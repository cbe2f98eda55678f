"""``python -m topaz_tpu_torch`` CLI dispatcher (port of
topaz_tpu/cli/main.py).

Same subcommand convention as the reference (topaz/main.py:53-148): each
command module exposes ``name``, ``help``, ``add_arguments(parser)`` and
``main(args)``. Every command of the JAX CLI runs, ``-d -2`` (every CUDA
device) included. A command of the JAX CLI that the port did not run would
be listed in ``NOT_PORTED``, and invoking it would exit with an error that
says so.
"""

from __future__ import annotations

import argparse
import sys

# commands of the JAX CLI (topaz_tpu/cli/commands/) that the port lacks: none
NOT_PORTED = ()


def _not_ported(name: str):
    def run(args):
        raise NotImplementedError(
            f"command {name!r} is not ported to topaz_tpu_torch")
    return run


def build_parser() -> argparse.ArgumentParser:
    import topaz_tpu_torch
    from topaz_tpu_torch.cli import commands

    parser = argparse.ArgumentParser(
        prog="python -m topaz_tpu_torch",
        fromfile_prefix_chars="@",
        description="PyTorch/CUDA port of topaz_tpu. Every command of the JAX CLI "
                    "runs, -d -2 (every CUDA device) included.",
    )
    parser.add_argument("--version", action="version", version=topaz_tpu_torch.__version__)
    subparsers = parser.add_subparsers(title="commands", metavar="<command>")
    subparsers.required = True
    subparsers.dest = "command"
    for module in commands.load():
        sub = subparsers.add_parser(module.name, help=module.help)
        module.add_arguments(sub)
        sub.set_defaults(func=module.main)
    for name in NOT_PORTED:
        sub = subparsers.add_parser(name, help="(not ported)", add_help=False)
        sub.set_defaults(func=_not_ported(name))
    return parser


def main(argv=None) -> None:
    from topaz_tpu_torch.device import DeviceUnavailableError
    from topaz_tpu_torch.utils.profiling import profile_session

    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown and args.command not in NOT_PORTED:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    try:
        # TOPAZ_PROFILE=<dir>: a Chrome trace of the whole command
        with profile_session():
            args.func(args)
    except NotImplementedError as e:
        sys.exit(f"error: {e} (see ROADMAP.md; the JAX package runs it: "
                 f"python -m topaz_tpu)")
    except DeviceUnavailableError as e:
        sys.exit(f"error: {e}")


if __name__ == "__main__":
    main()
