"""``python -m topaz_tpu_torch`` CLI dispatcher (port of
topaz_tpu/cli/main.py).

Same subcommand convention as the reference (topaz/main.py:53-148): each
command module exposes ``name``, ``help``, ``add_arguments(parser)`` and
``main(args)``. The commands of the JAX CLI that this port does not run yet
are listed, and invoking one exits with an error that says so; so does a
flag of a ported command whose path is not ported.
"""

from __future__ import annotations

import argparse
import sys

# commands of the JAX CLI (topaz_tpu/cli/commands/) not yet ported
NOT_PORTED = (
    "train", "segment", "precision_recall_curve", "watch", "serve", "warmup",
    "downsample", "denoise", "denoise3d", "convert", "split", "particle_stack",
    "train_test_split", "gui", "scale_coordinates", "boxes_to_coordinates",
    "star_to_coordinates", "coordinates_to_star", "coordinates_to_boxes",
    "coordinates_to_eman2_json", "star_particles_threshold",
)


def _not_ported(name: str):
    def run(args):
        raise NotImplementedError(
            f"command {name!r} is not yet ported to topaz_tpu_torch")
    return run


def build_parser() -> argparse.ArgumentParser:
    import topaz_tpu_torch
    from topaz_tpu_torch.cli.commands import extract, normalize, preprocess

    parser = argparse.ArgumentParser(
        prog="python -m topaz_tpu_torch",
        fromfile_prefix_chars="@",
        description="PyTorch/CUDA port of topaz_tpu. Ported: "
                    "normalize, preprocess, extract.",
    )
    parser.add_argument("--version", action="version", version=topaz_tpu_torch.__version__)
    subparsers = parser.add_subparsers(title="commands", metavar="<command>")
    subparsers.required = True
    subparsers.dest = "command"
    for module in (extract, normalize, preprocess):
        sub = subparsers.add_parser(module.name, help=module.help)
        module.add_arguments(sub)
        sub.set_defaults(func=module.main)
    for name in NOT_PORTED:
        sub = subparsers.add_parser(name, help="(not yet ported)", add_help=False)
        sub.set_defaults(func=_not_ported(name))
    return parser


def main(argv=None) -> None:
    from topaz_tpu_torch.device import DeviceUnavailableError

    parser = build_parser()
    args, unknown = parser.parse_known_args(argv)
    if unknown and args.command not in NOT_PORTED:
        parser.error(f"unrecognized arguments: {' '.join(unknown)}")
    try:
        args.func(args)
    except NotImplementedError as e:
        sys.exit(f"error: {e} (see ROADMAP.md; the JAX package runs it: "
                 f"python -m topaz_tpu)")
    except DeviceUnavailableError as e:
        sys.exit(f"error: {e}")


if __name__ == "__main__":
    main()
