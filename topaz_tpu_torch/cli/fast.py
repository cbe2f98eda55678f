"""The fast profile switch (port of topaz_tpu/cli/fast.py).

``--fast`` resolves to the opt-in fast paths of each command. Of the
commands ported so far only ``normalize``/``preprocess`` has one: the
histogram-EM GMM fit over all pixels (``--bins 65536``) in place of the
reference's random subsampling. Defaults stay exact/f32.
"""

from __future__ import annotations

FAST_BINS = 65536


def add_fast_flag(parser) -> None:
    parser.add_argument(
        "--fast", action="store_true",
        help="enable the documented fast profile: histogram-EM "
             "normalization (equivalent to --bins 65536; GMM stats "
             "quantized to 1/65536 of the intensity range). Defaults stay "
             "f32/exact for parity with the reference")


def apply_fast(args) -> None:
    """Resolve ``--fast`` into the concrete knobs, without overriding a
    knob the user set away from its default."""
    if not getattr(args, "fast", False):
        return
    if getattr(args, "bins", None) == 0:
        args.bins = FAST_BINS
