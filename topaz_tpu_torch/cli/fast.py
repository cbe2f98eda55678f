"""The fast profile switch (port of topaz_tpu/cli/fast.py).

``--fast`` resolves to the opt-in fast paths of each command:
``denoise`` runs its models in bfloat16 (``--precision bf16``);
``normalize``/``preprocess`` fit the GMM to a histogram of all pixels
(``--bins 65536``) in place of the reference's random subsampling. Defaults
stay exact/f32.
"""

from __future__ import annotations

FAST_BINS = 65536


def add_fast_flag(parser) -> None:
    parser.add_argument(
        "--fast", action="store_true",
        help="enable the documented fast profile: bf16 denoising and/or "
             "histogram-EM normalization where applicable (equivalent to "
             "--precision bf16 / --bins 65536; GMM stats quantized to "
             "1/65536 of the intensity range). Defaults stay f32/exact for "
             "parity with the reference")


def apply_fast(args) -> None:
    """Resolve ``--fast`` into the concrete knobs, without overriding a
    knob the user set away from its default."""
    if not getattr(args, "fast", False):
        return
    if getattr(args, "precision", None) == "f32":
        args.precision = "bf16"
    if getattr(args, "bins", None) == 0:
        args.bins = FAST_BINS
