"""Operations of the picker and the U-Net arm at every valid pixel of the
micrographs answered, over the traced window, against the card's float32
peak, in percent."""

from harness.measure import mfu_percent, valid_pixels
from reference import counts


def read(run):
    d = run.config["denoiser"]
    per_px = (counts.picker_flops_per_pixel(run.config["picker"]["layers"])
              + counts.unet_flops_per_pixel(d["nf"], d["base_width"], d["top_width"], d["levels"]))
    return mfu_percent(valid_pixels(run) * per_px, run.window_s)
