"""The U-Net's operations at every pixel denoised, over the traced window,
against the card's float32 peak, in percent."""

from harness.measure import mfu_percent
from reference import counts


def read(run):
    d = run.config["denoiser"]
    per_px = counts.unet_flops_per_pixel(d["nf"], d["base_width"], d["top_width"], d["levels"])
    return mfu_percent(run.driver.pixels * per_px, run.window_s)
