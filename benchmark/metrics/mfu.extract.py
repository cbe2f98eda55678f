"""Operations of dense scoring of every micrograph picked (each pixel of
its score map at the picker's operations a pixel, counted from the
configuration's layer list), over the window, against the card's float32
peak, in percent."""

from harness.measure import mfu_percent
from reference import counts


def read(run):
    per_pixel = counts.picker_flops_per_pixel(run.config["picker_seeded"]["layers"])
    return mfu_percent(run.driver.pixels * per_pixel, run.window_s)
