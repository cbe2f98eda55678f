"""Operations of dense scoring of every tomogram picked (each voxel of its
map at the 3D picker's operations a voxel, whatever the tiles recompute),
over the window, against the card's float32 peak, in percent."""

import math

from harness.measure import mfu_percent
from reference import picker3d


def read(run):
    per_volume = math.prod(run.traffic["shape"]) * picker3d.picker3d_flops_per_voxel(
        run.config["picker3d"]["layers"])
    return mfu_percent(run.driver.completed * per_volume, run.window_s)
