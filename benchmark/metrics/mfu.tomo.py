"""Operations of the published patch grid of every tomogram denoised
(ceil(n / s) patches an axis, (s + 2p)^3 voxels each, the 3D U-Net's
operations a voxel), over the window, against the card's float32 peak, in
percent."""

from harness.measure import mfu_percent
from reference import counts3d


def read(run):
    path = run.config["path"]
    per_volume = counts3d.tomogram_flops(run.traffic["shape"], run.config["denoiser3d"]["layers"],
                                         path["patch_size"], path["padding"])
    return mfu_percent(run.driver.completed * per_volume, run.window_s)
