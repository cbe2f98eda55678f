"""topaz_tpu_torch: the PyTorch and CUDA port of topaz_tpu, for NVIDIA
Hopper GPUs.

The JAX package ``topaz_tpu`` beside it is the reference this port is held
against. Module names follow it, so each counterpart is easy to find. This
package imports neither JAX nor anything of ``topaz_tpu``; it reads the
bundled picker weights (topaz_tpu/pretrained/detector/*.npz) by path.

Ported so far: preprocess (Fourier downsample + GMM normalization) and
extract (dense picker scoring + greedy NMS) for 2D micrographs, with the NMS
disk max-filter as a hand-written CUDA kernel (csrc/disk_max.cu).
"""

__version__ = "0.1.0"
