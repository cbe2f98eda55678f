"""topaz_tpu_torch: the PyTorch and CUDA port of topaz_tpu, for NVIDIA
Hopper GPUs.

The JAX package ``topaz_tpu`` beside it is the reference this port is held
against. Module names follow it, so each counterpart is easy to find. This
package imports neither JAX nor anything of ``topaz_tpu``; it reads the
bundled picker and denoiser weights (topaz_tpu/pretrained/{detector,denoise}/
*.npz) by path.

Ported so far, for 2D micrographs: preprocess (Fourier downsample + GMM
normalization), extract (dense picker scoring + greedy NMS, with the NMS
disk max-filter as a hand-written CUDA kernel, csrc/disk_max.cu), and
denoise inference (the noise2noise U-Nets and the classical filters).
"""

__version__ = "0.1.0"
