"""topaz_tpu_torch: the PyTorch and CUDA port of topaz_tpu, for NVIDIA
Hopper GPUs.

The JAX package ``topaz_tpu`` beside it is the reference this port is held
against. Module names follow it, so each counterpart is easy to find. This
package imports neither JAX nor anything of ``topaz_tpu``; it reads the
bundled picker and denoiser weights (topaz_tpu/pretrained/{detector,denoise}/
*.npz) by path.

Every module and command of the JAX package is ported (``cli/main.py``):
picking in 2D and 3D (the NMS disk max-filter is a hand-written CUDA
kernel, csrc/disk_max.cu), the batched pipeline, denoising and denoiser
training, picker training, ``segment``, ``gui``, ``serve``, ``watch``,
``warmup``, the coordinate tools, the extra feature extractors
(``models/extras.py``) and ``transform.ScaledGaussianMixture``; ``-d -2``
runs over every CUDA device (``parallel/``); reference ``.sav`` models are
read without unpickling code (``models/convert.py``).
"""

__version__ = "0.1.0"
