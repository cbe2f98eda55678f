"""Plain PyTorch reference of the benchmarked paths, written from the
published Topaz description (tbepler/topaz: topaz/utils/image.py Fourier
crop, topaz/stats.py GMM normalization, topaz/model/features/resnet.py
dense scoring, topaz/algorithms.py greedy NMS, topaz/denoising/models.py
U-Net) with the semantics the port documents where it departs (integer
nearest-upsample index, zero-padded shape buckets in the denoise arm).

It imports nothing of the program, of JAX or of the JAX package: weights
are the bundled ``.npz`` files read with numpy, inputs are what the harness
made. Every function runs on whatever device its tensors are on.
"""
