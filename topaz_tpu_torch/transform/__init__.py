from topaz_tpu_torch.transform.scaled_gaussian_mixture import ScaledGaussianMixture

__all__ = ["ScaledGaussianMixture"]
