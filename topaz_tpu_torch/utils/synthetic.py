"""Synthetic cryo-EM data generators for benchmarks, demos, and parity
tests (TPU-build utility; the reference relies on EMPIAR downloads its
tutorial performs, tutorial/01_quick_start_guide.ipynb — no real data
ships with either repo, so realistic synthesis is the testable stand-in).
"""

from __future__ import annotations

import numpy as np


def make_ctf_micrograph(rng, size=2048, n_particles=10, pixel_A=0.66,
                        defocus_A=15000.0, seed_centers=None,
                        signal=10.0, min_sep=2.2, white=1.0, pink=0.7):
    """Realistic synthetic micrograph (NOT plain Gaussian noise): solid-
    sphere particle projections imaged through a CTF with envelope decay,
    plus 1/f-colored ice background noise — the PSD and contrast-transfer
    structure of a real cryo-EM exposure at the tutorial's geometry
    (EMPIAR-10025 protocol: ~0.66 A/px raw, 8x downsample -> 5.28 A/px,
    particle radius ~14 px at the downsampled scale,
    tutorial/01_quick_start_guide.ipynb).

    Difficulty knobs (for non-saturating quality benchmarks):
      signal   CTF-signal amplitude relative to unit white noise
               (default 10.0 = the easy parity fixture; ~2-3 gives a
               task where a trained picker lands at AP 0.6-0.9)
      min_sep  center-to-center exclusion in particle radii (2.2 =
               non-overlapping; 1.2 allows crowding/overlap)
      white    white shot-noise sigma
      pink     1/f structural-noise sigma
      defocus_A  per-micrograph defocus in Angstrom (draw it from a
               range for a defocus-spread dataset)

    Returns (micrograph float32 [size,size], centers [(y,x) raw-scale]).
    """
    lam = 0.0197  # electron wavelength at 300 kV, Angstrom
    cs = 2.7e7    # spherical aberration 2.7 mm in Angstrom
    amp = 0.1     # amplitude contrast
    bfac = 150.0  # envelope B-factor, A^2

    # particle projections: solid spheres of ~74 A radius (14 px at 5.28)
    r_px = 112.0  # raw pixels
    sig = np.zeros((size, size), np.float32)
    margin = int(r_px) + 32
    if seed_centers is None:
        centers = []
        attempts = 0
        while len(centers) < n_particles and attempts < 50 * n_particles:
            attempts += 1
            cy, cx = rng.integers(margin, size - margin, size=2)
            if all((cy - y) ** 2 + (cx - x) ** 2 > (min_sep * r_px) ** 2
                   for y, x in centers):
                centers.append((int(cy), int(cx)))
    else:
        centers = seed_centers
    w = int(np.ceil(r_px)) + 2
    yy, xx = np.mgrid[-w : w + 1, -w : w + 1].astype(np.float32)
    d2 = yy**2 + xx**2
    proj = np.sqrt(np.maximum(r_px**2 - d2, 0.0)) / r_px  # sphere projection
    for cy, cx in centers:
        sig[cy - w : cy + w + 1, cx - w : cx + w + 1] -= proj

    # CTF in Fourier space (rfft grid), frequencies in 1/Angstrom
    fy = np.fft.fftfreq(size, d=pixel_A)[:, None]
    fx = np.fft.rfftfreq(size, d=pixel_A)[None, :]
    f2 = fy**2 + fx**2
    chi = np.pi * lam * defocus_A * f2 - 0.5 * np.pi * cs * lam**3 * f2**2
    ctf = (np.sqrt(1 - amp**2) * np.sin(chi) + amp * np.cos(chi)) \
        * np.exp(-bfac * f2 / 4.0)

    import scipy.fft as sfft

    sig_ctf = sfft.irfft2(sfft.rfft2(sig) * ctf, s=(size, size))

    # colored ice/solvent background: white shot noise + 1/f structural
    # noise (realistic falling PSD), SNR tuned so particles are visible
    # but not trivial
    wn = rng.normal(0, 1.0, (size, size)).astype(np.float32)
    pink_spec = sfft.rfft2(rng.normal(0, 1.0, (size, size)).astype(
        np.float32)) / np.sqrt(np.maximum(np.sqrt(f2) / 0.002, 1.0))
    pk = sfft.irfft2(pink_spec, s=(size, size)).astype(np.float32)
    pk *= 1.0 / max(pk.std(), 1e-9)

    x = (signal * sig_ctf.astype(np.float32) + white * wn + pink * pk)
    return x.astype(np.float32), centers
