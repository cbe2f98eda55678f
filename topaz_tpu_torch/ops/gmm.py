"""Two-component GMM intensity normalization (port of
topaz_tpu/ops/gmm.py:30-426).

The EM procedure of topaz/stats.py:36-214: 11 two-component lanes (one per
initial pi, ``DEFAULT_PIS[:-1]``) and a single-component lane, the best of
which normalizes the image. Each EM lane keeps the reference's early exit,
as the JAX package's vmapped ``while_loop`` (topaz_tpu/ops/gmm.py:169)
does: it stops on its own, and a lane that is done keeps its state.

The fits also take a batch of images, (B, N), with 0/1 validity weights
``w`` for the padding of a shape bucket: the (B, 11) lanes stand for the
JAX pipeline's ``vmap`` of the masked fit over images (topaz_tpu/
pipeline.py:203-209).

On the card the EM loop is the CUDA kernel ``csrc/gmm_em.cu``: one launch
runs every (image, lane) fit of a call to its end, with no host check
between steps, as JAX's ``while_loop`` runs on the device; each lane runs
over a thread-block cluster, on the plan ``_em_plan`` makes from the
card's limits (cluster size, and the pixels a block keeps in shared
memory). A tensor on the
CPU goes to the plain version, ``_gmm_fit_plain``: the same steps as eager
PyTorch, with one host check a step. What JAX computes outside its loop
(the quantile split, the single-component lane, the selection, the
histogram) stays PyTorch on both.

Numerical contract: same update equations, same init (quantile split,
shared variance), same MAP pi update, same termination; float32 reduction
order differs from JAX's, so mu/std agree to ~1e-5 relative. The kernel
sums in float64; the plain version with float64 sums is its twin (the same
float32 terms, and on the card the same values and each lane's stop at the
same step), while the CPU path sums in float32, as JAX does.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from collections import namedtuple

import numpy as np
import torch

DEFAULT_PIS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.98, 1.0)

# launches of the EM kernel in this process; callers may reset it to 0
launches = 0
# the shards of a mesh call the kernel from threads of their own
# (parallel/mesh.run_each): one build, and no lost count
_lock = threading.Lock()


def _betaln(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """log B(alpha, beta), evaluated in float64 (lgamma differences lose
    digits in float32 at alpha=900)."""
    a, b = alpha.double(), beta.double()
    return (torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)).to(alpha.dtype)


def beta_logpdf(pi, alpha, beta) -> torch.Tensor:
    """log Beta(alpha, beta) density at pi (stats.py:165 prior term).

    The boundary cases follow scipy (finite at pi=1 when beta==1 and at
    pi=0 when alpha==1): the naive ``0 * log(0) = NaN`` would poison an EM
    lane whose MAP pi collapses to exactly 1.0."""
    pi = torch.as_tensor(pi, dtype=torch.float32)
    alpha = torch.as_tensor(alpha, dtype=pi.dtype, device=pi.device)
    beta = torch.as_tensor(beta, dtype=pi.dtype, device=pi.device)
    zero = torch.zeros((), dtype=pi.dtype, device=pi.device)
    t_a = torch.where(alpha == 1, zero, (alpha - 1) * torch.log(pi))
    t_b = torch.where(beta == 1, zero, (beta - 1) * torch.log1p(-pi))
    return t_a + t_b - _betaln(alpha, beta)


def _beta_pdf_at_one(alpha, beta) -> torch.Tensor:
    """scipy.stats.beta.pdf(1, alpha, beta): 0 for beta>1, alpha for beta==1,
    inf for beta<1. The reference adds this (not its log!) to the
    single-component logp (stats.py:107) - reproduced for parity."""
    alpha = torch.as_tensor(alpha, dtype=torch.float32)
    beta = torch.as_tensor(beta, dtype=torch.float32)
    return torch.where(beta > 1, torch.zeros_like(alpha),
                       torch.where(beta == 1, alpha, torch.full_like(alpha, math.inf)))


def _posteriors(x, mu0, var0, mu1, var1, pi):
    log_p0 = -((x - mu0) ** 2) / 2 / var0 - 0.5 * torch.log(2 * math.pi * var0) + torch.log1p(-pi)
    log_p1 = -((x - mu1) ** 2) / 2 / var1 - 0.5 * torch.log(2 * math.pi * var1) + torch.log(pi)
    ma = torch.maximum(log_p0, log_p1)
    Z = ma + torch.log(torch.exp(log_p0 - ma) + torch.exp(log_p1 - ma))
    return log_p0, log_p1, Z


def _gmm_fit_plain(xb, wb, n, pi, split, alpha, beta, scale, tol, num_iters,
                   acc=torch.float32, history=None):
    """The EM of :func:`gmm_fit` in eager PyTorch, one (B, L, N) batch.

    ``xb`` (B, N), ``wb`` (B, N) or None, ``n`` (B,), ``pi`` and ``split``
    (B, L), all float32 on one device. Each (image, lane) pair keeps the
    reference's early exit: a ``running`` mask is computed before every
    step, and a lane that is done, or out of iterations, keeps its state,
    as the JAX package's vmapped ``while_loop`` does; the loop ends when no
    lane runs, checked on the host once a step. Returns ((logp, mu0, var0,
    mu1, var1, pi), steps), each (B, L).

    Sums are taken in ``acc`` and rounded to float32. float32 is the CPU
    path's, which agrees with JAX's float32 sums lane for lane; with
    float64 the version is the kernel's twin: the same float32 terms,
    summed as the kernel sums them, so that the two stop each lane at the
    same step. With a list ``history``, each step appends (logp - logp_cur,
    logp, running, mu0, var, mu1, pi), each (B, L), the step's values for
    every lane (also for lanes that no longer run, which keep their state),
    for holding a kernel's stops against them."""

    def _sum(t):
        if acc == t.dtype:
            return torch.sum(t, dim=-1, keepdim=True)
        return torch.sum(t, dim=-1, keepdim=True, dtype=acc).to(t.dtype)

    if wb is None:
        wb = torch.ones_like(xb)
    n = n.reshape(-1, 1, 1)
    mu = _sum(xb * wb)[:, None] / n
    xb, wb = xb[:, None], wb[:, None]
    pi, split = pi[..., None], split[..., None]

    def weighted_mean(p):
        s = _sum(p)
        safe = torch.where(s > 0, s, torch.ones_like(s))
        return torch.where(s > 0, _sum(xb * p) / safe, mu)

    def stats(p0, p1, pi):
        mu0 = weighted_mean(p0)
        mu1 = weighted_mean(p1)
        var = _sum(p0 * (xb - mu0) ** 2 + p1 * (xb - mu1) ** 2) / n
        log_p0, log_p1, Z = _posteriors(xb, mu0, var, mu1, var, pi)
        logp = scale * _sum(wb * Z) + beta_logpdf(pi, alpha, beta)
        return {"logp": logp, "log_p0": log_p0, "log_p1": log_p1, "Z": Z,
                "mu0": mu0, "var": var, "mu1": mu1, "pi": pi}

    p0 = (xb <= split).to(xb.dtype) * wb
    s = stats(p0, wb - p0, pi)
    s["logp_cur"] = s["logp"]
    it = torch.zeros(pi.shape, dtype=torch.int32, device=xb.device)
    done = torch.zeros(pi.shape, dtype=torch.bool, device=xb.device)

    while True:
        running = (~done) & (it < num_iters)
        if not bool(running.any()):
            break
        p0 = torch.exp(s["log_p0"] - s["Z"]) * wb
        p1 = torch.exp(s["log_p1"] - s["Z"]) * wb
        s1 = _sum(p1)
        a = alpha + s1
        b = beta + n - s1
        new = stats(p0, p1, (a - 1) / (a + b - 2))  # MAP pi (stats.py:174-177)
        gain = new["logp"] - s["logp_cur"]
        step_done = gain <= tol
        if history is not None:
            history.append((gain[..., 0], new["logp"][..., 0], running[..., 0])
                           + tuple(new[k][..., 0] for k in ("mu0", "var", "mu1", "pi")))
        new["logp_cur"] = torch.where(step_done, s["logp_cur"], new["logp"])
        s = {k: torch.where(running, new[k], v) for k, v in s.items()}
        done = torch.where(running, step_done, done)
        it = it + running.to(torch.int32)
    out = tuple(s[k][..., 0] for k in ("logp", "mu0", "var", "mu1", "var", "pi"))
    return out, it[..., 0]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from topaz_tpu_torch._build import build_library

    with _lock:
        lib = ctypes.CDLL(build_library("gmm_em"))
    lib.gmm_em_f32.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
        + [ctypes.c_int, ctypes.c_float] + [ctypes.c_void_p] * 3)
    lib.gmm_em_f32.restype = ctypes.c_int
    lib.gmm_em_smem_limit.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.gmm_em_smem_limit.restype = ctypes.c_int
    lib.gmm_em_max_clusters.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    lib.gmm_em_max_clusters.restype = ctypes.c_int
    return lib


# How the kernel runs a call: each (image, lane) pair over a thread-block
# cluster of `cluster` blocks, rank r on pixels [r slice, (r + 1) slice);
# each block keeps the responsibilities of the first `kept` pixels of its
# slice in `smem` bytes of dynamic shared memory (8 a pixel), from each
# evaluation to the next step's variance, and evaluates those of the others
# again. The route is "resident" where a block keeps its whole slice.
class EmPlan(namedtuple("EmPlan", "cluster kept smem slice")):
    @property
    def route(self) -> str:
        return "resident" if self.kept == self.slice else "recompute"


# cluster sizes: up to 8 blocks on every card of compute capability 9.0;
# the kernel asks for up to 16 (non-portable sizes, which an H100 allows),
# and the card's cudaOccupancyMaxActiveClusters rules out what it cannot run
MAX_CLUSTER = 16
# the blocks of one launch (gridDim.x), and so the lanes of one call at the
# smallest cluster
MAX_GRID = 2**31 - 1
MAX_LANES = MAX_GRID // 2
# _em_plan's cost of a lane step on one block, in posterior evaluations of
# one pixel (~0.54 ns each on an H100's SM): a kept pixel's variance term;
# a step's fixed cost, and its growth a block above 8; and the share of a
# call's lanes that run long (on micrographs, those of pi 0.1-0.5: 5 of
# 11). Fitted to the times of every plan at the callers' shapes
# (tools/profile_torch_gmm_em.py --refit): a step alone costs ~10000, but
# the turns of the model do not see lanes of unequal length share the
# clusters, and a fixed cost of 0-2000 ranks the plans best.
KEPT_COST, STEP_COST, STEP_COST_ABOVE_8, LONG_LANES = 0.2, 1000, 600, 0.5


def _em_candidates(B, L, N, weighted, sm_count, max_smem_per_block, max_active_clusters):
    """Every cluster size the kernel can run a call of B x L lanes of N
    pixels on, as [(plan, active clusters, cost)]: each size from 2 to
    MAX_CLUSTER whose grid fits one launch, each block keeping as many of
    its pixels as ``max_smem_per_block`` holds, with at least one such
    cluster resident on the card (``max_active_clusters(weighted, cluster,
    smem)``, capped at ``sm_count // cluster``). The cost is a lane step's
    time on one block times the long lanes a cluster runs in turn
    (LONG_LANES of the lanes over the active clusters, at least one)."""
    if N <= 0:
        raise ValueError(f"gmm_fit: no plan for {N} pixels")
    lanes = B * L
    out = []
    for c in range(2, MAX_CLUSTER + 1):
        if lanes * c > MAX_GRID or c > sm_count:
            break
        slice_ = -(-N // c)
        kept = min(slice_, max_smem_per_block // 8)
        active = min(int(max_active_clusters(weighted, c, 8 * kept)), sm_count // c)
        if active < 1:
            continue
        step = (2 * slice_ - kept + KEPT_COST * kept + STEP_COST
                + STEP_COST_ABOVE_8 * max(0, c - 8))
        turns = max(1.0, LONG_LANES * lanes / active)
        out.append((EmPlan(c, kept, 8 * kept, slice_), active, turns * step))
    return out


def _em_plan(B, L, N, weighted, sm_count, max_smem_per_block, max_active_clusters) -> EmPlan:
    """The kernel's plan for B x L lanes of N pixels on a card with
    ``sm_count`` SMs, ``max_smem_per_block`` bytes of dynamic shared memory
    a block and ``max_active_clusters`` (see ``_em_candidates``): the
    candidate of least cost, the smaller cluster on a tie. Raises
    ValueError where no cluster can run the call."""
    found = _em_candidates(B, L, N, weighted, sm_count, max_smem_per_block, max_active_clusters)
    if not found:
        raise ValueError(f"gmm_fit: no cluster runs {B} x {L} lanes of {N} pixels")
    return min(found, key=lambda f: (f[2], f[0].cluster))[0]


def _lane_order(B, L) -> torch.Tensor:
    """The kernel's grid order (csrc/gmm_em.cu, lane-major): cluster q runs
    lane l = q // B of image b = q % B, whose outputs sit at b * L + l, so
    the lanes of small pi, the longest on real images, start first.
    Returns those output indices in launch order."""
    q = torch.arange(B * L)
    return (q % B) * L + q // B


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    out = ctypes.c_int()
    with torch.cuda.device(index):
        err = _library().gmm_em_smem_limit(ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"gmm_em: shared memory query failed with CUDA error {err}")
    return out.value


@functools.lru_cache(maxsize=None)
def _max_clusters(index: int, weighted: bool, cluster: int, smem: int) -> int:
    out = ctypes.c_int()
    with torch.cuda.device(index):
        err = _library().gmm_em_max_clusters(int(weighted), cluster, smem, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"gmm_em: cluster occupancy query failed with CUDA error {err}")
    return out.value


@functools.lru_cache(maxsize=1024)
def _device_plan(index: int, B: int, L: int, N: int, weighted: bool) -> EmPlan:
    """``_em_plan`` with the limits of CUDA device ``index``: its SMs
    (``torch.cuda.get_device_properties``), the dynamic shared memory a
    block may take and the clusters it holds at once (the kernel's own
    queries)."""
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _em_plan(B, L, N, weighted, sms, _smem_limit(index),
                    functools.partial(_max_clusters, index))


def _gmm_fit_kernel(xb, wb, n, pi, split, alpha, beta, scale, tol, num_iters, plan=None):
    """The EM of :func:`gmm_fit` in one launch of the CUDA kernel
    ``csrc/gmm_em.cu`` on a CUDA tensor: no host check between steps, and
    nothing read back. Same arguments and return as ``_gmm_fit_plain``;
    ``plan`` (an ``EmPlan``) overrides the device's ``_device_plan``."""
    B, N = xb.shape
    L = pi.shape[-1]
    args = {"x": (xb, (B, N)), "n": (n, (B,)), "pi": (pi, (B, L)), "split": (split, (B, L))}
    if wb is not None:
        args["w"] = (wb, (B, N))
    for name, (t, shape) in args.items():
        if (t.device != xb.device or t.dtype != torch.float32 or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"gmm_fit: {name} must be contiguous float32 of shape {shape} on "
                             f"{xb.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if N == 0 or N > 2**31 - 1 or B * L > MAX_LANES:
        raise ValueError(f"gmm_fit: no kernel launch for {B} images x {L} lanes of {N} pixels")
    out = torch.empty((6, B, L), dtype=torch.float32, device=xb.device)
    steps = torch.empty((B, L), dtype=torch.int32, device=xb.device)
    if B * L == 0:
        return tuple(out), steps
    fn = _library().gmm_em_f32
    # log B(alpha, beta) of the float32 alpha and beta, as _betaln takes it
    a, b = float(np.float32(alpha)), float(np.float32(beta))
    betaln = math.lgamma(a) + math.lgamma(b) - math.lgamma(a + b)
    with torch.cuda.device(xb.device):
        if plan is None:
            plan = _device_plan(torch.cuda.current_device(), B, L, N, wb is not None)
        stream = torch.cuda.current_stream(xb.device).cuda_stream
        err = fn(xb.data_ptr(), None if wb is None else wb.data_ptr(), n.data_ptr(),
                 pi.data_ptr(), split.data_ptr(), B, N, L, plan.cluster, plan.kept,
                 alpha, beta, scale, tol, int(num_iters), betaln, out.data_ptr(),
                 steps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gmm_em kernel launch failed with CUDA error {err} ({plan})")
    global launches
    with _lock:
        launches += 1
    return tuple(out), steps


def _fit_inputs(x, pi, split, w, n):
    """gmm_fit's arguments as the (B, N), (B, N) or None, (B,), (B, L) and
    (B, L) float32 tensors of the plain version and the kernel, made on the
    device with no copy from the host where they are tensors already."""
    xb = x.reshape(x.shape[0] if x.dim() == 2 else 1, -1).to(torch.float32).contiguous()
    B, N = xb.shape
    wb = None if w is None else w.reshape(xb.shape).to(torch.float32).contiguous()
    if w is None:
        n = torch.full((B,), float(N), dtype=torch.float32, device=x.device)
    elif n is None:
        n = torch.sum(wb, dim=-1)
    elif isinstance(n, torch.Tensor):
        n = n.to(device=x.device, dtype=torch.float32).reshape(-1).expand(B).contiguous()
    else:
        n = torch.full((B,), float(n), dtype=torch.float32, device=x.device)
    lanes = []
    for t in (pi, split):
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
        lanes.append(t.reshape(-1, t.shape[-1]).expand(B, t.shape[-1]).contiguous())
    return xb, wb, n, lanes[0], lanes[1]


def gmm_fit(
    x: torch.Tensor,
    pi: torch.Tensor,
    split: torch.Tensor,
    alpha: float = 0.5,
    beta: float = 0.5,
    scale: float = 1.0,
    tol: float = 1e-3,
    num_iters: int = 100,
    w: torch.Tensor = None,
    n=None,
):
    """Fit shared-variance 2-component GMMs with a Beta prior on pi, one
    lane per entry of ``pi`` and ``split``.

    ``x`` is one image's pixels, (N,), or a batch of images, (B, N); ``pi``
    and ``split`` are (L,), or (B, L) for a batch. The batch stands for the
    JAX package's ``vmap`` over images: every (image, lane) pair stops on
    its own. Same update equations and termination rule as
    topaz/stats.py:122-214. ``w`` (weights the shape of ``x``) with ``n`` =
    their sum per image restricts the fit to a weighted subset: 0/1
    validity of padded images, or histogram counts. Returns per-lane
    (logp, mu0, var0, mu1, var1, pi), each (L,) or (B, L).

    A CUDA tensor goes to the kernel (``csrc/gmm_em.cu``: the whole fit in
    one launch, built at first use), a CPU tensor to the plain version.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"gmm_fit: no kernel for device {x.device}")
    fit = _gmm_fit_plain if x.device.type == "cpu" else _gmm_fit_kernel
    out, _steps = fit(*_fit_inputs(x, pi, split, w, n), alpha, beta, scale, tol, num_iters)
    return out if x.dim() == 2 else tuple(v[0] for v in out)


def _guard_degenerate(i, mus, stds, pis_out, logps, mean_all, rng):
    """Dead-frame guard, a documented divergence from the reference.

    A constant image (range 0) makes every EM lane's variance 0, so all
    logps are NaN; such frames normalize to zeros (mu=mean, std=1) with
    logp=-inf as the host-visible degeneracy signal. Non-constant images
    whose best lane still has a non-finite or zero std get the same
    fallback. ``i`` is the (B, 1) index of each image's best lane."""
    best_mu = mus.gather(-1, i)[:, 0]
    best_std = stds.gather(-1, i)[:, 0]
    degen = (rng <= 0) | ~torch.isfinite(best_std) | (best_std <= 0)
    one = torch.ones_like(best_std)
    mu_sel = torch.where(degen, mean_all, best_mu)
    std_sel = torch.where(degen, one, best_std)
    pi_sel = torch.where(degen, one, pis_out.gather(-1, i)[:, 0])
    logp_sel = torch.where(degen, torch.full_like(one, -math.inf), logps.gather(-1, i)[:, 0])
    return mu_sel, std_sel, pi_sel, logp_sel, mus, stds, pis_out, logps


def _select(batched, logp_g, mu_g, var_g, pi_g, logp1c, mu1c, var1c, mean_all, rng):
    """Append the single-component lane to the 11 EM lanes of each image,
    take the max-logp lane, guard dead frames; drop the batch axis of a
    single image."""
    logps = torch.cat([logp_g, logp1c[:, None]], dim=-1)
    mus = torch.cat([mu_g, mu1c[:, None]], dim=-1)
    stds = torch.sqrt(torch.cat([var_g, var1c[:, None]], dim=-1))
    pis_out = torch.cat([pi_g, torch.ones_like(pi_g[:, :1])], dim=-1)
    i = torch.argmax(logps, dim=-1, keepdim=True)
    out = _guard_degenerate(i, mus, stds, pis_out, logps, mean_all, rng)
    return out if batched else tuple(v[0] for v in out)


def _as_batch(x: torch.Tensor, w):
    """(x, w) as float32 (B, N) batches; a 1D ``x`` is one image."""
    batched = x.dim() == 2
    xb = x.to(torch.float32).reshape(x.shape[0] if batched else 1, -1)
    wb = None if w is None else w.reshape(xb.shape).to(torch.float32)
    return batched, xb, wb


def norm_fit(x: torch.Tensor, alpha: float = 900, beta: float = 1,
             scale: float = 1.0, num_iters: int = 100, w: torch.Tensor = None):
    """Try all 12 pi inits, pick the max-logp fit (topaz/stats.py:86-119).

    ``x`` is one image's pixels (N,) or a batch of images (B, N). Returns
    (mu, std, pi, logp, mus, stds, pis, logps), where mu/std are the
    *second* (high-intensity) component's parameters, as in the reference;
    a batch adds its leading axis to each.

    With ``w`` (0/1 validity weights, the shape of ``x``) each image is fit
    on its valid pixels only: the quantile initialization, the EM
    sufficient statistics and the single-component lane all ignore the
    padding of a shape bucket (topaz_tpu/ops/gmm.py:188-250).
    """
    batched, xb, wb = _as_batch(x, w)
    N = xb.shape[-1]
    pis = torch.tensor(DEFAULT_PIS, dtype=torch.float32, device=x.device)
    if wb is None:
        # linear-interpolation quantiles, in jnp.quantile's arithmetic
        xs = torch.sort(xb, dim=-1).values
        q = (1 - pis) * (float(N) - 1)
        low, high = torch.floor(q), torch.ceil(q)
        high_w = q - low
        low_w = 1 - high_w
        low = torch.clamp(low, 0, N - 1).long()
        high = torch.clamp(high, 0, N - 1).long()
        splits = xs[:, low] * low_w + xs[:, high] * high_w
        n = N
    else:
        # masked quantile, numpy's linear interpolation over each image's
        # own n valid pixels (float32, as jnp): padding sorts to +inf past
        # them
        n = torch.sum(wb, dim=-1, keepdim=True)
        xs = torch.sort(torch.where(wb > 0, xb, math.inf), dim=-1).values
        idx = (1 - pis) * (n - 1)
        lo = torch.clamp(torch.floor(idx).long(), 0, N - 1)
        hi = torch.clamp(torch.ceil(idx).long(), 0, N - 1)
        frac = idx - torch.floor(idx)
        splits = xs.gather(-1, lo) * (1 - frac) + xs.gather(-1, hi) * frac

    logp_g, _mu0, _var0, mu_g, var_g, pi_g = gmm_fit(
        xb, pis[:-1], splits[:, :-1], alpha=alpha, beta=beta, scale=scale,
        num_iters=num_iters, w=wb, n=None if wb is None else n)

    # lane 11: single-component model (stats.py:104-107); torch's x.var() is
    # unbiased, as the reference
    if wb is None:
        mu1c = torch.mean(xb, dim=-1)
        var1c = torch.mean((xb - mu1c[:, None]) ** 2, dim=-1) * (N / (N - 1))
        sum_z1c = torch.sum(-((xb - mu1c[:, None]) ** 2) / 2 / var1c[:, None]
                            - 0.5 * torch.log(2 * math.pi * var1c[:, None]), dim=-1)
        mean_all = torch.mean(xb, dim=-1)
        rng = torch.amax(xb, dim=-1) - torch.amin(xb, dim=-1)
    else:
        n = n[:, 0]
        mu1c = torch.sum(xb * wb, dim=-1) / n
        var1c = torch.sum(wb * (xb - mu1c[:, None]) ** 2, dim=-1) / (n - 1)
        sum_z1c = torch.sum(wb * (-((xb - mu1c[:, None]) ** 2) / 2 / var1c[:, None]
                                  - 0.5 * torch.log(2 * math.pi * var1c[:, None])), dim=-1)
        mean_all = torch.sum(xb * wb, dim=-1) / n
        rng = (torch.amax(torch.where(wb > 0, xb, -math.inf), dim=-1)
               - torch.amin(torch.where(wb > 0, xb, math.inf), dim=-1))
    logp1c = scale * sum_z1c + _beta_pdf_at_one(alpha, beta).to(x.device)
    return _select(batched, logp_g, mu_g, var_g, pi_g, logp1c, mu1c, var1c, mean_all, rng)


def norm_fit_hist(x: torch.Tensor, bins: int = 65536, alpha: float = 900,
                  beta: float = 1, num_iters: int = 100, w: torch.Tensor = None):
    """Histogram-accelerated :func:`norm_fit`: bin all pixels once, then
    run the same weighted EM over the bin centers with the counts as
    weights. The only error is value quantization to the bin width. Same
    shapes and return as norm_fit.

    With ``w`` (0/1 validity weights) each image's range and counts cover
    its valid pixels only. A batch bins all its images in one ``bincount``,
    image b's bins offset by ``b * bins``."""
    batched, xb, wb = _as_batch(x, w)
    B, N = xb.shape
    if wb is None:
        n = torch.full((B, 1), float(N), dtype=torch.float32, device=x.device)
        lo = torch.amin(xb, dim=-1, keepdim=True)
        hi = torch.amax(xb, dim=-1, keepdim=True)
    else:
        n = torch.sum(wb, dim=-1, keepdim=True)
        lo = torch.amin(torch.where(wb > 0, xb, math.inf), dim=-1, keepdim=True)
        hi = torch.amax(torch.where(wb > 0, xb, -math.inf), dim=-1, keepdim=True)
    width = torch.clamp(hi - lo, min=1e-30)
    idx = torch.clamp((((xb - lo) / width) * bins).to(torch.int32), 0, bins - 1)
    idx = idx + torch.arange(B, device=x.device)[:, None] * bins
    counts = torch.bincount(idx.reshape(-1), minlength=B * bins,
                            weights=None if wb is None else wb.reshape(-1))
    counts = counts.to(torch.float32).reshape(B, bins)
    centers = lo + (torch.arange(bins, dtype=torch.float32, device=x.device) + 0.5) * (width / bins)

    pis = torch.tensor(DEFAULT_PIS, dtype=torch.float32, device=x.device)
    # quantile init from the histogram CDF
    cdf = torch.cumsum(counts, -1)
    split_idx = torch.clamp(torch.searchsorted(cdf, (1 - pis) * n), 0, bins - 1)
    splits = centers.gather(-1, split_idx)

    logp_g, _mu0, _var0, mu_g, var_g, pi_g = gmm_fit(
        centers, pis[:-1], splits[:, :-1], alpha=alpha, beta=beta,
        num_iters=num_iters, w=counts, n=n)

    mu1c = torch.sum(centers * counts, dim=-1, keepdim=True) / n
    var1c = torch.sum(counts * (centers - mu1c) ** 2, dim=-1, keepdim=True) / (n - 1)
    logp1c = torch.sum(
        counts * (-((centers - mu1c) ** 2) / 2 / var1c
                  - 0.5 * torch.log(2 * math.pi * var1c)), dim=-1
    ) + _beta_pdf_at_one(alpha, beta).to(x.device)
    mean_all = torch.sum(centers * counts, dim=-1) / n[:, 0]
    return _select(batched, logp_g, mu_g, var_g, pi_g, logp1c, mu1c[:, 0], var1c[:, 0],
                   mean_all, (hi - lo)[:, 0])


def _warn_degenerate():
    import warnings

    warnings.warn(
        "constant image (std=0): normalized output is all zeros (the "
        "reference produces NaNs for such frames, topaz/stats.py:36-83)")


def normalize(
    x,
    alpha: float = 900,
    beta: float = 1,
    num_iters: int = 100,
    sample: int = 1,
    method: str = "gmm",
    seed: int = 0,
    verbose: bool = False,
    bins: int = 0,
    device="cuda",
):
    """Normalize an image by affine or GMM statistics (topaz/stats.py:36-83).

    The GMM fit runs on ``device``. ``bins > 0`` uses the histogram-EM fast
    path over all pixels instead of the reference's random subsampling
    (``sample``, drawn on the host with ``np.random.default_rng(seed)``).
    Returns (normalized float32 array, metadata dict).
    """
    from topaz_tpu_torch.device import resolve_device

    x = np.asarray(x, dtype=np.float32)

    if method == "affine":
        mu = float(x.mean())
        std = float(x.std())
        metadata = {"mu": mu, "std": std, "pi": 1}
        if std == 0 or not np.isfinite(std):
            _warn_degenerate()
            return np.zeros_like(x, dtype=np.float32), metadata
        return ((x - mu) / std).astype(np.float32), metadata

    device = resolve_device(device)
    if bins > 0:
        mu, std, pi, logp, mus, stds, pis, logps = (
            v.cpu().numpy() for v in norm_fit_hist(
                torch.as_tensor(x.ravel(), device=device), bins=int(bins), alpha=alpha,
                beta=beta, num_iters=num_iters))
        mu, std = float(mu), float(std)
        if np.isneginf(logp):
            _warn_degenerate()
        return ((x - mu) / std).astype(np.float32), {
            "mu": mu, "std": std, "pi": float(pi), "logp": float(logp),
            "mus": mus, "stds": stds, "pis": pis, "logps": logps,
            "alpha": alpha, "beta": beta, "sample": 1, "bins": int(bins),
        }

    x_sample = x
    scale = 1.0
    if sample > 1:
        n = int(np.round(x.size / sample))
        scale = x.size / n
        rng = np.random.default_rng(seed)
        x_sample = rng.choice(x.ravel(), size=n, replace=False)

    mu, std, pi, logp, mus, stds, pis, logps = (
        v.cpu().numpy() for v in norm_fit(
            torch.as_tensor(x_sample.ravel(), device=device), alpha=alpha, beta=beta,
            scale=scale, num_iters=num_iters))
    mu, std = float(mu), float(std)
    if np.isneginf(logp):
        _warn_degenerate()
    out = ((x - mu) / std).astype(np.float32)
    metadata = {
        "mu": mu,
        "std": std,
        "pi": float(pi),
        "logp": float(logp),
        "mus": mus,
        "stds": stds,
        "pis": pis,
        "logps": logps,
        "alpha": alpha,
        "beta": beta,
        "sample": sample,
    }
    return out, metadata
