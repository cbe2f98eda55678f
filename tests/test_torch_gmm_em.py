"""The GMM normalization's EM loop: the port's fits against the JAX
package's on the CPU, and the CUDA kernel (csrc/gmm_em.cu) against its
plain twin on the card.

On the CPU, seeded numpy data goes through the JAX package's ``gmm_fit``
(vmapped over lanes and images, as its ``norm_fit`` and pipeline run it),
``norm_fit`` and ``norm_fit_hist``, and through the port's. mu and std are
held to rtol 1e-5, the contract of tests/test_torch_gmm.py (float32 sums run
in other orders). Where no lane can stop early (``num_iters`` cuts every
lane first) every lane and every output is held to 1e-5, also for the plain
version with float64 sums, the kernel's twin. The means of the test
mixtures are 1 and 3, away from 0, where a relative tolerance on mu would
measure nothing.

The ``cuda`` test runs the kernel and its twin on the same inputs on the
card: equal to 1e-5 relative, each lane stopping at the same step except at
a float32 tie of logp - logp_cur with tol (``chip_smoke.em_compare``). This
file imports JAX only inside the CPU tests' fixture, so that on a machine
with a card and no JAX ``python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_gmm_em.py`` runs the card's cases."""

import functools
import math

import numpy as np
import pytest
import torch

from chip_smoke import em_compare, em_inputs, em_mixture
from topaz_tpu_torch.ops import gmm as tgmm

RTOL = 1e-5
ALPHA, BETA = 900.0, 1.0


@pytest.fixture(scope="module")
def jax_gmm():
    import jax
    import jax.numpy as jnp

    from topaz_tpu.ops import gmm as jgmm

    return jax, jnp, jgmm


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    # as tests/torch_threads.py: the suite's workers share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: runs the EM kernel csrc/gmm_em.cu on the card")
    return torch.device("cuda")


def _mixture(rng, B, N, valid=None, dead=None):
    """chip_smoke's test mixture (means 1 and 3) as numpy arrays."""
    x, w = em_mixture(rng, B, N, valid, dead, device="cpu")
    return x.numpy(), None if w is None else w.numpy()


def _lane_inputs(x, w):
    """pi and the quantile splits of each image's 11 EM lanes, as the JAX
    package's norm_fit makes them (numpy's linear interpolation over the
    valid pixels), and n."""
    pis = np.array(tgmm.DEFAULT_PIS[:-1], np.float32)
    splits, ns = [], []
    for b in range(x.shape[0]):
        xv = x[b] if w is None else x[b][w[b] > 0]
        splits.append(np.quantile(xv, 1 - pis).astype(np.float32))
        ns.append(np.float32(xv.size))
    return pis, np.stack(splits), np.array(ns, np.float32)


def _jax_fit(jax_gmm, x, w, pis, splits, ns, num_iters):
    """The JAX package's gmm_fit vmapped over lanes and images: (6, B, L)."""
    jax, jnp, jgmm = jax_gmm

    def one_image(xi, wi, si, ni):
        return jax.vmap(lambda p, s: jgmm.gmm_fit(
            xi, p, s, alpha=ALPHA, beta=BETA, num_iters=num_iters,
            w=wi, n=ni))(jnp.asarray(pis), si)

    if w is None:
        fit = jax.vmap(lambda xi, si: one_image(xi, None, si, None))
        out = fit(jnp.asarray(x), jnp.asarray(splits))
    else:
        out = jax.vmap(one_image)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(splits),
                                  jnp.asarray(ns))
    return [np.asarray(v) for v in out]


def _port_inputs(x, w, pis, splits, ns):
    return (torch.from_numpy(x), None if w is None else torch.from_numpy(w),
            torch.from_numpy(ns), torch.from_numpy(pis).expand(x.shape[0], -1).contiguous(),
            torch.from_numpy(splits))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("acc", [torch.float32, torch.float64])
def test_lanes_that_run_to_num_iters_match_jax(jax_gmm, masked, acc):
    """num_iters = 3 stops every lane before tol can: all 88 lanes of a
    padded bucket of 8 (or 3 whole images) and all six outputs agree with
    JAX's, for the CPU path's float32 sums and the kernel twin's float64."""
    rng = np.random.default_rng(11 + masked)
    B, N = (8, 3000) if masked else (3, 3000)
    x, w = _mixture(rng, B, N, rng.integers(1500, N + 1, B) if masked else None)
    pis, splits, ns = _lane_inputs(x, w)
    want = _jax_fit(jax_gmm, x, w, pis, splits, ns, num_iters=3)
    xb, wb, n, pi, split = _port_inputs(x, w, pis, splits, ns)
    got, steps = tgmm._gmm_fit_plain(xb, wb, n, pi, split, ALPHA, BETA, 1.0, 1e-3, 3,
                                     acc=acc)
    assert torch.equal(steps, torch.full((B, 11), 3, dtype=torch.int32))
    names = ("logp", "mu0", "var0", "mu1", "var1", "pi")
    for name, g, v in zip(names, got, want):
        assert g.shape == (B, 11)
        np.testing.assert_allclose(g.numpy(), v, rtol=RTOL, atol=0, err_msg=name)
    if acc == torch.float32:
        # the public entry runs the CPU path
        pub = tgmm.gmm_fit(xb, pi, split, alpha=ALPHA, beta=BETA, num_iters=3, w=wb,
                           n=n if masked else None)
        for g, p in zip(got, pub):
            assert torch.equal(g, p)


@pytest.mark.parametrize("bins", [0, 2048])
def test_dead_frame_runs_to_num_iters_and_is_guarded(jax_gmm, bins):
    """A constant image in a padded bucket: every EM lane of it has a NaN
    logp and runs all num_iters steps (it never gains), in the plain version
    and its float64 twin alike; norm_fit/norm_fit_hist guard it to std 1
    and logp -inf as JAX does, and its batchmates keep JAX's fits."""
    jax, jnp, jgmm = jax_gmm
    rng = np.random.default_rng(21)
    x, w = _mixture(rng, 4, 2500, rng.integers(1200, 2501, 4), dead=2)
    pis, splits, ns = _lane_inputs(x, w)
    args = _port_inputs(x, w, pis, splits, ns)
    for acc in (torch.float32, torch.float64):
        out, steps = tgmm._gmm_fit_plain(*args, ALPHA, BETA, 1.0, 1e-3, 100, acc=acc)
        assert torch.equal(steps[2], torch.full((11,), 100, dtype=torch.int32))
        logp, mu0, var0, mu1, var1, pi = (v[2] for v in out)
        # the split leaves no spread: var 0, so the densities, pi and logp
        # are NaN, and the means fall back to the image's mean
        assert all(bool(torch.isnan(v).all()) for v in (logp, var0, var1, pi))
        assert bool((mu0 == 2.5).all()) and bool((mu1 == 2.5).all())
        assert all(bool(torch.isfinite(v[b]).all()) for v in out for b in (0, 1, 3))
    if bins:
        got = tgmm.norm_fit_hist(torch.from_numpy(x), bins=bins, w=torch.from_numpy(w))
        want = jax.vmap(lambda a, b: jgmm.norm_fit_hist(a, bins=bins, w=b))(
            jnp.asarray(x), jnp.asarray(w))
    else:
        got = tgmm.norm_fit(torch.from_numpy(x), w=torch.from_numpy(w))
        want = jax.vmap(lambda a, b: jgmm.norm_fit(a, w=b))(jnp.asarray(x), jnp.asarray(w))
    assert float(got[1][2]) == float(want[1][2]) == 1.0
    assert np.isneginf(float(got[3][2])) and np.isneginf(float(want[3][2]))
    for i, name in enumerate(("mu", "std", "pi", "logp")):
        np.testing.assert_allclose(got[i].numpy()[[0, 1, 3]], np.asarray(want[i])[[0, 1, 3]],
                                   rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("bins", [0, 4096])
def test_bucket_with_padding_matches_jax(jax_gmm, bins):
    """A bucket of 8 images of random valid extents, junk in the padding:
    the masked fits (the pipeline's call) agree with JAX's vmapped masked
    fits on the selected mu, std, pi and logp."""
    jax, jnp, jgmm = jax_gmm
    rng = np.random.default_rng(31 + bins)
    x, w = _mixture(rng, 8, 4096, rng.integers(2000, 4097, 8))
    if bins:
        got = tgmm.norm_fit_hist(torch.from_numpy(x), bins=bins, w=torch.from_numpy(w))
        want = jax.vmap(lambda a, b: jgmm.norm_fit_hist(a, bins=bins, w=b))(
            jnp.asarray(x), jnp.asarray(w))
    else:
        got = tgmm.norm_fit(torch.from_numpy(x), w=torch.from_numpy(w))
        want = jax.vmap(lambda a, b: jgmm.norm_fit(a, w=b))(jnp.asarray(x), jnp.asarray(w))
    for i, name in enumerate(("mu", "std", "pi", "logp")):
        assert got[i].shape == (8,)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=RTOL, atol=0,
                                   err_msg=name)


def test_unmasked_image_matches_jax(jax_gmm):
    """One whole image, as preprocess fits it (1D, no weights)."""
    _, jnp, jgmm = jax_gmm
    x, _ = _mixture(np.random.default_rng(41), 1, 6000)
    got = tgmm.norm_fit(torch.from_numpy(x[0]))
    want = jgmm.norm_fit(jnp.asarray(x[0]))
    for i, name in enumerate(("mu", "std", "pi", "logp")):
        np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=RTOL, err_msg=name)


def test_cpu_fit_never_loads_the_kernel(monkeypatch):
    """A CPU tensor goes to the plain version: the kernel's library is not
    built, loaded or counted by any entry point."""

    def refuse():
        raise AssertionError("the kernel's library was requested for a CPU tensor")

    monkeypatch.setattr(tgmm, "_library", refuse)
    before = tgmm.launches
    x, w = _mixture(np.random.default_rng(51), 3, 1024, [1024, 700, 900])
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    pis, splits, ns = _lane_inputs(x, w)
    tgmm.gmm_fit(xt, torch.from_numpy(pis), torch.from_numpy(splits), w=wt,
                 n=torch.from_numpy(ns))
    tgmm.norm_fit(xt, w=wt)
    tgmm.norm_fit_hist(xt, bins=256, w=wt)
    tgmm.normalize(x[0].reshape(32, 32), device="cpu")
    tgmm.normalize(x[0].reshape(32, 32), bins=128, device="cpu")
    assert tgmm.launches == before


@pytest.mark.parametrize("bad", ["x dtype", "w shape", "n shape", "pi shape",
                                 "split layout", "no pixels"])
def test_kernel_wrapper_refuses_malformed_inputs(monkeypatch, bad):
    """The kernel's wrapper checks dtype, shape and layout of every pointer
    it hands the kernel, and raises before the library is touched."""

    def refuse():
        raise AssertionError("the kernel's library was requested for malformed inputs")

    monkeypatch.setattr(tgmm, "_library", refuse)
    B, N, L = 2, 64, 11
    x, w = torch.rand(B, N), torch.ones(B, N)
    n, pi, split = torch.full((B,), float(N)), torch.rand(B, L), torch.rand(B, L)
    if bad == "x dtype":
        x = x.double()
    elif bad == "w shape":
        w = torch.ones(B, N + 1)
    elif bad == "n shape":
        n = torch.full((B + 1,), float(N))
    elif bad == "pi shape":
        pi = torch.rand(B, L + 1)
    elif bad == "split layout":
        split = torch.rand(L, B).t()
    else:
        x, w = torch.rand(B, 0), torch.ones(B, 0)
    with pytest.raises(ValueError, match="gmm_fit"):
        tgmm._gmm_fit_kernel(x, w, n, pi, split, ALPHA, BETA, 1.0, 1e-3, 100)


def test_gmm_fit_takes_every_form_of_its_arguments():
    """One image as (N,) with (L,) lanes, or as a batch of one; n as an
    int, a float, a tensor of (B,) or (B, 1), or left to be summed: one
    fit, bit for bit."""
    x, w = _mixture(np.random.default_rng(61), 2, 800, [800, 560])
    pis, splits, ns = _lane_inputs(x, w)
    xt, wt, pt, st = (torch.from_numpy(a) for a in (x, w, pis, splits))
    one = tgmm.gmm_fit(xt[0], pt, st[0], alpha=ALPHA, beta=BETA)
    batch = tgmm.gmm_fit(xt[:1], pt[None], st[:1], alpha=ALPHA, beta=BETA)
    for a, b in zip(one, batch):
        assert a.shape == (11,) and b.shape == (1, 11)
        assert torch.equal(a, b[0])
    ref = tgmm.gmm_fit(xt, pt, st, alpha=ALPHA, beta=BETA, w=wt)
    for n in (torch.from_numpy(ns), torch.from_numpy(ns)[:, None]):
        for a, b in zip(ref, tgmm.gmm_fit(xt, pt, st, alpha=ALPHA, beta=BETA, w=wt, n=n)):
            assert torch.equal(a, b)
    whole = torch.ones_like(xt[:1])
    ref = tgmm.gmm_fit(xt[:1], pt, st[:1], alpha=ALPHA, beta=BETA)
    for n in (800, 800.0):
        for a, b in zip(ref, tgmm.gmm_fit(xt[:1], pt, st[:1], alpha=ALPHA, beta=BETA,
                                          w=whole, n=n)):
            assert torch.equal(a, b)


def test_plain_history_records_each_lanes_stop():
    """The history a kernel's stops are held against: one entry a step of
    the loop; each lane runs while logp - logp_cur > tol and stops at the
    first step where it is not, or at num_iters."""
    x, w = _mixture(np.random.default_rng(71), 3, 2000, [2000, 1500, 1800])
    pis, splits, ns = _lane_inputs(x, w)
    history = []
    tol = np.float32(1e-3)
    _, steps = tgmm._gmm_fit_plain(*_port_inputs(x, w, pis, splits, ns), ALPHA, BETA, 1.0,
                                   1e-3, 100, acc=torch.float64, history=history)
    assert len(history) == int(steps.max())
    for b in range(3):
        for lane in range(11):
            k = int(steps[b, lane])
            gains = [float(h[0][b, lane]) for h in history[:k]]
            assert all(bool(h[2][b, lane]) for h in history[:k])
            assert all(not bool(h[2][b, lane]) for h in history[k:])
            assert all(g > tol for g in gains[:-1])
            assert gains[-1] <= tol or k == 100


# clusters of C blocks an H100 80GB HBM3 holds at once, as
# cudaOccupancyMaxActiveClusters gives them for the EM kernel (1024 threads
# a block, a block an SM; a cluster lives in one GPC), and the dynamic
# shared memory a block of it may take: 227 KB less its static 2040 bytes
H100_CLUSTERS = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15, 9: 9}
H100_SMEM = 232448 - 2040


def _h100_clusters(weighted, cluster, smem):
    return H100_CLUSTERS.get(cluster, 7) if smem <= H100_SMEM else 0


# (B, L, N, weighted) as the callers fit: one 512^2 micrograph, the
# pipeline's 8 x 512^2 and 8 x 768 x 512 buckets, the 65536-bin histogram
# of a bucket, a 4096^2 micrograph fit whole, one pixel, and a call at the
# launch limit (MAX_LANES lanes of the smallest cluster)
PLAN_SHAPES = [(1, 11, 512 * 512, False), (8, 11, 512 * 512, True), (8, 11, 768 * 512, True),
               (8, 11, 65536, True), (1, 11, 4096 * 4096, False), (1, 11, 1, False),
               (tgmm.MAX_LANES, 1, 64, False)]


@pytest.mark.parametrize("card", ["h100", "portable", "small smem"])
@pytest.mark.parametrize("B, L, N, weighted", PLAN_SHAPES)
def test_em_plan_is_valid_at_the_callers_shapes(B, L, N, weighted, card):
    """The plan covers the image with its slices, keeps as many of a
    slice's pixels as the shared memory it was given holds, takes clusters
    of more than 8 blocks only where the card holds them (a card that
    refuses non-portable sizes holds none), fits one launch, and asks for a
    cluster size of which the card holds at least one."""
    smem = 48 * 1024 if card == "small smem" else H100_SMEM
    asked = []

    def active(weighted, cluster, nbytes):
        asked.append((cluster, nbytes))
        if card == "portable" and cluster > 8:
            return 0
        return _h100_clusters(weighted, cluster, nbytes)

    plan = tgmm._em_plan(B, L, N, weighted, 132, smem, active)
    assert 2 <= plan.cluster <= (8 if card == "portable" else tgmm.MAX_CLUSTER)
    assert plan.slice == -(-N // plan.cluster) and plan.cluster * plan.slice >= N
    assert plan.kept == min(plan.slice, smem // 8)
    assert plan.smem == 8 * plan.kept <= smem
    assert plan.route == ("resident" if plan.kept == plan.slice else "recompute")
    assert active(weighted, plan.cluster, plan.smem) >= 1
    assert (plan.cluster, plan.smem) in asked
    assert B * L * plan.cluster <= tgmm.MAX_GRID
    if B * L == tgmm.MAX_LANES:
        assert plan.cluster == 2


def test_em_plan_routes_at_the_shared_memory_limit():
    """One 512^2 micrograph keeps its responsibilities in shared memory on
    an H100, a 4096^2 micrograph recomputes most; at 16 blocks of
    H100_SMEM // 8 pixels the route changes between N and N + 1."""
    def plan(B, N, weighted=True):
        return tgmm._em_plan(B, 11, N, weighted, 132, H100_SMEM, _h100_clusters)

    assert plan(1, 512 * 512, False).route == "resident"
    assert plan(1, 4096 * 4096, False).route == "recompute"
    limit = 16 * (H100_SMEM // 8)
    at, above = plan(1, limit, False), plan(1, limit + 1, False)
    assert (at.route, at.cluster, at.kept) == ("resident", 16, H100_SMEM // 8)
    assert above.route == "recompute"


@pytest.mark.parametrize("why", ["too many lanes", "no cluster fits", "no pixels"])
def test_em_plan_refuses_what_no_cluster_runs(why):
    B, N, active = 8, 4096, _h100_clusters
    if why == "too many lanes":
        B = tgmm.MAX_LANES + 1
    elif why == "no cluster fits":
        active = lambda weighted, cluster, smem: 0  # noqa: E731
    else:
        N = 0
    with pytest.raises(ValueError, match="gmm_fit"):
        tgmm._em_plan(B, 1 if why == "too many lanes" else 11, N, False, 132, H100_SMEM, active)


@pytest.mark.parametrize("B, L", [(1, 11), (8, 11), (3, 5), (5, 1)])
def test_lane_order_round_trips(B, L):
    """The kernel's lane-major grid: a permutation of the B x L outputs
    whose inverse gives back each (image, lane) pair, and the B images'
    lane 0 (pi 0.1, the longest) first."""
    order = tgmm._lane_order(B, L)
    assert sorted(order.tolist()) == list(range(B * L))
    inverse = torch.empty_like(order)
    inverse[order] = torch.arange(B * L)
    for b in range(B):
        for lane in range(L):
            q = int(inverse[b * L + lane])
            assert q == lane * B + b and divmod(int(order[q]), L) == (b, lane)
    assert order[:B].tolist() == [b * L for b in range(B)]


def _card_plan(x, w, route):
    """The device's plan for the fit of (x, w), or ("other") where it is
    resident the recompute route at its size with no pixel kept, else the
    cheapest plan of another size."""
    B, N = x.shape
    index = x.device.index if x.device.index is not None else torch.cuda.current_device()
    plan = tgmm._device_plan(index, B, 11, N, w is not None)
    if route == "planned":
        return plan
    if plan.route == "resident":
        return plan._replace(kept=0, smem=0)
    found = tgmm._em_candidates(
        B, 11, N, w is not None, torch.cuda.get_device_properties(index).multi_processor_count,
        tgmm._smem_limit(index), functools.partial(tgmm._max_clusters, index))
    return min((f for f in found if f[0] != plan), key=lambda f: f[2])[0]


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["planned", "other"])
@pytest.mark.parametrize("weights", ["none", "0/1", "counts"])
@pytest.mark.parametrize("N", [4096, 262144, "limit", "limit+1"])
@pytest.mark.parametrize("B", [1, 8])
def test_kernel_matches_plain_twin_on_the_card(cuda_device, B, N, weights, route):
    """The kernel against the plain version with float64 sums on the same
    inputs, on the card: mu, std, pi and logp within 1e-5 relative, each
    lane at the twin's step (or one apart at a tie with tol), one launch a
    fit; on the device's plan and on the other route (or another cluster
    size), and on both sides of the largest N whose slices fit in shared
    memory (``N`` "limit" and "limit+1")."""
    if isinstance(N, str):
        limit = tgmm.MAX_CLUSTER * (tgmm._smem_limit(torch.cuda.current_device()) // 8)
        N = limit + (N == "limit+1")
    rng = np.random.default_rng(B * 1000 + N % 997 + len(weights))
    if weights == "counts":
        x, _ = em_mixture(rng, B, 4 * N)
        inputs, opts = em_inputs(tgmm.norm_fit_hist, x, bins=N)
    elif weights == "0/1":
        x, w = em_mixture(rng, B, N, rng.integers(N // 2, N + 1, B))
        inputs, opts = em_inputs(tgmm.norm_fit, x, w=w)
    else:
        x, _ = em_mixture(rng, B, N)
        inputs, opts = em_inputs(tgmm.norm_fit, x)
    alpha, beta, scale, num_iters = opts
    args = inputs + (alpha, beta, scale, 1e-3, num_iters)
    plan = _card_plan(inputs[0], inputs[1], route)
    before = tgmm.launches
    kern, ksteps = tgmm._gmm_fit_kernel(*args, plan=plan)
    torch.cuda.synchronize()
    assert tgmm.launches == before + 1
    history = []
    twin, tsteps = tgmm._gmm_fit_plain(*args, acc=torch.float64, history=history)
    history = [dict(zip(("gain", "logp", "running", "mu0", "var", "mu1", "pi"), h))
               for h in history]
    errs, _, ties, bad = em_compare(kern, ksteps, twin, tsteps, history)
    assert not bad, f"lanes stopping elsewhere than the twin: {bad} ({plan})"
    assert max(errs.values()) <= RTOL, (errs, plan)
    assert math.isfinite(sum(errs.values()))
