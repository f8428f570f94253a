"""centered_clip and K22 clipped_weighted_sum against the JAX package.

centered_clip iterates v <- v + sum_i lam_i (x_i - v), lam_i = w_i / tot *
min(1, tau / ||x_i - v||), from the carried center ``server_grad``.  Its
flat law runs the multiply-accumulate on K22 under ``impl="kernel"`` (the
JAX ``pallas``; on the CPU the wrapper's plain version) and the dense body
under ``gather``; the clip radius is plain torch on both.

Bars: every comparison here reassociates an fp32 sum (the JAX kernel's
``dot_general``, the row norms), so fp32 rtol = atol = 3e-6; a bf16 arena
holds bf16 values upcast exactly, so the same bar.  JAX runs its kernel
only at P % 512 == 0 (its 512-lane tile); at another P it falls back to
its dense body, and the port's kernel path is held to that.  A row with
lam = 0 (absent, or given no weight) is never read: its inf or NaN does
not reach the output.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.kernels.wsum import clipped_weighted_sum as jax_cws
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy
from repro_torch.core.aggregators import cclip_iterates, make_spec
from repro_torch.kernels.wsum import clipped_weighted_sum_plain

torch.set_num_threads(2)
TOL = 3e-6
N, F = 8, 2


def lam_of(n, seed, zeros=()):
    """(n,) fp32 clip-folded weights >= 0 summing to <= 1, 0 at
    ``zeros``."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.01, 1.0, size=n).astype(np.float32)
    lam[list(zeros)] = 0.0
    return (lam / max(lam.sum(), 1e-6) * 0.9).astype(np.float32)


def rows_of(n, d, seed, dtype="float32", hazard_rows=()):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n, d)).astype(np.float32)
    for k, i in enumerate(hazard_rows):
        g[i, ::3] = (np.inf, np.nan, -np.inf)[k % 3]
    return g.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else g


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("case", ["plain", "dead_nonfinite", "all_zero",
                                  "sum_one"])
def test_k22_plain_matches_jax_kernel(dtype, n, case):
    d = 1024
    dead = [i for i in (0, 2) if i < n] if case == "dead_nonfinite" else []
    lam = lam_of(n, 1, dead)
    if case == "all_zero":
        lam[:] = 0.0
    if case == "sum_one":
        lam = np.full(n, 1.0 / n, np.float32)
    g = rows_of(n, d, 2, dtype, hazard_rows=dead)
    v = np.random.default_rng(3).normal(size=d).astype(np.float32)
    want = np.asarray(jax_cws(jnp.asarray(lam), jnp.asarray(g),
                              jnp.asarray(v), interpret=True))
    got = kernels.clipped_weighted_sum(torch.from_numpy(lam),
                                       tensor_from_numpy(g),
                                       torch.from_numpy(v)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    if case == "all_zero":
        # (1 - 0) v + nothing: the center itself, exactly
        np.testing.assert_array_equal(got, v)


def test_k22_plain_is_the_kernel_order_and_counts_no_launch():
    """The plain version is the kernel's arithmetic: one rounded sum per
    row of lam, an fma chain over the rows with lam > 0, then
    fma(1 - sum, v, acc); a one-hot lam = 1 gives the row exactly; a CPU
    call counts no launch."""
    g = rows_of(4, 37, 5)                      # any d: 37 is prime
    v = np.random.default_rng(6).normal(size=37).astype(np.float32)
    lam = np.array([0.0, 1.0, 0.0, 0.0], np.float32)
    before = kernels.clipped_weighted_sum.launches
    out = clipped_weighted_sum_plain(torch.from_numpy(lam),
                                     torch.from_numpy(g),
                                     torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(out, g[1])
    one = kernels.clipped_weighted_sum(torch.ones(1), torch.from_numpy(g[:1]),
                                       torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(one, g[0])
    assert kernels.clipped_weighted_sum.launches == before


def test_k22_wrapper_rejects_bad_input():
    g, v = torch.zeros(3, 8), torch.zeros(8)
    with pytest.raises(ValueError):
        kernels.clipped_weighted_sum(torch.zeros(2), g, v)
    with pytest.raises(ValueError):
        kernels.clipped_weighted_sum(torch.zeros(3), g, torch.zeros(7))
    with pytest.raises(ValueError):
        kernels.clipped_weighted_sum(torch.zeros(3), g, v.double())
    with pytest.raises(TypeError):
        kernels.clipped_weighted_sum(torch.zeros(3), g.double(), v)
    with pytest.raises(ValueError):
        kernels.clipped_weighted_sum(torch.zeros(65), torch.zeros(65, 8), v)


# ---------------------------------------------------------------------------
# centered_clip's flat law


def masked_inputs(mode, n=N, seed=11):
    """(mask, weights) as numpy, or None: "plain" (neither), "masked" (6 of
    8 arrived, unit weights), "weighted" (6 of 8, staleness discounts)."""
    if mode == "plain":
        return None, None
    m = np.ones(n, bool)
    m[[1, 5]] = False
    if mode == "masked":
        return m, None
    w = np.array([1.0, 0.5, 1.0, 1.0 / 3.0, 0.5, 1.0, 1.0, 0.5], np.float32)
    return m, w[:n]


def cclip_case(d, mode, dtype="float32", seed=21, tau=0.5, iters=5,
               dead_hazard=False):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(N, d)) * 0.3).astype(np.float32)
    g[:F] = -1.5 * g[F:].mean(0)               # two sign-flipped rows
    m, w = masked_inputs(mode)
    if dead_hazard and m is not None:
        g[1, ::2] = np.inf
        g[5, 1::2] = np.nan
    if dtype == "bfloat16":
        g = g.astype(ml_dtypes.bfloat16)
    center = (rng.normal(size=d) * 0.05).astype(np.float32)
    return g, m, w, center, dict(tau=tau, iters=iters)


def run_both(g, m, w, center, hyper, impl, jax_impl, qscale=None):
    jspec = jax_make_spec("centered_clip", f=F, impl=jax_impl, n=N, **hyper)
    tspec = make_spec("centered_clip", f=F, impl=impl, n=N, **hyper)
    jout = np.asarray(jspec.aggregate_flat(
        jnp.asarray(g), None if m is None else jnp.asarray(m),
        None if w is None else jnp.asarray(w),
        state={"server_grad": jnp.asarray(center)},
        scale=None if qscale is None else jnp.asarray(qscale)))
    tout = tspec.aggregate_flat(
        tensor_from_numpy(g), None if m is None else torch.from_numpy(m),
        None if w is None else torch.from_numpy(w),
        state={"server_grad": torch.from_numpy(center)},
        scale=None if qscale is None else torch.from_numpy(qscale)).numpy()
    return jout, tout


@pytest.mark.parametrize("mode", ["plain", "masked", "weighted"])
@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_centered_clip_matches_jax(mode, impl, dtype):
    """P = 1024: JAX's pallas impl runs its kernel; the port's kernel impl
    is held to it, the gather impl to JAX's gather (dense body)."""
    g, m, w, center, hyper = cclip_case(1024, mode, dtype,
                                        dead_hazard=True)
    jout, tout = run_both(g, m, w, center, hyper, impl,
                          "pallas" if impl == "kernel" else "gather")
    assert np.isfinite(tout).all()
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["plain", "weighted"])
def test_centered_clip_kernel_any_width(mode):
    """P = 1000 (not a multiple of 512): JAX's pallas impl takes its dense
    body; the port's kernel takes any P and is held to it."""
    g, m, w, center, hyper = cclip_case(1000, mode)
    jout, tout = run_both(g, m, w, center, hyper, "kernel", "pallas")
    np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_centered_clip_each_iterate_matches_jax(impl):
    """Each of the 5 iterates (JAX run with iters = 1 .. 5) within the
    fp32 bar, and the kernel and gather iterates of the port within it
    of each other."""
    g, m, w, center, hyper = cclip_case(1024, "weighted")
    spec = make_spec("centered_clip", f=F, impl=impl, n=N, **hyper)
    its = list(cclip_iterates(spec, torch.from_numpy(g),
                              torch.from_numpy(m), torch.from_numpy(w),
                              {"server_grad": torch.from_numpy(center)}))
    assert len(its) == 5
    for k, it in enumerate(its, 1):
        jout, _ = run_both(g, m, w, center, dict(hyper, iters=k), impl,
                           "pallas" if impl == "kernel" else "gather")
        np.testing.assert_allclose(it.numpy(), jout, rtol=TOL, atol=TOL,
                                   err_msg=f"iterate {k}")


@pytest.mark.parametrize("mode", ["plain", "weighted"])
def test_centered_clip_on_an_int8_arena(mode):
    """int8 codes and row scales fed to both packages by value: the arena
    is dequantized first, then the law runs on the fp32 rows (K22 on them
    under the kernel impl)."""
    rng = np.random.default_rng(31)
    codes = rng.integers(-127, 128, size=(N, 1024)).astype(np.int8)
    qs = rng.uniform(1e-3, 1e-2, size=N).astype(np.float32)
    m, w = masked_inputs(mode)
    center = (rng.normal(size=1024) * 0.05).astype(np.float32)
    for impl, jimpl in (("kernel", "pallas"), ("gather", "gather")):
        jout, tout = run_both(codes, m, w, center, dict(tau=0.3), impl,
                              jimpl, qscale=qs)
        np.testing.assert_allclose(tout, jout, rtol=TOL, atol=TOL,
                                   err_msg=impl)


def test_centered_clip_routes():
    """``auto`` keeps the dense body (JAX's FLAT_SELF_KERNELED), an
    explicit kernel is accepted; the tree route returns fp32 leaves (the
    JAX tree law's fp32 center) and the flat law's values."""
    assert make_spec("centered_clip", f=F).impl == "gather"
    assert make_spec("centered_clip", f=F, impl="kernel").impl == "kernel"
    g, m, w, center, hyper = cclip_case(64, "weighted", "bfloat16")
    spec = make_spec("centered_clip", f=F, n=N, **hyper)
    tg = tensor_from_numpy(g)
    tree = {"a": tg[:, :40].reshape(N, 5, 8), "b": tg[:, 40:]}
    st = {"server_grad": torch.from_numpy(center)}
    out = spec.aggregate(tree, torch.from_numpy(m), torch.from_numpy(w),
                         state=st)
    flat = spec.aggregate_flat(tg, torch.from_numpy(m), torch.from_numpy(w),
                               state=st)
    assert out["a"].dtype == out["b"].dtype == torch.float32
    np.testing.assert_array_equal(
        torch.cat([out["a"].reshape(-1), out["b"]]).numpy(), flat.numpy())
