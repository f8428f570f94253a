"""The masked engine on a tree of mixed leaf dtypes (bf16 and fp32 leaves
under a mask and staleness weights), against the JAX package's gather
tree path, leaf for leaf.

The coordinate-wise rules with a masked kernel (coordinate_median,
trimmed_mean, sign_sgd) launch it once per uniform-dtype segment on the
kernel impl (plain versions on the CPU) and run the arrived-window law per
leaf on the gather impl; the pairwise kernel rules (krum) fall back to the
imputed tree path with a one-time warning.  JAX's own Pallas test of this
tree fails on jax 0.9.0 (ROADMAP.md R1), so the port is held to JAX's
gather path.  Bars: median, sign and krum exact; trimmed means within
rtol = atol = 3e-6 in fp32 leaves and 2e-2 in bf16 leaves (a bf16 value
rounded after a reassociated sum).
"""
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy, tensor_to_numpy
from repro_torch.core import aggregators as A
from repro_torch.core.aggregators import make_spec

torch.set_num_threads(2)
N, F = 8, 2
TOL, BF16_TOL = 3e-6, 2e-2
COORD_RULES = ["coordinate_median", "trimmed_mean", "sign_sgd"]
EXACT = ("coordinate_median", "sign_sgd", "krum")
DISCOUNTS = np.array([1.0, 0.5, 1.0 / 3.0], np.float32)


def mixed_tree(seed, hazard=None):
    """{a: (N, 5, 7) bf16, b: {c: (N, 11) fp32, e: (N, 3, 4) bf16}} of
    normal * 2 values (numpy, ml_dtypes bf16); ``hazard="nan_absent"``
    puts NaN and inf in row 0, which the mask leaves out."""
    rng = np.random.default_rng(seed)

    def leaf(*shape):
        return (rng.normal(size=(N,) + shape) * 2.0).astype(np.float32)

    a, c, e = leaf(5, 7), leaf(11), leaf(3, 4)
    if hazard == "nan_absent":
        a[0, ::2], c[0, 1::3], e[0] = np.nan, np.inf, np.nan
    bf = lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))   # noqa: E731
    return {"a": bf(a), "b": {"c": c, "e": bf(e)}}


def masks():
    """(mask, weights) cases: 6 of 8 live (row 0 absent) with staleness
    weights, 6 of 8 unweighted, 1 of 8, and all 8 with weights."""
    out = []
    for live, weighted in ((6, True), (6, False), (1, True), (8, True)):
        m = np.zeros(N, bool)
        m[N - live:] = True
        w = (DISCOUNTS[np.arange(N) % 3] * m).astype(np.float32)
        out.append((m, w if weighted else None))
    return out


def to_torch(tree):
    return {"a": tensor_from_numpy(tree["a"]),
            "b": {k: tensor_from_numpy(v) for k, v in tree["b"].items()}}


def leaves(tree):
    return [tree["a"], tree["b"]["c"], tree["b"]["e"]]


@functools.lru_cache(maxsize=None)
def _jax_gather_fn(rule, weighted):
    """The jitted JAX gather call, built once per (rule, weighted) so that
    the cases of one tree share its compile."""
    spec = jax_make_spec(rule, f=F, impl="gather", n=N)
    if weighted:
        return jax.jit(lambda g, m, w: spec.aggregate(g, mask=m, weights=w))
    return jax.jit(lambda g, m: spec.aggregate(g, mask=m))


def jax_gather(rule, tree, mask, w):
    """The JAX gather tree path, jitted as the JAX steps run it."""
    fn = _jax_gather_fn(rule, w is not None)
    jt = jax.tree.map(jnp.asarray, tree)
    if w is None:
        return fn(jt, jnp.asarray(mask))
    return fn(jt, jnp.asarray(mask), jnp.asarray(w))


def check_leaves(rule, ours, ref, msg):
    for o, r in zip(leaves(ours), leaves(ref)):
        assert str(o.dtype).replace("torch.", "") == str(r.dtype), msg
        assert tuple(o.shape) == r.shape, msg
        o = tensor_to_numpy(o).astype(np.float32)
        r = np.asarray(r).astype(np.float32)
        if rule in EXACT:
            np.testing.assert_array_equal(o, r, err_msg=msg)
        else:
            tol = TOL if np.asarray(r).dtype == np.float32 else BF16_TOL
            np.testing.assert_allclose(o, r, rtol=tol, atol=tol, err_msg=msg)


@pytest.mark.parametrize("hazard", [None, "nan_absent"])
@pytest.mark.parametrize("impl", ["kernel", "gather"])
@pytest.mark.parametrize("rule", COORD_RULES)
def test_coordinate_rules_on_a_mixed_tree_match_jax(rule, impl, hazard):
    """Per dtype segment on the kernel impl (one masked kernel launch per
    dtype, no fallback warning), per leaf on the gather impl.  With the
    NaN / inf row absent, the reference is JAX's on the clean tree: an
    absent row's content is irrelevant (JAX's vote would leak its NaN,
    ROADMAP.md P10)."""
    tree, clean = mixed_tree(1, hazard), mixed_tree(1)
    spec = make_spec(rule, f=F, impl=impl, n=N)
    for mask, w in masks():
        if hazard and mask[0]:
            continue                # the hazard row is the absent one
        with warnings.catch_warnings():
            warnings.simplefilter("error")          # no fallback warning
            ours = spec.aggregate(
                to_torch(tree), mask=torch.from_numpy(mask),
                weights=None if w is None else tensor_from_numpy(w))
        msg = f"{rule} {impl} {hazard} live={mask.sum()} w={w is not None}"
        check_leaves(rule, ours, jax_gather(rule, clean, mask, w), msg)
        if hazard == "nan_absent":
            assert all(bool(torch.isfinite(o).all())
                       for o in leaves(ours)), msg


def test_kernel_impl_launches_one_masked_kernel_per_dtype(monkeypatch):
    """The kernel impl's segments: one call of the masked entry per leaf
    dtype, each on the concatenation of that dtype's leaves."""
    seen = []
    real = kernels.kernel_masked_aggregate

    def spy(name, stack, *a):
        seen.append((stack.dtype, tuple(stack.shape)))
        return real(name, stack, *a)

    monkeypatch.setattr(kernels, "kernel_masked_aggregate", spy)
    mask, w = masks()[0]
    make_spec("trimmed_mean", f=F, n=N).aggregate(
        to_torch(mixed_tree(2)), mask=torch.from_numpy(mask),
        weights=tensor_from_numpy(w))
    assert sorted(seen, key=str) == sorted(
        [(torch.bfloat16, (N, 35 + 12)), (torch.float32, (N, 11))], key=str)


@pytest.mark.parametrize("impl", ["kernel", "gather"])
def test_krum_on_a_mixed_tree_takes_the_imputed_fallback(impl):
    """krum: the imputed tree path on both impls, leaf for leaf equal to
    JAX's; the kernel impl warns once (the same key as JAX's), the gather
    impl never."""
    key_dts = ("bfloat16", "float32")
    A._WARNED_ONCE.discard(("masked-pallas-mixed-dtype", "krum", key_dts))
    spec = make_spec("krum", f=F, impl=impl, n=N)
    tree = mixed_tree(3)
    for k, (mask, w) in enumerate(masks()):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            ours = spec.aggregate(
                to_torch(tree), mask=torch.from_numpy(mask),
                weights=None if w is None else tensor_from_numpy(w))
        fallback = [r for r in rec if "mixed dtypes" in str(r.message)]
        assert len(fallback) == (1 if impl == "kernel" and k == 0 else 0)
        check_leaves("krum", ours, jax_gather("krum", tree, mask, w),
                     f"krum {impl} live={mask.sum()}")


def test_mean_on_a_mixed_tree_matches_jax():
    """mean's exact weighted mean of the arrived rows, per leaf."""
    tree = mixed_tree(4)
    spec = make_spec("mean", f=F, n=N)
    for mask, w in masks():
        ours = spec.aggregate(
            to_torch(tree), mask=torch.from_numpy(mask),
            weights=None if w is None else tensor_from_numpy(w))
        check_leaves("trimmed_mean", ours, jax_gather("mean", tree, mask, w),
                     f"mean live={mask.sum()}")
