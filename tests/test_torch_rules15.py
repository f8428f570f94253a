"""The rules without a kernel (phocas, mean_around_median, cgc,
geometric_median, rfa, median_of_means, zeno) and the parallel ensemble
``compose`` against the JAX package: the dense laws at n = 5, 8 and 11
on plain, tied, signed-zero, +-inf and sign_flip (equal-row) stacks;
the masked closest-to-center law ``ref.arrived_mean_closest_ref`` at 0,
fewer than f + 1, some and all rows arrived; the registry's flat and tree
engines, synchronous and masked, in fp32 and bf16; and the laws of
``tests/test_membership_conformance.py`` on the new rules.

Neither package has a kernel for these rules: the JAX side runs its
``gather`` impl, the port's ``auto`` resolves to ``gather``.  Bars: fp32
within rtol = atol = 3e-6, bf16 within 2e-2; the departed-row law bit
for bit, as in JAX.  geometric_median and rfa meet the fp32 bar after 32
Weiszfeld iterations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.filters as JF
import repro.kernels.ref as jref
from repro.core.aggregators import make_spec as jax_make_spec
from repro_torch.core.aggregators import make_spec
from repro_torch.core.attacks import get_attack, make_byzantine_mask
from repro_torch.core.filters import dense as D
from repro_torch.kernels import ref
from test_torch_kernels import stack

torch.set_num_threads(2)
TOL = 3e-6
BF16_TOL = 2e-2
DIM = 257
RULES = ["phocas", "mean_around_median", "geometric_median", "rfa",
         "median_of_means", "cgc", "zeno"]
STATELESS = [r for r in RULES if r != "zeno"]
HAZARDS = [None, "ties", "signed_zero", "inf", "flipped"]
NF = {5: 1, 8: 2, 11: 2}


def hazard_stack(n, hazard, seed=None):
    """(n, DIM) fp32 numpy: :func:`test_torch_kernels.stack`, or
    ``flipped``: its first f rows replaced by sign_flip's bitwise-equal
    -mean."""
    seed = n if seed is None else seed
    if hazard != "flipped":
        return stack(n, DIM, seed, hazard)
    g = torch.from_numpy(stack(n, DIM, seed))
    return get_attack("sign_flip")(
        None, g, make_byzantine_mask(n, NF[n])).numpy()


def server_grad(d=DIM):
    return np.random.default_rng(11).normal(size=d).astype(np.float32)


def test_filter_registry_matches_jax():
    assert set(D.FILTERS) == set(JF.FILTERS)


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", sorted(NF))
@pytest.mark.parametrize("rule", RULES + ["compose"])
def test_dense_law_matches_jax(rule, n, hazard):
    g = hazard_stack(n, hazard)
    f = NF[n]
    kw_t, kw_j = {}, {}
    if rule == "zeno":
        v = server_grad()
        kw_t, kw_j = {"server_grad": torch.from_numpy(v)}, {
            "server_grad": jnp.asarray(v)}
    if rule == "compose":
        names = ("mean", "coordinate_median", "trimmed_mean")
        tfn, jfn = D.compose(*names), JF.compose(*names)
    else:
        tfn, jfn = D.FILTERS[rule], JF.FILTERS[rule]
    ours = tfn(torch.from_numpy(g), f, **kw_t).numpy()
    want = np.asarray(jfn(jnp.asarray(g), f, **kw_j))
    np.testing.assert_allclose(ours, want, rtol=TOL, atol=TOL,
                               err_msg=f"{rule} n={n} {hazard}")


@pytest.mark.parametrize("hazard", [None, "ties"])
def test_compose_of_selection_and_iterative_rules(hazard):
    g = hazard_stack(8, hazard)
    names = ("krum", "phocas", "geometric_median")
    np.testing.assert_allclose(
        D.compose(*names)(torch.from_numpy(g), 2).numpy(),
        np.asarray(JF.compose(*names)(jnp.asarray(g), 2)), rtol=TOL,
        atol=TOL)


def test_get_filter_binds_hyper():
    g = torch.from_numpy(hazard_stack(8, None))
    np.testing.assert_array_equal(
        D.get_filter("geometric_median", iters=3)(g, 0).numpy(),
        D.geometric_median(g, 0, iters=3).numpy())
    assert D.get_filter("cgc") is D.cgc


# ---------------------------------------------------------------------------
# the masked closest-to-center law


def arrival(n, case):
    m = np.ones(n, bool)
    if case == "none":
        m[:] = False
    elif case == "few":                  # 2 arrived < f + 1 = 3
        m[:] = False
        m[[2, 5]] = True
    elif case == "some":
        m[[0, 3]] = False
    return m


@pytest.mark.parametrize("hazard", [None, "ties", "signed_zero", "inf"])
@pytest.mark.parametrize("case", ["none", "few", "some", "full"])
@pytest.mark.parametrize("stat", ["trimmed_mean", "median"])
def test_arrived_mean_closest_matches_jax(stat, case, hazard):
    """At n = 8, f = 2; the absent rows hold NaN, which must not enter."""
    g = hazard_stack(8, hazard)
    m = arrival(8, case)
    g[~m] = np.nan
    ours = ref.arrived_mean_closest_ref(torch.from_numpy(g),
                                        torch.from_numpy(m), stat, 2)
    want = jref.arrived_mean_closest_ref(jnp.asarray(g), jnp.asarray(m),
                                         stat, 2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    if case == "none":
        assert not ours.any()


def test_arrived_mean_closest_chunks_change_no_bit(monkeypatch):
    g = torch.from_numpy(hazard_stack(8, "ties"))
    m = torch.from_numpy(arrival(8, "some"))
    whole = ref.arrived_mean_closest_ref(g, m, "median", 2)
    monkeypatch.setattr(ref, "_CLOSEST_CHUNK", 5)
    assert torch.equal(ref.arrived_mean_closest_ref(g, m, "median", 2),
                       whole)
    whole = D.phocas(g, 2)
    monkeypatch.setattr(D, "_CLOSEST_CHUNK", 5)
    assert torch.equal(D.phocas(g, 2), whole)


# ---------------------------------------------------------------------------
# the registry's engines


def spec_pair(rule, n=8, f=2):
    hyper = {"ema": 0.2, "rho": 1e-4} if rule == "zeno" else {}
    return (jax_make_spec(rule, f=f, impl="gather", n=n, **hyper),
            make_spec(rule, f=f, n=n, **hyper))


def state_pair(rule, d=DIM):
    if rule != "zeno":
        return None, None
    v = server_grad(d)
    return {"server_grad": jnp.asarray(v)}, {"server_grad":
                                             torch.from_numpy(v)}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", RULES)
def test_spec_on_the_arena_matches_jax(rule, dtype, masked):
    """``aggregate_flat`` of the port against the JAX engine on the same
    (n, d) stack (JAX's flat path; zeno, not flat-capable in JAX, through
    its tree engine on a one-leaf tree), with the mask and staleness
    weights of a straggler row."""
    js, ts = spec_pair(rule)
    assert ts.impl == "gather"
    g = hazard_stack(8, None) * 0.5
    jg = jnp.asarray(g).astype(dtype)
    tg = torch.from_numpy(g).to(getattr(torch, dtype))
    jst, tst = state_pair(rule)
    m = arrival(8, "some")
    w = np.where(m, np.linspace(0.4, 1.0, 8), 0.0).astype(np.float32)
    kw_j = dict(mask=jnp.asarray(m), weights=jnp.asarray(w)) if masked \
        else {}
    kw_t = dict(mask=torch.from_numpy(m), weights=torch.from_numpy(w)) \
        if masked else {}
    if js.flat_capable:
        want = np.asarray(js.aggregate_flat(jg, state=jst, **kw_j),
                          np.float32)
    else:
        want = np.asarray(js.aggregate(jg, state=jst, **kw_j), np.float32)
    ours = ts.aggregate_flat(tg, state=tst, **kw_t)
    assert ours.dtype == torch.float32
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(ours.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rule", RULES)
def test_spec_on_a_tree_matches_jax(rule, masked):
    """``aggregate`` on a two-leaf fp32 tree, and (masked) on a tree of
    fp32 and bf16 leaves for the stateless rules: the leaf dtypes and the
    values of the JAX tree engine."""
    js, ts = spec_pair(rule)
    g = hazard_stack(8, None) * 0.5
    mixed = masked and rule != "zeno"
    jt = {"a": jnp.asarray(g[:, :100]).reshape(8, 10, 10),
          "b": jnp.asarray(g[:, 100:])}
    tt = {"a": torch.from_numpy(g[:, :100].copy()).reshape(8, 10, 10),
          "b": torch.from_numpy(g[:, 100:].copy())}
    if mixed:
        jt["b"] = jt["b"].astype(jnp.bfloat16)
        tt["b"] = tt["b"].to(torch.bfloat16)
    jst, tst = state_pair(rule)
    m = arrival(8, "some")
    kw_j = dict(mask=jnp.asarray(m)) if masked else {}
    kw_t = dict(mask=torch.from_numpy(m)) if masked else {}
    want = js.aggregate(jt, state=jst, **kw_j)
    ours = ts.aggregate(tt, state=tst, **kw_t)
    for k in ("a", "b"):
        assert str(ours[k].dtype).endswith(str(want[k].dtype))
        tol = BF16_TOL if ours[k].dtype == torch.bfloat16 else TOL
        np.testing.assert_allclose(ours[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=tol, atol=tol, err_msg=k)


# ---------------------------------------------------------------------------
# the membership laws (tests/test_membership_conformance.py)

CN, CF, CD = 12, 2, 48


def conformance_data(seed):
    return (np.random.default_rng(seed).normal(size=(CN, CD)) * 2.0).astype(
        np.float32)


def conformance_spec(rule):
    hyper = {"ema": 0.2, "rho": 1e-4} if rule == "zeno" else {}
    spec = make_spec(rule, f=CF, n=CN, **hyper)
    return spec


def conformance_state(spec, g):
    return ({"server_grad": g.mean(0)} if spec.stateful else None)


@pytest.mark.parametrize("rule", sorted(set(RULES) - {"median_of_means"}))
def test_permutation_invariance(rule):
    """(median_of_means groups rows by position: exempt, as in JAX)."""
    spec = conformance_spec(rule)
    g = torch.from_numpy(conformance_data(0))
    st = conformance_state(spec, g)
    perm = torch.from_numpy(np.random.default_rng(77).permutation(CN))
    np.testing.assert_allclose(spec.aggregate(g, state=st).numpy(),
                               spec.aggregate(g[perm], state=st).numpy(),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("rule", RULES)
def test_departed_row_content_is_irrelevant(rule):
    spec = conformance_spec(rule)
    g = torch.from_numpy(conformance_data(10))
    mask = torch.ones(CN, dtype=torch.bool)
    mask[[1, 6, 9]] = False
    st = conformance_state(spec, g)
    garbage = torch.where(mask[:, None], g, -1e6 * (g + 3.0))
    assert torch.equal(spec.aggregate(g, mask=mask, state=st),
                       spec.aggregate(garbage, mask=mask, state=st))


@pytest.mark.parametrize("rule", RULES)
def test_full_roster_mask_is_identity(rule):
    spec = conformance_spec(rule)
    g = torch.from_numpy(conformance_data(5))
    st = conformance_state(spec, g)
    np.testing.assert_allclose(
        spec.aggregate(g, state=st).numpy(),
        spec.aggregate(g, mask=torch.ones(CN, dtype=torch.bool),
                       state=st).numpy(), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# build-time keys


def test_hyper_and_impl_keys():
    gm = make_spec("geometric_median", nu=1e-6, iters=4)
    assert gm.hyper == (("iters", 4), ("nu", 1e-6))     # nu kept, not fed
    g = torch.from_numpy(hazard_stack(8, None))
    np.testing.assert_array_equal(gm.aggregate_flat(g).numpy(),
                                  D.geometric_median(g, 0, iters=4).numpy())
    for rule in ("phocas", "mean_around_median"):
        assert make_spec(rule, f=2, native_dtype=True).hyper == ()
    with pytest.raises(ValueError, match="unknown hyper"):
        make_spec("cgc", f=2, native_dtype=True)
    for rule in RULES:
        with pytest.raises(ValueError, match="no kernel"):
            make_spec(rule, f=2, impl="kernel")
    with pytest.raises(ValueError, match="STATE"):
        make_spec("zeno", f=2, server_grad=torch.zeros(3))
    with pytest.raises(ValueError, match="ema=0"):
        make_spec("zeno", f=2).init_state(torch.zeros(3))
