"""Gradient coding (``repro_torch.core.redundancy``) against the JAX
package: the group tables and their errors, the vote law
(``coded_vote_weights``) with masks and ragged tables, the attacker-
inflated tolerance of ``tests/test_coding.py``, the flat and tree
decodes (a mixed-dtype tree among them), DETOX and its refusal,
``majority_vote``, the redundancy properties and reactive redundancy
(with the check decision injected: the port cannot replay JAX's PRNG).

On the CPU the decode's kernels (K2 ``gram``, K7
``masked_weighted_sum``) run their plain versions.  Bars: the decode
weights, the winners and the tie order exactly; the decoded aggregate
within fp32 rtol = atol = 3e-6 (bf16 leaves 2e-2); the vote sees the
same Gram on both sides where the weights are held exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.redundancy as JR
import repro.core.redundancy.coding as JC
import repro.core.redundancy.reactive as JRe
import repro_torch.core.redundancy as TR
import repro_torch.core.redundancy.coding as TC
import repro_torch.core.redundancy.reactive as TRe

torch.set_num_threads(2)
TOL = 3e-6


def coded_stack(n=12, r=3, d=20, corrupt_per_group=1, seed=0, ragged=False,
                hazard=None):
    """(n, d) fp32 numpy: each group's rows equal copies of its true row,
    the first ``corrupt_per_group`` rows of each group replaced
    (1e5 * (group + 1) everywhere, or +inf / -inf / NaN for ``hazard``);
    and the (groups, d) true rows."""
    groups = TC.coding_groups(n, r, allow_ragged=ragged)
    k = int(groups.max()) + 1
    true = np.random.default_rng(seed).normal(size=(k, d)).astype(np.float32)
    g = true[groups].copy()
    for grp in range(k):
        slots = np.flatnonzero(groups == grp)
        for j in slots[:corrupt_per_group]:
            g[j] = {None: 1e5 * (grp + 1), "inf": np.inf, "-inf": -np.inf,
                    "nan": np.nan}[hazard]
    return g, true


# ---------------------------------------------------------------------------
# the group tables


@pytest.mark.parametrize("n,r", [(10, 3), (10, 4), (7, 0), (9, -1)])
def test_coding_groups_errors_match_jax(n, r):
    with pytest.raises(ValueError) as je:
        JC.coding_groups(n, r)
    with pytest.raises(ValueError) as te:
        TC.coding_groups(n, r)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("n,r", [(10, 4), (6, 4), (5, 3), (12, 3), (3, 4)])
def test_ragged_tables_match_jax(n, r):
    tg = TC.coding_groups(n, r, allow_ragged=True)
    np.testing.assert_array_equal(tg, JC.coding_groups(n, r,
                                                       allow_ragged=True))
    assert not tg.flags.writeable
    assert TC.coding_groups(n, r, allow_ragged=True) is tg     # cached


def test_draco_assignment_matches_jax():
    k, grp = TC.draco_assignment(12, 3)
    jk, jgrp = JC.draco_assignment(12, 3)
    assert k == jk
    np.testing.assert_array_equal(grp.numpy(), np.asarray(jgrp))
    with pytest.raises(ValueError, match="n=10"):
        TC.draco_assignment(10, 3)


# ---------------------------------------------------------------------------
# the vote law


def vote_masks(n, groups, seed):
    """None, a random delivered mask, and a mask with group 0 absent."""
    rng = np.random.default_rng(seed)
    random = rng.random(n) < 0.7
    random[rng.integers(n)] = True
    no_group0 = np.asarray(groups) != 0
    return {"none": None, "random": random, "no_group0": no_group0}


@pytest.mark.parametrize("mask_case", ["none", "random", "no_group0"])
@pytest.mark.parametrize("hazard", [None, "inf", "nan"])
@pytest.mark.parametrize("n,r", [(4, 2), (8, 3), (8, 4), (12, 2), (12, 3),
                                 (12, 4)])
def test_coded_vote_weights_match_jax(n, r, hazard, mask_case):
    """The same (n, n) Gram (JAX's, of a coded stack with a Byzantine row
    per group) on both sides: the decode weights equal bit for bit, with
    ragged tables where r does not divide n."""
    g, _ = coded_stack(n, r, d=33, seed=n + r, ragged=True, hazard=hazard)
    groups = TC.coding_groups(n, r, allow_ragged=True)
    gram = np.array(jnp.asarray(g) @ jnp.asarray(g).T)
    m = vote_masks(n, groups, n * r)[mask_case]
    jw = JC.coded_vote_weights(jnp.asarray(gram), r,
                               mask=None if m is None else jnp.asarray(m),
                               groups=groups)
    tw = TC.coded_vote_weights(torch.from_numpy(gram), r,
                               mask=None if m is None else torch.from_numpy(m),
                               groups=groups)
    assert tw.dtype == torch.float32
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_vote_tolerance_not_attacker_inflatable():
    """tests/test_coding.py's inflater (1e6 in group 0) and steerer (the
    honest row of group 1 plus sqrt(1e5) everywhere, in slot 0): the
    honest rows win both groups, and the decode equals JAX's."""
    d = 20
    true = np.random.default_rng(0).normal(size=(2, d)).astype(np.float32)
    g = np.repeat(true, 3, axis=0)
    g[0] = 1e6
    g[3] = true[1] + np.sqrt(1e5).astype(np.float32)
    out = TC.draco_aggregate(torch.from_numpy(g), 3).numpy()
    assert np.abs(out - true.mean(0)).max() < 1e-3
    np.testing.assert_allclose(out, np.asarray(JC.draco_aggregate(
        jnp.asarray(g), 3)), rtol=TOL, atol=TOL)
    from repro_torch.kernels import gram
    w = TC.coded_vote_weights(gram(torch.from_numpy(g)), 3)
    np.testing.assert_array_equal(w.numpy(), [0, 0.5, 0, 0, 0.5, 0])


# ---------------------------------------------------------------------------
# the decodes


@pytest.mark.parametrize("hazard", [None, "inf", "-inf", "nan"])
@pytest.mark.parametrize("masked", [False, True])
def test_flat_draco_matches_jax(hazard, masked):
    g, true = coded_stack(12, 3, d=257, seed=5, hazard=hazard)
    m = np.ones(12, bool)
    if masked:
        m[[0, 3]] = False          # two Byzantine rows do not deliver
    jout = JC.flat_draco_aggregate(jnp.asarray(g), 3,
                                   mask=jnp.asarray(m) if masked else None)
    tout = TC.flat_draco_aggregate(torch.from_numpy(g), 3,
                                   mask=torch.from_numpy(m) if masked
                                   else None)
    assert tout.dtype == torch.float32 and torch.isfinite(tout).all()
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(tout.numpy(), true.mean(0), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("corrupt", [0, 1, 2])
def test_draco_aggregate_matches_jax(corrupt):
    """Exact recovery at one corrupt row of three, the break at two (the
    majority lies), as in JAX."""
    g, true = coded_stack(12, 3, corrupt_per_group=corrupt)
    out = TC.draco_aggregate(torch.from_numpy(g), 3).numpy()
    np.testing.assert_allclose(out, np.asarray(JC.draco_aggregate(
        jnp.asarray(g), 3)), rtol=TOL, atol=TOL)
    err = np.abs(out - true.mean(0)).max()
    assert (err < 1e-5) if corrupt < 2 else (err > 1.0)
    with pytest.raises(ValueError, match="n=10.*r=3"):
        TC.draco_aggregate(torch.ones((10, 8)), 3)


def test_majority_vote_matches_jax():
    rows = np.stack([np.ones(8), np.ones(8), 5 * np.ones(8)]).astype(
        np.float32)
    np.testing.assert_array_equal(
        TC.majority_vote(torch.from_numpy(rows)).numpy(),
        np.asarray(JC.majority_vote(jnp.asarray(rows))))
    g, _ = coded_stack(4, 4, d=9, seed=2)
    np.testing.assert_array_equal(
        TC.majority_vote(torch.from_numpy(g)).numpy(),
        np.asarray(JC.majority_vote(jnp.asarray(g))))


@pytest.mark.parametrize("filter_name", ["geometric_median", "mean",
                                         "coordinate_median"])
def test_detox_matches_jax(filter_name):
    g, _ = coded_stack(n=27, r=3, seed=1)
    out = TC.detox_aggregate(torch.from_numpy(g), r=3, f=1,
                             filter_name=filter_name)
    ref = JC.detox_aggregate(jnp.asarray(g), r=3, f=1,
                             filter_name=filter_name)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_detox_refuses_zero_breakdown_bucketing():
    g, _ = coded_stack(n=21, r=3)
    with pytest.raises(ValueError, match="2f\\+1") as te:
        TC.detox_aggregate(torch.from_numpy(g), r=3, f=1)
    with pytest.raises(ValueError) as je:
        JC.detox_aggregate(jnp.asarray(g), r=3, f=1)
    assert str(te.value) == str(je.value)


def test_uniform_tree_rides_the_flat_arena_bitwise():
    from repro_torch.core.flat import FlatPlan
    g, _ = coded_stack(n=12, r=3, d=24)
    tree = {"w": torch.from_numpy(g).reshape(12, 6, 4),
            "b": torch.from_numpy(g[:, :4].copy())}
    plan = FlatPlan.for_tree(tree)
    out = TC.tree_draco_aggregate(tree, 3)
    ref = plan.unravel(TC.flat_draco_aggregate(plan.ravel(tree), 3))
    for key in out:
        assert torch.equal(out[key], ref[key])


@pytest.mark.parametrize("masked", [False, True])
def test_mixed_dtype_tree_matches_jax(masked):
    """fp32 and bf16 leaves: the segment Grams summed into one vote (a
    one-time warning), the weights applied per segment, leaf dtypes
    kept."""
    g, _ = coded_stack(n=8, r=4, d=40, seed=3)
    jt = {"a": jnp.asarray(g[:, :24]).reshape(8, 4, 6),
          "b": jnp.asarray(g[:, 24:]).astype(jnp.bfloat16)}
    tt = {"a": torch.from_numpy(g[:, :24].copy()).reshape(8, 4, 6),
          "b": torch.from_numpy(g[:, 24:].copy()).to(torch.bfloat16)}
    m = np.array([1, 0, 1, 1, 1, 1, 0, 1], bool)
    jm = jnp.asarray(m) if masked else None
    tm = torch.from_numpy(m) if masked else None
    jout = JC.tree_draco_aggregate(jt, 4, mask=jm)
    from repro_torch.core import aggregators
    aggregators._WARNED_ONCE.clear()
    with pytest.warns(UserWarning, match="mixed-dtype"):
        tout = TC.tree_draco_aggregate(tt, 4, mask=tm)
    assert tout["a"].dtype == torch.float32
    assert tout["b"].dtype == torch.bfloat16
    np.testing.assert_allclose(tout["a"].numpy(), np.asarray(jout["a"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout["b"].float().numpy(),
                               np.asarray(jout["b"], np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# properties and reactive redundancy


def test_redundancy_properties_match_jax():
    from repro.core.redundancy.properties import \
        make_redundant_quadratics as jax_quadratics
    from repro_torch.core.redundancy.properties import \
        make_redundant_quadratics
    X = np.array([[0.0, 0.0]])
    Y = np.array([[3.0, 4.0]])
    assert float(TR.hausdorff_distance(X, Y)) == 5.0
    A = np.random.default_rng(0).normal(size=(5, 3))
    B = np.random.default_rng(1).normal(size=(7, 3))
    np.testing.assert_allclose(float(TR.hausdorff_distance(A, B)),
                               float(JR.hausdorff_distance(A, B)),
                               rtol=1e-6)
    for eps, f in ((0.0, 2), (1.0, 2), (0.5, 1)):
        Hs, xs, common = make_redundant_quadratics(8, 3, eps=eps, seed=1)
        jHs, jxs, jcommon = jax_quadratics(8, 3, eps=eps, seed=1)
        np.testing.assert_array_equal(Hs, jHs)
        assert (TR.check_2f_redundancy(Hs, xs, f=f, max_subsets=200)
                == JR.check_2f_redundancy(Hs, xs, f=f, max_subsets=200))
        assert (TR.check_2f_eps_redundancy(Hs, xs, f=f, max_subsets=60)
                == JR.check_2f_eps_redundancy(Hs, xs, f=f, max_subsets=60))
        np.testing.assert_array_equal(TR.quadratic_argmin(Hs, xs),
                                      JR.quadratic_argmin(Hs, xs))


def test_reactive_check_matches_jax():
    """A checking iteration exposes the liar (agent 3) as in JAX; later
    plain iterations exclude it."""
    n, d = 8, 10
    truth = np.ones(d, np.float32)
    g = np.tile(truth, (n, 1))
    g[3] = -50.0
    jagg, jst = JRe.check_and_aggregate(jnp.asarray(g), JRe.init_reactive(n),
                                        lambda i: jnp.asarray(truth))
    tagg, tst = TRe.check_and_aggregate(torch.from_numpy(g),
                                        TRe.init_reactive(n),
                                        lambda i: torch.from_numpy(truth))
    np.testing.assert_array_equal(tst.active.numpy(), np.asarray(jst.active))
    assert (tst.detected, tst.checks_run) == (jst.detected, jst.checks_run)
    np.testing.assert_allclose(tagg.numpy(), np.asarray(jagg), rtol=TOL,
                               atol=TOL)
    g2 = np.tile(truth, (n, 1))
    g2[3] = 99.0
    np.testing.assert_allclose(
        TRe.plain_aggregate(torch.from_numpy(g2), tst).numpy(),
        np.asarray(JRe.plain_aggregate(jnp.asarray(g2), jst)), rtol=TOL,
        atol=TOL)


@pytest.mark.parametrize("check", [True, False])
def test_reactive_step_with_an_injected_decision(check):
    """The port draws from a torch.Generator; JAX's draw cannot be
    replayed, so the decision is injected: True runs JAX's checking
    iteration, False its plain one."""
    n, d = 6, 5
    truth = np.arange(d, dtype=np.float32)
    g = np.tile(truth, (n, 1))
    g[2] = 7.0
    st = TRe.init_reactive(n)
    agg, st2 = TRe.reactive_step(None, torch.from_numpy(g), st, 0.5,
                                 lambda i: torch.from_numpy(truth),
                                 check=check)
    if check:
        jagg, jst = JRe.check_and_aggregate(
            jnp.asarray(g), JRe.init_reactive(n), lambda i: jnp.asarray(truth))
        np.testing.assert_array_equal(st2.active.numpy(),
                                      np.asarray(jst.active))
    else:
        jagg = JRe.plain_aggregate(jnp.asarray(g), JRe.init_reactive(n))
        assert st2 is st
    np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=TOL,
                               atol=TOL)
    gen = torch.Generator().manual_seed(0)
    draws = [TRe.should_check(gen, 0.5) for _ in range(64)]
    assert 0 < sum(draws) < 64
    gen.manual_seed(0)
    assert draws == [TRe.should_check(gen, 0.5) for _ in range(64)]
