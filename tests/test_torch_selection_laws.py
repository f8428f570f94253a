"""The selection family's laws on the port's kernel path, and its place in
the registry and the loops.

* the sync half of the JAX suite's
  ``test_selection_family_survives_nonfinite_adversary``
  (tests/test_kernels_parity.py): under +-inf-coordinate hostile rows the
  selections keep their cardinality and the aggregates stay finite;
* the permutation invariance of tests/test_membership_conformance.py
  (same N, D, f, hyper and bar), for the five rules on the kernel path;
* ``bulyan(base != "krum")`` resolves ``auto`` to gather and refuses
  ``kernel``; a masked call on the kernel path raises, naming ROADMAP.md
  slice 3b, while the gather path runs the mean-imputed law (held to
  JAX's gather); ``train_loop`` refuses, before any step, a trace with
  masked rows for such a spec, and runs a fault-free one.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.aggregators import make_spec
from repro_torch.data import SyntheticLM
from repro_torch.optim import adamw, constant
from repro_torch.simulator import SimConfig, Straggler
from repro_torch.training import ByzantineConfig, train_loop

torch.set_num_threads(2)
FAMILY = ("cge", "multi_krum", "m_krum", "mda", "bulyan")


def normal(n, d, seed, scale=2.0):
    return torch.from_numpy((np.random.default_rng(seed).normal(
        size=(n, d)) * scale).astype(np.float32))


def test_selection_family_survives_nonfinite_adversary():
    n, d, f = 8, 512, 2
    g = normal(n, d, 12)
    g[1, 7], g[5, 3] = math.inf, -math.inf            # 2 hostile rows
    gr = kernels.gram(g)
    w_krum = kernels.krum_select(gr, f)
    assert float(w_krum.sum()) == 1.0
    assert w_krum[1] == 0.0 and w_krum[5] == 0.0       # a finite row wins
    w_cge = kernels.cge_select(gr, n - f)
    assert float(w_cge.sum()) == n - f
    assert w_cge[1] == 0.0 and w_cge[5] == 0.0         # inf norms dropped
    for rule, hyper in [("krum", {}), ("cge", {}), ("multi_krum", {"m": 3}),
                        ("m_krum", {"m": 3}), ("bulyan", {}), ("mda", {})]:
        spec = make_spec(rule, f=f, n=n, **hyper)
        assert spec.impl == "kernel"
        assert bool(torch.isfinite(spec.aggregate_flat(g)).all()), rule
    for m in (2, 3):
        for fn in (kernels.multi_krum_order, kernels.iterative_order):
            order = fn(gr, f, m).numpy()
            assert sorted(order[order < n]) == list(range(m))


# the conformance suite's membership rows: N, F, D = 12, 2, 48; m = 2;
# bulyan at f = 1 (it needs n >= 4f + 3)
N, F, D = 12, 2, 48
CONFORMANCE = {"cge": {}, "multi_krum": {"m": 2}, "m_krum": {"m": 2},
               "mda": {}, "bulyan": {}}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("rule", FAMILY)
def test_permutation_invariance(rule, seed):
    f = 1 if rule == "bulyan" else F
    spec = make_spec(rule, f=f, n=N, **CONFORMANCE[rule])
    assert spec.impl == "kernel"
    g = normal(N, D, seed)
    perm = torch.from_numpy(np.random.default_rng(77 + seed).permutation(N))
    a = spec.aggregate_flat(g).numpy()
    b = spec.aggregate_flat(g[perm].contiguous()).numpy()
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=rule)


def test_bulyan_generic_base_is_gather_only():
    spec = make_spec("bulyan", f=1, n=8, base="trimmed_mean")
    assert spec.impl == "gather"
    with pytest.raises(ValueError, match="non-kernelized"):
        make_spec("bulyan", f=1, n=8, base="trimmed_mean", impl="kernel")
    assert make_spec("bulyan", f=1, n=8, base="krum").impl == "kernel"
    g = normal(8, 64, 3)
    ref = jax_make_spec("bulyan", f=1, n=8, base="trimmed_mean",
                        impl="gather").aggregate(jnp.asarray(g.numpy()))
    np.testing.assert_allclose(spec.aggregate_flat(g).numpy(),
                               np.asarray(ref), rtol=3e-6, atol=3e-6)


@pytest.mark.parametrize("rule", FAMILY)
def test_masked_kernel_call_raises_and_gather_runs_the_masked_law(rule):
    n, f = 8, 2
    g = normal(n, 64, 5)
    mask = torch.tensor([1, 1, 0, 1, 1, 1, 0, 1], dtype=torch.bool)
    w = torch.tensor([1.0, 0.5, 0.0, 1.0, 1 / 3, 1.0, 0.0, 0.5])
    assert make_spec(rule, f=f, n=n).impl == "kernel"
    with pytest.raises(NotImplementedError, match="slice 3b"):
        make_spec(rule, f=f, n=n).aggregate_flat(g, mask=mask, weights=w)
    ours = make_spec(rule, f=f, n=n, impl="gather").aggregate_flat(
        g, mask=mask, weights=w)
    # jitted, as the JAX step runs it: its imputed mean is then the
    # fused multiply-add chain the port computes (ROADMAP.md P5); bulyan's
    # beta = 1 pick between the two middle values turns on that last bit
    spec_j = jax_make_spec(rule, f=f, n=n, impl="gather")
    ref = jax.jit(lambda x, m, wt: spec_j.aggregate(x, mask=m, weights=wt))(
        jnp.asarray(g.numpy()), jnp.asarray(mask.numpy()),
        jnp.asarray(w.numpy()))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=3e-6,
                               atol=3e-6)


def _loop_setup(rule, impl="auto"):
    n, f = 4, 1
    cfg = get_config("paper-100m-smoke")
    ds = SyntheticLM(cfg.vocab_size, 16, n, 1)
    bz = ByzantineConfig(n_agents=n, f=f,
                         aggregator=make_spec(rule, f=f, n=n, impl=impl),
                         attack="sign_flip")
    return cfg, ds, bz, adamw(constant(1e-3))


STRAGGLERS = SimConfig(faults=(Straggler("lognormal", 0.8),), quorum=3,
                       max_staleness=3, seed=0)


def test_train_loop_refuses_masked_rows_before_any_step():
    cfg, ds, bz, opt = _loop_setup("m_krum")
    logs = []
    with pytest.raises(NotImplementedError, match="slice 3b"):
        train_loop(cfg, bz, opt, ds, steps=3, device="cpu", sim=STRAGGLERS,
                   log_fn=logs.append)
    assert logs == []
    # a fault-free run is all pure rows: the synchronous kernel step
    _, hist = train_loop(cfg, bz, opt, ds, steps=1, device="cpu",
                         sim=SimConfig(quorum=3), log_fn=logs.append)
    assert math.isfinite(hist[-1]["loss"])
    # the gather spec runs the masked rows
    cfg, ds, bz, opt = _loop_setup("m_krum", impl="gather")
    _, hist = train_loop(cfg, bz, opt, ds, steps=2, device="cpu",
                         sim=STRAGGLERS, log_every=1, log_fn=lambda *_: None)
    assert [h["arrived"] for h in hist] == [3, 3]
    assert all(math.isfinite(h["loss"]) for h in hist)
