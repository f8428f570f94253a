"""The port's async training loop: the synchronous degenerate case, the
history rows against the JAX loop, the deferral of an update-less row,
and the attack on a copy of the in-flight buffer.

* ``sim=None`` is the slice-1 synchronous loop bit for bit (parameters
  and metrics equal);
* the history rows' trace keys (``step``, ``arrived``, ``n_live``,
  ``staleness_mean``, ``vclock``) equal the JAX loop's for the same
  ``SimConfig``, and the rows without an update are the same (loss NaN);
* a row where nothing was delivered runs no step and hands its
  dispatches to the next step that runs;
* a Byzantine agent that does not refresh keeps its honest gradient in
  the buffer: the attack rewrites a copy.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import repro.simulator as JS
import repro.simulator.async_loop as jax_async_loop
import repro_torch.simulator as TS
import repro_torch.simulator.async_loop as async_loop
from repro.configs import get_config as jax_get_config
from repro.core.aggregators import make_spec as jax_make_spec
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.optim import adamw as jax_adamw
from repro.optim import constant as jax_constant
from repro.training.step import ByzantineConfig as JaxBz
from repro_torch.configs import get_config
from repro_torch.core.aggregators import make_spec
from repro_torch.core.attacks import get_attack, make_byzantine_mask
from repro_torch.core.flat import FlatPlan
from repro_torch.data import SyntheticLM
from repro_torch.device import make_generator
from repro_torch.models import init_params
from repro_torch.optim import adamw, constant
from repro_torch.simulator import SimConfig, async_train_loop
from repro_torch.training import ByzantineConfig, make_train_step, train_loop
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)
N, F = 6, 1
KEYS = ("step", "arrived", "n_live", "staleness_mean", "vclock")


def tiny(mod_get_config):
    return mod_get_config("paper-100m-smoke").replace(
        num_layers=1, vocab_size=32, dtype="float32")


def setup(rule="trimmed_mean", attack="sign_flip"):
    cfg = tiny(get_config)
    ds = SyntheticLM(vocab_size=32, seq_len=8, n_agents=N, per_agent_batch=1)
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=make_spec(rule, f=F,
                                                               n=N),
                         attack=attack)
    return cfg, ds, bz


def test_sim_none_is_the_slice_1_loop_bit_for_bit():
    """train_loop(sim=None) against the slice-1 loop written out: the
    same generator draws, the same synchronous step, equal bits."""
    cfg, ds, bz = setup()
    params, hist = train_loop(cfg, bz, adamw(constant(1e-3)), ds, steps=3,
                              device="cpu", log_every=1,
                              log_fn=lambda *_: None)
    opt = adamw(constant(1e-3))
    gen = make_generator(0, "cpu")
    ref = init_params(cfg, gen)
    state = opt.init(ref)
    step = make_train_step(cfg, bz, opt, device="cpu")
    ref_hist = []
    for _ in range(3):
        batch = ds.batch(ds.draw_starts(gen))
        ref, state, _, met = step(ref, state, None, batch, gen)
        ref_hist.append({k: float(v) for k, v in met.items()})
    for a, b in zip(tree_leaves(params), tree_leaves(ref)):
        assert torch.equal(a, b)
    for h, r in zip(hist, ref_hist):
        assert {k: h[k] for k in r} == r
        assert h["arrived"] == N and h["staleness_mean"] == 0.0


def _jax_loop(sim, steps):
    jcfg = tiny(jax_get_config)
    jds = JaxSyntheticLM(vocab_size=32, seq_len=8, n_agents=N,
                         per_agent_batch=1)
    jbz = JaxBz(n_agents=N, f=F, aggregator=jax_make_spec(
        "trimmed_mean", f=F, impl="pallas", n=N), attack="sign_flip")
    _, hist = jax_async_loop.async_train_loop(
        jcfg, jbz, jax_adamw(jax_constant(1e-3)), jds, steps, sim=sim,
        log_every=1, log_fn=lambda *_: None)
    return hist


def _port_loop(sim, steps):
    cfg, ds, bz = setup()
    _, hist = async_train_loop(cfg, bz, adamw(constant(1e-3)), ds, steps,
                               sim=sim, device="cpu", log_every=1,
                               log_fn=lambda *_: None)
    return hist


def _same_rows(hist, jhist):
    assert len(hist) == len(jhist)
    for h, j in zip(hist, jhist):
        assert {k: h[k] for k in KEYS} == {k: j[k] for k in KEYS}
        assert sorted(h) == sorted(j)
        assert math.isnan(h["loss"]) == math.isnan(j["loss"])


def test_history_rows_match_jax():
    def sim(mod):
        return mod.SimConfig(faults=(mod.Straggler("pareto", 2.0),
                                     mod.MessageDrop(p=0.2),
                                     mod.Churn(rate=0.2, mean_out=2.0)),
                             quorum=4, max_staleness=2, seed=3)
    steps = 6
    _same_rows(_port_loop(sim(TS), steps), _jax_loop(sim(JS), steps))


def _zero_arrival_trace(sim, n_agents, steps):
    """Row 1 delivers nothing but has dispatches; row 2 runs."""
    contrib = np.ones((steps, n_agents), bool)
    refresh = np.ones((steps, n_agents), bool)
    staleness = np.zeros((steps, n_agents), np.int64)
    contrib[1] = False
    refresh[1] = False
    refresh[1, [0, 4]] = True
    contrib[2, [1, 2]] = False
    refresh[2] = False
    refresh[2, 3] = True
    staleness[2, [0, 4]] = 1
    return JS.events.AsyncTrace(
        contrib=contrib, staleness=staleness, refresh=refresh,
        vclock=np.arange(steps, dtype=np.float64),
        quorum_met=contrib.any(1))


def test_zero_arrival_row_defers_its_dispatches(monkeypatch):
    seen = []
    real = async_loop.make_async_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def wrapped(*args):
            seen.append(np.asarray(args[7], bool).copy())
            return step(*args)
        return wrapped
    monkeypatch.setattr(async_loop, "make_async_step", recording)
    monkeypatch.setattr(async_loop, "plan_arrivals", _zero_arrival_trace)
    monkeypatch.setattr(jax_async_loop, "plan_arrivals",
                        _zero_arrival_trace)
    hist = _port_loop(SimConfig(), 4)
    _same_rows(hist, _jax_loop(JS.SimConfig(), 4))
    assert math.isnan(hist[1]["loss"]) and hist[1]["grad_norm"] == 0.0
    # row 2 refreshes its own dispatch and row 1's deferred ones
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0], [1, 0, 0, 1, 1, 0])


def test_the_attack_rewrites_a_copy_of_the_buffer():
    """A Byzantine agent that does not refresh for two steps keeps its
    honest gradient in the buffer (an attack in place would have flipped
    it to -mean of the honest rows)."""
    cfg, ds, bz = setup(rule="coordinate_median")
    opt = adamw(constant(1e-3))
    gen = make_generator(0, "cpu")
    params = init_params(cfg, gen)
    state = opt.init(params)
    plan = FlatPlan.for_proto(params)
    buffer = torch.zeros((N, plan.total))
    step = TS.make_async_step(cfg, bz, opt, device="cpu")
    cw = torch.ones(N)
    refresh = np.ones(N, bool)
    for k in range(3):
        batch = ds.batch(ds.draw_starts(gen))
        params, state, _, buffer, _, met = step(
            params, state, None, buffer, {}, batch, gen, refresh, cw)
        if k == 0:
            honest_row0 = buffer[0].clone()
            refresh = np.ones(N, bool)
            refresh[0] = False                  # agent 0 is Byzantine
        else:
            assert torch.equal(buffer[0], honest_row0), k
        assert math.isfinite(float(met["loss"]))
    # what the rule saw at the last step was the attack of this buffer
    sent = get_attack("sign_flip")(None, buffer, make_byzantine_mask(N, F))
    assert not torch.equal(sent[0], buffer[0])


def test_unported_loop_options_raise_and_name_the_roadmap():
    cfg, ds, bz = setup()
    opt = adamw(constant(1e-3))
    # checkpoints and the recorder run (tests/test_torch_obs.py,
    # tests/test_torch_checkpoint.py); the distribution knobs still raise
    for kw in ({"group_size": 2}, {"reshard": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            async_train_loop(cfg, dataclasses.replace(bz, **kw), opt, ds, 1,
                             device="cpu")
    # the coded fallback is ported: the step builds, and a code that does
    # not divide the roster fails before any step runs
    TS.make_async_step(cfg, bz, opt, device="cpu", fallback_r=2)
    with pytest.raises(ValueError, match="n=6, r=4"):
        async_train_loop(cfg, bz, opt, ds, 1, device="cpu",
                         sim=SimConfig(coded_fallback_r=4))

