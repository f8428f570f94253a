"""The port's flight recorder and selection telemetry against the JAX
package's (``tests/test_obs.py``), on the CPU at smoke shapes.

* ``selection_weights`` of every registered rule (the wrappers over an
  inner rule, the stateful rules from one carried center) on one (8, 96)
  stack made with numpy, in the plain, masked and weighted regimes,
  under the gather and kernel impls (the kernel impl's torch bodies run
  here), against JAX's: supports equal, the selection rules' weights
  exactly, the fractional ones within 3e-6;
* the weights are faithful: ``aggregate == weighted sum of sel_w``;
* attaching a Recorder leaves the port's sync, stateful and async loops
  bit for bit the same, and a churn run within its step-build budget;
* the recorder's trace, Chrome trace, report, provenance, subscribers
  and dispatch record (``render_report`` of one event list gives the
  same text in both packages).

The loop-level ``sel_w`` parity against JAX rides an existing
JAX-against-port async run (``test_torch_async.py``).
"""
import functools
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.obs.recorder as jax_recorder
from repro.core.aggregators import make_spec as jax_make_spec
from repro.obs.report import render_report as jax_render_report
from repro.obs.telemetry import dispatch_record as jax_dispatch_record
from repro_torch.configs import get_config
from repro_torch.core.aggregators import (REGISTRY, elastic, frac,
                                          list_aggregators, make_spec)
from repro_torch.data import SyntheticLM
from repro_torch.obs import counters
from repro_torch.obs.recorder import Recorder, chrome_trace, read_trace
from repro_torch.obs.report import render_report
from repro_torch.obs.telemetry import (agent_series, dispatch_record,
                                       suspicion_scores)
from repro_torch.optim import adamw, constant
from repro_torch.simulator import (Churn, SimConfig, Straggler,
                                   async_train_loop)
from repro_torch.training import ByzantineConfig, train_loop
from repro_torch.tree import tree_leaves

torch.set_num_threads(2)

CFG = get_config("paper-100m-smoke").replace(vocab_size=32, dtype="float32")
N, F, D = 8, 2, 96
RNG = np.random.default_rng(0)
STACK = RNG.normal(size=(N, D)).astype(np.float32)
CENTER = (RNG.normal(size=(D,)) * 0.1).astype(np.float32)
REGIMES = {
    "plain": (None, None),
    "masked": (np.array([1, 1, 0, 1, 1, 1, 0, 1], bool), None),
    "weighted": (np.array([1, 1, 1, 1, 1, 1, 1, 0], bool),
                 np.array([1, .5, 1, .25, 1, 1, .5, 0], np.float32)),
}
# the inner rule of each wrapper, and the hyper of the rules that need one
INNER = {"clipped": "krum", "bucketed": "krum",
         "staleness_discounted": "cge", "server_momentum": "trimmed_mean"}
HYPER = {"zeno": {"ema": 0.5}, "clipped": {"tau": 1.0}}
# exact selections (weights 1/k on the picked rows)
SELECTIONS = ("krum", "multi_krum", "m_krum", "mda", "cge", "bulyan",
              "zeno", "clipped", "bucketed", "staleness_discounted")


def _specs(rule, impl):
    """(jax spec, torch spec) of ``rule``: a wrapper's impl is its inner
    rule's.  None when the port has no such impl for the rule."""
    inner = INNER.get(rule)
    hyper = HYPER.get(rule, {})
    try:
        if inner is None:
            return (jax_make_spec(rule, f=F, n=N, impl="gather", **hyper),
                    make_spec(rule, f=F, n=N, impl=impl, **hyper))
        return (jax_make_spec(rule, f=F, n=N, **hyper,
                              inner=jax_make_spec(inner, f=F, n=N,
                                                  impl="gather")),
                make_spec(rule, f=F, n=N, **hyper,
                          inner=make_spec(inner, f=F, n=N, impl=impl)))
    except ValueError:
        return None


CASES = [(rule, impl) for impl in ("gather", "kernel")
         for rule in list_aggregators() if _specs(rule, impl) is not None]


@functools.lru_cache(maxsize=None)
def _jax_weights(rule, regime):
    jspec, _ = _specs(rule, "gather")
    mask, w = REGIMES[regime]
    state = ({"server_grad": jnp.asarray(CENTER)} if jspec.stateful
             else None)
    return np.asarray(jspec.selection_weights(
        jnp.asarray(STACK), mask=None if mask is None else jnp.asarray(mask),
        weights=None if w is None else jnp.asarray(w), state=state))


def _torch_weights(spec, regime):
    mask, w = REGIMES[regime]
    state = ({"server_grad": torch.from_numpy(CENTER)} if spec.stateful
             else None)
    return spec.selection_weights(
        torch.from_numpy(STACK),
        mask=None if mask is None else torch.from_numpy(mask),
        weights=None if w is None else torch.from_numpy(w), state=state)


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("rule,impl", CASES)
def test_selection_weights_match_jax(rule, impl, regime):
    _, spec = _specs(rule, impl)
    ours = _torch_weights(spec, regime)
    assert ours.shape == (N,) and ours.dtype == torch.float32
    ours, ref = ours.numpy(), _jax_weights(rule, regime)
    np.testing.assert_array_equal(ours > 0, ref > 0)
    if rule in SELECTIONS:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=3e-6, atol=3e-6)


def _tree():
    rng = np.random.default_rng(3)
    return {"w": torch.from_numpy(rng.normal(size=(N, 4, 6)).astype(
                np.float32)),
            "b": torch.from_numpy(rng.normal(size=(N, 5)).astype(
                np.float32))}


WSUM_EXACT = [(rule, impl) for rule in ("mean", "krum", "multi_krum",
                                        "m_krum", "mda", "cge", "cgc")
              for impl in ("gather", "kernel")
              if REGISTRY[rule].caps.pairwise or impl == "gather"]


@pytest.mark.parametrize("rule,impl", WSUM_EXACT)
def test_selection_weights_reconstruct_aggregate(rule, impl):
    """The weight-decomposable rules' telemetry IS the aggregation: the
    weighted sum of the rows with sel_w equals the aggregate."""
    grads = _tree()
    spec = make_spec(rule, f=F, n=N, impl=impl)
    sel = spec.selection_weights(grads)
    assert sel.shape == (N,) and sel.dtype == torch.float32
    agg = spec.aggregate(grads)
    for k, leaf in grads.items():
        rec = torch.tensordot(sel, leaf, dims=1)
        np.testing.assert_allclose(agg[k].numpy(), rec.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_krum_weights_are_one_hot(impl):
    """The hot index is exactly Krum's pick, on both impls."""
    spec = make_spec("krum", f=F, n=N, impl=impl)
    x = torch.from_numpy(STACK)
    sel = spec.selection_weights(x).numpy()
    assert sel.sum() == 1.0 and (sel > 0).sum() == 1
    assert torch.equal(spec.aggregate_flat(x), x[int(sel.argmax())])


def test_stateful_weights_need_their_state():
    spec = make_spec("zeno_pp", xi=0.5, ema=0.2, n=N)
    with pytest.raises(ValueError, match="stateful"):
        spec.selection_weights(torch.from_numpy(STACK))
    with pytest.raises(ValueError, match="not weight-decomposable"):
        make_spec("trimmed_mean", f=F, n=N).weights(torch.from_numpy(STACK))


@pytest.mark.parametrize("impl", ["gather", "kernel"])
def test_aggregate_with_telemetry_matches_aggregate(impl):
    grads = _tree()
    spec = make_spec("trimmed_mean", f=F, n=N, impl=impl)
    agg, telem = spec.aggregate_with_telemetry(grads)
    for k in grads:
        assert torch.equal(agg[k], spec.aggregate(grads)[k])
    assert set(telem) == {"sel_w", "mask", "contrib_w"}
    x = torch.from_numpy(STACK)
    mask, w = (torch.from_numpy(a) for a in REGIMES["weighted"])
    spec = make_spec("krum", f=F, n=N, impl=impl)
    vec, telem = spec.aggregate_flat_with_telemetry(x, mask=mask, weights=w)
    assert torch.equal(vec, spec.aggregate_flat(x, mask=mask, weights=w))
    assert torch.equal(telem["sel_w"], spec.selection_weights(
        x, mask=mask, weights=w))
    assert torch.equal(telem["contrib_w"], w * mask.float())


# ---------------------------------------------------------------------------
# recorder on == recorder off, bit for bit, in the port's loops


def _equal_trees(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                  tree_leaves(b)))


def _dataset():
    return SyntheticLM(vocab_size=32, seq_len=8, n_agents=N,
                       per_agent_batch=1)


def _stragglers():
    return SimConfig(faults=(Straggler(dist="pareto", scale=1.0, prob=0.5,
                                       agents=(0, 1)),),
                     quorum=6, max_staleness=3, seed=0)


def _cge_run(recorder, steps=6):
    bz = ByzantineConfig(n_agents=N, f=F,
                         aggregator=make_spec("cge", f=F, n=N),
                         attack="large_value")
    return async_train_loop(CFG, bz, adamw(constant(1e-3)), _dataset(),
                            steps=steps, sim=_stragglers(), log_every=1,
                            log_fn=lambda *_: None, recorder=recorder,
                            device="cpu")


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """cge under large_value and stragglers, 6 steps, without and with a
    recorder writing a JSONL trace."""
    path = str(tmp_path_factory.mktemp("obs") / "trace.jsonl")
    off = _cge_run(None)
    rec = Recorder(path, meta={"test": "obs"})
    on = _cge_run(rec)
    rec.close()
    return off, on, path, rec.events


def test_async_loop_recorder_bit_identical(recorded):
    (p_off, h_off), (p_on, h_on), _, events = recorded
    assert _equal_trees(p_off, p_on)
    assert [h["loss"] for h in h_off] == [h["loss"] for h in h_on]
    steps = [e for e in events if e["kind"] == "step"]
    assert len(steps) == 6 and all(e.get("telemetry") for e in steps)
    for e in steps:
        sel = np.asarray(e["telemetry"]["sel_w"])
        assert abs(sel.sum() - 1.0) < 1e-6 and (sel > 0).sum() == N - F


def test_stateful_loop_recorder_bit_identical():
    """centered_clip (its center carried) under slow_drift (its own state
    in the {agg, atk} bundle) takes the general async step every row."""
    bz = ByzantineConfig(n_agents=N, f=F,
                         aggregator=make_spec("centered_clip", f=F, n=N,
                                              tau=1.0),
                         attack="slow_drift")

    def run(recorder):
        return async_train_loop(CFG, bz, adamw(constant(1e-3)), _dataset(),
                                steps=4, sim=_stragglers(), log_every=4,
                                log_fn=lambda *_: None, recorder=recorder,
                                device="cpu")
    p_off, h_off = run(None)
    rec = Recorder()
    p_on, h_on = run(rec)
    rec.close()
    assert _equal_trees(p_off, p_on)
    assert [h["loss"] for h in h_off] == [h["loss"] for h in h_on]
    ser = agent_series(rec.events)
    assert ser["sel_w"].shape == (4, N)
    assert np.isfinite(ser["sel_w"][ser["mask"]]).all()


def test_sync_loop_recorder_bit_identical():
    bz = ByzantineConfig(n_agents=N, f=F,
                         aggregator=make_spec("trimmed_mean", f=F, n=N))

    def run(recorder):
        return train_loop(CFG, bz, adamw(constant(1e-3)), _dataset(),
                          steps=4, log_every=4, log_fn=lambda *_: None,
                          recorder=recorder, device="cpu")
    p_off, _ = run(None)
    rec = Recorder()
    p_on, _ = run(rec)
    rec.close()
    assert _equal_trees(p_off, p_on)
    steps = [e for e in rec.events if e["kind"] == "step"]
    assert len(steps) == 4
    # the pure rows ran the synchronous step: uniform participation
    assert all(e["telemetry"]["sel_w"] == [np.float32(1 / N).item()] * N
               for e in steps)


@pytest.mark.parametrize("case", ["int8_sync", "int8_async", "draco"])
def test_exchange_and_coded_loops_recorder_bit_identical(case):
    """A quantized exchange attributes on the fp32 rows it quantizes (krum
    reports one agent); the coded decode reports uniform shares of the
    live roster.  Recorder on and off bitwise, as above."""
    kw = {"draco_r": 4} if case == "draco" else {"agg_dtype": "int8"}
    f = 1 if case == "draco" else F
    bz = ByzantineConfig(n_agents=N, f=f, attack="sign_flip",
                         aggregator=make_spec("krum", f=f, n=N), **kw)
    ds = SyntheticLM(vocab_size=32, seq_len=8, n_agents=N,
                     per_agent_batch=1,
                     regime="parallel" if case == "draco" else "iid")

    def run(recorder):
        return train_loop(CFG, bz, adamw(constant(1e-3)), ds, steps=2,
                          log_every=2, log_fn=lambda *_: None,
                          sim=_stragglers() if case == "int8_async" else None,
                          recorder=recorder, device="cpu")
    p_off, h_off = run(None)
    rec = Recorder()
    p_on, h_on = run(rec)
    rec.close()
    assert _equal_trees(p_off, p_on)
    assert [h["loss"] for h in h_off] == [h["loss"] for h in h_on]
    sel = agent_series(rec.events)["sel_w"]
    assert sel.shape == (2, N)
    if case == "draco":
        assert (sel == np.float32(1 / N)).all()
    else:
        assert ((sel > 0).sum(1) == 1).all() and (sel.sum(1) == 1).all()


def test_churn_run_with_recorder_stays_in_build_budget():
    """Churn over a 3-bucket elastic spec with a recorder attached: at most
    one async step built per bucket and one synchronous step, each build
    in the recorder's ledger, a full-width telemetry row every step."""
    buckets = (4, 6, 8)
    spec = make_spec("trimmed_mean", f=frac(0.25), n=elastic(N, buckets))
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec)
    sim = SimConfig(faults=(Churn(rate=0.25, mean_out=2.0),), seed=0)
    before = counters.snapshot()
    rec = Recorder()
    _, h = async_train_loop(CFG, bz, adamw(constant(1e-3)), _dataset(),
                            steps=8, sim=sim, log_every=1,
                            log_fn=lambda *_: None, recorder=rec,
                            device="cpu")
    rec.close()
    assert [x["n_live"] for x in h] == [8, 6, 4, 6, 6, 7, 4, 3]
    delta = counters.counter_delta(before)
    assert delta.get("async_step", 0) <= len(buckets), delta
    assert delta.get("train_step", 0) <= 1, delta
    ledger = [e for e in rec.events if e["kind"] == "compile"]
    assert sum(e["count"] for e in ledger
               if e["site"] == "async_step") == delta.get("async_step", 0)
    ser = agent_series(rec.events)
    assert ser["sel_w"].shape == (8, N) and ser["mask"].shape == (8, N)
    # a departed agent carries no weight; each row's shares sum to 1
    assert (ser["sel_w"][~ser["roster"]] == 0).all()
    np.testing.assert_allclose(ser["sel_w"].sum(1), 1.0, atol=1e-6)
    assert any(e["kind"] == "membership" for e in rec.events)


# ---------------------------------------------------------------------------
# the trace, its exports and the report


def test_trace_jsonl_roundtrip(recorded):
    *_, path, events = recorded
    loaded = read_trace(path)
    assert [e["kind"] for e in loaded] == [e["kind"] for e in events]
    assert loaded[0]["kind"] == "meta" and loaded[1]["kind"] == "run"
    prov = loaded[0]["provenance"]
    for k in ("torch_version", "cuda_version", "backend", "device_kind",
              "device_count", "git_sha", "timestamp"):
        assert k in prov, k
    assert "interpret" not in prov
    assert prov["torch_version"] == torch.__version__


def test_chrome_trace_structure(recorded):
    *_, events = recorded
    ct = chrome_trace(events)
    assert set(ct) >= {"traceEvents", "displayTimeUnit"}
    phases = {e["ph"] for e in ct["traceEvents"]}
    assert {"X", "M", "C", "i"} <= phases
    spans = [e for e in ct["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == 6
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in spans)
    json.dumps(ct)


def test_report_cli_renders(recorded, tmp_path, capsys):
    from repro_torch.launch.report import main as report_main
    *_, path, _ = recorded
    perfetto = str(tmp_path / "trace.json")
    report_main([path, "--perfetto", perfetto])
    out = capsys.readouterr().out
    for part in ("per-agent suspicion", "recompile ledger", "rule dispatch",
                 "rule=cge  impl=kernel", "step statistics", "torch "):
        assert part in out, part
    with open(perfetto) as fh:
        assert "traceEvents" in json.load(fh)


def test_suspicion_ranks_the_excluded_agents(recorded):
    """cge against large_value (agents 0 and 1): the filtered-out agents
    top the suspicion ranking."""
    *_, events = recorded
    ser = agent_series(events)
    scores = suspicion_scores(ser["sel_w"], ser["mask"], ser["roster"])
    ranked = [s["agent"] for s in sorted(scores,
                                         key=lambda s: -s["suspicion"])]
    assert set(ranked[:2]) == {0, 1}, ranked
    assert all(0.0 <= s["suspicion"] <= 1.0 for s in scores)


def _jax_event_list():
    """One event list made by the JAX package's Recorder: its provenance,
    a run event with its dispatch record, steps with telemetry rows and a
    roster change, a build, a fault."""
    rec = jax_recorder.Recorder(meta={"test": "report"})
    spec = jax_make_spec("clipped", f=F, n=N, tau=2.0,
                         inner=jax_make_spec("trimmed_mean", f=F, n=N,
                                             impl="pallas"))
    rec.emit("run", steps=3, n_agents=N,
             dispatch=jax_dispatch_record(spec))
    rng = np.random.default_rng(5)
    for step in range(3):
        roster = np.ones(N, bool)
        roster[step] = False
        sel = rng.random(N).astype(np.float32) * roster
        rec.emit("compile", step=step, site="async_step", count=1)
        if step == 1:
            rec.fault(step, "quorum_miss", arrived=5)
        rec.step(step, t0=0.1 * step, t1=0.1 * step + 0.05,
                 metrics={"loss": 1.0 / (step + 1), "arrived": 7,
                          "n_live": 7, "staleness_mean": 0.5 * step,
                          "staleness_max": step, "quorum_ok": step != 1},
                 telemetry={"sel_w": sel / sel.sum(), "mask": roster,
                            "contrib_w": roster.astype(np.float32)},
                 roster=roster)
    rec.close()
    return rec.events


def test_report_text_equals_jax():
    events = _jax_event_list()
    assert render_report(events) == jax_render_report(events)
    assert render_report(events, top=3) == jax_render_report(events, top=3)


def test_dispatch_record_matches_jax_on_a_wrapper_chain():
    ours = dispatch_record(make_spec(
        "clipped", f=F, n=N, tau=2.0,
        inner=make_spec("trimmed_mean", f=F, n=N, impl="kernel")))
    ref = jax_dispatch_record(jax_make_spec(
        "clipped", f=F, n=N, tau=2.0, impl="gather",
        inner=jax_make_spec("trimmed_mean", f=F, n=N, impl="pallas")))
    ref["inner"]["impl"] = "kernel"
    # the port gives the wrappers a flat law (the loops take the arena);
    # in JAX they run on the tree engine only
    assert ours.pop("flat") and not ref.pop("flat")
    assert ours == ref
    ours = dispatch_record(make_spec("trimmed_mean", f=frac(0.25),
                                     n=elastic(N, (4, 6, 8))))
    assert ours["elastic_buckets"] == [4, 6, 8]


def test_counters_gauges_and_reset():
    before = counters.snapshot()
    counters.inc("obs_test_site")
    counters.inc("obs_test_site")
    counters.set_gauge("obs_test_gauge", 7)
    assert counters.counter_delta(before).get("obs_test_site") == 2
    assert counters.gauge("obs_test_gauge") == 7
    assert counters.snapshot()["gauges"]["obs_test_gauge"] == 7
    counters.reset("obs_test_site")
    counters.reset("obs_test_gauge")
    assert counters.trace_count("obs_test_site") == 0
    assert counters.gauge("obs_test_gauge") is None
    counters.inc("obs_test_site")
    counters.reset_traces("obs_test_site")
    assert counters.trace_count("obs_test_site") == 0


def test_provenance_keys():
    from repro_torch.obs.provenance import provenance
    p = provenance()
    assert p["torch_version"] == torch.__version__
    assert p["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert isinstance(p["git_sha"], str) and p["git_sha"]
    json.dumps(p)


def test_subscribers_see_every_event_and_leave_the_file_alone(tmp_path):
    rec = Recorder(str(tmp_path / "a.jsonl"))
    seen = []
    unsub = rec.subscribe(seen.append)
    rec.emit("note", message="a")
    rec.step(0, metrics={"loss": torch.tensor(1.0)})
    unsub()
    unsub()                                   # idempotent
    rec.emit("note", message="b")
    rec.close()
    assert [e["kind"] for e in seen] == ["note", "step"]
    assert seen == rec.events[1:3]
    assert seen[1]["metrics"]["loss"] == 1.0
    assert [e["kind"] for e in read_trace(rec.path)] == [
        "meta", "note", "step", "note"]


def test_launcher_records_checkpoints_and_writes_history(tmp_path, capsys):
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as launch_train
    trace, perfetto = tmp_path / "t.jsonl", tmp_path / "t.json"
    hist_out, ckpt = tmp_path / "h.json", tmp_path / "ckpt"
    hist = launch_train.main([
        "--smoke", "--device", "cpu", "--steps", "2", "--n-agents", "4",
        "--f", "1", "--filter", "krum", "--attack", "sign_flip",
        "--seq-len", "8", "--per-agent-batch", "1", "--record", str(trace),
        "--perfetto", str(perfetto), "--ckpt-dir", str(ckpt),
        "--history-out", str(hist_out)])
    assert math.isfinite(hist[-1]["loss"])
    out = capsys.readouterr().out
    assert "trace written" in out and "perfetto trace written" in out
    events = read_trace(trace)
    assert sum(e["kind"] == "step" for e in events) == 2
    assert json.loads(perfetto.read_text())["traceEvents"]
    assert json.loads(hist_out.read_text())[-1]["loss"] == hist[-1]["loss"]
    assert latest_step(str(ckpt)) == 2
