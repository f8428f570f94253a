"""The compressed exchange on the async loop: ``make_async_step`` with
``agg_dtype="int8"`` against the JAX package's under the straggler trace
(lognormal 0.8, quorum 6 of 8, max staleness 3: six deliveries a step, no
step pure), for coordinate_median, trimmed_mean (K19), sign_sgd (K20) and
krum (the engine-level dequantization, then K4 -> K6 -> K3 -> K7).  The
buffer stays fp32; the delivered rows are quantized after the attack.
Each step starts from the JAX side's state (ROADMAP.md P14,
``test_torch_helpers.check_quantized``).

Then the step-build budget of the compressed elastic loop (the port of
``tests/test_kernels_parity.py::test_quantized_flat_loop_compiles_once_
per_bucket``, with its faults and 30 of its 200 steps), and the
synchronous bucket step on codes: its kernel path equals its gather path.
"""
import math

import numpy as np
import pytest
import torch

import test_torch_helpers as H
from repro_torch.configs import get_config
from repro_torch.core.aggregators import elastic, frac, make_spec
from repro_torch.data import SyntheticLM
from repro_torch.obs.counters import counter_delta, snapshot
from repro_torch.optim import adamw, constant
from repro_torch.simulator import (Churn, Join, MessageDrop, SimConfig,
                                   Straggler, async_train_loop)
from repro_torch.training import ByzantineConfig, make_train_step

RULES = ["coordinate_median", "trimmed_mean", "sign_sgd", "krum"]


@pytest.mark.parametrize("rule", RULES)
def test_int8_async_step_matches_jax(rule):
    H.check_quantized(rule, "int8", loop="async")


def test_quantized_elastic_loop_builds_one_step_per_bucket():
    """agg_dtype="int8" under joins, churn, stragglers and message drops
    (quorum 3): at most one async step build per bucket and one
    synchronous step; the quantize and scale threading adds no build."""
    n, buckets = 8, (4, 6, 8)
    cfg = get_config("paper-100m-smoke").replace(vocab_size=32,
                                                 dtype="float32")
    ds = SyntheticLM(vocab_size=32, seq_len=8, n_agents=n,
                     per_agent_batch=1)
    spec = make_spec("trimmed_mean", f=frac(0.25), n=elastic(n, buckets))
    bz = ByzantineConfig(n_agents=n, f=2, aggregator=spec,
                         attack="sign_flip", agg_dtype="int8")
    sim = SimConfig(faults=(Join(agents=(7,), at=10),
                            Churn(rate=0.2, mean_out=2.0,
                                  agents=(1, 2, 3, 4)),
                            Straggler(dist="lognormal", scale=0.5),
                            MessageDrop(p=0.1)),
                    quorum=3, max_staleness=3, seed=0)
    before = snapshot()
    _, hist = async_train_loop(cfg, bz, adamw(constant(1e-3)), ds, steps=30,
                               sim=sim, device="cpu", log_every=1,
                               log_fn=lambda *_: None)
    built = counter_delta(before)
    assert 1 <= built.get("async_step", 0) <= len(buckets), built
    assert built.get("train_step", 0) <= 1, built
    assert math.isfinite(hist[-1]["loss"])
    assert len({h["n_live"] for h in hist}) > 1          # churn happened


@pytest.mark.parametrize("rule", ["trimmed_mean", "sign_sgd"])
def test_int8_sync_bucket_step_kernel_equals_gather(rule):
    """make_train_step(bucket=6) with agg_dtype="int8": the live rows'
    codes and scales packed into the bucket (a ghost row pads it), the
    masked scaled kernel (K19 / K20 plain) against the gather law from
    the same parameters and batch: equal losses, aggregates within 3e-6
    (trimmed_mean) or equal (sign_sgd)."""
    cfg, _ = H.configs()
    live = [0, 2, 3, 5, 6]
    outs = {}
    for impl in ("kernel", "gather"):
        spec = make_spec(rule, f=frac(0.25), impl=impl,
                         n=elastic(H.N, (4, 6, 8)))
        b, idx, valid = spec.elastic.pack(live)
        to = H._torch_recording(H.topt.adamw(H.topt.constant(H.LR),
                                             eps=H.EPS))
        step = make_train_step(cfg, ByzantineConfig(
            n_agents=H.N, f=spec.f, aggregator=spec, attack="sign_flip",
            agg_dtype="int8"), to, device="cpu", bucket=b)
        tp = H.params_from_numpy(H.jax_params_numpy())
        tb, _ = H.batch_np(700)
        _, ts, _, met = step(tp, to.init(tp), None, tb, None,
                             torch.as_tensor(idx, dtype=torch.int64),
                             torch.as_tensor(valid))
        outs[impl] = (float(met["loss"]),
                      H.flat_np(H.params_to_numpy(ts["agg"])))
    assert outs["kernel"][0] == outs["gather"][0]
    if rule == "sign_sgd":
        np.testing.assert_array_equal(outs["kernel"][1], outs["gather"][1])
    else:
        np.testing.assert_allclose(outs["kernel"][1], outs["gather"][1],
                                   rtol=3e-6, atol=3e-6)
