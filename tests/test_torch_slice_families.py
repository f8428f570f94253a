"""The text families end to end against the JAX package (ROADMAP.md item
22a), on the CPU at their smoke reductions and T = 80: logits, loss (MoE
aux included) and per-agent gradients of mamba2, mixtral, llama4-scout,
zamba2 and h2o-danube, remat on and off; the synchronous robust step on
mamba2-130m-smoke for trimmed_mean, coordinate_median and krum, and on
mixtral-smoke for one rule, and one async-loop step on mamba2-130m-smoke,
each in fp32 and in the native tree (bf16 leaves beside fp32 A_log /
dt_bias / D_skip, so an fp32 arena).  Weights come from
``repro.models.init_params``, batches from the JAX side's starts.  Each
test states its tolerance.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flat import FlatPlan as JaxFlatPlan
from repro.models import forward_train as jax_forward_train
from repro.models import loss_fn as jax_loss_fn
from repro_torch.convert import params_from_numpy
from repro_torch.core.flat import FlatPlan
from repro_torch.models import forward_train, loss_fn
from repro_torch.tree import tree_leaves
from test_torch_helpers import (FAMILY_SEQ, GRAD_TOL, LOGIT_TOL, batch_np,
                                family_model, family_params_numpy, flat_np,
                                leaves_np, run_async, run_slice)

torch.set_num_threads(2)
FAMILIES = ["mamba2-130m-smoke", "mixtral-8x22b-smoke",
            "llama4-scout-17b-a16e-smoke", "zamba2-7b-smoke",
            "h2o-danube-3-4b-smoke"]
AGENTS = 2


@functools.lru_cache(maxsize=None)
def jax_reference(arch):
    """JAX's logits and aux of agent 0's batch, and every agent's loss
    and gradient (fp32), computed once an arch and shared by the remat
    cases."""
    _, jcfg, pnp, seq = family_model(arch)
    _, jb = batch_np(21, n=AGENTS, seq=seq)
    jp = jax.tree.map(jnp.asarray, pnp)
    logits, aux = jax.jit(lambda p, b: jax_forward_train(jcfg, p, b))(
        jp, {k: v[0] for k, v in jb.items()})
    losses, grads = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b)), in_axes=(None, 0)))(jp, jb)
    return (np.asarray(logits), float(aux), np.asarray(losses),
            leaves_np(grads))


@pytest.mark.parametrize("arch", FAMILIES)
def test_logits_and_aux_match_jax(arch):
    """The logits within rtol = atol = LOGIT_TOL (zamba2-smoke's are the
    closest: 1.17e-5 at logits up to 4.3, ROADMAP.md P21), the MoE aux
    (summed over layers) within LOGIT_TOL, 0 exactly elsewhere."""
    cfg, _, pnp, seq = family_model(arch)
    tb, _ = batch_np(21, n=AGENTS, seq=seq)
    ref_logits, ref_aux, _, _ = jax_reference(arch)
    logits, aux = forward_train(cfg, params_from_numpy(pnp),
                                {k: v[0] for k, v in tb.items()})
    assert tuple(logits.shape) == (2, FAMILY_SEQ, cfg.vocab_size)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits,
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    if cfg.family == "moe":
        assert ref_aux > 0
        np.testing.assert_allclose(float(aux), ref_aux, rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)
    else:
        assert float(aux) == ref_aux == 0.0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_per_agent_gradients_match_jax(arch, remat):
    """Each agent's loss (aux included) within LOGIT_TOL and each
    gradient leaf within GRAD_TOL; per-layer remat (each layer, each use
    of the hybrid's shared block) changes nothing but memory."""
    cfg, _, pnp, seq = family_model(arch)
    tb, _ = batch_np(21, n=AGENTS, seq=seq)
    _, _, ref_losses, ref_grads = jax_reference(arch)
    tp = params_from_numpy(pnp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    for i in range(AGENTS):
        loss = loss_fn(cfg, tp, {k: v[i] for k, v in tb.items()}, remat)
        np.testing.assert_allclose(loss.item(), ref_losses[i],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for g, ref in zip(torch.autograd.grad(loss, leaves), ref_grads):
            np.testing.assert_allclose(g.numpy(), ref[i], rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


def test_mixed_tree_arena_matches_jax_flat_plan():
    """Exact: mamba2-130m-smoke's native tree mixes bf16 and fp32 leaves,
    so its arena is fp32 (no uniform dtype), with JAX's offsets, and
    unravel gives each leaf its own dtype back."""
    pnp = family_params_numpy("mamba2-130m-smoke", None)
    tp = params_from_numpy(pnp)
    plan, jplan = FlatPlan.for_proto(tp), JaxFlatPlan.for_proto(pnp)
    assert plan.offsets == jplan.offsets and plan.total == jplan.total
    assert plan.uniform_dtype is None and plan.arena_dtype == torch.float32
    assert {str(t.dtype) for t in tree_leaves(tp)} == {"torch.bfloat16",
                                                        "torch.float32"}
    vec = torch.arange(plan.total, dtype=torch.float32) % 7
    for t, leaf in zip(tree_leaves(plan.unravel(vec)), tree_leaves(tp)):
        assert t.dtype == leaf.dtype and t.shape == leaf.shape


def rel_l2(ours, ref):
    """||ours - ref|| / ||ref|| (fp64)."""
    ours = np.asarray(ours, np.float64).ravel()
    ref = np.asarray(ref, np.float64).ravel()
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


STEP_CASES = [("mamba2-130m-smoke", "trimmed_mean"),
              ("mamba2-130m-smoke", "coordinate_median"),
              ("mamba2-130m-smoke", "krum"),
              ("mixtral-8x22b-smoke", "trimmed_mean")]


def check_fp32_step(out, arch, msg):
    """One step in fp32 at the suite's step bars: the loss within
    LOGIT_TOL, the aggregate and the parameter change (post-step minus
    initial; AdamW's first step moves a coordinate by up to LR = 1e-3)
    within rtol = atol = GRAD_TOL."""
    p0 = flat_np(family_params_numpy(arch)).astype(np.float64)
    for jl, tl, ja, ta, jpar, tpar, *_ in out:
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(ta, ja, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)
        np.testing.assert_allclose(tpar - p0, np.asarray(jpar, np.float64)
                                   - p0, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=msg)


@pytest.mark.parametrize("arch,rule", STEP_CASES)
def test_sync_step_in_fp32_matches_jax(arch, rule):
    """One synchronous robust step (n = 8, f = 2, sign_flip, the kernel
    impl) from JAX's fp32 weights: the suite's step bars
    (:func:`check_fp32_step`)."""
    out = run_slice(rule, 0.0, steps=1, model=(arch, "float32"))
    check_fp32_step(out, arch, f"{arch} {rule}")


def test_async_step_in_fp32_matches_jax():
    """One async-loop step of trimmed_mean on mamba2-130m-smoke in fp32
    under the stragglers (6 of 8 deliver): the sync step's bars, and the
    in-flight buffer within rtol = atol = GRAD_TOL."""
    out = run_async("trimmed_mean", 0.0, steps=1,
                    model=("mamba2-130m-smoke", "float32"))
    check_fp32_step(out, "mamba2-130m-smoke", "async trimmed_mean")
    for *_, jbuf, tbuf, _, _ in out:
        np.testing.assert_allclose(tbuf, jbuf, rtol=GRAD_TOL, atol=GRAD_TOL)


# A native tree's step runs its forward and backward in bf16 on both sides,
# and XLA and PyTorch round their bf16 intermediates at different points,
# so single coordinates of a whole step part by more than one bf16 sum's
# 2e-2 (the per-agent gradients feed an order statistic, and AdamW's first
# step turns a flipped gradient sign into a 2 LR move).  The native cases
# are held in norm, against measured gaps of 0.021-0.058 (aggregate),
# 0.021 (buffer) and 0.09-0.22 (parameter change); in the sync cases the
# other coordinate rule's aggregate of the same arena, its plain mean and
# agent 0's or agent 7's row are 0.53 or more away, and a zero aggregate,
# buffer or update is 1.0 away.  The suite's bars hold the same cases in
# fp32 (:func:`check_fp32_step`).
NATIVE_LOSS_RTOL = 1e-3
NATIVE_AGG_L2 = 0.1
NATIVE_STEP_L2 = 0.3


def check_native_step(out, arch, msg):
    """One step of a native (bf16 / fp32) tree: the loss within rtol
    NATIVE_LOSS_RTOL, the fp32 aggregate within NATIVE_AGG_L2 and the
    parameter change (post-step minus initial) within NATIVE_STEP_L2,
    relative in L2 norm."""
    p0 = flat_np(family_params_numpy(arch, None)).astype(np.float64)
    for jl, tl, ja, ta, jpar, tpar, *_ in out:
        np.testing.assert_allclose(tl, jl, rtol=NATIVE_LOSS_RTOL,
                                   err_msg=msg)
        assert ta.dtype == np.float32
        assert rel_l2(ta, ja) <= NATIVE_AGG_L2, msg
        assert rel_l2(tpar - p0, np.asarray(jpar, np.float64) - p0) <= (
            NATIVE_STEP_L2), msg


@pytest.mark.parametrize("arch,rule", STEP_CASES)
def test_sync_step_on_the_native_tree_matches_jax(arch, rule):
    """One synchronous robust step (n = 8, f = 2, sign_flip, the kernel
    impl) from JAX's weights in the config's own dtypes: the native bars
    (:func:`check_native_step`)."""
    out = run_slice(rule, 0.0, steps=1, model=(arch, None))
    check_native_step(out, arch, f"{arch} {rule}")


def test_async_step_on_the_native_tree_matches_jax():
    """One async-loop step of trimmed_mean on mamba2-130m-smoke's native
    tree under the stragglers (6 of 8 deliver): the sync step's native
    bars, and the fp32 in-flight buffer within NATIVE_AGG_L2 in norm."""
    out = run_async("trimmed_mean", 0.0, steps=1,
                    model=("mamba2-130m-smoke", None))
    check_native_step(out, "mamba2-130m-smoke", "async trimmed_mean")
    for *_, jbuf, tbuf, _, _ in out:
        assert rel_l2(tbuf, jbuf) <= NATIVE_AGG_L2
