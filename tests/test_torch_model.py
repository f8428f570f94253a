"""Parity of the port's model-side modules with the JAX package, on the
CPU at paper-100m-smoke: configs, logits and loss, per-agent gradients,
one AdamW update, SyntheticLM, the FlatPlan layout and the weight
conversion.  Each test states its tolerance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as jopt
import repro_torch.optim as topt
from repro.configs import get_config as jax_get_config
from repro.configs import num_params as jax_num_params
from repro.core.flat import FlatPlan as JaxFlatPlan
from repro.data import SyntheticLM as JaxSyntheticLM
from repro.data import label_flip as jax_label_flip
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro_torch.configs import get_config, num_params
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 params_from_numpy, params_to_numpy)
from repro_torch.core.flat import FlatPlan
from repro_torch.data import SyntheticLM, label_flip
from repro_torch.models import Transformer, forward_train, init_params
from repro_torch.models import loss_fn
from repro_torch.tree import tree_items, tree_leaves
from test_torch_helpers import (GRAD_TOL, LOGIT_TOL, batch_np, configs,
                                jax_params_numpy, leaves_np)


@pytest.mark.parametrize("arch", ["paper-100m", "paper-100m-smoke"])
def test_config_fields_and_num_params(arch):
    """Exact: every field and the closed-form parameter count."""
    ours, ref = get_config(arch), jax_get_config(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert num_params(ours) == jax_num_params(ref)
    if arch == "paper-100m":
        assert num_params(ours) == 124_668_672


def test_init_params_layout_and_count():
    """Exact: the port's own init has the JAX tree's paths, shapes and
    dtype, and the parameter count num_params gives."""
    cfg, _ = configs()
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    ref = jax_params_numpy()
    assert ([p for p, _ in tree_items(ours)]
            == [tuple(k.key for k in path) for path, _ in
                jax.tree_util.tree_flatten_with_path(ref)[0]])
    assert [tuple(t.shape) for t in tree_leaves(ours)] == [
        x.shape for x in leaves_np(ref)]
    assert sum(t.numel() for t in tree_leaves(ours)) == num_params(cfg)


def test_logits_and_loss_match_jax():
    """rtol = atol = 1e-5 (fp32; matmul reassociation)."""
    cfg, jcfg = configs()
    tb, jb = batch_np(1, n=1)
    tb = {k: v[0] for k, v in tb.items()}
    jb = {k: v[0] for k, v in jb.items()}
    jp = jax.tree.map(jnp.asarray, jax_params_numpy())
    tp = params_from_numpy(jax_params_numpy())
    jl, _ = jax_forward_train(jcfg, jp, jb)
    tl, _ = forward_train(cfg, tp, tb)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    model = Transformer(cfg, tp)
    for loss in (loss_fn(cfg, tp, tb), model(tb)):
        np.testing.assert_allclose(loss.item(),
                                   float(jax_loss_fn(jcfg, jp, jb)),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert ({n for n, _ in model.named_parameters()}
            == {".".join(("params",) + p) for p, _ in tree_items(tp)})


@pytest.mark.parametrize("remat", [False, True])
def test_per_agent_gradients_match_jax(remat):
    """rtol = atol = 1e-4 for every agent's gradient; per-layer remat
    changes nothing but memory."""
    cfg, jcfg = configs()
    n = 3
    tb, jb = batch_np(2, n=n)
    jp = jax.tree.map(jnp.asarray, jax_params_numpy())
    jgrads = jax.vmap(jax.grad(lambda p, b: jax_loss_fn(jcfg, p, b)),
                      in_axes=(None, 0))(jp, jb)
    tp = params_from_numpy(jax_params_numpy())
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    for i in range(n):
        loss = loss_fn(cfg, tp, {k: v[i] for k, v in tb.items()}, remat)
        grads = torch.autograd.grad(loss, leaves)
        for g, ref in zip(grads, leaves_np(jgrads)):
            np.testing.assert_allclose(g.numpy(), ref[i], rtol=GRAD_TOL,
                                       atol=GRAD_TOL)


def test_one_adamw_update_matches_jax():
    """One AdamW update (default eps, weight decay on) from identical
    gradients and state: rtol = atol = 1e-6 on updates, moments and the
    applied parameters (fp32 elementwise law, no reductions)."""
    rng = np.random.default_rng(3)
    params = {"a": rng.normal(size=(5, 7)).astype(np.float32),
              "b": {"c": rng.normal(size=(11,)).astype(np.float32)}}
    grads = jax.tree.map(lambda p: rng.normal(size=p.shape).astype(
        np.float32), params)
    state = {"step": np.int32(4),
             "m": jax.tree.map(lambda p: 0.1 * rng.normal(size=p.shape)
                               .astype(np.float32), params),
             "v": jax.tree.map(lambda p: np.abs(rng.normal(size=p.shape))
                               .astype(np.float32), params)}
    jopt_ = jopt.adamw(jopt.constant(3e-3), weight_decay=0.1)
    topt_ = topt.adamw(topt.constant(3e-3), weight_decay=0.1)
    ju, js = jopt_.update(jax.tree.map(jnp.asarray, grads),
                          jax.tree.map(jnp.asarray, state),
                          jax.tree.map(jnp.asarray, params))
    jnew = jopt.apply_updates(jax.tree.map(jnp.asarray, params), ju)
    tp = params_from_numpy(params)
    tu, ts = topt_.update(params_from_numpy(grads),
                          opt_state_from_numpy(state), tp)
    topt.apply_updates(tp, tu)
    assert ts["step"] == int(js["step"]) == 5
    assert int(opt_state_to_numpy(ts)["step"]) == 5
    pairs = [(tu, ju), (tp, jnew), (ts["m"], js["m"]), (ts["v"], js["v"])]
    for ours, ref in pairs:
        for a, b in zip(leaves_np(params_to_numpy(ours)), leaves_np(ref)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("regime", ["iid", "noniid", "parallel"])
def test_synthetic_lm_matches_jax(regime):
    """Exact: with the JAX side's starts injected, the batches are equal,
    and so are the label-flipped ones."""
    V, T, n, b = 512, 16, 6, 3
    jds = JaxSyntheticLM(V, T, n, b, regime=regime)
    key = jax.random.PRNGKey(5)
    jb = jds.batch(key, 3)
    k_start = jax.random.fold_in(key, 3)
    if regime == "parallel":
        starts = np.broadcast_to(np.asarray(jax.random.randint(
            k_start, (1, b), 0, V)), (n, b))
    else:
        starts = np.asarray(jax.random.randint(k_start, (n, b), 0, V))
    tb = SyntheticLM(V, T, n, b, regime=regime).batch(starts)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    mask = np.arange(n) < 2
    np.testing.assert_array_equal(
        label_flip(tb, torch.from_numpy(mask), V)["labels"].numpy(),
        np.asarray(jax_label_flip(jb, jnp.asarray(mask), V)["labels"]))
    drawn = SyntheticLM(V, T, n, b, regime=regime).draw_starts(
        torch.Generator().manual_seed(0))
    assert drawn.shape == (n, b) and int(drawn.max()) < V


def test_flat_plan_matches_jax():
    """Exact: leaf order, offsets and total against the JAX plan; ravel
    then unravel_stack is the identity."""
    ref = jax_params_numpy()
    jplan = JaxFlatPlan.for_proto(ref)
    tp = params_from_numpy(ref)
    plan = FlatPlan.for_proto(tp)
    assert plan.offsets == jplan.offsets and plan.sizes == jplan.sizes
    assert plan.total == jplan.total
    stacked = jax.tree.map(lambda x: np.stack([x, 2 * x]), ref)
    jarena = np.asarray(JaxFlatPlan.for_tree(stacked).ravel(stacked))
    tstack = params_from_numpy(stacked)
    arena = FlatPlan.for_tree(tstack).ravel(tstack)
    np.testing.assert_array_equal(arena.numpy(), jarena)
    rows = plan.empty_arena(2, "cpu")
    for i in range(2):
        plan.write_row(rows, i, [t[i] for t in tree_leaves(tstack)])
    np.testing.assert_array_equal(rows.numpy(), jarena)
    back = plan.unravel_stack(arena)
    for a, b in zip(tree_leaves(back), tree_leaves(tstack)):
        assert torch.equal(a, b)
    one = plan.unravel(arena[1])
    for a, b in zip(tree_leaves(one), tree_leaves(tstack)):
        assert torch.equal(a, b[1])


def test_bf16_weights_cross_bit_for_bit():
    """Exact: bf16 leaves cross as their bits, both ways."""
    ref = jax.tree.map(np.asarray, jax_init_params(
        jax_get_config("paper-100m-smoke"), jax.random.PRNGKey(1)))
    tp = params_from_numpy(ref)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(tp))
    back = params_to_numpy(tp, like=ref)
    for a, b in zip(leaves_np(back), leaves_np(ref)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("diminishing", (0.1, 0.5)),
    ("cosine_warmup", (1e-3, 10, 100, 1e-5))])
def test_schedules_match_jax(name, args):
    """rtol 1e-6 (fp32 scalars; cosine is taken in fp64 before rounding)."""
    ours, ref = getattr(topt, name)(*args), getattr(jopt, name)(*args)
    for step in (0, 1, 5, 10, 11, 55, 100, 250):
        np.testing.assert_allclose(
            float(ours(step)), float(ref(jnp.asarray(step, jnp.int32))),
            rtol=1e-6, atol=0)
