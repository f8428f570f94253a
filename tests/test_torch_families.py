"""Parity of the text families' modules with the JAX package (ROADMAP.md
item 22a), on the CPU: the eight configs, the port's own init, the
sliding-window mask, the SSD scan and the Mamba2 block, the MoE block's
routing (ties, drops and the reference's overwrite R2) and the Zamba2
hybrid with a tail.  Inputs are made with numpy from a seed; weights come
from ``repro.models.init_params``.  Each test states its tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import num_params as jax_num_params
from repro.models import attention as jattn
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import moe as jmoe
from repro.models import ssm as jssm
from repro_torch.configs import get_config, list_archs, num_params
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.models import forward_train, init_params, loss_fn
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models.layers import activate
from repro_torch.tree import tree_items, tree_leaves
from test_torch_helpers import (FAMILY_SEQ, GRAD_TOL, LOGIT_TOL, batch_np,
                                family_configs, family_params_numpy,
                                leaves_np)

torch.set_num_threads(2)
TEXT_ARCHS = ["mamba2-130m", "mixtral-8x22b", "llama4-scout-17b-a16e",
              "zamba2-7b", "h2o-danube-3-4b", "llama3-8b", "phi4-mini-3.8b",
              "internlm2-20b"]
BF16_TOL = 2e-2
# the SSD bar: JAX's segsum takes differences of cumulative sums of the
# log-decays (up to ~34 in magnitude at chunk 32), and an ulp of such a
# sum moves exp(seg) by that ulp relative; XLA's CPU cumsum rounds in fp32
# while torch's CPU cumsum accumulates in fp64, so the two scans agree to
# LOGIT_TOL relative to the largest output, not to each small entry
SSD_TOL = LOGIT_TOL


def np32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def to_t(a):
    return torch.from_numpy(np.array(a, copy=True))


def close_to_peak(ours, ref, tol, msg=""):
    """|ours - ref| <= tol * (1 + max |ref|) elementwise, and rtol tol."""
    ref = np.asarray(ref, np.float32)
    ours = np.asarray(ours, np.float32)
    np.testing.assert_allclose(ours, ref, rtol=tol,
                               atol=tol * (1.0 + np.abs(ref).max()),
                               err_msg=msg)


# ---------------------------------------------------------------------------
# configs and the port's own init


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", TEXT_ARCHS)
def test_config_fields_and_num_params(arch, smoke):
    """Exact: every field and the closed-form parameter count, full and
    reduced."""
    name = arch + ("-smoke" if smoke else "")
    ours, ref = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert num_params(ours) == jax_num_params(ref)
    if name == "mamba2-130m":
        assert num_params(ours) == 128_940_480
    assert arch in list_archs()


@pytest.mark.parametrize("arch", TEXT_ARCHS)
def test_init_params_layout_laws_and_count(arch):
    """Exact: the port's own init of the smoke config in its native dtype
    has JAX's paths, shapes and dtypes (the SSM's A_log / dt_bias /
    D_skip and the router fp32 beside bf16 leaves), JAX's count of
    values, which is num_params plus the SSM's conv biases that
    num_params leaves out (ROADMAP.md R3), and JAX's constant leaves
    (norms, conv_b, A_log, dt_bias zero, D_skip one) bit for bit; each
    random leaf's standard deviation within 10 % of JAX's draw of the
    same law."""
    cfg, _ = family_configs(arch + "-smoke", None)
    ours = init_params(cfg, torch.Generator().manual_seed(0))
    ref = family_params_numpy(arch + "-smoke", None)
    ref_items = [(tuple(k.key for k in path), leaf) for path, leaf in
                 jax.tree_util.tree_flatten_with_path(ref)[0]]
    assert [p for p, _ in tree_items(ours)] == [p for p, _ in ref_items]
    total = sum(t.numel() for t in tree_leaves(ours))
    assert total == sum(r.size for _, r in ref_items)
    conv_b = (cfg.num_layers * (cfg.d_inner + 2 * cfg.ssm_groups
                                * cfg.ssm_state)
              if cfg.family in ("ssm", "hybrid") else 0)
    assert total == num_params(cfg) + conv_b
    for (path, t), (_, r) in zip(tree_items(ours), ref_items):
        r_t = tensor_from_numpy(r)
        assert tuple(t.shape) == r.shape and t.dtype == r_t.dtype, path
        r32, t32 = r_t.float(), t.float()
        if torch.all(r32 == r32.flatten()[0]):
            assert torch.equal(t32, r32), path
        else:
            np.testing.assert_allclose(float(t32.std()), float(r32.std()),
                                       rtol=0.1, err_msg=str(path))


def test_unported_options_are_refused_naming_slice_10b():
    """GELU, M-RoPE, qkv_bias, the encoder-decoder and the vision frontend
    raise NotImplementedError naming slice 10b."""
    base = get_config("paper-100m-smoke")
    x = torch.zeros(1, 4, base.d_model)
    cases = [
        lambda: activate(base.replace(act="gelu"), x, x),
        lambda: tattn.attention(base.replace(positional="mrope"), {}, x),
        lambda: init_params(base.replace(qkv_bias=True),
                            torch.Generator()),
        lambda: init_params(base.replace(encoder_layers=2),
                            torch.Generator()),
        lambda: forward_train(base.replace(frontend="vision"), {},
                              {"tokens": torch.zeros(1, 4).long()}),
    ]
    for case in cases:
        with pytest.raises(NotImplementedError, match="10b"):
            case()


# ---------------------------------------------------------------------------
# the sliding window


@pytest.mark.parametrize("T,S,off,window", [
    (80, 80, 0, 64), (80, 80, 0, 0), (5, 12, 7, 4), (1, 64, 63, 64),
    (64, 64, 0, 1)])
def test_causal_window_mask_matches_jax(T, S, off, window):
    """Exact."""
    ours = tattn._causal_window_mask(T, S, off, window)
    ref = np.asarray(jattn._causal_window_mask(T, S, off, window))
    np.testing.assert_array_equal(ours.numpy(), ref)


def test_sliding_window_attention_matches_jax():
    """h2o-danube-3-4b-smoke (window 64) at T = 80: rtol = atol =
    LOGIT_TOL against JAX; and the output at positions 64 and later is
    bitwise unchanged when the first token's input moves (it lies outside
    their window)."""
    arch = "h2o-danube-3-4b-smoke"
    cfg, jcfg = family_configs(arch)
    blk = jax.tree.map(lambda a: a[0],
                       family_params_numpy(arch)["blocks"]["attn"])
    x = np32(np.random.default_rng(0), 2, FAMILY_SEQ, cfg.d_model)
    ours = tattn.attention(cfg, params_from_numpy(blk), to_t(x))
    ref = jattn.attention(jcfg, jax.tree.map(jnp.asarray, blk),
                          jnp.asarray(x))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    x2 = x.copy()
    x2[:, 0] += 1.0
    moved = tattn.attention(cfg, params_from_numpy(blk), to_t(x2))
    assert torch.equal(moved[:, cfg.sliding_window:],
                       ours[:, cfg.sliding_window:])
    assert not torch.equal(moved[:, 1:cfg.sliding_window],
                           ours[:, 1:cfg.sliding_window])


# ---------------------------------------------------------------------------
# SSD and the Mamba2 block


def ssd_inputs(seed, t, h=8, p=16, g=1, n=16, b=2):
    rng = np.random.default_rng(seed)
    return (np32(rng, b, t, h, p),
            -np.abs(np32(rng, b, t, h, scale=0.5)),
            np32(rng, b, t, g, n), np32(rng, b, t, g, n))


@pytest.mark.parametrize("t,chunk,g,init", [
    (80, 32, 1, False),     # three chunks, the last padded
    (32, 32, 1, False),     # one whole chunk
    (20, 32, 1, False),     # one padded chunk
    (80, 32, 2, True),      # two groups, a carried-in state
])
def test_ssd_chunked_matches_jax(t, chunk, g, init):
    """y and the final state within SSD_TOL relative to their largest
    entry (see SSD_TOL)."""
    x, a, B, C = ssd_inputs(t, t, g=g)
    s0 = (np32(np.random.default_rng(9), 2, 8, 16, 16) if init else None)
    ref_y, ref_s = jssm.ssd_chunked(*map(jnp.asarray, (x, a, B, C)), chunk,
                                    None if s0 is None else jnp.asarray(s0))
    y, s = tssm.ssd_chunked(*map(to_t, (x, a, B, C)), chunk,
                            None if s0 is None else to_t(s0))
    assert y.dtype == torch.float32 and s.dtype == torch.float32
    close_to_peak(y.numpy(), ref_y, SSD_TOL)
    close_to_peak(s.numpy(), ref_s, SSD_TOL)


def test_ssd_backward_matches_jax_with_no_inf_minus_inf():
    """The gradients of sum(w * y) + sum(v * state) with respect to x, a,
    B and C are finite under anomaly detection (no backward reads the
    segsum's -inf triangle: an inf - inf would raise), and within
    GRAD_TOL of JAX's relative to their largest entry."""
    x, a, B, C = ssd_inputs(3, 80)
    rng = np.random.default_rng(4)
    w, v = np32(rng, *x.shape), np32(rng, 2, 8, 16, 16)

    def jf(*args):
        y, s = jssm.ssd_chunked(*args, 32)
        return jnp.sum(y * w) + jnp.sum(s * v)
    ref = jax.jit(jax.grad(jf, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, a, B, C)))
    ins = [to_t(z).requires_grad_(True) for z in (x, a, B, C)]
    with torch.autograd.detect_anomaly():
        y, s = tssm.ssd_chunked(*ins, 32)
        grads = torch.autograd.grad(
            torch.sum(y * to_t(w)) + torch.sum(s * to_t(v)), ins)
    for g_, r in zip(grads, ref):
        assert torch.isfinite(g_).all()
        close_to_peak(g_.numpy(), r, GRAD_TOL)


@pytest.mark.parametrize("t", [FAMILY_SEQ, 20])
def test_mamba_block_matches_jax(t):
    """mamba2-130m-smoke in fp32, three chunks (t = 80) and one padded
    chunk (t = 20): y and the final state within SSD_TOL relative to
    their largest entry."""
    arch = "mamba2-130m-smoke"
    cfg, jcfg = family_configs(arch)
    blk = jax.tree.map(lambda a: a[1],
                       family_params_numpy(arch)["blocks"]["ssm"])
    x = np32(np.random.default_rng(t), 2, t, cfg.d_model)
    ref_y, ref_s = jssm.mamba_block(jcfg, jax.tree.map(jnp.asarray, blk),
                                    jnp.asarray(x))
    y, s = tssm.mamba_block(cfg, params_from_numpy(blk), to_t(x))
    close_to_peak(y.numpy(), ref_y, SSD_TOL)
    close_to_peak(s.numpy(), ref_s, SSD_TOL)


def test_mamba_block_bf16_matches_jax():
    """mamba2-130m-smoke in its native dtype (bf16 weights and
    activations, fp32 A_log / dt_bias / D_skip and state) at t = 80: y
    (bf16) and the fp32 state within the bf16 bar, 2e-2 relative to
    their largest entry."""
    arch = "mamba2-130m-smoke"
    cfg, jcfg = family_configs(arch, None)
    blk = jax.tree.map(lambda a: a[0],
                       family_params_numpy(arch, None)["blocks"]["ssm"])
    x = np.asarray(jnp.asarray(np32(np.random.default_rng(5), 2,
                                    FAMILY_SEQ, cfg.d_model), jnp.bfloat16))
    ref_y, ref_s = jssm.mamba_block(jcfg, jax.tree.map(jnp.asarray, blk),
                                    jnp.asarray(x))
    y, s = tssm.mamba_block(cfg, params_from_numpy(blk),
                            tensor_from_numpy(x))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    close_to_peak(y.float().numpy(), np.asarray(ref_y, np.float32),
                  BF16_TOL)
    close_to_peak(s.numpy(), ref_s, BF16_TOL)


# ---------------------------------------------------------------------------
# the MoE block


def jax_routing(jcfg, router, xf, C):
    """JAX's dispatch law (``repro.models.moe.moe_block``'s lines, as jnp):
    expert ids (N, K), slots (N*K,), keep (N*K,)."""
    E, K = jcfg.num_experts, jcfg.experts_per_token
    probs = jax.nn.softmax(jnp.asarray(xf) @ jnp.asarray(router), axis=-1)
    _, ids = jax.lax.top_k(probs, K)
    flat_onehot = jax.nn.one_hot(ids.reshape(-1), E, dtype=jnp.int32)
    slot = jnp.sum(jnp.cumsum(flat_onehot, axis=0) * flat_onehot, -1) - 1
    return np.asarray(ids), np.asarray(slot), np.asarray(slot < C)


def moe_case(arch, capacity_factor, router="jax"):
    cfg, jcfg = family_configs(arch)
    cfg = cfg.replace(capacity_factor=capacity_factor)
    jcfg = jcfg.replace(capacity_factor=capacity_factor)
    blk = dict(jax.tree.map(lambda a: a[0],
                            family_params_numpy(arch)["blocks"]["moe"]))
    if router == "zero":           # every probability 1/E: all tied
        blk["router"] = np.zeros_like(blk["router"])
    elif router == "pair":         # experts 1 and 2 tied, and 0 and 3
        r = np.zeros_like(blk["router"])
        r[:, 1] = r[:, 2] = blk["router"][:, 1]
        blk["router"] = r
    x = np32(np.random.default_rng(11), 2, FAMILY_SEQ, cfg.d_model)
    return cfg, jcfg, blk, x


@pytest.mark.parametrize("arch,capacity_factor,router,drops,r2", [
    ("mixtral-8x22b-smoke", 1.25, "jax", False, False),
    ("mixtral-8x22b-smoke", 0.5, "jax", True, True),      # R2 shows
    ("llama4-scout-17b-a16e-smoke", 1.25, "jax", False, False),
    ("mixtral-8x22b-smoke", 1.25, "pair", False, False),  # a pair tie
    ("mixtral-8x22b-smoke", 1.25, "zero", True, True),    # all tied
])
def test_moe_block_matches_jax(arch, capacity_factor, router, drops, r2):
    """Exact: the expert ids (lower index first on ties, as lax.top_k),
    the slots and the kept set against JAX's dispatch law, the drop count
    and R2 (a drop after expert 0's slot-0 entry) as listed.  The aux
    loss within LOGIT_TOL of JAX's moe_block, the output within LOGIT_TOL
    relative to its largest entry: JAX's init law takes the stacked (E,
    D, F) expert leaves' fan-in as E, so the outputs run to hundreds and
    the matmuls' fp32 reassociation scales with them.  Where R2 holds, the
    output without its overwrite moves past the bar: the overwrite is
    what JAX computes (ROADMAP.md R2)."""
    cfg, jcfg, blk, x = moe_case(arch, capacity_factor, router)
    N = x.shape[0] * x.shape[1]
    C = tmoe.capacity(cfg, N)
    assert C == jmoe.capacity(jcfg, N)
    xf = x.reshape(N, -1)
    probs = torch.softmax(to_t(xf) @ to_t(blk["router"]), -1)
    _, ids, slot, keep, got_r2 = tmoe.route(cfg, probs, C)
    ref_ids, ref_slot, ref_keep = jax_routing(jcfg, blk["router"], xf, C)
    np.testing.assert_array_equal(ids.numpy(), ref_ids)
    np.testing.assert_array_equal(slot.numpy(), ref_slot)
    np.testing.assert_array_equal(keep.numpy(), ref_keep)
    assert bool((~keep).any()) == drops and bool(got_r2) == r2
    if router == "pair":           # each token's pair is tied: 1, 2 or 0, 3
        rows = {tuple(r) for r in ids.numpy().tolist()}
        assert rows == {(1, 2), (0, 3)}
    ref_out, ref_aux = jmoe.moe_block(jcfg, jax.tree.map(jnp.asarray, blk),
                                      jnp.asarray(x))
    tp = params_from_numpy(blk)
    out, aux = tmoe.moe_block(cfg, tp, to_t(x))
    close_to_peak(out.numpy(), ref_out, LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(ref_aux), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    if r2:
        real = tmoe.route
        try:
            tmoe.route = lambda *a: (*real(*a)[:4], torch.tensor(False))
            plain, _ = tmoe.moe_block(cfg, tp, to_t(x))
        finally:
            tmoe.route = real
        with pytest.raises(AssertionError):
            close_to_peak(plain.numpy(), ref_out, LOGIT_TOL)


# ---------------------------------------------------------------------------
# the hybrid with a tail


def test_zamba2_with_a_tail_matches_jax():
    """zamba2-7b-smoke at num_layers = 3, hybrid_attn_every = 2: one group
    of two SSM layers and the shared block, then one tail SSM layer.
    Logits and loss within LOGIT_TOL relative to the largest logit (the
    SSD bar, see SSD_TOL, carried through the stack), each gradient
    within GRAD_TOL, with remat on."""
    cfg, jcfg = family_configs("zamba2-7b-smoke")
    cfg = cfg.replace(num_layers=3, hybrid_attn_every=2)
    jcfg = jcfg.replace(num_layers=3, hybrid_attn_every=2)
    ref = jax.tree.map(np.asarray,
                       jax_init_params(jcfg, jax.random.PRNGKey(0)))
    tb, jb = batch_np(7, n=1, seq=FAMILY_SEQ)
    tb = {k: v[0] for k, v in tb.items()}
    jb = {k: v[0] for k, v in jb.items()}
    jp = jax.tree.map(jnp.asarray, ref)
    jl, _ = jax.jit(lambda p: jax_forward_train(jcfg, p, jb))(jp)
    tp = params_from_numpy(ref)
    tl, _ = forward_train(cfg, tp, tb)
    close_to_peak(tl.detach().numpy(), jl, LOGIT_TOL)
    jloss, jgrad = jax.jit(jax.value_and_grad(
        lambda p: jax_loss_fn(jcfg, p, jb)))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    loss = loss_fn(cfg, tp, tb, remat=True)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    for g, r in zip(torch.autograd.grad(loss, leaves), leaves_np(jgrad)):
        np.testing.assert_allclose(g.numpy(), r, rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
