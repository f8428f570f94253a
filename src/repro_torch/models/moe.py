"""Top-k mixture-of-experts block with capacity-based token dispatch.

Counterpart of ``repro.models.moe``: tokens are placed into a dense
(E, C, D) buffer, the experts run as batched matmuls, and the results
gather back weighted by the renormalized router probabilities.  A (token,
k) entry past its expert's capacity is dropped (its residual path passes
through), Switch / GShard semantics.  Plain torch ops: the JAX package
has no kernel here.  The sharding hints of the dispatch come with
distribution (ROADMAP.md item 23).

Three points where the port's law is spelled out:

* **Ties.**  ``lax.top_k`` puts the lower expert index first among equal
  probabilities; ``torch.topk`` promises no order, so the routing takes a
  stable descending sort.
* **Determinism.**  Each kept entry's (expert, slot) is unique by
  construction; dropped entries are written to one spare row past the
  buffer, which is thrown away, so no two writes of the buffer collide.
* **The reference's overwrite (ROADMAP.md R2).**  JAX's scatter sends
  every dropped entry to (expert 0, slot 0) as a zero row, and XLA's CPU
  keeps the last write.  So when a dropped entry comes after expert 0's
  first kept entry in flat (token, k) order, that token's expert-0 input
  is zero.  The port reproduces this: it zeroes ``buf[0, 0]`` exactly
  then.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import activate, dense_init


def init_moe(gen, cfg, dtype):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {
        "router": dense_init(gen, (D, E), torch.float32),
        "w_gate": dense_init(gen, (E, D, F), dtype),
        "w_up": dense_init(gen, (E, D, F), dtype),
        "w_down": dense_init(gen, (E, F, D), dtype),
    }
    if cfg.shared_expert:
        p["shared"] = {
            "w_gate": dense_init(gen, (D, F), dtype),
            "w_up": dense_init(gen, (D, F), dtype),
            "w_down": dense_init(gen, (F, D), dtype),
        }
    return p


def capacity(cfg, num_tokens: int) -> int:
    c = int(num_tokens * cfg.experts_per_token * cfg.capacity_factor
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)   # round up to 8


def route(cfg, probs, C: int):
    """The dispatch of (N, E) router probabilities into capacity ``C``:
    (gate values (N, K) renormalized, expert ids (N, K), slot (N*K,),
    keep (N*K,), r2 (,) bool: JAX's drop writes zero expert 0's slot 0)."""
    E, K = cfg.num_experts, cfg.experts_per_token
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    expert_ids = order[:, :K]                                   # (N, K)
    gate_vals = torch.gather(probs, 1, expert_ids)
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # position of each (token, k) inside its expert's capacity buffer:
    # its rank among the earlier entries of the same expert
    flat_ids = expert_ids.reshape(-1)                           # (N*K,)
    onehot = torch.nn.functional.one_hot(flat_ids, E)
    slot = torch.sum(torch.cumsum(onehot, dim=0) * onehot, dim=-1) - 1
    keep = slot < C
    # R2: a dropped entry after expert 0's first (slot 0) entry
    idx = torch.arange(flat_ids.numel(), device=probs.device)
    last_drop = torch.max(torch.where(keep, -1, idx))
    first0 = torch.min(torch.where(flat_ids == 0, idx, idx.numel()))
    r2 = last_drop > first0
    return gate_vals, expert_ids, slot, keep, r2


def moe_block(cfg, params, x):
    """x: (B, T, D) -> (out, aux_loss)."""
    B, T, D = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    N = B * T
    C = capacity(cfg, N)
    xf = x.reshape(N, D)

    logits = xf.float() @ params["router"]                      # (N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids, slot, keep, r2 = route(cfg, probs, C)

    # load-balance aux loss (Switch): E * sum_e fraction_e * prob_e
    onehot = torch.nn.functional.one_hot(expert_ids, E).float()  # (N, K, E)
    density = torch.mean(torch.sum(onehot, dim=1), dim=0)       # (E,)
    router_prob = torch.mean(probs, dim=0)
    aux = E * torch.sum(density * router_prob) * cfg.router_aux_coef

    # kept entries to their (expert, slot) row, dropped ones to the spare
    # row E * C; then JAX's overwrite of (0, 0) where R2 holds
    flat_ids = expert_ids.reshape(-1)
    row = torch.where(keep, flat_ids * C + slot,
                      torch.full_like(slot, E * C))
    tok_idx = torch.arange(N, device=x.device).repeat_interleave(K)
    buf = xf.new_zeros((E * C + 1, D)).index_put((row,), xf[tok_idx])
    live = torch.ones((E * C, 1), dtype=torch.bool, device=x.device)
    live[0, 0] = ~r2
    buf = torch.where(live, buf[:E * C], 0.0).reshape(E, C, D)

    # expert computation: batched matmuls (E, C, D) @ (E, D, F)
    h = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    h = activate(cfg, h, u)
    out_buf = torch.bmm(h, params["w_down"]).reshape(E * C, D)

    # gather back, weighted by the (renormalized) gate values
    safe = torch.where(keep, flat_ids * C + slot, torch.zeros_like(slot))
    gathered = out_buf[safe]                                    # (N*K, D)
    gathered = torch.where(keep[:, None], gathered, 0.0)
    gathered = gathered * gate_vals.reshape(-1)[:, None].to(x.dtype)
    out = torch.sum(gathered.reshape(N, K, D), dim=1)

    if cfg.shared_expert:
        s = params["shared"]
        sh = activate(cfg, xf @ s["w_gate"], xf @ s["w_up"])
        out = out + sh @ s["w_down"]
    return out.reshape(B, T, D), aux
