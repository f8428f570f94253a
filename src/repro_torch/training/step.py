"""Byzantine-robust synchronous training step (counterpart of
``repro.training.step``).

The survey's server-based BGD framework (Algorithm 2), on one card:

  1. per-agent loss and gradient, in an agent loop that copies each
     agent's gradient straight into its row of a preallocated (n, P)
     arena, in FlatPlan order — that copy is the one ravel;
  2. worker momentum (agents send momentum, not raw gradients);
  3. Byzantine injection: the attack rewrites the f adversarial rows,
     leaf by leaf in fp32, cast back to the arena dtype;
  4. ``spec.aggregate_flat(arena)`` — with ``impl="auto"`` the rule's
     hand-written CUDA kernels;
  5. one unravel, then the server-side optimizer applies the update.

``agg_dtype`` (the compressed exchange): ``"int8"`` or
``"float8_e4m3fn"`` quantizes the fp32 arena per row after the attack
(:func:`repro_torch.core.flat.quantize_rows`) and aggregates the codes
with their row scales, ``spec.aggregate_flat(codes, scale=qs)`` (the
scaled kernels K18 / K15 dequantize in registers; other rules dequantize
at engine level).  A float dtype (``"bfloat16"``, ``"float16"``) casts
the arena to it and runs the rule's usual kernels on that arena; the
aggregate then unravels to leaves of that dtype, as in the JAX step.

``bucket`` (elastic membership): gradients are still computed for all n
agents, but the rule runs over the LIVE roster packed into a (bucket,)
stack (``roster_idx``, padded by repeating a live slot, and
``roster_valid`` marking the real slots), with the bucket's respecialized
spec.  Each build counts once as ``"train_step"``
(:mod:`repro_torch.obs.counters`).

``draco_r`` (gradient coding, Draco): the aggregate is the repetition
code's decode instead of the rule's
(:func:`repro_torch.core.redundancy.coding.flat_draco_aggregate`: the
vote on K2's Gram, the winners applied by K7).  The group table is built
once per (bucket, r) when the step is built; an elastic bucket votes over
the packed live rows with ``roster_valid`` as the mask, its table ragged
where r does not divide the bucket; a quantized exchange hands the coded
path the fake-quantized stack (codes and scales have no coded kernel), in
the parameters' dtype, as the JAX step does.

``telemetry`` (a Python flag): the metrics also carry the step's
telemetry row ``{"sel_w", "mask", "contrib_w"}``, (n,) each: the rule's
selection weights (``spec.selection_weights``, computed after the
aggregate from the same arena and never fed to it; the pre-quantization
fp32 arena of a quantized exchange), scattered to the full roster from
an elastic bucket, or uniform participation over the live roster for the
coded decode.  Off, the step is the same program: the same launches and
no new host sync.

Restricted to ``group_size=1`` and ``reshard=False`` (each raises
``NotImplementedError`` naming the ROADMAP.md slice that brings it).
Stateful specs and the defense-aware attacks raise as in the JAX step:
they run through the async loop, which threads their state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
import torch

from repro_torch.core.aggregators import AggregatorSpec
from repro_torch.core.attacks import (get_attack, is_adaptive_attack,
                                      make_byzantine_mask)
from repro_torch.core.flat import (QUANT_DTYPES, FlatPlan, dtype_name,
                                   fake_quantize, quantize_rows)
from repro_torch.core.momentum import worker_momentum
from repro_torch.core.redundancy.coding import (coding_groups,
                                                flat_draco_aggregate)
from repro_torch.device import resolve_device
from repro_torch.models import loss_fn
from repro_torch.obs.counters import count_trace
from repro_torch.optim import apply_updates
from repro_torch.tree import tree_leaves


@dataclass(frozen=True, kw_only=True)
class ByzantineConfig:
    n_agents: int = 16
    f: int = 3
    aggregator: AggregatorSpec          # robust aggregation (make_spec)
    attack: str = "none"
    attack_hyper: dict = field(default_factory=dict)
    momentum_alpha: float = 0.0         # 0 = raw gradients
    draco_r: int = 0                    # > 0: coded aggregation instead
    remat: bool = False                 # per-layer activation checkpointing
    group_size: int = 1
    agg_dtype: str = ""
    reshard: bool = False

    def __post_init__(self):
        # the repetition code's shape contract, checked at config time
        if self.draco_r:
            coding_groups(self.n_agents, self.draco_r)

    def resolve_spec(self) -> AggregatorSpec:
        """The ``aggregator``, checked against the config's f and n."""
        spec = self.aggregator
        if spec.f != self.f:
            raise ValueError(
                f"aggregator {spec.describe()} was built for f={spec.f} "
                f"but the config declares f={self.f}")
        if spec.n is not None and spec.n != self.n_agents:
            raise ValueError(
                f"aggregator {spec.describe()} was built for n={spec.n} "
                f"but the config declares n_agents={self.n_agents}")
        return spec


def unsupported(bz: ByzantineConfig):
    """Why ``bz`` cannot run on the port yet (naming the ROADMAP.md slice),
    or None."""
    if bz.group_size > 1 or bz.reshard:
        return ("group_size / reshard come with ROADMAP.md slice 11 "
                "(distribution)")
    return None


def roster_members(n: int, roster_idx, roster_valid):
    """(n,) bool: the agents of the live roster packed in ``roster_idx``
    (the pad slots repeat a live one)."""
    hits = torch.zeros((n,), dtype=torch.float32, device=roster_idx.device)
    return hits.index_add(0, roster_idx, roster_valid.float()) > 0


def scatter_roster(sel_b, n: int, roster_idx, roster_valid):
    """(bucket,) weights of the packed live rows -> (n,) on the full
    roster (0 for the agents outside it; a pad slot adds 0)."""
    return torch.zeros((n,), dtype=torch.float32,
                       device=sel_b.device).index_add(
        0, roster_idx, torch.where(roster_valid, sel_b.float(), 0.0))


def participation(mask):
    """Uniform shares over the (n,) bool ``mask``: the coded decode's
    per-agent attribution (its vote is per group)."""
    mf = mask.float()
    return mf / torch.clamp_min(torch.sum(mf), 1.0)


def exchange_dtype(bz: ByzantineConfig):
    """``(quantized, dtype)`` of the config's ``agg_dtype``: a quantized
    exchange (int8 / float8_e4m3fn codes with a scale per row), a float
    dtype the arena is cast to, or ``(False, None)`` for none."""
    if not bz.agg_dtype:
        return False, None
    dt = getattr(torch, bz.agg_dtype, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"agg_dtype {bz.agg_dtype!r} is not a torch dtype")
    if bz.agg_dtype in QUANT_DTYPES:
        return True, dt
    if not dt.is_floating_point:
        raise ValueError(f"agg_dtype {bz.agg_dtype!r}: a cast exchange "
                         "takes a float dtype (int8 and float8_e4m3fn are "
                         "quantized per row)")
    return False, dt


def attack_arena(attack_fn, gen, plan: FlatPlan, arena, byz_mask,
                 out=None):
    """Apply a static attack leaf by leaf: each leaf's (n, size) column
    block is attacked in fp32 and cast back (the JAX ``tree_attack``;
    every attack is coordinate-decomposable).  In place, or into ``out``
    (an arena like ``arena``) when given."""
    out = arena if out is None else out
    for src, dst in zip(plan.leaf_columns(arena), plan.leaf_columns(out)):
        dst.copy_(attack_fn(gen, src.float(), byz_mask))


def make_train_step(cfg, bz: ByzantineConfig, optimizer, device=None,
                    bucket: int | None = None, telemetry: bool = False):
    """Returns ``train_step(params, opt_state, momentum, batch, gen=None,
    roster_idx=None, roster_valid=None) -> (params, opt_state, momentum,
    metrics)``.

    ``params`` is the nested parameter dict (updated in place),
    ``momentum`` the (n, P) fp32 worker-momentum buffer or None,
    ``batch`` holds (n, b, T) ``tokens``/``labels`` on ``device``, ``gen``
    the generator of attacks that draw noise; ``roster_idx`` (bucket,)
    int64 and ``roster_valid`` (bucket,) bool, on ``device``, when
    ``bucket`` is set.  ``device`` defaults to ``cuda`` and raises when
    CUDA is missing."""
    dev = resolve_device(device)
    why = unsupported(bz)
    if why:
        raise NotImplementedError(why)
    if is_adaptive_attack(bz.attack):
        raise NotImplementedError(
            f"{bz.attack} is a defense-aware attack — run it through the "
            "async loop (repro_torch.simulator.async_loop threads attack "
            "state and the defense's center alongside aggregator state)")
    quant, xdt = exchange_dtype(bz)
    spec = bz.resolve_spec()
    if spec.stateful:
        raise NotImplementedError(
            f"{spec.name} is stateful — run it through the async loop "
            "(repro_torch.simulator.async_loop threads aggregator state)")
    if bucket is not None or spec.elastic_n is not None:
        # an elastic master runs as its n_max bucket
        spec = spec.respecialize(bucket if bucket is not None
                                 else bz.n_agents)
    if not spec.flat_capable:
        raise NotImplementedError(f"{spec.describe()} has no flat path")
    # the bucket's group table, built here, once per (bucket, r); the
    # packed live rows are regrouped by position (exact in the parallel
    # regime, where every agent computes the same shard)
    groups = (coding_groups(bucket if bucket is not None else bz.n_agents,
                            bz.draco_r, allow_ragged=bucket is not None)
              if bz.draco_r else None)
    attack_fn = (get_attack(bz.attack, **bz.attack_hyper)
                 if bz.attack != "none" else None)
    n = bz.n_agents
    byz_mask = make_byzantine_mask(n, bz.f, device=dev)
    honest = (~byz_mask).float()
    count_trace("train_step")

    def train_step(params, opt_state, momentum, batch, gen=None,
                   roster_idx=None, roster_valid=None):
        if (roster_idx is None) != (bucket is None):
            raise ValueError("roster_idx/roster_valid go with bucket=")
        leaves = tree_leaves(params)
        for leaf in leaves:
            if leaf.device != dev:
                raise ValueError(f"parameters on {leaf.device}, step built "
                                 f"for {dev}")
            leaf.requires_grad_(True)
        plan = FlatPlan.for_proto(params)

        # (1) per-agent gradients, each copied into its arena row
        arena = plan.empty_arena(n, dev)
        losses = torch.empty((n,), dtype=torch.float32, device=dev)
        for i in range(n):
            agent_batch = {k: v[i] for k, v in batch.items()}
            loss = loss_fn(cfg, params, agent_batch, remat=bz.remat)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                plan.write_row(arena, i, grads)
                losses[i] = loss.detach()
            del grads, loss

        with torch.no_grad():
            # (2) variance reduction: agents send momentum (fp32 arena)
            if bz.momentum_alpha > 0.0:
                momentum, _ = worker_momentum(momentum, arena,
                                              bz.momentum_alpha)
                arena = momentum.clone()

            # (3) Byzantine injection at the communication boundary
            if attack_fn is not None:
                attack_arena(attack_fn, gen, plan, arena, byz_mask)

            # (4) robust aggregation on the arena (the live roster packed
            # into its bucket under elastic membership), or the coded
            # decode, then one unravel.  A
            # quantized exchange sends per-row codes and an fp32 scale
            # per row, quantized from the fp32 arena; a cast exchange
            # sends the arena in agg_dtype, and its aggregate unravels to
            # leaves of that dtype.  The coded path takes the fake-
            # quantized stack in the parameters' dtype
            qs = None
            # the stack the telemetry reads: the arena as exchanged, or
            # the fp32 arena a quantized exchange quantizes
            tel_stack = (arena if telemetry and quant and not bz.draco_r
                         else None)
            if quant and bz.draco_r:
                arena = fake_quantize(arena, xdt).to(arena.dtype)
            elif quant:
                arena, qs = quantize_rows(arena, xdt)
            elif xdt is not None:
                arena = arena.to(xdt)
                plan = plan.as_dtype(dtype_name(xdt))
            if bz.draco_r and bucket is not None:
                vec = flat_draco_aggregate(arena[roster_idx], bz.draco_r,
                                           mask=roster_valid, groups=groups)
            elif bz.draco_r:
                vec = flat_draco_aggregate(arena, bz.draco_r, groups=groups)
            elif bucket is not None:
                vec = spec.aggregate_flat(
                    arena[roster_idx], mask=roster_valid,
                    scale=None if qs is None else qs[roster_idx])
            else:
                vec = spec.aggregate_flat(arena, scale=qs)
            if telemetry:
                telem = _step_telemetry(
                    spec, n, arena if tel_stack is None else tel_stack,
                    bool(bz.draco_r), roster_idx, roster_valid)
            del arena, qs, tel_stack
            agg = plan.unravel(vec)

            # (5) server-side optimizer
            updates, opt_state = optimizer.update(agg, opt_state, params)
            apply_updates(params, updates)

            gnorm = torch.sqrt(sum(torch.sum(torch.square(l.float()))
                                   for l in tree_leaves(agg)))
            metrics = {
                "loss": torch.sum(losses * honest) / torch.sum(honest),
                "loss_all": torch.mean(losses),
                "grad_norm": gnorm,
            }
            if telemetry:
                metrics["telemetry"] = telem
        return params, opt_state, momentum, metrics

    return train_step


def _step_telemetry(spec, n, stack, coded, roster_idx=None,
                    roster_valid=None):
    """The synchronous step's telemetry row from the (n, P) ``stack``."""
    member = (torch.ones((n,), dtype=torch.bool, device=stack.device)
              if roster_idx is None
              else roster_members(n, roster_idx, roster_valid))
    if coded:
        sel = participation(member)
    elif roster_idx is None:
        sel = spec.selection_weights(stack)
    else:
        sel = scatter_roster(
            spec.selection_weights(stack[roster_idx], mask=roster_valid),
            n, roster_idx, roster_valid)
    return {"sel_w": sel, "mask": member, "contrib_w": member.float()}
