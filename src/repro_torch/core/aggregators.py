"""Robust-aggregation registry: typed, validated specs (registry core).

Counterpart of ``repro.core.aggregators`` for the rules ported so far:

* :class:`AggregatorCaps` / :class:`AggregatorDef` / :func:`register_aggregator`
  — the single extension point;
* :class:`AggregatorSpec` / :func:`make_spec` — a frozen handle naming a
  rule plus its static configuration (``f``, hyper-parameters, ``impl``),
  hyper keys validated at build time;
* ``spec.aggregate`` / ``spec.aggregate_flat`` — the engine over a
  pytree or a pre-raveled (n, P) arena, synchronous or masked.

Registered: every rule of the JAX registry.  ``mean``,
``coordinate_median``, ``trimmed_mean``, ``krum``, the selection family
``cge``, ``multi_krum``, ``m_krum``, ``mda`` and ``bulyan``, the 1-bit
vote ``sign_sgd`` and the sparse / dropout-aware ``sparse_mean`` of the
compressed exchange run on kernels; ``phocas``, ``mean_around_median``,
``cgc``, ``geometric_median``, ``rfa``, ``median_of_means`` and the
stateful ``zeno`` have no kernel in either package and run their dense
laws; the defenses with memory ``centered_clip`` and ``zeno_pp``; and
the composition wrappers ``clipped``, ``bucketed``,
``staleness_discounted`` and ``server_momentum``.  Impls:

* ``kernel`` — the hand-written CUDA kernels (:mod:`repro_torch.kernels`),
  the JAX package's ``pallas``.  On a CPU tensor each kernel wrapper runs
  its plain PyTorch version.
* ``gather`` — the paper-faithful dense law (:mod:`.filters.dense`).
* ``auto`` — ``kernel`` for the rules in the kernel table whose hyper
  selects a kernelized variant (not ``bulyan(base != "krum")``), else
  ``gather``.
* ``fused`` — the JAX package's leaf-wise, sharding-aware impl: not
  ported yet (ROADMAP.md slice 11, distribution); asking for it raises.

Impl-only keys (``impl_keys`` of a rule): ``native_dtype`` on the
coordinate-wise rules (phocas and mean_around_median among them).  ``make_spec`` accepts it for those rules and
refuses it for the others, then drops it: only the JAX package's
leaf-wise ``fused`` impl reads it (ROADMAP.md slice 11), and the flat
path ignores it there too.

A rule whose law is neither of the engine's (``sparse_mean``: per-
coordinate weights; the stateful rules) owns its route: ``flat_fn`` takes
the whole ``aggregate_flat`` call (mask, raw weights, state, row scales)
and ``custom_fn`` the whole tree call, before the engine's synchronous and
masked paths.

Masked / staleness-weighted aggregation (``mask=``, ``weights=``): the
coordinate-wise rules take the order statistic over the ARRIVED rows only
(absent rows are +inf sort sentinels, the rank window follows the
arrived count; phocas and mean_around_median then average the arrived
values closest to that center) and sign_sgd the vote of the arrived
rows; krum, the selection family, cgc, zeno and the geometric-median
family run on the mean-imputed stack; mean is the exact
weighted mean of the arrived rows; each but mean is then scaled by the
mean arrived weight.  ``impl="kernel"`` runs the fused masked kernels
(K5-K7, K12, K14, K16), which never build the masked (n, P) copy.  A
masked tree of mixed leaf dtypes runs the coordinate-wise kernels once
per uniform-dtype segment; the pairwise kernel rules fall back to the
imputed tree path with a one-time warning.
Elastic membership:
``make_spec(..., f=frac(r), n=elastic(n_max, buckets))`` and
``spec.respecialize(n_live)``.

Quantized arenas (``aggregate_flat(codes, scale=qs)``, the compressed
exchange of ``agg_dtype`` int8 / float8_e4m3fn): with ``impl="kernel"``
coordinate_median, trimmed_mean, sign_sgd and sparse_mean dequantize
inside their kernels (K18-K21, K15 on the codes); every other rule, and
the gather impl, dequantizes the (n, P) arena first
(``core.flat.dequantize_rows``, with a one-time warning on the kernel
impl), as the JAX engine does.

State and wrappers (the defenses with memory): a stateful rule carries
its memory between steps (``spec.init_state(proto)``, passed back as
``aggregate_flat(..., state=)``, advanced by ``spec.update_state(state,
agg)`` after each aggregate); on the arena the port keeps ``server_grad``
as ONE fp32 (P,) vector in the JAX leaf order, which the JAX state tree
ravels onto exactly.  ``centered_clip`` (its flat law runs K22 under an
explicit ``impl="kernel"``; ``auto`` keeps the dense body) and
``zeno_pp`` are stateful rules, and so is ``zeno`` (its validation
gradient; ``ema > 0`` keeps it as an EMA of the aggregates, ``ema = 0``
needs the caller's own ``state={"server_grad": v}``).

Composition WRAPPERS aggregate with their ``inner`` spec, and an inner
rule's state nests under ``state["inner"]``: ``server_momentum(inner,
beta)`` (an fp32 momentum step on the inner aggregate), ``clipped(inner,
tau)`` (each row scaled to norm <= tau, cast back to the arena's dtype),
``bucketed(inner, group_size)`` (the means of consecutive buckets, the
inner f capped at (k - 1) // 2 of the k buckets; synchronous only) and
``staleness_discounted(inner, ...)`` (its ``weights`` are raw staleness
ROUNDS, turned into discounts: ``staleness_aware``, so the async loop,
which passes discounts, refuses it).  In JAX the wrappers and zeno run
only on the tree engine; the port gives each a flat law (the loops take
the arena) and a tree route that is the JAX tree law.

Selection telemetry (``spec.selection_weights``, read by
:mod:`repro_torch.obs`): the (n,) per-agent weights the rule applied.
The weight-decomposable rules (``AggregatorCaps.weight_decomposable``,
``AggregatorDef.weights_fn``) report their own application weights; on
the kernel impl the pairwise rules read them off the selection kernels
their aggregate launches (K2 -> K3 / K8 / K9 / K10, masked K4 -> K6
first), so they name the rows the aggregate used; bulyan reports its
theta picks, centered_clip the clip weights of its final iterate,
zeno_pp its acceptance weights, the coordinate-wise and iterative rules
their participation (the normalized delivery weights), and the wrappers
transform and recurse.  The weights are computed apart from the
aggregate and never feed it.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import warnings
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.filters import dense as D
from repro_torch.core.flat import (QUANT_DTYPES, FlatPlan, dequantize_rows,
                                   dtype_name)
from repro_torch.tree import tree_leaves, tree_unflatten

IMPLS = ("auto", "kernel", "gather", "fused")

_WARNED_ONCE: set = set()


def warn_once(key, message):
    """Warn exactly once per ``key`` across the process (a warning inside
    a training loop would otherwise fire every step)."""
    if key in _WARNED_ONCE:
        return
    _WARNED_ONCE.add(key)
    warnings.warn(message, UserWarning, stacklevel=3)


@functools.lru_cache(maxsize=None)
def mda_combos(n: int, f: int) -> np.ndarray:
    """All (n-f)-subsets of minimum-diameter averaging, enumerated once
    per (n, f)."""
    combos = np.asarray(list(itertools.combinations(range(n), n - f)))
    if len(combos) > 200_000:
        raise ValueError(f"MDA infeasible for n={n}, f={f}")
    return combos


@functools.lru_cache(maxsize=None)
def trim_count(n: int, f: int, beta: float | None) -> int:
    """Per-side trim count of the coordinate-wise trimmed mean."""
    b = int(math.ceil((beta if beta is not None else f / n) * n)) if n else 0
    return min(b, (n - 1) // 2)


# ---------------------------------------------------------------------------
# elastic membership: n as a bucketed range, f as a live-roster policy


@dataclass(frozen=True)
class ElasticN:
    """A bucketed range of live agent counts for elastic-n specs: a live
    roster of ``n_live`` agents is served by the smallest bucket >=
    n_live (live rows packed into the bucket's stack, surplus slots are
    ghost rows masked out).  Build via :func:`elastic`."""
    n_max: int
    buckets: Tuple[int, ...]

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("elastic: need at least one bucket")
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(
                f"elastic: buckets must be strictly ascending, got "
                f"{self.buckets}")
        if self.buckets[-1] != self.n_max or self.buckets[0] < 1:
            raise ValueError(
                f"elastic: buckets must lie in [1, n_max={self.n_max}] and "
                f"end at n_max, got {self.buckets}")

    def bucket_for(self, n_live: int) -> int:
        """Smallest bucket capacity serving ``n_live`` live agents."""
        if n_live > self.n_max:
            raise ValueError(
                f"n_live={n_live} exceeds the elastic n_max={self.n_max}")
        if n_live < 1:
            raise ValueError(f"n_live must be >= 1, got {n_live}")
        return next(b for b in self.buckets if b >= n_live)

    def pack(self, live):
        """``live``: ascending live agent slots (>= 1 entry) -> ``(bucket,
        idx, valid)``: ``idx`` (bucket,) int32, the live slots padded by
        REPEATING the first live slot, and ``valid`` (bucket,) bool
        marking the real ones."""
        live = np.asarray(live, np.int32)
        b = self.bucket_for(len(live))       # raises on an empty roster
        idx = np.concatenate([live, np.full(b - len(live), live[0],
                                            np.int32)])
        valid = np.arange(b) < len(live)
        return b, idx, valid


def elastic(n_max: int, buckets: int | Tuple[int, ...] = 3,
            n_min: int | None = None) -> ElasticN:
    """Elastic agent count for ``make_spec(..., n=elastic(n_max, ...))``:
    an explicit ascending tuple of capacities ending at ``n_max``, or a
    bucket COUNT spread evenly over [n_min (default ~n_max/2), n_max]."""
    if isinstance(buckets, int):
        lo = n_min if n_min is not None else max(1, (n_max + 1) // 2)
        if not 1 <= lo <= n_max:
            raise ValueError(f"n_min={lo} outside [1, n_max={n_max}]")
        k = max(1, int(buckets))
        if k == 1:
            return ElasticN(n_max=n_max, buckets=(n_max,))
        pts = np.unique(np.linspace(lo, n_max, k).round().astype(int))
        return ElasticN(n_max=n_max, buckets=tuple(int(b) for b in pts))
    return ElasticN(n_max=n_max, buckets=tuple(int(b) for b in buckets))


@dataclass(frozen=True)
class FracF:
    """A Byzantine-budget POLICY: ``f = max(min_f, floor(ratio * n))``,
    re-derived per elastic bucket.  Build via :func:`frac`."""
    ratio: float
    min_f: int = 0

    def __post_init__(self):
        if not 0.0 <= self.ratio < 1.0:
            raise ValueError(f"frac ratio must be in [0, 1), got "
                             f"{self.ratio}")

    def resolve(self, n: int) -> int:
        # the epsilon guards fp products landing just below an integer
        # (0.29 * 100 == 28.999999999999996)
        return max(self.min_f, int(np.floor(self.ratio * n + 1e-9)))


def frac(ratio: float, min_f: int = 0) -> FracF:
    """``f=frac(0.2)``: tolerate 20% of the LIVE roster per bucket."""
    return FracF(ratio=ratio, min_f=min_f)


def staleness_discount_table(s, weighting: str = "poly",
                             power: float = 1.0, gamma: float = 0.7):
    """Staleness rounds -> discount multipliers: ``none`` -> 1, ``poly``
    -> (1+s)^-power, ``exp`` -> gamma^s.  Plain operators, so it works
    on numpy float64 (host-side trace planning) and tensors alike."""
    if weighting == "none":
        return s * 0.0 + 1.0
    if weighting == "poly":
        return (1.0 + s) ** (-power)
    if weighting == "exp":
        return gamma ** s
    raise KeyError(weighting)


# ---------------------------------------------------------------------------
# capability flags + registry


@dataclass(frozen=True)
class AggregatorCaps:
    """What an aggregation rule can do — drives engine dispatch.  Later
    slices add the JAX package's other flags with the code that reads
    them."""
    coordwise: bool = False           # per-coordinate rule
    weight_decomposable: bool = False  # aggregate == sum_i w_i g_i exactly
    pairwise: bool = False            # statistics derivable from the Gram
    stateful: bool = False            # carries init_state/update_state
    staleness_aware: bool = False     # ``weights`` = raw staleness ROUNDS,
    #                                   not discount multipliers


@dataclass(frozen=True)
class AggregatorDef:
    """Registry record: capabilities + the callables the engine uses."""
    name: str
    caps: AggregatorCaps
    hyper_keys: frozenset          # allowed hyper-parameter names
    gather_keys: frozenset         # hyper forwarded to the dense gather fn
    impl_keys: frozenset           # impl-only keys (accepted, not stored)
    dense_fn: Optional[Callable] = None    # (stack, f, **hyper) -> (P,)
    weights_fn: Optional[Callable] = None  # (spec, stack, state) -> (n,)
    # masked-law override (stack, wn) -> (P,) fp32, wn = w / tot: rules
    # whose masked law is not impute-then-scale (mean's exact weighted
    # mean of the arrived rows)
    masked_fn: Optional[Callable] = None
    # a rule's own routes, taken before the engine's: (spec, stack, mask,
    # weights, state, qscale) -> (P,) fp32 for the arena, (spec, grads,
    # mask, weights, state) -> tree for a tree (sparse_mean's per-
    # coordinate weights fit neither engine law)
    flat_fn: Optional[Callable] = None
    custom_fn: Optional[Callable] = None
    # (spec, state, n_cols) -> extra dense_fn kwargs from the state
    # (zeno's server_grad), for the gather impl
    gather_state_fn: Optional[Callable] = None
    # the state protocol: keys that must arrive through ``state=``, never
    # as a hyper; (spec, proto) -> state and (spec, state, agg) -> state
    state_keys: frozenset = frozenset()
    init_state_fn: Optional[Callable] = None
    update_state_fn: Optional[Callable] = None
    is_wrapper: bool = False       # needs an inner spec (server_momentum)
    tags: tuple = ()               # e.g. ("compressed",)


REGISTRY: dict[str, AggregatorDef] = {}


def register_aggregator(name: str, *, caps: AggregatorCaps,
                        hyper: tuple = (), gather: tuple = (),
                        impl_keys: tuple = (), dense_fn=None,
                        weights_fn=None, masked_fn=None, flat_fn=None,
                        custom_fn=None,
                        gather_state=None, state_keys: tuple = (),
                        init_state=None, update_state=None,
                        is_wrapper: bool = False, tags: tuple = ()):
    """Register an aggregation rule (raises on a duplicate name)."""
    if name in REGISTRY:
        raise ValueError(f"aggregator {name!r} already registered")
    REGISTRY[name] = AggregatorDef(
        name=name, caps=caps, hyper_keys=frozenset(hyper),
        gather_keys=frozenset(gather), impl_keys=frozenset(impl_keys),
        dense_fn=dense_fn, weights_fn=weights_fn, masked_fn=masked_fn,
        flat_fn=flat_fn, custom_fn=custom_fn, gather_state_fn=gather_state,
        state_keys=frozenset(state_keys),
        init_state_fn=init_state, update_state_fn=update_state,
        is_wrapper=is_wrapper, tags=tuple(tags))
    return REGISTRY[name]


def get_aggregator_def(name: str) -> AggregatorDef:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None


def list_aggregators(tag: str | None = None) -> list[str]:
    return sorted(n for n, d in REGISTRY.items()
                  if tag is None or tag in d.tags)


# ---------------------------------------------------------------------------
# the spec


@dataclass(frozen=True)
class AggregatorSpec:
    """Typed handle to a registered aggregation rule.  Build with
    :func:`make_spec`."""
    name: str
    f: int = 0
    hyper: tuple = ()                 # sorted ((key, value), ...)
    impl: str = "gather"              # kernel | gather
    inner: Optional["AggregatorSpec"] = None   # a wrapper's inner spec
    n: Optional[int] = None           # static agent count (n_max if elastic)
    # elastic-n: the bucketed live-count range this spec was built for;
    # ``respecialize(n_live)`` selects the per-bucket concrete spec
    elastic: Optional[ElasticN] = None
    f_policy: Optional[FracF] = None  # f re-derived per bucket when set

    @property
    def caps(self) -> AggregatorCaps:
        return get_aggregator_def(self.name).caps

    @property
    def stateful(self) -> bool:
        """True iff this rule, or any rule of its wrapper chain, carries
        state."""
        return self.caps.stateful or (self.inner is not None
                                      and self.inner.stateful)

    @property
    def staleness_aware(self) -> bool:
        """True iff this rule, or any rule of its wrapper chain, reads
        ``weights`` as raw staleness round counts."""
        return self.caps.staleness_aware or (self.inner is not None
                                             and self.inner.staleness_aware)

    @property
    def elastic_n(self) -> Optional[ElasticN]:
        """The ElasticN governing this spec: its own, or its wrapper
        chain's (a wrapper delegates elasticity to its inner rule)."""
        if self.elastic is not None:
            return self.elastic
        return self.inner.elastic_n if self.inner is not None else None

    def hp(self, key: str, default=None):
        return dict(self.hyper).get(key, default)

    def describe(self) -> str:
        h = ", ".join(f"{k}={v}" for k, v in self.hyper)
        el = (f", elastic[{'/'.join(map(str, self.elastic.buckets))}]"
              if self.elastic else "")
        inner = f" -> {self.inner.describe()}" if self.inner else ""
        return f"{self.name}(f={self.f}{', ' + h if h else ''}{el})" + inner

    def init_state(self, proto):
        """The initial state for a single-agent prototype (a parameter
        tree, or a (P,) vector): ``{}`` for a stateless rule, an inner
        rule's state nested under ``"inner"``."""
        d = get_aggregator_def(self.name)
        state = d.init_state_fn(self, proto) if d.init_state_fn else {}
        if self.inner is not None and self.inner.stateful:
            state = {**state, "inner": self.inner.init_state(proto)}
        return state

    def update_state(self, state, agg):
        """The state after a step whose aggregate was ``agg`` (the
        unraveled tree, or its (P,) ravel): the inner rule's state first,
        from the same aggregate, then this rule's."""
        d = get_aggregator_def(self.name)
        inner_state = None
        if self.inner is not None and self.inner.stateful:
            inner_state = self.inner.update_state(state["inner"], agg)
        new = (d.update_state_fn(self, state, agg) if d.update_state_fn
               else dict(state))
        if inner_state is not None:
            new = {**new, "inner": inner_state}
        return new

    def respecialize(self, n_live: int) -> "AggregatorSpec":
        """The concrete spec serving a live roster of ``n_live`` agents:
        for an elastic spec the smallest bucket >= n_live, equal to a
        fresh ``make_spec(name, f=f_b, impl=..., n=b, **hyper)`` and the
        SAME object on every call for that bucket (prebuilt at
        ``make_spec`` time).  A static spec returns itself when n matches
        (or was never pinned) and raises otherwise."""
        return _respecialize(self, n_live)

    @property
    def flat_capable(self) -> bool:
        """True iff :meth:`aggregate_flat` can take a pre-raveled arena:
        a rule with its own flat law (``flat_fn``), and every other
        registered rule on the kernel and gather impls."""
        if get_aggregator_def(self.name).flat_fn is not None:
            return True
        return self.impl in ("kernel", "gather")

    def aggregate(self, grads, mask=None, weights=None, state=None):
        """Aggregate per-agent gradients (leading axis = agent): a tree of
        (n, ...) leaves or an (n, P) stack.  Returns the same structure
        without the agent axis (leaf dtypes restored for a tree).

        ``mask`` (n,) bool — rows that arrived (None = all); ``weights``
        (n,) float — per-agent multipliers (staleness discounts), zeroed
        where ``mask`` is False."""
        if isinstance(grads, torch.Tensor):
            return self.aggregate_flat(grads, mask, weights, state)
        self._check_state(state)
        d = get_aggregator_def(self.name)
        if d.custom_fn is not None:
            return d.custom_fn(self, grads, mask, weights, state)
        plan = FlatPlan.for_tree(grads)
        if mask is None and weights is None:
            vec = self.aggregate_flat(plan.ravel(grads, torch.float32),
                                      state=state)
            return plan.unravel(vec)
        if plan.uniform_dtype is not None or self.stateful:
            # ravel in the leaves' own dtype: the engine's double rounding
            # through the arena dtype is then the tree engine's per-leaf
            # rounding (bit-for-bit with the JAX masked tree path).  A
            # stateful rule's own law is fp32 per coordinate, so a mixed
            # tree takes its fp32 ravel
            return plan.unravel(self.aggregate_flat(
                plan.ravel(grads), mask, weights, state))
        if mask is None:
            mask = torch.ones((_tree_rows(grads),), dtype=torch.bool,
                              device=tree_leaves(grads)[0].device)
        return _masked_mixed_tree(self, d, grads, plan, mask, weights)

    def _check_state(self, state):
        if self.stateful and state is None:
            raise ValueError(
                f"{self.describe()} is stateful: pass "
                "state=spec.init_state(proto) (called on THIS spec — for "
                "composed specs it nests the inner state correctly)")

    def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                       scale=None):
        """Aggregate a pre-raveled (n, P) arena (fp32 or bf16) -> (P,)
        fp32.  The kernel impl reads the arena in its own dtype; the
        gather impl takes an fp32 view or copy, as the JAX engine does.
        With ``mask``/``weights`` the masked law of the rule applies (see
        the module docstring).

        ``scale``: the (n,) fp32 row scales of a QUANTIZED arena
        (``stack`` then holds the int8 / float8_e4m3fn codes of
        :func:`repro_torch.core.flat.quantize_rows`; row i decodes as
        ``stack[i].float() * scale[i]``).  The rule runs on the decoded
        rows: inside the kernels for the rules of the scaled kernel table,
        on an engine-level dequantized copy otherwise."""
        if scale is not None and dtype_name(stack.dtype) not in QUANT_DTYPES:
            raise ValueError(
                f"scale= goes with a quantized arena "
                f"({' or '.join(sorted(QUANT_DTYPES))} codes), got "
                f"{stack.dtype}")
        self._check_state(state)
        if self.n is not None and stack.shape[0] != self.n:
            raise ValueError(f"{self.describe()} was built for n={self.n}, "
                             f"got a stack of {stack.shape[0]} rows")
        d = get_aggregator_def(self.name)
        if d.flat_fn is not None:
            return d.flat_fn(self, stack, mask, weights, state, scale)
        if mask is None and weights is None:
            return _flat_sync_vec(self, d, stack, scale, state)
        if mask is None:
            mask = torch.ones((stack.shape[0],), dtype=torch.bool,
                              device=stack.device)
        return _flat_masked_vec(self, d, stack, mask, weights, scale, state)

    # -- aggregation telemetry (repro_torch.obs) --------------------------
    def weights(self, grads, state=None):
        """Per-agent weights w with aggregate(g) == sum_i w_i g_i, only for
        the weight-decomposable rules (their dense law, whatever the
        impl).  ``grads``: an (n, P) stack or a tree."""
        d = get_aggregator_def(self.name)
        if not d.caps.weight_decomposable:
            raise ValueError(f"{self.name} is not weight-decomposable")
        if d.caps.stateful and state is None:
            raise ValueError(
                f"{self.name} is stateful: pass state=spec.init_state(...)")
        return d.weights_fn(self, _as_stack(grads), state)

    def selection_weights(self, grads, mask=None, weights=None, state=None):
        """(n,) fp32 per-agent selection / application weights, the
        telemetry signal of the detection-based defenses (see the module
        docstring for each rule class).  ``grads``: an (n, P) stack (the
        loops pass the fp32 arena, the pre-quantization one under a
        quantized exchange) or a tree; ``mask`` / ``weights`` as for
        :meth:`aggregate_flat`.  Computed apart from the aggregate: it
        re-runs the rule's selection and never feeds the aggregate."""
        self._check_state(state)
        return _selection_weights(self, get_aggregator_def(self.name),
                                  _as_stack(grads), mask, weights, state)

    def aggregate_with_telemetry(self, grads, mask=None, weights=None,
                                 state=None):
        """:meth:`aggregate` plus the telemetry struct ``{"sel_w": (n,)
        fp32, "mask": (n,) bool, "contrib_w": (n,) fp32}``; the aggregate
        is the same call's, bit for bit."""
        agg = self.aggregate(grads, mask=mask, weights=weights, state=state)
        return agg, self._telemetry(grads, mask, weights, state)

    def aggregate_flat_with_telemetry(self, stack, mask=None, weights=None,
                                      state=None, scale=None):
        """:meth:`aggregate_flat` plus the telemetry struct (see
        :meth:`aggregate_with_telemetry`); a quantized arena's weights are
        those of its decoded rows."""
        vec = self.aggregate_flat(stack, mask=mask, weights=weights,
                                  state=state, scale=scale)
        rows = stack if scale is None else dequantize_rows(stack, scale)
        return vec, self._telemetry(rows, mask, weights, state)

    def _telemetry(self, grads, mask, weights, state):
        stack = _as_stack(grads)
        n = stack.shape[0]
        m = (torch.ones((n,), dtype=torch.bool, device=stack.device)
             if mask is None else mask.to(torch.bool))
        cw = m.float() if weights is None else weights.float() * m.float()
        sel = self.selection_weights(stack, mask=mask, weights=weights,
                                     state=state)
        return {"sel_w": sel.float(), "mask": m, "contrib_w": cw}


@functools.lru_cache(maxsize=None)
def _respecialize(spec: AggregatorSpec, n_live: int) -> AggregatorSpec:
    """Cached: repeat calls for the same (spec, n_live) return the SAME
    object."""
    if spec.elastic is None:
        if spec.inner is not None and spec.inner.elastic_n is not None:
            # a wrapper keyed on its RESOLVED inner spec: every n_live of
            # one bucket gives the same wrapper object
            return _with_inner(spec, _respecialize(spec.inner, n_live))
        if spec.n is None or spec.n == n_live:
            return spec
        raise ValueError(
            f"{spec.describe()} was built for static n={spec.n}, not "
            f"n_live={n_live} — build it with n=elastic(...) to allow "
            "membership changes")
    return _bucket_spec(spec, spec.elastic.bucket_for(n_live))


@functools.lru_cache(maxsize=None)
def _bucket_spec(spec: AggregatorSpec, b: int) -> AggregatorSpec:
    """The concrete per-bucket spec of an elastic spec (cached)."""
    f_b = spec.f_policy.resolve(b) if spec.f_policy is not None else spec.f
    inner = spec.inner
    if inner is not None and inner.elastic_n is not None:
        inner = inner.respecialize(b)
    out = dataclasses.replace(spec, n=b, f=f_b, elastic=None, f_policy=None,
                              inner=inner)
    _warm_plan(out, b)
    return out


@functools.lru_cache(maxsize=None)
def _with_inner(spec: AggregatorSpec, inner: AggregatorSpec):
    return dataclasses.replace(spec, inner=inner)


def _warm_plan(spec: AggregatorSpec, n: int):
    """Precompute per-(n, f) static work at spec-build time."""
    if spec.name == "mda":
        mda_combos(n, spec.f)
    if spec.name == "trimmed_mean":
        trim_count(n, spec.f, spec.hp("beta"))
    if spec.inner is not None:
        _warm_plan(spec.inner, n)


# ---------------------------------------------------------------------------
# engine


def _scaled_kernel(spec) -> bool:
    """True iff ``spec`` dequantizes a quantized arena inside its kernels."""
    if spec.impl != "kernel":
        return False
    from repro_torch.kernels import kernel_scaled_supported
    return kernel_scaled_supported(spec.name)


def _flat_dequant(spec, stack, qscale):
    """The engine-level dequantization of the rules without a scaled
    kernel: the (n, P) fp32 copy, with a one-time notice on the kernel
    impl (the JAX engine pays the same copy for these rules)."""
    from repro_torch.core.flat import dequantize_rows
    if spec.impl == "kernel":
        warn_once(
            ("flat-scaled-dequant", spec.name),
            f"{spec.name}: no scaled (quantized-arena) kernel — "
            "dequantizing the (n, P) arena at engine level before "
            "aggregation.  Only the kernelized coordinate rules "
            "(coordinate_median, trimmed_mean, sign_sgd, sparse_mean) "
            "dequantize inside the kernel.")
    return dequantize_rows(stack, qscale)


def _flat_sync_vec(spec, d, stack, qscale=None, state=None):
    """(n, P) arena -> (P,) fp32, synchronous.  ``qscale``: the row scales
    of a quantized arena; ``state``: a stateful rule's, read by its
    ``gather_state_fn``."""
    if qscale is not None:
        if _scaled_kernel(spec):
            from repro_torch.kernels import kernel_scaled_aggregate
            return kernel_scaled_aggregate(spec.name, stack, qscale, spec.f,
                                           spec.hyper)
        stack = _flat_dequant(spec, stack, qscale)
    if spec.impl == "kernel":
        from repro_torch.kernels import kernel_aggregate
        return kernel_aggregate(spec.name, stack, spec.f, spec.hyper)
    if spec.impl == "gather":
        hyper = {k: v for k, v in spec.hyper if k in d.gather_keys}
        if d.gather_state_fn is not None:
            hyper.update(d.gather_state_fn(spec, state, stack.shape[1]))
        return d.dense_fn(stack.float(), spec.f, **hyper)
    raise NotImplementedError(_FUSED_MSG)


def _masked_prelude(mask, weights):
    """(mask bool, w = weights * mask fp32, cnt >= 1, tot >= 1e-30), all
    on the mask's device (no host sync)."""
    mask = mask.to(torch.bool)
    mf = mask.float()
    w = mf if weights is None else weights.float() * mf
    cnt = torch.clamp_min(torch.sum(mf), 1.0)
    tot = torch.clamp_min(torch.sum(w), 1e-30)
    return mask, w, cnt, tot


# the coordinate-wise rules whose masked law is the order statistic over
# the ARRIVED rows only (absent rows are +inf sort sentinels).  Imputing
# them at the delivered mean is not robust: the mean is attack-
# contaminated, so ghost rows land inside the trim window.  sign_sgd's
# vote counts the arrived rows only; phocas and mean_around_median take
# the arrived-window center, then the cnt - f arrived values closest to
# it (ref.arrived_mean_closest_ref).
_ARRIVED_STAT_RULES = ("coordinate_median", "trimmed_mean", "sign_sgd",
                       "phocas", "mean_around_median")


def _arrived_coord_vec(spec, xf, mask):
    """(n, P) fp32 -> (P,) fp32: the statistic over the arrived rows
    (the gather oracles :func:`repro_torch.kernels.ref.masked_stat_ref`,
    :func:`~repro_torch.kernels.ref.masked_sign_vote_ref` and
    :func:`~repro_torch.kernels.ref.arrived_mean_closest_ref`)."""
    from repro_torch.kernels import ref
    if spec.name == "sign_sgd":
        return ref.masked_sign_vote_ref(xf, mask)
    if spec.name == "coordinate_median":
        return ref.masked_stat_ref(xf, mask, None, "median")
    if spec.name == "phocas":
        return ref.arrived_mean_closest_ref(xf, mask, "trimmed_mean",
                                            spec.f)
    if spec.name == "mean_around_median":
        return ref.arrived_mean_closest_ref(xf, mask, "median", spec.f)
    b = trim_count(xf.shape[0], spec.f, spec.hp("beta"))
    return ref.masked_stat_ref(xf, mask, None, "trimmed_mean", b=b)


def _flat_masked_vec(spec, d, stack, mask, weights, qscale=None,
                     state=None):
    """Masked/weighted flat path: the arrived-window law for the
    coordinate-wise rules, the impute-at-delivered-mean law for krum,
    each scaled by tot/cnt (an explicit 0 when no weight was delivered);
    mean's exact weighted mean.  ``impl="kernel"`` fuses the law into the
    masked kernels: no masked (n, P) copy is made, and the mask, the
    weights and the counts stay on the device.  ``qscale``: the row
    scales of a quantized arena (the law runs on the dequantized rows)."""
    mask, w, cnt, tot = _masked_prelude(mask, weights)
    # a quantized arena's aggregate is fp32: no round trip through the
    # codes' dtype
    out_dtype = torch.float32 if qscale is not None else stack.dtype
    if qscale is not None and not _scaled_kernel(spec):
        stack, qscale = _flat_dequant(spec, stack, qscale), None
    if d.masked_fn is not None:
        return d.masked_fn(stack, w / tot)
    # the zero-total guard: tot == sum(w) whenever sum(w) > 0
    scale = torch.where(torch.sum(w) > 0, tot / cnt,
                        torch.zeros((), device=w.device))

    def scaled(vec):
        # the tree engine rounds the aggregate to the leaf dtype before
        # it scales; the round trip through the arena dtype keeps bf16
        # arenas bit-for-bit with it (a no-op for fp32)
        return vec.to(out_dtype).float() * scale

    if qscale is not None:
        from repro_torch.kernels import kernel_scaled_masked_aggregate
        return scaled(kernel_scaled_masked_aggregate(
            spec.name, stack, qscale, mask.float(), w / tot, spec.f,
            spec.hyper))
    if spec.impl == "kernel":
        from repro_torch.kernels import kernel_masked_aggregate
        return scaled(kernel_masked_aggregate(
            spec.name, stack, mask.float(), w / tot, spec.f, spec.hyper))
    if spec.impl != "gather":
        raise NotImplementedError(_FUSED_MSG)
    if d.caps.coordwise and spec.name in _ARRIVED_STAT_RULES:
        return scaled(_arrived_coord_vec(spec, stack.float(), mask))
    from repro_torch.kernels import ref
    imputed = ref.masked_impute_ref(stack, mask, w / tot)
    return scaled(_flat_sync_vec(spec, d, imputed, state=state))


def _tree_rows(grads) -> int:
    """The agent count of a tree of (n, ...) leaves."""
    return tree_leaves(grads)[0].shape[0]


def _masked_mixed_tree(spec, d, grads, plan, mask, weights):
    """The masked law on a tree of mixed leaf dtypes (the JAX tree
    engine's, ``repro/core/aggregators.py:1133-1210``), leaf slices in plan
    order.  A coordinate-wise rule with a masked kernel launches it once
    per uniform-dtype segment (columns are independent, so each segment
    is the uniform path); its gather impl runs the arrived-window law per
    leaf.  mean takes its exact weighted mean per leaf.  The rest (krum
    and the selection family) impute each leaf at the delivered mean in
    the leaf's dtype and aggregate the fp32 ravel of the imputed tree,
    with a one-time warning on the kernel impl (the Gram couples every
    column, so no kernel takes a mixed row).  Each aggregate leaf is
    rounded to its dtype, scaled by tot/cnt and rounded again, as the
    uniform path rounds it."""
    leaves = tree_leaves(grads)
    n = leaves[0].shape[0]
    if spec.n is not None and n != spec.n:
        raise ValueError(f"{spec.describe()} was built for n={spec.n}, got "
                         f"a tree of {n} rows")
    mask, w, cnt, tot = _masked_prelude(mask, weights)
    wn = w / tot
    scale = torch.where(torch.sum(w) > 0, tot / cnt,
                        torch.zeros((), device=w.device))

    def scaled(vec, dt):
        return (vec.to(dt).float() * scale).to(dt)

    cols = [l.reshape(n, -1) for l in leaves]
    if d.masked_fn is not None:
        outs = [d.masked_fn(c, wn).to(c.dtype) for c in cols]
    elif spec.impl == "kernel" and d.caps.coordwise:
        from repro_torch.kernels import kernel_masked_aggregate
        outs = _per_dtype(cols, lambda seg: kernel_masked_aggregate(
            spec.name, seg, mask.float(), wn, spec.f, spec.hyper), scaled)
    elif d.caps.coordwise and spec.name in _ARRIVED_STAT_RULES:
        outs = [scaled(_arrived_coord_vec(spec, c.float(), mask), c.dtype)
                for c in cols]
    else:
        if spec.impl == "kernel":
            dts = tuple(sorted({dtype_name(c.dtype) for c in cols}))
            warn_once(
                ("masked-pallas-mixed-dtype", spec.name, dts),
                f"{spec.name}: masked kernel skipped — gradient leaves "
                f"carry mixed dtypes {dts}; falling back to the tree-level "
                "imputed path (materializes the imputed (n, d) stack).  "
                "Cast the leaves to one exchange dtype to restore the "
                "fused kernel.")
        from repro_torch.kernels import ref
        vec = _flat_sync_vec(spec, d, torch.cat(
            [ref.masked_impute_ref(c, mask, wn).float() for c in cols],
            dim=1))
        outs = [scaled(vec[o:o + c.shape[1]], c.dtype)
                for o, c in zip(plan.offsets, cols)]
    return tree_unflatten(plan.paths, [o.reshape(shp) for o, shp in
                                       zip(outs, plan.shapes)])


def _per_dtype(cols, aggregate, finish):
    """The (n, size) leaf columns aggregated one uniform-dtype segment at a
    time: ``aggregate`` once per dtype on that dtype's columns side by
    side, each leaf's slice of the result through ``finish(vec, dtype)``.
    Exact for a per-coordinate law: no column meets another."""
    by_dtype: dict = {}
    for i, c in enumerate(cols):
        by_dtype.setdefault(c.dtype, []).append(i)
    outs = [None] * len(cols)
    for dt, idxs in by_dtype.items():
        vec = aggregate(torch.cat([cols[i] for i in idxs], dim=1))
        off = 0
        for i in idxs:
            outs[i] = finish(vec[off:off + cols[i].shape[1]], dt)
            off += cols[i].shape[1]
    return outs


# ---------------------------------------------------------------------------
# engine: selection-weight telemetry (repro_torch.obs): one (n,) read-out
# per rule class, mirroring the aggregate laws above.  The aggregate is
# never computed through this path, so telemetry cannot perturb it.


def _as_stack(grads):
    """The (n, P) stack of ``grads``: itself, or a tree's ravel (in its
    uniform leaf dtype, else fp32)."""
    if isinstance(grads, torch.Tensor):
        return grads
    return FlatPlan.for_tree(grads).ravel(grads)


def _participation(n, mask, weights, device):
    """The normalized delivery weights: the read-out of the rules without
    a per-row application decomposition (every arrived row enters a
    coordinate-wise or iterative rule's statistics)."""
    if mask is None and weights is None:
        return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=device)
    _, w, _, tot = _masked_prelude(mask, weights)
    return w / tot


def _bulyan_theta_select(d2, n, f, theta):
    """Bulyan's Krum-based selection stage on the distances ``d2``: the
    (n,) bool mask of its theta picks (the dense law's own, shared with
    :func:`repro_torch.core.filters.dense.bulyan`)."""
    rows = torch.arange(n, device=d2.device)
    sel = torch.zeros((n,), dtype=torch.bool, device=d2.device)
    for i in D.iterated_krum_picks(d2, f, theta):
        sel = sel | (rows == i)
    return sel


def _selection_weights(spec, d, stack, mask, weights, state):
    name = spec.name
    n = stack.shape[0]
    if d.is_wrapper:
        # the row transform of the wrapper's flat law, then the inner
        # rule's selection
        inner_state = _inner_state(spec, state)
        if name == "clipped":
            xf = stack.float()
            scale = _clip_scale(torch.sum(torch.square(xf), dim=1),
                                spec.hp("tau", 1.0))
            return spec.inner.selection_weights(
                (xf * scale[:, None]).to(stack.dtype), mask, weights,
                inner_state)
        if name == "staleness_discounted":
            return spec.inner.selection_weights(
                stack, mask, _staleness_w(spec, weights, n, stack.device),
                inner_state)
        if name == "server_momentum":
            # the momentum mixes the output; the rows enter as they are
            return spec.inner.selection_weights(stack, mask, weights,
                                                inner_state)
        # bucketed: rows enter through their group means
        return _participation(n, mask, weights, stack.device)
    if name == "zeno_pp":
        return zeno_pp_weights(spec, stack.float(), mask, weights, state)
    if name == "centered_clip":
        # the clip weights of the final iterate, normalized: a row the
        # carried center distrusts reports a smaller share
        lam = cclip_weights(spec, stack, mask, weights, state)
        tot = torch.sum(lam)
        return torch.where(tot > 0, lam / torch.clamp_min(tot, 1e-30), lam)
    # bulyan reports its theta picks (its krum base only: a generic base
    # reports participation)
    law = d.weights_fn
    if name == "bulyan":
        law = _w_bulyan if spec.hp("base", "krum") == "krum" else None
    if law is None:
        return _participation(n, mask, weights, stack.device)
    if mask is None and weights is None:
        if spec.impl == "kernel":
            from repro_torch.kernels import kernel_selection_weights
            return kernel_selection_weights(name, stack, spec.f,
                                            dict(spec.hyper))
        return law(spec, stack, state)
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=stack.device)
    m, w, _, tot = _masked_prelude(mask, weights)
    if name == "mean":
        # exact: the masked mean applies w / tot directly
        return w / tot
    # the masked law: the rule's weights over the mean-imputed stack (the
    # aggregate also scales by tot / cnt, a global factor)
    if spec.impl == "kernel":
        from repro_torch.kernels import kernel_selection_weights
        return kernel_selection_weights(name, stack, spec.f,
                                        dict(spec.hyper), mask=m.float(),
                                        wn=w / tot)
    from repro_torch.kernels import ref
    return law(spec, ref.masked_impute_ref(stack, m, w / tot), state)


# the dense weight laws: (spec, (n, P) stack, state) -> (n,) fp32, each
# the selection of its rule's dense law in :mod:`.filters.dense`


def _picked(n, idx, value, device):
    """(n,) fp32: ``value`` on the rows ``idx``, 0 elsewhere."""
    return torch.zeros((n,), dtype=torch.float32,
                       device=device).index_fill(0, idx.reshape(-1), value)


def _w_mean(spec, g, state):
    n = g.shape[0]
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)


def _w_cge(spec, g, state):
    n, f = g.shape[0], spec.f
    keep = D._ascending(torch.linalg.vector_norm(g.float(), dim=-1), n - f)
    return _picked(n, keep, 1.0 / (n - f) if spec.hp("normalize", True)
                   else 1.0, g.device)


def _w_cgc(spec, g, state):
    n, f = g.shape[0], spec.f
    norms = torch.linalg.vector_norm(g.float(), dim=-1)
    tau = torch.sort(norms).values[n - f - 1]
    w = torch.clamp_max(tau / torch.clamp_min(norms, 1e-30), 1.0)
    return w / n if spec.hp("normalize", True) else w


def _w_zeno(spec, g, state):
    n, f = g.shape[0], spec.f
    gf = g.float()
    v = _server_grad(state, g.shape[1])
    score = (spec.hp("lr", 1.0) * (gf @ v)
             - spec.hp("rho", 1e-3) * torch.sum(torch.square(gf), dim=-1))
    return _picked(n, D._top_k_order(score, n - f), 1.0 / (n - f),
                   g.device)


def _w_krum(spec, g, state):
    s = D.krum_scores(D.pairwise_sq_dists(g.float()), spec.f)
    return _picked(g.shape[0], torch.argmin(s), 1.0, g.device)


def _w_multi_krum(spec, g, state):
    m = spec.hp("m", 2)
    s = D.krum_scores(D.pairwise_sq_dists(g.float()), spec.f)
    return _picked(g.shape[0], D._ascending(s, m), 1.0 / m, g.device)


def _w_m_krum(spec, g, state):
    m = spec.hp("m", 2)
    picks = D.iterated_krum_picks(D.pairwise_sq_dists(g.float()), spec.f, m)
    return _picked(g.shape[0], torch.stack(picks), 1.0 / m, g.device)


def _w_mda(spec, g, state):
    n, f = g.shape[0], spec.f
    best = D.mda_subset(D.pairwise_sq_dists(g.float()), f)
    return _picked(n, best, 1.0 / (n - f), g.device)


def _w_bulyan(spec, g, state):
    """1/theta on Bulyan's theta picks (its krum base; telemetry only:
    the coordinate stage makes the aggregate no weighted sum)."""
    n, f = g.shape[0], spec.f
    theta = n - 2 * f
    sel = _bulyan_theta_select(D.pairwise_sq_dists(g.float()), n, f, theta)
    return sel.float() / theta


_FUSED_MSG = ("impl='fused' (the leaf-wise, sharding-aware impl) is not "
              "ported yet: ROADMAP.md slice 11")


def kernel_available(name: str) -> bool:
    """True iff ``name`` has a kernel path AND its caps declare the
    matching structure (coordinate-wise or Gram-derivable)."""
    d = get_aggregator_def(name)
    if d.is_wrapper or not (d.caps.coordwise or d.caps.pairwise):
        return False
    from repro_torch.kernels import kernel_supported
    return kernel_supported(name)


def _kernel_supports_hyper(name: str, hyper: dict | None) -> bool:
    """Hyper-level kernel gate: bulyan's kernels implement only the
    classic krum base (a generic base runs an arbitrary inner filter per
    selection round, which is not Gram-derivable)."""
    if name == "bulyan":
        return (hyper or {}).get("base", "krum") == "krum"
    return True


def _resolve_impl(name: str, impl: str, hyper: dict | None = None) -> str:
    """``auto`` -> ``kernel`` where a kernel exists and the hyper selects
    a kernelized variant, else ``gather``; ``kernel`` on a rule without
    one raises here, at build time."""
    if impl == "pallas":
        raise ValueError("impl='pallas' is the JAX package's name; the "
                         "port calls it impl='kernel'")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {'|'.join(IMPLS)}, got "
                         f"{impl!r}")
    if impl == "fused":
        raise NotImplementedError(_FUSED_MSG)
    supported = kernel_available(name) and _kernel_supports_hyper(name,
                                                                 hyper)
    if impl == "auto":
        return "kernel" if supported else "gather"
    if impl == "kernel" and not supported:
        from repro_torch.kernels.dispatch import FLAT_SELF_KERNELED
        if name in FLAT_SELF_KERNELED:
            # the rule's flat_fn launches its own kernel stages
            # (centered_clip's K22); ``auto`` does not select it, since
            # the kernel's sum association differs from the dense body
            return impl
        reason = ("its hyper-parameters select a non-kernelized variant"
                  if kernel_available(name) else
                  "no kernel is registered for it")
        raise ValueError(f"{name}: impl='kernel' requested but {reason} "
                         "(repro_torch.kernels.dispatch.KERNEL_RULES)")
    return impl


def make_spec(name: str, f: "int | FracF" = 0, impl: str = "auto",
              inner: AggregatorSpec | None = None,
              n: "int | ElasticN | None" = None, **hyper) -> AggregatorSpec:
    """Build a validated :class:`AggregatorSpec` (unknown hyper keys,
    state keys passed as hypers and unsupported impls raise here; a
    wrapper needs ``inner=``, any other rule takes none).

    ``n=elastic(n_max, buckets=...)`` builds an ELASTIC spec: every
    bucket's concrete spec is prebuilt here and
    :meth:`AggregatorSpec.respecialize` selects it.  ``f`` may then be a
    :func:`frac` policy, re-derived per bucket (a plain int f is carried
    unchanged)."""
    d = get_aggregator_def(name)
    el = n if isinstance(n, ElasticN) else None
    n_int = el.n_max if el is not None else n
    f_policy = f if isinstance(f, FracF) else None
    if f_policy is not None:
        if n_int is None:
            raise ValueError(
                f"{name}: f=frac(...) needs n= to resolve the budget — "
                "pass n=<int> or n=elastic(...)")
        f = f_policy.resolve(n_int)
        if el is None:
            f_policy = None           # static n: nothing to re-derive
    if not isinstance(f, int) or f < 0:
        raise ValueError(f"f must be an int >= 0 or frac(...), got {f!r}")
    if n_int is not None and not isinstance(n_int, int):
        raise ValueError(f"n must be an int or elastic(...), got {n!r}")
    if d.is_wrapper and inner is None:
        raise ValueError(f"{name} is a composition wrapper: pass inner=")
    if not d.is_wrapper and inner is not None:
        raise ValueError(f"{name} takes no inner spec")
    plain = {}
    for k, v in hyper.items():
        if k in d.state_keys:
            raise ValueError(
                f"{name}: {k!r} is aggregator STATE, not a hyper-parameter "
                f"— pass it via state= (see AggregatorSpec.init_state)")
        if k in d.hyper_keys:
            plain[k] = v
        elif k not in d.impl_keys:
            raise ValueError(
                f"{name}: unknown hyper-parameter {k!r} "
                f"(allowed: {sorted(d.hyper_keys | d.impl_keys)})")
    spec = AggregatorSpec(name=name, f=f, hyper=tuple(sorted(plain.items())),
                          impl=_resolve_impl(name, impl, plain), inner=inner,
                          n=n_int, elastic=el, f_policy=f_policy)
    if el is not None:
        for b in el.buckets:          # prebuild every bucket's spec NOW
            _bucket_spec(spec, b)
    elif n_int is not None:
        _warm_plan(spec, n_int)
    return spec


def _mean_masked(stack, wn):
    """Exact weighted mean of the arrived rows (no imputation, no scale):
    ``wn`` is w / tot, zero on absent rows; summed as the fused
    multiply-add chain of the jitted JAX step."""
    from repro_torch.kernels import ref
    return ref.fma_weighted_sum(wn, stack)


# ---------------------------------------------------------------------------
# registrations

register_aggregator(
    "mean",
    caps=AggregatorCaps(weight_decomposable=True),
    dense_fn=D.mean, weights_fn=_w_mean, masked_fn=_mean_masked)
register_aggregator(
    "krum",
    caps=AggregatorCaps(weight_decomposable=True, pairwise=True),
    dense_fn=D.krum, weights_fn=_w_krum)
register_aggregator(
    "multi_krum",
    caps=AggregatorCaps(weight_decomposable=True, pairwise=True),
    hyper=("m",), gather=("m",), dense_fn=D.multi_krum,
    weights_fn=_w_multi_krum)
register_aggregator(
    "m_krum",
    caps=AggregatorCaps(weight_decomposable=True, pairwise=True),
    hyper=("m",), gather=("m",), dense_fn=D.m_krum, weights_fn=_w_m_krum)
register_aggregator(
    "mda",
    caps=AggregatorCaps(weight_decomposable=True, pairwise=True),
    dense_fn=D.mda, weights_fn=_w_mda)
register_aggregator(
    "cge",
    caps=AggregatorCaps(weight_decomposable=True, pairwise=True),
    hyper=("normalize",), gather=("normalize",), dense_fn=D.cge,
    weights_fn=_w_cge)
register_aggregator(
    "bulyan",
    caps=AggregatorCaps(pairwise=True),
    hyper=("base",), gather=("base",), dense_fn=D.bulyan)
register_aggregator(
    "coordinate_median",
    caps=AggregatorCaps(coordwise=True),
    impl_keys=("native_dtype",), dense_fn=D.coordinate_median)
register_aggregator(
    "trimmed_mean",
    caps=AggregatorCaps(coordwise=True),
    hyper=("beta",), gather=("beta",), impl_keys=("native_dtype",),
    dense_fn=D.trimmed_mean)
register_aggregator(
    "sign_sgd",
    caps=AggregatorCaps(coordwise=True),
    impl_keys=("native_dtype",), dense_fn=D.sign_sgd)
# the rules without a kernel in either package: their dense laws
register_aggregator(
    "phocas",
    caps=AggregatorCaps(coordwise=True),
    impl_keys=("native_dtype",), dense_fn=D.phocas)
register_aggregator(
    "mean_around_median",
    caps=AggregatorCaps(coordwise=True),
    impl_keys=("native_dtype",), dense_fn=D.mean_around_median)
register_aggregator(
    "cgc",
    caps=AggregatorCaps(weight_decomposable=True),
    hyper=("normalize",), gather=("normalize",), dense_fn=D.cgc,
    weights_fn=_w_cgc)
register_aggregator(
    "geometric_median",
    caps=AggregatorCaps(),
    # "nu" is accepted as the legacy eps alias; as in the JAX gather impl
    # only iters and eps reach the dense law (the JAX fused impl, which
    # reads nu, is ROADMAP.md slice 11)
    hyper=("iters", "eps", "nu"), gather=("iters", "eps"),
    dense_fn=D.geometric_median)
register_aggregator(
    "rfa",
    caps=AggregatorCaps(),
    hyper=("iters", "nu", "eps"), gather=("iters", "nu"), dense_fn=D.rfa)
register_aggregator(
    "median_of_means",
    caps=AggregatorCaps(),
    hyper=("num_groups",), gather=("num_groups",),
    dense_fn=D.median_of_means)


# ---------------------------------------------------------------------------
# the compressed exchange's sparse / dropout-aware mean: a zero coordinate
# means NOT SENT, so each coordinate is averaged over the rows that sent
# it, weighted by (coord sent) * w_i.  Per-coordinate weights fit neither
# engine law, so the rule owns its routes (flat_fn, custom_fn).


def _sparse_row_weights(n, mask, weights, device):
    """((n,) fp32 {0,1} mask, (n,) fp32 row weights with the mask folded
    in: dead rows -> 0); no mask means every row live."""
    m = (torch.ones((n,), dtype=torch.float32, device=device) if mask is None
         else mask.to(torch.bool).float())
    return m, (m if weights is None else weights.float() * m)


def _sparse_mean_law(xf, cw):
    """sum_i cw_i x_i / sum_i cw_i over the agent axis, an explicit 0 where
    the denominator is 0 (nobody sent the coordinate).  The where-gate
    keeps an unsent or dead row's inf or NaN out (never 0 * x)."""
    num = torch.sum(torch.where(cw > 0, xf, 0.0) * cw, dim=0)
    den = torch.sum(cw, dim=0)
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def _sparse_mean_flat(spec, stack, mask, weights, state, qscale=None):
    """sparse_mean on the (n, P) arena.  ``impl="kernel"``: K17 (K21 on a
    quantized arena, dequantized in registers), from the synchronous
    tables without a mask and weights, else from the masked ones with the
    RAW mask-folded row weights; the gather impl applies the law to the
    fp32 (dequantized) arena."""
    n = stack.shape[0]
    if spec.impl == "kernel":
        from repro_torch import kernels
        if mask is None and weights is None:
            if qscale is not None:
                return kernels.kernel_scaled_aggregate(
                    "sparse_mean", stack, qscale, spec.f, spec.hyper)
            return kernels.kernel_aggregate("sparse_mean", stack, spec.f,
                                            spec.hyper)
        m, w = _sparse_row_weights(n, mask, weights, stack.device)
        if qscale is not None:
            return kernels.kernel_scaled_masked_aggregate(
                "sparse_mean", stack, qscale, m, w, spec.f, spec.hyper)
        return kernels.kernel_masked_aggregate("sparse_mean", stack, m, w,
                                               spec.f, spec.hyper)
    _, w = _sparse_row_weights(n, mask, weights, stack.device)
    xf = (dequantize_rows(stack, qscale) if qscale is not None
          else stack.float())
    return _sparse_mean_law(xf, (xf != 0).float() * w[:, None])


def _sparse_mean_tree(spec, grads, mask, weights, state):
    """sparse_mean on a tree: on the kernel impl one K17 launch per
    uniform-dtype segment (the law is per coordinate, so the segments
    split it exactly), on the gather impl the law per leaf in fp32; each
    leaf's aggregate rounded to its dtype.  No fp32 ravel of the tree."""
    plan = FlatPlan.for_tree(grads)
    leaves = tree_leaves(grads)
    n = leaves[0].shape[0]
    m, w = _sparse_row_weights(n, mask, weights, leaves[0].device)
    cols = [l.reshape(n, -1) for l in leaves]
    if spec.impl == "kernel":
        from repro_torch.kernels import kernel_masked_aggregate
        outs = _per_dtype(cols, lambda seg: kernel_masked_aggregate(
            "sparse_mean", seg, m, w, spec.f, spec.hyper),
            lambda vec, dt: vec.to(dt))
    else:
        outs = [_sparse_mean_law(c.float(), (c.float() != 0).float()
                                 * w[:, None]).to(c.dtype) for c in cols]
    return tree_unflatten(plan.paths, [o.reshape(shp) for o, shp in
                                       zip(outs, plan.shapes)])


register_aggregator(
    "sparse_mean",
    caps=AggregatorCaps(coordwise=True),
    flat_fn=_sparse_mean_flat, custom_fn=_sparse_mean_tree,
    tags=("compressed",))


# ---------------------------------------------------------------------------
# the state protocol's helpers: every stateful rule keeps its memory as
# ``server_grad``, one fp32 (P,) vector in the JAX leaf order (the JAX
# state tree raveled)


def _as_vec(x):
    """A (P,) tensor, or a tree (ravelled in its leaf order), as fp32."""
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).float()
    return torch.cat([l.reshape(-1).float() for l in tree_leaves(x)])


def _server_grad_zeros(proto):
    """``{"server_grad": 0}`` shaped like one agent's ravelled gradient:
    ``proto`` is a single-agent tree (the parameters) or a (P,) vector."""
    leaves = [proto] if isinstance(proto, torch.Tensor) else tree_leaves(
        proto)
    total = sum(l.numel() for l in leaves)
    return {"server_grad": torch.zeros((total,), dtype=torch.float32,
                                       device=leaves[0].device)}


def _server_grad_ema(state, agg, ema):
    """``(1 - ema) s + ema a`` — arithmetic even at ema = 1, so an inf in
    the carried state gives NaN (0 * inf), as in JAX; ema = 0 keeps the
    state as it is (an externally maintained center)."""
    if not ema:
        return dict(state)
    v = (1.0 - ema) * state["server_grad"] + ema * _as_vec(agg)
    return {**state, "server_grad": v}


def _server_grad(state, n_cols):
    v = state["server_grad"]
    if not isinstance(v, torch.Tensor) or v.shape != (n_cols,):
        raise ValueError(
            f"state['server_grad'] must be the ({n_cols},) fp32 ravel of the "
            f"gradient, got {type(v).__name__} "
            f"{tuple(getattr(v, 'shape', ()))}")
    return v.float()


def _f32_tree_route(spec, grads, mask, weights, state):
    """The tree route of a rule whose output is fp32 whatever the leaf
    dtypes (the JAX tree laws of centered_clip and server_momentum carry
    an fp32 center): the flat law on the tree's ravel, fp32 leaves out."""
    plan = FlatPlan.for_tree(grads)
    vec = spec.aggregate_flat(plan.ravel(grads), mask, weights, state)
    return plan.as_dtype("float32").unravel(vec)


def _rows_f32(stack, qscale):
    return (dequantize_rows(stack, qscale) if qscale is not None
            else stack.float())


# ---------------------------------------------------------------------------
# centered clipping (Karimireddy et al.): iterate v <- v + sum_i lam_i
# (x_i - v), lam_i = w_i / tot * min(1, tau / ||x_i - v||), from the
# CARRIED center.  The clip radius needs whole-row norms, so it stays
# plain torch; the model-sized multiply-accumulate runs K22 under
# impl="kernel".


def _cclip_lam(xf, mask, wn, v, tau):
    """The iteration's clip-folded weights: absent rows are where-gated
    to an exact 0 before the norm (their inf / NaN never reaches it), so
    their lam is 0 (``mask=None``: every row arrived, nothing to gate).
    Returns (lam, the gated difference)."""
    diff = xf - v[None]
    if mask is not None:
        diff = torch.where(mask[:, None], diff, 0.0)
    dist = torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=1), 1e-30))
    return wn * torch.clamp_max(tau / dist, 1.0), diff


def cclip_iterates(spec, stack, mask=None, weights=None, state=None,
                   qscale=None):
    """Yields every iterate of centered_clip's flat law, v_1 .. v_iters
    ((P,) fp32 each; the last is the aggregate).  ``impl="kernel"`` applies
    each step with K22 on the arena's own rows (the dequantized fp32 rows
    of a quantized arena), the gather impl with the dense body
    ``v + sum_i lam_i (x_i - v)``."""
    n, P = stack.shape
    xf = _rows_f32(stack, qscale)
    gate = mask
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=stack.device)
    mask, w, _, tot = _masked_prelude(mask, weights)
    wn = w / tot
    tau = torch.tensor(float(spec.hp("tau", 1.0)), dtype=torch.float32,
                       device=stack.device)
    v = _server_grad(state, P)
    rows = xf if qscale is not None else stack
    for _ in range(int(spec.hp("iters", 5))):
        lam, diff = _cclip_lam(xf, None if gate is None else mask, wn, v,
                               tau)
        if spec.impl == "kernel":
            del diff
            from repro_torch.kernels import clipped_weighted_sum
            v = clipped_weighted_sum(lam, rows, v)
        else:
            v = v + torch.sum(diff * lam[:, None], dim=0)
            del diff
        yield v


def cclip_weights(spec, stack, mask=None, weights=None, state=None):
    """(n,) fp32 clip weights lam of centered_clip's FINAL iterate (the
    telemetry read-out): the whole flat law re-run (K22 under
    ``impl="kernel"``), then one more clip-radius stage at its result."""
    n = stack.shape[0]
    v = _server_grad(state, stack.shape[1])
    for v in cclip_iterates(spec, stack, mask, weights, state):
        pass
    m = (torch.ones((n,), dtype=torch.bool, device=stack.device)
         if mask is None else mask)
    m, w, _, tot = _masked_prelude(m, weights)
    tau = torch.tensor(float(spec.hp("tau", 1.0)), dtype=torch.float32,
                       device=stack.device)
    lam, _ = _cclip_lam(stack.float(), None if mask is None else m, w / tot,
                        v, tau)
    return lam


def _cclip_flat(spec, stack, mask, weights, state, qscale=None):
    """centered_clip on the (n, P) arena: its own masked law (no mean
    imputation: an imputed row would drag v toward the attacker-
    controlled delivered mean); a quantized arena is dequantized first,
    as the JAX engine does."""
    v = _server_grad(state, stack.shape[1])
    for v in cclip_iterates(spec, stack, mask, weights, state, qscale):
        pass
    return v


def _cclip_update_state(spec, state, agg):
    # ema = 1 (default): the center IS the last aggregate; smaller ema
    # trails it
    return _server_grad_ema(state, agg, spec.hp("ema", 1.0))


register_aggregator(
    "centered_clip",
    caps=AggregatorCaps(stateful=True),
    hyper=("tau", "iters", "ema"), state_keys=("server_grad",),
    flat_fn=_cclip_flat, custom_fn=_f32_tree_route,
    init_state=lambda spec, proto: _server_grad_zeros(proto),
    update_state=_cclip_update_state, tags=("memory",))


# ---------------------------------------------------------------------------
# zeno_pp, the delay-adaptive score filter (Zeno++ line): accept a
# delivered row whose cosine with the coordinate median of the delivered
# rows clears a staleness-tightened threshold (or that aligns strongly
# with the carried EMA v), and whose norm is sane; average the accepted
# rows with their discounts.  No kernel: JAX runs it outside any.

_MEDIAN_CHUNK = 1 << 22     # columns per sort: (n, 4M) values and indices


def _arrived_median(xf, mask, lo, hi):
    """(P,) fp32: 0.5 (s[lo] + s[hi]) of each column sorted with the
    absent rows as +inf, sorted a column chunk at a time so that no
    (n, P) sort (and its int64 indices) exists at once."""
    out = torch.empty((xf.shape[1],), dtype=torch.float32, device=xf.device)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=xf.device)
    for c in range(0, xf.shape[1], _MEDIAN_CHUNK):
        blk = torch.where(mask[:, None], xf[:, c:c + _MEDIAN_CHUNK], inf)
        s = torch.sort(blk, dim=0).values
        out[c:c + _MEDIAN_CHUNK] = 0.5 * (s.index_select(0, lo)[0]
                                          + s.index_select(0, hi)[0])
    return out


def zeno_pp_weights(spec, xf, mask=None, weights=None, state=None):
    """The (n,) aggregation weights of zeno_pp on the fp32 rows ``xf``
    (JAX ``_zeno_pp_weights``).  Row norms and dots are flat sums over
    the whole row (JAX adds per-leaf sums in leaf order: the same values
    within the fp32 bar)."""
    eps = spec.hp("eps", 1e-12)
    xi = spec.hp("xi", 0.5)
    dev = xf.device
    n = xf.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    mask, base_w, _, base_tot = _masked_prelude(mask, weights)
    v = _server_grad(state, xf.shape[1])
    v_sq = torch.clamp_min(torch.sum(v * v), 0.0)
    g_norm = torch.sqrt(torch.clamp_min(torch.sum(xf * xf, dim=1), eps))
    cos_v = torch.mv(xf, v) / (g_norm * torch.sqrt(torch.clamp_min(v_sq,
                                                                   eps)))
    # the primary reference: the coordinate median over ONLY the delivered
    # rows (no imputation: the delivered mean is attacker-controlled)
    cnt = torch.sum(mask).to(torch.int64)
    lo = (torch.clamp_min(cnt - 1, 0) // 2).reshape(1)
    hi = (cnt // 2).reshape(1)
    ref = _arrived_median(xf, mask, lo, hi)
    ref_sq = torch.sum(ref * ref)
    cos_ref = torch.mv(xf, ref) / (
        g_norm * torch.sqrt(torch.clamp_min(ref_sq, eps)))
    del ref
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    disc = torch.where(mask, base_w / torch.clamp_min(torch.max(base_w),
                                                      eps), zero)
    thresh = xi * (1.0 - torch.clamp(disc, 0.0, 1.0))
    # the norm-sanity gate: rows farther than c_norm x the delivered
    # rows' median norm are rejected whatever their cosine
    c_norm = spec.hp("c_norm", 2.5)
    inf = torch.tensor(math.inf, dtype=torch.float32, device=dev)
    s_norm = torch.sort(torch.where(mask, g_norm, inf)).values
    med_norm = 0.5 * (s_norm.index_select(0, lo)[0]
                      + s_norm.index_select(0, hi)[0])
    sane = g_norm <= c_norm * med_norm
    # the rescue path: strong alignment with the historically honest EMA
    rescue = (v_sq >= eps) & (cos_v >= xi)
    w = torch.where(((cos_ref >= thresh) | rescue) & sane & mask, base_w,
                    zero)
    tot = torch.sum(w)
    # fallback: the discounted mean of the norm-sane delivered rows
    w_sane = torch.where(sane & mask, base_w, zero)
    t_sane = torch.sum(w_sane)
    fallback = torch.where(t_sane > eps, w_sane / torch.clamp_min(t_sane, eps),
                           base_w / base_tot)
    return torch.where(tot > eps, w / torch.clamp_min(tot, eps), fallback)


def _zeno_pp_flat(spec, stack, mask, weights, state, qscale=None):
    """zeno_pp on the (n, P) arena: the weighted sum of the rows with its
    weights, as the fused multiply-add chain of the jitted JAX step
    (:func:`repro_torch.kernels.ref.fma_weighted_sum`; a row of weight 0
    is never read)."""
    from repro_torch.kernels import ref
    xf = _rows_f32(stack, qscale)
    return ref.fma_weighted_sum(
        zeno_pp_weights(spec, xf, mask, weights, state), xf)


register_aggregator(
    "zeno_pp",
    caps=AggregatorCaps(weight_decomposable=True, stateful=True),
    hyper=("xi", "ema", "eps", "c_norm"), state_keys=("server_grad",),
    flat_fn=_zeno_pp_flat,
    weights_fn=lambda spec, g, state: zeno_pp_weights(spec, g.float(),
                                                      state=state),
    init_state=lambda spec, proto: _server_grad_zeros(proto),
    update_state=lambda spec, state, agg: _server_grad_ema(
        state, agg, spec.hp("ema", 0.2)))


# ---------------------------------------------------------------------------
# zeno (server validation): the dense law scores each row against the
# carried validation gradient; the engine's laws (impute-then-scale under
# a mask) apply as to any dense rule


def _zeno_init_state(spec, proto):
    if not spec.hp("ema", 0.0):
        # with ema = 0 the zeros would never move and the defense would
        # silently degrade to norm filtering
        raise ValueError(
            "zeno with ema=0 needs an externally maintained validation "
            "gradient: pass state={'server_grad': v} yourself, or set "
            "ema>0 to self-maintain it from past aggregates")
    return _server_grad_zeros(proto)


register_aggregator(
    "zeno",
    caps=AggregatorCaps(weight_decomposable=True, stateful=True),
    hyper=("rho", "lr", "ema"), gather=("rho", "lr"),
    state_keys=("server_grad",), dense_fn=D.zeno, weights_fn=_w_zeno,
    gather_state=lambda spec, state, p: {
        "server_grad": _server_grad(state, p)},
    init_state=_zeno_init_state,
    update_state=lambda spec, state, agg: _server_grad_ema(
        state, agg, spec.hp("ema", 0.0)))


# ---------------------------------------------------------------------------
# server momentum, a composition wrapper (the survey's history filter):
# out_t = beta m_{t-1} + (1 - beta) inner(g_t), m_t = out_t


def _inner_state(spec, state):
    """A wrapper's inner rule's state (None for a stateless inner rule)."""
    return (state or {}).get("inner") if spec.inner.stateful else None


def _server_momentum_flat(spec, stack, mask, weights, state, qscale=None):
    """The inner spec's aggregate of the arena (rounded to a float
    arena's dtype, as the inner rule's tree aggregate is in JAX), then
    the fp32 momentum step."""
    beta = spec.hp("beta", 0.9)
    inner = spec.inner.aggregate_flat(stack, mask, weights,
                                      _inner_state(spec, state), qscale)
    if qscale is None:
        inner = inner.to(stack.dtype).float()
    m = _server_grad(state, stack.shape[1])
    return beta * m + (1.0 - beta) * inner


register_aggregator(
    "server_momentum",
    caps=AggregatorCaps(stateful=True),
    hyper=("beta",), state_keys=("server_grad",),
    flat_fn=_server_momentum_flat, custom_fn=_f32_tree_route,
    init_state=lambda spec, proto: _server_grad_zeros(proto),
    # the momentum buffer IS the emitted update
    update_state=lambda spec, state, agg: _server_grad_ema(state, agg, 1.0),
    is_wrapper=True)


def server_momentum(inner: AggregatorSpec,
                    beta: float = 0.9) -> AggregatorSpec:
    return make_spec("server_momentum", f=inner.f, inner=inner, beta=beta)


# ---------------------------------------------------------------------------
# the row-transform wrappers: each has a flat law on the (n, P) arena (the
# loops' route) and a tree route that is the JAX tree law


def _clip_scale(sq, tau):
    """(n,) row scales min(1, tau / ||g_i||) from the squared norms."""
    return torch.clamp_max(tau / torch.sqrt(torch.clamp_min(sq, 1e-30)),
                           1.0)


def _clip_flat(spec, stack, mask, weights, state, qscale=None):
    """clipped on the arena: each row scaled to norm <= tau in fp32 and
    cast back to the arena's dtype (a quantized arena's decoded fp32
    rows), then the inner rule.  The norm is one sum over the row (the
    JAX tree law adds per-leaf sums: within the fp32 bar)."""
    xf = _rows_f32(stack, qscale)
    scale = _clip_scale(torch.sum(torch.square(xf), dim=1),
                        spec.hp("tau", 1.0))
    dt = torch.float32 if qscale is not None else stack.dtype
    clipped = (xf * scale[:, None]).to(dt)
    del xf
    return spec.inner.aggregate_flat(clipped, mask, weights,
                                     _inner_state(spec, state))


def _clip_tree(spec, grads, mask, weights, state):
    """clipped on a tree: the row norms summed leaf by leaf, each leaf
    scaled in fp32 and cast back to its dtype, then the inner rule."""
    leaves = tree_leaves(grads)
    n = leaves[0].shape[0]
    sq = sum(torch.sum(torch.square(l.reshape(n, -1).float()), dim=1)
             for l in leaves)
    scale = _clip_scale(sq, spec.hp("tau", 1.0))
    plan = FlatPlan.for_tree(grads)
    clipped = [(l.float() * scale.reshape((-1,) + (1,) * (l.dim() - 1))
                ).to(l.dtype) for l in leaves]
    return spec.inner.aggregate(tree_unflatten(plan.paths, clipped), mask,
                                weights, _inner_state(spec, state))


def _bucket_inner(spec, n):
    """(k buckets, the inner spec at the k bucket means: f capped at
    (k - 1) // 2, no pinned n)."""
    gs = spec.hp("group_size", 2)
    if n % gs:
        raise ValueError(f"bucketed: n={n} not divisible by "
                         f"group_size={gs}")
    k = n // gs
    f_eff = min(spec.inner.f, max((k - 1) // 2, 0))
    return k, dataclasses.replace(spec.inner, f=f_eff, n=None)


def _refuse_masked_buckets(mask, weights):
    if mask is not None or weights is not None:
        raise ValueError("bucketed: masked aggregation not supported "
                         "(bucket membership is static)")


def _bucket_flat(spec, stack, mask, weights, state, qscale=None):
    """bucketed on the arena: the fp32 means of consecutive buckets of
    ``group_size`` rows, cast to the arena's dtype (a quantized arena's
    decoded fp32 rows), then the inner rule; synchronous only."""
    _refuse_masked_buckets(mask, weights)
    n, p = stack.shape
    k, inner = _bucket_inner(spec, n)
    dt = torch.float32 if qscale is not None else stack.dtype
    means = torch.mean(_rows_f32(stack, qscale).reshape(k, n // k, p),
                       dim=1).to(dt)
    return inner.aggregate_flat(means, state=_inner_state(spec, state))


def _bucket_tree(spec, grads, mask, weights, state):
    _refuse_masked_buckets(mask, weights)
    leaves = tree_leaves(grads)
    n = leaves[0].shape[0]
    k, inner = _bucket_inner(spec, n)
    plan = FlatPlan.for_tree(grads)
    means = [torch.mean(l.float().reshape((k, n // k) + l.shape[1:]),
                        dim=1).to(l.dtype) for l in leaves]
    return inner.aggregate(tree_unflatten(plan.paths, means),
                           state=_inner_state(spec, state))


def _staleness_w(spec, weights, n, device):
    """The discounts of the raw staleness rounds ``weights`` (0 rounds
    for every row when None)."""
    s = (torch.zeros((n,), dtype=torch.float32, device=device)
         if weights is None else weights.float())
    return staleness_discount_table(s, spec.hp("weighting", "poly"),
                                    spec.hp("power", 1.0),
                                    spec.hp("gamma", 0.7))


def _staleness_flat(spec, stack, mask, weights, state, qscale=None):
    return spec.inner.aggregate_flat(
        stack, mask, _staleness_w(spec, weights, stack.shape[0],
                                  stack.device),
        _inner_state(spec, state), qscale)


def _staleness_tree(spec, grads, mask, weights, state):
    lead = tree_leaves(grads)[0]
    return spec.inner.aggregate(
        grads, mask, _staleness_w(spec, weights, lead.shape[0], lead.device),
        _inner_state(spec, state))


register_aggregator(
    "clipped",
    caps=AggregatorCaps(),
    hyper=("tau",), flat_fn=_clip_flat, custom_fn=_clip_tree,
    is_wrapper=True)
register_aggregator(
    "bucketed",
    caps=AggregatorCaps(),
    hyper=("group_size",), flat_fn=_bucket_flat, custom_fn=_bucket_tree,
    is_wrapper=True)
register_aggregator(
    "staleness_discounted",
    caps=AggregatorCaps(staleness_aware=True),
    hyper=("weighting", "power", "gamma"), flat_fn=_staleness_flat,
    custom_fn=_staleness_tree, is_wrapper=True)


def clipped(inner: AggregatorSpec, tau: float = 1.0) -> AggregatorSpec:
    return make_spec("clipped", f=inner.f, inner=inner, tau=tau)


def bucketed(inner: AggregatorSpec, group_size: int = 2) -> AggregatorSpec:
    return make_spec("bucketed", f=inner.f, inner=inner,
                     group_size=group_size)


def staleness_discounted(inner: AggregatorSpec, weighting: str = "poly",
                         power: float = 1.0,
                         gamma: float = 0.7) -> AggregatorSpec:
    return make_spec("staleness_discounted", f=inner.f, inner=inner,
                     weighting=weighting, power=power, gamma=gamma)
