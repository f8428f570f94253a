"""Robust-aggregation registry: typed, validated specs (registry core).

Counterpart of ``repro.core.aggregators`` for the rules ported so far:

* :class:`AggregatorCaps` / :class:`AggregatorDef` / :func:`register_aggregator`
  — the single extension point;
* :class:`AggregatorSpec` / :func:`make_spec` — a frozen handle naming a
  rule plus its static configuration (``f``, hyper-parameters, ``impl``),
  hyper keys validated at build time;
* ``spec.aggregate`` / ``spec.aggregate_flat`` — the engine over a
  pytree or a pre-raveled (n, P) arena, synchronous or masked.

Registered so far: ``mean``, ``coordinate_median``, ``trimmed_mean``,
``krum``, the selection family ``cge``, ``multi_krum``, ``m_krum``,
``mda`` and ``bulyan``, the 1-bit vote ``sign_sgd``, and the sparse /
dropout-aware ``sparse_mean`` of the compressed exchange.  Impls:

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
coordinate-wise rules.  ``make_spec`` accepts it for those rules and
refuses it for the others, then drops it: only the JAX package's
leaf-wise ``fused`` impl reads it (ROADMAP.md slice 11), and the flat
path ignores it there too.

A rule whose law is neither of the engine's (``sparse_mean``: per-
coordinate weights) owns its route: ``flat_fn`` takes the whole
``aggregate_flat`` call (mask, raw weights, row scales) and ``custom_fn``
the whole tree call, before the engine's synchronous and masked paths.

Masked / staleness-weighted aggregation (``mask=``, ``weights=``): the
coordinate-wise rules take the order statistic over the ARRIVED rows only
(absent rows are +inf sort sentinels, the rank window follows the
arrived count) and sign_sgd the vote of the arrived rows; krum and the
selection family run on the mean-imputed stack; mean is the exact
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

Wrappers, state and telemetry come with ROADMAP.md slices 3, 6 and 7.
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
    pairwise: bool = False            # statistics derivable from the Gram
    stateful: bool = False            # carries init_state/update_state


@dataclass(frozen=True)
class AggregatorDef:
    """Registry record: capabilities + the callables the engine uses."""
    name: str
    caps: AggregatorCaps
    hyper_keys: frozenset          # allowed hyper-parameter names
    gather_keys: frozenset         # hyper forwarded to the dense gather fn
    impl_keys: frozenset           # impl-only keys (accepted, not stored)
    dense_fn: Optional[Callable] = None    # (stack, f, **hyper) -> (P,)
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
    tags: tuple = ()               # e.g. ("compressed",)


REGISTRY: dict[str, AggregatorDef] = {}


def register_aggregator(name: str, *, caps: AggregatorCaps,
                        hyper: tuple = (), gather: tuple = (),
                        impl_keys: tuple = (), dense_fn=None,
                        masked_fn=None, flat_fn=None, custom_fn=None,
                        tags: tuple = ()):
    """Register an aggregation rule (raises on a duplicate name)."""
    if name in REGISTRY:
        raise ValueError(f"aggregator {name!r} already registered")
    REGISTRY[name] = AggregatorDef(
        name=name, caps=caps, hyper_keys=frozenset(hyper),
        gather_keys=frozenset(gather), impl_keys=frozenset(impl_keys),
        dense_fn=dense_fn, masked_fn=masked_fn, flat_fn=flat_fn,
        custom_fn=custom_fn, tags=tuple(tags))
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
        return self.caps.stateful

    def hp(self, key: str, default=None):
        return dict(self.hyper).get(key, default)

    def describe(self) -> str:
        h = ", ".join(f"{k}={v}" for k, v in self.hyper)
        el = (f", elastic[{'/'.join(map(str, self.elastic.buckets))}]"
              if self.elastic else "")
        return f"{self.name}(f={self.f}{', ' + h if h else ''}{el})"

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
        d = get_aggregator_def(self.name)
        if d.custom_fn is not None:
            return d.custom_fn(self, grads, mask, weights, state)
        plan = FlatPlan.for_tree(grads)
        if mask is None and weights is None:
            vec = self.aggregate_flat(plan.ravel(grads, torch.float32),
                                      state=state)
            return plan.unravel(vec)
        if plan.uniform_dtype is not None:
            # ravel in the leaves' own dtype: the engine's double rounding
            # through the arena dtype is then the tree engine's per-leaf
            # rounding (bit-for-bit with the JAX masked tree path)
            return plan.unravel(self.aggregate_flat(
                plan.ravel(grads), mask, weights, state))
        if state is not None:
            raise NotImplementedError(
                "stateful rules come with ROADMAP.md slice 6")
        return _masked_mixed_tree(self, d, grads, plan, mask, weights)

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
        if state is not None:
            raise NotImplementedError(
                "stateful rules come with ROADMAP.md slice 6")
        if self.n is not None and stack.shape[0] != self.n:
            raise ValueError(f"{self.describe()} was built for n={self.n}, "
                             f"got a stack of {stack.shape[0]} rows")
        d = get_aggregator_def(self.name)
        if d.flat_fn is not None:
            return d.flat_fn(self, stack, mask, weights, state, scale)
        if mask is None and weights is None:
            return _flat_sync_vec(self, d, stack, scale)
        if mask is None:
            mask = torch.ones((stack.shape[0],), dtype=torch.bool,
                              device=stack.device)
        return _flat_masked_vec(self, d, stack, mask, weights, scale)


@functools.lru_cache(maxsize=None)
def _respecialize(spec: AggregatorSpec, n_live: int) -> AggregatorSpec:
    """Cached: repeat calls for the same (spec, n_live) return the SAME
    object."""
    if spec.elastic is None:
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
    out = dataclasses.replace(spec, n=b, f=f_b, elastic=None, f_policy=None)
    _warm_plan(out, b)
    return out


def _warm_plan(spec: AggregatorSpec, n: int):
    """Precompute per-(n, f) static work at spec-build time."""
    if spec.name == "mda":
        mda_combos(n, spec.f)
    if spec.name == "trimmed_mean":
        trim_count(n, spec.f, spec.hp("beta"))


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


def _flat_sync_vec(spec, d, stack, qscale=None):
    """(n, P) arena -> (P,) fp32, synchronous.  ``qscale``: the row scales
    of a quantized arena."""
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
# vote counts the arrived rows only.  The JAX package's phocas and
# mean_around_median join with ROADMAP.md item 15.
_ARRIVED_STAT_RULES = ("coordinate_median", "trimmed_mean", "sign_sgd")


def _arrived_coord_vec(spec, xf, mask):
    """(n, P) fp32 -> (P,) fp32: the statistic over the arrived rows
    (the gather oracles :func:`repro_torch.kernels.ref.masked_stat_ref`
    and :func:`~repro_torch.kernels.ref.masked_sign_vote_ref`)."""
    from repro_torch.kernels import ref
    if spec.name == "sign_sgd":
        return ref.masked_sign_vote_ref(xf, mask)
    if spec.name == "coordinate_median":
        return ref.masked_stat_ref(xf, mask, None, "median")
    b = trim_count(xf.shape[0], spec.f, spec.hp("beta"))
    return ref.masked_stat_ref(xf, mask, None, "trimmed_mean", b=b)


def _flat_masked_vec(spec, d, stack, mask, weights, qscale=None):
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
    return scaled(_flat_sync_vec(spec, d, imputed))


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


_FUSED_MSG = ("impl='fused' (the leaf-wise, sharding-aware impl) is not "
              "ported yet: ROADMAP.md slice 11")


def kernel_available(name: str) -> bool:
    """True iff ``name`` has a kernel path AND its caps declare the
    matching structure (coordinate-wise or Gram-derivable)."""
    d = get_aggregator_def(name)
    if not (d.caps.coordwise or d.caps.pairwise):
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
        reason = ("its hyper-parameters select a non-kernelized variant"
                  if kernel_available(name) else
                  "no kernel is registered for it")
        raise ValueError(f"{name}: impl='kernel' requested but {reason} "
                         "(repro_torch.kernels.dispatch.KERNEL_RULES)")
    return impl


def make_spec(name: str, f: "int | FracF" = 0, impl: str = "auto",
              n: "int | ElasticN | None" = None, **hyper) -> AggregatorSpec:
    """Build a validated :class:`AggregatorSpec` (unknown hyper keys and
    unsupported impls raise here).

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
    plain = {}
    for k, v in hyper.items():
        if k in d.hyper_keys:
            plain[k] = v
        elif k not in d.impl_keys:
            raise ValueError(
                f"{name}: unknown hyper-parameter {k!r} "
                f"(allowed: {sorted(d.hyper_keys | d.impl_keys)})")
    spec = AggregatorSpec(name=name, f=f, hyper=tuple(sorted(plain.items())),
                          impl=_resolve_impl(name, impl, plain), n=n_int,
                          elastic=el, f_policy=f_policy)
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
    caps=AggregatorCaps(),
    dense_fn=D.mean, masked_fn=_mean_masked)
register_aggregator(
    "krum",
    caps=AggregatorCaps(pairwise=True),
    dense_fn=D.krum)
register_aggregator(
    "multi_krum",
    caps=AggregatorCaps(pairwise=True),
    hyper=("m",), gather=("m",), dense_fn=D.multi_krum)
register_aggregator(
    "m_krum",
    caps=AggregatorCaps(pairwise=True),
    hyper=("m",), gather=("m",), dense_fn=D.m_krum)
register_aggregator(
    "mda",
    caps=AggregatorCaps(pairwise=True),
    dense_fn=D.mda)
register_aggregator(
    "cge",
    caps=AggregatorCaps(pairwise=True),
    hyper=("normalize",), gather=("normalize",), dense_fn=D.cge)
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
