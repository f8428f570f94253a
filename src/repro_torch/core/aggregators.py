"""Robust-aggregation registry: typed, validated specs (registry core).

Counterpart of ``repro.core.aggregators`` for the synchronous path of the
port's first slice:

* :class:`AggregatorCaps` / :class:`AggregatorDef` / :func:`register_aggregator`
  — the single extension point;
* :class:`AggregatorSpec` / :func:`make_spec` — a frozen handle naming a
  rule plus its static configuration (``f``, hyper-parameters, ``impl``),
  hyper keys validated at build time;
* ``spec.aggregate`` / ``spec.aggregate_flat`` — the synchronous engine
  over a pytree or a pre-raveled (n, P) arena.

Registered so far: ``mean``, ``coordinate_median``, ``trimmed_mean`` and
``krum``.  Impls:

* ``kernel`` — the hand-written CUDA kernels (:mod:`repro_torch.kernels`),
  the JAX package's ``pallas``.  On a CPU tensor each kernel wrapper runs
  its plain PyTorch version.
* ``gather`` — the paper-faithful dense law (:mod:`.filters.dense`).
* ``auto`` — ``kernel`` for the rules in the kernel table, else
  ``gather``.
* ``fused`` — the JAX package's leaf-wise, sharding-aware impl: not
  ported yet (ROADMAP.md slice 11, distribution); asking for it raises.

The masked/weighted engine, elastic specs, wrappers, state and telemetry
come with ROADMAP.md slices 2, 3, 6 and 7.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.core.filters import dense as D
from repro_torch.core.flat import FlatPlan

IMPLS = ("auto", "kernel", "gather", "fused")


@functools.lru_cache(maxsize=None)
def trim_count(n: int, f: int, beta: float | None) -> int:
    """Per-side trim count of the coordinate-wise trimmed mean."""
    b = int(math.ceil((beta if beta is not None else f / n) * n)) if n else 0
    return min(b, (n - 1) // 2)


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
    dense_fn: Optional[Callable] = None    # (stack, f, **hyper) -> (P,)


REGISTRY: dict[str, AggregatorDef] = {}


def register_aggregator(name: str, *, caps: AggregatorCaps,
                        hyper: tuple = (), gather: tuple = (),
                        dense_fn=None):
    """Register an aggregation rule (raises on a duplicate name)."""
    if name in REGISTRY:
        raise ValueError(f"aggregator {name!r} already registered")
    REGISTRY[name] = AggregatorDef(
        name=name, caps=caps, hyper_keys=frozenset(hyper),
        gather_keys=frozenset(gather), dense_fn=dense_fn)
    return REGISTRY[name]


def get_aggregator_def(name: str) -> AggregatorDef:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown aggregator {name!r}; registered: "
                       f"{sorted(REGISTRY)}") from None


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
    n: Optional[int] = None           # static agent count

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
        return f"{self.name}(f={self.f}{', ' + h if h else ''})"

    @property
    def flat_capable(self) -> bool:
        """True iff :meth:`aggregate_flat` can take a pre-raveled arena
        (every registered rule on the kernel and gather impls)."""
        return self.impl in ("kernel", "gather")

    def aggregate(self, grads, mask=None, weights=None, state=None):
        """Aggregate per-agent gradients (leading axis = agent): a tree of
        (n, ...) leaves or an (n, P) stack.  Returns the same structure
        without the agent axis (leaf dtypes restored for a tree)."""
        if isinstance(grads, torch.Tensor):
            return self.aggregate_flat(grads, mask, weights, state)
        plan = FlatPlan.for_tree(grads)
        vec = self.aggregate_flat(plan.ravel(grads, torch.float32), mask,
                                  weights, state)
        return plan.unravel(vec)

    def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                       scale=None):
        """Aggregate a pre-raveled (n, P) arena (fp32 or bf16) -> (P,)
        fp32.  The kernel impl reads the arena in its own dtype; the
        gather impl takes an fp32 view or copy, as the JAX engine does."""
        if mask is not None or weights is not None:
            raise NotImplementedError(
                "masked/weighted aggregation comes with ROADMAP.md slice 2")
        if scale is not None:
            raise NotImplementedError(
                "quantized arenas come with ROADMAP.md slice 4")
        if state is not None:
            raise NotImplementedError(
                "stateful rules come with ROADMAP.md slice 6")
        if self.n is not None and stack.shape[0] != self.n:
            raise ValueError(f"{self.describe()} was built for n={self.n}, "
                             f"got a stack of {stack.shape[0]} rows")
        d = get_aggregator_def(self.name)
        if self.impl == "kernel":
            from repro_torch.kernels import kernel_aggregate
            return kernel_aggregate(self.name, stack, self.f, self.hyper)
        if self.impl == "gather":
            hyper = {k: v for k, v in self.hyper if k in d.gather_keys}
            return d.dense_fn(stack.float(), self.f, **hyper)
        raise NotImplementedError(_FUSED_MSG)


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


def _resolve_impl(name: str, impl: str) -> str:
    """``auto`` -> ``kernel`` where a kernel exists, else ``gather``;
    ``kernel`` on a rule without one raises here, at build time."""
    if impl == "pallas":
        raise ValueError("impl='pallas' is the JAX package's name; the "
                         "port calls it impl='kernel'")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {'|'.join(IMPLS)}, got "
                         f"{impl!r}")
    if impl == "fused":
        raise NotImplementedError(_FUSED_MSG)
    supported = kernel_available(name)
    if impl == "auto":
        return "kernel" if supported else "gather"
    if impl == "kernel" and not supported:
        raise ValueError(f"{name}: impl='kernel' requested but no kernel is "
                         "registered for it (repro_torch.kernels.dispatch."
                         "KERNEL_RULES)")
    return impl


def make_spec(name: str, f: int = 0, impl: str = "auto",
              n: int | None = None, **hyper) -> AggregatorSpec:
    """Build a validated :class:`AggregatorSpec` (unknown hyper keys and
    unsupported impls raise here)."""
    d = get_aggregator_def(name)
    if not isinstance(f, int) or f < 0:
        raise ValueError(f"f must be an int >= 0, got {f!r} (frac(...) "
                         "budgets come with ROADMAP.md slice 2)")
    if n is not None and not isinstance(n, int):
        raise NotImplementedError("elastic n comes with ROADMAP.md slice 2")
    for k in hyper:
        if k not in d.hyper_keys:
            raise ValueError(f"{name}: unknown hyper-parameter {k!r} "
                             f"(allowed: {sorted(d.hyper_keys)})")
    spec = AggregatorSpec(name=name, f=f, hyper=tuple(sorted(hyper.items())),
                          impl=_resolve_impl(name, impl), n=n)
    if n is not None and name == "trimmed_mean":
        trim_count(n, f, spec.hp("beta"))
    return spec


# ---------------------------------------------------------------------------
# registrations

register_aggregator(
    "mean",
    caps=AggregatorCaps(),
    dense_fn=D.mean)
register_aggregator(
    "krum",
    caps=AggregatorCaps(pairwise=True),
    dense_fn=D.krum)
register_aggregator(
    "coordinate_median",
    caps=AggregatorCaps(coordwise=True),
    dense_fn=D.coordinate_median)
register_aggregator(
    "trimmed_mean",
    caps=AggregatorCaps(coordwise=True),
    hyper=("beta",), gather=("beta",), dense_fn=D.trimmed_mean)
