"""Caps-driven kernel dispatch: rule name -> kernel implementation.

Counterpart of the synchronous table of ``repro.kernels.dispatch``
(``PALLAS_RULES`` there, ``KERNEL_RULES`` here).  Every entry takes the
(n, P) arena in its native dtype (fp32 or bf16: the kernels upcast in
registers, so no fp32 (n, P) copy is made) and returns the (P,) fp32
aggregate.  The masked, scaled and remaining selection tables come with
ROADMAP.md slices 2-4.
"""
from __future__ import annotations

from repro_torch.kernels.coord_stats import coord_stat
from repro_torch.kernels.ops import kernel_krum


def _trim_b(n: int, f: int, hyper: dict) -> int:
    from repro_torch.core.aggregators import trim_count    # lazy: no cycle
    return trim_count(n, f, hyper.get("beta"))


def _median(stack, f, hyper):
    return coord_stat(stack, "median")


def _trimmed_mean(stack, f, hyper):
    return coord_stat(stack, "trimmed_mean",
                      b=_trim_b(stack.shape[0], f, hyper))


def _krum(stack, f, hyper):
    return kernel_krum(stack, f)


KERNEL_RULES = {
    "coordinate_median": _median,
    "trimmed_mean": _trimmed_mean,
    "krum": _krum,
}


def kernel_supported(name: str) -> bool:
    return name in KERNEL_RULES


def kernel_aggregate(name: str, stack, f: int, hyper: tuple = ()):
    """stack: (n, P) fp32 or bf16 -> (P,) fp32 via the rule's kernels.
    ``hyper`` is the spec's sorted static hyper tuple."""
    return KERNEL_RULES[name](stack, f, dict(hyper))
