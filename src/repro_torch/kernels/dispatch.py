"""Caps-driven kernel dispatch: rule name -> kernel implementation.

Counterpart of the synchronous and masked tables of
``repro.kernels.dispatch`` (``PALLAS_RULES`` / ``PALLAS_MASKED_RULES``
there, ``KERNEL_RULES`` / ``KERNEL_MASKED_RULES`` here).  Every entry
takes the (n, P) arena in its native dtype (fp32 or bf16: the kernels
upcast in registers, so no fp32 (n, P) copy is made) and returns the (P,)
fp32 aggregate; the masked entries also take the (n,) fp32 mask and the
normalized weights wn = w / tot, on the arena's device.  The masked
selection family comes with ROADMAP.md slice 3b, the scaled table with
slice 4.
"""
from __future__ import annotations

from repro_torch.kernels.coord_stats import coord_stat
from repro_torch.kernels.masked import masked_coord_stat
from repro_torch.kernels.ops import (kernel_bulyan, kernel_cge, kernel_krum,
                                     kernel_krum_masked, kernel_m_krum,
                                     kernel_mda, kernel_multi_krum)


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


def _cge(stack, f, hyper):
    return kernel_cge(stack, f, normalize=hyper.get("normalize", True))


def _multi_krum(stack, f, hyper):
    return kernel_multi_krum(stack, f, m=hyper.get("m", 2))


def _m_krum(stack, f, hyper):
    return kernel_m_krum(stack, f, m=hyper.get("m", 2))


def _mda(stack, f, hyper):
    return kernel_mda(stack, f)


def _bulyan(stack, f, hyper):
    # only the classic krum base is Gram-derivable; make_spec gates the
    # kernel impl on hyper, so a generic base never reaches this table
    if hyper.get("base", "krum") != "krum":
        raise ValueError(f"bulyan: no kernel path for base="
                         f"{hyper['base']!r}")
    return kernel_bulyan(stack, f)


KERNEL_RULES = {
    "coordinate_median": _median,
    "trimmed_mean": _trimmed_mean,
    "krum": _krum,
    "cge": _cge,
    "multi_krum": _multi_krum,
    "m_krum": _m_krum,
    "mda": _mda,
    "bulyan": _bulyan,
}


def kernel_supported(name: str) -> bool:
    return name in KERNEL_RULES


def kernel_aggregate(name: str, stack, f: int, hyper: tuple = ()):
    """stack: (n, P) fp32 or bf16 -> (P,) fp32 via the rule's kernels.
    ``hyper`` is the spec's sorted static hyper tuple."""
    return KERNEL_RULES[name](stack, f, dict(hyper))


# masked rules: the coordinate statistics take the arrived-window law
# inside K5, krum the mean-imputed law inside K6 and K7


def _masked_median(stack, mask, wn, f, hyper):
    return masked_coord_stat(stack, mask, wn, "median")


def _masked_trimmed_mean(stack, mask, wn, f, hyper):
    return masked_coord_stat(stack, mask, wn, "trimmed_mean",
                             b=_trim_b(stack.shape[0], f, hyper))


def _masked_krum(stack, mask, wn, f, hyper):
    return kernel_krum_masked(stack, mask, wn, f)


KERNEL_MASKED_RULES = {
    "coordinate_median": _masked_median,
    "trimmed_mean": _masked_trimmed_mean,
    "krum": _masked_krum,
}


def kernel_masked_supported(name: str) -> bool:
    return name in KERNEL_MASKED_RULES


def masked_kernel_missing(name: str) -> str:
    """Why ``name`` has no masked kernel path, naming the ROADMAP.md slice
    that brings it."""
    return (f"{name}: no masked kernel path yet — the masked selection "
            "family (cge, multi_krum, m_krum, mda, bulyan) comes with "
            "ROADMAP.md slice 3b; impl='gather' runs the masked law")


def kernel_masked_aggregate(name: str, stack, mask, wn, f: int,
                            hyper: tuple = ()):
    """stack: (n, P) fp32 or bf16, mask: (n,) {0,1} fp32, wn: (n,) fp32
    -> (P,) fp32 masked statistic via the rule's kernels (the engine
    applies the tot/cnt scale)."""
    if name not in KERNEL_MASKED_RULES:
        raise NotImplementedError(masked_kernel_missing(name))
    return KERNEL_MASKED_RULES[name](stack, mask, wn, f, dict(hyper))
