"""Caps-driven kernel dispatch: rule name -> kernel implementation.

Counterpart of the synchronous and masked tables of
``repro.kernels.dispatch`` (``PALLAS_RULES`` / ``PALLAS_MASKED_RULES``
there, ``KERNEL_RULES`` / ``KERNEL_MASKED_RULES`` here).  Every entry
takes the (n, P) arena in its native dtype (fp32 or bf16: the kernels
upcast in registers, so no fp32 (n, P) copy is made) and returns the (P,)
fp32 aggregate; the masked entries also take the (n,) fp32 mask and the
normalized weights wn = w / tot, on the arena's device (sparse_mean's
entry takes the RAW mask-folded row weights in that slot: its law is
invariant under a global scaling of the weights).  Both tables hold the
same rules: the coordinate statistics, Krum and the selection family,
sign_sgd and sparse_mean.

The scaled tables (``PALLAS_SCALED_RULES`` / ``PALLAS_SCALED_MASKED_RULES``
there, ``KERNEL_SCALED_RULES`` / ``KERNEL_SCALED_MASKED_RULES`` here) take
a QUANTIZED arena, int8 / float8_e4m3fn codes and an (n,) fp32 scale per
row, and dequantize inside the kernel (K18-K21; synchronous sign_sgd votes
on the codes with K15), so no dequantized (n, P) copy is made.  The other
rules dequantize at engine level (``aggregators._flat_dequant``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.coord_stats import coord_stat
from repro_torch.kernels.masked import (masked_coord_stat, masked_sign_vote,
                                        scaled_coord_stat,
                                        scaled_masked_coord_stat,
                                        scaled_masked_sign_vote, sign_vote)
from repro_torch.kernels.ops import (kernel_bulyan, kernel_bulyan_masked,
                                     kernel_cge, kernel_cge_masked,
                                     kernel_krum, kernel_krum_masked,
                                     kernel_m_krum, kernel_m_krum_masked,
                                     kernel_mda, kernel_mda_masked,
                                     kernel_multi_krum,
                                     kernel_multi_krum_masked)
from repro_torch.kernels.wsum import (scaled_sparse_masked_weighted_mean,
                                      sparse_masked_weighted_mean)


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


def _krum_base(hyper):
    # only the classic krum base is Gram-derivable; make_spec gates the
    # kernel impl on hyper, so a generic base never reaches these tables
    if hyper.get("base", "krum") != "krum":
        raise ValueError(f"bulyan: no kernel path for base="
                         f"{hyper['base']!r}")


def _bulyan(stack, f, hyper):
    _krum_base(hyper)
    return kernel_bulyan(stack, f)


def _sign_sgd(stack, f, hyper):
    return sign_vote(stack)


def _ones(stack):
    return torch.ones((stack.shape[0],), dtype=torch.float32,
                      device=stack.device)


def _sparse_mean(stack, f, hyper):
    # synchronous: every row live with unit weight
    ones = _ones(stack)
    return sparse_masked_weighted_mean(stack, ones, ones)


KERNEL_RULES = {
    "coordinate_median": _median,
    "trimmed_mean": _trimmed_mean,
    "krum": _krum,
    "cge": _cge,
    "multi_krum": _multi_krum,
    "m_krum": _m_krum,
    "mda": _mda,
    "bulyan": _bulyan,
    "sign_sgd": _sign_sgd,
    "sparse_mean": _sparse_mean,
}


def kernel_supported(name: str) -> bool:
    return name in KERNEL_RULES


def kernel_aggregate(name: str, stack, f: int, hyper: tuple = ()):
    """stack: (n, P) fp32 or bf16 -> (P,) fp32 via the rule's kernels.
    ``hyper`` is the spec's sorted static hyper tuple."""
    return KERNEL_RULES[name](stack, f, dict(hyper))


# masked rules: the coordinate statistics take the arrived-window law
# inside K5 (sign_sgd the arrived rows' vote inside K16), Krum and the
# selection family the mean-imputed law inside K6 and their masked stages
# (K7, K12, K14)


def _masked_median(stack, mask, wn, f, hyper):
    return masked_coord_stat(stack, mask, wn, "median")


def _masked_trimmed_mean(stack, mask, wn, f, hyper):
    return masked_coord_stat(stack, mask, wn, "trimmed_mean",
                             b=_trim_b(stack.shape[0], f, hyper))


def _masked_krum(stack, mask, wn, f, hyper):
    return kernel_krum_masked(stack, mask, wn, f)


def _masked_cge(stack, mask, wn, f, hyper):
    return kernel_cge_masked(stack, mask, wn, f,
                             normalize=hyper.get("normalize", True))


def _masked_multi_krum(stack, mask, wn, f, hyper):
    return kernel_multi_krum_masked(stack, mask, wn, f, m=hyper.get("m", 2))


def _masked_m_krum(stack, mask, wn, f, hyper):
    return kernel_m_krum_masked(stack, mask, wn, f, m=hyper.get("m", 2))


def _masked_mda(stack, mask, wn, f, hyper):
    return kernel_mda_masked(stack, mask, wn, f)


def _masked_bulyan(stack, mask, wn, f, hyper):
    _krum_base(hyper)
    return kernel_bulyan_masked(stack, mask, wn, f)


def _masked_sign_sgd(stack, mask, wn, f, hyper):
    return masked_sign_vote(stack, mask, wn)


def _masked_sparse_mean(stack, mask, w, f, hyper):
    # the wn slot carries the RAW mask-folded row weights, not w / tot
    return sparse_masked_weighted_mean(stack, mask, w)


KERNEL_MASKED_RULES = {
    "coordinate_median": _masked_median,
    "trimmed_mean": _masked_trimmed_mean,
    "krum": _masked_krum,
    "cge": _masked_cge,
    "multi_krum": _masked_multi_krum,
    "m_krum": _masked_m_krum,
    "mda": _masked_mda,
    "bulyan": _masked_bulyan,
    "sign_sgd": _masked_sign_sgd,
    "sparse_mean": _masked_sparse_mean,
}


def kernel_masked_supported(name: str) -> bool:
    return name in KERNEL_MASKED_RULES


def masked_kernel_missing(name: str) -> str:
    """Why ``name`` has no masked kernel path (a rule of KERNEL_RULES
    without an entry in KERNEL_MASKED_RULES)."""
    return (f"{name}: no masked kernel path (KERNEL_MASKED_RULES); "
            "impl='gather' runs the masked law")


def kernel_masked_aggregate(name: str, stack, mask, wn, f: int,
                            hyper: tuple = ()):
    """stack: (n, P) fp32 or bf16, mask: (n,) {0,1} fp32, wn: (n,) fp32
    -> (P,) fp32 masked statistic via the rule's kernels (the engine
    applies the tot/cnt scale)."""
    if name not in KERNEL_MASKED_RULES:
        raise NotImplementedError(masked_kernel_missing(name))
    return KERNEL_MASKED_RULES[name](stack, mask, wn, f, dict(hyper))


# scaled rules: the arena holds int8 / fp8 codes and an (n,) fp32 scale per
# row (core.flat.quantize_rows); the kernels dequantize in registers


def _scaled_median(stack, qs, f, hyper):
    return scaled_coord_stat(stack, qs, "median")


def _scaled_trimmed_mean(stack, qs, f, hyper):
    return scaled_coord_stat(stack, qs, "trimmed_mean",
                             b=_trim_b(stack.shape[0], f, hyper))


def _scaled_sign_sgd(stack, qs, f, hyper):
    # sign(code * scale) == sign(code) for a finite scale > 0: the plain
    # vote reads the codes directly, as the JAX table does (an inf row's
    # 0 codes cast a 0 vote here, where the dequantized law reads NaN)
    return sign_vote(stack)


def _scaled_sparse_mean(stack, qs, f, hyper):
    ones = _ones(stack)
    return scaled_sparse_masked_weighted_mean(stack, qs, ones, ones)


KERNEL_SCALED_RULES = {
    "coordinate_median": _scaled_median,
    "trimmed_mean": _scaled_trimmed_mean,
    "sign_sgd": _scaled_sign_sgd,
    "sparse_mean": _scaled_sparse_mean,
}


def _scaled_masked_median(stack, qs, mask, wn, f, hyper):
    return scaled_masked_coord_stat(stack, qs, mask, wn, "median")


def _scaled_masked_trimmed_mean(stack, qs, mask, wn, f, hyper):
    return scaled_masked_coord_stat(stack, qs, mask, wn, "trimmed_mean",
                                    b=_trim_b(stack.shape[0], f, hyper))


def _scaled_masked_sign_sgd(stack, qs, mask, wn, f, hyper):
    return scaled_masked_sign_vote(stack, qs, mask, wn)


def _scaled_masked_sparse_mean(stack, qs, mask, w, f, hyper):
    # raw row weights, as _masked_sparse_mean
    return scaled_sparse_masked_weighted_mean(stack, qs, mask, w)


KERNEL_SCALED_MASKED_RULES = {
    "coordinate_median": _scaled_masked_median,
    "trimmed_mean": _scaled_masked_trimmed_mean,
    "sign_sgd": _scaled_masked_sign_sgd,
    "sparse_mean": _scaled_masked_sparse_mean,
}


def kernel_scaled_supported(name: str) -> bool:
    """True iff ``name`` dequantizes a quantized arena inside its kernels
    (both the synchronous and the masked entry)."""
    return name in KERNEL_SCALED_RULES and name in KERNEL_SCALED_MASKED_RULES


def kernel_scaled_aggregate(name: str, stack, qscale, f: int,
                            hyper: tuple = ()):
    """stack: (n, P) int8 / fp8 codes, qscale: (n,) fp32 -> (P,) fp32."""
    return KERNEL_SCALED_RULES[name](stack, qscale, f, dict(hyper))


def kernel_scaled_masked_aggregate(name: str, stack, qscale, mask, wn,
                                   f: int, hyper: tuple = ()):
    """The masked entry of :func:`kernel_scaled_aggregate` (mask: (n,)
    {0,1} fp32, wn: (n,) fp32; the engine applies the tot/cnt scale)."""
    return KERNEL_SCALED_MASKED_RULES[name](stack, qscale, mask, wn, f,
                                            dict(hyper))
