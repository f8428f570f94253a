"""Filter-level compositions of the kernels (counterpart of
``repro.kernels.ops``): the Krum pipeline Gram -> selection -> weighted
sum, plain and masked.  The JAX package pads d to its TPU tile
(``_pad_d``); the CUDA kernels mask their own ragged edge, so nothing is
padded here.  Its ``_drop_unselected`` where-copy is fused into the
weighted-sum kernels (and their plain versions) instead."""
from __future__ import annotations

from repro_torch.kernels.pairwise import gram, imputed_mean, masked_gram
from repro_torch.kernels.select import krum_select
from repro_torch.kernels.wsum import masked_weighted_sum, weighted_sum


def kernel_krum(g, f: int):
    """Krum, fully on the kernel path; a one-hot application is exactly
    the selected row's values."""
    w = krum_select(gram(g), f)
    return weighted_sum(w, g)


def kernel_krum_masked(g, mask, wn, f: int):
    """Masked Krum = Krum over the mean-imputed stack (the gather law),
    without building it: the mean is computed ONCE (through K4) and shared
    by K6 and K7, and the one-hot application returns exactly the
    selected imputed row (the live row, or the mean upcast for a ghost).
    K3's output is {0,1} by construction: K7's precondition w >= 0."""
    mean = imputed_mean(g, wn)
    w = krum_select(masked_gram(g, mask, wn, mean), f)
    return masked_weighted_sum(w, g, mask, mean)
