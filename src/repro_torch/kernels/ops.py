"""Filter-level compositions of the kernels (counterpart of
``repro.kernels.ops``): the Krum pipeline Gram -> selection -> weighted
sum.  The JAX package pads d to its TPU tile (``_pad_d``); the CUDA
kernels mask their own ragged edge, so nothing is padded here.  Its
``_drop_unselected`` where-copy is fused into the weighted-sum kernel
(and its plain version) instead."""
from __future__ import annotations

from repro_torch.kernels.pairwise import gram
from repro_torch.kernels.select import krum_select
from repro_torch.kernels.wsum import weighted_sum


def kernel_krum(g, f: int):
    """Krum, fully on the kernel path; a one-hot application is exactly
    the selected row's values."""
    w = krum_select(gram(g), f)
    return weighted_sum(w, g)
