"""K3: the Krum selection on the (n, n) Gram.

Replaces the Pallas TPU kernel ``repro/kernels/select.py:krum_select``
with the CUDA kernel ``csrc/krum_select.cu`` (one block, one thread per
candidate).

:func:`krum_select` launches the kernel for a CUDA tensor and runs the
plain version :func:`krum_select_plain` for a CPU tensor.
``krum_select.launches`` counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

MAX_N = 64


def _rank(values):
    """Exact comparison rank, first index wins ties, NaN ordered last:
    rank[i] = #{j : v_j < v_i or (v_j == v_i and j < i)}."""
    values = torch.where(torch.isnan(values),
                         torch.full_like(values, math.inf), values)
    n = values.shape[0]
    idx = torch.arange(n, device=values.device)
    vi, vj = values[:, None], values[None, :]
    before = (vj < vi) | ((vj == vi) & (idx[None, :] < idx[:, None]))
    return before.sum(dim=1)


def d2_from_gram(gr):
    """Squared distances off the Gram: NaN -> +inf, self -> +inf."""
    n = gr.shape[0]
    sq = torch.diagonal(gr)
    d2 = torch.maximum(sq[:, None] + sq[None, :] - 2.0 * gr,
                       torch.zeros((), dtype=gr.dtype, device=gr.device))
    d2 = torch.where(torch.isnan(d2), torch.full_like(d2, math.inf), d2)
    eye = torch.eye(n, dtype=torch.bool, device=gr.device)
    return d2.masked_fill(eye, math.inf)


def krum_k(n: int, f: int) -> int:
    return max(n - f - 2, 1)


def krum_select_plain(gr, f: int):
    """(n, n) Gram -> (n,) one-hot fp32: the plain version of the kernel
    (row sums of the k smallest distances taken in ascending order)."""
    gr = gr.float()
    srt, _ = torch.sort(d2_from_gram(gr), dim=1)
    k = krum_k(gr.shape[0], f)
    scores = srt[:, 0].clone()
    for m in range(1, k):
        scores = scores + srt[:, m]
    return (_rank(scores) == 0).float()


def krum_select(gr, f: int):
    """gr: (n, n) fp32 Gram -> (n,) one-hot fp32 Krum selection."""
    if gr.dim() != 2 or gr.shape[0] != gr.shape[1]:
        raise ValueError(f"krum_select: need an (n, n) Gram, got "
                         f"{tuple(gr.shape)}")
    n = gr.shape[0]
    if not 1 <= n <= MAX_N or f < 0:
        raise ValueError(f"krum_select: n={n}, f={f} outside n in "
                         f"[1, {MAX_N}], f >= 0")
    if gr.device.type == "cpu":
        return krum_select_plain(gr, f)
    if gr.device.type != "cuda":
        raise ValueError(f"krum_select: unsupported device {gr.device}")
    if gr.dtype != torch.float32 or not gr.is_contiguous():
        raise ValueError("krum_select: Gram must be contiguous float32")
    out = torch.empty((n,), dtype=torch.float32, device=gr.device)
    rc = build.lib().rt_krum_select(gr.data_ptr(), out.data_ptr(), n, int(f),
                                    build.stream_ptr(gr))
    build.check(rc, "krum_select")
    krum_select.launches += 1
    return out


krum_select.launches = 0
