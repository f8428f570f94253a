"""K4: the weighted sum w^T G over the agent axis.

Replaces the Pallas TPU kernel ``repro/kernels/wsum.py:weighted_sum`` with
the CUDA kernel ``csrc/wsum.cu``, which also fuses the caller's
``_drop_unselected`` (``repro/kernels/ops.py:53-59``): rows with w <= 0 are
skipped, never read, so a rejected +-inf row cannot leak 0 * inf.

:func:`weighted_sum` launches the kernel for a CUDA tensor and runs the
plain version :func:`weighted_sum_plain` for a CPU tensor.
``weighted_sum.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_N = 64


def weighted_sum_plain(w, g):
    """(n,), (n, d) -> (d,) fp32: sum over rows with w_i > 0, in row
    order, starting from the first selected term (a one-hot w returns the
    selected row's values exactly; an all-zero w returns zeros)."""
    wf = w.float()
    acc = None
    for i in torch.nonzero(wf > 0).flatten().tolist():
        t = wf[i] * g[i].float()
        acc = t if acc is None else acc + t
    if acc is None:
        return torch.zeros((g.shape[1],), dtype=torch.float32,
                           device=g.device)
    return acc


def weighted_sum(w, g):
    """w: (n,) fp32, g: (n, d) fp32 or bf16 -> (d,) fp32."""
    if g.dim() != 2 or w.shape != (g.shape[0],):
        raise ValueError(f"weighted_sum: shapes w {tuple(w.shape)}, g "
                         f"{tuple(g.shape)}")
    if not 1 <= g.shape[0] <= MAX_N:
        raise ValueError(f"weighted_sum: n={g.shape[0]} outside "
                         f"[1, {MAX_N}]")
    if g.device.type == "cpu":
        return weighted_sum_plain(w, g)
    if g.device.type != "cuda" or w.device != g.device:
        raise ValueError(f"weighted_sum: w on {w.device}, g on {g.device}")
    if g.stride(1) != 1:
        raise ValueError("weighted_sum: rows must be contiguous")
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError("weighted_sum: w must be contiguous float32")
    code = build.dtype_code(g)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_weighted_sum(w.data_ptr(), g.data_ptr(), code,
                                     out.data_ptr(), n, d, g.stride(0),
                                     build.stream_ptr(g))
    build.check(rc, "weighted_sum")
    weighted_sum.launches += 1
    return out


weighted_sum.launches = 0
