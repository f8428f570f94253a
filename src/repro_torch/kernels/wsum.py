"""K4, K7 and K11: the weighted sum w^T G over the agent axis, plain and
over the mean-imputed stack, and the ordered application of a selection.

* K4 :func:`weighted_sum` replaces the Pallas TPU kernel
  ``repro/kernels/wsum.py:weighted_sum`` with the CUDA kernel
  ``csrc/wsum.cu``, which also fuses the caller's ``_drop_unselected``
  (``repro/kernels/ops.py:53-59``): rows with w <= 0 are skipped, never
  read, so a rejected +-inf row cannot leak 0 * inf.
* K7 :func:`masked_weighted_sum` replaces
  ``repro/kernels/wsum.py:masked_weighted_sum`` with
  ``csrc/masked_wsum.cu``: live rows with w > 0 are read raw, and the
  ghost weight (the absent rows' total) multiplies the (d,) imputed mean,
  so the imputed stack is never built.
* K11 :func:`ordered_apply` replaces ``repro/kernels/wsum.py:ordered_apply``
  with ``csrc/ordered_apply.cu``: the k rows a selection order picked,
  summed in pick order and divided (multi-Krum, m-Krum, MDA); the other
  rows are never read.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

MAX_N = 64


def weighted_sum_plain(w, g):
    """(n,), (n, d) -> (d,) fp32: the fused multiply-add chain over rows
    with w_i > 0, in row order (:func:`ref.fma_weighted_sum`; a one-hot w
    returns the selected row's values exactly; an all-zero w returns
    zeros)."""
    return ref.fma_weighted_sum(w, g)


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


def masked_weighted_sum_plain(w, g, mask, mean):
    """(n,), (n, d), (n,), (d,) -> (d,) fp32: the fused multiply-add chain
    over the live rows with w_i > 0, in row order, then one more fused
    step with the ghost weight (the absent rows' w, summed in row order)
    and the mean, only when that weight is > 0."""
    wf = w.float()
    live = mask.float() > 0.5
    acc = ref.fma_weighted_sum(torch.where(live, wf, 0.0), g)
    ghost = torch.zeros((), dtype=torch.float32, device=g.device)
    for i in torch.nonzero(~live).flatten().tolist():
        ghost = ghost + wf[i]
    if float(ghost) > 0:
        any_live = bool((wf * live > 0).any())
        acc = ref.fma_f32(ghost, mean, acc if any_live else None)
    return acc


def masked_weighted_sum(w, g, mask, mean):
    """w: (n,) fp32 NON-NEGATIVE weights, g: (n, d) fp32 or bf16, mask:
    (n,) {0,1} fp32 (1 = arrived), mean: (d,) imputed mean in g's dtype
    -> (d,) fp32 weighted sum over the mean-imputed stack.

    ``w >= 0`` is the caller's precondition, as in the JAX kernel: the
    kernel gates rows on w > 0, so a negative weight would be dropped, not
    subtracted.  The plain version (a CPU tensor) refuses one; on the card
    the check would cost a host sync, and the one caller (Krum's one-hot
    from K3) is {0,1} by construction."""
    if g.dim() != 2 or w.shape != (g.shape[0],) or mask.shape != w.shape:
        raise ValueError(f"masked_weighted_sum: shapes w {tuple(w.shape)}, "
                         f"g {tuple(g.shape)}, mask {tuple(mask.shape)}")
    if not 1 <= g.shape[0] <= MAX_N:
        raise ValueError(f"masked_weighted_sum: n={g.shape[0]} outside "
                         f"[1, {MAX_N}]")
    if mean.shape != (g.shape[1],) or mean.dtype != g.dtype:
        raise ValueError(f"masked_weighted_sum: mean {tuple(mean.shape)} "
                         f"{mean.dtype} for a stack {tuple(g.shape)} "
                         f"{g.dtype}")
    if g.device.type == "cpu":
        if bool(torch.any(w < 0)):
            raise ValueError("masked_weighted_sum: weights must be >= 0 (a "
                             "negative weight would be dropped, not "
                             "subtracted)")
        return masked_weighted_sum_plain(w, g, mask, mean)
    if g.device.type != "cuda" or {w.device, mask.device,
                                   mean.device} != {g.device}:
        raise ValueError(f"masked_weighted_sum: w on {w.device}, g on "
                         f"{g.device}, mask on {mask.device}, mean on "
                         f"{mean.device}")
    if g.stride(1) != 1 or not mean.is_contiguous():
        raise ValueError("masked_weighted_sum: rows and mean must be "
                         "contiguous")
    for name, t in (("w", w), ("mask", mask)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"masked_weighted_sum: {name} must be "
                             "contiguous float32")
    code = build.dtype_code(g)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_masked_weighted_sum(
        w.data_ptr(), g.data_ptr(), code, mask.data_ptr(), mean.data_ptr(),
        out.data_ptr(), n, d, g.stride(0), build.stream_ptr(g))
    build.check(rc, "masked_weighted_sum")
    masked_weighted_sum.launches += 1
    return out


masked_weighted_sum.launches = 0


def ordered_apply_plain(order, g, k: int, div: float | None = None):
    """(n,) int order, (n, d) -> (d,) fp32: the row picked at each position
    r < k (the first row carrying r; none adds nothing) added in pick
    order from 0, then divided by ``div`` (by a tensor, so that the card
    divides too: a Python-scalar divisor becomes a reciprocal multiply
    there)."""
    acc = torch.zeros((g.shape[1],), dtype=torch.float32, device=g.device)
    for r in range(k):
        hit = order == r
        row = g.index_select(0, torch.argmax(hit.int()).reshape(1))[0]
        acc = acc + torch.where(hit.any(), row.float(), 0.0)
    if div is not None:
        acc = acc / torch.tensor(float(div), device=g.device)
    return acc


def ordered_apply(order, g, k: int, div: float | None = None):
    """order: (n,) int32 pick order (a position >= k is not picked, each
    position at most once), g: (n, d) fp32 or bf16 -> (d,) fp32: the k
    picked rows summed in pick order, divided by ``div`` (None = no
    division)."""
    if g.dim() != 2 or order.shape != (g.shape[0],):
        raise ValueError(f"ordered_apply: shapes order {tuple(order.shape)},"
                         f" g {tuple(g.shape)}")
    n, d = g.shape
    if not 1 <= n <= MAX_N or not 0 <= k <= n:
        raise ValueError(f"ordered_apply: n={n}, k={k} outside n in [1, "
                         f"{MAX_N}], k in [0, n]")
    if div is not None and not div > 0:
        raise ValueError(f"ordered_apply: div={div} must be > 0")
    if g.device.type == "cpu":
        return ordered_apply_plain(order, g, k, div)
    if g.device.type != "cuda" or order.device != g.device:
        raise ValueError(f"ordered_apply: order on {order.device}, g on "
                         f"{g.device}")
    if g.stride(1) != 1:
        raise ValueError("ordered_apply: rows must be contiguous")
    if order.dtype != torch.int32 or not order.is_contiguous():
        raise ValueError("ordered_apply: order must be contiguous int32")
    code = build.dtype_code(g)
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_ordered_apply(
        order.data_ptr(), g.data_ptr(), code, out.data_ptr(), n, d,
        g.stride(0), int(k), float(div or 0.0), build.stream_ptr(g))
    build.check(rc, "ordered_apply")
    ordered_apply.launches += 1
    return out


ordered_apply.launches = 0
