"""K4, K7, K11 and K12: the weighted sum w^T G over the agent axis, and
the ordered application of a selection, each plain and over the
mean-imputed stack; K17 and K21: sparse_mean's per-coordinate weighted
mean over the rows that sent each coordinate.

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
* K12 :func:`masked_ordered_apply` replaces
  ``repro/kernels/wsum.py:masked_ordered_apply`` with K11's kernel under
  its ``IMPUTE`` switch: a picked absent (ghost) row adds the (d,) imputed
  mean instead (masked multi-Krum, m-Krum, MDA); no absent row is read.
* K17 :func:`sparse_masked_weighted_mean` replaces
  ``repro/kernels/wsum.py:sparse_masked_weighted_mean`` with
  ``csrc/sparse_wmean.cu``: each coordinate averaged over the live rows
  that sent it (x != 0), weighted by the raw row weights, an exact 0
  where nobody sent it (sparse_mean, sync and masked).
* K21 :func:`scaled_sparse_masked_weighted_mean` replaces
  ``repro/kernels/wsum.py:scaled_sparse_masked_weighted_mean`` with a
  kernel of its own in the same file: int8 / fp8 codes read 8 bytes a
  row at a time and dequantized exactly in registers (the compressed
  exchange).
* K22 :func:`clipped_weighted_sum` replaces
  ``repro/kernels/wsum.py:clipped_weighted_sum`` with
  ``csrc/clipped_wsum.cu``: one centered-clip step, (1 - sum lam) v +
  sum_{lam_i > 0} lam_i g_i; a row with lam_i = 0 is never read.

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
    the check would cost a host sync, and the callers' weights are non-
    negative by construction: Krum's one-hot from K3, CGE's keep-set, and
    the coded decode's 1/k on each group winner
    (``core.redundancy.coding.flat_draco_aggregate``)."""
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
    return masked_ordered_apply_plain(order, g, None, None, k, div)


def masked_ordered_apply_plain(order, g, mask, mean, k: int,
                               div: float | None = None):
    """:func:`ordered_apply_plain` over the mean-imputed stack: a picked
    row with mask <= 0.5 adds ``mean`` (upcast) in place of its own
    values, which are selected away, never added (``mask=None``: every
    row arrived)."""
    acc = torch.zeros((g.shape[1],), dtype=torch.float32, device=g.device)
    for r in range(k):
        hit = order == r
        i = torch.argmax(hit.int()).reshape(1)
        row = g.index_select(0, i)[0].float()
        if mask is not None:
            live = mask.float().index_select(0, i)[0] > 0.5
            row = torch.where(live, row, mean.float())
        acc = acc + torch.where(hit.any(), row, 0.0)
    if div is not None:
        acc = acc / torch.tensor(float(div), device=g.device)
    return acc


def _check_ordered(name, order, g, k, div):
    if g.dim() != 2 or order.shape != (g.shape[0],):
        raise ValueError(f"{name}: shapes order {tuple(order.shape)}, g "
                         f"{tuple(g.shape)}")
    n = g.shape[0]
    if not 1 <= n <= MAX_N or not 0 <= k <= n:
        raise ValueError(f"{name}: n={n}, k={k} outside n in [1, {MAX_N}], "
                         "k in [0, n]")
    if div is not None and not div > 0:
        raise ValueError(f"{name}: div={div} must be > 0")


def _check_ordered_cuda(name, order, g):
    if g.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    if order.dtype != torch.int32 or not order.is_contiguous():
        raise ValueError(f"{name}: order must be contiguous int32")


def ordered_apply(order, g, k: int, div: float | None = None):
    """order: (n,) int32 pick order (a position >= k is not picked, each
    position at most once), g: (n, d) fp32 or bf16 -> (d,) fp32: the k
    picked rows summed in pick order, divided by ``div`` (None = no
    division)."""
    _check_ordered("ordered_apply", order, g, k, div)
    if g.device.type == "cpu":
        return ordered_apply_plain(order, g, k, div)
    if g.device.type != "cuda" or order.device != g.device:
        raise ValueError(f"ordered_apply: order on {order.device}, g on "
                         f"{g.device}")
    _check_ordered_cuda("ordered_apply", order, g)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_ordered_apply(
        order.data_ptr(), g.data_ptr(), build.dtype_code(g), out.data_ptr(),
        n, d, g.stride(0), int(k), float(div or 0.0), build.stream_ptr(g))
    build.check(rc, "ordered_apply")
    ordered_apply.launches += 1
    return out


ordered_apply.launches = 0


def masked_ordered_apply(order, g, mask, mean, k: int,
                         div: float | None = None):
    """:func:`ordered_apply` over the mean-imputed stack.  mask: (n,)
    {0,1} fp32 (1 = arrived), mean: the (d,) imputed mean in g's dtype;
    a picked absent row contributes exactly the mean (upcast) and is
    never read."""
    _check_ordered("masked_ordered_apply", order, g, k, div)
    if mask.shape != order.shape:
        raise ValueError(f"masked_ordered_apply: mask {tuple(mask.shape)} "
                         f"for {g.shape[0]} rows")
    if mean.shape != (g.shape[1],) or mean.dtype != g.dtype:
        raise ValueError(f"masked_ordered_apply: mean {tuple(mean.shape)} "
                         f"{mean.dtype} for a stack {tuple(g.shape)} "
                         f"{g.dtype}")
    if g.device.type == "cpu":
        return masked_ordered_apply_plain(order, g, mask, mean, k, div)
    if g.device.type != "cuda" or {order.device, mask.device,
                                   mean.device} != {g.device}:
        raise ValueError(f"masked_ordered_apply: order on {order.device}, g "
                         f"on {g.device}, mask on {mask.device}, mean on "
                         f"{mean.device}")
    _check_ordered_cuda("masked_ordered_apply", order, g)
    if mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError("masked_ordered_apply: mask must be contiguous "
                         "float32")
    if not mean.is_contiguous():
        raise ValueError("masked_ordered_apply: mean must be contiguous")
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_masked_ordered_apply(
        order.data_ptr(), g.data_ptr(), build.dtype_code(g), mask.data_ptr(),
        mean.data_ptr(), out.data_ptr(), n, d, g.stride(0), int(k),
        float(div or 0.0), build.stream_ptr(g))
    build.check(rc, "masked_ordered_apply")
    masked_ordered_apply.launches += 1
    return out


masked_ordered_apply.launches = 0


# ---------------------------------------------------------------------------
# K17 sparse_masked_weighted_mean, K21 scaled_sparse_masked_weighted_mean


def sparse_masked_weighted_mean_plain(g, mask, w, scale=None):
    """(n, d), (n,), (n,) -> (d,) fp32, the plain version of K17 (and, with
    ``scale``, of K21: row i decodes as ``g[i].float() * scale[i]``).
    Over the live rows (mask > 0.5) in row order: cw = w_i where the
    decoded value is != 0, else 0; num += where(cw > 0, x, 0) * cw and
    den += cw, each product and each sum rounded on its own (the kernel's
    __fmul_rn / __fadd_rn); then num / den, an exact 0 where den is 0.
    An absent row is never read."""
    num = torch.zeros((g.shape[1],), dtype=torch.float32, device=g.device)
    den = torch.zeros_like(num)
    wf = w.float()
    for i in torch.nonzero(mask.float() > 0.5).flatten().tolist():
        x = g[i].float()
        if scale is not None:
            x = x * scale[i]
        cw = torch.where(x != 0, wf[i], 0.0)
        num = num + torch.where(cw > 0, x, 0.0) * cw
        den = den + cw
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)


def scaled_sparse_masked_weighted_mean_plain(g, scale, mask, w):
    """The plain version of K21: K17's on the decoded rows (the decoded
    value decides "sent": an inf row's 0 codes decode to 0 * inf = NaN,
    which is sent and poisons its column)."""
    return sparse_masked_weighted_mean_plain(g, mask, w, scale)


def _check_sparse(name, g, mask, w, scale=None):
    """Shapes, dtypes and devices of K17's / K21's operands; returns the
    csrc dtype code of ``g`` (a float arena, or codes with ``scale``)."""
    code = build.dtype_code(g, build.FLOAT_CODES if scale is None
                            else build.QUANT_CODES)
    if g.dim() != 2 or mask.shape != (g.shape[0],) or w.shape != mask.shape:
        raise ValueError(f"{name}: shapes g {tuple(g.shape)}, mask "
                         f"{tuple(mask.shape)}, w {tuple(w.shape)}")
    n = g.shape[0]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: n={n} outside [1, {MAX_N}]")
    ops = (mask, w) if scale is None else (scale, mask, w)
    if scale is not None and scale.shape != (n,):
        raise ValueError(f"{name}: scale must be ({n},), got "
                         f"{tuple(scale.shape)}")
    if any(t.device != g.device for t in ops):
        raise ValueError(f"{name}: g on {g.device}, an operand on "
                         f"{[str(t.device) for t in ops]}")
    if g.device.type == "cpu":
        return code
    if g.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in ops):
        raise ValueError(f"{name}: mask, w (and scale) must be contiguous "
                         "float32")
    return code


def sparse_masked_weighted_mean(g, mask, w):
    """g: (n, d) fp32 or bf16, mask: (n,) {0,1} fp32 (1 = live), w: (n,)
    fp32 raw row weights (any positive scaling: the law is scale-
    invariant) -> (d,) fp32: each coordinate averaged over the live rows
    that sent it (x != 0), weighted by w; an exact 0 where nobody did."""
    code = _check_sparse("sparse_masked_weighted_mean", g, mask, w)
    if g.device.type == "cpu":
        return sparse_masked_weighted_mean_plain(g, mask, w)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_sparse_masked_weighted_mean(
        g.data_ptr(), code, mask.data_ptr(), w.data_ptr(), out.data_ptr(), n,
        d, g.stride(0), build.stream_ptr(g))
    build.check(rc, "sparse_masked_weighted_mean")
    sparse_masked_weighted_mean.launches += 1
    return out


def scaled_sparse_masked_weighted_mean(g, scale, mask, w):
    """g: (n, d) int8 or float8_e4m3fn codes, scale: (n,) fp32 row scales,
    mask and w as :func:`sparse_masked_weighted_mean` -> (d,) fp32: its
    law on the decoded rows, dequantized in registers."""
    code = _check_sparse("scaled_sparse_masked_weighted_mean", g, mask, w,
                         scale)
    if g.device.type == "cpu":
        return scaled_sparse_masked_weighted_mean_plain(g, scale, mask, w)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_scaled_sparse_masked_weighted_mean(
        g.data_ptr(), code, scale.data_ptr(), mask.data_ptr(), w.data_ptr(),
        out.data_ptr(), n, d, g.stride(0), build.stream_ptr(g))
    build.check(rc, "scaled_sparse_masked_weighted_mean")
    scaled_sparse_masked_weighted_mean.launches += 1
    return out


sparse_masked_weighted_mean.launches = 0
scaled_sparse_masked_weighted_mean.launches = 0


# ---------------------------------------------------------------------------
# K22 clipped_weighted_sum


def clipped_weighted_sum_plain(lam, g, v):
    """(n,), (n, d), (d,) -> (d,) fp32, the plain version of K22, in the
    kernel's order: ``s = sum lam_i`` over every row in row order, each
    sum rounded on its own; the fused multiply-add chain over the rows
    with lam_i > 0 in row order from the first rounded product
    (:func:`ref.fma_weighted_sum`; the other rows are never read); then
    one more fused step, ``fma(1 - s, v, acc)``."""
    lam = lam.float()
    s = torch.zeros((), dtype=torch.float32, device=g.device)
    for i in range(lam.shape[0]):
        s = s + lam[i]
    acc = ref.fma_weighted_sum(lam, g)
    return ref.fma_f32(1.0 - s, v.float(), acc)


def clipped_weighted_sum(lam, g, v):
    """lam: (n,) fp32 NON-NEGATIVE clip-folded weights, g: (n, d) fp32 or
    bf16 rows, v: (d,) fp32 current center -> (d,) fp32 updated center
    ``v + sum_i lam_i (g_i - v) = (1 - sum lam) v + sum lam_i g_i``, the
    application stage of one centered-clipping iteration.  ``lam >= 0``
    is the caller's precondition, as in the JAX kernel: a row is gated on
    lam_i > 0, so a negative weight would be dropped from the product
    (and still counted in sum lam)."""
    if (g.dim() != 2 or lam.shape != (g.shape[0],)
            or v.shape != (g.shape[1],)):
        raise ValueError(f"clipped_weighted_sum: shapes lam "
                         f"{tuple(lam.shape)}, g {tuple(g.shape)}, v "
                         f"{tuple(v.shape)}")
    if not 1 <= g.shape[0] <= MAX_N:
        raise ValueError(f"clipped_weighted_sum: n={g.shape[0]} outside "
                         f"[1, {MAX_N}]")
    if v.dtype != torch.float32:
        raise ValueError(f"clipped_weighted_sum: v must be float32, got "
                         f"{v.dtype}")
    code = build.dtype_code(g)
    if g.device.type == "cpu":
        if lam.device != g.device or v.device != g.device:
            raise ValueError(f"clipped_weighted_sum: lam on {lam.device}, "
                             f"g on {g.device}, v on {v.device}")
        return clipped_weighted_sum_plain(lam, g, v)
    if g.device.type != "cuda" or {lam.device, v.device} != {g.device}:
        raise ValueError(f"clipped_weighted_sum: lam on {lam.device}, g on "
                         f"{g.device}, v on {v.device}")
    if g.stride(1) != 1 or not v.is_contiguous():
        raise ValueError("clipped_weighted_sum: rows and v must be "
                         "contiguous")
    if lam.dtype != torch.float32 or not lam.is_contiguous():
        raise ValueError("clipped_weighted_sum: lam must be contiguous "
                         "float32")
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_clipped_weighted_sum(
        lam.data_ptr(), g.data_ptr(), code, v.data_ptr(), out.data_ptr(), n,
        d, g.stride(0), build.stream_ptr(g))
    build.check(rc, "clipped_weighted_sum")
    clipped_weighted_sum.launches += 1
    return out


clipped_weighted_sum.launches = 0
