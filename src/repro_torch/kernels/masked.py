"""K5, K15, K16 and K18-K20: the coordinate-wise rules over the ARRIVED
rows, signSGD's majority vote, and both over a quantized arena.

* K5 :func:`masked_coord_stat` replaces the Pallas TPU kernel
  ``repro/kernels/masked.py:masked_coord_stat`` with the CUDA kernel
  ``csrc/masked_coord_stat.cu``.  The law is the masked engine's for the
  coordinate-wise rules: absent rows are +inf sentinels in the
  per-coordinate sort, and the kept rank window follows the arrived count
  (:func:`repro_torch.kernels.ref.arrived_window`), which the kernel
  derives from the (n,) mask on the card.
* K15 :func:`sign_vote` and K16 :func:`masked_sign_vote` replace
  ``masked.py:sign_vote`` and ``masked_sign_vote`` with ``csrc/
  sign_vote.cu``: sign(sum_i sign(g_i)) per coordinate, over every row or
  over the arrived rows only (absent rows cast no vote, and are not read:
  a NaN there cannot leak, ROADMAP.md P10).  K15 also votes on int8 /
  fp8 codes: the synchronous compressed sign_sgd reads the codes as they
  are (a scale > 0 changes no sign).
* K18 :func:`scaled_coord_stat`, K19 :func:`scaled_masked_coord_stat` and
  K20 :func:`scaled_masked_sign_vote` replace ``masked.py:
  scaled_coord_stat``, ``scaled_masked_coord_stat`` and
  ``scaled_masked_sign_vote``: K1, K5 and K16 over a quantized arena,
  (n, d) int8 / float8_e4m3fn codes and an (n,) fp32 scale per row
  (:func:`repro_torch.core.flat.quantize_rows`), dequantized inside the
  kernel (``csrc/scaled_coord_stat.cu``, ``csrc/
  scaled_masked_coord_stat.cu``, ``csrc/sign_vote.cu``) with
  :func:`~repro_torch.core.flat.dequantize_rows`' one multiply, so the
  dequantized (n, d) stack is never made.  Their plain versions run the
  plain K1 / K5 / K16 on ``dequantize_rows(codes, scale)``.

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; ``<wrapper>.launches`` counts kernel
launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.filters.dense import nan_sign
from repro_torch.core.flat import dequantize_rows
from repro_torch.kernels import build
from repro_torch.kernels.coord_stats import (STATS, _check as _check_stat,
                                             _sort_network, coord_stat_plain)
from repro_torch.kernels.ref import arrived_window, masked_sign_vote_ref

MAX_N = 64


def masked_coord_stat_plain(g, mask, wn, stat: str, b: int = 0):
    """(n, d) any float -> (d,) fp32: the plain version of the kernel.
    The sentinel rows go through K1's network (torch.minimum / maximum
    spread a NaN of an arrived row as the TPU kernel's network does), and
    the window's ranks are summed in ascending order from 0, each
    selected with a where.  ``wn`` is unused, as in the JAX kernel."""
    n = g.shape[0]
    live = mask.float() > 0.5
    inf = torch.full((), math.inf, device=g.device)
    rows = _sort_network(torch.where(live[i], g[i].float(), inf)
                         for i in range(n))
    keep, width, cnt = arrived_window(mask, n, stat, b)
    zero = torch.zeros((), device=g.device)
    acc = torch.zeros_like(rows[0])
    for i in range(n):
        acc = acc + torch.where(keep[i], rows[i], zero)
    return torch.where(cnt > 0, acc / width, zero)


def _check(g, mask, stat, b):
    if stat not in STATS:
        raise KeyError(f"masked_coord_stat: unknown stat {stat!r}")
    if g.dim() != 2 or mask.shape != (g.shape[0],):
        raise ValueError(f"masked_coord_stat: shapes g {tuple(g.shape)}, "
                         f"mask {tuple(mask.shape)}")
    if not 1 <= g.shape[0] <= MAX_N:
        raise ValueError(f"masked_coord_stat: n={g.shape[0]} outside "
                         f"[1, {MAX_N}]")
    if b < 0:
        raise ValueError(f"masked_coord_stat: trim b={b} < 0")


def masked_coord_stat(g, mask, wn, stat: str, b: int = 0):
    """g: (n, d) fp32 or bf16, mask: (n,) {0,1} fp32 (1 = arrived), wn:
    (n,) normalized weights (unused: the engine scales outside) -> (d,)
    fp32 statistic over the arrived rows (``median``, or ``trimmed_mean``
    with per-side trim ``b``, clamped to the arrived count)."""
    _check(g, mask, stat, b)
    if g.device.type == "cpu":
        return masked_coord_stat_plain(g, mask, wn, stat, b)
    if g.device.type != "cuda" or mask.device != g.device:
        raise ValueError(f"masked_coord_stat: g on {g.device}, mask on "
                         f"{mask.device}")
    if g.stride(1) != 1:
        raise ValueError("masked_coord_stat: rows must be contiguous")
    if mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError("masked_coord_stat: mask must be contiguous "
                         "float32")
    code = build.dtype_code(g)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_masked_coord_stat(
        g.data_ptr(), code, mask.data_ptr(), out.data_ptr(), n, d,
        g.stride(0), STATS[stat], int(b), build.stream_ptr(g))
    build.check(rc, "masked_coord_stat")
    masked_coord_stat.launches += 1
    return out


masked_coord_stat.launches = 0


# ---------------------------------------------------------------------------
# K15 sign_vote, K16 masked_sign_vote


def sign_vote_plain(g):
    """(n, d) any float -> (d,) fp32: sign(sum_i sign(g_i)), the fp32 sum
    of +-1 / 0 exact in any order; a NaN value makes its column NaN."""
    return nan_sign(torch.sum(nan_sign(g.float()), dim=0))


def masked_sign_vote_plain(g, mask, wn):
    """The plain version of K16 (:func:`ref.masked_sign_vote_ref`): the
    vote of the arrived rows; ``wn`` is unused, as in the JAX kernel."""
    return masked_sign_vote_ref(g, mask)


def _check_vote(name, g, mask=None):
    if g.dim() != 2 or (mask is not None and mask.shape != (g.shape[0],)):
        raise ValueError(f"{name}: shapes g {tuple(g.shape)}" + (
            "" if mask is None else f", mask {tuple(mask.shape)}"))
    if not 1 <= g.shape[0] <= MAX_N:
        raise ValueError(f"{name}: n={g.shape[0]} outside [1, {MAX_N}]")


def sign_vote(g):
    """g: (n, d) fp32 or bf16, or int8 / fp8 codes -> (d,) fp32 majority
    vote in {-1, 0, +1} (NaN where a value is NaN)."""
    _check_vote("sign_vote", g)
    if g.device.type == "cpu":
        return sign_vote_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"sign_vote: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError("sign_vote: rows must be contiguous")
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    code = build.dtype_code(g, {**build.FLOAT_CODES, **build.QUANT_CODES})
    rc = build.lib().rt_sign_vote(g.data_ptr(), code, out.data_ptr(), n, d,
                                  g.stride(0), build.stream_ptr(g))
    build.check(rc, "sign_vote")
    sign_vote.launches += 1
    return out


def masked_sign_vote(g, mask, wn):
    """g: (n, d) fp32 or bf16, mask: (n,) {0,1} fp32 (1 = arrived), wn:
    (n,) normalized weights (unused: the engine scales outside) -> (d,)
    fp32 majority vote of the arrived rows (0 where none arrived)."""
    _check_vote("masked_sign_vote", g, mask)
    if g.device.type == "cpu":
        return masked_sign_vote_plain(g, mask, wn)
    if g.device.type != "cuda" or mask.device != g.device:
        raise ValueError(f"masked_sign_vote: g on {g.device}, mask on "
                         f"{mask.device}")
    if g.stride(1) != 1:
        raise ValueError("masked_sign_vote: rows must be contiguous")
    if mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError("masked_sign_vote: mask must be contiguous float32")
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_masked_sign_vote(g.data_ptr(), build.dtype_code(g),
                                         mask.data_ptr(), out.data_ptr(), n,
                                         d, g.stride(0), build.stream_ptr(g))
    build.check(rc, "masked_sign_vote")
    masked_sign_vote.launches += 1
    return out


sign_vote.launches = 0
masked_sign_vote.launches = 0


# ---------------------------------------------------------------------------
# K18 scaled_coord_stat, K19 scaled_masked_coord_stat, K20
# scaled_masked_sign_vote: the arena holds int8 / fp8 codes and an (n,)
# fp32 scale per row


def scaled_coord_stat_plain(g, scale, stat: str, b: int = 0):
    """The plain version of K18: K1's plain version on the dequantized
    stack."""
    return coord_stat_plain(dequantize_rows(g, scale), stat, b)


def scaled_masked_coord_stat_plain(g, scale, mask, wn, stat: str,
                                   b: int = 0):
    """The plain version of K19: K5's on the dequantized stack (an
    absent row's value is selected away, so its NaN cannot leak)."""
    return masked_coord_stat_plain(dequantize_rows(g, scale), mask, wn, stat,
                                   b)


def scaled_masked_sign_vote_plain(g, scale, mask, wn):
    """The plain version of K20: the arrived rows' vote on the dequantized
    stack (the multiply kept, as in the JAX kernel: an inf scale times a
    0 code is NaN and poisons its column)."""
    return masked_sign_vote_ref(dequantize_rows(g, scale), mask)


def _check_scaled(name, g, scale, mask=None):
    """Shapes, dtypes and devices of a scaled kernel's operands; returns
    the csrc dtype code of the codes."""
    code = build.dtype_code(g, build.QUANT_CODES)
    n = g.shape[0]
    if scale.shape != (n,) or scale.dtype != torch.float32:
        raise ValueError(f"{name}: scale must be ({n},) float32, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    for t in (scale,) + (() if mask is None else (mask,)):
        if t.device != g.device:
            raise ValueError(f"{name}: codes on {g.device}, an operand on "
                             f"{t.device}")
    if g.device.type == "cpu":
        return code
    if g.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    if not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous")
    if mask is not None and (mask.dtype != torch.float32
                             or not mask.is_contiguous()):
        raise ValueError(f"{name}: mask must be contiguous float32")
    return code


def scaled_coord_stat(g, scale, stat: str, b: int = 0):
    """g: (n, d) int8 or float8_e4m3fn codes, scale: (n,) fp32 -> (d,)
    fp32 order statistic of the dequantized stack (``median``, or
    ``trimmed_mean`` with per-side trim ``b``)."""
    _check_stat(g, stat, b)
    code = _check_scaled("scaled_coord_stat", g, scale)
    if g.device.type == "cpu":
        return scaled_coord_stat_plain(g, scale, stat, b)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_scaled_coord_stat(
        g.data_ptr(), code, scale.data_ptr(), out.data_ptr(), n, d,
        g.stride(0), STATS[stat], int(b), build.stream_ptr(g))
    build.check(rc, "scaled_coord_stat")
    scaled_coord_stat.launches += 1
    return out


def scaled_masked_coord_stat(g, scale, mask, wn, stat: str, b: int = 0):
    """g: (n, d) int8 or float8_e4m3fn codes, scale: (n,) fp32, mask: (n,)
    {0,1} fp32 (1 = arrived), wn: (n,) normalized weights (unused) ->
    (d,) fp32 statistic over the arrived rows of the dequantized stack."""
    _check(g, mask, stat, b)
    code = _check_scaled("scaled_masked_coord_stat", g, scale, mask)
    if g.device.type == "cpu":
        return scaled_masked_coord_stat_plain(g, scale, mask, wn, stat, b)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_scaled_masked_coord_stat(
        g.data_ptr(), code, scale.data_ptr(), mask.data_ptr(),
        out.data_ptr(), n, d, g.stride(0), STATS[stat], int(b),
        build.stream_ptr(g))
    build.check(rc, "scaled_masked_coord_stat")
    scaled_masked_coord_stat.launches += 1
    return out


def scaled_masked_sign_vote(g, scale, mask, wn):
    """g: (n, d) int8 or float8_e4m3fn codes, scale: (n,) fp32, mask: (n,)
    {0,1} fp32 (1 = arrived), wn: (n,) normalized weights (unused) ->
    (d,) fp32 majority vote of the arrived rows' dequantized values."""
    _check_vote("scaled_masked_sign_vote", g, mask)
    code = _check_scaled("scaled_masked_sign_vote", g, scale, mask)
    if g.device.type == "cpu":
        return scaled_masked_sign_vote_plain(g, scale, mask, wn)
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_scaled_masked_sign_vote(
        g.data_ptr(), code, scale.data_ptr(), mask.data_ptr(),
        out.data_ptr(), n, d, g.stride(0), build.stream_ptr(g))
    build.check(rc, "scaled_masked_sign_vote")
    scaled_masked_sign_vote.launches += 1
    return out


scaled_coord_stat.launches = 0
scaled_masked_coord_stat.launches = 0
scaled_masked_sign_vote.launches = 0
