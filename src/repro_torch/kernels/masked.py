"""K5, K15 and K16: the coordinate-wise rules over the ARRIVED rows, and
signSGD's majority vote.

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
  a NaN there cannot leak, ROADMAP.md P10).

Each wrapper runs its plain version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; ``<wrapper>.launches`` counts kernel
launches.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.filters.dense import nan_sign
from repro_torch.kernels import build
from repro_torch.kernels.coord_stats import STATS, _sort_network
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
    """g: (n, d) fp32 or bf16 -> (d,) fp32 majority vote in {-1, 0, +1}
    (NaN where a value is NaN)."""
    _check_vote("sign_vote", g)
    if g.device.type == "cpu":
        return sign_vote_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"sign_vote: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError("sign_vote: rows must be contiguous")
    n, d = g.shape
    out = torch.empty((d,), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_sign_vote(g.data_ptr(), build.dtype_code(g),
                                  out.data_ptr(), n, d, g.stride(0),
                                  build.stream_ptr(g))
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
