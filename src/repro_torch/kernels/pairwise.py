"""K2 and K6: the Gram matrix of the agent-gradient stack, plain and of
the mean-imputed stack.

* K2 :func:`gram` replaces the Pallas TPU kernel
  ``repro/kernels/pairwise.py:gram`` with the CUDA kernel ``csrc/gram.cu``:
  one template for every n up to 64 on the fp64 tensor cores (n padded to
  8-row blocks, the upper-triangle blocks only), each lane streaming
  16-byte vectors of its row into the fragments; a persistent grid, one
  contiguous column range and one fp64 partial per block, the partials
  summed in a fixed order (no atomics: runs repeat bit for bit, the Gram
  is bitwise symmetric).
* K6 :func:`masked_gram` replaces ``repro/kernels/pairwise.py:masked_gram``
  with ``csrc/masked_gram.cu``: K2's kernel with an imputing load (the
  lanes of an absent row stream the (d,) imputed mean instead), so the
  (n, d) imputed stack is never built and an absent row is never read.
* :func:`imputed_mean` — that (d,) mean, computed once and shared with K7.
  The JAX package computes it outside any kernel; here it goes through
  K4, which reads the arena in its own dtype and skips rows of weight 0
  (an fp32 (n, P) temporary would cost 4 GB at model width).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.wsum import weighted_sum

MAX_N = 64


def gram_plain(g):
    """(n, d) -> (n, n) fp32 Gram, summed in fp64 and rounded once.

    fp64 because an fp32 sum over the ~1e8 coordinates of a model drifts
    by more than the 3e-6 bar the kernel is held to; the kernel keeps its
    running sums in fp64 for the same reason.  The upper triangle is
    mirrored, as the kernel mirrors it, so the Gram is bitwise symmetric:
    the iterative selection's pair tie (K10) relies on d2(i, j) ==
    d2(j, i)."""
    x = g.double()
    gr = (x @ x.T).float()
    return torch.triu(gr) + torch.triu(gr, 1).T


def _check(name, g):
    if g.dim() != 2:
        raise ValueError(f"{name}: need an (n, d) stack, got "
                         f"{tuple(g.shape)}")
    if not 1 <= g.shape[0] <= MAX_N:
        raise ValueError(f"{name}: n={g.shape[0]} outside [1, {MAX_N}]")


def _cuda_scratch(name, g):
    """(code, blocks, partial, out) of a Gram launch on the card."""
    if g.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous")
    n, d = g.shape
    code = build.dtype_code(g)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    blocks = build.lib().rt_gram_scratch_blocks(n, code, d, sms)
    partial = torch.empty((blocks, n, n), dtype=torch.float64,
                          device=g.device)
    out = torch.empty((n, n), dtype=torch.float32, device=g.device)
    return code, blocks, partial, out


def gram(g):
    """g: (n, d) fp32 or bf16 -> (n, n) fp32 Gram."""
    _check("gram", g)
    if g.device.type == "cpu":
        return gram_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {g.device}")
    code, blocks, partial, out = _cuda_scratch("gram", g)
    n, d = g.shape
    rc = build.lib().rt_gram(g.data_ptr(), code, partial.data_ptr(),
                             out.data_ptr(), n, d, g.stride(0), blocks,
                             build.stream_ptr(g))
    build.check(rc, "gram")
    gram.launches += 1
    return out


gram.launches = 0


def imputed_mean(g, wn):
    """(d,) in g's dtype: the fp32 weighted mean ``sum_i wn_i g_i`` of the
    arrived rows (wn is 0 elsewhere), rounded to g's dtype — the value K6
    and K7 put in place of an absent row.  Computed by K4 (rows with
    wn <= 0 are never read) as the fused multiply-add chain of
    :func:`ref.imputed_mean_ref`, the jitted JAX step's arithmetic."""
    return weighted_sum(wn.float().contiguous(), g).to(g.dtype)


def masked_gram_plain(g, mask, wn, mean):
    """(n, n) fp32 Gram of ``where(mask, g, mean)``, summed in fp64."""
    live = (mask.float() > 0.5)[:, None]
    return gram_plain(torch.where(live, g, mean.to(g.dtype)[None]))


def masked_gram(g, mask, wn, mean=None):
    """g: (n, d) fp32 or bf16, mask: (n,) {0,1} fp32 (1 = arrived), wn: (n,)
    normalized weights -> (n, n) fp32 Gram of the mean-imputed stack.
    ``mean``: the (d,) :func:`imputed_mean` (computed here when None —
    pass it in to share one mean across the Krum pipeline)."""
    _check("masked_gram", g)
    if mask.shape != (g.shape[0],):
        raise ValueError(f"masked_gram: mask {tuple(mask.shape)} for "
                         f"{g.shape[0]} rows")
    if mean is None:
        mean = imputed_mean(g, wn)
    if mean.shape != (g.shape[1],) or mean.dtype != g.dtype:
        raise ValueError(f"masked_gram: mean {tuple(mean.shape)} "
                         f"{mean.dtype} for a stack {tuple(g.shape)} "
                         f"{g.dtype}")
    if g.device.type == "cpu":
        return masked_gram_plain(g, mask, wn, mean)
    if g.device.type != "cuda" or {mask.device, mean.device} != {g.device}:
        raise ValueError(f"masked_gram: g on {g.device}, mask on "
                         f"{mask.device}, mean on {mean.device}")
    if mask.dtype != torch.float32 or not mask.is_contiguous():
        raise ValueError("masked_gram: mask must be contiguous float32")
    if not mean.is_contiguous():
        raise ValueError("masked_gram: mean must be contiguous")
    code, blocks, partial, out = _cuda_scratch("masked_gram", g)
    n, d = g.shape
    rc = build.lib().rt_masked_gram(
        g.data_ptr(), code, mask.data_ptr(), mean.data_ptr(),
        partial.data_ptr(), out.data_ptr(), n, d, g.stride(0), blocks,
        build.stream_ptr(g))
    build.check(rc, "masked_gram")
    masked_gram.launches += 1
    return out


masked_gram.launches = 0
