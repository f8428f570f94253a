"""K2: the Gram matrix of the agent-gradient stack.

Replaces the Pallas TPU kernel ``repro/kernels/pairwise.py:gram`` with the
CUDA kernel ``csrc/gram.cu`` (split over d, fp64 running sums, partials
summed in a fixed order: no atomics, runs repeat bit for bit).

:func:`gram` launches the kernel for a CUDA tensor and runs the plain
version :func:`gram_plain` for a CPU tensor.  ``gram.launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_N = 64
TD = 128                 # columns per tile (csrc/gram.cu kTD)
BLOCKS_PER_SM = 8


def gram_plain(g):
    """(n, d) -> (n, n) fp32 Gram, summed in fp64 and rounded once.

    fp64 because an fp32 sum over the ~1e8 coordinates of a model drifts
    by more than the 3e-6 bar the kernel is held to; the kernel keeps its
    running sums in fp64 for the same reason."""
    x = g.double()
    return (x @ x.T).float()


def gram(g):
    """g: (n, d) fp32 or bf16 -> (n, n) fp32 Gram."""
    if g.dim() != 2:
        raise ValueError(f"gram: need an (n, d) stack, got {tuple(g.shape)}")
    n, d = g.shape
    if not 1 <= n <= MAX_N:
        raise ValueError(f"gram: n={n} outside [1, {MAX_N}]")
    if g.device.type == "cpu":
        return gram_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"gram: unsupported device {g.device}")
    if g.stride(1) != 1:
        raise ValueError("gram: rows must be contiguous")
    code = build.dtype_code(g)
    sms = torch.cuda.get_device_properties(g.device).multi_processor_count
    blocks = max(1, min((d + TD - 1) // TD, sms * BLOCKS_PER_SM))
    partial = torch.empty((blocks, n, n), dtype=torch.float64,
                          device=g.device)
    out = torch.empty((n, n), dtype=torch.float32, device=g.device)
    rc = build.lib().rt_gram(g.data_ptr(), code, partial.data_ptr(),
                             out.data_ptr(), n, d, g.stride(0), blocks,
                             build.stream_ptr(g))
    build.check(rc, "gram")
    gram.launches += 1
    return out


gram.launches = 0
