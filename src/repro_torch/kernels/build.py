"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Route: ``nvcc`` straight into one shared library with a plain C interface,
loaded with ``ctypes``.  The build happens at first use, from the sources
in this checkout only: one ``nvcc -c`` per source, all started together,
then one link.  The library lands in ``<repo>/build/repro_torch_kernels/
<hash>/`` (``build/`` is git-ignored), keyed on a hash of the sources and
flags, so a changed source rebuilds and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module on a
host with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

F32, BF16, I8, F8 = 0, 1, 2, 3      # dtype codes of csrc/common.cuh
FLOAT_CODES = {torch.float32: F32, torch.bfloat16: BF16}
# the codes of a quantized arena (core.flat.quantize_rows)
QUANT_CODES = {torch.int8: I8, torch.float8_e4m3fn: F8}

_LIB = None
BUILD_INFO: dict = {}


def build_root() -> Path:
    """``<repo>/build/repro_torch_kernels`` for a source checkout."""
    return (Path(__file__).resolve().parents[3] / "build"
            / "repro_torch_kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    cus, hdrs = _sources()
    for p in cus + hdrs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def build() -> Path:
    """Compile the library if this source hash has none yet; returns its
    path.  Records wall time and ptxas output in ``BUILD_INFO``."""
    out_dir = build_root() / _digest()
    lib = out_dir / "libkernels.so"
    if lib.exists():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    t0 = time.time()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for cu in cus:
            obj = Path(tmp) / (cu.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-I", str(CSRC), "-c", str(cu),
                   "-o", str(obj)]
            procs.append((cu, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for cu, obj, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {cu.name}\n{text}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {cu.name}:\n{text}")
        tmp_lib = Path(tmp) / "libkernels.so"
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (out_dir / "ptxas.log").write_text("\n".join(logs))
        os.replace(tmp_lib, lib)            # atomic: readers never see half
    BUILD_INFO.update(seconds=time.time() - t0, cached=False,
                      path=str(lib))
    return lib


def lib():
    """The loaded kernel library (built on first call), argtypes set."""
    global _LIB
    if _LIB is None:
        L = ctypes.CDLL(str(build()))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        L.rt_coord_stat.argtypes = [vp, i32, vp, i32, i64, i64, i32, i32, vp]
        L.rt_gram.argtypes = [vp, i32, vp, vp, i32, i64, i64, i32, vp]
        L.rt_gram_scratch_blocks.argtypes = [i32, i32, i64, i32]
        L.rt_krum_select.argtypes = [vp, vp, i32, i32, vp]
        L.rt_weighted_sum.argtypes = [vp, vp, i32, vp, i32, i64, i64, vp]
        L.rt_masked_coord_stat.argtypes = [vp, i32, vp, vp, i32, i64, i64,
                                           i32, i32, vp]
        L.rt_masked_gram.argtypes = [vp, i32, vp, vp, vp, vp, i32, i64, i64,
                                     i32, vp]
        L.rt_masked_weighted_sum.argtypes = [vp, vp, i32, vp, vp, vp, i32,
                                             i64, i64, vp]
        L.rt_cge_select.argtypes = [vp, vp, i32, i32, vp]
        L.rt_cge_weighted_sum.argtypes = [vp, vp, i32, vp, i32, i64, i64,
                                          i32, ctypes.c_float, vp]
        L.rt_masked_cge_weighted_sum.argtypes = [
            vp, vp, i32, vp, vp, vp, i32, i64, i64, i32, ctypes.c_float, vp]
        L.rt_multi_krum_order.argtypes = [vp, vp, i32, i32, i32, vp]
        L.rt_iterative_order.argtypes = [vp, vp, i32, i32, i32, vp]
        L.rt_ordered_apply.argtypes = [vp, vp, i32, vp, i32, i64, i64, i32,
                                       ctypes.c_float, vp]
        L.rt_bulyan_coord.argtypes = [vp, i32, vp, vp, i32, i64, i64, i32,
                                      i32, vp]
        L.rt_masked_ordered_apply.argtypes = [vp, vp, i32, vp, vp, vp, i32,
                                              i64, i64, i32, ctypes.c_float,
                                              vp]
        L.rt_masked_bulyan_coord.argtypes = [vp, i32, vp, vp, vp, vp, i32,
                                             i64, i64, i32, i32, vp]
        L.rt_sign_vote.argtypes = [vp, i32, vp, i32, i64, i64, vp]
        L.rt_masked_sign_vote.argtypes = [vp, i32, vp, vp, i32, i64, i64,
                                          vp]
        L.rt_scaled_coord_stat.argtypes = [vp, i32, vp, vp, i32, i64, i64,
                                           i32, i32, vp]
        L.rt_scaled_masked_coord_stat.argtypes = [vp, i32, vp, vp, vp, i32,
                                                  i64, i64, i32, i32, vp]
        L.rt_scaled_masked_sign_vote.argtypes = [vp, i32, vp, vp, vp, i32,
                                                 i64, i64, vp]
        L.rt_sparse_masked_weighted_mean.argtypes = [vp, i32, vp, vp, vp,
                                                     i32, i64, i64, vp]
        L.rt_scaled_sparse_masked_weighted_mean.argtypes = [
            vp, i32, vp, vp, vp, vp, i32, i64, i64, vp]
        L.rt_coord_sort.argtypes = [vp, i32, vp, i32, i64, i64, vp]
        L.rt_clipped_weighted_sum.argtypes = [vp, vp, i32, vp, vp, i32, i64,
                                              i64, vp]
        L.rt_empty.argtypes = [vp]
        for fn in ("rt_coord_stat", "rt_gram", "rt_gram_scratch_blocks",
                   "rt_krum_select", "rt_weighted_sum", "rt_masked_coord_stat",
                   "rt_masked_gram", "rt_masked_weighted_sum",
                   "rt_cge_select", "rt_cge_weighted_sum",
                   "rt_masked_cge_weighted_sum", "rt_multi_krum_order",
                   "rt_iterative_order", "rt_ordered_apply",
                   "rt_bulyan_coord", "rt_masked_ordered_apply",
                   "rt_masked_bulyan_coord", "rt_sign_vote",
                   "rt_masked_sign_vote", "rt_scaled_coord_stat",
                   "rt_scaled_masked_coord_stat",
                   "rt_scaled_masked_sign_vote",
                   "rt_sparse_masked_weighted_mean",
                   "rt_scaled_sparse_masked_weighted_mean", "rt_coord_sort",
                   "rt_clipped_weighted_sum", "rt_empty"):
            getattr(L, fn).restype = i32
        _LIB = L
    return _LIB


def empty_launch(t):
    """Launch the empty kernel (``csrc/empty.cu``) on the current stream of
    CUDA tensor ``t``'s device, through :func:`stream_ptr` as every
    wrapper does: the floor of a launch, for timing."""
    check(lib().rt_empty(stream_ptr(t)), "empty")


def check(rc: int, name: str):
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def dtype_code(t, codes=FLOAT_CODES) -> int:
    """The csrc dtype code of ``t``, one of ``codes`` (the float arenas by
    default; :data:`QUANT_CODES` for a kernel that takes int8 / fp8
    codes); raises on any other dtype."""
    try:
        return codes[t.dtype]
    except KeyError:
        names = " or ".join(str(d).replace("torch.", "") for d in codes)
        raise TypeError(f"kernel input must be {names}, got "
                        f"{t.dtype}") from None


def stream_ptr(t) -> int:
    """The raw handle of the current stream of CUDA tensor ``t``'s device
    (``torch.cuda.current_stream(t.device).cuda_stream`` without building a
    ``Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
