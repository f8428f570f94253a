"""Time this checkout's K1 and K21 against another checkout's, on the same
inputs, on the card (a host with the CUDA toolkit and an NVIDIA GPU):

    python -m repro_torch.kernels.compare --csrc DIR [--units GLOB ...]

``DIR`` is the ``csrc`` of the other checkout (unpack it with ``git
archive`` under the git-ignored ``build/``).  The units of ``DIR`` that
match a ``GLOB`` (by default the ones that hold K1 and K21 and K1's
instances) are compiled with ``build.py``'s flags into one library of
their own; this checkout's kernels come from :func:`build.lib`.  Each
case, at the full width of paper-100m (P = 124,668,672): K1 on a bf16
stack at n = 8, 16, 33 and 64 and on fp32 at n = 8 (median, trimmed b =
2); K21 on the int8 and fp8 codes of a sparse stack with 8 and 6 of 8
rows live.  The other library and this one run in turns (other, this,
this, other; CUDA events over ``--reps`` launches after a warm-up), their
outputs are compared (medians and K21 equal NaN to NaN, trimmed means
within 3e-6), and one JSON line a case gives both times, the bytes'
bound and the card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..core.flat import quantize_rows
from . import build
from .coord_stats import STATS

P = 124_668_672
MEM_BPS = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
UNITS = ("coord_stat*.cu", "order_stat_*.cu", "sparse_wmean.cu")


def other_lib(csrc: Path, globs, out_dir: Path):
    """The units of ``csrc`` matching ``globs`` in one shared library."""
    units = sorted({u for g in globs for u in csrc.glob(g)})
    if not units:
        raise SystemExit(f"no unit of {csrc} matches {list(globs)}")
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libother.so"
    nvcc = build._nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = [(u, Path(tmp) / (u.stem + ".o")) for u in units]
        running = [subprocess.Popen(
            [nvcc, *build.ARCH, *build.FLAGS, "-I", str(csrc), "-c", str(u),
             "-o", str(o)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for u, o in procs]
        for (u, _), p in zip(procs, running):
            text, _ = p.communicate()
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {u}:\n{text}")
        subprocess.run([nvcc, *build.ARCH, "-shared", "-o", str(lib),
                        *[str(o) for _, o in procs]], check=True)
    L = ctypes.CDLL(str(lib))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    L.rt_coord_stat.argtypes = [vp, i32, vp, i32, i64, i64, i32, i32, vp]
    L.rt_scaled_sparse_masked_weighted_mean.argtypes = [
        vp, i32, vp, vp, vp, vp, i32, i64, i64, vp]
    L.rt_coord_stat.restype = i32
    L.rt_scaled_sparse_masked_weighted_mean.restype = i32
    return L


def coord_stat(L, x, stat, b):
    out = torch.empty(x.shape[1], device=x.device)
    build.check(L.rt_coord_stat(x.data_ptr(), build.dtype_code(x),
                                out.data_ptr(), x.shape[0], x.shape[1],
                                x.stride(0), STATS[stat], b,
                                build.stream_ptr(x)), "coord_stat")
    return out


def sparse_mean(L, codes, scale, mask, w):
    out = torch.empty(codes.shape[1], device=codes.device)
    build.check(L.rt_scaled_sparse_masked_weighted_mean(
        codes.data_ptr(), build.dtype_code(codes, build.QUANT_CODES),
        scale.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
        codes.shape[0], codes.shape[1], codes.stride(0),
        build.stream_ptr(codes)), "scaled_sparse_masked_weighted_mean")
    return out


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def agree(a, b, tol):
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return bool(torch.allclose(a[~nan], b[~nan], rtol=tol, atol=tol))


def run_case(card, case, other, this, bytes_moved, tol, reps):
    ok = agree(other(), this(), tol)
    o1 = time_ms(other, reps)
    t1 = time_ms(this, reps)
    t2 = time_ms(this, reps)
    o2 = time_ms(other, reps)
    print(json.dumps({**case, "agree": ok, "other_ms": [o1, o2],
                      "this_ms": [t1, t2],
                      "bound_ms": bytes_moved / MEM_BPS * 1e3,
                      "card": card}), flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the csrc directory of the other checkout")
    ap.add_argument("--units", nargs="+", default=list(UNITS),
                    help="globs of the other checkout's units to compile")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    other = other_lib(args.csrc.resolve(), args.units,
                      build.build_root() / "other")
    this = build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for dtype, ns in ((torch.bfloat16, (8, 16, 33, 64)),
                      (torch.float32, (8,))):
        for n in ns:
            x = (torch.randn((n, P), generator=gen, device="cuda")
                 * 1e-3).to(dtype)
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                ok &= run_case(
                    card, {"kernel": "coord_stat", "dtype": str(dtype)[6:],
                           "n": n, "stat": stat, "b": b},
                    lambda: coord_stat(other, x, stat, b),
                    lambda: coord_stat(this, x, stat, b),
                    n * P * x.element_size() + 4 * P,
                    0.0 if stat == "median" else 3e-6, args.reps)
            del x
            torch.cuda.empty_cache()
    g = torch.randn((8, P), generator=gen, device="cuda") * 1e-3
    g[torch.rand((8, P), generator=gen, device="cuda") < 0.5] = 0.0
    for qdt in ("int8", "float8_e4m3fn"):
        codes, scale = quantize_rows(g, qdt)
        for live in (8, 6):
            m = torch.ones(8, device="cuda")
            m[live:] = 0.0
            w = m * torch.tensor([1.0, 0.5, 1.0 / 3.0] * 3,
                                 device="cuda")[:8] if live < 8 else m
            ok &= run_case(
                card, {"kernel": "scaled_sparse_masked_weighted_mean",
                       "dtype": qdt, "n": 8, "live": live},
                lambda: sparse_mean(other, codes, scale, m, w),
                lambda: sparse_mean(this, codes, scale, m, w),
                live * P + 4 * P + 12 * 8, 0.0, args.reps)
        del codes, scale
    if not ok:
        raise SystemExit("compare: the two checkouts disagree")


if __name__ == "__main__":
    sys.exit(main())
