"""Time this checkout's kernels against another checkout's, on the same
inputs, on the card (a host with the CUDA toolkit and an NVIDIA GPU):

    python -m repro_torch.kernels.compare --csrc DIR [--kernels NAME ...]
        [--units GLOB ...]

``DIR`` is the ``csrc`` of the other checkout (unpack it with ``git
archive`` under the git-ignored ``build/``).  ``--kernels`` picks rows of
:data:`KERNELS` (all by default); the units of ``DIR`` that hold them (or
those matching ``--units``) are compiled with ``build.py``'s flags into
one library of their own, and this checkout's kernels come from
:func:`build.lib`.  The cases, at the full width of paper-100m (P =
124,668,672):

* ``coord_stat`` (K1): a bf16 stack at n = 8, 16, 33 and 64 and fp32 at
  n = 8, median and trimmed (b = 2);
* ``scaled_sparse_masked_weighted_mean`` (K21): the int8 and fp8 codes of
  a sparse stack, 8 and 6 of 8 rows live;
* ``sign_vote`` (K15): n = 8 in bf16, fp32, int8 and fp8 codes, and int8
  codes at n = 16, 33 and 64;
* ``scaled_masked_sign_vote`` (K20): int8 and fp8 codes at 8 and 6 of 8
  arrived, and int8 at n = 16, 33 and 64 with n - 2 arrived;
* ``masked_sign_vote`` (K16): fp32 and bf16 at 6 of 8 arrived;
* ``sign_sgd_aggregation``: sign_sgd's ``spec.aggregate_flat`` on a bf16
  arena (one K15), on int8 and fp8 codes (one K15) and on those codes
  with 6 of 8 arrived (one K20), its kernels taken from either library;
* ``krum_select`` (K3) and ``iterative_order`` (K10): the port's Gram of a
  seeded (n, 256) stack at every n of :data:`SWEEP_N` (chip_smoke.py's
  Gram sweep, 1-64), f = max(2, (n - 3) // 4); K10 with min(3, n) picks
  and with theta = n - 2f (Bulyan's) picks; ``cge_select`` (K8, keeping
  n - f) and ``multi_krum_order`` (K9, m = 3) at n = 8, 11, 16, 33 and
  64.  These four are launch-bound: pass ``--reps 1000``;
* ``m_krum_aggregation``: m_krum's ``spec.aggregate_flat`` on a bf16 arena
  at n = 8 (one K2, K10 and K11), its kernels taken from either library;
* ``weighted_sum`` (K4) and ``masked_weighted_sum`` (K7) for their callers
  other than CGE: Krum's one-hot on a bf16 arena and the imputed mean's
  weights (6 of 8) on an fp32 one (K4); the one-hot on a live row at 6 of
  8 in fp32 and the coded decode's 1/2 on two winners in bf16 (K7);
* ``cge_aggregation``: CGE's kernel composition on a bf16 arena at n = 8
  and masked on an fp32 one at 6 of 8 (``ops.kernel_cge`` /
  ``kernel_cge_masked``: K2 and the apply; K4 (mean), K6 and the masked
  apply), this checkout's against the other library's kernels composed as
  the chain before CGE's apply: K2 -> K8 -> K4 (masked: K4 (mean) -> K6
  -> K8 -> K7) -> ``/ (n - f)``.

The other library and this one run in turns (other, this, this, other;
CUDA events over ``--reps`` launches after a warm-up), their outputs are
compared (medians, K21, the votes and the selections equal NaN to NaN,
trimmed means within 3e-6), and one JSON line a case gives both times,
the bytes' bound and the card.  For the launch-bound kernels the line
also gives each library's device-only time: the mean duration of the
kernel's own events in a ``torch.profiler`` trace of 200 calls
(:func:`device_ms`).
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
VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entry points of the compared kernels and their argtypes
ENTRIES = {
    "rt_coord_stat": [VP, I32, VP, I32, I64, I64, I32, I32, VP],
    "rt_scaled_sparse_masked_weighted_mean": [VP, I32, VP, VP, VP, VP, I32,
                                              I64, I64, VP],
    "rt_sign_vote": [VP, I32, VP, I32, I64, I64, VP],
    "rt_scaled_masked_sign_vote": [VP, I32, VP, VP, VP, I32, I64, I64, VP],
    "rt_masked_sign_vote": [VP, I32, VP, VP, I32, I64, I64, VP],
    "rt_krum_select": [VP, VP, I32, I32, VP],
    "rt_iterative_order": [VP, VP, I32, I32, I32, VP],
    "rt_cge_select": [VP, VP, I32, I32, VP],
    "rt_multi_krum_order": [VP, VP, I32, I32, I32, VP],
    "rt_gram": [VP, I32, VP, VP, I32, I64, I64, I32, VP],
    "rt_gram_scratch_blocks": [I32, I32, I64, I32],
    "rt_ordered_apply": [VP, VP, I32, VP, I32, I64, I64, I32,
                         ctypes.c_float, VP],
    "rt_weighted_sum": [VP, VP, I32, VP, I32, I64, I64, VP],
    "rt_masked_weighted_sum": [VP, VP, I32, VP, VP, VP, I32, I64, I64, VP],
    "rt_masked_gram": [VP, I32, VP, VP, VP, VP, I32, I64, I64, I32, VP],
}


def other_lib(csrc: Path, globs, entries, out_dir: Path):
    """The units of ``csrc`` matching ``globs`` in one shared library, with
    the argtypes of ``entries`` set."""
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
    for name in entries:
        fn = getattr(L, name)
        fn.argtypes = ENTRIES[name]
        fn.restype = I32
    return L


def _out(x):
    return torch.empty(x.shape[1], device=x.device)


def coord_stat(L, x, stat, b):
    out = _out(x)
    build.check(L.rt_coord_stat(x.data_ptr(), build.dtype_code(x),
                                out.data_ptr(), x.shape[0], x.shape[1],
                                x.stride(0), STATS[stat], b,
                                build.stream_ptr(x)), "coord_stat")
    return out


def sparse_mean(L, codes, scale, mask, w):
    out = _out(codes)
    build.check(L.rt_scaled_sparse_masked_weighted_mean(
        codes.data_ptr(), build.dtype_code(codes, build.QUANT_CODES),
        scale.data_ptr(), mask.data_ptr(), w.data_ptr(), out.data_ptr(),
        codes.shape[0], codes.shape[1], codes.stride(0),
        build.stream_ptr(codes)), "scaled_sparse_masked_weighted_mean")
    return out


def sign_vote(L, x):
    out = _out(x)
    build.check(L.rt_sign_vote(
        x.data_ptr(), build.dtype_code(x, {**build.FLOAT_CODES,
                                           **build.QUANT_CODES}),
        out.data_ptr(), x.shape[0], x.shape[1], x.stride(0),
        build.stream_ptr(x)), "sign_vote")
    return out


def scaled_vote(L, codes, scale, mask):
    out = _out(codes)
    build.check(L.rt_scaled_masked_sign_vote(
        codes.data_ptr(), build.dtype_code(codes, build.QUANT_CODES),
        scale.data_ptr(), mask.data_ptr(), out.data_ptr(), codes.shape[0],
        codes.shape[1], codes.stride(0), build.stream_ptr(codes)),
        "scaled_masked_sign_vote")
    return out


def masked_vote(L, x, mask):
    out = _out(x)
    build.check(L.rt_masked_sign_vote(
        x.data_ptr(), build.dtype_code(x), mask.data_ptr(), out.data_ptr(),
        x.shape[0], x.shape[1], x.stride(0), build.stream_ptr(x)),
        "masked_sign_vote")
    return out


def _mask(n, live):
    m = torch.ones(n, device="cuda")
    m[live:] = 0.0
    return m


def _floats(gen, n, dtype):
    return (torch.randn((n, P), generator=gen, device="cuda")
            * 1e-3).to(dtype)


def _name(dtype):
    return str(dtype).replace("torch.", "")


# Each row: the entry points, the units that hold them, and the cases: a
# generator of (case, call(L) -> output, bytes moved, tolerance).  A
# generator's inputs live while its cases run.

def coord_stat_cases(gen):
    for dtype, ns in ((torch.bfloat16, (8, 16, 33, 64)),
                      (torch.float32, (8,))):
        for n in ns:
            x = _floats(gen, n, dtype)
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                yield ({"dtype": _name(dtype), "n": n, "stat": stat,
                        "b": b},
                       lambda L, stat=stat, b=b: coord_stat(L, x, stat, b),
                       n * P * x.element_size() + 4 * P,
                       0.0 if stat == "median" else 3e-6)
            del x
            torch.cuda.empty_cache()


def sparse_mean_cases(gen):
    g = torch.randn((8, P), generator=gen, device="cuda") * 1e-3
    g[torch.rand((8, P), generator=gen, device="cuda") < 0.5] = 0.0
    for qdt in ("int8", "float8_e4m3fn"):
        codes, scale = quantize_rows(g, qdt)
        for live in (8, 6):
            m = _mask(8, live)
            w = m * torch.tensor([1.0, 0.5, 1.0 / 3.0] * 3,
                                 device="cuda")[:8] if live < 8 else m
            yield ({"dtype": qdt, "n": 8, "live": live},
                   lambda L, m=m, w=w: sparse_mean(L, codes, scale, m, w),
                   live * P + 4 * P + 12 * 8, 0.0)
        del codes, scale


def sign_vote_cases(gen):
    for dtype in (torch.bfloat16, torch.float32):
        x = _floats(gen, 8, dtype)
        yield ({"dtype": _name(dtype), "n": 8},
               lambda L: sign_vote(L, x), 8 * P * x.element_size() + 4 * P,
               0.0)
        del x
    g = torch.randn((8, P), generator=gen, device="cuda")
    for qdt in ("int8", "float8_e4m3fn"):
        codes, _ = quantize_rows(g, qdt)
        yield ({"dtype": qdt, "n": 8}, lambda L: sign_vote(L, codes),
               8 * P + 4 * P, 0.0)
        del codes
    del g
    for n in (16, 33, 64):
        codes = torch.randint(-127, 128, (n, P), generator=gen,
                              device="cuda", dtype=torch.int8)
        yield ({"dtype": "int8", "n": n}, lambda L: sign_vote(L, codes),
               n * P + 4 * P, 0.0)
        del codes
        torch.cuda.empty_cache()


def scaled_vote_cases(gen):
    g = torch.randn((8, P), generator=gen, device="cuda")
    for qdt in ("int8", "float8_e4m3fn"):
        codes, scale = quantize_rows(g, qdt)
        for live in (8, 6):
            m = _mask(8, live)
            yield ({"dtype": qdt, "n": 8, "live": live},
                   lambda L, m=m: scaled_vote(L, codes, scale, m),
                   live * P + 8 * 8 + 4 * P, 0.0)
        del codes, scale
    del g
    for n in (16, 33, 64):
        codes = torch.randint(-127, 128, (n, P), generator=gen,
                              device="cuda", dtype=torch.int8)
        scale = torch.rand(n, generator=gen, device="cuda") + 0.5
        m = _mask(n, n - 2)
        yield ({"dtype": "int8", "n": n, "live": n - 2},
               lambda L: scaled_vote(L, codes, scale, m),
               (n - 2) * P + 8 * n + 4 * P, 0.0)
        del codes
        torch.cuda.empty_cache()


def masked_vote_cases(gen):
    m = _mask(8, 6)
    for dtype in (torch.float32, torch.bfloat16):
        x = _floats(gen, 8, dtype)
        yield ({"dtype": _name(dtype), "n": 8, "live": 6},
               lambda L: masked_vote(L, x, m),
               6 * P * x.element_size() + 4 * 8 + 4 * P, 0.0)
        del x
        torch.cuda.empty_cache()


def aggregated(L, fn, *args, **kw):
    """``fn(*args, **kw)`` (an aggregation or a wrapper) with the kernels
    of library L."""
    saved = build._LIB
    build._LIB = L
    try:
        return fn(*args, **kw)
    finally:
        build._LIB = saved


def sign_sgd_cases(gen):
    from ..core.aggregators import make_spec
    spec = make_spec("sign_sgd", f=2, n=8)
    x = _floats(gen, 8, torch.bfloat16)
    yield ({"dtype": "bfloat16", "n": 8},
           lambda L: aggregated(L, spec.aggregate_flat, x),
           8 * P * 2 + 4 * P, 0.0)
    del x
    g = torch.randn((8, P), generator=gen, device="cuda")
    m = _mask(8, 6).bool()
    for qdt in ("int8", "float8_e4m3fn"):
        codes, scale = quantize_rows(g, qdt)
        yield ({"dtype": qdt, "n": 8},
               lambda L: aggregated(L, spec.aggregate_flat, codes,
                                    scale=scale),
               8 * P + 4 * P, 0.0)
        yield ({"dtype": qdt, "n": 8, "live": 6},
               lambda L: aggregated(L, spec.aggregate_flat, codes, mask=m,
                                    weights=m.float(), scale=scale),
               6 * P + 8 * 8 + 4 * P, 0.0)
        del codes, scale
    del g
    torch.cuda.empty_cache()


# The launch-bound selection kernels: the n of chip_smoke.py's Gram sweep
# for K3 and K10, the main path's and the wide rosters' for K8 and K9.
SWEEP_N = tuple(range(1, 18)) + (24, 32, 33, 48, 64)
NS = (8, 11, 16, 33, 64)


def f_of(n: int) -> int:
    return max(2, (n - 3) // 4)


def theta_of(n: int) -> int:
    """Bulyan's picks at n with f = f_of(n)."""
    return max(n - 2 * f_of(n), 1)


def gram_of(n: int, gen):
    """The port's (bitwise symmetric) Gram of a seeded (n, 256) stack."""
    from .pairwise import gram
    return gram(torch.randn((n, 256), generator=gen, device=gen.device))


# name -> (output dtype, its n, the C entry point's arguments after n, in
# order, for each case at n)
SELECTION = {
    "krum_select": (torch.float32, SWEEP_N, lambda n: [{"f": f_of(n)}]),
    "iterative_order": (torch.int32, SWEEP_N, lambda n: [
        {"f": f_of(n), "k_total": k} for k in sorted({min(3, n),
                                                       theta_of(n)})]),
    "cge_select": (torch.float32, NS, lambda n: [{"n_keep": n - f_of(n)}]),
    "multi_krum_order": (torch.int32, NS,
                         lambda n: [{"f": f_of(n), "m": 3}]),
}


def selection_cases(gen, which):
    dtype, ns, cases = SELECTION[which]
    for n in ns:
        gr = gram_of(n, gen)
        g, s = gr.data_ptr(), build.stream_ptr(gr)
        for kw in cases(n):
            def call(L, n=n, g=g, s=s, args=tuple(kw.values())):
                out = torch.empty((n,), dtype=dtype, device="cuda")
                build.check(getattr(L, "rt_" + which)(
                    g, out.data_ptr(), n, *args, s), which)
                return out
            yield {"n": n, **kw}, call, 4 * n * n + 4 * n, 0.0


def m_krum_cases(gen):
    """m_krum's ``spec.aggregate_flat`` on a bf16 arena at n = 8 (one K2,
    one K10, one K11), as chip_smoke.py times each rule's aggregation."""
    from ..core.aggregators import make_spec
    spec = make_spec("m_krum", f=2, n=8)
    x = _floats(gen, 8, torch.bfloat16)
    yield ({"dtype": "bfloat16", "n": 8},
           lambda L: aggregated(L, spec.aggregate_flat, x),
           8 * P * 2 + 2 * P * 2 + 4 * P, 0.0)
    del x
    torch.cuda.empty_cache()


def _weights(n, hot):
    w = torch.zeros(n, device="cuda")
    w[list(hot)] = 1.0 / len(hot)
    return w


def wsum_cases(gen):
    """K4 for Krum (a one-hot on a bf16 arena) and the imputed mean (the
    staleness weights of 6 of 8 rows, normalized, on an fp32 one)."""
    from .wsum import weighted_sum
    for dtype, w in ((torch.bfloat16, _weights(8, [3])),
                     (torch.float32, _mask(8, 6) * torch.tensor(
                         [1.0, 0.5, 1.0 / 3.0] * 3, device="cuda")[:8])):
        x = _floats(gen, 8, dtype)
        w = w / w.sum()
        rows = int((w > 0).sum())
        yield ({"dtype": _name(dtype), "n": 8, "rows": rows},
               lambda L, x=x, w=w: aggregated(L, weighted_sum, w, x),
               rows * P * x.element_size() + 4 * P, 0.0)
        del x
        torch.cuda.empty_cache()


def masked_wsum_cases(gen):
    """K7 for Krum (a one-hot on a live row, 6 of 8 arrived, fp32) and the
    coded decode (1/2 on the winners of two groups, bf16, all arrived)."""
    from .wsum import masked_weighted_sum
    for dtype, live, w in ((torch.float32, 6, _weights(8, [2])),
                           (torch.bfloat16, 8, _weights(8, [0, 4]))):
        x = _floats(gen, 8, dtype)
        m = _mask(8, live)
        mean = x[0].clone()
        rows = int((w > 0).sum())
        yield ({"dtype": _name(dtype), "n": 8, "live": live, "rows": rows},
               lambda L, x=x, m=m, mean=mean, w=w: aggregated(
                   L, masked_weighted_sum, w, x, m, mean),
               rows * P * x.element_size() + 4 * P, 0.0)
        del x, mean
        torch.cuda.empty_cache()


def parent_cge_apply(gr, x, k, mask=None, mean=None, div=None):
    """The apply stage of CGE's chain before CGE's apply, on the Gram
    ``gr``: K8 (keep ``k``) -> K4 (masked: K7 with ``mask`` / ``mean``),
    then ``/ div`` as given (a Python scalar: the reciprocal multiply
    torch takes on the card; a device tensor: IEEE division; None: no
    division)."""
    from .select import cge_select
    from .wsum import masked_weighted_sum, weighted_sum
    keep = cge_select(gr, k)
    out = (weighted_sum(keep, x) if mask is None
           else masked_weighted_sum(keep, x, mask, mean))
    return out if div is None else out / div


def parent_cge(x, f, mask=None, wn=None):
    """CGE's aggregation as the kernels composed it before CGE's apply:
    K2 -> K8 -> K4 (masked: K4 (mean) -> K6 -> K8 -> K7), then ``/ (n -
    f)`` by a Python scalar."""
    from .pairwise import gram, imputed_mean, masked_gram
    k = x.shape[0] - f
    if mask is None:
        return parent_cge_apply(gram(x), x, k, div=k)
    mean = imputed_mean(x, wn)
    return parent_cge_apply(masked_gram(x, mask, wn, mean), x, k, mask,
                            mean, div=k)


def cge_cases(gen):
    """CGE's kernel composition, this checkout's (the apply) against the
    other library's kernels in the chain before it (:func:`parent_cge`):
    the outputs differ by the division's rounding (the chain's reciprocal
    multiply), at most an ulp."""
    from .ops import kernel_cge, kernel_cge_masked
    this = build.lib()
    x = _floats(gen, 8, torch.bfloat16)
    yield ({"dtype": "bfloat16", "n": 8},
           lambda L: (kernel_cge(x, 2) if L is this
                      else aggregated(L, parent_cge, x, 2)),
           6 * P * 2 + 4 * P, 3e-6)
    del x
    torch.cuda.empty_cache()
    x = _floats(gen, 8, torch.float32)
    m = _mask(8, 6)
    w = m * torch.tensor([1.0, 0.5, 1.0 / 3.0] * 3, device="cuda")[:8]
    wn = w / w.sum()
    yield ({"dtype": "float32", "n": 8, "live": 6},
           lambda L: (kernel_cge_masked(x, m, wn, 2) if L is this
                      else aggregated(L, parent_cge, x, 2, m, wn)),
           5 * P * 4 + 4 * P, 3e-6)
    del x
    torch.cuda.empty_cache()


def _select_row(name, units):
    return (("rt_" + name,), units,
            lambda gen: selection_cases(gen, name), name + "_kernel")


# Each row: the entry points, the units that hold them, the cases, and the
# kernel's name in a torch.profiler trace where its device-only time is
# taken too (the launch-bound kernels), else None.
KERNELS = {
    "coord_stat": (("rt_coord_stat",), ("coord_stat*.cu",
                                         "order_stat_*.cu"),
                   coord_stat_cases, None),
    "scaled_sparse_masked_weighted_mean": (
        ("rt_scaled_sparse_masked_weighted_mean",), ("sparse_wmean.cu",),
        sparse_mean_cases, None),
    "sign_vote": (("rt_sign_vote",), ("sign_vote.cu",), sign_vote_cases,
                  None),
    "scaled_masked_sign_vote": (("rt_scaled_masked_sign_vote",),
                                ("sign_vote.cu",), scaled_vote_cases, None),
    "masked_sign_vote": (("rt_masked_sign_vote",), ("sign_vote.cu",),
                         masked_vote_cases, None),
    "sign_sgd_aggregation": (("rt_sign_vote", "rt_scaled_masked_sign_vote"),
                             ("sign_vote.cu",), sign_sgd_cases, None),
    "krum_select": _select_row("krum_select", ("krum_select.cu",)),
    "iterative_order": _select_row("iterative_order", ("order.cu",)),
    "cge_select": _select_row("cge_select", ("cge_select.cu",)),
    "multi_krum_order": _select_row("multi_krum_order", ("order.cu",)),
    "m_krum_aggregation": (("rt_gram", "rt_gram_scratch_blocks",
                            "rt_iterative_order", "rt_ordered_apply"),
                           ("gram.cu", "order.cu", "ordered_apply.cu"),
                           m_krum_cases, None),
    "weighted_sum": (("rt_weighted_sum",), ("wsum.cu",), wsum_cases,
                     "wsum_kernel"),
    "masked_weighted_sum": (("rt_masked_weighted_sum",),
                            ("masked_wsum.cu",), masked_wsum_cases,
                            "masked_wsum_kernel"),
    "cge_aggregation": (("rt_gram", "rt_gram_scratch_blocks",
                         "rt_masked_gram", "rt_cge_select",
                         "rt_weighted_sum", "rt_masked_weighted_sum"),
                        ("gram.cu", "masked_gram.cu", "cge_select.cu",
                         "wsum.cu", "masked_wsum.cu"), cge_cases, None),
}


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


def device_ms(name, call, reps: int = 200):
    """Mean duration (ms) of the device events called ``name`` in a
    ``torch.profiler`` trace of ``reps`` calls after a warm-up call, and
    their count; ("not measured", 0) if the trace holds none.  With
    ``name=None`` every device event counts and the mean is taken per
    call: the card's busy time a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    durs = [(e.time_range.end - e.time_range.start) / 1e3
            for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and (name is None or name in e.name)]
    if not durs:
        return "not measured", 0
    return sum(durs) / (reps if name is None else len(durs)), len(durs)


def agree(a, b, tol):
    a, b = a.float(), b.float()
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    return bool(torch.allclose(a[~nan], b[~nan], rtol=tol, atol=tol))


def run_case(card, case, other, this, bytes_moved, tol, reps, event):
    ok = agree(other(), this(), tol)
    o1 = time_ms(other, reps)
    t1 = time_ms(this, reps)
    t2 = time_ms(this, reps)
    o2 = time_ms(other, reps)
    row = {**case, "agree": ok, "other_ms": [o1, o2], "this_ms": [t1, t2],
           "bound_ms": bytes_moved / MEM_BPS * 1e3}
    if event:
        row.update(other_device_ms=device_ms(event, other)[0],
                   this_device_ms=device_ms(event, this)[0])
    print(json.dumps({**row, "card": card}), flush=True)
    return ok


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the csrc directory of the other checkout")
    ap.add_argument("--kernels", nargs="+", choices=list(KERNELS),
                    default=list(KERNELS), help="the kernels to compare")
    ap.add_argument("--units", nargs="+",
                    help="globs of the other checkout's units to compile "
                         "(by default those of the chosen kernels)")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("compare: needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    rows = [KERNELS[k] for k in args.kernels]
    globs = args.units or [g for _, units, _, _ in rows for g in units]
    other = other_lib(args.csrc.resolve(), sorted(set(globs)),
                      sorted({e for entries, *_ in rows for e in entries}),
                      build.build_root() / "other")
    this = build.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for name in args.kernels:
        _, _, cases, event = KERNELS[name]
        for case, call, bytes_moved, tol in cases(gen):
            ok &= run_case(card, {"kernel": name, **case},
                           lambda: call(other), lambda: call(this),
                           bytes_moved, tol, args.reps, event)
    if not ok:
        raise SystemExit("compare: the two checkouts disagree")


if __name__ == "__main__":
    sys.exit(main())
