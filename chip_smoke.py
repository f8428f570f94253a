"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases (each prints JSON lines; any
failure exits non-zero without a result line):

1. device    — the card (nvidia-smi name and power limit), torch and CUDA
               versions, and the build of the hand-written kernels from
               src/repro_torch/kernels/csrc with nvcc (sm_90a);
2. kernels   — every kernel of the main path against its plain PyTorch
               version at the main path's shapes (n = 8 agents, P =
               124,668,672 parameters of paper-100m) in bf16 and fp32,
               plus the NaN / +-inf / tie hazards at a small width; times
               of the kernel, the plain version and the one-call PyTorch
               library yardstick, and the bound;
3. train     — the main path: the synchronous Byzantine-robust step on the
               full-width paper-100m (bf16, n = 8, f = 2, sign_flip,
               seq 256, 2 sequences per agent, remat on), 3 steps each of
               trimmed_mean, coordinate_median and krum through
               ``train_loop`` with impl="auto", after one untimed warm-up
               step per rule; the launch counts must show that every
               step went through its kernels.  A traced step per rule
               then splits the device time by device event;
4. kernel vs gather — one full-width step with impl="kernel" against
               impl="gather" from the same state and batch: the same
               arena and loss, median and krum aggregates exact, trimmed
               mean within 3e-6 (phases 4b and 4d run as one pass).

The async path (ROADMAP.md slice 2) adds:

2b. masked kernels — K5 masked_coord_stat, K6 masked_gram, K7
               masked_weighted_sum and the imputed mean (through K4)
               against their plain versions at n = 8, P = 124,668,672 in
               fp32 (the async arena) and bf16, masks of 6, 1 and 0 of 8
               arrived, weights one-hot on a live row, one-hot on a ghost
               and a {0,1} set; K5 at full width at the elastic churn
               run's bucket masks (3 and 4 of 4, 6 of 6, 7 of 8 live,
               ghost rows repeating the first slot); the NaN / +-inf /
               tie hazards and n = 3, 4, 6 at a small width; times,
               library yardsticks and bounds;
3b. async    — the full-width configuration of phase 3 under stragglers
               (lognormal 0.8, quorum 6, max staleness 3: 6 deliveries and
               staleness up to 2 every step, no step pure) through
               ``train_loop(sim=...)``: 1 warm-up step, then 4 timed steps
               per rule; the launch counts must show one K5 per step
               (median, trimmed) or one each of K4 (the imputed mean), K6,
               K3 and K7 (krum).  Then the elastic trimmed_mean
               (f=frac(0.25), n=elastic(8, (4, 6, 8))) for 8 steps under
               Churn(rate=0.25, mean_out=2.0): live 8, 6, 4, 6, 6, 7, 4,
               3, exactly 3 bucket steps and 1 synchronous step built.  A
               traced async step per rule splits the device time;
4b. masked kernel vs gather — one full-width async step per rule with
               impl="kernel" against impl="gather" from the same state,
               buffer, batch and trace row, and the elastic
               trimmed_mean's bucket steps with ghost rows (3 live in
               bucket 4, 7 live in bucket 8): median and krum exact,
               trimmed mean within 3e-6.

The selection family (ROADMAP.md slice 3) adds:

2c. selection kernels — K8 cge_select, K9 multi_krum_order, K10
               iterative_order, K11 ordered_apply and K13 bulyan_coord
               against their plain versions at full width (P =
               124,668,672) in bf16 and fp32: K8-K10 on the full-width
               Gram (asserted bitwise symmetric) at n = 8 and 11, K11
               with the orders of multi_krum (m = 3), m_krum (m = 3) and
               mda (k = n - f = 6) at n = 8, K13 at n = 11 (theta 7, beta
               3) and n = 8 (theta 4, beta 1); the NaN / +-inf /
               duplicate-row / pair-tie hazards at a small width and n =
               3, 4, 8, 11, 16; times, yardsticks and bounds;
3c. selection train — the phase-3 configuration for cge, multi_krum (m
               = 3), m_krum (m = 3) and mda at n = 8 and bulyan at n = 11
               (f = 2): 1 warm-up step, then 2 timed steps per rule; the
               launch counts must show K2, K8, K4 (cge), K2, K9, K11
               (multi_krum), K2, K10, K11 (m_krum), K2, K11 (mda) and K2,
               K10, K13 (bulyan) once per step; a traced step per rule;
4c. selection kernel vs gather — one full-width step per rule with
               impl="kernel" against impl="gather" from the same state and
               batch: the same arena, equal losses, the selected set and
               pick order equal, the aggregates within 3e-6.

The masked selection family and sign_sgd (ROADMAP.md slice 3b) add:

2.  K15 sign_vote against its plain version at full width in bf16 and
               fp32 (with the other phase-2 kernels), its NaN / +-inf /
               +-0 hazards at a small width;
2d. masked selection kernels — K12 masked_ordered_apply with the orders
               of multi_krum (m = 3), m_krum (m = 3) and mda (k = 6) on
               the imputed Gram of a 6-of-8 mask, and a hand-made order
               with a ghost (absent) row picked first; K14
               masked_bulyan_coord at n = 11 (9 arrived) on K10's theta
               picks, and with a ghost forced into the selection; K16
               masked_sign_vote at masks of 6, 1 and 0 of 8; fp32 (the
               async buffer) and bf16, full width; hazards at a small
               width; times, yardsticks and bounds;
3.  sign_sgd among the synchronous rules (K15 once a step);
3d. async selection — cge, multi_krum (m = 3), m_krum (m = 3), mda and
               sign_sgd at n = 8 under the phase-3b stragglers, bulyan at
               n = 11 with quorum 9 (9 of 11 arrive, no step pure): 1
               warm-up step, then 2 timed steps per rule; the launch
               counts must show K4 (the imputed mean) and K6, then cge K8
               K7, multi_krum K9 K12, m_krum K10 K12, mda K12, bulyan K10
               K14, and sign_sgd K16, once a step; a traced async step for
               multi_krum and bulyan;
4.  sign_sgd kernel vs gather, exact;
4d. masked selection kernel vs gather — one full-width async step per
               rule of phase 3d with impl="kernel" against impl="gather"
               from the same state, buffer, batch and trace row: the same
               masked arena, the same selection and pick order on the
               imputed stack (and whether a ghost row is selected), the
               aggregates within 3e-6, sign_sgd exact.

4c. (also) the bulyan step at n = 11 on the seed-1 parameters and batch
               (ROADMAP.md P12): the two equal sign_flip rows' gather
               distances bitwise equal, and the same pick order on the
               kernel and gather paths; then what the repair costs: the
               gather distances and the gather aggregation of krum (n =
               8) and bulyan (n = 11) timed with the pair dots and with
               the library product they replaced.

The compressed exchange, agg_dtype int8 / float8_e4m3fn (ROADMAP.md
slice 4a), adds:

2e. scaled kernels — K18 scaled_coord_stat (median and trimmed), K19
               scaled_masked_coord_stat, K20 scaled_masked_sign_vote and
               K15 on the codes against their plain versions at n = 8, P =
               124,668,672, int8 and fp8 codes of a seeded fp32 arena
               (quantize_rows on the card, timed with its peak memory
               rise on lines of its own, from the fp32 arena and from the
               bf16 arena of the synchronous step),
               masks of 6, 1 and 0 of 8 arrived; the dequant-copy gate
               (aggregate_flat(codes, mask=, weights=, scale=) of each
               scaled rule raises the peak device memory by at most 3 * P
               * 4 bytes on impl="kernel", by at least n * P * 4 on
               impl="gather"); the NaN / inf / zero-row / inf-scale
               hazards at a small width; times, yardsticks and bounds;
3x. compressed train — the phase-3 configuration with agg_dtype int8 and
               fp8, and the phase-3b stragglers with int8, for
               coordinate_median, trimmed_mean, sign_sgd and krum: 1
               warm-up step, then 2 timed steps per rule; the launch
               counts must show K18 (sync median, trimmed), K15 (sync
               sign), K19 (async median, trimmed), K20 (async sign) once a
               step, and krum its usual kernels and one engine-level
               dequantization a step (none for the other rules);
4x. compressed kernel vs gather — one full-width synchronous step per
               rule in int8 and fp8 and one async step per rule in int8,
               impl="kernel" against impl="gather" from the same state:
               codes and scales bitwise equal, equal losses, median, sign
               and krum exact, trimmed mean within 3e-6.

sparse_mean (ROADMAP.md slice 4b) and the legacy ``ops`` sort paths add:

2f. sparse kernels — K17 sparse_masked_weighted_mean and K21
               scaled_sparse_masked_weighted_mean against their plain
               versions at n = 8, P = 124,668,672, on the real (n, P) bf16
               arena of one sparse_mean step (the embedding rows a batch
               does not touch are 0: not sent; the share of columns nobody
               sent is printed): bf16 with mask and weights all ones, fp32
               with 6, 1 and 0 of 8 live and raw staleness weights, int8
               and fp8 codes of that arena; the NaN / +-inf / -0.0 /
               unsent / dead-row / inf-scale hazards at a small width;
               times, a partial yardstick and bounds;
2g. coord_sort — K23 against its plain version on that arena in bf16 and
               fp32 at full width, NaN and +-inf rows and n = 3, 8, 11 at
               a small width; then the ``ops`` legacy paths
               (kernel_coordinate_median, kernel_trimmed_mean,
               kernel_pairwise_sq_dists) at full width with their launch
               counts (K23 twice, K2 once), against the gather laws; times
               against ``torch.sort(dim=0)`` and the bound;
3s. sparse train — sparse_mean (f = 2, sign_flip: the rule ignores f)
               through ``train_loop``: 1 warm-up and 3 timed synchronous
               steps, 1 + 4 async steps under the phase-3b stragglers,
               and 1 + 2 steps each of int8 and fp8 sync and int8 async;
               the launch counts must show one K17 (compressed: one K21)
               a step and no other kernel; a traced sync and async step;
4s. sparse kernel vs gather — one full-width step each (sync, async,
               int8 sync) with impl="kernel" against impl="gather" from
               the same state: the same arena, codes and loss, aggregates
               within 3e-6; then the masked tree of mixed leaf dtypes
               (bf16 and fp32) on both impls at a small width: median,
               sign and krum exact, trimmed mean and sparse_mean within
               3e-6 (bf16 leaves 2e-2), one masked kernel a dtype (krum:
               the imputed fallback with its warning).

The defenses with memory and the defense-aware attacks (ROADMAP.md slice
6) add:

2h. clipped_weighted_sum — K22 against its plain version at n = 8, P =
               124,668,672: fp32 rows with 8 and 6 of 8 lam > 0, bf16
               rows with 8; inf / NaN on lam = 0 rows, every lam = 0 (the
               output is v), sum lam = 1, n = 1, 3, 8, 64 and P = 1, 37,
               4099 and the prime 65537 at a small width; times against
               ``torch.addmv`` and the bound;
3m. memory train — the phase-3b configuration through
               ``train_loop(sim=...)``, 1 warm-up step and 2 timed steps
               (int8: 1): centered_clip impl="kernel" under sign_flip on
               the synchronous trace and under stragglers, centered_clip
               impl="auto", zeno_pp, server_momentum(trimmed_mean),
               spec_alie and min_max against kernel centered_clip,
               slow_drift against server_momentum(trimmed_mean), and one
               int8 kernel centered_clip step; the launch counts must show
               5 K22 a step on kernel centered_clip (iters = 5), none under
               auto and zeno_pp, one K5 a step for server_momentum(
               trimmed_mean), and nothing from the attack probes (they run
               the gather impl); one async step built, none synchronous.
               Then one traced kernel centered_clip step (idle share, K22's
               device time) and, on its buffer, the clip-radius stage's
               time apart from K22;
4m. memory kernel vs gather — one full-width async step of centered_clip
               with impl="kernel" against impl="gather" from the same
               state, with a nonzero server_grad carried from an earlier
               step, under sign_flip and under min_max: equal arenas (the
               attacked one included) and losses; the aggregate, the new
               server_grad and each of the 5 iterates within 3e-6.

The lines before the last give the kernels' summary and the card; the
last line is {"ok": true, "device": {...}}.  Exits non-zero when CUDA is
not available.
"""
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
MEM_BPS = 3.35e12           # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
N, F = 8, 2
TOL = 3e-6                  # the fp32 kernel bar (trimmed mean, Gram, wsum)
SEQ, PER_AGENT, STEPS = 256, 2, 3
RULES = ("trimmed_mean", "coordinate_median", "krum")
RULE_KERNELS = {"trimmed_mean": ("coord_stat",),
                "coordinate_median": ("coord_stat",),
                "krum": ("gram", "krum_select", "weighted_sum")}
ASYNC_STEPS = 4
# the async rules: rule -> (n, quorum, hyper, the kernels of one masked
# step); the selection family's table is ASYNC_SEL_RULES below
ASYNC_RULES = {
    "trimmed_mean": (N, 6, {}, ("masked_coord_stat",)),
    "coordinate_median": (N, 6, {}, ("masked_coord_stat",)),
    "krum": (N, 6, {}, ("weighted_sum", "masked_gram", "krum_select",
                        "masked_weighted_sum"))}
CHURN_LIVE = [8, 6, 4, 6, 6, 7, 4, 3]
SOURCES = {
    "coord_stat": ("src/repro_torch/kernels/csrc/coord_stat.cu",
                   "src/repro/kernels/coord_stats.py:95"),
    "gram": ("src/repro_torch/kernels/csrc/gram.cu",
             "src/repro/kernels/pairwise.py:38"),
    "krum_select": ("src/repro_torch/kernels/csrc/krum_select.cu",
                    "src/repro/kernels/select.py:106"),
    "weighted_sum": ("src/repro_torch/kernels/csrc/wsum.cu",
                     "src/repro/kernels/wsum.py:45"),
    "masked_coord_stat": ("src/repro_torch/kernels/csrc/masked_coord_stat.cu",
                          "src/repro/kernels/masked.py:235"),
    "masked_gram": ("src/repro_torch/kernels/csrc/masked_gram.cu",
                    "src/repro/kernels/pairwise.py:89"),
    "masked_weighted_sum": ("src/repro_torch/kernels/csrc/masked_wsum.cu",
                            "src/repro/kernels/wsum.py:87"),
    "cge_select": ("src/repro_torch/kernels/csrc/cge_select.cu",
                   "src/repro/kernels/select.py:120"),
    "multi_krum_order": ("src/repro_torch/kernels/csrc/order.cu",
                         "src/repro/kernels/select.py:212"),
    "iterative_order": ("src/repro_torch/kernels/csrc/order.cu",
                        "src/repro/kernels/select.py:220"),
    "ordered_apply": ("src/repro_torch/kernels/csrc/ordered_apply.cu",
                      "src/repro/kernels/wsum.py:318"),
    "bulyan_coord": ("src/repro_torch/kernels/csrc/bulyan_coord.cu",
                     "src/repro/kernels/select.py:288"),
    "masked_ordered_apply": ("src/repro_torch/kernels/csrc/ordered_apply.cu",
                             "src/repro/kernels/wsum.py:346"),
    "masked_bulyan_coord": (
        "src/repro_torch/kernels/csrc/masked_bulyan_coord.cu",
        "src/repro/kernels/select.py:312"),
    "sign_vote": ("src/repro_torch/kernels/csrc/sign_vote.cu",
                  "src/repro/kernels/masked.py:62"),
    "masked_sign_vote": ("src/repro_torch/kernels/csrc/sign_vote.cu",
                         "src/repro/kernels/masked.py:90"),
    "scaled_coord_stat": ("src/repro_torch/kernels/csrc/scaled_coord_stat.cu",
                          "src/repro/kernels/masked.py:133"),
    "scaled_masked_coord_stat": (
        "src/repro_torch/kernels/csrc/scaled_masked_coord_stat.cu",
        "src/repro/kernels/masked.py:171"),
    "scaled_masked_sign_vote": ("src/repro_torch/kernels/csrc/sign_vote.cu",
                                "src/repro/kernels/masked.py:207"),
    "sparse_masked_weighted_mean": (
        "src/repro_torch/kernels/csrc/sparse_wmean.cu",
        "src/repro/kernels/wsum.py:186"),
    "scaled_sparse_masked_weighted_mean": (
        "src/repro_torch/kernels/csrc/sparse_wmean.cu",
        "src/repro/kernels/wsum.py:227"),
    "coord_sort": ("src/repro_torch/kernels/csrc/coord_sort.cu",
                   "src/repro/kernels/coord_stats.py:53"),
    "clipped_weighted_sum": ("src/repro_torch/kernels/csrc/clipped_wsum.cu",
                             "src/repro/kernels/wsum.py:138"),
}
SYNC_KERNELS = ("coord_stat", "gram", "krum_select", "weighted_sum",
                "sign_vote")
# the selection family: rule -> (n, hyper, the kernels of one step)
SEL_RULES = {
    "cge": (N, {}, ("gram", "cge_select", "weighted_sum")),
    "multi_krum": (N, {"m": 3}, ("gram", "multi_krum_order",
                                 "ordered_apply")),
    "m_krum": (N, {"m": 3}, ("gram", "iterative_order", "ordered_apply")),
    "mda": (N, {}, ("gram", "ordered_apply")),
    "bulyan": (11, {}, ("gram", "iterative_order", "bulyan_coord")),
}
SEL_STEPS = 2
SIGN_RULES = {"sign_sgd": (N, {}, ("sign_vote",))}
# the async selection family and sign_sgd: rule -> (n, quorum, hyper, the
# kernels of one masked step)
IMPUTED = ("weighted_sum", "masked_gram")
ASYNC_SEL_RULES = {
    "cge": (N, 6, {}, IMPUTED + ("cge_select", "masked_weighted_sum")),
    "multi_krum": (N, 6, {"m": 3}, IMPUTED + ("multi_krum_order",
                                              "masked_ordered_apply")),
    "m_krum": (N, 6, {"m": 3}, IMPUTED + ("iterative_order",
                                          "masked_ordered_apply")),
    "mda": (N, 6, {}, IMPUTED + ("masked_ordered_apply",)),
    "sign_sgd": (N, 6, {}, ("masked_sign_vote",)),
    "bulyan": (11, 9, {}, IMPUTED + ("iterative_order",
                                     "masked_bulyan_coord")),
}
ASYNC_SEL_STEPS = 2
# the compressed exchange (agg_dtype): the quantized dtypes, and rule -> (n,
# hyper, the kernels of one step) of the synchronous step and (n, quorum,
# hyper, the kernels of one masked step) of the async one; krum takes the
# engine-level dequantization, then its own kernels
QUANT = ("int8", "float8_e4m3fn")
QUANT_RULES = {
    "coordinate_median": (N, {}, ("scaled_coord_stat",)),
    "trimmed_mean": (N, {}, ("scaled_coord_stat",)),
    "sign_sgd": (N, {}, ("sign_vote",)),
    "krum": (N, {}, ("gram", "krum_select", "weighted_sum")),
}
ASYNC_QUANT_RULES = {
    "coordinate_median": (N, 6, {}, ("scaled_masked_coord_stat",)),
    "trimmed_mean": (N, 6, {}, ("scaled_masked_coord_stat",)),
    "sign_sgd": (N, 6, {}, ("scaled_masked_sign_vote",)),
    "krum": ASYNC_RULES["krum"],
}
QUANT_STEPS = 2
# the rules whose quantized arena is dequantized at engine level (a count
# per step, read in phase 3x)
DEQUANT_RULES = ("krum",)
# sparse_mean (phase 3s): the kernel of one step, sync and masked, on a
# float arena and on codes
K17, K21 = "sparse_masked_weighted_mean", "scaled_sparse_masked_weighted_mean"
SPARSE_SYNC = {"sparse_mean": (N, {}, (K17,))}
SPARSE_ASYNC = {"sparse_mean": (N, 6, {}, (K17,))}
SPARSE_QUANT = {"sparse_mean": (N, {}, (K21,))}
SPARSE_AQUANT = {"sparse_mean": (N, 6, {}, (K21,))}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
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


def max_abs_err(a, b):
    """Largest |a - b|; NaN in both counts as agreement, NaN in one as
    inf, equal infinities as 0."""
    a, b = a.float(), b.float()
    both_nan = torch.isnan(a) & torch.isnan(b)
    one_nan = torch.isnan(a) ^ torch.isnan(b)
    same = (a == b) | both_nan
    diff = torch.where(same, torch.zeros_like(a), (a - b).abs())
    diff = torch.where(one_nan, torch.full_like(a, math.inf), diff)
    return float(diff.max()) if diff.numel() else 0.0


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / MEM_BPS * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def timing(fn, plain, reps, plain_reps, bytes_moved, flops, library=None,
           label=None):
    """Kernel, plain-version and (optional) library times with the bound,
    as the keyword arguments of a ``check`` line."""
    bms, by = bound(bytes_moved, flops)
    return dict(kernel_ms=time_ms(fn, reps),
                plain_ms=time_ms(plain, plain_reps),
                library_ms=time_ms(library, 2) if library else None,
                library=label, bound_ms=bms, bound_by=by)


def note(summary, name, err, kw=None):
    """Keep the largest error of ``name`` in ``summary``, and the timing
    ``kw`` (from :func:`timing`) of the summary's case."""
    summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], err)
    if kw:
        summary[name].update(
            ms=kw["kernel_ms"], **{k: kw[k] for k in (
                "plain_ms", "library_ms", "bound_ms", "bound_by")})


# ---------------------------------------------------------------------------
# phase 1


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    from repro_torch.kernels import build
    t0 = time.time()
    build.lib()
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, kernel_build_s=round(time.time() - t0, 3),
         build_cached=build.BUILD_INFO.get("cached"))
    return card


# ---------------------------------------------------------------------------
# phase 2


def check(name, ok, **kw):
    emit("kernels", kernel=name, ok=bool(ok), **kw)
    if not ok:
        fail(f"kernel {name} disagrees with its plain version: {kw}")


def kernel_checks(num_params):
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain
    from repro_torch.kernels.masked import sign_vote_plain
    from repro_torch.kernels.pairwise import gram_plain
    from repro_torch.kernels.select import krum_select_plain
    from repro_torch.kernels.wsum import weighted_sum_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    summary = {k: {"max_abs_err": 0.0} for k in SYNC_KERNELS}
    agg_ms = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        x = (torch.randn((N, P), generator=gen, device=DEVICE,
                         dtype=torch.float32) * 1e-3).to(dtype)
        main = dtype == torch.bfloat16       # the main path's arena dtype
        # K1 coord_stat
        for stat, b in (("median", 0), ("trimmed_mean", 2)):
            out = kernels.coord_stat(x, stat, b)
            ref = coord_stat_plain(x, stat, b)
            err = max_abs_err(out, ref)
            ok = err == 0.0 if stat == "median" else err <= TOL * (
                1 + float(ref.abs().max()))
            ms = time_ms(lambda: kernels.coord_stat(x, stat, b), 10)
            pms = time_ms(lambda: coord_stat_plain(x, stat, b), 2)
            lms = time_ms(lambda: torch.sort(x, dim=0), 2)
            bms, by = bound(N * P * s + 4 * P, N * (N - 1) // 2 * 2 * P)
            check("coord_stat", ok, stat=stat, dtype=dname, shape=[N, P],
                  max_abs_diff=err, exact=err == 0.0, kernel_ms=ms,
                  plain_ms=pms, library_ms=lms, library="torch.sort(dim=0)",
                  bound_ms=bms, bound_by=by)
            summary["coord_stat"]["max_abs_err"] = max(
                summary["coord_stat"]["max_abs_err"], err)
            if main and stat == "median":
                summary["coord_stat"].update(ms=ms, plain_ms=pms,
                                             library_ms=lms, bound_ms=bms,
                                             bound_by=by)
        # K2 gram
        gr = kernels.gram(x)
        ref = gram_plain(x)
        err = max_abs_err(gr, ref)
        ok = bool(torch.allclose(gr, ref, rtol=TOL, atol=TOL))
        rep = kernels.gram(x)
        ok = ok and torch.equal(gr, rep)            # repeats bit for bit
        ms = time_ms(lambda: kernels.gram(x), 10)
        pms = time_ms(lambda: gram_plain(x), 2)
        lms = time_ms(lambda: x @ x.T, 5)
        bms, by = bound(N * P * s + 4 * N * N, N * (N + 1) // 2 * 2 * P)
        check("gram", ok, dtype=dname, shape=[N, P], max_abs_diff=err,
              exact=err == 0.0, bitwise_repeat=True, kernel_ms=ms,
              plain_ms=pms, library_ms=lms, library="x @ x.T",
              bound_ms=bms, bound_by=by)
        summary["gram"]["max_abs_err"] = max(summary["gram"]["max_abs_err"],
                                             err)
        if main:
            summary["gram"].update(ms=ms, plain_ms=pms, library_ms=lms,
                                   bound_ms=bms, bound_by=by)
        # K3 krum_select
        w = kernels.krum_select(gr, F)
        wref = krum_select_plain(gr, F)
        err = max_abs_err(w, wref)
        ms = time_ms(lambda: kernels.krum_select(gr, F), 50)
        pms = time_ms(lambda: krum_select_plain(gr, F), 5)
        bms, by = bound(4 * N * N + 4 * N, N * N * (N + 4))
        check("krum_select", err == 0.0 and float(w.sum()) == 1.0,
              dtype="float32", shape=[N, N], max_abs_diff=err, exact=err == 0,
              kernel_ms=ms, plain_ms=pms, library_ms=None, bound_ms=bms,
              bound_by=by)
        summary["krum_select"]["max_abs_err"] = max(
            summary["krum_select"]["max_abs_err"], err)
        if main:
            summary["krum_select"].update(ms=ms, plain_ms=pms,
                                          library_ms=None, bound_ms=bms,
                                          bound_by=by)
        # K4 weighted_sum with Krum's one-hot: exactly the selected row
        sel = int(torch.argmax(w))
        out = kernels.weighted_sum(w, x)
        ref = weighted_sum_plain(w, x)
        err = max(max_abs_err(out, ref), max_abs_err(out, x[sel].float()))
        ms = time_ms(lambda: kernels.weighted_sum(w, x), 10)
        pms = time_ms(lambda: weighted_sum_plain(w, x), 5)
        wl = w.to(dtype)
        lms = time_ms(lambda: wl @ x, 5)
        nsel = int((w > 0).sum())          # rows this w makes it read
        bms, by = bound(nsel * P * s + 4 * P + 4 * N, 2 * nsel * P)
        check("weighted_sum", err == 0.0, dtype=dname, shape=[N, P],
              weights="krum one-hot", max_abs_diff=err, exact=err == 0.0,
              kernel_ms=ms, plain_ms=pms, library_ms=lms,
              library="w @ x", bound_ms=bms, bound_by=by)
        summary["weighted_sum"]["max_abs_err"] = max(
            summary["weighted_sum"]["max_abs_err"], err)
        if main:
            summary["weighted_sum"].update(ms=ms, plain_ms=pms,
                                           library_ms=lms, bound_ms=bms,
                                           bound_by=by)
        # K15 sign_vote: the vote is exact, so the kernel equals its plain
        # version bit for bit
        out = kernels.sign_vote(x)
        err = max_abs_err(out, sign_vote_plain(x))
        del out
        ms = time_ms(lambda: kernels.sign_vote(x), 10)
        pms = time_ms(lambda: sign_vote_plain(x), 2)
        lms = time_ms(lambda: torch.sign(torch.sign(x).sum(0)), 2)
        bms, by = bound(N * P * s + 4 * P, 2 * N * P)
        check("sign_vote", err == 0.0, dtype=dname, shape=[N, P],
              max_abs_diff=err, exact=err == 0.0, kernel_ms=ms,
              plain_ms=pms, library_ms=lms,
              library="torch.sign(torch.sign(g).sum(0)), a partial "
                      "yardstick (three calls)", bound_ms=bms, bound_by=by)
        summary["sign_vote"]["max_abs_err"] = max(
            summary["sign_vote"]["max_abs_err"], err)
        if main:
            summary["sign_vote"].update(ms=ms, plain_ms=pms, library_ms=lms,
                                        bound_ms=bms, bound_by=by)
        # aggregation time of each rule on this arena (the spec's call)
        if main:
            from repro_torch.core.aggregators import make_spec
            for rule in RULES + tuple(SIGN_RULES):
                spec = make_spec(rule, f=F, n=N)
                agg_ms[rule] = time_ms(lambda: spec.aggregate_flat(x), 5)
            emit("kernels", aggregation_ms=agg_ms, dtype=dname)
        del x, gr
        torch.cuda.empty_cache()
    hazard_checks()
    sign_hazard_checks()
    return summary, agg_ms


def sign_hazard_checks():
    """K15 and K16 on NaN, +-inf and +-0 values (and, for K16, NaN / +inf
    in an absent row, which casts no vote: ROADMAP.md P10) at a small width
    and n = 3, 8, 11: exact against the plain versions."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import (masked_sign_vote_plain,
                                            sign_vote_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(9)
    d = 4099
    for n in (3, 8, 11):
        m = arrival_mask(max(n - 2, 1), n)
        for hazard in ("nan", "inf", "zeros", "absent"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=gen, device=DEVICE)
                if hazard == "nan":
                    x[0, ::7] = math.nan
                elif hazard == "inf":
                    x[0, ::3], x[n - 1, 1::3] = math.inf, -math.inf
                elif hazard == "zeros":
                    x[:, ::2] = 0.0
                    x[: n // 2, ::4] = -0.0
                else:
                    x[n - 1, ::2], x[n - 1, 1::2] = math.nan, math.inf
                x = x.to(dtype)
                errs = {"sign_vote": max_abs_err(kernels.sign_vote(x),
                                                 sign_vote_plain(x))}
                out = kernels.masked_sign_vote(x, m, m)
                errs["masked_sign_vote"] = max_abs_err(
                    out, masked_sign_vote_plain(x, m, m))
                torch.cuda.synchronize()
                ok = all(v == 0.0 for v in errs.values())
                if hazard == "absent":
                    ok = ok and bool(torch.isfinite(out).all())
                check("sign_hazards", ok, hazard=hazard, n=n,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=errs)


def hazard_checks():
    """NaN row, +-inf rows, tied rows and values, at a small width."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_stat_plain
    from repro_torch.kernels.pairwise import gram_plain
    from repro_torch.kernels.select import krum_select_plain
    from repro_torch.kernels.wsum import weighted_sum_plain

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    d = 4099
    for hazard in ("nan", "inf", "ties", "spots"):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn((N, d), generator=gen, device=DEVICE) * 2.0
            if hazard == "nan":
                x[1] = math.nan
            elif hazard == "inf":
                x[1], x[4] = math.inf, -math.inf
            elif hazard == "ties":
                x[1] = x[0]
                x[2] = x[0]
                x[5] = torch.round(x[5])
            else:
                x[1, 7], x[3, 7], x[5, 11] = math.nan, math.inf, -math.inf
            x = x.to(dtype)
            errs, close = {}, {}
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                out = kernels.coord_stat(x, stat, b)
                ref = coord_stat_plain(x, stat, b)
                errs[stat] = max_abs_err(out, ref)
                close[stat] = bool(torch.allclose(out, ref, rtol=TOL,
                                                  atol=TOL, equal_nan=True))
            gr = kernels.gram(x)
            if hazard == "ties":
                ref = gram_plain(x)
                errs["gram"] = max_abs_err(gr, ref)
                close["gram"] = bool(torch.allclose(gr, ref, rtol=TOL,
                                                    atol=TOL))
            w = kernels.krum_select(gr, F)
            errs["krum_select"] = max_abs_err(w, krum_select_plain(gr, F))
            errs["weighted_sum"] = max_abs_err(
                kernels.weighted_sum(w, x), weighted_sum_plain(w, x))
            torch.cuda.synchronize()
            ok = (errs["median"] == 0.0 and close["trimmed_mean"]
                  and close.get("gram", True)
                  and errs["krum_select"] == 0.0
                  and errs["weighted_sum"] == 0.0
                  and float(w.sum()) == 1.0)
            check("hazards", ok, hazard=hazard,
                  dtype=str(dtype).replace("torch.", ""), shape=[N, d],
                  max_abs_diff=errs)


# ---------------------------------------------------------------------------
# phase 2b


def arrival_mask(arrived, n=N):
    """(n,) {0,1} fp32 mask with the first ``arrived`` rows arrived."""
    m = torch.zeros(n, device=DEVICE)
    m[:arrived] = 1.0
    return m


def discount_weights(m):
    """Staleness discounts {1, 1/2, 1/3} on the arrived rows and the
    normalized wn = w / tot the kernels take."""
    n = m.shape[0]
    w = m * torch.tensor([1.0, 0.5, 1.0 / 3.0] * n, device=m.device)[:n]
    return w, w / torch.clamp_min(w.sum(), 1e-30)


def masked_kernel_checks(num_params):
    """K5, K6, K7 and the imputed mean at the main path's shapes; the
    summary takes the fp32 arena's numbers (the async arena is fp32)."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_coord_stat_plain
    from repro_torch.kernels.pairwise import masked_gram_plain
    from repro_torch.kernels.ref import imputed_mean_ref
    from repro_torch.kernels.select import krum_select_plain
    from repro_torch.kernels.wsum import masked_weighted_sum_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    summary = {k: {"max_abs_err": 0.0} for k in SOURCES
               if k.startswith("masked")}
    summary["imputed_mean"] = {"max_abs_err": 0.0}

    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        main = dtype == torch.float32
        x = (torch.randn((N, P), generator=gen, device=DEVICE,
                         dtype=torch.float32) * 1e-3).to(dtype)
        for arrived in (6, 1, 0):
            m = arrival_mask(arrived)
            _, wn = discount_weights(m)
            timed = arrived == 6                  # the straggler rows' mask
            # K5 masked_coord_stat
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                out = kernels.masked_coord_stat(x, m, wn, stat, b)
                ref = masked_coord_stat_plain(x, m, wn, stat, b)
                err = max_abs_err(out, ref)
                ok = err == 0.0 if stat == "median" else bool(
                    torch.allclose(out, ref, rtol=TOL, atol=TOL))
                if arrived == 0:
                    ok = ok and not bool(out.any())
                kw = {}
                if timed:
                    ms = time_ms(lambda: kernels.masked_coord_stat(
                        x, m, wn, stat, b), 10)
                    pms = time_ms(lambda: masked_coord_stat_plain(
                        x, m, wn, stat, b), 2)
                    lms = time_ms(lambda: torch.sort(x, dim=0), 2)
                    bms, by = bound(arrived * P * s + 4 * P,
                                    N * (N - 1) // 2 * 2 * P)
                    kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                              library="torch.sort(dim=0)", bound_ms=bms,
                              bound_by=by)
                check("masked_coord_stat", ok, stat=stat, dtype=dname,
                      shape=[N, P], arrived=arrived, max_abs_diff=err,
                      exact=err == 0.0, **kw)
                note(summary, "masked_coord_stat", err,
                     main and stat == "trimmed_mean" and kw)
                del out, ref
            if arrived == 0:
                continue
            # the imputed mean, through K4
            mean = kernels.imputed_mean(x, wn)
            ref = imputed_mean_ref(x, wn)
            err = max_abs_err(mean, ref)
            ok = bool(torch.allclose(mean.float(), ref.float(), rtol=TOL,
                                     atol=TOL))
            kw = {}
            if timed:
                ms = time_ms(lambda: kernels.imputed_mean(x, wn), 10)
                pms = time_ms(lambda: imputed_mean_ref(x, wn), 2)
                wl = wn.to(dtype)
                lms = time_ms(lambda: wl @ x, 5)
                bms, by = bound(arrived * P * s + P * s,
                                2 * arrived * P)
                kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                          library="w @ x", bound_ms=bms, bound_by=by)
            check("imputed_mean", ok, via="weighted_sum", dtype=dname,
                  shape=[N, P], arrived=arrived, max_abs_diff=err,
                  exact=err == 0.0, **kw)
            note(summary, "imputed_mean", err, main and kw)
            # K6 masked_gram, then K3 on it
            gr = kernels.masked_gram(x, m, wn, mean)
            ref = masked_gram_plain(x, m, wn, mean)
            err = max_abs_err(gr, ref)
            ok = (bool(torch.allclose(gr, ref, rtol=TOL, atol=TOL))
                  and torch.equal(gr, kernels.masked_gram(x, m, wn, mean)))
            sel = kernels.krum_select(gr, F)
            ok = ok and torch.equal(sel, krum_select_plain(gr, F))
            kw = {}
            if timed:
                ms = time_ms(lambda: kernels.masked_gram(x, m, wn, mean), 10)
                pms = time_ms(lambda: masked_gram_plain(x, m, wn, mean), 2)
                lms = time_ms(lambda: x @ x.T, 5)
                bms, by = bound(arrived * P * s + P * s + 4 * N * N,
                                N * (N + 1) // 2 * 2 * P)
                kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                          library="x @ x.T", bound_ms=bms, bound_by=by)
            check("masked_gram", ok, dtype=dname, shape=[N, P],
                  arrived=arrived, max_abs_diff=err, exact=err == 0.0,
                  bitwise_repeat=True, krum_select_exact=True, **kw)
            note(summary, "masked_gram", err, main and kw)
            del gr, ref
            # K7 masked_weighted_sum: one-hot live, one-hot ghost, a set
            eye = torch.eye(N, device=DEVICE)
            cases = [("one-hot live", eye[0], x[0].float())]
            if arrived < N:
                cases.append(("one-hot ghost", eye[N - 1], mean.float()))
                cases.append(("{0,1} set", eye[0] + eye[1] + eye[N - 1],
                              None))
            for label, w, want in cases:
                out = kernels.masked_weighted_sum(w, x, m, mean)
                ref = masked_weighted_sum_plain(w, x, m, mean)
                err = max_abs_err(out, ref)
                if want is None:
                    ok = bool(torch.allclose(out, ref, rtol=TOL, atol=TOL))
                else:
                    err = max(err, max_abs_err(out, want))
                    ok = err == 0.0
                kw = {}
                if timed and label == "one-hot live":
                    ms = time_ms(lambda: kernels.masked_weighted_sum(
                        w, x, m, mean), 10)
                    pms = time_ms(lambda: masked_weighted_sum_plain(
                        w, x, m, mean), 5)
                    wl = w.to(dtype)
                    lms = time_ms(lambda: wl @ x, 5)
                    bms, by = bound(P * s + 4 * P + 8 * N, 2 * P)
                    kw = dict(kernel_ms=ms, plain_ms=pms, library_ms=lms,
                              library="w @ x", bound_ms=bms, bound_by=by)
                check("masked_weighted_sum", ok, weights=label, dtype=dname,
                      shape=[N, P], arrived=arrived, max_abs_diff=err,
                      exact=err == 0.0, **kw)
                note(summary, "masked_weighted_sum", err, main and kw)
                del out, ref
            del mean
        del x
        torch.cuda.empty_cache()
    note(summary, "masked_coord_stat", masked_bucket_checks(P, gen))
    masked_hazard_checks()
    return summary


# (bucket n, live rows, trimmed b = the bucket's f): the masks that the
# elastic churn run of phase 3b gives K5 (live 6, 4, 7 and 3 of buckets 6,
# 4, 8 and 4), the ghost rows packed as repeats of the first live slot
CHURN_BUCKETS = ((4, 4, 1), (4, 3, 1), (6, 6, 1), (8, 7, 2))


def masked_bucket_checks(P, gen):
    """K5 at full width, fp32 (the async arena), at the elastic churn
    run's bucket shapes and masks: median exact, trimmed mean within
    3e-6 of the plain version.  Returns the largest error."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_coord_stat_plain

    x = torch.randn((N, P), generator=gen, device=DEVICE) * 1e-3
    worst = 0.0
    for n, live, b in CHURN_BUCKETS:
        xb = x[:n]
        xb[live:] = xb[0]                      # ghost rows: the first slot
        m = arrival_mask(live, n)
        _, wn = discount_weights(m)
        for stat, bb in (("median", 0), ("trimmed_mean", b)):
            out = kernels.masked_coord_stat(xb, m, wn, stat, bb)
            ref = masked_coord_stat_plain(xb, m, wn, stat, bb)
            err = max_abs_err(out, ref)
            ok = err == 0.0 if stat == "median" else bool(
                torch.allclose(out, ref, rtol=TOL, atol=TOL))
            check("masked_coord_stat", ok, stat=stat, dtype="float32",
                  shape=[n, P], arrived=live, bucket=True, max_abs_diff=err,
                  exact=err == 0.0)
            worst = max(worst, err)
            del out, ref
    del x
    torch.cuda.empty_cache()
    return worst


def masked_hazard_checks():
    """NaN in an arrived row, NaN / +-inf in an absent row, +-inf arrived
    rows, ties, at a small width and n = 3, 4, 6, 8."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_coord_stat_plain
    from repro_torch.kernels.pairwise import masked_gram_plain
    from repro_torch.kernels.wsum import masked_weighted_sum_plain

    gen = torch.Generator(device=DEVICE).manual_seed(4)
    d = 4099
    for n in (3, 4, 6, 8):
        b = min(2 if n == 8 else 1, (n - 1) // 2)
        m = arrival_mask(max(n - 2, 1), n)
        _, wn = discount_weights(m)
        live, absent = int(m.sum()), n - int(m.sum())
        for hazard in ("nan", "absent", "inf", "ties"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=gen, device=DEVICE) * 2.0
                if hazard == "nan":
                    x[0] = math.nan
                elif hazard == "absent" and absent:
                    x[n - 1, ::2] = math.nan
                    x[n - 1, 1::2] = math.inf
                elif hazard == "inf":
                    x[0], x[live - 1] = math.inf, -math.inf
                elif hazard == "ties":
                    x[:live] = x[0].clone()
                    x[:, ::3] = torch.round(x[:, ::3])
                x = x.to(dtype)
                errs, ok = {}, True
                for stat, bb in (("median", 0), ("trimmed_mean", b)):
                    out = kernels.masked_coord_stat(x, m, wn, stat, bb)
                    ref = masked_coord_stat_plain(x, m, wn, stat, bb)
                    errs[stat] = max_abs_err(out, ref)
                    ok = ok and (errs[stat] == 0.0 if stat == "median"
                                 else bool(torch.allclose(
                                     out, ref, rtol=TOL, atol=TOL,
                                     equal_nan=True)))
                    if hazard == "absent":
                        ok = ok and bool(torch.isfinite(out).all())
                if hazard in ("absent", "ties"):
                    mean = kernels.imputed_mean(x, wn)
                    gr = kernels.masked_gram(x, m, wn, mean)
                    ref = masked_gram_plain(x, m, wn, mean)
                    errs["masked_gram"] = max_abs_err(gr, ref)
                    ok = ok and bool(torch.allclose(gr, ref, rtol=TOL,
                                                    atol=TOL))
                    w = kernels.krum_select(gr, 1)
                    out = kernels.masked_weighted_sum(w, x, m, mean)
                    errs["masked_weighted_sum"] = max_abs_err(
                        out, masked_weighted_sum_plain(w, x, m, mean))
                    ok = (ok and errs["masked_weighted_sum"] == 0.0
                          and bool(torch.isfinite(out).all()))
                torch.cuda.synchronize()
                check("masked_hazards", ok, hazard=hazard, n=n,
                      arrived=live, dtype=str(dtype).replace("torch.", ""),
                      shape=[n, d], max_abs_diff=errs)


# ---------------------------------------------------------------------------
# phase 2c


def selection_kernel_checks(num_params):
    """K8-K11 and K13 against their plain versions at the main path's
    shapes (see the module docstring), then the small-width hazards.  The
    summary takes the bf16 arena's numbers (the sync arena): K8 and K9 at
    n = 8, K10 at n = 8 with m_krum's 3 picks, K11 with multi_krum's
    order, K13 at n = 11."""
    from repro_torch import kernels
    from repro_torch.kernels.ops import mda_order
    from repro_torch.kernels.select import (bulyan_beta, bulyan_coord_plain,
                                            cge_select_plain, gram_d2,
                                            iterative_order_plain,
                                            multi_krum_order_plain)
    from repro_torch.kernels.wsum import ordered_apply_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    names = ("cge_select", "multi_krum_order", "iterative_order",
             "ordered_apply", "bulyan_coord")
    summary = {k: {"max_abs_err": 0.0} for k in names}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        main = dtype == torch.bfloat16
        for n in (N, 11):
            theta = n - 2 * F
            x = (torch.randn((n, P), generator=gen, device=DEVICE,
                             dtype=torch.float32) * 1e-3).to(dtype)
            gr = kernels.gram(x)
            sym = torch.equal(gr, gr.T)
            timed = main and n == N
            # K8 cge_select
            w = kernels.cge_select(gr, n - F)
            err = max_abs_err(w, cge_select_plain(gr, n - F))
            kw = timing(lambda: kernels.cge_select(gr, n - F),
                        lambda: cge_select_plain(gr, n - F), 50, 5,
                        8 * n, 2 * n * n) if timed else {}
            check("cge_select", err == 0.0 and sym
                  and float(w.sum()) == n - F, dtype=dname, n=n,
                  n_keep=n - F, gram_symmetric=sym, max_abs_diff=err, **kw)
            note(summary, "cge_select", err, kw)
            # K9 multi_krum_order
            for m in (2, 3):
                o = kernels.multi_krum_order(gr, F, m)
                err = max_abs_err(o.float(),
                                  multi_krum_order_plain(gr, F, m).float())
                ok = err == 0.0 and sorted(o[o < n].tolist()) == list(
                    range(m))
                kw = timing(lambda: kernels.multi_krum_order(gr, F, m),
                            lambda: multi_krum_order_plain(gr, F, m), 50, 5,
                            4 * n * n + 4 * n, n * n * (n + 4)) if (
                    timed and m == 3) else {}
                check("multi_krum_order", ok, dtype=dname, n=n, m=m,
                      max_abs_diff=err, **kw)
                note(summary, "multi_krum_order", err, kw)
            # K10 iterative_order
            for k_total in sorted({2, 3, theta}):
                o = kernels.iterative_order(gr, F, k_total)
                err = max_abs_err(o.float(), iterative_order_plain(
                    gr, F, k_total).float())
                ok = err == 0.0 and sorted(o[o < n].tolist()) == list(
                    range(k_total))
                kw = timing(lambda: kernels.iterative_order(gr, F, k_total),
                            lambda: iterative_order_plain(gr, F, k_total),
                            50, 5, 4 * n * n + 4 * n,
                            k_total * n * n * (n + 4)) if (
                    main and (n, k_total) in ((N, 3), (11, theta))) else {}
                check("iterative_order", ok, dtype=dname, n=n,
                      k_total=k_total, max_abs_diff=err, **kw)
                note(summary, "iterative_order", err,
                     kw if (n, k_total) == (N, 3) else None)
            # K11 ordered_apply with the orders of the three rules
            if n == N:
                cases = (("multi_krum", kernels.multi_krum_order(gr, F, 3),
                          3),
                         ("m_krum", kernels.iterative_order(gr, F, 3), 3),
                         ("mda", mda_order(gram_d2(gr), n, F), n - F))
                for rule, order, k in cases:
                    out = kernels.ordered_apply(order, x, k, div=k)
                    err = max_abs_err(out, ordered_apply_plain(order, x, k,
                                                               div=k))
                    wl = torch.where(order < k, 1.0 / k, 0.0).to(dtype)
                    kw = timing(
                        lambda: kernels.ordered_apply(order, x, k, div=k),
                        lambda: ordered_apply_plain(order, x, k, div=k),
                        10, 2, k * P * s + 4 * P + 4 * n, (k + 1) * P,
                        lambda: wl @ x, "w @ x, w = 1/k on the picked rows")
                    check("ordered_apply", err == 0.0, dtype=dname, n=n,
                          k=k, order_of=rule, shape=[n, P],
                          max_abs_diff=err, **kw)
                    note(summary, "ordered_apply", err,
                         kw if main and rule == "multi_krum" else None)
                    del out
            # K13 bulyan_coord on K10's theta picks
            sel = (kernels.iterative_order(gr, F, theta) < theta).float()
            beta = bulyan_beta(theta, F)
            out = kernels.bulyan_coord(x, sel, theta, F)
            err = max_abs_err(out, bulyan_coord_plain(x, sel, theta, F))
            del out
            picked = sel > 0.5
            kw = timing(lambda: kernels.bulyan_coord(x, sel, theta, F),
                        lambda: bulyan_coord_plain(x, sel, theta, F), 10, 2,
                        theta * P * s + 4 * P + 4 * n,
                        (n * (n - 1) + 3 * beta * n) * P,
                        lambda: torch.sort(x[picked], dim=0),
                        "torch.sort(g[sel], dim=0), a partial yardstick")
            check("bulyan_coord", err == 0.0, dtype=dname, n=n, theta=theta,
                  beta=beta, shape=[n, P], max_abs_diff=err, **kw)
            note(summary, "bulyan_coord", err,
                 kw if main and n == 11 else None)
            # aggregation time of each selection rule at this n (the
            # spec's call, every stage included)
            if main:
                from repro_torch.core.aggregators import make_spec
                agg_ms = {}
                for rule, (rn, hyper, _) in SEL_RULES.items():
                    if rn == n:
                        spec = make_spec(rule, f=F, n=n, **hyper)
                        agg_ms[rule] = time_ms(
                            lambda: spec.aggregate_flat(x), 5)
                emit("kernels", aggregation_ms=agg_ms, dtype=dname, n=n)
            del x, gr, sel
            torch.cuda.empty_cache()
    selection_hazard_checks()
    return summary


def selection_hazard_checks():
    """K8-K11 and K13 on NaN rows, +-inf rows, isolated non-finite
    coordinates, duplicated rows (every score tied) and a near pair (the
    K10 pair tie), with rounded columns (equidistant values), at a small
    width and n = 3, 4, 8, 11, 16: every result exact against the plain
    version, the card's Gram bitwise symmetric."""
    from repro_torch import kernels
    from repro_torch.kernels.select import (bulyan_coord_plain,
                                            cge_select_plain,
                                            iterative_order_plain,
                                            multi_krum_order_plain)
    from repro_torch.kernels.wsum import ordered_apply_plain

    gen = torch.Generator(device=DEVICE).manual_seed(8)
    d = 4099
    for n in (3, 4, 8, 11, 16):
        f = 1 if n < 8 else F
        theta = max(n - 2 * f, 1)
        for hazard in ("nan", "inf", "spots", "dup", "pair"):
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn((n, d), generator=gen, device=DEVICE) * 2.0
                x[:, ::5] = torch.round(x[:, ::5])
                if hazard == "nan":
                    x[1] = math.nan
                elif hazard == "inf":
                    x[1], x[n - 1] = math.inf, -math.inf
                elif hazard == "spots":
                    x[1, 7], x[n - 1, 7], x[0, 11] = (math.nan, math.inf,
                                                      -math.inf)
                elif hazard == "dup":
                    x[:] = x[0].clone()
                else:
                    x[n - 1] = x[n - 2] + 1e-3
                x = x.to(dtype)
                gr = kernels.gram(x)
                errs = {"gram_symmetry": max_abs_err(gr, gr.T)}
                errs["cge_select"] = max_abs_err(
                    kernels.cge_select(gr, n - f), cge_select_plain(gr, n - f))
                m = min(3, n)
                errs["multi_krum_order"] = max_abs_err(
                    kernels.multi_krum_order(gr, f, m).float(),
                    multi_krum_order_plain(gr, f, m).float())
                ok = True
                for k_total in sorted({m, theta, n}):
                    o = kernels.iterative_order(gr, f, k_total)
                    errs[f"iterative_order_{k_total}"] = max_abs_err(
                        o.float(), iterative_order_plain(gr, f,
                                                         k_total).float())
                    ok = ok and sorted(o[o < n].tolist()) == list(
                        range(k_total))
                for order in (kernels.multi_krum_order(gr, f, m),
                              kernels.iterative_order(gr, f, m)):
                    errs["ordered_apply"] = max(
                        errs.get("ordered_apply", 0.0),
                        max_abs_err(kernels.ordered_apply(order, x, m, div=m),
                                    ordered_apply_plain(order, x, m, div=m)))
                sel = (kernels.iterative_order(gr, f, theta)
                       < theta).float()
                errs["bulyan_coord"] = max_abs_err(
                    kernels.bulyan_coord(x, sel, theta, f),
                    bulyan_coord_plain(x, sel, theta, f))
                torch.cuda.synchronize()
                ok = ok and all(v == 0.0 for v in errs.values())
                check("selection_hazards", ok, hazard=hazard, n=n, f=f,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=errs)


# ---------------------------------------------------------------------------
# phase 2d


def ghost_first_order(m, k):
    """(n,) int32 pick order with the first absent row at rank 0 and the
    first k - 1 live rows after it (sentinel n elsewhere)."""
    n = m.shape[0]
    order = torch.full((n,), n, dtype=torch.int32, device=m.device)
    rows = (torch.nonzero(m <= 0.5).flatten()[:1].tolist()
            + torch.nonzero(m > 0.5).flatten().tolist())[:k]
    order[rows] = torch.arange(len(rows), dtype=torch.int32, device=m.device)
    return order


def with_ghost(sel, m):
    """``sel`` with its last selected live row swapped for the first absent
    row, when no absent row is selected yet (else ``sel`` itself)."""
    picked, live = sel > 0.5, m > 0.5
    if bool((picked & ~live).any()) or bool(live.all()):
        return sel
    out = sel.clone()
    out[torch.nonzero(picked & live).flatten()[-1]] = 0.0
    out[torch.nonzero(~live).flatten()[0]] = 1.0
    return out


def masked_selection_kernel_checks(num_params):
    """K12, K14 and K16 against their plain versions at the main path's
    shapes (see the module docstring), then the small-width hazards.  The
    ghost rows are the last ones (the mask's first rows arrive).  The
    summary takes the fp32 buffer's numbers (the async arena): K12 with
    multi_krum's order, K14 at n = 11 on K10's picks, K16 at 6 of 8."""
    from repro_torch import kernels
    from repro_torch.kernels.masked import masked_sign_vote_plain
    from repro_torch.kernels.ops import mda_order
    from repro_torch.kernels.select import (bulyan_beta, gram_d2,
                                            masked_bulyan_coord_plain)
    from repro_torch.kernels.wsum import masked_ordered_apply_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    names = ("masked_ordered_apply", "masked_bulyan_coord",
             "masked_sign_vote")
    summary = {k: {"max_abs_err": 0.0} for k in names}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).replace("torch.", "")
        s = torch.finfo(dtype).bits // 8
        main = dtype == torch.float32
        for n, arrived in ((N, 6), (11, 9)):
            x = (torch.randn((n, P), generator=gen, device=DEVICE,
                             dtype=torch.float32) * 1e-3).to(dtype)
            m = arrival_mask(arrived, n)
            live = m > 0.5
            _, wn = discount_weights(m)
            mean = kernels.imputed_mean(x, wn)
            gr = kernels.masked_gram(x, m, wn, mean)
            if n == N:
                # K12 with the rules' orders on the imputed Gram
                cases = (("multi_krum", kernels.multi_krum_order(gr, F, 3),
                          3),
                         ("m_krum", kernels.iterative_order(gr, F, 3), 3),
                         ("mda", mda_order(gram_d2(gr), n, F), n - F),
                         ("ghost first", ghost_first_order(m, 3), 3))
                for rule, order, k in cases:
                    picked = order < k
                    ghost = bool((picked & ~live).any())
                    out = kernels.masked_ordered_apply(order, x, m, mean, k,
                                                       div=k)
                    err = max_abs_err(out, masked_ordered_apply_plain(
                        order, x, m, mean, k, div=k))
                    del out
                    reads = int((picked & live).sum()) + int(ghost)
                    kw = timing(
                        lambda: kernels.masked_ordered_apply(
                            order, x, m, mean, k, div=k),
                        lambda: masked_ordered_apply_plain(
                            order, x, m, mean, k, div=k), 10, 2,
                        reads * P * s + 4 * P + 8 * n, (k + 1) * P) if (
                        rule != "ghost first") else {}
                    check("masked_ordered_apply", err == 0.0, dtype=dname,
                          n=n, k=k, order_of=rule, arrived=arrived,
                          ghost_picked=ghost, shape=[n, P],
                          max_abs_diff=err, **kw)
                    note(summary, "masked_ordered_apply", err,
                         kw if main and rule == "multi_krum" else None)
                # K16 at masks of 6, 1 and 0 of 8
                for arr in (6, 1, 0):
                    mm = arrival_mask(arr, n)
                    out = kernels.masked_sign_vote(x, mm, mm)
                    err = max_abs_err(out, masked_sign_vote_plain(x, mm, mm))
                    ok = err == 0.0 and (arr > 0 or not bool(out.any()))
                    del out
                    kw = timing(
                        lambda: kernels.masked_sign_vote(x, mm, mm),
                        lambda: masked_sign_vote_plain(x, mm, mm), 10, 2,
                        arr * P * s + 4 * P + 4 * n, 2 * arr * P,
                        lambda: torch.sign((torch.sign(x)
                                            * mm[:, None]).sum(0)),
                        "torch.sign((torch.sign(g) * mask[:, None]).sum(0))"
                        ", a partial yardstick (four calls)") if (
                        arr == 6) else {}
                    check("masked_sign_vote", ok, dtype=dname, n=n,
                          arrived=arr, shape=[n, P], max_abs_diff=err, **kw)
                    note(summary, "masked_sign_vote", err,
                         kw if main and arr == 6 else None)
            else:
                # K14 on K10's theta picks, then with a ghost selected
                theta = n - 2 * F
                beta = bulyan_beta(theta, F)
                sel = (kernels.iterative_order(gr, F, theta)
                       < theta).float()
                for label, sl in (("K10 picks", sel),
                                  ("ghost selected", with_ghost(sel, m))):
                    if label != "K10 picks" and sl is sel:
                        continue
                    picked = sl > 0.5
                    ghost = bool((picked & ~live).any())
                    out = kernels.masked_bulyan_coord(x, m, mean, sl, theta,
                                                      F)
                    err = max_abs_err(out, masked_bulyan_coord_plain(
                        x, m, mean, sl, theta, F))
                    del out
                    reads = int((picked & live).sum()) + int(ghost)
                    kw = timing(
                        lambda: kernels.masked_bulyan_coord(
                            x, m, mean, sl, theta, F),
                        lambda: masked_bulyan_coord_plain(
                            x, m, mean, sl, theta, F), 10, 2,
                        reads * P * s + 4 * P + 12 * n,
                        (n * (n - 1) + 3 * beta * n) * P,
                        lambda: torch.sort(x[picked], dim=0),
                        "torch.sort(g[sel], dim=0), a partial yardstick") if (
                        label == "K10 picks") else {}
                    check("masked_bulyan_coord", err == 0.0, dtype=dname,
                          n=n, theta=theta, beta=beta, arrived=arrived,
                          selection=label, ghost_selected=ghost,
                          shape=[n, P], max_abs_diff=err, **kw)
                    note(summary, "masked_bulyan_coord", err,
                         kw if main and label == "K10 picks" else None)
            del x, gr, mean
            torch.cuda.empty_cache()
    masked_selection_hazard_checks()
    return summary


def masked_selection_hazard_checks():
    """K12 and K14 on NaN and +-inf live rows, NaN / +inf in an absent row
    (never read), and tied rows with rounded columns, at a small width, n
    = 3, 4, 8, 11, 16 and n - 2 or 1 rows arrived: exact against the plain
    versions, a ghost among the picks and the selected rows."""
    from repro_torch import kernels
    from repro_torch.kernels.select import masked_bulyan_coord_plain
    from repro_torch.kernels.wsum import masked_ordered_apply_plain

    gen = torch.Generator(device=DEVICE).manual_seed(11)
    d = 4099
    for n in (3, 4, 8, 11, 16):
        f = 1 if n < 8 else F
        theta = max(n - 2 * f, 1)
        for arrived in (max(n - 2, 1), 1):
            m = arrival_mask(arrived, n)
            _, wn = discount_weights(m)
            for hazard in ("nan", "inf", "absent", "ties"):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn((n, d), generator=gen,
                                    device=DEVICE) * 2.0
                    x[:, ::5] = torch.round(x[:, ::5])
                    if hazard == "nan":
                        x[0, ::7] = math.nan
                    elif hazard == "inf":
                        x[0, ::3], x[arrived - 1, 1::3] = math.inf, -math.inf
                    elif hazard == "absent":
                        x[n - 1, ::2], x[n - 1, 1::2] = math.nan, math.inf
                    else:
                        x[:arrived] = x[0].clone()
                    x = x.to(dtype)
                    mean = kernels.imputed_mean(x, wn)
                    gr = kernels.masked_gram(x, m, wn, mean)
                    k = min(3, n)
                    errs = {}
                    for name, order in (
                            ("multi_krum", kernels.multi_krum_order(gr, f,
                                                                    k)),
                            ("m_krum", kernels.iterative_order(gr, f, k)),
                            ("ghost first", ghost_first_order(m, k))):
                        kk = int((order < n).sum())
                        errs[f"masked_ordered_apply {name}"] = max_abs_err(
                            kernels.masked_ordered_apply(order, x, m, mean,
                                                         kk, div=kk),
                            masked_ordered_apply_plain(order, x, m, mean, kk,
                                                       div=kk))
                    sel = (kernels.iterative_order(gr, f, theta)
                           < theta).float()
                    for label, sl in (("K10", sel),
                                      ("ghost", with_ghost(sel, m))):
                        errs[f"masked_bulyan_coord {label}"] = max_abs_err(
                            kernels.masked_bulyan_coord(x, m, mean, sl,
                                                        theta, f),
                            masked_bulyan_coord_plain(x, m, mean, sl, theta,
                                                      f))
                    torch.cuda.synchronize()
                    check("masked_selection_hazards",
                          all(v == 0.0 for v in errs.values()),
                          hazard=hazard, n=n, arrived=arrived,
                          dtype=str(dtype).replace("torch.", ""),
                          shape=[n, d], max_abs_diff=errs)
    # K14's all-inf rounds: at n = 16 (theta 12, beta 8) with 8 of the
    # selected values infinite in every third column, the last 4 rounds
    # find only +inf distances and take the first row, row 0: absent and
    # unselected, so its value is the (finite) mean, never its NaN bits
    n, theta = 16, 16 - 2 * F
    m = torch.ones(n, device=DEVICE)
    m[0] = 0.0
    sel = torch.zeros(n, device=DEVICE)
    sel[1:theta + 1] = 1.0
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn((n, d), generator=gen, device=DEVICE)
        x[0] = math.nan
        x[1:5, ::3], x[5:9, ::3] = math.inf, -math.inf
        x = x.to(dtype)
        mean = torch.full((d,), 0.25, device=DEVICE).to(dtype)
        out = kernels.masked_bulyan_coord(x, m, mean, sel, theta, F)
        err = max_abs_err(out, masked_bulyan_coord_plain(x, m, mean, sel,
                                                         theta, F))
        torch.cuda.synchronize()
        check("masked_selection_hazards",
              err == 0.0 and bool(torch.isfinite(out).all()),
              hazard="all-inf rounds", n=n, theta=theta,
              dtype=str(dtype).replace("torch.", ""), shape=[n, d],
              max_abs_diff={"masked_bulyan_coord": err})


# ---------------------------------------------------------------------------
# phase 2e


def scaled_kernel_checks(num_params):
    """K18, K19, K20 and K15 on codes at the main path's shapes (n = 8, P
    = 124,668,672), int8 and fp8 codes of a seeded fp32 arena quantized on
    the card, masks of 6, 1 and 0 of 8 arrived; the quantize time; the
    dequant-copy gate; the hazards at a small width.  The summary takes
    the int8 numbers (6 of 8 arrived for K19 and K20)."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.masked import (scaled_coord_stat_plain,
                                            scaled_masked_coord_stat_plain,
                                            scaled_masked_sign_vote_plain,
                                            sign_vote_plain)

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    names = ("scaled_coord_stat", "scaled_masked_coord_stat",
             "scaled_masked_sign_vote")
    summary = {k: {"max_abs_err": 0.0} for k in names}
    x = torch.randn((N, P), generator=gen, device=DEVICE) * 1e-3
    xb = x.bfloat16()                 # the synchronous step's arena dtype
    for qdt in QUANT:
        main = qdt == "int8"
        for arena in (x, xb):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            codes, qs = quantize_rows(arena, qdt)
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - base
            del codes, qs
            q_ms = time_ms(lambda: quantize_rows(arena, qdt), 3)
            emit("kernels", quantize_ms=q_ms, dtype=qdt, shape=[N, P],
                 arena=str(arena.dtype).replace("torch.", ""),
                 peak_rise_gb=rise / 1e9,
                 bound_ms=bound(arena.numel() * arena.element_size()
                                + N * P + 4 * N, 4 * N * P)[0])
        codes, qs = quantize_rows(x, qdt)
        # K18 scaled_coord_stat
        for stat, b in (("median", 0), ("trimmed_mean", 2)):
            out = kernels.scaled_coord_stat(codes, qs, stat, b)
            ref = scaled_coord_stat_plain(codes, qs, stat, b)
            err = max_abs_err(out, ref)
            ok = err == 0.0 if stat == "median" else bool(
                torch.allclose(out, ref, rtol=TOL, atol=TOL))
            del out, ref
            kw = timing(lambda: kernels.scaled_coord_stat(codes, qs, stat, b),
                        lambda: scaled_coord_stat_plain(codes, qs, stat, b),
                        10, 2, N * P + 4 * N + 4 * P,
                        N * (N - 1) // 2 * 2 * P + N * P)
            check("scaled_coord_stat", ok, stat=stat, dtype=qdt,
                  shape=[N, P], max_abs_diff=err, exact=err == 0.0, **kw)
            note(summary, "scaled_coord_stat", err,
                 main and stat == "median" and kw)
        for arrived in (6, 1, 0):
            m = arrival_mask(arrived)
            _, wn = discount_weights(m)
            timed = arrived == 6
            # K19 scaled_masked_coord_stat
            for stat, b in (("median", 0), ("trimmed_mean", 2)):
                out = kernels.scaled_masked_coord_stat(codes, qs, m, wn,
                                                       stat, b)
                ref = scaled_masked_coord_stat_plain(codes, qs, m, wn, stat,
                                                     b)
                err = max_abs_err(out, ref)
                ok = err == 0.0 if stat == "median" else bool(
                    torch.allclose(out, ref, rtol=TOL, atol=TOL))
                if arrived == 0:
                    ok = ok and not bool(out.any())
                del out, ref
                kw = timing(
                    lambda: kernels.scaled_masked_coord_stat(
                        codes, qs, m, wn, stat, b),
                    lambda: scaled_masked_coord_stat_plain(
                        codes, qs, m, wn, stat, b),
                    10, 2, arrived * P + 8 * N + 4 * P,
                    N * (N - 1) // 2 * 2 * P + arrived * P) if timed else {}
                check("scaled_masked_coord_stat", ok, stat=stat, dtype=qdt,
                      shape=[N, P], arrived=arrived, max_abs_diff=err,
                      exact=err == 0.0, **kw)
                note(summary, "scaled_masked_coord_stat", err,
                     main and stat == "trimmed_mean" and kw)
            # K20 scaled_masked_sign_vote
            out = kernels.scaled_masked_sign_vote(codes, qs, m, wn)
            err = max_abs_err(out, scaled_masked_sign_vote_plain(codes, qs,
                                                                 m, wn))
            ok = err == 0.0 and (arrived > 0 or not bool(out.any()))
            del out
            kw = timing(
                lambda: kernels.scaled_masked_sign_vote(codes, qs, m, wn),
                lambda: scaled_masked_sign_vote_plain(codes, qs, m, wn),
                10, 2, arrived * P + 8 * N + 4 * P,
                3 * arrived * P) if timed else {}
            check("scaled_masked_sign_vote", ok, dtype=qdt, shape=[N, P],
                  arrived=arrived, max_abs_diff=err, exact=err == 0.0, **kw)
            note(summary, "scaled_masked_sign_vote", err, main and kw)
        # K15 on the codes (the synchronous compressed sign_sgd)
        out = kernels.sign_vote(codes)
        err = max_abs_err(out, sign_vote_plain(codes))
        del out
        kw = timing(lambda: kernels.sign_vote(codes),
                    lambda: sign_vote_plain(codes), 10, 2,
                    N * P + 4 * P, 2 * N * P,
                    library=lambda: torch.sign(torch.sign(codes.float())
                                               .sum(0)),
                    label="torch.sign(torch.sign(codes.float()).sum(0)), a "
                          "partial yardstick (four calls)")
        check("sign_vote", err == 0.0, dtype=qdt, shape=[N, P],
              max_abs_diff=err, exact=err == 0.0, **kw)
        summary.setdefault("sign_vote_codes", {})[qdt] = kw
        dequant_copy_gate(codes, qs, P)
        del codes, qs
        torch.cuda.empty_cache()
    del x, xb
    torch.cuda.empty_cache()
    scaled_hazard_checks()
    return summary


def dequant_copy_gate(codes, qs, P):
    """``aggregate_flat(codes, mask=, weights=, scale=qs)`` of each scaled
    rule: on impl="kernel" the peak device memory may rise by at most 3 *
    P * 4 bytes over the call (a few (P,) fp32 vectors: no dequantized
    (n, P) copy); on impl="gather" (the engine-level dequantization) it
    must rise by at least n * P * 4."""
    from repro_torch.core.aggregators import make_spec
    n = codes.shape[0]
    m = arrival_mask(6).bool()
    w, _ = discount_weights(m.float())
    for rule in ("coordinate_median", "trimmed_mean", "sign_sgd"):
        rise = {}
        for impl in ("kernel", "gather"):
            spec = make_spec(rule, f=F, impl=impl, n=n)
            for mode, kw in (("sync", {}), ("masked", dict(mask=m,
                                                           weights=w))):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = spec.aggregate_flat(codes, scale=qs, **kw)
                torch.cuda.synchronize()
                rise[impl, mode] = torch.cuda.max_memory_allocated() - base
                del out
        ok = (all(rise["kernel", md] <= 3 * P * 4 for md in ("sync",
                                                              "masked"))
              and all(rise["gather", md] >= n * P * 4 for md in ("sync",
                                                                  "masked")))
        emit("dequant_copy_gate", rule=rule, dtype=str(codes.dtype).replace(
            "torch.", ""), ok=ok, kernel_rise_bytes=[rise["kernel", "sync"],
                                                    rise["kernel", "masked"]],
             gather_rise_bytes=[rise["gather", "sync"],
                                rise["gather", "masked"]],
             kernel_limit=3 * P * 4, gather_floor=n * P * 4)
        if not ok:
            fail(f"dequant-copy gate {rule}: peak rises {rise}")


def scaled_hazard_checks():
    """K18, K19, K20 and K15 on codes at a small width, n = 3, 8, 12:
    NaN rows (fp8 NaN codes, int8 0 codes of scale 1), inf rows (scale
    inf: K18 / K19 see NaN, K20 NaN columns where the row votes, K15 0
    votes on its 0 codes), zero rows (scale 1), live and absent: exact
    against the plain versions (trimmed within 3e-6)."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.masked import (scaled_coord_stat_plain,
                                            scaled_masked_coord_stat_plain,
                                            scaled_masked_sign_vote_plain,
                                            sign_vote_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(12)
    d = 4099
    for n in (3, 8, 12):
        for hazard in ("nan", "inf", "zero"):
            for qdt in QUANT:
                x = torch.randn((n, d), generator=gen, device=DEVICE)
                if hazard == "nan":
                    x[1, ::3] = math.nan
                elif hazard == "inf":
                    x[0, ::4], x[0, 1::4] = math.inf, -math.inf
                else:
                    x[n - 1] = 0.0
                codes, qs = quantize_rows(x, qdt)
                errs, close = {}, True
                for stat, b in (("median", 0), ("trimmed_mean", 1)):
                    out = kernels.scaled_coord_stat(codes, qs, stat, b)
                    ref = scaled_coord_stat_plain(codes, qs, stat, b)
                    errs["k18_" + stat] = max_abs_err(out, ref)
                    close &= bool(torch.allclose(out, ref, rtol=TOL,
                                                 atol=TOL, equal_nan=True))
                    for live in (n - 1, 1, 0):
                        # the hazard row live (first rows), then absent
                        for m in (arrival_mask(live, n),
                                  arrival_mask(live, n).flip(0)):
                            out = kernels.scaled_masked_coord_stat(
                                codes, qs, m, m, stat, b)
                            ref = scaled_masked_coord_stat_plain(
                                codes, qs, m, m, stat, b)
                            key = "k19_" + stat
                            errs[key] = max(errs.get(key, 0.0),
                                            max_abs_err(out, ref))
                            close &= bool(torch.allclose(
                                out, ref, rtol=TOL, atol=TOL,
                                equal_nan=True))
                errs["k20"] = 0.0
                for live in (n - 1, 1, 0):
                    for m in (arrival_mask(live, n),
                              arrival_mask(live, n).flip(0)):
                        out = kernels.scaled_masked_sign_vote(codes, qs, m, m)
                        errs["k20"] = max(errs["k20"], max_abs_err(
                            out, scaled_masked_sign_vote_plain(codes, qs, m,
                                                               m)))
                        if hazard == "inf" and m[0] > 0.5:
                            close &= bool(torch.isnan(out).all())
                k15 = kernels.sign_vote(codes)
                errs["k15"] = max_abs_err(k15, sign_vote_plain(codes))
                if hazard == "inf":
                    close &= not bool(torch.isnan(k15).all())
                torch.cuda.synchronize()
                ok = close and all(v == 0.0 for k, v in errs.items()
                                   if "trimmed" not in k)
                check("scaled_hazards", ok, hazard=hazard, n=n, dtype=qdt,
                      shape=[n, d], max_abs_diff=errs)


# ---------------------------------------------------------------------------
# phase 2f


def real_arena(cfg):
    """The (n, P) bf16 arena that one full-width synchronous sparse_mean
    step (seed 7) hands to its aggregation, after the attack: a real
    batch's gradients, so the embedding rows the batch does not touch are
    0 (not sent)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    gen = make_generator(7, DEVICE)
    params = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    store = {}
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=recorded(
        make_spec("sparse_mean", f=F, n=N), store), attack="sign_flip",
        remat=True)
    opt = adamw(constant(1e-4))
    step = make_train_step(cfg, bz, opt, device=DEVICE)
    step(params, opt.init(params), None, ds.batch(ds.draw_starts(gen)))
    arena = store["kernel"][0]
    del params, store, step
    torch.cuda.empty_cache()
    sent = arena != 0
    senders = sent.sum(0)
    emit("sparse_arena", shape=list(arena.shape),
         dtype=str(arena.dtype).replace("torch.", ""),
         nobody_sent_share=float((senders == 0).float().mean()),
         one_sender_share=float((senders == 1).float().mean()),
         sent_share_per_row=sent.float().mean(1).tolist())
    del sent, senders
    return arena


SPARSE_YARDSTICK = ("torch.sum(g, 0, dtype=float32) / "
                    "torch.count_nonzero(g, 0): a partial yardstick (two "
                    "calls, every row live with unit weight, no zero guard)")


def sparse_kernel_checks(x):
    """K17 and K21 on the real arena ``x`` (n = 8, bf16): K17 on it with
    mask and weights all ones (the synchronous step), on its fp32 copy
    with 6, 1 and 0 of 8 live and raw staleness weights (the async
    buffer); K21 on its int8 and fp8 codes, all live and 6, 1, 0 of 8.
    Exact against the plain versions.  The summary takes the bf16 sync
    case (K17) and the int8 sync case (K21)."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.wsum import (
        scaled_sparse_masked_weighted_mean_plain,
        sparse_masked_weighted_mean_plain)

    P = x.shape[1]
    summary = {K17: {"max_abs_err": 0.0}, K21: {"max_abs_err": 0.0}}
    ones = torch.ones(N, device=DEVICE)

    def case(name, fn, plain, g, m, w, bytes_per, main, label, **extra):
        live = int((m > 0.5).sum())
        out = fn()
        err = max_abs_err(out, plain())
        ok = err == 0.0 and (live > 0 or not bool(out.any()))
        del out
        kw = {}
        if live in (N, 6):
            kw = timing(fn, plain, 10, 2, live * P * bytes_per + 4 * P
                        + 8 * N, 5 * live * P,
                        library=((lambda: torch.sum(g, 0, dtype=torch.float32)
                                  / torch.count_nonzero(g, 0))
                                 if name == K17 else None),
                        label=SPARSE_YARDSTICK if name == K17 else None)
        check(name, ok, case=label, shape=[N, P], live=live,
              max_abs_diff=err, exact=err == 0.0, **extra, **kw)
        summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                           err)
        if main:
            summary[name].update(ms=kw["kernel_ms"], plain_ms=kw["plain_ms"],
                                 library_ms=None, bound_ms=kw["bound_ms"],
                                 bound_by=kw["bound_by"])

    # K17 on the synchronous step's bf16 arena
    case(K17, lambda: kernels.sparse_masked_weighted_mean(x, ones, ones),
         lambda: sparse_masked_weighted_mean_plain(x, ones, ones), x, ones,
         ones, 2, True, "sync bf16", dtype="bfloat16")
    xf = x.float()
    for live in (6, 1, 0):
        m = arrival_mask(live)
        w, _ = discount_weights(m)
        case(K17, lambda: kernels.sparse_masked_weighted_mean(xf, m, w),
             lambda: sparse_masked_weighted_mean_plain(xf, m, w), xf, m, w,
             4, False, "masked fp32, raw staleness weights",
             dtype="float32")
    for qdt in QUANT:
        codes, qs = quantize_rows(xf, qdt)
        for live in (N, 6, 1, 0):
            m = arrival_mask(live)
            w = ones if live == N else discount_weights(m)[0]
            case(K21, lambda: kernels.scaled_sparse_masked_weighted_mean(
                codes, qs, m, w),
                lambda: scaled_sparse_masked_weighted_mean_plain(
                    codes, qs, m, w), codes, m, w, 1,
                qdt == "int8" and live == N, "sync" if live == N else
                "masked, raw staleness weights", dtype=qdt,
                nobody_sent_share=float(
                    (~(codes.view(torch.uint8) & 0x7F).bool().any(0))
                    .float().mean()) if live == N else None)
        del codes, qs
        torch.cuda.empty_cache()
    del xf
    torch.cuda.empty_cache()
    sparse_hazard_checks()
    return summary


def sparse_hazard_checks():
    """K17 and K21 at a small width, n = 3, 8, 11, every live count: an inf
    or NaN in a live row of weight 0 (unsent), a live NaN (sent: its
    column NaN), -0.0 (not sent), a dead row of NaN, an all-zero column
    (an exact 0); on codes NaN rows, an inf row (scale inf: NaN columns
    wherever it is live) and a zero row.  Exact against the plain
    versions."""
    from repro_torch import kernels
    from repro_torch.core.flat import quantize_rows
    from repro_torch.kernels.wsum import (
        scaled_sparse_masked_weighted_mean_plain,
        sparse_masked_weighted_mean_plain)

    gen = torch.Generator(device=DEVICE).manual_seed(14)
    d = 4099
    for n in (3, 8, 11):
        base = torch.randn((n, d), generator=gen, device=DEVICE)
        base = torch.where(torch.rand((n, d), generator=gen, device=DEVICE)
                           < 0.5, torch.zeros((), device=DEVICE), base)
        base[:, :7] = 0.0
        masks = [arrival_mask(k, n) for k in (n, n - 1, 1, 0)]
        for hazard in ("unsent_nonfinite", "live_nan", "neg_zero",
                       "dead_nan"):
            for dtype in (torch.float32, torch.bfloat16):
                errs, props = [], True
                for m in masks:
                    w, _ = discount_weights(m)
                    g = base.clone()
                    live = int((m > 0.5).sum())
                    if hazard == "unsent_nonfinite" and live:
                        w[0] = 0.0
                        g[0, 8::3], g[0, 9::3] = math.inf, math.nan
                    elif hazard == "live_nan" and live:
                        g[live - 1, 8::5] = math.nan
                    elif hazard == "neg_zero":
                        g[:, 9::4] = -0.0
                    elif hazard == "dead_nan" and live < n:
                        g[n - 1] = math.nan
                    g = g.to(dtype)
                    out = kernels.sparse_masked_weighted_mean(g, m, w)
                    errs.append(max_abs_err(
                        out, sparse_masked_weighted_mean_plain(g, m, w)))
                    props &= not bool(out[:7].any())
                    if hazard == "live_nan" and live:
                        props &= bool(torch.isnan(out[8::5]).all())
                    elif hazard != "live_nan":
                        props &= bool(torch.isfinite(out).all())
                torch.cuda.synchronize()
                check("sparse_hazards", props and max(errs) == 0.0,
                      of=K17, hazard=hazard, n=n,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=max(errs))
        for hazard in ("nan", "inf", "zero_row"):
            g = base.clone()
            if hazard == "nan":
                g[min(1, n - 1), ::3] = math.nan
            elif hazard == "inf":
                g[0, 8::4], g[0, 9::4] = math.inf, -math.inf
            else:
                g[n - 1] = 0.0
            for qdt in QUANT:
                codes, qs = quantize_rows(g, qdt)
                errs, props = [], True
                for m in masks + [arrival_mask(n - 1, n).flip(0)]:
                    out = kernels.scaled_sparse_masked_weighted_mean(
                        codes, qs, m, m)
                    errs.append(max_abs_err(
                        out, scaled_sparse_masked_weighted_mean_plain(
                            codes, qs, m, m)))
                    if hazard == "inf" and float(m[0]) > 0.5:
                        props &= bool(torch.isnan(out).all())
                    elif hazard != "nan":
                        props &= bool(torch.isfinite(out).all())
                torch.cuda.synchronize()
                check("sparse_hazards", props and max(errs) == 0.0,
                      of=K21, hazard=hazard, n=n, dtype=qdt,
                      shape=[n, d], max_abs_diff=max(errs))


# ---------------------------------------------------------------------------
# phase 2g


def sort_checks(x):
    """K23 on the real arena ``x`` (bf16, and its fp32 copy) against its
    plain version, exact; the hazards at a small width; then the ``ops``
    legacy paths at full width, their launches counted from 0 (the drive
    of this entry point: K23 twice, K2 once), against the gather laws.
    Returns (summary, launch counts of the drive)."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import trim_count
    from repro_torch.core.filters import dense
    from repro_torch.kernels.coord_stats import coord_sort_plain

    P = x.shape[1]
    summary = {"coord_sort": {"max_abs_err": 0.0}}
    for g in (x, x.float()):
        dname = str(g.dtype).replace("torch.", "")
        out = kernels.coord_sort(g)
        err = max_abs_err(out, coord_sort_plain(g))
        del out
        torch.cuda.empty_cache()
        lib, label = ((lambda: torch.sort(g, dim=0), "torch.sort(g, dim=0)")
                      if g.dtype == torch.float32 else
                      (lambda: torch.sort(g.float(), dim=0),
                       "torch.sort(g.float(), dim=0)"))
        kw = timing(lambda: kernels.coord_sort(g),
                    lambda: coord_sort_plain(g), 5, 2,
                    N * P * g.element_size() + N * P * 4,
                    N * (N - 1) // 2 * 2 * P, library=lib, label=label)
        check("coord_sort", err == 0.0, dtype=dname, shape=[N, P],
              max_abs_diff=err, exact=err == 0.0, **kw)
        note(summary, "coord_sort", err, g is x and kw)
        torch.cuda.empty_cache()
    sort_hazard_checks()
    b = trim_count(N, F, None)
    kernels.reset_launch_counts()
    med = kernels.kernel_coordinate_median(x)
    tm = kernels.kernel_trimmed_mean(x, b)
    d2 = kernels.kernel_pairwise_sq_dists(x)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {k: {"coord_sort": 2, "gram": 1}.get(k, 0) for k in counts}
    xf = x.float()
    err_med = max_abs_err(med, dense.coordinate_median(xf))
    tm_ref = dense.trimmed_mean(xf, F)
    tm_ok = bool(torch.allclose(tm, tm_ref, rtol=TOL, atol=TOL))
    d2_ref = dense.pairwise_sq_dists(xf)
    sq = torch.sum(torch.square(xf), dim=1)
    scale = sq[:, None] + sq[None, :]
    d2_ok = bool(((d2 - d2_ref).abs() <= TOL * scale).all())
    ok = counts == want and err_med == 0.0 and tm_ok and d2_ok
    emit("ops_sort_paths", ok=ok, shape=[N, P], launches=counts,
         median_max_abs_diff=err_med,
         trimmed_max_abs_diff=max_abs_err(tm, tm_ref), trimmed_b=b,
         sq_dists_max_abs_diff=max_abs_err(d2, d2_ref),
         ms={"kernel_coordinate_median": time_ms(
             lambda: kernels.kernel_coordinate_median(x), 3),
             "kernel_trimmed_mean": time_ms(
                 lambda: kernels.kernel_trimmed_mean(x, b), 3),
             "kernel_pairwise_sq_dists": time_ms(
                 lambda: kernels.kernel_pairwise_sq_dists(x), 3)})
    if not ok:
        fail(f"ops sort paths: launches {counts} (expected {want}), median "
             f"{err_med}, trimmed {tm_ok}, distances {d2_ok}")
    del xf, med, tm, d2, tm_ref
    torch.cuda.empty_cache()
    return summary, counts


def sort_hazard_checks():
    """K23 at a small width, n = 3, 8, 11, fp32 and bf16: NaN rows and
    spots, +-inf rows, ties; exact against the plain version."""
    from repro_torch import kernels
    from repro_torch.kernels.coord_stats import coord_sort_plain

    gen = torch.Generator(device=DEVICE).manual_seed(15)
    d = 4099
    for n in (3, 8, 11):
        for hazard in ("nan_row", "spots", "inf_rows", "ties"):
            for dtype in (torch.float32, torch.bfloat16):
                g = torch.randn((n, d), generator=gen, device=DEVICE)
                if hazard == "nan_row":
                    g[n // 2] = math.nan
                elif hazard == "spots":
                    g[1, ::7], g[0, 3::11] = math.nan, math.inf
                    g[n - 1, 5::13] = -math.inf
                elif hazard == "inf_rows":
                    g[0], g[n - 1] = math.inf, -math.inf
                else:
                    g[1] = g[0]
                    g[:, ::4] = torch.round(g[:, ::4])
                g = g.to(dtype)
                err = max_abs_err(kernels.coord_sort(g), coord_sort_plain(g))
                torch.cuda.synchronize()
                check("sort_hazards", err == 0.0, hazard=hazard, n=n,
                      dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                      max_abs_diff=err)


# ---------------------------------------------------------------------------
# phase 2h

K22 = "clipped_weighted_sum"
K22_LIBRARY = "torch.addmv(v, g.t(), lam, beta=1 - sum lam)"


def cclip_kernel_checks(num_params):
    """K22 clipped_weighted_sum against its plain version at n = 8, P =
    124,668,672: fp32 rows with 8 and 6 of 8 lam > 0 (the async buffer;
    the 2 dead rows never read) and bf16 rows with 8; exact.  Times of
    the kernel, the plain version and ``torch.addmv`` (fp32: the same
    function in one call; bf16: a partial yardstick, addmv taking one
    dtype), and the bound.  The summary takes fp32 with 8 live rows."""
    from repro_torch import kernels
    from repro_torch.kernels.wsum import clipped_weighted_sum_plain

    P = num_params
    gen = torch.Generator(device=DEVICE).manual_seed(17)
    summary = {K22: {"max_abs_err": 0.0}}
    v = torch.randn(P, generator=gen, device=DEVICE) * 1e-3
    for dtype, live in ((torch.float32, N), (torch.float32, 6),
                        (torch.bfloat16, N)):
        x = (torch.randn((N, P), generator=gen, device=DEVICE)
             * 1e-3).to(dtype)
        lam = torch.rand(N, generator=gen, device=DEVICE) / N
        lam[live:] = 0.0
        err = max_abs_err(kernels.clipped_weighted_sum(lam, x, v),
                          clipped_weighted_sum_plain(lam, x, v))
        keep = float(1.0 - lam.sum())
        if dtype == torch.float32:
            label = K22_LIBRARY
            library = (lambda: torch.addmv(v, x.t(), lam, beta=keep))
        else:
            vb, lb = v.to(dtype), lam.to(dtype)
            label = (K22_LIBRARY + " in bf16: a partial yardstick (addmv "
                     "takes one dtype, so v, lam and the sum are bf16)")
            library = (lambda: torch.addmv(vb, x.t(), lb, beta=keep))
        kw = timing(lambda: kernels.clipped_weighted_sum(lam, x, v),
                    lambda: clipped_weighted_sum_plain(lam, x, v), 10, 2,
                    live * P * x.element_size() + 8 * P + 4 * N,
                    2 * live * P + 2 * P, library=library, label=label)
        check(K22, err == 0.0, dtype=str(dtype).replace("torch.", ""),
              shape=[N, P], live=live, max_abs_diff=err, exact=err == 0.0,
              **kw)
        note(summary, K22, err,
             kw if dtype == torch.float32 and live == N else None)
        del x
        torch.cuda.empty_cache()
    cclip_hazard_checks()
    return summary


def cclip_hazard_checks():
    """K22 at small widths (P = 1, 37, 4099 and the prime 65537) and n = 1,
    3, 8, 64, fp32 and bf16: inf / NaN in the rows with lam = 0 (never
    read: the output stays finite), every lam = 0 (the output is v
    exactly), sum lam = 1 and plain weights; exact against the plain
    version."""
    from repro_torch import kernels
    from repro_torch.kernels.wsum import clipped_weighted_sum_plain

    gen = torch.Generator(device=DEVICE).manual_seed(18)
    for n, d in ((1, 1), (3, 4099), (8, 65537), (64, 37), (8, 1)):
        for dtype in (torch.float32, torch.bfloat16):
            errs, props = [], True
            for case in ("live", "dead_nonfinite", "all_zero", "sum_one"):
                g = torch.randn((n, d), generator=gen, device=DEVICE) * 2.0
                lam = torch.rand(n, generator=gen, device=DEVICE) / n
                v = torch.randn(d, generator=gen, device=DEVICE)
                if case == "dead_nonfinite":
                    lam[::2] = 0.0
                    g[::2, ::3] = math.inf
                    g[::2, 1::3] = math.nan
                elif case == "all_zero":
                    lam.zero_()
                elif case == "sum_one":
                    lam.fill_(1.0 / n)
                g = g.to(dtype)
                out = kernels.clipped_weighted_sum(lam, g, v)
                errs.append(max_abs_err(
                    out, clipped_weighted_sum_plain(lam, g, v)))
                props &= bool(torch.isfinite(out).all())
                if case == "all_zero":
                    props &= torch.equal(out, v)
            torch.cuda.synchronize()
            check("clipped_weighted_sum_hazards",
                  props and max(errs) == 0.0, of=K22, n=n,
                  dtype=str(dtype).replace("torch.", ""), shape=[n, d],
                  cases=["live", "dead_nonfinite", "all_zero", "sum_one"],
                  max_abs_diff=max(errs))


# ---------------------------------------------------------------------------
# phases 3 and 4


class DequantCount:
    """Counts the engine-level dequantizations of a quantized arena
    (``aggregators._flat_dequant``) while entered."""

    def __enter__(self):
        from repro_torch.core import aggregators
        self.mod, self.real, self.n = aggregators, aggregators._flat_dequant, 0

        def counted(*a):
            self.n += 1
            return self.real(*a)

        aggregators._flat_dequant = counted
        return self

    def __exit__(self, *exc):
        self.mod._flat_dequant = self.real


def want_dequant(rule, agg_dtype, steps):
    return steps if agg_dtype in QUANT and rule in DEQUANT_RULES else 0


def phase_train(cfg, table, steps, agg_dtype=""):
    """Per rule of ``table`` (rule -> (n, hyper, kernels of one step)):
    one untimed warm-up step, then ``steps`` timed steps through
    ``train_loop`` (with exchange dtype ``agg_dtype``); the launch counts,
    reset just before the timed run and read just after, must show each
    of the rule's kernels once per step and no other, and a quantized
    exchange one engine-level dequantization per step for krum and none
    for the rules with a scaled kernel."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop

    totals = {k: 0 for k in SOURCES}
    for rule, (n, hyper, names) in table.items():
        ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        # one untimed warm-up step, so that every timed step is warm
        train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=1, seed=0,
                   device=DEVICE, log_fn=lambda s: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with DequantCount() as dq:
            _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                                 steps=steps, seed=0, device=DEVICE,
                                 log_every=1, log_fn=lambda s: None)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        wall = [h["wall_s"] for h in hist]
        step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
        losses = [h["loss"] for h in hist]
        want = {k: (steps if k in names else 0) for k in SOURCES}
        emit("train", rule=rule, n=n, hyper=hyper, impl=bz.aggregator.impl,
             agg_dtype=agg_dtype or None, steps=steps, losses=losses,
             step_ms=step_ms, median_step_ms=statistics.median(step_ms),
             peak_mem_gb=peak / 1e9, launches=counts,
             engine_dequant=dq.n)
        if not all(math.isfinite(v) for v in losses):
            fail(f"{rule}: non-finite loss {losses}")
        if counts != want:
            fail(f"{rule}: kernel launches {counts}, expected {want}")
        if dq.n != want_dequant(rule, agg_dtype, steps):
            fail(f"{rule} {agg_dtype}: {dq.n} engine dequantizations")
        for k, v in counts.items():
            totals[k] += v
    return totals


def kernel_selection(rule, gr, n, f, hyper):
    """The kernel path's selection on the (n, n) Gram ``gr``: CGE's
    keep-mask, else the (n,) pick order (sentinel n)."""
    from repro_torch import kernels
    from repro_torch.kernels.ops import mda_order
    from repro_torch.kernels.select import gram_d2
    if rule == "cge":
        return kernels.cge_select(gr, n - f)
    if rule == "multi_krum":
        return kernels.multi_krum_order(gr, f, hyper["m"]).long()
    if rule == "mda":
        return mda_order(gram_d2(gr), n, f).long()
    k = hyper["m"] if rule == "m_krum" else n - 2 * f
    return kernels.iterative_order(gr, f, k).long()


def gather_selection(rule, g, n, f, hyper):
    """The gather law's selection on the fp32 arena, in the form of
    :func:`kernel_selection`, recomputed with the dense laws' own helpers
    (``repro_torch.core.filters.dense``)."""
    from repro_torch.core.aggregators import mda_combos
    from repro_torch.core.filters import dense as D
    order = torch.full((n,), n, dtype=torch.int64, device=g.device)
    if rule == "cge":
        keep = torch.zeros((n,), device=g.device)
        keep[D._ascending(torch.linalg.vector_norm(g, dim=-1), n - f)] = 1.0
        return keep
    d2 = D.pairwise_sq_dists(g)
    if rule == "multi_krum":
        m = hyper["m"]
        order[D._ascending(D.krum_scores(d2, f), m)] = torch.arange(
            m, device=g.device)
        return order
    if rule == "mda":
        combos = torch.as_tensor(mda_combos(n, f), device=g.device)
        sub = d2[combos[:, :, None], combos[:, None, :]]
        best = combos[D.argmin_tiebreak(torch.amax(sub, dim=(1, 2)),
                                        torch.sum(sub, dim=(1, 2)))]
        order[best] = torch.arange(n - f, device=g.device)
        return order
    k = hyper["m"] if rule == "m_krum" else n - 2 * f
    mask = torch.ones((n,), dtype=torch.bool, device=g.device)
    for it in range(k):
        sc = D.krum_scores(d2, f, mask=mask, k=max(n - it - f - 2, 1))
        i = D.argmin_tiebreak(sc, D.masked_row_sums(d2, mask))
        order[i] = it
        mask[i] = False
    return order


def straggler_sim(quorum=6):
    from repro_torch.simulator import SimConfig, Straggler
    return SimConfig(faults=(Straggler("lognormal", 0.8),), quorum=quorum,
                     max_staleness=3, seed=0)


# (n, quorum) -> (arrived, max staleness) of the straggler trace's rows
STRAGGLER_TRACES = {(N, 6): ([6] * 6, [0, 1, 2, 1, 2, 1]),
                    (11, 9): ([9] * 4, [0, 1, 1, 2])}


def check_straggler_traces():
    """The straggler profile's rows at n = 8 (quorum 6) and n = 11 (quorum
    9): a fixed number of deliveries, so no row is pure."""
    from repro_torch.simulator import plan_arrivals
    for (n, quorum), (arrived, stale) in STRAGGLER_TRACES.items():
        tr = plan_arrivals(straggler_sim(quorum), n, len(arrived))
        if (tr.contrib.sum(1).tolist() != arrived
                or tr.staleness.max(1).tolist() != stale):
            fail(f"straggler trace (n={n}, quorum={quorum}) changed: "
                 f"arrived {tr.contrib.sum(1)}, max staleness "
                 f"{tr.staleness.max(1)}")


def phase_async(cfg, table, steps, agg_dtype=""):
    """Per rule of ``table`` (rule -> (n, quorum, hyper, the kernels of
    one step)): the straggler profile through ``train_loop(sim=...)``
    (with exchange dtype ``agg_dtype``), 1 warm-up step, then ``steps``
    timed steps.  The launch counts, reset just before the timed run and
    read just after, must show each of the rule's kernels once a step and
    no other, one async step built, and the engine-level dequantizations
    as in :func:`phase_train`."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop

    totals = {k: 0 for k in SOURCES}
    step_ms_by_rule = {}
    for rule, (n, quorum, hyper, names) in table.items():
        sim = straggler_sim(quorum)
        ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=1, seed=0,
                   device=DEVICE, sim=sim, log_fn=lambda s: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = snapshot()
        kernels.reset_launch_counts()
        with DequantCount() as dq:
            _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                                 steps=steps, seed=0, device=DEVICE, sim=sim,
                                 log_every=1, log_fn=lambda s: None)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        built = counter_delta(before)
        peak = torch.cuda.max_memory_allocated()
        wall = [h["wall_s"] for h in hist]
        step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
        losses = [h["loss"] for h in hist]
        want = {k: (steps if k in names else 0) for k in SOURCES}
        step_ms_by_rule[rule] = statistics.median(step_ms)
        emit("async", rule=rule, n=n, quorum=quorum, hyper=hyper,
             impl=bz.aggregator.impl, agg_dtype=agg_dtype or None,
             steps=steps, engine_dequant=dq.n,
             arrived=[h["arrived"] for h in hist],
             staleness_mean=[h["staleness_mean"] for h in hist],
             losses=losses, step_ms=step_ms,
             median_step_ms=step_ms_by_rule[rule], peak_mem_gb=peak / 1e9,
             launches=counts, steps_built=built)
        if not all(math.isfinite(v) for v in losses):
            fail(f"async {rule}: non-finite loss {losses}")
        if counts != want:
            fail(f"async {rule}: kernel launches {counts}, expected {want}")
        if built != {"async_step": 1}:
            fail(f"async {rule}: built {built}, expected one async step")
        if dq.n != want_dequant(rule, agg_dtype, steps):
            fail(f"async {rule} {agg_dtype}: {dq.n} engine "
                 "dequantizations")
        for k, v in counts.items():
            totals[k] += v
    return totals, step_ms_by_rule


def phase_async_elastic(cfg):
    """The elastic trimmed_mean under churn: one step build per bucket,
    K1 on the pure step and K5 on the others."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import elastic, frac, make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import Churn, SimConfig
    from repro_torch.training import ByzantineConfig, train_loop

    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    spec = make_spec("trimmed_mean", f=frac(0.25), n=elastic(N, (4, 6, 8)))
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                         attack="sign_flip", remat=True)
    sim = SimConfig(faults=(Churn(rate=0.25, mean_out=2.0),), seed=0)
    before = snapshot()
    kernels.reset_launch_counts()
    _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                         steps=len(CHURN_LIVE), seed=0, device=DEVICE,
                         sim=sim, log_every=1, log_fn=lambda s: None)
    counts = kernels.launch_counts()
    torch.cuda.synchronize()
    built = counter_delta(before)
    live = [h["n_live"] for h in hist]
    losses = [h["loss"] for h in hist]
    wall = [h["wall_s"] for h in hist]
    step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
    want = {k: 0 for k in SOURCES}
    want.update(coord_stat=1, masked_coord_stat=len(CHURN_LIVE) - 1)
    emit("async_elastic", rule="trimmed_mean", spec=spec.describe(),
         n_live=live, losses=losses, step_ms=step_ms, launches=counts,
         steps_built=built)
    if live != CHURN_LIVE:
        fail(f"churn trace changed: live {live}, expected {CHURN_LIVE}")
    if built != {"async_step": 3, "train_step": 1}:
        fail(f"elastic run built {built}, expected 3 bucket async steps "
             "and 1 synchronous step")
    if counts != want:
        fail(f"elastic run launches {counts}, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"elastic run: non-finite loss {losses}")
    return counts


def async_setup(cfg, seed, n=N, quorum=6):
    """Full-width parameters, a nonzero fp32 in-flight buffer, a batch and
    row 2 of the straggler trace (at n = 8, quorum 6: max staleness 2),
    all from ``seed``, for ``n`` agents."""
    from repro_torch.core.flat import FlatPlan
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.simulator import plan_arrivals, staleness_weights

    gen = make_generator(seed, DEVICE)
    params = init_params(cfg, gen)
    total = FlatPlan.for_proto(params).total
    buffer = torch.randn((n, total), generator=gen, device=DEVICE) * 1e-3
    ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    sim = straggler_sim(quorum)
    tr = plan_arrivals(sim, n, 3)
    cw = torch.from_numpy(staleness_weights(sim, tr)[2]).to(DEVICE)
    return params, buffer, batch, tr.refresh[2], cw


def phase_profile_async(cfg, table):
    """Per rule of ``table`` (rule -> (n, quorum, hyper)), one async step
    (row 2 of the straggler trace) after a warm-up step: untraced on the
    host clock, then traced; device busy time, idle share and the top
    device events, as phase_profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    setups = {}
    for rule, (n, quorum, hyper) in table.items():
        if (n, quorum) not in setups:
            setups.clear()
            torch.cuda.empty_cache()
            setups[n, quorum] = async_setup(cfg, 5, n, quorum)
        params, buffer, batch, refresh, cw = setups[n, quorum]
        opt = adamw(constant(1e-4))
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True)
        step = make_async_step(cfg, bz, opt, device=DEVICE)
        state = opt.init(params)
        args = (batch, None, refresh, cw)
        step(params, state, None, buffer, {}, *args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, None, buffer, {}, *args)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, None, buffer, {}, *args)
            torch.cuda.synchronize()
            traced_ms = 1e3 * (time.perf_counter() - t0)
        busy, span, by_name = device_busy(prof)
        seen = busy > 0
        ours = sum(t for k, t in by_name.items()
                   if any(name in k for name in OUR_KERNELS))
        top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
        emit("profile_async", rule=rule, n=n, step_ms=wall_ms,
             traced_step_ms=traced_ms,
             device_busy_ms=busy if seen else "not measured",
             device_span_ms=span if seen else "not measured",
             device_idle_share=(1 - busy / wall_ms) if seen else
             "not measured",
             aggregation_kernels_ms=ours if seen else "not measured",
             top_device_events_ms=[[k[:60], t] for k, t in top])
        del state
    setups.clear()
    torch.cuda.empty_cache()


def masked_selections(rule, stack, mask, weights, n, f, hyper):
    """(kernel selection, gather selection, whether a ghost row is
    selected) of one masked step: the kernel path's on the card's imputed
    Gram (K4 mean -> K6), the gather law's on the imputed fp32 stack
    (:func:`gather_selection`), each in :func:`kernel_selection`'s form."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import _masked_prelude
    from repro_torch.kernels.ref import masked_impute_ref
    mask, w, _, tot = _masked_prelude(mask, weights)
    wn = w / tot
    mean = kernels.imputed_mean(stack, wn)
    sel_k = kernel_selection(rule, kernels.masked_gram(stack, mask.float(),
                                                       wn, mean), n, f, hyper)
    imputed = masked_impute_ref(stack, mask.float(), wn).float()
    sel_g = gather_selection(rule, imputed, n, f, hyper)
    picked = sel_k > 0.5 if rule == "cge" else sel_k < n
    return sel_k, sel_g, bool((picked & ~mask).any())


EXACT_RULES = ("coordinate_median", "krum", "sign_sgd")


def recorded(spec, store):
    """A copy of ``spec`` whose ``aggregate_flat`` keeps, in
    ``store[impl]``, the arena, mask and weights it gets, the fp32
    aggregate it returns and the row scales of a quantized arena."""
    from repro_torch.core.aggregators import AggregatorSpec

    class Recorded(AggregatorSpec):
        def aggregate_flat(self, stack, mask=None, weights=None, state=None,
                           scale=None):
            out = super().aggregate_flat(stack, mask, weights, state, scale)
            store[self.impl] = (stack, mask, weights, out, scale)
            return out

    return Recorded(**{f.name: getattr(spec, f.name)
                       for f in dataclasses.fields(spec)})


def same(a, b):
    """Bitwise equality (int8 / fp8 codes compared as bytes)."""
    if a is None or b is None:
        return a is b
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.element_size() == 1:
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def compare_impls(phase, rule, n, hyper, store, losses, **kw):
    """The kernel and gather runs of one step from the same state: the
    arenas (and mask and weights) equal, the losses equal, for the
    selection family the selection and pick order equal (on the imputed
    stack for a masked step, with whether a ghost row is selected), the
    aggregates exact for EXACT_RULES and within 3e-6 otherwise."""
    from repro_torch import kernels
    (xk, mk, wk, ak, sk), (xg, mg, wg, ag, sg) = (store["kernel"],
                                                  store["gather"])
    same_arena = (same(xk, xg) and same(mk, mg) and same(wk, wg)
                  and same(sk, sg))
    if rule in SEL_RULES:
        if mk is None:
            sel_k = kernel_selection(rule, kernels.gram(xk), n, F, hyper)
            sel_g = gather_selection(rule, xg.float(), n, F, hyper)
        else:
            sel_k, sel_g, kw["ghost_selected"] = masked_selections(
                rule, xk, mk, wk, n, F, hyper)
        kw.update(same_selection=torch.equal(sel_k, sel_g),
                  selection_kernel=sel_k.tolist(),
                  selection_gather=sel_g.tolist())
    err = max_abs_err(ak, ag)
    close = err == 0.0 if rule in EXACT_RULES else bool(torch.allclose(
        ak, ag, rtol=TOL, atol=TOL))
    ok = (same_arena and close and kw.get("same_selection", True)
          and losses["kernel"] == losses["gather"])
    emit(phase, rule=rule, n=n, hyper=hyper, ok=ok, same_arena=same_arena,
         max_abs_diff=err, loss_kernel=losses["kernel"],
         loss_gather=losses["gather"], **kw)
    store.clear()
    torch.cuda.empty_cache()
    if not ok:
        fail(f"{phase} {rule} {kw}: kernel path differs from gather (arena "
             f"equal {same_arena}, aggregate {err}, losses {losses})")


def sync_pair(cfg, rule, n, hyper, base, batch, store, agg_dtype=""):
    """One full-width synchronous step of ``rule`` with impl="kernel" and
    with impl="gather" from the same parameters and batch (exchange dtype
    ``agg_dtype``); returns the losses (the specs' arguments and
    aggregates land in ``store``)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    losses = {}
    for impl in ("kernel", "gather"):
        spec = recorded(make_spec(rule, f=F, impl=impl, n=n, **hyper), store)
        bz = ByzantineConfig(n_agents=n, f=F, aggregator=spec,
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        opt = adamw(constant(1e-4))
        step = make_train_step(cfg, bz, opt, device=DEVICE)
        params = _clone(base)
        _, _, _, met = step(params, opt.init(params), None, batch)
        losses[impl] = float(met["loss"])
        del params
    return losses


def phase_kernel_vs_gather(cfg, rules):
    """Phase 4: one full-width synchronous step per rule of ``rules`` (n =
    8), all from one parameter set and batch (seed 1)
    (:func:`compare_impls`)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(1, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    for rule in rules:
        losses = sync_pair(cfg, rule, N, {}, base, batch, store)
        compare_impls("kernel_vs_gather", rule, N, {}, store, losses)
    torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()


def phase_selection_vs_gather(cfg):
    """Phase 4c: one full-width synchronous step per selection rule (seed
    3, a batch per rule) (:func:`compare_impls`)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(3, DEVICE)
    base = init_params(cfg, gen)
    store = {}
    for rule, (n, hyper, _) in SEL_RULES.items():
        ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
        batch = ds.batch(ds.draw_starts(gen))
        losses = sync_pair(cfg, rule, n, hyper, base, batch, store)
        compare_impls("selection_vs_gather", rule, n, hyper, store, losses)
    torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()


def async_pair(cfg, spec_of, n, base, buffer, batch, refresh, cw,
               *bucket_args, bucket=None, agg_dtype=""):
    """One full-width async step with ``spec_of("kernel")`` and with
    ``spec_of("gather")`` from the same parameters, buffer, batch and
    trace row (exchange dtype ``agg_dtype``); returns (store, losses) as
    :func:`sync_pair`."""
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    store, losses = {}, {}
    for impl in ("kernel", "gather"):
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=recorded(spec_of(impl), store),
                             attack="sign_flip", remat=True,
                             agg_dtype=agg_dtype)
        opt = adamw(constant(1e-4))
        step = make_async_step(cfg, bz, opt, device=DEVICE, bucket=bucket)
        params = _clone(base)
        _, _, _, _, _, met = step(params, opt.init(params), None,
                                  buffer.clone(), {}, batch, None, refresh,
                                  cw, *bucket_args)
        losses[impl] = float(met["loss"])
        del params
    return store, losses


def phase_tie_check(cfg):
    """Phase 4c, ROADMAP.md P12: the synchronous bulyan step at n = 11 on
    the seed-1 parameters and batch, where the gather law once broke the
    exact Krum tie of the two equal sign_flip rows the other way.  The
    gather law's distances must be bitwise equal for the equal rows, and
    the kernel and gather paths must pick in the same order
    (:func:`compare_impls`)."""
    from repro_torch.core.filters.dense import pairwise_sq_dists
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    n = SEL_RULES["bulyan"][0]
    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(1, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    losses = sync_pair(cfg, "bulyan", n, {}, base, batch, store)
    x = store["gather"][0].float()
    d2 = pairwise_sq_dists(x)
    equal_rows = same(x[0], x[1])
    tie = equal_rows and same(d2[0, F:], d2[1, F:]) and float(d2[0, 1]) == 0
    emit("tie_check", rule="bulyan", n=n, seed=1, equal_rows=equal_rows,
         equal_distances=tie)
    del d2
    if not tie:
        fail("P12: the equal sign_flip rows' gather distances differ")
    gram_cost(x)
    del x
    compare_impls("selection_vs_gather", "bulyan", n, {}, store, losses,
                  seed=1, tie_check=True)
    torch.use_deterministic_algorithms(False)
    del base
    torch.cuda.empty_cache()


def matmul_sq_dists(g):
    """The gather law's distances before P12's repair: the Gram as one
    library product ``g @ g.T``, which breaks an exact tie by rounding."""
    sq = torch.sum(torch.square(g), dim=-1)
    gram = g @ g.T
    d2 = torch.triu(torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram,
                                    0.0), 1)
    return d2 + d2.T


def gram_cost(x):
    """What P12's repair costs the gather law at full width: the distances
    of one fixed-order dot per pair against the library product, alone
    and inside the gather aggregation of krum (n = 8) and bulyan (n = 11),
    on the rows ``x`` of the tie check's step."""
    from unittest import mock

    from repro_torch.core.aggregators import make_spec
    from repro_torch.core.filters import dense

    for rule, n in (("krum", N), ("bulyan", x.shape[0])):
        g = x[:n]
        spec = make_spec(rule, f=F, impl="gather", n=n)
        row = {"pair_dists_ms": time_ms(lambda: dense.pairwise_sq_dists(g),
                                        2),
               "matmul_dists_ms": time_ms(lambda: matmul_sq_dists(g), 2),
               "gather_ms": time_ms(lambda: spec.aggregate_flat(g), 2)}
        with mock.patch.object(dense, "pairwise_sq_dists", matmul_sq_dists):
            row["gather_matmul_ms"] = time_ms(lambda: spec.aggregate_flat(g),
                                              2)
        emit("gather_gram", rule=rule, n=n, shape=list(g.shape), **row)


def phase_quant_vs_gather(cfg):
    """Phase 4x: the compressed exchange, impl="kernel" against
    impl="gather" from the same state: one full-width synchronous step per
    rule of QUANT_RULES in int8 and fp8 (seed 4), one async step per rule
    of ASYNC_QUANT_RULES in int8 (seed 6, row 2 of the straggler trace).
    The codes and scales (and mask and weights) bitwise equal, equal
    losses, median, sign and krum exact, trimmed mean within 3e-6
    (:func:`compare_impls`; krum's exact aggregate is its selected row)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(4, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    for qdt in QUANT:
        for rule in QUANT_RULES:
            losses = sync_pair(cfg, rule, N, {}, base, batch, store,
                               agg_dtype=qdt)
            compare_impls("quant_vs_gather", rule, N, {}, store, losses,
                          agg_dtype=qdt, loop="sync")
    del base, batch
    torch.cuda.empty_cache()
    setup = async_setup(cfg, 6)
    for rule, (n, quorum, hyper, _) in ASYNC_QUANT_RULES.items():
        store, losses = async_pair(
            cfg, lambda impl: make_spec(rule, f=F, impl=impl, n=n, **hyper),
            n, *setup, agg_dtype="int8")
        compare_impls("quant_vs_gather", rule, n, hyper, store, losses,
                      agg_dtype="int8", loop="async", quorum=quorum,
                      arrived=int((setup[-1] > 0).sum()))
    torch.use_deterministic_algorithms(False)
    del setup
    torch.cuda.empty_cache()


def phase_masked_vs_gather(cfg, table):
    """One full-width async step per rule of ``table`` (rule -> (n, quorum,
    hyper, ...)) with impl="kernel" and with impl="gather", from the same
    parameters, buffer, batch and row 2 of the straggler trace; then the
    elastic trimmed_mean's bucket steps with ghost rows (3 live in bucket
    4, 7 live in bucket 8), as the churn run packs them
    (:func:`compare_impls`)."""
    from repro_torch.core.aggregators import elastic, frac, make_spec

    def run(*a, **kw):
        return async_pair(cfg, *a, **kw)

    torch.use_deterministic_algorithms(True, warn_only=True)
    setups = {}
    for rule, (n, quorum, hyper, _) in table.items():
        if (n, quorum) not in setups:
            setups.clear()
            torch.cuda.empty_cache()
            setups[n, quorum] = async_setup(cfg, 6, n, quorum)
        setup = setups[n, quorum]
        store, losses = run(lambda impl: make_spec(rule, f=F, impl=impl, n=n,
                                                   **hyper), n, *setup)
        compare_impls("masked_vs_gather", rule, n, hyper, store, losses,
                      quorum=quorum, arrived=int((setup[-1] > 0).sum()))

    setups.clear()
    torch.cuda.empty_cache()
    base, buffer, batch, _, _ = async_setup(cfg, 6)
    for live in ((1, 3, 6), (0, 1, 2, 3, 4, 5, 7)):
        spec_e = make_spec("trimmed_mean", f=frac(0.25),
                           n=elastic(N, (4, 6, 8)))
        b, idx, valid = spec_e.elastic.pack(np.asarray(live))
        cw_b = torch.zeros(N, device=DEVICE)
        cw_b[list(live)] = 1.0
        refresh_b = np.zeros(N, bool)
        refresh_b[list(live)] = True
        store, losses = run(
            lambda impl: make_spec("trimmed_mean", f=frac(0.25), impl=impl,
                                   n=elastic(N, (4, 6, 8))),
            N, base, buffer, batch, refresh_b, cw_b, False,
            torch.as_tensor(idx, dtype=torch.int64, device=DEVICE),
            torch.as_tensor(valid, device=DEVICE), bucket=int(b))
        compare_impls("masked_vs_gather", "trimmed_mean", int(b), {}, store,
                      losses, arrived=len(live), bucket=int(b))
    torch.use_deterministic_algorithms(False)
    del buffer
    torch.cuda.empty_cache()


def phase_sparse_vs_gather(cfg):
    """Phase 4s: sparse_mean with impl="kernel" against impl="gather" from
    the same state: one full-width synchronous step (seed 8), one int8
    synchronous step, one async step (seed 9, row 2 of the straggler
    trace) (:func:`compare_impls`); then the mixed-dtype masked tree."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params

    torch.use_deterministic_algorithms(True, warn_only=True)
    gen = make_generator(8, DEVICE)
    base = init_params(cfg, gen)
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    batch = ds.batch(ds.draw_starts(gen))
    store = {}
    for qdt in ("", "int8"):
        losses = sync_pair(cfg, "sparse_mean", N, {}, base, batch, store,
                           agg_dtype=qdt)
        compare_impls("sparse_vs_gather", "sparse_mean", N, {}, store,
                      losses, agg_dtype=qdt or None, loop="sync")
    del base, batch
    torch.cuda.empty_cache()
    setup = async_setup(cfg, 9)
    store, losses = async_pair(
        cfg, lambda impl: make_spec("sparse_mean", f=F, impl=impl, n=N), N,
        *setup)
    compare_impls("sparse_vs_gather", "sparse_mean", N, {}, store, losses,
                  loop="async", arrived=int((setup[-1] > 0).sum()))
    torch.use_deterministic_algorithms(False)
    del setup
    torch.cuda.empty_cache()
    mixed_tree_checks()


# ---------------------------------------------------------------------------
# phases 3m and 4m: the defenses with memory and the defense-aware attacks

CCLIP_ITERS = 5             # centered_clip's default iters: K22 a step


def memory_cases():
    """(label, spec, attack, trace, agg_dtype, timed steps, the kernels of
    one step) of phase 3m: the phase-3b configuration through
    ``train_loop`` with a stateful spec or a defense-aware attack."""
    from repro_torch.core.aggregators import make_spec, server_momentum
    cck = make_spec("centered_clip", f=F, n=N, impl="kernel")
    smt = server_momentum(make_spec("trimmed_mean", f=F, n=N))
    k22 = {K22: CCLIP_ITERS}
    k5 = {"masked_coord_stat": 1}
    return [
        ("centered_clip kernel", cck, "sign_flip", "sync", "", 2, k22),
        ("centered_clip kernel", cck, "sign_flip", "stragglers", "", 2, k22),
        ("centered_clip auto", make_spec("centered_clip", f=F, n=N),
         "sign_flip", "stragglers", "", 2, {}),
        ("zeno_pp", make_spec("zeno_pp", f=F, n=N), "sign_flip",
         "stragglers", "", 2, {}),
        ("server_momentum(trimmed_mean)", smt, "sign_flip", "stragglers",
         "", 2, k5),
        ("spec_alie vs centered_clip kernel", cck, "spec_alie",
         "stragglers", "", 2, k22),
        ("min_max vs centered_clip kernel", cck, "min_max", "stragglers",
         "", 2, k22),
        ("slow_drift vs server_momentum(trimmed_mean)", smt, "slow_drift",
         "stragglers", "", 2, k5),
        ("centered_clip kernel int8", cck, "sign_flip", "stragglers",
         "int8", 1, k22),
    ]


def phase_memory(cfg):
    """Phase 3m: per case of :func:`memory_cases`, 1 untimed warm-up step
    and the timed steps through ``train_loop`` (on the synchronous trace
    too, every row runs the general async step: the state must see each
    step).  The launch counts, reset just before the timed run and read
    just after, must show the case's kernels per step and no other (the
    attack probes run the gather impl: no launch), one async step built
    and no synchronous one, and no engine-level dequantization."""
    from repro_torch import kernels
    from repro_torch.data import SyntheticLM
    from repro_torch.obs.counters import counter_delta, snapshot
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, train_loop

    totals = {k: 0 for k in SOURCES}
    step_ms_by_case = {}
    ds = SyntheticLM(cfg.vocab_size, SEQ, N, PER_AGENT)
    for label, spec, attack, trace, qdt, steps, per_step in memory_cases():
        sim = straggler_sim() if trace == "stragglers" else None
        bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec, attack=attack,
                             remat=True, agg_dtype=qdt)
        train_loop(cfg, bz, adamw(constant(1e-4)), ds, steps=1, seed=0,
                   device=DEVICE, sim=sim, log_fn=lambda s: None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = snapshot()
        kernels.reset_launch_counts()
        with DequantCount() as dq:
            _, hist = train_loop(cfg, bz, adamw(constant(1e-4)), ds,
                                 steps=steps, seed=0, device=DEVICE, sim=sim,
                                 log_every=1, log_fn=lambda s: None)
        counts = kernels.launch_counts()
        torch.cuda.synchronize()
        built = counter_delta(before)
        peak = torch.cuda.max_memory_allocated()
        wall = [h["wall_s"] for h in hist]
        step_ms = [1e3 * (b - a) for a, b in zip([0.0] + wall[:-1], wall)]
        losses = [h["loss"] for h in hist]
        want = {k: steps * per_step.get(k, 0) for k in SOURCES}
        key = f"{label}, {trace}" + (f", {qdt}" if qdt else "")
        step_ms_by_case[key] = statistics.median(step_ms)
        emit("memory", case=label, spec=spec.describe(), impl=spec.impl,
             attack=attack, trace=trace, agg_dtype=qdt or None, steps=steps,
             arrived=[h["arrived"] for h in hist], losses=losses,
             step_ms=step_ms, median_step_ms=step_ms_by_case[key],
             peak_mem_gb=peak / 1e9, launches=counts, steps_built=built,
             engine_dequant=dq.n)
        if not all(math.isfinite(v) for v in losses):
            fail(f"memory {key}: non-finite loss {losses}")
        if counts != want:
            fail(f"memory {key}: kernel launches {counts}, expected {want}")
        if built != {"async_step": 1}:
            fail(f"memory {key}: built {built}, expected one async step")
        if dq.n:
            fail(f"memory {key}: {dq.n} engine dequantizations")
        for k, v in counts.items():
            totals[k] += v
    return totals, step_ms_by_case


def memory_profile(cfg):
    """One traced async step of kernel centered_clip (row 2 of the
    straggler trace, after a warm-up step): step ms, device busy, idle
    share, K22's device time and the top device events; then, on that
    step's buffer, the device time of the clip-radius stage (the row norms
    of one iteration, plain torch) apart from K22, and of the whole
    ``aggregate_flat`` on each impl."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import (_cclip_lam, _masked_prelude,
                                              make_spec)
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    params, buffer, batch, refresh, cw = async_setup(cfg, 5)
    spec = make_spec("centered_clip", f=F, n=N, impl="kernel")
    opt = adamw(constant(1e-4))
    bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec,
                         attack="sign_flip", remat=True)
    step = make_async_step(cfg, bz, opt, device=DEVICE)
    ost = opt.init(params)
    st = spec.init_state(params)
    args = (batch, None, refresh, cw)
    _, _, _, _, st, _ = step(params, ost, None, buffer, st, *args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, _, _, st, _ = step(params, ost, None, buffer, st, *args)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, _, st, _ = step(params, ost, None, buffer, st, *args)
        torch.cuda.synchronize()
        traced_ms = 1e3 * (time.perf_counter() - t0)
    busy, span, by_name = device_busy(prof)
    seen = busy > 0
    k22 = sum(t for k, t in by_name.items() if "clipped_wsum_kernel" in k)
    top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
    mask, w, _, tot = _masked_prelude(cw > 0, cw)
    wn = w / tot
    tau = torch.tensor(1.0, device=DEVICE)
    v = st["server_grad"]
    norm_ms = time_ms(lambda: _cclip_lam(buffer, mask, wn, v, tau), 5)
    agg_ms = {}
    for impl in ("kernel", "gather"):
        sp = make_spec("centered_clip", f=F, n=N, impl=impl)
        agg_ms[impl] = time_ms(
            lambda: sp.aggregate_flat(buffer, mask, cw, state=st), 3)
    emit("profile_memory", rule="centered_clip", impl="kernel", n=N,
         step_ms=wall_ms, traced_step_ms=traced_ms,
         device_busy_ms=busy if seen else "not measured",
         device_span_ms=span if seen else "not measured",
         device_idle_share=(1 - busy / wall_ms) if seen else "not measured",
         k22_device_ms_per_step=k22 if seen else "not measured",
         norm_stage_ms_per_iteration=norm_ms,
         aggregate_flat_ms=agg_ms,
         top_device_events_ms=[[k[:60], t] for k, t in top])
    del params, buffer, batch, ost, st
    torch.cuda.empty_cache()
    return {"norm_stage_ms_per_iteration": norm_ms,
            "aggregate_flat_ms": agg_ms}


def memory_pair(cfg, attack, params, buffer, batch, refresh, cw, carried):
    """One full-width async step of centered_clip with impl="kernel" and
    with impl="gather" from the same parameters, fresh optimizer state,
    buffer, trace row and carried state under ``attack``; returns (store,
    losses, the new states)."""
    from repro_torch.core.aggregators import make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    store, losses, states = {}, {}, {}
    for impl in ("kernel", "gather"):
        spec = recorded(make_spec("centered_clip", f=F, n=N, impl=impl),
                        store)
        bz = ByzantineConfig(n_agents=N, f=F, aggregator=spec, attack=attack,
                             remat=True)
        opt = adamw(constant(1e-4))
        step = make_async_step(cfg, bz, opt, device=DEVICE)
        p = _clone(params)
        st = {"server_grad": carried.clone()}
        if attack != "sign_flip":
            st = {"agg": st, "atk": {}}
        _, _, _, _, st, met = step(p, opt.init(p), None, buffer.clone(), st,
                                   batch, None, refresh, cw)
        losses[impl] = float(met["loss"])
        states[impl] = st.get("agg", st)["server_grad"]
        del p
    return store, losses, states


def phase_memory_vs_gather(cfg):
    """Phase 4m: kernel against gather for centered_clip, from one state
    (seed 6, row 2 of the straggler trace) with a nonzero ``server_grad``
    carried from an earlier gather step: under sign_flip and under
    min_max (whose probes run the gather impl on both paths), the arenas,
    mask and weights equal and the losses equal; the aggregate, the new
    ``server_grad`` and each of the 5 iterates within 3e-6."""
    from repro_torch.core.aggregators import cclip_iterates, make_spec
    from repro_torch.optim import adamw, constant
    from repro_torch.simulator import make_async_step
    from repro_torch.training import ByzantineConfig

    torch.use_deterministic_algorithms(True, warn_only=True)
    params, buffer, batch, refresh, cw = async_setup(cfg, 6)
    spec = make_spec("centered_clip", f=F, n=N, impl="gather")
    opt = adamw(constant(1e-4))
    step = make_async_step(cfg, ByzantineConfig(
        n_agents=N, f=F, aggregator=spec, attack="sign_flip", remat=True),
        opt, device=DEVICE)
    p = _clone(params)
    _, _, _, buffer, carried, _ = step(p, opt.init(p), None, buffer,
                                       spec.init_state(p), batch, None,
                                       refresh, cw)
    carried = carried["server_grad"]
    del p, step
    for attack in ("sign_flip", "min_max"):
        store, losses, states = memory_pair(cfg, attack, params, buffer,
                                            batch, refresh, cw, carried)
        (xk, mk, wk, ak, _), (xg, mg, wg, ag, _) = (store["kernel"],
                                                    store["gather"])
        same_arena = same(xk, xg) and same(mk, mg) and same(wk, wg)
        close = {"aggregate": (ak, ag),
                 "server_grad": (states["kernel"], states["gather"])}
        st = {"server_grad": carried}
        its = zip(cclip_iterates(make_spec("centered_clip", f=F, n=N,
                                           impl="kernel"), xk, mk, wk, st),
                  cclip_iterates(make_spec("centered_clip", f=F, n=N,
                                           impl="gather"), xg, mg, wg, st))
        for i, pair in enumerate(its, 1):
            close[f"iterate_{i}"] = pair
        errs = {k: max_abs_err(a, b) for k, (a, b) in close.items()}
        within = {k: bool(torch.allclose(a, b, rtol=TOL, atol=TOL))
                  for k, (a, b) in close.items()}
        ok = (same_arena and all(within.values())
              and len(close) == 2 + CCLIP_ITERS
              and losses["kernel"] == losses["gather"])
        emit("memory_vs_gather", rule="centered_clip", attack=attack, ok=ok,
             same_arena=same_arena, max_abs_diff=errs, within_3e6=within,
             loss_kernel=losses["kernel"], loss_gather=losses["gather"],
             carried_norm=float(torch.linalg.vector_norm(carried)))
        del store, close, its
        torch.cuda.empty_cache()
        if not ok:
            fail(f"memory_vs_gather {attack}: arena equal {same_arena}, "
                 f"errors {errs}, losses {losses}")
    torch.use_deterministic_algorithms(False)
    del params, buffer, batch, carried
    torch.cuda.empty_cache()


# the kernels each rule's kernel impl launches on a masked bf16 + fp32 tree
MIXED_TREE_KERNELS = {
    "coordinate_median": {"masked_coord_stat": 2},
    "trimmed_mean": {"masked_coord_stat": 2},
    "sign_sgd": {"masked_sign_vote": 2},
    "sparse_mean": {K17: 2},
    "krum": {"gram": 1, "krum_select": 1, "weighted_sum": 1}}


def mixed_tree_checks():
    """The masked ``spec.aggregate`` on a tree of bf16 and fp32 leaves (6
    of 8 arrived, staleness weights) at a small width, kernel against
    gather: median, sign and krum exact, trimmed mean and sparse_mean
    within 3e-6 (bf16 leaves 2e-2: one rounding after a reassociated sum);
    the kernel impl launches one masked kernel per leaf dtype (krum: the
    imputed fallback, K2 -> K3 -> K4 once, with its one warning), the
    gather impl none."""
    from repro_torch import kernels
    from repro_torch.core.aggregators import make_spec

    gen = torch.Generator(device=DEVICE).manual_seed(13)

    def leaf(shape, dtype):
        x = torch.randn((N,) + shape, generator=gen, device=DEVICE) * 1e-3
        keep = torch.rand((N,) + shape, generator=gen, device=DEVICE) < 0.6
        return torch.where(keep, x, torch.zeros((), device=DEVICE)).to(dtype)

    tree = {"a": leaf((64, 33), torch.bfloat16),
            "b": {"c": leaf((1000,), torch.float32),
                  "e": leaf((7, 129), torch.bfloat16)}}
    m = arrival_mask(6).bool()
    w, _ = discount_weights(m.float())
    for rule, want in MIXED_TREE_KERNELS.items():
        outs, counts, warned = {}, {}, {}
        for impl in ("kernel", "gather"):
            kernels.reset_launch_counts()
            with warnings.catch_warnings(record=True) as rec:
                warnings.simplefilter("always")
                outs[impl] = make_spec(rule, f=F, impl=impl, n=N).aggregate(
                    tree, mask=m, weights=w)
            torch.cuda.synchronize()
            counts[impl] = {k: v for k, v in kernels.launch_counts().items()
                            if v}
            warned[impl] = sum("mixed dtypes" in str(r.message) for r in rec)
        errs, ok = {}, True
        for key, k_leaf, g_leaf in (
                ("a", outs["kernel"]["a"], outs["gather"]["a"]),
                ("b.c", outs["kernel"]["b"]["c"], outs["gather"]["b"]["c"]),
                ("b.e", outs["kernel"]["b"]["e"], outs["gather"]["b"]["e"])):
            errs[key] = max_abs_err(k_leaf, g_leaf)
            tol = TOL if k_leaf.dtype == torch.float32 else 2e-2
            ok &= (k_leaf.dtype == g_leaf.dtype and (
                errs[key] == 0.0 if rule in EXACT_RULES else
                bool(torch.allclose(k_leaf.float(), g_leaf.float(),
                                    rtol=tol, atol=tol))))
        ok &= counts["kernel"] == want and not counts["gather"]
        ok &= warned == {"kernel": int(rule == "krum"), "gather": 0}
        emit("mixed_tree", rule=rule, ok=ok, max_abs_diff=errs,
             launches=counts, fallback_warnings=warned)
        if not ok:
            fail(f"mixed-dtype tree {rule}: errors {errs}, launches {counts} "
                 f"(kernel impl expected {want}), warnings {warned}")


OUR_KERNELS = ("coord_stat_kernel", "gram_reg_kernel", "gram_partial_kernel",
               "gram_finish_kernel", "krum_select_kernel", "wsum_kernel",
               "masked_wsum_kernel", "cge_select_kernel",
               "multi_krum_order_kernel", "iterative_order_kernel",
               "ordered_apply_kernel", "bulyan_coord_kernel",
               "sign_vote_kernel", "sparse_wmean_kernel",
               "coord_sort_kernel", "clipped_wsum_kernel")


def device_busy(prof):
    """Device-side events of a trace only (kernels, copies, sets): the
    union of their intervals in ms, the span from the first start to the
    last end in ms, and the time per event name.  CPU operator rows are
    left out: they carry the device time of the kernels they launched,
    which the kernels' own rows hold already."""
    from torch.autograd import DeviceType
    evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for e in evs:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    span = (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0
    return busy / 1e3, span, by_name


def phase_profile(cfg, table):
    """Per rule of ``table``, after a warm-up step: one untimed-by-profiler
    step timed on the host clock, then one traced step.  Reports the
    device busy time (union of device events), the idle share against
    the untraced step, the kernels' share of the busy time, the peak
    device memory of the traced step and the top device events.  Runs
    after the main path's launch counts are read."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.aggregators import make_spec
    from repro_torch.data import SyntheticLM
    from repro_torch.device import make_generator
    from repro_torch.models import init_params
    from repro_torch.optim import adamw, constant
    from repro_torch.training import ByzantineConfig, make_train_step

    gen = make_generator(2, DEVICE)
    params = init_params(cfg, gen)
    for rule, (n, hyper, _) in table.items():
        ds = SyntheticLM(cfg.vocab_size, SEQ, n, PER_AGENT)
        opt = adamw(constant(1e-4))
        bz = ByzantineConfig(n_agents=n, f=F,
                             aggregator=make_spec(rule, f=F, n=n, **hyper),
                             attack="sign_flip", remat=True)
        step = make_train_step(cfg, bz, opt, device=DEVICE)
        state = opt.init(params)
        batch = ds.batch(ds.draw_starts(gen))
        step(params, state, None, batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, state, None, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, None, batch)
            torch.cuda.synchronize()
            traced_ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        busy, span, by_name = device_busy(prof)
        seen = busy > 0
        ours = sum(t for k, t in by_name.items()
                   if any(name in k for name in OUR_KERNELS))
        top = sorted(by_name.items(), key=lambda r: -r[1])[:8]
        emit("profile", rule=rule, n=n, step_ms=wall_ms,
             traced_step_ms=traced_ms,
             device_busy_ms=busy if seen else "not measured",
             device_span_ms=span if seen else "not measured",
             device_idle_share=(1 - busy / wall_ms) if seen else
             "not measured",
             aggregation_kernels_ms=ours if seen else "not measured",
             peak_mem_gb=peak / 1e9,
             top_device_events_ms=[[k[:60], t] for k, t in top])
        del state
    del params
    torch.cuda.empty_cache()


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


# ---------------------------------------------------------------------------


def main():
    # deterministic cuBLAS for the kernel-vs-gather phase: set before the
    # first CUDA call
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this smoke test needs an NVIDIA GPU")
    sys.path.insert(0, os.path.join(HERE, "src"))
    try:
        from repro_torch.configs import get_config, num_params
    except ImportError as e:
        fail(f"cannot import repro_torch from {HERE}/src: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    card = phase_device()
    cfg = get_config("paper-100m")
    summary, _ = kernel_checks(num_params(cfg))
    summary.update(masked_kernel_checks(num_params(cfg)))
    summary.update(selection_kernel_checks(num_params(cfg)))
    summary.update(masked_selection_kernel_checks(num_params(cfg)))
    summary.update(scaled_kernel_checks(num_params(cfg)))
    arena = real_arena(cfg)
    summary.update(sparse_kernel_checks(arena))
    sort_summary, sort_counts = sort_checks(arena)
    summary.update(sort_summary)
    del arena
    torch.cuda.empty_cache()
    summary.update(cclip_kernel_checks(num_params(cfg)))
    sync_rules = {**{r: (N, {}, RULE_KERNELS[r]) for r in RULES},
                  **SIGN_RULES}
    totals = phase_train(cfg, sync_rules, STEPS)
    check_straggler_traces()
    async_totals, async_step_ms = phase_async(cfg, ASYNC_RULES, ASYNC_STEPS)
    elastic_totals = phase_async_elastic(cfg)
    sel_totals = phase_train(cfg, SEL_RULES, SEL_STEPS)
    asel_totals, asel_step_ms = phase_async(cfg, ASYNC_SEL_RULES,
                                            ASYNC_SEL_STEPS)
    quant_totals = [phase_train(cfg, QUANT_RULES, QUANT_STEPS, agg_dtype=q)
                    for q in QUANT]
    aquant_totals, aquant_step_ms = phase_async(
        cfg, ASYNC_QUANT_RULES, QUANT_STEPS, agg_dtype="int8")
    sparse_totals = [phase_train(cfg, SPARSE_SYNC, STEPS)]
    asparse_totals, asparse_step_ms = phase_async(cfg, SPARSE_ASYNC,
                                                  ASYNC_STEPS)
    sparse_totals += [phase_train(cfg, SPARSE_QUANT, QUANT_STEPS,
                                  agg_dtype=q) for q in QUANT]
    asq_totals, asq_step_ms = phase_async(cfg, SPARSE_AQUANT, QUANT_STEPS,
                                          agg_dtype="int8")
    sparse_totals += [asparse_totals, asq_totals, sort_counts]
    memory_totals, memory_step_ms = phase_memory(cfg)
    phase_profile(cfg, {"trimmed_mean": (N, {}, ()), "krum": (N, {}, ()),
                        **SEL_RULES, "sparse_mean": (N, {}, ())})
    phase_profile_async(cfg, {**{r: (N, 6, {}) for r in RULES},
                              "multi_krum": (N, 6, {"m": 3}),
                              "sparse_mean": (N, 6, {}),
                              "bulyan": (11, 9, {})})
    phase_kernel_vs_gather(cfg, sync_rules)
    phase_selection_vs_gather(cfg)
    phase_tie_check(cfg)
    phase_masked_vs_gather(cfg, {**ASYNC_RULES, **ASYNC_SEL_RULES})
    phase_quant_vs_gather(cfg)
    phase_sparse_vs_gather(cfg)
    memory_stage_ms = memory_profile(cfg)
    phase_memory_vs_gather(cfg)
    kern = []
    for name, (src, replaces) in SOURCES.items():
        s = summary[name]
        kern.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": (totals[name] + async_totals[name]
                                  + elastic_totals[name] + sel_totals[name]
                                  + asel_totals[name]
                                  + sum(t[name] for t in quant_totals)
                                  + aquant_totals[name]
                                  + sum(t[name] for t in sparse_totals)
                                  + memory_totals[name]),
                     "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                     "bound_by": s["bound_by"],
                     "library_ms": s["library_ms"]})
    from repro_torch.kernels import build
    emit("done", seconds=round(time.time() - t0, 1),
         kernel_build_s=round(build.BUILD_INFO.get("seconds", 0.0), 1),
         imputed_mean=summary["imputed_mean"],
         async_median_step_ms=async_step_ms,
         async_selection_median_step_ms=asel_step_ms,
         async_quant_median_step_ms=aquant_step_ms,
         async_sparse_median_step_ms={"float32": asparse_step_ms,
                                      "int8": asq_step_ms},
         sign_vote_on_codes=summary["sign_vote_codes"],
         memory_median_step_ms=memory_step_ms,
         centered_clip_stages=memory_stage_ms)
    print(json.dumps({"kernels": kern}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
