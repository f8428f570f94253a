"""The scaled kernels of the compressed exchange and the engine around
them: K18 scaled_coord_stat, K19 scaled_masked_coord_stat, K20
scaled_masked_sign_vote and K15 sign_vote on int8 / fp8 codes, against the
JAX package.

On the CPU each wrapper runs its plain version (the plain K1 / K5 / K16
law on ``dequantize_rows(codes, scale)``), held against the JAX Pallas
kernel run in interpret mode, as the JAX suite runs it, on the same codes
and scales.  Median values and sign votes must match exactly
(``assert_array_equal``: NaN equals NaN), trimmed means within rtol =
atol = 3e-6 (another summation order of the same kept window).  n = 3,
4, 8 and 12 rows of d = 515 (not a multiple of JAX's 512-lane tile); masks
of n - 2, 1 and 0 rows arrived; NaN rows and inf rows (an inf row's scale
is inf, so it dequantizes to NaN: 0 * inf), live and absent.

K20 keeps the JAX kernel's dequantizing multiply, so a live inf row
poisons every column of the async vote; the synchronous compressed
sign_sgd votes on the raw codes with K15 (a scale > 0 changes no sign),
where the inf row's 0 codes cast a 0 vote.  Both are the JAX package's
behaviour, and both are held here.  Absent rows are not read (ROADMAP.md
P10): the JAX kernel leaks an absent row's NaN into the vote, so the
masked votes are compared where the absent rows are finite.
"""
import warnings

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.kernels.masked import \
    scaled_coord_stat as jax_scaled_coord_stat
from repro.kernels.masked import \
    scaled_masked_coord_stat as jax_scaled_masked_coord_stat
from repro.kernels.masked import \
    scaled_masked_sign_vote as jax_scaled_masked_sign_vote
from repro.kernels.masked import sign_vote as jax_sign_vote
from repro.kernels.ops import _pad_d
from repro_torch import kernels
from repro_torch.core import aggregators as A
from repro_torch.core.aggregators import make_spec, trim_count
from repro_torch.core.flat import dequantize_rows, quantize_rows
from repro_torch.kernels.dispatch import (KERNEL_SCALED_MASKED_RULES,
                                          KERNEL_SCALED_RULES,
                                          kernel_scaled_supported)

torch.set_num_threads(2)
D_ = 515
F = 2
TOL = 3e-6
NS = [3, 4, 8, 12]
QDTYPES = ["int8", "float8_e4m3fn"]
HAZARDS = [None, "nan", "inf"]
# the coordinate statistics' cases (n, qdt, hazard): every hazard at NS,
# with the fast path's: ``signed_zero`` and ``zero_row``; and n = 17 and 33
# (the kernels' 32- and 64-row capacities)
STAT_CASES = ([(n, q, h) for n in NS for q in QDTYPES
               for h in HAZARDS + ["signed_zero", "zero_row"]]
              + [(n, q, None) for n in (17, 33) for q in QDTYPES])
# the sign votes' cases: every hazard at NS, the fast path's value
# hazards, and the classes of row 0's scale that K20's fast path hands to
# its exact law (0, tiny, NaN) or folds in (negative); and n = 33 and 64
SCALE_HAZARDS = ["zero_scale", "tiny_scale", "neg_scale", "nan_scale"]
SIGN_CASES = ([(n, q, h) for n in NS for q in QDTYPES
               for h in HAZARDS + ["signed_zero", "zero_row"]
               + SCALE_HAZARDS]
              + [(n, q, None) for n in (33, 64) for q in QDTYPES])
SCALED_RULES = ["coordinate_median", "trimmed_mean", "sign_sgd"]
TINY = 2.0 ** -142            # a subnormal fp32 scale


def quantized(n, seed, qdt, hazard=None, d=D_):
    """(torch codes, torch scale, jax codes, jax scale) of seeded fp32
    rows; ``nan``: row 1 NaN in every 3rd value; ``inf``: row 0 holds +inf
    and -inf (its scale is inf); ``signed_zero``: row 1 holds tiny
    negative values every 2nd value (fp8 codes -0) beside +0 values in
    row 2; ``zero_row``: row 1 is all zero (scale 1, every code 0).  Row
    0's scale after quantize_rows: ``zero_scale`` 0, ``neg_scale``
    negated, ``nan_scale`` NaN, ``tiny_scale`` 2^-142 (fp8: row 0's codes
    then hold +-2^-9, the smallest code, and 0, so every product rounds to
    +-0)."""
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    if hazard == "nan":
        g[min(1, n - 1), ::3] = np.nan
    elif hazard == "inf":
        g[0, ::4], g[0, 1::4] = np.inf, -np.inf
    elif hazard == "signed_zero":
        g[min(1, n - 1), ::2] = -1e-30
        g[min(2, n - 1), 1::2] = 0.0
    elif hazard == "zero_row":
        g[min(1, n - 1)] = 0.0
    tc, ts = quantize_rows(torch.from_numpy(g), qdt)
    if hazard == "zero_scale":
        ts[0] = 0.0
    elif hazard == "neg_scale":
        ts[0] = -ts[0]
    elif hazard == "nan_scale":
        ts[0] = np.nan
    elif hazard == "tiny_scale":
        ts[0] = TINY
        if qdt == "float8_e4m3fn":
            smallest = np.where(g[0] < 0, 0x81, 0x01).astype(np.uint8)
            smallest[::5] = 0
            tc[0] = torch.from_numpy(smallest).view(tc.dtype)
    raw = tc.view(torch.uint8).numpy()
    jc = jnp.asarray(raw.view(np.int8) if qdt == "int8"
                     else raw.view(ml_dtypes.float8_e4m3fn))
    return tc, ts, jc, jnp.asarray(ts.numpy())


def arrivals(n, arrived, seed):
    m = np.zeros(n, np.float32)
    m[np.random.default_rng(seed).permutation(n)[:arrived]] = 1.0
    return m


def jax_kernel(fn, jc, *args, **kw):
    gp, d = _pad_d(jc)
    return np.asarray(fn(gp, *args, interpret=True, **kw))[:d]


def check(ours, ref, stat):
    assert ours.dtype == torch.float32
    if stat == "trimmed_mean":
        np.testing.assert_allclose(ours.numpy(), ref, rtol=TOL, atol=TOL)
    else:
        np.testing.assert_array_equal(ours.numpy(), ref)


@pytest.mark.parametrize("n,qdt,hazard", STAT_CASES)
def test_scaled_coord_stat_plain_matches_jax(n, qdt, hazard):
    tc, ts, jc, js = quantized(n, n, qdt, hazard)
    for stat in ("median", "trimmed_mean"):
        b = trim_count(n, F, None) if stat == "trimmed_mean" else 0
        ref = jax_kernel(jax_scaled_coord_stat, jc, js, stat, b)
        check(kernels.scaled_coord_stat(tc, ts, stat, b), ref, stat)


@pytest.mark.parametrize("absent", [False, True])
@pytest.mark.parametrize("n,qdt,hazard", STAT_CASES)
def test_scaled_masked_coord_stat_plain_matches_jax(n, qdt, hazard, absent):
    """The arrived-window law over the dequantized rows; ``absent``: the
    hazard row is among the absent ones (then it is never a statistic)."""
    tc, ts, jc, js = quantized(n, 10 + n, qdt, hazard)
    for k, arrived in enumerate((max(n - 2, 1), 1, 0)):
        m = arrivals(n, arrived, 20 + n + k)
        if hazard is not None and arrived:
            row = 0 if hazard == "inf" else min(1, n - 1)
            if m[row] == float(absent):      # put the row where asked
                other = int(np.flatnonzero(m != float(absent))[0]) if (
                    (m != float(absent)).any()) else row
                m[row], m[other] = m[other], m[row]
        wn = m / max(m.sum(), 1.0)
        for stat in ("median", "trimmed_mean"):
            b = trim_count(n, F, None) if stat == "trimmed_mean" else 0
            ref = jax_kernel(jax_scaled_masked_coord_stat, jc, js,
                             jnp.asarray(m), jnp.asarray(wn), stat, b)
            out = kernels.scaled_masked_coord_stat(
                tc, ts, torch.from_numpy(m), torch.from_numpy(wn), stat, b)
            check(out, ref, stat)
            if arrived == 0:
                np.testing.assert_array_equal(out.numpy(), 0.0)


@pytest.mark.parametrize("n,qdt,hazard", SIGN_CASES)
def test_sign_votes_on_codes_match_jax(n, qdt, hazard):
    """K15 on the raw codes (the synchronous compressed sign_sgd) and K20
    on the dequantized arrived rows.  An inf row: K15 reads its 0 codes as
    0 votes, K20 reads 0 * inf = NaN and poisons every column it votes in
    (the JAX kernels alike); so does a NaN scale, and a scale of 0 or one
    so tiny that every product rounds to +-0 votes 0 there.  Masks keep
    the hazard row live, or leave it out where its values are finite: the
    JAX K20 leaks an absent NaN (P10), the port's does not read the row,
    so there the port equals the JAX kernel on the arrived rows alone.

    ``tiny_scale`` on int8 codes: a code times 2^-142 is a nonzero
    subnormal of the code's sign, which XLA's CPU flushes to 0 (P13); the
    JAX side votes that row with a scale of 1 (the same signs)."""
    tc, ts, jc, js = quantized(n, 30 + n, qdt, hazard)
    if hazard == "tiny_scale" and qdt == "int8":
        js = js.at[0].set(1.0)
    ref = jax_kernel(jax_sign_vote, jc)
    out = kernels.sign_vote(tc)
    np.testing.assert_array_equal(out.numpy(), ref)
    if hazard == "inf":
        assert not np.isnan(out.numpy()).all()   # 0 votes, not NaN
    for arrived in (max(n - 2, 1), 1, 0):
        m = arrivals(n, arrived, 40 + n + arrived)
        wn = m / max(m.sum(), 1.0)
        ref = jax_kernel(jax_scaled_masked_sign_vote, jc, js,
                         jnp.asarray(m), jnp.asarray(wn))
        out = kernels.scaled_masked_sign_vote(tc, ts, torch.from_numpy(m),
                                              torch.from_numpy(wn))
        deq = dequantize_rows(tc, ts).numpy()
        absent_nan = np.isnan(deq[m == 0]).any(axis=0)
        np.testing.assert_array_equal(out.numpy()[~absent_nan],
                                      ref[~absent_nan])
        if absent_nan.any() and arrived:
            live = np.flatnonzero(m)
            ones = jnp.ones(len(live), jnp.float32)
            np.testing.assert_array_equal(out.numpy(), jax_kernel(
                jax_scaled_masked_sign_vote, jc[live], js[live], ones,
                ones / len(live)))
        if hazard in ("inf", "nan_scale") and m[0]:
            assert np.isnan(out.numpy()).all()    # the row's columns
        if m[0] and (hazard == "zero_scale" or (hazard == "tiny_scale"
                                                and qdt != "int8")):
            # row 0 votes 0: the vote of the other arrived rows
            rest = m.copy()
            rest[0] = 0.0
            np.testing.assert_array_equal(
                out.numpy(), kernels.scaled_masked_sign_vote(
                    tc, ts, torch.from_numpy(rest),
                    torch.from_numpy(rest)).numpy())
        if arrived == 0:
            np.testing.assert_array_equal(out.numpy(), 0.0)


def test_scaled_wrappers_check_their_operands():
    tc, ts, _, _ = quantized(4, 0, "int8")
    g = dequantize_rows(tc, ts)
    with pytest.raises(TypeError, match="int8"):
        kernels.scaled_coord_stat(g, ts, "median")           # not codes
    with pytest.raises(TypeError):
        kernels.scaled_masked_sign_vote(g.bfloat16(), ts, ts, ts)
    with pytest.raises(ValueError, match="scale"):
        kernels.scaled_coord_stat(tc, ts[:3], "median")
    with pytest.raises(ValueError, match="scale"):
        kernels.scaled_masked_coord_stat(tc, ts.double(), ts, ts, "median")
    with pytest.raises(ValueError):
        kernels.scaled_masked_sign_vote(tc, ts, torch.ones(3),
                                        torch.ones(3))
    # K15 takes codes as well as floats
    assert kernels.sign_vote(tc).shape == (D_,)


def test_scaled_tables_hold_the_coordinate_rules():
    assert sorted(KERNEL_SCALED_RULES) == sorted(SCALED_RULES
                                                 + ["sparse_mean"])
    assert sorted(KERNEL_SCALED_MASKED_RULES) == sorted(KERNEL_SCALED_RULES)
    for rule in SCALED_RULES:
        assert kernel_scaled_supported(rule)
        spec = make_spec(rule, f=F, native_dtype=True)
        assert spec.impl == "kernel"
        assert spec == make_spec(rule, f=F)
    assert kernel_scaled_supported("sparse_mean")        # K21
    for rule in ("krum", "multi_krum", "mean"):
        assert not kernel_scaled_supported(rule)
    with pytest.raises(ValueError, match="native_dtype"):
        make_spec("krum", f=F, native_dtype=True)


# ---------------------------------------------------------------------------
# the engine: aggregate_flat(codes, mask=, weights=, scale=)

MODES = ["plain", "masked", "weighted"]


def mode_args(mode, n, seed):
    """(mask, weights) as torch tensors or None; masks keep >= n - F rows."""
    if mode == "plain":
        return None, None
    rng = np.random.default_rng(100 + seed)
    mask = np.ones(n, bool)
    mask[rng.choice(n, size=F, replace=False)] = False
    if mode == "masked":
        return torch.from_numpy(mask), None
    w = rng.uniform(0.3, 1.0, size=n).astype(np.float32)
    return torch.from_numpy(mask), torch.from_numpy(w)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("qdt", QDTYPES)
@pytest.mark.parametrize("rule", SCALED_RULES)
def test_scaled_flat_matches_gather_dequant(rule, qdt, mode):
    """impl="kernel" (the scaled kernels' plain versions here) equals
    impl="gather" (the engine-level dequantization), which equals the
    rule run on ``dequantize_rows(codes, qs)``; and the JAX gather engine
    on the same codes agrees.  Bitwise for median and sign, 3e-6 for
    trimmed_mean; against JAX in the weighted mode within one ulp of the
    tot / cnt factor (the weights' sum in another order)."""
    for n in (9, 12):
        tc, ts, jc, js = quantized(n, 3, qdt, d=771)
        mask, w = mode_args(mode, n, 5)
        ka = make_spec(rule, f=F, impl="kernel", n=n)
        ga = make_spec(rule, f=F, impl="gather", n=n)
        out = ka.aggregate_flat(tc, mask=mask, weights=w, scale=ts)
        expect = ga.aggregate_flat(tc, mask=mask, weights=w, scale=ts)
        law = ga.aggregate_flat(dequantize_rows(tc, ts), mask=mask,
                                weights=w)
        jref = np.asarray(jax_make_spec(rule, f=F, impl="gather", n=n)
                          .aggregate_flat(
                              jc, scale=js,
                              mask=None if mask is None
                              else jnp.asarray(mask.numpy()),
                              weights=None if w is None
                              else jnp.asarray(w.numpy())))
        msg = f"{rule}/{qdt}/{mode}/n={n}"
        assert out.dtype == torch.float32, msg
        np.testing.assert_array_equal(expect.numpy(), law.numpy(),
                                      err_msg=msg)
        if rule == "trimmed_mean":
            for ref in (expect.numpy(), jref):
                np.testing.assert_allclose(out.numpy(), ref, rtol=TOL,
                                           atol=TOL, err_msg=msg)
        else:
            np.testing.assert_array_equal(out.numpy(), expect.numpy(),
                                          err_msg=msg)
            if mode == "weighted":
                # the tot / cnt factor sums the n weights in another
                # order than eager JAX: one ulp of it
                np.testing.assert_allclose(out.numpy(), jref, rtol=2.5e-7,
                                           atol=0, err_msg=msg)
            else:
                np.testing.assert_array_equal(out.numpy(), jref,
                                              err_msg=msg)


def test_scaled_kernel_path_reads_codes_only():
    """The kernel path hands the codes to the scaled kernels: it never
    builds the dequantized (n, P) copy (the engine-level dequantization
    is not called), where the gather path does."""
    tc, ts, _, _ = quantized(8, 4, "int8", d=640)
    mask, w = mode_args("weighted", 8, 5)
    calls = []
    real = A._flat_dequant

    def spy(spec, stack, qscale):
        calls.append(spec.impl)
        return real(spec, stack, qscale)

    A._flat_dequant = spy
    try:
        for rule in SCALED_RULES:
            for m, ww in ((None, None), (mask, w)):
                make_spec(rule, f=F, impl="kernel", n=8).aggregate_flat(
                    tc, mask=m, weights=ww, scale=ts)
        assert calls == []
        make_spec("trimmed_mean", f=F, impl="gather", n=8).aggregate_flat(
            tc, mask=mask, weights=w, scale=ts)
        assert calls == ["gather"]
    finally:
        A._flat_dequant = real


@pytest.mark.parametrize("rule", ["krum", "multi_krum"])
def test_scaled_fallback_rules_warn_once_and_stay_on_law(rule):
    """Rules without a scaled kernel take a quantized arena through the
    engine-level dequantization: one warning naming the in-kernel rules,
    and the dequantize-then-aggregate law exactly (the JAX test of the
    same name, for krum and multi_krum)."""
    n = 8
    tc, ts, _, _ = quantized(n, 15, "int8", d=640)
    mask, w = mode_args("weighted", n, 6)
    spec = make_spec(rule, f=F, impl="kernel", n=n)
    for key in [k for k in A._WARNED_ONCE
                if k[0] == "flat-scaled-dequant"]:
        A._WARNED_ONCE.discard(key)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = spec.aggregate_flat(tc, mask=mask, weights=w, scale=ts)
        spec.aggregate_flat(tc, mask=mask, weights=w, scale=ts)
        sync = spec.aggregate_flat(tc, scale=ts)
    hits = [r for r in rec if "no scaled" in str(r.message)]
    assert len(hits) == 1, [str(r.message) for r in rec]
    deq = dequantize_rows(tc, ts)
    np.testing.assert_array_equal(
        out.numpy(), spec.aggregate_flat(deq, mask=mask, weights=w).numpy())
    np.testing.assert_array_equal(sync.numpy(),
                                  spec.aggregate_flat(deq).numpy())
