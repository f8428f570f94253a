"""Wire quantization of the compressed exchange: the port's
``core.flat.quantize_rows`` / ``dequantize_rows`` / ``fake_quantize``
against the JAX package's, for int8 and float8_e4m3fn.

Inputs are made with numpy from a seed: n = 3, 8 and 12 rows of an odd
width, with a zero row, a NaN row and an inf row, int8 values on exact .5
ties of x / scale, and fp8 values on rounding ties and in the e4m3
subnormal code range.  Codes and scales must be bitwise equal (codes
compared as bytes, so a NaN code's sign counts too).

ROADMAP.md P13: XLA on the CPU flushes subnormal fp32 values to zero, so
the JAX package quantizes a row of subnormal gradients as an all-zero row
(scale 1.0, codes 0).  The port keeps IEEE arithmetic, as the card does
by default: such a row gets scale amax / qmax and its own codes.  The
P13 test holds the port to that IEEE law, computed independently in
numpy, and records the JAX package's flushed result beside it.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.flat import dequantize_rows as jax_dequantize_rows
from repro.core.flat import fake_quantize as jax_fake_quantize
from repro.core.flat import quantize_rows as jax_quantize_rows
from repro_torch.core.flat import (QUANT_DTYPES, dequantize_rows,
                                   fake_quantize, quantize_rows)

torch.set_num_threads(2)
QDTYPES = sorted(QUANT_DTYPES)
D = 771


def rows(n, seed):
    """(n, D) fp32 gradient-like rows (normal times a log-normal spread)
    with the hazard rows: 0 all zero, 1 NaN, 2 inf (with -inf and finite
    values), and a .5-tie / fp8-tie row where n > 3."""
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(n, D)) * np.exp(rng.normal(size=(n, D)))
         * 1e-3).astype(np.float32)
    g[0] = 0.0
    g[1, ::5] = np.nan
    g[2, ::7], g[2, 3::7] = np.inf, -np.inf
    if n > 3:
        # amax 254 -> int8 scale 2 exactly: odd integers are x / scale
        # ties (k + 0.5), rounded half to even
        g[3] = rng.integers(-127, 127, size=D) * 2 + 1
        g[3, 0] = 254.0
        # amax 448 -> fp8 scale 1: the midpoints between neighbouring
        # e4m3 values (ties to even), and the subnormal code range below
        # 2^-6 (multiples of 2^-10, halfway between 2^-9 steps)
        grid = np.asarray([1.0, 1.125, 2.0, 2.25, 64.0, 72.0, 0.015625],
                          np.float32)
        mids = (grid[:-1] + np.asarray([1.125, 1.25, 2.25, 2.5, 72.0, 80.0],
                                       np.float32)) / 2
        sub = np.arange(-15, 16, dtype=np.float32) * 2.0 ** -10
        vals = np.concatenate([mids, -mids, grid, sub])
        g[4] = np.resize(vals, D)
        g[4, 1] = 448.0
    return g


def codes_np(c):
    return np.asarray(c).view(np.uint8)


@pytest.mark.parametrize("qdt", QDTYPES)
@pytest.mark.parametrize("n", [3, 8, 12])
def test_quantize_rows_is_bitwise_jax(n, qdt):
    g = rows(n, seed=n)
    jc, js = jax_quantize_rows(jnp.asarray(g), jnp.dtype(qdt))
    tc, ts = quantize_rows(torch.from_numpy(g), qdt)
    assert tc.dtype == getattr(torch, qdt) and ts.dtype == torch.float32
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy(),
                                  codes_np(jc))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    # the dequantized rows and the round trip, bit for bit (NaN = NaN)
    np.testing.assert_array_equal(dequantize_rows(tc, ts).numpy(),
                                  np.asarray(jax_dequantize_rows(jc, js)))
    np.testing.assert_array_equal(
        fake_quantize(torch.from_numpy(g), qdt).numpy(),
        np.asarray(jax_fake_quantize(jnp.asarray(g), jnp.dtype(qdt))))


@pytest.mark.parametrize("n", [8, 12])
def test_quantize_ties_and_hazard_rows(n):
    """What the hazard rows quantize to: half-to-even on the int8 ties,
    scale 1 and codes 0 on a zero or NaN row (int8: the NaN code pinned to
    0; fp8 keeps it NaN), scale inf on an inf row with codes 0 where the
    value is finite."""
    g = rows(n, seed=n)
    tc, ts = quantize_rows(torch.from_numpy(g), "int8")
    c = tc.numpy()
    np.testing.assert_array_equal(ts.numpy()[:2], [1.0, 1.0])
    np.testing.assert_array_equal(c[:2], 0)
    assert ts[2] == np.inf
    finite = np.isfinite(g[2])
    np.testing.assert_array_equal(c[2][finite], 0)
    assert float(ts[3]) == 2.0
    np.testing.assert_array_equal(c[3], np.round(g[3] / 2.0))   # half even
    assert np.any(np.abs(g[3] / 2.0 % 2) == 0.5)                # ties hit
    fc, fs = quantize_rows(torch.from_numpy(g), "float8_e4m3fn")
    f = fc.view(torch.uint8).numpy()
    assert np.all((f[1][np.isnan(g[1])] & 0x7F) == 0x7F)         # NaN code
    assert float(fs[4]) == 1.0
    np.testing.assert_array_equal(
        f[4], g[4].astype(ml_dtypes.float8_e4m3fn).view(np.uint8))


@pytest.mark.parametrize("qdt", QDTYPES)
def test_quantize_roundtrip_is_the_dequant_law(qdt):
    """quantize_rows -> dequantize_rows IS fake_quantize, bit for bit, and
    int8 reconstructs within half a code step (the law of the JAX test of
    the same name)."""
    n, d = 12, 771
    g = (np.random.default_rng(13).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    codes, qs = quantize_rows(torch.from_numpy(g), qdt)
    assert codes.dtype == getattr(torch, qdt) and qs.shape == (n,)
    assert bool(torch.all(qs > 0))
    deq = dequantize_rows(codes, qs)
    np.testing.assert_array_equal(
        deq.numpy(), fake_quantize(torch.from_numpy(g), qdt).numpy())
    if qdt == "int8":
        err = np.abs(deq.numpy() - g)
        assert float(np.max(err / qs.numpy()[:, None])) <= 0.5 + 1e-6


@pytest.mark.parametrize("qdt", QDTYPES)
def test_quantize_zero_row_guard(qdt):
    """An all-zero row must not divide by its zero amax: scale 1.0, codes
    0, decode 0 (the law of the JAX test of the same name)."""
    g = np.zeros((4, 640), np.float32)
    g[1] = np.random.default_rng(14).normal(size=640) * 2.0
    codes, qs = quantize_rows(torch.from_numpy(g), qdt)
    assert torch.isfinite(qs).all()
    assert float(qs[0]) == 1.0
    np.testing.assert_array_equal(dequantize_rows(codes, qs)[0].numpy(), 0.0)


@pytest.mark.parametrize("qdt", QDTYPES)
def test_subnormal_row_keeps_ieee_arithmetic(qdt):
    """ROADMAP.md P13.  A row of subnormal fp32 gradients: the port gives
    scale = amax / qmax and codes = x / scale (clipped to [-qmax, qmax],
    rounded half to even for int8, cast for fp8) in IEEE fp32, bit for
    bit with the same law computed in numpy; the JAX package on the CPU flushes the
    row to zero (scale 1.0, codes 0).  Normal rows are unaffected."""
    rng = np.random.default_rng(5)
    g = (rng.normal(size=(3, 515)) * 1e-3).astype(np.float32)
    g[1] = (rng.integers(-2000, 2000, size=515) * 2.0 ** -149).astype(
        np.float32)                                   # subnormal values
    assert 0 < np.max(np.abs(g[1])) < np.finfo(np.float32).tiny
    qmax = np.float32(QUANT_DTYPES[qdt])
    amax = np.max(np.abs(g[1]))
    scale = amax / qmax                               # numpy keeps IEEE
    q = g[1] / scale
    # the subnormal scale is coarse, so |x / scale| may pass qmax: both
    # dtypes clip to [-qmax, qmax] before the cast
    want = (np.clip(np.round(q), -qmax, qmax).astype(np.int8).view(np.uint8)
            if qdt == "int8" else
            np.clip(q, -qmax, qmax).astype(ml_dtypes.float8_e4m3fn).view(
                np.uint8))
    if qdt != "int8":
        assert np.max(np.abs(q)) > qmax               # the clip is needed
    tc, ts = quantize_rows(torch.from_numpy(g), qdt)
    assert float(ts[1]) == float(scale) and float(ts[1]) != 1.0
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy()[1], want)
    assert np.count_nonzero(want) > 400               # the row is kept
    jc, js = jax_quantize_rows(jnp.asarray(g), jnp.dtype(qdt))
    assert float(js[1]) == 1.0                        # XLA flushed it
    assert not np.any(np.asarray(jc).astype(np.float32)[1])
    # the normal rows stay bitwise equal
    np.testing.assert_array_equal(tc.view(torch.uint8).numpy()[[0, 2]],
                                  codes_np(jc)[[0, 2]])
    np.testing.assert_array_equal(ts.numpy()[[0, 2]], np.asarray(js)[[0, 2]])
