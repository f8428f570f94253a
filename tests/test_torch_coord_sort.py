"""K23 coord_sort and the legacy ``ops`` sort paths against the JAX
package.

On the CPU the wrapper runs its plain version (K1's odd-even network with
every rank kept), held to the JAX Pallas kernel in interpret mode value
for value, NaN order included (a tied -0.0 / +0.0 may come out either
way round, and a NaN's bits are the CPU's own): a NaN spreads through the network as ``jnp.minimum``
/ ``jnp.maximum`` spread it, not to the end as a library sort puts it.
The statistics read off the sorted stack: the median exact, the trimmed
mean within rtol = atol = 3e-6 (JAX's ``jnp.mean`` reassociates the kept
window).  The pairwise distances off the Gram (K2, fp64 sums): within
3e-6 of the Cauchy-Schwarz scale G_ii + G_jj, as P1 holds the Gram.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.coord_stats import coord_sort as jax_coord_sort
from repro.kernels.ops import _pad_d
from repro_torch import kernels
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import ref

torch.set_num_threads(2)
TOL = 3e-6
D = 515
HAZARDS = [None, "nan_row", "inf_rows", "spots", "ties"]


def stack(n, seed, dtype, hazard, d=D):
    g = (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)
    if hazard == "nan_row":
        g[n // 2] = np.nan
    elif hazard == "inf_rows":
        g[0], g[n - 1] = np.inf, -np.inf
    elif hazard == "spots":
        g[1, ::7], g[0, 3::11], g[n - 1, 5::13] = np.nan, np.inf, -np.inf
    elif hazard == "ties":
        g[1] = g[0]
        g[:, ::4] = np.round(g[:, ::4])
    return g if dtype == "float32" else np.asarray(
        jnp.asarray(g, jnp.bfloat16))


def same_values(ours, want):
    """NaN at the same places and every other value equal.  A NaN's sign
    and payload, and which of two tied zeros (-0.0, +0.0) a minimum
    returns, are each library's own: not part of the law."""
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(want))
    np.testing.assert_array_equal(ours, want)


@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [3, 8, 11])
def test_coord_sort_plain_equals_jax_bitwise(n, dtype, hazard):
    g = stack(n, n, dtype, hazard)
    ours = kernels.coord_sort(tensor_from_numpy(g))
    assert ours.dtype == torch.float32 and ours.shape == (n, D)
    gp, d = _pad_d(jnp.asarray(g))
    want = np.asarray(jax_coord_sort(gp, interpret=True))[:, :d]
    same_values(ours.numpy(), want)
    if hazard in (None, "ties", "inf_rows"):          # no NaN: a sort
        np.testing.assert_array_equal(ours.numpy(), np.asarray(
            jax_ref.coord_sort_ref(jnp.asarray(g))))
        np.testing.assert_array_equal(ours.numpy(),
                                      ref.coord_sort_ref(
                                          tensor_from_numpy(g)).numpy())


@pytest.mark.parametrize("hazard", [None, "nan_row", "spots"])
@pytest.mark.parametrize("n", [3, 8, 11])
def test_coord_sort_ref_matches_jax(n, hazard):
    """The library sort oracle, NaN last on both sides."""
    g = stack(n, 40 + n, "float32", hazard)
    np.testing.assert_array_equal(
        ref.coord_sort_ref(tensor_from_numpy(g)).numpy(),
        np.asarray(jax_ref.coord_sort_ref(jnp.asarray(g))))


@pytest.mark.parametrize("hazard", [None, "nan_row", "inf_rows", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [3, 8, 11])
def test_ops_statistics_match_jax(n, dtype, hazard):
    """kernel_coordinate_median exact, kernel_trimmed_mean within 3e-6 for
    every per-side trim, against JAX ``ops``."""
    g = stack(n, 10 + n, dtype, hazard)
    tg, jg = tensor_from_numpy(g), jnp.asarray(g)
    np.testing.assert_array_equal(
        kernels.kernel_coordinate_median(tg).numpy(),
        np.asarray(jax_ops.kernel_coordinate_median(jg, interpret=True)))
    for b in range((n - 1) // 2 + 1):
        np.testing.assert_allclose(
            kernels.kernel_trimmed_mean(tg, b).numpy(),
            np.asarray(jax_ops.kernel_trimmed_mean(jg, b, interpret=True)),
            rtol=TOL, atol=TOL, err_msg=f"b={b}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [3, 8, 11])
def test_pairwise_sq_dists_match_jax(n, dtype):
    g = np.array(stack(n, 20 + n, dtype, None))
    g[n - 1] = g[0]                          # an exact pair: distance 0
    ours = kernels.kernel_pairwise_sq_dists(tensor_from_numpy(g)).numpy()
    want = np.asarray(jax_ops.kernel_pairwise_sq_dists(jnp.asarray(g),
                                                       interpret=True))
    x = np.asarray(g, np.float64)
    sq = np.sum(x * x, axis=1)
    scale = sq[:, None] + sq[None, :]
    assert np.all(np.abs(ours - want) <= TOL * scale + TOL)
    assert (ours >= 0).all() and ours[0, n - 1] == 0.0
    exact = np.maximum(scale - 2.0 * (x @ x.T), 0.0)
    assert np.all(np.abs(ours - exact) <= TOL * scale)


def test_coord_sort_counts_no_launch_on_the_cpu_and_rejects_bad_input():
    kernels.reset_launch_counts()
    kernels.kernel_trimmed_mean(torch.randn(5, 9), 1)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match="n="):
        kernels.coord_sort(torch.randn(65, 3))
    with pytest.raises(ValueError, match="stack"):
        kernels.coord_sort(torch.randn(4))
