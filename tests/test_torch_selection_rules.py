"""The selection family (cge, multi_krum, m_krum, mda, bulyan) through the
registry: ``aggregate_flat`` on the port's kernel path against the JAX
package's ``impl="pallas"``, and the gather path against JAX's gather.

Bars: the selected set and pick order exact (each package's selection
from its own Gram); the fp32 aggregate within rtol = atol = 3e-6; a bf16
arena (JAX given the same bf16 values, and returning bf16) within 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.kernels.ops import _d2_from_gram_jnp, _mda_order, _pad_d
from repro.kernels.pairwise import gram as jax_gram
from repro.kernels.select import cge_select as jax_cge_select
from repro.kernels.select import iterative_order as jax_iterative_order
from repro.kernels.select import multi_krum_order as jax_multi_krum_order
from repro_torch import kernels
from repro_torch.core.aggregators import make_spec
from repro_torch.kernels.ops import mda_order
from repro_torch.kernels.select import gram_d2

torch.set_num_threads(2)
TOL = 3e-6
BF16_TOL = 2e-2
F = 2
RULES = {"cge": {}, "multi_krum": {"m": 3}, "m_krum": {"m": 3}, "mda": {},
         "bulyan": {}}


def stack(n, d, seed):
    return (np.random.default_rng(seed).normal(size=(n, d)) * 2.0).astype(
        np.float32)


def selections(rule, g, n, hyper):
    """(port's, JAX's) selection of ``rule`` on the stack: the keep-mask or
    the pick order, each from its own package's Gram."""
    gt = kernels.gram(torch.from_numpy(g))
    gp, _ = _pad_d(jnp.asarray(g))
    gj = jax_gram(gp, interpret=True)
    if rule == "cge":
        return (kernels.cge_select(gt, n - F).numpy(),
                np.asarray(jax_cge_select(gj, n - F, interpret=True)))
    if rule == "multi_krum":
        m = hyper["m"]
        return (kernels.multi_krum_order(gt, F, m).numpy(),
                np.asarray(jax_multi_krum_order(gj, F, m, interpret=True)))
    if rule == "mda":
        return (mda_order(gram_d2(gt), n, F).numpy(),
                np.asarray(_mda_order(_d2_from_gram_jnp(gj), n, F)))
    k = hyper["m"] if rule == "m_krum" else n - 2 * F
    return (kernels.iterative_order(gt, F, k).numpy(),
            np.asarray(jax_iterative_order(gj, F, k, interpret=True)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8, 11])
@pytest.mark.parametrize("rule", sorted(RULES))
def test_aggregate_flat_matches_jax(rule, n, dtype):
    hyper = RULES[rule]
    g32 = stack(n, 771, seed=20 + n)
    g = torch.from_numpy(g32).to(getattr(torch, dtype))
    gj = jnp.asarray(g.float().numpy()).astype(getattr(jnp, dtype))
    ours_sel, ref_sel = selections(rule, g.float().numpy(), n, hyper)
    np.testing.assert_array_equal(ours_sel, ref_sel)
    tol = TOL if dtype == "float32" else BF16_TOL
    for ours_impl, ref_impl in (("auto", "pallas"), ("gather", "gather")):
        spec = make_spec(rule, f=F, impl=ours_impl, n=n, **hyper)
        assert spec.impl == ("kernel" if ours_impl == "auto" else "gather")
        ours = spec.aggregate_flat(g).numpy()
        assert ours.dtype == np.float32
        ref = np.asarray(jax_make_spec(rule, f=F, impl=ref_impl, n=n,
                                       **hyper).aggregate(gj),
                         np.float32)
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol,
                                   err_msg=f"{ours_impl} vs {ref_impl}")
