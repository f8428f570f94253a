"""Each CUDA kernel against its plain PyTorch version, on the card.

Marked ``cuda``: skipped where there is no NVIDIA GPU.  On the machine
with the card (no JAX needed):

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Bars: median values, Krum's one-hot and the one-hot weighted sum exact;
trimmed means, Grams and general weighted sums within rtol = atol = 3e-6.
"""
import math

import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.coord_stats import coord_stat_plain
from repro_torch.kernels.pairwise import gram_plain
from repro_torch.kernels.select import krum_select_plain
from repro_torch.kernels.wsum import weighted_sum_plain

TOL = 3e-6
F = 2
HAZARDS = [None, "nan", "inf", "ties", "spots"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def stack(n, d, seed, hazard, device, dtype):
    g = torch.randn((n, d), generator=torch.Generator().manual_seed(seed))
    g = g * 2.0
    if hazard == "nan":
        g[1] = math.nan
    elif hazard == "inf":
        g[1], g[4] = math.inf, -math.inf
    elif hazard == "ties":
        g[1] = g[0]
        g[2] = g[0]
        g[5] = torch.round(g[5])
    elif hazard == "spots":
        g[1, 7], g[3, 7], g[5, 11] = math.nan, math.inf, -math.inf
    return g.to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hazard", HAZARDS)
@pytest.mark.parametrize("n", [8, 9, 33])
def test_cuda_kernels_match_plain(cuda_device, n, hazard, dtype):
    d = 4099
    g = stack(n, d, 1, hazard, cuda_device, dtype)
    for stat, b in (("median", 0), ("trimmed_mean", 2)):
        ours, ref = kernels.coord_stat(g, stat, b), coord_stat_plain(g, stat,
                                                                      b)
        tol = 0 if stat == "median" else TOL
        torch.testing.assert_close(ours, ref, rtol=tol, atol=tol,
                                   equal_nan=True)
    gr = kernels.gram(g)
    if hazard in (None, "ties"):
        torch.testing.assert_close(gr, gram_plain(g), rtol=TOL, atol=TOL)
        assert torch.equal(gr, kernels.gram(g))       # repeats bit for bit
    w = kernels.krum_select(gr, F)
    assert torch.equal(w, krum_select_plain(gr, F))
    assert float(w.sum()) == 1.0
    torch.testing.assert_close(kernels.weighted_sum(w, g),
                               weighted_sum_plain(w, g), rtol=0, atol=0,
                               equal_nan=True)
    wg = torch.rand(n, generator=torch.Generator().manual_seed(2)).to(
        cuda_device)
    if hazard in (None, "ties"):
        torch.testing.assert_close(kernels.weighted_sum(wg, g),
                                   weighted_sum_plain(wg, g), rtol=TOL,
                                   atol=TOL)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_launch_counters_count_launches(cuda_device):
    kernels.reset_launch_counts()
    g = torch.randn(8, 1000, device=cuda_device)
    kernels.kernel_krum(g, F)
    kernels.coord_stat(g, "median")
    assert kernels.launch_counts() == {"coord_stat": 1, "gram": 1,
                                       "krum_select": 1, "weighted_sum": 1}
    coord_stat_plain(g, "median")                  # the plain version
    assert kernels.launch_counts()["coord_stat"] == 1


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_bad_input(cuda_device):
    g = torch.randn(8, 100, device=cuda_device)
    with pytest.raises(TypeError):
        kernels.coord_stat(g.half(), "median")
    with pytest.raises(ValueError):
        kernels.gram(g[:, ::2])               # strided rows
    with pytest.raises(ValueError):
        kernels.weighted_sum(torch.ones(8), g)          # w on the CPU
