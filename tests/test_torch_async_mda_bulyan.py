"""The async slice for the selection family, part 2: mda at n = 8 (quorum
6) and bulyan at n = 11, f = 2 (theta 7, beta 3), the least n its
guarantee allows, under the same straggler profile with quorum 9: nine of
eleven rows arrive at every step, so no step is pure.

mda is held as test_torch_async_selection.py holds its rules.  Bulyan's
coordinate stage is discontinuous in the gradients (ROADMAP.md P8): about
an ulp between the two frameworks' per-agent gradients flips a few
coordinates of the aggregate (6 of 1,443,072 in the first step), and on a
free run each flip moves the later steps apart (the losses part by 1.2e-4
after 4 steps).  So each of its 4 steps starts from the JAX side's state
and is held there: the loss within 1e-5, the buffer within 1e-4, and the
aggregate and the parameters within 1e-4 on all but 1e-5 of the
coordinates (test_torch_helpers.check_async_resynced)."""
import repro_torch.simulator as TS
from test_torch_helpers import (check_async, check_async_resynced,
                                straggler_sim)


def test_async_step_matches_jax():
    check_async("mda", alpha=0.0)


def test_bulyan_async_step_matches_jax():
    tr = TS.plan_arrivals(straggler_sim(TS, quorum=9), 11, 4)
    assert tr.contrib.sum(1).tolist() == [9] * 4           # no step pure
    check_async_resynced("bulyan", n=11, quorum=9)
