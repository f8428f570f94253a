"""The slice test for sign_sgd: the port's synchronous robust step (K15)
and its async step under stragglers (K16) against the JAX package's
``make_train_step`` / ``make_async_step`` (impl="pallas") on
paper-100m-smoke (fp32, n=8, f=2, sign_flip).

The majority vote is discontinuous in the gradients (ROADMAP.md P11): a
per-agent gradient coordinate that is a cancellation residue (|g| ~ 1e-9
where its neighbours are ~1e-3) takes its sign from the summation order,
which differs between XLA and PyTorch, and where the other votes tie it
moves the aggregate by 1.  That flips 2 of the 1,443,072 coordinates in
the first synchronous step and 4 in the first async step.  AdamW turns a
flip into a parameter step of about the learning rate, and the later
steps' gradients part further (136 flips in the second synchronous step,
2,523 in the third).  So the synchronous run is held as bulyan's is
(test_torch_slice_mda_bulyan.py): the loss at every step, the first step's
aggregate and parameters on all but 1e-5 of the coordinates; each async
step starts from the JAX side's state (check_async_resynced).  On the
same arena the two packages' votes are equal (test_torch_sign.py)."""
import numpy as np

from test_torch_helpers import (GRAD_TOL, LOGIT_TOL, check_async_resynced,
                                run_slice)


def test_sign_sgd_step_matches_jax():
    steps = run_slice("sign_sgd", 0.0)
    for step, (jl, tl, *_) in enumerate(steps):
        np.testing.assert_allclose(tl, jl, rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                   err_msg=f"sign_sgd step {step}")
    _, _, ja, ta, jpar, tpar = steps[0]
    for name, ours, ref in (("aggregate", ta, ja), ("params", tpar, jpar)):
        flipped = ~np.isclose(ours, ref, rtol=GRAD_TOL, atol=GRAD_TOL)
        assert flipped.sum() <= 1e-5 * ours.size, (name, int(flipped.sum()))


def test_sign_sgd_async_step_matches_jax():
    check_async_resynced("sign_sgd")
