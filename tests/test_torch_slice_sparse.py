"""The slice test for sparse_mean: the port's synchronous robust step (K17
with mask and weights all ones), its async step under stragglers (K17
with the raw staleness weights of the arrived rows) and its int8
compressed step (K21) against the JAX package's ``make_train_step`` /
``make_async_step`` (impl="pallas") on paper-100m-smoke (fp32, n = 8, f =
2, sign_flip; sparse_mean ignores f: it is an undefended mean over the
coordinates each agent sent).

The embedding rows a batch does not touch have an exact 0 gradient on
both sides, so they are "not sent" on both sides and the aggregate there
is an exact 0.  Elsewhere the law is a weighted mean, continuous in the
gradients: the synchronous run is held at the slice-1 bars over 3 steps
(loss 1e-5, aggregate and parameters 1e-4).  The async run starts each
step from the JAX side's state (``check_async_resynced``): a coordinate
that is an exact 0 on one side and a cancellation residue on the other
would change the sent set.  The int8 run is held as P14 holds the other
rules (``check_quantized``): the codes, the loss, and every aggregate
coordinate outside the bar one where a code moved.  A mean moves its
coordinate wherever a code moves (a median or a vote mostly does not):
in the first step the 21 moved codes (P14) move 16 of the 1,443,072
aggregate coordinates, by up to 1.5e-3 (8 of the codes move between 0
and +-1, which also changes who sent the coordinate), and no other
coordinate by more than 9e-8.  So the share of moved aggregate
coordinates is bounded by the moved codes' own bar, ``CODE_SHARE`` times
the n codes of a column, not by ``AGG_SHARE``."""
from test_torch_helpers import (CODE_SHARE, N, check_async_resynced,
                                check_quantized, check_slice)


def test_sparse_mean_step_matches_jax():
    check_slice("sparse_mean", 0.0)


def test_sparse_mean_async_step_matches_jax():
    check_async_resynced("sparse_mean")


def test_sparse_mean_int8_step_matches_jax():
    check_quantized("sparse_mean", "int8",
                    agg_share=CODE_SHARE["int8"] * N)
