"""The peer-to-peer architecture against the JAX package: the graph tools,
one combine round per rule, whole DGD trajectories under a Byzantine
broadcaster and under a fault schedule, the data-injection attack and its
detection, and the stateful-spec refusal (n = 8, d = 16, 12 rounds, on
the CPU).

Bars.  ``TOL`` is ROADMAP.md's fp32 bar.  Where a combine sums estimates
(plain's ``W @ states``, lf's ``total - top_f - bottom_f``, ce's kept
rows), the absolute bar is ``TOL`` times the largest magnitude summed:
lf's subtraction cancels, and with a 50.0 broadcaster among values near 2
the two frameworks' sum orders differ by an ulp of the total (ROADMAP.md
P20).  Where the rule selects or votes (coordinate_median, krum,
sign_sgd) and in the frozen rows of a faulted round, the result is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.aggregators import make_spec as jax_make_spec
from repro.core.p2p import dgd as JD
from repro.core.p2p import graph as JG
from repro.simulator import faults as JF
from repro_torch.core.aggregators import make_spec
from repro_torch.core.p2p import dgd as TD
from repro_torch.core.p2p import graph as TG
from repro_torch.simulator import faults as TF

torch.set_num_threads(2)
TOL = 3e-6
N, D, STEPS, BIG = 8, 16, 12, 50.0
SPEC_RULES = ("trimmed_mean", "coordinate_median", "krum", "sign_sgd")
EXACT = ("coordinate_median", "krum", "sign_sgd")


def directed(cycle):
    a = np.zeros((N, N), bool)
    for i in range(N - 1):
        a[i, i + 1] = True
    a[N - 1, 0] = cycle
    return a


GRAPHS = {
    "complete": JG.complete_graph(N), "ring1": JG.ring_graph(N, 1),
    "ring2": JG.ring_graph(N, 2), "torus3x3": JG.torus_graph(3, 3),
    "er0": JG.erdos_renyi(N, 0.4, seed=0),
    "er1": JG.erdos_renyi(N, 0.4, seed=1),
    "chain": directed(False), "cycle": directed(True)}


@pytest.mark.parametrize("args", [("complete_graph", (N,)),
                                  ("ring_graph", (N, 1)),
                                  ("ring_graph", (N, 2)),
                                  ("torus_graph", (3, 3)),
                                  ("erdos_renyi", (N, 0.4, 0)),
                                  ("erdos_renyi", (N, 0.4, 1))])
def test_topologies_equal_jax(args):
    name, a = args
    ours, ref = getattr(TG, name)(*a), getattr(JG, name)(*a)
    assert ours.dtype == ref.dtype == bool
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_graph_properties_equal_jax(graph):
    adj = GRAPHS[graph]
    n = len(adj)
    assert TG.is_connected(adj) == JG.is_connected(adj)
    sub, keep = TG.remove_nodes(adj, (0, 3))
    jsub, jkeep = JG.remove_nodes(adj, (0, 3))
    np.testing.assert_array_equal(sub, jsub)
    np.testing.assert_array_equal(keep, jkeep)
    assert TG.vertex_connectivity(adj) == JG.vertex_connectivity(adj)
    assert (TG.strongly_connected_components(adj)
            == JG.strongly_connected_components(adj))
    assert TG.source_component(adj) == JG.source_component(adj)
    for byz, f in (({0, 1}, 1), ({0, 1}, 2), ({0, 2, 5}, 2)):
        assert TG.is_f_local(adj, byz, f) == JG.is_f_local(adj, byz, f)
    for r, s in ((1, 1), (2, 2)):
        # on the subgraph: the brute force is exponential in n
        assert (TG.is_r_s_robust(sub, r, s)
                == JG.is_r_s_robust(sub, r, s)), (r, s)
    for a in (adj, adj.T):
        W, jW = TG.metropolis_weights(a), JG.metropolis_weights(a)
        assert W.dtype == jW.dtype and W.shape == (n, n)
        np.testing.assert_array_equal(W, jW)


def isolated_ring():
    """ring(8, 2) with receiver 3 cut off (deg 0) and sender 5 silent."""
    a = JG.ring_graph(N, 2)
    a[3, :] = a[:, 3] = False
    a[5, :] = False
    return a


ROUND_GRAPHS = {"complete": JG.complete_graph(N), "ring2": JG.ring_graph(N, 2),
                "isolated": isolated_ring()}


def broadcast_states():
    """Honest estimates near 2, the two Byzantine rows at 50.0."""
    rng = np.random.default_rng(0)
    s = (2.0 + 0.2 * rng.standard_normal((N, D))).astype(np.float32)
    s[:2] = BIG
    return s


def combines(rule, f):
    """(jax combine, torch combine) of ``rule``."""
    if rule in JD.COMBINE:
        return JD.COMBINE[rule], TD.COMBINE[rule]
    return (JD.make_combine_spec(jax_make_spec(rule, f=f, n=N)),
            TD.make_combine_spec(make_spec(rule, f=f, n=N)))


def held(ours, ref, rule, mag):
    if rule in EXACT:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=TOL,
                                   atol=TOL * max(1.0, mag))


@pytest.mark.parametrize("graph", list(ROUND_GRAPHS))
@pytest.mark.parametrize("rule", ["plain", "lf", "ce", *SPEC_RULES])
def test_combine_round_matches_jax(rule, graph):
    """One combine of the 50.0-broadcast states at f = 2: on ring(8, 2)
    every receiver has deg = 4 = 2f (lf keeps its own estimate); in the
    isolated ring receiver 3 has deg 0 and its spec mask holds itself
    alone."""
    adj = ROUND_GRAPHS[graph]
    W = JG.metropolis_weights(adj)
    s = broadcast_states()
    jc, tc = combines(rule, 2)
    ref = np.asarray(jc(adj, W, jnp.asarray(s), 2))
    ours = tc(adj, W, torch.from_numpy(s.copy()), 2)
    assert ours.dtype == torch.float32 and ours.shape == (N, D)
    held(ours.numpy(), ref, rule, BIG)
    if rule == "lf" and graph != "complete":
        # degraded receivers keep their own estimate, bit for bit
        deg = adj.T.sum(1)
        np.testing.assert_array_equal(ours.numpy()[deg <= 4], s[deg <= 4])


def quad():
    rng = np.random.default_rng(1)
    targets = (0.2 * rng.standard_normal((N, D))).astype(np.float32)
    jt, tt = jnp.asarray(targets), torch.from_numpy(targets)
    x0 = np.full((N, D), 2.0, np.float32)
    return targets, (lambda i, x: x - jt[i]), (lambda i, x: x - tt[i]), x0


def runs(adj, rule, f, **kw):
    """(jax trajectory, torch trajectory) as numpy from one x0."""
    _, jgrad, tgrad, x0 = quad()
    jc = rule if rule in JD.COMBINE else jax_make_spec(rule, f=f, n=N)
    tc = rule if rule in TD.COMBINE else make_spec(rule, f=f, n=N)
    jkw = {k[2:]: v for k, v in kw.items() if k.startswith("j_")}
    tkw = {k[2:]: v for k, v in kw.items() if k.startswith("t_")}
    ref = np.asarray(JD.p2p_dgd_run(adj, jgrad, jnp.asarray(x0), STEPS, f=f,
                                    combine=jc, **jkw))
    ours = TD.p2p_dgd_run(adj, tgrad, x0, STEPS, f=f, combine=tc,
                          device="cpu", **tkw)
    assert ours.shape == (STEPS + 1, N, D) and ours.device.type == "cpu"
    return ref, ours.numpy()


@pytest.mark.parametrize("rule", ["plain", "lf", "ce", *SPEC_RULES])
def test_trajectory_under_broadcaster_matches_jax(rule):
    """Agents 0 and 1 broadcast 50.0 on the complete graph, f = 2."""
    byz = np.arange(N) < 2
    ref, ours = runs(JG.complete_graph(N), rule, 2,
                     j_byz_mask=jnp.asarray(byz),
                     j_byz_fn=lambda k, t, s: jnp.full_like(s, BIG),
                     t_byz_mask=byz,
                     t_byz_fn=lambda g, t, s: torch.full_like(s, BIG))
    held(ours, ref, rule, BIG)
    np.testing.assert_array_equal(ours[1:, :2], BIG)
    if rule in ("lf", "ce", "trimmed_mean", "krum"):
        # the robust combines keep the honest agents away from 50.0
        assert np.abs(ours[-1, 2:]).max() < 5.0


def schedule(M):
    """The JAX test's membership schedule, brought within 12 rounds, plus
    a partition, a permanent crash and a sender whose every broadcast is
    dropped."""
    return (M.Join(agents=(7,), at=2),
            M.Rejoin(agents=(6,), leave_at=3, rejoin_at=6),
            M.Churn(rate=0.3, mean_out=3.0, agents=(1, 2, 3)),
            M.Partition(groups=((0, 1, 2, 3), (4, 5, 6, 7)), start=4, end=7),
            M.PermanentCrash(agents=(5,), at=8),
            M.MessageDrop(p=1.0, agents=(4,)))


@pytest.mark.parametrize("rule", ["plain", "lf", "ce", *SPEC_RULES])
def test_trajectory_under_fault_schedule_matches_jax(rule):
    """ring(8, 2), f = 1, agent 0 broadcasting 50.0, the faulted graph
    rebuilt every round; an agent that is crashed or churned out keeps
    its row bit for bit through the round."""
    jtr = JF.compile_schedule(schedule(JF), N, STEPS + 1, seed=0)
    ttr = TF.compile_schedule(schedule(TF), N, STEPS + 1, seed=0)
    for what in ("alive", "drop", "adj", "roster"):
        np.testing.assert_array_equal(getattr(ttr, what), getattr(jtr, what))
    byz = np.arange(N) < 1
    ref, ours = runs(JG.ring_graph(N, 2), rule, 1, j_fault_schedule=jtr,
                     j_byz_mask=jnp.asarray(byz),
                     j_byz_fn=lambda k, t, s: jnp.full_like(s, BIG),
                     t_fault_schedule=ttr, t_byz_mask=byz,
                     t_byz_fn=lambda g, t, s: torch.full_like(s, BIG))
    held(ours, ref, rule, BIG)
    assert np.isfinite(ours).all()
    out = ~(ttr.alive & ttr.roster)
    frozen = [(t, i) for t in range(STEPS) for i in range(N)
              if out[min(t, ttr.horizon - 1), i]]
    assert len(frozen) >= STEPS, frozen
    for t, i in frozen:
        np.testing.assert_array_equal(ours[t + 1, i], ours[t, i])
        np.testing.assert_array_equal(ref[t + 1, i], ref[t, i])


def test_fault_schedule_specs_compile_here():
    """p2p_dgd_run compiles an iterable of specs with ``fault_seed``, as
    JAX's does."""
    _, _, tgrad, x0 = quad()
    ttr = TF.compile_schedule(schedule(TF), N, STEPS + 1, seed=3)
    a = TD.p2p_dgd_run(JG.ring_graph(N, 2), tgrad, x0, STEPS,
                       fault_schedule=schedule(TF), fault_seed=3,
                       device="cpu")
    b = TD.p2p_dgd_run(JG.ring_graph(N, 2), tgrad, x0, STEPS,
                       fault_schedule=ttr, device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_data_injection_matches_jax_and_is_detected():
    """Wu et al. [114]: agent 0 fakes convergence to 10; JAX's per-round
    draws (the run's key split once a round) are handed to the port by
    value.  Both packages' detection flags agent 0 at every honest
    receiver."""
    key = jax.random.PRNGKey(0)
    noise = []
    for _ in range(STEPS):
        key, sub = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(sub, (N, D))))
    target = np.full((D,), 10.0, np.float32)
    byz = np.arange(N) < 1
    adj = JG.complete_graph(N)
    ref, ours = runs(adj, "plain", 0, j_byz_mask=jnp.asarray(byz),
                     j_byz_fn=JD.data_injection_attack(jnp.asarray(target)),
                     j_key=jax.random.PRNGKey(0), t_byz_mask=byz,
                     t_byz_fn=TD.data_injection_attack(
                         target, noise=np.stack(noise)))
    held(ours, ref, "plain", np.abs(ref).max())
    scores = TD.detect_injection(torch.from_numpy(ours), adj)
    jscores = JD.detect_injection(ref, adj)
    np.testing.assert_allclose(scores, jscores, rtol=1e-5, atol=1e-5)
    for s in (scores, jscores):
        assert all(int(np.argmax(s[i])) == 0 for i in range(1, N))


def test_data_injection_draws_from_the_run_generator():
    _, _, tgrad, x0 = quad()
    byz = np.arange(N) < 1
    attack = TD.data_injection_attack(np.full((D,), 10.0, np.float32))
    a, b, c = (TD.p2p_dgd_run(JG.complete_graph(N), tgrad, x0, 3,
                              byz_mask=byz, byz_fn=attack, seed=s,
                              device="cpu").numpy() for s in (5, 5, 6))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("rule,hyper", [("zeno_pp", {}),
                                        ("centered_clip", {})])
def test_stateful_spec_is_refused_as_in_jax(rule, hyper):
    with pytest.raises(ValueError) as jerr:
        JD.make_combine_spec(jax_make_spec(rule, f=2, n=N, **hyper))
    with pytest.raises(ValueError) as terr:
        TD.make_combine_spec(make_spec(rule, f=2, n=N, **hyper))
    assert str(terr.value) == str(jerr.value)
