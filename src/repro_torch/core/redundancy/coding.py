"""Gradient coding / algorithmic redundancy (counterpart of
``repro.core.redundancy.coding``; survey §3.3.3).

Draco: in the parallel setting the server gives the SAME data shard to
the r agents of a group (a repetition code).  With at most (r - 1) // 2
Byzantine agents in a group, a vote within each group recovers the exact
gradient.  The vote is a distance-based plurality, safe in floating
point.

DETOX: (1) a Draco vote within groups of r, (2) the n / r voted gradients
averaged in buckets, (3) a robust filter over the bucket means.

Decode paths.  There is ONE copy of the vote law,
:func:`coded_vote_weights`: (n, n) Gram -> (n,) decode weights, one
winner per group.  :func:`flat_draco_aggregate` runs it over the (n, P)
arena on the port's kernels: the vote on K2 (``kernels.pairwise.gram``)
and the application on K7 (``kernels.wsum.masked_weighted_sum``), which
reads only rows of weight > 0, so a rejected Byzantine row holding +-inf
or NaN cannot leak 0 * inf = NaN into the decode.  On a CPU tensor each
kernel wrapper runs its plain version.  The vote itself is (n, n) work
(sort, argmax, where) on the Gram's device, with no host sync; the group
table is host numpy, folded in as constants.
:func:`tree_draco_aggregate` ravels a uniform-dtype tree into that arena
path (the tree entry point IS the arena path); a mixed-dtype tree sums
the per-dtype segment Grams into one Gram, votes once and applies the
weights per segment.

Roster-aware grouping.  :func:`coding_groups` is the lru-cached per-(n,
r) group table.  Under elastic membership the loops build it per bucket
capacity when the bucket's step is built, grouping the packed LIVE rows
by position; in the parallel regime every agent computes the same shard,
so regrouping the live agents keeps exact recovery.  A bucket capacity
that r does not divide keeps a smaller trailing group; the static entry
points require n % r == 0 and raise :class:`ValueError` otherwise.

Vote tolerance.  Two rows agree when d2 <= tol * scale_g, scale_g the
lower-median delivered squared row norm of the group.  With a delivered
honest majority in the group that is an honest row's norm, so one
large-value Byzantine row cannot inflate the tolerance (a global max(sq)
scale could, and made the tie-break steerable).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.filters import dense as D


@functools.lru_cache(maxsize=None)
def coding_groups(n: int, r: int, allow_ragged: bool = False):
    """The static per-(n, r) group-id table, read-only: slot i belongs to
    group ``i // r``.  ``allow_ragged`` (elastic buckets only): a capacity
    that r does not divide keeps a smaller trailing group instead of
    raising."""
    if r <= 0:
        raise ValueError(
            f"gradient coding needs a positive repetition group size: "
            f"got r={r} (n={n})")
    if not allow_ragged and n % r:
        raise ValueError(
            f"draco repetition code needs the group size to divide the "
            f"agent count: got n={n}, r={r} (n % r == {n % r})")
    groups = np.arange(n, dtype=np.int64) // r
    groups.setflags(write=False)
    return groups


@functools.lru_cache(maxsize=None)
def _vote_tables(groups: tuple, device):
    """The group table's (k, n) one-hot, (n, n) same-group mask and (n,)
    group ids on ``device``, built once per (table, device): the vote then
    copies nothing from the host per step."""
    g = np.asarray(groups)
    k = int(g.max()) + 1
    return (torch.as_tensor(g[None, :] == np.arange(k)[:, None],
                            device=device),
            torch.as_tensor(g[:, None] == g[None, :], device=device),
            torch.as_tensor(g, device=device))


def draco_assignment(n: int, r: int):
    """Fractional repetition assignment, group g = agents [g r, (g + 1) r):
    (number of groups, the (n,) group-of-agent table as a tensor).  Raises
    :class:`ValueError` unless r divides n."""
    return n // r, torch.from_numpy(np.array(coding_groups(n, r)))


def majority_vote(g, tol: float = 1e-6):
    """The plurality row of g: (r, d) -> (d,).  Each row counts the rows
    within ``tol`` of the MEDIAN squared row norm; the row with the most
    wins (the first on a tie)."""
    d2 = D.pairwise_sq_dists(g)
    sq = torch.sum(torch.square(g), dim=-1)
    scale = torch.clamp_min(D.coordinate_median(sq[:, None])[0], 1e-30)
    votes = torch.sum(d2 <= tol * scale, dim=-1)
    return g[torch.argmax(votes)]


def coded_vote_weights(gram, r: int, tol: float = 1e-6, mask=None,
                       groups=None):
    """THE vote law: (n, n) fp32 Gram -> (n,) fp32 decode weights, 1 / (the
    number of surviving groups) on each surviving group's winner, 0
    elsewhere (non-negative, as K7 requires).

    ``mask`` (n,) bool restricts the vote to DELIVERED rows: an absent row
    neither votes nor wins, a group with no delivery gets weight 0, and
    the average is over the surviving groups.  ``groups`` is a host
    (numpy) table from :func:`coding_groups` (``i // r`` when None).

    Agreement is per group: d2 <= tol * (the lower median of the group's
    delivered squared norms).  The winner of a group is its first slot
    with the most votes."""
    n = gram.shape[0]
    dev = gram.device
    if groups is None:
        groups = coding_groups(n, r)
    onehot, same, gidx = _vote_tables(tuple(int(i) for i in groups), dev)

    sq = torch.diagonal(gram)
    d2 = torch.clamp_min(sq[:, None] + sq[None, :] - 2.0 * gram, 0.0)
    m = (torch.ones((n,), dtype=torch.bool, device=dev) if mask is None
         else mask.to(device=dev, dtype=torch.bool))
    in_group = onehot & m[None, :]
    cnt = torch.sum(in_group, dim=-1)                          # (k,)
    # the per-group lower median of the delivered squared norms: with at
    # most (cnt - 1) // 2 Byzantine rows delivered in a group, the value
    # at sorted index (cnt - 1) // 2 is an honest row's norm
    inf = torch.full((), float("inf"), device=dev)
    sq_rows = torch.where(in_group, sq[None, :], inf)
    mid = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, n - 1)
    med = torch.sort(sq_rows, dim=-1).values.gather(1, mid[:, None])[:, 0]
    zero = torch.zeros((), device=dev)
    scale = torch.clamp_min(torch.where(cnt > 0, med, zero), 1e-30)

    agree = (d2 <= tol * scale[gidx][:, None]) & same
    votes = torch.where(m, torch.sum(agree & m[None, :], dim=-1),
                        torch.full((), -1, dtype=torch.int64, device=dev))
    # the winner of each group: its first slot with the most votes (-2
    # outside the group; a delivered row always agrees with itself, so it
    # outranks the -1 of an absent row)
    outside = torch.full((), -2, dtype=torch.int64, device=dev)
    win = torch.argmax(torch.where(onehot, votes[None, :], outside), dim=-1)
    group_ok = cnt > 0
    group_w = group_ok.float() / torch.clamp_min(torch.sum(group_ok), 1)
    return torch.zeros((n,), dtype=torch.float32, device=dev).scatter(
        0, win, group_w)


def flat_draco_aggregate(x, r: int, tol: float = 1e-6, mask=None,
                         groups=None):
    """The Draco decode of the (n, P) arena (fp32 or bf16) -> (P,) fp32:
    the vote on K2's Gram, the winners applied by K7 with the decode
    weights, the mask and a zero mean in the arena's dtype (every winner
    is a delivered row, so the mean is never read)."""
    from repro_torch.kernels.pairwise import gram
    from repro_torch.kernels.wsum import masked_weighted_sum
    n, p = x.shape
    if groups is None:
        groups = coding_groups(n, r)
    w = coded_vote_weights(gram(x), r, tol=tol, mask=mask, groups=groups)
    m = (torch.ones((n,), dtype=torch.float32, device=x.device)
         if mask is None else mask.to(device=x.device,
                                      dtype=torch.float32))
    return masked_weighted_sum(w, x, m, torch.zeros((p,), dtype=x.dtype,
                                                    device=x.device))


def draco_aggregate(g, r: int, tol: float = 1e-6):
    """g: (n, d), groups of r computing identical tasks -> the mean over
    the groups of each group's majority row, in g's dtype: exact when no
    group holds more than (r - 1) // 2 Byzantine rows."""
    draco_assignment(g.shape[0], r)               # validates n % r == 0
    return flat_draco_aggregate(g, r, tol=tol).to(g.dtype)


def detox_aggregate(g, r: int, f: int = 0, buckets: int = 0,
                    filter_name: str = "geometric_median",
                    tol: float = 1e-6):
    """DETOX: vote -> bucket means -> a robust filter.

    The bucket stage tolerates f vote-overwhelmed groups only if the
    filter sees a strict honest majority of bucket means, b >= 2f + 1
    buckets after the divisibility shrink; otherwise it would silently
    degrade (b = 1 is a plain average), so this raises."""
    n, d = g.shape
    k, _ = draco_assignment(n, r)
    voted = torch.stack([majority_vote(grp, tol)
                         for grp in g.reshape(k, r, d)])
    b = buckets if buckets else max(1, k // max(2 * f + 1, 1))
    while k % b:
        b -= 1
    if b < 2 * f + 1:
        raise ValueError(
            f"detox: k={k} voted gradients (n={n}, r={r}) admit only "
            f"b={b} equal buckets — cannot hold 2f+1={2 * f + 1} bucket "
            f"means for f={f}; pick n/r with more groups or a lower f")
    means = torch.mean(voted.reshape(b, k // b, d), dim=1)
    return D.FILTERS[filter_name](means, min(f, max((b - 1) // 2, 0)))


def tree_draco_aggregate(grads, r: int, tol: float = 1e-6, mask=None,
                         groups=None):
    """Draco on a tree of (n, ...) gradient leaves -> a single-agent tree.

    A uniform-dtype tree ravels into the (n, P) arena and decodes with
    :func:`flat_draco_aggregate` (the arena path, bit for bit).  A mixed-
    dtype tree splits into per-dtype sub-arenas: the Gram of a whole row
    is the sum of its column segments' Grams, so the segment Grams (K2
    each) sum into ONE Gram for ONE vote, and K7 applies the weights per
    segment; the split is announced once with the dtypes.

    ``mask`` (n,) bool restricts the vote to delivered rows (the async
    fallback); ``groups`` (a host table from :func:`coding_groups`)
    overrides ``i // r`` (an elastic bucket's, possibly ragged)."""
    from repro_torch.core.aggregators import warn_once
    from repro_torch.core.flat import FlatPlan, dtype_name
    from repro_torch.kernels.pairwise import gram
    from repro_torch.kernels.wsum import masked_weighted_sum
    from repro_torch.tree import tree_leaves, tree_unflatten
    plan = FlatPlan.for_tree(grads)
    leaves = tree_leaves(grads)
    n = leaves[0].shape[0]
    if groups is None:
        groups = coding_groups(n, r)
    if plan.uniform_dtype is not None:
        return plan.unravel(flat_draco_aggregate(
            plan.ravel(grads), r, tol=tol, mask=mask, groups=groups))
    by_dtype: dict = {}
    for i, leaf in enumerate(leaves):
        by_dtype.setdefault(leaf.dtype, []).append(i)
    names = ", ".join(sorted(dtype_name(dt) for dt in by_dtype))
    warn_once(
        ("draco-mixed-dtype", names),
        f"tree_draco_aggregate: mixed-dtype gradient tree ({names}) decodes "
        "through per-dtype sub-arenas instead of one flat arena; set a "
        "uniform exchange dtype (e.g. agg_dtype) to restore the single-"
        "ravel path")
    dev = leaves[0].device
    m = (torch.ones((n,), dtype=torch.float32, device=dev) if mask is None
         else mask.to(device=dev, dtype=torch.float32))
    segs = {dt: torch.cat([leaves[i].reshape(n, -1) for i in idxs], dim=1)
            for dt, idxs in by_dtype.items()}
    total = None
    for seg in segs.values():
        g = gram(seg)
        total = g if total is None else total + g
    w = coded_vote_weights(total, r, tol=tol, mask=mask, groups=groups)
    out = [None] * len(leaves)
    for dt, idxs in by_dtype.items():
        seg = segs[dt]
        vec = masked_weighted_sum(w, seg, m, torch.zeros(
            (seg.shape[1],), dtype=dt, device=dev))
        off = 0
        for i in idxs:
            size = leaves[i][0].numel()
            out[i] = vec[off:off + size].reshape(leaves[i].shape[1:]).to(dt)
            off += size
    return tree_unflatten(plan.paths, out)
