"""Copied from ``repro.core.p2p.graph`` (numpy only, no JAX): host-side
graph tools on (n, n) bool adjacency, where ``adj[a, b]`` is the edge
a -> b.

Graph-theory utilities for the peer-to-peer architecture (survey §2.1,
§3.3.5): topology constructors, connectivity, source components, f-local
property, and (r, s)-robustness (Sundaram–Gharesifard / LeBlanc et al.)."""
from __future__ import annotations

import itertools

import numpy as np


# ---------------------------------------------------------------------------
# topologies (adjacency as (n, n) bool, no self loops)


def complete_graph(n: int):
    a = np.ones((n, n), bool)
    np.fill_diagonal(a, False)
    return a


def ring_graph(n: int, k: int = 1):
    """Each node connected to k neighbours on each side."""
    a = np.zeros((n, n), bool)
    for i in range(n):
        for j in range(1, k + 1):
            a[i, (i + j) % n] = a[i, (i - j) % n] = True
    return a


def torus_graph(rows: int, cols: int):
    n = rows * cols
    a = np.zeros((n, n), bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr, dc in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                j = ((r + dr) % rows) * cols + (c + dc) % cols
                a[i, j] = True
    np.fill_diagonal(a, False)
    return a


def erdos_renyi(n: int, p: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    a = rng.random((n, n)) < p
    a = a | a.T
    np.fill_diagonal(a, False)
    return a


# ---------------------------------------------------------------------------
# structural properties


def is_connected(adj) -> bool:
    adj = np.asarray(adj, bool)
    n = len(adj)
    seen = np.zeros(n, bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.flatnonzero(adj[i] | adj[:, i]):
            if not seen[j]:
                seen[j] = True
                stack.append(j)
    return bool(seen.all())


def remove_nodes(adj, nodes):
    keep = np.setdiff1d(np.arange(len(adj)), np.asarray(list(nodes)))
    return np.asarray(adj, bool)[np.ix_(keep, keep)], keep


def vertex_connectivity(adj, max_check: int = 200000) -> int:
    """Brute-force minimum vertex cut (small graphs: tests / examples)."""
    adj = np.asarray(adj, bool)
    n = len(adj)
    if not is_connected(adj):
        return 0
    for k in range(1, n - 1):
        combos = itertools.islice(
            itertools.combinations(range(n), k), max_check)
        for cut in combos:
            sub, _ = remove_nodes(adj, cut)
            if len(sub) and not is_connected(sub):
                return k
    return n - 1


def strongly_connected_components(adj):
    """Tarjan SCCs for directed adjacency."""
    adj = np.asarray(adj, bool)
    n = len(adj)
    index = [None] * n
    low = [0] * n
    onstack = [False] * n
    stack, out = [], []
    counter = [0]

    def strong(v):
        work = [(v, 0)]
        while work:
            node, pi = work[-1]
            if pi == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                onstack[node] = True
            recurse = False
            nbrs = np.flatnonzero(adj[node])
            for i in range(pi, len(nbrs)):
                w = nbrs[i]
                if index[w] is None:
                    work[-1] = (node, i + 1)
                    work.append((int(w), 0))
                    recurse = True
                    break
                elif onstack[w]:
                    low[node] = min(low[node], index[w])
            if recurse:
                continue
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    onstack[w] = False
                    comp.append(w)
                    if w == node:
                        break
                out.append(sorted(comp))
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in range(n):
        if index[v] is None:
            strong(v)
    return out


def source_component(adj):
    """The SCC with no incoming edges from outside, if it can reach all
    others (survey: non-empty source component condition, Su–Vaidya [103]).
    Returns the node list or None."""
    adj = np.asarray(adj, bool)
    sccs = strongly_connected_components(adj)
    for comp in sccs:
        comp_set = set(comp)
        incoming = any(adj[j, i] for i in comp for j in range(len(adj))
                       if j not in comp_set)
        if incoming:
            continue
        # must reach every node
        seen = set(comp)
        stack = list(comp)
        while stack:
            i = stack.pop()
            for j in np.flatnonzero(adj[i]):
                if j not in seen:
                    seen.add(int(j))
                    stack.append(int(j))
        if len(seen) == len(adj):
            return comp
    return None


def is_f_local(adj, byz, f: int) -> bool:
    """Each non-faulty node has at most f Byzantine in-neighbours."""
    adj = np.asarray(adj, bool)
    byz = set(int(b) for b in byz)
    for i in range(len(adj)):
        if i in byz:
            continue
        if sum(1 for j in np.flatnonzero(adj[:, i]) if int(j) in byz) > f:
            return False
    return True


def is_r_s_robust(adj, r: int, s: int, max_check: int = 100000) -> bool:
    """(r, s)-robustness (LeBlanc et al. [63]): for every pair of disjoint
    nonempty subsets, at least one of: |X_A^r| = |A|, |X_B^r| = |B|, or
    |X_A^r| + |X_B^r| >= s — where X_S^r are nodes in S with >= r
    in-neighbours outside S.  Exponential brute force: small graphs only."""
    adj = np.asarray(adj, bool)
    n = len(adj)
    nodes = range(n)
    checked = 0
    for size_a in range(1, n):
        for A in itertools.combinations(nodes, size_a):
            rest = [v for v in nodes if v not in A]
            for size_b in range(1, len(rest) + 1):
                for B in itertools.combinations(rest, size_b):
                    checked += 1
                    if checked > max_check:
                        raise ValueError("graph too large for brute force")
                    xa = sum(1 for i in A
                             if np.sum(adj[:, i]) - sum(adj[j, i] for j in A)
                             >= r)
                    xb = sum(1 for i in B
                             if np.sum(adj[:, i]) - sum(adj[j, i] for j in B)
                             >= r)
                    if not (xa == len(A) or xb == len(B) or xa + xb >= s):
                        return False
    return True


def metropolis_weights(adj):
    """Doubly-stochastic weight matrix W for DGD (eq. 14)."""
    adj = np.asarray(adj, bool)
    n = len(adj)
    deg = adj.sum(1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in np.flatnonzero(adj[i]):
            W[i, j] = 1.0 / (1 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W
