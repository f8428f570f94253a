"""Core: the survey's technique space as composable PyTorch modules
(counterpart of ``repro.core``).

- aggregators:  the unified AggregatorSpec API — typed, stateful,
                composable robust aggregation (registry + caps + engine)
- flat:         FlatPlan — the (n, P) arena ravel/unravel plan behind
                spec.aggregate_flat and the loops' flat pipeline
- filters:      dense reference implementations (Table 2) — the oracle
- attacks:      Byzantine behaviours (§3.1, §4.1)
- momentum:     worker momentum variance reduction (§3.3.4)
- redundancy:   gradient coding, Draco/DETOX/reactive, 2f-redundancy theory
- p2p:          decentralized (peer-to-peer) fault-tolerant DGD (§3.3.5)
- resilience:   (f,eps) / (alpha,f) / (delta_max,c) measurement (§3.5)
"""
