"""Peer-to-peer (decentralized) fault-tolerant DGD and its graph tools
(counterpart of ``repro.core.p2p``; survey §2.1, §3.3.5, §4.1)."""
from repro_torch.core.p2p.dgd import (COMBINE, data_injection_attack,
                                      detect_injection, p2p_dgd_run)
from repro_torch.core.p2p.graph import (complete_graph, erdos_renyi,
                                        is_connected, is_f_local,
                                        is_r_s_robust, metropolis_weights,
                                        ring_graph, source_component,
                                        torus_graph, vertex_connectivity)

__all__ = [
    "COMBINE", "p2p_dgd_run", "data_injection_attack", "detect_injection",
    "complete_graph", "ring_graph", "torus_graph", "erdos_renyi",
    "is_connected", "vertex_connectivity", "source_component", "is_f_local",
    "is_r_s_robust", "metropolis_weights",
]
