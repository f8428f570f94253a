from repro_torch.core.redundancy.coding import (coded_vote_weights,
                                                coding_groups,
                                                detox_aggregate,
                                                draco_aggregate,
                                                draco_assignment,
                                                flat_draco_aggregate,
                                                tree_draco_aggregate)
from repro_torch.core.redundancy.properties import (check_2f_eps_redundancy,
                                                    check_2f_redundancy,
                                                    hausdorff_distance,
                                                    quadratic_argmin)
from repro_torch.core.redundancy.reactive import (ReactiveState,
                                                  init_reactive,
                                                  reactive_step)

__all__ = [
    "coding_groups", "coded_vote_weights", "draco_assignment",
    "draco_aggregate", "detox_aggregate", "flat_draco_aggregate",
    "tree_draco_aggregate",
    "check_2f_redundancy", "check_2f_eps_redundancy", "hausdorff_distance",
    "quadratic_argmin", "ReactiveState", "init_reactive", "reactive_step",
]
