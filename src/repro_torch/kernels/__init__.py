"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of
the JAX package on the port's path, each beside its plain PyTorch version.

Every wrapper runs its plain version for a CPU tensor and launches its
kernel (or raises) for a CUDA tensor, and counts its launches in
``<wrapper>.launches``; :func:`launch_counts` reads them all and
:func:`reset_launch_counts` sets them to 0."""
from repro_torch.kernels.coord_stats import coord_sort, coord_stat
from repro_torch.kernels.dispatch import (KERNEL_MASKED_RULES, KERNEL_RULES,
                                          KERNEL_SCALED_MASKED_RULES,
                                          KERNEL_SCALED_RULES,
                                          kernel_aggregate,
                                          kernel_masked_aggregate,
                                          kernel_masked_supported,
                                          kernel_scaled_aggregate,
                                          kernel_scaled_masked_aggregate,
                                          kernel_scaled_supported,
                                          kernel_supported)
from repro_torch.kernels.masked import (masked_coord_stat, masked_sign_vote,
                                        scaled_coord_stat,
                                        scaled_masked_coord_stat,
                                        scaled_masked_sign_vote, sign_vote)
from repro_torch.kernels.ops import (kernel_bulyan, kernel_bulyan_masked,
                                     kernel_cge, kernel_cge_masked,
                                     kernel_coordinate_median, kernel_krum,
                                     kernel_krum_masked, kernel_m_krum,
                                     kernel_m_krum_masked, kernel_mda,
                                     kernel_mda_masked, kernel_multi_krum,
                                     kernel_multi_krum_masked,
                                     kernel_pairwise_sq_dists,
                                     kernel_trimmed_mean)
from repro_torch.kernels.pairwise import gram, imputed_mean, masked_gram
from repro_torch.kernels.select import (bulyan_coord, cge_select,
                                        iterative_order, krum_select,
                                        masked_bulyan_coord,
                                        multi_krum_order)
from repro_torch.kernels.wsum import (clipped_weighted_sum,
                                      masked_ordered_apply,
                                      masked_weighted_sum, ordered_apply,
                                      scaled_sparse_masked_weighted_mean,
                                      sparse_masked_weighted_mean,
                                      weighted_sum)

WRAPPERS = {"coord_stat": coord_stat, "gram": gram,
            "krum_select": krum_select, "weighted_sum": weighted_sum,
            "masked_coord_stat": masked_coord_stat,
            "masked_gram": masked_gram,
            "masked_weighted_sum": masked_weighted_sum,
            "cge_select": cge_select, "multi_krum_order": multi_krum_order,
            "iterative_order": iterative_order,
            "ordered_apply": ordered_apply,
            "masked_ordered_apply": masked_ordered_apply,
            "bulyan_coord": bulyan_coord,
            "masked_bulyan_coord": masked_bulyan_coord,
            "sign_vote": sign_vote, "masked_sign_vote": masked_sign_vote,
            "scaled_coord_stat": scaled_coord_stat,
            "scaled_masked_coord_stat": scaled_masked_coord_stat,
            "scaled_masked_sign_vote": scaled_masked_sign_vote,
            "sparse_masked_weighted_mean": sparse_masked_weighted_mean,
            "scaled_sparse_masked_weighted_mean":
                scaled_sparse_masked_weighted_mean,
            "coord_sort": coord_sort,
            "clipped_weighted_sum": clipped_weighted_sum}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts():
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = [*WRAPPERS, "imputed_mean", "kernel_krum", "kernel_krum_masked",
           "kernel_cge", "kernel_cge_masked", "kernel_multi_krum",
           "kernel_multi_krum_masked", "kernel_m_krum",
           "kernel_m_krum_masked", "kernel_mda", "kernel_mda_masked",
           "kernel_bulyan", "kernel_bulyan_masked",
           "kernel_coordinate_median", "kernel_trimmed_mean",
           "kernel_pairwise_sq_dists", "KERNEL_RULES",
           "KERNEL_MASKED_RULES", "KERNEL_SCALED_RULES",
           "KERNEL_SCALED_MASKED_RULES", "kernel_aggregate",
           "kernel_masked_aggregate", "kernel_masked_supported",
           "kernel_scaled_aggregate", "kernel_scaled_masked_aggregate",
           "kernel_scaled_supported", "kernel_supported", "WRAPPERS",
           "launch_counts",
           "reset_launch_counts"]
