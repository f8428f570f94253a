from repro_torch.core.filters.dense import (FILTERS, compose, get_filter,
                                            krum_scores, pairwise_sq_dists)

__all__ = ["FILTERS", "get_filter", "compose", "pairwise_sq_dists",
           "krum_scores"]
