from repro_torch.core.filters.dense import FILTERS

__all__ = ["FILTERS"]
