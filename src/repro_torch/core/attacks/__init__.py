from repro_torch.core.attacks.gradient import (ATTACKS, get_attack,
                                               honest_moments,
                                               make_byzantine_mask)

__all__ = ["ATTACKS", "get_attack", "make_byzantine_mask", "honest_moments"]
