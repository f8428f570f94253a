from repro_torch.core.attacks.adaptive import (ADAPTIVE_ATTACKS,
                                               DefenseAwareAttack,
                                               calibrate_alie_z,
                                               is_adaptive_attack,
                                               make_adaptive_attack)
from repro_torch.core.attacks.gradient import (ATTACKS, get_attack,
                                               honest_moments,
                                               make_byzantine_mask)

__all__ = ["ATTACKS", "get_attack", "make_byzantine_mask", "honest_moments",
           "ADAPTIVE_ATTACKS", "DefenseAwareAttack", "make_adaptive_attack",
           "is_adaptive_attack", "calibrate_alie_z"]
