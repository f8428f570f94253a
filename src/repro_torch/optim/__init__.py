from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, sgd
from repro_torch.optim.schedules import constant, cosine_warmup, diminishing

__all__ = ["Optimizer", "sgd", "adamw", "apply_updates", "constant",
           "diminishing", "cosine_warmup"]
