from repro_torch.training.loop import train_loop
from repro_torch.training.step import ByzantineConfig, make_train_step

__all__ = ["ByzantineConfig", "make_train_step", "train_loop"]
