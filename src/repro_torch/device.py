"""Device resolution for the port's entry points.

The entry points run on the card unless the caller asks for the CPU: a
missing ``device`` means ``cuda``, and asking for ``cuda`` on a host
without it raises instead of carrying on quietly on the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (the current card, with its index); raises when
    CUDA is asked for and missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this host; pass device='cpu' "
                "(or --device cpu) to run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_generator(seed: int, device) -> torch.Generator:
    """An explicit generator on ``device``, seeded."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))
