"""Synthetic data pipeline with per-agent distributions (counterpart of
``repro.data.synthetic``).

The process is a learnable modular-arithmetic LM: within a sequence,
token_{k+1} = (token_k + step) mod V, with ``step`` fixed (iid/parallel) or
agent-specific (non-iid).  Once the (n, b) ``starts`` are fixed the law is
deterministic, so tests inject the JAX side's ``starts`` and compare
batches exactly; otherwise they are drawn from an explicit generator.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SyntheticLM:
    vocab_size: int
    seq_len: int
    n_agents: int
    per_agent_batch: int
    regime: str = "iid"              # iid | noniid | parallel
    base_step: int = 7

    def _steps(self, device):
        if self.regime == "noniid":
            return (self.base_step
                    + 2 * torch.arange(self.n_agents, device=device)
                    ) % self.vocab_size
        return torch.full((self.n_agents,), self.base_step, device=device,
                          dtype=torch.int64)

    def draw_starts(self, gen: torch.Generator):
        """(n, b) int64 first tokens, from ``gen`` (on ``gen.device``)."""
        n, b, V = self.n_agents, self.per_agent_batch, self.vocab_size
        rows = 1 if self.regime == "parallel" else n
        starts = torch.randint(0, V, (rows, b), generator=gen,
                               device=gen.device)
        return starts.expand(n, b)

    def batch(self, starts):
        """{"tokens": (n, b, T), "labels": (n, b, T)} int64 from (n, b)
        ``starts`` (a tensor, or an array-like of ints)."""
        if not isinstance(starts, torch.Tensor):
            starts = torch.from_numpy(np.array(starts, dtype=np.int64))
        starts = starts.long()
        T, V = self.seq_len, self.vocab_size
        steps = self._steps(starts.device)[:, None]           # (n, 1)
        ks = torch.arange(T + 1, device=starts.device)[None, None, :]
        seq = (starts[..., None] + ks * steps[..., None]) % V  # (n, b, T+1)
        return {"tokens": seq[..., :-1].contiguous(),
                "labels": seq[..., 1:].contiguous()}


def label_flip(batch, byz_mask, vocab_size: int):
    """Rotate the labels of Byzantine agents by V/2 (poisoning attack)."""
    flipped = (batch["labels"] + vocab_size // 2) % vocab_size
    mask = byz_mask.reshape((-1,) + (1,) * (batch["labels"].dim() - 1))
    return dict(batch, labels=torch.where(mask, flipped, batch["labels"]))
