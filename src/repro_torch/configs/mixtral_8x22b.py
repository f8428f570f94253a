"""Mixtral-8x22B  [arXiv:2401.04088]

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 — 8 experts top-2,
sliding-window attention (4096), so long_500k decode runs.
Same dimensions as ``repro.configs.mixtral_8x22b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    num_experts=8,
    experts_per_token=2,
    sliding_window=4096,
    source="arXiv:2401.04088",
)
