"""Phi-4-mini 3.8B  [arXiv:2412.08905]

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 — RoPE SwiGLU GQA.
Pure full attention.  Same dimensions as ``repro.configs.phi4_mini_3_8b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=200064,
    source="arXiv:2412.08905",
)
