"""Mamba2-130M  [arXiv:2405.21060]

24L d_model=768 attention-free SSD (state-space duality), ssm_state=128,
d_inner=1536, head_dim=64 (24 SSM heads), vocab=50280, tied embeddings.
Same dimensions as ``repro.configs.mamba2_130m``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
