"""Zamba2-7B  [arXiv:2411.15242]

81 Mamba2 blocks (d_model=3584, ssm_state=64) + a SHARED full transformer
block (32H MHA kv=32, d_ff=14336) applied every 6 SSM blocks.  vocab=32000.
The shared attention uses a 4096 sliding window here so long_500k decode is
O(window), as ``repro.configs.zamba2_7b`` has it.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_every=6,
    sliding_window=4096,
    source="arXiv:2411.15242",
)
