"""InternLM2-20B  [arXiv:2403.17297]

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
Full attention.  Same dimensions as ``repro.configs.internlm2_20b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1000000.0,
    source="arXiv:2403.17297",
)
