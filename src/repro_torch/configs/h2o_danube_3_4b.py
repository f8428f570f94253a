"""H2O-Danube3-4B  [arXiv:2401.16818]

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000 — llama+mistral mix
with sliding-window attention (window 4096), so long_500k decode runs.
Same dimensions as ``repro.configs.h2o_danube_3_4b``.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    sliding_window=4096,
    source="arXiv:2401.16818",
)
