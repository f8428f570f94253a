"""The survey's own experimental scale: a ~100M-parameter dense LM (the
surveyed papers evaluate on small models; this is a modern equivalent
decoder LM).  Same dimensions as ``repro.configs.paper_100m``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="paper-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    source="survey experimental scale",
)
