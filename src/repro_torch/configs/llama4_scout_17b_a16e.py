"""Llama-4 Scout 17B-active / 16 experts  [hf:meta-llama/Llama-4-Scout-17B-16E]

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts top-1
with shared expert, early-fusion multimodal (text backbone here).  Chunked
local attention (8192) modeled as sliding-window, as
``repro.configs.llama4_scout_17b_a16e`` models it.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    num_experts=16,
    experts_per_token=1,
    shared_expert=True,
    sliding_window=8192,
    rope_theta=500000.0,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
