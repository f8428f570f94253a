"""Architecture configuration schema (the port's own copy of
``repro.configs.base``: the same fields, ``reduced()`` and ``num_params``,
so a config means the same model in both packages).

Every architecture gets one ``ArchConfig`` in
``repro_torch/configs/<id>.py``; ``reduced()`` derives the CPU smoke-test
variant of the same family (2 layers, d_model<=512, <=4 experts).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int                 # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    ssm_conv: int = 4
    # --- hybrid (Zamba2-style: shared attention every k SSM blocks) ---
    hybrid_attn_every: int = 0     # 0 -> not hybrid
    # --- attention flavour ---
    sliding_window: int = 0        # 0 -> full causal attention
    rope_theta: float = 10000.0
    positional: str = "rope"       # rope | mrope | sinusoid | none
    mrope_sections: tuple = (16, 24, 24)   # t/h/w splits of head_dim//2
    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0           # frames after the (stubbed) conv frontend
    # --- modality frontend stub ---
    frontend: str = "none"         # none | audio | vision
    frontend_tokens: int = 0       # patches/frames prepended for vlm
    # --- misc ---
    norm: str = "rms"              # rms | layer
    act: str = "silu"              # silu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context (O(window) or O(state))?"""
        return (
            self.family in ("ssm", "hybrid")
            or self.sliding_window > 0
        )

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    # ------------------------------------------------------------------
    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: tiny but structurally equal."""
        d_model = min(self.d_model, 256)
        heads = min(self.num_heads, 4) if self.num_heads else 0
        kv = min(self.num_kv_heads, max(1, heads // 2)) if heads else 0
        kw = dict(
            name=self.name + "-smoke",
            num_layers=2,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=(64 if heads else 0),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
        )
        if self.num_experts:
            kw.update(
                num_experts=min(self.num_experts, 4),
                experts_per_token=min(self.experts_per_token, 2),
            )
        if self.ssm_state:
            kw.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=32,
                      ssm_chunk=32)
        if self.hybrid_attn_every:
            kw.update(hybrid_attn_every=1, num_layers=2)
        if self.positional == "mrope":
            # sections must sum to head_dim/2 of the reduced head size
            kw.update(mrope_sections=(8, 12, 12))
        if self.encoder_layers:
            kw.update(encoder_layers=2, encoder_seq=min(self.encoder_seq, 64))
        if self.frontend_tokens:
            kw.update(frontend_tokens=min(self.frontend_tokens, 16))
        return self.replace(**kw)


def num_params(cfg: ArchConfig) -> int:
    """Closed-form parameter count (embedding + blocks + head)."""
    D, F, V, L = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.num_layers
    hd = cfg.resolved_head_dim
    total = V * D                                  # embed
    if not cfg.tie_embeddings:
        total += V * D                             # lm head
    total += D                                     # final norm

    def attn_params() -> int:
        q = D * cfg.num_heads * hd
        kv = 2 * D * cfg.num_kv_heads * hd
        o = cfg.num_heads * hd * D
        return q + kv + o

    def mlp_params() -> int:
        return 3 * D * F if cfg.act == "silu" else 2 * D * F

    def moe_params() -> int:
        p = D * cfg.num_experts + cfg.num_experts * 3 * D * F
        if cfg.shared_expert:
            p += 3 * D * F
        return p

    def ssm_params() -> int:
        di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
        h = cfg.ssm_num_heads
        in_proj = D * (2 * di + 2 * g * n + h)
        conv = cfg.ssm_conv * (di + 2 * g * n)
        extra = 3 * h          # A_log, dt_bias, D skip (per head)
        out = di * D
        return in_proj + conv + extra + out + di   # + gated norm scale

    if cfg.family == "ssm":
        total += L * (ssm_params() + D)
    elif cfg.family == "hybrid":
        total += L * (ssm_params() + D)
        total += attn_params() + mlp_params() + 2 * D   # one shared block
    elif cfg.family == "moe":
        total += L * (attn_params() + moe_params() + 2 * D)
    else:
        total += L * (attn_params() + mlp_params() + 2 * D)
        if cfg.is_encdec:
            E = cfg.encoder_layers
            total += E * (attn_params() + mlp_params() + 2 * D)
            # decoder cross-attention
            total += L * (attn_params() + D)
    return total


def active_params(cfg: ArchConfig) -> int:
    """Active parameters per token (MoE: only routed experts count)."""
    if not cfg.num_experts:
        return num_params(cfg)
    D, F, L = cfg.d_model, cfg.d_ff, cfg.num_layers
    dense_experts = cfg.num_experts - cfg.experts_per_token
    inactive = L * dense_experts * 3 * D * F
    return num_params(cfg) - inactive
