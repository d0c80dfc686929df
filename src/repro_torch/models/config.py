"""Model configuration covering all assigned architecture families.

One dataclass parameterizes dense GQA transformers, MLA attention, MoE,
RWKV6, Mamba-hybrid, encoder-decoder, and VLM-backbone variants. Every
assigned arch gets its exact config in configs/<id>.py.

Copy of ``repro.models.config``, which it is held against; the port imports nothing of
``repro``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

AttnKind = Literal["gqa", "mla", "none"]
Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int | None = None  # defaults to d_model // n_heads
    attn_kind: AttnKind = "gqa"
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    vocab_pad_multiple: int = 256  # Megatron-style padding for TP divisibility

    # -- MLA (multi-head latent attention) ------------------------------------
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE -------------------------------------------------------------------
    n_experts: int = 0
    experts_per_token: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # deepseek-v3: leading dense layers
    capacity_factor: float = 1.25

    # -- multi-token prediction (deepseek-v3) -----------------------------------
    mtp: bool = False
    mtp_loss_weight: float = 0.3

    # -- SSM / RWKV --------------------------------------------------------------
    ssm_state: int = 0  # mamba state size N
    rwkv_head_size: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    chunk_len: int = 32  # chunked linear-attention block length

    # -- hybrid (hymba) -----------------------------------------------------------
    swa_window: int = 0  # sliding-window size for SWA layers (0 = full attn)
    n_global_layers: int = 0  # layers with full attention: first/middle/last

    # -- encoder-decoder -------------------------------------------------------
    enc_layers: int = 0  # encoder depth (decoder depth = n_layers)

    # -- VLM stub ----------------------------------------------------------------
    vis_tokens: int = 0  # prepended precomputed patch-embedding tokens

    # -- dtypes -------------------------------------------------------------------
    dtype: str = "bfloat16"  # activation/compute dtype
    param_dtype: str = "float32"  # master weights

    # -- memory levers ------------------------------------------------------------
    loss_chunk: int = 0  # >0: compute CE over seq chunks (logits never full)
    attn_q_chunk: int = 0  # >0: query-chunked (flash-style) attention
    attn_qk_bf16: bool = False  # bf16 attention operands, f32 accumulation

    # -- derived -------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attn_kind == "none" and self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM state or bounded attention windows."""
        return self.family in ("ssm", "hybrid")

    def global_layer_ids(self) -> tuple[int, ...]:
        if self.n_global_layers <= 0:
            return ()
        if self.n_global_layers == 1:
            return (0,)
        span = self.n_layers - 1
        return tuple(
            round(i * span / (self.n_global_layers - 1))
            for i in range(self.n_global_layers)
        )

    def n_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS and reporting)."""
        d, v = self.d_model, self.padded_vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = self._layer_params()
        total = emb + self.n_layers * per_layer + d  # + final norm
        if self.enc_layers:
            total += self.enc_layers * self._enc_layer_params()
        if self.mtp:
            total += self._layer_params() + 2 * d * d
        return int(total)

    def n_active_params(self) -> int:
        """Activated parameters per token (MoE discounts inactive experts)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        expert = 3 * d * self.moe_d_ff
        inactive = (self.n_experts - self.experts_per_token) * expert
        moe_layers = self.n_layers - self.first_dense_layers
        return int(self.n_params() - moe_layers * inactive)

    def _attn_params(self) -> int:
        d = self.d_model
        if self.attn_kind == "mla":
            q = (
                d * self.q_lora_rank
                + self.q_lora_rank
                * self.n_heads
                * (self.qk_nope_head_dim + self.qk_rope_head_dim)
                if self.q_lora_rank
                else d * self.n_heads * (self.qk_nope_head_dim + self.qk_rope_head_dim)
            )
            kv = d * (self.kv_lora_rank + self.qk_rope_head_dim)
            kv += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_head_dim + self.v_head_dim
            )
            o = self.n_heads * self.v_head_dim * d
            return q + kv + o
        if self.attn_kind == "none":
            return 0
        hd = self.hd
        return d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d

    def _layer_params(self) -> int:
        d = self.d_model
        if self.family == "ssm":  # rwkv6
            att = 5 * d * d // 16 + 4 * d * d  # loras + r/k/v/g/o projections
            ffn = 2 * d * self.d_ff + d * d
            return att + ffn + 4 * d
        mlp = 3 * d * self.d_ff
        if self.is_moe:
            expert = 3 * d * self.moe_d_ff
            mlp = self.n_experts * expert + self.n_shared_experts * expert
            mlp += d * self.n_experts  # router
        attn = self._attn_params()
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            attn += 2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state + 2)
        return attn + mlp + 2 * d

    def _enc_layer_params(self) -> int:
        d = self.d_model
        return self._attn_params() + 3 * d * self.d_ff + 2 * d


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    changes: dict = dict(
        n_layers=min(cfg.n_layers, 3 if cfg.first_dense_layers else 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=96,
        vocab_size=503,
        vocab_pad_multiple=32,
    )
    if cfg.attn_kind == "mla":
        changes.update(
            q_lora_rank=32 if cfg.q_lora_rank else 0,
            kv_lora_rank=16,
            qk_nope_head_dim=16,
            qk_rope_head_dim=8,
            v_head_dim=16,
            head_dim=None,
        )
    if cfg.is_moe:
        changes.update(
            n_experts=8,
            experts_per_token=2,
            moe_d_ff=32,
            n_shared_experts=min(cfg.n_shared_experts, 1),
            first_dense_layers=1 if cfg.first_dense_layers else 0,
        )
    if cfg.family == "ssm":
        changes.update(rwkv_head_size=16, chunk_len=8, n_heads=4, head_dim=None)
    if cfg.family == "hybrid":
        changes.update(ssm_state=8, swa_window=16, n_global_layers=2, n_heads=5,
                       n_kv_heads=1, head_dim=16, d_model=80, ssm_expand=2)
    if cfg.enc_layers:
        changes.update(enc_layers=2)
    if cfg.vis_tokens:
        changes.update(vis_tokens=8)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
