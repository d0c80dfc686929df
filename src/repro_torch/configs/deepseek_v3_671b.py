"""DeepSeek-V3-671B [arXiv:2412.19437]: MLA + MoE (1 shared + 256 routed,
top-8) + multi-token prediction. 61L d_model=7168 128H routed d_ff=2048
vocab=129280; first 3 layers dense (d_ff=18432)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=18432,  # dense layers (first_dense_layers) use this width
        vocab_size=129280,
        attn_kind="mla",
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=256,
        experts_per_token=8,
        n_shared_experts=1,
        moe_d_ff=2048,
        first_dense_layers=3,
        mtp=True,
        rope_theta=10_000.0,
    )
