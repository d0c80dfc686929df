"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B]: dense, MLA attention.
62L d_model=2560 40H d_ff=6400 vocab=73448."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        d_ff=6400,
        vocab_size=73448,
        attn_kind="mla",
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
