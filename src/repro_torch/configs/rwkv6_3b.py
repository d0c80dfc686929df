"""RWKV6-3B (Finch) [arXiv:2404.05892]: attention-free, data-dependent decay.
32L d_model=2560 d_ff=8960 vocab=65536, head size 64."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="ssm",
        n_layers=32,
        d_model=2560,
        n_heads=40,  # d_model / rwkv_head_size
        n_kv_heads=40,
        d_ff=8960,
        vocab_size=65536,
        attn_kind="none",
        rwkv_head_size=64,
        chunk_len=32,
    )
