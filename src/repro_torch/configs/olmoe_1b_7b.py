"""OLMoE-1B-7B [arXiv:2409.02060]: MoE, 64 experts top-8.
16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1024,
        vocab_size=50304,
        n_experts=64,
        experts_per_token=8,
        moe_d_ff=1024,
        rope_theta=10_000.0,
    )
