"""Hymba-1.5B [arXiv:2411.13676]: hybrid — parallel attention + Mamba heads
in every layer; sliding-window attention except 3 global layers (first,
middle, last). 32L d_model=1600 25H (kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Meta tokens are omitted (DESIGN.md §5)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_expand=2,
        swa_window=1024,
        n_global_layers=3,
        rope_theta=10_000.0,
    )
