"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407]: dense GQA, 128k ctx.
40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072, head_dim=128."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
    )
