"""DeepSeek-67B [arXiv:2401.02954]: llama-arch dense GQA.
95L d_model=8192 64H (kv=8) d_ff=22016 vocab=102400."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        n_layers=95,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        rope_theta=10_000.0,
    )
