"""SeamlessM4T-medium [arXiv:2308.11596]: encoder-decoder, multimodal.
12L enc + 12L dec, d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.
The speech frontend is a STUB per the assignment: input_specs provides
precomputed frame embeddings."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium",
        family="encdec",
        n_layers=12,  # decoder depth
        enc_layers=12,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
