"""InternVL2-26B [arXiv:2404.16821]: InternViT frontend (STUB: precomputed
patch embeddings per the assignment) + InternLM2-20B language backbone.
48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92553."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b",
        family="vlm",
        n_layers=48,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab_size=92553,
        rope_theta=1_000_000.0,
        vis_tokens=1024,  # 448x448 InternViT with pixel shuffle -> 1024 tokens
    )
