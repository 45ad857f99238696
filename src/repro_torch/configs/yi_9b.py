"""yi-9b [dense]: llama-arch GQA (arXiv:2403.04652). 48L d_model=4096
32H (kv=4) d_ff=11008 vocab=64000, untied head.

The port's own copy of ``repro.configs.yi_9b``; a test holds the two field
for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b", family="dense",
        num_layers=48, d_model=4096, num_heads=32, num_kv_heads=4,
        d_ff=11008, vocab_size=64000,
        dtype="bfloat16", attn_impl="chunked", tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="yi-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=8, num_kv_heads=2,
        d_ff=128, vocab_size=256, dtype="float32", tie_embeddings=False)
