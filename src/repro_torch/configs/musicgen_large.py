"""musicgen-large [audio]: decoder-only over EnCodec tokens
(arXiv:2306.05284). 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048,
4 codebooks. The EnCodec frontend is a stub: a batch carries precomputed
frame embeddings (B, S, d_model).

The port's own copy of ``repro.configs.musicgen_large``; a test holds
the two field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=2048, num_codebooks=4,
        dtype="bfloat16", attn_impl="chunked")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=64, num_codebooks=4, dtype="float32")
