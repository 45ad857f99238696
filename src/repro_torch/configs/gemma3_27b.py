"""gemma3-27b [dense]: 62L d_model=5376 32H (GQA kv=16) head_dim=128
d_ff=21504 vocab=262144; 5:1 local (1024-window) : global layers, 128k
context (hf:google/gemma-3-*). head_dim=128 is the published value
(d_model / heads would be 168: gemma3 decouples the q width from
d_model).

The port's own copy of ``repro.configs.gemma3_27b``; a test holds the two
field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b", family="dense",
        num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
        d_ff=21504, vocab_size=262144, head_dim=128,
        global_every=6, sliding_window=1024,
        rope_theta=1_000_000.0, dtype="bfloat16", attn_impl="chunked")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", family="dense",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        global_every=3, sliding_window=8, dtype="float32")
