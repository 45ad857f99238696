"""qwen1.5-4b [dense]: 40L d_model=2560 20H (kv=20) d_ff=6912
vocab=151936, QKV bias (hf:Qwen/Qwen1.5-4B).

The port's own copy of ``repro.configs.qwen1p5_4b``; a test holds the two
field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
        d_ff=6912, vocab_size=151936, qkv_bias=True,
        dtype="bfloat16", attn_impl="chunked")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke", family="dense",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256, qkv_bias=True, dtype="float32")
