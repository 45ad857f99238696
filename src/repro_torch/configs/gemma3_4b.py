"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) head_dim=256
d_ff=10240 vocab=262144; 5:1 local (1024-window) : global layers
(hf:google/gemma-3-4b).

The port's own copy of ``repro.configs.gemma3_4b``; a test holds the two
field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b", family="dense",
        num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4,
        d_ff=10240, vocab_size=262144, head_dim=256,
        global_every=6, sliding_window=1024,
        rope_theta=1_000_000.0, dtype="bfloat16", attn_impl="chunked")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16,
        global_every=6, sliding_window=8, dtype="float32")
