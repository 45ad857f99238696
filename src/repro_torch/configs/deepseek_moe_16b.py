"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16) d_ff=1408
(fine-grained experts), 2 shared + 64 routed top-6 (arXiv:2401.06066).
Simplification: every layer is MoE (the real model's layer-0 dense FFN is
dropped).

The port's own copy of ``repro.configs.deepseek_moe_16b``; a test holds
the two field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe",
        num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1408, vocab_size=102400,
        num_experts=64, num_shared_experts=2, top_k=6, capacity_factor=1.25,
        dtype="bfloat16", attn_impl="chunked", tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=32, vocab_size=256,
        # cf=4 makes routing drop-free at smoke sizes (cap == T)
        num_experts=8, num_shared_experts=2, top_k=2, capacity_factor=4.0,
        dtype="float32", tie_embeddings=False)
