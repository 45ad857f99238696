"""zamba2-1.2b [hybrid]: Mamba2 backbone + shared attention block
(arXiv:2411.15242). 38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Simplification: ONE shared attention+MLP block applied
every 6th layer (the real model alternates two shared blocks).

The port's own copy of ``repro.configs.zamba2_1p2b``; a test holds the
two field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32000,
        ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        shared_attn_every=6, dtype="bfloat16", attn_impl="chunked")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=256,
        ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_ngroups=1,
        shared_attn_every=2, dtype="float32")
