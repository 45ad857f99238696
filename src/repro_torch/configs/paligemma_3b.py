"""paligemma-3b [vlm]: SigLIP + gemma (arXiv:2407.07726). LM backbone:
18L d_model=2048 8H (MQA kv=1) head_dim=256 d_ff=16384 vocab=257216. The
SigLIP frontend is a stub: a batch carries precomputed patch embeddings
(B, 256, d_model), which attend each other both ways (prefix-LM).

The port's own copy of ``repro.configs.paligemma_3b``; a test holds the
two field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-3b", family="vlm",
        num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
        d_ff=16384, vocab_size=257216, head_dim=256, num_patches=256,
        dtype="bfloat16", attn_impl="chunked")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="paligemma-smoke", family="vlm",
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=1,
        d_ff=128, vocab_size=512, head_dim=16, num_patches=16,
        dtype="float32")
