"""dbrx-132b [moe]: 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 fine-grained (hf:databricks/dbrx-base).

The port's own copy of ``repro.configs.dbrx_132b``; a test holds the two
field for field. Its int8 LUTs (~264 GB) need more than one card: at full
depth it can serve only tensor-parallel over several cards (four H100s at
least), with params held on the host and each rank's shard copied to its
card by ``Engine(mesh=)``. That run, on several cards, is still to
measure (ROADMAP.md queue A item 11)."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=10752, vocab_size=100352,
        num_experts=16, top_k=4, capacity_factor=1.25,
        dtype="bfloat16", attn_impl="chunked", tie_embeddings=False)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=96, vocab_size=256,
        num_experts=4, top_k=2, capacity_factor=2.0,
        dtype="float32", tie_embeddings=False)
