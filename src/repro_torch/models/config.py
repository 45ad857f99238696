"""Model configuration: the port's own copy of ``repro.models.config``.

Kept field for field identical to the JAX package's ``ModelConfig`` (a
test holds the two against each other), so configurations carry over
unchanged. Only the dense family is served by this port so far.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default: d_model // num_heads
    qkv_bias: bool = False
    # attention pattern (gemma3): every `global_every`-th layer is global,
    # the rest use `sliding_window`. 0 = all layers global (full causal).
    global_every: int = 0
    sliding_window: int = 0

    # MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_conv: int = 4

    # hybrid (zamba2): one *shared* attention block applied every N layers
    shared_attn_every: int = 0

    # audio (musicgen): number of parallel codebook heads; inputs are
    # precomputed frame embeddings from the (stubbed) EnCodec frontend.
    num_codebooks: int = 0

    # vlm (paligemma): number of precomputed patch embeddings prepended to
    # the token sequence (SigLIP frontend is a stub).
    num_patches: int = 0

    norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    # "heads": classic (B,S,H,HD) layout, half-rotation RoPE.
    # "hd": head_dim-major (B,S,HD,H) layout + interleaved RoPE — head_dim
    #       TP-shards cleanly (projection columns are hd-major contiguous)
    #       and the interleaved rotation is local to any even-sized hd
    #       shard, eliminating resharding collectives (see EXPERIMENTS.md
    #       §Perf iteration I2).
    head_layout: str = "heads"
    dtype: str = "float32"           # params/activations dtype
    tie_embeddings: bool = True
    # attention softmax/score implementation: "naive" or "chunked"
    attn_impl: str = "naive"
    attn_chunk: int = 1024
    remat: bool = False              # activation checkpointing per block

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.num_heads, 1))

    def layer_is_global(self, i: int) -> bool:
        if self.global_every <= 0:
            return True
        return (i % self.global_every) == (self.global_every - 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
