"""Model configuration: the port's own copy of ``repro.models.config``.

Kept field for field identical to the JAX package's ``ModelConfig`` (a
test holds the two against each other), so configurations carry over
unchanged. The port runs all six families.
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

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def pure_full_attention(self) -> bool:
        """True if every layer is unwindowed full attention (no SSM or
        local structure)."""
        if self.family in ("ssm", "hybrid"):
            return False
        return self.global_every == 0 or self.sliding_window == 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def layer_is_global(self, i: int) -> bool:
        if self.global_every <= 0:
            return True
        return (i % self.global_every) == (self.global_every - 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks; audio's
        codebook heads, the hybrid's shared block once), the JAX
        package's formula."""
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        emb = self.vocab_size * d
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp = 3 * d * f
        if self.family == "moe":
            mlp = (self.num_experts + self.num_shared_experts) * 3 * d * f \
                + d * self.num_experts
        if self.family == "ssm":
            return emb + L * self._ssm_block_params()
        if self.family == "hybrid":
            return emb + L * self._ssm_block_params() + (attn + 3 * d * f)
        total = emb + L * (attn + mlp)
        if self.family == "audio":
            total += self.num_codebooks * self.vocab_size * d
        return total

    def _ssm_block_params(self) -> int:
        d, din = self.d_model, self.d_inner
        n, g, h = self.ssm_state, self.ssm_ngroups, self.ssm_nheads
        in_proj = d * (2 * din + 2 * g * n + h)
        out_proj = din * d
        conv = (din + 2 * g * n) * self.ssm_conv
        return in_proj + out_proj + conv + 2 * h + din

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared),
        the JAX package's formula."""
        if self.family != "moe":
            return self.param_count()
        d, f, L = self.d_model, self.d_ff, self.num_layers
        hd = self.head_dim
        emb = self.vocab_size * d
        attn = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd) \
            + (self.num_heads * hd) * d
        mlp_active = (self.top_k + self.num_shared_experts) * 3 * d * f \
            + d * self.num_experts
        return emb + L * (attn + mlp_active)
