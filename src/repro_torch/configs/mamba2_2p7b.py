"""mamba2-2.7b [ssm]: SSD, attention-free (arXiv:2405.21060).
64L d_model=2560, ssm_state=128, d_ff=0, vocab=50280.

The port's own copy of ``repro.configs.mamba2_2p7b``; a test holds the
two field for field."""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-2.7b", family="ssm",
        num_layers=64, d_model=2560, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280, head_dim=1,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        dtype="bfloat16")


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        num_layers=3, d_model=64, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=256, head_dim=1,
        ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_ngroups=1,
        dtype="float32")
