"""Input stand-ins for every (arch x shape) dry-run cell (port of
``repro.launch.specs``).

No device allocation: params, optimizer state, batch and cache are trees
of meta tensors (shapes and dtypes, no data), where the JAX package
builds ``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``. The meta
init draws no random numbers (``Model.init`` with no generator on a
meta-device model). The trees' leaves have the JAX trees' shapes and
dtypes, block leaves without the stacked layer axis (the port keeps a
list of blocks).

Where the port's cells differ from the JAX package's: the ssm and hybrid
families serve through the port's slot-state entry points
(``Model.init_paged_cache(num_slots=)``, ``prefill_paged`` /
``decode_paged``), since the port's dense cache refuses them, as its
batch engine does. Their cache is the slot state: the JAX dense cache's
``conv`` / ``h`` leaves, and for the hybrid a slot-dense attention cache
with one trash row past ``max_seq``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.lut import QuantConfig
from repro_torch.core.lutboost import precompute_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import RECURRENT, Model
from repro_torch.train.trainer import TrainConfig, init_opt_state

META = torch.device("meta")
#: The slot-state cells' page size (their state has no pages; the
#: argument is required and unused).
PAGE = 16


@dataclasses.dataclass(frozen=True)
class ShapeCase:
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, ShapeCase] = {
    "train_4k": ShapeCase("train", 4096, 256),
    "prefill_32k": ShapeCase("prefill", 32768, 32),
    "decode_32k": ShapeCase("decode", 32768, 128),
    "long_500k": ShapeCase("decode", 524288, 1),
}


def cell_is_runnable(cfg: ModelConfig, shape_name: str) -> Tuple[bool, str]:
    """long_500k only runs for archs with sub-quadratic structure
    (SSM/hybrid or sliding-window); see DESIGN.md §Arch-applicability."""
    if shape_name == "long_500k" and cfg.pure_full_attention:
        return False, "skipped (pure full-attention arch at 500k context)"
    return True, ""


def batch_dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def meta_model(cfg: ModelConfig) -> Model:
    return Model(cfg, device=META)


def param_specs(model: Model, qc: QuantConfig):
    """Meta tree of the model's params (with the inference LUTs, next to
    the weights and centroids they come from, when qc.mode == lut_infer:
    the JAX tree's leaves)."""
    if qc.mode == "lut_infer":
        return precompute_model(model.init(None, qc.replace(
            mode="lut_train")), qc)
    return model.init(None, qc)


def make_batch_specs(cfg: ModelConfig, batch: int, seq: int, dtype=None):
    """A training batch of meta tensors (``repro.data.synthetic.
    make_batch_specs``' shapes): vlm's ``seq`` is the whole budget, image
    prefix and text."""
    dtype = dtype or batch_dtype(cfg)
    if cfg.family == "audio":
        return {"embeds": torch.empty((batch, seq, cfg.d_model),
                                      dtype=dtype, device=META),
                "labels": torch.empty((batch, seq, cfg.num_codebooks),
                                      dtype=torch.int32, device=META)}
    if cfg.family == "vlm":
        text = max(seq - cfg.num_patches, 1)
        return {"patch_embeds": torch.empty(
                    (batch, cfg.num_patches, cfg.d_model), dtype=dtype,
                    device=META),
                "tokens": torch.empty((batch, text), dtype=torch.int32,
                                      device=META)}
    return {"tokens": torch.empty((batch, seq), dtype=torch.int32,
                                  device=META)}


def train_input_specs(model: Model, qc: QuantConfig, case: ShapeCase,
                      tc: Optional[TrainConfig] = None):
    """(params, opt_state, batch, step) for the train step: meta trees
    and the step number."""
    tc = tc or TrainConfig()
    p = param_specs(model, qc)
    opt = init_opt_state(p, tc)
    batch = make_batch_specs(model.cfg, case.batch, case.seq)
    return p, opt, batch, 0


def cache_specs(model: Model, batch: int, max_seq: int):
    """The cell's cache on meta: the dense cache (``init_cache``), or the
    ssm / hybrid slot state of ``batch`` slots."""
    if model.cfg.family in RECURRENT:
        return model.init_paged_cache(max_seq, PAGE, 0, num_slots=batch)
    return model.init_cache(batch, max_seq)


def serve_input_specs(model: Model, qc: QuantConfig, case: ShapeCase):
    """(params, inputs, cache) for a prefill (kind=prefill: the batch
    without labels) or a single decode step (kind=decode: one new token a
    row, audio one frame embedding)."""
    cfg = model.cfg
    p = param_specs(model, qc)
    cache = cache_specs(model, case.batch, case.seq)
    if case.kind == "prefill":
        batch = make_batch_specs(cfg, case.batch, case.seq)
        batch.pop("labels", None)
        return p, batch, cache
    if cfg.family == "audio":
        tok = torch.empty((case.batch, 1, cfg.d_model),
                          dtype=batch_dtype(cfg), device=META)
    else:
        tok = torch.empty((case.batch, 1), dtype=torch.int32, device=META)
    return p, tok, cache
