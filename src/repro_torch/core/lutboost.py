"""LUTBoost, the paper's multistage model converter (§V); port of
``repro.core.lutboost``.

Stage ① swap linears for LUT operators and initialise centroids by per-
          subspace k-means over calibration activations (:func:`convert`);
Stage ② train *centroids only* (weights frozen: :func:`stage_mask`);
Stage ③ joint fine-tune of centroids and weights.
Deployment then builds every LUT (:func:`precompute_model`).

The optimisation loop lives in ``repro_torch.train.trainer``.

The capture keys each projection by the identity of its ``z`` tensor. The
port's params keep one dict per layer (``params["blocks"]`` is a list), so
every projection of every layer has a ``z`` of its own and the capture
sees that projection's real input. (The JAX package stacks layers and
scans them, so a capture around a whole model records nothing.) An MoE
layer's expert projections are not captured, as in the JAX package: their
centroids keep their init. The audio family's ``in_proj`` and ``heads``
are dense matrices with no centroids in either package, so the capture
and every stage pass them by.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.tree import tree_map, tree_map_with_path
from .codebook import kmeans_codebook
from .lut import QuantConfig, precompute_layer

# ---------------------------------------------------------------------------
# Stage ①: calibration capture + k-means init
# ---------------------------------------------------------------------------

_CAPTURE: Optional[Dict[int, torch.Tensor]] = None


@contextlib.contextmanager
def capture_activations():
    """Record the input of every LutLinear applied inside the block, keyed
    by ``id(params['z'])``: ``{id: (rows, K)}``, the rows of every call
    appended in call order, on the input's device and in its dtype."""
    global _CAPTURE
    prev = _CAPTURE
    _CAPTURE = {}
    try:
        yield _CAPTURE
    finally:
        _CAPTURE = prev


def record_activation(p: Dict[str, Any], x: torch.Tensor) -> None:
    """Called by LutLinear on every apply; a no-op unless capturing."""
    if _CAPTURE is None or "z" not in p:
        return
    key = id(p["z"])
    flat = x.detach().reshape(-1, x.shape[-1])
    prev = _CAPTURE.get(key)
    _CAPTURE[key] = flat.clone() if prev is None else torch.cat([prev, flat])


def _walk_lut_layers(tree, fn):
    """Apply fn to every sub-dict that looks like a LutLinear (has w & z)."""
    if isinstance(tree, dict):
        if "z" in tree and "w" in tree:
            return fn(tree)
        return {k: _walk_lut_layers(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_lut_layers(v, fn) for v in tree)
    return tree


def kmeans_init_from_capture(params, captured: Dict[int, torch.Tensor],
                             qc: QuantConfig, iters: int = 10, seed: int = 0,
                             inits: Optional[Dict[int, torch.Tensor]] = None
                             ) -> Any:
    """Replace every captured layer's centroids with k-means of its inputs.

    Args:
      params: a param tree holding LutLinear sub-dicts (w & z).
      captured: ``id(layer["z"]) -> (rows, K)`` from
        :func:`capture_activations`.
      qc: ``qc.spec`` fixes (v, c, metric) for the k-means.
      iters: Lloyd iterations per layer; seed: the k-means of the i-th
        captured layer (in tree order, from 1; ``codebook.kmeans_codebook``,
        at most 4096 rows) draws from a ``torch.Generator`` seeded
        ``seed + i`` on the rows' device.
      inits: optional ``id(layer["z"]) -> (nc, c, v)`` initial centroids
        in place of the random seeding (to hold the port against the JAX
        package, whose random streams differ).

    Returns: a tree with each captured layer's ``z`` replaced by its
    k-means codebook (dtype kept); the other leaves are the same tensors.
    """
    counter = [0]

    def init(layer):
        key = id(layer["z"])
        if key not in captured:
            return layer
        counter[0] += 1
        acts = captured[key]
        gen = torch.Generator(device=acts.device).manual_seed(
            seed + counter[0])
        start = None if inits is None else inits[key]
        z = kmeans_codebook(acts, layer["w"].shape[0], qc.spec, iters, gen,
                            init=start)
        out = dict(layer)
        out["z"] = z.to(layer["z"].dtype)
        return out

    return _walk_lut_layers(params, init)


def convert(apply_fn: Callable, params, calib_batch, qc: QuantConfig,
            iters: int = 10, seed: int = 0):
    """LUTBoost stage ①: one calibration forward (no gradients), then a
    k-means codebook of its inputs for every projection it ran.

    Args:
      apply_fn: ``apply_fn(params, batch)`` running the model. Pass its
        dense forward (``lambda p, b: model.forward(p, b, DENSE)``), as
        the JAX package's example and Table 2 benchmark do: the capture
        records in every mode, and under the lut_train forward each layer
        would be calibrated on inputs computed through upstream layers'
        random centroids.
      params: params whose LutLinear layers carry ``z`` (init the model
        with a ``lut_train`` QuantConfig).
      calib_batch: one representative batch (any family's: audio frame
        embeddings, vlm patches and text; a vlm projection's capture
        holds the patch rows too).
      qc / iters / seed: as :func:`kmeans_init_from_capture`.

    Returns: params with calibrated centroids (stage ② trains them).
    """
    with torch.no_grad(), capture_activations() as captured:
        apply_fn(params, calib_batch)
    with torch.no_grad():
        return kmeans_init_from_capture(params, captured, qc, iters, seed)


# ---------------------------------------------------------------------------
# Stages ②/③: trainable-parameter masking + schedule
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LutBoostSchedule:
    """Paper §VII-A hyper-parameters (ResNet defaults)."""
    stage2_steps: int = 1000
    stage3_steps: int = 5000
    lr_stage2: float = 1e-3
    lr_stage3: float = 5e-4
    recon_weight_stage2: float = 0.05
    recon_weight_stage3: float = 0.05

    def stage(self, step: int) -> int:
        return 2 if step < self.stage2_steps else 3

    def lr(self, step: int) -> float:
        return self.lr_stage2 if step < self.stage2_steps else self.lr_stage3

    def recon_weight(self, step: int) -> float:
        return (self.recon_weight_stage2 if step < self.stage2_steps
                else self.recon_weight_stage3)

    @property
    def total_steps(self) -> int:
        return self.stage2_steps + self.stage3_steps


def centroid_only_mask(params) -> Any:
    """A tree of bools matching ``params``: True only on centroid (``z``)
    leaves, the stage-② trainable set (weights frozen)."""
    return tree_map_with_path(lambda path, _: path.endswith("['z']"),
                              params)


def stage_mask(params, stage: int):
    """Trainable mask for a LUTBoost stage: centroids only for stage ②,
    everything for stage ③."""
    if stage == 2:
        return centroid_only_mask(params)
    return tree_map(lambda _: True, params)


def apply_mask(grads, mask):
    """Zero the gradient leaves wherever ``mask`` is False (frozen)."""
    return tree_map(lambda g, m: g if m else torch.zeros_like(g), grads,
                    mask)


# ---------------------------------------------------------------------------
# Deployment: precompute every LUT
# ---------------------------------------------------------------------------

def precompute_model(params, qc: QuantConfig):
    """Add ``lut`` (and ``lut_scale`` for int8) to every LutLinear so the
    tree can serve in ``mode="lut_infer"`` (paper step-2)."""
    return _walk_lut_layers(params, lambda p: precompute_layer(p, qc))
