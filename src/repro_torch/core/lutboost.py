"""Deployment half of LUTBoost (port of ``repro.core.lutboost``): build the
inference LUT of every LutLinear in a parameter tree. Training (stages
1-3) is not ported yet (ROADMAP.md queue A item 10)."""
from __future__ import annotations

from .lut import QuantConfig, precompute_layer


def _walk_lut_layers(tree, fn):
    """Apply fn to every sub-dict that looks like a LutLinear (has w & z)."""
    if isinstance(tree, dict):
        if "z" in tree and "w" in tree:
            return fn(tree)
        return {k: _walk_lut_layers(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_lut_layers(v, fn) for v in tree)
    return tree


def precompute_model(params, qc: QuantConfig):
    """Add ``lut`` (and ``lut_scale`` for int8) to every LutLinear so the
    tree can serve in ``mode="lut_infer"`` (paper step-2)."""
    return _walk_lut_layers(params, lambda p: precompute_layer(p, qc))
