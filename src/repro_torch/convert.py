"""Parameters from the JAX package's layout, for holding the two packages
against each other on the same weights.

The JAX package keeps a parameter pytree whose ``blocks`` leaves carry a
leading layer axis (its layer loop is a ``lax.scan``). The caller turns
that pytree into numpy arrays (``jax.tree_util.tree_map(np.asarray, ...)``)
so this module needs nothing of JAX; :func:`params_from_numpy` then builds
the port's params, with ``blocks`` unstacked into one dict per layer, and
:func:`params_to_numpy` goes back (to compare trained params with the JAX
package's).
:func:`kv_codebook_from_numpy` carries a JAX ``KVCodebook`` over the same
way (its ``tree()`` as numpy arrays).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.kv_codebook import KVCodebook
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    a = np.array(a)                      # own, writable, contiguous copy
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Any, cfg: ModelConfig,
                      device="cuda") -> Any:
    """The port's params from a JAX param tree of numpy arrays.

    ``tree["blocks"]`` leaves have a leading axis of ``cfg.num_layers``;
    they become a list of per-layer dicts (a Mamba2 block's too). Every
    other entry (``embed``, ``final_norm``, ``head``, the hybrid's
    ``shared_attn``, the audio family's ``in_proj`` and ``heads``: it has
    no ``embed``) comes over as it is. Every array keeps its dtype
    (float32, bfloat16, int8) and lands on ``device``.
    """
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev))
           for k, v in tree.items() if k != "blocks"}
    n_layers = cfg.num_layers

    def layer(i):
        def take(a):
            if a.shape[0] != n_layers:
                raise ValueError(f"blocks leaf of shape {a.shape} lacks a "
                                 f"leading axis of {n_layers} layers")
            return _tensor(a[i], dev)
        return _map(tree["blocks"], take)

    out["blocks"] = [layer(i) for i in range(n_layers)]
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_numpy(params: Any, cfg: ModelConfig) -> Any:
    """The inverse of :func:`params_from_numpy`: numpy arrays in the JAX
    package's layout, the list ``params["blocks"]`` stacked into leaves
    with a leading axis of ``cfg.num_layers``. numpy has no bfloat16, so
    a bf16 leaf comes back as float32 (which holds each of its values
    exactly); every other dtype is kept."""
    blocks = params["blocks"]
    if len(blocks) != cfg.num_layers:
        raise ValueError(f"{len(blocks)} blocks for a config of "
                         f"{cfg.num_layers} layers")
    out = {k: _map(v, _numpy) for k, v in params.items() if k != "blocks"}

    def stack(*leaves):
        return np.stack([_numpy(t) for t in leaves])

    def walk(first, i_path):
        if isinstance(first, dict):
            return {k: walk(v, i_path + (k,)) for k, v in first.items()}

        def leaf(b):
            for k in i_path:
                b = b[k]
            return b
        return stack(*(leaf(b) for b in blocks))

    out["blocks"] = walk(blocks[0], ())
    return out


def kv_codebook_from_numpy(tree: Any, device="cuda") -> KVCodebook:
    """The port's :class:`KVCodebook` from a JAX codebook's ``tree()``
    ({"zk", "zv": (L, nc, c, v), "sk", "sv": (L, KVH)}) as numpy arrays,
    on ``device``, every leaf bit for bit."""
    dev = resolve_device(device)
    return KVCodebook(**{key: _tensor(tree[key], dev)
                         for key in ("zk", "zv", "sk", "sv")})
