"""LUT construction and the LutLinear projection (port of ``repro.core.lut``).

Three operating modes (``QuantConfig.mode``):

  * ``dense``      — plain ``x @ w + b`` (the paper's comparison baseline).
  * ``lut_train``  — LUTBoost training: each sub-vector of the input goes
                     to its nearest centroid through a straight-through
                     estimator; the forward value is ``Â·W``, the backward
                     path ``A·W`` (paper §V-2), and a two-sided
                     reconstruction loss trains the centroids. Plain
                     PyTorch on the card too: the JAX package computes it
                     in XLA, not in a Pallas kernel.
  * ``lut_infer``  — deployment path: precomputed LUT (optionally int8),
                     nearest-centroid assignment fused with the LUT
                     gather-accumulate (``kernels.ops.vq_amm``, kernel B1),
                     or, with ``fuse=False``, the two-pass path: the
                     assignment (``ops.vq_assign``, kernel B3) writes the
                     indices, then the LUT accumulate reads them
                     (``ops.lut_matmul``, kernel B4). No dense weight is
                     needed at run time.

``QuantConfig.kv_quant="vq"`` is read by the paged serving path, not by
the projections: the KV pool then holds uint8 centroid codes
(``core/kv_codebook.py``, kernel B5).

Parameters of one LutLinear (a plain dict of tensors):
  w  (K, N)            dense weight  (absent after `strip_for_inference`)
  b  (N,)              optional bias
  z  (nc, c, v)        centroids (trained in LUTBoost stages 2 and 3)
  lut (nc, c, N)       precomputed table      (inference only)
  lut_scale (N,)       dequant scale          (int8 inference only)
An MoE layer's expert projections carry a leading expert axis on each
(``w (E, K, N)``, ``z (E, nc, c, v)``, ``lut (E, nc, c, N)``,
``lut_scale (E, N)``: one scale per expert and column); the functions
below take any leading axes, as the JAX package vmaps them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from .codebook import CodebookSpec, init_centroids
from .similarity import Metric, ste_quantize_subspaces

Params = Dict[str, torch.Tensor]

LUT_DTYPES = ("float32", "bfloat16", "int8")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """VQ-AMM operating point threaded through every projection."""
    mode: str = "dense"            # dense | lut_train | lut_infer
    v: int = 8                     # sub-vector length
    c: int = 16                    # centroids per subspace (<= 256)
    metric: Metric = "l2"          # l2 | l1 | chebyshev
    lut_dtype: str = "float32"     # float32 | bfloat16 | int8
    recon_weight: float = 0.05     # lut_train: the paper's penalty ratio
    task_grad_to_centroids: bool = False   # lut_train: LUT-NN-style path
    fuse: bool = True              # lut_infer: one fused assign + LUT
    #                                kernel (B1) vs two passes (B3, B4)
    kv_quant: str = "none"         # paged KV pool: none (fp rows) | vq
    #                                (uint8 codebook indices; kernel B5)
    kv_v: int = 4                  # KV sub-vector length over head_dim
    kv_c: int = 16                 # KV centroids per subspace (<= 256)

    def __post_init__(self):
        if self.mode not in ("dense", "lut_train", "lut_infer"):
            raise ValueError(f"unknown quant mode: {self.mode}")
        if self.kv_quant not in ("none", "vq"):
            raise ValueError(
                f"kv_quant must be 'none' or 'vq', got {self.kv_quant!r}")
        if self.kv_quant == "vq" and self.kv_c > 256:
            raise ValueError(
                f"kv_c={self.kv_c} does not fit uint8 page codes")
        if self.lut_dtype not in LUT_DTYPES:
            raise ValueError(f"lut_dtype must be one of {LUT_DTYPES}, got "
                             f"{self.lut_dtype!r}")
        if not 1 <= self.c <= 256:
            raise ValueError(f"c must be in [1, 256], got {self.c}")

    @property
    def spec(self) -> CodebookSpec:
        return CodebookSpec(v=self.v, c=self.c, metric=self.metric)

    @property
    def is_lut(self) -> bool:
        return self.mode in ("lut_train", "lut_infer")

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


DENSE = QuantConfig(mode="dense")


def lut_linear_init(generator: torch.Generator, k: int, n: int,
                    qc: QuantConfig, bias: bool = False,
                    dtype=torch.float32, device="cuda") -> Params:
    """Initialise a (K, N) projection from ``generator``, with centroids
    when LUT mode is on."""
    device = resolve_device(device)
    w = torch.randn((k, n), generator=generator, device=device)
    p: Params = {"w": ((1.0 / k ** 0.5) * w).to(dtype)}
    if bias:
        p["b"] = torch.zeros((n,), dtype=dtype, device=device)
    if qc.is_lut:
        p["z"] = init_centroids(generator, k, qc.spec, dtype=dtype,
                                device=device)
    return p


def build_lut(w: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """LUT[k, j, n] = z[k, j, :] . w[k*v:(k+1)*v, n] (paper step-2), in
    float32. w (..., K, N), z (..., nc, c, v) -> (..., nc, c, N), over
    any leading (expert) axes."""
    nc, c, v = z.shape[-3:]
    k, n = w.shape[-2:]
    if nc * v != k or w.shape[:-2] != z.shape[:-3]:
        raise ValueError(f"w {tuple(w.shape)} does not match z "
                         f"{tuple(z.shape)}")
    return torch.matmul(z.float(),
                        w.float().reshape(*w.shape[:-2], nc, v, n))


def quantize_lut_int8(lut: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-column int8 quantisation of the LUT.

    The scale is shared across subspaces so the integer accumulation
    ``sum_k lut8[k, idx, n]`` dequantises with one multiply per column.
    lut (..., nc, c, N) -> (int8 table, scale (..., N)): the amax runs
    over the two axes before N only, so experts keep their own scales.
    """
    amax = torch.amax(torch.abs(lut), dim=(-3, -2))            # (..., N)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    lut8 = torch.clamp(torch.round(lut / scale[..., None, None, :]), -127,
                       127)
    return lut8.to(torch.int8), scale.to(torch.float32)


def precompute_layer(p: Params, qc: QuantConfig) -> Params:
    """Turn a LutLinear into its inference form (adds lut / lut_scale);
    expert leaves (a leading expert axis on w and z) give one table and
    one scale per expert."""
    if "z" not in p:
        return p
    lut = build_lut(p["w"], p["z"])
    out = dict(p)
    if qc.lut_dtype == "int8":
        out["lut"], out["lut_scale"] = quantize_lut_int8(lut)
    elif qc.lut_dtype == "bfloat16":
        out["lut"] = lut.to(torch.bfloat16)
    else:
        out["lut"] = lut
    return out


def strip_for_inference(p: Params) -> Params:
    """Drop the dense weight once the LUT exists (deployment footprint)."""
    return {k: v for k, v in p.items() if k != "w" or "lut" not in p}


def lut_linear_apply(p: Params, x: torch.Tensor, qc: QuantConfig,
                     recon: Optional[List[torch.Tensor]] = None
                     ) -> torch.Tensor:
    """Apply the projection: x (..., K) -> (..., N) in x's dtype.

    In ``lut_train`` the projection's reconstruction loss (a float32
    scalar) is appended to ``recon``, which the caller must pass there;
    the other modes have none and leave it alone. While
    :func:`~repro_torch.core.lutboost.capture_activations` is open, the
    input is recorded first (LUTBoost stage 1).
    """
    if _lutboost._CAPTURE is not None:
        _lutboost.record_activation(p, x)
    if qc.mode == "dense" or "z" not in p:
        out = x @ p["w"]
        if "b" in p:
            out = out + p["b"]
        return out
    z = p["z"]
    k = z.shape[0] * z.shape[2]
    lead = x.shape[:-1]
    if qc.mode == "lut_train":
        if recon is None:
            raise ValueError("lut_train projections need a recon list")
        x_hat = ste_quantize_subspaces(x.reshape(*lead, k // qc.v, qc.v), z,
                                       qc.metric)
        out_q = x_hat.reshape(*lead, k).to(x.dtype) @ p["w"]        # Â·W
        if qc.task_grad_to_centroids:
            # LUT-NN-style: the task gradient reaches the centroids
            # through the STE
            out = out_q
            out_d = x.detach() @ p["w"]
        else:
            # paper-faithful: forward value Â·W, backward path A·W; the
            # centroids learn from the reconstruction loss only
            out_d = x @ p["w"]                                       # A·W
            out = out_d + (out_q - out_d).detach()
        recon.append((torch.mean((out_q.detach() - out_d) ** 2)
                      + torch.mean((out_q - out_d.detach()) ** 2)).float())
        if "b" in p:
            out = out + p["b"]
        return out
    x2d = x.reshape(-1, k // qc.v, qc.v).contiguous()
    lut = p.get("lut")
    if lut is None:                    # on-the-fly (testing convenience)
        lut = build_lut(p["w"], z)
    if qc.fuse:        # indices stay on chip (kernel B1)
        out = kops.vq_amm(x2d, z, lut, p.get("lut_scale"), qc.metric)
    else:              # two-pass: (M, nc) indices through device memory
        idx = kops.vq_assign(x2d, z, qc.metric)
        out = kops.lut_matmul(idx, lut, p.get("lut_scale"))
    out = out.reshape(*lead, -1).to(x.dtype)
    if "b" in p:
        out = out + p["b"]
    return out


# the capture hook's module; imported last, as it imports this one
from . import lutboost as _lutboost  # noqa: E402
