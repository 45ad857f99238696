"""Vector-quantized KV-cache codebooks (port of ``repro.core.kv_codebook``).

The paper's VQ + LUT idea applied to serving state: paged KV pages store
per-subspace centroid indices (uint8, grouped over ``head_dim``) instead
of fp rows. A :class:`KVCodebook` holds one codebook per layer for K and
one for V, plus per-layer, per-head RMS scales that normalise head
magnitudes before assignment, so one small ``(nc, c, v)`` table covers
every head of a layer.

Layout algebra (``nc = head_dim // v``, ``c <= 256`` so indices fit
uint8):

    fp row    (..., KVH, HD)   --encode-->   codes (..., KVH, nc) uint8
    codes     (..., KVH, nc)   --decode-->   fp row (..., KVH, HD)

    decode(codes)[..., h, s*v:(s+1)*v] = scale[h] * z[s, codes[..., h, s]]

Encode is plain-L2 nearest-centroid assignment in the scale-normalised
space, in the ``|x|^2 - 2 x.z + |z|^2`` form the JAX package uses, so
near-ties resolve the same way. Both directions are plain torch ops: the
JAX package computes them in XLA, not in a Pallas kernel, and the port
runs them on the write path (encode) and for the cached rows a prefill
chunk reads (decode); decode attention dequantizes inside kernel B5.

Fitting runs k-means (``core.codebook.kmeans_codebook``) per layer on
calibration K/V rows; :meth:`KVCodebook.from_rows` builds an exact-cover
codebook (centroids = the row set, unit scales), the lossless fixture of
the identity tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .codebook import CodebookSpec, kmeans_codebook

#: key of the codebook inside a quantized paged-cache dict; the model's
#: paged entry points detect a quantized pool by its presence.
CODEBOOK_KEY = "codebook"


# ---------------------------------------------------------------------------
# per-layer encode / decode (z (nc, c, v), scale (KVH,))
# ---------------------------------------------------------------------------

def kv_encode(rows: torch.Tensor, z: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """fp K/V rows (..., KVH, HD) -> codes (..., KVH, nc) uint8: L2
    assignment in the scale-normalised space the codebook was fit in."""
    nc, c, v = z.shape
    x = rows.float() / scale.float()[:, None]
    x = x.reshape(*rows.shape[:-1], nc, v)                 # (..., KVH, nc, v)
    zf = z.float()
    x2 = torch.sum(x * x, dim=-1)[..., None]               # (..., nc, 1)
    z2 = torch.sum(zf * zf, dim=-1)                        # (nc, c)
    xz = torch.einsum("...sv,scv->...sc", x, zf)
    d = x2 - 2.0 * xz + z2
    return torch.argmin(d, dim=-1).to(torch.uint8)


def kv_decode(codes: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
              dtype=torch.float32) -> torch.Tensor:
    """Codes (..., KVH, nc) uint8 -> fp rows (..., KVH, HD): one gather
    from the ``(nc, c, v)`` table, times the head's scale."""
    nc, c, v = z.shape
    sub = z.float()[torch.arange(nc, device=codes.device), codes.long()]
    rows = sub.reshape(*codes.shape[:-1], nc * v)
    return (rows * scale.float()[:, None]).to(dtype)


def kv_encode_stacked(rows: torch.Tensor, z: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """:func:`kv_encode` over a leading layer axis: rows (L, ..., KVH, HD),
    z (L, nc, c, v), scale (L, KVH) -> (L, ..., KVH, nc) uint8."""
    return torch.stack([kv_encode(r, zz, ss)
                        for r, zz, ss in zip(rows, z, scale)])


def kv_decode_stacked(codes: torch.Tensor, z: torch.Tensor,
                      scale: torch.Tensor, dtype=torch.float32
                      ) -> torch.Tensor:
    """:func:`kv_decode` over a leading layer axis."""
    return torch.stack([kv_decode(cd, zz, ss, dtype)
                        for cd, zz, ss in zip(codes, z, scale)])


# ---------------------------------------------------------------------------
# the codebook object
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KVCodebook:
    """Per-layer K/V codebooks + per-layer, per-head scales.

    zk/zv : (L, nc, c, v) float32 centroids (K and V fit separately).
    sk/sv : (L, KVH) float32 RMS scales dividing rows before assignment.
    """
    zk: torch.Tensor
    zv: torch.Tensor
    sk: torch.Tensor
    sv: torch.Tensor

    def __post_init__(self):
        l, nc, c, v = self.zk.shape
        if tuple(self.zv.shape) != (l, nc, c, v):
            raise ValueError(f"zk {tuple(self.zk.shape)} vs zv "
                             f"{tuple(self.zv.shape)}")
        if self.sk.shape[0] != l or self.sk.shape != self.sv.shape:
            raise ValueError(f"scale shapes {tuple(self.sk.shape)}/"
                             f"{tuple(self.sv.shape)} do not match zk "
                             f"{tuple(self.zk.shape)}")
        if c > 256:
            raise ValueError(f"c={c} does not fit uint8 codes")

    # -- shape algebra ------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return self.zk.shape[0]

    @property
    def nc(self) -> int:
        return self.zk.shape[1]

    @property
    def c(self) -> int:
        return self.zk.shape[2]

    @property
    def v(self) -> int:
        return self.zk.shape[3]

    @property
    def head_dim(self) -> int:
        return self.nc * self.v

    @property
    def bytes_per_token_per_kv_head(self) -> int:
        """uint8 codes per token per kv head for ONE of K/V."""
        return self.nc

    @property
    def equivalent_bits(self) -> float:
        """Paper Table V metric for the KV operating point."""
        return CodebookSpec(v=self.v, c=self.c).equivalent_bits

    def tree(self) -> Dict[str, torch.Tensor]:
        """The dict a quantized paged cache carries under
        :data:`CODEBOOK_KEY` (every leaf has the leading L axis)."""
        return {"zk": self.zk, "zv": self.zv, "sk": self.sk, "sv": self.sv}

    def fingerprint(self) -> int:
        """Content hash of the codebook (codes are only comparable under
        the same codebook)."""
        h = 0
        for leaf in (self.zk, self.zv, self.sk, self.sv):
            h = hash((h, leaf.detach().cpu().numpy().tobytes()))
        return h

    # -- convenience wrappers (tests / harnesses) ----------------------------
    def encode(self, rows: torch.Tensor, which: str = "k") -> torch.Tensor:
        z, s = (self.zk, self.sk) if which == "k" else (self.zv, self.sv)
        return kv_encode_stacked(rows, z, s)

    def decode(self, codes: torch.Tensor, which: str = "k",
               dtype=torch.float32) -> torch.Tensor:
        z, s = (self.zk, self.sk) if which == "k" else (self.zv, self.sv)
        return kv_decode_stacked(codes, z, s, dtype)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def fit(cls, k_rows: torch.Tensor, v_rows: torch.Tensor, *, v: int = 4,
            c: int = 16, iters: int = 8,
            generator: Optional[torch.Generator] = None) -> "KVCodebook":
        """K-means fit on calibration rows (L, T, KVH, HD), on their device.

        Rows are RMS-normalised per (layer, kv head) first, so one
        ``(nc, c, v)`` table per layer covers heads of very different
        magnitudes. ``generator`` (on the rows' device) seeds the k-means;
        default: seed 0."""
        if generator is None:
            generator = torch.Generator(device=k_rows.device).manual_seed(0)
        hd = k_rows.shape[-1]
        spec = CodebookSpec(v=v, c=c, metric="l2")
        spec.num_subspaces(hd)        # validates v | head_dim

        def one_stream(rows):
            xf = rows.float()
            scale = torch.sqrt(torch.mean(xf ** 2, dim=(1, 3))) + 1e-6
            xs = xf / scale[:, None, :, None]
            z = torch.stack([kmeans_codebook(x, hd, spec, iters=iters,
                                             generator=generator)
                             for x in xs])
            return z, scale

        zk, sk = one_stream(k_rows)
        zv, sv = one_stream(v_rows)
        return cls(zk=zk, zv=zv, sk=sk, sv=sv)

    @classmethod
    def from_rows(cls, k_rows: torch.Tensor,
                  v_rows: torch.Tensor) -> "KVCodebook":
        """Exact-cover codebook: one subspace (v = head_dim), centroids =
        the row set verbatim, unit scales. Every row of ``k_rows`` /
        ``v_rows`` then round-trips bit-identical through encode/decode.
        Requires T * KVH <= 256 rows per layer."""
        l, t, kvh, hd = k_rows.shape
        n = t * kvh
        if n > 256:
            raise ValueError(f"exact-cover needs T*KVH <= 256, got {n}")

        def pack(rows):
            return rows.float().reshape(l, n, hd)[:, None].contiguous()
        ones = torch.ones((l, kvh), dtype=torch.float32,
                          device=k_rows.device)
        return cls(zk=pack(k_rows), zv=pack(v_rows), sk=ones,
                   sv=ones.clone())


def codebook_from_tree(tree: Dict[str, torch.Tensor]) -> KVCodebook:
    """Rebuild a :class:`KVCodebook` from its cache-dict form."""
    return KVCodebook(zk=tree["zk"], zv=tree["zv"], sk=tree["sk"],
                      sv=tree["sv"])
