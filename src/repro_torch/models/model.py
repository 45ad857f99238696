"""The dense decoder served through the paged KV pool (port of
``repro.models.model``, dense family; paged serving entry points only).

Params are a plain dict: ``embed``, ``final_norm`` (and ``head`` when
embeddings are untied), and ``blocks``, a list with one dict per layer
(``{"attn": {...}, "mlp": {...}}``). Where the JAX package stacks layers
on a leading axis and scans, this port loops over the list.

API:
  Model(cfg, device)                                     device="cuda"
  init(generator, qc)                              -> params
  init_paged_cache(max_seq, page_size, num_pages, codebook=None)
                                                   -> {"k", "v"} pool
  prefill_paged(params, tokens, kv, table, slot, pos, valid, qc) -> logits
  decode_paged(params, tokens, kv, table, positions, qc)         -> logits
  verify_paged(params, tokens, kv, table, positions, n_live, qc) -> logits

The pool ``(L, P+1, page, KVH, HD)`` (last page = trash) is updated in
place: where the JAX entry points return a new pool (the engine donates
the old buffer), these write the fresh K/V rows into ``kv`` and return
only the logits. With a :class:`~repro_torch.core.kv_codebook.KVCodebook`
the pool holds uint8 centroid codes ``(L, P+1, page, KVH, nc)`` and the
cache carries its own copy of the codebook under ``CODEBOOK_KEY``; rows
are encoded where they are written (:meth:`Model._encode_rows`).
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from repro_torch.core.kv_codebook import CODEBOOK_KEY, kv_encode
from repro_torch.core.lut import (DENSE, QuantConfig, lut_linear_init,
                                  precompute_layer, strip_for_inference)
from repro_torch.device import resolve_device
from .config import ModelConfig
from .layers import attention, mlp, rms_norm

Params = Dict[str, Any]


class Model:
    """A dense decoder on ``device`` (default the CUDA card; raises when
    there is none)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md "
                "queue A item 9 (Other families)")
        if cfg.head_layout != "heads":
            raise NotImplementedError("paged serving requires "
                                      "head_layout='heads'")
        self.cfg = cfg
        self.device = resolve_device(device)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def _init_proj(self, gen, k: int, n: int, qc: QuantConfig,
                   bias: bool = False) -> Params:
        """One projection. In lut_infer mode its LUT is built and its
        dense weight dropped right away, so at most one dense weight
        exists at a time (full width fits on one card)."""
        p = lut_linear_init(gen, k, n, qc, bias=bias, dtype=self.dtype,
                            device=self.device)
        if qc.mode == "lut_infer":
            p = strip_for_inference(precompute_layer(p, qc))
        return p

    def _init_block(self, gen, qc: QuantConfig) -> Params:
        cfg = self.cfg
        d, hd, f = cfg.d_model, cfg.head_dim, cfg.d_ff
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        zeros = torch.zeros((d,), dtype=self.dtype, device=self.device)
        return {
            "attn": {
                "wq": self._init_proj(gen, d, h * hd, qc, cfg.qkv_bias),
                "wk": self._init_proj(gen, d, kvh * hd, qc, cfg.qkv_bias),
                "wv": self._init_proj(gen, d, kvh * hd, qc, cfg.qkv_bias),
                "wo": self._init_proj(gen, h * hd, d, qc),
                "norm": zeros.clone(),
            },
            "mlp": {
                "wg": self._init_proj(gen, d, f, qc),
                "wu": self._init_proj(gen, d, f, qc),
                "wd": self._init_proj(gen, f, d, qc),
                "norm": zeros.clone(),
            },
        }

    def init(self, generator: torch.Generator,
             qc: QuantConfig = DENSE) -> Params:
        """Random params from ``generator`` (a generator on this model's
        device), built on the device layer by layer; in lut_infer mode
        every projection holds its LUT and no dense weight."""
        cfg, dev = self.cfg, self.device

        def normal(shape, std):
            t = torch.randn(shape, generator=generator, device=dev)
            return (std * t).to(self.dtype)

        params: Params = {
            "final_norm": torch.zeros((cfg.d_model,), dtype=self.dtype,
                                      device=dev),
            "embed": normal((cfg.vocab_size, cfg.d_model), 0.02),
        }
        params["blocks"] = [self._init_block(generator, qc)
                            for _ in range(cfg.num_layers)]
        if not cfg.tie_embeddings:
            params["head"] = normal((cfg.d_model, cfg.vocab_size), 0.02)
        return params

    # ------------------------------------------------------------------
    # embedding / head / layer loop
    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def _head(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ params["embed"].T
        return x @ params["head"]

    def _windows(self) -> List[int]:
        cfg = self.cfg
        return [0 if cfg.layer_is_global(i) else cfg.sliding_window
                for i in range(cfg.num_layers)]

    def _run_blocks(self, params: Params, x: torch.Tensor, qc: QuantConfig,
                    q_offset, kv: Params, phys: torch.Tensor, write
                    ) -> torch.Tensor:
        """The layer loop: attention (reading layer li of the pool) then
        the MLP, with ``write(li, k_new, v_new)`` storing the layer's
        fresh rows once its attention has read the pool."""
        cb = kv.get(CODEBOOK_KEY)
        for li, (p_l, win) in enumerate(zip(params["blocks"],
                                            self._windows())):
            cb_l = (None if cb is None
                    else {key: leaf[li] for key, leaf in cb.items()})
            a, k_new, v_new = attention(p_l["attn"], x, self.cfg, qc,
                                        q_offset, kv["k"][li], kv["v"][li],
                                        phys, window=win, codebook=cb_l)
            write(li, self._encode_rows(cb_l, "k", k_new),
                  self._encode_rows(cb_l, "v", v_new))
            x = x + a
            x = x + mlp(p_l["mlp"], x, self.cfg, qc)
        return x

    # ------------------------------------------------------------------
    # paged serving (continuous batching; see repro_torch/serve/)
    # ------------------------------------------------------------------
    def init_paged_cache(self, max_seq: int, page_size: int,
                         num_pages: int, dtype=None,
                         codebook=None) -> Params:
        """The page pool ``{"k": (L, num_pages+1, page_size, KVH, HD),
        "v": ...}`` on this model's device; the extra last page is the
        trash page that absorbs writes of lanes that are not live.

        codebook: optional :class:`~repro_torch.core.kv_codebook.KVCodebook`
        -- the pool then holds uint8 codes ``(L, num_pages+1, page_size,
        KVH, nc)`` and the cache carries its own copy of the codebook's
        leaves under ``CODEBOOK_KEY``, on this model's device."""
        cfg = self.cfg
        l, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        if codebook is not None:
            if (codebook.num_layers, codebook.head_dim) != (l, hd):
                raise ValueError(
                    f"codebook (L={codebook.num_layers}, "
                    f"HD={codebook.head_dim}) does not match model "
                    f"(L={l}, HD={hd})")
            shape = (l, num_pages + 1, page_size, kvh, codebook.nc)
            return {
                "k": torch.zeros(shape, dtype=torch.uint8,
                                 device=self.device),
                "v": torch.zeros(shape, dtype=torch.uint8,
                                 device=self.device),
                CODEBOOK_KEY: {key: leaf.to(self.device, torch.float32,
                                            copy=True).contiguous()
                               for key, leaf in codebook.tree().items()}}
        shape = (l, num_pages + 1, page_size, kvh, hd)
        dtype = dtype or self.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                "v": torch.zeros(shape, dtype=dtype, device=self.device)}

    @staticmethod
    def _encode_rows(cb_l, key: str, rows: torch.Tensor) -> torch.Tensor:
        """Fresh K/V rows -> what the pool stores: the rows themselves for
        an fp pool (cb_l None), their uint8 centroid codes for a code
        pool. The encode is a plain torch op on the card too: the JAX
        package computes it in XLA (``kv_encode``), not in a Pallas
        kernel."""
        if cb_l is None:
            return rows
        z, s = (cb_l["zk"], cb_l["sk"]) if key == "k" else (cb_l["zv"],
                                                            cb_l["sv"])
        return kv_encode(rows, z, s)

    def prefill_paged(self, params: Params, tokens: torch.Tensor, kv: Params,
                      page_table: torch.Tensor, slot: int, pos: int,
                      valid_len: int, qc: QuantConfig = DENSE
                      ) -> torch.Tensor:
        """One RIGHT-padded prefill chunk for a single slot.

        Args:
          tokens: (1, C) int32, the chunk right-padded to the static chunk
            width C; only the first ``valid_len`` are real.
          kv: the pool from :meth:`init_paged_cache`; the chunk's real rows
            are written into it in place.
          page_table: (num_slots, pages_per_slot) int32, -1 = unallocated.
            Pages covering positions [0, pos + valid_len) of ``slot`` must
            be allocated.
          slot, pos, valid_len: host ints; pos is the chunk's absolute
            start position.

        Returns logits (1, V) at the last real token.
        """
        c = tokens.shape[1]
        trash = kv["k"].shape[1] - 1
        ps = kv["k"].shape[2]
        if pos + c > page_table.shape[1] * ps:
            raise ValueError(f"chunk [{pos}, {pos + c}) runs past max_seq "
                             f"{page_table.shape[1] * ps}")
        row = page_table[slot]
        phys = torch.where(row >= 0, row, torch.full_like(row, trash))[None]
        tok_pos = pos + torch.arange(valid_len, device=self.device)
        tgt, off = phys[0, tok_pos // ps].long(), tok_pos % ps

        def write(li, k_new, v_new):
            kv["k"][li, tgt, off] = k_new[0, :valid_len]
            kv["v"][li, tgt, off] = v_new[0, :valid_len]

        x = self._run_blocks(params, self._embed(params, tokens), qc, pos,
                             kv, phys, write)
        x_last = rms_norm(x[:, valid_len - 1:valid_len], params["final_norm"],
                          self.cfg.norm_eps)
        return self._head(params, x_last)[:, 0]

    def decode_paged(self, params: Params, tokens: torch.Tensor, kv: Params,
                     page_table: torch.Tensor, positions: torch.Tensor,
                     qc: QuantConfig = DENSE) -> torch.Tensor:
        """One decode step over ALL slots at per-slot positions.

        Args:
          tokens: (num_slots, 1) int32; lanes not decoding carry a dummy id.
          positions: (num_slots,) int32 sequence length of each DECODING
            slot; -1 for lanes that are not decoding this step (free slots,
            and slots mid-prefill, whose pages hold prompt KV that must not
            be overwritten). Row b attends rows < positions[b].
          page_table: (num_slots, pages_per_slot) int32, -1 = unallocated;
            the page covering each decoding slot's position must exist.

        Returns logits (num_slots, V). Each decoding slot's new K/V row is
        written at its own (page, offset); other lanes write the trash page.
        """
        b = tokens.shape[0]
        trash = kv["k"].shape[1] - 1
        ps = kv["k"].shape[2]
        phys = torch.where(page_table >= 0, page_table,
                           torch.full_like(page_table, trash))
        pos_c = torch.clamp_min(positions, 0).long()
        live_page = phys[torch.arange(b, device=self.device), pos_c // ps]
        tgt = torch.where(positions >= 0, live_page,
                          torch.full_like(live_page, trash)).long()
        off = pos_c % ps

        def write(li, k_new, v_new):
            kv["k"][li, tgt, off] = k_new[:, 0]
            kv["v"][li, tgt, off] = v_new[:, 0]

        x = self._run_blocks(params, self._embed(params, tokens), qc,
                             positions, kv, phys, write)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x)[:, 0]

    def verify_paged(self, params: Params, tokens: torch.Tensor, kv: Params,
                     page_table: torch.Tensor, positions: torch.Tensor,
                     n_live: torch.Tensor, qc: QuantConfig = DENSE
                     ) -> torch.Tensor:
        """Score T proposed tokens per slot in ONE call (speculative
        verify).

        Row b feeds tokens[b, 0:T] at absolute positions positions[b] ..
        positions[b]+T-1: column 0 is the slot's committed but not yet
        decoded token, columns 1.. are draft proposals. Token t's query
        attends the committed rows < positions[b] plus proposed tokens
        0..t (their K/V computed fresh in this call), so logits[b, t] is
        the target's distribution after tokens[b, :t+1].

        Args:
          tokens: (num_slots, T) int32 proposals; dead columns carry dummy
            ids.
          positions: (num_slots,) int32 committed length of each verifying
            slot; -1 = lane not in this verify (free or mid-prefill).
          n_live: (num_slots,) int32 live columns per row (0 for -1
            lanes). Columns >= n_live[b] write their K/V to the trash page
            and their logits are garbage the caller ignores.

        Returns logits (num_slots, T, V). Live columns' fresh K/V rows
        are written in place at positions[b]+t (encoded on a code pool);
        pages covering positions[b]+n_live[b] tokens must be allocated.
        The caller commits the accepted prefix by advancing its position
        and rolls back the rejected tail by not advancing over it: rows
        >= the position are never attended and are overwritten before
        the position crosses them again.
        """
        b, t_v = tokens.shape
        trash = kv["k"].shape[1] - 1
        ps = kv["k"].shape[2]
        max_seq = page_table.shape[1] * ps
        phys = torch.where(page_table >= 0, page_table,
                           torch.full_like(page_table, trash))
        cols = torch.arange(t_v, device=self.device)
        tok_pos = torch.clamp_min(positions, 0).long()[:, None] + cols[None]
        live = (positions >= 0)[:, None] & (cols[None] < n_live[:, None])
        tok_pos = torch.clamp_max(tok_pos, max_seq - 1)  # dead cols: clamp
        page = torch.gather(phys.long(), 1, tok_pos // ps)
        tgt = torch.where(live, page, torch.full_like(page, trash))
        off = tok_pos % ps

        def write(li, k_new, v_new):
            kv["k"][li, tgt, off] = k_new
            kv["v"][li, tgt, off] = v_new

        x = self._run_blocks(params, self._embed(params, tokens), qc,
                             positions, kv, phys, write)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x)
