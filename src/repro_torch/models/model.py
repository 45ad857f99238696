"""The decoder (port of ``repro.models.model``: the dense, MoE, SSM and
hybrid families): ``forward`` and ``loss`` for training, and the serving
entry points, paged for the continuous-batching engine, dense for the
batch-to-completion one.

Params are a plain dict: ``embed``, ``final_norm`` (and ``head`` when
embeddings are untied), and ``blocks``, a list with one dict per layer
(``{"attn": {...}, "mlp": {...}}``, or ``{"attn": {...}, "moe": {...}}``
for the MoE family, ``models/moe.py``; a Mamba2 block for the SSM and
hybrid families, ``models/mamba2.py``). The hybrid family adds
``shared_attn`` (``{"attn", "mlp"}``), one attention + MLP block applied
after every ``shared_attn_every``-th Mamba2 block. Where the JAX package
stacks layers on a leading axis and scans, this port loops over the list.

API:
  Model(cfg, device)                                     device="cuda"
  init(generator, qc)                              -> params
  forward(params, {"tokens"}, qc)                  -> (logits, aux)
  loss(params, {"tokens"}, qc)                     -> (scalar, metrics)
  init_cache(batch_size, max_seq)                  -> dense cache
  prefill(params, {"tokens"}, cache, qc, pad_lens=None) -> (logits, cache)
  decode(params, tokens, cache, qc, pad_lens=None)      -> (logits, cache)
  init_paged_cache(max_seq, page_size, num_pages, codebook=None,
                   num_slots=None)                 -> pool or slot state
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

The SSM and hybrid families keep their recurrent state slot by slot, not
in pages (``{"conv": (L, S, K-1, C), "h": (L, S, H, P, N) float32}``; the
hybrid's is ``{"mamba": {...}, "attn": {"k", "v": (n_inv, S, max_seq+1,
KVH, HD)}}``, a slot-dense cache for the shared block's invocations whose
last row is the trash row). It is updated in place as well: a prefill
chunk writes its slot's state, a decode step a per-lane select that keeps
the state of every lane that is not decoding. The dense-cache API and
``verify_paged`` refuse these families, as the JAX package's engines do.

``forward`` runs whole sequences from position 0 with no cache (the SSM
blocks from zero state), each layer under ``torch.utils.checkpoint`` when
``cfg.remat`` is set; in ``lut_train`` it sums every projection's
reconstruction loss, and the MoE family's load-balancing loss, for
``loss``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.kv_codebook import CODEBOOK_KEY, kv_encode
from repro_torch.core.lut import (DENSE, QuantConfig, lut_linear_init,
                                  precompute_layer, strip_for_inference)
from repro_torch.device import resolve_device
from .config import ModelConfig
from .layers import attention, mlp, rms_norm
from .mamba2 import init_mamba2, mamba2_block, mamba2_decode
from .moe import init_moe, moe_ffn

Params = Dict[str, Any]


#: The families this port serves: attention blocks with an MLP or an MoE
#: FFN, Mamba2 blocks (ssm), and Mamba2 blocks with one shared attention
#: block (hybrid). audio and vlm wait for queue A item 9.
FAMILIES = ("dense", "moe", "ssm", "hybrid")
#: The families whose state is recurrent and kept slot by slot.
RECURRENT = ("ssm", "hybrid")


class Model:
    """A dense, MoE, SSM or hybrid decoder on ``device`` (default the CUDA
    card; raises when there is none)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet: ROADMAP.md "
                "queue A item 9 (Other families)")
        if cfg.head_layout != "heads":
            raise NotImplementedError(
                "head_layout='hd' (the head_dim-major layout that shards "
                "attention) is not ported: ROADMAP.md queue A item 11 "
                "(Scale-out)")
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

    def _init_attn(self, gen, qc: QuantConfig) -> Params:
        cfg = self.cfg
        d, hd = cfg.d_model, cfg.head_dim
        h, kvh = cfg.num_heads, cfg.num_kv_heads
        return {
            "wq": self._init_proj(gen, d, h * hd, qc, cfg.qkv_bias),
            "wk": self._init_proj(gen, d, kvh * hd, qc, cfg.qkv_bias),
            "wv": self._init_proj(gen, d, kvh * hd, qc, cfg.qkv_bias),
            "wo": self._init_proj(gen, h * hd, d, qc),
            "norm": torch.zeros((d,), dtype=self.dtype, device=self.device),
        }

    def _init_mlp(self, gen, qc: QuantConfig) -> Params:
        d, f = self.cfg.d_model, self.cfg.d_ff
        return {
            "wg": self._init_proj(gen, d, f, qc),
            "wu": self._init_proj(gen, d, f, qc),
            "wd": self._init_proj(gen, f, d, qc),
            "norm": torch.zeros((d,), dtype=self.dtype, device=self.device),
        }

    def _init_block(self, gen, qc: QuantConfig) -> Params:
        cfg = self.cfg
        if cfg.family in RECURRENT:
            return init_mamba2(gen, cfg, qc, self.dtype, self.device)
        block = {"attn": self._init_attn(gen, qc)}
        if cfg.family == "moe":
            block["moe"] = init_moe(gen, cfg, qc, self.dtype, self.device)
        else:
            block["mlp"] = self._init_mlp(gen, qc)
        return block

    def init(self, generator: torch.Generator,
             qc: QuantConfig = DENSE) -> Params:
        """Random params from ``generator`` (a generator on this model's
        device), built on the device layer by layer. In lut_train every
        projection holds its dense weight ``w`` and centroids ``z``; in
        lut_infer its LUT and no dense weight."""
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
        if cfg.family == "hybrid":
            params["shared_attn"] = {"attn": self._init_attn(generator, qc),
                                     "mlp": self._init_mlp(generator, qc)}
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
                    q_offset, kv: Params, phys: Optional[torch.Tensor],
                    write, kv_start: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """The layer loop: attention (reading layer li of the pool, or of
        a dense cache when ``phys`` is None) then the MLP or the MoE FFN
        (whose load-balancing loss serving drops, as the JAX entry points
        do), with ``write(li, k_new, v_new)`` storing the layer's fresh
        rows once its attention has read the pool."""
        cb = kv.get(CODEBOOK_KEY)
        for li, (p_l, win) in enumerate(zip(params["blocks"],
                                            self._windows())):
            cb_l = (None if cb is None
                    else {key: leaf[li] for key, leaf in cb.items()})
            a, k_new, v_new = attention(p_l["attn"], x, self.cfg, qc,
                                        q_offset, kv["k"][li], kv["v"][li],
                                        phys, window=win, codebook=cb_l,
                                        kv_start=kv_start)
            write(li, self._encode_rows(cb_l, "k", k_new),
                  self._encode_rows(cb_l, "v", v_new))
            x = x + a
            if "moe" in p_l:
                x = x + moe_ffn(p_l["moe"], x, self.cfg, qc)[0]
            else:
                x = x + mlp(p_l["mlp"], x, self.cfg, qc)
        return x

    def _attn_slot_list(self) -> List[int]:
        """Hybrid: the shared block's invocation index after each layer
        (-1 = none): after every ``shared_attn_every``-th layer."""
        cfg = self.cfg
        slots, s = [], 0
        for i in range(cfg.num_layers):
            if cfg.shared_attn_every and (i % cfg.shared_attn_every
                                          == cfg.shared_attn_every - 1):
                slots.append(s)
                s += 1
            else:
                slots.append(-1)
        return slots

    @property
    def num_attn_slots(self) -> int:
        return sum(1 for s in self._attn_slot_list() if s >= 0)

    def _run_recurrent(self, params: Params, x: torch.Tensor,
                       qc: QuantConfig, read_state, merge, attn_rows=None,
                       write_attn=None, valid_len: Optional[int] = None,
                       q_offset=None) -> torch.Tensor:
        """The SSM / hybrid layer loop over slot state.

        ``read_state(li)`` gives layer li's {"conv": (B, K-1, C), "h": (B,
        H, P, N)} for the lanes of this call and ``merge(li, new)`` stores
        its new state. A prefill chunk (S > 1) runs ``mamba2_block`` with
        ``valid_len``, a decode step ``mamba2_decode``. The hybrid's shared
        attention block runs after every ``shared_attn_every``-th layer:
        ``attn_rows(inv)`` gives the invocation's cached (k, v) rows (B,
        T, KVH, HD), read with ``q_offset`` as ``layers.attention`` reads a
        dense cache, and ``write_attn(inv, k_new, v_new)`` stores the
        fresh rows once they have been read. Returns the residual
        stream."""
        cfg = self.cfg
        decode = torch.is_tensor(q_offset)        # per-lane positions
        shared = params.get("shared_attn")
        for li, (p_l, inv) in enumerate(zip(params["blocks"],
                                            self._attn_slot_list())):
            if decode:
                o, new = mamba2_decode(p_l, x, cfg, qc, read_state(li))
            else:
                o, new = mamba2_block(p_l, x, cfg, qc, read_state(li),
                                      valid_len=valid_len)
            merge(li, new)
            x = x + o
            if cfg.family == "hybrid" and inv >= 0:
                a, k_new, v_new = attention(shared["attn"], x, cfg, qc,
                                            q_offset, *attn_rows(inv), None)
                write_attn(inv, k_new, v_new)
                x = x + a
                x = x + mlp(shared["mlp"], x, cfg, qc)
        return x

    # ------------------------------------------------------------------
    # train forward + loss
    # ------------------------------------------------------------------
    def _train_layer(self, p_l: Params, li: int, shared: Optional[Params],
                     qc: QuantConfig, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Layer ``li`` over whole sequences: x -> (x, its recon loss, its
        MoE load-balancing loss), both float32 scalars."""
        cfg = self.cfg
        recon: List[torch.Tensor] = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in RECURRENT:
            o, _ = mamba2_block(p_l, x, cfg, qc, recon=recon)
            x = x + o
            if cfg.family == "hybrid" and self._attn_slot_list()[li] >= 0:
                a, _, _ = attention(shared["attn"], x, cfg, qc, 0, None,
                                    None, None, recon=recon)
                x = x + a
                x = x + mlp(shared["mlp"], x, cfg, qc, recon)
        else:
            a, _, _ = attention(p_l["attn"], x, cfg, qc, 0, None, None,
                                None, window=self._windows()[li],
                                recon=recon)
            x = x + a
            if "moe" in p_l:
                f, aux = moe_ffn(p_l["moe"], x, cfg, qc, recon)
            else:
                f = mlp(p_l["mlp"], x, cfg, qc, recon)
            x = x + f
        r = (torch.stack(recon).sum() if recon
             else torch.zeros((), dtype=torch.float32, device=x.device))
        return x, r, aux

    def forward(self, params: Params, batch: Dict, qc: QuantConfig = DENSE
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Logits of whole sequences: batch ``{"tokens": (B, S) int}`` ->
        (logits (B, S, V), {"recon", "moe_aux"}: float32 scalars summed
        over the layers)."""
        x = self._embed(params, batch["tokens"])
        recon = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        shared = params.get("shared_attn")
        for li, p_l in enumerate(params["blocks"]):
            layer = functools.partial(self._train_layer, p_l, li, shared, qc)
            if self.cfg.remat:
                x, r, a = checkpoint(layer, x, use_reentrant=False)
            else:
                x, r, a = layer(x)
            recon = recon + r
            aux = aux + a
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x), {"recon": recon, "moe_aux": aux}

    def loss(self, params: Params, batch: Dict, qc: QuantConfig = DENSE
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy (float32) + ``qc.recon_weight`` x the
        recon loss + 0.01 x the MoE load-balancing loss. Returns (total,
        {"ce", "recon", "moe_aux", "loss"})."""
        logits, aux = self.forward(params, batch, qc)
        labels = batch["tokens"][:, 1:].long()
        lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
        ce = -torch.gather(lp, -1, labels[..., None])[..., 0].mean()
        total = (ce + qc.recon_weight * aux["recon"]
                 + 0.01 * aux["moe_aux"])
        return total, {"ce": ce, "recon": aux["recon"],
                       "moe_aux": aux["moe_aux"], "loss": total}

    # ------------------------------------------------------------------
    # dense-cache serving (the batch-to-completion engine)
    # ------------------------------------------------------------------
    def init_cache(self, batch_size: int, max_seq: int,
                   dtype=None) -> Params:
        """A dense cache ``{"layers": {"k": (L, B, T, KVH, HD), "v": ...},
        "pos": 0}`` on this model's device."""
        cfg = self.cfg
        if cfg.family in RECURRENT:
            raise NotImplementedError(
                "the dense-cache API serves the batch-to-completion engine, "
                f"which refuses the {cfg.family!r} family; it serves "
                "through the continuous Engine (init_paged_cache with "
                "num_slots)")
        shape = (cfg.num_layers, batch_size, max_seq, cfg.num_kv_heads,
                 cfg.head_dim)
        dtype = dtype or self.dtype
        return {"layers": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device)},
            "pos": 0}

    def prefill(self, params: Params, batch: Dict, cache: Params,
                qc: QuantConfig = DENSE, pad_lens=None):
        """Prefill whole prompts into a dense cache from row 0.

        Args:
          batch: ``{"tokens": (B, S) int32}``; prompts LEFT-padded
            (right-aligned) to S, the batch-to-completion convention.
          cache: from :meth:`init_cache`; rows [0, S) are written in place.
          pad_lens: optional (B,) int32 pad width of each row; cache rows
            < pad_lens[b] are masked out of row b's attention.

        Returns (logits (B, V) at the last position, cache with pos = S).
        """
        tokens = batch["tokens"]
        s = tokens.shape[1]
        layers = cache["layers"]

        def write(li, k_new, v_new):
            layers["k"][li, :, :s] = k_new
            layers["v"][li, :, :s] = v_new

        x = self._run_blocks(params, self._embed(params, tokens), qc, 0,
                             layers, None, write, kv_start=pad_lens)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x)[:, 0], {"layers": layers, "pos": s}

    def decode(self, params: Params, tokens: torch.Tensor, cache: Params,
               qc: QuantConfig = DENSE, pad_lens=None):
        """One decode step of every row at the cache's position.

        tokens (B, 1) int32; pad_lens as in :meth:`prefill` (the left
        padding stays masked). The new row is written in place at
        ``cache["pos"]``. Returns (logits (B, V), cache with pos + 1).
        """
        pos = cache["pos"]
        layers = cache["layers"]
        if pos >= layers["k"].shape[2]:
            raise ValueError(f"decode at row {pos} runs past the cache's "
                             f"{layers['k'].shape[2]} rows")

        def write(li, k_new, v_new):
            layers["k"][li, :, pos] = k_new[:, 0]
            layers["v"][li, :, pos] = v_new[:, 0]

        x = self._run_blocks(params, self._embed(params, tokens), qc, pos,
                             layers, None, write, kv_start=pad_lens)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x)[:, 0], {"layers": layers,
                                             "pos": pos + 1}

    # ------------------------------------------------------------------
    # paged serving (continuous batching; see repro_torch/serve/)
    # ------------------------------------------------------------------
    def init_paged_cache(self, max_seq: int, page_size: int,
                         num_pages: int, dtype=None, codebook=None,
                         num_slots: Optional[int] = None) -> Params:
        """The page pool ``{"k": (L, num_pages+1, page_size, KVH, HD),
        "v": ...}`` on this model's device; the extra last page is the
        trash page that absorbs writes of lanes that are not live.

        codebook: optional :class:`~repro_torch.core.kv_codebook.KVCodebook`
        -- the pool then holds uint8 codes ``(L, num_pages+1, page_size,
        KVH, nc)`` and the cache carries its own copy of the codebook's
        leaves under ``CODEBOOK_KEY``, on this model's device.

        The SSM and hybrid families (whose state is O(1) a sequence) take
        ``num_slots`` instead of pages: ``{"conv": (L, num_slots, K-1, C),
        "h": (L, num_slots, H, P, N) float32}``, and for the hybrid
        ``{"mamba": {...}, "attn": {"k", "v": (n_inv, num_slots,
        max_seq+1, KVH, HD)}}``, whose extra last row is the trash row
        that absorbs writes of lanes that are not decoding (rows >= a
        slot's position are never read). They take no codebook."""
        cfg = self.cfg
        l, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        if cfg.family in RECURRENT:
            return self._init_slot_state(max_seq, num_slots, dtype, codebook)
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

    def _init_slot_state(self, max_seq: int, num_slots: Optional[int],
                         dtype, codebook) -> Params:
        cfg = self.cfg
        if codebook is not None:
            raise NotImplementedError(
                "KV quantization applies to paged attention pools only; "
                f"the {cfg.family!r} family has recurrent state")
        if num_slots is None:
            raise ValueError(f"the {cfg.family!r} family keeps its state "
                             "slot by slot: pass num_slots")
        dtype = dtype or self.dtype
        dev = self.device
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        l = cfg.num_layers
        mamba = {
            "conv": torch.zeros((l, num_slots, cfg.ssm_conv - 1, conv_dim),
                                dtype=dtype, device=dev),
            "h": torch.zeros((l, num_slots, cfg.ssm_nheads, cfg.ssm_headdim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=dev)}
        if cfg.family == "ssm":
            return mamba
        shape = (self.num_attn_slots, num_slots, max_seq + 1,
                 cfg.num_kv_heads, cfg.head_dim)
        return {"mamba": mamba,
                "attn": {"k": torch.zeros(shape, dtype=dtype, device=dev),
                         "v": torch.zeros(shape, dtype=dtype, device=dev)}}

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
            start position (any position: the chunk's pad rows may run
            past max_seq, its real rows may not).

        Returns logits (1, V) at the last real token.

        The SSM and hybrid families ignore ``page_table``: the chunk reads
        and writes ``slot``'s recurrent state in ``kv``
        (:meth:`_prefill_slot_state`).
        """
        if self.cfg.family in RECURRENT:
            x = self._prefill_slot_state(params, tokens, kv, slot, pos,
                                         valid_len, qc)
            x_last = rms_norm(x[:, valid_len - 1:valid_len],
                              params["final_norm"], self.cfg.norm_eps)
            return self._head(params, x_last)[:, 0]
        trash = kv["k"].shape[1] - 1
        ps = kv["k"].shape[2]
        # a chunk may start anywhere (a prefix hit, a shrunk prefill
        # budget), so its padded width may run past max_seq: its real rows
        # are computed as a cold prefill would and its pad rows are
        # written nowhere; only real rows past max_seq are an error
        if pos + valid_len > page_table.shape[1] * ps:
            raise ValueError(f"rows [{pos}, {pos + valid_len}) run past "
                             f"max_seq {page_table.shape[1] * ps}")
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
        The SSM and hybrid families ignore ``page_table``
        (:meth:`_decode_slot_state`).
        """
        if self.cfg.family in RECURRENT:
            x = self._decode_slot_state(params, tokens, kv, positions, qc)
            x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
            return self._head(params, x)[:, 0]
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

        Attention families only: Mamba2 (and hybrid) recurrent state is
        one evolving tensor a slot, which cannot roll back rejected draft
        tokens.
        """
        if self.cfg.family in RECURRENT:
            raise NotImplementedError(
                "verify_paged needs rewindable (paged) KV state; the "
                f"{self.cfg.family!r} family's recurrent state cannot roll "
                "back rejected draft tokens")
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

    # ------------------------------------------------------------------
    # slot state (the SSM and hybrid families)
    # ------------------------------------------------------------------
    def _prefill_slot_state(self, params: Params, tokens: torch.Tensor,
                            kv: Params, slot: int, pos: int, valid_len: int,
                            qc: QuantConfig) -> torch.Tensor:
        """One prefill chunk over ``slot``'s recurrent state. The first
        chunk of a new occupant (``pos == 0``) reads zeros, never the last
        occupant's state: that is how a slot is recycled. The chunk's
        pads are recurrence-neutral (``mamba2_block``'s ``valid_len``);
        the hybrid's shared attention reads the slot's rows [0, pos) and
        writes the chunk's real rows at [pos, pos + valid_len)."""
        hybrid = self.cfg.family == "hybrid"
        mamba = kv["mamba"] if hybrid else kv

        def read_state(li):
            return {key: (mamba[key][li, slot:slot + 1] if pos > 0 else
                          torch.zeros_like(mamba[key][li, slot:slot + 1]))
                    for key in ("conv", "h")}

        def merge(li, new):
            for key in ("conv", "h"):
                mamba[key][li, slot] = new[key][0]

        attn_rows = write_attn = None
        if hybrid:
            attn = kv["attn"]
            max_seq = attn["k"].shape[2] - 1          # the last is trash
            if pos + valid_len > max_seq:
                raise ValueError(f"rows [{pos}, {pos + valid_len}) run "
                                 f"past max_seq {max_seq}")

            def attn_rows(inv):
                return (attn["k"][inv, slot:slot + 1],
                        attn["v"][inv, slot:slot + 1])

            def write_attn(inv, k_new, v_new):
                attn["k"][inv, slot, pos:pos + valid_len] = \
                    k_new[0, :valid_len]
                attn["v"][inv, slot, pos:pos + valid_len] = \
                    v_new[0, :valid_len]

        return self._run_recurrent(
            params, self._embed(params, tokens), qc, read_state, merge,
            attn_rows, write_attn, valid_len=valid_len, q_offset=pos)

    def _decode_slot_state(self, params: Params, tokens: torch.Tensor,
                           kv: Params, positions: torch.Tensor,
                           qc: QuantConfig) -> torch.Tensor:
        """One decode step of every lane over the slot state. Every lane
        is computed, but only the decoding ones (``positions >= 0``) take
        their new state: a lane mid-prefill carries real state between two
        chunks, so each layer's update is a per-lane select. The hybrid's
        fresh K/V row goes to row ``positions[b]`` of the slot, or to the
        trash row for a lane that is not decoding."""
        hybrid = self.cfg.family == "hybrid"
        mamba = kv["mamba"] if hybrid else kv
        live = positions >= 0

        def read_state(li):
            return {key: mamba[key][li] for key in ("conv", "h")}

        def merge(li, new):
            for key in ("conv", "h"):
                old = mamba[key][li]
                mask = live.reshape((-1,) + (1,) * (old.dim() - 1))
                old.copy_(torch.where(mask, new[key].to(old.dtype), old))

        attn_rows = write_attn = None
        if hybrid:
            attn = kv["attn"]
            trash_row = attn["k"].shape[2] - 1
            lanes = torch.arange(tokens.shape[0], device=self.device)
            row = torch.where(live, positions,
                              torch.full_like(positions, trash_row)).long()

            def attn_rows(inv):
                return attn["k"][inv], attn["v"][inv]

            def write_attn(inv, k_new, v_new):
                attn["k"][inv, lanes, row] = k_new[:, 0]
                attn["v"][inv, lanes, row] = v_new[:, 0]

        return self._run_recurrent(
            params, self._embed(params, tokens), qc, read_state, merge,
            attn_rows, write_attn, q_offset=positions)
