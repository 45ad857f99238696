"""The decoder (port of ``repro.models.model``: the dense, MoE, SSM,
hybrid, audio and vlm families): ``forward`` and ``loss`` for training,
and the serving entry points, paged for the continuous-batching engine,
dense for the batch-to-completion one.

Params are a plain dict: ``embed``, ``final_norm`` (and ``head`` when
embeddings are untied), and ``blocks``, a list with one dict per layer
(``{"attn": {...}, "mlp": {...}}``, or ``{"attn": {...}, "moe": {...}}``
for the MoE family, ``models/moe.py``; a Mamba2 block for the SSM and
hybrid families, ``models/mamba2.py``). The hybrid family adds
``shared_attn`` (``{"attn", "mlp"}``), one attention + MLP block applied
after every ``shared_attn_every``-th Mamba2 block. Where the JAX package
stacks layers on a leading axis and scans, this port loops over the list.

The audio and vlm families take their inputs from a stubbed frontend, as
the JAX package does. audio (musicgen) has no ``embed``: a batch carries
frame embeddings ``{"embeds": (B, S, D), "labels": (B, S, Q)}``, which
``in_proj`` (D, D) maps into the model, and ``heads`` (Q, D, V) give one
set of logits per codebook, (B, S, Q, V). vlm (paligemma) prepends
``{"patch_embeds": (B, P, D)}`` to the embedded ``tokens`` (B, S); the P
patches attend each other both ways (the prefix-LM mask,
``layers.mask_tile``) and the loss covers the text tokens only.
``in_proj`` and ``heads`` are plain dense products outside any kernel,
as in the JAX package; every block projection runs through B1 (or B3 +
B4) as any family's does.
Both serve through the dense cache only (``prefill`` / ``decode``); the
paged entry points refuse them, as the JAX package's do.

API:
  Model(cfg, device)                                     device="cuda"
  init(generator, qc)                              -> params
  forward(params, batch, qc)                       -> (logits, aux)
  loss(params, batch, qc)                          -> (scalar, metrics)
  init_cache(batch_size, max_seq)                  -> dense cache
  prefill(params, batch, cache, qc, pad_lens=None) -> (logits, cache)
  decode(params, tokens, cache, qc, pad_lens=None) -> (logits, cache)
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
blocks from zero state), each layer checkpointed when ``cfg.remat`` is
set (``parallel.collectives.remat``); in ``lut_train`` it sums every
projection's reconstruction loss, and the MoE family's load-balancing
loss, for ``loss``.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.kv_codebook import CODEBOOK_KEY, kv_encode
from repro_torch.core.lut import (DENSE, QuantConfig, lut_linear_init,
                                  precompute_layer, strip_for_inference)
from repro_torch.device import resolve_device
from repro_torch.parallel.collectives import current as tp_current
from repro_torch.parallel.collectives import remat
from .config import ModelConfig
from .layers import attention, hd_fallback, mlp, rms_norm
from .mamba2 import init_mamba2, mamba2_block, mamba2_decode
from .moe import init_moe, moe_ffn

Params = Dict[str, Any]


#: The families of the JAX package, all ported: attention blocks with an
#: MLP or an MoE FFN, Mamba2 blocks (ssm), Mamba2 blocks with one shared
#: attention block (hybrid), and attention blocks over frame (audio) or
#: patch-prefixed (vlm) inputs.
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")
#: The families whose state is recurrent and kept slot by slot.
RECURRENT = ("ssm", "hybrid")
#: The families whose inputs come from a stubbed frontend (frame or patch
#: embeddings): no token prompts, so no paged serving.
FRONTEND = ("audio", "vlm")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab: int,
                  tp) -> torch.Tensor:
    """Mean cross-entropy in float32 of ``logits`` (..., V') against
    ``labels`` (...). Where V' is the whole ``vocab``, one float32
    ``log_softmax``. Otherwise (vocab-parallel: the rank's columns
    [r V', (r + 1) V') of ``tp``'s rank r) the row max is gathered (a
    constant of the gradient, as ``log_softmax``'s), the sum of
    exponentials all-reduced in rank order, and the label's logit taken
    by the rank that holds it and all-reduced: no rank forms a row of
    the whole vocab, and the gradient flows through the all-reduces."""
    z = logits.float()
    if z.shape[-1] == vocab:
        lp = torch.log_softmax(z, dim=-1)
        return -torch.gather(lp, -1, labels[..., None])[..., 0].mean()
    n = z.shape[-1]
    m = tp.all_gather(z.detach().amax(-1, keepdim=True), -1).amax(
        -1, keepdim=True)
    total = tp.all_reduce(torch.exp(z - m).sum(-1))
    ids = labels - tp.rank * n
    mine = (ids >= 0) & (ids < n)
    zy = torch.gather(z, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    zy = tp.all_reduce(torch.where(mine, zy, torch.zeros_like(zy)))
    return (torch.log(total) + m[..., 0] - zy).mean()


class Model:
    """A decoder of any of :data:`FAMILIES` on ``device`` (default the
    CUDA card; raises when there is none)."""

    def __init__(self, cfg: ModelConfig, device="cuda"):
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; known: "
                             f"{FAMILIES}")
        if cfg.head_layout != "heads":
            raise NotImplementedError(
                "head_layout='hd' (the head_dim-major layout that shards "
                "attention) is not ported: ROADMAP.md queue A item 11 "
                "(Scale-out, its training half)")
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
        lut_infer its LUT and no dense weight. audio has no ``embed`` but
        ``heads`` (Q, D, V) and ``in_proj`` (D, D), dense in every mode
        (no centroids)."""
        cfg, dev = self.cfg, self.device

        def normal(shape, std):
            t = torch.randn(shape, generator=generator, device=dev)
            return (std * t).to(self.dtype)

        params: Params = {
            "final_norm": torch.zeros((cfg.d_model,), dtype=self.dtype,
                                      device=dev)}
        if cfg.family != "audio":
            params["embed"] = normal((cfg.vocab_size, cfg.d_model), 0.02)
        params["blocks"] = [self._init_block(generator, qc)
                            for _ in range(cfg.num_layers)]
        if cfg.family == "hybrid":
            params["shared_attn"] = {"attn": self._init_attn(generator, qc),
                                     "mlp": self._init_mlp(generator, qc)}
        if cfg.family == "audio":
            params["heads"] = normal((cfg.num_codebooks, cfg.d_model,
                                      cfg.vocab_size), 0.02)
            params["in_proj"] = normal((cfg.d_model, cfg.d_model), 0.02)
        elif not cfg.tie_embeddings:
            params["head"] = normal((cfg.d_model, cfg.vocab_size), 0.02)
        return params

    # ------------------------------------------------------------------
    # embedding / head / layer loop
    # ------------------------------------------------------------------
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Token ids (B, S) -> (B, S, D); audio: frame embeddings (B, S,
        D) through ``in_proj``.

        Under tensor parallelism a vocab-sharded ``embed`` (rank r holds
        rows [r n, (r + 1) n)) is looked up where the rank owns the id and
        zero elsewhere, then all-reduced: exactly one rank adds a
        non-zero row, so the sum is the one-device lookup."""
        if self.cfg.family == "audio":
            return tokens.to(self.dtype) @ params["in_proj"]
        emb = params["embed"]
        tp = tp_current()
        if tp.size == 1 or emb.shape[0] == self.cfg.vocab_size:
            return emb[tokens.long()]
        n = emb.shape[0]
        ids = tokens.long() - tp.rank * n
        mine = ((ids >= 0) & (ids < n))[..., None]
        rows = emb[ids.clamp(0, n - 1)]
        return tp.all_reduce(torch.where(mine, rows, torch.zeros_like(rows)))

    def _inputs(self, params: Params, batch: Dict
                ) -> Tuple[torch.Tensor, int]:
        """A whole-sequence batch -> (x (B, S, D), prefix_len): audio's
        ``embeds``; vlm's ``patch_embeds`` (in the model's dtype) before
        its embedded ``tokens``, the P patches the bidirectional prefix;
        the others' ``tokens``."""
        cfg = self.cfg
        if cfg.family == "audio":
            return self._embed(params, batch["embeds"]), 0
        x = self._embed(params, batch["tokens"])
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(self.dtype)
            return torch.cat([patches, x], 1), cfg.num_patches
        return x, 0

    def _head(self, params: Params, x: torch.Tensor,
              gather: bool = True) -> torch.Tensor:
        """Logits. Under tensor parallelism a vocab-sharded head (or tied
        embedding; audio's ``heads`` sharded on V) gives the rank's
        columns: all-gathered in rank order (``gather``), so every rank
        holds the whole row (the reference's replicated output) and the
        engine reads it once, from rank 0; the loss keeps them
        (:func:`cross_entropy`)."""
        if self.cfg.family == "audio":          # one head per codebook
            out = torch.einsum("bsd,qdv->bsqv", x, params["heads"])
        elif self.cfg.tie_embeddings:
            out = x @ params["embed"].T
        else:
            out = x @ params["head"]
        tp = tp_current()
        if gather and tp.size > 1 and out.shape[-1] != self.cfg.vocab_size:
            out = tp.all_gather(out, -1)
        return out

    def _windows(self) -> List[int]:
        cfg = self.cfg
        return [0 if cfg.layer_is_global(i) else cfg.sliding_window
                for i in range(cfg.num_layers)]

    def _run_blocks(self, params: Params, x: torch.Tensor, qc: QuantConfig,
                    q_offset, kv: Params, phys: Optional[torch.Tensor],
                    write, kv_start: Optional[torch.Tensor] = None,
                    prefix_len: int = 0,
                    seq_rows: Optional[int] = None) -> torch.Tensor:
        """The layer loop: attention (reading layer li of the pool, or of
        a dense cache when ``phys`` is None; ``prefix_len`` as
        ``layers.attention`` takes it) then the MLP or the MoE FFN
        (whose load-balancing loss serving drops, as the JAX entry points
        do), with ``write(li, k_new, v_new)`` storing the layer's fresh
        rows (encoded for a code pool) where ``layers.attention`` calls
        it: before it reads a dense cache, after it reads the pool;
        ``seq_rows`` as ``layers.attention`` takes it (a
        sequence-sharded dense cache)."""
        cb = kv.get(CODEBOOK_KEY)
        tp = tp_current()
        # a code pool's codebook is replicated; its per-kv-head scales sk /
        # sv are cut to the rank's heads, or kept whole where the pool is
        # replicated (the head_dim layout: every rank attends every head)
        heads = not hd_fallback(self.cfg, tp.size)
        for li, (p_l, win) in enumerate(zip(params["blocks"],
                                            self._windows())):
            cb_l = (None if cb is None
                    else {key: tp.shard(leaf[li], 0)
                          if heads and key in ("sk", "sv") else leaf[li]
                          for key, leaf in cb.items()})
            def store(k_new, v_new, li=li, cb_l=cb_l):
                write(li, self._encode_rows(cb_l, "k", k_new),
                      self._encode_rows(cb_l, "v", v_new))
            x = x + attention(p_l["attn"], x, self.cfg, qc, q_offset,
                              kv["k"][li], kv["v"][li], phys, window=win,
                              codebook=cb_l, kv_start=kv_start,
                              prefix_len=prefix_len, seq_rows=seq_rows,
                              write=store)
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
        fresh rows where ``layers.attention`` calls it (a prefill chunk's
        before its read, a decode step's after). Returns the residual
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
                x = x + attention(shared["attn"], x, cfg, qc, q_offset,
                                  *attn_rows(inv), None,
                                  write=functools.partial(write_attn, inv))
                x = x + mlp(shared["mlp"], x, cfg, qc)
        return x

    # ------------------------------------------------------------------
    # train forward + loss
    # ------------------------------------------------------------------
    def _train_layer(self, p_l: Params, li: int, shared: Optional[Params],
                     qc: QuantConfig, x: torch.Tensor, prefix_len: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Layer ``li`` over whole sequences: x -> (x, its recon loss, its
        MoE load-balancing loss), both float32 scalars; the first
        ``prefix_len`` positions attend each other both ways."""
        cfg = self.cfg
        recon: List[torch.Tensor] = []
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in RECURRENT:
            o, _ = mamba2_block(p_l, x, cfg, qc, recon=recon)
            x = x + o
            if cfg.family == "hybrid" and self._attn_slot_list()[li] >= 0:
                x = x + attention(shared["attn"], x, cfg, qc, 0, None, None,
                                  None, recon=recon)
                x = x + mlp(shared["mlp"], x, cfg, qc, recon)
        else:
            x = x + attention(p_l["attn"], x, cfg, qc, 0, None, None, None,
                              window=self._windows()[li], recon=recon,
                              prefix_len=prefix_len)
            if "moe" in p_l:
                f, aux = moe_ffn(p_l["moe"], x, cfg, qc, recon)
            else:
                f = mlp(p_l["mlp"], x, cfg, qc, recon)
            x = x + f
        r = (torch.stack(recon).sum() if recon
             else torch.zeros((), dtype=torch.float32, device=x.device))
        return x, r, aux

    def forward(self, params: Params, batch: Dict, qc: QuantConfig = DENSE,
                gather: bool = True
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Logits of whole sequences: batch ``{"tokens": (B, S) int}``
        (audio ``{"embeds": (B, S, D)}``; vlm also ``{"patch_embeds": (B,
        P, D)}``) -> (logits (B, S, V) (audio (B, S, Q, V); vlm over the
        P + S positions), {"recon", "moe_aux"}: float32 scalars summed
        over the layers).

        Inside a rank of a ``parallel.collectives.RankRunner`` over a mesh
        (the sharded train step) ``params`` are the rank's shards and
        ``batch`` its data group's rows: the layers run their collectives,
        the logits come back whole (all-gathered; ``gather=False``: the
        rank's vocab columns, as the loss takes them), ``recon`` is the
        sum of the ranks' shares (one all-reduce over the model axis) and
        ``moe_aux`` the global batch's. With ``cfg.remat`` every rank
        recomputes a layer together in the backward, its collectives run
        again (``parallel.collectives.remat``)."""
        tp = tp_current()
        x, prefix_len = self._inputs(params, batch)
        recon = torch.zeros((), dtype=torch.float32, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        shared = params.get("shared_attn")
        for li, p_l in enumerate(params["blocks"]):
            layer = functools.partial(self._train_layer, p_l, li, shared, qc,
                                      prefix_len=prefix_len)
            x, r, a = remat(layer, x) if self.cfg.remat else layer(x)
            recon = recon + r
            aux = aux + a
        if qc.mode == "lut_train":
            # the ranks' shares of every projection's recon loss
            recon = tp.all_reduce(recon)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return (self._head(params, x, gather),
                {"recon": recon, "moe_aux": aux})

    def loss(self, params: Params, batch: Dict, qc: QuantConfig = DENSE
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy (float32) + ``qc.recon_weight`` x the
        recon loss + 0.01 x the MoE load-balancing loss. Returns (total,
        {"ce", "recon", "moe_aux", "loss"}). audio: every codebook's
        next frame (``labels`` (B, S, Q) shifted by one); vlm: the text
        tokens only, each predicted from the position before it (the last
        patch predicts the first token). Under tensor parallelism the
        logits stay the rank's vocab columns (:func:`cross_entropy`)."""
        cfg = self.cfg
        logits, aux = self.forward(params, batch, qc, gather=False)
        if cfg.family == "audio":
            labels = batch["labels"][:, 1:].long()          # (B, S-1, Q)
            pred = logits[:, :-1]
        elif cfg.family == "vlm":
            labels = batch["tokens"].long()
            pred = logits[:, cfg.num_patches - 1:-1]
        else:
            labels = batch["tokens"][:, 1:].long()
            pred = logits[:, :-1]
        ce = cross_entropy(pred, labels, cfg.vocab_size, tp_current())
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
        "pos": 0}`` on this model's device (a vlm's rows hold its patches,
        then its tokens)."""
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
            audio: ``{"embeds": (B, S, D)}``; vlm: ``{"patch_embeds": (B,
            P, D), "tokens": (B, S)}``, which fill rows [0, P + S).
          cache: from :meth:`init_cache`; the rows are written in place.
          pad_lens: optional (B,) int32 pad width of each row; cache rows
            < pad_lens[b] are masked out of row b's attention. Refused
            for vlm: the mask would hide the image prefix, whose rows come
            first.

        Returns (logits at the last position, (B, V) (audio (B, Q, V)),
        cache with pos = the rows written).

        Inside a rank of a ``parallel.collectives`` runner over a mesh,
        ``params`` are the rank's shards (``serving_layout``) and
        ``cache`` the rank's part of a cache laid out by
        ``parallel.sharding.cache_pspecs`` (``shard_cache``): its batch
        rows when the batch covers the data axes (``batch`` then holds
        those rows), else every row of a slice of the sequence over
        ``data`` (``cache["seq_rows"]``: each data rank writes the prompt
        rows it holds, and decode combines the ranks' softmax triples).
        Where the kv heads do not divide the model axis, the cache holds
        the rank's head_dim slice (``layers.attention``).
        """
        self._check_pad_lens(pad_lens)
        row0 = self._seq_rows(cache)
        x, prefix_len = self._inputs(params, batch)
        s = x.shape[1]
        layers = cache["layers"]
        lo = row0 or 0
        hi = min(lo + layers["k"].shape[2], s)
        if row0 is None and s > layers["k"].shape[2]:
            raise ValueError(f"a prompt of {s} rows runs past the cache's "
                             f"{layers['k'].shape[2]}")

        def write(li, k_new, v_new):
            if hi > lo:         # the prompt rows this rank's cache holds
                layers["k"][li, :, :hi - lo] = k_new[:, lo:hi]
                layers["v"][li, :, :hi - lo] = v_new[:, lo:hi]

        x = self._run_blocks(params, x, qc, 0, layers, None, write,
                             kv_start=pad_lens, prefix_len=prefix_len,
                             seq_rows=row0)
        x = rms_norm(x[:, -1:], params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x)[:, 0], dict(cache, layers=layers,
                                                 pos=s)

    def decode(self, params: Params, tokens: torch.Tensor, cache: Params,
               qc: QuantConfig = DENSE, pad_lens=None):
        """One decode step of every row at the cache's position.

        tokens (B, 1) int32 (audio: frame embeddings (B, 1, D); vlm: text
        token ids); pad_lens as in :meth:`prefill` (the left padding stays
        masked). The new row is written in place at ``cache["pos"]`` (by
        the rank that holds it, in a sequence-sharded cache; layouts as
        :meth:`prefill` takes them). Returns (logits (B, V) (audio (B, Q,
        V)), cache with pos + 1).
        """
        self._check_pad_lens(pad_lens)
        row0 = self._seq_rows(cache)
        pos = cache["pos"]
        layers = cache["layers"]
        rows = layers["k"].shape[2]
        total = rows * (1 if row0 is None else tp_current().over("data").size)
        if pos >= total:
            raise ValueError(f"decode at row {pos} runs past the cache's "
                             f"{total} rows")
        local = pos - (row0 or 0)

        def write(li, k_new, v_new):
            if 0 <= local < rows:   # the rank that holds row pos
                layers["k"][li, :, local] = k_new[:, 0]
                layers["v"][li, :, local] = v_new[:, 0]

        x = self._run_blocks(params, self._embed(params, tokens), qc, pos,
                             layers, None, write, kv_start=pad_lens,
                             seq_rows=row0)
        x = rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return self._head(params, x)[:, 0], dict(cache, layers=layers,
                                                 pos=pos + 1)

    def _seq_rows(self, cache: Params) -> Optional[int]:
        """The global index of this rank's first row of a dense cache
        sharded by sequence over ``data`` (``cache["seq_rows"]``, set by
        ``parallel.sharding.shard_cache``); None for a cache that holds
        every row. The MoE family routes the global batch over the data
        axes, which a sequence-sharded cache's ranks share: refused."""
        row0 = cache.get("seq_rows")
        if row0 is not None and self.cfg.family == "moe":
            raise NotImplementedError(
                "MoE serving over a sequence-sharded dense cache (a batch "
                "smaller than the data axes) is not ported: its routing "
                "gathers the batch over data: ROADMAP.md queue A item 11")
        return row0

    def _check_pad_lens(self, pad_lens) -> None:
        """Refuse left padding on a vlm: the JAX package masks rows <
        pad_lens after the prefix term, so it would mask the image
        prefix, whose rows come first, and attend the pad tokens."""
        if pad_lens is not None and self.cfg.family == "vlm":
            raise NotImplementedError(
                "pad_lens masks the first cache rows, which hold a vlm's "
                "image prefix; the vlm family takes no left padding")

    def _check_paged(self) -> None:
        if self.cfg.family in FRONTEND:
            raise NotImplementedError(
                "paged serving covers token-prompt families only; the "
                f"{self.cfg.family!r} family serves through the dense "
                "cache (prefill / decode)")

    # ------------------------------------------------------------------
    # paged serving (continuous batching; see repro_torch/serve/)
    # ------------------------------------------------------------------
    def init_paged_cache(self, max_seq: int, page_size: int,
                         num_pages: int, dtype=None, codebook=None,
                         num_slots: Optional[int] = None,
                         device=None) -> Params:
        """The page pool ``{"k": (L, num_pages+1, page_size, KVH, HD),
        "v": ...}`` on ``device`` (default this model's; the meta device
        gives the shapes alone); the extra last page is the trash page
        that absorbs writes of lanes that are not live.

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
        dev = self.device if device is None else device
        if cfg.family in RECURRENT:
            return self._init_slot_state(max_seq, num_slots, dtype, codebook,
                                         dev)
        if codebook is not None:
            if (codebook.num_layers, codebook.head_dim) != (l, hd):
                raise ValueError(
                    f"codebook (L={codebook.num_layers}, "
                    f"HD={codebook.head_dim}) does not match model "
                    f"(L={l}, HD={hd})")
            shape = (l, num_pages + 1, page_size, kvh, codebook.nc)
            return {
                "k": torch.zeros(shape, dtype=torch.uint8, device=dev),
                "v": torch.zeros(shape, dtype=torch.uint8, device=dev),
                CODEBOOK_KEY: {key: leaf.to(dev, torch.float32,
                                            copy=True).contiguous()
                               for key, leaf in codebook.tree().items()}}
        shape = (l, num_pages + 1, page_size, kvh, hd)
        dtype = dtype or self.dtype
        return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                "v": torch.zeros(shape, dtype=dtype, device=dev)}

    def _init_slot_state(self, max_seq: int, num_slots: Optional[int],
                         dtype, codebook, dev) -> Params:
        cfg = self.cfg
        if codebook is not None:
            raise NotImplementedError(
                "KV quantization applies to paged attention pools only; "
                f"the {cfg.family!r} family has recurrent state")
        if num_slots is None:
            raise ValueError(f"the {cfg.family!r} family keeps its state "
                             "slot by slot: pass num_slots")
        dtype = dtype or self.dtype
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
        self._check_paged()
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
        tok_pos = pos + torch.arange(valid_len, device=tokens.device)
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
        self._check_paged()
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
        live_page = phys[torch.arange(b, device=tokens.device), pos_c // ps]
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
        self._check_paged()
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
        cols = torch.arange(t_v, device=tokens.device)
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
            lanes = torch.arange(tokens.shape[0], device=tokens.device)
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
