"""Continuous-batching serving engine over the paged KV pool (port of the
core of ``repro.serve.engine.Engine``).

  * slot scheduling: a request is admitted the moment a slot frees,
    mid-decode included (``SlotScheduler``);
  * chunked prefill: prompts go through in right-padded chunks of
    ``prefill_chunk`` tokens, one chunk interleaved with each decode step,
    so a long prompt never stalls the running requests;
  * paged KV: attention KV lives in fixed-size pages with per-slot page
    tables (``PagedKVCache``), so memory scales with live tokens;
  * per-slot positions: one ``decode_paged`` call advances every decoding
    slot at its own sequence length;
  * one host read per decode step (the sampled token ids), counted in
    ``device_reads``.

Padding: prompts are RIGHT-padded per chunk. Pad positions sit causally
after every real token, only real rows are written to the pool, and decode
masks rows ``>= pos``, so pads are never attended.

The paper's technique enters through ``qc``: with ``mode="lut_infer"``
every projection runs assignment + LUT lookup (kernel B1, or B3 then B4
under ``fuse=False``) instead of a dense GEMM; the LUTs must already be in
``params``. With ``kv_quant="vq"`` the page pool holds uint8 codebook
indices (kernel B5 reads them); the engine fits the codebook itself from
a fixed calibration prefill unless the caller passes one.

With ``spec_decode=SpecConfig(...)`` the engine decodes speculatively
(``serve/speculative.py``): a drafter proposes up to ``k`` tokens per
decoding slot, one ``verify_paged`` call scores them, and the accepted
prefix plus one target token is emitted; greedy output stays
token-identical to non-speculative decoding.

Not ported yet (ROADMAP.md queue A): prefix caching and copy-on-write,
deadlines, load shedding and the degradation ladder, observability, the
tensor-parallel mesh, and the batch-to-completion baseline engine.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.kv_codebook import KVCodebook
from repro_torch.core.lut import DENSE, QuantConfig
from .kv_cache import PagedKVCache, PagePoolExhausted
from .scheduler import FinishReason, Request, SlotPhase, SlotScheduler
from .speculative import SpecConfig, accept_tokens


def _sample_tokens(logits: torch.Tensor, temps: Optional[Sequence[float]],
                   generators: Sequence[torch.Generator]) -> torch.Tensor:
    """One token id per row of ``logits`` (B, V), on the device.

    Greedy (argmax, lowest index on ties) where the row's temperature is
    <= 0, a categorical draw over ``softmax(logits / T)`` from the row's
    own generator elsewhere. ``temps`` None = the whole batch is greedy
    (no generator advances). Per-row generators are the per-slot streams:
    identical requests in different slots draw different samples. The
    streams will not reproduce the JAX package's bits.
    """
    out = torch.argmax(logits, dim=-1)
    if temps is None:
        return out
    for i, t in enumerate(temps):
        if t > 0.0:
            probs = torch.softmax(logits[i].float() / t, dim=-1)
            out[i] = torch.multinomial(probs, 1, generator=generators[i])[0]
    return out


def calibration_rows(model, params, qc: QuantConfig, max_seq: int,
                     page_size: int):
    """The K/V rows a KV codebook is fit on: (L, t, KVH, HD) each.

    The fixed token ramp ``(arange(t) * 31 + 7) % vocab``, t = min(128,
    max_seq), as the JAX engine feeds it, goes through one fp paged
    prefill chunk into a scratch one-slot pool (the port has no
    dense-cache prefill); the rows it writes are the sample. No random
    stream is involved.
    """
    cfg, dev = model.cfg, model.device
    t = min(128, max_seq)
    n_pages = -(-t // page_size)
    tokens = (torch.arange(t, dtype=torch.int32, device=dev) * 31 + 7
              ) % cfg.vocab_size
    kv = model.init_paged_cache(n_pages * page_size, page_size, n_pages)
    table = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    model.prefill_paged(params, tokens[None], kv, table, 0, 0, t, qc)

    def rows(pages):               # (L, P+1, page, KVH, HD) -> (L, t, ...)
        return pages[:, :n_pages].reshape(
            cfg.num_layers, n_pages * page_size, *pages.shape[3:])[:, :t]
    return rows(kv["k"]), rows(kv["v"])


class Engine:
    """Continuous-batching engine over a paged KV cache.

    Args:
      model: ``repro_torch.models.model.Model``; the engine runs on its
        device.
      params: model params (LUTs precomputed for ``qc.mode == "lut_infer"``).
      qc: quantisation operating point threaded through every projection.
      batch_size: number of slots (max concurrently running requests).
      max_seq: per-slot sequence capacity (rounded up to a page multiple).
      eos_id: optional stop token.
      seed: seeds the per-slot sampling generators.
      page_size: tokens per KV page.
      num_pages: physical pool size; default ``slots x pages_per_slot``.
        A smaller pool admits fewer concurrent tokens and may preempt.
      prefill_chunk: static prefill chunk width (must divide max_seq).
      kv_codebook: the KV codebook of a ``kv_quant="vq"`` engine; None
        fits one (:meth:`_fit_kv_codebook`). Passing one without
        ``kv_quant="vq"`` is an error.
      spec_decode: optional :class:`~repro_torch.serve.speculative.
        SpecConfig` enabling self-speculative decoding: a drafter (the
        target's own weights through a draft operating point or an
        early-exit prefix, or host-side n-gram lookup) proposes up to
        ``k`` tokens per decoding slot and ONE ``verify_paged`` call
        scores them, emitting 1 to ``k+1`` tokens per round. Greedy
        output stays token-identical to non-speculative decoding;
        temperature slots take rejection sampling with the residual
        correction. The degradation ladder that turns speculation off
        under page pressure (``MODE_NO_SPEC``) is not ported yet
        (ROADMAP.md queue A item 6): a speculative engine speculates
        every round, and shrinks a slot's lookahead only when the pool
        cannot hold it.
    """

    def __init__(self, model, params, qc: QuantConfig = DENSE,
                 batch_size: int = 8, max_seq: int = 512,
                 eos_id: Optional[int] = None, seed: int = 0,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 32,
                 kv_codebook: Optional[KVCodebook] = None,
                 spec_decode: Optional[SpecConfig] = None):
        self.model = model
        self.params = params
        self.qc = qc
        self.device = model.device
        self.num_slots = batch_size
        max_seq = -(-max_seq // page_size) * page_size
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.prefill_chunk = max(2, min(prefill_chunk, max_seq))
        if max_seq % self.prefill_chunk:
            raise ValueError(
                f"prefill_chunk ({self.prefill_chunk}) must divide "
                f"max_seq ({max_seq})")
        self.page_size = page_size
        self.kv_codebook = kv_codebook
        if qc.kv_quant == "vq":
            if self.kv_codebook is None:
                self.kv_codebook = self._fit_kv_codebook()
        elif kv_codebook is not None:
            raise ValueError(
                "kv_codebook supplied but qc.kv_quant is 'none' — set "
                "qc = qc.replace(kv_quant='vq') to serve quantized")
        self.kv = PagedKVCache(model, self.num_slots, max_seq,
                               page_size=page_size, num_pages=num_pages,
                               codebook=self.kv_codebook)
        self.scheduler = SlotScheduler(self.num_slots)
        self.step_count = 0
        self.device_reads = 0
        self._gens = [torch.Generator(device=self.device).manual_seed(
            seed * 1_000_003 + i) for i in range(self.num_slots)]
        # speculative decoding: verify calls, proposals scored, proposals
        # accepted, tokens emitted by rounds
        self.spec = spec_decode
        self.drafter = None
        self.spec_rounds = self.spec_drafted = 0
        self.spec_accepted = self.spec_emitted = 0
        if spec_decode is not None:
            if spec_decode.k < 1:
                raise ValueError(f"spec_decode.k must be >= 1, got "
                                 f"{spec_decode.k}")
            self._spec_rng = np.random.default_rng(seed)
            self.drafter = spec_decode.build_drafter()
            self.drafter.bind(self)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        """Enqueue a request; it is admitted as soon as a slot and pages
        free. Raises :class:`PagePoolExhausted` at once if its prompt
        could never be served."""
        self.kv.table.check_admissible(len(req.tokens) + len(req.out_tokens))
        self.scheduler.submit(req)

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests to completion."""
        for r in requests:
            self.submit(r)
        self.run_until_idle()
        return requests

    def run_until_idle(self) -> None:
        """Step until queue and slots are empty."""
        while self.scheduler.has_work:
            if not self.step():
                raise RuntimeError("engine made no progress with work "
                                   f"pending ({self.kv.table.occupancy()})")

    def step(self) -> bool:
        """One iteration: admit, one prefill chunk, one decode step.
        Returns False when there was nothing to do."""
        self.scheduler.admit(self.kv)
        progressed = False
        slot = self.scheduler.next_prefill()
        if slot is not None:
            self._prefill_chunk_step(slot)
            progressed = True
        if self.scheduler.decode_slots():
            if self.spec is not None:
                self._spec_decode_step()
            else:
                self._decode_step()
            progressed = True
        self.step_count += 1
        return progressed

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    def _fit_kv_codebook(self) -> KVCodebook:
        """Fit the KV codebook on :func:`calibration_rows` (k-means seeded
        with 0: a restart fits the same codebook)."""
        k_rows, v_rows = calibration_rows(self.model, self.params, self.qc,
                                          self.max_seq, self.page_size)
        return KVCodebook.fit(
            k_rows, v_rows, v=self.qc.kv_v, c=self.qc.kv_c,
            generator=torch.Generator(device=self.device).manual_seed(0))

    def _device_read(self, t: Union[torch.Tensor, Tuple[torch.Tensor, ...]]):
        """THE device -> host transfer of the step loop (one per decode
        step, one per finished prefill; a speculative round's draft ids
        and verify ids), counted in ``device_reads``. A tuple of tensors
        is one read and gives a tuple of arrays."""
        self.device_reads += 1
        if isinstance(t, tuple):
            return tuple(x.cpu().numpy() for x in t)
        return t.cpu().numpy()

    def _reserve_lookahead(self, slot_idx: int, pos: int, kk: int) -> int:
        """Reserve pages for ``kk`` draft tokens past the pending one,
        shrinking ``kk`` instead of preempting when the pool runs short
        (speculation is opportunistic). Returns the reserved lookahead."""
        while kk > 0:
            try:
                self.kv.table.ensure(slot_idx, pos + kk + 1)
                return kk
            except PagePoolExhausted:
                kk -= 1
        return 0

    def _ensure_pages(self, slot_idx: int, n_tokens: int) -> None:
        """Grow a slot to n_tokens, preempting other slots if needed."""
        while True:
            try:
                self.kv.table.ensure(slot_idx, n_tokens)
                return
            except PagePoolExhausted:
                if self.scheduler.preempt_youngest(
                        self.kv, exclude=slot_idx) is None:
                    raise

    def _grow_or_shed(self, s) -> None:
        """Reserve the page for slot ``s``'s next write, preempting other
        slots if needed. Once no other slot is left to preempt, the pool
        can never hold this sequence: the request finishes truncated (its
        last sampled token is already in out_tokens)."""
        try:
            self._ensure_pages(s.idx, s.pos + 1)
        except PagePoolExhausted:
            s.req.finish(FinishReason.TRUNCATED)
            self.scheduler.evict(s, self.kv)

    def _prefill_chunk_step(self, slot) -> None:
        c = self.prefill_chunk           # static chunk width
        chunk = self.scheduler.prompt_chunk(slot, c)
        valid = len(chunk)
        toks = np.zeros((1, c), np.int32)
        toks[0, :valid] = chunk
        logits = self.model.prefill_paged(
            self.params, torch.from_numpy(toks).to(self.device),
            self.kv.data, self.kv.table_device(), slot.idx, slot.pos, valid,
            self.qc)
        slot.pos += valid
        if slot.pos < slot.prefill_len:
            return
        temp = slot.req.temperature
        tok = _sample_tokens(logits, [temp] if temp > 0.0 else None,
                             [self._gens[slot.idx]])
        tok = int(self._device_read(tok)[0])
        self.scheduler.finish_prefill(slot, tok)
        self._record_token(slot, tok)

    def _decode_step(self) -> None:
        for s in list(self.scheduler.decode_slots()):
            if s.phase is not SlotPhase.DECODE:
                continue          # preempted by an earlier ensure this loop
            self._grow_or_shed(s)
        dslots = self.scheduler.decode_slots()
        if not dslots:
            return
        b = self.num_slots
        toks = np.zeros((b, 1), np.int32)
        # -1 marks lanes that are NOT decoding this step (free slots and
        # slots mid-prefill): their KV writes go to the trash page.
        positions = np.full((b,), -1, np.int32)
        temps = np.zeros((b,), np.float32)
        for s in dslots:
            toks[s.idx, 0] = s.next_token
            positions[s.idx] = s.pos
            temps[s.idx] = s.req.temperature
        logits = self.model.decode_paged(
            self.params, torch.from_numpy(toks).to(self.device),
            self.kv.data, self.kv.table_device(),
            torch.from_numpy(positions).to(self.device), self.qc)
        nxt = self._device_read(_sample_tokens(
            logits, temps if (temps > 0.0).any() else None, self._gens))
        for s in dslots:
            s.pos += 1
            self._record_token(s, int(nxt[s.idx]))

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target accepted (0.0 before any
        verify round)."""
        return self.spec_accepted / self.spec_drafted \
            if self.spec_drafted else 0.0

    @property
    def tokens_per_verify(self) -> float:
        """Mean tokens emitted per verify call, summed over the call's
        slots (as many as decoding slots = no speculation win; 0.0 before
        any round)."""
        return self.spec_emitted / self.spec_rounds \
            if self.spec_rounds else 0.0

    def _spec_decode_step(self) -> None:
        """One draft / verify round over every decoding slot, in place of
        :meth:`_decode_step`: the drafter proposes up to ``k`` tokens per
        slot, ONE ``verify_paged`` call scores them (k+1 columns; slots
        that drafted fewer pad with trash-bound columns), and the accepted
        prefix plus one target token is recorded. The argmax is taken on
        the device: a greedy round reads only the draft ids (model
        drafter) and the verify ids; the logits come to the host only
        when a slot samples. Rejected rows roll back: ``slot.pos`` does
        not advance over them and :meth:`PagedKVCache.trim` frees the
        tail pages the rejected lookahead no longer needs."""
        for s in list(self.scheduler.decode_slots()):
            if s.phase is not SlotPhase.DECODE:
                continue
            self._grow_or_shed(s)
        dslots = self.scheduler.decode_slots()
        if not dslots:
            return
        k = self.spec.k
        # the lookahead is capped by the slot's room and remaining budget;
        # a drafter that writes draft K/V needs its pages before drafting,
        # host-side drafters reserve after proposing
        k_slot = {}
        for s in dslots:
            room = self.max_seq - s.pos - 1
            budget = s.req.max_new_tokens - len(s.req.out_tokens) - 1
            kk = max(0, min(k, room, budget))
            if self.drafter.writes_kv:
                kk = self._reserve_lookahead(s.idx, s.pos, kk)
            k_slot[s.idx] = kk
        g, n_prop, q_rows = self.drafter.propose(self, dslots, k_slot, k)
        if not self.drafter.writes_kv:
            for s in dslots:
                n_prop[s.idx] = self._reserve_lookahead(
                    s.idx, s.pos, int(n_prop[s.idx]))
        b = self.num_slots
        toks = np.zeros((b, k + 1), np.int32)
        posv = np.full((b,), -1, np.int32)
        nlive = np.zeros((b,), np.int32)
        for s in dslots:
            n = int(n_prop[s.idx])
            toks[s.idx, 0] = s.next_token
            toks[s.idx, 1:1 + n] = g[s.idx, :n]
            posv[s.idx] = s.pos
            nlive[s.idx] = n + 1
        dev = self.device
        logits = self.model.verify_paged(
            self.params, torch.from_numpy(toks).to(dev), self.kv.data,
            self.kv.table_device(), torch.from_numpy(posv).to(dev),
            torch.from_numpy(nlive).to(dev), self.qc)
        ids = torch.argmax(logits, dim=-1).to(torch.int32)
        if any(s.req.temperature > 0.0 for s in dslots):
            ids_h, lg = self._device_read((ids, logits.float()))
        else:
            ids_h, lg = self._device_read(ids), None
        self.spec_rounds += 1
        for s in dslots:
            n = int(n_prop[s.idx])
            draft = [int(t) for t in g[s.idx, :n]]
            rows = None if q_rows is None else \
                [q_rows[t][s.idx] for t in range(n)]
            accepted, out = accept_tokens(
                draft, None if lg is None else lg[s.idx, :n + 1],
                s.req.temperature, self._spec_rng, rows,
                targets=ids_h[s.idx, :n + 1])
            self.spec_drafted += n
            self.spec_accepted += accepted
            req = s.req              # _record_token may evict (slot.req=None)
            for tok in out:
                s.pos += 1
                self._record_token(s, tok)
                self.spec_emitted += 1
                if req.done:         # EOS / budget / truncation: drop the rest
                    break
            if not req.done:
                # roll back the rejected lookahead: pages wholly past the
                # committed rows and the pending token's write row return
                self.kv.trim(s.idx, s.pos + 1)

    def _record_token(self, slot, tok: int) -> None:
        """Append a sampled token and apply the eviction rules."""
        req = slot.req
        req.out_tokens.append(tok)
        slot.next_token = tok
        hit_eos = self.eos_id is not None and tok == self.eos_id
        budget_done = len(req.out_tokens) >= req.max_new_tokens
        truncated = slot.pos >= self.max_seq      # no room for another write
        if hit_eos or budget_done or truncated:
            req.finish(FinishReason.COMPLETED if (hit_eos or budget_done)
                       else FinishReason.TRUNCATED)
            self.scheduler.evict(slot, self.kv)
