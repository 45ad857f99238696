"""Serving engines (port of ``repro.serve.engine``).

:class:`Engine`, the continuous-batching engine (the default):

  * slot scheduling: a request is admitted the moment a slot frees,
    mid-decode included (``SlotScheduler``), from a priority-ordered,
    optionally bounded queue with deadlines;
  * chunked prefill: prompts go through in right-padded chunks of
    ``prefill_chunk`` tokens, one chunk interleaved with each decode step,
    so a long prompt never stalls the running requests;
  * paged KV: attention KV lives in fixed-size pages with per-slot page
    tables (``PagedKVCache``), so memory scales with live tokens; the
    SSM and hybrid families keep their recurrent state slot by slot
    instead (no pages, no prefix caching, no speculation, no VQ pool);
  * prefix caching (on by default): fully written prompt pages are
    indexed by content, and a later prompt sharing a page-aligned prefix
    maps them read-shared and starts prefill past them; a whole-prompt
    match forks its last page (copy-on-write);
  * the degradation ladder (on by default): as pool pressure rises the
    engine drops speculation, then shrinks the prefill budget, then stops
    admitting, and steps back down with hysteresis;
  * per-slot positions: one ``decode_paged`` call advances every decoding
    slot at its own sequence length;
  * one host read per decode step (the sampled token ids), counted in
    ``device_reads``; every counter lives in an :class:`~repro_torch.obs.
    Obs` registry, and the step's phases are timed and traced there.

:class:`BatchToCompletionEngine`, the fixed-batch baseline: requests go in
fixed batches, prefilled together (left-padded) and decoded until the
longest finishes, over a dense ``(batch, max_seq)`` cache.

Padding: the continuous engine RIGHT-pads prompts per chunk. Pad
positions sit causally after every real token, only real rows are
written to the pool, and decode masks rows ``>= pos``, so pads are never
attended. The batch engine LEFT-pads (right-aligns) prompts so the batch
decodes from one position; pad rows are masked through ``pad_lens``.

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

Every model call runs through a ``parallel.collectives.RankRunner``:
one rank on one device. With ``mesh=`` (``launch.mesh``) the engine
serves tensor-parallel over the mesh's ``model`` axis: params and pool
are one shard a rank (``parallel.sharding``), each model call runs once a
rank in this process, and the page table, the scheduler and the host
read stay single. It serves on the mesh's first
data group (``replica_submeshes(mesh)[0]``): the reference replicates a
TP engine over the data axes, which repeats the same work on every data
group; the way to split data work is ``ReplicaRouter.from_mesh``, one TP
engine a data group.

Not ported yet (ROADMAP.md queue A): the JAX engine's recompile-guard
hooks (``jit_entry_points``) and device-resident temperature buffer,
which have no counterpart without jit (the port samples from host
temperatures and per-slot generators).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.kv_codebook import KVCodebook
from repro_torch.core.lut import DENSE, QuantConfig
from repro_torch.launch.mesh import replica_submeshes
from repro_torch.models.layers import hd_fallback
from repro_torch.models.model import FRONTEND, RECURRENT
from repro_torch.obs import Obs, safe_ratio
from repro_torch.parallel.collectives import RankRunner
from repro_torch.parallel.collectives import current as tp_current
from repro_torch.parallel.sharding import (check_tensor_parallel,
                                           serving_layout, shard_tree)
from .kv_cache import PagedKVCache, PagePoolExhausted
from .scheduler import FinishReason, Request, SlotPhase, SlotScheduler
from .speculative import SpecConfig, accept_tokens

log = logging.getLogger(__name__)

# Degradation ladder: each mode sheds work the engine can live without, in
# order of how cheap the capability is to lose. Pressure is pool occupancy
# (PagedKVCache.pressure).
MODE_NORMAL = 0          # full speculative lookahead, full prefill budget
MODE_NO_SPEC = 1         # speculative lookahead off (spec pages freed)
MODE_SHRINK_PREFILL = 2  # prefill chunk budget cut (decode keeps priority)
MODE_STOP_ADMIT = 3      # no new admissions until pressure clears
MODE_NAMES = ("normal", "no_spec", "shrink_prefill", "stop_admit")


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Pressure thresholds of the engine's degradation ladder.

    Escalation is immediate: the mode jumps to however many thresholds the
    pressure crosses. De-escalation is hysteretic: a mode is re-enabled
    only once pressure drops ``hysteresis`` BELOW the threshold that
    disabled it, so the engine cannot flap at a threshold. ``mode_for``
    is monotone in pressure for a fixed current mode.

    Attributes:
      spec_off: at/above this pressure, speculative lookahead is off
        (draft pages are pure opportunism: first to go).
      chunk_shrink: at/above, the prefill budget is divided by
        ``chunk_divisor`` (floor ``min_chunk``): decode drains pages,
        prefill only adds them.
      admit_stop: at/above, admission stops (waiting requests stay
        queued; the bounded queue sheds overflow by priority).
      hysteresis: re-enable margin below each threshold.
    """
    spec_off: float = 0.80
    chunk_shrink: float = 0.90
    admit_stop: float = 0.97
    hysteresis: float = 0.10
    chunk_divisor: int = 4
    min_chunk: int = 2

    def __post_init__(self):
        t = (self.spec_off, self.chunk_shrink, self.admit_stop)
        if not (0.0 < t[0] <= t[1] <= t[2] <= 1.0):
            raise ValueError(f"thresholds must satisfy 0 < spec_off <= "
                             f"chunk_shrink <= admit_stop <= 1, got {t}")

    def mode_for(self, pressure: float, current: int) -> int:
        """Next degradation mode given the pool pressure and the mode the
        engine is in now (hysteresis needs the history)."""
        thresholds = (self.spec_off, self.chunk_shrink, self.admit_stop)
        up = sum(pressure >= t for t in thresholds)
        down = sum(pressure > t - self.hysteresis for t in thresholds)
        return max(up, min(current, down))


#: The default ladder (frozen, so engines may share it).
DEFAULT_DEGRADATION = DegradationPolicy()


def _observe_request(obs: Obs, req) -> None:
    """Record one finished request into ``obs.metrics`` (idempotent).

    Emits the ``req.finish.*`` tally and the latency families: the step
    clock (TTFT and end-to-end in engine steps, from ``arrival`` /
    ``first_token_step`` / ``finish_step``) and the wall clock (``*_s``
    histograms and TPOT, from the ``*_ts`` ``perf_counter`` stamps); then
    closes the request's trace span. Both engines and the shed, expire and
    truncate paths funnel here."""
    if req.finish_reason is None or getattr(req, "_obs_done", False):
        return
    req._obs_done = True
    m = obs.metrics
    m.counter("req.finish." + req.finish_reason.name.lower(),
              unit="requests").inc()
    if req.arrival is not None:
        if req.first_token_step is not None:
            m.histogram("req.ttft_steps", unit="steps", lo=1.0,
                        hi=1e6).observe(req.first_token_step - req.arrival)
        if req.finish_step is not None:
            m.histogram("req.latency_steps", unit="steps", lo=1.0,
                        hi=1e6).observe(req.finish_step - req.arrival)
    if req.arrival_ts is not None:
        if req.first_token_ts is not None:
            m.histogram("req.ttft_s", unit="s").observe(
                req.first_token_ts - req.arrival_ts)
        if req.finish_ts is not None:
            m.histogram("req.latency_s", unit="s").observe(
                req.finish_ts - req.arrival_ts)
            n_decoded = len(req.out_tokens) - 1
            if n_decoded > 0 and req.first_token_ts is not None:
                m.histogram("req.tpot_s", unit="s").observe(
                    (req.finish_ts - req.first_token_ts) / n_decoded)
    tr = obs.tracer
    if tr.enabled and getattr(req, "_obs_traced", False):
        tr.request_end(req._seq, f"req {req._seq}",
                       {"reason": req.finish_reason.name,
                        "tokens": len(req.out_tokens)})


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


def _slot_generators(device, seed: int, n: int) -> List[torch.Generator]:
    """The per-slot sampling streams of an engine seeded with ``seed``."""
    return [torch.Generator(device=device).manual_seed(seed * 1_000_003 + i)
            for i in range(n)]


def calibration_rows(model, params, qc: QuantConfig, max_seq: int,
                     page_size: int):
    """The K/V rows a KV codebook is fit on: (L, t, KVH, HD) each.

    The fixed token ramp ``(arange(t) * 31 + 7) % vocab``, t = min(128,
    max_seq), as the JAX engine feeds it, goes through one fp paged
    prefill chunk into a scratch one-slot pool; the rows it writes are
    the sample. No random stream is involved.

    Inside a tensor-parallel rank (``params`` its shards) the scratch
    pool holds the rank's kv heads (under the head_dim layout, its
    head_dim slice of every kv head) and the rows are all-gathered over
    them: every rank returns the whole rows, those of one device.
    """
    cfg, tp = model.cfg, tp_current()
    dev = model.device if tp.size == 1 else tp.device
    t = min(128, max_seq)
    n_pages = -(-t // page_size)
    tokens = (torch.arange(t, dtype=torch.int32, device=dev) * 31 + 7
              ) % cfg.vocab_size
    axis = 4 if hd_fallback(cfg, tp.size) else 3
    kv = {key: tp.shard(pages, axis).contiguous() for key, pages in
          model.init_paged_cache(n_pages * page_size, page_size, n_pages,
                                 device=dev).items()}
    table = torch.arange(n_pages, dtype=torch.int32, device=dev)[None]
    model.prefill_paged(params, tokens[None], kv, table, 0, 0, t, qc)

    def rows(pages):               # (L, P+1, page, KVH, HD) -> (L, t, ...)
        return tp.all_gather(pages[:, :n_pages].reshape(
            cfg.num_layers, n_pages * page_size, *pages.shape[3:])[:, :t],
            axis - 1)
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
      mesh: optional :class:`~repro_torch.launch.mesh.Mesh` with a
        trailing ``model`` axis: the engine then serves tensor-parallel
        over the first data group's ranks. Params are placed by
        ``parallel.sharding.serving_layout`` (the JAX ``param_pspecs``;
        the Mamba2 ``in_proj`` / conv in the port's layout), the pool by
        ``serving_cache_layout`` (kv heads over ``model``), and every
        prefill chunk, decode step and verify call runs once a rank
        (``parallel.collectives``): column-parallel projections run their
        kernel on the rank's columns, row-parallel ones all-reduce
        partial sums, the embedding and head are vocab-parallel and the
        MoE experts expert-parallel. The logits are all-gathered, and the
        sampled tokens are read once, from rank 0's device. ``params``
        are full tensors on any one device, the host (CPU) included:
        each rank's shard is copied straight to its device, and the pool
        and the KV codebook's calibration are made shard by shard, so no
        card ever holds the whole model or pool (params on the host serve
        a model larger than one card). Raises ``NotImplementedError``
        where a sharded dim does not divide the model axis
        (``check_tensor_parallel``). ``self.params`` is the list of the
        ranks' trees (``[params]`` without a mesh) and ``self.kv.pools``
        that of their pools.
      prefix_cache: automatic prefix caching (default on). Fully written
        prompt pages are indexed by content as prefill covers them; a
        later request sharing a page-aligned prompt prefix maps them
        read-shared and starts prefill at its first uncached token.
        Greedy output is unchanged: shared pages hold exactly the KV a
        cold prefill would recompute. A code pool salts the index with its
        codebook's fingerprint.
      spec_decode: optional :class:`~repro_torch.serve.speculative.
        SpecConfig` enabling self-speculative decoding: a drafter (the
        target's own weights through a draft operating point or an
        early-exit prefix, or host-side n-gram lookup) proposes up to
        ``k`` tokens per decoding slot and ONE ``verify_paged`` call
        scores them, emitting 1 to ``k+1`` tokens per round. Greedy
        output stays token-identical to non-speculative decoding;
        temperature slots take rejection sampling with the residual
        correction. The ladder's ``MODE_NO_SPEC`` turns it off under
        pressure.
      max_queue: optional bound on the waiting queue. A ``submit`` that
        would overflow it sheds the lowest-priority (newest) request with
        ``finish_reason = LoadShedded`` instead of raising. None =
        unbounded.
      degradation: :class:`DegradationPolicy` stepping the engine down the
        ladder as pool pressure rises (speculation off, then a shrunk
        prefill budget, then an admission stop) and back up with
        hysteresis as it clears. None disables it.
      kv_codebook: the KV codebook of a ``kv_quant="vq"`` engine; None
        fits one (:meth:`_fit_kv_codebook`). Passing one without
        ``kv_quant="vq"`` is an error.
      obs: :class:`~repro_torch.obs.Obs` bundle the engine, its scheduler
        and its pool record into (a private one when None). Recording
        reads nothing from the card.
    """

    def __init__(self, model, params, qc: QuantConfig = DENSE,
                 batch_size: int = 8, max_seq: int = 512,
                 eos_id: Optional[int] = None, seed: int = 0,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefill_chunk: int = 32, mesh=None,
                 prefix_cache: bool = True,
                 spec_decode: Optional[SpecConfig] = None,
                 max_queue: Optional[int] = None,
                 degradation: Optional[DegradationPolicy]
                 = DEFAULT_DEGRADATION,
                 kv_codebook: Optional[KVCodebook] = None,
                 obs: Optional[Obs] = None):
        _refuse_frontend(model, "Engine")
        self.model = model
        self.qc = qc
        self.mesh = mesh
        group = None                      # the ranks under a mesh
        if mesh is None:
            self.params = [params]
            self._tp = RankRunner([model.device])
        else:
            if "model" not in mesh.axis_names:
                raise ValueError(f"mesh {mesh.axis_names} has no 'model' "
                                 "axis")
            msize = mesh.shape["model"]
            check_tensor_parallel(model.cfg, msize, qc)
            group = replica_submeshes(mesh)[0]
            self.params = shard_tree(
                params, serving_layout(params, model.cfg, msize), group)
            self._tp = RankRunner(list(group.devices.flat))
        self.device = self._tp.devices[0]
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
            if model.cfg.family in RECURRENT:
                raise ValueError(
                    "kv_quant='vq' quantizes paged attention KV pages; "
                    f"the {model.cfg.family!r} family has recurrent "
                    "state, which has no page rows to encode")
            if self.kv_codebook is None:
                self.kv_codebook = self._fit_kv_codebook()
        elif kv_codebook is not None:
            raise ValueError(
                "kv_codebook supplied but qc.kv_quant is 'none' — set "
                "qc = qc.replace(kv_quant='vq') to serve quantized")
        # every counter below lives in obs.metrics behind a same-named
        # read-only property; the scheduler and the pool record into the
        # same bundle, and a Tracer shared across replicas merges them
        self.obs = obs if obs is not None else Obs()
        met = self.obs.metrics
        self.kv = PagedKVCache(model, self.num_slots, max_seq,
                               page_size=page_size, num_pages=num_pages,
                               codebook=self.kv_codebook,
                               prefix_cache=prefix_cache, mesh=group)
        self.kv.obs = self.obs
        self.scheduler = SlotScheduler(self.num_slots, max_queue=max_queue,
                                       obs=self.obs)
        self.step_count = 0
        self.degradation = degradation
        self.mode = MODE_NORMAL
        self._c_mode = tuple(
            met.counter(f"engine.mode_steps.{MODE_NAMES[i]}", unit="steps",
                        desc="steps spent in this degradation mode")
            for i in range(4))
        self._c_transitions = met.counter(
            "engine.degradation.transitions", unit="transitions")
        self._c_emitted = met.counter("engine.emitted_tokens",
                                      unit="tokens")
        # prompt tokens admitted (re-admissions included), of those the
        # tokens served from shared pages, and tokens actually prefilled
        self._c_prompt = met.counter("engine.prompt_tokens", unit="tokens")
        self._c_cached = met.counter("engine.cached_tokens", unit="tokens")
        self._c_prefilled = met.counter("engine.prefilled_tokens",
                                        unit="tokens")
        self._g_pool_bytes = met.gauge("engine.pool.live_bytes", unit="B")
        self._g_pressure = met.gauge("engine.pool.pressure")
        self._g_mode = met.gauge("engine.mode")
        self._c_device_reads = met.counter("engine.device_reads",
                                           unit="reads")
        self._gens = _slot_generators(self.device, seed, self.num_slots)
        # speculative decoding: verify calls, proposals scored, proposals
        # accepted, tokens emitted by rounds
        self.spec = spec_decode
        self.drafter = None
        self._c_spec_rounds = met.counter("engine.spec.rounds",
                                          unit="rounds")
        self._c_spec_drafted = met.counter("engine.spec.drafted",
                                           unit="tokens")
        self._c_spec_accepted = met.counter("engine.spec.accepted",
                                            unit="tokens")
        self._c_spec_emitted = met.counter("engine.spec.emitted",
                                           unit="tokens")
        if spec_decode is not None:
            if not self.kv.paged:
                raise ValueError(
                    "spec_decode needs rewindable paged KV state; the "
                    f"{model.cfg.family!r} family's recurrent state cannot "
                    "roll back rejected draft tokens")
            if spec_decode.k < 1:
                raise ValueError(f"spec_decode.k must be >= 1, got "
                                 f"{spec_decode.k}")
            self._spec_rng = np.random.default_rng(seed)
            self.drafter = spec_decode.build_drafter()
            self.drafter.bind(self)

    @torch.no_grad()
    def _run(self, fn):
        """``fn(params, pool, local)`` once a rank, with the rank's params
        and pool and ``local`` moving a step input to the rank's device;
        returns rank 0's result. Serving builds no autograd graph (and so
        the runner keeps its persistent rank threads)."""
        return self._tp.run(lambda tp: fn(self.params[tp.rank],
                                          self.kv.pools[tp.rank],
                                          tp.local))[0]

    @property
    def collectives(self) -> Tuple[int, int]:
        """(collectives, bytes gathered) since the engine started; (0, 0)
        on one device (``parallel.collectives.RankRunner``)."""
        return self._tp.collectives, self._tp.bytes

    # ------------------------------------------------------------------
    # the device calls of the step loop (one named attribute each, so a
    # fault can be injected before any state is touched)
    # ------------------------------------------------------------------
    def _decode_call(self, toks: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
        table = self.kv.table_device()
        return self._run(lambda p, kv, loc: self.model.decode_paged(
            p, loc(toks), kv, loc(table), loc(positions), self.qc))

    def _verify_call(self, toks: torch.Tensor, positions: torch.Tensor,
                     n_live: torch.Tensor) -> torch.Tensor:
        table = self.kv.table_device()
        return self._run(lambda p, kv, loc: self.model.verify_paged(
            p, loc(toks), kv, loc(table), loc(positions), loc(n_live),
            self.qc))

    def _device_read(self, t: Union[torch.Tensor, Tuple[torch.Tensor, ...]]):
        """THE device -> host transfer of the step loop (one per decode
        step, one per finished prefill; a speculative round's draft ids
        and verify ids), counted in ``device_reads``. A tuple of tensors
        is one read and gives a tuple of arrays. The step loop waits for
        the card here, so the ``device_read`` phase holds the device time
        the host did not hide."""
        self._c_device_reads.inc()
        with self.obs.phase("device_read"):
            if isinstance(t, tuple):
                return tuple(x.cpu().numpy() for x in t)
            return t.cpu().numpy()

    # ------------------------------------------------------------------
    # registry-backed counters
    # ------------------------------------------------------------------
    @property
    def load(self) -> int:
        """Requests queued or occupying a slot (router dispatch metric)."""
        return len(self.scheduler.waiting) + sum(
            not s.free for s in self.scheduler.slots)

    @property
    def mode_steps(self) -> Dict[int, int]:
        """Steps spent in each degradation mode (``{mode: steps}``)."""
        return {i: c.value for i, c in enumerate(self._c_mode)}

    @property
    def emitted_tokens(self) -> int:
        return self._c_emitted.value

    @property
    def prompt_tokens(self) -> int:
        return self._c_prompt.value

    @property
    def cached_tokens(self) -> int:
        return self._c_cached.value

    @property
    def prefilled_tokens(self) -> int:
        return self._c_prefilled.value

    @property
    def device_reads(self) -> int:
        return self._c_device_reads.value

    @property
    def spec_rounds(self) -> int:
        return self._c_spec_rounds.value

    @property
    def spec_drafted(self) -> int:
        return self._c_spec_drafted.value

    @property
    def spec_accepted(self) -> int:
        return self._c_spec_accepted.value

    @property
    def spec_emitted(self) -> int:
        return self._c_spec_emitted.value

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of admitted prompt tokens served from shared pages
        (0.0 before any admission)."""
        return safe_ratio(self._c_cached.value, self._c_prompt.value)

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target accepted (0.0 before any
        verify round)."""
        return safe_ratio(self._c_spec_accepted.value,
                          self._c_spec_drafted.value)

    @property
    def tokens_per_verify(self) -> float:
        """Mean tokens emitted per verify call, summed over the call's
        slots (0.0 before any round)."""
        return safe_ratio(self._c_spec_emitted.value,
                          self._c_spec_rounds.value)

    @property
    def pressure(self) -> float:
        """Current page-pool pressure in [0, 1] (see PagedKVCache)."""
        return self.kv.pressure

    @property
    def progress_marker(self) -> int:
        """Monotone work counter: the router's watchdog compares it
        between steps to find a stalled (alive but useless) replica."""
        return self.prefilled_tokens + self.emitted_tokens

    @property
    def prefill_budget(self) -> int:
        """Prompt tokens fed per prefill chunk: the full chunk width
        normally, divided by the policy's ``chunk_divisor`` in mode >= 2
        (the chunk's padded width never changes, only how much of it
        carries real tokens)."""
        if self.degradation is None or self.mode < MODE_SHRINK_PREFILL:
            return self.prefill_chunk
        return max(self.degradation.min_chunk,
                   self.prefill_chunk // self.degradation.chunk_divisor)

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> Optional[Request]:
        """Enqueue a request; it is admitted as soon as a slot and pages
        free. Raises :class:`PagePoolExhausted` at once if its prompt
        could never be served. With a bounded queue, overflow sheds the
        lowest-priority request with ``finish_reason = LoadShedded``: it
        is returned here (possibly ``req`` itself); None when nothing was
        shed. ``arrival`` is stamped with the current step when unset
        (the deadline clock)."""
        self.kv.check_admissible(len(req.tokens) + len(req.out_tokens))
        if req.arrival is None:
            req.arrival = self.step_count
        if req.arrival_ts is None:
            req.arrival_ts = time.perf_counter()
        victim = self.scheduler.submit(req)
        if victim is not req:
            self._obs_request_start(req)
        if victim is not None:
            if victim.finish_step is None:
                victim.finish_step = self.step_count
            _observe_request(self.obs, victim)
        return victim

    def requeue(self, req: Request) -> None:
        """Re-admit a request the system already accepted (crash recovery
        from another replica): exempt from the queue bound, placed at the
        front. The caller counts the retry (the router does)."""
        self.kv.check_admissible(len(req.tokens) + len(req.out_tokens))
        if req.arrival is None:
            req.arrival = self.step_count
        if req.arrival_ts is None:
            req.arrival_ts = time.perf_counter()
        self.scheduler.requeue(req, front=True, count_retry=False)
        self._obs_request_start(req)

    def _obs_request_start(self, req) -> None:
        """Open (or mark re-admitted) the request's lifecycle span, on the
        requests track, keyed by its scheduler sequence number: a request
        that moves replicas after a crash stays one span."""
        tr = self.obs.tracer
        if not tr.enabled or req._seq < 0:
            return
        rid = req._seq
        if getattr(req, "_obs_traced", False):
            tr.request_instant(rid, f"req {rid}", "requeued")
        else:
            req._obs_traced = True
            tr.request_begin(rid, f"req {rid}",
                             {"prompt": len(req.tokens),
                              "max_new": req.max_new_tokens,
                              "priority": req.priority})

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests to completion."""
        for r in requests:
            self.submit(r)
        self.run_until_idle()
        return requests

    # Steps tolerated with work pending but nothing progressing before
    # run_until_idle raises: pages held outside the scheduler (fault
    # injection) stall the engine legitimately; a real livelock still
    # fails loudly.
    STALL_LIMIT = 512

    def run_until_idle(self) -> None:
        """Step until queue and slots are empty."""
        stalled = 0
        while self.scheduler.has_work:
            if self.step():
                stalled = 0
            else:
                stalled += 1
                if stalled > self.STALL_LIMIT:
                    raise RuntimeError(
                        f"engine made no progress in {stalled} steps "
                        f"({self.kv.occupancy()})")

    def _update_degradation(self) -> None:
        """Advance the degradation ladder from the current pressure."""
        if self.degradation is None:
            return
        new = self.degradation.mode_for(self.pressure, self.mode)
        if new != self.mode:
            log.info("degradation %s -> %s (pressure %.2f, %s)",
                     MODE_NAMES[self.mode], MODE_NAMES[new],
                     self.pressure, self.kv.occupancy())
            self._c_transitions.inc()
            self.obs.annotate("degradation", frm=MODE_NAMES[self.mode],
                              to=MODE_NAMES[new],
                              pressure=round(self.pressure, 3))
        self.mode = new

    def step(self) -> bool:
        """One iteration: expire deadlines, admit, one prefill chunk, one
        decode step (or speculative round). Under pressure the ladder
        sheds work first: mode 1 drops speculation, mode 2 shrinks the
        prefill budget, mode 3 stops admitting. Returns False when there
        was nothing to do."""
        self._update_degradation()
        self._c_mode[self.mode].inc()
        obs = self.obs
        if obs.active:
            self._g_pool_bytes.set(float(self.kv.live_bytes))
            self._g_pressure.set(self.pressure)
            self._g_mode.set(float(self.mode))
            obs.track("pool.pressure", self.pressure)
        with obs.phase("admit"):
            for req in self.scheduler.expire_deadlines(self.step_count,
                                                       self.kv):
                log.info("request expired past deadline_steps=%s",
                         req.deadline_steps)
                _observe_request(obs, req)
            # admission stops at the top of the ladder, but never on an
            # idle engine (nothing running would release pages)
            if (self.mode < MODE_STOP_ADMIT
                    or not self.scheduler.occupied_slots()):
                for slot in self.scheduler.admit(self.kv):
                    self._c_prompt.inc(slot.prefill_len)
                    self._c_cached.inc(slot.pos)  # admission: pos = matched
        progressed = False
        slot = self.scheduler.next_prefill()
        if slot is not None:
            with obs.phase("prefill_chunk"):
                self._prefill_chunk_step(slot)
            progressed = True
        if self.scheduler.decode_slots():
            if self.spec is not None and self.mode < MODE_NO_SPEC:
                self._spec_decode_step()
            else:
                self._decode_step()
            progressed = True
        self.step_count += 1
        return progressed

    # ------------------------------------------------------------------
    # internals
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _fit_kv_codebook(self) -> KVCodebook:
        """Fit the KV codebook on :func:`calibration_rows` (k-means seeded
        with 0: a restart or a second replica fits the same codebook, so
        their code pools share one prefix-key space)."""
        k_rows, v_rows = self._tp.run(lambda tp: calibration_rows(
            self.model, self.params[tp.rank], self.qc, self.max_seq,
            self.page_size))[0]
        return KVCodebook.fit(
            k_rows, v_rows, v=self.qc.kv_v, c=self.qc.kv_c,
            generator=torch.Generator(device=self.device).manual_seed(0))

    def _reserve_lookahead(self, slot_idx: int, pos: int, kk: int) -> int:
        """Reserve pages for ``kk`` draft tokens past the pending one,
        shrinking ``kk`` instead of preempting when the pool runs short
        (speculation is opportunistic). Returns the reserved lookahead."""
        while kk > 0:
            try:
                self.kv.ensure(slot_idx, pos + kk + 1)
                return kk
            except PagePoolExhausted:
                kk -= 1
        return 0

    def _ensure_pages(self, slot_idx: int, n_tokens: int) -> None:
        """Grow a slot to n_tokens, preempting other slots if needed."""
        while True:
            try:
                self.kv.ensure(slot_idx, n_tokens)
                return
            except PagePoolExhausted:
                if self.scheduler.preempt_youngest(
                        self.kv, exclude=slot_idx) is None:
                    raise

    def _grow_or_shed(self, s) -> None:
        """Reserve the page of slot ``s``'s next write, preempting other
        slots if needed. When even that fails: a pool that can NEVER hold
        the sequence finishes the request truncated (its last sampled
        token is already in out_tokens); a pool whose pages are held
        elsewhere for now (fault injection) preempts the slot itself, and
        the request resumes token-identically once pages return."""
        try:
            self._ensure_pages(s.idx, s.pos + 1)
        except PagePoolExhausted:
            if self.kv.pages_for(s.pos + 1) > \
                    self.kv.table.allocator.num_pages:
                req = s.req                    # evict clears slot.req
                req.finish(FinishReason.TRUNCATED, self.step_count)
                self.scheduler.evict(s, self.kv)
                _observe_request(self.obs, req)
            else:
                self.scheduler.preempt(s, self.kv)

    def _prefill_chunk_step(self, slot) -> None:
        c = self.prefill_chunk           # static chunk width, never shrunk
        chunk = self.scheduler.prompt_chunk(slot,
                                            min(c, self.prefill_budget))
        valid = len(chunk)
        toks = np.zeros((1, c), np.int32)
        toks[0, :valid] = chunk
        toks = torch.from_numpy(toks).to(self.device)
        table = self.kv.table_device()
        logits = self._run(lambda p, kv, loc: self.model.prefill_paged(
            p, loc(toks), kv, loc(table), slot.idx, slot.pos, valid,
            self.qc))
        slot.pos += valid
        self._c_prefilled.inc(valid)
        # index the prompt pages this chunk completed: later requests
        # sharing the prefix map them instead of recomputing
        self.kv.register_prefix(slot.idx, slot.prompt, slot.pos)
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
        with self.obs.phase("decode"):
            logits = self._decode_call(
                torch.from_numpy(toks).to(self.device),
                torch.from_numpy(positions).to(self.device))
        with self.obs.phase("sample"):
            nxt_dev = _sample_tokens(
                logits, temps if (temps > 0.0).any() else None, self._gens)
        nxt = self._device_read(nxt_dev)
        for s in dslots:
            s.pos += 1
            self._record_token(s, int(nxt[s.idx]))

    # ------------------------------------------------------------------
    # speculative decoding
    # ------------------------------------------------------------------
    def _spec_decode_step(self) -> None:
        """One draft / verify round over every decoding slot, in place of
        :meth:`_decode_step`: the drafter proposes up to ``k`` tokens per
        slot, ONE ``verify_paged`` call scores them (k+1 columns; slots
        that drafted fewer pad with trash-bound columns), and the accepted
        prefix plus one target token is recorded. The argmax is taken on
        the device: a greedy round reads only the draft ids (model
        drafter) and the verify ids; the logits come to the host only
        when a slot samples. Rejected rows roll back: ``slot.pos`` does
        not advance over them and :meth:`PagedKVCache.trim` drops the
        tail pages the rejected lookahead no longer needs (a shared page
        only loses this slot's reference)."""
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
        with self.obs.phase("draft"):
            g, n_prop, q_rows = self.drafter.propose(self, dslots, k_slot,
                                                     k)
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
        with self.obs.phase("verify"):
            logits = self._verify_call(torch.from_numpy(toks).to(dev),
                                       torch.from_numpy(posv).to(dev),
                                       torch.from_numpy(nlive).to(dev))
            ids = torch.argmax(logits, dim=-1).to(torch.int32)
        if any(s.req.temperature > 0.0 for s in dslots):
            ids_h, lg = self._device_read((ids, logits.float()))
        else:
            ids_h, lg = self._device_read(ids), None
        self._c_spec_rounds.inc()
        for s in dslots:
            n = int(n_prop[s.idx])
            draft = [int(t) for t in g[s.idx, :n]]
            rows = None if q_rows is None else \
                [q_rows[t][s.idx] for t in range(n)]
            accepted, out = accept_tokens(
                draft, None if lg is None else lg[s.idx, :n + 1],
                s.req.temperature, self._spec_rng, rows,
                targets=ids_h[s.idx, :n + 1])
            self._c_spec_drafted.inc(n)
            self._c_spec_accepted.inc(accepted)
            req = s.req              # _record_token may evict (slot.req=None)
            for tok in out:
                s.pos += 1
                self._record_token(s, tok)
                self._c_spec_emitted.inc()
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
        self._c_emitted.inc()
        if req.first_token_step is None:
            req.first_token_step = self.step_count
            req.first_token_ts = time.perf_counter()
        slot.next_token = tok
        hit_eos = self.eos_id is not None and tok == self.eos_id
        budget_done = len(req.out_tokens) >= req.max_new_tokens
        truncated = slot.pos >= self.max_seq      # no room for another write
        if hit_eos or budget_done or truncated:
            req.finish(FinishReason.COMPLETED if (hit_eos or budget_done)
                       else FinishReason.TRUNCATED, self.step_count)
            self.scheduler.evict(slot, self.kv)
            _observe_request(self.obs, req)


class BatchToCompletionEngine:
    """Fixed-batch baseline engine.

    Requests go in batches of ``batch_size``, prefilled together (LEFT-
    padded, right-aligned) into a dense ``(batch, max_seq)`` cache and
    decoded step by step until every request of the batch finishes: the
    whole batch waits on its longest member. Pad rows are masked through
    ``pad_lens``. Projections run B1 as in :class:`Engine` (at batch x
    longest-prompt rows in the prefill); attention runs in plain torch,
    as the JAX package's dense path computes it outside Pallas.
    Attention families only: an SSM would integrate the left padding into
    its state (``kv_start`` masks attention only); :class:`Engine`, which
    never left-pads, serves them.
    """

    def __init__(self, model, params, qc: QuantConfig = DENSE,
                 batch_size: int = 8, max_seq: int = 512,
                 eos_id: Optional[int] = None, seed: int = 0,
                 obs: Optional[Obs] = None):
        _refuse_frontend(model, "BatchToCompletionEngine")
        if model.cfg.family in RECURRENT:
            raise ValueError(
                "BatchToCompletionEngine left-pads prompts, which an SSM "
                "would integrate into its state (kv_start only masks "
                "attention); use the continuous Engine for "
                f"family={model.cfg.family!r}")
        self.model = model
        self.params = params
        self.qc = qc
        self.device = model.device
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.eos_id = eos_id
        # one tick per prefill and per decode step, across batches, so the
        # requests' step stamps compare with the continuous engine's
        self.step_count = 0
        self.obs = obs if obs is not None else Obs()
        self._gens = _slot_generators(self.device, seed, batch_size)

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests (in submission-order batches)."""
        for r in requests:
            if r.arrival is None:
                r.arrival = self.step_count
            if r.arrival_ts is None:
                r.arrival_ts = time.perf_counter()
        for i in range(0, len(requests), self.batch_size):
            self._run_batch(requests[i:i + self.batch_size])
        return requests

    def _run_batch(self, reqs: List[Request]) -> None:
        b, pad_b, dev = len(reqs), self.batch_size, self.device
        max_prompt = max(len(r.tokens) for r in reqs)
        if max_prompt > self.max_seq:
            raise ValueError(
                f"prompt of {max_prompt} tokens exceeds max_seq="
                f"{self.max_seq}")
        toks = np.zeros((pad_b, max_prompt), np.int32)
        pad_h = np.full((pad_b,), max_prompt, np.int32)  # empty rows: all pad
        for j, r in enumerate(reqs):
            # left-pad / right-align so the batch decodes from one position
            toks[j, max_prompt - len(r.tokens):] = r.tokens
            pad_h[j] = max_prompt - len(r.tokens)
        # a uniform-length batch needs no mask (its filler rows b.. are
        # discarded)
        pad_lens = torch.from_numpy(pad_h).to(dev) if pad_h[:b].any() \
            else None
        cache = self.model.init_cache(pad_b, self.max_seq)
        logits, cache = self.model.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)}, cache,
            self.qc, pad_lens=pad_lens)
        self.step_count += 1
        active = np.ones(pad_b, bool)
        active[b:] = False
        max_new = max(r.max_new_tokens for r in reqs)
        temps_h = np.zeros(pad_b, np.float32)
        temps_h[:b] = [r.temperature for r in reqs]
        temps = temps_h if (temps_h > 0.0).any() else None
        next_tok = _sample_tokens(logits, temps, self._gens)
        for step in range(max_new):
            np_tok = next_tok.cpu().numpy()
            for j, r in enumerate(reqs):
                if active[j] and not r.done:
                    t = int(np_tok[j])
                    r.out_tokens.append(t)
                    if r.first_token_step is None:
                        r.first_token_step = self.step_count
                        r.first_token_ts = time.perf_counter()
                    if (self.eos_id is not None and t == self.eos_id) or \
                            len(r.out_tokens) >= r.max_new_tokens:
                        r.finish(FinishReason.COMPLETED, self.step_count)
                        active[j] = False
            if not active[:b].any():
                break
            if max_prompt + step >= self.max_seq:
                break             # the cache is full: truncate
            logits, cache = self.model.decode(
                self.params, next_tok.to(torch.int32)[:, None], cache,
                self.qc, pad_lens=pad_lens)
            self.step_count += 1
            next_tok = _sample_tokens(logits, temps, self._gens)
        for r in reqs:
            # anything still unfinished was truncated at max_seq
            r.finish(FinishReason.TRUNCATED, self.step_count)
            _observe_request(self.obs, r)


def _refuse_frontend(model, engine: str) -> None:
    """The engines serve token prompts: an audio or vlm model (frame or
    patch embeddings from a stubbed frontend) serves through
    ``Model.prefill`` / ``decode`` on a dense cache instead. The JAX
    package's engines fail later, at the embedding or at the paged
    entry points; these refuse at construction."""
    if model.cfg.family in FRONTEND:
        raise NotImplementedError(
            f"{engine} serves token prompts; the {model.cfg.family!r} "
            "family's inputs are frontend embeddings: serve it through "
            "Model.init_cache / prefill / decode")


def greedy_generate(model, params, prompt_tokens, n_new: int,
                    qc: QuantConfig = DENSE, max_seq: int = 256):
    """One-shot greedy generation (tests, examples): the ``n_new``
    generated token ids."""
    eng = Engine(model, params, qc, batch_size=1, max_seq=max_seq)
    req = Request(tokens=list(prompt_tokens), max_new_tokens=n_new)
    eng.run([req])
    return req.out_tokens
