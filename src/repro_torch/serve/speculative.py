"""Self-speculative decoding: draft cheap, verify with the target, roll back
(port of ``repro.serve.speculative``).

A round over every decoding slot:

  1. **draft**: ``k`` cheap steps propose tokens ``g_1..g_k`` per slot.
     The model drafter decodes against the SHARED paged pool: its writes
     land at rows ``>= slot.pos``, which attention never reads back as
     committed context (the mask is ``kj < pos``) and which the verify
     step overwrites with the target's K/V, so drafting costs no pages
     beyond the round's lookahead.
  2. **verify**: ONE ``Model.verify_paged`` call scores the slot's
     pending token plus its proposals at per-slot positions and writes
     the target's K/V over the draft rows.
  3. **accept / roll back**: greedy slots keep the longest proposal
     prefix that matches the target's argmax and emit one correction or
     bonus token from the target, so the stream is token-identical to
     non-speculative greedy decoding. Temperature slots run rejection
     sampling with the residual correction (Leviathan et al., 2023).
     Rejected rows roll back by not advancing ``slot.pos`` over them and
     by trimming tail pages (:meth:`PageTable.trim`).

Drafters:
  * :class:`ModelDrafter`: the target's own weights through a draft
    :class:`QuantConfig` (the LUT-DLA move: a coarse ``lut_infer``
    operating point over the same params) and/or only the first
    ``draft_layers`` layers (early exit through the shared final norm and
    head). Its ``k`` steps are a Python loop of ``decode_paged`` calls;
    the draft tokens stay on the device between steps and come to the
    host once a round.
  * :class:`NgramDrafter`: prompt lookup, the continuation of an earlier
    occurrence of the current suffix n-gram. No model cost.

:func:`accept_tokens` is the acceptance math: a pure host function.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.lut import QuantConfig


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Speculative-decoding operating point for
    :class:`~repro_torch.serve.engine.Engine`.

    Attributes:
      k: draft lookahead, proposals per round and decoding slot. The
        verify call scores ``k + 1`` token columns; a round emits 1 (all
        rejected) to ``k + 1`` (all accepted plus the bonus) tokens.
      drafter: ``"model"`` (:class:`ModelDrafter`) or ``"ngram"``
        (:class:`NgramDrafter`).
      draft_qc: QuantConfig of the model drafter's steps; ``None`` = the
        engine's own ``qc``.
      draft_layers: early-exit depth of the model drafter (its first N
        layers, logits through the shared final norm and head); ``None``
        = full depth.
      ngram: longest suffix the ngram drafter matches on.
    """
    k: int = 4
    drafter: str = "model"
    draft_qc: Optional[QuantConfig] = None
    draft_layers: Optional[int] = None
    ngram: int = 3

    def build_drafter(self) -> "Drafter":
        if self.drafter == "model":
            return ModelDrafter(self.draft_qc, self.draft_layers)
        if self.drafter == "ngram":
            return NgramDrafter(self.ngram)
        raise ValueError(f"unknown drafter {self.drafter!r} "
                         "(expected 'model' or 'ngram')")


def _softmax(row: np.ndarray) -> np.ndarray:
    e = np.exp(row.astype(np.float64) - row.max())
    return e / e.sum()


def accept_tokens(draft: Sequence[int], logits: Optional[np.ndarray],
                  temperature: float, rng: np.random.Generator,
                  q_rows: Optional[Sequence[Optional[np.ndarray]]] = None,
                  targets: Optional[np.ndarray] = None,
                  ) -> Tuple[int, List[int]]:
    """Decide which proposals survive one verify round (host-side, pure).

    Args:
      draft: the ``n`` proposed tokens ``g_1..g_n``.
      logits: (n+1, V) target verify logits; row ``i`` is the target
        distribution after the slot's pending token and ``g_1..g_i``. May
        be ``None`` for a greedy slot when ``targets`` is given.
      temperature: the slot's sampling temperature (0 = greedy).
      rng: host PRNG for the accept coin flips and residual draws.
      q_rows: per-proposal draft distributions (each (V,), summing to 1),
        or ``None`` rows / ``None`` for a deterministic drafter (one-hot).
      targets: optional per-row argmax ids (>= n+1 entries); greedy mode
        uses them instead of ``np.argmax(logits)``.

    Returns ``(accepted, tokens)``: ``accepted`` proposals survived and
    ``tokens`` (``accepted + 1`` of them) is what the round emits: the
    surviving proposals plus one token from the target distribution (the
    residual draw after a rejection, or the bonus token). Greedy mode is
    exact prefix matching against the target argmax.
    """
    n = len(draft)
    if temperature <= 0.0:
        if targets is None:
            targets = np.argmax(logits[:n + 1], axis=-1)
        if len(targets) < n + 1:
            raise ValueError(f"{len(targets)} targets for {n} proposals")
        a = 0
        while a < n and draft[a] == int(targets[a]):
            a += 1
        return a, [int(t) for t in draft[:a]] + [int(targets[a])]
    if logits is None or logits.shape[0] < n + 1:
        raise ValueError(f"temperature mode needs {n + 1} logit rows")

    # Accept g with probability min(1, p(g)/q(g)); on rejection draw from
    # the residual max(p - q, 0), which makes the procedure draw exactly
    # from p (Leviathan et al., 2023).
    inv_t = 1.0 / max(temperature, 1e-6)
    for i in range(n):
        p = _softmax(logits[i] * inv_t)
        g = int(draft[i])
        q = None if q_rows is None else q_rows[i]
        q_g = 1.0 if q is None else float(q[g])
        if q_g > 0 and rng.random() < min(1.0, float(p[g]) / q_g):
            continue
        if q is None:                     # one-hot drafter: remove g's mass
            residual = p.copy()
            residual[g] = 0.0
        else:
            residual = np.maximum(p - q, 0.0)
        tot = residual.sum()
        if tot <= 0.0:                    # degenerate (p within q): use p
            residual, tot = p, p.sum()
        tok = int(rng.choice(residual.shape[0], p=residual / tot))
        return i, [int(t) for t in draft[:i]] + [tok]
    p = _softmax(logits[n] * inv_t)       # everything accepted: bonus token
    tok = int(rng.choice(p.shape[0], p=p))
    return n, [int(t) for t in draft] + [tok]


class Drafter:
    """Proposal source for one speculative round.

    ``bind(engine)`` is called once by the engine, ``propose`` once a
    round. A drafter may read the engine's state but must only WRITE
    cache rows at positions ``>= slot.pos``: the verify step owns
    everything below.

    ``writes_kv``: True when ``propose`` writes draft K/V through the page
    tables; the engine then reserves the lookahead pages BEFORE drafting
    (for host-side drafters after, so a round that proposes nothing
    allocates nothing).
    """

    writes_kv = False

    def bind(self, engine) -> None:
        pass

    def propose(self, engine, dslots, k_slot: Dict[int, int], k: int):
        """Return ``(g, n_prop, q_rows)`` for this round.

        g: (num_slots, k) int32 numpy proposals (garbage outside live
          entries).
        n_prop: (num_slots,) int proposals made per slot
          (``<= k_slot[idx]``).
        q_rows: per-step list of (num_slots, V) draft probabilities for
          temperature slots, or ``None`` for deterministic drafters.
        """
        raise NotImplementedError


class ModelDrafter(Drafter):
    """The target's own weights through a cheaper operating point:
    ``draft_qc`` switches the projections' mode, ``draft_layers`` cuts
    the stack to an early-exit prefix whose hidden state reads logits
    through the shared final norm and head.

    Step ``t`` writes its K/V at ``pos + t`` so that step ``t+1`` attends
    the round's earlier proposals; committed rows ``< pos`` are read and
    never written, and verify overwrites every draft row. With
    ``draft_layers`` the drafter runs a model of that many layers over
    ``params["blocks"][:n]`` and a view of the pool's first ``n`` layers
    (and of the codebook's), so its writes land in the shared pool with
    no copy back; the deeper layers' draft rows keep stale values, safe
    for the same reason.

    Greedy slots take the argmax on the device; temperature slots draw
    from ``softmax(logits / T)`` with the engine's per-slot generators,
    and only then are the draft distributions kept for rejection
    sampling. The round's draft tokens (and those distributions, when a
    slot samples) come to the host in one read.
    """

    writes_kv = True

    def __init__(self, draft_qc: Optional[QuantConfig] = None,
                 draft_layers: Optional[int] = None):
        self.draft_qc = draft_qc
        self.draft_layers = draft_layers

    def bind(self, engine) -> None:
        model = engine.model
        self.qc = self.draft_qc or engine.qc
        n = self.draft_layers
        if n is not None and not 0 < n <= model.cfg.num_layers:
            raise ValueError(
                f"draft_layers={n} out of range for a "
                f"{model.cfg.num_layers}-layer target")
        if n == model.cfg.num_layers:
            n = None                       # full depth: no slicing
        self._n = n
        self.model = model if n is None else type(model)(
            model.cfg.replace(num_layers=n), device=model.device)

    def _draft_state(self, engine):
        """(params, pool) the draft steps run on: the engine's own, or
        views of their first ``draft_layers`` layers."""
        params, kv, n = engine.params, engine.kv.data, self._n
        if n is None:
            return params, kv
        p_d = dict(params, blocks=params["blocks"][:n])
        kv_d = {key: kv[key][:n] for key in ("k", "v")}
        for key, cb in kv.items():        # a code pool's codebook
            if key not in ("k", "v"):
                kv_d[key] = {name: leaf[:n] for name, leaf in cb.items()}
        return p_d, kv_d

    def propose(self, engine, dslots, k_slot: Dict[int, int], k: int):
        b = engine.num_slots
        first = np.zeros((b,), np.int32)
        posv = np.full((b,), -1, np.int32)
        n_prop = np.zeros((b,), np.int32)
        temps = np.zeros((b,), np.float32)
        for s in dslots:
            first[s.idx] = s.next_token
            posv[s.idx] = s.pos
            n_prop[s.idx] = k_slot[s.idx]
            if k_slot[s.idx] > 0 and s.req.temperature > 0.0:
                temps[s.idx] = s.req.temperature
        if n_prop.max() == 0:
            return np.zeros((b, k), np.int32), n_prop, None
        hot = [i for i in range(b) if temps[i] > 0.0]
        dev = engine.device
        params, kv = self._draft_state(engine)
        table = engine.kv.table_device()
        cur = torch.from_numpy(first).to(dev)
        positions = torch.from_numpy(posv).to(dev)
        live = positions >= 0
        steps = torch.from_numpy(n_prop).to(dev)
        temps_d = torch.from_numpy(temps).to(dev)[:, None]
        toks, probs = [], []
        for t in range(k):
            pos_t = torch.where(live & (t < steps), positions + t,
                                torch.full_like(positions, -1))
            logits = self.model.decode_paged(params, cur[:, None], kv, table,
                                             pos_t, self.qc)
            cur = torch.argmax(logits, dim=-1).to(torch.int32)
            if hot:
                p = torch.softmax(logits.float() / temps_d.clamp_min(1e-6),
                                  dim=-1)
                for i in hot:
                    cur[i] = torch.multinomial(p[i], 1,
                                               generator=engine._gens[i])[0]
                probs.append(p)
            toks.append(cur)
        g = torch.stack(toks, dim=1)                      # (B, k)
        if not hot:
            return engine._device_read(g), n_prop, None
        g_h, q_h = engine._device_read((g, torch.stack(probs)))
        return g_h, n_prop, list(q_h)


class NgramDrafter(Drafter):
    """Prompt-lookup drafting: continue an earlier occurrence of the
    current suffix n-gram (longest suffix first; the EARLIEST occurrence
    wins, since it has the most continuation ahead of it). No model cost,
    deterministic (its draft distribution is one-hot)."""

    def __init__(self, ngram: int = 3):
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.ngram = ngram

    @staticmethod
    def _lookup(hist: List[int], k: int, nmax: int) -> List[int]:
        """Continuation of the best earlier match of a suffix n-gram.

        Longest suffix first; within one suffix length the earliest
        occurrence wins. A shorter suffix is tried when a longer one
        cannot fill the ``k`` lookahead, so constant runs propose the
        whole budget."""
        best: List[int] = []
        for n in range(min(nmax, len(hist) - 1), 0, -1):
            pat = hist[-n:]
            for i in range(0, len(hist) - n):
                if hist[i:i + n] == pat:
                    cont = hist[i + n:i + n + k]   # >= 1 token by range
                    if len(cont) > len(best):
                        best = cont
                    break                          # earliest i for this n
            if len(best) >= k:
                break
        return best

    def propose(self, engine, dslots, k_slot: Dict[int, int], k: int):
        b = engine.num_slots
        g = np.zeros((b, k), np.int32)
        n_prop = np.zeros((b,), np.int32)
        for s in dslots:
            kk = k_slot[s.idx]
            if kk <= 0:
                continue
            hist = list(s.req.tokens) + list(s.req.out_tokens)
            cont = self._lookup(hist, kk, self.ngram)
            g[s.idx, :len(cont)] = cont
            n_prop[s.idx] = len(cont)
        return g, n_prop, None
