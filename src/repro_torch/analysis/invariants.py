"""Structural invariants of the paged entry points (port of the checks of
``repro.analysis.jaxpr_check`` that mean something without a jaxpr).

One call each of ``prefill_paged``, ``decode_paged`` and ``verify_paged``
runs inside a :class:`~repro_torch.analysis.sync_guard.SyncLog` that also
watches every op's outputs, on an fp pool and on a code pool
(``kv_quant="vq"``), and the run checks:

  * ``inv-f64`` — no op produces a float64 tensor (on the card a float64
    op runs at a fraction of float32's rate, and every number after it
    is promoted);
  * ``inv-transfer`` — no host <-> device copy inside the entry point (a
    round trip inside the step serializes it and breaks CUDA-graph
    capture);
  * ``sync-model`` — no host sync inside the entry point;
  * ``inv-pool`` — the pool is updated in place: the ``k`` / ``v`` pool
    tensors (and, on a code pool, the four codebook leaves) keep their
    ``data_ptr`` across the call, and no op inside it allocates a tensor
    as large as one pool tensor. This is the counterpart of the JAX
    serving jits donating the pool (``donate_argnums``): a call that
    copied the pool would double its memory.

Not ported on purpose: the JAX checks' gather budgets (exact counts of
``gather`` equations in a jaxpr) and the lowering's aliasing annotations
have no eager counterpart: the port's ops are not a program that can be
counted before it runs, and in-place updates replace donation.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from .findings import Finding
from .sync_guard import SyncLog, model_findings

ENTRY_POINTS = ("prefill_paged", "decode_paged", "verify_paged")


@dataclasses.dataclass
class InvariantReport:
    """``rows``: one dict per (pool, entry point) with its counts:
    records (syncs and transfers), float64 ops, big allocations, and
    whether every pool pointer stayed put."""
    findings: List[Finding]
    rows: List[Dict]

    @property
    def ok(self) -> bool:
        return not self.findings


def _pool_leaves(kv) -> Dict[str, torch.Tensor]:
    from repro_torch.core.kv_codebook import CODEBOOK_KEY
    out = {"k": kv["k"], "v": kv["v"]}
    for key, leaf in kv.get(CODEBOOK_KEY, {}).items():
        out[f"codebook.{key}"] = leaf
    return out


def _finding(rule, pool, entry, detail, msg, fix) -> Finding:
    return Finding(rule, "", 0, f"Model.{entry}", f"{pool}:{detail}", msg,
                   "error", fix)


# the pool the checks run on: 2 slots of 32 tokens in pages of 8; slot 0
# prefills one chunk of 8, then every slot decodes one token and
# verifies 3 columns
SLOTS, MAX_SEQ, PAGE, CHUNK, VERIFY_COLS = 2, 32, 8, 8, 3
# a pool tensor is at least this large, so that no activation or plain-
# version temporary of a small model is as large as one
MIN_POOL_BYTES = 1 << 23


def check_entry_points(model, params, qc, codebook=None, pool: str = "fp"
                       ) -> InvariantReport:
    """Run the three paged entry points once each on a fresh pool (a code
    pool of ``codebook`` when given; ``pool`` names it in the findings)
    and check the invariants (module docstring). The pool holds 4x the
    pages the slots own, and at least ``MIN_POOL_BYTES`` a pool tensor;
    slot s owns pages [s * pages_per_slot, (s + 1) * pages_per_slot)."""
    dev, cfg = model.device, model.cfg
    per_slot = MAX_SEQ // PAGE
    row = cfg.num_kv_heads * (codebook.nc if codebook is not None
                              else cfg.head_dim * model.dtype.itemsize)
    num_pages = max(4 * SLOTS * per_slot,
                    -(-MIN_POOL_BYTES // (cfg.num_layers * PAGE * row)))
    kv = model.init_paged_cache(MAX_SEQ, PAGE, num_pages, codebook=codebook)
    table = torch.arange(SLOTS * per_slot, dtype=torch.int32,
                         device=dev).reshape(SLOTS, per_slot)
    rng = np.random.default_rng(0)

    def tokens(shape):
        return torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape).astype(np.int32)).to(dev)

    prefill_toks = tokens((1, CHUNK))
    decode_toks = tokens((SLOTS, 1))
    positions = torch.tensor([CHUNK] + [0] * (SLOTS - 1),
                             dtype=torch.int32, device=dev)
    verify_toks = tokens((SLOTS, VERIFY_COLS))
    verify_pos = positions + 1
    n_live = torch.full((SLOTS,), VERIFY_COLS, dtype=torch.int32,
                        device=dev)
    calls = {
        "prefill_paged": lambda: model.prefill_paged(
            params, prefill_toks, kv, table, 0, 0, CHUNK, qc),
        "decode_paged": lambda: model.decode_paged(
            params, decode_toks, kv, table, positions, qc),
        "verify_paged": lambda: model.verify_paged(
            params, verify_toks, kv, table, verify_pos, n_live, qc),
    }
    pool_bytes = min(kv["k"].untyped_storage().nbytes(),
                     kv["v"].untyped_storage().nbytes())
    findings: List[Finding] = []
    rows = []
    for entry in ENTRY_POINTS:
        leaves = _pool_leaves(kv)
        keep = [t.untyped_storage().data_ptr() for t in leaves.values()]
        ptrs = {k: t.data_ptr() for k, t in leaves.items()}
        with SyncLog(watch_dtypes=True, alloc_bytes=pool_bytes,
                     keep_storages=keep) as log:
            out = calls[entry]()
        if out.dtype == torch.float64:
            log.float64.append(("<output>", (f"model.{entry}",), ("", 0,
                                                                   entry)))
        moved = sorted(k for k, t in _pool_leaves(kv).items()
                       if t.data_ptr() != ptrs[k])
        inside = log.in_model()
        transfers = [r for r in inside if not r.waits or
                     r.kind == "download"]
        allocs = [a for a in log.big_allocs
                  if any(t.startswith("model.") for t in a[2])]
        rows.append({"pool": pool, "entry": entry,
                     "records": len(inside), "transfers": len(transfers),
                     "float64": len(log.float64), "big_allocs": len(allocs),
                     "pool_ptrs_same": not moved})
        for op, _tags, site in log.float64:
            findings.append(_finding(
                "inv-f64", pool, entry, f"{site[0]}:{site[2]}",
                f"{op} produced float64 in Model.{entry} ({pool} pool) at "
                f"{site[0]}:{site[1]}",
                "keep float32 (cast numpy float64 inputs before use)"))
        for r in transfers:
            findings.append(_finding(
                "inv-transfer", pool, entry,
                f"{r.site[0]}:{r.site[2]}:{r.kind}",
                f"{r.kind} ({r.op}) inside Model.{entry} ({pool} pool) at "
                f"{r.site[0]}:{r.site[1]}",
                "make the tensor on the device, or once outside the call"))
        findings.extend(f for f in model_findings(log, f"{pool} pool")
                        if not any(f.detail.endswith(k)
                                   for k in ("upload", "download")))
        if moved:
            findings.append(_finding(
                "inv-pool", pool, entry, "data_ptr",
                f"Model.{entry} ({pool} pool) replaced pool tensor(s) "
                f"{moved}: not updated in place",
                "write into the pool with an in-place index_put_"))
        for op, nbytes, _tags, site in allocs:
            findings.append(_finding(
                "inv-pool", pool, entry, f"alloc:{site[0]}:{site[2]}",
                f"{op} allocated {nbytes} bytes (a pool tensor is "
                f"{pool_bytes}) inside Model.{entry} ({pool} pool) at "
                f"{site[0]}:{site[1]}",
                "index the pool's rows; never materialise a pool copy"))
    return InvariantReport(findings, rows)


def run_invariants(model, params, qc) -> InvariantReport:
    """:func:`check_entry_points` on an fp pool, then on a code pool whose
    codebook is fit from the model's own calibration prefill (as the
    engine fits one). Attention families only."""
    from repro_torch.core.kv_codebook import KVCodebook
    from repro_torch.models.model import RECURRENT
    from repro_torch.serve.engine import calibration_rows
    if model.cfg.family in RECURRENT:
        raise ValueError(
            "the invariants cover paged attention pools; the "
            f"{model.cfg.family!r} family keeps recurrent slot state "
            "(its syncs are the sync guard's to check)")
    rep = check_entry_points(model, params, qc)
    k_rows, v_rows = calibration_rows(model, params, qc, MAX_SEQ, PAGE)
    cb = KVCodebook.fit(k_rows, v_rows, v=qc.kv_v, c=qc.kv_c,
                        generator=torch.Generator(
                            device=model.device).manual_seed(0))
    code = check_entry_points(model, params, qc.replace(kv_quant="vq"),
                              codebook=cb, pool="code")
    return InvariantReport(rep.findings + code.findings,
                           rep.rows + code.rows)
