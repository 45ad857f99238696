"""Static analysis + dynamic checks for the serving hot path (port of
``repro.analysis``).

Three cooperating passes:

* :mod:`repro_torch.analysis.astlint` — AST lint over the whole package:
  host syncs reachable from the model entry points or the engine step
  loop, host RNG/clock inside the model, mutable default args,
  paged-allocator API misuse.
* :mod:`repro_torch.analysis.sync_guard` — a dispatch-level recorder of
  host syncs, host <-> device copies and kernel builds, and the guard
  asserting that steady-state serving reads the card once a decode step
  (one a finished prefill, at most two a speculative round), never
  inside a model entry point, and builds nothing (the eager port's
  counterpart of the JAX recompile guard).
* :mod:`repro_torch.analysis.invariants` — one call of each paged entry
  point on fp and code pools: no float64, no transfer, no sync, the pool
  updated in place (the counterpart of the jaxpr checks and donation).

Findings are keyed (:class:`~repro_torch.analysis.findings.Finding`) and
diffed against the committed ``analysis/baseline_torch.json`` by
``scripts/analyze_torch.py``: grandfathered debt passes, new findings
fail.
"""
from .findings import (BASELINE_VERSION, SEVERITIES, Finding, diff_baseline,
                       load_baseline, save_baseline)
from .astlint import MODEL_SEEDS, STEP_SEEDS, run_ast_lint
from .sync_guard import (EXPECTED_READS, GuardReport, SyncLog, SyncRecord,
                         run_sync_guard)
from .invariants import InvariantReport, check_entry_points, run_invariants

__all__ = [
    "BASELINE_VERSION", "SEVERITIES", "Finding", "load_baseline",
    "save_baseline", "diff_baseline", "MODEL_SEEDS", "STEP_SEEDS",
    "run_ast_lint", "EXPECTED_READS", "GuardReport", "SyncLog",
    "SyncRecord", "run_sync_guard", "InvariantReport", "check_entry_points",
    "run_invariants",
]
