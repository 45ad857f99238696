"""Analysis gate of the PyTorch port: AST lint + invariants vs the
committed baseline.

Usage:  PYTHONPATH=src python scripts/analyze_torch.py \\
            [--baseline analysis/baseline_torch.json] [--update] \\
            [--no-invariants] [--src src] [-v]

Runs the AST lint over ``src/repro_torch``
(:mod:`repro_torch.analysis.astlint`) and — unless ``--no-invariants`` —
the paged entry points' invariants (:mod:`repro_torch.analysis.
invariants`) on the qwen1.5-4b and deepseek-moe-16b smoke configs on the
CPU (int8 LUTs, fp and code pools), then diffs the gating findings
against the committed baseline:

* a finding whose key is in the baseline is GRANDFATHERED (reported,
  exit 0);
* a NEW finding (key absent) fails with exit 1;
* a FIXED baselined key is reported so the baseline can be tightened.

``--update`` rewrites the baseline from the current findings (commit the
result; review the diff — shrinking is progress, growing needs a reason
in ROADMAP.md queue C). ``info``-severity findings are the host-sync
classification report (printed with ``-v``) and never gate.

The sync guard (:mod:`repro_torch.analysis.sync_guard`) drives engines
and runs in the tests (``tests/test_torch_analysis.py``) and on the card
(``chip_smoke.py``'s ``analysis`` phase), not here.
"""
from __future__ import annotations

import argparse
import collections
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

INVARIANT_CONFIGS = ("qwen1.5-4b", "deepseek-moe-16b")


def invariant_findings():
    """The invariants on the smoke configs, on the CPU."""
    import torch

    from repro_torch.analysis import run_invariants
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.lut import QuantConfig
    from repro_torch.models.model import Model
    qc = QuantConfig(mode="lut_infer", v=4, c=16, lut_dtype="int8")
    out = []
    for name in INVARIANT_CONFIGS:
        model = Model(get_smoke_config(name), device="cpu")
        params = model.init(torch.Generator().manual_seed(0), qc)
        out.extend(run_invariants(model, params, qc).findings)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline",
                    default=os.path.join(ROOT, "analysis/baseline_torch.json"))
    ap.add_argument("--update", action="store_true",
                    help="rewrite the baseline from current findings")
    ap.add_argument("--no-invariants", action="store_true",
                    help="skip the (model-running) invariant pass")
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="source root to lint")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info-severity classification")
    args = ap.parse_args(argv)

    from repro_torch.analysis import (diff_baseline, load_baseline,
                                      run_ast_lint, save_baseline)

    findings, graph = run_ast_lint(args.src)
    if not args.no_invariants:
        findings = findings + invariant_findings()

    n_model, n_step = len(graph.model_set), len(graph.step_loop)
    by_sev = collections.Counter(f.severity for f in findings)
    print(f"analyze_torch: {n_model} model-set fn(s), {n_step} step-loop "
          f"fn(s); {by_sev['error']} error / {by_sev['warn']} warn / "
          f"{by_sev['info']} info finding(s)")
    if args.verbose:
        for f in sorted(findings, key=lambda f: (f.path, f.line)):
            if f.severity == "info":
                print("  " + f.render())

    if args.update:
        save_baseline(args.baseline, findings)
        print(f"analyze_torch: baseline rewritten -> {args.baseline} "
              f"({by_sev['error'] + by_sev['warn']} key(s))")
        return 0

    baseline = load_baseline(args.baseline)
    new, grandfathered, fixed = diff_baseline(findings, baseline)
    for f in grandfathered:
        print(f"grandfathered (baseline): {f.render()}")
    for k in fixed:
        print(f"fixed (tighten baseline with --update): {k}")
    if new:
        print(f"\nanalyze_torch: {len(new)} NEW finding(s) not in "
              f"{os.path.relpath(args.baseline, ROOT)}:")
        for f in new:
            print(f.render())
        return 1
    print("analyze_torch: OK (no new findings)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
