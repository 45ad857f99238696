"""The port's analysis passes (``repro_torch.analysis``): the AST lint's
rules on seeded packages (each caught, each waived) and on the real
tree (equal to ``analysis/baseline_torch.json``), the sync guard on the
smoke configs (the read counts the JAX recompile-guard tests assert of
the JAX engine, ``tests/test_recompile_guard.py``), seeded syncs,
transfers, float64 and pool copies, and the invariants on fp and code
pools."""
import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import (EXPECTED_READS, SyncLog,  # noqa: E402
                                  check_entry_points, diff_baseline,
                                  load_baseline, run_ast_lint,
                                  run_invariants, run_sync_guard)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.lut import QuantConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.serve import Engine, Request, SpecConfig  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "analysis", "baseline_torch.json")
QC = QuantConfig(mode="lut_infer", v=4, c=16, lut_dtype="int8")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the machine's cores, and small ops slow down many times over when
    every process also spreads each op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "analyze_torch", os.path.join(ROOT, "scripts", "analyze_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# AST lint: one seeded violation per rule, caught, and silenced by its
# waiver; the gate (scripts/analyze_torch.py) fails on it and passes on
# the waived copy
# ---------------------------------------------------------------------------

# (rule, module path under repro_torch, source with a {W} waiver slot)
SEEDS = {
    "host-sync": ("models/model.py", """
        class Model:
            def decode_paged(self, x):
                return x.item(){W}
        """),
    "step-sync": ("serve/engine.py", """
        class Engine:
            def step(self):
                return self._helper()

            def _helper(self):
                return self.logits.cpu(){W}
        """),
    "host-rng": ("models/model.py", """
        import random

        class Model:
            def prefill_paged(self, x):
                return x * random.random(){W}
        """),
    "mutable-default": ("serve/policy.py", """
        def shed(queue, dropped=[]):{W}
            dropped.extend(queue)
            return dropped
        """),
    "allocator-free": ("serve/faults.py", """
        def release(table, page):
            table.allocator.free(page){W}
        """),
    "sync-site": ("convert.py", """
        def to_host(x):
            return x.numpy(){W}
        """),
}


def _mk_pkg(tmp_path, relpath, source):
    """A ``repro_torch`` package under tmp holding one module; returns its
    source root (what run_ast_lint and the gate's ``--src`` take)."""
    pkg = tmp_path / "src" / "repro_torch"
    path = pkg / relpath
    path.parent.mkdir(parents=True, exist_ok=True)
    for d in [pkg] + list(path.parents)[:len(path.parents) -
                                          len(pkg.parents) - 1]:
        (d / "__init__.py").write_text("")
    path.write_text(textwrap.dedent(source))
    return str(tmp_path / "src")


@pytest.mark.parametrize("rule", list(SEEDS))
def test_each_rule_caught_and_waived(rule, tmp_path, capsys):
    relpath, source = SEEDS[rule]
    src = _mk_pkg(tmp_path / "seeded", relpath, source.replace("{W}", ""))
    found = [f for f in run_ast_lint(src)[0] if f.rule == rule]
    assert len(found) == 1, found
    assert found[0].severity == {"sync-site": "info", "step-sync": "warn",
                                 "mutable-default": "error"}.get(
        rule, "error")
    waived = _mk_pkg(tmp_path / "waived", relpath,
                     source.replace("{W}", f"  # analysis: ok({rule})"))
    assert [f for f in run_ast_lint(waived)[0] if f.rule == rule] == []
    gate = _load_script().main
    empty = str(tmp_path / "empty.json")
    rc = gate(["--no-invariants", "--src", src, "--baseline", empty])
    out = capsys.readouterr().out
    if rule == "sync-site":          # classification only: never gates
        assert rc == 0, out
    else:
        assert rc == 1 and "NEW finding" in out and rule in out, out
    assert gate(["--no-invariants", "--src", waived,
                 "--baseline", empty]) == 0


@pytest.mark.parametrize("expr,kind", [
    ("x.tolist()", "tolist"), ("x.numpy()", "numpy"),
    ('x.to("cpu")', "to_cpu"), ("int(x.sum())", "int()"),
    ("bool(torch.any(x > 0))", "bool()"), ("float(x.max())", "float()"),
    ("torch.cuda.synchronize()", "cuda.synchronize"),
    ("np.asarray(x)", "np.asarray"), ("x.nonzero()", "nonzero"),
    ("torch.nonzero(x)", "nonzero"),
])
def test_host_sync_forms_in_the_model_set(expr, kind, tmp_path):
    src = _mk_pkg(tmp_path, "kernels/ops.py", f"""
        import numpy as np
        import torch

        def _inner(x, win):
            n = int(win) + int(np.ceil(win / 2)) + int(len(x.shape))
            return {expr}, n

        def vq_amm(x, win):
            return _inner(x, win)
        """)
    fs = [f for f in run_ast_lint(src)[0] if f.severity != "info"]
    assert [(f.rule, f.detail, f.symbol) for f in fs] == \
        [("host-sync", f"{kind}#0", "_inner")]


def test_finding_keys_stable_across_line_churn(tmp_path):
    relpath, source = SEEDS["host-sync"]
    src = _mk_pkg(tmp_path, relpath, source.replace("{W}", ""))
    keys1 = {f.key for f in run_ast_lint(src)[0]}
    path = tmp_path / "src" / "repro_torch" / relpath
    path.write_text("\n\n# a comment\n" + path.read_text())
    assert {f.key for f in run_ast_lint(src)[0]} == keys1


def test_repo_tree_lint_equals_the_committed_baseline():
    findings, graph = run_ast_lint(os.path.join(ROOT, "src"))
    gating = {f.key for f in findings if f.severity != "info"}
    baseline = load_baseline(BASELINE)
    new, _grand, fixed = diff_baseline(findings, baseline)
    assert new == [] and fixed == []
    assert gating == set(baseline)
    assert not [f for f in findings if f.severity == "error"]
    # the entry points are really in the sets: an import-graph regression
    # would blind the lint
    for q in ("models.model.Model.decode_paged", "models.moe.moe_ffn",
              "models.mamba2.mamba2_decode",
              "kernels.fused_amm.vq_amm_cuda",
              "kernels.flash_decode.flash_decode_paged"):
        assert f"repro_torch.{q}" in graph.model_set, q
    for q in ("serve.engine.Engine._decode_step",
              "serve.engine.Engine._spec_decode_step",
              "serve.speculative.accept_tokens",
              "serve.scheduler.SlotScheduler.admit"):
        assert f"repro_torch.{q}" in graph.step_loop, q


def test_gate_passes_on_the_tree_in_a_subprocess():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable,
                        os.path.join(ROOT, "scripts", "analyze_torch.py")],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK (no new findings)" in r.stdout


# ---------------------------------------------------------------------------
# the sync guard on the smoke configs
# ---------------------------------------------------------------------------

def _model(name):
    m = Model(get_smoke_config(name), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0), QC)


def _engine(m, params, **kw):
    return Engine(m, params, QC, batch_size=2, max_seq=32, page_size=8,
                  prefill_chunk=4, **kw)


def _mixed(base):
    """Chunked prefill (a 6-token prompt over 4-wide chunks), short and
    long greedy decodes and a temperature slot, as the JAX guard's
    workload."""
    return [Request(tokens=[base, base + 1, base + 2], max_new_tokens=4),
            Request(tokens=[base + 3] * 6, max_new_tokens=3),
            Request(tokens=[base + 4, base + 5], max_new_tokens=2,
                    temperature=0.7)]


@pytest.mark.parametrize("name", ["qwen1.5-4b", "deepseek-moe-16b",
                                  "mamba2-2.7b"])
def test_sync_guard_one_read_a_decode_step(name):
    """A greedy request costs one host read a token: its finished
    prefill's plus one a decode step (JAX: ``device_reads == 6``)."""
    m, params = _model(name)
    eng = _engine(m, params)
    rep = run_sync_guard(eng, _mixed(3),
                         [Request(tokens=[3, 4, 5], max_new_tokens=6)])
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    c = rep.counts
    assert c["device_reads"] == 6
    assert (c["decode_steps"], c["prefills"]) == (5, 1)
    assert (c["reads_decode"], c["reads_prefill"]) == (5, 1)
    assert c["model_records"] == 0 and c["step_syncs"] == 0
    assert (c["builds"], c["loads"]) == (0, 0)
    # the warmup's mixed workload reads once a decode step and prefill too
    assert rep.warmup.in_model() == []


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "zamba2-1.2b"])
def test_guard_script_on_a_smoke_config(name, capsys):
    spec = importlib.util.spec_from_file_location(
        "guard_serve", os.path.join(ROOT, "scripts", "guard_serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--config", name, "--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "decode steps (1.00 a step)" in out
    assert "records in model entry points 0" in out
    assert "FINDING" not in out


def test_sync_guard_speculative_rounds_read_at_most_twice():
    m, params = _model("qwen1.5-4b")
    eng = _engine(m, params, spec_decode=SpecConfig(k=3, drafter="ngram"))

    def reqs(b):
        return [Request(tokens=[b, b + 1, b + 2, b, b + 1], max_new_tokens=5),
                Request(tokens=[b + 3, b + 4], max_new_tokens=4)]
    rep = run_sync_guard(eng, reqs(3), reqs(9))
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    c = rep.counts
    assert c["spec_rounds"] > 0
    assert c["device_reads"] == 2 + c["reads_spec"]      # two prefills
    assert c["spec_rounds"] <= c["reads_spec"] <= \
        EXPECTED_READS["spec_round"] * c["spec_rounds"]


def test_seeded_item_in_decode_paged_is_sync_model(monkeypatch):
    m, params = _model("qwen1.5-4b")
    head = Model._head

    def syncing_head(self, p, x):
        if float(x.abs().sum().item()) < 0:       # a host branch
            raise AssertionError
        return head(self, p, x)
    monkeypatch.setattr(Model, "_head", syncing_head)
    rep = run_sync_guard(_engine(m, params), _mixed(3), _mixed(11))
    sm = [f for f in rep.findings if f.rule == "sync-model"]
    assert {f.detail for f in sm} >= {"model.decode_paged:scalar_read",
                                      "model.prefill_paged:scalar_read"}
    assert all(f.symbol == "decode_paged" or f.symbol == "prefill_paged"
               or f.path.endswith("model.py") for f in sm)
    assert rep.counts["model_records"] > 0


def test_steady_state_build_is_build_steady():
    m, params = _model("qwen1.5-4b")
    eng = _engine(m, params)
    steady = [Request(tokens=[3, 4, 5], max_new_tokens=3)]
    call = eng._decode_call

    def building_call(*a):
        if steady[0].out_tokens:            # only once the steady run runs
            _build.build.compiles += 1
        return call(*a)
    eng._decode_call = building_call
    rep = run_sync_guard(eng, _mixed(3), steady)
    assert [f.rule for f in rep.findings] == ["build-steady"]
    assert rep.counts["builds"] >= 1


def test_sync_log_tags_phases_and_classifies_copies():
    x = torch.arange(6.0)
    with SyncLog(cuda=False) as log:
        with log.tag("model.decode_paged"):
            x.to("meta")                     # a copy to another device
            bool((x > 2).any())
            x[x > 2]
        int(x.sum())
    kinds = [(r.kind, r.entry_point) for r in log.records]
    assert kinds == [("upload", "model.decode_paged"),
                     ("scalar_read", "model.decode_paged"),
                     ("bool_index", "model.decode_paged"),
                     ("scalar_read", None)]
    assert log.debug_warnings is None


# ---------------------------------------------------------------------------
# invariants on fp and code pools
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["qwen1.5-4b", "deepseek-moe-16b"])
def test_invariants_hold_on_fp_and_code_pools(name):
    m, params = _model(name)
    rep = run_invariants(m, params, QC)
    assert rep.ok, "\n".join(f.render() for f in rep.findings)
    assert [(r["pool"], r["entry"]) for r in rep.rows] == [
        (p, e) for p in ("fp", "code")
        for e in ("prefill_paged", "decode_paged", "verify_paged")]
    assert all(r["pool_ptrs_same"] and r["records"] == 0
               and r["float64"] == 0 and r["big_allocs"] == 0
               for r in rep.rows)


@pytest.mark.parametrize("seed", ["f64", "transfer", "sync", "pool-copy",
                                  "pool-alloc"])
def test_invariants_catch_seeded_violations(seed, monkeypatch):
    m, params = _model("qwen1.5-4b")
    head = Model._head
    decode = Model.decode_paged

    def bad_head(self, p, x):
        out = head(self, p, x)
        if seed == "f64":
            return out.double()
        if seed == "transfer":
            out.to("meta")
        if seed == "sync":
            out.sum().item()
        return out

    def bad_decode(self, params, tokens, kv, *a, **kw):
        if seed == "pool-copy":
            kv["k"] = kv["k"].clone()
        if seed == "pool-alloc":
            torch.zeros_like(kv["v"])
        return decode(self, params, tokens, kv, *a, **kw)
    monkeypatch.setattr(Model, "_head", bad_head)
    monkeypatch.setattr(Model, "decode_paged", bad_decode)
    rep = check_entry_points(m, params, QC)
    rules = {f.rule for f in rep.findings}
    want = {"f64": "inv-f64", "transfer": "inv-transfer",
            "sync": "sync-model", "pool-copy": "inv-pool",
            "pool-alloc": "inv-pool"}[seed]
    assert want in rules, [f.render() for f in rep.findings]
    if seed.startswith("pool"):
        assert {f.symbol for f in rep.findings} == {"Model.decode_paged"}
