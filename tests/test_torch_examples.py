"""The PyTorch port's example twins (``examples/torch_*.py``) at their
smallest sizes on the CPU: each ``main`` runs and reports, the DSE
twin's heatmap CSV is byte for byte the JAX example's, and the LUTBoost
twin's stage ① captures every projection."""
import importlib.util
import os
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tier-1 run puts several test processes on
    the machine's cores, and small ops slow down many times over when
    every process also spreads each op over every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_twin(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.rstrip().endswith("OK")
    assert out["rel"] < 0.32 and out["fused_err"] < 1e-3
    assert "relative error vs dense GEMM" in text


def _jax_dse_csv(monkeypatch, path, flags):
    """The JAX example's heatmap at ``flags``. Its search finds no
    feasible design at any flags (its accuracy bound and memory bound
    exclude every point), and it then exits before the heatmap, so the
    search is stubbed with a design: the CSV rows do not depend on it."""
    from repro.dse.models import LutDlaPoint
    from repro.dse.search import SearchResult
    mod = _example("dse_search")
    monkeypatch.setattr(mod, "co_design_search", lambda cn, **kw: (
        SearchResult(LutDlaPoint(v=2, c=8), 1.0, "lut", 1.0, 1.0, 1.0), {}))
    monkeypatch.setattr(sys, "argv", ["dse_search.py", "--csv", path, *flags])
    mod.main()
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("flags", [[], ["--m", "64", "--k", "4096",
                                        "--n", "1024", "--area", "2.5"]],
                         ids=["defaults", "custom"])
def test_dse_twin_csv_is_the_jax_examples(flags, tmp_path, monkeypatch,
                                          capsys):
    ours = str(tmp_path / "torch.csv")
    rc = _example("torch_dse_search").main(
        ["--csv", ours, "--device", "cpu", *flags])
    text = capsys.readouterr().out
    assert rc == 0
    assert "pruning stats:" in text and "heatmap written to" in text
    with open(ours, "rb") as f:
        mine = f.read()
    theirs = _jax_dse_csv(monkeypatch, str(tmp_path / "jax.csv"), flags)
    assert mine == theirs
    assert mine.count(b"\n") == 1 + 3 * 7 * 4


@pytest.mark.parametrize("metric", ["l2", "chebyshev"])
def test_lutboost_twin_captures_every_projection(metric, capsys):
    out = _example("torch_lutboost_convert").main(
        ["--device", "cpu", "--steps", "2", "--stage2-steps", "1",
         "--stage3-steps", "1", "--metrics", metric])
    text = capsys.readouterr().out
    assert "dense model CE" in text
    assert set(out["metrics"]) == {metric}
    for metric, r in out["metrics"].items():
        # 3 smoke layers x (wq, wk, wv, wo, wg, wu, wd)
        assert r["captured"] == r["projections"] == 21, metric
        assert r["z_leaves"] == 21
        assert r["ce"] == r["ce"]                 # finite, not NaN
        assert f"stage ① captured 21 of 21 projections" in text


def test_train_lm_twin_trains_and_resumes(tmp_path, capsys):
    mod = _example("torch_train_lm")
    args = ["--device", "cpu", "--steps", "3", "--batch", "2", "--seq",
            "16", "--ckpt-dir", str(tmp_path / "ck")]
    hist = mod.main(args)
    assert len(hist["loss"]) == 3
    assert "model: lm-smoke" in capsys.readouterr().out
    assert mod.main(args) == {"loss": [], "step_time": []}
    assert "nothing to do" in capsys.readouterr().out
    hist = mod.main(["--device", "cpu", "--steps", "2", "--batch", "2",
                     "--seq", "16", "--lut",
                     "--ckpt-dir", str(tmp_path / "ck_lut")])
    assert len(hist["loss"]) == 2
    assert "lut=True" in capsys.readouterr().out


def test_serve_demo_twin_and_its_chaos_trace(tmp_path, capsys):
    mod = _example("torch_serve_demo")
    out = mod.main(["--device", "cpu", "--train-steps", "2",
                    "--trace", str(tmp_path / "t.json")])
    text = capsys.readouterr().out
    assert "speculative pass is token-identical" in text
    for tag in ("dense", "lut-int8", "dense+lut-draft"):
        assert f"[{tag}] 12 requests" in text
    assert out["streams"]["dense"] == out["streams"]["dense+lut-draft"]
    assert out["trace_events"] > 0
    out = mod.main(["--device", "cpu", "--train-steps", "2", "--chaos",
                    "--trace", str(tmp_path / "c.json")])
    text = capsys.readouterr().out
    assert "[chaos] 16 requests" in text and "faults fired" in text
    assert sum(out["by_reason"].values()) == 16
    assert os.path.getsize(tmp_path / "c.json") > 0


@pytest.mark.parametrize("name", ["torch_quickstart",
                                  "torch_lutboost_convert",
                                  "torch_train_lm", "torch_serve_demo"])
def test_twins_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _example(name).main([])
