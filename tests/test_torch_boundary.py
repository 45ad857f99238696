"""The port's boundaries: it imports nothing of JAX or of the JAX package,
its default-device entry points refuse to run without a CUDA device, and
a CUDA tensor never falls back to a plain version."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import qwen1p5_4b  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.codebook import CodebookSpec, init_centroids  # noqa
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.path[:0] = [{root!r}, {src!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import glob, importlib.util, os
files = sorted(glob.glob(os.path.join({root!r}, "examples", "torch_*.py")))
files += [os.path.join({root!r}, "scripts", name)
          for name in ("analyze_torch.py", "guard_serve.py")]
for path in files:
    spec = importlib.util.spec_from_file_location(
        "walk_" + os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(len(names), len(files), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    code = _IMPORT_ALL.format(root=ROOT, src=os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, n_files, bad = res.stdout.split(" ", 2)
    assert int(n) >= 60                 # every module of the package
    assert int(n_files) == 7            # five twins, the gate, the guard
    assert bad.strip() == "[]"


def test_new_modules_are_in_the_boundary_walk():
    """The speculative-decoding module, the dense configs, the
    observability, fault-injection and router modules, the Mamba2
    module and the SSM / hybrid configs, the training modules
    (LUTBoost, optimizer, compression, trainer, checkpoints, data), the
    audio / vlm configs, and the co-design, simulator and analysis
    modules are among the modules the boundary check imports."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.serve.speculative", "repro_torch.configs.yi_9b",
            "repro_torch.configs.gemma3_4b",
            "repro_torch.configs.gemma3_27b", "repro_torch.obs",
            "repro_torch.obs.metrics", "repro_torch.obs.tracing",
            "repro_torch.serve.faults", "repro_torch.serve.router",
            "repro_torch.models.mamba2", "repro_torch.configs.mamba2_2p7b",
            "repro_torch.configs.zamba2_1p2b", "repro_torch.core.lutboost",
            "repro_torch.train", "repro_torch.train.optimizer",
            "repro_torch.train.compression", "repro_torch.train.trainer",
            "repro_torch.checkpoint", "repro_torch.checkpoint.manager",
            "repro_torch.data", "repro_torch.data.synthetic",
            "repro_torch.tree", "repro_torch.configs.musicgen_large",
            "repro_torch.configs.paligemma_3b", "repro_torch.dse",
            "repro_torch.dse.models", "repro_torch.dse.ppa",
            "repro_torch.dse.search", "repro_torch.simulator",
            "repro_torch.simulator.cycle_sim", "repro_torch.analysis",
            "repro_torch.analysis.findings", "repro_torch.analysis.astlint",
            "repro_torch.analysis.sync_guard",
            "repro_torch.analysis.invariants"} <= names


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = qwen1p5_4b.smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32),
                           "blocks": {}}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_centroids(torch.Generator(), 16, CodebookSpec())


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a CUDA tensor looks
    like to the dispatch, on a machine without one."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _cuda_looking(a):
    return torch.from_numpy(a).as_subclass(_CudaLooking)


def test_cuda_tensors_never_fall_back_to_the_plain_versions():
    if _build.library_path("fused_amm").exists():
        pytest.skip("a built kernel library is present")
    rng = np.random.default_rng(0)
    x = _cuda_looking(rng.standard_normal((4, 3, 8)).astype(np.float32))
    z = _cuda_looking(rng.standard_normal((3, 16, 8)).astype(np.float32))
    lut = _cuda_looking(rng.standard_normal((3, 16, 5)).astype(np.float32))
    plain, launches = tref.vq_amm_ref.calls, ops.vq_amm_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        ops.vq_amm(x, z, lut)
    assert tref.vq_amm_ref.calls == plain
    assert ops.vq_amm_cuda.launches == launches
    q = _cuda_looking(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    pages = _cuda_looking(rng.standard_normal((5, 4, 4, 8)).astype(
        np.float32))
    new = _cuda_looking(rng.standard_normal((2, 1, 4, 8)).astype(np.float32))
    phys = _cuda_looking(np.zeros((2, 2), np.int32))
    plain = (tfd.flash_decode_splits.calls,
             tfd.flash_decode_paged_plain.calls, tfd.fold_splits.calls)
    with pytest.raises((RuntimeError, AssertionError)):
        tfd.flash_decode_paged(q, pages, pages, new, new, phys,
                               np.array([3, 4], np.int32))
    assert (tfd.flash_decode_splits.calls, tfd.flash_decode_paged_plain.calls,
            tfd.fold_splits.calls) == plain


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    if os.path.isfile("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is installed")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
