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
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib"))
             or k == "repro" or k.startswith("repro."))
print(len(names), bad)
"""


def test_port_and_chip_smoke_import_no_jax_and_no_repro():
    code = _IMPORT_ALL.format(root=ROOT, src=os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.split(" ", 1)
    assert int(n) >= 19                 # every module of the package
    assert bad.strip() == "[]"


def test_new_modules_are_in_the_boundary_walk():
    """The speculative-decoding module and the dense configs are among
    the modules the boundary check imports."""
    import pkgutil

    import repro_torch
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")}
    assert {"repro_torch.serve.speculative", "repro_torch.configs.yi_9b",
            "repro_torch.configs.gemma3_4b",
            "repro_torch.configs.gemma3_27b"} <= names


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
