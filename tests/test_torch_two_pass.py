"""Port parity: the two-pass path (``QuantConfig(fuse=False)``): kernel B3's
plain version (``ops.vq_assign``) and kernel B4's (``ops.lut_matmul``)
against the JAX package's Pallas kernels (interpret mode) and oracles, the
two-pass projection, and a smoke-size qwen chain, on the same numpy
inputs (float32, CPU).

Tolerances: indices exactly equal on margin inputs (every sub-vector a
centroid plus small noise), tie-aware on random inputs (compared where
the JAX distances separate the best centroid from the second by more than
1e-5); LUT sums at 1e-5 (float32 sums in another order; int8 sums are
exact); model logits at 1e-4, as the fused chain in test_torch_model.py.
Within the port, two-pass and fused agree bit for bit on int8 LUTs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import lut as jlut  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core import similarity as jsim  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.assign import vq_assign_pallas  # noqa: E402
from repro.kernels.lut_gemm import lut_gemm_pallas  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import lut as tlut  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402

METRICS = ["l2", "l1", "chebyshev"]
GAP = 1e-5
ATOL = 1e-5
# ragged (M, nc, v, c, N): none a multiple of the JAX blocks used below
RAGGED = [(17, 5, 3, 7, 33), (23, 11, 8, 16, 130), (1, 3, 4, 9, 50)]


def _np(t):
    return np.asarray(t)


def _margin_inputs(m, nc, v, c, seed):
    """x = a centroid + small noise: every argmin has a clear margin."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((nc, c, v)).astype(np.float32)
    pick = rng.integers(0, c, (m, nc))
    x = (z[np.arange(nc)[None], pick]
         + 0.01 * rng.standard_normal((m, nc, v))).astype(np.float32)
    return x, z, pick.astype(np.int32)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("shape", RAGGED[:2])
def test_vq_assign_matches_jax_kernel_and_ref(metric, shape):
    """B3's plain version vs vq_assign_pallas (interpret, ragged padding
    path) and the JAX oracle: equal on margin inputs, tie-aware equal on
    random inputs."""
    m, nc, v, c, _ = shape
    x, z, pick = _margin_inputs(m, nc, v, c, m * c + v)
    before = tref.assign_ref.calls
    got = tops.vq_assign(torch.from_numpy(x), torch.from_numpy(z), metric)
    assert tref.assign_ref.calls == before + 1        # CPU -> plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, nc)
    jx, jz = jnp.asarray(x), jnp.asarray(z)
    want = _np(vq_assign_pallas(jx, jz, metric, block_m=8, block_k=4,
                                interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pick)
    np.testing.assert_array_equal(got.numpy(),
                                  _np(jref.assign_ref(jx, jz, metric)))
    rng = np.random.default_rng(m + nc)
    xr = rng.standard_normal((m, nc, v)).astype(np.float32)
    got_r = tops.vq_assign(torch.from_numpy(xr), torch.from_numpy(z),
                           metric).numpy()
    want_r = _np(vq_assign_pallas(jnp.asarray(xr), jz, metric, block_m=8,
                                  block_k=4, interpret=True))
    d = np.sort(_np(jsim.pairwise_distance_subspaces(jnp.asarray(xr), jz,
                                                     metric)), axis=-1)
    clear = (d[..., 1] - d[..., 0]) > GAP
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(got_r[clear], want_r[clear])


def test_vq_assign_bf16_inputs_and_ties():
    """bf16 x and z: distances in float32 on both sides; all-zero inputs
    tie everywhere and the lowest index wins."""
    x, z, pick = _margin_inputs(9, 6, 4, 16, 5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    zb = torch.from_numpy(z).to(torch.bfloat16)
    want = _np(vq_assign_pallas(jnp.asarray(x, jnp.bfloat16),
                                jnp.asarray(z, jnp.bfloat16), "l2",
                                interpret=True))
    np.testing.assert_array_equal(tops.vq_assign(xb, zb).numpy(), want)
    np.testing.assert_array_equal(want, pick)
    for metric in METRICS:
        idx = tops.vq_assign(torch.zeros((3, 2, 4)), torch.zeros((2, 5, 4)),
                             metric)
        assert (idx == 0).all()


def _lut_inputs(m, nc, c, n, lut_dtype, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, c, (m, nc)).astype(np.int32)
    lut = rng.standard_normal((nc, c, n)).astype(np.float32)
    scale = None
    if lut_dtype == "int8":
        lut = rng.integers(-127, 128, (nc, c, n)).astype(np.int8)
        scale = (0.01 + rng.random(n)).astype(np.float32)
    elif lut_dtype == "bfloat16":
        lut = np.asarray(jnp.asarray(lut, jnp.bfloat16))
    return idx, lut, scale


def _to_torch(a):
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.uint16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("lut_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("shape", RAGGED)
def test_lut_matmul_matches_jax_kernel_and_ref(lut_dtype, shape):
    """B4's plain version vs lut_gemm_pallas (interpret, ragged padding
    path) and the JAX gather oracle, for every LUT type."""
    m, nc, _, c, n = shape
    idx, lut, scale = _lut_inputs(m, nc, c, n, lut_dtype, m + nc + n)
    ts = None if scale is None else torch.from_numpy(scale)
    before = tref.lut_gemm_onehot.calls
    got = tops.lut_matmul(torch.from_numpy(idx), _to_torch(lut), ts)
    assert tref.lut_gemm_onehot.calls == before + 1   # CPU -> plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    js = None if scale is None else jnp.asarray(scale)
    want = _np(lut_gemm_pallas(jnp.asarray(idx), jnp.asarray(lut), js,
                               block_m=8, block_n=32, block_k=4,
                               interpret=True))
    oracle = _np(jref.lut_gemm_ref(jnp.asarray(idx), jnp.asarray(lut), js))
    for w in (want, oracle):
        np.testing.assert_allclose(got.numpy(), w, rtol=ATOL, atol=ATOL)
    if lut_dtype == "int8":          # integer sums: exact before the scale
        sums = tref.lut_gemm_onehot(torch.from_numpy(idx), _to_torch(lut))
        assert torch.equal(sums, torch.round(sums))


@pytest.mark.parametrize("lut_dtype", ["float32", "int8"])
def test_lut_linear_apply_two_pass_matches_jax(lut_dtype):
    rng = np.random.default_rng(3)
    k, n, v, c = 32, 24, 8, 16
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)
    z = 0.5 * rng.standard_normal((k // v, c, v)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    x = rng.standard_normal((2, 5, k)).astype(np.float32)
    qc_j = jlut.QuantConfig(mode="lut_infer", lut_dtype=lut_dtype, v=v,
                            c=c, fuse=False, impl="pallas")
    qc_t = tlut.QuantConfig(mode="lut_infer", lut_dtype=lut_dtype, v=v,
                            c=c, fuse=False)
    p_j = jlut.precompute_layer({"w": jnp.asarray(w), "z": jnp.asarray(z),
                                 "b": jnp.asarray(b)}, qc_j)
    p_t = {key: torch.from_numpy(np.array(val)) for key, val in p_j.items()}
    calls = tref.assign_ref.calls, tref.lut_gemm_onehot.calls
    out_j, _ = jlut.lut_linear_apply(p_j, jnp.asarray(x), qc_j)
    out_t = tlut.lut_linear_apply(p_t, torch.from_numpy(x), qc_t)
    assert (tref.assign_ref.calls, tref.lut_gemm_onehot.calls) == \
        (calls[0] + 1, calls[1] + 1)
    np.testing.assert_allclose(out_t.numpy(), _np(out_j), rtol=1e-4,
                               atol=1e-4)
    fused = tlut.lut_linear_apply(p_t, torch.from_numpy(x),
                                  qc_t.replace(fuse=True))
    if lut_dtype == "int8":
        assert torch.equal(out_t, fused)
    else:
        torch.testing.assert_close(out_t, fused, rtol=ATOL, atol=ATOL)


# ---------------------------------------------------------------------------
# model and engine
# ---------------------------------------------------------------------------

PS, MAX_SEQ, N_PAGES, CHUNK = 8, 32, 10, 4


@pytest.fixture(scope="module")
def pair():
    jm = JModel(jcfg.smoke_config())
    qc_j = jlut.QuantConfig(mode="lut_infer", lut_dtype="int8", fuse=False,
                            impl="pallas", flash="pallas")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(2), jlut.QuantConfig(mode="lut_train")),
        qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")
    qc_t = tlut.QuantConfig(mode="lut_infer", lut_dtype="int8", fuse=False)
    return jm, params_j, qc_j, tm, params_t, qc_t


def test_two_pass_prefill_and_decode_chain_match_jax(pair):
    """Chunked prefill of two slots plus a 4-step greedy decode chain with
    fuse=False on both sides (JAX: B3 and B4 Pallas kernels in interpret
    mode, B2 for decode) at 1e-4; greedy argmax identical."""
    jm, params_j, qc_j, tm, params_t, qc_t = pair
    table = np.full((2, MAX_SEQ // PS), -1, np.int32)
    table[0, :2] = [5, 2]
    table[1, :2] = [0, 7]
    prompts = [list(range(3, 14)), [40, 41, 42, 43, 44, 45]]
    kv_j = jm.init_paged_cache(2, MAX_SEQ, PS, num_pages=N_PAGES)
    kv_t = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES)
    pf_j = jax.jit(lambda p, t, kv, pt, s, pos, v: jm.prefill_paged(
        p, t, kv, pt, s, pos, v, qc_j))
    dec_j = jax.jit(lambda p, t, kv, pt, pos: jm.decode_paged(
        p, t, kv, pt, pos, qc_j))
    table_t = torch.from_numpy(table)
    last = {}
    for slot, prompt in enumerate(prompts):
        for pos in range(0, len(prompt), CHUNK):
            chunk = prompt[pos:pos + CHUNK]
            toks = np.zeros((1, CHUNK), np.int32)
            toks[0, :len(chunk)] = chunk
            lg_j, kv_j = pf_j(params_j, jnp.asarray(toks), kv_j,
                              jnp.asarray(table), slot, pos, len(chunk))
            lg_t = tm.prefill_paged(params_t, torch.from_numpy(toks), kv_t,
                                    table_t, slot, pos, len(chunk), qc_t)
            np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), atol=1e-4)
        last[slot] = int(np.argmax(_np(lg_j)[0]))
        assert int(lg_t.argmax()) == last[slot]
    positions = np.array([len(p) for p in prompts], np.int32)
    toks = np.array([[last[0]], [last[1]]], np.int32)
    for _ in range(4):
        lg_j, kv_j = dec_j(params_j, jnp.asarray(toks), kv_j,
                           jnp.asarray(table), jnp.asarray(positions))
        lg_t = tm.decode_paged(params_t, torch.from_numpy(toks), kv_t,
                               table_t, torch.from_numpy(positions), qc_t)
        np.testing.assert_allclose(lg_t.numpy(), _np(lg_j), atol=1e-4)
        nxt = _np(lg_j).argmax(-1)
        np.testing.assert_array_equal(lg_t.numpy().argmax(-1), nxt)
        toks = nxt[:, None].astype(np.int32)
        positions += 1


def test_two_pass_equals_fused_bitwise_in_the_port(pair):
    """int8 LUTs: every projection is an exact integer sum times the same
    scale either way, so prefill and decode logits are bit-identical."""
    *_, tm, params_t, qc_t = pair
    out = {}
    for fuse in (True, False):
        qc = qc_t.replace(fuse=fuse)
        kv = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES)
        table = torch.arange(MAX_SEQ // PS, dtype=torch.int32)[None]
        lg = [tm.prefill_paged(params_t, torch.tensor([[7, 8, 9, 10, 11]]),
                               kv, table, 0, 0, 5, qc)]
        tok = lg[0].argmax(-1)[:, None].to(torch.int32)
        for step in range(3):
            lg.append(tm.decode_paged(params_t, tok, kv, table,
                                      torch.tensor([5 + step],
                                                   dtype=torch.int32), qc))
            tok = lg[-1].argmax(-1)[:, None].to(torch.int32)
        out[fuse] = lg
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


def test_two_pass_engine_tokens_equal_fused_engine(pair):
    """The engine under fuse=False gives the fused engine's tokens, a
    temperature request included (same logits, same seeded streams)."""
    *_, tm, params_t, qc_t = pair
    outs = {}
    for fuse in (True, False):
        eng = TEngine(tm, params_t, qc_t.replace(fuse=fuse), batch_size=2,
                      max_seq=MAX_SEQ, page_size=PS, prefill_chunk=CHUNK,
                      seed=3)
        reqs = [Request(tokens=[3, 4, 5, 6, 7], max_new_tokens=6),
                Request(tokens=[9, 10], max_new_tokens=6, temperature=2.0),
                Request(tokens=[11, 12, 13], max_new_tokens=4)]
        eng.run(reqs)
        outs[fuse] = [r.out_tokens for r in reqs]
    assert outs[True] == outs[False]



def test_cuda_tensors_never_fall_back_to_the_plain_versions():
    from repro_torch.kernels import _build
    from test_torch_boundary import _cuda_looking as cuda_looking
    if any(_build.library_path(n).exists() for n in ("assign", "lut_gemm")):
        pytest.skip("a built kernel library is present")
    rng = np.random.default_rng(0)

    x = cuda_looking(rng.standard_normal((4, 3, 8)).astype(np.float32))
    z = cuda_looking(rng.standard_normal((3, 16, 8)).astype(np.float32))
    idx = cuda_looking(np.zeros((4, 3), np.int32))
    lut = cuda_looking(rng.standard_normal((3, 16, 5)).astype(np.float32))
    calls = tref.assign_ref.calls, tref.lut_gemm_onehot.calls
    launches = tops.vq_assign_cuda.launches, tops.lut_gemm_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tops.vq_assign(x, z)
    with pytest.raises(RuntimeError, match="nvcc"):
        tops.lut_matmul(idx, lut)
    assert (tref.assign_ref.calls, tref.lut_gemm_onehot.calls) == calls
    assert (tops.vq_assign_cuda.launches,
            tops.lut_gemm_cuda.launches) == launches
