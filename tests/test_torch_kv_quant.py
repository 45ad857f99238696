"""Port parity: VQ KV pages (``QuantConfig(kv_quant="vq")``): the codebook
(encode/decode, exact cover, k-means), kernel B5's plain version and the
quantized-pool decode against the JAX package's Pallas kernel (interpret
mode) and its dequantize-then-reference oracle, the model's code pool,
and the serving engine, on the same numpy inputs (float32, CPU).

Tolerances: codes compared exactly (tie-aware on random rows: where the
JAX distances separate the best centroid from the second by more than
1e-5); decoded rows and exact-cover round trips bit for bit; k-means
centroids from a shared init at 1e-5; flash decode outputs at 1e-5
(float32 softmax sums in another order; the sentinel compared in its own
dtype); model logits and calibration rows at 1e-4, as the fp chains in
test_torch_model.py; greedy tokens identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen1p5_4b as jcfg  # noqa: E402
from repro.core import codebook as jcb  # noqa: E402
from repro.core import kv_codebook as jkv  # noqa: E402
from repro.core import precompute_model  # noqa: E402
from repro.core.lut import QuantConfig as JQC  # noqa: E402
from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels.ref import flash_decode_kvq_ref as j_kvq_ref  # noqa
from repro.models.model import Model as JModel  # noqa: E402
from repro.serve import Engine as JEngine  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro_torch.configs import qwen1p5_4b as tcfg  # noqa: E402
from repro_torch.convert import (kv_codebook_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core import codebook as tcb  # noqa: E402
from repro_torch.core import kv_codebook as tkv  # noqa: E402
from repro_torch.core.lut import QuantConfig as TQC  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels.ref import flash_decode_kvq_ref  # noqa: E402
from repro_torch.models.model import Model as TModel  # noqa: E402
from repro_torch.serve.engine import Engine as TEngine  # noqa: E402
from repro_torch.serve.engine import calibration_rows  # noqa: E402
from repro_torch.serve.scheduler import Request  # noqa: E402

GAP = 1e-5
ATOL = 1e-5


def _np(t):
    return np.asarray(t)


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# codebook
# ---------------------------------------------------------------------------

def test_quant_config_kv_options_match_jax():
    for kw in ({}, {"kv_quant": "vq"}, {"kv_quant": "vq", "kv_v": 8,
                                         "kv_c": 256}):
        t, j = TQC(**kw), JQC(**kw)
        assert (t.kv_quant, t.kv_v, t.kv_c) == (j.kv_quant, j.kv_v, j.kv_c)
    for bad in ({"kv_quant": "int4"}, {"kv_quant": "vq", "kv_c": 300}):
        with pytest.raises(ValueError):
            JQC(**bad)
        with pytest.raises(ValueError):
            TQC(**bad)


@pytest.mark.parametrize("nc,c,v,kvh", [(4, 16, 4, 3), (2, 7, 3, 1),
                                        (1, 256, 8, 2)])
def test_kv_encode_decode_match_jax(nc, c, v, kvh):
    rng = np.random.default_rng(nc * c + v)
    z = rng.standard_normal((nc, c, v)).astype(np.float32)
    s = (np.abs(rng.standard_normal(kvh)) + 0.5).astype(np.float32)
    rows = (2 * rng.standard_normal((5, 6, kvh, nc * v))).astype(np.float32)
    codes_j = _np(jkv.kv_encode(jnp.asarray(rows), jnp.asarray(z),
                                jnp.asarray(s)))
    codes_t = tkv.kv_encode(_t(rows), _t(z), _t(s))
    assert codes_t.dtype == torch.uint8 and codes_t.shape == codes_j.shape
    x = (rows / s[:, None]).reshape(5, 6, kvh, nc, v)
    d = np.sort(((x[..., None, :] - z[None, None, None]) ** 2).sum(-1), -1)
    clear = (d[..., 1] - d[..., 0]) > GAP
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(codes_t.numpy()[clear], codes_j[clear])
    dec_j = _np(jkv.kv_decode(jnp.asarray(codes_j), jnp.asarray(z),
                              jnp.asarray(s)))
    dec_t = tkv.kv_decode(_t(codes_j), _t(z), _t(s))
    np.testing.assert_array_equal(dec_t.numpy(), dec_j)
    assert tkv.kv_decode(_t(codes_j), _t(z), _t(s),
                         torch.bfloat16).dtype == torch.bfloat16


def test_from_rows_exact_cover_roundtrip_bit_identical():
    rng = np.random.default_rng(3)
    l, t, kvh, hd = 2, 5, 3, 16
    rows_k = rng.standard_normal((l, t, kvh, hd)).astype(np.float32)
    rows_v = rng.standard_normal((l, t, kvh, hd)).astype(np.float32)
    cb = tkv.KVCodebook.from_rows(_t(rows_k), _t(rows_v))
    cb_j = jkv.KVCodebook.from_rows(jnp.asarray(rows_k), jnp.asarray(rows_v))
    assert (cb.nc, cb.c, cb.v) == (1, t * kvh, hd) == (cb_j.nc, cb_j.c,
                                                      cb_j.v)
    for key, leaf in cb.tree().items():
        np.testing.assert_array_equal(leaf.numpy(), _np(cb_j.tree()[key]))
    for which, rows in (("k", rows_k), ("v", rows_v)):
        codes = cb.encode(_t(rows), which)
        assert codes.dtype == torch.uint8
        np.testing.assert_array_equal(cb.decode(codes, which).numpy(), rows)
    assert cb.sk.data_ptr() != cb.sv.data_ptr()      # distinct buffers
    with pytest.raises(ValueError, match="exact-cover"):
        tkv.KVCodebook.from_rows(torch.zeros((1, 130, 2, 8)),
                                 torch.zeros((1, 130, 2, 8)))


def test_codebook_validation_fingerprint_and_transport():
    z = torch.zeros((2, 4, 300, 4))
    with pytest.raises(ValueError, match="uint8"):
        tkv.KVCodebook(zk=z, zv=z, sk=torch.ones((2, 2)),
                       sv=torch.ones((2, 2)))
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
    cb_j = jkv.KVCodebook.fit(jnp.asarray(rows), jnp.asarray(rows + 0.5),
                              v=4, c=4, iters=2, key=jax.random.PRNGKey(0))
    cb = kv_codebook_from_numpy(
        jax.tree_util.tree_map(np.asarray, cb_j.tree()), device="cpu")
    for key, leaf in cb.tree().items():
        np.testing.assert_array_equal(leaf.numpy(), _np(cb_j.tree()[key]))
    assert cb.head_dim == 8 and cb.equivalent_bits == pytest.approx(
        cb_j.equivalent_bits) == pytest.approx(0.5)
    assert cb.bytes_per_token_per_kv_head == cb_j.bytes_per_token_per_kv_head
    assert cb.fingerprint() == tkv.codebook_from_tree(cb.tree()).fingerprint()
    other = tkv.KVCodebook(zk=cb.zk + 1.0, zv=cb.zv, sk=cb.sk, sv=cb.sv)
    assert cb.fingerprint() != other.fingerprint()


@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
def test_kmeans_lloyd_matches_jax_from_a_shared_init(metric):
    """Seeding streams differ between the frameworks, so the port starts
    from the JAX init (x[perm] for the same key); every Lloyd update,
    empty-cluster re-seed included, must then agree."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 4)).astype(np.float32)
    x[:8] += 6.0                     # a far clump: clusters go empty
    key = jax.random.PRNGKey(4)
    c = 12
    init = x[_np(jax.random.permutation(key, 64))[:c]]
    want = _np(jcb.kmeans(jnp.asarray(x), c, metric, iters=6, key=key))
    got = tcb.kmeans(_t(x), c, metric, iters=6, init=_t(init))
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    # a batch of problems is each problem on its own
    xs = np.stack([x, x[::-1].copy()])
    inits = np.stack([init, init[::-1].copy()])
    got2 = tcb.kmeans(_t(xs), c, metric, iters=6, init=_t(inits))
    for i in range(2):
        np.testing.assert_allclose(
            got2[i].numpy(), tcb.kmeans(_t(xs[i]), c, metric, iters=6,
                                        init=_t(inits[i])).numpy(),
            rtol=ATOL, atol=ATOL)


def test_fit_scales_match_jax_and_fit_is_deterministic():
    rng = np.random.default_rng(1)
    rows_k = rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    rows_v = 3 * rng.standard_normal((2, 24, 2, 16)).astype(np.float32)
    cb_j = jkv.KVCodebook.fit(jnp.asarray(rows_k), jnp.asarray(rows_v),
                              v=4, c=8, iters=3, key=jax.random.PRNGKey(0))
    cb = tkv.KVCodebook.fit(_t(rows_k), _t(rows_v), v=4, c=8, iters=3)
    np.testing.assert_allclose(cb.sk.numpy(), _np(cb_j.sk), rtol=1e-6)
    np.testing.assert_allclose(cb.sv.numpy(), _np(cb_j.sv), rtol=1e-6)
    assert cb.zk.shape == cb_j.zk.shape and cb.zv.shape == cb_j.zv.shape
    again = tkv.KVCodebook.fit(_t(rows_k), _t(rows_v), v=4, c=8, iters=3)
    assert cb.fingerprint() == again.fingerprint()
    # every centroid is a mean of normalised rows: inside their range
    xs = rows_k / cb.sk.numpy()[:, None, :, None]
    assert np.abs(cb.zk.numpy()).max() <= np.abs(xs).max() + 1e-6
    with pytest.raises(ValueError, match="divisible"):
        tkv.KVCodebook.fit(_t(rows_k), _t(rows_v), v=5)


# ---------------------------------------------------------------------------
# kernel B5's plain version and flash_decode_paged(codebook=)
# ---------------------------------------------------------------------------

def _kvq_case(seed, slots=4, np_=5, ps=4, kvh=2, g=1, d=16, nc=4, c=16,
              positions=(16, 17, 9, -1)):
    """Random code pool over permuted pages (unallocated -> trash), a
    random codebook with per-head scales, fp q / k_new / v_new."""
    rng = np.random.default_rng(seed)
    p1 = slots * np_ + 1
    v = d // nc
    kc = rng.integers(0, c, (p1, ps, kvh, nc)).astype(np.uint8)
    vc = rng.integers(0, c, (p1, ps, kvh, nc)).astype(np.uint8)
    cb = {"zk": rng.standard_normal((nc, c, v)).astype(np.float32),
          "zv": rng.standard_normal((nc, c, v)).astype(np.float32),
          "sk": (np.abs(rng.standard_normal(kvh)) + 0.5).astype(np.float32),
          "sv": (np.abs(rng.standard_normal(kvh)) + 0.5).astype(np.float32)}
    perm = rng.permutation(p1 - 1)
    phys = np.full((slots, np_), p1 - 1, np.int32)
    for b, pos in enumerate(positions):
        n_alloc = min(-(-(pos + 1) // ps), np_) if pos >= 0 else 0
        phys[b, :n_alloc] = perm[b * np_: b * np_ + n_alloc]
    q = rng.standard_normal((slots, 1, kvh * g, d)).astype(np.float32)
    kn = rng.standard_normal((slots, 1, kvh, d)).astype(np.float32)
    vn = rng.standard_normal((slots, 1, kvh, d)).astype(np.float32)
    return q, kc, vc, cb, kn, vn, phys, np.asarray(positions, np.int32)


@pytest.mark.parametrize("kvh,g,window,kv_start,split", [
    (2, 1, 0, 0, 2),      # split of 2 pages does not divide NP = 5
    (2, 3, 11, 5, 3),     # GQA G = 3, window and kv_start, 3 does not divide
    (1, 4, 0, 5, 1),      # G = 4, kv_start, one page per split
    (2, 2, 11, 0, 5),     # window, one split over all pages
])
def test_kvq_flash_matches_jax_kernel_and_oracle(kvh, g, window, kv_start,
                                                 split):
    q, kc, vc, cb, kn, vn, phys, pos = _kvq_case(kvh * 7 + g + split,
                                                 kvh=kvh, g=g)
    j = [jnp.asarray(a) for a in (q, kc, vc, kn, vn, phys, pos)]
    cb_j = {k: jnp.asarray(a) for k, a in cb.items()}
    out_pl = _np(jfd.flash_decode_paged(
        j[0], j[1], j[2], j[3], j[4], j[5], j[6], window=window,
        kv_start=kv_start, impl="pallas", codebook=cb_j, split_pages=split,
        interpret=True))
    out_jref = _np(j_kvq_ref(j[0], j[1], j[2], cb_j, j[3], j[4], j[5], j[6],
                             window=window, kv_start=kv_start))
    t = [_t(a) for a in (q, kc, vc, kn, vn, phys, pos)]
    cb_t = {k: _t(a) for k, a in cb.items()}
    before = tfd.flash_decode_splits_kvq.calls
    fp_before = tfd.flash_decode_splits.calls
    out = tfd.flash_decode_paged(t[0], t[1], t[2], t[3], t[4], t[5], t[6],
                                 window=window, kv_start=kv_start,
                                 codebook=cb_t, split_pages=split)
    assert tfd.flash_decode_splits_kvq.calls == before + 1   # CPU -> plain
    assert tfd.flash_decode_splits.calls == fp_before
    oracle = flash_decode_kvq_ref(t[0], t[1], t[2], cb_t, t[3], t[4], t[5],
                                  t[6], window=window, kv_start=kv_start)
    np.testing.assert_allclose(oracle.numpy(), out_jref, atol=ATOL)
    live = pos >= 0                  # pos = -1 lanes: output discarded
    for want in (out_pl, out_jref):
        np.testing.assert_allclose(out.numpy()[live], want[live], atol=ATOL)
    assert np.isfinite(out.numpy()).all()


@pytest.mark.parametrize("slots,kvh,g,ps,np_,positions,window,impl", [
    # page 64: the JAX Pallas kernel (interpret mode)
    (3, 2, 2, 64, 4, (200, -1, 255), 0, "pallas"),
    (3, 1, 4, 64, 4, (130, 64, -1), 70, "pallas"),
    # the default split rule at the main path's 8 slots x 20 kv heads x
    # 32 pages (4 splits of 8 pages), against the JAX XLA split form
    (8, 20, 1, 4, 32, (5, 127, 128, -1, 64, 33, 100, 17), 0, "ref"),
])
def test_kvq_flash_default_split_matches_jax(slots, kvh, g, ps, np_,
                                              positions, window, impl):
    """flash_decode_paged over a code pool with its default split
    (``split_pages_for(..., kvq=True)``) against the JAX package's kernel
    and oracle, at page 64 and at the main path's slot and head counts."""
    q, kc, vc, cb, kn, vn, phys, pos = _kvq_case(
        slots * kvh + ps, slots=slots, np_=np_, ps=ps, kvh=kvh, g=g,
        positions=positions)
    j = [jnp.asarray(a) for a in (q, kc, vc, kn, vn, phys, pos)]
    cb_j = {k: jnp.asarray(a) for k, a in cb.items()}
    kw = {"interpret": True, "split_pages": 2} if impl == "pallas" else {}
    out_j = _np(jfd.flash_decode_paged(
        j[0], j[1], j[2], j[3], j[4], j[5], j[6], window=window,
        impl=impl, codebook=cb_j, **kw))
    out_jref = _np(j_kvq_ref(j[0], j[1], j[2], cb_j, j[3], j[4], j[5], j[6],
                             window=window))
    if (slots, kvh, np_) == (8, 20, 32):
        assert tfd.split_pages_for(slots, kvh, np_, kvq=True) == 8
    t = [_t(a) for a in (q, kc, vc, kn, vn, phys, pos)]
    out = tfd.flash_decode_paged(
        t[0], t[1], t[2], t[3], t[4], t[5], t[6], window=window,
        codebook={k: _t(a) for k, a in cb.items()}).numpy()
    assert np.isfinite(out).all()
    live = pos >= 0                  # pos = -1 lanes: output discarded
    for want in (out_j, out_jref):
        np.testing.assert_allclose(out[live], want[live], atol=ATOL)


@pytest.mark.parametrize("kvh,g,window,kv_start,split", [
    (2, 1, 0, 0, 2),      # split of 2 pages does not divide NP = 5
    (2, 3, 11, 5, 3),     # GQA G = 3, window and kv_start
    (1, 4, 6, 2, 1),      # G = 4, window, kv_start, one page per split
])
def test_fold_splits_on_plain_kvq_triples_matches_jax(kvh, g, window,
                                                      kv_start, split):
    """fold_splits over B5's plain triples equals the JAX package's
    flash_decode_paged over the same code pool (Pallas kernel in interpret
    mode, and the dequantize-then-reference oracle), 1e-5 relative; the
    pos = -1 lane returns exactly its v_new row."""
    q, kc, vc, cb, kn, vn, phys, pos = _kvq_case(kvh * 5 + g + split + 40,
                                                 kvh=kvh, g=g)
    j = [jnp.asarray(a) for a in (q, kc, vc, kn, vn, phys, pos)]
    cb_j = {k: jnp.asarray(a) for k, a in cb.items()}
    out_pl = _np(jfd.flash_decode_paged(
        j[0], j[1], j[2], j[3], j[4], j[5], j[6], window=window,
        kv_start=kv_start, impl="pallas", codebook=cb_j, split_pages=split,
        interpret=True))
    out_jref = _np(j_kvq_ref(j[0], j[1], j[2], cb_j, j[3], j[4], j[5], j[6],
                             window=window, kv_start=kv_start))
    b, d = q.shape[0], q.shape[-1]
    qg = _t(q).reshape(b, kvh, g, d) * d ** -0.5
    ph = np.pad(phys, ((0, 0), (0, (-phys.shape[1]) % split)),
                constant_values=kc.shape[0] - 1)
    m, l, acc = tfd.flash_decode_splits_kvq(
        qg, _t(kc), _t(vc), _t(cb["zk"]), _t(cb["zv"]), _t(cb["sk"]),
        _t(cb["sv"]), _t(ph), _t(pos), window,
        torch.full((b,), kv_start, dtype=torch.int32), split)
    out = tfd.fold_splits(m, l, acc, qg, _t(kn), _t(vn), torch.float32)
    assert out.shape == (b, 1, kvh * g * d)
    np.testing.assert_allclose(out.numpy(), out_pl, rtol=1e-5, atol=1e-5)
    live = pos >= 0
    np.testing.assert_allclose(out.numpy()[live], out_jref[live], rtol=1e-5,
                               atol=1e-5)
    dead = int(np.flatnonzero(~live)[0])
    want = _t(vn)[dead, 0, :, None, :].expand(kvh, g, d).reshape(1, -1)
    assert torch.equal(out[dead], want)


def test_kvq_all_masked_split_is_exactly_the_identity():
    """A pos = -1 lane and splits past a slot's length emit (-1e30, 0, 0)
    exactly, the sentinel compared in its own dtype (float32)."""
    q, kc, vc, cb, _, _, phys, pos = _kvq_case(11)
    qg = _t(q).reshape(4, 2, 1, 16) * 16 ** -0.5
    pad = np.pad(phys, ((0, 0), (0, 1)), constant_values=kc.shape[0] - 1)
    m, l, acc = tfd.flash_decode_splits_kvq(
        qg, _t(kc), _t(vc), _t(cb["zk"]), _t(cb["zv"]), _t(cb["sk"]),
        _t(cb["sv"]), _t(pad), _t(pos), 0, torch.zeros(4, dtype=torch.int32),
        2)
    neg = torch.tensor(tfd.NEG_INF, dtype=m.dtype)
    assert m.dtype == torch.float32
    assert bool((m[:, 3] == neg).all() and (l[:, 3] == 0).all()
                and (acc[:, 3] == 0).all())
    # slot 2 holds 9 tokens: splits 1 and 2 (tokens 8.. of 2-page splits)
    # hold a live key only in split 1; split 2 is empty
    assert bool((m[2, 2] == neg).all() and (l[2, 2] == 0).all())


def test_kvq_trash_codes_are_never_attended():
    q, kc, vc, cb, kn, vn, phys, pos = _kvq_case(12)
    args = dict(window=0, kv_start=0, codebook={k: _t(a)
                                                 for k, a in cb.items()})
    base = tfd.flash_decode_paged(_t(q), _t(kc), _t(vc), _t(kn), _t(vn),
                                  _t(phys), _t(pos), **args)
    kc2, vc2 = kc.copy(), vc.copy()
    kc2[-1] = (kc2[-1] + 5) % 16     # other codes on the trash page
    vc2[-1] = (vc2[-1] + 9) % 16
    again = tfd.flash_decode_paged(_t(q), _t(kc2), _t(vc2), _t(kn), _t(vn),
                                   _t(phys), _t(pos), **args)
    live = torch.from_numpy(pos >= 0)
    assert torch.equal(base[live], again[live])


# ---------------------------------------------------------------------------
# model: code pool, calibration rows, chains against JAX
# ---------------------------------------------------------------------------

PS, MAX_SEQ, N_PAGES, CHUNK = 8, 32, 10, 4


@pytest.fixture(scope="module")
def pair():
    jm = JModel(jcfg.smoke_config())
    qc_j = JQC(mode="lut_infer", lut_dtype="int8", flash="pallas",
               kv_quant="vq")
    params_j = precompute_model(
        jm.init(jax.random.PRNGKey(3), JQC(mode="lut_train")), qc_j)
    tm = TModel(tcfg.smoke_config(), device="cpu")
    params_t = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        params_j),
                                 tm.cfg, device="cpu")
    qc_t = TQC(mode="lut_infer", lut_dtype="int8", kv_quant="vq")
    # the JAX engine's own calibration fit, carried over
    probe = JEngine(jm, params_j, qc_j, batch_size=1, max_seq=MAX_SEQ,
                    page_size=PS, prefill_chunk=CHUNK, prefix_cache=False)
    cb_j = probe.kv_codebook
    cb_t = kv_codebook_from_numpy(
        jax.tree_util.tree_map(np.asarray, cb_j.tree()), device="cpu")
    return jm, params_j, qc_j, tm, params_t, qc_t, cb_j, cb_t


def test_calibration_rows_match_jax_prefill_rows(pair):
    """The port takes the calibration rows from one fp paged prefill
    chunk; the JAX engine from its dense-cache prefill of the same ramp."""
    jm, params_j, qc_j, tm, params_t, qc_t, *_ = pair
    k_t, v_t = calibration_rows(tm, params_t, qc_t, MAX_SEQ, PS)
    t = min(128, MAX_SEQ)
    tokens = (jnp.arange(t, dtype=jnp.int32) * 31 + 7) % jm.cfg.vocab_size
    _, cache = jm.prefill(params_j, {"tokens": tokens[None]},
                          jm.init_cache(1, t), qc_j)
    np.testing.assert_allclose(k_t.numpy(),
                               _np(cache["layers"]["k"][:, 0]), atol=1e-4)
    np.testing.assert_allclose(v_t.numpy(),
                               _np(cache["layers"]["v"][:, 0]), atol=1e-4)


def test_init_paged_cache_code_pool_and_validation(pair):
    *_, tm, _, _, _, cb_t = pair
    kv = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES, codebook=cb_t)
    cfg = tm.cfg
    assert kv["k"].dtype == torch.uint8 and tuple(kv["k"].shape) == (
        cfg.num_layers, N_PAGES + 1, PS, cfg.num_kv_heads, cb_t.nc)
    cb_cache = kv[tkv.CODEBOOK_KEY]
    for key, leaf in cb_t.tree().items():          # the cache's own copies
        assert torch.equal(cb_cache[key], leaf)
        assert cb_cache[key].data_ptr() != leaf.data_ptr()
    bad = tkv.KVCodebook.fit(torch.ones((cfg.num_layers, 8, 2, 8)),
                             torch.ones((cfg.num_layers, 8, 2, 8)), v=4,
                             c=4, iters=1)
    with pytest.raises(ValueError, match="does not match"):
        tm.init_paged_cache(MAX_SEQ, PS, N_PAGES, codebook=bad)


def test_quantized_prefill_and_decode_chain_match_jax(pair):
    """Chunked prefill of two slots and a 4-step greedy decode chain over
    a code pool, the same carried-over codebook on both sides (JAX: B5
    Pallas kernel in interpret mode): logits at 1e-4, argmax identical,
    the pools' codes equal; a non-decoding slot's codes stay untouched."""
    jm, params_j, qc_j, tm, params_t, qc_t, cb_j, cb_t = pair
    table = np.full((3, MAX_SEQ // PS), -1, np.int32)
    table[0, :2] = [5, 2]
    table[1, :2] = [0, 7]
    table[2, :1] = [9]
    prompts = [list(range(3, 14)), [40, 41, 42, 43, 44, 45], [7, 8, 9]]
    kv_j = jm.init_paged_cache(3, MAX_SEQ, PS, num_pages=N_PAGES,
                               codebook=cb_j)
    kv_t = tm.init_paged_cache(MAX_SEQ, PS, N_PAGES, codebook=cb_t)
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
    live = np.ones(N_PAGES + 1, bool)
    live[-1] = False                             # trash contents are free
    for key in ("k", "v"):
        np.testing.assert_array_equal(kv_t[key].numpy()[:, live],
                                      _np(kv_j[key])[:, live])
    slot2 = kv_t["k"][:, 9].clone()
    positions = np.array([len(prompts[0]), len(prompts[1]), -1], np.int32)
    toks = np.array([[last[0]], [last[1]], [0]], np.int32)
    for _ in range(4):
        lg_j, kv_j = dec_j(params_j, jnp.asarray(toks), kv_j,
                           jnp.asarray(table), jnp.asarray(positions))
        lg_t = tm.decode_paged(params_t, torch.from_numpy(toks), kv_t,
                               table_t, torch.from_numpy(positions), qc_t)
        lg_j = _np(lg_j)
        np.testing.assert_allclose(lg_t.numpy()[:2], lg_j[:2], atol=1e-4)
        nxt = lg_j.argmax(-1)
        np.testing.assert_array_equal(lg_t.numpy()[:2].argmax(-1), nxt[:2])
        toks = nxt[:, None].astype(np.int32)
        positions[:2] += 1
    assert torch.equal(kv_t["k"][:, 9], slot2)
    for key in ("k", "v"):
        np.testing.assert_array_equal(kv_t[key].numpy()[:, live],
                                      _np(kv_j[key])[:, live])


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

ENGINE_KW = dict(batch_size=2, max_seq=MAX_SEQ, page_size=PS,
                 prefill_chunk=CHUNK)
# (prompt, max_new): 6 pages of demand against a 5-page pool
PLAN = [(list(range(3, 14)), 12), ([40, 41, 42, 43, 44, 45], 12),
        ([7, 8, 9], 6)]
LATE = ([100, 101], 5)               # submitted mid-decode


def _serve(engine, make_req):
    reqs = [make_req(p, n) for p, n in PLAN]
    for r in reqs:
        engine.submit(r)
    for _ in range(5):               # the first requests reach decode
        engine.step()
    late = make_req(*LATE)
    engine.submit(late)
    engine.run_until_idle()
    return reqs + [late]


def test_engine_vq_greedy_tokens_match_jax_engine(pair):
    """Same params and codebook: the port's quantized engine emits the
    JAX engine's greedy tokens, mid-decode admission and preemption
    included."""
    jm, params_j, qc_j, tm, params_t, qc_t, cb_j, cb_t = pair
    j_eng = JEngine(jm, params_j, qc_j, num_pages=5, prefix_cache=False,
                    degradation=None, kv_codebook=cb_j, **ENGINE_KW)
    t_eng = TEngine(tm, params_t, qc_t, num_pages=5, kv_codebook=cb_t,
                    **ENGINE_KW)
    assert t_eng.kv.data["k"].dtype == torch.uint8
    j_reqs = _serve(j_eng, lambda p, n: JRequest(tokens=p, max_new_tokens=n))
    t_reqs = _serve(t_eng, lambda p, n: Request(tokens=p, max_new_tokens=n))
    assert j_eng.scheduler.preemptions >= 1
    assert t_eng.scheduler.preemptions == j_eng.scheduler.preemptions
    for rj, rt in zip(j_reqs, t_reqs):
        assert rt.done and rt.finish_reason.name == rj.finish_reason.name
        assert rt.out_tokens == rj.out_tokens


def test_engine_fits_its_own_codebook_deterministically(pair):
    *_, tm, params_t, qc_t, _, _ = pair
    a = TEngine(tm, params_t, qc_t, **ENGINE_KW)
    b = TEngine(tm, params_t, qc_t.replace(fuse=False), **ENGINE_KW)
    assert a.kv_codebook is not None
    assert (a.kv_codebook.nc, a.kv_codebook.c) == (
        tm.cfg.head_dim // qc_t.kv_v, qc_t.kv_c)
    assert a.kv_codebook.fingerprint() == b.kv_codebook.fingerprint()
    req = Request(tokens=[3, 4, 5], max_new_tokens=4)
    a.run([req])
    assert req.done and len(req.out_tokens) == 4


def test_exact_cover_codebook_gives_the_fp_pool_tokens(pair):
    """Harvest every row an fp run reads, make them the centroids
    (from_rows): the quantized engine then reproduces the fp tokens."""
    *_, tm, params_t, _, _, _ = pair
    qc = TQC(mode="lut_infer", lut_dtype="int8")
    prompt, n_new = [2, 3, 5, 7, 11], 8

    def run(e_qc, cb=None):
        eng = TEngine(tm, params_t, e_qc, batch_size=1, max_seq=MAX_SEQ,
                      page_size=PS, prefill_chunk=CHUNK, kv_codebook=cb)
        req = Request(tokens=list(prompt), max_new_tokens=n_new)
        eng.run([req])
        return req.out_tokens

    fp_out = run(qc)
    kv = tm.init_paged_cache(MAX_SEQ, PS, MAX_SEQ // PS)
    table = torch.arange(MAX_SEQ // PS, dtype=torch.int32)[None]
    p = len(prompt)
    logits = tm.prefill_paged(params_t, torch.tensor([prompt]), kv, table,
                              0, 0, p, qc)
    toks = []
    for step in range(n_new):
        nxt = int(logits.argmax())
        toks.append(nxt)
        logits = tm.decode_paged(params_t, torch.tensor([[nxt]]), kv, table,
                                 torch.tensor([p + step], dtype=torch.int32),
                                 qc)
    assert toks == fp_out
    t_rows = p + n_new - 1                     # every row the run reads
    cfg = tm.cfg
    rows = {key: kv[key][:, :MAX_SEQ // PS].reshape(
        cfg.num_layers, MAX_SEQ, cfg.num_kv_heads, cfg.head_dim)[:, :t_rows]
        for key in ("k", "v")}
    cb = tkv.KVCodebook.from_rows(rows["k"], rows["v"])
    assert run(qc.replace(kv_quant="vq"), cb) == fp_out


def test_bytes_per_token_algebra_and_engine_validation(pair):
    *_, tm, params_t, qc_t, _, cb_t = pair
    cfg = tm.cfg
    fp = TEngine(tm, params_t, qc_t.replace(kv_quant="none"), **ENGINE_KW)
    vq = TEngine(tm, params_t, qc_t, kv_codebook=cb_t, **ENGINE_KW)
    item = torch.tensor([], dtype=tm.dtype).element_size()
    assert fp.kv.bytes_per_token == (2 * cfg.num_layers * cfg.num_kv_heads
                                     * cfg.head_dim * item)
    assert vq.kv.bytes_per_token == 2 * cfg.num_layers * cfg.num_kv_heads \
        * cb_t.bytes_per_token_per_kv_head
    assert fp.kv.bytes_per_token == \
        vq.kv.bytes_per_token * item * qc_t.kv_v
    for eng in (fp, vq):
        assert eng.kv.page_bytes == eng.kv.bytes_per_token * PS
        assert eng.kv.pool_bytes == \
            eng.kv.page_bytes * eng.kv.table.allocator.num_pages
    with pytest.raises(ValueError, match="kv_quant"):
        TEngine(tm, params_t, qc_t.replace(kv_quant="none"),
                kv_codebook=cb_t, **ENGINE_KW)



def test_cuda_code_pool_never_falls_back_to_the_plain_version():
    from repro_torch.kernels import _build
    from test_torch_boundary import _cuda_looking as cuda_looking
    if _build.library_path("flash_decode_kvq").exists():
        pytest.skip("a built kernel library is present")
    q, kc, vc, cb, kn, vn, phys, pos = _kvq_case(13)

    plain = tfd.flash_decode_splits_kvq.calls
    with pytest.raises((RuntimeError, AssertionError)):
        tfd.flash_decode_paged(
            cuda_looking(q), cuda_looking(kc), cuda_looking(vc),
            cuda_looking(kn), cuda_looking(vn), cuda_looking(phys), pos,
            codebook={k: cuda_looking(a) for k, a in cb.items()})
    assert tfd.flash_decode_splits_kvq.calls == plain
    # the kernel's wrapper itself: its argument checks pass, then the
    # build fails without nvcc; a malformed argument fails the checks
    qg = cuda_looking(q.reshape(4, 2, 1, 16))
    pad = np.pad(phys, ((0, 0), (0, 1)), constant_values=kc.shape[0] - 1)
    args = [qg, cuda_looking(kc), cuda_looking(vc)] + [
        cuda_looking(cb[k]) for k in ("zk", "zv", "sk", "sv")] + [
        cuda_looking(pad), cuda_looking(pos), 0,
        cuda_looking(np.zeros(4, np.int32)), 2]
    launches = tfd.flash_decode_splits_kvq_cuda.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        tfd.flash_decode_splits_kvq_cuda(*args)
    bad = list(args)
    bad[3] = cuda_looking(cb["zk"][:, :, :2].copy())      # nc * v != D
    with pytest.raises(ValueError, match="flash_decode_splits_kvq_cuda"):
        tfd.flash_decode_splits_kvq_cuda(*bad)
    assert tfd.flash_decode_splits_kvq_cuda.launches == launches
