"""Port parity: paged flash decode (kernel B2's plain version, the split
reduction and the self-term fold) against the JAX package's Pallas kernel
(interpret mode) and its full-softmax oracle, on the same numpy inputs.

Tolerance: atol 1e-5 (float32; softmax sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import flash_decode as jfd  # noqa: E402
from repro.kernels.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402

ATOL = 1e-5


def _problem(seed, b=3, h=4, kvh=4, d=16, ps=4, n_pages=14, np_=5,
             positions=(7, -1, 19)):
    """Random pool with a poisoned trash page, per-slot page rows (some -1,
    trash-redirected) and per-slot lengths."""
    rng = np.random.default_rng(seed)
    k_pages = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    v_pages = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    k_pages[-1] = 1e4          # trash page: must never be attended
    v_pages[-1] = 1e4
    phys = np.stack([rng.permutation(n_pages)[:np_] for _ in range(b)])
    pos = np.asarray(positions, np.int32)
    for i, p in enumerate(pos):                 # unallocated tail -> trash
        phys[i, max(0, -(-int(p) // ps)):] = n_pages
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k_new = rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
    v_new = rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
    return q, k_pages, v_pages, k_new, v_new, phys.astype(np.int32), pos


@pytest.mark.parametrize("h,kvh,window,kv_start,split", [
    (4, 4, 0, 0, 2),      # G = 1, split of 2 pages does not divide NP = 5
    (8, 2, 5, 3, 3),      # GQA G = 4, sliding window, kv_start > 0
    (8, 4, 6, 2, 1),      # G = 2, window and kv_start, one page per split
])
def test_flash_decode_plain_matches_jax_kernel_and_oracle(h, kvh, window,
                                                          kv_start, split):
    q, kp, vp, kn, vn, phys, pos = _problem(h * 10 + window, h=h, kvh=kvh)
    j = [jnp.asarray(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    out_pl = np.asarray(jfd.flash_decode_paged(
        *j, window=window, kv_start=kv_start, impl="pallas",
        split_pages=split, interpret=True))
    out_ref = np.asarray(flash_decode_ref(*j, window=window,
                                          kv_start=kv_start))
    t = [torch.from_numpy(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    before = tfd.flash_decode_splits.calls
    out_t = tfd.flash_decode_paged(*t, window=window, kv_start=kv_start,
                                   split_pages=split).numpy()
    assert tfd.flash_decode_splits.calls == before + 1   # CPU -> plain
    assert out_t.shape == (3, 1, h * 16)
    assert np.isfinite(out_t).all()
    live = pos >= 0        # pos = -1 lanes: garbage by contract, but finite
    np.testing.assert_allclose(out_t[live], out_pl[live], atol=ATOL)
    np.testing.assert_allclose(out_t[live], out_ref[live], atol=ATOL)
    np.testing.assert_allclose(out_t, out_pl, atol=ATOL)


def test_split_triples_match_jax_and_masked_splits_are_identity():
    q, kp, vp, _, _, phys, pos = _problem(3, positions=(5, -1, 9))
    qg = (q.reshape(3, 4, 1, 16) * 16 ** -0.5).astype(np.float32)
    phys = np.pad(phys, ((0, 0), (0, 1)), constant_values=kp.shape[0] - 1)
    ks = np.zeros(3, np.int32)
    m_j, l_j, a_j = jfd.flash_decode_splits(
        jnp.asarray(qg), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(phys),
        jnp.asarray(pos), jnp.asarray(0), jnp.asarray(ks), 2)
    m_t, l_t, a_t = tfd.flash_decode_splits(
        torch.from_numpy(qg), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(phys), torch.from_numpy(pos), 0,
        torch.from_numpy(ks), 2)
    for got, want in ((m_t, m_j), (l_t, l_j), (a_t, a_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # slot 1 (pos = -1) and every split past a slot's length: exactly the
    # identity, compared in the array's own dtype
    neg = np.float32(tfd.NEG_INF)
    m, l, a = m_t.numpy(), l_t.numpy(), a_t.numpy()
    assert (m[:, 1] == neg).all() and (l[:, 1] == 0).all()
    assert (a[:, 1] == 0).all()
    assert (m[1:, 0] == neg).all() and (l[1:, 0] == 0).all()   # 5 keys
    assert (m[0, 0] > neg).all()


def test_reduce_splits_equals_sequential_combine():
    rng = np.random.default_rng(4)
    m = torch.from_numpy(rng.standard_normal((4, 2, 3)).astype(np.float32))
    m[1, 0] = tfd.NEG_INF                        # an all-masked split
    l = torch.from_numpy(rng.random((4, 2, 3)).astype(np.float32))
    l[1, 0] = 0
    acc = torch.from_numpy(rng.standard_normal((4, 2, 3, 5)).astype(
        np.float32))
    acc[1, 0] = 0
    tri = (m[0], l[0], acc[0])
    for i in (3, 1, 2):                          # any order
        tri = tfd.combine_splits(tri, (m[i], l[i], acc[i]))
    red = tfd.reduce_splits(m, l, acc)
    for got, want in zip(red, tri):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("b,h,kvh,ps,np_,positions,window,kv_start,impl", [
    # page 64: the JAX Pallas kernel (interpret mode), G = 4 and G = 1
    (3, 8, 2, 64, 5, (200, -1, 319), 0, 0, "pallas"),
    (3, 4, 4, 64, 5, (130, 64, -1), 70, 3, "pallas"),
    # the default split rule at the main path's 8 slots x 20 kv heads x
    # 32 pages (8 splits of 4 pages), against the JAX XLA split form
    (8, 20, 20, 4, 32, (5, 127, 128, -1, 64, 33, 100, 17), 0, 0, "ref"),
])
def test_flash_decode_paged_default_split_matches_jax(b, h, kvh, ps, np_,
                                                      positions, window,
                                                      kv_start, impl):
    """flash_decode_paged with its default split (``split_pages_for``)
    against the JAX package's kernel and oracle, at page 64 and at the
    main path's slot and head counts."""
    q, kp, vp, kn, vn, phys, pos = _problem(
        b * h + ps, b=b, h=h, kvh=kvh, ps=ps, n_pages=b * np_, np_=np_,
        positions=positions)
    j = [jnp.asarray(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    kw = {"interpret": True, "split_pages": 2} if impl == "pallas" else {}
    out_j = np.asarray(jfd.flash_decode_paged(
        *j, window=window, kv_start=kv_start, impl=impl, **kw))
    out_ref = np.asarray(flash_decode_ref(*j, window=window,
                                          kv_start=kv_start))
    t = [torch.from_numpy(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    sp = tfd.split_pages_for(b, kvh, np_)
    if (b, kvh, np_) == (8, 20, 32):
        assert sp == 4
    out_t = tfd.flash_decode_paged(*t, window=window,
                                   kv_start=kv_start).numpy()
    assert out_t.shape == (b, 1, h * 16) and np.isfinite(out_t).all()
    live = pos >= 0
    np.testing.assert_allclose(out_t[live], out_j[live], atol=ATOL)
    np.testing.assert_allclose(out_t[live], out_ref[live], atol=ATOL)


# ---------------------------------------------------------------------------
# the split reduction + self-term fold (plain version of the fused form's
# epilogue) and the fused wrappers' refusals
# ---------------------------------------------------------------------------

def _fp_triples(q, kp, vp, phys, pos, window, kv_start, split):
    """qg and kernel B2's plain triples, as flash_decode_paged makes them."""
    b, _, h, d = q.shape
    kvh = kp.shape[2]
    qg = torch.from_numpy(q).reshape(b, kvh, h // kvh, d) * d ** -0.5
    pad = (-phys.shape[1]) % split
    ph = np.pad(phys, ((0, 0), (0, pad)), constant_values=kp.shape[0] - 1)
    ks = torch.full((b,), kv_start, dtype=torch.int32)
    tri = tfd.flash_decode_splits(qg, torch.from_numpy(kp),
                                  torch.from_numpy(vp), torch.from_numpy(ph),
                                  torch.from_numpy(pos), window, ks, split)
    return tri, qg


@pytest.mark.parametrize("h,kvh,window,kv_start,split", [
    (4, 4, 0, 0, 2),      # G = 1, split does not divide NP
    (8, 2, 5, 3, 3),      # GQA G = 4, window, kv_start > 0
    (8, 4, 6, 2, 1),      # G = 2, window, kv_start, one page per split
])
def test_fold_splits_on_plain_triples_matches_jax(h, kvh, window, kv_start,
                                                  split):
    """fold_splits over B2's plain triples equals the JAX package's
    flash_decode_paged (Pallas kernel in interpret mode, and the oracle)
    on the same inputs, pos = -1 lane included (1e-5 relative)."""
    q, kp, vp, kn, vn, phys, pos = _problem(h * 13 + split, h=h, kvh=kvh)
    j = [jnp.asarray(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    out_pl = np.asarray(jfd.flash_decode_paged(
        *j, window=window, kv_start=kv_start, impl="pallas",
        split_pages=split, interpret=True))
    out_ref = np.asarray(flash_decode_ref(*j, window=window,
                                          kv_start=kv_start))
    (m, l, acc), qg = _fp_triples(q, kp, vp, phys, pos, window, kv_start,
                                  split)
    before = tfd.fold_splits.calls
    out = tfd.fold_splits(m, l, acc, qg, torch.from_numpy(kn),
                          torch.from_numpy(vn), torch.float32).numpy()
    assert tfd.fold_splits.calls == before + 1
    assert out.shape == (3, 1, h * 16) and out.dtype == np.float32
    np.testing.assert_allclose(out, out_pl, rtol=1e-5, atol=1e-5)
    live = pos >= 0
    np.testing.assert_allclose(out[live], out_ref[live], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fold_splits_dead_lane_is_exactly_v_new(out_dtype):
    """A pos = -1 lane (every split the identity) returns its v_new row
    exactly, cast to the output dtype; so does flash_decode_paged."""
    q, kp, vp, kn, vn, phys, pos = _problem(21, h=8, kvh=2,
                                            positions=(11, -1, -1))
    (m, l, acc), qg = _fp_triples(q, kp, vp, phys, pos, 4, 1, 2)
    vn_t = torch.from_numpy(vn).to(out_dtype)
    out = tfd.fold_splits(m, l, acc, qg, torch.from_numpy(kn).to(out_dtype),
                          vn_t, out_dtype)
    assert out.dtype == out_dtype
    g = 4                                  # each kv head's row, G times
    want = vn_t[:, 0, :, None, :].expand(3, 2, g, 16).reshape(3, 1, 128)
    for lane in (1, 2):
        assert torch.equal(out[lane], want[lane])
    assert not torch.equal(out[0], want[0])
    t = [torch.from_numpy(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    t[0], t[3], t[4] = t[0].to(out_dtype), t[3].to(out_dtype), vn_t
    full = tfd.flash_decode_paged(*t, window=4, kv_start=1, split_pages=2)
    for lane in (1, 2):
        assert torch.equal(full[lane], want[lane])


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a fused wrapper's
    checks run past the device test on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


# fault -> what the refusal names
_BAD_CALLS = {"cpu": "must be CUDA tensors", "q_dtype": "q must be one of",
              "k_new_shape": r"k_new \(2, 1, 3, 8\)",
              "v_new_dtype": "must be in q's dtype", "g": "G=9",
              "d": "D=264", "splits": "at most MAX_SPLITS = 16"}


def _bad_call(case, kvq):
    """Arguments of a fused wrapper (B=2, KVH=2, G=2, D=8, 3 pages of 4)
    with one fault, as CUDA-looking tensors (real CPU ones for "cpu")."""
    b, kvh, g, d, ps, np_, sp = 2, 2, 2, 8, 4, 3, 2
    if case == "g":
        g = 9
    elif case == "d":
        d = 264
    elif case == "splits":
        np_, sp = 17, 1                 # 17 splits of one page
    nc = d // 2
    q = torch.zeros((b, 1, kvh * g, d))
    kn, vn = torch.zeros((b, 1, kvh, d)), torch.zeros((b, 1, kvh, d))
    if case == "q_dtype":
        q = q.to(torch.float16)
    elif case == "k_new_shape":
        kn = torch.zeros((b, 1, kvh + 1, d))
    elif case == "v_new_dtype":
        vn = vn.to(torch.bfloat16)
    ints = [torch.zeros((b, np_), dtype=torch.int32),
            torch.zeros((b,), dtype=torch.int32),
            torch.zeros((b,), dtype=torch.int32)]
    if kvq:
        pool = [torch.zeros((b * np_ + 1, ps, kvh, nc), dtype=torch.uint8)
                for _ in range(2)]
        pool += [torch.zeros((nc, 16, 2)), torch.zeros((nc, 16, 2)),
                 torch.ones(kvh), torch.ones(kvh)]
    else:
        pool = [torch.zeros((b * np_ + 1, ps, kvh, d)) for _ in range(2)]
    ts = [q, *pool, kn, vn, *ints]
    if case != "cpu":
        ts = [t.as_subclass(_CudaLooking) for t in ts]
    phys, pos, ks = ts[-3:]
    return ts[:-3] + [phys, pos, 0, ks, sp]


@pytest.mark.parametrize("kvq", [False, True], ids=["b2", "b5"])
@pytest.mark.parametrize("case", _BAD_CALLS)
def test_fused_wrappers_raise_value_error(case, kvq):
    """The fused wrappers refuse what their kernel does not take (CPU
    tensors, q not float32 or bfloat16, k_new / v_new of another shape or
    dtype, G > 8, D > 256, more than MAX_SPLITS splits) with a ValueError
    naming the wrapper, and launch nothing."""
    fn = (tfd.flash_decode_paged_kvq_cuda if kvq
          else tfd.flash_decode_paged_cuda)
    launches = fn.launches
    with pytest.raises(ValueError,
                       match=f"^{fn.__name__}: .*{_BAD_CALLS[case]}"):
        fn(*_bad_call(case, kvq))
    assert fn.launches == launches


# b, kv heads, a rank's head_dim slice, page, pages a slot
HD_PLAN_SHAPES = [(b, kvh, d, ps, np_)
                  for b in (1, 3, 8, 16, 200) for kvh in (1, 3, 4, 20, 64)
                  for d in (8, 16, 24, 64, 256) for ps in (16, 64)
                  for np_ in (1, 5, 32, 128, 256)]


@pytest.mark.parametrize("elsize", [2, 4])
def test_hd_plan_puts_every_page_in_one_block(elsize):
    """B2s's ranges (``pages`` a block, ``blocks`` a slot) cover a slot's
    table, every page in exactly one block; the kv-head groups cover the
    kv heads, every head in exactly one group, as evenly as they go."""
    for b, kvh, d, ps, np_ in HD_PLAN_SHAPES:
        plan = tfd.hd_plan(b, kvh, d, ps, np_, elsize)
        owner = [pg // plan.pages for pg in range(np_)]
        assert sorted(set(owner)) == list(range(plan.blocks))
        assert (plan.blocks - 1) * plan.pages < np_ <= plan.blocks * plan.pages
        heads = [h // plan.kv_heads for h in range(kvh)]
        assert sorted(set(heads)) == list(range(plan.groups))
        assert (plan.groups - 1) * plan.kv_heads < kvh


@pytest.mark.parametrize("elsize", [2, 4])
def test_hd_plan_stays_within_one_cluster_and_the_block(elsize):
    """A cluster has at most MAX_SPLITS = 16 CTAs (Hopper's largest) and
    at most one a page; a group's value columns (kv heads x 16-byte
    chunks) fit B2a's threads; one page's slice of a group fits
    HD_SLICE_BYTES unless the group is a single kv head."""
    for b, kvh, d, ps, np_ in HD_PLAN_SHAPES:
        plan = tfd.hd_plan(b, kvh, d, ps, np_, elsize)
        nch = -(-d * elsize // 16)
        assert 1 <= plan.cluster <= min(tfd.MAX_SPLITS, np_)
        assert plan.kv_heads * nch <= tfd.HD_THREADS
        assert (plan.kv_heads == 1
                or plan.kv_heads * ps * nch * 16 <= tfd.HD_SLICE_BYTES)


def test_hd_plan_is_a_function_of_shapes_alone():
    """The plan takes shapes and the element size, never a position (no
    host read of the lanes' lengths), and gives the same launch every
    time: the engines' decode steps stay free of host syncs."""
    import inspect
    assert list(inspect.signature(tfd.hd_plan).parameters) == [
        "b", "kvh", "d", "ps", "np_", "elsize"]
    for shape in HD_PLAN_SHAPES[::17]:
        plans = {tfd.hd_plan(*shape, 2) for _ in range(3)}
        assert len(plans) == 1
        assert all(isinstance(v, int) for v in plans.pop())


@pytest.mark.parametrize("name,shape,b2s,b2a", [
    ("qwen1.5-4b", (8, 20, 16, 16, 32), 256, 128),
    ("gemma3-4b", (8, 4, 32, 16, 128), 256, 128),
    ("one slot of 4096 tokens", (1, 20, 16, 16, 256), 256, 16),
])
def test_hd_plan_fills_the_card_once_at_the_main_slices(name, shape, b2s,
                                                        b2a):
    """At the (1, 8) slices of qwen1.5-4b and gemma3-4b (bf16) one kv-head
    group takes every head, B2a runs 8 clusters of 16 CTAs, 128 blocks in
    one wave over the H100's 132 SMs, and B2s about two blocks an SM."""
    plan = tfd.hd_plan(*shape, 2)
    b = shape[0]
    assert plan.groups == 1
    assert plan.blocks * b * plan.groups == b2s <= 2 * tfd.SMS
    assert plan.cluster * b * plan.groups == b2a <= tfd.SMS


def test_split_pages_for_caps_the_splits_at_one_cluster():
    """At most MAX_SPLITS = 16 splits whatever the shape; the main path's
    8 slots x 20 kv heads x 32 pages still take 8 splits (B2) and 4 (B5),
    and one slot at 4096 tokens (256 pages of 16) takes 16."""
    assert tfd.MAX_SPLITS == 16
    for kvq in (False, True):
        for b in (1, 2, 8, 64):
            for kvh in (1, 4, 20):
                for np_ in (1, 5, 16, 17, 32, 100, 256, 1024):
                    sp = tfd.split_pages_for(b, kvh, np_, kvq)
                    assert 1 <= sp <= np_
                    assert -(-np_ // sp) <= tfd.MAX_SPLITS
    assert -(-32 // tfd.split_pages_for(8, 20, 32)) == 8
    assert -(-32 // tfd.split_pages_for(8, 20, 32, kvq=True)) == 4
    for kvq in (False, True):
        assert -(-256 // tfd.split_pages_for(1, 20, 256, kvq)) == 16


def test_flash_decode_paged_takes_the_plain_pair_on_the_cpu():
    """On CPU tensors flash_decode_paged is the plain pair (triples, then
    fold_splits) through flash_decode_paged_plain, whatever the split
    count: 17 splits of one page are fine there."""
    q, kp, vp, kn, vn, phys, pos = _problem(9, np_=5, n_pages=20,
                                            positions=(17, 3, 20))
    phys = np.concatenate([phys] * 4, axis=1)[:, :17]   # 17 pages a slot
    t = [torch.from_numpy(a) for a in (q, kp, vp, kn, vn, phys, pos)]
    calls = (tfd.flash_decode_paged_plain.calls, tfd.fold_splits.calls)
    out = tfd.flash_decode_paged(*t, split_pages=1)
    assert (tfd.flash_decode_paged_plain.calls,
            tfd.fold_splits.calls) == (calls[0] + 1, calls[1] + 1)
    (m, l, acc), qg = _fp_triples(q, kp, vp, phys, pos, 0, 0, 1)
    assert m.shape[0] == 17
    want = tfd.fold_splits(m, l, acc, qg, t[3], t[4], torch.float32)
    assert torch.equal(out, want)
