"""Kernels B1-B5 on the card against their plain versions, beyond the
main path's shapes: every metric, x type and LUT type on ragged M, N and
nc, split-K over several row tiles (B1, B3, B4, and B4(B3(x)) == B1(x)
bit for bit on int8 LUTs); GQA, sliding window, kv_start, inactive lanes,
float32 and bfloat16 pools, pages of 4 to 64 tokens, D of 36 to 256 with
G up to 8, a split over all of a slot's pages, a split size that does not
divide the page count and the default split rule (B2); the same over
uint8 code pools, D of 64 to 256, exact-cover tables above 48 KB, and
codebooks whose tables only B5's dequantize form takes (B5); pools at a
storage offset that is not 16-byte aligned (B1's LUT, B2, B5); B1 at
shapes that cross its tiling's edges (1 to 300 rows, c of 2 to 256,
subspaces that do not divide into its cluster's ranks); B3 and B4 on
misaligned operands (element loads), B3 with one subspace above 48 KB of
staging; float-LUT B1 and B4 launched twice on one input (bit for bit
equal), B4(B3(x)) == B1(x) bit for bit on float LUTs wherever the two
launches take one geometry, and what a call enqueues (B1, B3, B4: one
kernel); B2 and B5 in their fused form (the split reduction and self-term
fold as a thread-block-cluster epilogue) against the plain triples then
fold_splits, pages 4 to 64, G up to 8, D up to 256, q in float32 and
bfloat16, both B5 forms, its scaled query bit for bit the plain
version's, 16 splits at one slot of 4096 tokens (G=1 D=128, G=8 D=128,
G=2 D=256), and one flash_decode_paged call as one kernel; B1, B3 and B4
at the projection shapes of yi-9b and gemma3-4b (M = 8, 32, 40); one
``Model.verify_paged`` call through the kernels against its plain run;
grouped B1, B3 and B4 (a leading expert axis, one launch for all
experts) against their plain versions at E of 1, 2 and 64, E = 1 bit for
bit the ungrouped launch, one kernel a grouped call, B4(B3(x)) == B1(x)
bit for bit on float LUTs, 18 experts of a dbrx-132b expert shape whose
int8 tables pass 2^31 bytes, the wrappers' refusals of mismatched
experts; the same with live-row counts (rows past an expert's count 0.0
and index 0, live rows the launch without counts bit for bit on int8,
experts with no live row at every cluster size, one kernel a call, the
ungrouped geometry kept, the refusals of bad counts); and one
deepseek-moe-16b smoke decode step with one grouped launch per expert
projection; B2s and B2a (the head_dim layout's decode: partial scores,
then the softmax and a rank's V slice) against their plain versions over
float32 and bfloat16 pools and queries, pages 16 to 64, D/m of 8 to 64,
G up to 8, window, kv_start, a pos = -1 lane (exactly its v_new), live
ranges that start and end inside a page and a cluster CTA's chunk, fewer
live keys than CTAs, NP = 1, one slot of 4096 and of 65536 tokens, 16
slots, three launches bit for bit equal, and pools at an odd storage
offset (D/m 16 and 24).

Needs a CUDA device and ``nvcc``: marked ``cuda``, and skipped when torch
sees no card. On a machine with an H100, from the repository root:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's ``tests/conftest.py`` imports JAX.)

Inputs have a clear argmin margin (each sub-vector is a centroid plus
small noise), so the kernel's indices must equal the plain argmin.
Tolerances: int8 LUTs are exact int32 sums times the same scale
(rtol 1e-6); float LUTs are summed in another (fixed) order than the
plain version's (rtol/atol 1e-4), and two launches on one input give the
same bits; B2's triples differ by fp32 summation order (atol 2e-5
relative to their magnitude), and so does the fused form's float32
output, whose bfloat16 output is that value rounded (half a bfloat16 ulp
more); lanes with pos = -1 are exactly their v_new row; two launches of
the fused form give the same bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import deepseek_moe_16b, gemma3_4b  # noqa: E402
from repro_torch.core.lut import QuantConfig  # noqa: E402
from repro_torch.device import enqueued  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import flash_decode as tfd  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.assign import (  # noqa: E402
    vq_assign_cuda, vq_assign_geometry)
from repro_torch.kernels.fused_amm import (  # noqa: E402
    vq_amm_cuda, vq_amm_geometry)
from repro_torch.kernels.lut_gemm import (  # noqa: E402
    lut_gemm_cuda, lut_gemm_geometry)
from repro_torch.models.model import Model  # noqa: E402

pytestmark = pytest.mark.cuda

# (M, nc, v, c, N): ragged everywhere; the 40-row and 9-row shapes need
# several k splits and several 8-row tiles of B3 and B4; the rest cross
# B1's edges: rows a block sums (1-16, 17-32, 33-64 and above 64, so
# several row groups), subspaces that do not divide into the cluster's
# ranks, c of 2, 16 and 256, and N not a multiple of B1's column tile
# (256 int8, 128 bfloat16, 64 float32 columns) or of 16
B1_SHAPES = [(17, 5, 3, 7, 33), (1, 3, 4, 9, 50), (23, 11, 8, 16, 130),
             (40, 700, 8, 16, 300), (9, 90, 8, 256, 70),
             (8, 320, 8, 16, 6912), (31, 37, 8, 2, 257),
             (32, 101, 8, 16, 1000), (33, 64, 4, 16, 520),
             (64, 45, 8, 256, 300), (65, 29, 3, 16, 130),
             (300, 53, 8, 16, 777)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _b1_inputs(shape, x_dtype, lut_dtype, seed, dev):
    m, nc, v, c, n = shape
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((nc, c, v)).astype(np.float32)
    pick = rng.integers(0, c, (m, nc))
    x = z[np.arange(nc)[None], pick] + 0.01 * rng.standard_normal(
        (m, nc, v)).astype(np.float32)
    lut = rng.standard_normal((nc, c, n)).astype(np.float32)
    scale = None
    if lut_dtype == torch.int8:
        lut = rng.integers(-127, 128, (nc, c, n)).astype(np.int8)
        scale = torch.from_numpy(
            (0.01 + rng.random(n)).astype(np.float32)).to(dev)
    x = torch.from_numpy(x).to(dev, x_dtype)
    z = torch.from_numpy(z).to(dev, x_dtype)
    lut = torch.from_numpy(lut).to(dev, lut_dtype)
    return x, z, lut, scale


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
def test_vq_amm_kernel_matches_plain(dev, metric, x_dtype, lut_dtype):
    for i, shape in enumerate(B1_SHAPES):
        x, z, lut, scale = _b1_inputs(shape, x_dtype, lut_dtype, i, dev)
        before = vq_amm_cuda.launches
        got = vq_amm_cuda(x, z, lut, scale, metric)
        want = tref.vq_amm_ref(x, z, lut, scale, metric)
        torch.cuda.synchronize()
        assert vq_amm_cuda.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == want.shape
        if lut_dtype == torch.int8:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_vq_amm_kernel_ties_take_the_lowest_index(dev):
    """All-zero x and centroids tie everywhere: centroid 0 must win (the
    LUT row j holds j, so the output is the index sum)."""
    m, nc, v, c, n = 5, 7, 4, 16, 8
    x = torch.zeros((m, nc, v), device=dev)
    z = torch.zeros((nc, c, v), device=dev)
    lut = torch.arange(c, dtype=torch.float32, device=dev)[None, :, None]
    lut = lut.expand(nc, c, n).contiguous()
    for metric in ("l2", "l1", "chebyshev"):
        out = vq_amm_cuda(x, z, lut, None, metric)
        assert float(out.abs().max()) == 0.0


def _b2_problem(dev, b, h, kvh, d, ps, np_, positions, kv_dtype, seed):
    rng = np.random.default_rng(seed)
    n_pages = b * np_
    kp = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    kp[-1] = 1e4                        # trash page: never attended
    vp[-1] = 1e4
    phys = rng.permutation(n_pages).reshape(b, np_).astype(np.int32)
    for i, p in enumerate(positions):   # unallocated tail -> trash
        phys[i, max(0, -(-p // ps)):] = n_pages
    qg = (rng.standard_normal((b, kvh, h // kvh, d)) * d ** -0.5).astype(
        np.float32)
    t = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)  # noqa: E731
    return (t(qg), t(kp, kv_dtype), t(vp, kv_dtype), t(phys),
            t(np.asarray(positions, np.int32)))


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,ps,np_,split,window,kv_start", [
    (20, 20, 128, 16, 32, 8, 0, 0),     # the main path's shape
    (16, 4, 128, 16, 10, 3, 0, 0),      # GQA G=4, split does not divide
    (8, 1, 64, 8, 9, 2, 20, 5),         # G=8, window, kv_start
    (6, 3, 256, 4, 7, 7, 0, 3),         # D=256, one split
    (20, 20, 128, 16, 32, None, 0, 0),  # the default split rule
    (20, 20, 128, 32, 16, 4, 0, 0),     # page 32, D=128
    (20, 20, 128, 64, 8, 4, 0, 0),      # page 64, D=128 (66 KB as fp32)
    (8, 4, 256, 32, 6, 2, 0, 0),        # page 32, D=256, G=2 (gemma3)
    (8, 1, 256, 32, 5, 2, 0, 0),        # page 32, D=256, G=8 (paligemma)
    (4, 4, 128, 16, 12, 12, 0, 0),      # one split over all of the pages
    (8, 2, 128, 16, 10, 4, 0, 0),       # 3 splits of 4 over 10 pages
    (16, 4, 128, 16, 12, 3, 37, 21),    # live keys start mid-page
    (4, 2, 36, 16, 5, 2, 0, 0),         # bf16 rows of 72 bytes
])
def test_flash_decode_splits_kernel_matches_plain(dev, kv_dtype, h, kvh, d,
                                                  ps, np_, split, window,
                                                  kv_start):
    b = 4
    cap = np_ * ps
    positions = [cap, -1, ps, min(cap, 3 * ps + 1)]   # full, idle, page edge
    qg, kp, vp, phys, pos = _b2_problem(dev, b, h, kvh, d, ps, np_,
                                        positions, kv_dtype, h + d)
    if split is None:
        split = tfd.split_pages_for(b, kvh, np_)
    pad = (-np_) % split
    phys = torch.nn.functional.pad(phys, (0, pad),
                                   value=kp.shape[0] - 1).contiguous()
    ks = torch.full((b,), kv_start, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_splits_cuda.launches
    got = tfd.flash_decode_splits_cuda(qg, kp, vp, phys, pos, window, ks,
                                       split)
    want = tfd.flash_decode_splits(qg, kp, vp, phys, pos, window, ks, split)
    torch.cuda.synchronize()
    assert tfd.flash_decode_splits_cuda.launches == before + 1
    for a, w in zip(got, want):
        assert a.shape == w.shape
        tol = 2e-5 * (1.0 + float(w.abs().max()))
        torch.testing.assert_close(a, w, rtol=0, atol=tol)
    neg = torch.tensor(tfd.NEG_INF, dtype=torch.float32, device=dev)
    m, l, acc = got
    assert bool((m[:, 1] == neg).all() and (l[:, 1] == 0).all()
                and (acc[:, 1] == 0).all())          # pos = -1: identity


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_vq_amm_kernel_takes_misaligned_luts(dev, lut_dtype):
    """A LUT whose data starts one element past a 16-byte boundary takes
    B1's element loads and gives the plain version's result."""
    for i in (2, 5, 7, 9):
        x, z, lut, scale = _b1_inputs(B1_SHAPES[i], torch.bfloat16,
                                      lut_dtype, i, dev)
        got = vq_amm_cuda(x, z, _misaligned(lut), scale)
        want = tref.vq_amm_ref(x, z, lut, scale)
        torch.cuda.synchronize()
        if lut_dtype == torch.int8:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_lut_gemm_kernel_takes_misaligned_luts(dev, lut_dtype):
    """A LUT whose data starts one element past a 16-byte boundary takes
    B4's element loads and gives the plain version's result."""
    for i in (2, 5, 7, 9):
        m, nc, _, c, _ = B1_SHAPES[i]
        _, _, lut, scale = _b1_inputs(B1_SHAPES[i], torch.bfloat16,
                                      lut_dtype, i, dev)
        idx = torch.randint(0, c, (m, nc), device=dev, dtype=torch.int32)
        got = lut_gemm_cuda(idx, _misaligned(lut), scale)
        want = tref.lut_gemm_onehot(idx, lut, scale)
        torch.cuda.synchronize()
        if lut_dtype == torch.int8:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# B3 and B4: the two-pass path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
def test_vq_assign_kernel_matches_plain_and_b1(dev, metric, x_dtype):
    for i, shape in enumerate(B1_SHAPES):
        x, z, _, _ = _b1_inputs(shape, x_dtype, torch.float32, i, dev)
        before = vq_assign_cuda.launches
        got = vq_assign_cuda(x, z, metric)
        torch.cuda.synchronize()
        assert vq_assign_cuda.launches == before + 1
        assert got.dtype == torch.int32 and got.shape == x.shape[:2]
        assert torch.equal(got, tref.assign_ref(x, z, metric))
        # random x: near-ties, but one distance code with B1
        xr = torch.randn(x.shape, device=dev).to(x_dtype)
        nc, c = z.shape[0], z.shape[1]
        probe = (torch.arange(c, device=dev, dtype=torch.float32)[None, :,
                                                                 None]
                 * torch.eye(nc, device=dev)[:, None, :]).contiguous()
        b1 = torch.round(vq_amm_cuda(xr, z, probe, None, metric))
        assert torch.equal(vq_assign_cuda(xr, z, metric), b1.to(torch.int32))


def test_vq_assign_kernel_ties_take_the_lowest_index(dev):
    for metric in ("l2", "l1", "chebyshev"):
        idx = vq_assign_cuda(torch.zeros((5, 7, 4), device=dev),
                             torch.zeros((7, 16, 4), device=dev), metric)
        assert int(idx.abs().max()) == 0


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [3, 4, 8])
def test_vq_assign_kernel_takes_misaligned_x(dev, x_dtype, v):
    """x whose data starts one element past a 16-byte boundary, and rows
    of 3 or 4 elements (not 16-byte multiples in bfloat16), take B3's
    element loads and give the plain argmin."""
    for i, (m, nc, c) in enumerate([(8, 40, 16), (33, 21, 7), (70, 9, 256)]):
        x, z, _, _ = _b1_inputs((m, nc, v, c, 4), x_dtype, torch.float32, i,
                                dev)
        for metric in ("l2", "l1", "chebyshev"):
            got = vq_assign_cuda(_misaligned(x), z, metric)
            torch.cuda.synchronize()
            assert torch.equal(got, tref.assign_ref(x, z, metric))


def test_vq_assign_kernel_takes_a_subspace_above_48kb(dev):
    """c = 256, v = 220: one subspace's staged centroids take 220 KB, so
    the block opts into the card's 227 KB and takes fewer rows."""
    x, z, _, _ = _b1_inputs((20, 3, 220, 256, 4), torch.float32,
                            torch.float32, 0, dev)
    assert torch.equal(vq_assign_cuda(x, z), tref.assign_ref(x, z))


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_lut_gemm_kernel_matches_plain(dev, lut_dtype):
    for i, shape in enumerate(B1_SHAPES):
        m, nc, _, c, n = shape
        _, _, lut, scale = _b1_inputs(shape, torch.float32, lut_dtype, i,
                                      dev)
        idx = torch.randint(0, c, (m, nc), device=dev, dtype=torch.int32)
        before = lut_gemm_cuda.launches
        got = lut_gemm_cuda(idx, lut, scale)
        want = tref.lut_gemm_onehot(idx, lut, scale)
        torch.cuda.synchronize()
        assert lut_gemm_cuda.launches == before + 1
        assert got.dtype == torch.float32 and got.shape == want.shape
        if lut_dtype == torch.int8:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
def test_two_pass_equals_fused_bitwise_on_int8(dev, metric, x_dtype):
    for i, shape in enumerate(B1_SHAPES):
        x, z, lut, scale = _b1_inputs(shape, x_dtype, torch.int8, i, dev)
        xr = torch.randn(x.shape, device=dev).to(x_dtype)
        for xx in (x, xr):
            two = lut_gemm_cuda(vq_assign_cuda(xx, z, metric), lut, scale)
            assert torch.equal(two, vq_amm_cuda(xx, z, lut, scale, metric))


# ---------------------------------------------------------------------------
# B5: flash decode over a code pool
# ---------------------------------------------------------------------------

def _b5_problem(dev, b, h, kvh, d, ps, np_, positions, nc, c, seed):
    rng = np.random.default_rng(seed)
    n_pages = b * np_
    kc = rng.integers(0, c, (n_pages + 1, ps, kvh, nc)).astype(np.uint8)
    vc = rng.integers(0, c, (n_pages + 1, ps, kvh, nc)).astype(np.uint8)
    tab = [rng.standard_normal((nc, c, d // nc)).astype(np.float32)
           for _ in range(2)]
    tab += [(np.abs(rng.standard_normal(kvh)) + 0.5).astype(np.float32)
            for _ in range(2)]
    phys = rng.permutation(n_pages).reshape(b, np_).astype(np.int32)
    for i, p in enumerate(positions):   # unallocated tail -> trash
        phys[i, max(0, -(-p // ps)):] = n_pages
    qg = (rng.standard_normal((b, kvh, h // kvh, d)) * d ** -0.5).astype(
        np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(qg), t(kc), t(vc), [t(a) for a in tab], t(phys),
            t(np.asarray(positions, np.int32)))


@pytest.mark.parametrize("h,kvh,d,ps,np_,split,window,kv_start,nc,c", [
    (20, 20, 128, 16, 32, 2, 0, 0, 32, 16),    # the main path's shape
    (16, 4, 128, 16, 10, 3, 0, 0, 32, 16),     # GQA G=4, split not dividing
    (8, 1, 64, 8, 9, 2, 20, 5, 16, 16),        # G=8, window, kv_start, D=64
    (6, 3, 256, 4, 7, 7, 0, 3, 64, 16),        # D=256, one split
    (8, 2, 128, 16, 6, 4, 0, 0, 1, 128),       # exact cover: 64 KB tables
    (8, 2, 128, 16, 6, 4, 40, 2, 1, 256),      # 128 KB tables, from L2
    (20, 20, 128, 16, 32, None, 0, 0, 32, 16),  # the default split rule
    (20, 20, 128, 32, 16, 4, 0, 0, 32, 16),    # page 32
    (20, 20, 128, 64, 8, 4, 0, 0, 32, 16),     # page 64
    (8, 4, 256, 32, 6, 2, 0, 0, 64, 16),       # page 32, D=256, G=2
    (8, 1, 256, 32, 5, 2, 0, 0, 64, 16),       # page 32, D=256, G=8
    (4, 4, 128, 16, 12, 12, 0, 0, 32, 16),     # one split over all pages
    (16, 4, 128, 16, 12, 3, 37, 21, 32, 16),   # live keys start mid-page
    (8, 2, 96, 16, 6, 3, 0, 0, 24, 16),        # code rows of 24 bytes
    # nc x c = 32768: the score table does not fit, the dequantize form
    (4, 2, 128, 16, 6, 3, 9, 0, 128, 256),     # G=2, window
    (8, 1, 128, 16, 6, 3, 20, 5, 128, 256),    # G=8, window, kv_start
    (4, 2, 128, 16, 12, 3, 37, 21, 128, 256),  # live keys start mid-page
    (8, 1, 256, 32, 5, 2, 0, 3, 128, 256),     # page 32, D=256, G=8
])
def test_flash_decode_splits_kvq_kernel_matches_plain(
        dev, h, kvh, d, ps, np_, split, window, kv_start, nc, c):
    b = 4
    cap = np_ * ps
    positions = [cap, -1, ps, min(cap, 3 * ps + 1)]   # full, idle, page edge
    qg, kc, vc, tab, phys, pos = _b5_problem(dev, b, h, kvh, d, ps, np_,
                                             positions, nc, c, h + d + c)
    if split is None:
        split = tfd.split_pages_for(b, kvh, np_, kvq=True)
    pad = (-np_) % split
    phys = torch.nn.functional.pad(phys, (0, pad),
                                   value=kc.shape[0] - 1).contiguous()
    ks = torch.full((b,), kv_start, dtype=torch.int32, device=dev)
    before = tfd.flash_decode_splits_kvq_cuda.launches
    got = tfd.flash_decode_splits_kvq_cuda(qg, kc, vc, *tab, phys, pos,
                                           window, ks, split)
    want = tfd.flash_decode_splits_kvq(qg, kc, vc, *tab, phys, pos, window,
                                       ks, split)
    torch.cuda.synchronize()
    assert tfd.flash_decode_splits_kvq_cuda.launches == before + 1
    for a, w in zip(got, want):
        assert a.shape == w.shape
        tol = 2e-5 * (1.0 + float(w.abs().max()))
        torch.testing.assert_close(a, w, rtol=0, atol=tol)
    neg = torch.tensor(tfd.NEG_INF, dtype=torch.float32, device=dev)
    m, l, acc = got
    assert bool((m[:, 1] == neg).all() and (l[:, 1] == 0).all()
                and (acc[:, 1] == 0).all())          # pos = -1: identity
    form = "dequantize" if nc * c > 32 * 256 else "lut"
    assert tfd.kvq_form(h // kvh, d, ps, split, nc, c, d // nc) == form


def _misaligned(t):
    """A contiguous copy of t whose data starts one element past a 16-byte
    boundary, as a view into a larger buffer at an odd offset would."""
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = buf[1:1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 != 0
    return out


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "codes"])
def test_flash_decode_kernels_take_misaligned_pools(dev, pool):
    """Pools whose base is not 16-byte aligned are read without vector
    copies and give the same triples."""
    b, h, kvh, d, ps, np_, split = 4, 16, 4, 128, 16, 8, 4
    positions = [np_ * ps, -1, ps, 3 * ps + 1]
    ks = torch.tensor([0, 0, 5, 0], dtype=torch.int32, device=dev)
    if pool == "codes":
        nc, c = 32, 16
        qg, kc, vc, tab, phys, pos = _b5_problem(dev, b, h, kvh, d, ps, np_,
                                                 positions, nc, c, 3)
        got = tfd.flash_decode_splits_kvq_cuda(
            qg, _misaligned(kc), _misaligned(vc), *tab, phys, pos, 30, ks,
            split)
        want = tfd.flash_decode_splits_kvq(qg, kc, vc, *tab, phys, pos, 30,
                                           ks, split)
    else:
        qg, kp, vp, phys, pos = _b2_problem(dev, b, h, kvh, d, ps, np_,
                                            positions,
                                            getattr(torch, pool), 3)
        got = tfd.flash_decode_splits_cuda(qg, _misaligned(kp),
                                           _misaligned(vp), phys, pos, 30,
                                           ks, split)
        want = tfd.flash_decode_splits(qg, kp, vp, phys, pos, 30, ks, split)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        tol = 2e-5 * (1.0 + float(w.abs().max()))
        torch.testing.assert_close(a, w, rtol=0, atol=tol)


# ---------------------------------------------------------------------------
# float LUTs: fixed-order sums in B1 and B4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
def test_float_lut_sums_are_the_same_on_every_launch(dev, lut_dtype):
    """B1 and B4 launched twice on one input give the same bits at every
    shape: no float atomic decides the order of the sums."""
    for i, shape in enumerate(B1_SHAPES):
        for x_dtype in (torch.float32, torch.bfloat16):
            x, z, lut, _ = _b1_inputs(shape, x_dtype, lut_dtype, i, dev)
            xr = torch.randn(x.shape, device=dev).to(x_dtype)
            scale = 0.5 + torch.rand(lut.shape[2], device=dev)
            for sc in (None, scale):
                first = vq_amm_cuda(xr, z, lut, sc)
                assert torch.equal(first, vq_amm_cuda(xr, z, lut, sc))
                idx = vq_assign_cuda(xr, z)
                two = lut_gemm_cuda(idx, lut, sc)
                assert torch.equal(two, lut_gemm_cuda(idx, lut, sc))
                torch.testing.assert_close(two, first, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_vq_amm_and_lut_gemm_launch_counts(dev, lut_dtype):
    """B1, B3 and B4: one kernel a call, no memset, no copy, for every
    LUT and x type."""
    one = {"kernels": 1, "copies": 0, "memsets": 0, "other": 0}
    for x_dtype in (torch.float32, torch.bfloat16):
        x, z, lut, scale = _b1_inputs(B1_SHAPES[3], x_dtype, lut_dtype, 0,
                                      dev)
        idx = vq_assign_cuda(x, z)
        assert enqueued(lambda: vq_amm_cuda(x, z, lut, scale)) == one
        assert enqueued(lambda: vq_assign_cuda(x, z)) == one
        assert enqueued(lambda: lut_gemm_cuda(idx, lut, scale)) == one


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
def test_two_pass_equals_fused_bitwise_on_float_luts_at_one_geometry(
        dev, lut_dtype):
    """Where B4's launch takes B1's cluster size and row groups, the two
    run one sum in one order, so B4(B3(x)) == B1(x) bit for bit on float
    LUTs too; at least one B1_SHAPES entry must be such a shape."""
    same = 0
    for i, shape in enumerate(B1_SHAPES):
        x, z, lut, _ = _b1_inputs(shape, torch.bfloat16, lut_dtype, i, dev)
        xr = torch.randn(x.shape, device=dev).to(x.dtype)
        idx = vq_assign_cuda(xr, z)
        g1, g4 = vq_amm_geometry(xr, z, lut), lut_gemm_geometry(idx, lut)
        if (g1["cluster"], g1["row_groups"]) != (g4["cluster"],
                                                 g4["row_groups"]):
            continue
        same += 1
        scale = 0.5 + torch.rand(lut.shape[2], device=dev)
        for sc in (None, scale):
            assert torch.equal(lut_gemm_cuda(idx, lut, sc),
                               vq_amm_cuda(xr, z, lut, sc))
    assert same >= 1


# ---------------------------------------------------------------------------
# the fused forms: B2 / B5 with the split reduction and self-term fold as a
# thread-block-cluster epilogue, one kernel a flash_decode_paged call
# ---------------------------------------------------------------------------

# pool -> (nc, c) of a code pool as a function of D: "codes" takes B5's
# LUT form at these shapes or its dequantize form, "codes_deq" (nc x c
# of 256 x D) always the dequantize form
_CODEBOOKS = {"codes": lambda d: (d // 4, 16), "codes_deq": lambda d: (d, 256)}


def _fused_problem(dev, pool, b, h, kvh, d, ps, np_, positions, split,
                   seed):
    """A pool of one layer, the wrapper of its fused kernel and its plain
    triples. Returns (fused(q, kn, vn, phys), plain_triples(qg), wrapper,
    phys (B, NP) unpadded, split)."""
    if pool in _CODEBOOKS:
        nc, c = _CODEBOOKS[pool](d)
        _, kc, vc, tab, phys, pos = _b5_problem(dev, b, h, kvh, d, ps, np_,
                                                positions, nc, c, seed)
        split = split or tfd.split_pages_for(b, kvh, np_, kvq=True)

        def fused(q, kn, vn, ph, ks, window):
            return tfd.flash_decode_paged_kvq_cuda(q, kc, vc, *tab, kn, vn,
                                                   ph, pos, window, ks,
                                                   split)

        def plain(qg, ph, ks, window):
            return tfd.flash_decode_splits_kvq(qg, kc, vc, *tab, ph, pos,
                                               window, ks, split)
        wrapper, trash = tfd.flash_decode_paged_kvq_cuda, kc.shape[0] - 1
    else:
        _, kp, vp, phys, pos = _b2_problem(dev, b, h, kvh, d, ps, np_,
                                           positions, getattr(torch, pool),
                                           seed)
        split = split or tfd.split_pages_for(b, kvh, np_)

        def fused(q, kn, vn, ph, ks, window):
            return tfd.flash_decode_paged_cuda(q, kp, vp, kn, vn, ph, pos,
                                               window, ks, split)

        def plain(qg, ph, ks, window):
            return tfd.flash_decode_splits(qg, kp, vp, ph, pos, window, ks,
                                           split)
        wrapper, trash = tfd.flash_decode_paged_cuda, kp.shape[0] - 1
    padded = torch.nn.functional.pad(phys, (0, (-np_) % split),
                                     value=trash).contiguous()
    return fused, lambda qg, ks, w: plain(qg, padded, ks, w), wrapper, \
        phys, split


def _query(dev, b, h, kvh, d, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=dev).to(dtype)
            for shape in ((b, 1, h, d), (b, 1, kvh, d), (b, 1, kvh, d))]


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "codes",
                                  "codes_deq"])
@pytest.mark.parametrize("h,kvh,d,ps,np_,split,window,kv_start", [
    (20, 20, 128, 16, 32, None, 0, 0),  # the main path's shape
    (16, 4, 128, 16, 10, 3, 0, 0),      # GQA G=4, split does not divide
    (8, 1, 64, 8, 9, 2, 20, 5),         # G=8, window, kv_start
    (6, 3, 256, 4, 7, 7, 0, 3),         # D=256, page 4, one split
    (20, 20, 128, 64, 8, 4, 0, 0),      # page 64
    (8, 1, 256, 32, 5, 2, 0, 0),        # page 32, D=256, G=8
    (4, 2, 96, 16, 6, 1, 37, 21),       # D=96 (3 column groups), a page
                                        # a split
    (4, 2, 36, 16, 5, 2, 0, 0),         # D=36: bf16 rows of 72 bytes
])
def test_fused_kernel_matches_plain_pair(dev, pool, h, kvh, d, ps, np_,
                                         split, window, kv_start):
    """One launch of the fused kernel against the plain triples then
    fold_splits, q, k_new and v_new in float32 and in bfloat16: float32
    output within 2e-5 (1 + max|ref|), bfloat16 within half a bfloat16
    ulp more; the pos = -1 lane exactly its v_new row; two launches
    bitwise equal."""
    b, g = 4, h // kvh
    cap = np_ * ps
    positions = [cap, -1, ps, min(cap, 3 * ps + 1)]   # full, idle, page edge
    ks = torch.full((b,), kv_start, dtype=torch.int32, device=dev)
    fused, plain, wrapper, phys, split = _fused_problem(
        dev, pool, b, h, kvh, d, ps, np_, positions, split, h + d)
    for q_dtype in (torch.float32, torch.bfloat16):
        q, kn, vn = _query(dev, b, h, kvh, d, q_dtype, h * d)
        qg = tfd._scaled_query(q, kvh)
        want = tfd.fold_splits(*plain(qg, ks, window), qg, kn, vn,
                               torch.float32)
        before = wrapper.launches
        got = fused(q, kn, vn, phys, ks, window)
        again = fused(q, kn, vn, phys, ks, window)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2
        assert got.dtype == q_dtype and got.shape == want.shape
        assert torch.equal(got, again)
        tol = 2e-5 * (1.0 + float(want.abs().max()))
        rtol = 0.0 if q_dtype == torch.float32 else 2.0 ** -8
        torch.testing.assert_close(got.float(), want, rtol=rtol, atol=tol)
        dead = vn[1, 0, :, None, :].expand(kvh, g, d).reshape(1, -1)
        assert torch.equal(got[1], dead)                   # pos = -1
    if pool == "codes_deq":
        nc, c = _CODEBOOKS[pool](d)
        assert tfd.kvq_form(g, d, ps, split, nc, c, d // nc,
                            fused=True) == "dequantize"


@pytest.mark.parametrize("pool", ["bfloat16", "codes", "codes_deq"])
def test_fused_kernel_scales_q_as_the_plain_version(dev, pool,
                                                    monkeypatch):
    """The fused kernel's scaled query is, bit for bit, the one the plain
    version forms (float32 q times the float32 D**-0.5): a launch on raw
    bfloat16 q equals, rounded to bfloat16, a launch of the same kernel
    with q_scale 1 on the plain version's float32 scaled query."""
    b, h, kvh, d, ps, np_ = 8, 20, 20, 128, 16, 32
    positions = [511, 300, -1, 17, 128, 255, 64, 400]
    ks = torch.zeros((b,), dtype=torch.int32, device=dev)
    fused, _, _, phys, split = _fused_problem(dev, pool, b, h, kvh, d, ps,
                                              np_, positions, None, 11)
    q, kn, vn = _query(dev, b, h, kvh, d, torch.bfloat16, 12)
    got = fused(q, kn, vn, phys, ks, 0)
    qg = tfd._scaled_query(q, kvh).reshape(b, 1, h, d)
    launch = tfd._launch_fused
    monkeypatch.setattr(tfd, "_launch_fused",
                        lambda *a: launch(*a[:-1], 1.0))   # q_scale 1
    pre = fused(qg, kn.float(), vn.float(), phys, ks, 0)
    torch.cuda.synchronize()
    assert pre.dtype == torch.float32
    assert not torch.equal(got.float(), pre)
    assert torch.equal(got, pre.to(torch.bfloat16))


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "codes"])
def test_fused_kernel_takes_misaligned_pools(dev, pool):
    """A pool whose base is not 16-byte aligned is read without vector
    copies and gives the same output, bit for bit."""
    b, h, kvh, d, ps, np_ = 4, 16, 4, 128, 16, 8
    positions = [np_ * ps, -1, ps, 3 * ps + 1]
    ks = torch.tensor([0, 0, 5, 0], dtype=torch.int32, device=dev)
    q, kn, vn = _query(dev, b, h, kvh, d, torch.float32, 3)
    if pool == "codes":
        nc, c = 32, 16
        _, kc, vc, tab, phys, pos = _b5_problem(dev, b, h, kvh, d, ps, np_,
                                                positions, nc, c, 3)
        got = tfd.flash_decode_paged_kvq_cuda(
            q, _misaligned(kc), _misaligned(vc), *tab, kn, vn, phys, pos, 30,
            ks, 4)
        want = tfd.flash_decode_paged_kvq_cuda(q, kc, vc, *tab, kn, vn, phys,
                                               pos, 30, ks, 4)
    else:
        _, kp, vp, phys, pos = _b2_problem(dev, b, h, kvh, d, ps, np_,
                                           positions, getattr(torch, pool), 3)
        got = tfd.flash_decode_paged_cuda(q, _misaligned(kp), _misaligned(vp),
                                          kn, vn, phys, pos, 30, ks, 4)
        want = tfd.flash_decode_paged_cuda(q, kp, vp, kn, vn, phys, pos, 30,
                                           ks, 4)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,kvh,d", [
    (20, 20, 128),     # qwen1.5-4b: G=1
    (32, 4, 128),      # yi-9b: G=8
    (8, 4, 256),       # gemma3-4b: G=2, D=256
])
@pytest.mark.parametrize("pool", ["bfloat16", "codes"])
def test_fused_kernel_at_sixteen_splits(dev, pool, h, kvh, d):
    """One slot at 4096 tokens: the split rule's cap gives 16 splits of 16
    pages, one cluster of 16 blocks per kv head, against the plain pair;
    at each dense config's group and head size (a cluster the card cannot
    schedule raises)."""
    b, ps, np_ = 1, 16, 256
    ks = torch.zeros((b,), dtype=torch.int32, device=dev)
    fused, plain, _, phys, split = _fused_problem(dev, pool, b, h, kvh, d,
                                                  ps, np_, [4095], None, 16)
    assert -(-np_ // split) == tfd.MAX_SPLITS
    geo = tfd.fused_geometry(torch.empty((b, 1, h, d), device=dev),
                             torch.empty((1, ps, kvh, d), device=dev),
                             torch.empty((b, np_), device=dev), split)
    assert (geo["cluster"], geo["clusters"]) == (16, kvh)
    assert geo["resident"] >= 1 and geo["registers"] > 0
    q, kn, vn = _query(dev, b, h, kvh, d, torch.float32, 16)
    qg = tfd._scaled_query(q, kvh)
    want = tfd.fold_splits(*plain(qg, ks, 0), qg, kn, vn, torch.float32)
    got = fused(q, kn, vn, phys, ks, 0)
    torch.cuda.synchronize()
    tol = 2e-5 * (1.0 + float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0.0, atol=tol)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "codes",
                                  "codes_deq"])
def test_flash_decode_paged_runs_the_kernels_only(dev, pool):
    """One flash_decode_paged call on the card at the main path's shape is
    one kernel: B2 (B5 over codes) in its fused form, no query scale, no
    fold launch, no copy; the plain versions never run."""
    b, h, kvh, d, ps, np_ = 8, 20, 20, 128, 16, 32
    positions = [511, 300, -1, 17, 128, 255, 64, 400]
    dtype = torch.float32 if pool == "float32" else torch.bfloat16
    q, kn, vn = _query(dev, b, h, kvh, d, dtype, 5)
    if pool in _CODEBOOKS:
        nc, c = _CODEBOOKS[pool](d)
        _, kp, vp, tab, phys, pos = _b5_problem(dev, b, h, kvh, d, ps, np_,
                                                positions, nc, c, 5)
        cb = dict(zip(("zk", "zv", "sk", "sv"), tab))
        kernel = tfd.flash_decode_paged_kvq_cuda
    else:
        _, kp, vp, phys, pos = _b2_problem(dev, b, h, kvh, d, ps, np_,
                                           positions, dtype, 5)
        cb = None
        kernel = tfd.flash_decode_paged_cuda

    def call():
        return tfd.flash_decode_paged(q, kp, vp, kn, vn, phys, pos,
                                      codebook=cb)
    plain = (tfd.flash_decode_paged_plain, tfd.flash_decode_paged_kvq_plain,
             tfd.fold_splits, tfd.flash_decode_splits,
             tfd.flash_decode_splits_kvq)
    counts = [f.calls for f in plain]
    launches = kernel.launches
    out = call()
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    assert [f.calls for f in plain] == counts
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert enqueued(call) == {"kernels": 1, "copies": 0, "memsets": 0,
                              "other": 0}


# ---------------------------------------------------------------------------
# the dense configs' projection shapes, and the speculative verify
# ---------------------------------------------------------------------------

# (K, N) of yi-9b's (wq/wo, wk/wv, wg/wu, wd) and gemma3-4b's (wq, wk/wv,
# wo, wg/wu, wd) projections
DENSE_PROJ_SHAPES = [(4096, 4096), (4096, 512), (4096, 11008),
                     (11008, 4096), (2560, 2048), (2560, 1024),
                     (2048, 2560), (2560, 10240), (10240, 2560)]


@pytest.mark.parametrize("k,n", DENSE_PROJ_SHAPES)
def test_projection_kernels_at_the_dense_configs_shapes(dev, k, n):
    """B1, B3 and B4 at decode (M=8), the prefill chunk (M=32) and a
    speculative verify of 8 slots x 5 tokens (M=40), int8 LUTs: B1 and B4
    against the plain sum, B3 against the plain argmin, and B4(B3(x)) ==
    B1(x) bit for bit on margin and random x."""
    nc = k // 8
    for m in (8, 32, 40):
        x, z, lut, scale = _b1_inputs((m, nc, 8, 16, n), torch.bfloat16,
                                      torch.int8, m + k + n, dev)
        idx = vq_assign_cuda(x, z)
        assert torch.equal(idx, tref.assign_ref(x, z))
        want = tref.vq_amm_ref(x, z, lut, scale)
        torch.testing.assert_close(vq_amm_cuda(x, z, lut, scale), want,
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(lut_gemm_cuda(idx, lut, scale), want,
                                   rtol=1e-6, atol=1e-6)
        xr = torch.randn(x.shape, device=dev).to(x.dtype)
        for xx in (x, xr):
            assert torch.equal(
                lut_gemm_cuda(vq_assign_cuda(xx, z), lut, scale),
                vq_amm_cuda(xx, z, lut, scale))


def test_verify_paged_through_the_kernels_matches_its_plain_run(
        dev, monkeypatch):
    """One Model.verify_paged call (gemma3-4b smoke: G=2, window 8, int8
    LUTs) on a prefilled pool, with a pos = -1 lane and dead columns: B1
    launches for every projection and its logits and written rows equal
    the same call through the plain versions (exact int8 sums; attention
    is plain torch on both sides)."""
    model = Model(gemma3_4b.smoke_config(), device=dev)
    qc = QuantConfig(mode="lut_infer", lut_dtype="int8")
    params = model.init(torch.Generator(device=dev).manual_seed(0), qc)
    ps, npg = 8, 4
    kv = model.init_paged_cache(ps * npg, ps, 3 * npg)
    table = torch.arange(3 * npg, dtype=torch.int32,
                         device=dev).reshape(3, npg)
    gen = torch.Generator(device=dev).manual_seed(1)
    vocab = model.cfg.vocab_size
    for slot, n in enumerate((13, 9, 3)):
        toks = torch.randint(0, vocab, (1, 16), generator=gen, device=dev,
                             dtype=torch.int32)
        model.prefill_paged(params, toks, kv, table, slot, 0, n, qc)
    toks = torch.randint(0, vocab, (3, 5), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.tensor([13, 9, -1], dtype=torch.int32, device=dev)
    n_live = torch.tensor([5, 2, 0], dtype=torch.int32, device=dev)
    kv_p = {key: t.clone() for key, t in kv.items()}
    launches, plain = vq_amm_cuda.launches, tref.vq_amm_ref.calls
    got = model.verify_paged(params, toks, kv, table, pos, n_live, qc)
    torch.cuda.synchronize()
    assert vq_amm_cuda.launches == launches + 7 * model.cfg.num_layers
    assert tref.vq_amm_ref.calls == plain
    monkeypatch.setattr(ops, "vq_amm_cuda", tref.vq_amm_ref)
    want = model.verify_paged(params, toks, kv_p, table, pos, n_live, qc)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[1, :2], want[1, :2], rtol=1e-5,
                               atol=1e-5)
    for key in ("k", "v"):
        torch.testing.assert_close(kv[key][:, :-1], kv_p[key][:, :-1],
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# grouped launches: a leading expert axis on every operand (MoE experts)
# ---------------------------------------------------------------------------

# (M, nc, v, c, N) of one expert: ragged N, rows past one row group, v of
# 3 (element loads), c of 9 and 256
GROUPED_SHAPES = [(8, 32, 8, 16, 200), (23, 11, 8, 16, 130),
                  (1, 3, 4, 9, 50), (65, 29, 3, 16, 130),
                  (9, 12, 8, 256, 70)]


def _grouped_inputs(e, shape, x_dtype, lut_dtype, seed, dev):
    """E experts' operands of one shape, each from _b1_inputs, stacked:
    x (E, M, nc, v), z (E, nc, c, v), lut (E, nc, c, N), scale (E, N) or
    None."""
    parts = [_b1_inputs(shape, x_dtype, lut_dtype, seed + i, dev)
             for i in range(e)]
    x, z, lut = (torch.stack([p[j] for p in parts]) for j in range(3))
    scale = None if parts[0][3] is None else torch.stack(
        [p[3] for p in parts])
    return x, z, lut, scale


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
def test_grouped_kernels_match_plain(dev, metric, lut_dtype):
    """B1, B3 and B4 with E of 1, 2 and 64 experts in one launch against
    their plain versions (a loop over the experts), x in float32 and
    bfloat16: indices exact, int8 sums exact, float sums to 1e-4. Each
    call counts one launch, and one grouped launch."""
    for e in (1, 2, 64):
        for i, shape in enumerate(GROUPED_SHAPES):
            for x_dtype in (torch.float32, torch.bfloat16):
                x, z, lut, scale = _grouped_inputs(e, shape, x_dtype,
                                                   lut_dtype, 10 * i, dev)
                wrappers = (vq_amm_cuda, vq_assign_cuda, lut_gemm_cuda)
                launches = [(w.launches, w.grouped) for w in wrappers]
                out = vq_amm_cuda(x, z, lut, scale, metric)
                idx = vq_assign_cuda(x, z, metric)
                two = lut_gemm_cuda(idx, lut, scale)
                assert [(w.launches, w.grouped) for w in wrappers] == [
                    (n + 1, g + 1) for n, g in launches]
                assert out.shape == (e, shape[0], shape[4])
                assert torch.equal(idx, tref.assign_ref(x, z, metric))
                want = tref.vq_amm_ref(x, z, lut, scale, metric)
                tol = 1e-6 if lut_dtype == torch.int8 else 1e-4
                torch.testing.assert_close(out, want, rtol=tol, atol=tol)
                torch.testing.assert_close(two, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_grouped_launch_of_one_expert_is_the_ungrouped_one(dev, lut_dtype):
    """E = 1: the grouped launch gives the 3-d call's bits, and takes its
    geometry; E = 64: each expert's slice of the output is the 3-d call on
    that expert's operands, bit for bit, where the two launches take one
    cluster size."""
    for i, shape in enumerate(GROUPED_SHAPES):
        x, z, lut, scale = _grouped_inputs(1, shape, torch.bfloat16,
                                           lut_dtype, i, dev)
        xr = torch.randn(x.shape, device=dev).to(x.dtype)
        s0 = None if scale is None else scale[0]
        assert torch.equal(vq_amm_cuda(xr, z, lut, scale)[0],
                           vq_amm_cuda(xr[0], z[0], lut[0], s0))
        idx = vq_assign_cuda(xr, z)
        assert torch.equal(idx[0], vq_assign_cuda(xr[0], z[0]))
        assert torch.equal(lut_gemm_cuda(idx, lut, scale)[0],
                           lut_gemm_cuda(idx[0], lut[0], s0))
        g = vq_amm_geometry(xr, z, lut)
        assert g.pop("experts") == 1
        assert g == {k: v for k, v in vq_amm_geometry(
            xr[0], z[0], lut[0]).items() if k != "experts"}
    x, z, lut, scale = _grouped_inputs(64, GROUPED_SHAPES[0], torch.bfloat16,
                                       lut_dtype, 3, dev)
    out = vq_amm_cuda(x, z, lut, scale)
    g64 = vq_amm_geometry(x, z, lut)
    for i in range(64):
        s = None if scale is None else scale[i]
        if lut_dtype == torch.int8 or vq_amm_geometry(
                x[i], z[i], lut[i])["cluster"] == g64["cluster"]:
            assert torch.equal(out[i], vq_amm_cuda(x[i], z[i], lut[i], s))


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_grouped_calls_are_one_kernel(dev, lut_dtype):
    """A grouped call of B1, B3 or B4 at deepseek-moe-16b's routed shape
    (64 experts, 8 rows, 2048 -> 1408) enqueues one kernel and nothing
    else, and two launches give the same bits."""
    one = {"kernels": 1, "copies": 0, "memsets": 0, "other": 0}
    x, z, lut, scale = _grouped_inputs(64, (8, 256, 8, 16, 1408),
                                       torch.bfloat16, lut_dtype, 0, dev)
    xr = torch.randn(x.shape, device=dev).to(x.dtype)
    idx = vq_assign_cuda(xr, z)
    assert enqueued(lambda: vq_amm_cuda(xr, z, lut, scale)) == one
    assert enqueued(lambda: vq_assign_cuda(xr, z)) == one
    assert enqueued(lambda: lut_gemm_cuda(idx, lut, scale)) == one
    assert torch.equal(vq_amm_cuda(xr, z, lut, scale),
                       vq_amm_cuda(xr, z, lut, scale))
    assert torch.equal(lut_gemm_cuda(idx, lut, scale),
                       lut_gemm_cuda(idx, lut, scale))


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16])
def test_grouped_two_pass_equals_fused_bitwise_on_float_luts(dev, lut_dtype):
    """B4(B3(x)) == B1(x) bit for bit on float LUTs with an expert axis,
    wherever the two grouped launches take one cluster size and row
    groups; at least one shape must."""
    same = 0
    for e in (2, 64):
        for i, shape in enumerate(GROUPED_SHAPES):
            x, z, lut, _ = _grouped_inputs(e, shape, torch.bfloat16,
                                           lut_dtype, i, dev)
            xr = torch.randn(x.shape, device=dev).to(x.dtype)
            idx = vq_assign_cuda(xr, z)
            g1, g4 = vq_amm_geometry(xr, z, lut), lut_gemm_geometry(idx, lut)
            if (g1["cluster"], g1["row_groups"]) != (g4["cluster"],
                                                     g4["row_groups"]):
                continue
            same += 1
            assert torch.equal(lut_gemm_cuda(idx, lut, None),
                               vq_amm_cuda(xr, z, lut, None))
    assert same >= 1


def test_grouped_kernels_beyond_2gb_of_expert_tables(dev):
    """Expert tables past 2^31 elements: 18 experts of dbrx-132b's
    6144 -> 10752 at 8 rows (a dbrx layer's 16 hold 2.11e9 bytes, just
    below 2^31 = 2.147e9), an int8 table of 2.38e9 bytes whose last
    expert starts at 2.25e9: its outputs, and those of experts below the
    line, must equal the plain version's (64-bit expert offsets)."""
    e, m, nc, c, n = 18, 8, 768, 16, 10752
    gen = torch.Generator(device=dev).manual_seed(0)
    z = (0.02 * torch.randn((e, nc, c, 8), generator=gen, device=dev)).to(
        torch.bfloat16)
    pick = torch.randint(0, c, (e, m, nc), generator=gen, device=dev)
    x = z.float()[torch.arange(e, device=dev)[:, None, None],
                  torch.arange(nc, device=dev)[None, None], pick]
    x = (x + 0.002 * torch.randn(x.shape, generator=gen, device=dev)).to(
        torch.bfloat16)
    lut = torch.randint(-127, 128, (e, nc, c, n), generator=gen, device=dev,
                        dtype=torch.int8)
    scale = 1e-3 + 1e-2 * torch.rand((e, n), generator=gen, device=dev)
    assert (e - 1) * nc * c * n > 2 ** 31
    out = vq_amm_cuda(x, z, lut, scale)
    idx = vq_assign_cuda(x, z)
    two = lut_gemm_cuda(idx, lut, scale)
    for i in (0, 8, 15, 16, 17):         # 17 starts past 2^31 elements
        assert torch.equal(idx[i], tref.assign_ref(x[i], z[i]))
        want = tref.vq_amm_ref(x[i], z[i], lut[i], scale[i])
        torch.testing.assert_close(out[i], want, rtol=1e-6, atol=1e-6)
        assert torch.equal(two[i], out[i])


def test_grouped_wrappers_refuse_mismatched_experts(dev):
    """Mismatched expert counts, a missing expert axis on one operand and
    a non-contiguous expert slice: ValueError, and no launch."""
    x, z, lut, scale = _grouped_inputs(4, GROUPED_SHAPES[0], torch.bfloat16,
                                       torch.int8, 0, dev)
    idx = vq_assign_cuda(x, z)
    launches = (vq_amm_cuda.launches, vq_assign_cuda.launches,
                lut_gemm_cuda.launches)
    bad_b1 = [(x[:3], z, lut, scale), (x, z, lut[:3], scale),
              (x, z, lut, scale[:3]), (x, z[0], lut, scale),
              (x, z, lut, scale[0]), (x[::2], z[::2], lut[::2], scale[::2]),
              (x, z, lut[:, ::2], scale)]
    for args in bad_b1:
        with pytest.raises(ValueError):
            vq_amm_cuda(*args)
    for args in [(x[:3], z), (x, z[0]), (x[::2], z[::2])]:
        with pytest.raises(ValueError):
            vq_assign_cuda(*args)
    for args in [(idx[:3], lut, scale), (idx, lut[0], scale[0]),
                 (idx[::2], lut[::2], scale[::2])]:
        with pytest.raises(ValueError):
            lut_gemm_cuda(*args)
    assert (vq_amm_cuda.launches, vq_assign_cuda.launches,
            lut_gemm_cuda.launches) == launches


def _counts_for(m, dev):
    """Live-row counts of five experts: none, part, all, past the
    capacity (clamped by the kernels), one row."""
    return torch.tensor([0, max(1, m // 2), m, m + 3, 1], dtype=torch.int64,
                        device=dev)


def _live(counts, m):
    return torch.arange(m, device=counts.device)[None] < counts[:, None]


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
@pytest.mark.parametrize("metric", ["l2", "l1", "chebyshev"])
def test_grouped_kernels_with_counts_match_plain(dev, metric, lut_dtype):
    """B1, B3 and B4 with live-row counts against their plain versions
    with the same counts (indices exact, int8 sums exact, float sums to
    1e-4), dead rows 0.0 and index 0; on int8 LUTs the live rows equal
    the launch without counts bit for bit and B4(B3(x)) == B1(x); one
    launch a call, counted as grouped."""
    for i, shape in enumerate(GROUPED_SHAPES):
        m = shape[0]
        for x_dtype in (torch.float32, torch.bfloat16):
            x, z, lut, scale = _grouped_inputs(5, shape, x_dtype, lut_dtype,
                                               40 + i, dev)
            counts = _counts_for(m, dev)
            live = _live(counts, m)
            kw = dict(counts=counts, most_live=int(counts.sum()))
            wrappers = (vq_amm_cuda, vq_assign_cuda, lut_gemm_cuda)
            launches = [(w.launches, w.grouped) for w in wrappers]
            out = vq_amm_cuda(x, z, lut, scale, metric, **kw)
            idx = vq_assign_cuda(x, z, metric, **kw)
            two = lut_gemm_cuda(idx, lut, scale, **kw)
            assert [(w.launches, w.grouped) for w in wrappers] == [
                (n + 1, g + 1) for n, g in launches]
            assert torch.equal(idx, tref.assign_ref(x, z, metric, **kw))
            want = tref.vq_amm_ref(x, z, lut, scale, metric, **kw)
            tol = 1e-6 if lut_dtype == torch.int8 else 1e-4
            torch.testing.assert_close(out, want, rtol=tol, atol=tol)
            torch.testing.assert_close(two, want, rtol=tol, atol=tol)
            assert torch.equal(out[~live], torch.zeros_like(out[~live]))
            assert torch.equal(two[~live], torch.zeros_like(two[~live]))
            assert torch.equal(idx[~live], torch.zeros_like(idx[~live]))
            assert torch.equal(idx[live], vq_assign_cuda(x, z, metric)[live])
            if lut_dtype == torch.int8:
                assert torch.equal(out[live],
                                   vq_amm_cuda(x, z, lut, scale,
                                               metric)[live])
                assert torch.equal(two, out)


def test_grouped_dead_clusters_return(dev):
    """Experts with no live row at every cluster size: their clusters
    write zeros and return before any cluster barrier, so a launch where
    every count is 0, and one where live and dead experts share the
    grid, both finish (no hang) with the right rows."""
    x, z, lut, scale = _grouped_inputs(5, (8, 256, 8, 16, 1408),
                                       torch.bfloat16, torch.int8, 7, dev)
    want = vq_amm_cuda(x, z, lut, scale)
    layouts = [dict(cluster=cl) for cl in (1, 2, 4, 8, 16)] + [
        dict(tile_cluster=tc) for tc in (1, 2, 3, 6, 8)]
    for lay in layouts:
        dead = torch.zeros(5, dtype=torch.int64, device=dev)
        out = vq_amm_cuda(x, z, lut, scale, counts=dead, most_live=40,
                          **lay)
        torch.cuda.synchronize()
        assert not out.any()
        counts = _counts_for(8, dev)
        out = vq_amm_cuda(x, z, lut, scale, counts=counts, most_live=40,
                          **lay)
        torch.cuda.synchronize()
        live = _live(counts, 8)
        assert torch.equal(out[live], want[live]) and not out[~live].any()
    idx = lut_gemm_cuda(vq_assign_cuda(x, z), lut, scale,
                        counts=torch.zeros(5, dtype=torch.int64, device=dev))
    torch.cuda.synchronize()
    assert not idx.any()


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_grouped_two_pass_equals_fused_with_counts(dev, lut_dtype):
    """B4(B3(x)) == B1(x) bit for bit with live-row counts: always on
    int8 LUTs; on float LUTs wherever the two launches take one cluster
    size (then they sum in one order: the partitions follow the live
    rows alike), at least once."""
    same = 0
    for e in (5, 64):
        for i, shape in enumerate(GROUPED_SHAPES):
            m = shape[0]
            x, z, lut, scale = _grouped_inputs(e, shape, torch.bfloat16,
                                               lut_dtype, 60 + i, dev)
            xr = torch.randn(x.shape, device=dev).to(x.dtype)
            counts = torch.randint(0, m + 2, (e,), device=dev)
            kw = dict(counts=counts, most_live=e * m)
            idx = vq_assign_cuda(xr, z, **kw)
            g1 = vq_amm_geometry(xr, z, lut, **kw)
            g4 = lut_gemm_geometry(idx, lut, **kw)
            if lut_dtype != torch.int8 and g1["cluster"] != g4["cluster"]:
                continue
            same += 1
            assert torch.equal(lut_gemm_cuda(idx, lut, scale, **kw),
                               vq_amm_cuda(xr, z, lut, scale, **kw))
    assert same >= 1


@pytest.mark.parametrize("lut_dtype", [torch.float32, torch.bfloat16,
                                       torch.int8])
def test_grouped_calls_with_counts_are_one_kernel(dev, lut_dtype):
    """At deepseek-moe-16b's routed decode buffer (64 experts, 8 rows,
    2048 -> 1408, 48 live rows): a call of B1, B3 or B4 with counts
    enqueues one kernel and nothing else, two launches give the same
    bits, and every layout (k splits, tile clusters) gives B1 the same
    bits on int8; the planner takes tile clusters there."""
    one = {"kernels": 1, "copies": 0, "memsets": 0, "other": 0}
    x, z, lut, scale = _grouped_inputs(64, (8, 256, 8, 16, 1408),
                                       torch.bfloat16, lut_dtype, 0, dev)
    counts = torch.zeros(64, dtype=torch.int64, device=dev)
    counts[torch.randperm(64, device=dev)[:35]] = 1
    counts[:13] += 1                      # 48 live rows on 35-48 experts
    kw = dict(counts=counts, most_live=48)
    idx = vq_assign_cuda(x, z, **kw)
    assert enqueued(lambda: vq_amm_cuda(x, z, lut, scale, **kw)) == one
    assert enqueued(lambda: vq_assign_cuda(x, z, **kw)) == one
    assert enqueued(lambda: lut_gemm_cuda(idx, lut, scale, **kw)) == one
    out = vq_amm_cuda(x, z, lut, scale, **kw)
    assert vq_amm_geometry(x, z, lut, **kw)["tile_cluster"] > 0
    assert torch.equal(out, vq_amm_cuda(x, z, lut, scale, **kw))
    assert torch.equal(lut_gemm_cuda(idx, lut, scale, **kw),
                       lut_gemm_cuda(idx, lut, scale, **kw))
    if lut_dtype == torch.int8:
        for lay in ([dict(cluster=cl) for cl in (1, 2, 4, 8, 16)]
                    + [dict(tile_cluster=tc) for tc in range(1, 9)]):
            assert torch.equal(vq_amm_cuda(x, z, lut, scale, **lay, **kw),
                               out)


def test_ungrouped_launches_keep_their_geometry(dev):
    """Calls without counts launch as before live-row counts existed:
    B1's and B4's planned geometry at qwen1.5-4b's decode shape (2560 ->
    6912, M=8) and B3's rule (8 subspaces x 8 rows a block), whatever
    grouped calls with counts the process has planned."""
    x, z, lut, scale = _b1_inputs((8, 320, 8, 16, 6912), torch.bfloat16,
                                  torch.int8, 0, dev)
    xg, zg, lutg, _ = _grouped_inputs(3, (8, 320, 8, 16, 6912),
                                      torch.bfloat16, torch.int8, 0, dev)
    vq_amm_cuda(xg, zg, lutg, None,
                counts=torch.ones(3, dtype=torch.int64, device=dev))
    assert vq_amm_geometry(x, z, lut) == {
        "experts": 1, "cluster": 8, "tiles": 27, "row_groups": 1,
        "subspaces": 40, "smem": 40768, "tile_cluster": 0}
    assert vq_assign_geometry(x, z) == {
        "experts": 1, "k_blocks": 40, "row_groups": 1, "subspaces": 8,
        "rows": 8, "smem": 6272}
    idx = vq_assign_cuda(x, z)
    g4 = lut_gemm_geometry(idx, lut)
    assert (g4["tiles"], g4["row_groups"]) == (27, 1)
    assert torch.equal(lut_gemm_cuda(idx, lut, scale),
                       vq_amm_cuda(x, z, lut, scale))


def test_wrappers_refuse_bad_counts(dev):
    """counts of the wrong type, shape or device, and most_live without
    counts: ValueError, and no launch."""
    x, z, lut, scale = _grouped_inputs(4, GROUPED_SHAPES[0], torch.bfloat16,
                                       torch.int8, 0, dev)
    idx = vq_assign_cuda(x, z)
    good = torch.ones(4, dtype=torch.int64, device=dev)
    launches = (vq_amm_cuda.launches, vq_assign_cuda.launches,
                lut_gemm_cuda.launches)
    for kw in (dict(counts=good.int()), dict(counts=good[:3]),
               dict(counts=good.cpu()), dict(counts=good[::2]),
               dict(most_live=8), dict(counts=good, most_live=-1)):
        with pytest.raises(ValueError):
            vq_amm_cuda(x, z, lut, scale, **kw)
        with pytest.raises(ValueError):
            vq_assign_cuda(x, z, **kw)
        with pytest.raises(ValueError):
            lut_gemm_cuda(idx, lut, scale, **kw)
    for lay in (dict(cluster=17), dict(tile_cluster=2),
                dict(counts=good, tile_cluster=9),
                dict(counts=good, cluster=2, tile_cluster=2)):
        with pytest.raises(ValueError):
            vq_amm_cuda(x, z, lut, scale, **lay)
    assert (vq_amm_cuda.launches, vq_assign_cuda.launches,
            lut_gemm_cuda.launches) == launches


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "two-pass"])
def test_moe_decode_runs_one_grouped_launch_per_expert_projection(dev,
                                                                  fuse):
    """deepseek-moe-16b smoke on the card (int8 LUTs): one decode_paged
    step launches B1 (or B3 and B4) once for each of a layer's 4
    attention, 3 routed and 3 shared-expert projections (the 6 expert ones
    grouped), and never a plain version; its logits equal the same step through the plain versions
    (exact int8 sums; routing and attention are the same torch ops)."""
    model = Model(deepseek_moe_16b.smoke_config(), device=dev)
    qc = QuantConfig(mode="lut_infer", lut_dtype="int8", fuse=fuse)
    params = model.init(torch.Generator(device=dev).manual_seed(0), qc)
    ps, npg = 8, 4
    kv = model.init_paged_cache(ps * npg, ps, 3 * npg)
    table = torch.arange(3 * npg, dtype=torch.int32,
                         device=dev).reshape(3, npg)
    gen = torch.Generator(device=dev).manual_seed(1)
    vocab = model.cfg.vocab_size
    for slot, n in enumerate((13, 9, 3)):
        toks = torch.randint(0, vocab, (1, 16), generator=gen, device=dev,
                             dtype=torch.int32)
        model.prefill_paged(params, toks, kv, table, slot, 0, n, qc)
    toks = torch.randint(0, vocab, (3, 1), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.tensor([13, 9, 3], dtype=torch.int32, device=dev)
    kv_p = {key: t.clone() for key, t in kv.items()}
    wrappers = (vq_amm_cuda, vq_assign_cuda, lut_gemm_cuda)
    plain = (tref.vq_amm_ref, tref.assign_ref, tref.lut_gemm_onehot)
    launches = [w.launches for w in wrappers]
    grouped = [w.grouped for w in wrappers]
    calls = [p.calls for p in plain]
    got = model.decode_paged(params, toks, kv, table, pos, qc)
    torch.cuda.synchronize()
    per_step = 10 * model.cfg.num_layers
    want_launches = ([per_step, 0, 0] if fuse else [0, per_step, per_step])
    assert [w.launches - n for w, n in zip(wrappers, launches)] == \
        want_launches
    assert [w.grouped - n for w, n in zip(wrappers, grouped)] == [
        n * 6 // 10 for n in want_launches]
    assert [p.calls for p in plain] == calls
    for w, p in zip(("vq_amm_cuda", "vq_assign_cuda", "lut_gemm_cuda"),
                    plain):
        setattr(ops, w, p)
    try:
        want = model.decode_paged(params, toks, kv_p, table, pos, qc)
    finally:
        for w, k in zip(("vq_amm_cuda", "vq_assign_cuda", "lut_gemm_cuda"),
                        wrappers):
            setattr(ops, w, k)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the head_dim layout's decode: B2s (partial scores), B2a (attend)
# ---------------------------------------------------------------------------

def _hd_problem(dev, b, h, kvh, d, ps, np_, positions, kv_dtype, q_dtype,
                seed):
    rng = np.random.default_rng(seed)
    n_pages = b * np_
    kp = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    vp = rng.standard_normal((n_pages + 1, ps, kvh, d)).astype(np.float32)
    kp[-1] = 1e4                        # trash page: never attended
    vp[-1] = 1e4
    phys = rng.permutation(n_pages).reshape(b, np_).astype(np.int32)
    for i, p in enumerate(positions):   # unallocated tail -> trash
        phys[i, max(0, -(-p // ps)):] = n_pages
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    kn = rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
    vn = rng.standard_normal((b, 1, kvh, d)).astype(np.float32)
    t = lambda a, dt=None: torch.from_numpy(a).to(dev, dt)  # noqa: E731
    return (t(q, q_dtype), t(kp, kv_dtype), t(vp, kv_dtype),
            t(kn, kv_dtype), t(vn, kv_dtype), t(phys),
            t(np.asarray(positions, np.int32)))


# h, kvh, d (a rank's slice), ps, np_, window, kv_start, positions (None:
# [NP x page, -1, page, 3 x page + 1] on 4 slots)
HD_CASES = [
    (20, 20, 16, 16, 32, 0, 0, None),   # qwen1.5-4b over 8 ranks
    (8, 4, 32, 16, 16, 40, 3, None),    # gemma3-4b over 8: G=2, window
    (32, 4, 16, 32, 8, 0, 5, None),     # yi-9b over 8: G=8, page 32
    (8, 1, 64, 64, 4, 100, 0, None),    # G=8, D/m 64, page 64
    (48, 8, 8, 16, 12, 0, 0, None),     # dbrx-132b over 16: D/m 8
    (6, 3, 24, 16, 5, 0, 2, None),      # D/m 24: not a power of two
    # live ranges that start and end inside a B2a CTA's chunk and inside
    # a page, kv_start past the first page
    (20, 20, 16, 16, 32, 100, 37, [333, 411, -1, 500, 90]),
    # a 5-token window: fewer live keys than a cluster's CTAs (the ranks
    # past the live ones hold none) and B2s ranges all dead but one page;
    # 20 pages, not a multiple of the cluster
    (8, 4, 32, 16, 20, 5, 0, [300, -1, 17, 64]),
    (20, 20, 16, 16, 1, 0, 3, [16, -1, 9, 1]),           # NP = 1
    (20, 20, 16, 16, 256, 0, 0, [4096]),    # one slot of 4096 tokens
    # one slot of 65536 tokens: B2s's pages in rounds, B2a's chunk too
    # long for its score cache (read from sc again), its V in rounds
    (20, 20, 16, 16, 4096, 0, 0, [65536]),
    (8, 4, 32, 16, 8, 0, 0,                 # B = 16
     [128, 7, -1, 64, 100, 33, 0, 128, 17, 90, 3, 128, 1, 50, 77, 127]),
]


@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,kvh,d,ps,np_,window,kv_start,positions",
                         HD_CASES)
def test_head_dim_decode_kernels_match_plain(dev, kv_dtype, q_dtype, h, kvh,
                                             d, ps, np_, window, kv_start,
                                             positions):
    """B2s's partial scores (float32: sums in another order) and B2a's
    output on them against the plain versions: float32 output within
    2e-5 of its scale, bfloat16 within one ulp; a pos = -1 lane's scores
    0 and its output exactly its v_new slice; dead keys score 0; one
    launch each, and two launches bit for bit equal."""
    cap = np_ * ps
    positions = positions or [cap, -1, ps, min(cap, 3 * ps + 1)]
    b = len(positions)
    q, kp, vp, kn, vn, phys, pos = _hd_problem(
        dev, b, h, kvh, d, ps, np_, positions, kv_dtype, q_dtype, h + d)
    ks = torch.full((b,), kv_start, dtype=torch.int32, device=dev)
    before = (tfd.flash_decode_hd_scores_cuda.launches,
              tfd.flash_decode_hd_attend_cuda.launches)
    sc = tfd.flash_decode_hd_scores_cuda(q, kp, kn, phys, pos, window, ks)
    want_sc = tfd.flash_decode_hd_scores_plain(q, kp, kn, phys, pos, window,
                                               ks)
    torch.cuda.synchronize()
    assert sc.shape == (b, h, cap + 1)
    torch.testing.assert_close(sc, want_sc, rtol=0,
                               atol=2e-5 * (1 + float(want_sc.abs().max())))
    dead = [i for i, p in enumerate(positions) if p < 0]
    for i in dead:
        assert bool((sc[i, :, :-1] == 0).all())
    scale = (4 * d) ** -0.5                # a rank's slice of 4 x d
    out = tfd.flash_decode_hd_attend_cuda(sc, vp, vn, phys, pos, window, ks,
                                          scale, q_dtype)
    again = tfd.flash_decode_hd_attend_cuda(sc, vp, vn, phys, pos, window,
                                            ks, scale, q_dtype)
    want = tfd.flash_decode_hd_attend_plain(sc, vp, vn, phys, pos, window,
                                            ks, scale, q_dtype)
    torch.cuda.synchronize()
    assert (tfd.flash_decode_hd_scores_cuda.launches,
            tfd.flash_decode_hd_attend_cuda.launches) == (before[0] + 1,
                                                          before[1] + 2)
    assert torch.equal(out, again)
    assert out.shape == (b, 1, h, d) and out.dtype == q_dtype
    tol = 2e-5 * (1 + float(want.float().abs().max()))
    if q_dtype == torch.bfloat16:
        tol += 2 ** -7 * float(want.float().abs().max())
    torch.testing.assert_close(out.float(), want.float(), rtol=0, atol=tol)
    g = h // kvh
    for i in dead:
        lane = vn[i, 0].to(q_dtype).repeat_interleave(g, 0)
        assert torch.equal(out[i, 0], lane)


def test_head_dim_decode_kernels_repeat_bitwise(dev):
    """At gemma3-4b's (1, 8) slice in bfloat16 (8 slots, 4 kv heads, G=2,
    D/m 32, 128 pages, its 1024 window, kv starts, a pos = -1 lane), three
    launches of each kernel give the same bits: every sum runs in one
    fixed order, the cluster's partials folded in rank order."""
    positions = [1100, -1, 1350, 1799, 1623, 1208, 1480, 1777]
    q, kp, vp, kn, vn, phys, pos = _hd_problem(
        dev, 8, 8, 4, 32, 16, 128, positions, torch.bfloat16, torch.bfloat16,
        7)
    ks = torch.tensor([0, 0, 7, 0, 300, 0, 0, 12], dtype=torch.int32,
                      device=dev)
    scs = [tfd.flash_decode_hd_scores_cuda(q, kp, kn, phys, pos, 1024, ks)
           for _ in range(3)]
    outs = [tfd.flash_decode_hd_attend_cuda(scs[0], vp, vn, phys, pos, 1024,
                                            ks, 256 ** -0.5, torch.bfloat16)
            for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(scs[0], x) for x in scs[1:])
    assert all(torch.equal(outs[0], x) for x in outs[1:])


@pytest.mark.parametrize("d", [16, 24])
@pytest.mark.parametrize("pool", ["float32", "bfloat16"])
def test_head_dim_decode_kernels_take_misaligned_pools(dev, pool, d):
    """Pools (and the new rows) at a storage offset that is not 16-byte
    aligned give the aligned launch's bits (element loads)."""
    dt = getattr(torch, pool)
    q, kp, vp, kn, vn, phys, pos = _hd_problem(
        dev, 4, 20, 20, d, 16, 8, [128, -1, 16, 49], dt, torch.float32, 5)
    ks = torch.tensor([0, 0, 5, 0], dtype=torch.int32, device=dev)
    sc = tfd.flash_decode_hd_scores_cuda(q, kp, kn, phys, pos, 30, ks)
    sc_m = tfd.flash_decode_hd_scores_cuda(q, _misaligned(kp),
                                           _misaligned(kn), phys, pos, 30, ks)
    out = tfd.flash_decode_hd_attend_cuda(sc, vp, vn, phys, pos, 30, ks,
                                          0.1, torch.float32)
    out_m = tfd.flash_decode_hd_attend_cuda(sc, _misaligned(vp),
                                            _misaligned(vn), phys, pos, 30,
                                            ks, 0.1, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(sc, sc_m) and torch.equal(out, out_m)
