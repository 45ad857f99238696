"""Paged flash decode: attention of one new token per slot over the paged
KV pool, read in place through the page table (port of
``repro.kernels.flash_decode``).

  * split-KV: each slot's logical KV length is cut into splits of
    ``split_pages`` pages; every split reduces to a triple ``(m, l, acc)``
    (running max, sum of exponentials at that max, partial numerator).
  * the triples form a commutative monoid under :func:`combine_splits`
    with identity ``(NEG_INF, 0, 0)``; :func:`reduce_splits` folds them,
    then the new token's self term is folded in. All-masked splits emit
    the identity, never NaN: probabilities are zero under the mask, not
    through ``exp(-inf)``.
  * GQA: queries arrive grouped ``(B, KVH, G, D)``, so the G query heads
    of one kv head share each K/V row.
  * trash page: ``phys`` maps unallocated pages to the pool's last page;
    its keys sit at ``kj >= pos`` and are masked, so its contents are
    never attended.

  * quantized pool: with ``codebook=`` the pages hold uint8 centroid
    codes ``(P+1, page, KVH, nc)`` (``core/kv_codebook.py``); fp K/V rows
    are never written to device memory.

On the card one ``flash_decode_paged`` call is one kernel: B2
(``csrc/flash_decode.cu``, :func:`flash_decode_paged_cuda`) or, over a
code pool, B5 (``csrc/flash_decode_kvq.cu``,
:func:`flash_decode_paged_kvq_cuda`) in its fused form. The splits of
one (slot, kv head) form a thread block cluster, and the reduction over
splits and the self-term fold (plain XLA in the JAX package, which fuses
it) run at the kernel's end over the cluster's shared memory. On the CPU
the same call is the plain pair: the per-split triples
(:func:`flash_decode_splits` / :func:`flash_decode_splits_kvq`), then
:func:`fold_splits` (:func:`flash_decode_paged_plain` /
:func:`flash_decode_paged_kvq_plain`). The triples form of each kernel
(:func:`flash_decode_splits_cuda`, :func:`flash_decode_splits_kvq_cuda`)
keeps the TPU kernels' contract, triples out, for holding B2 and B5
against their plain versions.

Under the head_dim layout of tensor parallelism (kv heads that do not
divide the model axis; ``models.layers.attention``) each rank's fp pool
holds every kv head's head_dim slice, and a decode is two kernels with an
all-reduce between them (``csrc/flash_decode_hd.cu``): B2s,
:func:`flash_decode_hd_scores`, the rank's partial scores (B, H, T + 1)
(the last column the new token's self term), and, on their sum over the
ranks, B2a, :func:`flash_decode_hd_attend`: the scale, the masks, one
float32 softmax and the probabilities times the rank's V slice. Their
plain versions are :func:`flash_decode_hd_scores_plain` and
:func:`flash_decode_hd_attend_plain`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.similarity import one_hot
from repro_torch.launch.op_cost import kernel_call, meta_result
from . import _build
from . import work as _work

# Finite stand-in for -inf. exp(NEG_INF - NEG_INF) == 1 (not NaN), which
# is what makes the identity triple compose safely.
NEG_INF = -1e30

#: Blocks a split-KV launch of kernel B2 aims at: ten on each of the
#: H100's 132 SMs. B2's blocks are short (a few tiles each), and their
#: time goes to a chain of dependent steps (page ids, then K/V tiles,
#: then the scores, the merge and the write); many blocks in flight hide
#: it. Fewer, longer blocks leave an SM with too few warps; more, shorter
#: ones write more triples. At the main path's 8 slots x 20 kv heads x 32
#: pages this is 8 splits of 4 pages. Chosen on an H100 from the sweep
#: ``chip_smoke.py`` prints; the port's choice for this card, not the
#: TPU's table.
SPLIT_BLOCKS = 10 * 132

#: The same for kernel B5 over a code pool: four blocks an SM (4 splits
#: of 8 pages at the main path). A B5 block builds a score table before
#: its first key, so it wants more keys than a B2 block.
SPLIT_BLOCKS_KVQ = 4 * 132


#: Most splits of one launch: the fused kernels' splits of one (slot, kv
#: head) form one thread block cluster, at most 16 blocks on Hopper.
MAX_SPLITS = 16


def split_pages_for(b: int, kvh: int, np_: int, kvq: bool = False) -> int:
    """Pages per split of a launch over ``b`` slots x ``kvh`` kv heads x
    ``np_`` pages: the fewest splits that reach :data:`SPLIT_BLOCKS`
    (:data:`SPLIT_BLOCKS_KVQ` over a code pool) blocks, at most one split
    per page and at most :data:`MAX_SPLITS` splits. The main path's 8
    slots x 20 kv heads x 32 pages of 16 take 8 splits of 4 pages (B2) or
    4 splits of 8 pages (B5); one slot at 4096 tokens takes 16 splits."""
    blocks = SPLIT_BLOCKS_KVQ if kvq else SPLIT_BLOCKS
    ns = max(1, min(np_, MAX_SPLITS, -(-blocks // max(1, b * kvh))))
    return -(-np_ // ns)


Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def combine_splits(a: Triple, b: Triple) -> Triple:
    """Merge two split triples ``(m, l, acc)`` into one (associative,
    commutative, identity ``(NEG_INF, 0, 0)``)."""
    m_a, l_a, o_a = a
    m_b, l_b, o_b = b
    m = torch.maximum(m_a, m_b)
    wa = torch.exp(m_a - m)
    wb = torch.exp(m_b - m)
    return (m, l_a * wa + l_b * wb,
            o_a * wa[..., None] + o_b * wb[..., None])


def reduce_splits(m: torch.Tensor, l: torch.Tensor,
                  acc: torch.Tensor) -> Triple:
    """Fold per-split triples over the leading split axis in one pass.
    m, l: (NS, ...); acc: (NS, ..., D)."""
    m_t = torch.amax(m, dim=0)
    w = torch.exp(m - m_t[None])
    return m_t, torch.sum(l * w, dim=0), torch.sum(acc * w[..., None], dim=0)


def _split_masks(pos, win: int, ks, kj):
    """Shared causal/window/kv_start mask. kj broadcasts against pos."""
    mask = (kj < pos) & (kj >= ks)
    if win > 0:
        mask = mask & (kj > pos - win)
    return mask


def flash_decode_splits(qg: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, phys: torch.Tensor,
                        pos: torch.Tensor, win: int, ks: torch.Tensor,
                        split_pages: int) -> Triple:
    """Per-split triples in plain PyTorch: the plain version of kernel B2.

    qg: (B, KVH, G, D) float32 queries, already scaled by D**-0.5.
    k_pages/v_pages: (P+1, page, KVH, D) pool (last page = trash).
    phys: (B, NS*split_pages) physical page ids (trash-padded).
    pos/ks: (B,) int32; win: int (0 = no window).
    Returns (m, l, acc) shaped (NS, B, KVH, G[, D]) float32.
    ``flash_decode_splits.calls`` counts calls.
    """
    _build.bump(flash_decode_splits, "calls")
    b, kvh, g, d = qg.shape
    ps = k_pages.shape[1]
    ns = phys.shape[1] // split_pages
    sl = split_pages * ps                                  # tokens / split
    kg = k_pages[phys.long()].reshape(b, ns, sl, kvh, d).float()
    vg = v_pages[phys.long()].reshape(b, ns, sl, kvh, d).float()
    kj = torch.arange(ns * sl, dtype=torch.int32,
                      device=qg.device).reshape(ns, sl)
    mask = _split_masks(pos[:, None, None], win, ks[:, None, None],
                        kj[None])                          # (B, NS, SL)
    mask5 = mask[:, :, None, None, :]
    sc = torch.einsum("bkgd,bstkd->bskgt", qg, kg)
    sc = torch.where(mask5, sc, torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1)                             # (B, NS, KVH, G)
    p = torch.where(mask5, torch.exp(sc - m[..., None]),
                    torch.zeros_like(sc))
    l = torch.sum(p, dim=-1)
    acc = torch.einsum("bskgt,bstkd->bskgd", p, vg)
    return (m.movedim(1, 0).contiguous(), l.movedim(1, 0).contiguous(),
            acc.movedim(1, 0).contiguous())


flash_decode_splits.calls = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = _build.load("flash_decode")
    if lib.flash_decode_splits_launch.argtypes is None:
        fn = lib.flash_decode_splits_launch
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _I, _P, _P, _P,
                       _I, _I, _I, _I, _I, _I, _I, _I, _P]
        fn.restype = _I
        fn = lib.flash_decode_paged_launch
        fn.argtypes = [_P] * 8 + [_I, _P, _F] + [_I] * 9 + [_P, _P]
        fn.restype = _I
    return lib


def _check(cond: bool, msg: str,
           who: str = "flash_decode_splits_cuda") -> None:
    if not cond:
        raise ValueError(f"{who}: {msg}")


def flash_decode_splits_cuda(qg: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, phys: torch.Tensor,
                             pos: torch.Tensor, win: int, ks: torch.Tensor,
                             split_pages: int) -> Triple:
    """Kernel B2: the same contract as :func:`flash_decode_splits`, on the
    card. All tensors contiguous CUDA tensors on one device; qg float32,
    pages float32 or bfloat16, phys/pos/ks int32. G <= 8, D <= 256.
    ``flash_decode_splits_cuda.launches`` counts launches."""
    tensors = [qg, k_pages, v_pages, phys, pos, ks]
    _check(all(t.device.type == "cuda" for t in tensors),
           "all tensors must be CUDA tensors")
    _check(len({t.device for t in tensors}) == 1,
           "tensors lie on different devices")
    _check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    _check(qg.dtype == torch.float32, "qg must be float32")
    _check(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
           f"pages must share one of {list(_KV_DTYPES)}")
    _check(all(t.dtype == torch.int32 for t in (phys, pos, ks)),
           "phys, pos and kv_start must be int32")
    b, kvh, g, d = qg.shape
    p1, ps = k_pages.shape[0], k_pages.shape[1]
    _check(tuple(k_pages.shape) == (p1, ps, kvh, d)
           and v_pages.shape == k_pages.shape,
           f"pool {tuple(k_pages.shape)} does not match qg {tuple(qg.shape)}")
    _check(phys.dim() == 2 and phys.shape[0] == b
           and tuple(pos.shape) == (b,) and tuple(ks.shape) == (b,),
           "phys (B, NP), pos (B,) and kv_start (B,) expected")
    _check(1 <= g <= 8 and 1 <= d <= 256 and split_pages >= 1,
           f"G={g}, D={d} or split_pages={split_pages} out of range")
    np_ = phys.shape[1]
    ns = -(-np_ // split_pages)
    fn = _lib().flash_decode_splits_launch
    m = torch.empty((ns, b, kvh, g), dtype=torch.float32, device=qg.device)
    l = torch.empty_like(m)
    acc = torch.empty((ns, b, kvh, g, d), dtype=torch.float32,
                      device=qg.device)
    with torch.cuda.device(qg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qg.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 phys.data_ptr(), pos.data_ptr(), ks.data_ptr(), int(win),
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                 b, kvh, g, d, ps, np_, split_pages,
                 _KV_DTYPES[k_pages.dtype], stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode_splits_cuda: launch failed with cudaError {err}")
    _build.bump(flash_decode_splits_cuda, "launches")
    return m, l, acc


flash_decode_splits_cuda.launches = 0


def flash_decode_splits_kvq(qg: torch.Tensor, kc_pages: torch.Tensor,
                            vc_pages: torch.Tensor, zk: torch.Tensor,
                            zv: torch.Tensor, sk: torch.Tensor,
                            sv: torch.Tensor, phys: torch.Tensor,
                            pos: torch.Tensor, win: int, ks: torch.Tensor,
                            split_pages: int) -> Triple:
    """Per-split triples over a code pool, in plain PyTorch: the plain
    version of kernel B5, in the LUT-accumulate form of the JAX package's
    ``_flash_xla_kvq`` (cut into splits). Scores are a one-hot contraction
    of the codes with the per-query table ``(q * sk)_s . zk_s``; the value
    side pools probability mass per (subspace, centroid) and applies each
    centroid once. fp K/V rows are never formed.

    kc_pages/vc_pages: (P+1, page, KVH, nc) uint8; zk/zv (nc, c, v);
    sk/sv (KVH,); the rest as :func:`flash_decode_splits`.
    ``flash_decode_splits_kvq.calls`` counts calls.
    """
    _build.bump(flash_decode_splits_kvq, "calls")
    b, kvh, g, d = qg.shape
    ps = kc_pages.shape[1]
    nc, c, v = zk.shape
    ns = phys.shape[1] // split_pages
    sl = split_pages * ps
    kc = kc_pages[phys.long()].reshape(b, ns, sl, kvh, nc).long()
    vc = vc_pages[phys.long()].reshape(b, ns, sl, kvh, nc).long()
    qs = (qg * sk.float()[None, :, None, None]).reshape(b, kvh, g, nc, v)
    lut_k = torch.einsum("bkgsv,scv->bkgsc", qs, zk.float())
    oh_k = one_hot(kc, c, torch.float32)
    sc = torch.einsum("bntksc,bkgsc->bnkgt", oh_k, lut_k)  # (B,NS,KVH,G,SL)
    kj = torch.arange(ns * sl, dtype=torch.int32,
                      device=qg.device).reshape(ns, sl)
    mask = _split_masks(pos[:, None, None], win, ks[:, None, None],
                        kj[None])                          # (B, NS, SL)
    mask5 = mask[:, :, None, None, :]
    sc = torch.where(mask5, sc, torch.full_like(sc, NEG_INF))
    m = torch.amax(sc, dim=-1)                             # (B, NS, KVH, G)
    p = torch.where(mask5, torch.exp(sc - m[..., None]),
                    torch.zeros_like(sc))
    l = torch.sum(p, dim=-1)
    oh_v = one_hot(vc, c, torch.float32)
    w = torch.einsum("bnkgt,bntksc->bnkgsc", p, oh_v)
    acc = torch.einsum("bnkgsc,scv->bnkgsv", w, zv.float())
    acc = acc.reshape(b, ns, kvh, g, d) * sv.float()[None, None, :, None,
                                                     None]
    return (m.movedim(1, 0).contiguous(), l.movedim(1, 0).contiguous(),
            acc.movedim(1, 0).contiguous())


flash_decode_splits_kvq.calls = 0


def _lib_kvq():
    lib = _build.load("flash_decode_kvq")
    fn = lib.flash_decode_splits_kvq_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 10 + [_I, _P, _P, _P] + [_I] * 10 + [_P]
        fn.restype = _I
        fn = lib.flash_decode_paged_kvq_launch
        fn.argtypes = [_P] * 12 + [_I, _P, _F] + [_I] * 11 + [_P, _P]
        fn.restype = _I
        lib.flash_decode_kvq_form.argtypes = [_I] * 8
        lib.flash_decode_kvq_form.restype = _I
    return lib


# Forms of kernel B5 (``csrc/flash_decode_kvq.cu``): the LUT form (score
# table and probability pooled per centroid) and the dequantize form (fp
# rows in shared memory, then B2's row loop). A launch takes the LUT form
# when its tables fit the block's shared memory, else the other.
_KVQ_FORMS = {1: "lut", 2: "dequantize"}


def kvq_form(g: int, d: int, page: int, split_pages: int, nc: int, c: int,
             v: int, fused: bool = False) -> Optional[str]:
    """The form kernel B5 takes at these shapes ("lut" or "dequantize"),
    or None when it cannot launch; ``fused``: in its fused form, whose
    push slots take shared memory the triples form leaves to the LUT
    form. Builds the kernel."""
    form = _lib_kvq().flash_decode_kvq_form(g, d, page, split_pages, nc, c,
                                            v, int(fused))
    return _KVQ_FORMS.get(form)


def flash_decode_splits_kvq_cuda(qg: torch.Tensor, kc_pages: torch.Tensor,
                                 vc_pages: torch.Tensor, zk: torch.Tensor,
                                 zv: torch.Tensor, sk: torch.Tensor,
                                 sv: torch.Tensor, phys: torch.Tensor,
                                 pos: torch.Tensor, win: int,
                                 ks: torch.Tensor, split_pages: int
                                 ) -> Triple:
    """Kernel B5: the same contract as :func:`flash_decode_splits_kvq`, on
    the card. All tensors contiguous CUDA tensors on one device; qg, zk,
    zv, sk, sv float32, code pages uint8, phys/pos/ks int32; G <= 8,
    D = nc * v <= 256, c <= 256. ``flash_decode_splits_kvq_cuda.launches``
    counts launches."""
    tensors = [qg, kc_pages, vc_pages, zk, zv, sk, sv, phys, pos, ks]

    def check(cond, msg):
        _check(cond, msg, "flash_decode_splits_kvq_cuda")
    check(all(t.device.type == "cuda" for t in tensors),
           "all tensors must be CUDA tensors")
    check(len({t.device for t in tensors}) == 1,
           "tensors lie on different devices")
    check(all(t.is_contiguous() for t in tensors),
           "tensors must be contiguous")
    check(all(t.dtype == torch.float32 for t in (qg, zk, zv, sk, sv)),
           "qg, zk, zv, sk and sv must be float32")
    check(kc_pages.dtype == torch.uint8 and vc_pages.dtype == torch.uint8,
           "code pages must be uint8")
    check(all(t.dtype == torch.int32 for t in (phys, pos, ks)),
           "phys, pos and kv_start must be int32")
    b, kvh, g, d = qg.shape
    nc, c, v = zk.shape
    p1, ps = kc_pages.shape[0], kc_pages.shape[1]
    check(tuple(kc_pages.shape) == (p1, ps, kvh, nc)
           and vc_pages.shape == kc_pages.shape,
           f"code pool {tuple(kc_pages.shape)} does not match qg "
           f"{tuple(qg.shape)} and nc={nc}")
    check(zv.shape == zk.shape and nc * v == d,
           f"tables {tuple(zk.shape)}/{tuple(zv.shape)} do not cover D={d}")
    check(tuple(sk.shape) == (kvh,) and tuple(sv.shape) == (kvh,),
           "sk and sv must have shape (KVH,)")
    check(phys.dim() == 2 and phys.shape[0] == b
           and tuple(pos.shape) == (b,) and tuple(ks.shape) == (b,),
           "phys (B, NP), pos (B,) and kv_start (B,) expected")
    check(1 <= g <= 8 and 1 <= d <= 256 and 1 <= c <= 256
           and split_pages >= 1,
           f"G={g}, D={d}, c={c} or split_pages={split_pages} out of range")
    np_ = phys.shape[1]
    ns = -(-np_ // split_pages)
    fn = _lib_kvq().flash_decode_splits_kvq_launch
    m = torch.empty((ns, b, kvh, g), dtype=torch.float32, device=qg.device)
    l = torch.empty_like(m)
    acc = torch.empty((ns, b, kvh, g, d), dtype=torch.float32,
                      device=qg.device)
    with torch.cuda.device(qg.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qg.data_ptr(), kc_pages.data_ptr(), vc_pages.data_ptr(),
                 zk.data_ptr(), zv.data_ptr(), sk.data_ptr(), sv.data_ptr(),
                 phys.data_ptr(), pos.data_ptr(), ks.data_ptr(), int(win),
                 m.data_ptr(), l.data_ptr(), acc.data_ptr(),
                 b, kvh, g, d, ps, np_, split_pages, nc, c, v, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_decode_splits_kvq_cuda: launch failed with cudaError "
            f"{err}")
    _build.bump(flash_decode_splits_kvq_cuda, "launches")
    return m, l, acc


flash_decode_splits_kvq_cuda.launches = 0


def fold_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                qg: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Reduce the split triples and fold in the new token's self term, in
    plain PyTorch: the plain version of the fused kernels' epilogue
    (``flashc::fold_end``, ``csrc/flash_common.cuh``).

    m, l: (NS, B, KVH, G), acc: (NS, B, KVH, G, D) float32 (from B2/B5 or
    their plain versions); qg (B, KVH, G, D) float32, pre-scaled;
    k_new/v_new (B, 1, KVH, D). Returns (B, 1, KVH*G*D) in ``out_dtype``.
    The new token is always live, so the denominator is >= exp(0): never
    zero, and a lane whose splits are all the identity (pos = -1) returns
    exactly its v_new row. ``fold_splits.calls`` counts calls.
    """
    _build.bump(fold_splits, "calls")
    b, kvh, g, d = qg.shape
    m, l, acc = reduce_splits(m, l, acc)
    s_new = torch.einsum("bkgd,bkd->bkg", qg, k_new[:, 0].float())
    m_f = torch.maximum(m, s_new)
    alpha = torch.exp(m - m_f)
    p_new = torch.exp(s_new - m_f)
    denom = l * alpha + p_new
    out = (acc * alpha[..., None]
           + p_new[..., None] * v_new[:, 0, :, None, :].float())
    out = out / denom[..., None]
    return out.reshape(b, 1, kvh * g * d).to(out_dtype)


fold_splits.calls = 0


@functools.lru_cache(maxsize=64)
def _device_const(value, dtype: torch.dtype, n: int,
                  device: torch.device) -> torch.Tensor:
    """A constant (n,) tensor on ``device``, made once: the query scale
    and an int kv_start reach the card without a copy or fill per call.
    Every caller gets the same tensor, so callers only read it."""
    return torch.full((n,), value, dtype=dtype, device=device)


def _scaled_query(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q (B, 1, H, D) as (B, KVH, G, D) float32 times D**-0.5: one
    float32 multiply (a (1,) float32 scale promotes q)."""
    b, _, h, d = q.shape
    return q.reshape(b, kvh, h // kvh, d) * _device_const(
        d ** -0.5, torch.float32, 1, q.device)


def _trash_padded(phys: torch.Tensor, split_pages: int,
                  trash: int) -> torch.Tensor:
    """phys padded with the trash page to whole splits, as the plain
    versions index it (keys there sit at kj >= NP*page >= pos)."""
    pad = (-phys.shape[1]) % split_pages
    if pad:
        phys = torch.nn.functional.pad(phys, (0, pad), value=trash)
    return phys.contiguous()


def flash_decode_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, phys: torch.Tensor,
                             pos: torch.Tensor, win: int, ks: torch.Tensor,
                             split_pages: int) -> torch.Tensor:
    """One paged decode attention over an fp pool in plain PyTorch: the
    plain version of :func:`flash_decode_paged_cuda`. The query scaled,
    B2's plain triples (:func:`flash_decode_splits`), then
    :func:`fold_splits`. ``flash_decode_paged_plain.calls`` counts
    calls."""
    _build.bump(flash_decode_paged_plain, "calls")
    qg = _scaled_query(q, k_pages.shape[2])
    m, l, acc = flash_decode_splits(
        qg, k_pages, v_pages, _trash_padded(phys, split_pages,
                                            k_pages.shape[0] - 1),
        pos, win, ks, split_pages)
    return fold_splits(m, l, acc, qg, k_new, v_new, q.dtype)


flash_decode_paged_plain.calls = 0


def flash_decode_paged_kvq_plain(q: torch.Tensor, kc_pages: torch.Tensor,
                                 vc_pages: torch.Tensor, zk: torch.Tensor,
                                 zv: torch.Tensor, sk: torch.Tensor,
                                 sv: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor, phys: torch.Tensor,
                                 pos: torch.Tensor, win: int,
                                 ks: torch.Tensor,
                                 split_pages: int) -> torch.Tensor:
    """The same over a code pool: the plain version of
    :func:`flash_decode_paged_kvq_cuda` (:func:`flash_decode_splits_kvq`,
    then :func:`fold_splits`). ``flash_decode_paged_kvq_plain.calls``
    counts calls."""
    _build.bump(flash_decode_paged_kvq_plain, "calls")
    qg = _scaled_query(q, kc_pages.shape[2])
    m, l, acc = flash_decode_splits_kvq(
        qg, kc_pages, vc_pages, zk, zv, sk, sv,
        _trash_padded(phys, split_pages, kc_pages.shape[0] - 1), pos, win,
        ks, split_pages)
    return fold_splits(m, l, acc, qg, k_new, v_new, q.dtype)


flash_decode_paged_kvq_plain.calls = 0


def _check_fused(who: str, q: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, pool: torch.Tensor,
                 tensors: list, phys: torch.Tensor, pos: torch.Tensor,
                 ks: torch.Tensor, split_pages: int) -> Tuple[int, int, int,
                                                             int, int]:
    """The checks both fused wrappers share. Returns (B, KVH, G, D, NP)."""
    def check(cond, msg):
        _check(cond, msg, who)
    check(all(t.device.type == "cuda" for t in tensors),
          "all tensors must be CUDA tensors")
    check(len({t.device for t in tensors}) == 1,
          "tensors lie on different devices")
    check(all(t.is_contiguous() for t in tensors),
          "tensors must be contiguous")
    check(q.dtype in _KV_DTYPES, f"q must be one of {list(_KV_DTYPES)}")
    check(k_new.dtype == q.dtype and v_new.dtype == q.dtype,
          f"k_new ({k_new.dtype}) and v_new ({v_new.dtype}) must be in q's "
          f"dtype {q.dtype}")
    check(all(t.dtype == torch.int32 for t in (phys, pos, ks)),
          "phys, pos and kv_start must be int32")
    check(q.dim() == 4 and q.shape[1] == 1 and pool.dim() == 4,
          f"q (B, 1, H, D) and a pool (P+1, page, KVH, .) expected, got "
          f"{tuple(q.shape)} and {tuple(pool.shape)}")
    b, _, h, d = q.shape
    kvh = pool.shape[2]
    check(kvh >= 1 and h % kvh == 0,
          f"{h} query heads do not group over {kvh} kv heads")
    g = h // kvh
    check(tuple(k_new.shape) == (b, 1, kvh, d) and v_new.shape == k_new.shape,
          f"k_new {tuple(k_new.shape)} / v_new {tuple(v_new.shape)}, "
          f"expected {(b, 1, kvh, d)}")
    check(phys.dim() == 2 and phys.shape[0] == b
          and tuple(pos.shape) == (b,) and tuple(ks.shape) == (b,),
          "phys (B, NP), pos (B,) and kv_start (B,) expected")
    check(1 <= g <= 8 and 1 <= d <= 256 and split_pages >= 1,
          f"G={g}, D={d} or split_pages={split_pages} out of range")
    np_ = phys.shape[1]
    ns = -(-np_ // split_pages)
    check(ns <= MAX_SPLITS,
          f"{ns} splits of {split_pages} pages over {np_} pages: at most "
          f"MAX_SPLITS = {MAX_SPLITS} (one thread block cluster)")
    return b, kvh, g, d, np_


def _launch_fused(who: str, fn, q: torch.Tensor, args: list, shape: list,
                  q_scale: float) -> torch.Tensor:
    """Launch a fused kernel's C entry point: args, then out, q_scale (the
    kernel multiplies q by it as it reads q), shape and q's dtype."""
    b, _, h, d = q.shape
    out = torch.empty((b, 1, h * d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, out.data_ptr(), q_scale, *shape,
                 _KV_DTYPES[q.dtype], stream, None)
    if err != 0:
        raise RuntimeError(
            f"{who}: launch failed with cudaError {err} (9: no thread block "
            "cluster of this launch's splits fits the card)")
    return out


def flash_decode_paged_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, phys: torch.Tensor,
                            pos: torch.Tensor, win: int, ks: torch.Tensor,
                            split_pages: int) -> torch.Tensor:
    """Kernel B2 in its fused form: the same contract as
    :func:`flash_decode_paged_plain`, on the card, in one kernel. q (B, 1,
    H, D) float32 or bfloat16; k_new, v_new (B, 1, KVH, D) in q's dtype;
    pages float32 or bfloat16; phys (B, NP) int32 need not be padded;
    pos/ks int32. All contiguous CUDA tensors on one device. G <= 8, D <=
    256, at most :data:`MAX_SPLITS` splits. Returns (B, 1, H*D) in q's
    dtype. ``flash_decode_paged_cuda.launches`` counts launches."""
    who = "flash_decode_paged_cuda"
    _check(k_pages.dtype in _KV_DTYPES and v_pages.dtype == k_pages.dtype,
           f"pages must share one of {list(_KV_DTYPES)}", who)
    b, kvh, g, d, np_ = _check_fused(
        who, q, k_new, v_new, k_pages,
        [q, k_pages, v_pages, k_new, v_new, phys, pos, ks], phys, pos, ks,
        split_pages)
    p1, ps = k_pages.shape[0], k_pages.shape[1]
    _check(tuple(k_pages.shape) == (p1, ps, kvh, d)
           and v_pages.shape == k_pages.shape,
           f"pool {tuple(k_pages.shape)} does not match q {tuple(q.shape)}",
           who)
    out = _launch_fused(
        who, _lib().flash_decode_paged_launch, q,
        [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
         k_new.data_ptr(), v_new.data_ptr(), phys.data_ptr(), pos.data_ptr(),
         ks.data_ptr(), int(win)],
        [b, kvh, g, d, ps, np_, split_pages, _KV_DTYPES[k_pages.dtype]],
        d ** -0.5)
    _build.bump(flash_decode_paged_cuda, "launches")
    return out


flash_decode_paged_cuda.launches = 0


def flash_decode_paged_kvq_cuda(q: torch.Tensor, kc_pages: torch.Tensor,
                                vc_pages: torch.Tensor, zk: torch.Tensor,
                                zv: torch.Tensor, sk: torch.Tensor,
                                sv: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, phys: torch.Tensor,
                                pos: torch.Tensor, win: int,
                                ks: torch.Tensor,
                                split_pages: int) -> torch.Tensor:
    """Kernel B5 in its fused form: the same contract as
    :func:`flash_decode_paged_kvq_plain`, on the card, in one kernel. q,
    k_new, v_new as :func:`flash_decode_paged_cuda`; code pages uint8
    (P+1, page, KVH, nc); zk, zv (nc, c, v), sk, sv (KVH,) float32; D = nc
    * v <= 256, c <= 256. ``flash_decode_paged_kvq_cuda.launches`` counts
    launches."""
    who = "flash_decode_paged_kvq_cuda"
    _check(kc_pages.dtype == torch.uint8 and vc_pages.dtype == torch.uint8,
           "code pages must be uint8", who)
    _check(all(t.dtype == torch.float32 for t in (zk, zv, sk, sv)),
           "zk, zv, sk and sv must be float32", who)
    b, kvh, g, d, np_ = _check_fused(
        who, q, k_new, v_new, kc_pages,
        [q, kc_pages, vc_pages, zk, zv, sk, sv, k_new, v_new, phys, pos, ks],
        phys, pos, ks, split_pages)
    _check(zk.dim() == 3, f"zk (nc, c, v) expected, got {tuple(zk.shape)}",
           who)
    nc, c, v = zk.shape
    p1, ps = kc_pages.shape[0], kc_pages.shape[1]
    _check(tuple(kc_pages.shape) == (p1, ps, kvh, nc)
           and vc_pages.shape == kc_pages.shape,
           f"code pool {tuple(kc_pages.shape)} does not match q "
           f"{tuple(q.shape)} and nc={nc}", who)
    _check(zv.shape == zk.shape and nc * v == d and 1 <= c <= 256,
           f"tables {tuple(zk.shape)}/{tuple(zv.shape)} do not cover D={d} "
           "with c <= 256", who)
    _check(tuple(sk.shape) == (kvh,) and tuple(sv.shape) == (kvh,),
           "sk and sv must have shape (KVH,)", who)
    out = _launch_fused(
        who, _lib_kvq().flash_decode_paged_kvq_launch, q,
        [q.data_ptr(), kc_pages.data_ptr(), vc_pages.data_ptr(),
         zk.data_ptr(), zv.data_ptr(), sk.data_ptr(), sv.data_ptr(),
         k_new.data_ptr(), v_new.data_ptr(), phys.data_ptr(), pos.data_ptr(),
         ks.data_ptr(), int(win)],
        [b, kvh, g, d, ps, np_, split_pages, nc, c, v], d ** -0.5)
    _build.bump(flash_decode_paged_kvq_cuda, "launches")
    return out


flash_decode_paged_kvq_cuda.launches = 0


def fused_geometry(q: torch.Tensor, pool: torch.Tensor, phys: torch.Tensor,
                   split_pages: int, codebook: Optional[dict] = None) -> dict:
    """The launch that :func:`flash_decode_paged_cuda` (with ``codebook``,
    :func:`flash_decode_paged_kvq_cuda`) makes at these shapes and dtypes,
    without making it: its cluster size (splits), the clusters of its
    grid, how many of them the card holds at once, and a block's shared
    memory bytes and registers a thread."""
    b, _, h, d = q.shape
    kvh, ps, np_ = pool.shape[2], pool.shape[1], phys.shape[1]
    info = (ctypes.c_int * 5)()
    if codebook is None:
        fn = _lib().flash_decode_paged_launch
        args = [None] * 8 + [0, None, 1.0, b, kvh, h // kvh, d, ps, np_,
                             split_pages, _KV_DTYPES[pool.dtype]]
    else:
        nc, c, v = codebook["zk"].shape
        fn = _lib_kvq().flash_decode_paged_kvq_launch
        args = [None] * 12 + [0, None, 1.0, b, kvh, h // kvh, d, ps, np_,
                              split_pages, nc, c, v]
    with torch.cuda.device(q.device):
        err = fn(*args, _KV_DTYPES[q.dtype], None, info)
    if err != 0:
        raise RuntimeError(f"fused_geometry: cudaError {err}")
    return dict(zip(("cluster", "clusters", "resident", "smem", "registers"),
                    info))


def flash_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, phys: torch.Tensor, positions,
                       *, window: int = 0, kv_start=0,
                       codebook: Optional[dict] = None,
                       split_pages: Optional[int] = None) -> torch.Tensor:
    """Single-token paged decode attention.

    q (B,1,H,D); k_pages/v_pages (P+1, page, KVH, D): one layer's slice of
    the pool, last page = trash; k_new/v_new (B,1,KVH,D) the fresh token,
    NOT yet in the pool (its self term is always live and computed from
    these fp rows, so the newest token is exact on a quantized pool too).
    phys (B, NP) physical page ids, already trash-redirected. positions:
    (B,) int32 per-slot lengths (-1 = inactive lane: its output is the
    v_new row, discarded by the caller). window: int; kv_start: int or
    (B,). codebook: one layer's slice of the KV codebook ({"zk": (nc, c,
    v), "zv": ..., "sk": (KVH,), "sv": ...}); when given, k_pages/v_pages
    are uint8 code pools (P+1, page, KVH, nc). split_pages: pages per
    split (default :func:`split_pages_for`).
    For CUDA tensors, one kernel: B2 (B5 over codes) in its fused form;
    for CPU tensors, the plain versions; meta tensors as
    ``kernels.ops``' entry points take them (under an OpCost only).
    Returns (B, 1, H*D) in q's dtype.
    """
    b, s, h, d = q.shape
    if s != 1:
        raise ValueError(f"flash decode is single-token (got S={s})")
    with kernel_call("b2" if codebook is None else "b5", q.device,
                     lambda: _work.flash_decode(q, k_pages, k_new, phys,
                                                codebook)):
        if q.is_meta:
            return meta_result((b, 1, h * d), q.dtype)
        return _flash_decode_paged(q, k_pages, v_pages, k_new, v_new, phys,
                                   positions, window, kv_start, codebook,
                                   split_pages)


def _lanes(positions, kv_start, b: int, dev: torch.device
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (B,) int32 positions and kv starts a launch takes (an int
    kv_start: one constant tensor, made once)."""
    pos = torch.as_tensor(positions, dtype=torch.int32,
                          device=dev).expand(b).contiguous()
    ks = (_device_const(kv_start, torch.int32, b, dev)
          if isinstance(kv_start, int) else
          torch.as_tensor(kv_start, dtype=torch.int32,
                          device=dev).expand(b).contiguous())
    return pos, ks


def _flash_decode_paged(q, k_pages, v_pages, k_new, v_new, phys, positions,
                        window, kv_start, codebook, split_pages):
    b = q.shape[0]
    kvh = k_pages.shape[2]
    np_ = phys.shape[1]
    dev = q.device
    pos, ks = _lanes(positions, kv_start, b, dev)
    if split_pages is None:
        split_pages = split_pages_for(b, kvh, np_, codebook is not None)
    sp = min(split_pages, np_)
    args = (q.contiguous(), k_pages, v_pages)
    rest = (k_new.contiguous(), v_new.contiguous(),
            phys.to(torch.int32).contiguous(), pos, window, ks, sp)
    if codebook is None:
        fn = (flash_decode_paged_plain if dev.type == "cpu"
              else flash_decode_paged_cuda)
        return fn(*args, *rest)
    fn = (flash_decode_paged_kvq_plain if dev.type == "cpu"
          else flash_decode_paged_kvq_cuda)
    return fn(*args, codebook["zk"], codebook["zv"], codebook["sk"],
              codebook["sv"], *rest)


# ---------------------------------------------------------------------------
# the head_dim layout's decode: B2s (partial scores), B2a (attend)
# ---------------------------------------------------------------------------

def _live_keys(pos: torch.Tensor, win: int, ks: torch.Tensor,
               t: int) -> torch.Tensor:
    """(B, T) the live keys of each lane: kv_start <= j < pos, within the
    window."""
    kj = torch.arange(t, dtype=torch.int32, device=pos.device)[None]
    return _split_masks(pos[:, None], win, ks[:, None], kj)


def flash_decode_hd_scores_plain(q: torch.Tensor, k_pages: torch.Tensor,
                                 k_new: torch.Tensor, phys: torch.Tensor,
                                 pos: torch.Tensor, win: int,
                                 ks: torch.Tensor) -> torch.Tensor:
    """The partial scores of the head_dim layout in plain PyTorch: the
    plain version of kernel B2s. q (B, 1, KVH*G, D) (a rank's head_dim
    slice, unscaled), k_pages (P+1, page, KVH, D), k_new (B, 1, KVH, D),
    phys (B, NP) trash-redirected, pos / ks (B,) int32. Returns (B, H,
    NP*page + 1) float32: the dot products of q with every live key row
    (0 elsewhere), then the self term with k_new.
    ``flash_decode_hd_scores_plain.calls`` counts calls."""
    _build.bump(flash_decode_hd_scores_plain, "calls")
    b, _, h, d = q.shape
    kvh, ps = k_pages.shape[2], k_pages.shape[1]
    t = phys.shape[1] * ps
    qf = q[:, 0].float().reshape(b, kvh, h // kvh, d)
    kg = k_pages[phys.long()].reshape(b, t, kvh, d).float()
    sc = torch.einsum("bkgd,btkd->bkgt", qf, kg)
    live = _live_keys(pos, win, ks, t)[:, None, None]
    sc = torch.where(live, sc, torch.zeros_like(sc))
    s_new = torch.einsum("bkgd,bkd->bkg", qf, k_new[:, 0].float())
    return torch.cat([sc, s_new[..., None]], -1).reshape(b, h, t + 1)


flash_decode_hd_scores_plain.calls = 0


def flash_decode_hd_attend_plain(sc: torch.Tensor, v_pages: torch.Tensor,
                                 v_new: torch.Tensor, phys: torch.Tensor,
                                 pos: torch.Tensor, win: int,
                                 ks: torch.Tensor, scale: float,
                                 out_dtype: torch.dtype) -> torch.Tensor:
    """The attend step of the head_dim layout in plain PyTorch: the plain
    version of kernel B2a. sc (B, H, NP*page + 1) float32, the scores
    summed over the ranks; v_pages (P+1, page, KVH, D) and v_new (B, 1,
    KVH, D), the rank's slices. The scores times ``scale`` (the whole
    head_dim's), masked to -1e30 off the live keys (the last column, the
    self term, always live), one float32 softmax, the probabilities
    rounded to ``out_dtype``, their product with V summed in float32.
    Returns (B, 1, H, D) in ``out_dtype``; a pos = -1 lane gives exactly
    its v_new row. ``flash_decode_hd_attend_plain.calls`` counts calls."""
    _build.bump(flash_decode_hd_attend_plain, "calls")
    b, h, t1 = sc.shape
    kvh, ps, d = v_pages.shape[2], v_pages.shape[1], v_pages.shape[3]
    t = t1 - 1
    live = torch.cat([_live_keys(pos, win, ks, t),
                      torch.ones((b, 1), dtype=torch.bool,
                                 device=sc.device)], -1)[:, None]
    s = torch.where(live, sc * scale, torch.full_like(sc, NEG_INF))
    p = torch.softmax(s, dim=-1).to(out_dtype).float()
    vg = v_pages[phys.long()].reshape(b, t, kvh, d)
    v_all = torch.cat([vg, v_new.to(vg.dtype)], 1).float()
    out = torch.einsum("bkgt,btkd->bkgd", p.reshape(b, kvh, h // kvh, t1),
                       v_all)
    return out.reshape(b, 1, h, d).to(out_dtype)


flash_decode_hd_attend_plain.calls = 0


#: Streaming multiprocessors of the H100: the head_dim kernels' grids
#: are sized by them (:func:`hd_plan`).
SMS = 132

#: Bytes of one page's slice of a block's kv heads in the head_dim
#: kernels' shared memory, where the pages land by cp.async.
HD_SLICE_BYTES = 24 * 1024

#: Threads of a block of kernels B2s and B2a.
HD_THREADS = 256


class HdPlan(NamedTuple):
    """How kernels B2s and B2a cut one launch (:func:`hd_plan`)."""
    kv_heads: int    # kv heads a B2s block and a B2a cluster take
    groups: int      # kv-head groups: grid z of both kernels
    pages: int       # pages a B2s block
    blocks: int      # B2s blocks a slot and group: ceil(np / pages)
    cluster: int     # B2a CTAs a cluster, one cluster a slot and group


def hd_plan(b: int, kvh: int, d: int, ps: int, np_: int,
            elsize: int) -> HdPlan:
    """The head_dim kernels' launch over ``b`` slots x ``kvh`` kv heads x
    ``np_`` pages of ``ps`` tokens, a rank's head_dim slice ``d`` of
    ``elsize``-byte elements: a function of these shapes alone (no
    position is read on the host).

    A row slice is ``ceil(d * elsize / 16)`` 16-byte chunks. A group takes
    as many kv heads as keep one page's slice within
    :data:`HD_SLICE_BYTES` and B2a's value columns (kv heads x chunks)
    within its :data:`HD_THREADS` threads, spread evenly over the groups.
    B2s cuts each slot's table into ``blocks`` ranges of ``pages`` pages,
    about two blocks an SM (the card holds them all at once; one block an
    SM was slower at gemma3-4b's slice, PERF.md). B2a gives each (slot,
    group) a cluster of ``cluster`` CTAs, one wave over the :data:`SMS`
    SMs (at most :data:`MAX_SPLITS`, at most one a page). qwen1.5-4b's
    (1, 8) slice (8 slots, 20 kv heads, 16 dims of bf16, 32 pages) takes
    one group, 32 B2s blocks of one page a slot and clusters of 16: 256
    and 128 blocks."""
    nch = -(-d * elsize // 16)
    cap = max(1, min(kvh, HD_THREADS // nch,
                     HD_SLICE_BYTES // (ps * nch * 16)))
    groups = -(-kvh // cap)
    share = max(1, SMS // (b * groups))
    blocks = min(np_, max(1, 2 * SMS // (b * groups)))
    pages = -(-np_ // blocks)
    return HdPlan(kv_heads=-(-kvh // groups), groups=groups, pages=pages,
                  blocks=-(-np_ // pages),
                  cluster=min(MAX_SPLITS, np_, share))


def _lib_hd():
    lib = _build.load("flash_decode_hd")
    fn = lib.flash_decode_hd_scores_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 6 + [_I, _P] + [_I] * 10 + [_P, _P]
        fn.restype = _I
        fn = lib.flash_decode_hd_attend_launch
        fn.argtypes = [_P] * 6 + [_I, _F, _P] + [_I] * 10 + [_P, _P]
        fn.restype = _I
    return lib


def _check_hd(who: str, pool: torch.Tensor, new: torch.Tensor,
              tensors: list, phys: torch.Tensor, pos: torch.Tensor,
              ks: torch.Tensor, b: int, h: int) -> Tuple[int, int, int]:
    """The checks both head_dim kernels share. Returns (KVH, G, D)."""
    def check(cond, msg):
        _check(cond, msg, who)
    check(all(t.device.type == "cuda" for t in tensors),
          "all tensors must be CUDA tensors")
    check(len({t.device for t in tensors}) == 1,
          "tensors lie on different devices")
    check(all(t.is_contiguous() for t in tensors),
          "tensors must be contiguous")
    check(pool.dtype in _KV_DTYPES and new.dtype == pool.dtype,
          f"the pool and the new row must share one of {list(_KV_DTYPES)}")
    check(all(t.dtype == torch.int32 for t in (phys, pos, ks)),
          "phys, pos and kv_start must be int32")
    check(pool.dim() == 4, f"a pool (P+1, page, KVH, D) expected, got "
          f"{tuple(pool.shape)}")
    kvh, d = pool.shape[2], pool.shape[3]
    check(h % kvh == 0, f"{h} query heads do not group over {kvh} kv heads")
    check(tuple(new.shape) == (b, 1, kvh, d),
          f"new row {tuple(new.shape)}, expected {(b, 1, kvh, d)}")
    check(phys.dim() == 2 and phys.shape[0] == b
          and tuple(pos.shape) == (b,) and tuple(ks.shape) == (b,),
          "phys (B, NP), pos (B,) and kv_start (B,) expected")
    check(1 <= b <= 65535 and h <= 65535, f"B={b}, H={h} out of range")
    check(1 <= h // kvh <= 8 and 1 <= d <= 256,
          f"G={h // kvh} or D={d} out of range (G <= 8, D <= 256)")
    return kvh, h // kvh, d


def _hd_launch(who: str, fn, args: list, info=None) -> None:
    err = fn(*args, info)
    if err != 0:
        raise RuntimeError(
            f"{who}: launch failed with cudaError {err} (9: no thread block "
            "cluster of this launch fits the card)")


def flash_decode_hd_scores_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                                k_new: torch.Tensor, phys: torch.Tensor,
                                pos: torch.Tensor, win: int,
                                ks: torch.Tensor, *,
                                pages: Optional[int] = None
                                ) -> torch.Tensor:
    """Kernel B2s: the same contract as
    :func:`flash_decode_hd_scores_plain`, on the card. q float32 or
    bfloat16; pages and k_new float32 or bfloat16 (one type); phys, pos,
    ks int32; all contiguous CUDA tensors on one device; the slot's q
    (H x D floats) within 48 KB; G <= 8, D <= 256. ``pages``: pages a
    block (default :func:`hd_plan`'s). ``flash_decode_hd_scores_cuda.
    launches`` counts launches."""
    who = "flash_decode_hd_scores_cuda"
    _check(q.dim() == 4 and q.shape[1] == 1 and q.dtype in _KV_DTYPES,
           f"q (B, 1, H, D) float32 or bfloat16 expected, got "
           f"{tuple(q.shape)} {q.dtype}", who)
    b, _, h, d = q.shape
    kvh, g, dk = _check_hd(who, k_pages, k_new,
                           [q, k_pages, k_new, phys, pos, ks], phys, pos,
                           ks, b, h)
    _check(dk == d, f"pool head_dim {dk} != q's {d}", who)
    _check(h * d * 4 <= 48 * 1024, f"H x D = {h * d} floats exceed 48 KB",
           who)
    ps, np_ = k_pages.shape[1], phys.shape[1]
    plan = hd_plan(b, kvh, d, ps, np_, k_pages.element_size())
    sc = torch.empty((b, h, np_ * ps + 1), dtype=torch.float32,
                     device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _hd_launch(who, _lib_hd().flash_decode_hd_scores_launch, [
            q.data_ptr(), k_pages.data_ptr(), k_new.data_ptr(),
            phys.data_ptr(), pos.data_ptr(), ks.data_ptr(), int(win),
            sc.data_ptr(), b, kvh, g, d, ps, np_, plan.kv_heads,
            pages or plan.pages, _KV_DTYPES[k_pages.dtype],
            _KV_DTYPES[q.dtype], stream])
    _build.bump(flash_decode_hd_scores_cuda, "launches")
    return sc


flash_decode_hd_scores_cuda.launches = 0


def flash_decode_hd_attend_cuda(sc: torch.Tensor, v_pages: torch.Tensor,
                                v_new: torch.Tensor, phys: torch.Tensor,
                                pos: torch.Tensor, win: int,
                                ks: torch.Tensor, scale: float,
                                out_dtype: torch.dtype, *,
                                cluster: Optional[int] = None
                                ) -> torch.Tensor:
    """Kernel B2a: the same contract as
    :func:`flash_decode_hd_attend_plain`, on the card. sc float32 (B, H,
    NP*page + 1); pages and v_new float32 or bfloat16 (one type);
    ``out_dtype`` float32 or bfloat16; G <= 8, D <= 256. ``cluster``: CTAs
    a cluster, at most :data:`MAX_SPLITS` (default :func:`hd_plan`'s).
    ``flash_decode_hd_attend_cuda.launches`` counts launches."""
    who = "flash_decode_hd_attend_cuda"
    _check(sc.dim() == 3 and sc.dtype == torch.float32,
           f"sc (B, H, T + 1) float32 expected, got {tuple(sc.shape)} "
           f"{sc.dtype}", who)
    _check(out_dtype in _KV_DTYPES, f"out_dtype must be one of "
           f"{list(_KV_DTYPES)}", who)
    b, h, t1 = sc.shape
    kvh, g, d = _check_hd(who, v_pages, v_new,
                          [sc, v_pages, v_new, phys, pos, ks], phys, pos, ks,
                          b, h)
    ps, np_ = v_pages.shape[1], phys.shape[1]
    _check(t1 == np_ * ps + 1, f"sc has {t1} columns, the table "
           f"{np_ * ps} keys + 1", who)
    plan = hd_plan(b, kvh, d, ps, np_, v_pages.element_size())
    cs = cluster or plan.cluster
    _check(1 <= cs <= MAX_SPLITS, f"a cluster of {cs} CTAs: at most "
           f"MAX_SPLITS = {MAX_SPLITS}", who)
    out = torch.empty((b, 1, h, d), dtype=out_dtype, device=sc.device)
    with torch.cuda.device(sc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _hd_launch(who, _lib_hd().flash_decode_hd_attend_launch, [
            sc.data_ptr(), v_pages.data_ptr(), v_new.data_ptr(),
            phys.data_ptr(), pos.data_ptr(), ks.data_ptr(), int(win),
            float(scale), out.data_ptr(), b, kvh, g, d, ps, np_,
            plan.kv_heads, cs, _KV_DTYPES[v_pages.dtype],
            _KV_DTYPES[out_dtype], stream])
    _build.bump(flash_decode_hd_attend_cuda, "launches")
    return out


flash_decode_hd_attend_cuda.launches = 0


def hd_geometry(q: torch.Tensor, pool: torch.Tensor,
                phys: torch.Tensor) -> dict:
    """The launches that :func:`flash_decode_hd_scores_cuda` and
    :func:`flash_decode_hd_attend_cuda` make for a rank's q slice (B, 1,
    H, D) over ``pool`` (P+1, page, KVH, D) and ``phys`` (B, NP), without
    making them: for each (``"b2s"``, ``"b2a"``) its cluster size, the
    clusters of its grid, how many of them the card holds at once, a
    block's shared memory bytes and registers a thread; and the plan
    (``"plan"``). Builds the kernels."""
    b, _, h, d = q.shape
    kvh, ps, np_ = pool.shape[2], pool.shape[1], phys.shape[1]
    plan = hd_plan(b, kvh, d, ps, np_, pool.element_size())
    dt, qt = _KV_DTYPES[pool.dtype], _KV_DTYPES[q.dtype]
    lib = _lib_hd()
    shape = [b, kvh, h // kvh, d, ps, np_, plan.kv_heads]
    out = {"plan": plan._asdict()}
    for key, fn, args in (
            ("b2s", lib.flash_decode_hd_scores_launch,
             [None] * 6 + [0, None] + shape + [plan.pages, dt, qt, None]),
            ("b2a", lib.flash_decode_hd_attend_launch,
             [None] * 6 + [0, 1.0, None] + shape
             + [plan.cluster, dt, qt, None])):
        info = (ctypes.c_int * 5)()
        with torch.cuda.device(q.device):
            _hd_launch("hd_geometry", fn, args, info)
        out[key] = dict(zip(("cluster", "clusters", "resident", "smem",
                             "registers"), info))
    return out


def flash_decode_hd_scores(q: torch.Tensor, k_pages: torch.Tensor,
                           k_new: torch.Tensor, phys: torch.Tensor,
                           positions, *, window: int = 0,
                           kv_start=0) -> torch.Tensor:
    """A rank's partial decode scores under the head_dim layout: q (B, 1,
    H, D) its head_dim slice, k_pages (P+1, page, KVH, D) one layer of its
    pool, k_new (B, 1, KVH, D) the fresh row's slice (in the pool's type),
    phys (B, NP) trash-redirected; positions and kv_start as
    :func:`flash_decode_paged` takes them. Returns (B, H, NP*page + 1)
    float32, to be all-reduced over the ranks. For CUDA tensors kernel
    B2s; for CPU tensors its plain version; meta tensors as
    ``kernels.ops``' entry points take them (under an OpCost only)."""
    b, _, h, _ = q.shape
    t1 = phys.shape[1] * k_pages.shape[1] + 1
    with kernel_call("b2s", q.device,
                     lambda: _work.flash_decode_hd_scores(q, k_pages, phys)):
        if q.is_meta:
            return meta_result((b, h, t1), torch.float32)
        pos, ks = _lanes(positions, kv_start, b, q.device)
        fn = (flash_decode_hd_scores_plain if q.device.type == "cpu"
              else flash_decode_hd_scores_cuda)
        return fn(q.contiguous(), k_pages, k_new.contiguous(),
                  phys.to(torch.int32).contiguous(), pos, window, ks)


def flash_decode_hd_attend(sc: torch.Tensor, v_pages: torch.Tensor,
                           v_new: torch.Tensor, phys: torch.Tensor,
                           positions, scale: float, out_dtype: torch.dtype,
                           *, window: int = 0, kv_start=0) -> torch.Tensor:
    """The rest of the head_dim layout's decode on the summed scores
    ``sc`` (:func:`flash_decode_hd_scores`, all-reduced): v_pages and
    v_new the rank's V slices, ``scale`` the whole head_dim's D^-0.5.
    Returns (B, 1, H, D) in ``out_dtype``. For CUDA tensors kernel B2a;
    for CPU tensors its plain version; meta as
    :func:`flash_decode_hd_scores`."""
    b, h, _ = sc.shape
    d = v_pages.shape[-1]
    with kernel_call("b2a", sc.device,
                     lambda: _work.flash_decode_hd_attend(sc, v_pages, phys,
                                                          out_dtype)):
        if sc.is_meta:
            return meta_result((b, 1, h, d), out_dtype)
        pos, ks = _lanes(positions, kv_start, b, sc.device)
        fn = (flash_decode_hd_attend_plain if sc.device.type == "cpu"
              else flash_decode_hd_attend_cuda)
        return fn(sc.contiguous(), v_pages, v_new.contiguous(),
                  phys.to(torch.int32).contiguous(), pos, window, ks, scale,
                  out_dtype)
