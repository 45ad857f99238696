"""Mamba2 block: the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060); port of ``repro.models.mamba2``, function for
function.

Prefill runs the chunked block decomposition: an intra-chunk quadratic
term plus an inter-chunk linear state recurrence (a loop over chunks, as
the JAX package's ``lax.scan``). Decode is the O(1)-per-token recurrent
update of a (B, H, P, N) float32 state.

The projections (``in_proj``, ``out_proj``) are LutLinear, so in
``lut_infer`` they run kernel B1 (or B3 then B4 with ``fuse=False``) on
the card; in ``lut_train`` their recon terms join the ``recon`` list.
The scan, the causal conv and the recurrent update are plain torch ops
there too: the JAX package computes them in XLA, not in a Pallas
kernel.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.lut import (QuantConfig, lut_linear_init,
                                  lut_linear_row, precompute_layer,
                                  strip_for_inference)
from repro_torch.parallel.collectives import current as tp_current
from .layers import proj, rms_norm, rms_norm_sharded

Params = Dict


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., l) -> (..., l, l): S[i, j] = sum_{j < k <= i} x[k], -inf
    above the diagonal. exp(segsum) is the decay matrix L."""
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    l = x.shape[-1]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.full_like(seg, -torch.inf))


def init_mamba2(gen: torch.Generator, cfg, qc: QuantConfig, dtype,
                device) -> Params:
    """One Mamba2 block from ``gen``. In lut_infer each projection's LUT is
    built and its dense weight dropped right away, as ``Model`` does for
    an attention projection."""
    d, din = cfg.d_model, cfg.d_inner
    n, g, h = cfg.ssm_state, cfg.ssm_ngroups, cfg.ssm_nheads
    conv_dim = din + 2 * g * n

    def projection(k, m):
        p = lut_linear_init(gen, k, m, qc, dtype=dtype, device=device)
        if qc.mode == "lut_infer":
            p = strip_for_inference(precompute_layer(p, qc))
        return p

    def vec(t):
        return t.to(device=device, dtype=dtype)
    conv_w = torch.randn((cfg.ssm_conv, conv_dim), generator=gen,
                         device=device)
    return {
        "norm": torch.zeros((d,), dtype=dtype, device=device),
        "in_proj": projection(d, 2 * din + 2 * g * n + h),
        "conv_w": (0.1 * conv_w).to(dtype),
        "conv_b": torch.zeros((conv_dim,), dtype=dtype, device=device),
        # softplus^-1 of dt in [1e-3, 0.1]
        "dt_bias": vec(torch.log(torch.exp(torch.linspace(1e-3, 0.1, h))
                                 - 1.0)),
        "A_log": vec(torch.log(torch.linspace(1.0, 16.0, h))),
        "D": torch.ones((h,), dtype=dtype, device=device),
        "gate_norm": torch.zeros((din,), dtype=dtype, device=device),
        "out_proj": projection(din, d),
    }


def _split_in_proj(zxbcdt: torch.Tensor, cfg, tp_size: int = 1):
    """z | xBC | dt of the fused in_proj output; under tensor parallelism
    (``tp_size`` ranks) the rank's columns, laid out z_r | x_r | B | C |
    dt_r (``parallel.sharding.mamba_columns``)."""
    din = cfg.d_inner // tp_size
    gn = cfg.ssm_ngroups * cfg.ssm_state
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + din + 2 * gn]
    dt = zxbcdt[..., din + din + 2 * gn:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None,
                 valid_len: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. xbc (B, S, C), w (K, C).

    state (B, K-1, C) carries the trailing inputs for decode continuity.
    valid_len: when the tail of xbc is right-padding (a prefill chunk),
    the carried state is the trailing K-1 *real* inputs, the window ending
    at position valid_len, not at S.
    Returns (out (B, S, C), new_state (B, K-1, C))."""
    kk = w.shape[0]
    s = xbc.shape[1]
    if state is None:
        state = torch.zeros((xbc.shape[0], kk - 1, xbc.shape[-1]),
                            dtype=xbc.dtype, device=xbc.device)
    xpad = torch.cat([state, xbc], dim=1)                      # (B, S+K-1, C)
    out = sum(xpad[:, i:i + s, :] * w[i][None, None] for i in range(kk))
    if kk <= 1:
        new_state = state
    elif valid_len is None:
        new_state = xpad[:, -(kk - 1):, :]
    else:
        # real inputs occupy xpad[:, :valid_len + kk - 1]; keep its tail
        new_state = xpad[:, valid_len:valid_len + kk - 1, :]
    return F.silu(out + b[None, None]), new_state


def ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, chunk: int = 128,
                h0: Optional[torch.Tensor] = None):
    """Chunked SSD scan.

    x    (B, S, H, P)   inputs per head
    dt   (B, S, H)      softplus-ed timestep, float32
    a_log(H,)           A = -exp(a_log)
    bmat (B, S, G, N)   input -> state projection
    cmat (B, S, G, N)   state -> output projection
    d_skip (H,)         skip connection
    h0   (B, H, P, N)   optional initial state
    Returns (y (B, S, H, P) in x's type, h_final (B, H, P, N) float32).
    The types follow the JAX package's promotions: the dt-weighted input
    and the decays are float32, the C.B scores and the state-to-output
    term are in the model's type, the inter-chunk recurrence float32.
    """
    b, s, h, p = x.shape
    g, n = bmat.shape[2], bmat.shape[3]
    rep = h // g
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
    nch = x.shape[1] // chunk
    f32 = torch.float32

    a = (-torch.exp(a_log.to(f32)))[None, None] * dt              # (B, S', H)
    xw = x * dt[..., None]                                        # float32

    def r(t):             # (B, S', ...) -> (B, nch, chunk, ...)
        return t.reshape(b, nch, chunk, *t.shape[2:])
    xc, ac = r(xw), r(a)
    bc, cc = r(bmat), r(cmat)
    if rep > 1:
        bc = torch.repeat_interleave(bc, rep, dim=3)
        cc = torch.repeat_interleave(cc, rep, dim=3)
    # (B, nch, chunk, H, N) after the repeat

    acs = torch.cumsum(ac, dim=2)                                 # (B,nch,l,H)
    # 1) intra-chunk (diagonal blocks)
    dmat = torch.exp(_segsum(torch.movedim(ac, -1, 2)))      # (B,nch,H,l,l)
    scores = torch.einsum("bclhn,bcshn->bchls", cc, bc)
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores * dmat, xc)
    # 2) chunk final states
    decay_states = torch.exp(acs[:, :, -1:, :] - acs)             # (B,nch,l,H)
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", bc.to(f32),
                          decay_states, xc)
    # 3) inter-chunk recurrence
    chunk_decay = torch.exp(acs[:, :, -1, :])                     # (B,nch,H)
    hprev = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
             if h0 is None else h0.to(f32))
    h_prevs = []
    for ci in range(nch):
        h_prevs.append(hprev)
        hprev = chunk_decay[:, ci, :, None, None] * hprev + states[:, ci]
    h_final = hprev
    h_prevs = torch.stack(h_prevs, dim=1)                    # (B,nch,H,P,N)
    # 4) state -> output within a chunk
    state_decay = torch.exp(acs)                                  # (B,nch,l,H)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", cc,
                         h_prevs.to(cc.dtype), state_decay.to(cc.dtype))
    y = (y_diag + y_off).reshape(b, nch * chunk, h, p)[:, :s]
    y = y + x[:, :s] * d_skip[None, None, :, None]
    return y.to(x.dtype), h_final


def _gated_norm(y: torch.Tensor, z: torch.Tensor, gamma: torch.Tensor,
                cfg, tp) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` over d_inner. Under tensor parallelism
    the rank's slices are all-gathered first, the norm reduces over the
    whole row, and the rank keeps its slice for the row-parallel
    ``out_proj``: bit for bit the one-device values."""
    gated = y * F.silu(z)
    if tp.size == 1:
        return rms_norm(gated, gamma, cfg.norm_eps)
    return rms_norm_sharded(tp.all_gather(gated, -1), gamma, cfg.norm_eps,
                            tp)


def mamba2_block(p: Params, x: torch.Tensor, cfg, qc: QuantConfig,
                 cache: Optional[Params] = None,
                 valid_len: Optional[int] = None,
                 recon: Optional[List[torch.Tensor]] = None
                 ) -> Tuple[torch.Tensor, Optional[Params]]:
    """The full Mamba2 block (prefill and training path). x (B, S, D).

    cache: {"conv": (B, K-1, C), "h": (B, H, P, N)}, carried for prefill
    continuity and returned updated for the next chunk or decode; None
    starts from zero state (training's whole sequences).
    valid_len: positions >= valid_len are right-padding (a prefill
    chunk). An SSM integrates every input into its state, so pads are
    made recurrence-neutral: their dt is 0 (decay exp(-A.0) = 1, input
    weight dt.x = 0, an exact no-op on h) and the conv state is taken at
    the last real token.
    recon: lut_train: the list the two projections' recon terms join
    (the JAX package returns their sum as its second output).
    Under tensor parallelism the rank runs its own heads and channels
    (plus every head's B and C): ``in_proj`` is column-parallel in the
    port's layout, the gated norm reads the all-gathered row, and
    ``out_proj`` is row-parallel. In lut_train the ``in_proj`` recon share
    counts the B and C columns, which every rank holds, on rank 0 only;
    their gradient, like every replicated entry's, is one part of a sum
    over the ranks (``train.trainer``).
    Returns (out (B, S, D), new_cache or None).
    """
    b, s, _ = x.shape
    tp = tp_current()
    h, pdim, n, g = (cfg.ssm_nheads // tp.size, cfg.ssm_headdim,
                     cfg.ssm_state, cfg.ssm_ngroups)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    din = cfg.d_inner // tp.size
    bc = (2 * din, 2 * din + 2 * g * n)       # every rank's B and C columns
    z, xbc, dt = _split_in_proj(proj(p["in_proj"], xn, qc, recon, bc), cfg,
                                tp.size)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state,
                                 valid_len=valid_len)
    xs = xbc[..., :din].reshape(b, s, h, pdim)
    bmat = xbc[..., din:din + g * n].reshape(b, s, g, n)
    cmat = xbc[..., din + g * n:].reshape(b, s, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"].float())            # (B,S,H)
    if valid_len is not None:
        live = (torch.arange(s, device=x.device) < valid_len)[None, :, None]
        dt = torch.where(live, dt, torch.zeros_like(dt))
    h0 = cache["h"] if cache is not None else None
    y, h_final = ssd_chunked(xs, dt, p["A_log"], bmat, cmat, p["D"],
                             chunk=128, h0=h0)
    y = _gated_norm(y.reshape(b, s, din), z, p["gate_norm"], cfg, tp)
    out = lut_linear_row(p["out_proj"], y, qc, recon)
    new_cache = None
    if cache is not None:
        new_cache = {"conv": new_conv, "h": h_final}
    return out, new_cache


def mamba2_decode(p: Params, x: torch.Tensor, cfg, qc: QuantConfig,
                  cache: Params) -> Tuple[torch.Tensor, Params]:
    """One recurrent step. x (B, 1, D), cache {"conv", "h"}; the update is
    float32 and its output is cast back to x's type. Returns (out, new
    cache)."""
    b = x.shape[0]
    tp = tp_current()
    h, pdim, n, g = (cfg.ssm_nheads // tp.size, cfg.ssm_headdim,
                     cfg.ssm_state, cfg.ssm_ngroups)
    f32 = torch.float32
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    z, xbc, dt = _split_in_proj(proj(p["in_proj"], xn, qc), cfg, tp.size)
    # conv over the cached window
    xpad = torch.cat([cache["conv"], xbc], dim=1)                # (B, K, C)
    kk = p["conv_w"].shape[0]
    conv_out = torch.einsum("bkc,kc->bc", xpad[:, -kk:], p["conv_w"])
    xbc1 = F.silu(conv_out + p["conv_b"])[:, None]               # (B, 1, C)
    new_conv = xpad[:, -(kk - 1):]
    din = cfg.d_inner // tp.size
    xs = xbc1[..., :din].reshape(b, h, pdim).to(f32)
    bmat = xbc1[..., din:din + g * n].reshape(b, g, n)
    cmat = xbc1[..., din + g * n:].reshape(b, g, n)
    rep = h // g
    bmat = torch.repeat_interleave(bmat, rep, dim=1).to(f32)     # (B, H, N)
    cmat = torch.repeat_interleave(cmat, rep, dim=1).to(f32)
    dt1 = F.softplus(dt.float()[:, 0] + p["dt_bias"].float())    # (B, H)
    a = torch.exp(-torch.exp(p["A_log"].float())[None] * dt1)
    hnew = (a[..., None, None] * cache["h"]
            + torch.einsum("bh,bhp,bhn->bhpn", dt1, xs, bmat))
    y = torch.einsum("bhpn,bhn->bhp", hnew, cmat)
    y = y + xs * p["D"].float()[None, :, None]
    y = _gated_norm(y.reshape(b, 1, din).to(x.dtype), z, p["gate_norm"],
                    cfg, tp)
    out = lut_linear_row(p["out_proj"], y, qc)
    return out, {"conv": new_conv, "h": hnew}
