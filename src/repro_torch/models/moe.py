"""Mixture-of-Experts FFN with top-k routing and optional shared experts
(port of ``repro.models.moe``).

Dispatch is the capacity-slotted formulation of the reference (Switch
style): each (token, choice) pair gets a slot in its expert's capacity
buffer from a cumulative one-hot count in (token, choice) order, and
pairs past the capacity are dropped. The expert projections carry
per-expert codebooks and LUTs (``z (E, nc, c, v)``, ``lut (E, nc, c,
N)``, ``lut_scale (E, N)``) and run in ``lut_infer`` as ONE grouped
kernel call per projection for all experts (``kernels.ops`` with a
leading expert axis: B1 fused, or B3 then B4), where the JAX package
vmaps its Pallas kernels over the experts. The routed experts' calls
also take each buffer's live rows (the pairs the router kept there, a
device vector straight from ``route``), so the kernels work on those
rows only and write the empty rows as zeros, which is what the
dispatch's zero rows would give the combine anyway: nothing reads an
empty row with a nonzero weight.

The router product is a plain matmul outside any kernel, as the JAX
package leaves it to XLA. In ``lut_train`` each expert's rows go to that
expert's centroids through the straight-through estimator (one call for
all experts), with the forward value ``Â·W``, the backward path ``A·W``
and the two-sided reconstruction loss of ``core.lut``, in plain PyTorch.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.lut import (QuantConfig, row_parallel_train, build_lut,
                                  precompute_layer, recon_terms,
                                  strip_for_inference)
from repro_torch.core.similarity import one_hot, ste_quantize_subspaces
from repro_torch.kernels import ops as kops
from repro_torch.parallel.collectives import current as tp_current
from .layers import rms_norm

Params = Dict[str, torch.Tensor]


def init_expert_proj(gen: torch.Generator, e: int, k: int, n: int,
                     qc: QuantConfig, dtype, device) -> Params:
    """E (K, N) expert projections from ``gen``, with per-expert
    centroids in LUT modes. In lut_infer the tables are built and the
    dense weight dropped right away (one projection's float32 table at a
    time), as ``Model`` does for a dense projection."""
    w = torch.randn((e, k, n), generator=gen, device=device)
    p = {"w": ((1.0 / k ** 0.5) * w).to(dtype)}
    del w
    if qc.is_lut:
        z = torch.randn((e, k // qc.v, qc.c, qc.v), generator=gen,
                        device=device)
        p["z"] = (0.02 * z).to(dtype)
    if qc.mode == "lut_infer":
        p = strip_for_inference(precompute_layer(p, qc))
    return p


def expert_proj(p: Params, x: torch.Tensor, qc: QuantConfig,
                recon: Optional[List[torch.Tensor]] = None,
                counts: Optional[torch.Tensor] = None,
                most_live: Optional[int] = None) -> torch.Tensor:
    """Batched per-expert projection: x (E, Cap, K) capacity-slotted
    expert buffers -> (E, Cap, N) in x's dtype.

    ``counts`` (E,) int64 on x's device and ``most_live``: the buffers'
    live rows and their bound (``kernels.ops``); in lut_infer the rows
    past an expert's count come out zero and cost the kernels nothing.
    Other modes compute every row (an empty row of zeros gives zeros).

    p: {"w": (E, K, N)} and, in LUT modes, "z" (E, nc, c, v); in
    lut_infer also "lut" (E, nc, c, N) and, for int8, "lut_scale" (E, N).
    In lut_infer every expert goes through one kernel call (``qc.fuse``:
    B1; else B3 then B4), on the card one launch for all experts. In
    lut_train the recon term (over all experts) joins ``recon``; the
    task gradient never reaches the centroids here, whatever
    ``task_grad_to_centroids`` says, as in the JAX package. Under tensor
    parallelism the experts (or the shared experts' columns) are the
    rank's and the recon term its share (``core.lut.recon_terms``).
    """
    if qc.mode == "dense" or "z" not in p:
        return torch.bmm(x, p["w"])
    e, cap, k = x.shape
    xs = x.reshape(e, cap, k // qc.v, qc.v)
    z = p["z"]
    if qc.mode == "lut_train":
        if recon is None:
            raise ValueError("lut_train projections need a recon list")
        x_hat = ste_quantize_subspaces(xs, z, qc.metric)
        out_q = torch.bmm(x_hat.reshape(e, cap, k).to(x.dtype), p["w"])
        out_d = torch.bmm(x, p["w"])
        recon.append(recon_terms(out_q, out_d))
        return out_d + (out_q - out_d).detach()
    return _expert_accumulate(p, x, qc, p.get("lut_scale"), counts,
                              most_live).to(x.dtype)


def _expert_accumulate(p: Params, x: torch.Tensor, qc: QuantConfig,
                       scale: Optional[torch.Tensor],
                       counts: Optional[torch.Tensor] = None,
                       most_live: Optional[int] = None) -> torch.Tensor:
    """The lut_infer product of every expert, x (E, Cap, K) -> (E, Cap,
    N) float32: one grouped call of B1 (or B3 then B4), times ``scale``
    (E, N) when given, on the live rows of ``counts`` when given."""
    e, cap, k = x.shape
    xs = x.reshape(e, cap, k // qc.v, qc.v).contiguous()
    z = p["z"]
    lut = p.get("lut")
    if lut is None:                    # on-the-fly (testing convenience)
        lut = build_lut(p["w"], z)
    live = dict(counts=counts, most_live=most_live)
    if qc.fuse:
        return kops.vq_amm(xs, z, lut, scale, qc.metric, **live)
    return kops.lut_matmul(kops.vq_assign(xs, z, qc.metric, **live), lut,
                           scale, **live)


def expert_proj_row(p: Params, x: torch.Tensor, qc: QuantConfig,
                    recon: Optional[List[torch.Tensor]] = None
                    ) -> torch.Tensor:
    """:func:`expert_proj` of a row-parallel expert shard (the shared
    experts' ``wd`` under tensor parallelism): x (E, Cap, K / ranks) the
    rank's input features, ``p`` its rows / subspaces. The partial sums
    (int8 LUTs: without the scale, exact integers) are all-reduced, then
    ``lut_scale`` (E, N) applies once, as the kernel's epilogue does: bit
    for bit the one-device projection on int8 LUTs (``core.lut.
    lut_linear_row``). In lut_train ``z`` holds the rank's subspaces and
    the two partial products are all-reduced together, as
    ``core.lut.lut_linear_row`` does (the task gradient does not reach
    the centroids, as in :func:`expert_proj`). One device:
    :func:`expert_proj` (``recon`` as there)."""
    tp = tp_current()
    if tp.size == 1:
        return expert_proj(p, x, qc, recon)
    if qc.mode == "lut_train" and "z" in p:
        return row_parallel_train(
            p, x, qc.replace(task_grad_to_centroids=False), recon, tp,
            torch.bmm)
    if qc.mode == "dense" or "z" not in p:
        part = torch.bmm(x, p["w"]).float()
    else:
        part = _expert_accumulate(p, x, qc, None)
    out = tp.all_reduce(part)
    if "lut_scale" in p:
        out = out * p["lut_scale"][:, None, :]
    return out.to(x.dtype)


def init_moe(gen: torch.Generator, cfg, qc: QuantConfig, dtype,
             device) -> Params:
    """One MoE layer: router (D, E), routed experts wg / wu (E, D, F) and
    wd (E, F, D), the pre-norm, and shared experts when the config has
    them."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    router = torch.randn((d, e), generator=gen, device=device)
    p = {
        "router": ((1.0 / d ** 0.5) * router).to(dtype),
        "wg": init_expert_proj(gen, e, d, f, qc, dtype, device),
        "wu": init_expert_proj(gen, e, d, f, qc, dtype, device),
        "wd": init_expert_proj(gen, e, f, d, qc, dtype, device),
        "norm": torch.zeros((d,), dtype=dtype, device=device),
    }
    if cfg.num_shared_experts:
        se = cfg.num_shared_experts
        p["shared_wg"] = init_expert_proj(gen, se, d, f, qc, dtype, device)
        p["shared_wu"] = init_expert_proj(gen, se, d, f, qc, dtype, device)
        p["shared_wd"] = init_expert_proj(gen, se, f, d, qc, dtype, device)
    return p


def route(probs: torch.Tensor, k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                     torch.Tensor, torch.Tensor]:
    """Top-k routing with capacity slots, the reference's rule.

    probs (T, E) float32 router probabilities. Returns, for the T*k
    (token, choice) pairs in that order: expert id, slot in the expert's
    buffer, whether the pair is kept (slot < cap), and its renormalised
    gate; then the pairs each expert received, (E,) int64 (the last row
    of the running count, a view: no op of its own). Clamped to ``cap``
    it is each buffer's live rows, the kept pairs, which fill the
    buffer's first slots. The top-k is a stable descending sort, so ties
    take the lowest expert index first, as ``jax.lax.top_k`` does.
    """
    e = probs.shape[-1]
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    eid = gate_idx.reshape(-1)
    counts = torch.cumsum(one_hot(eid, e), dim=0)            # (T*k, E)
    slot = counts.gather(1, eid[:, None])[:, 0] - 1
    return eid, slot, slot < cap, gate_vals.reshape(-1), counts[-1]


def moe_ffn(p: Params, x: torch.Tensor, cfg, qc: QuantConfig,
            recon: Optional[List[torch.Tensor]] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE. x (B, S, D) -> (out (B, S, D), aux), aux the
    load-balancing loss E * sum_e f_e * p_e (float32 scalar).

    Every row of x is a token here, the pad rows of a prefill chunk
    included (they count in T, and so in the capacity), as in the
    reference. Only kept pairs are scattered into the (E, Cap, D)
    buffers; each kept pair has its own slot, so no sum is needed (the
    reference adds zeros for dropped pairs, which gives the same
    buffers). A dropped pair combines with a zero gate, as in the
    reference. The routed experts' projections take each buffer's live
    rows (``route``'s counts, a device vector, no host read) and the
    bound T x k on them, and work on those rows only; the combine reads
    kept pairs' rows, and a dropped pair's row cap - 1 of a full buffer,
    all live. ``recon``: lut_train, the list the expert projections'
    recon terms join.

    Under tensor parallelism the routing is replicated (every rank
    computes the same dispatch), the routed experts are sharded over the
    ranks (expert parallelism: rank r runs the grouped kernel over its
    E / ranks experts' buffers), and their outputs are all-gathered in
    expert order before the combine, so the combine sums each token's
    choices in the one-device order. The shared experts are
    tensor-parallel (wg / wu column-, wd row-parallel).

    Under data parallelism (the sharded train step: each data group holds
    its rows of the global batch) the routing is the global batch's, as
    in the reference, whose one program sees the whole batch: T, the
    capacity, each pair's slot (a count over the global token order) and
    ``aux`` all come from it. The normalised tokens are all-gathered over
    the data axes in batch order, every data group routes and runs the
    experts over all of them, and keeps its own rows of the output; so
    ``aux`` and the experts' recon terms are the global batch's in every
    data group (the train step averages the data groups' losses, so each
    enters once).
    """
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    dp = tp_current().data
    if dp.size > 1:                   # the global batch's tokens
        xn = dp.all_gather(xn, 0)
    tokens = xn.reshape(-1, d)
    t = tokens.shape[0]

    logits = (tokens @ p["router"].to(tokens.dtype)).float()
    probs = torch.softmax(logits, dim=-1)                     # (T, E)
    # capacity: cf * T * k / E, floored at 8 and capped at T
    cap = min(t, max(int(cfg.capacity_factor * t * k / e), 8))
    eid, slot, keep, gates, load = route(probs, k, cap)

    onehot_any = one_hot(eid.reshape(t, k), e).sum(1).float()  # (T, E)
    ce = onehot_any.mean(0) / k
    aux = e * torch.sum(probs.mean(0) * ce)

    # dispatch: kept pairs into rows eid * cap + slot of an (E*cap + 1, D)
    # buffer; dropped pairs into its last row, which no expert reads
    dest = torch.where(keep, eid * cap + slot,
                       torch.full_like(eid, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=tokens.dtype, device=x.device)
    buf[dest] = tokens.repeat_interleave(k, dim=0)
    buf = buf[:e * cap].view(e, cap, d)

    tp = tp_current()
    if tp.size > 1:                   # this rank's experts' buffers
        el = e // tp.size
        buf = buf[tp.rank * el:(tp.rank + 1) * el]
        load = load[tp.rank * el:(tp.rank + 1) * el]
    live = dict(counts=load, most_live=t * k)
    g = expert_proj(p["wg"], buf, qc, recon, **live)
    u = expert_proj(p["wu"], buf, qc, recon, **live)
    y = expert_proj(p["wd"], F.silu(g) * u, qc, recon,
                    **live)                                   # (E, Cap, D)
    y = tp.all_gather(y, 0)

    # combine: each pair's row (a dropped pair reads slot cap - 1 with a
    # zero gate), weighted, summed over its k choices
    src = eid * cap + torch.where(keep, slot, torch.full_like(slot,
                                                              cap - 1))
    w = (gates * keep).to(y.dtype)
    out = (y.reshape(e * cap, d)[src] * w[:, None]).reshape(t, k, d).sum(1)

    if "shared_wg" in p:              # always-on shared experts, summed
        xin = tokens[None].expand(cfg.num_shared_experts, t, d).contiguous()
        sg = expert_proj(p["shared_wg"], xin, qc, recon)
        su = expert_proj(p["shared_wu"], xin, qc, recon)
        out = out + expert_proj_row(p["shared_wd"], F.silu(sg) * su, qc,
                                    recon).sum(0)
    out = out.reshape(-1, s, d)
    if dp.size > 1:                   # this data group's rows
        out = out[dp.rank * b:(dp.rank + 1) * b]
    return out, aux
