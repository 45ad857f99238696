"""Quickstart of the PyTorch port: VQ-AMM in 60 lines — the paper's Fig 2
pipeline (twin of ``examples/quickstart.py``).

Builds a codebook over activations (k-means), precomputes the LUT, and
compares LUT-based matmul against the dense result. On a CUDA device the
three kernel entry points run the hand-written Hopper kernels (B3, B4,
B1); with ``--device cpu`` their plain PyTorch versions.

Run: PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse
import sys

import torch

from repro_torch.core.codebook import CodebookSpec, kmeans_codebook
from repro_torch.core.lut import build_lut, quantize_lut_int8
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import lut_matmul, vq_amm, vq_assign

M, K, N = 256, 512, 384
V, C = 4, 32                     # equivalent bit-width: log2(32)/4 = 1.25 bit


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(0)
    spec = CodebookSpec(v=V, c=C, metric="l2")

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # activations with VQ-friendly structure (a few latent directions + noise)
    basis = normal(4, K)
    codes = normal(M, 4)
    A = codes @ basis + 0.05 * normal(M, K)
    W = normal(K, N) / K ** 0.5

    # step 1 — cluster activations per subspace (paper step ①)
    Z = kmeans_codebook(A, K, spec, iters=15, generator=gen)
    print(f"codebook: {tuple(Z.shape)}  (subspaces×centroids×v), "
          f"equivalent bits = {spec.equivalent_bits}")

    # step 2 — precompute LUT = centroids · weights (paper step ②)
    LUT = build_lut(W, Z)
    LUT8, scale = quantize_lut_int8(LUT)
    print(f"LUT: {tuple(LUT.shape)}, int8 {LUT8.nbytes / 1e6:.2f} MB "
          f"vs bf16 weights {W.nbytes / 2 / 1e6:.2f} MB")

    # step 3 — inference: assign + lookup (paper steps ③④), two-pass
    x = A.reshape(M, K // V, V)
    idx = vq_assign(x, Z, "l2")
    out_lut = lut_matmul(idx, LUT8, scale)

    # same thing, fused: the index tensor never leaves the chip (on the
    # card one Hopper kernel; B4(B3(x)) == B1(x) bit for bit there)
    out_fused = vq_amm(x, Z, LUT8, scale, "l2")
    fused_err = float(torch.max(torch.abs(out_fused - out_lut)))
    assert fused_err < 1e-3, fused_err
    print(f"fused assign+lookup matches two-pass "
          f"(idx tensor eliminated: {idx.nbytes / 1e3:.1f} KB)")

    out_dense = A @ W
    rel = float(torch.linalg.norm(out_lut - out_dense)
                / torch.linalg.norm(out_dense))
    print(f"relative error vs dense GEMM: {rel:.4f}")

    # the compute that remains: one index per (row, subspace) + table adds
    ops_dense = 2 * M * K * N
    ops_lut = 2 * C * M * K + M * N * (K // V)
    print(f"dense ops {ops_dense / 1e6:.0f}M -> lut ops {ops_lut / 1e6:.0f}M "
          f"({ops_dense / ops_lut:.1f}x fewer)")
    # 1.25-bit AMM on random gaussians: the JAX example's bound (0.3053
    # on its seed)
    assert rel < 0.32, rel
    print("OK")
    return {"rel": rel, "fused_err": fused_err}


if __name__ == "__main__":
    main(sys.argv[1:])
