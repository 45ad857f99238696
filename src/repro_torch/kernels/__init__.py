"""Kernels B1 (fused VQ-AMM) and B2 (paged flash decode): CUDA sources in
``csrc/``, their wrappers, plain versions and the device dispatch."""
