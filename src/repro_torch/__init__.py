"""PyTorch/CUDA port of the LUT-DLA serving stack, for NVIDIA Hopper.

The layout mirrors the JAX package ``repro`` module for module
(``core/``, ``kernels/``, ``models/``, ``serve/``, ``configs/``), so each
module here has one reference counterpart. This package imports only
``torch``, ``numpy`` and the standard library.

Device rule: a function runs where its tensors lie. CPU tensors take the
plain PyTorch version of each kernel; CUDA tensors take the hand-written
Hopper kernel (``csrc/*.cu``) or the call raises. Nothing falls back from
one to the other. Functions that create tensors take ``device="cuda"`` by
default and raise when no CUDA device is present.
"""
