"""Device resolution for the port's entry points, and a count of what a
call enqueues on the card."""
from __future__ import annotations

import ctypes
from typing import Callable, Dict

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    no CUDA device is present (the entry points never run a CUDA request
    on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


_NODE_KINDS = {0: "kernels", 1: "copies", 2: "memsets"}


def enqueued(fn: Callable[[], object]) -> Dict[str, int]:
    """What one call of ``fn`` enqueues on the current CUDA device, by
    kind: ``{"kernels", "copies", "memsets", "other"}``. ``fn`` runs once
    to warm up (builds kernels, caches constants), then once captured
    into a CUDA graph, whose nodes the driver lists (cuGraphGetNodes,
    cuGraphNodeGetType). Exact, and nothing stays enabled afterwards, as
    a profiler session may leave it."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    cu.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_size_t)]
    cu.cuGraphGetNodes.restype = ctypes.c_int
    cu.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.c_int)]
    cu.cuGraphNodeGetType.restype = ctypes.c_int
    handle, n = ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.c_size_t(0)
    out = {"kernels": 0, "copies": 0, "memsets": 0, "other": 0}
    try:
        if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        nodes = (ctypes.c_void_p * n.value)()
        if cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) != 0:
            raise RuntimeError("cuGraphGetNodes failed")
        for node in nodes:
            kind = ctypes.c_int(-1)
            if cu.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
                raise RuntimeError("cuGraphNodeGetType failed")
            out[_NODE_KINDS.get(kind.value, "other")] += 1
    finally:
        graph.reset()
    return out
