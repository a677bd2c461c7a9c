"""PyTorch + CUDA port of the SPA-GCN / SimGNN scoring system (`repro`).

The JAX package `repro` is the reference; this package mirrors its layout
and names module for module (each docstring names its counterpart) and is
held against it by `tests/test_torch_*.py`. The Pallas TPU megakernels on
the pair-scoring path are hand-written CUDA kernels here (`csrc/`), built
with `nvcc` at first use (`kernels/build.py`).

This package imports `torch` and `numpy` only — never `jax` and nothing of
`repro` (pinned by `tests/test_torch_imports.py`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
