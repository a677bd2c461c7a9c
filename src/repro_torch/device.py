"""Device policy of the port (counterpart of `repro.kernels.common.
should_interpret`, which picks Pallas interpret mode off-TPU).

Here the rule is by tensor placement, never by fallback:

  * entry points (`ScoringEngine`, `simgnn_query_server`, the `kernels.ops`
    wrappers, `pack_pairs`) take `device=None`, which means the card
    (`"cuda"`); without CUDA they raise unless the caller asked for
    `device="cpu"` explicitly — they never drop silently to the CPU;
  * a kernel wrapper launches its CUDA kernel on CUDA tensors and runs its
    plain PyTorch version only on CPU tensors (`on_cuda`), or on meta
    tensors, where it only propagates shapes and dtypes: the dry run
    (`launch/dryrun.py`) asks for `device="meta"` explicitly, as the
    tests ask for the CPU, and meta holds no data for a kernel to read.

TF32 is switched off for the whole process on import. The f32 parity bound
the port is held to (1e-6 on post-sigmoid scores, `tests/
test_parity_matrix.py`) is out of reach when float32 matmuls or
convolutions round their inputs to TF32's 10-bit mantissa, and the plain
PyTorch versions run as the card's on-device reference in `chip_smoke.py`.

bf16 matrix products (the LM's projections, router and logits) keep
float32 accumulation end to end: cuBLAS may otherwise reduce split-K
partial sums in bf16 (`allow_bf16_reduced_precision_reduction`), which
the JAX package's products (float32 accumulation, one rounding of the
output) never do.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """`None` -> the card; raises when the requested device is CUDA and no
    CUDA device exists (no silent CPU fallback)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU or all on meta; mixed placement is a caller error."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"} or kinds == {"meta"}:
        return False
    raise ValueError(f"tensors on mixed devices {sorted(kinds)}")
