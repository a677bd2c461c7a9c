"""Parameter trees between numpy and PyTorch (no JAX counterpart module).

SimGNN parameters keep the JAX tree layout of `repro.core.simgnn.
init_simgnn_params` — `{"gcn": [{"w", "b"}, ...], "att": {"w"},
"ntn": {"w", "v", "b"}, "fcn": [{"w", "b"}, ...]}` — as a dict of tensors,
so the port's public functions take the same trees the JAX package does.
`jax.random` and `torch.Generator` draw different numbers from one seed, so
parity tests convert the JAX package's params with `params_from_numpy`
instead of re-initializing.

`adamw_state_from_numpy` / `adamw_state_to_numpy` move an AdamW state
(step, m, v; the JAX package's `AdamWState` as numpy arrays) the same way,
so an optimizer step can be held against the JAX package's.

bfloat16 leaves stay bfloat16 both ways. numpy has no native bfloat16; the
JAX stack hands them over as `ml_dtypes.bfloat16` arrays, which are moved
bit for bit through a 16-bit integer view.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree):
    """Apply `fn` to every leaf of a nested dict/list/tuple (or named
    tuple) tree, keeping its structure and key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):    # NamedTuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree) -> list:
    """Leaves in the order `tree_map` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out


def _leaf_to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)                 # a writable host copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # only needed to hand bf16 back to numpy callers

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree, device="cpu"):
    """numpy (or array-like) tree -> the same tree of tensors on `device`;
    leaf order, shapes and dtypes are preserved."""
    return tree_map(lambda a: _leaf_to_tensor(a, device), tree)


def params_to_numpy(params):
    """Tensor tree -> numpy tree (host copies), the inverse of
    `params_from_numpy`."""
    return tree_map(_leaf_to_numpy, params)


def params_to(params, device=None, dtype: torch.dtype | None = None):
    """Move (and optionally cast) every leaf; a no-op for leaves already
    there."""
    return tree_map(lambda t: t.to(device=device, dtype=dtype), params)


def adamw_state_from_numpy(state, device="cpu"):
    """An AdamW state with `step`, `m` and `v` fields of numpy (or
    array-like) leaves -> the port's `train.optimizer.AdamWState` on
    `device` (step a scalar int32 tensor)."""
    from repro_torch.train.optimizer import AdamWState

    return AdamWState(step=torch.tensor(int(np.asarray(state.step)),
                                        dtype=torch.int32, device=device),
                      m=params_from_numpy(state.m, device),
                      v=params_from_numpy(state.v, device))


def adamw_state_to_numpy(state):
    """The port's AdamWState -> (step, m, v) as numpy: an int32 scalar
    array and two numpy trees (the JAX state's fields, in order)."""
    return (np.asarray(int(state.step), np.int32),
            params_to_numpy(state.m), params_to_numpy(state.v))
