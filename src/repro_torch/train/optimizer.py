"""AdamW and a cosine schedule on parameter trees of tensors — port of
`repro.train.optimizer`.

Moments are stored in a configurable dtype (float32 by default); all
arithmetic is float32 whatever the storage dtype, and params update in
their own dtype. Trees are the nested dicts / lists of `repro_torch.params`.

A param stored as per-device blocks (`distributed.placement.
ShardedTensor`, on an LM mesh) gets moments with the same blocks, and
`adamw_update` updates it block by block on each block's device, the
gradient laid out the same way (`train.step.constrain_grads`). The update
is elementwise, so each block's bits are those of the whole update.
`global_norm` and `clip_by_global_norm` take whole gradients.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.distributed.placement import ShardedTensor
from repro_torch.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor       # scalar int32
    m: object                # tree like params
    v: object                # tree like params


def adamw_init(params, state_dtype: str = "float32") -> AdamWState:
    dt = getattr(torch, state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else "cpu"

    def zeros(p):
        if isinstance(p, ShardedTensor):
            return p.with_blocks(torch.zeros(b.shape, dtype=dt,
                                             device=b.device)
                                 for b in p.blocks)
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def cosine_schedule(step, *, peak_lr: float = 3e-4, warmup: int = 200,
                    total: int = 10_000, floor: float = 0.1):
    """lr for the step being taken (1-indexed: the first update uses
    lr = peak / warmup, not 0), as a float32 tensor."""
    s = torch.clamp(torch.as_tensor(step).float(), min=0.0) + 1.0
    warm = s / max(1, warmup)
    frac = torch.clamp((s - warmup) / max(1, total - warmup), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(
        torch.tensor(math.pi, dtype=torch.float32, device=s.device) * frac))
    return peak_lr * torch.where(s < warmup, warm, cos)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf, in float32."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _on(x, device):
    """A scalar tensor on a block's device (floats pass)."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


def adamw_update(grads, state: AdamWState, params, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1):
    """One AdamW step; float32 math, storage dtypes preserved. Returns
    (new params, new state); nothing is updated in place."""
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=t.device), t)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=t.device), t)

    def upd(p, g, m, v):
        if isinstance(p, ShardedTensor):
            outs = [upd(*blocks) for blocks in zip(p.blocks, g.blocks,
                                                   m.blocks, v.blocks)]
            return tuple(x.with_blocks(o[k] for o in outs)
                         for k, x in enumerate((p, m, v)))
        g32 = g.float()
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32 * g32
        mh = m32 / _on(bc1, p.device)
        vh = v32 / _on(bc2, p.device)
        delta = mh / (torch.sqrt(vh) + eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        if p.dim() >= 2:
            delta = delta + weight_decay * p.float()
        new_p = (p.float() - _on(lr, p.device) * delta).to(p.dtype)
        return new_p, m32.to(m.dtype), v32.to(v.dtype)

    triples = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.m),
        tree_leaves(state.v))]

    def rebuild(k):
        it = iter(t[k] for t in triples)
        return tree_map(lambda _: next(it), params)
    return rebuild(0), AdamWState(step=step, m=rebuild(1), v=rebuild(2))
