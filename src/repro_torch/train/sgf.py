"""Stochastic gradient functions — port of `repro.train.sgf`: the
swappable loss -> (value, grads) transform the ScoringEngine's training
executors are built from (DESIGN.md §16).

The engine holds one gradient-function object (`engine.grad_fn`) and asks
it for the transform; `cache_key` keys the engine's executor cache. The
transform is applied per microbatch chunk, inside the chunk loop, before
the cross-chunk sum: clipping variants therefore clip each chunk.

`value_and_grad(loss_fn)` returns fn(params, *args) -> (value, grads):
the params' leaves are detached copies that require grad, the loss is
differentiated by `torch.autograd.grad`, and value and grads come back
detached, grads as a tree like params.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.params import tree_leaves, tree_map

__all__ = ["GradientFunction", "StandardGradient", "ClippedGradient",
           "global_norm"]


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a gradient tree."""
    return torch.sqrt(sum(torch.sum(torch.square(g))
                          for g in tree_leaves(tree)))


def _value_and_grad(loss_fn):
    def fn(params, *args):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            value = loss_fn(leaves, *args)
            grads = torch.autograd.grad(value, tree_leaves(leaves))
        it = iter(grads)
        return value.detach(), tree_map(lambda _: next(it), params)
    return fn


@dataclass(frozen=True)
class GradientFunction:
    """Base transform: how a scalar loss function becomes a (value, grads)
    function. Subclasses override `value_and_grad` and extend
    `cache_key`; instances stay frozen and stateless."""

    @property
    def cache_key(self) -> str:
        return "standard"

    def value_and_grad(self, loss_fn):
        """loss_fn(params, *args) -> scalar   becomes
        fn(params, *args) -> (scalar, grads-like-params)."""
        return _value_and_grad(loss_fn)


@dataclass(frozen=True)
class StandardGradient(GradientFunction):
    """Plain autograd value and gradients, the default."""


@dataclass(frozen=True)
class ClippedGradient(GradientFunction):
    """Per-microbatch global-norm clipping: grads whose L2 norm exceeds
    `clip_norm` are rescaled onto the ball."""
    clip_norm: float = 1.0

    @property
    def cache_key(self) -> str:
        return f"clip:{self.clip_norm:g}"

    def value_and_grad(self, loss_fn):
        vg = _value_and_grad(loss_fn)

        def fn(params, *args):
            v, g = vg(params, *args)
            norm = global_norm(g)
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            return v, tree_map(lambda x: x * scale, g)
        return fn
