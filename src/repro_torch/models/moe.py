"""Mixture-of-Experts FFN — port of `repro.models.moe`: top-k routing with
per-sequence capacity and gather-based dispatch into dense expert tiles.

Routing and dispatch are computed per sequence (the batch dim is the GShard
'group' dim), as in the JAX package; the JAX package vmaps one sequence's
dispatch over B, the port writes the batch dim out. Tokens over capacity
are dropped (contribute zero; the residual passes them through).

With `cfg.moe_use_kernel` the expert FFN of the whole batch, [B, E, C, D],
goes through one call of `kernels.moe_experts.moe_expert_ffn` (one kernel
launch per MoE layer on the card, float32 inside); otherwise through
einsums in the activations' dtype, as the JAX package's `else` branch. The
JAX package's mesh constraints (`rt`) only lay tensors out, and pin the
expert hidden to the `model` axis; the port's mesh step (`train/step.py`)
runs each replica on its own rows, and on a model row (`lm.tp_apply_block`)
each member routes every token with the replicated router and computes
its columns of the expert hidden (its slices of `w_in` / `w_out`), so
routing needs no constraint.

The load-balancing aux loss is a product of two batch means, so it does
not split over data-parallel replicas. Inside `route_stats()` every
`route` call also records its layer's routed fractions (detached: they
are one-hot of an argmax) and mean router probabilities, in call order;
the mesh step averages them over replicas and forms the aux term once
(`aux_from_stats`), as the JAX package's step on a mesh computes it over
the whole batch. On a model row only member 0 records (`record=False`
elsewhere) and only its aux term counts, so each layer counts once a
replica and the aux gradient reaches the router once.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch

from repro_torch.kernels.moe_experts import moe_expert_ffn
from repro_torch.models.layers import silu


def moe_capacity(seq_len: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(seq_len * top_k * capacity_factor / n_experts) + 1
    return max(top_k, min(c, seq_len))


def top_k_lowest_first(logits: torch.Tensor, k: int):
    """(values, int32 indices) of the k largest along the last dim, ties to
    the lower index — the order of `jax.lax.top_k`, which `torch.topk`
    does not promise."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


#: the aux loss's weight in `lm.lm_loss` and `encdec.encdec_loss` (and in
#: the mesh step, which forms the aux term itself)
AUX_WEIGHT = 0.01

#: the list `route_stats()` collects into, or None
_STATS: list | None = None


@contextmanager
def route_stats():
    """Collect (frac [E], mean_prob [E]) of every `route` call of the
    `with` block, in call order, into the list it yields; an enclosing
    `route_stats` gets them too when the block ends."""
    global _STATS
    before, _STATS = _STATS, []
    try:
        yield _STATS
    finally:
        if before is not None:
            before.extend(_STATS)
        _STATS = before


def aux_from_stats(per_replica: list) -> torch.Tensor:
    """The aux loss of the whole batch from each replica's `route_stats`
    lists (equal-sized replicas, at least one routed layer): per layer
    n_e * sum(mean frac * mean prob), summed over layers in order."""
    n = len(per_replica)
    terms = []
    for layer in zip(*per_replica):
        frac = sum(f for f, _ in layer) / n
        prob = sum(p for _, p in layer) / n
        terms.append(frac.shape[-1] * torch.sum(frac * prob))
    aux = terms[0]
    for term in terms[1:]:
        aux = aux + term
    return aux


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int, *,
          record: bool = True):
    """x [B,S,D] -> (weights [B,S,k], experts [B,S,k] int32, aux_loss).
    With `record` False the call adds nothing to `route_stats`."""
    logits = torch.einsum("bsd,de->bse", x.float(), router_w.float())
    weights, experts = top_k_lowest_first(logits, top_k)
    weights = torch.softmax(weights, dim=-1)              # renorm over top-k
    # Switch-style load-balancing aux loss (fraction routed x mean prob)
    n_e = router_w.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    frac = torch.nn.functional.one_hot(experts[..., 0].long(), n_e).float() \
        .mean(dim=(0, 1))
    mean_prob = probs.mean(dim=(0, 1))
    if record and _STATS is not None:
        _STATS.append((frac.detach(), mean_prob))
    aux = n_e * torch.sum(frac * mean_prob)
    return weights, experts, aux


def _dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int):
    """experts [..., S, k] -> (slot [..., S*k] int32, keep [..., S*k] bool),
    per sequence: slot is the position inside the destination expert's
    capacity buffer, in token-major order; over-capacity slots are clipped
    to capacity-1 and not kept."""
    *lead, s, k = experts.shape
    flat = experts.reshape(*lead, s * k).long()
    # one-hot laid out [..., E, S*k] so the running count per expert is a
    # scan along the innermost dim
    ids = torch.arange(n_experts, device=experts.device)[:, None]
    onehot = (flat[..., None, :] == ids).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - 1
    slot = torch.gather(pos, -2, flat[..., None, :])[..., 0, :]
    keep = slot < capacity
    return torch.clamp(slot, 0, capacity - 1), keep


def slot_token_map(experts: torch.Tensor, n_experts: int, capacity: int):
    """experts [B, S, k] -> (tok_for_slot [B, E, C] int32, slot, keep).

    The scatter-min of the JAX package (`.at[flat_e, slot].min(assign)`):
    each (expert, slot) holds the token-major assignment index that was
    kept there, or the sentinel S*k when the slot is empty. Dropped
    assignments share the clipped slot C-1 with the sentinel value, so the
    min keeps the kept one."""
    b, s, k = experts.shape
    slot, keep = _dispatch_indices(experts, n_experts, capacity)
    flat_e = experts.reshape(b, s * k).long()
    sentinel = s * k
    # (a Python scalar, not a tensor made from one: copying a host scalar
    # to the card would wait for the stream at every layer)
    assign = torch.where(
        keep, torch.arange(s * k, dtype=torch.int32, device=experts.device),
        sentinel)
    tok = torch.full((b, n_experts * capacity), sentinel, dtype=torch.int32,
                     device=experts.device)
    tok.scatter_reduce_(1, flat_e * capacity + slot.long(), assign,
                        reduce="amin", include_self=True)
    return tok.reshape(b, n_experts, capacity), slot, keep


def moe_ffn(p, x: torch.Tensor, cfg, *,
            record: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """p: {router [D,E], w_in [E,D,2F], w_out [E,F,D]}; x [B,S,D].
    Returns (y [B,S,D], aux_loss); `record` goes to `route`."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    cap = moe_capacity(s, e, k, cfg.capacity_factor)
    weights, experts, aux = route(p["router"], x, k, record=record)

    tok_for_slot, slot, keep = slot_token_map(experts, e, cap)
    # gather tokens into dense expert tiles (sentinel -> zero row)
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)          # [B,S+1,D]
    src_tok = torch.clamp(tok_for_slot // k, max=s).long()         # [B,E,C]
    bi = torch.arange(b, device=x.device)
    buf = x_pad[bi[:, None, None], src_tok]                         # [B,E,C,D]
    if cfg.moe_use_kernel:
        y_buf = moe_expert_ffn(buf, p["w_in"], p["w_out"])
    else:
        h = torch.einsum("becd,edf->becf", buf, p["w_in"])  # fused gate+up
        gate, up = h.chunk(2, dim=-1)
        y_buf = torch.einsum("becf,efd->becd", silu(gate) * up, p["w_out"])
    flat_e = experts.reshape(b, s * k).long()
    y_tok = y_buf[bi[:, None], flat_e, slot.long()]                # [B,S*k,D]
    w_tok = weights.to(x.dtype).reshape(b, s * k)
    y_tok = y_tok * (w_tok[..., None] * keep[..., None])
    return y_tok.reshape(b, s, k, d).sum(dim=2).to(x.dtype), aux
