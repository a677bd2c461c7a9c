"""Differentiable twins of the packed pair-score kernels — port of
`repro.kernels.grad` (DESIGN.md §11).

The JAX package cannot differentiate `pl.pallas_call`, so it composes the
packed kernels' bodies from `kernels/common.py`, whose custom VJP rules
reuse the forward's edge planes, under `jit`. The port composes the same
bodies in plain PyTorch: the packed kernels' plain versions, whose gather
and segment bodies carry those rules as `torch.autograd.Function`s. No CUDA
kernel runs here, on either device, as no Pallas kernel runs on the JAX
package's training path.

  * `packed_pair_score_grad` — the dense block-diagonal tile path (§8);
  * `sparse_pair_score_grad` — the packed-CSR edge path (§9).

Both take the `core.batching.pack_pairs` layouts the inference kernels
take and return the same `[T, P]` pair-slot scores (exact zeros at pad
slots), so one packing pass serves the forward and backward passes of
every accumulation chunk. `core.engine.ScoringEngine.loss_and_grad` is the
dispatch point.

`kernel_with_plain_backward` is the port's own: it gives the LM kernels'
wrappers (`flash_attention`, `wkv6_state`, `mamba_selective_scan_state`,
`moe_expert_ffn`) a backward on the card. Their forward stays the CUDA
kernel; their backward is autograd of the plain version, the port's
counterpart of `jax.grad` over the `jnp` code the JAX package trains with.
On a tensor-parallel model row (`distributed.tensor_parallel`) the plain
recompute runs at the member's shard shapes and on its stream: autograd
runs a backward node on the stream its forward ran on.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.packed_pair import packed_pair_score_plain
from repro_torch.kernels.sparse_pair import sparse_pair_score_plain


def _weights(params) -> tuple:
    return params["gcn"], params["att"]["w"], params["ntn"], params["fcn"]


def packed_pair_score_grad(params, adj1, labels1, mask1, seg1,
                           adj2, labels2, mask2, seg2,
                           pair_mask) -> torch.Tensor:
    """Differentiable packed-dense scorer: in-graph normalisation, the GCN
    stack with the W1 label gather, segment Att pooling, NTN/FCN. pack_pairs
    layout in, [T, P] pair-slot scores out (zero at pad slots)."""
    return packed_pair_score_plain(adj1, labels1, mask1, seg1, adj2, labels2,
                                   mask2, seg2, pair_mask, *_weights(params))


def sparse_pair_score_grad(params,
                           nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1,
                           labels1, mask1, seg1,
                           nbr2, nbr_w2, ov_snd2, ov_rcv2, ov_w2,
                           labels2, mask2, seg2,
                           pair_mask) -> torch.Tensor:
    """Differentiable packed-sparse scorer: aggregation from the packed-CSR
    edge planes (`csr_aggregate_block_sym`, whose backward aggregates the
    cotangent over the same planes). pack_pairs(with_edges=True) layout in,
    [T, P] pair-slot scores out."""
    return sparse_pair_score_plain(nbr1, nbr_w1, ov_snd1, ov_rcv1, ov_w1,
                                   labels1, mask1, seg1, nbr2, nbr_w2,
                                   ov_snd2, ov_rcv2, ov_w2, labels2, mask2,
                                   seg2, pair_mask, *_weights(params))


def packed_arrays(packed, *, sparse: bool) -> tuple:
    """Flatten a PackedPairBatch into the positional tensor tuple the
    matching `*_score_grad` function takes (`pair_mask` last)."""
    if sparse:
        e = packed.edges
        return (e.edges1.senders, e.edges1.weights,
                e.overflow1.senders, e.overflow1.receivers,
                e.overflow1.weights,
                packed.labels1, packed.mask1, packed.seg1,
                e.edges2.senders, e.edges2.weights,
                e.overflow2.senders, e.overflow2.receivers,
                e.overflow2.weights,
                packed.labels2, packed.mask2, packed.seg2,
                packed.pair_mask)
    return (packed.adj1, packed.labels1, packed.mask1, packed.seg1,
            packed.adj2, packed.labels2, packed.mask2, packed.seg2,
            packed.pair_mask)


# ------------------------------------- gradients through the LM kernels

def needs_grad(*tensors) -> bool:
    """True when autograd records and one of `tensors` (None entries
    skipped) requires grad: the case in which a CUDA kernel wrapper must
    go through `kernel_with_plain_backward`."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _KernelPlainBackward(torch.autograd.Function):
    """Forward: the kernel. Backward: autograd of the plain version,
    recomputed on the saved inputs."""

    @staticmethod
    def forward(ctx, kernel, plain, *inputs):
        ctx.set_materialize_grads(False)
        ctx.plain = plain
        ctx.slots = [i for i, x in enumerate(inputs)
                     if isinstance(x, torch.Tensor)]
        ctx.n_inputs = len(inputs)
        ctx.save_for_backward(*(inputs[i] for i in ctx.slots))
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        inputs: list = [None] * ctx.n_inputs
        leaves = []
        for i, saved in zip(ctx.slots, ctx.saved_tensors):
            x = saved.detach()
            if ctx.needs_input_grad[2 + i]:
                x.requires_grad_(True)
                leaves.append((i, x))
            inputs[i] = x
        with torch.enable_grad():
            out = ctx.plain(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        # an output whose incoming gradient is None contributes zeros
        used = [(o, g) for o, g in zip(outs, grads)
                if g is not None and o.requires_grad]
        result: list = [None] * (2 + ctx.n_inputs)
        if used and leaves:
            got = torch.autograd.grad([o for o, _ in used],
                                      [x for _, x in leaves],
                                      [g for _, g in used], allow_unused=True)
            for (i, x), g in zip(leaves, got):
                result[2 + i] = torch.zeros_like(x) if g is None else g
        return tuple(result)


def kernel_with_plain_backward(kernel, plain, *inputs):
    """`kernel(*inputs)` whose backward is autograd of `plain(*inputs)`.

    The JAX package has no backward kernel for `flash_attention`,
    `wkv6`, `mamba_selective_scan` or `moe_expert_ffn`: its training path
    differentiates `jnp` code. A pybind- or ctypes-launched CUDA kernel's
    output has no `grad_fn`, so the kernel wrappers route a call that
    autograd records through here: the forward launches the kernel (the
    launch counts once), the backward recomputes the plain version under
    `torch.enable_grad()` on detached copies of the saved inputs and
    returns `torch.autograd.grad` of that recompute. `inputs` are tensors
    or None (an absent initial state); `kernel` and `plain` take them
    positionally and return a tensor or a tuple of tensors. An output
    whose incoming gradient is None (the final states of `wkv6_state` and
    `mamba_selective_scan_state` when a loss reads only y) counts as
    zeros."""
    return _KernelPlainBackward.apply(kernel, plain, *inputs)
