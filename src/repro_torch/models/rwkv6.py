"""RWKV-6 (Finch) block — port of `repro.models.rwkv6`: time-mix with
data-dependent per-channel decay + squared-ReLU channel-mix.

The WKV recurrence (the JAX package's `wkv_scan`, which returns the final
state too) is `kernels.wkv6.wkv6_state`: on CUDA tensors one launch of the
kernel `csrc/wkv6.cu` per layer and step, on CPU tensors the plain
sequential scan. Prefill starts from a zero state (the JAX block ignores a
given state when T > 1); decode (T = 1 with the cache's state) launches
the same kernel at T = 1 where the JAX block takes an einsum fast path:
the same arithmetic.

Decode carries {"shift_t", "shift_c", "wkv"}: O(1) state per token.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.wkv6 import wkv6_state
from repro_torch.models.layers import silu


def _token_shift(x: torch.Tensor, last: torch.Tensor | None) -> torch.Tensor:
    """Returns x_{t-1} (zeros / carried state at t=0). x [B,T,D]."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def time_mix(p, x: torch.Tensor, cfg, *, shift_state=None, wkv_state=None,
             cols: slice | None = None):
    """Returns (y [B,T,D], new_shift [B,1,D], new_wkv [B,H,K,V]).

    On a tensor-parallel member (`distributed.tensor_parallel`) p holds
    its heads (H from `w0`'s rows), `cols` its columns of D: the
    replicated decay LoRA's output is cut to them, and y is the member's
    partial sum over its rows of `wo`."""
    b, t, _ = x.shape
    h, kd = p["w0"].shape[0], cfg.rwkv_head_dim
    prev = _token_shift(x, shift_state)
    delta = prev - x

    def mixed(name):
        return x + delta * p[f"mix_{name}"]

    r = (mixed("r") @ p["wr"]).reshape(b, t, h, kd)
    k = (mixed("k") @ p["wk"]).reshape(b, t, h, kd)
    v = (mixed("v") @ p["wv"]).reshape(b, t, h, kd)
    g = silu(mixed("g") @ p["wg"])
    # data-dependent decay (the Finch signature): w = exp(-exp(w0 + lora(xw)))
    w_lora = torch.tanh(mixed("w") @ p["lora_a_w"]) @ p["lora_b_w"]
    if cols is not None:
        w_lora = w_lora[..., cols]
    w = torch.exp(-torch.exp(p["w0"].reshape(h * kd).float()
                             + w_lora.float()))
    w = w.reshape(b, t, h, kd)
    s0 = wkv_state if t == 1 else None
    o, new_wkv = wkv6_state(r, k, v, w, p["u"], s0)
    # per-head groupnorm (population variance, as jnp.var) then gate
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = ((o - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    o = (o.reshape(b, t, h * kd) * g).to(x.dtype)
    return o @ p["wo"], x[:, -1:], new_wkv


def channel_mix_parts(p, x: torch.Tensor, *, shift_state=None):
    """`channel_mix`'s two factors and its new shift: (rr = sigmoid(xr @
    wr), out = relu(xk @ w_in)^2 @ w_out, new_shift [B,1,D]). On a
    tensor-parallel member rr holds its columns of D and out its partial
    sum over its hidden units: the row sums out and gathers rr before
    their product."""
    prev = _token_shift(x, shift_state)
    delta = prev - x
    xk = x + delta * p["mix_ck"]
    xr = x + delta * p["mix_cr"]
    kk = torch.square(torch.relu(xk @ p["w_in"]))
    out = kk @ p["w_out"]
    rr = torch.sigmoid(xr @ p["wr"])
    return rr, out, x[:, -1:]


def channel_mix(p, x: torch.Tensor, *, shift_state=None):
    """RWKV channel-mix: squared-ReLU FFN with receptance gate. Returns
    (y [B,T,D], new_shift [B,1,D])."""
    rr, out, shift = channel_mix_parts(p, x, shift_state=shift_state)
    return rr * out, shift
