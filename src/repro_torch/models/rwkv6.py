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


def time_mix(p, x: torch.Tensor, cfg, *, shift_state=None, wkv_state=None):
    """Returns (y [B,T,D], new_shift [B,1,D], new_wkv [B,H,K,V])."""
    b, t, d = x.shape
    h, kd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
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
    w = torch.exp(-torch.exp(p["w0"].reshape(h * kd).float()
                             + w_lora.float()))
    w = w.reshape(b, t, h, kd)
    s0 = wkv_state if t == 1 else None
    o, new_wkv = wkv6_state(r, k, v, w, p["u"], s0)
    # per-head groupnorm (population variance, as jnp.var) then gate
    mean = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    o = ((o - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)
    o = (o.reshape(b, t, d) * g).to(x.dtype)
    return o @ p["wo"], x[:, -1:], new_wkv


def channel_mix(p, x: torch.Tensor, *, shift_state=None):
    """RWKV channel-mix: squared-ReLU FFN with receptance gate. Returns
    (y [B,T,D], new_shift [B,1,D])."""
    prev = _token_shift(x, shift_state)
    delta = prev - x
    xk = x + delta * p["mix_ck"]
    xr = x + delta * p["mix_cr"]
    kk = torch.square(torch.relu(xk @ p["w_in"]))
    out = kk @ p["w_out"]
    rr = torch.sigmoid(xr @ p["wr"])
    return rr * out, x[:, -1:]
