"""Mamba (selective SSM) block, the Jamba hybrid's recurrent layer — port of
`repro.models.mamba`.

Recurrence per channel c with state dim N:
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t * x_t        (ZOH discretization)
    y_t = C_t . h_t + D * x_t
with data-dependent (selective) B_t, C_t, dt_t. The scan is
`kernels.mamba_scan.mamba_selective_scan_state`: on CUDA tensors one launch
of the kernel `csrc/mamba_scan.cu` per layer and step (h0 from the cache's
`ssm` in decode), on CPU tensors the plain sequential scan. Its y already
holds D * x, which the JAX block adds after its scan. The JAX config's
`mamba_naive_disc` and `mamba_scan_unroll` are XLA scheduling knobs that
compute the same numbers; the port ignores them.

Decode carries (conv_state, ssm_state): O(1) per token.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import mamba_selective_scan_state
from repro_torch.models.layers import silu


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: torch.Tensor | None):
    """Depthwise causal conv over time. x [B,T,Din], w [Din,K], b [Din].
    conv_state [B, K-1, Din] for decode. Returns (y, new_state); the K
    terms are summed in the JAX block's order, then b."""
    k, t = w.shape[-1], x.shape[1]
    if conv_state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[-1]))
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [B, T+K-1, Din]
    y = xp[:, 0:t, :] * w[:, 0]
    for i in range(1, k):
        y = y + xp[:, i:i + t, :] * w[:, i]
    return y + b, xp[:, -(k - 1):, :]


def mamba_in(p, x: torch.Tensor, cfg, *, state=None):
    """The block up to `x_proj`: (xin, z, new conv state, proj [B,T,
    R+2N]). On a tensor-parallel member p holds its channels ([x_k | z_k]
    of `in_proj`, its rows of `x_proj`), so proj is its partial sum: the
    row sums it before `mamba_out`."""
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)            # [B,T,Din] each
    conv_state = state["conv"] if state is not None else None
    xin, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    xin = silu(xin)
    return xin, z, new_conv, xin @ p["x_proj"]


def mamba_out(p, xin, z, new_conv, proj, cfg, *, state=None):
    """The block from the whole `proj` on: the scan over xin's channels,
    the gate and `out_proj` (a member's partial sum). Returns (y,
    new_state)."""
    n = cfg.mamba_d_state
    dt_low, b_mat, c_mat = torch.split(proj, [cfg.dt_rank, n, n], dim=-1)
    pre = dt_low @ p["dt_proj"] + p["dt_bias"]
    dt = torch.logaddexp(pre, torch.zeros_like(pre))        # jax softplus
    a = -torch.exp(p["a_log"].float())                      # [Din,N]
    h0 = state["ssm"].float() if state is not None else None
    y, h_final = mamba_selective_scan_state(
        dt.float(), xin.float(), b_mat.float().contiguous(),
        c_mat.float().contiguous(), a, p["d"], h0)          # y holds D * x
    y = y.to(z.dtype) * silu(z)
    out = y @ p["out_proj"]
    return out, {"conv": new_conv.to(z.dtype), "ssm": h_final}


def mamba_block(p, x: torch.Tensor, cfg, *, state=None):
    """x [B,T,D]. state None (prefill) or {"conv": [B,K-1,Din], "ssm":
    [B,Din,N]} (decode). Returns (y, new_state)."""
    xin, z, new_conv, proj = mamba_in(p, x, cfg, state=state)
    return mamba_out(p, xin, z, new_conv, proj, cfg, state=state)
