"""Numerics of the tensor-core kernels' bf16 split, emulated with torch ops
on the CPU.

The bf16 paths of `csrc/flash_attn.cu` and `csrc/moe_experts.cu` multiply
a float32 intermediate (P, the softmax weights, in P·V; h, the SwiGLU
output, in h·W_out) on the tensor cores, which take bf16 operands. Each
such x is split into bf16 terms, hi = bf16(x), mid = bf16(x - hi),
lo = bf16(x - hi - mid), one MMA per term into one float32 accumulator.
A product of two bf16 values is exact in float32, so the emulation here
is a float32 matmul over the terms stacked along the reduction axis.

Bounds are the kernels' own, unchanged: flash attention rtol 2e-4 /
atol 2e-5 (the JAX kernel sweep's), the expert FFN rtol 1e-5 / atol 1e-6
in float32 and one bf16 ulp more once y is rounded to bf16; here they
hold against a float64 product of the same float32 intermediate at the
served reduction lengths (S = 4096 kv rows, F = 512 hidden columns).
"""

import numpy as np
import pytest
import torch

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
BODY_TOL = dict(rtol=1e-5, atol=1e-6)
S_SERVED, D_HEAD = 4096, 64           # granite's 4096-token prefill
D_MODEL, F_SERVED = 1536, 512         # granite-moe-3b-a800m's experts


def bf16_terms(x: torch.Tensor, n: int) -> list:
    """x (float32) as n bf16 terms (each held in float32), largest first:
    each term is the bf16 rounding of what the earlier ones left."""
    terms, rest = [], x.clone()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def split_matmul(x: torch.Tensor, w: torch.Tensor, n: int) -> torch.Tensor:
    """x [M, K] float32 times w [K, N] (bf16 values) as the kernels do
    it: x's n bf16 terms against w, one float32 accumulation."""
    return torch.cat(bf16_terms(x, n), 1) @ torch.cat([w.float()] * n, 0)


def excess(got, want, tol) -> float:
    """max(|got - want| - (atol + rtol |want|)); <= 0 is within `tol`."""
    return float(((got.double() - want).abs()
                  - (tol["atol"] + tol["rtol"] * want.abs())).max())


def bf16_ulp(want: torch.Tensor) -> torch.Tensor:
    _, ex = torch.frexp(want.abs())
    return torch.ldexp(torch.ones_like(want), ex - 8)


def softmax_weights(rng, rows, s):
    """p = exp(s - rowmax) in float32 for attention logits at granite's
    scale (q, k ~ N(0, 1), D 64: logits N(0, 1) after D^-0.5), and the
    row sums l."""
    logits = torch.from_numpy(rng.standard_normal((rows, s)).astype(
        np.float32))
    p = torch.exp(logits - logits.max(1, keepdim=True).values)
    return p, p.sum(1, keepdim=True)


def swiglu_h(rng, rows):
    """h = silu(x W_gate) * (x W_up) in float32 at the model's scales
    (x ~ N(0, 1) after the norm, W_in ~ N(0, 0.02)), and a bf16 W_out at
    0.02 / sqrt(32 layers)."""
    x = torch.from_numpy(rng.standard_normal((rows, D_MODEL)).astype(
        np.float32)).bfloat16().float()
    w_in = torch.from_numpy((rng.standard_normal(
        (D_MODEL, 2 * F_SERVED)) * 0.02).astype(np.float32)).bfloat16()
    w_out = torch.from_numpy((rng.standard_normal(
        (F_SERVED, D_MODEL)) * 0.02 / 32 ** 0.5).astype(
            np.float32)).bfloat16()
    gate, up = (x @ w_in.float()).chunk(2, dim=1)
    return gate * torch.sigmoid(gate) * up, w_out


@pytest.mark.parametrize("values", ("normal", "softmax", "swiglu"))
def test_three_bf16_terms_rebuild_float32_exactly(values):
    rng = np.random.default_rng(0)
    if values == "normal":
        x = torch.from_numpy(rng.standard_normal(1 << 16).astype(
            np.float32) * 10.0 ** rng.integers(-20, 20, 1 << 16))
    elif values == "softmax":
        x = softmax_weights(rng, 16, S_SERVED)[0].flatten()
    else:
        x = swiglu_h(rng, 8)[0].flatten()
    x = x[x != 0].float()
    hi, mid, lo = bf16_terms(x, 3)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    # two terms leave at most 2^-16 of x (hi keeps 8 bits, mid 8 more)
    two = hi.double() + mid.double()
    assert float(((two - x.double()).abs() / x.double().abs()).max()) \
        <= 2.0 ** -16


def test_two_term_pv_within_the_flash_bound_at_s_4096(capsys):
    """P·V with P split in two bf16 terms, divided by l, against the
    float64 product; the single rounding is measured on the same inputs."""
    rng = np.random.default_rng(1)
    p, l = softmax_weights(rng, 64, S_SERVED)
    v = torch.from_numpy(rng.standard_normal((S_SERVED, D_HEAD)).astype(
        np.float32)).bfloat16()
    want = (p.double() @ v.double()) / l.double()
    two = split_matmul(p, v, 2) / l
    one = split_matmul(p, v, 1) / l
    assert excess(two, want, FLASH_TOL) <= 0
    with capsys.disabled():
        print(f"\nP·V at S {S_SERVED}: two bf16 terms max abs err "
              f"{float((two.double() - want).abs().max()):.3e}, excess over "
              f"(rtol 2e-4, atol 2e-5) {excess(two, want, FLASH_TOL):.3e}; "
              f"one term (a single rounding) max abs err "
              f"{float((one.double() - want).abs().max()):.3e}, excess "
              f"{excess(one, want, FLASH_TOL):.3e}")


def test_three_term_h_w_out_within_the_body_bound_at_f_512():
    """h·W_out with h split in three bf16 terms: float32 within BODY_TOL of
    the float64 product, and within one bf16 ulp more once rounded."""
    rng = np.random.default_rng(2)
    h, w_out = swiglu_h(rng, 64)
    want = h.double() @ w_out.double()
    three = split_matmul(h, w_out, 3)
    assert excess(three, want, BODY_TOL) <= 0
    rounded = three.bfloat16().float().double()
    assert float(((rounded - want).abs() - bf16_ulp(want)
                  - BODY_TOL["atol"] - BODY_TOL["rtol"] * want.abs()).max()) \
        <= 0


def test_one_term_h_w_out_misses_the_body_bound():
    """A single rounding of h (what a plain bf16 GEMM does) is outside
    BODY_TOL on the same inputs: the split is what keeps the bound."""
    rng = np.random.default_rng(2)
    h, w_out = swiglu_h(rng, 64)
    want = h.double() @ w_out.double()
    assert excess(split_matmul(h, w_out, 1), want, BODY_TOL) > 0
