"""The port's flash attention (`repro_torch.kernels.flash_attn`) and the
long-prompt prefill branch against the JAX package, on the CPU.

The JAX kernel runs in interpret mode, as tests/test_kernels.py runs it;
the port's CPU path is the plain version. Bounds:
  * float32: rtol 2e-4 / atol 2e-5, the JAX kernel sweep's bound
    (tests/test_kernels.py, flash_attention against its oracle);
  * bfloat16: one bf16 ulp of the value plus that bound (both sides round
    one float32 result once);
  * the plain version against `chunked_attention_core` at prefill
    positions: rtol 1e-5 / atol 1e-6, float32 sums in another order
    (tests/test_torch_lm.py's attention bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import flash_attention as jax_flash_attention
from repro_torch.configs import reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attn import (flash_attention,
                                            flash_attention_plain)
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.init import init_params

FLASH_TOL = dict(rtol=2e-4, atol=2e-5)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed, b, t, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32),
            rng.standard_normal((b, s, kv, d)).astype(np.float32))


def _both(qkv, block, dtype=torch.float32, **kw):
    """(port plain, JAX interpret-mode kernel) on the same inputs."""
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in qkv)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jax_flash_attention(*(jnp.asarray(a).astype(jdt) for a in qkv),
                               block_q=block, block_kv=block,
                               interpret=True, **kw)
    got = flash_attention_plain(tq, tk, tv, **kw)
    # on CPU tensors the wrapper is the plain version
    assert torch.equal(flash_attention(tq, tk, tv, **kw), got)
    return got, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (False, None, None), (True, 64, None),
    (True, None, 30.0), (True, 32, 50.0)])
def test_flash_plain_matches_jax_kernel_masks(causal, window, softcap):
    got, want = _both(_inputs(0, 2, 128, 128, 4, 2, 32), 32, causal=causal,
                      window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


@pytest.mark.parametrize("t,s,h,kv,d", [
    (64, 64, 8, 8, 64), (128, 128, 8, 1, 16), (256, 256, 4, 4, 128),
    (64, 128, 4, 2, 32), (128, 64, 6, 3, 32)])
def test_flash_plain_matches_jax_kernel_shapes(t, s, h, kv, d):
    """GQA and MHA, and T != S both ways: causality is by index from 0 on
    both axes (row t sees kv rows s <= t), as the JAX kernel's."""
    got, want = _both(_inputs(1, 2, t, s, h, kv, d), 64, causal=True)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)


def test_flash_plain_fully_masked_rows_give_zero():
    """T 128 > S 32 with a window of 16: rows t >= S + 16 - 1 see no kv row
    and give 0, as the JAX kernel's clamped denominator does."""
    got, want = _both(_inputs(2, 1, 128, 32, 2, 2, 32), 32, causal=True,
                      window=16)
    np.testing.assert_allclose(got.numpy(), want, **FLASH_TOL)
    assert np.all(got.numpy()[:, 47:] == 0) and np.all(want[:, 47:] == 0)
    assert np.abs(got.numpy()[:, :47]).min(axis=-1).max() > 0


def test_flash_plain_bf16_within_one_ulp_of_jax_kernel():
    got, want = _both(_inputs(3, 2, 128, 128, 4, 2, 64), 64,
                      dtype=torch.bfloat16, causal=True)
    assert got.dtype == torch.bfloat16
    _, ex = np.frexp(np.abs(want))
    bound = np.ldexp(1.0, ex - 8) + FLASH_TOL["atol"] \
        + FLASH_TOL["rtol"] * np.abs(want)
    assert np.all(np.abs(got.float().numpy() - want) <= bound)


@pytest.mark.parametrize("arch", ("gemma2-9b", "jamba-1.5-large-398b"))
def test_long_prompt_prefill_branch_on_the_cpu(arch, monkeypatch):
    """On CPU tensors the long-prompt branch stays `chunked_attention_core`
    (the flash kernel wrapper is not called), and at the prefill positions
    `lm` hands it, arange(S), that equals the index-masked flash attention
    the card runs: causal, the local window, the softcap."""
    cfg = reduced_config(arch)
    s = tlayers.CHUNK_THRESHOLD + 5
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, s)).astype(np.int32))
    x, positions = tlm._embed_inputs(params, cfg, tokens, None)
    assert torch.equal(positions[0], torch.arange(s, dtype=torch.int32))
    p = {k: v[0] for k, v in params["groups"][cfg.layer_kinds().index(
        "attn")]["attn"].items()}
    q, k, v = tlayers._qkv(p, x, cfg, positions)

    def no_kernel(*args, **kwargs):
        raise AssertionError("the CPU path called the flash wrapper")

    monkeypatch.setattr(tlayers, "flash_attention", no_kernel)
    for local in ((False, True) if cfg.sliding_window else (False,)):
        window = cfg.sliding_window if local else None
        y, _ = tlayers.self_attention(p, x, cfg, positions=positions,
                                      local=local)
        chunked = tlayers.chunked_attention_core(
            q, k, v, cfg, q_pos=positions, kv_pos=positions, causal=True,
            window=window)
        np.testing.assert_array_equal(
            y.numpy(), tlayers._out_proj(p, chunked).numpy())
        flash = flash_attention_plain(q, k, v, causal=True, window=window,
                                      softcap=cfg.attn_softcap)
        np.testing.assert_allclose(chunked.numpy(), flash.numpy(),
                                   **ATTN_TOL)


def test_ops_reexports_the_lm_kernels():
    """`kernels.ops` re-exports flash_attention and wkv6, as the JAX
    package's ops module does."""
    assert ops.flash_attention is flash_attention and ops.wkv6 is wkv6
    assert {"flash_attention", "wkv6"} <= set(ops.__all__)
