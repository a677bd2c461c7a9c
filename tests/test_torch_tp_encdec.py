"""Tensor-parallel enc-dec serving (`models/encdec.py` with a runtime,
`serve.step`'s enc-dec steps on an LM mesh) against the JAX package's
enc-dec serving steps on a mesh, on the CPU.

The JAX package serves on simulated host devices, which XLA fixes when
its backend starts, so a module fixture runs the JAX side in one
subprocess under `XLA_FLAGS=--xla_force_host_platform_device_count=8`
(this file run as a script, started with the module's first test): on
Auto-axes `jax.sharding.Mesh`es (never `repro.launch.mesh`, whose
Explicit axes make the models' constraints raise), with params placed by
`param_shardings`, it runs the jitted `build_prefill_step(cfg, rt)` and 4
`build_decode_step(cfg, rt)` steps fed the greedy tokens, and keeps the
frames, the prompt, the tokens, the logits, `enc_out` and the caches
after prefill and after the last step in a temporary npz; it also serves
the same inputs unsharded. The port runs the same calls on logical CPU
devices (`sharding.logical_devices`), one CPU thread (a multithreaded CPU
GEMM may split its sums differently from one call to the next, and the
bit-equality tests compare runs).

Reduced float32 seamless-m4t-large-v2 (2 encoder + 2 decoder layers, 4
heads, frames [B, S_ENC, 64], a SEQ-token prompt) on (1, 2) and (2, 2)
at batch 4 and on (2, 2, 2) at batch 8. Bounds: logits and `enc_out`
within LOGIT_ATOL of JAX's on the same mesh; the caches' `pos` planes
bit-equal, K/V within LOGIT_ATOL; greedy tokens equal up to the first
step at which JAX's top-2 margin is MARGIN or less. JAX's mesh serving
agrees with its unsharded serving on every case here, so no case is held
to JAX unsharded instead. A (1, 1) mesh is bit-equal to the port's
unsharded serving, two runs of one mesh to each other.
"""

import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed import sharding as jsharding
from repro.models.init import init_params as jax_init_params
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import encdec, layers
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.serve.step import (build_decode_step, build_prefill_step,
                                    greedy_generate)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-large-v2"
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "2x2x2": (2, 2, 2)}
#: (mesh, batch)
CASES = [("1x2", 4), ("2x2", 4), ("2x2x2", 8)]
S_ENC = 16
SEQ = 12
NEW = 5                     # greedy tokens: prefill and 4 decode steps
LOGIT_ATOL = 1e-5
MARGIN = 1e-4
JAX_TIMEOUT_S = 600


def _cfg(jax_side=True):
    return (reduced_config if jax_side else port_reduced_config)(ARCH)


def _key(mesh, batch) -> str:
    return f"{mesh}|b{batch}"


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                                    _cfg()))


def _inputs(batch) -> tuple[np.ndarray, np.ndarray]:
    """(frames [batch, S_ENC, D] float32, prompt [batch, SEQ] int32)."""
    cfg = _cfg()
    rng = np.random.default_rng(batch)
    frames = rng.standard_normal((batch, S_ENC, cfg.d_model))
    prompt = rng.integers(0, cfg.vocab_size, (batch, SEQ))
    return frames.astype(np.float32), prompt.astype(np.int32)


# ---------------------------------------------------------- the JAX side

def _jax_main(out_path: str) -> None:
    import jax.numpy as jnp

    from repro.serve.step import build_decode_step as jax_decode_step
    from repro.serve.step import build_prefill_step as jax_prefill_step

    assert jax.local_device_count() == 8, jax.local_device_count()
    cfg = _cfg()
    out: dict = {}

    def caches(tag, tree):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{tag}|{jsharding._path_str(path)}"] = np.asarray(x)

    runs = CASES + [("none", b) for b in sorted({b for _, b in CASES})]
    for name, batch in runs:
        p = jax.tree.map(jnp.asarray, _jax_params())
        if name == "none":
            rt = jsharding.Runtime(mesh=None)
        else:
            shape = MESHES[name]
            axes = ("pod", "data", "model") if len(shape) == 3 \
                else ("data", "model")
            devs = np.array(jax.devices()[:int(np.prod(shape))]).reshape(
                shape)
            rt = jsharding.make_runtime(jax.sharding.Mesh(devs, axes))
            p = jax.tree.map(jax.device_put, p,
                             jsharding.param_shardings(rt, p))
        key = _key(name, batch)
        frames, prompt = (jnp.asarray(a) for a in _inputs(batch))
        prefill = jax.jit(jax_prefill_step(cfg, rt))
        decode = jax.jit(jax_decode_step(cfg, rt))
        last, enc_out, cache, pos = prefill(p, frames, prompt)
        out[f"{key}|enc_out"] = np.asarray(enc_out)
        out[f"{key}|logits0"] = np.asarray(last)
        caches(f"{key}|cache0", cache)
        toks = [jnp.argmax(last, -1).astype(jnp.int32)]
        for t in range(NEW - 1):
            last, cache, pos = decode(p, toks[-1][:, None], enc_out, cache,
                                      pos)
            out[f"{key}|logits{t + 1}"] = np.asarray(last)
            toks.append(jnp.argmax(last, -1).astype(jnp.int32))
        caches(f"{key}|cache{NEW - 1}", cache)
        out[f"{key}|tokens"] = np.asarray(jnp.stack(toks, 1))
    np.savez(out_path, **out)


@pytest.fixture(scope="module", autouse=True)
def jax_job(tmp_path_factory):
    """The JAX side's job, started with the module's first test so that
    the port's own tests run meanwhile; (npz path, process). Killed at
    the module's end if still running."""
    out = tmp_path_factory.mktemp("jax_tp_encdec") / "jax.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src"), str(ROOT / "tests")]
                   + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen([sys.executable, __file__, str(out)], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    yield out, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_side(jax_job):
    """The job's records (waits for the job)."""
    out, proc = jax_job
    _, err = proc.communicate(timeout=JAX_TIMEOUT_S)
    assert proc.returncode == 0, err[-4000:]
    with np.load(out) as z:
        return dict(z)


# --------------------------------------------------------- the port side

@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _runtime(shape):
    """A runtime over an LMMesh of `shape` ((data, model) or (pod, data,
    model)) of logical CPU devices."""
    with sharding.logical_devices(int(np.prod(shape)), "cpu"):
        mesh = make_test_mesh(*shape[-2:], multi_pod=len(shape) == 3,
                              device="cpu")
    return sharding.make_runtime(mesh)


def _params():
    return params_from_numpy(_jax_params())


def _paths(tree) -> dict:
    out = {}
    sharding.map_with_path(lambda path, x: out.setdefault(path, x), tree)
    return out


def _serve(rt, frames, prompt, tokens=None):
    """The port's prefill and NEW - 1 decode steps on `rt` (None:
    unsharded), fed `tokens` (None: its own greedy tokens): ([logits],
    enc_out, caches after prefill, caches after the last step, [B, NEW]
    tokens), the caches assembled into the unsharded layout."""
    cfg = _cfg(jax_side=False)
    params = _params()
    if rt is not None:
        params = tp.tp_layout(params, cfg, rt)
    prefill, decode = build_prefill_step(cfg, rt), build_decode_step(cfg, rt)
    whole = (lambda c: c) if rt is None else tp.gather_caches
    last, enc_out, cache, pos = prefill(params, frames, prompt)
    logits, first = [last], whole(cache)
    toks = [torch.argmax(last, -1)]
    for t in range(NEW - 1):
        fed = toks[-1][:, None] if tokens is None else tokens[:, t:t + 1]
        last, cache, pos = decode(params, fed, enc_out, cache, pos)
        logits.append(last)
        toks.append(torch.argmax(last, -1))
    return logits, enc_out, first, whole(cache), torch.stack(toks, 1)


def _inputs_t(batch):
    return tuple(torch.from_numpy(a) for a in _inputs(batch))


#: each case's port runs, made once (four tests read them)
_RUNS: dict = {}


def _port_case(case, jax_side):
    """(the run fed JAX's tokens, the greedy run) on the case's mesh."""
    if case not in _RUNS:
        name, batch = case
        frames, prompt = _inputs_t(batch)
        tokens = torch.from_numpy(
            jax_side[f"{_key(*case)}|tokens"]).long()
        rt = _runtime(MESHES[name])
        _RUNS[case] = (_serve(rt, frames, prompt, tokens),
                       _serve(rt, frames, prompt))
    return _RUNS[case]


@pytest.mark.parametrize("case", CASES, ids=[_key(*c) for c in CASES])
def test_prefill_and_decode_logits_match_the_jax_mesh(jax_side, case):
    (logits, _, _, _, _), _ = _port_case(case, jax_side)
    key = _key(*case)
    for t, got in enumerate(logits):
        np.testing.assert_allclose(got.numpy(), jax_side[f"{key}|logits{t}"],
                                   rtol=0, atol=LOGIT_ATOL, err_msg=str(t))


@pytest.mark.parametrize("case", CASES, ids=[_key(*c) for c in CASES])
def test_enc_out_matches_the_jax_mesh(jax_side, case):
    """`enc_out` comes back whole on the caller's device, the replicas
    joined along the batch."""
    (_, enc_out, _, _, _), _ = _port_case(case, jax_side)
    want = jax_side[f"{_key(*case)}|enc_out"]
    assert enc_out.shape == want.shape
    np.testing.assert_allclose(enc_out.numpy(), want, rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("case", CASES, ids=[_key(*c) for c in CASES])
def test_caches_match_the_jax_mesh(jax_side, case):
    (_, _, first, last, _), _ = _port_case(case, jax_side)
    key = _key(*case)
    for tag, tree in ((0, first), (NEW - 1, last)):
        got = _paths(tree)
        want = {k.split("|", 3)[3]: v for k, v in jax_side.items()
                if k.startswith(f"{key}|cache{tag}|")}
        assert sorted(got) == sorted(want)
        for path, x in got.items():
            if path.endswith("pos"):
                np.testing.assert_array_equal(x.numpy(), want[path], path)
            else:
                np.testing.assert_allclose(x.numpy(), want[path], rtol=0,
                                           atol=LOGIT_ATOL, err_msg=path)


@pytest.mark.parametrize("case", CASES, ids=[_key(*c) for c in CASES])
def test_greedy_tokens_match_the_jax_mesh(jax_side, case):
    """Equal up to the first step at which JAX's top-2 margin is MARGIN
    or less (a tie that float32 sums in another order may break either
    way)."""
    _, (_, _, _, _, gen) = _port_case(case, jax_side)
    key = _key(*case)
    want = jax_side[f"{key}|tokens"]
    checked = 0
    for row in range(want.shape[0]):
        for t in range(NEW):
            top2 = np.sort(jax_side[f"{key}|logits{t}"][row])[-2:]
            if top2[1] - top2[0] <= MARGIN:
                break
            assert int(gen[row, t]) == int(want[row, t]), (row, t)
            checked += 1
    assert checked >= want.size // 2, checked


@pytest.mark.parametrize("case", CASES, ids=[_key(*c) for c in CASES])
def test_the_jax_mesh_agrees_with_jax_unsharded_serving(jax_side, case):
    """Why every case is held to JAX's serving on its own mesh: unlike
    JAX's rwkv6 serving on (2, 2, 2) (`tests/test_torch_tp_serve.py`),
    JAX's enc-dec mesh serving gives its unsharded tokens, and logits and
    enc_out within LOGIT_ATOL, on every case here."""
    key, ref = _key(*case), _key("none", case[1])
    np.testing.assert_array_equal(jax_side[f"{key}|tokens"],
                                  jax_side[f"{ref}|tokens"])
    for name in ["enc_out"] + [f"logits{t}" for t in range(NEW)]:
        np.testing.assert_allclose(jax_side[f"{key}|{name}"],
                                   jax_side[f"{ref}|{name}"], rtol=0,
                                   atol=LOGIT_ATOL, err_msg=name)


# ------------------------------------------------------------- the layout

def _unsplit(parts, path, x):
    """The whole leaf from its members' slices (the inverse of
    `member_params`; seamless has no fused-halves leaf but `mlp/w_in`)."""
    spec = sharding.param_spec(path, x.ndim)
    dims = [i for i, e in enumerate(spec) if e == tp.RULE_AXIS]
    if not dims:
        for part in parts:
            assert torch.equal(part, x), path
        return parts[0]
    dim = dims[0]
    if tp._FUSED.search(path):
        halves = [p.chunk(2, dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim)
    return torch.cat(parts, dim)


@pytest.mark.parametrize("shape", ((1, 2), (1, 4)))
def test_member_slices_put_back_together_equal_each_param(shape):
    """Every leaf, the encoder's `enc_groups` and the decoder's `xattn`
    included, is its members' slices put back together; the q/k/v and
    `wo` leaves of both are cut by heads."""
    cfg = _cfg(jax_side=False)
    params = _params()
    layout = tp.tp_layout(params, cfg, _runtime(shape))
    m = shape[1]
    trees = [_paths(layout.members[p]) for p in layout.rows(4)[0]]
    whole = _paths(params)
    assert any("enc_groups" in p for p in whole)
    assert any("xattn" in p for p in whole)
    for path, x in whole.items():
        parts = [t[path] for t in trees]
        assert all(p.is_contiguous() for p in parts), path
        assert torch.equal(_unsplit(parts, path, x), x), path
        if path.endswith(("attn/wq", "attn/wk", "attn/wv")):
            assert parts[0].shape[-1] * m == x.shape[-1], path
        if path.endswith("attn/wo"):
            assert parts[0].shape[-2] * m == x.shape[-2], path


def test_an_uneven_split_raises_naming_the_dim():
    """8 members over reduced seamless's 4 heads: ValueError naming the
    config and the dim, from the layout and from the steps."""
    cfg = _cfg(jax_side=False)
    rt = _runtime((1, 8))
    with pytest.raises(ValueError, match=f"{ARCH}.*n_heads"):
        tp.tp_layout(_params(), cfg, rt)
    frames, prompt = _inputs_t(4)
    with pytest.raises(ValueError, match="n_heads"):
        build_prefill_step(cfg, rt)(_params(), frames, prompt)


def test_cross_attention_on_member_heads_sums_to_the_whole():
    """`layers.cross_attention` takes its head counts from the weights:
    the members' partial sums over their `xattn` heads add up to the
    whole layer's output."""
    cfg = _cfg(jax_side=False)
    xattn = _params()["groups"][0]["xattn"]
    p = {k: v[0] for k, v in xattn.items()}
    g = torch.Generator().manual_seed(3)
    x = torch.randn((2, 5, cfg.d_model), generator=g)
    enc_out = torch.randn((2, 7, cfg.d_model), generator=g)
    want = layers.cross_attention(p, x, enc_out, cfg)
    parts = [layers.cross_attention(
        tp.member_params({"xattn": p}, k, 2, "cpu")["xattn"], x, enc_out, cfg)
        for k in range(2)]
    np.testing.assert_allclose((parts[0] + parts[1]).numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


# ------------------------------------------------------ bits and dispatch

def _same(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_a_one_member_mesh_is_bit_equal_to_unsharded_serving():
    frames, prompt = _inputs_t(4)
    want = _serve(None, frames, prompt)
    assert _same(_serve(_runtime((1, 1)), frames, prompt), want)


def test_two_runs_of_one_mesh_are_bit_equal():
    frames, prompt = _inputs_t(4)
    first = _serve(_runtime((2, 2)), frames, prompt)
    assert _same(_serve(_runtime((2, 2)), frames, prompt), first)


def test_prefill_returns_member_caches_and_a_whole_enc_out():
    """A (2, 2) prefill: a `TPCache` of two replicas' rows, each member's
    K/V holding its half of the heads, `enc_out` whole and equal to
    `encdec.encode`'s within LOGIT_ATOL."""
    cfg = _cfg(jax_side=False)
    rt = _runtime((2, 2))
    layout = tp.tp_layout(_params(), cfg, rt)
    frames, prompt = _inputs_t(4)
    _, enc_out, cache, pos = encdec.prefill_encdec(layout, cfg, frames,
                                                   prompt, rt=rt)
    assert isinstance(cache, tp.TPCache) and cache.rows == ((0, 1), (2, 3))
    for blocks in cache.blocks:
        for member in blocks:
            assert member[0]["attn"]["k"].shape[3] * 2 == cfg.n_kv_heads
    np.testing.assert_allclose(
        enc_out.numpy(), encdec.encode(_params(), cfg, frames).numpy(),
        rtol=0, atol=LOGIT_ATOL)
    assert pos.tolist() == [SEQ] * 4


def test_decode_takes_the_cache_of_a_prefill_on_the_same_rows():
    cfg = _cfg(jax_side=False)
    rt = _runtime((2, 2))
    layout = tp.tp_layout(_params(), cfg, rt)
    frames, prompt = _inputs_t(4)
    _, enc_out, cache, pos = encdec.prefill_encdec(layout, cfg, frames,
                                                   prompt, rt=rt)
    with pytest.raises(ValueError, match="TPCache"):
        encdec.decode_step_encdec(layout, cfg, prompt[:3, :1], enc_out[:3],
                                  cache, pos[:3], rt=rt)
    whole = encdec.prefill_encdec(_params(), cfg, frames, prompt)[2]
    with pytest.raises(ValueError, match="TPCache"):
        encdec.decode_step_encdec(layout, cfg, prompt[:, :1], enc_out,
                                  whole, pos, rt=rt)


def test_without_an_lm_mesh_the_steps_run_the_single_device_path():
    """rt None and a runtime over a tile mesh give the enc-dec functions'
    outputs bit for bit; a layout without its runtime raises; and
    `greedy_generate` still raises for enc-dec, on a mesh too, as the JAX
    package's does."""
    cfg = _cfg(jax_side=False)
    frames, prompt = _inputs_t(2)
    want = encdec.prefill_encdec(_params(), cfg, frames, prompt)
    nxt = torch.argmax(want[0], -1)[:, None]
    want_step = encdec.decode_step_encdec(_params(), cfg, nxt, want[1],
                                          want[2], want[3])
    for rt in (None, sharding.Runtime(mesh=sharding.tile_mesh(1, "cpu"))):
        got = build_prefill_step(cfg, rt)(_params(), frames, prompt)
        assert isinstance(got[2], list) and _same(got, want)
        step = build_decode_step(cfg, rt)(_params(), nxt, got[1], got[2],
                                          got[3])
        assert _same(step, want_step)
    rt = _runtime((1, 2))
    layout = tp.tp_layout(_params(), cfg, rt)
    with pytest.raises(ValueError, match="runtime"):
        encdec.prefill_encdec(layout, cfg, frames, prompt)
    with pytest.raises(NotImplementedError, match="encdec steps directly"):
        greedy_generate(_params(), cfg, prompt, max_new=2, device="cpu",
                        rt=rt)


if __name__ == "__main__":
    _jax_main(sys.argv[1])
