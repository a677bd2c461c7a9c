"""Tensor-parallel LM training (`lm.lm_loss` / `lm.forward` with a runtime,
`lm.vocab_parallel_nll`, the differentiable cut of
`tensor_parallel.member_params`, the row hand-offs under autograd and the
mesh `build_train_step(cfg, rt)` over `model`) on the CPU.

Reduced float32 configs of granite (`moe_use_kernel=False`, the JAX
default), rwkv6-7b, the Jamba hybrid, qwen1.5-4b and gemma2-9b (softcaps,
post-block norms), params converted from the JAX tree with
`params_from_numpy`, meshes on logical CPU devices, one CPU thread (a
multithreaded CPU GEMM may split its sums differently from one call to
the next, and the bit-equality tests compare runs). The three JAX mesh
steps on (2, 2) and (2, 2, 2), now tensor-parallel in the port, are held
in `tests/test_torch_lm_mesh.py::test_mesh_step_matches_jax`; here the
port's tensor-parallel value-and-grad of reduced gemma2 and internvl2
(prepended patch embeddings) on (1, 2) is held to
`jax.value_and_grad` of the JAX package's `lm_loss` (JAX_ATOL).

Bounds: one value-and-grad on (1, 2), (2, 2) and (2, 2, 2) (and (1, 4)
where a family splits over 4) within ATOL of the port's unsharded
value-and-grad or its data-parallel one on the same data axes, a (1, 1)
mesh and rows of one member (a config that does not split) bit-equal;
the vocab-parallel cross-entropy and its gradients within ATOL of
`next_token_nll` of the whole logits, only [B, T, m, 3] gathered;
`gradcheck` of the row hand-offs in float64; remat bit-equal; the MoE aux
term within AUX_ATOL of the unsharded one, a control that counts every
member's statistics beyond 1e-4; `accum_steps=2` and `compress_grads` on
(2, 2) within ATOL of the data-parallel step; seamless's (2, 2) step on
rows of two within ATOL of the data-parallel (2, 1) step (the enc-dec
row itself: `tests/test_torch_tp_encdec_train.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.data.tokens import batch_for_step
from repro.distributed.sharding import Runtime as JaxRuntime
from repro.models import lm as jlm
from repro.models.init import init_params as jax_init_params
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.distributed import placement, sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import main as launch
from repro_torch.models import lm, moe
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import (_mesh_value_and_grad, build_train_step,
                                    value_and_grad)

GRANITE = "granite-moe-3b-a800m"
RWKV = "rwkv6-7b"
JAMBA = "jamba-1.5-large-398b"
QWEN = "qwen1.5-4b"
GEMMA = "gemma2-9b"
SEAMLESS = "seamless-m4t-large-v2"
INTERNVL = "internvl2-2b"
ARCHS = (GRANITE, RWKV, JAMBA, QWEN, GEMMA)
#: (mesh, the mesh of the same data axes with a model axis of one: None
#: for the unsharded value-and-grad)
MESHES = {(1, 2): None, (2, 2): (2, 1), (2, 2, 2): (2, 2, 1)}
#: the families whose reduced counts split over a model row of 4
SPLIT_4 = (RWKV, QWEN)
ATOL = 1e-6
AUX_ATOL = 1e-7
JAX_ATOL = 1e-5
BATCH = 4
SEQ = 16


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(arch, jax_side=False):
    cfg = (reduced_config if jax_side else port_reduced_config)(arch)
    return cfg.with_(moe_use_kernel=False) if arch == GRANITE else cfg


@functools.lru_cache(maxsize=None)
def _jax_params(arch):
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                                    _cfg(arch, True)))


def _params(arch):
    return params_from_numpy(_jax_params(arch))


def _batch(arch, batch=BATCH, step=0):
    return batch_for_step(_cfg(arch, True), step, global_batch=batch,
                          seq_len=SEQ)


def _torch_batch(arch, batch=BATCH):
    return {k: torch.from_numpy(v) for k, v in _batch(arch, batch).items()}


def _mesh(shape):
    """An LMMesh of `shape` ((data, model) or (pod, data, model)) over
    logical CPU devices."""
    with sharding.logical_devices(int(np.prod(shape)), "cpu"):
        return make_test_mesh(*shape[-2:], multi_pod=len(shape) == 3,
                              device="cpu")


def _vg(arch, shape, batch=BATCH, **kw):
    """(loss, [gradient leaves]) of the batch on a mesh of `shape` through
    the train step's mesh value-and-grad (None: unsharded)."""
    cfg, params, b = _cfg(arch), _params(arch), _torch_batch(arch, batch)
    if shape is None:
        loss, g = value_and_grad(params, cfg, b, **kw)
    else:
        mesh = _mesh(shape)
        m, _ = tp.train_row_size(cfg, mesh)
        loss, g = _mesh_value_and_grad(params, cfg, b, mesh,
                                       sharding.make_runtime(mesh).batch_axes,
                                       m)
    return loss, tree_leaves(g)


def _within(a, b, atol) -> float:
    """The largest |difference| of two (loss, leaves) pairs, asserted to
    be at most `atol`."""
    (la, ga), (lb, gb) = a, b
    assert len(ga) == len(gb)
    worst = max([float((la.detach() - lb.detach()).abs().max())]
                + [float((x - y).abs().max()) for x, y in zip(ga, gb)])
    assert worst <= atol, worst
    return worst


def _bit_equal(a, b) -> bool:
    (la, ga), (lb, gb) = a, b
    return torch.equal(la, lb) and all(torch.equal(x, y)
                                       for x, y in zip(ga, gb))


# ---------------------------------------------------- one value-and-grad

@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: "x".join(
    map(str, s)))
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_value_and_grad_holds_the_data_parallel_one(arch, shape):
    """Every replica's rows through a model row of two: the loss and every
    gradient leaf within ATOL of the unsharded value-and-grad (one
    replica) or of the data-parallel one over the same data axes."""
    assert tp.train_row_size(_cfg(arch), _mesh(shape)) == (2, None)
    _within(_vg(arch, shape), _vg(arch, MESHES[shape]), ATOL)


@pytest.mark.parametrize("arch", SPLIT_4)
def test_a_model_row_of_four(arch):
    assert tp.train_row_size(_cfg(arch), _mesh((1, 4))) == (4, None)
    _within(_vg(arch, (1, 4)), _vg(arch, None), ATOL)


def test_a_one_member_mesh_is_bit_equal_to_unsharded():
    """(1, 1) through `lm_loss` with the runtime (a row of one member on
    its own stream) and through the step: bit for bit."""
    cfg, params, b = _cfg(GRANITE), _params(GRANITE), _torch_batch(GRANITE)
    rt = sharding.make_runtime(_mesh((1, 1)))
    want = _vg(GRANITE, None)
    loss, g = value_and_grad(params, cfg, b, rt=rt)
    assert _bit_equal((loss, tree_leaves(g)), want)
    assert _bit_equal(_vg(GRANITE, (1, 1)), want)


def test_lm_loss_on_a_mesh_of_several_replicas_raises():
    """The model layer runs one model row; the train step splits the
    batch over replicas (each replica's loss gets its row)."""
    cfg, params, b = _cfg(GRANITE), _params(GRANITE), _torch_batch(GRANITE)
    rt = sharding.make_runtime(_mesh((2, 2)))
    with pytest.raises(ValueError, match="2 replicas"):
        lm.lm_loss(params, cfg, b, rt=rt)
    with pytest.raises(ValueError, match="build_train_step"):
        lm.forward(params, cfg, b["tokens"], rt=rt)


@pytest.mark.parametrize("arch,shape,dim", (
    (GRANITE, (1, 4), "n_kv_heads=2"), (QWEN, (1, 8), "n_heads=4")))
def test_a_config_that_does_not_split_trains_on_rows_of_one(arch, shape,
                                                            dim, capsys):
    """Where heads, GQA groups or hidden units do not split over the
    `model` axis, the step's rows are one member (it says which dim) and
    its value-and-grad is the unsharded one bit for bit; the launcher
    prints the row and the dim."""
    cfg = _cfg(arch)
    rt = sharding.make_runtime(_mesh(shape))
    step = build_train_step(cfg, rt)
    m = shape[-1]
    assert step.model_row == 1
    assert step.model_row_note == f"{dim} does not split over {m} members"
    assert _bit_equal(_vg(arch, shape), _vg(arch, None))
    with pytest.raises(ValueError, match=dim):      # serving still raises
        tp.tp_layout(_params(arch), cfg, rt)
    if arch == QWEN:
        launch(["--model", QWEN, "--reduced", "--steps", "1", "--batch",
                "2", "--seq-len", "8", "--mesh", "x".join(map(str, shape)),
                "--device", "cpu"])
        out = capsys.readouterr().out
        assert (f"model row: 1 member ({dim} does not split over {m} "
                f"members)") in out


def test_the_jax_value_and_grad_on_a_model_row():
    """Reduced gemma2 (softcaps, post-block norms, the vocab-parallel loss
    under the final softcap) and internvl2 (patch embeddings) on (1, 2):
    the loss and gradients within JAX_ATOL of `jax.value_and_grad` of the
    JAX `lm_loss`."""
    rt = sharding.make_runtime(_mesh((1, 2)))
    for arch in (GEMMA, INTERNVL):
        cfg, jcfg = _cfg(arch), _cfg(arch, True)
        b = _batch(arch, 2)
        jloss, jg = jax.value_and_grad(lambda p: jlm.lm_loss(
            p, jcfg, JaxRuntime(mesh=None),
            {k: jnp.asarray(v) for k, v in b.items()}))(
                jax.tree.map(jnp.asarray, _jax_params(arch)))
        loss, g = value_and_grad(_params(arch), cfg,
                                 {k: torch.from_numpy(v)
                                  for k, v in b.items()}, rt=rt)
        if arch == INTERNVL:
            assert "embeds" in b
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                                   atol=JAX_ATOL)
        for a, t in zip(jax.tree.leaves(jg), tree_leaves(g)):
            np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                       atol=JAX_ATOL)


# ------------------------------------------- the vocab-parallel loss

@pytest.mark.parametrize("m", (2, 4))
@pytest.mark.parametrize("arch", (GEMMA, QWEN))
def test_vocab_parallel_nll_equals_next_token_nll(arch, m, monkeypatch):
    """Padded vocabulary ids (512 columns, 256 ids) and gemma2's final
    softcap: the loss and its gradients for the hidden state, the final
    norm and the head within ATOL of `next_token_nll` of the whole
    logits; what the row gathers is [B, T, m, 3], never the logits."""
    cfg, params = _cfg(arch), _params(arch)
    assert cfg.vocab_padded != cfg.vocab_size
    assert (cfg.final_softcap is not None) == (arch == GEMMA)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 9, cfg.d_model, generator=g, requires_grad=True)
    tokens = torch.randint(0, cfg.vocab_size, (2, 10), generator=g)
    head = ["final_norm", "embed" if cfg.tie_embeddings else "lm_head"]
    whole = {k: params[k] for k in head}
    leaves = [t.requires_grad_(True) for t in tree_leaves(whole)]
    want = lm.next_token_nll(lm.logits_from_hidden(whole, cfg, x), tokens)
    want_g = torch.autograd.grad(want, [x] + leaves)

    gathered = []
    real = tp.row_gather

    def spy(row, parts, dim, **kw):
        gathered.append(tuple(parts[0].shape))
        return real(row, parts, dim, **kw)

    monkeypatch.setattr(tp, "row_gather", spy)
    with sharding.logical_devices(m, "cpu"):
        mesh = sharding.lm_mesh((m,), ("model",), "cpu")
    row = tp.Row(mesh, range(m), "cpu")
    trees = [tp.member_params(whole, k, m, "cpu", grad=True)
             for k in range(m)]
    got = lm.vocab_parallel_nll(row, trees, cfg, [x] * m, [tokens] * m)
    got_g = torch.autograd.grad(got, [x] + leaves)
    assert gathered == [(2, 9, 1, 3)]
    _within((got, list(got_g)), (want, list(want_g)), ATOL)


# ------------------------------------------------------ the hand-offs

@pytest.mark.parametrize("m", (2, 3))
def test_row_hand_offs_pass_gradcheck(m):
    with sharding.logical_devices(m, "cpu"):
        mesh = sharding.lm_mesh((m,), ("model",), "cpu")
    row = tp.Row(mesh, range(m), "cpu")
    g = torch.Generator().manual_seed(m)
    parts = [torch.randn(2, 3, dtype=torch.float64, generator=g,
                         requires_grad=True) for _ in range(m)]
    assert torch.autograd.gradcheck(
        lambda *p: torch.stack(tp.row_sum(row, list(p))), parts)
    assert torch.autograd.gradcheck(
        lambda *p: torch.stack(tp.row_gather(row, list(p), -1)), parts)
    assert torch.autograd.gradcheck(
        lambda *p: tp.row_gather(row, list(p), 0, first_only=True)[0], parts)
    assert torch.autograd.gradcheck(lambda t: torch.stack(row.put(t)),
                                    parts[:1])


def test_member_slices_carry_whole_gradients():
    """The differentiable cut of Jamba's params (every kind of leaf: the
    fused [gate | up] and [x | z] halves, rows, columns, replicated):
    under a loss that weighs member k's slices by w_k, the cut of each
    cut leaf's gradient is w_k in place, and each replicated leaf's
    gradient is the sum of the members' w_k."""
    params, m = _params(JAMBA), 2
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    trees = [tp.member_params(params, k, m, "cpu", grad=True)
             for k in range(m)]
    g = torch.Generator().manual_seed(5)
    weights = [[torch.randn(x.shape, generator=g) for x in tree_leaves(tr)]
               for tr in trees]
    total = sum(torch.sum(x * w) for tr, ws in zip(trees, weights)
                for x, w in zip(tree_leaves(tr), ws))
    grads = _tree_like(params, torch.autograd.grad(total, leaves))
    cuts = [tree_leaves(tp.member_params(grads, k, m, "cpu"))
            for k in range(m)]
    n_cut = 0
    for i, (x, gr) in enumerate(zip(leaves, tree_leaves(grads))):
        if tree_leaves(trees[0])[i].shape == x.shape:   # replicated
            assert torch.equal(gr, weights[0][i] + weights[1][i]), i
        else:
            n_cut += 1
            for k in range(m):
                assert torch.equal(cuts[k][i], weights[k][i]), (i, k)
    assert 0 < n_cut < len(leaves)


def _tree_like(tree, leaves):
    it = iter(leaves)
    return sharding.map_with_path(lambda p, x: next(it), tree)


# -------------------------------------------------------- remat, aux

@pytest.mark.parametrize("arch", (GRANITE, RWKV))
def test_remat_changes_no_bit_on_a_model_row(arch):
    cfg, params, b = _cfg(arch), _params(arch), _torch_batch(arch)
    rt = sharding.make_runtime(_mesh((1, 2)))
    runs = []
    for remat in (True, False):
        loss, g = value_and_grad(params, cfg, b, rt=rt, remat=remat)
        runs.append((loss, tree_leaves(g)))
    assert _bit_equal(*runs)


def test_the_moe_aux_term_counts_once_a_replica(monkeypatch):
    """On (1, 2) every member routes every token: only member 0 records
    its statistics and its aux term counts, within AUX_ATOL of the
    unsharded aux; counting every member's statistics (the control)
    counts each layer twice."""
    cfg, params = _cfg(GRANITE), _params(GRANITE)
    tokens = _torch_batch(GRANITE)["tokens"]
    rt = sharding.make_runtime(_mesh((1, 2)))
    n_moe = cfg.n_groups * sum(cfg.layer_is_moe())
    with torch.no_grad():
        _, whole = lm.forward(params, cfg, tokens)
        with moe.route_stats() as seen:
            _, aux = lm.forward(params, cfg, tokens, rt=rt)
        real = moe.route
        monkeypatch.setattr(moe, "route", lambda r, x, k, record=True:
                            real(r, x, k))
        with moe.route_stats() as every:
            lm.forward(params, cfg, tokens, rt=rt)
    assert len(seen) == n_moe and len(every) == 2 * n_moe
    assert abs(float(aux) - float(whole)) <= AUX_ATOL
    assert abs(float(moe.aux_from_stats([seen])) - float(whole)) <= AUX_ATOL
    assert abs(float(moe.aux_from_stats([every])) - float(whole)) > 1e-4


# ------------------------------------------------------- the full step

def _steps(arch, shape, kw, n=2):
    """`n` mesh steps of `arch` on `shape` with step options `kw`: the
    losses and the params after the last, gathered whole."""
    cfg = _cfg(arch)
    rt = sharding.make_runtime(_mesh(shape))
    p = params_from_numpy(_jax_params(arch))
    p = placement.shard_tree(p, sharding.param_shardings(rt, p))
    o = adamw_init(p)
    step = build_train_step(cfg, rt, peak_lr=1e-2, **kw)
    accum = kw.get("accum_steps", 1)
    losses = []
    for s in range(n):
        b = batch_for_step(_cfg(arch, True), s, global_batch=BATCH * accum,
                           seq_len=SEQ)
        if accum > 1:
            b = {k: v.reshape((accum, BATCH) + v.shape[1:])
                 for k, v in b.items()}
        p, o, m = step(p, o, b)
        losses.append(m["loss"])
    return step, (torch.stack(losses), [placement.gather(x)
                                        for x in tree_leaves(p)])


@pytest.mark.parametrize("arch,kw", (
    (GRANITE, {"accum_steps": 2}), (RWKV, {"compress_grads": True})),
    ids=("granite-accum2", "rwkv6-compress"))
def test_step_options_on_a_model_row(arch, kw):
    """`accum_steps=2` (one-row batch shards: 4 rows over 2 replicas of
    2 microbatches) and int8 gradient compression on (2, 2): within ATOL
    of the data-parallel step on (2, 1) with the same options."""
    step, got = _steps(arch, (2, 2), kw)
    assert step.model_row == 2
    _within(got, _steps(arch, (2, 1), kw)[1], ATOL)


def test_enc_dec_trains_data_parallel_on_any_mesh():
    """Seamless trains tensor-parallel over `model` as the decoders do:
    its (2, 2) step runs rows of two members (no note), within ATOL of
    the data-parallel step on (2, 1)."""
    step, got = _steps(SEAMLESS, (2, 2), {}, n=1)
    assert (step.model_row, step.model_row_note) == (2, None)
    _within(got, _steps(SEAMLESS, (2, 1), {}, n=1)[1], ATOL)
