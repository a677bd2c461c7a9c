"""Tensor-parallel enc-dec training (`encdec.encdec_loss` /
`encdec.forward_encdec` with a runtime, the mesh `build_train_step(cfg,
rt)` over `model` for seamless-m4t-large-v2) on the CPU.

Reduced float32 seamless (2 encoder + 2 decoder layers, 4 heads, `d_ff`
128, a 512-column padded vocabulary of 256 ids, tied embeddings), params
converted from the JAX tree with `params_from_numpy`, frames [B, S_ENC,
64] and SEQ target tokens made from a seed with numpy, meshes on logical
CPU devices, one CPU thread (a multithreaded CPU GEMM may split its sums
differently from one call to the next, and the bit-equality tests
compare runs). No JAX subprocess: `jax.value_and_grad` of the unsharded
JAX `encdec_loss` runs in the test process, and the JAX mesh steps of
seamless are `tests/test_torch_lm_mesh.py`'s.

Bounds: the step's mesh value-and-grad on (1, 2), (2, 2), (2, 2, 2) and
(1, 4) within ATOL of the port's unsharded value-and-grad (one replica)
or its data-parallel one on the same data axes; (1, 1) and remat
bit-equal; (1, 2) within JAX_ATOL of the JAX package's gradients; the
training forward's logits within ATOL of unsharded; each member's
differentiable slice of the enc-dec leaves carrying its part of the
whole gradient.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config
from repro.distributed.sharding import Runtime as JaxRuntime
from repro.models import encdec as jencdec
from repro.models.init import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.configs import reduced_config as port_reduced_config
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.launch.train import main as launch
from repro_torch.models import encdec
from repro_torch.params import params_from_numpy, tree_leaves
from repro_torch.train.step import (_mesh_value_and_grad, build_train_step,
                                    value_and_grad)

ARCH = "seamless-m4t-large-v2"
#: (mesh, the mesh of the same data axes with a model axis of one: None
#: for the unsharded value-and-grad)
MESHES = {(1, 2): None, (2, 2): (2, 1), (2, 2, 2): (2, 2, 1), (1, 4): None}
ATOL = 1e-6
JAX_ATOL = 1e-5
BATCH = 4
S_ENC = 16
SEQ = 12


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(jax_side=False):
    return (reduced_config if jax_side else port_reduced_config)(ARCH)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(0),
                                                    _cfg(True)))


def _params():
    return params_from_numpy(_jax_params())


def _batch(batch=BATCH) -> dict:
    """{"frames" [batch, S_ENC, D] float32, "tokens" [batch, SEQ] int32}
    as numpy arrays."""
    rng = np.random.default_rng(batch)
    cfg = _cfg()
    return {"frames": rng.standard_normal(
                (batch, S_ENC, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   (batch, SEQ)).astype(np.int32)}


def _torch_batch(batch=BATCH) -> dict:
    return {k: torch.from_numpy(v) for k, v in _batch(batch).items()}


def _mesh(shape):
    """An LMMesh of `shape` ((data, model) or (pod, data, model)) over
    logical CPU devices."""
    with sharding.logical_devices(int(np.prod(shape)), "cpu"):
        return make_test_mesh(*shape[-2:], multi_pod=len(shape) == 3,
                              device="cpu")


def _vg(shape, batch=BATCH, **kw):
    """(loss, [gradient leaves]) of the batch on a mesh of `shape` through
    the train step's mesh value-and-grad (None: unsharded)."""
    cfg, params, b = _cfg(), _params(), _torch_batch(batch)
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
def test_mesh_value_and_grad_holds_the_data_parallel_one(shape):
    """Every replica's frames and tokens through a model row of the
    `model` axis' size: the loss and every gradient leaf (the encoder's,
    the cross-attention's and `enc_final_norm` included) within ATOL of
    the unsharded value-and-grad or the data-parallel one."""
    assert tp.train_row_size(_cfg(), _mesh(shape)) == (shape[-1], None)
    _within(_vg(shape), _vg(MESHES[shape]), ATOL)


def test_the_full_config_trains_on_rows_of_the_model_axis():
    cfg = get_config(ARCH)
    assert tp.train_row_size(cfg, _mesh((1, 4))) == (4, None)
    assert tp.train_row_size(cfg, _mesh((2, 2))) == (2, None)


def test_a_one_member_mesh_is_bit_equal_to_unsharded():
    """(1, 1) through `encdec_loss` with the runtime (a row of one member
    on its own stream) and through the step: bit for bit."""
    cfg, params, b = _cfg(), _params(), _torch_batch()
    rt = sharding.make_runtime(_mesh((1, 1)))
    want = _vg(None)
    loss, g = value_and_grad(params, cfg, b, rt=rt)
    assert _bit_equal((loss, tree_leaves(g)), want)
    assert _bit_equal(_vg((1, 1)), want)


def test_the_jax_value_and_grad_on_a_model_row():
    """(1, 2): the loss and every gradient leaf within JAX_ATOL of
    `jax.value_and_grad` of the JAX `encdec_loss`, unsharded."""
    cfg, jcfg, b = _cfg(), _cfg(True), _batch(2)
    rt = sharding.make_runtime(_mesh((1, 2)))
    jloss, jg = jax.value_and_grad(lambda p: jencdec.encdec_loss(
        p, jcfg, JaxRuntime(mesh=None),
        {k: jnp.asarray(v) for k, v in b.items()}))(
            jax.tree.map(jnp.asarray, _jax_params()))
    loss, g = value_and_grad(_params(), cfg, {k: torch.from_numpy(v)
                                              for k, v in b.items()}, rt=rt)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=0,
                               atol=JAX_ATOL)
    jleaves, leaves = jax.tree.leaves(jg), tree_leaves(g)
    assert len(jleaves) == len(leaves)
    for a, t in zip(jleaves, leaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=0,
                                   atol=JAX_ATOL)


@pytest.mark.parametrize("shape", ((1, 2), (1, 4)), ids=("1x2", "1x4"))
def test_the_training_forward_on_a_model_row(shape):
    """`forward_encdec(..., rt)`: the logits, gathered along the padded
    vocabulary, within ATOL of the unsharded forward; the pad ids masked
    on every member's columns; the aux term zero (no MoE layer)."""
    cfg, params, b = _cfg(), _params(), _torch_batch()
    rt = sharding.make_runtime(_mesh(shape))
    with torch.no_grad():
        want, _ = encdec.forward_encdec(params, cfg, b["frames"],
                                        b["tokens"])
        got, aux = encdec.forward_encdec(params, cfg, b["frames"],
                                         b["tokens"], rt=rt)
    assert got.shape == want.shape == (BATCH, SEQ, cfg.vocab_padded)
    assert float(aux) == 0.0
    assert bool((got[..., cfg.vocab_size:] == -1e9).all())
    assert float((got - want).abs().max()) <= ATOL


def test_encdec_loss_on_a_mesh_of_several_replicas_raises():
    """The model layer runs one model row; the train step splits the
    batch over replicas (each replica's loss gets its row)."""
    cfg, params, b = _cfg(), _params(), _torch_batch()
    rt = sharding.make_runtime(_mesh((2, 2)))
    with pytest.raises(ValueError, match="2 replicas"):
        encdec.encdec_loss(params, cfg, b, rt=rt)
    with pytest.raises(ValueError, match="build_train_step"):
        encdec.forward_encdec(params, cfg, b["frames"], b["tokens"], rt=rt)


# ------------------------------------------------ the gradients' paths

def test_remat_changes_no_bit_on_a_model_row():
    """Both stacks under `torch.utils.checkpoint` (the encoder's recompute
    enters the row like the decoder's) or not: bit for bit."""
    cfg, params, b = _cfg(), _params(), _torch_batch()
    rt = sharding.make_runtime(_mesh((1, 2)))
    runs = []
    for remat in (True, False):
        loss, g = value_and_grad(params, cfg, b, rt=rt, remat=remat)
        runs.append((loss, tree_leaves(g)))
    assert _bit_equal(*runs)


def test_member_slices_carry_whole_gradients():
    """The differentiable cut of seamless's params (the encoder's blocks,
    the cross-attention, `enc_final_norm`, the tied embedding): under a
    loss that weighs member k's slices by w_k, the cut of each cut leaf's
    gradient is w_k in place, and each replicated leaf's gradient is the
    sum of the members' w_k."""
    params, m = _params(), 2
    paths = list(_paths(params))
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
    cut, whole = set(), set()
    for i, (x, gr) in enumerate(zip(leaves, tree_leaves(grads))):
        if tree_leaves(trees[0])[i].shape == x.shape:   # replicated
            whole.add(paths[i])
            assert torch.equal(gr, weights[0][i] + weights[1][i]), paths[i]
        else:
            cut.add(paths[i])
            for k in range(m):
                assert torch.equal(cuts[k][i], weights[k][i]), (paths[i], k)
    assert "enc_final_norm/scale" in whole and "embed/table" in cut
    for name in ("wq", "wk", "wv", "wo"):
        assert f"enc_groups/0/attn/{name}" in cut
        assert f"groups/0/xattn/{name}" in cut
    assert {"enc_groups/0/mlp/w_in", "enc_groups/0/mlp/w_out"} <= cut


def test_every_member_adds_its_part_to_the_encoders_gradient(monkeypatch):
    """The members' `enc_out` copies feed their cross-attention as they
    stand, so the encoder's gradients carry every member's partial
    d enc_out: detaching member k > 0's copy (the control) leaves the
    encoder's gradients beyond 1e-3 of unsharded, the decoder's within
    ATOL."""
    real = encdec._row_encode

    def detached(row, trees, cfg, frames, **kw):
        outs = real(row, trees, cfg, frames, **kw)
        return [outs[0]] + [e.detach() for e in outs[1:]]

    cfg = _cfg()
    paths = list(_paths(_params()))
    want = _vg(None)
    monkeypatch.setattr(encdec, "_row_encode", detached)
    got = _vg((1, 2))
    enc = [i for i, p in enumerate(paths) if p.startswith("enc_")]
    assert enc and cfg.n_enc_layers == 2
    worst = max(float((got[1][i] - want[1][i]).abs().max()) for i in enc)
    assert worst > 1e-3, worst
    _within((got[0], [got[1][i] for i in range(len(paths)) if i not in enc]),
            (want[0], [want[1][i] for i in range(len(paths))
                       if i not in enc]), ATOL)


def _paths(tree):
    out = []
    sharding.map_with_path(lambda p, x: out.append(p), tree)
    return out


def _tree_like(tree, leaves):
    it = iter(leaves)
    return sharding.map_with_path(lambda p, x: next(it), tree)


# ------------------------------------------------------- the full step

def test_split_dims_name_the_encoders_counts():
    """An enc-dec config whose decoder has no attention or dense FFN
    layer still names the counts its encoder and cross-attention split."""
    cfg = _cfg()
    names = dict(tp._split_dims(cfg))
    assert names == {"vocab_padded": 512, "n_heads": 4, "n_kv_heads": 4,
                     "d_ff": 128}
    mamba = cfg.with_(layer_pattern=("mamba",), moe_period=1, n_experts=4,
                      d_ff_expert=64)
    assert mamba.layer_kinds() == ["mamba"] and all(mamba.layer_is_moe())
    assert {"n_heads", "n_kv_heads", "d_ff"} <= dict(tp._split_dims(mamba)
                                                    ).keys()
    assert tp.unsplit_dim(mamba.with_(d_ff=130), 4) == "d_ff=130"


def test_the_step_and_the_launcher_name_a_row_of_two(capsys):
    """`build_train_step(cfg, rt)` on (2, 2) runs rows of two members
    (no note); the launcher at `--mesh 1x2` prints its row."""
    step = build_train_step(_cfg(), sharding.make_runtime(_mesh((2, 2))))
    assert (step.model_row, step.model_row_note) == (2, None)
    launch(["--model", ARCH, "--reduced", "--steps", "1", "--batch", "2",
            "--seq-len", "16", "--mesh", "1x2", "--device", "cpu"])
    assert "model row: 2 members\n" in capsys.readouterr().out
