"""The port's training path against the JAX package's, on the CPU.

Each backward rule of `repro_torch.kernels.common` (a `torch.autograd.
Function`) is held against `jax.vjp` of the JAX body within 1e-6 in
float32, normwise: |got - want| <= 1e-6 * max(1, max |want|) (a rule's
cotangent sums hundreds of unit-scale terms, whose float32 rounding in
another order is about 1e-7 of their size each), on packed planes with pad
slots, isolated nodes and COO overflow;
`packed_pair_score_grad` / `sparse_pair_score_grad` parameter gradients
within 1e-5 of JAX's; `ScoringEngine.loss_and_grad` on every `TRAIN_PATHS`
entry within 1e-6 (loss) and `GRAD_ATOL_F32` = 1e-5 (each gradient leaf,
tests/test_grad.py) of the JAX engine's, params converted from the JAX
tree; `simgnn_loss` against JAX's and as the engine's autodiff anchor.
Also: the oversize split to the reference, the empty batch,
label-free graphs rejected, accumulation equal to one shot, the power of
two enforced, the train plan's restrictions, and pad slots' exact-zero
cotangents.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.batching import pack_pairs as jpack_pairs
from repro.core.engine import ScoringEngine as JaxEngine
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.kernels import common as jcommon
from repro.kernels import grad as jgrad
from repro_torch.core.batching import pack_pairs
from repro_torch.core.engine import TRAIN_PATHS, ScoringEngine
from repro_torch.core.simgnn import SimGNNConfig
from repro_torch.data.graphs import random_graph
from repro_torch.kernels import common as tcommon
from repro_torch.kernels import grad as tgrad
from repro_torch.params import params_from_numpy
from repro_torch.train.sgf import StandardGradient

CFG = SimGNNConfig()
JCFG = JaxConfig()
#: f32 bound on engine grads (tests/test_grad.py GRAD_ATOL_F32).
GRAD_ATOL_F32 = 1e-5
#: f32 bound on one backward rule against jax.vjp of the JAX body, times
#: max(1, the largest |entry| of the JAX result).
RULE_ATOL = 1e-6


def _rule_close(got, want):
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= RULE_ATOL * scale, (err, scale)


@functools.lru_cache(maxsize=None)
def _jparams():
    return init_simgnn_params(jax.random.PRNGKey(0), JCFG)


def _tparams():
    return params_from_numpy(jax.tree.map(np.asarray, _jparams()), "cpu")


def _by_path(tree, prefix=()):
    """{key path: numpy leaf} of a dict/list tree of either package."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_by_path(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_by_path(v, prefix + (i,)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().float().numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def _assert_tree_close(got, want, atol):
    g, w = _by_path(got), _by_path(want)
    assert set(g) == set(w)
    worst = max(float(np.abs(g[k] - w[k]).max()) for k in w)
    assert worst <= atol, f"max grad err {worst:.2e} > {atol:.0e}"


def _mixed_pairs(seed, n_pairs, max_n=64, avg_degree=None):
    rng = np.random.default_rng(seed)
    return [(random_graph(rng, int(rng.integers(5, max_n + 1)),
                          avg_degree=avg_degree),
             random_graph(rng, int(rng.integers(5, max_n + 1)),
                          avg_degree=avg_degree))
            for _ in range(n_pairs)]


def _isolated_pairs(seed=3, n=6):
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(n):
        g1, g2 = random_graph(rng, 12), random_graph(rng, 9)
        for g in (g1, g2):            # sever one node completely
            g["adj"][0, :] = g["adj"][:, 0] = 0.0
        pairs.append((g1, g2))
    return pairs


def _targets(seed, n):
    return np.random.default_rng(1000 + seed).uniform(0.0, 1.0, n).astype(
        np.float32)


# --------------------------------------------- each backward rule vs jax.vjp


def _packed(case):
    """Port packed planes of one case (both sides stacked) + node width."""
    if case == "isolated":
        pairs, kw = _isolated_pairs(), {}
    elif case == "overflow":                 # D 2 << degree: COO spill
        pairs, kw = _mixed_pairs(4, 8, max_n=32, avg_degree=6.0), {
            "edge_budget": 64 * 2}
    else:
        pairs, kw = _mixed_pairs(7, 7), {"edge_budget": 64 * 4}
    packed, _ = pack_pairs(pairs, 64, slots_per_tile=16, with_edges=True,
                           device="cpu", **kw)
    e = packed.edges

    def cat(a, b):
        return torch.cat([a, b])
    planes = {
        "nbr": cat(e.edges1.senders, e.edges2.senders),
        "nbr_w": cat(e.edges1.weights, e.edges2.weights),
        "ov_snd": cat(e.overflow1.senders, e.overflow2.senders),
        "ov_rcv": cat(e.overflow1.receivers, e.overflow2.receivers),
        "ov_w": cat(e.overflow1.weights, e.overflow2.weights),
        "labels": cat(packed.labels1, packed.labels2),
        "mask": cat(packed.mask1, packed.mask2),
        "seg": cat(packed.seg1, packed.seg2),
    }
    if case == "overflow":
        assert float(planes["ov_w"].abs().sum()) > 0
    return planes, packed.slots_per_tile


def _j(x):
    return jnp.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _vjp_pair(tfn, jfn, t_args, diff, g):
    """(port grads, JAX grads) of <fn(args), g> for the args at `diff`."""
    leaves = [a.clone().requires_grad_(True) if i in diff else a
              for i, a in enumerate(t_args)]
    out = tfn(*leaves)
    got = torch.autograd.grad(out, [leaves[i] for i in diff],
                              torch.from_numpy(g))

    def f(*xs):
        args = [_j(a) for a in t_args]
        for i, x in zip(diff, xs):
            args[i] = x
        return jfn(*args)
    jout, pull = jax.vjp(f, *[_j(t_args[i]) for i in diff])
    _rule_close(out.detach().numpy(), np.asarray(jout))
    want = pull(jnp.asarray(g))
    return [x.numpy() for x in got], [np.asarray(x) for x in want]


CASES = ("main", "isolated", "overflow")


@pytest.mark.parametrize("sym", (False, True))
@pytest.mark.parametrize("case", CASES)
def test_csr_aggregate_backward_matches_jax(case, sym):
    planes, _ = _packed(case)
    rng = np.random.default_rng(len(case))
    gb, n = planes["mask"].shape
    hw = torch.from_numpy(rng.normal(size=(gb, n, 8)).astype(np.float32))
    g = rng.normal(size=(gb, n, 8)).astype(np.float32)
    args = [planes[k] for k in ("nbr", "nbr_w", "ov_snd", "ov_rcv",
                                "ov_w")] + [hw]
    tfn = tcommon.csr_aggregate_block_sym if sym \
        else tcommon.csr_aggregate_block
    jfn = jcommon.csr_aggregate_block_sym if sym \
        else jcommon.csr_aggregate_block
    got, want = _vjp_pair(tfn, jfn, args, (1, 4, 5), g)
    for a, b in zip(got, want):              # d_nbr_w, d_ov_w, d_hw
        _rule_close(a, b)


@pytest.mark.parametrize("kind", ("edge", "overflow"))
@pytest.mark.parametrize("case", CASES)
def test_edge_aggregate_backward_matches_jax(case, kind):
    planes, _ = _packed(case)
    gb, n = planes["mask"].shape
    rng = np.random.default_rng(7 + len(case))
    # the ELL planes as an explicit COO list (receiver = slot % N; pad
    # slots carry weight 0 and point at node 0), or the overflow list
    if kind == "edge":
        d = planes["nbr"].shape[-1] // n
        snd = planes["nbr"].int()
        rcv = torch.arange(n, dtype=torch.int32).repeat(d).expand(
            snd.shape).contiguous()
        w = planes["nbr_w"]
    else:
        snd, rcv, w = (planes[k].int() if k != "ov_w" else planes[k]
                       for k in ("ov_snd", "ov_rcv", "ov_w"))
    hw = torch.from_numpy(rng.normal(size=(gb, n, 8)).astype(np.float32))
    g = rng.normal(size=(gb, n, 8)).astype(np.float32)
    tfn = tcommon.edge_aggregate_block if kind == "edge" \
        else tcommon.overflow_aggregate_block
    jfn = jcommon.edge_aggregate_block if kind == "edge" \
        else jcommon.overflow_aggregate_block
    got, want = _vjp_pair(tfn, jfn, [snd, rcv, w, hw], (2, 3), g)
    for a, b in zip(got, want):              # d_w, d_hw
        _rule_close(a, b)


@pytest.mark.parametrize("case", CASES)
def test_label_gather_backward_matches_jax(case):
    planes, _ = _packed(case)
    labels = planes["labels"].reshape(-1)
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.normal(size=(29, 16)).astype(np.float32))
    g = rng.normal(size=(labels.shape[0], 16)).astype(np.float32)
    got, want = _vjp_pair(tcommon.label_gather, jcommon.label_gather,
                          [w, labels], (0,), g)
    _rule_close(got[0], want[0])


@pytest.mark.parametrize("case", CASES)
def test_segment_att_pool_backward_matches_jax(case):
    planes, p = _packed(case)
    gb, n = planes["mask"].shape
    rng = np.random.default_rng(11)
    h = torch.from_numpy(rng.normal(size=(gb, n, 8)).astype(np.float32))
    h = h * planes["mask"][..., None]
    att_w = torch.from_numpy(
        (rng.normal(size=(8, 8)) / np.sqrt(8)).astype(np.float32))
    g = rng.normal(size=(gb, p, 8)).astype(np.float32)
    got, want = _vjp_pair(
        lambda *a: tcommon.segment_att_pool_block(*a, p),
        lambda *a: jcommon.segment_att_pool_block(*a, p),
        [h, planes["mask"], planes["seg"], att_w], (0, 1, 3), g)
    for a, b in zip(got, want):              # d_h, d_mask, d_att_w
        _rule_close(a, b)
    # pad node slots get exact-zero h cotangents
    assert (got[0][planes["mask"].numpy() == 0] == 0).all()


@pytest.mark.parametrize("seed", range(3))
def test_csr_backward_pad_slots_exactly_zero(seed):
    """Pad ELL slots (weight 0, sender 0) give bit-zero cotangent rows to
    nodes that send no real edge, whatever their stored sender."""
    rng = np.random.default_rng(seed)
    n, d = 4 + 2 * seed, 1 + seed % 3
    live = rng.random((1, n * d)) < 0.5
    nbr = torch.from_numpy(rng.integers(0, n, (1, n * d)).astype(np.int32)
                           * live)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, (1, n * d)).astype(np.float32)
                         * live)
    zeros = torch.zeros((1, 4), dtype=torch.int32)
    hw = torch.from_numpy(rng.normal(size=(1, n, 3)).astype(np.float32))
    hw.requires_grad_(True)
    for fn in (tcommon.csr_aggregate_block, tcommon.csr_aggregate_block_sym):
        out = fn(nbr, w, zeros, zeros, zeros.float(), hw)
        (d_hw,) = torch.autograd.grad(out, hw, torch.ones_like(out))
        if fn is tcommon.csr_aggregate_block:
            real = set(nbr[0][torch.from_numpy(live[0])].tolist())
            for node in range(n):
                if node not in real:
                    assert (d_hw[0, node] == 0).all()


# ----------------------------------------------- packed scorers' gradients


@pytest.mark.parametrize("sparse", (False, True))
@pytest.mark.parametrize("case", ("main", "isolated", "overflow"))
def test_packed_score_grad_matches_jax(case, sparse):
    pairs = {"main": _mixed_pairs(7, 7), "isolated": _isolated_pairs(),
             "overflow": _mixed_pairs(4, 8, max_n=32, avg_degree=6.0)}[case]
    kw = {"edge_budget": 64 * 2} if case == "overflow" else {}
    tpacked, _ = pack_pairs(pairs, 64, slots_per_tile=16,
                            with_edges=sparse, device="cpu", **kw)
    jpacked, _ = jpack_pairs(pairs, 64, slots_per_tile=16,
                             with_edges=sparse, **kw)
    t_arr = tgrad.packed_arrays(tpacked, sparse=sparse)
    j_arr = jgrad.packed_arrays(jpacked, sparse=sparse)
    tfn = tgrad.sparse_pair_score_grad if sparse \
        else tgrad.packed_pair_score_grad
    jfn = jgrad.sparse_pair_score_grad if sparse \
        else jgrad.packed_pair_score_grad
    c = np.random.default_rng(5).normal(
        size=tuple(t_arr[-1].shape)).astype(np.float32)

    def tloss(p):
        return (tfn(p, *t_arr) * torch.from_numpy(c)).sum()
    params = _tparams()
    tl, tg = StandardGradient().value_and_grad(tloss)(params)
    jl, jg = jax.value_and_grad(
        lambda p: jnp.sum(jfn(p, *j_arr) * c))(_jparams())
    assert abs(float(tl) - float(jl)) <= GRAD_ATOL_F32
    _assert_tree_close(tg, jg, GRAD_ATOL_F32)
    scores = tfn(params, *t_arr)
    assert (scores[t_arr[-1] == 0] == 0).all()     # pad slots exact zero


# ------------------------------------------------------------ loss_and_grad


def _both(path, **kw):
    return (JaxEngine(_jparams(), JCFG, path=path, planner="threshold",
                      **kw),
            ScoringEngine(_tparams(), CFG, path=path, device="cpu", **kw))


@pytest.mark.parametrize("batch", (7, 12))
@pytest.mark.parametrize("path", TRAIN_PATHS + ("auto",))
def test_loss_and_grad_matches_jax(path, batch):
    pairs, targets = _mixed_pairs(batch, batch), _targets(batch, batch)
    jeng, teng = _both(path)
    jl, jg = jeng.loss_and_grad(pairs, targets)
    tl, tg = teng.loss_and_grad(pairs, targets)
    assert teng.last_plan.path == jeng.last_plan.path
    assert teng.last_plan.reason == jeng.last_plan.reason
    assert abs(float(tl) - float(jl)) <= 1e-6
    _assert_tree_close(tg, jg, GRAD_ATOL_F32)
    assert tl.dtype == torch.float32
    if teng.last_plan.path != "reference":
        assert teng.last_pack_stats == jeng.last_pack_stats


@pytest.mark.parametrize("path", ("packed_dense", "packed_sparse"))
@pytest.mark.parametrize("case", ("isolated", "overflow"))
def test_loss_and_grad_edge_cases_match_jax(case, path):
    if case == "isolated":
        pairs, kw = _isolated_pairs(), {}
    else:
        pairs, kw = _mixed_pairs(4, 8, max_n=32, avg_degree=6.0), {
            "edge_budget": 64 * 2}
    targets = _targets(4, len(pairs))
    jeng, teng = _both(path, **kw)
    jl, jg = jeng.loss_and_grad(pairs, targets)
    tl, tg = teng.loss_and_grad(pairs, targets)
    assert abs(float(tl) - float(jl)) <= 1e-6
    _assert_tree_close(tg, jg, GRAD_ATOL_F32)


def test_train_oversize_pairs_fall_back_to_reference():
    rng = np.random.default_rng(8)
    pairs = _mixed_pairs(8, 6) + [(random_graph(rng, 90),
                                   random_graph(rng, 20))]
    targets = _targets(8, 7)
    jeng, teng = _both("packed_sparse")
    jl, jg = jeng.loss_and_grad(pairs, targets)
    tl, tg = teng.loss_and_grad(pairs, targets)
    plan = teng.last_plan
    assert len(plan.fit_idx) == 6 and list(plan.over_idx) == [6]
    assert plan.fallback == "reference" and plan.attempts == 2
    assert abs(float(tl) - float(jl)) <= 1e-6
    _assert_tree_close(tg, jg, GRAD_ATOL_F32)
    kinds = [(r.kind, r.path) for r in teng.recorder.records()]
    assert kinds == [("train", "train:packed_sparse"),
                     ("train", "train:reference")]


def test_train_plan_restricted_to_vjp_capable_paths():
    engine = ScoringEngine(_tparams(), CFG, device="cpu")
    plan = engine.plan(_mixed_pairs(5, 12), train=True)
    assert plan.path in TRAIN_PATHS and plan.fallback == "reference"
    assert engine.plan(_mixed_pairs(6, 2), train=True).path == "reference"
    for path in ("bucketed_mega", "two_kernel", "embedding_cache"):
        eng = ScoringEngine(_tparams(), CFG, path=path, device="cpu")
        with pytest.raises(ValueError, match="VJP-capable"):
            eng.loss_and_grad(_mixed_pairs(7, 6), _targets(7, 6))


def test_empty_batch_loss_and_grad():
    engine = ScoringEngine(_tparams(), CFG, device="cpu")
    loss, grads = engine.loss_and_grad([], [])
    assert float(loss) == 0.0
    assert all((v == 0).all() for v in _by_path(grads).values())


def test_label_free_graphs_rejected_in_training():
    pairs = [({"adj": g1["adj"]}, g2) for g1, g2 in _mixed_pairs(10, 6)]
    engine = ScoringEngine(_tparams(), CFG, device="cpu")
    with pytest.raises(ValueError, match="int node labels"):
        engine.loss_and_grad(pairs, _targets(10, 6))


@pytest.mark.parametrize("path", ("packed_dense", "packed_sparse"))
def test_accumulation_chunks_match_single_shot(path):
    pairs, targets = _mixed_pairs(11, 16), _targets(11, 16)
    engine = ScoringEngine(_tparams(), CFG, path=path, device="cpu")
    loss1, grads1 = engine.loss_and_grad(pairs, targets, accum_steps=1)
    tiles = engine.last_pack_stats["n_tiles"]
    loss4, grads4 = engine.loss_and_grad(pairs, targets, accum_steps=4)
    assert engine.last_pack_stats["n_tiles"] == tiles
    assert abs(float(loss1) - float(loss4)) <= 1e-6
    _assert_tree_close(grads4, grads1, 1e-6)
    jeng = JaxEngine(_jparams(), JCFG, path=path, planner="threshold")
    jl, jg = jeng.loss_and_grad(pairs, targets, accum_steps=4)
    assert abs(float(loss4) - float(jl)) <= 1e-6
    _assert_tree_close(grads4, jg, GRAD_ATOL_F32)


@pytest.mark.parametrize("steps", (0, 3, 6))
def test_accum_steps_must_be_power_of_two(steps):
    engine = ScoringEngine(_tparams(), CFG, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        engine.loss_and_grad(_mixed_pairs(12, 8), _targets(12, 8),
                             accum_steps=steps)


def test_clipped_gradient_engine_matches_jax():
    from repro.train.sgf import ClippedGradient as JaxClipped
    from repro_torch.train.sgf import ClippedGradient

    pairs, targets = _mixed_pairs(14, 12), _targets(14, 12)
    jeng = JaxEngine(_jparams(), JCFG, path="packed_sparse",
                     planner="threshold", grad_fn=JaxClipped(1e-3))
    teng = ScoringEngine(_tparams(), CFG, path="packed_sparse",
                         grad_fn=ClippedGradient(1e-3), device="cpu")
    jl, jg = jeng.loss_and_grad(pairs, targets, accum_steps=2)
    tl, tg = teng.loss_and_grad(pairs, targets, accum_steps=2)
    assert abs(float(tl) - float(jl)) <= 1e-6
    _assert_tree_close(tg, jg, GRAD_ATOL_F32)
    assert all(k[-1] == "clip:0.001" for k in teng._train_fns)


def test_simgnn_loss_matches_jax_and_anchors_the_engine():
    """`core.simgnn.simgnn_loss` (one-hot dense batches, plain autograd)
    against the JAX package's value and grads, and the engine's packed
    `loss_and_grad` against it: the independent autodiff anchor."""
    from repro.core.batching import pad_graphs as jpad
    from repro.core.simgnn import simgnn_loss as jloss
    from repro_torch.core.batching import pad_graphs
    from repro_torch.core.simgnn import simgnn_loss

    pairs, targets = _mixed_pairs(15, 9), _targets(15, 9)
    tb = [pad_graphs([p[s] for p in pairs], CFG.n_node_labels, 64,
                     device="cpu") for s in (0, 1)]
    jb = [jpad([p[s] for p in pairs], JCFG.n_node_labels, 64)
          for s in (0, 1)]

    def batch(b, tgt):
        return {"adj1": b[0].adj, "feats1": b[0].feats, "mask1": b[0].mask,
                "adj2": b[1].adj, "feats2": b[1].feats, "mask2": b[1].mask,
                "target": tgt}
    tl, tg = StandardGradient().value_and_grad(simgnn_loss)(
        _tparams(), batch(tb, targets))
    jl, jg = jax.value_and_grad(jloss)(_jparams(),
                                       batch(jb, jnp.asarray(targets)))
    assert abs(float(tl) - float(jl)) <= 1e-6
    _assert_tree_close(tg, jg, GRAD_ATOL_F32)
    engine = ScoringEngine(_tparams(), CFG, path="packed_sparse",
                           device="cpu")
    el, eg = engine.loss_and_grad(pairs, targets)
    assert abs(float(el) - float(tl)) <= GRAD_ATOL_F32
    _assert_tree_close(eg, tg, GRAD_ATOL_F32)
