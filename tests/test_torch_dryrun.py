"""The port's dry run (`launch/specs.py`, `launch/step_analysis.py`,
`launch/dryrun.py`) against the JAX package's on the CPU, and the meta
route of every kernel wrapper (`device.on_cuda`).

The JAX side runs in this process where one device is enough: its specs
and `jax.sharding.AbstractMesh` shard shapes need none, and
`dryrun.build_lowering` compiles on a one-device Auto-axes
`jax.sharding.Mesh`. Its (2, 2) step runs in one subprocess with 8 host
devices (XLA fixes the count when its backend starts), on a
`jax.sharding.Mesh` built here, never through `repro.launch.mesh`, whose
`jax.make_mesh` gives Explicit axes (the cause of the JAX package's own
dry-run test failure). That subprocess and the port's two CLI runs start
with the first test and are read by the last ones.

Bounds: specs, cache shapes and dtypes equal; per-position bytes of param
blocks plus AdamW moments equal to JAX's shard bytes to the byte on both
production meshes; unsharded step FLOPs equal to JAX's `analyze_hlo` dot
FLOPs exactly; the (2, 2) mesh step's FLOPs JAX's per-device count x 4
plus the extra held by `_mesh_extra_flops`; hand-off bytes and counts
equal to an analytic count from the config and JAX's param specs, kind by
kind; meta fields equal; a wrapper on meta gives its plain version's
shapes and dtypes.
"""

import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

jax.devices()   # the backend keeps the devices it starts with (the JAX
_FLAGS = os.environ.get("XLA_FLAGS")   # dry run's import asks for 512)
from repro.configs import ARCH_IDS, SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.configs import shape_applicable  # noqa: E402
from repro.distributed.sharding import _path_str, param_spec  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.models.init import abstract_params  # noqa: E402

if _FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _FLAGS

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs.simgnn_aids import CONFIG as SIMGNN  # noqa: E402
from repro_torch.core import batching  # noqa: E402
from repro_torch.core.gcn import normalized_adjacency  # noqa: E402
from repro_torch.core.simgnn import init_simgnn_params  # noqa: E402
from repro_torch.data.graphs import query_pairs, random_graph  # noqa: E402
from repro_torch.distributed import placement, sharding  # noqa: E402
from repro_torch.kernels import ops, retrieval  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attention  # noqa: E402
from repro_torch.kernels.fused_gcn import fused_gcn_att  # noqa: E402
from repro_torch.kernels.fused_pair import fused_pair_score  # noqa: E402
from repro_torch.kernels.mamba_scan import (  # noqa: E402
    mamba_selective_scan, mamba_selective_scan_state)
from repro_torch.kernels.moe_experts import moe_expert_ffn  # noqa: E402
from repro_torch.kernels.packed_pair import packed_pair_score  # noqa: E402
from repro_torch.kernels.simgnn_head import simgnn_head  # noqa: E402
from repro_torch.kernels.sparse_pair import sparse_pair_score  # noqa: E402
from repro_torch.kernels.wkv6 import wkv6, wkv6_state  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch import step_analysis  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models.init import init_params  # noqa: E402
from repro_torch.train.optimizer import adamw_init  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QWEN, GEMMA, GRANITE = "qwen1.5-4b", "gemma2-9b", "granite-moe-3b-a800m"
#: reduced cells whose unsharded step FLOPs are held to JAX's dot FLOPs:
#: the four of the first comparison, then one cell of the MoE, rwkv,
#: hybrid and enc-dec families (each family's train cell runs its plain
#: scan step by step, which takes the port 10-60 s on meta)
FLOP_CELLS = {(QWEN, "prefill_32k"): 302_252_032,
              (QWEN, "train_4k"): 1_375_731_712,
              (GEMMA, "prefill_32k"): 570_687_488,
              (GEMMA, "decode_32k"): 1_982_464,
              (GRANITE, "decode_32k"): None,
              ("rwkv6-7b", "prefill_32k"): None,
              ("jamba-1.5-large-398b", "decode_32k"): None,
              ("seamless-m4t-large-v2", "decode_32k"): None}
#: the production meshes: (axis sizes, axis names)
PRODUCTION = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}

_JAX_2X2 = r'''
import json, sys
import jax, numpy as np
from repro.launch.dryrun import build_lowering
from repro.launch.hlo_analysis import analyze_hlo
mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                         ("data", "model"))
lowered, _ = build_lowering("qwen1.5-4b", "train_4k", mesh, reduced=True)
print(json.dumps({"per_device_dot_flops":
                  analyze_hlo(lowered.compile().as_text())["dot_flops"]}))
'''


_TP_CACHES = r'''
import json, sys
from repro_torch.distributed import sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import dryrun, step_analysis
from repro_torch.launch.mesh import make_test_mesh
with sharding.logical_devices(4, "meta"):
    mesh = make_test_mesh(2, 2, device="meta")
out = {}
for arch in sys.argv[1:]:
    _, resident, _ = dryrun.build_cell(arch, "decode_32k", mesh)
    cache = resident["cache"]
    whole = {}
    sharding.map_with_path(lambda path, t: whole.__setitem__(
        path, [list(t.shape), str(t.dtype).replace("torch.", "")]),
        tp.gather_caches(cache, "meta"))
    out[arch] = {"rows": [list(r) for r in cache.rows], "whole": whole,
                 "per_position": step_analysis.placed_bytes(cache, 4)}
print(json.dumps(out))
'''


def _env(**kw) -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
                **kw)


class _Jobs:
    """The subprocesses of this file, started together by the first test
    that asks for them."""

    def __init__(self, out: Path):
        self.out = out
        cli = [sys.executable, "-m", "repro_torch.launch.dryrun"]
        self.procs = {
            "jax_2x2": subprocess.Popen(
                [sys.executable, "-c", _JAX_2X2], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
                env=_env(XLA_FLAGS="--xla_force_host_platform_device_count"
                                   "=8")),
            "failure": subprocess.Popen(
                cli + ["--arch", GRANITE, "--shape", "decode_32k", "--mesh",
                       "single", "--out", str(out / "failure")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env()),
            **{f"tp_caches{i}": subprocess.Popen(
                [sys.executable, "-c", _TP_CACHES, *ARCH_IDS[i::3]],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env()) for i in range(3)},
            "sweep": subprocess.Popen(
                cli + ["--reduced", "--arch", QWEN, "--mesh", "both",
                       "--out", str(out / "sweep")],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=_env())}
        self.done: dict = {}

    def result(self, name: str) -> tuple:
        if name not in self.done:
            out, err = self.procs[name].communicate(timeout=600)
            self.done[name] = (self.procs[name].returncode, out, err)
        return self.done[name]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    j = _Jobs(tmp_path_factory.mktemp("dryrun"))
    yield j
    for p in j.procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _cache_sig(tree) -> list:
    """(path, shape, dtype) of a cache tree's leaves, dict keys sorted as
    JAX flattens them (torch tensors or ShapeDtypeStructs)."""
    return [(_path_str(p), tuple(x.shape), _dtype(x)) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _meta_mesh(*shape):
    with sharding.logical_devices(math.prod(shape), "meta"):
        return make_test_mesh(*shape, device="meta")


def _jax_mesh_1x1():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


# ------------------------------------------------------------- the specs

def test_subprocesses_start(jobs):
    """The JAX (2, 2) step and the two CLI runs start first and run while
    the tests below do."""
    assert all(p.pid for p in jobs.procs.values())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match_jax(arch):
    """Every applicable shape at full size: the data arguments' shapes and
    dtypes, and the decode cache's (the port's `cache_specs` leaf for
    leaf with JAX's, in order)."""
    for shape, sh in SHAPES.items():
        if not shape_applicable(jax_get_config(arch), shape)[0]:
            continue
        got, want = S.input_specs(arch, shape), jspecs.input_specs(arch,
                                                                   shape)
        assert sorted(got) == sorted(want), shape
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (shape, k)
            assert _dtype(got[k]) == _dtype(want[k]), (shape, k)
            assert got[k].device.type == "meta"
        if sh["kind"] == "decode":
            b, s = sh["global_batch"], sh["seq_len"]
            assert _cache_sig(S.cache_specs(get_config(arch), b, s)) == \
                _cache_sig(jspecs.cache_specs(jax_get_config(arch), b, s)), \
                shape


# ----------------------------------------------------------- step FLOPs

@pytest.mark.parametrize("cell", sorted(FLOP_CELLS),
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_unsharded_step_flops_equal_jax_dot_flops(cell):
    """Reduced cells on (1, 1): the port's matmul FLOPs of the step as it
    runs (remat recompute included) equal JAX's loop-corrected dot FLOPs
    (`analyze_hlo`) exactly."""
    arch, shape = cell
    lowered, _ = jdryrun.build_lowering(arch, shape, _jax_mesh_1x1(),
                                        reduced=True)
    want = analyze_hlo(lowered.compile().as_text())["dot_flops"]
    if FLOP_CELLS[cell] is not None:
        assert want == FLOP_CELLS[cell]
    got = dryrun.analyze_cell(arch, shape, _meta_mesh(1, 1), reduced=True)
    assert got["step_flops"] == want


def _mesh_extra_flops(cfg, batch: int, seq: int, replicas: int, m: int
                      ) -> int:
    """What the port's mesh step computes beyond the unsharded step on a
    mesh of `replicas` replicas with model rows of `m` members (a dense
    decoder whose layer groups are one layer):
      + each group's remat recompute runs until the last op whose saved
        tensor the backward needs (`torch.utils.checkpoint`'s early stop):
        unsharded that ends before the FFN's down projection; on a row it
        ends before the last member's, so members 0 .. m - 2 run theirs
        again: 2 (batch / replicas) seq (d_ff / m) d_model each;
      - the vocab-parallel loss takes the logits of the positions that
        predict a token (seq - 1), where the unsharded loss makes them
        for all seq and drops the last: 2 batch d_model vocab_padded in
        the forward and twice that in the backward."""
    rows = batch // replicas
    recompute = (replicas * cfg.n_groups * (m - 1)
                 * 2 * rows * seq * (cfg.d_ff // m) * cfg.d_model)
    last = 3 * 2 * batch * cfg.d_model * cfg.vocab_padded
    return recompute - last


def test_mesh_step_flops_are_jax_per_device_times_four_plus_the_extra(jobs):
    """Reduced qwen1.5-4b train_4k on (2, 2): the port's step FLOPs are
    JAX's per-device dot FLOPs x 4 (1,375,731,712, the unsharded count)
    plus `_mesh_extra_flops`: 16,777,216 - 786,432 = 15,990,784."""
    rc, out, err = jobs.result("jax_2x2")
    assert rc == 0, err[-2000:]
    per_device = json.loads(out.strip().splitlines()[-1])[
        "per_device_dot_flops"]
    assert per_device * 4 == FLOP_CELLS[(QWEN, "train_4k")]
    cfg = reduced_config(QWEN)
    got = dryrun.analyze_cell(QWEN, "train_4k", _meta_mesh(2, 2),
                              reduced=True)
    assert got["model_row"] == 2
    extra = _mesh_extra_flops(cfg, 4, 256, 2, 2)
    assert extra == 15_990_784
    assert got["step_flops"] == per_device * 4 + extra


# ---------------------------------------------------------- meta fields

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_meta_fields_and_model_flops_equal_jax(arch):
    """params_total, params_active and model_flops of every shape, as the
    JAX dry run computes them."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    mesh = dryrun.cell_mesh("multi")
    for shape in SHAPES:
        got = dryrun._meta_fields(arch, shape, dryrun.cell_shape(shape),
                                  cfg, mesh)
        want = dict(kind=SHAPES[shape]["kind"],
                    global_batch=SHAPES[shape]["global_batch"],
                    seq_len=SHAPES[shape]["seq_len"],
                    params_total=jcfg.param_count(),
                    params_active=jcfg.active_param_count())
        assert {k: got[k] for k in want} == want
        assert got["n_devices"] == 512 and got["mesh_shape"] == [2, 16, 16]
        assert got["mesh_axes"] == ["pod", "data", "model"]
        assert dryrun.model_flops(got) == jdryrun.model_flops(want)


# ------------------------------------------------------------ hand-offs

def _leaves(cfg):
    """(path, shape, itemsize, spec) of every JAX param leaf."""
    return [(_path_str(p), tuple(x.shape), x.dtype.itemsize,
             param_spec(_path_str(p), x.ndim))
            for p, x in jax.tree_util.tree_flatten_with_path(
                abstract_params(cfg))[0]]


def _split(spec, axis: str) -> bool:
    return any(axis == e or (isinstance(e, tuple) and axis in e)
               for e in spec)


def _train_handoffs(arch: str) -> dict:
    """The hand-offs of a reduced dense decoder's train step on (2, 2):
    replicas at positions 0 and 2 (data 0 and 1), model rows of 2, layer
    groups of one layer (module docstring of `sharding.handoffs`)."""
    jcfg = jax_reduced_config(arch)
    sh = dryrun.cell_shape("train_4k", reduced=True)
    b, t, d = sh["global_batch"], sh["seq_len"], jcfg.d_model
    n_rep, m, n_pos, rows, elt = 2, 2, 4, sh["global_batch"] // 2, 4
    out: dict = {}

    def add(kind, nbytes, count):
        into = out.setdefault(kind, {"bytes": 0, "count": 0})
        into["bytes"] += nbytes
        into["count"] += count

    for _, shape, size, spec in _leaves(jcfg):
        whole = math.prod(shape) * size
        kd = 2 if _split(spec, "data") else 1
        km = 2 if _split(spec, "model") else 1
        block = whole // (kd * km)
        # replica 0 reads every distinct block but its own; replica 1
        # (position 2, data 1) holds one of them only if data splits
        add("gather", block * (kd * km - 1), kd * km - 1)
        remote = kd * km - (1 if kd == 2 else 0)
        add("gather", block * remote, remote)
        add("constrain_grads", block * (n_pos - 1), n_pos - 1)
        add("grad_sum", whole * (n_rep - 1), n_rep - 1)
        cut = whole // m if km == 2 else whole
        for kind in ("param_cut", "param_cut.backward"):
            add(kind, n_rep * (m - 1) * cut, n_rep * (m - 1))
    act = rows * t * d * elt                       # a [rows, T, D] float32
    layers = jcfg.n_layers
    # the embedding's and each layer's mixer and FFN row sums; the remat
    # recompute runs the mixer's again but stops before the FFN's
    fwd, bwd = 1 + 3 * layers, 1 + 2 * layers
    add("row_sum", n_rep * fwd * 2 * (m - 1) * act, n_rep * fwd * 2 * (m - 1))
    add("row_sum.backward", n_rep * bwd * 2 * (m - 1) * act,
        n_rep * bwd * 2 * (m - 1))
    # the vocab-parallel loss: each member's [rows, T - 1, 1, 3] to member 0
    parts = (m - 1) * rows * (t - 1) * 3 * elt
    for kind in ("row_gather", "row_gather.backward"):
        add(kind, n_rep * parts, n_rep * (m - 1))
    return out


def _decode_handoffs(arch: str) -> dict:
    """A reduced decoder's decode step on (2, 2): per replica, the
    embedding's and each layer's mixer and FFN row sums of [rows, 1, D]
    float32, and the logits' gather of [rows, 1, V / m] on member 0."""
    jcfg = jax_reduced_config(arch)
    sh = dryrun.cell_shape("decode_32k", reduced=True)
    n_rep, m, rows = 2, 2, sh["global_batch"] // 2
    calls = 1 + 2 * jcfg.n_layers
    act = rows * jcfg.d_model * 4
    return {"row_sum": {"bytes": n_rep * calls * 2 * (m - 1) * act,
                        "count": n_rep * calls * 2 * (m - 1)},
            "row_gather": {"bytes": n_rep * (m - 1) * rows
                           * (jcfg.vocab_padded // m) * 4,
                           "count": n_rep * (m - 1)}}


@pytest.mark.parametrize("cell", ((QWEN, "train_4k"), (GEMMA, "decode_32k")),
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_handoffs_equal_an_analytic_count(cell):
    arch, shape = cell
    got = dryrun.analyze_cell(arch, shape, _meta_mesh(2, 2), reduced=True)
    want = (_train_handoffs if shape == "train_4k" else
            _decode_handoffs)(arch)
    assert got["handoffs"] == want
    assert got["handoff_bytes"] == sum(v["bytes"] for v in want.values())


def test_handoffs_count_nothing_outside_a_block():
    """With no `handoffs()` block open the hand-off points book nothing."""
    mesh = _meta_mesh(2, 2)
    run, _, _ = dryrun.build_cell(GEMMA, "decode_32k", mesh, reduced=True)
    assert not sharding.handoffs_open()
    run()
    with sharding.handoffs() as moved:
        pass
    assert moved == {}


# --------------------------------------------------------- storage bytes

def _jax_shard_bytes(arch: str, mesh: str) -> int:
    """One device's bytes of params and AdamW m and v: JAX's
    `NamedSharding(AbstractMesh, param_spec).shard_shape` of every leaf."""
    cfg = jax_get_config(arch)
    amesh = jax.sharding.AbstractMesh(*PRODUCTION[mesh])
    opt = np.dtype(cfg.opt_state_dtype).itemsize
    total = 0
    for path, x in jax.tree_util.tree_flatten_with_path(
            abstract_params(cfg))[0]:
        spec = param_spec(_path_str(path), x.ndim)
        n = math.prod(jax.sharding.NamedSharding(amesh, spec)
                      .shard_shape(x.shape))
        total += n * (x.dtype.itemsize + 2 * opt)
    return total


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_storage_bytes_per_position_equal_jax_shards(arch):
    """Full size on (16, 16) and (2, 16, 16): every position holds, of its
    param blocks and AdamW moments (`placement.shard_tree`,
    `adamw_init`), JAX's shard bytes to the byte."""
    cfg = get_config(arch)
    params = init_params(torch.Generator(), cfg, device="meta")
    for mesh_kind in PRODUCTION:
        mesh = dryrun.cell_mesh(mesh_kind)
        rt = sharding.make_runtime(mesh)
        placed = placement.shard_tree(params,
                                      S.param_shardings_abstract(rt, params))
        opt = adamw_init(placed, cfg.opt_state_dtype)
        want = S.opt_state_shardings(rt, placement.tree_shardings(placed))
        assert placement.tree_shardings(opt.m) == want.m
        assert placement.tree_shardings(opt.v) == want.v
        per = step_analysis.placed_bytes([placed, opt.m, opt.v], mesh.size)
        assert per == [_jax_shard_bytes(arch, mesh_kind)] * mesh.size, \
            mesh_kind


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_tp_cache_gathered_whole_has_the_jax_cache_specs(jobs, arch):
    """The decode cell's `TPCache` (the port's own prefill on a (2, 2)
    meta mesh at full size, at decode_32k's batch and cache length; made
    in the subprocesses `_TP_CACHES`, three), gathered whole, has JAX's
    `cache_specs`; the two replicas' rows are the mesh's model rows, and
    every position holds the same bytes of it."""
    rc, out, err = jobs.result(f"tp_caches{ARCH_IDS.index(arch) % 3}")
    assert rc == 0, err[-2000:]
    got = json.loads(out.strip().splitlines()[-1])[arch]
    sh = SHAPES["decode_32k"]
    want = {path: [list(shape), dtype] for path, shape, dtype in _cache_sig(
        jspecs.cache_specs(jax_get_config(arch), sh["global_batch"],
                           sh["seq_len"]))}
    assert got["whole"] == want
    assert got["rows"] == [[0, 1], [2, 3]]
    per = got["per_position"]
    assert len(set(per)) == 1 and per[0] > 0


# ----------------------------------------------------------- the records

def test_cli_records_a_cell_it_cannot_lay_out_and_exits_1(jobs):
    """granite-moe-3b-a800m decode_32k on (16, 16) at full size: its 24
    heads do not split over 16 members of a model row, so the CLI writes
    the error with the cell's meta fields and exits 1 (nothing padded)."""
    rc, out, err = jobs.result("failure")
    assert rc == 1, out[-2000:] + err[-2000:]
    rec = json.loads((jobs.out / "failure" /
                      f"{GRANITE}__decode_32k__single.json").read_text())
    assert "n_heads=24 does not split evenly over 16" in rec["error"]
    assert rec["skipped"] is False and rec["n_devices"] == 256
    assert rec["mesh_shape"] == [16, 16] and rec["kind"] == "decode"


def test_cli_reduced_sweep_writes_the_records_jax_reads(jobs):
    """`--reduced --arch qwen1.5-4b --mesh both`: one record per cell
    under JAX's names, long_500k skipped as JAX skips it, the port's
    fields in place of the HLO's."""
    rc, out, err = jobs.result("sweep")
    assert rc == 0, out[-2000:] + err[-2000:]
    for shape in SHAPES:
        for mesh in ("single", "multi"):
            rec = json.loads((jobs.out / "sweep" /
                              f"{QWEN}__{shape}__{mesh}.json").read_text())
            if shape == "long_500k":
                assert rec["skipped"] and "quadratic" in rec["note"]
                continue
            assert rec["step_flops"] > 0 and rec["handoff_bytes"] > 0
            assert rec["mesh"] == mesh and rec["fits"] is None
            assert rec["memory"]["step_peak_bytes"] > 0
            assert len(rec["memory"]["resident_bytes_per_position"]) == \
                rec["n_devices"]
    rec = json.loads((jobs.out / "sweep" /
                      f"{QWEN}__train_4k__multi.json").read_text())
    assert rec["mesh_axes"] == ["pod", "data", "model"]
    assert rec["model_row"] == 2 and rec["handoffs"]["gather"]["bytes"] > 0


# ------------------------------------------- the kernel wrappers on meta

def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, device) for v in x)
    return x


def _sig(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape), x.dtype
    if isinstance(x, (list, tuple)):
        return type(x)(_sig(v) for v in x)
    return x


@functools.cache
def _wrapper_cases() -> dict:
    """name -> (wrapper, CPU arguments, index of a tensor argument left on
    the CPU for the mixed-device call; None for the `ops` entries, which
    move every array to the device they are given)."""
    p = init_simgnn_params(torch.Generator().manual_seed(0), SIMGNN,
                           device="cpu")
    w = (p["gcn"], p["att"]["w"], p["ntn"], p["fcn"])
    packed, _ = batching.pack_pairs(query_pairs(3, 40), 64,
                                    slots_per_tile=16, with_edges=True,
                                    device="cpu")
    e = packed.edges
    sparse = (e.edges1.senders, e.edges1.weights, e.overflow1.senders,
              e.overflow1.receivers, e.overflow1.weights, packed.labels1,
              packed.mask1, packed.seg1, e.edges2.senders, e.edges2.weights,
              e.overflow2.senders, e.overflow2.receivers, e.overflow2.weights,
              packed.labels2, packed.mask2, packed.seg2, packed.pair_mask)
    dense = (packed.adj1, packed.labels1, packed.mask1, packed.seg1,
             packed.adj2, packed.labels2, packed.mask2, packed.seg2,
             packed.pair_mask)
    rng = np.random.default_rng(6)
    g = batching.pad_graphs([random_graph(rng, n) for n in (5, 9, 12)],
                            SIMGNN.n_node_labels, 16, device="cpu")
    adj = normalized_adjacency(g.adj, g.mask)
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=gen)

    uq, dq = (torch.from_numpy(x) for x in retrieval.collapse_query_ntn(
        p["ntn"], r(5, 32).numpy()))
    scan = (r(2, 5, 6), r(2, 5, 6), r(2, 5, 3), r(2, 5, 3),
            -torch.rand(6, 3, generator=gen), r(6))
    rwkv = (r(2, 5, 3, 4), r(2, 5, 3, 4), r(2, 5, 3, 4),
            torch.rand(2, 5, 3, 4, generator=gen), r(3, 4))
    return {
        "sparse_pair_score": (sparse_pair_score, sparse + w, 0),
        "packed_pair_score": (packed_pair_score, dense + w, 0),
        "fused_pair_score": (fused_pair_score,
                             (adj, g.feats, g.mask, adj, g.feats, g.mask)
                             + w, 0),
        "fused_gcn_att": (fused_gcn_att, (adj, g.feats, g.mask, w[0], w[1]),
                          0),
        "simgnn_head": (simgnn_head, (r(7, 32), r(7, 32), w[2], w[3]), 0),
        "blocked_topm": (lambda q, c: retrieval.blocked_topm(
            q, c, 10, block_cols=32), (r(5, 32), r(137, 32)), 0),
        "blocked_topm_ntn": (lambda u, d, c, f: retrieval.blocked_topm_ntn(
            u, d, c, f, 10, block_cols=32), (uq, dq, r(137, 32), w[3]), 0),
        "flash_attention": (flash_attention, (r(2, 8, 4, 16), r(2, 8, 2, 16),
                                              r(2, 8, 2, 16)), 0),
        "wkv6_state": (wkv6_state, rwkv, 0),
        "wkv6": (wkv6, rwkv, 0),
        "mamba_selective_scan_state": (mamba_selective_scan_state, scan, 0),
        "mamba_selective_scan": (mamba_selective_scan, scan, 0),
        "moe_expert_ffn": (moe_expert_ffn, (r(2, 4, 3, 8), r(4, 8, 10),
                                            r(4, 5, 8)), 0),
        "ops.graph_embeddings_fused": (
            lambda *a: ops.graph_embeddings_fused(p, *a, device=a[0].device),
            (adj, g.feats, g.mask), None),
        "ops.pair_scores_fused": (
            lambda *a: ops.pair_scores_fused(p, *a, device=a[0].device),
            (r(7, 32), r(7, 32)), None),
        "ops.simgnn_pair_score_kernel": (
            lambda *a: ops.simgnn_pair_score_kernel(p, *a,
                                                    device=a[0].device),
            (g.adj, g.feats, g.mask, g.adj, g.feats, g.mask), None),
        "ops.pair_score_megakernel": (
            lambda *a: ops.pair_score_megakernel(p, *a, device=a[0].device),
            (g.adj, g.feats, g.mask, g.adj, g.feats, g.mask), None),
        "ops.pair_score_packed": (
            lambda pk: ops.pair_score_packed(p, pk, device=pk.adj1.device),
            (packed,), None),
        "ops.pair_score_sparse": (
            lambda pk: ops.pair_score_sparse(p, pk, device=pk.adj1.device),
            (packed,), None),
        "ops.pair_score_packed_sharded": (
            lambda pk: ops.pair_score_packed_sharded(
                p, pk, mesh=_tile_mesh(pk.adj1.device)), (packed,), None),
        "ops.pair_score_sparse_sharded": (
            lambda pk: ops.pair_score_sparse_sharded(
                p, pk, mesh=_tile_mesh(pk.adj1.device)), (packed,), None)}


def _tile_mesh(device):
    """A tile mesh of 2 logical devices of `device`'s kind."""
    with sharding.logical_devices(2, device.type):
        return sharding.tile_mesh(2, device.type)


WRAPPERS = ("blocked_topm", "blocked_topm_ntn", "flash_attention",
            "fused_gcn_att", "fused_pair_score", "mamba_selective_scan",
            "mamba_selective_scan_state", "moe_expert_ffn",
            "ops.graph_embeddings_fused", "ops.pair_score_megakernel",
            "ops.pair_score_packed", "ops.pair_score_packed_sharded",
            "ops.pair_score_sparse", "ops.pair_score_sparse_sharded",
            "ops.pair_scores_fused", "ops.simgnn_pair_score_kernel",
            "packed_pair_score", "simgnn_head", "sparse_pair_score", "wkv6",
            "wkv6_state")


@pytest.mark.parametrize("name", WRAPPERS)
def test_kernel_wrapper_on_meta_gives_the_plain_shapes(name):
    """On meta tensors a wrapper runs its plain version, which only
    propagates shapes and dtypes: the CPU call's; mixed meta and CPU
    tensors raise."""
    assert sorted(_wrapper_cases()) == list(WRAPPERS)
    fn, args, i = _wrapper_cases()[name]
    want = _sig(fn(*args))
    got = fn(*_to(args, "meta"))
    assert _sig(got) == want
    for t in (got if isinstance(got, tuple) else (got,)):
        assert t.device.type == "meta"
    if i is None:
        return
    mixed = list(_to(args, "meta"))
    mixed[i] = args[i]
    with pytest.raises(ValueError, match="mixed devices"):
        fn(*mixed)
