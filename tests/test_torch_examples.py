"""The port's examples (`python -m repro_torch.examples.<name>`) against
the JAX package's (`examples/*.py`), on the CPU at small sizes, with the
JAX example's params converted into the port's.

  * quickstart: the plain and kernel-path scores within 1e-6 of the JAX
    example's jnp and Pallas (interpret mode) scores, the loss within
    1e-6, and the printed score lines equal;
  * simgnn_search: the same engine plan and first scores in the pairs
    mode (the reference path and the engine's auto dispatch), the same
    top-k results in the exact and two-stage modes, and an index saved by
    the port loading in the JAX example (and back);
  * serve_lm: the same greedy tokens on the JAX example's prompt;
  * elastic_restart: the same printed lines (steps reached, restored
    step, round-trip difference), unsharded and on a (2, 2) mesh restored
    onto (4, 1), and the checkpoint of step 10 within 1e-5 of the JAX
    example's.

Each port example raises without CUDA unless `--device cpu` is given.
"""

import functools
import importlib.util
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.core.simgnn import init_simgnn_params
from repro.core.simgnn import pair_score as jax_pair_score
from repro.core.simgnn import simgnn_loss as jax_simgnn_loss
from repro.data.graphs import pair_stream as jax_pair_stream
from repro.kernels.ops import simgnn_pair_score_kernel as jax_kernel_score
from repro.models.init import init_params as jax_init_params
from repro_torch.configs.simgnn_aids import CONFIG as CFG
from repro_torch.ckpt import manager as ckpt
from repro_torch.distributed.placement import gather
from repro_torch.examples import (elastic_restart, quickstart, serve_lm,
                                  simgnn_search)
from repro_torch.params import params_from_numpy, tree_leaves

ROOT = Path(__file__).resolve().parents[1]
#: scores of one batch against the JAX package's (the f32 parity bound)
SCORE_ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_example(name, argv, monkeypatch, capsys) -> str:
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    _jax_example(name).main()
    return capsys.readouterr().out


@functools.lru_cache(maxsize=None)
def _jparams():
    return init_simgnn_params(jax.random.PRNGKey(0), CFG)


def _tparams():
    return params_from_numpy(jax.tree.map(np.asarray, _jparams()))


def _line(out: str, prefix: str) -> str:
    found = [ln for ln in out.splitlines() if ln.startswith(prefix)]
    assert len(found) == 1, (prefix, out)
    return found[0]


def _values(line: str) -> list[str]:
    return re.findall(r"'([-0-9.e]+)'", line)


def test_quickstart_matches_jax(monkeypatch, capsys):
    jout = _run_jax_example("quickstart", [], monkeypatch, capsys)
    got = quickstart.main(["--device", "cpu"], params=_tparams())
    tout = capsys.readouterr().out
    batch = next(jax_pair_stream(seed=0, batch=8))
    args = [jnp.asarray(batch[k]) for k in quickstart.DENSE_KEYS]
    want = np.asarray(jax_pair_score(_jparams(), *args))
    want_k = np.asarray(jax_kernel_score(_jparams(), *args))
    np.testing.assert_allclose(got["scores"].numpy(), want, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(got["scores_kernel"].numpy(), want_k, rtol=0,
                               atol=SCORE_ATOL)
    np.testing.assert_array_equal(got["target"], batch["target"])
    want_loss = float(jax_simgnn_loss(_jparams(), {
        k: jnp.asarray(batch[k]) for k in (*quickstart.DENSE_KEYS,
                                           "target")}))
    assert abs(got["loss"] - want_loss) <= SCORE_ATOL
    assert _values(_line(tout, "similarity scores (plain path)")) == \
        _values(_line(jout, "similarity scores (jnp path)"))
    assert _values(_line(tout, "similarity scores (kernel path)")) == \
        _values(_line(jout, "similarity scores (Pallas path)"))
    assert _line(tout, "GED targets") == _line(jout, "GED targets")
    assert _line(tout, "untrained MSE") == _line(jout, "untrained MSE")


SEARCH_PAIRS = (["--queries", "48", "--batch", "24"],
                ["--queries", "48", "--batch", "24", "--kernels"],
                ["--queries", "48", "--batch", "24", "--kernels",
                 "--avg-degree", "6"])


@pytest.mark.parametrize("argv", SEARCH_PAIRS,
                         ids=("reference", "auto", "auto_degree6"))
def test_search_pairs_mode_matches_jax(argv, monkeypatch, capsys):
    jout = _run_jax_example("simgnn_search", argv, monkeypatch, capsys)
    got = simgnn_search.main([*argv, "--device", "cpu"], params=_tparams())
    tout = capsys.readouterr().out
    assert _line(tout, "engine plan") == _line(jout, "engine plan")
    assert _line(tout, "first scores") == _line(jout, "first scores")
    assert got["first_scores"].shape == (24,)


SEARCH_TOPK = (["--topk", "5", "--corpus", "96", "--queries", "48",
                "--batch", "16"],
               ["--topk", "5", "--corpus", "96", "--queries", "48",
                "--batch", "16", "--mode", "two_stage", "--topm", "16"])


@pytest.mark.parametrize("argv", SEARCH_TOPK, ids=("exact", "two_stage"))
def test_search_topk_mode_matches_jax(argv, monkeypatch, capsys):
    jout = _run_jax_example("simgnn_search", argv, monkeypatch, capsys)
    got = simgnn_search.main([*argv, "--device", "cpu"], params=_tparams())
    tout = capsys.readouterr().out
    assert _line(tout, "top results") == _line(jout, "top results")
    if "two_stage" in argv:
        assert _line(tout, "sampled recall") == _line(jout, "sampled recall")
    idx, scores = got["top"]
    assert len(idx) == 5 and np.all(np.diff(scores) <= 0)


def test_search_index_dir_round_trips_with_jax(tmp_path, monkeypatch,
                                               capsys):
    argv = ["--topk", "3", "--corpus", "64", "--queries", "16", "--batch",
            "16", "--index-dir", str(tmp_path)]
    built = simgnn_search.main([*argv, "--device", "cpu"], params=_tparams())
    tout = capsys.readouterr().out
    assert not built["loaded"] and "saved index shards" in tout
    jout = _run_jax_example("simgnn_search", argv, monkeypatch, capsys)
    assert "loaded persisted index" in jout
    assert "(1 shards verified, 0 recovered, 0 rows re-embedded)" in jout
    again = simgnn_search.main([*argv, "--device", "cpu"], params=_tparams())
    tout2 = capsys.readouterr().out
    assert again["loaded"]
    assert _line(tout2, "top results") == _line(tout, "top results") == \
        _line(jout, "top results")


@pytest.mark.parametrize("arch", ("gemma2-9b", "granite-moe-3b-a800m"))
def test_serve_lm_matches_jax(arch, monkeypatch, capsys):
    argv = ["--arch", arch, "--new", "6"]
    jout = _run_jax_example("serve_lm", argv, monkeypatch, capsys)
    cfg = jax_reduced_config(arch)
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0,
                                         cfg.vocab_size))
    got = serve_lm.main([*argv, "--device", "cpu"],
                        params=params_from_numpy(jax.tree.map(np.asarray,
                                                              jp)),
                        prompt=torch.from_numpy(prompt))
    tout = capsys.readouterr().out
    assert tout.splitlines() == jout.splitlines()
    assert got["tokens"].shape == (2, 6)
    assert (got["margins"] >= 0).all()


def _steady(out: str) -> list[str]:
    """The printed lines without the loop's straggler notes (wall-clock
    dependent)."""
    return [ln for ln in out.splitlines()
            if not ln.startswith("[loop] straggler")]


@functools.lru_cache(maxsize=None)
def _elastic_params():
    return jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jax_reduced_config("gemma2-9b")))


@pytest.mark.parametrize("mesh,restore", (("none", "none"), ("2x2", "4x1")))
def test_elastic_restart_matches_jax(mesh, restore, tmp_path, monkeypatch,
                                     capsys):
    mod = _jax_example("elastic_restart")
    monkeypatch.setattr(mod, "CKPT", str(tmp_path / "jax"))
    jout = _run_jax_example("elastic_restart", [], monkeypatch, capsys)
    monkeypatch.setattr(elastic_restart, "init_params",
                        lambda gen, cfg, device=None:
                        params_from_numpy(_elastic_params(), device))
    (p2, o2), (p3, _), _ = elastic_restart.main(
        ["--ckpt-dir", str(tmp_path / "port"), "--mesh", mesh,
         "--restore-mesh", restore, "--device", "cpu"])
    tout = capsys.readouterr().out
    assert _steady(tout) == _steady(jout)
    assert "restored step 10; max param diff after round trip: 0.0e+00" \
        in tout
    want = ckpt.restore(str(tmp_path / "jax"), 10, (p2, o2))
    for a, b in zip(tree_leaves(want), tree_leaves((p2, o2))):
        np.testing.assert_allclose(gather(b).numpy(), gather(a).numpy(),
                                   rtol=0, atol=1e-5)
    if restore != "none":
        assert {x.sharding.mesh.axis_sizes for x in tree_leaves(p3)} == \
            {(4, 1)}


@pytest.mark.parametrize("module", (quickstart, simgnn_search, serve_lm,
                                    elastic_restart),
                         ids=("quickstart", "simgnn_search", "serve_lm",
                              "elastic_restart"))
def test_examples_need_the_card_unless_told_cpu(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default would run")
    argv = (["--topk", "2", "--corpus", "8", "--queries", "2", "--batch",
             "2"] if module is simgnn_search else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)
