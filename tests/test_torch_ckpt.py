"""The port's checkpoint manager (`repro_torch.ckpt.manager`) and its
msgpack codec against `repro.ckpt.manager` and `msgpack`, on the CPU.

  * the codec's bytes equal `msgpack.packb`'s on the JAX manager's real
    manifests and on a hypothesis sweep of manifest-shaped values; it
    round-trips, and truncated, garbled or trailing bytes raise
    `MsgpackError`;
  * the port's manifest keys, dtypes and shapes equal the JAX manager's on
    converted (params, AdamW state), 49 keys in JAX's order;
  * cross-restore holds both ways bit for bit, and the port reads a
    JAX-written bfloat16 checkpoint;
  * the JAX manager's checkpoint tests (`tests/test_optim_ckpt.py`,
    `tests/test_store.py`) hold for the port, and `verify_step` /
    `latest_valid_step` report the JAX manager's problem lists for the same
    corruption. Two parts of a problem string are each package's own and
    are masked before the comparison: the checksum hex (npz files carry
    the wall clock, so two saves differ in bytes) and the decoder's
    exception after "manifest unreadable: ".
"""

import os
import re

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from repro.ckpt import manager as jckpt
from repro.core.simgnn import SimGNNConfig as JaxConfig
from repro.core.simgnn import init_simgnn_params
from repro.testing import faults as jfaults
from repro.train.optimizer import adamw_init as jax_adamw_init
from repro_torch.ckpt import manager as ckpt
from repro_torch.ckpt import msgpack_codec as codec
from repro_torch.params import (adamw_state_from_numpy, params_from_numpy,
                                tree_leaves)
from repro_torch.testing import faults
from repro_torch.train.optimizer import AdamWState, adamw_init

hypothesis = pytest.importorskip("hypothesis")
st = pytest.importorskip("hypothesis.strategies")


def _simgnn_trees():
    """(JAX (params, AdamW state), the port's converted copy)."""
    jp = init_simgnn_params(jax.random.PRNGKey(0), JaxConfig())
    js = jax_adamw_init(jp)._replace(step=jnp.asarray(7, jnp.int32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    ts = adamw_state_from_numpy(jax.tree.map(np.asarray, js))
    return (jp, js), (tp, ts)


def _manifest_bytes(d, step):
    with open(os.path.join(d, f"step_{step:09d}", "manifest.msgpack"),
              "rb") as f:
        return f.read()


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as uint8 (bf16 and NaN payloads compared bit for
    bit)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.contiguous().numpy().reshape(-1).view(np.uint8)
    return np.asarray(x).reshape(-1).view(np.uint8)


# ------------------------------------------------------------------ codec

def test_codec_matches_msgpack_on_jax_manifests(tmp_path):
    (jp, js), _ = _simgnn_trees()
    trees = {"simgnn": (jp, js),
             "bf16": {"a": jnp.arange(4, dtype=jnp.bfloat16)},
             "small": {"layer": [{"w": jnp.ones((4, 8)), "b": jnp.zeros(8)}],
                       "step_count": jnp.asarray(7, jnp.int32)}}
    for i, (name, tree) in enumerate(trees.items()):
        d = str(tmp_path / name)
        jckpt.save(d, 10 ** i + 99, tree)
        raw = _manifest_bytes(d, 10 ** i + 99)
        obj = msgpack.unpackb(raw)
        assert codec.packb(obj) == raw, name
        assert codec.unpackb(raw) == obj, name


_SCALAR = (st.none() | st.booleans()
           | st.integers(min_value=-(1 << 63), max_value=(1 << 64) - 1)
           | st.floats(allow_nan=False) | st.text(max_size=300))
_MANIFEST_LIKE = st.recursive(
    _SCALAR,
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=40), kids, max_size=20),
    max_leaves=60)


@hypothesis.settings(max_examples=300, deadline=None)
@hypothesis.given(_MANIFEST_LIKE)
def test_codec_bytes_equal_msgpack_and_round_trip(value):
    raw = msgpack.packb(value)
    assert codec.packb(value) == raw
    assert codec.unpackb(raw) == msgpack.unpackb(raw)
    assert codec.unpackb(codec.packb(value)) == value


@pytest.mark.parametrize("length", (16, 17, 32, 255, 256, 65535, 65536))
def test_codec_container_and_str_sizes(length):
    for value in ("x" * length, [1] * length,
                  {f"k{i}": None for i in range(length)}):
        raw = msgpack.packb(value)
        assert codec.packb(value) == raw
        assert codec.unpackb(raw) == value


def test_codec_nan_and_signed_zero_bits():
    for x in (float("nan"), -0.0, float("inf"), -float("inf"), 5e-324):
        assert codec.packb(x) == msgpack.packb(x)
        assert codec.packb([x]) == codec.packb(codec.unpackb(
            codec.packb([x])))


def test_codec_refuses_float32():
    """msgpack writes float32 only when asked; no manifest holds one."""
    raw = msgpack.packb(1.5, use_single_float=True)
    assert raw[0] == 0xCA
    with pytest.raises(codec.MsgpackError, match="0xca"):
        codec.unpackb(raw)


def test_codec_rejects_truncated_garbled_and_trailing_bytes(tmp_path):
    (jp, js), _ = _simgnn_trees()
    jckpt.save(str(tmp_path), 3, (jp, js))
    raw = _manifest_bytes(str(tmp_path), 3)
    for cut in range(len(raw)):
        with pytest.raises(codec.MsgpackError):
            codec.unpackb(raw[:cut])
    for extra in (b"\x00", raw):
        with pytest.raises(codec.MsgpackError, match="extra data"):
            codec.unpackb(raw + extra)
    for bad in (b"\xc1", b"\xc4\x01x", b"\xd4\x01\x00", b"\x81\x01\x02",
                b"\xa2\xff\xfe"):
        with pytest.raises(codec.MsgpackError):
            codec.unpackb(bad)
    # every single-bit flip either decodes or raises the codec's error
    for at in range(0, len(raw), 7):
        for bit in (0, 7):
            flipped = bytearray(raw)
            flipped[at] ^= 1 << bit
            try:
                codec.unpackb(bytes(flipped))
            except codec.MsgpackError:
                pass


@pytest.mark.parametrize("value", (b"bytes", {1: 2}, {"a": {3}}, object(),
                                   1 << 64, -(1 << 63) - 1))
def test_codec_refuses_types_outside_a_manifest(value):
    with pytest.raises(codec.MsgpackError):
        codec.packb(value)


# ------------------------------------------------------ layout and restore

def test_manifest_keys_dtypes_shapes_equal_jax(tmp_path):
    (jp, js), (tp, ts) = _simgnn_trees()
    jckpt.save(str(tmp_path / "jax"), 7, (jp, js))
    ckpt.save(str(tmp_path / "port"), 7, (tp, ts))
    want = msgpack.unpackb(_manifest_bytes(str(tmp_path / "jax"), 7))
    got = msgpack.unpackb(_manifest_bytes(str(tmp_path / "port"), 7))
    assert list(got) == list(want)
    for key in ("format_version", "keys", "dtypes", "shapes", "step"):
        assert got[key] == want[key], key
    assert list(got["checksums"]) == ["arrays.0.npz"]
    keys = got["keys"]
    assert len(keys) == 49
    assert keys[:2] == ["0/att/w", "0/fcn/0/b"]
    assert keys[keys.index("1/step") + 1] == "1/m/att/w"
    jkeys, _, _ = jckpt._flatten_with_paths((jp, js))
    assert ckpt._flatten_with_paths((tp, ts))[0] == jkeys


def test_arrays_contents_equal_jax(tmp_path):
    (jp, js), (tp, ts) = _simgnn_trees()
    jckpt.save(str(tmp_path / "jax"), 7, (jp, js))
    ckpt.save(str(tmp_path / "port"), 7, (tp, ts))
    paths = [os.path.join(tmp_path, who, "step_000000007", "arrays.0.npz")
             for who in ("jax", "port")]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert a.files == b.files == [str(i) for i in range(49)]
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            assert a[k].tobytes() == b[k].tobytes(), k


def test_jax_writes_port_restores_bit_equal(tmp_path):
    (jp, js), (tp, ts) = _simgnn_trees()
    js = js._replace(m=jax.tree.map(lambda x: x + 0.25, js.m))
    jckpt.save(str(tmp_path), 7, (jp, js))
    zeros = (jax.tree.map(torch.zeros_like, tp),
             adamw_init(jax.tree.map(torch.zeros_like, tp)))
    p, s = ckpt.restore(str(tmp_path), 7, zeros)
    assert isinstance(s, AdamWState)
    assert s.step.dtype == torch.int32 and s.step.shape == () \
        and int(s.step) == 7
    assert list(p) == list(tp)                      # the like's key order
    for a, b in zip(tree_leaves((p, s)), jax.tree.leaves((jp, js))):
        assert a.dtype == torch.from_numpy(np.array(b)).dtype
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_writes_jax_restores_bit_equal(tmp_path):
    (jp, js), (tp, ts) = _simgnn_trees()
    gen = torch.Generator().manual_seed(3)
    tp = jax.tree.map(lambda t: torch.randn(t.shape, generator=gen), tp)
    ts = ts._replace(v=jax.tree.map(torch.rand_like, tp),
                     step=torch.tensor(123, dtype=torch.int32))
    ckpt.save(str(tmp_path), 123, (tp, ts))
    p, s = jckpt.restore(str(tmp_path), 123, (jp, js))
    assert int(s.step) == 123 and s.step.dtype == jnp.int32
    for a, b in zip(jax.tree.leaves((p, s)), tree_leaves((tp, ts))):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_port_reads_a_jax_bf16_checkpoint(tmp_path):
    """JAX's manager writes bf16 leaves as 2-byte void entries under
    "bfloat16"; the port reads them back bit for bit, and writes its own
    bf16 leaves the same way."""
    tree = {"a": jnp.asarray([1.5, -0.0, 3e38, np.nan, 1e-40], jnp.bfloat16),
            "b": jnp.arange(6, dtype=jnp.float32).reshape(2, 3)}
    jckpt.save(str(tmp_path / "jax"), 1, tree)
    man = msgpack.unpackb(_manifest_bytes(str(tmp_path / "jax"), 1))
    assert man["dtypes"] == ["bfloat16", "float32"]
    like = {"a": torch.zeros(5, dtype=torch.bfloat16),
            "b": torch.zeros(2, 3)}
    got = ckpt.restore(str(tmp_path / "jax"), 1, like)
    assert got["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got["a"]), _bits(tree["a"]))
    np.testing.assert_array_equal(got["b"].numpy(), np.asarray(tree["b"]))
    ckpt.save(str(tmp_path / "port"), 1, got)
    assert msgpack.unpackb(_manifest_bytes(str(tmp_path / "port"), 1)) \
        ["dtypes"] == ["bfloat16", "float32"]
    paths = [os.path.join(tmp_path, who, "step_000000001", "arrays.0.npz")
             for who in ("jax", "port")]
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        assert a["0"].dtype.itemsize == b["0"].dtype.itemsize == 2
        assert a["0"].tobytes() == b["0"].tobytes()
    again = ckpt.restore(str(tmp_path / "port"), 1, like)
    np.testing.assert_array_equal(_bits(again["a"]), _bits(tree["a"]))


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layer": [{"w": torch.randn(4, 8, generator=g),
                       "b": torch.zeros(8)}],
            "step_count": torch.tensor(7, dtype=torch.int32)}


def test_restore_casts_to_the_likes_dtype(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    like = jax.tree.map(lambda t: t.to(torch.bfloat16)
                        if t.is_floating_point() else t, _tree(5))
    got = ckpt.restore(str(tmp_path), 1, like)
    assert got["layer"][0]["w"].dtype == torch.bfloat16
    assert torch.equal(got["layer"][0]["w"],
                       _tree()["layer"][0]["w"].to(torch.bfloat16))
    assert got["step_count"].dtype == torch.int32


# ----------------------------------- the JAX manager's checkpoint tests

def test_ckpt_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 100, t)
    restored = ckpt.restore(str(tmp_path), 100, t)
    for a, b in zip(tree_leaves(t), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_ckpt_keep_k_and_latest(tmp_path):
    t = _tree()
    for s in (10, 20, 30, 40):
        ckpt.save(str(tmp_path), s, t, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 40
    assert sorted(os.listdir(tmp_path)) == ["step_000000030",
                                            "step_000000040"]


def test_ckpt_crash_mid_save_ignored(tmp_path):
    """A .tmp directory left by a crash must not be picked up by restart."""
    ckpt.save(str(tmp_path), 10, _tree())
    os.makedirs(tmp_path / "step_000000020.tmp")   # simulated torn write
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_ckpt_orphan_tmp_swept(tmp_path):
    t = _tree()
    orphan = tmp_path / "step_000000005.tmp"
    os.makedirs(orphan / "nested")
    (orphan / "nested" / "arrays.0.npz").write_bytes(b"torn")
    ckpt.save(str(tmp_path), 10, t)
    assert not orphan.exists()
    assert sorted(os.listdir(tmp_path)) == ["step_000000010"]

    os.makedirs(tmp_path / "step_000000099.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 10
    assert not (tmp_path / "step_000000099.tmp").exists()
    # An in-flight save of this process is exempt from the sweep.
    live = str(tmp_path / "step_000000042.tmp")
    os.makedirs(live)
    with ckpt._ACTIVE_LOCK:
        ckpt._ACTIVE_TMPS.add(live)
    try:
        assert ckpt.sweep_orphan_tmps(str(tmp_path)) == []
        assert os.path.isdir(live)
    finally:
        with ckpt._ACTIVE_LOCK:
            ckpt._ACTIVE_TMPS.discard(live)


def test_ckpt_structure_mismatch_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt.restore(str(tmp_path), 1, {"other": torch.zeros(3)})


def test_save_async_snapshots_before_returning(tmp_path):
    t = _tree()
    want = [x.clone() for x in tree_leaves(t)]
    thread = ckpt.save_async(str(tmp_path), 3, t, keep=2)
    t["layer"][0]["w"].add_(1.0)                 # training goes on
    thread.join(timeout=60)
    assert not thread.is_alive()
    got = ckpt.restore(str(tmp_path), 3, _tree())
    for a, b in zip(tree_leaves(got), want):
        assert torch.equal(a, b)


# ---------------------------- corruption: the port against the JAX manager

def _wtree(seed):
    """test_store.py's checkpoint tree, for each package."""
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (4, 8)))
    return ({"w": jnp.asarray(w), "step": jnp.asarray(seed, jnp.int32)},
            {"w": torch.from_numpy(w.copy()),
             "step": torch.tensor(seed, dtype=torch.int32)})


def _chains(tmp_path, steps=(10, 20, 30)):
    """The same three checkpoints written by each package."""
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    for s in steps:
        jt, tt = _wtree(s)
        jckpt.save(dirs["jax"], s, jt)
        ckpt.save(dirs["port"], s, tt)
    return dirs


_HEX = re.compile(r"(manifest|file) [0-9a-f]{8}\.\.")


def _masked(problems):
    """A problem list with each package's own parts masked."""
    out = []
    for p in problems:
        if p.startswith("manifest unreadable: "):
            p = "manifest unreadable: <decoder error>"
        out.append(_HEX.sub(r"\1 <hex>..", p))
    return out


def _masked_walk(result):
    best, skipped = result
    return best, [(s, _masked(p)) for s, p in skipped]


CKPT_FAULTS = [
    ("torn", "arrays.0.npz"), ("bitflip", "arrays.0.npz"),
    ("missing", "arrays.0.npz"), ("torn", "manifest.msgpack"),
    ("stale", "manifest.msgpack"), ("missing", "manifest.msgpack"),
    ("bitflip", "manifest.msgpack")]


@pytest.mark.parametrize("mode,victim", CKPT_FAULTS)
def test_resume_walks_back_past_corrupt_newest(tmp_path, mode, victim):
    """Every fault mode on the newest checkpoint, applied by each package's
    `corrupt_file` to its own chain: the port walks back to the previous
    valid step, refuses the corrupt one, and reports the problems the JAX
    manager reports — on its own chain and on JAX's."""
    dirs = _chains(tmp_path)
    jfaults.corrupt_file(os.path.join(dirs["jax"], "step_000000030", victim),
                         mode)
    faults.corrupt_file(os.path.join(dirs["port"], "step_000000030", victim),
                        mode)
    best, skipped = ckpt.latest_valid_step(dirs["port"])
    assert best == 20 and [s for s, _ in skipped] == [30] and skipped[0][1]
    # the port on JAX's bytes: the JAX manager's report exactly, but for
    # the decoder's own exception text
    on_jax = ckpt.latest_valid_step(dirs["jax"])
    assert _masked_walk(on_jax) == _masked_walk(
        jckpt.latest_valid_step(dirs["jax"]))
    # the same corruption of each package's own chain: the same report
    assert _masked_walk((best, skipped)) == _masked_walk(on_jax)
    # and the JAX manager on the port's bytes
    assert _masked_walk(jckpt.latest_valid_step(dirs["port"])) == \
        _masked_walk((best, skipped))
    if victim.startswith("arrays") or mode != "missing":
        with pytest.raises(ckpt.CheckpointCorrupt) as exc:
            ckpt.restore(dirs["port"], 30, _wtree(30)[1])
        assert exc.value.step == 30 and exc.value.problems == skipped[0][1]
    restored = ckpt.restore(dirs["port"], best, _wtree(0)[1])
    assert torch.equal(restored["w"], _wtree(20)[1]["w"])
    restored = ckpt.restore(dirs["jax"], best, _wtree(0)[1])
    assert torch.equal(restored["w"], _wtree(20)[1]["w"])


def test_resume_walks_back_two_rungs(tmp_path):
    dirs = _chains(tmp_path)
    for fx, d in ((jfaults, dirs["jax"]), (faults, dirs["port"])):
        fx.corrupt_file(os.path.join(d, "step_000000030", "arrays.0.npz"),
                        "bitflip")
        fx.corrupt_file(os.path.join(d, "step_000000020",
                                     "manifest.msgpack"), "torn")
    best, skipped = ckpt.latest_valid_step(dirs["port"])
    assert best == 10 and sorted(s for s, _ in skipped) == [20, 30]
    assert _masked_walk((best, skipped)) == _masked_walk(
        jckpt.latest_valid_step(dirs["jax"]))


def test_resume_all_corrupt_reports_none(tmp_path):
    dirs = _chains(tmp_path, steps=(10,))
    faults.corrupt_file(os.path.join(dirs["port"], "step_000000010",
                                     "arrays.0.npz"), "torn")
    best, skipped = ckpt.latest_valid_step(dirs["port"])
    assert best is None and [s for s, _ in skipped] == [10]


def test_write_seam_stale_ckpt_manifest(tmp_path):
    """The stale fault through the WRITE seam (a replica on newer code
    wrote the checkpoint): verification refuses it, in both packages."""
    d = str(tmp_path)
    with faults.fs_inject("ckpt:manifest", "stale") as plan:
        ckpt.save(d, 5, _tree())
    assert plan.triggered == 1
    problems = ckpt.verify_step(d, 5)
    assert problems == ["unsupported format_version 1001 (expected 1)"]
    assert jckpt.verify_step(d, 5) == problems
    assert ckpt.latest_valid_step(d) == (None, [(5, problems)])


@pytest.mark.parametrize("mode", ("torn", "bitflip", "missing"))
def test_write_seam_damaged_ckpt_arrays(tmp_path, mode):
    d = str(tmp_path)
    with faults.fs_inject("ckpt:arrays", mode) as plan:
        ckpt.save(d, 5, _tree())
    assert plan.triggered == 1
    problems = ckpt.verify_step(d, 5)
    want = ("arrays.0.npz missing" if mode == "missing"
            else "arrays.0.npz checksum mismatch")
    assert len(problems) == 1 and problems[0].startswith(want)
    assert jckpt.verify_step(d, 5) == problems


@pytest.mark.parametrize("mode", ("torn", "bitflip", "missing"))
def test_write_seam_damaged_ckpt_manifest(tmp_path, mode):
    d = str(tmp_path)
    ckpt.save(d, 4, _tree())
    with faults.fs_inject("ckpt:manifest", mode, at_byte=3):
        ckpt.save(d, 5, _tree())
    assert ckpt.latest_valid_step(d)[0] == 4
    assert _masked(ckpt.verify_step(d, 5)) == _masked(jckpt.verify_step(d, 5))


def test_unknown_fault_site_mode_pairs_raise(tmp_path):
    with pytest.raises(ValueError, match="manifest sites"):
        with faults.fs_inject("ckpt:arrays", "stale"):
            ckpt.save(str(tmp_path), 1, _tree())
