"""Multi-pod dry run — port of `repro.launch.dryrun`.

For every (architecture x input shape x mesh) cell, the port's own step
runs on the meta device over a mesh of logical meta devices
(`sharding.logical_devices(n, "meta")`), with the port's own layout
code: params drawn on meta (`init_params(device="meta")`), laid out by
`param_shardings` (`placement.shard_tree`) with their AdamW moments
(`adamw_init`) for a train step, or cut by `tensor_parallel.tp_layout`
for serving, whose decode cache is the `TPCache` the port's own prefill
makes (a one-token prompt at the cell's cache length: the cache's layout
depends on its length, not on the prompt's). Then `step_analysis.analyze`
runs the step: `build_train_step(cfg, rt)`, or `serve.step.
build_prefill_step` / `build_decode_step` (enc-dec included). One JSON
record per cell lands in `--out` (default `artifacts/dryrun_torch`):

  * the JAX dry run's meta fields, computed the same way: arch, shape,
    kind, global_batch, seq_len, n_devices, mesh_shape, mesh_axes,
    params_total, params_active and model_flops (6 N tokens for a train
    step, 2 N tokens for prefill and decode);
  * `memory`: the resident bytes of each mesh position by category
    (`step_analysis.placed_bytes`), the step's peak of live bytes (the
    most at once over the mesh, each position's most, the unattributed
    most), and each position's bound, resident + its peak + the
    unattributed peak;
  * `step_flops` (matmul FLOPs of the step as it runs, the remat
    recompute included), `handoffs` (bytes and counts by kind) and
    `handoff_bytes`;
  * `fits`: every position's bound within the capacity, the card's
    `total_memory` where a card is present, else `--capacity-bytes`
    (None without one).

A cell the port cannot lay out (an uneven split in `param_shardings`,
`tensor_parallel.check_splits` on a model row) records its error, and
the sweep goes on; nothing is padded or replicated to make it fit. So
does a cell that runs past `--cell-timeout` seconds (a meta run costs
a Python dispatch per operation, and the plain scans and chunked
attention run a loop step per token or chunk). A sweep with any failure
exits 1, as the JAX CLI does. `shape_applicable`
skips are recorded as in the JAX package. `--reduced` runs the reduced
configs at the JAX dry run's reduced shapes on the (2, 2) / (2, 2, 2)
test meshes over 8 logical meta devices; without it the production
meshes (16, 16) / (2, 16, 16) over 512. The JAX CLI's `--save-hlo` has
no counterpart (there is no HLO). `build_cell` also takes an explicit
shape, a dict of the `SHAPES` fields (kind, seq_len, global_batch), and
any mesh.

    python -m repro_torch.launch.dryrun --reduced --arch qwen1.5-4b \\
        --shape train_4k --mesh both
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import time
import traceback
from contextlib import contextmanager

import torch

from repro_torch.configs import (ARCH_IDS, SHAPES, get_config,
                                 reduced_config, shape_applicable)
from repro_torch.distributed import placement, sharding
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.launch import specs as S
from repro_torch.launch import step_analysis
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh
from repro_torch.models.init import init_params
from repro_torch.serve.step import build_decode_step, build_prefill_step
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.step import build_train_step

#: logical meta devices armed for the production meshes and the test ones
PRODUCTION_DEVICES, TEST_DEVICES = 512, 8


def cell_mesh(mesh_kind: str, *, reduced: bool = False):
    """The cell's mesh of logical meta devices: `make_test_mesh(2, 2)`
    with `reduced`, else `make_production_mesh`; "multi" adds the pod
    axis."""
    multi = mesh_kind == "multi"
    n = TEST_DEVICES if reduced else PRODUCTION_DEVICES
    with sharding.logical_devices(n, "meta"):
        if reduced:
            return make_test_mesh(2, 2, multi_pod=multi, device="meta")
        return make_production_mesh(multi_pod=multi, device="meta")


def cell_shape(shape, *, reduced: bool = False) -> dict:
    """{kind, seq_len, global_batch} of a `SHAPES` name or of an explicit
    dict; `reduced` cuts them as the JAX dry run does."""
    sh = dict(SHAPES[shape] if isinstance(shape, str) else shape)
    if reduced:
        sh.update(seq_len=max(256, sh["seq_len"] // 128),
                  global_batch=max(4, sh["global_batch"] // 64))
    return sh


def model_flops(meta) -> float:
    """Analytic useful FLOPs: 6 N_active tokens (train), 2 N_active tokens
    (prefill), 2 N_active a sequence (decode: one token each)."""
    n = meta["params_active"]
    if meta["kind"] == "train":
        return 6.0 * n * meta["global_batch"] * meta["seq_len"]
    if meta["kind"] == "prefill":
        return 2.0 * n * meta["global_batch"] * meta["seq_len"]
    return 2.0 * n * meta["global_batch"]


def _meta_fields(arch, shape, sh, cfg, mesh) -> dict:
    return dict(arch=arch, shape=shape if isinstance(shape, str) else
                "custom", kind=sh["kind"], global_batch=sh["global_batch"],
                seq_len=sh["seq_len"], n_devices=mesh.size,
                mesh_shape=list(mesh.axis_sizes),
                mesh_axes=list(mesh.axis_names),
                params_total=cfg.param_count(),
                params_active=cfg.active_param_count())


def build_cell(arch: str, shape, mesh, *, reduced: bool = False,
               overrides: dict | None = None, cfg=None):
    """(step thunk, resident trees {category: tree}, meta fields) of the
    cell on `mesh` (an `LMMesh` of meta devices): the layout is made here,
    the step runs when the thunk is called. `shape` is a `SHAPES` name or
    a dict of its fields; `cfg` replaces the arch's config."""
    if cfg is None:
        cfg = reduced_config(arch) if reduced else get_config(arch)
    if overrides:
        cfg = cfg.with_(**overrides)
    sh = cell_shape(shape, reduced=reduced)
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    rt = sharding.make_runtime(mesh)
    meta = _meta_fields(arch, shape, sh, cfg, mesh)
    params = init_params(torch.Generator(), cfg, device="meta")
    data = S.step_inputs(cfg, kind, b, s)
    if kind == "train":
        placed = placement.shard_tree(
            params, S.param_shardings_abstract(rt, params))
        del params
        opt_state = adamw_init(placed, cfg.opt_state_dtype)
        step = build_train_step(cfg, rt)
        meta["model_row"] = step.model_row
        meta["model_row_note"] = step.model_row_note
        return (lambda: step(placed, opt_state, data),
                {"params": placed, "opt_state": opt_state,
                 "inputs": data}, meta)
    layout = tp.serving_layout(params, cfg, rt)
    del params
    meta["model_row"] = layout.model_size
    prefill = build_prefill_step(cfg, rt)
    if kind == "prefill":
        cache_len = S.dec_len(cfg, s) if cfg.is_enc_dec else s
        if cfg.is_enc_dec:
            def run():
                return prefill(layout, data["frames"], data["tokens"],
                               cache_len=cache_len)
        else:
            def run():
                return prefill(layout, data["tokens"], data.get("embeds"),
                               cache_len=cache_len)
        return run, {"params": layout, "inputs": data}, meta
    # decode: the cache of the port's own prefill of one token (and, for
    # enc-dec, one frame), at the cell's length
    tok = torch.empty((b, 1), dtype=S.I32, device="meta")
    decode = build_decode_step(cfg, rt)
    if cfg.is_enc_dec:
        frame = torch.empty((b, 1, cfg.d_model), dtype=S.BF16, device="meta")
        caches = prefill(layout, frame, tok, cache_len=s)[2]

        def run():
            return decode(layout, data["token"], data["enc_out"], caches,
                          data["cache_pos"])
    else:
        caches = prefill(layout, tok, cache_len=s)[1]

        def run():
            return decode(layout, data["token"], caches, data["cache_pos"])
    return run, {"params": layout, "cache": caches, "inputs": data}, meta


def capacity_bytes(given: int | None = None) -> int | None:
    """A device's memory: the card's `total_memory` where one is present,
    else `given`."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return given


def analyze_cell(arch: str, shape, mesh, *, reduced: bool = False,
                 overrides: dict | None = None, cfg=None,
                 capacity: int | None = None) -> dict:
    """The record of one cell on `mesh` (module docstring), without the
    cell's mesh name and timings."""
    t0 = time.perf_counter()
    run, resident, meta = build_cell(arch, shape, mesh, reduced=reduced,
                                     overrides=overrides, cfg=cfg)
    t1 = time.perf_counter()
    got = step_analysis.analyze(run, mesh.size)
    n = mesh.size
    held = {k: step_analysis.placed_bytes(v, n) for k, v in resident.items()}
    per = [sum(v[i] for v in held.values()) for i in range(n)]
    bound = [r + p + got["unattributed_peak_bytes"]
             for r, p in zip(per, got["peak_bytes_by_position"])]
    return dict(
        meta, build_s=round(t1 - t0, 3), run_s=round(got["seconds"], 3),
        memory={"resident_bytes": held,
                "resident_bytes_per_position": per,
                "step_peak_bytes": got["peak_bytes"],
                "step_peak_bytes_by_position": got["peak_bytes_by_position"],
                "step_unattributed_peak_bytes":
                    got["unattributed_peak_bytes"],
                "device_bytes_bound": bound,
                "max_device_bytes_bound": max(bound),
                "capacity_bytes": capacity},
        fits=None if capacity is None else max(bound) <= capacity,
        step_flops=got["flops"], model_flops=model_flops(meta),
        handoffs=got["handoffs"], handoff_bytes=got["handoff_bytes"])


def run_cell(arch: str, shape: str, mesh_kind: str, out_dir: str, *,
             reduced: bool = False, overrides: dict | None = None,
             tag: str = "", capacity: int | None = None) -> dict:
    """Dry-run one cell and write its record (a skip record where
    `shape_applicable` rules the shape out)."""
    cfg = reduced_config(arch) if reduced else get_config(arch)
    ok, note = shape_applicable(cfg, shape)
    cell_id = cell_name(arch, shape, mesh_kind, tag)
    if not ok:
        rec = dict(arch=arch, shape=shape, mesh=mesh_kind, skipped=True,
                   note=note)
        _write(out_dir, cell_id, rec)
        print(f"[dryrun] SKIP {cell_id}: {note}")
        return rec
    mesh = cell_mesh(mesh_kind, reduced=reduced)
    rec = dict(analyze_cell(arch, shape, mesh, reduced=reduced,
                            overrides=overrides, capacity=capacity),
               mesh=mesh_kind, skipped=False)
    _write(out_dir, cell_id, rec)
    mem = rec["memory"]
    print(f"[dryrun] OK {cell_id}: run={rec['run_s']}s "
          f"step_flops={rec['step_flops']:.3e} "
          f"model_flops={rec['model_flops']:.3e} "
          f"handoff_GB={rec['handoff_bytes'] / 1e9:.2f} "
          f"max_device_GB={mem['max_device_bytes_bound'] / 1e9:.2f} "
          f"fits={rec['fits']}")
    return rec


def cell_name(arch: str, shape: str, mesh_kind: str, tag: str = "") -> str:
    return f"{arch}__{shape}__{mesh_kind}" + (f"__{tag}" if tag else "")


def _write(out_dir: str, cell_id: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, cell_id + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


@contextmanager
def _time_limit(seconds: int | None):
    """TimeoutError in the `with` block once `seconds` have passed (no
    limit for None)."""
    if not seconds:
        yield
        return

    def expire(signum, frame):
        raise TimeoutError(f"the cell ran past --cell-timeout {seconds} s")

    before = signal.signal(signal.SIGALRM, expire)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)


def _error_meta(arch, shape, mesh_kind, reduced, overrides) -> dict:
    """The meta fields of a cell that failed (its arch and shape alone
    where even those cannot be made)."""
    try:
        cfg = reduced_config(arch) if reduced else get_config(arch)
        if overrides:
            cfg = cfg.with_(**overrides)
        return _meta_fields(arch, shape, cell_shape(shape, reduced=reduced),
                            cfg, cell_mesh(mesh_kind, reduced=reduced))
    except Exception:
        return dict(arch=arch, shape=shape)


def _value(v: str):
    """A `--set` value: int, float, bool or the string itself."""
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    if v in ("true", "True", "false", "False"):
        return v in ("true", "True")
    return v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=[None, *ARCH_IDS])
    ap.add_argument("--shape", default=None, choices=[None, *SHAPES])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced configs and shapes on the (2, 2) test "
                         "meshes over 8 logical meta devices")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    help="config override field=value (int/float/bool), "
                         "e.g. --set moe_use_kernel=true")
    ap.add_argument("--tag", default="",
                    help="record name suffix for variant runs")
    ap.add_argument("--capacity-bytes", type=int, default=None,
                    help="a device's memory for `fits` where no card is "
                         "present")
    ap.add_argument("--cell-timeout", type=int, default=None,
                    help="seconds a cell may run before it is recorded as "
                         "a failure and the sweep goes on")
    args = ap.parse_args(argv)
    overrides = dict((k, _value(v)) for k, v in
                     (kv.split("=", 1) for kv in args.set))
    capacity = capacity_bytes(args.capacity_bytes)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mk in meshes:
                cell = cell_name(arch, shape, mk, args.tag)
                path = os.path.join(args.out, cell + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[dryrun] cached {cell}")
                    continue
                try:
                    with _time_limit(args.cell_timeout):
                        run_cell(arch, shape, mk, args.out,
                                 reduced=args.reduced, overrides=overrides,
                                 tag=args.tag, capacity=capacity)
                except Exception as e:  # record and continue the sweep
                    failures.append((cell, repr(e)))
                    _write(args.out, cell, dict(
                        _error_meta(arch, shape, mk, args.reduced,
                                    overrides),
                        mesh=mk, skipped=False, error=repr(e),
                        trace=traceback.format_exc()[-4000:]))
                    print(f"[dryrun] FAIL {cell}: {e}")
    if failures:
        print(f"[dryrun] {len(failures)} failures:")
        for c, e in failures:
            print("  ", c, e)
        raise SystemExit(1)
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
