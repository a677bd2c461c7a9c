"""How far apart valid float32 runs of rwkv6-7b's training gradients lie,
and whether tensor-parallel training moves them further, on one NVIDIA GPU.

    python3 tools/tp_train_conditioning.py [--tokens T] [--layers L]
        [--f32-only]

rwkv6-7b at full width with L layers (default 4), params from seed 1 in
float32, a batch of 2 x T tokens (`batch_for_step`, seed 31; T default
256): `value_and_grad` of `lm.lm_loss` unsharded and on a (1, 4) mesh
over logical devices of cuda:0 (`chip_smoke.py` phase 27 (b)'s run),
each repeated (bit-equal repeats rule out a race between the members'
streams; run it again under `CUDA_LAUNCH_BLOCKING=1` to see the bits
unchanged with every launch serialized), the unsharded run with the plain
wkv6 in place of the kernel (the floor: another valid float32 order),
and, unless `--f32-only`, the same params in float64 with the plain wkv6
(the kernel is float32) unsharded and on (1, 4), which every float32 run
is held against. Prints, for each pair, the loss, the whole gradient
tree's relative L2 and the leaves that depart most; writes
`chiprun_out/tp_train_conditioning.json` (`..._blocking.json` under
`CUDA_LAUNCH_BLOCKING=1`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--f32-only", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tp_train_conditioning: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.distributed import sharding
    from repro_torch.kernels import build
    from repro_torch.kernels.wkv6 import wkv6_state_plain
    from repro_torch.models import rwkv6 as rwkv_mod
    from repro_torch.models.init import init_params
    from repro_torch.params import params_to, tree_leaves
    from repro_torch.train.step import value_and_grad

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    blocking = os.environ.get("CUDA_LAUNCH_BLOCKING") == "1"
    print(f"card: {smi}; CUDA_LAUNCH_BLOCKING={int(blocking)}; rwkv6-7b, "
          f"{args.layers} layers at full width, 2 x {args.tokens} tokens")
    build.build_all()
    dev = torch.device("cuda")
    cfg = get_config(cs.RWKV_ARCH).with_(n_layers=args.layers,
                                         dtype="float32",
                                         param_dtype="float32")
    params = init_params(torch.Generator().manual_seed(1), cfg, device=dev)
    paths: list = []
    sharding.map_with_path(lambda p, x: paths.append(p), params)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_step(
        cfg, 0, global_batch=2, seq_len=args.tokens, seed=31).items()}
    rt, where = cs._tp_runtime((1, 4))
    plain = [(rwkv_mod, "wkv6_state", wkv6_state_plain)]
    report: dict = {"card": smi, "blocking": blocking, "mesh": where,
                    "tokens": args.tokens, "layers": args.layers}

    def vg(p, c, mesh_rt=None):
        kw = {} if mesh_rt is None else {"rt": mesh_rt}
        loss, g = value_and_grad(p, c, batch, **kw)
        torch.cuda.synchronize()
        return float(loss), tree_leaves(g)

    def held(name, a, b):
        num = den = 0.0
        rows = []
        for path, x, y in zip(paths, a[1], b[1]):
            d = float(torch.linalg.vector_norm(x.double() - y.double()))
            n = float(torch.linalg.vector_norm(y.double()))
            num, den = num + d * d, den + n * n
            rows.append((d / max(n, 1e-300), path))
        rows.sort(reverse=True)
        rel = (num / den) ** 0.5
        report[name] = {"loss": (a[0], b[0]), "grads_rel_l2": rel,
                        "worst": rows[:4]}
        print(f"  {name}: loss {a[0]:.10g} / {b[0]:.10g}; gradient tree "
              f"rel L2 {rel:.3e}; worst leaves " + ", ".join(
                  f"{p} {r:.3e}" for r, p in rows[:4]), flush=True)

    ref64 = None
    if not args.f32_only:
        cfg64 = cfg.with_(dtype="float64", param_dtype="float64")
        p64 = params_to(params, dtype=torch.float64)
        with cs._plain_versions(plain):
            ref64 = vg(p64, cfg64)
            held("float64: (1, 4) vs unsharded", vg(p64, cfg64, rt), ref64)
        del p64
        torch.cuda.empty_cache()
    ref32 = vg(params, cfg)
    held("unsharded again vs unsharded", vg(params, cfg), ref32)
    tp32 = vg(params, cfg, rt)
    held("(1, 4) vs unsharded", tp32, ref32)
    held("(1, 4) again vs (1, 4)", vg(params, cfg, rt), tp32)
    with cs._plain_versions(plain):
        plain32 = vg(params, cfg)
    held("floor: unsharded, plain wkv6 vs the kernel", plain32, ref32)
    if ref64 is not None:
        for name, run in (("unsharded", ref32), ("(1, 4)", tp32),
                          ("unsharded plain wkv6", plain32)):
            held(f"float32 {name} vs float64 unsharded", run, ref64)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"tp_train_conditioning{'_blocking' if blocking else ''}"
           ".json").write_text(
        json.dumps(report, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
