"""Wall time of served SimGNN-AIDS pair-scoring requests on one GPU, for
one source tree — run it on two trees in turns in one call to compare them.

    python3 tools/serve_request_time.py SRC_DIR [--rounds 3] [--tag NAME]

SRC_DIR is the `src` directory of a checkout (its `repro_torch` package is
imported from there). The script builds the kernels, then serves, through
`simgnn_query_server(use_kernels=True)` on the auto path with the
threshold rules (`planner="threshold"` where the server takes it), the
AIDS stream `query_pairs(1, 2048)` (packed_sparse) and the average-degree-8
stream `search_pairs(5, 2048, avg_degree=8.0)` (packed_dense) in requests
of 256 pairs, `--rounds` times each after one warm request, and prints
each stream's median, quartiles and min-max request ms (host clock around
each request; the scores come back to the host, so it includes the card)
and one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH = 256
N_PAIRS = 2048


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("src")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_request_time: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs.simgnn_aids import CONFIG
    from repro_torch.core.simgnn import init_simgnn_params
    from repro_torch.data.graphs import query_pairs, search_pairs
    from repro_torch.kernels import build
    from repro_torch.serve.batching import simgnn_query_server

    build.build_all()
    params = init_simgnn_params(torch.Generator().manual_seed(0), CONFIG,
                                device="cuda")
    kw = {}
    if "planner" in inspect.signature(simgnn_query_server).parameters:
        kw["planner"] = "threshold"
    score = simgnn_query_server(params, CONFIG, use_kernels=True, **kw)
    streams = {"aids": query_pairs(1, N_PAIRS),
               "degree 8": search_pairs(5, N_PAIRS, avg_degree=8.0)}
    out = {"tag": args.tag, "src": args.src}
    for name, stream in streams.items():
        score(stream[:BATCH])                          # warm
        walls, paths = [], set()
        for _ in range(args.rounds):
            for i in range(0, N_PAIRS, BATCH):
                t0 = time.perf_counter()
                score(stream[i:i + BATCH])
                walls.append(1e3 * (time.perf_counter() - t0))
                paths.add(score.last_plan.path)
        q = statistics.quantiles(walls, n=4)
        out[name] = {"median_ms": statistics.median(walls),
                     "q1_ms": q[0], "q3_ms": q[2], "min_ms": min(walls),
                     "max_ms": max(walls), "requests": len(walls),
                     "paths": sorted(paths)}
        print(f"{args.tag} {name}: {len(walls)} requests of {BATCH} pairs on "
              f"{sorted(paths)}: median {out[name]['median_ms']:.3f} ms "
              f"(quartiles {q[0]:.3f}-{q[2]:.3f}, range {min(walls):.3f}-"
              f"{max(walls):.3f})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
