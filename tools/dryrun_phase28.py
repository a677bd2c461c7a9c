"""Phase 28 of `chip_smoke.py` alone, on one NVIDIA GPU.

    python3 tools/dryrun_phase28.py

Calls `chip_smoke.dryrun_phase`, which measures on the card what phases
24 (a), 26 and 27 (d) record for it (`chip_smoke.dryrun_measurements`:
seamless's param and AdamW blocks on (2, 2) and (1, 4), granite's
`TPLayout` and prompt `TPCache` on (1, 4), the peak of seamless's
value-and-grad on (1, 4) and (1, 1)), runs the dry run of the same cells
on the meta device and the dry-run CLI once at full size, and holds them
against each other; it raises on a failed check. Writes
`chiprun_out/dryrun_phase28.json`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import chip_smoke

    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    report = chip_smoke.dryrun_phase(torch.device("cuda"), smi)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "dryrun_phase28.json").write_text(
        json.dumps(report, indent=1, default=str))
    print(f"phase 28 alone: {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
