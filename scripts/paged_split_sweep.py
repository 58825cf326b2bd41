"""Time the paged decode form at several split counts on one card.

    python scripts/paged_split_sweep.py

For each value of ``SPLIT_BLOCKS_PER_SM`` in ``VALUES`` (swept up, then
down again, so drift shows as a difference between the two passes), the
wrapper (split kernel and combine) runs on the decode cases of
``chip_smoke.kernel_cases`` for f32, int8 and fp8 pages, timed by
``chip_smoke.time_ms`` (device time, L2 flushed) and checked against the
plain version (1e-4).  Prints one JSON line per reading, then the card's
name and power limit.  Card only.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

VALUES = (1, 2, 4, 8, 16)


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    dev = resolve_device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    (k, v, _, hkv), cases = cs.kernel_cases(np)
    pages = cs.paged_pages(torch, k, v)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    decode = [c for c in cases if c[0].startswith("decode")]
    for value in VALUES + VALUES[::-1]:
        pa.SPLIT_BLOCKS_PER_SM = value
        pa.split_plan.cache_clear()
        for case, q_np, table_np, len_np, _ in decode:
            q = torch.from_numpy(q_np).to(dev)
            table = torch.from_numpy(table_np).to(dev)
            lengths = torch.from_numpy(len_np).to(dev)
            splits, per = pa.split_plan(q.shape[0], hkv, table.shape[1], n_sm)
            for code, (kp, vp, ks, vs) in pages.items():
                kernel, plain = cs.paged_fns(ops, q, kp, vp, ks, vs, table,
                                             lengths)
                err = float((kernel() - plain()).abs().max())
                cs.check(err <= cs.KERNEL_TOL, f"{code} {case}: {err}")
                print(json.dumps({
                    "blocks_per_sm": value, "splits": splits, "per": per,
                    "case": case, "pages": code, "max_abs_err": err,
                    "ms": cs.time_ms(torch, kernel, flush)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
