"""f32 GEMM time by row count on the card: where cuBLAS's choice for few
rows turns slow.

    python scripts/small_gemm_probe.py

For each weight shape [K, N] (the RAG demo's 2-layer model of width 128:
q/o 128 x 128, k/v 128 x 64, gate/up 128 x 256, down 256 x 128; and
full-width granite-3-2b's: 2048 x 2048, 2048 x 512, 2048 x 8192, 8192 x
2048) and each row count M, the time of ``x @ w`` (x [1, M, K], the
serving code's form) with TF32 off, as the port runs f32: 50 calls under
``torch.profiler`` after 20 to warm up, the device time a call and the
kernels cuBLAS ran.  Prints one JSON line a shape, then the card's name
and power limit.  Card only.
"""
from __future__ import annotations

import json
import subprocess
import sys


SHAPES = [(128, 128), (128, 64), (128, 256), (256, 128),
          (2048, 2048), (2048, 512), (2048, 8192), (8192, 2048)]
ROWS = [1, 2, 4, 8, 16, 24, 32, 64, 128]


def device_us(torch, fn, n=50, warm=20):
    """(device us a call, {kernel: calls a call}) of ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, kernels = 0.0, {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us += (getattr(e, "self_device_time_total", None)
               or getattr(e, "self_cuda_time_total", 0))
        kernels[e.key[:70]] = e.count / n
    return us / n, kernels


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("small_gemm_probe: needs a card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for k, n in SHAPES:
        w = torch.randn(k, n, device="cuda", generator=g)
        row, picks = {}, {}
        for m in ROWS:
            x = torch.randn(1, m, k, device="cuda", generator=g)
            row[m], picks[m] = device_us(torch, lambda: x @ w)
        print(json.dumps({"k": k, "n": n, "us_by_rows": row,
                          "kernels_by_rows": picks}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
