"""Time the flash-attention kernel's tuning knobs on one card.

    python scripts/flash_sweep.py [--source FILE] [--only NAME,...]

Builds ``csrc/flash_attention.cu`` once per entry of ``VARIANTS`` (a
copy with another choice written in by text replacement, which fails
loudly if the source moved on) into ``build/repro_torch/``, prints
nvcc's registers and spills for each head-dim instantiation, then times
each build through the wrapper on ``chip_smoke.FLASH_CASES`` (device
time, ``chip_smoke.time_ms``), checked against the plain version
(1e-4).  The builds are timed in order, then in reverse, so drift shows
as a difference between the two passes.  First it reads the card's
``mma.sync.m16n8k8`` TF32 rate (``MMA_PROBE``: every warp of 132 x 4
blocks of 8 warps issues independent products from registers), the
ceiling of the kernel's route.  ``--source`` builds another copy of the
kernel's source (an earlier design, to time beside this one in one
call); ``--only`` keeps the named variants.  Prints one JSON line per
reading, then the card's name and power limit.  Card only.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (name, (old, new) replacements in the source, held to the plain version
# within 1e-4); the TF32-only build is a timing probe (one product instead
# of three: TF32 accuracy)
VARIANTS = (
    ("as built", (), True),
    ("cvt.rna instruction", ((
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        "  uint32_t r;\n  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : "
        "\"f\"(x));\n  return r;"),), True),
    ("key tile 64 at D<=64", ((
        "  static constexpr int BC = kKeys;",
        "  static constexpr int BC = DP <= 64 ? 64 : kKeys;"),), True),
    ("Q in shared memory above D 96", ((
        "  static constexpr bool QREG = DP <= 128;",
        "  static constexpr bool QREG = DP <= 96;"),), True),
    ("hi*hi only (timing probe)", tuple(
        (f"  for (int n = 0; n < N; ++n) mma_tf32(acc[n], {a}, {b}[n]);",
         "  for (int n = 0; n < 0; ++n) {}")
        for a, b in (("a.lo", "bh"), ("a.hi", "bl"))), False),
)


# independent m16n8k8 TF32 products from registers: ACC accumulators a
# warp, ITERS rounds; the sum of the accumulators is written so that
# nothing is optimised away
MMA_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
constexpr int ACC = 8;
__global__ void mma_probe(float* out, int iters) {
  float d[ACC][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (threadIdx.x + i));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (threadIdx.x - i));
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ACC; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < ACC; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_probe_launch(void* out, int blocks, int threads,
                                int iters, void* stream) {
  mma_probe<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}
"""


def mma_rate(torch, cs, flush):
    """TF32 FLOP/s of mma.sync.m16n8k8 on this card (MMA_PROBE)."""
    from repro_torch.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / "mma_probe.cu"
    src.write_text(MMA_PROBE)
    lib = build.BUILD_DIR / "libmma_probe.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).mma_probe_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, threads, iters = 4 * n_sm, 256, 4096
    out = torch.empty(blocks * threads, device=cs.DEVICE)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        cs.check(fn(out.data_ptr(), blocks, threads, iters, stream) == 0,
                 "mma probe launch")
    ms = cs.time_ms(torch, run, flush, 10, 2)
    flops = blocks * threads // 32 * iters * 8 * 16 * 8 * 8 * 2
    return {"mma_probe": "m16n8k8 tf32, 8 independent accumulators a warp",
            "blocks": blocks, "threads": threads, "ms": ms,
            "tflops": flops / ms / 1e9}


def build_variant(index, edits, source):
    """The source with ``edits`` applied, built into build/repro_torch/."""
    from repro_torch.kernels import build

    # the shared header inlined, so that an edit may reach its helpers
    header = build.CSRC / "tf32_mma.cuh"
    text = source.read_text().replace('#include "tf32_mma.cuh"',
                                      header.read_text())
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{source.name} no longer has {old!r}")
        text = text.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"flash_sweep_{source.stem}_{index}"
    variant = build.BUILD_DIR / f"{stem}.cu"
    variant.write_text(text)
    out = build.BUILD_DIR / f"lib{stem}.so"
    done = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(variant)],
        check=True, capture_output=True, text=True)
    log = done.stdout + done.stderr
    regs = {}
    for dp, body in re.findall(
            r"flash_3xtf32_kernelILi(\d+)E.*?\n(.*?)(?=Compiling entry|\Z)",
            log, re.S):
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        regs[int(dp)] = [int(used.group(1)) if used else None,
                         int(spill.group(1)) if spill else None]
    fn = ctypes.CDLL(str(out)).flash_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs


def main(argv) -> int:
    import argparse

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", type=Path,
                    default=build.CSRC / "flash_attention.cu")
    ap.add_argument("--only", default="")
    args = ap.parse_args(argv)
    variants = [v for v in VARIANTS
                if not args.only or v[0] in args.only.split(",")]
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    print(json.dumps(mma_rate(torch, cs, flush)), flush=True)
    fns = []
    for i, (name, edits, _) in enumerate(variants):
        fn, regs = build_variant(i, edits, args.source)
        fns.append(fn)
        print(json.dumps({"variant": name, "source": args.source.name,
                          "registers_spill_bytes_by_dp": regs}), flush=True)
    rng = np.random.default_rng(4)
    cases = []
    for label, shape, causals in cs.FLASH_CASES:
        b, h, hkv, s, d = (shape[k] for k in ("batch", "heads", "kv_heads",
                                              "seq", "head_dim"))
        q = torch.from_numpy(rng.standard_normal(
            (b, h, s, d), dtype=np.float32)).to(cs.DEVICE)
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, s, d), dtype=np.float32)).to(cs.DEVICE)
            for _ in range(2))
        for causal in causals:
            cases.append((f"{'causal' if causal else 'non-causal'} {label}",
                          q, k, v, causal,
                          ops.ref.flash_attention_ref(q, k, v, causal)))
    order = list(range(len(variants)))
    for i in order + order[::-1]:
        fa._bind = lambda fn=fns[i]: fn
        for case, q, k, v, causal, want in cases:
            def run(q=q, k=k, v=v, causal=causal):
                return ops.flash_attention(q, k, v, causal=causal)
            err = float((run() - want).abs().max())
            cs.check(err <= cs.KERNEL_TOL or not variants[i][2],
                     f"{variants[i][0]} {case}: {err}")
            print(json.dumps({"variant": variants[i][0],
                              "source": args.source.name, "case": case,
                              "max_abs_err": err,
                              "ms": cs.time_ms(torch, run, flush)}),
                  flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
