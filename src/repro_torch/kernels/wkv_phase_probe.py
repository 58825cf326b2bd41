"""Where the wkv-scan kernel's time goes inside a block.

Builds a copy of ``csrc/rwkv_scan.cu`` in which thread 0 of every block
reads ``clock64()`` at each ``__syncthreads()`` and adds the cycles since
the previous one to the phase that just ended, one a step of the kernel:
``state`` (the previous step's partial sums and state update, then the
wait for this step's copies; the set-up), ``scan`` (the warp scans, the
decays and the anchored rows, and the next step's copies issued),
``scores`` (the dots of the step's pairs) and ``products`` (the output
product).  The kernel itself is not changed.  Runs it at rwkv6-3b's
prefill shape (B=8, S=512, H=40, dk=dv=64, chunk 32), checks the copy's outputs
against the unmodified kernel's (within 1e-4 relative), and prints one
JSON line: each phase's share of the summed cycles, cycles per block,
both kernels' times (CUDA events, mean of 20 launches after 3 warm-ups)
and the card's name and power limit as nvidia-smi gives them.

    PYTHONPATH=src python -m repro_torch.kernels.wkv_phase_probe

Needs the card and nvcc.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import build, ops

PHASES = ("state", "scan", "scores", "products")
# the phase each __syncthreads() of the kernel closes, in source order:
# the loop's top (after the wait for the step's copies), then after the
# scans, the scores, the products; the last one follows the loop
SYNC_PHASES = (0, 1, 2, 3, 0)
SHAPE = {"b": 8, "s": 512, "h": 40, "dk": 64, "dv": 64, "chunk": 32}


def instrumented_source() -> str:
    src = (build.CSRC / "rwkv_scan.cu").read_text()
    head = "#include <cuda_runtime.h>\n"
    src = src.replace(head, head + """
__device__ unsigned long long wkv_phase_cycles[4];
extern "C" int wkv_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, wkv_phase_cycles,
                                   sizeof(wkv_phase_cycles));
}
extern "C" int wkv_phase_zero() {
  const unsigned long long zero[4] = {0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(wkv_phase_cycles, zero, sizeof(zero));
}
""", 1)
    start = "  const int bh = blockIdx.x;\n"
    if start not in src:
        raise RuntimeError("rwkv_scan.cu's kernel no longer has the line "
                           "the probe starts its clock at")
    src = src.replace(start, start + "  long long prof_last = clock64(), "
                      "prof_acc[4] = {0, 0, 0, 0};\n", 1)
    body = src.index("rwkv_scan_kernel(")
    parts = src[body:].split("__syncthreads();")
    if len(parts) != len(SYNC_PHASES) + 1:
        raise RuntimeError(f"rwkv_scan.cu has {len(parts) - 1} barriers in "
                           f"its kernel, the probe expects "
                           f"{len(SYNC_PHASES)}")
    out = parts[0]
    for i, (phase, rest) in enumerate(zip(SYNC_PHASES, parts[1:])):
        mark = (f"__syncthreads(); if (tid == 0) {{ const long long now = "
                f"clock64(); prof_acc[{phase}] += now - prof_last; "
                f"prof_last = now; }}")
        if i == len(SYNC_PHASES) - 1:
            mark += (" if (tid == 0) for (int p = 0; p < 4; ++p) "
                     "atomicAdd(&wkv_phase_cycles[p], "
                     "(unsigned long long)prof_acc[p]);")
        out += mark + rest
    return src[:body] + out


def _build():
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = build.BUILD_DIR / "rwkv_scan_phases.cu"
    so = build.BUILD_DIR / "librwkv_scan_phases.so"
    cu.write_text(instrumented_source())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.rwkv_scan_f32.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                                  + [ctypes.c_void_p])
    lib.wkv_phase_read.argtypes = [ctypes.c_void_p]
    return lib


def _time_ms(fn, iters=20):
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    if not torch.cuda.is_available():
        raise SystemExit("the wkv phase probe needs a CUDA card")
    lib = _build()
    b, s, h, dk, dv, chunk = (SHAPE[k] for k in ("b", "s", "h", "dk", "dv",
                                                 "chunk"))
    g = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    r, k, v = randn(b, s, h, dk), randn(b, s, h, dk), randn(b, s, h, dv)
    logw = -randn(b, s, h, dk).exp()
    u, s0 = randn(h, dk), randn(b, h, dk, dv)
    o, s_t = torch.empty_like(v), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream

    def probed():
        err = lib.rwkv_scan_f32(*(t.data_ptr() for t in
                                  (r, k, v, logw, u, s0, o, s_t)),
                                b, s, h, dk, dv, chunk, stream)
        if err:
            raise RuntimeError(f"instrumented launch: cudaError_t {err}")

    def plain_kernel():
        return ops.rwkv_scan(r, k, v, logw, u, s0, chunk=chunk)
    want_o, want_s = plain_kernel()
    probed_ms = _time_ms(probed)
    kernel_ms = _time_ms(plain_kernel)
    if lib.wkv_phase_zero():
        raise RuntimeError("could not zero the phase counters")
    probed()
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * len(PHASES))()
    if lib.wkv_phase_read(cycles):
        raise RuntimeError("could not read the phase counters")
    diff = max(float((o - want_o).abs().max()),
               float((s_t - want_s).abs().max()))
    if diff > 1e-4 * max(1.0, float(want_o.abs().max()),
                         float(want_s.abs().max())):
        raise RuntimeError(f"the instrumented kernel's outputs differ by "
                           f"{diff}")
    total = sum(cycles)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "shape": SHAPE, "nvidia_smi": smi,
        "cycles_per_block": total / (b * h),
        "shares": {p: cycles[i] / total for i, p in enumerate(PHASES)},
        "kernel_ms": kernel_ms, "instrumented_ms": probed_ms,
        "max_abs_diff": diff}))


if __name__ == "__main__":
    main()
