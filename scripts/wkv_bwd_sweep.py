"""Time the wkv backward against builds of ``csrc/rwkv_scan_bwd.cu`` with
one part of its work taken out (or one choice changed), on one card.

    python scripts/wkv_bwd_sweep.py [--rounds N] [--batch B ...]
                                    [--only NAME ...]

Each variant is the source with a few lines replaced (``VARIANTS``);
"as built" computes the function (it is checked against the plain
version, 1e-4 x max(1, max |plain|)), and so does every variant marked
as a design choice; the others time what is left when a part is skipped
(a pass alone, a phase of the chunk pass removed), so the differences
say what that part costs at rwkv6-3b's training shapes (S=512, H=40,
dk=dv=64, chunk 32; B = 4 and 8 by default).  The variants run in turns,
``--rounds`` times (default 2, the order reversed every other round),
each timed by ``chip_smoke.time_ms``.  Prints ptxas's registers and
spills and the chunk kernel's blocks an SM for each build, one JSON line
a reading, then the card's name and power limit.  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

CHUNK_LAUNCH = ("  chunk_kernel<<<(unsigned)(b * h) * (unsigned)(seq / step), "
                "kThreads, smem_chunk, s>>>(a);\n")
STATE_LAUNCH = ("  state_kernel<<<(unsigned)(b * h) * n_rb, state_threads(dv), "
                "smem_state, s>>>(a);\n")
DU_LAUNCH = ("  rwkv_scan_bwd_du_kernel<<<dim3((unsigned)h, (unsigned)((dk + 31) "
             "/ 32)), dim3(32, kDuRows), 0,\n                            s>>>(a);\n")

# the chunk kernel with clock64() read at its start, after each of its four
# barriers and at its end by thread 0, written over the block's du share
# (ws: six 64-bit stamps as twelve words, then the SM's id)
PROBE = (
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n",
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n"
     "  long long stamp[6];\n  stamp[0] = clock64();\n"),
    ("the rows (G may be in flight)\n  __syncthreads();\n",
     "the rows (G may be in flight)\n  __syncthreads();\n  stamp[1] = clock64();\n"),
    ("   // G\n  __syncthreads();\n",
     "   // G\n  __syncthreads();\n  stamp[2] = clock64();\n"),
    ("      RS[i] = acc;\n    }\n  }\n  __syncthreads();\n",
     "      RS[i] = acc;\n    }\n  }\n  __syncthreads();\n  stamp[3] = clock64();\n"),
    ("        if (q == 0) KD[i] = kd;\n      }\n    }\n  }\n  __syncthreads();\n",
     "        if (q == 0) KD[i] = kd;\n      }\n    }\n  }\n  __syncthreads();\n"
     "  stamp[4] = clock64();\n"),
    ("    a.ws[((size_t)bh * n_steps + c) * dk + i] = du;\n  }\n}\n",
     "    a.ws[((size_t)bh * n_steps + c) * dk + i] = du;\n  }\n  __syncthreads();\n"
     "  stamp[5] = clock64();\n  if (tid == 0) {\n"
     "    float* o = a.ws + ((size_t)bh * n_steps + c) * dk;\n"
     "    for (int x = 0; x < 6; ++x) {\n"
     "      o[2 * x] = __int_as_float((int)(stamp[x] & 0xffffffffLL));\n"
     "      o[2 * x + 1] = __int_as_float((int)(stamp[x] >> 32));\n    }\n"
     "    unsigned sm;\n    asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "    o[12] = __int_as_float((int)sm);\n  }\n}\n"),
)
# appended to every build: the chunk kernel's blocks an SM at a shape, as
# the card's occupancy query gives them (or minus a cudaError_t)
OCCUPANCY = ('}  // extern "C"', '''\
int sweep_chunk_blocks_per_sm(int dk, int dv, int step) {
  const bool mma = chunk_mma(dk, dv, step);
  const size_t smem = sizeof(float) * (size_t)ChunkLayout(step, dk, dv, mma).total;
  auto kernel = mma ? rwkv_scan_bwd_chunk_kernel<64, 64, true>
                    : rwkv_scan_bwd_chunk_kernel<0, 0, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return err == cudaSuccess ? n : -(int)err;
}

}  // extern "C"''')
PHASES = ("loads and cumulative sums", "scores and dP", "products",
          "pair sums", "column pass")

# (name, computes the function, [(old, new), ...]) on csrc/rwkv_scan_bwd.cu
VARIANTS = (
    ("as built", True, []),
    ("state pass alone", False, [(CHUNK_LAUNCH, ""), (DU_LAUNCH, "")]),
    ("chunk pass alone", False, [(STATE_LAUNCH, ""), (DU_LAUNCH, "")]),
    ("du alone", False, [(STATE_LAUNCH, ""), (CHUNK_LAUNCH, "")]),
    ("state: no cumulative sums", False, [
        ("    if (l < 0 || l >= rows) return;",
         "    if (l >= -1) return;")]),
    ("state: no stores", False, [
        ("        *reinterpret_cast<float4*>(dst + (size_t)x * dv) = g[x];",
         "        if (c < 0) *reinterpret_cast<float4*>(dst + (size_t)x * dv) = g[x];")]),
    ("chunk: no cumulative sums", False, [
        ("    for (int i0 = 0; i0 < dk; i0 += kThreads / QC) {",
         "    for (int i0 = 0; i0 < 0; i0 += kThreads / QC) {")]),
    ("chunk: no scores / dP", False, [
        ("for (int q0 = 0; q0 < n_items; q0 += kThreads) {",
         "for (int q0 = 0; q0 < 0; q0 += kThreads) {")]),
    ("chunk: no products", False, [
        ("  if constexpr (MMA) {\n    // m16n8k8",
         "  if constexpr (false) {\n    // m16n8k8"),
        ("    for (int item = tid; item < n_v + 2 * n_k; item += kThreads) {",
         "    for (int item = tid; item < 0; item += kThreads) {")]),
    ("chunk: no pair sums", False, [
        ("          if (s < t) {\n            const float p = DP[t * lda + s] *",
         "          if (s < 0) {\n            const float p = DP[t * lda + s] *")]),
    ("chunk: no column pass", False, [
        ("  for (int i = tid; i < dk; i += kThreads) {\n    const float ui",
         "  for (int i = tid; i < 0; i += kThreads) {\n    const float ui")]),
    ("chunk: phase probe", False, list(PROBE)),
    ("state: five blocks an SM (fewer registers)", True, [
        ("__launch_bounds__(DV ? kRows / 4 * (DV / 4) + 32 : 1024)",
         "__launch_bounds__(DV ? kRows / 4 * (DV / 4) + 32 : 1024, DV ? 5 : 1)"),
        ("#pragma unroll\n      for (int t = 0; t < kMaxStep; ++t) {\n        if (t < L) {\n"
         "          const float4 rx",
         "#pragma unroll 4\n      for (int t = 0; t < kMaxStep; ++t) {\n        if (t < L) {\n"
         "          const float4 rx")]),
    ("state pass: the any-width build", True, [
        ("auto state_kernel = dv == 64 ?", "auto state_kernel = false ?")]),
    ("chunk: two blocks an SM (more registers)", True, [
        ("__launch_bounds__(kThreads, 3) rwkv_scan_bwd_chunk_kernel",
         "__launch_bounds__(kThreads, 2) rwkv_scan_bwd_chunk_kernel")]),
    ("chunk: products on FMA tiles", True, [
        ("  return dk == 64 && dv == 64 && step % 8 == 0;\n",
         "  return false;\n")]),
)


def build_variant(name, edits):
    from repro_torch.kernels import build
    tag = "rwkv_scan_bwd_" + "".join(c if c.isalnum() else "_" for c in name)
    handle, log = build.build_variant(build.CSRC / "rwkv_scan_bwd.cu",
                                      [*edits, OCCUPANCY], tag)
    handle.rwkv_scan_bwd_f32.argtypes = ([ctypes.c_void_p] * 16 +
                                         [ctypes.c_int] * 6 +
                                         [ctypes.c_void_p])
    handle.sweep_chunk_blocks_per_sm.argtypes = [ctypes.c_int] * 3
    return handle, log


def probe_readings(torch, np, run, ws, b):
    """One launch of the probe build: each chunk block's cycles in each
    phase (mean and 90th percentile over the blocks), its lifetime, and
    the blocks an SM ran."""
    run()
    torch.cuda.synchronize()
    words = ws.view(torch.int32).reshape(-1, ws.shape[-1])[:, :13].cpu()
    words = words.numpy().astype(np.int64)
    stamps = (words[:, 1:12:2] << 32) | (words[:, 0:12:2] & 0xffffffff)
    spans = np.diff(stamps, axis=1)
    reading = {"probe": "chunk kernel cycles a block", "batch": b,
               "blocks": int(spans.shape[0]),
               "blocks_per_sm": float(spans.shape[0] / len(
                   np.unique(words[:, 12])))}
    for name, col in zip(PHASES + ("lifetime",),
                         list(spans.T) + [stamps[:, -1] - stamps[:, 0]]):
        reading[name] = {"mean": float(col.mean()),
                         "p90": float(np.percentile(col, 90))}
    print(json.dumps(reading), flush=True)


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--batch", type=int, nargs="*",
                    default=list(cs.WKV_TRAIN_BATCHES))
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to run (as built always runs)")
    args = ap.parse_args(argv)
    variants = [v for v in VARIANTS
                if args.only is None or v[0] == "as built" or v[0] in args.only]
    if not torch.cuda.is_available():
        print("wkv_bwd_sweep: no CUDA card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    w = cs.WKV
    s, h, dk, dv, chunk = (w[k] for k in ("seq", "heads", "dk", "dv",
                                          "chunk"))
    step = ops.ref.wkv_step_tokens(chunk)
    with ThreadPoolExecutor(max_workers=8) as pool:
        built = list(pool.map(lambda v: build_variant(v[0], v[2]), variants))
    libs = {}
    for (name, _, _), (lib, log) in zip(variants, built):
        libs[name] = lib
        print(json.dumps({"variant": name, "ptxas": build.ptxas_lines(log),
                          "chunk_blocks_per_sm":
                              lib.sweep_chunk_blocks_per_sm(dk, dv, step)}),
              flush=True)
    rng = np.random.default_rng(31)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    for b in args.batch:
        r, k, v, logw, u, s0, do, dsT = cs.wkv_train_inputs(
            torch, np, rng, b, s, h, dk, dv)
        _, s_t, states = ops.rwkv_scan_states(r, k, v, logw, u, s0,
                                              chunk=chunk)
        grads = [torch.empty_like(x) for x in (r, k, v, logw, u, s0)]
        gs = torch.empty_like(states)
        ws = torch.empty((b, h, s // step, dk), device=r.device)

        def runner(lib):
            def run():
                err = lib.rwkv_scan_bwd_f32(*(t.data_ptr() for t in (
                    r, k, v, logw, u, states, do, dsT, *grads, gs, ws)),
                    b, s, h, dk, dv, step, stream)
                if err:
                    raise RuntimeError(f"launch failed: cudaError_t {err}")
            return run
        want = ops.ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                           chunk=chunk)
        for name, computes, _ in variants:
            if not computes:
                continue
            runner(libs[name])()
            torch.cuda.synchronize()
            for grad, got, ww in zip(cs.WKV_GRADS, grads, want):
                err = float((got - ww).abs().max())
                cs.check(err <= cs.WKV_TOL * max(1.0, float(ww.abs().max())),
                         f"{name} B={b}: {grad} max_abs_err {err}")
        if "chunk: phase probe" in libs:
            probe_readings(torch, np, runner(libs["chunk: phase probe"]), ws,
                           b)
        order = [v[0] for v in variants]
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                print(json.dumps({"variant": name, "batch": b, "round": rnd,
                                  "ms": cs.time_ms(torch, runner(libs[name]),
                                                   flush)}), flush=True)
        del r, k, v, logw, u, s0, do, dsT, s_t, states, grads, gs, ws, want
        torch.cuda.empty_cache()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
