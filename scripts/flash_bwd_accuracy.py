"""Where the flash backward's error comes from, on one card.

    python scripts/flash_bwd_accuracy.py [--out FILE]

Builds ``csrc/flash_attention_bwd.cu`` as it stands and four variants of
it made by text replacement (``VARIANTS``), each into build/repro_torch:

  * ``as_built``: each query (key) tile's share of dK and dV (dQ) summed
    in the tensor core's accumulator operand from zero, then added to the
    running sums by f32 adds (``tile_times_rows``);
  * ``long_sums_in_c``: the running sums kept in the accumulator operand
    across every tile (the first 3xTF32 design);
  * ``step_sums``: each k-step's eight products (three mma) joined to
    the running sums by f32 adds;
  * ``step_sums_and_scores``: the same, and S and dP summed over
    head_dim that way too;
  * ``fma``: the f32 FMA route at every shape.

At granite-3-2b's, phi3-mini-3.8b's and a qwen2-72b-like training shape
(causal), and one full-attention shape, it runs each variant on the same
inputs and holds dq, dk and dv against float64 autograd of the plain
forward (``ref.flash_attention_ref``), beside the plain f32 backward
(``ref.flash_attention_bwd_ref``) against the same float64 gradient.
Each reading: max |err|, max |exact|, err / max(1, max |exact|), the
time (``chip_smoke.time_ms``), ptxas's registers and spill stores of the
shape's kernels, and whether ``as_built`` gives the wrapper's bits.
Prints one JSON line per reading, then the card's name and power limit;
``--out`` also writes the lines to FILE.  Card only.
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

LONG_SUMS_IN_C = (("acc_times_rows<LD, KT>(part, c[kk]",
                   "acc_times_rows<LD, KT>(acc, c[kk]"),
                  ("acc[n][i] += part[n][i];", ";"))
# mma_3xtf32 into zeroed registers, then added to acc by f32 adds
STEP_ADD = ("// rows [r0, r0 + ROWS) of a [n, d] matrix", """\
template <int N>
__device__ __forceinline__ void mma_3xtf32_add(float (*acc)[4], const SplitA& a,
                                               const float* b) {
  float t[N][4];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) t[n][c] = 0.f;
  mma_3xtf32<N>(t, a, b);
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] += t[n][c];
}

// rows [r0, r0 + ROWS) of a [n, d] matrix""")
STEP_SUMS = LONG_SUMS_IN_C + (STEP_ADD, (
    "mma_3xtf32<4>(acc + n0, sa, bf);", "mma_3xtf32_add<4>(acc + n0, sa, bf);"))
SCORE_ADDS = (("mma_3xtf32<NT>(", "mma_3xtf32_add<NT>("),)
FMA_ONLY = (("if (group <= kMmaRows) return launch_mma",
             "if (group < 0) return launch_mma"),)
VARIANTS = {"as_built": (), "long_sums_in_c": LONG_SUMS_IN_C,
            "step_sums": STEP_SUMS,
            "step_sums_and_scores": STEP_SUMS + SCORE_ADDS, "fma": FMA_ONLY}
# (label, B, H, Hkv, S, D, causal)
SHAPES = (("granite-3-2b train", 8, 32, 8, 512, 64, True),
          ("phi3-mini-3.8b train", 8, 32, 32, 512, 96, True),
          ("qwen2-72b heads", 4, 64, 8, 512, 128, True),
          ("full attention", 4, 32, 8, 512, 64, False))


def build_variants():
    """{variant: ctypes function}, all nvcc runs started together."""
    from repro_torch.kernels import build

    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"flash_attention_bwd.cu no longer has "
                                   f"{old!r}")
            src = src.replace(old, new)
        path = build.BUILD_DIR / f"flash_attention_bwd_{name}.cu"
        path.write_text(src)
        lib = build.BUILD_DIR / f"libflash_attention_bwd_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns, logs = {}, {}
    for name, (lib, proc) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{logs[name]}")
        fn = ctypes.CDLL(str(lib)).flash_attention_bwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, logs


def ptxas_report(log, dp):
    """{kernel: [registers, spill store bytes]} of the kernels built for
    ``dp`` columns, from nvcc's ``-Xptxas -v`` output."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif fn is None or f"ILi{dp}E" not in fn:
            continue
        elif "spill stores" in line:
            name = re.search(r"flash_bwd_\w+?_kernel", fn).group(0)
            out.setdefault(name, [None, None])[1] = int(
                line.split("bytes spill stores")[0].split()[-1])
        elif "Used" in line and "registers" in line:
            name = re.search(r"flash_bwd_\w+?_kernel", fn).group(0)
            out.setdefault(name, [None, None])[0] = int(
                line.split("Used")[1].split()[0])
    return out


def readings(torch, np, cs, fns, logs, flush):
    """The readings at SHAPES, printed and returned."""
    from repro_torch.kernels import ops

    lines = []

    def emit(obj):
        lines.append(obj)
        cs.emit(obj)

    rng = np.random.default_rng(21)
    for label, b, h, hkv, s, d, causal in SHAPES:
        q, do = (torch.from_numpy(rng.standard_normal(
            (b, h, s, d), dtype=np.float32)).to(cs.DEVICE) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, s, d), dtype=np.float32)).to(cs.DEVICE)
            for _ in range(2))
        out, lse = ops.flash_attention_lse(q, k, v, causal=causal)
        leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
        exact = torch.autograd.grad(
            ops.ref.flash_attention_ref(*leaves, causal=causal), leaves,
            do.double())
        wrapper = ops.flash_attention_bwd(q, k, v, out, lse, do, causal)
        plain = ops.ref.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                causal)

        def errors(got):
            res = {}
            for name, g, x in zip(("dq", "dk", "dv"), got, exact):
                e = float((g.double() - x).abs().max())
                top = float(x.abs().max())
                res[name] = {"max_abs_err": e, "max_abs_exact": top,
                             "err_over_scale": e / max(1.0, top)}
            return res

        case = {"shape": label, "B": b, "H": h, "Hkv": hkv, "S": s, "D": d,
                "causal": causal}
        emit({**case, "variant": "plain f32 (ref.flash_attention_bwd_ref)",
              "vs_float64": errors(plain)})
        for name, fn in fns.items():
            got = [torch.empty_like(t) for t in (q, k, v)]
            di = torch.empty((b, h, s), dtype=torch.float32,
                             device=q.device)
            stream = torch.cuda.current_stream().cuda_stream

            def run(fn=fn, got=got, di=di, stream=stream):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         di.data_ptr(), *(t.data_ptr() for t in got),
                         b, h, hkv, s, s, d, int(causal), stream)
                cs.check(err == 0, f"{name}: cudaError_t {err}")

            run()
            torch.cuda.synchronize()
            reading = {**case, "variant": name, "vs_float64": errors(got),
                       "ms": cs.time_ms(torch, run, flush),
                       "ptxas": ptxas_report(logs[name], -(-d // 32) * 32)}
            if name == "as_built":
                reading["wrapper_bits"] = all(
                    torch.equal(a, w) for a, w in zip(got, wrapper))
                cs.check(reading["wrapper_bits"],
                         f"{label}: as_built differs from the wrapper")
            emit(reading)
        del q, k, v, do, out, lse, leaves, exact, wrapper, plain
        torch.cuda.empty_cache()
    return lines


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device

    if not torch.cuda.is_available():
        print("flash_bwd_accuracy: no CUDA card", file=sys.stderr)
        return 1
    out_file = Path(argv[argv.index("--out") + 1]) if "--out" in argv \
        else None
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    fns, logs = build_variants()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    lines = readings(torch, np, cs, fns, logs, flush)
    if out_file is not None:
        out_file.parent.mkdir(parents=True, exist_ok=True)
        out_file.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
