"""The flash backward's design choices, their errors and their times, on
one card.

    python scripts/flash_bwd_accuracy.py [--only NAME,...] [--out FILE]

Builds ``csrc/flash_attention_bwd.cu`` as it stands and each variant of
``VARIANTS`` (a copy with one choice written in by text replacement,
which raises if the source moved on), all nvcc runs started together,
into build/repro_torch, and prints ptxas's registers and spill stores
of each tensor-core kernel by head dim:

  * ``as_built``: each walked tile's share of a head's dK and dV (dQ)
    summed in the tensor core's accumulator operand from zero, then added
    to the running sums by f32 adds (``tile_times_rows``); the G heads'
    dK/dV shares joined head 0 first by f32 adds; lo = x - hi left
    unrounded (``split_lo_cut``);
  * ``long_sums_in_c``: the running sums kept in the accumulator operand
    across every tile (the first 3xTF32 design's sums);
  * ``lo_rounded``: lo = tf32(x - hi), the split of ``csrc/tf32_mma.cuh``
    (the first design's products);
  * ``fma``: the f32 FMA route at every shape;
  * the design's other choices: registers for one dK/dV block a SM at
    D = 64, a three-stage ring, 16-row walked tiles at D = 96, 32-row
    ones at D = 128, the dK/dV and dQ blocks in two launches;
  * timing probes, which skip part of the work and are not held to the
    plain version: no merge of the heads' shares, the dK/dV blocks
    alone, the dQ blocks alone.

At granite-3-2b's (the train batch and microbatch), phi3-mini-3.8b's
and a qwen2-72b-like training shape (causal), and one full-attention
shape, it runs each build on the same inputs: dq, dk and dv against
float64 autograd of the plain forward (``ref.flash_attention_ref``),
beside the plain f32 backward (``ref.flash_attention_bwd_ref``) against
the same float64 gradient; every variant but the probes held to the
plain backward within ``chip_smoke.BWD_TOL`` x max(1, max |plain|);
``as_built`` held to the wrapper's bits.  Each reading: max |err|, max
|exact|, err / max(1, max |exact|) and the time (``chip_smoke.time_ms``).
The builds are timed in order, then in reverse, so drift shows as a
difference between the two passes.  ``--only`` keeps ``as_built`` and the
named variants.  Prints one JSON line per reading, then the card's name
and power limit; ``--out`` also writes the lines to FILE.  Card only.
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

LAUNCH = "  return launch(0, kv_blocks + q_blocks);"
LONG_SUMS_IN_C = (("mma_3xtf32<4>(part + m0, sa, bf);",
                   "mma_3xtf32<4>(acc + n0 + m0, sa, bf);"),
                  ("for (int i = 0; i < 4; ++i) acc[n0 + n][i] += part[n][i];",
                   ";"))
# {name: ((old, new) replacements in the source, held to the plain version)}
VARIANTS = {
    "as_built": ((), True),
    "long_sums_in_c": (LONG_SUMS_IN_C, True),
    "lo_rounded": (((
        "  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));",
        "  lo = to_tf32(__fsub_rn(x, __uint_as_float(hi)));"),), True),
    "fma": ((("if (group <= kMmaRows) return launch_mma",
              "if (group < 0) return launch_mma"),), True),
    "one_dkdv_block_a_sm_at_d64": ((("KV_BLOCKS = DP <= 64 ? 3 : 1;",
                                     "KV_BLOCKS = 1;"),), True),
    "three_stages": ((("constexpr int kStages = 2;",
                       "constexpr int kStages = 3;"),), True),
    "rows16_at_d96": ((("DP <= 96 ? 32 : 16", "DP <= 64 ? 32 : 16"),), True),
    "rows32_at_d128": ((("DP <= 96 ? 32 : 16", "DP <= 128 ? 32 : 16"),),
                       True),
    "two_launches": (((LAUNCH, "  if ((err = launch(0, kv_blocks)) != "
                       "cudaSuccess) return err;\n"
                       "  return launch(kv_blocks, q_blocks);"),), True),
    "probe_no_merge": ((("  if (!last_of_group(tickets,",
                         "  return;\n  if (!last_of_group(tickets,"),), False),
    "probe_dkdv_only": (((LAUNCH, "  return launch(0, kv_blocks);"),), False),
    "probe_dq_only": (((LAUNCH, "  return launch(kv_blocks, q_blocks);"),),
                      False),
}
# (label, B, H, Hkv, S, D, causal)
SHAPES = (("granite-3-2b train", 8, 32, 8, 512, 64, True),
          ("granite-3-2b train microbatch", 4, 32, 8, 512, 64, True),
          ("phi3-mini-3.8b train", 8, 32, 32, 512, 96, True),
          ("qwen2-72b heads", 4, 64, 8, 512, 128, True),
          ("full attention", 4, 32, 8, 512, 64, False))


def build_variants(names):
    """{variant: ctypes function}, {variant: nvcc's log}; all nvcc runs
    started together."""
    from repro_torch.kernels import build

    text = (build.CSRC / "flash_attention_bwd.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = text
        for old, new in VARIANTS[name][0]:
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
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, logs


def ptxas_report(log):
    """{"<tensor-core kernel> <DP>": [registers, spill store bytes]} from
    nvcc's ``-Xptxas -v`` output."""
    report = {}
    for name, dp, body in re.findall(
            r"(flash_bwd_\w*?mma_kernel)ILi(\d+)E.*?\n(.*?)(?=Compiling "
            r"entry|\Z)", log, re.S):
        used = re.search(r"Used (\d+) registers", body)
        spill = re.search(r"(\d+) bytes spill stores", body)
        report[f"{name} {dp}"] = [int(used.group(1)) if used else None,
                                  int(spill.group(1)) if spill else None]
    return report


def readings(torch, np, cs, fns, flush, emit):
    """The readings at SHAPES, each passed to ``emit``."""
    from repro_torch.kernels import ops

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
        plan = ops.ref.flash_bwd_plan(b, h, hkv, s, s, d)
        ws = torch.empty(max(plan.workspace, 4), device=q.device)
        tickets = torch.zeros(max(plan.tickets, 1), dtype=torch.int32,
                              device=q.device)
        di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        runs = {}
        for name, fn in fns.items():
            got = [torch.empty_like(t) for t in (q, k, v)]

            def run(name=name, fn=fn, got=got):
                err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         di.data_ptr(), *(t.data_ptr() for t in got),
                         ws.data_ptr(), tickets.data_ptr(), tickets.numel(),
                         b, h, hkv, s, s, d, int(causal), stream)
                cs.check(err == 0, f"{name}: cudaError_t {err}")

            run()
            torch.cuda.synchronize()
            runs[name] = run
            reading = {**case, "variant": name, "vs_float64": errors(got)}
            if VARIANTS[name][1]:
                reading["err_vs_plain_over_scale"] = max(
                    float((g - w).abs().max()) / max(1.0, float(w.abs().max()))
                    for g, w in zip(got, plain))
                cs.check(reading["err_vs_plain_over_scale"] <= cs.BWD_TOL,
                         f"{name} {label}: "
                         f"{reading['err_vs_plain_over_scale']}")
            if name == "as_built":
                reading["wrapper_bits"] = all(
                    torch.equal(a, w) for a, w in zip(got, wrapper))
                cs.check(reading["wrapper_bits"],
                         f"{label}: as_built differs from the wrapper")
            reading["ms"] = cs.time_ms(torch, run, flush)
            emit(reading)
        for name in list(runs)[::-1]:
            emit({**case, "variant": name, "pass": "reverse",
                  "ms": cs.time_ms(torch, runs[name], flush)})
        del q, k, v, do, out, lse, leaves, exact, wrapper, plain, ws, runs
        torch.cuda.empty_cache()


def main(argv) -> int:
    import argparse

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default="",
                    help="comma-separated variants (as_built always runs)")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    unknown = only - set(VARIANTS)
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("flash_bwd_accuracy: no CUDA card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    lines = []

    def emit(obj):
        lines.append(obj)
        cs.emit(obj)

    fns, logs = build_variants([n for n in VARIANTS
                                if not only or n == "as_built" or n in only])
    for name, log in logs.items():
        emit({"variant": name, "ptxas_registers_spill_bytes":
              ptxas_report(log)})
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    readings(torch, np, cs, fns, flush, emit)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
