"""Time the wkv-scan kernel against builds of ``csrc/rwkv_scan.cu`` with
one part of its work taken out, on one card.

    python scripts/wkv_sweep.py [--rounds N]

Each variant is the source with a few lines replaced (``VARIANTS``);
only "as built" computes the function (it is checked against the plain
version, 1e-4 x max(1, max |plain|)); the others time what is left when
a part is skipped, so the differences say what that part costs at
rwkv6-3b's prefill shape (B=8, S=512, H=40, dk=dv=64, chunk 32).  The
variants run in turns, ``--rounds`` times (default 2), each timed by
``chip_smoke.time_ms``.  Prints one JSON line a reading, then the card's
name and power limit.  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# (name, [(old, new), ...]) applied to csrc/rwkv_scan.cu
VARIANTS = (
    ("as built", []),
    ("no scan rounds", [
        ("for (int off = 1; off < kMaxStep; off <<= 1) {",
         "for (int off = 1; off < 0; off <<= 1) {")]),
    ("single-float scan", [
        ("if (t >= off) df_add(hi[n], lo[n], yh, yl);",
         "if (t >= off) hi[n] += yh;")]),
    ("no anchored rows", [
        ("for (int b = 1; b < n_bits; ++b) {",
         "for (int b = 1; b < 0; ++b) {")]),
    ("no scores", [
        ("for (int q0 = 0; q0 < 2 * n_pairs + L; q0 += kThreads) {",
         "for (int q0 = 0; q0 < 0; q0 += kThreads) {")]),
    ("no output product", [
        ("for (int kk0 = 0; kk0 < kdim; kk0 += 8) {",
         "for (int kk0 = 0; kk0 < 0; kk0 += 8) {")]),
    ("no state update", [
        ("for (int k0 = 0; k0 < L; k0 += 8) {",
         "for (int k0 = 0; k0 < 0; k0 += 8) {")]),
    ("products on FMA tiles", [
        ("  const bool fixed = dk == 64 && dv == 64 && step % 8 == 0;\n"
         "  auto kernel = fixed ? rwkv_scan_kernel<64, 64, true>\n"
         "                      : rwkv_scan_kernel<0, 0, false>;\n"
         "  static int",
         "  const bool fixed = false;\n"
         "  auto kernel = fixed ? rwkv_scan_kernel<64, 64, true>\n"
         "                      : rwkv_scan_kernel<0, 0, false>;\n"
         "  static int")]),
    ("two blocks an SM (more registers)", [
        ("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")]),
)


def build_variant(name, edits):
    from repro_torch.kernels import build
    text = (build.CSRC / "rwkv_scan.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: rwkv_scan.cu has no {old!r}")
        text = text.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"rwkv_scan_{tag}.cu"
    lib = build.BUILD_DIR / f"librwkv_scan_{tag}.so"
    src.write_text(text)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], check=True, capture_output=True,
                         text=True)
    regs = [line.strip() for line in out.stdout.splitlines() +
            out.stderr.splitlines() if "registers" in line or
            "spill" in line]
    handle = ctypes.CDLL(str(lib))
    handle.rwkv_scan_f32.argtypes = ([ctypes.c_void_p] * 8 +
                                     [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return handle, regs


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to run (as built always runs)")
    args = ap.parse_args(argv)
    variants = [(n, e) for n, e in VARIANTS
                if args.only is None or n == "as built" or n in args.only]
    if not torch.cuda.is_available():
        print("wkv_sweep: no CUDA card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    libs = {}
    w = cs.WKV
    for name, edits in variants:
        libs[name], regs = build_variant(name, edits)
        per_sm = libs[name].rwkv_scan_blocks_per_sm(w["dk"], w["dv"],
                                                    w["chunk"])
        print(json.dumps({"variant": name, "ptxas": regs,
                          "blocks_per_sm": per_sm}), flush=True)
    b, s, h, dk, dv, chunk = (w[k] for k in ("batch", "seq", "heads", "dk",
                                             "dv", "chunk"))
    rng = np.random.default_rng(7)

    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).to(cs.DEVICE)
    r, k = (dev(rng.standard_normal((b, s, h, dk))) for _ in range(2))
    v = dev(rng.standard_normal((b, s, h, dv)))
    logw = dev(-np.exp(rng.standard_normal((b, s, h, dk))))
    u = dev(rng.standard_normal((h, dk)))
    s0 = dev(rng.standard_normal((b, h, dk, dv)))
    o, s_t = torch.empty_like(v), torch.empty_like(s0)
    stream = torch.cuda.current_stream().cuda_stream
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)

    def runner(lib):
        def run():
            err = lib.rwkv_scan_f32(*(t.data_ptr() for t in (
                r, k, v, logw, u, s0, o, s_t)), b, s, h, dk, dv, chunk,
                stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")
        return run
    runner(libs["as built"])()
    torch.cuda.synchronize()
    want = ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    for name, got, ww in (("o", o, want[0]), ("sT", s_t, want[1])):
        err = float((got - ww).abs().max())
        cs.check(err <= 1e-4 * max(1.0, float(ww.abs().max())),
                 f"as built: {name} max_abs_err {err}")
    order = [n for n, _ in variants]
    for rnd in range(args.rounds):
        for name in (order if rnd % 2 == 0 else order[::-1]):
            print(json.dumps({"variant": name, "round": rnd,
                              "ms": cs.time_ms(torch, runner(libs[name]),
                                               flush)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
