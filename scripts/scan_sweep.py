"""Time the scan kernel against builds of ``csrc/isp_scan.cu`` with one
part of its work taken out, on one card.

    python scripts/scan_sweep.py [--rounds N] [--only NAME ...]

Each variant is the source with a few lines replaced, or the plan's
constants changed (``VARIANTS``); "as built" and the plan variants
compute the function (checked against the plain version, bit for bit);
the others time what is left when a part is skipped, so the differences say what bounds the scan at the SF-1
lineitem shapes (46,885 pages of 128 x 16, f32 and int8 pages, job "ge
extendedprice").  Each variant is timed twice: the whole call, and its
fold block alone over the fold values a full call left
(``isp_scan.scan_chain_runner``), with the L2 cache flushed before each
launch and without.  The variants run in turns,
``--rounds`` times (default 2), each timed by ``chip_smoke.time_ms``.
Prints one JSON line a reading, then the card's name and power limit.
Card only.
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

# (name, [(old, new), ...]) applied to csrc/isp_scan.cu
VARIANTS = (
    ("as built", []),
    # the fold blocks' lanes add one value a slot, not a slot's pages
    ("fold: no adds", [
        ("        acc = fold_row(sring + (size_t)slot * slot_floats +\n"
         "                           (size_t)vr * a.slot_stride,\n"
         "                       min(a.slot_pages, a.n_valid - k * a.slot_pages), acc);",
         "        acc = __fadd_rn(acc, sring[(size_t)slot * slot_floats +\n"
         "                                   (size_t)vr * a.slot_stride]);")]),
    # the loader warp releases each slot without copying into it
    ("fold: no copies", [
        ("          if (lane == 0) mbar_expect_tx(&full[slot], rows * bytes);\n"
         "          __syncwarp();\n"
         "          if (lane < rows)\n",
         "          if (lane == 0) mbar_arrive(&full[slot]);\n"
         "          __syncwarp();\n"
         "          if (lane < 0)\n")]),
    # the fold lanes add a constant a page, no shared-memory reads: the
    # dependent f32 add chain alone
    ("fold: adds of a constant", [
        ("      acc = __fadd_rn(acc, x[u].x);\n"
         "      acc = __fadd_rn(acc, x[u].y);\n"
         "      acc = __fadd_rn(acc, x[u].z);\n"
         "      acc = __fadd_rn(acc, x[u].w);\n",
         "      acc = __fadd_rn(acc, 1.5f);\n"
         "      acc = __fadd_rn(acc, 1.5f);\n"
         "      acc = __fadd_rn(acc, 1.5f);\n"
         "      acc = __fadd_rn(acc, 1.5f);\n")]),
    # the fold blocks return at once: the producers' stream alone
    ("no fold blocks", [
        ("  if (blockIdx.x < a.n_fold)\n"
         "    scan_follow(a, ring, mm, M, full, empty, &count);",
         "  if (blockIdx.x < a.n_fold)\n"
         "    return;")]),
    # the producer warp releases each stage without copying into it: the
    # consumers' work alone
    ("stream: no copies", [
        ("        if (pl == 0) mbar_expect_tx(&full[slot], nu * (page_bytes + sc_bytes));\n"
         "        __syncwarp();\n"
         "        if (pl < nu) {",
         "        if (pl == 0) mbar_arrive(&full[slot]);\n"
         "        __syncwarp();\n"
         "        if (pl < 0) {")]),
    # the consumers skip the column walk (the filter bits stay)
    ("stream: no column walk", [
        ("            float sum, mn, mx;\n"
         "            page_column_staged<CODE>(st + (size_t)i * a.page_stride,",
         "            float sum = 0.f, mn = 0.f, mx = 0.f;\n"
         "            if (cc < 0) page_column_staged<CODE>(st + (size_t)i * a.page_stride,")]),
    # the consumers skip the filter bits
    ("stream: no filter bits", [
        ("        for (int w0 = wg; w0 < words; w0 += kWords * wstep) {",
         "        for (int w0 = wg; w0 < 0; w0 += kWords * wstep) {")]),
    # every wait on an mbarrier polls (test_wait) instead of suspending
    # the warp (try_wait)
    ("waits poll", [
        ("      \"mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\\n\"\n"
         "      \"selp.u32 %0, 1, 0, P1;\\n\"",
         "      \"mbarrier.test_wait.parity.shared::cta.b64 P1, [%1], %2;\\n\"\n"
         "      \"selp.u32 %0, 1, 0, P1;\\n\"")]),
    # one block an SM (the grid half as wide)
    ("one block an SM", [], {"SCAN_BLOCKS_PER_SM": 1}),
    # the ring's stages as first built: up to 4 of up to 33 KB (f32: 4
    # pages a stage; one consumer group)
    ("stages of 33 KB, up to 4", [], {"SCAN_STAGE_BYTES": 33 * 1024,
                                      "SCAN_MAX_STAGES": 4}),
    # stages of one f32 page, up to 8
    ("stages of 9 KB", [], {"SCAN_STAGE_BYTES": 9 * 1024}),
    # chunks of half and twice the rows (more flags and a shorter wait
    # for the first, or fewer)
    ("chunks of 1,024 rows", [], {"SCAN_CHUNK_ROWS": 1024}),
    ("chunks of 512 rows", [], {"SCAN_CHUNK_ROWS": 512}),
    ("chunks of 4,096 rows", [], {"SCAN_CHUNK_ROWS": 4096}),
    # clock64 around each phase of the first producer block's consumer
    # threads 0, 128 and 224, printed at its end (a probe: its time is not
    # the kernel's)
    ("probe: producer phases", [
        ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
        ("  int step = 0;\n"
         "  for (int c = b; c < a.n_chunks; c += a.n_prod) {\n"
         "    const int p1 = min((c + 1) * a.chunk_pages, a.n_valid);\n"
         "    for (int u0 = c * a.chunk_pages; u0 < p1; u0 += a.unit_pages) {\n"
         "      const int nu = min(a.unit_pages, p1 - u0);\n"
         "      if constexpr (TMA) {\n"
         "        if (step++ % G != g) continue;\n"
         "        const int slot = (step - 1) % a.n_stages;\n"
         "        mbar_wait_bounded(&full[slot], ((step - 1) / a.n_stages) & 1);\n",
         "  int step = 0;\n"
         "  long long tw = 0, tp = 0, tc = 0, tf = 0, T0 = 0, T00 = clock64();\n"
         "  for (int c = b; c < a.n_chunks; c += a.n_prod) {\n"
         "    const int p1 = min((c + 1) * a.chunk_pages, a.n_valid);\n"
         "    for (int u0 = c * a.chunk_pages; u0 < p1; u0 += a.unit_pages) {\n"
         "      const int nu = min(a.unit_pages, p1 - u0);\n"
         "      if constexpr (TMA) {\n"
         "        if (step++ % G != g) continue;\n"
         "        const int slot = (step - 1) % a.n_stages;\n"
         "        T0 = clock64();\n"
         "        mbar_wait_bounded(&full[slot], ((step - 1) / a.n_stages) & 1);\n"
         "        tw += clock64() - T0;\n"
         "        T0 = clock64();\n"),
        ("        named_sync(kGroupBar + g, T);\n"
         "        for (int i = s; s < S && i < nu; i += S) {\n",
         "        named_sync(kGroupBar + g, T);\n"
         "        tp += clock64() - T0;\n"
         "        T0 = clock64();\n"
         "        for (int i = s; s < S && i < nu; i += S) {\n"),
        ("        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(&empty[slot]);\n"
         "      } else {\n",
         "        tc += clock64() - T0;\n"
         "        __syncwarp();\n"
         "        if (lane == 0) mbar_arrive(&empty[slot]);\n"
         "      } else {\n"),
        ("    // the chunk's fold values are written: publish them\n"
         "    __threadfence();\n"
         "    named_sync(kRowsBar, kScanThreads);\n"
         "    if (t == 0) st_release(a.flags + c, a.epoch);\n"
         "  }\n",
         "    // the chunk's fold values are written: publish them\n"
         "    T0 = clock64();\n"
         "    __threadfence();\n"
         "    named_sync(kRowsBar, kScanThreads);\n"
         "    if (t == 0) st_release(a.flags + c, a.epoch);\n"
         "    tf += clock64() - T0;\n"
         "  }\n"
         "  if ((t == 0 || t == 128 || t == 224) && b == 0)\n"
         "    printf(\"probe t=%d units %d wait %lld prepass %lld walk %lld \"\n"
         "           \"publish %lld total %lld\\n\", t, step, tw, tp, tc, tf,\n"
         "           clock64() - T00);\n")]),
    # clock64 around the fold blocks' adder warp: cycles waiting for a
    # slot, cycles adding, printed at the end with the SM it ran on
    ("probe: fold phases", [
        ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cstdio>\n"),
        ("      float acc = 0.f;\n"
         "      for (int k = 0; k < n_slots_total; ++k, ++step) {\n"
         "        const int slot = step % a.n_slots;\n"
         "        mbar_wait_bounded(&full[slot], (step / a.n_slots) & 1);\n"
         "        acc = fold_row(sring + (size_t)slot * slot_floats +\n"
         "                           (size_t)vr * a.slot_stride,\n"
         "                       min(a.slot_pages, a.n_valid - k * a.slot_pages), acc);\n",
         "      float acc = 0.f;\n"
         "      long long tw = 0, ta = 0, T0 = 0, T00 = clock64(), first = -1;\n"
         "      for (int k = 0; k < n_slots_total; ++k, ++step) {\n"
         "        const int slot = step % a.n_slots;\n"
         "        T0 = clock64();\n"
         "        mbar_wait_bounded(&full[slot], (step / a.n_slots) & 1);\n"
         "        tw += clock64() - T0;\n"
         "        if (first < 0) first = clock64() - T00;\n"
         "        T0 = clock64();\n"
         "        acc = fold_row(sring + (size_t)slot * slot_floats +\n"
         "                           (size_t)vr * a.slot_stride,\n"
         "                       min(a.slot_pages, a.n_valid - k * a.slot_pages), acc);\n"
         "        ta += clock64() - T0;\n"),
        ("      if (lane < a.vw && g == 0) *count = acc;\n",
         "      unsigned smid;\n"
         "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
         "      if (lane == 0 && !a.follow_only)\n"
         "        printf(\"probe fold f=%d sm=%u first %lld wait %lld add %lld total %lld\\n\",\n"
         "               f, smid, first, tw, ta, clock64() - T00);\n"
         "      if (lane < a.vw && g == 0) *count = acc;\n")]),
    # producers skip the fence before a chunk's flag
    ("stream: no fences", [
        ("    // the chunk's fold values are written: publish them\n"
         "    __threadfence();",
         "    // the chunk's fold values are written: publish them")]),
)


def overrides(plan):
    """Set the wrapper's and the plan's constants a variant names;
    returns the previous values."""
    from repro_torch.kernels import isp_scan, ref
    old = {}
    for key, value in plan.items():
        mod = isp_scan if hasattr(isp_scan, key) and key.startswith(
            "SCAN_BLOCKS") else ref
        old[key] = (mod, getattr(mod, key))
        setattr(mod, key, value)
    return old


def build_variant(name, edits):
    from repro_torch.kernels import build
    text = (build.CSRC / "isp_scan.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: isp_scan.cu has no {old!r}")
        text = text.replace(old, new)
    tag = "".join(c if c.isalnum() else "_" for c in name)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"isp_scan_{tag}.cu"
    lib = build.BUILD_DIR / f"libisp_scan_{tag}.so"
    src.write_text(text)
    out = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                          str(src)], check=True, capture_output=True,
                         text=True)
    regs = [line.strip() for line in out.stdout.splitlines() +
            out.stderr.splitlines() if "registers" in line and
            "scan_kernel" in line or "spill" in line and "scan" in line]
    return ctypes.CDLL(str(lib)), regs


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import isp_scan, ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None,
                    help="variant names to run (as built always runs)")
    args = ap.parse_args(argv)
    variants = [(v[0], v[1], v[2] if len(v) > 2 else {}) for v in VARIANTS
                if args.only is None or v[0] == "as built" or
                v[0] in args.only]
    if not torch.cuda.is_available():
        print("scan_sweep: no CUDA card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    libs = {}
    for name, edits, _ in variants:
        libs[name], regs = build_variant(name, edits)
        print(json.dumps({"variant": name, "ptxas": regs}), flush=True)
    li, _ = cs.make_lineitem(np)
    x, table = cs.on_pages(torch, li, cs.LINEITEM["page_rows"])
    pools = cs.quantized_pools(torch, x)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    no_flush = torch.empty(1, dtype=torch.uint8, device=cs.DEVICE)
    built = isp_scan._bind
    _, col, op, thr = cs.SCAN_JOBS[1]
    order = [n for n, _, _ in variants]
    plans = {n: p for n, _, p in variants}
    for code in ("f32", "int8"):
        pages, scales = pools[code]

        def run():
            return ops.scan_filter_reduce(pages, table, li.shape[0], thr,
                                          scales=scales, filter_col=col,
                                          filter_op=op)
        want = ops.ref.scan_filter_reduce_ref(
            pages, table, li.shape[0], thr, scales=scales, filter_col=col,
            filter_op=op)
        for rnd in range(args.rounds):
            for name in (order if rnd % 2 == 0 else order[::-1]):
                isp_scan._bind = (lambda n, lib=libs[name]:
                                  isp_scan.typed(getattr(lib, n), n))
                saved = overrides(plans[name])
                if name == "as built" or plans[name]:
                    cs.exact(torch, run(), want, f"{name} {code}")
                chain = isp_scan.scan_chain_runner(
                    pages, table, li.shape[0], thr, scales=scales,
                    filter_col=col, filter_op=op)
                plan = isp_scan.scan_plan_of(pages, table, li.shape[0],
                                             scales)
                print(json.dumps({
                    "variant": name, "pages": code, "round": rnd,
                    "ms": cs.time_ms(torch, run, flush),
                    "fold_alone_ms": cs.time_ms(torch, chain, flush),
                    "fold_alone_l2_warm_ms": cs.time_ms(torch, chain,
                                                        no_flush),
                    "blocks_per_sm": libs[name].scan_blocks_per_sm(
                        ("f32", "int8").index(code), int(plan.tma),
                        plan.smem),
                    "plan": plan._asdict()}), flush=True)
                for key, (mod, value) in saved.items():
                    setattr(mod, key, value)
        isp_scan._bind = built
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
