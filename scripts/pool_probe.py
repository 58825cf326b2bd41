"""Take the pool forms of the paged-attention kernels apart on one card.

    python scripts/pool_probe.py [--rounds N] [--only NAME ...]
                                 [--ptxas FILE]

At the kernels phase's pool cases (``chip_smoke.pool_kernel_cases``: 4
nodes x 80 pages, placed and striped; the decode form at B=8, lengths
513..576, the chunk form at C=256, lengths 257..512) on f32 and int8
pages, times by ``chip_smoke.time_ms`` (device time, L2 flushed):

  merged    the pool wrapper (one launch: walk and merge); merged_warm
            the same with L2 not flushed (the launch's code and data warm)
  unmerged  ``paged_attention.pool_partials`` (the launch without its
            merge: no ticket, no merged output)
  one_node  the pool wrapper at one node whose window is the store
  single    ``ops.paged_attention(_q8)`` on the same table (the single
            form, with its combine launch for the decode form)

Then each build of ``csrc/paged_attention.cu`` with one design choice
changed (``VARIANTS``: text edits of the source, built with the repo's
nvcc flags into ``build/repro_torch/``) against the source as built, in
turns (as built, variant, variant, as built), ``--rounds`` times, each
checked against the plain version (1e-4) unless it is a timing-only
build.  Prints one JSON line per
reading, then the card's name and power limit; ``--ptxas`` writes nvcc's
``-Xptxas -v`` report of the source as built (registers, spills of each
kernel) to FILE.  Card only.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

# name: (what changes, [(text in the source, its replacement), ...],
# whether its output is checked: False for a timing-only build whose
# output is not the function's)
VARIANTS = {
    "decode_node_major": (
        "the pool decode grid's z node-major (node s's splits dispatched "
        "together) where it is split-major",
        [("  const int node = POOL ? blockIdx.z % n_nodes : 0;\n"
          "  const int split = POOL ? blockIdx.z / n_nodes : blockIdx.z;",
          "  const int node = POOL ? blockIdx.z / splits : 0;\n"
          "  const int split = blockIdx.z - node * splits;")], True),
    "chunk_tile_major": (
        "the pool chunk grid tile-major (x = row tile * N + node: a tile's "
        "node blocks dispatched together, longest tiles first across "
        "nodes) where z = node dispatches node after node",
        [("  const int q0 = (gridDim.x - 1 - blockIdx.x) * bq;     "
          "// longest rows first\n"
          "  // pool form: node blockIdx.z owns the physical pages "
          "[base, base + n_local)\n"
          "  const int node = POOL ? blockIdx.z : 0;",
          "  const int node = POOL ? blockIdx.x % n_nodes : 0;\n"
          "  const int tile = POOL ? blockIdx.x / n_nodes : blockIdx.x;\n"
          "  const int q0 = ((POOL ? gridDim.x / n_nodes : gridDim.x) - 1 - "
          "tile) * bq;"),
         ("last_of_group(tickets, blockIdx.x * gridDim.y + blockIdx.y, "
          "n_nodes)",
          "last_of_group(tickets, tile * gridDim.y + blockIdx.y, n_nodes)"),
         ("  dim3 grid((c + bq - 1) / bq, hkv, n_nodes);",
          "  dim3 grid((c + bq - 1) / bq * n_nodes, hkv);")], True),
    "pool_chunk_two_blocks": (
        "the pool chunk kernel's launch bounds without a blocks-a-SM ask "
        "(the single form's)",
        [("__global__ void __launch_bounds__(kThreads, 1) "
          "paged_pool_chunk_kernel",
          "__global__ void __launch_bounds__(kThreads) "
          "paged_pool_chunk_kernel")], True),
    "chunk_full_instantiations": (
        "the pool chunk kernel also instantiated at d == D (the head dim a "
        "constant), as the single form is",
        [("  const bool full = !POOL && d == D;\n"
          "  auto kernel = paged_chunk_kernel<T, Q, D, false>;\n"
          "  if constexpr (POOL) kernel = paged_pool_chunk_kernel<T, Q, D, false>;\n"
          "  else if (full) kernel = paged_chunk_kernel<T, Q, D, true>;",
          "  const bool full = d == D;\n"
          "  auto kernel = paged_chunk_kernel<T, Q, D, false>;\n"
          "  if constexpr (POOL)\n"
          "    kernel = full ? paged_pool_chunk_kernel<T, Q, D, true>\n"
          "                  : paged_pool_chunk_kernel<T, Q, D, false>;\n"
          "  else if (full) kernel = paged_chunk_kernel<T, Q, D, true>;")],
        True),
    "chunk_merge_per_warp": (
        "the pool chunk form's merge by merge_partials, a row per warp (the "
        "combine kernel's body) where merge_rows takes its rows at once",
        [("  if constexpr (CHUNK) {\n    if (n <= 4)",
          "  if constexpr (false) {\n    if (n <= 4)")], True),
    "row_map_divide": (
        "the chunk merge's row map by integer division by the positions a "
        "tile, not a mask and a shift (a power of two)",
        [("                   (bq & (bq - 1)) == 0 ? __ffs(bq) - 1 : -1};",
          "                   -1};")], True),
    "fence_every_thread": (
        "every thread fences its partials before the ticket, and every "
        "thread of the last block after it (one thread fences as built)",
        [("  __syncthreads();\n  bool last = false;\n"
          "  if (threadIdx.x == 0) {\n"
          "    __threadfence();                     "
          "// the block's partials, device-wide\n",
          "  __threadfence();\n  __syncthreads();\n  bool last = false;\n"
          "  if (threadIdx.x == 0) {\n"),
         ("  return __syncthreads_or(last);\n}",
          "  const bool l_ = __syncthreads_or(last);\n"
          "  if (l_) __threadfence();\n  return l_;\n}")], True),
    "merge_skipped": (
        "timing only: no block merges (the tickets are still taken); the "
        "launch minus its merge",
        [("  return __syncthreads_or(last);\n}",
          "  __syncthreads_or(last);\n  return false;\n}")], False),
}



def build_variants(names):
    """{name: CDLL} of the VARIANTS named, one nvcc each, all at once."""
    from repro_torch.kernels import build
    base = (build.CSRC / "paged_attention.cu").read_text()
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        src = base
        for old, new in VARIANTS[name][1]:
            if old not in src:
                raise RuntimeError(f"variant {name}: text not in the "
                                   f"source: {old[:60]!r}")
            src = src.replace(old, new)
        h = hashlib.sha256((src + " ".join(build.NVCC_FLAGS)).encode())
        out = build.BUILD_DIR / f"libpaged_{name}_{h.hexdigest()[:12]}.so"
        cu = out.with_suffix(".cu")
        cu.write_text(src)
        jobs[name] = (out, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed:\n{log}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def use_library(pa, build, lib):
    """Point the wrappers at ``lib`` (None: the source as built)."""
    pa._bind.cache_clear()
    pa.build = build if lib is None else type("B", (), {
        "load_library": staticmethod(lambda name: lib)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--ptxas", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import paged_attention as pa

    dev = resolve_device("cuda")
    (k, v, page, hkv), cases = cs.kernel_cases(np)
    pages = cs.paged_pages(torch, k, v)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    warm = torch.empty(1, dtype=torch.uint8, device=dev)    # no flush
    rng = np.random.default_rng(7)
    inputs = []
    for form, (case, q_np, _, len_np, _) in (("decode", cases[1]),
                                             ("chunk", cases[3])):
        q = torch.from_numpy(q_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        for policy in ("placed", "striped"):
            if form == "chunk":
                row = cs.pool_table(np, rng, len_np[-1:], 32, policy,
                                    first_node=1)[0]
                table = torch.from_numpy(row).to(dev)[None].expand(
                    len(len_np), 32)
            else:
                table = torch.from_numpy(cs.pool_table(
                    np, rng, len_np, 64, policy)).to(dev)
            inputs.append((form, policy, q, table, lengths))

    def fns(code, q, table, lengths):
        kp, vp, ks, vs = pages[code]
        sc = () if ks is None else (ks, vs)
        pool = ops.paged_attention_pool_q8 if sc else ops.paged_attention_pool
        single = ops.paged_attention_q8 if sc else ops.paged_attention
        n, local = cs.POOL_NODES, cs.POOL_LOCAL
        return {
            "merged": lambda: pool(q, kp, vp, *sc, table, lengths, n_nodes=n,
                                   n_local=local),
            "unmerged": lambda: pa.pool_partials(q, kp, vp, table, lengths,
                                                 ks, vs, n_nodes=n,
                                                 n_local=local),
            "one_node": lambda: pool(q, kp, vp, *sc, table, lengths,
                                     n_nodes=1, n_local=kp.shape[0]),
            "single": lambda: single(q, kp, vp, *sc, table, lengths)}

    def plain(code, q, table, lengths):
        kp, vp, ks, vs = pages[code]
        return (ops.ref.paged_attention_ref(q, kp, vp, table, lengths)
                if ks is None else ops.ref.paged_attention_q8_ref(
                    q, kp, vp, ks, vs, table, lengths))

    def run(tag, which=("merged", "merged_warm", "unmerged", "one_node",
                        "single"),
            checked=True):
        for form, policy, q, table, lengths in inputs:
            for code in ("f32", "int8"):
                f = fns(code, q, table, lengths)
                err = None
                if checked:
                    err = float((f["merged"]() - plain(code, q, table,
                                                       lengths)).abs().max())
                    cs.check(err <= cs.KERNEL_TOL, f"{tag} {form} {policy} "
                             f"{code}: {err}")
                print(json.dumps({
                    "build": tag, "form": form, "policy": policy,
                    "pages": code, "max_abs_err": err,
                    **{w: cs.time_ms(torch, f[w.replace("_warm", "")],
                                     warm if w.endswith("_warm") else flush)
                       for w in which}}),
                    flush=True)

    names = [n for n in VARIANTS if not args.only or n in args.only]
    t0 = time.monotonic()
    log = build._finish("paged_attention", build._start("paged_attention"))
    t1 = time.monotonic()
    libs = build_variants(names)
    print(json.dumps({"build_s": t1 - t0, "variant_builds_s":
                      time.monotonic() - t1, "variants": names}), flush=True)
    if args.ptxas:
        Path(args.ptxas).write_text(log or "already built\n")
    run("as_built")
    for name in names:
        lib = libs[name]
        print(json.dumps({"variant": name, "what": VARIANTS[name][0]}),
              flush=True)
        for _ in range(args.rounds):
            for tag, lb in (("as_built", None), (name, lib), (name, lib),
                            ("as_built", None)):
                use_library(pa, build, lb)
                run(tag, ("merged",), lb is None or VARIANTS[name][2])
        use_library(pa, build, None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
