"""Time the embedding-bag kernel against builds of ``csrc/embed_agg.cu``
with one part of its design changed, and against the first design kept
in ``scripts/csrc/embed_agg_pr12.cu``, on one card.

    python scripts/embed_sweep.py [--rounds N] [--only NAME ...]

Each variant is the source with a few lines replaced (``VARIANTS``), and
for some the plan's constants in ``kernels.ref`` changed to match; every
variant computes the function and is checked against the plain version
bit for bit.  The cases are ``chip_smoke.embed_cases``' f32 bags over the
4M x 128 table (2048 Zipf(1.2) bags of 16, unweighted and weighted; the
byte-bound bag, ``chip_smoke.EMBED_WIDE``) and the same 2048 bags of 16
with uniform ids, which takes the Zipf head's hot rows away.  Variants
run in turns, ``--rounds`` times (default 2), each reading timed by
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

# the row load of csrc/embed_agg.cu, which some variants replace
_LOAD = ("        s.r[j].raw = __ldg("
         "reinterpret_cast<const typename Vec<VB>::T*>(\n"
         "            col + static_cast<long long>(rid) * ld));")

# a 16-byte piece loaded with a PTX cache hint (``{}``), other pieces
# as built
_HINT = ("// One bag's walk: a stage's ids and weights, its rows, its adds.",
         """template <int VB>
__device__ __forceinline__ typename Vec<VB>::T ld_hint(const uint8_t* p) {{
  if constexpr (VB == 16) {{
    uint4 v;
    asm("ld.global.nc{}.v4.u32 {{%0, %1, %2, %3}}, [%4];"
        : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
  }} else {{
    return __ldg(reinterpret_cast<const typename Vec<VB>::T*>(p));
  }}
}}

// One bag's walk: a stage's ids and weights, its rows, its adds.""")


def _hinted(hint):
    return [(_HINT[0], _HINT[1].format(hint)),
            (_LOAD, "        s.r[j].raw = ld_hint<VB>(\n"
                    "            col + static_cast<long long>(rid) * ld);")]


# (name, [(old, new), ...] applied to csrc/embed_agg.cu, {ref constant:
# value})
VARIANTS = (
    ("as built", [], {}),
    # the next stage's rows go out after this stage's adds: one stage in
    # flight; stages of 4 rows (8 rows in flight)
    ("one stage in flight", [
        ("      g.fetch_rows(l + kStage, id_b, w_b, sb);\n"
         "      g.fetch_ids(l + 2 * kStage, id_a, w_a);\n"
         "      g.add(l, sa);\n",
         "      g.add(l, sa);\n"
         "      g.fetch_rows(l + kStage, id_b, w_b, sb);\n"
         "      g.fetch_ids(l + 2 * kStage, id_a, w_a);\n")], {}),
    ("stages of 4 rows", [("constexpr int kStage = 8; ",
                           "constexpr int kStage = 4; ")], {}),
    # pieces of at most 4 / 8 bytes: a 512-byte row is 4 / 2 slices of 32
    # lanes, each reading 128 / 256 contiguous bytes of it
    ("pieces of 4 bytes", [], {"EMBED_MAX_PIECE": 4}),
    ("pieces of 8 bytes", [], {"EMBED_MAX_PIECE": 8}),
    # at most 102 registers: 5 blocks (20 warps) an SM
    ("5 blocks an SM", [("constexpr int kMinBlocks = 4;",
                         "constexpr int kMinBlocks = 5;")], {}),
    # blocks of one and two warps
    ("blocks of 32 threads", [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 32;"),
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 16;")],
     {"EMBED_BLOCK_THREADS": 32}),
    ("blocks of 64 threads", [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 64;"),
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 8;")],
     {"EMBED_BLOCK_THREADS": 64}),
    # rows by plain loads (ld.global), through L2 only (ld.global.cg),
    # evict-first (ld.global.cs)
    ("rows by plain loads", [(_LOAD, _LOAD.replace(
        "__ldg(reinterpret_cast<const typename Vec<VB>::T*>(",
        "*reinterpret_cast<const typename Vec<VB>::T*>(").replace(
        "ld));", "ld);"))], {}),
    ("rows past L1", [(_LOAD, _LOAD.replace("__ldg", "__ldcg"))], {}),
    ("rows evict-first", [(_LOAD, _LOAD.replace("__ldg", "__ldcs"))], {}),
    # many warps with few rows in flight each, as the first design runs:
    # stages of 4 rows at most 64 registers (32 warps an SM), and one
    # stage of 4 in flight at most 40 (48 warps)
    ("stages of 4 rows, 8 blocks an SM", [
        ("constexpr int kStage = 8; ", "constexpr int kStage = 4; "),
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 8;")],
     {}),
    ("one stage of 4 rows in flight, 12 blocks an SM", [
        ("constexpr int kStage = 8; ", "constexpr int kStage = 4; "),
        ("constexpr int kMinBlocks = 4;", "constexpr int kMinBlocks = 12;"),
        ("      g.fetch_rows(l + kStage, id_b, w_b, sb);\n"
         "      g.fetch_ids(l + 2 * kStage, id_a, w_a);\n"
         "      g.add(l, sa);\n",
         "      g.add(l, sa);\n"
         "      g.fetch_rows(l + kStage, id_b, w_b, sb);\n"
         "      g.fetch_ids(l + 2 * kStage, id_a, w_a);\n")], {}),
    # L2 fetches 256 / 128 bytes around each miss; L1 allocates nothing
    ("rows with L2::256B", _hinted(".L2::256B"), {}),
    ("rows with L2::128B", _hinted(".L2::128B"), {}),
    ("rows with L1::no_allocate and L2::256B",
     _hinted(".L1::no_allocate.L2::256B"), {}),
)


def build_variant(index, edits):
    """ctypes handle of csrc/embed_agg.cu with ``edits`` applied."""
    from repro_torch.kernels import build

    text = (build.CSRC / "embed_agg.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"embed_agg.cu no longer has {old!r}")
        text = text.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"embed_agg_sweep{index}.cu"
    src.write_text(text)
    lib = build.BUILD_DIR / f"libembed_agg_sweep{index}.so"
    return subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                             str(lib), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), lib


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from redesign_check import first_design_library
    from repro_torch.device import resolve_device
    from repro_torch.kernels import embed_agg as emb
    from repro_torch.kernels import ref

    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("embed_sweep: no CUDA card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    variants = [v for v in VARIANTS if args.only is None or v[0] in
                args.only or v[0] == "as built"]
    jobs = [build_variant(i, v[1]) for i, v in enumerate(variants)]
    libs = {}
    for (name, _, consts), (proc, lib) in zip(variants, jobs):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(line.split("Used")[1].split()[0])
                for line in log.splitlines() if "registers" in line]
        spills = [int(line.split("bytes spill stores")[0].split()[-1])
                  for line in log.splitlines() if "spill stores" in line]
        print(json.dumps({"variant": name, "max_registers": max(regs),
                          "max_spill_store_bytes": max(spills)}), flush=True)
        libs[name] = (ctypes.CDLL(str(lib)), consts)
    old = first_design_library()

    rng = np.random.default_rng(2)
    rows, dim = cs.EMBED["rows"], cs.EMBED["dim"]
    table = torch.from_numpy(rng.standard_normal(
        (rows, dim), dtype=np.float32)).to(cs.DEVICE)
    shape = (cs.EMBED["bags"], cs.EMBED["lookups"])
    zipf = torch.from_numpy(((rng.zipf(1.2, shape) - 1) % rows).astype(
        np.int32)).to(cs.DEVICE)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(
        np.float32)).to(cs.DEVICE)
    wide = torch.from_numpy(rng.integers(
        0, rows, (cs.EMBED_WIDE["bags"], cs.EMBED_WIDE["lookups"]),
        dtype=np.int32)).to(cs.DEVICE)
    uniform = torch.from_numpy(rng.integers(0, rows, shape, dtype=np.int32)
                               ).to(cs.DEVICE)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    cases = (("2048 Zipf bags x 16, unweighted", zipf, None),
             ("2048 Zipf bags x 16, weighted", zipf, w),
             ("2048 uniform bags x 16, unweighted", uniform, None),
             ("16,384 uniform bags x 64, unweighted (byte-bound)", wide,
              None))
    built_bind = emb._bind
    for case, ix, weights in cases:
        want = ref.embed_agg_ref(table, ix, weights)
        out = torch.empty_like(want)
        stream = torch.cuda.current_stream().cuda_stream

        def first(ix=ix, weights=weights, out=out):
            err = old.embed_agg(table.data_ptr(), ix.data_ptr(),
                                None if weights is None else
                                weights.data_ptr(), out.data_ptr(),
                                ix.shape[0], ix.shape[1], dim, stream)
            if err:
                raise RuntimeError(f"first design embed_agg: cudaError_t "
                                   f"{err}")
        first()
        cs.same_bits(torch, out, want, f"first design {case}")
        for _ in range(args.rounds):
            for name, (lib, consts) in [*libs.items(),
                                        ("first design", (None, {}))]:
                if lib is None:
                    fn = first
                else:
                    saved = {k: getattr(ref, k) for k in consts}
                    for k, v in consts.items():
                        setattr(ref, k, v)
                    emb._bind = _binder(lib)

                    def fn(ix=ix, weights=weights):
                        return emb.launch_embed_agg(table, ix, weights)
                    cs.same_bits(torch, fn(), want, f"{name} {case}")
                ms = cs.time_ms(torch, fn, flush)
                if lib is not None:
                    emb._bind = built_bind
                    for k, v in saved.items():
                        setattr(ref, k, v)
                print(json.dumps({"case": case, "variant": name, "ms": ms}),
                      flush=True)
    print(smi, flush=True)
    return 0


def _binder(lib):
    """``embed_agg._bind`` over another build of the library."""
    from repro_torch.kernels import embed_agg as emb

    def bind(name):
        fn = getattr(lib, name)
        fn.argtypes = emb._ARGTYPES[name]
        fn.restype = ctypes.c_int
        return fn
    return bind


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
