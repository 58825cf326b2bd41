"""Check and time the scan, top-k, paged-attention, flash, wkv and
embedding kernels on one card.

    python scripts/redesign_check.py [topk] [pools] [paged] [flash] [wkv]
                                     [swizzle] [scan] [scan-split] [embed]
                                     [train] [wkv-bwd] [--logs DIR]

Builds every kernel source (``kernels.build.build_all``; with ``--logs``
nvcc's ``-Xptxas -v`` report of each source is written to DIR), then
runs ``chip_smoke.topk_cases`` (the 1M x 768 corpus on f32, int8 and fp8
pages, k 4 and 128, dot and cosine, bit-identical to the plain version)
and ``chip_smoke.flash_cases`` (flash attention at granite-3-2b's,
phi3-mini's and a D = 128, G = 8 prefill shape, within 1e-4), each timed
by ``chip_smoke.time_ms`` beside its bound and a library call, and each
kernel's untimed check at other shapes (``topk_other_shapes``,
``flash_other_shapes``).  ``pools`` runs ``chip_smoke.topk_pool_cases``
(the corpus on pages of 2,048 rows, the lineitem extent in an int8 store
of 24 columns and on int8 pages of 6 rows) and ``topk_other_shapes``;
``paged`` runs ``chip_smoke.phase_kernels`` (paged attention at the
serving shapes, timed, and at ``OTHER_SHAPES``); ``wkv`` runs
``chip_smoke.wkv_cases`` and ``wkv_other_shapes``.
``swizzle`` times the top-k against a build of ``csrc/isp_scan.cu``
whose stages are not swizzled (row t reads its 16-byte chunk j at j, so
the eight rows of a quarter warp share four banks), in turns (as built,
unswizzled, unswizzled, as built) on the corpus's f32 and int8 pools at
k = 4, dot; both must give the plain version's block.  ``scan`` times the
scan (``csrc/isp_scan.cu``) against the two-launch design kept in
``scripts/csrc/isp_scan_two_pass.cu``, in turns (as built, two-pass,
two-pass, as built), over the SF-1 lineitem extent on f32, int8 and fp8
pages (three of ``chip_smoke.SCAN_JOBS`` each), both bit-identical to the
plain version, with the as-built kernel's ordered page fold alone
(``isp_scan.scan_chain_runner``); then ``chip_smoke.scan_cases_timed``
and ``scan_other_shapes``.  ``scan-split`` times the two-pass design's
launches apart (the pages pass, the fold) and together.  ``embed`` times
the embedding bag and gather (``csrc/embed_agg.cu``) against the first
design kept in ``scripts/csrc/embed_agg_pr12.cu`` (built by the script),
in turns (as built, first design, first design, as built): the 4M x 128
f32 table's 2048 Zipf bags of 16, unweighted and weighted, the byte-bound bag
(``chip_smoke.EMBED_WIDE``) and the corpus token gather, both designs
bit-identical to the plain version; then ``chip_smoke.embed_cases``
(with its floors and ``embed_other_shapes``).  ``train`` builds the two
flash sources only, times the flash backward against its first design
kept in ``scripts/csrc/flash_attention_bwd_pr22.cu`` (built by the
script) in turns (as built, first design, first design, as built) at
granite-3-2b's
attention at 8 x 512 and 4 x 512 tokens and phi3-mini-3.8b's, both held
to the plain backward, and runs ``chip_smoke.flash_train_cases`` (the
forward with lse and the backward at granite-3-2b's and phi3-mini's
attention, timed beside SDPA's backward), ``flash_train_other_shapes``
and ``chip_smoke.phase_train`` (granite-3-2b trained at full depth and
width, then the 2-layer gates).  ``wkv-bwd`` builds the two wkv sources
only, prints ptxas's registers and spills of the wkv backward's kernels
and of its first design (a block per (batch, head) walking every step's
whole work in reverse, kept in ``scripts/csrc/rwkv_scan_bwd_pr25.cu`` and
built by the script), times the two designs in turns (as built, first
design, first design, as built) at rwkv6-3b's training shapes (B = 4 and
8 x 512 tokens, 40 heads of 64), both held to the plain backward within
``chip_smoke.WKV_TOL`` x max(1, max |plain|) on every gradient and each
bit-equal over two runs, then runs ``chip_smoke.wkv_train_cases`` and
``wkv_train_other_shapes`` (about 3 min with the builds).  Prints one
JSON line per case or reading, the kernels line, then the card's name
and power limit.  With no case named, topk and flash run.  Card only.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


# the swizzle off: a plain box, and each row's chunks in place
UNSWIZZLE = (("CU_TENSOR_MAP_SWIZZLE_128B", "CU_TENSOR_MAP_SWIZZLE_NONE"),
             ("score_chunk<CODE, COS>(row, j ^ sw,",
              "score_chunk<CODE, COS>(row, j,"))


def unswizzled_library():
    """ctypes handle of csrc/isp_scan.cu built with UNSWIZZLE applied."""
    from repro_torch.kernels import build

    return build.build_variant(build.CSRC / "isp_scan.cu", UNSWIZZLE,
                               "isp_scan_unswizzled")[0]


def swizzle_readings(torch, np, cs, flush):
    from repro_torch.kernels import isp_scan, ops

    variant = unswizzled_library()
    built = isp_scan._bind
    data = cs.make_data(np)
    pr = cs.CORPUS["page_rows"]
    x, table = cs.on_pages(torch, data["corpus"], pr)
    n_rows = data["corpus"].shape[0]
    q = torch.from_numpy(data["corpus"][cs.DUP_IDS[0]].copy()).to(cs.DEVICE)
    pools = cs.quantized_pools(torch, x)
    for code in ("f32", "int8"):
        pages, scales = pools[code]

        def run():
            return ops.topk_scan(pages, table, n_rows, q, k=4, scales=scales)
        want = ops.ref.topk_scan_ref(pages, table, n_rows, q, k=4,
                                     scales=scales)
        for build_name in ("as built", "unswizzled", "unswizzled",
                           "as built"):
            isp_scan._bind = built if build_name == "as built" else (
                lambda name: isp_scan.typed(getattr(variant, name), name))
            cs.exact(torch, run(), want, f"{build_name} {code}")
            print(json.dumps({"swizzle": build_name, "pages": code,
                              "case": "1M x 768 corpus, k=4, dot",
                              "ms": cs.time_ms(torch, run, flush)}),
                  flush=True)
        isp_scan._bind = built


TWO_PASS = ROOT / "scripts" / "csrc" / "isp_scan_two_pass.cu"
# the SF-1 lineitem jobs the scan readings take (chip_smoke.SCAN_JOBS)
SCAN_READ_JOBS = ("all", "ge extendedprice", "ne returnflag")


def two_pass_library():
    """ctypes handle of the two-launch scan (``TWO_PASS``), built into
    build/repro_torch."""
    import ctypes

    from repro_torch.kernels import build

    handle = build.build_variant(TWO_PASS, (), "isp_scan_two_pass")[0]
    P, I, F, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    for fmt in ("f32", "int8", "fp8"):
        getattr(handle, f"scan_pages_{fmt}").argtypes = (
            [P] * 4 + [I, I, I, LL, F, I, I, P])
        getattr(handle, f"scan_two_pass_{fmt}").argtypes = (
            [P] * 5 + [I, I, I, LL, F, I, I, P])
    handle.scan_fold.argtypes = [P, P, I, I, P]
    return handle


def scan_cases(torch, np, cs):
    """(case, pages, scales, table, n_rows, col, op, thr) over the SF-1
    lineitem extent on f32, int8 and fp8 pools, SCAN_READ_JOBS each."""
    li, _ = cs.make_lineitem(np)
    x, table = cs.on_pages(torch, li, cs.LINEITEM["page_rows"])
    for code, (pages, scales) in cs.quantized_pools(torch, x).items():
        for label, col, op, thr in cs.SCAN_JOBS:
            if label in SCAN_READ_JOBS:
                yield (f"SF-1 lineitem {label} col{col} ({code})", pages,
                       scales, table, li.shape[0], col, op, thr)


def two_pass_runners(torch, lib, pages, scales, table, n_rows, col, op,
                     thr):
    """(both, pages alone, fold alone, out) launching the two-launch
    scan on the current stream."""
    from repro_torch.kernels import isp_scan
    from repro_torch.kernels.ref import FILTER_OPS, n_valid_pages

    n_phys, page_rows, n_cols = pages.shape
    n_valid = n_valid_pages(n_rows, page_rows, table.numel())
    fmt = isp_scan._CODE[pages.dtype]
    partials = torch.empty((n_valid, 4, n_cols), device=pages.device)
    out = torch.empty((8, n_cols), device=pages.device)
    stream = torch.cuda.current_stream().cuda_stream
    sc = None if scales is None else scales.data_ptr()
    args = (n_valid, page_rows, n_cols, n_rows, float(thr), col,
            FILTER_OPS.index(op), stream)

    def check(err):
        if err:
            raise RuntimeError(f"two-pass scan launch: cudaError_t {err}")

    def both():
        check(getattr(lib, f"scan_two_pass_{fmt}")(
            pages.data_ptr(), sc, table.data_ptr(), partials.data_ptr(),
            out.data_ptr(), *args))

    def pages_alone():
        check(getattr(lib, f"scan_pages_{fmt}")(
            pages.data_ptr(), sc, table.data_ptr(), partials.data_ptr(),
            *args))

    def fold_alone():
        check(lib.scan_fold(partials.data_ptr(), out.data_ptr(), n_valid,
                            n_cols, stream))
    return both, pages_alone, fold_alone, out


def scan_split_readings(torch, np, cs, flush):
    """The two-launch scan's launches timed apart, and both."""
    from repro_torch.kernels import ops

    lib = two_pass_library()
    for case, pages, scales, table, n_rows, col, op, thr in scan_cases(
            torch, np, cs):
        both, pages_alone, fold_alone, out = two_pass_runners(
            torch, lib, pages, scales, table, n_rows, col, op, thr)
        both()
        cs.exact(torch, out, ops.ref.scan_filter_reduce_ref(
            pages, table, n_rows, thr, scales=scales, filter_col=col,
            filter_op=op), f"two-pass {case}")
        print(json.dumps({"scan_split": case,
                          "both_ms": cs.time_ms(torch, both, flush),
                          "pages_ms": cs.time_ms(torch, pages_alone, flush),
                          "fold_ms": cs.time_ms(torch, fold_alone, flush)}),
              flush=True)


def scan_readings(torch, np, cs, flush):
    """The scan as built against the two-launch scan, in turns (as built,
    two-pass, two-pass, as built), both bit-identical to the plain
    version; and the as-built kernel's ordered chain alone."""
    from repro_torch.kernels import isp_scan, ops

    lib = two_pass_library()
    for case, pages, scales, table, n_rows, col, op, thr in scan_cases(
            torch, np, cs):
        def new(pages=pages, scales=scales, table=table, n_rows=n_rows,
                col=col, op=op, thr=thr):
            return ops.scan_filter_reduce(pages, table, n_rows, thr,
                                          scales=scales, filter_col=col,
                                          filter_op=op)
        old, _, _, out = two_pass_runners(torch, lib, pages, scales, table,
                                          n_rows, col, op, thr)
        want = ops.ref.scan_filter_reduce_ref(
            pages, table, n_rows, thr, scales=scales, filter_col=col,
            filter_op=op)
        cs.exact(torch, new(), want, f"as built {case}")
        old()
        cs.exact(torch, out, want, f"two-pass {case}")
        chain = isp_scan.scan_chain_runner(pages, table, n_rows, thr,
                                           scales=scales, filter_col=col,
                                           filter_op=op)
        reading = {"scan": case}
        for name, fn in (("as built", new), ("two-pass", old),
                         ("two-pass", old), ("as built", new)):
            reading.setdefault(f"{name} ms", []).append(
                cs.time_ms(torch, fn, flush))
        reading["chain alone ms"] = cs.time_ms(torch, chain, flush)
        print(json.dumps(reading), flush=True)


FIRST_DESIGN = ROOT / "scripts" / "csrc" / "embed_agg_pr12.cu"


def first_design_library():
    """ctypes handle of the first embedding design (``FIRST_DESIGN``),
    built into build/repro_torch."""
    import ctypes

    from repro_torch.kernels import build

    handle = build.build_variant(FIRST_DESIGN, (), "embed_agg_first")[0]
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    handle.embed_agg.argtypes = [P] * 4 + [I, I, I, P]
    handle.embed_gather_i32.argtypes = [P] * 3 + [LL, I, P]
    return handle


def embed_readings(torch, np, cs, data, flush):
    """The embedding kernels as built against the first design, in turns
    (as built, first design, first design, as built), both bit-identical
    to the plain version."""
    from repro_torch.kernels import embed_agg as emb
    from repro_torch.kernels import ops

    lib = first_design_library()
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

    def check(err, what):
        if err:
            raise RuntimeError(f"first design {what} launch: cudaError_t "
                               f"{err}")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    for case, ix, weights in (("2048 Zipf bags x 16, unweighted", zipf, None),
                              ("2048 Zipf bags x 16, weighted", zipf, w),
                              ("16,384 uniform bags x 64, unweighted "
                               "(byte-bound)", wide, None)):
        out = torch.empty((ix.shape[0], dim), device=cs.DEVICE)

        def new(ix=ix, weights=weights):
            return emb.launch_embed_agg(table, ix, weights)

        def old(ix=ix, weights=weights, out=out):
            check(lib.embed_agg(table.data_ptr(), ix.data_ptr(),
                                None if weights is None else
                                weights.data_ptr(), out.data_ptr(),
                                ix.shape[0], ix.shape[1], dim, stream()),
                  "embed_agg")
        want = ops.ref.embed_agg_ref(table, ix, weights)
        cs.same_bits(torch, new(), want, f"as built {case}")
        old()
        cs.same_bits(torch, out, want, f"first design {case}")
        reading = {"embed_agg": f"{rows} x {dim} f32 table, {case}"}
        for name, fn in (("as built", new), ("first design", old),
                         ("first design", old), ("as built", new)):
            reading.setdefault(f"{name} ms", []).append(
                cs.time_ms(torch, fn, flush))
        print(json.dumps(reading), flush=True)
    del table
    tokens = torch.from_numpy(data["corpus_tokens"]).to(cs.DEVICE)
    gidx = torch.from_numpy(rng.integers(0, tokens.shape[0], (8, cs.RAG["k"]),
                                         dtype=np.int32)).to(cs.DEVICE)
    out = torch.empty((8, cs.RAG["k"], tokens.shape[1]), dtype=torch.int32,
                      device=cs.DEVICE)

    def new_gather():
        return emb.launch_embed_gather(tokens, gidx)

    def old_gather():
        check(lib.embed_gather_i32(tokens.data_ptr(), gidx.data_ptr(),
                                   out.data_ptr(), gidx.numel(),
                                   tokens.shape[1], stream()), "embed_gather")
    want = ops.ref.embed_gather_ref(tokens, gidx)
    cs.same_bits(torch, new_gather(), want, "as built gather")
    old_gather()
    cs.same_bits(torch, out, want, "first design gather")
    reading = {"embed_gather": f"corpus_tokens {list(tokens.shape)} int32, "
               f"ids {list(gidx.shape)}"}
    for name, fn in (("as built", new_gather), ("first design", old_gather),
                     ("first design", old_gather), ("as built", new_gather)):
        reading.setdefault(f"{name} ms", []).append(
            cs.time_ms(torch, fn, flush))
    print(json.dumps(reading), flush=True)
    del tokens
    torch.cuda.empty_cache()


FIRST_BWD_DESIGN = ROOT / "scripts" / "csrc" / "flash_attention_bwd_pr22.cu"
# (label, B, H, Hkv, S, D), causal: granite-3-2b's attention at a train
# batch of 8 x 512 and at the train phase's microbatch of 4 x 512, and
# phi3-mini-3.8b's (32 heads of 96, no grouping)
TRAIN_COMPARE = (("granite-3-2b train", 8, 32, 8, 512, 64),
                 ("granite-3-2b train microbatch", 4, 32, 8, 512, 64),
                 ("phi3-mini-3.8b train", 8, 32, 32, 512, 96))


def first_bwd_library():
    """ctypes function of the backward's first design
    (``FIRST_BWD_DESIGN``),
    built into build/repro_torch."""
    import ctypes

    from repro_torch.kernels import build

    handle = build.build_variant(FIRST_BWD_DESIGN, (),
                                 "flash_attention_bwd_first")[0]
    fn = handle.flash_attention_bwd_f32
    # q, k, v, out, dout, lse, di, dq, dk, dv, B, H, Hkv, Sq, Sk, D,
    # causal, stream
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def train_readings(torch, np, cs, flush):
    """The flash backward as built against its first design at
    ``TRAIN_COMPARE``, in turns (as built, first design, first design, as
    built); both
    held to the plain backward within ``chip_smoke.BWD_TOL`` x max(1,
    max |plain|) on dq, dk and dv, and each deterministic."""
    from repro_torch.kernels import ops

    old_fn = first_bwd_library()
    rng = np.random.default_rng(23)
    for label, b, h, hkv, s, d in TRAIN_COMPARE:
        q, do = (torch.from_numpy(rng.standard_normal(
            (b, h, s, d), dtype=np.float32)).to(cs.DEVICE) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, s, d), dtype=np.float32)).to(cs.DEVICE)
            for _ in range(2))
        out, lse = ops.flash_attention_lse(q, k, v, causal=True)
        old = [torch.empty_like(t) for t in (q, k, v)]
        di = torch.empty((b, h, s), dtype=torch.float32, device=q.device)

        def new_run():
            return ops.flash_attention_bwd(q, k, v, out, lse, do, True)

        def old_run():
            err = old_fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), do.data_ptr(), lse.data_ptr(),
                         di.data_ptr(), *(t.data_ptr() for t in old), b, h,
                         hkv, s, s, d, 1,
                         torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"first design: cudaError_t {err}")

        want = ops.ref.flash_attention_bwd_ref(q, k, v, out, lse, do, True)
        reading = {"flash_attention_bwd_f32":
                   f"causal B={b} H={h} Hkv={hkv} S={s} D={d} ({label})"}
        for name, run in (("as built", new_run), ("first design", old_run)):
            first = [t.clone() for t in (run() or old)]
            again = run() or old
            torch.cuda.synchronize()
            for grad, a, o, w in zip(("dq", "dk", "dv"), first, again, want):
                lim = cs.BWD_TOL * max(1.0, float(w.abs().max()))
                e = float((o - w).abs().max())
                cs.check(torch.equal(a, o), f"{name} {label} {grad}: two "
                         f"runs differ")
                cs.check(e <= lim, f"{name} {label} {grad}: {e} > {lim}")
                reading[f"{name} {grad} err_vs_plain"] = e
        for name, run in (("as built", new_run), ("first design", old_run),
                          ("first design", old_run), ("as built", new_run)):
            reading.setdefault(f"{name} ms", []).append(
                cs.time_ms(torch, run, flush))
        print(json.dumps(reading), flush=True)
        del q, k, v, do, out, lse, old, di, want
        torch.cuda.empty_cache()


FIRST_WKV_BWD_DESIGN = ROOT / "scripts" / "csrc" / "rwkv_scan_bwd_pr25.cu"


def first_wkv_bwd_library():
    """(ctypes function of the wkv backward's first design
    (``FIRST_WKV_BWD_DESIGN``), built into build/repro_torch; nvcc's
    ``-Xptxas -v`` report)."""
    import ctypes

    from repro_torch.kernels import build

    handle, log = build.build_variant(FIRST_WKV_BWD_DESIGN, (),
                                      "rwkv_scan_bwd_first")
    fn = handle.rwkv_scan_bwd_f32
    # r k v logw u states sT do dsT dr dk dv dlogw du ds0 ws tickets,
    # n_tickets B S H dk dv step, stream
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 +
                   [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, log


def wkv_bwd_readings(torch, np, cs, flush, as_built_log):
    """The wkv backward as built against its first design at rwkv6-3b's
    training shapes (``chip_smoke.WKV_TRAIN_BATCHES``), in turns (as built,
    first design, first design, as built); both held to the plain backward
    within ``chip_smoke.WKV_TOL`` x max(1, max |plain|) on every gradient
    and each bit-equal over two runs."""
    from repro_torch.kernels import build, ops

    old_fn, old_log = first_wkv_bwd_library()
    for name, log in (("as built", as_built_log), ("first design", old_log)):
        print(json.dumps({"ptxas": f"rwkv_scan_bwd ({name})",
                          "lines": build.ptxas_lines(log)}), flush=True)
    rng = np.random.default_rng(29)
    s, h, dk, dv, chunk = (cs.WKV[k] for k in ("seq", "heads", "dk", "dv",
                                               "chunk"))
    step = ops.ref.wkv_step_tokens(chunk)
    for b in cs.WKV_TRAIN_BATCHES:
        args = cs.wkv_train_inputs(torch, np, rng, b, s, h, dk, dv)
        r, k, v, logw, u, s0, do, dsT = args
        _, s_t, states = ops.rwkv_scan_states(r, k, v, logw, u, s0,
                                              chunk=chunk)
        old = [torch.empty_like(x) for x in (r, k, v, logw, u, s0)]
        ws = torch.empty((b, h, dk), dtype=torch.float32, device=r.device)
        tickets = torch.zeros(h, dtype=torch.int32, device=r.device)

        def new_run():
            return ops.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do,
                                     dsT, chunk=chunk)

        def old_run():
            err = old_fn(*(t.data_ptr() for t in (
                r, k, v, logw, u, states, s_t, do, dsT, *old, ws, tickets)),
                tickets.numel(), b, s, h, dk, dv, step,
                torch.cuda.current_stream().cuda_stream)
            cs.check(err == 0, f"first design: cudaError_t {err}")

        want = ops.ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                           chunk=chunk)
        reading = {"rwkv_scan_bwd_f32": f"B={b} S={s} H={h} dk={dk} dv={dv} "
                   f"chunk {chunk} (step {step}), logw = -exp(N(0,1)) "
                   "(rwkv6-3b train shapes)",
                   "bound_ms": cs.wkv_bwd_bound(b, s, h, dk, dv, step)}
        for name, run in (("as built", new_run), ("first design", old_run)):
            first = [t.clone() for t in (run() or old)]
            again = run() or old
            torch.cuda.synchronize()
            for grad, a, o, w in zip(cs.WKV_GRADS, first, again, want):
                lim = cs.WKV_TOL * max(1.0, float(w.abs().max()))
                e = float((o - w).abs().max())
                cs.check(torch.equal(a, o), f"{name} B={b} {grad}: two runs "
                         f"differ")
                cs.check(e <= lim, f"{name} B={b} {grad}: {e} > {lim}")
                reading[f"{name} {grad} err_vs_plain"] = e
        for name, run in (("as built", new_run), ("first design", old_run),
                          ("first design", old_run), ("as built", new_run)):
            reading.setdefault(f"{name} ms", []).append(
                cs.time_ms(torch, run, flush))
        print(json.dumps(reading), flush=True)
        del args, r, k, v, logw, u, s0, do, dsT, s_t, states, old, ws, want
        torch.cuda.empty_cache()


def main(argv) -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build

    logs_dir = None
    if "--logs" in argv:
        logs_dir = Path(argv[argv.index("--logs") + 1])
        argv = [a for a in argv if a not in ("--logs", str(logs_dir))]
    which = set(argv) or {"topk", "flash"}
    if which - {"topk", "pools", "paged", "flash", "wkv", "swizzle", "scan",
                "scan-split", "embed", "train", "wkv-bwd"}:
        print(f"redesign_check: unknown case {which}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("redesign_check: no CUDA card", file=sys.stderr)
        return 1
    resolve_device("cuda")
    smi = cs.phase_env(torch)
    t0 = time.monotonic()
    logs = build.build_all(
        ["flash_attention", "flash_attention_bwd"] if which == {"train"} else
        ["rwkv_scan", "rwkv_scan_bwd"] if which == {"wkv-bwd"} else None)
    print(json.dumps({"build_s": time.monotonic() - t0}), flush=True)
    if logs_dir is not None:
        logs_dir.mkdir(parents=True, exist_ok=True)
        for name, log in logs.items():
            (logs_dir / f"{name}.ptxas.txt").write_text(log)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=cs.DEVICE)
    results = []
    if "topk" in which:
        results += cs.topk_cases(torch, cs.make_data(np), flush)
        cs.topk_other_shapes(torch, np)
    if "pools" in which:
        results += cs.topk_pool_cases(torch, np, cs.make_data(np), flush)
        cs.topk_other_shapes(torch, np)
    if "paged" in which:
        results += cs.phase_kernels(torch, np)
    if "wkv" in which:
        results += cs.wkv_cases(torch, np, flush)
        cs.wkv_other_shapes(torch, np)
    if "flash" in which:
        results += cs.flash_cases(torch, np, flush)
        cs.flash_other_shapes(torch, np)
    if "train" in which:
        train_readings(torch, np, cs, flush)
        results += cs.flash_train_cases(torch, np, flush)
        cs.flash_train_other_shapes(torch, np)
        counts = cs.phase_train(torch, np, smi)
        for entry in results:
            if entry["kernel"] in ("flash_attention_fwd_lse_f32",
                                   "flash_attention_bwd_f32"):
                entry["launches"] = counts[entry["kernel"]]
    if "wkv-bwd" in which:
        wkv_bwd_readings(torch, np, cs, flush, logs.get("rwkv_scan_bwd", ""))
        results += cs.wkv_train_cases(torch, np, flush)
        cs.wkv_train_other_shapes(torch, np)
    if "swizzle" in which:
        swizzle_readings(torch, np, cs, flush)
    if "scan-split" in which:
        scan_split_readings(torch, np, cs, flush)
    if "scan" in which:
        scan_readings(torch, np, cs, flush)
        li, _ = cs.make_lineitem(np)
        results += cs.scan_cases_timed(torch, li, flush)
        cs.scan_other_shapes(torch, np, li)
    if "embed" in which:
        data = cs.make_data(np)
        embed_readings(torch, np, cs, data, flush)
        results += cs.embed_cases(torch, np, data, flush)
    print(json.dumps({"kernels": results}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
