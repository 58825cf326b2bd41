#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's paths (serving, in-storage processing, training) on
the card, in phases; each phase prints JSON lines and any failure exits
non-zero:

  env      the card (name and power limit from nvidia-smi), torch and
           CUDA versions; fails when torch.cuda.is_available() is false
  build    nvcc builds every kernel source of the checkout (one nvcc per
           source, all started together), timed
  kernels  each kernel against its plain version, timed with CUDA events
           (device time: a sleep kernel holds the card while the host
           enqueues) beside its bound and a library call: paged attention
           at the serving path's shapes, f32, int8 and fp8 pages, within
           1e-4 (and the pool form at 4 nodes x 80 pages, placed and
           striped, decode and chunk: node partials against the plain
           per-node partials, the merge inside its launch bit-equal to
           paged_combine_f32 of its unmerged partials, 1 node bit-equal
           to the single forms; untimed at POOL_SHAPES on 2 and 4 nodes,
           placed, striped and random, and on rows of 1,100 one-token
           pages):
           the decode form on four decode batches (ragged 0..1000,
           the serve phase's 513..576, one row of 4,000, a verify pass
           of 8 sequences x 8 rows at 513..576), its per-split
           partials against the plain split emulation, the combine
           kernel alone, and a prefill chunk through the chunk form
           (expanded page row) and the decode form (contiguous table);
           both forms untimed at OTHER_SHAPES (head dims 8-256 that are
           multiples of 8, pages up to 256 tokens, groups up to 64);
           the scan over a TPC-H SF-1 lineitem
           extent (6,001,215 rows x 16 f32 columns, page 128; five filter
           jobs on f32, int8 and fp8 pools, a pow2-padded table and an
           empty result; one launch a call, beside its byte bound and
           its chain bound, the kernel's ordered page fold alone), and
           untimed at SCAN_SHAPES, on the lineitem extent's other pools
           and at SCAN_C3 (40M rows, a count past 2^24 that must be the
           page-order fold's), the top-k over a 1M x 768 corpus (k 4 and 128,
           dot and cosine, planted duplicate rows), the embedding bag
           (4M x 128 table: 2048 Zipf bags of 16 on f32, weighted and
           not, and on bf16; 16,384 uniform bags of 64, byte-bound) and
           the token-block gather, beside their measured floors (an
           empty kernel on the call's grid, an id-then-row probe), and
           untimed at EMBED_DIMS x EMBED_LOOKUPS on every table dtype and
           gathers of 1-8-byte rows, each bit-identical to its plain
           version with one launch a call; the top-k
           also over the corpus on pages of 2,048 rows, the lineitem
           extent in an int8 store of 24 columns and on int8 pages of 6
           rows (timed), and untimed at TOPK_SHAPES
  serve    PagedServer over full-width granite-3-2b (40 layers, random
           f32 weights from a seeded torch.Generator): 8 prompts of 512
           tokens, prefill chunks of 256, 64 greedy tokens at horizon 1
           and at horizon 8 (tokens must be identical), the first decode
           step's logits against the plain-attention step_reference, then
           int8 and fp8 page passes; kernel launch counters reset just
           before and read just after (every prefill chunk through the
           chunk form, every decode step through the decode form, per
           page type); a few horizon-1 steps under
           torch.profiler give the step's device busy time
  serve_spec
           sampled and speculative serving and the continuous batcher on
           the serve phase's weights: 8 prompts of 512 tokens (the serve
           phase's first four, four that repeat a seeded 16-token phrase
           32 times), 64 tokens each: greedy per-token (its first four
           against the serve phase's) and speculative at H=8; sampled at
           temperature 0.8, top-p 0.9, seed 0 per-token, at H=8
           (identical) and speculative; a cold sampler (0.05) plain and
           speculative; int8 and fp8 pages, greedy plain and
           speculative (16 tokens); a ContinuousBatcher (max_active 8,
           H=8, speculative, sampled, prefill chunks of 256) over these
           8 and 8 more requests of the two kinds, each against its
           request's stream from decode.  Streams the reference holds
           identical may differ only at a near-tie: the first position
           that differs is printed with the per-token run's gap between
           its two largest scores there (logits, or lp + g when sampled),
           which must be below 1e-3.  Verify passes launch the decode
           form on f32, int8 and fp8 pages; tok/s, speculation telemetry
           and the batcher's TTFT and latency percentiles are printed,
           launch counters reset just before and read just after
  serve_pool
           pool serving on the same weights and prompts: a 1-node
           PoolServer against PagedServer bit for bit (prefill logits
           and every step's logits; f32 and int8 at h1 and h8, fp8 at
           h8); 4-node placed and striped and 2-node placed pools on the
           serve phase's 320-page store, prefill logits within 1e-4 of
           the 1-node run and tokens at h1, h8 and speculative H=8 by
           the near-tie rule; then a PoolRouter over StoragePool(4)
           (nodes of 160 pages): uninterrupted, a node killed after two
           router steps (requeue and re-prefill on the survivors), the
           same kill on the lossy fault plan (tokens equal to the
           fault-free kill's, every kind of fault injected, NACKs equal
           to the corruptions), a warm drain (one MIGRATE frame a moved
           page) and an active=2 pool of bucket 4 that grows to 3 under
           load and drains back; tok/s by node count, TTFT, requeues,
           control frames per 1k tokens and a profiled 4-node h1 step
           are printed, launch counters reset just before and read just
           after
  serve_reduced
           the launcher's --paged --reduced path (granite-3-2b reduced,
           head_dim 16) at pages of 16 and of 128 tokens: tokens
           identical at horizon 1 and 8, the first step's logits within
           1e-3 of step_reference; launch counters reset and read
  isp      the in-storage path through the port's entry points, launch
           counters reset just before and read just after: a 4-node
           StoragePool pulls the analytics image, a node ingests a table
           through λFS, a job goes through the docker-cli front door, the
           SF-1 extent is scanned in storage through one JOB frame, the
           OffloadPlanner runs jobs on the device and on the host (blocks
           bit-identical), the extent on int8 and fp8 pools takes a scan
           and a top-k job, top-k jobs run over f32 pages of 1,024 rows
           and an int8 store of 24 columns, a dlrm-embed container
           runs, and RAG over the 1M x 768 corpus feeds the serve
           phase's granite-3-2b in two waves (the second rides the
           prefix cache)

  dense    the launcher's default (non-paged) path through get_model +
           make_serving_fns, launch counters reset just before and read
           just after each model: the serve phase's granite-3-2b on its 8
           prompts of 512 tokens, phi3-mini-3.8b at full width cut to 2
           layers (head_dim 96) on 8 prompts of 512 tokens, 16 greedy
           tokens, then full-width rwkv6-3b (32 layers, d_model 2560,
           random f32 weights) on 8 prompts of 512 tokens, 64 greedy
           tokens each; prefill and first decode-step logits within 1e-3
           of the same path with the plain kernel versions on the card
           and greedy tokens identical to it; granite's first decode step
           within 1e-3 of the paged serve phase's; one prefill and a few
           decode steps of each under torch.profiler
  train    granite-3-2b trained at full width and depth, then 2 layers
           of that width against the plain attention, a λFS restart,
           int8 compression, learnable data, the launcher and quickstart
  families the archs no earlier phase runs, each built on the card from
           a seeded generator in f32 and freed before the next, launch
           counters reset just before and read just after each:
           phi3.5-moe-42b-a6.6b at full width cut to 4 layers (the
           routed-row MoE against the dense dispatch on 64 tokens; dense
           prefill of 8 x 512 and 4 decode steps; PagedServer at h1 and
           h8 on f32 pages and at h8 on int8 pages, a 2-node PoolServer,
           32 tokens each: tokens identical across dense, paged h1, h8
           and the pool, the first paged decode step within 1e-4 of the
           dense one), llama4-scout-17b-a16e cut to 2 layers (prefill and
           4 decode steps within 5e-4 of its forward), granite-3-2b's
           int8 dense-decode cache on the serve phase's weights (softmax
           within 5e-3 of the f32 cache's, decisive tokens equal),
           zamba2-1.2b, paligemma-3b (prefill from 256 patch
           embeddings) and hubert-xlarge (bidirectional) at full width
           and depth; one line a model with its wall time, tokens/s, peak
           memory, attention launches and profiles of a step
  train_families
           training of the families the train phase does not run, each
           built on the card from a seeded generator in f32 through
           launch.train.build and freed before the next, launch counters
           reset just before and read just after its full run: rwkv6-3b
           (the wkv scan through the forward kernel's states variant and
           the backward kernel) and zamba2-1.2b at full depth and width,
           phi3.5-moe-42b-a6.6b at full width cut to 2 of 32 layers; 3
           steps of 8 x 512 tokens, grad-accum 2, remat full, AdamW
           warmup_cosine, one step profiled (GEMM, wkv forward and
           backward, flash ms; idle share, device operations); then at 2
           layers of that width one step's loss (1e-5 rel) and gradients
           (1e-4 x max(1, max|plain|)) against the plain flash and wkv
           versions on the card (for the MoE both paths' routing
           observed: a difference must start at a router margin below
           1e-5, and the plain path is then held to the kernel path's
           routes), a λFS restart bit-equal to the uninterrupted run
           (phi3.5-moe at 1 layer), learnable data whose loss falls, and
           launch.train.main at --reduced for rwkv6-3b and zamba2-1.2b
           with checkpoints and --resume; one line a model

The kernels phase also holds the flash-attention kernel (causal and not
at granite-3-2b's prefill shape, causal at phi3-mini-3.8b's and at
qwen2-72b's heads, and at the families phase's shapes: phi3.5-moe,
llama4-scout's group of 5, zamba2's shared block, paligemma's head_dim
256 on the FMA route, hubert's non-causal head_dim 80; each beside the
bound of its 3xTF32 route and the f32 bound), the paged kernels at
phi3.5-moe's serving shape (head_dim 128, group 4: decode and chunk on
f32 and int8 pages, the pool forms at 2 nodes) and the RWKV6 wkv-scan
kernel (at rwkv6-3b's, and untimed at WKV_SHAPES) against their plain
versions; then the wkv training kernels at rwkv6-3b's train microbatch
(B = 4) and at B = 8, each timed beside its bound and its plain version
(no single PyTorch call computes either): the forward's states variant
(o and sT bit-equal to rwkv_scan_f32, the step states within 1e-4 x
max(1, max|plain|) of ``ref.wkv_states_ref``) and the backward
rwkv_scan_bwd_f32 (its state pass, chunk pass and du sum in one call;
every gradient within 1e-4 x max(1, max|plain|) of
``ref.wkv_chunked_bwd_ref``, bit-equal over two runs, its distance from
float64 autograd and its scratch bytes printed), untimed at WKV_SHAPES
(harsh decays: within the limit or no farther from float64 than the
plain backward).  Then
the kernels line (launches: the serve, serve_spec, serve_pool,
serve_reduced, isp, dense, train, families and train_families phases'
counts, also apart for train and each train_families model; an entry of
a families model's shape also its launches in that model's run), the
nvidia-smi line, and the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

DEVICE = "cuda"
# the serve phase's configuration: full-width granite-3-2b, f32
SERVE = {"arch": "granite-3-2b", "reduced": False, "requests": 8,
         "prompt_len": 512, "gen": 64, "q8_gen": 16, "chunk": 256,
         "page": 16, "hbm_pages": 320}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
F32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12            # H100 SXM TF32 tensor cores, dense
# clock cycles of the sleep kernel ahead of each timed call: about 1 ms
# at the H100's clocks, more than the host takes to enqueue the call
HOLD_CYCLES = 2_000_000
KERNEL_TOL = 1e-4              # f32 outputs ~N(0,1); only the sum order differs
# logits of the kernel path vs the plain-attention reference after 40
# f32 layers: the attention sums differ in order (about 1e-6 relative per
# layer) and the residual stream carries that through every layer
LOGITS_TOL = 1e-3
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {"f32": "src/repro/kernels/paged_attention.py:39",
            "int8": "src/repro/kernels/paged_attention.py:77",
            "fp8": "src/repro/kernels/paged_attention.py:77"}
# the wrappers' two forms, one compiled kernel each per page type
DECODE_OF = {"f32": "paged_decode_f32", "int8": "paged_decode_q8_int8",
             "fp8": "paged_decode_q8_fp8"}
CHUNK_OF = {"f32": "paged_chunk_f32", "int8": "paged_chunk_q8_int8",
            "fp8": "paged_chunk_q8_fp8"}
COMBINE = "paged_combine_f32"
# rows a sequence in a speculative verify pass (the serve_spec horizon)
VERIFY_H = 8


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def phase_env(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "env", "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return smi


def phase_build():
    from repro_torch.kernels import build
    t0 = time.monotonic()
    logs = build.build_all()
    secs = time.monotonic() - t0
    regs, spills = [], []
    for log in logs.values():
        for line in log.splitlines():
            if "Used" in line and "registers" in line:
                regs.append(int(line.split("Used")[1].split()[0]))
            if "spill stores" in line:
                spills.append(int(line.split("bytes spill stores")[0]
                                  .split()[-1]))
    emit({"phase": "build", "seconds": secs, "sources": sorted(logs),
          "kernels_compiled": len(regs),
          "max_registers": max(regs, default=None),
          "max_spill_store_bytes": max(spills, default=None)})


# -- kernels ------------------------------------------------------------------


def time_ms(torch, fn, flush, iters=30, warmup=3):
    """Median of ``iters`` CUDA-event timings of ``fn`` after warm-up,
    with the L2 cache flushed before each (the serving path finds a
    layer's pages cold: a layer's weights pass through L2 in between).
    A sleep kernel holds the card busy while the host enqueues the start
    event, ``fn``'s launches and the end event, so the interval is the
    device's time for ``fn`` alone, not the host's time to launch it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(torch, q, table, lengths, page, hkv, code_bytes, quantized,
          rows_a_sequence=1):
    """Least time for the work on this run's data: bytes (each valid
    k/v slot, its scales, q, out, the table's entries and lengths once;
    a table whose sequences have ``rows_a_sequence`` rows each counted
    once a sequence) over the memory rate, vs f32 operations (4*D per
    query head and valid position) over the f32 rate."""
    b, h, d = q.shape
    pps = table.shape[1]
    pos = torch.arange(pps * page, device=q.device)
    valid = pos[None, :] < lengths[:, None].long()
    slot = table.long().repeat_interleave(page, dim=1) * page + pos % page
    n_slots = int(torch.unique(slot[valid]).numel())
    per_slot = hkv * d * code_bytes * 2 + (hkv * 4 * 2 if quantized else 0)
    table_entries = (pps if table.stride(0) == 0
                     else table.numel() // rows_a_sequence)
    n_bytes = (n_slots * per_slot + 2 * q.numel() * 4 + table_entries * 4 +
               lengths.numel() * 4)
    ops = int(lengths.long().sum()) * h * d * 4
    return bytes_bound(n_bytes, ops)


def kernel_cases(np):
    """Inputs at the serving path's shapes for granite-3-2b (H=32,
    Hkv=8, D=64, page 16), each (name, q, table, lengths, form):
    decode batches through the decode form (ragged lengths 0..1000 over
    a pow2 table of 64 pages; the serve phase's 513..576; one row of
    4,000 of granite-3-2b's 4,096 positions over 256 pages), and a
    prefill chunk of 256 query positions of one sequence (the second
    chunk of a 512-token prompt: lengths 257..512) with its page row
    expanded over the chunk (the chunk form, as ``PagedServer`` passes
    it) and materialised (the decode form)."""
    rng = np.random.default_rng(0)
    h, hkv, d, page, n_phys = 32, 8, 64, 16, 320
    k = rng.standard_normal((n_phys, page, hkv, d), dtype=np.float32)
    v = rng.standard_normal((n_phys, page, hkv, d), dtype=np.float32)

    def table_for(lengths, pps):
        table = np.zeros((len(lengths), pps), np.int32)
        perm = rng.permutation(n_phys)
        used = 0
        for i, n in enumerate(lengths):
            need = -(-int(n) // page)
            table[i, :need] = perm[used:used + need]
            used += need
        return table
    cases = []
    for name, lens, pps in (
            ("decode B=8 lengths 0..1000 pps=64",
             np.array([0, 1, 9, 16, 100, 513, 777, 1000], np.int32), 64),
            ("decode B=8 lengths 513..576 pps=64 (serve phase)",
             np.array([513, 530, 544, 548, 560, 561, 575, 576], np.int32), 64),
            ("decode B=1 length 4000 pps=256",
             np.array([4000], np.int32), 256)):
        q = rng.standard_normal((len(lens), h, d), dtype=np.float32)
        cases.append((name, q, table_for(lens, pps), lens, "decode"))
    row = rng.permutation(n_phys)[:32].astype(np.int32)
    pre_len = np.arange(257, 513, dtype=np.int32)
    q = rng.standard_normal((256, h, d), dtype=np.float32)
    cases.append(("prefill chunk C=256 pps=32, expanded row", q, row,
                  pre_len, "chunk"))
    cases.append(("prefill chunk C=256 pps=32, contiguous table", q, row,
                  pre_len, "decode"))
    # a speculative verify pass: 8 sequences of committed length 512 +
    # 8b, each fed H = 8 positions, one query row a position (lengths
    # 513..576), every row over its sequence's page row
    seq_len = 512 + VERIFY_H * np.arange(8, dtype=np.int32)
    lens = (seq_len[:, None] + np.arange(1, VERIFY_H + 1)).reshape(-1)
    q = rng.standard_normal((len(lens), h, d), dtype=np.float32)
    table = np.repeat(table_for(seq_len + VERIFY_H, 64), VERIFY_H, axis=0)
    cases.append((f"verify pass B=8 x H={VERIFY_H} rows, lengths 513..576 "
                  "pps=64", q, table, lens.astype(np.int32), "verify"))
    return (k, v, page, hkv), cases


def paged_pages(torch, k, v):
    """{page type: (k, v, k_scale, v_scale)} on the card, quantized by
    the port's own page quantizer."""
    from repro_torch.core.kv_tier import quantize_page_kv
    dev = torch.device(DEVICE)
    k_t, v_t = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    pages = {"f32": (k_t, v_t, None, None)}
    for code, dtype, qmax in (("int8", torch.int8, 127.0),
                              ("fp8", torch.float8_e4m3fn, 448.0)):
        kq, ks = quantize_page_kv(k_t, qmax, dtype)
        vq, vs = quantize_page_kv(v_t, qmax, dtype)
        pages[code] = (kq, vq, ks, vs)
    return pages


def paged_fns(ops, q, kp, vp, ks, vs, table, lengths):
    """(the wrapper, its plain version) on one case's inputs."""
    if ks is None:
        return (lambda: ops.paged_attention(q, kp, vp, table, lengths),
                lambda: ops.ref.paged_attention_ref(q, kp, vp, table,
                                                    lengths))
    return (lambda: ops.paged_attention_q8(q, kp, vp, ks, vs, table,
                                           lengths),
            lambda: ops.ref.paged_attention_q8_ref(q, kp, vp, ks, vs, table,
                                                   lengths))


def check_split_partials(torch, q, kp, vp, ks, vs, table, lengths, what):
    """The decode form's per-split partials, at the wrappers' own split
    and at an uneven one of 3 pages, against the plain split emulation
    (1e-4).  Returns (max error, the wrappers' pages a split)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    pps = table.shape[1]
    _, per = pa.split_plan(q.shape[0], kp.shape[2], pps,
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)
    errs = []
    for pages in sorted({per, min(3, pps)}):
        got = pa.split_partials(q, kp, vp, table, lengths, ks, vs,
                                pages_per_split=pages)
        torch.cuda.synchronize()
        want = ref.paged_split_partials_ref(q, kp, vp, table, lengths, pages,
                                            ks, vs)
        for part, g, w in zip(("acc", "m", "l"), got, want):
            err = float((g - w).abs().max())
            check(err <= KERNEL_TOL, f"{what}: split partial {part} at "
                  f"{pages} pages a split: max_abs_err {err}")
            errs.append(err)
    return max(errs), per


def phase_kernels(torch, np):
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as pa

    dev = torch.device(DEVICE)
    (k, v, page, hkv), cases = kernel_cases(np)
    pages = paged_pages(torch, k, v)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    results = []
    for case, q_np, table_np, len_np, form in cases:
        q = torch.from_numpy(q_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        table = torch.from_numpy(table_np).to(dev)
        if table.dim() == 1:
            table = table[None].expand(len(len_np), table.shape[0])
            if form == "decode":
                table = table.contiguous()
        for code, (kp, vp, ks, vs) in pages.items():
            kernel, plain = paged_fns(ops, q, kp, vp, ks, vs, table, lengths)
            name = (CHUNK_OF if form == "chunk" else DECODE_OF)[code]
            before = ops.launch_counts()[name]
            got = kernel()
            torch.cuda.synchronize()
            check(ops.launch_counts()[name] == before + 1,
                  f"{case}: the wrapper took the {form} form")
            want = plain()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()), f"{code} {case}: finite")
            check(err <= KERNEL_TOL,
                  f"{code} {case}: max_abs_err {err} > {KERNEL_TOL}")
            zero_rows = lengths == 0
            check(not bool(got[zero_rows].any()), "length-0 rows are zero")
            split_err = split_ms = None
            if form != "chunk" and not case.startswith("prefill"):
                split_err, per = check_split_partials(
                    torch, q, kp, vp, ks, vs, table, lengths,
                    f"{code} {case}")
                split_ms = time_ms(torch, lambda: pa.split_partials(
                    q, kp, vp, table, lengths, ks, vs,
                    pages_per_split=per), flush)
            kd, vd = (kp, vp) if ks is None else (
                kp.float() * ks[..., None], vp.float() * vs[..., None])
            library_ms = time_ms(torch, library_call(torch, F, q, kd, vd,
                                                     table, lengths, page,
                                                     case), flush)
            kernel_ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush)
            b_ms, b_by = bound(torch, q, table, lengths, page, hkv,
                               kp.element_size(), ks is not None,
                               VERIFY_H if form == "verify" else 1)
            results.append({
                "name": ("paged_attention" if code == "f32"
                         else "paged_attention_q8"),
                "kernel": name, "form": form, "pages": code, "case": case,
                "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[code], "launches": None,
                "max_abs_err": err, "split_partials_max_abs_err": split_err,
                "split_kernel_ms": split_ms,
                "tolerance": KERNEL_TOL,
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
                "library": "torch.nn.functional.scaled_dot_product_attention"
                           " on the gathered dense K/V",
                "note": ("wrapper time: split kernel and paged_combine_f32"
                         if form != "chunk" else "wrapper time")})
            emit({"phase": "kernels", **{k_: results[-1][k_] for k_ in (
                "kernel", "case", "max_abs_err",
                "split_partials_max_abs_err", "ms", "split_kernel_ms",
                "plain_ms", "bound_ms",
                "bound_by", "library_ms")}})
    results += combine_cases(torch, ops, pages, cases, flush)
    results += pool_kernel_cases(torch, np, ops, pages, cases, flush)
    pool_other_shapes(torch, np, ops)
    chunk_padding_zeros(torch, np, ops, pages, cases)
    other_shapes(torch, np, ops)
    del pages
    results += family_paged_cases(torch, np, flush)
    return results


# (H, Hkv, D, page): GQA groups 1, 8, 2, 4 and head dims 128, 96, 32, 256,
# 160 beside granite's, so the kernels' shape-generic paths run on the
# card (several lanes a token's dot, two tokens a lane, 2-wide output
# vectors, 32-key chunk tiles, also over pages of 37, 48 and 64; decode
# ring slots of half a page, 19 of 37 tokens and 32 of 64, where three
# f32 pages at D 256 do not fit in shared memory); then head dims that
# are not a multiple of 32 (16: the reduced configs', 80: hubert-xlarge's,
# 24: codes copied in 8-byte pieces), pages of 128 and 256 tokens (two
# and four decode tiles a page) and a GQA group of 64 (two decode blocks
# a kv head)
OTHER_SHAPES = ((8, 8, 128, 8), (32, 4, 96, 32), (4, 2, 32, 64),
                (8, 2, 256, 16), (8, 1, 256, 64), (8, 2, 160, 48),
                (4, 1, 256, 37), (8, 2, 16, 16), (16, 4, 16, 128),
                (8, 2, 80, 16), (8, 4, 24, 16), (64, 1, 16, 8),
                (64, 1, 128, 256), (48, 1, 80, 128))


def other_shapes(torch, np, ops):
    """Both forms at OTHER_SHAPES, every page type, within 1e-4 of the
    plain versions; length-0 rows zero.  Not timed."""
    rng = np.random.default_rng(5)
    dev = torch.device(DEVICE)
    worst = 0.0
    for h, hkv, d, page in OTHER_SHAPES:
        n_phys, pps = 40, 8
        pages = paged_pages(torch, *(rng.standard_normal(
            (n_phys, page, hkv, d), dtype=np.float32) for _ in range(2)))
        dec_len = np.array([0, 1, page + 3, 5 * page, pps * page], np.int32)
        dec_table = np.stack([rng.permutation(n_phys)[:pps]
                              for _ in dec_len]).astype(np.int32)
        c = 40
        chunk_len = np.where(np.arange(c) < c - 3,
                             3 * page + np.arange(c) + 1, 0).astype(np.int32)
        row = torch.from_numpy(rng.permutation(n_phys)[:pps].astype(
            np.int32)).to(dev)
        for lens, table in ((dec_len, torch.from_numpy(dec_table).to(dev)),
                            (chunk_len, row[None].expand(c, pps))):
            lengths = torch.from_numpy(lens).to(dev)
            q = torch.from_numpy(rng.standard_normal(
                (len(lens), h, d), dtype=np.float32)).to(dev)
            for code, (kp, vp, ks, vs) in pages.items():
                kernel, plain = paged_fns(ops, q, kp, vp, ks, vs, table,
                                          lengths)
                got = kernel()
                torch.cuda.synchronize()
                err = float((got - plain()).abs().max())
                what = (f"{code} H={h} Hkv={hkv} D={d} page={page} "
                        f"B={len(lens)}")
                check(err <= KERNEL_TOL, f"{what}: max_abs_err {err}")
                check(not bool(got[lengths == 0].any()),
                      f"{what}: length-0 rows zero")
                worst = max(worst, err)
    emit({"phase": "kernels", "check": "paged attention at other shapes",
          "shapes_h_hkv_d_page": OTHER_SHAPES, "max_abs_err": worst,
          "tolerance": KERNEL_TOL})


def combine_cases(torch, ops, pages, cases, flush):
    """paged_combine_f32 alone, on the f32 decode form's partials of the
    first and the long decode case at the wrappers' split, against the
    plain merge; timed with the partials warm in L2, where the split
    kernel just wrote them on the serving path."""
    from repro_torch.kernels import paged_attention as pa
    dev = torch.device(DEVICE)
    kp, vp, _, _ = pages["f32"]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    no_flush = torch.empty(1, dtype=torch.uint8, device=dev)
    results = []
    for case, q_np, table_np, len_np, _ in (cases[0], cases[2]):
        q = torch.from_numpy(q_np).to(dev)
        table = torch.from_numpy(table_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        splits, per = pa.split_plan(q.shape[0], kp.shape[2], table.shape[1],
                                    n_sm)
        acc, m, l = pa.split_partials(q, kp, vp, table, lengths,
                                      pages_per_split=per)

        def kernel():
            return pa.combine_splits(acc, m, l)

        def plain():
            return ops.ref.combine_splits_ref(acc, m, l)
        got = kernel()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        check(err <= KERNEL_TOL, f"{COMBINE} {case}: max_abs_err {err}")
        n_bytes = (acc.numel() + m.numel() + l.numel() + got.numel()) * 4
        b_ms, b_by = bytes_bound(n_bytes, acc.numel() * 2 + m.numel() * 4)
        results.append({
            "name": "paged_attention", "kernel": COMBINE, "form": "combine",
            "pages": "any (f32 partials)",
            "case": f"{case}: {splits} splits of {per} pages",
            "route": "cuda", "source": SOURCE, "replaces": REPLACES["f32"],
            "launches": None, "max_abs_err": err, "tolerance": KERNEL_TOL,
            "ms": time_ms(torch, kernel, no_flush), "plain_ms": time_ms(
                torch, plain, no_flush), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library": "none: no single PyTorch call merges softmax partials",
            "note": "the decode form's merge of its split partials (both "
                    "paged-attention kernels use it)"})
        results[-1]["kernel_ms"] = results[-1]["ms"]
        emit({"phase": "kernels", **{k_: results[-1][k_] for k_ in (
            "kernel", "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")}})
    return results


def chunk_padding_zeros(torch, np, ops, pages, cases):
    """The chunk form on a chunk whose last 16 positions are padding
    (length 0, as a short prompt's last chunk has): zeros there, and the
    rest within 1e-4 of the plain version, for every page type."""
    dev = torch.device(DEVICE)
    _, q_np, row, len_np, _ = cases[3]
    q = torch.from_numpy(q_np).to(dev)
    lengths = torch.from_numpy(np.where(np.arange(len(len_np)) < 240, len_np,
                                        0).astype(np.int32)).to(dev)
    table = torch.from_numpy(row).to(dev)[None].expand(len(len_np), len(row))
    for code, (kp, vp, ks, vs) in pages.items():
        kernel, plain = paged_fns(ops, q, kp, vp, ks, vs, table, lengths)
        got = kernel()
        torch.cuda.synchronize()
        err = float((got - plain()).abs().max())
        check(err <= KERNEL_TOL, f"{code} chunk with padding: {err}")
        check(not bool(got[240:].any()), f"{code} chunk: padding rows zero")


# the pool form: POOL_NODES emulated nodes of POOL_LOCAL pages share the
# kernels phase's 320-page store, node s owning [s * 80, (s + 1) * 80)
POOL_NODES, POOL_LOCAL = 4, 80
POOL_DECODE_OF = {"f32": "paged_pool_decode_f32",
                  "int8": "paged_pool_decode_q8_int8",
                  "fp8": "paged_pool_decode_q8_fp8"}
POOL_CHUNK_OF = {"f32": "paged_pool_chunk_f32",
                 "int8": "paged_pool_chunk_q8_int8",
                 "fp8": "paged_pool_chunk_q8_fp8"}


def pool_table(np, rng, lengths, pps, policy, first_node=0, page=16,
               nodes=POOL_NODES, local=POOL_LOCAL):
    """[B, pps] over ``nodes`` windows of ``local`` pages, no page twice:
    ``placed`` puts row i's pages in node (first_node + i) % N's window,
    ``striped`` logical page j in node j % N's, ``random`` each page in a
    random node's."""
    free = [list(rng.permutation(local) + s * local) for s in range(nodes)]
    table = np.zeros((len(lengths), pps), np.int32)
    for i, n in enumerate(lengths):
        for j in range(-(-int(n) // page)):
            s = {"placed": first_node + i, "striped": j,
                 "random": int(rng.integers(nodes))}[policy] % nodes
            table[i, j] = free[s].pop()
    return table


def check_pool_partials(torch, q, kp, vp, ks, vs, table, lengths, what,
                        nodes=POOL_NODES, local=POOL_LOCAL, per=None):
    """Each node's partials from the pool form (its splits merged by
    max-rebase) against ``ref.paged_pool_partials_ref``: m within 1e-4,
    l and acc within 1e-4 x max(1, l).  Returns the largest error and the
    unmerged partials [B, H, N * S, ...] (``per`` pages a split, the
    wrappers' own when None)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    acc, m, l = pa.pool_partials(q, kp, vp, table, lengths, ks, vs,
                                 n_nodes=nodes, n_local=local,
                                 pages_per_split=per)
    torch.cuda.synchronize()
    ga, gm, gl = ref.merge_split_partials(acc, m, l)        # [B, H, N, ...]
    wa, wm, wl = (w.movedim(0, 2) for w in ref.paged_pool_partials_ref(
        q, kp, vp, table, lengths, nodes, local, ks, vs))
    scale = torch.clamp(wl, min=1.0)
    errs = {"m": float((gm - wm).abs().max()),
            "l": float(((gl - wl).abs() / scale).max()),
            "acc": float(((ga - wa).abs() / scale[..., None]).max())}
    for part, err in errs.items():
        check(err <= KERNEL_TOL, f"{what}: node partial {part}: {err}")
    b, h, d = q.shape
    return max(errs.values()), (acc.reshape(b, h, -1, d), m.reshape(b, h, -1),
                                l.reshape(b, h, -1))


def check_pool_merge(torch, got, parts, what):
    """The pool form's merge inside its launch against
    ``paged_combine_f32`` over the same launch's unmerged partials: bit
    for bit (the same arithmetic in the same order)."""
    from repro_torch.kernels import paged_attention as pa
    sep = pa.combine_splits(*parts)
    torch.cuda.synchronize()
    check(torch.equal(got, sep), f"{what}: fused merge != paged_combine_f32 "
          f"of the unmerged partials (max diff "
          f"{float((got - sep).abs().max())})")


def pool_kernel_cases(torch, np, ops, pages, cases, flush):
    """The pool form of both kernels at POOL_NODES nodes of POOL_LOCAL
    pages, placed and striped tables, f32 / int8 / fp8: the decode form
    at the serve phase's batch (B=8, lengths 513..576) and the chunk form
    at its second prefill chunk (C=256, lengths 257..512).  The merged
    output within 1e-4 of the plain attention, each node's partials
    within 1e-4 of ``ref.paged_pool_partials_ref``, and at one node
    whose window is the store, ``ops.paged_attention``'s bits; timed
    beside the bytes bound (each live page once) and SDPA on the
    gathered K/V."""
    import torch.nn.functional as F
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(7)
    page, hkv = 16, pages["f32"][0].shape[2]
    n_phys = pages["f32"][0].shape[0]
    check(n_phys == POOL_NODES * POOL_LOCAL, "the pool cases tile the store")
    serve_case, chunk_case = cases[1], cases[3]
    results = []
    for form, (case, q_np, _, len_np, _) in (("decode", serve_case),
                                             ("chunk", chunk_case)):
        q = torch.from_numpy(q_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        for policy in ("placed", "striped"):
            if form == "chunk":
                # the chunk's one page row, placed on node 1
                row = pool_table(np, rng, len_np[-1:], 32, policy,
                                 first_node=1)[0]
                table = torch.from_numpy(row).to(dev)[None].expand(
                    len(len_np), 32)
            else:
                table = torch.from_numpy(pool_table(
                    np, rng, len_np, 64, policy)).to(dev)
            for code, (kp, vp, ks, vs) in pages.items():
                scales = () if ks is None else (ks, vs)
                single = (ops.paged_attention_q8 if scales
                          else ops.paged_attention)
                pool = (ops.paged_attention_pool_q8 if scales
                        else ops.paged_attention_pool)

                def kernel():
                    return pool(q, kp, vp, *scales, table, lengths,
                                n_nodes=POOL_NODES, n_local=POOL_LOCAL)

                def plain():
                    return ops.ref.paged_pool_attention_ref(
                        q, kp, vp, table, lengths, POOL_NODES, POOL_LOCAL,
                        ks, vs)
                name = (POOL_CHUNK_OF if form == "chunk"
                        else POOL_DECODE_OF)[code]
                what = f"pool {code} {form} {policy}"
                before = ops.launch_counts()[name]
                got = kernel()
                torch.cuda.synchronize()
                check(ops.launch_counts()[name] == before + 1,
                      f"{what}: the wrapper took the pool {form} form")
                want = (ops.ref.paged_attention_q8_ref(
                    q, kp, vp, ks, vs, table, lengths) if scales else
                    ops.ref.paged_attention_ref(q, kp, vp, table, lengths))
                err = float((got - want).abs().max())
                check(bool(torch.isfinite(got).all()) and err <= KERNEL_TOL,
                      f"{what}: merged output max_abs_err {err}")
                part_err, parts = check_pool_partials(
                    torch, q, kp, vp, ks, vs, table, lengths, what)
                check_pool_merge(torch, got, parts, what)
                one = pool(q, kp, vp, *scales, table, lengths, n_nodes=1,
                           n_local=n_phys)
                check(torch.equal(one, single(q, kp, vp, *scales, table,
                                              lengths)),
                      f"{what}: one node != paged_attention bit for bit")
                kd, vd = (kp, vp) if ks is None else (
                    kp.float() * ks[..., None], vp.float() * vs[..., None])
                b_ms, b_by = bound(torch, q, table, lengths, page, hkv,
                                   kp.element_size(), ks is not None)
                results.append({
                    "name": ("paged_attention" if code == "f32"
                             else "paged_attention_q8"),
                    "kernel": name, "form": f"pool {form}", "pages": code,
                    "case": f"{POOL_NODES} nodes x {POOL_LOCAL} pages, "
                            f"{policy}: {case}",
                    "route": "cuda", "source": SOURCE,
                    "replaces": REPLACES[code], "launches": None,
                    "max_abs_err": err, "node_partials_max_err": part_err,
                    "one_node_bit_equal": True,
                    "fused_merge_bit_equal_to_combine": True,
                    "tolerance": KERNEL_TOL,
                    "ms": time_ms(torch, kernel, flush),
                    "plain_ms": time_ms(torch, plain, flush),
                    "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": time_ms(torch, library_call(
                        torch, F, q, kd, vd, table, lengths, page,
                        "prefill" if form == "chunk" else case), flush),
                    "library": "torch.nn.functional.scaled_dot_product_"
                               "attention on the gathered dense K/V",
                    "note": "wrapper time: one launch, every node's "
                            "owned pages and the merge of their partials"})
                results[-1]["kernel_ms"] = results[-1]["ms"]
                emit({"phase": "kernels", **{k_: results[-1][k_] for k_ in (
                    "kernel", "case", "max_abs_err", "node_partials_max_err",
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}})
    return results


# the pool form untimed, (H, Hkv, D, page): head dims 16, 64, 96, 128, 256
# at pages of 8, 16 and 128 (a page two chunk tiles, a tile eight
# pages), a GQA group of 64 (two decode blocks a kv head), codes at d = 8
# mod 16 (24, 40: 8-byte pieces), and D 192 at pages of 49, where the
# decode form has room for a list of 6 pages (its windows)
POOL_SHAPES = ((8, 2, 16, 16), (32, 8, 64, 16), (32, 4, 96, 8),
               (16, 2, 128, 128), (8, 2, 256, 16), (64, 1, 64, 8),
               (8, 4, 24, 16), (8, 2, 40, 128), (4, 2, 192, 49))
# (nodes, local pages, policy) of the sweep
POOL_LAYOUTS = ((2, 24, "placed"), (4, 12, "striped"), (4, 12, "random"),
                (2, 24, "random"))
# pages of one token, rows of 1,100 and 700 pages placed on one node each:
# past 512 listed pages, both forms walk their lists in windows
POOL_LONG = {"h": 8, "hkv": 2, "d": 64, "nodes": 4, "local": 1200,
             "pps": 1100, "lengths": (1100, 700, 0), "chunk": 8}


def pool_sweep_case(torch, ops, pages, q, table, lengths, nodes, local,
                    what, pers=(None,)):
    """One pool-form case, untimed: the merged output within 1e-4 of the
    plain attention, the node partials (at each of ``pers`` pages a
    split) within 1e-4 x max(1, l), the fused merge bit-equal to
    ``paged_combine_f32`` of the unmerged partials, and the form at one
    node bit-equal to the single form.  Returns the largest error."""
    worst = 0.0
    for code, (kp, vp, ks, vs) in pages.items():
        scales = () if ks is None else (ks, vs)
        single = ops.paged_attention_q8 if scales else ops.paged_attention
        pool = (ops.paged_attention_pool_q8 if scales
                else ops.paged_attention_pool)
        got = pool(q, kp, vp, *scales, table, lengths, n_nodes=nodes,
                   n_local=local)
        torch.cuda.synchronize()
        want = single(q, kp, vp, *scales, table, lengths)
        plain = (ops.ref.paged_attention_q8_ref(q, kp, vp, ks, vs, table,
                                                lengths) if scales else
                 ops.ref.paged_attention_ref(q, kp, vp, table, lengths))
        err = float((got - plain).abs().max())
        tag = f"{what} {code}"
        check(bool(torch.isfinite(got).all()) and err <= KERNEL_TOL,
              f"{tag}: merged output max_abs_err {err}")
        check(not bool(got[lengths == 0].any()), f"{tag}: length-0 rows zero")
        for per in pers:
            part_err, parts = check_pool_partials(
                torch, q, kp, vp, ks, vs, table, lengths, tag, nodes, local,
                per)
            worst = max(worst, part_err)
            if per is None:              # the wrappers' own split
                check_pool_merge(torch, got, parts, tag)
        one = pool(q, kp, vp, *scales, table, lengths, n_nodes=1,
                   n_local=kp.shape[0])
        check(torch.equal(one, want), f"{tag}: one node != the single form")
        worst = max(worst, err)
    return worst


def pool_other_shapes(torch, np, ops):
    """The pool form at POOL_SHAPES x POOL_LAYOUTS, both forms, every
    page type (``pool_sweep_case``), the decode form also at one split a
    node; then pages of one token with rows past 512 pages (POOL_LONG),
    whose lists both forms walk in windows.  Not timed."""
    rng = np.random.default_rng(11)
    dev = torch.device(DEVICE)
    worst, n_cases = 0.0, 0
    for h, hkv, d, page in POOL_SHAPES:
        pps = 8
        for nodes, local, policy in POOL_LAYOUTS:
            pages = paged_pages(torch, *(rng.standard_normal(
                (nodes * local, page, hkv, d), dtype=np.float32)
                for _ in range(2)))
            dec_len = np.array([0, 1, page + 3, 5 * page, pps * page],
                               np.int32)
            c = 40
            chunk_len = np.where(np.arange(c) < c - 3, 3 * page +
                                 np.arange(c) + 1, 0).astype(np.int32)
            dec_table = pool_table(np, rng, dec_len, pps, policy,
                                   page=page, nodes=nodes, local=local)
            row = pool_table(np, rng, chunk_len[-4:-3], pps, policy,
                             first_node=1, page=page, nodes=nodes,
                             local=local)[0]
            for lens, table, pers in (
                    (dec_len, dec_table, (None, pps)),
                    (chunk_len, torch.from_numpy(row).to(dev)[None].expand(
                        c, pps), (None,))):
                q = torch.from_numpy(rng.standard_normal(
                    (len(lens), h, d), dtype=np.float32)).to(dev)
                lengths = torch.from_numpy(lens).to(dev)
                if not isinstance(table, torch.Tensor):
                    table = torch.from_numpy(table).to(dev)
                worst = max(worst, pool_sweep_case(
                    torch, ops, pages, q, table, lengths, nodes, local,
                    f"pool H={h} Hkv={hkv} D={d} page={page} {nodes} nodes "
                    f"{policy} B={len(lens)}", pers))
                n_cases += 1
    lg = POOL_LONG
    nodes, local = lg["nodes"], lg["local"]
    pages = paged_pages(torch, *(rng.standard_normal(
        (nodes * local, 1, lg["hkv"], lg["d"]), dtype=np.float32)
        for _ in range(2)))
    lens = np.array(lg["lengths"], np.int32)
    table = torch.from_numpy(pool_table(np, rng, lens, lg["pps"], "placed",
                                        page=1, nodes=nodes,
                                        local=local)).to(dev)
    chunk_len = (lens[0] - np.arange(lg["chunk"])[::-1]).astype(np.int32)
    for lens_, table_, pers in (
            (lens, table, (None, lg["pps"])),
            (chunk_len, table[0][None].expand(lg["chunk"], lg["pps"]),
             (None,))):
        q = torch.from_numpy(rng.standard_normal(
            (len(lens_), lg["h"], lg["d"]), dtype=np.float32)).to(dev)
        worst = max(worst, pool_sweep_case(
            torch, ops, pages, q, table_, torch.from_numpy(lens_).to(dev),
            nodes, local, f"pool page=1 pps={lg['pps']} B={len(lens_)}",
            pers))
        n_cases += 1
    emit({"phase": "kernels", "check": "pool form at other shapes",
          "shapes_h_hkv_d_page": POOL_SHAPES, "layouts": POOL_LAYOUTS,
          "long_rows": lg, "cases": n_cases, "max_err": worst,
          "tolerance": KERNEL_TOL, "fused_merge_bit_equal_to_combine": True,
          "one_node_bit_equal": True})


def library_call(torch, F, q, kd, vd, table, lengths, page, case):
    """One SDPA call on dense K/V gathered (and dequantised) outside the
    timing: per decode row a [S] masked key axis; for a prefill chunk,
    whose rows share one page row, its 256 positions as the query axis
    of one sequence."""
    b, h, d = q.shape
    hkv = kd.shape[2]
    pps = table.shape[1]
    s = pps * page
    if case.startswith("prefill"):
        kk = kd[table[0].long()].reshape(1, s, hkv, d).transpose(1, 2)
        vv = vd[table[0].long()].reshape(1, s, hkv, d).transpose(1, 2)
        qq = q.transpose(0, 1)[None]                      # [1, H, C, D]
        mask = (torch.arange(s, device=q.device)[None, :] <
                lengths[:, None].long())[None, None]      # [1, 1, C, S]
    else:
        kk = kd[table.long()].reshape(b, s, hkv, d).transpose(1, 2)
        vv = vd[table.long()].reshape(b, s, hkv, d).transpose(1, 2)
        qq = q[:, :, None]                                # [B, H, 1, D]
        mask = (torch.arange(s, device=q.device)[None, :] <
                lengths[:, None].long())[:, None, None]   # [B, 1, 1, S]
    kk = kk.repeat_interleave(h // hkv, dim=1).contiguous()
    vv = vv.repeat_interleave(h // hkv, dim=1).contiguous()
    qq = qq.contiguous()

    def call():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)
    return call


# -- in-storage analytics and retrieval: kernels -------------------------------

ISP_SOURCE = "src/repro_torch/kernels/csrc/isp_scan.cu"
EMBED_SOURCE = "src/repro_torch/kernels/csrc/embed_agg.cu"
ISP_REPLACES = {"scan_filter_reduce_f32": "src/repro/kernels/isp_scan.py:120",
                "scan_filter_reduce_int8": "src/repro/kernels/isp_scan.py:162",
                "scan_filter_reduce_fp8": "src/repro/kernels/isp_scan.py:162",
                "topk_scan_f32": "src/repro/kernels/isp_scan.py:376",
                "topk_scan_int8": "src/repro/kernels/isp_scan.py:414",
                "topk_scan_fp8": "src/repro/kernels/isp_scan.py:414",
                "embed_agg": "src/repro/kernels/embed_agg.py:23",
                "embed_gather": "src/repro/kernels/embed_agg.py:94"}
NEW_KERNELS = tuple(ISP_REPLACES)
# TPC-H SF-1 lineitem: 6,001,215 rows of its 16 columns, as f32
LINEITEM = {"rows": 6_001_215, "cols": 16, "page_rows": 128}
# the columns' value ranges (TPC-H spec 4.2.3), in column order:
# orderkey, partkey, suppkey, linenumber, quantity, extendedprice,
# discount, tax, returnflag, linestatus, shipdate, commitdate,
# receiptdate, shipinstruct, shipmode, comment (a hash)
SCAN_JOBS = [("all", 0, "all", 0.0), ("ge extendedprice", 5, "ge", 50000.0),
             ("lt shipdate", 10, "lt", 1000.0), ("eq quantity", 4, "eq", 24.0),
             ("ne returnflag", 8, "ne", 1.0)]
# retrieval corpus: 1,000,000 passages x 768 (BERT-base-class embedding
# width), page 128; rows DUP_IDS are copies of one row (tie-break)
CORPUS = {"rows": 1_000_000, "dim": 768, "page_rows": 128, "chunk": 64}
DUP_IDS = (123_457, 500_000, 999_999)
# DLRM embedding bag: MLPerf DLRM (Criteo 1TB) embedding dim 128, its
# largest tables cut 10x to 4M rows; 2048 bags of 16 lookups
EMBED = {"rows": 4_000_000, "dim": 128, "bags": 2048, "lookups": 16}
# a bag bound by bytes: 16,384 bags of 64 ids uniform over the EMBED table
# (~0.92M distinct rows, ~0.47 GB)
EMBED_WIDE = {"bags": 16_384, "lookups": 64}
# untimed shapes of the embedding kernels: row widths (one element to
# 4,000 bytes, column slices past 512 bytes; with the views, every piece
# width of every table dtype), bag lengths (a stage, two, a ragged third,
# many), the gather's dtypes (1, 2, 4 and 8 bytes)
EMBED_DIMS = (1, 2, 3, 4, 6, 24, 64, 128, 768, 1000)
EMBED_LOOKUPS = (1, 16, 33, 100)
GATHER_DTYPES = ("int32", "float32", "bfloat16", "int8", "float8_e4m3fn",
                 "float8_e5m2", "float16", "float64", "int64")
RAG = {"template": 128, "k": 4, "question": 32, "queries": 4, "waves": 2,
       "gen": 8}
PLAIN_ITERS = 3          # timing repeats of the plain versions
HOST_SLICE = 65_536      # rows of the slice the planner runs both ways


def make_lineitem(np):
    """The seeded SF-1 lineitem extent [rows, 16] f32, and the generator
    that goes on to make the rest of ``make_data``."""
    rng = np.random.default_rng(1)
    n = LINEITEM["rows"]
    cols = [np.repeat(np.arange(1, n // 4 + 2), 4)[:n],   # orderkey
            rng.integers(1, 200_001, n), rng.integers(1, 10_001, n),
            rng.integers(1, 8, n), rng.integers(1, 51, n),
            rng.uniform(900.0, 105_000.0, n),
            rng.integers(0, 11, n) / 100.0, rng.integers(0, 9, n) / 100.0,
            rng.integers(0, 3, n), rng.integers(0, 2, n),
            rng.integers(0, 2_557, n), rng.integers(0, 2_557, n),
            rng.integers(0, 2_557, n), rng.integers(0, 4, n),
            rng.integers(0, 7, n), rng.standard_normal(n)]
    return np.stack(cols, axis=1).astype(np.float32), rng


def make_data(np):
    """Seeded inputs of the isp kernels and phase (numpy generators)."""
    lineitem, rng = make_lineitem(np)
    corpus = rng.standard_normal((CORPUS["rows"], CORPUS["dim"]),
                                 dtype=np.float32)
    corpus[list(DUP_IDS[1:])] = corpus[DUP_IDS[0]]
    tokens = rng.integers(0, 49_155, (CORPUS["rows"], CORPUS["chunk"]),
                          dtype=np.int32)
    return {"lineitem": lineitem, "corpus": corpus, "corpus_tokens": tokens}


def bytes_bound(n_bytes, ops=0):
    """(least ms, what bounds it): bytes over the memory rate vs f32
    operations over the f32 rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops / F32_FLOPS * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def pool_bound(n_valid, page_rows, n_cols, pages, quantized, ops_per_elem,
               extra_bytes):
    """The valid pages' bytes, their scales and table entries once, plus
    the query/output bytes; operations per element read."""
    elems = n_valid * page_rows * n_cols
    n_bytes = (elems * pages.element_size() + n_valid * 4 +
               (n_valid * page_rows * 4 if quantized else 0) + extra_bytes)
    return bytes_bound(n_bytes, elems * (ops_per_elem + quantized))


def kernel_line(results, kernel, case, err, kernel_ms, plain_ms, bound_,
                library_ms, library, source, tolerance=0.0):
    results.append({
        "name": kernel.rsplit("_", 1)[0] if kernel.startswith(
            ("scan", "topk", "flash", "rwkv")) else kernel,
        "kernel": kernel, "case": case, "route": "cuda", "source": source,
        "replaces": {**ISP_REPLACES, **DENSE_REPLACES}[kernel],
        "launches": None, "max_abs_err": err, "tolerance": tolerance,
        "ms": kernel_ms,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "plain_iters": PLAIN_ITERS, "bound_ms": bound_[0],
        "bound_by": bound_[1], "library_ms": library_ms,
        "library": library})
    emit({"phase": "kernels", **{k: results[-1][k] for k in (
        "kernel", "case", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms", "launches")}})


def exact(torch, got, want, what):
    """max |got - want| after checking the two are equal bit for bit."""
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(torch.equal(got, want), f"{what}: kernel != plain version "
          f"(max_abs_err {err})")
    return err


def quantized_pools(torch, x):
    from repro_torch.core.kv_tier import quantize_page_kv
    pools = {"f32": (x, None)}
    for code, dtype, qmax in (("int8", torch.int8, 127.0),
                              ("fp8", torch.float8_e4m3fn, 448.0)):
        pools[code] = quantize_page_kv(x, qmax, dtype)
    return pools


def on_pages(torch, arr, page_rows):
    """[rows, C] numpy -> zero-padded [pages, page_rows, C] on the card
    and the identity page table."""
    rows, cols = arr.shape
    n_pages = -(-rows // page_rows)
    x = torch.zeros((n_pages * page_rows, cols), device=DEVICE)
    x[:rows] = torch.from_numpy(arr).to(DEVICE)
    table = torch.arange(n_pages, dtype=torch.int32, device=DEVICE)
    return x.view(n_pages, page_rows, cols), table


def scan_library(torch, flat, col, op, thr):
    """The same masked count/sum/min/max in six PyTorch calls."""
    key = flat[:, col]
    thr = float(thr)

    def call():
        m = {"all": torch.ones_like(key, dtype=torch.bool), "ge": key >= thr,
             "lt": key < thr, "eq": key == thr, "ne": key != thr}[op]
        mf = m[:, None]
        return (m.sum(), torch.where(mf, flat, 0.0).sum(0),
                torch.where(mf, flat, 1e30).amin(0),
                torch.where(mf, flat, -1e30).amax(0))
    return call


def phase_isp_kernels(torch, np, data, flush):
    """The scan, top-k and embedding kernels against their plain versions
    at the isp phase's sizes; every case must agree bit for bit."""
    results = scan_cases_timed(torch, data["lineitem"], flush)
    scan_other_shapes(torch, np, data["lineitem"])
    results += topk_cases(torch, data, flush)
    topk_other_shapes(torch, np)
    results += topk_pool_cases(torch, np, data, flush)
    results += embed_cases(torch, np, data, flush)
    return results


def scan_cases_timed(torch, li, flush):
    """The scan over the SF-1 lineitem extent ``li`` on f32, int8 and fp8
    pools (SCAN_JOBS; f32 also a pow2-padded table and an empty result),
    each bit-identical to its plain version and timed beside its byte
    bound, its chain bound (the kernel's ordered page fold alone,
    ``isp_scan.scan_chain_runner``) and the six-call library expression."""
    from repro_torch.kernels import isp_scan, ops

    results = []
    pr = LINEITEM["page_rows"]
    n_rows, n_cols = li.shape
    x, table = on_pages(torch, li, pr)
    n_valid = table.numel()
    padded = torch.zeros(1 << (n_valid - 1).bit_length(), dtype=torch.int32,
                         device=DEVICE)
    padded[:n_valid] = table
    for code, (pages, scales) in quantized_pools(torch, x).items():
        kernel = f"scan_filter_reduce_{code}"
        flat = ops.ref.pool_rows(pages, scales, table.long()).reshape(
            -1, n_cols)[:n_rows]
        chain_ms = time_ms(torch, isp_scan.scan_chain_runner(
            pages, table, n_rows, scales=scales), flush)
        emit({"phase": "kernels", "kernel": kernel, "check": "the ordered "
              "page fold alone (chain bound)", "ms": chain_ms,
              "plan": isp_scan.scan_plan_of(pages, table, n_rows,
                                            scales)._asdict()})
        cases = [(f"SF-1 lineitem {label} col{col} ({code})", table, col, op,
                  thr) for label, col, op, thr in SCAN_JOBS]
        if code == "f32":
            cases += [("SF-1 lineitem ge col5, table pow2-padded to "
                       f"{padded.numel()}", padded, 5, "ge", 50000.0),
                      ("SF-1 lineitem, filter passes no row", table, 5, "ge",
                       1e9)]
        for case, tab, col, op, thr in cases:
            def run(fn=ops.scan_filter_reduce, tab=tab, col=col, op=op,
                    thr=thr):
                return fn(pages, tab, n_rows, thr, scales=scales,
                          filter_col=col, filter_op=op)
            before = ops.launch_counts()[kernel]
            got = run()
            check(ops.launch_counts()[kernel] == before + 1,
                  f"{case}: one launch")
            want = run(ops.ref.scan_filter_reduce_ref)
            err = exact(torch, got, want, case)
            lib = scan_library(torch, flat, col, op, thr)
            cnt, _, mn, mx = lib()
            check(got[0, 0].item() == cnt.item() and torch.equal(got[2], mn)
                  and torch.equal(got[3], mx), f"{case}: count/min/max "
                  "differ from the library expression")
            if "no row" in case:
                check(cnt.item() == 0 and bool((got[2] == 1e30).all()) and
                      bool((got[3] == -1e30).all()), "empty result sentinels")
            bound_ = pool_bound(n_valid, pr, n_cols, pages,
                                scales is not None, 4, 8 * n_cols * 4)
            kernel_line(results, kernel, case, err,
                        time_ms(torch, run, flush),
                        time_ms(torch, lambda: run(
                            ops.ref.scan_filter_reduce_ref), flush,
                            PLAIN_ITERS, 1),
                        bound_,
                        time_ms(torch, lib, flush, 10, 2),
                        "masked count/sum/amin/amax over the f32 rows "
                        "(dequantised outside the timing): 6 PyTorch calls",
                        ISP_SOURCE)
            results[-1]["chain_bound_ms"] = chain_ms
            results[-1]["larger_bound"] = ("chain" if chain_ms > bound_[0]
                                           else bound_[1])
        del flat
    del x
    torch.cuda.empty_cache()
    return results


# (page_rows, n_cols): pages of one row up to 2,048 rows, rows of 1-176
# columns (a fold of two passes at 176), each on f32, int8 and fp8 pages
# (the direct path where a page is no multiple of 16 bytes, code pages
# of a row count not a multiple of 4, or a page over half the ring)
SCAN_SHAPES = tuple((pr, c) for pr in (1, 6, 8, 128, 1024, 2048)
                    for c in (1, 3, 16, 24, 33, 176))
# the C3 case: a 1-column extent whose passing rows are past 2^24, where
# the count must be the page-order f32 fold's
SCAN_C3 = {"rows": 40_000_000, "page_rows": 128}


def parent_count_order(counts):
    """The per-page counts [n] as the two-launch scan's fold added them:
    16 warps each folding pages w, w + 16, ... in order, then the warps'
    sums added in warp order (f32)."""
    import numpy as np

    counts = np.asarray(counts, np.float32)
    warps = [np.add.accumulate(counts[w::16])[-1] if len(counts[w::16])
             else np.float32(0) for w in range(16)]
    return float(np.add.accumulate(np.asarray(warps, np.float32))[-1])


def scan_other_shapes(torch, np, li):
    """The scan, untimed, bit-identical to its plain version: every
    SCAN_SHAPES on f32, int8 and fp8 pages over shuffled, pow2-padded
    tables (n_rows not a multiple of page_rows, the five filter ops in
    turn, some with n_rows = 0); the lineitem extent ``li`` on f32 pages
    of 2,048 rows, on int8 pages of 6 rows and in an int8 store of 24
    columns; and SCAN_C3."""
    from repro_torch.kernels import isp_scan, ops

    rng = np.random.default_rng(9)
    paths = {}
    for i, (page_rows, n_cols) in enumerate(SCAN_SHAPES):
        for j, code in enumerate(("f32", "int8", "fp8")):
            n_valid = 1 + (7 * i + 3 * j) % 23
            n_rows = 0 if (i + j) % 11 == 0 else max(
                1, n_valid * page_rows - (i + 1) % page_rows)
            n_valid = max(1, -(-n_rows // page_rows))
            n_phys = n_valid + 3
            x = rng.standard_normal((n_phys, page_rows, n_cols),
                                    dtype=np.float32)
            x[..., (i + j) % n_cols] = np.round(x[..., (i + j) % n_cols])
            pages, scales = quantized_pools(torch, torch.from_numpy(x).to(
                DEVICE))[code]
            table = np.full(1 << (n_valid - 1).bit_length(), n_phys + 99,
                            np.int32)
            table[:n_valid] = rng.permutation(n_phys)[:n_valid]
            tab = torch.from_numpy(table).to(DEVICE)
            op = ops.ref.FILTER_OPS[(i + j) % 5]
            col = (i + j) % n_cols
            thr = 0.0 if op in ("eq", "ne") else 0.25
            got = ops.scan_filter_reduce(pages, tab, n_rows, thr,
                                         scales=scales, filter_col=col,
                                         filter_op=op)
            want = ops.ref.scan_filter_reduce_ref(
                pages, tab, n_rows, thr, scales=scales, filter_col=col,
                filter_op=op)
            exact(torch, got, want, f"scan {code} page {page_rows} x "
                  f"{n_cols} {op} col{col} rows {n_rows}")
            path = "tma" if isp_scan.scan_plan_of(pages, tab, n_rows,
                                                  scales).tma else "direct"
            paths[path] = paths.get(path, 0) + 1
    # the lineitem extent on the pools of PERF.md section 4
    n_rows = li.shape[0]
    wide = np.zeros((n_rows, TOPK_NARROW["cols"]), np.float32)
    wide[:, :li.shape[1]] = li
    pools = {}
    for label, arr, pr, code in (
            ("f32 pages of 2048 rows", li, TOPK_REPAGED, "f32"),
            (f"int8 pages of {TOPK_SHORT_PAGE} rows", li, TOPK_SHORT_PAGE,
             "int8"),
            (f"int8 store of {TOPK_NARROW['cols']} columns", wide,
             TOPK_NARROW["page_rows"], "int8")):
        x, tab = on_pages(torch, arr, pr)
        pages, scales = quantized_pools(torch, x)[code]
        del x
        got = ops.scan_filter_reduce(pages, tab, n_rows, 50000.0,
                                     scales=scales, filter_col=5,
                                     filter_op="ge")
        exact(torch, got, ops.ref.scan_filter_reduce_ref(
            pages, tab, n_rows, 50000.0, scales=scales, filter_col=5,
            filter_op="ge"), f"scan SF-1 lineitem, {label}")
        plan = isp_scan.scan_plan_of(pages, tab, n_rows, scales)
        pools[label] = {"path": "tma" if plan.tma else "direct",
                        "pages": tab.numel(), "count": got[0, 0].item()}
        del pages, scales
    del wide
    # C3: ~20M of 40M rows pass; the count must be the page-order fold's
    c3 = SCAN_C3
    pages, tab = on_pages(torch, rng.standard_normal(
        (c3["rows"], 1), dtype=np.float32), c3["page_rows"])
    got = ops.scan_filter_reduce(pages, tab, c3["rows"], 0.0,
                                 filter_op="ge")
    want = ops.ref.scan_filter_reduce_ref(pages, tab, c3["rows"], 0.0,
                                          filter_op="ge")
    exact(torch, got, want, "scan C3 (count past 2^24)")
    live = pages.reshape(-1)[:c3["rows"]] >= 0
    exact_count = int(live.sum())
    page_counts = torch.zeros(tab.numel() * c3["page_rows"],
                              device=DEVICE)
    page_counts[:c3["rows"]] = live.float()
    page_counts = page_counts.view(tab.numel(), -1).sum(dim=1).cpu().numpy()
    check(got[0, 0].item() > 2 ** 24, "C3: the count passes 2^24")
    emit({"phase": "kernels", "check": "scan at other shapes",
          "shapes": len(SCAN_SHAPES) * 3, "paths": paths, "pools": pools,
          "c3": {"rows": c3["rows"], "page_rows": c3["page_rows"],
                 "count": got[0, 0].item(), "plain_fold_count":
                 want[0, 0].item(), "exact_integer_count": exact_count,
                 "two_pass_order_count": parent_count_order(page_counts)},
          "bit_identical": True})
    del pages, live
    torch.cuda.empty_cache()


def topk_cases(torch, data, flush):
    """The top-k over the 1M x 768 retrieval corpus on every page format,
    k 4 and 128, dot and cosine, bit-identical to its plain version."""
    from repro_torch.kernels import ops

    results = []
    pr = CORPUS["page_rows"]
    x, table = on_pages(torch, data["corpus"], pr)
    n_rows, dim = data["corpus"].shape
    n_valid = table.numel()
    q = torch.from_numpy(data["corpus"][DUP_IDS[0]].copy()).to(DEVICE)
    for code, (pages, scales) in quantized_pools(torch, x).items():
        kernel = f"topk_scan_{code}"
        flat = ops.ref.pool_rows(pages, scales, table.long()).reshape(
            -1, dim)[:n_rows]
        for k in (4, 128):
            for metric in ("dot", "cosine"):
                case = (f"1M x 768 corpus, k={k}, {metric} ({code}), query "
                        f"= row {DUP_IDS[0]}, copied at {DUP_IDS[1:]}")

                def run(fn=ops.topk_scan, k=k, metric=metric):
                    return fn(pages, table, n_rows, q, k=k, metric=metric,
                              scales=scales)
                got = run()
                want = run(ops.ref.topk_scan_ref)
                err = exact(torch, got, want, case)
                check(got[1, :3].tolist() == [float(i) for i in DUP_IDS],
                      f"{case}: planted copies first, by row id")
                if metric == "dot":
                    def lib(k=k):
                        return torch.topk(flat @ q, k)
                    lib_name = "torch.topk(rows @ q, k): 2 PyTorch calls"
                else:
                    def lib(k=k):
                        return torch.topk((flat @ q) / torch.clamp(
                            flat.norm(dim=1), min=1e-6), k)
                    lib_name = ("torch.topk((rows @ q) / clamp(rows.norm(1)"
                                ")), k): 5 PyTorch calls")
                kernel_line(results, kernel, case, err,
                            time_ms(torch, run, flush, 10, 2),
                            time_ms(torch, lambda: run(ops.ref.topk_scan_ref),
                                    flush, PLAIN_ITERS, 1),
                            pool_bound(n_valid, pr, dim, pages,
                                       scales is not None,
                                       2 if metric == "dot" else 4,
                                       dim * 4 + 8 * ops.topk_pad(k) * 4),
                            time_ms(torch, lib, flush, 10, 2),
                            lib_name + " on the f32 rows (dequantised "
                            "outside the timing)", ISP_SOURCE)
        del flat
    del x, pages, scales
    torch.cuda.empty_cache()
    return results


# (page_rows, n_cols, page type, k, metric, n_rows): page rows that are not
# a multiple of 32 (idle row threads), a last stage of part of a 128-byte
# box (f32 48, int8 176 columns), rows narrower than a box (16 and 4),
# 256 rows a page (a ring of 3 stages), k not a power of two, and fewer
# rows than k; then pages of several units (300 rows: 256 + 44; 1,030),
# rows that fit no tensor map (int8 40, f32 7, fp8 33 columns: the direct
# path) and fp8 pages of 6 rows (row scales loaded by the row threads)
TOPK_SHAPES = ((100, 48, "f32", 7, "dot", 3687),
               (96, 176, "int8", 100, "cosine", 2001),
               (256, 32, "fp8", 128, "dot", 3000),
               (256, 32, "f32", 128, "cosine", 50),
               (8, 4, "f32", 4, "dot", 301),
               (128, 16, "int8", 1, "cosine", 5000),
               (300, 16, "f32", 5, "dot", 1190),
               (300, 40, "int8", 9, "cosine", 2000),
               (6, 16, "fp8", 3, "dot", 500),
               (5, 7, "f32", 2, "dot", 333),
               (1030, 33, "fp8", 128, "dot", 4000))


def topk_other_shapes(torch, np):
    """The top-k at TOPK_SHAPES over a shuffled, pow2-padded page table,
    each with a row copied at the first and last valid row, bit-identical
    to the plain version.  Not timed."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(8)
    for page_rows, n_cols, code, k, metric, n_rows in TOPK_SHAPES:
        n_valid = -(-n_rows // page_rows)
        n_phys = n_valid + 5
        x = rng.standard_normal((n_phys * page_rows, n_cols),
                                dtype=np.float32)
        table = np.full(1 << (n_valid - 1).bit_length(), n_phys + 99,
                        np.int32)
        table[:n_valid] = rng.permutation(n_phys)[:n_valid]
        first, last = (table[0] * page_rows,
                       table[(n_rows - 1) // page_rows] * page_rows +
                       (n_rows - 1) % page_rows)
        x[last] = x[first]
        pages, scales = quantized_pools(torch, torch.from_numpy(x).to(
            DEVICE).view(n_phys, page_rows, n_cols))[code]
        tab = torch.from_numpy(table).to(DEVICE)
        q = torch.from_numpy(x[first].copy()).to(DEVICE)
        got = ops.topk_scan(pages, tab, n_rows, q, k=k, metric=metric,
                            scales=scales)
        want = ops.ref.topk_scan_ref(pages, tab, n_rows, q, k=k,
                                     metric=metric, scales=scales)
        exact(torch, got, want, f"top-k {code} page {page_rows} x {n_cols}"
              f" k={k} {metric} rows {n_rows}")
    emit({"phase": "kernels", "check": "top-k at other shapes",
          "shapes": TOPK_SHAPES, "bit_identical": True})


# the pools the top-k took only through its plain version before: the
# corpus re-paged at 2,048 rows (eight units a page), the lineitem extent
# in an int8 store of 24 columns (24-byte rows: the direct path) and on
# int8 pages of 6 rows (row scales loaded by the row threads)
TOPK_REPAGED = 2048
TOPK_NARROW = {"cols": 24, "page_rows": 128}
TOPK_SHORT_PAGE = 6


def topk_pool_cases(torch, np, data, flush):
    """The top-k on TOPK_REPAGED / TOPK_NARROW / TOPK_SHORT_PAGE pools,
    bit-identical to its plain version, each timed beside its bound and
    ``torch.topk`` on the f32 rows."""
    from repro_torch.kernels import isp_scan, ops

    results = []
    cases = []
    n_rows, dim = data["corpus"].shape
    x, table = on_pages(torch, data["corpus"], TOPK_REPAGED)
    pools = quantized_pools(torch, x)
    q = torch.from_numpy(data["corpus"][DUP_IDS[0]].copy()).to(DEVICE)
    for code in ("f32", "int8"):
        for k in (4, 128):
            cases.append((f"1M x 768 corpus on pages of {TOPK_REPAGED} rows, "
                          f"k={k}, dot ({code})", *pools[code], table,
                          n_rows, q, k, True))
    del x
    li = data["lineitem"]
    wide = np.zeros((li.shape[0], TOPK_NARROW["cols"]), np.float32)
    wide[:, :li.shape[1]] = li
    rng = np.random.default_rng(10)
    lq = np.zeros(TOPK_NARROW["cols"], np.float32)
    lq[:li.shape[1]] = rng.standard_normal(li.shape[1])
    lq = torch.from_numpy(lq).to(DEVICE)
    for cols, pr, label in ((TOPK_NARROW["cols"], TOPK_NARROW["page_rows"],
                             f"int8 store of {TOPK_NARROW['cols']} columns"),
                            (li.shape[1], TOPK_SHORT_PAGE,
                             f"int8 pages of {TOPK_SHORT_PAGE} rows")):
        xl, tl = on_pages(torch, wide[:, :cols], pr)
        pages, scales = quantized_pools(torch, xl)["int8"]
        del xl
        for metric in ("dot", "cosine"):
            cases.append((f"SF-1 lineitem, {label}, k=4, {metric}", pages,
                          scales, tl, li.shape[0], lq[:cols], 4,
                          metric == "dot"))
    for case, pages, scales, tab, rows, query, k, dot in cases:
        metric = "dot" if dot else "cosine"
        code = isp_scan._CODE[pages.dtype]
        kernel = f"topk_scan_{code}"
        path = isp_scan.check_topk_pool(pages, scales, query)

        def run(fn=ops.topk_scan, pages=pages, scales=scales, tab=tab,
                rows=rows, query=query, k=k, metric=metric):
            return fn(pages, tab, rows, query, k=k, metric=metric,
                      scales=scales)
        before = ops.launch_counts()[kernel]
        got = run()
        check(ops.launch_counts()[kernel] == before + 1,
              f"{case}: the kernel launched")
        err = exact(torch, got, run(ops.ref.topk_scan_ref), case)
        n_valid = tab.numel()
        flat = ops.ref.pool_rows(pages, scales, tab.long()).reshape(
            -1, pages.shape[2])[:rows]

        def lib(flat=flat, query=query, k=k, dot=dot):
            s_ = flat @ query
            return torch.topk(s_ if dot else s_ / torch.clamp(
                flat.norm(dim=1), min=1e-6), k)
        kernel_line(results, kernel, f"{case} [{path} path]", err,
                    time_ms(torch, run, flush, 10, 2),
                    time_ms(torch, lambda: run(ops.ref.topk_scan_ref),
                            flush, PLAIN_ITERS, 1),
                    pool_bound(n_valid, pages.shape[1], pages.shape[2],
                               pages, scales is not None, 2 if dot else 4,
                               pages.shape[2] * 4 + 8 * ops.topk_pad(k) * 4),
                    time_ms(torch, lib, flush, 10, 2),
                    ("torch.topk(rows @ q, k): 2 PyTorch calls" if dot else
                     "torch.topk((rows @ q) / clamp(rows.norm(1)), k): 5 "
                     "PyTorch calls") + " on the f32 rows (dequantised "
                    "outside the timing)", ISP_SOURCE)
        results[-1]["path"] = path
        del flat
    del cases, pools
    torch.cuda.empty_cache()
    return results


def same_bits(torch, got, want, what):
    """max |got - want| after checking the two are equal byte for byte
    (fp8 rows and signed zeros included)."""
    torch.cuda.synchronize()
    check(got.dtype == want.dtype and got.shape == want.shape,
          f"{what}: {got.dtype} {tuple(got.shape)} against the plain "
          f"version's {want.dtype} {tuple(want.shape)}")
    check(torch.equal(got.contiguous().view(torch.uint8),
                      want.contiguous().view(torch.uint8)),
          f"{what}: kernel != plain version")
    return float((got.float() - want.float()).abs().max())


def one_launch(ops, kernel, fn, what):
    """fn(), checking it launched ``kernel`` once."""
    before = ops.launch_counts()[kernel]
    out = fn()
    check(ops.launch_counts()[kernel] == before + 1,
          f"{what}: one {kernel} launch")
    return out


def embed_floors(torch, emb, table, idx, flush):
    """The measured floors of a call on ``table`` and ``idx`` (a gather's
    ids as [B * K, 1]), timed as the kernel is: the empty kernel on the
    call's grid, and the dependent pair (an id, then a 16-byte piece of
    its row)."""
    empty, pair = emb.floor_runners(table, idx)
    e_ms, p_ms = time_ms(torch, empty, flush), time_ms(torch, pair, flush)
    return {"floor_empty_ms": e_ms, "floor_pair_ms": p_ms,
            "floor_ms": max(e_ms, p_ms)}


def embed_cases(torch, np, data, flush):
    """The embedding bag over the 4M x 128 table: 2048 Zipf bags of 16 on
    f32 (unweighted, weighted) and on the table as bf16, and the
    byte-bound bag (EMBED_WIDE, uniform ids); the token-block gather over
    the corpus's token blocks.  Each call one launch, bit-identical to
    its plain version, timed beside its bytes bound and its measured
    floors (``embed_floors``; the larger of the two bounds governs);
    then ``embed_other_shapes``."""
    import torch.nn.functional as F
    from repro_torch.kernels import embed_agg as emb
    from repro_torch.kernels import ops

    results = []
    rng = np.random.default_rng(2)
    table_e = torch.from_numpy(rng.standard_normal(
        (EMBED["rows"], EMBED["dim"]), dtype=np.float32)).to(DEVICE)
    shape = (EMBED["bags"], EMBED["lookups"])
    ids = ((rng.zipf(1.2, shape) - 1) % EMBED["rows"]).astype(np.int32)
    idx = torch.from_numpy(ids).to(DEVICE)
    w = torch.from_numpy(rng.uniform(0.5, 1.5, shape).astype(
        np.float32)).to(DEVICE)
    wide = rng.integers(0, EMBED["rows"], (EMBED_WIDE["bags"],
                                           EMBED_WIDE["lookups"]),
                        dtype=np.int32)
    zipf = (f"{shape[0]} bags x {shape[1]} Zipf(1.2) lookups "
            f"({len(np.unique(ids))} distinct rows)")
    cases = [(f"{zipf}, unweighted", table_e, ids, None),
             (f"{zipf}, weighted", table_e, ids, w),
             (f"{zipf}, unweighted, the table as bf16",
              table_e.to(torch.bfloat16), ids, None),
             (f"{wide.shape[0]} bags x {wide.shape[1]} uniform lookups "
              f"({len(np.unique(wide))} distinct rows), unweighted "
              "(byte-bound)", table_e, wide, None)]
    for case, table, ids_np, weights in cases:
        case = (f"{EMBED['rows']} x {EMBED['dim']} "
                f"{str(table.dtype)[6:]} table, {case}")
        ix = torch.from_numpy(ids_np).to(DEVICE)
        got = one_launch(ops, "embed_agg",
                         lambda: ops.embed_agg(table, ix, weights), case)
        want = ops.ref.embed_agg_ref(table, ix, weights)
        err = same_bits(torch, got, want, case)
        weighted = weights is not None
        lib_ms, lib = None, ("none: embedding_bag sums a bf16 table into "
                             "bf16, not f32")
        if table.dtype == torch.float32:
            ix_long = ix.long()

            def call(table=table, ix_long=ix_long, weights=weights):
                return F.embedding_bag(ix_long, table, mode="sum",
                                       per_sample_weights=weights)
            check(bool(torch.allclose(call(), got, rtol=1e-5, atol=1e-5)),
                  "embed_agg vs embedding_bag")
            lib_ms = time_ms(torch, call, flush)
            lib = ("torch.nn.functional.embedding_bag(mode='sum', "
                   "per_sample_weights=w)")
        n_look, (b, d) = ix.numel(), got.shape
        bound_ = bytes_bound(len(np.unique(ids_np)) * d *
                             table.element_size() +
                             n_look * 4 * (1 + weighted) + b * d * 4,
                             n_look * d * (1 + weighted))
        kernel_line(results, "embed_agg", case, err,
                    time_ms(torch, lambda table=table, ix=ix, weights=weights:
                            emb.launch_embed_agg(table, ix, weights), flush),
                    time_ms(torch, lambda table=table, ix=ix, weights=weights:
                            ops.ref.embed_agg_ref(table, ix, weights),
                            flush, PLAIN_ITERS, 1),
                    bound_, lib_ms, lib, EMBED_SOURCE)
        floors = embed_floors(torch, emb, table, ix, flush)
        results[-1].update(floors, path=emb.kernel_takes(table, weights),
                           plan=emb.plan_of(table)._asdict(),
                           larger_bound="floor" if floors["floor_ms"] >
                           bound_[0] else bound_[1])
        emit({"phase": "kernels", "kernel": "embed_agg", "case": case,
              **floors})
        del ix, got, want
    del cases, table_e
    tokens = torch.from_numpy(data["corpus_tokens"]).to(DEVICE)
    gidx = torch.from_numpy(rng.integers(0, CORPUS["rows"], (8, RAG["k"]),
                                         dtype=np.int32)).to(DEVICE)
    case = (f"corpus_tokens [{CORPUS['rows']}, {CORPUS['chunk']}] int32, "
            f"ids [8, {RAG['k']}]")
    got = one_launch(ops, "embed_gather",
                     lambda: ops.embed_gather(tokens, gidx), case)
    err = same_bits(torch, got, ops.ref.embed_gather_ref(tokens, gidx), case)
    n_unique = int(torch.unique(gidx).numel())
    bound_ = bytes_bound(n_unique * CORPUS["chunk"] * 4 + gidx.numel() * 4
                         + gidx.numel() * CORPUS["chunk"] * 4)
    kernel_line(results, "embed_gather", case, err,
                time_ms(torch, lambda: emb.launch_embed_gather(tokens, gidx),
                        flush),
                time_ms(torch, lambda: ops.ref.embed_gather_ref(tokens, gidx),
                        flush, PLAIN_ITERS, 1),
                bound_,
                time_ms(torch, lambda: tokens[gidx.long()], flush),
                "tokens[ids] (one index_select)", EMBED_SOURCE)
    floors = embed_floors(torch, emb, tokens, gidx.reshape(-1, 1), flush)
    results[-1].update(floors, path=emb.kernel_takes(tokens, gather=True),
                       plan=emb.plan_of(tokens)._asdict(),
                       larger_bound="floor" if floors["floor_ms"] >
                       bound_[0] else bound_[1])
    emit({"phase": "kernels", "kernel": "embed_gather", "case": case,
          **floors})
    del tokens
    torch.cuda.empty_cache()
    embed_other_shapes(torch, np)
    return results


def embed_table(torch, np, rng, dtype, rows, d):
    """[rows, d] of ``dtype`` on the card: N(0, 4) values converted for
    float dtypes (fp8 e4m3 within its range), integers over the dtype's
    range for the others (int32: past 2^24, where the widening rounds)."""
    if dtype.is_floating_point:
        x = torch.from_numpy(rng.normal(0.0, 4.0, (rows, d)).astype(
            np.float32)).to(DEVICE)
        return x.to(dtype)
    info = torch.iinfo(dtype)
    return torch.from_numpy(rng.integers(
        max(info.min, -2**30), min(info.max, 2**30), (rows, d),
        endpoint=True)).to(DEVICE).to(dtype)


def embed_other_shapes(torch, np):
    """Untimed, bit for bit and one launch a call: the bag at EMBED_DIMS x
    EMBED_LOOKUPS on every table dtype of ``embed_agg.AGG_DTYPES``,
    unweighted and with f32 and bf16 weights, on a table and on its view
    table[1:] (another base alignment), and on a column slice (a row
    stride that is not the width); the gather of GATHER_DTYPES rows at
    EMBED_DIMS, table and view."""
    from repro_torch.kernels import embed_agg as emb
    from repro_torch.kernels import ops

    rng = np.random.default_rng(5)
    paths, n_agg, n_gather = set(), 0, 0
    bags, rows = 37, 1025
    for d in EMBED_DIMS:
        for dtype in emb.AGG_DTYPES:
            table = embed_table(torch, np, rng, dtype, rows, d)
            for t in (table, table[1:]):
                for n_look in EMBED_LOOKUPS:
                    ix = torch.from_numpy(rng.integers(
                        0, rows - 1, (bags, n_look),
                        dtype=np.int32)).to(DEVICE)
                    w = torch.from_numpy(rng.uniform(
                        0.5, 2.0, (bags, n_look)).astype(np.float32)).to(
                        DEVICE)
                    for weights in (None, w, w.bfloat16()):
                        wdt = None if weights is None else weights.dtype
                        what = (f"embed_agg {dtype} D={d} L={n_look} "
                                f"base+{t.data_ptr() % 16} weights {wdt}")
                        paths.add(emb.kernel_takes(t, weights))
                        got = one_launch(ops, "embed_agg",
                                         lambda: ops.embed_agg(t, ix, weights),
                                         what)
                        same_bits(torch, got, ops.ref.embed_agg_ref(
                            t, ix, weights), what)
                        n_agg += 1
    for dtype in emb.AGG_DTYPES:
        part = embed_table(torch, np, rng, dtype, rows, 128)[:, 8:72]
        ix = torch.from_numpy(rng.integers(0, rows, (bags, 33),
                                           dtype=np.int32)).to(DEVICE)
        what = f"embed_agg {dtype} column slice [:, 8:72] of D=128"
        paths.add(emb.kernel_takes(part))
        got = one_launch(ops, "embed_agg", lambda: ops.embed_agg(part, ix),
                         what)
        same_bits(torch, got, ops.ref.embed_agg_ref(part, ix), what)
        n_agg += 1
    for name in GATHER_DTYPES:
        dtype = getattr(torch, name)
        for d in EMBED_DIMS:
            table = embed_table(torch, np, rng, dtype, rows, d)
            for t in (table, table[1:]):
                ix = torch.from_numpy(rng.integers(0, rows - 1, (8, 4),
                                                   dtype=np.int32)).to(DEVICE)
                what = f"embed_gather {name} D={d} base+{t.data_ptr() % 16}"
                paths.add(emb.kernel_takes(t, gather=True))
                got = one_launch(ops, "embed_gather",
                                 lambda: ops.embed_gather(t, ix), what)
                same_bits(torch, got, ops.ref.embed_gather_ref(t, ix), what)
                n_gather += 1
    every = {f"{str(dt)[6:]}_v{v}" for dt in emb.AGG_DTYPES
             for v in (16, 8, 4, 2, 1) if v >= dt.itemsize}
    every |= {f"gather_v{v}" for v in (16, 8, 4, 2, 1)}
    check(every <= paths, f"embed kernels never run: {sorted(every - paths)}")
    emit({"phase": "kernels", "check": "embed other shapes, bit for bit",
          "agg_cases": n_agg, "gather_cases": n_gather,
          "paths": sorted(paths)})


# -- in-storage analytics and retrieval: the isp phase -------------------------


def phase_isp(torch, np, smi, served, data):
    """The port's isp path on the card, through its entry points: a
    4-node StoragePool, λFS ingest, the docker-cli front door, JOB frames
    over the SF-1 lineitem extent (f32, int8 and fp8 pools), the offload
    planner on the device and on the host, a dlrm-embed container, and
    RAG over the 1M x 768 corpus into full-width granite-3-2b."""
    import urllib.parse
    from repro_torch.core.container import (ImageManifest, from_jsonable,
                                            make_blob)
    from repro_torch.core.extent_store import AnalyticsJob, analytics_blob
    from repro_torch.core.lambda_fs import SHARABLE_NS
    from repro_torch.core.storage_pool import StoragePool
    from repro_torch.kernels import ops
    from repro_torch.launch import isp as isp_launch   # dlrm-embed app
    from repro_torch.runtime.offload import OffloadPlanner
    from repro_torch.runtime.retrieval import RetrievalFrontend
    from repro_torch.runtime.serve import PagedServer

    cfg, model, params = (served[k] for k in ("cfg", "model", "params"))
    rng = np.random.default_rng(3)
    li = data["lineitem"]
    pr, n_cols = LINEITEM["page_rows"], LINEITEM["cols"]
    sf1_pages = -(-li.shape[0] // pr)
    ext_cfg = {"n_pages": sf1_pages + HOST_SLICE // pr, "page_rows": pr,
               "n_cols": n_cols, "device": DEVICE}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_phase = time.monotonic()
    out = {}

    def wire(stats):
        return stats.bytes_tx + stats.bytes_rx

    def plain_scan(store, name, job):
        return ops.ref.scan_filter_reduce_ref(
            store.pages, store.page_table(name), store.extents[name].n_rows,
            job.threshold, scales=store.scales, filter_col=job.filter_col,
            filter_op=job.filter_op).cpu().numpy()

    def plain_topk(store, name, job):
        q = torch.from_numpy(job.padded_query(store.n_cols)).to(DEVICE)
        return ops.ref.topk_scan_ref(
            store.pages, store.page_table(name), store.extents[name].n_rows,
            q, k=job.k, metric=job.metric, scales=store.scales).cpu().numpy()

    # 1. the analytics image, pulled onto all four nodes over Ether-oN
    pool = StoragePool(4, extent_cfg=ext_cfg)
    pool.broadcast_pull("isp-analytics", analytics_blob())
    ips = pool.alive_nodes()
    # 2. λFS ingest of a 65,536-row slice of lineitem on node 1
    node = pool.nodes[ips[1]]
    sl = li[:HOST_SLICE]
    node.fs.write("/data/lineitem.bin", sl.tobytes(), SHARABLE_NS,
                  actor="host")
    node.ingest_extent("lineitem-slice", "/data/lineitem.bin", n_cols)
    # 3. an AnalyticsJob through the docker-cli front door
    job = AnalyticsJob(extent="lineitem-slice", filter_col=4,
                       filter_op="eq", threshold=24.0, reduce="count")
    cid = json.loads(node.docker.handle_http(
        "POST /containers/create?image=isp-analytics"))["Id"]
    q_str = urllib.parse.quote(json.dumps([job.to_dict()]))
    resp = from_jsonable(json.loads(node.docker.handle_http(
        f"POST /containers/{cid}/start?job={q_str}")))
    block = resp["result"][0]
    host = ops.scan_filter_reduce_host(
        torch.from_numpy(node.extents.get("lineitem-slice")), 24.0,
        page_rows=pr, filter_col=4, filter_op="eq").numpy()
    check(np.array_equal(block, host), "front door block != host fold")
    check(block[0, 0] == (sl[:, 4] == 24.0).sum(), "front door count")
    out["front_door"] = {"extent_rows": HOST_SLICE, "job": "count(quantity"
                         " == 24)", "count": float(block[0, 0]),
                         "bit_identical_to_host_fold": True}
    # 4. the full SF-1 extent in storage: five jobs in one JOB frame
    store = pool.nodes[ips[0]].extents
    t0 = time.monotonic()
    store.put("lineitem", li)
    torch.cuda.synchronize()
    put_s = time.monotonic() - t0
    jobs = [AnalyticsJob(extent="lineitem", filter_col=col, filter_op=op,
                         threshold=thr, job_id=i)
            for i, (_, col, op, thr) in enumerate(SCAN_JOBS)]
    before = dict(vars(pool.driver.stats))
    t0 = time.monotonic()
    blocks = from_jsonable(pool.driver.submit_jobs(
        ips[0], [j.to_dict() for j in jobs]))
    frame_s = time.monotonic() - t0
    stats = pool.driver.stats
    wire_b = wire(stats) - before["bytes_tx"] - before["bytes_rx"]
    for j, b in zip(jobs, blocks):
        check(np.array_equal(b, plain_scan(store, "lineitem", j)),
              f"SF-1 JOB frame job {j.job_id} != plain version")
    scanned = len(jobs) * store.extents["lineitem"].nbytes
    out["sf1_job_frame"] = {
        "rows": li.shape[0], "pages": sf1_pages, "jobs": len(jobs),
        "ingest_s": put_s, "frame_wall_s": frame_s,
        "per_job_wall_s": frame_s / len(jobs),
        "tx_commands": stats.tx_commands - before["tx_commands"],
        "upcalls": stats.rx_completions - before["rx_completions"],
        "wire_bytes": wire_b, "bytes_scanned": scanned,
        "reduction_ratio": scanned / wire_b,
        "counts": [float(b[0, 0]) for b in blocks],
        "blocks_equal_plain_version": True}
    # the host leg at full size for one job: the whole extent through
    # Ether-oN frames, then the host fold
    planner = OffloadPlanner(pool)
    before = dict(vars(pool.driver.stats))
    t0 = time.monotonic()
    rec = planner.execute([jobs[1]], force="host")[0]
    host_s = time.monotonic() - t0
    check(rec["where"] == "host" and np.array_equal(rec["block"], blocks[1]),
          "SF-1 host leg block != in-storage block")
    out["sf1_host_leg"] = {
        "job": SCAN_JOBS[1][0], "wall_s": host_s,
        "upcalls": pool.driver.stats.rx_completions - before["rx_completions"],
        "wire_bytes": wire(pool.driver.stats) - before["bytes_tx"] -
        before["bytes_rx"], "equals_in_storage_block": True}
    # 5. the planner on the slice: batched JOB frames vs fetch + host fold
    sjobs = [AnalyticsJob(extent="lineitem-slice", filter_col=col,
                          filter_op=op, threshold=thr, job_id=i)
             for i, (_, col, op, thr) in enumerate(SCAN_JOBS)]
    runs = {}
    for force in ("device", "host", None):
        before = dict(vars(pool.driver.stats))
        t0 = time.monotonic()
        recs = planner.execute(sjobs, force=force)
        secs = time.monotonic() - t0
        runs[force or "planner"] = (recs, {
            "where": [r["where"] for r in recs],
            "wall_s": secs, "per_job_wall_s": secs / len(sjobs),
            "wire_bytes": wire(pool.driver.stats) - before["bytes_tx"] -
            before["bytes_rx"],
            "job_frames": pool.driver.stats.job_frames -
            before["job_frames"],
            "extent_reads": pool.driver.stats.extent_reads -
            before["extent_reads"]})
    for d, h in zip(runs["device"][0], runs["host"][0]):
        check(d["where"] == "device" and h["where"] == "host",
              "forced placements")
        check(np.array_equal(d["block"], h["block"]),
              f"slice job {d['job'].job_id}: device block != host block")
    est = runs["planner"][0][0]["est"]
    out["planner_slice"] = {
        "note": f"five jobs on a {HOST_SLICE}-row slice of the SF-1 "
                "extent, each placement (sf1_host_leg: one job's host leg "
                "at full size)", "device_equals_host": True,
        "modeled_host_ms": est.host_s * 1e3,
        "modeled_dvirtfw_ms": est.dvirtfw_s * 1e3,
        **{k: v[1] for k, v in runs.items()}}
    # 6. the same SF-1 extent on int8 and fp8 pools: a scan and a top-k job
    out["quantized"] = {}
    for code in ("int8", "fp8"):
        qpool = StoragePool(1, extent_cfg={**ext_cfg, "page_dtype": code})
        qpool.broadcast_pull("isp-analytics", analytics_blob())
        qip = qpool.alive_nodes()[0]
        qstore = qpool.nodes[qip].extents
        qstore.put("lineitem", li)
        qjobs = [AnalyticsJob(extent="lineitem", filter_col=5,
                              filter_op="ge", threshold=50000.0, job_id=0),
                 AnalyticsJob(extent="lineitem", reduce="topk", k=4,
                              query=[float(v) for v in
                                     rng.standard_normal(n_cols)],
                              job_id=1)]
        t0 = time.monotonic()
        qb = from_jsonable(qpool.driver.submit_jobs(
            qip, [j.to_dict() for j in qjobs]))
        secs = time.monotonic() - t0
        check(np.array_equal(qb[0], plain_scan(qstore, "lineitem",
                                               qjobs[0])),
              f"{code} scan JOB != plain version")
        check(np.array_equal(qb[1], plain_topk(qstore, "lineitem",
                                               qjobs[1])),
              f"{code} top-k JOB != plain version")
        out["quantized"][code] = {
            "frame_wall_s": secs, "count_ge": float(qb[0][0, 0]),
            "topk_ids": qb[1][1, :4].tolist(),
            "extent_bytes": qstore.extents["lineitem"].nbytes,
            "wire_bytes": wire(qpool.driver.stats)}
        del qpool, qstore
    # 6b. top-k JOBs over pools the card took only through the plain
    # version before: f32 pages of 1,024 rows (four units a page) and an
    # int8 store of 24 columns (rows no tensor map describes)
    out["topk_pools"] = {}
    for label, cfg_over in (("f32 pages of 1024 rows",
                             {"page_rows": 1024}),
                            ("int8 store of 24 columns",
                             {"n_cols": TOPK_NARROW["cols"],
                              "page_dtype": "int8"})):
        tcfg = {**ext_cfg, **cfg_over}
        tcfg["n_pages"] = -(-li.shape[0] // tcfg["page_rows"]) + 1
        tpool = StoragePool(1, extent_cfg=tcfg)
        tpool.broadcast_pull("isp-analytics", analytics_blob())
        tip = tpool.alive_nodes()[0]
        tstore = tpool.nodes[tip].extents
        tstore.put("lineitem", li)
        tjob = AnalyticsJob(extent="lineitem", reduce="topk", k=8,
                            query=[float(v) for v in
                                   rng.standard_normal(n_cols)], job_id=0)
        t0 = time.monotonic()
        tb = from_jsonable(tpool.driver.submit_jobs(tip, [tjob.to_dict()]))
        secs = time.monotonic() - t0
        check(np.array_equal(tb[0], plain_topk(tstore, "lineitem", tjob)),
              f"top-k JOB over {label} != plain version")
        out["topk_pools"][label] = {
            "frame_wall_s": secs, "topk_ids": tb[0][1, :8].tolist(),
            "page_rows": tstore.page_rows, "n_cols": tstore.n_cols,
            "equals_plain_version": True}
        del tpool, tstore
    # 7. the DLRM embed container on node 2
    pool.broadcast_pull("dlrm-embed", make_blob(
        ImageManifest("dlrm-embed", "dlrm-embed", ["rootfs-layer0"]),
        {"rootfs-layer0": b"binaries+runtime"}))
    enode = pool.nodes[ips[2]]
    etable = rng.standard_normal((512, isp_launch.EMBED_DIM),
                                 dtype=np.float32)
    eidx = rng.integers(0, 512, (32, isp_launch.EMBED_LOOKUPS),
                        dtype=np.int32)
    enode.fs.write("/data/table.npy", etable.tobytes(), SHARABLE_NS,
                   actor="host")
    enode.fs.write("/data/idx.npy", eidx.tobytes(), SHARABLE_NS,
                   actor="host")
    _, pooled = enode.docker.cmd_run("dlrm-embed")
    want = ops.ref.embed_agg_ref(torch.from_numpy(etable).to(DEVICE),
                                 torch.from_numpy(eidx).to(DEVICE))
    check(np.array_equal(pooled, want.cpu().numpy()), "dlrm-embed result")
    out["dlrm_embed"] = {"pooled_shape": list(pooled.shape)}
    del pool, store
    torch.cuda.empty_cache()
    # 8. RAG over the 1M x 768 corpus into full-width granite-3-2b
    rpool = StoragePool(1, extent_cfg={
        "n_pages": -(-CORPUS["rows"] // CORPUS["page_rows"]),
        "page_rows": CORPUS["page_rows"], "n_cols": CORPUS["dim"],
        "device": DEVICE})
    rpool.broadcast_pull("isp-analytics", analytics_blob())
    server = PagedServer(model, params, page_size=SERVE["page"],
                         hbm_pages=SERVE["hbm_pages"], device=DEVICE)
    template = rng.integers(0, cfg.vocab_size, RAG["template"],
                            dtype=np.int32)
    fe = RetrievalFrontend(rpool, server, corpus_tokens=data[
        "corpus_tokens"] % cfg.vocab_size, template=template, k=RAG["k"])
    t0 = time.monotonic()
    fe.ingest(data["corpus"])
    torch.cuda.synchronize()
    ingest_s = time.monotonic() - t0
    queries = rng.standard_normal((RAG["queries"], CORPUS["dim"]),
                                  dtype=np.float32)
    queries[0] = data["corpus"][DUP_IDS[0]]
    rstore = rpool.nodes[rpool.alive_nodes()[0]].extents
    rag_job = AnalyticsJob(extent=fe.extent, reduce="topk", k=RAG["k"],
                           query=[float(v) for v in queries[0]])
    check(fe.planner.estimate(rag_job).choice == "device",
          "the planner prices corpus retrieval on the device")
    waves = []
    for wave in range(RAG["waves"]):
        tails = [rng.integers(0, cfg.vocab_size, RAG["question"],
                              dtype=np.int32) for _ in queries]
        g0 = ops.launch_counts()["embed_gather"]
        h0 = server.tier_stats()["prefix_hits"]
        t0 = time.monotonic()
        prompts, hits = fe.build_prompts(queries, tails, force="device")
        retrieve_s = time.monotonic() - t0
        check(ops.launch_counts()["embed_gather"] - g0 == 1,
              "one embed_gather launch per build_prompts")
        check(all(h["where"] == "device" and len(h["ids"]) == RAG["k"]
                  for h in hits), "retrieval ran in storage")
        check(hits[0]["ids"][:3] == list(DUP_IDS), "planted rows retrieved")
        want_len = RAG["template"] + RAG["k"] * CORPUS["chunk"] + \
            RAG["question"]
        check(all(len(p) == want_len for p in prompts), "prompt length")
        t0 = time.monotonic()
        ttft = []
        for i, p in enumerate(prompts):
            server.add_request(100 * wave + i, p, chunk=SERVE["chunk"])
            ttft.append(time.monotonic() - t0)
        toks = server.decode(RAG["gen"])
        check(all(len(t) == RAG["gen"] and all(0 <= v < cfg.vocab_size
                                               for v in t)
                  for t in toks.values()), "RAG tokens")
        waves.append({"retrieve_s": retrieve_s, "admit_s": ttft[-1],
                      "ttft_first_s": ttft[0],
                      "prefix_hits": server.tier_stats()["prefix_hits"] -
                      h0, "top_ids_query0": hits[0]["ids"]})
    check(waves[1]["prefix_hits"] > 0, "second wave rides the prefix cache")
    check(np.array_equal(
        plain_topk(rstore, fe.extent, rag_job)[1, :RAG["k"]],
        np.asarray(hits[0]["ids"], np.float32)),
        "RAG ids == plain top-k on the card")
    out["rag"] = {"corpus": [CORPUS["rows"], CORPUS["dim"]],
                  "ingest_s": ingest_s, "k": RAG["k"],
                  "prompt_len": want_len, "queries": RAG["queries"] *
                  RAG["waves"], "waves": waves, "where": fe.stats,
                  "prefix_hit_rate": server.prefix_hit_rate(),
                  "etheron_wire_bytes": wire(rpool.driver.stats),
                  "corpus_bytes": rstore.extents[fe.extent].nbytes}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in NEW_KERNELS:
        check(counts[name] > 0, f"{name} launched on the isp path")
    # the RAG admissions' prefill chunks and decode steps
    for name in (CHUNK_OF["f32"], DECODE_OF["f32"]):
        check(counts[name] > 0, f"{name} launched on the isp path")
    emit({"phase": "isp", **out, "launches": counts,
          "phase_s": time.monotonic() - t_phase,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    return counts


# -- dense serving: flash attention and the RWKV6 wkv scan --------------------

DENSE_SOURCE = {"flash_attention_f32":
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "flash_attention_fwd_lse_f32":
                "src/repro_torch/kernels/csrc/flash_attention.cu",
                "flash_attention_bwd_f32":
                "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                "rwkv_scan_f32": "src/repro_torch/kernels/csrc/rwkv_scan.cu",
                "rwkv_scan_states_f32":
                "src/repro_torch/kernels/csrc/rwkv_scan.cu",
                "rwkv_scan_bwd_f32":
                "src/repro_torch/kernels/csrc/rwkv_scan_bwd.cu"}
# the backwards replace no Pallas kernel: the JAX package takes the
# gradients by autodiff of chunked_attention and of wkv_chunked
DENSE_REPLACES = {"flash_attention_f32":
                  "src/repro/kernels/flash_attention.py:26",
                  "flash_attention_fwd_lse_f32":
                  "src/repro/kernels/flash_attention.py:26",
                  "flash_attention_bwd_f32": "src/repro/models/layers.py:125",
                  "rwkv_scan_f32": "src/repro/kernels/rwkv_scan.py:21",
                  "rwkv_scan_states_f32": "src/repro/kernels/rwkv_scan.py:21",
                  "rwkv_scan_bwd_f32": "src/repro/models/rwkv6.py:56"}
# granite-3-2b's dense prefill: 8 prompts of 512 tokens, 32 heads over 8
# kv heads of 64
FLASH = {"batch": 8, "heads": 32, "kv_heads": 8, "seq": 512, "head_dim": 64}
# the flash kernel's cases, prompts of 512 tokens: granite-3-2b's prefill
# (the dense phase's), phi3-mini-3.8b's (32 heads of 96, no grouping) and
# qwen2-72b's heads (64 of 128 over 8 kv heads) on 4 prompts; then the
# families phase's models at 8 x 512 ("family": the model whose launches
# the entry reports): phi3.5-moe's heads, llama4-scout's group of 5 (not a
# power of two), zamba2's shared block, paligemma's head_dim 256 on the
# kernel's FMA route, hubert's non-causal encoder at head_dim 80
FLASH_CASES = (
    ("granite-3-2b prefill", FLASH, (True, False)),
    ("phi3-mini-3.8b prefill", {"batch": 8, "heads": 32, "kv_heads": 32,
                                "seq": 512, "head_dim": 96}, (True,)),
    ("qwen2-72b heads, G = 8", {"batch": 4, "heads": 64, "kv_heads": 8,
                                "seq": 512, "head_dim": 128}, (True,)),
    ("phi3.5-moe-42b-a6.6b prefill", {
        "batch": 8, "heads": 32, "kv_heads": 8, "seq": 512, "head_dim": 128,
        "family": "phi3.5-moe"}, (True,)),
    ("llama4-scout-17b-a16e prefill, G = 5", {
        "batch": 8, "heads": 40, "kv_heads": 8, "seq": 512, "head_dim": 128,
        "family": "llama4-scout"}, (True,)),
    ("zamba2-1.2b shared block", {
        "batch": 8, "heads": 32, "kv_heads": 32, "seq": 512, "head_dim": 64,
        "family": "zamba2"}, (True,)),
    ("paligemma-3b prefill, FMA route", {
        "batch": 8, "heads": 8, "kv_heads": 1, "seq": 512, "head_dim": 256,
        "family": "paligemma"}, (True,)),
    ("hubert-xlarge encoder", {
        "batch": 8, "heads": 16, "kv_heads": 16, "seq": 512, "head_dim": 80,
        "family": "hubert"}, (False,)),
)
# rwkv6-3b's prefill: 8 prompts of 512 tokens, 40 heads of 64, chunk 32
WKV = {"batch": 8, "seq": 512, "heads": 40, "dk": 64, "dv": 64, "chunk": 32}
# the dense phase: the serve phase's granite-3-2b and prompts, then
# rwkv6-3b; 64 greedy tokens a request, f32 caches
DENSE = {"rwkv_arch": "rwkv6-3b", "rwkv_reduced": False, "requests": 8,
         "prompt_len": 512, "gen": 64, "profile_steps": 4}
# phi3-mini-3.8b through the same path at full width (32 heads of 96),
# cut to PHI3["layers"] layers: the flash kernel at head_dim 96
PHI3 = {"arch": "phi3-mini-3.8b", "reduced": False, "layers": 2, "gen": 16}
WKV_TOL = 1e-4           # times max(1, max |plain|), on o and on sT


FLASH_ROUTE_NOTE = ("three TF32 products (hi*hi, hi*lo, lo*hi) per f32 "
                    "product at 495 TFLOP/s dense")


def flash_bound(b, h, hkv, s, d, causal):
    """q, k, v and out once against 4*D f32 operations per (query, key)
    pair kept (the QK dot and the PV update)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    return bytes_bound(4 * (2 * b * h * s * d + 2 * b * hkv * s * d),
                       b * h * pairs * 4 * d)


def flash_bounds(b, h, hkv, s, d, causal):
    """(the bound of the kernel's route, the f32 bound): the same bytes
    against three TF32 tensor-core products per f32 product (3xTF32) at
    TF32_FLOPS, and against the f32 operations at F32_FLOPS."""
    pairs = s * (s + 1) // 2 if causal else s * s
    n_bytes = 4 * (2 * b * h * s * d + 2 * b * hkv * s * d)
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = 3 * b * h * pairs * 4 * d / TF32_FLOPS * 1e3
    route = (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")
    return route, flash_bound(b, h, hkv, s, d, causal)


def wkv_ops_per_chunk(c, dk, dv):
    """f32 operations of one chunk of one (batch, head) in the chunk
    form: cumsum and cum - logw; the strictly lower scores (sub, exp, two
    multiplies, add per key dim); the diagonal; scores @ v; r * exp(cx)
    and its product with the state; the k decays, exp(cum[-1]), the
    decayed state and k2^T v."""
    return (2 * c * dk + c * (c - 1) // 2 * dk * 5 + 3 * c * dk +
            c * (c + 1) // 2 * dv * 2 + 2 * c * dk + 2 * c * dk * dv +
            3 * c * dk + dk + 2 * dk * dv + 2 * c * dk * dv)


def wkv_bound(b, s, h, dk, dv, chunk):
    n_bytes = 4 * (3 * b * s * h * dk + 2 * b * s * h * dv + h * dk +
                   2 * b * h * dk * dv)
    return bytes_bound(n_bytes, b * h * (s // chunk) *
                       wkv_ops_per_chunk(chunk, dk, dv))


def phase_dense_kernels(torch, np, flush):
    """Flash attention (forward, and the training forward and backward)
    and the wkv scan (at rwkv6-3b's prefill shape), each against its
    plain version."""
    results = flash_cases(torch, np, flush)
    flash_other_shapes(torch, np)
    results += flash_train_cases(torch, np, flush)
    flash_train_other_shapes(torch, np)
    results += wkv_cases(torch, np, flush)
    wkv_other_shapes(torch, np)
    results += wkv_train_cases(torch, np, flush)
    wkv_train_other_shapes(torch, np)
    return results


def flash_cases(torch, np, flush):
    """Flash attention against its plain version at FLASH_CASES' shapes,
    each beside both bounds and SDPA on the same tensors."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    results = []
    rng = np.random.default_rng(4)
    for label, shape, causals in FLASH_CASES:
        b, h, hkv, s, d = (shape[k] for k in ("batch", "heads", "kv_heads",
                                              "seq", "head_dim"))
        q = torch.from_numpy(rng.standard_normal(
            (b, h, s, d), dtype=np.float32)).to(DEVICE)
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, s, d), dtype=np.float32)).to(DEVICE) for _ in range(2))
        k_rep = k.repeat_interleave(h // hkv, dim=1)
        v_rep = v.repeat_interleave(h // hkv, dim=1)
        for causal in causals:
            def kernel(causal=causal):
                return ops.flash_attention(q, k, v, causal=causal)

            def plain(causal=causal):
                return ops.ref.flash_attention_ref(q, k, v, causal=causal)

            def lib(causal=causal):
                return F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                      is_causal=causal)
            case = (f"{'causal' if causal else 'non-causal'} B={b} H={h} "
                    f"Hkv={hkv} S={s} D={d} ({label})")
            got = kernel()
            torch.cuda.synchronize()
            err = float((got - plain()).abs().max())
            check(bool(torch.isfinite(got).all()), f"flash {case}: finite")
            check(err <= KERNEL_TOL, f"flash {case}: max_abs_err {err} > "
                  f"{KERNEL_TOL}")
            route, f32 = flash_bounds(b, h, hkv, s, d, causal)
            kernel_line(
                results, "flash_attention_f32", case, err,
                time_ms(torch, kernel, flush),
                time_ms(torch, plain, flush, PLAIN_ITERS, 1), route,
                time_ms(torch, lib, flush),
                "torch.nn.functional.scaled_dot_product_attention(is_causal) "
                "on f32 with the kv heads repeated (outside the timing)",
                DENSE_SOURCE["flash_attention_f32"], KERNEL_TOL)
            results[-1]["route_bound"] = "3xTF32 mma: " + FLASH_ROUTE_NOTE
            results[-1]["bound_f32_ms"], results[-1]["bound_f32_by"] = f32
            if "family" in shape:
                results[-1]["families_model"] = shape["family"]
        del q, k, v, k_rep, v_rep
        torch.cuda.empty_cache()
    return results


# (B, H, Hkv, Sq, Sk, D, causal): ragged lengths, head dims padded to the
# next multiple of 32 (80, 8), Q in shared memory (160 and up), GQA
# groups that do not divide 64 (3, 12) and 64 heads a kv head, Sq != Sk
FLASH_SHAPES = ((1, 4, 4, 100, 100, 32, True), (2, 6, 2, 77, 77, 80, True),
                (1, 12, 1, 64, 64, 96, False), (1, 2, 2, 130, 70, 128, False),
                (1, 4, 2, 96, 96, 160, True), (1, 2, 1, 64, 64, 192, True),
                (1, 2, 2, 50, 50, 224, False), (1, 8, 1, 128, 128, 256, True),
                (1, 64, 1, 40, 40, 8, True))


def flash_other_shapes(torch, np):
    """Flash attention at FLASH_SHAPES within 1e-4 of the plain version.
    Not timed."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(9)
    worst = 0.0
    for b, h, hkv, sq, sk, d, causal in FLASH_SHAPES:
        q = torch.from_numpy(rng.standard_normal(
            (b, h, sq, d), dtype=np.float32)).to(DEVICE)
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, sk, d), dtype=np.float32)).to(DEVICE) for _ in range(2))
        got = ops.flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((got - ops.ref.flash_attention_ref(q, k, v, causal))
                    .abs().max())
        check(bool(torch.isfinite(got).all()) and err <= KERNEL_TOL,
              f"flash B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} D={d} "
              f"causal={causal}: max_abs_err {err}")
        worst = max(worst, err)
    emit({"phase": "kernels", "check": "flash attention at other shapes",
          "shapes": FLASH_SHAPES, "max_abs_err": worst,
          "tolerance": KERNEL_TOL})


# the training kernels' cases: granite-3-2b's and phi3-mini-3.8b's
# attention at a train batch of 8 x 512 tokens, and granite-3-2b's at the
# train phase's microbatch of 4 x 512 (TRAIN: batch 8, grad-accum 2),
# causal
FLASH_TRAIN_CASES = (
    ("granite-3-2b train", FLASH),
    ("granite-3-2b train microbatch", {**FLASH, "batch": 4}),
    ("phi3-mini-3.8b train", {"batch": 8, "heads": 32, "kv_heads": 32,
                              "seq": 512, "head_dim": 96}),
)
# untimed: FLASH_SHAPES, head_dim 16 at a group of 16, and head_dim 128
# at a group of 8 (the backward's 16-row tiles with the heads' merge)
FLASH_TRAIN_SHAPES = FLASH_SHAPES + ((2, 16, 1, 33, 33, 16, True),
                                     (1, 16, 2, 100, 100, 128, True))
LSE_TOL = 1e-5
BWD_TOL = 1e-4           # times max(1, max |plain|), on dq, dk and dv


def flash_bwd_bounds(b, h, hkv, s, d, causal):
    """(the bound of the kernel's route, the f32 bound): q, k, v, out,
    dout, lse read and dq, dk, dv written once, against the five products
    a kept (query, key) pair needs (S, dP, dV, dK, dQ: 10 * D f32
    operations) as three TF32 products each at TF32_FLOPS (the 3xTF32
    route, D <= 128 and G <= 64) or at F32_FLOPS (the FMA route)."""
    pairs = s * (s + 1) // 2 if causal else s * s
    n_bytes = 4 * (5 * b * h * s * d + 4 * b * hkv * s * d + b * h * s)
    ops_ = b * h * pairs * 10 * d
    f32 = bytes_bound(n_bytes, ops_)
    if d > 128 or h // hkv > 64:
        return f32, f32
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = 3 * ops_ / TF32_FLOPS * 1e3
    return ((b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")), f32


def check_flash_train(torch, ops, q, k, v, do, causal, what):
    """The training forward and backward against their plain versions:
    out bit-equal to the forward-only kernel, lse within LSE_TOL, dq, dk,
    dv within BWD_TOL x max(1, max |plain|) and the same bits on a second
    run; the kernel's and the plain backward's dq, dk, dv each held to
    float64 autograd of the plain forward, within BWD_TOL x max(1,
    max |float64|).  Returns (lse err, {dq, dk, dv: readings}): the error
    against the plain version, its limit and their ratio, max |plain|,
    and the kernel's and the plain version's errors against float64
    beside that limit."""
    out, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    check(torch.equal(out, ops.flash_attention(q, k, v, causal=causal)),
          f"{what}: out of the lse forward differs from flash_attention_f32")
    _, plain_lse = ops.ref.flash_attention_lse_ref(q, k, v, causal=causal)
    lse_err = float((lse - plain_lse).abs().max())
    check(lse_err <= LSE_TOL, f"{what}: lse {lse_err} > {LSE_TOL}")
    got = ops.flash_attention_bwd(q, k, v, out, lse, do, causal)
    again = ops.flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    want = ops.ref.flash_attention_bwd_ref(q, k, v, out, lse, do, causal)
    leaves = [t.double().requires_grad_(True) for t in (q, k, v)]
    exact = torch.autograd.grad(
        ops.ref.flash_attention_ref(*leaves, causal=causal), leaves,
        do.double())
    per = {}
    for name, g, a, w, x in zip(("dq", "dk", "dv"), got, again, want, exact):
        check(bool(torch.isfinite(g).all()), f"{what} {name}: finite")
        check(torch.equal(g, a), f"{what} {name}: two backward runs differ")
        top = float(w.abs().max())
        lim = BWD_TOL * max(1.0, top)
        e = float((g - w).abs().max())
        check(e <= lim, f"{what} {name}: {e} > {lim}")
        lim64 = BWD_TOL * max(1.0, float(x.abs().max()))
        ke = float((g.double() - x).abs().max())
        check(ke <= lim64, f"{what} {name}: kernel vs float64 autograd "
              f"{ke} > {lim64}")
        pe = float((w.double() - x).abs().max())
        check(pe <= lim64, f"{what} {name}: plain vs float64 autograd "
              f"{pe} > {lim64}")
        per[name] = {"err_vs_plain": e, "limit": lim,
                     "err_over_limit": e / lim, "max_abs_plain": top,
                     "err_vs_float64": ke, "plain_err_vs_float64": pe,
                     "float64_limit": lim64}
    return lse_err, per


def check_flash_bwd_plan(torch, ops, q, k, v, do, causal, what):
    """The workspace and tickets the wrapper gives the backward
    (``ref.flash_bwd_plan``) against what the kernel touches: one launch
    through the C entry point with both poisoned past the plan's sizes
    (NaN floats, tickets of 7) must write exactly ``plan.workspace``
    floats, leave every ticket zeroed and the poisoned ones as they were,
    and give the wrapper's dq, dk, dv bits.  A launch outside the
    wrapper: no count.  Returns the reading."""
    from repro_torch.kernels import flash_attention as fa

    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    plan = ops.ref.flash_bwd_plan(b, h, hkv, sq, sk, d)
    spare = 4096
    ws = torch.full((plan.workspace + spare,), float("nan"),
                    device=q.device)
    tickets = torch.full((plan.tickets + spare,), 7, dtype=torch.int32,
                         device=q.device)
    tickets[:plan.tickets] = 0
    out, lse = ops.flash_attention_lse(q, k, v, causal=causal)
    want = ops.flash_attention_bwd(q, k, v, out, lse, do, causal)
    got = [torch.empty_like(t) for t in (q, k, v)]
    di = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    err = fa._bind_bwd()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        do.data_ptr(), lse.data_ptr(), di.data_ptr(),
        *(t.data_ptr() for t in got), ws.data_ptr(), tickets.data_ptr(),
        tickets.numel(), b, h, hkv, sq, sk, d, int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err == 0, f"{what}: plan launch cudaError_t {err}")
    torch.cuda.synchronize()
    written = int((~torch.isnan(ws)).sum())
    reading = {
        "plan_workspace_floats": plan.workspace,
        "workspace_floats_written": written,
        "written_past_plan": int((~torch.isnan(ws[plan.workspace:])).sum()),
        "plan_tickets": plan.tickets,
        "tickets_left_nonzero": int((tickets[:plan.tickets] != 0).sum()),
        "poisoned_tickets_changed": int(
            (tickets[plan.tickets:] != 7).sum()),
        "bits_equal_wrapper": all(torch.equal(g, w)
                                  for g, w in zip(got, want))}
    check(written == plan.workspace and not reading["written_past_plan"],
          f"{what}: the kernel wrote {written} workspace floats "
          f"({reading['written_past_plan']} past the plan's "
          f"{plan.workspace})")
    check(not reading["tickets_left_nonzero"]
          and not reading["poisoned_tickets_changed"],
          f"{what}: tickets {reading}")
    check(reading["bits_equal_wrapper"], f"{what}: the plan launch's dq, "
          "dk, dv differ from the wrapper's")
    return reading


def flash_train_cases(torch, np, flush):
    """The training forward (flash_attention_fwd_lse_f32) and backward
    (flash_attention_bwd_f32) at FLASH_TRAIN_CASES, checked and timed;
    the backward beside SDPA's backward (fwd + bwd minus fwd)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops

    results, plans = [], []
    rng = np.random.default_rng(11)
    for label, shape in FLASH_TRAIN_CASES:
        b, h, hkv, s, d = (shape[k] for k in ("batch", "heads", "kv_heads",
                                              "seq", "head_dim"))
        q, do = (torch.from_numpy(rng.standard_normal(
            (b, h, s, d), dtype=np.float32)).to(DEVICE) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, s, d), dtype=np.float32)).to(DEVICE) for _ in range(2))
        case = f"causal B={b} H={h} Hkv={hkv} S={s} D={d} ({label})"
        lse_err, per = check_flash_train(torch, ops, q, k, v, do, True,
                                         case)
        err = max(r["err_vs_plain"] for r in per.values())
        out, lse = ops.flash_attention_lse(q, k, v, causal=True)
        g = h // hkv
        rep = [t.repeat_interleave(g, dim=1).requires_grad_(True)
               for t in (k, v)]
        qg = q.clone().requires_grad_(True)

        def lib_fwd():
            with torch.no_grad():
                return F.scaled_dot_product_attention(qg, *rep,
                                                      is_causal=True)

        def lib_fwd_bwd():
            o = F.scaled_dot_product_attention(qg, *rep, is_causal=True)
            return torch.autograd.grad(o, [qg, *rep], do)

        lib_ms = (time_ms(torch, lib_fwd_bwd, flush) -
                  time_ms(torch, lib_fwd, flush))
        route, f32 = flash_bounds(b, h, hkv, s, d, True)
        kernel_line(
            results, "flash_attention_fwd_lse_f32", case, lse_err,
            time_ms(torch, lambda: ops.flash_attention_lse(q, k, v, True),
                    flush),
            time_ms(torch, lambda: ops.ref.flash_attention_lse_ref(
                q, k, v, True), flush, PLAIN_ITERS, 1), route,
            time_ms(torch, lib_fwd, flush),
            "torch.nn.functional.scaled_dot_product_attention(is_causal) "
            "forward on f32 with the kv heads repeated",
            DENSE_SOURCE["flash_attention_fwd_lse_f32"],
            f"out bit-equal to flash_attention_f32; lse {LSE_TOL}")
        results[-1]["bound_f32_ms"], results[-1]["bound_f32_by"] = f32
        bound_, f32 = flash_bwd_bounds(b, h, hkv, s, d, True)
        kernel_line(
            results, "flash_attention_bwd_f32", case, err,
            time_ms(torch, lambda: ops.flash_attention_bwd(
                q, k, v, out, lse, do, True), flush),
            time_ms(torch, lambda: ops.ref.flash_attention_bwd_ref(
                q, k, v, out, lse, do, True), flush, PLAIN_ITERS, 1),
            bound_, lib_ms,
            "backward of torch.nn.functional.scaled_dot_product_attention"
            "(is_causal) on f32 with the kv heads repeated: fwd + bwd "
            "minus fwd", DENSE_SOURCE["flash_attention_bwd_f32"],
            f"{BWD_TOL} x max(1, max|plain|) on dq, dk, dv; deterministic")
        results[-1]["bound_f32_ms"], results[-1]["bound_f32_by"] = f32
        results[-1]["errors"] = per
        results[-1]["route_bound"] = "3xTF32 mma: " + FLASH_ROUTE_NOTE
        results[-1]["note"] = ("3xTF32 mma.sync (lo = x - hi cut by the "
                               "tensor core) for D <= 128 and G <= 64, else "
                               "f32 FMA; a dK/dV block a (batch, head, key "
                               "tile), the G heads' shares merged head 0 "
                               "first by the last block of each group, "
                               "the dQ blocks in the same launch; S and "
                               "dP recomputed in the dQ blocks (7 "
                               "products a pair; the bound counts 5); each "
                               "walked tile's share summed in the mma's C, "
                               "tiles joined by f32 adds")
        plans.append({"case": case, **check_flash_bwd_plan(
            torch, ops, q, k, v, do, True, case)})
        del q, k, v, do, out, lse, rep, qg
        torch.cuda.empty_cache()
    emit({"phase": "kernels", "check": "flash backward workspace and "
          "tickets of ref.flash_bwd_plan against the kernel", "cases": plans})
    return results


def flash_train_other_shapes(torch, np):
    """The training kernels at FLASH_TRAIN_SHAPES (head_dim 8-256, groups
    1-64, lengths off the tile, full attention with Sq != Sk), checked as
    the timed cases.  Not timed."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(12)
    worst_lse, worst, n_plan = 0.0, {}, 0
    for b, h, hkv, sq, sk, d, causal in FLASH_TRAIN_SHAPES:
        q, do = (torch.from_numpy(rng.standard_normal(
            (b, h, sq, d), dtype=np.float32)).to(DEVICE) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (b, hkv, sk, d), dtype=np.float32)).to(DEVICE) for _ in range(2))
        lse_err, per = check_flash_train(
            torch, ops, q, k, v, do, causal,
            f"flash train B={b} H={h} Hkv={hkv} Sq={sq} Sk={sk} D={d} "
            f"causal={causal}")
        if ops.ref.flash_bwd_mma(d, h // hkv):
            check_flash_bwd_plan(torch, ops, q, k, v, do, causal,
                                 f"flash train plan B={b} H={h} Hkv={hkv} "
                                 f"Sq={sq} Sk={sk} D={d} causal={causal}")
            n_plan += 1
        worst_lse = max(worst_lse, lse_err)
        for name, r in per.items():
            w = worst.setdefault(name, {})
            for key in ("err_vs_plain", "err_over_limit", "err_vs_float64",
                        "plain_err_vs_float64"):
                w[key] = max(w.get(key, 0.0), r[key])
    emit({"phase": "kernels", "check": "flash training kernels at other "
          "shapes", "shapes": FLASH_TRAIN_SHAPES, "lse_max_abs_err": worst_lse,
          "bwd_worst": worst,
          "tolerance": {"lse": LSE_TOL, "bwd": f"{BWD_TOL} x max(1, "
                        "max|plain|) against the plain version, and x max(1, "
                        "max|float64|) against float64 autograd"},
          "deterministic": True, "plan_checked_shapes": n_plan})


def wkv_cases(torch, np, flush):
    """The wkv scan at rwkv6-3b's prefill shape against its plain
    version."""
    from repro_torch.kernels import ops

    results = []
    rng = np.random.default_rng(7)
    b, s, h, dk, dv, chunk = (WKV[k] for k in ("batch", "seq", "heads", "dk",
                                               "dv", "chunk"))

    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).to(DEVICE)
    r, k = (dev(rng.standard_normal((b, s, h, dk))) for _ in range(2))
    v = dev(rng.standard_normal((b, s, h, dv)))
    logw = dev(-np.exp(rng.standard_normal((b, s, h, dk))))
    u = dev(rng.standard_normal((h, dk)))
    s0 = dev(rng.standard_normal((b, h, dk, dv)))

    def kernel():
        return ops.rwkv_scan(r, k, v, logw, u, s0, chunk=chunk)

    def plain():
        return ops.ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
    o_p, s_p = plain()
    o, s_t = kernel()
    torch.cuda.synchronize()
    errs = []
    for name, got, want in (("o", o, o_p), ("sT", s_t, s_p)):
        err = float((got - want).abs().max())
        lim = WKV_TOL * max(1.0, float(want.abs().max()))
        check(bool(torch.isfinite(got).all()), f"rwkv_scan {name}: finite")
        check(err <= lim, f"rwkv_scan {name}: max_abs_err {err} > {lim}")
        errs.append(err)
    kernel_line(
        results, "rwkv_scan_f32",
        f"B={b} S={s} H={h} dk={dk} dv={dv} chunk {chunk}, logw = "
        "-exp(N(0,1)), s0 ~ N(0,1) (rwkv6-3b prefill)", max(errs),
        time_ms(torch, kernel, flush),
        time_ms(torch, plain, flush, PLAIN_ITERS, 1),
        wkv_bound(b, s, h, dk, dv, chunk), None,
        "none: no single PyTorch call computes the wkv recurrence",
        DENSE_SOURCE["rwkv_scan_f32"],
        f"{WKV_TOL} x max(1, max|plain|) on o and sT")
    # both against the float64 per-token recurrence (a reading, no gate)
    exact = ops.ref.wkv_ref(*(x.double() for x in (r, k, v, logw, u, s0)))
    results[-1]["vs_float64"] = {
        name: {"kernel": float((g.double() - x).abs().max()),
               "plain": float((w.double() - x).abs().max())}
        for name, g, w, x in (("o", o, o_p, exact[0]),
                              ("sT", s_t, s_p, exact[1]))}
    emit({"phase": "kernels", "kernel": "rwkv_scan_f32",
          "vs_float64": results[-1]["vs_float64"]})
    del exact
    torch.cuda.empty_cache()
    return results


# (B, S, H, dk, dv, chunk, sigma): logw = -exp(N(0, sigma)); steps of 8
# and 16 tokens (chunks 8, 16, 64), dk != dv both ways, one (b, h) of one
# chunk, harsher decays, a chunk of 20 (steps of 10: the product's rows
# padded to 12), a 128 x 128 state (160 KB of shared memory), and tokens
# that do not decay (logw = 0 at every fifth token of the last case)
WKV_SHAPES = ((2, 128, 4, 64, 64, 8, 1.0), (2, 128, 4, 64, 64, 16, 1.0),
              (2, 256, 4, 64, 64, 64, 1.0), (2, 128, 3, 64, 32, 32, 1.0),
              (1, 96, 2, 32, 96, 32, 1.0), (1, 32, 1, 64, 64, 32, 1.0),
              (2, 128, 4, 64, 64, 32, 2.0), (1, 60, 2, 16, 16, 20, 1.0),
              (1, 64, 1, 128, 128, 32, 1.0), (2, 64, 2, 64, 64, 32, 1.0))


def wkv_other_shapes(torch, np):
    """The wkv scan at WKV_SHAPES within 1e-4 x max(1, max |plain|) of
    its plain version on o and sT; at the harsher decays (sigma 2), where
    the plain version's own f32 error against the float64 per-token
    recurrence exceeds that limit, no farther from the float64 recurrence
    than the plain version is (or within the limit).  Not timed."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(11)
    worst, harsh = 0.0, []
    for i, (b, s, h, dk, dv, chunk, sigma) in enumerate(WKV_SHAPES):
        def dev(x):
            return torch.from_numpy(x.astype(np.float32)).to(DEVICE)
        r, k = (dev(rng.standard_normal((b, s, h, dk))) for _ in range(2))
        v = dev(rng.standard_normal((b, s, h, dv)))
        lw = -np.exp(sigma * rng.standard_normal((b, s, h, dk)))
        if i == len(WKV_SHAPES) - 1:
            lw[:, ::5] = 0.0
        logw = dev(lw)
        u = dev(rng.standard_normal((h, dk)))
        s0 = dev(rng.standard_normal((b, h, dk, dv)))
        got = ops.rwkv_scan(r, k, v, logw, u, s0, chunk=chunk)
        torch.cuda.synchronize()
        want = ops.ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
        exact = (ops.ref.wkv_ref(*(x.double() for x in (r, k, v, logw, u,
                                                        s0)))
                 if sigma > 1 else (None, None))
        what = (f"rwkv_scan B={b} S={s} H={h} dk={dk} dv={dv} chunk "
                f"{chunk} sigma {sigma}")
        for name, g, w, x in zip(("o", "sT"), got, want, exact):
            err = float((g - w).abs().max())
            lim = WKV_TOL * max(1.0, float(w.abs().max()))
            check(bool(torch.isfinite(g).all()), f"{what}: {name} finite")
            if x is None:
                check(err <= lim, f"{what}: {name} max_abs_err {err} > {lim}")
                worst = max(worst, err / lim)
                continue
            k_err = float((g.double() - x).abs().max())
            p_err = float((w.double() - x).abs().max())
            check(err <= lim or k_err <= p_err,
                  f"{what}: {name} max_abs_err {err} > {lim} and "
                  f"{k_err} from the float64 recurrence > the plain "
                  f"version's {p_err}")
            harsh.append({"case": what, "out": name, "vs_plain": err,
                          "limit": lim, "kernel_vs_float64": k_err,
                          "plain_vs_float64": p_err})
    emit({"phase": "kernels", "check": "wkv scan at other shapes",
          "shapes_b_s_h_dk_dv_chunk_sigma": WKV_SHAPES,
          "worst_err_over_limit": worst, "harsh_decays": harsh,
          "tolerance": f"{WKV_TOL} x max(1, max|plain|)"})


# the wkv training kernels at rwkv6-3b's train microbatch (4 x 512, grad-
# accum 2 of 8 x 512) and at 8 x 512
WKV_TRAIN_BATCHES = (4, 8)
WKV_GRADS = ("dr", "dk", "dv", "dlogw", "du", "ds0")


def wkv_bwd_ops_per_step(step, dk, dv):
    """f32 operations of one step of one (batch, head) in the backward's
    chunk form: dV = A^T dO (lower triangle) + k~ G; dO S0^T, V G^T, r~^T
    dO and G's decay; the scores and dP of the pairs s <= t; the pair
    sums of dr' and dk' (sub, exp, multiply, two FMAs a key dim); the
    cumulative sums, r~ and k~, the column pass and rowsum(S0 * G)."""
    pairs = step * (step - 1) // 2
    return (step * (step + 1) * dv + 2 * step * dk * dv +
            6 * step * dk * dv + 2 * dk * dv +
            4 * pairs * dk + 3 * step * dk + 2 * (pairs + step) * dv +
            6 * pairs * dk + 13 * step * dk + 2 * dk * dv)


def wkv_bwd_bound(b, s, h, dk, dv, step):
    """The backward as a function: r, k, v, logw, do, u, s0 and dsT in,
    dr, dk, dv, dlogw, du and ds0 out, each once (not the step states the
    forward's states variant saves for it: printed apart), against the
    operations of its steps."""
    n_bytes = 4 * (6 * b * s * h * dk + 3 * b * s * h * dv + 2 * h * dk +
                   3 * b * h * dk * dv)
    return bytes_bound(n_bytes, b * h * (s // step) *
                       wkv_bwd_ops_per_step(step, dk, dv))


def wkv_train_inputs(torch, np, rng, b, s, h, dk, dv, sigma=1.0):
    """(r, k, v, logw, u, s0, do, dsT) on the card, f32, logw =
    -exp(N(0, sigma))."""
    def dev(x):
        return torch.from_numpy(x.astype(np.float32)).to(DEVICE)
    r, k = (dev(rng.standard_normal((b, s, h, dk))) for _ in range(2))
    v = dev(rng.standard_normal((b, s, h, dv)))
    logw = dev(-np.exp(sigma * rng.standard_normal((b, s, h, dk))))
    u = dev(rng.standard_normal((h, dk)))
    s0 = dev(rng.standard_normal((b, h, dk, dv)))
    do = dev(rng.standard_normal((b, s, h, dv)))
    dsT = dev(rng.standard_normal((b, h, dk, dv)))
    return r, k, v, logw, u, s0, do, dsT


def check_wkv_train(torch, ops, args, chunk, what, harsh=False):
    """The states variant and the backward on ``args`` against their plain
    versions: o and sT bit-equal to ``rwkv_scan``'s, the states and every
    gradient within WKV_TOL x max(1, max |plain|) (at harsh decays, or no
    farther from float64 autograd than the plain backward), the backward
    bit-equal over two runs.  Returns ({name: err}, states, sT, the
    harsh-decay readings)."""
    r, k, v, logw, u, s0, do, dsT = args
    o1, s1 = ops.rwkv_scan(r, k, v, logw, u, s0, chunk=chunk)
    o2, s2, states = ops.rwkv_scan_states(r, k, v, logw, u, s0, chunk=chunk)
    torch.cuda.synchronize()
    check(torch.equal(o1, o2) and torch.equal(s1, s2),
          f"{what}: the states variant's o/sT differ from rwkv_scan's")
    step = ops.ref.wkv_step_tokens(min(chunk, r.shape[1]))
    want_st = ops.ref.wkv_states_ref(k, v, logw, s0, step)
    errs = {"states": float((states - want_st).abs().max())}
    lim = WKV_TOL * max(1.0, float(want_st.abs().max()))
    check(errs["states"] <= lim or harsh,
          f"{what}: states max_abs_err {errs['states']} > {lim}")
    del want_st
    got = ops.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s2, do, dsT,
                            chunk=chunk)
    again = ops.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s2, do, dsT,
                              chunk=chunk)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two backward runs differ")
    want = ops.ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                       chunk=chunk)
    exact = (ops.ref.wkv_chunked_bwd_ref(*(x.double() for x in args),
                                         chunk=chunk)
             if harsh else [None] * 6)
    readings = []
    for name, g, w, x in zip(WKV_GRADS, got, want, exact):
        check(bool(torch.isfinite(g).all()), f"{what}: {name} finite")
        err = float((g - w).abs().max())
        lim = WKV_TOL * max(1.0, float(w.abs().max()))
        errs[name] = err
        if x is None:
            check(err <= lim, f"{what}: {name} max_abs_err {err} > {lim}")
            continue
        k_err = float((g.double() - x).abs().max())
        p_err = float((w.double() - x).abs().max())
        check(err <= lim or k_err <= p_err,
              f"{what}: {name} max_abs_err {err} > {lim} and {k_err} from "
              f"float64 > the plain version's {p_err}")
        readings.append({"case": what, "out": name, "vs_plain": err,
                         "limit": lim, "kernel_vs_float64": k_err,
                         "plain_vs_float64": p_err})
    return errs, states, s2, readings


def wkv_train_cases(torch, np, flush):
    """The wkv training kernels at rwkv6-3b's shapes (B = 4, the train
    microbatch, and 8; S = 512, H = 40, dk = dv = 64, chunk 32), each
    against its plain version and timed beside its bound: the forward's
    states variant, and the backward, also against float64 autograd (a
    reading) and bit-equal over two runs."""
    from repro_torch.kernels import ops

    results = []
    rng = np.random.default_rng(13)
    s, h, dk, dv, chunk = (WKV[k] for k in ("seq", "heads", "dk", "dv",
                                            "chunk"))
    step = ops.ref.wkv_step_tokens(chunk)
    for b in WKV_TRAIN_BATCHES:
        args = wkv_train_inputs(torch, np, rng, b, s, h, dk, dv)
        r, k, v, logw, u, s0, do, dsT = args
        case = (f"B={b} S={s} H={h} dk={dk} dv={dv} chunk {chunk} (step "
                f"{step}), logw = -exp(N(0,1)), s0, do, dsT ~ N(0,1) "
                f"(rwkv6-3b {'train microbatch' if b == 4 else 'prefill'})")
        errs, states, s_t, _ = check_wkv_train(torch, ops, args, chunk,
                                               f"wkv train B={b}")

        def fwd():
            return ops.rwkv_scan_states(r, k, v, logw, u, s0, chunk=chunk)

        def fwd_plain():
            o = ops.ref.wkv_chunked_ref(r, k, v, logw, u, s0, chunk=chunk)
            return o, ops.ref.wkv_states_ref(k, v, logw, s0, step)
        state_bytes = 4 * b * h * (s // step) * dk * dv
        fwd_bound = wkv_bound(b, s, h, dk, dv, chunk)
        kernel_line(
            results, "rwkv_scan_states_f32", case, errs["states"],
            time_ms(torch, fwd, flush), time_ms(torch, fwd_plain, flush,
                                                PLAIN_ITERS, 1),
            (fwd_bound[0] + state_bytes / HBM_BYTES_PER_S * 1e3,
             fwd_bound[1]), None,
            "none: no single PyTorch call computes the wkv recurrence",
            DENSE_SOURCE["rwkv_scan_states_f32"],
            f"o, sT bit-equal to rwkv_scan_f32; states {WKV_TOL} x max(1, "
            "max|plain|)")

        def bwd():
            return ops.rwkv_scan_bwd(r, k, v, logw, u, s0, states, s_t, do,
                                     dsT, chunk=chunk)

        def bwd_plain():
            return ops.ref.wkv_chunked_bwd_ref(r, k, v, logw, u, s0, do, dsT,
                                               chunk=chunk)
        kernel_line(
            results, "rwkv_scan_bwd_f32", case,
            max(errs[n] for n in WKV_GRADS), time_ms(torch, bwd, flush),
            time_ms(torch, bwd_plain, flush, PLAIN_ITERS, 1),
            wkv_bwd_bound(b, s, h, dk, dv, step), None,
            "none: no single PyTorch call computes the wkv backward",
            DENSE_SOURCE["rwkv_scan_bwd_f32"],
            f"{WKV_TOL} x max(1, max|plain|) on each gradient")
        results[-1]["errors"] = errs
        results[-1]["states_bytes"] = state_bytes
        results[-1]["deterministic"] = True
        # the design's scratch beyond the function's own bytes, from the
        # shapes: the forward's step states read once, the gradient states
        # (one a step but the last) written and read once, all as if from
        # DRAM (some are served by L2); a note, not a kernels-line figure
        emit({"phase": "kernels", "kernel": "rwkv_scan_bwd_f32",
              "case": case,
              "note": "scratch computed from shapes, not measured",
              "scratch_bytes": {
                  "forward_states_read": state_bytes,
                  "gradient_states_written_and_read":
                      2 * state_bytes * (s // step - 1) // (s // step)}})
        if b == WKV_TRAIN_BATCHES[0]:
            got = bwd()
            want = bwd_plain()
            exact = ops.ref.wkv_chunked_bwd_ref(*(x.double() for x in args),
                                                chunk=chunk)
            results[-1]["vs_float64"] = {
                name: {"kernel": float((g.double() - x).abs().max()),
                       "plain": float((w.double() - x).abs().max())}
                for name, g, w, x in zip(WKV_GRADS, got, want, exact)}
            emit({"phase": "kernels", "kernel": "rwkv_scan_bwd_f32",
                  "case": case, "vs_float64": results[-1]["vs_float64"]})
            del got, want, exact
        del args, r, k, v, logw, u, s0, do, dsT, states, s_t
        torch.cuda.empty_cache()
    return results


def wkv_train_other_shapes(torch, np):
    """The states variant and the backward at WKV_SHAPES (steps of 8-16
    tokens, dk != dv, a step of 10, a 128 x 128 state, undecayed
    tokens, harsh decays held to float64), each bit-equal over two runs.
    Not timed."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(17)
    worst, harsh = 0.0, []
    for i, (b, s, h, dk, dv, chunk, sigma) in enumerate(WKV_SHAPES):
        args = wkv_train_inputs(torch, np, rng, b, s, h, dk, dv, sigma)
        if i == len(WKV_SHAPES) - 1:
            args[3][:, ::5] = 0.0
        what = (f"wkv train B={b} S={s} H={h} dk={dk} dv={dv} chunk "
                f"{chunk} sigma {sigma}")
        errs, _, _, readings = check_wkv_train(torch, ops, args, chunk, what,
                                               harsh=sigma > 1)
        harsh += readings
        if sigma <= 1:
            worst = max(worst, max(errs.values()))
    emit({"phase": "kernels", "check": "wkv training kernels at other "
          "shapes", "shapes_b_s_h_dk_dv_chunk_sigma": WKV_SHAPES,
          "worst_max_abs_err": worst, "harsh_decays": harsh,
          "tolerance": f"{WKV_TOL} x max(1, max|plain|); o/sT of the "
          "states variant bit-equal to rwkv_scan_f32"})


@contextlib.contextmanager
def plain_kernels(ops):
    """The same path with the flash and wkv kernels' plain versions on
    the card (the wrappers launch their kernels for every CUDA tensor);
    training attention and the training wkv scan differentiate the plain
    forwards by autograd."""
    saved = (ops.flash_attention, ops.rwkv_scan, ops.flash_attention_with_grad,
             ops.rwkv_scan_with_grad)
    ops.flash_attention = ops.ref.flash_attention_ref
    ops.rwkv_scan = ops.ref.wkv_chunked_ref
    ops.flash_attention_with_grad = ops.ref.flash_attention_ref
    ops.rwkv_scan_with_grad = ops.ref.wkv_chunked_ref
    try:
        yield
    finally:
        (ops.flash_attention, ops.rwkv_scan, ops.flash_attention_with_grad,
         ops.rwkv_scan_with_grad) = saved


def dense_run(torch, prefill, decode, params, prompts, gen):
    """The launcher's default path: one prefill of every prompt (f32
    cache), a transformer's cache padded to prompt_len + gen, then
    gen - 1 greedy decode steps: gen tokens a request."""
    import torch.nn.functional as F
    n_req, prompt_len = prompts.shape
    tokens = torch.from_numpy(prompts).long().to(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    logits, cache = prefill(params, {"tokens": tokens},
                            cache_dtype=torch.float32)
    cur = logits.argmax(-1)
    picks = [cur.cpu()]                    # the first token is on the host
    prefill_s = time.monotonic() - t0
    if "k" in cache:
        pad = prompt_len + gen - cache["k"].shape[-2]
        cache["k"] = F.pad(cache["k"], (0, 0, 0, pad))
        cache["v"] = F.pad(cache["v"], (0, 0, 0, pad))
    t1 = time.monotonic()
    step1 = None
    for _ in range(gen - 1):
        step_logits, cache = decode(params, cache, cur)
        if step1 is None:
            step1 = step_logits.clone()
        cur = step_logits.argmax(-1)
        picks.append(cur)
    toks = torch.stack([p.to(DEVICE) for p in picks], dim=1).cpu()
    decode_s = time.monotonic() - t1
    return {"prefill_logits": logits, "step1_logits": step1,
            "tokens": toks, "cache": cache, "last": cur,
            "stats": {"prefill_s": prefill_s, "ttft_s": prefill_s,
                      "prefill_tok_s": n_req * prompt_len / prefill_s,
                      "decode_s": decode_s,
                      "decode_tok_s": n_req * (gen - 1) / decode_s,
                      "peak_memory_gb":
                          torch.cuda.max_memory_allocated() / 1e9}}


def dense_model(torch, ops, name, model, params, prompts, gen):
    """One model through the dense path: launch counts of the kernel run,
    the plain run on the card, the gates between them, a profile."""
    from repro_torch.runtime.serve import make_serving_fns
    cfg = model.cfg
    prefill, decode = make_serving_fns(model)
    ops.reset_launch_counts()
    run = dense_run(torch, prefill, decode, params, prompts, gen)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    with plain_kernels(ops):
        ref = dense_run(torch, prefill, decode, params, prompts, gen)
    out = {"arch": cfg.name, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "params": sum(t.numel() for t in _leaves(params)),
           "requests": prompts.shape[0], "prompt_len": prompts.shape[1],
           "gen": gen, **run["stats"],
           "plain_run": ref["stats"], "launches": counts}
    for key in ("prefill_logits", "step1_logits"):
        got = run[key]
        check(tuple(got.shape) == (prompts.shape[0], cfg.vocab_size) and
              bool(torch.isfinite(got).all()), f"{name} {key}: shape, finite")
        err = float((got - ref[key]).abs().max())
        check(err <= LOGITS_TOL, f"{name} {key} vs the plain kernels: "
              f"{err} > {LOGITS_TOL}")
        out[f"{key}_max_abs_err_vs_plain"] = err
    check(torch.equal(run["tokens"], ref["tokens"]),
          f"{name}: greedy tokens differ from the plain kernels' run")
    check(bool(((run["tokens"] >= 0) & (run["tokens"] < cfg.vocab_size))
               .all()), f"{name}: token range")
    out["tokens_identical_to_plain"] = True
    out["tokens_request0"] = run["tokens"][0].tolist()
    del ref
    # one prefill, then a few decode steps on its cache, under the profiler
    tokens = torch.from_numpy(prompts).long().to(DEVICE)
    n_prof = DENSE["profile_steps"]
    state = {}

    def prefill_once():
        state["logits"], state["cache"] = prefill(
            params, {"tokens": tokens}, cache_dtype=torch.float32)

    def steps():
        import torch.nn.functional as F
        cache, cur = state["cache"], state["logits"].argmax(-1)
        if "k" in cache:
            cache["k"] = F.pad(cache["k"], (0, 0, 0, n_prof))
            cache["v"] = F.pad(cache["v"], (0, 0, 0, n_prof))
        torch.cuda.synchronize()
        for _ in range(n_prof):
            logits, cache = decode(params, cache, cur)
            cur = logits.argmax(-1)
    out["profile_prefill"] = profile_calls(torch, prefill_once, 1)
    out["profile_decode_step"] = profile_calls(torch, steps, n_prof)
    return out, counts, run


def phase_dense(torch, np, smi, served):
    """The launcher's default path at full width: granite-3-2b (the serve
    phase's params and prompts), then rwkv6-3b; ``served`` is emptied so
    that granite's weights are freed before rwkv6-3b's are made."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model

    t_phase = time.monotonic()
    gen = DENSE["gen"]
    cfg = served["cfg"]
    granite, g_counts, run = dense_model(
        torch, ops, "granite", served["model"], served["params"],
        served["prompts"], gen)
    check(g_counts["flash_attention_f32"] == cfg.n_layers,
          f"flash_attention_f32 launched {g_counts['flash_attention_f32']} "
          f"times in one granite prefill, not {cfg.n_layers}")
    # the paged serve phase's first decode step on the same prompts
    seqs, paged_logits = served["paged_first_step"]
    order = torch.tensor(seqs, device=run["step1_logits"].device)
    err = float((run["step1_logits"][order] - paged_logits).abs().max())
    check(err <= LOGITS_TOL, f"granite dense vs paged first decode step: "
          f"{err} > {LOGITS_TOL}")
    # the paged run's tokens start after the admission token, which is
    # the dense run's first
    paged = served["tokens_h1"]
    pairs = [(a, b) for i in range(len(seqs))
             for a, b in zip(run["tokens"][i, 1:].tolist(), paged[i])]
    granite["step1_logits_max_abs_err_vs_paged"] = err
    granite["tokens_equal_to_paged"] = sum(a == b for a, b in pairs)
    granite["tokens_compared_to_paged"] = len(pairs)
    del run
    served.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    phi3, p_counts = dense_phi3(torch, np, ops)
    rcfg = get_arch(DENSE["rwkv_arch"])
    if DENSE["rwkv_reduced"]:
        rcfg = rcfg.reduced()
    model = get_model(rcfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    prompts = np.random.default_rng(5).integers(
        0, rcfg.vocab_size, (DENSE["requests"], DENSE["prompt_len"]),
        dtype=np.int32)
    rwkv, r_counts, run = dense_model(torch, ops, "rwkv6", model, params,
                                      prompts, gen)
    rwkv["init_s"] = init_s
    rwkv["weights_gb"] = rwkv["params"] * 4 / 1e9
    check(r_counts["rwkv_scan_f32"] == rcfg.n_layers,
          f"rwkv_scan_f32 launched {r_counts['rwkv_scan_f32']} times in "
          f"one rwkv6 prefill, not {rcfg.n_layers}")
    del run, params
    torch.cuda.empty_cache()
    counts = {k: g_counts[k] + p_counts[k] + r_counts[k] for k in g_counts}
    emit({"phase": "dense", "granite": granite, "phi3_mini": phi3,
          "rwkv6": rwkv,
          "launches": counts, "logits_tol": LOGITS_TOL,
          "phase_s": time.monotonic() - t_phase,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    return counts


def dense_phi3(torch, np, ops):
    """phi3-mini-3.8b (head_dim 96) at full width, depth cut, through the
    dense path: one flash launch a layer, tokens equal to the plain
    kernels' run."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    from repro_torch.models.api import get_model

    cfg = get_arch(PHI3["arch"])
    cfg = cfg.reduced() if PHI3["reduced"] else dataclasses.replace(
        cfg, n_layers=PHI3["layers"])
    model = get_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    prompts = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (DENSE["requests"], DENSE["prompt_len"]),
        dtype=np.int32)
    out, counts, run = dense_model(torch, ops, "phi3-mini", model, params,
                                   prompts, PHI3["gen"])
    check(counts["flash_attention_f32"] == cfg.n_layers,
          f"flash_attention_f32 launched {counts['flash_attention_f32']} "
          f"times in one phi3-mini prefill, not {cfg.n_layers}")
    out["head_dim"] = cfg.hd
    out["depth_cut_from"] = get_arch(PHI3["arch"]).n_layers
    del run, params
    torch.cuda.empty_cache()
    return out, counts


# -- serve --------------------------------------------------------------------


def phase_serve(torch, np, smi):
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serve import PagedServer

    dev = torch.device(DEVICE)
    cfg = get_arch(SERVE["arch"])
    if SERVE["reduced"]:
        cfg = cfg.reduced()
    n_req, prompt_len, gen, q_gen, chunk, page, hbm_pages = (
        SERVE[k] for k in ("requests", "prompt_len", "gen", "q8_gen",
                           "chunk", "page", "hbm_pages"))
    model = get_model(cfg)
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (n_req, prompt_len), dtype=np.int32)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()

    def admit(server):
        t_start = time.monotonic()
        ttft = []
        for i, p in enumerate(prompts):
            server.add_request(i, p, chunk=chunk)   # ends in a host argmax
            ttft.append(time.monotonic() - t_start)
        return {"prefill_s": ttft[-1],
                "prefill_tok_s": n_req * prompt_len / ttft[-1],
                "ttft_first_s": ttft[0],
                "ttft_mean_s": float(np.mean(ttft))}

    def decode(server, n, horizon):
        torch.cuda.synchronize()
        t_start = time.monotonic()
        out = server.decode(n, horizon=horizon)
        secs = time.monotonic() - t_start
        return out, {"decode_s": secs,
                     "decode_tok_s": sum(map(len, out.values())) / secs}

    runs = {}
    # horizon 1 (the launcher's per-token path), with the first decode
    # step held against the plain-attention eager reference
    server = PagedServer(model, params, page_size=page, hbm_pages=hbm_pages,
                         device=dev)
    runs["h1"] = admit(server)
    pending = server.pending_tokens()
    ref_logits = server.step_reference(pending)
    seqs, logits = server.step_batch(pending)
    check(tuple(logits.shape) == (n_req, cfg.vocab_size), "logits shape")
    check(bool(torch.isfinite(logits).all()), "finite logits")
    logits_err = float((logits - ref_logits).abs().max())
    check(logits_err <= LOGITS_TOL,
          f"step_batch vs step_reference {logits_err} > {LOGITS_TOL}")
    first = logits.argmax(dim=-1).cpu().tolist()
    for s, tok in zip(seqs, first):
        server.set_pending(s, tok)
    rest, stats = decode(server, gen - 1, None)
    runs["h1"].update(stats)
    tokens_h1 = {s: [first[i]] + rest[s] for i, s in enumerate(seqs)}
    runs["h1"]["tier"] = server.tier_stats()
    profile = profile_decode(torch, server, 4)
    del server

    server = PagedServer(model, params, page_size=page, hbm_pages=hbm_pages,
                         device=dev)
    runs["h8"] = admit(server)
    tokens_h8, stats = decode(server, gen, 8)
    runs["h8"].update(stats)
    runs["h8"]["tier"] = server.tier_stats()
    del server
    check(tokens_h1 == tokens_h8, "greedy tokens identical at horizon 1 "
          "and horizon 8")
    check(all(len(t) == gen and all(0 <= x < cfg.vocab_size for x in t)
              for t in tokens_h8.values()), "token count and range")

    for code in ("int8", "fp8"):
        server = PagedServer(model, params, page_size=page,
                             hbm_pages=hbm_pages, page_dtype=code, device=dev)
        runs[code] = admit(server)
        toks, stats = decode(server, q_gen, 8)
        runs[code].update(stats)
        runs[code]["agree_with_f32"] = float(np.mean(
            [a == b for s in toks for a, b in zip(toks[s], tokens_h8[s])]))
        del server
    torch.cuda.synchronize()
    counts = ops.launch_counts()

    # every prefill chunk of every layer through the chunk form, every
    # decode step's layers through the decode form (f32: the horizon-1
    # and horizon-8 servers; int8 and fp8: one server each)
    n_chunks = n_req * (-(-prompt_len // chunk))
    need = {}
    for code, servers, steps in (("f32", 2, 2 * gen), ("int8", 1, q_gen),
                                 ("fp8", 1, q_gen)):
        need[CHUNK_OF[code]] = cfg.n_layers * servers * n_chunks
        need[DECODE_OF[code]] = cfg.n_layers * steps
        check(counts[CHUNK_OF[code]] == need[CHUNK_OF[code]],
              f"{CHUNK_OF[code]} launches {counts[CHUNK_OF[code]]} != "
              f"{need[CHUNK_OF[code]]} (one per layer and prefill chunk)")
        check(counts[DECODE_OF[code]] >= need[DECODE_OF[code]],
              f"{DECODE_OF[code]} launches {counts[DECODE_OF[code]]} < "
              f"{need[DECODE_OF[code]]} (one per layer and decode step)")
    n_decode = sum(counts[DECODE_OF[c]] for c in DECODE_OF)
    check(counts[COMBINE] == n_decode,
          f"{COMBINE} launches {counts[COMBINE]} != {n_decode} (one per "
          f"decode-form launch)")
    emit({"phase": "serve", "arch": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads,
          "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.hd, "d_ff": cfg.d_ff,
          "vocab": cfg.vocab_size, "params": n_params,
          "weights_gb": n_params * 4 / 1e9, "init_s": init_s,
          "requests": n_req, "prompt_len": prompt_len, "gen": gen,
          "q8_gen": q_gen, "prefill_chunk": chunk, "page_size": page,
          "hbm_pages": hbm_pages, "runs": runs, "profile_h1": profile,
          "tokens_identical_h1_h8": True,
          "tokens_request0": tokens_h8[0],
          "first_step_logits_max_abs_err": logits_err,
          "logits_tol": LOGITS_TOL, "launches": counts,
          "launches_needed": need,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    served = {"cfg": cfg, "model": model, "params": params,
              "prompts": prompts, "paged_first_step": (seqs, logits),
              "tokens_h1": tokens_h1}
    return counts, served


# the serve_spec phase: the serve phase's granite-3-2b, its first four
# prompts and four that repeat a seeded 16-token phrase 32 times (512
# tokens), 64 tokens each, horizon 8; sampling at temperature 0.8, top-p
# 0.9, seed 0 (and 0.05 for a pass whose drafts land); the batcher serves
# these 8 and 8 more of the two kinds
SERVE_SPEC = {"phrase": 16, "repeats": 32, "horizon": 8, "max_active": 8,
              "temperature": 0.8, "top_p": 0.9, "seed": 0,
              "cold_temperature": 0.05}


def spec_prompts(np, random_prompts, first_seed, vocab):
    """Four of ``random_prompts`` and four phrases of SERVE_SPEC["phrase"]
    tokens (numpy seeds ``first_seed``..+3), each repeated
    SERVE_SPEC["repeats"] times."""
    phrases = [np.tile(np.random.default_rng(first_seed + i).integers(
        0, vocab, SERVE_SPEC["phrase"], dtype=np.int32),
        SERVE_SPEC["repeats"]) for i in range(4)]
    return list(random_prompts[:4]) + phrases


def record_gaps(server):
    """Observe ``server.token_scores``: for every selection its device
    steps make, keep each row's gap between its two largest scores
    (logits when greedy, lp + g when sampled).  Returns the list the
    gaps [B] land in, one entry a decode step."""
    gaps = []
    inner = server.token_scores

    def scores(logits, *args):
        out = inner(logits, *args)
        top = out.topk(2, dim=-1).values
        gaps.append(top[..., 0] - top[..., 1])
        return out
    server.token_scores = scores
    return gaps


def first_divergences(torch, name, rids, want, got, gaps, first_gaps=None,
                      phase="serve_spec"):
    """The near-tie rule for two streams the reference holds identical:
    where ``got[rid]`` differs from ``want[rid]`` (the per-token run's),
    print the first position that differs and the gap there between the
    two largest scores of the per-token run; a divergence passes only at
    a gap below LOGITS_TOL.  ``gaps``: the per-token run's record (its
    t-th decode step, slot = the rid's index in ``rids``); with
    ``first_gaps`` ({rid: gap}) the streams begin with the token drawn
    after prefill and decode step t is position t + 1.  Returns the
    divergences."""
    steps = torch.stack(gaps).cpu() if gaps else None
    offset = 0 if first_gaps is None else 1
    found = []
    for slot, rid in enumerate(rids):
        a, b = want[rid], got[rid]
        if a == b:
            continue
        pos = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   min(len(a), len(b)))
        gap = None
        if pos < min(len(a), len(b)):
            if pos < offset:
                gap = first_gaps[rid]
            elif steps is not None and pos - offset < steps.shape[0]:
                gap = float(steps[pos - offset, slot])
        found.append({"run": name, "rid": rid, "position": pos,
                      "per_token": a[pos:pos + 1], "got": b[pos:pos + 1],
                      "top2_gap": gap})
        emit({"phase": phase, "divergence": found[-1],
              "limit": LOGITS_TOL})
        check(gap is not None and gap < LOGITS_TOL,
              f"{name}: request {rid} leaves the per-token stream at "
              f"position {pos}, where its two largest scores are {gap} "
              f"apart: not a near-tie below {LOGITS_TOL}")
    return found


def profile_spec(torch, server, cold, hot, horizon):
    """Where a speculative verify pass (cold sampler, drafts that land;
    the gate reopened first) and a sampled decode step (``hot``, one
    fused step) spend their time, under ``torch.profiler``: 2 of each
    on ``server``'s live sequences, which have room for them."""
    seqs = server.sequence_ids()
    verify = []

    def run(batch_fn, budget, sampling):
        got = batch_fn(server.pending_tokens(), {s: budget for s in seqs},
                       budget, sampling=sampling)
        for s, toks in got.items():
            server.set_pending(s, toks[-1])

    def passes():
        for _ in range(2):
            server.reset_speculation_stats()
            run(server.spec_horizon_batch, horizon, cold)
            verify.append(server.speculation_stats()["passes"])

    def steps():
        for _ in range(2):
            run(server.horizon_batch, 1, hot)
    out = {"verify_pass": profile_calls(torch, passes, 2)}
    out["verify_pass"]["verify_passes"] = sum(verify)
    out["sampled_step"] = profile_calls(torch, steps, 2)
    return out


def phase_serve_spec(torch, np, smi, served):
    """Sampled and speculative paged serving, and the continuous batcher,
    on the serve phase's full-width granite-3-2b; launch counters reset
    just before and read just after.  Every stream the reference holds
    identical to the per-token one is compared by the near-tie rule
    (``first_divergences``); sampled h1 and h8 must be identical."""
    from repro_torch.kernels import ops
    from repro_torch.runtime import serve as srv
    from repro_torch.runtime.prng import prng_key
    from repro_torch.runtime.scheduler import ContinuousBatcher, Request

    cfg, model, params = served["cfg"], served["model"], served["params"]
    gen, q_gen, chunk, page, hbm, plen = (SERVE[k] for k in (
        "gen", "q8_gen", "chunk", "page", "hbm_pages", "prompt_len"))
    hzn = SERVE_SPEC["horizon"]
    sc = srv.SamplingConfig(SERVE_SPEC["temperature"], SERVE_SPEC["top_p"],
                            SERVE_SPEC["seed"])
    cold = srv.SamplingConfig(SERVE_SPEC["cold_temperature"],
                              SERVE_SPEC["top_p"], SERVE_SPEC["seed"])
    batch1 = spec_prompts(np, served["prompts"], 100, cfg.vocab_size)
    batch2 = spec_prompts(np, np.random.default_rng(1).integers(
        0, cfg.vocab_size, (4, plen), dtype=np.int32), 200, cfg.vocab_size)
    rids1, rids2 = list(range(8)), list(range(8, 16))
    key = prng_key(sc.seed, DEVICE)
    runs, divergences = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_phase = time.monotonic()

    def admit(prompts, rids, sampling=None, page_dtype="fp32"):
        """A server with ``prompts`` admitted (chunks of SERVE["chunk"]);
        with ``sampling``, each pending token is drawn by sampled_token
        from the prompt's last logits.  Returns (server, {rid: first
        token}, {rid: its top-2 gap})."""
        server = srv.PagedServer(model, params, page_size=page,
                                 hbm_pages=hbm, page_dtype=page_dtype,
                                 device=DEVICE)
        first, first_gaps = {}, {}
        for rid, prompt in zip(rids, prompts):
            last = server.add_request(rid, prompt, chunk=chunk)
            if sampling is not None:
                first[rid] = srv.sampled_token(last, sampling, rid,
                                               len(prompt))
                server.set_pending(rid, first[rid])
                top = srv.token_scores(last, sampling, key, rid,
                                       len(prompt)).topk(2).values
                first_gaps[rid] = float(top[0] - top[1])
        return server, first, first_gaps

    def decode(server, name, n, first=None, **kw):
        """One timed decode call; the run's tok/s, launches and
        speculation telemetry go to ``runs[name]``.  Returns the streams
        (``first`` tokens prepended)."""
        torch.cuda.synchronize()
        before = ops.launch_counts()
        t0 = time.monotonic()
        out = server.decode(n, **kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        after = ops.launch_counts()
        runs[name] = {
            "decode_s": secs,
            "decode_tok_s": sum(map(len, out.values())) / secs,
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}
        if kw.get("speculative"):
            runs[name]["speculation"] = server.speculation_stats()
        emit({"phase": "serve_spec", "run": name, **runs[name]})
        if first:
            out = {r: [first[r]] + out[r] for r in out}
        check(all(0 <= t < cfg.vocab_size for v in out.values() for t in v)
              and all(len(v) == n + bool(first) for v in out.values()),
              f"{name}: token count and range")
        return out

    def verify_passes(name, code):
        st = runs[name]["speculation"]
        need = cfg.n_layers * st["passes"]
        got = runs[name]["launches"].get(DECODE_OF[code], 0)
        check(st["passes"] > 0 and got >= need,
              f"{name}: {st['passes']} verify passes, {got} "
              f"{DECODE_OF[code]} launches (>= {need} needed)")

    # greedy: the per-token run (scores recorded), then speculative H=8
    server = admit(batch1, rids1)[0]
    gaps = record_gaps(server)
    greedy_h1 = decode(server, "greedy_h1", gen)
    del server
    divergences += first_divergences(
        torch, "serve phase's h1 (its first four prompts)", rids1[:4],
        greedy_h1, served["tokens_h1"], gaps)
    server = admit(batch1, rids1)[0]
    greedy_spec = decode(server, "greedy_spec_h8", gen, horizon=hzn,
                         speculative=True)
    del server
    verify_passes("greedy_spec_h8", "f32")
    divergences += first_divergences(torch, "greedy speculative h8", rids1,
                                     greedy_h1, greedy_spec, gaps)

    # sampled: per-token (recorded), h8 (identical: same operations),
    # speculative h8
    server, first, first_gaps = admit(batch1, rids1, sc)
    gaps_s = record_gaps(server)
    sampled_h1 = decode(server, "sampled_h1", gen - 1, first, sampling=sc)
    del server
    server, first8, _ = admit(batch1, rids1, sc)
    sampled_h8 = decode(server, "sampled_h8", gen - 1, first8, horizon=hzn,
                        sampling=sc)
    del server
    check(not first_divergences(torch, "sampled h8", rids1, sampled_h1,
                                sampled_h8, gaps_s, first_gaps),
          "sampled tokens identical at horizon 1 and 8")
    server, first_sp, _ = admit(batch1, rids1, sc)
    sampled_spec = decode(server, "sampled_spec_h8", gen - 1, first_sp,
                          horizon=hzn, speculative=True, sampling=sc)
    del server
    divergences += first_divergences(torch, "sampled speculative h8", rids1,
                                     sampled_h1, sampled_spec, gaps_s,
                                     first_gaps)

    # a cold sampler (drafts land): speculative against the plain horizon
    # (h8 selects as h1 does, checked above), q8_gen tokens
    server, first_c, cold_gaps = admit(batch1, rids1, cold)
    gaps_c = record_gaps(server)
    cold_plain = decode(server, "cold_sampled_h8", q_gen - 1, first_c,
                        horizon=hzn, sampling=cold)
    del server
    server, first_cs, _ = admit(batch1, rids1, cold)
    cold_spec = decode(server, "cold_sampled_spec_h8", q_gen - 1, first_cs,
                       horizon=hzn, speculative=True, sampling=cold)
    profiles = profile_spec(torch, server, cold, sc, hzn)
    del server
    divergences += first_divergences(torch, "cold sampled speculative h8",
                                     rids1, cold_plain, cold_spec, gaps_c,
                                     cold_gaps)

    # int8 and fp8 pages: greedy speculative against the plain horizon
    for code in ("int8", "fp8"):
        server = admit(batch1, rids1, page_dtype=code)[0]
        gaps_q = record_gaps(server)
        plain = decode(server, f"{code}_greedy_h8", q_gen, horizon=hzn)
        del server
        server = admit(batch1, rids1, page_dtype=code)[0]
        spec = decode(server, f"{code}_greedy_spec_h8", q_gen, horizon=hzn,
                      speculative=True)
        del server
        verify_passes(f"{code}_greedy_spec_h8", code)
        divergences += first_divergences(
            torch, f"{code} greedy speculative h8", rids1, plain, spec,
            gaps_q)

    # the second batch's sampled streams (h8, recorded), then the batcher
    server, first2, first_gaps2 = admit(batch2, rids2, sc)
    gaps2 = record_gaps(server)
    sampled2 = decode(server, "sampled_h8_batch2", gen - 1, first2,
                      horizon=hzn, sampling=sc)
    del server
    server = srv.PagedServer(model, params, page_size=page, hbm_pages=hbm,
                             device=DEVICE)
    batcher = ContinuousBatcher(server, max_active=SERVE_SPEC["max_active"],
                                horizon=hzn, speculative=True, sampling=sc,
                                prefill_chunk=chunk)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    t0 = time.monotonic()
    for rid, prompt in zip(rids1 + rids2, batch1 + batch2):
        check(batcher.submit(Request(rid=rid, prompt=prompt,
                                     max_tokens=gen)), f"request {rid} taken")
    stats = batcher.run_to_completion()
    torch.cuda.synchronize()
    secs = time.monotonic() - t0
    after = ops.launch_counts()
    out = {r.rid: r.output for r in batcher.finished}
    check(stats["requests"] == 16 and not batcher.rejected,
          "the batcher finished every request")
    check(server.table.free_pages == server.hbm_pages,
          "the batcher's pages came back")
    runs["batcher"] = {
        "seconds": secs, "tok_s": sum(map(len, out.values())) / secs,
        **{k: stats[k] for k in stats if k != "tier"},
        "speculation": server.speculation_stats(),
        "launches": {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}}
    emit({"phase": "serve_spec", "run": "batcher", **runs["batcher"]})
    del server, batcher
    divergences += first_divergences(torch, "batcher (first batch)", rids1,
                                     sampled_h1, out, gaps_s, first_gaps)
    divergences += first_divergences(torch, "batcher (second batch)", rids2,
                                     sampled2, out, gaps2, first_gaps2)

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for code in ("f32", "int8", "fp8"):
        for name in (CHUNK_OF[code], DECODE_OF[code]):
            check(counts[name] > 0, f"{name} launched in serve_spec")
    n_decode = sum(counts[DECODE_OF[c]] for c in DECODE_OF)
    check(counts[COMBINE] == n_decode,
          f"{COMBINE} launches {counts[COMBINE]} != {n_decode}")
    emit({"phase": "serve_spec", "arch": cfg.name, "requests": 8,
          "batcher_requests": 16, "prompt_len": plen, "gen": gen,
          "q8_gen": q_gen, "horizon": hzn, "sampling": {
              "temperature": sc.temperature, "top_p": sc.top_p,
              "seed": sc.seed, "cold_temperature": cold.temperature},
          "seconds": time.monotonic() - t_phase,
          "runs": {k: {k2: v2 for k2, v2 in v.items() if k2 != "launches"}
                   for k, v in runs.items()},
          "profiles": profiles,
          "divergences": divergences, "divergence_limit": LOGITS_TOL,
          "sampled_h1_h8_identical": True, "launches": counts,
          "tokens_request4_greedy": greedy_h1[4],
          "tokens_request4_sampled": sampled_h1[4],
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return counts


# the serve_pool phase: the serve phase's weights and prompts through a
# PoolServer of N emulated DockerSSD nodes sharing the serve phase's
# 320-page store (320 / N pages a node), the h8 / speculative horizon;
# the router's runs on 4 nodes of 160 pages (room on the survivors for
# a killed or drained node's sequences), its failover kill after two
# steps, and the elastic bucket (4 nodes of 80 pages, 2 active: half
# the requests wait until a node joins)
SERVE_POOL = {"store_pages": 320, "horizon": 8, "kill_after": 2,
              "runs": ((4, "placed"), (4, "striped"), (2, "placed")),
              "router_node_pages": 160,
              "elastic": {"nodes": 4, "active": 2, "grow_to": 3,
                          "node_pages": 80}}


def phase_serve_pool(torch, np, smi, served):
    """Pool serving on the serve phase's full-width granite-3-2b through
    the port's entry points (PoolServer, StoragePool.attach_server,
    PoolRouter); launch counters reset just before and read just after.

    A 1-node pool equals PagedServer bit for bit (prefill logits and
    every step's logits, h1 and h8, f32 / int8 pages; fp8 at h8);
    4-node placed / striped and 2-node placed pools hold prefill logits
    within 1e-4 of the 1-node run and its per-token greedy tokens at
    h1, h8 and speculative H=8 (near-tie rule).  Through a PoolRouter
    over StoragePool(4): the uninterrupted run (TTFT), a node killed
    after two steps (requeue + re-prefill on the survivors), the same
    kill on the ``lossy`` fault plan (tokens equal to the fault-free
    kill's, injector counters > 0, NACKs = corruptions), a warm drain
    (MIGRATE frames in ``control_plane_terms``) and an ``active=2``
    pool of bucket 4 that grows under load and drains back; every
    stream against the per-token one by the near-tie rule."""
    from repro_torch.core import analytical as A
    from repro_torch.core.faults import PRESET_PLANS
    from repro_torch.core.storage_pool import StoragePool
    from repro_torch.kernels import ops
    from repro_torch.runtime.pool import PoolServer
    from repro_torch.runtime.scheduler import PoolRouter, Request
    from repro_torch.runtime.serve import PagedServer

    cfg, model, params = served["cfg"], served["model"], served["params"]
    prompts = served["prompts"]
    gen, q_gen, chunk, page = (SERVE[k] for k in ("gen", "q8_gen", "chunk",
                                                  "page"))
    store, hzn = SERVE_POOL["store_pages"], SERVE_POOL["horizon"]
    rids = list(range(len(prompts)))
    runs, divergences = {}, []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t_phase = time.monotonic()

    def pool(n, policy="placed", page_dtype="fp32", node_pages=None, **kw):
        return PoolServer(model, params, n_nodes=n, page_size=page,
                          hbm_pages_per_node=node_pages or store // n,
                          policy=policy, page_dtype=page_dtype,
                          device=DEVICE, **kw)

    def record_logits(server):
        """Every decode step's logits, as the device steps select on
        them (``server.token_scores`` observed)."""
        seen = []
        inner = server.token_scores

        def scores(logits, *args):
            seen.append(logits)
            return inner(logits, *args)
        server.token_scores = scores
        return seen

    def admit(server):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits = [server.add_request(i, p, chunk=chunk)
                  for i, p in enumerate(prompts)]
        torch.cuda.synchronize()
        return torch.stack(logits), time.monotonic() - t0

    def decode(server, name, n, **kw):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = server.decode(n, **kw)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        runs[name] = {"decode_s": secs,
                      "decode_tok_s": sum(map(len, out.values())) / secs}
        if kw.get("speculative"):
            runs[name]["speculation"] = server.speculation_stats()
        check(all(len(v) == n and all(0 <= t < cfg.vocab_size for t in v)
                  for v in out.values()), f"{name}: token count and range")
        emit({"phase": "serve_pool", "run": name, **runs[name]})
        return out

    # 1 node = the single server, bit for bit
    one = {}
    for code, n_tok, horizons in (("fp32", gen, (None, hzn)),
                                  ("int8", q_gen, (None, hzn)),
                                  ("fp8", q_gen, (hzn,))):
        for horizon in horizons:
            tag = f"{code}_h{horizon or 1}"
            logs, toks, pre = [], [], []
            for server in (PagedServer(model, params, page_size=page,
                                       hbm_pages=store, page_dtype=code,
                                       device=DEVICE),
                           pool(1, page_dtype=code)):
                pre.append(admit(server)[0])
                logs.append(record_logits(server))
                if tag == "fp32_h1" and len(toks) == 1:
                    gaps = record_gaps(server)
                    first = server.pending_tokens()
                toks.append(decode(server, ("single_" if not toks else
                                            "pool1_") + tag, n_tok,
                                   horizon=horizon))
                del server
            check(torch.equal(pre[0], pre[1]), f"1-node pool {tag}: prefill "
                  "logits != PagedServer's bit for bit")
            check(toks[0] == toks[1] and len(logs[0]) == len(logs[1]) and
                  all(torch.equal(a, b) for a, b in zip(*logs)),
                  f"1-node pool {tag}: a step's logits != PagedServer's")
            one[tag] = {"steps": len(logs[0]), "bit_equal": True}
            if tag == "fp32_h1":
                pre1, tokens1 = pre[1], toks[1]
            del logs
    # the per-token run's streams as a router emits them: the prefill's
    # argmax, then gen - 1 decoded tokens
    top = pre1.topk(2, dim=-1).values
    first_gaps = {r: float(top[r, 0] - top[r, 1]) for r in rids}
    want = {r: [first[r]] + tokens1[r][:gen - 1] for r in rids}

    # N nodes = 1 node
    pool_runs = {}
    for n, policy in SERVE_POOL["runs"]:
        tag = f"{n}n_{policy}"
        errs = []
        for kind, kw in (("h1", {}), ("h8", {"horizon": hzn}),
                         ("spec_h8", {"horizon": hzn,
                                      "speculative": True})):
            server = pool(n, policy)
            logits, prefill_s = admit(server)
            errs.append(float((logits - pre1).abs().max()))
            check(errs[-1] <= KERNEL_TOL, f"{tag} {kind}: prefill logits "
                  f"{errs[-1]} from the 1-node run's")
            if policy == "placed":
                check(len({server.node_of(r) for r in rids}) > 1,
                      f"{tag}: placement spread over more than one node")
            out = decode(server, f"{tag}_{kind}", gen, **kw)
            divergences += first_divergences(
                torch, f"{tag} {kind}", rids, tokens1, out, gaps,
                phase="serve_pool")
            runs[f"{tag}_{kind}"]["prefill_s"] = prefill_s
            if (n, policy, kind) == (4, "placed", "h1"):
                # the pool form merges inside its own launch: no combine
                profile = profile_decode(torch, server, 4, match={
                    "pool_decode_form": "paged_decode_kernel",
                    "combine": "paged_combine_kernel"})
                combine_calls = (profile.get("matched", {}).get("combine", {})
                                 .get("calls_per_step", 0))
                check(combine_calls == 0, f"4-node step: {combine_calls} "
                      "paged_combine_f32 launches a step (the pool form "
                      "merges in its own launch)")
            del server
        pool_runs[tag] = {"prefill_logits_max_abs_err": max(errs)}

    # through the router over StoragePool(4)
    def router_run(name, *, kill=False, drain=False, plan=None,
                   elastic=False):
        el = SERVE_POOL["elastic"]
        server = (pool(el["nodes"], active=el["active"],
                       node_pages=el["node_pages"]) if elastic
                  else pool(4, node_pages=SERVE_POOL["router_node_pages"]))
        fabric = StoragePool(4, heartbeat_timeout=0.0,
                             extent_cfg={"device": DEVICE})
        fabric.attach_server(server)
        if plan is not None:
            fabric.attach_faults(plan)
        router = PoolRouter(server, fabric, max_active=len(prompts),
                            horizon=hzn)
        for r, p in zip(rids, prompts):
            check(router.submit(Request(rid=r, prompt=p, max_tokens=gen)),
                  f"{name}: request {r} taken")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        rec = {}
        for _ in range(SERVE_POOL["kill_after"]):
            router.step()
        if kill:
            victim = server.node_of(min(router.active))
            fabric.nodes[fabric.serving_ips()[victim]].fail()
            t_kill = time.monotonic()
            rec["victim"] = victim
        if drain:
            rep = fabric.drain_serving_node(server.node_of(min(router.active)))
            rec["drain"] = {k: rep[k] for k in ("victims", "migrated_pages",
                                                "cold")}
        if elastic:
            fabric.grow_serving(el["grow_to"])
            rec["alive_after_grow"] = server.alive_nodes()
            router.step()
            router.step()
            grown = [s for s in server.alive_nodes() if s >= el["active"]]
            rep = fabric.drain_serving_node(grown[0])
            rec["drain_back"] = {k: rep[k] for k in (
                "victims", "migrated_pages", "cold")}
            rec["alive_after_drain"] = server.alive_nodes()
        stats = router.run_to_completion()
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        out = {r.rid: list(r.output) for r in router.finished}
        check(stats["requests"] == len(prompts) and not router.rejected,
              f"{name}: every request finished")
        toks = sum(map(len, out.values()))
        terms = A.control_plane_terms(fabric.driver.stats, toks)
        rec.update({
            "seconds": secs, "tok_s": toks / secs,
            "requeues": router.requeues,
            "p50_ttft_s": stats["p50_ttft_s"],
            "p99_ttft_s": stats["p99_ttft_s"],
            "control_frames": terms["control_frames"],
            "frames_per_1k_tokens": terms["frames_per_1k_tokens"],
            "migrate_frames": terms["migrate_frames"],
            "retransmits": terms["retransmits"], "nacks": terms["nacks"],
            "dup_frames": terms["dup_frames"],
            "events": sorted({e[0] for e in fabric.events})})
        if kill:
            rec["after_kill_s"] = time.monotonic() - t_kill
        if plan is not None:
            rec["injector"] = fabric.fault_injector.stats.as_dict()
        runs[name] = rec
        emit({"phase": "serve_pool", "run": name, **rec})
        divergences.extend(first_divergences(
            torch, name, rids, want, out, gaps, first_gaps,
            phase="serve_pool"))
        return out, rec, fabric

    router_run("router_4n")
    failed, rec, _ = router_run("router_failover", kill=True)
    check(rec["requeues"] >= 1 and "serve-requeue" in rec["events"],
          "failover: the victim's sequences requeued")
    chaos, rec, fabric = router_run("router_failover_lossy", kill=True,
                                    plan=PRESET_PLANS["lossy"])
    check(chaos == failed, "lossy fabric: tokens != the fault-free kill's")
    inj = rec["injector"]
    check(all(inj[k] > 0 for k in ("dropped", "corrupted", "duplicated",
                                   "delayed")),
          f"lossy fabric: every kind of fault injected ({inj})")
    check(rec["nacks"] == inj["corrupted"] and
          rec["dup_frames"] >= inj["duplicated"] and rec["retransmits"] > 0,
          "lossy fabric: the driver's recovery counters match the "
          f"injector's ({rec}, {inj})")
    _, rec, _ = router_run("router_drain", drain=True)
    check(rec["drain"]["migrated_pages"] > 0 and
          rec["migrate_frames"] == rec["drain"]["migrated_pages"],
          "warm drain: pages migrated, one MIGRATE frame each")
    _, rec, _ = router_run("router_elastic", elastic=True)
    check(len(rec["alive_after_grow"]) == SERVE_POOL["elastic"]["grow_to"]
          and rec["drain_back"]["victims"] and
          len(rec["alive_after_drain"]) == SERVE_POOL["elastic"]["active"],
          "elastic: grew to 3 nodes, the joined node took requests, and "
          "drained back to 2")

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for code in ("f32", "int8", "fp8"):
        for name in (POOL_DECODE_OF[code], POOL_CHUNK_OF[code]):
            check(counts[name] > 0, f"{name} launched in serve_pool")
    n_merge = sum(counts[n] for n in DECODE_OF.values())
    check(counts[COMBINE] == n_merge,
          f"{COMBINE} launches {counts[COMBINE]} != {n_merge} (one per "
          "single-device decode-form launch; the pool form merges in its "
          "own launch)")
    emit({"phase": "serve_pool", "arch": cfg.name, "requests": len(prompts),
          "prompt_len": SERVE["prompt_len"], "gen": gen, "q8_gen": q_gen,
          "store_pages": store, "horizon": hzn, "one_node": one,
          "pools": pool_runs,
          "decode_tok_s": {k: v["decode_tok_s"] for k, v in runs.items()
                           if "decode_tok_s" in v},
          "router": {k: {k2: v[k2] for k2 in (
              "tok_s", "p50_ttft_s", "p99_ttft_s", "requeues", "seconds",
              "frames_per_1k_tokens", "migrate_frames") if k2 in v}
              for k, v in runs.items() if k.startswith("router")},
          "profile_4n_h1": profile,
          "seconds": time.monotonic() - t_phase,
          "divergences": divergences, "divergence_limit": LOGITS_TOL,
          "launches": counts, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    return counts


# the launcher's --paged --reduced path (head_dim 16) at the serving page
# and at pages of 128: 4 prompts of 300 tokens, chunks of 128, 16 tokens
SERVE_REDUCED = {"arch": "granite-3-2b", "requests": 4, "prompt_len": 300,
                 "gen": 16, "chunk": 128, "pages": (16, 128),
                 "window_tokens": 4096}


def phase_serve_reduced(torch, np, smi):
    """PagedServer over reduced granite-3-2b (head_dim 16, which the
    paged kernels refused before) at each of SERVE_REDUCED's pages:
    greedy tokens identical at horizon 1 and 8, the first decode step's
    logits within 1e-3 of step_reference; launch counters reset just
    before and read just after."""
    from repro_torch.configs.base import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.api import get_model
    from repro_torch.runtime.serve import PagedServer

    cfg = get_arch(SERVE_REDUCED["arch"]).reduced()
    model = get_model(cfg)
    params = model.init(torch.Generator(device=DEVICE).manual_seed(1),
                        device=DEVICE)
    n_req, plen, gen, chunk = (SERVE_REDUCED[k] for k in (
        "requests", "prompt_len", "gen", "chunk"))
    prompts = np.random.default_rng(12).integers(
        0, cfg.vocab_size, (n_req, plen), dtype=np.int32)
    ops.reset_launch_counts()
    runs = {}
    for page in SERVE_REDUCED["pages"]:
        hbm = SERVE_REDUCED["window_tokens"] // page
        tokens = {}
        for horizon in (1, 8):
            server = PagedServer(model, params, page_size=page,
                                 hbm_pages=hbm, device=DEVICE)
            for i, prompt in enumerate(prompts):
                server.add_request(i, prompt, chunk=chunk)
            if horizon == 1:
                pending = server.pending_tokens()
                want = server.step_reference(pending)
                seqs, logits = server.step_batch(pending)
                err = float((logits - want).abs().max())
                check(bool(torch.isfinite(logits).all()) and
                      err <= LOGITS_TOL, f"reduced granite, page {page}: "
                      f"step_batch vs step_reference {err}")
                first = logits.argmax(-1).cpu().tolist()
                for sq, tok in zip(seqs, first):
                    server.set_pending(sq, tok)
                rest = server.decode(gen - 1)
                tokens[1] = {sq: [first[i]] + rest[sq]
                             for i, sq in enumerate(seqs)}
            else:
                tokens[8] = server.decode(gen, horizon=8)
            del server
        check(tokens[1] == tokens[8], f"reduced granite, page {page}: "
              "greedy tokens differ between horizon 1 and 8")
        runs[page] = {"hbm_pages": hbm, "step1_logits_max_abs_err": err,
                      "tokens_identical_h1_h8": True,
                      "tokens_request0": tokens[8][0]}
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    for name in (CHUNK_OF["f32"], DECODE_OF["f32"], COMBINE):
        check(counts[name] > 0, f"{name} launched on the reduced serve path")
    emit({"phase": "serve_reduced", "arch": cfg.name, "head_dim": cfg.hd,
          "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
          "n_layers": cfg.n_layers, "requests": n_req, "prompt_len": plen,
          "gen": gen, "prefill_chunk": chunk, "runs": runs,
          "launches": counts, "logits_tol": LOGITS_TOL,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    return counts


# -- train ---------------------------------------------------------------------

# the train phase: granite-3-2b at full width and depth, f32, through the
# launcher's objects (launch.train.build: get_model, warmup_cosine + adamw,
# make_train_step) and its data pipeline (ShardedLoader); then the same
# width cut to 2 layers for the gates, and the launcher's main itself
TRAIN = {"arch": "granite-3-2b", "batch": 8, "seq": 512, "grad_accum": 2,
         "steps": 4, "lr": 3e-4, "reduced_layers": 2, "restart_steps": 2,
         "compression_steps": 3, "learnable_steps": 20, "learnable_lr": 1e-3,
         "quickstart_steps": 40}
# f32 params + grads + m + v, the grad-accum sum, activations at remat
TRAIN_EXPECTED_GB = 54


def train_objects(cfg, steps, *flags, arch=None):
    """The launcher's objects (``launch.train.build``) for ``arch``
    (TRAIN's by default) at TRAIN's batch and seq and ``steps`` steps,
    with ``flags`` added to its command line, on the card: f32, remat
    "full", random params from a seeded generator, AdamW with
    warmup_cosine.  ``cfg`` (not None) stands in for the arch's config:
    a depth cut."""
    from repro_torch.launch.train import build, parse_args

    return build(parse_args([
        "--arch", arch or TRAIN["arch"], "--batch", str(TRAIN["batch"]),
        "--seq", str(TRAIN["seq"]), "--steps", str(steps),
        "--device", DEVICE, *flags]), cfg=cfg)


def train_batch(torch, np, cfg, i, kind="random"):
    from repro_torch.data import synthetic_stream
    from repro_torch.launch.train import to_device
    return to_device(synthetic_stream(0, i, 0, batch=TRAIN["batch"],
                                      seq_len=TRAIN["seq"],
                                      vocab=cfg.vocab_size, kind=kind),
                     DEVICE)


def phase_train(torch, np, smi):
    """Training on the card: granite-3-2b at full width and depth (the
    launcher's objects and data pipeline, grad-accum 2, remat "full",
    AdamW with warmup_cosine), launch counters reset just before and
    read just after, one step profiled; then 2 layers at full width: one
    step's loss and gradients against the same step through the plain
    attention, a restart through a λFS checkpoint bit-equal to the
    uninterrupted run, int8 compression, and learnable data."""
    import dataclasses

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.base import get_arch
    from repro_torch.core.lambda_fs import LambdaFS
    from repro_torch.data import ShardedLoader
    from repro_torch.kernels import ops
    from repro_torch.launch.train import to_device
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import make_train_step

    t_phase = time.monotonic()
    cfg = get_arch(TRAIN["arch"])
    ga, n_steps = TRAIN["grad_accum"], TRAIN["steps"]
    tokens_a_step = TRAIN["batch"] * TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    ga_lr = ("--grad-accum", str(ga), "--lr", str(TRAIN["lr"]))
    run = train_objects(None, n_steps, *ga_lr)
    model, params, opt, step = run.model, run.params, run.opt_state, run.step
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = model.param_count(params)
    loader = ShardedLoader(global_batch=TRAIN["batch"], seq_len=TRAIN["seq"],
                           vocab=cfg.vocab_size, n_shards=1, shard=0)
    try:
        batches = [to_device(next(loader), DEVICE) for _ in range(n_steps + 1)]
    finally:
        loader.close()
    ops.reset_launch_counts()
    walls, losses, norms = [], [], []
    for batch in batches[:n_steps]:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))          # syncs
        norms.append(float(m["grad_norm"]))
        walls.append(time.monotonic() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"granite train: loss {losses}, grad norm {norms}")
    n_fwd = counts["flash_attention_fwd_lse_f32"]
    n_bwd = counts["flash_attention_bwd_f32"]
    # remat "full" runs each layer's forward twice a microbatch
    check(n_fwd == 2 * cfg.n_layers * ga * n_steps and
          n_bwd == cfg.n_layers * ga * n_steps and
          counts["flash_attention_f32"] == 0,
          f"granite train launches: fwd_lse {n_fwd}, bwd {n_bwd}, "
          f"forward-only {counts['flash_attention_f32']}")
    steady = statistics.median(walls[1:])

    def one_step():
        nonlocal params, opt
        params, opt, m = step(params, opt, batches[n_steps])
        float(m["loss"])
    profile = profile_calls(torch, one_step, 1, {
        "flash_fwd_lse": "flash_3xtf32_kernel",
        "flash_bwd": "flash_bwd_"})
    granite = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab_size,
               "params": n_params, "batch": TRAIN["batch"],
               "seq": TRAIN["seq"], "grad_accum": ga, "remat": "full",
               "steps": n_steps, "init_s": init_s, "losses": losses,
               "grad_norms": norms, "step_wall_s": walls,
               "steady_step_wall_s": steady,
               "tokens_per_s": tokens_a_step / steady,
               "peak_memory_gb": peak_gb,
               "expected_memory_gb": TRAIN_EXPECTED_GB,
               "flash_fwd_lse_launches_a_step": n_fwd / n_steps,
               "flash_bwd_launches_a_step": n_bwd / n_steps,
               "profile_step": profile}
    emit({"phase": "train", "run": "granite-3-2b full", **granite})
    del model, params, opt, step, batches, run
    torch.cuda.empty_cache()

    # 2 layers at full width
    rcfg = dataclasses.replace(cfg, n_layers=TRAIN["reduced_layers"])
    run = train_objects(rcfg, n_steps, *ga_lr)
    model, params = run.model, run.params
    batch = train_batch(torch, np, rcfg, 0)
    grads_only = lambda g, s, p: (g, s)
    gstep = make_train_step(model, grads_only, grad_accum=ga, clip=1e30)
    g_kernel, _, m_kernel = gstep(params, None, batch)
    with plain_kernels(ops):
        g_plain, _, m_plain = gstep(params, None, batch)
    loss_rel = abs(float(m_kernel["loss"]) - float(m_plain["loss"])) / abs(
        float(m_plain["loss"]))
    check(loss_rel <= 1e-5, f"2-layer loss vs plain attention: {loss_rel}")
    grad_err = 0.0
    for a, w in zip(tree_leaves(g_kernel), tree_leaves(g_plain)):
        e = float((a - w).abs().max())
        lim = 1e-4 * max(1.0, float(w.abs().max()))
        check(e <= lim, f"2-layer gradient vs plain attention: {e} > {lim}")
        grad_err = max(grad_err, e / max(1.0, float(w.abs().max())))
    del g_kernel, g_plain, params, model, run
    torch.cuda.empty_cache()

    # restart: 2 steps, save into λFS, restore, 2 more == 4 straight
    r_steps = 2 * TRAIN["restart_steps"]
    rbatches = [train_batch(torch, np, rcfg, i) for i in range(r_steps)]
    run = train_objects(rcfg, r_steps, *ga_lr)
    p, o, step = run.params, run.opt_state, run.step
    for b in rbatches:
        p, o, _ = step(p, o, b)
    straight = [x.clone() for x in tree_leaves(p)]
    del p, o
    fs = LambdaFS()
    mgr = CheckpointManager("/unused", fs=fs)
    run = train_objects(rcfg, r_steps, *ga_lr)
    p, o, step = run.params, run.opt_state, run.step
    for b in rbatches[:TRAIN["restart_steps"]]:
        p, o, _ = step(p, o, b)
    t0 = time.monotonic()
    mgr.save(TRAIN["restart_steps"], {"params": p, "opt": o})
    save_s = time.monotonic() - t0
    del p, o
    run = train_objects(rcfg, r_steps, *ga_lr)
    template, tmpl_opt, step = run.params, run.opt_state, run.step
    t0 = time.monotonic()
    state = mgr.restore({"params": template, "opt": tmpl_opt})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    p, o = state["params"], state["opt"]
    check(all(x.device == t.device for x, t in zip(tree_leaves(p),
                                                   tree_leaves(template))),
          "restored params are on the template's device")
    for b in rbatches[TRAIN["restart_steps"]:]:
        p, o, _ = step(p, o, b)
    resumed = tree_leaves(p)
    check(all(torch.equal(a, b) for a, b in zip(resumed, straight)),
          "2-layer restart through λFS is not bit-equal to the "
          "uninterrupted run")
    del p, o, state, template, tmpl_opt, straight, resumed, run

    # int8 compression, 3 steps
    run = train_objects(rcfg, TRAIN["compression_steps"], *ga_lr,
                        "--compression", "int8")
    p, o, res, cstep = run.params, run.opt_state, run.residuals, run.step
    c_losses = []
    for i in range(TRAIN["compression_steps"]):
        p, o, res, m = cstep(p, o, res, train_batch(torch, np, rcfg, i))
        c_losses.append(float(m["loss"]))
    check(all(np.isfinite(c_losses)), f"int8 compression losses {c_losses}")
    del p, o, res, run

    # learnable data, 20 steps
    n_learn = TRAIN["learnable_steps"]
    run = train_objects(rcfg, n_learn, "--lr", str(TRAIN["learnable_lr"]))
    p, o, lstep = run.params, run.opt_state, run.step
    l_losses = []
    for i in range(n_learn):
        p, o, m = lstep(p, o, train_batch(torch, np, rcfg, i, "learnable"))
        l_losses.append(float(m["loss"]))
    check(all(np.isfinite(l_losses)) and l_losses[-1] < l_losses[0],
          f"learnable data: first loss {l_losses[0]}, last {l_losses[-1]}")
    del p, o
    torch.cuda.empty_cache()
    emit({"phase": "train", "run": f"{rcfg.n_layers} layers, full width",
          "loss_rel_err_vs_plain_attention": loss_rel,
          "grad_err_vs_plain_attention": grad_err,
          "grad_tolerance": "1e-4 x max(1, max|plain|) per leaf",
          "restart_bit_equal": True, "restart_store": "LambdaFS",
          "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
          "lambdafs_bytes": fs.used, "compression_int8_losses": c_losses,
          "learnable_first_loss": l_losses[0],
          "learnable_last_loss": l_losses[-1]})
    train_entry_points(torch, np, ops)
    emit({"phase": "train", "launches": counts,
          "phase_s": time.monotonic() - t_phase,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    return counts


def train_entry_points(torch, np, ops):
    """The user's entry points on the card: ``python -m
    repro_torch.launch.train`` (its ``main``) at --reduced with async
    checkpoints every 2 steps, then again with --resume past the last
    one; and ``examples/quickstart_torch.py`` (its ``main``) for
    TRAIN["quickstart_steps"] steps, which exits unless the loss falls.
    Each must launch the training kernels; checkpoints go under build/
    and are removed after."""
    import importlib.util
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train

    ckpt = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["--arch", TRAIN["arch"], "--reduced", "--steps", "4",
            "--batch", str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]),
            "--grad-accum", "2", "--ckpt-dir", str(ckpt / "launcher"),
            "--ckpt-every", "2", "--log-every", "1", "--device", DEVICE]
    ops.reset_launch_counts()
    losses = train.main(argv)
    resumed = train.main([*argv, "--steps", "6", "--resume"])
    counts = ops.launch_counts()
    steps = CheckpointManager(str(ckpt / "launcher")).steps()
    check(len(losses) == 4 and len(resumed) == 2 and
          all(np.isfinite(losses + resumed)),
          f"launcher losses {losses}, resumed {resumed}")
    check(steps == [2, 4, 6], f"launcher checkpoints {steps}")
    # reduced granite: 2 layers, remat none, 2 microbatches, 6 steps
    check(counts["flash_attention_fwd_lse_f32"] == 24 and
          counts["flash_attention_bwd_f32"] == 24,
          f"launcher kernel launches {counts}")

    path = ROOT / "examples" / "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    ops.reset_launch_counts()
    first, last = quickstart.main([
        "--steps", str(TRAIN["quickstart_steps"]),
        "--ckpt", str(ckpt / "quickstart"), "--device", DEVICE])
    q_counts = ops.launch_counts()
    check(q_counts["flash_attention_fwd_lse_f32"] > 0 and
          q_counts["flash_attention_bwd_f32"] > 0,
          f"quickstart kernel launches {q_counts}")
    shutil.rmtree(ckpt, ignore_errors=True)
    emit({"phase": "train", "run": "entry points",
          "launcher_losses": losses, "launcher_resumed_losses": resumed,
          "launcher_checkpoints": steps,
          "launcher_launches": {k: counts[k] for k in (
              "flash_attention_fwd_lse_f32", "flash_attention_bwd_f32")},
          "quickstart_steps": TRAIN["quickstart_steps"],
          "quickstart_first_loss": first, "quickstart_last_loss": last,
          "quickstart_launches": {k: q_counts[k] for k in (
              "flash_attention_fwd_lse_f32", "flash_attention_bwd_f32")}})


# -- families ------------------------------------------------------------------

# the families phase (after train): the archs no earlier phase runs, each
# built on the card in f32 from a seeded torch.Generator, run and freed
# before the next; 8 requests of 512 tokens.  phi3.5-moe and llama4-scout
# at full width cut in depth (f32 experts are 5.03 and 8.05 GB a layer);
# zamba2, paligemma and hubert at full width and depth; granite-3-2b's
# int8 dense-decode cache on the serve phase's weights and prompts
FAMILIES = {
    "reduced": False, "requests": 8, "prompt_len": 512,
    "moe": {"arch": "phi3.5-moe-42b-a6.6b", "layers": 4, "decode_steps": 4,
            "gen": 32, "chunk": 256, "page": 16, "hbm_pages": 320,
            "pool_nodes": 2, "route_tokens": 64},
    "scout": {"arch": "llama4-scout-17b-a16e", "layers": 2,
              "decode_steps": 4},
    "int8": {"arch": "granite-3-2b", "steps": 8},
    "zamba2": {"arch": "zamba2-1.2b", "gen": 32},
    "paligemma": {"arch": "paligemma-3b", "patches": 256, "gen": 8},
    "hubert": {"arch": "hubert-xlarge", "frames": 512},
}
DECODE_VS_FORWARD_TOL = 5e-4   # the reference's prefill/decode-vs-forward
INT8_SOFTMAX_TOL = 5e-3        # tests/test_optimizations.py's int8 case
INT8_DECISIVE_GAP = 0.05       # the same: greedy tokens equal past this gap
# a router margin (the k-th largest router probability minus the next)
# below which two paths' f32 sums may route a token to different experts:
# ~100x the f32 noise of a probability of ~0.1
ROUTE_TIE = 1e-5
FAMILY_MATCH = {"gemm": "gemm", "gemv": "gemv", "flash": "flash_",
                "paged": "paged_"}
# phi3.5-moe-42b-a6.6b's paged serving shape (32 heads over 8 kv heads of
# 128, page 16) as the families phase serves it: decode at 8 sequences of
# 513..541 positions, its prefill chunk of 256 (lengths 257..512), f32 and
# int8 pages, and the pool forms at 2 nodes of 160 pages, placed
MOE_PAGED = {"heads": 32, "kv_heads": 8, "head_dim": 128, "page": 16,
             "nodes": 2, "local": 160, "family": "phi3.5-moe"}


def family_paged_cases(torch, np, flush):
    """Both paged-attention kernels at MOE_PAGED's shape, each against
    its plain version (1e-4), beside its bound and SDPA on the gathered
    K/V: the decode and chunk forms on f32 and int8 pages, the pool
    decode and chunk forms on f32 pages."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(8)
    h, hkv, d, page, nodes, local = (MOE_PAGED[k] for k in (
        "heads", "kv_heads", "head_dim", "page", "nodes", "local"))
    k, v = (rng.standard_normal((nodes * local, page, hkv, d),
                                dtype=np.float32) for _ in range(2))
    pages = paged_pages(torch, k, v)
    del k, v
    results = []
    for form, lens, pps in (
            ("decode", (513 + 4 * np.arange(8)).astype(np.int32), 64),
            ("chunk", np.arange(257, 513, dtype=np.int32), 32)):
        q = torch.from_numpy(rng.standard_normal((len(lens), h, d),
                                                 dtype=np.float32)).to(dev)
        lengths = torch.from_numpy(lens).to(dev)
        if form == "decode":
            table = torch.from_numpy(pool_table(
                np, rng, lens, pps, "placed", page=page, nodes=nodes,
                local=local)).to(dev)
        else:                          # one sequence's page row, expanded
            row = pool_table(np, rng, lens[-1:], pps, "placed", page=page,
                             nodes=nodes, local=local)[0]
            table = torch.from_numpy(row).to(dev)[None].expand(len(lens),
                                                                pps)
        for layout, code in (("single", "f32"), ("single", "int8"),
                             ("pool", "f32")):
            kp, vp, ks, vs = pages[code]
            if layout == "single":
                kernel, plain = paged_fns(ops, q, kp, vp, ks, vs, table,
                                          lengths)
                name = (CHUNK_OF if form == "chunk" else DECODE_OF)[code]
            else:
                def kernel():
                    return ops.paged_attention_pool(
                        q, kp, vp, table, lengths, n_nodes=nodes,
                        n_local=local)

                def plain():
                    return ops.ref.paged_pool_attention_ref(
                        q, kp, vp, table, lengths, nodes, local)
                name = (POOL_CHUNK_OF if form == "chunk"
                        else POOL_DECODE_OF)[code]
            case = (f"{layout} {form}, B={len(lens)} H={h} Hkv={hkv} D={d} "
                    f"page {page}, lengths {lens[0]}..{lens[-1]}" +
                    (f", {nodes} nodes x {local} pages placed"
                     if layout == "pool" else "") +
                    " (phi3.5-moe-42b-a6.6b paged serving)")
            before = ops.launch_counts()[name]
            got = kernel()
            torch.cuda.synchronize()
            check(ops.launch_counts()[name] == before + 1,
                  f"{case}: the wrapper took the {layout} {form} form")
            err = float((got - plain()).abs().max())
            check(bool(torch.isfinite(got).all()) and err <= KERNEL_TOL,
                  f"{code} {case}: max_abs_err {err} > {KERNEL_TOL}")
            kd, vd = (kp, vp) if ks is None else (
                kp.float() * ks[..., None], vp.float() * vs[..., None])
            b_ms, b_by = bound(torch, q, table, lengths, page, hkv,
                               kp.element_size(), ks is not None)
            results.append({
                "name": ("paged_attention" if code == "f32"
                         else "paged_attention_q8"),
                "kernel": name, "form": f"{layout} {form}", "pages": code,
                "case": case, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[code], "launches": None,
                "families_model": MOE_PAGED["family"],
                "max_abs_err": err, "tolerance": KERNEL_TOL,
                "ms": time_ms(torch, kernel, flush),
                "plain_ms": time_ms(torch, plain, flush, PLAIN_ITERS, 1),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": time_ms(torch, library_call(
                    torch, F, q, kd, vd, table, lengths, page,
                    "prefill" if form == "chunk" else case), flush),
                "library": "torch.nn.functional.scaled_dot_product_"
                           "attention on the gathered dense K/V"})
            results[-1]["kernel_ms"] = results[-1]["ms"]
            emit({"phase": "kernels", **{k_: results[-1][k_] for k_ in (
                "kernel", "case", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}})
    return results


def family_cfg(arch, layers=None):
    """``arch``'s config, cut to ``layers`` layers at full width (the
    reduced config in a CPU rehearsal)."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    if FAMILIES["reduced"]:
        return cfg.reduced()
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def family_model(torch, arch, layers=None, **kw):
    """(cfg, model, params, init seconds): ``get_model`` of the config,
    f32 params drawn on the card from a generator of seed 0."""
    from repro_torch.models.api import get_model
    cfg = family_cfg(arch, layers)
    model = get_model(cfg, **kw)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params = model.init(torch.Generator(device=DEVICE).manual_seed(0),
                        device=DEVICE)
    torch.cuda.synchronize()
    return cfg, model, params, time.monotonic() - t0


def family_prompts(np, cfg, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (FAMILIES["requests"], FAMILIES["prompt_len"]),
        dtype=np.int32)


def family_line(torch, smi, name, cfg, params, init_s, counts, attention,
                wall, tokens, **extra):
    """One model's line: the wall time of its runs (init and profiles
    excluded) and the tokens they processed a second, peak memory, the
    attention kernels' launches (each > 0: every model attends) and
    ``extra``."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    n_params = sum(t.numel() for t in _leaves(params))
    launched = {k: counts[k] for k in attention}
    check(all(n > 0 for n in launched.values()),
          f"{name}: attention launched {launched}")
    emit({"phase": "families", "model": name, "arch": cfg.name,
          "n_layers": cfg.n_layers,
          "depth_cut_from": get_arch(cfg.name).n_layers,
          "head_dim": cfg.hd, "config": dataclasses.asdict(cfg),
          "params": n_params, "weights_gb": n_params * 4 / 1e9,
          "init_s": init_s, "wall_s": wall, "tokens": tokens,
          "tokens_per_s": tokens / wall,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "attention_launches": launched, **extra,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})


def decode_vs_forward(torch, model, params, inputs, steps, pad_to=1):
    """Prefill of ``inputs`` ({"tokens"} or {"embeds"} [B, S]) on an f32
    cache, ``steps`` greedy decode steps, then ``forward`` over the
    prompt and the fed tokens (embedded after an embeds prompt; zero
    tokens appended to a multiple of ``pad_to``, which a causal model's
    earlier logits do not see).  Returns (stats, the largest error of
    the prefill's and each step's logits against the forward's, the
    cache with one free position, the next token)."""
    import torch.nn.functional as F
    first = inputs.get("tokens", inputs.get("embeds"))
    b, s = first.shape[:2]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    logits, cache = model.prefill(params, inputs, cache_dtype=torch.float32)
    cur = logits.argmax(-1)
    torch.cuda.synchronize()
    prefill_s = time.monotonic() - t0
    if "k" in cache:
        cache["k"] = F.pad(cache["k"], (0, 0, 0, steps + 1))
        cache["v"] = F.pad(cache["v"], (0, 0, 0, steps + 1))
    outs, fed = [logits], []
    t1 = time.monotonic()
    for _ in range(steps):
        fed.append(cur)
        lg, cache = model.decode_step(params, cache, cur)
        outs.append(lg)
        cur = lg.argmax(-1)
    torch.cuda.synchronize()
    decode_s = time.monotonic() - t1
    fed = torch.stack(fed, dim=1)
    if "tokens" in inputs:
        seq = torch.cat([inputs["tokens"], fed], dim=1)
        seq = F.pad(seq, (0, -seq.shape[1] % pad_to))
        full = {"tokens": seq}
    else:
        full = {"embeds": torch.cat([inputs["embeds"], params["embed"][
            "table"][fed].to(inputs["embeds"].dtype)], dim=1)}
    ref, _ = model.forward(params, full)
    errs = [float((o - ref[:, s - 1 + t]).abs().max())
            for t, o in enumerate(outs)]
    del ref
    for o in outs:
        check(bool(torch.isfinite(o).all()), "finite logits")
    check(max(errs) <= DECODE_VS_FORWARD_TOL,
          f"prefill/decode logits vs forward: {errs} > "
          f"{DECODE_VS_FORWARD_TOL}")
    stats = {"prefill_s": prefill_s, "prefill_tok_s": b * s / prefill_s,
             "decode_s": decode_s, "decode_steps": steps,
             "decode_tok_s": b * steps / decode_s if steps else None,
             "logits_max_abs_err_vs_forward": max(errs),
             "logits_tol": DECODE_VS_FORWARD_TOL,
             "tokens_request0": fed[0].tolist()}
    return stats, cache, cur


def moe_routing_check(torch, cfg, lp):
    """``layers.apply_moe`` (routed rows) against the plain dense
    dispatch ``layers.apply_moe_dense`` on the card, on layer 0's experts
    and FAMILIES["moe"]["route_tokens"] random tokens: never dropping,
    at the config's capacity factor and at a capacity of 4 (drops
    certain); out within 1e-4 x max(1, max |plain|), aux within 1e-6.
    A dropped pair that differs between the two leaves an expert's
    whole output in one of them."""
    from repro_torch.models import layers as L
    n = FAMILIES["moe"]["route_tokens"]
    x = torch.randn((1, n, cfg.d_model), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(3))
    out = {}
    for label, kw in (("no_drop", {"no_drop": True}),
                      (f"capacity_factor {cfg.capacity_factor}", {}),
                      ("capacity 4", {"capacity": 4})):
        got, aux = L.apply_moe(lp, x, cfg, **kw)
        want, want_aux = L.apply_moe_dense(lp, x, cfg, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        lim = KERNEL_TOL * max(1.0, float(want.abs().max()))
        aux_err = abs(float(aux) - float(want_aux))
        check(err <= lim and aux_err <= 1e-6,
              f"apply_moe {label} vs dense dispatch: {err} (limit {lim}), "
              f"aux {aux_err}")
        cap = L.moe_capacity(cfg, n, kw.get("capacity"),
                             kw.get("no_drop", False))
        keep = L.moe_route(lp, x.reshape(n, -1), cfg, cap)[2]
        out[label] = {"capacity": cap, "dropped_pairs": int((~keep).sum()),
                      "max_abs_err": err, "tolerance": lim,
                      "aux_err": aux_err}
    check(out["capacity 4"]["dropped_pairs"] > 0, "capacity 4 drops")
    return out


@contextlib.contextmanager
def observed_routing(torch):
    """Observe ``layers.moe_route`` (as ``record_gaps`` observes a
    server's token scores): each call's top-k expert ids [T, k] and its
    margins [T] (the k-th largest router probability minus the next), in
    call order."""
    from repro_torch.models import layers as L
    real = L.moe_route
    calls = []

    def observed(p, xt, cfg, capacity):
        out = real(p, xt, cfg, capacity)
        probs = torch.softmax((xt @ p["router"].to(xt.dtype)).float(), -1)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        calls.append((out[1], top[:, -2] - top[:, -1]))
        return out
    L.moe_route = observed
    try:
        yield calls
    finally:
        L.moe_route = real


def routing_steps(calls, n_layers, n_req, plen, prefill_calls):
    """One run's observed routing by step: step 0 the prompt ([n_layers,
    n_req, plen, k] ids and [n_layers, n_req, plen] margins, from one
    call a layer over every prompt, or ``prefill_calls`` calls a layer:
    each sequence's chunks in turn), step s the decode step s ([n_layers,
    n_req, k] and [n_layers, n_req]: one call a layer over the batch)."""
    import torch
    pre, rest = calls[:n_layers * prefill_calls], calls[n_layers *
                                                       prefill_calls:]
    ids = [[] for _ in range(n_layers)]
    margins = [[] for _ in range(n_layers)]
    for i, (topi, margin) in enumerate(pre):
        layer = i % n_layers
        ids[layer].append(topi)
        margins[layer].append(margin)
    steps = [(torch.stack([torch.cat(x).reshape(n_req, plen, -1)
                           for x in ids]),
              torch.stack([torch.cat(x).reshape(n_req, plen)
                           for x in margins]))]
    for i in range(0, len(rest), n_layers):
        step = rest[i:i + n_layers]
        steps.append((torch.stack([t[:n_req] for t, _ in step]),
                      torch.stack([m[:n_req] for _, m in step])))
    return steps


def routing_roots(a, b):
    """Where each sequence's routing first differs between two runs'
    ``routing_steps``: {seq: {"step", "layer", "positions", "margin"}},
    the lowest layer of the first step with a difference (a difference
    there has no earlier one to come from), ``margin`` the largest of
    the two runs' margins over those tokens.  Sequences routed alike in
    every step both runs have are left out."""
    roots = {}
    for step, ((ids_a, m_a), (ids_b, m_b)) in enumerate(zip(a, b)):
        differ = (ids_a != ids_b).any(-1)            # [L, B(, S)]
        for seq in range(differ.shape[1]):
            if seq in roots or not bool(differ[:, seq].any()):
                continue
            layer = int(differ[:, seq].reshape(differ.shape[0], -1).any(-1)
                        .nonzero()[0])
            where = differ[layer, seq]
            margin = max(float(m_a[layer, seq][where].max()),
                         float(m_b[layer, seq][where].max()))
            roots[seq] = {"step": step, "layer": layer, "margin": margin,
                          "positions": where.reshape(-1).nonzero()
                          .reshape(-1).tolist()}
    return roots


def check_route_ties(roots, what):
    """Every routing difference between two runs must start at a
    near-tie of the router (margin below ROUTE_TIE); printed."""
    for seq, root in roots.items():
        emit({"phase": "families", "routing_near_tie": what, "seq": seq,
              **root, "route_tie": ROUTE_TIE})
        check(root["margin"] < ROUTE_TIE,
              f"{what}: sequence {seq} routed apart at a router margin of "
              f"{root['margin']} (not a near-tie below {ROUTE_TIE})")


def tokens_until_roots(want, got, roots, what, first_step=0):
    """Token streams {seq: [...]} (token j the output of step first_step
    + j) identical in every sequence up to the step where its routing
    first differs (``routing_roots``), which a near-tie excuses.
    Returns the number of tokens compared."""
    n = 0
    for seq, toks in want.items():
        end = roots.get(seq, {}).get("step", first_step + len(toks))
        keep = max(0, end - first_step)
        check(toks[:keep] == got[seq][:keep],
              f"{what}: sequence {seq}'s greedy tokens differ before any "
              f"routing difference")
        n += len(toks[:keep])
    return n


def family_moe(torch, np, ops, smi):
    """phi3.5-moe-42b-a6.6b at full width, FAMILIES["moe"]["layers"]
    layers: the routing check, dense prefill and decode steps,
    PagedServer greedy at h1 and h8 on f32 pages and at h8 on int8
    pages, a 2-node PoolServer.  Tokens identical across dense, paged
    h1, paged h8 and the pool, the first paged decode step within 1e-4
    of the dense one, in every sequence whose routing the two paths
    agree on; a sequence whose router meets a near-tie (two experts'
    probabilities within ROUTE_TIE: the paths' f32 sums pick different
    ones) is printed and compared up to that step."""
    from repro_torch.models.transformer import layer_params
    from repro_torch.runtime.pool import PoolServer
    from repro_torch.runtime.serve import PagedServer, make_serving_fns

    spec = FAMILIES["moe"]
    cfg, model, params, init_s = family_model(
        torch, spec["arch"], spec["layers"], moe_no_drop=True)
    routing = moe_routing_check(torch, cfg,
                                layer_params(params["layers"], 0)["mlp"])
    prompts = family_prompts(np, cfg, 21)
    n_req, plen = prompts.shape
    gen, chunk, page, hbm = (spec[k] for k in ("gen", "chunk", "page",
                                                "hbm_pages"))
    n_chunks = -(-plen // chunk)
    ops.reset_launch_counts()
    t0 = time.monotonic()
    prefill, decode = make_serving_fns(model)
    with observed_routing(torch) as calls:
        dense = dense_run(torch, prefill, decode, params, prompts,
                          spec["decode_steps"] + 1)
    dense_route = routing_steps(calls, cfg.n_layers, n_req, plen, 1)

    def admit(server):
        torch.cuda.synchronize()
        t = time.monotonic()
        for i, p in enumerate(prompts):
            server.add_request(i, p, chunk=chunk)   # ends in a host argmax
        return {"prefill_s": time.monotonic() - t}

    def timed_decode(server, n, horizon, run):
        torch.cuda.synchronize()
        t = time.monotonic()
        out = server.decode(n, horizon=horizon)
        run["decode_s"] = time.monotonic() - t
        run["decode_tok_s"] = sum(map(len, out.values())) / run["decode_s"]
        return out

    runs, out = {}, {}
    h1_server = PagedServer(model, params, page_size=page, hbm_pages=hbm,
                            device=DEVICE)
    with observed_routing(torch) as calls:
        runs["paged_h1"] = admit(h1_server)
        pending = h1_server.pending_tokens()
        seqs, step1 = h1_server.step_batch(pending)
        first = step1.argmax(-1).cpu().tolist()
        for s, tok in zip(seqs, first):
            h1_server.set_pending(s, tok)
        rest = timed_decode(h1_server, gen - 1, None, runs["paged_h1"])
    h1_route = routing_steps(calls, cfg.n_layers, n_req, plen,
                             n_req * n_chunks)
    tokens_h1 = {s: [first[i]] + rest[s] for i, s in enumerate(seqs)}
    for label, kw in (("paged_h8", {}),
                      ("paged_int8_h8", {"page_dtype": "int8"})):
        server = PagedServer(model, params, page_size=page, hbm_pages=hbm,
                             device=DEVICE, **kw)
        runs[label] = admit(server)
        out[label] = timed_decode(server, gen, 8, runs[label])
        runs[label]["tier"] = server.tier_stats()
        del server
    server = PoolServer(model, params, n_nodes=spec["pool_nodes"],
                        page_size=page,
                        hbm_pages_per_node=hbm // spec["pool_nodes"],
                        device=DEVICE)
    with observed_routing(torch) as calls:
        runs["pool_2n_h8"] = admit(server)
        out["pool_2n_h8"] = timed_decode(server, gen, 8, runs["pool_2n_h8"])
    runs["pool_2n_h8"]["tier"] = server.tier_stats()
    del server
    pool_route = routing_steps(calls, cfg.n_layers, n_req, plen,
                               n_req * n_chunks)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = ops.launch_counts()

    # dense against paged h1: the first decode step's logits and the
    # tokens of steps 0..decode_steps
    ties = {"dense vs paged h1": routing_roots(dense_route, h1_route),
            "paged h1 vs 2-node pool": routing_roots(h1_route, pool_route)}
    for what, roots in ties.items():
        check_route_ties(roots, what)
    roots = ties["dense vs paged h1"]
    order = torch.tensor(seqs, device=step1.device)
    errs = (dense["step1_logits"][order] - step1).abs().amax(-1).tolist()
    exact = [s for s in seqs if roots.get(s, {}).get("step", 2) > 1]
    step1_err = max(errs[seqs.index(s)] for s in exact)
    check(step1_err <= KERNEL_TOL, f"phi3.5-moe paged first decode step vs "
          f"dense: {step1_err} > {KERNEL_TOL}")
    dense_toks = dense["tokens"].tolist()
    compared = tokens_until_roots(
        {s: dense_toks[s] for s in seqs},
        {s: [pending[s]] + tokens_h1[s][:spec["decode_steps"]] for s in seqs},
        roots, "phi3.5-moe dense vs paged h1")
    check(out["paged_h8"] == tokens_h1, "phi3.5-moe greedy tokens: paged h8 "
          "differs from h1")
    compared_pool = tokens_until_roots(
        tokens_h1, out["pool_2n_h8"], ties["paged h1 vs 2-node pool"],
        "phi3.5-moe paged h1 vs the 2-node pool", first_step=1)
    q8 = out["paged_int8_h8"]
    check(all(len(q8[s]) == gen and all(0 <= t < cfg.vocab_size
                                        for t in q8[s]) for s in seqs),
          "phi3.5-moe int8 pages: every request runs to the end")
    runs["paged_int8_h8"]["agree_with_f32"] = float(np.mean(
        [a == b for s in seqs for a, b in zip(q8[s], tokens_h1[s])]))
    check(counts["flash_attention_f32"] == cfg.n_layers,
          f"phi3.5-moe: flash launched {counts['flash_attention_f32']} times "
          f"in one dense prefill, not {cfg.n_layers}")
    for name, servers in ((CHUNK_OF["f32"], 2), (CHUNK_OF["int8"], 1),
                          (POOL_CHUNK_OF["f32"], 1)):
        check(counts[name] == servers * cfg.n_layers * n_req * n_chunks,
              f"phi3.5-moe: {name} launched {counts[name]} times, not one "
              f"per layer and prefill chunk")
    toks = n_req * (plen * 5 + spec["decode_steps"] + 4 * gen)
    profile_step = profile_decode(torch, h1_server, 1, FAMILY_MATCH)
    del h1_server
    profile_prefill = profile_calls(torch, lambda: prefill(
        params, {"tokens": torch.from_numpy(prompts).long().to(DEVICE)},
        cache_dtype=torch.float32), 1, FAMILY_MATCH)
    family_line(torch, smi, "phi3.5-moe", cfg, params, init_s, counts,
                ("flash_attention_f32", DECODE_OF["f32"], CHUNK_OF["f32"],
                 DECODE_OF["int8"], CHUNK_OF["int8"], POOL_DECODE_OF["f32"],
                 POOL_CHUNK_OF["f32"]), wall, toks,
                dense=dense["stats"], runs=runs, routing_check=routing,
                step1_logits_max_abs_err_vs_dense=step1_err,
                step1_logits_err_by_seq=errs, step1_tol=KERNEL_TOL,
                routing_near_ties=ties, route_tie=ROUTE_TIE,
                tokens_compared={"dense vs paged h1": compared,
                                 "paged h1 vs h8": n_req * gen,
                                 "paged h1 vs pool": compared_pool},
                tokens_request0=tokens_h1[seqs[0]],
                profile_paged_decode_step=profile_step,
                profile_dense_prefill=profile_prefill, launches=counts)
    return counts


def family_scout(torch, np, ops, smi):
    """llama4-scout-17b-a16e at full width, FAMILIES["scout"]["layers"]
    layers: dense prefill and greedy decode steps against its own
    forward."""
    spec = FAMILIES["scout"]
    cfg, model, params, init_s = family_model(
        torch, spec["arch"], spec["layers"], moe_no_drop=True)
    prompts = torch.from_numpy(family_prompts(np, cfg, 22)).long().to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    stats, cache, cur = decode_vs_forward(torch, model, params,
                                          {"tokens": prompts},
                                          spec["decode_steps"])
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    check(counts["flash_attention_f32"] == 2 * cfg.n_layers,
          "llama4-scout: one flash launch a layer in the prefill and in "
          "the forward")
    profile = profile_calls(torch, lambda: model.decode_step(
        params, cache, cur), 1, FAMILY_MATCH)
    family_line(torch, smi, "llama4-scout", cfg, params, init_s,
                counts, ("flash_attention_f32",), wall,
                prompts.numel() * 2 + prompts.shape[0] * spec[
                    "decode_steps"], **stats, group=cfg.n_heads //
                cfg.n_kv_heads, profile_decode_step=profile,
                launches=counts)
    return counts


def family_int8(torch, np, ops, smi):
    """granite-3-2b's int8 dense-decode cache (``kv_quant="int8"``) on
    the serve phase's weights (seed 0) and prompts: the f32 prefill cache
    quantized by ``layers.quantize_kv``, as tests/test_optimizations.py
    does, then decode steps on both caches, fed the same tokens: softmax
    within 5e-3, greedy tokens equal wherever the f32 cache's top-2 gap
    is over 0.05."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    from repro_torch.models.api import get_model
    spec = FAMILIES["int8"]
    cfg, m_fp, params, init_s = family_model(torch, spec["arch"])
    m_q8 = get_model(cfg, kv_quant="int8")
    prompts = torch.from_numpy(family_prompts(np, cfg, 0)).long().to(DEVICE)
    steps = spec["steps"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    logits, cache = m_fp.prefill(params, {"tokens": prompts},
                                 cache_dtype=torch.float32)
    for name in ("k", "v"):
        cache[name] = F.pad(cache[name], (0, 0, 0, steps + 1))
    kq, ks = L.quantize_kv(cache["k"])
    vq, vs = L.quantize_kv(cache["v"])
    q8 = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs,
          "index": cache["index"]}
    cur = logits.argmax(-1)
    prob_err, decisive, q8_s = 0.0, 0, 0.0
    for _ in range(steps):
        lf, cache = m_fp.decode_step(params, cache, cur)
        torch.cuda.synchronize()
        t = time.monotonic()
        lq, q8 = m_q8.decode_step(params, q8, cur)
        torch.cuda.synchronize()
        q8_s += time.monotonic() - t
        prob_err = max(prob_err, float((torch.softmax(lf, -1) -
                                        torch.softmax(lq, -1)).abs().max()))
        top2 = torch.topk(lf, 2, dim=-1).values
        sure = top2[:, 0] - top2[:, 1] > INT8_DECISIVE_GAP
        check(torch.equal(lf.argmax(-1)[sure], lq.argmax(-1)[sure]),
              "granite int8 cache: a decisive greedy token differs")
        decisive += int(sure.sum())
        cur = lf.argmax(-1)
    check(prob_err <= INT8_SOFTMAX_TOL, f"granite int8 cache: softmax "
          f"{prob_err} > {INT8_SOFTMAX_TOL}")
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    profile = profile_calls(torch, lambda: m_q8.decode_step(params, q8, cur),
                            1, FAMILY_MATCH)
    family_line(torch, smi, "granite-int8-cache", cfg, params, init_s,
                counts, ("flash_attention_f32",), wall,
                prompts.numel() + 2 * prompts.shape[0] * steps,
                decode_steps=steps, q8_decode_s=q8_s,
                q8_decode_tok_s=prompts.shape[0] * steps / q8_s,
                softmax_max_abs_err=prob_err,
                softmax_tol=INT8_SOFTMAX_TOL, decisive_tokens=decisive,
                decisive_tokens_equal=True,
                cache_bytes={"int8": sum(t.numel() * t.element_size()
                                         for t in (kq, vq, ks, vs)),
                             "f32": 2 * kq.numel() * 4},
                profile_q8_decode_step=profile, launches=counts)
    return counts


def family_zamba2(torch, np, ops, smi):
    """zamba2-1.2b at full width and depth: prefill, greedy decode steps,
    both within 5e-4 of ``forward`` on the same tokens."""
    spec = FAMILIES["zamba2"]
    cfg, model, params, init_s = family_model(torch, spec["arch"])
    prompts = torch.from_numpy(family_prompts(np, cfg, 23)).long().to(DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    stats, cache, cur = decode_vs_forward(torch, model, params,
                                          {"tokens": prompts}, spec["gen"],
                                          pad_to=model.chunk)
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    check(counts["flash_attention_f32"] == 2 * model.n_attn,
          f"zamba2: flash launched {counts['flash_attention_f32']} times, "
          f"not once per shared-block application in the prefill and the "
          f"forward ({2 * model.n_attn})")
    profile_step = profile_calls(torch, lambda: model.decode_step(
        params, cache, cur), 1, FAMILY_MATCH)
    profile_prefill = profile_calls(torch, lambda: model.prefill(
        params, {"tokens": prompts}, cache_dtype=torch.float32), 1,
        FAMILY_MATCH)
    family_line(torch, smi, "zamba2", cfg, params, init_s, counts,
                ("flash_attention_f32",), wall,
                2 * prompts.numel() + prompts.shape[0] * spec["gen"] * 2,
                **stats, shared_block_applications=model.n_attn,
                profile_decode_step=profile_step,
                profile_prefill=profile_prefill, launches=counts)
    return counts


def family_paligemma(torch, np, ops, smi):
    """paligemma-3b at full width and depth: prefill from synthetic patch
    embeddings, then greedy token decode steps, within 5e-4 of
    ``forward`` over the patches and the fed tokens' embeddings."""
    from repro_torch.models.frontends import synth_embeddings
    spec = FAMILIES["paligemma"]
    cfg, model, params, init_s = family_model(torch, spec["arch"])
    patches = synth_embeddings(
        cfg, FAMILIES["requests"], spec["patches"],
        torch.Generator(device=DEVICE).manual_seed(24), device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    stats, cache, cur = decode_vs_forward(torch, model, params,
                                          {"embeds": patches}, spec["gen"])
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    check(counts["flash_attention_f32"] == 2 * cfg.n_layers,
          "paligemma: one flash launch a layer in the prefill and in the "
          "forward")
    profile = profile_calls(torch, lambda: model.prefill(
        params, {"embeds": patches}, cache_dtype=torch.float32), 1,
        FAMILY_MATCH)
    family_line(torch, smi, "paligemma", cfg, params, init_s, counts,
                ("flash_attention_f32",), wall,
                2 * patches.shape[0] * patches.shape[1] +
                patches.shape[0] * spec["gen"] * 2, **stats,
                flash_route="FMA (head_dim 256)", profile_prefill=profile,
                launches=counts)
    return counts


def family_hubert(torch, np, ops, smi):
    """hubert-xlarge at full width and depth: ``forward`` on synthetic
    frame embeddings; changing the last frame moves the first frame's
    logits (tests/test_models.py's bidirectional check)."""
    from repro_torch.models.frontends import synth_embeddings
    spec = FAMILIES["hubert"]
    cfg, model, params, init_s = family_model(torch, spec["arch"])
    frames = synth_embeddings(
        cfg, FAMILIES["requests"], spec["frames"],
        torch.Generator(device=DEVICE).manual_seed(25), device=DEVICE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.monotonic()
    l1, _ = model.forward(params, {"embeds": frames})
    torch.cuda.synchronize()
    forward_s = time.monotonic() - t0
    changed = frames.clone()
    changed[:, -1] = 0.0
    l2, _ = model.forward(params, {"embeds": changed})
    moved = float((l1[:, 0] - l2[:, 0]).abs().max())
    check(bool(torch.isfinite(l1).all()) and tuple(l1.shape) == (
        *frames.shape[:2], cfg.vocab_size), "hubert logits: shape, finite")
    check(moved > 1e-6, f"hubert: the last frame moved the first logits by "
          f"{moved}, not past 1e-6 (not bidirectional)")
    wall = time.monotonic() - t0
    counts = ops.launch_counts()
    check(counts["flash_attention_f32"] == 2 * cfg.n_layers,
          "hubert: one flash launch a layer a forward")
    profile = profile_calls(torch, lambda: model.forward(
        params, {"embeds": frames}), 1, FAMILY_MATCH)
    family_line(torch, smi, "hubert", cfg, params, init_s, counts,
                ("flash_attention_f32",), wall, 2 * frames.shape[0] *
                frames.shape[1], forward_s=forward_s,
                forward_tok_s=frames.shape[0] * frames.shape[1] / forward_s,
                first_logits_moved_by_last_frame=moved,
                profile_forward=profile, launches=counts)
    return counts


def phase_families(torch, np, smi):
    """The archs no earlier phase runs, one at a time (each model's
    weights freed before the next is built), launch counters reset just
    before each and read just after.  Returns {model: launch counts}."""
    from repro_torch.kernels import ops
    t_phase = time.monotonic()
    per_model = {}
    for name, run in (("phi3.5-moe", family_moe),
                      ("llama4-scout", family_scout),
                      ("granite-int8-cache", family_int8),
                      ("zamba2", family_zamba2),
                      ("paligemma", family_paligemma),
                      ("hubert", family_hubert)):
        torch.cuda.empty_cache()
        per_model[name] = run(torch, np, ops, smi)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    counts = {k: sum(c[k] for c in per_model.values())
              for k in per_model["hubert"]}
    emit({"phase": "families", "launches": counts,
          "phase_s": time.monotonic() - t_phase,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    return per_model


# -- train_families -------------------------------------------------------------

# the train_families phase (after families): training of the families the
# train phase does not run, each built on the card in f32 from a seeded
# generator (train_objects: launch.train.build at TRAIN's 8 x 512 tokens,
# remat "full", AdamW with warmup_cosine), run and freed before the next.  rwkv6-3b and zamba2-1.2b at full depth
# and width, phi3.5-moe at full width cut to 2 of 32 layers (5 f32 copies
# of its 2.74B parameters: 55 GB; 3 layers would need 80).  Then at
# gate_layers of the same width: one step against the plain versions, a
# λFS restart (phi3.5-moe at restart_layers: its host copies of params and
# moments), learnable data; and launch.train.main at --reduced.
TRAIN_FAMILIES = {
    "grad_accum": 2, "steps": 3, "lr": 3e-4,
    "gate_layers": 2, "restart_layers": {"phi3.5-moe-42b-a6.6b": 1},
    "restart_steps": 1, "learnable_steps": 10, "learnable_lr": 1e-3,
    "reduced": False,
    "models": (("rwkv6-3b", None), ("zamba2-1.2b", None),
               ("phi3.5-moe-42b-a6.6b", 2)),
}
# (the wkv backward's three kernels: rwkv_scan_bwd_{state,chunk,du}_kernel)
TRAIN_MATCH = {"gemm": "gemm", "wkv_fwd": "rwkv_scan_kernel",
               "wkv_bwd": "rwkv_scan_bwd_",
               "flash_fwd": "flash_3xtf32", "flash_bwd": "flash_bwd_"}


def train_family_cfg(arch, layers=None):
    """``arch``'s config cut to ``layers`` at full width (the reduced
    config, cut the same way, in a CPU rehearsal)."""
    import dataclasses

    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    if TRAIN_FAMILIES["reduced"]:
        cfg = cfg.reduced()
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def train_family_kernels(cfg, model):
    """{kernel: launches a microbatch} of a training step with remat
    "full": RWKV6 runs the wkv states variant twice a layer (the forward
    and its recompute) and the backward once; Zamba2's shared block (not
    recomputed, as the reference's) the flash training forward and
    backward once an application; a transformer each layer's flash
    training forward twice and its backward once."""
    if cfg.block_type == "rwkv6":
        return {"rwkv_scan_states_f32": 2 * cfg.n_layers,
                "rwkv_scan_bwd_f32": cfg.n_layers, "rwkv_scan_f32": 0}
    if cfg.block_type == "mamba2_hybrid":
        return {"flash_attention_fwd_lse_f32": model.n_attn,
                "flash_attention_bwd_f32": model.n_attn,
                "flash_attention_f32": 0}
    return {"flash_attention_fwd_lse_f32": 2 * cfg.n_layers,
            "flash_attention_bwd_f32": cfg.n_layers,
            "flash_attention_f32": 0}


@contextlib.contextmanager
def pinned_routing(torch, recorded):
    """``layers.moe_route`` replaying ``recorded`` top-k expert ids [T, k]
    in call order: the weights, the aux term and the capacity drops
    computed as ``moe_route`` computes them, from this path's router
    probabilities at those ids (a path held to another at the routes the
    other took)."""
    import torch.nn.functional as F

    from repro_torch.models import layers as L
    real = L.moe_route
    it = iter(recorded)

    def pinned(p, xt, cfg, capacity):
        e = cfg.n_experts
        topi = next(it)
        probs = torch.softmax((xt @ p["router"].to(xt.dtype)).float(), -1)
        topv = probs.gather(-1, topi)
        topv = topv / topv.sum(dim=-1, keepdim=True)
        density = F.one_hot(topi[:, 0], e).float().mean(dim=0)
        aux = torch.sum(density * probs.mean(dim=0)) * (e ** 2) / e
        onehot = F.one_hot(topi, e)
        pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
        return topv, topi, pos < capacity, aux
    L.moe_route = pinned
    try:
        yield
    finally:
        L.moe_route = real


def train_family_gate(torch, np, ops, arch, cfg):
    """One step's loss and gradients (grad-accum as the full run, no
    clip) against the same step through the plain flash and wkv versions
    on the card: loss within 1e-5 rel, each leaf within 1e-4 x max(1,
    max |plain|).  For an MoE both paths' routing is observed; where it
    differs, each difference must start at a router near-tie (margin
    below ROUTE_TIE, printed) and the plain path is held to the kernel
    path's routes (``pinned_routing``)."""
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.runtime.train import make_train_step
    tf = TRAIN_FAMILIES
    run = train_objects(cfg, 1, "--grad-accum", str(tf["grad_accum"]),
                        arch=arch)
    model, params = run.model, run.params
    batch = train_batch(torch, np, cfg, 0)
    grads_only = lambda g, s, p: (g, s)
    gstep = make_train_step(model, grads_only, grad_accum=tf["grad_accum"],
                            clip=1e30)
    observe = (lambda: observed_routing(torch)) if cfg.is_moe else (
        lambda: contextlib.nullcontext([]))
    with observe() as calls_k:
        g_kernel, _, m_kernel = gstep(params, None, batch)
    with plain_kernels(ops), observe() as calls_p:
        g_plain, _, m_plain = gstep(params, None, batch)
    routing = {"calls": len(calls_k), "differing_tokens": 0}
    if cfg.is_moe:
        check(len(calls_k) == len(calls_p), "routing calls differ")
        worst = 0.0
        for (ids_k, m_k), (ids_p, m_p) in zip(calls_k, calls_p):
            where = (ids_k != ids_p).any(-1)
            if bool(where.any()):
                routing["differing_tokens"] += int(where.sum())
                worst = max(worst, float(m_k[where].max()),
                            float(m_p[where].max()))
        routing["max_margin_of_a_difference"] = worst
        if routing["differing_tokens"]:
            emit({"phase": "train_families", "routing_near_tie": arch,
                  **routing, "route_tie": ROUTE_TIE})
            check(worst < ROUTE_TIE, f"{arch} gate: routed apart at a "
                  f"router margin of {worst} (not below {ROUTE_TIE})")
            del g_plain
            with plain_kernels(ops), pinned_routing(
                    torch, [ids for ids, _ in calls_k]):
                g_plain, _, m_plain = gstep(params, None, batch)
            routing["plain_path_pinned"] = True
    loss_rel = abs(float(m_kernel["loss"]) - float(m_plain["loss"])) / abs(
        float(m_plain["loss"]))
    check(loss_rel <= 1e-5, f"{arch} gate: loss vs plain {loss_rel}")
    grad_err = 0.0
    for a, w in zip(tree_leaves(g_kernel), tree_leaves(g_plain)):
        e = float((a - w).abs().max())
        scale = max(1.0, float(w.abs().max()))
        check(e <= 1e-4 * scale,
              f"{arch} gate: gradient vs plain {e} > {1e-4 * scale}")
        grad_err = max(grad_err, e / scale)
    del g_kernel, g_plain, params, model, run, calls_k, calls_p
    torch.cuda.empty_cache()
    return {"loss_rel_err_vs_plain": loss_rel,
            "grad_err_vs_plain": grad_err, "routing": routing}


def train_family_restart(torch, np, arch, cfg):
    """2 x restart_steps steps straight against restart_steps, a save into
    λFS, a restore into a fresh template and restart_steps more: params
    bit-equal (for an MoE: its gathers' gradients deterministic)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.lambda_fs import LambdaFS
    from repro_torch.optim.adamw import tree_leaves
    tf = TRAIN_FAMILIES
    flags = ("--grad-accum", str(tf["grad_accum"]), "--lr", str(tf["lr"]))
    half = tf["restart_steps"]
    batches = [train_batch(torch, np, cfg, i) for i in range(2 * half)]
    run = train_objects(cfg, 2 * half, *flags, arch=arch)
    p, o, step = run.params, run.opt_state, run.step
    for b in batches:
        p, o, _ = step(p, o, b)
    straight = [x.clone() for x in tree_leaves(p)]
    del p, o, run
    torch.cuda.empty_cache()
    fs = LambdaFS()
    mgr = CheckpointManager("/unused", fs=fs)
    run = train_objects(cfg, 2 * half, *flags, arch=arch)
    p, o, step = run.params, run.opt_state, run.step
    for b in batches[:half]:
        p, o, _ = step(p, o, b)
    t0 = time.monotonic()
    mgr.save(half, {"params": p, "opt": o})
    save_s = time.monotonic() - t0
    del p, o, run
    torch.cuda.empty_cache()
    run = train_objects(cfg, 2 * half, *flags, arch=arch)
    t0 = time.monotonic()
    state = mgr.restore({"params": run.params, "opt": run.opt_state})
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    p, o, step = state["params"], state["opt"], run.step
    del run
    for b in batches[half:]:
        p, o, _ = step(p, o, b)
    check(all(torch.equal(a, b) for a, b in zip(tree_leaves(p), straight)),
          f"{arch}: the λFS restart is not bit-equal to the uninterrupted "
          f"run")
    used = fs.used
    del p, o, state, straight, mgr, fs
    torch.cuda.empty_cache()
    return {"restart_layers": cfg.n_layers, "restart_bit_equal": True,
            "restart_store": "LambdaFS", "checkpoint_save_s": save_s,
            "checkpoint_restore_s": restore_s, "lambdafs_bytes": used}


def train_family_learnable(torch, np, arch, cfg):
    """learnable_steps steps on the learnable stream: finite losses, the
    last below the first."""
    tf = TRAIN_FAMILIES
    run = train_objects(cfg, tf["learnable_steps"], "--lr",
                        str(tf["learnable_lr"]), arch=arch)
    p, o, step = run.params, run.opt_state, run.step
    losses = []
    for i in range(tf["learnable_steps"]):
        p, o, m = step(p, o, train_batch(torch, np, cfg, i, "learnable"))
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{arch} learnable data: losses {losses}")
    del p, o, run
    torch.cuda.empty_cache()
    return {"learnable_losses": losses}


def train_family_launcher(torch, np, ops, arch, kernels):
    """``launch.train.main`` at --reduced on the card (4 steps with async
    checkpoints every 2, then --resume to 6): finite losses, checkpoints
    2/4/6, and ``kernels`` launched."""
    import shutil

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    ckpt = ROOT / "build" / "chip_smoke_train_families"
    shutil.rmtree(ckpt, ignore_errors=True)
    tf = TRAIN_FAMILIES
    argv = ["--arch", arch, "--reduced", "--steps", "4", "--batch",
            str(TRAIN["batch"]), "--seq", str(TRAIN["seq"]), "--grad-accum", "2",
            "--ckpt-dir", str(ckpt), "--ckpt-every", "2", "--log-every", "1",
            "--device", DEVICE]
    ops.reset_launch_counts()
    losses = train.main(argv)
    resumed = train.main([*argv, "--steps", "6", "--resume"])
    counts = ops.launch_counts()
    steps = CheckpointManager(str(ckpt)).steps()
    shutil.rmtree(ckpt, ignore_errors=True)
    check(len(losses) == 4 and len(resumed) == 2 and
          all(np.isfinite(losses + resumed)),
          f"{arch} launcher losses {losses}, resumed {resumed}")
    check(steps == [2, 4, 6], f"{arch} launcher checkpoints {steps}")
    check(all(counts[k] > 0 for k in kernels),
          f"{arch} launcher launches {counts}")
    return {"launcher_losses": losses, "launcher_resumed_losses": resumed,
            "launcher_checkpoints": steps,
            "launcher_launches": {k: counts[k] for k in kernels}}


def train_family(torch, np, ops, smi, arch, layers):
    """One family: the full run (launch counters reset just before and
    read just after, one step profiled), then the gate, the restart,
    learnable data and, for the SSM families, the launcher.  Returns the
    full run's launch counts."""
    tf = TRAIN_FAMILIES
    ga, n_steps = tf["grad_accum"], tf["steps"]
    cfg = train_family_cfg(arch, layers)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    run = train_objects(cfg, n_steps, "--grad-accum", str(ga), "--lr",
                        str(tf["lr"]), arch=arch)
    model, params, opt, step = run.model, run.params, run.opt_state, run.step
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    n_params = model.param_count(params)
    batches = [train_batch(torch, np, cfg, i) for i in range(n_steps + 1)]
    ops.reset_launch_counts()
    walls, losses, norms = [], [], []
    for batch in batches[:n_steps]:
        torch.cuda.synchronize()
        t0 = time.monotonic()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))            # syncs
        norms.append(float(m["grad_norm"]))
        walls.append(time.monotonic() - t0)
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{arch} train: loss {losses}, grad norm {norms}")
    want = {k: n * ga * n_steps
            for k, n in train_family_kernels(cfg, model).items()}
    got = {k: counts[k] for k in want}
    check(got == want, f"{arch} train launches {got}, expected {want}")

    def one_step():
        nonlocal params, opt
        params, opt, m = step(params, opt, batches[n_steps])
        float(m["loss"])
    profile = profile_calls(torch, one_step, 1, TRAIN_MATCH)
    steady = statistics.median(walls[1:])
    line = {"phase": "train_families", "model": arch, "arch": cfg.name,
            "n_layers": cfg.n_layers,
            "depth_cut_from": train_family_cfg(arch).n_layers,
            "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "params": n_params, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "grad_accum": ga, "remat": "full", "steps": n_steps,
            "init_s": init_s, "losses": losses, "grad_norms": norms,
            "step_wall_s": walls, "steady_step_wall_s": steady,
            "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / steady,
            "peak_memory_gb": peak_gb, "launches_a_step": {
                k: n / n_steps for k, n in got.items()},
            "idle_share": profile.get("idle_share"),
            "device_ops_per_step": profile.get("device_ops_per_step"),
            "profile_step": profile}
    launched = [k for k, n in train_family_kernels(cfg, model).items() if n]
    del model, params, opt, step, batches, run
    torch.cuda.empty_cache()
    gcfg = train_family_cfg(arch, tf["gate_layers"])
    line.update(gate_layers=gcfg.n_layers,
                **train_family_gate(torch, np, ops, arch, gcfg))
    rcfg = train_family_cfg(arch, tf["restart_layers"].get(
        arch, tf["gate_layers"]))
    line.update(train_family_restart(torch, np, arch, rcfg))
    line.update(train_family_learnable(torch, np, arch, gcfg))
    if not cfg.is_moe:
        line.update(train_family_launcher(torch, np, ops, arch, launched))
    emit({**line, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "note": "smoke run, not a benchmark"})
    return counts


def phase_train_families(torch, np, smi):
    """Training of rwkv6-3b, zamba2-1.2b and phi3.5-moe on the card, one
    model at a time (each freed before the next).  Returns {model: the
    full run's launch counts}."""
    from repro_torch.kernels import ops
    t_phase = time.monotonic()
    per_model = {}
    for arch, layers in TRAIN_FAMILIES["models"]:
        per_model[arch] = train_family(torch, np, ops, smi, arch, layers)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    emit({"phase": "train_families", "phase_s": time.monotonic() - t_phase,
          "launches": {a: {k: c[k] for k in c if c[k]}
                       for a, c in per_model.items()},
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    return per_model


def profile_decode(torch, server, n_steps, match=None):
    """Where a horizon-1 decode step's time goes: ``n_steps`` committed
    steps of the paged server under ``torch.profiler``."""
    pending = server.pending_tokens()

    def steps():
        nonlocal pending
        for _ in range(n_steps):
            seqs, logits = server.step_batch(pending)
            pending = dict(zip(seqs, logits.argmax(-1).cpu().tolist()))
    return profile_calls(torch, steps, n_steps, match)


def profile_calls(torch, run, n_steps, match=None):
    """``run()`` (``n_steps`` steps) under ``torch.profiler``: device busy
    time is the sum of the kernels' device time (one stream, so they do
    not overlap), idle share the rest of the wall time; ``match``
    ({label: substring}) also sums the ms and calls a step of the
    kernels whose name holds the substring.  A measurement only: a
    profiler that fails or sees no device time is reported, not
    fatal."""
    from torch.profiler import ProfilerActivity, profile
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            run()
            torch.cuda.synchronize()
            wall_ms = (time.monotonic() - t0) * 1e3 / n_steps
        rows = []
        for a in prof.key_averages():
            if a.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = (getattr(a, "self_device_time_total", None)
                  or getattr(a, "self_cuda_time_total", 0))
            rows.append((us / 1e3 / n_steps, a.count / n_steps, a.key))
    except Exception as exc:      # the smoke run goes on without it
        return {"error": repr(exc)}
    busy = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    matched = {label: {"ms_per_step": sum(r[0] for r in rows if sub in r[2]),
                       "calls_per_step": sum(r[1] for r in rows
                                             if sub in r[2])}
               for label, sub in (match or {}).items()}
    return {"steps": n_steps, "wall_ms_per_step": wall_ms, "matched": matched,
            "device_busy_ms_per_step": busy,
            "idle_share": 1 - busy / wall_ms if busy else None,
            "device_ops_per_step": sum(r[1] for r in rows),
            "top": [{"kernel": k[:80], "ms_per_step": ms,
                     "calls_per_step": n} for ms, n, k in rows[:8]],
            "note": ("profiled (profiler overhead included in the wall "
                     "time)" if busy else "profiler saw no device time")}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    resolve_device("cuda")                      # f32 contract: TF32 off
    smi = phase_env(torch)
    phase_build()
    data = make_data(np)
    kernels = phase_kernels(torch, np)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=DEVICE)
    kernels += phase_isp_kernels(torch, np, data, flush)
    kernels += phase_dense_kernels(torch, np, flush)
    del flush
    counts, served = phase_serve(torch, np, smi)
    spec_counts = phase_serve_spec(torch, np, smi, served)
    pool_counts = phase_serve_pool(torch, np, smi, served)
    reduced_counts = phase_serve_reduced(torch, np, smi)
    isp_counts = phase_isp(torch, np, smi, served, data)
    del data
    dense_counts = phase_dense(torch, np, smi, served)
    train_counts = phase_train(torch, np, smi)
    family_counts = phase_families(torch, np, smi)
    tf_counts = phase_train_families(torch, np, smi)
    for entry in kernels:
        entry["launches"] = sum(c[entry["kernel"]] for c in (
            counts, spec_counts, pool_counts, reduced_counts, isp_counts,
            dense_counts, train_counts, *family_counts.values(),
            *tf_counts.values()))
        entry["launches_in_train"] = train_counts[entry["kernel"]]
        entry["launches_in_train_families"] = {
            a: c[entry["kernel"]] for a, c in tf_counts.items()}
        if "families_model" in entry:
            entry["launches_in_families"] = family_counts[
                entry["families_model"]][entry["kernel"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
