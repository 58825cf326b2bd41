#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Drives the port's main path, paged-KV serving of full-width
granite-3-2b, on the card, in phases; each phase prints one JSON line
and any failure exits non-zero:

  env      the card (name and power limit from nvidia-smi), torch and
           CUDA versions; fails when torch.cuda.is_available() is false
  build    nvcc builds every kernel source of the checkout, timed
  kernels  each kernel against its plain version at the serving path's
           shapes (decode and prefill chunk; f32, int8 and fp8 pages),
           timed with CUDA events beside its bound and a library call
  serve    PagedServer over full-width granite-3-2b (40 layers, random
           f32 weights from a seeded torch.Generator): 8 prompts of 512
           tokens, prefill chunks of 256, 64 greedy tokens at horizon 1
           and at horizon 8 (tokens must be identical), the first decode
           step's logits against the plain-attention step_reference, then
           int8 and fp8 page passes; kernel launch counters reset just
           before and read just after; a few horizon-1 steps under
           torch.profiler give the step's device busy time

Then the kernels line (with the serve phase's launch counts), the
nvidia-smi line, and the last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
KERNEL_TOL = 1e-4              # f32 outputs ~N(0,1); only the sum order differs
# logits of the kernel path vs the plain-attention reference after 40
# f32 layers: the attention sums differ in order (about 1e-6 relative per
# layer) and the residual stream carries that through every layer
LOGITS_TOL = 1e-3
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
REPLACES = {"f32": "src/repro/kernels/paged_attention.py:39",
            "int8": "src/repro/kernels/paged_attention.py:77",
            "fp8": "src/repro/kernels/paged_attention.py:77"}
KERNEL_OF = {"f32": "paged_attention_f32", "int8": "paged_attention_q8_int8",
             "fp8": "paged_attention_q8_fp8"}


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
    layer's pages cold: a layer's weights pass through L2 in between)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(torch, q, table, lengths, page, hkv, code_bytes, quantized):
    """Least time for the work on this run's data: bytes (each valid
    k/v slot, its scales, q, out, table and lengths once) over the
    memory rate, vs f32 operations (4*D per query head and valid
    position) over the f32 rate."""
    b, h, d = q.shape
    pps = table.shape[1]
    pos = torch.arange(pps * page, device=q.device)
    valid = pos[None, :] < lengths[:, None].long()
    slot = table.long().repeat_interleave(page, dim=1) * page + pos % page
    n_slots = int(torch.unique(slot[valid]).numel())
    per_slot = hkv * d * code_bytes * 2 + (hkv * 4 * 2 if quantized else 0)
    n_bytes = (n_slots * per_slot + 2 * q.numel() * 4 + table.numel() * 4 +
               lengths.numel() * 4)
    ops = int(lengths.long().sum()) * h * d * 4
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    return (max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms
            else "operations")


def kernel_cases(torch, np):
    """Inputs at the serving path's shapes for granite-3-2b (H=32,
    Hkv=8, D=64, page 16): a decode batch with ragged lengths (0, 1, a
    partial page, up to 1000 over a pow2 table of 64 pages) and a
    prefill chunk of 256 query positions of one sequence (the second
    chunk of a 512-token prompt: lengths 257..512, one page row
    broadcast over the chunk)."""
    rng = np.random.default_rng(0)
    h, hkv, d, page, n_phys = 32, 8, 64, 16, 320
    k = rng.standard_normal((n_phys, page, hkv, d), dtype=np.float32)
    v = rng.standard_normal((n_phys, page, hkv, d), dtype=np.float32)
    dec_len = np.array([0, 1, 9, 16, 100, 513, 777, 1000], np.int32)
    dec_table = np.zeros((8, 64), np.int32)
    perm = rng.permutation(n_phys)
    used = 0
    for i, n in enumerate(dec_len):
        need = -(-int(n) // page)
        dec_table[i, :need] = perm[used:used + need]
        used += need
    row = rng.permutation(n_phys)[:32].astype(np.int32)
    pre_table = np.broadcast_to(row[None, :], (256, 32)).copy()
    pre_len = np.arange(257, 513, dtype=np.int32)
    cases = []
    for name, table, lens in (("decode B=8 pps=64", dec_table, dec_len),
                              ("prefill chunk C=256 pps=32", pre_table,
                               pre_len)):
        q = rng.standard_normal((len(lens), h, d), dtype=np.float32)
        cases.append((name, q, table, lens))
    return (k, v, page, hkv), cases


def phase_kernels(torch, np):
    import torch.nn.functional as F
    from repro_torch.core.kv_tier import quantize_page_kv
    from repro_torch.kernels import ops

    dev = torch.device(DEVICE)
    (k, v, page, hkv), cases = kernel_cases(torch, np)
    k_t, v_t = torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev)
    pages = {"f32": (k_t, v_t, None, None)}
    for code, dtype, qmax in (("int8", torch.int8, 127.0),
                              ("fp8", torch.float8_e4m3fn, 448.0)):
        kq, ks = quantize_page_kv(k_t, qmax, dtype)
        vq, vs = quantize_page_kv(v_t, qmax, dtype)
        pages[code] = (kq, vq, ks, vs)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    results = []
    for case, q_np, table_np, len_np in cases:
        q = torch.from_numpy(q_np).to(dev)
        table = torch.from_numpy(table_np).to(dev)
        lengths = torch.from_numpy(len_np).to(dev)
        for code, (kp, vp, ks, vs) in pages.items():
            if ks is None:
                def kernel():
                    return ops.paged_attention(q, kp, vp, table, lengths)

                def plain():
                    return ops.ref.paged_attention_ref(q, kp, vp, table,
                                                       lengths)
                kd, vd = kp, vp
            else:
                def kernel():
                    return ops.paged_attention_q8(q, kp, vp, ks, vs, table,
                                                  lengths)

                def plain():
                    return ops.ref.paged_attention_q8_ref(q, kp, vp, ks, vs,
                                                          table, lengths)
                kd = kp.float() * ks[..., None]
                vd = vp.float() * vs[..., None]
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err = float((got - want).abs().max())
            check(bool(torch.isfinite(got).all()), f"{code} {case}: finite")
            check(err <= KERNEL_TOL,
                  f"{code} {case}: max_abs_err {err} > {KERNEL_TOL}")
            zero_rows = lengths == 0
            check(not bool(got[zero_rows].any()), "length-0 rows are zero")
            library_ms = time_ms(torch, library_call(torch, F, q, kd, vd,
                                                     table, lengths, page,
                                                     case), flush)
            kernel_ms = time_ms(torch, kernel, flush)
            plain_ms = time_ms(torch, plain, flush)
            b_ms, b_by = bound(torch, q, table, lengths, page, hkv,
                               kp.element_size(), ks is not None)
            results.append({
                "name": ("paged_attention" if code == "f32"
                         else "paged_attention_q8"),
                "kernel": KERNEL_OF[code], "pages": code, "case": case,
                "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[code], "launches": None,
                "max_abs_err": err, "tolerance": KERNEL_TOL,
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": library_ms,
                "library": "torch.nn.functional.scaled_dot_product_attention"
                           " on the gathered dense K/V"})
            emit({"phase": "kernels", **{k_: results[-1][k_] for k_ in (
                "kernel", "case", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}})
    return results


def library_call(torch, F, q, kd, vd, table, lengths, page, case):
    """One SDPA call on dense K/V gathered (and dequantised) outside the
    timing: per decode row a [S] masked key axis; for the prefill chunk,
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

    n_chunks = n_req * (-(-prompt_len // chunk))
    need = cfg.n_layers * (2 * gen + 2 * n_chunks)
    check(counts["paged_attention_f32"] >= need,
          f"paged_attention_f32 launches {counts['paged_attention_f32']} "
          f"< {need}")
    for code in ("int8", "fp8"):
        check(counts[KERNEL_OF[code]] > 0, f"{KERNEL_OF[code]} launched")
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
          "launches_needed_f32": need,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "note": "smoke run, not a benchmark"})
    return counts


def profile_decode(torch, server, n_steps):
    """Where a horizon-1 decode step's time goes: ``n_steps`` committed
    steps under ``torch.profiler``; device busy time is the sum of the
    kernels' device time (one stream, so they do not overlap), idle share
    the rest of the wall time.  A measurement only: a profiler that fails
    or sees no device time is reported, not fatal."""
    from torch.profiler import ProfilerActivity, profile
    try:
        pending = server.pending_tokens()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n_steps):
                seqs, logits = server.step_batch(pending)
                pending = dict(zip(seqs, logits.argmax(-1).cpu().tolist()))
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
    return {"steps": n_steps, "wall_ms_per_step": wall_ms,
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
    kernels = phase_kernels(torch, np)
    counts = phase_serve(torch, np, smi)
    for entry in kernels:
        entry["launches"] = counts[entry["kernel"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
