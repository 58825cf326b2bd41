"""Analytical distributed-LLM-inference model and the serving cost terms.

The port of ``repro.core.analytical`` (pure Python; numpy for the
geometric means): the paper's Calculon-style simulator, extended, as the
paper did, with a KV-cache model and a DP/TP/PP parallelism sweep.

Reproduces Fig 12a (optimal parallelism per disaggregation model),
Fig 12b (8 LLMs x {H,D} x {NoCache,Cache}), Fig 13a/b (sequence-length
sensitivity: crossover + ~9.5x converged speedup) and Fig 13c/d (batch
sensitivity, <=~1.3x); then the serving terms: the control and data
planes' frame traffic, the KV tier's page movement, and the amortized
models of the fused decode horizon, the prefix cache with chunked
prefill and speculative decoding, with their two-point fitters.

The hardware constants (:class:`HW`) are the paper's prototype: host
DDR4, a DockerSSD's flash channels and its link, calibrated to the
paper's headline ratios.  They describe neither a TPU nor the H100 this
port runs on; the models price the paper's system, and a serving run's
own counters feed the serving terms.

Physical story (paper section "Disaggregated Computing Storage"):
  * H-NoCache — hosts recompute all K/V every step (O(n^2) compute),
    all data in local DRAM.
  * H-Cache  — hosts keep a KV cache; it exceeds DRAM, so the overflow
    lives on a 400 GB SSD behind **Linux swap** (page faults, cache
    pollution, mode switches, extra copies -> low effective bandwidth).
  * D-NoCache — recompute inside DockerSSDs (slower cores: 2.2 vs
    3.8 GHz -> ~1.7x slower than H-NoCache).
  * D-Cache  — KV cache on flash **local to the compute**, accessed as
    memory through λFS at aggregate multi-channel bandwidth — no swap
    machinery.  This is the paper's headline winner (~7.9x over
    H-Cache).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Tuple

# ---------------------------------------------------------------------------
# model zoo of the paper's LLM case study (public configs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LLM:
    name: str
    n_params: float
    n_layers: int
    d_model: int
    n_heads: int


POOL_LLMS = [
    LLM("lamda-137B", 137e9, 64, 8192, 128),
    LLM("gpt3-175B", 175e9, 96, 12288, 96),
    LLM("jurassic-178B", 178e9, 76, 13824, 96),
    LLM("pangu-200B", 200e9, 64, 16384, 128),
    LLM("gopher-280B", 280e9, 80, 16384, 128),
    LLM("turing-530B", 530e9, 105, 20480, 128),
    LLM("palm-540B", 540e9, 118, 18432, 48),
    LLM("megatron-1T", 1000e9, 128, 25600, 160),
]


# ---------------------------------------------------------------------------
# hardware constants (calibrated to the paper's prototype numbers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HW:
    """Calibrated against the paper's headline numbers (random-search fit;
    see benchmarks/calibrate.py).  Achieved vs paper:
      D-Cache/H-Cache 7.3 (7.9) | H-Cache/H-NoCache 420 (421)
      D-Cache/D-NoCache 4.8K (4.6K) | D-Cache/H-NoCache 3.1K (3.2K)
      D-NoCache slowdown 1.6x (1.7x) | crossover lamda 256 (256),
      megatron 512 (1024) | converged speedup 9.6x (~9.5x)."""
    # compute (effective dense FLOP/s per node; CPU-class inference path)
    host_flops: float = 2.953e11        # 3.8 GHz host
    ssd_flops: float = 1.902e11         # 2.2 GHz frontend (~1.6x slower)
    # memory paths
    dram_bw: float = 1.080e10           # host DDR4 effective
    dram_gb: float = 64.0               # per host node
    swap_eff_bw: float = 8.73e8         # Linux swap: page-fault + copy +
    #                                     cache-pollution machinery
    flash_local_bw: float = 1.331e10    # 12-channel aggregate, λFS direct
    ssd_dram_gb: float = 2.0
    # interconnect (TP collectives / PP boundaries)
    link_bw: float = 2.576e10
    bytes_per = 2                       # bf16
    # "all other data is also maintained in memory": framework + weight
    # copies occupy DRAM beyond the raw fp16 weights
    weight_overhead: float = 1.255
    # the KV region is allocated swap-backed from the start: most of it
    # pays page machinery even when DRAM-resident
    swap_floor: float = 0.773


# ---------------------------------------------------------------------------
# single-step latency model
# ---------------------------------------------------------------------------


# effective bytes per stored KV element by page format (runtime.serve's
# ``page_dtype`` knob); quantized formats add the per-slot f32 scale,
# amortized over the head_dim lanes it covers
PAGE_DTYPE_BYTES = {"fp32": 4.0, "bf16": 2.0, "int8": 1.0, "fp8": 1.0}


def page_dtype_bytes_per_elem(page_dtype: str, head_dim: int = 128) -> float:
    base = PAGE_DTYPE_BYTES[page_dtype]
    if page_dtype in ("int8", "fp8"):
        base += 4.0 / max(head_dim, 1)
    return base


def kv_bytes_per_token(m: LLM, hw: HW, page_dtype: str = None) -> float:
    """KV bytes per cached token.  Default prices at ``hw.bytes_per``
    (the calibrated bf16 story); passing a page format prices at that
    format's code+scale size — the knob the Fig-13 sensitivity sweeps
    turn to see quantization shift the D/H crossover."""
    if page_dtype is None:
        return 2 * m.n_layers * m.d_model * hw.bytes_per
    hd = max(m.d_model // max(m.n_heads, 1), 1)
    return 2 * m.n_layers * m.d_model * page_dtype_bytes_per_elem(
        page_dtype, hd)


def step_time(m: LLM, *, t: int, batch: int, dp: int, tp: int, pp: int,
              cache: bool, device: str, hw: HW = HW(),
              page_dtype: str = None) -> Dict[str, float]:
    """Latency of generating token t (context length t), per microstep.

    Returns dict with compute/memory/comm components (seconds).
    """
    flops_dev = hw.host_flops if device == "host" else hw.ssd_flops
    b_local = max(1, batch // dp)

    attn = 4 * m.n_layers * m.d_model            # attention MACs/token/ctx
    if cache:
        flops = (2 * m.n_params + attn * t) * b_local   # one token forward
        kv_read = kv_bytes_per_token(m, hw, page_dtype) * t * b_local
    else:
        # recompute the whole prefix: O(t) weight flops + O(t^2) attention
        flops = (2 * m.n_params * t + attn * t * t) * b_local
        kv_read = 0.0

    # Parallelism semantics (the reason Fig 12a flips):
    #  * cache (one token/step): the token passes PP stages *sequentially*
    #    -> pp does NOT divide per-token latency; only tp does.  pp still
    #    divides per-node weight footprint (capacity -> less swap).
    #  * nocache (recompute t tokens): the prefix streams through the
    #    pipeline as microbatches -> pp divides latency with efficiency
    #    t/(t+pp-1).
    weight_read = m.n_params * hw.bytes_per / tp      # summed across stages
    if cache:
        div = tp
    else:
        pipe_eff = t / (t + pp - 1)
        div = tp * pp * pipe_eff
    compute = flops / (flops_dev * div)

    # memory path.  KV reads: per-node footprint is /(tp*pp) (capacity),
    # but a decoded token reads the KV of *every* stage sequentially, so
    # the latency-relevant read volume divides by tp only.
    if device == "host":
        if cache:
            kv_total_gb = (kv_bytes_per_token(m, hw, page_dtype) * t *
                           b_local / (tp * pp) / 1e9)
            # DP replicates weights; only tp*pp shrinks the footprint
            dram_free = max(hw.dram_gb - hw.weight_overhead * m.n_params *
                            hw.bytes_per / (tp * pp) / 1e9, 0.5)
            swap_frac = max(hw.swap_floor,
                            1.0 - dram_free / max(kv_total_gb, 1e-9))
            mem = (kv_read / tp) * (
                (1 - swap_frac) / hw.dram_bw + swap_frac / hw.swap_eff_bw)
        else:
            mem = 0.0
        mem += weight_read / hw.dram_bw
    else:
        bw = hw.flash_local_bw
        mem = (kv_read / tp) / bw + weight_read / bw

    # communication: TP all-reduce twice per layer on the activations of
    # the tokens being processed; PP passes boundary activations
    tokens_proc = b_local * (t if not cache else 1)
    act = tokens_proc * m.d_model * hw.bytes_per
    comm = 0.0
    if tp > 1:
        comm += 2 * m.n_layers / pp * 2 * (tp - 1) / tp * act / hw.link_bw
    if pp > 1:
        comm += (pp - 1) * act / hw.link_bw
    return {"compute": compute, "memory": mem, "comm": comm,
            "total": compute + mem + comm}


def generation_time(m: LLM, *, seq_len: int, batch: int, dp: int, tp: int,
                    pp: int, cache: bool, device: str, hw: HW = HW(),
                    page_dtype: str = None,
                    sample_points: int = 24) -> Dict[str, float]:
    """Total time to generate ``seq_len`` tokens (trapezoidal sampling of
    the per-step cost over t)."""
    ts = sorted({max(1, int(seq_len * i / sample_points))
                 for i in range(sample_points + 1)})
    comp = mem = comm = 0.0
    prev_t = 0
    for t in ts:
        st = step_time(m, t=t, batch=batch, dp=dp, tp=tp, pp=pp,
                       cache=cache, device=device, hw=hw,
                       page_dtype=page_dtype)
        w = t - prev_t
        comp += st["compute"] * w
        mem += st["memory"] * w
        comm += st["comm"] * w
        prev_t = t
    return {"compute": comp, "memory": mem, "comm": comm,
            "total": comp + mem + comm}


# ---------------------------------------------------------------------------
# parallelism sweep (Fig 12a)
# ---------------------------------------------------------------------------


def factorizations(n: int) -> List[Tuple[int, int, int]]:
    out = []
    for dp in [2 ** i for i in range(int(math.log2(n)) + 1)]:
        if n % dp:
            continue
        rest = n // dp
        for tp in [2 ** i for i in range(int(math.log2(rest)) + 1)]:
            if rest % tp:
                continue
            out.append((dp, tp, rest // tp))
    return out


def best_parallelism(m: LLM, *, n_nodes: int, seq_len: int, batch: int,
                     cache: bool, device: str, hw: HW = HW(),
                     page_dtype: str = None):
    """Sweep (dp, tp, pp); return (best cfg, its time breakdown)."""
    best, best_t = None, None
    for dp, tp, pp in factorizations(n_nodes):
        if dp > max(batch, 1):
            continue
        if pp > m.n_layers:
            continue
        if device == "host":
            # hard capacity: the weight shard must fit host DRAM
            w_gb = hw.weight_overhead * m.n_params * hw.bytes_per / (tp * pp) / 1e9
            if w_gb > hw.dram_gb:
                continue
        else:
            # DockerSSD: the weight shard must fit the node's 400GB flash.
            # (KV extents can span the pool's aggregate flash via λFS —
            # the disaggregated-storage point of the paper.)
            w_gb = m.n_params * hw.bytes_per / (tp * pp) / 1e9
            if w_gb > 400.0:
                continue
        t = generation_time(m, seq_len=seq_len, batch=batch, dp=dp, tp=tp,
                            pp=pp, cache=cache, device=device, hw=hw,
                            page_dtype=page_dtype)
        if best_t is None or t["total"] < best_t["total"]:
            best, best_t = (dp, tp, pp), t
    return best, best_t


# ---------------------------------------------------------------------------
# the four disaggregation configurations (Fig 12b)
# ---------------------------------------------------------------------------

CONFIGS = ["H-NoCache", "H-Cache", "D-NoCache", "D-Cache"]


def config_args(config: str):
    return {"cache": config.endswith("-Cache"),
            "device": "host" if config.startswith("H") else "ssd"}


def nodes_for(m: LLM) -> int:
    """16..128 DockerSSDs/hosts depending on model size (paper setup).
    Sized so the fp16 weights (+ framework overhead) fit the host fleet's
    DRAM when fully model-parallel (the H-* configurations must have at
    least one feasible parallelization)."""
    hw = HW()
    w_gb = hw.weight_overhead * m.n_params * hw.bytes_per / 1e9
    need = max(16.0, w_gb / hw.dram_gb, m.n_params * 2 / 350e9)
    return int(min(128, 2 ** math.ceil(math.log2(need))))


def evaluate_pool(seq_len: int = 32768, batch_per_node: int = 1,
                  hw: HW = HW()):
    """Fig 12: for each LLM x config, optimal parallelism + breakdown."""
    results = {}
    for m in POOL_LLMS:
        n = nodes_for(m)
        batch = batch_per_node * n
        row = {}
        for config in CONFIGS:
            ca = config_args(config)
            best, t = best_parallelism(m, n_nodes=n, seq_len=seq_len,
                                       batch=batch, hw=hw, **ca)
            row[config] = {"parallelism": best, "time": t}
        results[m.name] = {"nodes": n, "configs": row}
    return results


def headline_ratios(results) -> Dict[str, float]:
    """The paper's claims: D-Cache/H-Cache ~7.9x, H-Cache/H-NoCache ~421x,
    D-Cache/D-NoCache ~4.6Kx, D-Cache/H-NoCache ~3.2Kx, D-NoCache ~1.7x
    slower than H-NoCache."""
    import numpy as np
    g = lambda xs: float(np.exp(np.mean(np.log(xs))))
    r = {}
    r["d_cache_vs_h_cache"] = g([v["configs"]["H-Cache"]["time"]["total"] /
                                 v["configs"]["D-Cache"]["time"]["total"]
                                 for v in results.values()])
    r["h_cache_vs_h_nocache"] = g([v["configs"]["H-NoCache"]["time"]["total"] /
                                   v["configs"]["H-Cache"]["time"]["total"]
                                   for v in results.values()])
    r["d_cache_vs_d_nocache"] = g([v["configs"]["D-NoCache"]["time"]["total"] /
                                   v["configs"]["D-Cache"]["time"]["total"]
                                   for v in results.values()])
    r["d_cache_vs_h_nocache"] = g([v["configs"]["H-NoCache"]["time"]["total"] /
                                   v["configs"]["D-Cache"]["time"]["total"]
                                   for v in results.values()])
    r["d_nocache_slowdown_vs_h"] = g(
        [v["configs"]["D-NoCache"]["time"]["total"] /
         v["configs"]["H-NoCache"]["time"]["total"] for v in results.values()])
    return r


# ---------------------------------------------------------------------------
# serving control-plane traffic (pool frontend over Ether-oN)
# ---------------------------------------------------------------------------


def control_plane_terms(ether_stats, n_tokens: int) -> Dict[str, float]:
    """Traffic terms for the pool-serving control plane.

    ``ether_stats`` is the frontend driver's ``EtherONStats`` after a
    serving run: admission/placement/free messages ride 0xE0/0xE1 frames
    (cost-accounted per operation, like Fig 3's docker-cli path), while
    the token-rate tensor traffic stays on the device and never shows
    up here.  The per-token figures quantify the paper's claim that the
    control plane is off the serving hot path — a few frames per
    *sequence*, amortized to noise per generated token.  On a lossy
    fabric the reliability terms price what delivery actually cost:
    retransmitted frames, checksum NACKs, dedup hits and the virtual
    time spent in retransmit backoff (all exactly zero fault-free)."""
    toks = max(int(n_tokens), 1)
    wire = ether_stats.bytes_tx + ether_stats.bytes_rx
    terms = {
        "control_frames": float(ether_stats.control_frames),
        "frames_per_1k_tokens":
            1e3 * ether_stats.control_frames / toks,
        "wire_bytes": float(wire),
        "wire_bytes_per_token": wire / toks,
        "us_total": float(ether_stats.time_us),
        "us_per_token": ether_stats.time_us / toks,
    }
    terms.update(reliability_terms(ether_stats))
    terms.update(migration_terms(ether_stats, toks))
    return terms


def migration_terms(ether_stats, n_tokens: int) -> Dict[str, float]:
    """Elastic-drain (warm-path live migration) cost terms.

    One MIGRATE frame per page moved device-to-device off a draining
    node; ``migrate_bytes`` are the moved page payloads (they move on
    the device, not over the host fabric, but the copy cost is priced into the
    driver's virtual time).  Every term is exactly zero on a static
    pool — the elastic suite pins that, the same discipline as the
    reliability counters.  ``getattr`` keeps pre-elastic stats objects
    (or mocks) pricing as a static pool."""
    toks = max(int(n_tokens), 1)
    frames = float(getattr(ether_stats, "migrate_frames", 0))
    mbytes = float(getattr(ether_stats, "migrate_bytes", 0))
    return {
        "migrate_frames": frames,
        "migrate_frames_per_1k_tokens": 1e3 * frames / toks,
        "migrate_bytes": mbytes,
        "migrate_bytes_per_token": mbytes / toks,
    }


def reliability_terms(ether_stats) -> Dict[str, float]:
    """Delivery-reliability cost terms shared by the control- and
    data-plane breakdowns (``getattr`` so pre-reliability stats objects
    — or mocks — price as a clean fabric)."""
    backoff = float(getattr(ether_stats, "backoff_us", 0.0))
    time_us = float(getattr(ether_stats, "time_us", 0.0))
    return {
        "retransmits": float(getattr(ether_stats, "retransmits", 0)),
        "nacks": float(getattr(ether_stats, "nacks", 0)),
        "dup_frames": float(getattr(ether_stats, "dup_frames", 0)),
        "backoff_us": backoff,
        # fraction of the fabric's virtual time lost to retry waits —
        # the goodput tax the fault plan levied
        "backoff_frac": backoff / time_us if time_us > 0 else 0.0,
    }


def horizon_amortized_terms(n_tokens: int, horizon: int,
                            host_overhead_s: float,
                            device_step_s: float) -> Dict[str, float]:
    """Amortized control-plane model of the fused decode horizon.

    The per-token decode path pays one host interaction per generated
    token (page-table planning, kernel dispatch, the logits/argmax
    transfer); the fused horizon pays it once per ``horizon`` tokens
    while the on-device token loop runs uninterrupted.  With
    ``host_overhead_s`` the cost of one host interaction and
    ``device_step_s`` the on-device per-token cost, generating
    ``n_tokens`` costs::

        ceil(n_tokens / horizon) * host_overhead_s
            + n_tokens * device_step_s

    — the H-fold amortization that turns control-plane cost into noise,
    the serving-side analogue of batching docker-cli ops into one
    Ether-oN frame.  The two constants are measurable from any pair of
    horizon runs (two equations, two unknowns)."""
    toks = max(int(n_tokens), 1)
    h = max(int(horizon), 1)
    interactions = -(-toks // h)
    total = interactions * host_overhead_s + toks * device_step_s
    per_token_h1 = host_overhead_s + device_step_s
    return {
        "horizon": float(h),
        "host_interactions": float(interactions),
        "interactions_per_token": interactions / toks,
        "host_s_per_token": interactions * host_overhead_s / toks,
        "modeled_tokens_per_s": toks / total,
        "modeled_speedup_vs_h1": per_token_h1 * toks / total,
    }


def prefix_chunk_terms(n_prompt: int, n_cached: int, chunk: int,
                       host_overhead_s: float,
                       token_prefill_s: float) -> Dict[str, float]:
    """Amortized admission model of the shared-prefix cache + chunked
    prefill.

    Cold admission computes every prompt token through
    ``ceil(n_prompt / chunk)`` chunk calls; a warm admission
    computes only the uncached suffix (``n_prompt - n_cached`` tokens —
    the cached pages are refcount shares, zero compute and zero data
    movement, the redundancy DockerSSD's disaggregated pool exists to
    eliminate).  With ``host_overhead_s`` the cost of one host
    interaction (page planning, kernel dispatch, the logits transfer) and
    ``token_prefill_s`` the per-token device cost::

        admission(n) = ceil(n / chunk) * host_overhead_s
                         + n * token_prefill_s

    The chunk term also bounds how long an admission can stall the
    in-flight decode horizons: one chunk, not one prompt — the
    admission-side analogue of the decode horizon's H-fold
    amortization."""
    prompt = max(int(n_prompt), 1)
    cached = min(max(int(n_cached), 0), prompt - 1)
    ch = max(int(chunk), 1)

    def admission_s(n):
        return -(-n // ch) * host_overhead_s + n * token_prefill_s

    cold = admission_s(prompt)
    warm = admission_s(prompt - cached)
    one_shot_stall = host_overhead_s + prompt * token_prefill_s
    return {
        "prompt_tokens": float(prompt),
        "cached_tokens": float(cached),
        "prefix_hit_rate": cached / prompt,
        "chunk": float(ch),
        "cold_admission_s": cold,
        "warm_admission_s": warm,
        "modeled_warm_speedup": cold / max(warm, 1e-12),
        "max_decode_stall_s": host_overhead_s + ch * token_prefill_s,
        "one_shot_stall_s": one_shot_stall,
        "stall_reduction": one_shot_stall /
            max(host_overhead_s + ch * token_prefill_s, 1e-12),
    }


def fit_prefill_overheads(n_a: int, chunks_a: int, t_a: float,
                          n_b: int, chunks_b: int,
                          t_b: float) -> Tuple[float, float]:
    """Solve (host_overhead_s, token_prefill_s) from two measured
    admissions: t = n_chunks * host_overhead_s + n_tokens *
    token_prefill_s (two equations, two unknowns — the prefill-side
    sibling of :func:`fit_horizon_overheads`)."""
    det = chunks_a * n_b - chunks_b * n_a
    if det == 0:
        raise ValueError("need two admissions with independent "
                         "(chunks, tokens) mixes to fit")
    host = (t_a * n_b - t_b * n_a) / det
    host = max(host, 0.0)
    tok = max((t_a - chunks_a * host) / max(n_a, 1), 0.0)
    return host, tok


def fit_horizon_overheads(h_a: int, tok_s_a: float, h_b: int,
                          tok_s_b: float) -> Tuple[float, float]:
    """Solve (host_overhead_s, device_step_s) from two measured horizon
    runs: per-token time t(H) = host_overhead_s / H + device_step_s."""
    if h_a == h_b:
        raise ValueError("need two distinct horizons to fit")
    ta, tb = 1.0 / tok_s_a, 1.0 / tok_s_b
    host = max((ta - tb) / (1.0 / h_a - 1.0 / h_b), 0.0)
    # derive dev from the CLAMPED host so the pair stays consistent
    # with the measurements even when noise inverts the two cells
    # (host clamps to 0 -> dev falls back to the faster measured rate)
    dev = min(max(ta - host / h_a, 0.0), min(ta, tb))
    return host, dev


def speculative_terms(n_tokens: int, horizon: int, alpha: float,
                      host_overhead_s: float,
                      verify_pos_s: float) -> Dict[str, float]:
    """Amortized model of speculative decoding on the fused-horizon
    scaffold (the draft-verify loop of ``spec_horizon_batch``).

    One pass drafts ``horizon - 1`` candidates and verifies them in a
    single chunk-shaped forward (``horizon`` query positions through
    one layer scan), then commits the longest accepted prefix plus the
    bonus token.  With per-candidate acceptance rate ``alpha`` the
    expected tokens per pass is the truncated geometric sum::

        E[tokens/pass] = 1 + alpha + alpha^2 + ... + alpha^(H-1)
                       = (1 - alpha^H) / (1 - alpha)

    (H at alpha=1 — every candidate lands; 1 at alpha=0 — every pass
    still nets its bonus token).  A pass costs one host interaction
    (``host_overhead_s`` — planning, dispatch, the packed transfer)
    plus ``horizon * verify_pos_s`` of device compute (every position
    runs the full stack whether accepted or not), so::

        t(n) = passes * (host_overhead_s + horizon * verify_pos_s),
        passes = ceil(n / E[tokens/pass])

    ``modeled_speedup_vs_horizon`` compares against the plain fused
    horizon at the same H (one forward per token, one host interaction
    per H tokens) — the BENCH_serve cell's baseline.  Above ~1/H
    effective acceptance the pass wins; at alpha=0 it degrades toward
    1/H, which is why ``spec_horizon_batch`` falls back to the plain
    horizon when no sequence can draft."""
    toks = max(int(n_tokens), 1)
    h = max(int(horizon), 1)
    a = min(max(float(alpha), 0.0), 1.0)
    exp_tokens = float(h) if a >= 1.0 else (1.0 - a ** h) / (1.0 - a)
    passes = -(-toks // max(exp_tokens, 1e-9))
    total = passes * (host_overhead_s + h * verify_pos_s)
    # plain fused horizon on the same budget: one forward per token,
    # one host interaction per H tokens
    plain = (-(-toks // h)) * host_overhead_s + toks * verify_pos_s
    return {
        "horizon": float(h),
        "alpha": a,
        "expected_tokens_per_pass": exp_tokens,
        "passes": float(passes),
        "modeled_tokens_per_s": toks / max(total, 1e-12),
        "modeled_speedup_vs_horizon": plain / max(total, 1e-12),
    }


def fit_speculation_overheads(h_a: int, tokens_per_pass_a: float,
                              tok_s_a: float, h_b: int,
                              tokens_per_pass_b: float,
                              tok_s_b: float) -> Tuple[float, float]:
    """Solve (host_overhead_s, verify_pos_s) from two measured
    speculative runs with different draft lengths: per-pass time
    t(H) = host_overhead_s + H * verify_pos_s, and the measured
    tokens/s gives t(H) = tokens_per_pass / tok_s (two equations, two
    unknowns — the speculation sibling of
    :func:`fit_horizon_overheads`, with the same clamping discipline
    when noise inverts the cells)."""
    if h_a == h_b:
        raise ValueError("need two distinct draft lengths to fit")
    ta = tokens_per_pass_a / tok_s_a        # measured seconds per pass
    tb = tokens_per_pass_b / tok_s_b
    pos = max((ta - tb) / float(h_a - h_b), 0.0)
    host = min(max(ta - h_a * pos, 0.0), min(ta, tb))
    return host, pos


def kv_tier_terms(tier_stats, hw: HW = HW()) -> Dict[str, float]:
    """Tier-traffic terms from a serving run's ``tier_stats()``
    aggregate: host<->HBM KV page movement, priced dtype-aware (a
    quantized page ships its codes+scales, never an inflated f32 copy —
    the counters already reflect that).  ``modeled_tier_s`` prices the
    movement at the D-Cache λFS flash path, the tier the host window
    spills to in the paper's placement."""
    moved = float(tier_stats.get(
        "kv_bytes_moved",
        tier_stats.get("bytes_in", 0) + tier_stats.get("bytes_out", 0)))
    page_bytes = float(tier_stats.get("page_bytes", 0) or 0)
    return {
        "kv_bytes_moved": moved,
        "page_bytes": page_bytes,
        "pages_moved": moved / page_bytes if page_bytes else 0.0,
        "bytes_in": float(tier_stats.get("bytes_in", 0)),
        "bytes_out": float(tier_stats.get("bytes_out", 0)),
        "modeled_tier_s": moved / hw.flash_local_bw,
    }


def data_plane_terms(ether_stats, bytes_scanned: int,
                     n_jobs: int) -> Dict[str, float]:
    """Traffic terms for the analytics data plane (ISP job offload).

    ``ether_stats`` is the driver's ``EtherONStats`` after an offload
    run: JOB submissions and RESULTS aggregates ride 0xE0/0xE1 frames,
    cost-accounted per operation exactly like Fig 3's docker-cli path.
    ``bytes_scanned`` is what the host baseline would have moved;
    ``reduction_ratio`` quantifies the paper's first headline claim —
    ship the operator to the data and only the aggregate crosses the
    wire."""
    jobs = max(int(n_jobs), 1)
    wire = ether_stats.bytes_tx + ether_stats.bytes_rx
    terms = {
        "job_frames": float(ether_stats.job_frames),
        "result_bytes": float(ether_stats.result_bytes),
        "wire_bytes": float(wire),
        "wire_bytes_per_job": wire / jobs,
        "us_total": float(ether_stats.time_us),
        "us_per_job": ether_stats.time_us / jobs,
        "reduction_ratio": bytes_scanned / max(wire, 1),
    }
    terms.update(reliability_terms(ether_stats))
    return terms


# ---------------------------------------------------------------------------
# sensitivity sweeps (Fig 13)
# ---------------------------------------------------------------------------


def seq_sensitivity(model_name: str, seq_lens=None, hw: HW = HW()):
    """D-Cache vs H-Cache speedup across sequence lengths; crossover is
    where speedup crosses 1.0."""
    m = next(x for x in POOL_LLMS if x.name == model_name)
    n = nodes_for(m)
    seq_lens = seq_lens or [64, 128, 256, 512, 1024, 2048, 4096, 8192,
                            16384, 32768, 65536, 131072]
    out = []
    for s in seq_lens:
        _, th = best_parallelism(m, n_nodes=n, seq_len=s, batch=n,
                                 cache=True, device="host", hw=hw)
        _, td = best_parallelism(m, n_nodes=n, seq_len=s, batch=n,
                                 cache=True, device="ssd", hw=hw)
        out.append({"seq_len": s, "h_cache": th["total"],
                    "d_cache": td["total"],
                    "speedup": th["total"] / td["total"]})
    return out


def crossover_point(rows) -> int:
    for r in rows:
        if r["speedup"] >= 1.0:
            return r["seq_len"]
    return -1


def batch_sensitivity(model_name: str, seq_len: int = 8192,
                      batches=(1, 4, 16, 64, 256, 512), hw: HW = HW()):
    m = next(x for x in POOL_LLMS if x.name == model_name)
    n = nodes_for(m)
    out = []
    for b in batches:
        _, th = best_parallelism(m, n_nodes=n, seq_len=seq_len, batch=b * n,
                                 cache=True, device="host", hw=hw)
        _, td = best_parallelism(m, n_nodes=n, seq_len=seq_len, batch=b * n,
                                 cache=True, device="ssd", hw=hw)
        out.append({"batch_per_node": b, "speedup": th["total"] / td["total"]})
    return out
