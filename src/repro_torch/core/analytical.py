"""Analytical cost terms of the pool-serving control plane.

The port of the serving part of ``repro.core.analytical``:
``control_plane_terms`` prices the admission, placement, free and
migration frames a ``StoragePool`` frontend sent during a serving run,
with the delivery-reliability terms a lossy fabric adds.  The Fig-3 /
Fig-11 models and the rest of the JAX package's module are not ported.
"""
from __future__ import annotations

from typing import Dict


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
