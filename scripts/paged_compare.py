"""Compare the paged-attention kernels of two checkouts on one card, timed
the same way.

    python scripts/paged_compare.py [--serve | --serve-only] [--pairs N]
        OTHER_CHECKOUT

``OTHER_CHECKOUT`` is another tree of this repository (for instance the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists).  Each run is a process of its own in one of the
two checkouts, in the order other, this, this, other, repeated ``N``
times (default 1).  A run calls that checkout's own
``chip_smoke.phase_kernels`` (the paged-attention cases at the serving
path's shapes), with this checkout's ``chip_smoke.time_ms`` (device time
behind a sleep kernel, L2 flushed) put in place of the other's, so the
two designs are timed by one method, and times the host's side of one
f32 ``paged_attention`` call at the serve phase's decode shape (the card
held busy meanwhile).  With ``--serve`` the run then drives that
checkout's own ``chip_smoke.phase_serve`` (full-width granite-3-2b paged
serving); ``--serve-only`` drives only that.  Prints one JSON line per
run: the checkout, each case's kernel, case, ms, max_abs_err and
library_ms, the host µs a call, and the serve phase's line.  Card only.
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# host time of one f32 paged_attention call at the serve phase's decode
# shape (B=8, H=32, Hkv=8, D=64, page 16, lengths 513..576, pps 64): 200
# calls enqueued behind a sleep kernel of ~50 ms, so the host never waits
# for the card; median of 7 such rounds, in microseconds a call
HOST_TIMER = """
import statistics, time
from repro_torch.kernels import ops


def host_us(torch, calls=200, rounds=7):
    g = torch.Generator().manual_seed(0)
    kp, vp = (torch.randn(320, 16, 8, 64, generator=g).cuda()
              for _ in range(2))
    q = torch.randn(8, 32, 64, generator=g).cuda()
    table = torch.zeros(8, 64, dtype=torch.int32)
    table[:, :36] = torch.randperm(320, generator=g)[:288].view(8, 36)
    table = table.cuda()
    lengths = torch.tensor([513, 530, 544, 548, 560, 561, 575, 576],
                           dtype=torch.int32).cuda()

    def call():
        return ops.paged_attention(q, kp, vp, table, lengths)
    call()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        torch.cuda._sleep(100_000_000)
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {"wrapper_host_us": statistics.median(per), "rounds_us": per}
"""

CHILD = """
import json, sys
sys.path[:0] = ["src", "."]
import numpy as np, torch
import chip_smoke as cs
from repro_torch.device import resolve_device
resolve_device("cuda")
exec({timer!r}, cs.__dict__)
exec({host_timer!r})
if {kernels}:
    for r in cs.phase_kernels(torch, np):
        print("RESULT " + json.dumps({{k: r.get(k) for k in (
            "kernel", "case", "ms", "max_abs_err", "library_ms")}}),
            flush=True)
    print("HOST " + json.dumps(host_us(torch)), flush=True)
if {serve}:
    cs.phase_serve(torch, np, "")
"""


def _timer_source() -> str:
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return (f"HOLD_CYCLES = {chip_smoke.HOLD_CYCLES}\n" +
            inspect.getsource(chip_smoke.time_ms))


def run(checkout: Path, timer: str, kernels: bool, serve: bool):
    """(kernel results, the host timing, the serve phase's line; None
    where not run) of one checkout."""
    code = CHILD.format(timer=timer, host_timer=HOST_TIMER, kernels=kernels,
                        serve=serve)
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"phases failed in {checkout}:\n"
                           f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.splitlines()

    def tagged(tag):
        return [json.loads(line[len(tag):]) for line in lines
                if line.startswith(tag)]
    host = tagged("HOST ")
    served = [json.loads(line) for line in lines
              if line.startswith('{"phase": "serve"')]
    return (tagged("RESULT "), host[0] if host else None,
            served[0] if served else None)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    pairs = 1
    if "--pairs" in argv:
        i = argv.index("--pairs")
        pairs = int(argv[i + 1])
        del argv[i:i + 2]
    serve_only = "--serve-only" in argv
    serve = serve_only or "--serve" in argv
    rest = [a for a in argv if a not in ("--serve", "--serve-only")]
    if len(rest) != 1 or pairs < 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = Path(rest[0]).resolve()
    timer = _timer_source()
    order = (("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)) * pairs
    for i, (name, tree) in enumerate(order):
        results, host, served = run(tree, timer, not serve_only, serve)
        print(json.dumps({"run": i, "checkout": name, "results": results,
                          "host": host, "serve": served}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
