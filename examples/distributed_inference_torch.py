"""Distributed inference across pool nodes with pipeline parallelism, on
the PyTorch/CUDA port (the twin of ``examples/distributed_inference.py``):
a small decoder's layers are partitioned over DockerSSD nodes (PP
stages), each stage runs its layer slice as a containerized task,
activations hop stage to stage through λFS's sharable namespace, and the
pool survives a mid-run node failure.

  python examples/distributed_inference_torch.py [--device cpu]

Runs on ``cuda`` unless ``--device cpu`` is given (attention through the
flash-attention kernel on the card).
"""
import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.core import (SHARABLE_NS, ImageManifest,  # noqa: E402
                              StoragePool, make_blob, register_app)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.models.transformer import layer_params  # noqa: E402

CFG = dataclasses.replace(
    get_arch("granite-3-2b"),
    n_layers=4, d_model=128, n_heads=8, n_kv_heads=4, d_ff=256,
    vocab_size=512)


def register_stage(params, device):
    """Register the ``llm-stage`` app: one pipeline stage runs its slice
    of layers on the activation fetched from its sharable namespace."""
    @register_app("llm-stage")
    def llm_stage(ctx, stage: int = 0, n_stages: int = 2):
        ctx.bind("/act/in.npy")
        h = np.frombuffer(ctx.fs.read("/act/in.npy", SHARABLE_NS),
                          np.float32).reshape(1, -1, CFG.d_model)
        ctx.release("/act/in.npy")
        h = torch.from_numpy(h.copy()).to(device)
        per = CFG.n_layers // n_stages
        with torch.no_grad():
            for li in range(stage * per, (stage + 1) * per):
                lp = layer_params(params["layers"], li)
                a = L.apply_norm(lp["attn_norm"], h, CFG.norm)
                h = h + L.attention_block(lp["attn"], a, CFG)[0]
                m = L.apply_norm(lp["mlp_norm"], h, CFG.norm)
                h = h + L.apply_mlp(lp["mlp"], m, CFG.act)
        ctx.log(f"stage {stage}: ran layers {stage*per}..{(stage+1)*per-1}")
        return h.cpu().numpy()
    return llm_stage


def run_pipeline(pool, placement, params, tokens, device):
    """Drive a microbatch through the stages over the pool."""
    with torch.no_grad():
        h = L.embed_tokens(params["embed"], torch.from_numpy(tokens).to(
            device), torch.float32).cpu().numpy()
    stages = sorted(set(placement.stage_of.values()))
    for stage in stages:
        ip = [i for i in placement.node_ips
              if placement.stage_of[i] == stage][0]
        node = pool.nodes[ip]
        node.fs.write("/act/in.npy", h.tobytes(), SHARABLE_NS, actor="host")
        _, h = node.docker.cmd_run("llm-stage", stage=stage,
                                   n_stages=len(stages))
    with torch.no_grad():
        x = L.apply_norm(params["final_norm"], torch.from_numpy(h).to(device),
                         CFG.norm)
        return L.unembed(params["embed"], params.get("lm_head"), x,
                         CFG.tie_embeddings).cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = get_model(CFG, compute_dtype=torch.float32)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    register_stage(params, device)

    pool = StoragePool(n_nodes=4, extent_cfg={"device": device})
    blob = make_blob(ImageManifest("llm-stage", "llm-stage", ["weights"]),
                     {"weights": b"stage-shard"})
    pool.broadcast_pull("llm-stage", blob)
    pl = pool.place_distributed("llm", "llm-stage", pp=2)
    placed = dict(pl.stage_of)
    print(f"pipeline placement: {placed}")

    tokens = np.asarray([[3, 1, 4, 1, 5, 9, 2, 6]], np.int32)
    logits = run_pipeline(pool, pl, params, tokens, device)

    # verify against the monolithic model
    with torch.no_grad():
        ref, _ = model.forward(params, {"tokens": torch.from_numpy(
            tokens).to(device)})
    ref = ref.cpu().numpy()
    err = float(np.abs(logits - ref).max())
    print(f"pipelined-vs-monolithic max err: {err:.2e}")
    assert err < 1e-3

    # node failure mid-service: reschedule, run again, same answer
    victim = pl.node_ips[0]
    pool.nodes[victim].fail()
    pool.check_heartbeats(now=1e9)
    print(f"failed {victim} -> {pool.events[-1]}")
    logits2 = run_pipeline(pool, pool.placements["llm"], params, tokens,
                           device)
    err2 = float(np.abs(logits2 - ref).max())
    print(f"after reschedule, max err: {err2:.2e}")
    assert err2 < 1e-3
    print("pipelined inference survived the failure with identical output")
    return {"err": err, "err_after_failure": err2, "placement": placed,
            "rescheduled": dict(pool.placements["llm"].stage_of)}


if __name__ == "__main__":
    main()
