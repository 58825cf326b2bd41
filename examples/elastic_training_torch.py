"""Elastic training on the PyTorch/CUDA port (the twin of
``examples/elastic_training.py``): node failure -> degraded mesh -> exact
resume.

Train reduced granite-3-2b on an 8-rank ``(data, model)`` mesh of (2, 4)
with params and AdamW state sharded (``param_specs``: FSDP over data,
tensor parallelism over model), checkpoint asynchronously (rank 0 writes
the assembled leaves), "lose" two ranks, rebuild a 6-rank mesh
(``make_elastic_mesh`` keeps the model axis as wide as divides: (3, 2)),
restore the checkpoint **resharded** onto it, re-partition the
deterministic data pipeline, and check that training continues from the
exact same state: the loss trajectory matches a run that restored the
checkpoint onto the healthy (2, 4) mesh (max |delta| < 1e-5).

  python examples/elastic_training_torch.py [--device cpu]

Each phase is a set of ranks spawned by ``launch.mesh.run_ranks`` (gloo;
on ``cuda`` the ranks share the card).  Runs on ``cuda`` unless
``--device cpu`` is given.
"""
import argparse
import importlib
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
# spawned ranks import this module by name
sys.path.insert(0, str(ROOT / "examples"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.data import synthetic_stream  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_elastic_mesh, run_ranks  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402

HEALTHY, DEGRADED, MODEL_PARALLEL = 8, 6, 4
SAVE_AT, RESUMED_STEPS = 6, 4


def batch_for(step, cfg, n_shards, device):
    """Deterministic global batch assembled from per-shard streams."""
    shards = [synthetic_stream(0, step, s, batch=2, seq_len=32,
                               vocab=cfg.vocab_size, kind="learnable")
              for s in range(n_shards)]
    return {k: torch.from_numpy(np.concatenate([s[k] for s in shards]))
            .long().to(device) for k in shards[0]}


def phase(n_ranks: int, ckpt_dir: str, device_type: str) -> dict:
    """One rank of a phase.  ``HEALTHY`` ranks: train ``SAVE_AT`` steps
    on the (2, 4) mesh, save asynchronously, then the reference run: the
    checkpoint restored onto the same mesh, ``RESUMED_STEPS`` steps.
    ``DEGRADED`` ranks: the checkpoint restored onto the degraded mesh,
    ``RESUMED_STEPS`` steps.  Returns the mesh and the losses."""
    device = resolve_device(
        f"cuda:{torch.cuda.current_device()}" if device_type == "cuda"
        else "cpu")
    cfg = get_arch("granite-3-2b").reduced()
    model = get_model(cfg, compute_dtype=torch.float32, remat="none")
    init_fn, upd_fn = adamw(lr=3e-3)
    mesh = make_elastic_mesh(n_ranks, model_parallel=MODEL_PARALLEL,
                             device_type=device_type)
    tstep = make_train_step(model, upd_fn, mesh=mesh)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    specs = shd.param_specs(mesh, params)
    tspecs = {"params": specs, "opt": AdamWState(step=(), m=specs, v=specs)}
    template = {"params": params, "opt": init_fn(params)}
    mgr = CheckpointManager(ckpt_dir, keep=2)
    shape = tuple(mesh.shape)
    rank0 = torch.distributed.get_rank() == 0
    out = {"mesh": shape}

    def run(p, opt, steps, label):
        losses = []
        for step in steps:
            p, opt, m = tstep(p, opt, batch_for(step, cfg, 8, device))
            losses.append(float(m["loss"]))
            if rank0:
                print(f"[{label} {shape}] step {step} loss "
                      f"{losses[-1]:.4f}", flush=True)
        return p, opt, losses

    if n_ranks == HEALTHY:
        p = shd.shard_tree(params, mesh, specs)
        p, opt, out["losses"] = run(p, init_fn(p), range(SAVE_AT),
                                    f"{n_ranks} ranks")
        mgr.save(SAVE_AT, {"params": p, "opt": opt}, blocking=False,
                 mesh=mesh, specs=tspecs)
        mgr.wait()
        if rank0:
            print(f"checkpoint committed at step {SAVE_AT} (async, atomic)",
                  flush=True)
    state = mgr.restore(template, mesh=mesh, specs=tspecs)
    *_, out["resumed"] = run(state["params"], state["opt"],
                             range(SAVE_AT, SAVE_AT + RESUMED_STEPS),
                             f"{n_ranks} ranks")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device_type = resolve_device(args.device).type
    # the ranks unpickle ``phase`` from this module imported by its name
    fn = importlib.import_module(Path(__file__).stem).phase
    with tempfile.TemporaryDirectory() as ckpt:
        # ---- phase 1: healthy fleet (8 ranks, a (2, 4) mesh), and the
        # uninterrupted reference from the checkpoint on the same mesh
        healthy = run_ranks(fn, HEALTHY, (HEALTHY, ckpt, device_type),
                            device_type=device_type)[0]
        # ---- phase 2: two ranks "fail" -> a degraded 6-rank mesh
        degraded = run_ranks(fn, DEGRADED, (DEGRADED, ckpt, device_type),
                             device_type=device_type)[0]
    print(f"healthy mesh {healthy['mesh']}, rebuilt degraded mesh "
          f"{degraded['mesh']}")
    err = max(abs(a - b) for a, b in zip(degraded["resumed"],
                                         healthy["resumed"]))
    print(f"\nresumed-vs-reference loss trajectory max |delta| = {err:.2e}")
    assert err < 1e-5
    print("elastic resume is exact: the degraded fleet continues the run")
    return {"err": err, "healthy_mesh": healthy["mesh"],
            "degraded_mesh": degraded["mesh"],
            "losses": healthy["losses"], "resumed": degraded["resumed"],
            "reference": healthy["resumed"]}


if __name__ == "__main__":
    main()
