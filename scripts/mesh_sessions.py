"""Sessions of the model code on a ``(pod, data, model)`` mesh of ranks:
the harness of ``tests/test_torch_mesh*.py`` and of ``chip_smoke.py``'s
``mesh`` phase.  A spec's ``mesh`` is its shape; its axes are
``spec["axes"]``, else the last ``len(mesh)`` of ``(pod, data, model)``
(``(2, 2)`` is ``(data, model)``, ``(2, 2, 2)`` all three).

``mesh_sessions(specs)`` runs each spec in this rank (spawned by
``repro_torch.launch.mesh.run_ranks``, every rank of the group on the
spec's mesh) and returns one result a spec.  Kinds:

  * ``"train"``: ``make_train_step(..., mesh=)`` for ``len(batches)``
    steps from this rank's shards (``shard_tree`` under ``param_specs``),
    the gradients fed to AdamW at the first step captured; rank 0 returns
    the gathered params, gradients, moments (and residuals) where
    ``keep``;
  * ``"serve"``: ``make_serving_fns(model, mesh)``: a prefill of
    ``prompts`` into a cache of ``cache_len`` positions sequence-sharded
    over ``model`` (or a given whole cache, ``cache``, sharded by
    ``cache_spec_shardings``), then ``gen`` greedy decode steps;
  * ``"save"`` / ``"restore"``: a checkpoint of this rank's shards, and
    its restore onto this spec's mesh, held to the weights bit for bit;
  * ``"roundtrip"``: ``gather_tree(shard_tree(x))`` bit-equal to ``x`` for
    the params and an AdamW state;
  * ``"bad_mesh"``: a mesh of fewer ranks than the group must raise;
  * ``"pipeline"``: ``runtime.pipeline_par.make_pipeline_loss`` on a
    ``(pod, data)`` mesh (``axes``), the loss and its gradients from this
    rank's stage params, gathered whole (rank 0 returns them where
    ``keep``); with ``model_code`` also the model code's loss placed on
    the same mesh (``model.on_mesh``: the batch over ``(pod, data)``).

With ``twin`` rank 0 also runs the same work in one process
(``mesh=None``) on the same weights and holds the mesh's result to it
(:func:`step_check` for the params after a step); a failed check raises.
Every rank reports its collectives (calls and bytes by kind), times,
peak card memory and kernel launches.  Spawned ranks import this module
by name, so put ``scripts/`` on ``sys.path`` first::

    sys.path.insert(0, "scripts"); sys.path.insert(0, "src")
    from mesh_sessions import mesh_sessions
    run_ranks(mesh_sessions, 4, ([spec, ...],), device_type="cpu")
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.mesh import MESH_AXES, MeshPlacement, make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models.api import get_model
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamWState, tree_leaves, tree_map
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.pipeline_par import (gather_stages,
                                              make_pipeline_loss,
                                              stage_params)
from repro_torch.runtime.serve import make_serving_fns
from repro_torch.runtime.train import (gather_data, make_train_step,
                                       split_rows)

LOSS_RTOL = 1e-5           # f32 both sides; only summation orders differ
GRAD_TOL = 1e-4            # times max(1, max |g_ref|), per leaf
STEP_TOL = dict(atol=2e-5, rtol=2e-4)   # tests/test_train.py's own
NORM_RTOL = 1e-5           # the pre-clip grad_norm against one process
LOGIT_TOL = 1e-4           # tests/test_sharding_multidev.py's decode bound
FLOOR_X = 3                # times the one-process path's own spread
ADAM_EPS = 1e-8            # optim.adamw's default


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


def _f64(x, device) -> torch.Tensor:
    """``x`` (a tensor or an array) in float64 on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.detach().to(device, torch.float64)


def step_check(got, want, g_ref, lr: float, *, eps: float = ADAM_EPS,
               grad_tol: float = GRAD_TOL, atol: float = STEP_TOL["atol"],
               rtol: float = STEP_TOL["rtol"], band: float = 1.0,
               g_delta=None) -> dict:
    """Hold params after one AdamW step (``got``) to the reference's
    (``want``), the trees keyed alike (tensors or arrays).  Every limit
    comes from the reference's side: its params, and its gradient fed
    to the update (``g_ref``, after clipping).

    Every element is held to ``atol + rtol * |want|``, but for the
    elements whose reference gradient is below ``band * eps``.  AdamW's
    first step moves an element by ``lr * (f(g) + wd * p)``, ``f(g) = g /
    (|g| + eps)``; the decay term is the same on both sides, ``|f| < 1``
    and the slope of ``f`` is ``eps / (|g| + eps)**2 <= 1 / eps``.  A
    gradient held to ``|g - g_ref| <= delta``, ``delta = grad_tol *
    max(1, max |g_ref| of the leaf)``, therefore moves the element by at
    most ``lr * min(2, delta / eps)`` more or less than the reference;
    near ``g = 0`` that slope is reached, so an element with ``|g_ref| <
    band * eps`` is held to that bound plus the comparison's own.  Past
    the band the slope is below ``1 / ((band + 1)**2 eps)``: a gradient
    gap ``gamma`` moves the step by less than ``lr * gamma / ((band +
    1)**2 eps)``, which ``atol`` has to hold.

    ``g_delta`` ({leaf path: an array like ``g_ref``'s leaf}: how far the
    gradient check lets each element of the tested gradient lie from
    ``g_ref``, such as one int8 step of the reference's row scale):
    every element also takes
    ``lr * min(2, g_delta * s)``, ``s`` the largest slope of ``f`` within
    ``g_delta`` of ``g_ref``.  Returns {"elements", "exempt" (how many
    took the band's bound), "worst" (largest error over its limit),
    "worst_leaf"}; raises ``AssertionError`` where an element is past
    its limit."""
    n = exempt = 0
    worst, worst_leaf = 0.0, None
    for path, g, w in _pairs(got, want):
        gr = _leaf(g_ref, path)
        dev = _device_of(w, g)
        delta = grad_tol * max(1.0, float(_flat(gr).abs().max()))
        d_all = None if g_delta is None else _flat(g_delta[path])
        for at, (gc, wc, grc) in _chunked(dev, g, w, gr):
            lim = atol + rtol * wc.abs()
            small = grc.abs() < band * eps
            lim = torch.where(small, lim + lr * min(2.0, delta / eps), lim)
            if d_all is not None:
                d = (d_all if d_all.numel() == 1 else
                     d_all[at:at + CHUNK]).to(dev, torch.float64)
                slope = eps / ((grc.abs() - d).clamp(min=0) + eps) ** 2
                lim = lim + lr * (d * slope).clamp(max=2.0)
            err = (gc - wc).abs()
            ratio = float((err / lim).max()) if err.numel() else 0.0
            if ratio > worst:
                worst, worst_leaf = ratio, path
            bad = int((err > lim).sum())
            if bad:
                i = int(torch.argmax(err - lim))
                raise AssertionError(
                    f"{path}: {bad} elements past the step bound; element "
                    f"{at + i}: got {float(gc[i])!r}, want {float(wc[i])!r}, "
                    f"limit {float(lim[i])!r}, reference gradient "
                    f"{float(grc[i])!r}")
            n += err.numel()
            exempt += int(small.sum())
    return {"elements": n, "exempt": exempt, "worst": worst,
            "worst_leaf": worst_leaf}


#: elements a comparison moves to its device at once, in float64
CHUNK = 1 << 25


def _device_of(*xs):
    """The card of the first of ``xs`` on one (a check runs there), else
    the CPU."""
    for x in xs:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return torch.device("cpu")


def _flat(x) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.detach().reshape(-1)


def _chunked(dev, *xs):
    """(offset, the float64 chunks on ``dev``) over the flattened
    ``xs``."""
    flats = [_flat(x) for x in xs]
    for at in range(0, flats[0].numel(), CHUNK):
        yield at, [f[at:at + CHUNK].to(dev, torch.float64) for f in flats]


def _leaf(tree, path):
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree


def grads_check(got, want, tol: float = GRAD_TOL, floors=None) -> float:
    """Each leaf within ``tol * max(1, max |want|)``, or the leaf's
    ``floors[path]`` where that is larger; returns the largest error over
    its limit (raises past 1)."""
    worst = 0.0
    for path, g, w in _pairs(got, want):
        lim = max(tol * max(1.0, float(_flat(w).abs().max())),
                  (floors or {}).get(path, 0.0))
        err = max((float((gc - wc).abs().max()) for _, (gc, wc) in
                   _chunked(_device_of(w, g), g, w)), default=0.0)
        if err > lim:
            raise AssertionError(f"gradient {path}: {err} > {lim}")
        worst = max(worst, err / lim)
    return worst


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _axes(spec) -> tuple:
    return tuple(spec.get("axes") or MESH_AXES[-len(spec["mesh"]):])


def _mesh(spec, device):
    """The spec's mesh over the group's first ranks."""
    return make_test_mesh(tuple(spec["mesh"]), _axes(spec),
                          device_type=device.type)


def _device(spec):
    if spec.get("device", "cpu") == "cuda":
        return resolve_device(f"cuda:{torch.cuda.current_device()}")
    return torch.device("cpu")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _weights(spec, model, device):
    """The session's params: the given numpy tree (the reference's
    init), else drawn from ``seed`` on ``device``."""
    if spec.get("params") is not None:
        return params_from_jax(spec["params"], device)
    gen = torch.Generator(device=device).manual_seed(spec.get("seed", 0))
    return model.init(gen, device=device)


def _model(spec, **kw):
    kw.setdefault("moe_impl", spec.get("moe_impl", "dense"))
    kw.setdefault("moe_no_drop", spec.get("moe_no_drop", False))
    return get_model(ArchConfig(**spec["cfg"]), remat=spec.get("remat",
                                                              "none"), **kw)


class DataBlocks:
    """A one-process model of the shardmap MoE's local capacity on ``n``
    data ranks (``layers.apply_moe_shardmap``): the batch's ``n`` row
    blocks (each data rank's rows) run alone, each routed with its own
    capacity; the loss is the CE over every valid token plus
    ``AUX_LOSS_COEF`` times the blocks' mean aux, prefill's logits and
    cache the blocks' joined.  Decode never drops, so it is the model's."""

    def __init__(self, model, n: int):
        self.model, self.n, self.cfg = model, n, model.cfg

    def __getattr__(self, name):
        return getattr(self.model, name)

    def _blocks(self, batch):
        return [{k: v.chunk(self.n)[i] for k, v in batch.items()}
                for i in range(self.n)]

    def loss(self, params, batch):
        from repro_torch.models.transformer import AUX_LOSS_COEF

        nll, cnt, aux = 0.0, 0.0, 0.0
        for part in self._blocks(batch):
            _, m = self.model.loss(params, part)
            c = (part["labels"] != -1).sum().float()
            nll, cnt, aux = nll + m["ce"] * c, cnt + c, aux + m["aux"]
        ce = nll / torch.clamp(cnt, min=1.0)
        aux = aux / self.n
        return ce + AUX_LOSS_COEF * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, *args):
        outs = [self.model.prefill(params, part, *args)
                for part in self._blocks(batch)]
        cache = {k: (v if k == "index" else
                     torch.cat([o[1][k] for o in outs], dim=1))
                 for k, v in outs[0][1].items()}
        return torch.cat([o[0] for o in outs]), cache


def digest(tree) -> list:
    """The bits of every leaf of this rank's ``tree``, summed as integers
    (one int a leaf): equal digests, the same bits but by a collision."""
    return [int(x.detach().contiguous().view(torch.int32).long().sum())
            if x.dtype == torch.float32 else int(x.long().sum())
            for x in tree_leaves(tree)]


def _twin_model(spec, model):
    """The one-process model the mesh's work is held to: the model, or
    for the shardmap MoE on more than one ``(pod, data)`` rank its
    local-capacity model (:class:`DataBlocks`, a block a rank in their
    pod-major order)."""
    sizes = dict(zip(_axes(spec), spec["mesh"]))
    blocks = sizes.get("pod", 1) * sizes.get("data", 1)
    if spec.get("moe_impl") == "shardmap" and blocks > 1 and \
            model.cfg.is_moe:
        return DataBlocks(model, blocks)
    return model


def _lr(spec):
    lr = spec.get("lr", 1e-3)
    return warmup_cosine(*lr[1:]) if isinstance(lr, (list, tuple)) else lr


def _lr_at_1(spec) -> float:
    lr = _lr(spec)
    return float(lr(torch.ones((), dtype=torch.int32)) if callable(lr)
                 else lr)


def _cpu(tree):
    return tree_map(lambda x: x.detach().cpu().clone(), tree)


def _launches(before):
    now = ops.launch_counts()
    return {k: v - before.get(k, 0) for k, v in now.items()
            if v - before.get(k, 0)}


def _peak(device):
    return (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)


def _batches(spec, device):
    """The spec's batches on ``device``: token ids as int64, a frontend's
    embeddings as they are."""
    def one(v):
        t = torch.from_numpy(np.asarray(v))
        return (t if t.is_floating_point() else t.long()).to(device)
    return [{k: one(v) for k, v in b.items()} for b in spec["batches"]]


def train_session(spec, device) -> dict:
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    specs = shd.param_specs(mesh, params)
    local = shd.shard_tree(params, mesh, specs)
    del params                      # the twin draws its own
    compression = spec.get("compression", "none")
    init, upd = adamw(lr=_lr(spec))
    seen = {}

    def update(g, s, p):
        seen.setdefault("grads", tree_map(lambda x: x.clone(), g))
        return upd(g, s, p)

    kw = dict(grad_accum=spec.get("ga", 1), compression=compression)
    step = make_train_step(model, update, mesh=mesh, **kw)
    opt = init(local)
    res = comp.init_residuals(local) if compression != "none" else None
    batches = _batches(spec, device)
    before = ops.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    L.moe_drops(True)
    losses, norms, ms = [], [], []
    for b in batches:
        _sync(device)
        t0 = time.perf_counter()
        if res is None:
            local, opt, m = step(local, opt, b)
        else:
            local, opt, res, m = step(local, opt, res, b)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out = {"losses": losses, "grad_norms": norms, "ms": ms,
           "launches": _launches(before), "peak_bytes": _peak(device),
           "collectives": dict(step.placement.stats),
           "moe": dict(L.moe_drops(False)),
           "digest": digest({"params": local, "grads": seen["grads"]})}
    tree = {"params": local, "grads": seen["grads"]}
    if res is not None:
        tree["residuals"] = res
    if spec.get("keep"):
        tree.update(m=opt.m, v=opt.v)
    # the whole tree on rank 0's host only (at full width it does not fit
    # on every rank's share of the card), where a check reads it
    whole = (shd.gather_tree(tree, mesh, {k: specs for k in tree}, dst=0)
             if spec.get("twin") is True or spec.get("keep") else None)
    rank0 = dist.get_rank() == 0
    if spec.get("twin") and rank0:
        out["twin"] = _train_twin(spec, _twin_model(spec, model), whole,
                                  losses, norms, device, kw)
    if spec.get("keep") and rank0:
        out.update(_cpu(whole))
    return out


def _train_twin(spec, model, whole, losses, mesh_norms, device,
                kw) -> dict:
    """The same steps in one process on the same weights; the mesh's
    result held to it: losses (LOSS_RTOL), the pre-clip grad_norms
    (NORM_RTOL: a replicated leaf counted once a rank, not once), the
    first step's gradients (GRAD_TOL) and params (:func:`step_check`, its
    band the spec's ``step_band``, else 1), or with ``bit_equal``
    everything bit for bit (a one-rank mesh).  ``twin="scalars"`` holds
    the losses and grad_norms only (no tree is gathered).  With
    ``spread`` the grad_norm and gradient limits are at least FLOOR_X
    times the
    one-process path's own spread (:func:`_grad_spread`), and each
    element's step takes the gap that opens (``step_check``'s
    ``g_delta``)."""
    params = _weights(spec, model, device)
    init, upd = adamw(lr=_lr(spec))
    seen = {}

    def update(g, s, p):
        seen.setdefault("grads", tree_map(lambda x: x.clone(), g))
        return upd(g, s, p)

    step = make_train_step(model, update, **kw)
    opt = init(params)
    res = comp.init_residuals(params) if kw["compression"] != "none" \
        else None
    want, norms = [], []
    for b in _batches(spec, device):
        if res is None:
            params, opt, m = step(params, opt, b)
        else:
            params, opt, res, m = step(params, opt, res, b)
        want.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    if spec.get("bit_equal"):
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(whole["params"]), tree_leaves(params))) and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(whole["grads"]),
                                              tree_leaves(seen["grads"])))
        _check(same and losses == want, "one-rank mesh: not the one-process "
               "step's bits")
        return {"bit_equal": True, "losses": want}
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
    _check(rel <= LOSS_RTOL, f"loss {losses} vs one process {want}")
    out = {"losses": want, "loss_rel_err": rel, "grad_norms": norms}
    norm_tol, floors, g_delta = NORM_RTOL, None, None
    if spec.get("spread"):
        spread = _grad_spread(spec, model, device, kw, seen["grads"],
                              norms[0])
        out["spread"] = spread
        norm_tol = max(NORM_RTOL, FLOOR_X * spread["norm_rel"])
        floors = {k: FLOOR_X * v for k, v in spread["grads"].items()}
        g_delta = floors
    norm_rel = max(abs(a - b) / abs(b) for a, b in zip(mesh_norms, norms))
    _check(norm_rel <= norm_tol, f"grad_norm {mesh_norms} vs one process "
           f"{norms} (limit {norm_tol} rel)")
    out.update(grad_norm_rel_err=norm_rel, grad_norm_limit=norm_tol)
    if spec.get("twin") == "scalars":
        return out
    if res is None:
        out["grads_err_over_limit"] = grads_check(whole["grads"],
                                                  seen["grads"],
                                                  floors=floors)
    else:
        checked, g_delta = _compressed_check(whole, seen["grads"], res,
                                             mesh_norms[0], norms[0])
        out.update(checked)
    if len(want) == 1:
        out["params"] = step_check(whole["params"], params, seen["grads"],
                                   _lr_at_1(spec), g_delta=g_delta,
                                   band=spec.get("step_band", 1.0))
    return out


def _grad_spread(spec, model, device, kw, grads, norm) -> dict:
    """The one-process path's own spread: its first step again on the
    weights with every element moved by one part in 2^23 (a rounding-
    level change, signs from a seeded generator), the same batch.
    Returns {"norm_rel": the pre-clip grad_norm's relative change,
    "grads": {leaf path: the largest change of the clipped gradient}}.
    A path whose gradients amplify rounding (RWKV6 at init: heads whose
    wkv output has a variance near the group norm's eps) moves by far
    more than the rounding; the mesh's arithmetic, another order of the
    same sums, can move it as far."""
    params = _weights(spec, model, device)
    gen = torch.Generator(device=device).manual_seed(23)

    def nudge(x):
        if not x.is_floating_point():
            return x
        sign = torch.randint(0, 2, x.shape, generator=gen, device=device)
        return x * (1 + (2.0 * sign - 1) * 2.0 ** -23)
    params = tree_map(nudge, params)
    init, upd = adamw(lr=_lr(spec))
    seen = {}

    def update(g, s, p):
        seen.setdefault("grads", g)
        return upd(g, s, p)
    step = make_train_step(model, update, **kw)
    _, _, m = step(params, init(params), _batches(spec, device)[0])
    return {"norm_rel": abs(float(m["grad_norm"]) - norm) / norm,
            "grads": {path: float((a - b).abs().max()) for path, a, b in
                      _pairs(seen["grads"], grads)}}


def _compressed_check(whole, grads, res, got_norm, norm) -> dict:
    """One int8-compressed step against one process.  What the gradient
    tolerance holds is the gradient before compression, ``g32 = out +
    residual`` (``out`` the compressed gradient before the clip's
    scale): within GRAD_TOL.  A compressed element may still differ by
    one step of its row's scale where g32 / scale sits at a rounding
    boundary: such flips are counted and each held to one step.  Returns
    (the check's readings, {leaf path: the gap the check lets each
    element of the gradient fed to AdamW take}: one step of the
    reference's row scale plus GRAD_TOL's limit, through the clip,
    plus NORM_RTOL of the element for the clip's own gap)."""
    def unclip(g, gn):
        return g / min(1.0, 1.0 / max(gn, 1e-9))

    got = {p: unclip(_np(g), got_norm) for p, g, _ in
           _pairs(whole["grads"], whole["grads"])}
    want = {p: unclip(_np(g), norm) for p, g, _ in _pairs(grads, grads)}
    g32_got = {p: got[p] + _np(r) for p, r, _ in
               _pairs(whole["residuals"], whole["residuals"])}
    g32_want = {p: want[p] + _np(r) for p, r, _ in _pairs(res, res)}
    worst = grads_check(g32_got, g32_want)
    n_flips, g_delta = 0, {}
    clip = min(1.0, 1.0 / max(norm, 1e-9))
    for p in want:
        w = torch.from_numpy(g32_want[p]).float()
        scale = comp._quant_int8(w)[1].double().numpy()
        scale = np.broadcast_to(scale.reshape((-1,) + (1,) * (w.dim() - 1))
                                if w.dim() > 1 else scale.reshape(()),
                                w.shape)
        lim = GRAD_TOL * max(1.0, float(np.abs(want[p]).max()))
        diff = np.abs(got[p] - want[p])
        flip = diff > lim
        _check(bool((diff[flip] <= scale[flip] * 1.001 + lim).all()),
               f"compressed gradient {p}: a difference past one int8 step")
        n_flips += int(flip.sum())
        g_delta[p] = clip * (scale * 1.001 + lim +
                             NORM_RTOL * np.abs(want[p]))
    return {"g32_err_over_limit": worst, "int8_flips": n_flips}, g_delta


def serve_session(spec, device) -> dict:
    model = _model(spec, kv_quant="int8" if spec["kv"] == "int8" else
                   "none")
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    specs = shd.param_specs(mesh, params)
    prefill, decode = make_serving_fns(model, mesh)
    place = prefill.placement
    local = shd.shard_tree(params, mesh, specs)
    prompts = torch.from_numpy(np.asarray(spec["prompts"])).long().to(device)
    cache_len = spec["cache_len"]
    rank0 = dist.get_rank() == 0
    twin = _serve_twin(spec, _twin_model(spec, model), params, prompts,
                       device) if spec.get("twin") and rank0 else None
    del params
    before = ops.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    L.moe_drops(True)
    out = {}
    _sync(device)
    t0 = time.perf_counter()
    if spec["kv"] == "int8":
        whole = spec.get("cache")
        if whole is not None:
            whole = {k: torch.from_numpy(np.asarray(v)).to(device)
                     for k, v in whole.items() if k != "index"}
            index = spec["cache"]["index"]
        else:                    # the twin's prefill cache, quantized
            whole = _twin_int8_cache(model, twin, prompts.shape[0],
                                     cache_len, device)
            index = prompts.shape[1]
        cspec = shd.cache_spec_shardings(mesh, {k: (tuple(v.shape), v.dtype)
                                               for k, v in whole.items()})
        cache = {**shd.shard_tree(whole, mesh, cspec), "index": index}
        del whole
        tokens = torch.from_numpy(np.asarray(spec["first"])).long().to(
            device) if "first" in spec else None
        if tokens is None:
            tokens = _bcast(twin["prefill"] if rank0 else None,
                            (prompts.shape[0], model.cfg.vocab_size),
                            device).argmax(-1)
    else:
        logits, cache = prefill(local, {"tokens": prompts}, torch.float32,
                                cache_len)
        _sync(device)
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        out["prefill"] = logits.cpu()
        tokens = logits.argmax(-1)
    stats0 = dict(place.stats)
    steps, picks, ms = [], [], []
    for _ in range(spec["gen"]):
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = decode(local, cache, tokens)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        steps.append(logits.cpu())
        picks.append(tokens.cpu())
        tokens = logits.argmax(-1)
    picks.append(tokens.cpu())
    if spec.get("keep_cache"):
        whole = decode.gather_cache(cache, prompts.shape[0])
        if rank0:
            out["cache_whole"] = {k: v.cpu() for k, v in whole.items()
                                  if isinstance(v, torch.Tensor)}
    out.update(steps=steps, tokens=torch.stack(picks, 1), ms=ms,
               launches=_launches(before), peak_bytes=_peak(device),
               moe=dict(L.moe_drops(False)),
               cache_shape=list(cache["k"].shape) if "k" in cache else None,
               cache_shapes={k: list(v.shape) for k, v in cache.items()
                             if isinstance(v, torch.Tensor)},
               collectives={k: v - stats0.get(k, 0)
                            for k, v in place.stats.items()},
               collectives_session=dict(place.stats))
    if twin is not None:
        out["twin"] = _serve_compare(spec, out, twin)
    return out


def _bcast(x, shape, device):
    """Rank 0's f32 ``x`` on every rank."""
    buf = x.to(device).float().contiguous() if x is not None else \
        torch.empty(shape, device=device)
    dist.broadcast(buf, 0)
    return buf


def _twin_int8_cache(model, twin, b, cache_len, device):
    """Rank 0's quantized one-process prefill cache on every rank."""
    cfg = model.cfg
    shape = (cfg.n_layers, b, cfg.n_kv_heads, cache_len, cfg.hd)
    out = {}
    for name in ("k", "v"):
        full = _bcast(twin["cache"][name] if twin is not None else None,
                      shape, device)
        out[name], out[f"{name}_scale"] = L.quantize_kv(full)
    return out


def _decode(model, params, cache, tokens, gen):
    """``gen`` greedy one-process decode steps from ``tokens``: (each
    step's logits on the host, the tokens fed and the last picked)."""
    steps, picks = [], []
    for _ in range(gen):
        logits, cache = model.decode_step(params, cache, tokens)
        steps.append(logits.cpu())
        picks.append(tokens.cpu())
        tokens = logits.argmax(-1)
    picks.append(tokens.cpu())
    return steps, torch.stack(picks, 1)


def _serve_twin(spec, model, params, prompts, device) -> dict:
    """The one-process dense path on the same weights: a prefill into a
    cache of ``cache_len`` positions (quantized for int8), then ``gen``
    greedy decode steps.  Also the path's own spread (``floor``): the
    same decode on the batch in two halves (other GEMM shapes, the same
    arithmetic), its largest logit gap from the whole batch's at the
    first step and at any step."""
    logits, cache = model.prefill(params, {"tokens": prompts},
                                  torch.float32, spec["cache_len"])
    twin = {"prefill": logits, "cache": {k: v for k, v in cache.items()
                                         if k != "index"}}
    if spec["kv"] == "int8":
        whole = spec.get("cache")
        if whole is not None:
            cache = {k: torch.from_numpy(np.asarray(v)).to(device)
                     for k, v in whole.items() if k != "index"}
            cache["index"] = whole["index"]
        else:
            cache = {"index": cache["index"]}
            for name in ("k", "v"):
                cache[name], cache[f"{name}_scale"] = L.quantize_kv(
                    twin["cache"][name])
    tokens = (torch.from_numpy(np.asarray(spec["first"])).long().to(device)
              if "first" in spec else logits.argmax(-1))
    b = tokens.shape[0]
    halves = [({k: (v if k == "index" else v[:, rows].clone())
                for k, v in cache.items()}, tokens[rows])
              for rows in (slice(0, b // 2), slice(b // 2, b))] \
        if b > 1 else []
    twin["steps"], twin["tokens"] = _decode(model, params, cache, tokens,
                                            spec["gen"])
    if halves:
        parts = [_decode(model, params, c, t, spec["gen"])[0]
                 for c, t in halves]
        gaps = [float((torch.cat([a, b_]) - w).abs().max())
                for a, b_, w in zip(*parts, twin["steps"])]
        twin["floor"] = {"first_step": gaps[0], "max_step": max(gaps)}
    return twin


def _serve_compare(spec, got, twin) -> dict:
    """The mesh's serving against the one-process twin, or with
    ``bit_equal`` every token and logit bit for bit.  Greedy tokens
    identical; logits at the prefill and the first step within
    LOGIT_TOL, or FLOOR_X times the twin's own spread at the first step
    (``floor``: its largest gap on the batch in halves) where that is
    larger."""
    if spec.get("bit_equal"):
        same = (torch.equal(got["tokens"], twin["tokens"]) and
                all(torch.equal(a, b) for a, b in zip(got["steps"],
                                                      twin["steps"])) and
                ("prefill" not in got or
                 torch.equal(got["prefill"], twin["prefill"].cpu())))
        _check(same, "one-rank mesh: not the one-process serving's bits")
        return {"bit_equal": True}
    floor = twin.get("floor")
    tol = max(LOGIT_TOL, FLOOR_X * floor["first_step"]) if floor \
        else LOGIT_TOL
    want, toks = twin["tokens"], got["tokens"]
    apart = (toks != want).nonzero()
    _check(not len(apart), f"greedy tokens differ from one process at "
           f"(row, token) {apart[:4].tolist()}")
    errs = [float((a - b).abs().max()) for a, b in zip(got["steps"],
                                                       twin["steps"])]
    out = {"first_step_err": errs[0], "max_step_err": max(errs),
           "limit": tol, "tokens_equal": True, "floor": floor}
    if "prefill" in got:
        out["prefill_err"] = float((got["prefill"] -
                                    twin["prefill"].cpu()).abs().max())
        _check(out["prefill_err"] <= tol,
               f"prefill logits {out['prefill_err']} > {tol}")
    _check(errs[0] <= tol, f"first step logits {errs[0]} > {tol}")
    return out


def save_session(spec, device) -> dict:
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    specs = shd.param_specs(mesh, params)
    mgr = CheckpointManager(spec["dir"])
    mgr.save(spec.get("step", 1), shd.shard_tree(params, mesh, specs),
             mesh=mesh, specs=specs, blocking=spec.get("blocking", True))
    mgr.wait()
    return {"saved": sorted(mgr.steps()) if dist.get_rank() == 0 else None}


def restore_session(spec, device) -> dict:
    """Restore onto this spec's mesh: this rank's slices equal to
    ``shard_tree`` of the weights, and gathered whole equal to them, bit
    for bit."""
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    specs = shd.param_specs(mesh, params)
    got = CheckpointManager(spec["dir"]).restore(params, mesh=mesh,
                                                 specs=specs)
    want = shd.shard_tree(params, mesh, specs)
    local = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(want)))
    back = shd.gather_tree(got, mesh, specs)
    whole = all(torch.equal(a, b) for _, a, b in _pairs(back, params))
    _check(local and whole, f"restore onto {spec['mesh']}: local "
           f"{local}, whole {whole}")
    return {"local_equal": local, "whole_equal": whole,
            "local_shapes": {p: list(a.shape) for p, a, _ in
                             _pairs(got, got)}}


def roundtrip_session(spec, device) -> dict:
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    specs = shd.param_specs(mesh, params)
    init, _ = adamw()
    opt = init(params)
    gen = torch.Generator(device=device).manual_seed(1)   # alike on every rank
    opt = AdamWState(step=opt.step + 3, m=tree_map(
        lambda x: torch.randn(x.shape, generator=gen, device=device), params),
        v=tree_map(lambda x: torch.rand(x.shape, generator=gen,
                                        device=device), params))
    tree = {"params": params, "opt": opt}
    tspecs = {"params": specs, "opt": AdamWState(step=(), m=specs, v=specs)}
    back = shd.gather_tree(shd.shard_tree(tree, mesh, tspecs), mesh, tspecs)
    same = (all(torch.equal(a, b) for _, a, b in _pairs(back["params"],
                                                         params)) and
            torch.equal(back["opt"].step, opt.step) and
            all(torch.equal(a, b) for _, a, b in _pairs(back["opt"].m,
                                                         opt.m)) and
            all(torch.equal(a, b) for _, a, b in _pairs(back["opt"].v,
                                                         opt.v)))
    _check(same, f"gather_tree(shard_tree(x)) != x on {spec['mesh']}")
    return {"bit_equal": same}


def bad_mesh_session(spec, device) -> dict:
    """A mesh of fewer ranks than the group: the placement raises."""
    mesh = _mesh(spec, device)
    try:
        MeshPlacement(mesh)
    except ValueError as e:
        return {"raised": str(e)}
    raise AssertionError(f"a mesh {spec['mesh']} over "
                         f"{dist.get_world_size()} ranks did not raise")


def pipeline_session(spec, device) -> dict:
    """The GPipe loss and gradients, ``steps`` times (each timed); with
    ``twin`` rank 0 holds them to ``model.loss`` and its gradients in
    one process (loss LOSS_RTOL, gradients GRAD_TOL)."""
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    loss_fn = make_pipeline_loss(model, mesh,
                                 n_microbatches=spec["microbatches"])
    place = loss_fn.placement
    local = stage_params(params, mesh)
    batch = _batches(spec, device)[0]
    before = ops.launch_counts()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    ms, stats = [], []
    for _ in range(spec.get("steps", 1)):
        s0 = dict(place.stats)
        _sync(device)
        t0 = time.perf_counter()
        loss, grads = loss_fn.value_and_grad(local, batch)
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        stats.append({k: v - s0.get(k, 0) for k, v in place.stats.items()})
    stages = place.sizes["pod"]
    out = {"loss": float(loss), "ms": ms, "collectives_a_step": stats[-1],
           "launches": _launches(before), "peak_bytes": _peak(device),
           "stages": stages, "microbatches": spec["microbatches"],
           "bubble": (stages - 1) / (spec["microbatches"] + stages - 1)}
    whole = gather_stages(grads, mesh)
    if spec.get("model_code"):
        out["model_code_loss"] = _model_code_loss(model, params, mesh,
                                                  batch)
    if dist.get_rank() == 0:
        if spec.get("twin"):
            out["twin"] = _pipeline_twin(model, params, batch, float(loss),
                                         whole)
        if spec.get("keep"):
            out["grads"] = _cpu(whole)
    return out


def _model_code_loss(model, params, mesh, batch) -> float:
    """The model code's loss on ``mesh`` (``model.on_mesh``): this rank's
    ``param_specs`` shards gathered over the FSDP axes, its rows of the
    batch."""
    placed = model.on_mesh(mesh)
    place = placed.place
    local = shd.shard_tree(params, mesh, placed.specs)
    rows = place.rows_axis(batch["tokens"].shape[0])
    with torch.no_grad():
        loss, _ = placed.with_rows(rows).loss(
            gather_data(place, placed.specs, local),
            {k: split_rows(rows, v) for k, v in batch.items()})
    return float(loss)


def _pipeline_twin(model, params, batch, loss, grads) -> dict:
    leaves = tree_leaves(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    it = iter(live)
    want, _ = model.loss(tree_map(lambda _: next(it), params), batch)
    it = iter(torch.autograd.grad(want, live))
    g_ref = tree_map(lambda _: next(it), params)
    want = want.detach()
    rel = abs(loss - float(want)) / abs(float(want))
    _check(rel <= LOSS_RTOL, f"pipeline loss {loss} vs one process "
           f"{float(want)}")
    return {"loss": float(want), "loss_rel_err": rel,
            "grads_err_over_limit": grads_check(grads, g_ref)}


def pipeline_backward_session(spec, device) -> dict:
    """``loss.backward()`` on this rank's leaves gives ``value_and_grad``'s
    gradients, bit for bit."""
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    loss_fn = make_pipeline_loss(model, mesh,
                                 n_microbatches=spec["microbatches"])
    local = stage_params(params, mesh)
    batch = _batches(spec, device)[0]
    _, grads = loss_fn.value_and_grad(local, batch)
    live = tree_map(lambda x: x.detach().requires_grad_(True), local)
    loss_fn(live, batch).backward()
    return {"equal": all(torch.equal(a.grad, b) for a, b in zip(
        tree_leaves(live), tree_leaves(grads)))}


def pipeline_errors_session(spec, device) -> dict:
    """What the pipeline refuses on a pod mesh: layers that do not divide
    over the stages, a batch that does not divide over data x
    microbatches."""
    import dataclasses

    raised = {}
    mesh = make_test_mesh((2, 2), ("pod", "data"), device_type=device.type)
    cfg = ArchConfig(**spec["cfg"])
    try:
        make_pipeline_loss(get_model(dataclasses.replace(cfg, n_layers=3)),
                           mesh, n_microbatches=2)
    except ValueError as e:
        raised["layers"] = str(e)
    model = _model(spec)
    loss_fn = make_pipeline_loss(model, mesh, n_microbatches=4)
    toks = torch.zeros((4, 8), dtype=torch.long, device=device)
    try:
        loss_fn({}, {"tokens": toks, "labels": toks})
    except ValueError as e:
        raised["batch"] = str(e)
    return {"raised": raised}


def serve_raises_session(spec, device) -> dict:
    """``make_serving_fns(model, mesh)``'s prefill into a cache of
    ``cache_len`` positions that do not split over the mesh's sequence
    axis: the message of the ``ValueError`` it raises."""
    model = _model(spec)
    params = _weights(spec, model, device)
    mesh = _mesh(spec, device)
    prefill, _ = make_serving_fns(model, mesh)
    local = shd.shard_tree(params, mesh, shd.param_specs(mesh, params))
    prompts = torch.from_numpy(np.asarray(spec["prompts"])).long().to(device)
    try:
        prefill(local, {"tokens": prompts}, torch.float32, spec["cache_len"])
    except ValueError as e:
        return {"raised": str(e)}
    raise AssertionError(f"a cache of {spec['cache_len']} positions on "
                         f"{spec['mesh']} did not raise")


def raises_session(spec, device) -> dict:
    """``on_mesh`` of each of ``cfgs`` on this spec's mesh: the message of
    the ``NotImplementedError`` it raises (None where it places)."""
    mesh = _mesh(spec, device)
    out = []
    for cfg in spec["cfgs"]:
        try:
            get_model(ArchConfig(**cfg)).on_mesh(mesh)
            out.append(None)
        except NotImplementedError as e:
            out.append(str(e))
    return {"raised": out}


SESSIONS = {"pipeline": pipeline_session, "raises": raises_session,
            "serve_raises": serve_raises_session,
            "pipeline_backward": pipeline_backward_session,
            "pipeline_errors": pipeline_errors_session, "train": train_session, "serve": serve_session,
            "save": save_session, "restore": restore_session,
            "roundtrip": roundtrip_session, "bad_mesh": bad_mesh_session}


def mesh_sessions(specs: list) -> list:
    """Each spec's session in this rank, in order (every rank of the
    group runs the same list); one result a spec, with its seconds."""
    out = []
    for spec in specs:
        device = _device(spec)
        t0 = time.monotonic()
        res = SESSIONS[spec["kind"]](spec, device)
        res["session_s"] = time.monotonic() - t0
        out.append(res)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        dist.barrier()
    return out
