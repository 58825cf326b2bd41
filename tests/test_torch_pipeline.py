"""The GPipe pipeline over ``pod`` (``runtime.pipeline_par``) against the
JAX package's ``make_pipeline_loss`` on the same meshes and inputs.

Reduced granite-3-2b at 4 layers (d 64, 4 heads of 16, vocab 128), the
reference's init.  The reference runs once in a subprocess with four
forced host devices: its pipeline loss and ``jax.grad`` of it on a
``(pod 2, data 2)`` and a ``(pod 4)`` mesh.  The port runs on 4 gloo
ranks spawned once (``launch.mesh.run_ranks``, a ``FileStore`` in
``tmp_path``, every join limited to ``LIMIT`` s) through
``scripts/mesh_sessions.py``'s ``pipeline`` session: each rank's stage
params from ``stage_params``, the gradients gathered by
``gather_stages``.  Held: loss within 1e-5 rel, every gradient within
1e-4 x max(1, max|g|) (``tests/test_pipeline_par.py``'s bounds), and
the same against the port's one-process ``model.loss`` (rank 0's twin);
a ``model`` axis replicates the work; on (pod 2, data 1, model 2) the
pipeline and the model code placed on the same mesh (``model.on_mesh``:
the batch over ``(pod, data)``) give the same loss; ``loss.backward()``
and ``value_and_grad`` agree bit for bit; the errors."""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_arch  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.runtime.pipeline_par import (make_pipeline_loss,  # noqa: E402
                                              pipeline_specs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from mesh_sessions import (GRAD_TOL, LOSS_RTOL, grads_check,  # noqa: E402
                           mesh_sessions)

LIMIT = 240                # seconds, every join of spawned ranks
N_LAYERS, B, S, M = 4, 16, 16, 4
MESHES = {"pod2 data2": ((2, 2), ("pod", "data")),
          "pod4": ((4,), ("pod",))}

_REFERENCE = """
import json
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.launch.mesh import auto_axis_kwargs
from repro.configs.base import get_arch
from repro.models.api import get_model
from repro.runtime.pipeline_par import make_pipeline_loss

cfg = dataclasses.replace(get_arch("granite_3_2b").reduced(),
                          n_layers=%(layers)d)
model = get_model(cfg, compute_dtype=jnp.float32, remat="none")
params = model.init(jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
toks = rng.integers(0, cfg.vocab_size, (%(b)d, %(s)d), dtype=np.int32)
labs = np.concatenate([toks[:, 1:], np.full((%(b)d, 1), -1, np.int32)], 1)
batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)}
out = {"params/" + "/".join(k.key for k in path): np.asarray(x)
       for path, x in jax.tree_util.tree_flatten_with_path(params)[0]}
out["tokens"], out["labels"] = toks, labs
losses = {}
for name, (shape, axes) in %(meshes)r.items():
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         **auto_axis_kwargs(tuple(axes)))
    loss_pp = make_pipeline_loss(model, mesh, n_microbatches=%(m)d)
    with mesh:
        losses[name] = float(jax.jit(loss_pp)(params, batch))
        g = jax.jit(jax.grad(loss_pp))(params, batch)
    for path, x in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[name + "/" + "/".join(k.key for k in path)] = np.asarray(x)
np.savez(%(out)r, **out)
print("RESULT " + json.dumps(losses))
"""


def _tree(z, prefix):
    tree = {}
    for key in z.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *head, leaf = key[len(prefix) + 1:].split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[leaf] = np.array(z[key])
    return tree


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import json

    d = tmp_path_factory.mktemp("ref")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE) % {
        "layers": N_LAYERS, "b": B, "s": S, "m": M, "out": str(d / "r.npz"),
        "meshes": {k: (list(v[0]), list(v[1])) for k, v in MESHES.items()}}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    res = {"losses": json.loads(line[-1][len("RESULT "):])}
    with np.load(d / "r.npz") as z:
        res["params"] = _tree(z, "params")
        res["batch"] = {"tokens": np.array(z["tokens"]),
                        "labels": np.array(z["labels"])}
        for name in MESHES:
            res[name] = _tree(z, name)
    return res


def _cfg():
    return dataclasses.replace(get_arch("granite-3-2b").reduced(),
                               n_layers=N_LAYERS)


@pytest.fixture(scope="module")
def ranks(reference, tmp_path_factory):
    base = {"kind": "pipeline", "cfg": dataclasses.asdict(_cfg()),
            "params": reference["params"], "batches": [reference["batch"]],
            "microbatches": M, "keep": True, "twin": True}
    cases = {name: dict(base, mesh=shape, axes=axes)
             for name, (shape, axes) in MESHES.items()}
    cases["pod2 data1 model2"] = dict(base, mesh=(2, 1, 2),
                                      axes=("pod", "data", "model"),
                                      model_code=True)
    cases["backward"] = dict(base, kind="pipeline_backward", mesh=(2, 2),
                             axes=("pod", "data"))
    cases["errors"] = {"kind": "pipeline_errors",
                       "cfg": dataclasses.asdict(_cfg()), "seed": 0}
    names = list(cases)
    got = run_ranks(mesh_sessions, 4, ([cases[n] for n in names],),
                    timeout_s=LIMIT,
                    workdir=str(tmp_path_factory.mktemp("ranks")))
    return {n: [got[r][i] for r in range(4)] for i, n in enumerate(names)}


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_loss_matches_reference(reference, ranks, name):
    res = ranks[name]
    assert all(r["loss"] == res[0]["loss"] for r in res)
    assert res[0]["loss"] == pytest.approx(reference["losses"][name],
                                           rel=LOSS_RTOL)


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_grads_match_reference(reference, ranks, name):
    """Every leaf, the tied table's two shares summed over the stages."""
    assert grads_check(ranks[name][0]["grads"], reference[name],
                       GRAD_TOL) <= 1.0


@pytest.mark.parametrize("name", list(MESHES) + ["pod2 data1 model2"])
def test_pipeline_matches_one_process(ranks, name):
    twin = ranks[name][0]["twin"]
    assert twin["loss_rel_err"] <= LOSS_RTOL
    assert twin["grads_err_over_limit"] <= 1.0


def test_model_axis_replicates_the_work(ranks):
    """On (pod 2, data 1, model 2) both model ranks of a stage compute the
    same loss and gradients as the (pod 2, data 2) run's."""
    a, b = ranks["pod2 data1 model2"][0], ranks["pod2 data2"][0]
    assert a["loss"] == pytest.approx(b["loss"], rel=LOSS_RTOL)
    assert grads_check(a["grads"], b["grads"], GRAD_TOL) <= 1.0


@pytest.mark.parametrize("name", list(MESHES))
def test_pipeline_schedule_counts(ranks, name):
    """Each boundary carries M activations forward and M gradients back;
    the bubble is (S - 1) / (M + S - 1)."""
    res = ranks[name]
    stages = res[0]["stages"]
    assert res[0]["bubble"] == (stages - 1) / (M + stages - 1)
    sent = sum(r["collectives_a_step"].get("send", 0) for r in res)
    data = 4 // stages
    assert sent == 2 * M * (stages - 1) * data


def test_backward_equals_value_and_grad(ranks):
    for r in ranks["backward"]:
        assert r["equal"]


@pytest.mark.parametrize("what,says", [("layers", "layers"),
                                       ("batch", "microbatches")])
def test_pipeline_errors(ranks, what, says):
    """The pipeline refuses layers that do not divide over the stages and
    a batch that does not divide over data x microbatches."""
    assert all(says in r["raised"][what] for r in ranks["errors"])


def test_pipeline_and_model_code_share_a_pod_mesh(reference, ranks):
    """On (pod 2, data 1, model 2) the pipeline's loss is still the
    reference's (its (pod 2, data 2) run: the same batch), and the model
    code placed on that mesh gives the same loss on every rank."""
    res = ranks["pod2 data1 model2"]
    want = reference["losses"]["pod2 data2"]
    for r in res:
        assert r["loss"] == pytest.approx(want, rel=LOSS_RTOL)
        assert r["model_code_loss"] == pytest.approx(r["loss"],
                                                     rel=LOSS_RTOL)


def test_pipeline_takes_a_transformer():
    rwkv = get_model(get_arch("rwkv6-3b").reduced())
    with pytest.raises(TypeError, match="TransformerLM"):
        make_pipeline_loss(rwkv, object(), n_microbatches=2)


def test_pipeline_specs_split_the_layers_only():
    model = get_model(_cfg())
    params = model.init(torch.Generator().manual_seed(0))
    specs = pipeline_specs(params)
    assert specs["layers"]["attn"]["wq"] == ("pod", None, None)
    assert specs["embed"]["table"] == (None, None)
    assert specs["final_norm"]["scale"] == (None,)
