"""The port's placement rules (``runtime/sharding.py``) and meshes
(``launch/mesh.py``) against the JAX package's.

The reference's specs need a mesh of real devices: one subprocess with
eight forced host devices dumps, as JSON, ``param_spec`` of every leaf of
every registry arch's ``reduced()`` params (shapes from ``eval_shape``),
``serve_param_specs``, ``batch_spec``, ``cache_spec_shardings`` and
``decode_token_spec`` on the meshes (2, 4), (4, 2), (1, 8), (8, 1) and
(3, 2) of ``("data", "model")`` (and one ``("pod", "data", "model")``),
and the ``pool_*_specs``.  The port's specs, from its own param and cache
trees, are held equal to them spec for spec.  The meshes themselves
(``DeviceMesh``) are built over a fake process group of eight ranks."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.configs.base import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402
from repro_torch.runtime import pool as tpool  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [(2, 4), (4, 2), (1, 8), (8, 1), (3, 2)]
POD_MESH = (2, 2, 2)
BATCH_SHAPES = {"tokens": [8, 16], "labels": [8, 16], "embeds": [6, 16, 64],
                "odd": [3, 5]}

_REFERENCE = r"""
import json
import jax
import jax.numpy as jnp
from repro.configs.base import ARCH_IDS, get_arch
from repro.launch.mesh import make_test_mesh, make_elastic_mesh
from repro.models.api import get_model
from repro.runtime import sharding as shd

def spec(p):
    return [list(a) if isinstance(a, tuple) else a for a in p]

def flat(tree, keyed):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]:
        out["/".join(shd._key_of(p) for p in path)] = spec(leaf)
    return out

meshes = %(meshes)s
res = {"meshes": {}, "pool": {}, "elastic": {}}
for shape in meshes + [%(pod)s]:
    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    mesh = make_test_mesh(tuple(shape), axes)
    one = {"params": {}, "serve": {}, "cache": {}}
    for arch in ARCH_IDS:
        m = get_model(get_arch(arch).reduced())
        shapes = jax.eval_shape(m.init, jax.random.PRNGKey(0))
        one["params"][arch] = flat(shd.param_specs(mesh, shapes), True)
        one["serve"][arch] = flat(shd.serve_param_specs(mesh, shapes), True)
        for b, s in ((2, 16), (8, 12)):
            cs = m.cache_spec(b, s)
            one["cache"][f"{arch}/{b}x{s}"] = flat(
                shd.cache_spec_shardings(mesh, cs), True)
    bs = {k: jax.ShapeDtypeStruct(tuple(v), jnp.int32)
          for k, v in %(batch)s.items()}
    one["batch"] = flat(shd.batch_spec(mesh, bs), True)
    one["token"] = {str(b): spec(shd.decode_token_spec(mesh, b))
                    for b in (1, 2, 3, 4, 6, 8, 16)}
    res["meshes"]["x".join(map(str, shape))] = one
for q in (False, True):
    res["pool"][str(q)] = {
        "store": spec(shd.pool_store_spec()),
        "state": {k: spec(v) for k, v in shd.pool_state_spec(q).items()},
        **{name: [[spec(s) if isinstance(s, jax.sharding.PartitionSpec)
                   else {k: spec(v) for k, v in s.items()} for s in side]
                  for side in fn(q)]
           for name, fn in (("step", shd.pool_step_specs),
                            ("chunk", shd.pool_chunk_specs),
                            ("horizon", shd.pool_horizon_specs),
                            ("spec", shd.pool_spec_specs))}}
for n, mp in ((8, 4), (6, 4), (8, 16), (6, 16), (5, 4), (4, 2)):
    res["elastic"][f"{n}/{mp}"] = list(make_elastic_mesh(
        n, model_parallel=mp).devices.shape)
res["bucket"] = {str(n): shd.mesh_bucket(n) for n in range(1, 10)}
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    env["JAX_PLATFORMS"] = "cpu"
    code = textwrap.dedent(_REFERENCE) % {
        "meshes": [list(m) for m in MESHES], "pod": list(POD_MESH),
        "batch": BATCH_SHAPES}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.fixture
def fake_group():
    """A fake default process group of eight ranks (this process rank 0):
    enough for ``DeviceMesh`` to be built, no collective runs."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _json(spec):
    return [list(a) if isinstance(a, tuple) else a for a in spec]


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): _json(tree)}


def _axes(shape):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return dict(zip(names, shape))


@pytest.fixture(scope="module")
def trees():
    """Each arch's reduced params (the port's own init) and cache specs."""
    out = {}
    for arch in ARCH_IDS:
        m = get_model(get_arch(arch).reduced())
        out[arch] = (m, m.init(torch.Generator().manual_seed(0),
                               device="cpu"))
    return out


ALL_MESHES = MESHES + [POD_MESH]


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_param_specs_match_reference(reference, trees, shape):
    want = reference["meshes"]["x".join(map(str, shape))]
    mesh = _axes(shape)
    for arch, (_, params) in trees.items():
        assert _flat(shd.param_specs(mesh, params)) == want["params"][arch], arch
        assert _flat(shd.serve_param_specs(mesh, params)) == \
            want["serve"][arch], arch


@pytest.mark.parametrize("shape", ALL_MESHES, ids=lambda s: "x".join(
    map(str, s)))
def test_batch_cache_and_token_specs_match_reference(reference, trees,
                                                     shape):
    want = reference["meshes"]["x".join(map(str, shape))]
    mesh = _axes(shape)
    batch = {k: torch.empty(v, dtype=torch.int32)
             for k, v in BATCH_SHAPES.items()}
    assert _flat(shd.batch_spec(mesh, batch)) == want["batch"]
    for arch, (m, _) in trees.items():
        for b, s in ((2, 16), (8, 12)):
            got = _flat(shd.cache_spec_shardings(mesh, m.cache_spec(b, s)))
            ref = {k: v for k, v in want["cache"][f"{arch}/{b}x{s}"].items()
                   if k != "index"}
            assert got == ref, (arch, b, s)
    for b, spec in want["token"].items():
        assert _json(shd.decode_token_spec(mesh, int(b))) == spec


@pytest.mark.parametrize("quantized", [False, True])
def test_pool_specs_match_reference(reference, quantized):
    want = reference["pool"][str(quantized)]
    assert _json(shd.pool_store_spec()) == want["store"]
    assert {k: _json(v) for k, v in
            shd.pool_state_spec(quantized).items()} == want["state"]
    for name, fn in (("step", shd.pool_step_specs),
                     ("chunk", shd.pool_chunk_specs),
                     ("horizon", shd.pool_horizon_specs),
                     ("spec", shd.pool_spec_specs)):
        got = [[_json(s) if isinstance(s, tuple) else
                {k: _json(v) for k, v in s.items()} for s in side]
               for side in fn(quantized)]
        assert got == want[name], name


def test_device_mesh_reads_as_its_sizes(reference, trees, fake_group):
    """Specs over a ``DeviceMesh`` equal those over its sizes."""
    mesh = tmesh.make_test_mesh((2, 4))
    assert shd.mesh_axes(mesh) == {"data": 2, "model": 4}
    _, params = trees["qwen2_72b"]
    assert (_flat(shd.param_specs(mesh, params)) ==
            reference["meshes"]["2x4"]["params"]["qwen2_72b"])


@pytest.mark.parametrize("n,mp", [(8, 4), (6, 4), (8, 16), (6, 16), (5, 4),
                                  (4, 2)])
def test_elastic_mesh_shapes(reference, fake_group, n, mp):
    want = tuple(reference["elastic"][f"{n}/{mp}"])
    assert tmesh.elastic_mesh_shape(n, mp) == want
    mesh = tmesh.make_elastic_mesh(n, model_parallel=mp, device_type="cpu")
    assert tuple(mesh.shape) == want
    assert mesh.mesh_dim_names == ("data", "model")
    assert (8, 4) != (n, mp) or want == (2, 4)
    assert (6, 4) != (n, mp) or want == (3, 2)


def test_mesh_bucket_and_pool_mesh_errors(reference, fake_group):
    for n, b in reference["bucket"].items():
        assert shd.mesh_bucket(int(n)) == b
    assert tpool.mesh_bucket is shd.mesh_bucket
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        shd.mesh_bucket(0)
    with pytest.raises(ValueError, match="need 9 ranks but only 8"):
        shd.pool_mesh(9, device_type="cpu")
    with pytest.raises(ValueError, match="need 4 ranks but only 2"):
        shd.pool_mesh(4, devices=[0, 1], device_type="cpu")
    mesh = shd.pool_mesh(4, device_type="cpu")
    assert mesh.mesh_dim_names == ("model",) and tuple(mesh.shape) == (4,)
    with pytest.raises(ValueError, match="needs 16 ranks"):
        tmesh.make_test_mesh((4, 4))


def test_pool_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        shd.pool_mesh(2, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs a process group"):
        tmesh.make_test_mesh((1, 2))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"data": 2, "model": 4}
    assert shd.to_placements(mesh, (None, "model", None)) == (
        Replicate(), Shard(1))
    assert shd.to_placements(mesh, ("data", "model")) == (Shard(0), Shard(1))
    assert shd.to_placements(mesh, ()) == (Replicate(), Replicate())
    pod = {"pod": 2, "data": 2, "model": 2}
    assert shd.to_placements(pod, (("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))


def test_backend_rule():
    assert tmesh.pick_backend("cpu", 4, 0) == "gloo"
    assert tmesh.pick_backend("cuda", 4, 1) == "gloo"      # ranks share a card
    assert tmesh.pick_backend("cuda", 4, 4) == "nccl"      # a card each
    assert tmesh.pick_backend("cuda", 1, 1) == "nccl"
    assert tmesh.elastic_mesh_shape(8, 4) == (2, 4)
    assert tmesh.elastic_mesh_shape(6, 4) == (3, 2)
