"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py``, no script of ``scripts/`` and no
``examples/*_torch.py`` imports JAX, ``ml_dtypes`` (a JAX dependency) or
the JAX package, and its entry points refuse to fall back to the CPU
when CUDA is asked for."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py")) + \
    sorted((ROOT / "examples").glob("*_torch.py"))
BANNED = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args and
              isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            text = (arg.value if isinstance(arg, ast.Constant) else
                    "".join(v.value for v in arg.values
                            if isinstance(v, ast.Constant)))
            yield text


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.name} imports {bad}"


def test_launcher_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "granite-3-2b", "--reduced", "--paged",
                    "--requests", "1", "--prompt-len", "4", "--gen", "1"])


def test_launcher_runs_on_cpu_when_asked():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "granite-3-2b", "--reduced", "--paged",
                      "--requests", "2", "--prompt-len", "6", "--gen", "3",
                      "--horizon", "2", "--prefill-chunk", "4",
                      "--device", "cpu"])
    assert {k: len(v) for k, v in out.items()} == {0: 3, 1: 3}


LAUNCH = ["--reduced", "--device", "cpu", "--requests", "2", "--prompt-len",
          "6", "--gen", "4", "--page-size", "4", "--hbm-pages", "16"]


def _reference_tokens(flags):
    """What the JAX launcher serves for ``flags + LAUNCH`` (its weights,
    ``PRNGKey(0)``; its prompts): the paged path's ``decode`` tokens, or
    for ``--pool`` the router's outputs (the prefill's token first),
    which equal the single server's by the pool's contract."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    import numpy as np
    from repro.configs.base import get_arch as jget_arch
    from repro.models.api import get_model as jget_model
    from repro.runtime.serve import PagedServer as JServer

    cfg = jget_arch(flags[1]).reduced()
    model = jget_model(cfg, compute_dtype=jnp.float32, moe_no_drop=True)
    params = model.init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6),
                                                dtype=np.int32)
    server = JServer(model, params, page_size=4, hbm_pages=16)
    first = [int(np.argmax(server.add_request(i, p)))
             for i, p in enumerate(prompts)]
    params = jax.device_get(params)
    if "--pool" not in flags:
        return params, server.decode(4)
    rest = server.decode(3)
    return params, {i: [first[i], *rest[i]] for i in range(2)}


@pytest.mark.parametrize("flags", [
    ["--arch", "phi3.5-moe-42b-a6.6b", "--paged"],
    ["--arch", "phi3.5-moe-42b-a6.6b", "--pool", "--nodes", "2"],
    ["--arch", "zamba2-1.2b", "--pool", "--temperature", "0.8"]])
def test_launcher_paths_not_yet_ported_exit(flags, monkeypatch):
    """The MoE arch runs the paged and the 2-node pool path on the CPU
    and, on the JAX launcher's weights, gives its tokens; the zamba2
    hybrid block stops at the JAX launcher's ``SystemExit`` (those paths
    serve transformer archs only)."""
    from repro_torch.launch import serve
    from repro_torch.models.convert import params_from_jax
    if flags[1] == "zamba2-1.2b":
        with pytest.raises(SystemExit, match="supports transformer archs"):
            serve.main([*flags, *LAUNCH])
        return
    jparams, want = _reference_tokens(flags)
    build = serve.get_model

    def on_reference_weights(cfg, **kw):
        model = build(cfg, **kw)
        model.impl.init = lambda *a, **k: params_from_jax(jparams,
                                                          device="cpu")
        return model

    monkeypatch.setattr(serve, "get_model", on_reference_weights)
    assert serve.main([*flags, *LAUNCH]) == want


def test_launcher_pool_runs_on_cpu_when_asked():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "granite-3-2b", "--reduced", "--pool",
                      "--nodes", "2", "--requests", "3", "--prompt-len", "6",
                      "--gen", "3", "--page-size", "4", "--hbm-pages", "8",
                      "--horizon", "4", "--speculative", "--prefill-chunk",
                      "4", "--device", "cpu"])
    assert {k: len(v) for k, v in out.items()} == {0: 3, 1: 3, 2: 3}


def test_isp_launcher_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the launcher would run on it")
    from repro_torch.launch import isp
    with pytest.raises(RuntimeError, match="CUDA"):
        isp.main(["--rows", "10"])


def test_isp_launcher_runs_on_cpu_when_asked():
    from repro_torch.launch import isp
    out = isp.main(["--rows", "70", "--cols", "8", "--page-rows", "16",
                    "--page-dtype", "int8", "--corpus-rows", "40",
                    "--emb-dim", "8", "--k", "2", "--reduced",
                    "--device", "cpu"])
    assert [v["where"] for v in out["planner"]] == ["device", "device"]
    assert out["dlrm_shape"] == [32, 64]
    assert out["etheron"]["job_frames"] == 4
    rag = out["rag"]
    assert rag["where"]["device"] == 8 and len(rag["ids"]) == 2
    assert rag["waves"][1]["prefix_hits"] > rag["waves"][0]["prefix_hits"]
