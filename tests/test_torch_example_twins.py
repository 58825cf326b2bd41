"""The port's example twins (``examples/*_torch.py``) run on the CPU at
their own demo sizes, each its invariants held (the assertions inside
``main``) and the values it returns checked here."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", ["none", "lossy"])
def test_serve_pool_twin(plan):
    out = _load("serve_pool_torch").main(["--device", "cpu",
                                          "--fault-plan", plan])
    assert out["one_node_equal"] and out["failover_equal"]
    assert out["warm_equals_cold"] and out["spec_equal"]
    assert out["requeues"] > 0 and out["spec_passes"] > 0
    assert out["warm_tokens"] < out["cold_tokens"]
    assert 6.0 <= out["verdict"]["d_cache_vs_h_cache"] <= 10.0
    if plan == "lossy":
        assert out["control_plane"]["retransmits"] > 0


def test_serve_rag_twin():
    out = _load("serve_rag_torch").main(["--device", "cpu"])
    assert out["first_wave"] and len(out["ids"]) == 3
    assert out["warm_tokens"] < out["cold_tokens"]
    assert out["stats"]["device"] > 0 and out["stats"]["host"] == 0


def test_distributed_inference_twin():
    out = _load("distributed_inference_torch").main(["--device", "cpu"])
    assert out["err"] < 1e-3 and out["err_after_failure"] < 1e-3
    assert out["rescheduled"] != out["placement"]


def test_elastic_training_twin():
    """8 gloo ranks on (2, 4), an async save, 6 ranks restored resharded
    onto (3, 2): the loss trajectory of the restored run against the
    same checkpoint restored onto (2, 4) (the twin asserts < 1e-5)."""
    out = _load("elastic_training_torch").main(["--device", "cpu"])
    assert out["err"] < 1e-5
    assert out["healthy_mesh"] == (2, 4) and out["degraded_mesh"] == (3, 2)
    assert out["losses"][-1] < out["losses"][0]
