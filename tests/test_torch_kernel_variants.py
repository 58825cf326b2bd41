"""The scripts that build variants of a kernel by replacing lines of its
source (``kernels.build.build_variant``) still find those lines: each
edit of ``scripts/wkv_bwd_sweep.py`` in ``csrc/rwkv_scan_bwd.cu`` and of
``scripts/redesign_check.py``'s unswizzled scan in ``csrc/isp_scan.cu``.
So an edit of a kernel that moves them fails here, on the CPU, and not
only when the script runs on the card.  The builds themselves need
``nvcc`` and run on the card only."""
import importlib.util
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


SWEEP = _script("wkv_bwd_sweep")
CHECK = _script("redesign_check")
CASES = ([(build.CSRC / "rwkv_scan_bwd.cu", name, [*edits, SWEEP.OCCUPANCY])
          for name, _, edits in SWEEP.VARIANTS] +
         [(build.CSRC / "isp_scan.cu", "unswizzled", list(CHECK.UNSWIZZLE))])


@pytest.mark.parametrize("source, name, edits", CASES,
                         ids=[f"{c[0].stem}: {c[1]}" for c in CASES])
def test_variant_edits_find_their_lines(source, name, edits):
    text = source.read_text()
    for old, new in edits:
        assert old in text, f"{name}: {source.name} has no {old!r}"
        assert old != new, f"{name}: an edit that changes nothing"


def test_build_variant_refuses_a_missing_line_before_building(monkeypatch):
    def no_nvcc():
        raise AssertionError("nvcc reached")
    monkeypatch.setattr(build, "_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="has no"):
        build.build_variant(build.CSRC / "rwkv_scan_bwd.cu",
                            [("no such line in the source", "")], "t")
