"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface,
``<checkout>/build/repro_torch/lib<name>_<hash>.so``, where the hash
covers the source, the shared headers ``csrc/*.cuh`` and the flags, and
loaded with ``ctypes``.  The build runs at first use (or ahead, from
:func:`build_all`, one ``nvcc`` per source, all started together); a
failed build or load raises, and no caller falls back to the plain
version.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# -I csrc: the shared headers (csrc/*.cuh), also for copies of a source
# built elsewhere (the phase probe, the sweeps)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(CSRC)]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin); the "
                       "port's CUDA kernels are built on the machine with "
                       "the card")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc into a temporary name; None if already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> str:
    if job is None:
        return ""
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)            # atomic: a reader never sees half a file
    return log


def build_all(names=None) -> Dict[str, str]:
    """Compile every ``csrc/*.cu`` not yet built (or those of ``names``),
    one nvcc each, all at once.  Returns {name: nvcc's output} (its
    ``-Xptxas -v`` report of registers, shared memory and spills)."""
    names = sorted(names or (p.stem for p in CSRC.glob("*.cu")))
    jobs = {n: _start(n) for n in names}
    return {n: _finish(n, job) for n, job in jobs.items()}


def build_variant(source: Path, edits, tag: str) -> Tuple[ctypes.CDLL, str]:
    """Build a copy of the CUDA source ``source`` with each ``(old, new)``
    of ``edits`` replaced in its text into ``BUILD_DIR/lib<tag>.so`` and
    load it: (the library, nvcc's output with its ``-Xptxas -v`` report).
    For scripts that time or check a variant of a kernel; an edit whose
    ``old`` is not in the text, or a failed build, raises."""
    text = Path(source).read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{tag}: {Path(source).name} has no {old!r}")
        text = text.replace(old, new)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = BUILD_DIR / f"{tag}.cu"
    lib = BUILD_DIR / f"lib{tag}.so"
    src.write_text(text)
    done = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    log = done.stdout + done.stderr
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag} (exit "
                           f"{done.returncode}):\n{log}")
    return ctypes.CDLL(str(lib)), log


def ptxas_lines(log: str):
    """The registers, stack and spill lines of nvcc's ``-Xptxas -v``
    report, each after its function's name."""
    return [line.strip() for line in log.splitlines()
            if "Function properties" in line or "spill" in line or
            "registers" in line]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if missing."""
    _finish(name, _start(name))
    return ctypes.CDLL(str(library_path(name)))
