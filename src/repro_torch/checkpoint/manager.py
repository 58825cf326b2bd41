"""Checkpoint manager (the port of ``repro.checkpoint.manager``).

  * **Atomic commits**: leaves go to ``step_N.tmp/``, then a manifest,
    and the directory is renamed to ``step_N`` last: a crash mid-save
    never corrupts the latest checkpoint.
  * **Async saves**: the leaves are copied to the host first (the only
    sync point; a copy even for a CPU tensor, since the train step
    updates params and moments in place afterwards), then a background
    thread writes them.
  * **The reference's layout**: one ``.npy`` a leaf, named by its tree
    path joined by ``/`` (``/`` stored as ``__``), the same keys as
    ``jax.tree_util.tree_flatten_with_path`` gives (dict keys sorted,
    a NamedTuple field ``f`` as ``.f``), so a checkpoint written by the
    JAX package restores here and the other way round.
  * λFS: with ``fs=`` the blobs live in a DockerSSD's private namespace
    (``repro_torch.core.lambda_fs``), the pool's checkpoint store.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix=()):
    """{key: leaf} in the order and with the keys JAX's
    ``tree_flatten_with_path`` gives the same tree."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return {"/".join(prefix): tree}
    out = {}
    for name, sub in items:
        out.update(_flatten(sub, prefix + (name,)))
    return out


def _unflatten(template, loaded, prefix=()):
    """``template``'s structure with each leaf replaced by ``loaded``'s
    array of its key, as a tensor on the template leaf's device."""
    if isinstance(template, dict):
        return {k: _unflatten(v, loaded, prefix + (str(k),))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(
            _unflatten(getattr(template, f), loaded, prefix + (f".{f}",))
            for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, loaded, prefix + (str(i),))
                              for i, x in enumerate(template))
    arr = torch.from_numpy(np.array(loaded["/".join(prefix)], order="C"))
    if isinstance(template, torch.Tensor):
        return arr.to(template.device)
    return arr


def _to_numpy(leaf) -> np.ndarray:
    """A host copy of ``leaf`` that later in-place updates do not reach
    (``.cpu()`` of a CPU tensor would share its storage)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


def _structure(tree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (f"{type(tree).__name__}(" +
                ", ".join(_structure(x) for x in tree) + ")")
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(_structure(x) for x in tree) + "]"
    return "*"


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 fs=None, fs_prefix: str = "/ckpt"):
        self.dir = directory
        self.keep = keep
        self.fs = fs
        self.fs_prefix = fs_prefix
        self._save_thread: Optional[threading.Thread] = None
        self._last_error: Optional[Exception] = None
        if fs is None:
            os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Any, *, blocking: bool = True):
        """Serialize a tree of tensors.  With blocking=False the write
        happens on a background thread (async checkpointing); the
        leaves are on the host before this returns."""
        arrays = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
        manifest = {
            "step": step,
            "keys": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                     for k, v in arrays.items()},
            "treedef": _structure(tree),
        }
        # a write still in flight finishes first (the reference skips this
        # for a blocking save, which then races a pending async save of
        # the same step over step_N.tmp)
        self.wait()
        if blocking:
            self._write(step, arrays, manifest)
        else:
            self._save_thread = threading.Thread(
                target=self._write_guarded, args=(step, arrays, manifest),
                daemon=True)
            self._save_thread.start()

    def _write_guarded(self, step, arrays, manifest):
        try:
            self._write(step, arrays, manifest)
        except Exception as e:  # surfaced on the next wait()
            self._last_error = e

    def _write(self, step, arrays, manifest):
        if self.fs is not None:
            base = f"{self.fs_prefix}/step_{step}.tmp"
            for k, v in arrays.items():
                buf = io.BytesIO()
                np.save(buf, v)
                self.fs.write(f"{base}/{k.replace('/', '__')}.npy",
                              buf.getvalue())
            self.fs.write(f"{base}/manifest.json",
                          json.dumps(manifest).encode())
            # atomic commit: write the manifest pointer last
            self.fs.write(f"{self.fs_prefix}/step_{step}/COMMITTED",
                          json.dumps(manifest).encode())
            for name in self.fs.listdir(base):
                self.fs.symlink(f"{base}/{name}",
                                f"{self.fs_prefix}/step_{step}/{name}")
            return
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, v in arrays.items():
            np.save(os.path.join(tmp, k.replace("/", "__") + ".npy"), v)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)          # the atomic commit point
        self._gc()

    def wait(self):
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"))

    # -- restore ----------------------------------------------------------------

    def steps(self):
        if self.fs is not None:
            names = [n for n in self.fs.listdir(self.fs_prefix)
                     if n.startswith("step_") and not n.endswith(".tmp")]
            return sorted(int(n.split("_")[1]) for n in names)
        if not os.path.isdir(self.dir):
            return []
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, *, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``template``; each leaf lands on
        the device of the template's leaf (the host for a non-tensor)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoints")

        def load(k):
            fname = k.replace("/", "__") + ".npy"
            if self.fs is not None:
                data = self.fs.read(f"{self.fs_prefix}/step_{step}/{fname}")
                return np.load(io.BytesIO(data))
            return np.load(os.path.join(self.dir, f"step_{step}", fname))

        loaded = {k: load(k) for k in _flatten(template)}
        return _unflatten(template, loaded)
