"""Atomic checkpoints of a flat tree of numpy arrays: save, restore,
list, and keep the newest few.

Port of `repro.distributed.checkpoint`. The reference flattens any jax
pytree by key path; the trees the port checkpoints are flat dicts of
numpy arrays (`ServingEngine.checkpoint_tree`), so the port stores each
key as it is and casts back to the template's dtypes on restore.

A save writes the arrays as one .npz plus a JSON manifest under a
temporary directory and renames it to ``step_<step>`` (a crash mid-save
never corrupts the newest checkpoint); ``keep`` bounds how many step
directories stay on disk. ``process_index`` names the shard file, as in
the reference, so a multi-process caller can give each process its own.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def _flatten(tree: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        raise TypeError(f"expected a flat dict of arrays, got {type(tree)}")
    out = {}
    for key, leaf in tree.items():
        if isinstance(leaf, dict):
            raise TypeError(f"{key!r}: nested trees are not supported")
        out[str(key)] = np.asarray(leaf)
    return out


def _unflatten(tree_like: Dict[str, np.ndarray],
               flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Shapes from the stored arrays, dtypes from `tree_like`."""
    out = {}
    for key, leaf in tree_like.items():
        arr = flat[key]
        dtype = getattr(leaf, "dtype", None)
        if dtype is not None and arr.dtype != dtype:
            arr = arr.astype(dtype)
        out[key] = arr
    return out


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, process_index: int = 0):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.proc = process_index

    def _step_dir(self, step: int) -> pathlib.Path:
        return self.dir / f"step_{step:08d}"

    def save(self, step: int, tree: Dict[str, np.ndarray],
             metadata: Optional[Dict] = None) -> pathlib.Path:
        tmp = self.dir / f".tmp_step_{step:08d}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        flat = _flatten(tree)
        np.savez(tmp / f"shard_{self.proc}.npz", **flat)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(flat), "metadata": metadata or {}}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)             # atomic publish
        self._gc()
        return final

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Dict[str, np.ndarray],
                step: Optional[int] = None
                ) -> Tuple[Dict[str, np.ndarray], int]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        with np.load(self._step_dir(step) / f"shard_{self.proc}.npz") as z:
            flat = dict(z)
        return _unflatten(tree_like, flat), step
