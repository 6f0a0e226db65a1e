"""Parameter-tree checkpointing in the reference's on-disk format (its
``checkpoint/checkpointer.py``): ``step_%08d/arrays.npz`` holding one array
per leaf (``a0``, ``a1``, ... in sorted key order) beside ``manifest.json``
(``{"step": s, "leaves": {key: {"name", "dtype"}}}``), written under
``.tmp`` and then renamed. Keys are ``jax.tree_util``'s path notation of a
nested dict, ``"['embed']/['tok']"``, and the port's trees have the
reference's paths, so a checkpoint either package writes restores in the
other bit for bit. bfloat16 has no numpy dtype: it is stored as uint16 with
``"dtype": "bfloat16"``. Tensors are copied to the host before the save;
``restore`` puts each leaf on its target leaf's device. Keeps the last
``keep`` checkpoints."""
from __future__ import annotations

import json
import os
import re
import shutil

import numpy as np
import torch


def _flatten_with_paths(tree, prefix: tuple = ()) -> dict:
    """{path key: leaf} of a nested dict (lists and None too, as the
    recurrent families' trees hold), keys as ``jax.tree_util`` writes them
    (``"['a']/['b']"``, ``"['rest']/[0]/['ln']"``)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten_with_paths(tree[k], prefix + (f"[{k!r}]",)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, t in enumerate(tree):
            out.update(_flatten_with_paths(t, prefix + (f"[{i}]",)))
        return out
    if tree is None:
        return {}
    return {"/".join(prefix): tree}


def _to_numpy(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, arr.dtype.name


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, tree) -> str:
        path = self._path(step)
        tmp = path + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        arrays, manifest = {}, {}
        for i, (key, leaf) in enumerate(sorted(_flatten_with_paths(tree).items())):
            name = f"a{i}"
            arrays[name], dtype = _to_numpy(leaf)
            manifest[key] = {"name": name, "dtype": dtype}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f, indent=1)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()
        return path

    def _gc(self):
        for s in self.all_steps()[: -self.keep]:
            shutil.rmtree(self._path(s), ignore_errors=True)

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target):
        """A tree shaped like ``target`` (a nested dict of tensors) from the
        checkpoint of ``step``: each leaf in the checkpoint's dtype, on its
        target leaf's device. A missing leaf raises KeyError, a shape
        mismatch ValueError."""
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        with np.load(os.path.join(path, "arrays.npz")) as data:
            def load(key, leaf):
                if key not in manifest:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                entry = manifest[key]
                arr = data[entry["name"]]
                if arr.shape != tuple(leaf.shape):
                    raise ValueError(f"shape mismatch for {key!r}: ckpt {arr.shape} vs "
                                     f"target {tuple(leaf.shape)}")
                return _from_numpy(arr, entry["dtype"], leaf.device)

            def walk(node, prefix):
                if isinstance(node, dict):
                    return {k: walk(node[k], prefix + (f"[{k!r}]",)) for k in sorted(node)}
                if isinstance(node, list):
                    return [walk(t, prefix + (f"[{i}]",)) for i, t in enumerate(node)]
                if node is None:
                    return None
                return load("/".join(prefix), node)

            return walk(target, ())
