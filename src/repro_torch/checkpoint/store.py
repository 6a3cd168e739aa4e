"""Checkpoints in the reference's format (``repro.checkpoint.store``).

- **atomic**: written to ``<dir>.tmp-<pid>`` and then renamed, so a
  checkpoint directory exists completely or not at all;
- **self-verifying**: ``manifest.json`` holds the sha256 of ``shard-0.npz``,
  and :func:`load_pytree` checks it before restoring;
- **keep-k GC**: :class:`CheckpointManager` keeps the newest ``keep``.

One ``shard-0.npz`` holds the leaves as ``leaf_<i>`` in the reference's
leaf order (:mod:`repro_torch.tree`), so a checkpoint that either package
wrote restores in the other, bitwise. A bf16 leaf is stored as the
reference's ``np.savez`` stores an ``ml_dtypes.bfloat16`` array: its raw
2-byte values (numpy ``V2``), read back as bf16 into a bf16 leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch import tree


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


_BF16_RAW = np.dtype("V2")        # how np.savez stores a bfloat16 array


def _to_numpy(x) -> np.ndarray:
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16_RAW)
    return x.numpy()


def _from_numpy(a: np.ndarray, like: torch.Tensor, what: str):
    if a.dtype == _BF16_RAW:
        if like.dtype != torch.bfloat16:
            raise IOError(f"{what}: raw 2-byte values (bfloat16), expected "
                          f"{like.dtype}")
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def save_pytree(tree_: object, directory: str) -> None:
    """Write ``tree_`` (tensors or arrays as leaves) to ``directory``,
    replacing what was there only once the new checkpoint is complete."""
    tmp = f"{directory}.tmp-{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    flat = tree.leaves(tree_)
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(flat)}
    npz = os.path.join(tmp, "shard-0.npz")
    np.savez(npz, **arrays)
    manifest = {"treedef": tree.describe(tree_), "n_leaves": len(flat),
                "digests": {"shard-0.npz": _digest(npz)}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_pytree(tree_like, directory: str, *, device=None):
    """Restore into the structure of ``tree_like``: each leaf a tensor with
    the stored dtype, on ``device`` or else the device of the matching
    leaf of ``tree_like`` (which may be a meta tensor when ``device`` is
    given). Raises ``IOError`` on a failed integrity check or a leaf count
    or shape that does not match."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    npz_path = os.path.join(directory, "shard-0.npz")
    if _digest(npz_path) != manifest["digests"]["shard-0.npz"]:
        raise IOError(f"checkpoint {directory} failed integrity check")
    like = tree.leaves(tree_like)
    if manifest["n_leaves"] != len(like):
        raise IOError(
            f"checkpoint {directory} has {manifest['n_leaves']} leaves, "
            f"expected {len(like)} (config mismatch?)")
    restored = []
    with np.load(npz_path) as data:
        for i, ref in enumerate(like):
            a = data[f"leaf_{i}"]
            if tuple(a.shape) != tuple(ref.shape):
                raise IOError(f"checkpoint {directory}: leaf {i} has shape "
                              f"{a.shape}, expected {tuple(ref.shape)}")
            restored.append(_from_numpy(a, ref, f"checkpoint {directory}: "
                                        f"leaf {i}").to(
                device if device is not None else ref.device))
    return tree.unflatten(tree_like, restored)


class CheckpointManager:
    """``step_<10 digits>`` checkpoint directories under ``root``."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        os.makedirs(root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def steps(self) -> list[int]:
        """Steps with a complete checkpoint (an unfinished ``.tmp-<pid>``
        directory is not one)."""
        out = []
        for name in os.listdir(self.root):
            digits = name[len("step_"):]
            if (name.startswith("step_") and digits.isdigit()
                    and os.path.exists(os.path.join(self.root, name,
                                                    "manifest.json"))):
                out.append(int(digits))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree_) -> None:
        save_pytree(tree_, self._dir(step))
        self._gc()

    def restore(self, step: int, tree_like, *, device=None):
        return load_pytree(tree_like, self._dir(step), device=device)

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self._dir(s), ignore_errors=True)
