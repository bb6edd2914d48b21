"""Manifest-based checkpointing with atomic publish and restart-from-latest.

Layout (one directory per step):

    <root>/step_000123/
        manifest.json        tree structure, shapes, dtypes, leaf hashes,
                             data cursor, rng, config fingerprint
        arrays.npz           flat leaf arrays (host-gathered)

The manifest is written LAST and the directory renamed from a `.tmp` suffix,
so a crash mid-write never leaves a checkpoint that `latest_step()` would
pick up; corrupt payloads are detected by leaf hash and skipped.  Leaves are
saved on the host: a restore puts each leaf on its template's device, in
its template's dtype.

Trees are nested dicts (keys taken in sorted order), lists and tuples
(NamedTuples included) whose leaves are tensors, numpy arrays or scalars.
A bf16 tensor is stored widened to f32 (exact) and cast back on restore.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "list_steps"]

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"


def _flatten(tree: Any) -> tuple[list[np.ndarray], Any, list[str]]:
    """Leaves in a fixed order (dict keys sorted), as numpy arrays, and the
    tree's structure with each leaf replaced by ``"*"``."""
    leaves = _leaves(tree)
    treedef = _unflatten(tree, iter(["*"] * len(leaves)))
    arrs = [_to_numpy(x) for x in leaves]
    names = [f"leaf_{i:05d}" for i in range(len(arrs))]
    return arrs, treedef, names


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def _leaves(tree: Any) -> list[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in _leaves(x)]
    return [tree]


def _unflatten(template: Any, leaves) -> Any:
    """`template`'s structure with its leaves taken from the iterator
    `leaves` in `_flatten`'s order."""
    if isinstance(template, dict):
        got = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: got[k] for k in template}
    if isinstance(template, (list, tuple)):
        items = [_unflatten(x, leaves) for x in template]
        if hasattr(template, "_fields"):  # NamedTuple
            return type(template)(*items)
        return type(template)(items)
    return next(leaves)


def _restore_leaf(a: np.ndarray, t: Any) -> Any:
    if isinstance(t, torch.Tensor):
        return torch.from_numpy(np.array(a)).to(dtype=t.dtype).reshape(t.shape).to(t.device)
    t = np.asarray(t)
    return np.asarray(a).astype(t.dtype).reshape(t.shape)


def _leaf_hash(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def save_checkpoint(
    root: str,
    step: int,
    tree: Any,
    *,
    extra: dict | None = None,
    keep: int = 3,
) -> str:
    """Atomically publish a checkpoint; prunes to the newest `keep`."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrs, treedef, names = _flatten(tree)
    np.savez(os.path.join(tmp, _ARRAYS), **dict(zip(names, arrs)))
    manifest = {
        "step": step,
        "treedef": json.dumps(treedef),
        "leaves": [
            {"name": n, "shape": list(a.shape), "dtype": str(a.dtype), "hash": _leaf_hash(a)}
            for n, a in zip(names, arrs)
        ],
        "extra": extra or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(root, keep)
    return final


def _prune(root: str, keep: int) -> None:
    steps = list_steps(root)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(root, f"step_{s:09d}"), ignore_errors=True)


def list_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, _MANIFEST)):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    continue
    return sorted(out)


def latest_step(root: str) -> int | None:
    steps = list_steps(root)
    return steps[-1] if steps else None


def restore_checkpoint(
    root: str, template: Any, *, step: int | None = None
) -> tuple[Any, dict, int] | None:
    """Restore into the structure of `template` (shapes must match).

    Walks backwards from the newest checkpoint, skipping corrupt ones
    (hash mismatch / missing arrays) — the fail-slow tolerant restore path.
    Returns (tree, extra, step) or None.
    """
    candidates = [step] if step is not None else list(reversed(list_steps(root)))
    for s in candidates:
        if s is None:
            continue
        path = os.path.join(root, f"step_{s:09d}")
        try:
            with open(os.path.join(path, _MANIFEST)) as f:
                manifest = json.load(f)
            data = np.load(os.path.join(path, _ARRAYS))
            leaves = []
            for meta in manifest["leaves"]:
                a = data[meta["name"]]
                if _leaf_hash(a) != meta["hash"]:
                    raise IOError(f"hash mismatch in {meta['name']}")
                leaves.append(a)
            t_leaves = _leaves(template)
            if len(t_leaves) != len(leaves):
                raise IOError("leaf count mismatch vs template")
            restored = _unflatten(
                template,
                iter([_restore_leaf(a, t) for a, t in zip(leaves, t_leaves)]),
            )
            return restored, manifest.get("extra", {}), int(manifest["step"])
        except Exception:
            continue  # corrupt/partial: try the previous one
    return None
