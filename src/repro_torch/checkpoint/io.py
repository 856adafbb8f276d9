"""Checkpointing: save and restore a tree of tensors (a ``RoundState``
included) in the JAX package's format, so a checkpoint written by either
package restores in the other.

Layout per step:  <dir>/step_<N:08d>/
    manifest.json   — keypaths, shapes, dtypes (integrity-checked on load)
    arrays.npz      — one entry per leaf, keyed by its keypath

A tree is a dict (nested or flat), a NamedTuple, a list or tuple of
those, with leaves that are tensors, numpy arrays or Python numbers;
``None`` is an empty subtree. Keypaths are the reference's letter for
letter: dict keys joined by ``/`` (a flat name ``"l1/wx"`` reads as the
nested ``{"l1": {"wx"}}``), a list index as its number, and a NamedTuple
field as ``.field`` (``jax.tree_util``'s ``GetAttrKey`` prints so), so a
``RoundState`` writes ``.params/w1``, ``.rng`` and ``.round``.

Dtypes follow the reference's: a PRNG key (an int64 ``[..., 2]`` leaf
named ``rng`` or ``clock_rng``, the port's two-word layout) is written as
uint32, a Python int as int32 (the reference's round counter), and a
bf16 leaf upcast to f32 (npz has no bf16); restore casts every leaf back
to its ``like`` leaf's dtype and device, a uint32 key into int64.

Atomicity: written to a tmp dir and ``os.replace()``'d into place, so a
crashed write never leaves a half checkpoint behind. ``keep`` rotates old
steps out. A tensor on the card is copied to the host once, whole.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

Tree = Any

__all__ = ["save_checkpoint", "restore_checkpoint", "read_checkpoint",
           "latest_step", "list_checkpoints"]

KEY_LEAVES = ("rng", "clock_rng")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flat_with_paths(tree: Tree, prefix: tuple = ()) -> list:
    """``[(path, leaf)]`` in ``jax.tree.flatten`` order: dict keys sorted,
    NamedTuple fields and sequence items in order, None skipped. A path
    is a tuple of its components' printed forms."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flat_with_paths(tree[k], prefix + (str(k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += _flat_with_paths(getattr(tree, f), prefix + (f".{f}",))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flat_with_paths(v, prefix + (str(i),))
        return out
    return [(prefix, tree)]


def _rebuild(tree: Tree, leaves: dict, prefix: tuple = ()) -> Tree:
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(**{f: _rebuild(getattr(tree, f), leaves,
                                          prefix + (f".{f}",))
                             for f in tree._fields})
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _key(path: tuple) -> str:
    return "/".join(path)


def _to_numpy(path: tuple, v) -> np.ndarray:
    """One leaf as the array the reference would write."""
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        a = t.cpu().numpy()
    elif isinstance(v, bool):
        a = np.asarray(v)
    elif isinstance(v, int):
        a = np.asarray(v, np.int32)
    else:
        a = np.asarray(v)
        if a.dtype.kind == "V" or str(a.dtype) == "bfloat16":
            a = a.astype(np.float32)
    if (path and path[-1].lstrip(".") in KEY_LEAVES and a.dtype == np.int64
            and a.shape[-1:] == (2,)):
        a = a.astype(np.uint32)
    return a


def save_checkpoint(ckpt_dir: str | Path, step: int, tree: Tree, *,
                    keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays = {_key(p): _to_numpy(p, v) for p, v in _flat_with_paths(tree)}
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(a.shape), "dtype": str(a.dtype)}
                   for k, a in arrays.items()},
    }
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)

    if keep > 0:
        steps = sorted(list_checkpoints(ckpt_dir))
        for old in steps[:-keep]:
            shutil.rmtree(ckpt_dir / f"step_{old:08d}")
    return final


def list_checkpoints(ckpt_dir: str | Path) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for p in ckpt_dir.iterdir():
        if p.is_dir() and p.name.startswith("step_"):
            out.append(int(p.name[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str | Path) -> int | None:
    steps = list_checkpoints(ckpt_dir)
    return steps[-1] if steps else None


def _step_dir(ckpt_dir: str | Path, step: int | None) -> tuple[Path, int]:
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    return ckpt_dir / f"step_{step:08d}", step


def read_checkpoint(ckpt_dir: str | Path, step: int | None = None
                    ) -> tuple[dict[str, np.ndarray], int]:
    """Raw read: the flat ``{keypath: array}`` dict as written (keys
    uint32), no ``like`` tree — for callers whose structure the
    checkpoint itself records (the client pool's variable slab count)."""
    d, step = _step_dir(ckpt_dir, step)
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as data:
        out = {k: data[k] for k in manifest["leaves"]}
    return out, step


def _like_leaf(arr: np.ndarray, ref):
    """``arr`` as ``ref``'s kind of leaf: a tensor of its dtype on its
    device, a numpy array of its dtype, or a Python number."""
    if isinstance(ref, torch.Tensor):
        a = arr.astype(np.int64) if arr.dtype == np.uint32 else arr
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=ref.device, dtype=ref.dtype)
    if isinstance(ref, np.ndarray):
        return arr.astype(ref.dtype)
    if isinstance(ref, bool):
        return bool(arr)
    if isinstance(ref, int):
        return int(arr)
    if isinstance(ref, float):
        return float(arr)
    return arr


def restore_checkpoint(ckpt_dir: str | Path, like: Tree,
                       step: int | None = None) -> tuple[Tree, int]:
    """Restore into the structure of ``like`` (keypaths, shapes checked;
    each leaf cast to ``like``'s dtype and placed on its device)."""
    data, step = read_checkpoint(ckpt_dir, step)
    leaves = {}
    for path, ref in _flat_with_paths(like):
        key = _key(path)
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[key]
        want = tuple(ref.shape) if hasattr(ref, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"shape mismatch for {key!r}: "
                             f"{arr.shape} vs {want}")
        leaves[path] = _like_leaf(arr, ref)
    return _rebuild(like, leaves), step
