"""Checkpoint serialization: one .npy per leaf + a JSON manifest (port of
``repro.checkpoint.serialize``; each package reads the other's).

Layout of a checkpoint directory:

    step_000420/
      MANIFEST.json        {"step": 420, "leaves": {"<path>": {...}}, ...}
      <path-hash>.npy      one array per tree leaf

* Tree paths are the manifest keys, spelled as the reference spells them
  (``jax.tree_util`` key paths joined by "/": dict keys, sequence indices
  and NamedTuple field names, e.g. ``opt/mu/groups/0/sub0/attn/wq``), and
  the file names derive from them the same way, so the two packages read
  each other's checkpoints.
* bf16 leaves are stored as their uint16 words with ``"dtype":
  "bfloat16"`` in the manifest; a Python scalar leaf (the port's
  ``OptState.count``) is stored as the 0-d int32 / f32 array the
  reference keeps there.
* Writes go to ``<dir>.tmp`` then ``os.rename``: a crash mid-write never
  corrupts the latest checkpoint.
* Every leaf's CRC32 is recorded in the manifest and re-verified on load:
  a checkpoint that rotted on disk raises :class:`ChecksumError` naming
  the leaf instead of silently restoring garbage weights.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch


class ChecksumError(ValueError):
    """A stored array's bytes no longer match their recorded CRC32."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] in ``jax.tree_util`` order: dict keys sorted,
    sequences and NamedTuple fields in order; empty containers and
    ``None`` hold no leaves."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [x for name in tree._fields
                for x in flatten_with_path(getattr(tree, name),
                                           prefix + (name,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in flatten_with_path(t, prefix + (str(i),))]
    if tree is None:
        return []
    return [(prefix, tree)]


def map_with_path(tree, fn, prefix: tuple = ()):
    """``tree`` with every leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_path(tree[k], fn, prefix + (str(k),))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(getattr(tree, n), fn,
                                          prefix + (n,))
                            for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(t, fn, prefix + (str(i),))
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(prefix, tree)


def _path_str(path) -> str:
    return "/".join(path)


def _fname(path_str: str) -> str:
    h = hashlib.sha1(path_str.encode()).hexdigest()[:16]
    safe = "".join(c if c.isalnum() or c in "._-" else "_"
                   for c in path_str)[-48:]
    return f"{safe}.{h}.npy"


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, logical dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    elif isinstance(leaf, bool):
        arr = np.asarray(leaf)
    elif isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)
    elif isinstance(leaf, float):
        arr = np.asarray(leaf, np.float32)
    else:
        arr = np.asarray(leaf)
        if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
            return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def save_pytree(directory: str, tree: Any, *, step: int = 0,
                extra_meta: Optional[dict] = None):
    """Write ``tree`` (tensors / numpy arrays / scalars) to ``directory``."""
    tmp = directory + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    leaves_meta = {}
    for path, leaf in flatten_with_path(tree):
        ps = _path_str(path)
        arr, logical_dtype = _to_numpy(leaf)
        fn = _fname(ps)
        np.save(os.path.join(tmp, fn), arr, allow_pickle=False)
        leaves_meta[ps] = {"file": fn, "shape": list(arr.shape),
                           "dtype": logical_dtype,
                           "crc32": zlib.crc32(np.ascontiguousarray(arr)
                                               .tobytes())}

    manifest = {"step": step, "leaves": leaves_meta,
                "meta": extra_meta or {}}
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)

    if os.path.exists(directory):
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def load_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "MANIFEST.json")) as f:
        return json.load(f)


def load_pytree(directory: str, like: Any, *, device=None) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors, arrays
    or Python scalars).  Each tensor leaf lands on ``device`` (default: the
    ``like`` leaf's own device) in its stored dtype; a Python scalar leaf
    comes back as a Python scalar."""
    manifest = load_manifest(directory)
    leaves_meta = manifest["leaves"]

    def one(path, leaf):
        ps = _path_str(path)
        if ps not in leaves_meta:
            raise KeyError(f"checkpoint {directory} missing leaf {ps!r}")
        meta = leaves_meta[ps]
        arr = np.load(os.path.join(directory, meta["file"]),
                      allow_pickle=False)
        if "crc32" in meta:        # absent in pre-integrity checkpoints
            got = zlib.crc32(np.ascontiguousarray(arr).tobytes())
            if got != meta["crc32"]:
                raise ChecksumError(
                    f"leaf {ps!r} in {directory}: stored CRC32 "
                    f"{meta['crc32']:#010x} != {got:#010x} on disk — the "
                    f"checkpoint is corrupt; restore an older step")
        expect = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != expect:
            raise ValueError(
                f"leaf {ps!r}: checkpoint shape {arr.shape} != {expect}")
        if isinstance(leaf, (bool, int, float)):
            return type(leaf)(arr)
        if meta["dtype"] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(arr.copy())
        dev = device if device is not None else getattr(leaf, "device",
                                                         "cpu")
        return t.to(dev)

    return map_with_path(like, one)
