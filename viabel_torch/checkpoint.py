"""Checkpoint and resume of optimizer state, the ``.npz`` backend
(counterpart of ``viabel_tpu/checkpoint.py:42-70, 124-144``).

``save_pytree`` writes a nested structure of dicts, lists and tuples whose
leaves are tensors, numpy arrays, Python scalars or strings to one
``.npz`` archive, in the JAX package's layout: leaf ``i`` (in the JAX
package's flattening order: dict entries by sorted key, list and tuple
items in order, ``None`` holding no leaf) under ``leaf_%05d``, and a JSON
description under ``__viabel_tpu_treedef__``. So a file that either
package writes can be read by the other: a FASO ``resume_state`` saved by
the JAX package loads here with the JAX state as the template, and
:func:`viabel_torch.convert.resume_state_from_jax` makes it the port's.

Combined with ``FASO.optimize(..., resume_state=...)`` a run that was
stopped restarts from its last segment boundary with the same
convergence statistics (the history ring is the detection state).
"""

import json
import os

import numpy as np
import torch

from .utils import check_device, deferred_names

__all__ = ["save_pytree", "load_pytree"]

_META_KEY = "__viabel_tpu_treedef__"

#: the Orbax directory backend writes mesh-sharded arrays shard by shard;
#: it comes with the sharded engines (ROADMAP.md, Queue 1 item 13b)
__getattr__ = deferred_names(__name__, {"save_pytree_orbax": "13b",
                                        "load_pytree_orbax": "13b"})


def _flatten(tree, path=()):
    """``(path, leaf)`` pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], path + (str(key),))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _flatten(item, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        restored = {key: _unflatten(like[key], leaves) for key in sorted(like)}
        return {key: restored[key] for key in like}
    if isinstance(like, (list, tuple)):
        items = [_unflatten(item, leaves) for item in like]
        return items if isinstance(like, list) else tuple(items)
    if like is None:
        return None
    return _restore(next(leaves), like)


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _restore(array, like):
    """A stored array as the template leaf's kind: a tensor on the
    template's device and in its dtype, a numpy array in its dtype, or a
    Python scalar or string."""
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(array, dtype=like.dtype, device=like.device)
    if isinstance(like, bool):
        return bool(array)
    if isinstance(like, int):
        return int(array)
    if isinstance(like, float):
        return float(array)
    if isinstance(like, str):
        return str(array)
    if hasattr(like, "dtype"):  # numpy, or another package's array
        return np.asarray(array).astype(np.dtype(like.dtype))
    return array


def save_pytree(path, tree):
    """Write ``tree`` to ``path`` (``.npz``): through ``path + ".tmp"`` and
    ``os.replace``, so a reader never sees a partial file."""
    arrays, paths = {}, []
    for i, (leaf_path, leaf) in enumerate(_flatten(tree)):
        arrays[f"leaf_{i:05d}"] = _to_numpy(leaf)
        paths.append("/".join(leaf_path) or "__root__")
    arrays[_META_KEY] = np.frombuffer(
        json.dumps({"treedef": "viabel_torch", "paths": paths}).encode(),
        dtype=np.uint8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_pytree(path, like=None, device="cuda"):
    """Read a file written by :func:`save_pytree` (of either package).

    With ``like`` (a tree of the same structure, such as the state that
    was saved or a fresh one), each leaf comes back as the template's
    leaf: a tensor on its device and in its dtype, a numpy array in its
    dtype, or a Python scalar. Without it, a list of the leaves as tensors
    on ``device``.
    """
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for name in data.files if name.startswith("leaf_"))
        arrays = [data[f"leaf_{i:05d}"] for i in range(n)]
    if like is None:
        device = check_device(device)
        return [torch.as_tensor(a, device=device) for a in arrays]
    n_like = sum(1 for _ in _flatten(like))
    if n_like != len(arrays):
        raise ValueError(f"checkpoint has {len(arrays)} leaves; template has {n_like}")
    return _unflatten(like, iter(arrays))
