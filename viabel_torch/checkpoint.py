"""Checkpoint and resume of optimizer state (counterpart of
``viabel_tpu/checkpoint.py``): the ``.npz`` backend and the directory
backend over ``torch.distributed.checkpoint``.

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

``save_pytree_orbax`` / ``load_pytree_orbax`` keep the JAX package's names
for its Orbax directory backend and write a ``torch.distributed.checkpoint``
directory instead. Every rank of the process group calls the save with
its own tree: a sharded run's state holds this rank's ring shard (or
rings) and its copy of the replicated leaves, and each rank writes its
tree to its own file, with no gather. A load reads one saved rank's tree
(by default its own rank's) or every saved rank's, in a process group of
any size or in one process, so a state saved on P ranks resumes on Q:
load every tree, join them with
:func:`viabel_torch.faso.merge_resume_states` and pass the whole state to
the run (the JAX package's Orbax restore re-shards its global arrays).
"""

import json
import os
import shutil

import numpy as np
import torch
import torch.distributed as dist

from .utils import check_device

__all__ = ["save_pytree", "load_pytree", "save_pytree_orbax", "load_pytree_orbax"]

_META_KEY = "__viabel_tpu_treedef__"


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


def _group():
    """``(rank, world size)`` of the default process group, or ``(0, 1)``
    without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dcp(fn, state, path, no_dist):
    """``dcp.save`` or ``dcp.load`` of ``state`` (with no collective when
    ``no_dist``), without the notice that DCP gives in one process."""
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(state, checkpoint_id=path, no_dist=no_dist)


def _kind(leaf):
    """How a leaf comes back from a load without a template."""
    if isinstance(leaf, torch.Tensor):
        return "tensor"
    if isinstance(leaf, (np.ndarray, np.generic)):
        return "numpy"
    return "object"


def _dcp_value(leaf):
    """A leaf as DCP stores it: tensors as they are (a numpy array or
    numpy scalar as a CPU tensor), Python scalars and strings as
    objects."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().contiguous()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return torch.from_numpy(np.array(leaf))  # a contiguous copy, 0-d kept
    return leaf


def save_pytree_orbax(path, tree):
    """Write ``tree`` to the checkpoint directory ``path`` with
    ``torch.distributed.checkpoint``, overwriting an existing one (the JAX
    package's ``force=True``). Under a process group every rank calls it
    with its own tree and writes it to its own file (a ring shard is
    written where it lies; nothing is gathered). Leaves are those of
    :func:`save_pytree`."""
    import torch.distributed.checkpoint as dcp
    rank, world = _group()
    state, paths, kinds = {}, [], []
    for i, (leaf_path, leaf) in enumerate(_flatten(tree)):
        state[f"rank{rank}/leaf_{i:05d}"] = _dcp_value(leaf)
        paths.append("/".join(leaf_path) or "__root__")
        kinds.append(_kind(leaf))
    state[f"rank{rank}/{_META_KEY}"] = json.dumps({"paths": paths, "kinds": kinds,
                                                  "world": world})
    path = os.path.abspath(path)
    if rank == 0 and os.path.lexists(path):
        if os.path.isdir(path) and not os.path.islink(path):
            shutil.rmtree(path)
        else:
            os.remove(path)
    if world > 1:
        dist.barrier()
    _dcp(dcp.save, state, path, world == 1)


def _nest(paths, leaves):
    """The nested dicts and lists that ``paths`` describe (a dict whose
    keys are ``0..n-1`` comes back a list)."""
    root = {}
    for path, leaf in zip(paths, leaves):
        node, parts = root, path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and sorted(node) == sorted(str(i) for i in range(len(node))):
            return [node[str(i)] for i in range(len(node))]
        return node

    out = lists(root)
    return out.get("__root__", out) if isinstance(out, dict) else out


def load_pytree_orbax(path, like=None, device="cuda", rank=None):
    """Read a directory written by :func:`save_pytree_orbax`: the tree
    that saved rank ``rank`` wrote (by default this process's rank in its
    process group, 0 without one), or with ``rank="all"`` the list of
    every saved rank's tree in rank order. The saved world size need not
    be this one's; no collective runs, so any rank may load alone.

    With ``like`` (a tree of the same structure, such as the state that
    was saved; with ``rank="all"`` a list of one a saved rank), each leaf
    comes back as the template's leaf: a tensor on its device and in its
    dtype (read there directly), a numpy array, or a Python scalar; a
    template leaf of another shape raises ``ValueError``, as the JAX
    package's Orbax restore does. Without it, the saved structure: tensors
    on ``device``, numpy arrays and Python scalars as they were saved.
    """
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    path = os.path.abspath(path)
    stored = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    saved = sorted(int(key.split("/", 1)[0][len("rank"):]) for key in stored
                   if key.endswith("/" + _META_KEY))
    if rank == "all":
        ranks = saved
        templates = [None] * len(saved) if like is None else list(like)
        if len(templates) != len(saved):
            raise ValueError(f"{path} holds {len(saved)} ranks' trees; "
                             f"{len(templates)} templates were given")
    else:
        ranks, templates = [_group()[0] if rank is None else int(rank)], [like]
        if ranks[0] not in saved:
            raise ValueError(f"{path} holds the trees of ranks {saved}, not of rank "
                             f"{ranks[0]}: pass rank= one of them, or rank='all'")
    if any(t is None for t in templates):
        device = check_device(device)
    metas = {f"rank{r}/{_META_KEY}": None for r in ranks}
    _dcp(dcp.load, metas, path, True)
    metas = [json.loads(metas[f"rank{r}/{_META_KEY}"]) for r in ranks]
    state, plans = {}, []
    for r, meta, tmpl_tree in zip(ranks, metas, templates):
        paths = meta["paths"]
        tmpls = ([None] * len(paths) if tmpl_tree is None
                 else [leaf for _, leaf in _flatten(tmpl_tree)])
        if len(tmpls) != len(paths):
            raise ValueError(f"checkpoint has {len(paths)} leaves; template has "
                             f"{len(tmpls)}")
        keys = [f"rank{r}/leaf_{i:05d}" for i in range(len(paths))]
        for key, tmpl, leaf_path in zip(keys, tmpls, paths):
            md = stored[key]
            if not isinstance(md, TensorStorageMetadata):
                state[key] = None
                continue
            shape = tuple(md.size)
            if tmpl is not None and hasattr(tmpl, "shape") and tuple(tmpl.shape) != shape:
                raise ValueError(f"leaf {leaf_path!r}: requested shape {tuple(tmpl.shape)} "
                                 f"is not compatible with the stored shape {shape}")
            where = (tmpl.device if isinstance(tmpl, torch.Tensor)
                     else device if tmpl is None else "cpu")
            state[key] = torch.empty(shape, dtype=md.properties.dtype, device=where)
        plans.append((keys, tmpls, meta, tmpl_tree))
    _dcp(dcp.load, state, path, True)
    trees = []
    for keys, tmpls, meta, tmpl_tree in plans:
        leaves = [state[key] for key in keys]
        if tmpl_tree is None:
            kinds = meta.get("kinds", ["tensor"] * len(keys))
            leaves = [v.cpu().numpy() if kind == "numpy" else v
                      for v, kind in zip(leaves, kinds)]
            trees.append(_nest(meta["paths"], leaves))
            continue
        restored = []
        for value, tmpl in zip(leaves, tmpls):
            if isinstance(tmpl, torch.Tensor):
                restored.append(value.to(tmpl.dtype))
            else:
                array = value.cpu().numpy() if isinstance(value, torch.Tensor) else value
                restored.append(_restore(np.asarray(array), tmpl))
        trees.append(_unflatten(tmpl_tree, iter(restored)))
    return trees if rank == "all" else trees[0]
