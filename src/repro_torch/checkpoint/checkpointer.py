"""Fault-tolerant checkpointing: async, atomic, in the reference's layout.

Counterpart of ``repro.checkpoint.checkpointer``.  Layout per step::

    <dir>/step_<N>.tmp/ …writing… -> atomic rename -> <dir>/step_<N>/
        manifest.json      (leaf paths, shapes, dtypes, step)
        arrays.npz         (flat leaf arrays, host layout)

Writes happen on a background thread (training continues); the manifest is
written last and the directory renamed atomically, so a crash mid-write
never corrupts the latest checkpoint.

The layout is the reference's, so that a checkpoint written by either
package restores in the other.  A tree is flattened as
``jax.tree_util.tree_flatten_with_path`` flattens the reference's: dict
keys sorted (``['key']``), list and tuple items (``[i]``), NamedTuple
fields (``.field``), and each path written as ``keystr`` writes it.  A
parameter module in the tree (the model, or an optimizer's state shaped
like it) stands for the reference's parameter tree,
``models.weights.to_jax_params``: its layers stacked on a leading (L, ...)
axis under the reference's keys.  So ``(params, SGDState)`` gives the
parameter paths, then ``[1].step`` and the momentum's leaves when there
are any.  bf16 is stored as its uint16 bit pattern with the dtype name
``bfloat16``; restoring it needs no ``ml_dtypes`` (the bits are viewed as
``torch.bfloat16``).  Restore matches leaves by flatten order, checks each
path and shape against the target's, and writes parameter modules in
place.

The runtime's global state tier checkpoints through the same directory
(``save_global_tier`` / ``restore_global_tier``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.weights import (Bits, load_jax_params, numpy_to_torch,
                                         to_jax_params, torch_to_numpy)

# dtypes numpy can savez/load natively; others round-trip as bit views
_NUMPY_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16",
                 "int8", "uint64", "uint32", "uint16", "uint8", "bool",
                 "complex64", "complex128"}
_LEAVES = (torch.Tensor, np.ndarray, np.generic, int, float, bool)


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in the reference's flatten order."""
    if isinstance(tree, nn.Module):
        yield from _flatten(to_jax_params(tree, tree.cfg), path)
    elif isinstance(tree, (Bits, *_LEAVES)):
        yield path, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _flatten(x, f"{path}[{i}]")
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif tree is not None:
        raise TypeError(f"checkpoint: no rule for {type(tree).__name__} at "
                        f"{path or 'the root'}")


def _rebuild(tree, leaves: Iterator):
    """``tree``'s structure over the restored ``leaves`` (in flatten order);
    a parameter module is written in place and returned."""
    if isinstance(tree, nn.Module):
        load_jax_params(tree, _rebuild(to_jax_params(tree, tree.cfg), leaves))
        return tree
    if isinstance(tree, torch.Tensor):
        return numpy_to_torch(next(leaves)).to(tree.device, tree.dtype)
    if isinstance(tree, (Bits, *_LEAVES)):        # a host leaf: numpy back
        a = next(leaves)
        if isinstance(a, np.ndarray) and not isinstance(tree, Bits) and \
                np.asarray(tree).dtype.name in _NUMPY_NATIVE:
            a = a.astype(np.asarray(tree).dtype)
        return a
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, f), leaves)
                            for f in tree._fields])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, leaves) for x in tree)
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return tree


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(array numpy can save, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        leaf = torch_to_numpy(leaf)
    if isinstance(leaf, Bits):
        return leaf.bits, leaf.dtype
    a = np.asarray(leaf)
    if a.dtype.name not in _NUMPY_NATIVE:            # ml_dtypes bf16/f8
        return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint8), \
            a.dtype.name
    return a, a.dtype.name


def _from_saved(a: np.ndarray, dtype_name: str):
    return a if dtype_name in _NUMPY_NATIVE else Bits(a, dtype_name)


def _shape(leaf) -> List[int]:
    a = leaf.bits if isinstance(leaf, Bits) else leaf
    return list(a.shape) if hasattr(a, "shape") else []


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # -- save -------------------------------------------------------------------

    def save(self, step: int, tree, *, blocking: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Snapshot a tree (params, optimizer state).  The leaves are copied
        to the host before this returns; the files are written on a
        background thread unless ``blocking``."""
        items = [(p, _to_host(leaf)) for p, leaf in _flatten(tree)]
        host_arrays = {f"leaf_{i}": a for i, (_, (a, _)) in enumerate(items)}
        manifest = {
            "step": step,
            "paths": [p for p, _ in items],
            "dtypes": [d for _, (_, d) in items],
            "shapes": [list(a.shape) for _, (a, _) in items],
            "extra": extra or {},
            "time": time.time(),
        }
        self.wait()

        def _write():
            try:
                tmp = os.path.join(self.directory, f"step_{step}.tmp")
                final = os.path.join(self.directory, f"step_{step}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **host_arrays)
                with open(os.path.join(tmp, "manifest.json"), "w") as f:
                    json.dump(manifest, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)                      # atomic commit
                self._gc()
            except BaseException as e:                     # surfaced on wait()
                self._last_error = e

        if blocking:
            _write()
            if self._last_error:
                err, self._last_error = self._last_error, None
                raise err
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error:
            err, self._last_error = self._last_error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_", 1)[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, tree_like, step: Optional[int] = None
                ) -> Tuple[Any, int, Dict[str, Any]]:
        """Restore into the structure of ``tree_like``: the same paths and
        shapes.  Parameter modules in it are written in place; tensors come
        back on their template's device, in its dtype."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        leaves = [_from_saved(data[f"leaf_{i}"], d)
                  for i, d in enumerate(manifest["dtypes"])]
        flat = list(_flatten(tree_like))
        if len(flat) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(leaves)} leaves, target structure has "
                f"{len(flat)}")
        for (p, t), saved, shape in zip(flat, manifest["paths"],
                                        manifest["shapes"]):
            if p != saved or _shape(t) != shape:
                raise ValueError(f"checkpoint leaf {saved} {shape} does not "
                                 f"fit the target's {p} {_shape(t)}")
        return (_rebuild(tree_like, iter(leaves)), step, manifest["extra"])


# -- global-tier (runtime state) checkpointing ----------------------------------------

def save_global_tier(global_tier, directory: str, tag: str = "state") -> str:
    """Checkpoint every state key of the runtime's global tier."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"{tag}.tmp.npz")
    final = os.path.join(directory, f"{tag}.npz")
    arrays = {}
    for i, key in enumerate(global_tier.keys()):
        arrays[f"k{i}"] = np.frombuffer(
            global_tier.get(key, host="ckpt"), np.uint8)
        arrays[f"n{i}"] = np.frombuffer(key.encode(), np.uint8)
    np.savez(tmp, **arrays)
    os.replace(tmp, final)
    return final


def restore_global_tier(global_tier, directory: str, tag: str = "state") -> int:
    data = np.load(os.path.join(directory, f"{tag}.npz"))
    n = 0
    i = 0
    while f"k{i}" in data:
        key = bytes(data[f"n{i}"]).decode()
        global_tier.set(key, bytes(data[f"k{i}"]), host="ckpt")
        n += 1
        i += 1
    return n
