"""Atomic checkpoints in the JAX package's on-disk format.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``MANIFEST.json``, the manifest
written last, so a directory without one is incomplete and ignored.
Leaves are keyed by their path of dict keys joined with ``/`` (the JAX
package's ``tree_flatten_with_path`` keys), so a state written by either
package restores through the other. bfloat16 leaves ride as uint16 with
their dtype in the manifest, as there. Retention keeps the newest K
complete checkpoints. ``peek_leaves`` reads leaves without a template
(the serving plan is recovered that way), and ``Checkpointer`` writes in
a background thread.

A ``distributed.sharding.Sharded`` leaf is saved whole (its blocks
gathered), so a checkpoint written over any mesh restores onto any
other, or onto one device: ``restore(shardings=)`` places each leaf as
it loads, as the JAX package's ``restore(shardings=)`` does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import Sharded, place_tree

__all__ = ["save", "restore", "latest_step", "peek_leaves", "Checkpointer"]

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{slash-joined key path: leaf} of a tree of nested dicts."""
    if isinstance(tree, dict):
        flat = {}
        for k in sorted(tree):
            flat.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
        return flat
    return {prefix[:-len(_SEP)]: tree}


def _unflatten_like(tree_like: Any, leaf_fn, prefix: str = "") -> Any:
    if isinstance(tree_like, dict):
        return {k: _unflatten_like(v, leaf_fn, f"{prefix}{k}{_SEP}")
                for k, v in tree_like.items()}
    return leaf_fn(prefix[:-len(_SEP)], tree_like)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    if isinstance(leaf, Sharded):
        leaf = leaf.gather(torch.device("cpu"))
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, arr.dtype.name


def _bf16_tensor(arr: np.ndarray) -> torch.Tensor:
    """A bfloat16 leaf stored as uint16 → a bfloat16 tensor."""
    return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)


def save(directory: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Atomic checkpoint write of a tree of nested dicts of tensors (or
    numpy arrays); returns the checkpoint path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat, dtypes = {}, {}
    for key, leaf in _flatten(tree).items():
        flat[key], dtypes[key] = _to_numpy(leaf)
    np.savez(os.path.join(tmp, "arrays.npz"), **flat)
    manifest = {
        "step": step,
        "time": time.time(),
        "n_arrays": len(flat),
        "bytes": int(sum(a.nbytes for a in flat.values())),
        "dtypes": dtypes,
    }
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _retain(directory, keep)
    return final


def _complete_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name,
                                           "MANIFEST.json")):
                steps.append(int(name.split("_")[1]))
    return sorted(steps)


def _retain(directory: str, keep: int):
    steps = _complete_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    steps = _complete_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, tree_like: Any, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, int]:
    """Restore into the structure of ``tree_like`` (nested dicts whose
    leaves are tensors, ``Sharded`` tensors or numpy arrays). Returns
    (tree, step): each leaf a CPU tensor of the template leaf's dtype,
    or, with ``shardings`` (a tree of ``NamedSharding``s like
    ``tree_like``; a None leaf stays on the host), placed under its
    sharding as it loads."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    base = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(base, "MANIFEST.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(base, "arrays.npz")) as data:
        def leaf(key, like):
            if key not in data:
                raise ValueError(
                    f"checkpoint at {base} has no leaf {key!r} that the "
                    f"restore template expects — the state schema differs "
                    f"from the one this checkpoint was written with")
            arr = data[key]
            if dtypes.get(key) == "bfloat16":
                t = _bf16_tensor(arr)
            else:
                # a copy keeps a 0-d leaf 0-d (ascontiguousarray makes it 1-d)
                t = torch.from_numpy(arr.copy(order="C"))
            dtype = (like.dtype if isinstance(like, (torch.Tensor, Sharded))
                     else torch.from_numpy(np.asarray(like)).dtype)
            return t.to(dtype)
        tree = _unflatten_like(tree_like, leaf)
    if shardings is not None:
        tree = place_tree(tree, shardings)
    return tree, step


def peek_leaves(directory: str, step: Optional[int] = None,
                prefix: str = "") -> dict[str, Any]:
    """A checkpoint's stored leaves without a restore template:
    ``{slash-joined path: leaf}`` for every leaf whose path starts with
    ``prefix`` (empty: all). A state group that describes itself, such as
    the serving plan (``conv.planner.Plan.from_checkpoint``), is read
    this way before any engine exists to give a template. An absent
    group gives ``{}``. Leaves are numpy arrays, except that bfloat16
    leaves (which numpy lacks) are re-viewed through the manifest into
    bfloat16 CPU tensors, as ``restore`` does."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {directory}")
    base = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(base, "MANIFEST.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    out = {}
    with np.load(os.path.join(base, "arrays.npz")) as data:
        for key in data.files:
            if not key.startswith(prefix):
                continue
            arr = data[key]
            out[key] = (_bf16_tensor(arr) if dtypes.get(key) == "bfloat16"
                        else arr)
    return out


class Checkpointer:
    """Checkpoints written in a background thread, one in flight: the
    device → host copy runs in the caller's thread (so the caller may go
    on changing its tensors), the file write in the thread. A failed
    write raises from the next ``wait`` (``save_async``/``save_sync``
    wait first)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any):
        self.wait()
        host = _host_tree(tree)
        self._thread = threading.Thread(target=self._write,
                                        args=(step, host), daemon=True)
        self._thread.start()

    def _write(self, step: int, host: Any):
        try:
            save(self.directory, step, host, keep=self.keep)
        except BaseException as e:      # re-raised by wait()
            self._error = e

    def save_sync(self, step: int, tree: Any):
        self.wait()
        save(self.directory, step, _host_tree(tree), keep=self.keep)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _host_tree(tree: Any) -> Any:
    """A copy of ``tree`` with every tensor leaf on the host (a copy even
    where the leaf is already there: the caller may change it after)."""
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, Sharded):
        tree = tree.gather(torch.device("cpu"))
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)
