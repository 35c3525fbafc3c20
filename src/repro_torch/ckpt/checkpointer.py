"""Async, atomic checkpointing of trees of tensors.

The port of ``repro.ckpt.checkpointer``, with the same on-disk layout, so
either package reads the other's snapshots:

    <dir>/step_00000100.tmp-<nonce>/   # written here first
        manifest.json                  # step, time, leaf count, shapes, dtypes
        arrays.npz                     # leaf_0, leaf_1, ... one per leaf
    <dir>/step_00000100/               # atomic os.replace on completion

* atomicity — a checkpoint is visible iff its directory rename completed;
  a crash mid-write leaves only ``.tmp-*`` debris that ``cleanup()``
  removes (at start-up, age-guarded, so a directory shared by live
  processes never loses an in-flight write).
* async — ``save_async`` copies the tree to host memory, then writes on a
  background thread; the caller waits only for the device-to-host copy.
* retention — ``keep_last`` prunes old steps after a successful save.
* restore — ``restore`` rebuilds a target tree's structure with tensors on
  the device asked for (or the target's own).
* sharded trees — over a mesh of ranks (``launch.mesh``) ``save`` takes
  ``shardings``, a tree of ``dist.sharding.NamedPlacement``s beside the
  tree of this rank's blocks: every rank gathers the whole tensors and
  rank 0 alone writes them, so a snapshot is the same file whatever the
  mesh.  ``restore(..., shardings=...)`` cuts each whole tensor to the
  block this rank holds under the *target's* placements: a snapshot
  saved at one mesh restores at another (elastic N -> M).

A tree is a tensor, a numpy array or a scalar (a leaf), or a dict, list,
tuple or ``NamedTuple`` (an optimizer state) of trees; ``None`` holds no
leaf.  It is flattened here, dicts in
sorted key order as ``jax.tree_util`` orders them, so ``leaf_i`` names the
same leaf in both packages.  Only the manifest's ``treedef`` string is the
port's own spelling of the structure; no reader parses it.
"""
from __future__ import annotations

import json
import os
import secrets
import shutil
import threading
import time

import numpy as np
import torch


def flatten(tree) -> tuple[list, object]:
    """``(leaves, structure)`` of a tree, dicts in sorted key order."""
    leaves: list = []

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [walk(x) for x in node])
        if node is None:
            return None
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def unflatten(structure, leaves):
    """The inverse of :func:`flatten`."""
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return _rebuild(node, [build(x) for x in node])
        return None

    return build(structure)


def _rebuild(node, children: list):
    """A list or tuple of ``node``'s type holding ``children``: a
    ``NamedTuple`` takes them as positional fields."""
    if hasattr(node, "_fields"):
        return type(node)(*children)
    return type(node)(children)


class _Leaf:
    def __repr__(self):
        return "*"


_LEAF = _Leaf()


def to_numpy(x) -> np.ndarray:
    """A host numpy copy of a leaf (a tensor on any device, an array or a
    scalar).  A bfloat16 tensor, which numpy cannot hold, is kept as
    float32 (exact); ``restore`` casts it back to the target's dtype."""
    if torch.is_tensor(x):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu").numpy().copy()
    return np.array(x)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3,
                 cleanup_max_age_s: float | None = 3600.0):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        # start-up sweep of crash debris, age-guarded; None skips it
        if cleanup_max_age_s is not None:
            self.cleanup(max_age_s=cleanup_max_age_s)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = True,
             shardings=None):
        """Copy ``tree`` to host memory now; write it, in the background
        unless ``blocking``.  A failed write raises (here, or at the next
        ``save``/``wait`` for a background one).  With ``shardings`` (a
        tree of ``NamedPlacement``s mirroring ``tree``), every rank must
        call it: the blocks are gathered and rank 0 writes."""
        self.wait()  # one outstanding save at a time
        leaves, structure = flatten(tree)
        if shardings is not None:
            import torch.distributed as dist

            places, _ = flatten(shardings)
            _check_count(places, leaves)
            leaves = [pl.full(x) if torch.is_tensor(x) else x
                      for x, pl in zip(leaves, places)]
            if dist.get_rank() != 0:
                return
        host = [to_numpy(x) for x in leaves]

        def write():
            try:
                self._write(step, host, structure)
            except BaseException as e:
                self._error = e

        if blocking:
            write()
            self._raise_if_failed()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree, shardings=None):
        self.save(step, tree, blocking=False, shardings=shardings)

    def _write(self, step: int, leaves: list[np.ndarray], structure):
        nonce = secrets.token_hex(4)
        tmp = self._step_dir(step) + f".tmp-{nonce}"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        manifest = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(leaves),
            "treedef": f"repro_torch:{structure!r}",
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": [str(x.dtype) for x in leaves],
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = self._step_dir(step)
        if os.path.exists(final):  # overwrite-same-step (restart race)
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from e

    def _prune(self):
        for s in self.steps()[: -self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def cleanup(self, max_age_s: float | None = None):
        """Remove interrupted ``.tmp-*`` writes (crash debris); with
        ``max_age_s`` only debris at least that old."""
        now = time.time()
        for name in os.listdir(self.dir):
            if ".tmp-" not in name:
                continue
            path = os.path.join(self.dir, name)
            if max_age_s is not None:
                try:
                    if now - os.path.getmtime(path) < max_age_s:
                        continue
                except OSError:
                    continue
            shutil.rmtree(path, ignore_errors=True)

    def remove(self, step: int) -> bool:
        """Drop one saved step's directory; whether anything was removed."""
        d = self._step_dir(step)
        if not os.path.isdir(d):
            return False
        shutil.rmtree(d, ignore_errors=True)
        return True

    # -- restore ---------------------------------------------------------------
    def read_arrays(self, step: int) -> tuple[dict, list[np.ndarray]]:
        """``(manifest, leaves)`` of a saved step: host numpy arrays in
        flattened order, no target tree needed."""
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(d, "arrays.npz")) as data:
            leaves = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
        return manifest, leaves

    def restore(self, step: int, target_tree, device=None, shardings=None):
        """Restore into the structure of ``target_tree`` (leaf shapes
        checked, dtypes cast to the target's), as tensors on ``device`` —
        by default each target tensor's own device, else the CPU.

        ``shardings``: a tree of ``NamedPlacement``s mirroring the target
        (whose leaves are this rank's blocks), or one that every leaf
        takes: each saved whole tensor is cut to this rank's block under
        it (elastic N -> M)."""
        manifest, arrays = self.read_arrays(step)
        leaves, structure = flatten(target_tree)
        if manifest["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves; target has "
                f"{len(leaves)} — incompatible trees")
        if shardings is not None:
            from repro_torch.dist.sharding import NamedPlacement

            places = ([shardings] * len(leaves)
                      if isinstance(shardings, NamedPlacement)
                      else flatten(shardings)[0])
            _check_count(places, leaves)
            arrays = [_block_of(arr, pl) for arr, pl in zip(arrays, places)]
        out = []
        for i, (ref, arr) in enumerate(zip(leaves, arrays)):
            shape = tuple(ref.shape) if hasattr(ref, "shape") else np.shape(ref)
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"leaf {i}: checkpoint shape {arr.shape} != "
                                 f"target {tuple(shape)}")
            # ascontiguousarray makes a 0-d leaf 1-d: keep its shape
            t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
            if torch.is_tensor(ref):
                t = t.to(dtype=ref.dtype,
                         device=device if device is not None else ref.device)
            else:
                t = t.to(dtype=torch.from_numpy(np.asarray(ref)).dtype,
                         device=device if device is not None else "cpu")
            out.append(t)
        return unflatten(structure, out)

    def restore_latest(self, target_tree, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, target_tree, device)


def _check_count(places: list, leaves: list) -> None:
    if len(places) != len(leaves):
        raise ValueError(
            f"shardings has {len(places)} leaves; target has {len(leaves)} "
            "— pass one NamedPlacement to broadcast")


def _block_of(arr: np.ndarray, placement) -> np.ndarray:
    """This rank's block of a saved whole array."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).reshape(arr.shape)
    return placement.block(t).contiguous().numpy()
