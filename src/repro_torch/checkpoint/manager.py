"""Checkpoint/restart with async writes, in the JAX package's on-disk
format (a port of its ``checkpoint/manager.py``).

  * every leaf is written as its own ``.npy`` under a step directory with a
    JSON manifest (tree paths, shapes, dtypes, step), written last, in a
    ``.tmp_step_*`` directory that is renamed when complete;
  * leaves are named and ordered as the JAX package's
    ``jax.tree_util.tree_flatten_with_path`` names them: dict keys in
    sorted order, list and tuple indices, joined by ``/``.  A port
    ``Model`` is saved in the JAX package's ``init_params`` layout
    (``convert.param_names``), its layers stacked on a leading axis, so
    either package restores the other's checkpoint;
  * bfloat16 leaves are stored widened to float32; the manifest keeps the
    original dtype's numpy name (``"bfloat16"``) and ``restore`` casts to
    the dtype of the ``like`` leaf;
  * ``save`` copies every leaf into host memory of its own before it
    returns, on any device (the port's train step updates the model and
    the optimizer state in place: the writer thread must not see the next
    step), and writes on a background thread;
  * ``keep`` bounds disk usage; a half-written step directory (no
    manifest) is ignored; a checkpoint that looks complete but is corrupt
    (truncated leaf file, shape mismatch against its own manifest,
    unreadable JSON) raises :class:`CheckpointError` from ``restore``,
    and ``restore_latest`` walks back to the newest retained step that
    loads cleanly, with a ``RuntimeWarning``;
  * background-write failures are re-raised from the next
    ``wait()``/``save()``;
  * a ``ShardedTensor`` leaf (``distributed.sharding``) is saved whole,
    and ``restore(..., shardings=)`` places each loaded leaf under its
    ``Sharding`` on any ``LMMesh``, of any shape: the files do not record
    the mesh that saved them.
"""
from __future__ import annotations

import copy
import json
import shutil
import threading
import warnings
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.convert import param_names
from repro_torch.distributed.sharding import (ShardedTensor, shard_tensor,
                                              unshard_tensor)


class CheckpointError(RuntimeError):
    """A checkpoint directory is unreadable or fails validation."""


class _Stacked(tuple):
    """One leaf of a model's layer axis: a tensor per layer, saved stacked."""


def _module_tree(model: nn.Module, named: dict | None = None) -> dict:
    """The model as the JAX package's parameter tree: nested dicts of its
    parameters (or of ``named``'s values, keyed by parameter name), each
    layer list's as ``_Stacked`` leaves."""
    named = dict(model.named_parameters()) if named is None else named

    def leaves(tree):
        if isinstance(tree, dict):
            return {k: leaves(v) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return _Stacked(named[n] for n in tree)
        return named[tree]

    return leaves(param_names(model))


def _flatten(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, nn.Module):
        tree = _module_tree(tree)
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, _Stacked):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten(v, f"{prefix}{i}/")]
    if tree is None:
        return []
    return [(prefix[:-1], tree)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _host_copy(leaf) -> Tuple[Any, str]:
    """A private host copy of ``leaf`` (a tensor on the CPU, or a numpy
    array) and the numpy name of its dtype."""
    if isinstance(leaf, _Stacked):
        # stacked where the layers live (a new tensor), then one copy
        return (torch.stack([t.detach() for t in leaf]).to("cpu"),
                _dtype_name(leaf[0].dtype))
    if isinstance(leaf, ShardedTensor):
        return (unshard_tensor(leaf, "cpu").detach().clone(),
                _dtype_name(leaf.dtype))
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True), _dtype_name(leaf.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _to_numpy(a) -> np.ndarray:
    """A host copy as the array that goes to disk: non-numpy-native dtypes
    (bfloat16 and other ml_dtypes) widened to float32."""
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    return a.astype(np.float32) if a.dtype.kind == "V" else a


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: bool = False) -> None:
        """Snapshot to host memory, then write asynchronously.

        ``tree`` is a port ``Model``, or nested dicts, lists and tuples of
        tensors (any device), ``ShardedTensor``\\ s and numpy arrays.
        Non-numpy-native dtypes (bfloat16) are stored widened to fp32; the
        manifest keeps the original dtype and restore() casts back."""
        host = [(name, *_host_copy(leaf)) for name, leaf in _flatten(tree)]
        self.wait()

        def write():
            try:
                d = self.dir / f"step_{step:08d}"
                tmp = self.dir / f".tmp_step_{step:08d}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir()
                manifest = {"step": step, "leaves": {}}
                for i, (name, a, orig) in enumerate(host):
                    arr = _to_numpy(a)
                    fn = f"leaf_{i:05d}.npy"
                    np.save(tmp / fn, arr)
                    manifest["leaves"][name] = {
                        "file": fn, "shape": list(arr.shape), "dtype": orig}
                # manifest last: its presence marks the checkpoint complete
                (tmp / "manifest.json").write_text(json.dumps(manifest))
                if d.exists():
                    shutil.rmtree(d)
                tmp.rename(d)
                self._gc()
            except BaseException as e:     # surfaced by the next wait()
                self._write_error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the in-flight write; re-raise any failure it hit (an
        async ``save`` must not be lost in the thread)."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise CheckpointError(
                f"background checkpoint write failed: {err}") from err

    def _gc(self) -> None:
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def steps(self) -> List[int]:
        """All retained manifest-complete steps, oldest first."""
        out = []
        for d in self.dir.glob("step_*"):
            if (d / "manifest.json").exists():     # complete checkpoints only
                out.append(int(d.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any, shardings: Any = None) -> Any:
        """Load into the structure of ``like``: each leaf cast to the dtype
        of ``like``'s leaf, a tensor on its device (a port ``Model`` comes
        back as a new model on ``like``'s device), a numpy array as a
        numpy array.

        ``shardings`` places the leaves on a mesh instead: a tree of
        ``Sharding``\\ s in ``like``'s structure (``None`` leaves load as
        above), or for a ``Model`` ``{parameter name: Sharding}``, which
        gives ``{parameter name: ShardedTensor}``.  Each leaf is cast to
        ``like``'s dtype and split on the mesh it names, whatever mesh
        saved it.

        Raises :class:`CheckpointError` when the step directory is
        corrupt: unreadable manifest, a missing leaf, a truncated
        ``.npy``, or a leaf whose shape disagrees with the manifest."""
        d = self.dir / f"step_{step:08d}"
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, ValueError) as e:
            raise CheckpointError(
                f"step {step}: unreadable manifest in {d}: {e}") from e
        loaded = {}
        for name, _ in _flatten(like):
            try:
                meta = manifest["leaves"][name]
                arr = np.load(d / meta["file"])
            except KeyError as e:
                raise CheckpointError(
                    f"step {step}: leaf {name!r} missing from manifest"
                    ) from e
            except (OSError, ValueError, EOFError) as e:
                raise CheckpointError(
                    f"step {step}: leaf {name!r} unreadable "
                    f"(truncated/corrupt file): {e}") from e
            if list(arr.shape) != list(meta.get("shape", arr.shape)):
                raise CheckpointError(
                    f"step {step}: leaf {name!r} shape {list(arr.shape)} != "
                    f"manifest {meta['shape']} (truncated write?)")
            loaded[name] = arr
        if shardings is not None:
            return _place(like, loaded, shardings)
        return _unflatten(like, loaded)

    def restore_latest(self, like: Any, shardings: Any = None,
                       ) -> Tuple[Optional[int], Any]:
        """``(step, tree)`` from the newest retained checkpoint that
        loads cleanly.  A corrupt latest step (truncated mid-crash) is
        skipped with a warning and the previous retained step is tried —
        a restart loses one checkpoint interval instead of raising
        mid-restore.  ``(None, None)`` when nothing restorable exists."""
        for step in reversed(self.steps()):
            try:
                return step, self.restore(step, like, shardings)
            except CheckpointError as e:
                warnings.warn(
                    f"checkpoint step {step} is corrupt, falling back to "
                    f"the previous retained step: {e}",
                    RuntimeWarning, stacklevel=2)
        return None, None


def _placed(arr: np.ndarray, dtype: torch.dtype, sharding) -> ShardedTensor:
    """``arr`` cast to ``dtype`` and split under ``sharding``."""
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    return shard_tensor(t, sharding, copy=True)


def _cast(arr: np.ndarray, like):
    if isinstance(like, ShardedTensor):
        return _placed(arr, like.dtype, like.sharding)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            like.device, like.dtype)
    return np.asarray(arr).astype(np.asarray(like).dtype)


def _place(like: Any, loaded: dict, shardings: Any,
           prefix: str = "") -> Any:
    """``_unflatten`` with each leaf that has a ``Sharding`` in
    ``shardings`` split onto its mesh."""
    if isinstance(like, nn.Module):
        params = dict(like.named_parameters())
        names = _module_tree(like, {n: n for n in params})
        out = {}
        for name, leaf in _flatten(names):
            stacked = isinstance(leaf, _Stacked)
            for i, pname in enumerate(leaf if stacked else (leaf,)):
                arr = loaded[name][i] if stacked else loaded[name]
                out[pname] = _placed(arr, params[pname].dtype,
                                     shardings[pname])
        return out
    if isinstance(like, dict):
        return {k: _place(like[k], loaded, shardings[k], f"{prefix}{k}/")
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_place(v, loaded, shardings[i], f"{prefix}{i}/")
                          for i, v in enumerate(like))
    if shardings is None:
        return _unflatten(like, loaded, prefix)
    return _placed(loaded[prefix[:-1]], like.dtype, shardings)


def _unflatten(like: Any, loaded: dict, prefix: str = "") -> Any:
    """``like``'s structure with the loaded arrays in its leaves' places."""
    if isinstance(like, nn.Module):
        model = copy.deepcopy(like)
        with torch.no_grad():
            for name, leaf in _flatten(model, prefix):
                arr = loaded[name]
                for i, p in enumerate(leaf if isinstance(leaf, _Stacked)
                                      else (leaf,)):
                    a = arr[i] if isinstance(leaf, _Stacked) else arr
                    p.copy_(_cast(a, p))
        return model
    if isinstance(like, dict):
        return {k: _unflatten(like[k], loaded, f"{prefix}{k}/")
                for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, loaded, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    if like is None:
        return None
    return _cast(loaded[prefix[:-1]], like)
