"""Fault-tolerant checkpointing (port of ``repro/checkpoint/manager.py``):
numpy-only, atomic, async, with the same directory format.

A checkpoint is ``step_<N:010d>/`` holding ``manifest.json`` and one
``.npy`` per leaf, named by its key path (``tp/layers/attn/lora/q/a`` ->
``tp__layers__attn__lora__q__a.npy``).  Key paths follow the reference's
pytree paths: dict keys as they are, NamedTuple fields with a leading
dot (``opt/.mu/...``, ``opt/.step``), None leaves skipped.  bf16 leaves
are stored as their raw 2-byte words (numpy ``|V2``) with the manifest
dtype ``bfloat16``, as the reference writes them, so either package
reads the other's checkpoints.

 * Atomic: write ``step_<N>.tmp``, then ``os.replace``; ``latest()``
   scans committed directories only.
 * Async: a background thread writes host copies; ``save`` blocks only
   for the device-to-host copy of the leaves.
 * Integrity: a CRC32 per leaf in the manifest, checked on restore.
 * Garbage collection: the newest ``keep`` checkpoints are kept.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten_paths(tree: Any, prefix: Tuple[str, ...] = ()
                   ) -> List[Tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's pytree order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten_paths(tree[k], prefix + (str(k),))
        return out
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += _flatten_paths(getattr(tree, f), prefix + ("." + f,))
        return out
    return [("/".join(prefix), tree)]


def _to_host(x) -> Tuple[np.ndarray, str]:
    """(array to save, manifest dtype).  Copies: a later in-place update
    of a device tensor must not reach an async save."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            raw = x.view(torch.int16).cpu().numpy().copy()
            return raw.view(np.dtype("V2")), "bfloat16"
        a = x.cpu().numpy().copy()
        return a, str(a.dtype)
    a = np.array(x, dtype=np.int32)        # the optimizer step
    return a, str(a.dtype)


def _from_host(arr: np.ndarray, dtype: str, tmpl):
    """A loaded array in the template leaf's kind: a tensor of the
    template's dtype on its device, or a host int (the optimizer step)."""
    if dtype == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if isinstance(tmpl, int):
        return int(t.item())
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


def _unflatten(tmpl: Any, leaves: Dict[str, Any],
               prefix: Tuple[str, ...] = ()) -> Any:
    if tmpl is None:
        return None
    if isinstance(tmpl, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tmpl.items()}
    if _is_namedtuple(tmpl):
        return type(tmpl)(*[_unflatten(getattr(tmpl, f), leaves,
                                       prefix + ("." + f,))
                            for f in tmpl._fields])
    return leaves["/".join(prefix)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._async = async_save
        self._err: Optional[BaseException] = None
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[Dict] = None):
        """Snapshot to host, then commit (async if enabled)."""
        host = {k: _to_host(x) for k, x in _flatten_paths(tree)}
        payload = (step, host, extra or {})
        if self._async:
            self._q.put(payload)
        else:
            self._commit(*payload)

    def wait(self):
        if self._async:
            self._q.join()
        if self._err:
            raise self._err

    def _worker(self):
        while True:
            payload = self._q.get()
            try:
                self._commit(*payload)
            except BaseException as e:   # surfaced on wait()
                self._err = e
            finally:
                self._q.task_done()

    def _commit(self, step: int, host: Dict[str, Tuple[np.ndarray, str]],
                extra: Dict):
        tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
        final = os.path.join(self.dir, f"step_{step:010d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": {}}
        for key, (arr, dtype) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname, "shape": list(arr.shape), "dtype": dtype,
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self):
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_") and not name.endswith(".tmp") \
                    and os.path.exists(os.path.join(self.dir, name,
                                                    "manifest.json")):
                out.append(int(name.split("_")[1]))
        return out

    def latest(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree: Any,
                verify: bool = True) -> Tuple[Any, Dict]:
        """Load into the structure, dtypes and devices of ``target_tree``.
        Raises ``IOError`` on a CRC mismatch."""
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = {}
        for key, tmpl in _flatten_paths(target_tree):
            meta = manifest["leaves"][key]
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc"]:
                    raise IOError(f"checkpoint corruption at leaf {key}")
            leaves[key] = _from_host(arr, meta["dtype"], tmpl)
        return _unflatten(target_tree, leaves), manifest["extra"]
