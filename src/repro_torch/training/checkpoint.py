"""Async, elastic checkpointing (the port of ``repro/training/checkpoint.py``).

Layout (one directory per step), the reference's, so that a checkpoint
written by either package restores in the other:

    <dir>/step_000042/
        MANIFEST.json        step, time, the leaf index, the caller's meta
        <flat-key>.npy       one file per state leaf, the full array; a
                             WO/OO-split leaf as ``…::host`` and ``…::dev``

bf16 leaves are stored as their raw 16 bits (``uint16``) with the manifest
dtype ``"bfloat16"``; the port writes and reads them through an ``int16``
view of the tensor, bit for bit, with no bf16 numpy type.

Fault-tolerance properties:
  * atomic: written to ``<dir>/.tmp_<step>`` then renamed -- a crash
    mid-save never corrupts the latest checkpoint;
  * async: ``save_async`` takes an owned host snapshot (blocking only on
    the device->host copies) and writes it in a background thread,
    double-buffered so at most one save is in flight;
  * elastic: ``restore`` takes a ``StatePlacement`` of the *target* plan
    and mesh -- the full state is cut to this rank's part there, its
    WO/OO-split leaves split again by the target's stage, and written
    into the live state in place when one is given.

The snapshot is a copy the writer owns: the train step updates the state
in place, and on the CPU (and for the pinned host parts of split leaves on
a card) a numpy view of a live tensor would be rewritten by the next step
while the writer reads it.  Before reading, the device is synchronised,
since ``adam_update`` copies the host parts back without blocking.

On a multi-rank plan ``save`` is collective (every rank gathers through
``bridge.gather_train_state``) and rank 0 writes; ``restore`` reads the
files on every rank, so the directory must be one that every rank sees
(one host, or a shared filesystem).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

SEP = "::"   # flat-key separator (param names already contain '/')


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{SEP}{k}" if prefix else k))
        return out
    out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        cur = root
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return root


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def host_snapshot(tree: Any, out: Any = None) -> Any:
    """An owned host copy of a state tree: each tensor a CPU tensor in its
    own dtype (device ones copied after a synchronise, CPU ones -- pinned
    host parts included -- cloned), each array copied.  ``out``: an
    earlier snapshot of the same tree, written over in place (its pages
    are already mapped: on an H100's host, phase L of ``chip_smoke.py``
    took 0.8-1.6 s for 8.4 GB into such a buffer and 2.9-5.6 s into
    fresh memory); a new one is made where it does not match."""
    for t in _leaves(tree):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            # adam_update writes the host parts back with non-blocking copies
            torch.cuda.synchronize(t.device)
            break
    if out is not None and _same_layout(tree, out):
        with torch.no_grad():
            for dst, src in zip(_leaves(out), _leaves(tree)):
                dst.copy_(src)
        return out
    return _map(tree, lambda x: x.detach().to("cpu", copy=True)
                if isinstance(x, torch.Tensor) else np.array(x, copy=True))


def _same_layout(tree: Any, host: Any) -> bool:
    """Whether ``host`` is a CPU-tensor tree of ``tree``'s keys, shapes and
    dtypes (every leaf of ``tree`` a tensor)."""
    if isinstance(tree, dict):
        return isinstance(host, dict) and tree.keys() == host.keys() and \
            all(_same_layout(tree[k], host[k]) for k in tree)
    return isinstance(tree, torch.Tensor) and \
        isinstance(host, torch.Tensor) and host.device.type == "cpu" and \
        host.shape == tree.shape and host.dtype == tree.dtype


def _map(tree: Any, fn) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def nbytes(tree: Any) -> int:
    """The bytes of a state tree's leaves."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in _leaves(tree))


def load_into(live: Any, host: Any) -> Any:
    """Write a host tree into the live one in place where a leaf can take
    it (``copy_`` into a tensor, ``copyto`` into a writeable array of the
    same shape); any other leaf is replaced.  Returns the live tree."""
    if isinstance(live, dict):
        for k in host:
            live[k] = load_into(live[k], host[k]) if k in live else host[k]
        return live
    if isinstance(live, torch.Tensor):
        src = host if isinstance(host, torch.Tensor) else \
            torch.from_numpy(np.array(host, copy=True))
        with torch.no_grad():
            live.copy_(src)
        return live
    src = host.numpy() if isinstance(host, torch.Tensor) else \
        np.asarray(host)
    if isinstance(live, np.ndarray) and live.flags.writeable \
            and live.shape == src.shape:
        np.copyto(live, src)
        return live
    return src.copy()


def _to_disk(x) -> Tuple[np.ndarray, str]:
    """(the array to save, the manifest dtype); bf16 as its raw bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    if str(x.dtype) == "bfloat16":        # a bf16 numpy type of a caller
        return x.view(np.uint16), "bfloat16"
    return x, str(x.dtype)


def _from_disk(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class StatePlacement:
    """Where a train state lives: the counterpart of the reference's pytree
    of ``NamedSharding``s.  It knows the model config, the plan, the live
    mesh (None: one device) and the device, and does two things:

    * ``full(state)``: the live state (one rank's shards) -> the full
      state as owned CPU tensors in their own dtype; on a mesh every rank
      must call it (``bridge.gather_train_state``) and only rank 0 gets
      it (None elsewhere);
    * ``place(full, into=None)``: a full state -> this rank's part
      (``bridge.shard_train_state``), or written into the live state
      ``into`` in place (``bridge.load_train_state``).

    Any plan of the same model places any other plan's state: S, dp, tp,
    ZeRO and WO/OO may differ."""

    def __init__(self, cfg, plan, mesh=None, device="cpu",
                 param_dtype: torch.dtype = torch.bfloat16):
        self.cfg, self.plan, self.mesh = cfg, plan, mesh
        self.device = torch.device(device)
        self.param_dtype = param_dtype

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else dist.get_rank()

    @property
    def world(self) -> int:
        return 1 if self.mesh is None else self.mesh.size()

    def barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier()

    def full(self, state: Dict, out: Any = None) -> Optional[Dict]:
        """``out``: an earlier result to write over (one device)."""
        from repro_torch import bridge
        if self.mesh is None:
            return host_snapshot(state, out)
        return bridge.gather_train_state(state, self.cfg, self.plan,
                                         self.mesh, keep_dtype=True)

    def place(self, full: Dict, into: Optional[Dict] = None) -> Dict:
        from repro_torch import bridge
        if into is not None:
            return bridge.load_train_state(into, full, self.cfg, self.plan,
                                           self.mesh)
        return bridge.shard_train_state(full, self.cfg, self.plan, self.mesh,
                                        param_dtype=self.param_dtype,
                                        device=self.device)


class Checkpointer:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None
        self._buffer: Any = None     # the last snapshot, written over next
        # each save: step, the blocking snapshot's seconds, and the write's
        # start and end (time.perf_counter) and bytes
        self.saves: List[Dict[str, float]] = []

    # -- save -----------------------------------------------------------------
    def _snapshot(self, step: int, state: Any,
                  place: Optional[StatePlacement]):
        t0 = time.perf_counter()
        host = place.full(state, self._buffer) if place is not None else \
            host_snapshot(state, self._buffer)
        self._buffer = host
        self.saves.append({"step": step,
                           "snapshot_s": time.perf_counter() - t0})
        return host

    @staticmethod
    def _meta(meta: Optional[Dict], place: Optional[StatePlacement]):
        meta = dict(meta or {})
        if place is not None:
            meta.setdefault("world", place.world)
            meta.setdefault("rank", place.rank)
        return meta

    def save(self, step: int, state: Any, meta: Optional[Dict] = None, *,
             place: Optional[StatePlacement] = None
             ) -> Optional[pathlib.Path]:
        """Snapshot and write; on a mesh collective, and rank 0 writes
        (the other ranks return None)."""
        self.wait()                     # the buffer is the writer's until then
        host = self._snapshot(step, state, place)
        if place is not None and place.rank != 0:
            return None
        return self._write(step, host, self._meta(meta, place))

    def save_async(self, step: int, state: Any, meta: Optional[Dict] = None,
                   *, place: Optional[StatePlacement] = None) -> None:
        """Snapshot synchronously (the device->host copies), write in the
        background."""
        self.wait()                                # double-buffer: one in flight
        host = self._snapshot(step, state, place)
        if place is not None and place.rank != 0:
            return
        meta = self._meta(meta, place)

        def work():
            try:
                self._write(step, host, meta)
            except BaseException as e:             # surfaced on next wait()
                self._last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            e, self._last_error = self._last_error, None
            raise e

    def _write(self, step: int, host_state: Any, meta: Dict) -> pathlib.Path:
        t0 = time.perf_counter()
        record = self.saves[-1] if self.saves else {}
        flat = _flatten(host_state)
        tmp = self.dir / f".tmp_{step:09d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        index = {}
        for key, x in flat.items():
            arr, dtype = _to_disk(x)
            fname = f"{abs(hash(key)) & 0xFFFFFFFF:08x}_{len(index):05d}.npy"
            np.save(tmp / fname, arr)
            index[key] = {"file": fname, "shape": list(arr.shape),
                          "dtype": dtype}
        manifest = {"step": step, "time": time.time(), "leaves": index,
                    **meta}
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=2))
        final = self.dir / f"step_{step:09d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()
        record.update(write_start=t0, write_end=time.perf_counter(),
                      bytes=nbytes(host_state))
        return final

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def manifest(self, step: int) -> Dict:
        p = self.dir / f"step_{step:09d}" / "MANIFEST.json"
        return json.loads(p.read_text())

    def restore(self, step: Optional[int] = None, *,
                place: Optional[StatePlacement] = None,
                into: Any = None) -> Tuple[int, Any, Dict]:
        """Load a checkpoint: its leaves as CPU tensors over the files,
        mapped copy-on-write (bf16 bit for bit);
        with ``place`` (a ``StatePlacement`` of the target plan and mesh)
        this rank's part of it, placed elastically; with ``into`` written
        into that live state in place.

        Returns (step, state, manifest).
        """
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        # mapped, not read: a rank's cut reads only its part, and the
        # ranks of one host share the page cache
        state = _unflatten({key: _from_disk(np.load(d / ent["file"],
                                                    mmap_mode="c"),
                                            ent["dtype"])
                            for key, ent in manifest["leaves"].items()})
        if place is not None:
            state = place.place(state, into=into)
        elif into is not None:
            state = load_into(into, state)
        return step, state, manifest
