"""Checkpointing: async, atomic, elastic-restore.

Layout of one checkpoint (the reference's, file for file):
    <dir>/step_000000120/
        manifest.json          # leaf names, shapes, dtypes, ``extra``
        arrays/<leaf-id>.npy   # one file per leaf
    <dir>/step_000000120.COMMITTED   # atomic publish marker

Leaves are numbered in JAX's flattening order (dict keys sorted, tuple and
``NamedTuple`` fields in order: ``scan_util.tree_leaves``) and bf16 is
stored as a ``uint16`` view with ``"bfloat16"`` in the manifest, so a
checkpoint of ``(params, OptState)`` written by either package restores
in the other.

Fault-tolerance properties:
  * writes go to a temp dir + atomic rename, then the COMMITTED marker is
    placed last → a crash mid-write never corrupts a restorable state;
  * async mode runs the file I/O on a worker thread so the train loop is
    not blocked (the device→host copy is taken before ``save`` returns);
  * keep_n garbage-collects old steps only after the newer one commits;
  * a step saved again (a resumed run counts data steps from 0, so it
    saves its first steps over the earlier run's) loses its marker before
    its directory is replaced, and ``restore`` waits for a pending write
    first, so a restore after a failure reads the last commit whole.

On an LM mesh a ``DTensor`` leaf is saved whole (``full_tensor``, a
collective every rank takes part in; rank 0 writes the files), so the
files stay the reference's and restore in either package; ``restore``
with ``shardings=`` (a tree of ``distributed.sharding.NamedSharding``)
places each restored leaf on its placements, each rank reading only its
shard of the file, the reference's elastic restore onto the current
mesh. A leaf restored to the CPU is mapped from its file, which the
train driver's restores read, leaf by leaf, into the compiled step's own
buffers (``CompiledTrainStep.load_state``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.api import is_sharded
from repro_torch.distributed.sharding import from_shard, shard_slices
from repro_torch.kernels.common import resolve_device
from repro_torch.models.scan_util import (tree_leaves,
                                          tree_leaves_with_path,
                                          tree_unflatten)

PyTree = Any


def _to_storable(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as npy can hold it, and its dtype's name:
    bf16 (which npy cannot round-trip) as its ``uint16`` bits; a
    ``DTensor`` whole."""
    if is_sharded(leaf):
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _writes() -> bool:
    """Whether this process writes checkpoint files: the only one, or
    rank 0 of a process group (every rank gathers its shards)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_n: int = 3,
                 async_write: bool = True) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, tree: PyTree, extra: Optional[Dict] = None
             ) -> None:
        # Device→host copy happens synchronously, the file I/O goes to the
        # worker thread.
        host_leaves = []
        for name, leaf in tree_leaves_with_path(tree):
            arr, dtype_name = _to_storable(leaf)
            host_leaves.append((name, arr, dtype_name))
        manifest = {
            "step": step,
            "extra": extra or {},
            "leaves": [
                {"name": n, "shape": list(a.shape), "dtype": dn}
                for n, a, dn in host_leaves],
        }

        def write():
            tmp = self.dir / f".tmp_step_{step:09d}"
            final = self.dir / f"step_{step:09d}"
            marker = self.dir / f"step_{step:09d}.COMMITTED"
            if tmp.exists():
                shutil.rmtree(tmp)
            (tmp / "arrays").mkdir(parents=True)
            for i, (name, arr, _dn) in enumerate(host_leaves):
                np.save(tmp / "arrays" / f"{i:05d}.npy", arr)
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():                  # a step saved again
                marker.unlink(missing_ok=True)  # unpublished first
                shutil.rmtree(final)
            os.rename(tmp, final)
            marker.touch()                      # atomic publish
            self._gc()

        self.wait()
        if not _writes():
            return
        if self.async_write:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
            (self.dir / f"step_{s:09d}.COMMITTED").unlink(missing_ok=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for m in sorted(self.dir.glob("step_*.COMMITTED")):
            out.append(int(m.stem.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: PyTree, step: Optional[int] = None,
                shardings: Optional[PyTree] = None, device="cuda"
                ) -> Tuple[PyTree, Dict]:
        """Restore into the structure of ``tree_like``: each leaf on the
        device of the matching ``tree_like`` leaf, with the stored dtype
        and shape. A ``tree_like`` leaf on the ``"meta"`` device (the
        port's ``ShapeDtypeStruct``) names a shape only, and its leaf goes
        to ``device`` (``"cuda"`` unless the caller asks for the CPU;
        raises without CUDA). A leaf restored to the CPU is mapped from
        its file (copy-on-write), so nothing is read until it is used:
        ``CompiledTrainStep.load_state`` then reads each leaf, on a mesh
        only each rank's shard of it, straight into its own buffers.
        ``shardings`` (a tree of ``NamedSharding`` of ``tree_like``'s
        structure) re-shards onto its mesh: each leaf a ``DTensor`` with
        those placements, each rank reading only its own shard of the
        file (the reference's ``device_put`` of a host array). A pending
        async write is joined first."""
        self.wait()
        flat_like = tree_leaves(tree_like)
        fallback = None
        if shardings is None and any(like.device.type == "meta"
                                     for like in flat_like):
            fallback = resolve_device(device)
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        final = self.dir / f"step_{step:09d}"
        manifest = json.loads((final / "manifest.json").read_text())
        if len(flat_like) != len(manifest["leaves"]):
            raise ValueError(
                f"checkpoint {final} holds {len(manifest['leaves'])} leaves; "
                f"the tree to restore into has {len(flat_like)}")
        flat_sh = tree_leaves(shardings) if shardings is not None \
            else [None] * len(flat_like)
        leaves = []
        for i, (like, sh) in enumerate(zip(flat_like, flat_sh)):
            expect = manifest["leaves"][i]
            arr = np.load(final / "arrays" / f"{i:05d}.npy", mmap_mode="c")
            if list(arr.shape) != expect["shape"]:
                raise ValueError(f"{final}/arrays/{i:05d}.npy has shape "
                                 f"{list(arr.shape)}; the manifest says "
                                 f"{expect['shape']}")
            if sh is not None:
                local = arr[shard_slices(arr.shape, sh.placements, sh.mesh)]
                leaves.append(from_shard(_from_storable(
                    np.array(local), expect["dtype"]), arr.shape, sh))
            else:
                leaves.append(_from_storable(arr, expect["dtype"]).to(
                    fallback if like.device.type == "meta" else like.device))
        return tree_unflatten(tree_like, leaves), manifest["extra"]
