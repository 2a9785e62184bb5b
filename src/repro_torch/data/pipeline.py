"""Deterministic synthetic data pipeline.

Design goals for 1000+-node runs:
  * **Determinism under restart/elasticity**: every batch is a pure function
    of (seed, step) — a restarted or re-sharded job replays the exact token
    stream with no host coordination or state files.
  * **Prefetch**: a background thread keeps ``depth`` batches ready, hiding
    host-side generation behind device compute.

The reference's pipeline (``data/pipeline.py``): ``_tokens_for`` and
``_frontend_for`` are its numpy functions unchanged, so a batch's tokens
are the reference's bit for bit. ``make_batch`` returns tensors on
``device`` (``"cuda"`` unless the caller asks for the CPU; raises without
CUDA): the token ids as int64, the type ``embed`` indexes with, the same
values as the reference's int32. With ``mesh=`` (an LM ``DeviceMesh``)
each rank draws only its own rows, as the reference's
``make_array_from_callback`` does, and the batch is a ``DTensor``: the
batch dim on the data axes when it divides them, else replicated.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 256
    seq_len: int = 4096
    # Synthetic-stream flavor: zipfian token draws mimic natural-language
    # unigram statistics so losses are non-degenerate.
    zipf_a: float = 1.2


def _tokens_for(cfg: DataConfig, model: ModelConfig, step: int,
                lo: int, hi: int) -> np.ndarray:
    """Rows [lo, hi) of the global batch at ``step`` — pure function."""
    n_front = model.frontend_tokens if model.frontend != "none" else 0
    seq = cfg.seq_len - n_front
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, lo, hi]))
    z = rng.zipf(cfg.zipf_a, size=(hi - lo, seq)).astype(np.int64)
    return (z % model.vocab).astype(np.int32)


def _frontend_for(cfg: DataConfig, model: ModelConfig, step: int,
                  lo: int, hi: int) -> Optional[np.ndarray]:
    if model.frontend == "none":
        return None
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed + 7, step, lo, hi]))
    return rng.standard_normal(
        (hi - lo, model.frontend_tokens, model.frontend_dim)
    ).astype(np.float32)


def _host_batch(cfg: DataConfig, model: ModelConfig, step: int,
                rows: Optional[Tuple[int, int]] = None
                ) -> Dict[str, np.ndarray]:
    """Rows ``[lo, hi)`` (all of them by default) of the batch at
    ``step`` as numpy arrays."""
    lo, hi = rows or (0, cfg.global_batch)
    batch = {"tokens": _tokens_for(cfg, model, step, lo, hi)}
    fe = _frontend_for(cfg, model, step, lo, hi)
    if fe is not None:
        batch["frontend_embeds"] = fe
    return batch


def _mesh_rows(cfg: DataConfig, mesh) -> Tuple[Tuple[int, int], tuple]:
    """This rank's rows of the global batch on ``mesh`` and the batch's
    placements: the batch dim on the data axes (pod major) when it
    divides them, else every rank holds all rows."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    dp = [a for a in ("pod", "data") if a in names]
    n = 1
    for a in dp:
        n *= mesh.size(names.index(a))
    if cfg.global_batch % n:
        return (0, cfg.global_batch), tuple(Replicate() for _ in names)
    idx = 0
    for a in dp:
        idx = idx * mesh.size(names.index(a)) + mesh.get_local_rank(a)
    per = cfg.global_batch // n
    return (idx * per, (idx + 1) * per), tuple(
        Shard(0) if a in dp else Replicate() for a in names)


def _to_mesh(batch: Dict[str, np.ndarray], mesh,
             pl: tuple) -> Dict[str, torch.Tensor]:
    from torch.distributed.tensor import DTensor
    local = _to_device(batch, torch.device(mesh.device_type,
                                           _mesh_device_index(mesh)))
    return {k: DTensor.from_local(v, mesh, pl, run_check=False)
            for k, v in local.items()}


def _mesh_device_index(mesh) -> int:
    """The local device of this rank: the current card on CUDA."""
    return torch.cuda.current_device() if mesh.device_type == "cuda" else 0


def _to_device(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    out = {"tokens": torch.as_tensor(batch["tokens"], dtype=torch.long,
                                     device=device)}
    if "frontend_embeds" in batch:
        out["frontend_embeds"] = torch.as_tensor(batch["frontend_embeds"],
                                                 device=device)
    return out


def make_batch(cfg: DataConfig, model: ModelConfig, step: int,
               mesh=None, device="cuda") -> Dict[str, torch.Tensor]:
    """Global batch at ``step`` on ``device``; with ``mesh=`` a ``DTensor``
    batch on the mesh's device type, each rank holding its rows (seeded
    per shard, as in the reference, so a sharded batch's rows differ from
    the unsharded batch's)."""
    if mesh is not None:
        rows, pl = _mesh_rows(cfg, mesh)
        return _to_mesh(_host_batch(cfg, model, step, rows), mesh, pl)
    return _to_device(_host_batch(cfg, model, step), resolve_device(device))


class PrefetchIterator:
    """Background-thread prefetch of ``depth`` upcoming batches: the
    worker draws them on the host (numpy only, no CUDA call off the main
    thread) and ``__next__`` moves one to ``device``, as ``(step,
    batch)``; with ``mesh=`` the worker draws this rank's rows and
    ``__next__`` gives ``make_batch(..., mesh=)``'s ``DTensor`` batch."""

    def __init__(self, cfg: DataConfig, model: ModelConfig,
                 mesh=None, start_step: int = 0, depth: int = 2,
                 device="cuda") -> None:
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        self.rows, self.placements = (_mesh_rows(cfg, mesh) if mesh is not None
                                      else (None, None))
        self.device = resolve_device(device)
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = _host_batch(self.cfg, self.model, s, self.rows)
            while not self._stop.is_set():
                try:
                    self.q.put((s, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            s += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        s, batch = self.q.get()
        if self.mesh is not None:
            return s, _to_mesh(batch, self.mesh, self.placements)
        return s, _to_device(batch, self.device)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
