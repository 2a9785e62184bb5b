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
values as the reference's int32. The host-sharded branch (``mesh=``)
waits for the LM mesh and raises.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

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


def _host_batch(cfg: DataConfig, model: ModelConfig,
                step: int) -> Dict[str, np.ndarray]:
    """The whole batch at ``step`` as numpy arrays."""
    batch = {"tokens": _tokens_for(cfg, model, step, 0, cfg.global_batch)}
    fe = _frontend_for(cfg, model, step, 0, cfg.global_batch)
    if fe is not None:
        batch["frontend_embeds"] = fe
    return batch


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
    """Global batch at ``step`` on ``device``. A sharded batch (``mesh=``)
    is the LM mesh's (ROADMAP item C.7) and raises until it is ported;
    its per-shard seeds will make a shard's rows differ from this
    unsharded batch's."""
    if mesh is not None:
        raise NotImplementedError(
            "make_batch(mesh=...): the host-sharded batch comes with the LM "
            "mesh (ROADMAP item C.7)")
    return _to_device(_host_batch(cfg, model, step), resolve_device(device))


class PrefetchIterator:
    """Background-thread prefetch of ``depth`` upcoming batches: the
    worker draws them on the host (numpy only, no CUDA call off the main
    thread) and ``__next__`` moves one to ``device``, as ``(step,
    batch)``."""

    def __init__(self, cfg: DataConfig, model: ModelConfig,
                 mesh=None, start_step: int = 0, depth: int = 2,
                 device="cuda") -> None:
        if mesh is not None:
            raise NotImplementedError(
                "PrefetchIterator(mesh=...): the host-sharded batch comes "
                "with the LM mesh (ROADMAP item C.7)")
        self.cfg = cfg
        self.model = model
        self.device = resolve_device(device)
        self.step = start_step
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            batch = _host_batch(self.cfg, self.model, s)
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
        return s, _to_device(batch, self.device)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
