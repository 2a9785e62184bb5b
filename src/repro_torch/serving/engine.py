"""Batched LM serving engine: continuous batching over a fixed decode
batch, greedy decoding.

The engine keeps a fixed-size decode batch; finished sequences free
their slot, queued requests are admitted into a free slot and their
prompt is fed token by token through the decode path at that slot's
row. It is the reference's engine, admission, slot freeing and token
stream alike. ``decode_step`` runs eagerly here; the reference jits it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import decode_step, init_cache

PyTree = Any


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (len,) int32
    max_new_tokens: int = 16
    out_tokens: Optional[List[int]] = None


@dataclasses.dataclass
class SlotState:
    rid: int = -1
    pos: int = 0
    remaining: int = 0


class ServingEngine:
    """Greedy-decoding engine over a fixed decode batch. ``params`` must
    live on ``device`` (``"cuda"`` by default; raises without CUDA unless
    the caller asks for the CPU), where the cache is made."""

    def __init__(self, cfg: ModelConfig, params: PyTree, batch_size: int,
                 max_len: int = 512, device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self.cache = init_cache(cfg, batch_size, max_len, self.device)
        self.slots = [SlotState() for _ in range(batch_size)]
        self.queue: List[Request] = []
        self.done: Dict[int, Request] = {}

    # ------------------------------------------------------------ intake
    def submit(self, req: Request) -> None:
        req.out_tokens = []
        self.queue.append(req)

    def _free_slot(self) -> Optional[int]:
        for i, s in enumerate(self.slots):
            if s.rid < 0:
                return i
        return None

    def _admit(self) -> None:
        """Continuous batching: prefill queued requests into free slots by
        feeding prompt tokens through the decode path at the slot rows."""
        while self.queue and self._free_slot() is not None:
            slot = self._free_slot()
            req = self.queue.pop(0)
            self.slots[slot] = SlotState(rid=req.rid, pos=0,
                                         remaining=req.max_new_tokens)
            self.done[req.rid] = req
            for t in req.prompt:
                self._step_one(slot, int(t), emit=False)

    # ------------------------------------------------------------ decode
    def _step_one(self, slot: int, token: int, emit: bool) -> Optional[int]:
        """One decode of the whole batch with ``token`` at row ``slot``
        (0 elsewhere) at the slot's position; the slot's argmax when
        ``emit``."""
        s = self.slots[slot]
        tokens = torch.zeros((self.b, 1), dtype=torch.long)
        tokens[slot, 0] = token
        logits, self.cache = decode_step(
            self.params, tokens.to(self.device), self.cache, s.pos, self.cfg)
        s.pos += 1
        if emit:
            return int(torch.argmax(logits[slot]))
        return None

    def step(self) -> int:
        """One engine tick: admit, then decode one token for every active
        slot. Returns number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.rid >= 0]
        if not active:
            return 0
        for i in active:
            s = self.slots[i]
            req = self.done[s.rid]
            last = (int(req.prompt[-1]) if not req.out_tokens
                    else req.out_tokens[-1])
            nxt = self._step_one(i, last, emit=True)
            req.out_tokens.append(nxt)
            s.remaining -= 1
            if s.remaining <= 0 or s.pos >= self.max_len - 1:
                self.slots[i] = SlotState()          # free the slot
        return len(active)

    def run_until_done(self, max_ticks: int = 1000) -> Dict[int, List[int]]:
        for _ in range(max_ticks):
            if self.step() == 0 and not self.queue:
                break
        return {rid: r.out_tokens for rid, r in self.done.items()}
