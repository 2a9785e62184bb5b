"""Batched LM serving engine: continuous batching over a fixed decode
batch, greedy decoding.

The engine keeps a fixed-size decode batch; finished sequences free
their slot, queued requests are admitted into a free slot and their
prompt is fed token by token through the decode path at that slot's
row. It is the reference's engine, admission, slot freeing and token
stream alike.

The reference jits ``decode_step``; here, on a CUDA device, the engine
captures it once as a CUDA graph and replays it for every later step.
The graph reads static buffers (the ``(B, 1)`` token tensor, a ``(1,)``
position tensor and the cache, which ``decode_step`` writes in place)
and writes a static logits tensor; a step fills the token and the
position in, replays, and takes the slot's argmax outside the graph. The
first step on the card is the warm pass: ``decode_step`` run eagerly on
a side stream through the same buffers (it builds the lazily made
tables the graph then reads), and its logits are that step's; the
capture follows on the same stream of the params' card, and records
without running. A capture that fails raises: the engine never carries
on with the eager step on a card. On the CPU every step is the eager
``decode_step`` through the same buffers. The graph binds the params,
the cache and the buffers by address, so they stay the engine's for its
lifetime.
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
    the caller asks for the CPU), where the cache, the static buffers and,
    on a card, the decode graph are made: one capture per engine, that is
    per (config, batch, ``max_len``)."""

    def __init__(self, cfg: ModelConfig, params: PyTree, batch_size: int,
                 max_len: int = 512, device="cuda") -> None:
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.b = batch_size
        self.max_len = max_len
        self.cache = init_cache(cfg, batch_size, max_len, self.device)
        self._tokens = torch.zeros((batch_size, 1), dtype=torch.long,
                                   device=self.device)
        self._pos = torch.zeros((1,), dtype=torch.long, device=self.device)
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._logits: Optional[torch.Tensor] = None
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
    def _decode(self) -> torch.Tensor:
        """The step the graph records: ``decode_step`` on the static
        token and position buffers and the cache; (B, vocab) logits."""
        with torch.no_grad():
            return decode_step(self.params, self._tokens, self.cache,
                               self._pos, self.cfg)[0]

    def _capture(self) -> torch.Tensor:
        """The warm pass, then the capture of ``_decode``; returns the
        warm pass's logits (this step's)."""
        stream = torch.cuda.Stream(device=self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            logits = self._decode()
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream,
                              capture_error_mode="thread_local"):
            static = self._decode()
        self._graph, self._logits = graph, static
        return logits

    def decode_logits(self, slot: int, token: int, pos: int) -> torch.Tensor:
        """(B, vocab) logits of one decode of the whole batch with
        ``token`` at row ``slot`` (0 elsewhere) at position ``pos``; the
        cache is written in place. On a card, a replay of the captured
        step (the warm pass and capture at the first call): the tensor
        returned is the graph's static output, overwritten by the next
        step."""
        self._tokens.zero_()
        self._tokens[slot, 0] = token
        self._pos.fill_(pos)
        if self.device.type != "cuda":
            return self._decode()
        if self._graph is None:
            return self._capture()
        self._graph.replay()
        return self._logits

    def _step_one(self, slot: int, token: int, emit: bool) -> Optional[int]:
        """One decode of the whole batch with ``token`` at row ``slot``
        (0 elsewhere) at the slot's position; the slot's argmax when
        ``emit``."""
        s = self.slots[slot]
        logits = self.decode_logits(slot, token, s.pos)
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
