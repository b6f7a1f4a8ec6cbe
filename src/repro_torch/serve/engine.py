"""Batched serving engine: slot-based continuous batching over the model
zoo's prefill/decode paths (port of ``repro/serve/engine.py``).

A fixed pool of ``slots`` holds one batch-1 cache each. Every tick first
refills empty slots from the request queue (a prefill of the prompt into
the slot's cache, which yields the first token), then runs one decode step
per live slot. Greedy sampling is ``argmax``; temperature sampling is the
Gumbel-max draw of :mod:`repro_torch.random`, keyed from the logits as the
reference keys it, so with float32 logits it draws what ``jax.random``
draws. Caches live where the parameters live and are reused on refill:
setting ``len`` to 0 empties one, since prefill overwrites positions
``[0, S)`` (and the whole ``cross`` stack, and every Mamba, mLSTM and
sLSTM state and conv tail) and attention reads only positions below
``len``. The vlm and audio families take a memory with
each request (``Request.memory``, (Sm, D): image tokens or encoder
frames, ``mem_len`` = ``num_image_tokens`` or ``encoder_seq`` positions),
handed to prefill as (1, Sm, D) float32 and cast there, as in the
reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import random as trandom
from ..models import decode_step, init_cache, prefill
from ..models.config import ModelConfig

PyTree = Any


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new: int = 16
    temperature: float = 0.0    # 0 = greedy
    memory: Optional[np.ndarray] = None  # (Sm, D): vlm image tokens / audio frames


@dataclass
class GenerationResult:
    rid: int
    tokens: List[int]
    prompt_len: int


def sample_key(logits: torch.Tensor) -> torch.Tensor:
    """The reference's key for a temperature draw: ``PRNGKey(int(sum|logits|
    · 1e3) mod 2**31)``, the sum rounded to the logits' dtype (as ``jnp.sum``
    returns it) before the product in that dtype."""
    total = logits.abs().float().sum().to(logits.dtype) * 1e3
    return trandom.prng_key(int(total.item()) % (2**31), device=logits.device)


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params: PyTree, *, slots: int = 4, max_len: int = 512):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.mem_len = {"vlm": cfg.num_image_tokens, "audio": cfg.encoder_seq}.get(cfg.family, 0)
        self._queue: List[Request] = []
        self._active: Dict[int, Request] = {}        # slot -> request
        self._generated: Dict[int, List[int]] = {}
        self._done: List[GenerationResult] = []
        self._budget: Dict[int, int] = {}

        # one cache per slot (batch=1) — refilled in place
        self._caches: List[PyTree] = [
            init_cache(cfg, 1, max_len, memory_len=self.mem_len, device=self.device)
            for _ in range(slots)
        ]
        self._next_tok = np.zeros((slots, 1), np.int64)
        self._live = np.zeros((slots,), bool)

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self._queue.append(req)

    def run(self, max_ticks: int = 1000) -> List[GenerationResult]:
        ticks = 0
        while (self._queue or self._live.any()) and ticks < max_ticks:
            self.tick()
            ticks += 1
        return self.results()

    def results(self) -> List[GenerationResult]:
        out, self._done = self._done, []
        return out

    # -- engine internals ------------------------------------------------------
    def tick(self) -> None:
        self._fill_slots()
        if not self._live.any():
            return
        for s in np.nonzero(self._live)[0]:
            tok = torch.from_numpy(self._next_tok[s : s + 1]).to(self.device)
            logits, self._caches[s] = decode_step(self.params, self.cfg, tok, self._caches[s])
            nxt = self._sample(logits, self._active[s].temperature)
            self._push_token(int(s), nxt)

    def _fill_slots(self) -> None:
        for s in range(self.slots):
            if self._live[s] or not self._queue:
                continue
            req = self._queue.pop(0)
            cache = self._caches[s]
            cache["len"] = 0
            toks = torch.as_tensor(np.asarray(req.prompt)[None, :], dtype=torch.int64,
                                   device=self.device)
            mem = None
            if self.mem_len:
                mem = torch.as_tensor(np.asarray(req.memory)[None], dtype=torch.float32,
                                      device=self.device)
            logits, self._caches[s] = prefill(self.params, self.cfg, toks, cache, memory=mem)
            nxt = self._sample(logits, req.temperature)
            self._active[s] = req
            self._generated[s] = []
            self._budget[s] = req.max_new
            self._live[s] = True
            self._push_token(s, nxt)

    def _push_token(self, slot: int, tok: int) -> None:
        self._generated[slot].append(tok)
        self._next_tok[slot, 0] = tok
        if len(self._generated[slot]) >= self._budget[slot]:
            req = self._active.pop(slot)
            self._done.append(
                GenerationResult(req.rid, self._generated.pop(slot), len(req.prompt))
            )
            self._live[slot] = False

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float) -> int:
        if temperature <= 0:
            return int(torch.argmax(logits[0]))
        return int(trandom.categorical(sample_key(logits), logits[0].float() / temperature))
