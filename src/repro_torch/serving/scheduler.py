"""Continuous-batching serving scheduler (vLLM-style slot management).

A fixed pool of B decode slots runs one decode step per tick with a
*per-slot* position vector (``nn.attention.attention_decode`` takes a (B,)
``cur_pos``). Requests join whenever a slot frees up; prompt tokens are
teacher-forced through the same decode path, per slot, so other slots keep
generating while one is still prefilling, and finished requests leave
without stalling the batch. Each request is greedy (``temperature`` 0) or
sampled; a sampled request draws from ``softmax(logits / 0.8)`` whatever
its ``temperature``, as the JAX package's scheduler does.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from repro_torch.launch.steps import make_decode_step

# the temperature of every sampled request (src/repro/serving/scheduler.py)
SAMPLE_TEMPERATURE = 0.8


@dataclasses.dataclass
class Request:
    prompt: list                   # token ids
    max_new_tokens: int = 16
    temperature: float = 0.0
    # filled by the scheduler:
    output: Optional[list] = None
    slot: Optional[int] = None


class ContinuousBatcher:
    """Slot-pool scheduler over a transformer-family decode step. Runs
    where ``params`` lie; samples from a ``torch.Generator`` of ``seed`` on
    that device."""

    def __init__(self, spec, cfg, params, *, num_slots=4, max_len=128,
                 seed=0):
        if spec.family != "transformer":
            raise ValueError("the scheduler serves transformer-family decode")
        self.spec, self.cfg, self.params = spec, cfg, params
        self.device = params["embed"]["table"].device
        self.B = num_slots
        self.max_len = max_len
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self._decode = make_decode_step(spec, cfg)
        self.state = spec.model.init_decode_state(
            cfg, num_slots, max_len, dtype=torch.float32, device=self.device)
        # per-slot bookkeeping (host side)
        self.pos = [0] * num_slots          # next position to write
        self.active: List[Optional[Request]] = [None] * num_slots
        self.pending: List[Request] = []
        self.done: List[Request] = []
        self._next_tok = [0] * num_slots    # token to feed this tick

    def submit(self, req: Request):
        req.output = []
        self.pending.append(req)

    def _admit(self):
        for s in range(self.B):
            if self.active[s] is None and self.pending:
                req = self.pending.pop(0)
                req.slot = s
                self.active[s] = req
                self.pos[s] = 0
                self._next_tok[s] = req.prompt[0]
                self._invalidate_slot(s)

    def _invalidate_slot(self, s):
        """Recycle slot ``s``: mark every cached position of it empty (in
        place), so the new tenant never attends to the last one's keys."""
        for cache in self.state.values():
            cache["pos"][:, s] = -1

    def _sample(self, logits):
        """Per-slot next tokens: argmax where the slot's request is greedy
        (``temperature`` 0), else a draw from ``softmax(logits / 0.8)``:
        the JAX package's scheduler samples every request at 0.8."""
        hot = [r is not None and r.temperature > 0 for r in self.active]
        nxt = logits.argmax(dim=-1)
        if any(hot):
            probs = torch.softmax(logits.float() / SAMPLE_TEMPERATURE, dim=-1)
            drawn = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
            nxt = torch.where(torch.tensor(hot, device=logits.device), drawn,
                              nxt)
        return nxt.tolist()

    @torch.inference_mode()
    def step(self):
        """One decode tick for all slots. Returns the number of active
        slots."""
        self._admit()
        if not any(self.active):
            return 0
        toks = torch.tensor([[t] for t in self._next_tok], dtype=torch.long,
                            device=self.device)
        cur = torch.tensor(self.pos, dtype=torch.int32, device=self.device)
        logits, self.state = self._decode(self.params, self.state, toks, cur)
        nxt = self._sample(logits[:, -1])
        active = 0
        for s in range(self.B):
            req = self.active[s]
            if req is None:
                continue
            active += 1
            self.pos[s] += 1
            if self.pos[s] < len(req.prompt):
                # still prefilling: feed the next prompt token
                self._next_tok[s] = req.prompt[self.pos[s]]
                continue
            req.output.append(nxt[s])
            self._next_tok[s] = nxt[s]
            if (len(req.output) >= req.max_new_tokens
                    or self.pos[s] >= self.max_len - 1):
                self.done.append(req)
                self.active[s] = None
        return active

    def run(self, max_ticks=10_000):
        ticks = 0
        while (self.pending or any(self.active)) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.done, ticks
