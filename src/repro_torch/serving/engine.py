"""Batched decode serving engine: continuous slot-based batching.

Counterpart of ``repro.serving.engine``. A fixed pool of B slots over one
shared cache; requests are admitted into free slots, their prompts
teacher-forced one token a tick, then decoded one token per engine step
(greedy, or sampled at a temperature), and retired on EOS or length. The
step runs the model's ``decode_step`` on the engine's device (CUDA unless
the caller names one; without a GPU the default raises), eagerly: there is
no ``jit`` to trace.

Greedy decoding is ``torch.argmax`` (the first maximum, as ``jnp.argmax``),
so on the same model the engine gives the reference's outputs and tick
count. Temperature sampling draws from a ``torch.Generator`` seeded from
``seed`` on the engine's device: the same seed gives the same outputs, but
not the reference's ``jax.random`` draws, so parity with the reference
holds at temperature 0 only.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.additive_gp import resolve_device

__all__ = ["ServeEngine", "Request"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 32
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    def __init__(self, model, params, par, batch_slots: int = 8,
                 ctx: int = 1024, eos_id: int = 0, temperature: float = 0.0,
                 seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model
        self.params = params
        self.par = par
        self.B = batch_slots
        self.ctx = ctx
        self.eos = eos_id
        self.temperature = temperature
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.cache = model.init_cache(batch_slots, ctx)
        self.pos = np.zeros(batch_slots, np.int32)
        self.slots: list[Request | None] = [None] * batch_slots
        self.pending: list[Request] = []
        self.tokens = np.zeros((batch_slots, 1), np.int32)

    def submit(self, req: Request):
        self.pending.append(req)

    def _admit(self):
        for i in range(self.B):
            if self.slots[i] is None and self.pending:
                req = self.pending.pop(0)
                self.slots[i] = req
                # prefill by teacher-forcing the prompt one token at a time
                # (slot-local; pos is per-engine uniform in this simple engine)
                req._cursor = 0  # type: ignore[attr-defined]
                self.tokens[i, 0] = req.prompt[0]

    def step(self) -> list[Request]:
        """One engine tick; returns newly finished requests."""
        self._admit()
        if all(s is None for s in self.slots):
            return []
        pos = int(self.pos.max())
        logits, self.cache = self.model.decode_step(
            self.params, self.cache,
            torch.as_tensor(self.tokens, device=self.device),
            torch.tensor(pos, dtype=torch.int32, device=self.device),
            self.par)
        if self.temperature > 0:
            probs = torch.softmax(logits[:, 0].double() / self.temperature,
                                  dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self.generator)[:, 0]
        else:
            nxt = torch.argmax(logits[:, 0], dim=-1)
        nxt = nxt.to(torch.int32).cpu().numpy()
        finished = []
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            cur = getattr(req, "_cursor", 0) + 1
            if cur < len(req.prompt):  # still consuming the prompt
                self.tokens[i, 0] = req.prompt[cur]
            else:
                req.out.append(int(nxt[i]))
                self.tokens[i, 0] = int(nxt[i])
                if len(req.out) >= req.max_new or int(nxt[i]) == self.eos:
                    req.done = True
                    finished.append(req)
                    self.slots[i] = None
            req._cursor = cur  # type: ignore[attr-defined]
        self.pos += 1
        return finished

    def run_until_done(self, max_ticks: int = 10_000) -> list[Request]:
        done = []
        for _ in range(max_ticks):
            done += self.step()
            if not self.pending and all(s is None for s in self.slots):
                break
        return done
