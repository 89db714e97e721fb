"""Batched decode serving: fixed-slot continuous batching engine.

Port of ``repro/serve/engine.py``. A :class:`ServeEngine` owns B cache
slots with independent per-slot positions. Every tick runs ONE decode over
all slots (prompt tokens are fed through the same decode path:
"prefill-as-decode" continuous batching); a finished request frees its
slot for the next queued one. The cache is preallocated and updated in
place by the decode (the reference donates it to a jitted decode). On a
CUDA device the tick's decode is one CUDA graph, captured on the first
tick (where the reference jits it); every decoder-only cache updates in
place there (K/V and ``kpos``, MLA's ``ckv``/``kr``, the SSM's ``conv`` and
f32 ``ssm``). The greedy argmax runs on the device
and returns the first maximum, as ``np.argmax`` does, so a tick copies B
token ids to the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..models.api import ModelAPI
from ..models.params import init_params


@dataclasses.dataclass
class Request:
    """A generation request: ``prompt`` token ids, at most ``max_new``
    greedy tokens appended to ``out``."""

    rid: int
    prompt: list
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    fed: int = 0                    # prompt tokens already consumed


class ServeEngine:
    """Fixed-slot continuous batching over ``model.decode``.

    Parameters
    ----------
    model : ModelAPI
    params : dict
        The model's parameters, on ``device``.
    n_slots : int
        Cache slots, the decode's batch.
    max_seq : int
        Each slot's cache length; a request stops at position
        ``max_seq - 1``.
    device : str or torch.device, optional
        ``None`` = ``cuda``; ``"cpu"`` for the CPU.
    """

    def __init__(self, model: ModelAPI, params, *, n_slots: int = 4,
                 max_seq: int = 256, device=None):
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.device = resolve_device(device)
        self.cache = init_params(model.cache_schema(n_slots, max_seq),
                                 device=self.device)
        self.pos = np.zeros((n_slots,), np.int32)
        self.slot_req: list = [None] * n_slots
        self.queue: list = []
        self._graph = None          # CUDA: (graph, static inputs, output)

    def submit(self, req: Request):
        """Queue a request; it is admitted at a tick with a free slot."""
        self.queue.append(req)

    def _admit(self):
        # as the reference, only the position is reset: a slot's SSM state
        # (``conv``/``ssm``) carries over from its previous request and the
        # idle ticks since (ROADMAP queue 3); an attention cache is masked
        # past the position, so it does not show
        for slot in range(self.n_slots):
            if self.slot_req[slot] is None and self.queue:
                req = self.queue.pop(0)
                req.slot, req.fed = slot, 0
                self.pos[slot] = 0
                self.slot_req[slot] = req

    def step(self) -> int:
        """One engine tick: one token for every active slot, in one call.
        Returns the number of active slots (0: nothing to do)."""
        self._admit()
        tokens = np.zeros((self.n_slots, 1), np.int32)
        active = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            active.append(slot)
            if req.fed < len(req.prompt):                  # still prefilling
                tokens[slot, 0] = req.prompt[req.fed]
            else:                                          # generating
                tokens[slot, 0] = req.out[-1]
        if not active:
            return 0

        next_tok = self._tick(tokens, self.pos.copy())
        for slot in active:
            req = self.slot_req[slot]
            self.pos[slot] += 1
            if req.fed < len(req.prompt):
                req.fed += 1
                if req.fed < len(req.prompt):
                    continue                               # keep prefilling
            req.out.append(int(next_tok[slot]))
            if len(req.out) >= req.max_new or self.pos[slot] >= self.max_seq - 1:
                req.done = True
                self.slot_req[slot] = None
        return len(active)

    def _tick(self, tokens: np.ndarray, pos: np.ndarray) -> np.ndarray:
        """One decode over every slot: tokens (B, 1) and positions (B,) in,
        each slot's greedy next token out. On a CUDA device the decode is
        captured into a CUDA graph on the first tick (run eagerly, then
        captured from the same inputs) and replayed from the second: the
        shapes are fixed and the cache is updated in place, so only the
        tokens and positions change (the reference jits the decode)."""
        tok = torch.from_numpy(tokens).to(self.device)
        p = torch.from_numpy(pos).to(self.device)
        if self.device.type != "cuda":
            logits, self.cache = self.model.decode(self.params, self.cache,
                                                   tok, p)
            return torch.argmax(logits, dim=-1).numpy()
        if self._graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):       # warm-up off the capture
                logits, self.cache = self.model.decode(self.params,
                                                       self.cache, tok, p)
                next_tok = torch.argmax(logits, dim=-1)
            torch.cuda.current_stream(self.device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            static = (tok.clone(), p.clone())
            with torch.cuda.graph(graph):
                logits, _ = self.model.decode(self.params, self.cache,
                                              *static)
                out = torch.argmax(logits, dim=-1)
            self._graph = (graph, static, out)
            return next_tok.cpu().numpy()
        graph, (s_tok, s_pos), out = self._graph
        s_tok.copy_(tok)
        s_pos.copy_(p)
        graph.replay()
        return out.cpu().numpy()

    def run(self, max_ticks: int = 10_000) -> int:
        """Tick until the queue and the slots are empty (or ``max_ticks``);
        returns the ticks run."""
        ticks = 0
        while (self.queue or any(r is not None for r in self.slot_req)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks
