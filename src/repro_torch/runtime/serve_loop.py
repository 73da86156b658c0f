"""Batched serving loop: continuous batched decode over a request queue
(port of ``repro.runtime.serve_loop``).

The loop keeps a fixed batch of slots, prefills an empty slot from the
queue and steps all slots together; each slot decodes at its own position.
A slot finishes at ``max_new_tokens``, at ``eos_id`` or when its position
reaches ``max_len - 1``, and is refilled.  Greedy decoding takes the
argmax (the first index on ties, as ``jnp.argmax``).  Sampling at
``temperature > 0`` draws from a ``torch.Generator`` seeded with `seed` on
the model's device: reproducible per seed, but not jax's
``categorical`` stream.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import DecoderLM, decode_step, init_decode_state


@dataclasses.dataclass(frozen=True)
class ServeLoopConfig:
    batch_slots: int = 4
    max_new_tokens: int = 32
    max_len: int = 256
    eos_id: int = -1              # -1: no EOS, run to max_new_tokens
    temperature: float = 0.0      # 0 = greedy


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (prompt_len,) int32


def run_serving(cfg: ModelConfig, params: DecoderLM, requests: list[Request],
                serve: ServeLoopConfig = ServeLoopConfig(),
                seed: int = 0) -> dict[int, np.ndarray]:
    """Serve all requests on the model's device; returns {uid: generated
    tokens}."""
    dev = params.device
    b = serve.batch_slots
    state = init_decode_state(cfg, batch=b, max_len=serve.max_len, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def step(tok: np.ndarray, positions: np.ndarray) -> torch.Tensor:
        logits, _ = decode_step(params, cfg, state,
                                torch.from_numpy(tok).to(dev),
                                torch.from_numpy(positions).to(dev))
        return logits[:, 0]

    queue = list(requests)
    active: list[Optional[Request]] = [None] * b
    progress = np.zeros(b, np.int64)          # tokens generated per slot
    pos = np.zeros(b, np.int64)               # next position per slot
    cur = np.zeros((b, 1), np.int64)
    outputs: dict[int, list[int]] = {}

    def admit(slot: int):
        """Prefill a slot from the queue token by token (teacher forcing
        through the decode path).  The other slots are stepped alongside
        at their own, unchanged positions: re-encoding a slot's current
        token at its current position writes the cache entry its next
        real step writes, so prefilling one slot never perturbs another."""
        req = queue.pop(0)
        active[slot] = req
        outputs[req.uid] = []
        logits = None
        for t, tok in enumerate(req.prompt):
            tok_b = cur.copy()
            tok_b[slot, 0] = int(tok)
            pos_t = pos.copy()
            pos_t[slot] = t
            logits = step(tok_b, pos_t)
        if logits is not None:
            cur[slot, 0] = int(torch.argmax(logits[slot]))
            outputs[req.uid].append(int(cur[slot, 0]))
        else:
            # Empty prompt: there are no logits to sample from; seed the
            # slot from token 0 (a fixed BOS surrogate) and let the shared
            # step below generate the first real token.
            cur[slot, 0] = 0
        pos[slot] = len(req.prompt)
        progress[slot] = 0

    while queue or any(a is not None for a in active):
        for slot in range(b):
            if active[slot] is None and queue:
                admit(slot)
        logits = step(cur, pos)
        if serve.temperature > 0:
            probs = torch.softmax(logits / serve.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        nxt = nxt.cpu().numpy()
        for slot in range(b):
            req = active[slot]
            if req is None:
                continue
            tok = int(nxt[slot])
            outputs[req.uid].append(tok)
            progress[slot] += 1
            pos[slot] += 1
            cur[slot, 0] = tok
            done = (progress[slot] >= serve.max_new_tokens
                    or tok == serve.eos_id
                    or pos[slot] >= serve.max_len - 1)
            if done:
                active[slot] = None
    return {uid: np.asarray(toks, np.int32) for uid, toks in outputs.items()}
