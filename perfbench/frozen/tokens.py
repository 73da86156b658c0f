"""Deterministic, step-indexed synthetic LM token pipeline: a frozen copy
of ``repro_torch/data/tokens.py``, so the benchmark's batches do not move
when the program's pipeline does.  ``batch(step)`` equals the program's
``TokenPipeline(...).batch(step)`` bit for bit on the same device.

``batch(step)`` is a pure function of (seed, step): every step of a run
draws rows of its own.  The stream: a per-(row, position) random walk over
``n_states`` Markov states (steps of -1, 0, +1, folded with Python's
``%``), a zipf-ish token inside the state's band of ``vocab // n_states``
ids (a uniform squared), and targets shifted by one with a uniform last
target, drawn from a ``torch.Generator`` on the pipeline's device seeded
from (seed, step) by ``step_seed``.
"""

from __future__ import annotations

import dataclasses

import torch


_MASK64 = (1 << 64) - 1


def step_seed(seed: int, step: int) -> int:
    """A 63-bit generator seed from (seed, step): splitmix64's finaliser
    over the pair, so nearby steps and seeds give unrelated streams."""
    z = ((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF)) & _MASK64
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_states: int = 64          # Markov states for bigram structure
    device: object = "cuda"

    def batch(self, step: int) -> dict:
        """{"tokens": (B, S) int32, "targets": (B, S) int32} on the
        pipeline's device."""
        dev = torch.device(self.device)
        gen = torch.Generator(device=dev).manual_seed(
            step_seed(self.seed, step))
        b, s = self.global_batch, self.seq_len
        band = self.vocab // self.n_states
        walk = torch.randint(0, 3, (b, s), generator=gen, device=dev) - 1
        # floor modulo, as Python's % on the negative sums
        states = torch.remainder(torch.cumsum(walk, dim=1), self.n_states)
        u = torch.rand((b, s), generator=gen, device=dev)
        base = (u * u * band).to(torch.int32)
        tokens = torch.clamp(states * band + base, 0, self.vocab - 1).to(
            torch.int32)
        last = torch.randint(0, self.vocab, (b, 1), generator=gen,
                             device=dev, dtype=torch.int32)
        return {"tokens": tokens,
                "targets": torch.cat([tokens[:, 1:], last], dim=1)}
