"""PRNG discipline: explicit `torch.Generator`s derived from one seed.

Counterpart of the JAX package's `core/prng.py`, which folds
`jax.random` keys per (stage, iteration). Here every stream is a
`torch.Generator` on an explicit device, seeded from an integer that is
derived deterministically from the run seed (a keyed hash, stable across
processes, unlike Python's salted `hash(str)`). Torch's streams are not
JAX's: tests that compare the two packages feed both the same numpy draws.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import torch

_SEED_BITS = 63  # torch.Generator.manual_seed takes a non-negative int64


def fold_in(seed: int, data: int | str) -> int:
    """Deterministic child seed of `seed` for `data` (an int or a name)."""
    msg = f"{int(seed)}/{type(data).__name__}:{data}".encode()
    digest = hashlib.blake2b(msg, digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << _SEED_BITS) - 1)


def root_generator(seed: int, device="cuda") -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def stage_generator(seed: int, stage: str, device="cuda") -> torch.Generator:
    """Per-stage stream, independent of call order."""
    return root_generator(fold_in(seed, stage), device)


def iter_generator(seed: int, iteration: int, device="cuda") -> torch.Generator:
    return root_generator(fold_in(seed, int(iteration)), device)


def draw_seed(generator: torch.Generator) -> torch.Tensor:
    """A (1,) int64 kernel seed drawn on the generator's own device, so a
    caller on the card never waits for the host."""
    return torch.randint(0, 2**62, (1,), generator=generator,
                         device=generator.device, dtype=torch.int64)


@dataclass(frozen=True)
class RowSeed:
    """A kernel seed for a shard of a batch: the launch over the shard's
    rows draws, from `seed`, what one launch over the whole batch draws for
    global rows row0, row0 + 1, ..."""

    seed: torch.Tensor
    row0: int
