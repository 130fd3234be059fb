"""Deterministic, checkpoint-friendly randomness (port of
``vsr_tpu/utils/rng.py``).

Every consumer derives an independent stream from a single root seed through
``np.random.SeedSequence`` spawn keys, so results do not depend on worker
count, epoch replay order, or library-internal draws:

    root -> ("shuffle", epoch)              the epoch's sample order
    root -> ("data", epoch, sample_index)   per-sample augmentation Generator
    root -> ("init",)                       torch Generator for model init

``seed_to_int`` and ``numpy_generator`` are copies of the JAX package's, so
shuffles and augmentations are the same draws in both packages (the tests
pin them). String seeds are hashed with SHA-256 so they are stable across
processes and Python versions.
"""

from __future__ import annotations

import hashlib
from typing import Iterable

import numpy as np
import torch


def seed_to_int(seed: int | str) -> int:
    """Map an int or string seed to a stable uint64-range int."""
    if isinstance(seed, (int, np.integer)):
        return int(seed) & 0xFFFFFFFFFFFFFFFF
    digest = hashlib.sha256(str(seed).encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little")


def _tokens_to_ints(tokens: Iterable[int | str]) -> list[int]:
    return [seed_to_int(t) for t in tokens]


class RngTree:
    """Derives independent numpy and torch Generators from one root seed."""

    def __init__(self, root_seed: int | str):
        self.root_seed = root_seed
        self._root = seed_to_int(root_seed)

    def numpy_generator(self, *tokens: int | str) -> np.random.Generator:
        ss = np.random.SeedSequence([self._root] + _tokens_to_ints(tokens))
        return np.random.Generator(np.random.Philox(ss))

    def torch_generator(self, *tokens: int | str,
                        device: torch.device | str = "cpu") -> torch.Generator:
        """A torch Generator seeded from the word the JAX package turns into
        its PRNG key for the same token path (the draws differ: another
        generator; two runs with one seed agree)."""
        ss = np.random.SeedSequence([self._root] + _tokens_to_ints(tokens))
        gen = torch.Generator(device=device)
        gen.manual_seed(int(ss.generate_state(1, np.uint32)[0]))
        return gen

    def __repr__(self) -> str:
        return f"RngTree(root_seed={self.root_seed!r})"
