"""Deterministic seeding.

The port's own copy of hipt_abmil_atec23_tpu/utils/seeding.py: one root
seed gives per-fold and per-stream numpy generators for host-side sampling
(the same streams as the JAX package), and a ``torch.Generator`` takes the
place of the JAX package's root PRNG key for initialisation. torch and JAX
draw different numbers from the same seed, so only the host streams agree
between the two packages.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)


def fold_seed(root_seed: int, fold: int) -> int:
    """Stable per-fold seed (reference re-seeds with the same seed per fold;
    we derive distinct streams to avoid cross-fold correlation)."""
    return (root_seed * 1_000_003 + fold * 7919) % (2**31 - 1)


def host_rng(root_seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence((root_seed, *stream)))


def stream_seed(root_seed: int, *stream: int) -> int:
    """A 63-bit seed for the stream ``(root_seed, *stream)``, from the same
    SeedSequence as ``host_rng``."""
    seq = np.random.SeedSequence((root_seed, *stream))
    return int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1))


def torch_generator(root_seed: int, *stream: int,
                    device="cpu") -> torch.Generator:
    """A generator on ``device`` for the stream ``(root_seed, *stream)``,
    seeded from the same SeedSequence as ``host_rng``."""
    return torch.Generator(device=device).manual_seed(
        stream_seed(root_seed, *stream))
