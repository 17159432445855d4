"""Seed hierarchy for ``torch.Generator``s.

The same hierarchy as ``ssrs_tpu/core/rng.py``:

    root(seed) -> case -> realization -> {"potential","thermals","tracks"}

with the same sha256 string labels. JAX folds labels into threefry keys;
here each fold hashes the parent seed and the label into a new 64-bit
seed, and the leaf seeds a ``torch.Generator`` on the run's device. The
two packages therefore draw different numbers from the same seed (JAX's
threefry and torch's Philox never agree); each is reproducible on its
own for a fixed seed, device type and shape.
"""

from __future__ import annotations

import hashlib

import torch

_MASK64 = (1 << 64) - 1


def root_seed(sim_seed: int) -> int:
    """Root seed of a run; negative seeds (the reference's "unseeded"
    mode, ssrs/config.py:17) map to a fixed but distinct stream."""
    return sim_seed if sim_seed >= 0 else 0x5539


def fold_in(seed: int, data: int) -> int:
    """Deterministically mix the integer ``data`` into ``seed``."""
    payload = (int(seed) & _MASK64).to_bytes(8, 'little') + \
        (int(data) & _MASK64).to_bytes(8, 'little')
    return int.from_bytes(hashlib.sha256(payload).digest()[:8], 'little')


def fold_str(seed: int, name: str) -> int:
    """Fold a string label into a seed (the label's tag is the one
    ``ssrs_tpu.core.rng.fold_str`` uses)."""
    digest = hashlib.sha256(name.encode('utf-8')).digest()
    return fold_in(seed, int.from_bytes(digest[:4], 'little'))


def case_seed(sim_seed: int, case_id: str, real_id: int, stream: str) -> int:
    """64-bit seed of one (case, realization, stream) triple."""
    seed = fold_str(root_seed(sim_seed), case_id)
    seed = fold_in(seed, real_id)
    return fold_str(seed, stream)


def case_generator(sim_seed: int, case_id: str, real_id: int, stream: str,
                   device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`case_seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(case_seed(sim_seed, case_id, real_id, stream))
    return gen
