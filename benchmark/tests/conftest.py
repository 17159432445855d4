"""Shared fixtures of the benchmark's tests: the repository on the path,
offline ``requests``, and a copy of the benchmark cut to a size the CPU
runs in seconds."""

import json
import os
import shutil
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the tiny cut: 60x50 cells at 200 m, 300 steps, 12,000 tracks a case
# (above the default track_pkl_budget, so the counts-only drivers run, as
# in the cells)
TINY_CONFIG = dict(region_width_km=[12., 10.], resolution=200.,
                   track_start_region=[1., 11., 1., 2.],
                   track_max_steps=300)
TINY_DIRECTIONS = [0., 90., 180., 270.]
TINY_TRACKS = 12_000
# sound tiny runs read 0.02-0.04 (blocks of 5 cells)
TINY_COUNTS_L1 = 0.1
# and 1e-3-1e-2 of the expected total
TINY_COUNTS_MASS = 0.05


@pytest.fixture(scope='session', autouse=True)
def _offline():
    from benchmark import offline
    saved = sys.modules.get('requests')
    offline.refuse_http()
    yield
    if saved is None:
        sys.modules.pop('requests', None)
    else:
        sys.modules['requests'] = saved


def make_tiny_root(dest: str) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``dest`` with the
    configurations and mixes cut to the tiny size."""
    shutil.copytree(os.path.join(REPO, 'benchmark'),
                    os.path.join(dest, 'benchmark'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), dest)
    for name in os.listdir(os.path.join(dest, 'benchmark', 'configs')):
        path = os.path.join(dest, 'benchmark', 'configs', name)
        with open(path, encoding='utf-8') as f:
            doc = json.load(f)
        doc.update(TINY_CONFIG)
        if 'wind_directions' in doc:
            doc['wind_directions'] = TINY_DIRECTIONS
        with open(path, 'w', encoding='utf-8') as f:
            json.dump(doc, f)
    # sampling noise of a few thousand tracks, against the cells' limits
    # for hundreds of thousands
    for name in os.listdir(os.path.join(dest, 'benchmark', 'limits')):
        path = os.path.join(dest, 'benchmark', 'limits', name)
        with open(path, encoding='utf-8') as f:
            doc = json.load(f)
        doc['counts_l1'] = TINY_COUNTS_L1
        doc['counts_mass'] = TINY_COUNTS_MASS
        with open(path, 'w', encoding='utf-8') as f:
            json.dump(doc, f)
    for name in os.listdir(os.path.join(dest, 'benchmark', 'traffic')):
        path = os.path.join(dest, 'benchmark', 'traffic', name)
        with open(path, encoding='utf-8') as f:
            doc = json.load(f)
        doc['tracks_per_case'] = TINY_TRACKS
        with open(path, 'w', encoding='utf-8') as f:
            json.dump(doc, f)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


@pytest.fixture
def one_thread():
    """Torch on one thread: the fields' float32 ops give the same bits in
    every process (see the repository's verify notes)."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
