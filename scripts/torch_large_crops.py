"""Crops of BASELINE config 5's field, each solved alone by the port's
refined solver on one CUDA card and by the host's float64 direct solve.

The field is the thresholded updraft of ``chip_smoke.py``'s
``LARGE_CONFIG`` (200x200 km at 30 m, 6667x6667 cells), built by the
port's ``Simulator`` on the card (the constructor only: terrain and
updraft, offline, so the terrain is the synthetic DEM). From it the
script cuts ``SSRS_CROP`` x ``SSRS_CROP`` windows (default 600, the
largest the smoke's host direct solves take) at eleven places spread over
the grid, and solves each with the run's track direction and the
``Simulator``'s tol and V-cycle budget. The whole grid has no direct
solve (44.4M unknowns), so these windows are where the refined solver on
this field can be held against one.

    python3 scripts/torch_large_crops.py
    SSRS_CROP=1000 python3 scripts/torch_large_crops.py

Prints one JSON line a crop: its corner, the refined solve's rrel,
passes, V-cycles and seconds, whether the Simulator's 5e-3 net would
accept it, the direct solve's seconds, and the max and mean |refined -
direct| (of 1000) over all cells and over the cells with conductivity >
0; then the card's name and power limit. Without a CUDA device it exits
non-zero and prints no result. It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np
import torch

import chip_smoke

# the corners of the windows, as fractions of the room left beside one
CORNERS = ((0.075, 0.075), (0.075, 0.45), (0.075, 0.9), (0.45, 0.075),
           (0.45, 0.45), (0.45, 1.), (1., 0.075), (1., 0.45), (1., 1.),
           (0.225, 0.225), (0.675, 0.675))


def main() -> int:
    if not torch.cuda.is_available():
        print('torch_large_crops.py: no CUDA device', file=sys.stderr)
        return 1
    chip_smoke._refuse_http()
    from ssrs_tpu_torch import Config, Simulator
    size = int(os.environ.get('SSRS_CROP', 600))
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_') as out:
        sim = Simulator(Config(out_dir=out, **chip_smoke.LARGE_CONFIG))
        field = sim.load_updrafts(sim.case_ids[0], device=False)[0]
    room = np.array(field.shape) - size
    for fr, fc in CORNERS:
        out = chip_smoke.crop_against_direct(
            torch, field, int(fr * room[0]), int(fc * room[1]), size,
            float(sim.track_direction), float(sim.potential_tol))
        print(json.dumps({**out, 'inside_net': out['rrel'] <= chip_smoke.LARGE_RREL_MAX}),
              flush=True)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    print(json.dumps({'device': smi.stdout.strip().splitlines()[0]}),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
