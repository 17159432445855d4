#!/usr/bin/env python3
"""The refined solver of this checkout against another checkout's, on
the card: are the potentials bitwise equal, and how long does each take?

Run from the root of a checkout, with another checkout (the parent,
unpacked by ``git archive``) at OTHER:

    python3 scripts/torch_solver_bits.py OTHER

Two hard fields (``potential.fields.conductivity_hard``, seeds 1 and 2,
460x460 and 500x600, track direction 0) are solved by the one-device
refined solver (``potential.lap.solve_potential_refined``), in a batch
of BATCH fields of their grid (seeds from theirs on, through
``solve_potential_refined_batch``) and, where a checkout has it, by the
row-sharded one over ``[cuda:0] * SHARDS``
(``parallel.solve_potential_refined_sharded``). Each checkout solves in
a process of its own, in turns: this, other, other, this. The script
prints the card's name and power limit, one JSON line a process (rrel,
V-cycles, seconds, the sharded solve's moves between shards), one line a
result saying whether it is bitwise equal across the checkouts and
between this checkout's two processes, and last one JSON line of those
answers. It exits 1 if this checkout's two processes differ.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = {'hard_460': ((460, 460), 1), 'hard_500x600': ((500, 600), 2)}
SHARDS = 4
BATCH = 4


def child(root: str, inputs: str, out: str) -> None:
    """Solve the fields in ``inputs`` with the package of ``root``; save
    the potentials to ``out`` and print their numbers."""
    import torch
    sys.path.insert(0, root)
    import ssrs_tpu_torch
    from ssrs_tpu_torch.potential import lap
    from ssrs_tpu_torch.potential.boundary import boundary_masks
    if not ssrs_tpu_torch.__file__.startswith(os.path.abspath(root)):
        raise RuntimeError(f'imported {ssrs_tpu_torch.__file__}, not the '
                           f'package of {root}')
    try:
        from ssrs_tpu_torch.parallel import solve_potential_refined_sharded
    except ImportError:
        solve_potential_refined_sharded = None
    mesh = [torch.device('cuda', 0)] * SHARDS
    pots, meta = {}, {}
    for name in FIELDS:
        cond = torch.from_numpy(np.load(os.path.join(
            inputs, f'{name}.npy'))).cuda()
        conds = torch.from_numpy(np.load(os.path.join(
            inputs, f'{name}_batch.npy'))).cuda()
        bmask, bvals = boundary_masks(0., tuple(cond.shape))
        runs = [('one_device', lambda st: lap.solve_potential_refined(
            cond, bmask, bvals, stats=st)),
                ('batch', lambda st: lap.solve_potential_refined_batch(
                    conds, bmask, bvals, stats=st))]
        if solve_potential_refined_sharded is not None:
            runs.append(('sharded', lambda st: solve_potential_refined_sharded(
                cond, bmask, bvals, mesh=mesh, stats=st)))
        for kind, solve in runs:
            stats = {}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pot, rrel = solve(stats)
            if kind == 'sharded':
                pot = pot.gather()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            pots[f'{name}/{kind}'] = pot.cpu().numpy()
            meta[f'{name}/{kind}'] = {
                'rrel': np.asarray(rrel).tolist(),
                'vcycles': stats['vcycles'], 'seconds': secs,
                **({'moves': {k: v['moves'] for k, v in
                              stats['transfers'].items()}}
                   if 'transfers' in stats else {})}
    np.savez(out, **pots)
    print(json.dumps({'root': root, 'solves': meta}), flush=True)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == '--child':
        child(*sys.argv[2:])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print('FAIL: no CUDA device', file=sys.stderr)
        return 1
    other = os.path.abspath(sys.argv[1])
    if not os.path.isfile(os.path.join(other, 'ssrs_tpu_torch',
                                       'potential', 'lap.py')):
        print(f'FAIL: no ssrs_tpu_torch under {other}', file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ssrs_tpu_torch.potential.fields import conductivity_hard
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory(dir=REPO, prefix='.smoke_bits_') as tmp:
        for name, (shape, seed) in FIELDS.items():
            np.save(os.path.join(tmp, f'{name}.npy'),
                    conductivity_hard(shape, seed=seed))
            np.save(os.path.join(tmp, f'{name}_batch.npy'), np.stack(
                [conductivity_hard(shape, seed=seed + i)
                 for i in range(BATCH)]))
        res = {}
        for tag, root in (('this', REPO), ('other', other),
                          ('other_again', other), ('this_again', REPO)):
            out = os.path.join(tmp, f'{tag}.npz')
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            '--child', root, tmp, out], check=True,
                           timeout=900)
            with np.load(out) as f:
                res[tag] = {k: f[k] for k in f.files}
    answers = {}
    for key, pot in res['this'].items():
        same = {'repeatable': bool(np.array_equal(pot,
                                                  res['this_again'][key]))}
        if key in res['other']:
            same['equal_to_other'] = bool(np.array_equal(pot,
                                                         res['other'][key]))
        answers[key] = same
        print(f'{key}: {same}', flush=True)
    print(json.dumps({'bitwise': answers}), flush=True)
    return 0 if all(a['repeatable'] for a in answers.values()) else 1


if __name__ == '__main__':
    sys.exit(main())
