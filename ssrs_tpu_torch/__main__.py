"""Command-line entry point: ``python -m ssrs_tpu_torch <command>``.

The counterpart of ``ssrs_tpu/__main__.py`` on the port. A run config is a
JSON object whose keys are ``Config`` fields. ``Simulator`` writes such an
object to ``<out_dir>/<run_name>/<run_name>.json``, with four keys it
derives (``data_dir``, ``fig_dir``, ``mode_data_dir``, ``mode_fig_dir``);
the loader accepts and ignores those four, so a past run's JSON of either
package re-runs as it is.

Commands:
    run CONFIG.json [--no-plots] [--device cuda|cpu]
        build the Simulator on the device (default cuda, which raises
        without a card), simulate the tracks, compute the presence map,
        then draw the terrain, track and presence figures unless
        --no-plots is given (the figures need matplotlib; without it the
        command fails before it builds the Simulator)
    info
        package, torch and CUDA versions and the CUDA devices
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

# keys that Simulator adds to its run JSON; they follow from out_dir,
# run_name and sim_mode
DERIVED_KEYS = ('data_dir', 'fig_dir', 'mode_data_dir', 'mode_fig_dir')


def _load_config(path: str):
    from .config import Config
    with open(path) as fobj:
        raw = json.load(fobj)
    if not isinstance(raw, dict):
        raise SystemExit(f'{path}: expected a JSON object of Config '
                         'fields')
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = sorted(set(raw) - fields - set(DERIVED_KEYS))
    if unknown:
        raise SystemExit(
            f'{path}: unknown Config field(s): {", ".join(unknown)}\n'
            f'valid fields: {", ".join(sorted(fields))}')
    # JSON turns tuples into lists
    return Config(**{k: tuple(v) if isinstance(v, list) else v
                     for k, v in raw.items() if k in fields})


def _cmd_run(args) -> int:
    from .simulator import Simulator
    config = _load_config(args.config)
    if not args.no_plots:
        # fail now, not after the solve, where the figures cannot be drawn
        import matplotlib.pyplot  # noqa: F401
    sim = Simulator(config, device=args.device)
    sim.simulate_tracks()
    sim.compute_presence_map()
    if not args.no_plots:
        sim.plot_terrain_features()
        sim.plot_simulated_tracks()
        sim.plot_presence_map()
    print(f'run complete: {sim.mode_data_dir}')
    return 0


def _cmd_info(args) -> int:
    import torch

    from . import __version__
    print(f'ssrs_tpu_torch {__version__}')
    print(f'torch {torch.__version__}')
    print(f'cuda {torch.version.cuda}')
    available = torch.cuda.is_available()
    print(f'cuda available: {available}')
    if available:
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            print(f'  cuda:{i} {props.name}, '
                  f'{props.total_memory / 2**30:.1f} GiB')
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='python -m ssrs_tpu_torch',
        description='stochastic soaring-raptor simulator on PyTorch/CUDA')
    sub = parser.add_subparsers(dest='command', required=True)

    p_run = sub.add_parser('run', help='run a simulation from a JSON '
                                       'config')
    p_run.add_argument('config', help='JSON file of Config fields')
    p_run.add_argument('--no-plots', action='store_true',
                       help='skip figure generation')
    p_run.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                       help='device of the run (default: cuda)')
    p_run.set_defaults(fn=_cmd_run)

    p_info = sub.add_parser('info', help='report versions and devices')
    p_info.set_defaults(fn=_cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    sys.exit(main())
