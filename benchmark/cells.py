"""Discovery by name: the cells, configurations, traffic mixes, limits and
metric readers that ``BENCHMARK.json`` names.

A later change adds a configuration, a mix, a cell or a metric by adding
files and entries; nothing here lists them:

- ``BENCHMARK.json``'s ``configs[i].file``: the configuration's JSON, the
  ``Config`` fields of the program plus the harness's keys
  (:data:`HARNESS_KEYS`). A snapshot or seasonal configuration holds
  ``wtk_standin``, ``{"years": [...], "seed": n, "spacing_km": x}``: the
  WTK stand-in (``wtk.py``) that set-up writes and every job reads as its
  ``LOCAL`` source (the harness sets ``wtk_source``,
  ``wtk_local_template`` and ``wtk_local_years``); it states the mode's
  fields (``snapshot_datetime``, or ``seasonal_start``, ``seasonal_end``,
  ``seasonal_timeofday`` and ``seasonal_count``) and
  ``wtk_orographic_height``, ``wtk_thermal_height`` and
  ``wtk_interp_type`` (``linear``) itself;
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, read by the
  one generator in ``traffic.py``;
- ``benchmark/limits/<cell>.json``: the limits of the cell's comparison
  with the plain reference (``judge.py``);
- ``benchmark/metrics/<metric>.py``: a reader ``read(ctx)`` of the metric,
  which returns a number, or None where it finds nothing to read."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = 'benchmark'
# keys of a configuration file that are not the program's Config fields
HARNESS_KEYS = ('source', 'assumed', 'reduced', 'why', 'wind_directions',
                'wtk_standin')


def load_spec(root: str) -> dict:
    with open(os.path.join(root, 'BENCHMARK.json'), encoding='utf-8') as f:
        return json.load(f)


def _by_name(items, name: str, what: str) -> dict:
    for item in items:
        if item['name'] == name:
            return item
    raise KeyError(f'no {what} named {name!r} in BENCHMARK.json')


def find_cell(spec: dict, name: str) -> dict:
    return _by_name(spec['workloads'], name, 'workload')


def load_config(root: str, spec: dict, name: str) -> dict:
    entry = _by_name(spec['configs'], name, 'config')
    with open(os.path.join(root, entry['file']), encoding='utf-8') as f:
        return json.load(f)


def config_fields(doc: dict, field_names) -> dict:
    """The program's ``Config`` fields of a configuration file; any other
    key must be one of :data:`HARNESS_KEYS`."""
    unknown = set(doc) - set(field_names) - set(HARNESS_KEYS)
    if unknown:
        raise KeyError(f'configuration keys that are neither Config fields '
                       f'nor harness keys: {sorted(unknown)}')
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in doc.items() if k in field_names}


def load_traffic(root: str, name: str) -> dict:
    with open(os.path.join(root, BENCH_DIR, 'traffic', f'{name}.json'),
              encoding='utf-8') as f:
        return json.load(f)


def load_limits(root: str, cell: str) -> dict:
    with open(os.path.join(root, BENCH_DIR, 'limits', f'{cell}.json'),
              encoding='utf-8') as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on. A metric with a
    ``workloads`` key applies to the cells listed; a per-layer metric
    without one to every cell that reports the metric it moves."""
    def listed(m):
        return cell in m['workloads'] if 'workloads' in m else None

    e2e = [m for m in spec['end_to_end'] if listed(m) in (True, None)]
    if not trace:
        return e2e
    moved = {m['name'] for m in e2e}
    return [m for m in spec['per_layer']
            if listed(m) or (listed(m) is None and m['moves'] in moved)]


def metric_reader(root: str, name: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<name>.py``."""
    path = os.path.join(root, BENCH_DIR, 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'benchmark_metric_{name.replace(".", "_").replace("-", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
