"""The one traffic generator: jobs of whole ``Simulator`` runs, closed
loop, one after another in one process.

Jobs run in a closed loop: an analyst waits for each result before
asking for the next. A mix (``benchmark/traffic/<name>.json``) sets:

- ``tracks_per_case``: the tracks of each wind case of a job
  (``Config.track_count``);
- ``share_potentials``: false, each job is a new ``Simulator`` in a run
  directory of its own that holds the region's raster and no cached
  potential, so the job solves; true, set-up runs one job in the run
  directory ``shared``, which solves and caches the potentials there,
  and every job is a new ``Simulator`` in that directory, which finds
  them cached: an analyst re-running a solved wind rose with a new seed.

A configuration with ``wind_directions`` runs each job as a direction
sweep (``simulate_direction_sweep``), else as ``simulate_tracks``; every
job ends with ``compute_presence_map``. Each job's seed comes from the
run's ``--seed`` and the job's index, and its tracks start from the
first start draw of its ``Simulator``'s rng (after the seasonal
datetimes, in seasonal mode).

A configuration with ``wtk_standin`` (snapshot or seasonal mode) has
set-up write the WTK stand-in (``wtk.py``), one file a year, into the
run's directory, and every job's ``Config`` name it as its ``LOCAL``
source, read through the stand-in's ``h5py``-shaped reader, which is
``h5py`` from set-up to :meth:`Traffic.close`. A job in its own run
directory reads the archive anew, as a first run on a local WTK copy
does."""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import hashlib
import os
import shutil
import time

import numpy as np

from . import cells, terrain, wtk


def job_seed(seed: int, label) -> int:
    """A job's ``sim_seed``: 56 bits of sha256 of the run's seed and the
    job's label, so any whole ``--seed`` gives a valid, distinct one."""
    digest = hashlib.sha256(f'{int(seed)}/{label}'.encode()).digest()
    return int.from_bytes(digest[:7], 'little')


@dataclasses.dataclass
class Job:
    """One job: its label, seed, the start draw its tracks took
    (``(rng seed, index of the draw among the run's start draws)``: in
    seasonal mode the start draws follow the datetimes' draws),
    wall-clock span, the ``Simulator``'s phase records of it and where its
    outputs are."""
    label: object
    seed: int
    draw: tuple
    start: float
    end: float
    records: list
    data_dir: str            # orographs and potentials
    out_dir: str             # counts and summary
    cases: list
    failed: str = ''

    @property
    def wall(self) -> float:
        return self.end - self.start

    def counts_path(self, case: str) -> str:
        return _one(os.path.join(self.out_dir, f'{case}_*_counts.npy'))

    def summary_path(self) -> str:
        return os.path.join(self.out_dir, 'summary_presence.npy')

    def orograph_path(self, case: str) -> str:
        return os.path.join(self.data_dir, f'{case}_orograph.npy')

    def potential_path(self, case: str) -> str:
        return _one(os.path.join(self.data_dir, f'{case}_*_potential.npy'))


def _load(path: str, device, dtype=None):
    """A saved array as a tensor on ``device`` (float32 by default)."""
    import torch
    return torch.as_tensor(np.load(path), dtype=dtype or torch.float32,
                           device=device)


def _one(pattern: str) -> str:
    found = glob.glob(pattern)
    if len(found) != 1:
        raise FileNotFoundError(f'{len(found)} files match {pattern}')
    return found[0]


class Traffic:
    """The jobs of one mix on one configuration, in ``workdir``, on
    ``device``. The program's printing goes to ``workdir/program.log``."""

    def __init__(self, cfg_doc: dict, mix: dict, seed: int, workdir: str,
                 device):
        from ssrs_tpu_torch import Config
        names = [f.name for f in dataclasses.fields(Config)]
        self.fields = cells.config_fields(cfg_doc, names)
        self.dirns = cfg_doc.get('wind_directions')
        self.cfg = cfg_doc
        self.standin = cfg_doc.get('wtk_standin')
        self.tracks = int(mix['tracks_per_case'])
        self.shared = bool(mix['share_potentials'])
        self.seed = int(seed)
        self.workdir = workdir
        self.device = device
        self.log = open(os.path.join(workdir, 'program.log'), 'a',
                        encoding='utf-8')
        self.sim = None
        self._context = contextlib.ExitStack()
        self.wtk_kw = {}

    def close(self) -> None:
        self.sim = None
        self._context.close()
        self.log.close()

    @contextlib.contextmanager
    def _quiet(self):
        with contextlib.redirect_stdout(self.log):
            yield

    def _simulator(self, run_name: str, sim_seed: int):
        from ssrs_tpu_torch import Config, Simulator
        data = os.path.join(self.workdir, run_name, 'data')
        if not os.path.isdir(data):
            os.makedirs(data)
            os.link(self.raster, os.path.join(data, 'srtm1.tif'))
        cfg = Config(**self.fields, **self.wtk_kw, sim_seed=sim_seed,
                     track_count=self.tracks, out_dir=self.workdir,
                     run_name=run_name)
        return Simulator(cfg, device=self.device)

    def _write_standin(self) -> None:
        """One stand-in file a year of ``wtk_standin`` in the run's
        directory, its reader installed as ``h5py``, and the jobs'
        ``LOCAL`` source pointed at them."""
        lonlat = terrain.region(self.cfg)[2]
        lat, lon = wtk.sites(lonlat, float(self.standin['spacing_km']),
                             int(self.standin['seed']))
        years = [int(y) for y in self.standin['years']]
        os.makedirs(os.path.join(self.workdir, 'wtk'))
        template = os.path.join(self.workdir, 'wtk', 'standin_$YEAR.wtk')
        for year in years:
            wtk.write(template.replace('$YEAR', str(year)), lat, lon,
                      wtk.year_hours(year), wtk.layer_names(self.cfg))
        self._context.enter_context(wtk.reader_installed())
        self.wtk_kw = dict(wtk_source='LOCAL', wtk_local_template=template,
                           wtk_local_years=tuple(years))

    def _body(self, sim) -> None:
        if self.dirns:
            sim.simulate_direction_sweep([float(d) for d in self.dirns])
        else:
            sim.simulate_tracks()
        sim.compute_presence_map()

    def setup(self) -> None:
        """The region's DEM as a saved SRTM raster and, with
        ``wtk_standin``, the WTK stand-in, then, untimed, at the window's
        shapes: with shared potentials the job that solves and caches them
        and one that finds them cached, else one job, discarded."""
        self.dem, self.dem_bounds = terrain.make_dem(self.fields)
        os.makedirs(os.path.join(self.workdir, 'raster'))
        self.raster = os.path.join(self.workdir, 'raster', 'srtm1.tif')
        terrain.write_dem_tiff(self.raster, self.dem, self.dem_bounds)
        if self.standin:
            self._write_standin()
        for label in ('setup', 'warmup') if self.shared else ('warmup',):
            warm = self.job(label)
            shutil.rmtree(os.path.join(self.workdir, f'job{label}'))
            if warm.failed:
                raise RuntimeError(f'the {label} job failed:\n{warm.failed}')

    def job(self, label) -> Job:
        """Run one job; a job that raises is returned with ``failed`` set
        to its traceback."""
        import traceback
        seed = job_seed(self.seed, label)
        out = os.path.join(self.workdir, f'job{label}')
        failed = ''
        records = []
        start = time.perf_counter()
        try:
            with self._quiet():
                sim = self.sim = self._simulator(
                    'shared' if self.shared else f'job{label}', seed)
                self._body(sim)
                records = sim.timer.records
        except Exception:  # a failed job is counted, and the loop goes on
            failed = traceback.format_exc()
        end = time.perf_counter()
        draw = (seed, 0)
        if failed:
            return Job(label, seed, draw, start, end, records, '', '', [],
                       failed)
        data = sim.mode_data_dir
        if self.shared:
            os.makedirs(out)
            for path in glob.glob(os.path.join(data, '*_counts.npy')) + [
                    os.path.join(data, 'summary_presence.npy')]:
                os.replace(path, os.path.join(out, os.path.basename(path)))
        else:
            out = data
        return Job(label, seed, draw, start, end, records, data, out,
                   list(sim.case_ids))

    # ---- the program's outputs, read after the window ----------------------

    def outputs(self, job: Job, device, counts: bool = True):
        """The job's outputs as tensors on ``device``: per case its
        thresholded updraft (the program's threshold of its saved
        orograph), potential and, with ``counts``, its counts, and the
        summary map."""
        fields = {c: self.case_fields(job, c, device) for c in job.cases}
        out = {'thresholded': {c: f[0] for c, f in fields.items()},
               'potential': {c: f[1] for c, f in fields.items()}}
        if counts:
            out['counts'] = {c: self.case_counts(job, c, device)
                             for c in job.cases}
            out['summary'] = self.summary(job, device)
        return out

    def case_fields(self, job: Job, case: str, device):
        """(thresholded updraft, potential) of one case of the job, float32
        on ``device``."""
        from ssrs_tpu_torch.fields import get_above_threshold_speed
        thr = float(self.fields['updraft_threshold'])
        return (get_above_threshold_speed(
            _load(job.orograph_path(case), device), thr),
            _load(job.potential_path(case), device))

    def case_counts(self, job: Job, case: str, device):
        """The counts of one case of the job, float64 on ``device``."""
        import torch
        return _load(job.counts_path(case), device, torch.float64)

    def summary(self, job: Job, device):
        """The job's summary map, float64 on ``device``."""
        import torch
        return _load(job.summary_path(), device, torch.float64)

    def drop_outputs(self, job: Job, cases=None, summary: bool = True):
        """Delete the job's counts of ``cases`` (all, by default) and, with
        ``summary``, its summary, which no check reads, so that they leave
        the disk before they are written back to it."""
        paths = [p for c in (['*'] if cases is None else cases)
                 for p in glob.glob(os.path.join(job.out_dir,
                                                 f'{c}_*_counts.npy'))]
        for path in paths + ([job.summary_path()] if summary else []):
            with contextlib.suppress(FileNotFoundError):
                os.remove(path)

    def useful_steps(self, job: Job) -> int:
        """Agent-steps that moved a track: the presence mass of each case
        minus its starts."""
        return sum(int(np.load(job.counts_path(c)).sum(dtype=np.int64))
                   - self.tracks for c in job.cases)
