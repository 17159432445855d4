"""The ``Simulator`` facade of the port.

The PyTorch counterpart of ``ssrs_tpu/simulator.py``: uniform, snapshot
and seasonal mode (the last two from WindToolKit winds, interpolated to
the grid by a plan built once on the host and applied on the run's
device, ``fields/interp.py``), the ``fluidflow`` run, with the directional
potential from the refined solver on the run's device
(``potential_solver='auto'``, the default, or ``'refined'``), from the
host float64 direct solve (``'direct'``, ``'dense'``) or from the legacy
multigrid (``'mg'``, ``'multigrid'``), and the directed
random walk (``'drw'``, no potential); thermal realizations
(``thermals_realization_count``); the wind-direction sweep
(``simulate_direction_sweep``); recorded trajectories for runs up to
``track_pkl_budget`` tracks (the default ``track_count``) and presence
counts alone above, where several (case, realization) populations go
through the interleaved multi-case driver; the turbines of the USWTDB and
their presence scores (``get_turbine_presence``). It keeps the JAX
package's constructor flow (region -> terrain -> turbines -> wind ->
updraft fields), its output-directory layout and its artifact names and
formats (``turbines.csv``, ``wtk_locations.csv``, ``y..._wtk.csv``,
``*_orograph.npy``, ``*_thermals.npy``, ``*_potential.npy``,
``*_tracks.pkl``, ``*_counts.npy``, ``summary_presence.npy``,
``phase_timings.json``), so one package's cached files feed the other;
and the reference's figures (``plotting.py``), drawn with matplotlib where
it is installed.

On several devices (``Simulator(device=[...], mesh_devices=n)``) a
counts-only run shards its agents over the mesh (``_run_large``,
``parallel/mesh.py``) and the multi-case driver spreads its cases over
it; recorded runs, the fields and the solves stay on the first device.

The multi-case prep can solve its potentials in batches
(``potential_batch > 1``, ``potential/lap.py``'s
``solve_potential_refined_batch``); ``potential_solver='mg'`` is the JAX
package's legacy multigrid; ``track_tail_bucket='auto'`` its self-tuned
end of compaction. The JAX package's engine knobs (``track_step_impl``
``'xla'`` or ``'pallas'``, ``track_presence_impl`` other than ``'auto'``)
raise ``NotImplementedError``: the port has one engine.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import asdict
from datetime import datetime
from typing import List, Tuple

import numpy as np
import torch

from .config import Config
from .core.grid import Grid
from .core.rng import case_generator, case_seed
from .core.timing import PhaseTimer, elapsed_str
from .agents.presence import card_or_raise, compute_presence_counts
from .agents.moves import directional_probs
from .agents.simulate import (TrackParams, prepared_weights_batch,
                              simulate_presence_cases_compacting,
                              simulate_presence_compacting,
                              simulate_tracks_recorded)
from .agents.starts import get_starting_indices
from .data import (Terrain, TurbinesUSWTB, get_raster_in_projected_crs,
                   transform_bounds, transform_coordinates)
from .fields import (compute_orographic_updraft,
                     compute_slope_aspect_degrees, compute_thermals,
                     get_above_threshold_speed)
from .fields.interp import InterpPlan, speed_and_direction
from .parallel.mesh import make_mesh, simulate_presence_sharded_compacting
from .plotting import PlottingMixin
from .potential.boundary import boundary_masks
from .potential.direct import fallback_cost_estimate, solve_potential_direct
from .utils import get_seasonal_datetimes_list, makedir_if_not_exists


def _check_slice(cfg: Config) -> None:
    """Raise ValueError for an unknown solver, and NotImplementedError for
    the JAX package's engine knobs, which select a TPU implementation of
    the same function (the port has one engine)."""
    solver = (cfg.potential_solver or 'auto').lower()
    if solver not in ('auto', 'refined', 'direct', 'dense', 'mg',
                      'multigrid'):
        raise ValueError(
            f'potential_solver={cfg.potential_solver!r}: expected auto, '
            'refined, direct, dense, mg or multigrid')
    if str(cfg.track_step_impl) not in ('auto', 'fused') or \
            str(cfg.track_presence_impl) != 'auto':
        raise NotImplementedError(
            f'track_step_impl={cfg.track_step_impl!r}, track_presence_impl='
            f'{cfg.track_presence_impl!r}: the port has one engine (the '
            "fused step kernel); only 'auto' (or 'fused') is accepted")


def _devices(device) -> List[torch.device]:
    """The ``Simulator``'s devices: ``device`` as a list. ``'cuda'`` with
    no index is every visible card (and raises without one); a sequence
    may repeat a device."""
    if isinstance(device, (str, torch.device)):
        device = card_or_raise(device, 'Simulator')
        if device.type == 'cuda' and device.index is None:
            return [torch.device('cuda', i)
                    for i in range(torch.cuda.device_count())]
        return [device]
    return [card_or_raise(d, 'Simulator') for d in device]


class Simulator(PlottingMixin, Config):
    """SSRS simulation orchestrator (reference: ssrs/simulator.py:34).

    ``device``: one PyTorch device or a sequence of them (default
    ``'cuda'``: every visible card). The first is the run's device: the
    fields, the solves and the recorded runs. The mesh (``self.mesh``) is
    the first ``Config.mesh_devices`` of them (0: all), as
    ``jax.devices()[:n]`` is in the JAX package: a counts-only run shards
    its agents over it and the multi-case driver spreads its cases over
    it when it has more than one entry. A sequence may repeat a device."""

    lonlat_crs = 'EPSG:4326'
    time_format = 'y%Ym%md%dh%H'

    def __init__(self, in_config: Config = None, device='cuda',
                 **kwargs) -> None:
        devices = _devices(device)
        self.timer = PhaseTimer(device=devices[0])
        with self.timer.span('init'):
            self._construct(in_config, devices, kwargs)

    def _construct(self, in_config, devices, kwargs) -> None:
        """The construction (ssrs/simulator.py:36-142), inside the
        ``init`` span."""
        if in_config is None:
            super().__init__(**kwargs)
        else:
            super().__init__(**asdict(in_config))
        _check_slice(self)
        self.device = devices[0]
        self.mesh = make_mesh(int(self.mesh_devices), devices)
        print(f'\n---- SSRS (PyTorch, {self.device}, mesh of '
              f'{len(self.mesh)}) in {self.sim_mode} mode')
        print(f'Run name: {self.run_name}')

        self._rng = np.random.default_rng(
            self.sim_seed if self.sim_seed >= 0 else None)
        if self.sim_seed >= 0:
            print('Specified random number seed:', self.sim_seed)

        # directories (ssrs/simulator.py:54-61)
        print(f'Output dir: {os.path.join(self.out_dir, self.run_name)}')
        self.data_dir = os.path.join(self.out_dir, self.run_name, 'data/')
        self.fig_dir = os.path.join(self.out_dir, self.run_name, 'figs/')
        self.mode_data_dir = os.path.join(self.data_dir, self.sim_mode)
        self.mode_fig_dir = os.path.join(self.fig_dir, self.sim_mode)
        for dirname in (self.mode_data_dir, self.mode_fig_dir):
            makedir_if_not_exists(dirname)

        # config dump (ssrs/simulator.py:63-67)
        fpath = os.path.join(self.out_dir, self.run_name,
                             f'{self.run_name}.json')
        with self.timer.span('save.config'), \
                open(fpath, 'w', encoding='utf-8') as cfile:
            json.dump({k: v for k, v in self.__dict__.items()
                       if not k.startswith('_') and _jsonable(v)},
                      cfile, ensure_ascii=False, indent=2, default=str)

        # grid geometry (ssrs/simulator.py:69-85)
        print(f'Terrain resolution = {self.resolution} m')
        proj_west, proj_south = transform_coordinates(
            self.lonlat_crs, self.projected_crs,
            self.southwest_lonlat[0], self.southwest_lonlat[1])
        self.grid = Grid.from_region(
            tuple(self.region_width_km), self.resolution,
            (float(np.asarray(proj_west).ravel()[0]),
             float(np.asarray(proj_south).ravel()[0])))
        self.gridsize = self.grid.shape
        print(f'Terrain grid size = {self.gridsize}')
        self.bounds = self.grid.bounds
        self.extent = self.grid.extent
        self.lonlat_bounds = transform_bounds(
            self.bounds, self.projected_crs, self.lonlat_crs)

        # terrain layers (ssrs/simulator.py:87-99), with the offline
        # synthetic fallback appended to the reference's 3DEP->SRTM chain
        self.region = Terrain(self.lonlat_bounds, self.data_dir)
        self._terrain_rasters = {}  # reprojected layers, by raster path
        with self.timer.phase('terrain'):
            self._setup_terrain()

        # turbines (ssrs/simulator.py:101-105)
        turbine_fpath = os.path.join(self.mode_data_dir, 'turbines.csv')
        with self.timer.phase('turbines'):
            self.turbines = TurbinesUSWTB(
                self.bounds, self.projected_crs,
                self.turbine_minimum_hubheight, turbine_fpath,
                self.print_verbose)

        # WTK layer names (ssrs/simulator.py:107-115)
        self.wtk_layers = {
            'wspeed': f'windspeed_{int(self.wtk_orographic_height)}m',
            'wdirn': f'winddirection_{int(self.wtk_orographic_height)}m',
            'pressure': f'pressure_{int(self.wtk_thermal_height)}m',
            'temperature': f'temperature_{int(self.wtk_thermal_height)}m',
            'blheight': 'boundary_layer_height',
            'surfheatflux': 'surface_heat_flux',
        }

        # the WTK sites' interpolation plan (_wtk_interp_plan)
        self._wtk_plan = None

        # mode dispatch (ssrs/simulator.py:117-133)
        if self.sim_mode.lower() != 'uniform':
            from .data import WTK
            wtk_kw = {}
            if self.wtk_source == 'LOCAL':
                wtk_kw = dict(local_template=self.wtk_local_template,
                              local_years=list(self.wtk_local_years))
            self.wtk = WTK(self.wtk_source, self.lonlat_bounds,
                           list(self.wtk_layers.values()),
                           self.mode_data_dir, **wtk_kw)
            if self.sim_mode.lower() == 'seasonal':
                # from the run's rng, before the starts draw from it
                self.dtimes = self.get_seasonal_datetimes()
            elif self.sim_mode.lower() == 'snapshot':
                self.dtimes = [datetime(*self.snapshot_datetime)]
            with self.timer.phase('wtk_download', cases=len(self.dtimes)):
                self.wtk.download_data(self.dtimes, self.max_cores)
            self.case_ids = [dt.strftime(self.time_format)
                             for dt in self.dtimes]
            with self.timer.phase('updrafts', cases=len(self.dtimes)):
                self.compute_orographic_updrafts_using_wtk()
        else:
            print(f'Uniform mode: Wind speed = {self.uniform_windspeed} m/s')
            print(f'Uniform mode: Wind dirn = {self.uniform_winddirn} '
                  'deg(cw)')
            self.case_ids = [self._get_uniform_id()]
            with self.timer.phase('updrafts'):
                self.compute_orographic_updraft_uniform()
        with self.timer.phase('thermals', realizations=int(
                self.thermals_realization_count)):
            for case_id in self.case_ids:
                self.compute_thermal_updrafts(case_id)

        # plotting settings (ssrs/simulator.py:138-142)
        fig_aspect = self.region_width_km[0] / self.region_width_km[1]
        self.fig_size = (self.fig_height * fig_aspect, self.fig_height)
        self.km_bar = min([1, 5, 10], key=lambda x: abs(
            x - self.region_width_km[0] // 4))
        print('SSRS Simulator initiation done.')

    # ---- terrain ---------------------------------------------------------

    def _setup_terrain(self):
        """3DEP -> SRTM -> synthetic source chain
        (ssrs/simulator.py:87-99 + offline fallback)."""
        try:
            self.terrain_layers = {
                'Elevation': 'DEM',
                'Slope': 'Slope Degrees',
                'Aspect': 'Aspect Degrees',
            }
            self.region.download(list(self.terrain_layers.values()))
        except Exception:
            print('Connection issues with 3DEP WMS service! Trying SRTM1..')
            try:
                self.terrain_layers = {'Elevation': 'SRTM1'}
                self.region.download(list(self.terrain_layers.values()))
            except Exception:
                print('SRTM unavailable too! Using synthetic terrain '
                      '(offline mode).')
                self.terrain_layers = {'Elevation': 'SYNTHETIC'}
                self.region.download(list(self.terrain_layers.values()))

    def get_terrain_layer(self, lname: str) -> np.ndarray:
        """A terrain layer on the run grid (float64, lower-left origin).
        Each raster is reprojected once a ``Simulator`` (on the host: ~30 s
        at 6667x6667, PERF.md); later calls return a copy."""
        fpath = self.region.get_raster_fpath(self.terrain_layers[lname])
        if fpath not in self._terrain_rasters:
            with self.timer.span('terrain.reproject'):
                self._terrain_rasters[fpath] = get_raster_in_projected_crs(
                    fpath, self.bounds, self.gridsize, self.resolution,
                    self.projected_crs)
        return self._terrain_rasters[fpath].copy()

    def get_terrain_elevation(self) -> np.ndarray:
        return self.get_terrain_layer('Elevation')

    def _slope_aspect(self):
        """(slope, aspect) in degrees, float32 tensors on the run's device:
        the source's ``Slope`` and ``Aspect`` layers where it has them
        (3DEP), else the Horn stencil on the DEM
        (ssrs/simulator.py:152-159). The uniform and the WTK updrafts,
        the thermal fields and the sweep all read these."""
        horn = None
        out = []
        for i, lname in enumerate(('Slope', 'Aspect')):
            try:
                layer = torch.from_numpy(self.get_terrain_layer(
                    lname).astype(np.float32)).to(self.device)
            except Exception:
                if horn is None:
                    # float32, as the JAX package computes with 64-bit
                    # types off
                    elev = torch.from_numpy(self.get_terrain_elevation()
                                            .astype(np.float32))
                    horn = compute_slope_aspect_degrees(
                        elev.to(self.device), self.resolution)
                layer = horn[i]
            out.append(layer)
        return tuple(out)

    def get_terrain_slope(self) -> np.ndarray:
        """Slope layer, or Horn-stencil recompute from the DEM
        (ssrs/simulator.py:152-159)."""
        return self._slope_aspect()[0].cpu().numpy()

    def get_terrain_aspect(self) -> np.ndarray:
        return self._slope_aspect()[1].cpu().numpy()

    def get_terrain_grid(self):
        """(xgrid, ygrid) (ssrs/simulator.py:177-185)."""
        return self.grid.xy_grid()

    # ---- updrafts --------------------------------------------------------

    def _orograph(self, slope, aspect, winddirn: float) -> torch.Tensor:
        """Uniform-wind orographic updraft for one wind direction."""
        return compute_orographic_updraft(
            torch.full(self.gridsize, float(self.uniform_windspeed),
                       dtype=torch.float32, device=self.device),
            torch.full(self.gridsize, float(winddirn),
                       dtype=torch.float32, device=self.device),
            slope, aspect)

    def compute_orographic_updraft_uniform(self) -> None:
        """Uniform-mode orographic updraft (ssrs/simulator.py:189-198)."""
        print('Computing orographic updrafts..')
        slope, aspect = self._slope_aspect()
        orograph = self._orograph(slope, aspect, self.uniform_winddirn)
        fname = self._get_orograph_fname(self.case_ids[0],
                                         self.mode_data_dir)
        self._save('orographs', f'{fname}.npy',
                   orograph.cpu().numpy().astype(np.float32))

    def compute_orographic_updrafts_using_wtk(self) -> None:
        """Per-datetime WTK-interpolated updrafts
        (ssrs/simulator.py:200-215): each case's winds are read from the
        WTK cache and interpolated to the grid (the plan of
        :meth:`_wtk_interp_plan`, built at the first case), the
        updraft is computed on the run's device and saved as
        ``{case}_orograph.npy``. One ``wtk_frame`` and one ``wtk_interp``
        phase record a case."""
        print('Computing orographic updrafts..', end='')
        slope, aspect = self._slope_aspect()
        start_time = time.time()
        for dtime, case_id in zip(self.dtimes, self.case_ids):
            with self.timer.phase('wtk_frame', id=case_id):
                wtk_df = self.wtk.get_dataframe_for_this_time(dtime)
            with self.timer.phase('wtk_interp', id=case_id):
                wspeed, wdirn = self._get_interpolated_wind_conditions(
                    wtk_df[self.wtk_layers['wspeed']],
                    wtk_df[self.wtk_layers['wdirn']])
            orograph = compute_orographic_updraft(
                torch.from_numpy(wspeed.astype(np.float32)).to(self.device),
                torch.from_numpy(wdirn.astype(np.float32)).to(self.device),
                slope, aspect)
            fname = self._get_orograph_fname(case_id, self.mode_data_dir)
            self._save('orographs', f'{fname}.npy',
                       orograph.cpu().numpy().astype(np.float32))
        print(f'took {elapsed_str(start_time)}', flush=True)

    def compute_thermal_updrafts(self, case_id: str) -> None:
        """Thermal realizations (ssrs/simulator.py:217-228), each from
        its own generator of the seed hierarchy, saved as
        ``{case}_r{real}_thermals.npy``."""
        if self.thermals_realization_count > 0:
            print('Computing thermal updrafts...', flush=True)
            aspect = self._slope_aspect()[1]
            for real_id in range(self.thermals_realization_count):
                gen = case_generator(self.sim_seed, case_id, real_id,
                                     'thermals', self.device)
                thermals = compute_thermals(gen, aspect, 2.0)
                fname = self._get_thermal_fname(case_id, real_id,
                                                self.mode_data_dir)
                np.save(f'{fname}.npy',
                        thermals.cpu().numpy().astype(np.float32))
        else:
            print('No thermals requested!', flush=True)

    def load_updrafts(self, case_id: str, apply_threshold: bool = True,
                      device: bool = True) -> list:
        """Orographic [+ thermal] updrafts of a case, optionally
        thresholded (ssrs/simulator.py:230-243): the orograph, then the
        orograph plus each thermal realization. The threshold runs on the
        run's device either way; ``device=True`` returns the fields as
        tensors there, ``device=False`` as numpy arrays (the
        host-materialized prep of ``Config.fields_device=False``)."""
        fname = self._get_orograph_fname(case_id, self.mode_data_dir)
        orograph = np.load(f'{fname}.npy')
        updrafts = [orograph]
        for real_id in range(int(self.thermals_realization_count)):
            fname = self._get_thermal_fname(case_id, real_id,
                                            self.mode_data_dir)
            updrafts.append(orograph + np.load(f'{fname}.npy'))
        updrafts = [torch.from_numpy(ix).to(self.device) for ix in updrafts]
        if apply_threshold:
            updrafts = [get_above_threshold_speed(ix, self.updraft_threshold)
                        for ix in updrafts]
        return updrafts if device else [ix.cpu().numpy() for ix in updrafts]

    def _get_orograph_fname(self, case_id: str, dirname: str = './'):
        return os.path.join(dirname, f'{case_id}_orograph')

    def _get_thermal_fname(self, case_id: str, real_id: int,
                           dirname: str = './'):
        return os.path.join(dirname, f'{case_id}_r{real_id}_thermals')

    # ---- directional potential ------------------------------------------

    def get_directional_potential(self, updraft, case_id,
                                  real_id) -> np.ndarray:
        """Cached directional-potential solve
        (ssrs/simulator.py:259-288)."""
        return self.finish_directional_potential(
            self.begin_directional_potential(updraft, case_id, real_id))

    def _check_potential_cache(self, case_id, real_id):
        """Returns (cached-state-or-None, fname, id_str)."""
        fname = self._get_potential_fname(case_id, real_id,
                                          self.mode_data_dir)
        id_str = self._get_id_string(case_id, real_id)
        start_time = time.time()
        try:
            with self.timer.span('potential.load'):
                potential = np.load(f'{fname}.npy')
            if potential.shape != tuple(self.gridsize):
                raise FileNotFoundError
            if (self.sim_seed < 0) and (real_id != 0):
                raise FileNotFoundError
            print(f'{id_str}: Found saved potential')
            handle = ('done', potential, {
                **_solve_info('cache'), 'seconds': time.time() - start_time})
            return ('cached', handle, fname, id_str, start_time), fname, \
                id_str
        except FileNotFoundError:
            return None, fname, id_str

    def begin_directional_potential(self, updraft, case_id, real_id):
        """Cache check and solve for one (case, realization): returns an
        opaque handle for :meth:`finish_directional_potential`.

        The JAX package dispatches its solve asynchronously here, so that
        a multi-case prep overlaps the host work of case *i+1* with the
        device solve of case *i*. The port's refined solve is
        SYNCHRONOUS (its iteration reads its exit test on the host,
        ``potential/lap.py``), so nothing overlaps yet: the solve has run
        when this returns. The split, its order and the artifacts are
        kept for the solver that can overlap."""
        state, fname, id_str = self._check_potential_cache(case_id,
                                                           real_id)
        if state is not None:
            return state
        return self._solve_one(updraft, fname, id_str)

    def _solve_one(self, updraft, fname, id_str):
        """The handle of one uncached solve."""
        start_time = time.time()
        handle = self._begin_potential_solve(updraft)
        handle[-1]['seconds'] = time.time() - start_time
        return ('solve', handle, fname, id_str, start_time)

    def _potential_batch_cap(self) -> int:
        """How many uncached refined solves one batched solve may carry
        (``Config.potential_batch``: 0 = auto, which is off as in the JAX
        package; 1 = off; n > 1 = at most n, and at most what fits
        ``_BATCH_MEMORY_SHARE`` of the run's device's free memory at
        ``_BATCH_BYTES_PER_CELL`` a case). 1 for another solver than the
        refined one. The JAX package's envelope, 3.5e9 bytes at 200 a
        cell, is the TPU's."""
        pb = int(self.potential_batch)
        if pb <= 1 or (self.potential_solver or 'auto').lower() not in (
                'auto', 'refined'):
            return 1
        cells = int(np.prod(self.gridsize))
        budget = _BATCH_MEMORY_SHARE * _free_bytes(self.device)
        return max(1, min(pb, int(budget // (cells *
                                             _BATCH_BYTES_PER_CELL))))

    def begin_directional_potentials(self, items):
        """Multi-case prep: cache-check every ``(updraft, case_id,
        real_id)`` item and solve the uncached ones, one
        :meth:`finish_directional_potential` handle per item, in order.

        With a batch cap above 1 (:meth:`_potential_batch_cap`, rounded
        down to a power of two),
        the uncached items go in groups through
        ``solve_potential_refined_batch`` on the run's device, as in the
        JAX package (``ssrs_tpu/simulator.py:389-432``): a group holds
        the cap's or the next power of two at or above the items left,
        whichever is fewer, and a lone remainder takes the single solve.
        The port pads no group. Each item of a group finishes through its
        own handle and the residual net, so a case that stalls inside a
        batch falls back to the direct solve alone. Its ``potential``
        record adds ``batch`` (the group's size) and ``group_seconds``;
        its ``seconds`` are the group's wall over the group's size, so
        the records still sum to the prep's time."""
        cap = self._potential_batch_cap()
        if cap <= 1:
            return [self.begin_directional_potential(updraft, case_id,
                                                     real_id)
                    for updraft, case_id, real_id in items]
        cap = 1 << (cap.bit_length() - 1)
        states = [None] * len(items)
        todo = []
        for i, (updraft, case_id, real_id) in enumerate(items):
            state, fname, id_str = self._check_potential_cache(case_id,
                                                               real_id)
            if state is not None:
                states[i] = state
            else:
                todo.append((i, updraft, fname, id_str))
        pos = 0
        while pos < len(todo):
            n_left = len(todo) - pos
            if n_left == 1:
                i, updraft, fname, id_str = todo[pos]
                states[i] = self._solve_one(updraft, fname, id_str)
                break
            group = todo[pos:pos + min(cap, 1 << (n_left - 1).bit_length())]
            for (i, _, _, _), state in zip(group, self._solve_group(group)):
                states[i] = state
            pos += len(group)
        return states

    def _solve_group(self, group):
        """The handles of one batched refined solve of ``group``'s
        ``(index, updraft, fname, id_str)`` items. Within the fallback cap
        the cases that end above :data:`RESOLVE_TRIGGER` are solved again
        together, from their iterates (the first of :meth:`_resolve`'s
        re-solves, as one batch under one span ``potential.resolve``)."""
        from .potential import solve_potential_refined_batch
        start_time = time.time()
        conds = torch.stack([torch.as_tensor(g[1], dtype=torch.float32,
                                             device=self.device)
                             for g in group])
        bmask, bvals = boundary_masks(self.track_direction,
                                      tuple(self.gridsize))
        maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
            else 60
        stats = {}
        pots, rrels = solve_potential_refined_batch(
            conds, bmask, bvals, tol=float(self.potential_tol),
            maxcycles=maxiter, stats=stats)
        n = len(group)
        infos = [{**_solve_info('refined', rrel=float(rrels[j]),
                                passes=stats['passes'][j],
                                vcycles=stats['vcycles'][j]), 'batch': n}
                 for j in range(n)]
        rrels = [float(r) for r in rrels]
        cap = int(self.potential_fallback_max_unknowns)
        stalled = [j for j in range(n) if rrels[j] > RESOLVE_TRIGGER] \
            if cap <= 0 or int(np.prod(self.gridsize)) <= cap else []
        if stalled:
            with self.timer.span('potential.resolve', cases=len(stalled),
                                 warm=True):
                again, again_rrels = solve_potential_refined_batch(
                    conds[stalled], bmask, bvals,
                    tol=float(self.potential_tol), maxcycles=maxiter,
                    init=pots[stalled], depth=RESOLVE_GCR_K)
            for i, j in enumerate(stalled):
                pots[j] = again[i]
                rrels[j] = float(again_rrels[i])
                infos[j].update(resolves=1, resolve_rrel=rrels[j])
        wall = time.time() - start_time
        return [('solve', ('refined', (conds[j], pots[j], rrels[j]),
                           {**infos[j], 'group_seconds': wall,
                            'seconds': wall / n}),
                 fname, id_str, start_time)
                for j, (_, _, fname, id_str) in enumerate(group)]

    def finish_directional_potential(self, state) -> np.ndarray:
        """Materialize a :meth:`begin_directional_potential` handle: read
        the residual, apply the float64-fallback policy, save the
        artifact."""
        return self._finish_directional_potential_pair(state)[0]

    def _finish_directional_potential_pair(self, state):
        """finish_directional_potential, returning ``(host, device)``: the
        host array backs the ``.npy`` artifact; the device tensor (None
        for cached and fallback results) lets the weight-table build use
        the solver's own output. Appends the item's ``potential`` phase
        record: the seconds of its solve and of this call, and the
        solver's ``solver``, ``rrel``, ``fallback``, ``passes`` and
        ``vcycles`` (``solver`` is ``'refined'``, ``'direct'`` or
        ``'cache'``)."""
        kind, handle, fname, id_str, start_time = state
        t0 = time.time()
        potential, dev = self._finish_potential_solve_pair(handle)
        if kind != 'cached':
            print(f'{id_str}: Computing potential..'
                  f'took {elapsed_str(start_time)}', flush=True)
            self._save('potential', f'{fname}.npy',
                       potential.astype(np.float32))
        if np.isnan(potential).any():
            print('NANs found in potential!')
        info = dict(handle[-1])
        self.timer.add('potential',
                       info.pop('seconds', 0.) + time.time() - t0,
                       start_time * 1e9, id=id_str, **info)
        return potential, dev

    def _device_fields_fit(self, n_fields: int) -> bool:
        """Whether the device-resident prep (Config.fields_device) may
        park ``n_fields`` conductivities AND potentials on the card for
        the whole prep; past the guard the host-materialized flow runs
        instead. The guard is the JAX package's: never beyond 4096^2
        cells, and at most ~1.5 GB resident (2 float32 fields a case)."""
        if not bool(self.fields_device):
            return False
        cells = int(np.prod(self.gridsize))
        if cells > _LARGE_GRID_CELLS:
            return False
        return cells * max(1, n_fields) * 8 <= 1_500_000_000

    def _prepare_potentials(self, items, pairs: bool = False):
        """Potentials for a list of ``(case_id, real_id, updraft)`` work
        items, in order, through :meth:`begin_directional_potentials` and
        finish in windows: of ``4 * cap`` items where batched solves apply
        (the refined solver, a batch cap above 1 and more than one item,
        as in ``ssrs_tpu/simulator.py:496-506``), else of the JAX
        package's bounded finish depth (3, or 1 past 4096^2). At most a
        window's unfinished solves are held at once.

        With ``pairs=True`` every element is ``(host, device-or-None)``
        (see :meth:`_finish_directional_potential_pair`); otherwise
        plain host arrays."""
        finish = (self._finish_directional_potential_pair if pairs
                  else self.finish_directional_potential)
        out = []
        depth = 3 if int(np.prod(self.gridsize)) <= _LARGE_GRID_CELLS \
            else 1
        cap = self._potential_batch_cap()
        if cap > 1 and len(items) > 1:
            depth = 4 * cap
        for w0 in range(0, len(items), depth):
            handles = self.begin_directional_potentials(
                [(upd, cid, rid) for cid, rid, upd in items[w0:w0 + depth]])
            out.extend(finish(handle) for handle in handles)
        return out

    def _solve_potential(self, conductivity) -> np.ndarray:
        return self._finish_potential_solve_pair(
            self._begin_potential_solve(conductivity))[0]

    def _begin_potential_solve(self, conductivity):
        """Run one potential solve of a conductivity (tensor or numpy);
        returns the handle :meth:`_finish_potential_solve_pair` reads,
        ``(kind, payload, info)``. ``'auto'`` is the refined solver on the
        run's device (the JAX package's default); ``'direct'`` and
        ``'dense'`` the host float64 solve; ``'mg'`` and ``'multigrid'``
        the legacy multigrid on the run's device, at most
        ``potential_maxiter`` V-cycles (<= 0: 200), which takes no
        residual net (``ssrs_tpu/simulator.py:539-546``)."""
        solver = (self.potential_solver or 'auto').lower()
        cond = torch.as_tensor(conductivity, dtype=torch.float32,
                               device=self.device)
        if solver in ('direct', 'dense'):
            return ('done', solve_potential_direct(cond.cpu().numpy(),
                                                   self.track_direction),
                    _solve_info('direct'))
        if solver in ('mg', 'multigrid'):
            from .potential import solve_potential_for_direction
            maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
                else 200
            stats = {}
            pot, resid = solve_potential_for_direction(
                cond, self.track_direction, tol=float(self.potential_tol),
                maxiter=maxiter, stats=stats)
            return ('done', pot.cpu().numpy(),
                    {**_solve_info('mg', **stats), 'residual_norm': resid})
        from .potential import solve_potential_refined
        bmask, bvals = boundary_masks(self.track_direction,
                                      tuple(self.gridsize))
        maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
            else 60
        stats = {}
        pot, resid = solve_potential_refined(
            cond, bmask, bvals, tol=float(self.potential_tol),
            maxcycles=maxiter, stats=stats)
        return ('refined', (cond, pot, resid),
                _solve_info('refined', rrel=float(resid), **stats))

    def _finish_potential_solve_pair(self, handle):
        """(host potential, device potential or None) of a
        :meth:`_begin_potential_solve` handle, through the port's solve
        policy.

        On a grid within ``Config.potential_fallback_max_unknowns``
        (<= 0 lifts the cap), where the host float64 direct solve can
        answer, a refined solve whose scaled relative residual ends above
        :data:`RESOLVE_TRIGGER` is solved again on the run's device, from
        its own iterate and, failing that, from the cold start
        (:meth:`_resolve`); a re-solve is kept if it ends at or under the
        trigger, else the direct solve replaces it. The JAX package keeps
        every solve under its 5e-3 net (ssrs_tpu/simulator.py:563-612).
        Past the cap the net is the JAX package's: a solve above 5e-3
        raises instead of buying an hours-long host solve. The handle's
        info counts ``resolves`` (0 to 2) and ``fallbacks`` and records
        the last re-solve's ``resolve_rrel``; ``rrel``, ``passes`` and
        ``vcycles`` stay the first solve's."""
        kind, payload, info = handle
        if kind == 'done':
            return payload, None
        conductivity, pot, resid = payload
        unknowns = int(np.prod(self.gridsize))
        cap = int(self.potential_fallback_max_unknowns)
        if cap <= 0 or unknowns <= cap:
            if float(resid) > RESOLVE_TRIGGER:
                pot, resid = self._resolve(conductivity, pot, info)
            if float(resid) <= RESOLVE_TRIGGER:
                return pot.cpu().numpy(), pot
        elif float(resid) <= 5e-3:
            return pot.cpu().numpy(), pot
        est_s, est_gb = fallback_cost_estimate(unknowns)
        if cap > 0 and unknowns > cap:
            raise RuntimeError(
                f'device potential solve stalled (rrel '
                f'{float(resid):.2e}) on a {self.gridsize[0]}x'
                f'{self.gridsize[1]} grid, and the f64 direct '
                f'fallback at {unknowns} unknowns is estimated at '
                f'~{est_s / 60:.0f} min / ~{est_gb:.0f} GB, and fails '
                'outright near 4096^2 (SuperLU int32 fill-in limit). '
                'Raise Config.potential_fallback_max_unknowns to '
                "attempt it anyway, or set potential_solver='direct' "
                'to run it deliberately.')
        print(f'device potential solve stalled (rrel '
              f'{float(resid):.2e}); falling back to the f64 '
              f'direct solver (estimated ~{est_s:.0f} s / '
              f'~{est_gb:.1f} GB at {unknowns} unknowns)..',
              flush=True)
        info['fallback'] = True
        info['fallbacks'] = 1
        return solve_potential_direct(conductivity.cpu().numpy(),
                                      self.track_direction), None

    def _resolve(self, conductivity, stalled, info):
        """(potential, rrel) of the re-solves of ``conductivity`` that
        ``info['resolves']`` does not count as done: the refined solve from
        the ``stalled`` potential, with a fresh pass budget and stall
        count, and, where that ends above :data:`RESOLVE_TRIGGER`, once
        more from the cold start; each GCR solve keeps
        :data:`RESOLVE_GCR_K` directions, and each re-solve is a span
        ``potential.resolve`` (its fields ``cases``, 1, and ``warm``),
        counted in ``info``."""
        from .potential import solve_potential_refined
        bmask, bvals = boundary_masks(self.track_direction,
                                      tuple(self.gridsize))
        maxiter = self.potential_maxiter if self.potential_maxiter > 0 \
            else 60
        done = info['resolves']
        for n, init in list(enumerate((stalled, None), 1))[done:]:
            with self.timer.span('potential.resolve', cases=1,
                                 warm=init is not None):
                pot, resid = solve_potential_refined(
                    conductivity, bmask, bvals,
                    tol=float(self.potential_tol), maxcycles=maxiter,
                    init=init, depth=RESOLVE_GCR_K)
            info.update(resolves=n, resolve_rrel=float(resid))
            if float(resid) <= RESOLVE_TRIGGER:
                break
        return pot, resid

    def _get_id_string(self, case_id: str, real_id=None):
        """Artifact id (ssrs/simulator.py:290-298)."""
        out = (f'{case_id}_d{int(self.track_direction % 360)}'
               f'_t{int(self.updraft_threshold * 100)}'
               f'_{self.movement_model}')
        if real_id is not None:
            out += f'_r{int(real_id)}'
        return out

    def _get_potential_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_potential')

    # ---- track simulation -----------------------------------------------

    def _track_params(self) -> TrackParams:
        cap = self.track_max_steps if self.track_max_steps > 0 else \
            self.grid.reference_max_moves()
        return TrackParams(
            grid_shape=self.grid.shape,
            move_dirn=float(self.track_direction),
            nu=float(self.track_stochastic_nu),
            memory_k=int(self.track_dirn_restrict),
            burnin=self.grid.burnin_length(),
            nsteps=cap,
            weight_dtype=str(self.track_weight_precision))

    def simulate_tracks(self) -> None:
        """Simulate all tracks of every case and realization
        (ssrs/simulator.py:332-386) and save the ``_counts.npy`` presence
        counts; a run of at most ``track_pkl_budget`` tracks also saves
        its trajectories as ``_tracks.pkl``."""
        with self.timer.phase('simulate_tracks',
                              tracks=int(self.track_count),
                              cases=len(self.case_ids)):
            self._simulate_tracks_impl()
        self._dump_phase_timings()

    def _starts(self) -> np.ndarray:
        """The run's ``(N, 2)`` int32 start cells, from the run's rng."""
        starting_rows, starting_cols = get_starting_indices(
            int(self.track_count), list(self.track_start_region),
            self.track_start_type, tuple(self.region_width_km),
            float(self.resolution), rng=self._rng)
        return np.stack([starting_rows, starting_cols],
                        axis=1).astype(np.int32)

    def _work_items(self, items):
        """``(case_id, real_id, updraft, (host, device) potential)`` work
        items of fluidflow ``(case_id, real_id, updraft)`` items."""
        pots = self._prepare_potentials(items, pairs=True)
        return [(cid, rid, upd, pot)
                for (cid, rid, upd), pot in zip(items, pots)]

    def _simulate_tracks_impl(self) -> None:
        print(f'Movement model = {self.movement_model}')
        print(f'Updraft threshold = {self.updraft_threshold} m/s')
        print(f'Movement direction = {self.track_direction} deg (cw)')
        starts = self._starts()
        params = self._track_params()
        # reference-format .pkl trajectories for runs up to
        # track_pkl_budget tracks; larger runs keep only the counts
        record = int(self.track_count) <= int(self.track_pkl_budget)

        if self.movement_model not in ('fluidflow', 'drw'):
            raise ValueError(
                f'movement_model {self.movement_model!r} not '
                "implemented; options: 'fluidflow', 'drw'")

        # every (case, realization, fields) work item; a drw item carries
        # no field and no potential. With Config.fields_device the
        # thresholded updrafts stay tensors on the run's device and the
        # solver's potentials feed the table build as they are; without
        # it both pass through numpy.
        n_fields = len(self.case_ids) * (
            1 + int(self.thermals_realization_count))
        dev_fields = self._device_fields_fit(n_fields)
        work = []
        items = []
        for case_id in self.case_ids:
            updrafts = self.load_updrafts(case_id, apply_threshold=True,
                                          device=dev_fields)
            for real_id, updraft in enumerate(updrafts):
                if self.movement_model == 'fluidflow':
                    items.append((case_id, real_id, updraft))
                else:
                    work.append((case_id, real_id, None, None))
        if items:
            work = self._work_items(items)

        if not record and len(work) > 1:
            self._simulate_batched(params, starts, work)
            return

        for case_id, real_id, updraft, pot_pair in work:
            potential = None if pot_pair is None else \
                self._device_potential(pot_pair)
            id_str = self._get_id_string(case_id, real_id)
            print(f'{id_str}: Simulating {self.track_count} tracks..',
                  end='', flush=True)
            start_time = time.time()
            # recorded runs stay on the run's device, as in the JAX package
            with self.timer.phase('tracks', recorded=record, id=id_str,
                                  devices=1 if record else len(self.mesh)):
                if record:
                    run = simulate_tracks_recorded(
                        params, starts, case_generator(
                            self.sim_seed, case_id, real_id, 'tracks',
                            self.device),
                        updraft=updraft, potential=potential)
                    presence, steps = run.presence, run.steps
                else:
                    presence, steps = self._run_large(
                        params, starts, case_seed(self.sim_seed, case_id,
                                                  real_id, 'tracks'),
                        updraft, potential)
                presence = presence.cpu().numpy()
            print(f'took {elapsed_str(start_time)}', flush=True)
            # useful steps = presence mass minus the start deposits
            self.timer.records[-1].update(
                steps=int(steps),
                useful_steps=int(presence.sum(dtype=np.int64))
                - int(self.track_count))
            if record:
                self.timer.records[-1].update(
                    builder=run.builder, build_seconds=run.build_seconds)
                fname = self._get_tracks_fname(case_id, real_id,
                                               self.mode_data_dir)
                with self.timer.phase('write_tracks'):
                    with open(f'{fname}.pkl', 'wb') as fobj:
                        pickle.dump(run.tracks, fobj)
            fname = self._get_counts_fname(case_id, real_id,
                                           self.mode_data_dir)
            self._save('counts', f'{fname}.npy', presence.astype(np.int32))

    def _tail_bucket(self):
        return int(self.track_tail_bucket) \
            if self.track_tail_bucket != 'auto' else 'auto'

    def _run_large(self, params, starts, seed: int, updraft, potential):
        """The counts-only driver (``ssrs_tpu/simulator.py:813-833``):
        agents sharded over the mesh when it has more than one entry
        (``Config.mesh_devices``; 0 = every device of the ``Simulator``),
        shard i seeded with ``fold_in(seed, i)``; dead-agent compaction in
        both regimes. Returns (presence int32 on the run's device, steps).
        """
        tail = self._tail_bucket()
        if len(self.mesh) > 1:
            return simulate_presence_sharded_compacting(
                params, starts, seed, updraft=updraft, potential=potential,
                mesh=self.mesh, tail_bucket=tail)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return simulate_presence_compacting(
            params, starts, gen, updraft=updraft, potential=potential,
            tail_bucket=tail)

    def _device_potential(self, pot_pair) -> torch.Tensor:
        """The potential of a ``(host, device-or-None)`` pair on the run's
        device: the solver's own tensor, or the host array (a cached
        artifact, a fallback result) uploaded."""
        host, dev = pot_pair
        if dev is not None:
            return dev
        return torch.from_numpy(np.asarray(host, np.float32)).to(self.device)

    def _simulate_batched(self, params, starts, work) -> None:
        """All (case, realization) populations through the interleaved
        multi-case compacting driver
        (``agents.simulate_presence_cases_compacting``); the reference
        loops them serially through its pool (ssrs/simulator.py:348-386).
        The tables of fluidflow items are built at once; drw items have
        no table. With a mesh of more than one entry, case i runs on
        ``mesh[i % len(mesh)]`` (``ssrs_tpu/simulator.py:790-795``). One
        ``batched_tracks`` phase record, one ``_counts.npy`` a work
        item."""
        mesh = self.mesh
        gens = [case_generator(self.sim_seed, case_id, real_id, 'tracks',
                               mesh[i % len(mesh)])
                for i, (case_id, real_id, _, _) in enumerate(work)]
        if work[0][2] is None:
            tables = [None] * len(work)
        else:
            dirp = torch.from_numpy(
                directional_probs(float(self.track_direction))).to(
                    self.device)
            tables = prepared_weights_batch(
                torch.stack([torch.as_tensor(upd, dtype=torch.float32,
                                             device=self.device)
                             for _, _, upd, _ in work]),
                torch.stack([self._device_potential(pot)
                             for _, _, _, pot in work]),
                dirp.expand(len(work), 9), params.weight_dtype)
        print(f'Simulating {len(work)} cases x {self.track_count} '
              'tracks (batched)..', end='', flush=True)
        start_time = time.time()
        with self.timer.phase('batched_tracks', cases=len(work),
                              devices=len(mesh)):
            presence, steps = simulate_presence_cases_compacting(
                params, tables, starts, gens, tail_bucket=self._tail_bucket(),
                devices=mesh if len(mesh) > 1 else None)
            presence = presence.cpu().numpy().astype(np.int32)
        print(f'took {elapsed_str(start_time)}', flush=True)
        # useful steps = presence mass minus the start deposits
        self.timer.records[-1].update(
            steps=[int(s) for s in steps],
            useful_steps=int(presence.sum(dtype=np.int64))
            - len(work) * int(self.track_count))
        for i, (case_id, real_id, _, _) in enumerate(work):
            fname = self._get_counts_fname(case_id, real_id,
                                           self.mode_data_dir)
            self._save('counts', f'{fname}.npy', presence[i])

    def simulate_direction_sweep(self, wind_dirns) -> List[str]:
        """Uniform-mode wind-direction sweep: one updraft field,
        threshold, potential and agent population per direction, the
        populations advancing together through the multi-case driver.
        Only valid in uniform mode. Returns the new case ids
        (``s{speed}d{dirn}``); artifacts follow the standard naming, so
        the presence map works unchanged. One ``direction_sweep`` span."""
        with self.timer.span('direction_sweep', cases=len(wind_dirns)):
            new_cases = self._direction_sweep(wind_dirns)
        self._dump_phase_timings()
        return new_cases

    def _direction_sweep(self, wind_dirns) -> List[str]:
        if self.sim_mode.lower() != 'uniform':
            raise ValueError('direction sweep requires uniform mode')
        slope, aspect = self._slope_aspect()
        oros = [self._orograph(slope, aspect, d) for d in wind_dirns]
        new_cases = [f's{int(self.uniform_windspeed)}d{int(d)}'
                     for d in wind_dirns]
        dev_fields = self.movement_model == 'fluidflow' and \
            self._device_fields_fit(len(wind_dirns))

        def save_orographs():
            for case_id, oro in zip(new_cases, oros):
                fname = self._get_orograph_fname(case_id,
                                                 self.mode_data_dir)
                self._save('orographs', f'{fname}.npy',
                           oro.cpu().numpy().astype(np.float32))

        if not dev_fields:
            # the host flow reloads the artifacts through load_updrafts,
            # so they must exist before the work items are built
            save_orographs()
        self.case_ids = new_cases
        starts = self._starts()
        params = self._track_params()
        work = []
        items = []
        for case_id, oro in zip(new_cases, oros):
            if self.movement_model == 'fluidflow':
                updraft = get_above_threshold_speed(
                    oro, self.updraft_threshold) if dev_fields else \
                    self.load_updrafts(case_id, apply_threshold=True,
                                       device=False)[0]
                items.append((case_id, 0, updraft))
            else:
                work.append((case_id, 0, None, None))
        if items:
            try:
                work = self._work_items(items)
            finally:
                # the device flow's artifact copy must land even when a
                # solve raises (e.g. the fallback's size cap): the host
                # flow saved the orographs before the prep
                if dev_fields:
                    save_orographs()
        self._simulate_batched(params, starts, work)
        return new_cases

    def _dump_phase_timings(self) -> None:
        """Structured phase log (``phase_timings.json``): the records added
        since the last dump, and the dump's own ``save.phase_log``
        (:meth:`PhaseTimer.dump`)."""
        self.timer.dump(os.path.join(self.out_dir, self.run_name,
                                     'phase_timings.json'))

    def _save(self, kind: str, path: str, array: np.ndarray) -> None:
        """``np.save`` of an artifact under the span ``save.<kind>``."""
        with self.timer.span(f'save.{kind}'):
            np.save(path, array)

    def _get_counts_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_counts')

    def _get_tracks_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_tracks')

    def _get_presence_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_presence')

    def get_presence_counts(self, case_id: str, real_id: int) -> np.ndarray:
        """Presence counts of one realization: the ``_counts.npy``
        artifact when present, else the recount of the ``_tracks.pkl``
        trajectories on the run's device (int16, as the JAX package's)."""
        fname = self._get_counts_fname(case_id, real_id,
                                       self.mode_data_dir)
        try:
            return np.load(f'{fname}.npy')
        except FileNotFoundError:
            tname = self._get_tracks_fname(case_id, real_id,
                                           self.mode_data_dir)
            # this run's own artifact, written by simulate_tracks
            with open(f'{tname}.pkl', 'rb') as fobj:
                tracks = pickle.load(fobj)
            return compute_presence_counts(tracks, self.gridsize,
                                           device=self.device)

    # ---- presence maps ---------------------------------------------------

    def compute_presence_map(self, radius: float = 1000.) -> np.ndarray:
        """Summary presence probability over all cases and realizations
        (the computation inside ``plot_presence_map``,
        ssrs/simulator.py:508-546), saved as ``summary_presence.npy``."""
        krad = self._presence_kernel_radius(radius)
        summary_prob = np.zeros(self.gridsize, np.float64)
        with self.timer.phase('presence_map'):
            for case_id in self.case_ids:
                summary_prob += self._case_presence(case_id, krad)
            summary_prob = self._finish_summary_presence(summary_prob)
        self._dump_phase_timings()
        return summary_prob

    def get_turbine_presence(self, radius: float = 1000.):
        """Turbine-conflict scores: relative presence density at each
        turbine location (the analysis the reference sketches but leaves
        commented out, ssrs/simulator.py:594-607). Returns the turbines'
        table with a ``presence`` column, sorted by it, descending."""
        if self.turbines.dframe is None:
            raise RuntimeError('No turbine data available '
                               '(USWTDB fetch failed or out of bounds)')
        summary = self.compute_presence_map(radius=radius)
        xlocs, ylocs = self.turbines.get_locations()
        xgrid, ygrid = self.get_terrain_grid()
        cols = np.clip(np.searchsorted(xgrid, xlocs), 0,
                       self.gridsize[1] - 1)
        rows = np.clip(np.searchsorted(ygrid, ylocs), 0,
                       self.gridsize[0] - 1)
        out = self.turbines.dframe.assign(presence=summary[rows, cols])
        return out.sort_values('presence', ascending=False)

    # ---- WTK wind interpolation -----------------------------------------

    def get_wtk_locs(self):
        wtk_lons, wtk_lats = self.wtk.get_coordinates()
        return transform_coordinates(self.lonlat_crs, self.projected_crs,
                                     wtk_lons, wtk_lats)

    def _wtk_interp_plan(self) -> InterpPlan:
        """The interpolation plan of the WTK sites' projected coordinates
        (the span ``wtk_interp.sites``, every call), the grid and
        ``wtk_interp_type``: the one built before where all three are the
        same, else a new one (the span ``wtk_interp.plan``). Counted on the
        ``wtk_interp`` record: ``plan_builds``, ``plan_hits`` and
        ``griddata_calls`` (the host SciPy calls: ``'cubic'`` alone makes
        one a call)."""
        with self.timer.span('wtk_interp.sites'):
            wtk_xlocs, wtk_ylocs = self.get_wtk_locs()
            points = np.array([np.asarray(wtk_xlocs),
                               np.asarray(wtk_ylocs)], dtype=np.float64).T
        xgrid, ygrid = self.get_terrain_grid()
        method = self.wtk_interp_type
        plan = self._wtk_plan
        hit = plan is not None and plan.fits(points, xgrid, ygrid, method)
        if not hit:
            with self.timer.span('wtk_interp.plan', method=method):
                plan = InterpPlan(points, xgrid, ygrid, method, self.device)
            self._wtk_plan = plan
        self.timer.count('plan_builds', int(not hit), on='wtk_interp')
        self.timer.count('plan_hits', int(hit), on='wtk_interp')
        self.timer.count('griddata_calls', int(method == 'cubic'),
                         on='wtk_interp')
        return plan

    def _interpolate_wtk_vardata(self, vdata: np.ndarray) -> np.ndarray:
        """Unstructured -> grid interpolation (ssrs/simulator.py:765-776),
        ``griddata`` with the nearest site outside the sites' hull, through
        the plan (:meth:`_wtk_interp_plan`) on the run's device (the span
        ``wtk_interp.apply``); float64 on the host."""
        plan = self._wtk_interp_plan()
        with self.timer.span('wtk_interp.apply'):
            return plan(vdata).cpu().numpy()

    def _get_interpolated_wind_conditions(
            self, wspeed, wdirn) -> Tuple[np.ndarray, np.ndarray]:
        """Vector-decompose, interpolate, recompose
        (ssrs/simulator.py:778-792): both components through one
        application of the plan, recomposed in float64 on the run's
        device (the span ``wtk_interp.apply``); float64 on the host."""
        wspeed = np.asarray(wspeed, float)
        wdirn = np.asarray(wdirn, float)
        easterly = wspeed * np.sin(np.radians(wdirn))
        northerly = wspeed * np.cos(np.radians(wdirn))
        plan = self._wtk_interp_plan()
        with self.timer.span('wtk_interp.apply'):
            interp = plan(np.stack([easterly, northerly], axis=1))
            winds = speed_and_direction(interp[..., 0], interp[..., 1])
            speed, dirn = torch.stack(winds).cpu().numpy()
        return speed, dirn

    # ---- seasonal sampling ----------------------------------------------

    def get_seasonal_datetimes(self) -> List[datetime]:
        """Seeded seasonal datetime sampler (ssrs/simulator.py:718-752),
        driven by the run's rng as in the JAX package, so that a seed
        gives both packages the same cases."""
        print(f'Seasonal: Requested {self.seasonal_count} counts')
        print(f'Seasonal: Starting Month,Day is {self.seasonal_start}')
        print(f'Seasonal: Ending Month,Day is {self.seasonal_end}')
        print(f'Seasonal: Time of day is {self.seasonal_timeofday}')
        return get_seasonal_datetimes_list(
            self.wtk.years, self.seasonal_start, self.seasonal_end,
            self.seasonal_timeofday, self.seasonal_count,
            tuple(self.lonlat_bounds[0:2]), self._rng)

    # ---- misc ------------------------------------------------------------

    def _get_uniform_id(self):
        return (f's{int(self.uniform_windspeed)}'
                f'd{int(self.uniform_winddirn)}')


# the scaled relative residual above which a refined solve is solved again
# on the device, and which a re-solve must reach to be kept
# (Simulator._finish_potential_solve_pair): on the seasonal Appalachian
# fields (600x700) re-solves end at 7e-8 to 1.3e-5, and a lower trigger
# sends more of them to the ~10-s host solve (PERF.md)
RESOLVE_TRIGGER = 1e-5
# the GCR directions a re-solve keeps: the stalls it answers are a few
# near-null modes (weakly coupled cells inside large islands) that the
# first solve's three keep reintroducing
RESOLVE_GCR_K = 10

# the JAX package's large-grid boundary (4096^2 cells): past it the prep
# never parks fields on the device (Simulator._device_fields_fit) and holds
# one unfinished solve at a time (Simulator._prepare_potentials)
_LARGE_GRID_CELLS = 4096 * 4096

# Simulator._potential_batch_cap: the refined solve's peak device memory
# a cell and case, above what was allocated before it, and the share of
# the device's free memory a group may take. Groups of 1, 2, 4 and 8 at
# 500x600, 800x600 and 1000x1000 peaked at 288-356 bytes a cell and case,
# the single solve the most (scripts/torch_batch_crossover.py on an
# NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md); 360 covers them
_BATCH_BYTES_PER_CELL = 360
_BATCH_MEMORY_SHARE = 0.5


def _free_bytes(device: torch.device) -> int:
    """The free memory of ``device``: the card's, or the host's available
    memory for the CPU."""
    if device.type == 'cuda':
        return torch.cuda.mem_get_info(device)[0]
    return os.sysconf('SC_AVPHYS_PAGES') * os.sysconf('SC_PAGE_SIZE')


def _solve_info(solver: str, rrel=None, passes: int = 0,
                vcycles: int = 0) -> dict:
    """The fields a solve adds to the ``potential`` phase record."""
    return dict(solver=solver, rrel=rrel, fallback=False, passes=passes,
                vcycles=vcycles, resolves=0, fallbacks=0, resolve_rrel=None)


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False
