"""The ``Simulator`` facade of the port, in uniform mode.

The PyTorch counterpart of ``ssrs_tpu/simulator.py`` for uniform mode:
the ``fluidflow`` run, with the directional potential from the refined
solver on the run's device (``potential_solver='auto'``, the default, or
``'refined'``) or from the host float64 direct solve (``'direct'``,
``'dense'``), and the directed random walk (``'drw'``, no potential);
thermal realizations (``thermals_realization_count``); the wind-direction
sweep (``simulate_direction_sweep``); recorded trajectories for runs up
to ``track_pkl_budget`` tracks (the default ``track_count``) and presence
counts alone above, where several (case, realization) populations go
through the interleaved multi-case driver. It keeps the JAX package's
constructor flow (region -> terrain -> orographic updraft -> thermals),
its output-directory layout and its artifact names and formats
(``*_orograph.npy``, ``*_thermals.npy``, ``*_potential.npy``,
``*_tracks.pkl``, ``*_counts.npy``, ``summary_presence.npy``,
``phase_timings.json``), so one package's cached fields feed the other.

Every configuration not ported yet raises ``NotImplementedError`` naming
its item in ROADMAP.md. Turbines (USWTDB) and plotting are not
ported; the terrain is the offline synthetic DEM.
"""
from __future__ import annotations

import json
import os
import pickle
import time
from dataclasses import asdict
from typing import List

import numpy as np
import torch

from .config import Config
from .core.grid import Grid
from .core.rng import case_generator
from .core.timing import PhaseTimer, elapsed_str
from .agents.presence import (card_or_raise, compute_presence_counts,
                              smooth_presence)
from .agents.moves import directional_probs
from .agents.simulate import (TrackParams, prepared_weights_batch,
                              simulate_presence_cases_compacting,
                              simulate_presence_compacting,
                              simulate_tracks_recorded)
from .agents.starts import get_starting_indices
from .data import (Terrain, get_raster_in_projected_crs, transform_bounds,
                   transform_coordinates)
from .fields import (compute_orographic_updraft,
                     compute_slope_aspect_degrees, compute_thermals,
                     get_above_threshold_speed)
from .potential.boundary import boundary_masks
from .potential.direct import fallback_cost_estimate, solve_potential_direct
from .utils import makedir_if_not_exists


def _check_slice(cfg: Config) -> None:
    """Raise NotImplementedError for a configuration not ported yet."""
    todo = 'ROADMAP.md, "Modules still to port"'
    if str(cfg.sim_mode).lower() != 'uniform':
        raise NotImplementedError(
            f'sim_mode={cfg.sim_mode!r}: only uniform mode is ported; '
            f'snapshot and seasonal modes wait for WTK ({todo}: data '
            'sources)')
    solver = (cfg.potential_solver or 'auto').lower()
    if solver in ('mg', 'multigrid'):
        raise NotImplementedError(
            f'potential_solver={cfg.potential_solver!r}: the legacy '
            "row-normalized multigrid is not ported; use 'auto' (the "
            f"refined device solver) or 'direct' ({todo}: not ported, on "
            'purpose)')
    if solver not in ('auto', 'refined', 'direct', 'dense'):
        raise ValueError(
            f'potential_solver={cfg.potential_solver!r}: expected auto, '
            'refined, direct or dense')
    if int(cfg.potential_batch) > 1:
        raise NotImplementedError(
            f'potential_batch={cfg.potential_batch}: the batched multi-case '
            f'solve is not ported ({todo}: not ported, on purpose)')
    if int(cfg.mesh_devices) > 1:
        raise NotImplementedError(
            f'mesh_devices={cfg.mesh_devices}: the port runs on one device; '
            f'multi-GPU waits ({todo}: multi-GPU)')
    if str(cfg.track_step_impl) not in ('auto', 'fused') or \
            str(cfg.track_presence_impl) != 'auto':
        raise NotImplementedError(
            f'track_step_impl={cfg.track_step_impl!r}, track_presence_impl='
            f'{cfg.track_presence_impl!r}: the port has one engine (the '
            "fused step kernel); only 'auto' (or 'fused') is accepted")


class Simulator(Config):
    """SSRS simulation orchestrator (reference: ssrs/simulator.py:34), on
    one PyTorch device (default ``'cuda'``)."""

    lonlat_crs = 'EPSG:4326'

    def __init__(self, in_config: Config = None, device='cuda',
                 **kwargs) -> None:
        device = card_or_raise(device, 'Simulator')
        if in_config is None:
            super().__init__(**kwargs)
        else:
            super().__init__(**asdict(in_config))
        _check_slice(self)
        self.device = device
        print(f'\n---- SSRS (PyTorch, {device}) in {self.sim_mode} mode')
        print(f'Run name: {self.run_name}')

        self.timer = PhaseTimer(device=device)
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
        with open(fpath, 'w', encoding='utf-8') as cfile:
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

        # terrain: the offline synthetic DEM (the JAX package's chain
        # 3DEP -> SRTM -> synthetic ends here without a network)
        self.region = Terrain(self.lonlat_bounds, self.data_dir)
        self.terrain_layers = {'Elevation': 'SYNTHETIC'}
        with self.timer.phase('terrain'):
            self.region.download(list(self.terrain_layers.values()))

        print(f'Uniform mode: Wind speed = {self.uniform_windspeed} m/s')
        print(f'Uniform mode: Wind dirn = {self.uniform_winddirn} deg(cw)')
        self.case_ids = [self._get_uniform_id()]
        with self.timer.phase('updrafts'):
            self.compute_orographic_updraft_uniform()
        with self.timer.phase('thermals', realizations=int(
                self.thermals_realization_count)):
            for case_id in self.case_ids:
                self.compute_thermal_updrafts(case_id)
        print('SSRS Simulator initiation done.')

    # ---- terrain ---------------------------------------------------------

    def get_terrain_elevation(self) -> np.ndarray:
        """The DEM on the run grid (float64, lower-left origin)."""
        return get_raster_in_projected_crs(
            self.region.get_raster_fpath(self.terrain_layers['Elevation']),
            self.bounds, self.gridsize, self.resolution,
            self.projected_crs)

    def _slope_aspect(self):
        # float32, as the JAX package computes with 64-bit types off
        elev = torch.from_numpy(
            self.get_terrain_elevation().astype(np.float32)).to(self.device)
        return compute_slope_aspect_degrees(elev, self.resolution)

    def get_terrain_slope(self) -> np.ndarray:
        """Horn-stencil slope from the DEM (ssrs/simulator.py:152-159)."""
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
        np.save(f'{fname}.npy', orograph.cpu().numpy().astype(np.float32))

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
        start_time = time.time()
        handle = self._begin_potential_solve(updraft)
        handle[-1]['seconds'] = time.time() - start_time
        return ('solve', handle, fname, id_str, start_time)

    def begin_directional_potentials(self, items):
        """Multi-case prep: cache-check every ``(updraft, case_id,
        real_id)`` item and solve the uncached ones, one
        :meth:`finish_directional_potential` handle per item, in order.
        The JAX package can group the uncached solves into batched
        programs here (``potential_batch > 1``, which the port refuses:
        ROADMAP.md, "Not ported, on purpose"), so every item takes the
        single solve."""
        return [self.begin_directional_potential(updraft, case_id, real_id)
                for updraft, case_id, real_id in items]

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
            np.save(f'{fname}.npy', potential.astype(np.float32))
        if np.isnan(potential).any():
            print('NANs found in potential!')
        info = dict(handle[-1])
        self.timer.records.append({
            'phase': 'potential',
            'seconds': info.pop('seconds', 0.) + time.time() - t0,
            'id': id_str, **info})
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
        if cells > 4096 * 4096:
            return False
        return cells * max(1, n_fields) * 8 <= 1_500_000_000

    def _prepare_potentials(self, items, pairs: bool = False):
        """Potentials for a list of ``(case_id, real_id, updraft)`` work
        items, in order, through :meth:`begin_directional_potentials` and
        finish in windows of the JAX package's bounded finish depth (3, or
        1 past 4096^2): at most that many unfinished solves are held at
        once.

        With ``pairs=True`` every element is ``(host, device-or-None)``
        (see :meth:`_finish_directional_potential_pair`); otherwise
        plain host arrays."""
        finish = (self._finish_directional_potential_pair if pairs
                  else self.finish_directional_potential)
        out = []
        depth = 3 if int(np.prod(self.gridsize)) <= 4096 * 4096 else 1
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
        ``'dense'`` the host float64 solve."""
        solver = (self.potential_solver or 'auto').lower()
        cond = torch.as_tensor(conductivity, dtype=torch.float32,
                               device=self.device)
        if solver in ('direct', 'dense'):
            return ('done', solve_potential_direct(cond.cpu().numpy(),
                                                   self.track_direction),
                    _solve_info('direct'))
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
        :meth:`_begin_potential_solve` handle, through the residual net.

        The net is the JAX package's numerical policy
        (ssrs_tpu/simulator.py:563-612): a refined solve whose scaled
        relative residual exceeds 5e-3 is discarded for the float64
        direct solve, unless the grid is above
        ``Config.potential_fallback_max_unknowns`` (<= 0 lifts the cap),
        where it raises instead of buying an hours-long host solve. The
        handle's info records a fallback."""
        kind, payload, info = handle
        if kind == 'done':
            return payload, None
        conductivity, pot, resid = payload
        if float(resid) > 5e-3:
            unknowns = int(np.prod(self.gridsize))
            est_s, est_gb = fallback_cost_estimate(unknowns)
            cap = int(self.potential_fallback_max_unknowns)
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
            return solve_potential_direct(conductivity.cpu().numpy(),
                                          self.track_direction), None
        return pot.cpu().numpy(), pot

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

        tail = int(self.track_tail_bucket) \
            if self.track_tail_bucket != 'auto' else 'auto'
        for case_id, real_id, updraft, pot_pair in work:
            potential = None if pot_pair is None else \
                self._device_potential(pot_pair)
            id_str = self._get_id_string(case_id, real_id)
            print(f'{id_str}: Simulating {self.track_count} tracks..',
                  end='', flush=True)
            start_time = time.time()
            gen = case_generator(self.sim_seed, case_id, real_id, 'tracks',
                                 self.device)
            with self.timer.phase('tracks', recorded=record, id=id_str):
                if record:
                    run = simulate_tracks_recorded(params, starts, gen,
                                                   updraft=updraft,
                                                   potential=potential)
                    presence, steps = run.presence, run.steps
                else:
                    presence, steps = simulate_presence_compacting(
                        params, starts, gen, updraft=updraft,
                        potential=potential, tail_bucket=tail)
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
            np.save(f'{fname}.npy', presence.astype(np.int32))

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
        no table. One ``batched_tracks`` phase record, one ``_counts.npy``
        a work item."""
        gens = [case_generator(self.sim_seed, case_id, real_id, 'tracks',
                               self.device)
                for case_id, real_id, _, _ in work]
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
        tail = int(self.track_tail_bucket) \
            if self.track_tail_bucket != 'auto' else 'auto'
        with self.timer.phase('batched_tracks', cases=len(work)):
            presence, steps = simulate_presence_cases_compacting(
                params, tables, starts, gens, tail_bucket=tail)
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
            np.save(f'{fname}.npy', presence[i])

    def simulate_direction_sweep(self, wind_dirns) -> List[str]:
        """Uniform-mode wind-direction sweep: one updraft field,
        threshold, potential and agent population per direction, the
        populations advancing together through the multi-case driver.
        Only valid in uniform mode. Returns the new case ids
        (``s{speed}d{dirn}``); artifacts follow the standard naming, so
        the presence map works unchanged."""
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
                np.save(f'{fname}.npy',
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
        self._dump_phase_timings()
        return new_cases

    def _dump_phase_timings(self) -> None:
        """Structured phase log (``phase_timings.json``)."""
        fpath = os.path.join(self.out_dir, self.run_name,
                             'phase_timings.json')
        with open(fpath, 'w', encoding='utf-8') as fobj:
            json.dump(self.timer.records, fobj, indent=2, default=str)

    def _get_counts_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_counts')

    def _get_tracks_fname(self, case_id, real_id, dirname):
        return os.path.join(dirname,
                            f'{self._get_id_string(case_id, real_id)}'
                            '_tracks')

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

    def _presence_kernel_radius(self, radius: float) -> int:
        """Smoothing kernel radius in cells, clamped to [2, grid/2]."""
        return int(round(min(max(radius / self.resolution, 2),
                             min(self.gridsize) / 2)))

    def _smoothed_presence(self, case_id, real_id, krad: int) -> np.ndarray:
        """Max-normalized smoothed presence probability of one
        realization."""
        counts = torch.from_numpy(
            self.get_presence_counts(case_id, real_id).astype(np.int32))
        prob = smooth_presence(counts.to(self.device), krad).cpu().numpy()
        return prob / np.amax(prob)

    def _case_presence(self, case_id, krad: int) -> np.ndarray:
        """Sum of a case's per-realization probabilities (realization 0 is
        orographic only; 1.. add the thermal realizations),
        max-normalized."""
        case_prob = np.zeros(self.gridsize, np.float64)
        for real_id in range(1 + int(self.thermals_realization_count)):
            case_prob += self._smoothed_presence(case_id, real_id, krad)
        return case_prob / np.amax(case_prob)

    def compute_presence_map(self, radius: float = 1000.) -> np.ndarray:
        """Summary presence probability over all cases and realizations
        (the computation inside ``plot_presence_map``,
        ssrs/simulator.py:508-546), saved as ``summary_presence.npy``."""
        krad = self._presence_kernel_radius(radius)
        summary_prob = np.zeros(self.gridsize, np.float64)
        with self.timer.phase('presence_map'):
            for case_id in self.case_ids:
                summary_prob += self._case_presence(case_id, krad)
            summary_prob = summary_prob / np.amax(summary_prob)
            fname = os.path.join(self.mode_data_dir, 'summary_presence')
            np.save(f'{fname}.npy', summary_prob.astype(np.float32))
        self._dump_phase_timings()
        return summary_prob

    # ---- misc ------------------------------------------------------------

    def _get_uniform_id(self):
        return (f's{int(self.uniform_windspeed)}'
                f'd{int(self.uniform_winddirn)}')


def _solve_info(solver: str, rrel=None, passes: int = 0,
                vcycles: int = 0) -> dict:
    """The fields a solve adds to the ``potential`` phase record."""
    return dict(solver=solver, rrel=rrel, fallback=False, passes=passes,
                vcycles=vcycles)


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False
