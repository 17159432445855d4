"""The figure layer of the ``Simulator``: a port of ``ssrs_tpu/plotting.py``
with every ``plot_*`` method of the reference (ssrs/simulator.py:305-329,
393-506, 508-592, 641-709, 794-804), the same figures under the same
names.

Every map figure goes through one ``_render_map`` pipeline: create the
figure, run a draw callback that returns the colorbar mappable, apply the
GIS decor pass, overlay the turbines, clamp the extent, save. The visual
contract lives in :data:`ssrs_tpu_torch.figstyle.STYLE`.

The presence arithmetic that ``compute_presence_map`` shares with
``plot_presence_map`` lives here too: the smoothing of each realization's
counts on the run's device, the sum over a case's realizations and the one
writer of ``summary_presence.npy``. matplotlib is imported inside the
methods that draw, never at import: the package runs without it.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from .agents.presence import smooth_presence
from .fields import get_above_threshold_speed
from .figstyle import STYLE, decorate_gis_axes


class PlottingMixin:
    """Plot methods shared by Simulator; relies on its attributes/naming."""

    # ---- shared pipeline -------------------------------------------------

    def _render_map(self, draw, fpath=None, *, cbar_label=None,
                    plot_turbs=True, km_bar=None, clamp=False,
                    show=False):
        """Render one GIS map figure.

        ``draw(axs)`` paints the content and returns the mappable for
        the colorbar (or None for figures without one). Decor runs
        BEFORE the turbine overlay, so project labels never produce a
        legend on these maps — the golden-figure convention (the
        reference calls ``create_gis_axis`` before
        ``plot_turbine_locations`` in every method).

        With ``fpath`` the figure is saved (and closed unless ``show``);
        without it, returns ``(fig, axs)`` for the caller to finish —
        the windplant zoom re-limits the axes after rendering.
        """
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(figsize=self.fig_size)
        mappable = draw(axs)
        cbar, _ = decorate_gis_axes(
            fig, axs, mappable,
            self.km_bar if km_bar is None else km_bar)
        if cbar is not None and cbar_label:
            cbar.set_label(cbar_label)
        if plot_turbs:
            self.plot_turbine_locations(axs)
        if clamp:
            axs.set_xlim([self.extent[0], self.extent[1]])
            axs.set_ylim([self.extent[2], self.extent[3]])
        if fpath is None:
            return fig, axs
        self.save_fig(fig, fpath, show)
        return None

    def _each_realization(self, case_id, apply_threshold=True):
        """Realization ids of a case (0 = orographic only; 1.. add
        thermal realizations), from the config: ``load_updrafts`` always
        yields ``1 + thermals_realization_count`` fields."""
        del case_id, apply_threshold
        return range(1 + int(self.thermals_realization_count))

    # ---- terrain ---------------------------------------------------------

    # layer name -> (accessor attr, cmap, colorbar label, scale, vlims)
    _TERRAIN_LAYERS = {
        'elevation': ('get_terrain_elevation', STYLE['cmap_elevation'],
                      'Altitude (km)', 1e-3, None),
        'slope': ('get_terrain_slope', STYLE['cmap_slope'],
                  'Slope (Degrees)', 1., None),
        'aspect': ('get_terrain_aspect', STYLE['cmap_aspect'],
                   'Aspect (Degrees)', 1., (0., 360.)),
    }

    def _plot_terrain_layer(self, layer, plot_turbs, show):
        """One terrain underlay figure (ssrs/simulator.py:647-685)."""
        accessor, cmap, label, scale, vlims = self._TERRAIN_LAYERS[layer]
        data = getattr(self, accessor)() * scale

        def draw(axs):
            kw = {} if vlims is None else dict(vmin=vlims[0],
                                               vmax=vlims[1])
            return axs.imshow(data, cmap=cmap, extent=self.extent,
                              origin='lower', **kw)

        self._render_map(draw, os.path.join(self.fig_dir, f'{layer}.png'),
                         cbar_label=label, plot_turbs=plot_turbs,
                         show=show)

    def plot_terrain_features(self, plot_turbs=True, show=False) -> None:
        """(ssrs/simulator.py:641-646)"""
        print('Plotting terrain layers..', flush=True)
        for layer in self._TERRAIN_LAYERS:
            self._plot_terrain_layer(layer, plot_turbs, show)

    def plot_terrain_elevation(self, plot_turbs=True, show=False) -> None:
        self._plot_terrain_layer('elevation', plot_turbs, show)

    def plot_terrain_slope(self, plot_turbs=True, show=False) -> None:
        self._plot_terrain_layer('slope', plot_turbs, show)

    def plot_terrain_aspect(self, plot_turbs=True, show=False) -> None:
        self._plot_terrain_layer('aspect', plot_turbs, show)

    # ---- updrafts & WTK --------------------------------------------------

    def plot_updrafts(self, apply_threshold=True, plot_turbs=True,
                      show=False) -> None:
        """(ssrs/simulator.py:437-461)"""
        print('Plotting updraft fields..')
        for case_id in self.case_ids:
            updrafts = self.load_updrafts(case_id, apply_threshold,
                                          device=False)
            for real_id, updraft in enumerate(updrafts):
                # color scale saturates at the rounded mean, capped to
                # [1, 5] m/s like the reference's committed figures
                vmax = min(max(1, int(round(float(np.mean(updraft))))),
                           STYLE['updraft_vmax_cap'])
                label = ('Orographic updraft (m/s)' if real_id == 0
                         else 'Orographic + Thermal (m/s)')
                if apply_threshold:
                    label += ', usable'
                fname = (f'{self._get_id_string(case_id, real_id)}'
                         '_updraft.png')
                self._render_map(
                    lambda axs, u=updraft, v=vmax: axs.imshow(
                        u, cmap=STYLE['cmap_updraft'], extent=self.extent,
                        origin='lower', vmin=0, vmax=v),
                    os.path.join(self.mode_fig_dir, fname),
                    cbar_label=label, plot_turbs=plot_turbs, show=show)

    def plot_wtk_layers(self, plot_turbs=True, show=False) -> None:
        """(ssrs/simulator.py:463-486)"""
        try:
            cases = list(zip(self.dtimes, self.case_ids))
            varnames = list(self.wtk.varnames)
        except AttributeError:
            print('No WTK data to plot in uniform mode!')
            return
        for dtime, case_id in cases:
            wtk_df = self.wtk.get_dataframe_for_this_time(dtime)
            for wtk_lyr in varnames:
                vardata = np.asarray(wtk_df[wtk_lyr]).flatten()
                interp = self._interpolate_wtk_vardata(vardata)
                self._render_map(
                    lambda axs, d=interp: axs.imshow(
                        d, cmap=STYLE['cmap_wtk'], origin='lower',
                        extent=self.extent,
                        alpha=STYLE['underlay_alpha']),
                    os.path.join(self.mode_fig_dir,
                                 f'{case_id}_{wtk_lyr}.png'),
                    cbar_label=wtk_lyr, plot_turbs=plot_turbs,
                    clamp=True, show=show)

    def plot_updraft_threshold_function(self, show=False) -> None:
        """(ssrs/simulator.py:794-804) — plain line plot, no GIS decor."""
        import matplotlib.pyplot as plt
        fig, axs = plt.subplots(figsize=STYLE['threshold_figsize'])
        uspeed = np.linspace(0, np.ceil(self.updraft_threshold) + 1, 100)
        axs.plot(uspeed, get_above_threshold_speed(
            torch.from_numpy(uspeed.astype(np.float32)),
            self.updraft_threshold).numpy())
        axs.grid(True)
        axs.set_xlabel('Updraft speed (m/s)')
        axs.set_ylabel('Threshold function')
        self.save_fig(fig, os.path.join(self.fig_dir,
                                        'threshold_function.png'), show)

    # ---- potential -------------------------------------------------------

    def plot_directional_potentials(self, plot_turbs=True,
                                    show=False) -> None:
        """(ssrs/simulator.py:305-329)"""
        if self.movement_model != 'fluidflow':
            return
        print('Plotting directional potential..')
        for case_id in self.case_ids:
            for real_id in self._each_realization(case_id):
                data_f = self._get_potential_fname(case_id, real_id,
                                                   self.mode_data_dir)
                try:
                    potential = np.load(f'{data_f}.npy')
                except FileNotFoundError:
                    # same graceful skip as plot_simulated_tracks: a
                    # realization without a materialized potential
                    # (e.g. plots called before simulate) should not
                    # abort the whole plotting pass
                    print(f'{os.path.basename(data_f)}: no potential '
                          'artifact, skipping plot', flush=True)
                    continue
                lvls = np.linspace(0., np.amax(potential),
                                   STYLE['potential_levels'])
                fig_f = self._get_potential_fname(case_id, real_id,
                                                  self.mode_fig_dir)
                self._render_map(
                    lambda axs, p=potential, lv=lvls: axs.contourf(
                        p, lv, cmap=STYLE['cmap_potential'],
                        origin='lower', extent=self.extent),
                    f'{fig_f}.png', cbar_label='Directional potential',
                    plot_turbs=plot_turbs, clamp=True, show=show)

    # ---- tracks ----------------------------------------------------------

    def _draw_tracks(self, axs, tracks, elevation, xgrid, ygrid):
        """Terrain underlay + one polyline per track + start dots +
        the start-region rectangle. Thin lines once the track count
        exceeds the golden-figure cutoff."""
        import matplotlib.patches as mpatches
        axs.imshow(elevation, alpha=STYLE['underlay_alpha'], cmap='Greys',
                   origin='lower', extent=self.extent)
        lwidth = (STYLE['track_lw_many']
                  if int(self.track_count) > STYLE['track_lw_cutoff']
                  else STYLE['track_lw_few'])
        for trk in tracks:
            axs.plot(xgrid[trk[0, 1]], ygrid[trk[0, 0]],
                     STYLE['start_marker'],
                     markersize=STYLE['start_markersize'])
            axs.plot(xgrid[trk[:, 1]], ygrid[trk[:, 0]],
                     STYLE['track_color'], linewidth=lwidth,
                     alpha=STYLE['track_alpha'])
        # start region, km offsets from the SW corner -> metres
        x0, x1, y0, y1 = self.track_start_region
        axs.add_patch(mpatches.Rectangle(
            (self.extent[0] + x0 * 1000., self.extent[2] + y0 * 1000.),
            (x1 - x0) * 1000., (y1 - y0) * 1000.,
            **STYLE['start_region']))
        return None  # no colorbar on track maps

    def plot_simulated_tracks(self, plot_turbs=True, show=False) -> None:
        """(ssrs/simulator.py:393-432)"""
        print('Plotting simulated tracks..')
        elevation = self.get_terrain_elevation()
        xgrid, ygrid = self.get_terrain_grid()
        for case_id in self.case_ids:
            for real_id in self._each_realization(case_id):
                fname = self._get_tracks_fname(case_id, real_id,
                                               self.mode_data_dir)
                if not os.path.exists(f'{fname}.pkl'):
                    print(f'{fname}.pkl absent (large run: tracks not '
                          'materialized); skipping track plot')
                    continue
                with open(f'{fname}.pkl', 'rb') as fobj:
                    tracks = pickle.load(fobj)
                out = self._get_tracks_fname(case_id, real_id,
                                             self.mode_fig_dir)
                self._render_map(
                    lambda axs, t=tracks: self._draw_tracks(
                        axs, t, elevation, xgrid, ygrid),
                    f'{out}.png', plot_turbs=plot_turbs, clamp=True,
                    show=show)

    # ---- presence --------------------------------------------------------

    def _presence_kernel_radius(self, radius: float) -> int:
        """Smoothing kernel radius in cells, clamped to [2, grid/2]."""
        return int(round(min(max(radius / self.resolution, 2),
                             min(self.gridsize) / 2)))

    def _smoothed_presence(self, case_id, real_id, krad: int) -> np.ndarray:
        """Max-normalized smoothed presence probability of one
        realization, smoothed on the run's device (TF32 off in
        ``smooth_presence``)."""
        counts = torch.from_numpy(
            self.get_presence_counts(case_id, real_id).astype(np.int32))
        prob = smooth_presence(counts.to(self.device), krad).cpu().numpy()
        return prob / np.amax(prob)

    def _finish_summary_presence(self, summary_prob: np.ndarray
                                 ) -> np.ndarray:
        """Normalize the accumulated summary and write the
        ``summary_presence.npy`` artifact — the ONE definition of that
        artifact, shared by plot_presence_map and
        Simulator.compute_presence_map so the two paths cannot drift."""
        summary_prob = summary_prob / np.amax(summary_prob)
        fname = os.path.join(self.mode_data_dir, 'summary_presence')
        self._save('summary', f'{fname}.npy', summary_prob.astype(np.float32))
        return summary_prob

    def _case_presence(self, case_id, krad: int, each=None):
        """Sum of a case's per-realization probabilities, max-normalized;
        ``each(real_id, prob)`` observes every realization layer."""
        case_prob = np.zeros(self.gridsize, np.float64)
        for real_id in self._each_realization(case_id):
            prob = self._smoothed_presence(case_id, real_id, krad)
            case_prob += prob
            if each is not None:
                each(real_id, prob)
        return case_prob / np.amax(case_prob)

    def _plot_presence(self, in_prob, in_val, plot_turbs,
                       wfarm_level=False):
        """Log-scaled presence underlay (ssrs/simulator.py:491-506);
        values at or below ``in_val`` are blanked. Returns (fig, axs)
        unsaved — callers name the artifact (and the windplant zoom
        re-limits)."""
        from matplotlib.colors import LogNorm

        def draw(axs):
            prob = np.array(in_prob)
            prob[prob <= in_val] = 0.
            axs.imshow(prob, extent=self.extent, origin='lower',
                       cmap=STYLE['cmap_presence'],
                       alpha=STYLE['underlay_alpha'],
                       norm=LogNorm(vmin=in_val,
                                    vmax=STYLE['presence_vmax']))
            return None  # log underlay carries no colorbar

        return self._render_map(draw, None, plot_turbs=plot_turbs,
                                km_bar=1. if wfarm_level else None,
                                clamp=True)

    def plot_presence_map(self, plot_turbs=True, radius: float = 1000.,
                          show=False, minval=0.1,
                          plot_all: bool = False) -> None:
        """(ssrs/simulator.py:508-550)"""
        print('Plotting presence density map..')
        krad = self._presence_kernel_radius(radius)
        summary_prob = np.zeros(self.gridsize, np.float64)

        for case_id in self.case_ids:
            def save_real(real_id, prob, case_id=case_id):
                fig, _ = self._plot_presence(prob, minval, plot_turbs)
                fname = self._get_presence_fname(case_id, real_id,
                                                 self.mode_fig_dir)
                self.save_fig(fig, f'{fname}.png', show)

            case_prob = self._case_presence(
                case_id, krad, each=save_real if plot_all else None)
            summary_prob += case_prob
            fig, _ = self._plot_presence(case_prob, minval, plot_turbs)
            fname = f'{self._get_id_string(case_id)}_presence.png'
            self.save_fig(fig, os.path.join(self.mode_fig_dir, fname),
                          show)

        summary_prob = self._finish_summary_presence(summary_prob)
        if len(self.case_ids) > 1:
            fig, _ = self._plot_presence(summary_prob, minval, plot_turbs)
            self.save_fig(fig, os.path.join(self.mode_fig_dir,
                                            'summary_presence.png'), show)

    def plot_windplant_presence_map(self, pname, radius: float = 100.,
                                    plot_turbs=True, show=False,
                                    minval=0.05, pad: float = 2000.
                                    ) -> None:
        """(ssrs/simulator.py:557-592) — summary presence zoomed to one
        project's turbines, with a 1 km scale bar."""
        print('Plotting presence density map..')
        xloc, yloc = self.turbines.get_locations_for_this_project(pname)
        krad = self._presence_kernel_radius(radius)
        summary_prob = np.zeros(self.gridsize, np.float64)
        for case_id in self.case_ids:
            summary_prob += self._case_presence(case_id, krad)
        summary_prob /= np.amax(summary_prob)
        fig, axs = self._plot_presence(summary_prob, minval, plot_turbs,
                                       wfarm_level=True)
        axs.set_xlim([min(xloc) - pad, max(xloc) + pad])
        axs.set_ylim([min(yloc) - pad, max(yloc) + pad])
        self.save_fig(fig, os.path.join(self.mode_fig_dir,
                                        f'presence_{pname}.png'), show)

    # ---- turbines & misc -------------------------------------------------

    def plot_turbine_locations(self, axs, set_label: bool = True,
                               draw_box: bool = False) -> None:
        """Marker overlay per project, style cycling through
        Config.turbine_mrkr_styles (ssrs/simulator.py:687-709)."""
        import itertools
        import matplotlib.patches as mpatches
        if self.turbines.dframe is None:
            return
        styles = itertools.cycle(self.turbine_mrkr_styles)
        for pname, mrkr in zip(self.turbines.get_project_names(), styles):
            xlocs, ylocs = \
                self.turbines.get_locations_for_this_project(pname)
            axs.plot(xlocs, ylocs, mrkr,
                     markersize=self.turbine_mrkr_size,
                     alpha=STYLE['turbine_alpha'],
                     label=pname if set_label else '')
            if draw_box:
                axs.add_patch(mpatches.Rectangle(
                    (min(xlocs) - 1, min(ylocs) - 1),
                    max(xlocs) - min(xlocs) + 2,
                    max(ylocs) - min(ylocs) + 2, **STYLE['turbine_box']))

    def save_fig(self, fig, fpath: str, show_fig: bool = False) -> None:
        """(ssrs/simulator.py:754-758). Deliberately reference-exact:
        with ``show_fig=True`` the figure is neither saved nor closed —
        it is left open for the caller's pyplot/inline backend to
        display (the reference behaves identically; notebooks rely on
        the open figure)."""
        import matplotlib.pyplot as plt
        if not show_fig:
            fig.savefig(fpath, bbox_inches='tight', dpi=self.fig_dpi)
            plt.close(fig)
