"""GIS figure styling shared by the figure layer (``plotting.py``) and
``utils.create_gis_axis``: a copy of ``ssrs_tpu/figstyle.py``.

The values in :data:`STYLE` are the figure-parity spec, each cited to the
reference line whose output it must match, so the port draws the JAX
package's figures. matplotlib is imported inside the functions that use
it, never at import.
"""

from __future__ import annotations

# ---- figure-parity style table ---------------------------------------------
# One flat table so the whole visual contract is auditable in one place.
STYLE = {
    # GIS decor (reference ssrs/utils.py:32-71)
    'scale_bar': dict(loc=3, pad=0.1, size_vertical=0.1,
                      frameon=False),                 # ssrs/utils.py:41-44
    'north_arrow_xy': (0.03, 0.925),                  # ssrs/utils.py:47
    'north_arrow_text_xy': (0.03, 0.99),              # ssrs/utils.py:48
    'north_arrow_alpha': 0.9,                         # ssrs/utils.py:45,52
    'north_arrow_lw': 2.1,                            # ssrs/utils.py:45
    'colorbar': dict(pad=0.01, shrink=0.8, aspect=40),  # ssrs/utils.py:55
    'legend': dict(markerscale=2, columnspacing=1.0,
                   handletextpad=0.0, borderaxespad=0.,
                   fontsize='small'),                 # ssrs/utils.py:63-68
    'legend_anchor': (0, 1.005),                      # ssrs/utils.py:63
    # underlays & overlays (reference ssrs/simulator.py)
    'underlay_alpha': 0.75,      # terrain/WTK/presence; simulator.py:400
    'track_lw_many': 0.15,       # > cutoff tracks; simulator.py:397
    'track_lw_few': 0.4,         # simulator.py:397
    'track_lw_cutoff': 251,      # simulator.py:397
    'track_alpha': 0.5,          # simulator.py:413
    'track_color': '-r',         # simulator.py:413
    'start_marker': 'b.',        # simulator.py:410
    'start_markersize': 1.0,     # simulator.py:410
    'start_region': dict(alpha=0.2, edgecolor='none',
                         facecolor='b'),              # simulator.py:420-424
    'turbine_alpha': 0.75,       # simulator.py:698
    'turbine_box': dict(linewidth=1, edgecolor='k', facecolor='none',
                        zorder=20),                   # simulator.py:703-707
    # colormaps / scaling (reference ssrs/simulator.py)
    'cmap_elevation': 'terrain',   # simulator.py:650
    'cmap_slope': 'magma_r',       # simulator.py:662
    'cmap_aspect': 'hsv',          # simulator.py:674
    'cmap_updraft': 'viridis',     # simulator.py:446
    'cmap_wtk': 'viridis',         # simulator.py:473
    'cmap_potential': 'cividis',   # simulator.py:315
    'cmap_presence': 'Reds',       # simulator.py:497
    'updraft_vmax_cap': 5,         # simulator.py:445
    'potential_levels': 11,        # simulator.py:314
    'presence_vmax': 1.0,          # simulator.py:499
    'threshold_figsize': (5, 3),   # simulator.py:797
}


# ---- axis decorators -------------------------------------------------------

def hide_ticks(ax) -> None:
    """Blank GIS canvas: no ticks or tick labels on either axis."""
    ax.tick_params(axis='both', which='both', bottom=False, top=False,
                   labelbottom=False, right=False, left=False,
                   labelleft=False)


def add_scale_bar(ax, km_bar: float) -> None:
    """Anchored distance bar (data units are metres)."""
    from mpl_toolkits.axes_grid1.anchored_artists import AnchoredSizeBar
    spec = STYLE['scale_bar']
    ax.add_artist(AnchoredSizeBar(ax.transData, km_bar * 1000.,
                                  f'{int(km_bar)} km', spec['loc'],
                                  pad=spec['pad'],
                                  size_vertical=spec['size_vertical'],
                                  frameon=spec['frameon']))


def add_north_arrow(ax) -> None:
    """'N' with an upward arrow in the axes' top-left corner."""
    alpha = STYLE['north_arrow_alpha']
    ax.annotate(
        'N', xy=STYLE['north_arrow_xy'], xycoords='axes fraction',
        xytext=STYLE['north_arrow_text_xy'], textcoords='axes fraction',
        arrowprops=dict(fc='k', ec='k', alpha=alpha,
                        lw=STYLE['north_arrow_lw'],
                        arrowstyle='<-,head_length=1.0'),
        bbox=dict(pad=-4, facecolor='none', edgecolor='none'),
        ha='center', va='top', alpha=alpha)


def add_colorbar(fig, ax, mappable):
    """Frameless tickless colorbar; returns it (None for no mappable)."""
    if not mappable:
        return None
    cbar = fig.colorbar(mappable, ax=ax, **STYLE['colorbar'])
    cbar.outline.set_visible(False)
    cbar.ax.tick_params(size=0)
    return cbar


def add_project_legend(fig, ax):
    """Legend above the axes for any labeled artists (turbine projects);
    column count scales with figure width. None when nothing is labeled."""
    if not ax.get_legend_handles_labels()[1]:
        return None
    # the reference's int(w // 2) formula is kept, floored at 1: at
    # figure widths under 2 in (tall narrow regions) ncol=0 crashes
    # matplotlib's legend layout
    ncol = max(1, int(fig.get_size_inches()[0] // 2))
    return ax.legend(bbox_to_anchor=STYLE['legend_anchor'], ncol=ncol,
                     loc='lower left', **STYLE['legend'])


def decorate_gis_axes(fig, ax, mappable=None, km_bar: float = 10.):
    """Full GIS decor pass: bare canvas, scale bar, north arrow,
    optional colorbar, legend (if labeled artists exist at this point —
    callers that draw turbines AFTER decorating get no legend, matching
    the golden figures), equal aspect. Returns (colorbar, legend)."""
    hide_ticks(ax)
    add_scale_bar(ax, km_bar)
    add_north_arrow(ax)
    cbar = add_colorbar(fig, ax, mappable)
    legend = add_project_legend(fig, ax)
    ax.set_aspect('equal', adjustable='box')
    return cbar, legend
