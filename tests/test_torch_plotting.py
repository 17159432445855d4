"""The port's figure layer (``ssrs_tpu_torch/plotting.py``) against the JAX
package's.

Both ``Simulator``s run the tests' WY config (12x10 km at 200 m, 50x60)
with one thermal realization, every HTTP request refused (both terrain
chains end at the same synthetic DEM). The JAX package simulates; its
thermal fields, potentials, counts and ``_tracks.pkl`` are then copied
into the port's ``data/uniform/``, so both packages draw from the same
artifacts (ROADMAP.md section 3: runs that do not share them differ).

- Every ``plot_*`` method writes the same file names in both packages.
- Where the drawn arrays are bitwise equal (elevation: the same numpy
  reprojection; tracks: the same ``.pkl`` over the same elevation;
  potential: the same array and levels), the decoded PNGs are
  pixel-identical. The test asserts the inputs' bitwise equality first.
- The other figures draw arrays that each package computes in its own
  float32 arithmetic: slope and aspect (Horn stencil), the updrafts, the
  threshold function and the smoothed presence. Those arrays agree at
  ``rtol=1e-5, atol=1e-4``, the field tolerance of
  ``tests/test_torch_simulator.py`` and ``tests/test_torch_thermals.py``.
- The WTK layers of a snapshot run at ``rtol=1e-9``: host float64 in both,
  where the JAX package reads its cached coordinates up to an ulp off.
"""

import os
import shutil

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu_torch
from ssrs_tpu_torch.agents.presence import smooth_presence

matplotlib = pytest.importorskip('matplotlib')
matplotlib.use('Agg')
import matplotlib.image as mpimg  # noqa: E402
import matplotlib.pyplot as plt  # noqa: E402

pd = pytest.importorskip('pandas')
h5py = pytest.importorskip('h5py')

CONFIG = dict(
    run_name='wy_fig', sim_mode='uniform', sim_seed=11,
    southwest_lonlat=(-106.21, 42.78), region_width_km=(12., 10.),
    resolution=200., uniform_winddirn=270., uniform_windspeed=10.,
    track_direction=0., track_count=300,
    track_start_region=(1., 11., 1., 2.), track_max_steps=400,
    potential_solver='direct', thermals_realization_count=1,
    mesh_devices=1, fig_dpi=30, fig_height=4.)
CASE = 's10d270'
RTOL, ATOL = 1e-5, 1e-4
# drawn from bitwise-equal inputs
PIXEL_EXACT = ('elevation.png', f'uniform/{CASE}_d0_t75_fluidflow_r0_tracks.png',
               f'uniform/{CASE}_d0_t75_fluidflow_r1_tracks.png',
               f'uniform/{CASE}_d0_t75_fluidflow_r0_potential.png',
               f'uniform/{CASE}_d0_t75_fluidflow_r1_potential.png')
TURBINES = dict(
    t_state=['WY'] * 4, p_name=['P1', 'P1', 'P2', 'P2'],
    p_year=[2015] * 4, t_cap=[2000] * 4, t_hh=[90., 80., 95., 90.],
    t_rd=[100.] * 4, xlong=[-106.18, -106.15, -106.12, -106.10],
    ylat=[42.80, 42.81, 42.83, 42.82])


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


def _capture(sim):
    """Record what each saved figure draws on its first axes: a list of
    draws by the file's path under ``figs/``."""
    drawn = {}
    save = sim.save_fig

    def save_fig(fig, fpath, show_fig=False):
        ax = fig.axes[0]
        drawn.setdefault(os.path.relpath(fpath, sim.fig_dir), []).append(dict(
            images=[np.ma.getdata(im.get_array()).copy()
                    for im in ax.images],
            lines=[(np.asarray(ln.get_xdata()), np.asarray(ln.get_ydata()),
                    ln.get_label()) for ln in ax.lines],
            xlim=ax.get_xlim(), ylim=ax.get_ylim()))
        save(fig, fpath, show_fig)

    sim.save_fig = save_fig
    return drawn


def _plot_all(sim):
    sim.plot_terrain_features()
    sim.plot_updrafts()
    sim.plot_updrafts(apply_threshold=False)
    sim.plot_wtk_layers()
    sim.plot_updraft_threshold_function()
    sim.plot_directional_potentials()
    sim.plot_simulated_tracks()
    sim.plot_presence_map(plot_all=True)


def _fig_names(sim):
    return {os.path.relpath(os.path.join(d, f), sim.fig_dir)
            for d, _, files in os.walk(sim.fig_dir) for f in files}


def _turbines(sim, package):
    if package is ssrs_tpu:
        frame = pd.DataFrame(TURBINES)
    else:
        frame = dict(TURBINES)
    return package.data.TurbinesUSWTB(
        sim.bounds, sim.projected_crs, sim.turbine_minimum_hubheight,
        None, False, dataframe=frame)


@pytest.fixture(scope='module')
def figs(tmp_path_factory):
    """(JAX simulator, port, JAX drawn arrays, port drawn arrays): every
    plot method of both, then the turbine figures with a fixture."""
    root = tmp_path_factory.mktemp('figs')
    jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(out_dir=str(root / 'jax'),
                                                 **CONFIG))
    jax_sim.simulate_tracks()
    port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(root / 'port'), **CONFIG), device='cpu')
    for name in os.listdir(jax_sim.mode_data_dir):
        if name.endswith(('_thermals.npy', '_potential.npy', '_counts.npy',
                          '_tracks.pkl')):
            shutil.copy(os.path.join(jax_sim.mode_data_dir, name),
                        port.mode_data_dir)
    drawn = []
    for sim, package in ((jax_sim, ssrs_tpu), (port, ssrs_tpu_torch)):
        drawn.append(_capture(sim))
        _plot_all(sim)
        sim.turbines = _turbines(sim, package)
        sim.plot_windplant_presence_map('P1')
    return jax_sim, port, drawn[0], drawn[1]


def test_every_plot_method_writes_the_jax_names(figs):
    jax_sim, port, _, _ = figs
    names = _fig_names(port)
    assert names == _fig_names(jax_sim)
    ids = [f'{CASE}_d0_t75_fluidflow_r{r}' for r in (0, 1)]
    assert {'elevation.png', 'slope.png', 'aspect.png',
            'threshold_function.png', f'uniform/{CASE}_d0_t75_fluidflow'
            '_presence.png', 'uniform/presence_P1.png'} <= names
    for ident in ids:
        for kind in ('updraft', 'potential', 'tracks', 'presence'):
            assert f'uniform/{ident}_{kind}.png' in names


def test_figures_from_equal_inputs_are_pixel_identical(figs):
    jax_sim, port, jdrawn, tdrawn = figs
    np.testing.assert_array_equal(port.get_terrain_elevation(),
                                  jax_sim.get_terrain_elevation())
    for got, want in zip(port.get_terrain_grid(),
                         jax_sim.get_terrain_grid()):
        np.testing.assert_array_equal(got, want)
    assert port.extent == jax_sim.extent
    for name in os.listdir(jax_sim.mode_data_dir):
        if name.endswith(('_potential.npy', '_tracks.pkl')):
            with open(os.path.join(jax_sim.mode_data_dir, name), 'rb') as a, \
                    open(os.path.join(port.mode_data_dir, name), 'rb') as b:
                assert a.read() == b.read()
    for name in PIXEL_EXACT:
        (tdraw,), (jdraw,) = tdrawn[name], jdrawn[name]
        for got, want in zip(tdraw['images'], jdraw['images']):
            np.testing.assert_array_equal(got, want)
        assert len(tdraw['lines']) == len(jdraw['lines'])
        for got, want in zip(tdraw['lines'], jdraw['lines']):
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
        got = mpimg.imread(os.path.join(port.fig_dir, name))
        want = mpimg.imread(os.path.join(jax_sim.fig_dir, name))
        assert got.shape == want.shape and got.shape[0] > 50
        np.testing.assert_array_equal(got, want)


def test_figures_from_float32_fields_agree_within_tolerance(figs):
    _, port, jdrawn, tdrawn = figs
    checked = 0
    for name, draws in tdrawn.items():
        if name in PIXEL_EXACT or name == 'uniform/presence_P1.png':
            continue
        assert len(draws) == len(jdrawn[name])
        for got, want in zip(draws, jdrawn[name]):
            checked += _agree(name, got, want, port)
    # slope, aspect, 2 x 2 updrafts (thresholded and not), the threshold
    # function, 2 realizations' presence and the case's
    assert checked == 10


def _agree(name, got, want, port):
    """Asserts that one figure's drawn arrays agree; returns the number of
    arrays compared."""
    checked = 0
    assert len(got['images']) == len(want['images'])
    for g, w in zip(got['images'], want['images']):
        assert g.shape == w.shape
        if name == 'aspect.png':
            d = np.mod(g.astype(np.float64) - w, 360.)
            assert np.minimum(d, 360. - d).max() <= ATOL + RTOL * 360.
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                       err_msg=name)
        checked += 1
    if name == 'threshold_function.png':
        (gx, gy, _), = got['lines']
        (wx, wy, _), = want['lines']
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_allclose(gy, wy, rtol=RTOL, atol=ATOL)
        assert gy.max() > port.updraft_threshold
        checked += 1
    return checked


def test_windplant_map_and_turbine_overlay(figs):
    jax_sim, port, jdrawn, tdrawn = figs
    (got,), (want,) = tdrawn['uniform/presence_P1.png'], \
        jdrawn['uniform/presence_P1.png']
    np.testing.assert_allclose(got['images'][0], want['images'][0],
                               rtol=RTOL, atol=ATOL)
    # the turbines' projected coordinates agree to 1e-6 m
    np.testing.assert_allclose(got['xlim'], want['xlim'], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got['ylim'], want['ylim'], rtol=0, atol=1e-6)
    assert [ln[2] for ln in got['lines']] == [ln[2] for ln in
                                              want['lines']] == ['P1', 'P2']
    for g, w in zip(got['lines'], want['lines']):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g[1], w[1], rtol=0, atol=1e-6)
    overlays = []
    for sim in (jax_sim, port):
        fig, axs = plt.subplots()
        sim.plot_turbine_locations(axs, set_label=False, draw_box=True)
        overlays.append((
            [(np.asarray(ln.get_xdata()), ln.get_marker(), ln.get_label())
             for ln in axs.lines],
            [(p.get_x(), p.get_width()) for p in axs.patches]))
        plt.close(fig)
    (tlines, tboxes), (jlines, jboxes) = overlays[1], overlays[0]
    assert len(tlines) == len(jlines) == 2 and len(tboxes) == 2
    for g, w in zip(tlines, jlines):
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
        assert g[1:] == w[1:]
    np.testing.assert_allclose(tboxes, jboxes, rtol=0, atol=1e-6)


def test_save_fig_shown_leaves_the_figure_open(figs, tmp_path):
    port = figs[1]
    fig, axs = plt.subplots()
    try:
        fpath = str(tmp_path / 'shown.png')
        port.save_fig(fig, fpath, show_fig=True)
        assert plt.fignum_exists(fig.number)
        assert not os.path.exists(fpath)
        port.save_fig(fig, fpath)
        assert not plt.fignum_exists(fig.number)
        assert os.path.isfile(fpath)
    finally:
        plt.close(fig)


def test_fig_size_and_km_bar_equal_jax(figs):
    jax_sim, port, _, _ = figs
    assert port.fig_size == jax_sim.fig_size == (4. * 1.2, 4.)
    assert port.km_bar == jax_sim.km_bar == 1


def test_compute_presence_map_unchanged_by_the_move(figs):
    """The summary of the arithmetic that ``compute_presence_map`` ran
    before it moved to the figure layer, bit for bit, and its phase
    record."""
    port = figs[1]
    krad = int(round(min(max(1000. / port.resolution, 2),
                         min(port.gridsize) / 2)))
    want = np.zeros(port.gridsize, np.float64)
    for case_id in port.case_ids:
        case_prob = np.zeros(port.gridsize, np.float64)
        for real_id in range(1 + port.thermals_realization_count):
            counts = torch.from_numpy(port.get_presence_counts(
                case_id, real_id).astype(np.int32))
            prob = smooth_presence(counts, krad).numpy()
            case_prob += prob / np.amax(prob)
        want += case_prob / np.amax(case_prob)
    want = want / np.amax(want)
    got = port.compute_presence_map()
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.load(os.path.join(port.mode_data_dir, 'summary_presence.npy')),
        want.astype(np.float32))
    # the map's record, then the phase log's save after it
    assert [r['phase'] for r in port.timer.records[-2:]] == [
        'presence_map', 'save.phase_log']


def test_plot_presence_map_writes_the_same_summary(figs):
    """``plot_presence_map`` and ``compute_presence_map`` share the one
    writer of ``summary_presence.npy``."""
    port = figs[1]
    fpath = os.path.join(port.mode_data_dir, 'summary_presence.npy')
    want = port.compute_presence_map()
    os.remove(fpath)
    port.plot_presence_map()
    np.testing.assert_array_equal(np.load(fpath), want.astype(np.float32))


def test_the_package_imports_no_matplotlib():
    import subprocess
    import sys
    code = ('import sys, ssrs_tpu_torch, ssrs_tpu_torch.plotting, '
            'ssrs_tpu_torch.figstyle, ssrs_tpu_torch.utils, '
            'ssrs_tpu_torch.__main__; '
            'bad = [m for m in sys.modules if m.split(".")[0] in '
            '("matplotlib", "mpl_toolkits", "jax", "ssrs_tpu")]; '
            'assert not bad, bad')
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, '-c', code], cwd=repo, check=True)


# ---- the WTK layers of a snapshot run ---------------------------------------

YEAR = 2012
LAYERS = ['windspeed_100m', 'winddirection_100m', 'pressure_100m',
          'temperature_100m', 'boundary_layer_height',
          'surface_heat_flux']


@pytest.fixture(scope='module')
def wtk_template(tmp_path_factory):
    """A WTK-shaped archive for the first half of 2012 on a jittered
    0.02-degree lattice around the WY region (the fixture of
    ``tests/test_torch_modes.py``)."""
    fpath = str(tmp_path_factory.mktemp('wtk') / f'wtk_{YEAR}.h5')
    lats = np.linspace(42.70, 43.00, 16)
    lons = np.linspace(-106.30, -106.00, 16)
    lat_g, lon_g = np.meshgrid(lats, lons, indexing='ij')
    rng = np.random.default_rng(3)
    lat_g = lat_g + rng.uniform(-2e-3, 2e-3, lat_g.shape)
    lon_g = lon_g + rng.uniform(-2e-3, 2e-3, lon_g.shape)
    coords = np.stack([lat_g.ravel(), lon_g.ravel()], axis=1)
    hours = np.arange(24 * 182)[:, None]
    site = np.arange(coords.shape[0])[None, :]
    fields = {
        'windspeed_100m': 9. + 5. * np.sin(0.37 * hours + 0.05 * site),
        'winddirection_100m': np.mod(
            200. + 7. * hours + 300. * (lon_g.ravel()[None, :] + 106.15)
            + 200. * (lat_g.ravel()[None, :] - 42.85), 360.),
    }
    with h5py.File(fpath, 'w') as f:
        f.create_dataset('coordinates', data=coords)
        for name in LAYERS:
            vals = fields.get(name)
            if vals is None:
                vals = rng.uniform(1, 300, (hours.size, site.size))
            ds = f.create_dataset(name, data=(vals * 100.).astype('i4'))
            ds.attrs['scale_factor'] = 100.0
    return fpath.replace(str(YEAR), '$YEAR')


def test_plot_wtk_layers_in_a_snapshot_run(tmp_path, wtk_template):
    kw = dict(CONFIG, run_name='snap', sim_mode='snapshot',
              snapshot_datetime=(YEAR, 6, 17, 13),
              thermals_realization_count=0, wtk_source='LOCAL',
              wtk_local_template=wtk_template, wtk_local_years=(YEAR,),
              max_cores=2)
    jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
        out_dir=str(tmp_path / 'jax'), **kw))
    port = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        out_dir=str(tmp_path / 'port'), **kw), device='cpu')
    drawn = []
    for sim in (jax_sim, port):
        drawn.append(_capture(sim))
        sim.plot_wtk_layers()
    names = {f'snapshot/y2012m06d17h13_{lyr}.png' for lyr in LAYERS}
    assert _fig_names(port) == _fig_names(jax_sim) == names
    assert set(drawn[1]) == names
    for name in names:
        (tdraw,), (jdraw,) = drawn[1][name], drawn[0][name]
        got, want = tdraw['images'][0], jdraw['images'][0]
        assert got.shape == port.gridsize and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
        assert tdraw['xlim'] == (port.extent[0], port.extent[1])


# ---- the figure and filesystem helpers of utils.py --------------------------

@pytest.mark.parametrize('from_origin', [False, True])
@pytest.mark.parametrize('in_km', [False, True])
def test_extent_from_bounds_equals_jax(from_origin, in_km):
    from ssrs_tpu.utils import get_extent_from_bounds as jext
    from ssrs_tpu_torch.utils import get_extent_from_bounds as text
    bounds = (-1.25e6, 2.3e5, -1.19e6, 2.8e5)
    assert text(bounds, from_origin, in_km) == jext(bounds, from_origin,
                                                     in_km)


@pytest.mark.parametrize('arr', [np.array([[1], [2], [3]]), np.eye(2),
                                 np.arange(4.), 7.5])
@pytest.mark.parametrize('label', ['cov', '', None])
def test_pretty_str_equals_jax(arr, label):
    from ssrs_tpu.utils import pretty_str as jpretty
    from ssrs_tpu_torch.utils import pretty_str as tpretty
    assert tpretty(label, arr) == jpretty(label, arr)


def test_directory_helpers(tmp_path):
    from ssrs_tpu_torch.utils import (empty_this_directory,
                                      remove_all_dirs_in_this_dir)
    (tmp_path / 'a' / 'b').mkdir(parents=True)
    (tmp_path / 'c').mkdir()
    (tmp_path / 'f.txt').write_text('x')
    remove_all_dirs_in_this_dir(str(tmp_path))
    assert os.listdir(tmp_path) == ['f.txt']
    remove_all_dirs_in_this_dir(str(tmp_path / 'missing'))
    empty_this_directory(str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_create_gis_axis_equals_jax():
    """The GIS decor of both packages: the same artists, colorbar and
    legend on one image and one labeled line."""
    from ssrs_tpu.utils import create_gis_axis as jgis
    from ssrs_tpu_torch.utils import create_gis_axis as tgis
    drawn = []
    for gis in (jgis, tgis):
        fig, ax = plt.subplots(figsize=(4., 3.))
        im = ax.imshow(np.arange(12.).reshape(3, 4))
        ax.plot([0, 1], [0, 1], label='P1')
        cbar, legend = gis(fig, ax, im, km_bar=5.)
        drawn.append((len(fig.axes), [type(a).__name__ for a in
                                      ax.get_children()],
                      [t.get_text() for t in legend.get_texts()],
                      cbar.outline.get_visible(), ax.get_aspect()))
        plt.close(fig)
    assert drawn[0] == drawn[1]
    assert drawn[1][0] == 2 and drawn[1][2] == ['P1']
