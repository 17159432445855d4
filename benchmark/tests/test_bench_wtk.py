"""Snapshot and seasonal configurations (WTK winds) through the benchmark
on the CPU at a tiny cut: the stand-in read back through the program's
``LOCAL`` reader, the reference's sampler, winds and orograph against the
program's, whole runs judged correct, three faults and the control judged
not correct, the check's bounded sample of (job, case) pairs, and the
uniform judge's numbers unchanged, bit for bit.

The WTK cells are added to a copy of the benchmark as data files alone (a
configuration, a mix, limits and entries in ``BENCHMARK.json``)."""

import json
import os
import sys
import types
from datetime import date, datetime

import numpy as np
import pytest
import torch

from benchmark import cells, control, harness, judge, terrain, traffic
from benchmark import wtk, wtkref
from conftest import make_tiny_root

# the Appalachian example's region and season (NREL/SSRS
# examples/example_appalachian.py), cut to 60x50 cells at 200 m and 3
# cases of 1,000 tracks
SEASONAL = {
    'source': 'https://github.com/NREL/SSRS examples/example_appalachian.py',
    'why': 'the seasonal mode at a tiny cut', 'assumed': [], 'reduced': [],
    'sim_mode': 'seasonal', 'southwest_lonlat': [-79.7, 39.0],
    'projected_crs': 'ESRI:102008', 'region_width_km': [12.0, 10.0],
    'resolution': 200.0, 'seasonal_start': [3, 1], 'seasonal_end': [6, 1],
    'seasonal_timeofday': 'daytime', 'seasonal_count': 3,
    'wtk_orographic_height': 100, 'wtk_thermal_height': 100,
    'wtk_interp_type': 'linear',
    'wtk_standin': {'years': [2012], 'seed': 7, 'spacing_km': 2.0},
    'thermals_realization_count': 0, 'updraft_threshold': 0.75,
    'movement_model': 'fluidflow', 'track_direction': 0.0,
    'track_start_region': [1.0, 11.0, 0.0, 1.0],
    'track_start_type': 'random', 'track_stochastic_nu': 1.0,
    'track_dirn_restrict': 1, 'track_max_steps': 300,
    'potential_solver': 'auto', 'potential_tol': 1e-07,
    'track_weight_precision': 'auto'}
SNAPSHOT = {k: v for k, v in SEASONAL.items() if not k.startswith('seas')}
SNAPSHOT.update(sim_mode='snapshot', snapshot_datetime=[2010, 6, 17, 13],
                wtk_standin={'years': [2010], 'seed': 7, 'spacing_km': 2.0})
CONFIGS = {'tiny_seasonal': SEASONAL, 'tiny_snapshot': SNAPSHOT}
MIX = {'tracks_per_case': 1000, 'share_potentials': False,
       'why': 'whole runs, a new Simulator a job'}
# Limits of the tiny cut, from its readings on this CPU (one thread):
# - updraft_gap, summary_gap: the cells' own (sound runs read 2e-5-6e-5
#   and 2e-7-7e-7; the control 1.0-1.2 and 7e-3-9e-3);
# - potential_resid: the refined solve stops inside the program's 5e-3
#   net on a few of these patchy fields (4 of 39 seasonal solves read
#   4.9e-4-1.5e-2; the rest 5e-5-1.5e-4); the control reads 3.1-3.6;
# - counts: 1-3 pooled pairs of 1,000 tracks read counts_l1 0.025-0.068
#   and counts_mass up to 0.012.
LIMITS = {'updraft_gap': 1e-3, 'potential_resid': 0.1, 'counts_l1': 0.2,
          'counts_mass': 0.05, 'summary_gap': 1e-5}


def add_wtk_cells(root: str) -> str:
    """The WTK cells ``tiny_seasonal.run`` and ``tiny_snapshot.run``
    added to the benchmark copy at ``root`` as data files and entries."""
    bench = os.path.join(root, 'benchmark')
    with open(os.path.join(root, 'BENCHMARK.json'), encoding='utf-8') as f:
        spec = json.load(f)
    with open(os.path.join(bench, 'traffic', 'wtkrun.json'), 'w',
              encoding='utf-8') as f:
        json.dump(MIX, f)
    for name, doc in CONFIGS.items():
        cell = f'{name}.run'
        with open(os.path.join(bench, 'configs', f'{name}.json'), 'w',
                  encoding='utf-8') as f:
            json.dump(doc, f)
        with open(os.path.join(bench, 'limits', f'{cell}.json'), 'w',
                  encoding='utf-8') as f:
            json.dump(LIMITS, f)
        spec['configs'].append({
            'name': name, 'source': doc['source'],
            'file': f'benchmark/configs/{name}.json', 'reduced': [],
            'why': doc['why']})
        spec['workloads'].append({
            'name': cell, 'config': name, 'traffic': 'wtkrun', 'chips': 1,
            'why': 'whole WTK runs at a tiny cut'})
        for m in spec['end_to_end'] + spec['per_layer']:
            if m['name'] in ('run_s', 'solve_s.run', 'updrafts_s.run'):
                m['workloads'].append(cell)
    with open(os.path.join(root, 'BENCHMARK.json'), 'w',
              encoding='utf-8') as f:
        json.dump(spec, f)
    return root


@pytest.fixture
def wtk_root(tmp_path):
    return add_wtk_cells(make_tiny_root(str(tmp_path)))


def _standin(cfg, dest):
    """The stand-in of ``cfg`` written under ``dest``: (template, lat,
    lon, region lon/lat bounds)."""
    lonlat = terrain.region(cfg)[2]
    lat, lon = wtk.sites(lonlat, 2.0, 7)
    template = os.path.join(dest, 'standin_$YEAR.wtk')
    wtk.write(template.replace('$YEAR', '2012'), lat, lon,
              wtk.year_hours(2012), wtk.layer_names(cfg))
    return template, lat, lon, lonlat


def _frame(template, lonlat, names, out_dir, when):
    from ssrs_tpu_torch.data import WTK
    client = WTK('LOCAL', lonlat, names, out_dir, local_template=template,
                 local_years=[2012])
    return client.get_dataframe_for_this_time(when)


def test_standin_through_the_program_reader(tmp_path):
    """The program's LOCAL reader takes the reference's sites from the
    stand-in and reads the values the reference computes, every layer,
    at several hours."""
    template, lat, lon, lonlat = _standin(SEASONAL, str(tmp_path))
    names = wtk.layer_names(SEASONAL)
    idx = wtkref.read_sites(lat, lon, lonlat)
    assert 0 < len(idx) < len(lat)
    saved = sys.modules.get('h5py')
    with wtk.reader_installed():
        for k, when in enumerate([datetime(2012, 1, 1, 0),
                                  datetime(2012, 4, 5, 13),
                                  datetime(2012, 12, 31, 23)]):
            df = _frame(template, lonlat, names, str(tmp_path / f'c{k}'),
                        when)
            assert np.array_equal(np.asarray(df['Indices']), idx)
            assert np.array_equal(np.asarray(df['Latitude']), lat[idx])
            hour = wtkref.hour_of_year(when)
            for name in names:
                assert np.array_equal(np.asarray(df[name]), wtk.values(
                    name, hour, lat[idx], lon[idx])), (when, name)
    assert sys.modules.get('h5py') is saved


def test_standin_layout_is_what_h5py_gives(tmp_path):
    """The same arrays written as a real HDF5 file read the same frame
    through the program's reader and h5py."""
    h5py = pytest.importorskip('h5py')
    template, lat, lon, lonlat = _standin(SEASONAL, str(tmp_path))
    names = wtk.layer_names(SEASONAL)
    real = str(tmp_path / 'real_$YEAR.h5')
    with h5py.File(real.replace('$YEAR', '2012'), 'w') as fobj:
        fobj.create_dataset('coordinates', data=np.stack([lat, lon], 1))
        hours = np.arange(wtk.year_hours(2012))
        for name in names:
            dset = fobj.create_dataset(
                name, data=wtk.raw(name, hours[:, None], lat, lon))
            dset.attrs['scale_factor'] = wtk.scale_of(name)
    when = datetime(2012, 5, 17, 9)
    got = _frame(real, lonlat, names, str(tmp_path / 'h5'), when)
    with wtk.reader_installed():
        want = _frame(template, lonlat, names, str(tmp_path / 'w'), when)
    for col in ['Indices', 'Longitude', 'Latitude'] + names:
        assert np.array_equal(np.asarray(got[col]), np.asarray(want[col]))


@pytest.mark.parametrize('seed', [0, 7, 2 ** 31 + 11, 2 ** 55 + 3])
@pytest.mark.parametrize('season,tod', [
    (((3, 1), (6, 1)), 'daytime'), (((3, 20), (5, 15)), 'morning'),
    (((6, 1), (8, 31)), 'afternoon'), (((10, 1), (12, 1)), 'evening')])
def test_sampler_matches_the_program(seed, season, tod):
    """The frozen sampler draws the program's datetimes from a seed, and
    leaves the generator where the program's does."""
    from ssrs_tpu_torch.utils import get_seasonal_datetimes_list
    lonlat = (-79.7, 39.0)
    rng_a = np.random.default_rng(seed)
    rng_b = np.random.default_rng(seed)
    got = wtkref.seasonal_datetimes([2011, 2012], *season, tod, 8, lonlat,
                                    rng_a)
    want = get_seasonal_datetimes_list([2011, 2012], *season, tod, 8,
                                       lonlat, rng_b)
    assert sorted(got) == sorted(want) and len(got) == 8
    assert rng_a.random() == rng_b.random()


def test_sunrise_matches_the_program():
    from ssrs_tpu_torch.utils import get_sunrise_sunset_time
    for lonlat in [(-79.7, 39.0), (-106.21, 42.78), (-121.98, 37.56)]:
        for day in range(1, 365, 17):
            when = date.fromordinal(date(2012, 1, 1).toordinal() + day)
            assert wtkref.sunrise_sunset(lonlat, when) == \
                get_sunrise_sunset_time(lonlat, when)


@pytest.fixture(scope='module')
def seasonal_job(tmp_path_factory):
    """One seasonal job of the tiny cut on the CPU: (Traffic, Job)."""
    torch.set_num_threads(1)
    workdir = str(tmp_path_factory.mktemp('seasonal'))
    gen = traffic.Traffic(SEASONAL, MIX, 5, workdir, 'cpu')
    gen.setup()
    job = gen.job(0)
    assert not job.failed, job.failed
    yield gen, job
    gen.close()


def test_cases_are_the_references(seasonal_job):
    gen, job = seasonal_job
    assert sorted(job.cases) == sorted(wtkref.cases(SEASONAL, job.seed))
    assert len(job.cases) == SEASONAL['seasonal_count']


def test_winds_match_the_program(seasonal_job):
    """The reference's winds on the grid against the program's scipy
    ``griddata`` of the same sites, both float64: the two only differ in
    their ESRI:102008 code and the order of the barycentric sums, ~1e-12
    of a wind."""
    gen, job = seasonal_job
    sim = gen.sim
    winds = wtkref.Winds(SEASONAL, 'cpu')
    names = wtk.layer_names(SEASONAL)
    for case, when in wtkref.cases(SEASONAL, job.seed).items():
        df = sim.wtk.get_dataframe_for_this_time(when)
        speed, dirn = sim._get_interpolated_wind_conditions(df[names[0]],
                                                            df[names[1]])
        ws, wd = winds.at(when)
        assert np.abs(ws.numpy() - speed).max() < 1e-9, case
        gap = np.abs(wd.numpy() - dirn)
        assert np.minimum(gap, 360. - gap).max() < 1e-7, case


def test_orograph_matches_the_program(seasonal_job):
    """The program's thresholded updraft of each case against the
    reference's: float32 winds, stencil and raster path against float64,
    within the cells' ``updraft_gap`` limit (sound cell runs read ~1e-4)."""
    gen, job = seasonal_job
    fields = wtkref.Fields(SEASONAL, gen.dem, gen.dem_bounds, 'cpu')
    for case, when in wtkref.cases(SEASONAL, job.seed).items():
        got = gen.case_fields(job, case, 'cpu')[0].double()
        want = fields.thresholded(when)
        assert float((got - want).abs().max()) < 1e-3, case
        assert float(want.abs().max()) > 0.75


@pytest.mark.parametrize('cell', ['tiny_seasonal.run', 'tiny_snapshot.run'])
def test_wtk_cell_is_correct(wtk_root, cell, one_thread):
    res = harness.run_cell(wtk_root, cell, 2 ** 31 + 17, 0.5, False, 'cpu')
    assert res['correct'] is True, res['checks']
    assert set(res['checks']) == set(judge.NAMES)
    assert set(res['metrics']) == {'run_s', 'setup_s'}


def _rotated_winds(mp):
    """The first case of every job under winds turned by 10 degrees."""
    from ssrs_tpu_torch.simulator import Simulator
    orig = Simulator._get_interpolated_wind_conditions

    def rotated(self, wspeed, wdirn):
        speed, dirn = orig(self, wspeed, wdirn)
        self._rotated = getattr(self, '_rotated', 0) + 1
        if self._rotated == 1:
            dirn = np.mod(dirn + 10., 360.)
        return speed, dirn

    mp.setattr(Simulator, '_get_interpolated_wind_conditions', rotated)


def _datetime_swapped(mp):
    """One of every run's datetimes moved by an hour."""
    from datetime import timedelta
    from ssrs_tpu_torch.simulator import Simulator
    orig = Simulator.get_seasonal_datetimes

    def swapped(self):
        out = orig(self)
        return [out[0] + timedelta(hours=1)] + out[1:]

    mp.setattr(Simulator, 'get_seasonal_datetimes', swapped)


def _starts_first(mp):
    """The tracks' starts drawn from the run's generator before the
    datetimes."""
    from ssrs_tpu_torch.simulator import Simulator
    orig_dt, orig_starts = Simulator.get_seasonal_datetimes, \
        Simulator._starts

    def datetimes(self):
        self._early_starts = orig_starts(self)
        return orig_dt(self)

    mp.setattr(Simulator, 'get_seasonal_datetimes', datetimes)
    mp.setattr(Simulator, '_starts', lambda self: self._early_starts)


def _half_left_out(mp):
    """Half of the agents left out of the recording driver, which a case
    of at most ``track_pkl_budget`` tracks runs on."""
    from ssrs_tpu_torch import simulator
    orig = simulator.simulate_tracks_recorded

    def half(params, starts, *a, **k):
        return orig(params, starts[:len(starts) // 2], *a, **k)

    mp.setattr(simulator, 'simulate_tracks_recorded', half)


@pytest.mark.parametrize('fault,number', [
    (_rotated_winds, 'updraft_gap'), (_datetime_swapped, 'updraft_gap'),
    (_starts_first, 'updraft_gap'), (_half_left_out, 'counts_mass')],
    ids=lambda f: f.__name__[1:] if callable(f) else f)
def test_wtk_fault_is_not_correct(wtk_root, fault, number, monkeypatch,
                                  one_thread):
    fault(monkeypatch)
    res = harness.run_cell(wtk_root, 'tiny_seasonal.run', 2 ** 31 + 17, 0.5,
                           False, 'cpu')
    assert res['correct'] is False, res['checks']
    assert res['checks'][number]['value'] > LIMITS[number]


def test_wtk_control_is_not_correct(wtk_root):
    limits = cells.load_limits(wtk_root, 'tiny_seasonal.run')
    for r in control.readings(wtk_root, 'tiny_seasonal.run', [3, 4, 5],
                              'cpu', jobs=2):
        correct, checks = judge.verdict(r['numbers'], limits)
        assert not correct, checks


def test_wtk_table_only_control_differs_in_counts_alone(wtk_root):
    for r in control.readings(wtk_root, 'tiny_seasonal.run', [3], 'cpu',
                              table_only=True):
        n = r['numbers']
        assert n['updraft_gap'] < 1e-6 and n['potential_resid'] < 1e-9
        assert n['summary_gap'] < 1e-12 and n['counts_l1'] > 0


def test_check_reads_a_bounded_sample(monkeypatch, one_thread, tmp_path):
    """With a sample of 2 pairs, a window of two 3-case jobs has two
    expectations worked out, one group each, and every field judged."""
    from benchmark import reference as ref
    monkeypatch.setattr(judge, 'COUNT_PAIRS', 2)
    groups, fields = [], set()
    orig = ref.expected_counts

    def counted(trans, starts, *a, **k):
        groups.append((trans.dim(), starts.shape[0]))
        return orig(trans, starts, *a, **k)

    monkeypatch.setattr(ref, 'expected_counts', counted)
    orig_fields = traffic.Traffic.case_fields

    def case_fields(self, job, case, device):
        fields.add((job.label, case))
        return orig_fields(self, job, case, device)

    monkeypatch.setattr(traffic.Traffic, 'case_fields', case_fields)
    gen = traffic.Traffic(SEASONAL, MIX, 23, str(tmp_path), 'cpu')
    try:
        gen.setup()
        sample = judge.PairSample(23)
        jobs = [gen.job(k) for k in range(2)]
        for j in jobs:
            for job, cases, summary in sample.add(j):
                gen.drop_outputs(job, cases, summary)
        correct, checks = harness.check(gen, SEASONAL, LIMITS, jobs, sample,
                                        'cpu')
    finally:
        gen.close()
    assert correct, checks
    assert groups == [(4, 1), (4, 1)]
    assert fields >= {(j.label, c) for j in jobs for c in j.cases}


def _jobs(n, cases=3):
    return [types.SimpleNamespace(label=k, cases=[f'c{k}_{i}'
                                                  for i in range(cases)])
            for k in range(n)]


def test_pair_sample():
    """At most COUNT_PAIRS pairs and one summary job, the same for a seed,
    each pair as likely as any; every count that neither needs is given
    back for its file to go, and none that they need."""
    k, jobs = judge.COUNT_PAIRS, _jobs(30)

    def run(seed):
        sample, dropped = judge.PairSample(seed), set()
        for j in jobs:
            for job, cases, summary in sample.add(j):
                assert summary and job is not sample.summary_job
                dropped |= {(job.label, c) for c in cases}
        kept = {(j.label, c) for j, c in sample.kept}
        assert len(kept) == k and not kept & dropped
        every = {(j.label, c) for j in jobs for c in j.cases}
        whole = {(sample.summary_job.label, c)
                 for c in sample.summary_job.cases}
        assert every - dropped == kept | whole
        return sorted(kept), sample.summary_job.label

    assert run(3) == run(3)
    hits = {}
    for seed in range(1500):
        for pair in run(seed)[0]:
            hits[pair] = hits.get(pair, 0) + 1
    expect = 1500 * k / 90
    assert len(hits) == 90
    assert min(hits.values()) > 0.7 * expect
    assert max(hits.values()) < 1.3 * expect


UNIFORM = [w['name'] for w in cells.load_spec(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))['workloads']]


@pytest.mark.parametrize('cell', UNIFORM)
def test_uniform_numbers_are_the_frozen_arithmetic(tiny_root, cell,
                                                    one_thread, tmp_path):
    """A uniform cell's five numbers from the check equal, bit for bit,
    those of the judge's arithmetic before it judged by case."""
    import frozen_uniform_judge as frozen
    spec = cells.load_spec(tiny_root)
    w = cells.find_cell(spec, cell)
    cfg = cells.load_config(tiny_root, spec, w['config'])
    mix = cells.load_traffic(tiny_root, w['traffic'])
    workdir = str(tmp_path / 'run')
    os.makedirs(workdir)
    gen = traffic.Traffic(cfg, mix, 31, workdir, 'cpu')
    try:
        gen.setup()
        jobs = [gen.job(k) for k in range(2)]
        sample = judge.Sample(31)
        for j in jobs:
            assert sample.add(j) is None
        want = frozen.check_numbers(gen, cfg, jobs, sample.kept, 'cpu')
        _, checks = harness.check(gen, cfg, cells.load_limits(
            tiny_root, cell), jobs, sample, 'cpu')
    finally:
        gen.close()
    assert {n: c['value'] for n, c in checks.items()} == want
