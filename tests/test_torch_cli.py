"""``python -m ssrs_tpu_torch`` (``ssrs_tpu_torch/__main__.py``), the
counterpart of ``tests/test_cli.py``, on the CPU (``--device cpu``).

A run JSON that a ``Simulator`` of either package wrote re-runs through
the port's CLI; the JAX package's own CLI refuses it (ROADMAP.md
section 3), which the last test pins beside it."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import requests
import torch

import ssrs_tpu
import ssrs_tpu.__main__ as jax_cli
import ssrs_tpu_torch
from ssrs_tpu_torch.__main__ import DERIVED_KEYS, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(
    sim_mode='uniform', sim_seed=5, southwest_lonlat=[-106.21, 42.78],
    region_width_km=[4., 3.], resolution=100., uniform_winddirn=270.,
    uniform_windspeed=10., track_direction=0., track_count=50,
    track_start_region=[1., 3., 0.5, 1.], fig_dpi=30, fig_height=3.)
ID = 's10d270_d0_t75_fluidflow_r0'


def _offline(*args, **kwargs):
    raise requests.exceptions.ConnectionError('network disabled in tests')


@pytest.fixture(scope='module', autouse=True)
def _no_network():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(requests, 'get', _offline)
        yield


@pytest.fixture(scope='module', autouse=True)
def _one_thread():
    """The refined solve's many small ops crawl on a thread pool whose
    cores other test workers hold (``tests/test_torch_potential.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write(path, **kw):
    path.write_text(json.dumps(kw))
    return str(path)


def _outputs(out_dir, run_name):
    data = os.path.join(out_dir, run_name, 'data', 'uniform')
    return (np.load(os.path.join(data, f'{ID}_counts.npy')),
            np.load(os.path.join(data, 'summary_presence.npy')))


def test_info_runs(capsys):
    assert main(['info']) == 0
    out = capsys.readouterr().out
    assert f'torch {torch.__version__}' in out
    assert f'cuda available: {torch.cuda.is_available()}' in out
    assert out.startswith(f'ssrs_tpu_torch {ssrs_tpu_torch.__version__}')


def test_info_as_a_module():
    run = subprocess.run([sys.executable, '-m', 'ssrs_tpu_torch', 'info'],
                         cwd=REPO, capture_output=True, text=True,
                         check=True)
    assert 'cuda available' in run.stdout


def test_run_rejects_unknown_fields(tmp_path):
    cfg = _write(tmp_path / 'bad.json', run_name='x', not_a_field=1)
    with pytest.raises(SystemExit, match='not_a_field'):
        main(['run', cfg, '--device', 'cpu'])
    listed = tmp_path / 'list.json'
    listed.write_text('[1, 2]')
    with pytest.raises(SystemExit, match='JSON object'):
        main(['run', str(listed), '--device', 'cpu'])


def test_run_tiny_on_the_cpu(tmp_path, capsys):
    """A whole run with figures: the artifacts and the figures of
    ``ssrs_tpu``'s CLI run."""
    out = str(tmp_path / 'out')
    cfg = _write(tmp_path / 'tiny.json', run_name='cli_tiny', out_dir=out,
                 **TINY)
    assert main(['run', cfg, '--device', 'cpu']) == 0
    run_dir = tmp_path / 'out' / 'cli_tiny'
    data = run_dir / 'data' / 'uniform'
    assert capsys.readouterr().out.rstrip().endswith(
        f'run complete: {os.path.join(out, "cli_tiny", "data/", "uniform")}')
    assert {p.name for p in data.iterdir()} == {
        's10d270_orograph.npy', f'{ID}_potential.npy', f'{ID}_tracks.pkl',
        f'{ID}_counts.npy', 'summary_presence.npy'}
    figs = {str(p.relative_to(run_dir / 'figs'))
            for p in (run_dir / 'figs').rglob('*.png')}
    assert figs == {'elevation.png', 'slope.png', 'aspect.png',
                    f'uniform/{ID}_tracks.png',
                    'uniform/s10d270_d0_t75_fluidflow_presence.png'}
    counts, summary = _outputs(out, 'cli_tiny')
    assert counts.sum() >= 50 and summary.max() == 1.0


@pytest.mark.parametrize('knob', [
    dict(track_step_impl='xla'), dict(track_presence_impl='scatter'),
    dict(track_step_impl='xla', track_presence_impl='scatter',
         track_tail_bucket='auto')])
def test_refused_engine_knobs_fail_before_any_output(tmp_path, knob):
    """The knobs of ``tests/test_cli.py`` that the port does not run raise
    ``_check_slice``'s error before a directory is made."""
    out = tmp_path / 'out'
    cfg = _write(tmp_path / 'knobs.json', run_name='cli_knobs',
                 out_dir=str(out), **TINY, track_max_steps=120,
                 track_pkl_budget=0, **knob)
    with pytest.raises(NotImplementedError, match='one engine'):
        main(['run', cfg, '--no-plots', '--device', 'cpu'])
    assert not out.exists()


@pytest.mark.parametrize('knob', [
    dict(track_tail_bucket='auto'), dict(potential_solver='mg'),
    dict(potential_batch=4)])
def test_run_takes_the_solver_options(tmp_path, knob):
    """The options the port once refused run from a JSON on their own:
    the self-tuned tail, the legacy multigrid, a batch cap (one case, so
    the single solve)."""
    out = tmp_path / 'out'
    cfg = _write(tmp_path / 'options.json', run_name='cli_options',
                 out_dir=str(out), **TINY, track_max_steps=120,
                 track_pkl_budget=0, **knob)
    assert main(['run', cfg, '--no-plots', '--device', 'cpu']) == 0
    counts, summary = _outputs(out, 'cli_options')
    assert counts.sum() >= TINY['track_count'] and summary.max() == 1.0
    with open(out / 'cli_options' / 'cli_options.json') as fobj:
        saved = json.load(fobj)
    assert all(saved[k] == v for k, v in knob.items())


def test_run_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the run would go to it')
    out = tmp_path / 'out'
    cfg = _write(tmp_path / 'tiny.json', run_name='cli_card',
                 out_dir=str(out), **TINY)
    for argv in (['run', cfg], ['run', cfg, '--no-plots']):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            main(argv)
    assert not out.exists()


def test_run_without_matplotlib_fails_before_any_output(tmp_path,
                                                        monkeypatch):
    """No figures without matplotlib: ``run`` raises the ImportError before
    it builds the Simulator; ``--no-plots`` runs."""
    monkeypatch.setitem(sys.modules, 'matplotlib', None)
    monkeypatch.setitem(sys.modules, 'matplotlib.pyplot', None)
    out = tmp_path / 'out'
    cfg = _write(tmp_path / 'tiny.json', run_name='cli_nompl',
                 out_dir=str(out), **TINY)
    with pytest.raises(ImportError):
        main(['run', cfg, '--device', 'cpu'])
    assert not out.exists()
    assert main(['run', cfg, '--no-plots', '--device', 'cpu']) == 0
    assert not list((out / 'cli_nompl' / 'figs').rglob('*.png'))


def test_saved_run_json_of_either_package_reruns(tmp_path):
    """The JSON a ``Simulator`` writes, with its four derived keys, re-runs
    through the port's CLI: the JAX package's and the port's own. The JAX
    package's CLI refuses the JSON its own Simulator wrote."""
    jax_sim = ssrs_tpu.Simulator(ssrs_tpu.Config(
        run_name='from_jax', out_dir=str(tmp_path / 'jax'), **TINY))
    port_sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        run_name='from_port', out_dir=str(tmp_path / 'port'), **TINY),
        device='cpu')
    saved = {}
    for sim in (jax_sim, port_sim):
        path = os.path.join(sim.out_dir, sim.run_name,
                            f'{sim.run_name}.json')
        with open(path) as fobj:
            saved[sim.run_name] = (path, json.load(fobj))
    jkeys, tkeys = (set(saved[n][1]) for n in ('from_jax', 'from_port'))
    assert jkeys == tkeys and set(DERIVED_KEYS) <= tkeys
    with pytest.raises(SystemExit, match='unknown Config field'):
        jax_cli.main(['run', saved['from_jax'][0], '--no-plots'])
    for name, (path, raw) in saved.items():
        assert main(['run', path, '--no-plots', '--device', 'cpu']) == 0
        counts, summary = _outputs(raw['out_dir'], name)
        assert counts.sum() >= 50 and summary.max() == 1.0


def test_cli_run_equals_the_in_process_run(tmp_path):
    """Counts and summary of a CLI run, bit for bit those of the same
    config through ``Simulator`` in the process."""
    cfg = _write(tmp_path / 'tiny.json', run_name='same',
                 out_dir=str(tmp_path / 'cli'), **TINY)
    assert main(['run', cfg, '--no-plots', '--device', 'cpu']) == 0
    sim = ssrs_tpu_torch.Simulator(ssrs_tpu_torch.Config(
        run_name='same', out_dir=str(tmp_path / 'lib'),
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in TINY.items()}), device='cpu')
    sim.simulate_tracks()
    sim.compute_presence_map()
    for got, want in zip(_outputs(str(tmp_path / 'cli'), 'same'),
                         _outputs(str(tmp_path / 'lib'), 'same')):
        np.testing.assert_array_equal(got, want)
