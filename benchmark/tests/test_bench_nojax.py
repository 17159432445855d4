"""The check that a run loaded neither JAX nor the JAX package: top-level
names compared whole, so the port (``ssrs_tpu_torch``) passes."""

import sys
import types

from benchmark import harness


def test_names_compared_whole(monkeypatch):
    for name in ('ssrs_tpu_torch', 'ssrs_tpu_torch.agents', 'jaxtyping',
                 'ssrs_tpu_torchx'):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == [
        m for m in sorted(sys.modules)
        if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ssrs_tpu')]
    clean = harness.forbidden_modules()
    for name in ('ssrs_tpu', 'ssrs_tpu.agents', 'jax.numpy', 'jaxlib',
                 'flax'):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    found = harness.forbidden_modules()
    assert set(found) - set(clean) == {'ssrs_tpu', 'ssrs_tpu.agents',
                                       'jax.numpy', 'jaxlib', 'flax'}


def test_benchmark_and_port_load_no_jax():
    """The benchmark's modules and the port import no JAX (checked in a
    fresh interpreter: the test process may hold JAX for other tests)."""
    import subprocess
    from conftest import REPO
    code = ('import sys; sys.path.insert(0, %r); '
            'from benchmark import harness, judge, control, traffic, '
            'reference, devtrace; import ssrs_tpu_torch; '
            'from ssrs_tpu_torch import Simulator; '
            'print(harness.forbidden_modules())' % REPO)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == '[]'
