"""The port's chunk kernel (T agent steps per launch) on the CPU.

- ``fused_chunk`` (the wrapper, which runs ``fused_chunk_plain`` on CPU
  tensors) against T steps of the JAX package's ``make_step_fn`` with
  ``step_impl='fused-interpret'`` (the Pallas kernel in interpret mode),
  from one state (``state_from_numpy``) with the same injected uniforms:
  exactly, at nu in {0, 1}, memory k in {0, 1, 3}, both table dtypes, over
  windows that cross the burn-in and one that runs past the step cap.
- The emission rows equal those the per-step recording loop writes.
- Both chunked drivers give bit-identical presence, steps and tracks to
  the per-step loops they replace (kept here as the reference), with the
  uniform block forced small so that a chunk takes several launches; on
  the CPU one ``(T, N)`` draw gives the numbers of T draws of N.
- The wrapper's operand checks, and no launches on the CPU.
Tests of the CUDA kernel itself need the card (``tests/test_torch_gpu.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssrs_tpu.agents import simulate as jsim
from ssrs_tpu.agents.moves import directional_probs, restriction_table

from ssrs_tpu_torch import native as tnative
from ssrs_tpu_torch.agents import fused_chunk as fc
from ssrs_tpu_torch.agents import simulate as tsim

GRID = (48, 56)
N = 1024            # one block of the JAX kernel
BURNIN = 3
NSTEPS = 16
# steps 0-4 cross the burn-in, 5-11, then 12-19 run 4 steps past the cap
WINDOWS = (5, 7, 8)


def _fields():
    nrow, ncol = GRID
    y = np.linspace(0, np.pi, nrow)[:, None]
    x = np.linspace(0, 2 * np.pi, ncol)[None, :]
    updraft = (1.0 + 0.8 * np.sin(x) * np.sin(y)).astype(np.float32)
    potential = (np.linspace(1000., 0., nrow)[:, None]
                 * np.ones((1, ncol))).astype(np.float32)
    return updraft, potential


def _jax_table(dtype):
    up, pot = _fields()
    return jsim.prepared_weights(jnp.asarray(up), jnp.asarray(pot),
                                 jnp.asarray(directional_probs(0.)), dtype)


def _to_port(params, state):
    return tsim.state_from_numpy(
        params, np.asarray(state.pos_r), np.asarray(state.pos_c),
        np.asarray(state.mem), np.asarray(state.alive),
        np.asarray(state.palive), np.asarray(state.step),
        np.asarray(state.presence), device='cpu')


def _assert_same(params, js, ts):
    nrow, ncol = params.grid_shape
    np.testing.assert_array_equal(ts.pos_r.numpy(), np.asarray(js.pos_r))
    np.testing.assert_array_equal(ts.pos_c.numpy(), np.asarray(js.pos_c))
    np.testing.assert_array_equal(ts.mem.numpy(), np.asarray(js.mem))
    np.testing.assert_array_equal(ts.alive.numpy(), np.asarray(js.alive))
    np.testing.assert_array_equal(ts.palive.numpy(),
                                  np.asarray(js.palive) != 0)
    np.testing.assert_array_equal(
        ts.presence.numpy(), np.asarray(js.presence)[:nrow, :ncol])
    assert ts.step == int(js.step)


def _restr_dirp():
    return (torch.from_numpy(restriction_table()),
            torch.from_numpy(directional_probs(0.)))


def _chunk(params, table, state, u, emit=None, fn=fc.fused_chunk):
    """One chunk of ``u.shape[0]`` steps through ``fn``, in place; the
    state with its counter advanced."""
    restr, dirp = _restr_dirp()
    fn(table, restr, dirp, state.pos_r, state.pos_c, state.mem, state.alive,
       state.palive, u, state.presence, nu=params.nu,
       memory_k=params.memory_k, s0=state.step, burnin=params.burnin,
       nsteps=params.nsteps, emit=emit)
    state.step = min(state.step + u.shape[0], params.nsteps)
    return state


def _starts(rng, n):
    """Starts over the whole grid (the border rows and columns included),
    10% of them invalid: some agents die at the boundary in each window."""
    nrow, ncol = GRID
    starts = np.stack([rng.integers(0, nrow, n), rng.integers(0, ncol, n)],
                      axis=1).astype(np.int32)
    return starts, rng.random(n) < 0.9


@pytest.mark.parametrize('nu', [1.0, 0.0])
@pytest.mark.parametrize('k,dtype', [(0, 'float32'), (1, 'float32'),
                                     (3, 'float32'), (0, 'bfloat16'),
                                     (1, 'bfloat16'), (3, 'bfloat16')])
def test_chunk_exact_vs_jax_steps(k, dtype, nu):
    rng = np.random.default_rng(200 + 10 * k + int(nu))
    jp = jsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=nu, memory_k=k,
                          burnin=BURNIN, nsteps=NSTEPS, weight_dtype=dtype,
                          step_impl='fused-interpret')
    tp = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=nu, memory_k=k,
                          burnin=BURNIN, nsteps=NSTEPS, weight_dtype=dtype)
    table = _jax_table(dtype)
    jstep = jsim.make_step_fn(jp, table, jnp.asarray(directional_probs(0.)),
                              jnp.asarray(restriction_table()))
    ttable = tsim.weights_from_numpy(np.asarray(table), 'cpu')
    starts, valid = _starts(rng, N)
    js = jsim.init_state(jp, starts, jax.random.key(0), valid=valid)
    ts = _to_port(tp, js)
    n_alive = []
    for t_len in WINDOWS:
        u = rng.random((t_len, N)).astype(np.float32)
        emit = (torch.zeros((t_len, N, 2), dtype=torch.int16),
                torch.zeros((t_len, N), dtype=torch.bool))
        ts = _chunk(tp, ttable, ts, torch.from_numpy(u), emit)
        for t in range(t_len):
            js = jstep(js, u=jnp.asarray(u[t]))
            np.testing.assert_array_equal(emit[0][t].numpy(),
                                          np.asarray(js.pos).astype(np.int16))
            np.testing.assert_array_equal(emit[1][t].numpy(),
                                          np.asarray(js.alive))
        _assert_same(tp, js, ts)
        n_alive.append(int(ts.alive.sum()))
    # agents died at the boundary before the cap, and nobody is alive
    # past it
    assert int(valid.sum()) > n_alive[0] > n_alive[1] > 0 == n_alive[2]


def _emission_buffer(t_len, b, seed):
    """A chunk's emission buffer filled with noise, and its views."""
    noise = np.random.default_rng(seed).integers(0, 256, 5 * t_len * b
                                                 + 4 * b, dtype=np.uint8)
    buf = torch.from_numpy(noise)
    return buf, tsim._split_emissions(buf, t_len, b, tsim._TORCH_VIEWS)


@pytest.mark.parametrize('k,dtype', [(0, 'float32'), (1, 'bfloat16'),
                                     (3, 'float32')])
def test_emission_rows_equal_per_step_recording(k, dtype):
    """The chunk's emission rows, byte for byte, against the rows the
    per-step recording loop writes (positions as int16, alive flags), on
    windows that cross the burn-in and run past the cap."""
    rng = np.random.default_rng(300 + k)
    tp = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1., memory_k=k,
                          burnin=BURNIN, nsteps=NSTEPS, weight_dtype=dtype)
    up, pot = _fields()
    restr, dirp = _restr_dirp()
    table = tsim.prepared_weights(torch.from_numpy(up),
                                  torch.from_numpy(pot), dirp, dtype)
    step = tsim.make_step_fn(tp, table, dirp, restr)
    starts, valid = _starts(rng, N)
    chunked = tsim.init_state(tp, starts, valid=valid)
    stepped = tsim.init_state(tp, starts, valid=valid)
    for i, t_len in enumerate(WINDOWS):
        u = torch.from_numpy(rng.random((t_len, N)).astype(np.float32))
        buf_c, (pos_c, _, alive_c) = _emission_buffer(t_len, N, i)
        buf_s, (pos_s, _, alive_s) = _emission_buffer(t_len, N, i + 10)
        chunked = _chunk(tp, table, chunked, u, (pos_c, alive_c))
        for t in range(t_len):
            stepped = step(stepped, u=u[t])
            pos_s[t, :, 0] = stepped.pos_r
            pos_s[t, :, 1] = stepped.pos_c
            alive_s[t] = stepped.alive
        npos = 4 * t_len * N
        assert torch.equal(buf_c[:npos], buf_s[:npos])
        assert torch.equal(buf_c[npos + 4 * N:], buf_s[npos + 4 * N:])
        for name in ('pos_r', 'pos_c', 'mem', 'alive', 'palive', 'presence'):
            assert torch.equal(getattr(chunked, name), getattr(stepped, name))
        assert chunked.step == stepped.step


def _reference_compacting(params, starts, gen, table, chunk, min_bucket):
    """The compacting driver's per-step loop, as it was before the chunk
    kernel."""
    restr, dirp = _restr_dirp()
    step = tsim.make_step_fn(params, table, dirp, restr)
    state = tsim.init_state(params, starts)
    n_alive = state.pos_r.shape[0]
    while state.step < params.nsteps and n_alive > 0:
        for _ in range(min(chunk, params.nsteps - state.step)):
            state = step(state, generator=gen)
        n_alive = int(state.alive.sum())
        cur = state.pos_r.shape[0]
        if n_alive > 0 and cur > min_bucket:
            m = tsim._bucket_for(n_alive, min_bucket)
            if m < cur:
                state, _ = tsim._compact_body(state, m)
    state = tsim.flush_pending(state)
    return state.presence, state.step


def _reference_recorded(params, starts, gen, table, chunk, min_bucket):
    """The recording driver's per-step loop, as it was before the chunk
    kernel: three copies a step into the chunk's emission buffer."""
    restr, dirp = _restr_dirp()
    step = tsim.make_step_fn(params, table, dirp, restr)
    state = tsim.init_state(params, starts)
    builder = tnative.PyTrackBuilder(starts.astype(np.int16))
    ids = torch.arange(starts.shape[0], dtype=torch.int32)
    n_alive = ids.shape[0]
    while state.step < params.nsteps and n_alive > 0:
        t_len = min(chunk, params.nsteps - state.step)
        b = ids.shape[0]
        buf = torch.empty(5 * t_len * b + 4 * b, dtype=torch.uint8)
        pos, ids_out, alive = tsim._split_emissions(buf, t_len, b,
                                                    tsim._TORCH_VIEWS)
        ids_out.copy_(ids)
        for t in range(t_len):
            state = step(state, generator=gen)
            pos[t, :, 0] = state.pos_r
            pos[t, :, 1] = state.pos_c
            alive[t] = state.alive
        pos_h, ids_h, alive_h = tsim._split_emissions(
            buf.numpy(), t_len, b, tsim._NUMPY_VIEWS)
        n_alive = int(alive_h[-1].sum())
        builder.append_chunk(pos_h, alive_h, ids_h)
        if n_alive > 0 and b > min_bucket:
            m = tsim._bucket_for(n_alive, min_bucket)
            if m < b:
                state, order = tsim._compact_body(state, m)
                ids = ids[order]
    state = tsim.flush_pending(state)
    return state.presence, state.step, builder.export()


@pytest.mark.parametrize('driver', ['compacting', 'recorded'])
@pytest.mark.parametrize('k', [1, 9])
def test_drivers_bit_identical_to_per_step_loops(monkeypatch, driver, k):
    """600 agents, chunks of 8 steps, a uniform block of 1000 values (one
    launch covers 1000 // batch steps): the same presence, steps and
    tracks as the per-step loop from one generator seed. At k = 9, above
    the chunk kernel's ring, the drivers take the per-step loop."""
    n, nsteps, chunk, min_bucket = 600, 120, 8, 64
    params = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1.,
                              memory_k=k, burnin=4, nsteps=nsteps)
    up, pot = _fields()
    table = tsim.prepared_weights(torch.from_numpy(up), torch.from_numpy(pot),
                                  _restr_dirp()[1], 'float32')
    rng = np.random.default_rng(7)
    starts = np.stack([rng.integers(3, GRID[0] - 8, n),
                       rng.integers(18, 38, n)], axis=1).astype(np.int32)
    calls = []
    real = tsim.fused_chunk

    def counting(*args, **kwargs):
        calls.append(args[8].shape[0])
        return real(*args, **kwargs)

    monkeypatch.setattr(tsim, 'UNIFORM_BLOCK', 1000)
    monkeypatch.setattr(tsim, 'fused_chunk', counting)
    if driver == 'compacting':
        got = tsim.simulate_presence_compacting(
            params, starts, torch.Generator().manual_seed(3), base_flat=table,
            chunk=chunk, min_bucket=min_bucket)
        want = _reference_compacting(params, starts,
                                     torch.Generator().manual_seed(3), table,
                                     chunk, min_bucket)
    else:
        run = tsim.simulate_tracks_recorded(
            params, starts, torch.Generator().manual_seed(3), base_flat=table,
            chunk=chunk, min_bucket=min_bucket)
        got = (run.presence, run.steps, run.tracks)
        want = _reference_recorded(params, starts,
                                   torch.Generator().manual_seed(3), table,
                                   chunk, min_bucket)
        assert len(got[2]) == len(want[2]) == n
        for a, b in zip(got[2], want[2]):
            np.testing.assert_array_equal(a, b)
    assert torch.equal(got[0], want[0]) and got[1] == want[1]
    assert got[1] > 2 * chunk
    if k > fc.MAX_MEMORY_K:
        assert calls == []
    else:
        # the first chunk (600 agents) takes 1000 // 600 = 1 step a launch;
        # compaction shrinks the batch, and the launches grow
        assert sum(calls) == got[1] and len(calls) > -(-got[1] // chunk)
        assert calls[0] == 1 and 1 < max(calls) <= chunk


def test_drivers_leave_the_callers_arrays_alone():
    """The chunk kernel updates the state in place; the state owns its
    tensors, so the caller's starts and valid mask stay as they were."""
    params = tsim.TrackParams(grid_shape=GRID, move_dirn=0., nu=1.,
                              memory_k=1, burnin=4, nsteps=40)
    up, pot = _fields()
    rng = np.random.default_rng(8)
    starts, valid = _starts(rng, 300)
    starts_copy, valid_copy = starts.copy(), valid.copy()
    tsim.simulate_presence_compacting(params, starts,
                                      torch.Generator().manual_seed(1),
                                      updraft=up, potential=pot, valid=valid,
                                      chunk=16, min_bucket=64)
    np.testing.assert_array_equal(starts, starts_copy)
    np.testing.assert_array_equal(valid, valid_copy)
    one = starts[:1].copy()
    tsim.simulate_presence_compacting(params, one,
                                      torch.Generator().manual_seed(1),
                                      updraft=up, potential=pot, chunk=16)
    np.testing.assert_array_equal(one, starts[:1])


def _operands(memory_k=1, t_len=4, n=64):
    rng = np.random.default_rng(9)
    nrow, ncol = GRID
    table = torch.from_numpy(
        (rng.random((nrow * ncol, 9)) * 10.).astype(np.float32))
    restr, dirp = _restr_dirp()
    ops = dict(
        table=table, restr=restr, dirp=dirp,
        r=torch.from_numpy(rng.integers(1, nrow - 1, n).astype(np.int32)),
        c=torch.from_numpy(rng.integers(1, ncol - 1, n).astype(np.int32)),
        mem=torch.from_numpy(rng.integers(0, 9, (max(memory_k, 1), n))
                             .astype(np.int32)),
        alive=torch.from_numpy(rng.random(n) < 0.8),
        palive=torch.from_numpy(rng.random(n) < 0.8),
        u=torch.from_numpy(rng.random((t_len, n)).astype(np.float32)),
        presence=torch.zeros(GRID, dtype=torch.int32))
    return ops


def _call(fn, ops, memory_k=1, emit=None, s0=2):
    fn(ops['table'], ops['restr'], ops['dirp'], ops['r'], ops['c'],
       ops['mem'], ops['alive'], ops['palive'], ops['u'], ops['presence'],
       nu=1.0, memory_k=memory_k, s0=s0, burnin=3, nsteps=50, emit=emit)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    fc.reset_launch_count()
    a, b = _operands(), _operands()
    _call(fc.fused_chunk, a)
    _call(fc.fused_chunk_plain, b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    assert int(a['presence'].sum()) > 0
    assert fc.launch_count() == 0 and fc.steps_count() == 0


@pytest.mark.parametrize('bad', ['dtype', 'shape', 'device', 'contiguity',
                                 'table', 'memory_k', 'emit', 'u_rank'])
def test_wrapper_rejects_bad_operands(bad):
    memory_k = 9 if bad == 'memory_k' else 1
    ops = _operands(memory_k=memory_k)
    emit = None
    if bad == 'dtype':
        ops['r'] = ops['r'].long()
    elif bad == 'shape':
        ops['alive'] = ops['alive'][:-1]
    elif bad == 'device':
        ops['u'] = ops['u'].to('meta')
    elif bad == 'contiguity':
        ops['c'] = torch.ones(128, dtype=torch.int32)[::2]
    elif bad == 'table':
        ops['table'] = ops['table'][:-1]
    elif bad == 'emit':
        emit = (torch.zeros((4, 64, 2), dtype=torch.int32),
                torch.zeros((4, 64), dtype=torch.bool))
    else:
        ops['u'] = ops['u'][0]
    before = {k: v.clone() for k, v in ops.items() if v.device.type == 'cpu'}
    with pytest.raises(ValueError):
        _call(fc.fused_chunk, ops, memory_k=memory_k, emit=emit)
    for name, v in before.items():
        assert torch.equal(ops[name], v), name
