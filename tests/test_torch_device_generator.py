"""The split device path's generator (handyrl_tpu_torch/device_generation.py
``DeviceGenerator``) on the CPU, against the JAX package's
(handyrl_tpu/device_generation.py:226-386).

- The splice: the port's generator runs its rollout chunks (a small
  GeeseNet, filters 16 and 2 blocks on the 'pallas' trunk's plain version,
  on the Hungry Geese twin; the quick start's SimpleConv2dModel on the
  TicTacToe twin) and every chunk's unpacked numpy records also go through
  the JAX ``DeviceGenerator._splice``. The episodes must be equal: args,
  steps, outcome and every moment's turn, observation, action mask, value,
  probability, action and reward exactly (both splice the same float32
  records), the discounted returns within 1e-6 (the same float sums, kept
  as a bound).
- The one-chunk pipeline: after n calls n + 1 chunks were dispatched, and
  call t splices the records of dispatch t - 1; the drain splices the
  chunk in flight.
- The static-buffer trap: the generator's record tensors are rewritten by
  every dispatch (on the card they are a CUDA graph's outputs), so a chunk
  handed to the device ingest must keep the records of its own dispatch
  after the next ones, in storage of its own.
"""

import os
import types

import numpy as np
import pytest
import torch

from handyrl_tpu import device_generation as jdg
from handyrl_tpu.envs import jax_hungry_geese as jhg
from handyrl_tpu.envs import jax_tictactoe as jtt
from handyrl_tpu.ops.batch import decompress_moments as jax_decompress
from handyrl_tpu_torch import device_generation as dg
from handyrl_tpu_torch.envs import torch_hungry_geese as tg
from handyrl_tpu_torch.envs import torch_tictactoe as tt
from handyrl_tpu_torch.models.geese import GeeseNet
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.ops.batch import decompress_moments

pytestmark = pytest.mark.timeout(120)

RETURN_TOL = 1e-6
ARGS = {'gamma': 0.9, 'compress_steps': 4}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _geese():
    return tg, jhg, GeeseNet(filters=16, layers=2, torus_impl='pallas',
                             generator=torch.Generator().manual_seed(0))


def _tictactoe():
    torch.manual_seed(0)
    return tt, jtt, SimpleConv2dModel()


ENVS = {'HungryGeese': (_geese, 4, 8, 40), 'TicTacToe': (_tictactoe, 4, 4, 6)}


def _jax_splicer(jenv, n_envs, chunk_steps):
    """The JAX generator, built only for its host splice (its rollout,
    whose net this stand-in lacks, is never called)."""
    wrapper = types.SimpleNamespace(module=types.SimpleNamespace(apply=None),
                                    params=None)
    return jdg.DeviceGenerator(jenv, wrapper, dict(ARGS), n_envs=n_envs,
                               chunk_steps=chunk_steps)


def _same_value(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=what)


def _same_episodes(got, want):
    assert len(got) == len(want)
    for e, (x, y) in enumerate(zip(got, want)):
        assert x['args'] == y['args'] and x['steps'] == y['steps'], e
        assert x['outcome'] == y['outcome'], e
        mx, my = decompress_moments(x['moment']), jax_decompress(y['moment'])
        assert len(mx) == len(my) == x['steps']
        for t, (a, b) in enumerate(zip(mx, my)):
            assert a['turn'] == b['turn'], (e, t)
            for key in ('selected_prob', 'action', 'reward'):
                assert a[key] == b[key], (e, t, key)
            for key in ('observation', 'action_mask', 'value'):
                for p in b[key]:
                    _same_value(a[key][p], b[key][p], (e, t, key, p))
            for p, r in b['return'].items():
                assert abs(a['return'][p] - r) <= RETURN_TOL, (e, t, p)


@pytest.mark.parametrize('name', sorted(ENVS))
def test_splice_matches_jax(name):
    make, n_envs, chunk_steps, chunks = ENVS[name]
    env, jenv, net = make()
    gen = dg.DeviceGenerator(env, net, dict(ARGS), n_envs=n_envs,
                             chunk_steps=chunk_steps, seed=3)
    jgen = _jax_splicer(jenv, n_envs, chunk_steps)
    real_splice, want = gen._splice, []

    def both(rec):
        want.extend(jgen._splice({k: v.copy() for k, v in rec.items()}))
        return real_splice(rec)
    gen._splice = both
    got = []
    for _ in range(chunks):
        got += gen.step_chunk()
    got += gen.drain_episodes()
    assert len(got) >= 3
    _same_episodes(got, want)
    ep = got[0]
    assert ep['args']['role'] == 'g'
    assert set(ep['args']['model_id'].values()) == {-1}
    assert sorted(ep['outcome']) == list(range(env.NUM_PLAYERS))


def _snapshotting(gen):
    """The generator with a copy of its static records after each chunk."""
    real_chunk, snaps = gen._chunk, []

    def chunk(full):
        out = real_chunk(full)
        snaps.append({k: v.clone() for k, v in gen.records.items()})
        return out
    gen._chunk = chunk
    return snaps


def test_one_chunk_pipeline():
    env, _, net = _geese()
    gen = dg.DeviceGenerator(env, net, dict(ARGS), n_envs=4, chunk_steps=4,
                             seed=1)
    snaps = _snapshotting(gen)
    spliced = []
    real_splice = gen._splice
    gen._splice = lambda rec: spliced.append(rec) or real_splice(rec)
    for n in range(1, 6):
        gen.step_chunk()
        assert gen.dispatches == len(snaps) == n + 1
        rec = spliced[-1]
        for k in ('done', 'action', 'outcome', 'obs'):
            np.testing.assert_array_equal(rec[k], snaps[n - 1][k].numpy(),
                                          err_msg='%s call %d' % (k, n))
    gen.drain_episodes()
    assert gen.dispatches == 6 and len(spliced) == 6
    np.testing.assert_array_equal(spliced[-1]['done'],
                                  snaps[-1]['done'].numpy())
    assert gen.drain_episodes() == []


def test_queued_chunk_keeps_its_records_after_the_next_dispatch():
    """The static-buffer trap: the next dispatches rewrite the generator's
    record tensors; a handed-out chunk keeps its own dispatch's records."""
    env, _, net = _geese()
    gen = dg.DeviceGenerator(env, net, dict(ARGS), n_envs=4, chunk_steps=4,
                             seed=2)
    snaps = _snapshotting(gen)
    chunk, done, outcome = gen.step_chunk_records()
    assert chunk.ready is None   # the CPU: no stream to order
    kept = {k: v.clone() for k, v in chunk.records.items()}
    for _ in range(3):
        later = gen.step_chunk_records()
    assert gen.dispatches == 5
    for k, v in chunk.records.items():
        assert v.data_ptr() != gen.records[k].data_ptr(), k
        assert torch.equal(v, kept[k]), k
        assert torch.equal(v, snaps[0][k]), k
    # the static tensors hold the newest dispatch, not the queued chunk's
    assert not torch.equal(gen.records['obs'], kept['obs'])
    np.testing.assert_array_equal(done, snaps[0]['done'].numpy())
    np.testing.assert_array_equal(outcome, snaps[0]['outcome'].numpy())
    np.testing.assert_array_equal(later[1], snaps[3]['done'].numpy())
    tail = gen.drain_records()
    assert torch.equal(tail[0].records['action'], snaps[4]['action'])
    assert gen.drain_records() is None


def test_record_packer_round_trips_every_dtype():
    records = {'done': torch.tensor([[True, False]]),
               'action': torch.tensor([[3, 0]], dtype=torch.int32),
               'player': torch.tensor([[1, 0]]),
               'prob': torch.tensor([[0.25, 0.5]])}
    packer = dg._RecordPacker(records)
    out = packer.unpack(packer.pack(records).numpy())
    for k, v in records.items():
        assert out[k].dtype == v.numpy().dtype, k
        np.testing.assert_array_equal(out[k], v.numpy(), err_msg=k)
