"""Batcher processes and shared-memory batches (handyrl_tpu_torch/ops/
shm_batch.py, connection.JobPool, train.Batcher's process modes) against
the JAX package's (handyrl_tpu/ops/shm_batch.py, tests/
test_ingest_pipeline.py:38-140, tests/test_batcher_processes.py).

Batches are numpy on both sides, so every comparison is exact: the spec
and map round trip, the slot cycle, ``make_batch(out=)`` into a dirty
reused arena against a fresh batch and the JAX package's ``make_batch``
(pad values, the 1e32 action masks, ``progress`` 1 and the terminal value
bootstrap included), and batches built by spawned children through shared
memory against the same builder in this process. A spawned child imports
no ``torch``. The learner runs through its CLI on the CPU with each
switch, and a killed child makes it exit 1 naming the batcher instead of
hanging; no run leaves a segment in /dev/shm.
"""

import json
import os
import queue
import random
import signal
import subprocess
import sys
import time
from collections import deque

import numpy as np
import pytest
import torch

from handyrl_tpu.ops import batch as jax_batch
from handyrl_tpu.ops import shm_batch as jax_shm
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.connection import JobPool
from handyrl_tpu_torch.guard import ChaosNaN
from handyrl_tpu_torch.ops import batch
from handyrl_tpu_torch.ops.shm_batch import (_SHM_SLOTS, ArenaMap, ArenaRing,
                                             SharedBatch, batch_spec,
                                             batcher_process, copy_into)
from handyrl_tpu_torch.train import Batcher, Trainer
from handyrl_tpu_torch.utils.fs import verify_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.timeout(60)   # each test's own limit


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process (and in the processes a test starts, through
    OMP_NUM_THREADS) keeps these runs' many small ops from waiting on
    descheduled OpenMP threads (tens of times slower without it)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _tiny_batch(seed=0):
    rng = np.random.RandomState(seed)
    return {
        'observation': {'board': rng.rand(2, 3, 1, 4, 4).astype(np.float32),
                        'scalars': rng.rand(2, 3, 1, 5).astype(np.float32)},
        'selected_prob': rng.rand(2, 3, 1, 1).astype(np.float32),
        'action': rng.randint(0, 4, (2, 3, 1, 1)).astype(np.int32),
        'progress': rng.rand(2, 3, 1).astype(np.float32),
    }


def _assert_tree_equal(a, b, path=''):
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            _assert_tree_equal(a[k], b[k], path + '/' + str(k))
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_shm_spec_map_roundtrip():
    """The spec equals the JAX package's; spec -> segment -> views -> copy
    -> a second mapping: equal, mixed dtypes and nesting kept; another
    slot's writes leave it alone."""
    b = _tiny_batch()
    spec = batch_spec(b)
    assert spec == jax_shm.batch_spec(b)
    assert all(e['offset'] % 64 == 0 for e in spec['entries'])
    ring = ArenaRing(spec, slots=2)
    try:
        copy_into(ring.views[0], b)
        amap = ArenaMap()
        remap = amap.attach(ring.names[0], spec)
        _assert_tree_equal(b, remap)
        copy_into(ring.views[1], _tiny_batch(seed=9))
        _assert_tree_equal(b, remap)
        del remap
        amap.close()
    finally:
        ring.close()
        ring.close()   # idempotent
    assert not any(os.path.exists('/dev/shm/' + n) for n in ring.names)


def test_shm_slot_acquire_release_cycle():
    ring = ArenaRing(batch_spec(_tiny_batch()), slots=2)
    try:
        a, b = ring.acquire(), ring.acquire()
        assert {a, b} == {0, 1}
        assert ring.acquire() is None       # exhausted: backpressure
        ring.release(a)
        assert ring.acquire() == a
    finally:
        ring.close()


def test_shared_batch_release_is_idempotent():
    calls = []
    sb = SharedBatch({'x': np.zeros(1)}, lambda: calls.append(1))
    sb.release()
    sb.release()
    assert calls == [1]


def _episodes(n=12, seed=0, n_actions=5):
    """Turn-based two-player episodes of 2..12 plies, shaped like
    generation output (the JAX test's, with ragged lengths so that windows
    are padded and the value tail is bootstrapped)."""
    rng = np.random.RandomState(seed)
    eps = []
    for i in range(n):
        steps = 2 + (i * 7 + seed) % 11
        moments = []
        for t in range(steps):
            turn = t % 2
            m = {k: {0: None, 1: None} for k in
                 ('observation', 'selected_prob', 'action_mask', 'action',
                  'value', 'reward', 'return')}
            for p in (0, 1):
                if p == turn:
                    m['observation'][p] = rng.rand(3, 3, 3).astype(np.float32)
                    m['selected_prob'][p] = float(rng.rand())
                    am = np.zeros(n_actions, np.float32)
                    am[rng.randint(1, n_actions):] = 1e32
                    m['action_mask'][p] = am
                    m['action'][p] = int(rng.randint(3))
                    m['value'][p] = np.array([rng.rand() - 0.5], np.float32)
            m['reward'] = {0: 0.0, 1: 0.0}
            m['return'] = {0: float(rng.rand()), 1: float(rng.rand())}
            m['turn'] = [turn]
            moments.append(m)
        eps.append({'args': {'player': [0, 1]}, 'steps': steps,
                    'outcome': {0: 1.0, 1: -1.0} if i % 3 else
                    {0: -1.0, 1: 1.0},
                    'moment': batch.compress_moments(moments, 2)})
    return eps


def _job_args(turn_based=True, observation=False):
    return {'turn_based_training': turn_based, 'observation': observation,
            'forward_steps': 6, 'burn_in_steps': 0, 'compress_steps': 2,
            'maximum_episodes': 100, 'decode_cache_blocks': 64}


@pytest.mark.parametrize('turn_based,observation', [
    (True, False), (True, True), (False, True)])
def test_make_batch_into_a_dirty_arena_equals_jax(turn_based, observation):
    """A batch built into shared-memory views that still hold another
    batch equals a fresh batch and the JAX package's make_batch on the
    same episodes, bit for bit."""
    args = _job_args(turn_based, observation)
    eps_a, eps_b = _episodes(seed=1), _episodes(seed=2)
    random.seed(3)
    sel_a = [batch.select_episode(eps_a, args) for _ in range(12)]
    random.seed(4)
    sel_b = [batch.select_episode(eps_b, args) for _ in range(12)]
    random.seed(5)
    first = batch.make_batch(sel_a, args)
    ring = ArenaRing(batch_spec(first), slots=1)
    try:
        view = ring.views[0]
        copy_into(view, first)
        random.seed(6)   # solo windows draw their seat
        out = batch.make_batch(sel_b, args, out=view)
        assert out is view
        random.seed(6)
        fresh = batch.make_batch(sel_b, args)
        random.seed(6)
        want = jax_batch.make_batch(sel_b, args)
        _assert_tree_equal(fresh, want)
        _assert_tree_equal(view, want)
        # the pads this draw needs were restored in the dirty arena
        assert (want['episode_mask'] == 0).any()
        assert (want['action_mask'] == np.float32(1e32)).any()
        assert (want['progress'][want['episode_mask'][..., 0, 0] == 0]
                == 1).all()
        del view, out
    finally:
        ring.close()


def _maps_torch(pid):
    """True when process ``pid`` has mapped libtorch (imported torch)."""
    with open('/proc/%d/maps' % pid) as f:
        return 'libtorch' in f.read()


def test_spawned_batcher_child_imports_no_torch():
    """A JobPool child builds the batch this process builds from the same
    selection and never maps libtorch; closing the pool ends it."""
    args = _job_args()
    eps = _episodes(seed=3)
    random.seed(8)
    sels = [[batch.select_episode(eps, args) for _ in range(4)]
            for _ in range(3)]
    jobs = iter([(s, args) for s in sels])
    pool = JobPool(batcher_process, jobs, 1)
    pool.start()
    try:
        got = pool.recv(timeout=30)
        assert pool.error is None
        _assert_tree_equal(got, batch.make_batch(sels[0], args))
        assert _maps_torch(os.getpid())   # the check sees this process's
        assert not _maps_torch(pool.pids[0])
    finally:
        pool.close()
    assert not any(proc.is_alive() for proc, _ in pool._workers)


def test_shared_memory_batcher_roundtrip():
    """Spawned shared-memory children -> slot descriptors -> mapped
    SharedBatch views here, through slot recycling (more batches than
    slots); each batch has the builder's invariants, and the children's
    segments are gone once the batcher stops."""
    args = dict(_job_args(), batch_size=3, num_batchers=1,
                batcher_processes=True, batcher_shared_memory=True)
    random.seed(0)
    batcher = Batcher(args, deque(_episodes()))
    batcher.run()
    try:
        for _ in range(2 * _SHM_SLOTS + 1):   # forces slot recycling
            sb = batcher.batch(timeout=30)
            assert isinstance(sb, SharedBatch)
            b = sb.batch
            assert b['observation'].shape == (3, 6, 1, 3, 3, 3)
            assert b['value'].shape == (3, 6, 2, 1)
            assert b['action'].dtype == np.dtype(np.int32)
            assert set(np.unique(b['turn_mask'])) <= {0.0, 1.0}
            assert np.all(b['selected_prob'] > 0)
            assert np.all((b['progress'] >= 0) & (b['progress'] <= 1))
            assert np.all(b['episode_mask'][:, 0] == 1.0)
            sb.release()
        shm = batcher.shm_summary()
        assert shm['batches'] >= 2 * _SHM_SLOTS + 1
        assert len(shm['segments']) == _SHM_SLOTS
        assert shm['slots_used'] == _SHM_SLOTS
    finally:
        batcher.stop()
    assert not any(os.path.exists('/dev/shm/' + n)
                   for n in shm['segments'])


def test_a_lost_batcher_child_raises_naming_it():
    args = dict(_job_args(), batch_size=3, num_batchers=2,
                batcher_processes=True, batcher_shared_memory=True)
    batcher = Batcher(args, deque(_episodes()))
    batcher.run()
    try:
        batcher.batch(timeout=30).release()
        os.kill(batcher._pool.pids[1], signal.SIGKILL)
        deadline = time.monotonic() + 30
        with pytest.raises(RuntimeError, match='batcher process 1'):
            while time.monotonic() < deadline:
                try:
                    batcher.batch(timeout=0.5).release()
                except queue.Empty:
                    pass
    finally:
        batcher.stop()


def test_trainer_releases_each_shared_batch_once():
    """On the CPU a shared batch is released after its step (the card
    releases it after the staging copy), a skipped non-finite step
    included; the ones still staged at shutdown are released by
    ``release``."""
    from handyrl_tpu_torch.environment import make_env
    raw = {'env_args': {'env': 'TicTacToe'},
           'train_args': {'batch_size': 4, 'forward_steps': 4,
                          'prefetch_depth': 2}}
    args = dict(apply_defaults(raw)['train_args'])
    args['env'] = {'env': 'TicTacToe'}
    net = make_env(args['env']).net()
    trainer = Trainer(args, net)
    job = _job_args()
    job['forward_steps'] = 4
    random.seed(1)
    eps = _episodes(seed=4, n_actions=9)   # TicTacToe's 9 actions
    released = []

    class Stub:
        handed = 0

        def batch(self, timeout=None):
            sel = [batch.select_episode(eps, job) for _ in range(4)]
            n = Stub.handed
            Stub.handed += 1
            return SharedBatch(batch.make_batch(sel, job),
                               lambda: released.append(n))

        def stop(self):
            pass
    trainer.batcher = Stub()
    # the third step is non-finite and skipped
    trainer.chaos_nan = ChaosNaN({'nanstep': 2})
    trainer.update_flag = True
    trainer.train()
    trainer.release()
    assert trainer.guard.total_bad == 1
    assert sorted(released) == list(range(Stub.handed))
    assert trainer.steps >= 3


def _run_cli(tmp_path, **switches):
    cfg = {'env_args': {'env': 'TicTacToe'},
           'train_args': dict({
               'batch_size': 16, 'forward_steps': 8, 'generation_envs': 8,
               'num_batchers': 2, 'minimum_episodes': 30,
               'update_episodes': 25, 'epochs': 2,
               'model_dir': str(tmp_path / 'models')}, **switches)}
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(cfg))
    return subprocess.Popen(
        [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
         str(path), '--device', 'cpu'], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize('shared_memory', [False, True])
def test_learner_cli_with_batcher_processes(tmp_path, shared_memory):
    proc = _run_cli(tmp_path, batcher_processes=True,
                    batcher_shared_memory=shared_memory)
    try:
        out, err = proc.communicate(timeout=50)
    finally:
        proc.kill()   # a no-op once it exited
    assert proc.returncode == 0, err[-2000:]
    assert 'batcher processes: 2 spawned' in out
    line = json.loads([l for l in out.splitlines() if l.startswith('{')][0])
    assert line['epochs'] == 2 and not line['failed']
    for name in ('1.ckpt', '2.ckpt', 'latest.ckpt', 'trainer_state.ckpt'):
        assert verify_checkpoint(str(tmp_path / 'models' / name)) == (
            True, 'ok'), name
    if shared_memory:
        shm = line['shm']
        assert line['batcher_mode'] == 'shared_memory'
        assert shm['batches'] > 0 and len(shm['segments']) == 2 * _SHM_SLOTS
        assert not any(os.path.exists('/dev/shm/' + n)
                       for n in shm['segments'])
    else:
        assert line['batcher_mode'] == 'processes' and line['shm'] is None


def _children(pid):
    """The pids whose parent is ``pid``."""
    out = []
    for d in os.listdir('/proc'):
        if d.isdigit():
            try:
                with open('/proc/%s/stat' % d) as f:
                    if int(f.read().rsplit(')', 1)[1].split()[1]) == pid:
                        out.append(int(d))
            except (OSError, IndexError, ValueError):
                pass
    return out


def test_learner_cli_exits_naming_a_killed_batcher(tmp_path):
    """SIGKILL to a batcher child: the learner exits 1 naming the lost
    batcher process (it does not wait for batches forever), and the dead
    child's segments are unlinked once the run's processes are gone."""
    proc = _run_cli(tmp_path, batcher_processes=True,
                    batcher_shared_memory=True, epochs=200)
    try:
        kids = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            kids = [k for k in _children(proc.pid) if _is_batcher(k)]
            if len(kids) == 2 and (tmp_path / 'models' / '1.ckpt').exists():
                break
            time.sleep(0.2)
        assert len(kids) == 2
        os.kill(kids[0], signal.SIGKILL)
        out, err = proc.communicate(timeout=25)
    finally:
        proc.kill()   # a no-op once it exited
    assert proc.returncode == 1, err[-2000:]
    assert 'batcher process' in err and 'was lost' in err
    line = json.loads([l for l in out.splitlines() if l.startswith('{')][0])
    assert line['failed'] and 'batcher process' in line['failed_reason']
    deadline = time.monotonic() + 10
    names = line['shm']['segments']
    while time.monotonic() < deadline and any(
            os.path.exists('/dev/shm/' + n) for n in names):
        time.sleep(0.2)
    assert not any(os.path.exists('/dev/shm/' + n) for n in names)


def _is_batcher(pid):
    try:
        with open('/proc/%d/cmdline' % pid) as f:
            return 'spawn_main' in f.read()
    except OSError:
        return False


def test_validate_takes_the_jax_batcher_keys():
    from handyrl_tpu.config import apply_defaults as jax_apply_defaults
    from handyrl_tpu_torch.config import ConfigError
    jax_ta = jax_apply_defaults({})['train_args']
    ta = apply_defaults({})['train_args']
    for key in ('batcher_processes', 'batcher_shared_memory'):
        assert ta[key] is jax_ta[key] is False, key
    both = {'batcher_processes': True, 'batcher_shared_memory': True}
    for env in ('TicTacToe', 'HungryGeese'):
        assert apply_defaults({'env_args': {'env': env},
                               'train_args': both})['train_args'][
            'batcher_shared_memory'] is True
    # shared memory alone is refused by both packages
    with pytest.raises(ConfigError, match='requires batcher_processes'):
        apply_defaults({'train_args': {'batcher_shared_memory': True}})
    with pytest.raises(AssertionError, match='requires batcher_processes'):
        jax_apply_defaults({'train_args': {'batcher_shared_memory': True}})
