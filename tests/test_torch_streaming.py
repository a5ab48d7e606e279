"""The port's streaming ingest (handyrl_tpu_torch/streaming.py, generation.py
``build_chunk`` and ``Generator.generate(emit=)``, ops/batch.py's
staleness-aware ``select_episode``, the ledger's chunk screen, the
gathers' resume-token handshake) against the JAX package's, mirroring
tests/test_streaming.py's twelve tests.

TicTacToe's full-width SimpleConv2dModel drives both packages with one set
of weights (``params_from_flax``). Records compare exactly in what
training sees: the decoded moment stream (one pickle of it), the filled
returns, the outcome, the steps and the block grid; across the packages
the same chunk stream gives the same records, exact, because both
assemblers decode the same bytes and fill the returns in the same fp64
order. ``select_episode`` draws from Python's ``random``: the same seed
gives the same picks in both packages, exactly."""

import os
import pickle
import random
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu import streaming as jax_streaming
from handyrl_tpu.fault import TaskLedger as JaxTaskLedger
from handyrl_tpu.generation import build_chunk as jax_build_chunk
from handyrl_tpu.ops.batch import select_episode as jax_select_episode
from handyrl_tpu_torch.config import ConfigError, apply_defaults
from handyrl_tpu_torch.connection import (RESUME_KIND, FramedConnection,
                                          accept_socket_connections,
                                          connect_socket_connection)
from handyrl_tpu_torch.connection import pack as conn_pack
from handyrl_tpu_torch.connection import unpack as conn_unpack
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.fault import LedgerJournal, TaskLedger
from handyrl_tpu_torch.generation import Generator, build_chunk
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models import tictactoe
from handyrl_tpu_torch.ops.batch import decompress_moments, select_episode
from handyrl_tpu_torch.spool import EpisodeSpool
from handyrl_tpu_torch.streaming import ChunkAssembler, chunk_key
from handyrl_tpu_torch.worker import Gather
from test_torch_durability import free_ports, restart_drill


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread a process (and OMP_NUM_THREADS=1 in the
    processes a test starts): the workers of a parallel run share the
    cores."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _args(chunk_steps=4, compress_steps=4, **stream):
    s = {'enabled': True, 'chunk_steps': chunk_steps}
    s.update(stream)
    return {'observation': False, 'gamma': 0.8,
            'compress_steps': compress_steps, 'seed': 11, 'streaming': s}


@pytest.fixture(scope='module')
def wrapper():
    """TicTacToe's net with the weights the JAX package's wrapper draws
    from seed 4."""
    from handyrl_tpu.environment import make_env as jax_make_env
    from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
    from handyrl_tpu.models import build as jax_build
    jw = JaxModelWrapper(jax_build('SimpleConv2dModel'), seed=4)
    jw.ensure_params(jax_make_env({'env': 'TicTacToe'}).observation(0))
    net = tictactoe.SimpleConv2dModel()
    net.load_state_dict(tictactoe.params_from_flax(
        jax.tree_util.tree_map(np.asarray, jw.params)))
    return ModelWrapper(net, device='cpu')


def _gen_args(sample_key, task_id=7):
    return {'role': 'g', 'player': [0, 1], 'model_id': {0: 1, 1: 1},
            'sample_key': sample_key, 'task_id': task_id}


def _generate(wrapper, args, sample_key, task_id=7, stream=True):
    """One TicTacToe episode under the purity contract: the whole record
    (stream=False) or the emitted chunks (stream=True)."""
    gen = Generator(make_env({'env': 'TicTacToe'}), args)
    if not stream:
        rec = gen.generate({0: wrapper, 1: wrapper},
                           _gen_args(sample_key, task_id))
        assert rec is not None and not rec.get('streamed')
        return rec
    chunks = []
    summary = gen.generate({0: wrapper, 1: wrapper},
                           _gen_args(sample_key, task_id),
                           emit=chunks.append)
    assert summary is not None and summary.get('streamed')
    assert summary['steps'] == sum(c['steps'] for c in chunks)
    return chunks


def _assemble(args, chunks, check_finite=True, cls=ChunkAssembler):
    asm = cls(args, check_finite=check_finite)
    result = None
    for c in chunks:
        res = asm.add(c)
        if res['status'] == 'complete':
            result = res
    return asm, result


def _moment_bytes(rec):
    """What training sees of a trajectory: one pickle of the decoded
    moments (a fixed point after one decode; the raw bz2 bytes may differ
    in pickle memo layout only)."""
    return pickle.dumps(decompress_moments(rec['moment']))


def _assert_records_equal(a, b):
    assert a['steps'] == b['steps']
    assert a['outcome'] == b['outcome']
    assert a['args'] == b['args']
    assert len(a['moment']) == len(b['moment'])   # the same block grid
    assert _moment_bytes(a) == _moment_bytes(b)


# ---------------------------------------------------------------------------
# reassembly


def test_streamed_chunks_reassemble_byte_identically(wrapper):
    args = _args(chunk_steps=4, compress_steps=4)
    whole = _generate(wrapper, args, sample_key=100, stream=False)
    chunks = _generate(wrapper, args, sample_key=100)
    assert chunks[-1]['final'] and chunks[-1]['outcome'] is not None
    for c in chunks[:-1]:
        assert not c['final'] and c['outcome'] is None
        for m in decompress_moments(c['moment']):
            assert all(v is None for v in m['return'].values())
    _, res = _assemble(args, chunks)
    assert res is not None and res['record'] is not None
    _assert_records_equal(res['record'], whole)
    assert res['entry']['moment'] == res['record']['moment']
    assert 'partial' not in res['entry']


def test_fuzz_window_sizes_and_arrival_orders(wrapper):
    rng = random.Random(17)
    for trial in range(12):
        cs = rng.choice([1, 2, 3])
        T = cs * rng.randint(1, 4)
        args = _args(chunk_steps=T, compress_steps=cs)
        skey = 1000 + trial
        whole = _generate(wrapper, args, sample_key=skey, stream=False)
        chunks = _generate(wrapper, args, sample_key=skey)
        shuffled = list(chunks)
        rng.shuffle(shuffled)
        asm, res = _assemble(args, shuffled)
        assert res is not None, 'assembly never completed (trial %d)' % trial
        _assert_records_equal(res['record'], whole)
        assert asm.open_count() == 0


def test_reissued_attempt_merges_without_double_count(wrapper):
    """A re-issued attempt regenerates the same chunks under the same
    sample_key; the screen admits only the missing ones and the episode
    completes once."""
    args = _args(chunk_steps=2, compress_steps=2)
    first = _generate(wrapper, args, sample_key=555, task_id=1)
    again = _generate(wrapper, args, sample_key=555, task_id=2)
    assert len(first) == len(again) >= 2
    for a, b in zip(first, again):
        assert a['moment'] == b['moment']
    ledger = TaskLedger(deadline=60)
    asm = ChunkAssembler(args)
    for c in ledger.admit_chunks([first[0]]):
        asm.add(c)
    admitted = ledger.admit_chunks(again)
    assert len(admitted) == len(again) - 1
    done = [r for r in (asm.add(c) for c in admitted)
            if r['status'] == 'complete']
    assert len(done) == 1 and done[0]['record'] is not None
    ledger.complete_chunked(chunk_key(first[0]),
                            done[0]['final_args'].get('task_id'))
    assert ledger.admit_chunks(first) == []
    assert ledger.stats['duplicates'] >= len(first) + 1


def test_partial_entry_grows_in_place_then_finalizes(wrapper):
    args = _args(chunk_steps=2, compress_steps=2)
    chunks = _generate(wrapper, args, sample_key=42)
    assert len(chunks) >= 3
    asm = ChunkAssembler(args)
    res0 = asm.add(chunks[0], mark=10)
    assert res0['status'] == 'open' and res0['new']
    entry = res0['entry']
    assert entry['partial'] and entry['steps'] == chunks[0]['steps']
    assert set(entry['outcome'].values()) == {0.0}
    assert len(entry['chunk_recv']) == 1
    assert asm.min_open_mark() == 10
    res1 = asm.add(chunks[1], mark=11)
    assert res1['entry'] is entry and not res1['new']
    assert entry['steps'] == chunks[0]['steps'] + chunks[1]['steps']
    assert asm.min_open_mark() == 10
    for c in chunks[2:]:
        res = asm.add(c)
    assert res['status'] == 'complete' and res['entry'] is entry
    assert 'partial' not in entry
    assert entry['outcome'] == res['record']['outcome']
    assert asm.min_open_mark() is None
    assert asm.counts() == {'reassembled_episodes': 1, 'open_assemblies': 0,
                            'abandoned_assemblies': 0}


def test_out_of_order_arrival_defers_exposure(wrapper):
    args = _args(chunk_steps=2, compress_steps=2)
    chunks = _generate(wrapper, args, sample_key=43)
    asm = ChunkAssembler(args)
    res = asm.add(chunks[-1])
    assert res['status'] == 'open' and res['entry'] is None
    for c in chunks[:-1]:
        res = asm.add(c)
    assert res['status'] == 'complete' and res['record'] is not None


def test_poisoned_chunk_freezes_assembly_but_completes_task(wrapper):
    args = _args(chunk_steps=2, compress_steps=2)
    chunks = _generate(wrapper, args, sample_key=44)
    window = decompress_moments(chunks[0]['moment'])
    window[0]['observation'][window[0]['turn'][0]] = np.full(3, np.nan)
    for m in window:
        for p in m['return']:
            m['return'][p] = None
    poisoned = build_chunk(chunks[0]['args'], 0, 0, window, args)
    asm = ChunkAssembler(args, check_finite=True)
    results = [asm.add(c) for c in [poisoned] + chunks[1:]]
    done = [r for r in results if r['status'] == 'complete']
    assert len(done) == 1 and done[0]['record'] is None
    assert asm.open_count() == 0


def test_reap_abandons_stale_assemblies(wrapper):
    clock = [0.0]
    args = _args(chunk_steps=2, compress_steps=2)
    chunks = _generate(wrapper, args, sample_key=45)
    asm = ChunkAssembler(args, clock=lambda: clock[0])
    asm.add(chunks[0], mark=3)
    assert asm.open_count() == 1 and asm.min_open_mark() == 3
    clock[0] = 10.0
    assert asm.reap(older_than=100) == []
    clock[0] = 1000.0
    assert asm.reap(older_than=100) == [chunk_key(chunks[0])]
    assert asm.open_count() == 0 and asm.min_open_mark() is None
    assert asm.counts()['abandoned_assemblies'] == 1


# ---------------------------------------------------------------------------
# the journal and the spool across a SIGKILL


def test_journal_round_trips_chunk_book(tmp_path, wrapper):
    args = _args(chunk_steps=2, compress_steps=2)
    chunks = _generate(wrapper, args, sample_key=777, task_id=0)
    key = chunk_key(chunks[0])
    ledger = TaskLedger(deadline=60)
    ledger.journal = LedgerJournal(str(tmp_path))
    role = _gen_args(777)
    del role['task_id']
    tid = ledger.assign('w1', role)
    assert len(ledger.admit_chunks(chunks[:1])) == 1
    ledger.flush_journal()
    state = LedgerJournal(str(tmp_path)).load()
    assert state['chunks'] == [[list(key), [0]]]
    restored = TaskLedger(deadline=60)
    restored.restore_state(state)
    assert [c['chunk'] for c in restored.admit_chunks(chunks)] == \
        [c['chunk'] for c in chunks[1:]]
    ledger.complete_chunked(key, tid)
    ledger.flush_journal()
    state = LedgerJournal(str(tmp_path)).load()
    assert 'chunks' not in state and state['chunks_closed'] == [list(key)]
    ledger.journal.snapshot(ledger.snapshot_state())
    state = LedgerJournal(str(tmp_path)).load()
    assert 'chunks' not in state and 'chunks_closed' not in state


def test_sigkill_mid_episode_replays_chunks_without_double_count(
        tmp_path, wrapper):
    """The learner dies after spooling a prefix of an episode's chunks;
    the restarted one replays them (screened by the journaled book), the
    re-issued attempt delivers the rest, and the episode completes once,
    equal to the whole-episode record."""
    args = _args(chunk_steps=2, compress_steps=2)
    whole = _generate(wrapper, args, sample_key=888, task_id=0, stream=False)
    chunks = _generate(wrapper, args, sample_key=888, task_id=0)
    key = chunk_key(chunks[0])
    sp = EpisodeSpool(str(tmp_path), segment_mb=1)
    ledger = TaskLedger(deadline=60)
    ledger.journal = LedgerJournal(str(tmp_path))
    role = _gen_args(888)
    del role['task_id']
    ledger.assign('w1', role)
    for i, c in enumerate(ledger.admit_chunks(chunks[:-1])):
        sp.append(i, conn_pack({'idx': i, 'chunk': c}))
        ledger.flush_journal()
    ledger.journal.close()
    sp.close()

    state = LedgerJournal(str(tmp_path)).load()
    ledger2 = TaskLedger(deadline=60)
    ledger2.restore_state(state)
    live_keys = {tuple(k) for k, _ in state.get('chunks') or ()}
    assert key in live_keys
    recovered = EpisodeSpool(str(tmp_path), segment_mb=1).recover(
        0, conn_unpack)
    replay = [rec['chunk'] for rec in recovered
              if chunk_key(rec['chunk']) in live_keys]
    assert len(replay) == len(chunks) - 1
    asm = ChunkAssembler(args)
    for rec, c in zip(recovered, replay):
        asm.add(c, mark=rec['idx'])
        ledger2.seed_chunk(chunk_key(c), c['chunk'])
    admitted = ledger2.admit_chunks(chunks)
    assert [c['chunk'] for c in admitted] == [chunks[-1]['chunk']]
    done = [r for r in (asm.add(c) for c in admitted)
            if r['status'] == 'complete']
    assert len(done) == 1
    _assert_records_equal(done[0]['record'], whole)
    ledger2.complete_chunked(key, done[0]['final_args'].get('task_id'))
    assert ledger2.admit_chunks(chunks) == []


# ---------------------------------------------------------------------------
# against the JAX package


def test_jax_and_port_assemblers_give_equal_records(wrapper):
    """The same chunk streams (shuffled, with a re-issued attempt's
    duplicates screened by each package's ledger) through the JAX
    ChunkAssembler and the port's give equal records: decoded moments,
    filled returns, outcome and steps (exact)."""
    rng = random.Random(3)
    for trial in range(4):
        args = _args(chunk_steps=2 * (trial % 2 + 1), compress_steps=2)
        chunks = _generate(wrapper, args, sample_key=300 + trial)
        again = _generate(wrapper, args, sample_key=300 + trial, task_id=8)
        stream = chunks[:1] + again
        rng.shuffle(stream)
        records = []
        for led, cls in ((TaskLedger(60), ChunkAssembler),
                         (JaxTaskLedger(60), jax_streaming.ChunkAssembler)):
            _, res = _assemble(args, led.admit_chunks(stream), cls=cls)
            records.append(res['record'])
        port, ref = records
        _assert_records_equal(port, ref)
        got, want = (decompress_moments(r['moment']) for r in records)
        assert [m['return'] for m in got] == [m['return'] for m in want]
        assert chunk_key(stream[0]) == jax_streaming.chunk_key(stream[0])


def test_build_chunk_matches_jax(wrapper):
    """The same moments through both packages' ``build_chunk`` decode to
    the same windows (exact) with the same header fields."""
    args = _args(chunk_steps=4, compress_steps=2)
    whole = _generate(wrapper, args, sample_key=12, stream=False)
    moments = decompress_moments(whole['moment'])
    for m in moments:
        m['return'] = {p: None for p in m['return']}
    ga = _gen_args(12)
    for base, final in ((0, False), (4, True)):
        window = moments[base:base + 4]
        kw = dict(final=final, outcome=whole['outcome'] if final else None)
        a = build_chunk(ga, base // 4, base, window, args, **kw)
        b = jax_build_chunk(ga, base // 4, base, window, args, **kw)
        assert {k: v for k, v in a.items() if k != 'moment'} == \
            {k: v for k, v in b.items() if k != 'moment'}
        assert pickle.dumps(decompress_moments(a['moment'])) == \
            pickle.dumps(decompress_moments(b['moment']))


# ---------------------------------------------------------------------------
# staleness-aware selection


def _buffer_args(**stream):
    a = {'maximum_episodes': 64, 'forward_steps': 2, 'burn_in_steps': 0,
         'compress_steps': 2}
    if stream:
        a['streaming'] = stream
    return a


def _fake_episodes(wrapper, n=6):
    args = _args(chunk_steps=2, compress_steps=2)
    eps = []
    for i in range(n):
        rec = _generate(wrapper, args, sample_key=2000 + i, stream=False)
        rec['recv_time'] = 100.0 + i
        eps.append(rec)
    return eps


def _picks(sel, eps, args, seed, n, **kw):
    random.seed(seed)
    out = [sel(eps, args, **kw) for _ in range(n)]
    return out, random.getstate()


def test_staleness_off_path_is_rng_sequence_identical(wrapper):
    """``staleness_half_life`` 0 adds no random draw: the picks and the
    generator's state equal those of a config without the block, and the
    JAX sampler's under the same seed."""
    eps = _fake_episodes(wrapper)
    off = _buffer_args(enabled=True, staleness_half_life=0.0, max_reselect=4)
    base, base_state = _picks(select_episode, eps, _buffer_args(), 99, 40)
    port, port_state = _picks(select_episode, eps, off, 99, 40)
    ref, ref_state = _picks(jax_select_episode, eps, off, 99, 40)
    assert base_state == port_state == ref_state
    assert base == port == ref


def test_staleness_weighting_prefers_fresh_chunks(wrapper):
    eps = _fake_episodes(wrapper, n=2)
    now = 1000.0
    eps[0]['chunk_recv'] = [now - 1e7]
    eps[0]['chunk_steps'] = 2
    eps[1]['recv_time'] = now
    args = _buffer_args(enabled=True, staleness_half_life=1.0,
                        max_reselect=4)
    picks, _ = _picks(select_episode, eps, args, 5, 200, now=now)
    stale = sum(1 for s in picks if s['recv_time'] == eps[0]['chunk_recv'][0])
    fresh = sum(1 for s in picks if s['recv_time'] == now)
    assert stale + fresh == len(picks) and fresh > stale


def test_staleness_picks_equal_the_jax_samplers(wrapper):
    """With staleness on, the same seed gives the JAX sampler's picks and
    generator state (exact), over partly streamed entries of mixed ages."""
    eps = _fake_episodes(wrapper, n=5)
    now = 500.0
    for i, ep in enumerate(eps[:3]):
        ep['chunk_steps'] = 2
        ep['chunk_recv'] = [now - 3.0 * (i + j) for j in range(3)]
    args = _buffer_args(enabled=True, staleness_half_life=2.0,
                        max_reselect=3)
    port, port_state = _picks(select_episode, eps, args, 21, 100, now=now)
    ref, ref_state = _picks(jax_select_episode, eps, args, 21, 100, now=now)
    assert port == ref and port_state == ref_state


def test_config_rejects_misaligned_chunk_steps():
    apply_defaults({})
    apply_defaults({'train_args': {
        'compress_steps': 4, 'streaming': {'enabled': True,
                                           'chunk_steps': 8}}})
    with pytest.raises(ConfigError, match='chunk_steps'):
        apply_defaults({'train_args': {
            'compress_steps': 4, 'streaming': {'enabled': True,
                                               'chunk_steps': 6}}})


# ---------------------------------------------------------------------------
# the resume-token handshake


class _Learner:
    """A learner's data port that answers RESUME_KIND with ``run_id`` at
    ``generation`` and echoes 'args' with ``[None]``."""

    def __init__(self, port, run_id, generation):
        self.run_id, self.generation = run_id, generation
        self.tokens = []
        self._stop = False
        self._thread = threading.Thread(target=self._serve, args=(port,),
                                        daemon=True)
        self._thread.start()
        for _ in range(200):          # until the port listens
            try:
                socket.create_connection(('127.0.0.1', port), 1).close()
                break
            except OSError:
                time.sleep(0.02)

    def _serve(self, port):
        for conn in accept_socket_connections(port, timeout=0.2):
            if self._stop:
                return
            if conn is None:
                continue
            threading.Thread(target=self._answer, args=(conn,),
                             daemon=True).start()

    def _answer(self, conn):
        try:
            while True:
                kind, body = conn.recv()
                if kind == RESUME_KIND:
                    self.tokens.append(body)
                    conn.send({'ok': body.get('run_id') == self.run_id,
                               'run_id': self.run_id,
                               'generation': self.generation})
                else:
                    conn.send([None] * len(body))
        except Exception:
            conn.close()

    def stop(self):
        self._stop = True
        self._thread.join()


def _gather(port, token):
    args = {'worker': {'num_parallel': 0, 'num_gathers': 1},
            'resume_token': token,
            'fault_tolerance': {'heartbeat_interval': 0,
                                'reconnect_initial_delay': 0.01,
                                'reconnect_max_delay': 0.02,
                                'reconnect_max_tries': 50}}
    return Gather(args, None, 0, reconnect=lambda: connect_socket_connection(
        '127.0.0.1', port))


@pytest.mark.parametrize('run_id,reattached', [('run-a', True),
                                               ('run-b', False)])
def test_gather_presents_its_token_on_a_redial(run_id, reattached):
    """After its link dies, a gather redials and presents ``{run_id,
    generation, gather}``: the restarted learner of its run answers ok at
    a new generation and the gather reattaches in place (the RPC goes
    through on the new link); a learner of another run refuses and the
    gather raises for a cold respawn."""
    (port,) = free_ports(1)
    server = _Learner(port, run_id, generation=1)
    try:
        gather = _gather(port, {'run_id': 'run-a', 'generation': 0})
        assert gather._server_rpc(('args', [None])) == [None]
        gather.server.sock.shutdown(socket.SHUT_RDWR)   # the link died
        if reattached:
            assert gather._server_rpc(('args', [None])) == [None]
            assert gather.stats['reattaches'] == 1
            assert gather._resume_token['generation'] == 1
        else:
            with pytest.raises(ConnectionError, match='resume token'):
                gather._server_rpc(('args', [None]))
            assert gather.stats['reattaches'] == 0
        assert server.tokens == [{'run_id': 'run-a', 'generation': 0,
                                  'gather': 0}]
        gather.hub.close()
    finally:
        server.stop()


@pytest.mark.timeout(420)
@pytest.mark.parametrize('drop_token', [False, True])
def test_streaming_learner_restart_reattaches_or_respawns(tmp_path,
                                                          drop_token):
    """The drill on a streaming learner (chunk_steps 2, the IMPACT target
    at clip 1.0): with its run token the restarted port learner keeps the
    host's gather (reattached, zero respawns) and finishes its budget with
    each streamed episode counted once; with the token deleted it is
    another run, refuses the gather's token, and the host respawns the
    gather cold (the run still ends)."""
    out, summary, host_out, rc, host_rc = restart_drill(
        tmp_path, {'compress_steps': 2,
                   'streaming': {'enabled': True, 'chunk_steps': 2,
                                 'target_clip': 1.0,
                                 'target_sync_epochs': 2}},
        drop_token=drop_token)
    assert rc == 0, out[-3000:]
    assert 'durable plane: restored ledger book' in out
    assert summary['model_epoch'] == 4
    assert summary['repeated_sample_keys'] == 0
    assert summary['streaming']['reassembled_episodes'] == \
        summary['distinct_sample_keys']
    restored = int(out.split('returned=')[1].split(')')[0])
    assert summary['episodes'] == restored + summary['distinct_sample_keys']
    if drop_token:
        assert summary['durable']['rejected_tokens'] >= 1
        assert 'respawning' in host_out
        assert summary['durable']['generation'] == 0
    else:
        assert host_rc == 0
        assert 'reattached across a learner restart' in host_out
        assert 'worker host: 0 gather respawns' in host_out
        assert summary['durable']['reattached'] >= 1
