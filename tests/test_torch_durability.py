"""The port's durable training plane (handyrl_tpu_torch/utils/fs.py framed
records, spool.py, fault.py's journal and restored book, config.py's
``durability`` block, the learner's restart) against the JAX package's
(handyrl_tpu/utils/fs.py, spool.py, fault.py, config.py), mirroring
tests/test_durability.py.

Files are the contract: a frame, a spool segment and a ledger journal
written by either package are read by the other, byte for byte and
record for record (exact: both encode with msgpack's bytes and CRC32).
The end-to-end drill SIGKILLs a port learner serving a worker host over
localhost TCP and restarts it with ``restart_epoch: -1``: the restarted
learner restores the book, replays the spool and finishes the epoch
budget while the host's gather reattaches with no respawn."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import pytest
import torch

from handyrl_tpu import fault as jax_fault
from handyrl_tpu import spool as jax_spool
from handyrl_tpu.config import apply_defaults as jax_apply_defaults
from handyrl_tpu.connection import pack as jax_pack
from handyrl_tpu.connection import unpack as jax_unpack
from handyrl_tpu.utils import fs as jax_fs
from handyrl_tpu_torch import fault, spool
from handyrl_tpu_torch.config import (TRAIN_DEFAULTS, ConfigError,
                                      apply_defaults)
from handyrl_tpu_torch.connection import pack, unpack
from handyrl_tpu_torch.fault import RESTORED_ENDPOINT, LedgerJournal, TaskLedger
from handyrl_tpu_torch.utils import fs
from handyrl_tpu_torch.utils.fs import (append_framed_record, frame_record,
                                        open_append, read_framed_records)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


# the two packages' modules, by name, for the cross-package cases
PKG = {
    'torch': {'fs': fs, 'spool': spool, 'fault': fault, 'pack': pack,
              'unpack': unpack},
    'jax': {'fs': jax_fs, 'spool': jax_spool, 'fault': jax_fault,
            'pack': jax_pack, 'unpack': jax_unpack},
}
CROSS = [('torch', 'jax'), ('jax', 'torch')]


# ---------------------------------------------------------------------------
# framed records


def _write_frames(path, payloads, mod=fs):
    fd = mod.open_append(str(path))
    try:
        for payload in payloads:
            mod.append_framed_record(fd, payload)
    finally:
        os.close(fd)


def test_framed_record_roundtrip(tmp_path):
    path = tmp_path / 'frames.wal'
    payloads = [b'alpha', b'', b'x' * 4096]
    _write_frames(path, payloads)
    records, valid_bytes, torn = read_framed_records(str(path))
    assert records == payloads
    assert valid_bytes == path.stat().st_size
    assert not torn


def test_frames_are_the_jax_packages_bytes(tmp_path):
    """Exact: the same magic, header and CRC32."""
    for payload in (b'', b'alpha', bytes(range(256)) * 17,
                    pack({'idx': 3, 'episode': {'args': {0: 1}}})):
        assert frame_record(payload) == jax_fs.frame_record(payload)
    _write_frames(tmp_path / 'a.wal', [b'one', b'two'])
    _write_frames(tmp_path / 'b.wal', [b'one', b'two'], mod=jax_fs)
    assert (tmp_path / 'a.wal').read_bytes() == (tmp_path / 'b.wal'
                                                 ).read_bytes()


def test_framed_record_torn_tail_is_detected_and_truncatable(tmp_path):
    path = tmp_path / 'frames.wal'
    _write_frames(path, [b'good-1', b'good-2'])
    keep = path.stat().st_size
    with open(path, 'ab') as f:
        f.write(frame_record(b'torn-record-payload')[:-7])
    records, valid_bytes, torn = read_framed_records(str(path))
    assert records == [b'good-1', b'good-2']
    assert valid_bytes == keep and torn
    assert jax_fs.read_framed_records(str(path)) == (records, valid_bytes,
                                                     torn)
    os.truncate(str(path), valid_bytes)
    assert read_framed_records(str(path)) == ([b'good-1', b'good-2'],
                                              keep, False)


def test_framed_record_crc_mismatch_stops_the_scan(tmp_path):
    path = tmp_path / 'frames.wal'
    _write_frames(path, [b'aaaa', b'bbbb', b'cccc'])
    data = bytearray(path.read_bytes())
    frame_len = len(frame_record(b'aaaa'))
    data[2 * frame_len - 1] ^= 0xFF   # last payload byte of record 2
    path.write_bytes(bytes(data))
    records, valid_bytes, torn = read_framed_records(str(path))
    assert records == [b'aaaa']
    assert valid_bytes == frame_len and torn


# ---------------------------------------------------------------------------
# episode spool


def _make_spool(tmp_path, pkg='torch', **kw):
    kw.setdefault('segment_mb', 64.0)
    kw.setdefault('keep_segments', 2)
    return PKG[pkg]['spool'].EpisodeSpool(str(tmp_path), **kw)


def test_spool_append_recover_roundtrip(tmp_path):
    sp = _make_spool(tmp_path)
    for idx in range(5):
        sp.append(idx, pack({'idx': idx, 'episode': {'n': idx}}))
    sp.close()
    recovered = _make_spool(tmp_path).recover(2, unpack)
    assert [rec['idx'] for rec in recovered] == [2, 3, 4]
    assert [rec['episode']['n'] for rec in recovered] == [2, 3, 4]
    assert _make_spool(tmp_path).recover(5, unpack) == []


def test_spool_truncates_torn_tail_on_recover(tmp_path):
    sp = _make_spool(tmp_path)
    for idx in range(3):
        sp.append(idx, pack({'idx': idx, 'episode': idx}))
    sp.close()
    (segment,) = [os.path.join(sp.root, n) for n in os.listdir(sp.root)]
    good_size = os.path.getsize(segment)
    with open(segment, 'ab') as f:
        f.write(frame_record(pack({'idx': 3, 'episode': 3}))[:-3])
    recovered = _make_spool(tmp_path).recover(0, unpack)
    assert [rec['idx'] for rec in recovered] == [0, 1, 2]
    assert os.path.getsize(segment) == good_size


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_spool_rotation_gc_and_restart_sequencing(tmp_path, pkg):
    """The port's spool rotates, collects and renumbers as the JAX one:
    the same segment names and survivors after the same calls."""
    pk, upk = PKG[pkg]['pack'], PKG[pkg]['unpack']
    sp = _make_spool(tmp_path, pkg, segment_mb=0.0001, keep_segments=1)
    for idx in range(6):
        sp.append(idx, pk({'idx': idx, 'episode': 'x' * 256}))
    assert len(os.listdir(sp.root)) == 6
    assert sp.gc(4) == 3
    survivors = sorted(os.listdir(sp.root))
    assert survivors == ['%08d.wal' % i for i in (3, 4, 5)]
    recovered = _make_spool(tmp_path, pkg, keep_segments=1).recover(4, upk)
    assert [rec['idx'] for rec in recovered] == [4, 5]
    sp.close()
    fresh = _make_spool(tmp_path, pkg, segment_mb=0.0001, keep_segments=1)
    fresh.recover(6, upk)
    fresh.append(6, pk({'idx': 6, 'episode': 'y'}))
    fresh.close()
    assert sorted(os.listdir(fresh.root))[-1] == '%08d.wal' % 6


@pytest.mark.parametrize('writer,reader', CROSS)
def test_spool_written_by_one_package_is_recovered_by_the_other(
        tmp_path, writer, reader):
    """Exact: the segments are byte for byte equal, and the reader
    recovers the writer's records (int-keyed maps, numpy arrays, bytes),
    truncating the same torn tail."""
    import numpy as np
    records = [{'idx': i, 'episode': {
        'args': {'player': [0, 1], 'model_id': {0: i, 1: -1},
                 'sample_key': 10 + i, 'task_id': i},
        'steps': 3 + i, 'outcome': {0: 1.0, 1: -1.0},
        'moment': [b'\x00bz' * (i + 1)]}} for i in range(4)]
    records.append({'idx': 4, 'chunk': {
        'args': {'sample_key': 20}, 'chunk': 1, 'base': 4, 'steps': 4,
        'moment': [b'c'], 'final': False, 'outcome': None,
        'x': np.arange(6, dtype=np.float32).reshape(2, 3)}})
    w = _make_spool(tmp_path / 'w', writer)
    for rec in records:
        w.append(rec['idx'], PKG[writer]['pack'](rec))
    w.close()
    other = _make_spool(tmp_path / 'o', reader)
    for rec in records:
        other.append(rec['idx'], PKG[reader]['pack'](rec))
    other.close()
    seg = '%08d.wal' % 0
    assert ((tmp_path / 'w' / 'spool' / seg).read_bytes()
            == (tmp_path / 'o' / 'spool' / seg).read_bytes())
    with open(tmp_path / 'w' / 'spool' / seg, 'ab') as f:
        f.write(b'HRLW\x00\x00\x10')
    got = _make_spool(tmp_path / 'w', reader).recover(
        1, PKG[reader]['unpack'])
    assert [r['idx'] for r in got] == [1, 2, 3, 4]
    for r, want in zip(got, records[1:]):
        if 'episode' in want:
            assert r['episode'] == want['episode']
        else:
            np.testing.assert_array_equal(r['chunk'].pop('x'),
                                          want['chunk']['x'])
            assert r['chunk'] == {k: v for k, v in want['chunk'].items()
                                  if k != 'x'}
    assert os.path.getsize(tmp_path / 'w' / 'spool' / seg) == os.path.getsize(
        tmp_path / 'o' / 'spool' / seg)


# ---------------------------------------------------------------------------
# ledger journal


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def _journal_life(model_dir, pkg):
    """One life of a book under a journal: assign, complete, strand,
    cancel, stream a chunk, snapshot, and more deltas after it."""
    F = PKG[pkg]['fault']
    ledger = F.TaskLedger(deadline=30.0, clock=_Clock())
    ledger.journal = F.LedgerJournal(str(model_dir))
    tids = [ledger.assign('ep-a', {'role': 'g', 'model_id': {0: 5, 1: 3},
                                   'sample_key': k, 'player': [0, 1]})
            for k in range(4)]
    ledger.assign('ep-b', {'role': 'e', 'model_id': {0: 5}, 'sample_key': 2,
                           'player': [0]})
    ledger.admit([{'args': {'task_id': tids[0]}}])
    ledger.admit_chunks([{'args': {'sample_key': 1, 'task_id': tids[1]},
                          'chunk': 0}])
    ledger.flush_journal()
    ledger.journal.snapshot(dict(ledger.snapshot_state(),
                                 extra={'num_episodes': 4}))
    ledger.fail_endpoint('ep-b')
    ledger.cancel(tids[2])
    ledger.admit_chunks([{'args': {'sample_key': 1, 'task_id': tids[1]},
                          'chunk': 1},
                         {'args': {'sample_key': 3, 'task_id': tids[3]},
                          'chunk': 0}])
    ledger.complete_chunked(('k', 3), tids[3])
    ledger.assign('ep-a', {'role': 'g', 'model_id': {0: 6}, 'sample_key': 4,
                           'player': [0, 1]})
    ledger.flush_journal()
    ledger.journal.close()
    return ledger


@pytest.mark.parametrize('writer,reader', CROSS)
def test_ledger_journal_written_by_one_package_is_loaded_by_the_other(
        tmp_path, writer, reader):
    """Exact: the snap and the delta journal are the same bytes from both
    packages, and either package's load gives the same book (the port's
    ``key_marks`` aside, which the JAX book does not compute)."""
    _journal_life(tmp_path / 'w', writer)
    _journal_life(tmp_path / 'o', reader)
    for name in (LedgerJournal.SNAP, LedgerJournal.DELTA):
        assert ((tmp_path / 'w' / name).read_bytes()
                == (tmp_path / 'o' / name).read_bytes())
    got = PKG[reader]['fault'].LedgerJournal(str(tmp_path / 'w')).load()
    want = jax_fault.LedgerJournal(str(tmp_path / 'o')).load()
    marks = got.pop('key_marks', None)
    assert got == want
    assert marks in (None, {'g': 5})
    assert want['tasks'][5]['model_id'] == {0: 6}     # int keys survive
    assert want['chunks'] == [[['k', 1], [0, 1]]]
    assert want['chunks_closed'] == [['k', 3]]
    assert [b['sample_key'] for b in want['reissue']] == [2]


def test_ledger_journal_roundtrip_preserves_payloads(tmp_path):
    ledger = TaskLedger(deadline=30.0, clock=_Clock())
    ledger.journal = LedgerJournal(str(tmp_path))
    t0 = {'role': 'g', 'model_id': {0: 5, 1: 3}, 'sample_key': 17}
    t1 = {'role': 'e', 'model_id': {0: 5}, 'sample_key': 4}
    t2 = {'role': 'g', 'model_id': {0: 5}, 'sample_key': 18}
    tid0 = ledger.assign('ep-a', t0)
    ledger.assign('ep-a', t1)
    ledger.assign('ep-b', t2)
    ledger.admit([{'args': {'task_id': tid0}}])
    ledger.flush_journal()
    ledger.journal.close()
    state = LedgerJournal(str(tmp_path)).load()
    assert state['next_tid'] == 3
    assert sorted(state['tasks']) == [1, 2]
    assert state['tasks'][1] == {'role': 'e', 'model_id': {0: 5},
                                 'sample_key': 4}
    assert state['key_marks'] == {'g': 19, 'e': 5}
    restored = TaskLedger(deadline=30.0, clock=_Clock())
    restored.restore_state(state)
    assert restored.outstanding() == 2
    assert restored.outstanding_by_endpoint() == {RESTORED_ENDPOINT: 2}
    first, second = restored.next_reissue(), restored.next_reissue()
    assert {first['sample_key'], second['sample_key']} == {4, 18}
    assert restored.next_reissue() is None
    assert restored.assign('ep-new', {'role': 'g', 'model_id': {}}) == 3


def test_ledger_journal_snapshot_folds_deltas_and_replays_idempotently(
        tmp_path):
    ledger = TaskLedger(deadline=30.0, clock=_Clock())
    ledger.journal = LedgerJournal(str(tmp_path))
    ledger.assign('ep', {'role': 'g', 'sample_key': 0})
    tid1 = ledger.assign('ep', {'role': 'g', 'sample_key': 1})
    ledger.admit([{'args': {'task_id': tid1}}])
    ledger.flush_journal()
    ledger.journal.snapshot(ledger.snapshot_state())
    assert os.path.getsize(tmp_path / LedgerJournal.DELTA) == 0
    ledger.assign('ep', {'role': 'g', 'sample_key': 2})
    ledger.journal.close()
    state = LedgerJournal(str(tmp_path)).load()
    assert sorted(state['tasks']) == [0, 2]
    assert state['next_tid'] == 3
    journal = LedgerJournal(str(tmp_path))
    journal.record('c', tid1)
    journal.record('s', 99)
    journal.close()
    again = LedgerJournal(str(tmp_path)).load()
    assert sorted(again['tasks']) == [0, 2]
    assert again['reissue'] == state['reissue']
    assert again == dict(jax_fault.LedgerJournal(str(tmp_path)).load(),
                         key_marks={'g': 3})


def test_ledger_journal_torn_delta_tail_truncates_on_load(tmp_path):
    ledger = TaskLedger(deadline=30.0, clock=_Clock())
    ledger.journal = LedgerJournal(str(tmp_path))
    ledger.assign('ep', {'role': 'g', 'sample_key': 7})
    ledger.journal.close()
    delta = tmp_path / LedgerJournal.DELTA
    good_size = os.path.getsize(delta)
    with open(delta, 'ab') as f:
        f.write(b'HRLW\x00\x00\xff\xff')
    state = LedgerJournal(str(tmp_path)).load()
    assert sorted(state['tasks']) == [0]
    assert state['tasks'][0]['sample_key'] == 7
    assert os.path.getsize(delta) == good_size


def test_key_marks_keep_fresh_tasks_off_replayed_keys(tmp_path):
    """ROADMAP.md F4: a learner killed before its first snapshot leaves
    deltas only; the tasks it completed are gone from the book, so the
    JAX book's counters restart below their sample keys, and a fresh
    task would replay a key whose episode the spool gives back. The
    port's load marks every key assigned since the snapshot."""
    ledger = TaskLedger(deadline=30.0, clock=_Clock())
    ledger.journal = LedgerJournal(str(tmp_path))
    for k in range(3):
        tid = ledger.assign('ep', {'role': 'g', 'sample_key': k})
        ledger.admit([{'args': {'task_id': tid}}])
    ledger.assign('ep', {'role': 'e', 'sample_key': 0})
    ledger.flush_journal()
    ledger.journal.close()
    state = LedgerJournal(str(tmp_path)).load()
    assert state['tasks'] == {3: {'role': 'e', 'sample_key': 0}}
    assert state['key_marks'] == {'g': 3, 'e': 1}
    assert 'key_marks' not in jax_fault.LedgerJournal(str(tmp_path)).load()


@pytest.mark.parametrize('pkg', ['torch', 'jax'])
def test_restored_task_cancel_closes_the_unflushed_completion_window(
        tmp_path, pkg):
    """The same book from either package: the spooled task cancels out of
    the restored state, the lost one re-issues with its payload, and the
    replayed upload of the spooled episode drops as a duplicate."""
    ledger = TaskLedger(deadline=30.0, clock=_Clock())
    ledger.journal = LedgerJournal(str(tmp_path))
    tid_spooled = ledger.assign('ep', {'role': 'g', 'sample_key': 5})
    ledger.assign('ep', {'role': 'g', 'sample_key': 6})
    ledger.admit([{'args': {'task_id': tid_spooled}}])
    ledger.journal.close()           # crash: the completion never flushed
    state = PKG[pkg]['fault'].LedgerJournal(str(tmp_path)).load()
    assert sorted(state['tasks']) == [0, 1]
    state['tasks'].pop(tid_spooled, None)
    for F in (fault, jax_fault):
        restored = F.TaskLedger(deadline=30.0, clock=_Clock())
        restored.restore_state(state)
        assert restored.next_reissue() == {'role': 'g', 'sample_key': 6}
        assert restored.next_reissue() is None
        assert restored.admit([{'args': {'task_id': tid_spooled}}]) == []
        assert restored.stats['duplicates'] == 1
        assert restored.stats['reissued'] == 1


def test_restored_reissue_skips_tasks_a_reattached_gather_completed():
    state = {'tasks': {0: {'role': 'g', 'sample_key': 0},
                       1: {'role': 'g', 'sample_key': 1}},
             'reissue': [{'role': 'e', 'sample_key': 9}], 'next_tid': 2}
    books = []
    for F in (fault, jax_fault):
        ledger = F.TaskLedger(deadline=30.0, clock=_Clock())
        ledger.restore_state(state)
        assert len(ledger.admit([{'args': {'task_id': 0}}])) == 1
        books.append([ledger.next_reissue() for _ in range(3)]
                     + [ledger.assign('ep', {'role': 'g'}),
                        dict(ledger.stats)])
    assert books[0] == books[1]
    assert books[0][:3] == [{'role': 'g', 'sample_key': 1},
                            {'role': 'e', 'sample_key': 9}, None]


# ---------------------------------------------------------------------------
# config


def test_durability_defaults_equal_the_jax_packages():
    jax_ta = jax_apply_defaults({})['train_args']
    ta = apply_defaults({})['train_args']
    assert ta['durability'] == jax_ta['durability'] \
        == TRAIN_DEFAULTS['durability']
    assert ta['streaming'] == jax_ta['streaming'] \
        == TRAIN_DEFAULTS['streaming']


@pytest.mark.parametrize('block,value,key', [
    ('durability', {'segment_mb': 0}, 'segment_mb'),
    ('durability', {'keep_segments': -1}, 'keep_segments'),
    ('streaming', {'chunk_steps': 0}, 'chunk_steps'),
    ('streaming', {'chunk_steps': 6}, 'chunk_steps'),
    ('streaming', {'staleness_half_life': -1.0}, 'staleness_half_life'),
    ('streaming', {'max_reselect': 0}, 'max_reselect'),
    ('streaming', {'target_clip': -0.5}, 'target_clip'),
    ('streaming', {'target_sync_epochs': 0}, 'target_sync_epochs'),
])
def test_durable_plane_checks_are_the_jax_packages(block, value, key):
    """Each value the JAX package refuses (an AssertionError there) is a
    ConfigError here naming the key; the edge values both accept."""
    with pytest.raises(AssertionError):
        jax_apply_defaults({'train_args': {block: value}})
    with pytest.raises(ConfigError, match=key):
        apply_defaults({'train_args': {block: value}})
    edge = {k: (1 if k == 'target_sync_epochs' or k == 'max_reselect'
                else 8 if k == 'chunk_steps' else 0.0001 if k == 'segment_mb'
                else 0) for k in value}
    jax_apply_defaults({'train_args': {block: edge}})
    apply_defaults({'train_args': {block: edge}})


def test_streaming_and_target_are_accepted_and_the_league_refused():
    args = apply_defaults({'train_args': {
        'streaming': {'enabled': True, 'chunk_steps': 32,
                      'staleness_half_life': 5.0, 'max_reselect': 2,
                      'target_clip': 1.0, 'target_sync_epochs': 2},
        'durability': {'spool': False, 'segment_mb': 8, 'keep_segments': 0,
                       'ledger_snapshot': False}}})
    assert args['train_args']['streaming']['target_clip'] == 1.0
    # the league runs with the registry it draws its members from
    with pytest.raises(ConfigError, match='league.enabled requires '
                       'serving.publish'):
        apply_defaults({'train_args': {'league': {'enabled': True}}})
    with pytest.raises(ConfigError, match='streaming'):
        apply_defaults({'train_args': {'streaming': {'window': 3}}})


# ---------------------------------------------------------------------------
# the learner's restart end to end (localhost TCP, the CLI entry points)


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(('127.0.0.1', 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _wait_for(predicate, deadline, poll=0.25):
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(poll)
    return predicate()


# the environment variables the telemetry config is mirrored into
TELEMETRY_MIRROR = ('HANDYRL_TPU_RUN_ID', 'HANDYRL_TPU_TELEMETRY',
                    'HANDYRL_TPU_TRACE', 'HANDYRL_TPU_TRACE_RATE',
                    'HANDYRL_TPU_BLACKBOX', 'HANDYRL_TPU_RECORDER_EVENTS',
                    'HANDYRL_TPU_RETRACE')


def restart_drill(tmp_path, train_args=None, drop_token=False, epochs=4,
                  kill_after='updated model'):
    """Serve a worker host of 2 workers from ``python -m
    handyrl_tpu_torch.train --server`` (TicTacToe, VTRACE, the durability
    defaults, ``train_args`` merged in), SIGKILL the learner once
    ``kill_after`` shows in its log, restart it (``restart_epoch: -1``;
    its run token deleted first with ``drop_token``) and wait for both to
    end. Returns (the restarted learner's log, its JSON line, the host's
    log, the two exit codes)."""
    entry, data = free_ports(2)
    cfg = {'env_args': {'env': 'TicTacToe'},
           'train_args': {
               'batch_size': 8, 'forward_steps': 8, 'update_episodes': 24,
               'minimum_episodes': 24, 'epochs': epochs, 'num_batchers': 1,
               'restart_epoch': -1, 'model_dir': str(tmp_path / 'models'),
               'policy_target': 'VTRACE', 'value_target': 'VTRACE',
               'fault_tolerance': {
                   'heartbeat_interval': 1.0, 'liveness_timeout': 8.0,
                   'rpc_timeout': 30.0, 'task_deadline': 30.0,
                   'reconnect_initial_delay': 0.25,
                   'reconnect_max_delay': 1.0, 'reconnect_max_tries': 240}},
           'worker_args': {'server_address': '127.0.0.1', 'num_parallel': 2}}
    cfg['train_args'].update(train_args or {})
    path = tmp_path / 'cfg.json'
    path.write_text(json.dumps(cfg))
    # the processes take their telemetry, and the run identity that a
    # dropped token must change, from their config: never from the
    # environment a learner that ran earlier in this process mirrored it to
    env = {k: v for k, v in os.environ.items() if k not in TELEMETRY_MIRROR}
    env.update(OMP_NUM_THREADS='1', PYTHONUNBUFFERED='1',
               HANDYRL_TPU_ENTRY_PORT=str(entry),
               HANDYRL_TPU_DATA_PORT=str(data))
    learner_cmd = [sys.executable, '-m', 'handyrl_tpu_torch.train',
                   '--config', str(path), '--device', 'cpu', '--server']
    logs = {n: open(tmp_path / (n + '.log'), 'w')
            for n in ('learner1', 'learner2', 'host')}
    procs = []

    def start(cmd, log):
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log,
                                      stderr=subprocess.STDOUT))
        return procs[-1]

    def text(name):
        return (tmp_path / (name + '.log')).read_text()
    try:
        learner1 = start(learner_cmd, logs['learner1'])
        assert _wait_for(lambda: 'started server' in text('learner1')
                         or learner1.poll() is not None, time.time() + 120)
        assert learner1.poll() is None, text('learner1')[-2000:]
        host = start([sys.executable, '-m', 'handyrl_tpu_torch.worker',
                      '--config', str(path), '--device', 'cpu'],
                     logs['host'])
        assert _wait_for(lambda: kill_after in text('learner1')
                         or learner1.poll() is not None, time.time() + 240)
        assert learner1.poll() is None, 'the learner ended before the kill'
        learner1.send_signal(signal.SIGKILL)
        learner1.wait(timeout=30)
        if drop_token:
            os.unlink(tmp_path / 'models' / 'run_token.json')
        learner2 = start(learner_cmd, logs['learner2'])
        learner2.wait(timeout=300)
        host.wait(timeout=120)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
    out = text('learner2')
    lines = [line for line in out.splitlines() if line.startswith('{')]
    return (out, json.loads(lines[-1]) if lines else None, text('host'),
            learner2.returncode, host.returncode)


@pytest.mark.timeout(420)
def test_learner_restart_zero_loss(tmp_path):
    """The mirror of tests/test_durability.py's slow drill, on the port:
    the restarted learner restores the book, replays the spool, finishes
    the budget with each episode counted once (no sample key twice, the
    counted episodes those restored plus those it took), and the host's
    gather reattaches with zero respawns."""
    out, summary, host_out, rc, host_rc = restart_drill(tmp_path)
    assert rc == 0 and host_rc == 0, out[-3000:]
    assert 'durable plane: restored ledger book' in out
    assert 'auto-resume: newest valid checkpoint' in out
    assert 'reattached across a learner restart' in host_out
    assert 'respawning' not in host_out
    assert 'worker host: 0 gather respawns' in host_out
    restored = int(out.split('returned=')[1].split(')')[0])
    assert summary['model_epoch'] == 4
    assert summary['repeated_sample_keys'] == 0
    assert summary['episodes'] == restored + summary['distinct_sample_keys']
    assert summary['durable']['generation'] == 1
    assert summary['durable']['reattached'] >= 1
    assert summary['fleet']['reattaches'] >= 1
