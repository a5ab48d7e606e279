"""The compiled-performance plane on the port, held to the JAX package
where both compute the same function: the device-memory rows (the CPU's
``process_rss`` row; a CUDA card's row from ``torch.cuda.memory_stats``
and ``mem_get_info``, faked here), the utilization proxy and the memory
ratio (equal floats, tolerance 0), ``perf_status`` and the stage timer;
the steady-state sentinel over the port's run-time compiles (a CUDA
graph capture, a kernel library build): counted after
``mark_steady_state``, raised under ``abort`` before anything is
captured, exempt inside ``expected_compile``, and a CapturedCall's
capture (at its second call) counted only when its first call came in
steady state (the JAX package compiles at the first); and a small TicTacToe
learner on the CPU whose metrics rows carry the stage histograms, the
proxy, the memory sample and the steady-state mark, and whose
``profile_epochs`` trace is valid Chrome JSON."""

import contextlib
import json
import os
import sys
import types

import pytest
import torch

from handyrl_tpu import telemetry as jt
from handyrl_tpu.utils.timing import StageTimer as JaxStageTimer
from handyrl_tpu_torch import telemetry as pt
from handyrl_tpu_torch.utils.timing import StageTimer


@pytest.fixture(autouse=True)
def clean_plane(monkeypatch):
    """One intra-op thread; the plane's process-global state reset around
    each test."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv('OMP_NUM_THREADS', '1')
    monkeypatch.delenv('HANDYRL_TPU_RETRACE', raising=False)
    pt.clear_steady_state()
    pt.configure_perf_plane(True, 'warn')
    pt._STEADY['retraces'] = 0
    yield
    pt.clear_steady_state()
    pt.configure_perf_plane(True, 'warn')
    pt._PERF_PLANE.update(last_mem=[], util=None)
    torch.set_num_threads(before)


def test_the_cpu_row_is_the_jax_packages_process_rss_row():
    import jax
    got = pt.sample_device_memory()
    want = jt.sample_device_memory(jax.devices('cpu'))
    assert [sorted(r) for r in got] == [sorted(r) for r in want]
    assert got[0]['device'] == want[0]['device'] == 'process_rss'
    assert got[0]['bytes_in_use'] > 0 and got[0]['bytes_limit'] > 0
    gauges = pt.snapshot()['gauges']
    assert gauges['device_mem_bytes_in_use{device="process_rss"}'] > 0


def fake_cuda(monkeypatch, stats, free_total):
    cuda = types.SimpleNamespace(
        is_initialized=lambda: True, current_device=lambda: 0,
        memory_stats=lambda index: dict(stats),
        mem_get_info=lambda index: free_total)
    monkeypatch.setattr(sys.modules['torch'], 'cuda', cuda)


def test_a_card_row_reads_memory_stats_and_mem_get_info(monkeypatch):
    stats = {'allocated_bytes.all.current': 3 << 30,
             'allocated_bytes.all.peak': 5 << 30}
    fake_cuda(monkeypatch, stats, (60 << 30, 80 << 30))
    [row] = pt.sample_device_memory()
    assert row == {'device': 'cuda:0', 'bytes_in_use': 3 << 30,
                   'peak_bytes_in_use': 5 << 30, 'bytes_limit': 80 << 30}
    gauges = pt.snapshot()['gauges']
    assert gauges['device_mem_bytes_limit{device="cuda:0"}'] == 80 << 30
    # the ratio and the status block are the JAX package's functions of it
    assert pt.device_memory_utilization() == \
        jt.device_memory_utilization([row]) == 3 / 80
    status = pt.perf_status()
    assert sorted(status) == sorted(jt.perf_status())
    assert status['device_memory'] == [row]


def test_a_disabled_plane_samples_nothing():
    pt.configure_perf_plane(enabled=False)
    assert pt.sample_device_memory() == []
    assert pt.mark_steady_state() is False


@pytest.mark.parametrize('stages', [
    {}, {'dispatch': 1.0}, {'host_block': 2.0, 'dispatch': 2.0},
    {'select': {'s': 0.5, 'n': 3}, 'ipc': {'s': 0.25, 'n': 3},
     'h2d': {'s': 0.125, 'n': 3}, 'dispatch': {'s': 1.0, 'n': 3},
     'host_block': {'s': 3.0, 'n': 1}},
    {'host_block': 0.0, 'dispatch': 0.0}, {'decode': 'bad'}])
def test_the_utilization_proxy_is_the_jax_packages(stages):
    assert pt.utilization_from_stages(stages) == \
        jt.utilization_from_stages(stages)


def test_the_stage_timer_is_the_jax_packages():
    rp, rj = pt.MetricRegistry(), jt.MetricRegistry()
    tp, tj = StageTimer(registry=rp), JaxStageTimer(registry=rj)
    for i, stage in enumerate(pt.INGEST_STAGES * 3):
        tp.add(stage, 0.001 * (i + 1), i % 3 + 1)
        tj.add(stage, 0.001 * (i + 1), i % 3 + 1)
    with tp.section('dispatch'), tj.section('dispatch'):
        pass
    sp, sj = tp.snapshot(), tj.snapshot()
    assert sorted(sp) == sorted(sj)
    for k in sp:
        if k != 'dispatch':
            assert sp[k] == sj[k]
    assert sorted(rp.snapshot()['hists']) == sorted(rj.snapshot()['hists'])
    assert tp.snapshot(reset=True) and tp.snapshot() == {}


def counts():
    snap = pt.snapshot()['counters']
    return (snap.get('xla_retraces_total', 0),
            snap.get('xla_expected_compiles_total', 0),
            snap.get('xla_compile_events_total{event="graph_capture"}', 0),
            snap.get('xla_compile_events_total{event="kernel_build"}', 0))


def fake_capture(monkeypatch):
    """CountedGraph's and CapturedCall's CUDA calls replaced by no-ops: a
    capture runs its body on the host once, a replay returns its output.
    The launch counts the captures book go to a table of the test's own
    (the process's stays as it was: other tests read it)."""
    from handyrl_tpu_torch.ops import graphs, launches
    monkeypatch.setattr(launches, '_by_path', {})

    class Graph:
        def register_generator_state(self, gen):
            pass

        def replay(self):
            pass

    class Stream:
        device = 'cuda:0'

        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass
    cuda = types.SimpleNamespace(
        CUDAGraph=Graph, Stream=Stream,
        current_stream=lambda device=None: Stream(),
        stream=lambda s: contextlib.nullcontext(),
        graph=lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(graphs.torch, 'cuda', cuda)
    return lambda fn: graphs.CountedGraph(fn, Stream())


def test_the_sentinel_counts_a_capture_after_steady_state(monkeypatch):
    capture = fake_capture(monkeypatch)
    r0, e0, g0, _ = counts()
    capture(lambda: torch.zeros(2))         # warm-up: not a retrace
    assert counts()[:3] == (r0, e0, g0 + 1)
    assert pt.mark_steady_state('unit test')
    assert pt.snapshot()['gauges']['xla_steady_state'] == 1.0
    capture(lambda: torch.ones(2))
    assert counts()[:3] == (r0 + 1, e0, g0 + 2)
    assert pt.steady_retrace_count() == 1
    assert pt.perf_status()['retraces'] == 1
    events = [e for e in pt.recorder().events() if e['kind'] == 'retrace']
    assert 'graph_capture' in events[-1]['msg']


def test_a_call_first_made_in_warm_up_captures_as_warm_up(monkeypatch):
    """A CapturedCall runs eagerly at its first call and captures at its
    second (the JAX package compiles at the first): the capture of a call
    first made before steady state is no retrace, one first made after
    is."""
    from handyrl_tpu_torch.ops import graphs
    fake_capture(monkeypatch)
    ran = []
    early = graphs.CapturedCall(lambda: ran.append('early'), 'cuda')
    early()                                  # eager, before steady state
    pt.mark_steady_state()
    r0, e0, g0, _ = counts()
    early()                                  # its capture: warm-up
    early()                                  # a replay
    assert counts()[:3] == (r0, e0, g0 + 1)
    late = graphs.CapturedCall(lambda: ran.append('late'), 'cuda')
    late()
    late()                                   # first made in steady state
    assert counts()[:3] == (r0 + 1, e0, g0 + 2)
    assert ran == ['early', 'early', 'late', 'late']
    assert (early.captures, late.captures) == (1, 1)


def test_abort_raises_before_anything_is_captured(monkeypatch):
    capture = fake_capture(monkeypatch)
    pt.configure_perf_plane(retrace='abort')
    pt.mark_steady_state()
    ran = []
    with pytest.raises(pt.RetraceError, match='graph_capture'):
        capture(lambda: ran.append(1))
    assert ran == []
    # the environment's policy wins over the config's
    monkeypatch.setenv('HANDYRL_TPU_RETRACE', 'warn')
    capture(lambda: ran.append(1))
    assert ran == [1] and pt.retrace_policy() == jt.retrace_policy() == 'warn'


def test_expected_compile_and_off_are_exempt(monkeypatch):
    capture = fake_capture(monkeypatch)
    pt.mark_steady_state()
    r0, e0, g0, _ = counts()
    with pt.expected_compile('a fresh shape by design'):
        capture(lambda: torch.zeros(1))
    assert counts()[:3] == (r0, e0 + 1, g0 + 1)
    pt.configure_perf_plane(retrace='off')
    capture(lambda: torch.zeros(1))
    assert counts()[:3] == (r0, e0 + 1, g0 + 2)
    pt.clear_steady_state()
    capture(lambda: torch.zeros(1))
    assert counts()[0] == r0


def test_a_kernel_build_is_a_compile_and_a_present_library_is_not(
        monkeypatch, tmp_path):
    from handyrl_tpu_torch.ops import cuda_build
    built = []
    monkeypatch.setattr(cuda_build, '_build',
                        lambda todo: built.append(list(todo)) or {})
    monkeypatch.setattr(cuda_build, 'library_path',
                        lambda name: str(tmp_path / ('lib%s.so' % name)))
    *_, b0 = counts()
    pt.mark_steady_state()
    r0 = counts()[0]
    cuda_build.build(['targets'])
    assert built == [['targets']] and counts()[3] == b0 + 1
    assert counts()[0] == r0 + 1
    (tmp_path / 'libtargets.so').write_bytes(b'')
    cuda_build.build(['targets'])            # present: nothing compiles
    assert built == [['targets']] and counts()[3] == b0 + 1


def test_adopt_config_configures_the_plane(monkeypatch):
    for key in ('HANDYRL_TPU_TRACE', 'HANDYRL_TPU_BLACKBOX',
                'HANDYRL_TPU_RECORDER_EVENTS', 'HANDYRL_TPU_TRACE_RATE'):
        # empty (no operator override), and put back as it was after
        monkeypatch.setenv(key, '')
    args = {'telemetry': {'perf_plane': False, 'retrace': 'abort'}}
    pt.adopt_config(args)
    try:
        assert pt.perf_plane_enabled() is False
        assert pt.retrace_policy() == 'abort'
    finally:
        pt.configure_perf_plane(True, 'warn')
        pt.configure_recorder(pt.RECORDER_EVENTS_DEFAULT, 'blackbox',
                              force=True)


# ---------------------------------------------------------------------------
# the learner on the CPU


def test_the_learner_rows_carry_the_perf_plane_and_a_profile(tmp_path,
                                                            monkeypatch):
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.train import Learner
    monkeypatch.setenv('HANDYRL_TPU_TIMING', '1')
    # the learner mirrors its telemetry config into the environment: put
    # it back as it was after (later tests start processes)
    for key in ('HANDYRL_TPU_RUN_ID', 'HANDYRL_TPU_BLACKBOX',
                'HANDYRL_TPU_RECORDER_EVENTS', 'HANDYRL_TPU_TRACE',
                'HANDYRL_TPU_TRACE_RATE'):
        monkeypatch.setenv(key, os.environ.get(key, ''))
    raw = {'env_args': {'env': 'TicTacToe'},
           'train_args': {'batch_size': 16, 'forward_steps': 8,
                          'generation_envs': 8, 'num_batchers': 1,
                          'minimum_episodes': 40, 'update_episodes': 30,
                          'epochs': 3, 'model_dir': str(tmp_path / 'm'),
                          'metrics_jsonl': str(tmp_path / 'm.jsonl'),
                          'profile_epochs': '2',
                          'telemetry': {'alerts': {'interval': 0.5}}}}
    learner = Learner(apply_defaults(raw), device='cpu')
    learner.run()
    line = learner.summary()
    assert line['epochs'] == 3 and not line['failed']
    assert line['telemetry']['retraces'] == 0
    with open(str(tmp_path / 'm.jsonl')) as f:
        rows = [jt.validate_metrics_line(l) for l in f]
    assert len(rows) == 3
    last = rows[-1]['telemetry']
    assert last['gauges']['xla_steady_state'] == 1.0
    assert 0.0 <= last['gauges']['device_utilization_proxy'] <= 1.0
    assert last['gauges']['device_mem_bytes_in_use{device="process_rss"}'] > 0
    for stage in ('select', 'ipc', 'h2d', 'dispatch', 'host_block'):
        assert last['hists']['stage_seconds{stage="%s"}' % stage][
            'count'] > 0, stage
    assert last['counters']['episodes_generated_total'] > 0
    assert 'policy_lag' in rows[-1] and 'alerts' in rows[-1]
    [path] = line['telemetry']['profiles']
    assert path.startswith(str(tmp_path / 'm' / 'profile'))
    with open(path) as f:
        trace = json.load(f)
    assert trace['traceEvents']
    assert any(e.get('cat') == 'cpu_op' for e in trace['traceEvents'])


def test_profile_dir_alone_traces_the_steps_after_the_first_once(tmp_path):
    """With ``profile_dir`` and no epochs named, one trace opens after the
    first update step and closes PROFILE_STEPS steps later: one marked op
    a step lands in it exactly PROFILE_STEPS times, and no second trace
    opens."""
    from handyrl_tpu_torch.train import PROFILE_STEPS, Profiler
    prof = Profiler(torch.device('cpu'), str(tmp_path))
    a = torch.ones(4, 4)
    for steps in range(1, 2 * PROFILE_STEPS + 3):
        torch.mm(a, a)            # the step's marked op
        prof.step(steps)
        assert prof.active == (1 <= steps < 1 + PROFILE_STEPS)
    prof.stop()                   # nothing open: writes nothing
    [path] = prof.paths
    assert os.path.basename(path) == 'profile-%s-steps1-%d.json' % (
        pt.run_id(), 1 + PROFILE_STEPS)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    assert sum(e.get('name') == 'aten::mm' for e in events) == PROFILE_STEPS


def test_a_learner_with_profile_dir_alone_writes_one_step_trace(tmp_path,
                                                               monkeypatch):
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.train import PROFILE_STEPS, Learner
    for key in ('HANDYRL_TPU_RUN_ID', 'HANDYRL_TPU_BLACKBOX',
                'HANDYRL_TPU_RECORDER_EVENTS', 'HANDYRL_TPU_TRACE',
                'HANDYRL_TPU_TRACE_RATE'):
        monkeypatch.setenv(key, os.environ.get(key, ''))
    raw = {'env_args': {'env': 'TicTacToe'},
           'train_args': {'batch_size': 16, 'forward_steps': 8,
                          'generation_envs': 8, 'num_batchers': 1,
                          'minimum_episodes': 40, 'update_episodes': 30,
                          'epochs': 3, 'model_dir': str(tmp_path / 'm'),
                          'profile_dir': str(tmp_path / 'prof')}}
    learner = Learner(apply_defaults(raw), device='cpu')
    learner.run()
    line = learner.summary()
    assert line['epochs'] == 3 and not line['failed']
    # the window closes at its PROFILE_STEPS-th step, or at the trainer
    # thread's end when the run stops first
    [path] = line['telemetry']['profiles']
    assert os.path.dirname(path) == str(tmp_path / 'prof')
    assert path.endswith('-steps1-%d.json' % min(
        1 + PROFILE_STEPS, learner.trainer.steps))
    with open(path) as f:
        assert any(e.get('cat') == 'cpu_op'
                   for e in json.load(f)['traceEvents'])
