"""The port's telemetry core (handyrl_tpu_torch/telemetry.py) held to the
JAX package's (handyrl_tpu/telemetry.py) on the same inputs: snapshots
from a numpy generator with a seed go through both packages'
``merge_snapshots``, ``relabel``, ``summarize``, ``hist_quantile`` and
``render_prometheus`` and must come out equal (the same Python float
arithmetic: tolerance 0, bytes for the exposition text); the defaults,
the alert catalog, scripted alert streams, ``from_config``, the status
text, the blackbox layout and the JSONL schema check agree; the exporter
answers on 127.0.0.1; the config's ``telemetry`` checks are the JAX
package's, as ConfigErrors; and every metric name the JAX package
registers appears in the port's sources (the serving tier's too, which
its exporters serve), apart from the mesh's (ROADMAP.md §1 item 5)."""

import glob
import json
import os
import re
import urllib.request

import numpy as np
import pytest

from handyrl_tpu import config as jax_config
from handyrl_tpu import telemetry as jt
from handyrl_tpu_torch import config as port_config
from handyrl_tpu_torch import telemetry as pt
from handyrl_tpu_torch.config import ConfigError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """Tests of a parallel run share the cores (OMP_NUM_THREADS=1 for any
    process one starts)."""
    monkeypatch.setenv('OMP_NUM_THREADS', '1')


def seeded_snapshots(seed, peers=3):
    """``peers`` registry snapshots of random counters, gauges and
    histograms (DEFAULT_BUCKETS and BATCH_ROW_BUCKETS bounds), with keys
    shared between peers and labelled keys."""
    rng = np.random.default_rng(seed)
    snaps = []
    for p in range(peers):
        counters, gauges, hists = {}, {}, {}
        for i in range(6):
            labels = {'gather': str(int(rng.integers(0, 3)))} if i % 2 else {}
            counters[pt.metric_key('c%d_total' % i, labels)] = int(
                rng.integers(0, 1000))
            gauges[pt.metric_key('g%d' % i, labels)] = float(
                rng.normal() * 100)
        for i, bounds in enumerate((pt.DEFAULT_BUCKETS,
                                    pt.BATCH_ROW_BUCKETS)):
            buckets = [int(v) for v in rng.integers(0, 9, len(bounds) + 1)]
            hists[pt.metric_key('h%d_seconds' % i, {'stage': 'x'})] = {
                'bounds': list(bounds), 'buckets': buckets,
                'sum': float(rng.random() * 50), 'count': int(sum(buckets))}
        snaps.append({'counters': counters, 'gauges': gauges,
                      'hists': hists})
    return snaps


def strip_stamps(snap):
    return {k: v for k, v in snap.items() if k not in ('run_id', 'time')}


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_merge_relabel_summarize_quantile_equal_the_jax_package(seed):
    """Exact (tolerance 0): both sum the same floats in the same order."""
    snaps = seeded_snapshots(seed)
    snaps.append(None)                  # a peer without a snapshot
    conflict = seeded_snapshots(seed + 100, peers=1)[0]
    key = next(iter(conflict['hists']))
    conflict['hists'][key] = dict(conflict['hists'][key],
                                  bounds=[1.0, 2.0], buckets=[1, 2, 3])
    snaps.append(conflict)              # mismatched bounds: dropped, counted
    mp, mj = pt.merge_snapshots(snaps), jt.merge_snapshots(snaps)
    assert strip_stamps(mp) == strip_stamps(mj)
    assert mp['hist_bound_conflicts'] == 1
    assert pt.relabel(mp, source='fleet') == jt.relabel(mp, source='fleet')
    assert pt.summarize(mp) == jt.summarize(mj)
    for h in mp['hists'].values():
        for q in (0.0, 0.1, 0.5, 0.95, 0.99, 1.0):
            assert pt.hist_quantile(h['bounds'], h['buckets'], h['count'],
                                    q) == jt.hist_quantile(
                h['bounds'], h['buckets'], h['count'], q)
    assert pt.split_key('a{b="1",c="2"}') == jt.split_key('a{b="1",c="2"}')


@pytest.mark.parametrize('seed', [3, 4])
def test_render_prometheus_is_byte_equal(seed):
    snaps = seeded_snapshots(seed)
    local = snaps[0]
    fleet = pt.relabel(pt.merge_snapshots(snaps[1:]), source='fleet')
    text = pt.render_prometheus([local, fleet])
    assert text.encode() == jt.render_prometheus([local, fleet]).encode()
    assert '# TYPE h0_seconds histogram' in text
    assert 'source="fleet"' in text


def test_defaults_and_the_alert_catalog_are_the_jax_packages():
    assert pt.TELEMETRY_DEFAULTS == jt.TELEMETRY_DEFAULTS
    assert pt.BUILTIN_ALERTS == jt.BUILTIN_ALERTS
    assert pt.INGEST_STAGES == jt.INGEST_STAGES
    assert pt.HOST_STATE_CODES == jt.HOST_STATE_CODES
    for name in ('DEFAULT_BUCKETS', 'BATCH_ROW_BUCKETS', 'LAG_EPOCH_BUCKETS',
                 'AGE_SECOND_BUCKETS', 'COMPILE_SECOND_BUCKETS'):
        assert getattr(pt, name) == getattr(jt, name), name
    for raw in (True, False, {'trace_dir': 't', 'alerts': False}, None):
        assert pt.config_block({'telemetry': raw} if raw is not None
                               else {}) == jt.config_block(
            {'telemetry': raw} if raw is not None else {})


def scripted_stream(seed, steps=40):
    """Snapshots and times of a run whose counters and gauges trip and
    clear several built-in rules (numpy draws from ``seed``)."""
    rng = np.random.default_rng(seed)
    out, now = [], 1000.0
    c = {'learner_episodes_returned_total': 0, 'guard_nonfinite_total': 0,
         'hub_disconnects_total{reason="read_error"}': 0,
         'fleet_host_transitions_total{from="draining",to="quarantined"}': 0,
         'serve_requests_total': 0, 'serve_shed_total': 0,
         'gather_uploads_total{gather="0",kind="episode"}': 0}
    for i in range(steps):
        now += float(rng.uniform(0.5, 20.0))
        if i < 15 or i > 30:      # an ingest stall in between
            c['learner_episodes_returned_total'] += int(rng.integers(1, 9))
        if rng.random() < 0.2:
            c['guard_nonfinite_total'] += int(rng.integers(1, 40))
        if rng.random() < 0.15:
            c['hub_disconnects_total{reason="read_error"}'] += 1
        if rng.random() < 0.1:
            c['fleet_host_transitions_total{from="draining",'
              'to="quarantined"}'] += 1
        c['serve_requests_total'] += int(rng.integers(50, 100))
        c['serve_shed_total'] += int(rng.integers(0, 12))
        c['gather_uploads_total{gather="0",kind="episode"}'] += 1
        gauges = {'policy_lag_mean': float(rng.uniform(0, 30)),
                  'device_mem_utilization': float(rng.uniform(0.8, 1.0))}
        hists = {'stage_seconds{stage="dispatch"}': {
            'bounds': list(pt.DEFAULT_BUCKETS),
            'buckets': [0] * (len(pt.DEFAULT_BUCKETS) + 1), 'sum': 0.0,
            'count': 0}}
        out.append(([{'counters': dict(c), 'gauges': gauges,
                      'hists': hists}, None], now))
    return out


@pytest.mark.parametrize('block', [
    None,
    {'interval': 1.0, 'rules': [
        {'name': 'ingest_stall', 'for': 5.0},
        {'name': 'lag_high', 'metric': 'policy_lag_mean', 'op': '>=',
         'threshold': 20.0, 'for': 10.0, 'clear_for': 15.0},
        {'name': 'uploads_slow', 'metric': 'gather_uploads_total',
         'labels': 'kind="episode"', 'kind': 'rate', 'op': '<',
         'threshold': 0.2}]},
    {'builtin': False, 'rules': [
        {'name': 'shed_ratio', 'metric': 'serve_shed_total',
         'denominator': 'serve_requests_total', 'kind': 'ratio',
         'threshold': 0.06, 'for': 3.0}]}])
def test_alert_engines_agree_on_a_scripted_stream(block):
    args = {'telemetry': {'alerts': block}} if block is not None else {}
    ep = pt.AlertEngine.from_config(args)
    ej = jt.AlertEngine.from_config(args)
    assert ep.rule_names() == ej.rule_names()
    fired = set()
    for snaps, now in scripted_stream(7):
        bp, bj = ep.evaluate(snaps, now), ej.evaluate(snaps, now)
        assert bp == bj
        fired |= set(bp['fired'])
    assert fired          # the stream trips rules, not only quiet ones


@pytest.mark.parametrize('args', [
    {}, {'telemetry': False}, {'telemetry': {'enabled': False}},
    {'telemetry': {'alerts': False}},
    {'telemetry': {'alerts': {'enabled': False}}},
    {'telemetry': {'alerts': [{'name': 'x', 'metric': 'm', 'for': 2}]}},
    {'telemetry': {'alerts': {'builtin': False, 'interval': 0.1,
                              'rules': [{'name': 'y', 'metric': ['a', 'b'],
                                         'kind': 'rate'}]}}},
    {'telemetry': {'alerts': {'rules': [
        {'name': 'heartbeat_misses', 'threshold': 2.0, 'for': 30.0}]}}}])
def test_from_config_builds_the_same_rules(args):
    ep, ej = pt.AlertEngine.from_config(args), jt.AlertEngine.from_config(args)
    if ej is None:
        assert ep is None
        return
    assert ep.interval == ej.interval
    attrs = ('name', 'metric', 'denominator', 'kind', 'labels', 'op',
             'threshold', 'for_s', 'clear_for', 'arm_metric')
    assert [[getattr(r, a) for a in attrs] for r in ep._rules] == \
        [[getattr(r, a) for a in attrs] for r in ej._rules]


def test_alert_rule_errors_are_the_jax_packages():
    for spec in ({'name': 'a', 'kind': 'mean'}, {'name': 'b', 'op': '!='},
                 {'name': 'c', 'kind': 'ratio', 'metric': 'm'}):
        with pytest.raises(ValueError) as ep:
            pt.AlertRule(spec)
        with pytest.raises(ValueError) as ej:
            jt.AlertRule(spec)
        assert str(ep.value) == str(ej.value)


STATUS = {
    'role': 'learner', 'pid': 4242, 'run_id': 'abc123', 'time': 5.0,
    'progress': {'epoch': 3, 'steps': 120, 'episodes': 512, 'buffer': 400},
    'alerts': {'active': ['ingest_stall'], 'fired': {'ingest_stall': 2,
                                                     'heartbeat_misses': 1}},
    'fleet_hosts': {'host-127.0.0.1': 'healthy', 'host-10.0.0.2': 'draining'},
    'perf': {'steady_state': True, 'retraces': 0, 'retrace_policy': 'warn',
             'device_utilization_proxy': 0.42,
             'device_mem_utilization': 0.137,
             'device_memory': [{'device': 'cuda:0', 'bytes_in_use': 3 << 30,
                                'peak_bytes_in_use': 5 << 30,
                                'bytes_limit': 80 << 30}]},
    'recorder': {'events': 17, 'capacity': 256, 'dropped': 0,
                 'dumps': ['a.json']}}


def test_render_status_is_the_same_text():
    text = pt.render_status(STATUS)
    assert text == jt.render_status(STATUS)
    assert 'FIRING ingest_stall' in text and 'mem cuda:0' in text


def test_blackbox_dump_has_the_jax_layout(tmp_path):
    pt.record_event('guard', 'nonfinite updates', bad=3)
    jt.record_event('guard', 'nonfinite updates', bad=3)
    path_p = pt.recorder().dump('unit-test', directory=str(tmp_path / 'p'),
                                context={'why': 'test'})
    path_j = jt.recorder().dump('unit-test', directory=str(tmp_path / 'j'),
                                context={'why': 'test'})
    dp, dj = json.load(open(path_p)), json.load(open(path_j))
    assert sorted(dp) == sorted(dj)
    assert dp['schema'] == dj['schema'] == 'handyrl_tpu.blackbox/1'
    assert sorted(dp['stats']) == sorted(dj['stats'])
    assert sorted(dp['metrics']) == sorted(dj['metrics'])
    assert dp['events'][-1]['kind'] == 'guard' and dp['events'][-1]['bad'] == 3
    assert os.path.basename(path_p) == '%s-%d-%s.json' % (
        re.sub(r'[^A-Za-z0-9_.-]', '_', pt._TRACE.label), os.getpid(),
        pt.run_id())


def test_registry_parts_agree_with_the_jax_registry():
    """Gauge.add, observe_agg, quantile, span, observe_stage and
    snapshot(reset=) on one op sequence in both registries."""
    regs = (pt.MetricRegistry(), jt.MetricRegistry())
    rng = np.random.default_rng(11)
    ops = [(float(rng.uniform(0, 2)), int(rng.integers(1, 5)))
           for _ in range(50)]
    for reg in regs:
        g = reg.gauge('depth', q='a')
        h = reg.histogram('lat_seconds')
        for total, n in ops:
            g.add(total)
            h.observe_agg(total, n)
            reg.observe_stage('dispatch', total / 10, n)
        with reg.span('epoch_update'):
            pass
    sp, sj = (r.snapshot(reset=True) for r in regs)
    sp['hists'].pop('stage_seconds{stage="epoch_update"}')
    sj['hists'].pop('stage_seconds{stage="epoch_update"}')
    assert strip_stamps(sp) == strip_stamps(sj)
    assert regs[0].histogram('lat_seconds').quantile(0.5) == \
        regs[1].histogram('lat_seconds').quantile(0.5) == 0.0   # reset
    assert regs[0].snapshot()['gauges'] == regs[1].snapshot()['gauges']


@pytest.mark.parametrize('line,fleet', [
    ('{"epoch": 1}', False),
    ('{"epoch": 1, "steps": 2, "episodes": 3, "time": 4, "run_id": "r", '
     '"telemetry": {"counters": {}}}', False),
    ('{"epoch": 1, "steps": 2, "episodes": 3, "time": 4, "run_id": "r", '
     '"telemetry": {"counters": {}}}', True),
    ('{"epoch": 1, "steps": 2, "episodes": 3, "time": 4, "run_id": "r", '
     '"telemetry": {"counters": {}}, "alerts": {"fired": {}}}', False)])
def test_validate_metrics_line_agrees(line, fleet):
    outcomes = []
    for mod in (pt, jt):
        try:
            mod.validate_metrics_line(line, fleet=fleet)
            outcomes.append(None)
        except ValueError as exc:
            outcomes.append(str(exc))
    assert outcomes[0] == outcomes[1]


def test_exporter_answers_metrics_statusz_and_healthz(capsys):
    reg = pt.MetricRegistry()
    reg.counter('learner_episodes_returned_total').inc(7)
    reg.histogram('stage_seconds', stage='dispatch').observe(0.01)
    fleet = pt.relabel({'counters': {'gather_uploads_total{gather="0"}': 3},
                        'gauges': {}, 'hists': {}}, source='fleet')
    exporter = pt.TelemetryExporter(
        lambda: [reg.snapshot(), fleet], port=0, host='127.0.0.1',
        status=lambda: {'progress': {'epoch': 2}}).start()
    try:
        base = 'http://127.0.0.1:%d' % exporter.port
        text = urllib.request.urlopen(base + '/metrics', timeout=5).read(
            ).decode()
        assert text == pt.render_prometheus([reg.snapshot(), fleet])
        assert 'learner_episodes_returned_total 7' in text
        assert 'gather_uploads_total{gather="0",source="fleet"} 3' in text
        status = json.loads(urllib.request.urlopen(
            base + '/statusz', timeout=5).read())
        assert status['progress'] == {'epoch': 2}
        assert {'run_id', 'role', 'pid', 'recorder'} <= set(status)
        assert urllib.request.urlopen(base + '/healthz', timeout=5).read() \
            == b'ok\n'
        # the operator view: both packages' status_main print the same
        target = '127.0.0.1:%d' % exporter.port
        pt.status_main(None, [target])
        got = capsys.readouterr().out
        jt.status_main(None, [target])
        want = capsys.readouterr().out
        got_lines, want_lines = got.splitlines(), want.splitlines()
        assert got_lines[1:] == want_lines[1:]   # its recorder line moves
        assert 'progress: epoch=2' in got
    finally:
        exporter.stop()


def test_exporter_takes_an_ephemeral_port_when_its_port_is_busy():
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        s.listen(1)
        busy = s.getsockname()[1]
        exporter = pt.TelemetryExporter(lambda: [], port=busy,
                                        host='127.0.0.1').start()
        try:
            assert exporter.port not in (0, busy)
        finally:
            exporter.stop()


# ---------------------------------------------------------------------------
# the config's telemetry knobs: the JAX defaults and checks


def test_the_telemetry_knobs_take_the_jax_defaults():
    raw = {'train_args': {}}
    jargs = jax_config.apply_defaults({'train_args': {}})
    pargs = port_config.apply_defaults(raw)
    for key in ('telemetry', 'telemetry_port', 'profile_epochs',
                'profile_dir'):
        assert pargs['train_args'][key] == jargs['train_args'][key], key
    # the whole JAX block is accepted as written
    block = {'telemetry': {'enabled': True, 'trace_dir': 'traces',
                           'trace_sample_rate': 0.25, 'blackbox_dir': 'bb',
                           'recorder_events': 64, 'metrics_rotate_mb': 5,
                           'alerts': {'interval': 2.0, 'rules': [
                               {'name': 'x', 'metric': 'm'}]},
                           'perf_plane': True, 'retrace': 'abort',
                           'retrace_warmup_epochs': 2},
             'telemetry_port': 9200, 'profile_epochs': '2,4-5',
             'profile_dir': 'prof'}
    jax_config.validate(jax_config.apply_defaults({'train_args': block}))
    got = port_config.apply_defaults({'train_args': block})['train_args']
    assert {k: got[k] for k in block} == block


@pytest.mark.parametrize('train_args', [
    {'telemetry': 'yes'},
    {'telemetry': {'trace_sample_rate': 1.5}},
    {'telemetry': {'trace_sample_rate': -0.1}},
    {'telemetry': {'recorder_events': 8}},
    {'telemetry': {'metrics_rotate_mb': -1}},
    {'telemetry': {'alerts': 'loud'}},
    {'telemetry': {'alerts': {'interval': 0}}},
    {'telemetry': {'alerts': {'rules': [{'name': 'no_metric'}]}}},
    {'telemetry': {'alerts': [{'metric': 'no_name'}]}},
    {'telemetry': {'retrace': 'panic'}},
    {'telemetry': {'retrace_warmup_epochs': -1}},
    {'profile_epochs': '0'},
    {'profile_epochs': '0-2'},
    {'telemetry_port': 70000},
    {'telemetry_port': -1},
    {'telemetry': False, 'telemetry_port': 9100},
    {'telemetry': {'enabled': False}, 'telemetry_port': 9100}])
def test_the_jax_telemetry_rejections_are_config_errors(train_args):
    raw = {'train_args': train_args}
    with pytest.raises(AssertionError):
        jax_config.validate(jax_config.apply_defaults(raw))
    with pytest.raises(ConfigError):
        port_config.apply_defaults(raw)


@pytest.mark.parametrize('spec', [
    '', None, 3, [1, 4], (2,), '3', '2,5', '3-5', '3-5,8', ' 1 , 7-9 ', '4-4'])
def test_parse_epoch_set_agrees(spec):
    assert port_config.parse_epoch_set(spec) == \
        jax_config.parse_epoch_set(spec)


# ---------------------------------------------------------------------------
# the metric names

# registered by the JAX package's mesh (ROADMAP.md §1 item 5); the port
# registers every other name (the serving tier's registries came with it)
NOT_ON_THE_TRAINING_PLANE = (
    'mesh_shard_bytes_total',
)
_REGISTERED = re.compile(
    r"""\b(?:counter|gauge|histogram)\(\s*['"]([a-zA-Z_:][a-zA-Z0-9_:]*)['"]""")
_NAMED = re.compile(r"""['"]([a-z][a-z0-9_]*_(?:total|seconds|ms))['"]""")


def _names(package, pattern):
    out = set()
    for path in glob.glob(os.path.join(REPO, package, '**', '*.py'),
                          recursive=True):
        with open(path) as f:
            out |= set(pattern.findall(f.read()))
    return out


def test_every_jax_training_plane_metric_name_is_in_the_port():
    jax_names = _names('handyrl_tpu', _REGISTERED) | \
        (_names('handyrl_tpu', _NAMED) & _names('handyrl_tpu', re.compile(
            r"""_COUNTERS\s*=\s*\{[^}]*?['"]([a-z_]+_total)['"]""")))
    port_text = ''
    for path in glob.glob(os.path.join(REPO, 'handyrl_tpu_torch', '**',
                                       '*.py'), recursive=True):
        with open(path) as f:
            port_text += f.read()
    missing = sorted(n for n in jax_names - set(NOT_ON_THE_TRAINING_PLANE)
                     if "'%s'" % n not in port_text)
    assert len(jax_names) > 100
    assert missing == []
    for name in NOT_ON_THE_TRAINING_PLANE:
        assert name in jax_names    # the exception list names real metrics
