"""Mesh-portable checkpoints in the port, against the JAX package's
tests/test_mesh_checkpoint.py and tests/test_partition.py:91-106: the
layout manifest beside every checkpoint and trainer state
(handyrl_tpu_torch/utils/fs.py ``layout_path``,
handyrl_tpu_torch/parallel/partition.py ``checkpoint_layout``) reads as
the JAX package's for the same mesh shape, either package reads the
other's, a run saved under two ranks resumes under one (and one under
two) with the params bit-identical at resume, monotonic steps and the
``mesh-portable restore`` line, and at resume a corrupt manifest falls
back to the newest valid pair while a missing one loads as legacy."""

import json
import os

import jax
import pytest

from handyrl_tpu.parallel import partition as jax_partition
from handyrl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from handyrl_tpu.utils import fs as jax_fs
from handyrl_tpu_torch import telemetry
from handyrl_tpu_torch.config import apply_defaults
from handyrl_tpu_torch.environment import make_env
from handyrl_tpu_torch.model import params_bytes
from handyrl_tpu_torch.parallel import partition
from handyrl_tpu_torch.parallel.mesh import Mesh, PartitionSpec as P
from handyrl_tpu_torch.train import Learner, params_digest
from handyrl_tpu_torch.utils import fs
from tests.torch_ranks_support import (json_line, one_torch_thread,
                                       run_ranks, train_argv, train_config)

pytestmark = pytest.mark.timeout(120)   # each test's own limit

_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)

RULE_SETS = [
    partition.DEFAULT_RULES,
    (('dense/kernel', [None, 'model']), ('bias', 'data'), ('.*', None)),
]


def test_checkpoint_layout_and_describe_match_jax():
    for n in (2, 4):
        mesh = Mesh(n)
        want = jax_partition.checkpoint_layout(
            jax_make_mesh(jax.devices()[:n]), jax_partition.DEFAULT_RULES,
            steps=7)
        got = partition.checkpoint_layout(mesh, partition.DEFAULT_RULES,
                                          steps=7)
        assert got == want
        assert got['mesh'] == {'data': n, 'model': 1}
        assert got['devices'] == n and got['steps'] == 7
        assert partition.describe_mesh(got) == \
            jax_partition.describe_mesh(want) == 'data=%dxmodel=1' % n
    assert partition.checkpoint_layout(None) == \
        jax_partition.checkpoint_layout(None)
    assert partition.describe_mesh(partition.checkpoint_layout(None)) == \
        'single device'
    for rules in RULE_SETS:
        assert json.dumps(partition.serializable_rules(rules)) == \
            json.dumps(jax_partition.serializable_rules(rules))
    assert partition.pure_data_parallel(partition.DEFAULT_RULES)
    assert not partition.pure_data_parallel(RULE_SETS[1])
    assert partition.spec_from_entry(['data']) == P('data')
    assert partition.spec_from_entry(None) == P()


def test_manifests_read_across_packages(tmp_path):
    layout = partition.checkpoint_layout(Mesh(2), steps=3)
    mine, theirs = str(tmp_path / 'a.ckpt'), str(tmp_path / 'b.ckpt')
    fs.write_layout_manifest(mine, layout)
    jax_fs.write_layout_manifest(theirs, layout)
    for path in (mine, theirs):
        assert fs.read_layout_manifest(path) == \
            jax_fs.read_layout_manifest(path) == (layout, 'ok')
    with open(fs.layout_path(mine), 'wb') as f:
        f.write(b'\xff\xfe garbage')
    with open(jax_fs.layout_path(theirs), 'w') as f:
        f.write('[1, 2]')
    for path in (mine, theirs):
        assert fs.read_layout_manifest(path) == \
            jax_fs.read_layout_manifest(path) == (None, 'unparsable')
    missing = str(tmp_path / 'c.ckpt')
    assert fs.read_layout_manifest(missing) == \
        jax_fs.read_layout_manifest(missing) == (None, 'missing')
    assert fs.layout_path(missing) == jax_fs.layout_path(missing)


def _train_args(model_dir, metrics, epochs, restart=0):
    return {'batch_size': 8, 'forward_steps': 4, 'update_episodes': 16,
            'minimum_episodes': 16, 'generation_envs': 8, 'eval_envs': 4,
            'epochs': epochs, 'device_generation': True,
            'device_replay': True, 'sgd_steps_per_chunk': 2,
            'device_chunk_steps': 8, 'model_dir': model_dir,
            'metrics_jsonl': metrics, 'restart_epoch': restart}


def _raw(*a, **k):
    return {'env_args': {'env': 'TicTacToe'},
            'train_args': _train_args(*a, **k)}


@pytest.mark.timeout(180)
def test_checkpoint_restores_across_rank_counts(tmp_path, capsys):
    """Save under two ranks; resume under one, then under two again: the
    resumed params are what the writers ended with, bit for bit, the step
    counter continues, and each change of mesh is logged."""
    model_dir = str(tmp_path / 'models')
    metrics = str(tmp_path / 'metrics.jsonl')
    cfg = train_config(tmp_path, 'two.json', _raw(model_dir, metrics, 2))
    results = run_ranks(train_argv(cfg), 2, tmp_path, 'save2')
    for rc, out in results:
        assert rc == 0, out[-3000:]
    a = json_line(results[0][1])
    assert a['model_epoch'] == 2 and a['steps_at_exit'] > 0
    state_path = os.path.join(model_dir, 'trainer_state.ckpt')
    layout, reason = fs.read_layout_manifest(state_path)
    assert reason == 'ok' and layout['mesh'] == {'data': 2, 'model': 1}
    assert layout['processes'] == 2 and layout['steps'] == a['steps_at_exit']
    # the JAX package reads the port's manifest alike
    assert jax_fs.read_layout_manifest(state_path) == (layout, 'ok')

    # one process: the learner in this process
    capsys.readouterr()
    ln = Learner(apply_defaults(_raw(model_dir, metrics, 3, restart=-1)),
                 device='cpu')
    out = capsys.readouterr().out
    assert ('mesh-portable restore: checkpoint written under data=2xmodel=1 '
            '(2 process(es)), restoring onto single device (1 process(es))'
            in out)
    assert 'resumed trainer state (steps %d)' % a['steps_at_exit'] in out
    assert ln.model_epoch == 2 and ln.trainer.steps == a['steps_at_exit']
    # bit-identical resumed params: what the two ranks ended with
    assert params_digest(ln.trainer.host_params()) == \
        a['mesh']['params_sha256']
    ln.run()
    assert ln.model_epoch == 3 and ln.trainer.steps > a['steps_at_exit']
    b_steps = ln.trainer.steps
    layout, reason = fs.read_layout_manifest(state_path)
    assert reason == 'ok' and layout['mesh'] is None
    assert layout['processes'] == 1

    # and two ranks again, from the one process's files
    cfg = train_config(tmp_path, 'again.json',
                       _raw(model_dir, metrics, 4, restart=-1))
    results = run_ranks(train_argv(cfg), 2, tmp_path, 'resume2')
    for rc, out in results:
        assert rc == 0, out[-3000:]
        assert ('mesh-portable restore: checkpoint written under single '
                'device (1 process(es)), restoring onto data=2xmodel=1 (2 '
                'process(es))' in out)
        line = json_line(out)
        assert line['steps_at_start'] == b_steps
        assert line['model_epoch'] == 4 and line['steps_at_exit'] > b_steps
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    steps = [int(r['steps']) for r in rows]
    assert [int(r['epoch']) for r in rows] == [1, 2, 3, 4]
    assert steps == sorted(steps)


def _fake_checkpoints(model_dir, layouts):
    """Numbered TicTacToe checkpoints with CRC sidecars and the given
    manifest bytes a epoch (None: no manifest)."""
    import torch
    net = make_env({'env': 'TicTacToe'}).net()
    net.reset_parameters(torch.Generator().manual_seed(3))
    raw = params_bytes(net)
    os.makedirs(model_dir, exist_ok=True)
    for epoch, layout_bytes in layouts.items():
        path = os.path.join(model_dir, '%d.ckpt' % epoch)
        fs.checksummed_write_bytes(path, raw)
        if layout_bytes is not None:
            with open(fs.layout_path(path), 'wb') as f:   # deliberately raw
                f.write(layout_bytes)


def test_corrupt_manifest_falls_back_to_newest_valid(tmp_path):
    """A PRESENT but unparsable manifest disqualifies its checkpoint like a
    CRC failure: the resume falls back to the previous valid epoch; a
    corrupt trainer_state manifest leaves the optimizer fresh instead of
    trusting the pair."""
    model_dir = str(tmp_path / 'models')
    good = json.dumps({'format': 1, 'mesh': None, 'devices': 1,
                       'processes': 1, 'partition_rules': [['.*', []]]}
                      ).encode()
    _fake_checkpoints(model_dir, {1: good, 2: b'{not json'})
    state_path = os.path.join(model_dir, 'trainer_state.ckpt')
    fs.checksummed_write_bytes(state_path, b'\x00' * 64)
    with open(fs.layout_path(state_path), 'wb') as f:
        f.write(b'\xff\xfe garbage')
    assert fs.read_layout_manifest(state_path) == (None, 'unparsable')

    fallbacks = telemetry.REGISTRY.counter('guard_ckpt_fallbacks_total')
    mark = fallbacks.value
    ln = Learner(apply_defaults(_raw(model_dir, '', 0, restart=-1)),
                 device='cpu')
    assert ln.model_epoch == 1          # epoch 2's manifest was corrupt
    assert ln.trainer.steps == 0        # the optimizer restarted fresh
    assert fallbacks.value >= mark + 2
    ln.shutdown()


def test_missing_manifest_is_legacy_ok(tmp_path):
    """Checkpoints from before the manifests (no .layout) stay loadable."""
    model_dir = str(tmp_path / 'models')
    _fake_checkpoints(model_dir, {3: None})
    assert fs.read_layout_manifest(
        os.path.join(model_dir, '3.ckpt')) == (None, 'missing')
    ln = Learner(apply_defaults(_raw(model_dir, '', 0, restart=-1)),
                 device='cpu')
    assert ln.model_epoch == 3
    ln.shutdown()
