"""The port's fused device loop sharded over two ranks of a torch.distributed
job on the host (gloo), against the JAX package's
tests/test_multichip_fused.py: device generation, device window ingest,
device replay and SGD end to end, each rank its own envs and ring slice,
the grads summed over the ranks inside the update step.

- The learner's entry point on the JAX test's config (batch 16,
  forward_steps 8, 3 epochs, 16 generation envs, 8 eval envs, K=2, 8-ply
  chunks) over two ranks: both run the sharded loop, reach epoch 3 with
  at least 90 episodes, count the same episodes, steps and evaluation
  results and end with the same params (bit for bit); rank 0 alone
  writes the run directory (rank 1's configured one stays absent).
- The loop state really is sharded: rank r's initial env rows are rows
  [r N/2, (r+1) N/2) of the unsharded pipeline's (equal exactly), its ring
  has ``capacity`` rows, and a warm dispatch's pack is global: done (8, 16)
  and outcome (8, 16, 2) on every rank.
- A SIGTERM to rank 1 alone ends both ranks with exit 75.
"""

import copy
import os
import signal
import sys
import time

import pytest
import torch

from handyrl_tpu_torch.envs import torch_tictactoe as tt
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.ops.device_windows import DeviceWindower
from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline
from handyrl_tpu_torch.utils.fs import read_layout_manifest
from tests.torch_ranks_support import (REPO, json_line, one_torch_thread,
                                       read, run_ranks, run_script,
                                       start_ranks, train_argv, train_config,
                                       wait_ranks)

pytestmark = pytest.mark.timeout(120)   # each test's own limit

_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)

TRAIN = {'batch_size': 16, 'forward_steps': 8, 'update_episodes': 30,
         'minimum_episodes': 16, 'generation_envs': 16, 'eval_envs': 8,
         'epochs': 3, 'device_generation': True, 'device_replay': True,
         'sgd_steps_per_chunk': 2, 'device_chunk_steps': 8}
PREEMPT_EXIT = 75


def _config(tmp_path, name, **over):
    ta = dict(TRAIN, model_dir=str(tmp_path / name / 'models'),
              metrics_jsonl=str(tmp_path / name / 'metrics.jsonl'))
    ta.update(over)
    return train_config(tmp_path, name + '.json',
                        {'env_args': {'env': 'TicTacToe'},
                         'train_args': ta})


def test_two_rank_fused_loop_end_to_end(tmp_path):
    results = run_ranks(train_argv(_config(tmp_path, 'r0')), 2, tmp_path,
                        'fused')
    lines = []
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, out[-3000:]
        assert 'sharded over 2 devices' in out
        assert 'multi-host: process %d of 2, 2 global devices' % rank in out
        lines.append(json_line(out))
    for line in lines:
        assert line['model_epoch'] == 3
        assert line['steps'] > 0
        assert line['episodes'] >= 30 * 3
    assert lines[0]['mesh']['params_sha256'] == \
        lines[1]['mesh']['params_sha256']
    # the global packs: every rank counted the same episodes, steps and
    # (its evaluator's envs sharded too) evaluation results
    for key in ('episodes', 'steps', 'eval_results', 'eval_by_epoch'):
        assert lines[0][key] == lines[1][key], key
    assert lines[0]['eval_results'] > 0
    assert [l['mesh']['writes_run_dir'] for l in lines] == [True, False]
    models = tmp_path / 'r0' / 'models'
    layout, reason = read_layout_manifest(str(models / 'latest.ckpt'))
    assert reason == 'ok'
    assert layout['mesh'] == {'data': 2, 'model': 1}
    assert layout['processes'] == 2 and layout['devices'] == 2


def test_two_rank_fused_loop_with_per_rank_configs(tmp_path):
    """Rank 1 configured with a run directory of its own writes nothing
    there: no checkpoint, no manifest, no metrics row."""
    cfgs = [_config(tmp_path, 'r0'), _config(tmp_path, 'r1')]
    script = tmp_path / 'by_rank.py'
    script.write_text(
        'import os, runpy, sys\n'
        'sys.argv = [sys.argv[0], "--config", %r[int(os.environ['
        '"JAX_PROCESS_ID"])], "--device", "cpu"]\n'
        'runpy.run_module("handyrl_tpu_torch.train", run_name="__main__")\n'
        % (cfgs,))
    results = run_ranks([sys.executable, str(script)], 2, tmp_path, 'cfg')
    for rc, out in results:
        assert rc == 0, out[-3000:]
    lines = [json_line(out) for _, out in results]
    assert lines[0]['mesh']['params_sha256'] == \
        lines[1]['mesh']['params_sha256']
    assert os.path.exists(tmp_path / 'r0' / 'models' / 'latest.ckpt.layout')
    assert os.path.exists(tmp_path / 'r0' / 'metrics.jsonl')
    assert not os.path.exists(tmp_path / 'r1')


_STATE = r"""
import copy, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
from handyrl_tpu_torch.parallel import multihost
from handyrl_tpu_torch.parallel.mesh import make_mesh
from handyrl_tpu_torch.envs import torch_tictactoe as tt
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.ops.device_windows import DeviceWindower
from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline

assert multihost.initialize()
multihost.select_backend(torch.device('cpu'))
mesh = make_mesh()
net = SimpleConv2dModel()
net.reset_parameters(torch.Generator().manual_seed(0))
step = train_step.ReplayUpdateStep(
    net, losses.LossConfig(**%(cfg)r), train_step.init_train_state(net),
    mesh=mesh)
wd = DeviceWindower('turn', 8, 0, tt.MAX_STEPS, 1, 64, 2, 0.8, False)
fp = FusedPipeline(tt, copy.deepcopy(net), step, wd, 16, 8, 2, 16, seed=0,
                   mesh=mesh)
torch.save(fp.state._asdict(), %(out)r %% mesh.index)
rows = sorted({v.shape[0] for v in fp.ring.values()})
assert fp.warm_step() is None       # pipelined one deep
parsed = fp.warm_step()
print('OK', mesh.index, fp.n_loc, fp.b_loc, fp.capacity, rows,
      tuple(parsed['done'].shape), tuple(parsed['outcome'].shape),
      fp.ring_size_host, fp.ring_min_host, flush=True)
multihost.shutdown()
"""
CFG = dict(turn_based_training=True, observation=False, policy_target='TD',
           value_target='TD', gamma=0.8, lmb=0.7)


def test_fused_pipeline_state_is_sharded(tmp_path):
    out = str(tmp_path / 'state_%d.pt')
    outs = run_script(_STATE % {'repo': REPO, 'cfg': CFG, 'out': out}, 2,
                      tmp_path, 'state')
    net = SimpleConv2dModel()
    net.reset_parameters(torch.Generator().manual_seed(0))
    step = train_step.ReplayUpdateStep(net, losses.LossConfig(**CFG),
                                       train_step.init_train_state(net))
    wd = DeviceWindower('turn', 8, 0, tt.MAX_STEPS, 1, 64, 2, 0.8, False)
    whole = FusedPipeline(tt, copy.deepcopy(net), step, wd, 16, 8, 2, 16,
                          seed=0).state._asdict()
    for rank, text in enumerate(outs):
        line = next(l for l in text.splitlines() if l.startswith('OK'))
        assert line.split(None, 5)[1:5] == [str(rank), '8', '8', '64']
        # every ring leaf: capacity rows on this rank (and the windower's
        # one spare row past them, as on one device)
        assert '[65] (8, 16) (8, 16, 2)' in line
        mine = torch.load(out % rank)
        for k, v in whole.items():
            assert torch.equal(mine[k], v[rank * 8:(rank + 1) * 8]), k
    # the ring sizes summed and their minimum, from the global pack
    tails = [l.split()[-2:] for o in outs for l in o.splitlines()
             if l.startswith('OK')]
    assert tails[0] == tails[1]


def test_sigterm_to_one_rank_ends_both_with_75(tmp_path):
    cfg = _config(tmp_path, 'long', epochs=10000)
    procs = start_ranks(train_argv(cfg), 2, tmp_path, 'preempt')
    deadline = time.monotonic() + 60
    while 'epoch 1\n' not in read(procs[1][1]):
        assert time.monotonic() < deadline, read(procs[1][1])[-3000:]
        assert all(p.poll() is None for p, _ in procs), \
            [read(log)[-2000:] for _, log in procs]
        time.sleep(0.2)
    procs[1][0].send_signal(signal.SIGTERM)
    results = wait_ranks(procs, 60)
    for rank, (rc, out) in enumerate(results):
        assert rc == PREEMPT_EXIT, (rank, out[-3000:])
        assert 'preempted: checkpoint flushed' in out
    lines = [json_line(out) for _, out in results]
    assert lines[0]['mesh']['params_sha256'] == \
        lines[1]['mesh']['params_sha256']
    models = tmp_path / 'long' / 'models'
    assert os.path.exists(models / 'trainer_state.ckpt.layout')
