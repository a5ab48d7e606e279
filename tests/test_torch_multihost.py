"""The port's distributed job (handyrl_tpu_torch/parallel/multihost.py)
against the JAX package's tests/test_multihost.py: two real processes join
one torch.distributed job over gloo on the host, by the JAX package's
variables or by the ``train_args.distributed`` block, and run a
cross-process collective; without configuration ``initialize`` is a
no-op. Then the update step over two ranks (``build_update_step`` with a
mesh; each rank its half of the global batch): both ranks hold the same
params bit for bit, and both equal the JAX package's step over its
two-device mesh (``make_mesh(jax.devices()[:2])``, the 8-virtual-device
CPU mesh of tests/conftest.py) within tests/test_partition.py:163-185's
tolerances: the loss within rel 1e-5 and the params within rtol 2e-5,
atol 1e-6 (the same fp32 sums in other orders: the ranks' two partial
gradients summed by gloo, XLA's sharded reduction in the JAX step). A
world of 1 through ``initialize`` is the plain step, equal with
``torch.equal`` (no mesh, no collective). On each rank the fused loop's
forms of the two-rank step, split at the collective
(``StaticUpdateStep`` over a mesh, and ``ReplayUpdateStep.run`` over the
rank's ring of B/2 rows), equal ``build_update_step``'s with
``torch.equal``, which the JAX step holds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.train_step import build_update_step as jax_build_step
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu.parallel import partition as jax_partition
from handyrl_tpu.parallel.mesh import make_mesh as jax_make_mesh
from handyrl_tpu.parallel.mesh import shard_batch as jax_shard_batch
from handyrl_tpu_torch.models.tictactoe import (SimpleConv2dModel,
                                                params_from_flax)
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.parallel import multihost
from handyrl_tpu_torch.parallel.mesh import make_mesh
from tests.torch_ranks_support import (REPO, free_port, one_torch_thread,
                                       run_script)

pytestmark = pytest.mark.timeout(120)   # each test's own limit

_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)

LR = 1e-4
LOSS_REL = 1e-5
PARAM_TOL = dict(rtol=2e-5, atol=1e-6)
CFG = dict(turn_based_training=False, observation=True, policy_target='TD',
           value_target='TD', gamma=0.9)

_JOIN = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
from handyrl_tpu_torch.parallel import multihost
%(join)s
assert multihost.is_coordinator() == (multihost.process_index() == 0)
import torch.distributed as dist
# one cross-process collective: everyone receives the coordinator's value
val = torch.tensor(100.0 + multihost.process_index())
dist.broadcast(val, src=0)
print('OK', multihost.process_index(), multihost.process_count(),
      multihost.global_mesh().size, float(val), flush=True)
multihost.shutdown()
"""


def _check_join(outs, marker=None):
    for pid, out in enumerate(outs):
        line = next(l for l in out.splitlines() if l.startswith('OK'))
        _, idx, count, devices, val = line.split()
        assert int(idx) == pid
        assert int(count) == 2
        assert int(devices) == 2          # one device a rank
        assert float(val) == 100.0        # the coordinator's value won
        if marker:
            assert marker % pid in out


def test_two_ranks_join_by_the_jax_variables(tmp_path):
    outs = run_script(_JOIN % {
        'repo': REPO,
        'join': "assert multihost.initialize(), 'the variables join'"},
        2, tmp_path, 'join_env')
    _check_join(outs)


def test_two_ranks_join_by_the_config_block(tmp_path):
    port = free_port()
    join = r"""
import os
from handyrl_tpu_torch.train import _init_multihost
pid = int(os.environ.pop('JAX_PROCESS_ID'))
for k in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES'):
    os.environ.pop(k)
device, active = _init_multihost({'train_args': {'distributed': {
    'coordinator_address': 'localhost:%d', 'num_processes': 2,
    'process_id': pid}}}, 'cpu')
assert active and device.type == 'cpu'
""" % port
    outs = run_script(_JOIN % {'repo': REPO, 'join': join}, 2, tmp_path,
                      'join_cfg')
    _check_join(outs, 'multi-host: process %d of 2, 2 global devices '
                '(cpu, collectives: gloo')


def test_initialize_noop_without_configuration(monkeypatch):
    for var in ('JAX_COORDINATOR_ADDRESS', 'COORDINATOR_ADDRESS',
                'MEGASCALE_COORDINATOR_ADDRESS'):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.process_count() == 1 and multihost.is_coordinator()


# -------------------------------------------------- the step over two ranks

_STEP = r"""
import hashlib, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
from handyrl_tpu_torch.parallel import multihost
from handyrl_tpu_torch.parallel.mesh import make_mesh, shard_batch
from handyrl_tpu_torch.models.tictactoe import SimpleConv2dModel
from handyrl_tpu_torch.ops import losses, train_step

assert multihost.initialize()
multihost.select_backend(torch.device('cpu'))
mesh = make_mesh()
assert mesh.shape == {'data': 2, 'model': 1}, mesh.shape
inp = torch.load(%(inp)r)
net = SimpleConv2dModel()
net.load_state_dict(inp['state_dict'])
step = train_step.build_update_step(net, losses.LossConfig(**inp['cfg']),
                                    mesh=mesh)
# this rank's half of the global batch
local = shard_batch(mesh, inp['batch'])
lr = torch.tensor(inp['lr'])
state, metrics = step(train_step.init_train_state(net), local, lr)


def same(params, got_metrics, what):
    for k in state.params:
        assert torch.equal(params[k], state.params[k]), (what, k)
    for k in metrics:
        assert torch.equal(got_metrics[k], metrics[k]), (what, k)


# the fused loop's forms of the step, split at the collective: the static
# step (_pre, _reduce, _post on its own buffers) ...
cfg = losses.LossConfig(**inp['cfg'])
static = train_step.StaticUpdateStep(net, cfg, train_step.init_train_state(net),
                                     mesh=mesh)
same(static.state.params, static(local, lr), 'static')
# ... and the replay step's two captured calls over this rank's ring of
# B/2 rows, its slots the ring's rows in order (lr = 1 x default_lr)
b = local['value'].shape[0]
ring = {k: v.reshape(b, -1).clone() for k, v in local.items()}
spec = {k: (tuple(v.shape[1:]), v.dtype) for k, v in local.items()}
replay = train_step.ReplayUpdateStep(net, cfg, train_step.init_train_state(net),
                                     default_lr=inp['lr'], mesh=mesh)
replay.bind(ring, spec, torch.tensor(b), torch.tensor(0), b, b, None)
packed = replay.run(1, 1.0, slots=torch.arange(b)[None])
same(replay.state.params, replay.unpack(packed), 'replay')
h = hashlib.sha1()
for k in sorted(state.params):
    h.update(state.params[k].numpy().tobytes())
torch.save({'params': state.params,
            'metrics': {k: v.item() for k, v in metrics.items()}},
           %(out)r %% multihost.process_index())
# one collective for each of the three steps
print('OK', multihost.process_index(), int(state.steps), h.hexdigest(),
      mesh.collectives, flush=True)
multihost.shutdown()
"""


def _ttt_pieces():
    jm = jax_build('SimpleConv2dModel')
    batch = _synthetic_batch(8, 4, 1, (3, 3, 3), 9, np.random.RandomState(0))
    params = jm.init(jax.random.PRNGKey(0), batch['observation'][:, 0, 0],
                     None)
    net = SimpleConv2dModel()
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, net, batch


def test_two_rank_step_matches_the_jax_two_device_step(tmp_path):
    jm, params, net, batch = _ttt_pieces()
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    inp = str(tmp_path / 'step_in.pt')
    torch.save({'state_dict': net.state_dict(), 'batch': tbatch, 'cfg': CFG,
                'lr': LR}, inp)
    out = str(tmp_path / 'step_out_%d.pt')
    outs = run_script(_STEP % {'repo': REPO, 'inp': inp, 'out': out}, 2,
                      tmp_path, 'step')
    rows = []
    for pid, text in enumerate(outs):
        line = next(l for l in text.splitlines() if l.startswith('OK'))
        _, idx, steps, digest, collectives = line.split()
        assert (int(idx), int(steps), int(collectives)) == (pid, 1, 3)
        rows.append(digest)
    # the replicated params are bit-identical on both ranks
    assert rows[0] == rows[1]
    got = [torch.load(out % r) for r in range(2)]
    assert got[0]['metrics'] == got[1]['metrics']

    # the JAX package's step over its two-device mesh
    mesh = jax_make_mesh(jax.devices()[:2])
    state = jax_init_state(params)
    shardings = jax_partition.tree_shardings(mesh, state,
                                             jax_partition.DEFAULT_RULES)
    jstep = jax_build_step(jm, JaxLossConfig(**CFG), mesh=mesh, donate=False,
                           state_shardings=shardings)
    jstate, jmetrics = jstep(state, jax_shard_batch(mesh, batch),
                             jnp.asarray(LR, jnp.float32))
    want = float(jmetrics['total'])
    assert abs(got[0]['metrics']['total'] - want) / abs(want) < LOSS_REL
    jparams = params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                      jstate.params))
    for k, v in jparams.items():
        np.testing.assert_allclose(got[0]['params'][k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)
    # and the port's one-rank step over the whole batch (the same
    # tolerance: one gradient of 8 rows against two of 4 summed)
    whole, wm = train_step.build_update_step(net, losses.LossConfig(**CFG))(
        train_step.init_train_state(net), tbatch, torch.tensor(LR))
    assert abs(got[0]['metrics']['total'] - float(wm['total'])) \
        / abs(float(wm['total'])) < LOSS_REL
    for k, v in whole.params.items():
        np.testing.assert_allclose(got[0]['params'][k].numpy(), v.numpy(),
                                   err_msg=k, **PARAM_TOL)


def test_world_of_one_is_the_plain_step(monkeypatch):
    """``initialize`` with one process: the mesh is 1x1, and the step with
    it runs no collective and equals the plain step exactly."""
    for var in ('JAX_COORDINATOR_ADDRESS', 'COORDINATOR_ADDRESS'):
        monkeypatch.delenv(var, raising=False)
    _, _, net, batch = _ttt_pieces()
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    cfg = losses.LossConfig(**CFG)
    lr = torch.tensor(LR)
    plain, pm = train_step.build_update_step(net, cfg)(
        train_step.init_train_state(net), tbatch, lr)
    assert multihost.initialize('localhost:%d' % free_port(), 1, 0)
    try:
        assert multihost.process_count() == 1
        mesh = make_mesh()
        assert mesh.shape == {'data': 1, 'model': 1} and mesh.size == 1
        state, metrics = train_step.build_update_step(net, cfg, mesh=mesh)(
            train_step.init_train_state(net), tbatch, lr)
        static = train_step.StaticUpdateStep(
            net, cfg, train_step.init_train_state(net), mesh=mesh)
        static_metrics = static(tbatch, lr)
    finally:
        multihost.shutdown()
    assert mesh.collectives == 0
    for k in plain.params:
        assert torch.equal(state.params[k], plain.params[k]), k
        assert torch.equal(static.state.params[k], plain.params[k]), k
    for k in pm:
        assert torch.equal(metrics[k], pm[k]), k
        assert torch.equal(static_metrics[k], pm[k]), k


# ------------------------------------- the paths a world of 2 does not run

def _ta(**over):
    from handyrl_tpu_torch.config import apply_defaults
    raw = {'env_args': {'env': 'TicTacToe'},
           'train_args': dict({'batch_size': 16, 'generation_envs': 16,
                               'device_generation': True,
                               'device_replay': True}, **over)}
    args = apply_defaults(raw)
    ta = dict(args['train_args'])
    ta['env'] = args['env_args']
    return ta


@pytest.mark.parametrize('over,remote,part', [
    ({'device_generation': False, 'device_replay': False}, False,
     "the host learner's batched path"),
    ({'device_replay': False}, False, 'the split path'),
    ({'fused_pipeline': False}, False, 'the threaded replay trainer'),
    ({'batched_generation': False}, False,
     "the worker plane's local cluster"),
    ({}, True, '--server'),
    ({'batch_size': 15}, False, 'batch_size 15 do not divide'),
], ids=['host', 'split', 'threaded', 'worker_plane', 'server',
        'indivisible'])
def test_paths_left_out_raise_naming_5a_ii(over, remote, part):
    """A world of more than 1 trains on the sharded fused loop alone; the
    paths that step from the host's batch supply raise, naming the part
    and ROADMAP.md section 1 item 5a-ii."""
    from handyrl_tpu_torch.config import ConfigError
    from handyrl_tpu_torch.train import refuse_world_path
    with pytest.raises(ConfigError) as exc:
        refuse_world_path(_ta(**over), remote, 2)
    assert part in str(exc.value)
    assert 'ROADMAP.md section 1 item 5a-ii' in str(exc.value)
    # the sharded fused loop itself passes; a world of 1 runs every path
    refuse_world_path(_ta(), False, 2)


def test_shard_batch_stages_this_ranks_slice():
    """Rank r of W takes rows [r B/W, (r+1) B/W) of every leaf and a
    scalar whole; ``mesh_shard_bytes_total`` counts the host bytes staged:
    1/W of the batch's array bytes, as the JAX package's
    ``_place_host_leaf`` counts a device's shard (tests/test_partition.py
    test_shard_batch_transfers_one_nth_per_device)."""
    from handyrl_tpu_torch import telemetry
    from handyrl_tpu_torch.parallel.mesh import (Mesh, batch_sharding,
                                                 replicated_sharding,
                                                 shard_batch)
    rng = np.random.RandomState(0)
    batch = {'observation': rng.randn(8, 4, 3).astype(np.float32),
             'obs': {'board': rng.randint(0, 9, (8, 2)).astype(np.int32)},
             'scale': np.float32(2.0)}
    counter = telemetry.REGISTRY.counter('mesh_shard_bytes_total')
    for r in range(4):
        mesh = Mesh(4, index=r)
        mark = counter.value
        got = shard_batch(mesh, batch)
        assert np.array_equal(got['observation'].numpy(),
                              batch['observation'][2 * r:2 * r + 2])
        assert np.array_equal(got['obs']['board'].numpy(),
                              batch['obs']['board'][2 * r:2 * r + 2])
        assert float(got['scale']) == 2.0
        assert counter.value - mark == (
            batch['observation'].nbytes + batch['obs']['board'].nbytes) \
            // 4 + 4
    assert tuple(batch_sharding(mesh).spec) == ('data',)
    assert tuple(replicated_sharding(mesh).spec) == ()
    t = torch.arange(8.0)
    assert torch.equal(shard_batch(Mesh(2, index=1), {'t': t})['t'], t[4:])
