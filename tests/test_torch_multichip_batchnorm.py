"""norm_kind='batch' through the port's update step over two ranks, against
the JAX package's tests/test_multichip_batchnorm.py: each rank normalises
by its own batch slice (torch DataParallel semantics, the JAX package's
shard_map'd ``_update_core``) and the averaged running statistics must
leave the replicated train state identical on both ranks. With identical
slices on the two ranks, the averaged statistics equal the single-rank
step's and the JAX step's under ``shard_map`` over two devices
(``_update_core(axis_name='data')``) within rtol 1e-5 / atol 1e-6 (the
same fp32 EMA; the two packages' batch moments are sums in other
orders), and the params are bit-identical across the ranks. On each rank the
fused loop's form of the step, split at the collective
(``StaticUpdateStep`` over the mesh), equals ``build_update_step``'s, the
averaged statistics included, with ``torch.equal``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.train_step import (_update_core, init_train_state,
                                        make_optimizer)
from handyrl_tpu_torch.models.geister import GeisterNet, params_from_flax
from handyrl_tpu_torch.ops import losses, train_step
from tests.test_batchnorm_parity import geister_batch_and_wrapper  # noqa: F401
from tests.torch_ranks_support import REPO, one_torch_thread, run_script

pytestmark = pytest.mark.timeout(120)   # each test's own limit

_one_torch_thread = pytest.fixture(autouse=True, scope='module')(
    one_torch_thread)

STATS_TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
NET = dict(filters=8, drc_layers=2, drc_repeats=1, norm_kind='batch')

_RANK = r"""
import hashlib, sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, %(repo)r)
from handyrl_tpu_torch.parallel import multihost
from handyrl_tpu_torch.parallel.mesh import make_mesh
from handyrl_tpu_torch.models.geister import GeisterNet
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.ops.device_windows import flatten_window_keys

assert multihost.initialize()
multihost.select_backend(torch.device('cpu'))
mesh = make_mesh()
inp = torch.load(%(inp)r)
net = GeisterNet(**inp['net'])
net.load_state_dict(inp['state_dict'])
step = train_step.build_update_step(net, losses.LossConfig(**inp['cfg']),
                                    mesh=mesh)
# the same slice on both ranks
state, metrics = step(train_step.init_train_state(net), inp['batch'],
                      torch.tensor(inp['lr']))
# the fused loop's form of the step, split at the collective (_pre,
# _reduce, _post on its own buffers; a dict observation under '.' keys)
static = train_step.StaticUpdateStep(
    net, losses.LossConfig(**inp['cfg']), train_step.init_train_state(net),
    mesh=mesh)
got = static(flatten_window_keys(inp['batch']), torch.tensor(inp['lr']))
for k in state.params:
    assert torch.equal(static.state.params[k], state.params[k]), k
for k in metrics:
    assert torch.equal(got[k], metrics[k]), k
assert mesh.collectives == 2
h = hashlib.sha1()
for k in sorted(state.params):
    h.update(state.params[k].numpy().tobytes())
torch.save(state.params, %(out)r %% multihost.process_index())
print('OK', multihost.process_index(), h.hexdigest(),
      float(metrics['total']), flush=True)
multihost.shutdown()
"""


def _torch_batch(batch):
    return {k: ({kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items()}


def _jax_two_device_stats(wrapper, batch, args):
    """The running averages after the JAX package's shard_map'd step over
    two devices, each with ``batch``."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ('data',))
    state = init_train_state(jax.tree_util.tree_map(jnp.array,
                                                    wrapper.params))
    cfg = JaxLossConfig.from_args(args)
    core = _update_core(wrapper.module, cfg, make_optimizer(),
                        axis_name='data')
    rep2 = jax.tree_util.tree_map(lambda a: jnp.concatenate([a] * 2, axis=0),
                                  batch)
    try:
        shard_map = partial(jax.shard_map, mesh=mesh, check_vma=False)
    except AttributeError:
        from jax.experimental.shard_map import shard_map as _sm
        shard_map = partial(_sm, mesh=mesh, check_rep=False)
    P = jax.sharding.PartitionSpec

    def spec_like(tree, s):
        return jax.tree_util.tree_map(lambda _: s, tree)

    lr = jnp.asarray(LR, jnp.float32)
    out_shapes = jax.eval_shape(
        _update_core(wrapper.module, cfg, make_optimizer()), state, batch, lr)
    sharded = shard_map(
        lambda st, b, l: core(st, b, l),
        in_specs=(spec_like(state, P()), spec_like(rep2, P('data')), P()),
        out_specs=spec_like(out_shapes, P()))
    state2, _ = jax.jit(sharded)(state, rep2, lr)
    return params_from_flax(jax.tree_util.tree_map(np.asarray, {
        'params': state2.params['params'],
        'batch_stats': state2.params['batch_stats']}))


def test_two_ranks_average_the_running_statistics(geister_batch_and_wrapper,
                                                  tmp_path):
    wrapper, batch, args = geister_batch_and_wrapper
    net = GeisterNet(**NET)
    net.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, wrapper.params)))
    cfg = JaxLossConfig.from_args(args)._asdict()
    tbatch = _torch_batch(batch)
    inp = str(tmp_path / 'bn_in.pt')
    torch.save({'net': NET, 'state_dict': net.state_dict(), 'batch': tbatch,
                'cfg': cfg, 'lr': LR}, inp)
    out = str(tmp_path / 'bn_out_%d.pt')
    outs = run_script(_RANK % {'repo': REPO, 'inp': inp, 'out': out}, 2,
                      tmp_path, 'bn')
    rows = [next(l for l in o.splitlines() if l.startswith('OK')).split()
            for o in outs]
    # the replicated state is bit-identical on both ranks
    assert rows[0][2] == rows[1][2] and rows[0][3] == rows[1][3]
    assert np.isfinite(float(rows[0][3]))
    ranks = [torch.load(out % r) for r in range(2)]
    for k in ranks[0]:
        assert torch.equal(ranks[0][k], ranks[1][k]), k

    # the single-rank step of the port on the same slice
    single, _ = train_step.build_update_step(net, losses.LossConfig(**cfg))(
        train_step.init_train_state(net), tbatch, torch.tensor(LR))
    stats = [k for k in single.params if k not in dict(
        net.named_parameters())]
    assert stats, 'a batch net keeps running averages'
    start = dict(net.named_buffers())
    assert max(float((ranks[0][k] - start[k]).abs().max())
               for k in stats) > 1e-7      # the averages advanced
    jax_stats = _jax_two_device_stats(wrapper, batch, args)
    for k in stats:
        np.testing.assert_allclose(ranks[0][k].numpy(),
                                   single.params[k].numpy(), err_msg=k,
                                   **STATS_TOL)
        np.testing.assert_allclose(ranks[0][k].numpy(),
                                   jax_stats[k].numpy(), err_msg=k,
                                   **STATS_TOL)
