"""GeeseFormer in the port (handyrl_tpu_torch/models/transformer.py)
against the JAX package's (handyrl_tpu/models/transformer.py): the
forward in fp32 and with the compute dtype bfloat16 (the JAX module's
``dtype=jnp.bfloat16``), with and without ``remat``; the param trees and
snapshots both ways; one VTRACE update step as in
tests/test_transformer.py::test_geese_former_trains; ``remat``'s grads;
the refused ``mesh``; ``Learner(args, net=GeeseFormer())`` on the host
learner and the fused loop; the service answering INFER for a registry
snapshot. Params are carried from perturbed flax inits; inputs are numpy
boards from a seed.

Tolerances:
- fp32 forward within FWD_TOL = 1e-5 (the products and the softmax's sums
  in other orders; 4e-6 seen at the default width);
- bf16 forward: outputs bf16 on both sides, within 2^-5 x max(1, |ref|)
  elementwise (a flipped rounding of a bf16 value, 2^-8 relative, carried
  through the blocks; 1 ulp at |policy| 8-16 seen), mean within 2^-6;
- the step: metrics rtol = atol = 1e-4, Adam's moments within 1e-4 of
  each leaf's largest element, the params within lr / 10 (as
  tests/test_torch_train_step.py: fp32 sums in other orders, and Adam
  turns a grad near 1e-8 into a step of up to lr);
- snapshots and the param round trip are exact; remat's grads are equal.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_batch
from handyrl_tpu.model import ModelWrapper as JaxModelWrapper
from handyrl_tpu.models import build as jax_build
from handyrl_tpu.ops.losses import LossConfig as JaxLossConfig
from handyrl_tpu.ops.train_step import build_update_step as jax_build_step
from handyrl_tpu.ops.train_step import init_train_state as jax_init_state
from handyrl_tpu_torch import models
from handyrl_tpu_torch.config import apply_defaults, serving_args
from handyrl_tpu_torch.model import ModelWrapper, params_bytes
from handyrl_tpu_torch.models.blocks import set_compute_dtype
from handyrl_tpu_torch.models.transformer import (GeeseFormer,
                                                  params_from_flax,
                                                  params_to_flax)
from handyrl_tpu_torch.ops import losses, train_step
from handyrl_tpu_torch.serving.client import ServiceClient
from handyrl_tpu_torch.serving.registry import ModelRegistry
from handyrl_tpu_torch.serving.service import InferenceService
from handyrl_tpu_torch.train import Learner

SMALL = dict(dim=32, layers=2, heads=2)
FWD_TOL = 1e-5
BF16_TOL, BF16_MEAN_TOL = 2.0 ** -5, 2.0 ** -6
LR = 1e-4
METRIC_TOL = dict(rtol=1e-4, atol=1e-4)
MOMENT_ATOL_OF_MAX = 1e-4
PARAM_ATOL = LR / 10


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """One intra-op thread a process: the workers of a parallel run share
    the cores."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _obs(B=4, seed=0):
    """tests/test_transformer.py's boards: sparse planes, one own head."""
    rng = np.random.RandomState(seed)
    obs = (rng.rand(B, 17, 7, 11) < 0.1).astype(np.float32)
    obs[:, 0] = 0
    for b in range(B):
        obs[b, 0, rng.randint(7), rng.randint(11)] = 1.0
    return obs


def _pair(seed=0, **cfg):
    """A perturbed flax init of the JAX module (``cfg``) and the port's
    GeeseFormer with the same params."""
    jm = jax_build('GeeseFormer', **cfg)
    v = jm.init(jax.random.PRNGKey(seed), _obs(2, seed), None)
    rng = np.random.RandomState(seed + 1)
    v = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.randn(*np.shape(a)).astype(
            np.float32), v)
    net = GeeseFormer(**cfg)
    net.load_state_dict(params_from_flax(v))
    return jm, v, net


@pytest.mark.timeout(120)
@pytest.mark.parametrize('cfg', [SMALL, dict(SMALL, remat=True), {}])
def test_forward_matches_jax(cfg):
    jm, v, net = _pair(**cfg)
    obs = _obs(5, 3)
    ref = jm.apply(v, obs, None)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
        single = net(torch.from_numpy(obs[0]))
    for k in ('policy', 'value'):
        assert out[k].shape == ref[k].shape
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=FWD_TOL, err_msg=k)
    # one observation: the JAX module's unbatched call
    ref1 = jm.apply(v, obs[0], None)
    assert single['policy'].shape == ref1['policy'].shape == (4,)
    np.testing.assert_allclose(single['policy'].numpy(),
                               np.asarray(ref1['policy']), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.timeout(120)
@pytest.mark.parametrize('cfg', [SMALL, {}])
def test_bf16_forward_matches_jax(cfg):
    _, v, net = _pair(**cfg)
    jm = jax_build('GeeseFormer', dtype=jnp.bfloat16, **cfg)
    set_compute_dtype(net, 'bfloat16')
    obs = _obs(6, 4)
    ref = jm.apply(v, obs, None)
    with torch.no_grad():
        out = net(torch.from_numpy(obs))
    for k in ('policy', 'value'):
        assert out[k].dtype == torch.bfloat16 and ref[k].dtype == jnp.bfloat16
        g = out[k].float().numpy()
        r = np.asarray(ref[k].astype(jnp.float32))
        err = np.abs(g - r)
        assert (err <= BF16_TOL * np.maximum(1.0, np.abs(r))).all(), (
            k, err.max())
        assert err.mean() <= BF16_MEAN_TOL * max(1.0, np.abs(r).mean()), k
    assert {p.dtype for p in net.parameters()} == {torch.float32}


@pytest.mark.parametrize('cfg', [SMALL, dict(SMALL, remat=True)])
def test_params_and_snapshots_cross_both_packages(cfg):
    jm, v, net = _pair(**cfg)
    obs = _obs(3, 5)
    # the param tree round trip is exact, block names included
    back = params_to_flax(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, v))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a JAX snapshot loads in the port
    jw = JaxModelWrapper(jm, v)
    port = ModelWrapper.from_snapshot(jw.snapshot(), device='cpu')
    assert isinstance(port.module, GeeseFormer)
    assert port.module.remat == bool(cfg.get('remat'))
    got = port.batch_inference(obs)
    want = jm.apply(v, obs, None)
    np.testing.assert_allclose(got['policy'], np.asarray(want['policy']),
                               rtol=0, atol=FWD_TOL)
    # a port snapshot loads in the JAX package
    snap = ModelWrapper(net, device='cpu').snapshot()
    assert snap['architecture'] == 'GeeseFormer'
    jback = JaxModelWrapper.from_snapshot(snap, obs[0])
    np.testing.assert_allclose(
        np.asarray(jback.module.apply(jback.params, obs, None)['policy']),
        got['policy'], rtol=0, atol=FWD_TOL)
    # the Adam moments' mapping takes the remat net's names through
    # model.param_trees
    assert params_bytes(net, dict(net.named_parameters())) == \
        params_bytes(net)


def _step_cfg():
    return dict(turn_based_training=False, observation=True,
                policy_target='VTRACE', value_target='VTRACE', gamma=0.99)


@pytest.mark.timeout(300)
def test_one_vtrace_step_matches_jax():
    rng = np.random.RandomState(2)
    batch = _synthetic_batch(4, 6, 1, (17, 7, 11), 4, rng)
    # 0/1 boards: the synthetic uniform planes saturate the value head
    # (grads near 1e-6, whose moments then compare at fp32 round-off)
    batch['observation'] = _obs(24, 8).reshape(4, 6, 1, 17, 7, 11)
    jm, v, net = _pair(**SMALL)
    jstep = jax_build_step(jm, JaxLossConfig(**_step_cfg()), donate=False)
    jstate, jmet = jstep(jax_init_state(v), batch,
                         jnp.asarray(LR, jnp.float32))
    step = train_step.build_update_step(net,
                                        losses.LossConfig(**_step_cfg()))
    state, met = step(train_step.init_train_state(net),
                      {k: torch.from_numpy(np.asarray(a))
                       for k, a in batch.items()}, torch.tensor(LR))
    assert np.isfinite(float(jmet['total']))
    assert set(met) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(met[k].item(), float(jmet[k]), err_msg=k,
                                   **METRIC_TOL)
    flat = lambda tree: params_from_flax(  # noqa: E731
        jax.tree_util.tree_map(np.asarray, tree))
    for k, want in flat(jstate.params).items():
        np.testing.assert_allclose(state.params[k].numpy(), want.numpy(),
                                   rtol=0, atol=PARAM_ATOL, err_msg=k)
    adam = jstate.opt_state[2]
    assert int(adam.count) == int(state.opt_state.count) == 1
    for name, jtree, got in (('mu', adam.mu, state.opt_state.mu),
                             ('nu', adam.nu, state.opt_state.nu)):
        for k, want in flat(jtree).items():
            w = want.numpy()
            np.testing.assert_allclose(
                got[k].numpy(), w, rtol=1e-4,
                atol=MOMENT_ATOL_OF_MAX * np.abs(w).max(),
                err_msg='%s %s' % (name, k))


def test_remat_gives_the_same_grads():
    _, v, plain = _pair(**SMALL)
    remat = GeeseFormer(remat=True, **SMALL)
    remat.load_state_dict(plain.state_dict())
    obs = torch.from_numpy(_obs(4, 6))
    grads = []
    for net in (plain, remat):
        out = net(obs)
        (out['policy'].square().sum() + out['value'].sum()).backward()
        grads.append({k: p.grad for k, p in net.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_mesh_is_refused_by_name():
    with pytest.raises(ValueError, match='item 9'):
        GeeseFormer(mesh=object(), **SMALL)
    with pytest.raises(ValueError, match='item 9'):
        models.build('GeeseFormer', mesh=object())
    # the registry builds it by name; no net_kind selects it
    assert isinstance(models.build('GeeseFormer'), GeeseFormer)
    from handyrl_tpu_torch.config import ConfigError
    with pytest.raises(ConfigError, match='net_kind'):
        apply_defaults({'env_args': {'env': 'HungryGeese',
                                     'net_kind': 'former'}})


def _learner_args(tmp_path, fused, dtype=''):
    ta = {'turn_based_training': False, 'observation': True, 'gamma': 0.99,
          'forward_steps': 4, 'batch_size': 4, 'generation_envs': 4,
          'num_batchers': 1, 'minimum_episodes': 4, 'update_episodes': 4,
          'epochs': 1, 'policy_target': 'VTRACE', 'value_target': 'VTRACE',
          'compute_dtype': dtype, 'model_dir': str(tmp_path / 'models')}
    if fused:
        ta.update(eval_envs=4, maximum_episodes=16, device_generation=True,
                  device_replay=True, device_chunk_steps=8,
                  sgd_steps_per_chunk=2)
    return apply_defaults({'env_args': {'env': 'HungryGeese'},
                           'train_args': ta})


@pytest.mark.timeout(300)
@pytest.mark.parametrize('fused,dtype', [(False, ''), (True, ''),
                                         (False, 'bfloat16')])
def test_learner_trains_a_geese_former(tmp_path, fused, dtype):
    net = GeeseFormer(generator=torch.Generator().manual_seed(0), **SMALL)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    learner = Learner(_learner_args(tmp_path, fused, dtype), net=net,
                      device='cpu')
    learner.run()
    line = learner.summary()
    assert line['epochs'] == 1 and not line['failed']
    assert bool(line.get('fused')) == fused
    assert all(np.isfinite(v) for v in line['losses'].values())
    after = learner.params
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert {t.dtype for t in after.values()} == {torch.float32}
    # the checkpoint is a GeeseFormer's flax tree: the JAX package reads it
    snap = {'architecture': 'GeeseFormer', 'config': net.config(),
            'params': (tmp_path / 'models' / '1.ckpt').read_bytes()}
    jw = JaxModelWrapper.from_snapshot(snap, _obs(1)[0])
    got = jw.module.apply(jw.params, _obs(2, 9), None)['policy']
    with torch.no_grad():
        net.load_state_dict({k: v for k, v in after.items()})
        set_compute_dtype(net, None)
        want = net(torch.from_numpy(_obs(2, 9)))['policy']
    np.testing.assert_allclose(np.asarray(got), want.numpy(), rtol=0,
                               atol=FWD_TOL)


@pytest.mark.timeout(300)
def test_service_answers_infer_for_a_registry_snapshot(tmp_path):
    _, v, net = _pair(**SMALL)
    wrapper = ModelWrapper(net, device='cpu')
    root = str(tmp_path / 'registry')
    ModelRegistry(root).publish('former', snapshot=wrapper.snapshot(),
                                version=1, promote=True)
    svc = InferenceService(serving_args({'env': 'HungryGeese'}, {},
                                        {'port': 0, 'registry_dir': root}),
                           device='cpu').start()
    client = ServiceClient('localhost', svc.port, timeout=120)
    try:
        obs = _obs(3, 7)
        for o in obs:
            out = client.request('former@champion', o)['outputs']
            want = wrapper.inference(o)
            np.testing.assert_allclose(np.asarray(out['policy']),
                                       want['policy'], rtol=0, atol=FWD_TOL)
            np.testing.assert_allclose(np.asarray(out['value']),
                                       want['value'], rtol=0, atol=FWD_TOL)
    finally:
        client.close()
        svc.stop(drain=False)
