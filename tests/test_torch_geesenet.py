"""The port's GeeseNet (handyrl_tpu_torch/models/geese.py) against the JAX
package's, on the CPU: flax params carried across by ``params_from_flax``,
the same numpy observations through both, policy and value compared.

Tolerance atol 1e-4 (rtol 1e-5): fp32 on both sides, but the port's
'pad'/'halo' trunks run torch convolutions and group_norm, which sum in a
different order than XLA's, and 13 layers of GroupNorm carry the
difference from layer to layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.models.geese import GeeseNet as JaxGeeseNet
from handyrl_tpu_torch.model import ModelWrapper
from handyrl_tpu_torch.models.geese import (GeeseNet, params_from_flax,
                                            params_to_flax)

TOL = dict(rtol=1e-5, atol=1e-4)


def _obs(batch, seed):
    """Board-like observations: 0/1 planes with one head cell in channel 0
    per sample (the head readout pools there)."""
    rng = np.random.default_rng(seed)
    obs = (rng.random((batch, 17, 7, 11)) < 0.1).astype(np.float32)
    obs[:, 0] = 0
    for b in range(batch):
        obs[b, 0, rng.integers(7), rng.integers(11)] = 1
    return obs


def _jax_net(obs, seed, **kw):
    net = JaxGeeseNet(**kw)
    params = net.init(jax.random.PRNGKey(seed), jnp.asarray(obs))
    return net, params, jax.tree_util.tree_map(np.asarray, params)


def _port_out(tree, obs, **kw):
    net = GeeseNet(**kw)
    net.load_state_dict(params_from_flax(tree))
    with torch.no_grad():
        out = net.eval()(torch.from_numpy(obs))
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize('impl', ['pad', 'halo', 'pallas'])
def test_forward_parity_small(impl):
    obs = _obs(3, seed=0)
    kw = dict(layers=2, filters=16, torus_impl=impl)
    net, params, tree = _jax_net(obs, 1, **kw)
    ref = net.apply(params, jnp.asarray(obs))
    got = _port_out(tree, obs, **kw)
    for k in ('policy', 'value'):
        assert got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), **TOL)


def test_forward_parity_full_width():
    """Full width (L=12, F=32), B=2: the port's 'pallas' net (its trunk's
    plain version on the CPU) and its 'pad' net against the JAX 'pad'."""
    obs = _obs(2, seed=2)
    net, params, tree = _jax_net(obs, 3)
    ref = net.apply(params, jnp.asarray(obs))
    for impl in ('pallas', 'pad'):
        got = _port_out(tree, obs, torus_impl=impl)
        for k in ('policy', 'value'):
            np.testing.assert_allclose(got[k], np.asarray(ref[k]),
                                       err_msg=impl, **TOL)


def test_flax_tree_round_trip_and_leading_dims():
    """params_to_flax inverts params_from_flax, the tree has the JAX
    net's structure, and extra leading dims pass through the forward."""
    obs = _obs(4, seed=4)
    _, _, tree = _jax_net(obs, 5, layers=2, filters=16)
    net = GeeseNet(layers=2, filters=16, torus_impl='pallas')
    net.load_state_dict(params_from_flax(tree))
    back = params_to_flax(net)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with torch.no_grad():
        flat = net(torch.from_numpy(obs))
        lead = net(torch.from_numpy(obs.reshape(2, 2, 17, 7, 11)))
    assert lead['policy'].shape == (2, 2, 4)
    assert lead['value'].shape == (2, 2, 1)
    np.testing.assert_array_equal(lead['policy'].reshape(4, 4).numpy(),
                                  flat['policy'].numpy())


def test_snapshot_round_trip_is_exact():
    gen = torch.Generator().manual_seed(6)
    net = GeeseNet(layers=2, filters=16, torus_impl='pallas', generator=gen)
    wrapper = ModelWrapper(net, device='cpu')
    snap = wrapper.snapshot()
    assert snap['architecture'] == 'GeeseNet'
    assert snap['config'] == {'layers': 2, 'filters': 16,
                              'torus_impl': 'pallas'}
    assert isinstance(snap['params'], bytes)
    back = ModelWrapper.from_snapshot(snap, device='cpu')
    assert back.module.config() == net.config()
    ref, got = net.state_dict(), back.module.state_dict()
    assert ref.keys() == got.keys()
    for k in ref:
        assert torch.equal(ref[k], got[k]), k
    obs = _obs(1, seed=7)[0]
    for k, v in wrapper.inference(obs).items():
        np.testing.assert_array_equal(back.inference(obs)[k], v)


def test_fresh_init_follows_flax_defaults():
    """lecun_normal kernels (variance 1/fan_in), GroupNorm scale 1 and
    bias 0; the same seed gives the same weights."""
    def make():
        return GeeseNet(generator=torch.Generator().manual_seed(8))

    net = make().requires_grad_(False)
    for w, fan_in in ((net.stem_w, 9 * 17), (net.block_w, 9 * 32),
                      (net.policy_w, 32), (net.value_w, 64)):
        std = float(w.std())
        # ~ 1/sqrt(fan_in) within sampling noise (>= 64 draws per tensor)
        assert abs(std * np.sqrt(fan_in) - 1) < 0.25, (w.shape, std)
        assert float(w.abs().max()) <= 2.0 / 0.8796 / np.sqrt(fan_in) + 1e-6
    assert torch.equal(net.stem_scale, torch.ones(32))
    assert torch.equal(net.block_bias, torch.zeros(12, 32))
    assert all(torch.equal(a, b) for a, b in
               zip(net.state_dict().values(), make().state_dict().values()))
