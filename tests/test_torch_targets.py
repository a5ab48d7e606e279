"""The port's target recursions (handyrl_tpu_torch/ops/targets.py) against
the JAX package's: the ``lax.scan`` versions in handyrl_tpu/ops/targets.py
and the Pallas kernels of handyrl_tpu/ops/pallas_targets.py in interpret
mode, on the same numpy inputs. The port's wrappers run the plain version
for a CPU tensor; the CUDA kernels (K3-K5) are held to it on the card by
chip_smoke.py.

Tolerance rtol = atol = 1e-5, as tests/test_targets.py uses: fp32, at most
T = 16 steps of a contraction (|gamma * lambda| <= 1), the two sides
associate the products differently."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops import pallas_targets as jax_pallas
from handyrl_tpu.ops import targets as jax_targets
from handyrl_tpu_torch.ops import targets, kernel_launches

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(seed, B=3, T=7, P=2, returns_T=None):
    rng = np.random.RandomState(seed)
    shape = (B, T, P, 1)
    f = np.float32
    return dict(
        values=rng.randn(*shape).astype(f),
        returns=rng.randn(B, returns_T or T, P, 1).astype(f),
        rewards=rng.randn(*shape).astype(f),
        rhos=rng.uniform(0.1, 1.0, shape).astype(f),
        cs=rng.uniform(0.1, 1.0, shape).astype(f),
        masks=(rng.rand(*shape) > 0.3).astype(f))


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _both(out):
    return [np.asarray(o) for o in out]


@pytest.mark.parametrize('algorithm', ['TD', 'UPGO', 'VTRACE', 'MC'])
@pytest.mark.parametrize('gamma', [1.0, 0.8])
@pytest.mark.parametrize('use_rewards', [True, False])
def test_compute_target_matches_jax(algorithm, gamma, use_rewards):
    d = _rand(42)
    rew = d['rewards'] if use_rewards else None
    want = jax_targets.compute_target(
        algorithm, d['values'], d['returns'], rew, 0.7, gamma, d['rhos'],
        d['cs'], d['masks'], use_pallas=False)
    got = targets.compute_target(
        algorithm, _t(d['values']), _t(d['returns']), _t(rew), 0.7, gamma,
        _t(d['rhos']), _t(d['cs']), _t(d['masks']))
    for g, w in zip(got, _both(want)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


@pytest.mark.parametrize('algorithm', ['TD', 'UPGO', 'VTRACE'])
def test_outcome_bootstrap_of_length_one(algorithm):
    """The value target bootstraps from batch['outcome'], (B, 1, P, 1)."""
    d = _rand(7, returns_T=1)
    want = jax_targets.compute_target(
        algorithm, d['values'], d['returns'], None, 0.7, 1.0, d['rhos'],
        d['cs'], d['masks'], use_pallas=False)
    got = targets.compute_target(
        algorithm, _t(d['values']), _t(d['returns']), None, 0.7, 1.0,
        _t(d['rhos']), _t(d['cs']), _t(d['masks']))
    for g, w in zip(got, _both(want)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


# B*P = 200 lanes: not a multiple of the 128-lane tile the Pallas wrapper
# pads to; T = 1 (the bootstrap row alone); P = 4 (four players a row, as
# Hungry Geese's turn-alternating batches); returns of one row (the value
# target's outcome, whose bootstrap row the CUDA kernels read in place)
@pytest.mark.parametrize('B,T,P,returns_T', [
    (4, 16, 2, None), (100, 16, 2, None), (4, 1, 2, None), (25, 16, 4, None),
    (3, 1, 4, None), (4, 16, 2, 1), (25, 16, 4, 1)],
    ids=['4-16-2', '100-16-2', '4-1-2', '25-16-4', '3-1-4',
         '4-16-2-one_returns_row', '25-16-4-one_returns_row'])
@pytest.mark.parametrize('kernel', ['td_lambda', 'upgo', 'vtrace'])
def test_kernel_wrappers_match_jax_pallas_interpret(kernel, B, T, P,
                                                    returns_T):
    d = _rand(3, B=B, T=T, P=P, returns_T=returns_T)
    lam = (0.7 + 0.3 * (1 - d['masks'])).astype(np.float32)
    args = (d['values'], d['returns'], d['rewards'], lam, 0.9)
    extra = (d['rhos'], d['cs']) if kernel == 'vtrace' else ()
    want = getattr(jax_pallas, kernel + '_pallas')(*args, *extra,
                                                   interpret=True)
    got = getattr(targets, kernel + '_kernel')(
        *[_t(a) for a in args[:4]], 0.9, *[_t(a) for a in extra])
    for g, w in zip(got, _both(want)):
        assert g.shape == (B, T, P, 1)
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_no_baseline_falls_back_to_returns():
    d = _rand(2)
    t, a = targets.compute_target('TD', None, _t(d['returns']), None, 0.7,
                                  1.0, _t(d['rhos']), _t(d['cs']),
                                  _t(d['masks']))
    assert t is a
    np.testing.assert_array_equal(t.numpy(), d['returns'])


def test_td_hand_computed_two_steps():
    """tv_1 = G_1; tv_0 = r_0 + g*((1-l)*V_1 + l*tv_1)."""
    def arr(*v):
        return torch.tensor(v, dtype=torch.float32).reshape(1, 2, 1, 1)
    ones = torch.ones(1, 2, 1, 1)
    g, lmb = 0.9, 0.7
    t, _ = targets.compute_target('TD', arr(0.5, 0.25), arr(0.9, 1.0),
                                  arr(0.1, 0.0), lmb, g, ones, ones, ones)
    np.testing.assert_allclose(
        t.numpy().ravel(), [0.1 + g * ((1 - lmb) * 0.25 + lmb * 1.0), 1.0],
        rtol=1e-6)


def test_vtrace_hand_computed_two_steps():
    def arr(*v):
        return torch.tensor(v, dtype=torch.float32).reshape(1, 2, 1, 1)
    ones = torch.ones(1, 2, 1, 1)
    g, lmb = 0.9, 0.6
    vs, adv = targets.compute_target(
        'VTRACE', arr(0.5, 0.25), arr(0.0, 1.0), arr(0.1, 0.2), lmb, g,
        arr(0.8, 0.9), arr(0.7, 0.6), ones)
    d0 = 0.8 * (0.1 + g * 0.25 - 0.5)
    d1 = 0.9 * (0.2 + g * 1.0 - 0.25)
    want_vs = [0.5 + d0 + g * lmb * 0.7 * d1, 0.25 + d1]
    want_adv = [0.1 + g * want_vs[1] - 0.5, 0.2 + g * 1.0 - 0.25]
    np.testing.assert_allclose(vs.numpy().ravel(), want_vs, rtol=1e-5)
    np.testing.assert_allclose(adv.numpy().ravel(), want_adv, rtol=1e-5)


def test_masked_steps_collapse_to_lambda_one():
    d = _rand(3)
    zeros = np.zeros_like(d['masks'])
    g = 0.8
    t, _ = targets.compute_target('TD', _t(d['values']), _t(d['returns']),
                                  _t(d['rewards']), 0.3, g, _t(d['rhos']),
                                  _t(d['cs']), _t(zeros))
    want = np.zeros_like(d['values'])
    want[:, -1] = d['returns'][:, -1]
    for i in range(want.shape[1] - 2, -1, -1):
        want[:, i] = d['rewards'][:, i] + g * want[:, i + 1]
    np.testing.assert_allclose(t.numpy(), want, **TOL)


def test_broadcast_rhos_match_jax():
    """Turn-based batches carry (B, T, 1, 1) importance ratios against
    (B, T, 2, 1) values; both sides broadcast them."""
    d = _rand(9)
    rhos, cs = d['rhos'][:, :, :1], d['cs'][:, :, :1]
    want = jax_targets.compute_target(
        'VTRACE', d['values'], d['returns'], d['rewards'], 0.7, 0.9, rhos,
        cs, d['masks'], use_pallas=False)
    got = targets.compute_target(
        'VTRACE', _t(d['values']), _t(d['returns']), _t(d['rewards']), 0.7,
        0.9, _t(rhos), _t(cs), _t(d['masks']))
    for g, w in zip(got, _both(want)):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def test_cpu_calls_never_count_launches():
    d = _rand(4)
    before = kernel_launches()
    for algorithm in ('TD', 'UPGO', 'VTRACE'):
        targets.compute_target(algorithm, _t(d['values']), _t(d['returns']),
                               None, 0.7, 1.0, _t(d['rhos']), _t(d['cs']),
                               _t(d['masks']))
    assert kernel_launches() == before
    assert [before[k] for k in ('td_lambda', 'upgo', 'vtrace')] == [0] * 3


@pytest.mark.parametrize('algorithm', ['TD', 'UPGO', 'VTRACE'])
def test_meta_tensor_raises(algorithm):
    d = _rand(5)
    m = {k: torch.from_numpy(v).to('meta') for k, v in d.items()}
    with pytest.raises(ValueError, match='no kernel'):
        targets.compute_target(algorithm, m['values'], m['returns'], None,
                               0.7, 1.0, m['rhos'], m['cs'], m['masks'])


def test_unknown_algorithm_raises():
    d = _rand(6)
    with pytest.raises(ValueError, match='unknown target'):
        targets.compute_target('GAE', _t(d['values']), _t(d['returns']),
                               None, 0.7, 1.0, _t(d['rhos']), _t(d['cs']),
                               _t(d['masks']))
