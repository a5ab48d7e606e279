"""The port's GeeseNet trunk (handyrl_tpu_torch/ops/geese_trunk.py) against
the JAX package's Pallas trunk (handyrl_tpu/ops/pallas_geese.py), on the
CPU: the same numpy inputs go through the JAX kernel in interpret mode, the
JAX tile math ``tile_forward``, and the port's plain version, which is what
the port's wrapper runs for a CPU tensor. The CUDA kernel itself is held
to the plain version on the card by chip_smoke.py.

Tolerance rtol = atol = 2e-5, as tests/test_pallas_geese.py uses for the
same function: fp32 throughout, the two frameworks sum the 9 taps and the
GroupNorm statistics in different orders."""

import os
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops.pallas_geese import (tile_forward, trunk_apply,
                                          trunk_params_from_geesenet as
                                          jax_trunk_params)
from handyrl_tpu_torch.ops import geese_trunk, kernel_launches


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    """The workers of a parallel test run share the cores: one intra-op
    thread a process (and in the processes a test starts, through
    OMP_NUM_THREADS) keeps these runs' many small ops from waiting on
    descheduled OpenMP threads (tens of times slower without it)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


LAYERS, FILTERS, CIN, N = 2, 16, 17, 5
GROUPS = min(8, FILTERS)
JAX_TILE = 4          # N=5 is not a multiple of it: the JAX side pads
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed=0):
    """x (N,7,11,Cin) and the trunk operands, from numpy with a seed; the
    norm's scale and bias are random so that they are exercised too."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((N, 7, 11, CIN)).astype(f32)
    ops = (
        (rng.standard_normal((3, 3, CIN, FILTERS)) / np.sqrt(9 * CIN)).astype(f32),
        rng.uniform(0.5, 1.5, FILTERS).astype(f32),
        (0.1 * rng.standard_normal(FILTERS)).astype(f32),
        (rng.standard_normal((LAYERS, 3, 3, FILTERS, FILTERS))
         / np.sqrt(9 * FILTERS)).astype(f32),
        rng.uniform(0.5, 1.5, (LAYERS, FILTERS)).astype(f32),
        (0.1 * rng.standard_normal((LAYERS, FILTERS))).astype(f32),
    )
    return x, ops


def _port(x, ops):
    args = [torch.from_numpy(a) for a in (x,) + ops]
    return geese_trunk.trunk_forward(*args, groups=GROUPS).numpy()


def test_plain_version_matches_jax_pallas_kernel_interpret():
    x, ops = _inputs()
    pad = (-N) % JAX_TILE
    xp = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
    ref = np.asarray(trunk_apply(jnp.asarray(xp), *map(jnp.asarray, ops),
                                 GROUPS, JAX_TILE, True))[:N]
    got = _port(x, ops)
    assert got.shape == (N, 7, 11, FILTERS)
    np.testing.assert_allclose(got, ref, **TOL)


def test_plain_version_matches_jax_tile_forward():
    x, ops = _inputs(seed=1)
    ref = np.asarray(tile_forward(jnp.asarray(x), *map(jnp.asarray, ops),
                                  groups=GROUPS, dtype=jnp.float32))
    np.testing.assert_allclose(_port(x, ops), ref, **TOL)


def test_cpu_tensor_takes_the_plain_path_and_never_counts():
    x, ops = _inputs(seed=2)
    before = kernel_launches()['geese_trunk']
    args = [torch.from_numpy(a) for a in (x,) + ops]
    got = geese_trunk.trunk_forward(*args, groups=GROUPS)
    ref = geese_trunk.trunk_forward_reference(*args, groups=GROUPS)
    assert torch.equal(got, ref)
    assert kernel_launches()['geese_trunk'] == before == 0


def test_no_kernel_for_other_devices():
    x, ops = _inputs(seed=3)
    args = [torch.from_numpy(a).to('meta') for a in (x,) + ops]
    with pytest.raises(ValueError, match='no kernel'):
        geese_trunk.trunk_forward(*args, groups=GROUPS)


def test_trunk_params_from_flax_tree_match_jax():
    """The kernel's operand stacking agrees with the JAX package's, with
    and without the top-level 'params' key."""
    rng = np.random.default_rng(4)
    tree = {'TorusConv_%d' % i: {
        'Conv_0': {'kernel': rng.standard_normal(
            (3, 3, CIN if i == 0 else FILTERS, FILTERS)).astype(np.float32)},
        'GroupNorm_0': {'scale': rng.standard_normal(FILTERS).astype(np.float32),
                        'bias': rng.standard_normal(FILTERS).astype(np.float32)}}
        for i in range(LAYERS + 1)}
    ref = jax_trunk_params(tree, layers=LAYERS)
    for wrapped in (tree, {'params': tree}):
        got = geese_trunk.trunk_params_from_geesenet(wrapped, layers=LAYERS)
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
