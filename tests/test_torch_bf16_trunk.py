"""The bf16 form of the GeeseNet trunk (handyrl_tpu_torch/ops/geese_trunk.py,
x in bfloat16: K1, K2a and K2b's bf16 form on the card, their plain bf16
versions here) against the JAX package's TPU trunk in bf16
(handyrl_tpu/ops/pallas_geese.py): ``tile_forward`` with
``dtype=jnp.bfloat16``, and ``jax.vjp`` of ``trunk_apply`` (interpret
mode: the TPU kernels ``_fwd_kernel`` and ``_bwd_kernel``) on bf16 x, at
N=8, F=16, L=2 and at full width (Cin 17, F=32, L=12) at N=4. Also the
wrapper's dtype rules, the training form's saved tensors, TrunkFunction in
bf16 and the launch counters' names. The CUDA kernels are held to these
plain versions on the card by chip_smoke.py phase 15(a).

Tolerances:
- the forward within FWD_TOL = 2^-5 of the output's largest element,
  the mean error within FWD_MEAN_TOL = 2^-8 of the mean |y|: both sum the
  nine taps of each conv in fp32 and round at the same points (the conv
  output, the norm's output, the residual sum), but the products' sums
  are blocked in other orders (by the thread count too), so a value near
  a rounding boundary of bf16 rounds one ulp (2^-8 relative) the other
  way and the next layers carry it: equal at the small size, 1 ulp at
  full width (0.125 at |y| up to 16) seen;
- the grads within BWD_TOL = 2^-4 of each grad's largest element: JAX's
  vjp rounds more often than the port's backward (each tap's transposed
  product and each weight grad of an 8-sample tile to bf16, the taps
  summed in bf16), while the port rounds each transposed conv once and
  keeps the weight grads in fp32 (CHANGES.md); 2.0% seen at full width,
  1.2% at the small size. The bf16 grads' own distance from the fp32
  grads of the same weights is larger (checked), so the bound still tells
  a bf16 backward from a wrong one.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops import pallas_geese
from handyrl_tpu_torch.ops import geese_trunk, kernel_launches, launches

FWD_TOL = 2.0 ** -5
FWD_MEAN_TOL = 2.0 ** -8
BWD_TOL = 2.0 ** -4
NAMES = ('dx', 'd_stem_w', 'd_stem_scale', 'd_stem_bias', 'd_block_w',
         'd_block_scale', 'd_block_bias')


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


def _operands(n, cin, F, L, seed):
    """x (boards of 0/1 planes), the six weight operands (norm scale and
    bias off their init) and dy, as numpy float32."""
    rng = np.random.default_rng(seed)
    x = (rng.random((n, 7, 11, cin)) < 0.2).astype(np.float32)
    ops = (rng.normal(0, (1 / (9 * cin)) ** .5, (3, 3, cin, F)),
           rng.normal(1, .1, (F,)), rng.normal(0, .1, (F,)),
           rng.normal(0, (1 / (9 * F)) ** .5, (L, 3, 3, F, F)),
           rng.normal(1, .1, (L, F)), rng.normal(0, .1, (L, F)))
    dy = rng.normal(0, 1, (n, 7, 11, F)).astype(np.float32)
    return x, tuple(np.asarray(a, np.float32) for a in ops), dy


def _bf16_np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


SIZES = [(8, 17, 16, 2), (4, 17, 32, 12)]


@pytest.mark.timeout(240)
@pytest.mark.parametrize('n,cin,F,L', SIZES)
def test_bf16_forward_equals_tile_forward(n, cin, F, L):
    x, ops, _ = _operands(n, cin, F, L, n + L)
    groups = min(8, F)
    want = pallas_geese.tile_forward(jnp.asarray(x, jnp.bfloat16),
                                     *map(jnp.asarray, ops), groups=groups,
                                     dtype=jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tops = [torch.from_numpy(a) for a in ops]
    got = geese_trunk.trunk_forward(xt, *tops, groups=groups)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = got.float().numpy(), _bf16_np(want)
    err = np.abs(g - w)
    assert err.max() <= FWD_TOL * np.abs(w).max(), err.max()
    assert err.mean() <= FWD_MEAN_TOL * np.abs(w).mean(), err.mean()
    # the training form: the same output; acts (bf16) the block inputs,
    # xhat and rstd fp32
    saved = geese_trunk.training_buffers(n, L, F, groups, 'cpu',
                                         torch.bfloat16)
    assert saved['acts'].dtype == torch.bfloat16
    assert saved['xhat'].dtype == saved['rstd'].dtype == torch.float32
    y = geese_trunk.trunk_forward(xt, *tops, groups=groups, **saved)
    assert torch.equal(y, got)
    h = torch.relu(geese_trunk._group_norm(
        geese_trunk._torus_conv(xt, tops[0].to(torch.bfloat16)), tops[1],
        tops[2], groups))
    assert torch.equal(saved['acts'][:, 0], h)


@pytest.mark.timeout(300)
@pytest.mark.parametrize('n,cin,F,L', SIZES)
def test_bf16_backward_matches_trunk_apply_vjp(n, cin, F, L):
    x, ops, dy = _operands(n, cin, F, L, 10 + n + L)
    groups = min(8, F)
    fn = functools.partial(pallas_geese.trunk_apply, groups=groups, tile=n,
                           interpret=True)
    _, vjp = jax.vjp(fn, jnp.asarray(x, jnp.bfloat16),
                     *map(jnp.asarray, ops))
    want = vjp(jnp.asarray(dy, jnp.bfloat16))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    tops = [torch.from_numpy(a) for a in ops]
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    saved = geese_trunk.training_buffers(n, L, F, groups, 'cpu',
                                         torch.bfloat16)
    y = geese_trunk.trunk_forward(xt, *tops, groups=groups, **saved)
    got = geese_trunk.trunk_backward(xt, *tops, dyt, groups=groups, y=y,
                                     **saved)
    # recomputed from the layer inputs, the plain backward is the same
    again = geese_trunk.trunk_backward(xt, *tops, dyt, groups=groups)
    f32 = geese_trunk.trunk_backward(xt.float(), *tops, dyt.float(),
                                     groups=groups)
    for name, g, w, a, f in zip(NAMES, got, want, again, f32):
        assert g.dtype == (torch.bfloat16 if name == 'dx'
                           else torch.float32), name
        w = _bf16_np(w)
        scale = np.abs(w).max()
        err = np.abs(g.float().numpy() - w).max() / scale
        assert err <= BWD_TOL, (name, err)
        torch.testing.assert_close(a, g, rtol=0, atol=0)
        if name in ('d_stem_w', 'd_block_w'):
            # bf16's own distance from the fp32 grads exceeds the bound's
            # use: the test would see a backward that ignored bf16
            own = (np.abs(f.numpy() - g.float().numpy()).max()
                   / np.abs(f.numpy()).max())
            assert own > 0, name


def test_trunk_function_in_bf16_is_the_plain_backward():
    n, cin, F, L = 6, 17, 16, 2
    x, ops, dy = _operands(n, cin, F, L, 3)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tops = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    y = geese_trunk.trunk_apply(xt, *tops, 8)
    assert y.dtype == torch.bfloat16
    y.backward(dyt)
    want = geese_trunk.trunk_backward_reference(
        xt.detach(), *[t.detach() for t in tops], dyt, groups=8)
    for g, w in zip([xt.grad] + [t.grad for t in tops], want):
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [t.grad.dtype for t in tops] == [torch.float32] * 6
    # CPU tensors never count a launch
    assert kernel_launches()['geese_trunk_bf16'] == 0


def test_dtype_rules_of_the_wrapper():
    n, cin, F, L = 2, 17, 16, 1
    x, ops, _ = _operands(n, cin, F, L, 4)
    tops = [torch.from_numpy(a) for a in ops]
    # x picks the form; the weights stay fp32 in both
    for dt in (torch.float32, torch.bfloat16):
        geese_trunk._check_operands(torch.from_numpy(x).to(dt), *tops, 8)
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        geese_trunk._check_operands(torch.from_numpy(x).half(), *tops, 8)
    with pytest.raises(TypeError, match='stem_w'):
        geese_trunk._check_operands(torch.from_numpy(x).to(torch.bfloat16),
                                    tops[0].to(torch.bfloat16), *tops[1:], 8)
    saved = geese_trunk.training_buffers(n, L, F, 8, 'cpu')
    with pytest.raises(TypeError, match='acts'):
        geese_trunk._check_saved(n, L, F, 8, torch.device('cpu'),
                                 torch.bfloat16, **saved)
    # each form counts under its own names
    assert geese_trunk.COUNTERS[torch.bfloat16] == (
        'geese_trunk_bf16', 'geese_trunk_bwd_bf16')
    assert set(geese_trunk.COUNTERS[torch.bfloat16]) <= set(launches.KERNELS)
