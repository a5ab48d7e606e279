"""The port's hand-derived trunk backward (handyrl_tpu_torch/ops/geese_trunk.py
``trunk_backward_reference``, the plain version of K2 and what the wrapper
runs for a CPU tensor) against the JAX package's Pallas trunk
(handyrl_tpu/ops/pallas_geese.py): ``jax.vjp`` of ``trunk_apply`` in
interpret mode, which runs the TPU backward kernel ``_bwd_kernel``, both
from the saved training forward (as K2 runs) and recomputing each layer.
It is also held against torch autograd of the port's plain forward, and
:class:`TrunkFunction`'s wiring is checked. The CUDA kernel itself is held
to the plain version on the card by chip_smoke.py.

Tolerance rtol = atol = 1e-4: fp32 throughout; the three backwards sum the
taps, the GroupNorm statistics and the weight-grad reductions over N*77
pixels in different orders, and the error grows through two normalised
layers of the chain (observed about 1e-6 here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handyrl_tpu.ops.pallas_geese import trunk_apply as jax_trunk_apply
from handyrl_tpu_torch.ops import geese_trunk, kernel_launches

LAYERS, FILTERS, CIN, N = 2, 16, 17, 5
GROUPS = min(8, FILTERS)
TOL = dict(rtol=1e-4, atol=1e-4)
NAMES = ('dx', 'd_stem_w', 'd_stem_scale', 'd_stem_bias', 'd_block_w',
         'd_block_scale', 'd_block_bias')


def _inputs(seed=0, layers=LAYERS, n=N):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, 7, 11, CIN)).astype(f32)
    ops = (
        (rng.standard_normal((3, 3, CIN, FILTERS)) / np.sqrt(9 * CIN)).astype(f32),
        rng.uniform(0.5, 1.5, FILTERS).astype(f32),
        (0.1 * rng.standard_normal(FILTERS)).astype(f32),
        (rng.standard_normal((layers, 3, 3, FILTERS, FILTERS))
         / np.sqrt(9 * FILTERS)).astype(f32),
        rng.uniform(0.5, 1.5, (layers, FILTERS)).astype(f32),
        (0.1 * rng.standard_normal((layers, FILTERS))).astype(f32),
    )
    dy = rng.standard_normal((n, 7, 11, FILTERS)).astype(f32)
    return x, ops, dy


def _port_backward(x, ops, dy, need_dx=True, saved=False):
    """The plain backward; with ``saved`` from what the plain training
    forward saved (acts, y, xhat, rstd), as K2 runs, else recomputing each
    layer's conv and statistics."""
    args = [torch.from_numpy(a) for a in (x,) + ops]
    kw = {}
    if saved:
        n, layers = x.shape[0], ops[3].shape[0]
        kw = dict(acts=torch.empty(n, layers, 7, 11, FILTERS),
                  xhat=torch.empty(n, layers + 1, 7, 11, FILTERS),
                  rstd=torch.empty(n, layers + 1, GROUPS))
        kw['y'] = geese_trunk.trunk_forward_reference(*args, groups=GROUPS,
                                                      **kw)
    out = geese_trunk.trunk_backward_reference(
        *args, torch.from_numpy(dy), groups=GROUPS, need_dx=need_dx, **kw)
    return [None if g is None else g.numpy() for g in out]


def _jax_vjp(x, ops, dy, tile):
    def f(*a):
        return jax_trunk_apply(*a, GROUPS, tile, True)
    _, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, ops))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


@pytest.mark.parametrize('seed,saved', [
    pytest.param(0, False, id='0'), pytest.param(1, False, id='1'),
    pytest.param(0, True, id='saved-0'), pytest.param(1, True, id='saved-1')])
def test_reference_backward_matches_jax_vjp_of_pallas_interpret(seed, saved):
    """Both paths of the plain backward: from the saved forward (acts, y,
    xhat, rstd, as K2 reads them) and recomputing each layer's conv."""
    x, ops, dy = _inputs(seed)
    # the JAX trunk takes N in whole tiles; tile 5 is the batch itself
    want = _jax_vjp(x, ops, dy, tile=N)
    got = _port_backward(x, ops, dy, saved=saved)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)


def test_reference_backward_matches_torch_autograd_of_plain_forward():
    x, ops, dy = _inputs(seed=2, layers=3, n=3)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x,) + ops]
    y = geese_trunk.trunk_forward_reference(*args, groups=GROUPS)
    want = torch.autograd.grad(y, args, torch.from_numpy(dy))
    got = _port_backward(x, ops, dy)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g, w.numpy(), err_msg=name, **TOL)


def test_stem_only_trunk_has_empty_block_grads():
    """L = 0: the stem alone, with no residual path anywhere."""
    x, ops, dy = _inputs(seed=3, layers=0, n=2)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (x,) + ops]
    y = geese_trunk.trunk_forward_reference(*args, groups=GROUPS)
    want = torch.autograd.grad(y, args[:4], torch.from_numpy(dy))
    got = _port_backward(x, ops, dy)
    for name, g, w in zip(NAMES, got[:4], want):
        np.testing.assert_allclose(g, w.numpy(), err_msg=name, **TOL)
    assert got[4].shape == (0, 3, 3, FILTERS, FILTERS)


def test_function_returns_dx_only_when_x_needs_it():
    x, ops, dy = _inputs(seed=4, n=2)
    params = [torch.from_numpy(a).requires_grad_(True) for a in ops]
    want = _port_backward(x, ops, dy)
    for x_grad in (False, True):
        xt = torch.from_numpy(x).requires_grad_(x_grad)
        y = geese_trunk.trunk_apply(xt, *params, groups=GROUPS)
        np.testing.assert_allclose(
            y.detach().numpy(),
            geese_trunk.trunk_forward_reference(
                torch.from_numpy(x), *map(torch.from_numpy, ops),
                groups=GROUPS).numpy(), rtol=0, atol=0)
        y.backward(torch.from_numpy(dy))
        assert (xt.grad is not None) == x_grad
        if x_grad:
            np.testing.assert_allclose(xt.grad.numpy(), want[0], **TOL)
        for name, p, w in zip(NAMES[1:], params, want[1:]):
            np.testing.assert_allclose(p.grad.numpy(), w, err_msg=name, **TOL)
            p.grad = None
    assert kernel_launches()['geese_trunk'] == 0
    assert kernel_launches()['geese_trunk_bwd'] == 0


def test_wrapper_backward_on_cpu_is_the_reference_and_never_counts():
    x, ops, dy = _inputs(seed=5, n=2)
    args = [torch.from_numpy(a) for a in (x,) + ops]
    got = geese_trunk.trunk_backward(*args, torch.from_numpy(dy),
                                     groups=GROUPS, need_dx=False)
    want = _port_backward(x, ops, dy, need_dx=False)
    assert got[0] is None and want[0] is None
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(g.numpy(), w)
    assert kernel_launches()['geese_trunk_bwd'] == 0


def test_training_forward_records_block_inputs():
    x, ops, _ = _inputs(seed=6, n=2)
    args = [torch.from_numpy(a) for a in (x,) + ops]
    acts = torch.full((2, LAYERS, 7, 11, FILTERS), float('nan'))
    y = geese_trunk.trunk_forward(*args, groups=GROUPS, acts=acts)
    h = torch.relu(geese_trunk._group_norm(
        geese_trunk._torus_conv(args[0], args[1]), args[2], args[3], GROUPS))
    np.testing.assert_allclose(acts[:, 0].numpy(), h.numpy(), rtol=0, atol=0)
    assert torch.isfinite(acts).all()
    assert torch.equal(y, geese_trunk.trunk_forward(*args, groups=GROUPS))


def test_backward_has_no_kernel_for_other_devices():
    x, ops, dy = _inputs(seed=7, n=1)
    args = [torch.from_numpy(a).to('meta') for a in (x,) + ops + (dy,)]
    with pytest.raises(ValueError, match='no kernel'):
        geese_trunk.trunk_backward(*args, groups=GROUPS)


def test_reference_backward_from_saved_forward_equals_recomputed():
    """Given the training forward's block inputs and output, the plain
    backward takes its layer inputs and ReLU masks from them (as K2 does)
    and gives the grads it gives when it runs the forward itself."""
    x, ops, dy = _inputs(seed=8, n=3)
    args = [torch.from_numpy(a) for a in (x,) + ops]
    acts = torch.empty(3, LAYERS, 7, 11, FILTERS)
    y = geese_trunk.trunk_forward(*args, groups=GROUPS, acts=acts)
    got = geese_trunk.trunk_backward(*args, torch.from_numpy(dy),
                                     groups=GROUPS, acts=acts, y=y)
    want = _port_backward(x, ops, dy)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, rtol=0,
                                   atol=1e-6)
