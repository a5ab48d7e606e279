"""What K1's training form saves for K2, and the arithmetic K2's tensor-core
transposed conv relies on, on the CPU (the CUDA kernels themselves are held
to their plain versions on the card by chip_smoke.py).

- The plain training forward (``trunk_forward_reference`` with ``xhat`` and
  ``rstd`` buffers) records exactly the normalised conv output and rstd that
  ``_group_norm`` normalises with (atol 0: the same arithmetic).
- The plain backward from the saved tensors recomputes no conv, and
  :class:`TrunkFunction` saves them and hands them to the backward, on the
  CPU without a launch.
- 3xTF32: K2 splits each operand of the transposed conv into TF32 hi + lo
  (``cvt.rna``: 10 mantissa bits, ties away from 0) and sums hi*hi + hi*lo
  + lo*hi in fp32. Emulated here on ``_conv_transpose`` at full width (F=32)
  with dc spread over three decades as K2 sees it (dc carries each group's
  rstd): the three terms stay within 1e-5 of the fp32 result relative to its
  largest element; one TF32 pass (hi*hi) does not, which is why the kernel
  takes three."""

import os
import numpy as np
import pytest
import torch

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


LAYERS, FILTERS, CIN = 2, 16, 17
GROUPS = min(8, FILTERS)
SPLIT_TOL = 1e-5   # 3xTF32 against fp32, relative to the largest element


def _inputs(seed, n=3, layers=LAYERS, filters=FILTERS):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((n, 7, 11, CIN)).astype(f32)
    ops = (
        (rng.standard_normal((3, 3, CIN, filters)) / np.sqrt(9 * CIN)).astype(f32),
        rng.uniform(0.5, 1.5, filters).astype(f32),
        (0.1 * rng.standard_normal(filters)).astype(f32),
        (rng.standard_normal((layers, 3, 3, filters, filters))
         / np.sqrt(9 * filters)).astype(f32),
        rng.uniform(0.5, 1.5, (layers, filters)).astype(f32),
        (0.1 * rng.standard_normal((layers, filters))).astype(f32),
    )
    dy = rng.standard_normal((n, 7, 11, filters)).astype(f32)
    return ([torch.from_numpy(a) for a in (x,) + ops], torch.from_numpy(dy))


def _saved_forward(args, groups=GROUPS):
    n, layers, filters = args[0].shape[0], args[4].shape[0], args[1].shape[-1]
    saved = dict(acts=torch.full((n, layers, 7, 11, filters), float('nan')),
                 xhat=torch.full((n, layers + 1, 7, 11, filters), float('nan')),
                 rstd=torch.full((n, layers + 1, groups), float('nan')))
    y = geese_trunk.trunk_forward_reference(*args, groups=groups, **saved)
    return y, saved


@pytest.mark.parametrize('filters', [16, 32])
def test_training_forward_records_what_group_norm_normalises_with(filters):
    args, _ = _inputs(0, filters=filters)
    y, saved = _saved_forward(args)
    assert torch.equal(y, geese_trunk.trunk_forward_reference(
        *args, groups=GROUPS))
    x, stem_w, block_w = args[0], args[1], args[4]
    inputs = [x] + [saved['acts'][:, i] for i in range(LAYERS)]
    weights = [stem_w] + [block_w[i] for i in range(LAYERS)]
    for l, (h, w) in enumerate(zip(inputs, weights)):
        xhat, rstd, _ = geese_trunk._normalize(geese_trunk._torus_conv(h, w),
                                               GROUPS)
        np.testing.assert_allclose(saved['xhat'][:, l].numpy(), xhat.numpy(),
                                   rtol=0, atol=0)
        np.testing.assert_allclose(saved['rstd'][:, l].numpy(), rstd.numpy(),
                                   rtol=0, atol=0)


def test_wrapper_training_forward_on_cpu_fills_the_buffers():
    args, _ = _inputs(1, n=2)
    y, want = _saved_forward(args)
    got = {k: torch.full_like(v, float('nan')) for k, v in want.items()}
    assert torch.equal(geese_trunk.trunk_forward(*args, groups=GROUPS, **got),
                       y)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert kernel_launches()['geese_trunk'] == 0


def test_reference_backward_from_saved_tensors_recomputes_no_conv(
        monkeypatch):
    """Given acts, y, xhat and rstd the plain backward takes every layer's
    normalised conv output from them, as K2 does: with the conv made to
    raise it still runs, and it gives the recomputing path's grads (tol
    1e-6 abs: the same values reach the same formulas)."""
    args, dy = _inputs(2)
    y, saved = _saved_forward(args)
    want = geese_trunk.trunk_backward_reference(*args, dy, groups=GROUPS)

    def no_conv(*a, **k):
        raise AssertionError('the saved path recomputed a conv')
    monkeypatch.setattr(geese_trunk, '_torus_conv', no_conv)
    got = geese_trunk.trunk_backward_reference(*args, dy, groups=GROUPS, y=y,
                                               **saved)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


def test_function_saves_xhat_and_rstd_and_uses_them(monkeypatch):
    """TrunkFunction's forward keeps acts, y, xhat and rstd; its backward
    reads them (no conv is recomputed) and matches the plain backward
    within 1e-6; nothing launches on the CPU."""
    args, dy = _inputs(3)
    x = args[0].clone().requires_grad_(True)
    params = [a.clone().requires_grad_(True) for a in args[1:]]
    out = geese_trunk.trunk_apply(x, *params, groups=GROUPS)
    y, saved = _saved_forward(args)
    kept = out.grad_fn.saved_tensors
    for name, want in (('y', y), ('acts', saved['acts']),
                       ('xhat', saved['xhat']), ('rstd', saved['rstd'])):
        assert any(t.shape == want.shape and torch.equal(t, want)
                   for t in kept), name
    monkeypatch.setattr(geese_trunk, '_torus_conv', None)   # no recompute
    out.backward(dy)
    want = geese_trunk.trunk_backward_reference(*args, dy, groups=GROUPS,
                                                y=y, **saved)
    for g, w in zip([x.grad] + [p.grad for p in params], want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)
    assert kernel_launches()['geese_trunk'] == 0
    assert kernel_launches()['geese_trunk_bwd'] == 0


# ------------------------------------------------- 3xTF32, emulated

def _tf32(a: np.ndarray) -> np.ndarray:
    """Round fp32 to TF32 as ``cvt.rna.tf32.f32`` does: to 10 mantissa bits,
    to nearest with ties away from 0 (add half of the 13 dropped bits to
    the magnitude, then clear them)."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a: np.ndarray):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def test_tf32_rounding_is_round_half_away():
    ulp = 2.0 ** -10   # TF32's spacing in [1, 2)
    a = np.array([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                  1 + 1.5 * ulp, 3.0e-3, -7.5e4], np.float32)
    r = _tf32(a)
    np.testing.assert_array_equal(r[:4], np.array(
        [1 + ulp, 1, -(1 + ulp), 1 + 2 * ulp], np.float32))
    assert not (r.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(r - a) <= 2.0 ** -11 * np.abs(a)).all()
    hi, lo = _split(a)
    assert not (lo.view(np.uint32) & 0x1FFF).any()
    assert (np.abs(hi + lo - a) <= 2.0 ** -21 * np.abs(a)).all()


def _transposed_conv_terms(seed, filters=32):
    """dc (N,7,11,F) with K2's spread (each sample's group scaled by a
    factor over 1e-2..1e1, as rstd scales it), a block's weights, and the
    transposed conv: fp32, 3xTF32 (hi*hi, then the two small terms summed
    apart and added, as the kernel accumulates them) and one TF32 pass."""
    rng = np.random.default_rng(seed)
    n, cpg = 2, filters // 8
    scale = 10.0 ** rng.uniform(-2, 1, (n, 1, 1, 8))
    dc = (rng.standard_normal((n, 7, 11, filters))
          * np.repeat(scale, cpg, axis=-1)).astype(np.float32)
    w = (rng.standard_normal((3, 3, filters, filters))
         / np.sqrt(9 * filters)).astype(np.float32)

    def conv(d, k):
        return geese_trunk._conv_transpose(torch.from_numpy(d),
                                           torch.from_numpy(k)).numpy()
    (d_hi, d_lo), (w_hi, w_lo) = _split(dc), _split(w)
    exact = conv(dc, w)
    three = conv(d_hi, w_hi) + (conv(d_lo, w_hi) + conv(d_hi, w_lo))
    one = conv(d_hi, w_hi)
    return exact, three, one


@pytest.mark.parametrize('seed', [0, 1])
def test_three_tf32_terms_reach_fp32_in_the_transposed_conv(seed):
    exact, three, _ = _transposed_conv_terms(seed)
    err = np.abs(three - exact).max() / np.abs(exact).max()
    assert err <= SPLIT_TOL, err


def test_one_tf32_pass_misses_fp32():
    exact, _, one = _transposed_conv_terms(0)
    err = np.abs(one - exact).max() / np.abs(exact).max()
    assert err > 10 * SPLIT_TOL, err
