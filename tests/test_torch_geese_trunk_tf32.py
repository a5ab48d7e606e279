"""The arithmetic of K1, the port's trunk forward kernel, emulated on the CPU
at full GeeseNet width and held to the JAX package's trunk (the CUDA kernel
itself is held to the plain version on the card by chip_smoke.py).

K1 runs each 3x3 torus conv on the tensor cores in 3xTF32: both operands
are split into TF32 hi + lo (``cvt.rna`` rounding: 10 mantissa bits, ties
away from 0, done as (bits + 0x1000) & ~0x1fff), and each product is hi*hi
+ (lo*hi + hi*lo) with fp32 sums, lo*lo left out. The stem's 17 input
channels are padded with zero weight rows and zero input columns to a
multiple of 8 (the kernel takes round8(17) = 24; 32, the width of the
blocks, gives the same sums). The residual stream stays fp32: only the
conv's operands are split. GroupNorm is two-pass (the mean, then the
squared deviations), in fp32. Here that arithmetic runs in numpy through
all 13 layers (stem + 12 blocks, F=32, 8 groups) on seeded inputs, and the
output, each block's input, each layer's normalised conv output ``xhat``
and per-group ``rstd`` are held to the JAX package's tile math
(``tile_forward`` and its ``_torus_conv`` / ``_group_norm``) on the same
inputs.

Tolerance: TOL = 2e-4 abs for y, the block inputs and xhat, RSTD_RTOL =
1e-4 relative for rstd, as chip_smoke.py holds the kernel to the plain
version on the card: fp32 sums in other orders and the 3xTF32 split (about
2^-22 of each product) carried through 13 normalised layers. One TF32 pass
(hi*hi alone) misses TOL, which is why the kernel keeps three."""

import jax.numpy as jnp
import numpy as np
import pytest

from handyrl_tpu.ops.pallas_geese import (_group_norm, _torus_conv,
                                          tile_forward)

CIN, FILTERS, LAYERS, GROUPS, N = 17, 32, 12, 8, 4
EPS = 1e-6
TOL = 2e-4
RSTD_RTOL = 1e-4


def _tf32(a: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32 as K1 rounds it (``cvt.rna.tf32.f32``): add half
    of the 13 dropped bits to the magnitude, then clear them."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a: np.ndarray):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _inputs(seed):
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


def _torus(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    """3x3 torus conv in fp32: the nine tap products, each tap's neighbour
    h[(r+a-1) % 7, (c+b-1) % 11]."""
    n, _, _, c = h.shape
    out = np.zeros((n * 77, w.shape[-1]), np.float32)
    for a in range(3):
        for b in range(3):
            tap = np.roll(h, (1 - a, 1 - b), axis=(1, 2)).reshape(n * 77, c)
            out += tap @ w[a, b]
    return out.reshape(n, 7, 11, -1)


def _conv(h, w, terms):
    """The conv as K1 computes it: 'three' TF32 products (hi*hi, then the
    two small terms summed apart and added) or 'one' (hi*hi)."""
    (h_hi, h_lo), (w_hi, w_lo) = _split(h), _split(w)
    big = _torus(h_hi, w_hi)
    if terms == 'one':
        return big
    return big + (_torus(h_lo, w_hi) + _torus(h_hi, w_lo))


def _emulated_forward(x, ops, terms='three', stem_width=24):
    """K1's forward: y, the block inputs, xhat (L+1 layers) and rstd."""
    stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias = ops
    pad = stem_width - CIN   # zero input columns and zero weight rows
    xp = np.concatenate([x, np.zeros(x.shape[:3] + (pad,), np.float32)], -1)
    wp = np.concatenate(
        [stem_w, np.zeros((3, 3, pad, FILTERS), np.float32)], 2)
    layers = [(wp, stem_scale, stem_bias)] + [
        (block_w[i], block_scale[i], block_bias[i]) for i in range(LAYERS)]
    h, acts, xhats, rstds = xp, [], [], []
    cpg = FILTERS // GROUPS
    for l, (w, scale, bias) in enumerate(layers):
        c = _conv(h, w, terms)
        cg = c.reshape(N, 77, GROUPS, cpg)
        mean = cg.sum(axis=(1, 3), dtype=np.float32) / np.float32(77 * cpg)
        dev = cg - mean[:, None, :, None]
        var = (dev * dev).sum(axis=(1, 3), dtype=np.float32) / np.float32(77 * cpg)
        rstd = (np.float32(1) / np.sqrt(var + np.float32(EPS))).astype(np.float32)
        xhats.append((dev * rstd[:, None, :, None]).reshape(c.shape))
        rstds.append(rstd)
        mul = (rstd[:, :, None] * scale.reshape(GROUPS, cpg)).reshape(N, FILTERS)
        add = bias - (mean[:, :, None] * mul.reshape(N, GROUPS, cpg)
                      ).reshape(N, FILTERS)
        norm = c * mul[:, None, None, :] + add[:, None, None, :]
        h = np.maximum(norm if l == 0 else h + norm, 0).astype(np.float32)
        if l < LAYERS:
            acts.append(h)
    return h, np.stack(acts, 1), np.stack(xhats, 1), np.stack(rstds, 1)


def _jax_reference(x, ops):
    """The JAX package's trunk on the same inputs: y from ``tile_forward``;
    the block inputs, each layer's normalised conv output (its
    ``_group_norm`` at unit scale and zero bias) and per-group rstd (flax
    GroupNorm's, from the same statistics) from its tile math step by
    step."""
    stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias = map(
        jnp.asarray, ops)
    y = np.asarray(tile_forward(jnp.asarray(x), stem_w, stem_scale, stem_bias,
                                block_w, block_scale, block_bias,
                                groups=GROUPS, dtype=jnp.float32))
    ones, zeros = jnp.ones(FILTERS), jnp.zeros(FILTERS)
    h, acts, xhats, rstds = jnp.asarray(x), [], [], []
    layers = [(stem_w, stem_scale, stem_bias)] + [
        (block_w[i], block_scale[i], block_bias[i]) for i in range(LAYERS)]
    for l, (w, scale, bias) in enumerate(layers):
        c = _torus_conv(h, w, jnp.float32)
        xhats.append(np.asarray(_group_norm(c, ones, zeros, GROUPS)))
        cg = c.reshape(N, 77, GROUPS, -1)
        var = jnp.maximum((cg * cg).mean(axis=(1, 3))
                          - cg.mean(axis=(1, 3)) ** 2, 0.0)
        rstds.append(np.asarray(1.0 / jnp.sqrt(var + EPS)))
        norm = _group_norm(c, scale, bias, GROUPS)
        h = jnp.maximum(norm if l == 0 else h + norm, 0.0)
        if l < LAYERS:
            acts.append(np.asarray(h))
    np.testing.assert_allclose(np.asarray(h), y, rtol=0, atol=1e-5)
    return y, np.stack(acts, 1), np.stack(xhats, 1), np.stack(rstds, 1)


@pytest.fixture(scope='module')
def case():
    x, ops = _inputs(20261016)
    return x, ops, _jax_reference(x, ops)


@pytest.mark.parametrize('stem_width', [24, 32])
def test_three_tf32_terms_match_the_jax_trunk(case, stem_width):
    x, ops, (y_ref, acts_ref, _, _) = case
    y, acts, _, _ = _emulated_forward(x, ops, 'three', stem_width)
    assert y.shape == (N, 7, 11, FILTERS) and np.isfinite(y).all()
    assert np.abs(y - y_ref).max() <= TOL
    assert np.abs(acts - acts_ref).max() <= TOL


def test_three_tf32_terms_give_the_saved_xhat_and_rstd(case):
    x, ops, (_, _, xhat_ref, rstd_ref) = case
    _, _, xhat, rstd = _emulated_forward(x, ops, 'three')
    assert xhat.shape == (N, LAYERS + 1, 7, 11, FILTERS)
    assert rstd.shape == (N, LAYERS + 1, GROUPS)
    assert np.abs(xhat - xhat_ref).max() <= TOL
    assert (np.abs(rstd - rstd_ref) / np.abs(rstd_ref)).max() <= RSTD_RTOL


def test_the_stem_padding_adds_nothing(case):
    """Zero weight rows against zero input columns: the padded widths give
    the same conv sums, so 24 and 32 agree to fp32 rounding."""
    x, ops, _ = case
    a = _emulated_forward(x, ops, 'three', 24)
    b = _emulated_forward(x, ops, 'three', 32)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v, rtol=0, atol=1e-5)


def test_one_tf32_pass_misses_the_tolerance(case):
    x, ops, (y_ref, _, xhat_ref, _) = case
    y, _, xhat, _ = _emulated_forward(x, ops, 'one')
    assert np.abs(y - y_ref).max() > TOL
    assert np.abs(xhat - xhat_ref).max() > TOL
