"""The arithmetic of K2b, the weight-grad phase of the port's trunk backward
(``trunk_wgrad_kernel`` + ``column_sum`` in ``csrc/geese_trunk.cu``),
emulated on the CPU at full GeeseNet width and held to the JAX package's
grads (the CUDA kernel itself is held to the plain version on the card by
chip_smoke.py).

K2b forms each layer's weight grad dW[t][ci][f] = sum over samples s and
pixels p of in[s, nbr(p, t), ci] * dc[s, p, f] as a GEMM on the tensor
cores in 3xTF32: both operands are split into TF32 hi + lo by truncation
(hi = bits & ~0x1fff, lo = the rest, truncated the same way; each value is
split as its fragment loads, so the kernel takes one integer operation
each where K1's and K2a's ``cvt.rna`` rounding, (bits + 0x1000) & ~0x1fff,
takes two), each k8 step (8 pixels of one sample) adds hi*hi into one
fp32 accumulator and lo*hi, then hi*lo, into another, lo*lo is left out,
and the two are added at the end. A sample's 77 pixels are padded to
80 with zero rows in both operands; the stem's 17 input channels are padded
to 24 with zero columns. One block sums the samples of one chunk in order;
the chunks' partial rows are then added in chunk order (column_sum), and so
are the scale and bias grads, which stay fp32. The chunk size and the
padded pixel count are read from the kernel source.

Here that arithmetic runs in numpy through all 13 layers (Cin=17, F=32,
L=12, 8 groups) on seeded inputs over more than one chunk (the last one
ragged), from each layer's input and conv-output grad dc as the JAX
package's tile math gives them, and every weight, scale and bias grad is
held to ``jax.vjp`` of ``handyrl_tpu.ops.pallas_geese.tile_forward``.

Tolerance: each grad's max abs error within BWD_TOL = 1e-4 of its largest
element, as chip_smoke.py holds K2 on the card: fp32 sums of N*77 products
in another order than XLA's and the truncating 3xTF32 split (about 2^-20
of each product) stay near 1e-6 of the largest element. A
single TF32 pass (hi*hi alone) truncates each operand at 2^-10: a thousand
times worse, past BWD_TOL (9e-4 to 1e-3 against 7e-7 to 8e-7 here), which
is why the kernel keeps three products."""

import torch
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from handyrl_tpu.ops.pallas_geese import _group_norm, _torus_conv, tile_forward


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


CIN, FILTERS, LAYERS, GROUPS = 17, 32, 12, 8
BWD_TOL = 1e-4
SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'handyrl_tpu_torch', 'csrc', 'geese_trunk.cu')


def _kernel_constant(name):
    with open(SOURCE) as f:
        return int(re.search(r'constexpr int %s = (\d+);' % name,
                             f.read()).group(1))


CHUNK = _kernel_constant('kChunk')
KPIX = _kernel_constant('kKPix')
N = CHUNK + CHUNK // 2 + 1   # two chunks, the second ragged


def _tf32(a):
    """fp32 truncated to TF32 (10 mantissa bits), as K2b splits."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
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
    dy = rng.standard_normal((N, 7, 11, FILTERS)).astype(f32)
    return x, ops, dy


def _jax_grads(x, ops, dy):
    """The JAX package's grads of the trunk's weights, scales and biases."""
    _, vjp = jax.vjp(lambda *w: tile_forward(jnp.asarray(x), *w,
                                             groups=GROUPS,
                                             dtype=jnp.float32),
                     *map(jnp.asarray, ops))
    return [np.asarray(g) for g in vjp(jnp.asarray(dy))]


def _jax_layers(x, ops, dy):
    """What K2b reads, from the JAX package's tile math: each layer's input
    (x, then each block's), its conv-output grad dc and per-sample scale and
    bias grads. A zero offset on each conv output and per-sample copies of
    each scale and bias make one vjp give them."""
    stem_w, stem_scale, stem_bias, block_w, block_scale, block_bias = map(
        jnp.asarray, ops)
    weights = [stem_w] + [block_w[i] for i in range(LAYERS)]

    def per_sample(v):
        return jnp.broadcast_to(v, (N, 1, 1, FILTERS))

    scales = [per_sample(stem_scale)] + [per_sample(s) for s in block_scale]
    biases = [per_sample(stem_bias)] + [per_sample(b) for b in block_bias]
    deltas = [jnp.zeros((N, 7, 11, FILTERS), jnp.float32)] * (LAYERS + 1)

    def forward(deltas, scales, biases):
        h, inputs = jnp.asarray(x), []
        for l in range(LAYERS + 1):
            inputs.append(h)
            c = _torus_conv(h, weights[l], jnp.float32) + deltas[l]
            c = _group_norm(c, scales[l], biases[l], GROUPS)
            h = jax.nn.relu(c if l == 0 else h + c)
        return h, inputs

    _, vjp, inputs = jax.vjp(forward, deltas, scales, biases, has_aux=True)
    dc, dscale, dbias = vjp(jnp.asarray(dy))
    return ([np.asarray(h) for h in inputs], [np.asarray(d) for d in dc],
            [np.asarray(d).reshape(N, FILTERS) for d in dscale],
            [np.asarray(d).reshape(N, FILTERS) for d in dbias])


def _neighbour_rows():
    """(9, KPIX): the row of the layer input that tap t of pixel p reads;
    the padded pixels read the zero row 77."""
    rows = np.full((9, KPIX), 77)
    for t in range(9):
        a, b = divmod(t, 3)
        for p in range(77):
            r, c = divmod(p, 11)
            rows[t, p] = ((r + a - 1) % 7) * 11 + (c + b - 1) % 11
    return rows


def _emulated_wgrad(h, dc, terms):
    """K2b's weight grad of one layer, (3,3,C,F), from its input h (N,7,11,C)
    and dc (N,7,11,F): per chunk, the samples in order, each sample's KPIX/8
    k8 steps in order, hi*hi into acc and the small terms into their own
    accumulator ('three'), or hi*hi alone ('one'); the chunks' partials
    then added in chunk order."""
    c = h.shape[-1]
    cw = -(-c // 8) * 8
    f32 = np.float32
    hp = np.zeros((N, 78, cw), f32)               # zero row 77, zero columns
    hp[:, :77, :c] = h.reshape(N, 77, c)
    dcp = np.zeros((N, KPIX, FILTERS), f32)       # zero rows 77..
    dcp[:, :77] = dc.reshape(N, 77, FILTERS)
    b_hi, b_lo = _split(hp[:, _neighbour_rows()])   # (N, 9, KPIX, cw)
    a_hi, a_lo = _split(dcp)
    total = np.zeros((9, FILTERS, cw), f32)
    for n0 in range(0, N, CHUNK):
        acc = np.zeros((9, FILTERS, cw), f32)
        small = np.zeros((9, FILTERS, cw), f32)
        for s in range(n0, min(N, n0 + CHUNK)):
            for k in range(0, KPIX, 8):
                a, al = a_hi[s, k:k + 8], a_lo[s, k:k + 8]
                b, bl = b_hi[s, :, k:k + 8], b_lo[s, :, k:k + 8]
                acc += np.einsum('kf,tkc->tfc', a, b)
                if terms == 'three':
                    small += np.einsum('kf,tkc->tfc', al, b)
                    small += np.einsum('kf,tkc->tfc', a, bl)
        total += acc + small
    return total[:, :, :c].transpose(0, 2, 1).reshape(3, 3, c, FILTERS)


def _chunked_sum(v):
    """Per-sample grads (N, F) summed as K2b and column_sum add them."""
    total = np.zeros(v.shape[1:], np.float32)
    for n0 in range(0, N, CHUNK):
        part = np.zeros(v.shape[1:], np.float32)
        for s in range(n0, min(N, n0 + CHUNK)):
            part += v[s]
        total += part
    return total


def _emulated_grads(layers, terms):
    inputs, dcs, dscales, dbiases = layers
    dw = [_emulated_wgrad(h, d, terms) for h, d in zip(inputs, dcs)]
    ds = [_chunked_sum(v) for v in dscales]
    db = [_chunked_sum(v) for v in dbiases]
    return [dw[0], ds[0], db[0], np.stack(dw[1:]), np.stack(ds[1:]),
            np.stack(db[1:])]


def _errors(got, ref):
    return [float(np.abs(g - r).max() / np.abs(r).max())
            for g, r in zip(got, ref)]


@pytest.fixture(scope='module')
def case():
    x, ops, dy = _inputs(20261017)
    layers = _jax_layers(x, ops, dy)
    return _jax_grads(x, ops, dy), layers, _emulated_grads(layers, 'three')


def test_the_inputs_span_two_chunks():
    assert CHUNK < N < 2 * CHUNK and KPIX % 8 == 0 and KPIX >= 77


def test_the_layer_grads_are_the_trunk_grads(case):
    """The per-sample scale and bias grads sum to the trunk's: the dc and
    inputs the emulation reads are those of the same backward."""
    ref, (inputs, dcs, dscales, dbiases), _ = case
    assert len(inputs) == len(dcs) == LAYERS + 1
    assert inputs[0].shape == (N, 7, 11, CIN)
    np.testing.assert_allclose(dscales[0].sum(0), ref[1], rtol=0,
                               atol=1e-5 * np.abs(ref[1]).max())
    np.testing.assert_allclose(np.stack([d.sum(0) for d in dbiases[1:]]),
                               ref[5], rtol=0,
                               atol=1e-5 * np.abs(ref[5]).max())


@pytest.mark.parametrize('grad', range(6))
def test_three_tf32_terms_match_the_jax_grads(case, grad):
    ref, _, three = case
    got = three[grad]
    assert got.shape == ref[grad].shape and np.isfinite(got).all()
    assert np.abs(got - ref[grad]).max() <= BWD_TOL * np.abs(ref[grad]).max()


def test_one_tf32_pass_is_measurably_worse(case):
    ref, layers, three = case
    three = _errors(three[::3], ref[::3])
    one = _errors(_emulated_grads(layers, 'one')[::3], ref[::3])
    for e3, e1 in zip(three, one):   # the stem's and the blocks' weights
        assert e1 > 10 * e3 and e1 > BWD_TOL
