#!/usr/bin/env python3
"""Time K1 and K2's phases for variants of the trunk kernel source on one
NVIDIA GPU: ``python3 scripts/torch_trunk_variants.py [variant ...]
[name=path.cu ...]`` from the root of a checkout.

The checkout's ``handyrl_tpu_torch/csrc/geese_trunk.cu`` is ``current``;
variants are derived from it by exact text edits, each replacing every
occurrence of its text (the script fails if an edit no longer applies):

- ``no_conv``: K2's phase A without its transposed conv (the grads are
  wrong; the time is that of everything else in the phase);
- ``one_accumulator``: phase A's three 3xTF32 mma of a k-step into one set
  of accumulators instead of two;
- ``rolled_taps``: phase A's tap loop not unrolled;
- ``k1_no_conv``: K1 without its convs (its outputs are wrong; the time is
  that of the GroupNorm, the weight staging, the barriers and the writes);
- ``k1_no_stage``: K1 without staging each block's weights (wrong outputs;
  the time of everything else);
- ``k1_one_accumulator``: K1's three mma of a k-step into one set of
  accumulators;
- ``k1_unrolled_taps``: K1's tap loop unrolled;
- ``k1_two_blocks``: K1 built for two blocks an SM instead of three (more
  registers a thread);
- ``k2b_no_mma``: K2's phase B without its products (wrong weight grads;
  the time of the copies, the barriers and column_sum);
- ``k2b_one_pass``: phase B's products as one TF32 pass (hi*hi alone; the
  grads lose accuracy; the time of a third of the mma);
- ``k2b_rolled``: phase B's pixel loop not unrolled (it is by two: more
  registers, the next k-step's loads free to move up);
- ``k2b_halo13``: phase B's halo board 13 columns wide instead of 15 (the
  pixels a quarter warp reads conflict in shared memory where a board row
  wraps);
- ``k2b_raw_b``: phase B with the input's fragments unsplit (lo left 0;
  the grads lose accuracy; the time without 90 integer and float
  operations a lane a k-step);
- ``k2b_rna``: phase B's operands split by rounding (tf32_rna, as K1 and
  K2a split theirs) instead of truncation;
- ``trunc``: K1's and K2a's TF32 rounding by truncation, one integer
  operation instead of two (what their rounding costs);
- ``k2b_chunk8``, ``k2b_chunk13``, ``k2b_chunk15``, ``k2b_chunk32``: phase
  B with 8, 13, 15 or 32 samples a partial row instead of 16 (the blocks'
  fill of the last wave against the partial rows to write and add).

Variants named on the command line run alone (with ``current``); with none
named, all do. Further sources may be given as ``name=path``, for example
another commit's ``geese_trunk.cu`` unpacked with ``git archive``. Every
variant is built (one nvcc each, all at once) into the git-ignored build
directory, then each runs, in the order given and then reversed, on the
same full-width GeeseNet operands (fp32): K1 at N=8 (the serving bucket)
and N=2048 (the update step's rows), serving and training form, timed with
CUDA events, with its largest error against the plain version; and K2 at
N=2048 and N=8 from the current kernel's training forward, phase A's and
phase B's device time per call (torch.profiler) and the largest grad error
against the plain version relative to the grad's largest element.
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, 'handyrl_tpu_torch', 'csrc', 'geese_trunk.cu')
N = 2048

EDITS = {
    'no_conv': [(
        '      conv_transpose_mma<F>(dcs_s, ws, F, mt, nh, nbr, acc);\n',
        '      for (int j = 0; j < kPixTiles; ++j)\n'
        '        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;\n')],
    'one_accumulator': [('mma_tf32(small[j], ', 'mma_tf32(acc[j], ')],
    'rolled_taps': [(
        '#pragma unroll\n  for (int t = 0; t < kTaps; ++t) {',
        '  for (int t = 0; t < kTaps; ++t) {')],
    'k1_no_conv': [(
        '    if (layer == 0)\n'
        '      conv_mma<F, 0>(hs, xpair, ws, cw, mt, nh, nbr, acc);\n'
        '    else\n'
        '      conv_mma<F, F>(hs, S::kPair, ws, F, mt, nh, nbr, acc);\n',
        '    for (int j = 0; j < kPixTiles; ++j)\n'
        '      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;\n')],
    'k1_no_stage': [(
        '      stage_rows<F>(ws, block_w + static_cast<size_t>(layer) * kTaps '
        '* F * F);\n',
        '      ;\n')],
    'k1_one_accumulator': [('mma_tf32(lo_terms[j], ', 'mma_tf32(acc[j], ')],
    'k1_unrolled_taps': [(
        '#pragma unroll 1\n  for (int t = 0; t < kTaps; ++t) {',
        '#pragma unroll\n  for (int t = 0; t < kTaps; ++t) {')],
    'k1_two_blocks': [(
        '__launch_bounds__(FwdShape<F>::kThreads, 3)',
        '__launch_bounds__(FwdShape<F>::kThreads, 2)')],
    'k2b_no_mma': [(
        '      if (ct < nct) wgrad_mma<F>(dcs(b), ins(b), is, base, ct, acc, '
        'small);\n', '')],
    'k2b_one_pass': [(
        '        mma_tf32(small[mi][t], av[mi][0].y, av[mi][1].y, '
        'av[mi][2].y,\n'
        '                 av[mi][3].y, bv[t][0].x, bv[t][1].x);\n',
        '        ;\n'), (
        '        mma_tf32(small[mi][t], av[mi][0].x, av[mi][1].x, '
        'av[mi][2].x,\n'
        '                 av[mi][3].x, bv[t][0].y, bv[t][1].y);\n',
        '        ;\n')],
    'k2b_rolled': [(
        '#pragma unroll 2\n  for (int kk = 0; kk < kKPix / 8; ++kk)',
        '#pragma unroll 1\n  for (int kk = 0; kk < kKPix / 8; ++kk)')],
    'k2b_halo13': [('constexpr int kHaloW = 15;',
                    'constexpr int kHaloW = 13;')],
    'k2b_raw_b': [
        ('      bv[t][0] = split_tf32_trunc(b0p[tap[t]]);\n'
         '      bv[t][1] = split_tf32_trunc(b1p[tap[t]]);\n',
         '      bv[t][0] = make_float2(b0p[tap[t]], 0.f);\n'
         '      bv[t][1] = make_float2(b1p[tap[t]], 0.f);\n')],
    'k2b_rna': [('split_tf32_trunc(ap[', 'split_tf32(ap['),
                ('split_tf32_trunc(b0p[', 'split_tf32(b0p['),
                ('split_tf32_trunc(b1p[', 'split_tf32(b1p[')],
    'trunc': [(
        '  return __uint_as_float((__float_as_uint(x) + 0x1000u) & '
        '0xFFFFE000u);',
        '  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);')],
}


for _n in (8, 13, 15, 32):
    EDITS['k2b_chunk%d' % _n] = [('constexpr int kChunk = 16;',
                                  'constexpr int kChunk = %d;' % _n)]


def derive(text, edits):
    for old, new in edits:
        if old not in text:
            sys.exit('torch_trunk_variants: an edit no longer applies: %r'
                     % old[:60])
        text = text.replace(old, new)
    return text


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_trunk_variants: no CUDA device')
    sys.path.insert(0, REPO)
    import numpy as np
    import chip_smoke as c
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops import cuda_build, geese_trunk

    with open(SOURCE) as f:
        text = f.read()
    out_dir = os.path.join(cuda_build.BUILD_DIR, 'variants')
    os.makedirs(out_dir, exist_ok=True)
    sources = {'current': SOURCE}
    named = [a for a in sys.argv[1:] if '=' not in a]
    for name in named:
        if name not in EDITS:
            sys.exit('torch_trunk_variants: no variant %r' % name)
    for name, edits in EDITS.items():
        if named and name not in named:
            continue
        path = os.path.join(out_dir, name + '.cu')
        with open(path, 'w') as f:
            f.write(derive(text, edits))
        sources[name] = path
    for arg in sys.argv[1:]:
        if '=' in arg:
            name, path = arg.split('=', 1)
            sources[name] = os.path.abspath(path)
    for name, path in sources.items():
        cuda_build.SOURCES['variant_' + name] = path
    print(c.nvidia_smi_line(), flush=True)
    cuda_build.build(['variant_' + name for name in sources])
    for name in sources:   # ptxas's lines for K1 and K2's phases at F=32
        for kernel, what in (('trunk_fwd_kernelILi32', 'K1'),
                             ('trunk_bwd_kernelILi32', 'phase A'),
                             ('trunk_wgrad_kernelILi32', 'phase B')):
            seen = False
            for line in cuda_build.build_log('variant_' + name).splitlines():
                seen = seen or ('Compiling' in line and kernel in line)
                if seen and ('registers' in line or 'stack frame' in line):
                    print('%-18s %s (F=32): %s' % (name, what, line.strip()))
                    if 'registers' in line:
                        break

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, weights = c.trunk_net(torch, GeeseNet)
    obs = np.stack(c.game_observations(make_env, N, c.SEED + 2))
    x = torch.from_numpy(obs).cuda().permute(0, 2, 3, 1).contiguous()
    dy = torch.randn(N, 7, 11, c.WIDTH['filters'],
                     generator=torch.Generator().manual_seed(c.SEED)).cuda()
    groups = c.WIDTH['groups']
    load = cuda_build.load
    with torch.no_grad():
        cases = {}   # K2's operands at N=2048 and N=8
        for rows in (N, 8):
            xr, dyr = x[:rows].contiguous(), dy[:rows].contiguous()
            y, acts, xhat, rstd = c.training_forward(torch, geese_trunk, xr,
                                                     weights, groups)
            saved = dict(acts=acts, y=y, xhat=xhat, rstd=rstd)
            cases[rows] = (xr, dyr, saved, geese_trunk.trunk_backward_reference(
                xr, *weights, dyr, groups=groups, need_dx=False, **saved))
        y_ref = geese_trunk.trunk_forward_reference(x, *weights,
                                                    groups=groups)
        x8 = x[:8].contiguous()
        names = list(sources)
        for name in names + names[::-1]:
            geese_trunk.cuda_build.load = \
                lambda _, name=name: load('variant_' + name)
            geese_trunk._LIB = None

            def forward(rows=x):
                return geese_trunk.trunk_forward(rows, *weights, groups=groups)
            k1_err = (forward() - y_ref).abs().max().item()
            k1 = (c.cuda_time_ms(torch, lambda: forward(x8), 200),
                  c.cuda_time_ms(torch, forward, 50),
                  c.cuda_time_ms(torch, lambda: c.training_forward(
                      torch, geese_trunk, x, weights, groups), 50))

            k2 = []
            for rows, (xr, dyr, saved, ref) in cases.items():
                def kernel():
                    return geese_trunk.trunk_backward(
                        xr, *weights, dyr, groups=groups, need_dx=False,
                        **saved)
                got = kernel()
                torch.cuda.synchronize()
                err = max(((g - r).abs().max() / r.abs().max()).item()
                          for g, r in zip(got[1:], ref[1:]))
                ms = c.kernel_ms(torch, kernel, 20)
                phase = {p: sum(t for k, t in ms.items()
                                if any(kn in k for kn in kernels))
                         for p, kernels in c.PHASES.items()}
                k2.append('N=%d phase A %.4f ms  phase B %.4f ms  max err / '
                          'max |grad| %.3g' % (rows, phase['a'], phase['b'],
                                               err))
            print('%-18s K1 N=8 %.4f ms, N=%d %.4f ms, training form %.4f '
                  'ms, max abs err %.3g  K2 %s' % (
                      name, k1[0], N, k1[1], k1[2], k1_err, '; '.join(k2)),
                  flush=True)
    geese_trunk.cuda_build.load = load
    geese_trunk._LIB = None


if __name__ == '__main__':
    main()
