#!/usr/bin/env python3
"""Time K2's phases for variants of the trunk kernel source on one NVIDIA
GPU: ``python3 scripts/torch_trunk_variants.py [name=path.cu ...]`` from the
root of a checkout.

The checkout's ``handyrl_tpu_torch/csrc/geese_trunk.cu`` is ``current``;
three variants are derived from it by exact text edits (the script fails if
an edit no longer applies):

- ``no_conv``: phase A without its transposed conv (the grads are wrong;
  the time is that of everything else in the phase);
- ``one_accumulator``: the three 3xTF32 mma of a k-step into one set of
  accumulators instead of two;
- ``rolled_taps``: the conv's tap loop not unrolled.

Further sources may be given as ``name=path``. Every variant is built (one
nvcc each, all at once) into the git-ignored build directory, then each
runs K2 at the update step's shape (N=2048, full GeeseNet width, fp32) on
the same inputs, in the order given and then reversed, printing phase A's
and phase B's device time per call (torch.profiler) and the largest grad
error against the plain version relative to the grad's largest element.
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
}


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
    for name, edits in EDITS.items():
        path = os.path.join(out_dir, name + '.cu')
        with open(path, 'w') as f:
            f.write(derive(text, edits))
        sources[name] = path
    for arg in sys.argv[1:]:
        name, path = arg.split('=', 1)
        sources[name] = os.path.abspath(path)
    for name, path in sources.items():
        cuda_build.SOURCES['variant_' + name] = path
    print(c.nvidia_smi_line(), flush=True)
    cuda_build.build(['variant_' + name for name in sources])
    for name in sources:   # ptxas's line for phase A at F=32
        seen = False
        for line in cuda_build.build_log('variant_' + name).splitlines():
            seen = seen or ('Compiling' in line
                            and 'trunk_bwd_kernelILi32' in line)
            if seen and 'registers' in line:
                print('%-16s phase A (F=32): %s' % (name, line.strip()))
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
        y, acts, xhat, rstd = c.training_forward(torch, geese_trunk, x,
                                                 weights, groups)
        saved = dict(acts=acts, y=y, xhat=xhat, rstd=rstd)
        ref = geese_trunk.trunk_backward_reference(
            x, *weights, dy, groups=groups, need_dx=False, **saved)
        names = list(sources)
        for name in names + names[::-1]:
            geese_trunk.cuda_build.load = \
                lambda _, name=name: load('variant_' + name)
            geese_trunk._LIB = None

            def kernel():
                return geese_trunk.trunk_backward(
                    x, *weights, dy, groups=groups, need_dx=False, **saved)
            got = kernel()
            torch.cuda.synchronize()
            err = max(((g - r).abs().max() / r.abs().max()).item()
                      for g, r in zip(got[1:], ref[1:]))
            ms = c.kernel_ms(torch, kernel, 20)
            phase = {p: sum(t for k, t in ms.items()
                            if any(kn in k for kn in kernels))
                     for p, kernels in c.PHASES.items()}
            print('%-16s phase A %.4f ms  phase B %.4f ms  max err / max '
                  '|grad| %.3g' % (name, phase['a'], phase['b'], err),
                  flush=True)
    geese_trunk.cuda_build.load = load
    geese_trunk._LIB = None


if __name__ == '__main__':
    main()
