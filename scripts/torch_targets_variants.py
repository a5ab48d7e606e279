#!/usr/bin/env python3
"""Time K3-K5 (TD(lambda), UPGO, V-Trace) for several sources of the target
kernels on one NVIDIA GPU: ``python3 scripts/torch_targets_variants.py
[name=path.cu ...]`` from the root of a checkout.

The checkout's ``handyrl_tpu_torch/csrc/targets.cu`` is ``current``; further
sources are given as ``name=path``, for example another commit's
``targets.cu`` unpacked with ``git archive`` into a git-ignored directory.
Every source is built (one nvcc each, all at once) into the git-ignored
build directory and called through its own C interface: a source whose
functions take the bootstrap row's strides (``g_sb``) reads it in place
from the one-row returns; an older one takes a contiguous (B, 1, P, 1) copy,
made outside the timed region. Then, in the order given and then reversed,
each kernel of each source runs at every (T, P, N lanes) of chip_smoke.py's
phase 2 (B = N / P rows, the same seeded operands for every source): its
largest error against the plain version (it fails above chip_smoke.py's
TARGET_TOL), and its device time per launch by CUDA-graph replay of 100
launches (CUDA events), beside the byte bound.
Prints the card (nvidia-smi) first, then one line per source and shape.
"""

import ctypes
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, 'handyrl_tpu_torch', 'csrc', 'targets.cu')
GAMMA = 0.99
REPS = 100


def bind(lib, strided):
    p, i, f, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    g = [p, ll, ll] if strided else [p]
    lib.targets_lambda.argtypes = [p] + g + [p] * 4 + [i] * 4 + [f, p]
    lib.targets_vtrace.argtypes = [p] + g + [p] * 6 + [i] * 3 + [f, p]
    lib.targets_lambda.restype = lib.targets_vtrace.restype = i
    return lib


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('torch_targets_variants: no CUDA device')
    sys.path.insert(0, REPO)
    import numpy as np
    import chip_smoke as c
    from handyrl_tpu_torch.ops import cuda_build, targets

    sources = {'current': SOURCE}
    for arg in sys.argv[1:]:
        if '=' not in arg:
            sys.exit('torch_targets_variants: give sources as name=path.cu')
        name, path = arg.split('=', 1)
        sources[name] = os.path.abspath(path)
    for name, path in sources.items():
        cuda_build.SOURCES['targets_variant_' + name] = path
    print(c.nvidia_smi_line(), flush=True)
    cuda_build.build(['targets_variant_' + n for n in sources])
    libs = {}
    for name, path in sources.items():
        with open(path) as f:
            strided = 'g_sb' in f.read()
        libs[name] = (bind(cuda_build.load('targets_variant_' + name),
                           strided), strided)

    cases = []
    for T in c.TARGET_TS:
        for P in c.TARGET_PS:
            for n in c.TARGET_NS:
                B = n // P
                rng = np.random.RandomState(c.SEED + 7 * n + 3 * T + P)
                shape = (B, T, P, 1)

                def arr(a):
                    return torch.from_numpy(a.astype(np.float32)).cuda()
                ops = dict(v=arr(rng.uniform(-1, 1, shape)),
                           g=arr(np.sign(rng.randn(B, 1, P, 1))),
                           rew=arr(0.1 * rng.randn(*shape)),
                           lam=arr(0.95 + 0.05 * (rng.rand(*shape) < 0.2)),
                           rho=arr(rng.uniform(0, 1, shape)),
                           c=arr(rng.uniform(0, 1, shape)))
                cases.append((T, P, n, B, ops))
    names = list(sources)
    for name in names + names[::-1]:
        lib, strided = libs[name]
        for T, P, n, B, o in cases:
            out = [torch.empty_like(o['v']) for _ in range(2)]
            g = ([o['g'].data_ptr(), o['g'].stride(0), o['g'].stride(2)]
                 if strided else [o['g'].contiguous().data_ptr()])
            for kind in ('td_lambda', 'upgo', 'vtrace'):
                def launch():
                    stream = torch.cuda.current_stream().cuda_stream
                    if kind == 'vtrace':
                        err = lib.targets_vtrace(
                            o['v'].data_ptr(), *g, o['rew'].data_ptr(),
                            o['lam'].data_ptr(), o['rho'].data_ptr(),
                            o['c'].data_ptr(), out[0].data_ptr(),
                            out[1].data_ptr(), B, T, P, GAMMA, stream)
                    else:
                        err = lib.targets_lambda(
                            o['v'].data_ptr(), *g, o['rew'].data_ptr(),
                            o['lam'].data_ptr(), out[0].data_ptr(),
                            out[1].data_ptr(), B, T, P,
                            int(kind == 'upgo'), GAMMA, stream)
                    if err:
                        sys.exit('torch_targets_variants: %s %s failed with '
                                 'CUDA error %d' % (name, kind, err))
                launch()
                torch.cuda.synchronize()
                extra = (o['rho'], o['c']) if kind == 'vtrace' else ()
                ref = getattr(targets, kind)(o['v'], o['g'], o['rew'],
                                             o['lam'], GAMMA, *extra)
                err = max((a - r).abs().max().item()
                          for a, r in zip(out, ref))
                if not err <= c.TARGET_TOL:
                    sys.exit('torch_targets_variants: %s %s disagrees with '
                             'the plain version at T=%d P=%d N=%d: %.3g'
                             % (name, kind, T, P, n, err))
                ms = c.graph_time_ms(torch, launch, REPS)
                bound = c.target_bound_ms(kind, T, n)[0]
                print('%-10s %-9s T=%-2d P=%d N=%-4d %.5f ms a launch (graph '
                      'replay)  bound %.6f ms  max abs err %.3g' % (
                          name, kind, T, P, n, ms, bound, err), flush=True)


if __name__ == '__main__':
    main()
