#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (handyrl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda), and exits
non-zero, printing no result, when either is missing or any phase fails.

1. Prints the card (name and power limit from nvidia-smi), the torch and
   CUDA versions, and builds every CUDA kernel of the port from the
   checkout's sources (one nvcc per source, all started together).
2. Holds each kernel against its plain PyTorch version on the card, fp32
   with TF32 off, at full GeeseNet width (Cin=17, F=32, L=12, 8 groups) on
   real Hungry Geese observations, N in {1, 8, 64, 100}, and times the
   kernel, the plain version and one library yardstick (the port's own
   ``torus_impl='pad'`` trunk: cuDNN convs and torch's group_norm, which
   the kernel path never calls).
3. The main path, through the entry points a user calls: publishes a
   full-width GeeseNet(torus_impl='pallas') with seeded weights into a
   temporary registry, starts ``python -m handyrl_tpu_torch.serving`` on
   the card, plays Hungry Geese games (four geese, each ply's four requests
   coalesced into one batch) through ServiceClient, checks every reply, one
   served policy against a local 'pad' forward of the same weights, and
   the service's kernel launch counts: the service process starts with
   every count at 0, the script reads them just before the games (failing
   unless all are 0) and just after (failing unless each kernel of the
   path launched), then SIGTERMs the service and expects exit 75. The
   comparison launches of phase 2 run in this process and never count.
4. Prints one ``{"kernels": [...]}`` JSON line, the nvidia-smi line, and
   as the last line ``{"ok": true, "device": {...}}``.
"""

import json
import os
import select
import shutil
import signal
import subprocess
import sys
import tempfile
import time

SEED = 20261016
WIDTH = dict(cin=17, filters=32, layers=12, groups=8)
KERNEL_NS = (1, 8, 64, 100)
MAIN_PATH_N = 8          # four geese per ply, padded to the engine's bucket
# Tolerances, fp32 throughout with TF32 off: the kernel, the plain version
# and cuDNN sum the 9 taps and the GroupNorm statistics in different
# orders, and 13 normalised layers carry the difference (about 1e-5 at
# full width); the bounds leave an order of magnitude above that.
TOL = 2e-4               # max abs error of the trunk, kernel vs plain
POLICY_TOL = 1e-4        # served policy and value vs the local 'pad' forward
PEAK_FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
PEAK_SOURCE = 'H100 SXM data sheet at 700 W'


def fail(msg):
    print('chip_smoke: FAIL: %s' % msg, file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail('nvidia-smi failed: %s' % out.stderr.strip())
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(torch, fn, reps):
    """Mean device time of one call of ``fn`` over ``reps`` back-to-back
    calls (CUDA events, after a warm-up)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def game_observations(make_env, count, seed):
    """``count`` real observations from random Hungry Geese play."""
    import random
    rng = random.Random(seed)
    env = make_env({'env': 'HungryGeese', 'id': seed})
    obs = []
    while len(obs) < count:
        if env.terminal():
            env.reset()
        for p in env.turns():
            obs.append(env.observation(p))
        env.step({p: rng.randrange(4) for p in env.turns()})
    return obs[:count]


# ------------------------------------------------------------------ phases

def phase_build(cuda_build):
    nvcc = cuda_build.nvcc_path()
    version = subprocess.run([nvcc, '--version'], capture_output=True,
                             text=True).stdout.strip().splitlines()[-1]
    t0 = time.monotonic()
    built = cuda_build.build()
    log('build: %s (%s): %s in %.2f s wall' % (
        nvcc, version, ', '.join('%s %.2f s' % kv for kv in built.items())
        or 'all libraries current', time.monotonic() - t0))
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log('  %s: %s' % (name, line.strip()))


def trunk_bound_ms(n, cin, filters, layers):
    """Least time for the trunk at batch n: the larger of the 9-tap
    products' FLOPs over the fp32 peak (GroupNorm's ~1% is left out, which
    only lowers the bound) and the bytes read once / written once (input,
    weights, output) over the HBM rate."""
    flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    weights = 9 * cin * filters + layers * 9 * filters * filters \
        + 2 * filters * (layers + 1)
    nbytes = 4 * (n * 77 * cin + weights + n * 77 * filters)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def phase_kernels(torch, geese_trunk, GeeseNet, make_env):
    """K1 against its plain version and the library yardstick."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)
    net = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                   torus_impl='pad', generator=gen)
    with torch.no_grad():   # exercise the norm's scale and bias too
        for p in (net.stem_scale, net.block_scale):
            p.uniform_(0.5, 1.5, generator=gen)
        for p in (net.stem_bias, net.block_bias):
            p.normal_(0.0, 0.1, generator=gen)
    net = net.cuda().eval()
    weights = (net.stem_w, net.stem_scale, net.stem_bias, net.block_w,
               net.block_scale, net.block_bias)
    import numpy as np
    all_obs = np.stack(game_observations(make_env, max(KERNEL_NS), SEED))
    rows = {}
    with torch.no_grad():
        for n in KERNEL_NS:
            obs = torch.from_numpy(all_obs[:n]).cuda()
            x = obs.permute(0, 2, 3, 1).contiguous()     # (N,7,11,17)

            def kernel():
                return geese_trunk.trunk_forward(x, *weights,
                                                 groups=WIDTH['groups'])

            def plain():
                return geese_trunk.trunk_forward_reference(
                    x, *weights, groups=WIDTH['groups'])

            def library():
                return net.trunk(x)

            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            err = (got - ref).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            lib_err = (library() - ref).abs().max().item()
            bound, bound_by, flops, nbytes = trunk_bound_ms(
                n, WIDTH['cin'], WIDTH['filters'], WIDTH['layers'])
            row = {'n': n, 'max_abs_err': err,
                   'ms': cuda_time_ms(torch, kernel, 200),
                   'plain_ms': cuda_time_ms(torch, plain, 20),
                   'library_ms': cuda_time_ms(torch, library, 50),
                   'bound_ms': bound, 'bound_by': bound_by,
                   'flops': flops, 'bytes': nbytes}
            rows[n] = row
            log('geese_trunk N=%-3d max_abs_err %.3g (tol %.0e, pad-trunk '
                'vs plain %.3g)  kernel %.4f ms  plain %.4f ms  library '
                '%.4f ms  bound %.4f ms (%s)  launches so far %d' % (
                    n, err, TOL, lib_err, row['ms'], row['plain_ms'],
                    row['library_ms'], bound, bound_by, geese_trunk.launches))
            if not finite:
                fail('geese_trunk produced non-finite values at N=%d' % n)
            if not err <= TOL:
                fail('geese_trunk disagrees with its plain version at N=%d: '
                     'max abs err %.3g > %.0e' % (n, err, TOL))
    return rows


def read_ready_line(proc, timeout):
    """The service's JSON ready line from its stdout."""
    deadline = time.monotonic() + timeout
    buf = b''
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            fail('the service exited with %s before it was ready'
                 % proc.returncode)
        ready, _, _ = select.select([proc.stdout], [], [], 0.5)
        if not ready:
            continue
        chunk = os.read(proc.stdout.fileno(), 65536)
        buf += chunk
        for line in buf.decode('utf-8', 'replace').splitlines():
            if line.startswith('{') and 'serving_ready' in line:
                return json.loads(line)['serving_ready']
    fail('no ready line from the service within %.0f s' % timeout)


def play_games(client, make_env, sample_seed, np):
    """Four-goose games through the service until two of them reached ten
    plies; every reply is checked. Returns (games, first obs, the seconds
    of each ply's round trip: its requests pipelined, then collected)."""
    OPPOSITE = {0: 1, 1: 0, 2: 3, 3: 2}
    long_games, games, first_obs, ply_s = 0, 0, None, []
    while long_games < 2:
        if games >= 12:
            fail('no two games reached ten plies in 12 games')
        env = make_env({'env': 'HungryGeese', 'id': SEED + games})
        env.reset()
        last, ply = {}, 0
        while not env.terminal() and ply < 60:
            t0 = time.perf_counter()
            rids = {}
            for p in env.turns():
                obs = env.observation(p)
                if first_obs is None:
                    first_obs = obs
                legal = [a for a in range(4) if a != OPPOSITE.get(last.get(p))]
                rids[p] = (client.submit(
                    'default@champion', obs, legal=legal,
                    seed=sample_seed(SEED, (games, p), ply)), legal)
            actions = {}
            for p, (rid, legal) in rids.items():
                rep = client.collect(rid, timeout=120)
                value = np.asarray(rep['value'])
                if rep['action'] not in legal:
                    fail('illegal action %r for legal %s' % (rep['action'],
                                                              legal))
                if not (0.0 < float(rep['prob']) <= 1.0):
                    fail('sampled prob %r out of range' % rep['prob'])
                if value.shape != (1,) or not np.isfinite(value).all():
                    fail('bad value %r' % (rep['value'],))
                if not np.isfinite(np.asarray(rep['action_mask'])).all():
                    fail('non-finite action mask')
                actions[p] = rep['action']
            ply_s.append(time.perf_counter() - t0)
            env.step(actions)
            last.update(actions)
            ply += 1
        games += 1
        long_games += ply >= 10
    return games, first_obs, ply_s


def phase_main_path(torch, repo):
    import numpy as np
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.generation import sample_seed
    from handyrl_tpu_torch.model import ModelWrapper
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.serving.client import ServiceClient
    from handyrl_tpu_torch.serving.registry import ModelRegistry

    net = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                   torus_impl='pallas',
                   generator=torch.Generator().manual_seed(SEED + 1))
    wrapper = ModelWrapper(net, device='cuda')
    tmp = tempfile.mkdtemp(prefix='chip_smoke_')
    proc, client, log_file = None, None, None
    try:
        root = os.path.join(tmp, 'registry')
        ModelRegistry(root).publish('default', snapshot=wrapper.snapshot(),
                                    version=1, promote=True)
        log_path = os.path.join(tmp, 'service.log')
        log_file = open(log_path, 'wb')
        t0 = time.monotonic()
        proc = subprocess.Popen(
            [sys.executable, '-m', 'handyrl_tpu_torch.serving', '--env',
             'HungryGeese', '--registry', root, '--port', '0'],
            cwd=repo, stdout=subprocess.PIPE, stderr=log_file)
        ready = read_ready_line(proc, timeout=300)
        log('service: ready on port %d (%s) after %.1f s' % (
            ready['port'], ready['device'], time.monotonic() - t0))
        if ready['device'] != 'cuda':
            fail('the service runs on %r, not the card' % ready['device'])
        client = ServiceClient('localhost', ready['port'], timeout=120,
                               name='chip_smoke')
        # the service process starts with every kernel count at 0; read
        # them just before the games drive the main path ...
        before = client.status()['kernel_launches']
        if any(before.values()):
            fail('kernel counts before the main path are not 0: %s' % before)
        t0 = time.monotonic()
        games, first_obs, ply_s = play_games(client, make_env, sample_seed,
                                             np)
        played_s = time.monotonic() - t0
        # ... and just after
        status = client.status()
        launches = status['kernel_launches']
        # the first ply also admits the model to the engine's vault
        steady = np.sort(np.asarray(ply_s[1:]))
        log('service: %d games, %d plies in %.2f s; %d requests in %d '
            'batches; kernel launches %s' % (
                games, len(ply_s), played_s, status['engine_requests'],
                status['engine_batches'], launches))
        log('service: ply round trip (4 geese) first %.2f ms; then p50 %.3f '
            'ms, p99 %.3f ms, mean %.3f ms over %d plies (host clock)' % (
                1e3 * ply_s[0], 1e3 * steady[len(steady) // 2],
                1e3 * steady[min(len(steady) - 1,
                                 int(0.99 * len(steady)))],
                1e3 * steady.mean(), len(steady)))
        if not launches.get('geese_trunk', 0) > 0:
            fail('the main path never launched geese_trunk: %s' % launches)
        if status['answered'] != status['received']:
            fail('unanswered requests: %s' % status)

        # one served policy against a local 'pad' forward of the same
        # weights (cuDNN convs, TF32 off)
        served = client.request('default@champion', first_obs)['outputs']
        pad = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                       torus_impl='pad')
        pad.load_state_dict(net.state_dict())
        local = ModelWrapper(pad, device='cuda').inference(first_obs)
        policy_err = float(np.abs(np.asarray(served['policy'])
                                  - local['policy']).max())
        value_err = float(np.abs(np.asarray(served['value'])
                                 - local['value']).max())
        log('service: served policy vs local pad forward: max abs err '
            'policy %.3g value %.3g (tol %.0e)' % (policy_err, value_err,
                                                  POLICY_TOL))
        if not (policy_err <= POLICY_TOL and value_err <= POLICY_TOL):
            fail('served outputs disagree with the local forward')
        client.close()
        client = None

        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fail('the service did not exit within 120 s of SIGTERM')
        log('service: exit %d after SIGTERM' % rc)
        if rc != 75:
            fail('the service exited %d after SIGTERM, expected 75' % rc)
        return launches
    except BaseException:
        if log_file is not None:
            log_file.flush()
            with open(os.path.join(tmp, 'service.log'), 'rb') as f:
                tail = f.read()[-4000:].decode('utf-8', 'replace')
            print('--- service log tail ---\n%s' % tail, file=sys.stderr)
        raise
    finally:
        if client is not None:
            client.close()
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if log_file is not None:
            log_file.close()
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    try:
        import torch
    except ImportError:
        fail('torch is not installed')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is false: this script needs a card')
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, 'handyrl_tpu_torch')):
        fail('handyrl_tpu_torch/ is not beside this script: run it from a '
             'checkout of the repository')
    sys.path.insert(0, repo)
    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops import cuda_build, geese_trunk

    t_start = time.monotonic()
    smi = nvidia_smi_line()
    log('card: %s | torch %s, CUDA %s, %d device(s)' % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    log('== phase 1: build')
    phase_build(cuda_build)

    log('== phase 2: kernels against their plain versions')
    rows = phase_kernels(torch, geese_trunk, GeeseNet, make_env)

    log('== phase 3: main path (serving)')
    launches = phase_main_path(torch, repo)

    main_row = rows[MAIN_PATH_N]
    kernels = [{
        'name': 'geese_trunk', 'route': 'cuda',
        'source': 'handyrl_tpu_torch/csrc/geese_trunk.cu',
        'replaces': 'handyrl_tpu/ops/pallas_geese.py:108',
        'launches': launches['geese_trunk'],
        'max_abs_err': max(r['max_abs_err'] for r in rows.values()),
        'ms': main_row['ms'], 'plain_ms': main_row['plain_ms'],
        'bound_ms': main_row['bound_ms'], 'bound_by': main_row['bound_by'],
        'library_ms': main_row['library_ms'],
        'n': MAIN_PATH_N, 'peaks': PEAK_SOURCE,
        'by_n': {str(n): {k: r[k] for k in ('max_abs_err', 'ms', 'plain_ms',
                                            'library_ms', 'bound_ms')}
                 for n, r in rows.items()},
    }]
    log('total %.1f s' % (time.monotonic() - t_start))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
