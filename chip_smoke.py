#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (handyrl_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and ``nvcc`` (CUDA_HOME, PATH or /usr/local/cuda), and exits
non-zero, printing no result, when either is missing or any phase fails.

1. Prints the card (name and power limit from nvidia-smi), the torch and
   CUDA versions, and builds every CUDA kernel of the port from the
   checkout's sources (one nvcc per source, all started together). It
   counts the tensor-core instructions (HMMA) in the trunk kernels' SASS
   (``cuobjdump --dump-sass``) and fails unless K1's and K2b's are more
   than 0.
2. Holds each kernel against its plain PyTorch version on the card, fp32
   with TF32 off, and times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call:
   - K1, the trunk forward, at full GeeseNet width (Cin=17, F=32, L=12,
     8 groups) on real Hungry Geese observations, N in {1, 8, 64, 100,
     128, 256, 1024, 2048}, its convs on the tensor cores in 3xTF32 (bounds
     over the TF32 peak), timed with CUDA events back to back (the kernels line's ms) and
     by torch.profiler's device time, which leaves the wrapper's host cost
     out (256 is the learners' generation bucket: 64 envs of four geese;
     128 the fused loop's evaluation ply, 32 envs of four geese; 1024 the
     fused loop's update step, B=64 x T=16);
     the library yardstick is the port's own ``torus_impl='pad'``
     trunk (cuDNN convs and torch's group_norm, which the kernel path never
     calls). At N in {8, 1024, 2048} also its training form, timed beside the
     serving form: the saved block inputs and normalised conv outputs
     (xhat, abs) and per-group rstd (relative) against the plain training
     forward's;
   - K2, the trunk backward, at the same width for N in {8, 64, 1024, 2048},
     from K1's training forward, every grad against the plain version's
     relative to the grad's largest element; the yardstick is torch
     autograd's backward through the 'pad' trunk. Its two phases (K2a,
     trunk_bwd_kernel; K2b, trunk_wgrad_kernel + column_sum, both on the
     tensor cores in 3xTF32) are timed apart by torch.profiler and each
     has its own bound. K2b also has its own plain version (the 13 plain
     weight grads from the same layer inputs and conv-output grads) and
     yardstick: cuDNN's weight grads of the 13 torus convs
     (``torch.nn.grad.conv2d_weight`` on circularly padded NCHW inputs,
     padded outside the timed region), timed by CUDA-graph replay;
   - K1 and K2 at the other width they are built for, F=16 (2 blocks,
     N=64), for correctness only, K1's saved tensors included;
   - K3-K5, the TD(lambda), UPGO and V-Trace recursions, at T in {1, 16},
     P in {1, 4} and N lanes (N = B*P) in {16, 64, 100, 128, 2048}, with
     one-row returns (the outcome, whose bootstrap row the kernels read in
     place): (T=16, P=1, N=128) is the headline step's and the row the
     kernels line reports, 16 the in-process steps', 64 the fused loop's
     (B=64, T=16, P=1), 100 a ragged edge; and (T=16, P=2, N=256), the
     turn-based step's of phase 7 (B=128, two players);
     each timed by CUDA-graph replay (device time) and through its
     wrapper; no single PyTorch call computes a recursion, so they have no
     yardstick.
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
4. The training path, through its entry point: runs
   ``python -m handyrl_tpu_torch.bench --device cuda`` (the headline
   update step, B=128, T=16, full width, TD/TD, eager and as one CUDA
   graph; a fresh process whose counts start at 0 and are set to 0 again
   before its first step), reads its JSON line and fails unless the losses
   are finite, both forms were timed and K1, K2 and K3 launched once a
   step in each form. Then, in this process, for TD/TD and for
   UPGO/VTRACE (which must launch K4 and K5) at B=16 on real boards, with
   every count set to 0 just before each form: three eager steps and five
   graphed ones on the card; the first of each is held against the same
   step of the port on the CPU (same weights, same batch: loss terms, grad
   norm, params and Adam's first moment by leaf), the graphed steps
   against the eager ones step by step, and the graph's fourth step, with
   a NaN lr, must keep params, moments and count, report nonfinite 1 and
   advance steps, and its fifth must train. Last, torch.profiler over
   headline steps of each form (graph replays for the graphed one): the
   device busy time, the host-clock step and the idle share, and K1, K2a,
   K2b and K3 each once a step in the device rows, or it fails.
5. The local learner, through its entry point: writes the slice's JSON
   config (full-width GeeseNet, ``torus_impl='pallas'``, B=128, T=16,
   TD/TD, 64 generation envs, 256 episodes before the first epoch and
   512 an epoch (about 100 update steps an epoch at 256), 3 epochs, online
   evaluation against 'random') into a temporary directory and runs
   ``python -m handyrl_tpu_torch.train --config ... --device cuda`` (a
   fresh process, every count at 0). Fails unless it exits 0 having
   trained 3 epochs with finite losses, wrote every checkpoint with its CRC
   sidecar, changed the params between ``1.ckpt`` and the last one, and
   launched K1 in generation and evaluation (serving form) and K1, K2 and
   K3 in training once a step (the capture's eager warm-up steps
   included). Then loads ``latest.ckpt`` on the card and on the CPU and
   holds the card's forward to the CPU's on real boards (POLICY_TOL), and
   prints the learner's rates beside the bench's graphed step.
6. The fused device loop, through the same entry point with no --device
   (the card is the default): the JAX package's north-star configuration
   (full-width GeeseNet, B=64, T=16, VTRACE/VTRACE, 64 generation envs,
   32-ply chunks, 32 eval envs, 64 SGD steps a chunk, 200 episodes before
   the first epoch and 100 an epoch, checkpoint files every 10 epochs,
   ``metrics_jsonl``), FUSED_EPOCHS epochs (60-120 s). Fails unless it
   exits 0 having run the fused pipeline in solo mode and closed every
   epoch, wrote the checkpoints of epochs 10, 20, ... and the last (and no
   other) with their CRC sidecars, wrote one metrics row an epoch with
   the run plane's keys (METRICS_KEYS in every row, each of
   METRICS_SOME_KEYS in some, steps monotonic), took steps = fused
   dispatches x 64,
   launched K1 under 'generation' and 'evaluation' (serving form) and K1,
   K2 and K5 under 'training' once a step (no warm-up steps: a graph's
   first call runs eagerly, as a real step), moved every leaf from
   ``10.ckpt`` to the last, and ``latest.ckpt``'s forward on the card
   matches the CPU's (POLICY_TOL). Then, in this process: the env twin's
   step, auto-reset, observation, greedy agent and outcome on the card
   against the CPU on the same state, actions and uniforms (equal
   exactly); the ingest of two chunks' card records with the same draws
   into a ring they wrap (equal exactly); three steps of the K-step update
   graph (eager, captured, replayed) against the CPU's step from the same
   state on the slots the card drew (phase 4's tolerances), and two
   replays drawing different slots; two replays of the rollout graph
   drawing different actions; one steady fused dispatch under
   torch.profiler (device busy time, idle share, top kernels, and K1, K2a,
   K2b and K5 as often as its graphs hold them). Prints the loop's rates
   beside phase 5's host learner, and its host seconds by stage, the
   epoch close split into the wait for the in-flight dispatch before a
   checkpoint and the checkpoint's copies and files.
7. The README's quick start, through both entry points with no --device:
   ``python -m handyrl_tpu_torch.train --config`` on ``tictactoe.json``
   (config.yaml's blocks: turn-based TicTacToe on the full-width
   SimpleConv2dModel, TD/TD, B=128, T=16, 64 envs, 400 episodes then 200
   an epoch), cut to QUICK_EPOCHS epochs. Fails unless every epoch ran
   with finite losses, every checkpoint passes ``verify_checkpoint``, the
   params moved from ``1.ckpt`` to the last, K3 launched once a step plus
   the capture's warm-ups under 'training' (at T=16, P=2, 256 lanes) and
   no other kernel anywhere, ``latest.ckpt``'s forward on the card matches
   the CPU's (POLICY_TOL), and tests/test_train_e2e.py's learning bar holds
   (at least 80 evaluation results over the last 5 epochs, a win rate
   above 0.6 against 'random'). Then ``python -m
   handyrl_tpu_torch.evaluation latest.ckpt 100 4`` must count all 100
   games for both agents in its report, played in 4 spawned processes.
   Prints the rates, the steps per epoch, K3's time at 256 lanes, the
   tournament's seconds and the main agent's win rate.
8. Phase 6's run, read on. (a) ``scripts/torch_eval_checkpoints.py``
   scores its checkpoints of epoch 10 and of the last in a fresh process
   (counts from 0 at the first point): 512 games a point against
   'random', one evaluator and one captured rollout graph for both
   points. Fails unless K1 (serving form) launched under 'evaluation' and
   nothing else did, one rollout graph was captured, and the last point's
   win rate is at least 0.95 and not below epoch 10's. (b) A preemption
   drill: the learner resumes the model dir (``restart_epoch: -1``, 6
   more epochs, ``keep_checkpoints: 3``) and gets SIGTERM once its first
   metrics row lands. Fails unless it exits 75 printing ``preempted:
   checkpoint flushed``, ``trainer_state.ckpt`` verifies, one
   ``preempted`` row holds the flushed steps, the restart exits 0 naming
   the flushed epoch in its ``auto-resume`` line and warms its ring up
   again before it trains, the rows' steps are monotonic with unique
   epoch rows to the end, and only the newest 3 numbered checkpoints
   remain.
9. Prints one ``{"kernels": [...]}`` JSON line (K1, K2a, K2b, K3-K5; K2a
   and K2b take their launches from K2's count, one of each a call; the
   fused loop's under ``learner_fused_*``, the quick start's under
   ``quick_start_*``, the scorer's under ``score_*``), the nvidia-smi
   line, and as the last line ``{"ok": true, "device": {...}}``.
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
KERNEL_NS = (1, 8, 64, 100, 128, 256, 1024, 2048)
MAIN_PATH_N = 8          # four geese per ply, padded to the engine's bucket
TRAIN_N = 2048           # B*T*P of the headline update step
BWD_NS = (8, 64, 1024, 2048)
TARGET_TS, TARGET_PS = (1, 16), (1, 4)
TARGET_NS = (16, 64, 100, 128, 2048)   # lanes B*P
TARGET_PATH = (16, 1, 128)  # (T, P, lanes) of the headline step's targets
STEP_B = 16              # the in-process card-vs-CPU update step
# Tolerances, fp32 throughout with TF32 off: the kernel, the plain version
# and cuDNN sum the 9 taps and the GroupNorm statistics in different
# orders, and 13 normalised layers carry the difference (about 1e-5 at
# full width); the bounds leave an order of magnitude above that.
TOL = 2e-4               # max abs error of the trunk, kernel vs plain
POLICY_TOL = 1e-4        # served policy and value vs the local 'pad' forward
# K2: each grad's max abs error over its largest element. The kernel and
# the plain version sum the weight grads over N*77 pixels and the
# GroupNorm statistics in other orders; 1e-6 of the largest element is
# what that gives at full width, the bound leaves two orders above it.
BWD_TOL = 1e-4
# K3-K5: fp32 recursions of 16 steps on O(1) inputs; the kernel fuses
# multiply-adds the plain version rounds twice (about 1e-6 seen).
TARGET_TOL = 1e-4
# The update step on the card against the same step on the CPU (fp32 sums in
# other orders): each loss term within STEP_RTOL of the larger of |total|,
# |v| and 1 (p and ent are sums of terms of both signs, near 0 on this
# batch, so their own size is no scale); the pre-clip grad norm within
# STEP_NORM_RTOL of itself; the parameter update within 2 lr everywhere
# (Adam's first step is g / (|g| + 1e-8): an element whose grad rounds
# across 0 may move the other way) and within STEP_UPDATE_RTOL of the
# CPU's update in L2 norm. Those see the update's sign more than its size,
# so Adam's first moment after the step (0.1 x the clipped, decayed grad) is
# also held leaf by leaf: its max abs difference over the CPU's largest
# element of that leaf within STEP_MU_RTOL.
STEP_RTOL = 1e-4
STEP_NORM_RTOL = 1e-3
STEP_UPDATE_RTOL = 1e-2
STEP_MU_RTOL = 1e-3
# The graphed step against the eager step on the card, over 3 steps: the
# same kernels and ops in the same order, so equality is expected (the log
# says whether it held bit for bit). Should cuBLAS pick another algorithm
# for the heads' products under capture, their fp32 sums reassociate: the
# bounds are then those of tests/test_torch_train_step.py for fp32
# reassociation of this step: params within lr / 10 (Adam turns a grad near
# 1e-8 into a step of up to lr), Adam's moments within 1e-4 of each leaf's
# largest element, metrics within 1e-4 of max(|value|, 1). Count and steps
# are integers and must be equal.
GRAPH_PARAM_ATOL = 1e-6   # lr / 10 at the bench's lr of 1e-5
GRAPH_MOMENT_RTOL = 1e-4
GRAPH_METRIC_RTOL = 1e-4
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12     # H100 SXM HBM3
PEAK_SOURCE = 'H100 SXM data sheet at 700 W'
# K1's saved normalised conv outputs (abs, as the trunk's output) and
# per-group rstd (relative: rstd is 1/std of conv outputs of any size)
RSTD_RTOL = 1e-4
SAVED_NS = (8, 1024, 2048)  # the serving bucket, the fused loop's and the
                            # update step's rows


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


def graph_time_ms(torch, fn, reps):
    """Device time of one call of ``fn``: ``reps`` calls captured in one
    CUDA graph and replayed, timed with CUDA events. For kernels that take
    less time on the card than their wrapper takes on the host, where
    :func:`cuda_time_ms` would time the host."""
    fn()
    torch.cuda.synchronize()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # warm up off the default stream
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(e):
    return getattr(e, 'self_device_time_total',
                   getattr(e, 'self_cuda_time_total', 0)) or 0


def kernel_ms(torch, fn, reps):
    """Device time of each kernel ``fn`` launches, per call of ``fn``, by
    kernel name: torch.profiler over ``reps`` calls after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: device_us(e) / 1e3 / reps for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and device_us(e) > 0}


def training_forward(torch, geese_trunk, x, weights, groups):
    """K1's training form: (y, acts, xhat, rstd) on the card."""
    saved = geese_trunk.training_buffers(x.shape[0], weights[3].shape[0],
                                         weights[0].shape[-1], groups,
                                         x.device)
    y = geese_trunk.trunk_forward(x, *weights, groups=groups, **saved)
    return y, saved['acts'], saved['xhat'], saved['rstd']


def saved_errors(torch, geese_trunk, x, weights, groups):
    """K1's training form against the plain training forward on the same
    input: max abs error of y, acts and xhat, and rstd's max relative
    error."""
    got = training_forward(torch, geese_trunk, x, weights, groups)
    torch.cuda.synchronize()
    ref = [torch.empty_like(t) for t in got[1:]]
    y = geese_trunk.trunk_forward_reference(x, *weights, groups=groups,
                                            acts=ref[0], xhat=ref[1],
                                            rstd=ref[2])
    for name, t in zip(('y', 'acts', 'xhat', 'rstd'), got):
        if not bool(torch.isfinite(t).all().item()):
            fail('geese_trunk training form: non-finite %s' % name)
    err = {name: (g - r).abs().max().item()
           for name, g, r in zip(('y', 'acts', 'xhat'), got, [y] + ref[:2])}
    err['rstd_rel'] = ((got[3] - ref[2]).abs() / ref[2].abs()).max().item()
    return err


def check_saved(err, what):
    log('%s: K1 training form vs plain: max abs err y %.3g, acts %.3g, xhat '
        '%.3g (tol %.0e); rstd max rel err %.3g (tol %.0e)' % (
            what, err['y'], err['acts'], err['xhat'], TOL, err['rstd_rel'],
            RSTD_RTOL))
    if not (max(err['y'], err['acts'], err['xhat']) <= TOL
            and err['rstd_rel'] <= RSTD_RTOL):
        fail('%s: K1\'s saved tensors disagree with the plain training '
             'forward' % what)


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
    cuobjdump = os.path.join(os.path.dirname(nvcc), 'cuobjdump')
    hmma = sass_hmma_counts(cuobjdump,
                            cuda_build.library_path('geese_trunk'))
    for kernel, count in sorted(hmma.items()):
        log('  SASS of %s: %d HMMA instructions' % (kernel, count))
    for name, kernel in (('K1', 'trunk_fwd_kernel'),
                         ('K2b', 'trunk_wgrad_kernel')):
        counts = {k: c for k, c in hmma.items() if k.startswith(kernel)}
        if not counts or not all(counts.values()):
            fail('%s (%s) does not run on the tensor cores: HMMA counts %s'
                 % (name, kernel, counts))
    return hmma


def sass_hmma_counts(cuobjdump, library):
    """The tensor-core mma instructions (HMMA) in the SASS of each trunk
    kernel in ``library``, by kernel and width: {'trunk_fwd_kernel<32>':
    count, ...}."""
    import re
    out = subprocess.run([cuobjdump, '--dump-sass', library],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        fail('cuobjdump failed on %s: %s' % (library, out.stderr.strip()))
    counts, kernel = {}, None
    for line in out.stdout.splitlines():
        if 'Function : ' in line:
            m = re.search(r'(trunk_[a-z]+_kernel)ILi(\d+)E', line)
            kernel = '%s<%s>' % m.groups() if m else None
            if kernel:
                counts[kernel] = 0
        elif kernel and 'HMMA' in line:
            counts[kernel] += 1
    return counts


def trunk_bound_ms(n, cin, filters, layers, groups, training=False):
    """Least time for K1 at batch n: the larger of its operations over the
    peak of the units it runs on and its bytes (read once / written once)
    over the HBM rate. The 9-tap products run on the tensor cores in
    3xTF32, three TF32 products per fp32 multiply-add, over the TF32 peak
    (GroupNorm's ~1% is left out, which only lowers the bound); the bytes
    are the input, the weights and the output, and in the training form
    (``training``) also what it saves for K2: acts, xhat and rstd."""
    flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    weights = 9 * cin * filters + layers * 9 * filters * filters \
        + 2 * filters * (layers + 1)
    nbytes = 4 * (n * 77 * cin + weights + n * 77 * filters)
    if training:
        nbytes += 4 * n * (layers * 77 * filters
                           + (layers + 1) * (77 * filters + groups))
    t_ops, t_bytes = 3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops >= t_bytes else 'bytes', flops, nbytes)


def trunk_net(torch, GeeseNet):
    """A full-width 'pad' GeeseNet on the card with seeded weights, the
    norm's scale and bias random too, and its trunk operands."""
    gen = torch.Generator().manual_seed(SEED)
    net = GeeseNet(filters=WIDTH['filters'], layers=WIDTH['layers'],
                   torus_impl='pad', generator=gen)
    with torch.no_grad():   # exercise the norm's scale and bias too
        for p in (net.stem_scale, net.block_scale):
            p.uniform_(0.5, 1.5, generator=gen)
        for p in (net.stem_bias, net.block_bias):
            p.normal_(0.0, 0.1, generator=gen)
    net = net.cuda().eval()
    return net, (net.stem_w, net.stem_scale, net.stem_bias, net.block_w,
                 net.block_scale, net.block_bias)


def phase_kernels(torch, geese_trunk, GeeseNet, make_env):
    """K1 against its plain version and the library yardstick."""
    from handyrl_tpu_torch.ops import kernel_launches
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    net, weights = trunk_net(torch, GeeseNet)
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
                n, WIDTH['cin'], WIDTH['filters'], WIDTH['layers'],
                WIDTH['groups'])
            row = {'n': n, 'max_abs_err': err,
                   'ms': cuda_time_ms(torch, kernel, 200),
                   'device_ms': sum(
                       t for k, t in kernel_ms(torch, kernel, 20).items()
                       if 'trunk_fwd_kernel' in k),
                   'plain_ms': cuda_time_ms(torch, plain, 20),
                   'library_ms': cuda_time_ms(torch, library, 50),
                   'bound_ms': bound, 'bound_by': bound_by,
                   'flops': flops, 'bytes': nbytes}
            rows[n] = row
            log('geese_trunk N=%-3d max_abs_err %.3g (tol %.0e, pad-trunk '
                'vs plain %.3g)  kernel %.4f ms (%.4f ms on the card by the '
                'profiler)  plain %.4f ms  library %.4f ms  bound %.4f ms '
                '(%s)  launches so far %d' % (
                    n, err, TOL, lib_err, row['ms'], row['device_ms'],
                    row['plain_ms'], row['library_ms'], bound, bound_by,
                    kernel_launches()['geese_trunk']))
            if not finite:
                fail('geese_trunk produced non-finite values at N=%d' % n)
            if not err <= TOL:
                fail('geese_trunk disagrees with its plain version at N=%d: '
                     'max abs err %.3g > %.0e' % (n, err, TOL))
            if n in SAVED_NS:
                # the training form: also acts, xhat and rstd for K2
                check_saved(saved_errors(torch, geese_trunk, x, weights,
                                         WIDTH['groups']), 'N=%d' % n)
                row['train_ms'] = cuda_time_ms(torch, lambda: training_forward(
                    torch, geese_trunk, x, weights, WIDTH['groups']), 50)
                tb, tb_by, _, tbytes = trunk_bound_ms(
                    n, WIDTH['cin'], WIDTH['filters'], WIDTH['layers'],
                    WIDTH['groups'], training=True)
                row['train_bound_ms'] = tb
                log('geese_trunk N=%-3d training form %.4f ms (serving form '
                    '%.4f ms), bound %.4f ms (%s; %.4g GFLOP as 3xTF32, %.4g '
                    'MB)' % (n, row['train_ms'], row['ms'], tb, tb_by,
                             flops / 1e9, tbytes / 1e6))
    return rows


def bwd_bounds_ms(n, cin, filters, layers, groups):
    """Least times for K2's two phases at batch n as the update step calls
    it (no dx), each the larger of its operations over the peak of the
    units it runs on and its bytes (inputs read once, outputs written once)
    over the HBM rate. Phase A (trunk_bwd_kernel): the blocks' transposed
    convs in 3xTF32 on the tensor cores, three TF32 products per fp32
    multiply-add, over the TF32 peak; it reads xhat, rstd, acts (the ReLU
    masks), y, dy and the weights and writes dc and the scale and bias
    grads. Phase B (trunk_wgrad_kernel + column_sum): the weight products,
    also in 3xTF32 over the TF32 peak; it reads x, acts, dc and the scale
    and bias grads and writes the grads. Returns {phase: (ms, bound_by,
    flops, bytes)}."""
    nl = layers + 1
    weights = 9 * cin * filters + layers * 9 * filters * filters
    grads = weights + 2 * filters * nl
    px = 77 * filters
    a_flops = n * 2 * 77 * 9 * layers * filters * filters
    a_bytes = 4 * (n * (nl * px + nl * groups + layers * px + 2 * px
                        + nl * px + nl * 2 * filters) + weights + 2 * nl * filters)
    b_flops = n * 2 * 77 * 9 * (cin * filters + layers * filters * filters)
    b_bytes = 4 * (n * (77 * cin + layers * px + nl * px + nl * 2 * filters)
                   + grads)
    out = {}
    for phase, t_ops, flops, nbytes in (
            ('a', 3 * a_flops / PEAK_TF32_FLOPS, a_flops, a_bytes),
            ('b', 3 * b_flops / PEAK_TF32_FLOPS, b_flops, b_bytes)):
        t_bytes = nbytes / PEAK_BYTES
        out[phase] = (1e3 * max(t_ops, t_bytes),
                      'operations' if t_ops >= t_bytes else 'bytes', flops,
                      nbytes)
    return out


PHASES = {'a': ('trunk_bwd_kernel',), 'b': ('trunk_wgrad_kernel',
                                             'column_sum')}


def layer_inputs_and_dc(geese_trunk, x, weights, dy, groups, saved):
    """What K2b reads: each layer's input (x, then each block's) and its
    conv-output grad dc, from the plain backward's steps on the training
    forward's saved tensors."""
    stem_w, stem_scale, _, block_w, block_scale, _ = weights
    layers = block_w.shape[0]
    inputs = [x] + [saved['acts'][:, i] for i in range(layers)]
    outs = inputs[1:] + [saved['y']]
    ws, scales = [stem_w] + list(block_w), [stem_scale] + list(block_scale)
    dh, dcs = dy, [None] * (layers + 1)
    for l in range(layers, -1, -1):
        g = dh * (outs[l] > 0)
        dcs[l] = geese_trunk._group_norm_backward(
            g, saved['xhat'][:, l], saved['rstd'][:, l], scales[l],
            groups)[0]
        if l > 0:
            dh = g + geese_trunk._conv_transpose(dcs[l], ws[l])
    return inputs, dcs


def wgrad_yardsticks(torch, geese_trunk, inputs, dcs, ref_w):
    """K2b's plain version (the 13 plain weight grads) and cuDNN's weight
    grads of the same 13 torus convs (fp32, TF32 off), each checked against
    the plain backward's weight grads ``ref_w`` and timed: the plain
    version with CUDA events, cuDNN by CUDA-graph replay (the wrapper's
    host cost would hide it). The circular padding and NCHW copies are
    made before the timed region. Returns (plain ms, cuDNN ms, cuDNN's max
    error over each grad's largest element)."""
    import torch.nn.functional as F
    torch.backends.cudnn.allow_tf32 = False
    padded = [F.pad(h.permute(0, 3, 1, 2).contiguous(), (1, 1, 1, 1),
                    mode='circular') for h in inputs]
    dcs_nchw = [d.permute(0, 3, 1, 2).contiguous() for d in dcs]
    sizes = [(d.shape[-1], h.shape[-1], 3, 3) for h, d in zip(inputs, dcs)]

    def plain():
        return [geese_trunk._conv_weight_grad(h, d)
                for h, d in zip(inputs, dcs)]

    def library():
        return [torch.nn.grad.conv2d_weight(p, size, d)
                for p, size, d in zip(padded, sizes, dcs_nchw)]

    got = library()
    err = max(((g.permute(2, 3, 1, 0) - r).abs().max() / r.abs().max()).item()
              for g, r in zip(got, ref_w))
    return (cuda_time_ms(torch, plain, 5), graph_time_ms(torch, library, 20),
            err)


def phase_backward(torch, geese_trunk, GeeseNet, make_env):
    """K2 against its plain version and torch autograd's backward through
    the 'pad' trunk; each phase timed by the profiler."""
    import numpy as np
    net, weights = trunk_net(torch, GeeseNet)
    all_obs = np.stack(game_observations(make_env, max(BWD_NS), SEED + 2))
    gen = torch.Generator().manual_seed(SEED + 3)
    names = ('dx', 'd_stem_w', 'd_stem_scale', 'd_stem_bias', 'd_block_w',
             'd_block_scale', 'd_block_bias')
    L, F, G = WIDTH['layers'], WIDTH['filters'], WIDTH['groups']
    rows = {}
    for n in BWD_NS:
        x = torch.from_numpy(all_obs[:n]).cuda().permute(0, 2, 3, 1) \
            .contiguous()
        dy = torch.randn(n, 7, 11, F, generator=gen).cuda()
        with torch.no_grad():
            y, acts, xhat, rstd = training_forward(torch, geese_trunk, x,
                                                   weights, G)
            saved = dict(acts=acts, y=y, xhat=xhat, rstd=rstd)

            def kernel(need_dx=False):
                return geese_trunk.trunk_backward(
                    x, *weights, dy, groups=G, need_dx=need_dx, **saved)

            def plain():
                return geese_trunk.trunk_backward_reference(
                    x, *weights, dy, groups=G, need_dx=False, **saved)

            got = kernel(need_dx=True)
            torch.cuda.synchronize()
            ref = geese_trunk.trunk_backward_reference(x, *weights, dy,
                                                       groups=G, **saved)
            errs = {}
            for name, g, r in zip(names, got, ref):
                if not bool(torch.isfinite(g).all().item()):
                    fail('geese_trunk_bwd: non-finite %s at N=%d' % (name, n))
                errs[name] = ((g - r).abs().max() / r.abs().max()).item()
            ms = cuda_time_ms(torch, kernel, 20)
            plain_ms = cuda_time_ms(torch, plain, 5)
            by_kernel = kernel_ms(torch, kernel, 10)
            inputs, dcs = layer_inputs_and_dc(geese_trunk, x, weights, dy, G,
                                              saved)
            b_plain_ms, b_library_ms, b_library_err = wgrad_yardsticks(
                torch, geese_trunk, inputs, dcs, [ref[1]] + list(ref[4]))
            del inputs, dcs
        # the yardstick: autograd through the cuDNN trunk, backward only
        with torch.enable_grad():
            yp = net.trunk(x)
            library_ms = cuda_time_ms(torch, lambda: torch.autograd.grad(
                yp, weights, dy, retain_graph=True), 5)
        del yp
        err = max(errs.values())
        bounds = bwd_bounds_ms(n, WIDTH['cin'], F, L, G)
        row = {'n': n, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
               'library_ms': library_ms}
        for phase, kernels in PHASES.items():
            times = [t for k, t in by_kernel.items()
                     if any(name in k for name in kernels)]
            if len(times) != len(kernels):
                fail('the profiler shows %d of K2 phase %s\'s kernels %s: %s'
                     % (len(times), phase, kernels, sorted(by_kernel)))
            bound, bound_by, flops, nbytes = bounds[phase]
            row[phase] = {'ms': sum(times), 'bound_ms': bound,
                          'bound_by': bound_by, 'flops': flops,
                          'bytes': nbytes}
        row['b'].update(plain_ms=b_plain_ms, library_ms=b_library_ms,
                        library_err=b_library_err)
        rows[n] = row
        log('geese_trunk_bwd N=%-4d max err / max |grad| %.3g (tol %.0e; %s)'
            '  kernel %.4f ms  plain %.4f ms  library %.4f ms' % (
                n, err, BWD_TOL, ', '.join('%s %.2g' % kv for kv in
                                           errs.items()), ms, plain_ms,
                library_ms))
        for phase, kernels in PHASES.items():
            r = row[phase]
            log('  phase %s (%s) %.4f ms a call (profiler), bound %.4f ms '
                '(%s; %.4g GFLOP, %.4g MB)' % (
                    phase, ' + '.join(kernels), r['ms'], r['bound_ms'],
                    r['bound_by'], r['flops'] / 1e9, r['bytes'] / 1e6))
        b = row['b']
        log('  phase b: plain weight grads %.4f ms; cuDNN weight grads of the '
            '13 convs %.4f ms (CUDA-graph replay; max err / max |grad| %.3g '
            'against the plain version) beside the kernel\'s %.4f ms' % (
                b['plain_ms'], b['library_ms'], b['library_err'], b['ms']))
        if not err <= BWD_TOL:
            fail('geese_trunk_bwd disagrees with its plain version at N=%d'
                 % n)
        if not b['library_err'] <= BWD_TOL:
            fail('cuDNN\'s weight grads disagree with the plain version at '
                 'N=%d: the yardstick computes another function' % n)
    return rows


def phase_narrow(torch, geese_trunk, n=64, filters=16, layers=2):
    """K1 and K2 at the kernels' other width, F=16 (no main path runs it
    yet), against their plain versions; correctness only."""
    gen = torch.Generator().manual_seed(SEED + 5)

    def rand(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=gen)).cuda()
    cin, groups = WIDTH['cin'], min(8, filters)
    weights = (rand(3, 3, cin, filters, scale=(9 * cin) ** -0.5),
               rand(filters, scale=0.2, shift=1.0), rand(filters, scale=0.1),
               rand(layers, 3, 3, filters, filters,
                    scale=(9 * filters) ** -0.5),
               rand(layers, filters, scale=0.2, shift=1.0),
               rand(layers, filters, scale=0.1))
    x, dy = rand(n, 7, 11, cin), rand(n, 7, 11, filters)
    with torch.no_grad():
        check_saved(saved_errors(torch, geese_trunk, x, weights, groups),
                    'F=%d L=%d N=%d' % (filters, layers, n))
        y, acts, xhat, rstd = training_forward(torch, geese_trunk, x,
                                               weights, groups)
        saved = dict(acts=acts, y=y, xhat=xhat, rstd=rstd)
        y_err = (y - geese_trunk.trunk_forward_reference(
            x, *weights, groups=groups)).abs().max().item()
        got = geese_trunk.trunk_backward(x, *weights, dy, groups=groups,
                                         **saved)
        ref = geese_trunk.trunk_backward_reference(x, *weights, dy,
                                                   groups=groups, **saved)
        g_err = max(((g - r).abs().max() / r.abs().max()).item()
                    for g, r in zip(got, ref))
    log('F=%d L=%d N=%d: geese_trunk max_abs_err %.3g (tol %.0e), '
        'geese_trunk_bwd max err / max |grad| %.3g (tol %.0e)' % (
            filters, layers, n, y_err, TOL, g_err, BWD_TOL))
    if not (y_err <= TOL and g_err <= BWD_TOL):
        fail('the F=%d kernels disagree with their plain versions' % filters)


def target_bound_ms(kind, T, n):
    """Least time for K3-K5 at (T, n): bytes only (a few flops a step):
    values, rewards, lambda (and rhos, cs for V-Trace) read once, the
    bootstrap row, targets and advantages written once."""
    reads = 5 if kind == 'vtrace' else 3
    nbytes = 4 * ((reads + 2) * T * n + n)
    return 1e3 * nbytes / PEAK_BYTES, 'bytes', nbytes


def phase_targets(torch, targets):
    """K3-K5 against their plain versions at every (T, P, N) of TARGET_TS,
    TARGET_PS and TARGET_NS (B = N / P rows), each timed by graph replay
    (the kernel's device time) and through the wrapper, beside the plain
    version's time and the byte bound. ``returns`` is the outcome, one row
    a trajectory, whose bootstrap row the kernels read in place."""
    import numpy as np
    rows = {}
    for T in TARGET_TS:
        for P in TARGET_PS:
            for n in TARGET_NS:
                rows.update(target_rows(torch, targets, np, T, P, n))
    # the turn-based step's (phase 7): two players, B=128
    rows.update(target_rows(torch, targets, np, *QUICK_TARGETS))
    return rows


def target_rows(torch, targets, np, T, P, n):
    B = n // P
    rng = np.random.RandomState(SEED + 7 * n + 3 * T + P)
    shape = (B, T, P, 1)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).cuda()
    values = arr(rng.uniform(-1, 1, shape))
    returns = arr(np.sign(rng.randn(B, 1, P, 1)))
    rewards = arr(0.1 * rng.randn(*shape))
    lam = arr(0.95 + 0.05 * (rng.rand(*shape) < 0.2))
    rhos = arr(rng.uniform(0, 1, shape))
    cs = arr(rng.uniform(0, 1, shape))
    rows = {}
    for kind in ('td_lambda', 'upgo', 'vtrace'):
        args = (values, returns, rewards, lam, 0.99) + (
            (rhos, cs) if kind == 'vtrace' else ())
        kernel = getattr(targets, kind + '_kernel')
        plain = getattr(targets, kind)
        got, ref = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        finite = all(bool(torch.isfinite(g).all().item()) for g in got)
        ms = graph_time_ms(torch, lambda: kernel(*args), 100)
        call_ms = cuda_time_ms(torch, lambda: kernel(*args), 200)
        plain_ms = cuda_time_ms(torch, lambda: plain(*args), 20)
        bound, bound_by, nbytes = target_bound_ms(kind, T, n)
        rows[(kind, T, P, n)] = {
            'n': n, 'T': T, 'P': P, 'max_abs_err': err, 'ms': ms,
            'call_ms': call_ms, 'plain_ms': plain_ms, 'library_ms': None,
            'bound_ms': bound, 'bound_by': bound_by, 'bytes': nbytes}
        log('%-9s T=%-2d P=%d N=%-4d max_abs_err %.3g (tol %.0e)  kernel '
            '%.4f ms on the card (graph replay; %.4f ms a call through the '
            'wrapper)  plain %.4f ms  bound %.6f ms (bytes)' % (
                kind, T, P, n, err, TARGET_TOL, ms, call_ms, plain_ms,
                bound))
        if not finite or not err <= TARGET_TOL:
            fail('%s disagrees with its plain version at T=%d P=%d N=%d'
                 % (kind, T, P, n))
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


def run_bench_entry(repo):
    """``python -m handyrl_tpu_torch.bench --device cuda``: its one JSON
    line, checked: finite losses, both forms timed, and K1, K2 and K3
    launched once a step in each form (the graphed form's steps include
    the eager warm-up steps of its capture)."""
    import math
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.bench', '--device', 'cuda'],
        cwd=repo, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail('the bench entry exited %d:\n%s' % (proc.returncode,
                                                 proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('the bench entry printed %d JSON lines' % len(lines))
    line = json.loads(lines[0])
    launches, steps = line['kernel_launches'], line['steps_run']
    log('bench: graphed step %.3f ms (%.1f trajectories/s), eager step %.3f '
        'ms, over %d timed steps each (host clock, %s, %s); the graphed '
        'form\'s first call (%d eager warm-up steps and the capture) %.1f ms; '
        'peak memory %s MiB; %.1f s in all; losses %s; grad norm %.4g; '
        'steps %s; kernel launches %s' % (
            line['step_ms'], line['value'], line['eager_step_ms'],
            line['timed_steps'], line['device'], line['compute_dtype'],
            line['steps_by_form']['graphed']['capture_warmup'],
            line['graph_first_call_ms'], line['peak_memory_mib'],
            time.monotonic() - t0, line['losses'], line['grad_norm'],
            line['steps_by_form'], line['kernel_launches_by_form']))
    if line['form'] != 'graphed' or not line['eager_step_ms'] > 0:
        fail('the bench entry did not time both forms: %s' % line)
    if not all(math.isfinite(v) for v in line['losses'].values()):
        fail('the bench entry reports non-finite losses: %s' % line['losses'])
    if line['nonfinite'] != 0:
        fail('the bench entry hit the non-finite guard')
    for form, counts in line['kernel_launches_by_form'].items():
        run = line['steps_by_form'][form]['run']
        for name in ('geese_trunk', 'geese_trunk_bwd', 'td_lambda'):
            if counts[name] != run:
                fail('the bench entry\'s %s form launched %s %d times in %d '
                     'steps' % (form, name, counts[name], run))
    if sum(line['steps_by_form'][f]['run'] for f in ('eager', 'graphed')) \
            != steps:
        fail('the bench entry\'s steps do not add up: %s' % line)
    return line


def card_steps(torch, device, policy_target, value_target, obs, lrs,
               graphed=False):
    """Headline update steps at B=STEP_B on ``device``, one for each lr in
    ``lrs`` (floats; NaN drives the guard), from the seeded weights and
    batch of the bench entry with ``obs`` (B, T, 1, 17, 7, 11) for its
    observations; eager (``build_update_step``) or, with ``graphed``, as
    the CUDA graph (``build_graphed_update_step``). Returns the params
    before the first step and, after each step, a dict of the params,
    Adam's moments (mu, nu) and count, steps and the metrics, on the CPU."""
    from handyrl_tpu_torch import bench
    from handyrl_tpu_torch.ops.train_step import (build_graphed_update_step,
                                                  build_update_step)
    net, cfg, batch, state = bench.headline_setup(
        device, B=STEP_B, policy_target=policy_target,
        value_target=value_target)
    batch['observation'] = torch.from_numpy(obs).to(device)

    def cpu(d):
        return {k: v.detach().cpu().clone() for k, v in d.items()}
    before = cpu(state.params)
    if graphed:
        step = build_graphed_update_step(net, cfg, state)
    else:
        update = build_update_step(net, cfg)
    after = []
    for lr in lrs:
        lr = torch.tensor(lr, device=device)
        if graphed:
            metrics = step(batch, lr)
            state = step.state
        else:
            state, metrics = update(state, batch, lr)
        after.append({'params': cpu(state.params),
                      'mu': cpu(state.opt_state.mu),
                      'nu': cpu(state.opt_state.nu),
                      'count': int(state.opt_state.count),
                      'steps': int(state.steps),
                      'metrics': {k: float(v) for k, v in metrics.items()}})
    return before, after


def check_against_cpu(label, old, card, cpu, lr=None):
    """One update step on the card (``card``, from params ``old``) against
    the same step on the CPU, under the STEP_* tolerances (the params' at
    2 lr; lr defaults to the bench's)."""
    from handyrl_tpu_torch.bench import LR
    LR = LR if lr is None else lr
    m, cm = card['metrics'], cpu['metrics']
    new, cpu_new, mu, cpu_mu = (card['params'], cpu['params'], card['mu'],
                                cpu['mu'])
    terms = ('total', 'p', 'v', 'ent', 'diag_grad_norm', 'data_count')
    scale = max(abs(cm['total']), abs(cm['v']), 1.0)
    errs = {k: abs(m[k] - cm[k]) / scale / STEP_RTOL
            for k in ('total', 'p', 'v', 'ent')}
    errs['diag_grad_norm'] = (abs(m['diag_grad_norm'] - cm['diag_grad_norm'])
                              / max(cm['diag_grad_norm'], 1e-30)
                              / STEP_NORM_RTOL)
    errs['data_count'] = abs(m['data_count'] - cm['data_count'])
    step_max = max((new[k] - cpu_new[k]).abs().max().item() for k in new)
    diff = sum(((new[k] - cpu_new[k]) ** 2).sum().item() for k in new)
    upd = sum(((cpu_new[k] - old[k]) ** 2).sum().item() for k in new)
    update_rel = (diff / upd) ** 0.5
    mu_rel = {k: ((mu[k] - cpu_mu[k]).abs().max()
                  / cpu_mu[k].abs().max().clamp_min(1e-30)).item()
              for k in mu}
    mu_worst = sorted(mu_rel.items(), key=lambda kv: -kv[1])
    log('%s card vs CPU: %s; params max abs diff %.3g (tol 2 lr = %.0e), '
        'update L2 rel diff %.3g (tol %.0e); nonfinite %g' % (
            label, ', '.join('%s %.6g/%.6g' % (k, m[k], cm[k])
                             for k in terms),
            step_max, 2 * LR, update_rel, STEP_UPDATE_RTOL, m['nonfinite']))
    log('%s card vs CPU: Adam mu max abs diff / max |mu| by leaf, worst '
        'first (tol %.0e): %s' % (label, STEP_MU_RTOL, ', '.join(
            '%s %.3g' % kv for kv in mu_worst)))
    if m['nonfinite'] or cm['nonfinite']:
        fail('the %s step hit the non-finite guard' % label)
    bad = [k for k, e in errs.items() if not e <= 1]
    if bad:
        fail('the %s step on the card disagrees with the CPU in %s'
             % (label, bad))
    if not (step_max <= 2 * LR and update_rel <= STEP_UPDATE_RTOL):
        fail('the %s step on the card moves the params unlike the CPU'
             % label)
    if not mu_worst[0][1] <= STEP_MU_RTOL:
        fail('the %s step on the card gives Adam moments unlike the CPU in %s'
             % (label, [k for k, e in mu_worst if not e <= STEP_MU_RTOL]))
    if not cm['diag_grad_norm'] > 0:
        fail('the %s step has no gradient to compare' % label)


def check_graphed_against_eager(label, graphed, eager):
    """The graphed steps against the eager ones, step by step: count and
    steps equal, the rest within the GRAPH_* tolerances (see above);
    returns the largest differences seen."""
    worst = {'params': 0.0, 'moments': 0.0, 'metrics': 0.0}
    for i, (g, e) in enumerate(zip(graphed, eager)):
        if (g['count'], g['steps']) != (e['count'], e['steps']):
            fail('%s step %d: graphed count/steps %s, eager %s' % (
                label, i, (g['count'], g['steps']), (e['count'], e['steps'])))
        worst['params'] = max([worst['params']] + [
            (g['params'][k] - e['params'][k]).abs().max().item()
            for k in e['params']])
        worst['moments'] = max([worst['moments']] + [
            ((g[m][k] - e[m][k]).abs().max()
             / e[m][k].abs().max().clamp_min(1e-30)).item()
            for m in ('mu', 'nu') for k in e[m]])
        worst['metrics'] = max([worst['metrics']] + [
            abs(g['metrics'][k] - e['metrics'][k])
            / max(abs(e['metrics'][k]), 1.0) for k in e['metrics']])
        if set(g['metrics']) != set(e['metrics']):
            fail('%s: the graphed step reports other metrics' % label)
    equal = all(all(torch_equal(g[m], e[m]) for m in ('params', 'mu', 'nu'))
                and g['metrics'] == e['metrics']
                for g, e in zip(graphed, eager))
    log('%s: graphed vs eager over %d steps on the card: %s; params max abs '
        'diff %.3g (tol %.0e), mu/nu max diff / max |leaf| %.3g (tol %.0e), '
        'metrics max rel diff %.3g (tol %.0e)' % (
            label, len(eager), 'equal bit for bit' if equal else 'not equal',
            worst['params'], GRAPH_PARAM_ATOL, worst['moments'],
            GRAPH_MOMENT_RTOL, worst['metrics'], GRAPH_METRIC_RTOL))
    if not (worst['params'] <= GRAPH_PARAM_ATOL
            and worst['moments'] <= GRAPH_MOMENT_RTOL
            and worst['metrics'] <= GRAPH_METRIC_RTOL):
        fail('%s: the graphed step disagrees with the eager step' % label)
    return dict(worst, equal=equal)


def torch_equal(a, b):
    return all(bool((a[k] == b[k]).all()) for k in a)


def check_guard(label, good, nan, after):
    """A graphed step with a NaN lr (``nan``, after ``good``) keeps params,
    moments and count, reports nonfinite 1 and advances steps; the next
    step (``after``) with a finite lr trains."""
    kept = (torch_equal(nan['params'], good['params'])
            and torch_equal(nan['mu'], good['mu'])
            and torch_equal(nan['nu'], good['nu'])
            and nan['count'] == good['count'])
    trained = (not any(bool((after['params'][k] == nan['params'][k]).all())
                       for k in nan['params'])
               and after['count'] == nan['count'] + 1
               and after['metrics']['nonfinite'] == 0)
    log('%s: graphed step with lr NaN: state kept %s, nonfinite %g, steps '
        '%d -> %d; the next step with a finite lr trains: %s (count %d -> '
        '%d)' % (label, kept, nan['metrics']['nonfinite'], good['steps'],
                 nan['steps'], trained, nan['count'], after['count']))
    if not (kept and nan['metrics']['nonfinite'] == 1
            and nan['steps'] == good['steps'] + 1 and trained):
        fail('%s: the non-finite guard in the graph misbehaves' % label)


def phase_training(torch, repo, make_env):
    import numpy as np
    from handyrl_tpu_torch.bench import LR
    from handyrl_tpu_torch.ops import kernel_launches, reset_kernel_launches
    out = {'bench': run_bench_entry(repo), 'paths': {}}
    out['paths']['bench'] = out['bench']['kernel_launches']
    # the bench's uniform-noise planes saturate the full-width net (tanh
    # values of exactly +-1, logits in the hundreds: every grad is 0), so
    # the card-vs-CPU step runs on real boards, where the grads are not
    obs = np.stack(game_observations(make_env, STEP_B * 16, SEED + 4))
    obs = obs.reshape(STEP_B, 16, 1, 17, 7, 11)
    nan = float('nan')
    for pt, vt, path in (('TD', 'TD', ('geese_trunk', 'geese_trunk_bwd',
                                        'td_lambda')),
                         ('UPGO', 'VTRACE', ('geese_trunk', 'geese_trunk_bwd',
                                             'upgo', 'vtrace'))):
        label = '%s/%s B=%d' % (pt, vt, STEP_B)
        _, cpu = card_steps(torch, 'cpu', pt, vt, obs, (LR,))
        runs = {}
        for form, lrs in (('eager', (LR,) * 3),
                          ('graphed', (LR,) * 3 + (nan, LR))):
            reset_kernel_launches()
            runs[form] = card_steps(torch, 'cuda', pt, vt, obs, lrs,
                                    graphed=form == 'graphed')
            torch.cuda.synchronize()
            launches = kernel_launches()
            out['paths']['%s_%s_%s' % (form, pt, vt)] = launches
            log('step %s %s on the card: %d steps, kernel launches %s' % (
                label, form, len(lrs), launches))
            missing = [k for k in path if launches[k] < 1]
            if missing:
                fail('the %s %s step never launched %s' % (label, form,
                                                           missing))
            old, after = runs[form]
            check_against_cpu('step %s %s' % (label, form), old, after[0],
                              cpu[0])
        graphed = runs['graphed'][1]
        out[(pt, vt)] = check_graphed_against_eager(
            'step ' + label, graphed[:3], runs['eager'][1])
        check_guard('step ' + label, graphed[2], graphed[3], graphed[4])
    out['profile'] = {form: profile_step(torch, form)
                      for form in ('eager', 'graphed')}
    return out


# the kernels that must show once a step in the profiled window, by the
# name the profiler gives them
PROFILED = ('trunk_fwd_kernel', 'trunk_bwd_kernel', 'trunk_wgrad_kernel',
            'lambda_kernel')


def profile_step(torch, form, steps=5):
    """Device time by kernel over ``steps`` headline update steps (B=128,
    T=16) of ``form`` ('eager' or 'graphed': replays of the step's CUDA
    graph) under torch.profiler, and the device's busy share of the window
    (the profiler's own host cost lengthens the window, so the idle share
    is an upper bound). One step under the profiler's warm-up comes first
    and is not recorded: without it the trace missed the window's first
    kernel launches (it listed K1 with 4 of its 5). Fails unless each of
    PROFILED shows once a step in the device rows (of a second window when
    the first lost a record): for the graphed form that is the proof that
    replays run the kernels."""
    from handyrl_tpu_torch import bench
    from handyrl_tpu_torch.ops.train_step import (build_graphed_update_step,
                                                  build_update_step)
    net, cfg, batch, state = bench.headline_setup('cuda')
    lr = torch.tensor(bench.LR, device='cuda')
    if form == 'graphed':
        graphed = build_graphed_update_step(net, cfg, state)

        def step():
            graphed(batch, lr)
    else:
        update = build_update_step(net, cfg)
        holder = [state]

        def step():
            holder[0], _ = update(holder[0], batch, lr)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    result = profile_window(torch, form, step, steps)
    if result is None:
        # a window can lose a record: of 8 windows profiled on an H100, one
        # (of the eager step) listed K1 4 times in 5 steps while the
        # wrapper counted 5. A second window must show each kernel once a
        # step.
        log('profile %s: a second window' % form)
        result = profile_window(torch, form, step, steps)
    if result is None:
        fail('profile %s: kernels not once a step in the device rows of two '
             'windows of %d steps' % (form, steps))
    return result


def profile_window(torch, form, step, steps):
    """One profiled window of ``steps`` calls of ``step``: the summary, or
    None when a kernel of PROFILED is not in it once a step."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=steps,
                                   repeat=1)) as prof:
        step()   # the warm-up step
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for i in range(steps):
            step()
            if i == steps - 1:
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t0)
            prof.step()   # the last one closes the recorded window

    # the kernels' own rows (the host ops' rows repeat their kernels' time,
    # and so does the schedule's ProfilerStep row)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not events:
        fail('profile %s: the profiler shows no kernel on the card (CUPTI '
             'saw no device activity)' % form)
    rows = sorted(((device_us(e) / 1e3 / steps, e.count / steps, e.key)
                   for e in events if not e.key.startswith('ProfilerStep')),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    step_ms = wall_ms / steps
    launches = sum(r[1] for r in rows)
    log('profile %s: %d steps, %.3f ms a step on the host clock (profiled), '
        'device busy %.3f ms a step (%.1f%%, idle %.1f%%), %g kernel '
        'launches a step of %d kernels' % (
            form, steps, step_ms, busy, 100 * busy / step_ms,
            100 - 100 * busy / step_ms, launches, len(rows)))
    for ms, count, key in rows[:10]:
        log('  %8.4f ms a step  %6.2f launches a step  %s' % (ms, count,
                                                               key[:90]))
    counts = {name: sum(e.count for e in events
                        if re.search(r'\b%s[<(]' % name, e.key))
              for name in PROFILED}
    log('profile %s: launches in the window of %d steps: %s' % (
        form, steps, counts))
    if any(c != steps for c in counts.values()):
        return None
    return {'step_ms_profiled': step_ms, 'device_busy_ms': busy,
            'idle_share': 1 - busy / step_ms,
            'launches_per_step': launches, 'launches_in_window': counts,
            'top': [{'kernel': k[:120], 'ms_per_step': ms,
                     'launches_per_step': c} for ms, c, k in rows[:10]]}


# the learner phase's config: the update step of the bench (B=128, T=16,
# TD/TD, gamma 0.99, solo training with observations) fed by batched
# self-play of 64 Hungry Geese envs on the full-width GeeseNet's kernels
LEARNER_EPOCHS = 3
LEARNER_CONFIG = {
    'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
    'train_args': {
        'turn_based_training': False, 'observation': True, 'gamma': 0.99,
        'forward_steps': 16, 'compress_steps': 4, 'batch_size': 128,
        'policy_target': 'TD', 'value_target': 'TD',
        'generation_envs': 64, 'num_batchers': 2,
        'minimum_episodes': 256, 'update_episodes': 512,
        'epochs': LEARNER_EPOCHS, 'eval': {'opponent': ['random']},
        'seed': SEED},
}
LEARNER_FILES = ['%d.ckpt' % e for e in range(1, LEARNER_EPOCHS + 1)] + [
    'latest.ckpt', 'trainer_state.ckpt']


def run_learner_entry(repo, tmp):
    """``python -m handyrl_tpu_torch.train --config ... --device cuda`` on
    LEARNER_CONFIG: its JSON line and the wall time of the process."""
    cfg = json.loads(json.dumps(LEARNER_CONFIG))
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    path = os.path.join(tmp, 'learner.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path, '--device', 'cuda'],
            cwd=repo, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the learner did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    for line in proc.stdout.splitlines():
        if line.startswith(('epoch', 'win rate', 'generation stats', 'loss',
                            'updated model')):
            log('  learner: %s' % line)
    if proc.returncode != 0:
        fail('the learner exited %d:\n%s' % (proc.returncode,
                                             proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('the learner printed %d JSON lines' % len(lines))
    return json.loads(lines[0]), wall


def phase_learner(torch, repo, make_env, bench_line):
    import math
    import numpy as np
    from handyrl_tpu_torch.evaluation import load_model
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    tmp = tempfile.mkdtemp(prefix='chip_smoke_learner_')
    try:
        line, wall = run_learner_entry(repo, tmp)
        models = os.path.join(tmp, 'models')
        log('learner: %s' % json.dumps(line))
        if line['epochs'] != LEARNER_EPOCHS or line['failed']:
            fail('the learner trained %s epochs (failed %s)'
                 % (line['epochs'], line['failed_reason']))
        for name in LEARNER_FILES:
            ok, reason = verify_checkpoint(os.path.join(models, name))
            if not ok or reason != 'ok':
                fail('learner checkpoint %s: %s' % (name, reason))
        if not (line['losses'] and all(math.isfinite(v)
                                       for v in line['losses'].values())):
            fail('the learner reports non-finite losses: %s'
                 % line['losses'])
        env = make_env(LEARNER_CONFIG['env_args'])
        _, from_flax = param_trees(env.net())

        def params(name):
            with open(os.path.join(models, name), 'rb') as f:
                return from_flax(flax_msgpack.from_bytes(f.read()))
        first, last = params('1.ckpt'), params('%d.ckpt' % LEARNER_EPOCHS)
        moved = {k: (last[k] - first[k]).abs().max().item() for k in first}
        log('learner: params max abs change from 1.ckpt to %d.ckpt by leaf: '
            '%s' % (LEARNER_EPOCHS, ', '.join('%s %.3g' % kv
                                              for kv in moved.items())))
        if not any(v > 0 for v in moved.values()):
            fail('the learner\'s params did not change after epoch 1')
        by_path = line['kernel_launches']
        gen, ev = by_path.get('generation', {}), by_path.get('evaluation', {})
        train = by_path.get('training', {})
        runs = line['steps_at_exit'] + GRAPH_WARMUP_STEPS
        log('learner: kernel launches by path %s; %d update steps (and %d '
            'eager warm-up steps of the capture)' % (
                by_path, line['steps_at_exit'], GRAPH_WARMUP_STEPS))
        if not (gen.get('geese_trunk', 0) > 0 and ev.get('geese_trunk', 0) > 0):
            fail('the learner\'s generation or evaluation never launched K1')
        if any(p.get(k, 0) for p in (gen, ev)
               for k in ('geese_trunk_bwd', 'td_lambda', 'upgo', 'vtrace')):
            fail('generation or evaluation launched a training kernel')
        for name in ('geese_trunk', 'geese_trunk_bwd', 'td_lambda'):
            if train.get(name) != runs:
                fail('the learner\'s training launched %s %s times in %d '
                     'steps' % (name, train.get(name), runs))

        # latest.ckpt on the card against the CPU, on real boards
        obs = np.stack(game_observations(make_env, 64, SEED + 5))
        card = load_model(os.path.join(models, 'latest.ckpt'), env, 'cuda')
        cpu = load_model(os.path.join(models, 'latest.ckpt'), env, 'cpu')
        got, want = card.batch_inference(obs), cpu.batch_inference(obs)
        err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        log('learner: latest.ckpt forward on the card vs the CPU over %d '
            'real boards: max abs err %s (tol %.0e)' % (
                len(obs), err, POLICY_TOL))
        if not all(np.isfinite(got[k]).all() for k in got) or \
                max(err.values()) > POLICY_TOL:
            fail('the learner\'s checkpoint computes other outputs on the '
                 'card than on the CPU')
        log('learner: %.1f episodes/s generated, %.2f update steps/s, %.1f '
            'trajectories/s trained (bench graphed step alone: %.1f), epochs '
            '%s s, peak memory %.1f MiB, %.1f s process wall (%s)' % (
                line['episodes_per_s'], line['update_steps_per_s'],
                line['trajectories_per_s'], bench_line['value'],
                ['%.2f' % t for t in line['epoch_seconds']],
                line['peak_memory_mib'], wall, nvidia_smi_line()))
        return line
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------- phase 6: fused loop

# the fused device loop at the JAX package's north-star configuration
# (scripts/run_north_star.py:36-50): full-width GeeseNet, B=64, T=16,
# VTRACE/VTRACE, 64 generation envs, 32-ply chunks, 32 eval envs, 64 SGD
# steps a chunk; 200 episodes before the first epoch and 100 an epoch,
# checkpoint files every 10 epochs and at the last, a metrics row an epoch
FUSED_EPOCHS = 170
FUSED_K = 64
FUSED_INTERVAL = 10
FUSED_CONFIG = {
    'env_args': {'env': 'HungryGeese', 'torus_impl': 'pallas'},
    'train_args': {
        'turn_based_training': False, 'observation': True, 'gamma': 0.99,
        'forward_steps': 16, 'batch_size': 64,
        'policy_target': 'VTRACE', 'value_target': 'VTRACE',
        'generation_envs': 64, 'device_generation': True,
        'device_replay': True, 'device_chunk_steps': 32, 'eval_envs': 32,
        'sgd_steps_per_chunk': FUSED_K, 'minimum_episodes': 200,
        'update_episodes': 100, 'epochs': FUSED_EPOCHS,
        'checkpoint_interval': FUSED_INTERVAL,
        'eval': {'opponent': ['random']},
        'seed': SEED},
}
FUSED_PATHS = {'generation': ('geese_trunk',),
               'evaluation': ('geese_trunk',),
               'training': ('geese_trunk', 'geese_trunk_bwd', 'vtrace')}
FUSED_PROFILED = {'trunk_fwd_kernel': 'chunk + K', 'trunk_bwd_kernel': 'K',
                  'trunk_wgrad_kernel': 'K', 'vtrace_kernel': 'K'}
# every fused metrics row (handyrl_tpu/train.py:2378-2496, without the
# planes the port lacks), and the keys of rows of epochs that had results
METRICS_KEYS = ('epoch', 'steps', 'episodes', 'time', 'run_id', 'telemetry',
                'sgd_steps_per_sec', 'buffer', 'replay_dropped_episodes',
                'replay_ring_occupancy', 'replay_sample_reuse',
                'guard_nonfinite', 'guard_rollbacks', 'guard_bad_episodes',
                'dispatches_gen', 'dispatches_eval')
METRICS_SOME_KEYS = ('generation_mean', 'win_rate', 'eval_opponents',
                     'win_rate_recent10', 'eval_games_recent10')
INGEST_PLIES = 64        # the card-vs-CPU ingest: two chunks' plies
INGEST_CAPACITY = 32     # into a ring that they wrap


def run_fused_entry(repo, tmp):
    """``python -m handyrl_tpu_torch.train --config ...`` (no --device: the
    card is the default) on FUSED_CONFIG, its rows to ``metrics.jsonl``:
    its JSON line and its wall."""
    cfg = json.loads(json.dumps(FUSED_CONFIG))
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    cfg['train_args']['metrics_jsonl'] = os.path.join(tmp, 'metrics.jsonl')
    path = os.path.join(tmp, 'fused.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path], cwd=repo, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the fused learner did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    out = proc.stdout.splitlines()
    if 'fused device pipeline' not in proc.stdout or \
            '(solo mode)' not in proc.stdout:
        fail('the learner did not run the fused device pipeline:\n%s'
             % proc.stdout[-2000:])
    epochs = [i for i, l in enumerate(out) if l.startswith('epoch ')]
    for i in epochs[:2] + epochs[-2:]:
        for line in out[i:i + 5]:
            if line.startswith(('epoch', 'win rate', 'generation stats',
                                'loss', 'updated model')):
                log('  fused: %s' % line)
    if proc.returncode != 0:
        fail('the fused learner exited %d:\n%s' % (proc.returncode,
                                                   proc.stderr[-4000:]))
    lines = [l for l in out if l.startswith('{')]
    if len(lines) != 1:
        fail('the fused learner printed %d JSON lines' % len(lines))
    return json.loads(lines[0]), wall


def fused_env_checks(torch):
    """The env twin's step, observe, greedy agent and auto-reset on the card
    against the CPU, on a state reached by 40 random plies of 64 games,
    with the same actions and uniforms: equal exactly, every field."""
    from handyrl_tpu_torch.envs import torch_hungry_geese as tg
    gen = torch.Generator().manual_seed(SEED + 11)
    state = tg.init_state(64, generator=gen)
    for _ in range(40):
        acts = torch.randint(0, 4, (64, 4), generator=gen)
        state = tg.step(state, acts, generator=gen)
        state = tg.auto_reset(state, tg.terminal(state), generator=gen)
    acts = torch.randint(0, 4, (64, 4), generator=gen)
    u_food = torch.rand((64, tg.N_FOOD), generator=gen)
    u_greedy = torch.rand((64, 4), generator=gen)
    u_reset = torch.rand((64, tg.N_CELLS), generator=gen)

    def run(dev):
        st = tg.State(*[t.to(dev) for t in state])
        nxt = tg.step(st, acts.to(dev), u=u_food.to(dev))
        out = {'step.' + k: v for k, v in nxt._asdict().items()}
        done = tg.terminal(nxt)
        reset = tg.auto_reset(nxt, done, u=u_reset.to(dev))
        out.update({'reset.' + k: v for k, v in reset._asdict().items()})
        out['observe'] = tg.observe(st)
        out['greedy'] = tg.greedy_action(st, u=u_greedy.to(dev))
        out['outcome'] = tg.outcome(nxt)
        out['terminal'] = done
        return {k: v.cpu() for k, v in out.items()}

    card, cpu = run('cuda'), run('cpu')
    bad = [k for k in cpu if not torch.equal(card[k], cpu[k])]
    log('fused: env step/auto_reset/observe/greedy_action/outcome on the '
        'card vs the CPU, 64 games after 40 plies: %d fields, unequal %s'
        % (len(cpu), bad))
    if bad:
        fail('the env twin computes other values on the card than on the '
             'CPU in %s' % bad)


def fused_setup(torch, capacity=None):
    """An in-process fused pipeline at FUSED_CONFIG's widths on the card:
    (pipeline, update step, env module, args)."""
    from handyrl_tpu_torch.config import apply_defaults
    from handyrl_tpu_torch.envs import torch_hungry_geese as tg
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.ops.device_windows import DeviceWindower
    from handyrl_tpu_torch.ops.fused_pipeline import FusedPipeline
    from handyrl_tpu_torch.ops.replay import ring_capacity, \
        windows_per_episode
    from handyrl_tpu_torch.ops.train_step import ReplayUpdateStep, \
        init_train_state
    from handyrl_tpu_torch.train import loss_config
    args = apply_defaults(FUSED_CONFIG)['train_args']
    net = GeeseNet(torus_impl='pallas',
                   generator=torch.Generator().manual_seed(SEED)).cuda()
    actor = GeeseNet(torus_impl='pallas').cuda()
    actor.load_state_dict(net.state_dict())
    step = ReplayUpdateStep(net, loss_config(args), init_train_state(net))
    windower = DeviceWindower(
        'solo', args['forward_steps'], 0, tg.MAX_STEPS,
        windows_per_episode(args), capacity or ring_capacity(args), 4,
        args['gamma'], False)
    fp = FusedPipeline(tg, actor, step, windower, args['generation_envs'],
                       args['device_chunk_steps'], FUSED_K,
                       args['batch_size'], seed=SEED)
    return fp, step, tg, args


def fused_ingest_and_step_checks(torch, fp, tg, args):
    """Records of INGEST_PLIES plies on the card, ingested on the card and
    on the CPU with the same draws into a ring of INGEST_CAPACITY rows: history, counts,
    ring rows, cursor and size equal exactly. Then three steps of the
    card's step graph (its first eager, then a capture and a replay) on
    that ring, each held against the CPU's step from the card's state with
    the slots the card drew, under phase 4's tolerances; the slots of two
    replays must differ."""
    from handyrl_tpu_torch.ops.device_windows import DeviceWindower
    from handyrl_tpu_torch.ops.train_step import ReplayUpdateStep, \
        TrainState, AdamState
    from handyrl_tpu_torch.models.geese import GeeseNet
    from handyrl_tpu_torch.train import loss_config
    state = tg.State(*[t.clone() for t in fp.state])
    _, records = fp._rollout(state, INGEST_PLIES,
                             torch.Generator('cuda').manual_seed(SEED + 3))
    K, N = records['done'].shape
    W = fp.windower.W
    gen = torch.Generator().manual_seed(SEED + 12)
    draws = {'u': torch.rand((K, N, W), generator=gen),
             'seat': torch.randint(0, 4, (K, N, W), generator=gen)}
    out = {}
    for dev in ('cuda', 'cpu'):
        wd = DeviceWindower('solo', args['forward_steps'], 0, tg.MAX_STEPS,
                            W, INGEST_CAPACITY, 4, args['gamma'], False)
        rec = {k: v.to(dev) for k, v in records.items()}
        ws = wd.init_state(rec)
        ring = wd.init_ring(rec)
        cursor = torch.zeros((), dtype=torch.int64, device=dev)
        size = torch.zeros((), dtype=torch.int64, device=dev)
        n_done, n_win = wd.ingest(rec, ws, ring, cursor, size,
                                  draws={k: v.to(dev)
                                         for k, v in draws.items()})
        out[dev] = dict(ring=ring, cursor=cursor, size=size, ws=ws,
                        n_done=int(n_done), n_win=int(n_win), wd=wd)
    c, h = out['cuda'], out['cpu']
    bad = [k for k in h['ring'] if not torch.equal(
        c['ring'][k][:INGEST_CAPACITY].cpu(), h['ring'][k][:INGEST_CAPACITY])]
    bad += [k for k in h['ws']['hist'] if not torch.equal(
        c['ws']['hist'][k].cpu(), h['ws']['hist'][k])]
    for k in ('cursor', 'size'):
        if int(c[k]) != int(h[k]):
            bad.append(k)
    if not torch.equal(c['ws']['counts'].cpu(), h['ws']['counts']):
        bad.append('counts')
    log('fused: ingest of %d plies of %d envs on the card vs the CPU: '
        '%d episodes, %d windows into %d rows (cursor %d, size %d); unequal '
        '%s' % (K, N, h['n_done'], h['n_win'], INGEST_CAPACITY,
                int(h['cursor']), int(h['size']), bad))
    if bad or (c['n_done'], c['n_win']) != (h['n_done'], h['n_win']):
        fail('the ingest on the card differs from the CPU\'s in %s' % bad)
    if h['n_win'] <= INGEST_CAPACITY:
        fail('the ingest check\'s ring did not wrap')

    cfg = loss_config(args)
    net = GeeseNet(torus_impl='pallas',
                   generator=torch.Generator().manual_seed(SEED + 1))
    from handyrl_tpu_torch.ops.train_step import init_train_state
    card = ReplayUpdateStep(net.cuda(), cfg, init_train_state(net.cuda()))
    host_net = GeeseNet(torus_impl='pallas')
    host = ReplayUpdateStep(host_net, cfg, init_train_state(host_net))
    card.bind(c['ring'], c['wd'].window_spec, c['size'], c['cursor'],
              INGEST_CAPACITY, args['batch_size'],
              torch.Generator('cuda').manual_seed(SEED + 4))
    host.bind(h['ring'], h['wd'].window_spec, h['size'], h['cursor'],
              INGEST_CAPACITY, args['batch_size'], None)
    ema = float(args['batch_size'] * args['forward_steps'])
    lr = 3e-8 * ema

    def snap(st, metrics=None):
        return {'params': {k: v.detach().cpu().clone()
                           for k, v in st.state.params.items()},
                'mu': {k: v.cpu().clone()
                       for k, v in st.state.opt_state.mu.items()},
                'state': TrainState(
                    params={k: v.detach().cpu().clone()
                            for k, v in st.state.params.items()},
                    opt_state=AdamState(
                        count=st.state.opt_state.count.cpu().clone(),
                        mu={k: v.cpu().clone()
                            for k, v in st.state.opt_state.mu.items()},
                        nu={k: v.cpu().clone()
                            for k, v in st.state.opt_state.nu.items()}),
                    steps=st.state.steps.cpu().clone()),
                'metrics': metrics}

    slots_seen = []
    for i in range(3):
        before = snap(card)
        m = card.unpack(card.run(1, ema))
        torch.cuda.synchronize()
        slots = card.last_slots.cpu().clone()
        slots_seen.append(slots)
        host.load_state(before['state'])
        hm = host.unpack(host.run(1, ema, slots=slots[None]))
        after = snap(card, {k: float(v) for k, v in m.items()})
        cpu_after = snap(host, {k: float(v) for k, v in hm.items()})
        check_against_cpu('fused K-step update, step %d (%s)' % (
            i + 1, ('eager', 'captured and replayed', 'replayed')[i]),
            before['params'], after, cpu_after, lr=lr)
    if torch.equal(slots_seen[1], slots_seen[2]):
        fail('two replays of the step graph drew the same slots')
    log('fused: the step graph\'s replays drew different slots (%d of %d '
        'differ)' % (int((slots_seen[1] != slots_seen[2]).sum()),
                     slots_seen[1].numel()))


def fused_profile(torch, fp, args):
    """Replays of the chunk graph draw new actions; then one steady fused
    dispatch (chunk + ingest + K steps, graphs captured already) under
    torch.profiler: its device busy time, the host-clock dispatch, the
    idle share and the top kernels; each kernel of FUSED_PROFILED in the
    device rows as often as the dispatch launches it (of a second window
    when the first lost a record)."""
    for _ in range(2):   # the chunk graph: eager, then captured + replayed
        fp.warm_step()
    # two more warm-up dispatches: two replays of one graph
    fp.warm_step()
    a1 = fp._chunk._out['action'].clone()
    fp.warm_step()
    a2 = fp._chunk._out['action'].clone()
    differ = int((a1 != a2).sum())
    log('fused: two replays of the rollout graph: %d of %d actions differ'
        % (differ, a1.numel()))
    if differ == 0:
        fail('two replays of the rollout graph drew the same actions')
    ema = float(args['batch_size'] * args['forward_steps'])
    for _ in range(3):   # the step graph: eager, capture, replay
        fp.train_step(ema)
    torch.cuda.synchronize()
    # the two parts of a dispatch apart, by CUDA events over 3 calls each
    parts = {}
    for name, fn in (('chunk', fp._chunk),
                     ('steps', lambda: fp.update_step.run(FUSED_K, ema))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            fn()
        end.record()
        torch.cuda.synchronize()
        parts[name] = start.elapsed_time(end) / 3
    log('fused: the chunk graph (%d plies of %d envs and their ingest) %.3f '
        'ms a call; %d replays of the step graph %.3f ms (%.4f ms a step); '
        'CUDA events' % (args['device_chunk_steps'], args['generation_envs'],
                         parts['chunk'], FUSED_K, parts['steps'],
                         parts['steps'] / FUSED_K))
    result = fused_profile_window(torch, fp, args, ema)
    if result is None:
        # a window can lose records, as phase 4's profile_step found: one of
        # three steady dispatches profiled on an H100 listed K2a and K2b 63
        # times in 64 steps. A second window must show every launch.
        log('fused profile: a second window')
        result = fused_profile_window(torch, fp, args, ema)
    if result is None:
        fail('the profiled fused dispatch did not launch the kernels as '
             'often as its graphs hold them, in two windows')
    result.update(chunk_ms=parts['chunk'], steps_ms=parts['steps'])
    return result


def fused_profile_window(torch, fp, args, ema):
    """One steady fused dispatch under torch.profiler: the summary, or None
    when a kernel of the dispatch is not in the device rows as often as its
    graphs launch it."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fp.train_step(ema)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and device_us(e) > 0]
    if not events:
        fail('fused profile: the profiler shows no kernel on the card')
    rows = sorted(((device_us(e) / 1e3, e.count, e.key) for e in events),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    log('fused profile: one steady dispatch (%d plies of %d envs, ingest, %d '
        'SGD steps at B=%d): %.3f ms on the host clock (profiled), device '
        'busy %.3f ms (%.1f%%, idle %.1f%%), %d kernel launches of %d '
        'kernels' % (args['device_chunk_steps'], args['generation_envs'],
                     FUSED_K, args['batch_size'], wall_ms, busy,
                     100 * busy / wall_ms, 100 - 100 * busy / wall_ms,
                     sum(r[1] for r in rows), len(rows)))
    for ms, count, key in rows[:12]:
        log('  %9.4f ms  %6d launches  %s' % (ms, count, key[:90]))
    want = {'trunk_fwd_kernel': args['device_chunk_steps'] + FUSED_K,
            'trunk_bwd_kernel': FUSED_K, 'trunk_wgrad_kernel': FUSED_K,
            'vtrace_kernel': FUSED_K}
    counts = {name: sum(e.count for e in events
                        if re.search(r'\b%s[<(]' % name, e.key))
              for name in want}
    log('fused profile: launches in the dispatch %s (expected %s)'
        % (counts, want))
    if counts != want:
        return None
    return {'dispatch_ms_profiled': wall_ms, 'device_busy_ms': busy,
            'idle_share': 1 - busy / wall_ms,
            'launches': sum(r[1] for r in rows), 'kernels': len(rows),
            'launches_in_dispatch': counts,
            'top': [{'kernel': k[:120], 'ms': ms, 'launches': c}
                    for ms, c, k in rows[:12]]}


def read_metrics(path):
    rows = []
    with open(path) as f:
        for l in f:
            if l.strip():
                rows.append(json.loads(l))
    return rows


def check_metrics_rows(rows, epochs):
    """One row an epoch 1..epochs (none preempted), every row with
    METRICS_KEYS and a telemetry summary, each of METRICS_SOME_KEYS in
    some row, steps non-decreasing."""
    got = [r['epoch'] for r in rows]
    if got != list(range(1, epochs + 1)):
        fail('the fused metrics rows are for epochs %s' % got)
    for r in rows:
        missing = [k for k in METRICS_KEYS if k not in r]
        if missing or 'counters' not in r['telemetry'] or \
                r.get('preempted'):
            fail('fused metrics row of epoch %d lacks %s: %s'
                 % (r['epoch'], missing, json.dumps(r)[:400]))
    for k in METRICS_SOME_KEYS:
        if not any(k in r for r in rows):
            fail('no fused metrics row has %r' % k)
    steps = [r['steps'] for r in rows]
    if steps != sorted(steps) or steps[-1] <= 0:
        fail('the fused metrics rows\' steps are not monotonic: %s' % steps)


def phase_fused(torch, repo, make_env, learner_line, tmp):
    """Runs the fused loop into ``tmp`` (kept for phase 8)."""
    import math
    import numpy as np
    from handyrl_tpu_torch.evaluation import load_model
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    line, wall = run_fused_entry(repo, tmp)
    models = os.path.join(tmp, 'models')
    if line['epochs'] != FUSED_EPOCHS or line['failed']:
        fail('the fused learner trained %s epochs' % line['epochs'])
    secs = sorted(line['epoch_seconds'])
    log('fused: %s; epoch_seconds of %d epochs: min %.3f, median %.3f, '
        'max %.3f, sum %.2f' % (
            json.dumps({k: v for k, v in line.items()
                        if k not in ('epoch_seconds', 'epoch_steps')}),
            len(secs), secs[0], secs[len(secs) // 2], secs[-1],
            sum(secs)))
    loop = line['loop_seconds']
    log('fused: the loop\'s host seconds: dispatch %.3f, fetch %.3f, '
        'evaluation %.3f, epoch close %.3f, of which the wait for the '
        'in-flight dispatch before a checkpoint %.3f and the checkpoint\'s '
        'copies and files %.3f' % (
            loop['dispatch'], loop['fetch'], loop['evaluation'],
            loop['epoch_close'], loop['checkpoint_wait'],
            loop['checkpoint_write']))
    steps = line['steps_at_exit']
    if steps != line['fused_dispatches'] * FUSED_K or steps <= 0:
        fail('the fused learner took %d steps in %d fused dispatches of '
             '%d' % (steps, line['fused_dispatches'], FUSED_K))
    want = sorted(set(range(FUSED_INTERVAL, FUSED_EPOCHS + 1,
                            FUSED_INTERVAL)) | {FUSED_EPOCHS})
    got = sorted(int(n.split('.')[0]) for n in os.listdir(models)
                 if n.endswith('.ckpt') and n.split('.')[0].isdigit())
    if got != want:
        fail('the fused loop wrote checkpoints %s, not %s' % (got, want))
    names = ['%d.ckpt' % e for e in want] + [
        'latest.ckpt', 'trainer_state.ckpt']
    for name in names:
        ok, reason = verify_checkpoint(os.path.join(models, name))
        if not ok or reason != 'ok':
            fail('fused checkpoint %s: %s' % (name, reason))
    rows = read_metrics(os.path.join(tmp, 'metrics.jsonl'))
    check_metrics_rows(rows, FUSED_EPOCHS)
    log('fused: %d metrics rows; the last: %s' % (
        len(rows), json.dumps({k: v for k, v in rows[-1].items()
                               if k != 'telemetry'})))
    if not (line['losses'] and all(math.isfinite(v)
                                   for v in line['losses'].values())):
        fail('the fused learner reports non-finite losses: %s'
             % line['losses'])
    by_path = line['kernel_launches']
    for path, kernels in FUSED_PATHS.items():
        for k in kernels:
            if not by_path.get(path, {}).get(k, 0) > 0:
                fail('the fused loop\'s %s never launched %s' % (path, k))
    train = by_path['training']
    for k in FUSED_PATHS['training']:
        if train[k] != steps:
            fail('the fused loop\'s training launched %s %d times in %d '
                 'steps' % (k, train[k], steps))
    if any(by_path.get(p, {}).get(k, 0)
           for p in ('generation', 'evaluation')
           for k in ('geese_trunk_bwd', 'td_lambda', 'upgo', 'vtrace')):
        fail('the fused loop\'s generation or evaluation launched a '
             'training kernel')
    log('fused: %d steps in %d fused dispatches (+ %d warm-up), kernel '
        'launches by path %s' % (steps, line['fused_dispatches'],
                                 line['warm_dispatches'], by_path))

    env = make_env(FUSED_CONFIG['env_args'])
    _, from_flax = param_trees(env.net())

    def params(name):
        with open(os.path.join(models, name), 'rb') as f:
            return from_flax(flax_msgpack.from_bytes(f.read()))
    first = params('%d.ckpt' % FUSED_INTERVAL)
    last = params('%d.ckpt' % FUSED_EPOCHS)
    moved = {k: (last[k] - first[k]).abs().max().item() for k in first}
    log('fused: params max abs change from %d.ckpt to %d.ckpt by leaf: '
        '%s' % (FUSED_INTERVAL, FUSED_EPOCHS,
                ', '.join('%s %.3g' % kv for kv in moved.items())))
    still = [k for k, v in moved.items() if not v > 0]
    if still:
        fail('the fused loop did not move %s' % still)
    obs = np.stack(game_observations(make_env, 64, SEED + 6))
    card = load_model(os.path.join(models, 'latest.ckpt'), env, 'cuda')
    cpu = load_model(os.path.join(models, 'latest.ckpt'), env, 'cpu')
    got, want = card.batch_inference(obs), cpu.batch_inference(obs)
    err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
    log('fused: latest.ckpt forward on the card vs the CPU over %d real '
        'boards: max abs err %s (tol %.0e)' % (len(obs), err,
                                               POLICY_TOL))
    if not all(np.isfinite(got[k]).all() for k in got) or \
            max(err.values()) > POLICY_TOL:
        fail('the fused loop\'s checkpoint computes other outputs on the '
             'card than on the CPU')

    fused_env_checks(torch)
    fp, _, tg, args = fused_setup(torch)
    fused_ingest_and_step_checks(torch, fp, tg, args)
    profile = fused_profile(torch, fp, args)
    fp.release()
    del fp
    torch.cuda.empty_cache()
    log('fused vs the host learner (phase 5), same card (%s): %.1f vs %.1f '
        'episodes/s, %.2f vs %.2f SGD steps/s, %.1f vs %.1f trajectories/s '
        '(B=64 vs 128), peak memory %.1f vs %.1f MiB; fused: %d epochs in '
        '%.1f s of process wall, sample reuse %.2f, %d windows ingested '
        '(ring %d of %d), dispatch %.2f s and fetch %.2f s on the host; a '
        'steady dispatch %.3f ms, device busy %.3f ms, idle %.1f%%' % (
            nvidia_smi_line(), line['episodes_per_s'],
            learner_line['episodes_per_s'], line['sgd_steps_per_s'],
            learner_line['update_steps_per_s'], line['trajectories_per_s'],
            learner_line['trajectories_per_s'], line['peak_memory_mib'],
            learner_line['peak_memory_mib'], line['epochs'], wall,
            line['sample_reuse'], line['windows_ingested'],
            line['ring_size'], line['ring_capacity'],
            line['dispatch_seconds'], line['fetch_seconds'],
            profile['dispatch_ms_profiled'], profile['device_busy_ms'],
            100 * profile['idle_share']))
    return {'line': line, 'profile': profile, 'wall': wall}


# ---------------------------------------------------- phase 7: quick start

# the README's quick start: tictactoe.json (config.yaml's env_args and
# train_args: turn-based TicTacToe, the full-width SimpleConv2dModel, TD/TD,
# lambda 0.7, gamma 0.8, B=128, T=16, 64 envs, 400 episodes before the first
# epoch and 200 an epoch, evaluation against 'random'), cut to QUICK_EPOCHS
# epochs (config.yaml runs forever); then the offline tournament of its
# latest.ckpt against 'random'. The learning bar is tests/test_train_e2e.py's
# slow test: over the last QUICK_LAST epochs at least QUICK_MIN_RESULTS
# evaluation results and a win rate above QUICK_MIN_WIN_RATE.
QUICK_CONFIG = 'tictactoe.json'
QUICK_EPOCHS = 15
QUICK_LAST = 5
QUICK_MIN_RESULTS, QUICK_MIN_WIN_RATE = 80, 0.6
QUICK_GAMES, QUICK_PROCS = 100, 4
QUICK_TARGETS = (16, 2, 256)   # (T, P, lanes) of the turn-based step's K3
QUICK_FILES = ['%d.ckpt' % e for e in range(1, QUICK_EPOCHS + 1)] + [
    'latest.ckpt', 'trainer_state.ckpt']


def tictactoe_observations(make_env, count, seed):
    """``count`` real TicTacToe observations, from both seats' views."""
    import random
    rng = random.Random(seed)
    env = make_env({'env': 'TicTacToe'})
    obs = []
    while len(obs) < count:
        if env.terminal():
            env.reset()
        obs += [env.observation(p) for p in env.players()]
        env.play(rng.choice(env.legal_actions()))
    return obs[:count]


def run_quick_start(repo, tmp):
    """``python -m handyrl_tpu_torch.train --config`` on tictactoe.json with
    QUICK_EPOCHS epochs and a temporary model_dir (no --device: the card is
    the default). Returns its JSON line, its epoch lines and its wall time."""
    with open(os.path.join(repo, QUICK_CONFIG)) as f:
        cfg = json.load(f)
    cfg['train_args']['epochs'] = QUICK_EPOCHS
    cfg['train_args']['model_dir'] = os.path.join(tmp, 'models')
    path = os.path.join(tmp, 'quick_start.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
             path], cwd=repo, capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the quick start did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail('the quick start exited %d:\n%s' % (proc.returncode,
                                                 proc.stderr[-4000:]))
    lines = [l for l in proc.stdout.splitlines() if l.startswith('{')]
    if len(lines) != 1:
        fail('the quick start printed %d JSON lines' % len(lines))
    shown = [l for l in proc.stdout.splitlines()
             if l.startswith(('epoch', 'win rate', 'loss'))]
    return json.loads(lines[0]), shown, wall


def run_quick_eval(repo, ckpt):
    """``python -m handyrl_tpu_torch.evaluation CKPT QUICK_GAMES
    QUICK_PROCS --config tictactoe.json`` on the card: the tallies of its
    report by agent and its wall time."""
    import ast
    t0 = time.monotonic()
    try:
        proc = subprocess.run(
            [sys.executable, '-m', 'handyrl_tpu_torch.evaluation', ckpt,
             str(QUICK_GAMES), str(QUICK_PROCS), '--config', QUICK_CONFIG],
            cwd=repo, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired as exc:
        fail('the tournament did not finish within 300 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail('the tournament exited %d:\n%s' % (proc.returncode,
                                                proc.stderr[-4000:]))
    out = proc.stdout.splitlines()
    head = '%d process, %d games' % (QUICK_PROCS, QUICK_GAMES)
    if head not in out or 'total games = %d' % QUICK_GAMES not in out:
        fail('the tournament did not print its header lines')
    agents, report = {}, []
    for line in out:
        if line.startswith('---agent '):
            current = int(line.strip('-').split()[1])
            report.append(line)
        elif line.startswith(('default-', 'total ')) and report:
            label, rest = line.split(' ', 1)
            tally_text, wp = rest.rsplit(' ', 1)
            agents.setdefault(current, {})[label] = (
                ast.literal_eval(tally_text), float(wp))
            report.append(line)
    return agents, report, wall


def phase_quick_start(torch, repo, make_env, k3_rows):
    import math
    import numpy as np
    from handyrl_tpu_torch.evaluation import load_model
    from handyrl_tpu_torch.model import param_trees
    from handyrl_tpu_torch.ops.train_step import GRAPH_WARMUP_STEPS
    from handyrl_tpu_torch.utils import flax_msgpack
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    tmp = tempfile.mkdtemp(prefix='chip_smoke_quick_')
    try:
        line, shown, wall = run_quick_start(repo, tmp)
        for l in shown:
            log('  quick start: %s' % l)
        models = os.path.join(tmp, 'models')
        log('quick start: %s' % json.dumps(line))
        if line['epochs'] != QUICK_EPOCHS or line['failed']:
            fail('the quick start trained %s epochs (failed %s)'
                 % (line['epochs'], line['failed_reason']))
        for name in QUICK_FILES:
            ok, reason = verify_checkpoint(os.path.join(models, name))
            if not ok or reason != 'ok':
                fail('quick start checkpoint %s: %s' % (name, reason))
        if not (line['losses'] and all(math.isfinite(v)
                                       for v in line['losses'].values())):
            fail('the quick start reports non-finite losses: %s'
                 % line['losses'])
        env = make_env({'env': 'TicTacToe'})
        _, from_flax = param_trees(env.net())

        def params(name):
            with open(os.path.join(models, name), 'rb') as f:
                return from_flax(flax_msgpack.from_bytes(f.read()))
        first, last = params('1.ckpt'), params('%d.ckpt' % QUICK_EPOCHS)
        moved = {k: (last[k] - first[k]).abs().max().item() for k in first}
        if not any(v > 0 for v in moved.values()):
            fail('the quick start\'s params did not change after epoch 1')

        # K3 once an update step (and each capture warm-up), nothing else:
        # the net's convs are PyTorch's, as the JAX package leaves them to XLA
        by_path = line['kernel_launches']
        runs = line['steps_at_exit'] + GRAPH_WARMUP_STEPS
        train = by_path.get('training', {})
        log('quick start: kernel launches by path %s; %d update steps (and %d '
            'eager warm-up steps of the capture)' % (
                by_path, line['steps_at_exit'], GRAPH_WARMUP_STEPS))
        if train.get('td_lambda') != runs:
            fail('the quick start launched K3 %s times in %d steps'
                 % (train.get('td_lambda'), runs))
        others = {(p, k): v for p, c in by_path.items() for k, v in c.items()
                  if v and (p, k) != ('training', 'td_lambda')}
        if others:
            fail('the quick start launched other kernels: %s' % others)

        # latest.ckpt on the card against the CPU, on real boards
        obs = np.stack(tictactoe_observations(make_env, 256, SEED + 6))
        ckpt = os.path.join(models, 'latest.ckpt')
        card = load_model(ckpt, env, 'cuda')
        cpu = load_model(ckpt, env, 'cpu')
        got, want = card.batch_inference(obs), cpu.batch_inference(obs)
        err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        log('quick start: latest.ckpt forward on the card vs the CPU over %d '
            'real boards: max abs err %s (tol %.0e)' % (len(obs), err,
                                                       POLICY_TOL))
        if not all(np.isfinite(got[k]).all() for k in got) or \
                max(err.values()) > POLICY_TOL:
            fail('the quick start\'s checkpoint computes other outputs on '
                 'the card than on the CPU')

        # the learning bar of tests/test_train_e2e.py's slow test
        last_epoch = line['model_epoch'] - 1
        n = r = 0
        for epoch in range(max(1, last_epoch - QUICK_LAST + 1),
                           last_epoch + 1):
            en, er = line['eval_by_epoch'].get(str(epoch), (0, 0))
            n, r = n + en, r + er
        win_rate = (r / (n + 1e-6) + 1) / 2
        steps = [b - a for a, b in zip([0] + line['epoch_steps'],
                                       line['epoch_steps'])]
        log('quick start: %d evaluation results over epochs %d-%d, win rate '
            '%.4f against random (bar: >= %d results, > %.2f)' % (
                n, max(1, last_epoch - QUICK_LAST + 1), last_epoch,
                win_rate, QUICK_MIN_RESULTS, QUICK_MIN_WIN_RATE))
        if n < QUICK_MIN_RESULTS or not win_rate > QUICK_MIN_WIN_RATE:
            fail('the quick start missed the learning bar: %d results, win '
                 'rate %.4f' % (n, win_rate))

        agents, report, eval_wall = run_quick_eval(repo, ckpt)
        for l in report:
            log('  tournament: %s' % l)
        totals = {a: sum(t['total'][0].values()) for a, t in agents.items()}
        if sorted(agents) != [0, 1] or set(totals.values()) != {QUICK_GAMES}:
            fail('the tournament counted %s games by agent' % totals)
        eval_wp = agents[0]['total'][1]
        k3 = k3_rows[('td_lambda',) + QUICK_TARGETS]
        log('quick start: %.1f episodes/s, %.2f SGD steps/s, %.1f '
            'trajectories/s, steps per epoch %s, %d episodes, %d evaluation '
            'results, peak memory %.1f MiB, %.1f s process wall; K3 %.2f us at '
            '%d lanes (T=%d, P=%d; graph replay); tournament %d games in %d '
            'processes %.1f s, main agent win rate %.4f (%s)' % (
                line['episodes_per_s'], line['update_steps_per_s'],
                line['trajectories_per_s'], steps, line['episodes'],
                line['eval_results'], line['peak_memory_mib'], wall,
                1e3 * k3['ms'], QUICK_TARGETS[2], QUICK_TARGETS[0],
                QUICK_TARGETS[1], QUICK_GAMES, QUICK_PROCS, eval_wall,
                eval_wp, nvidia_smi_line()))
        return {'line': line, 'wall': wall, 'win_rate': win_rate,
                'eval_results': n, 'steps_per_epoch': steps,
                'eval_wall': eval_wall, 'eval_win_rate': eval_wp}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------- phase 8: scoring and preemption

# (a) phase 6's checkpoints at epoch FUSED_INTERVAL and at its last, scored
# offline by scripts/torch_eval_checkpoints.py (one evaluator, one captured
# rollout, SCORE_GAMES games a point against 'random', a fresh process);
# the bar is under the JAX package's curves (0.985-0.991 at epoch 160,
# north_star_device_curve{,_r5}.jsonl)
SCORE_GAMES = 512
SCORE_ENVS = 64
SCORE_MIN_LAST = 0.95
# (b) the preemption drill: phase 6's model dir resumed (restart_epoch -1)
# for DRILL_EPOCHS more epochs with keep_checkpoints DRILL_KEEP, SIGTERMed
# once its first metrics row lands, then restarted to its end
DRILL_EPOCHS = 6
DRILL_KEEP = 3


def run_scorer(repo, models, out):
    """The scorer on epochs FUSED_INTERVAL and FUSED_EPOCHS of ``models``:
    its rows and its summary line."""
    every = FUSED_EPOCHS // FUSED_INTERVAL - 1   # picks the first and last
    cmd = [sys.executable, 'scripts/torch_eval_checkpoints.py', models,
           'HungryGeese', out, '--every', str(every), '--games',
           str(SCORE_GAMES), '--envs', str(SCORE_ENVS), '--opponent',
           'random', '--env-args', json.dumps(FUSED_CONFIG['env_args'])]
    t0 = time.monotonic()
    try:
        proc = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                              timeout=300)
    except subprocess.TimeoutExpired as exc:
        fail('the scorer did not finish within 300 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    wall = time.monotonic() - t0
    if proc.returncode != 0:
        fail('the scorer exited %d:\n%s' % (proc.returncode,
                                            proc.stderr[-4000:]))
    lines = [json.loads(l) for l in proc.stdout.splitlines()
             if l.startswith('{')]
    return read_metrics(out), lines[-1], wall


def drill_config(tmp, epochs):
    cfg = json.loads(json.dumps(FUSED_CONFIG))
    cfg['train_args'].update(
        model_dir=os.path.join(tmp, 'models'), restart_epoch=-1,
        epochs=epochs, keep_checkpoints=DRILL_KEEP,
        metrics_jsonl=os.path.join(tmp, 'metrics.jsonl'))
    path = os.path.join(tmp, 'drill.json')
    with open(path, 'w') as f:
        json.dump(cfg, f)
    return path


def run_drill(repo, tmp, epochs):
    """The resumed learner, SIGTERMed once a new metrics row lands; then
    its restart. Returns both runs' (returncode, stdout) and the walls."""
    path = drill_config(tmp, epochs)
    metrics = os.path.join(tmp, 'metrics.jsonl')
    rows_before = len(read_metrics(metrics))
    cmd = [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config', path]
    out_path = os.path.join(tmp, 'drill_first.log')
    t0 = time.monotonic()
    with open(out_path, 'w') as out:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 300
            while (len(read_metrics(metrics)) <= rows_before
                   and proc.poll() is None and time.monotonic() < deadline):
                time.sleep(0.05)
            if proc.poll() is not None:
                fail('the resumed learner exited %s before its first row'
                     % proc.returncode)
            if time.monotonic() >= deadline:
                fail('the resumed learner wrote no row within 300 s')
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(out_path) as f:
        first = (rc, f.read(), time.monotonic() - t0)
    t0 = time.monotonic()
    try:
        again = subprocess.run(cmd, cwd=repo, capture_output=True, text=True,
                               timeout=600)
    except subprocess.TimeoutExpired as exc:
        fail('the restarted learner did not finish within 600 s:\n%s' % (
            (exc.stderr or b'')[-4000:]))
    second = (again.returncode, again.stdout + again.stderr,
              time.monotonic() - t0)
    return first, second


def phase_score_and_drill(repo, tmp):
    import re
    from handyrl_tpu_torch import guard
    from handyrl_tpu_torch.utils.fs import verify_checkpoint
    models = os.path.join(tmp, 'models')

    rows, summary, wall = run_scorer(repo, models,
                                     os.path.join(tmp, 'curve.jsonl'))
    epochs = [r['epoch'] for r in rows]
    if epochs != [FUSED_INTERVAL, FUSED_EPOCHS]:
        fail('the scorer scored epochs %s' % epochs)
    if any(r['games'] < SCORE_GAMES or r['opponent'] != 'random'
           or set(r) != {'epoch', 'opponent', 'games', 'win_rate', 'mean'}
           for r in rows):
        fail('the scorer\'s rows: %s' % rows)
    first, last = rows
    if not (last['win_rate'] >= SCORE_MIN_LAST
            and last['win_rate'] >= first['win_rate']):
        fail('scored win rates against random: epoch %d %.4f, epoch %d '
             '%.4f (bar: the last >= %.2f and not below the first)' % (
                 first['epoch'], first['win_rate'], last['epoch'],
                 last['win_rate'], SCORE_MIN_LAST))
    by_path = summary['kernel_launches']
    launched = {(p, k) for p, counts in by_path.items()
                for k, n in counts.items() if n}
    if launched != {('evaluation', 'geese_trunk')} or \
            summary['rollout_graphs'] != 1:
        fail('the scorer launched %s with %s rollout graphs'
             % (by_path, summary['rollout_graphs']))
    log('score: %s; %d dispatches, K1 launches %s, one rollout graph, '
        '%.2f s scoring, %.1f s process wall (%s)' % (
            ', '.join('epoch %d %.4f (%d games, mean %.4f)' % (
                r['epoch'], r['win_rate'], r['games'], r['mean'])
                for r in rows),
            summary['dispatches'], by_path, summary['seconds'], wall,
            nvidia_smi_line()))

    end = FUSED_EPOCHS + DRILL_EPOCHS
    (rc1, out1, wall1), (rc2, out2, wall2) = run_drill(repo, tmp, end)
    if rc1 != guard.PREEMPT_EXIT_CODE or \
            'preempted: checkpoint flushed' not in out1:
        fail('the SIGTERMed learner exited %s:\n%s' % (rc1, out1[-3000:]))
    m = re.search(r'preempted: checkpoint flushed at epoch (\d+) \(steps '
                  r'(\d+)\)', out1)
    flushed, flushed_steps = int(m.group(1)), int(m.group(2))
    ok, reason = verify_checkpoint(os.path.join(models, 'trainer_state.ckpt'))
    if not ok:
        fail('the flushed trainer_state.ckpt: %s' % reason)
    if rc2 != 0 or ('auto-resume: newest valid checkpoint is epoch %d'
                    % flushed) not in out2:
        fail('the restarted learner exited %s:\n%s' % (rc2, out2[-3000:]))
    scored = rows
    rows = read_metrics(os.path.join(tmp, 'metrics.jsonl'))
    pre = [r for r in rows if r.get('preempted')]
    if len(pre) != 1 or pre[0]['steps'] != flushed_steps:
        fail('preempted rows: %s' % pre)
    steps = [r['steps'] for r in rows]
    epochs = [r['epoch'] for r in rows if not r.get('preempted')]
    if steps != sorted(steps) or len(epochs) != len(set(epochs)) or \
            max(epochs) != end:
        fail('the metrics rows across the restart: epochs %s, steps %s'
             % (epochs[-12:], steps[-12:]))
    kept = sorted(int(n.split('.')[0]) for n in os.listdir(models)
                  if n.endswith('.ckpt') and n.split('.')[0].isdigit())
    if len(kept) != DRILL_KEEP or kept[-1] != end or flushed not in kept:
        fail('numbered checkpoints after the drill: %s' % kept)
    line = json.loads([l for l in out2.splitlines() if l.startswith('{')][-1])
    if not line['warm_dispatches'] >= 1:
        fail('the restart trained before refilling its ring: %s' % line)
    log('drill: SIGTERM after the first resumed row, exit %d in %.1f s, '
        'flushed epoch %d (steps %d); restart exit 0 in %.1f s to epoch %d '
        '(%d warm-up dispatches before training again); numbered checkpoints '
        'kept %s (keep_checkpoints %d); %d metrics rows, steps monotonic' % (
            rc1, wall1, flushed, flushed_steps, wall2, end,
            line['warm_dispatches'], kept, DRILL_KEEP, len(rows)))
    return {'score': scored, 'score_summary': summary}


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
    from handyrl_tpu_torch.ops import cuda_build, geese_trunk, targets

    t_start = time.monotonic()
    smi = nvidia_smi_line()
    log('card: %s | torch %s, CUDA %s, %d device(s)' % (
        smi, torch.__version__, torch.version.cuda,
        torch.cuda.device_count()))

    log('== phase 1: build')
    hmma = phase_build(cuda_build)

    log('== phase 2: kernels against their plain versions')
    rows = phase_kernels(torch, geese_trunk, GeeseNet, make_env)
    bwd_rows = phase_backward(torch, geese_trunk, GeeseNet, make_env)
    phase_narrow(torch, geese_trunk)
    target_rows = phase_targets(torch, targets)

    log('== phase 3: main path (serving)')
    launches = phase_main_path(torch, repo)

    log('== phase 4: main path (training)')
    train = phase_training(torch, repo, make_env)

    log('== phase 5: main path (the local learner)')
    learner = phase_learner(torch, repo, make_env, train['bench'])

    fused_tmp = tempfile.mkdtemp(prefix='chip_smoke_fused_')
    try:
        log('== phase 6: main path (the fused device loop)')
        fused = phase_fused(torch, repo, make_env, learner, fused_tmp)

        log('== phase 7: main path (the quick start: TicTacToe, turn-based)')
        quick = phase_quick_start(torch, repo, make_env, target_rows)

        log('== phase 8: main path (phase 6\'s checkpoints scored offline; '
            'a preemption drill)')
        scored = phase_score_and_drill(repo, fused_tmp)
    finally:
        shutil.rmtree(fused_tmp, ignore_errors=True)

    log('== phase 9: the kernels line')
    # launches on each main path: serving, the bench entry (both forms),
    # the in-process steps of each form and config, the learner by its
    # paths (each run with the counts at 0 just before; a graph's replays
    # counted by bookkeeping)
    paths = dict(train['paths'], serving=launches)
    for name, counts in learner['kernel_launches'].items():
        paths['learner_' + name] = counts
    for name, counts in fused['line']['kernel_launches'].items():
        paths['learner_fused_' + name] = counts
    for name, counts in quick['line']['kernel_launches'].items():
        paths['quick_start_' + name] = counts
    for name, counts in scored['score_summary']['kernel_launches'].items():
        paths['score_' + name] = counts

    def entry(name, source, replaces, main_row, by_n, count=None, **extra):
        count = count or name   # the wrapper count the launches are read from
        row = {'name': name, 'route': 'cuda',
               'source': 'handyrl_tpu_torch/csrc/' + source,
               'replaces': replaces,
               'launches': sum(p.get(count, 0) for p in paths.values()),
               'launches_by_path': {k: p.get(count, 0)
                                    for k, p in paths.items()},
               'max_abs_err': max(r['max_abs_err'] for r in by_n.values()),
               'peaks': PEAK_SOURCE}
        row.update({k: main_row[k] for k in ('ms', 'plain_ms', 'bound_ms',
                                             'bound_by', 'library_ms', 'n')})
        row['by_n'] = {str(n): {k: r[k] for k in (
            'max_abs_err', 'ms', 'plain_ms', 'library_ms', 'bound_ms')}
            for n, r in by_n.items()}
        row.update(extra)
        return row

    kernels = [
        entry('geese_trunk', 'geese_trunk.cu',
              'handyrl_tpu/ops/pallas_geese.py:108', rows[MAIN_PATH_N], rows,
              train_ms={str(n): rows[n]['train_ms'] for n in SAVED_NS},
              train_bound_ms={str(n): rows[n]['train_bound_ms']
                              for n in SAVED_NS},
              device_ms={str(n): r['device_ms'] for n, r in rows.items()},
              sass_hmma=hmma.get('trunk_fwd_kernel<32>', 0)),
    ]
    # K2 as its two phases: each wrapper call launches each phase once
    notes = {'a': dict(plain_and_library_ms_are='of the whole K2'),
             'b': dict(plain_ms_is='the 13 plain weight grads',
                       library_ms_is='cuDNN\'s weight grads of the 13 torus '
                       'convs (conv2d_weight, fp32), by CUDA-graph replay',
                       sass_hmma=hmma.get('trunk_wgrad_kernel<32>', 0))}
    for phase, kernel_names in PHASES.items():
        by_n = {n: dict(r, **r[phase]) for n, r in bwd_rows.items()}
        kernels.append(entry(
            'geese_trunk_bwd_' + phase, 'geese_trunk.cu',
            'handyrl_tpu/ops/pallas_geese.py:115', by_n[TRAIN_N], by_n,
            count='geese_trunk_bwd', kernels=kernel_names,
            k2_ms=bwd_rows[TRAIN_N]['ms'],
            max_abs_err_is='of K2\'s grads, relative to each grad\'s '
            'largest element', **notes[phase]))
    for name, line in (('td_lambda', 129), ('upgo', 138), ('vtrace', 149)):
        by_n = {'T%d_P%d_N%d' % key[1:]: r
                for key, r in target_rows.items() if key[0] == name}
        kernels.append(entry(
            name, 'targets.cu', 'handyrl_tpu/ops/pallas_targets.py:%d' % line,
            target_rows[(name,) + TARGET_PATH], by_n, T=TARGET_PATH[0],
            P=TARGET_PATH[1],
            library_ms_none='no single PyTorch call computes the recursion'))
    bench_line = train['bench']
    log('training path: graphed %.1f trajectories/s, %.3f ms a step; eager '
        '%.3f ms a step (B=128, T=16, fp32, host clock); profiled device '
        'busy %s ms, idle share %s' % (
            bench_line['value'], bench_line['step_ms'],
            bench_line['eager_step_ms'],
            {f: round(p['device_busy_ms'], 4)
             for f, p in train['profile'].items()},
            {f: round(p['idle_share'], 4)
             for f, p in train['profile'].items()}))
    log('total %.1f s' % (time.monotonic() - t_start))
    print(json.dumps({'kernels': kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
