"""What the port's data-parallel tests share: ranks of a torch.distributed
job on the host, each a process of its own started with the JAX package's
variables (JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) on
a free port, one intra-op thread each (OMP_NUM_THREADS=1), over gloo; the
learner's entry point run that way; and the fixture body that keeps the
test process itself on one thread."""

import json
import os
import socket
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def one_torch_thread():
    """A fixture body: one intra-op thread here and in the processes a
    test starts (the workers of a parallel test run share the cores)."""
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def free_port() -> int:
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_env(port: int, world: int, rank: int, **extra) -> dict:
    """The environment of rank ``rank`` of a ``world``-rank job on
    ``port``: the JAX package's variables, one thread, the repo on the
    path."""
    env = dict(os.environ, JAX_COORDINATOR_ADDRESS='localhost:%d' % port,
               JAX_NUM_PROCESSES=str(world), JAX_PROCESS_ID=str(rank),
               OMP_NUM_THREADS='1',
               PYTHONPATH=REPO + os.pathsep + os.environ.get('PYTHONPATH',
                                                             ''))
    env.pop('XLA_FLAGS', None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def start_ranks(argv, world: int, tmp_path, tag: str, envs=None):
    """Start ``world`` processes of ``argv`` as the ranks of one job, their
    output to files under ``tmp_path``; returns [(process, log path)]."""
    port = free_port()
    out = []
    for rank in range(world):
        log = str(tmp_path / ('%s_rank%d.log' % (tag, rank)))
        env = rank_env(port, world, rank, **((envs or [{}] * world)[rank]))
        with open(log, 'w') as f:
            proc = subprocess.Popen(argv, env=env, cwd=str(tmp_path),
                                    stdout=f, stderr=subprocess.STDOUT)
        out.append((proc, log))
    return out


def wait_ranks(procs, timeout: float):
    """Each rank's (exit code, output); kills every rank left at the
    deadline (and fails)."""
    deadline = time.monotonic() + timeout
    try:
        for proc, _ in procs:
            proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for proc, _ in procs:
            proc.kill()
        raise AssertionError('ranks still running after %.0f s:\n%s' % (
            timeout, '\n'.join(read(log)[-3000:] for _, log in procs)))
    return [(proc.returncode, read(log)) for proc, log in procs]


def run_ranks(argv, world: int, tmp_path, tag: str, timeout: float = 120,
              envs=None):
    return wait_ranks(start_ranks(argv, world, tmp_path, tag, envs),
                      timeout)


def read(path: str) -> str:
    with open(path) as f:
        return f.read()


def run_script(source: str, world: int, tmp_path, tag: str,
               timeout: float = 120):
    """``source`` as a script run by ``world`` ranks; fails unless each
    exits 0. Returns each rank's output."""
    script = tmp_path / ('%s.py' % tag)
    script.write_text(source)
    results = run_ranks([sys.executable, str(script)], world, tmp_path, tag,
                        timeout)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, 'rank %d exited %d:\n%s' % (rank, rc, out[-4000:])
    return [out for _, out in results]


def train_config(tmp_path, name: str, raw: dict) -> str:
    path = tmp_path / name
    path.write_text(json.dumps(raw))
    return str(path)


def train_argv(config: str):
    """The learner's entry point on the host."""
    return [sys.executable, '-m', 'handyrl_tpu_torch.train', '--config',
            config, '--device', 'cpu']


def json_line(out: str) -> dict:
    """The learner's JSON line in its output."""
    lines = [l for l in out.splitlines() if l.startswith('{"device"')]
    assert len(lines) == 1, out[-3000:]
    return json.loads(lines[0])
