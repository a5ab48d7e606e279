"""The port's update-step entry point, ``python -m handyrl_tpu_torch.bench``:
its ``run_bench`` at a small size on the CPU gives one JSON-serialisable
line with the metric, the step time of the eager step (the only form on
the CPU; the graphed form's fields are null), finite losses and the kernel
counts (all 0 on the CPU); without a card, ``--device cuda`` raises. Its batch is
the JAX package's ``__graft_entry__._synthetic_batch``, draw for draw."""

import json
import os
import subprocess
import sys

import numpy as np

from __graft_entry__ import _synthetic_batch
from handyrl_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_run_prints_one_json_line():
    line = json.loads(json.dumps(bench.run_bench(
        'cpu', steps=2, B=4, T=4, filters=16, layers=2)))
    assert line['metric'] == bench.METRIC and line['unit'] == bench.UNIT
    assert line['value'] > 0 and line['step_ms'] > 0
    assert line['device'] == 'cpu' and line['compute_dtype'] == 'float32'
    assert set(line['losses']) == {'total', 'p', 'v', 'ent'}
    assert all(np.isfinite(v) for v in line['losses'].values())
    assert line['nonfinite'] == 0 and line['grad_norm'] > 0
    assert line['steps_run'] == bench.WARMUP + 2 and line['timed_steps'] == 2
    # graphs are CUDA-only: on the CPU the eager step is the line's
    assert line['form'] == 'eager' and line['eager_step_ms'] is None
    for k in ('graph_first_call_ms', 'peak_memory_mib', 'steps_by_form',
              'kernel_launches_by_form'):
        assert line[k] is None, k
    assert line['kernel_launches'] == {
        'geese_trunk': 0, 'geese_trunk_bwd': 0, 'td_lambda': 0, 'upgo': 0,
        'vtrace': 0}


def test_cuda_without_a_card_raises():
    proc = subprocess.run(
        [sys.executable, '-m', 'handyrl_tpu_torch.bench', '--device', 'cuda'],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
    assert proc.returncode != 0
    assert '{' not in proc.stdout
    assert 'CUDA' in proc.stderr


def test_synthetic_batch_is_the_jax_packages():
    want = _synthetic_batch(3, 5, 1, (17, 7, 11), 4, np.random.RandomState(7))
    got = bench.synthetic_batch(3, 5, 1, (17, 7, 11), 4,
                                np.random.RandomState(7))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_kernel_counts_in_one_place():
    """ops.kernel_launches reads every kernel's count (summed over the
    paths, or of one path); reset sets each to 0; the service reports the
    same dict."""
    from handyrl_tpu_torch import ops
    from handyrl_tpu_torch.ops import launches
    from handyrl_tpu_torch.serving import service
    ops.add_kernel_launches({'geese_trunk': 1})
    with launches.path('training'):
        ops.add_kernel_launches({'geese_trunk': 2, 'geese_trunk_bwd': 2,
                                 'vtrace': 1})
    want = {'geese_trunk': 3, 'geese_trunk_bwd': 2, 'td_lambda': 0,
            'upgo': 0, 'vtrace': 1}
    assert ops.kernel_launches() == service.kernel_launches() == want
    assert ops.kernel_launches('training') == dict(want, geese_trunk=2)
    ops.reset_kernel_launches()
    assert set(ops.kernel_launches().values()) == {0}
