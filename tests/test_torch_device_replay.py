"""The host-push replay ring of the threaded replay trainer
(handyrl_tpu_torch/ops/replay.py ``DeviceReplay``) against the JAX
package's ``DeviceReplay`` (handyrl_tpu/ops/replay.py:56-130) on the CPU.

The same windows (numpy, from a seed, with the shapes and dtypes the host
window builder gives: (T, P, ...) float32 leaves and an int32 action) are
pushed into both rings in chunks of 8 until the ring wraps; after every
push the rings' rows, cursor and size are equal exactly. Samples are drawn
from the same slots (the port takes the uniforms the JAX key gives) and
must be equal exactly, each leaf back in its window shape with its dtype.
Equality is exact: both rings only copy and gather.
"""

import os

import jax
import numpy as np
import pytest
import torch

from handyrl_tpu.ops.replay import DeviceReplay as JaxDeviceReplay
from handyrl_tpu_torch.ops.replay import DeviceReplay, recency_slots

pytestmark = pytest.mark.timeout(60)

T, P, A = 4, 1, 4
SPEC = {'observation': ((T, P, 17, 7, 11), np.float32),
        'selected_prob': ((T, P, 1), np.float32),
        'action': ((T, P, 1), np.int32),
        'action_mask': ((T, P, A), np.float32),
        'value': ((T, P, 1), np.float32),
        'reward': ((T, P, 1), np.float32),
        'return': ((T, P, 1), np.float32),
        'outcome': ((1, P, 1), np.float32),
        'episode_mask': ((T, 1, 1), np.float32),
        'turn_mask': ((T, P, 1), np.float32),
        'observation_mask': ((T, P, 1), np.float32),
        'progress': ((T, 1), np.float32)}


@pytest.fixture(autouse=True, scope='module')
def _one_torch_thread():
    before, omp = torch.get_num_threads(), os.environ.get('OMP_NUM_THREADS')
    torch.set_num_threads(1)
    os.environ['OMP_NUM_THREADS'] = '1'
    yield
    torch.set_num_threads(before)
    if omp is None:
        os.environ.pop('OMP_NUM_THREADS', None)
    else:
        os.environ['OMP_NUM_THREADS'] = omp


def _windows(rng, n):
    out = {}
    for k, (shape, dtype) in SPEC.items():
        if dtype == np.int32:
            out[k] = rng.randint(0, A, size=(n,) + shape).astype(np.int32)
        else:
            out[k] = rng.standard_normal((n,) + shape).astype(np.float32)
    return out


def _rows_equal(port, jr):
    # the JAX ring's leaves are in its treedef's (sorted key) order
    keys = sorted(port.buffers)
    assert len(jr.buffers) == len(keys)
    for k, jb in zip(keys, jr.buffers):
        np.testing.assert_array_equal(port.buffers[k].numpy(),
                                      np.asarray(jb), err_msg=k)
    assert (port.cursor, port.size) == (jr.cursor, jr.size)
    assert int(port.cursor_t) == port.cursor
    assert int(port.size_t) == port.size


@pytest.mark.parametrize('capacity', [20, 24])
def test_push_and_sample_match_jax(capacity):
    rng = np.random.RandomState(capacity)
    port, jr = DeviceReplay(capacity), JaxDeviceReplay(capacity)
    key = jax.random.PRNGKey(7)
    for push in range(6):    # 48 windows: the ring wraps twice
        win = _windows(rng, 8)
        port.push(win)
        jr.push(win)
        _rows_equal(port, jr)
        key, sub = jax.random.split(key)
        want = jr.sample(sub, 16)
        u = np.array(jax.random.uniform(sub, (16,)))
        got = port.sample(16, u=torch.from_numpy(u))
        assert set(got) == set(want)
        for k, (shape, dtype) in SPEC.items():
            assert tuple(got[k].shape) == (16,) + shape, k
            assert got[k].numpy().dtype == dtype, k
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]),
                                          err_msg='%s push %d' % (k, push))
    assert port.size == capacity
    assert port.window_spec['action'] == ((T, P, 1), torch.int32)


def test_recency_slots_match_jax_on_a_wrapped_ring():
    """The slots both rings draw from the same uniforms: the newest window
    most likely, the oldest at the cursor once the ring is full."""
    from handyrl_tpu.ops.replay import recency_slots as jax_slots
    key = jax.random.PRNGKey(3)
    u = np.array(jax.random.uniform(key, (4096,)))
    for size, cursor, cap in ((0, 0, 8), (5, 5, 8), (8, 3, 8), (24, 17, 24)):
        want = np.asarray(jax_slots(key, size, cursor, cap, 4096))
        got = recency_slots(torch.from_numpy(u), torch.tensor(size),
                            torch.tensor(cursor), cap).numpy()
        np.testing.assert_array_equal(got, want)


def test_sample_from_an_empty_ring_raises():
    port = DeviceReplay(8)
    with pytest.raises(ValueError, match='empty'):
        port.sample(4)
