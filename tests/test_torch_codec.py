"""The port's wire codec (handyrl_tpu_torch/connection.py) against the JAX
package's (msgpack with the ndarray ext hook): byte-identical encodings
over the protocol's message shapes, each side decoding the other's bytes,
and the port's framing refusing bad input. Exact equality throughout."""

import numpy as np
import pytest

from handyrl_tpu import connection as jax_connection
from handyrl_tpu_torch import connection
from handyrl_tpu_torch.connection import FrameParser, pack, unpack


def _arrays():
    rng = np.random.default_rng(0)
    out = [
        rng.standard_normal((17, 7, 11)).astype(np.float32),
        rng.standard_normal((3, 4)),                          # float64
        rng.integers(-5, 5, (2, 3)).astype(np.int64),
        rng.integers(-5, 5, 7).astype(np.int32),
        rng.integers(0, 255, (4, 4)).astype(np.uint8),
        rng.random(5) < 0.5,                                  # bool
        rng.standard_normal(6).astype(np.float16),
        np.asarray(3.5, np.float32),                          # 0-d
        np.zeros((0, 4), np.float32),                         # empty
        rng.standard_normal((4, 3)).astype(np.float32).T,     # not C-order
        np.arange(70000, dtype=np.uint8),                     # ext32 length
        np.arange(300, dtype=np.uint8),                       # ext16 length
    ]
    # ext payloads of every small length, across the fixext 1/2/4/8/16
    # and ext8 boundaries
    out += [np.arange(n, dtype=np.uint8) for n in range(0, 24)]
    return out


def _messages():
    arrays = _arrays()
    ints = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
            2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
            -2 ** 31, -2 ** 31 - 1, -2 ** 63]
    strs = ['', 'a', 'x' * 31, 'x' * 32, 'y' * 255, 'y' * 256,
            'z' * 65536, 'ünïcødé']
    blobs = [b'', b'\x00', b'b' * 255, b'b' * 256, b'c' * 65536,
             bytearray(b'raw')]
    return [
        None, True, False, 1.5, -0.0, float('inf'),
        *ints, *strs, *blobs, *arrays,
        np.float32(0.25), np.float64(2.5), np.int64(-7), np.int32(9),
        np.uint8(200), np.bool_(True),
        list(range(15)), list(range(16)), list(range(70000)),
        tuple(range(3)),
        {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
        {i: i for i in range(70000)},
        # the protocol's own frames
        ('__infer__', {'rid': 3, 'model': 'default@champion',
                       'obs': arrays[0], 'legal': [0, 2, 3],
                       'seed': [2 ** 64 - 1, 0, 7], 'client': 't0',
                       'trace': {'id': 'r1.2', 'parent': None}}),
        ('__infer__', {'rid': 3, 'action': 2, 'prob': np.float32(0.3),
                       'action_mask': np.array([0, 1e32, 0, 0], np.float32),
                       'value': np.array([0.1], np.float32), 'hidden': None}),
        ('__serve__', {'op': 'status'}),
        {'architecture': 'GeeseNet', 'config': {'layers': 2},
         'params': {'params': {'TorusConv_0': {'Conv_0': {
             'kernel': arrays[1]}}}}},
        [[[], {}], [{'nested': [1, [2, [3, None]]]}]],
    ]


@pytest.mark.parametrize('index', range(len(_messages())))
def test_pack_is_byte_identical_to_msgpack(index):
    msg = _messages()[index]
    assert pack(msg) == jax_connection.pack(msg)


def _equal(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        assert type(a) is type(b) and (a == b or a != a), (a, b)


def test_each_side_decodes_the_others_bytes():
    for msg in _messages():
        ours, theirs = pack(msg), jax_connection.pack(msg)
        _equal(unpack(theirs), jax_connection.unpack(theirs))
        _equal(jax_connection.unpack(ours), unpack(ours))


def test_decoded_arrays_own_their_memory():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    back = unpack(pack({'a': arr}))['a']
    assert back.flags.writeable and back.flags.owndata
    back[0, 0] = 99.0
    np.testing.assert_array_equal(unpack(pack(arr)), arr)


def test_refuses_code_and_garbage():
    with pytest.raises(TypeError):
        pack(object())
    with pytest.raises(TypeError):
        pack({'f': len})
    good = pack({'k': [1, 2, 3]})
    with pytest.raises(ValueError):
        unpack(good[:-1])                  # truncated
    with pytest.raises(ValueError):
        unpack(good + b'\x00')             # trailing bytes
    with pytest.raises(ValueError):
        unpack(b'\xc1')                    # never-used type byte
    # an unknown ext type decodes to data, never to an object
    ext = unpack(b'\xd4\x05\x07')
    assert ext == connection.ExtType(5, b'\x07')


def test_frame_parser_splits_and_validates():
    p = FrameParser()
    frames = [pack(m) for m in ({'a': 1}, [1, 2], 'x' * 300)]
    stream = b''.join(len(f).to_bytes(4, 'big') + f for f in frames)
    got = []
    for i in range(0, len(stream), 7):     # arbitrary chunking
        got += p.feed(stream[i:i + 7])
    assert got == frames
    with pytest.raises(ConnectionResetError):
        FrameParser().feed((-1).to_bytes(4, 'big', signed=True))
    with pytest.raises(ConnectionResetError):
        FrameParser().feed((connection.MAX_FRAME_BYTES + 1).to_bytes(4, 'big'))
