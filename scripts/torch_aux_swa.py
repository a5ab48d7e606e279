"""Stochastic Weight Averaging over a range of epoch checkpoints, on the port.

The counterpart of ``scripts/aux_swa.py`` for ``handyrl_tpu_torch``: the
equal-weight running mean ``a + (x - a) / n`` (fp32) over the params of
``MODEL_DIR/<epoch>.ckpt`` for START <= epoch <= END (flax's ``to_bytes``
layout, as either package's learner writes it), written to
``MODEL_DIR/swa.ckpt`` in the same layout, then reloaded strictly into
a fresh net and verified by one probe inference. Every floating-point
entry of the net's state is averaged (params, and a BatchNorm net's
running averages); a missing checkpoint is skipped, as in the JAX script.
The mean runs on ``--device`` ('cuda' unless asked otherwise).

Usage: python scripts/torch_aux_swa.py ENV START END [MODEL_DIR]
       [--device cuda|cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('env', nargs='?', default='TicTacToe')
    ap.add_argument('start', nargs='?', type=int, default=1)
    ap.add_argument('end', nargs='?', type=int, default=None)
    ap.add_argument('model_dir', nargs='?', default='models')
    ap.add_argument('--device', default='cuda',
                    help="where the mean runs: 'cuda' (default) or 'cpu'")
    a = ap.parse_args(argv)
    end = a.start if a.end is None else a.end

    import numpy as np

    from handyrl_tpu_torch.environment import make_env
    from handyrl_tpu_torch.model import (ModelWrapper, load_params_bytes,
                                         params_bytes, resolve_device)

    device = resolve_device(a.device)
    env = make_env({'env': a.env})
    env.reset()
    example_obs = env.observation(env.players()[0])

    module = env.net()
    avg = None
    count = 0
    for epoch in range(a.start, end + 1):
        path = os.path.join(a.model_dir, '%d.ckpt' % epoch)
        if not os.path.exists(path):
            print('skip missing', path)
            continue
        with open(path, 'rb') as f:
            load_params_bytes(module, f.read())
        state = {k: v.to(device) for k, v in module.state_dict().items()}
        count += 1
        if avg is None:
            avg = {k: v.clone() for k, v in state.items()}
        else:
            # the running equal-weight mean: avg += (x - avg) / n
            for k, v in state.items():
                if v.is_floating_point():
                    avg[k] = avg[k] + (v - avg[k]) / count
    assert avg is not None, 'no checkpoints found in range'
    print('averaged %d checkpoints' % count)

    module.load_state_dict({k: v.cpu() for k, v in avg.items()})
    out_path = os.path.join(a.model_dir, 'swa.ckpt')
    with open(out_path, 'wb') as f:
        f.write(params_bytes(module))
    print('wrote', out_path)

    # the self-test: a strict reload into a fresh net, one probe inference
    check = env.net()
    with open(out_path, 'rb') as f:
        load_params_bytes(check, f.read())
    wrapper = ModelWrapper(check, device)
    out = wrapper.inference(example_obs, wrapper.init_hidden())
    assert 'policy' in out
    finite = bool(np.isfinite(out['policy']).all())
    print('reload check ok; policy shape %s, finite %s, device %s'
          % (tuple(out['policy'].shape), finite, device))
    return 0 if finite else 1


if __name__ == '__main__':
    sys.exit(main())
