"""Export a trained model of the PyTorch port to a self-contained ``.pt2``.

The counterpart of ``scripts/export_model.py``'s default mode for the
port (``handyrl_tpu_torch/export.py``): the checkpoint's net, traced with
``torch.export`` in eval mode without autograd on a batch-1 observation,
its params inside, and for Hungry Geese's GeeseNet the trunk as the
registered CUDA kernel operator ``handyrl_tpu_torch::geese_trunk``.
``--net-kind lstm`` exports a GeeseNetLSTM checkpoint, its hidden state
an input and an output of the program. The export runs on the CPU. A
self-test reloads the file with
``handyrl_tpu_torch.evaluation.ExportedModel`` on the CPU and holds one
inference (and a recurrent net's next hidden state) to the checkpoint's.

Usage: python scripts/torch_export_model.py [--net-kind conv|lstm] ENV
       CKPT_PATH OUT_PATH
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

SELF_TEST_ATOL = 1e-4   # fp32: the traced program and the net, the same math


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('env', nargs='?', default='TicTacToe')
    ap.add_argument('ckpt', nargs='?', default='models/latest.ckpt')
    ap.add_argument('out', nargs='?', default='models/latest.pt2')
    ap.add_argument('--net-kind', default='conv', choices=('conv', 'lstm'))
    a = ap.parse_args(argv)

    import numpy as np
    from handyrl_tpu_torch.evaluation import ExportedModel
    from handyrl_tpu_torch.export import export_env_args, export_model

    info = export_model(export_env_args(a.env, a.net_kind), a.ckpt, a.out)
    print('wrote', info['path'], info['bytes'], 'bytes (K1 operator in the '
          'graph: %s)' % info['kernel_op'])

    # self-test: reload with no net class and run one inference
    model = ExportedModel(a.out, device='cpu')
    out = model.inference(info['obs'], model.init_hidden())
    wrapper = info['wrapper']
    want = wrapper.inference(info['obs'], wrapper.init_hidden())
    if 'hidden' in want:     # the next state, batch axis 1 in the program's
        out.update(zip(('h', 'c'), (h[0] for h in out.pop('hidden'))))
        want.update(zip(('h', 'c'), want.pop('hidden')))
    dev = max(float(np.max(np.abs(out[k] - want[k]))) for k in want)
    if dev > SELF_TEST_ATOL:
        print('self-test failed: max deviation from the checkpoint %.2e, '
              'above %g' % (dev, SELF_TEST_ATOL), file=sys.stderr)
        return 1
    print('reload check ok; outputs %s, max deviation from the checkpoint '
          '%.2e' % (sorted(out), dev))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
