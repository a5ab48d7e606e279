"""Model wrapper: a torch module on an explicit device, with a numpy edge.

The port of ``handyrl_tpu/model.py``. A "model" is an ``nn.Module`` from the
port's zoo placed on one device; the wrapper presents the numpy-in /
numpy-out single-sample ``inference`` and the batched ``batch_inference``
the generators and the inference engine call. Snapshots are data: the
architecture name, its non-default config, and the flax-shaped param tree
(``params_to_flax`` / ``params_from_flax``) in the bytes flax's
``to_bytes`` gives (``utils/flax_msgpack.py``), never pickled code, so that
either package loads the other's snapshots.

The device defaults to ``'cuda'``; without a CUDA device the caller must
ask for ``'cpu'`` explicitly, or the wrapper raises.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from . import models as model_zoo
from .ops import launches
from .utils import flax_msgpack
from .utils.tree import map_structure


def resolve_device(device: Any = 'cuda') -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that torch cannot see
    raises instead of quietly running on the host."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'device %r requested but torch sees no CUDA device; pass '
            "device='cpu' to run on the host" % (str(device),))
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError('unsupported device %r' % (str(device),))
    return dev


def param_trees(module):
    """(to_flax, from_flax) for the module's architecture: its params (or
    a mapping of its parameter names to tensors) to the flax param tree of
    numpy arrays, and back to a state dict of CPU tensors."""
    if model_zoo.architecture_name(module) == 'GeeseNet':
        from .models.geese import params_from_flax, params_to_flax
        return params_to_flax, params_from_flax
    raise KeyError('no snapshot format for %s'
                   % model_zoo.architecture_name(module))


def params_bytes(module: torch.nn.Module, params=None) -> bytes:
    """The module's params, or ``params`` (a mapping of its parameter names
    to tensors), as the flax param tree in flax's ``to_bytes`` layout: the
    bytes of the JAX package's ``ModelWrapper.params_bytes`` and its
    learner checkpoints."""
    to_flax, _ = param_trees(module)
    return flax_msgpack.to_bytes(to_flax(module if params is None
                                         else params))


def load_params_bytes(module: torch.nn.Module, raw: bytes) -> None:
    """Load :func:`params_bytes` (of either package) into ``module``."""
    _, from_flax = param_trees(module)
    module.load_state_dict(from_flax(flax_msgpack.from_bytes(raw)))


class ModelWrapper:
    """Holds a module on ``device``; numpy in, numpy out."""

    def __init__(self, module: torch.nn.Module, device: Any = 'cuda'):
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()

    def init_hidden(self, batch_shape=None):
        return self.module.init_hidden(batch_shape)

    def _to_device(self, x):
        return map_structure(
            lambda v: None if v is None
            else torch.as_tensor(np.asarray(v), device=self.device), x)

    @torch.no_grad()
    def batch_inference(self, obs, hidden=None) -> Dict[str, Any]:
        """Batched path: the leading batch dim is already present. Returns
        numpy arrays (None outputs dropped). Holds ``launches.capture_lock``
        from the upload to the copy back, so it never runs while another
        thread captures a CUDA graph."""
        with launches.capture_lock:
            return self._forward_to_host(obs, hidden)

    def _forward_to_host(self, obs, hidden):
        # every device tensor of the call is freed by the time it returns
        outputs = self.module(self._to_device(obs), self._to_device(hidden))
        return {k: map_structure(lambda t: t.cpu().numpy(), v)
                for k, v in outputs.items() if v is not None}

    def inference(self, obs, hidden=None) -> Dict[str, Any]:
        """Single sample: the batch dim is added and removed here."""
        obs_b = map_structure(
            lambda v: None if v is None else np.asarray(v)[None], obs)
        hidden_b = None if hidden is None else map_structure(
            lambda v: np.asarray(v)[None], hidden)
        outputs = self.batch_inference(obs_b, hidden_b)
        return {k: map_structure(lambda a: a[0], v)
                for k, v in outputs.items()}

    # -- wire format ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Architecture name + non-default constructor config + the
        flax-shaped param tree as flax's ``to_bytes`` writes it."""
        snap = {'architecture': model_zoo.architecture_name(self.module),
                'params': params_bytes(self.module)}
        config = self.module.config()
        if config:
            snap['config'] = config
        return snap

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any],
                      device: Any = 'cuda') -> 'ModelWrapper':
        """Rebuild a model on ``device`` from :meth:`snapshot` data of
        either package (the port's older snapshots too)."""
        dev = resolve_device(device)
        name = snap['architecture']
        module = model_zoo.build(name, **model_zoo.snapshot_config(
            name, snap.get('config') or {}))
        load_params_bytes(module, snap['params'])
        return cls(module, dev)


class RandomModel:
    """Non-parametric stand-in: replays zero outputs shaped like a probe
    inference, which after legal-action masking yields uniform random
    play."""

    def __init__(self, wrapper: ModelWrapper, example_obs):
        probe = wrapper.inference(example_obs, wrapper.init_hidden())
        self.output_dict = {k: np.zeros_like(v) for k, v in probe.items()
                            if k != 'hidden'}

    def init_hidden(self, batch_shape=None):
        return None

    def inference(self, *args, **kwargs):
        return self.output_dict

