"""Model zoo of the port.

The registry maps architecture names to constructors so model snapshots
ship as (name, config, params) data, never as pickled code. Names match the
JAX package's, so a snapshot names the same architecture in both.
"""

from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    def deco(ctor):
        _REGISTRY[name] = ctor
        return ctor
    return deco


def _constructor(name: str) -> Callable:
    if name not in _REGISTRY:
        # lazily import the built-in model modules, which self-register
        from . import (connect_four, geese, geister,  # noqa: F401
                       tictactoe, transformer)
    if name not in _REGISTRY:
        raise KeyError('architecture %r is not ported' % (name,))
    return _REGISTRY[name]


def build(name: str, **kwargs):
    return _constructor(name)(**kwargs)


def snapshot_config(name: str, config: Dict) -> Dict:
    """A snapshot's config as keywords of the port's ``name``: the keys the
    port's module lists in ``FOREIGN_CONFIG`` (the JAX module's fields
    that change nothing here, such as the TPU kernel's tiling) are dropped,
    and any key the module's ``DEFAULTS`` do not name raises."""
    ctor = _constructor(name)
    foreign = getattr(ctor, 'FOREIGN_CONFIG', ())
    unknown = [k for k in config if k not in ctor.DEFAULTS
               and k not in foreign]
    if unknown:
        raise ValueError('snapshot config of %s has keys the port does not '
                         'know: %s' % (name, sorted(unknown)))
    return {k: v for k, v in config.items() if k not in foreign}


def architecture_name(module) -> str:
    return type(module).__name__
