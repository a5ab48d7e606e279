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


def build(name: str, **kwargs):
    if name not in _REGISTRY:
        # lazily import the built-in model modules, which self-register
        from . import geese  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError('architecture %r is not ported' % (name,))
    return _REGISTRY[name](**kwargs)


def architecture_name(module) -> str:
    return type(module).__name__
