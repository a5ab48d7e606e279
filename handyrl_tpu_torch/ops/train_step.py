"""The SGD update step.

The port of ``handyrl_tpu/ops/train_step.py:25-136``: forward, targets,
losses, gradients, global-norm clip at 4.0, additive weight decay 1e-5,
Adam, parameter update, with the learning rate a runtime 0-d tensor. The
state is functional, as in the JAX package: ``update(state, batch, lr)``
returns a new :class:`TrainState` and leaves the old one as it was, and the
net runs on the state's parameters through ``torch.func.functional_call``.

:func:`build_graphed_update_step` runs the same step as one CUDA graph on
static buffers, updated in place: the port's counterpart of the JAX
package's jitted step with its donated state (train_step.py:174 there).

A ``norm_kind='batch'`` net's running averages ride in ``params`` beside
the parameters, by their buffer names, as the JAX package keeps its
``batch_stats`` collection in the variables: Adam's moments cover the
parameters alone (``opt_state.mu``'s names), the averages advance by the
training forward's EMA (``ops/losses.py``), and a non-finite step keeps
the old ones.

With ``cfg.target_clip`` > 0 the step takes the IMPACT target network's
parameters (``ops/losses.py``; train_step.py:60-80 there): an argument of
:func:`build_update_step`'s ``update``, and in :class:`StaticUpdateStep`
and the graph that captures it static buffers of their own, never updated
by the step, refreshed by :meth:`StaticUpdateStep.sync_target` with
``copy_`` (so a sync is no new capture), and never part of the state a
checkpoint holds.

The optimizer is written out on tensors, because ``torch.optim.Adam`` and
``clip_grad_norm_`` compute other numbers than the optax chain
``clip_by_global_norm(4.0) -> add_decayed_weights(1e-5) -> scale_by_adam()``
(torch clips by ``max_norm / (norm + 1e-6)`` and keeps no separate decay
step), and because the non-finite guard has to keep the moments and the
step count of a bad step as well as the parameters. The guard decides on
the device, with no host sync.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..models.blocks import batch_stats_sink, collect_batch_stats
from .device_windows import unflatten_window_keys
from .graphs import CapturedCall, CountedGraph
from .losses import LossConfig, compute_loss

Tensor = torch.Tensor

CLIP_NORM = 4.0
WEIGHT_DECAY = 1e-5
B1, B2, EPS, EPS_ROOT = 0.9, 0.999, 1e-8, 0.0


class AdamState(NamedTuple):
    """optax ``ScaleByAdamState`` over the net's parameters by name."""
    count: Tensor            # int32 0-d
    mu: Dict[str, Tensor]
    nu: Dict[str, Tensor]


class TrainState(NamedTuple):
    # the parameters and a 'batch' net's running averages (its buffers)
    params: Dict[str, Tensor]
    opt_state: AdamState
    steps: Tensor            # int32 0-d


def init_train_state(module: torch.nn.Module) -> TrainState:
    """The module's parameters and buffers (detached copies) with zero
    Adam moments over the parameters."""
    trainable = {k: v.detach().clone() for k, v in module.named_parameters()}
    params = dict(trainable)
    params.update((k, v.detach().clone()) for k, v in module.named_buffers())
    dev = next(iter(params.values())).device
    return TrainState(
        params=params,
        opt_state=AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu={k: torch.zeros_like(v) for k, v in trainable.items()},
            nu={k: torch.zeros_like(v) for k, v in trainable.items()}),
        steps=torch.zeros((), dtype=torch.int32, device=dev))


def split_batch_stats(params: Dict[str, Tensor], opt: AdamState):
    """(the parameters Adam updates, the running averages or None): the
    port's ``split_batch_stats``, by Adam's names."""
    stats = {k: v for k, v in params.items() if k not in opt.mu}
    return {k: params[k] for k in opt.mu}, (stats or None)


def global_norm(tensors) -> Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def init_hidden_for(module: torch.nn.Module, batch: Dict[str, Any]):
    """The recurrent state a window starts from, (B, P) zeros of the
    module's ``init_hidden``, B and P read from ``batch['value']``; None
    for a feed-forward net (the JAX package's ``init_hidden_for``)."""
    value = batch['value']
    return module.init_hidden((value.shape[0], value.shape[2]))


def _step_math(apply_fn: Callable, cfg: LossConfig, params: Dict[str, Tensor],
               opt: AdamState, batch: Dict[str, Any], lr: Tensor,
               hidden=None, target: Optional[Dict[str, Tensor]] = None
               ) -> Tuple[Dict[str, Tensor], AdamState, Dict[str, Tensor]]:
    """One step's math at ``params``, leaves that require grad (and a
    'batch' net's running averages, which do not): forward (from
    ``hidden``, a recurrent net's state at the windows' start), targets
    (through the IMPACT ``target`` parameters where given), losses,
    grads, clip, decay, Adam and the guard. Returns the new parameters
    (and running averages), the new Adam state and the metrics, as new
    tensors (``params``, ``opt`` and ``target`` are only read)."""
    names = list(opt.mu)
    trainable, stats = split_batch_stats(params, opt)
    total, aux = compute_loss(apply_fn, trainable, hidden, batch, cfg,
                              batch_stats=stats, target_params=target)
    grads = dict(zip(names, torch.autograd.grad(
        total, [params[k] for k in names])))
    with torch.no_grad():
        grad_norm = global_norm(grads.values())
        ok = (torch.isfinite(lr) & torch.isfinite(total.detach())
              & torch.isfinite(grad_norm))
        # clip_by_global_norm: g if norm < 4 else g / norm * 4
        trigger = grad_norm < CLIP_NORM
        count = opt.count + 1          # int32, as optax's safe_increment
        bc1 = 1 - B1 ** count.float()
        bc2 = 1 - B2 ** count.float()
        new_params, mu, nu = {}, {}, {}
        for k in names:
            p, g = params[k], grads[k]
            g = torch.where(trigger, g, g / grad_norm * CLIP_NORM)
            g = g + WEIGHT_DECAY * p                 # add_decayed_weights
            m = (1 - B1) * g + B1 * opt.mu[k]        # scale_by_adam
            v = (1 - B2) * g ** 2 + B2 * opt.nu[k]
            u = (m / bc1) / (torch.sqrt(v / bc2 + EPS_ROOT) + EPS)
            new_params[k] = torch.where(ok, p + (-lr * u), p)
            mu[k] = torch.where(ok, m, opt.mu[k])
            nu[k] = torch.where(ok, v, opt.nu[k])
        for k, old in (stats or {}).items():
            new_params[k] = torch.where(ok, aux['batch_stats'][k], old)
        new_opt = AdamState(count=torch.where(ok, count, opt.count),
                            mu=mu, nu=nu)
        metrics = {k: v.detach() for k, v in aux['losses'].items()}
        metrics['data_count'] = aux['data_count']
        for k, v in aux['diag'].items():
            metrics['diag_' + k] = v
        metrics['diag_grad_norm'] = grad_norm
        metrics = {k: torch.where(ok, v, torch.zeros_like(v))
                   for k, v in metrics.items()}
        metrics['nonfinite'] = 1.0 - ok.float()
    return new_params, new_opt, metrics


def _apply_fn(module: torch.nn.Module) -> Callable:
    """``apply_fn(params, obs, hidden)`` runs the module on ``params`` in
    inference mode; with ``batch_stats`` (its running averages by buffer
    name) in training mode (``train=True``, whatever ``module.training``
    says), returning ``(outputs, advanced running averages)``."""
    def apply_fn(params, obs, hidden, batch_stats=None):
        if batch_stats is None:
            return functional_call(module, params, (obs, hidden))
        with batch_stats_sink() as sink:
            out = functional_call(module, {**params, **batch_stats},
                                  (obs, hidden), {'train': True})
        return out, collect_batch_stats(module, sink)
    return apply_fn


def build_update_step(module: torch.nn.Module, cfg: LossConfig
                      ) -> Callable[..., Tuple[TrainState,
                                               Dict[str, Tensor]]]:
    """Returns ``update(state, batch, lr, target_params=None) -> (state,
    metrics)``; ``target_params`` (a copy of ``state.params``, the IMPACT
    target's) counts with ``cfg.target_clip`` > 0.

    ``metrics`` holds the per-term loss sums, the turn count of the batch
    (``data_count``), the ``diag_*`` off-policy diagnostics and
    ``diag_grad_norm`` (the norm before the clip), all 0-d tensors on the
    device; a step that met a non-finite lr, loss or gradient reports them
    as zeros and ``nonfinite`` 1, and keeps the parameters and the
    optimizer state, Adam's count included. ``steps`` advances either way.
    """
    apply_fn = _apply_fn(module)

    def update(state: TrainState, batch: Dict[str, Any], lr: Tensor,
               target_params: Optional[Dict[str, Tensor]] = None
               ) -> Tuple[TrainState, Dict[str, Tensor]]:
        live = {k: v.detach().requires_grad_(k in state.opt_state.mu)
                for k, v in state.params.items()}
        params, opt, metrics = _step_math(apply_fn, cfg, live,
                                          state.opt_state, batch, lr,
                                          init_hidden_for(module, batch),
                                          target_params)
        return (TrainState(params=params, opt_state=opt,
                           steps=state.steps + 1), metrics)

    return update


# ------------------------------------------ the step on static buffers

# eager steps of the body before a capture (their state changes undone)
GRAPH_WARMUP_STEPS = 3


def _signature(batch: Dict[str, Tensor]) -> Tuple:
    """The shape and dtype of every batch leaf, by name."""
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(batch.items()))


class StaticUpdateStep:
    """The update step on buffers that live as long as the object: the
    parameters (leaves that require grad), Adam's moments and count,
    ``steps``, the learning rate and, for each batch signature (the shape
    and dtype of every batch leaf), the batch: a flat dict of tensors,
    a dict observation's leaves under '.' keys (``ops.device_windows.
    flatten_window_keys``). Each call copies the batch
    and ``lr`` into them, runs :func:`build_update_step`'s math, writes the
    new state back in place and returns the metrics, copied out of one
    packed tensor. The body runs on any device; :class:`GraphedUpdateStep`
    captures it as a CUDA graph.

    With ``cfg.target_clip`` > 0 the IMPACT target's parameters are
    buffers of their own (:attr:`target`), a copy of the state's at
    construction, read by every step and written only by
    :meth:`sync_target`."""

    def __init__(self, module: torch.nn.Module, cfg: LossConfig,
                 state: TrainState):
        self._apply = _apply_fn(module)
        self._module = module
        self._cfg = cfg
        self._device = state.steps.device

        def own(t):
            return t.detach().clone()
        opt = state.opt_state
        self._params = {k: own(v).requires_grad_(k in opt.mu)
                        for k, v in state.params.items()}
        self._opt = AdamState(count=own(opt.count),
                              mu={k: own(v) for k, v in opt.mu.items()},
                              nu={k: own(v) for k, v in opt.nu.items()})
        self._steps = own(state.steps)
        self._lr = torch.zeros((), dtype=torch.float32, device=self._device)
        self._batches: Dict[Tuple, Dict[str, Tensor]] = {}
        self.metric_names: Tuple[str, ...] = ()
        self.target: Optional[Dict[str, Tensor]] = None
        if cfg.target_clip > 0:
            self.target = {k: own(v) for k, v in state.params.items()}
            self.target_syncs = 0

    def sync_target(self) -> None:
        """Copy the live parameters (and running averages) into the
        target's buffers, in place: a captured graph reads the new target
        on its next replay, with no new capture."""
        if self.target is None:
            raise RuntimeError('sync_target: the step has no target network '
                               '(target_clip is 0)')
        with torch.no_grad():
            for k, t in self.target.items():
                t.copy_(self._params[k])
        self.target_syncs += 1

    @property
    def state(self) -> TrainState:
        """The state as a :class:`TrainState` of views of the buffers: the
        next call changes what they hold."""
        return TrainState(params={k: v.detach()
                                  for k, v in self._params.items()},
                          opt_state=self._opt, steps=self._steps)

    def load_state(self, state: TrainState) -> None:
        """Copies ``state`` (on any device) into the buffers, in place, so
        a captured graph goes on reading them. Raises, changing nothing,
        unless its parameters have the buffers' names and shapes."""
        for name, mine, theirs in (
                ('params', self._params, state.params),
                ('mu', self._opt.mu, state.opt_state.mu),
                ('nu', self._opt.nu, state.opt_state.nu)):
            if set(mine) != set(theirs) or any(
                    mine[k].shape != theirs[k].shape for k in mine):
                raise ValueError('load_state: %s do not match the step\'s '
                                 'parameters' % name)
        with torch.no_grad():
            for k, p in self._params.items():
                p.copy_(state.params[k])
            for k in self._opt.mu:
                self._opt.mu[k].copy_(state.opt_state.mu[k])
                self._opt.nu[k].copy_(state.opt_state.nu[k])
            self._opt.count.copy_(state.opt_state.count)
            self._steps.copy_(state.steps)

    def _load(self, batch: Dict[str, Any], lr: Tensor) -> Tuple:
        """Copies ``batch`` and ``lr`` into the buffers (allocated on a
        signature's first call); returns the batch's signature."""
        for k, v in batch.items():
            if not isinstance(v, torch.Tensor):
                raise TypeError('the static update step takes a flat dict of '
                                'tensors; %s is %s' % (k, type(v).__name__))
            if v.device != self._device:
                raise ValueError('batch[%r] is on %s, the step on %s'
                                 % (k, v.device, self._device))
        key = _signature(batch)
        static = self._batches.get(key)
        if static is None:
            static = self._batches[key] = {k: torch.empty_like(v)
                                           for k, v in batch.items()}
        for k, v in batch.items():
            static[k].copy_(v)
        self._lr.copy_(lr)
        return key

    def _body(self, batch: Dict[str, Tensor]) -> Tensor:
        """One step on the buffers; returns the metrics packed in
        :attr:`metric_names` order."""
        batch = unflatten_window_keys(batch)
        params, opt, metrics = _step_math(
            self._apply, self._cfg, self._params, self._opt, batch, self._lr,
            init_hidden_for(self._module, batch), self.target)
        with torch.no_grad():
            for k, p in self._params.items():
                p.copy_(params[k])
            for k in self._opt.mu:
                self._opt.mu[k].copy_(opt.mu[k])
                self._opt.nu[k].copy_(opt.nu[k])
            self._opt.count.copy_(opt.count)
            self._steps.add_(1)
            if not self.metric_names:
                self.metric_names = tuple(metrics)
            return torch.stack([metrics[k].float()
                                for k in self.metric_names])

    def _unpack(self, packed: Tensor) -> Dict[str, Tensor]:
        return dict(zip(self.metric_names, packed.clone().unbind()))

    def __call__(self, batch: Dict[str, Any], lr: Tensor
                 ) -> Dict[str, Tensor]:
        return self._unpack(self._body(self._batches[self._load(batch, lr)]))


class GraphedUpdateStep(StaticUpdateStep):
    """:class:`StaticUpdateStep` as one CUDA graph per batch signature,
    the port's counterpart of the JAX package's jitted step: captured on
    the signature's first call, after :data:`GRAPH_WARMUP_STEPS` eager
    steps of the body on a side stream (they build and load the kernels
    and create cuBLAS's handles; the state is put back after them), then
    replayed, one launch a step. A capture or replay failure raises; there
    is no eager fallback (:func:`build_update_step` is the step for the
    CPU).

    Each graph is an ``ops.graphs.CountedGraph``: its warm-up and capture
    hold ``launches.capture_lock``, and the launches its wrappers counted
    during the capture are added again on every replay, so
    ``kernel_launches()`` stays a count of kernels run. That replays run
    them is shown by the profiler (chip_smoke.py's training phase)."""

    def __init__(self, module: torch.nn.Module, cfg: LossConfig,
                 state: TrainState):
        devices = {t.device.type for t in list(module.parameters())
                   + list(state.params.values()) + [state.steps]}
        if devices != {'cuda'}:
            raise ValueError('a CUDA graph of the update step needs the '
                             'module and the state on a CUDA device, got %s; '
                             'build_update_step runs on the CPU'
                             % sorted(devices))
        super().__init__(module, cfg, state)
        # signature -> its graph (its output, the packed metrics)
        self._graphs: Dict[Tuple, CountedGraph] = {}

    @property
    def captures(self) -> int:
        """Graphs captured so far (one a batch signature)."""
        return len(self._graphs)

    def _capture(self, key: Tuple) -> CountedGraph:
        batch = self._batches[key]
        side = torch.cuda.Stream(self._device)

        def warmup():
            # eager steps on the side stream, then the state put back
            cur = torch.cuda.current_stream(self._device)
            saved = [t.detach().clone() for t in self._buffers()]
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(GRAPH_WARMUP_STEPS):
                    self._body(batch)
            cur.wait_stream(side)
            with torch.no_grad():
                for t, s in zip(self._buffers(), saved):
                    t.copy_(s)
        self._graphs[key] = CountedGraph(lambda: self._body(batch), side,
                                         warmup=warmup)
        return self._graphs[key]

    def _buffers(self):
        opt = self._opt
        return (list(self._params.values()) + list(opt.mu.values())
                + list(opt.nu.values()) + [opt.count, self._steps])

    def __call__(self, batch: Dict[str, Any], lr: Tensor
                 ) -> Dict[str, Tensor]:
        key = self._load(batch, lr)
        graph = self._graphs.get(key) or self._capture(key)
        return self._unpack(graph.replay())


class ReplayUpdateStep(StaticUpdateStep):
    """K recency-sampled update steps from the device ring: the port of the
    JAX package's ``build_replay_update`` (train_step.py:191-269 there).

    Each step draws ``batch_size`` slots with ``ops.replay.recency_slots``
    (uniforms from the bound generator, or given), gathers the batch from
    the ring's flat rows (restoring each leaf's window shape), sets the
    learning rate from the device step counter, lr = default_lr *
    data_cnt_ema / (1 + steps * 1e-5), and runs :class:`StaticUpdateStep`'s
    body on it. :meth:`run` returns the metrics summed over the K steps.

    On a CUDA device one step (draw, gather, lr, body, the metrics' running
    sum) is one CUDA graph, replayed K times a call; the first step ever
    runs eagerly (``ops.graphs.CapturedCall``). On the CPU the same
    step runs eagerly. Call :meth:`bind` before :meth:`run`."""

    def __init__(self, module: torch.nn.Module, cfg: LossConfig,
                 state: TrainState, default_lr: float = 3e-8):
        super().__init__(module, cfg, state)
        self.default_lr = float(default_lr)
        dev = self._device
        self._ema = torch.zeros((), dtype=torch.float32, device=dev)
        self._sum = None
        self._given = None
        self._call = None
        # the slots the last step drew (B,), rewritten by every step
        self.last_slots: Optional[Tensor] = None

    def bind(self, ring: Dict[str, Tensor], window_spec: Dict[str, Tuple],
             size: Tensor, cursor: Tensor, capacity: int, batch_size: int,
             generator: Optional[torch.Generator]) -> None:
        """The ring (flat rows a leaf, read in place), its window shapes,
        its 0-d size and cursor tensors (read in place), capacity, B and
        the generator of the slots' uniforms."""
        self._ring, self._spec = ring, window_spec
        self._size, self._cursor = size, cursor
        self.capacity, self.batch_size = int(capacity), int(batch_size)
        self._generator = generator
        self._call = CapturedCall(self._one, self._device,
                                  [generator] if generator is not None
                                  else [])

    def gather(self, slots: Tensor) -> Dict[str, Tensor]:
        """The batch of ring rows ``slots`` (B,), each leaf (B,) + its
        window shape."""
        return {k: rows[slots].reshape((slots.shape[0],) + self._spec[k][0])
                for k, rows in self._ring.items()}

    def _one(self) -> Tensor:
        from .replay import recency_slots
        if self._given is not None:
            slots = self._given
        else:
            u = torch.rand((self.batch_size,), generator=self._generator,
                           device=self._device)
            slots = recency_slots(u, self._size, self._cursor, self.capacity)
        batch = self.gather(slots)
        with torch.no_grad():
            if self.last_slots is None:   # the first step, which runs eagerly
                self.last_slots = torch.empty_like(slots)
            self.last_slots.copy_(slots)
            self._lr.copy_(self._ema * self.default_lr
                           / (1 + self._steps.float() * 1e-5))
        packed = self._body(batch)
        with torch.no_grad():
            if self._sum is None:   # the first step, which runs eagerly
                self._sum = torch.zeros_like(packed)
            self._sum.add_(packed)
        return packed

    def run(self, num_steps: int, data_cnt_ema: float,
            slots: Optional[Tensor] = None) -> Tensor:
        """``num_steps`` steps; returns the metrics summed over them, packed
        in :attr:`metric_names` order (a device tensor that the next call
        rewrites). ``slots`` (num_steps, B), where given, replace the draws
        (the CPU only: a graph's steps draw their own)."""
        if self._call is None:
            raise RuntimeError('ReplayUpdateStep.run before bind')
        if slots is not None and self._device.type == 'cuda':
            raise ValueError('given slots run on the CPU only')
        self._ema.fill_(float(data_cnt_ema))
        if self._sum is not None:
            self._sum.zero_()
        for i in range(num_steps):
            self._given = slots[i] if slots is not None else None
            self._call()
        self._given = None
        return self._sum

    def unpack(self, packed: Tensor) -> Dict[str, Tensor]:
        return self._unpack(packed)


def build_graphed_update_step(module: torch.nn.Module, cfg: LossConfig,
                              state: TrainState) -> GraphedUpdateStep:
    """The update step of :func:`build_update_step` as a CUDA graph on
    static buffers, starting from ``state`` (copied): ``step(batch, lr) ->
    metrics``, with ``step.state`` the state after the last call. ``lr`` is
    a 0-d tensor, copied in on every call, so a schedule needs no new
    capture. Raises unless the module and the state are on a CUDA
    device."""
    return GraphedUpdateStep(module, cfg, state)


# --------------------------------------------- optax layout, in and out

def opt_state_to_flax(opt_state: AdamState, to_flax: Callable
                      ) -> Dict[str, Any]:
    """The Adam state in optax's layout, as numpy: ``{'count': int32,
    'mu': tree, 'nu': tree}`` with the moments as flax param trees
    (``to_flax`` is the net's ``params_to_flax``)."""
    return {'count': np.asarray(opt_state.count.cpu().numpy(), np.int32),
            'mu': to_flax(opt_state.mu), 'nu': to_flax(opt_state.nu)}


def opt_state_from_flax(count, mu_tree, nu_tree, from_flax: Callable,
                        device: Any = 'cpu') -> AdamState:
    """An :class:`AdamState` from optax's ``ScaleByAdamState`` fields
    (``from_flax`` is the net's ``params_from_flax``)."""
    def load(tree):
        return {k: v.to(device) for k, v in from_flax(tree).items()}
    return AdamState(
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
        mu=load(mu_tree), nu=load(nu_tree))
