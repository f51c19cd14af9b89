"""The train step captured as one CUDA graph, replayed at device pace.

The JAX package's step is one compiled program (`jax.jit`).  The port's
eager step launches ~6900 device operations from Python, and on the card
the host's launches, not the device, set its pace.  On a card,
make_train_step (train/step.py) returns a `GraphedStep`: the first
WARMUP calls that meet a key run the eager step, the next captures the
whole step (forward, losses, backward and the Adam update) as one
torch.cuda.CUDAGraph, and every later call with that key copies its
batch into the graph's static buffers, writes the consistency ramp into
a 0-d tensor on the card, and replays the graph.

- The key (`graph_key`) is everything that changes which operations a
  step launches: the batch's keys, shapes, dtypes and device, the
  pseudo-label branch epoch < thresh_epoch, the model's bn_groups,
  dropout rates and encoder checkpoint (`remat_encoder`: the backward
  runs the encoder's forward again), the process-wide switches that pick
  kernels (TF32, deterministic algorithms, cuDNN's modes, the BN
  one-pass threshold, the packed uint8 prep), the identity of the
  state's model, optimizer and generator, and the addresses of the
  model's parameters and buffers, which the graph's kernels read and
  write.  A call with another key takes its own graph, or the eager step
  while the key warms up.
- The step stays eager where a replay would skip something: a hook on
  the model, a parameter or any module (a replay fires none), and a
  process group (gloo collectives cannot be captured; NCCL capture is
  not built).
- Values that change without changing the graph reach every replay
  through tensors on the card: the ramp (written before each replay)
  and the learning rate (train/optimizer.py's fused Adam reads its 0-d
  lr tensor, which TrainState.with_learning_rate and load_state_dict
  fill in place).
- The dropout generator is registered with each graph, so a replay
  draws fresh masks and advances the generator as the eager step does:
  eager steps and replays that take turns continue one stream.
- A replay calls no kernel wrapper, so it adds to every launch counter
  what that counter counted during the capture (utils/profiling.py).
- The warm-up steps run on the capture stream, so that everything the
  step initialises per stream (library handles, workspaces), and every
  cache the kernel wrappers fill per geometry (built libraries, plans,
  tap tables, the gather index), is in place before the capture.

At most MAX_GRAPHS graphs live per step function, all in one memory
pool; the least recently used goes first.  Graphs share the pool
safely because they replay one at a time on one stream and each keeps
its own static outputs (the metrics and the gradients) alive.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np
import torch

from picad_tpu_torch.models import layers
from picad_tpu_torch.parallel import mesh
from picad_tpu_torch.utils.profiling import (
    add_launches,
    launch_state,
    launches_between,
    set_launch_state,
)

WARMUP = 2  # eager calls of a key before its capture
MAX_GRAPHS = 4  # e.g. both sides of thresh_epoch, each with a ragged last batch

# what the step reads of a batch (train/step.py prepare_views, _labels)
STEP_KEYS = ("data", "aug_data", "loc_msk", "action", "label_vid", "row_mask")


def step_tensors(batch: dict) -> dict:
    """The batch entries the step reads, as tensors (numpy arrays are
    wrapped, not copied)."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k in STEP_KEYS if (v := batch.get(k)) is not None}


def backend_flags() -> tuple:
    """The process-wide switches that pick which kernels the step runs."""
    from picad_tpu_torch.train import step  # it imports this module

    cudnn = torch.backends.cudnn
    return (torch.backends.cuda.matmul.allow_tf32, cudnn.allow_tf32, cudnn.enabled,
            cudnn.deterministic, cudnn.benchmark, torch.are_deterministic_algorithms_enabled(),
            layers.BN_ONEPASS_MIN, step._PACKED_PREP)


class _Parts(NamedTuple):
    # the model's submodules, not the model: an entry of _PARTS that held
    # its key would keep every model it has seen, and its tensors, alive
    modules: list
    tensors: list  # parameters and buffers


_PARTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _parts(model) -> _Parts:
    """The model's submodules, parameters and buffers, listed once a model."""
    parts = _PARTS.get(model)
    if parts is None:
        parts = _PARTS[model] = _Parts(list(model.modules())[1:],
                                       list(model.parameters()) + list(model.buffers()))
    return parts


def has_hooks(model) -> bool:
    """Whether any hook would run in the step: a global module hook, a
    hook on the model or a submodule, or a hook on a parameter."""
    g = torch.nn.modules.module
    if (g._global_forward_hooks or g._global_forward_pre_hooks or g._global_backward_hooks
            or g._global_backward_pre_hooks):
        return True
    parts = _parts(model)
    return (any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
                or m._backward_pre_hooks for m in (model, *parts.modules))
            or any(t._backward_hooks or getattr(t, "_post_accumulate_grad_hooks", None)
                   for t in parts.tensors))


def graph_key(state, batch: dict, epoch, thresh_epoch) -> tuple | None:
    """What decides which operations a step of `state` on `batch` at
    `epoch` launches, or None where the step must stay eager (a hook or
    a process group)."""
    model = state.model
    if mesh.is_active() or has_hooks(model):
        return None
    batch_sig = tuple((k, tuple(t.shape), t.dtype, t.device)
                      for k, t in step_tensors(batch).items())
    return (id(model), id(state.optimizer), id(state.generator), batch_sig,
            float(epoch) < float(thresh_epoch), model.bn_groups,
            model.dropout_rate, model.drop_enc.rate, model.drop_dec.rate,
            model.remat_encoder, backend_flags(),
            tuple(t.data_ptr() for t in _parts(model).tensors))


class _Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    inputs: dict  # the static batch
    ramp: torch.Tensor  # 0-d f64: the consistency ramp
    names: tuple  # the metrics' names, in the order of `metrics`
    metrics: torch.Tensor  # the metrics, stacked
    grads: list  # (parameter, its static gradient)
    counted: dict  # the launch counts the capture made
    owners: tuple  # model, optimizer, generator: their ids stay theirs


class GraphedStep:
    """make_train_step's step on a card: `step(state, batch, epoch,
    wt_ramp) -> (state, metrics)`, the eager step's contract, replaying
    a CUDA graph per key (see the module docstring).

    `eager_step` is the eager step; `run(state, batch, epoch, wt_ramp)`
    its work without the checks and the step count, returning the
    metrics; `check(state)` its checks.  `captures` and `replays` count
    what the step did."""

    def __init__(self, eager_step: Callable, run: Callable, check: Callable,
                 thresh_epoch: float, device: torch.device):
        self.eager_step, self._run, self._check = eager_step, run, check
        self.thresh_epoch, self.device = thresh_epoch, device
        self.graphs: OrderedDict = OrderedDict()
        self._seen: dict = {}  # key -> eager calls so far
        self.pool = None
        self._stream = None
        self.captures = self.replays = 0

    def __call__(self, state, batch, epoch, wt_ramp):
        key = graph_key(state, batch, epoch, self.thresh_epoch)
        if key is None:
            return self.eager_step(state, batch, epoch, wt_ramp)
        g = self.graphs.get(key)
        if g is None:
            n = self._seen.get(key, 0)
            if n < WARMUP:
                self._seen[key] = n + 1
                return self._on_capture_stream(self.eager_step, state, batch, epoch, wt_ramp)
            g = self._capture(key, state, batch, epoch)
        self.graphs.move_to_end(key)
        return self._replay(g, state, batch, wt_ramp)

    def _capture_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return self._stream

    def _on_capture_stream(self, fn, *args):
        side, cur = self._capture_stream(), torch.cuda.current_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args)
        cur.wait_stream(side)
        return out

    def _capture(self, key, state, batch, epoch) -> _Captured:
        if len(self.graphs) >= MAX_GRAPHS:
            self.graphs.popitem(last=False)
        self._check(state)
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        inputs = {k: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for k, t in step_tensors(batch).items()}
        ramp = torch.zeros((), dtype=torch.float64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        state.optimizer.zero_grad(set_to_none=True)
        before = launch_state()

        def record():
            with torch.cuda.graph(graph, pool=self.pool, stream=self._capture_stream(),
                                  capture_error_mode="thread_local"):
                metrics = self._run(state, inputs, epoch, ramp)
                names = tuple(metrics)
                stacked = torch.stack([metrics[k].detach() for k in names])
            return names, stacked

        try:
            names, stacked = self._on_capture_stream(record)
            counted = launches_between(before, launch_state())
        finally:
            set_launch_state(before)  # the capture launched nothing
        grads = [(p, p.grad) for p in state.model.parameters() if p.grad is not None]
        g = _Captured(graph, inputs, ramp, names, stacked, grads, counted,
                      (state.model, state.optimizer, state.generator))
        self.graphs[key] = g
        self._seen.pop(key, None)
        self.captures += 1
        return g

    def _replay(self, g: _Captured, state, batch, wt_ramp):
        self._check(state)
        for k, t in step_tensors(batch).items():
            g.inputs[k].copy_(t, non_blocking=True)
        if isinstance(wt_ramp, torch.Tensor):
            g.ramp.copy_(wt_ramp)
        else:
            g.ramp.fill_(float(wt_ramp))
        state.model.train()
        g.graph.replay()
        add_launches(g.counted)
        for p, grad in g.grads:
            p.grad = grad
        state.step += 1
        self.replays += 1
        return state, dict(zip(g.names, g.metrics.clone().unbind()))
