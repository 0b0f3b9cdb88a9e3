"""A step run as one replayed CUDA graph: the one capture policy
(`OneGraph`) of the train step (engine/trainer.py) and the eval forward
(engine/tester.py)."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from .. import parallel
from ..models.lifting import Dropout
from ..ops import epipolar_attention_cuda as attn
from ..utils import tracing


def signature(inputs: Dict[str, torch.Tensor]) -> Optional[tuple]:
    """What a graph is captured for: the keys and each tensor's shape,
    dtype, strides and device; None with a value that is not a tensor."""
    if not all(isinstance(v, torch.Tensor) for v in inputs.values()):
        return None
    return tuple((k, v.shape, v.dtype, v.stride(), v.device) for k, v in inputs.items())


def on_cuda(inputs: Dict[str, torch.Tensor]) -> bool:
    return all(v.is_cuda for v in inputs.values())


def graphable(model: torch.nn.Module, inputs: Dict[str, torch.Tensor]) -> bool:
    """Whether a replay would do all that a call of `model` does: every
    input on CUDA, no process group (inside `parallel.alone()` a rank runs
    as one process) and no DistributedDataParallel (its reducer runs on the
    host), tracing off, and no Python that runs per call inside the model
    (a module or global hook; training-mode dropout drawing from its
    generator)."""
    hooks = torch.nn.modules.module
    if not (on_cuda(inputs) and not parallel.distributed()
            and not isinstance(model, DistributedDataParallel) and not tracing.enabled()
            and not (hooks._global_forward_hooks or hooks._global_forward_pre_hooks
                     or hooks._global_backward_hooks or hooks._global_backward_pre_hooks)):
        return False
    return not any(m._forward_hooks or m._forward_pre_hooks or m._backward_hooks
                   or m._backward_pre_hooks
                   or (m.training and isinstance(m, (Dropout, torch.nn.Dropout)) and m.p)
                   for m in model.modules())


def clone(out):
    """`out` (tensors in dicts, tuples and lists) with every tensor cloned."""
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(clone(v) for v in out)
    return out


class Graph:
    """`body(inputs)` as a CUDA graph, captured on a side stream
    (`torch.cuda.graph`) over static copies of the inputs made with their
    strides; every intermediate and output lives in the graph's private
    pool.  The attention's launch counts (ops/epipolar_attention_cuda.py),
    which its wrapper keeps on the host, advance by the capture's on every
    replay: the capture ran the wrapper's Python and no kernel, a replay the
    kernels and no Python."""

    def __init__(self, inputs: Dict[str, torch.Tensor], body: Callable):
        self.inputs = {k: torch.empty_like(v) for k, v in inputs.items()}
        counted = attn.LAUNCHES, attn.BACKWARD_LAUNCHES
        self.graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph empties the allocator's cache as it enters, so
        # the graph's pool takes the place of the eager calls' blocks
        with torch.cuda.graph(self.graph):
            self.outputs = body(self.inputs)
        self.launches = attn.LAUNCHES - counted[0], attn.BACKWARD_LAUNCHES - counted[1]
        attn.LAUNCHES, attn.BACKWARD_LAUNCHES = counted

    def __call__(self, inputs: Dict[str, torch.Tensor]):
        """The inputs copied in, a replay, and the outputs cloned."""
        for k, v in inputs.items():
            self.inputs[k].copy_(v)
        self.graph.replay()
        attn.LAUNCHES += self.launches[0]
        attn.BACKWARD_LAUNCHES += self.launches[1]
        return clone(self.outputs)


class OneGraph:
    """The one graph that a step keeps.  A call whose key (the `signature`
    of its inputs, and what else the step puts in it) is the held graph's
    replays it and counts `counter` (utils/tracing.py), inside `span` if
    one is given, then calls `replayed`.  A call with another key runs
    `eager`, unless it repeats the key of the call before it, which ran
    eagerly and so warmed up cuDNN, the attention's scratch and adam's
    state, and `graphable(inputs)` says a replay would do all that the call
    does: then the old graph is dropped, its pool freed, and that call
    captures `body` ((static inputs) -> outputs, run once, at the capture)
    as a new `Graph` and replays it.  A replay enqueues a copy of each
    input, the graph and a clone of each output, where the eager call
    enqueued its kernels one by one."""

    def __init__(self, body: Callable, eager: Callable, graphable: Callable[..., bool],
                 counter: str, span: Optional[str] = None,
                 replayed: Callable[[], None] = lambda: None):
        self.body, self.eager, self.graphable = body, eager, graphable
        self.counter, self.span, self.replayed = counter, span, replayed
        self.graph, self.key = None, None  # the captured body and its key
        self.previous = None  # the last call's key

    def __call__(self, key, inputs: Dict[str, torch.Tensor], stale: bool = False):
        """One call with `key` (None: never captured); `stale` drops the
        held graph even where the key is its own (a repeated key captures
        anew)."""
        repeated, self.previous = key is not None and key == self.previous, key
        if self.graph is None or key != self.key or stale:
            if not (repeated and self.graphable(inputs)):
                return self.eager(inputs)
            self.graph = None  # its pool is freed before the new capture
            self.graph, self.key = Graph(inputs, self.body), key
        with tracing.span(self.span) if self.span else contextlib.nullcontext():
            tracing.count(self.counter)
            out = self.graph(inputs)
            self.replayed()
            return out
