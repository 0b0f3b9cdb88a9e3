"""Device-side marks around a mechanism, for a profiler's device trace.

A span (utils/tracing.py) is host work: a CUDA graph's replay runs no
Python and opens none.  A mark is an empty named kernel of the port's own
library (csrc/trace_marks.cu) launched on the current stream, so a graph
captures it with the kernels around it and every replay runs it again:
the device trace then shows where a mechanism's forward and backward began
and ended on every step, eager or replayed.  On the CPU a mark launches
nothing.

`enter(mechanism, *tensors)` and `leave(mechanism, *tensors)` are
identity autograd Functions: `enter` marks `<mechanism>_forward_begin` in
the forward and `<mechanism>_backward_end` in the backward (the gradients
of its outputs are the mechanism's last), `leave` marks
`<mechanism>_forward_end` and `<mechanism>_backward_begin`.  Put the
mechanism's inputs through `enter` and its differentiable outputs through
`leave`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

# in csrc/trace_marks.cu's order
MARKS = ("epipolar_pooled_forward_begin", "epipolar_pooled_forward_end",
         "epipolar_pooled_backward_begin", "epipolar_pooled_backward_end",
         "hourglass_fusion_forward_begin", "hourglass_fusion_forward_end",
         "hourglass_fusion_backward_begin", "hourglass_fusion_backward_end")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ._build import load_library

    lib = load_library("trace_marks")
    lib.trace_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.trace_mark.restype = ctypes.c_int
    if lib.trace_mark_count() != len(MARKS):
        raise RuntimeError("csrc/trace_marks.cu and MARKS name different marks")
    return lib


def mark(name: str, device: torch.device) -> None:
    """Issue the mark `name` on `device`'s current stream (nothing on the CPU)."""
    which = MARKS.index(name)
    if device.type == "cuda":
        err = _library().trace_mark(which, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the mark {name} failed: CUDA error {err}")


class _Identity(torch.autograd.Function):
    """`tensors` unchanged (as views), `forward_mark` issued in the forward
    and `backward_mark` in the backward."""

    @staticmethod
    def forward(ctx, forward_mark, backward_mark, *tensors):
        ctx.backward_mark, ctx.device = backward_mark, tensors[0].device
        mark(forward_mark, ctx.device)
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        mark(ctx.backward_mark, ctx.device)
        return (None, None, *grads)


def enter(mechanism: str, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The mechanism's inputs, between its forward's begin and its backward's end."""
    return _Identity.apply(f"{mechanism}_forward_begin", f"{mechanism}_backward_end", *tensors)


def leave(mechanism: str, *tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The mechanism's outputs, between its forward's end and its backward's begin."""
    return _Identity.apply(f"{mechanism}_forward_end", f"{mechanism}_backward_begin", *tensors)
