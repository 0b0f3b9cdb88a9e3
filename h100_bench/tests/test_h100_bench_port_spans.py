"""The readers of the port's own spans (harness/port_spans.py and the eight
`program_span` metrics that read it): each reads a synthetic RunRecord and
returns None without its data; the drain keeps the traced window's spans;
idle gaps are named by the innermost span that holds their middle, nested
spans included.  On the card (`cuda`): a port span and the profiler's
kernel times share one clock."""

import time

import pytest

from h100_bench.harness import port_spans, spec
from h100_bench.harness.record import RunRecord
from h100_bench.harness.trace import Trace

NEW = {  # metric -> its value on the synthetic records below
    "forward_host_ms.train": 30.0, "backward_host_ms.train": 20.0,
    "optimizer_host_ms.train": 6.0, "host_syncs_per_step.train": 3.5,
    "attn_tile_path_share.train": 75.0,
    "upload_ms.infer": 2.0, "forward_host_ms.infer": 10.0, "host_syncs_per_group.infer": 1.5,
}


def _record(kind, cuda=True):
    trace = Trace(device=[], spans=[], start=100.0, end=101.0,
                  kernels=[(100.1, 100.2, "k")] if cuda else [])
    return RunRecord(kind=kind, setup_s=1.0, window_s=1.0, steps=2, items_per_step=2,
                     peak_window_bytes=0, forward_flops_per_item=1.0, peak_flops=1.0,
                     trace=trace, traced_steps=2)


def _train_spans():
    """Two train steps of 100 ms at 100.1 s and 100.3 s."""
    spans = []
    for k in range(2):
        t = 100.1 + 0.2 * k
        top = len(spans)
        spans += [(t, t + 0.1, "train_step", -1, None),
                  (t, t + 0.03, "train.forward", top, None),
                  (t + 0.01, t + 0.011, "epipolar.attention", top + 1, 1.0),
                  (t + 0.03, t + 0.031, "train.optimizer", top, None),
                  (t + 0.031, t + 0.051, "train.backward", top, None),
                  (t + 0.04, t + 0.041, "epipolar.attention_backward", top + 4, 2.0),
                  (t + 0.051, t + 0.056, "train.optimizer", top, None)]
    counters = {(1, "host_syncs"): 2, (4, "host_syncs"): 1, (8, "host_syncs"): 4,
                (-1, "host_syncs"): 50,  # outside every step: not counted
                (-1, "attn.forward_tiles.tile_path"): 40,
                (-1, "attn.forward_tiles.per_query_path"): 20,
                (-1, "attn.backward_tiles.tile_path"): 50,
                (-1, "attn.backward_tiles.per_query_path"): 10}
    return port_spans.PortSpans(spans, counters, "train_step")


def _infer_spans():
    spans = []
    for k in range(2):
        t = 100.1 + 0.2 * k
        top = len(spans)
        spans += [(t, t + 0.015, "eval_step", -1, None),
                  (t, t + 0.002, "eval.upload", top, None),
                  (t + 0.002, t + 0.012, "eval.forward", top, None),
                  (t + 0.015, t + 0.016, "eval.fetch", -1, None),
                  (t + 0.02, t + 0.024, "eval.process_group", -1, None)]
    counters = {(0, "host_syncs"): 1, (3, "host_syncs"): 1, (9, "host_syncs"): 1,
                (-1, "host_syncs"): 9}
    return port_spans.PortSpans(spans, counters, "eval_step")


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_reader_reads_a_synthetic_record(name):
    kind = "train" if name.endswith(".train") else "infer"
    run = _record(kind)
    port_spans.attach(run, _train_spans() if kind == "train" else _infer_spans())
    assert spec.reader(name).read(run) == pytest.approx(NEW[name])


@pytest.mark.parametrize("name", sorted(NEW))
def test_each_new_reader_returns_none_without_its_data(name):
    kind = "train" if name.endswith(".train") else "infer"
    reader = spec.reader(name)
    run = _record(kind)
    port_spans.attach(run, None)  # a program without the port's spans
    assert reader.read(run) is None
    other = _record("infer" if kind == "train" else "train")  # the other kind of cell
    port_spans.attach(other, _train_spans() if kind == "infer" else _infer_spans())
    assert reader.read(other) is None
    empty = _record(kind)
    port_spans.attach(empty, port_spans.PortSpans([], {}, port_spans.STEP_SPAN[kind]))
    assert reader.read(empty) is None


@pytest.mark.parametrize("name", ["host_syncs_per_step.train", "host_syncs_per_group.infer"])
def test_cuda_only_readers_return_none_on_a_cpu_record(name):
    kind = "train" if name.endswith(".train") else "infer"
    run = _record(kind, cuda=False)
    spans = _train_spans() if kind == "train" else _infer_spans()
    port_spans.attach(run, spans)
    assert spec.reader(name).read(run) is None


def test_the_drain_keeps_the_traced_windows_spans():
    tracing = pytest.importorskip("epipolar_transformers_tpu_torch.utils.tracing")
    tracing.disable()
    tracing.drain()
    tracing.enable()
    with tracing.span("before_the_window"):
        pass
    start = time.time_ns() / 1e9
    for _ in range(2):
        with tracing.step("train_step"):
            with tracing.span("train.forward"):
                tracing.count("host_syncs")
    end = time.time_ns() / 1e9
    run = _record("train")
    run.trace.start, run.trace.end = start, end
    try:
        got = port_spans.of(run)
    finally:
        tracing.disable()
        tracing.drain()
    assert not tracing.enabled()
    assert [(s[2], s[3]) for s in got.spans] == [("train_step", -1), ("train.forward", 0),
                                                 ("train_step", -1), ("train.forward", 2)]
    assert got.steps == 2 and got.counted("host_syncs", ["train_step"]) == 2
    assert port_spans.of(run) is got  # drained once


def test_idle_gaps_named_by_the_innermost_span():
    spans = [(0.0, 10.0, "bench.train_step"),  # the harness's
             (0.0, 9.0, "train_step"), (1.0, 4.0, "train.forward"),
             (2.0, 3.0, "epipolar.attention"), (5.0, 8.0, "train.backward")]
    gaps = [(2.2, 2.4),    # inside the attention, three deep
            (3.5, 3.7),    # after the attention ended, in its parent
            (4.4, 4.6),    # after a child ended, in the step
            (6.0, 6.5),    # in the backward
            (9.2, 9.4),    # the harness's span alone
            (10.5, 11.0)]  # outside every span
    named = dict(port_spans.idle_by_innermost_span(gaps, spans))
    assert named == pytest.approx({"epipolar.attention": 0.2, "train.forward": 0.2,
                                   "train_step": 0.2, "train.backward": 0.5,
                                   "bench.train_step": 0.2, "other": 0.5})


def test_idle_gaps_of_a_trace():
    trace = Trace(device=[(0.5, 1.0, "a"), (0.8, 2.0, "b"), (3.0, 3.5, "c")], spans=[],
                  start=0.0, end=4.0)
    assert port_spans.idle_gaps(trace) == [(0.0, 0.5), (2.0, 3.0), (3.5, 4.0)]
    assert dict(trace.idle_gaps()) == pytest.approx(
        dict(port_spans.idle_by_innermost_span(port_spans.idle_gaps(trace), [])))


@pytest.mark.cuda
def test_a_port_span_and_the_profilers_kernels_share_one_clock():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile

    from epipolar_transformers_tpu_torch.utils import tracing

    from h100_bench.harness.trace import from_profiler

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.enable()
        time.sleep(0.05)  # an idle device
        with tracing.span("sleep", device=True):
            torch.cuda._sleep(10_000_000)
            torch.cuda.synchronize()
        tracing.disable()
    spans, _ = tracing.drain()
    every = from_profiler(prof, 0.0, float("inf"), []).kernels
    kernels = [k for k in every if "spin_kernel" in k[2]]  # torch.cuda._sleep's
    assert len(kernels) == 1 and len(spans) == 1, [k[2] for k in every]
    start, end = spans[0].start_ns / 1e9, spans[0].end_ns / 1e9
    assert start <= kernels[0][0] <= end
    assert kernels[0][0] - start < 1e-3
