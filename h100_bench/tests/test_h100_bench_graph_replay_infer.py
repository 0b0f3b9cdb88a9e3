"""The reader of `graph_replay_share.infer`: the port's eval replay counter
under its `eval_step` spans over those spans, on a synthetic record of one
replayed and one eager view group; None without the port's spans, on a
train record, and for a program that has no eval replay counter."""

import pytest

from epipolar_transformers_tpu_torch.engine import tester
from h100_bench.harness import port_spans, spec
from h100_bench.harness.record import RunRecord
from h100_bench.harness.trace import Trace

NAME = "graph_replay_share.infer"


def _record(kind="infer"):
    trace = Trace(device=[], spans=[], start=100.0, end=101.0, kernels=[(100.1, 100.2, "k")])
    return RunRecord(kind=kind, setup_s=1.0, window_s=1.0, steps=2, items_per_step=4,
                     peak_window_bytes=0, forward_flops_per_item=1.0, peak_flops=1.0,
                     trace=trace, traced_steps=2)


def _spans():
    """A replayed group at 100.1 s, then an eager one at 100.3 s."""
    spans = [(100.1, 100.11, "eval_step", -1, None),
             (100.1, 100.101, "eval.upload", 0, None),
             (100.101, 100.11, "eval.forward", 0, None),
             (100.3, 100.4, "eval_step", -1, None),
             (100.3, 100.301, "eval.upload", 3, None),
             (100.301, 100.4, "eval.forward", 3, None)]
    counters = {(2, tester.GRAPH_REPLAY_EVAL): 1,
                (-1, tester.GRAPH_REPLAY_EVAL): 5}  # outside every group: not counted
    return port_spans.PortSpans(spans, counters, "eval_step")


@pytest.mark.parametrize("replayed", [1, 2])
def test_the_share_of_replayed_groups(replayed):
    spans = _spans()
    if replayed == 2:
        spans.counters[(5, tester.GRAPH_REPLAY_EVAL)] = 1
    run = _record()
    port_spans.attach(run, spans)
    assert spec.reader(NAME).read(run) == pytest.approx(50.0 * replayed)


def test_none_without_the_ports_spans_or_on_a_train_record():
    reader = spec.reader(NAME)
    run = _record()
    port_spans.attach(run, None)
    assert reader.read(run) is None
    other = _record("train")
    port_spans.attach(other, _spans())
    assert reader.read(other) is None


def test_none_for_a_program_without_the_counter(monkeypatch):
    run = _record()
    port_spans.attach(run, _spans())
    monkeypatch.delattr(tester, "GRAPH_REPLAY_EVAL")
    assert spec.reader(NAME).read(run) is None
