"""The reader of `graph_replay_share.train`: the port's replay counter under
its `train_step` spans over those spans, on a synthetic record of one
replayed and one eager step; None without the port's spans, on an eval
record, and for a program that has no replay counter."""

import pytest

from epipolar_transformers_tpu_torch.engine import trainer
from h100_bench.harness import port_spans, spec
from h100_bench.harness.record import RunRecord
from h100_bench.harness.trace import Trace

NAME = "graph_replay_share.train"


def _record(kind="train"):
    trace = Trace(device=[], spans=[], start=100.0, end=101.0, kernels=[(100.1, 100.2, "k")])
    return RunRecord(kind=kind, setup_s=1.0, window_s=1.0, steps=2, items_per_step=2,
                     peak_window_bytes=0, forward_flops_per_item=1.0, peak_flops=1.0,
                     trace=trace, traced_steps=2)


def _spans():
    """A replayed step at 100.1 s, then an eager one at 100.3 s."""
    spans = [(100.1, 100.11, "train_step", -1, None),
             (100.1, 100.11, "train.replay", 0, None),
             (100.3, 100.4, "train_step", -1, None),
             (100.3, 100.35, "train.forward", 2, None)]
    counters = {(1, trainer.GRAPH_REPLAY): 1,
                (-1, trainer.GRAPH_REPLAY): 5}  # outside every step: not counted
    return port_spans.PortSpans(spans, counters, "train_step")


def test_the_share_of_replayed_steps():
    run = _record()
    port_spans.attach(run, _spans())
    assert spec.reader(NAME).read(run) == pytest.approx(50.0)


def test_none_without_the_ports_spans_or_on_an_eval_record():
    reader = spec.reader(NAME)
    run = _record()
    port_spans.attach(run, None)
    assert reader.read(run) is None
    other = _record("infer")
    port_spans.attach(other, _spans())
    assert reader.read(other) is None


def test_none_for_a_program_without_the_counter(monkeypatch):
    run = _record()
    port_spans.attach(run, _spans())
    monkeypatch.delattr(trainer, "GRAPH_REPLAY")
    assert spec.reader(NAME).read(run) is None
