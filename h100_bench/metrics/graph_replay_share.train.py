"""The share of the traced part's train steps that replayed the step's CUDA
graph: the port's replay counter under its `train_step` spans, over those
spans, in %.  None for a program that has no such counter (it names it in
`engine.trainer.GRAPH_REPLAY`), or without the port's spans."""

import importlib

from h100_bench.harness import port_spans

LAYER, UNIT, MOVES, SOURCE = "Host launch path", "%", "train_samples_per_s", "program_counter"


def read(run):
    p = port_spans.of(run) if run.kind == "train" else None
    if p is None or not p.steps:
        return None
    try:
        trainer = importlib.import_module("epipolar_transformers_tpu_torch.engine.trainer")
    except ImportError:
        return None
    counter = getattr(trainer, "GRAPH_REPLAY", None)
    if counter is None:
        return None
    return 100.0 * p.counted(counter, ["train_step"]) / p.steps
