"""The port's spans and counters (utils/tracing.py): nesting, parents and
self time, a span on another thread, the off path, the span tree of a tiny
flagship train step and eval group, bit-equal steps with tracing on and
off, `drain()`, following a running profiler, and the count of host syncs
from CUDA's sync debug warnings.

The tests marked `cuda` run on the card (python -m pytest --noconftest
tests/test_torch_tracing.py): a real sync counted, and the attention's
device spans in a tiny flagship train step with their tile counts.
"""

import threading
import time
import warnings

import numpy as np
import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg
from epipolar_transformers_tpu_torch.data.datasets.synthetic import SyntheticMultiview
from epipolar_transformers_tpu_torch.data.pipeline import collate
from epipolar_transformers_tpu_torch.engine.solver import make_optimizer
from epipolar_transformers_tpu_torch.engine.tester import (TRAIN_KEYS, EvalRecord,
                                                          fetch_outputs, host_output_keys,
                                                          make_eval_step, process_group,
                                                          to_model_inputs)
from epipolar_transformers_tpu_torch.engine.trainer import build_model, make_train_step
from epipolar_transformers_tpu_torch.utils import tracing


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts and ends with tracing off and empty buffers."""
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()


def _tree(spans):
    """{name: parent name} over the spans; the first of each name."""
    out = {}
    for s in spans:
        out.setdefault(s.name, spans[s.parent].name if s.parent >= 0 else None)
    return out


def test_spans_nest_with_parents_and_self_time():
    tracing.enable()
    with tracing.step("outer"):
        with tracing.span("a"):
            with tracing.span("a.inner"):
                tracing.count("n", 2)
        with tracing.span("b"):
            tracing.count("n")
            tracing.count("n")
    tracing.count("n", 5)  # no span open
    tracing.launching()  # no device span open: nothing to move
    tracing.disable()
    spans, counters = tracing.drain()
    assert [s.name for s in spans] == ["outer", "a", "a.inner", "b"]
    assert [s.parent for s in spans] == [-1, 0, 1, 0]
    assert {s.step for s in spans} == {0}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert counters == {(2, "n"): 2, (3, "n"): 2, (-1, "n"): 5}
    rows = tracing.summary(spans, counters)
    whole = (spans[0].end_ns - spans[0].start_ns) / 1e6
    children = sum(spans[i].end_ns - spans[i].start_ns for i in (1, 3)) / 1e6
    assert rows["outer"]["self_ms"] == pytest.approx(whole - children)
    assert rows["a"]["calls"] == 1 and rows["a.inner"]["n"] == 2 and rows["b"]["n"] == 2


def test_steps_take_new_ids():
    tracing.enable()
    for _ in range(3):
        with tracing.step("s"), tracing.span("inside"):
            pass
    tracing.disable()
    spans, _ = tracing.drain()
    assert [(s.name, s.step) for s in spans] == [("s", 0), ("inside", 0), ("s", 1),
                                                  ("inside", 1), ("s", 2), ("inside", 2)]


def test_a_span_on_another_thread_keeps_its_thread_and_parent():
    tracing.enable()
    seen = []

    def work():
        with tracing.span("on_thread"):
            seen.append(threading.get_ident())

    with tracing.step("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with tracing.span("after"):
            pass
    tracing.disable()
    spans, _ = tracing.drain()
    by = {s.name: s for s in spans}
    assert by["on_thread"].parent == spans.index(by["main"])
    assert by["on_thread"].thread == seen[0] != by["main"].thread
    assert by["after"].parent == spans.index(by["main"])


def test_disabled_spans_record_nothing():
    assert not tracing.enabled()
    first = tracing.span("x")
    for _ in range(100_000):
        with tracing.span("x", device=True):
            tracing.count("n")
            tracing.launching()
        with tracing.step("s"):
            pass
    assert tracing.span("y") is first is tracing.step("s")  # one shared no-op
    assert tracing.drain() == ([], {})


def test_drain_empties_the_buffers_and_leaves_open_spans_out():
    tracing.enable()
    with tracing.span("done"):
        pass
    with tracing.span("open"):
        with tracing.span("child"):
            tracing.count("n")
        spans, counters = tracing.drain()
        assert [s.name for s in spans] == ["done", "child"]
        assert spans[1].parent == -1 and counters == {(1, "n"): 1}
        assert tracing.drain() == ([], {})
        with tracing.span("later"):
            pass
    tracing.disable()
    spans, _ = tracing.drain()
    assert [(s.name, s.parent) for s in spans] == [("later", -1)]
    assert tracing.drain() == ([], {})


def test_a_running_profiler_turns_the_spans_on_and_off():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.span("before_a_step"):  # only a step turns tracing on
            pass
        with tracing.step("profiled"), tracing.span("inside"):
            pass
    assert tracing.enabled()
    with tracing.step("after"):  # the profiler has stopped: off again
        pass
    assert not tracing.enabled()
    spans, _ = tracing.drain()
    assert [s.name for s in spans] == ["profiled", "inside"]


def test_annotations_name_profiler_ranges():
    tracing.enable(annotate=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.step("annotated_step"), tracing.span("annotated_inner"):
            torch.ones(2).add_(1)
    tracing.disable()
    names = {e.name for e in prof.events()}
    assert {"annotated_step", "annotated_inner"} <= names
    assert [s.name for s in tracing.drain()[0]] == ["annotated_step", "annotated_inner"]


def test_sync_warnings_are_counted_not_shown(monkeypatch):
    """The counting hook, with CUDA's sync debug switch stubbed out: each
    sync warning counts against the innermost span, even from one line, and
    is not shown; any other warning still is; disable() restores both."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    shown = []
    monkeypatch.setattr(warnings, "showwarning", lambda *a, **k: shown.append(str(a[0])))
    tracing.enable()
    assert modes == ["warn"]
    with tracing.span("syncing"):
        for _ in range(3):
            warnings.warn(tracing.SYNC_WARNING + " (Triggered internally)", UserWarning)
        warnings.warn("something else", UserWarning)
    tracing.disable()
    assert modes == ["warn", 0]
    assert shown == ["something else"]
    _, counters = tracing.drain()
    assert counters == {(0, "host_syncs"): 3}
    warnings.warn("after", UserWarning)
    assert shown[-1] == "after"


@pytest.fixture(scope="module")
def tiny():
    """The tiny flagship on the CPU, one batch of 2 train items and one
    eval group."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    cfg = flagship_cfg(tiny=True)
    ds = SyntheticMultiview(cfg, is_train=True, n_samples=2, device_render=False)
    batch = to_model_inputs(collate([ds[i] for i in range(2)]), "cpu", TRAIN_KEYS)
    group = {k: v[0] for k, v in collate([SyntheticMultiview(cfg, False, 1)[0]]).items()}
    yield cfg, batch, group
    torch.set_num_threads(threads)


def _train_run(cfg, batch, traced):
    torch.manual_seed(0)
    model = build_model(cfg, torch.device("cpu"))
    step = make_train_step(cfg, model, make_optimizer(cfg, model))
    step(batch)
    if traced:
        tracing.enable()
    loss = step(batch)["loss"]
    tracing.disable()
    return model, loss


def test_tiny_train_step_span_tree_and_bit_equal_results(tiny):
    cfg, batch, _ = tiny
    plain_model, plain_loss = _train_run(cfg, batch, False)
    assert tracing.drain() == ([], {})
    model, loss = _train_run(cfg, batch, True)
    spans, _ = tracing.drain()
    assert _tree(spans) == {
        "train_step": None, "train.forward": "train_step", "train.optimizer": "train_step",
        "train.backward": "train_step", "model.other_trunk": "train.forward",
        "model.reference": "train.forward", "model.loss": "train.forward",
        "epipolar.fusion": "model.reference"}
    assert [s.name for s in spans if s.parent == 0] == [
        "train.forward", "train.optimizer", "train.backward", "train.optimizer"]
    assert {s.step for s in spans} == {0}
    assert torch.equal(loss, plain_loss)
    for (k, a), (k2, b) in zip(model.state_dict().items(), plain_model.state_dict().items()):
        assert k == k2 and torch.equal(a, b), k


def test_tiny_eval_group_span_tree(tiny):
    cfg, _, group = tiny
    torch.manual_seed(0)
    model = build_model(cfg, torch.device("cpu"))
    eval_step = make_eval_step(cfg, model, torch.device("cpu"))
    tracing.enable()
    out = eval_step(group)
    host, _ = fetch_outputs(out, host_output_keys(cfg, group))
    process_group(cfg, group, {k: v.numpy() for k, v in host.items()}, EvalRecord())
    tracing.disable()
    spans, _ = tracing.drain()
    assert _tree(spans) == {
        "eval_step": None, "eval.upload": "eval_step", "eval.forward": "eval_step",
        "model.trunks": "eval.forward", "model.reference": "eval.forward",
        "epipolar.fusion": "model.reference", "eval.fetch": None, "eval.process_group": None}
    assert all(np.isfinite(v.numpy()).all() for v in host.values())


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_a_sync_on_the_card_is_counted(device):
    x = torch.ones(4, device=device)
    tracing.enable()
    with tracing.span("syncs"):
        x.sum().item()
        x.cpu()
    with tracing.span("no_sync"):
        x.add_(1)
    tracing.disable()
    spans, counters = tracing.drain()
    assert counters.get((0, "host_syncs"), 0) >= 2
    assert (1, "host_syncs") not in counters
    assert torch.cuda.get_sync_debug_mode() == 0


@pytest.mark.cuda
def test_device_time_starts_at_the_launch(device):
    torch.cuda.synchronize()
    tracing.enable()
    with tracing.span("whole", device=True):
        time.sleep(0.05)  # host work while the device idles
        torch.cuda._sleep(1_000_000)
    with tracing.span("launch", device=True):
        time.sleep(0.05)
        tracing.launching()
        torch.cuda._sleep(1_000_000)
    tracing.disable()
    torch.cuda.synchronize()
    whole, launch = tracing.drain()[0]
    assert whole.device_ms > 50 > launch.device_ms > 0


@pytest.mark.cuda
def test_attention_device_spans_in_a_tiny_train_step(device, tiny):
    from epipolar_transformers_tpu_torch.ops import epipolar_attention_cuda as attn

    cfg, batch, _ = tiny
    model = build_model(cfg, device)
    step = make_train_step(cfg, model, make_optimizer(cfg, model))
    inputs = {k: v.to(device) for k, v in batch.items()}
    step(inputs)
    tracing.enable()
    step(inputs)
    tracing.disable()
    torch.cuda.synchronize()
    spans, counters = tracing.drain()
    tree = _tree(spans)
    assert tree["epipolar.attention"] == "epipolar.fusion"
    assert tree["epipolar.attention_backward"] == "train.backward"
    backward = next(s for s in spans if s.name == "epipolar.attention_backward")
    assert backward.thread != spans[0].thread  # autograd's device thread
    for s in spans:
        if s.name.startswith("epipolar.attention"):
            assert s.device_ms is not None and s.device_ms > 0
    tiles = tuple(counters[(-1, f"attn.forward_tiles.{p}")]
                  for p in ("tile_path", "per_query_path"))
    assert sum(tiles) > 0 and tiles == attn.tile_counts()  # still readable
    assert tracing.drain() == ([], {})  # summed once
