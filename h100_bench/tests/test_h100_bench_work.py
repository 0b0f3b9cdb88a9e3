"""The benchmark's own arithmetic on hand-made inputs: the reference's FLOP
count, the attention's operations and bytes at each dtype, and the
device's busy union, kernel phases and idle gaps of a synthetic trace."""

import pytest
import torch

from epipolar_transformers_tpu_torch.config import flagship_cfg, update_from_dict
from epipolar_transformers_tpu_torch.utils.profiling import profile_model
import h100_bench.tests.bench_tiny  # noqa: F401  (two torch threads)
from h100_bench.harness import spec, work
from h100_bench.harness.trace import Trace


def _locs(points, H=5, W=5):
    """(1, K, H, W, 2) normalized locations: the first query's K samples at
    these pixel positions (x, y), every other query's off the map."""
    t = torch.tensor(points, dtype=torch.float32)
    norm = torch.stack([2 * t[:, 0] / (W - 1) - 1, 2 * t[:, 1] / (H - 1) - 1], -1)
    locs = torch.full((1, len(points), H, W, 2), -100.0)
    locs[0, :, 0, 0] = norm
    return locs


@pytest.mark.parametrize("points, pairs", [
    ([(1.0, 1.0)], 1),  # on a pixel: one row with weight
    ([(1.5, 1.5)], 4),  # between four pixels
    ([(1.5, 1.0), (1.0, 1.0)], 2),  # a row shared by two samples counts once
    ([(-3.0, -3.0)], 0),  # off the map
    ([(4.5, 1.0)], 1),  # half off the right edge: only the column inside
])
def test_live_pairs(points, pairs):
    assert work.live_pairs(_locs(points)) == pairs


def test_attention_bound_counts_each_byte_once():
    locs = _locs([(1.5, 1.5), (1.0, 1.0)])  # K=2 on a 5x5 map; 4 distinct rows
    C, HW = 8, 25
    fwd = work.attention_bound(locs, C, "float32", backward=False)
    assert fwd["flops"] == 4 * 2 * C * 2
    # queries and keys (= values), locations, then out and the weights
    assert fwd["bytes"] == 3 * HW * C * 4 + 2 * HW * 2 * 4 + 2 * HW * 4
    bwd = work.attention_bound(locs, C, "bfloat16", backward=True)
    assert bwd["flops"] == 4 * 2 * C * 5
    # queries, keys, the output's gradient read, two gradients written
    assert bwd["bytes"] == 5 * HW * C * 2 + 2 * HW * 2 * 4
    assert bwd["seconds"] == max(bwd["flops"] / 989e12, bwd["bytes"] / 3.35e12)
    assert fwd["bound_by"] == "bytes"


def test_peaks_are_the_published_ones():
    assert work.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 495e12}
    assert work.PEAK_BYTES_PER_S == 3.35e12


def test_reference_flops_match_the_port_count():
    """The reference's count of the flagship at 256 px against the port's
    own (FlopCounterMode on its eval forward, the attention by formula)."""
    cell = spec.load_cell("r50_256.train_b16")
    ours = cell.reference.forward_flops(cell.recipe)
    cfg = update_from_dict(flagship_cfg(), {"DTYPE": "float32"})  # the count is the same
    theirs = profile_model(cfg, 1, device="cpu")["flops"]
    # the port's eval forward also decodes the peaks: two small matmuls a
    # joint (17 x 17 windows on 64 x 64 maps), 3.2 MFLOP of 29.7 GFLOP
    assert theirs - ours == pytest.approx(3.19e6, rel=0.01)
    # the attention's share: 2 B HW K (Cq + Cv)
    assert 2 * 4096 * 64 * (256 + 256) < ours


def test_busy_union_phases_and_gaps():
    t = Trace(device=[(0.0, 1.0, "a"), (0.5, 2.0, "b"), (3.0, 4.0, "c"), (9.0, 12.0, "d")],
              spans=[(2.0, 2.8, "bench.wait"), (2.8, 3.0, "bench.host_half")],
              start=0.5, end=10.0,
              kernels=[(1.0, 1.1, "void group_kernel(Params, Schedule)"),
                       (1.2, 1.5, "void tile_forward_kernel<float, 8>(Params)"),
                       (2.0, 2.1, "group_kernel(Params, Schedule)"),
                       (2.2, 2.6, "void tile_backward_kernel<float, 8>(Params)"),
                       (2.7, 2.8, "fill_kernel_other<1>(int)")])
    assert t.busy_s() == pytest.approx(1.5 + 1.0 + 1.0)
    assert 100 * (1 - t.busy_s() / t.window_s) == pytest.approx(100 * 6.0 / 9.5)
    phases = t.phase_times(("tile_forward_kernel",), ("tile_backward_kernel", "fill_kernel"),
                           ("group_kernel",))
    assert phases["forward"] == pytest.approx(0.1 + 0.3)
    assert phases["backward"] == pytest.approx(0.1 + 0.4)
    gaps = dict(t.idle_gaps())
    assert gaps["bench.wait"] == pytest.approx(1.0) and gaps["other"] == pytest.approx(5.0)
    assert t.kernel_count() == 5
    assert t.top_ops(2) == [("b", 1.5), ("c", 1.0)]


def _record(kind, **kw):
    from h100_bench.harness.record import RunRecord

    trace = Trace(device=[(0.0, 0.4, "k")], spans=[], start=0.0, end=1.0,
                  kernels=kw.pop("kernels", []))
    return RunRecord(kind=kind, setup_s=1.0, window_s=1.0, steps=4, items_per_step=2,
                     peak_window_bytes=0, forward_flops_per_item=1e12, peak_flops=1e15,
                     trace=trace, **kw)


@pytest.mark.parametrize("metric, kind, phase, kernel", [
    ("attn_fwd_roofline.train", "train", "forward", "void tile_forward_kernel<float, 8>(P)"),
    ("attn_bwd_roofline.train", "train", "backward", "void tile_backward_kernel<float, 8>(P)"),
    ("attn_fwd_roofline.infer", "infer", "forward", "epipolar_attention_kernel(Params)"),
])
def test_a_roofline_fails_rather_than_vanish_without_its_kernels(metric, kind, phase, kernel):
    reader = spec.reader(metric)
    ran = _record(kind, kernels=[(0.1, 0.3, kernel)], attention_bound_s={phase: 0.05})
    assert reader.read(ran) == pytest.approx(25.0)
    with pytest.raises(RuntimeError, match="renamed or taken off the path"):
        reader.read(_record(kind, kernels=[(0.1, 0.3, "other(int)")],
                            attention_bound_s={phase: 0.05}))
    assert reader.read(_record(kind, attention_bound_s={})) is None  # no call traced


@pytest.mark.parametrize("metric, kind, passes", [("mfu.train", "train", 3),
                                                  ("mfu.infer", "infer", 1)])
def test_mfu_reads_the_untraced_part_of_the_window(metric, kind, passes):
    run = _record(kind, traced_steps=1, untraced_steps=10, untraced_s=2.0)
    # passes x 1 TFLOP an item x 2 items x 10 steps in 2 s of a 1 PFLOP/s peak
    assert spec.reader(metric).read(run) == pytest.approx(passes * 1.0)


def test_a_traced_window_keeps_its_spans_inside_its_bounds():
    from h100_bench.harness.window import Window

    w = Window(0.3, True, torch.device("cpu"))  # under TRACE_SECONDS: traced throughout
    while True:
        with w.span("bench.train_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        if w.tick():
            break
    _, t = w.close()
    assert len(t.spans) == w.calls
    assert all(t.start <= a <= b <= t.end for a, b, _ in t.spans)
    assert t.device == []  # a CPU run's profiler holds no device work
    assert w.untraced() == (0, 0.0)
