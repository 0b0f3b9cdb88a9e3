"""The port's profiling and loader tooling (ROADMAP A13a) on the CPU: the
command line's --trace and VIS.FLOPS, the train loop's windowed meters
(against the JAX package's MetricLogger on the same series), the
tensorboard event files that `train` writes itself (read back with
tensorboard's own reader and checked against tensorboardX's CRC), and
DATALOADER.BENCHMARK's stage times from loader worker processes.  The
JAX package's DataLoader under workers keeps its stage times in the
workers (ROADMAP C16): pinned here too.
"""

import math
import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_cli import TINY_FLAGSHIP_YAML, TRAIN_SET  # noqa: E402
from torch_configs import one_torch_thread  # noqa: E402,F401

from epipolar_transformers_tpu.utils import metric_logger as jax_meters  # noqa: E402
from epipolar_transformers_tpu_torch import main as cli  # noqa: E402
from epipolar_transformers_tpu_torch.config import DatasetCatalog, load_config  # noqa: E402
from epipolar_transformers_tpu_torch.engine import trainer  # noqa: E402
from epipolar_transformers_tpu_torch.utils import metric_logger  # noqa: E402
from epipolar_transformers_tpu_torch.utils.profiling import (  # noqa: E402
    DATALOADER_STAGES, trace_summary)

STAGES = {"setup", "read", "undistort", "warp", "heatmap"}


@pytest.fixture
def yaml_path(tmp_path, monkeypatch):
    monkeypatch.setitem(DatasetCatalog.DATASETS, TRAIN_SET, {
        "factory": "SyntheticMultiview", "is_train": True, "n_samples": 8})
    path = tmp_path / "tiny_flagship.yaml"
    path.write_text(TINY_FLAGSHIP_YAML)
    return str(path)


def test_cli_trace_writes_a_chrome_trace_of_the_run(yaml_path, tmp_path):
    """--trace DIR: the train and test dispatch under torch.profiler, the
    host's ops in DIR/trace.json, one `train_step` span a step."""
    trace = tmp_path / "trace"
    results = cli.main(["--trace", str(trace), "--cfg", yaml_path, "--device", "cpu",
                        "--max-steps", "2", "--max-eval-batches", "1",
                        "OUTPUT_DIR", str(tmp_path / "out")])
    assert math.isfinite(results["EPEmean_global"])
    assert os.listdir(trace) == ["trace.json"]
    summary = trace_summary(str(trace / "trace.json"))
    assert summary["steps"] == 2
    assert summary["device_events"] == 0 and summary["busy_share"] == 0  # no card here
    assert summary["window_ms"] > 0


def test_cli_vis_flops_prints_the_profile_and_stops(yaml_path, tmp_path, capsys):
    out = tmp_path / "out"
    prof = cli.main(["--cfg", yaml_path, "--device", "cpu", "VIS.FLOPS", "True",
                     "OUTPUT_DIR", str(out)])
    assert set(prof) == {"params", "flops", "bytes_accessed", "attention_flops", "conv_flops"}
    assert prof["flops"] > prof["conv_flops"] > 0 and prof["attention_flops"] > 0
    assert math.isnan(prof["bytes_accessed"])
    assert capsys.readouterr().out.count("PROFILE: ") == 1
    assert not any(f.endswith(".pth") for f in os.listdir(out))  # nothing trained


def test_meters_equal_jax_on_the_same_series():
    rng = np.random.RandomState(0)
    port, jax_side = metric_logger.MetricLogger(), jax_meters.MetricLogger()
    for _ in range(45):  # past the window of 20
        values = {"loss": float(rng.rand()), "heatmap_loss": torch.tensor(float(rng.rand()))}
        port.update(**values)
        jax_side.update(**{k: float(v) for k, v in values.items()})
        assert str(port) == str(jax_side)
    assert port.get_all_avg() == jax_side.get_all_avg()
    assert port.loss.median == jax_side.loss.median and port.loss.avg == jax_side.loss.avg
    assert metric_logger.prefix_dict({"a": 1}, "train") == jax_meters.prefix_dict({"a": 1}, "train")


def test_train_writes_event_files_with_the_logged_values(yaml_path, tmp_path, caplog):
    """TENSORBOARD.USE: one event file under OUTPUT_DIR/<COMMENT>-<time>
    with a `train/<key>` scalar a logged step, read back by tensorboard's
    EventAccumulator and the port's reader alike, CRCs as tensorboardX
    computes them; the log line shows each key's window median, which the
    event values give back (to the log's 4 decimals)."""
    import tensorboardX.record_writer as tbx
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    cfg = load_config(yaml_path, ["OUTPUT_DIR", str(tmp_path / "out"), "TENSORBOARD.USE", "True",
                                  "TENSORBOARD.COMMENT", "exp", "SOLVER.MAX_EPOCHS", "3"])
    with caplog.at_level("INFO", logger=trainer.__name__):
        trainer.train(cfg, max_steps=3, device="cpu")
    (folder,) = [d for d in os.listdir(tmp_path / "out") if os.path.isdir(tmp_path / "out" / d)]
    assert re.fullmatch(r"exp-\d{4}-\d\d-\d\d-\d\d-\d\d", folder), folder
    log_dir = str(tmp_path / "out" / folder)
    (name,) = os.listdir(log_dir)
    assert name.startswith("events.out.tfevents.")
    logged = [dict((k, float(v)) for k, v, _ in re.findall(r"(\w+): (\S+) \((\S+)\)", line))
              for line in caplog.text.splitlines() if " step " in line and " loss: " in line]
    assert len(logged) == 3

    ea = EventAccumulator(log_dir)
    ea.Reload()
    ours = metric_logger.read_scalars(log_dir)
    assert sorted(ea.Tags()["scalars"]) == sorted(ours) == sorted(f"train/{k}" for k in logged[0])
    for tag, series in ours.items():
        theirs = [(e.step, e.value) for e in ea.Scalars(tag)]
        assert theirs == series and [s for s, _ in series] == [1, 2, 3]
        for i, line in enumerate(logged):
            median = float(np.median([v for _, v in series[:i + 1]]))
            assert abs(median - line[tag.split("/", 1)[1]]) <= 5e-5 + 1e-6

    for data in metric_logger.read_records(os.path.join(log_dir, name)):
        assert metric_logger.masked_crc32c(data) == tbx.masked_crc32c(data)


def test_event_files_off_and_on_other_ranks(yaml_path, tmp_path, monkeypatch):
    """No file without TENSORBOARD.USE; a rank other than 0 writes none."""
    out = tmp_path / "off"
    trainer.train(load_config(yaml_path, ["OUTPUT_DIR", str(out)]), max_steps=1, device="cpu")
    assert not [f for f in os.listdir(out) if "tfevents" in f]
    monkeypatch.setattr(trainer.parallel, "is_primary", lambda: False)
    out = tmp_path / "rank1"
    trainer.train(load_config(yaml_path, ["OUTPUT_DIR", str(out), "TENSORBOARD.USE", "True"]),
                  max_steps=1, device="cpu")
    assert not [f for f in os.listdir(out) if "tfevents" in f]


@pytest.fixture(scope="module")
def fake_h36m(tmp_path_factory):
    from chip_smoke import write_fake_h36m

    root = tmp_path_factory.mktemp("h36m")
    write_fake_h36m(str(root), train_groups=4, val_groups=1, image_size=64)
    return str(root)


H36M_CUT = ["--device", "cpu", "--max-steps", "2", "BACKBONE.BODY", "epipolarposeR-18",
            "DATASETS.IMAGE_SIZE", "(32, 32)", "KEYPOINT.HEATMAP_SIZE", "(8, 8)",
            "EPIPOLAR.SAMPLESIZE", "4", "SOLVER.IMS_PER_BATCH", "2", "DOTEST", "False"]


@pytest.mark.parametrize("workers", [0, 2])
def test_dataloader_benchmark_reports_every_stage(fake_h36m, tmp_path, monkeypatch, caplog,
                                                  workers):
    """DATALOADER.BENCHMARK through the command line: the loader alone, no
    model; with 2 worker processes the stage times come back from the
    workers, every stage nonzero, one count an item."""
    monkeypatch.setattr(DatasetCatalog, "DATA_DIR", fake_h36m)
    seen = {}
    real = trainer.benchmark_loader

    def spy(loader, max_steps=None):
        seen.update(real(loader, max_steps))
        seen["counts"] = dict(DATALOADER_STAGES.counts)
        return seen

    monkeypatch.setattr(trainer, "benchmark_loader", spy)
    with caplog.at_level("INFO", logger=trainer.__name__):
        assert cli.main(["--cfg", "configs/epipolar/fake_h36m_zresidual.yaml", *H36M_CUT,
                         "DATALOADER.BENCHMARK", "True", "DATALOADER.NUM_WORKERS", str(workers),
                         "OUTPUT_DIR", str(tmp_path / "out")]) is None
    assert seen["batches"] == 2 and seen["ms_per_batch"] > 0
    # the first batch apart from the other's: together the pass's wall
    assert seen["first_batch_ms"] > 0 and seen["then_ms_per_batch"] > 0
    assert seen["first_batch_ms"] + seen["then_ms_per_batch"] == pytest.approx(
        seen["seconds"] * 1e3)
    assert set(seen["stage_ms"]) == STAGES and all(v > 0 for v in seen["stage_ms"].values())
    # 2 batches of 2 groups of 4 views: 16 views, each timed once a stage
    assert seen["counts"] == {s: 16 for s in STAGES}
    assert "DATALOADER.BENCHMARK: 2 batches" in caplog.text
    assert not os.path.exists(tmp_path / "out" / "last_checkpoint")


def test_jax_loader_workers_keep_their_stage_times(fake_h36m, monkeypatch):
    """C16: the JAX package's DataLoader with worker processes times each
    item in the worker, into the worker's own DATALOADER_STAGES; the
    consumer's stays empty, so its DATALOADER.BENCHMARK report under
    NUM_WORKERS > 0 holds no stage.  With no worker it holds all five."""
    pytest.importorskip("cv2")
    from epipolar_transformers_tpu.config import DatasetCatalog as JaxCatalog
    from epipolar_transformers_tpu.config import load_config as jax_load_config
    from epipolar_transformers_tpu.data.pipeline import DataLoader, build_dataset
    from epipolar_transformers_tpu.utils.profiling import DATALOADER_STAGES as JAX_STAGES

    monkeypatch.setattr(JaxCatalog, "DATA_DIR", fake_h36m)
    cfg = jax_load_config("configs/epipolar/fake_h36m_zresidual.yaml", [
        "DATASETS.IMAGE_SIZE", "(32, 32)", "KEYPOINT.HEATMAP_SIZE", "(8, 8)",
        "DATALOADER.BENCHMARK", "True"])
    ds = build_dataset(cfg, "multiview_h36m_train")
    for workers, want in ((2, set()), (0, STAGES)):
        JAX_STAGES.reset()
        batches = list(DataLoader(ds, batch_size=2, shuffle=False, num_workers=workers))
        assert len(batches) == 2
        assert set(JAX_STAGES.times) == want
