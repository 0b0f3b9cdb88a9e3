"""A rehearsal of the benchmark without the card: BENCHMARK.json keeps to the
contract's shape and limits, every cell finds its configuration, traffic,
limits and metric files, every per-layer metric's cells report the
end-to-end metric it moves, and a run without a card (or without the port
beside it) exits non-zero and prints no result."""

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from h100_bench.harness import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(text, limit=200):
    return isinstance(text, str) and 1 <= len(text) <= limit and not re.search(r"[\n\r\t]", text)


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"] == ["python3", "h100_bench/run.py"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check with 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("h100_bench/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _line(w["why"]) and w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
        assert set(m) - {"workloads"} <= {"name", "unit", "better", "bound", "source", "layer",
                                           "moves"}
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert c.traffic["kind"] in ("train", "infer")
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])
    for number, entry in c.limits.items():
        assert math.isfinite(entry["limit"]) and entry["limit"] >= 0, number
    if c.chips > 1:  # one rank a card, the deployment the configuration states
        assert c.config["ranks"] == c.chips and "rank_gap" in c.limits


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_matches_its_entry(metric):
    r = spec.reader(metric["name"])
    assert callable(r.read)
    assert (r.UNIT, r.SOURCE) == (metric["unit"], metric["source"])
    if "layer" in metric:
        assert (r.LAYER, r.MOVES) == (metric["layer"], metric["moves"])
        assert _line(metric["layer"])
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))


def test_file_names_are_new_to_the_repo_tests():
    ours = {p.name for p in (ROOT / "h100_bench" / "tests").glob("*.py")}
    assert not ours & {p.name for p in (ROOT / "tests").glob("*.py")}


def _run(cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "CUDA_VISIBLE_DEVICES": "",
           **(env_extra or {})}
    return subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                           "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(out):
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    _no_result(out)


def test_no_program_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    _no_result(out)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell):
    """On the card: a short run of each cell prints a result that is correct."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if torch.cuda.device_count() < spec.load_cell(cell).chips:
        pytest.skip(f"{cell} needs {spec.load_cell(cell).chips} GPUs")
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
                          "2147483677", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
