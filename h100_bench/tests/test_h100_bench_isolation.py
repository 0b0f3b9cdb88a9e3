"""What the harness and the reference load: no module whose top-level name,
compared whole, is `jax`, `jaxlib`, `flax` or `epipolar_transformers_tpu`;
and the reference nothing of the port (`epipolar_transformers_tpu_torch`)."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

LOADED = """
import json, sys
sys.path.insert(0, {root!r})
{imports}
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""


def _top_level(imports: str):
    out = subprocess.run([sys.executable, "-c", LOADED.format(root=str(ROOT), imports=imports)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax():
    names = _top_level("import h100_bench.harness.train, h100_bench.harness.infer, "
                       "h100_bench.control\nsys.argv = ['run.py']\n"
                       "import runpy; runpy.run_path('h100_bench/run.py', run_name='bench')")
    assert "epipolar_transformers_tpu_torch" in names  # the program under test
    assert not names & {"jax", "jaxlib", "flax", "epipolar_transformers_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    modules = sorted(p.stem for p in (ROOT / "h100_bench" / "reference").glob("*.py")
                     if p.stem != "__init__")
    assert {"model", "geometry"} <= set(modules)
    names = _top_level("import importlib\n" + "".join(
        f"importlib.import_module('h100_bench.reference.{m}')\n" for m in modules))
    assert not names & {"jax", "jaxlib", "flax", "epipolar_transformers_tpu",
                        "epipolar_transformers_tpu_torch"}


def test_the_reference_sources_name_no_program():
    for path in (ROOT / "h100_bench" / "reference").glob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "epipolar_transformers_tpu" not in text, path


def test_the_check_compares_whole_top_level_names():
    from h100_bench.harness import forbidden_modules

    sys.modules["epipolar_transformers_tpu_torch_fake"] = sys.modules[__name__]
    try:
        assert "epipolar_transformers_tpu_torch_fake" not in forbidden_modules()
        sys.modules["jaxlib.fake"] = sys.modules[__name__]
        assert forbidden_modules() == ["jaxlib.fake"] or "jaxlib.fake" in forbidden_modules()
    finally:
        sys.modules.pop("epipolar_transformers_tpu_torch_fake", None)
        sys.modules.pop("jaxlib.fake", None)
