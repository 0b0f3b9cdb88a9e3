"""The port's H100 benchmark: one run of one cell of BENCHMARK.json.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds the PyTorch port
(`epipolar_transformers_tpu_torch`).  The run makes its weights and inputs
on the card from the seed, warms up the cell's shapes, measures for
`--seconds`, checks what the window produced against the plain reference
in `h100_bench/reference/`, and prints one JSON line last on standard
output; each compared number beside its limit goes last on standard error
too.  With `--trace 0` the line holds the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics from a profiler trace of the window.  It
exits non-zero, printing no result, where torch sees no card or fewer
cards than the cell asks for, and where a JAX module is loaded.  A cell on
several cards runs one process a card (`harness/ranks.py`), prints rank
0's result once every rank has ended, and exits non-zero where any rank
fails.  Build caches stay in `build/` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # one thread for the host's small linear algebra (pymvg's 4x4 solves)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from h100_bench.harness import forbidden_modules, run_cell, spec

    cell = spec.load_cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: the cell needs {cell.chips} card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if cell.chips > 1:  # a process a card, rank 0's result (harness/ranks.py)
        from h100_bench.harness import ranks

        result = ranks.launch(cell, args.seed, args.seconds, bool(args.trace), T_START)
        if result is None:
            return 4
    else:
        device = torch.device("cuda", 0)
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                            "count": cell.chips, **result["device"]}
    found = forbidden_modules()
    if found:
        print(f"h100_bench: the run loaded {found}", file=sys.stderr)
        return 3
    if args.trace:
        print(f"card: {card_line()}; the mfu and roofline shares are of its published "
              "peaks at 700 W", file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
