#!/usr/bin/env python3
"""A 20-joint checkpoint's heatmap head cut to the 17 H36M joints, as a
checkpoint of the PyTorch port.

    python3 scripts/torch_convert_20to17.py in.pth out.pth
    python3 scripts/torch_convert_20to17.py --cfg configs/foo.yaml in.ckpt out.pth [KEY VALUE ...]

The counterpart of scripts/convert_20to17.py (reference scripts/20to17.py):
the MPII-union models train a 20-joint final layer, and H36M's eval reads
the 17 actual joints, rows ACTUAL_IN_UNION of the union.  Every
`final_layer` weight and bias with 20 output rows keeps those 17.

The input is the port's own checkpoint (`Checkpointer.save`'s
{'model', 'optimizer', 'extra'}, or a bare state dict), or a JAX
checkpoint (flax msgpack `.ckpt`), whose weights are read into the model
that `--cfg` and its overrides build (the 20-joint one the file was
trained as) and taken from there.  The output is a port checkpoint with
the model's weights and the input's `extra`, no optimizer state (the
moments of the 20 rows no longer fit); it loads through cfg.WEIGHTS.
Runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from epipolar_transformers_tpu_torch.data.datasets.joints_dataset import ACTUAL_IN_UNION  # noqa: E402
from epipolar_transformers_tpu_torch.utils.checkpoint import Checkpointer  # noqa: E402


def cut_final_layer(state: dict) -> dict:
    """The state dict with every 20-row `final_layer` weight and bias cut
    to rows ACTUAL_IN_UNION."""
    rows = torch.as_tensor(ACTUAL_IN_UNION)
    out = {}
    for key, value in state.items():
        parts = key.split(".")
        if ("final_layer" in parts and parts[-1] in ("weight", "bias")
                and value.ndim >= 1 and value.shape[0] == 20):
            value = value.index_select(0, rows).clone()
        out[key] = value
    return out


def read_state(path: str, cfg_path=None, opts=()) -> tuple:
    """(state dict, extra) of a port checkpoint or, with the config of its
    model, a JAX `.ckpt`."""
    if path.endswith(".ckpt"):
        if cfg_path is None:
            raise SystemExit(f"{path}: a JAX checkpoint needs --cfg, the config of its model")
        from epipolar_transformers_tpu_torch.config import load_config
        from epipolar_transformers_tpu_torch.models import ModelBuilder
        from epipolar_transformers_tpu_torch.utils.flax_msgpack import read_checkpoint
        from epipolar_transformers_tpu_torch.utils.jax_import import load_jax_variables

        params, stats, extra = read_checkpoint(path)
        model = ModelBuilder(load_config(cfg_path, list(opts)))
        load_jax_variables(model, {"params": params, "batch_stats": stats})
        return model.state_dict(), dict(extra)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if Checkpointer.is_native(payload):
        return payload["model"], dict(payload["extra"] or {})
    return payload, {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a port checkpoint (.pth) or a JAX checkpoint (.ckpt)")
    ap.add_argument("dst", help="the port checkpoint to write")
    ap.add_argument("--cfg", default=None, help="the config of a .ckpt's 20-joint model")
    ap.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE config overrides")
    args = ap.parse_args(argv)
    state, extra = read_state(args.src, args.cfg, args.opts)
    state = cut_final_layer(state)
    torch.save({"model": state, "optimizer": None, "extra": extra}, args.dst)
    cut = sorted(k for k, v in state.items() if "final_layer" in k.split("."))
    print(f"wrote {args.dst}: {', '.join(f'{k} {tuple(state[k].shape)}' for k in cut)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
