"""Torch state-dict key -> flax parameter path, for the PoseResNet family.

The port's own copy of `torch_key_to_flax_path` from
epipolar_transformers_tpu/utils/torch_import.py (tests/test_torch_config.py
holds the two equal on every key of the flagship model): layerX.N ->
layerX/blockN, downsample.{0,1} -> downsample_conv/_bn, deconv_layers.{3i,
3i+1} -> deconv_layers/deconv{i}, bn{i}.
"""

from __future__ import annotations

import re
from typing import Tuple


def torch_key_to_flax_path(key: str) -> Tuple[Tuple[str, ...], str, str]:
    """Map a torch parameter key to (flax path tuple, leaf name, kind).

    kind in {'conv', 'deconv', 'linear', 'bn_param', 'bn_stat', 'other'}.
    """
    parts = key.split(".")
    leaf = parts[-1]
    mods = parts[:-1]

    out = []
    kind = "other"
    i = 0
    while i < len(mods):
        m = mods[i]
        if re.fullmatch(r"layer\d", m) and i + 1 < len(mods) and mods[i + 1].isdigit():
            out.append(m)
            out.append(f"block{mods[i + 1]}")
            i += 2
            continue
        if m == "downsample" and i + 1 < len(mods) and mods[i + 1] in ("0", "1"):
            out.append("downsample_conv" if mods[i + 1] == "0" else "downsample_bn")
            i += 2
            continue
        if m == "deconv_layers" and i + 1 < len(mods) and mods[i + 1].isdigit():
            n = int(mods[i + 1])
            if n % 3 == 0:
                out.append("deconv_layers")
                out.append(f"deconv{n // 3}")
            elif n % 3 == 1:
                out.append("deconv_layers")
                out.append(f"bn{n // 3}")
            i += 2
            continue
        out.append(m)
        i += 1

    if leaf in ("running_mean", "running_var"):
        kind = "bn_stat"
    elif leaf == "num_batches_tracked":
        kind = "skip"
    elif leaf in ("weight", "bias"):
        last = out[-1] if out else ""
        if "bn" in last or last.endswith("_bn") or last == "bn1":
            kind = "bn_param"
        else:
            kind = "layer_param"
    return tuple(out), leaf, kind
