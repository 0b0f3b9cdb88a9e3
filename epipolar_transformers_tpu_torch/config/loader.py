"""YAML + CLI-override config loading.

The port's own copy of epipolar_transformers_tpu/config/loader.py.  Mirrors
the reference UX (`python main.py --cfg file.yaml KEY.SUBKEY VALUE ...`,
reference: main.py:21-45) but produces a frozen `Config` instead of mutating a
global singleton.
"""

from __future__ import annotations

import ast
from typing import Any, Iterable, Mapping

from .schema import Config, update_from_dict


def _parse_literal(text: str) -> Any:
    """Parse a CLI override value the way yacs did: python literal, else str."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _coerce(value: Any) -> Any:
    """Recursively parse yacs-style python-literal strings inside YAML.

    Reference configs write tuples as `(256, 256)` which yaml.safe_load reads
    as plain strings; yacs parsed them as python literals — mirror that.
    """
    if isinstance(value, dict):
        return {k: _coerce(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_coerce(v) for v in value]
    if isinstance(value, str):
        stripped = value.strip()
        if stripped[:1] in "([" or stripped in {"None", "True", "False"}:
            return _parse_literal(stripped)
    return value


def _load_yaml(path: str) -> Mapping[str, Any]:
    import yaml

    with open(path) as f:
        return _coerce(yaml.safe_load(f) or {})


def load_config(
    yaml_path: str | None = None,
    overrides: Iterable[str] = (),
    base: Config | None = None,
) -> Config:
    """Build a Config from an optional YAML file plus KEY VALUE override pairs.

    `overrides` is the flat remainder list from the CLI:
    ["SOLVER.BASE_LR", "0.01", "EPIPOLAR.MERGE", "late", ...]
    """
    cfg = base or Config()
    if yaml_path:
        cfg = update_from_dict(cfg, _load_yaml(yaml_path))
    overrides = list(overrides)
    if len(overrides) % 2 != 0:
        raise ValueError("CLI overrides must be KEY VALUE pairs")
    for key, value in zip(overrides[::2], overrides[1::2]):
        tree: dict = {}
        node = tree
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_literal(value)
        cfg = update_from_dict(cfg, tree)
    # Infer the dataset family for reference-config compatibility (the
    # reference switches on `'h36m' in cfg.OUTPUT_DIR`, modeling/model.py:75).
    if not cfg.DATASET_FAMILY:
        if "h36m" in cfg.OUTPUT_DIR or any("h36m" in d for d in cfg.DATASETS.TRAIN + cfg.DATASETS.TEST):
            cfg = cfg.replace(DATASET_FAMILY="h36m")
        elif any("RHD" in d or "rhd" in d for d in cfg.DATASETS.TRAIN + cfg.DATASETS.TEST):
            cfg = cfg.replace(DATASET_FAMILY="rhd")
    return cfg
