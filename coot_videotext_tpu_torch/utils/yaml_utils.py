"""
YAML config loading with scientific-float coercion, the config dump and the
json sidecars (copy of coot_videotext_tpu/utils/yaml_utils.py; behavioral parity with reference
nntrainer/utils_yaml.py:29-148).

PyYAML's safe loader parses `1e-4` as a string unless it matches the strict
YAML 1.1 float regex (`1.0e-4`); configs in the wild use the relaxed form, so
we coerce any string that python can parse as a float.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, Dict, Union

import yaml

_FLOAT_RE = re.compile(
    r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)$")


def _coerce_floats(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _coerce_floats(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_coerce_floats(v) for v in node]
    if isinstance(node, str) and _FLOAT_RE.match(node):
        return float(node)
    return node


def load_yaml_config_file(file: Union[str, Path]) -> Dict[str, Any]:
    """Load a yaml config file, coercing scientific-notation floats."""
    with open(file, "rt", encoding="utf8") as fh:
        data = yaml.safe_load(fh)
    if data is None:
        data = {}
    assert isinstance(data, dict), f"Config root must be a mapping: {file}"
    return _coerce_floats(data)


def dump_yaml_config_file(file: Union[str, Path], data: Dict[str, Any]) -> None:
    """Dump config to yaml and verify the round trip reproduces the input
    (reference utils_yaml.py:123-148)."""
    path = Path(file)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(data, default_flow_style=False, indent=4,
                                   sort_keys=False), encoding="utf8")
    if _coerce_floats(data) != load_yaml_config_file(path):
        raise ValueError(f"yaml round-trip verification failed for {file}")


def dump_json(data: Any, file: Union[str, Path]) -> None:
    """Write a small json sidecar (host state, not arrays)."""
    Path(file).write_text(json.dumps(data, indent=2), encoding="utf8")


def load_json(file: Union[str, Path]) -> Any:
    return json.loads(Path(file).read_text(encoding="utf8"))
