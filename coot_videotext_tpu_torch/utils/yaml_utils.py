"""
YAML config loading with scientific-float coercion (copy of the loader of
coot_videotext_tpu/utils/yaml_utils.py; behavioral parity with reference
nntrainer/utils_yaml.py:29-148).

PyYAML's safe loader parses `1e-4` as a string unless it matches the strict
YAML 1.1 float regex (`1.0e-4`); configs in the wild use the relaxed form, so
we coerce any string that python can parse as a float.
"""

from __future__ import annotations

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


