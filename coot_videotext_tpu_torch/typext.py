"""
Typed-config / constants runtime.

Copy of the parts of coot_videotext_tpu/typext.py that the PyTorch package
uses (ConfigClass, ConstantHolder, SaveableState, INF): the package keeps its
own copy so it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Union

# fp16-safe infinity (reference nntrainer/typext.py:24). We keep the same
# constant for additive attention masks: bf16 has fp32's exponent range so it
# would tolerate a larger value, but 32752 keeps masked-softmax numerics
# comparable with the reference's released checkpoints.
INF = 32752.0


class ConfigClass:
    """Base class for configuration objects (reference typext.py:29)."""

    def __repr__(self) -> str:
        parts = []
        for key, value in vars(self).items():
            if isinstance(value, ConfigClass):
                value_str = repr(value).replace("\n", "\n    ")
                parts.append(f"{key}:\n    {value_str}")
            else:
                parts.append(f"{key}: {value}")
        return f"{type(self).__name__}\n  " + "\n  ".join(
            p.replace("\n", "\n  ") for p in parts)


class ConstantHolderMeta(type):
    """Metaclass registering all uppercase string attributes as values."""

    def __new__(mcs, name, bases, namespace):
        cls = super().__new__(mcs, name, bases, namespace)
        values: List[Any] = []
        keys: List[str] = []
        for base in reversed(cls.__mro__):
            for key, value in vars(base).items():
                if key.startswith("_") or callable(value) or isinstance(
                        value, (classmethod, staticmethod, property)):
                    continue
                if key not in keys:
                    keys.append(key)
                    values.append(value)
        cls._keys = keys
        cls._values = values
        return cls

    def __contains__(cls, item) -> bool:
        return item in cls._values

    def __iter__(cls):
        return iter(cls._values)


class ConstantHolder(metaclass=ConstantHolderMeta):
    """
    Enum replacement: class-level string constants with containment checks
    (reference typext.py:294). Usage: ``class Split(ConstantHolder): TRAIN = "train"``.
    """

    @classmethod
    def values(cls) -> List[Any]:
        return list(cls._values)

    @classmethod
    def keys(cls) -> List[str]:
        return list(cls._keys)

    @classmethod
    def assert_valid(cls, value: Any) -> None:
        if value not in cls._values:
            raise ValueError(
                f"{value!r} is not a valid {cls.__name__}; valid: {cls._values}")


class SaveableState:
    """
    JSON-round-trippable dataclass mixin for trainer state
    (reference typext.py:55 SaveableBaseModel). Subclasses must be
    dataclasses.
    """

    def save(self, file: Union[str, Path]) -> None:
        path = Path(file)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(json.dumps(dataclasses.asdict(self), indent=2))
        tmp.replace(path)

    def load(self, file: Union[str, Path]) -> "SaveableState":
        self.apply_dict(json.loads(Path(file).read_text()))
        return self

    def apply_dict(self, data: Dict[str, Any]) -> None:
        field_names = {f.name for f in dataclasses.fields(self)}
        for key, value in data.items():
            if key not in field_names:
                raise KeyError(
                    f"Unknown field {key} for state {type(self).__name__}")
            setattr(self, key, value)

    @classmethod
    def create_from_file(cls, file: Union[str, Path]):
        obj = cls()
        obj.load(file)
        return obj
