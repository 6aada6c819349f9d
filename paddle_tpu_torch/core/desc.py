"""Serializable program IR: VarDesc / OpDesc.

A copy of paddle_tpu/core/desc.py: the PyTorch port serializes programs
in exactly the same JSON form (same PROGRAM_FORMAT_VERSION, same
to_dict/from_dict), so a program built by either package loads in the
other (reference: paddle/fluid/framework/framework.proto:43-189).  The
port's interpreter (core/executor.py) runs the ops one by one on torch
tensors.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

# Program format version, mirroring the version field of the reference proto
# (reference: paddle/fluid/framework/framework.proto:24) so checkpoints and
# exported inference programs can be compatibility-checked on load.
PROGRAM_FORMAT_VERSION = 1

# Canonical dtype names (numpy-style names, shared with paddle_tpu).
_DTYPE_ALIASES = {
    "float": "float32",
    "fp32": "float32",
    "fp16": "float16",
    "bf16": "bfloat16",
    "double": "float64",
    "int": "int32",
    "long": "int64",
    "bool": "bool",
    "uint8": "uint8",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "float32": "float32",
    "float64": "float64",
}


def normalize_dtype(dtype) -> str:
    """Normalize a dtype spec (str / np.dtype / torch.dtype) to canonical
    str."""
    if dtype is None:
        return "float32"
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.replace("np.", "").replace("torch.", "")
    if name in _DTYPE_ALIASES:
        return _DTYPE_ALIASES[name]
    raise ValueError(f"unsupported dtype: {dtype!r}")


@dataclasses.dataclass
class VarDesc:
    """Description of a program variable.

    Mirrors reference VarDesc (framework.proto:105-165): name, type, shape,
    dtype, persistable.  LoD level is replaced by `lod_level` meaning "has a
    companion sequence-length tensor" (segment/length based ragged support
    instead of LoD offset tables, see SURVEY.md §5.7).
    """

    name: str
    shape: Tuple[int, ...] = ()
    dtype: str = "float32"
    persistable: bool = False
    stop_gradient: bool = False
    is_data: bool = False
    lod_level: int = 0
    # Parameter-only metadata (regularizer/clip live on the python Parameter).
    is_parameter: bool = False
    trainable: bool = True

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "VarDesc":
        d = dict(d)
        d["shape"] = tuple(d.get("shape", ()))
        return VarDesc(**d)


@dataclasses.dataclass
class OpDesc:
    """Description of one operator invocation.

    Mirrors reference OpDesc (framework.proto:75-104): type plus named
    input/output slots (each a list of var names) and an attribute map.
    Attrs must be JSON-serializable.
    """

    type: str
    inputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, List[str]] = dataclasses.field(default_factory=dict)
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def input_names(self) -> List[str]:
        out: List[str] = []
        for names in self.inputs.values():
            out.extend(names)
        return out

    def output_names(self) -> List[str]:
        out: List[str] = []
        for names in self.outputs.values():
            out.extend(names)
        return out

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OpDesc":
        return OpDesc(
            type=d["type"],
            inputs={k: list(v) for k, v in d.get("inputs", {}).items()},
            outputs={k: list(v) for k, v in d.get("outputs", {}).items()},
            attrs=dict(d.get("attrs", {})),
        )


def dump_program_dict(prog_dict: Dict[str, Any]) -> str:
    """Serialize a program dict (from Program.to_dict) to JSON text."""
    return json.dumps(prog_dict, indent=1, sort_keys=True)


def load_program_dict(text: str) -> Dict[str, Any]:
    d = json.loads(text)
    version = d.get("version", 0)
    if version > PROGRAM_FORMAT_VERSION:
        raise RuntimeError(
            f"program format version {version} is newer than supported "
            f"({PROGRAM_FORMAT_VERSION})"
        )
    return d
