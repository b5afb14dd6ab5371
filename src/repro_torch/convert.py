"""Carry the JAX reference's state across to this package.

CMM has no weights: what parameterises a run is its leaf data, its
``TimeModel`` and its ``ClusterSpec``.  These helpers rebuild each from
what the reference exposes (``TimeModel.to_json()``, the spec's dataclass
fields, numpy arrays), so the same inputs can be planned and executed by
both packages.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.lazy import ClusteredMatrix
from .core.machine import ClusterSpec
from .core.timemodel import TimeModel


def timemodel_from_json(text: str) -> TimeModel:
    """The TimeModel whose reference twin printed ``text`` (``to_json``)."""
    return TimeModel.from_json(text)


def spec_from_fields(**fields) -> ClusterSpec:
    """A ClusterSpec from the reference spec's fields
    (``dataclasses.asdict(spec)``).  Fields this package does not model
    must hold their inert defaults: a memory budget (out-of-core
    admission) is refused rather than silently dropped."""
    for name in ("mem_bytes",):
        if fields.pop(name, None) is not None:
            raise ValueError(f"{name} is not supported by repro_torch")
    if any(v >= 0 for v in fields.pop("node_mem", ()) or ()):
        raise ValueError("node_mem is not supported by repro_torch")
    return ClusterSpec(**fields)


def leaf_from_numpy(array, device="cpu", name: str = "") -> ClusteredMatrix:
    """An INPUT leaf holding ``array`` on ``device``; ml_dtypes' bfloat16
    arrays become ``torch.bfloat16``."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a))
    return ClusteredMatrix.from_array(t.to(device), name=name)
