"""Carry the JAX reference's state across to this package.

CMM has no weights: what parameterises a run is its leaf data, its
``TimeModel`` and its ``ClusterSpec``.  These helpers rebuild each from
what the reference exposes (``TimeModel.to_json()``, the spec's dataclass
fields, numpy arrays), so the same inputs can be planned and executed by
both packages.  The LM stack does have weights: ``params_from_jax`` loads
the reference's parameter dict, given as numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from .configs.base import ModelConfig
from .core.lazy import ClusteredMatrix
from .core.machine import ClusterSpec
from .core.timemodel import TimeModel
from .models.lm import LAYER_PREFIX, LM, param_specs


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


def tensor_from_numpy(array) -> torch.Tensor:
    """A CPU tensor holding ``array``; ml_dtypes' bfloat16 arrays become
    ``torch.bfloat16``."""
    a = np.asarray(array)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def leaf_from_numpy(array, device="cpu", name: str = "") -> ClusteredMatrix:
    """An INPUT leaf holding ``array`` on ``device``."""
    return ClusteredMatrix.from_array(tensor_from_numpy(array).to(device),
                                      name=name)


def params_from_jax(cfg: ModelConfig, params_np, device="cpu") -> LM:
    """The model whose weights are the reference's ``init_params`` dict
    ``params_np`` (name -> numpy array), on ``device``, in the arrays'
    dtype.  Each ``layers/...`` array's leading (n_layers, ...) axis is
    split over the port's layers; a missing, extra or misshapen entry
    raises."""
    specs = param_specs(cfg)
    if set(params_np) != set(specs):
        raise ValueError(f"reference params differ from the port's: "
                         f"{sorted(set(params_np) ^ set(specs))}")
    tensors = {k: tensor_from_numpy(v) for k, v in params_np.items()}
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1:
        raise ValueError(f"reference params of several dtypes: {dtypes}")
    model = LM(cfg, device, dtypes.pop())
    with torch.no_grad():
        for name, t in tensors.items():
            if tuple(t.shape) != specs[name][0]:
                raise ValueError(f"{name}: shape {tuple(t.shape)}, the port "
                                 f"expects {specs[name][0]}")
            layered = name.startswith(LAYER_PREFIX)
            for i, d in enumerate(model.tensors(name)):
                d.copy_(t[i] if layered else t)
    return model
