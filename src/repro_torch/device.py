"""Device resolution: the port runs on the CUDA card unless told otherwise."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA card; raise if there is none.  Any
    other value (``"cpu"``, ``"cuda:1"``, a ``torch.device``) is taken as
    given: running on the CPU is an explicit choice, never a fallback.
    A CUDA device always comes back with its index, so it compares equal
    to a tensor's ``.device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
