"""Executor backends + the single name -> factory registry.

``EXECUTORS`` is the one place a backend is named: ``CMMEngine.run``,
``chip_smoke.py`` and the tests all resolve executor strings through
``make_executor``.  Every backend takes ``device=`` (``None``: the CUDA
card).
"""
from typing import Callable, Dict

from .local import LocalExecutor                                # noqa: F401
from .batched import (WaveExecutor, build_waves,                # noqa: F401
                      predict_wave_makespan)

#: executor name -> factory (kwargs forwarded verbatim)
EXECUTORS: Dict[str, Callable] = {
    # per-task threaded executor, torch ops per tile
    "local": LocalExecutor,
    # per-task, ADDMUL tiles through the CUDA kernel (K1 / K2)
    "kernel": lambda **kw: LocalExecutor(use_kernel=True, **kw),
    # wave-batched, stacked torch ops per group
    "batched": lambda **kw: WaveExecutor(backend="torch", **kw),
    # wave-batched, ADDMUL groups through one CUDA kernel launch (K3)
    "batched-cuda": lambda **kw: WaveExecutor(backend="cuda", **kw),
}


def make_executor(name: str, **kw):
    """Instantiate a registered executor backend by name."""
    try:
        factory = EXECUTORS[name]
    except KeyError:
        raise ValueError(
            f"unknown executor {name!r}; known: {sorted(EXECUTORS)}"
        ) from None
    return factory(**kw)
