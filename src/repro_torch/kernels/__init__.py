"""Hand-written CUDA kernels and their plain PyTorch versions: ADDMUL
(``matmul.py``, K1-K4), flash attention (``attention.py``, K5) and
chunkwise gated linear attention (``gla.py``, K6)."""


def libraries():
    """Every kernel library, for ``cuda.build_all``."""
    from . import attention, gla, matmul
    return (matmul.LIBRARY, attention.LIBRARY, gla.LIBRARY)


def wrappers():
    """Every launch wrapper; each counts its launches in ``.launches``."""
    from . import attention, gla, matmul
    return matmul.WRAPPERS + attention.WRAPPERS + gla.WRAPPERS


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    from . import cuda
    cuda.reset(wrappers())
