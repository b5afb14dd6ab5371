"""CUDA flash-attention forward (K5): build, load and the launch wrapper.

``flash_attention`` replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_fa_kernel``).  The kernel is ``csrc/flash_attention.cu``; its header
comment gives the design and what bounds it.  Differences from the Pallas
wrapper, both in the function's favour: k/v may carry fewer heads than q
(grouped-query attention, read in place), and lengths that are not a
multiple of the block are masked instead of refused.

For tensors on the CPU the wrapper runs the plain PyTorch version
(``kernels/ref.py::flash_attention``); for CUDA tensors it launches the
kernel or raises.  It counts its launches in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda, ref

#: block shape and head-dimension limit compiled into the kernel
BLOCK = (64, 64)
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_LL4 = ctypes.c_longlong * 4


class _Params(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "k", "v", "o")]
                + [(f, _LL4) for f in ("sq", "sk", "sv", "so")]
                + [(f, ctypes.c_int) for f in ("B", "H", "KV", "S", "SK",
                                               "D", "causal", "dtype")]
                + [("scale", ctypes.c_float), ("pad", ctypes.c_int)])


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_flash_attention.argtypes = [ctypes.POINTER(_Params),
                                          ctypes.c_void_p]
    lib.repro_flash_attention.restype = ctypes.c_int
    lib.repro_fa_error_string.argtypes = [ctypes.c_int]
    lib.repro_fa_error_string.restype = ctypes.c_char_p
    lib.repro_fa_params_size.restype = ctypes.c_int
    cfg = (ctypes.c_int * 3)()
    lib.repro_fa_config(cfg)
    if (lib.repro_fa_params_size() != ctypes.sizeof(_Params)
            or tuple(cfg) != BLOCK + (MAX_HEAD_DIM,)):
        raise RuntimeError("the flash-attention library does not match the "
                           "ctypes layout in kernels/attention.py")


LIBRARY = cuda.CudaLibrary("flash_attention.cu", "libflash_attention", _bind)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """K5: softmax(q k^T / sqrt(d)) v, the Pallas kernel's function.

    q (B, H, S, D); k, v (B, KV, Sk, D) with H % KV == 0; any strides (a
    (B, S, H, D) tensor's ``transpose(1, 2)`` is taken as it is).  f32 or
    bf16, all three alike; the result is q.dtype (on the card laid out
    like q, so a transposed view comes back as one)."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"expected (B, H, S, D) q and equal (B, KV, Sk, D) "
                         f"k, v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if cuda.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA flash-attention kernel takes f32 and bf16, "
                        f"not {q.dtype}")
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    p = _Params(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                o=out.data_ptr(), sq=_LL4(*q.stride()), sk=_LL4(*k.stride()),
                sv=_LL4(*v.stride()), so=_LL4(*out.stride()), B=b, H=h,
                KV=k.shape[1], S=s, SK=k.shape[2], D=d, causal=int(causal),
                dtype=_DTYPE_CODE[q.dtype], scale=1.0 / d ** 0.5)
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(ctypes.byref(p), cuda.stream_of(q))
    cuda.check_launch(lib.repro_fa_error_string, rc, "flash_attention")
    cuda.count(flash_attention)
    return out


flash_attention.launches = 0
WRAPPERS = (flash_attention,)
