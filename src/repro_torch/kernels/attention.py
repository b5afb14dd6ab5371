"""CUDA flash-attention forward (K5): build, load and the launch wrappers.

``flash_attention`` replaces the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_fa_kernel``).  The kernels are in ``csrc/flash_attention.cu``; its
header comment gives their design and what bounds them.  Differences from
the Pallas wrapper, both in the function's favour: k/v may carry fewer
heads than q (grouped-query attention, read in place), and lengths that are
not a multiple of the block are masked instead of refused.

Two kernels compute the function, and ``choose_variant`` picks one by an
explicit rule on dtype, head dimension and layout:

* ``flash_attention_mma``: bf16 operands on the tensor cores
  (``mma.sync`` with f32 accumulation), K/V staged as bf16 by 16-byte
  copies.  It needs a head dimension that is a multiple of 8 and rows on
  16-byte boundaries (``rows_aligned``).
* ``flash_attention_fma``: everything else, f32 operands above all, on the
  FMA units.  Tensor cores would round f32 operands to TF32, which the f32
  tier forbids.

For tensors on the CPU ``flash_attention`` runs the plain PyTorch version
(``kernels/ref.py::flash_attention``); for CUDA tensors it launches one of
the two kernels or raises.  Each variant counts its launches in its own
``.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda, ref

#: block shape and head-dimension limit compiled into both kernels
BLOCK = (64, 64)
MAX_HEAD_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_VARIANT_CODE = {"fma": 0, "mma": 1}
_LL4 = ctypes.c_longlong * 4


class _Params(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "k", "v", "o")]
                + [(f, _LL4) for f in ("sq", "sk", "sv", "so")]
                + [(f, ctypes.c_int) for f in ("B", "H", "KV", "S", "SK",
                                               "D", "causal", "dtype")]
                + [("scale", ctypes.c_float), ("variant", ctypes.c_int)])


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


def rows_aligned(*ts: torch.Tensor) -> bool:
    """True if every tensor's rows can be read in 16-byte copies: unit
    last stride, every other stride a multiple of 16 bytes, and a 16-byte
    aligned base."""
    return all(t.stride(-1) == 1
               and all(s * t.element_size() % 16 == 0 for s in t.stride()[:-1])
               and t.data_ptr() % 16 == 0 for t in ts)


def choose_variant(dtype: torch.dtype, head_dim: int,
                   aligned: bool) -> str:
    """The K5 kernel for a call: ``"mma"`` (tensor cores) for bf16 with a
    head dimension that is a multiple of 8 and 16-byte aligned rows,
    ``"fma"`` for every other call, f32 above all."""
    if dtype == torch.bfloat16 and head_dim % 8 == 0 and aligned:
        return "mma"
    return "fma"


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"expected (B, H, S, D) q and equal (B, KV, Sk, D) "
                         f"k, v; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _launch(wrapper, variant: str, q, k, v, causal: bool) -> torch.Tensor:
    """Enqueue one launch of ``variant`` on CUDA tensors; the result is
    laid out like q."""
    if cuda.on_cpu(q, k, v):
        raise ValueError(f"{wrapper.__name__} launches a CUDA kernel; its "
                         f"tensors lie on the CPU")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA flash-attention kernels take f32 and "
                        f"bf16, not {q.dtype}")
    b, h, s, d = q.shape
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} exceeds the kernel's {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    if variant == "mma" and choose_variant(
            q.dtype, d, rows_aligned(q, k, v, out)) != "mma":
        raise ValueError(f"the tensor-core kernel takes bf16 with a head dim "
                         f"that is a multiple of 8 and 16-byte aligned rows; "
                         f"got {q.dtype}, D={d}, strides {q.stride()}")
    p = _Params(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                o=out.data_ptr(), sq=_LL4(*q.stride()), sk=_LL4(*k.stride()),
                sv=_LL4(*v.stride()), so=_LL4(*out.stride()), B=b, H=h,
                KV=k.shape[1], S=s, SK=k.shape[2], D=d, causal=int(causal),
                dtype=_DTYPE_CODE[q.dtype], scale=1.0 / d ** 0.5,
                variant=_VARIANT_CODE[variant])
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        rc = lib.repro_flash_attention(ctypes.byref(p), cuda.stream_of(q))
    cuda.check_launch(lib.repro_fa_error_string, rc, wrapper.__name__)
    cuda.count(wrapper)
    return out


def flash_attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """K5 on the tensor cores (CUDA tensors only; raises on a call the
    kernel does not take, see ``choose_variant``)."""
    _check(q, k, v)
    return _launch(flash_attention_mma, "mma", q, k, v, causal)


def flash_attention_fma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """K5 on the FMA units (CUDA tensors only; f32 or bf16, any strides)."""
    _check(q, k, v)
    return _launch(flash_attention_fma, "fma", q, k, v, causal)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """K5: softmax(q k^T / sqrt(d)) v, the Pallas kernel's function.

    q (B, H, S, D); k, v (B, KV, Sk, D) with H % KV == 0; any strides (a
    (B, S, H, D) tensor's ``transpose(1, 2)`` is taken as it is).  f32 or
    bf16, all three alike; the result is q.dtype (on the card laid out
    like q, so a transposed view comes back as one)."""
    _check(q, k, v)
    if cuda.on_cpu(q, k, v):
        return ref.flash_attention(q, k, v, causal=causal)
    # the output is allocated like q, so q's alignment stands for it
    if choose_variant(q.dtype, q.shape[3], rows_aligned(q, k, v)) == "mma":
        return _launch(flash_attention_mma, "mma", q, k, v, causal)
    return _launch(flash_attention_fma, "fma", q, k, v, causal)


flash_attention_mma.launches = 0
flash_attention_fma.launches = 0
WRAPPERS = (flash_attention_mma, flash_attention_fma)
