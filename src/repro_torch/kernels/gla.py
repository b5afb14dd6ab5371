"""CUDA chunkwise gated linear attention (K6): build, load and the wrapper.

``gla`` replaces the TPU kernel ``src/repro/kernels/gla.py::gla`` (Pallas
``_gla_kernel``).  The kernels are in ``csrc/gla.cu``; its header comment
gives the design (the f32 state split along dv across blocks, the C x C
decayed scores staged once per chunk) and what bounds it.  Beyond the
Pallas wrapper's result it also returns the final state and normaliser,
which the serving path keeps as its cache.

For tensors on the CPU the wrapper runs the plain PyTorch version
(``kernels/ref.py::gla``); for CUDA tensors it launches the kernels (one C
call enqueues the score pass and the chunk walk) or raises.  It counts its
launches in ``gla.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda, ref

#: limits compiled into the kernel (the largest dk is read at load time)
MAX_CHUNK = 128
DV_TILE = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 2}
_LL4 = ctypes.c_longlong * 4


class _Params(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_void_p) for f in ("q", "k", "v", "la", "y",
                                                "state", "norm", "P", "F",
                                                "nin")]
                + [(f, _LL4) for f in ("sq", "sk", "sv", "sy")]
                + [("sla", ctypes.c_longlong * 3)]
                + [(f, ctypes.c_int) for f in ("B", "S", "H", "DK", "DV", "C",
                                               "normalize", "dtype")])


_config = {}


def _bind(lib: ctypes.CDLL) -> None:
    lib.repro_gla.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.repro_gla.restype = ctypes.c_int
    lib.repro_gla_error_string.argtypes = [ctypes.c_int]
    lib.repro_gla_error_string.restype = ctypes.c_char_p
    lib.repro_gla_params_size.restype = ctypes.c_int
    cfg = (ctypes.c_int * 3)()
    lib.repro_gla_config(cfg)
    if (lib.repro_gla_params_size() != ctypes.sizeof(_Params)
            or tuple(cfg)[:2] != (MAX_CHUNK, DV_TILE)):
        raise RuntimeError("the GLA library does not match the ctypes "
                           "layout in kernels/gla.py")
    _config["max_dk"] = cfg[2]


LIBRARY = cuda.CudaLibrary("gla.cu", "libgla", _bind)


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_a: torch.Tensor, *, chunk: int = 128, normalize: bool = True
        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """K6: chunkwise GLA from a zero state, the Pallas kernel's function.

    q, k (B, S, H, dk); v (B, S, H, dv); log_a (B, S, H), taken as f32;
    any strides.  q, k, v f32 or bf16 alike.  Returns y (B, S, H, dv) in
    v.dtype, and the final f32 state (B, H, dk, dv) and normaliser
    (B, H, dk).  S must be a multiple of ``chunk`` (as the Pallas wrapper
    requires)."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if k.shape != q.shape or v.shape[:3] != (b, s, h) or \
            log_a.shape != (b, s, h):
        raise ValueError(f"bad GLA shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, log_a "
                         f"{tuple(log_a.shape)}")
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if cuda.on_cpu(q, k, v, log_a):
        return ref.gla(q, k, v, log_a, chunk=chunk, normalize=normalize)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA GLA kernel takes f32 and bf16, not "
                        f"{q.dtype}")
    lib = LIBRARY.load()
    if not 1 <= chunk <= MAX_CHUNK or dk > _config["max_dk"]:
        raise ValueError(f"chunk {chunk} / dk {dk} exceed the kernel's "
                         f"limits {MAX_CHUNK} / {_config['max_dk']}")
    dev, f32 = q.device, torch.float32
    la = log_a.to(f32)
    nc = s // chunk
    y = torch.empty(b, s, h, dv, dtype=v.dtype, device=dev)
    state = torch.empty(b, h, dk, dv, dtype=f32, device=dev)
    norm = torch.empty(b, h, dk, dtype=f32, device=dev)
    scores = torch.empty(b * h, nc, chunk, chunk, dtype=f32, device=dev)
    F = torch.empty(b * h, nc, chunk, dtype=f32, device=dev)
    nin = torch.empty_like(F)
    p = _Params(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                la=la.data_ptr(), y=y.data_ptr(), state=state.data_ptr(),
                norm=norm.data_ptr(), P=scores.data_ptr(), F=F.data_ptr(),
                nin=nin.data_ptr(), sq=_LL4(*q.stride()),
                sk=_LL4(*k.stride()), sv=_LL4(*v.stride()),
                sy=_LL4(*y.stride()),
                sla=(ctypes.c_longlong * 3)(*la.stride()), B=b, S=s, H=h,
                DK=dk, DV=dv, C=chunk, normalize=int(normalize),
                dtype=_DTYPE_CODE[q.dtype])
    with torch.cuda.device(dev):
        rc = lib.repro_gla(ctypes.byref(p), cuda.stream_of(q))
    cuda.check_launch(lib.repro_gla_error_string, rc, "gla")
    cuda.count(gla)
    return y, (state, norm)


gla.launches = 0
WRAPPERS = (gla,)
