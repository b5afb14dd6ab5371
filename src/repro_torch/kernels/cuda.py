"""Build, load and launch the hand-written CUDA kernels.

Each source in ``csrc/`` has a plain C interface (no PyTorch headers, so a
build takes seconds).  It is compiled with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/<hash of source and flags>/<name>.so`` at first use and
loaded with ``ctypes``.  ``build_all`` starts one ``nvcc`` per source at
once, so a fresh checkout pays for the slowest build, not the sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class CudaLibrary:
    """One ``csrc/<source>`` compiled into ``<name>.so``; ``bind(lib)``
    sets the C functions' ctypes signatures and checks the layout the
    library was built with (raising on a mismatch)."""

    def __init__(self, source: str, name: str,
                 bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self.name = name
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        #: what the last build printed (``-Xptxas -v``: registers, spills)
        #: and how long it took
        self.build_log = ""
        self.build_seconds = 0.0

    def path(self) -> Path:
        """Where the library built from the current source and flags lives."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_ROOT / h.hexdigest()[:16] / f"{self.name}.so"

    def build(self) -> Path:
        """Compile the source unless this source was built already."""
        with self._lock:
            out = self.path()
            if out.exists():
                return out
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f".{os.getpid()}.{out.name}")
            t0 = time.perf_counter()
            res = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True)
            self.build_seconds = time.perf_counter() - t0
            self.build_log = res.stdout + res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source}:\n{self.build_log}")
            os.replace(tmp, out)
            return out

    def load(self) -> ctypes.CDLL:
        """The loaded library, built at first use (later calls cost one
        attribute read: every launch calls this)."""
        if self._lib is None:
            path = self.build()
            with self._lock:
                if self._lib is None:
                    lib = ctypes.CDLL(str(path))
                    self._bind(lib)
                    self._lib = lib
        return self._lib


def build_all(libs: Sequence[CudaLibrary]) -> None:
    """Build (and load) every library, one ``nvcc`` per source, all at once;
    raises the first failure after all have finished."""
    errors: list = []

    def one(lib):
        try:
            lib.load()
        except BaseException as e:          # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(lib,)) for lib in libs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


def check_launch(err_string, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code; ``err_string``
    is the library's ``cudaGetErrorString`` export."""
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({err_string(rc).decode()})")


# -- wrappers' shared checks and launch counts --------------------------------

_count_lock = threading.Lock()


def count(wrapper) -> None:
    """Add one to ``wrapper.launches``: called where a kernel is launched,
    and nowhere else."""
    with _count_lock:
        wrapper.launches += 1


def reset(wrappers) -> None:
    """Set each wrapper's launch count to 0."""
    with _count_lock:
        for w in wrappers:
            w.launches = 0


def on_cpu(*ts) -> bool:
    """True if every tensor lies on the CPU, False if all lie on one CUDA
    device; raises for any other mix."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current stream on ``t``'s device, for a launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
