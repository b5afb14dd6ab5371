#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line per result; any failure exits non-zero:

1. identify the card (``nvidia-smi`` name and power limit, torch, CUDA);
2. build the three kernel libraries from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, all started together;
3. hold every kernel wrapper (K1 addmul, K2 addmul_epilogue, K3
   addmul_batched, K4 matmul) against its plain PyTorch version on the
   card: main-path tiles, a ragged tile, tiny tiles, both transpose flags,
   f64/f32/bf16, every epilogue instruction, mixed-dtype extras; K3 must
   equal K1/K2 per group bitwise; time kernel, plain version and the
   library call, and compute each kernel's bound.  Integer products
   (int64, int32, int64 past its range) must equal the plain version
   exactly; torch has no CUDA integer matmul, so that runs on the host;
4. the main path: all eight paper workloads at n=4096, tile 1024, f64
   through ``CMMEngine.run`` with the ``kernel`` and ``batched-cuda``
   executors, then Markov and Synth at n=8192, tile 2048, in f64 and f32.
   ``kernel`` must equal ``batched-cuda`` bitwise, the result must pass
   the check ``run(validate=True)`` makes against ``eager()`` on the card
   (``engine.assert_tier_close``), and the launch counters must account
   for every ADDMUL task.  Then the probes of long epilogues (``A@B + R1
   + ... + R17``, ``A@B`` under 70 ``sin``: past the kernel's 16 extras and
   64 instructions) and of integer products (``I@J``, ``I@J - K``,
   ``sqrt(I@J + K) * 0.5``) through all four executors: ``kernel`` ≡
   ``batched-cuda`` bitwise, each result against ``eager()`` on the card
   at the tier, the integer ones exactly and against the host's too, and
   the launch counters showing the kernels ran them;
5. mixed precision: Kmeans through ``batched-cuda`` with
   ``precision="mixed"`` against strict at 2e-2;
6. hold K5 (flash attention) and K6 (chunkwise GLA) against their plain
   versions on the card at the serving shapes (qwen3-8b prefill
   attention: B=4, H=32, KV=8, S=512, D=128, bf16, causal; xlstm-1.3b
   prefill mLSTM: B=4, S=512, H=4, dk=dv=1024, chunk 128, bf16) and at
   small, ragged and non-causal shapes; K5's tensor-core kernel at D=64
   and 128, ragged S=100 and 70 with D=16 and 40, non-causal with Sk != S,
   GQA ratios 1 and 4, (B, S, H, D) views and contiguous (B, H, S, D),
   each call launching the variant ``choose_variant`` names; its FMA kernel
   at the f32 cases; K5 also against ``scaled_dot_product_attention``
   (timed as its library call, never used by the port); time kernel,
   plain version and library call (at the bf16 serving shape the FMA
   kernel on the same inputs too), and compute each kernel's bound;
7. LM serving at full width through ``repro_torch.launch.serve``:
   qwen3-8b (36 layers) and xlstm-1.3b (48 layers), random weights from
   seed 0, batch 4, prompt 512, 16 new tokens (prefill, then 15 greedy
   decode steps).  K5's tensor-core kernel (qwen3) or K6 (xlstm) must
   launch once per layer in the prefill, and the prefill's last-position
   logits must agree at the bf16 tier with the same model's prefill
   through the plain versions on the card.

The JSON summary of the kernels (K1-K6, K5 as its two variants; K4 is
checked and timed but is off every path, the f32 K5 kernel is off the bf16
serving path) and the ``nvidia-smi`` line come before the last line,
which is the JSON device record.  Needs one CUDA card; exits non-zero,
printing no result, without one.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published peaks of one H100 SXM (NVIDIA data sheet, dense): the least
#: time for a kernel's work is the larger of its FLOPs over the peak for
#: its operands' type and its bytes over the HBM rate
PEAK_FLOPS = {"float64": (67e12, "FP64 tensor core 67 TFLOP/s"),
              "float32": (67e12, "FP32 non-tensor 67 TFLOP/s"),
              "bfloat16": (989e12, "BF16 tensor core 989 TFLOP/s")}
HBM_BYTES_PER_S = 3.35e12

#: (rtol, atol); atol is scaled by max(1, max|want|).  A bf16 result is
#: accumulated in f32 by both the kernel and its plain version and rounded
#: once, so the two may land one bf16 ulp apart: rtol is two ulps at bf16's
#: widest relative spacing (2**-7, an 8-bit significand) and atol is f32's
TOL = {"float64": (1e-8, 1e-8), "float32": (1e-4, 1e-5),
       "bfloat16": (2 ** -6, 1e-5)}

#: every FUSED-program instruction at least once, over the accumulator
#: (slot 0) and two extras (slots 1, 2) of possibly different dtypes
PROG_EWISE = (("in", 0), ("scale", "mul", 1e-3, 0), ("ewise", "sin", 1),
              ("ewise", "cos", 1), ("ewise", "exp", 1),
              ("ewise", "tanh", 1), ("ewise", "abs", 1),
              ("ewise", "sqrt", 6), ("ewise", "sign", 1),
              ("add", 2, 3), ("add", 9, 4), ("ewmul", 10, 5),
              ("sub", 11, 7), ("add", 12, 8), ("ewise", "relu", 13))
PROG_SCALE = (("in", 0), ("in", 1), ("in", 2), ("add", 0, 1),
              ("sub", 3, 2), ("scale", "add", 1.5, 4),
              ("scale", "sub", 0.5, 5), ("scale", "rsub", 2.0, 6),
              ("scale", "scale", 0.25, 7), ("scale", "mul", -1.5, 8),
              ("scale", "ewmul", 0.5, 9), ("ewise", "abs", 10),
              ("scale", "add", 1.0, 11), ("scale", "rdiv", 3.0, 12),
              ("scale", "div", 7.0, 13), ("ewmul", 14, 2))
PROG_RELU = (("in", 0), ("scale", "sub", 0.5, 0), ("ewise", "relu", 1))


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def emit(tag: str, **kw) -> None:
    print(f"[{tag}] " + json.dumps(kw), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.core import ClusteredMatrix as CM
    from repro_torch.core.engine import (VALIDATE_TOL, CMMEngine,
                                         assert_tier_close)
    from repro_torch.core.fusion import fused_flops
    from repro_torch.core.graph import TaskKind, matmul_epilogue
    from repro_torch import kernels as K
    from repro_torch.exec.batched import group_wave
    from repro_torch.kernels import attention as fa
    from repro_torch.kernels import cuda
    from repro_torch.kernels import gla as gla_k
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
    from repro_torch.launch import serve
    from repro_torch.models import decode
    from repro_torch.models.lm import LM
    from repro_torch.suite import BENCHMARKS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    t_start = time.perf_counter()

    # -- 1. the card ----------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    smi_line = smi[torch.cuda.current_device()]
    emit("card", nvidia_smi=smi_line, torch=torch.__version__,
         cuda=torch.version.cuda, python=sys.version.split()[0])

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    cuda.build_all(K.libraries())
    emit("build", seconds=round(time.perf_counter() - t0, 3))
    for lib in K.libraries():
        emit("library", library=str(lib.path().relative_to(HERE)),
             nvcc_seconds=round(lib.build_seconds, 3))
        for line in lib.build_log.splitlines():
            if "entry function" in line or "registers" in line \
                    or "spill" in line:
                print("  ptxas: " + line.strip(), flush=True)

    # -- 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float64):
        return torch.randn(*shape, device=dev, generator=gen,
                           dtype=torch.float64).to(dtype)

    def timed(fn, min_seconds=0.05) -> float:
        """Mean ms per call: CUDA events over a run of calls after warm-up
        (the run grows until it spans ``min_seconds``)."""
        fn()
        torch.cuda.synchronize()
        reps = 1
        while True:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
            if ms >= min_seconds * 1e3 or reps >= 256:
                return ms / reps
            reps *= 2

    def check(name, got, want, dtype_name, atol_abs=None) -> float:
        """Elementwise ``|got - want| <= atol * max(1, max|want|) + rtol
        |want|`` at the dtype's tier; ``atol_abs`` replaces the absolute
        term where the tier's does not fit the function (K5 in bf16)."""
        rtol, atol = TOL[dtype_name]
        err = (got.double() - want.double()).abs()
        scale = max(1.0, float(want.double().abs().max()))
        if atol_abs is not None:
            atol, scale = atol_abs, 1.0
        bad = err > atol * scale + rtol * want.double().abs()
        if got.shape != want.shape or got.dtype != want.dtype or bool(
                bad.any()):
            fail(f"{name}: kernel disagrees with its plain version "
                 f"(max abs err {float(err.max())}, scale {scale})")
        return float(err.max())

    def bound(flops, nbytes, acc_name):
        peak, peak_name = PEAK_FLOPS[acc_name]
        t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes", peak_name)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    rows = {}     # kernel -> row of the JSON summary (main-path shape)

    def record(kernel, label, main, err, ms, plain_ms, library_ms, flops,
               moved, acc_name, **extra):
        b_ms, b_by, peak = bound(flops, moved, acc_name)
        emit("kernel", kernel=kernel, case=label, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
             bound_by=b_by, peak=peak, share_of_bound=b_ms / ms, **extra)
        if main:
            rows[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms, case=label,
                                peak=peak, **extra)

    def operands(m, k, n, dt, ta=False, tb=False):
        a = randn(k, m, dtype=dt).T if ta else randn(m, k, dtype=dt)
        b = randn(n, k, dtype=dt).T if tb else randn(k, n, dtype=dt)
        return a, b, randn(m, n, dtype=dt)

    def acc_name(a, b, *rest):
        """The type whose peak bounds the work: f64 if any operand is f64,
        bf16 when both factors are bf16 (tensor cores take them at the bf16
        rate, accumulating in f32), else f32."""
        if torch.float64 in [t.dtype for t in (a, b, *rest)]:
            return "float64"
        if a.dtype == b.dtype == torch.bfloat16:
            return "bfloat16"
        return "float32"

    cases = [  # (label, m, k, n, dtype, ta, tb, main-path timing row)
        ("main 1024 f64", 1024, 1024, 1024, torch.float64, False, False,
         True),
        ("main 2048 f64", 2048, 2048, 2048, torch.float64, False, False,
         False),
        ("main 2048 f32", 2048, 2048, 2048, torch.float32, False, False,
         False),
        ("1024 f32", 1024, 1024, 1024, torch.float32, False, False, False),
        ("1024 bf16", 1024, 1024, 1024, torch.bfloat16, False, False, False),
        ("ragged 1000 f32", 1000, 1000, 1000, torch.float32, False, False,
         False),
        ("ragged 1000 f64 A^T", 1000, 1000, 1000, torch.float64, True,
         False, False),
        ("ragged 1000 bf16 B^T", 1000, 1000, 1000, torch.bfloat16, False,
         True, False),
        ("tiny 4 f64 A^T B^T", 4, 4, 4, torch.float64, True, True, False),
        ("tiny 16 f32 B^T", 16, 16, 16, torch.float32, False, True, False),
        ("tiny 16 bf16 A^T", 16, 16, 16, torch.bfloat16, True, False,
         False),
    ]
    for label, m, k, n, dt, ta, tb, main in cases:
        a, b, c = operands(m, k, n, dt, ta, tb)
        an = acc_name(a, b, c)
        dn = str(dt).split(".")[1]
        flops = 2 * m * n * k
        # K1
        err = check(f"K1 {label}", mm.addmul(c, a, b), ref.addmul(c, a, b),
                    dn)
        out = torch.empty_like(c)
        record("addmul", label, main, err,
               timed(lambda: mm.addmul(c, a, b, out=out)),
               timed(lambda: ref.addmul(c, a, b)),
               timed(lambda: torch.addmm(c, a, b)), flops,
               nbytes(a, b, c, c), an)
        # K4
        err = check(f"K4 {label}", mm.matmul(a, b), ref.matmul(a, b), dn)
        record("matmul", label, main, err, timed(lambda: mm.matmul(a, b)),
               timed(lambda: ref.matmul(a, b)),
               timed(lambda: torch.mm(a, b)), flops, nbytes(a, b, c), an)
        # K2: three programs cover every instruction; extras of mixed types
        e1 = randn(m, n, dtype=torch.float32)
        e2 = randn(m, n, dtype=torch.bfloat16 if dt == torch.float32
                   else torch.float32)
        for pname, prog, extras in (("ewise", PROG_EWISE, []),
                                    ("scale", PROG_SCALE, [e1, e2]),
                                    ("relu", PROG_RELU, [])):
            got = mm.addmul_epilogue(c, a, b, *extras, prog=prog)
            want = ref.addmul(c, a, b, prog=prog, extras=extras)
            err = check(f"K2 {pname} {label}", got, want,
                        str(got.dtype).split(".")[1])
            if pname == "relu":
                record("addmul_epilogue", f"{label} relu", main, err,
                       timed(lambda: mm.addmul_epilogue(c, a, b, prog=prog)),
                       timed(lambda: ref.addmul(c, a, b, prog=prog)), None,
                       flops + fused_flops(prog, m, n), nbytes(a, b, c, c),
                       an)
        # mixed-precision store (bf16 out from an f32 accumulator)
        if dt == torch.float32:
            got = mm.addmul_epilogue(c, a, b, prog=PROG_RELU,
                                     out_dtype=torch.bfloat16)
            check(f"K2 bf16-store {label}", got,
                  ref.addmul(c, a, b, prog=PROG_RELU,
                             out_dtype=torch.bfloat16), "bfloat16")

    # K3: a wave group of main-path tiles; each member bitwise = K1 / K2
    for label, G, m, dt, main in (("main G=16 1024 f64", 16, 1024,
                                   torch.float64, True),
                                  ("main G=4 2048 f32", 4, 2048,
                                   torch.float32, False),
                                  ("ragged G=3 1000 bf16 A^T", 3, 1000,
                                   torch.bfloat16, False),
                                  ("tiny G=9 4 f32 B^T", 9, 4,
                                   torch.float32, False)):
        ta, tb = "A^T" in label, "B^T" in label
        a3 = randn(G, m, m, dtype=dt)
        b3 = randn(G, m, m, dtype=dt)
        a3 = a3.transpose(1, 2) if ta else a3
        b3 = b3.transpose(1, 2) if tb else b3
        c3 = randn(G, m, m, dtype=dt)
        e3 = randn(G, m, m, dtype=torch.float32)
        dn = str(dt).split(".")[1]
        plain3 = mm.addmul_batched(c3, a3, b3)
        epi3 = mm.addmul_batched(c3, a3, b3, prog=PROG_SCALE[:3] + (
            ("add", 0, 1), ("ewise", "relu", 3)), extras=[e3, e3])
        for g in range(G):
            if not torch.equal(plain3[g], mm.addmul(c3[g], a3[g], b3[g])):
                fail(f"K3 {label}: group {g} differs from K1")
            if not torch.equal(epi3[g], mm.addmul_epilogue(
                    c3[g], a3[g], b3[g], e3[g], e3[g],
                    prog=PROG_SCALE[:3] + (("add", 0, 1),
                                           ("ewise", "relu", 3)))):
                fail(f"K3 {label}: group {g} differs from K2")
        err = check(f"K3 {label}", plain3, ref.addmul(c3, a3, b3), dn)
        out3 = torch.empty_like(c3)
        record("addmul_batched", label, main, err,
               timed(lambda: mm.addmul_batched(c3, a3, b3, out=out3)),
               timed(lambda: ref.addmul(c3, a3, b3)),
               timed(lambda: torch.baddbmm(c3, a3, b3)), 2 * G * m ** 3,
               nbytes(a3, b3, c3, c3), acc_name(a3, b3, c3))

    # integer products: exact int64 accumulation, wrapping as NumPy's does
    # (a sum modulo 2^64 does not depend on its order, so even the wrap
    # case is exact); the plain version runs on the host
    for label, m, k, n, dt, hi, ta in (
            ("int64 1024", 1024, 1024, 1024, torch.int64, 1000, False),
            ("ragged int64 1000 A^T", 1000, 1000, 1000, torch.int64, 1000,
             True),
            ("tiny int32 16", 16, 16, 16, torch.int32, 1000, False),
            ("tiny int64 16 past 2^63", 16, 16, 16, torch.int64, 2 ** 40,
             False)):
        def randint(*shape):
            return torch.randint(-hi, hi, shape, device=dev, generator=gen,
                                 dtype=dt)
        a = randint(k, m).T if ta else randint(m, k)
        b, c = randint(k, n), randint(m, n)
        c3, a3, b3 = randint(3, m, n), randint(3, m, k), randint(3, k, n)
        host = [t.cpu() for t in (c, a, b)]
        host3 = [t.cpu() for t in (c3, a3, b3)]
        for name, got, want in (
                ("K1", mm.addmul(c, a, b), ref.addmul(*host)),
                ("K4", mm.matmul(a, b), ref.matmul(*host[1:])),
                ("K3", mm.addmul_batched(c3, a3, b3), ref.addmul(*host3))):
            if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
                fail(f"{name} {label}: not equal to the plain version")
        emit("kernel_int", case=label, dtype=str(dt).split(".")[1],
             exact=["K1", "K4", "K3"])
    torch.cuda.synchronize()

    # -- 4. the main path ------------------------------------------------------
    def addmul_counts(plan):
        tasks = [t for t in plan.program.graph if t.kind is TaskKind.ADDMUL]
        epi = sum(1 for t in tasks if matmul_epilogue(t.payload) is not None)
        groups = sum(1 for w in plan.waves
                     for key, _ in group_wave(plan.program.graph, w,
                                              plan.program.dtypes)
                     if key[0] is TaskKind.ADDMUL)
        return len(tasks), epi, groups

    def launches():
        return {w.__name__: w.launches for w in mm.WRAPPERS}

    runs = [(name, 4096, 1024, torch.float64) for name in BENCHMARKS]
    runs += [(name, 8192, 2048, dt) for name in ("Markov", "Synth")
             for dt in (torch.float64, torch.float32)]
    mm.reset_launches()
    for name, n, tile, dt in runs:
        engine = CMMEngine()                      # device None: the card
        expr = BENCHMARKS[name](n, dtype=dt)
        t0 = time.perf_counter()
        plan = engine.plan(expr, tile=tile)
        plan_s = time.perf_counter() - t0
        n_addmul, n_epi, n_groups = addmul_counts(plan)
        out = {}
        for ex in ("kernel", "batched-cuda"):
            before = launches()
            t0 = time.perf_counter()
            out[ex] = engine.run(expr, executor=ex, plan=plan)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = launches()
            delta = {k: after[k] - before[k] for k in after}
            want = ({"addmul": n_addmul - n_epi, "addmul_epilogue": n_epi,
                     "addmul_batched": 0, "matmul": 0} if ex == "kernel"
                    else {"addmul": 0, "addmul_epilogue": 0,
                          "addmul_batched": n_groups, "matmul": 0})
            if delta != want:
                fail(f"{name} n={n} {ex}: launches {delta}, want {want}")
            # host seconds inside the executor's spans, by task kind: FILL
            # draws and copies synchronously; an ADDMUL span is the
            # kernel's enqueue (longer only when the launch queue is full)
            host = {}
            for sp in engine.last_spans:
                host[sp.name] = host.get(sp.name, 0.0) + sp.dur
            emit("path", workload=name, n=n, tile=tile,
                 dtype=str(dt).split(".")[1], executor=ex,
                 wall_s=wall, plan_s=plan_s,
                 tasks=len(plan.program.graph), addmul_tasks=n_addmul,
                 launches=delta, host_span_s=host)
        if not torch.equal(out["kernel"], out["batched-cuda"]):
            fail(f"{name} n={n}: kernel and batched-cuda differ")
        t0 = time.perf_counter()
        oracle = expr.eager(engine.device)
        try:
            assert_tier_close(out["kernel"], oracle)
        except AssertionError as e:
            fail(f"{name} n={n} {dt}: result vs eager(): {e}")
        emit("validate", workload=name, n=n, dtype=str(dt).split(".")[1],
             kernel_eq_batched_cuda=True,
             eager_s=time.perf_counter() - t0,
             max_abs_err=float((out["kernel"].double()
                                - oracle.double()).abs().max()),
             max_abs_ref=float(oracle.double().abs().max()))
        del out, oracle
    path_launches = launches()
    for k in ("addmul", "addmul_epilogue", "addmul_batched"):
        if path_launches[k] == 0:
            fail(f"kernel {k} was never launched on the main path")

    # probes: epilogues past the kernel's limits (the kernel runs a head of
    # the program, eval_fused the rest) and integer products (exact; torch
    # has no CUDA integer matmul, so every executor runs them in K1/K3)
    def leaf(t):
        return CM.from_array(t)

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n, n), device=dev, generator=gen)

    def probe_exprs():
        n = 2048
        a, b = leaf(randn(n, n)), leaf(randn(n, n))
        extras17 = a @ b
        for _ in range(17):
            extras17 = extras17 + leaf(randn(n, n))
        sin70 = a @ b
        for _ in range(70):
            sin70 = sin70.ewise("sin")
        yield "17 extras", 2048, 512, extras17
        yield "70 sin", 2048, 512, sin70
        n = 1024
        i, j = leaf(randint(3000, 12000, n)), leaf(randint(3000, 12000, n))
        k = leaf(randint(-50, 50, n))
        yield "I@J", n, 256, i @ j
        yield "I@J-K", n, 256, i @ j - k
        yield "sqrt(I@J+K)*0.5", n, 256, (i @ j + k).ewise("sqrt") * 0.5

    for name, n, tile, expr in probe_exprs():
        engine = CMMEngine()
        plan = engine.plan(expr, tile=tile)
        n_addmul, n_epi, n_groups = addmul_counts(plan)
        integer = name.startswith(("I", "sqrt(I"))
        oracle = expr.eager(engine.device)
        out = {}
        for ex in ("local", "batched", "kernel", "batched-cuda"):
            before = launches()
            out[ex] = engine.run(expr, executor=ex, plan=plan)
            torch.cuda.synchronize()
            after = launches()
            delta = {k: after[k] - before[k] for k in after}
            want = dict.fromkeys(delta, 0)
            if ex in ("batched", "batched-cuda") and (
                    integer or ex == "batched-cuda"):
                want["addmul_batched"] = n_groups
            elif integer:
                want["addmul"] = n_addmul          # no epilogue in the kernel
            elif ex == "kernel":
                want.update(addmul=n_addmul - n_epi, addmul_epilogue=n_epi)
            if delta != want:
                fail(f"probe {name} {ex}: launches {delta}, want {want}")
            try:
                if integer and out[ex].dtype == torch.int64:
                    if not torch.equal(out[ex], oracle):
                        raise AssertionError("not equal")
                else:
                    assert_tier_close(out[ex], oracle)
            except AssertionError as e:
                fail(f"probe {name} {ex}: result vs eager(): {e}")
        if not torch.equal(out["kernel"], out["batched-cuda"]):
            fail(f"probe {name}: kernel and batched-cuda differ")
        host_equal = None
        if integer:
            host = expr.eager("cpu")
            host_equal = out["kernel"].dtype == host.dtype and (
                torch.equal(out["kernel"].cpu(), host)
                if host.dtype == torch.int64 else None)
            if host_equal is False:
                fail(f"probe {name}: differs from the host's int64 result")
            if host_equal is None:
                assert_tier_close(out["kernel"].cpu(), host)
        emit("probe", expr=name, n=n, tile=tile,
             dtype=str(out["kernel"].dtype).split(".")[1],
             kernel_eq_batched_cuda=True, addmul_tasks=n_addmul,
             epilogue_tasks=n_epi, equal_to_host=host_equal,
             max_abs_err_vs_eager=float((out["kernel"].double()
                                         - oracle.double()).abs().max()))
        del out, oracle

    # -- 5. mixed precision -----------------------------------------------------
    engine = CMMEngine()
    expr = BENCHMARKS["Kmeans"](4096)
    plan = engine.plan(expr, tile=1024)
    strict = engine.run(expr, executor="batched-cuda", plan=plan)
    mixed = engine.run(expr, executor="batched-cuda", plan=plan,
                       precision="mixed")
    try:
        assert_tier_close(mixed, strict, tol=2e-2)
    except AssertionError as e:
        fail(f"mixed precision vs strict: {e}")
    rel = float((mixed.double() - strict).abs().max()
                / strict.abs().max())
    emit("mixed", workload="Kmeans", n=4096, tile=1024, dtype_out=str(
        mixed.dtype).split(".")[1], max_err_over_max_ref=rel, tol=2e-2)

    # -- 6. K5 and K6 against their plain versions ----------------------------
    def dn_(dtype):
        return str(dtype).split(".")[1]

    def dn(t):
        return dn_(t.dtype)

    def fa_bound_work(q, k, v, o, causal):
        """FLOPs and bytes one attention call needs: 4 D FLOPs per (row,
        col) pair that is not masked (the causal triangle), q/k/v read and
        o written once."""
        b, h, s, d = q.shape
        sk = k.shape[2]
        pairs = sum(min(r + 1, sk) for r in range(s)) if causal else s * sk
        return 4 * d * pairs * b * h, nbytes(q, k, v, o)

    bf16, f32 = torch.bfloat16, torch.float32
    fa_cases = [  # (label, B, H, KV, S, Sk, D, dtype, causal, layout, main)
        ("qwen3-8b prefill", 4, 32, 8, 512, 512, 128, bf16, True, "BSHD",
         True),
        ("D=64 GQA 4", 2, 16, 4, 512, 512, 64, bf16, True, "BSHD", False),
        ("GQA 1 D=128", 2, 8, 8, 256, 256, 128, bf16, True, "BSHD", False),
        ("ragged S=100 D=16", 2, 4, 2, 100, 100, 16, bf16, True, "BSHD",
         False),
        ("ragged S=70 D=40 non-causal", 1, 2, 1, 70, 70, 40, bf16, False,
         "BSHD", False),
        ("non-causal Sk=384 S=256", 2, 8, 2, 256, 384, 128, bf16, False,
         "BSHD", False),
        ("causal Sk=70 S=130", 1, 4, 4, 130, 70, 64, bf16, True, "BSHD",
         False),
        ("contiguous (B,H,S,D)", 2, 8, 2, 200, 200, 128, bf16, True, "BHSD",
         False),
        ("non-causal MHA", 2, 8, 8, 256, 256, 64, bf16, False, "BSHD",
         False),
        ("qwen3-8b prefill f32", 4, 32, 8, 512, 512, 128, f32, True, "BSHD",
         True),
        ("small ragged GQA f32", 2, 4, 2, 100, 100, 16, f32, True, "BSHD",
         False),
        ("small ragged non-causal f32", 1, 2, 1, 70, 70, 40, f32, False,
         "BSHD", False),
    ]
    fa_variants = {"mma": fa.flash_attention_mma,
                   "fma": fa.flash_attention_fma}
    for label, b, h, kvh, s, sk, d, dt, causal, layout, main in fa_cases:
        def qkv(heads, length):
            if layout == "BSHD":    # the serving layout, seen as views
                return randn(b, length, heads, d, dtype=dt).transpose(1, 2)
            return randn(b, heads, length, d, dtype=dt)
        q, k, v = qkv(h, s), qkv(kvh, sk), qkv(kvh, sk)
        variant = fa.choose_variant(dt, d, fa.rows_aligned(q, k, v))
        if variant != ("mma" if dt == bf16 else "fma"):
            fail(f"K5 {label}: the rule chose {variant}")
        wrapper = fa_variants[variant]
        before = wrapper.launches
        got = fa.flash_attention(q, k, v, causal=causal)
        if wrapper.launches != before + 1:
            fail(f"K5 {label}: flash_attention did not launch {variant}")
        # bf16: the two round the probabilities to bf16 against different
        # running maxima (one rounding, 2^-8 relative, each); the output,
        # a convex combination of v's rows, may then move by 2^-8 max|v|:
        # the gate allows twice that, beside two ulps of each value
        atol = 2 ** -7 * float(v.abs().max()) if dt == bf16 else None
        err = check(f"K5 {variant} {label}", got, ref.flash_attention(
            q, k, v, causal=causal), dn(q), atol)
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
        check(f"K5 {variant} {label} vs scaled_dot_product_attention", got,
              sdpa, dn(q), atol)
        extra = {}
        if main and variant == "mma":
            # the FMA kernel on the same inputs, timed in this run
            err_fma = check(f"K5 fma {label}", fa.flash_attention_fma(
                q, k, v, causal=causal), ref.flash_attention(
                q, k, v, causal=causal), dn(q), atol)
            extra = dict(fma_ms_same_inputs=timed(
                lambda: fa.flash_attention_fma(q, k, v, causal=causal)),
                fma_max_abs_err=err_fma)
        flops, moved = fa_bound_work(q, k, v, got, causal)
        record(f"flash_attention_{variant}", label, main, err,
               timed(lambda: wrapper(q, k, v, causal=causal)),
               timed(lambda: ref.flash_attention(q, k, v, causal=causal)),
               timed(lambda: torch.nn.functional.scaled_dot_product_attention(
                   q, k, v, is_causal=causal, enable_gqa=True)),
               flops, moved, dn(q), **extra)
    if rows["flash_attention_mma"]["ms"] >= rows["flash_attention_mma"][
            "fma_ms_same_inputs"]:
        print("NOTE: the tensor-core K5 was not faster than the FMA kernel "
              "on the same inputs in this run", flush=True)

    def gla_bound_work(q, k, v, la, y, st, nm, chunk):
        """FLOPs and bytes one GLA call needs, all in f32: per chunk the
        intra-chunk triangle (q.k and the scores times v), the state
        update, and, after the first chunk (whose state is zero), the
        inter-chunk product; inputs read and outputs written once."""
        b, s, h, dk = q.shape
        dv = v.shape[-1]
        nc = s // chunk
        tri = chunk * (chunk + 1) // 2
        per_chunk = 2 * tri * (dk + dv) + 2 * chunk * dk * (dv + 1)
        inter = 2 * chunk * dk * (dv + 1)
        flops = b * h * (nc * per_chunk + (nc - 1) * inter)
        return flops, nbytes(q, k, v, la, y, st, nm)

    gla_cases = [  # (label, B, S, H, dk, dv, chunk, dtype, normalize,
        #             forget-gate bias, main)
        ("xlstm-1.3b prefill", 4, 512, 4, 1024, 1024, 128, torch.bfloat16,
         True, 0.0, True),
        ("xlstm-1.3b prefill, slow decay", 4, 512, 4, 1024, 1024, 128,
         torch.bfloat16, True, 3.0, False),
        ("small", 2, 64, 3, 8, 16, 16, torch.float32, True, 3.0, False),
        ("ragged widths and chunk, no normaliser", 1, 96, 2, 40, 70, 48,
         torch.float32, False, 3.0, False),
    ]
    for label, b, s, h, dk, dv, chunk, dt, norm, bias, main in gla_cases:
        q = randn(b, s, h, dk, dtype=dt)
        k = (randn(b, s, h, dk) / dk ** 0.5).to(dt)
        v = randn(b, s, h, dv, dtype=dt)
        # the mLSTM's forget gate, log sigmoid of a pre-activation: at
        # bias 0 it decays as the random-weight model's does (mean log
        # decay ~ -0.8 a step, e^-100 over a chunk), at 3 slowly
        la = torch.nn.functional.logsigmoid(
            randn(b, s, h, dtype=torch.float32) + bias)
        y, (st, nm) = gla_k.gla(q, k, v, la, chunk=chunk, normalize=norm)
        y_p, (st_p, nm_p) = ref.gla(q, k, v, la, chunk=chunk,
                                    normalize=norm)
        err = check(f"K6 {label} y", y, y_p, dn(y))
        check(f"K6 {label} state", st, st_p, "float32")
        check(f"K6 {label} norm", nm, nm_p, "float32")
        flops, moved = gla_bound_work(q, k, v, la, y, st, nm, chunk)
        record("gla", label, main, err,
               timed(lambda: gla_k.gla(q, k, v, la, chunk=chunk,
                                       normalize=norm)),
               timed(lambda: ref.gla(q, k, v, la, chunk=chunk,
                                     normalize=norm)),
               None, flops, moved, "float32")
    torch.cuda.synchronize()

    # -- 7. LM serving at full width -------------------------------------------
    def all_launches():
        return {w.__name__: w.launches for w in K.wrappers()}

    def prefill_logits(model, tokens, kernels):
        with torch.no_grad():
            return decode.prefill(model, tokens, tokens.shape[1],
                                  kernels=kernels)[1]

    def cast(model, dtype):
        """A copy of ``model`` with its weights (and cache type) in dtype."""
        out = LM(dataclasses.replace(model.cfg, dtype=dn_(dtype)), dev, dtype)
        with torch.no_grad():
            for a, b in zip(model.parameters(), out.parameters()):
                b.copy_(a)
        return out

    def device_profile(fn, kernel_names):
        """Run ``fn`` under ``torch.profiler``: device busy ms (the sum of
        the device-side events' times: kernels and copies), ms in the
        named kernels, kernel launches, and the host wall ms (inflated by
        the profiler)."""
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = named = 0.0
        n_launch = 0
        for e in prof.key_averages():
            if "LaunchKernel" in e.key:
                n_launch += e.count
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue                  # host ops: their kernels count
            busy += e.self_device_time_total
            if any(k in e.key for k in kernel_names):
                named += e.self_device_time_total
        return {"device_busy_ms": busy / 1e3, "kernel_ms": named / 1e3,
                "launches": n_launch, "profiled_wall_ms": wall * 1e3}

    serve_launches = {}
    for arch, kernel in (("qwen3-8b", "flash_attention_mma"),
                         ("xlstm-1.3b", "gla")):
        t0 = time.perf_counter()
        model = serve.build_model(arch, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        cfg = model.cfg
        tokens = serve.prompts(model, 4, 512)
        serve.serve(model, tokens[:, :128], 2)          # warm-up
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        r = serve.serve(model, tokens, 16)              # the main path
        counts = all_launches()
        want = {w: 0 for w in counts}
        want[kernel] = cfg.n_layers
        if counts != want:
            fail(f"{arch} serving: launches {counts}, want {want}")
        serve_launches[kernel] = counts[kernel]
        peak = torch.cuda.max_memory_allocated()
        finite = bool(torch.isfinite(r["prefill_logits"]).all())
        if tuple(r["tokens"].shape) != (4, 16) or not finite:
            fail(f"{arch} serving: tokens {tuple(r['tokens'].shape)}, "
                 f"finite logits {finite}")
        # where the time goes: one traced prefill and three traced decode
        # steps (after the counts were read: these launches are not the
        # main path's)
        names = {"flash_attention_mma": ("fa_mma",),
                 "gla": ("gla_scores", "gla_state")}[kernel]
        pre_prof = device_profile(lambda: decode.prefill(
            model, tokens, 512 + 4), names)
        cache, logits = decode.prefill(model, tokens, 512 + 4)
        tok = logits.argmax(-1, keepdim=True)

        def three_steps():
            nonlocal cache, tok
            for _ in range(3):
                cache, _, tok = decode.decode_step(model, cache, tok)

        dec_prof = device_profile(three_steps, names)
        del cache, logits, tok
        emit("serve_profile", arch=arch, prefill=pre_prof,
             prefill_idle_share=1 - pre_prof["device_busy_ms"]
             / r["prefill_ms"],
             decode_3_steps=dec_prof,
             decode_idle_share=1 - dec_prof["device_busy_ms"] / 3
             / r["decode_ms_per_step"])
        # the reference on the card: the same weights through the plain
        # versions, in bf16 as served and in an f32 copy
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = prefill_logits(model, tokens, kernels=False)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = r["prefill_logits"]
        m32 = cast(model, torch.float32)
        got32 = prefill_logits(m32, tokens, kernels=True)
        plain32 = prefill_logits(m32, tokens, kernels=False)
        del m32
        # f32: the kernels against their plain versions through the whole
        # model, at the f32 tier
        try:
            assert_tier_close(got32, plain32)
        except AssertionError as e:
            fail(f"{arch} f32 prefill logits, kernels vs plain versions: {e}")
        # bf16 as served: at the bf16 tier, or within the bf16 model's own
        # rounding error (bf16 vs f32 weights, plain versions) where that
        # is the larger: a model that amplifies one-ulp differences moves
        # by that much whichever way its attention is summed
        own = float((plain.double() - plain32.double()).abs().max())
        err = float((got.double() - plain.double()).abs().max())
        tier = VALIDATE_TOL[torch.bfloat16] * max(
            1.0, float(plain.double().abs().max()))
        if err > max(tier, own):
            fail(f"{arch} bf16 prefill logits, kernels vs plain versions: "
                 f"max abs err {err} > max(bf16 tier {tier}, the bf16 "
                 f"model's own error {own})")
        emit("serve", arch=arch, layers=cfg.n_layers,
             params=sum(t.numel() for t in model.parameters()),
             batch=4, prompt=512, new_tokens=16, init_s=init_s,
             prefill_ms=r["prefill_ms"],
             decode_ms_per_token=r["decode_ms_per_step"],
             tok_per_s=r["tok_per_s"], max_memory_gb=peak / 1e9,
             launches=counts, prefill_plain_ms=plain_ms,
             logits_max_abs=float(plain.double().abs().max()),
             bf16_kernel_vs_plain_max_abs_err=err, bf16_tier_atol=tier,
             bf16_vs_f32_plain_max_abs_err=own,
             f32_kernel_vs_plain_max_abs_err=float(
                 (got32.double() - plain32.double()).abs().max()),
             sample=r["tokens"][0].tolist())
        del model, r, plain, got, got32, plain32
        torch.cuda.empty_cache()

    # -- summary ----------------------------------------------------------------
    csrc = "src/repro_torch/kernels/csrc/"
    table = (  # kernel, TPU kernel it replaces, source, main-path launches
        ("addmul", "src/repro/kernels/matmul.py:263", "addmul.cu",
         path_launches["addmul"]),
        ("addmul_epilogue", "src/repro/kernels/matmul.py:181", "addmul.cu",
         path_launches["addmul_epilogue"]),
        ("addmul_batched", "src/repro/kernels/ops.py:94", "addmul.cu",
         path_launches["addmul_batched"]),
        # the tiler emits no C-less product: K4 is off every path
        ("matmul", "src/repro/kernels/matmul.py:229", "addmul.cu", 0),
        ("flash_attention_mma", "src/repro/kernels/flash_attention.py:87",
         "flash_attention.cu", serve_launches["flash_attention_mma"]),
        # f32 (and layouts the 16-byte copies cannot read) only: the bf16
        # serving path never runs it
        ("flash_attention_fma", "src/repro/kernels/flash_attention.py:87",
         "flash_attention.cu", 0),
        ("gla", "src/repro/kernels/gla.py:93", "gla.cu",
         serve_launches["gla"]),
    )
    kernels = []
    for k, replaces, src, n in table:
        r = rows[k]
        kernels.append({
            "name": k, "route": "cuda", "source": csrc + src,
            "replaces": replaces, "launches": n,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "case": r["case"], "peak": r["peak"]})
    emit("done", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
