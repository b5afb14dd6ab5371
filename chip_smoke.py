#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one line per result; any failure exits non-zero:

1. identify the card (``nvidia-smi`` name and power limit, torch, CUDA);
2. build the kernel library from ``src/repro_torch/kernels/csrc``;
3. hold every kernel wrapper (K1 addmul, K2 addmul_epilogue, K3
   addmul_batched, K4 matmul) against its plain PyTorch version on the
   card: main-path tiles, a ragged tile, tiny tiles, both transpose flags,
   f64/f32/bf16, every epilogue instruction, mixed-dtype extras; K3 must
   equal K1/K2 per group bitwise; time kernel, plain version and the
   library call, and compute each kernel's bound;
4. the main path: all eight paper workloads at n=4096, tile 1024, f64
   through ``CMMEngine.run`` with the ``kernel`` and ``batched-cuda``
   executors, then Markov and Synth at n=8192, tile 2048, in f64 and f32.
   ``kernel`` must equal ``batched-cuda`` bitwise, the result must pass
   the check ``run(validate=True)`` makes against ``eager()`` on the card
   (``engine.assert_tier_close``), and the launch counters must account
   for every ADDMUL task;
5. mixed precision: Kmeans through ``batched-cuda`` with
   ``precision="mixed"`` against strict at 2e-2.

The JSON summary of the main path's kernels (K1-K3; K4 is off the path)
and the ``nvidia-smi`` line come before the last line, which is the JSON
device record.  Needs one CUDA card; exits
non-zero, printing no result, without one.
"""
from __future__ import annotations

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
    from repro_torch.core.engine import CMMEngine, assert_tier_close
    from repro_torch.core.fusion import fused_flops
    from repro_torch.core.graph import TaskKind, matmul_epilogue
    from repro_torch.exec.batched import group_wave
    from repro_torch.kernels import matmul as mm
    from repro_torch.kernels import ref
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
    mm.library()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         library=str(mm.library_path().relative_to(HERE)),
         nvcc_seconds=round(mm.build_seconds, 3))
    for line in mm.build_log.splitlines():
        if "registers" in line or "spill" in line:
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

    def check(name, got, want, dtype_name) -> float:
        rtol, atol = TOL[dtype_name]
        err = (got.double() - want.double()).abs()
        scale = max(1.0, float(want.double().abs().max()))
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
               moved, acc_name):
        b_ms, b_by, peak = bound(flops, moved, acc_name)
        emit("kernel", kernel=kernel, case=label, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
             bound_by=b_by, peak=peak, share_of_bound=b_ms / ms)
        if main:
            rows[kernel] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by,
                                library_ms=library_ms, case=label,
                                peak=peak)

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

    # -- summary ----------------------------------------------------------------
    replaces = {"addmul": "src/repro/kernels/matmul.py:263",
                "addmul_epilogue": "src/repro/kernels/matmul.py:181",
                "addmul_batched": "src/repro/kernels/ops.py:94"}
    kernels = []
    # matmul (K4) is checked and timed above but is not on the main path
    # (the tiler emits no C-less product), so the path's list leaves it out
    for k in ("addmul", "addmul_epilogue", "addmul_batched"):
        r = rows[k]
        kernels.append({
            "name": k, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/addmul.cu",
            "replaces": replaces[k], "launches": path_launches[k],
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
