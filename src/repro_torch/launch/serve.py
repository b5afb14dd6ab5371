"""Serving launcher: prefill a batch of prompts, then greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        --reduced --device cpu

The counterpart of ``src/repro/launch/serve.py`` on one device (no mesh:
sharding is not ported yet).  Weights are random, drawn on the device from
seed 0; prompts are random tokens from a numpy generator of seed 0.  Prints
prefill ms, decode ms per step and decoded tokens per second.  Without
``--device`` it runs on the CUDA card and fails without one.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from ..configs.base import ARCH_IDS, get_config, get_reduced
from ..device import resolve_device
from ..models import decode as D
from ..models import lm as M


SEED = 0


def build_model(arch: str, reduced: bool = False, device=None) -> M.LM:
    """The model of ``arch`` (its reduced variant with ``reduced``) with
    weights drawn from ``SEED`` on ``device``."""
    cfg = get_reduced(arch) if reduced else get_config(arch)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return M.init_params(cfg, gen, dev)


def prompts(model: M.LM, batch: int, prompt_len: int) -> torch.Tensor:
    """Random prompt tokens in [1, vocab) on the model's device."""
    rng = np.random.default_rng(SEED)
    toks = rng.integers(1, model.cfg.vocab, (batch, prompt_len))
    return torch.from_numpy(toks).to(model.top["lm_head"].device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@torch.no_grad()
def serve(model: M.LM, tokens: torch.Tensor,
          max_new: int) -> Dict[str, object]:
    """Prefill ``tokens`` (B, S), then ``max_new - 1`` greedy decode steps.

    Returns the generated tokens (B, max_new), the prefill's last logits,
    and host-clock times that end in a device synchronise: prefill ms,
    decode ms per step and decoded tokens per second."""
    dev = tokens.device
    b, s = tokens.shape
    _sync(dev)
    t0 = time.perf_counter()
    cache, logits = D.prefill(model, tokens, s + max_new)
    tok = logits.argmax(-1, keepdim=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for _ in range(max_new - 1):
        cache, _, tok = D.decode_step(model, cache, tok)
        out.append(tok)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    steps = max_new - 1
    return {"tokens": torch.cat(out, dim=1), "prefill_logits": logits,
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_per_step": decode_s * 1e3 / max(steps, 1),
            "tok_per_s": steps * b / max(decode_s, 1e-9)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cpu, cuda or cuda:N (default: the CUDA card)")
    args = ap.parse_args(argv)

    model = build_model(args.arch, args.reduced, args.device)
    tokens = prompts(model, args.batch, args.prompt_len)
    r = serve(model, tokens, args.max_new)
    dev = tokens.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{model.cfg.name} on {where}")
    print(f"prefill {args.batch}x{args.prompt_len}: "
          f"{r['prefill_ms']:.1f} ms")
    print(f"decode {args.max_new - 1} steps: "
          f"{r['decode_ms_per_step']:.2f} ms/token "
          f"({r['tok_per_s']:.0f} tok/s)")
    print("sample:", r["tokens"][0][:12].tolist())


if __name__ == "__main__":
    main()
