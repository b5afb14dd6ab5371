"""The LM serving slice against the JAX reference, on the CPU.

For each ported architecture (reduced config, f32 weights and cache) the
reference's ``init_params`` draws the weights, ``convert.params_from_jax``
carries them over, and both packages run prefill and then four decode
steps fed the same tokens.  Compared: the prefill's last-position logits,
the caches it builds (post-RoPE K/V, or GLA state and normaliser), and each
decode step's logits, at max|got - want| <= 1e-4 max|want| elementwise
(f32; logits are compared, never argmax tokens, which a last-bit
difference could flip).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_plan as ref_get_plan
from repro.configs.base import get_reduced as ref_get_reduced
from repro.models import lm as ref_lm
from repro.train.steps import make_decode_step, make_prefill_step
from repro_torch import convert, kernels
from repro_torch.configs.base import ARCH_IDS, get_config, get_reduced
from repro_torch.launch import serve
from repro_torch.models import decode, lm

B, S, STEPS = 2, 32, 4


def _close(got: torch.Tensor, want):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


@pytest.fixture(scope="module", params=ARCH_IDS)
def runs(request):
    """Both packages' prefill and decode outputs for one architecture."""
    arch = request.param
    ref_cfg = dataclasses.replace(ref_get_reduced(arch), dtype="float32")
    plan = ref_get_plan(arch, "default")
    params = ref_lm.init_params(ref_cfg, jax.random.PRNGKey(0), jnp.float32)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, ref_cfg.vocab, (B, S + STEPS))

    pre = jax.jit(make_prefill_step(ref_cfg, plan, max_len=S + STEPS))
    dec = jax.jit(make_decode_step(ref_cfg, plan))
    cache, logits, _ = pre(params, {"tokens": jnp.asarray(toks[:, :S],
                                                          jnp.int32)})
    ref = {"prefill": np.asarray(logits),
           "cache": {k: np.asarray(v) for k, v in cache.items()},
           "steps": []}
    for t in range(STEPS):
        cache, logits, _ = dec(params, cache, jnp.asarray(
            toks[:, S + t:S + t + 1], jnp.int32))
        ref["steps"].append(np.asarray(logits))

    cfg = dataclasses.replace(get_reduced(arch), dtype="float32")
    model = convert.params_from_jax(
        cfg, {k: np.asarray(v) for k, v in params.items()})
    tt = torch.from_numpy(toks)
    kernels.reset_launches()
    with torch.no_grad():
        cache, logits = decode.prefill(model, tt[:, :S], S + STEPS)
        port = {"prefill": logits,
                "cache": {k: v.clone() if torch.is_tensor(v) else v
                          for k, v in cache.items()},
                "steps": []}
        for t in range(STEPS):
            cache, logits, _ = decode.decode_step(model, cache,
                                                  tt[:, S + t:S + t + 1])
            port["steps"].append(logits)
    port["launches"] = [w.launches for w in kernels.wrappers()]
    return arch, ref, port


def test_prefill_logits_match_reference(runs):
    _, ref, port = runs
    _close(port["prefill"], ref["prefill"])


def test_prefill_cache_matches_reference(runs):
    arch, ref, port = runs
    assert port["cache"]["pos"] == int(ref["cache"]["pos"]) == S
    names = ("k", "v") if arch == "qwen3-8b" else ("state", "norm")
    assert set(port["cache"]) == set(ref["cache"]) == {"pos", *names}
    for name in names:
        _close(port["cache"][name], ref["cache"][name])


def test_decode_steps_match_reference(runs):
    _, ref, port = runs
    for got, want in zip(port["steps"], ref["steps"]):
        _close(got, want)


def test_no_kernel_launches_on_cpu(runs):
    assert runs[2]["launches"] == [0] * 7


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_use_the_reference_names_and_shapes(arch):
    for cfg, ref_cfg in ((get_reduced(arch), ref_get_reduced(arch)),
                         (get_config(arch), None)):
        ref_cfg = ref_cfg or dataclasses.replace(
            ref_get_reduced(arch), **dataclasses.asdict(cfg))
        ref_specs = {k: s for k, (s, _, _) in
                     ref_lm.param_specs(ref_cfg).items()}
        assert {k: s for k, (s, _) in lm.param_specs(cfg).items()} == \
            ref_specs
        assert cfg.param_counts() == ref_cfg.param_counts()


def test_params_from_jax_refuses_a_mismatch():
    cfg = get_reduced("xlstm-1.3b")
    params = {k: np.zeros(s, np.float32)
              for k, (s, _) in lm.param_specs(cfg).items()}
    params.pop("lm_head")
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_jax(cfg, params)


def test_init_params_draws_from_the_generator():
    cfg = get_reduced("qwen3-8b")

    def draw(seed):
        gen = torch.Generator().manual_seed(seed)
        return lm.init_params(cfg, gen, "cpu", torch.float32)

    a, b, c = draw(0), draw(0), draw(1)
    wq = [m.layers[0]["attn/wq"] for m in (a, b, c)]
    assert torch.equal(wq[0], wq[1]) and not torch.equal(wq[0], wq[2])
    assert float(wq[0].abs().max()) <= 2.0 / cfg.d_model ** 0.5
    assert torch.equal(a.layers[1]["ln1/scale"], torch.ones(cfg.d_model))


def test_default_device_is_the_card_never_a_fallback():
    if torch.cuda.is_available():
        return
    cfg = get_reduced("qwen3-8b")
    with pytest.raises(RuntimeError, match="CUDA"):
        lm.LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_model("qwen3-8b", reduced=True)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert f"{arch} on cpu" in out and "ms/token" in out and "tok/s" in out
