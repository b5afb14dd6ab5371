"""Flash attention (K5) and chunkwise GLA (K6): the plain versions behind the
CUDA kernel wrappers (the path a wrapper takes for CPU tensors) against the
JAX reference on the same numpy inputs.

K5 is held against the Pallas kernel in interpret mode
(``repro.kernels.flash_attention``) and, for grouped heads and ragged
lengths, against ``repro.models.layers.attention``.  K6 is held against the
Pallas kernel in interpret mode (``repro.kernels.gla``) and against
``repro.models.ssm.chunkwise_gla``, final state and normaliser included.

Tolerances: f32 1e-4 relative / 1e-5 absolute, bf16 5e-2 (the kernel tier
of TESTING.md: the two sides round the bf16 probabilities after different
running maxima).  The kernels themselves run only on a CUDA card, where
``chip_smoke.py`` holds each against these same plain versions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.gla import gla as pallas_gla
from repro.models.layers import attention as ref_attention
from repro.models.layers import decode_attention as ref_decode_attention
from repro.models.ssm import chunkwise_gla as ref_chunkwise_gla
from repro_torch import kernels
from repro_torch.kernels import attention as fa
from repro_torch.kernels import gla as gla_kernel
from repro_torch.models import layers, ssm

_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(dt):
    return dict(rtol=5e-2, atol=5e-2) if dt == "bf16" \
        else dict(rtol=1e-4, atol=1e-5)


def _pair(rng, shape, dt):
    """One input in both frameworks: an f32 draw rounded once to ``dt``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, _JNP[dt]), torch.from_numpy(x).to(_TORCH[dt])


def _close(got: torch.Tensor, want, dt):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dt))


# -- K5 -----------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas(causal, dt):
    rng = np.random.default_rng(11 + causal)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng, (2, 3, 64, 16), dt)
                                    for _ in range(3))
    want = pallas_fa(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                     interpret=True)
    got = fa.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype
    _close(got, want, dt)


def test_grouped_attention_matches_reference_layer():
    """(B, S, H, D) grouped-query attention with k/v on 2 of 4 heads, at a
    length (37) no block divides, masked as the reference layer masks it."""
    rng = np.random.default_rng(37)
    jq, tq = _pair(rng, (2, 37, 4, 16), "f32")
    (jk, tk), (jv, tv) = (_pair(rng, (2, 37, 2, 16), "f32") for _ in range(2))
    want = jax.jit(ref_attention)(jq, jk, jv)
    got = layers.attention(tq, tk, tv, causal=True)
    plain = layers.attention(tq, tk, tv, causal=True, kernels=False)
    _close(got, want, "f32")
    assert torch.equal(got, plain)


def test_decode_attention_matches_reference_layer():
    """One query against the first 21 of 32 cache positions."""
    rng = np.random.default_rng(5)
    jq, tq = _pair(rng, (2, 1, 4, 16), "f32")
    (jk, tk), (jv, tv) = (_pair(rng, (2, 32, 4, 16), "f32") for _ in range(2))
    _close(layers.decode_attention(tq, tk, tv, 21),
           jax.jit(ref_decode_attention, static_argnums=3)(jq, jk, jv, 21),
           "f32")


def test_flash_attention_guards():
    q = torch.zeros(1, 3, 8, 16)
    with pytest.raises(ValueError, match="do not fit"):
        fa.flash_attention(q, torch.zeros(1, 2, 8, 16),
                           torch.zeros(1, 2, 8, 16))
    with pytest.raises(TypeError, match="differ"):
        fa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="B, H, S, D"):
        fa.flash_attention(q[0], q[0], q[0])
    for variant in fa.WRAPPERS:             # the kernels take CUDA tensors
        with pytest.raises(ValueError, match="CPU"):
            variant(q, q, q)


@pytest.mark.parametrize("dtype,d,aligned,want", [
    (torch.bfloat16, 128, True, "mma"), (torch.bfloat16, 64, True, "mma"),
    (torch.bfloat16, 40, True, "mma"), (torch.bfloat16, 16, True, "mma"),
    (torch.bfloat16, 20, True, "fma"), (torch.bfloat16, 128, False, "fma"),
    (torch.float32, 128, True, "fma"), (torch.float32, 16, True, "fma"),
])
def test_flash_attention_variant_rule(dtype, d, aligned, want):
    """bf16 with a head dim that is a multiple of 8 and 16-byte rows goes
    to the tensor cores; f32 (no TF32) and every other layout to FMA."""
    assert fa.choose_variant(dtype, d, aligned) == want


def test_flash_attention_rows_aligned_reads_strides():
    bf16 = torch.bfloat16
    serving = torch.zeros(2, 37, 4, 40, dtype=bf16).transpose(1, 2)
    assert fa.rows_aligned(serving)                    # (B, S, H, D) view
    assert fa.rows_aligned(torch.zeros(2, 4, 37, 16, dtype=bf16))
    assert not fa.rows_aligned(torch.zeros(2, 4, 37, 20, dtype=bf16))
    assert not fa.rows_aligned(serving[..., 4:])       # base 8 bytes off
    assert not fa.rows_aligned(
        torch.zeros(2, 4, 16, 37, dtype=bf16).transpose(2, 3))


# -- K6 -----------------------------------------------------------------------

def _gla_inputs(rng, dt, b=2, s=64, h=3, dk=8, dv=16):
    q, k = (_pair(rng, (b, s, h, dk), dt) for _ in range(2))
    v = _pair(rng, (b, s, h, dv), dt)
    la = (-np.abs(rng.standard_normal((b, s, h))) * 0.1).astype(np.float32)
    return q, k, v, (jnp.asarray(la), torch.from_numpy(la))


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("chunk", [16, 32])
def test_gla_matches_pallas_and_chunkwise_f32(chunk, normalize):
    rng = np.random.default_rng(chunk + normalize)
    (jq, tq), (jk, tk), (jv, tv), (jla, tla) = _gla_inputs(rng, "f32")
    y, (state, norm) = gla_kernel.gla(tq, tk, tv, tla, chunk=chunk,
                                      normalize=normalize)
    _close(y, pallas_gla(jq, jk, jv, jla, chunk=chunk, normalize=normalize,
                         interpret=True), "f32")
    y_ref, (s_ref, n_ref) = ref_chunkwise_gla(jq, jk, jv, jla, chunk=chunk,
                                              normalize=normalize)
    _close(y, y_ref, "f32")
    _close(state, s_ref, "f32")
    _close(norm, n_ref, "f32")


@pytest.mark.parametrize("normalize", [True, False])
def test_gla_matches_pallas_bf16(normalize):
    rng = np.random.default_rng(7 + normalize)
    (jq, tq), (jk, tk), (jv, tv), (jla, tla) = _gla_inputs(
        rng, "bf16", b=1, s=32, h=2, dk=8, dv=8)
    y, (state, norm) = gla_kernel.gla(tq, tk, tv, tla, chunk=16,
                                      normalize=normalize)
    assert y.dtype == torch.bfloat16 and state.dtype == torch.float32
    _close(y, pallas_gla(jq, jk, jv, jla, chunk=16, normalize=normalize,
                         interpret=True), "bf16")
    _, (s_ref, n_ref) = ref_chunkwise_gla(jq, jk, jv, jla, chunk=16,
                                          normalize=normalize)
    _close(state, s_ref, "bf16")
    _close(norm, n_ref, "bf16")


def test_gla_decode_step_continues_the_chunkwise_state():
    """Prefill by chunks, then one recurrent step, equals chunks over the
    longer sequence (the serving path's hand-over from K6 to decode)."""
    rng = np.random.default_rng(3)
    (_, tq), (_, tk), (_, tv), (_, tla) = _gla_inputs(rng, "f32", s=33)
    y_all, (s_all, n_all) = ssm.chunkwise_gla(tq, tk, tv, tla, chunk=33)
    _, (st, nm) = ssm.chunkwise_gla(tq[:, :32], tk[:, :32], tv[:, :32],
                                    tla[:, :32], chunk=16)
    y, st, nm = ssm.gla_decode_step(st, nm, tq[:, 32], tk[:, 32], tv[:, 32],
                                    tla[:, 32])
    _close(y, y_all[:, 32].numpy(), "f32")
    _close(st, s_all.numpy(), "f32")
    _close(nm, n_all.numpy(), "f32")


def test_gla_guards():
    q = torch.zeros(1, 24, 2, 8)
    la = torch.zeros(1, 24, 2)
    with pytest.raises(ValueError, match="chunk"):
        gla_kernel.gla(q, q, q, la, chunk=16)
    with pytest.raises(ValueError, match="bad GLA shapes"):
        gla_kernel.gla(q, q, q, la[:, :, :1], chunk=8)
    with pytest.raises(TypeError, match="differ"):
        gla_kernel.gla(q, q, q.bfloat16(), la, chunk=8)


# -- counters -----------------------------------------------------------------

def test_launch_counters_stay_zero_on_cpu():
    kernels.reset_launches()
    q = torch.ones(1, 16, 2, 8)
    layers.attention(q, q, q)
    ssm.chunkwise_gla(q, q, q, torch.zeros(1, 16, 2), chunk=8)
    assert [w.launches for w in kernels.wrappers()] == [0] * 7
