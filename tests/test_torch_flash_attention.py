"""The port's flash-attention module (threestudio_3dgs_tpu_torch.ops.
flash_attention) against the JAX package on the CPU: K5's plain twin
against the Pallas kernel ``_flash_bhnd`` in interpret mode, the routing
rule, the forward-only guard, and the power of the bf16 limit K5 is held to.
K5 itself is held against the plain twin on the card (tests/test_torch_gpu.py
and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threestudio_3dgs_tpu.ops.flash_attention import _flash_bhnd
from threestudio_3dgs_tpu.ops.flash_attention import attention_reference as jax_reference

from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
from threestudio_3dgs_tpu_torch.utils.profiling import k5_inputs, k5_tolerance


def qkv(bh, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("n,d", [(512, 64), (1024, 64)])
def test_plain_twin_matches_pallas_kernel(n, d, dtype, atol):
    """The JAX tests' tolerances: 2e-5 in f32 (matmul re-association), 3e-2
    in bf16 (inputs, p and the output rounded to bf16)."""
    q, k, v = qkv(6, n, d, seed=n)
    scale = 1.0 / np.sqrt(d)
    jdt = getattr(jnp, dtype)
    want = _flash_bhnd(*(jnp.asarray(a, jdt) for a in (q, k, v)), float(scale), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = fa.flash_bhnd(*(torch.tensor(a).to(tdt) for a in (q, k, v)), scale)
    assert got.dtype == tdt and got.shape == (6, n, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_attention_reference_matches_jax():
    """The einsum path (cross-attention, short sequences, the CPU) in the
    UNet's (B, N, H, D) layout: f32 summation order only."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 96, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 77, 4, 16)).astype(np.float32) for _ in range(2))
    want = np.asarray(jax_reference(q, k, v, 0.25))
    got = fa.attention_reference(torch.tensor(q), torch.tensor(k), torch.tensor(v), 0.25)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("q_shape,k_shape,device,want", [
    ((8, 4096, 5, 64), (8, 4096, 5, 64), "cuda", True),    # level 0 self-attention
    ((8, 1024, 10, 64), (8, 1024, 10, 64), "cuda", True),  # level 1 self-attention
    ((2, 16384, 5, 64), (2, 16384, 5, 64), "cuda", True),  # MVDream: 4 views folded
    ((8, 4096, 5, 64), (8, 4096, 5, 64), "cpu", False),    # the CPU: always plain
    ((8, 4096, 5, 64), (8, 77, 5, 64), "cuda", False),     # cross-attention
    ((8, 256, 20, 64), (8, 256, 20, 64), "cuda", False),   # below MIN_SEQ
    ((8, 1088, 5, 64), (8, 1088, 5, 64), "cuda", False),   # n % 256 != 0
    ((8, 4096, 5, 12), (8, 4096, 5, 12), "cuda", False),   # d % 8 != 0
], ids=["level0", "level1", "multiview", "cpu", "cross", "short", "untiled", "head_dim"])
def test_routing_rule(q_shape, k_shape, device, want):
    assert fa.kernel_route(q_shape, k_shape, device) is want


def online_softmax_model(q, k, v, scale, skip_tile=None, tile=64):
    """K5's arithmetic on the CPU: 64-key tiles, running max and sum in f32,
    p rounded to the input type before p . v, the f32 accumulator rescaled
    when the max grows; ``skip_tile`` leaves one tile out (a broken kernel)."""
    bh, n, d = q.shape
    m = torch.full((bh, n, 1), -float("inf"))
    l = torch.zeros((bh, n, 1))
    o = torch.zeros((bh, n, d))
    for j in range(n // tile):
        if j == skip_tile:
            continue
        kt, vt = k[:, j * tile:(j + 1) * tile], v[:, j * tile:(j + 1) * tile]
        s = torch.matmul(q.float(), kt.float().transpose(1, 2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (o / l).to(q.dtype)


@pytest.mark.parametrize("broken", [False, True], ids=["faithful", "skips_a_tile"])
@pytest.mark.parametrize("bh,n", [(2, 4096), (4, 1024)])
def test_bf16_check_limit_has_power(bh, n, broken):
    """The limit that chip_smoke.py and the card tests hold K5 to in bf16
    (profiling.k5_tolerance), at the UNet's two sequence lengths on a few
    of its (batch * head) rows: a model of K5's arithmetic passes it, and
    the same model without its first, middle or last key tile misses it by
    more than 10x."""
    q, k, v = k5_inputs(bh, n, torch.bfloat16, seed=10, device="cpu")
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    tol = k5_tolerance(want)
    if not broken:
        got = online_softmax_model(q, k, v, 0.125)
        assert float((got.float() - want.float()).abs().max()) <= tol
        return
    for skip in (0, n // 128, n // 64 - 1):
        got = online_softmax_model(q, k, v, 0.125, skip_tile=skip)
        assert float((got.float() - want.float()).abs().max()) > 10 * tol, skip


def test_cpu_attention_takes_the_einsum():
    """On the CPU a call that would meet the rule on the card is the einsum,
    bit for bit."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.tensor(rng.normal(size=(1, 1024, 2, 64)).astype(np.float32))
               for _ in range(3))
    assert torch.equal(fa.attention(q, k, v, 0.125), fa.attention_reference(q, k, v, 0.125))


def test_kernel_wrapper_refuses_grad():
    q, k, v = (torch.tensor(a) for a in qkv(2, 64, 64, seed=5))
    with pytest.raises(RuntimeError, match="forward-only"):
        fa.flash_bhnd(q.requires_grad_(True), k, v, 0.125)
