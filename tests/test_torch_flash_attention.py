"""The port's flash-attention module (threestudio_3dgs_tpu_torch.ops.
flash_attention) against the JAX package on the CPU: K5's plain twin
against the Pallas kernel ``_flash_bhnd`` in interpret mode, the routing
rule, the rule that picks K5's kernel on the card, the forward-only guard,
a CPU model of both K5 kernels' arithmetic (ragged n, a rising max) and
the power of the bf16 limit K5 is held to.  K5 itself is held against the
plain twin on the card (tests/test_torch_gpu.py and chip_smoke.py)."""

import math

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


LOG2E = math.log2(math.e)
# (key tile, exp2 with log2(e) folded into the scale): the CUDA-core kernel
# (f32 on the card; bf16 until the wgmma kernel) and the bf16 wgmma kernel
KERNEL_MODELS = {"cuda_core": (64, False), "wgmma": (128, True)}


def online_softmax_model(q, k, v, scale, skip_tile=None, tile=64, exp2=False):
    """K5's arithmetic on the CPU: key tiles of ``tile`` (the last one
    ragged), running max and sum in f32, p rounded to the input type before
    p . v, l summing the unrounded p, the f32 accumulator rescaled when the
    max grows.  Without ``exp2``: s = (q . k) scale, p = exp(s - m).  With
    ``exp2`` (the wgmma kernel): the max is taken of the unscaled scores and
    p = exp2(s c - m c), c = scale log2(e) in f32.  ``skip_tile`` leaves one
    tile out (a broken kernel)."""
    bh, n, d = q.shape
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((bh, n, 1), -float("inf"))
    l = torch.zeros((bh, n, 1))
    o = torch.zeros((bh, n, d))
    for j in range(-(-n // tile)):
        if j == skip_tile:
            continue
        kt, vt = k[:, j * tile:(j + 1) * tile], v[:, j * tile:(j + 1) * tile]
        s = torch.matmul(q.float(), kt.float().transpose(1, 2))
        if not exp2:
            s = s * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        if exp2:
            p, alpha = torch.exp2(s * c - m_new * c), torch.exp2((m - m_new) * c)
        else:
            p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (o / l).to(q.dtype)


def max_diff(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("broken", [False, True], ids=["faithful", "skips_a_tile"])
@pytest.mark.parametrize("bh,n", [(2, 4096), (4, 1024)])
def test_bf16_check_limit_has_power(bh, n, broken, kernel):
    """The limit that chip_smoke.py and the card tests hold K5 to in bf16
    (profiling.k5_tolerance), at the UNet's two sequence lengths on a few
    of its (batch * head) rows, for the CUDA-core kernel's 64-key tiles and
    the wgmma kernel's 128-key tiles with exp2: a model of the kernel's
    arithmetic passes it, and the same model without its first, middle or
    last key tile misses it by more than 10x."""
    tile, exp2 = KERNEL_MODELS[kernel]
    q, k, v = k5_inputs(bh, n, torch.bfloat16, seed=10, device="cpu")
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    tol = k5_tolerance(want)
    if not broken:
        got = online_softmax_model(q, k, v, 0.125, tile=tile, exp2=exp2)
        assert max_diff(got, want) <= tol
        return
    for skip in (0, n // (2 * tile), n // tile - 1):
        got = online_softmax_model(q, k, v, 0.125, skip_tile=skip, tile=tile, exp2=exp2)
        assert max_diff(got, want) > 10 * tol, skip


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_with_rising_max(kernel, dtype):
    """Keys in rising norm (logits spanning about +-30): the running max
    grows in every key tile for most rows, so every tile rescales O and l;
    the model stays within k5_tolerance of the plain twin."""
    tile, exp2 = KERNEL_MODELS[kernel]
    tdt = getattr(torch, dtype)
    q, k, v = k5_inputs(2, 1024, tdt, seed=11, device="cpu", rising=True)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * 0.125
    assert 25 < float(s.abs().max()) < 60
    tile_max = s.reshape(2, 1024, -1, tile).amax(-1)
    grows = (tile_max[..., 1:] > tile_max[..., :-1].cummax(-1).values).float().mean()
    assert float(grows) > 0.5
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    got = online_softmax_model(q, k, v, 0.125, tile=tile, exp2=exp2)
    assert max_diff(got, want) <= k5_tolerance(want)


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_ragged_n_matches_pallas_kernel(kernel, dtype):
    """n = 1000, a partial last key tile (and query tile on the card): the
    model against the JAX package's ``_flash_bhnd`` in interpret mode (its
    queries padded to 1024 rows, which it tiles by 256; rows are
    independent) and against the plain twin, to k5_tolerance."""
    tile, exp2 = KERNEL_MODELS[kernel]
    q, k, v = qkv(2, 1000, 64, seed=12)
    q_pad = np.concatenate([q, np.zeros((2, 24, 64), np.float32)], axis=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _flash_bhnd(jnp.asarray(q_pad, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), 0.125,
                       interpret=True)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))[:, :1000]).to(tdt)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    got = online_softmax_model(tq, tk, tv, 0.125, tile=tile, exp2=exp2)
    plain = fa.flash_bhnd_torch(tq, tk, tv, 0.125)
    assert max_diff(got, want) <= k5_tolerance(want)
    assert max_diff(got, plain) <= k5_tolerance(plain)


@pytest.mark.parametrize("dtype,bh,n,d,scale,want", [
    (torch.bfloat16, 40, 4096, 64, 0.125, "wgmma"),     # level 0 self-attention
    (torch.bfloat16, 80, 1024, 64, 0.125, "wgmma"),     # level 1
    (torch.bfloat16, 10, 16384, 64, 0.125, "wgmma"),    # MVDream: 4 views folded
    (torch.bfloat16, 40, 1000, 64, 0.125, "wgmma"),     # ragged n
    (torch.bfloat16, 1, 1, 64, 0.125, "wgmma"),         # one token
    (torch.bfloat16, 65535, 1024, 64, 0.125, "wgmma"),
    (torch.float32, 16, 1024, 64, 0.125, "cuda_core"),  # f32 weights and the checks
    (torch.float32, 16, 1024, 64, -0.125, "cuda_core"),
    (torch.bfloat16, 8, 1024, 40, 40**-0.5, ValueError),  # Zero123's d = 40
    (torch.bfloat16, 8, 1024, 80, 80**-0.5, ValueError),  # Zero123's d = 80
    (torch.float32, 8, 1024, 40, 40**-0.5, ValueError),
    (torch.bfloat16, 65536, 1024, 64, 0.125, "wgmma"),   # a 1-D persistent grid: no bh limit
    (torch.float32, 65535, 1024, 64, 0.125, "cuda_core"),  # the f32 grid's y extent
    (torch.float32, 65536, 1024, 64, 0.125, ValueError),
    (torch.bfloat16, 16, 1024, 64, -0.125, ValueError),
    (torch.bfloat16, 16, 1024, 64, 0.0, ValueError),
    (torch.float16, 16, 1024, 64, 0.125, ValueError),
], ids=["level0", "level1", "multiview", "ragged", "one_token", "max_bh", "f32",
        "f32_negative_scale", "bf16_d40", "bf16_d80", "f32_d40", "bh_over", "f32_max_bh",
        "f32_bh_over", "bf16_negative_scale", "bf16_zero_scale", "f16"])
def test_kernel_picked_by_type(dtype, bh, n, d, scale, want):
    """bf16 always goes to the wgmma kernel and f32 to the CUDA-core kernel;
    a shape the picked kernel does not take raises (never a bf16 call on
    the CUDA-core kernel)."""
    if want is ValueError:
        with pytest.raises(ValueError):
            fa.k5_kernel(dtype, bh, n, d, scale)
    else:
        assert fa.k5_kernel(dtype, bh, n, d, scale) == want


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
