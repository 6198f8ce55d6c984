"""The port's flash-attention module (threestudio_3dgs_tpu_torch.ops.
flash_attention) against the JAX package on the CPU: K5's plain twin
against the Pallas kernel ``_flash_bhnd`` in interpret mode, the routing
rule, the rule that picks K5's kernel on the card, the forward-only guard,
a CPU model of both K5 kernels' arithmetic (ragged n, a rising max, a head
dim zero-filled to 64; the f32 kernel's three-way bf16 split) and the
power of the bf16 and f32 limits K5 is held to.  K5 itself is held
against the plain twin on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train  # noqa: F401  (its import shares the CPU's cores: share_cpu_threads)

from threestudio_3dgs_tpu.ops.flash_attention import _flash_bhnd
from threestudio_3dgs_tpu.ops.flash_attention import attention_reference as jax_reference

from threestudio_3dgs_tpu_torch.ops import flash_attention as fa
from threestudio_3dgs_tpu_torch.utils.profiling import k5_float64, k5_inputs, k5_tolerance


def qkv(bh, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("n,d", [(512, 64), (1024, 64), (1024, 80), (1024, 160)])
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
    ((8, 1024, 8, 80), (8, 1024, 8, 80), "cuda", True),    # Zero123's level 1 at cond 512
    ((8, 256, 8, 160), (8, 256, 8, 160), "cuda", False),   # its level 2: 256 tokens
    ((8, 4096, 8, 40), (8, 4096, 8, 40), "cuda", True),    # its level 0 at cond 512
], ids=["level0", "level1", "multiview", "cpu", "cross", "short", "untiled", "head_dim",
        "z123_512_level1", "z123_512_level2", "z123_512_level0"])
def test_routing_rule(q_shape, k_shape, device, want, monkeypatch):
    """The port's rule, and the JAX package's ``attention`` traced at the
    same shapes with the TPU as its backend (the card's case) or the CPU:
    it reaches ``_flash_bhnd`` exactly where the port reaches K5."""
    import threestudio_3dgs_tpu.ops.flash_attention as jfa

    assert fa.kernel_route(q_shape, k_shape, device) is want
    called = []
    monkeypatch.setattr(jfa.jax, "default_backend", lambda: "tpu" if device == "cuda" else "cpu")
    monkeypatch.setattr(jfa, "_flash_bhnd", lambda q, k, v, scale: called.append(1) or q)
    q, k = (jax.ShapeDtypeStruct(s, jnp.float32) for s in (q_shape, k_shape))
    jax.eval_shape(lambda q, k, v: jfa.attention(q, k, v, 0.125), q, k, k)
    assert bool(called) is want


LOG2E = math.log2(math.e)


def exact_product(a, b):
    """a b with every product exact and the sums in f32."""
    return torch.matmul(a.float(), b.float())


def bf16_planes(x, count):
    """x as ``count`` bf16 values (held in f32), each the round-to-nearest
    bf16 of what the earlier ones leave: b0 = bf16(x), b1 = bf16(x - b0), ..."""
    planes, rest = [], x.float()
    for _ in range(count):
        planes.append(rest.to(torch.bfloat16).float())
        rest = rest - planes[-1]
    return planes


def split_product(terms):
    """a b as the plane products a_i b_j of ``terms`` (in that order), laid
    side by side along the reduced axis: one f32 accumulator, as the f32
    kernel's wgmma steps sum them."""
    count = 1 + max(max(t) for t in terms)

    def product(a, b):
        pa, pb = bf16_planes(a, count), bf16_planes(b, count)
        return torch.matmul(torch.cat([pa[i] for i, _ in terms], -1),
                            torch.cat([pb[j] for _, j in terms], -2))

    return product


def tf32_product(a, b):
    """One TF32 pass: a and b rounded to 10-bit mantissas (to nearest, ties
    away), the sums in f32."""
    def tf32(x):
        bits = x.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)

    return torch.matmul(tf32(a), tf32(b))


# the f32 kernel's six plane products (i + j <= 2, the smallest first), and
# the three of a two-way split
SPLIT_6 = split_product(((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)))
SPLIT_3 = split_product(((1, 0), (0, 1), (0, 0)))
# (key tile, exp2 with log2(e) folded into the scale, the products of S and
# P V): the f32 kernel (64-key tiles, exp, the six-product split of both)
# and the bf16 wgmma kernel
KERNEL_MODELS = {"split_bf16": (64, False, (SPLIT_6, SPLIT_6)),
                 "wgmma": (128, True, (exact_product, exact_product))}


def online_softmax_model(q, k, v, scale, skip_tile=None, tile=64, exp2=False,
                         products=(exact_product, exact_product)):
    """K5's arithmetic on the CPU: key tiles of ``tile`` (the last one
    ragged), running max and sum in f32, p rounded to the input type before
    p . v, l summing the unrounded p, the f32 accumulator rescaled when the
    max grows; S = ``products[0]``(q, k^T), P V = ``products[1]``(p, v).
    Without ``exp2``: s = (q . k) scale, p = exp(s - m).  With ``exp2``
    (the wgmma kernel): the max is taken of the unscaled scores and
    p = exp2(s c - m c), c = scale log2(e) in f32.  ``skip_tile`` leaves one
    tile out (a broken kernel)."""
    bh, n, d = q.shape
    s_product, pv_product = products
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((bh, n, 1), -float("inf"))
    l = torch.zeros((bh, n, 1))
    o = torch.zeros((bh, n, d))
    for j in range(-(-n // tile)):
        if j == skip_tile:
            continue
        kt, vt = k[:, j * tile:(j + 1) * tile], v[:, j * tile:(j + 1) * tile]
        s = s_product(q, kt.transpose(1, 2))
        if not exp2:
            s = s * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        if exp2:
            p, alpha = torch.exp2(s * c - m_new * c), torch.exp2((m - m_new) * c)
        else:
            p, alpha = torch.exp(s - m_new), torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + pv_product(p.to(v.dtype), vt)
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
    of its (batch * head) rows, for the f32 kernel's 64-key tiles and
    split products (exact on bf16 inputs, whose lower planes are zero) and
    the wgmma kernel's 128-key tiles with exp2: a model of the kernel's
    arithmetic passes it, and the same model without its first, middle or
    last key tile misses it by more than 10x."""
    tile, exp2, products = KERNEL_MODELS[kernel]
    q, k, v = k5_inputs(bh, n, torch.bfloat16, seed=10, device="cpu")
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    tol = k5_tolerance(want)
    if not broken:
        got = online_softmax_model(q, k, v, 0.125, tile=tile, exp2=exp2, products=products)
        assert max_diff(got, want) <= tol
        return
    for skip in (0, n // (2 * tile), n // tile - 1):
        got = online_softmax_model(q, k, v, 0.125, skip_tile=skip, tile=tile, exp2=exp2,
                                   products=products)
        assert max_diff(got, want) > 10 * tol, skip


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_with_rising_max(kernel, dtype):
    """Keys in rising norm (logits spanning about +-30): the running max
    grows in every key tile for most rows, so every tile rescales O and l;
    the model stays within k5_tolerance of the plain twin, and of the same
    function evaluated in float64."""
    tile, exp2, products = KERNEL_MODELS[kernel]
    tdt = getattr(torch, dtype)
    q, k, v = k5_inputs(2, 1024, tdt, seed=11, device="cpu", rising=True)
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * 0.125
    assert 25 < float(s.abs().max()) < 60
    tile_max = s.reshape(2, 1024, -1, tile).amax(-1)
    grows = (tile_max[..., 1:] > tile_max[..., :-1].cummax(-1).values).float().mean()
    assert float(grows) > 0.5
    want = fa.flash_bhnd_torch(q, k, v, 0.125)
    got = online_softmax_model(q, k, v, 0.125, tile=tile, exp2=exp2, products=products)
    assert max_diff(got, want) <= k5_tolerance(want)
    exact = k5_float64(q, k, v, 0.125).to(tdt)
    assert max_diff(got, exact) <= k5_tolerance(exact)


@pytest.mark.parametrize("bh,n,pv3_factor,tf32_factor,f64_gain", [
    (2, 1024, 1.21, 662, 3.70), (2, 4096, 1.33, 770, 2.07)])
def test_f32_split_limit_has_power(bh, n, pv3_factor, tf32_factor, f64_gain):
    """The f32 limit (2e-5) at keys in rising norm, where the plain twin is
    itself about 1.4e-5 from float64: the f32 kernel's model (six plane
    products of both S and P V) passes it and is 2-3.7x closer to float64
    than the plain twin; the same model misses it with a two-way split of
    P V (three products) and with one TF32 pass of both, by the factors
    measured on these inputs."""
    q, k, v = k5_inputs(bh, n, torch.float32, seed=11, device="cpu", rising=True)
    want, exact = fa.flash_bhnd_torch(q, k, v, 0.125), k5_float64(q, k, v, 0.125)
    tol = k5_tolerance(want)
    got = online_softmax_model(q, k, v, 0.125, products=(SPLIT_6, SPLIT_6))
    assert max_diff(got, want) <= tol
    assert max_diff(got, exact) * f64_gain <= max_diff(want, exact)
    pv3 = online_softmax_model(q, k, v, 0.125, products=(SPLIT_6, SPLIT_3))
    assert max_diff(pv3, want) > pv3_factor * tol
    tf32 = online_softmax_model(q, k, v, 0.125, products=(tf32_product, tf32_product))
    assert max_diff(tf32, want) > tf32_factor * tol


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_ragged_n_matches_pallas_kernel(kernel, dtype):
    """n = 1000, a partial last key tile (and query tile on the card): the
    model against the JAX package's ``_flash_bhnd`` in interpret mode (its
    queries padded to 1024 rows, which it tiles by 256; rows are
    independent) and against the plain twin, to k5_tolerance."""
    tile, exp2, products = KERNEL_MODELS[kernel]
    q, k, v = qkv(2, 1000, 64, seed=12)
    q_pad = np.concatenate([q, np.zeros((2, 24, 64), np.float32)], axis=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _flash_bhnd(jnp.asarray(q_pad, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt), 0.125,
                       interpret=True)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))[:, :1000]).to(tdt)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    got = online_softmax_model(tq, tk, tv, 0.125, tile=tile, exp2=exp2, products=products)
    plain = fa.flash_bhnd_torch(tq, tk, tv, 0.125)
    assert max_diff(got, want) <= k5_tolerance(want)
    assert max_diff(got, plain) <= k5_tolerance(plain)


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_zero_padded_head_dim(kernel, dtype):
    """Stable Zero123's level 0, d = 40, as K5 takes it: q, k and v
    zero-filled to 64 columns (the fill of its 64-column TMA boxes).  The
    model on the padded inputs leaves O's columns 40..63 exactly zero and
    its first 40 equal the model on the unpadded inputs (up to the f32
    order of the sums, which the zero terms do not change on the card's
    tensor cores but may on the CPU's), and both hold to k5_tolerance
    against the JAX package's ``_flash_bhnd`` at d = 40 (interpret mode)
    and the plain twin."""
    tile, exp2, products = KERNEL_MODELS[kernel]
    d, scale = 40, 40**-0.5
    q, k, v = qkv(2, 1024, d, seed=13)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _flash_bhnd(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale, interpret=True)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).to(tdt)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    pq, pk, pv = (torch.nn.functional.pad(t, (0, 64 - d)) for t in (tq, tk, tv))
    padded = online_softmax_model(pq, pk, pv, scale, tile=tile, exp2=exp2, products=products)
    unpadded = online_softmax_model(tq, tk, tv, scale, tile=tile, exp2=exp2, products=products)
    assert padded.shape == (2, 1024, 64) and not bool(padded[..., d:].any())
    same = 2e-6 if dtype == "float32" else 2.0**-8 * max_diff(unpadded, 0 * unpadded)
    assert max_diff(padded[..., :d], unpadded) <= same
    plain = fa.flash_bhnd_torch(tq, tk, tv, scale)
    for got in (padded[..., :d], unpadded):
        assert max_diff(got, want) <= k5_tolerance(want)
        assert max_diff(got, plain) <= k5_tolerance(plain)



def kernel_tile(kernel, d):
    """The key tile of K5's kernel at head dim d (csrc/flash_attention.cu
    bf16_shape / split_shape): bf16 128 keys up to two 64-column boxes, 64
    past; f32 64 keys in one box, 32 past."""
    boxes = -(-d // 64)
    if kernel == "wgmma":
        return 128 if boxes <= 2 else 64
    return 64 if boxes == 1 else 32


@pytest.mark.parametrize("kernel", list(KERNEL_MODELS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [80, 160])
def test_model_wide_head_dims(kernel, dtype, d):
    """Stable Zero123's levels 1-2 at a 512^2 conditioning image, d = 80
    and 160, as K5 takes them: two or three 64-column boxes, the last
    zero-filled past d, at the key tile the kernel uses there.  The model
    leaves the padded columns zero and holds to k5_tolerance against the
    JAX package's ``_flash_bhnd`` (interpret mode) and the plain twin."""
    _, exp2, products = KERNEL_MODELS[kernel]
    tile, scale, width = kernel_tile(kernel, d), d**-0.5, 64 * -(-d // 64)
    q, k, v = qkv(2, 1024, d, seed=d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = _flash_bhnd(*(jnp.asarray(a, jdt) for a in (q, k, v)), scale, interpret=True)
    want = torch.tensor(np.asarray(want.astype(jnp.float32))).to(tdt)
    padded = online_softmax_model(*(torch.nn.functional.pad(torch.tensor(a).to(tdt), (0, width - d))
                                    for a in (q, k, v)), scale, tile=tile, exp2=exp2,
                                  products=products)
    assert padded.shape == (2, 1024, width) and not bool(padded[..., d:].any())
    got = padded[..., :d]
    plain = fa.flash_bhnd_torch(*(torch.tensor(a).to(tdt) for a in (q, k, v)), scale)
    assert max_diff(got, want) <= k5_tolerance(want)
    assert max_diff(got, plain) <= k5_tolerance(plain)
    assert max_diff(plain, want) <= k5_tolerance(want)

@pytest.mark.parametrize("dtype,bh,n,d,scale,want", [
    (torch.bfloat16, 40, 4096, 64, 0.125, "wgmma"),     # level 0 self-attention
    (torch.bfloat16, 80, 1024, 64, 0.125, "wgmma"),     # level 1
    (torch.bfloat16, 10, 16384, 64, 0.125, "wgmma"),    # MVDream: 4 views folded
    (torch.bfloat16, 40, 1000, 64, 0.125, "wgmma"),     # ragged n
    (torch.bfloat16, 1, 1, 64, 0.125, "wgmma"),         # one token
    (torch.bfloat16, 65535, 1024, 64, 0.125, "wgmma"),
    (torch.float32, 16, 1024, 64, 0.125, "split_bf16"),  # f32 weights and the checks
    (torch.float32, 16, 1024, 64, -0.125, "split_bf16"),
    (torch.bfloat16, 64, 1024, 40, 40**-0.5, "wgmma"),   # Stable Zero123's level 0
    (torch.bfloat16, 8, 1024, 80, 80**-0.5, "wgmma"),    # Zero123's level 1 at cond 512
    (torch.float32, 16, 1024, 40, 40**-0.5, "split_bf16"),  # half_precision_weights: false
    (torch.bfloat16, 8, 1024, 8, 8**-0.5, "wgmma"),      # the smallest d
    (torch.float32, 8, 1024, 12, 12**-0.5, ValueError),  # d % 8 != 0
    (torch.bfloat16, 65536, 1024, 64, 0.125, "wgmma"),   # a 1-D persistent grid: no bh limit
    (torch.float32, 65535, 1024, 64, 0.125, "split_bf16"),  # 1-D persistent grids:
    (torch.float32, 65536, 1024, 64, 0.125, "split_bf16"),  # no bh limit in f32 either
    (torch.bfloat16, 16, 1024, 64, -0.125, ValueError),
    (torch.bfloat16, 16, 1024, 64, 0.0, ValueError),
    (torch.float16, 16, 1024, 64, 0.125, ValueError),
    (torch.bfloat16, 8, 256, 160, 160**-0.5, "wgmma"),   # Zero123's level 2
    (torch.bfloat16, 8, 1024, 256, 256**-0.5, "wgmma"),  # four 64-column boxes
    (torch.bfloat16, 8, 1024, 264, 264**-0.5, ValueError),  # past four boxes
    (torch.float32, 8, 1024, 160, 160**-0.5, "split_bf16"),
    (torch.float32, 8, 1024, 192, 192**-0.5, "split_bf16"),  # three boxes of planes
    (torch.float32, 8, 1024, 200, 200**-0.5, ValueError),  # past three
], ids=["level0", "level1", "multiview", "ragged", "one_token", "max_bh", "f32",
        "f32_negative_scale", "bf16_d40", "bf16_d80", "f32_d40", "bf16_d8", "f32_d12", "bh_over",
        "f32_max_bh",
        "f32_bh_over", "bf16_negative_scale", "bf16_zero_scale", "f16", "bf16_d160",
        "bf16_d256", "bf16_d264", "f32_d160", "f32_d192", "f32_d200"])
def test_kernel_picked_by_type(dtype, bh, n, d, scale, want):
    """bf16 always goes to the wgmma kernel and f32 to the split-bf16
    kernel; a shape the picked kernel does not take raises (never a bf16
    call on the f32 kernel)."""
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
