"""The FLOP counts of ``costs.py`` against PyTorch's ``FlopCounterMode``
over the reference's own forward (and backward) at tiny widths, and
against a count by hand; K5's bound at the UNet's shapes."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import costs
from benchmark.reference import diffusion

import tiny


def _weights(shapes):
    gen = torch.Generator().manual_seed(0)
    return {k: torch.randn(s, generator=gen) * 0.1 for k, s in shapes.items()}


def _counted(fn):
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


@pytest.mark.parametrize("views", [1, 4])
def test_unet_flops_match_counter(views):
    cfg = dict(tiny.cell("sd21.t2i")["config"]["unet"])
    if views > 1:
        cfg.update(num_views=4, camera_embed_dim=16)
    w = _weights(diffusion.unet_shapes(cfg))
    b, h = 8, 16
    x = torch.randn(b, 4, h, h)
    t = torch.randint(0, 1000, (b,))
    ctx = torch.randn(b, 77, 1024)
    cam = torch.randn(b, 16) if views > 1 else None
    counted = _counted(lambda: diffusion.unet_forward(w, cfg, x, t, ctx, cam))
    ours = costs.unet_flops(cfg, b, h, h, 77, long_tokens=64)
    assert sum(ours.values()) == pytest.approx(counted, rel=1e-12)
    # self-attention over 16^2 (x 4 views) tokens at level 0 is "long"
    assert ours["attn_long"] > 0


def test_unet_flops_by_hand():
    """One level, one resnet, one transformer, no up/down sampling: the
    sum written out."""
    cfg = {"block_out_channels": [8], "attention_head_dim": [2], "cross_attention_dim": 6,
           "layers_per_block": 1, "down_block_types": ["CrossAttnDownBlock2D"],
           "up_block_types": ["CrossAttnUpBlock2D"], "use_linear_projection": True,
           "norm_num_groups": 2}
    b, h, n, c, L, cross, temb = 1, 2, 4, 8, 3, 6, 32
    conv3 = lambda cin, cout: 2 * b * cin * cout * 9 * n  # noqa: E731
    resnet = lambda cin, cout: conv3(cin, cout) + conv3(cout, cout) + 2 * b * temb * cout + (  # noqa: E731
        2 * b * cin * cout * n if cin != cout else 0)
    transformer = (2 * 2 * b * n * c * c + 4 * 2 * b * n * c * c + 2 * 2 * b * n * c * c
                   + 2 * 2 * b * L * cross * c + 2 * b * n * c * 8 * c + 2 * b * n * 4 * c * c
                   + 4 * b * n * n * c + 4 * b * n * L * c)
    hand = (2 * b * (c * temb + temb * temb) + conv3(4, c)
            + resnet(c, c) + transformer  # down
            + resnet(c, c) + transformer + resnet(c, c)  # mid
            + 2 * (resnet(2 * c, c) + transformer)  # up: two resnets over the skips
            + conv3(c, 4))
    assert sum(costs.unet_flops(cfg, b, h, h, L).values()) == hand


def test_vae_flops_match_counter():
    cfg = dict(tiny.cell("sd21.t2i")["config"]["vae"])
    w = _weights(diffusion.vae_encoder_shapes(cfg))
    x = torch.randn(2, 3, 32, 32, requires_grad=True)
    fwd = costs.vae_encoder_flops(cfg, 2, 32, 32)
    assert sum(fwd.values()) == pytest.approx(
        _counted(lambda: diffusion.vae_encode(w, cfg, x)), rel=1e-12)
    y = diffusion.vae_encode(w, cfg, x)
    # the weights need no gradient, as the guidance's frozen VAE
    grad_input = _counted(lambda: torch.autograd.grad(y.sum(), x))
    assert sum(costs.vae_backward_to_input(fwd).values()) == pytest.approx(grad_input, rel=1e-12)


def test_k5_bound_terms():
    # SD 2.1-base at 512^2, bf16: the products bound it (PERF.md's 0.1737 ms)
    s, term = costs.k5_bound_s(40, 4096, 64, "bf16")
    assert term == "products" and s == pytest.approx(4 * 40 * 4096**2 * 64 / 989e12)
    assert s * 1e3 == pytest.approx(0.1737, abs=1e-4)
    # MVDream's f32 shape: the split route's 12 bf16 products (0.2606 ms)
    s, term = costs.k5_bound_s(10, 4096, 64, "f32")
    assert term == "products" and s * 1e3 == pytest.approx(0.2606, abs=1e-4)
    s, term = costs.k5_bound_s(64, 1024, 40, "bf16")
    assert term == "sfu" and s == pytest.approx(64 * 1024**2 / (16 * 132 * 1.98e9))
    assert math.isclose(costs.k5_bound_s(1, 8, 64, "bf16")[0],
                        4 * 8 * 64 * 2 / 3.35e12)
