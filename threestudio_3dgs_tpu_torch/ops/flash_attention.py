"""Flash-attention forward for the diffusion UNet: the CUDA kernel K5 and its
plain torch twin.

Port of the JAX package's ``ops/flash_attention.py``.  ``_flash_bhnd``, its
Pallas kernel, is replaced by ``csrc/flash_attention.cu``: softmax(Q K^T *
scale) V per (batch * head) in the (BH, N, D) layout, forward only, because
the SDS denoiser runs under ``torch.no_grad`` and is never differentiated.
``flash_bhnd`` takes the plain twin for CPU tensors and launches the kernel
for CUDA tensors; it refuses inputs that require grad on either device.  On
the card ``k5_kernel`` picks K5's kernel by type alone: bf16 (the UNet's
type) runs on ``wgmma`` with TMA-fed K/V tiles; f32 splits q, k and v into
three bf16 planes each and runs both products on ``wgmma`` as six plane
products.  Both take every head dim d % 8 == 0 up to ``MAX_HEAD_DIM`` of
their type (64 for SD 2.1 and MVDream, 40 for Stable Zero123's level 0, 80
and 160 for its levels 1-2), read in 64-column boxes zero-filled past d
inside the kernel; a shape that the picked kernel does not take raises.

``attention`` keeps the JAX package's routing rule, with ``device.type ==
"cuda"`` in place of ``default_backend() == "tpu"`` (the JAX rule's
``use_flash`` and ``min_seq`` arguments have no caller here, so the rule
takes their defaults): long self-attention goes to K5, everything else
(cross-attention, short sequences, the CPU) to ``attention_reference``, the
materialised einsum with an f32 softmax.
"""

from __future__ import annotations

import torch

from . import native

BQ = 256  # the TPU kernel's query rows per program; the routing rule keeps it
# the largest head dim each K5 kernel takes (four 64-column boxes in bf16,
# three in f32), d % 8 == 0
MAX_HEAD_DIM = {torch.bfloat16: 256, torch.float32: 192}
MIN_SEQ = 1024


def attention_reference(q, k, v, scale):
    """Materialised einsum attention with an f32 softmax, (B, N, H, D)
    layout: the path of everything K5 does not take."""
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", weights, v)


def flash_bhnd_torch(q, k, v, scale):
    """Plain twin of K5 on (BH, N, D): the TPU kernel's arithmetic with the
    whole row in one piece (s in f32, p rounded to the input type before
    p . v, l from the unrounded p, o / l in the input type)."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / l).to(q.dtype)


def shape_tag(bh, n, d) -> str:
    """The name under which ``native.SHAPE_LAUNCHES`` counts K5 at a shape."""
    return f"{bh}x{n}x{d}"


def k5_kernel(dtype, bh, n, d, scale) -> str:
    """Which of K5's kernels takes (bh, n, d) inputs of ``dtype`` on the
    card: ``"wgmma"`` for bf16, ``"split_bf16"`` for f32.  Raises ValueError
    for what the picked kernel does not take; a bf16 call is never handed to
    the f32 kernel."""
    if dtype == torch.bfloat16:
        kernel = "wgmma"
    elif dtype == torch.float32:
        kernel = "split_bf16"
    else:
        raise ValueError(f"K5 takes bf16 or f32 inputs, got {dtype}")
    limit = MAX_HEAD_DIM[dtype]
    if not (0 < d <= limit and d % 8 == 0):
        raise ValueError(
            f"K5 takes {dtype} head dims d <= {limit} with d % 8 == 0, got {d}")
    if kernel == "wgmma" and not scale > 0:
        # the wgmma kernel takes the row max of the unscaled scores
        raise ValueError(f"K5's bf16 kernel takes scale > 0, got {scale}")
    return kernel


def flash_bhnd_cuda(q, k, v, scale):
    """K5 on the card: the kernel ``k5_kernel`` picks, one launch (the f32
    kernel's split pass included, into a scratch of 9 bh n d bf16)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        native.check_cuda_tensor(t, name, q.dtype, 3)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"K5 is self-attention: q, k, v shapes {q.shape}, {k.shape}, {v.shape}")
    bh, n, d = q.shape
    kernel = k5_kernel(q.dtype, bh, n, d, scale)
    out = torch.empty_like(q)
    scratch = None if kernel == "wgmma" else torch.empty(
        9 * q.numel(), dtype=torch.bfloat16, device=q.device)
    native.launch(
        "flash_attention_forward", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        bh, n, d, float(scale), int(kernel == "wgmma"), native.stream_handle(q.device),
        shape=shape_tag(bh, n, d),
    )
    return out


def flash_bhnd(q, k, v, scale):
    """(BH, N, D) forward attention: the plain twin for CPU tensors, K5 for
    CUDA tensors.  Forward only: raises if an input requires grad."""
    if any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash attention is forward-only: call it under torch.no_grad()")
    if q.device.type == "cpu":
        return flash_bhnd_torch(q, k, v, scale)
    return flash_bhnd_cuda(q, k, v, scale)


def kernel_route(q_shape, k_shape, device_type: str) -> bool:
    """The JAX package's routing rule (``attention``): long, tile-friendly
    self-attention on the accelerator goes to the kernel."""
    _, n, _, d = q_shape
    m = k_shape[1]
    return bool(
        device_type == "cuda"
        and n >= MIN_SEQ
        and n == m
        and n % min(BQ, n) == 0
        and d % 8 == 0
    )


def attention(q, k, v, scale):
    """Multi-head attention, (B, N, H, D) layout.  Calls that meet the
    routing rule reach K5 (or raise); the rest take the einsum."""
    if not kernel_route(q.shape, k.shape, q.device.type):
        return attention_reference(q, k, v, scale)
    b, n, h, d = q.shape

    def heads_first(t):
        return t.permute(0, 2, 1, 3).reshape(b * h, n, d)

    out = flash_bhnd(heads_first(q), heads_first(k), heads_first(v), scale)
    return out.reshape(b, h, n, d).permute(0, 2, 1, 3)
