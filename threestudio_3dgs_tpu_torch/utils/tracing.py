"""Spans at the layer boundaries of the training step, on the clock of
``torch.profiler``.

``span(name)`` is a ``record_function`` while a torch profiler records (in
the active steps of its schedule), and a shared no-op otherwise, so an
untraced step pays one flag check a span.  ``host_read(x)`` brings one
value to the host inside a ``*/host_read`` span: every device-to-host
read of a value on the training path goes through it, so a trace counts
them.  The module keeps no state: the profiler holds the spans with the
device events and writes them out together (the launcher's ``--profile``,
a benchmark's traced run); a span's parent is the span that encloses it
on its thread, and the step is the profiler's own ``ProfilerStep#N``.

The spans, by where they are opened:

  ``Trainer.fit``           fit/data, fit/train_step, fit/host_read (each
                            logged value), fit/log, fit/validate,
                            fit/checkpoint
  ``data/uncond.py``        data/rays (the sampler's rays)
  ``BaseGaussianSystem``    system/loss (``forward_loss``: the renders, the
                            guidance and the losses around them),
                            system/render (``render_batch``),
                            system/backward (``torch.autograd.grad``),
                            system/update (Adam), system/densify (the
                            densify statistics, the pair-capacity
                            controller, the structural update)
  ``BaseGuidance``          system/guidance (a call: UNet, VAE encode, SDS)
  ``diffusion/unet.py``     guidance/unet (a call of ``UNet2DCondition``: the
                            SD, MVDream and Zero123 denoisers' CFG batch)
  ``diffusion/vae.py``      guidance/encode (a call of ``VAEEncoder``: the
                            renders' encode, whose backward the profiler
                            links to it)
  ``renderers/spacetime``   render/timed (each view's timed evaluation of
                            the spacetime field, and the spline's knots of
                            a batch: one span an evaluation)
  ``systems/gaussian_4dgen`` system/motion_reg (the motion stage's anchor,
                            lite ARAP and inter-frame losses)
  ``ops/rasterizer``        render/backward (the hand backward of the blend
                            and the pair gather, on autograd's thread),
                            render/host_read (the binning's pair total)
  ``models/gaussian_field`` system/host_read (the live-row count)
"""

from __future__ import annotations

import contextlib

import torch

SPANS = (
    "fit/data", "data/rays", "fit/train_step", "fit/host_read", "fit/log", "fit/validate",
    "fit/checkpoint", "system/loss", "system/render", "render/backward", "render/host_read",
    "system/guidance", "system/backward", "system/host_read", "system/update", "system/densify",
    "render/timed", "guidance/unet", "guidance/encode", "system/motion_reg",
)
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` while a profiler records, else the
    shared no-op context."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def host_read(x: torch.Tensor, name: str = "system/host_read"):
    """The one value of ``x`` as a Python number, read inside the span
    ``name`` (a ``*/host_read`` of ``SPANS``)."""
    with span(name):
        return x.item()
