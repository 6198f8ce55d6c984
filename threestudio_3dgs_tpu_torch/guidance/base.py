"""Guidance interface and prompt processing (port of the JAX package's
``guidance/base.py``).

The guidance contract: guidance(rgb (B, H, W, 3), prompt_utils, batch) ->
{"loss_sds": ..., ...}; every loss_* is weighted by the matching lambda_*
in the system config.  The prompt processor carries the prompt text and its
embeddings: with ``pretrained_model_name_or_path`` a local directory that
holds ``text_encoder/`` and ``tokenizer/``, the CLIP hidden states
(``guidance/clip.py``, run once per prompt variant on the system's device);
without them, deterministic vectors seeded by the CRC32 of the text (the
JAX package seeds its fallback from Python's per-process ``hash``).  Where
the JAX package turns any failure of its CLIP load into the fallback, the
port raises: a silently different prompt is a different result.

View-dependent prompting (threestudio's rule): four direction-suffixed
variants of the prompt are embedded up front, and
``get_text_embeddings(elevation, azimuth)`` picks one per view."""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from ..utils.config import parse_structured
from ..utils.registry import register
from ..utils.tracing import span
from .clip import PromptEncoder, has_clip


class BaseGuidance:
    """Subclasses implement guide(rgb, prompt_utils, batch, generator, sched);
    a call runs it inside the ``system/guidance`` span."""

    def __call__(self, rgb, prompt_utils, batch, generator=None, sched=None, **kwargs):
        with span("system/guidance"):
            return self.guide(rgb, prompt_utils, batch, generator, sched, **kwargs)

    def guide(self, rgb, prompt_utils, batch, generator=None, sched=None):
        raise NotImplementedError


@dataclasses.dataclass
class PromptProcessorConfig:
    prompt: str = "a hamburger"
    negative_prompt: str = ""
    spawn: bool = False
    pretrained_model_name_or_path: str = ""
    use_perp_neg: bool = False
    front_threshold: float = 30.0
    back_threshold: float = 30.0
    overhead_threshold: float = 60.0
    view_dependent_prompting: bool = True


VIEW_SUFFIXES = (", front view", ", side view", ", back view", ", overhead view")


def text_embedding(text: str) -> np.ndarray:
    """(77, 1024) f32 drawn from a generator seeded by the text's CRC32."""
    rng = np.random.default_rng(zlib.crc32(text.encode("utf-8")))
    return rng.normal(size=(77, 1024)).astype(np.float32)


class PromptUtils:
    """Carrier for text conditioning: the prompt's embedding (77, D) and,
    with view-dependent prompting, those of its four view variants (4, 77,
    D); CLIP's from ``model_dir`` when it holds a text encoder and a
    tokenizer, else the CRC32-seeded vectors (D = 1024)."""

    def __init__(self, prompt: str, negative_prompt: str = "", model_dir: str = "",
                 cfg=None, device="cuda"):
        self.prompt = prompt
        self.negative_prompt = negative_prompt
        self.cfg = cfg or PromptProcessorConfig(prompt=prompt)
        # the encoder is loaded once for the prompt and its view variants,
        # and its device memory freed after
        encode = PromptEncoder(model_dir, device) if has_clip(model_dir) else text_embedding
        self.text_embedding = encode(prompt)
        self.view_embeddings = (
            np.stack([encode(prompt + s) for s in VIEW_SUFFIXES])
            if self.cfg.view_dependent_prompting else None
        )

    def view_index(self, elevation, azimuth) -> np.ndarray:
        """(B,) int32 index into VIEW_SUFFIXES: overhead above the elevation
        threshold, else front / back by the azimuth window, else side."""
        azim = (np.asarray(azimuth) + 180.0) % 360.0 - 180.0  # [-180, 180)
        front = np.abs(azim) < self.cfg.front_threshold
        back = np.abs(azim) > 180.0 - self.cfg.back_threshold
        idx = np.where(front, 0, np.where(back, 2, 1))
        return np.where(np.asarray(elevation) > self.cfg.overhead_threshold, 3, idx).astype(np.int32)

    def get_text_embeddings(self, elevation=None, azimuth=None, **_):
        """No angles: the prompt's embedding (77, D).  With per-view
        elevation and azimuth (B,) in degrees: (B, 77, D)."""
        if elevation is None or azimuth is None or self.view_embeddings is None:
            return self.text_embedding
        return self.view_embeddings[self.view_index(elevation, azimuth)]


@register("dummy-prompt-processor")
@register("stable-diffusion-prompt-processor")
@register("stable-zero123-prompt-processor")
@register("zero123-prompt-processor")
class PromptProcessor:
    Config = PromptProcessorConfig

    def __init__(self, cfg=None, device="cuda", **kwargs):
        if cfg is None:
            cfg = PromptProcessorConfig(**kwargs)
        elif isinstance(cfg, dict):
            cfg = parse_structured(PromptProcessorConfig, cfg)
        self.cfg = cfg
        self.device = device

    def __call__(self) -> PromptUtils:
        return PromptUtils(self.cfg.prompt, self.cfg.negative_prompt,
                           model_dir=str(self.cfg.pretrained_model_name_or_path or ""),
                           cfg=self.cfg, device=self.device)
