"""Latent-diffusion stack of the port (PyTorch, NCHW): the conditional UNet
and the SD VAE with diffusers parameter names, and their checkpoints (port
of the JAX package's ``diffusion/``)."""

from .unet import (  # noqa: F401
    MVDREAM_UNET,
    SD21_UNET,
    ZERO123_UNET,
    UNet2DCondition,
    UNet2DConditionConfig,
)
from .vae import SD_VAE, AutoencoderKLConfig, VAEDecoder, VAEEncoder  # noqa: F401
from .convert import (  # noqa: F401
    flax_unet_to_torch,
    flax_vae_decoder_to_torch,
    flax_vae_encoder_to_torch,
)
