"""Kind ``sd``: text-to-3D SDS with Stable Diffusion guidance
(``gaussian-splatting-system``).  The weights are the UNet and the VAE's
encoder; the reference step is ``reference.train.TextTo3D``; the model
FLOPs are the UNet's forward on the CFG batch and the VAE encoder's
forward and its backward to the input (``costs.py``), each FLOP at the
peak of the unit and type it runs in.  The render's arithmetic is not
counted.

bfloat16 configurations: every product at the bf16 peak, but the
float32 ``conv_out`` / ``quant_conv``.  float32 configurations:
convolutions at TF32 where cuDNN may use it (PyTorch's default), dense
layers and attention outside K5 at TF32 or float32 as the matmul switch
says, K5's long self-attention at the bf16 peak (its split route runs on
bf16 tensor cores)."""

from benchmark import costs
from benchmark.reference import diffusion, train

PROGRAM_ONLY_KEYS = ("num_views", "camera_embed_dim")  # not in a diffusers config.json


def weight_files(config):
    return [{"name": sub, "config": {k: v for k, v in config[sub].items()
                                     if k not in PROGRAM_ONLY_KEYS}, "shapes": shapes(config[sub])}
            for sub, shapes in (("unet", diffusion.unet_shapes),
                                ("vae", diffusion.vae_encoder_shapes))]


class Reference(train.TextTo3D):
    def __init__(self, yaml_cfg, config, weights, device, precision=diffusion.F32):
        super().__init__(yaml_cfg, config, weights["unet"], weights["vae"], device, precision)


def model_seconds(config, ctx, flags):
    conv_peak = costs.PEAK_TF32 if flags["cudnn_tf32"] else costs.PEAK_F32
    mm_peak = costs.PEAK_TF32 if flags["matmul_tf32"] else costs.PEAK_F32
    bf16 = config["dtype"] == "bfloat16"
    b, h, _ = ctx["batch_shape"]
    size = config.get("image_size", h)  # the guidance's input size (MVDream resizes to it)
    unet = costs.unet_flops(config["unet"], 2 * b, size // 8, size // 8, 77)
    fwd = costs.vae_encoder_flops(config["vae"], b, size, size)
    vae = {k: v + costs.vae_backward_to_input(fwd)[k] for k, v in fwd.items()}
    if bf16:
        t = (sum(v for k, v in unet.items() if k != "conv_out") + vae["conv"] + vae["dense"]
             + vae["attn"]) / costs.PEAK_BF16
        t += (unet["conv_out"] + vae["conv_out"]) / conv_peak
    else:
        t = (unet["conv"] + unet["conv_out"] + vae["conv"] + vae["conv_out"]) / conv_peak
        t += (unet["dense"] + unet["attn_short"] + vae["dense"] + vae["attn"]) / mm_peak
        t += unet["attn_long"] / costs.PEAK_BF16
    return t
