"""threestudio_3dgs_tpu_torch: the PyTorch + CUDA port of threestudio_3dgs_tpu.

Same layout, registered names, configs and output dicts as the JAX package,
which stays the reference.  Plain tensor code is torch; the rasterizer's
kernels are hand-written CUDA for Hopper in ``csrc/`` (built at first CUDA
use by ``ops/native.py``), each with a plain torch twin that CPU tensors
take.  Importing the package imports neither JAX nor the JAX package and
builds nothing.

  ops/        math core, rasterizer (projection, binning, blend) and kernels,
              Lie-group, spline and dual-quaternion ops, meshes, ARAP,
              SuGaR's regularisers
  models/     fixed-capacity Gaussian field (with densify / prune), the
              spacetime field and its deformation network, SuGaR's
              mesh-bound Gaussians (static and dynamic), Adam, state
              conversion, PLY I/O, mesh extraction and export, heat-method
              geodesics
  renderers/  diff-gaussian-rasterizer and its -advanced, -background,
              -normal and -shading variants, the spacetime renderer and
              the SuGaR renderers (-normal, -shading, -temporal)
  materials/  no-material and the point-light material
  backgrounds/ solid colour and the neural environment map
  guidance/   SDS math, the fake and analytic-scene guidances, Stable
              Diffusion, MVDream / ImageDream, Zero123, the CLIP tokenizer,
              text encoder and image tower
  diffusion/  the UNet (multiview too) and VAE of the diffusion guidance
  data/       random-camera sampler, the fixed eval circles, the single
              image and the video frames
  systems/    the text-to-3D, multi-view, image-to-3D, video-to-4D and
              SuGaR (static and 4D) training steps and their eval renders
  utils/      registry, config system, losses, checkpoints, image saving
"""

__version__ = "0.1.0"

from .utils.registry import find, register, registry  # noqa: F401

# importing the subpackages registers their components
from . import ops  # noqa: F401,E402
from . import models  # noqa: F401,E402
from . import materials  # noqa: F401,E402
from . import backgrounds  # noqa: F401,E402
from . import renderers  # noqa: F401,E402
from . import guidance  # noqa: F401,E402
from . import data  # noqa: F401,E402
from . import systems  # noqa: F401,E402
