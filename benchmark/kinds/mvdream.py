"""Kind ``mvdream``: text-to-3D with the MVDream guidance, shading
renderer, point-light material and neural environment background
(``gaussian-splatting-mvdream-system``).  Its hooks are ``sd``'s:
``reference.train.TextTo3D`` takes the 4-view step from the
configuration's ``kind``, the weights are the camera-conditioned UNet and
the VAE's encoder, and the model FLOPs are counted alike at the
guidance's ``image_size``."""

from benchmark.kinds.sd import Reference, model_seconds, weight_files  # noqa: F401
