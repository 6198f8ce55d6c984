"""The port's hybrid 2-D mesh renderer (cameras x tile rows,
``threestudio_3dgs_tpu_torch/parallel/hybrid.py``) against the one-rank
renders and the JAX package's ``make_hybrid_rasterize``, as
tests/test_hybrid_parallel.py holds the JAX package: the gathered batch
equals the per-view renders, and the inputs' gradients sum over both mesh
axes.  The port runs a (2, 2) mesh of 4 gloo ranks, spawned once for the
file; the JAX side a (2, 2) mesh of 4 of the conftest's virtual devices."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (shares the CPU threads)
from threestudio_3dgs_tpu.ops import camera as jcam
from threestudio_3dgs_tpu.ops.rasterizer import RasterizeConfig as JConfig
from threestudio_3dgs_tpu.parallel.hybrid import make_hybrid_rasterize
from threestudio_3dgs_tpu.parallel.mesh import make_mesh as jmake_mesh

from threestudio_3dgs_tpu_torch.ops import camera as cam_ops
from threestudio_3dgs_tpu_torch.ops.rasterizer import RasterizeConfig, rasterize
from torch_dist_worker import spawn_ranks

SIZE, TILE, MAX_PAIRS, FOV = 64, 16, 1 << 14, 0.85
BG = [0.1, 0.1, 0.1]


def scene(n=400, seed=0):
    """tests/test_hybrid_parallel.py's scene."""
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(n, 3)).astype(np.float32) * 0.4,
        np.exp(rng.normal(size=(n, 3)).astype(np.float32) * 0.4 - 2.6),
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32),
        rng.uniform(size=(n, 3)).astype(np.float32),
    ]


def c2ws(b):
    """tests/test_hybrid_parallel.py's cameras."""
    out = []
    for v in range(b):
        ang = 0.8 * v + 0.3
        eye = np.array([2.1 * np.sin(ang), -2.1 * np.cos(ang), 0.5])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
        out.append(c2w)
    return out


SCENE, C2WS = scene(), c2ws(2)


@pytest.fixture(scope="module")
def jax_side():
    mesh = jmake_mesh(4, axis_names=("data", "tile"), shape=(2, 2))
    cams = [jcam.camera_from_c2w(jnp.asarray(c), FOV, FOV, SIZE, SIZE) for c in C2WS]
    f = make_hybrid_rasterize(mesh, cams, jnp.asarray(BG),
                              config=JConfig(tile_size=TILE, max_pairs=MAX_PAIRS, impl="jax"))
    args = tuple(map(jnp.asarray, SCENE))

    def loss(*a):
        out = f(*a)
        return jnp.sum(out["image"] ** 2) + jnp.sum(out["alpha"])

    return dict(out=jax.device_get(jax.jit(f)(*args)),
                grads=[np.asarray(g) for g in
                       jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    case = dict(scene=SCENE, c2ws=C2WS, fov=FOV, size=SIZE, bg=BG, tile_size=TILE,
                max_pairs=MAX_PAIRS, shape=(2, 2))
    return spawn_ranks(4, [("hybrid", "hybrid_render", case)],
                       str(tmp_path_factory.mktemp("hybrid")))


@pytest.fixture(scope="module")
def single():
    """Each view rendered alone by the port, and the gradients of the
    summed per-view loss."""
    xs = [torch.tensor(a, requires_grad=True) for a in SCENE]
    cfg = RasterizeConfig(tile_size=TILE, max_pairs=MAX_PAIRS)
    outs, total = [], 0.0
    for c in C2WS:
        cam = cam_ops.camera_from_c2w(c, FOV, FOV, SIZE, SIZE, device="cpu")
        o = rasterize(*xs[:4], cam, torch.tensor(BG), colors=xs[4], config=cfg)
        total = total + torch.sum(o["image"] ** 2) + torch.sum(o["alpha"])
        outs.append({k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                     for k, v in o.items()})
    return outs, [g.numpy() for g in torch.autograd.grad(total, xs)]


class TestHybrid2DMesh:
    def test_forward_matches_single_device(self, ranks, single, jax_side):
        refs, _ = single
        for r, res in enumerate(ranks):
            out = res["hybrid"]
            assert out["image"].shape == (2, SIZE, SIZE, 3)
            ci = out["coordinate"][0]
            for v, ref in enumerate(refs):
                for want in (ref["image"], np.asarray(jax_side["out"]["image"][v])):
                    np.testing.assert_allclose(out["image"][v], want, rtol=0, atol=1e-5)
                for want in (ref["depth"], np.asarray(jax_side["out"]["depth"][v])):
                    np.testing.assert_allclose(out["depth"][v], want, rtol=0, atol=1e-4)
                np.testing.assert_allclose(out["alpha"][v], ref["alpha"], rtol=0, atol=1e-5)
            # this rank's camera shard: radii and the band union of visibility
            np.testing.assert_array_equal(out["radii"][0], refs[ci]["radii"])
            np.testing.assert_array_equal(out["visibility"][0], refs[ci]["visibility"])
            np.testing.assert_array_equal(out["visibility"][0],
                                          np.asarray(jax_side["out"]["visibility"][ci]))
            assert out["n_dropped"] == int(jax_side["out"]["n_dropped"]) == 0

    def test_grads_psum_over_both_axes(self, ranks, single, jax_side):
        _, ref_grads = single
        for r, res in enumerate(ranks):
            for a, b, jb in zip(res["hybrid"]["grads"], ref_grads, jax_side["grads"]):
                scale = max(1.0, float(np.abs(b).max()))
                np.testing.assert_allclose(a, b, rtol=0, atol=3e-4 * scale)
                np.testing.assert_allclose(a, jb, rtol=0, atol=3e-4 * scale)

    def test_mesh_coordinates(self, ranks):
        """Rank r sits at (r // 2, r % 2) of the row-major (data, tile) mesh."""
        assert [res["hybrid"]["coordinate"] for res in ranks] == [[0, 0], [0, 1], [1, 0], [1, 1]]
