"""The port's textured-mesh bake (threestudio_3dgs_tpu_torch.ops.tri_raster,
models.texture_bake, models.sugar's postprocess) against the JAX package on
the CPU, mirroring tests/test_tri_raster.py and tests/test_sugar.py's bake
and postprocess tests.  Inputs are drawn from numpy with a seed and go
through both packages.

Every id-pass pixel and every texel is held equal, except where the JAX
computation has a tie: two faces' depths within 1e-5 at a pixel, or the two
densest Gaussians of a texel within 1e-5 relative.  The tests count those
exceptions (none occur on these inputs: the port writes the JAX package's
sums, products and fused multiply-adds in XLA's and numpy's order)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import test_torch_train  # noqa: F401  (shares the CPU threads between workers)

from threestudio_3dgs_tpu.models import texture_bake as jtb
from threestudio_3dgs_tpu.models.sugar import SuGaRConfig as JaxSuGaRConfig
from threestudio_3dgs_tpu.models.sugar import SuGaRModel as JaxSuGaRModel
from threestudio_3dgs_tpu.ops.camera import camera_from_c2w as jax_camera
from threestudio_3dgs_tpu.ops.tri_raster import rasterize_triangles_camera as jax_raster

from threestudio_3dgs_tpu_torch.models import texture_bake as ptb
from threestudio_3dgs_tpu_torch.models.convert import sugar_state_from_numpy
from threestudio_3dgs_tpu_torch.models.sugar import SuGaRModel
from threestudio_3dgs_tpu_torch.ops.camera import camera_from_c2w as port_camera
from threestudio_3dgs_tpu_torch.ops.mesh import icosphere
from threestudio_3dgs_tpu_torch.ops.tri_raster import rasterize_triangles_camera as port_raster
from threestudio_3dgs_tpu_torch.utils.saving import decode_png

Z_TIE = 1e-5
DENSITY_TIE = 1e-5


def cameras(c2w, fov, h, w):
    return (jax_camera(jnp.asarray(c2w), fov, fov, h, w),
            port_camera(np.asarray(c2w), fov, fov, h, w, device="cpu"))


def front(h=64, w=64, fov=0.8):
    """Identity c2w: the camera at the origin looking down -z."""
    return cameras(np.eye(4, dtype=np.float32), fov, h, w)


def orbit(rng, h, w, radius=2.0, fov=0.7):
    th, el = rng.uniform(0, 2 * np.pi), rng.uniform(-0.6, 0.6)
    pos = radius * np.array([np.cos(th) * np.cos(el), np.sin(el), np.sin(th) * np.cos(el)])
    fwd = -pos / np.linalg.norm(pos)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, pos
    return cameras(c2w, fov, h, w)


def quad_mesh(z=-2.0, half=0.8):
    verts = np.array([[-half, -half, z], [half, -half, z], [half, half, z], [-half, half, z]],
                     np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def noisy_sphere(seed=0, subdivisions=3):
    verts, faces = icosphere(subdivisions, 0.6)
    rng = np.random.default_rng(seed)
    return (verts + rng.normal(scale=0.02, size=verts.shape)).astype(np.float32), faces


def both_raster(verts, faces, cams, **kw):
    jc, pc = cams
    return (jax_raster(verts, faces, jc, **kw),
            port_raster(torch.tensor(verts), torch.tensor(faces, dtype=torch.int64), pc, **kw))


def face_depth_at(verts, faces, cam, f, y, x):
    """The JAX camera's screen-space depth of face f at pixel (y, x), and
    whether the face covers it."""
    w2c, proj = np.asarray(cam.w2c, np.float64), np.asarray(cam.full_proj, np.float64)
    v = np.concatenate([verts[faces[f]], np.ones((3, 1))], 1).astype(np.float64)
    clip = v @ proj.T
    ndc = clip[:, :2] / clip[:, 3:]
    p = np.stack([((ndc[:, 0] + 1) * cam.width - 1) / 2, ((ndc[:, 1] + 1) * cam.height - 1) / 2], 1)
    z = v @ w2c[2]
    t = np.array([x, y], np.float64)

    def cross(a, b):
        return a[0] * b[1] - a[1] * b[0]

    e = np.array([cross(p[2] - p[1], t - p[1]), cross(p[0] - p[2], t - p[2]),
                  cross(p[1] - p[0], t - p[0])])
    b = e / e.sum()
    return float(b @ z), bool((b >= -1e-6).all())


def assert_id_pass_equal(a, b, verts, faces, jcam):
    """Face ids, barycentrics and depths equal at every pixel but z ties;
    returns the number of tie pixels."""
    fa, fb = np.asarray(a.face_id), b.face_id.numpy()
    ties = 0
    for y, x in zip(*np.nonzero(fa != fb)):
        assert fa[y, x] >= 0 and fb[y, x] >= 0, (y, x)
        za, ca = face_depth_at(verts, faces, jcam, fa[y, x], y, x)
        zb, cb = face_depth_at(verts, faces, jcam, fb[y, x], y, x)
        assert ca and cb and abs(za - zb) <= Z_TIE, (y, x, za, zb)
        ties += 1
    same = fa == fb
    np.testing.assert_array_equal(np.asarray(a.bary)[same], b.bary.numpy()[same])
    np.testing.assert_array_equal(np.asarray(a.zbuf)[same], b.zbuf.numpy()[same])
    assert int(a.n_dropped_pairs) == int(b.n_dropped_pairs)
    assert int(a.n_dropped_tile) == int(b.n_dropped_tile)
    return ties


class TestTriRaster:
    @pytest.mark.parametrize("seed,h,w,max_pairs,per_tile", [
        (0, 96, 80, 1 << 14, 64), (1, 64, 64, 1 << 14, 1024), (2, 72, 96, 1 << 14, 16),
        (3, 64, 64, 600, 64)], ids=["orbit", "roomy", "tile_cap", "pair_cap"])
    def test_id_pass_matches_jax(self, seed, h, w, max_pairs, per_tile):
        """A noisy icosphere from a random orbit view, at a roomy capacity
        and with either capacity cut (both packages drop the same pairs)."""
        verts, faces = noisy_sphere(seed)
        rng = np.random.default_rng(seed)
        cams = orbit(rng, h, w)
        a, b = both_raster(verts, faces, cams, max_pairs=max_pairs, max_faces_per_tile=per_tile)
        assert (np.asarray(a.face_id) >= 0).sum() > 500
        if seed == 2:
            assert int(a.n_dropped_tile) > 0
        if seed == 3:
            assert int(a.n_dropped_pairs) > 0
        assert assert_id_pass_equal(a, b, verts, faces, cams[0]) == 0

    def test_occlusion_near_wins(self):
        cams = front()
        verts = np.array([[-1.5, -1.5, -3], [1.5, -1.5, -3], [0, 1.5, -3],
                          [-0.4, -0.4, -2], [0.4, -0.4, -2], [0, 0.5, -2]], np.float32)
        faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
        a, b = both_raster(verts, faces, cams)
        fid = b.face_id.numpy()
        assert fid[32, 32] == 1 and fid[0, 0] == -1 and fid[50, 32] == 0
        assert abs(float(b.zbuf[32, 32]) - 2.0) < 1e-3 and float(b.zbuf[0, 0]) == -1.0
        assert assert_id_pass_equal(a, b, verts, faces, cams[0]) == 0
        a2, b2 = both_raster(verts, faces[::-1].copy(), cams)
        assert b2.face_id[32, 32] == 0
        assert assert_id_pass_equal(a2, b2, verts, faces[::-1].copy(), cams[0]) == 0

    def test_barycentric_interpolation(self):
        cams = front(128, 128)
        verts, faces = quad_mesh()
        a, b = both_raster(verts, faces, cams)
        fid, bary = b.face_id.numpy(), b.bary.numpy()
        hit = fid >= 0
        assert hit.sum() > 1000
        assert np.abs(bary[hit].sum(-1) - 1.0).max() < 1e-5 and bary[hit].min() > -1e-5
        ys, xs = np.nonzero(hit)
        pos = (bary[hit][:, :, None] * verts[faces[fid[hit]]]).sum(1)
        proj = cams[1].full_proj.numpy()
        ph = pos @ proj[:3, :3].T + proj[:3, 3]
        ndc = ph[:, :2] / (pos @ proj[3, :3] + proj[3, 3])[:, None]
        assert np.abs(((ndc[:, 0] + 1) * 128 - 1) / 2 - xs).max() < 1e-2
        assert np.abs(((ndc[:, 1] + 1) * 128 - 1) / 2 - ys).max() < 1e-2
        assert assert_id_pass_equal(a, b, verts, faces, cams[0]) == 0

    def test_backface_rasterizes(self):
        cams = front()
        verts, faces = quad_mesh()
        flipped = faces[:, ::-1].copy()
        _, b = both_raster(verts, faces, cams)
        a2, b2 = both_raster(verts, flipped, cams)
        assert (b.face_id >= 0).sum() == (b2.face_id >= 0).sum() > 0
        assert assert_id_pass_equal(a2, b2, verts, flipped, cams[0]) == 0

    def test_behind_camera_culled(self):
        cams = front()
        verts = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2]], np.float32)
        faces = np.array([[0, 1, 2]], np.int32)
        a, b = both_raster(verts, faces, cams)
        assert bool((b.face_id == -1).all()) and (np.asarray(a.face_id) == -1).all()

    def test_tile_order_and_z_ties(self):
        """Pairs are ordered by a stable sort on the tile, so a tile lists
        its faces in ascending id in both packages: of identical faces (a
        z tie everywhere) the lowest id wins, and past max_faces_per_tile
        the nearest of the first ids wins, not the nearest overall."""
        cams = front()
        # faces 0..5: one triangle around the view axis at depths 2.5, 2.4,
        # ..., 2.0 (each nearer one covers the farther ones' pixels), then
        # face 6 a duplicate of the nearest
        tri = np.array([[-0.5, -0.5, -2.0], [0.5, -0.5, -2.0], [0.0, 0.5, -2.0]], np.float32)
        verts = np.concatenate([tri + [0, 0, -0.5 + 0.1 * i] for i in range(6)] + [tri])
        verts = verts.astype(np.float32)
        faces = np.arange(21, dtype=np.int32).reshape(7, 3)
        a, b = both_raster(verts, faces, cams)
        fid = b.face_id.numpy()
        assert set(np.unique(fid[fid >= 0])) == {5}  # face 5 beats its duplicate 6
        assert assert_id_pass_equal(a, b, verts, faces, cams[0]) == 0
        a, b = both_raster(verts, faces, cams, max_faces_per_tile=4)
        fid = b.face_id.numpy()
        assert int(b.n_dropped_tile) > 0
        # the centre's tile lists all seven: the nearest of its first four
        # wins; outer tiles, past the far faces' reach, list 4..6 and keep 5
        assert fid[32, 32] == 3 and 6 not in fid and 5 in fid
        assert assert_id_pass_equal(a, b, verts, faces, cams[0]) == 0


class TestUVAtlas:
    @pytest.mark.parametrize("n_faces,ss", [(10, 10), (7, 16), (1, 6)])
    def test_layout(self, n_faces, ss):
        tex_j, uv_j = jtb.build_triangle_uv_atlas(n_faces, ss)
        tex_p, uv_p = ptb.build_triangle_uv_atlas(n_faces, ss)
        assert tex_p == tex_j
        np.testing.assert_array_equal(uv_p, uv_j)
        # bottom and top triangles of one square share no texel centre
        jj, ii = np.meshgrid(np.arange(ss), np.arange(ss), indexing="ij")
        px = torch.tensor(np.stack([ii + 0.5, jj + 0.5], -1).reshape(-1, 2), dtype=torch.float32)
        if n_faces > 1:
            b0 = ptb._uv_bary(px, torch.tensor(uv_p[0]).expand(ss * ss, 3, 2))
            b1 = ptb._uv_bary(px, torch.tensor(uv_p[1]).expand(ss * ss, 3, 2))
            assert not bool(((b0.amin(-1) > 0) & (b1.amin(-1) > 0)).any())
            want = jtb._uv_bary(px.numpy(), np.broadcast_to(uv_j[0], (ss * ss, 3, 2)))
            np.testing.assert_array_equal(b0.numpy(), want)


def gradient_bake(package):
    h = w = 128
    cams = front(h, w)
    verts, faces = quad_mesh()
    tex, uv = jtb.build_triangle_uv_atlas(len(faces), square_size=16)
    rgb = np.zeros((h, w, 3), np.float32)
    rgb[..., 0] = np.linspace(0, 1, w)[None, :]
    rgb[..., 1] = np.linspace(0, 1, h)[:, None]
    if package == "jax":
        return jtb.bake_texture_uv(verts, faces, uv, tex, [{"rgb": rgb, "camera": cams[0]}])
    return ptb.bake_texture_uv(torch.tensor(verts), torch.tensor(faces), torch.tensor(uv), tex,
                               [{"rgb": rgb, "camera": cams[1]}]).numpy()


class TestPerTexelBake:
    def test_bake_matches_jax(self):
        """The scatter-average of a colour gradient: every texel equal."""
        got, want = gradient_bake("port"), gradient_bake("jax")
        np.testing.assert_array_equal(got, want)

    def test_intra_square_gradient(self):
        texture = gradient_bake("port")
        _, uv = ptb.build_triangle_uv_atlas(2, 16)
        jj, ii = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
        px = np.stack([ii + 0.5, jj + 0.5], -1).reshape(-1, 2)
        inside = jtb._uv_bary(px, np.broadcast_to(uv[0], (256, 3, 2))).min(-1) > 0.05
        texels = texture[px[inside, 1].astype(int), px[inside, 0].astype(int)]
        assert texels.std(axis=0).max() > 0.05

    def test_bake_round_trip(self):
        texture = gradient_bake("port")
        verts, faces = quad_mesh()
        cams = front(128, 128)
        tex, uv = ptb.build_triangle_uv_atlas(2, 16)
        out = port_raster(torch.tensor(verts), torch.tensor(faces), cams[1])
        fid, bary = out.face_id.numpy(), out.bary.numpy()
        hit = fid >= 0
        puv = (bary[hit][..., None] * uv[fid[hit]]).sum(1)
        a = np.clip(np.floor(puv[:, 0]).astype(int), 0, tex - 1)
        b = np.clip(np.floor(puv[:, 1]).astype(int), 0, tex - 1)
        rgb = np.zeros((128, 128, 3), np.float32)
        rgb[..., 0] = np.linspace(0, 1, 128)[None, :]
        rgb[..., 1] = np.linspace(0, 1, 128)[:, None]
        err = np.abs(texture[b, a] - rgb[hit])
        assert np.median(err) < 0.05 and err.mean() < 0.1

    def test_occluded_face_keeps_init(self):
        h = w = 64
        cams = front(h, w)
        vf, ff = quad_mesh(z=-3.0, half=0.3)
        vn, fn = quad_mesh(z=-2.0, half=1.0)
        verts = np.concatenate([vf, vn])
        faces = np.concatenate([ff, fn + 4]).astype(np.int32)
        tex, uv = ptb.build_triangle_uv_atlas(len(faces), square_size=16)
        rgb = np.ones((h, w, 3), np.float32)
        init = np.full((tex, tex, 3), 0.25, np.float32)
        texture = ptb.bake_texture_uv(torch.tensor(verts), torch.tensor(faces), torch.tensor(uv),
                                      tex, [{"rgb": rgb, "camera": cams[1]}],
                                      torch.tensor(init)).numpy()
        c0, c2 = uv[0].mean(0).astype(int), uv[2].mean(0).astype(int)
        assert np.allclose(texture[c0[1], c0[0]], 0.25)
        assert np.allclose(texture[c2[1], c2[0]], 1.0, atol=1e-5)
        want = jtb.bake_texture_uv(verts, faces, uv, tex, [{"rgb": rgb, "camera": cams[0]}], init)
        np.testing.assert_array_equal(texture, want)

    def test_save_obj_bytes(self, tmp_path):
        """OBJ and MTL bytes equal to the JAX package's, PNG pixels equal
        to what imageio wrote there."""
        import imageio.v2 as imageio

        texture = gradient_bake("port")
        verts, faces = quad_mesh()
        verts = verts + np.float32(-1e-7)  # some -0.000000 rows
        tex, uv = ptb.build_triangle_uv_atlas(2, 16)
        os.makedirs(tmp_path / "p")
        os.makedirs(tmp_path / "j")
        port_path = ptb.save_textured_obj_uv(str(tmp_path / "p" / "mesh.obj"), torch.tensor(verts),
                                             torch.tensor(faces), uv, tex, torch.tensor(texture))
        jax_path = jtb.save_textured_obj_uv(str(tmp_path / "j" / "mesh.obj"), verts, faces, uv,
                                            tex, texture)
        for ext in (".obj", ".mtl"):
            with open(port_path[:-4] + ext, "rb") as f, open(jax_path[:-4] + ext, "rb") as g:
                assert f.read() == g.read(), ext
        text = open(port_path).read()
        assert text.count("\nvt ") == 3 * len(faces) and "mtllib" in text
        with open(port_path[:-4] + ".png", "rb") as f:
            png = decode_png(f.read())
        np.testing.assert_array_equal(png, imageio.imread(jax_path[:-4] + ".png"))


def densest_ties(verts, faces, uv, ss, xyz, inv_rot):
    """Per texel of the JAX package's init, whether its two densest
    Gaussians are within DENSITY_TIE relative (numpy, as the JAX code)."""
    tex = jtb.build_triangle_uv_atlas(len(faces), ss)[0]
    ties = np.zeros((tex, tex), bool)
    n_g = len(xyz) // len(faces)
    jj, ii = np.meshgrid(np.arange(ss), np.arange(ss), indexing="ij")
    local = np.stack([ii + 0.5, jj + 0.5], -1).reshape(-1, 2).astype(np.float32)
    for f in range(len(faces)):
        px = (uv[f].min(0) // ss) * ss + local
        bary = np.clip(jtb._uv_bary(px, np.broadcast_to(uv[f], (len(px), 3, 2))), 0, None)
        bary /= np.maximum(bary.sum(-1, keepdims=True), 1e-8)
        pos = bary @ verts[faces[f]]
        g = slice(f * n_g, (f + 1) * n_g)
        warped = np.einsum("gxy,pgx->pgy", inv_rot[g], pos[:, None] - xyz[g][None])
        dens = np.sort(np.exp(-0.5 * np.clip((warped ** 2).sum(-1), 0, 1e8)), axis=-1)
        if n_g > 1:
            tie = dens[:, -1] - dens[:, -2] <= DENSITY_TIE * dens[:, -1]
            ties[px[:, 1].astype(int), px[:, 0].astype(int)] |= tie
    return ties


class TestInitFromSH:
    def test_densest_gaussian_wins(self):
        verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        faces = np.array([[0, 1, 2]], np.int32)
        tex, uv = ptb.build_triangle_uv_atlas(1, square_size=16)
        bary_tab = np.array([[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]],
                            np.float32)
        centers = bary_tab @ verts
        inv_rot = np.broadcast_to(np.eye(3, dtype=np.float32) / 0.05, (3, 3, 3)).copy()
        colors = np.eye(3, dtype=np.float32)
        texture = ptb.init_texture_from_sh(
            torch.tensor(verts), torch.tensor(faces), torch.tensor(uv), tex, 16,
            torch.tensor(centers), torch.tensor(inv_rot), torch.tensor(colors)).numpy()
        for g in range(3):
            puv = (bary_tab[g][:, None] * uv[0]).sum(0)
            assert texture[int(puv[1]), int(puv[0])][g] == pytest.approx(1.0)
        want = jtb.init_texture_from_sh(verts, faces, uv, tex, 16, centers, inv_rot, colors)
        np.testing.assert_array_equal(texture, want)

    @pytest.mark.parametrize("n_g,ss,chunk", [(6, 10, 64), (3, 8, 16384)])
    def test_matches_jax(self, n_g, ss, chunk):
        """An odd face count (the last face without a partner), six or three
        random anisotropic Gaussians a face: every texel equal but the
        counted ties of density."""
        rng = np.random.default_rng(n_g)
        verts, faces = noisy_sphere(n_g, 1)
        faces = faces[:79]
        tex, uv = ptb.build_triangle_uv_atlas(len(faces), ss)
        bary = rng.dirichlet(np.ones(3), size=(len(faces), n_g)).astype(np.float32)
        xyz = np.einsum("fgk,fkx->fgx", bary, verts[faces]).reshape(-1, 3).astype(np.float32)
        rot = np.linalg.qr(rng.normal(size=(len(xyz), 3, 3)))[0].astype(np.float32)
        scales = np.exp(rng.normal(-2.5, 0.5, size=(len(xyz), 3))).astype(np.float32)
        inv_rot = (rot / scales[:, None, :]).astype(np.float32)
        colors = rng.uniform(size=(len(xyz), 3)).astype(np.float32)
        want = jtb.init_texture_from_sh(verts, faces, uv, tex, ss, xyz, inv_rot, colors)
        got = ptb.init_texture_from_sh(
            torch.tensor(verts), torch.tensor(faces), torch.tensor(uv), tex, ss,
            torch.tensor(xyz), torch.tensor(inv_rot), torch.tensor(colors), chunk=chunk).numpy()
        ties = densest_ties(verts, faces, uv, ss, xyz, inv_rot)
        differ = (got != want).any(-1)
        assert not (differ & ~ties).any()
        assert differ.sum() == 0  # the count of tie exceptions on these inputs
        assert (np.abs(got - 0.5) > 1e-6).any(-1).mean() > 0.5


def sugar_models(n_per_face=1, opacity=0.5, mesh=None, scales=None):
    """The JAX and the port's SuGaR models bound to one mesh, the port's
    state converted from the JAX package's."""
    verts, faces = mesh if mesh is not None else noisy_sphere(0, 2)
    jm = JaxSuGaRModel(JaxSuGaRConfig(n_gaussians_per_surface_triangle=n_per_face,
                                      init_gs_opacity=opacity))
    jm.bind_mesh(verts, faces)
    js = jm.init_state(0)
    if scales is not None:
        js = js.replace(params=js.params.replace(scales=jnp.full_like(js.params.scales, scales)))
    pm = SuGaRModel(device="cpu", n_gaussians_per_surface_triangle=n_per_face,
                    init_gs_opacity=opacity)
    pm.bind_mesh(verts, faces)
    return jm, js, pm, sugar_state_from_numpy(js, device="cpu")


def grid_mesh(n=8, z=0.0):
    xs = np.linspace(-1, 1, n)
    verts = np.array([[x, y, z] for y in xs for x in xs], np.float32)
    faces = []
    for j in range(n - 1):
        for i in range(n - 1):
            a = j * n + i
            faces += [[a, a + 1, a + n], [a + 1, a + n + 1, a + n]]
    return verts, np.asarray(faces, np.int32)


class TestPostprocess:
    def test_compute_density_matches_jax(self):
        jm, js, pm, ps = sugar_models(3, 0.9)
        means = pm.as_gaussian_arrays(ps)["means3d"]
        pts = torch.cat([means[:40], means[:40] * 3.0, means[:40] + 0.01])
        got = pm.compute_density(ps, pts).numpy()
        want = jm.compute_density(js, pts.numpy())
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert (got[:40] > got[40:80] + 0.05).all()

    @pytest.mark.parametrize("opacity,scales,threshold,iterations", [
        (0.01, None, 0.5, 1), (0.99, np.log(3.0), 0.1, 1), (0.5, None, 0.3, 2)],
        ids=["low_density_removed", "high_density_readded", "two_rings"])
    def test_postprocess_matches_jax(self, opacity, scales, threshold, iterations):
        jm, js, pm, ps = sugar_models(1, opacity, grid_mesh(8), scales)
        jn = jm.postprocess_state(js, density_threshold=threshold, iterations=iterations)
        pn = pm.postprocess_state(ps, density_threshold=threshold, iterations=iterations)
        np.testing.assert_array_equal(pn.faces.numpy(), np.asarray(jn.faces))
        for k, v in pn.params.as_dict().items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(getattr(jn.params, k)), err_msg=k)
        assert pn.adam.count == 0 and not any(bool(m.any()) for m in pn.adam.mu.values())
        np.testing.assert_array_equal(pm.topology.edge_faces, jm.topology.edge_faces)
        if scales is None and iterations == 1:
            assert pn.n_faces < ps.n_faces
        if scales is not None:
            assert pn.n_faces == ps.n_faces


class TestPointsBake:
    def test_bake_and_save_matches_jax(self, tmp_path):
        """The centre-projection bake (square_size < 6) of a red front view:
        the texture and the OBJ / MTL bytes equal to the JAX package's."""
        jm, js, pm, ps = sugar_models(1)
        arrays = pm.as_gaussian_arrays(ps)
        xyz, normals = arrays["means3d"], arrays["normals"]
        eye = np.array([0.0, -3.0, 0.0])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4, dtype=np.float32)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, np.cross(right, fwd), -fwd, eye
        jc, pc = cameras(c2w, 0.8, 64, 64)
        rgb = np.zeros((64, 64, 3), np.float32)
        rgb[..., 0] = 1.0
        rgb[32:, :, 1] = np.linspace(0, 1, 64)[None]
        texture, uv = ptb.bake_texture(xyz, normals, [{"rgb": rgb, "depth": None, "camera": pc}],
                                       square_size=4)
        want, want_uv = jtb.bake_texture(xyz.numpy(), normals.numpy(),
                                         [{"rgb": rgb, "depth": None, "camera": jc}], square_size=4)
        np.testing.assert_array_equal(uv, want_uv)
        np.testing.assert_allclose(texture.numpy(), want, atol=1e-6)
        assert (texture[..., 0] > 0.9).any()
        face_idx = np.arange(ps.n_faces)
        os.makedirs(tmp_path / "p")
        os.makedirs(tmp_path / "j")
        ptb.save_textured_obj(str(tmp_path / "p" / "baked.obj"), ps.params.points, ps.faces,
                              face_idx, uv, texture)
        jtb.save_textured_obj(str(tmp_path / "j" / "baked.obj"), np.asarray(js.params.points),
                              np.asarray(js.faces), face_idx, want_uv, want)
        for ext in (".obj", ".mtl"):
            assert (open(tmp_path / "p" / f"baked{ext}", "rb").read()
                    == open(tmp_path / "j" / f"baked{ext}", "rb").read())
        assert os.path.exists(tmp_path / "p" / "baked.png")
