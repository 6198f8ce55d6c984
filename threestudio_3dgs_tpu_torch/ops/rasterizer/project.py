"""Per-Gaussian view preprocessing as one hand-differentiated step: the CUDA
kernel pair K7 (``csrc/project.cu``) and its plain torch twins.

``project`` projects the Gaussians into B cameras of one size (B = 1 for
``rasterize``; B stacked views for ``rasterize_batched``, their tile rows
shifted down by v * grid_y) and returns the ``Projected`` fields together
with the binning's ``RowFields`` (the packed rect and reachable-tile mask,
the exact pair counts, the depth sort key and the cull fields), so that
``plan_pairs`` only sorts, sums and reads the total.  It runs under
``Project``, a ``torch.autograd.Function`` like ``Blend`` and
``PairGather``: one node a render, whose backward maps d means2d, d depths
and d conics to d means3d, d scales, d quats and d means2d_offset from the
saved inputs alone.

Dispatch is by device, as ``blend.py``'s: CPU tensors take the twins, CUDA
tensors the kernels.  The forward twin is ``project_gaussians`` plus
``binning.row_fields`` a view, with the culled rows (dead, or at view depth
<= 0.2) set to the kernel's culled outputs: their depth, zeros elsewhere,
``MASK_NONE`` and a +inf sort key.  The backward twin
(``project_bwd_torch``) is the kernel's hand-derived gradient in torch,
which ``tests/test_torch_project.py`` holds to ``torch.autograd`` through
``project_gaussians`` in float64: exact zeros on culled and det <= 0 rows,
clamp's gradient at the Jacobian limits with the bounds included, the
quaternion's normalisation and the scaling modifier.

Each launch is counted in ``native.LAUNCHES`` and under its shape tag
(``"<views>x<rows>"``, and ``"stacked"`` for B > 1); the forward runs in a
``render/project`` span and the backward in ``render/backward`` >
``render/project``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...utils.tracing import span
from .. import native
from ..camera import Camera
from .binning import RowFields, row_fields
from .expand import MASK_NONE
from .preprocess import Projected, _cov3d_entries, camera_scalars, project_gaussians

# (name, trailing shape) of the row inputs that may have a leading view axis
_ROW_INPUTS = (("means3d", (3,)), ("scales", (3,)), ("quats", (4,)), ("opac", ()),
               ("alive", ()), ("offset", (2,)))


@dataclasses.dataclass(frozen=True)
class ProjectViews:
    """The cameras of one projection and its grid."""

    cameras: Tuple[Camera, ...]
    tile_size: int
    scaling_modifier: float

    @property
    def grid(self) -> Tuple[int, int]:
        cam, ts = self.cameras[0], self.tile_size
        return (cam.width + ts - 1) // ts, (cam.height + ts - 1) // ts

    @property
    def view_grid_y(self) -> int:
        """Tile rows between stacked views (0: one view)."""
        return self.grid[1] if len(self.cameras) > 1 else 0

    @functools.cached_property
    def table(self) -> torch.Tensor:
        """The (B, 36) float32 rows K7 reads its cameras from, on the
        cameras' device: each view's row-major ``w2c`` and ``full_proj``,
        then its ``camera_scalars``.  Built once, at its first read (the
        forward's), and read again by the backward; the scalars go over in
        one non-blocking copy from pinned memory, so it reads nothing back."""
        cams = self.cameras
        device = cams[0].w2c.device
        for cam in cams:
            for name, mat in (("w2c", cam.w2c), ("full_proj", cam.full_proj)):
                if tuple(mat.shape) != (4, 4) or mat.dtype != torch.float32 or \
                        mat.device != device:
                    raise ValueError(f"camera {name} must be (4, 4) float32 on {device}")
        b = len(cams)
        host = torch.empty((b, 4), dtype=torch.float32, pin_memory=device.type == "cuda")
        host.numpy()[:] = [camera_scalars(cam) for cam in cams]
        mats = torch.cat([m.reshape(1, 16) for cam in cams for m in (cam.w2c, cam.full_proj)], 1)
        return torch.cat([mats.reshape(b, 32), host.to(device, non_blocking=True)], 1)


def _view(t: Optional[torch.Tensor], v: int, trailing: tuple) -> Optional[torch.Tensor]:
    """View v of an input with a leading view axis, else the input."""
    if t is None or t.dim() == len(trailing) + 1:
        return t
    return t[v]


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def project_fwd_torch(means3d, scales, quats, opacities, alive, means2d_offset,
                      views: ProjectViews) -> Tuple[Projected, RowFields]:
    """Plain twin of K7's forward: ``project_gaussians`` and the row pass a
    view, the culled rows set to the kernel's culled outputs."""
    gy, vgy = views.grid[1], views.view_grid_y
    projs: List[Projected] = []
    rows: List[RowFields] = []
    for v, cam in enumerate(views.cameras):
        alive_v = _view(alive, v, ())
        proj = project_gaussians(
            _view(means3d, v, (3,)), _view(scales, v, (3,)), _view(quats, v, (4,)), cam,
            tile_size=views.tile_size, scaling_modifier=views.scaling_modifier, alive=alive_v,
            means2d_offset=_view(means2d_offset, v, (2,)),
        )
        if vgy:
            shift = torch.tensor([0, v * gy], dtype=proj.tiles_min.dtype,
                                 device=proj.tiles_min.device)
            proj = proj._replace(tiles_min=proj.tiles_min + shift,
                                 tiles_max=proj.tiles_max + shift)
        row = row_fields(proj, views.tile_size, _view(opacities, v, ()), vgy)
        live = proj.depths > 0.2
        if alive_v is not None:
            live = live & alive_v
        col = live[:, None]
        culled_rect = torch.tensor([0, 0, 0, MASK_NONE], dtype=row.rect.dtype,
                                   device=row.rect.device)
        projs.append(proj._replace(
            means2d=torch.where(col, proj.means2d, torch.zeros_like(proj.means2d)),
            conics=torch.where(col, proj.conics, torch.zeros_like(proj.conics)),
            tiles_min=torch.where(col, proj.tiles_min, torch.zeros_like(proj.tiles_min)),
            tiles_max=torch.where(col, proj.tiles_max, torch.zeros_like(proj.tiles_max)),
        ))
        rows.append(row._replace(
            rect=torch.where(col, row.rect, culled_rect),
            cull_fields=torch.where(col, row.cull_fields, torch.zeros_like(row.cull_fields)),
        ))
    if len(projs) == 1:
        return projs[0], rows[0]
    return (Projected(*(torch.cat(leaves, dim=0) for leaves in zip(*projs))),
            RowFields(*(torch.cat(leaves, dim=0) for leaves in zip(*rows))))


def _mv3(m, r):
    return m[:, 0] * r[0] + m[:, 1] * r[1] + m[:, 2] * r[2] + r[3]


def conic_terms(m, s, q, cam: Camera, modifier: float, alive) -> Dict[str, torch.Tensor]:
    """The forward terms the hand backward reads, the 2D covariance in
    ``project_gaussians``' operation order (so ``live``, in frustum with
    det > 0, is its decision in the same dtype)."""
    dt = m.dtype
    w2c, fp = cam.w2c.to(dt), cam.full_proj.to(dt)
    fx, fy, lx, ly = camera_scalars(cam)
    depth = _mv3(m, w2c[2])
    live = depth > 0.2
    if alive is not None:
        live = live & alive
    ones = torch.ones_like(depth)
    z = torch.where(live, depth, ones)
    px, py = _mv3(m, w2c[0]), _mv3(m, w2c[1])
    u, v = px / z, py / z
    tx, ty = torch.clamp(u, -lx, lx) * z, torch.clamp(v, -ly, ly) * z
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    rw3 = w2c[:3, :3]
    t0 = (fx * inv_z)[:, None] * rw3[0] + (-fx * tx * inv_z2)[:, None] * rw3[2]
    t1 = (fy * inv_z)[:, None] * rw3[1] + (-fy * ty * inv_z2)[:, None] * rw3[2]
    s00, s01, s02, s11, s12, s22 = _cov3d_entries(s, q, modifier)

    def sigma_vec(vec):
        vx, vy, vz = vec.unbind(-1)
        return torch.stack([s00 * vx + s01 * vy + s02 * vz, s01 * vx + s11 * vy + s12 * vz,
                            s02 * vx + s12 * vy + s22 * vz], dim=-1)

    st0, st1 = sigma_vec(t0), sigma_vec(t1)
    c00 = t0[:, 0] * st0[:, 0] + t0[:, 1] * st0[:, 1] + t0[:, 2] * st0[:, 2] + 0.3
    c01 = t1[:, 0] * st0[:, 0] + t1[:, 1] * st0[:, 1] + t1[:, 2] * st0[:, 2]
    c11 = t1[:, 0] * st1[:, 0] + t1[:, 1] * st1[:, 1] + t1[:, 2] * st1[:, 2] + 0.3
    det = c00 * c11 - c01 * c01
    live = live & (det > 0.0)
    return dict(w2c=w2c, fp=fp, live=live, z=z, u=u, v=v, tx=tx, ty=ty, inv_z=inv_z,
                inv_z2=inv_z2, t0=t0, t1=t1, st0=st0, st1=st1, c00=c00, c01=c01, c11=c11,
                inv_det=1.0 / torch.where(live, det, ones))


def _bwd_view(m, s, q, alive, cam: Camera, modifier: float, g_m2, g_d, g_c):
    """The hand backward of one view (the kernel's formulas, in the inputs'
    dtype): (d means3d, d scales, d quats, d means2d_offset)."""
    t = conic_terms(m, s, q, cam, modifier, alive)
    w2c, fp, live, z, u, v = t["w2c"], t["fp"], t["live"], t["z"], t["u"], t["v"]
    t0, t1, st0, st1 = t["t0"], t["t1"], t["st0"], t["st1"]
    c00, c01, c11, inv_det = t["c00"], t["c01"], t["c11"], t["inv_det"]
    inv_z, inv_z2 = t["inv_z"], t["inv_z2"]
    fx, fy, lx, ly = camera_scalars(cam)
    size = torch.tensor([cam.width, cam.height], dtype=m.dtype, device=m.device)
    hx, hy = _mv3(m, fp[0]), _mv3(m, fp[1])
    rw = 1.0 / (torch.where(live, _mv3(m, fp[3]), torch.ones_like(z)) + 1e-7)

    sq = (q * q).sum(-1)
    nrm = torch.sqrt(torch.clamp_min(sq, 1e-24))
    qn = q / nrm[:, None]
    w, x, y, zq = qn.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + zq * zq), 2 * (x * y - w * zq), 2 * (x * zq + w * y),
        2 * (x * y + w * zq), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - w * x),
        2 * (x * zq - w * y), 2 * (y * zq + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)
    ms = modifier * s
    s2 = ms * ms
    tx, ty = t["tx"], t["ty"]
    cu, cv = torch.clamp(u, -lx, lx), torch.clamp(v, -ly, ly)
    rw3 = w2c[:3, :3]

    g_ndc = g_m2 * (size * 0.5)
    d_off = g_ndc
    d_rw = g_ndc[:, 0] * hx + g_ndc[:, 1] * hy
    d_wh = -d_rw * rw * rw
    dm = (g_ndc[:, 0:1] * rw[:, None]) * fp[0, :3] + (g_ndc[:, 1:2] * rw[:, None]) * fp[1, :3] \
        + d_wh[:, None] * fp[3, :3]

    gca, gcb, gcc = g_c.unbind(-1)
    d_inv = gca * c11 - gcb * c01 + gcc * c00
    d_det = -d_inv * inv_det * inv_det
    dc00 = gcc * inv_det + d_det * c11
    dc11 = gca * inv_det + d_det * c00
    dc01 = -gcb * inv_det - 2.0 * c01 * d_det
    dt0 = 2.0 * dc00[:, None] * st0 + dc01[:, None] * st1
    dt1 = 2.0 * dc11[:, None] * st1 + dc01[:, None] * st0
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    gs = dc00[:, None, None] * outer(t0, t0) + dc11[:, None, None] * outer(t1, t1) \
        + 0.5 * dc01[:, None, None] * (outer(t0, t1) + outer(t1, t0))
    gr = gs @ rot
    d_s2 = (rot * gr).sum(1)
    d_s = d_s2 * 2.0 * ms * modifier
    dr = (2.0 * gr * s2[:, None, :]).reshape(-1, 9)
    d00, d01, d02, d10, d11, d12, d20, d21, d22 = dr.unbind(-1)
    dqn = 2.0 * torch.stack([
        -zq * d01 + y * d02 + zq * d10 - x * d12 - y * d20 + x * d21,
        y * d01 + zq * d02 + y * d10 - 2 * x * d11 - w * d12 + zq * d20 + w * d21 - 2 * x * d22,
        -2 * y * d00 + x * d01 + w * d02 + x * d10 + zq * d12 - w * d20 + zq * d21 - 2 * y * d22,
        -2 * zq * d00 - w * d01 + x * d02 + w * d10 - 2 * zq * d11 + y * d12 + x * d20 + y * d21,
    ], dim=-1)
    dot = torch.where(sq >= 1e-24, (qn * dqn).sum(-1), torch.zeros_like(sq))
    d_q = (dqn - dot[:, None] * qn) / nrm[:, None]

    dj00, dj02 = (dt0 * rw3[0]).sum(-1), (dt0 * rw3[2]).sum(-1)
    dj11, dj12 = (dt1 * rw3[1]).sum(-1), (dt1 * rw3[2]).sum(-1)
    d_tx = -fx * inv_z2 * dj02
    d_ty = -fy * inv_z2 * dj12
    d_inv_z2 = -fx * tx * dj02 - fy * ty * dj12
    d_inv_z = fx * dj00 + fy * dj11 + 2.0 * inv_z * d_inv_z2
    d_u = torch.where((u >= -lx) & (u <= lx), d_tx * z, torch.zeros_like(z))
    d_v = torch.where((v >= -ly) & (v <= ly), d_ty * z, torch.zeros_like(z))
    dz = -d_inv_z * inv_z * inv_z + g_d + d_tx * cu + d_ty * cv - d_u * u / z - d_v * v / z
    dm = dm + (d_u / z)[:, None] * w2c[0, :3] + (d_v / z)[:, None] * w2c[1, :3] \
        + dz[:, None] * w2c[2, :3]

    col = live[:, None]
    return tuple(torch.where(col, g, torch.zeros_like(g)) for g in (dm, d_s, d_q, d_off))


def project_bwd_torch(means3d, scales, quats, alive, views: ProjectViews, g_means2d, g_depths,
                      g_conics, with_offset: bool):
    """Plain twin of K7's backward: per-view gradients stacked to (B, N, k),
    d means2d_offset None unless ``with_offset`` (an upstream gradient None
    is zero)."""
    n = means3d.shape[-2]
    rows = len(views.cameras) * n
    zeros = means3d.new_zeros
    g_means2d = zeros((rows, 2)) if g_means2d is None else g_means2d
    g_depths = zeros((rows,)) if g_depths is None else g_depths
    g_conics = zeros((rows, 3)) if g_conics is None else g_conics
    grads = [
        _bwd_view(_view(means3d, v, (3,)), _view(scales, v, (3,)), _view(quats, v, (4,)),
                  _view(alive, v, ()), cam, views.scaling_modifier,
                  g_means2d[v * n:(v + 1) * n], g_depths[v * n:(v + 1) * n],
                  g_conics[v * n:(v + 1) * n])
        for v, cam in enumerate(views.cameras)
    ]
    d_m, d_s, d_q, d_o = (torch.stack(g) for g in zip(*grads))
    return d_m, d_s, d_q, d_o if with_offset else None


# ---------------------------------------------------------------------------
# K7 on the card
# ---------------------------------------------------------------------------


def _shape_struct(views: ProjectViews, n: int) -> native.ProjectShape:
    cam = views.cameras[0]
    gx, gy = views.grid
    return native.ProjectShape(n, cam.width, cam.height, views.tile_size, gx, gy,
                               views.view_grid_y, views.scaling_modifier)


def _inputs_struct(tensors, b: int, n: int) -> native.ProjectInputs:
    """Pointers and the view strides of the row inputs (named as
    ``_ROW_INPUTS``; None for an absent one)."""
    s = native.ProjectInputs()
    for (name, trailing), t in zip(_ROW_INPUTS, tensors):
        if t is None:
            continue
        dtype = torch.bool if name == "alive" else torch.float32
        per_view = t.dim() == len(trailing) + 2
        native.check_cuda_tensor(t, name, dtype, t.dim())
        want = ((b,) if per_view else ()) + (n,) + trailing
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want} or shared by the views, got {tuple(t.shape)}")
        setattr(s, name, t.data_ptr())
        setattr(s, name + "_vs", t[0].numel() if per_view else 0)
    return s


def _table(views: ProjectViews, device) -> int:
    if views.table.device != device:
        raise ValueError(f"the cameras must be on {device}, got {views.table.device}")
    return views.table.data_ptr()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _tags(b: int, n: int):
    return (f"{b}x{n}", "stacked" if b > 1 else "")


def project_fwd_cuda(means3d, scales, quats, opacities, alive, means2d_offset,
                     views: ProjectViews) -> Tuple[Projected, RowFields]:
    """K7's forward: one launch for the B views."""
    b, n = len(views.cameras), means3d.shape[-2]
    device = means3d.device
    rows = b * n
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    proj = Projected(
        means2d=torch.empty((rows, 2), **f32), depths=torch.empty(rows, **f32),
        conics=torch.empty((rows, 3), **f32), radii=torch.empty(rows, **i32),
        tiles_min=torch.empty((rows, 2), **i32), tiles_max=torch.empty((rows, 2), **i32),
        visible=torch.empty(rows, dtype=torch.bool, device=device),
    )
    fields = RowFields(
        rect=torch.empty((rows, 4), **i32),
        counts=torch.empty(rows, dtype=torch.int64, device=device),
        sort_key=torch.empty(rows, **f32), cull_fields=torch.empty((rows, 6), **f32),
    )
    out = native.ProjectOutputs(*(t.data_ptr() for t in (*proj, *fields)))
    tensors = (means3d, scales, quats, opacities, alive, means2d_offset)
    native.launch("project_fwd", _inputs_struct(tensors, b, n), _table(views, device),
                  _shape_struct(views, n), b, out, native.stream_handle(device),
                  shape=_tags(b, n))
    return proj, fields


def project_bwd_cuda(means3d, scales, quats, alive, views: ProjectViews, g_means2d, g_depths,
                     g_conics, with_offset: bool):
    """K7's backward: per-view gradients (B, N, k) from the saved inputs (an
    upstream gradient None is zero)."""
    b, n = len(views.cameras), means3d.shape[-2]
    device = means3d.device
    grads_in = [None if g is None else g.contiguous() for g in (g_means2d, g_conics, g_depths)]
    for g, name in zip(grads_in, ("d_means2d", "d_conics", "d_depths")):
        if g is not None:
            native.check_cuda_tensor(g, name, torch.float32, g.dim())
    d_m = torch.empty((b, n, 3), dtype=torch.float32, device=device)
    d_s = torch.empty_like(d_m)
    d_q = torch.empty((b, n, 4), dtype=torch.float32, device=device)
    d_o = torch.empty((b, n, 2), dtype=torch.float32, device=device) if with_offset else None
    g = native.ProjectGrads(*(_ptr(t) for t in (*grads_in, d_m, d_s, d_q, d_o)))
    native.launch("project_bwd", _inputs_struct((means3d, scales, quats, None, alive, None), b, n),
                  _table(views, device), _shape_struct(views, n), b, g,
                  native.stream_handle(device), shape=_tags(b, n))
    return d_m, d_s, d_q, d_o


# ---------------------------------------------------------------------------
# the autograd boundary
# ---------------------------------------------------------------------------


def _to_input(grad: Optional[torch.Tensor], like: Optional[torch.Tensor]):
    """Per-view gradients (B, N, k) in the shape of the input they belong
    to: summed over the views for an input the views share."""
    if grad is None or like is None:
        return None
    if like.dim() == grad.dim():
        return grad
    return grad.sum(0) if grad.shape[0] > 1 else grad[0]


class Project(torch.autograd.Function):
    """The hand-differentiated projection: K7 forward, K7 backward."""

    @staticmethod
    def forward(ctx, means3d, scales, quats, means2d_offset, opacities, alive,
                views: ProjectViews):
        cpu = means3d.device.type == "cpu"
        fn = project_fwd_torch if cpu else project_fwd_cuda
        proj, rows = fn(means3d, scales, quats, opacities, alive, means2d_offset, views)
        ctx.save_for_backward(means3d, scales, quats, alive, means2d_offset)
        ctx.views = views
        # no zero tensors for the outputs that get no gradient (the integer
        # and row-field outputs always, depths without a depth channel)
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(proj.radii, proj.tiles_min, proj.tiles_max, proj.visible,
                                    *rows)
        return (*proj, *rows)

    @staticmethod
    def backward(ctx, g_means2d, g_depths, g_conics, *unused):
        means3d, scales, quats, alive, offset = ctx.saved_tensors
        fn = project_bwd_torch if means3d.device.type == "cpu" else project_bwd_cuda
        with span("render/backward"), span("render/project"):
            d_m, d_s, d_q, d_o = fn(means3d, scales, quats, alive, ctx.views, g_means2d,
                                    g_depths, g_conics, ctx.needs_input_grad[3])
            return (_to_input(d_m, means3d), _to_input(d_s, scales), _to_input(d_q, quats),
                    _to_input(d_o, offset), None, None, None)


def project(
    means3d: torch.Tensor,  # (N, 3) or (B, N, 3)
    scales: torch.Tensor,  # (N, 3) or (B, N, 3), activated
    quats: torch.Tensor,  # (N, 4) or (B, N, 4), unnormalised wxyz
    opacities: torch.Tensor,  # (N,) or (B, N), activated
    cameras: Sequence[Camera],  # B cameras of one height and width
    tile_size: int,
    scaling_modifier: float = 1.0,
    alive: Optional[torch.Tensor] = None,  # (N,) or (B, N)
    means2d_offset: Optional[torch.Tensor] = None,  # (N, 2) or (B, N, 2)
) -> Tuple[Projected, RowFields]:
    """Project the Gaussians into the B cameras, rows view-major (B N rows;
    tile rects shifted down by v * grid_y when B > 1), with the binning's
    row fields for ``view_grid_y = grid_y`` (0 for one camera)."""
    views = ProjectViews(tuple(cameras), int(tile_size), float(scaling_modifier))
    if any(c.height != views.cameras[0].height or c.width != views.cameras[0].width
           for c in views.cameras):
        raise ValueError("project requires cameras of one height and width")
    rows_in = (means3d, scales, quats, means2d_offset, opacities.detach(), alive)
    with span("render/project"):
        out = Project.apply(*(None if t is None else t.contiguous() for t in rows_in), views)
    return Projected(*out[:len(Projected._fields)]), RowFields(*out[len(Projected._fields):])


def project_plain(means3d, scales, quats, opacities, cameras, tile_size, scaling_modifier=1.0,
                  alive=None, means2d_offset=None) -> Tuple[Projected, None]:
    """``project``'s signature over the path before K7: the forward twin
    under ``torch.autograd`` and no row fields, so that ``plan_pairs`` runs
    the plain row pass.  Stands in for ``api.project`` in the checks and
    timings."""
    views = ProjectViews(tuple(cameras), int(tile_size), float(scaling_modifier))
    proj, _ = project_fwd_torch(means3d, scales, quats, opacities, alive, means2d_offset, views)
    return proj, None
