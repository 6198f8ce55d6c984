"""The port's evaluation and export surface against the JAX package on the
CPU: eval renders, PNGs, the point-cloud PLY, mesh extraction, the
decimator, checkpoints and ``--resume``, and the launcher's
``--validate`` / ``--test`` / ``--predict`` / ``--export`` (in process and
as a subprocess).  States start from the JAX package's init, carried over
with ``models/convert.py``."""

import os
import subprocess
import sys

import numpy as np
import imageio.v2 as imageio
import jax
import pytest
import torch

from threestudio_3dgs_tpu.models import gaussian_field as jgf
from threestudio_3dgs_tpu.models import mesh_extract as jmesh
from threestudio_3dgs_tpu.models import ply_io as jply
from threestudio_3dgs_tpu.native import decimate_mesh as jax_decimate_mesh
from threestudio_3dgs_tpu.trainer import Trainer as JaxTrainer
from threestudio_3dgs_tpu.utils import saving as jsaving
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config

from threestudio_3dgs_tpu_torch import launch
from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf
from threestudio_3dgs_tpu_torch.models import mesh_extract as pmesh
from threestudio_3dgs_tpu_torch.models import ply_io as pply
from threestudio_3dgs_tpu_torch.models.convert import gaussian_state_from_numpy, to_numpy
from threestudio_3dgs_tpu_torch.models.decimate import decimate_mesh
from threestudio_3dgs_tpu_torch.systems.base import SystemState
from threestudio_3dgs_tpu_torch.trainer import Trainer
from threestudio_3dgs_tpu_torch.utils import saving as psaving
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config

from test_torch_train import JAX_CONFIG, JAX_ONLY, OVERRIDES, PORT_CONFIG, ROOT

# eval views at the training size; few test views
EVAL = ["data.eval_height=64", "data.eval_width=64", "data.n_test_views=3",
        "system.exporter.resolution=48"]


@pytest.fixture(scope="module")
def systems(tmp_path_factory):
    """Both packages' trainers on one config and the JAX init state in each
    package's form."""
    root = tmp_path_factory.mktemp("eval")
    jt = JaxTrainer(jax_load_config(JAX_CONFIG, OVERRIDES + EVAL + JAX_ONLY
                                    + [f"exp_root_dir={root / 'jax'}"]))
    pt = Trainer(load_config(PORT_CONFIG, OVERRIDES + EVAL + [f"exp_root_dir={root / 'port'}"]),
                 device="cpu")
    jstate = jt.system.init_state(jt.cfg.seed)
    pstate = SystemState(gauss=gaussian_state_from_numpy(jax.device_get(jstate.gauss),
                                                         device="cpu"))
    return jt, pt, jstate, pstate


def _cli(tmp_path, *flags, steps=2):
    return ["--config", PORT_CONFIG, *flags, "--device", "cpu", f"exp_root_dir={tmp_path}",
            f"trainer.max_steps={steps}", "data.eval_height=32", "data.eval_width=32",
            "data.n_test_views=2", "system.exporter.resolution=32",
            *[o for o in OVERRIDES if not o.startswith("trainer.max_steps")]]


# ---------------------------------------------------------------------------
# Eval renders and PNGs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("split", ["val", "test"])
def test_render_views_match_jax(systems, split):
    """comp_rgb to 1e-5 (the training renders' tolerance); radii, visibility
    and pair counts exact.  The vanilla renderer has no depth or opacity
    output."""
    jt, pt, jstate, pstate = systems
    views = getattr(pt.data, f"{split}_views")()
    want = jt.system.render_views(jstate, getattr(jt.data, f"{split}_views")())
    got = pt.system.render_views(pstate, views)
    assert len(got) == len(want) == len(views)
    for g, w in zip(got, want):
        assert g["comp_rgb"].shape == (1, 64, 64, 3)
        np.testing.assert_allclose(g["comp_rgb"], np.asarray(w["comp_rgb"]), rtol=0, atol=1e-5)
        for k in ("radii", "visibility_filter", "n_pairs", "n_dropped"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]), err_msg=k)
        assert g["comp_rgb"].std() > 0.01  # the Gaussians are in view


# (name, images): a plain RGB image; a grid of RGB beside a one-channel
# map, with values outside [0, 1] to clip; an RGBA image
PNG_CASES = {
    "rgb": lambda rng: [rng.uniform(size=(40, 56, 3))],
    "grid": lambda rng: [rng.uniform(-0.2, 1.2, size=(33, 17, 3)), rng.uniform(size=(33, 17))],
    "rgba": lambda rng: [rng.uniform(size=(24, 24, 4))],
}


@pytest.mark.parametrize("case", sorted(PNG_CASES))
def test_png_pixels_match_jax(tmp_path, case):
    """The same float images through both packages' save_image_grid (the
    JAX package writes with imageio, the port with its own encoder): the
    decoded pixels are equal."""
    images = [im.astype(np.float32) for im in PNG_CASES[case](np.random.default_rng(3))]
    jsaving.save_image_grid(str(tmp_path / "jax.png"), images)
    psaving.save_image_grid(str(tmp_path / "port.png"), images)
    want = imageio.imread(tmp_path / "jax.png")
    got = imageio.imread(tmp_path / "port.png")
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    # the port's own decoder (chip_smoke.py reads the test renders with it)
    np.testing.assert_array_equal(psaving.decode_png((tmp_path / "port.png").read_bytes()), want)


def test_validate_writes_the_render(systems):
    """Trainer.validate: one PNG per validation view, named it{step}-{i},
    holding the eval render's pixels."""
    _, pt, _, pstate = systems
    pt.state, pt.step = pstate, 5
    pt.validate()
    path = os.path.join(pt.save_dir, "save", "it5-0.png")
    render = pt.system.render_views(pstate, pt.data.val_views())[0]["comp_rgb"][0]
    np.testing.assert_array_equal(imageio.imread(path), psaving.to_uint8(render))


def test_img_sequence_without_imageio(tmp_path, monkeypatch, capsys):
    """Without imageio the frames stay and no video is written; with it, a
    video (a gif where imageio has no mp4 writer)."""
    for i in range(3):
        psaving.save_image_grid(str(tmp_path / "frames" / f"{i}.png"),
                                [np.full((8, 8, 3), i / 3.0, np.float32)])
    out = str(tmp_path / "seq.mp4")
    video = psaving.save_img_sequence(out, str(tmp_path / "frames"))
    assert video is not None and os.path.exists(video)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)  # import fails
    assert psaving.save_img_sequence(out, str(tmp_path / "frames")) is None
    assert "no video of the 3 frames" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# PLY, mesh, decimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sh_degree", [0, 1])
def test_ply_bytes_match_jax(tmp_path, sh_degree):
    """GaussianField.save_ply of one state in both packages: the files are
    byte-identical (alive rows only), and the port's ply_io reads them."""
    cfg = dict(init_num_pts=200, capacity=300, sh_degree=sh_degree)
    jstate = jgf.init_state(jgf.GaussianFieldConfig(**cfg), seed=4)
    rng = np.random.default_rng(4)
    rest = rng.normal(size=jstate.params.features_rest.shape).astype(np.float32)
    alive = np.asarray(jstate.alive).copy()
    alive[::7] = False
    jstate = jstate.replace(params=jstate.params.replace(features_rest=jax.numpy.asarray(rest)),
                            alive=jax.numpy.asarray(alive))
    pstate = gaussian_state_from_numpy(jax.device_get(jstate), device="cpu")
    jgf.GaussianField(jgf.GaussianFieldConfig(**cfg)).save_ply(jstate, str(tmp_path / "j.ply"))
    pgf.GaussianField(pgf.GaussianFieldConfig(**cfg), device="cpu").save_ply(
        pstate, str(tmp_path / "p.ply"))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    back = pply.load_gaussian_ply(str(tmp_path / "p.ply"), sh_degree)
    assert back["xyz"].shape[0] == int(alive.sum())
    np.testing.assert_array_equal(back["xyz"], to_numpy(pstate)["params"]["xyz"][alive])
    assert pply.attribute_names(sh_degree) == jply.attribute_names(sh_degree)


@pytest.fixture(scope="module")
def mesh_states():
    """A field of a few hundred fat, opaque Gaussians in a sphere."""
    cfg = jgf.GaussianFieldConfig(init_num_pts=300, capacity=400, pc_init_radius=0.5,
                                  opacity_init=0.9)
    jstate = jgf.init_state(cfg, seed=5)
    scaling = np.asarray(jstate.params.scaling) + np.log(2.5).astype(np.float32)
    jstate = jstate.replace(params=jstate.params.replace(scaling=jax.numpy.asarray(scaling)))
    return jstate, gaussian_state_from_numpy(jax.device_get(jstate), device="cpu")


def test_mesh_extract_matches_jax(mesh_states):
    """Vertices to 1e-5 (the covariances go through torch here and jnp
    there), faces exact."""
    jstate, pstate = mesh_states
    want_v, want_f = jmesh.extract_mesh_from_gaussians(jstate, resolution=48)
    got_v, got_f = pmesh.extract_mesh_from_gaussians(pstate, resolution=48)
    assert len(want_f) > 100
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-5)


def test_decimator_matches_jax(mesh_states, tmp_path):
    """The port builds the same decimate.cpp: on the same mesh the output is
    equal; a mesh under the target comes back unchanged."""
    verts, faces = jmesh.extract_mesh_from_gaussians(mesh_states[0], resolution=48)
    target = len(faces) // 3
    want_v, want_f = jax_decimate_mesh(verts, faces, target)
    got_v, got_f = decimate_mesh(verts, faces, target)
    assert 0 < len(got_f) <= target + 2
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_v, want_v)
    same_v, same_f = decimate_mesh(verts, faces, len(faces))
    np.testing.assert_array_equal(same_f, faces)


def test_exporter_writes_ply_and_decimated_obj(mesh_states, tmp_path):
    from threestudio_3dgs_tpu_torch.models.exporter import MeshExporter

    field = pgf.GaussianField(pgf.GaussianFieldConfig(capacity=400), device="cpu")
    out = MeshExporter({"resolution": 48, "decimate_target": 500}, geometry=field)(
        mesh_states[1], str(tmp_path))
    assert 0 < out["n_faces"] <= 502
    lines = open(out["obj"]).read().splitlines()
    assert sum(line.startswith("f ") for line in lines) == out["n_faces"]
    assert pply.read_ply_table(out["ply"])["x"].shape == (300,)


# ---------------------------------------------------------------------------
# Checkpoints, --resume and the launcher
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip(systems, tmp_path):
    _, _, _, pstate = systems
    path = str(tmp_path / "x.ckpt.npz")
    save_checkpoint(path, pstate, 7)
    state, step = load_checkpoint(path, device="cpu")
    assert step == 7
    assert state.extra_params == {} and state.extra_opt is None
    state = state.gauss
    want, got = to_numpy(pstate.gauss), to_numpy(state)
    for group in ("params",):
        for k, v in want[group].items():
            np.testing.assert_array_equal(got[group][k], v)
    for m in ("mu", "nu"):
        for k, v in want["adam"][m].items():
            np.testing.assert_array_equal(got["adam"][m][k], v)
    assert got["adam"]["count"] == want["adam"]["count"]
    for k in ("alive",) + pgf.STAT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k])
    assert state.alive.dtype == torch.bool


def test_resume_continues_at_saved_step(tmp_path):
    first = launch.main(_cli(tmp_path / "a", "--train", steps=2))
    ckpt = os.path.join(first.save_dir, "ckpts", "last.ckpt.npz")
    resumed = launch.main(_cli(tmp_path / "b", "--train", "--resume", ckpt, steps=4))
    assert [row["step"] for row in resumed.metrics_log] == [3, 4]
    assert resumed.step == 4
    assert resumed.state.gauss.adam.count == 4  # two steps on the saved moments
    assert os.path.exists(os.path.join(resumed.save_dir, "save", "it4-test", "1.png"))


@pytest.mark.parametrize("flag,expected", [
    ("--validate", "it0-0.png"),
    ("--test", os.path.join("it0-test", "1.png")),
    ("--predict", os.path.join("it0-test", "0.png")),
    ("--export", os.path.join("export", "model.obj")),
])
def test_launch_entry_points_on_fresh_init(tmp_path, flag, expected):
    """Without --resume each entry point works on a fresh init."""
    trainer = launch.main(_cli(tmp_path, flag))
    assert trainer.step == 0
    assert os.path.exists(os.path.join(trainer.save_dir, "save", expected))


def test_launch_validate_from_checkpoint(tmp_path):
    trained = launch.main(_cli(tmp_path / "a", "--train", steps=2))
    ckpt = os.path.join(trained.save_dir, "ckpts", "last.ckpt.npz")
    trainer = launch.main(_cli(tmp_path / "b", "--validate", "--resume", ckpt))
    assert trainer.step == 2
    np.testing.assert_array_equal(trainer.state.gauss.params.xyz.numpy(),
                                  trained.state.gauss.params.xyz.numpy())
    assert os.path.exists(os.path.join(trainer.save_dir, "save", "it2-0.png"))


def test_cli_train_and_export(tmp_path):
    """The launch CLI as a subprocess: --train (then the test renders and
    the PLY) and --export."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-m", "threestudio_3dgs_tpu_torch.launch",
         *_cli(tmp_path, "--train", "--export")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    for line in ("checkpoint ->", "test renders ->", "export ->"):
        assert line in res.stdout, line
    save = os.path.join(str(tmp_path), "gs-sds-generation")
    run_dirs = os.listdir(save)
    assert len(run_dirs) == 1
    out = os.path.join(save, run_dirs[0], "save")
    assert sorted(os.listdir(os.path.join(out, "it2-test"))) == ["0.png", "1.png"]
    assert os.path.exists(os.path.join(out, "point_cloud.ply"))
    assert os.path.exists(os.path.join(out, "export", "model.obj"))
