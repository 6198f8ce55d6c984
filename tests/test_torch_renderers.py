"""The port's renderer variants (``-advanced``, ``-background``,
``-normal``, ``-shading``), the neural background, the point-light
material, ``ops/image.py`` and the systems' extra parameters against the
JAX package on the CPU.

Scenes: the shading YAML's system at 64^2, tile 16, B = 2, 300 Gaussians
in a sphere of radius 0.5 (opacity 0.8, so the middle of a view is opaque
and the normals' stop-gradient mask has both sides), the JAX package's
initial field and background MLP carried over with ``models/convert.py``.
The JAX renderer draws its per-view randomness from ``fold_in(key,
view_index)``; the same uniforms, recomputed here from that key, reach the
port through the test-only ``draws`` keyword.  Outputs are held to 2e-5
absolute, gradients (with respect to every Gaussian field and the
background MLP, through a random weighting of every output) to 1e-4
relative L2 per field."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from threestudio_3dgs_tpu.ops import image as jimage
from threestudio_3dgs_tpu.systems.base import to_device_batch
from threestudio_3dgs_tpu.utils.config import load_config as jax_load_config
from threestudio_3dgs_tpu.utils.registry import find as jfind

from threestudio_3dgs_tpu_torch.models.convert import extra_from_numpy, gaussian_state_from_numpy
from threestudio_3dgs_tpu_torch.ops import image as pimage
from threestudio_3dgs_tpu_torch.systems.base import SystemState, flatten_extra
from threestudio_3dgs_tpu_torch.utils.ckpt import load_checkpoint, save_checkpoint
from threestudio_3dgs_tpu_torch.utils.config import load_config
from threestudio_3dgs_tpu_torch.utils.registry import find as pfind

from test_torch_train import ROOT

JAX_SHADING = f"{ROOT}/threestudio_3dgs_tpu/configs/gaussian_splatting_shading.yaml"
PORT_SHADING = f"{ROOT}/threestudio_3dgs_tpu_torch/configs/gaussian_splatting_shading.yaml"
SCENE = [
    "data.width=64", "data.height=64", "data.batch_size=2",
    "system.geometry.init_num_pts=300", "system.geometry.capacity=400",
    "system.geometry.pc_init_radius=0.5", "system.geometry.opacity_init=0.8",
    "system.renderer.tile_size=16", "system.renderer.max_pairs=65536",
    "system.renderer.batched=false", "system.renderer.adaptive_max_pairs=false",
]
FIELDS = ("xyz", "features_dc", "scaling", "rotation", "opacity")
OUT_KEYS = ("comp_rgb", "comp_depth", "comp_mask", "comp_normal", "comp_rgb_bg")
OUT_ATOL = 2e-5
GRAD_REL = 1e-4


def rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@dataclasses.dataclass
class Pair:
    jsys: object
    psys: object
    jstate: object
    pstate: SystemState
    batch: dict


def make_pair(renderer_type, extra=()):
    """The shading YAML's system in both packages with ``renderer_type``,
    the JAX initial state in each package's form, and one training batch."""
    overrides = SCENE + [f"system.renderer_type={renderer_type}"] + list(extra)
    jcfg = jax_load_config(JAX_SHADING, overrides)
    pcfg = load_config(PORT_SHADING, overrides)
    jsys = jfind(jcfg.system_type)(jcfg.system)
    psys = pfind(pcfg.system_type)(pcfg.system, device="cpu")
    jstate = jsys.init_state(0)
    params, opt = extra_from_numpy(jax.device_get(jstate.extra_params),
                                   jax.device_get(jstate.extra_opt), device="cpu")
    pstate = SystemState(gauss=gaussian_state_from_numpy(jax.device_get(jstate.gauss), "cpu"),
                         extra_params=params, extra_opt=opt)
    batch = pfind(pcfg.data_type)(pcfg.data, seed=0).train_batch(0)
    return Pair(jsys, psys, jstate, pstate, batch)


def jax_view_draws(key, bs, with_background, soft_shading):
    """The uniforms the JAX renderer draws for each view from ``key``: its
    per-view key fold_in(key, i); the kernel background's inversion (split
    off first unless the background is neural); the neural background's
    augmentation (two from that key); the material's soft-shading ratio
    (split off that key) and its mode (two from what remains)."""
    u = lambda k: float(jax.random.uniform(k))  # noqa: E731
    out = []
    for i in range(bs):
        k = jax.random.fold_in(key, i)
        d = {}
        if not with_background:
            k, sub = jax.random.split(k)
            d["invert_bg"] = u(sub)
        k1, k2 = jax.random.split(k)
        d["bg_aug"] = (u(k1), u(k2))
        if soft_shading:
            k, sub = jax.random.split(k)
            d["soft"] = u(sub)
        m1, m2 = jax.random.split(k)
        d["mode"] = (u(m1), u(m2))
        out.append(d)
    return out


def render_both(pair, training, seed=0, ambient_only=False, **kw):
    """Both renderers on the pair's batch; returns (JAX outputs, JAX grads,
    port outputs, port grads), the grads of sum(w * output) over every
    output with weights drawn from ``seed``."""
    jr, pr = pair.jsys.renderer, pair.psys.renderer
    batch = pair.batch
    height, width = int(batch["height"]), int(batch["width"])
    key = jax.random.PRNGKey(seed + 100) if training else None
    rng = np.random.default_rng(seed)
    weights = {k: rng.normal(size=(2, height, width, 3 if k in ("comp_rgb", "comp_normal",
                                                                  "comp_rgb_bg") else 1))
               .astype(np.float32) for k in OUT_KEYS}
    jb = dict(to_device_batch(batch), height=height, width=width)

    def jax_loss(gp, bgp):
        gs = pair.jstate.gauss.replace(params=gp)
        out = jr.batch_forward(gs, jb, bg_params=bgp, key=key,
                               ambient_only=jnp.asarray(ambient_only), training=training, **kw)
        loss = sum(jnp.sum(out[k] * weights[k]) for k in OUT_KEYS if k in out)
        return loss, out

    (_, jout), (jg, jgb) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(
        pair.jstate.gauss.params, pair.jstate.extra_params.get("background"))
    # dead rows: the JAX gradient of a zero quaternion is NaN, the port's 0;
    # the optimiser masks them in both
    alive = np.asarray(pair.jstate.gauss.alive)
    jgrads = {f: np.asarray(getattr(jg, f))[alive] for f in FIELDS}
    jgrads.update({f"bg/{k}": np.asarray(v) for k, v in (jgb or {}).items()})

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in pair.pstate.gauss.params.as_dict().items()}
    bg = {k: v.detach().clone().requires_grad_(True)
          for k, v in pair.pstate.extra_params.get("background", {}).items()}
    from threestudio_3dgs_tpu_torch.models import gaussian_field as pgf

    gs = dataclasses.replace(pair.pstate.gauss, params=pgf.GaussianParams(**leaves))
    draws = None
    if training:
        draws = jax_view_draws(key, 2, pr.with_background,
                               bool(getattr(pr.material, "cfg", None)
                                    and getattr(pr.material.cfg, "soft_shading", False)))
    pout = pr.batch_forward(gs, batch, bg_params=bg or None, training=training,
                            ambient_only=ambient_only, draws=draws, **kw)
    loss = sum(torch.sum(pout[k] * torch.tensor(weights[k])) for k in OUT_KEYS if k in pout)
    inputs = [leaves[f] for f in FIELDS] + list(bg.values())
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    pgrads = {f: g[torch.tensor(alive)] for f, g in zip(FIELDS, grads[:len(FIELDS)])}
    pgrads.update({f"bg/{k}": g for k, g in zip(bg, grads[len(FIELDS):])})
    pgrads = {k: np.zeros_like(jgrads[k]) if g is None else g.numpy() for k, g in pgrads.items()}
    return jout, jgrads, pout, pgrads


def check_outputs_and_grads(jout, jgrads, pout, pgrads, expect_keys):
    assert sorted(k for k in OUT_KEYS if k in pout) == sorted(expect_keys)
    assert sorted(k for k in OUT_KEYS if k in jout) == sorted(expect_keys)
    for k in expect_keys:
        got, want = pout[k].detach().numpy(), np.asarray(jout[k])
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=OUT_ATOL, err_msg=k)
    assert set(pgrads) == set(jgrads)
    for k, want in jgrads.items():
        assert np.isfinite(pgrads[k]).all(), k
        if np.abs(want).max() == 0:
            assert np.abs(pgrads[k]).max() == 0, k
        else:
            assert rel_l2(pgrads[k], want) <= GRAD_REL, (k, rel_l2(pgrads[k], want))


VARIANTS = {
    "advanced": ("diff-gaussian-rasterizer-advanced", ("comp_rgb", "comp_depth", "comp_mask")),
    "background": ("diff-gaussian-rasterizer-background",
                   ("comp_rgb", "comp_depth", "comp_mask", "comp_rgb_bg")),
    "normal": ("diff-gaussian-rasterizer-normal",
               ("comp_rgb", "comp_depth", "comp_mask", "comp_normal")),
    "shading": ("diff-gaussian-rasterizer-shading", OUT_KEYS),
}


@pytest.fixture(scope="module")
def pairs():
    return {name: make_pair(rtype) for name, (rtype, _) in VARIANTS.items()}


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_renderer_variant_matches_jax(pairs, variant, training):
    """Each variant's outputs and gradients, with the JAX draws fed in when
    training (the YAML's random background augmentation and soft shading)
    and none at eval."""
    jout, jgrads, pout, pgrads = render_both(pairs[variant], training)
    check_outputs_and_grads(jout, jgrads, pout, pgrads, VARIANTS[variant][1])
    if variant in ("normal", "shading"):
        alpha = pout["comp_mask"].detach().numpy()
        assert (alpha > 0.99).any() and (alpha <= 0.99).any()  # both sides of the mask


@pytest.mark.parametrize("case", ["ambient_only", "ambient_ratio", "albedo", "textureless",
                                  "diffuse"])
def test_shading_options_match_jax(pairs, case):
    """The material's other inputs through the shading renderer: the
    warm-up (albedo while ambient_only), a fixed ambient ratio and each
    forced shading mode."""
    kw = {"ambient_only": case == "ambient_only"}
    if case == "ambient_ratio":
        kw["ambient_ratio"] = 0.3
    elif case != "ambient_only":
        kw["shading"] = case
    jout, jgrads, pout, pgrads = render_both(pairs["shading"], True, seed=3, **kw)
    check_outputs_and_grads(jout, jgrads, pout, pgrads, OUT_KEYS)


def test_material_random_modes_match_jax():
    """The training draw picks albedo, textureless or shaded per view; with
    textureless_prob 0.5 and four views under two keys all three occur, and
    each view matches the JAX renderer's."""
    pair = make_pair("diff-gaussian-rasterizer-shading",
                     ["system.material.textureless_prob=0.5", "data.batch_size=2"])
    modes = set()
    for seed in (0, 1):
        for d in jax_view_draws(jax.random.PRNGKey(seed + 100), 2, True, True):
            u1, u2 = d["mode"]
            modes.add("albedo" if u1 > 0.75 else "textureless" if u2 < 0.5 else "shaded")
        jout, jgrads, pout, pgrads = render_both(pair, True, seed=seed)
        check_outputs_and_grads(jout, jgrads, pout, pgrads, OUT_KEYS)
    assert modes == {"albedo", "textureless", "shaded"}


def test_neural_background_matches_jax():
    """The MLP on raw (unnormalised) ray directions, eval_color at eval,
    and the random augmentation with the JAX draws."""
    jbg = jfind("gaussian-mvdream-neural-environment-map-background")(
        {"random_aug": True, "random_aug_prob": 0.8})
    pbg = pfind("gaussian-mvdream-neural-environment-map-background")(
        {"random_aug": True, "random_aug_prob": 0.8})
    params = jax.device_get(jbg.init_params(jax.random.PRNGKey(4)))
    pparams = {k: torch.tensor(np.asarray(v)) for k, v in params.items()}
    dirs = np.random.default_rng(0).normal(size=(5, 7, 3)).astype(np.float32)
    want = np.asarray(jbg(params, jnp.asarray(dirs)))
    got = pbg(pparams, torch.tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        draws = {"bg_aug": (float(jax.random.uniform(k1)), float(jax.random.uniform(k2)))}
        want = np.asarray(jbg(params, jnp.asarray(dirs), key=key, training=True))
        got = pbg(pparams, torch.tensor(dirs), training=True, draws=draws).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    eval_bg = pfind("gaussian-mvdream-neural-environment-map-background")(
        {"eval_color": [0.1, 0.2, 0.3]})
    np.testing.assert_array_equal(eval_bg(pparams, torch.tensor(dirs))[2, 3].numpy(),
                                  np.float32([0.1, 0.2, 0.3]))
    # the port's own init: He-normal weights from a generator, zero biases
    own = pbg.init_params(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in params.items()}
    assert all(float(own[f"b{i}"].abs().max()) == 0 for i in range(3))


def test_depth_to_normal_matches_jax():
    xyz = np.random.default_rng(1).normal(size=(9, 11, 3)).astype(np.float32)
    want = np.asarray(jimage.depth_to_normal(jnp.asarray(xyz)))
    np.testing.assert_allclose(pimage.depth_to_normal(torch.tensor(xyz)).numpy(), want,
                               rtol=0, atol=1e-6)


def test_normalize_vec_matches_jax_with_finite_grads_at_zero():
    """Unit vectors where |v| > 0, zeros where v = 0, and gradients equal to
    the JAX package's: finite (zero) at the zero vectors."""
    v = np.random.default_rng(2).normal(size=(6, 3)).astype(np.float32)
    v[[1, 4]] = 0.0
    w = np.random.default_rng(3).normal(size=(6, 3)).astype(np.float32)
    want, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(jimage.normalize_vec(x) * w))(jnp.asarray(v))
    x = torch.tensor(v, requires_grad=True)
    out = pimage.normalize_vec(x)
    (out * torch.tensor(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jimage.normalize_vec(v)),
                               atol=1e-6)
    assert np.isfinite(x.grad.numpy()).all()
    np.testing.assert_array_equal(x.grad.numpy()[[1, 4]], 0.0)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-5)


def test_extra_params_init_lr_and_schedule(pairs):
    """init_state builds the background MLP with zeroed Adam moments; the
    shading YAML's optimizer.args.lr (0.01) wins over its
    params.background.lr (0.001), as in the JAX package; ambient_only is
    step < ambient_only_steps."""
    psys, jsys = pairs["shading"].psys, pairs["shading"].jsys
    state = psys.init_state(0)
    assert set(state.extra_params) == {"background"}
    flat = flatten_extra(state.extra_params)
    assert set(flat) == {f"background/{k}{i}" for k in "wb" for i in range(3)}
    assert state.extra_opt.count == 0 and all(float(m.abs().max()) == 0
                                              for m in state.extra_opt.mu.values())
    assert psys.extra_lr == float(jsys.extra_lr) == 0.01
    for step in (0, 1999, 2000):
        assert psys.sched_scalars(step)["ambient_only"] == bool(
            jsys.sched_scalars(step)["ambient_only"])
    solid = pfind("gaussian-splatting-system")(
        load_config(PORT_SHADING, SCENE + ["system.background_type=solid-color-background",
                                           "system.renderer_type=diff-gaussian-rasterizer"]
                    ).system, device="cpu")
    assert solid.init_state(0).extra_params == {} and solid.init_state(0).extra_opt is None


def test_checkpoint_carries_extra_params(pairs, tmp_path):
    """The background MLP and its Adam state survive save and load."""
    state = pairs["shading"].pstate
    state.extra_opt.count = 3
    path = str(tmp_path / "x.ckpt.npz")
    save_checkpoint(path, state, 5)
    loaded, step = load_checkpoint(path, device="cpu")
    assert step == 5 and loaded.extra_opt.count == 3
    for k, v in flatten_extra(state.extra_params).items():
        assert torch.equal(flatten_extra(loaded.extra_params)[k], v), k
        assert torch.equal(loaded.extra_opt.nu[k], state.extra_opt.nu[k]), k
    assert torch.equal(loaded.gauss.params.xyz, state.gauss.params.xyz)
    state.extra_opt.count = 0
