"""The port's appearance models and camera refinement against the JAX
package: the MLP and sinusoidal encoders, the affine codes, the 6D
rotation and the camera-pose deltas, the neural and multi-scale neural
bilateral grids, the CP-4D grid and the bilateral cycle loss. Parameters
are the JAX package's initialisers moved off their initial values with a
seeded numpy draw and carried across by bilateral_driving_tpu_torch/
convert.py; images are 3 of 24 x 16 px. Each function's values are held
within 1e-5 absolute, and its VJP (jax.vjp against torch.autograd, for a
seeded cotangent) within 1e-5 relative norm per parameter leaf and input.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.core import transforms as jtransforms
from bilateral_driving_tpu.models import affine as jaffine
from bilateral_driving_tpu.models import bilateral as jbilateral
from bilateral_driving_tpu.models import camera_opt as jcamera_opt
from bilateral_driving_tpu.models import encoders as jencoders
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.core import transforms
from bilateral_driving_tpu_torch.models import affine, bilateral, camera_opt
from bilateral_driving_tpu_torch.models import encoders
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import setup, trainer
from bilateral_driving_tpu_torch.utils import config

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_IMAGES, H, W = 3, 16, 24
ATOL = 1e-5
VJP_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _shapes(fn, *args, **kw):
    """The tree a JAX initialiser returns, its arrays as shapes (nothing is
    compiled or run)."""
    return jax.eval_shape(lambda k: fn(k, *args, **kw), jax.random.key(0))


def _drawn(tree, seed: int, sd: float = 0.3):
    """Numpy float32 normal draws in the shapes of a tree of shapes (its
    static leaves kept): parameters away from any initial value."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: rng.normal(0, sd, x.shape).astype(np.float32), tree)


def _parity(jf, tf, tree, *inputs, seed=0, vjp_rtol=VJP_RTOL):
    """jf(tree, *inputs) of the JAX package against tf of the port, the
    tree (numpy, JAX nesting) carried across by convert.tree_from_jax.
    Returns the port's output."""
    jtree = jax.tree.map(jnp.asarray, tree)
    jin = [jnp.asarray(x) for x in inputs]
    jout, vjp = jax.vjp(jax.jit(jf), jtree, *jin)
    ttree = convert.tree_from_jax(tree, "cpu")
    leaves = dict(trainer.named_leaves(ttree))
    for p in leaves.values():
        p.requires_grad_(True)
    tin = [_t(x).requires_grad_(True) for x in inputs]
    tout = tf(ttree, *tin)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=ATOL, rtol=0)
    ct = np.random.default_rng(seed).normal(
        size=np.shape(jout)).astype(np.float32)
    jg = vjp(jnp.asarray(ct))
    tg = torch.autograd.grad(tout, [*leaves.values(), *tin], _t(ct),
                             allow_unused=True)
    want = dict(trainer.named_leaves(convert.tree_from_jax(
        jax.tree.map(np.asarray, jg[0]), "cpu")))
    assert set(want) == set(leaves)
    got = dict(zip([*leaves, *range(len(tin))], tg))
    want.update({i: g for i, g in enumerate(jg[1:])})
    for k, g in got.items():
        w = np.asarray(want[k])
        g = np.zeros_like(w) if g is None else g.numpy()
        assert np.any(w), f"zero JAX gradient of {k}"
        assert _rel(g, w) < vjp_rtol, (k, _rel(g, w))
    return tout


def _images(seed: int):
    return np.random.default_rng(seed).uniform(
        0, 1, (H, W, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# encoders
# --------------------------------------------------------------------------


@pytest.mark.parametrize("skips", [(), (2,)])
def test_mlp_apply_matches_jax(skips):
    shapes = _shapes(jencoders.mlp_init, 5, 7, 4, 16, skips=skips)
    x = np.random.default_rng(1).normal(size=(6, 5)).astype(np.float32)
    # the port keeps skips out of the tree: the caller passes them
    tree = {"layers": _drawn(shapes["layers"], 0)}
    _parity(lambda p, x: jencoders.mlp_apply(
        {**p, "skips": jencoders.Static(skips)}, x),
        lambda p, x: encoders.mlp_apply(p, x, skips), tree, x)


def test_mlp_init_matches_jax_shapes_and_zeros():
    """The JAX package's layer shapes; Kaiming-uniform within 1/sqrt(in);
    zero_init_last zeroes the last layer, zero_init_all every layer."""
    g = torch.Generator().manual_seed(0)
    for kw in ({}, {"skips": (1, 2)}, {"zero_init_last": True},
               {"zero_init_all": True}):
        jp = _shapes(jencoders.mlp_init, 5, 12, 3, 8, **kw)
        tp = encoders.mlp_init(g, 5, 12, 3, 8, device="cpu", **kw)
        assert set(tp) == {"layers"}
        for i, (jl, tl) in enumerate(zip(jp["layers"], tp["layers"],
                                         strict=True)):
            zero = kw.get("zero_init_all") or (kw.get("zero_init_last")
                                               and i == 2)
            for k in ("w", "b"):
                assert tuple(tl[k].shape) == jl[k].shape, (kw, k)
                bound = 1.0 / np.sqrt(jl["w"].shape[0])
                assert float(tl[k].abs().max()) <= bound
                assert bool(tl[k].any()) != bool(zero), (kw, i, k)


@pytest.mark.parametrize("use_identity", [True, False])
def test_sinusoidal_encode_matches_jax(use_identity):
    x = np.random.default_rng(2).uniform(-1, 1, (5, 3)).astype(np.float32)
    out = _parity(lambda _, x: jencoders.sinusoidal_encode(
        x, 0, 4, use_identity),
        lambda _, x: encoders.sinusoidal_encode(x, 0, 4, use_identity),
        {}, x)
    assert out.shape[-1] == encoders.sinusoidal_dim(3, 0, 4, use_identity) \
        == jencoders.sinusoidal_dim(3, 0, 4, use_identity)
    same = encoders.sinusoidal_encode(_t(x), 2, 2)
    assert torch.equal(same, _t(x))


# --------------------------------------------------------------------------
# affine codes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["image", "mean", "pixel"])
def test_affine_mats_match_jax(mode):
    tree = _drawn(_shapes(jaffine.init_affine, N_IMAGES,
                          pixel_affine=mode == "pixel"), 3, sd=0.2)
    pix = np.random.default_rng(4).uniform(0, 1, (H, W, 2)).astype(
        np.float32)
    inputs = (pix,) if mode == "pixel" else ()
    mean = mode == "mean"
    mats = _parity(
        lambda p, *c: jaffine.affine_mats(p, 1, *c, use_mean_embedding=mean),
        lambda p, *c: affine.affine_mats(p, 1, *c, use_mean_embedding=mean),
        tree, *inputs)
    assert mats.shape == ((H, W, 3, 4) if mode == "pixel" else (3, 4))
    _parity(lambda p, *c: jaffine.identity_reg_loss(jaffine.affine_mats(
        p, 2, *c, use_mean_embedding=mean)),
        lambda p, *c: affine.identity_reg_loss(affine.affine_mats(
            p, 2, *c, use_mean_embedding=mean)), tree, *inputs)


def test_affine_init_is_the_identity():
    p = affine.init_affine(torch.Generator().manual_seed(0), N_IMAGES,
                           device="cpu")
    jp = _shapes(jaffine.init_affine, N_IMAGES)
    assert p["embedding"].shape == jp["embedding"].shape
    assert not p["embedding"].any()
    assert all(not layer[k].any() for layer in p["decoder"]["layers"]
               for k in ("w", "b"))
    assert torch.equal(affine.affine_mats(p, 0), torch.eye(3, 4))


# --------------------------------------------------------------------------
# camera refinement
# --------------------------------------------------------------------------


def test_rotation_6d_matches_jax():
    d6 = np.random.default_rng(5).normal(size=(7, 6)).astype(np.float32)
    rot = _parity(lambda _, d: jtransforms.rotation_6d_to_matrix(d),
                  lambda _, d: transforms.rotation_6d_to_matrix(d), {}, d6)
    eye = torch.eye(3).expand(7, 3, 3)
    torch.testing.assert_close(rot @ rot.transpose(-1, -2), eye)
    R = np.random.default_rng(6).normal(size=(2, 3, 3)).astype(np.float32)
    t = np.random.default_rng(7).normal(size=(2, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        transforms.se3_compose(_t(R), _t(t)).numpy(),
        np.asarray(jtransforms.se3_compose(jnp.asarray(R), jnp.asarray(t))))


def _c2w(seed: int):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=4).astype(np.float32)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.asarray(jtransforms.quat_to_rotmat(jnp.asarray(q)))
    c2w[:3, 3] = rng.uniform(-20, 20, 3)
    return c2w


def test_apply_camera_opt_matches_jax():
    tree = _drawn(_shapes(jcamera_opt.init_camera_opt, N_IMAGES), 8,
                  sd=0.1)
    _parity(lambda p, c: jcamera_opt.apply_camera_opt(p, c, 2),
            lambda p, c: camera_opt.apply_camera_opt(p, c, 2), tree,
            _c2w(9))


def test_zero_pose_embeddings_give_the_same_bits():
    c2w = _c2w(10)
    p = camera_opt.init_camera_opt(torch.Generator().manual_seed(0),
                                   N_IMAGES, device="cpu")
    assert not p["embeds"].any() and p["embeds"].shape == (N_IMAGES, 9)
    out = camera_opt.apply_camera_opt(p, _t(c2w), 1)
    np.testing.assert_array_equal(out.numpy(), c2w)
    jout = jcamera_opt.apply_camera_opt(
        jcamera_opt.init_camera_opt(jax.random.key(0), N_IMAGES),
        jnp.asarray(c2w), 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    # the perturbation model draws with std 0.01
    q = camera_opt.init_camera_opt(torch.Generator().manual_seed(0), 4000,
                                   std=0.01, device="cpu")["embeds"]
    assert abs(float(q.std()) - 0.01) < 5e-4


# --------------------------------------------------------------------------
# neural and CP-4D bilateral grids, the cycle loss
# --------------------------------------------------------------------------


NEIGHBOURS = [None, [0, 2]]


@pytest.mark.parametrize("nbrs", NEIGHBOURS, ids=["image", "neighbours"])
def test_neural_bilateral_matches_jax(nbrs):
    tree = _drawn(_shapes(jbilateral.init_neural_bilateral, N_IMAGES, 8, 6,
                          4, 8, 16), 11)
    jn = None if nbrs is None else jnp.asarray(nbrs)
    _parity(lambda p, rgb: jbilateral.neural_bilateral_affines(
        p, rgb, 1, neighbor_idx=jn),
        lambda p, rgb: bilateral.neural_bilateral_affines(
            p, rgb, 1, neighbor_idx=nbrs), tree, _images(12))


def test_neural_bilateral_tv_matches_jax():
    tree = {"grids": np.random.default_rng(13).normal(
        0, 0.3, (N_IMAGES, 8, 4, 6, 8)).astype(np.float32)}
    _parity(jbilateral.bilateral_tv_loss, bilateral.bilateral_tv_loss, tree)


@pytest.mark.parametrize("nbrs", NEIGHBOURS, ids=["image", "neighbours"])
def test_multiscale_neural_matches_jax(nbrs):
    tree = _drawn(_shapes(jbilateral.init_multiscale_neural, N_IMAGES,
                          hidden_dim=16), 14)
    jn = None if nbrs is None else jnp.asarray(nbrs)
    _parity(lambda p, rgb: jbilateral.multiscale_neural_affines(
        p, rgb, 2, neighbor_idx=jn),
        lambda p, rgb: bilateral.multiscale_neural_affines(
            p, rgb, 2, neighbor_idx=nbrs), tree, _images(15))
    tv_tree = {"levels": [{"grids": lv["grids"]} for lv in tree["levels"]]}
    _parity(jbilateral.multiscale_neural_tv_loss,
            bilateral.multiscale_tv_loss, tv_tree)


def test_neural_inits_match_jax():
    g = torch.Generator().manual_seed(0)
    p = bilateral.init_neural_bilateral(g, N_IMAGES, 8, 6, 4, 8, 16,
                                        device="cpu")
    jp = _shapes(jbilateral.init_neural_bilateral, N_IMAGES, 8, 6, 4, 8, 16)
    assert p["grids"].shape == jp["grids"].shape and not p["grids"].any()
    ms = bilateral.init_multiscale_neural(g, N_IMAGES, device="cpu")
    jms = _shapes(jbilateral.init_multiscale_neural, N_IMAGES)
    for head, jhead in [(p["head"], jp["head"])] + [
            (a["head"], b["head"]) for a, b in zip(ms["levels"],
                                                   jms["levels"])]:
        assert [tuple(layer["w"].shape) for layer in head["layers"]] == [
            layer["w"].shape for layer in jhead["layers"]]
        assert head["layers"][0]["w"].any()
        assert not head["layers"][-1]["w"].any()
    for a, b in zip(ms["levels"], jms["levels"], strict=True):
        assert a["grids"].shape == b["grids"].shape


def test_cp4d_matches_jax():
    tree = _drawn(_shapes(jbilateral.init_cp4d, rank=3, grid_x=6, grid_y=5,
                          grid_z=4, grid_w=3), 16, sd=0.5)
    rng = np.random.default_rng(17)
    # coordinates past both ends too: the clamp at the border
    xyz = rng.uniform(-1.2, 1.2, (H, W, 3)).astype(np.float32)
    _parity(lambda p, x, rgb: jbilateral.cp4d_affines(p, x, rgb),
            lambda p, x, rgb: bilateral.cp4d_affines(p, x, rgb), tree, xyz,
            _images(18))
    _parity(jbilateral.cp4d_tv_loss, bilateral.cp4d_tv_loss, tree)


def test_cp4d_init_is_the_identity():
    p = bilateral.init_cp4d(torch.Generator().manual_seed(0), device="cpu")
    jp = _shapes(jbilateral.init_cp4d)
    ident = torch.tensor([1.0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0])
    for k in ("fx", "fy", "fz", "fw"):
        assert p[k].shape == jp[k].shape
        # rank 0 carries the identity, the JAX package's closed form
        want = ident if k == "fw" else torch.ones(12)
        assert torch.equal(p[k][0], want.expand_as(p[k][0]))
        assert 5e-4 < float(p[k][1:].std()) < 2e-3
    zero = {k: torch.cat([v[:1], torch.zeros_like(v[1:])]) for k, v in
            p.items()}
    xyz = torch.rand((4, 5, 3)) * 2 - 1
    mats = bilateral.cp4d_affines(zero, xyz, torch.rand((4, 5, 3)))
    torch.testing.assert_close(mats, torch.eye(3, 4).expand(4, 5, 3, 4))


def test_inverse_loss_matches_jax():
    # grids near the identity, so the composed affine inverts well
    rng = np.random.default_rng(19)
    tree = jax.tree.map(
        lambda x: (np.asarray(x) + rng.normal(0, 0.05, x.shape)).astype(
            np.float32), jbilateral.init_multiscale(None, N_IMAGES))
    rgb, gt = _images(20), _images(21)

    def jf(p, rgb, gt):
        mats = jbilateral.multiscale_affines(p, rgb, 1)
        return jbilateral.inverse_loss(mats, gt, rgb)

    def tf(p, rgb, gt):
        mats = bilateral.multiscale_affines(p, rgb, 1)
        return bilateral.inverse_loss(mats, gt, rgb)

    _parity(jf, tf, tree, rgb, gt)


# --------------------------------------------------------------------------
# the models as the trainer builds them
# --------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["omnire"])
def test_build_models_matches_jax_structure(preset):
    """build_models gives every leaf the JAX package's setup gives, of the
    same shape, with CamPosePerturb drawn where asked."""
    from bilateral_driving_tpu.train import setup as jsetup
    from bilateral_driving_tpu.tools import common as jcommon
    from bilateral_driving_tpu.utils import config as jconfig

    over = ["trainer.envlight_resolution=8", "trainer.use_camera_perturb=true"]
    cfg = common.trainer_config_from(config.apply_dotlist(
        config.wrap(configs.PRESETS[preset]), over), N_IMAGES, 2, 1.0)
    jtree = jconfig.apply_dotlist(jconfig.load_config(os.path.join(
        ROOT, "bilateral_driving_tpu", "configs", f"{preset}.yaml")), over)
    jcfg = jcommon.trainer_config_from(jtree, N_IMAGES, 2, 1.0)
    got = setup.build_models(cfg, "cpu")
    want = _drawn(_shapes(jsetup.build_models, jcfg), 0)
    want = dict(trainer.named_leaves(convert.tree_from_jax(want, "cpu")))
    got = dict(trainer.named_leaves(got))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in want.items()}
    assert {trainer.label_for_path(k) for k in got} == {
        "sky", "affine", "camera_opt"}
    assert not got.get("CamPose/embeds", torch.zeros(1)).any()
    assert ("CamPose/embeds" in got) == (preset == "omnire")
    assert got["CamPosePerturb/embeds"].any()


def test_forward_refines_training_views_only():
    """trainer.forward on a tiny synthetic scene with both camera models:
    zero embeddings render the unrefined image bit for bit; moved ones
    change training views only, and the rendered loss reaches both pose
    tables through the view matrix and the SH camera origin."""
    from bilateral_driving_tpu_torch.data import synthetic

    g = torch.Generator().manual_seed(0)
    scene = synthetic.make_scene(
        g, num_bg=300, num_frames=12, num_cams=2, width=W, height=H,
        focal=20.0, num_rigid=1, rigid_pts=30, num_deformable=1,
        deformable_pts=30, device="cpu")
    tree = config.apply_dotlist(config.wrap(configs.PRESETS["omnire"]), [
        "trainer.use_smpl=false", "trainer.use_camera_perturb=true",
        "trainer.envlight_resolution=8", "render.isect_capacity=8192"])
    cfg = common.trainer_config_from(tree, 24, 12, 1.0)
    state, statics = synthetic.random_state(scene, cfg, g, 512, 10,
                                            device="cpu")
    full = trainer.merge_statics(statics, state.aux)
    views = {"train": synthetic.make_batch(scene, 2),
             "test": synthetic.make_batch(scene, 20)}
    poses = {k: state.params[k]["embeds"]
             for k in ("CamPose", "CamPosePerturb")}

    def render(batch, test=False):
        return trainer.forward(cfg, state.params, full, state.masks, batch,
                               10, in_test_set=test,
                               neighbor_idx=[18, 22] if test else None)

    with torch.no_grad():
        moved = {k: render(b, k == "test")["rgb"] for k, b in views.items()}
        for p in poses.values():
            p.zero_()
        still = {k: render(b, k == "test")["rgb"] for k, b in views.items()}
        off = trainer.forward(
            dataclasses.replace(cfg, use_camera_opt=False,
                                use_camera_perturb=False),
            state.params, full, state.masks, views["train"], 10)["rgb"]
    assert torch.equal(still["train"], off)
    assert not torch.equal(moved["train"], still["train"])
    assert torch.equal(moved["test"], still["test"])
    for p in poses.values():
        p.requires_grad_(True)
    loss = render(views["train"])["rgb"].square().mean()
    grads = torch.autograd.grad(loss, list(poses.values()))
    for name, gr in zip(poses, grads):
        assert gr[2].abs().sum() > 0, name
        assert not torch.cat([gr[:2], gr[3:]]).any(), name
