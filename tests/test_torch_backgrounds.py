"""The PVG and DeformableGS backgrounds (pvg.yaml, deformablegs.yaml)
against the JAX package: their modules on numpy draws, one training step
of each preset leaf by leaf on a small state made by the JAX package's own
synthetic set-up and carried across by convert.py, and one PVG refinement.

The JAX steps run its default path with `expand_gather_xla` in place of
its Pallas expansion kernel, as tests/test_torch_train.py explains, one
compile per background. PVG's temporal smoothing is compared at the
offset the JAX step draws (the two frameworks' random draws cannot
match). The PVG step's batch carries no lidar map: the JAX package's
inverse-depth loss gives the rendered depth a NaN gradient wherever a
pixel has no hit (ROADMAP.md, faults in the reference), so the
inverse-depth form is compared on its own, where that gradient is finite.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.data import synthetic as jsynthetic
from bilateral_driving_tpu.scene import deformable as jdeformable
from bilateral_driving_tpu.scene import pvg as jpvg
from bilateral_driving_tpu.tools import common as jcommon
from bilateral_driving_tpu.train import density as jdensity
from bilateral_driving_tpu.train import losses as jlosses
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.data.scene import _pixel_viewdirs
from bilateral_driving_tpu_torch.models import deform
from bilateral_driving_tpu_torch.scene import deformable, pvg
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.train import losses, trainer
from bilateral_driving_tpu_torch.utils import config, trajectory

from test_torch_smpl_train import _torch_batch
from test_torch_train import _jax_reference_path, _rel
from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
W, H, FRAMES, R = 96, 64, 4, 16
CAP = 2 ** 14
STEP = 3399
GRAD_RTOL = 2e-4          # per leaf, as tests/test_torch_train.py
SEED = 1                  # the states' perturbations and targets
FWD_ATOL = 1e-5           # module values, as tests/test_torch_appearance.py


def _t(x):
    return torch.from_numpy(np.array(x))


def _vjp_both(jfn, tfn, args, seed=0):
    """Values and the VJP of a random cotangent of a JAX function (one
    compile) and its port on the same float32 arrays."""
    rng = np.random.default_rng(seed)
    jargs = [jnp.asarray(a) for a in args]
    shape = jax.eval_shape(jfn, *jargs).shape
    ct = rng.normal(size=shape).astype(np.float32)

    @jax.jit
    def both(jargs, ct):
        out, vjp = jax.vjp(jfn, *jargs)
        return out, vjp(ct)

    jout, jgrads = both(jargs, jnp.asarray(ct))
    targs = [_t(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    tgrads = torch.autograd.grad(tout, targs, _t(ct))
    return (np.asarray(jout), tout.detach().numpy(),
            [np.asarray(g) for g in jgrads], [g.numpy() for g in tgrads])


def _pvg_params(n, rng):
    return {
        "means": rng.normal(0, 3, (n, 3)), "log_scales": rng.normal(-2, .5,
                                                                    (n, 3)),
        "quats": rng.normal(size=(n, 4)),
        "logit_opacities": rng.normal(0, 1, (n, 1)),
        "sh_dc": rng.normal(size=(n, 1, 3)),
        "sh_rest": rng.normal(0, .1, (n, 15, 3)),
        "taus": rng.normal(0, .5, n), "log_betas": rng.normal(-1.2, .3, n),
        "velocity": rng.normal(0, .5, (n, 3))}


def test_pvg_modules_match_jax():
    """gaussians (with a smoothing offset), its gradients into taus, betas
    and velocity, and velocity_reg_loss's safe norm at v = 0."""
    rng = np.random.default_rng(0)
    n = 200
    p = {k: v.astype(np.float32) for k, v in _pvg_params(n, rng).items()}
    p["velocity"][:20] = 0.0
    mask = (rng.random(n) < 0.9).astype(np.float32)
    radii = rng.integers(0, 3, n).astype(np.int32)
    cam = np.array([0.3, -0.2, 1.0], np.float32)
    keys = ("means", "taus", "log_betas", "velocity", "logit_opacities")
    jcfg, tcfg = jpvg.PVGConfig(cycle=0.2), pvg.PVGConfig(cycle=0.2)

    def jfn(*a):
        q = {**p, **dict(zip(keys, a))}
        b = jpvg.gaussians(q, jnp.asarray(mask), jnp.asarray(cam), 2500,
                           0.021, jcfg, smooth_delta_t=-0.004)
        return jnp.concatenate([b.means, b.opacities[:, None], b.rgbs], 1)

    def tfn(*a):
        q = {**{k: _t(v) for k, v in p.items()}, **dict(zip(keys, a))}
        b = pvg.gaussians(q, _t(mask), _t(cam), 2500, 0.021, tcfg,
                          smooth_delta_t=-0.004)
        return torch.cat([b.means, b.opacities[:, None], b.rgbs], 1)

    jo, to, jg, tg = _vjp_both(jfn, tfn, [p[k] for k in keys])
    np.testing.assert_allclose(to, jo, atol=FWD_ATOL)
    for k, a, b in zip(keys, tg, jg):
        assert np.any(b), k
        assert _rel(a, b) < 1e-5, k
    # some slots fall outside the marginal-visibility window
    marg = np.exp(-0.5 * (p["taus"] - 0.021) ** 2
                  / np.exp(p["log_betas"]) ** 2)
    assert (marg < 0.05).any() and (marg > 0.05).any()

    jo, to, jg, tg = _vjp_both(
        lambda v: jpvg.velocity_reg_loss({**p, "velocity": v},
                                         jnp.asarray(mask),
                                         jnp.asarray(radii), 0.001, jcfg),
        lambda v: pvg.velocity_reg_loss(
            {**{k: _t(x) for k, x in p.items()}, "velocity": v}, _t(mask),
            _t(radii), 0.001, tcfg), [p["velocity"]])
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    assert np.isfinite(tg[0]).all() and _rel(tg[0], jg[0]) < 1e-5

    # init_extras: taus scaled, the reference's log(sqrt(betas_init))
    t_init = rng.random(50).astype(np.float32)
    je = jpvg.init_extras(None, 64, 50, jnp.asarray(t_init), 0.1, 0.06)
    te = pvg.init_extras(64, 50, _t(t_init), 0.1, 0.06, "cpu")
    for k in je:
        np.testing.assert_array_equal(te[k].numpy(), np.asarray(je[k]), k)


def test_deformgs_modules_match_jax():
    """contract and deformgs_gaussians through a 4 x 64 network (its
    parameters carried by convert.deform_net_from_jax; the steps below run
    the presets' 8 x 256)."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1.5, (300, 3)).astype(np.float32)
    np.testing.assert_allclose(
        deformable.contract(_t(x)).numpy(),
        np.asarray(jdeformable.contract(jnp.asarray(x))), atol=1e-7)
    assert deformable.linear_noise(500, 0.1, 1000) == pytest.approx(
        float(jdeformable.linear_noise(500, 0.1, 1000)))
    n = 150
    p = {k: v.astype(np.float32) for k, v in _pvg_params(n, rng).items()
         if k not in ("taus", "log_betas", "velocity")}
    jnet = jax.tree.map(np.asarray, jdeformable.deform.init_deform(
        jax.random.key(3), depth=4, width=64))
    tnet = convert.deform_net_from_jax(jnet, "cpu").requires_grad_(True)
    assert isinstance(tnet, deform.DeformNetwork)
    mask = (rng.random(n) < 0.9).astype(np.float32)
    cam = np.array([0.1, 0.0, -1.0], np.float32)
    center = np.array([0.5, 0.0, 1.0], np.float32)
    keys = ("means", "log_scales", "quats", "logit_opacities")

    def jfn(*a):
        q = {**p, **dict(zip(keys, a))}
        b = jdeformable.deformgs_gaussians(
            q, jnet, jnp.asarray(mask), jnp.asarray(cam), 1500, 0.4,
            jnp.asarray(center), jnp.asarray(2.0))
        return jnp.concatenate([b.means, b.scales, b.quats,
                                b.opacities[:, None], b.rgbs], 1)

    def tfn(*a):
        q = {**{k: _t(v) for k, v in p.items()}, **dict(zip(keys, a))}
        b = deformable.deformgs_gaussians(
            q, tnet, _t(mask), _t(cam), 1500, 0.4, _t(center),
            torch.tensor(2.0))
        return torch.cat([b.means, b.scales, b.quats, b.opacities[:, None],
                          b.rgbs], 1)

    jo, to, jg, tg = _vjp_both(jfn, tfn, [p[k] for k in keys])
    np.testing.assert_allclose(to, jo, atol=FWD_ATOL, rtol=1e-5)
    for k, a, b in zip(keys, tg, jg):
        assert _rel(a, b) < 1e-5, k


def test_losses_match_jax():
    """opacity_entropy, inverse_depth_smoothness and the inverse-depth
    depth loss reduced over the image (pvg.yaml), values and gradients; the
    depth gradient where the JAX package's is finite (the pixels it keeps),
    and 0 where it is NaN."""
    rng = np.random.default_rng(2)
    op = rng.uniform(0, 1, (37, 53)).astype(np.float32)
    op[::7] = 1.0
    img = rng.uniform(0, 1, (37, 53, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 60, (37, 53)).astype(np.float32)
    depth[::5, ::3] = 0.0                       # nothing rendered
    lidar = np.where(rng.random((37, 53)) < 0.3,
                     rng.uniform(0, 100, (37, 53)), 0).astype(np.float32)
    hit = (lidar > 0).astype(np.float32)
    for jf, tf, x in (
            (jlosses.opacity_entropy, losses.opacity_entropy, op),
            (lambda d: jlosses.inverse_depth_smoothness(
                1.0 / (d + 1e-5), jnp.asarray(img)),
             lambda d: losses.inverse_depth_smoothness(1.0 / (d + 1e-5),
                                                       _t(img)), depth)):
        jo, to, jg, tg = _vjp_both(jf, tf, [x])
        np.testing.assert_allclose(to, jo, rtol=1e-5)
        assert _rel(tg[0], jg[0]) < 1e-5
    for kw in ({"loss_type": "l1", "normalize": False,
                "use_inverse_depth": True, "reduction": "mean_on_hw"},
               {"loss_type": "l2", "normalize": True,
                "use_inverse_depth": True, "reduction": "mean_on_hit"},
               {"loss_type": "smooth_l1", "normalize": False,
                "use_inverse_depth": False, "reduction": "sum"}):
        jv, jgr = jax.value_and_grad(lambda d: jlosses.depth_loss(
            d, jnp.asarray(lidar), jnp.asarray(hit), **kw))(
                jnp.asarray(depth))
        td = _t(depth).requires_grad_(True)
        tv = losses.depth_loss(td, _t(lidar), _t(hit), **kw)
        (tgr,) = torch.autograd.grad(tv, td)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
        jgr, tgr = np.asarray(jgr), tgr.numpy()
        fin = np.isfinite(jgr)
        assert np.isfinite(tgr).all() and np.any(tgr), kw
        np.testing.assert_allclose(tgr[fin], jgr[fin], rtol=1e-5,
                                   atol=1e-9)
        assert not np.any(tgr[~fin])
        if kw["use_inverse_depth"] and not kw["normalize"]:
            assert not fin.all()


def _refine_inputs(rng, cap=300, live=200):
    p = {k: v.astype(np.float32) for k, v in _pvg_params(cap, rng).items()}
    p["log_scales"] = np.log(rng.choice([0.002, 0.05, 0.9],
                                        (cap, 3))).astype(np.float32)
    p["log_betas"] = np.log(rng.choice([0.005, 0.3], cap)).astype(np.float32)
    alive = np.arange(cap) < live
    stats = jdensity.DensityStats(
        grad_norm=(rng.random(cap) < 0.2) * rng.uniform(0, 1e-3, cap),
        vis_count=rng.integers(1, 3, cap).astype(np.float32),
        max_radii=rng.uniform(0, 0.1, cap),
        t_grad=(rng.random(cap) < 0.2) * rng.uniform(0, 1e-2, cap))
    return p, alive, jdensity.DensityStats(
        *(np.asarray(x, np.float32) for x in stats))


def _rotmat(q):
    from bilateral_driving_tpu.core import transforms

    return transforms.quat_to_rotmat(q)


@functools.lru_cache(maxsize=None)
def _step(name):
    """One step of a preset's small state through both trainers (one JAX
    compile of compute_grads)."""
    cfg = jconfig.load_config(os.path.join(
        ROOT, "bilateral_driving_tpu", "configs", f"{name}.yaml"))
    cfg["data"] = jconfig.ConfigDict(
        {"width": W, "height": H, "num_frames": FRAMES, "num_bg": 300,
         "bg_capacity": 512})
    cfg["trainer"]["envlight_resolution"] = R
    tcfg, jsc, params, statics, aux, masks = jcommon.build_synthetic_scene(
        jax.random.key(0), cfg, interpret=True)
    smooth = name == "pvg"
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP,
                               pvg_smooth_probability=1.0)
    rng = np.random.default_rng(SEED)

    def perturb(path, x):
        x = np.asarray(x)
        key = jax.tree_util.keystr(path)
        if x.dtype != np.float32 or "deform_net" in key or "'means'" in key:
            return x
        sd = {"CamPose": 0.01, "sh_rest": 0.05, "taus": 0.03,
              "velocity": 0.3}.get(next((k for k in (
                  "CamPose", "sh_rest", "taus", "velocity") if k in key),
                  ""), 0.1)
        return (x + rng.normal(0, sd, x.shape)).astype(np.float32)

    # every learned array off its init: velocity and the affine codes and
    # poses start at zero
    params = jax.tree_util.tree_map_with_path(perturb, params)
    pcfg = common.trainer_config_from(
        config.wrap(configs.PRESETS[name]), tcfg.num_images,
        tcfg.num_frames, tcfg.scene_scale)
    pcfg = dataclasses.replace(pcfg, isect_capacity=CAP,
                               envlight_resolution=R,
                               pvg_smooth_probability=1.0)
    for f in dataclasses.fields(trainer.TrainerConfig):
        assert getattr(pcfg, f.name) == getattr(tcfg, f.name), f.name
    jstate = jtrainer.init_state(jax.random.key(1), tcfg,
                                 jax.tree.map(jnp.asarray, params), masks,
                                 aux)
    jstate = jstate.replace(step=jnp.asarray(STEP, jnp.int32))
    state = convert.train_state_from_jax(
        pcfg, params, aux, masks, jstate.stats, STEP, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tstatics = convert.tree_from_jax(statics, "cpu")
    pixels = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    sky = (rng.random((H, W)) < 0.3).astype(np.float32)
    depth = np.where(rng.random((H, W)) < 0.1, rng.uniform(3, 40, (H, W)),
                     0).astype(np.float32)
    jb = jsynthetic.make_batch(jsc, 1, jnp.asarray(pixels), jnp.asarray(sky),
                               jnp.asarray(depth))
    if smooth:
        del jb["lidar_depth_map"]

    # a novel view (PVG only): a front_center_interp pose, the sky from
    # its own view directions
    traj = trajectory.get_novel_trajectory(
        {0: np.asarray(jsc.cameras)}, "front_center_interp", 7)
    nb = dict(jb)
    nb["camera_to_world"] = jnp.asarray(traj[3])
    nb["viewdirs"] = jnp.asarray(_pixel_viewdirs(
        H, W, np.asarray(jb["intrinsics"]), traj[3]))

    def jfn(st, b, nb):
        g = jtrainer.compute_grads(tcfg, statics, st, b)
        if not smooth:
            return g, None
        return g, jtrainer.forward(
            tcfg, st.params, jtrainer.merge_statics(statics, st.aux),
            st.masks, nb, st.step, novel_view=True, in_test_set=True)

    with _jax_reference_path():
        jg, jnovel = jax.jit(jfn)(jstate, jb, nb)
    novel = None
    if smooth:
        with torch.no_grad():
            novel = (jnovel, trainer.forward(
                pcfg, state.params, trainer.merge_statics(tstatics,
                                                          state.aux),
                state.masks, _torch_batch(nb), state.step, novel_view=True,
                in_test_set=True))
    offset = 0.0
    if smooth:
        # the offset the JAX step drew (train/trainer.py compute_grads)
        k1, k2 = jax.random.split(jax.random.fold_in(jstate.key, 17))
        bound = tcfg.pvg_distribution_span / max(tcfg.num_frames - 1, 1)
        offset = float(jax.random.uniform(k2, minval=-bound, maxval=bound))
        assert offset != 0.0
    tb = _torch_batch(jb)
    tg = trainer.compute_grads(pcfg, tstatics, state, tb,
                               time_offset=offset)
    state, tm = trainer.apply_grads_and_refine(pcfg, tstatics, state, tb,
                                               *tg)
    return dict(name=name, jg=jg, tg=tg, tm=tm, state=state, jsc=jsc,
                batch=jb, traj=traj, novel=novel)
