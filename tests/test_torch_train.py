"""The port's flagship training step against the JAX package's, through
bilateral_driving_tpu_torch/convert.py: one state of a small
omnire_ms_bilateral scene made by the JAX package's own scene set-up, one
plain step and one refining step, plus the losses, schedules and
refinement on their own.

The JAX side runs its default path, whose backward sums each Gaussian's
entries directly with the Pallas segment-sum kernel (interpret mode), with
one change: its Pallas expansion kernel, which returns wrong Gaussian ids
on this scene's sparse table (ROADMAP.md, faults found), is replaced by the
package's own XLA reference of that kernel, `expand_gather_xla` (the
kernel's fallback and test oracle). The XLA expansion path is no reference
for the gradients: its backward sums entries as differences of float32
prefix sums over the whole capacity, which loses the small gradients of
Gaussians late in the order.

Rules of comparison. Losses and metrics first. Gradients leaf by leaf, as
the norm of the difference against the norm of the JAX gradient. Parameter
deltas are compared only where the JAX gradient stands clear of rounding:
Adam's first update is about lr * sign(g), so where |g| is within rounding
of 0 the two frameworks may step in opposite directions.
"""
import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.data import synthetic as jsynthetic
from bilateral_driving_tpu.ops import expand_pallas, segsum_pallas
from bilateral_driving_tpu.tools import common
from bilateral_driving_tpu.train import density as jdensity
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu.utils import config as config_lib
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.train import trainer
from test_torch_threads import one_torch_thread  # noqa: F401

FLAGSHIP_YAML = os.path.join(os.path.dirname(__file__), "..",
                             "bilateral_driving_tpu", "configs",
                             "omnire_ms_bilateral.yaml")
W, H, FRAMES, R = 96, 64, 4, 16
CAP = 2 ** 14
BG_CAP = 512
# the first step densifies nothing; the second refines: 3400 % 3000 = 400
# is past the 100-step gate, before stop_split_at and stop_screen_size_at
STEP = 3399
# per-leaf gradient tolerance (relative norm): the compositing gradients
# differ by up to 6e-5 between the frameworks (tests/test_torch_backward.py)
# and every leaf's gradient is a sum of them
GRAD_RTOL = 2e-4
# optax corrects Adam's bias in float32: 1 - 0.999 rounds to
# 1.3e-5 below 0.001, so its first step is lr (1 - 6.4e-6) where
# torch.optim.Adam's, corrected in float64, is lr
ADAM_RTOL = 2e-5


@contextlib.contextmanager
def _jax_reference_path():
    """The JAX package's default rasterization path with its expansion
    kernel replaced by expand_gather_xla; yields the list of shapes its
    Pallas segment sums were traced with."""
    traced = []
    pallas_sum = segsum_pallas.segment_sum

    def segment_sum(data, offsets, **kw):
        traced.append(tuple(data.shape))
        return pallas_sum(data, offsets, **kw)

    def expand_gather(*args, interpret=False):
        return expand_pallas.expand_gather_xla(*args)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(expand_pallas, "expand_gather", expand_gather)
        mp.setattr(segsum_pallas, "segment_sum", segment_sum)
        yield traced


def _torch_batch(jb):
    out = {}
    for k, v in jb.items():
        v = np.array(v)
        out[k] = torch.from_numpy(v) if v.ndim else v.item()
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def run():
    """Two steps of both trainers from one converted state; the JAX steps
    are compiled once."""
    cfg = config_lib.load_config(FLAGSHIP_YAML)
    cfg["data"] = config_lib.ConfigDict(
        {"width": W, "height": H, "num_frames": FRAMES, "num_bg": 300,
         "bg_capacity": BG_CAP})
    cfg["trainer"]["envlight_resolution"] = R
    tcfg, jscene, params, statics, aux, masks = common.build_synthetic_scene(
        jax.random.key(0), cfg, interpret=True)
    tcfg = dataclasses.replace(tcfg, isect_capacity=CAP)
    rng = np.random.default_rng(0)

    def perturb(path, x):
        x = np.asarray(x)
        name = jax.tree_util.keystr(path)
        if (x.dtype != np.float32 or "deform_net" in name
                or "instances" in name or "'means'" in name):
            return x
        sd = 0.05 if "sh_rest" in name else 0.1
        return (x + rng.normal(0, sd, x.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    pcfg = configs.flagship_config(
        tcfg.num_images, tcfg.num_frames, isect_capacity=CAP,
        envlight_resolution=R, scene_scale=tcfg.scene_scale)

    jstate = jtrainer.init_state(jax.random.key(1), tcfg,
                                 jax.tree.map(jnp.asarray, params), masks,
                                 aux)
    jstate = jstate.replace(step=jnp.asarray(STEP, jnp.int32))
    state = convert.train_state_from_jax(
        pcfg, params, aux, masks, jstate.stats, STEP, device="cpu",
        generator=torch.Generator().manual_seed(0))
    tstatics = convert.tree_from_jax(statics, "cpu")

    # targets: an image, a sky mask and sparse lidar depths drawn from a seed
    batches = []
    for frame in (1, 2):
        pixels = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        sky = (rng.random((H, W)) < 0.3).astype(np.float32)
        depth = np.where(rng.random((H, W)) < 0.1,
                         rng.uniform(3, 40, (H, W)), 0).astype(np.float32)
        batches.append(jsynthetic.make_batch(
            jscene, frame, jnp.asarray(pixels), jnp.asarray(sky),
            jnp.asarray(depth)))

    grads_fn = jax.jit(lambda st, b: jtrainer.compute_grads(
        tcfg, statics, st, b))
    apply_fn = jax.jit(functools.partial(jtrainer.apply_grads_and_refine,
                                         tcfg, statics))
    steps, segsum_traced = [], []
    for jb in batches:
        before = {k: v.detach().clone()
                  for k, v in trainer.named_leaves(state.params)}
        with _jax_reference_path() as traced:
            jg = grads_fn(jstate, jb)
        # traced once, on the first call
        segsum_traced += traced
        tb = _torch_batch(jb)
        tg = trainer.compute_grads(pcfg, tstatics, state, tb)
        jstate, jm = apply_fn(jstate, jb, *jg)
        state, tm = trainer.apply_grads_and_refine(pcfg, tstatics, state, tb,
                                                   *tg)
        steps.append(dict(jg=jg, tg=tg, jm=jm, tm=tm, before=before,
                          jstate=jstate,
                          after={k: v.detach().clone() for k, v in
                                 trainer.named_leaves(state.params)},
                          masks={k: v.clone() for k, v in state.masks.items()},
                          stats=dict(state.stats)))
        # start the next step from the JAX parameters: where a gradient is
        # within rounding of 0 the two first updates differ by 2 lr, which
        # would move tile spans and intersection counts apart
        jparams = dict(trainer.named_leaves(convert.tree_from_jax(
            jax.tree.map(np.asarray, jstate.params), "cpu")))
        with torch.no_grad():
            for k, p in trainer.named_leaves(state.params):
                p.copy_(jparams[k])
    return dict(steps=steps, state=state, pcfg=pcfg, tstatics=tstatics,
                batches=batches, segsum_traced=segsum_traced)


def _jax_grads_by_path(g_params):
    """The JAX gradient tree keyed like trainer.named_leaves (a
    deformation network's (in, out) matrices become its (out, in)
    weights)."""
    tree = convert.tree_from_jax(jax.tree.map(np.asarray, g_params), "cpu")
    return {k: v.detach().numpy()
            for k, v in trainer.named_leaves(tree)}


def test_losses_and_metrics_match_jax(run):
    for i, s in enumerate(run["steps"]):
        jtotal, jloss = s["jg"][0], s["jg"][1]
        ttotal, tloss = s["tg"][0], s["tg"][1]
        assert set(tloss) == set(jloss), i
        for k in jloss:
            np.testing.assert_allclose(float(tloss[k]), float(jloss[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)
        jm, tm = s["jm"], s["tm"]
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7,
                                       err_msg=f"step {i}: {k}")
        assert float(tm["nonfinite_params"]) == 0
        assert float(tm["loss/depth"]) > 0 and float(tm["loss/sky_opacity"]) > 0


def test_reference_sums_segments_directly(run):
    """The JAX steps' backward went through the Pallas segment sums (the
    stacked (16, cap) layout), not the XLA path's prefix sums."""
    assert run["segsum_traced"]
    assert all(s == (16, CAP) for s in run["segsum_traced"])


def test_gradients_match_jax_leaf_by_leaf(run):
    for s in run["steps"]:
        want = _jax_grads_by_path(s["jg"][3])
        got = {k: v.numpy() for k, v in s["tg"][3].items()}
        assert set(got) == set(want)
        rel = {k: _rel(got[k], want[k]) for k in want}
        worst = max(rel, key=rel.get)
        assert rel[worst] < GRAD_RTOL, (worst, rel[worst])
        # the per-Gaussian screen-space gradient of the statistics
        assert _rel(s["tg"][4].numpy(), np.asarray(s["jg"][4])) < GRAD_RTOL


def test_first_update_follows_the_optimizers_own_count(run):
    """A state at step 3399 with fresh Adam moments takes its first update
    at the schedules' count 0: the warm-up group (affine, 1000 steps) does
    not move, and every other leaf moves by lr * sign(g) where g is clear
    of rounding, as in the JAX package."""
    s = run["steps"][0]
    want_g = _jax_grads_by_path(s["jg"][3])
    got_g = {k: v.numpy() for k, v in s["tg"][3].items()}
    jafter = dict(trainer.named_leaves(convert.tree_from_jax(
        jax.tree.map(np.asarray, s["jstate"].params), "cpu")))
    compared = 0
    for k, p0 in s["before"].items():
        p0 = p0.numpy()
        d_port = s["after"][k].numpy() - p0
        d_jax = jafter[k].detach().numpy() - p0
        if k.startswith("Affine/"):
            assert np.all(d_port == 0) and np.all(d_jax == 0), k
            continue
        g = want_g[k]
        noise = np.abs(got_g[k] - g).max()
        clear = np.abs(g) > 100 * noise + 1e-30
        ulp = np.spacing(np.maximum(np.abs(p0), np.abs(p0 + d_jax)))
        tol = 2 * ulp + ADAM_RTOL * np.abs(d_jax)
        assert np.all(np.abs(d_port - d_jax)[clear] <= tol[clear]), k
        compared += int(clear.sum())
    assert compared > 10000


def test_density_statistics_match_jax(run):
    s = run["steps"][0]
    for name, st in s["stats"].items():
        js = s["jstate"].stats[name]
        np.testing.assert_array_equal(st.vis_count.numpy(),
                                      np.asarray(js.vis_count))
        # radius / image size: XLA divides by multiplying with the
        # reciprocal, one rounding more
        np.testing.assert_allclose(st.max_radii.numpy(),
                                   np.asarray(js.max_radii), rtol=2.5e-7)
        assert _rel(st.grad_norm.numpy(), np.asarray(js.grad_norm)) \
            < GRAD_RTOL, name


def test_refining_step_matches_jax(run):
    """The second step refines: the same slots stay alive, the same number
    are dropped for want of capacity, the statistics restart from zero and
    the Adam moments of every slot that took a child are zero."""
    s = run["steps"][1]
    assert float(s["tm"]["refine_dropped"]) == float(s["jm"]["refine_dropped"])
    grown = 0
    for name, m in s["masks"].items():
        jm = np.asarray(s["jstate"].masks[name])
        np.testing.assert_array_equal(m.numpy().astype(bool), jm, name)
        before = run["steps"][0]["masks"][name].numpy().astype(bool)
        born = m.numpy().astype(bool) & ~before
        grown += int(born.sum())
        assert not s["stats"][name].vis_count.any()
        p = run["state"].params[name]["means"]
        st = run["state"].opt.state[p]
        if born.any():
            assert not st["exp_avg"][torch.from_numpy(born)].any()
    assert grown > 0


def _refine_inputs(step, seed=0, cap=256, live=180):
    """One class's parameters and statistics with points to split (large,
    high gradient), duplicate (small, high gradient) and cull (transparent
    or huge), more children than free slots, and an out-of-box cull."""
    rng = np.random.default_rng(seed)
    params = {
        "means": rng.normal(0, 2, (cap, 3)),
        "log_scales": np.log(rng.choice([0.001, 0.2, 0.9], (cap, 3))),
        "quats": rng.normal(size=(cap, 4)),
        "logit_opacities": rng.normal(0, 3, (cap, 1)),
        "sh_dc": rng.normal(size=(cap, 1, 3)),
        "sh_rest": rng.normal(size=(cap, 15, 3)),
        "instances_quats": rng.normal(size=(3, 2, 4)),
    }
    params = {k: v.astype(np.float32) for k, v in params.items()}
    aux = {"point_ids": rng.integers(0, 2, cap).astype(np.int32)}
    alive = np.arange(cap) < live
    stats = jdensity.DensityStats(
        grad_norm=(rng.random(cap) < 0.3) * rng.uniform(0, 0.01, cap),
        vis_count=rng.integers(0, 3, cap).astype(np.float32),
        max_radii=rng.uniform(0, 0.2, cap),
        t_grad=np.zeros(cap))
    stats = jdensity.DensityStats(*(np.asarray(x, np.float32) for x in stats))
    extra = rng.random(cap) < 0.05
    return params, aux, alive, stats, extra


def _rotmat(q):
    from bilateral_driving_tpu.core import transforms
    return transforms.quat_to_rotmat(q)


def _high_grad(stats, alive, cfg):
    avg = stats.grad_norm / np.maximum(stats.vis_count, 1.0)
    return (avg > cfg.densify_grad_thresh) & alive


def _densify(step, cfg):
    return (step < cfg.stop_split_at and step % cfg.reset_alpha_interval
            > max(4, cfg.refine_interval) and step > cfg.warmup_steps)


def _split_parents(params, stats, alive, step, cfg):
    big = np.exp(params["log_scales"]).max(-1) > cfg.densify_size_thresh
    screen = (stats.max_radii > cfg.split_screen_size) & (
        step < cfg.stop_screen_size_at)
    sel = (big | screen) & _high_grad(stats, alive, cfg) & _densify(step, cfg)
    return list(np.flatnonzero(sel))


def _dup_parents(params, stats, alive, step, cfg):
    big = np.exp(params["log_scales"]).max(-1) > cfg.densify_size_thresh
    sel = ~big & _high_grad(stats, alive, cfg) & _densify(step, cfg)
    return list(np.flatnonzero(sel))


def test_parameter_groups_follow_the_jax_labels(run):
    groups = {g["label"]: len(g["params"])
              for g in run["state"].opt.param_groups}
    assert groups["means"] == 2 and groups["means_deform"] == 1
    assert groups["deform_net"] == 22 and groups["affine"] == 3
    assert groups["sky"] == 1 and groups["instance_embeds"] == 1
    labels = {trainer.label_for_path(p): p
              for p in dict(trainer.named_leaves(run["state"].params))}
    assert "other" not in labels
