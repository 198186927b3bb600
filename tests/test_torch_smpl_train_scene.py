"""The proto_scene build with SMPL and the omnire_bilateral CLI on the CPU
(helpers in tests/test_torch_smpl_train.py). Split from that file: the
port's test files hold at most four tests each, bar one parametrized test or
tests that share a module fixture, so that pytest-xdist's count-ordered
queue (--dist loadfile) runs them after tests/test_parallel.py (README).
"""
import json
import os

import jax
import numpy as np

from bilateral_driving_tpu.data import scene as jscene
from bilateral_driving_tpu.scene import smpl_model as jsmpl_model
from bilateral_driving_tpu.tools import common as jcommon
from bilateral_driving_tpu.utils import config as jconfig
from bilateral_driving_tpu_torch import configs, convert
from bilateral_driving_tpu_torch.scene import smpl_model
from bilateral_driving_tpu_torch.tools import common
from bilateral_driving_tpu_torch.tools import train as train_cli
from bilateral_driving_tpu_torch.utils import config

from test_torch_smpl_train import BILATERAL_YAML, PACK, SCENE
from test_torch_threads import one_torch_thread  # noqa: F401


def test_real_scene_routes_the_pedestrian_to_smpl(monkeypatch):
    """build_real_scene with SMPL on and the synthetic body: the
    pedestrian becomes SMPLNodes (DeformableNodes is dropped, the scene
    having no other deformable instance), with the JAX package's poses,
    betas, validity and template (the port's synthetic body patched to the
    JAX package's); with SMPL off it stays in DeformableNodes."""
    over = [f"data.scene_dir={SCENE}", f"data.pixel_pack={PACK}",
            "data.cameras=[0,1]", "data.num_cams=2", "data.downscale=1",
            "background_init.capacity=1024",
            "background_init.num_lidar_samples=400",
            "background_init.num_near_pts=100",
            "background_init.num_far_pts=100", "smpl.model_path=synthetic"]
    jm = jsmpl_model.synthetic_model(jax.random.key(0), num_verts=256)
    monkeypatch.setattr(smpl_model, "synthetic_model",
                        lambda *a, **kw: convert.smpl_model_from_jax(jm,
                                                                     "cpu"))
    tree = config.apply_dotlist(config.wrap(configs.OMNIRE_BILATERAL_TREE),
                                over)
    tcfg, data, params, statics, aux, masks = common.build_real_scene(
        tree, 0, "cpu")
    assert tcfg.use_smpl and not tcfg.use_deformable
    assert set(masks) == {"Background", "RigidNodes", "SMPLNodes"}

    jtree = jconfig.apply_dotlist(jconfig.load_config(BILATERAL_YAML),
                                  [o for o in over if "pixel_pack" not in o])
    jdata = jscene.load_scene(SCENE, cameras=(0, 1))
    jtcfg = jcommon.trainer_config_from(jtree, jdata.num_images,
                                        jdata.num_frames,
                                        jdata.scene_radius())
    jp, js, ja, jmask = jcommon._smpl_from_scene(jax.random.key(0), jtree,
                                                 jdata, jtcfg)
    got, gstat = params["SMPLNodes"], statics["SMPLNodes"]
    eps = np.finfo(np.float32).eps
    # the root quats come from rotmat_to_quat (2 ulp, its rsqrt), the
    # body's da-pose from sin and cos
    for k in ("instances_quats", "smpl_quats"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jp[k]),
                                   atol=2 * eps, rtol=0, err_msg=k)
    np.testing.assert_array_equal(got["instances_trans"].numpy(),
                                  np.asarray(jp["instances_trans"]))
    np.testing.assert_array_equal(gstat["instances_fv"].numpy(),
                                  np.asarray(js["instances_fv"]))
    assert gstat["instances_fv"].numpy().sum() > 20
    assert int(masks["SMPLNodes"].sum()) == 256
    for f in ("j_canonical", "verts_canonical", "a0_inv"):
        np.testing.assert_allclose(getattr(gstat["template"], f).numpy(),
                                   np.asarray(getattr(js["template"], f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    np.testing.assert_array_equal(gstat["on_mesh_x"].numpy(),
                                  got["means"].detach().numpy())
    np.testing.assert_array_equal(aux["SMPLNodes"]["point_ids"].numpy(),
                                  np.asarray(ja["point_ids"]))
    for k in ("logit_opacities", "sh_rest", "log_scales"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, err_msg=k)
    same = [set(a) == set(b) for a, b in zip(
        gstat["nn_ind"].numpy().reshape(-1, 5),
        np.asarray(js["nn_ind"]).reshape(-1, 5))]
    assert np.mean(same) > 0.99

    off = config.apply_dotlist(tree, ["trainer.use_smpl=false"])
    tcfg, _, _, _, _, masks = common.build_real_scene(off, 0, "cpu")
    assert not tcfg.use_smpl and tcfg.use_deformable
    assert "SMPLNodes" not in masks


def test_cli_trains_omnire_bilateral(tmp_path):
    """A few CPU steps of tools.train with the omnire_bilateral preset and
    the synthetic body, a refine among them: SMPLNodes train, every loss
    is finite."""
    out = str(tmp_path)
    summ = train_cli.main([
        "--config", "omnire_bilateral", "--device", "cpu", "--output_root",
        out, "--run_name", "r", f"data.scene_dir={SCENE}",
        f"data.pixel_pack={PACK}", "data.cameras=[0,1]", "data.num_cams=2",
        "data.downscale=1", "data.test_image_stride=20",
        "trainer.envlight_resolution=16", "background_init.capacity=1024",
        "background_init.num_lidar_samples=400",
        "background_init.num_near_pts=100", "background_init.num_far_pts=100",
        "rigid_capacity=256", "render.isect_capacity=4096",
        "smpl.model_path=synthetic", "trainer.max_steps=4",
        "density.warmup_steps=1", "density.refine_interval=2",
        "res_schedule.downscale_times=0", "logging.log_every=1",
        "logging.metrics_flush_every=1"])
    assert summ["steps"] == 4
    assert summ["final_points"]["SMPLNodes"] == 256
    assert summ["nonfinite_params_max"] == 0
    with open(os.path.join(out, "r", "metrics.json")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    losses = [v for r in rows for k, v in r.items() if k.startswith("loss")]
    assert losses and all(np.isfinite(losses))
