"""The port's data-parallel layer on two gloo CPU ranks against the JAX
package's on two of the conftest's virtual devices; the multi-process
image draw; the grid slice's CPU gradient at 1 and 4 threads.

One spawn of two ranks (tests/torch_parallel_workers.py) serves the first
two tests. The JAX side runs its default path with the Pallas expansion
kernel replaced by `expand_gather_xla`, as tests/test_torch_train.py does
(the kernel is wrong on this sparse table, ROADMAP.md).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.data import synthetic as jsynthetic
from bilateral_driving_tpu.parallel import data_parallel as jdp
from bilateral_driving_tpu.parallel import distributed as jdist
from bilateral_driving_tpu.train import density as jdensity
from bilateral_driving_tpu.train import setup as jsetup
from bilateral_driving_tpu.train import trainer as jtrainer
from bilateral_driving_tpu_torch import convert
from bilateral_driving_tpu_torch.models import bilateral
from bilateral_driving_tpu_torch.parallel import data_parallel, distributed
from test_torch_eval import _port_config
from test_torch_threads import one_torch_thread  # noqa: F401
from test_torch_train import (GRAD_RTOL, _jax_grads_by_path,
                              _jax_reference_path, _rel, _torch_batch)
import torch_parallel_workers as workers

W = H = 32
N_IMAGES = 2


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX package's test_parallel scene (300 background Gaussians in
    512 slots, 32 x 32 images, no sky or appearance model) with random
    targets: the JAX data-parallel gradients on a 2-device mesh, and the
    port's two ranks on the converted state."""
    key = jax.random.key(0)
    jscene = jsynthetic.make_scene(key, num_bg=300, num_frames=8, width=W,
                                   height=H)
    jcfg = jtrainer.TrainerConfig(
        background_model="vanilla", sky_model="none", affine_model="none",
        isect_capacity=2 ** 12, interpret=True, num_images=8, num_frames=8,
        sh_degree=0, density=jdensity.DensityConfig(refine_interval=10000),
        scene_scale=5.0, w_depth=0.0)
    params = jsetup.build_models(key, jcfg)
    bg, masks = jsetup.build_background(key, 512, jscene.bg_means,
                                        jscene.bg_colors, sh_degree=0)
    # anisotropic Gaussians off their init (equal KNN scales leave the
    # quaternions without a gradient)
    rng = np.random.default_rng(0)
    params["Background"] = {k: (v + rng.normal(0, 0.3, v.shape).astype(
        np.float32)) if k in ("log_scales", "quats") else v
        for k, v in bg.items()}
    masks = {"Background": masks}
    aux, statics = {"Background": {}}, {"Background": {}}
    jstate = jtrainer.init_state(key, jcfg, params, masks, aux)
    jbatches = [jsynthetic.make_batch(jscene, f, jnp.asarray(
        rng.uniform(0, 1, (H, W, 3)).astype(np.float32)))
        for f in range(N_IMAGES)]

    mesh = jdp.make_mesh(N_IMAGES)
    stacked = jdp.shard_batch(jdp.stack_batches(jbatches), mesh)
    P = jax.sharding.PartitionSpec

    def probe(state, batch_slice):
        batch = jax.tree.map(lambda x: x[0], batch_slice)
        total, _, outputs, g, gd = jtrainer.compute_grads(
            jcfg, statics, state, batch)
        return (jax.lax.pmean(total, "data"), jax.lax.pmean(g, "data"),
                jax.lax.psum(gd, "data"),
                jax.lax.pmax(outputs["info"]["radii"], "data"))

    with _jax_reference_path():
        jtotal, jg, jgd, jradii = jax.jit(jdp.shard_map(
            probe, mesh=mesh, in_specs=(P(), P("data")),
            out_specs=(P(),) * 4, check_vma=False))(jstate, stacked)

    pcfg = _port_config(jcfg)
    state = convert.train_state_from_jax(
        pcfg, params, aux, masks, jstate.stats, 0, device="cpu")
    case = {"cfg": pcfg, "params": state.params, "masks": state.masks,
            "aux": state.aux, "step": 0,
            "statics": convert.tree_from_jax(statics, "cpu"),
            "batches": [_torch_batch(b) for b in jbatches]}
    tmp = tmp_path_factory.mktemp("data_parallel")
    torch.save(case, tmp / "case.pt")
    ranks = workers.spawn(workers.data_parallel_case, N_IMAGES, tmp,
                          str(tmp / "case.pt"))
    return {"ranks": ranks, "jtotal": jtotal, "jg": jg, "jgd": jgd,
            "jradii": jradii}


def test_parallel_step_is_the_mean_of_image_grads(spawned):
    """The reduced gradient is the mean of the per-image gradients (the
    JAX package's tests/test_parallel.py property, atol 1e-5), the same
    on both ranks; after two parallel steps both ranks hold the same
    parameter bits."""
    r0, r1 = spawned["ranks"]
    for k, g in r0["grads"].items():
        mean = sum(x[k] for x in r0["image_grads"]) / N_IMAGES
        np.testing.assert_allclose(g.numpy(), mean.numpy(), atol=1e-5,
                                   err_msg=k)
        assert torch.equal(g, r1["grads"][k]), k
    assert any(bool(g.any()) for g in r0["grads"].values())
    assert r0["digests"] == r1["digests"]
    assert r0["metrics"] == r1["metrics"]
    for m in r0["metrics"]:
        assert np.isfinite(m["loss"]) and m["nonfinite_params"] == 0


def test_parallel_grads_match_jax(spawned):
    """The port's reduced gradients (mean), screen gradients (sum) and
    radii (max) against the JAX package's pmean / psum / pmax over a
    2-device data mesh, every leaf within the training tests' 2e-4."""
    r0 = spawned["ranks"][0]
    want = _jax_grads_by_path(spawned["jg"])
    got = {k: v.numpy() for k, v in r0["grads"].items()}
    assert set(got) == set(want)
    rel = {k: _rel(got[k], want[k]) for k in want}
    worst = max(rel, key=rel.get)
    assert rel[worst] < GRAD_RTOL, (worst, rel[worst])
    assert _rel(r0["dummy"].numpy(), np.asarray(spawned["jgd"])) < GRAD_RTOL
    np.testing.assert_array_equal(r0["radii"].numpy(),
                                  np.asarray(spawned["jradii"]))
    np.testing.assert_allclose(float(r0["total"]),
                               float(spawned["jtotal"]), rtol=1e-5)


def test_process_train_indices_match_jax():
    """Every rank of an 8-rank run draws its row of the JAX package's
    global choice (8 virtual devices in one process there)."""
    jmesh = jdist.global_mesh()
    assert jmesh.size == 8
    for n_images, seed, step in ((40, 0, 0), (40, 3, 17), (5, 1, 2)):
        idx = np.arange(100, 100 + n_images)
        want = jdist.process_train_indices(idx, seed, step, jmesh)
        got = [distributed.process_train_indices(
            idx, seed, step, data_parallel.Mesh(None, 8, r,
                                                torch.device("cpu")))
            for r in range(8)]
        np.testing.assert_array_equal(np.concatenate(got), want)


def test_grid_slice_gradient_ignores_thread_count():
    """The single grid's trilinear slice on the CPU: its gradient has the
    same bits at 1 and 4 torch threads (its gather is
    core.indexing.take_rows, as the deformable nodes' embedding gather
    is), and equals a plain `table[idx]` gather's up to the order of its
    sums."""
    g = torch.Generator().manual_seed(0)
    grid = torch.randn((12, 8, 16, 16), generator=g)
    coords = torch.rand((32, 512, 3), generator=g) * 2 - 1
    w = torch.randn((32, 512, 12), generator=g)

    def grad(threads, fn):
        before = torch.get_num_threads()
        torch.set_num_threads(threads)
        try:
            vol = grid.clone().requires_grad_()
            return torch.autograd.grad((fn(vol, coords) * w).sum(), vol)[0]
        finally:
            torch.set_num_threads(before)

    def plain_slice(vol, c):
        real = bilateral.take_rows
        bilateral.take_rows = lambda table, idx: table[idx]
        try:
            return bilateral.grid_sample_3d(vol, c)
        finally:
            bilateral.take_rows = real

    one = grad(1, bilateral.grid_sample_3d)
    for _ in range(2):
        assert torch.equal(grad(4, bilateral.grid_sample_3d), one)
    np.testing.assert_allclose(one.numpy(), grad(4, plain_slice).numpy(),
                               rtol=1e-5, atol=1e-4)
