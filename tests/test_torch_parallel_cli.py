"""The training CLI's parallel flags and --project on the CPU (gloo ranks
started by the CLI itself, or processes of a multi-process run started
apart), and the two pipeline options of the band
path against the JAX package: the projection's fov_extent (with the
port's row_offset) and the per-intersection screen-gradient sink with
absgrad_from_sink."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bilateral_driving_tpu.ops import pipeline as jpipeline
from bilateral_driving_tpu.ops import projection as jprojection
from bilateral_driving_tpu_torch.ops import pipeline, projection
from bilateral_driving_tpu_torch.parallel import data_parallel, distributed
from bilateral_driving_tpu_torch.tools import train as train_cli
from test_torch_cli import TINY, _assert_same
from test_torch_pipeline import HEIGHT, WIDTH, _scene
from test_torch_threads import one_torch_thread  # noqa: F401
import torch_parallel_workers as workers

STEPS = 4
RUN = TINY + [f"trainer.max_steps={STEPS}", "density.warmup_steps=2",
              "density.refine_interval=3", "logging.ckpt_every=100",
              "logging.log_every=2", "logging.metrics_flush_every=2",
              "logging.vis_freq=0"]


def test_parallel_cli_ranks_end_equal(tmp_path):
    """`--data_parallel 2` and `--tile_parallel 2` on the fixture, each
    two gloo ranks started by the CLI, and two processes of a
    `--num_processes 2` run started apart: the run writes
    <root>/<project>/<run> (rank 1 under proc1), every rank ends with the
    same checkpoint bits and metrics, and a refine happened. The
    processes of the multi-process run each trained the images
    process_train_indices gave them (the images whose sampler error they
    recorded)."""
    for name in ("data_parallel", "tile_parallel", "num_processes"):
        argv = ["--device", "cpu", "--output_root", str(tmp_path),
                "--project", "p", "--run_name", name, *RUN]
        if name == "num_processes":
            workers.cli_processes(
                argv, 2, f"file://{tmp_path / 'rendezvous'}")
            with open(tmp_path / "p" / name / "train_summary.json") as f:
                summ = json.load(f)
        else:
            summ = train_cli.main([f"--{name}", "2", *argv])
        root = tmp_path / "p" / name
        assert not (tmp_path / name).exists()
        assert not (root / "rendezvous").exists()
        assert summ["parallel"] == {
            "ranks": 2, "rank": 0, "backend": "gloo",
            "data": 1 if name == "tile_parallel" else 2,
            "tile": 2 if name == "tile_parallel" else 1}
        assert [r["step"] for r in summ["refines"]] == [3]
        ckpts = [torch.load(d / "checkpoints" / f"checkpoint_{STEPS}.pt",
                            weights_only=False)
                 for d in (root, root / "proc1")]
        for k in ("params", "aux", "masks", "stats", "opt", "step",
                  "updates", "generator"):
            _assert_same(ckpts[0][k], ckpts[1][k], f"{name} {k}")
        errors = [c["extra"]["sampler"]["error_buffer"] for c in ckpts]
        if name == "num_processes":
            # two cameras a frame; data.test_image_stride=20 holds frame
            # 20 out
            train = [i for i in range(len(errors[0])) if i // 2 != 20]
            for r, e in enumerate(errors):
                mesh = data_parallel.Mesh(None, 2, r, torch.device("cpu"))
                want = {int(i) for s in range(STEPS) for i in
                        distributed.process_train_indices(train, 0, s, mesh)}
                assert set(np.flatnonzero(e).tolist()) == want, r
        else:
            _assert_same(ckpts[0]["extra"], ckpts[1]["extra"], name)
        metrics = [(d / "metrics.json").read_text()
                   for d in (root, root / "proc1")]
        assert metrics[0] == metrics[1] and metrics[0]
        with open(root / "proc1" / "train_summary.json") as f:
            assert json.load(f)["parallel"]["rank"] == 1


def test_tile_parallel_with_num_processes_raises(tmp_path):
    """As the JAX CLI: tile bands stay on one host, so --tile_parallel
    with --num_processes is refused, before any process group forms."""
    with pytest.raises(ValueError, match="--tile_parallel with "
                                         "--num_processes"):
        train_cli.main(["--device", "cpu", "--output_root", str(tmp_path),
                        "--tile_parallel", "2", "--num_processes", "2",
                        "--process_id", "0", "--coordinator",
                        "127.0.0.1:1", *RUN])
    assert not torch.distributed.is_initialized()


def test_fov_extent_projection_matches_jax():
    """A band's projection: fov_extent against the JAX package's (the
    Jacobian clamped with another field of view, some conics moved by
    it), and row_offset giving the means exactly less the offset."""
    s = _scene(5, n=400)
    geo = ("means", "quats", "scales", "viewmat", "K")
    base = projection.project(*[torch.from_numpy(s[k]) for k in geo],
                              WIDTH, HEIGHT, near_plane=0.3)
    fov = (WIDTH // 2, 2 * HEIGHT)
    want = jprojection.project(*[jnp.asarray(s[k]) for k in geo], WIDTH,
                               HEIGHT, near_plane=0.3, fov_extent=fov)
    got = projection.project(*[torch.from_numpy(s[k]) for k in geo], WIDTH,
                             HEIGHT, near_plane=0.3, fov_extent=fov)
    v = np.array(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    np.testing.assert_array_equal(got.radii.numpy(), np.asarray(want.radii))
    np.testing.assert_allclose(got.means2d.numpy()[v],
                               np.asarray(want.means2d)[v], rtol=1e-6,
                               atol=1e-4)
    np.testing.assert_allclose(got.conics.numpy()[v],
                               np.asarray(want.conics)[v], rtol=1e-5,
                               atol=1e-6)
    assert not torch.equal(got.conics[v], base.conics[v])
    band = projection.project(*[torch.from_numpy(s[k]) for k in geo],
                              WIDTH, 32, near_plane=0.3,
                              fov_extent=(WIDTH, HEIGHT), row_offset=32)
    assert torch.equal(band.means2d[:, 0], base.means2d[:, 0])
    assert torch.equal(band.means2d[:, 1], base.means2d[:, 1] - 32)
    assert torch.equal(band.conics, base.conics)


def test_sink_and_absgrad_match_jax():
    """mean2d_sink's gradient (per sorted intersection) and
    absgrad_from_sink against the JAX package's (tests/test_rasterize.py's
    absgrad test): the same sorted ids, gradients within the pipeline
    tests' 1e-4 relative norm, nothing for culled Gaussians."""
    s = _scene(4, n=120)
    keys = ("means", "quats", "scales", "opac", "colors", "viewmat", "K")
    cap = 2 ** 13
    jcfg = jpipeline.RasterizeConfig(isect_capacity=cap, interpret=True,
                                     pallas_expand=False)

    def jloss(sink):
        out = jpipeline.rasterize(*[jnp.asarray(s[k]) for k in keys], WIDTH,
                                  HEIGHT, jcfg, mean2d_sink=sink)
        return jnp.sum(out["rgb"] ** 2), out["info"]["gauss_ids"]

    (_, jids), jd = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.zeros((cap, 2)))
    n = s["means"].shape[0]
    want = np.asarray(jpipeline.absgrad_from_sink(jd, jids, n))

    sink = torch.zeros((cap, 2), requires_grad=True)
    out = pipeline.rasterize(*[torch.from_numpy(s[k]) for k in keys], WIDTH,
                             HEIGHT, pipeline.RasterizeConfig(
                                 isect_capacity=cap), mean2d_sink=sink)
    (d_sink,) = torch.autograd.grad((out["rgb"] ** 2).sum(), sink)
    ids = out["info"]["gauss_ids"]
    m = int(out["info"]["num_isects"])
    np.testing.assert_array_equal(ids.numpy()[:m], np.asarray(jids)[:m])
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(d_sink.numpy(), np.asarray(jd)) < 1e-4
    got = pipeline.absgrad_from_sink(d_sink, ids, n).numpy()
    assert got.shape == (n, 2) and rel(got, want) < 1e-4
    vis = out["info"]["radii"].numpy() > 0
    assert got[vis].sum() > 0 and not got[~vis].any()
