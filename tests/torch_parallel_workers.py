"""Rank functions of the port's multi-process CPU tests (no tests here).

`spawn` runs a function on gloo ranks started by torch.multiprocessing
with a file:// rendezvous in the test's temporary directory (no port to
race for); each rank runs torch on one thread, imports only torch and the
port (not JAX), and saves what it returns, which `spawn` loads back in
rank order.
"""
import hashlib
import os

import torch
import torch.distributed as dist

from bilateral_driving_tpu_torch.data import synthetic
from bilateral_driving_tpu_torch.parallel import data_parallel, tile_parallel
from bilateral_driving_tpu_torch.train import density, trainer


def spawn(fn, world: int, tmp_path, *args) -> list:
    """fn(*args) on `world` gloo ranks; the ranks' results in rank order."""
    import torch.multiprocessing as mp

    out = str(tmp_path)
    mp.spawn(_rank, nprocs=world, join=True,
             args=(fn, world, out, os.path.join(out, "rendezvous"), args))
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def cli_processes(argv, world: int, coordinator: str) -> None:
    """tools.train.main(argv) as the `world` processes of a multi-process
    run (--coordinator, --num_processes, --process_id), each started
    apart by torch.multiprocessing on one thread."""
    import torch.multiprocessing as mp

    mp.spawn(_cli_process, nprocs=world, join=True,
             args=(list(argv), world, coordinator))


def _cli_process(rank, argv, world, coordinator):
    from bilateral_driving_tpu_torch.tools import train as train_cli

    torch.set_num_threads(1)
    train_cli.main([*argv, "--coordinator", coordinator, "--num_processes",
                    str(world), "--process_id", str(rank)])


def _rank(rank, fn, world, out, store, args):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def digests(params) -> dict:
    """SHA-1 of every parameter leaf's bytes."""
    return {k: hashlib.sha1(v.detach().numpy().tobytes()).hexdigest()
            for k, v in trainer.named_leaves(params)}


def _state(case):
    return trainer.init_state(
        case["cfg"], {k: _copy(v) for k, v in case["params"].items()},
        {k: v.clone() for k, v in case["masks"].items()}, case["aux"],
        step=case["step"], generator=torch.Generator().manual_seed(0))


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return tree


def data_parallel_case(case_file: str) -> dict:
    """The reduced gradients of one data-parallel step of a saved case
    (cfg, params, masks, aux, statics, step, one batch per rank), and
    the parameter digests after two parallel steps; rank 0 also returns
    the per-image gradients of every batch."""
    case = torch.load(case_file, weights_only=False)
    cfg, statics, batches = case["cfg"], case["statics"], case["batches"]
    mesh = data_parallel.make_mesh(len(batches), device="cpu")
    batch = data_parallel.shard_batch(
        data_parallel.stack_batches(batches), mesh)
    total, loss_dict, outputs, g, gd = trainer.compute_grads(
        cfg, statics, _state(case), batch)
    info = outputs["info"]
    total, loss_dict, g, psnr, (gd, num_isects), (radii, _) = \
        data_parallel.reduce_grads(
            total, loss_dict, g, trainer.image_psnr(outputs, batch),
            mesh.group, mesh.size, sums=(gd, info["num_isects"]),
            maxes=(info["radii"], info["overflow"]))
    result = {"total": total, "loss": loss_dict, "grads": g, "dummy": gd,
              "num_isects": num_isects, "radii": radii, "psnr": psnr}
    if mesh.rank == 0:
        result["image_grads"] = [trainer.compute_grads(
            cfg, statics, _state(case), b)[3] for b in batches]
    state = _state(case)
    step = data_parallel.parallel_train_step(cfg, statics, mesh)
    metrics = []
    for _ in range(2):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    result.update(metrics=metrics, digests=digests(state.params))
    return result


TILE_W, TILE_H = 32, 64     # two 32-pixel tile rows: two real bands


def tile_config():
    """The JAX package's tile-step test configuration
    (tests/test_parallel.py): EnvLight and multi-scale grids after the
    band gather, so both gradient paths are exercised."""
    return trainer.TrainerConfig(
        background_model="vanilla", sky_model="envlight",
        affine_model="multiscale_bilateral", envlight_resolution=16,
        isect_capacity=2 ** 12, num_images=4, num_frames=4, sh_degree=1,
        density=density.DensityConfig(refine_interval=10000),
        scene_scale=5.0, w_depth=0.0)


def tile_scene(cfg, n_images: int):
    """A small scene drawn from a seed, its state and one batch of random
    targets per image."""
    g = torch.Generator().manual_seed(3)
    scene = synthetic.make_scene(g, num_bg=300, num_frames=4, width=TILE_W,
                                 height=TILE_H, num_rigid=0, device="cpu")
    state, statics = synthetic.random_state(scene, cfg, g, 512, 0,
                                            device="cpu")
    batches = [synthetic.make_batch(scene, f, torch.rand(
        (TILE_H, TILE_W, 3), generator=g)) for f in range(n_images)]
    return state, statics, batches


def _tile_run(cfg, statics, case, batch, mesh) -> dict:
    """One step of `mesh` from the case: the step's own reductions of this
    rank's gradients, its metrics and the parameter digests after it."""
    total, loss_dict, outputs, g, gd = trainer.compute_grads(
        cfg, statics, _state(case), batch,
        rasterize_fn=tile_parallel.banded_rasterize_fn(mesh.tile))
    total, loss_dict, g, _, (gd,), _ = data_parallel.reduce_grads(
        total, loss_dict, g, trainer.image_psnr(outputs, batch),
        mesh.group, mesh.size, sums=(gd,))
    st, m = tile_parallel.tile_train_step(cfg, statics, mesh)(
        _state(case), batch)
    return {"total": total, "grads": g, "dummy": gd / mesh.tile.size,
            "radii": outputs["info"]["radii"],
            "metrics": {k: float(v) for k, v in m.items()},
            "digests": digests(st.params)}


def _band_render(cfg, statics, case, batch, tile_mesh) -> dict:
    """The batch's image through make_render_fn over the tile group and
    through pipeline.rasterize whole, without gradients."""
    from bilateral_driving_tpu_torch.ops import pipeline
    from bilateral_driving_tpu_torch.ops.camera import viewmat_from_c2w

    state = _state(case)
    with torch.no_grad():
        merged, _ = trainer.collect_gaussians(
            cfg, state.params, trainer.merge_statics(statics, state.aux),
            state.masks, batch["camera_to_world"][:3, 3], state.step,
            batch["frame_idx"], batch["normed_time"])
        args = (merged.means, merged.quats, merged.scales, merged.opacities,
                merged.rgbs, viewmat_from_c2w(batch["camera_to_world"]),
                batch["intrinsics"])
        rcfg = pipeline.RasterizeConfig(isect_capacity=cfg.isect_capacity)
        bands = tile_parallel.make_render_fn(tile_mesh, TILE_W, TILE_H,
                                             rcfg)(*args)
        whole = pipeline.rasterize(*args, TILE_W, TILE_H, rcfg)
    return {k: (bands[k], whole[k]) for k in ("rgb", "alpha")} | {
        "num_isects": (int(bands["info"]["num_isects"]),
                       int(whole["info"]["num_isects"]))}


def tile_case() -> dict:
    """On four ranks, tile_scene trained two ways: a 2 x 2 hybrid step
    (each image band-split over a tile row of two ranks) and, on each tile
    row alone, a 1 x 2 tile step of its image (a one-rank data group).
    Rank 0 also returns the whole image's gradients and train_step's
    metrics of each image."""
    n_data = n_tile = 2
    cfg = tile_config()
    state, statics, batches = tile_scene(cfg, n_data)
    case = {"cfg": cfg, "params": state.params, "masks": state.masks,
            "aux": state.aux, "step": 0}
    mesh = tile_parallel.make_hybrid_mesh(n_data, n_tile, "cpu")
    alone = [dist.new_group([r]) for r in range(n_data * n_tile)]
    batch = tile_parallel.shard_data_batch(
        data_parallel.stack_batches(batches), mesh)
    row = tile_parallel.HybridMesh(
        data=data_parallel.Mesh(alone[dist.get_rank()], 1, 0, mesh.device,
                                "data"), tile=mesh.tile, group=mesh.tile.group)
    result = {"hybrid": _tile_run(cfg, statics, case, batch, mesh),
              "tile": _tile_run(cfg, statics, case, batch, row),
              "render": _band_render(cfg, statics, case, batch, mesh.tile)}
    if dist.get_rank() == 0:
        whole = [trainer.compute_grads(cfg, statics, _state(case), b)
                 for b in batches]
        result["image_grads"] = [w[3] for w in whole]
        result["image_dummy"] = [w[4] for w in whole]
        result["image_radii"] = [w[2]["info"]["radii"] for w in whole]
        result["train_step"] = [
            {k: float(v) for k, v in trainer.train_step(
                cfg, statics, _state(case), b)[1].items()}
            for b in batches]
    return result
