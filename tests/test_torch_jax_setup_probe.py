"""How the port's tests run the JAX package's synthetic scene set-up,
measured on the CPU. No tests here: run it as a script from the repo root.

    JAX_PLATFORMS=cpu python tests/test_torch_jax_setup_probe.py builds
    JAX_PLATFORMS=cpu python tests/test_torch_jax_setup_probe.py builds --jit
    JAX_PLATFORMS=cpu python tests/test_torch_jax_setup_probe.py precision

`builds` runs, in one fresh process as a pytest worker would, the
`common.build_synthetic_scene` calls of the port's step and forward
fixtures (their presets, at their size), op by op or each as one jitted
program, and prints each call's seconds. Op by op, a call reuses the
primitives that earlier calls compiled; jitted, each call compiles anew.

`precision` builds tests/test_torch_train.py's scene both ways, prints the
largest difference of each leaf that differs, and for each scene that
test's second step: the JAX package's float32 gradients and the port's
plain path in float32, leaf by leaf against the port's plain path with
every tensor in float64 (relative norm of the difference).
"""
import argparse
import dataclasses
import functools
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if __name__ == "__main__":
    sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from bilateral_driving_tpu.tools import common  # noqa: E402
from bilateral_driving_tpu.utils import config as config_lib  # noqa: E402

PRESETS = ("omnire_ms_bilateral", "omnire_bilateral", "omnire", "pvg",
           "deformablegs")


def _config(name):
    """A preset at the port's step and forward fixtures' size."""
    cfg = config_lib.load_config(os.path.join(
        ROOT, "bilateral_driving_tpu", "configs", f"{name}.yaml"))
    cfg["data"] = config_lib.ConfigDict(
        {"width": 96, "height": 64, "num_frames": 4, "num_bg": 300,
         "bg_capacity": 512})
    cfg["trainer"]["envlight_resolution"] = 16
    return cfg


def build(cfg, jit: bool):
    """common.build_synthetic_scene(key 0, cfg), op by op or as one jitted
    program; in the latter, values known while tracing (a constant's
    logit) are computed as they are, since the build reads some back as
    Python numbers, and leaves that are not arrays come back as traced."""
    if not jit:
        return common.build_synthetic_scene(jax.random.key(0), cfg,
                                            interpret=True)
    made = {}

    def arrays(key):
        with jax.ensure_compile_time_eval():
            out = common.build_synthetic_scene(key, cfg, interpret=True)
        leaves, made["tree"] = jax.tree_util.tree_flatten(out)
        made["traced"] = [isinstance(x, jax.core.Tracer) for x in leaves]
        made["leaves"] = leaves
        return [x for x, t in zip(leaves, made["traced"]) if t]

    got = iter(jax.jit(arrays)(jax.random.key(0)))
    return jax.tree_util.tree_unflatten(made["tree"], [
        next(got) if t else x
        for x, t in zip(made["leaves"], made["traced"])])


def builds(jit: bool):
    total = 0.0
    for name in PRESETS:
        t0 = time.perf_counter()
        out = build(_config(name), jit)
        jax.block_until_ready(out[2])
        dt = time.perf_counter() - t0
        total += dt
        print(f"{name}: {dt:.2f} s")
    print(f"{'jitted' if jit else 'op by op'}: {total:.2f} s in all")


def _second_step_errors(scene):
    """tests/test_torch_train.py's fixture up to its second step's
    gradients, on the given build; returns {leaf: (JAX float32 error,
    port float32 error)} against the port's plain path in float64."""
    import torch

    import test_torch_train as tt
    from bilateral_driving_tpu.data import synthetic as jsynthetic
    from bilateral_driving_tpu.train import trainer as jtrainer
    from bilateral_driving_tpu_torch import configs, convert
    from bilateral_driving_tpu_torch.train import trainer

    tcfg, jscene, params, statics, aux, masks = scene
    tcfg = dataclasses.replace(tcfg, isect_capacity=tt.CAP)
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
        tcfg.num_images, tcfg.num_frames, isect_capacity=tt.CAP,
        envlight_resolution=tt.R, scene_scale=tcfg.scene_scale)
    jstate = jtrainer.init_state(jax.random.key(1), tcfg,
                                 jax.tree.map(jnp.asarray, params), masks,
                                 aux)
    jstate = jstate.replace(step=jnp.asarray(tt.STEP, jnp.int32))
    batches = []
    for frame in (1, 2):
        shape = (tt.H, tt.W)
        pixels = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
        sky = (rng.random(shape) < 0.3).astype(np.float32)
        depth = np.where(rng.random(shape) < 0.1, rng.uniform(3, 40, shape),
                         0).astype(np.float32)
        batches.append(jsynthetic.make_batch(
            jscene, frame, jnp.asarray(pixels), jnp.asarray(sky),
            jnp.asarray(depth)))
    grads_fn = jax.jit(lambda st, b: jtrainer.compute_grads(
        tcfg, statics, st, b))
    apply_fn = jax.jit(functools.partial(jtrainer.apply_grads_and_refine,
                                         tcfg, statics))
    with tt._jax_reference_path():
        jstate, _ = apply_fn(jstate, batches[0],
                             *grads_fn(jstate, batches[0]))
        jg = grads_fn(jstate, batches[1])
    want32 = tt._jax_grads_by_path(jg[3])
    params = jax.tree.map(np.asarray, jstate.params)

    def cast(tree, dtype):
        return jax.tree.map(lambda x: np.asarray(x).astype(dtype)
                            if np.asarray(x).dtype == np.float32
                            else np.asarray(x), tree)

    def port_grads(dtype):
        state = convert.train_state_from_jax(
            pcfg, cast(params, dtype), aux, masks, jstate.stats,
            int(jstate.step), device="cpu",
            generator=torch.Generator().manual_seed(0))
        g = trainer.compute_grads(
            pcfg, convert.tree_from_jax(cast(statics, dtype), "cpu"), state,
            tt._torch_batch(cast(batches[1], dtype)))
        return {k: v.numpy() for k, v in g[3].items()}

    g64, g32 = port_grads(np.float64), port_grads(np.float32)
    return {k: (tt._rel(want32[k], g64[k]), tt._rel(g32[k], g64[k]))
            for k in g64 if np.any(g64[k])}


def precision():
    cfg = _config("omnire_ms_bilateral")
    scenes = {"op by op": build(cfg, False), "jitted": build(cfg, True)}
    a, b = (jax.tree_util.tree_leaves_with_path(s[1:])
            for s in scenes.values())
    for (path, x), (_, y) in zip(a, b):
        if not hasattr(x, "dtype"):
            continue
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if not np.array_equal(x, y):
            print(f"leaf {jax.tree_util.keystr(path)}: "
                  f"{np.abs(x - y).max():.3g} at most")
    for label, scene in scenes.items():
        err = _second_step_errors(scene)
        jworst = max(err, key=lambda k: err[k][0])
        pworst = max(err, key=lambda k: err[k][1])
        print(f"{label}: JAX float32 {err[jworst][0]:.3g} ({jworst}; the "
              f"port's there {err[jworst][1]:.3g}), port float32 "
              f"{err[pworst][1]:.3g} ({pworst})")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("what", choices=("builds", "precision"))
    p.add_argument("--jit", action="store_true",
                   help="builds: each call as one jitted program")
    args = p.parse_args(argv)
    if args.what == "builds":
        builds(args.jit)
    else:
        precision()


if __name__ == "__main__":
    main()
