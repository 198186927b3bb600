"""Every public top-level function and class of the JAX package has its
counterpart in the port.

The JAX package's sources and the port's are read with `ast`; neither is
imported. A public name (no leading underscore) of a JAX module counts as
ported when the counterpart module (the same path in the port, or the one
MODULES names) defines, assigns or imports the same name, or when
ELSEWHERE names the place in the port that does its job. NO_COUNTERPART
lists the names the port leaves out on purpose, each with its reason:
plumbing of the TPU path (Pallas block layouts, jit's static leaves) or the
XLA path that the port does not follow by design."""
import ast
import os

from test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
JAX_PKG, PORT_PKG = "bilateral_driving_tpu", "bilateral_driving_tpu_torch"

# JAX module -> the port's module, where the paths differ
MODULES = {
    "eval/lpips_jax.py": "eval/lpips.py",
    "ops/expand_pallas.py": "ops/expand_cuda.py",
    "ops/rasterize_pallas.py": "ops/rasterize_cuda.py",
    "ops/scan_pallas.py": "ops/scan_cuda.py",
    "ops/segsum_pallas.py": "ops/segsum_cuda.py",
}

# "JAX module:name" -> "port module:name" that does its job
ELSEWHERE = {
    # the port keeps a class's six arrays in a dict of tensors
    "core/gaussians.py:GaussianParams": "train/setup.py:gaussian_dict",
    "core/gaussians.py:init_params": "train/setup.py:gaussian_dict",
    "core/gaussians.py:random_quats": "train/setup.py:random_quats",
    # Sigma = R S S^T R^T, formed inside the projection
    "core/gaussians.py:covariance3d": "ops/projection.py:project",
    "models/bilateral.py:multiscale_neural_tv_loss":
        "models/bilateral.py:multiscale_tv_loss",
    "models/deform.py:init_deform": "models/deform.py:DeformNetwork",
    "models/deform.py:apply_deform": "models/deform.py:DeformNetwork",
    "models/sky.py:sample_cubemap": "ops/cubemap.py:sample",
    "ops/camera.py:Camera": "ops/camera.py:viewmat_from_c2w",
    "ops/cubemap.py:splat_grad": "ops/cubemap_cuda.py:splat_grad",
    "ops/cubemap.py:sample_splat_vjp": "ops/cubemap.py:sample_splat",
    "ops/expand_pallas.py:expand_gather_xla":
        "ops/expand_cuda.py:expand_gather_plain",
    "scene/background.py:init_from_points": "train/setup.py:build_background",
    "scene/deformable.py:init_node_embeddings":
        "models/encoders.py:embedding_init",
    "scene/nodes.py:GaussianBundle": "core/gaussians.py:Gaussians",
    "scene/nodes.py:sh_colors": "core/gaussians.py:sh_colors",
    "scene/nodes.py:quat_norm": "core/transforms.py:quat_normalize",
    "scene/rigid.py:init_instance_state": "train/setup.py:build_rigid",
    # K steps per dispatch: the CLI's dispatch windows
    "train/trainer.py:train_multi_step": "tools/train.py:train",
}

REASONS = ("TPU-only plumbing", "the XLA path")
NO_COUNTERPART = {
    "models/encoders.py:Static":
        "TPU-only plumbing: keeps metadata out of jit's traced pytrees",
    "ops/expand_pallas.py:pad_table":
        "TPU-only plumbing: pads the table to the kernel's row blocks",
    "ops/expand_pallas.py:chunk_edges":
        "TPU-only plumbing: 128-entry chunk windows over 256-row blocks",
    "ops/expand_pallas.py:window_violation":
        "TPU-only plumbing: the fallback test of those windows",
    "ops/pipeline.py:isect_buffer_size":
        "TPU-only plumbing: the sorted buffer's length, the capacity",
    "ops/scan_utils.py:cumsum_rows":
        "the XLA path: only the prefix-difference _expand_sort_bwd uses it",
}


def _public(path: str) -> list:
    tree = ast.parse(open(path).read())
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")]


def _bound(path: str) -> set:
    """Names a module binds at top level: defs, classes, assignments and
    imports."""
    out = set()
    for n in ast.parse(open(path).read()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign) else [n.target]):
                out |= {x.id for x in ast.walk(t) if isinstance(x, ast.Name)}
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            out |= {(a.asname or a.name).split(".")[0] for a in n.names}
    return out


def _jax_names() -> dict:
    """{"module path:name": port module path} over the JAX package."""
    out = {}
    base = os.path.join(ROOT, JAX_PKG)
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, f), base)
            for name in _public(os.path.join(base, rel)):
                out[f"{rel}:{name}"] = MODULES.get(rel, rel)
    return out


def _in_port(module: str, name: str) -> bool:
    path = os.path.join(ROOT, PORT_PKG, module)
    return os.path.exists(path) and name in _bound(path)


def test_every_public_name_has_a_counterpart():
    names = _jax_names()
    assert len(names) > 300
    missing = [k for k, module in names.items()
               if not _in_port(module, k.split(":")[1])
               and k not in ELSEWHERE and k not in NO_COUNTERPART]
    assert not missing, f"no counterpart in the port: {missing}"
    gone = {k: v for k, v in ELSEWHERE.items() if not _in_port(
        *v.split(":"))}
    assert not gone, f"counterparts not in the port: {gone}"


def test_the_map_holds_no_stale_entry():
    """Each listed name is a public name of the JAX package that its
    counterpart module lacks, each renamed module exists in both packages,
    and each reason is of an allowed kind."""
    names = _jax_names()
    for jax_mod, port_mod in MODULES.items():
        assert os.path.exists(os.path.join(ROOT, JAX_PKG, jax_mod)), jax_mod
        assert os.path.exists(os.path.join(ROOT, PORT_PKG, port_mod)), \
            port_mod
    for k in [*ELSEWHERE, *NO_COUNTERPART]:
        assert k in names, f"{k} is no public name of the JAX package"
        assert not _in_port(names[k], k.split(":")[1]), \
            f"{k} is in the port under its own name: drop the entry"
    assert not set(ELSEWHERE) & set(NO_COUNTERPART)
    for k, reason in NO_COUNTERPART.items():
        assert reason.startswith(REASONS), k
