"""Registers, memory and resident blocks per SM of the port's CUDA kernels.

Builds the kernels of a checkout (this one by default) with that checkout's
own `ops/cuda_build.py`, reads each library's device code with the CUDA
toolkit's `cuobjdump`, loads it through the CUDA driver and prints, per
kernel function, one JSON line: registers per thread, static shared memory
per block and local (spilled) memory per thread (cuFuncGetAttribute), and
the blocks that can be resident on one SM at a given block size
(cuOccupancyMaxActiveBlocksPerMultiprocessor, which leaves clusters out).
For a kernel launched in clusters of its own fixed size
(`__cluster_dims__`) also that size and the clusters that can be resident
on the whole card at once (cuOccupancyMaxActiveClusters), which is what
bounds such a launch. Needs a card.

Usage:
  python -m bilateral_driving_tpu_torch.tools.kernel_resources \\
      [--root CHECKOUT] [--threads NAME=N ...]
--threads gives the block size of a library's kernels (default 256), e.g.
rasterize_fwd=1024 for a forward that runs a block of 1,024 threads per
tile, or 0 for each function's own `__launch_bounds__`.
"""
from __future__ import annotations

import argparse
import ctypes
import glob
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile

# CUfunction_attribute values (cuda.h)
ATTRS = {"registers": 4, "shared_bytes": 1, "local_bytes": 3}
MAX_THREADS, CLUSTER_WIDTH = 0, 11


class LaunchConfig(ctypes.Structure):
    """CUlaunchConfig (cuda.h)."""
    _fields_ = [("grid", ctypes.c_uint * 3), ("block", ctypes.c_uint * 3),
                ("shared_bytes", ctypes.c_uint), ("stream", ctypes.c_void_p),
                ("attrs", ctypes.c_void_p), ("num_attrs", ctypes.c_uint)]


def driver():
    """A caller of CUDA driver functions in the card's primary context
    (PyTorch's), raising on an error."""
    cu = ctypes.CDLL("libcuda.so.1")

    def call(name, *args):
        err = getattr(cu, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} failed: CUDA driver error {err}")

    call("cuInit", 0)
    dev, ctx = ctypes.c_int(), ctypes.c_void_p()
    call("cuDeviceGet", ctypes.byref(dev), 0)
    call("cuDevicePrimaryCtxRetain", ctypes.byref(ctx), dev)
    call("cuCtxSetCurrent", ctx)
    return call


def resources(lib_path: str, threads: int | None, call) -> list[dict]:
    """Each kernel function of one built library at a block size of
    `threads` (None: the most the function can launch, its
    `__launch_bounds__` where it declares them); `call` from driver()."""
    cuobjdump = os.path.join(os.path.dirname(
        importlib.import_module("bilateral_driving_tpu_torch.ops.cuda_build")
        .nvcc()), "cuobjdump")
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        subprocess.run([cuobjdump, "-xelf", "all", lib_path], cwd=tmp,
                       check=True, capture_output=True)
        for cubin in sorted(glob.glob(os.path.join(tmp, "*.cubin"))):
            names = re.findall(r"Function (\S+):", subprocess.run(
                [cuobjdump, "-res-usage", cubin], check=True,
                capture_output=True, text=True).stdout)
            mod = ctypes.c_void_p()
            call("cuModuleLoad", ctypes.byref(mod), cubin.encode())
            for name in names:
                fn, value = ctypes.c_void_p(), ctypes.c_int()
                call("cuModuleGetFunction", ctypes.byref(fn), mod,
                     name.encode())

                def attr(a):
                    call("cuFuncGetAttribute", ctypes.byref(value), a, fn)
                    return value.value

                n = threads or attr(MAX_THREADS)
                row = {"function": name, "threads": n,
                       **{key: attr(a) for key, a in ATTRS.items()}}
                call("cuOccupancyMaxActiveBlocksPerMultiprocessor",
                     ctypes.byref(value), fn, n, ctypes.c_size_t(0))
                row["blocks_per_sm"] = value.value
                width = attr(CLUSTER_WIDTH)
                if width:
                    cfg = LaunchConfig((width, 1, 1), (n, 1, 1), 0)
                    call("cuOccupancyMaxActiveClusters", ctypes.byref(value),
                         fn, ctypes.byref(cfg))
                    row["cluster"] = width
                    row["clusters_on_card"] = value.value
                out.append(row)
            call("cuModuleUnload", mod)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--threads", nargs="*", default=[])
    args = ap.parse_args()
    threads = dict(kv.split("=") for kv in args.threads)
    sys.path.insert(0, os.path.abspath(args.root))
    for mod in [m for m in sys.modules if m.startswith("bilateral_driving")]:
        del sys.modules[mod]
    cuda_build = importlib.import_module(
        "bilateral_driving_tpu_torch.ops.cuda_build")
    cuda_build.build()
    call = driver()
    for name in cuda_build.KERNELS:
        for row in resources(str(cuda_build.library_path(name)),
                             int(threads.get(name, 256)) or None, call):
            print(json.dumps({"root": os.path.abspath(args.root),
                              "kernel": name, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
