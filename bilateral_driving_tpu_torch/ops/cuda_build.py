"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain `extern "C"` launch function. It is
compiled by nvcc for `sm_90a` into a shared library at first use and loaded
with ctypes; nothing includes PyTorch's headers, so a build takes seconds.
Libraries go to `_build/` inside the package (listed in `.gitignore`), named
by a hash of the source and flags, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# kernel name -> extra nvcc flags
KERNELS = {
    "expand": [],
    # sigma and alpha must round like the plain version's separate operations
    "rasterize_fwd": ["--fmad=false"],
    # alpha must round exactly as in rasterize_fwd, so the gate agrees
    "rasterize_bwd": ["--fmad=false"],
    "segsum": [],
    "cubemap_splat": [],
    "scan": [],
}
BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], object] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _flags(name: str) -> list[str]:
    return BASE_FLAGS + KERNELS[name]


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{h[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Returns seconds per
    kernel compiled; raises with nvcc's output if one fails."""
    names = list(KERNELS) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(exist_ok=True)
    exe = nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT),
                    tmp, time.perf_counter())
    secs, errors = {}, []
    for n, (proc, tmp, t0) in procs.items():
        out, _ = proc.communicate()
        secs[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {n}.cu:\n{out.decode()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(n))
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes):
    """A launch function of one kernel's library with its argument types
    set once, when first asked for (ctypes passes an untyped int as 32
    bits, which would cut a pointer)."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def check(code: int, what: str):
    """Raise if a launch function returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def require_cuda(*tensors):
    """Kernel path guard: every tensor is a CUDA tensor on a usable card (a
    CUDA tensor implies one, so the card is only asked about otherwise)."""
    import torch

    for t in tensors:
        if t.device.type != "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "CUDA kernel requested but CUDA is not available")
            raise RuntimeError(
                f"CUDA kernel needs CUDA tensors, got one on {t.device}")


def current_stream(device) -> int:
    """The handle of PyTorch's current stream on a CUDA device, as
    torch.cuda.current_stream(device).cuda_stream gives it, without building
    a Stream object (0.1 us a call on the card against 6 us)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
