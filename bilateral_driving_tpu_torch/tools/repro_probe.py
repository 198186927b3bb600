"""Where do two runs of the SMPL quality protocol part? A probe of the
port's run-to-run reproducibility on the card.

Runs tools.train in this process with tools/quality_smoke.py's overrides
for `--steps` steps, twice per mode, and digests every parameter leaf
(SHA-1 of its bytes) after every training step; reports the first step
whose digests differ between the two runs and the leaves that differ
there. Modes:

  default        the port as it is
  deterministic  under torch.use_deterministic_algorithms(True,
                 warn_only=True): PyTorch's own nondeterministic device
                 operations (the index-gather backward among them) take
                 their deterministic versions or warn
  plain_splat    deterministic, and the EnvLight splat kernel's wrapper
                 pointed at its plain version (index_add_, deterministic in
                 that mode): a probe only, not a path of the port

It also launches the splat kernel `--repeats` times on the arguments of
its first launch in the default run and counts the elements whose bits
differ from the first launch.

    python -m bilateral_driving_tpu_torch.tools.repro_probe \
        [--steps 16] [--repeats 20] [--config omnire_ms_bilateral] \
        [--modes default,deterministic,plain_splat] [--out repro_probe.json]

Prints one JSON line (and writes it to --out) with the card's nvidia-smi
name and power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import shutil

import torch

from ..ops import cubemap, cubemap_cuda
from ..train import trainer
from . import quality_smoke
from . import train as train_cli

REPO = quality_smoke.REPO
MODES = ("default", "deterministic", "plain_splat")


@contextlib.contextmanager
def _swapped(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _digests(state) -> dict:
    return {k: hashlib.sha1(p.detach().cpu().numpy().tobytes()).hexdigest()
            for k, p in trainer.named_leaves(state.params)}


def run_once(config: str, steps: int, workdir: str, name: str,
             capture=None, device: str = "cuda") -> list:
    """tools.train for `steps` steps; the parameter digests after each
    step. `capture` (a dict) receives the splat's first arguments."""
    digests = []
    step_fn = trainer.train_step

    def recorded(*args, **kw):
        out = step_fn(*args, **kw)
        digests.append(_digests(out[0]))
        return out

    splat = cubemap.cubemap_cuda.splat_grad

    def capturing(*args):
        if capture is not None and not capture:
            capture["args"] = tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args)
        return splat(*args)

    # tools.train reads the wrapper's launch counter
    capturing.launches = 0
    with _swapped(trainer, "train_step", recorded), \
            _swapped(cubemap.cubemap_cuda, "splat_grad", capturing):
        train_cli.main(["--config", config, "--device", device,
                        "--output_root", workdir, "--run_name", name]
                       + quality_smoke.overrides(steps))
    return digests


def first_difference(a: list, b: list):
    """(first step index whose digests differ, the leaves that differ
    there), or (None, [])."""
    for i, (da, db) in enumerate(zip(a, b, strict=True)):
        if da != db:
            return i, sorted(k for k in da if da[k] != db[k])
    return None, []


def splat_repeats(args, repeats: int) -> dict:
    """The splat kernel launched `repeats` times on one input: the
    elements whose bits differ from the first launch."""
    first = cubemap_cuda.splat_grad(*args)
    differ, max_abs = [], 0.0
    for _ in range(repeats - 1):
        z = cubemap_cuda.splat_grad(*args)
        ne = z.view(torch.int32) != first.view(torch.int32)
        differ.append(int(ne.sum()))
        max_abs = max(max_abs, float((z - first).abs().max()))
    face = args[0]
    return {"repeats": repeats, "elements": first.numel(),
            "pixels": int(face.numel()), "live_pixels": int((face >= 0).sum()),
            "resolution": int(args[-1]),
            "differing_elements_per_launch": differ,
            "max_abs_difference": max_abs}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="omnire_ms_bilateral")
    p.add_argument("--steps", type=int, default=16)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--modes", default=",".join(MODES),
                   help="comma-separated subset of " + ", ".join(MODES))
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    workdir = os.path.join(REPO, "work_dirs", "repro_probe")
    result = {"config": args.config, "steps": args.steps,
              "nvidia_smi": quality_smoke.nvidia_smi(), "modes": {}}
    capture = {}
    modes = args.modes.split(",")
    if "default" not in modes or set(modes) - set(MODES):
        raise ValueError(f"--modes {args.modes}: the default mode captures "
                         f"the splat's input; choose from {MODES}")
    for mode in modes:
        runs = []
        with contextlib.ExitStack() as stack:
            if mode != "default":
                torch.use_deterministic_algorithms(True, warn_only=True)
                stack.callback(torch.use_deterministic_algorithms, False)
            if mode == "plain_splat":
                def plain(*a):
                    return cubemap_cuda.splat_grad_plain(*a)
                plain.launches = 0
                stack.enter_context(_swapped(cubemap.cubemap_cuda,
                                             "splat_grad", plain))
            for r in range(2):
                runs.append(run_once(
                    args.config, args.steps, workdir, f"{mode}_{r}",
                    capture if mode == "default" else None, args.device))
        step, leaves = first_difference(*runs)
        result["modes"][mode] = {"first_differing_step": step,
                                 "differing_leaves": leaves,
                                 "steps_compared": len(runs[0])}
    result["splat"] = splat_repeats(capture["args"], args.repeats)
    shutil.rmtree(workdir, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
