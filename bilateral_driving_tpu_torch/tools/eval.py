"""Evaluation CLI: port of bilateral_driving_tpu/tools/eval.py.

    python -m bilateral_driving_tpu_torch.tools.eval \
        --log_dir work_dirs/myrun [--checkpoint path] [--compute_geo] \
        [--device cpu] [key=value ...]

Rebuilds the scene and trainer from the run's saved config.json (with any
overrides), restores the latest checkpoint (or the given one), renders the
test split and the full set, and writes the aggregated metrics to
metrics_test.json and metrics_full.json in the run directory
(reference eval_metrics.py:24-127).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from ..eval import render_loop
from ..train import checkpoint
from ..utils import config as config_lib
from ..utils.logging import logger, setup_logging
from . import train as train_cli


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--compute_geo", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)
    dev = train_cli.device_of(args.device)

    setup_logging(args.log_dir)
    cfg = config_lib.load_config(os.path.join(args.log_dir, "config.json"),
                                 overrides=args.opts)
    tcfg, data, statics, state = train_cli.build(cfg, 0, dev)
    ckpt = args.checkpoint or checkpoint.latest_checkpoint(
        os.path.join(args.log_dir, "checkpoints"))
    if ckpt:
        state, extra = checkpoint.restore_checkpoint(ckpt, state)
        tcfg = dataclasses.replace(tcfg,
                                   isect_capacity=extra["isect_capacity"])
        logger.info(f"restored {ckpt} @ step {state.step}")

    test_stride = cfg.get_path("data.test_image_stride", 10)
    _, test_idx = data.split_train_test(test_stride)
    neighbor_map = data.neighbor_train_indices(test_stride)
    out = {}
    for split, indices in [("test", test_idx),
                           ("full", np.arange(data.num_images))]:
        if args.max_images:
            indices = indices[:args.max_images]
        if len(indices) == 0:
            continue
        results = render_loop.render_images(
            tcfg, state, statics, data, indices, neighbor_map=neighbor_map,
            compute_metrics=True, compute_geo=args.compute_geo)
        agg = render_loop.aggregate_metrics(results["metrics"])
        logger.info(f"{split}: {agg}")
        with open(os.path.join(args.log_dir,
                               f"metrics_{split}.json"), "w") as f:
            json.dump(agg, f, indent=2)
        out[split] = agg
    return out


if __name__ == "__main__":
    main()
