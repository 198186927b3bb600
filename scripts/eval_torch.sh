#!/usr/bin/env bash
# nuScenes evaluation-protocol metrics for the PyTorch/CUDA port (the port's
# copy of scripts/eval.sh): evaluates every protocol scene's final
# checkpoint on the test and full splits.
#
# Usage: [OUTPUT_ROOT=./work_dirs] [DEVICE=cuda] ./scripts/eval_torch.sh \
#        [scene...]
set -euo pipefail

output_root=${OUTPUT_ROOT:-./work_dirs}
scenes=(${@:-152 164 171 200 209 359 529 916})
device=${DEVICE:-cuda}

for scene in "${scenes[@]}"; do
    run_dir="$output_root/nuscenes_protocol/$scene"
    ckpt=$(ls -d "$run_dir"/checkpoints/checkpoint_* | sort -V | tail -1)
    python -m bilateral_driving_tpu_torch.tools.eval \
        --log_dir "$run_dir" --checkpoint "$ckpt" --compute_geo \
        --device "$device"
done
