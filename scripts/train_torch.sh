#!/usr/bin/env bash
# nuScenes evaluation-protocol training for the PyTorch/CUDA port (the port's
# copy of scripts/train.sh): trains the 8 protocol scenes
# {152 164 171 200 209 359 529 916} with the extended multi-scale-bilateral
# preset, 6 cameras, test_image_stride=10.
#
# Usage: DATA_ROOT=/data/nuscenes/processed_10hz [DATA_PARALLEL=N] \
#        [DEVICE=cuda] ./scripts/train_torch.sh [scene...]
set -euo pipefail

output_root=${OUTPUT_ROOT:-./work_dirs}
data_root=${DATA_ROOT:?set DATA_ROOT to the processed nuScenes root}
config=omnire_ms_bilateral_extended
dataset=nuscenes/6cams
scenes=(${@:-152 164 171 200 209 359 529 916})
data_parallel=${DATA_PARALLEL:-0}       # >1 shards the image batch per step
device=${DEVICE:-cuda}

for scene in "${scenes[@]}"; do
    python -m bilateral_driving_tpu_torch.tools.train \
        --config "$config" \
        --output_root "$output_root" \
        --project nuscenes_protocol \
        --run_name "$scene" \
        --data_parallel "$data_parallel" \
        --device "$device" \
        dataset=$dataset \
        data.scene_dir="$data_root/$scene" \
        data.test_image_stride=10 \
        data.start_frame=0 data.end_frame=-1
done
