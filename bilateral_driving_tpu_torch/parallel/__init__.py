"""Multi-device training over torch.distributed: port of
bilateral_driving_tpu/parallel/ (data, tile and hybrid data x tile
parallel steps, and the multi-process set-up)."""
from .data_parallel import make_mesh, parallel_train_step
