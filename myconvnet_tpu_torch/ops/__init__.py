from myconvnet_tpu_torch.ops.batch_norm import batch_norm_inference
from myconvnet_tpu_torch.ops.conv import conv2d
from myconvnet_tpu_torch.ops.pool import global_avg_pool, max_pool2d

__all__ = ["batch_norm_inference", "conv2d", "global_avg_pool",
           "max_pool2d"]
