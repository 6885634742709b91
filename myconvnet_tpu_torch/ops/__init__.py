from myconvnet_tpu_torch.ops.batch_norm import (batch_norm_inference,
                                                batch_norm_train)
from myconvnet_tpu_torch.ops.conv import conv2d
from myconvnet_tpu_torch.ops.pool import global_avg_pool, max_pool2d

__all__ = ["batch_norm_inference", "batch_norm_train", "conv2d",
           "global_avg_pool", "max_pool2d"]
