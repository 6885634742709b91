"""Hand-written CUDA kernels for the H100, one module per TPU kernel.

Each module holds the wrapper (which launches the kernel for CUDA tensors
and counts its launches in ``<wrapper>.launches``), its plain PyTorch
version (which the wrapper runs for CPU tensors), and a note on the Pallas
kernel it replaces.  ``_build`` compiles ``csrc/*.cu`` at first use.
"""

from myconvnet_tpu_torch.ops.kernels.bn_act import (bn_inference_fused,
                                                    fused_scale_shift_act)
from myconvnet_tpu_torch.ops.kernels.conv_pair import \
    conv1x1_conv3x3_bn_relu

WRAPPERS = {"bn_act": fused_scale_shift_act,
            "conv_pair": conv1x1_conv3x3_bn_relu}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "bn_inference_fused", "conv1x1_conv3x3_bn_relu",
           "fused_scale_shift_act", "launch_counts", "reset_launch_counts"]
