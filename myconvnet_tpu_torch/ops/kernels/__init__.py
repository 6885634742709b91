"""Hand-written CUDA kernels for the H100, one module per TPU kernel.

Each module holds the wrapper (which launches the kernel for CUDA tensors
and counts its launches in ``<wrapper>.launches``), its plain PyTorch
version (which the wrapper runs for CPU tensors), and a note on the Pallas
kernel it replaces.  ``_build`` compiles ``csrc/*.cu`` at first use.
The kernels of the served paths (B1, B4, B5, B6's forward and B9's
forward) are also torch custom ops in the ``mcn`` namespace (``_ops``), so
that ``torch.export`` keeps them in an exported program; importing this
package registers them.
"""

from myconvnet_tpu_torch.ops.kernels import (affine, bn_act, conv_fused,
                                             conv_pair, correlation,
                                             flash_attention, normalize_u8,
                                             pad_crop_u8, randaugment_ew)
from myconvnet_tpu_torch.ops.kernels.bn_act import (bn_inference_fused,
                                                    fused_scale_shift_act)
from myconvnet_tpu_torch.ops.kernels.conv_fused import conv3x3_bn_relu
from myconvnet_tpu_torch.ops.kernels.conv_pair import \
    conv1x1_conv3x3_bn_relu
from myconvnet_tpu_torch.ops.kernels.pad_crop_u8 import \
    pad_crop_flip_normalize

# kernel name -> wrapper; ``normalize_u8.normalize_u8`` keeps the module's
# name for the module.  The flash-attention module has three kernels;
# ``shear_rows`` (affine) shears rows or columns.  The correlation module
# has the forward kernel and one backward kernel behind two wrappers.
WRAPPERS = {"bn_act": fused_scale_shift_act,
            "conv_pair": conv1x1_conv3x3_bn_relu,
            "normalize_u8": normalize_u8.normalize_u8,
            "pad_crop_u8": pad_crop_flip_normalize,
            "conv_fused": conv3x3_bn_relu,
            "flash_attention_fwd": flash_attention.flash_attention_fwd,
            "flash_attention_dq": flash_attention.flash_attention_dq,
            "flash_attention_dkv": flash_attention.flash_attention_dkv,
            "shear_rows": affine.shear_rows,
            "randaugment_ew": randaugment_ew.apply_layer,
            "correlation_fwd": correlation.correlation_fwd,
            "correlation_bwd_f1": correlation.correlation_bwd_f1,
            "correlation_bwd_f2": correlation.correlation_bwd_f2}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["WRAPPERS", "affine", "bn_act", "bn_inference_fused",
           "conv1x1_conv3x3_bn_relu", "conv3x3_bn_relu", "conv_fused",
           "conv_pair", "correlation", "flash_attention",
           "fused_scale_shift_act", "launch_counts", "normalize_u8", "pad_crop_flip_normalize",
           "pad_crop_u8", "randaugment_ew", "reset_launch_counts"]
