"""Correlation (cost) volume for optical flow (FlowNetC, PWC-Net).

Port of ``myconvnet_tpu/ops/correlation.py``.  The JAX package's flow
models call the XLA op there and keep a Pallas kernel that "must equal" it
(``ops/pallas/correlation.py``); the port runs the hand-written CUDA
kernels of ``ops/kernels/correlation.py`` where the math sits, forward and
backward, for every CUDA tensor, and the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.ops.kernels.correlation import correlation


def correlation_volume(f1: torch.Tensor, f2: torch.Tensor, *,
                       max_displacement: int = 4) -> torch.Tensor:
    """``[N,H,W,C] x [N,H,W,C] -> [N,H,W,(2d+1)^2]`` float32 cost volume.

    Channel k = dy*(2d+1)+dx holds ``mean_c(f1[y,x,c] *
    f2[y+dy-d, x+dx-d, c])``; displacements outside the frame contribute
    zeros.  Float32 products and sums whatever the inputs' dtype."""
    if f1.shape != f2.shape:
        raise ValueError(f"feature shapes differ: {tuple(f1.shape)} vs "
                         f"{tuple(f2.shape)}")
    d = int(max_displacement)
    if d < 0:
        raise ValueError(f"max_displacement must be >= 0, got {d}")
    return correlation(f1, f2, d)
