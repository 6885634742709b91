"""Image-quality metrics: PSNR and SSIM per image pair, and the paired
evaluator that pix2pix's eval scores with.

Port of ``myconvnet_tpu/eval/image_metrics.py``: ``psnr`` (``:16``),
``ssim`` (``:36``) with its 7x7 uniform filter (``:25``, VALID windows;
here ``avg_pool2d``, whose float32 sum stays off the tensor cores) and
``PairedImageEvaluator`` (``:59``), which keeps its running sum on the
device, so a batch costs no host sync until :meth:`score`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(a: torch.Tensor, b: torch.Tensor, *, max_val: float = 1.0
         ) -> torch.Tensor:
    """[N, H, W, C] pairs -> [N] dB, float32."""
    mse = (a.float() - b.float()).square().mean((1, 2, 3))
    return 10.0 * torch.log10(max_val ** 2 / torch.clamp(mse, min=1e-12))


def _uniform_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """Mean over size x size VALID windows, per channel, NHWC."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), size, stride=1).permute(
        0, 2, 3, 1)


def ssim(a: torch.Tensor, b: torch.Tensor, *, max_val: float = 1.0,
         window: int = 7, k1: float = 0.01, k2: float = 0.03
         ) -> torch.Tensor:
    """Mean structural similarity per pair ([N, H, W, C] -> [N]) over
    uniform windows."""
    af, bf = a.float(), b.float()
    c1, c2 = (k1 * max_val) ** 2, (k2 * max_val) ** 2
    mu_a, mu_b = _uniform_filter(af, window), _uniform_filter(bf, window)
    s_aa = _uniform_filter(af * af, window) - mu_a * mu_a
    s_bb = _uniform_filter(bf * bf, window) - mu_b * mu_b
    s_ab = _uniform_filter(af * bf, window) - mu_a * mu_b
    lum = (2 * mu_a * mu_b + c1) / (mu_a ** 2 + mu_b ** 2 + c1)
    con = (2 * s_ab + c2) / (s_aa + s_bb + c2)
    return (lum * con).mean((1, 2, 3))


class PairedImageEvaluator:
    """PSNR or SSIM averaged over every pair: ``update(pred, target)``."""

    higher_is_better = True

    def __init__(self, metric: str = "psnr", max_val: float = 1.0):
        if metric not in ("psnr", "ssim"):
            raise ValueError(f"unknown image metric {metric!r}")
        self.name = metric
        self._fn = psnr if metric == "psnr" else ssim
        self._max_val = max_val
        self.reset()

    def reset(self) -> None:
        self._sum = None
        self._n = 0

    def update(self, pred: torch.Tensor, target: torch.Tensor) -> None:
        vals = self._fn(pred, target, max_val=self._max_val).sum()
        self._sum = vals if self._sum is None else self._sum + vals
        self._n += int(pred.shape[0])

    def score(self) -> float:
        return 0.0 if self._sum is None else float(self._sum) / max(
            self._n, 1)

    def worst_score(self) -> float:
        return float("-inf")

    def is_better(self, curr: float, best: float) -> bool:
        return curr > best
