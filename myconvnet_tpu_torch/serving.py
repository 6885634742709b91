"""Frozen inference functions, request bucketing and latency percentiles.

Port of ``myconvnet_tpu/serving.py``: ``make_inference_fn`` (``:58-93``),
``make_batched_server`` (``:447-485``) and ``measure_latency``
(``:488-521``).  Where the JAX package closes a jitted function over
folded weights, the port loads the weights into the module, folds BN in
place, moves it to the device and casts convs and dense layers to the
policy's compute dtype once; the returned function then runs the eval
forward eagerly.  Exporting an artifact (torch.export) comes with a later
slice.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.core.precision import (BF16, Policy,
                                                apply_backend_flags)
from myconvnet_tpu_torch.models.folding import fold_batch_norms
from myconvnet_tpu_torch.nn import Conv, Dense
from myconvnet_tpu_torch.weights import Tree, from_jax


def make_inference_fn(model: nn.Module, params: Tree, state: Tree, *,
                      fold_bn: bool = True,
                      device: str | torch.device = "cuda",
                      policy: Policy = BF16):
    """Return ``fn(x) -> logits`` for ``x`` [B, H, W, C] (numpy or tensor,
    already normalized); logits are a float32 tensor on ``device``.  ``params``/``state`` are JAX-layout trees; with
    ``fold_bn`` each BN is folded into its conv with its own eps.
    ``fn.model`` is the prepared module."""
    device = torch.device(device)
    from_jax(model, params, state)
    if fold_bn:
        fold_batch_norms(model)
    model.eval().to(device)
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            m.to(policy.compute_dtype)
    apply_backend_flags(policy)

    @torch.inference_mode()
    def fn(x):
        x = torch.as_tensor(x).to(device=device,
                                  dtype=policy.compute_dtype)
        return model(x).float()

    fn.model = model
    return fn


def make_batched_server(fn, batch_sizes=(1, 8, 32, 128)):
    """Serve any request size on a fixed set of batch shapes: a request
    goes to the smallest bucket >= n, padded with zeros and sliced back;
    larger requests are chunked through the biggest bucket.  Fixed shapes
    keep the kernels' launch shapes to a known set."""
    buckets = sorted(set(int(b) for b in batch_sizes))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bad batch_sizes {batch_sizes!r}")

    def _run_padded(x, bucket):
        n = x.shape[0]
        if n < bucket:
            pad = torch.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            return fn(torch.cat([x, pad]))[:n]
        return fn(x)

    def serve(x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        for b in buckets:
            if n <= b:
                return _run_padded(x, b)
        big = buckets[-1]
        return torch.cat([_run_padded(x[i:i + big], big)
                          for i in range(0, n, big)])

    return serve


def measure_latency(serve, sample_shape, *, request_sizes=(1, 4, 16, 64),
                    iters: int = 50, warmup: int = 5) -> dict:
    """Per-request latency percentiles of a serve fn.  Each request ends
    in a read of the result to the host, so a number covers host ->
    device -> result readback, as in the JAX version.

    Returns {size: {"p50": ms, ..., "mean": ms, "qps": requests/s,
    "images_per_sec": n * qps}}.
    """
    results = {}
    rs = np.random.RandomState(0)
    for n in request_sizes:
        x = rs.standard_normal((n, *sample_shape)).astype(np.float32)
        for _ in range(warmup):
            float(serve(x).float().sum())
        times = []
        for i in range(iters):
            # evolve the payload so no layer can replay a cached result
            x_i = x + np.float32(i * 1e-6)
            t0 = time.perf_counter()
            float(serve(x_i).float().sum())
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times) * 1e3
        row = {f"p{p}": float(np.percentile(arr, p)) for p in (50, 95, 99)}
        row["mean"] = float(arr.mean())
        row["qps"] = float(1e3 / arr.mean())
        row["images_per_sec"] = float(n * 1e3 / arr.mean())
        results[int(n)] = row
    return results
