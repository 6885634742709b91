#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Needs CUDA and this checkout; prints the card (nvidia-smi name and
   power limit), the torch and nvcc versions.
2. Builds the hand-written kernels from ``myconvnet_tpu_torch/csrc`` and
   prints the build time.
3. Holds each kernel against its plain PyTorch version at every shape the
   served ResNet-50 gives it (batch 8, 224x224): max error against the
   stated tolerance, and both times from CUDA events (plus the unfused
   cuDNN bf16 pair, for conv_pair).
4. Builds ResNet-50 at full width from ``configs/imagenet_resnet50.py``
   with random weights made from a seed in the JAX layout, loads them
   through ``weights.from_jax``, folds BN, and serves a classify route
   over HTTP on localhost.
5. Sends 3 predict requests (JSON bodies of 1, 3 and 8 images), counts the
   kernel launches they cause (13 conv_pair and 7 bn_act per device call)
   and checks the logits against the plain path (the same module on the
   host CPU, where each wrapper runs its plain version).
6. Prints measure_latency p50 for request sizes 1 and 8 (measured before
   the host reference of step 5 runs).

Exits non-zero on any failure.  The second-to-last line of stdout is the
kernels' JSON record, the last ``{"ok": true, "device": {...}}``.  Details
go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "imagenet_resnet50.py")
SEED = 0
BATCH = 8

# conv_pair sites of ResNet-50 at 224, batch 8: (n, h, w, cin, cm, cout)
# and how many blocks of one forward run at that shape
PAIR_SITES = [((BATCH, 56, 56, 64, 64, 64), 1),       # stage1.block1
              ((BATCH, 56, 56, 256, 64, 64), 2),      # stage1.block2-3
              ((BATCH, 28, 28, 512, 128, 128), 3),    # stage2.block2-4
              ((BATCH, 14, 14, 1024, 256, 256), 5),   # stage3.block2-6
              ((BATCH, 7, 7, 2048, 512, 512), 2)]     # stage4.block2-3
# bn_act sites: the conv outputs [n, h, w, c] that get bias + ReLU
ACT_SITES = [("stem.conv", (BATCH, 112, 112, 64)),
             ("stage2.block1.conv_a", (BATCH, 56, 56, 128)),
             ("stage2.block1.conv_b", (BATCH, 28, 28, 128)),
             ("stage3.block1.conv_a", (BATCH, 28, 28, 256)),
             ("stage3.block1.conv_b", (BATCH, 14, 14, 256)),
             ("stage4.block1.conv_a", (BATCH, 14, 14, 512)),
             ("stage4.block1.conv_b", (BATCH, 7, 7, 512))]
PER_CALL = {"conv_pair": 13, "bn_act": 7}
# kernel vs plain: bn_act rounds like its plain version (bit-exact
# expected; 1 bf16 ulp allowed); conv_pair sums in another order, which
# can flip the bf16 intermediate by an ulp (2 bf16 ulps allowed)
TOL = {"bn_act": dict(rtol=2 ** -8, atol=1e-6),
       "conv_pair": dict(rtol=2 ** -6, atol=2 ** -7)}
# served logits (bf16 on the card) vs the plain path on the host, as a
# fraction of max |logit|: the CPU test of the same comparison against JAX
# holds 0.05 (tests/test_torch_resnet.py)
LOGIT_REL_TOL = 0.05
SOURCES = {"conv_pair": ("myconvnet_tpu_torch/csrc/conv_pair.cu",
                         "myconvnet_tpu/ops/pallas/conv_pair.py:101"),
           "bn_act": ("myconvnet_tpu_torch/csrc/bn_act.cu",
                      "myconvnet_tpu/ops/pallas/bn_act.py:48")}


def log(*a):
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def cuda_ms(fn, iters=20, warmup=3, sleep_cycles=20_000_000):
    """Device ms per call of ``fn``.  A sleep kernel holds the stream while
    the host enqueues every call, so the events time the launches back to
    back on the device, not the host's launch rate (a small kernel takes
    less time on the card than its Python wrapper takes on the host)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():  # the device caught up with the host: sleep longer
        torch.cuda.synchronize()
        if sleep_cycles >= 10 ** 9:
            raise RuntimeError("the host enqueues too slowly to time fn")
        return cuda_ms(fn, iters, 0, 4 * sleep_cycles)
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(out, ref, rtol, atol):
    """(max |out - ref|, whether every element is within atol + rtol|ref|)."""
    import torch
    d = (out.float() - ref.float()).abs()
    ok = bool(torch.all(d <= atol + rtol * ref.float().abs()))
    return float(d.max()), ok


def check_kernels(dev):
    """Kernel vs plain at every slice shape; returns the per-kernel
    summary (times summed over one batch-8 forward) and the details."""
    import torch
    import torch.nn.functional as F

    from myconvnet_tpu_torch.ops.kernels import bn_act, conv_pair

    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def unfused_bf16(x, w1, s1, b1, w3, s3, b3):
        """The cuDNN bf16 pair with eager epilogues, for timing only."""
        def conv(v, w, pad):
            return F.conv2d(v.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                            padding=pad)
        y = torch.relu(conv(x, w1, 0) * s1[:, None, None]
                       + b1[:, None, None]).to(torch.bfloat16)
        z = torch.relu(conv(y.permute(0, 2, 3, 1), w3, 1)
                       * s3[:, None, None] + b3[:, None, None])
        return z.to(torch.bfloat16).permute(0, 2, 3, 1)

    details, summary = [], {}
    for (n, h, w, cin, cm, co), count in PAIR_SITES:
        x = randn(n, h, w, cin).to(torch.bfloat16)
        w1 = randn(cm, 1, 1, cin, scale=cin ** -0.5).to(
            torch.bfloat16).permute(1, 2, 3, 0)
        w3 = randn(co, 3, 3, cm, scale=(9 * cm) ** -0.5).to(
            torch.bfloat16).permute(1, 2, 3, 0)
        s1, s3 = randn(cm).abs() + 0.5, randn(co).abs() + 0.5
        b1, b3 = randn(cm, scale=0.3), randn(co, scale=0.3)
        args = (x, w1, s1, b1, w3, s3, b3)
        out = conv_pair.conv1x1_conv3x3_bn_relu(*args)
        ref = conv_pair.conv_pair_reference(*args)
        torch.cuda.synchronize()
        err, ok = compare(out, ref, **TOL["conv_pair"])
        row = dict(kernel="conv_pair", shape=[n, h, w, cin, cm, co],
                   sites=count, max_abs_err=err, ok=ok,
                   plan=conv_pair.plan(n, h, w, cin, cm, co),
                   ms=cuda_ms(lambda: conv_pair.conv1x1_conv3x3_bn_relu(
                       *args)),
                   plain_ms=cuda_ms(lambda: conv_pair.conv_pair_reference(
                       *args)),
                   cudnn_bf16_ms=cuda_ms(lambda: unfused_bf16(*args)))
        details.append(row)
        log(f"conv_pair {row['shape']} x{count} plan {row['plan']}: "
            f"max_abs_err={err:.3g} "
            f"(tol rtol={TOL['conv_pair']['rtol']:.3g} "
            f"atol={TOL['conv_pair']['atol']:.3g}) ok={ok} "
            f"kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}ms "
            f"cudnn_bf16_unfused={row['cudnn_bf16_ms']:.4f}ms")
    for site, shape in ACT_SITES:
        x = randn(*shape).to(torch.bfloat16)
        c = shape[-1]
        a, b = torch.ones(c, device=dev), randn(c, scale=0.5)
        out = bn_act.fused_scale_shift_act(x, a, b, "relu")
        ref = bn_act.scale_shift_act_reference(x, a, b, "relu")
        torch.cuda.synchronize()
        err, ok = compare(out, ref, **TOL["bn_act"])
        row = dict(kernel="bn_act", site=site, shape=list(shape), sites=1,
                   max_abs_err=err, ok=ok,
                   ms=cuda_ms(lambda: bn_act.fused_scale_shift_act(
                       x, a, b, "relu")),
                   plain_ms=cuda_ms(lambda: bn_act.scale_shift_act_reference(
                       x, a, b, "relu")))
        details.append(row)
        log(f"bn_act {site} {list(shape)}: max_abs_err={err:.3g} "
            f"(tol rtol={TOL['bn_act']['rtol']:.3g} "
            f"atol={TOL['bn_act']['atol']:.3g}) ok={ok} "
            f"kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}ms")
    for name in SOURCES:
        rows = [r for r in details if r["kernel"] == name]
        summary[name] = dict(
            ok=all(r["ok"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] * r["sites"] for r in rows),
            plain_ms=sum(r["plain_ms"] * r["sites"] for r in rows))
    return summary, details


def post(url, body):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type":
                                          "application/json"})
    # no proxy from the environment: the server is on this host
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=300) as r:
        return json.load(r)


def serve_and_check(dev):
    """Drive the served main path; returns (launch counts, checks)."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import models, recipes, serving, serving_http
    from myconvnet_tpu_torch.core.precision import get_policy
    from myconvnet_tpu_torch.ops import kernels
    from myconvnet_tpu_torch.weights import random_jax_params

    cfg = recipes.load_config(CONFIG)
    h, w = cfg["input_hw"]
    template = models.get_model(cfg["model"], cfg["num_classes"],
                                **cfg["model_kwargs"])
    params, state = random_jax_params(template, SEED)
    t0 = time.perf_counter()
    route = serving_http.build_route("resnet50", "classify", CONFIG,
                                     params=params, state=state,
                                     batch=BATCH, device=dev)
    log(f"route built (from_jax + fold + to {dev}): "
        f"{time.perf_counter() - t0:.2f}s, policy={cfg['precision']}, "
        f"input {route.input_shape}")
    server = serving_http.ModelServer([route])
    httpd = serving_http.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/v1/models/resnet50:predict")
    rs = np.random.RandomState(SEED)
    images = {n: rs.rand(n, h, w, 3).astype(np.float32) for n in (1, 3, 8)}
    bodies = {n: json.dumps({"instances": x.tolist()}).encode()
              for n, x in images.items()}
    post(url, bodies[1])  # warm-up request (cuDNN autotuning, allocator)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    replies, calls = {}, 0
    try:
        for n, body in bodies.items():
            t0 = time.perf_counter()
            replies[n] = post(url, body)
            log(f"predict n={n}: {len(replies[n]['predictions'])} rows in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (HTTP, JSON "
                f"decode included); top-1 "
                f"{replies[n]['predictions'][0][0]}")
            calls += -(-n // BATCH)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    log(f"launch counts over {calls} device calls: {counts}")
    checks = {}
    for name, per in PER_CALL.items():
        if counts[name] != per * calls:
            raise AssertionError(f"{name}: {counts[name]} launches, want "
                                 f"{per} x {calls} device calls")
        log(f"{name}: {counts[name] // calls} launches per device call "
            f"(want {per}) ok")
    for n, rep in replies.items():
        rows = rep["predictions"]
        if len(rows) != n or any(len(r) != route.topk for r in rows):
            raise AssertionError(f"reply to n={n} has the wrong shape")
        if not all(0.0 <= e["prob"] <= 1.0 for r in rows for e in r):
            raise AssertionError(f"reply to n={n} has bad probabilities")

    # latency before the host reference below, whose CPU threads would
    # compete with the serving thread
    lat = serving.measure_latency(serving.make_batched_server(route.fn),
                                  (h, w, 3), request_sizes=(1, 8),
                                  iters=30, warmup=3)
    for n, row in lat.items():
        log(f"measure_latency n={n}: p50={row['p50']:.3f}ms "
            f"p95={row['p95']:.3f}ms mean={row['mean']:.3f}ms "
            f"images/s={row['images_per_sec']:.1f}")
    checks["latency_ms"] = {n: row for n, row in lat.items()}

    # logits on the card vs the plain path (same trees, host CPU)
    x = (images[8] - route.mean) / route.std
    card = route.fn(x).float().cpu().numpy()
    host = serving.make_inference_fn(
        models.get_model(cfg["model"], cfg["num_classes"]), params, state,
        device="cpu", policy=get_policy(cfg["precision"]))
    plain = host(x).float().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    top1 = float((card.argmax(1) == plain.argmax(1)).mean())
    finite = bool(np.isfinite(card).all())
    log(f"logits {card.shape}: finite={finite} max|card-plain|/max|plain|"
        f"={rel:.4g} (tol {LOGIT_REL_TOL}) top-1 agreement={top1:.3f} "
        f"max|logit|={np.abs(plain).max():.3g}")
    if not finite or card.shape != (BATCH, cfg["num_classes"]) \
            or rel > LOGIT_REL_TOL:
        raise AssertionError("served logits disagree with the plain path")
    checks.update(logit_rel_err=rel, top1_agreement=top1)

    return counts, calls, checks


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from myconvnet_tpu_torch.core.precision import FULL, \
            apply_backend_flags
        from myconvnet_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here ({e}); run from "
              "a checkout of the repo", file=sys.stderr)
        return 1
    if not os.path.exists(CONFIG):
        print(f"chip_smoke: {CONFIG} is missing", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    log(card)
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvcc[-1] if nvcc else 'nvcc ?'}")
    # plain versions are the float32 references: true float32 on the card
    apply_backend_flags(FULL)

    t0 = time.perf_counter()
    lib_path, compile_s = _build.build()
    _build.library()
    log(f"kernels built: {lib_path.relative_to(ROOT)} compile "
        f"{compile_s:.1f}s, build+load {time.perf_counter() - t0:.1f}s")

    summary, details = check_kernels(dev)
    counts, calls, checks = serve_and_check(dev)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": counts[name],
         "max_abs_err": summary[name]["max_abs_err"],
         "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"]}
        for name in SOURCES]}
    bad = [n for n, s in summary.items() if not s["ok"]]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernels": record["kernels"], "per_shape": details,
                   "device_calls": calls, "checks": checks,
                   "failed": bad}, f, indent=1)
    if bad:
        raise AssertionError(f"kernels outside tolerance: {bad}")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
