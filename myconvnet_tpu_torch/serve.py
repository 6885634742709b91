"""Serving entry point of the port: latency numbers or an HTTP server.

    python -m myconvnet_tpu_torch.serve --config configs/imagenet_resnet50.py \\
        --ckpt runs/r50/ --latency [--sizes 1,8,32]
    python -m myconvnet_tpu_torch.serve --config configs/imagenet_resnet50.py \\
        --ckpt runs/r50/ --serve 127.0.0.1:8080 [--batch 8]

``--ckpt`` is a JAX checkpoint (``ckpt-<step>.npz``, or the directory
holding them).  Port of ``serve.py:152-202`` (``--latency``) and of its
``--serve`` path for one classify route named ``default``.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True, help="recipe config")
    ap.add_argument("--ckpt", required=True,
                    help="JAX checkpoint .npz or its directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8,
                    help="--serve: the route's fixed batch")
    ap.add_argument("--topk", type=int, default=5)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--latency", action="store_true",
                      help="measure p50/p95/p99 + throughput")
    mode.add_argument("--serve", metavar="HOST:PORT",
                      help="start the HTTP model server")
    ap.add_argument("--sizes", default="1,8,32",
                    help="request sizes for --latency")
    args = ap.parse_args(argv)

    from myconvnet_tpu_torch import serving, serving_http

    route = serving_http.build_route(
        "default", "classify", args.config, ckpt=args.ckpt,
        batch=args.batch, device=args.device, topk=args.topk)
    if args.latency:
        sizes = tuple(int(s) for s in args.sizes.split(","))
        stats = serving.measure_latency(
            serving.make_batched_server(route.fn), route.input_shape[1:],
            request_sizes=sizes)
        for n, row in stats.items():
            print(f"n={n:<4d} p50={row['p50']:.2f}ms "
                  f"p95={row['p95']:.2f}ms p99={row['p99']:.2f}ms "
                  f"qps={row['qps']:.1f} "
                  f"images/s={row['images_per_sec']:.0f}")
        return
    host, port = args.serve.rsplit(":", 1)
    httpd = serving_http.make_http_server(
        serving_http.ModelServer([route]), host, int(port))
    print(f"serving route 'default' on http://{host}:"
          f"{httpd.server_address[1]}", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
