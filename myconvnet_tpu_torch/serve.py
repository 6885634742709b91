"""Serving entry point of the port: latency numbers or an HTTP server.

    python -m myconvnet_tpu_torch.serve --config configs/imagenet_resnet50.py \\
        --ckpt runs/r50/ --latency [--sizes 1,8,32]
    python -m myconvnet_tpu_torch.serve --serve 127.0.0.1:8080 \\
        [--config configs/imagenet_resnet50.py --ckpt runs/r50/] \\
        [--route seg=segment:configs/voc_deeplabv3plus.py:runs/voc/ ...] \\
        [--batch 8] [--batch_window_ms 5]

``--ckpt`` is a checkpoint of either package (``ckpt-<step>.npz``, or the
directory holding them).  Port of ``serve.py:152-202`` (``--latency``) and
of its ``--serve`` path: ``--config``/``--ckpt`` make a classify route
named ``default``; each ``--route NAME=KIND:CONFIG:CKPT`` adds a route of
kind classify, segment (a DeepLabv3+ recipe), translate (a pix2pix
checkpoint's generator) or flow (a PWC-Net or FlowNet recipe), built in
memory from the recipe and the checkpoint (the exported-artifact form
``NAME=KIND:ARTIFACT[:CONFIG]`` comes with the exporters, ROADMAP A15).
``--batch_window_ms`` > 0 coalesces concurrent requests to a route into
one device call.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default=None, help="recipe config of the "
                    "'default' classify route")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint .npz or its directory")
    ap.add_argument("--route", action="append", default=[],
                    metavar="NAME=KIND:CONFIG:CKPT",
                    help="--serve: add a route (repeatable)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8,
                    help="--serve: each route's fixed batch")
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="--serve: coalesce requests to a route arriving "
                         "within this window into one device call")
    ap.add_argument("--topk", type=int, default=5)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--latency", action="store_true",
                      help="measure p50/p95/p99 + throughput")
    mode.add_argument("--serve", metavar="HOST:PORT",
                      help="start the HTTP model server")
    ap.add_argument("--sizes", default="1,8,32",
                    help="request sizes for --latency")
    args = ap.parse_args(argv)
    if (args.config is None) != (args.ckpt is None):
        raise SystemExit("--config and --ckpt go together")
    if args.latency and args.config is None:
        raise SystemExit("--latency needs --config and --ckpt")
    if args.serve and args.config is None and not args.route:
        raise SystemExit("--serve needs --config/--ckpt or a --route")

    from myconvnet_tpu_torch import serving, serving_http
    from myconvnet_tpu_torch.train.cli import resolve_device

    device = resolve_device(args.device)
    routes = []
    if args.config is not None:
        routes.append(serving_http.build_route(
            "default", "classify", args.config, ckpt=args.ckpt,
            batch=args.batch, device=device, topk=args.topk))
    if args.latency:
        route = routes[0]
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
    for spec in args.route:
        name, kind, config, ckpt = serving_http.parse_route_spec(spec)
        routes.append(serving_http.build_route(
            name, kind, config, ckpt=ckpt, batch=args.batch, device=device,
            topk=args.topk))
    host, port = args.serve.rsplit(":", 1)
    httpd = serving_http.make_http_server(
        serving_http.ModelServer(routes,
                                 batch_window_ms=args.batch_window_ms),
        host, int(port))
    print(f"serving routes {[r.name for r in routes]} on http://{host}:"
          f"{httpd.server_address[1]}"
          + (f" (batch window {args.batch_window_ms:g} ms)"
             if args.batch_window_ms > 0 else ""), flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
