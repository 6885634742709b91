"""Serving entry point of the port: run, time or serve a model.

    # an artifact of test --export (no model code or weights needed):
    python -m myconvnet_tpu_torch.serve --artifact model.pt2 --images d/ \\
        [--config C --topk 5 --calibration calibration.json]
    python -m myconvnet_tpu_torch.serve --artifact model.pt2 --latency \\
        [--sizes 1,8,32] [--hw 224,224]
    python -m myconvnet_tpu_torch.serve --artifact seg.pt2 --segment \\
        --images d/ [--out o/] [--config C]
    python -m myconvnet_tpu_torch.serve --artifact p2p.pt2 --translate \\
        --images d/ [--out o/]
    python -m myconvnet_tpu_torch.serve --artifact flow.pt2 --flow \\
        --images d/ [--out o/]
    python -m myconvnet_tpu_torch.serve --artifact dcgan.pt2 --sample 64 \\
        [--seed 0] [--out samples.png]
    # in memory from a recipe and a checkpoint of either package:
    python -m myconvnet_tpu_torch.serve --config configs/imagenet_resnet50.py \\
        --ckpt runs/r50/ --latency [--sizes 1,8,32]
    # the HTTP server:
    python -m myconvnet_tpu_torch.serve --serve 127.0.0.1:8080 \\
        [--config C --ckpt D | --artifact A [--segment|--translate|--flow]] \\
        [--route seg=segment:seg.pt2[:configs/voc_deeplabv3plus.py] ...] \\
        [--route seg=segment:configs/voc_deeplabv3plus.py:runs/voc/ ...] \\
        [--batch 8] [--batch_window_ms 5]

Port of ``serve.py``: the one-shot modes of an artifact (``serving.
load_inference``; its fixed batch is the only bucket) for the kinds the
port exports: classify ``--images`` (host normalization with the recipe's
statistics, ``--calibration``'s temperature, ``--topk``), ``--latency``
(``:152-202``), ``--segment`` (``:392``, VOC-palette ``<name>_mask.png``),
``--flow`` (``:466``, ``<name>_a.*``/``<name>_b.*`` pairs to
``<name>_flow.png``), ``--translate`` (``:646``, ``<name>_out.png``) and
``--sample N`` (``:676``, a grid of N images from latents drawn from
``--seed`` with numpy, as JAX draws them); image directories are read by
:func:`_iter_image_chunks` (``:302``).  ``--serve`` starts the HTTP server
(``serving_http``): ``--config``/``--ckpt`` or ``--artifact`` make the
route named ``default``, each ``--route`` adds one, in either form of
``serving_http.parse_route_spec``; ``--batch_window_ms`` > 0 coalesces
concurrent requests to a route into one device call.  ``--device``
(default cuda) is where the program runs: an artifact exported for
another device type is refused.  ``--detect``, ``--depth``, ``--clips``,
``--text``, ``--wav`` and ``--track`` are refused by name (their ROADMAP
A17 families).  ``main(argv)`` returns what a mode printed, as data.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# unported one-shot modes -> their ROADMAP A17 family
UNPORTED_MODES = {"detect": "detection", "depth": "depth",
                  "clips": "video", "text": "OCR", "wav": "audio",
                  "track": "tracking"}
_IMAGE_EXTS = (".jpg", ".jpeg", ".png")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--artifact", default=None,
                    help="an artifact of test --export")
    ap.add_argument("--config", default=None, help="recipe config: the "
                    "in-memory 'default' route's (with --ckpt), or an "
                    "artifact's class names and normalization")
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint .npz or its directory (with --config)")
    ap.add_argument("--route", action="append", default=[],
                    metavar="NAME=KIND:ARTIFACT[:CONFIG]",
                    help="--serve: add a route (repeatable); "
                         "NAME=KIND:CONFIG:CKPT builds it in memory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=8,
                    help="--serve: an in-memory route's fixed batch")
    ap.add_argument("--batch_window_ms", type=float, default=0.0,
                    help="--serve: coalesce requests to a route arriving "
                         "within this window into one device call")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--images", default=None,
                    help="directory of images (classify, --segment, "
                         "--translate, --flow)")
    ap.add_argument("--calibration", default=None,
                    help="calibration.json of test --calibrate (classify "
                         "--images: the fitted softmax temperature)")
    ap.add_argument("--segment", action="store_true",
                    help="a segmentation artifact: raw [0, 1] images in, "
                         "coverage printed, <name>_mask.png written")
    ap.add_argument("--translate", action="store_true",
                    help="an image-to-image artifact (pix2pix): "
                         "<name>_out.png written")
    ap.add_argument("--flow", action="store_true",
                    help="an optical-flow artifact: <name>_a.* / "
                         "<name>_b.* pairs, <name>_flow.png written")
    ap.add_argument("--sample", type=int, default=0, metavar="N",
                    help="a latent-input generator artifact (dcgan): a "
                         "grid of N samples to --out (samples.png)")
    ap.add_argument("--seed", type=int, default=0, help="--sample: the "
                    "latents' numpy seed")
    ap.add_argument("--out", default=None,
                    help="where --segment/--translate/--flow write (the "
                         "images' directory by default) or --sample's PNG")
    ap.add_argument("--latency", action="store_true",
                    help="measure p50/p95/p99 + throughput")
    ap.add_argument("--sizes", default="1,8,32",
                    help="request sizes for --latency")
    ap.add_argument("--hw", default=None,
                    help="--latency of an artifact: H,W (must be its own)")
    ap.add_argument("--serve", metavar="HOST:PORT",
                    help="start the HTTP model server")
    ap.add_argument("--detect", action="store_true", help="not ported")
    ap.add_argument("--depth", action="store_true", help="not ported")
    ap.add_argument("--text", action="store_true", help="not ported")
    ap.add_argument("--track", action="store_true", help="not ported")
    ap.add_argument("--clips", default=None, help="not ported")
    ap.add_argument("--wav", default=None, help="not ported")
    args = ap.parse_args(argv)
    for mode, family in UNPORTED_MODES.items():
        if getattr(args, mode):
            raise SystemExit(f"serve --{mode} is not ported (ROADMAP A17's "
                             f"{family} family)")
    if args.artifact and args.ckpt:
        raise SystemExit("pass --artifact or --config/--ckpt, not both")
    if (args.config is None) != (args.ckpt is None) and not args.artifact:
        raise SystemExit("--config and --ckpt go together (a --config "
                         "alone goes with --artifact)")
    if args.latency and not args.artifact and args.ckpt is None:
        raise SystemExit("--latency needs --artifact, or --config and "
                         "--ckpt")

    from myconvnet_tpu_torch.train.cli import resolve_device

    device = resolve_device(args.device)
    if args.serve:
        return run_server(args, device)
    if args.artifact is None:
        if args.latency:
            return run_latency_in_memory(args, device)
        raise SystemExit("pass --artifact FILE, --config/--ckpt with "
                         "--latency, or --serve HOST:PORT")

    from myconvnet_tpu_torch import serving

    kind = serving.artifact_meta(args.artifact)["kind"]
    mode = ("segment" if args.segment else "translate" if args.translate
            else "flow" if args.flow else "sample" if args.sample
            else "classify")
    if kind != mode and not args.latency:
        raise SystemExit(f"{args.artifact} is a {kind!r} artifact; this "
                         f"mode serves {mode!r} ones")
    fn = serving.load_inference(args.artifact, device)
    art_shape = fn.input_shapes[0]
    if args.latency:
        return run_latency(fn, art_shape, args)
    run = {"segment": run_segment, "translate": run_translate,
           "flow": run_flow, "sample": run_sample,
           "classify": run_classify}[mode]
    return run(fn, art_shape, args)


def _print_latency(stats):
    for n, row in stats.items():
        print(f"n={n:<4d} p50={row['p50']:.2f}ms "
              f"p95={row['p95']:.2f}ms p99={row['p99']:.2f}ms "
              f"qps={row['qps']:.1f} "
              f"images/s={row['images_per_sec']:.0f}", flush=True)
    return stats


def run_latency_in_memory(args, device):
    """``--latency`` of the 'default' route built from the recipe and the
    checkpoint."""
    from myconvnet_tpu_torch import serving, serving_http

    route = serving_http.build_route(
        "default", "classify", args.config, ckpt=args.ckpt,
        batch=args.batch, device=device, topk=args.topk)
    sizes = tuple(int(s) for s in args.sizes.split(","))
    return _print_latency(serving.measure_latency(
        serving.make_batched_server(route.fn), route.input_shape[1:],
        request_sizes=sizes))


def run_latency(fn, art_shape, args):
    """``--latency`` of an artifact: its batch is the only bucket."""
    from myconvnet_tpu_torch import serving

    if args.calibration:
        print("note: --calibration has no effect on --latency (it "
              "rescales logits, not compute)", flush=True)
    if args.hw:
        hw = tuple(int(v) for v in args.hw.split(","))
        if hw != tuple(art_shape[1:3]):
            raise SystemExit(
                f"--hw {args.hw} does not match the artifact's fixed input "
                f"{art_shape}: export again for another resolution")
    sizes = tuple(int(s) for s in args.sizes.split(","))
    return _print_latency(serving.measure_latency(
        serving.make_batched_server(fn, batch_sizes=(art_shape[0],)),
        tuple(art_shape[1:]), request_sizes=sizes))


def _image_paths(images_dir, exclude_suffix=()):
    if not images_dir:
        raise SystemExit("this mode needs --images DIR")
    paths = sorted(
        os.path.join(images_dir, f) for f in os.listdir(images_dir)
        if f.lower().endswith(_IMAGE_EXTS)
        and not any(f.lower().endswith(s) for s in exclude_suffix))
    if not paths:
        raise SystemExit(f"no images under {images_dir!r}")
    return paths


def _load(path, h, w, nch=3):
    """An image file -> float32 [h, w, nch] in [0, 1] (Pillow convert, a
    BILINEAR resize, / 255)."""
    from myconvnet_tpu_torch.data.pipeline import pil_image

    image = pil_image("serve", path)
    img = image.open(path).convert("L" if nch == 1 else "RGB")
    x = np.asarray(img.resize((w, h), image.BILINEAR), np.float32) / 255.0
    return x[..., None] if nch == 1 else x


def _iter_image_chunks(images_dir, batch, h, w, exclude_suffix=(), nch=3):
    """Yield (paths, [batch, h, w, nch] raw [0, 1] float32) over every
    image of ``images_dir``, the last chunk padded with zeros to the
    artifact's batch; ``exclude_suffix`` skips this tool's own outputs."""
    paths = _image_paths(images_dir, exclude_suffix)
    for start in range(0, len(paths), batch):
        chunk_paths = paths[start:start + batch]
        chunk = np.stack([_load(p, h, w, nch) for p in chunk_paths])
        if len(chunk) < batch:
            chunk = np.concatenate(
                [chunk, np.zeros((batch - len(chunk), h, w, nch),
                                 np.float32)])
        yield chunk_paths, chunk


def _host(t):
    return t.float().cpu().numpy() if t.is_floating_point() \
        else t.cpu().numpy()


def _config(args):
    if not args.config:
        return None
    from myconvnet_tpu_torch import recipes
    return recipes.load_config(args.config)


def run_classify(fn, art_shape, args):
    """Classify the images of ``--images``: normalized on the host with
    the recipe's statistics (the ImageNet ones without ``--config``), the
    temperature of ``--calibration``, the top-k printed.  Returns [(file
    name, [(label, prob), ...]), ...]."""
    import json

    from myconvnet_tpu_torch import recipes, serving, serving_http
    from myconvnet_tpu_torch.eval.evaluators import decode_predictions

    cfg = _config(args)
    batch, h, w, nch = art_shape
    mean, std = recipes.normalization(cfg, nch)
    paths = _image_paths(args.images)
    x = (np.stack([_load(p, h, w, nch) for p in paths]) - mean) / std
    serve = serving.make_batched_server(fn, batch_sizes=(batch,))
    logits = _host(serve(x))
    if args.calibration:
        with open(args.calibration) as f:
            temp = float(json.load(f)["temperature"])
        logits = logits / temp
        print(f"(temperature-calibrated, T={temp:.3f})", flush=True)
    names = serving_http._class_names(cfg, "classify") or [
        str(i) for i in range(logits.shape[-1])]
    out = []
    for path, row in zip(paths, decode_predictions(logits, names,
                                                   args.topk)):
        print(f"{os.path.basename(path)}: "
              + ", ".join(f"{n}:{p:.2f}" for n, p in row), flush=True)
        out.append((os.path.basename(path), row))
    return out


def run_segment(fn, art_shape, args):
    """Segment the images of ``--images`` (raw [0, 1]; the artifact
    normalizes): the five largest classes' coverage and the mean
    confidence printed, ``<name>_mask.png`` (VOC palette) written.
    Returns [(file name, classes [H, W], confidence [H, W]), ...]."""
    from myconvnet_tpu_torch import serving_http
    from myconvnet_tpu_torch.utils.images import colorize_mask, save_png

    names = serving_http._class_names(_config(args), "segment")
    out_dir = args.out or args.images
    batch, h, w, _ = art_shape
    out = []
    for paths, chunk in _iter_image_chunks(args.images, batch, h, w,
                                           exclude_suffix=("_mask.png",)):
        classes, conf = (_host(t) for t in fn(chunk))
        for i, path in enumerate(paths):
            base = os.path.basename(path)
            ids, counts = np.unique(classes[i], return_counts=True)
            parts = []
            for j in np.argsort(-counts)[:5]:
                cid = int(ids[j])
                label = names[cid] if names and cid < len(names) \
                    else str(cid)
                parts.append(f"{label}:{100.0 * counts[j] / classes[i].size:.0f}%")
            dst = save_png(os.path.join(
                out_dir, os.path.splitext(base)[0] + "_mask.png"),
                colorize_mask(classes[i]))
            print(f"{base}: {', '.join(parts)} (mean conf "
                  f"{conf[i].mean():.2f}) -> {dst}", flush=True)
            out.append((base, classes[i], conf[i]))
    return out


def run_translate(fn, art_shape, args):
    """Translate the images of ``--images`` ([0, 1] in and out), each
    written as ``<name>_out.png``.  Returns [(file name, uint8 image),
    ...]."""
    from myconvnet_tpu_torch.utils.images import save_png

    out_dir = args.out or args.images
    batch, h, w, _ = art_shape
    out = []
    for paths, chunk in _iter_image_chunks(args.images, batch, h, w,
                                           exclude_suffix=("_out.png",)):
        y = _host(fn(chunk))
        for i, path in enumerate(paths):
            base = os.path.splitext(os.path.basename(path))[0]
            img = (np.clip(y[i], 0.0, 1.0) * 255).astype(np.uint8)
            dst = save_png(os.path.join(out_dir, base + "_out.png"), img)
            print(f"{os.path.basename(path)}: {h}x{w} -> "
                  f"{img.shape[0]}x{img.shape[1]} -> {dst}", flush=True)
            out.append((os.path.basename(path), img))
    return out


def run_flow(fn, art_shape, args):
    """The flow of each ``<name>_a.*`` / ``<name>_b.*`` pair of
    ``--images``: mean |flow| printed, ``<name>_flow.png`` (colour wheel)
    written.  Returns [(name, flow [H, W, 2]), ...]."""
    from myconvnet_tpu_torch.utils.images import flow_to_color, save_png

    if not args.images:
        raise SystemExit("--flow needs --images DIR with <name>_a.* / "
                         "<name>_b.* frame pairs")
    batch, h, w, _ = art_shape
    pairs = {}
    for f in sorted(os.listdir(args.images)):
        base, ext = os.path.splitext(f)
        if ext.lower() not in _IMAGE_EXTS:
            continue
        for tag in ("a", "b"):
            if base.endswith("_" + tag):
                pairs.setdefault(base[:-2], {})[tag] = os.path.join(
                    args.images, f)
    names = sorted(k for k, v in pairs.items() if "a" in v and "b" in v)
    if not names:
        raise SystemExit(f"no <name>_a/<name>_b frame pairs under "
                         f"{args.images!r}")
    out_dir = args.out or args.images
    out = []
    for start in range(0, len(names), batch):
        chunk = names[start:start + batch]
        x = np.zeros((batch, h, w, 6), np.float32)
        for i, name in enumerate(chunk):
            x[i, :, :, :3] = _load(pairs[name]["a"], h, w)
            x[i, :, :, 3:] = _load(pairs[name]["b"], h, w)
        flow = _host(fn(x))
        for i, name in enumerate(chunk):
            mag = float(np.sqrt((flow[i] ** 2).sum(-1)).mean())
            dst = save_png(os.path.join(out_dir, name + "_flow.png"),
                           flow_to_color(flow[i]))
            print(f"{name}: mean |flow| {mag:.2f}px -> {dst}", flush=True)
            out.append((name, flow[i]))
    return out


def run_sample(fn, art_shape, args):
    """``--sample N``: N latents drawn batch by batch from
    ``np.random.RandomState(--seed)``, a grid PNG to ``--out``.  Returns
    the uint8 samples."""
    from myconvnet_tpu_torch.utils.images import make_grid, save_png

    batch, z_shape = art_shape[0], tuple(art_shape[1:])
    rng = np.random.RandomState(args.seed)
    outs, need = [], args.sample
    while need > 0:
        z = rng.standard_normal((batch, *z_shape)).astype(np.float32)
        outs.append(_host(fn(z))[:min(need, batch)])
        need -= batch
    imgs = (np.clip(np.concatenate(outs), 0.0, 1.0) * 255).astype(np.uint8)
    dst = save_png(args.out or "samples.png", make_grid(imgs))
    print(f"wrote {len(imgs)} samples to {dst}", flush=True)
    return imgs


def run_server(args, device):
    """``--serve HOST:PORT``: every route in one process behind the stdlib
    HTTP server; blocks until interrupted."""
    from myconvnet_tpu_torch import serving_http

    routes = []
    if args.artifact:
        kind = ("segment" if args.segment else "translate"
                if args.translate else "flow" if args.flow else "classify")
        routes.append(serving_http.artifact_route(
            "default", kind, args.artifact, args.config, device=device,
            topk=args.topk))
    elif args.config is not None:
        routes.append(serving_http.build_route(
            "default", "classify", args.config, ckpt=args.ckpt,
            batch=args.batch, device=device, topk=args.topk))
    for spec in args.route:
        try:
            parsed = serving_http.parse_route_spec(spec)
        except ValueError as e:
            raise SystemExit(str(e)) from e
        routes.append(serving_http.route_from_spec(
            parsed, batch=args.batch, device=device, topk=args.topk))
    if not routes:
        raise SystemExit("--serve needs --config/--ckpt or a --route (or "
                         "--artifact)")
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
