"""HTTP model server on the Python stdlib: classify, segment, translate
and flow routes, with cross-request micro-batching.

Port of ``myconvnet_tpu/serving_http.py`` for the route kinds whose models
the port has:

    GET  /healthz                    -> {"status": "ok"}
    GET  /v1/models                  -> {"models": [{name, kind, ...}]}
    POST /v1/models/<name>:predict
         body: a JPEG/PNG (Content-Type image/*; needs Pillow), or JSON
         {"instances": [[H,W,C float rows], ...]} in [0, 1]
         classify  -> {"predictions": [[{"label", "prob"} x topk], ...]}
         segment   -> {"segmentations": [{"size": [H, W], "rle": [class,
                      run, ...], "coverage": {label: fraction},
                      "mean_conf"}, ...]}   (DeepLabv3+)
         translate -> {"images": [base64 PNG, ...]}   (pix2pix's U-Net;
                      [0, 1] in, [0, 1] out)
         flow      -> {"flows": [{"size", "mean_mag", "max_mag", "png"},
                      ...]}   (JSON [H, W, 6] frame pairs only)

A route is built from a recipe config plus a checkpoint of either package
(or parameter trees in memory) by :func:`build_route`, or from an artifact
of ``test --export`` by :func:`artifact_route` (``--route
NAME=KIND:ARTIFACT[:CONFIG]``; :func:`parse_route_spec` tells the two
forms apart).  A route's program is the chain JAX's exported artifact
computes (``serving.py:220-277`` for segment, ``:377-427`` with
``export_cli.py:226-240`` for translate, ``export_cli.py:355-427`` for
flow): in memory it runs eagerly on the route's device, and the port's
artifact of the same kind holds the same program (``serving``'s
``segment_program``, ``image_to_image_program``, ``normalizer``).  Each
request is first brought to the program's input space: an image body is
decoded on the host with JAX's geometry (Pillow ``convert``, then a
BILINEAR ``resize`` to the route's size), kept as uint8 and normalized on
the route's device by the ``normalize_u8`` kernel (B2), one launch a
request, with the recipe's mean and std (classify, in-memory segment) or
mean = std = 0.5 (in-memory translate: exactly ``x * 2 - 1``), or mean 0
and std 1 (segment and translate artifacts, which take [0, 1] and
normalize inside); a JSON body of raw [0, 1] rows is normalized on the
host for classify (``serving_http.py:373-374``) and inside the program on
the device for segment and translate, as JAX's artifacts do; flow takes
its rows raw.  The rows then run through the
route's fixed batch (:func:`_run_chunked`, tuple outputs sliced member by
member) under one device lock, or, with ``ModelServer(batch_window_ms >
0)``, through the route's :class:`_Batcher`, which runs the normalized
rows of concurrent requests as one device call.
"""

from __future__ import annotations

import base64
import json
import threading
import time
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from myconvnet_tpu_torch.ops.kernels.normalize_u8 import (device_stats,
                                                          normalize_u8)

KINDS = ("classify", "segment", "translate", "flow")
# the recipe task each kind serves
TASK_OF = {"classify": "classification", "segment": "segmentation",
           "translate": "gan", "flow": "flow"}


@dataclass
class Route:
    """One served model: its fixed-batch program plus request codec."""

    name: str
    kind: str
    fn: Callable                   # [B, H, W, C] input space -> outputs
    input_shape: tuple             # (B, H, W, C)
    mean: np.ndarray = None        # an image body's B2 statistics (and
    std: np.ndarray = None         # classify's host normalization)
    topk: int = 5
    device: str | torch.device = "cpu"   # where the program runs
    class_names: Optional[Sequence[str]] = None
    # raw [0, 1] float rows (a tensor on the device) -> the program's
    # input space; None: the identity (flow, artifacts) or classify's host
    # step
    pre: Optional[Callable] = None
    artifact: Optional[str] = None   # the file an artifact route serves

    def describe(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "input": list(self.input_shape),
                "classes": len(self.class_names)
                if self.class_names else None,
                **({"artifact": self.artifact} if self.artifact else {})}


class RouteSpec(NamedTuple):
    """A parsed ``--route``: a recipe ``config`` and a checkpoint
    ``ckpt``, or an ``artifact`` with an optional ``config``."""

    name: str
    kind: str
    config: Optional[str]
    ckpt: Optional[str]
    artifact: Optional[str] = None


_SPEC_FORMS = "NAME=KIND:CONFIG:CKPT or NAME=KIND:ARTIFACT[:CONFIG]"


def parse_route_spec(spec: str) -> RouteSpec:
    """``NAME=KIND:CONFIG:CKPT`` (a route built in memory from a recipe
    and a checkpoint) or ``NAME=KIND:ARTIFACT[:CONFIG]`` (an artifact of
    ``test --export``, ``serving_http.py:581-594``): the second field is
    an artifact when it is an artifact file.  A spec whose second field is
    an artifact and whose third is not a config file (``.py`` or
    ``.json``) is ambiguous and refused."""
    from myconvnet_tpu_torch.serving import is_artifact

    name, eq, rest = spec.partition("=")
    parts = rest.split(":")
    if not eq or not name or not 2 <= len(parts) <= 3 or not all(parts):
        raise ValueError(f"route spec {spec!r}: want {_SPEC_FORMS}")
    kind, first, *more = parts
    if is_artifact(first):
        if more and not more[0].endswith((".py", ".json")):
            raise ValueError(
                f"route spec {spec!r} is ambiguous: {first!r} is an "
                f"artifact, so {more[0]!r} should be its CONFIG (a .py or "
                f".json recipe), not a checkpoint; want {_SPEC_FORMS}")
        return RouteSpec(name, kind, more[0] if more else None, None, first)
    if not more:
        raise ValueError(f"route spec {spec!r}: {first!r} is not an "
                         f"artifact file and no CKPT follows; want "
                         f"{_SPEC_FORMS}")
    return RouteSpec(name, kind, first, more[0])


def route_from_spec(spec: RouteSpec, *, batch: int = 8,
                    device: str | torch.device | None = None,
                    topk: int = 5) -> "Route":
    """The route of a parsed spec: :func:`artifact_route` (on the
    artifact's device unless ``device`` is given; its batch is the
    artifact's) or :func:`build_route`."""
    if spec.artifact is not None:
        return artifact_route(spec.name, spec.kind, spec.artifact,
                              spec.config, device=device, topk=topk)
    return build_route(spec.name, spec.kind, spec.config, ckpt=spec.ckpt,
                       batch=batch, device=device or "cuda", topk=topk)


def _trees(cfg, kind, ckpt, params, state):
    from myconvnet_tpu_torch.weights import load_jax_checkpoint
    if (ckpt is None) == (params is None):
        raise ValueError("pass exactly one of ckpt or params")
    if ckpt is not None:
        fields = (("g_params", "g_state") if kind == "translate"
                  else ("params", "model_state"))
        params, state = load_jax_checkpoint(ckpt, fields)
    return params, state or {}


def _class_names(cfg, kind):
    """The recipe's class names where the port knows them
    (``serving_http.py:152-161``: Fashion-MNIST, VOC's segmentation
    classes)."""
    ds = (cfg or {}).get("dataset")
    if ds == "fashion_mnist":
        from myconvnet_tpu_torch.subsets.mnist import FASHION_CLASS_NAMES
        return FASHION_CLASS_NAMES
    if ds == "voc" and kind == "segment":
        from myconvnet_tpu_torch.subsets.voc import SEG_CLASS_NAMES
        return SEG_CLASS_NAMES
    return None


def build_route(name: str, kind: str, config: str | dict, *,
                ckpt: Optional[str] = None, params=None, state=None,
                batch: int = 8, device: str | torch.device = "cuda",
                topk: int = 5) -> Route:
    """Build the recipe's model, load a checkpoint of either package
    (``ckpt``; a GAN checkpoint's generator for translate) or parameter
    trees (``params``, ``state``) into it, and wrap its program as a route
    of kind ``kind`` with a fixed batch of ``batch``."""
    from myconvnet_tpu_torch import models, recipes, serving
    from myconvnet_tpu_torch.core.precision import get_policy

    if kind not in KINDS:
        raise ValueError(f"route {name!r}: the port serves {KINDS}, not "
                         f"{kind!r}")
    cfg = recipes.load_config(config) if isinstance(config, str) \
        else dict(config)
    task = cfg.get("task", "classification")
    if kind == "translate" and task == "gan" \
            and cfg.get("gan_kind", "dcgan") != "pix2pix":
        # a latent-input generator is a sampler, not a route
        # (serving_http.py:106-120)
        raise ValueError(
            f"route {name!r}: a {cfg.get('gan_kind', 'dcgan')} generator "
            "takes [N, latent] latents, not [N, H, W, C] images — "
            "'translate' routes serve image-to-image generators only")
    if task != TASK_OF[kind]:
        raise ValueError(f"route {name!r}: a {kind} route serves a "
                         f"{TASK_OF[kind]} recipe, not {task!r}")
    params, state = _trees(cfg, kind, ckpt, params, state)
    policy = get_policy(cfg.get("precision", "f32"))
    device = torch.device(device)
    mean = std = pre = None
    if kind == "classify":
        h, w = cfg.get("input_hw", (224, 224))
        model = models.get_model(cfg["model"], cfg["num_classes"],
                                 input_hw=(h, w),
                                 **cfg.get("model_kwargs", {}))
        fn = serving.make_inference_fn(model, params, state, device=device,
                                       policy=policy)
        mean, std = recipes.normalization(cfg, 3)
        nch = 3
    elif kind == "segment":
        aug = recipes.make_augment(cfg.get("augment"))
        h, w = aug.out_hw if aug is not None else cfg["input_hw"]
        model = models.get_model(cfg["model"], cfg["num_classes"],
                                 input_hw=(h, w),
                                 **cfg.get("model_kwargs", {}))
        fn = serving.segment_program(serving.make_inference_fn(
            model, params, state, device=device, policy=policy), (h, w))
        mean, std = recipes.normalization(cfg, 3)
        nch = 3
    elif kind == "translate":
        from myconvnet_tpu_torch import recipes_gan
        h = w = int(cfg.get("image_size", 256))
        fn = serving.image_to_image_program(serving.make_inference_fn(
            recipes_gan.gan_generator(cfg), params, state, fold_bn=False,
            device=device, policy=policy), post=serving.from_tanh)
        mean = std = np.full(3, 0.5, np.float32)
        nch = 3
    else:
        h, w = cfg.get("input_hw", (384, 512))
        model = models.FLOW_MODELS[cfg["model"]](
            0, **cfg.get("model_kwargs", {}))
        fn = serving.make_inference_fn(model, params, state, fold_bn=False,
                                       device=device, policy=policy)
        nch = 6
    if kind in ("segment", "translate"):
        pre = serving.normalizer(mean, std, device)
    return Route(name=name, kind=kind, fn=fn, input_shape=(batch, h, w, nch),
                 mean=mean, std=std, topk=topk, device=device,
                 class_names=_class_names(cfg, kind), pre=pre)


def artifact_route(name: str, kind: str, artifact: str,
                   config: Optional[str | dict] = None, *,
                   device: str | torch.device | None = None,
                   topk: int = 5) -> Route:
    """A route of kind ``kind`` over an artifact of ``test --export``
    (``serving_http.py:95-150``): its program and fixed batch are the
    artifact's, and no model code is loaded.  ``config`` (optional) gives
    the class names and, for classify, the normalization (the ImageNet
    statistics without it, as JAX's ``AugmentConfig`` defaults).  Segment
    and translate artifacts take raw [0, 1] rows, so an image body goes
    through B2 with mean 0 and std 1 (``x / 255``); a JSON body reaches
    the artifact as it came."""
    from myconvnet_tpu_torch import recipes, serving

    if kind not in KINDS:
        raise ValueError(f"route {name!r}: the port serves {KINDS}, not "
                         f"{kind!r}")
    art = serving.artifact_meta(artifact)["kind"]
    if art == "sample":
        raise ValueError(
            f"route {name!r}: {artifact} is a latent-input generator "
            "(dcgan) — a sampler for serve --sample, not a route")
    if art != kind:
        raise ValueError(f"route {name!r}: {artifact} is a {art!r} "
                         f"artifact, not {kind!r}")
    fn = serving.load_inference(artifact, device)
    shape = fn.input_shapes[0]
    cfg = recipes.load_config(config) if isinstance(config, str) \
        else config
    mean = std = None
    if kind == "classify":
        mean, std = recipes.normalization(cfg, shape[3])
    elif kind in ("segment", "translate"):
        mean = np.zeros(shape[3], np.float32)
        std = np.ones(shape[3], np.float32)
    return Route(name=name, kind=kind, fn=fn, input_shape=tuple(shape),
                 mean=mean, std=std, topk=topk, device=fn.device,
                 class_names=_class_names(cfg, kind), artifact=artifact)


def _host(t: torch.Tensor, n: int) -> np.ndarray:
    t = t[:n]
    return (t.float() if t.is_floating_point() else t).cpu().numpy()


def _run_chunked(fn, x, batch: int):
    """Pad/chunk a request of any size (a numpy array or a tensor) through
    the route's fixed batch; a tuple output comes back as a tuple of
    numpy arrays, each member sliced to the request's rows."""
    x = torch.as_tensor(x)
    outs = []
    for i in range(0, len(x), batch):
        chunk = x[i:i + batch]
        n = len(chunk)
        if n < batch:
            chunk = torch.cat([chunk,
                               chunk.new_zeros((batch - n, *x.shape[1:]))])
        out = fn(chunk)
        outs.append(tuple(_host(t, n) for t in out)
                    if isinstance(out, tuple) else _host(out, n))
    if isinstance(outs[0], tuple):
        return tuple(np.concatenate(ts) for ts in zip(*outs))
    return np.concatenate(outs)


def _rle_encode(flat: np.ndarray) -> list:
    """Row-major run-length encoding: [class, run, class, run, ...];
    ``np.repeat(rle[0::2], rle[1::2]).reshape(size)`` decodes it."""
    if flat.size == 0:
        return []
    starts = np.concatenate([[0], np.flatnonzero(np.diff(flat)) + 1])
    runs = np.diff(np.concatenate([starts, [flat.size]]))
    out = np.empty(2 * len(starts), np.int64)
    out[0::2] = flat[starts]
    out[1::2] = runs
    return out.tolist()


def _class_coverage(cls: np.ndarray, names=None, top: int = 5) -> dict:
    """The ``top`` most frequent classes' shares of the map."""
    ids, counts = np.unique(cls, return_counts=True)
    cov = {}
    for j in np.argsort(-counts)[:top]:
        cid = int(ids[j])
        label = names[cid] if names and cid < len(names) else str(cid)
        cov[label] = round(float(counts[j]) / cls.size, 4)
    return cov


class _Batcher:
    """Cross-request micro-batching: requests to one route within a
    window run as ONE device call.

    Leader-collects (``serving_http.py:207-258``): the first request into
    an empty epoch leads, sleeps the window while followers append their
    rows, closes the epoch under the mutex, runs the concatenated rows
    once and wakes the followers, each slicing its own rows out of every
    member of the output.  The leader's failure reaches each follower as
    ``RuntimeError("batched device call failed: ...")``.
    """

    def __init__(self, run, window_s: float):
        self.run = run          # fn(rows) -> outputs (an array or a tuple)
        self.window = window_s
        self._mu = threading.Lock()
        self._epoch = None

    def submit(self, x):
        with self._mu:
            epoch = self._epoch
            lead = epoch is None
            if lead:
                epoch = {"xs": [], "done": threading.Event(),
                         "outs": None, "err": None}
                self._epoch = epoch
            idx = len(epoch["xs"])
            epoch["xs"].append(x)
        if lead:
            time.sleep(self.window)
            with self._mu:
                self._epoch = None      # the epoch is closed; a new opens
            try:
                epoch["outs"] = self.run(epoch["xs"])
            except BaseException as e:  # wake the followers with it
                epoch["err"] = e
                raise
            finally:
                epoch["done"].set()
        else:
            epoch["done"].wait()
            if epoch["err"] is not None:
                raise RuntimeError(
                    f"batched device call failed: {epoch['err']}")
        rows = slice(sum(len(a) for a in epoch["xs"][:idx]),
                     sum(len(a) for a in epoch["xs"][:idx + 1]))
        out = epoch["outs"]
        return (tuple(t[rows] for t in out) if isinstance(out, tuple)
                else out[rows])


class ModelServer:
    """The route table + device lock; http handlers delegate here.

    ``batch_window_ms > 0`` gives every route a :class:`_Batcher`:
    concurrent requests within the window run as one device call instead
    of one each through the lock."""

    def __init__(self, routes: Sequence[Route],
                 batch_window_ms: float = 0.0):
        if not routes:
            raise ValueError("no routes")
        self.routes = {r.name: r for r in routes}
        if len(self.routes) != len(routes):
            raise ValueError("duplicate route names")
        self._lock = threading.Lock()
        # each route's (mean, std) as float32 tensors on its device
        self._stats = {}
        self._batchers = {}
        if batch_window_ms > 0:
            for r in self.routes.values():
                self._batchers[r.name] = _Batcher(self._runner(r),
                                                  batch_window_ms / 1e3)

    def _runner(self, route: Route):
        def run(xs):
            with self._lock:
                x = xs[0] if len(xs) == 1 else torch.cat(
                    [torch.as_tensor(a).to(route.device) for a in xs])
                return _run_chunked(route.fn, x, route.input_shape[0])
        return run

    def _prepare(self, route: Route, x: np.ndarray):
        """A decoded request -> the program's input rows: uint8 through B2
        on the route's device (one launch), float rows through the route's
        ``pre`` on the device (classify's were normalized on the host)."""
        if x.dtype == np.uint8:
            if route.name not in self._stats:
                self._stats[route.name] = device_stats(
                    route.mean, route.std, route.device)
            return normalize_u8(torch.from_numpy(x).to(route.device),
                                *self._stats[route.name])
        if route.pre is None:
            return x
        return route.pre(torch.from_numpy(x).to(route.device))

    def _execute(self, route: Route, x: np.ndarray):
        """The route's outputs of a decoded request: prepared under the
        device lock, then one device call of its own or a share of the
        micro-batcher's."""
        b = self._batchers.get(route.name)
        with self._lock:
            x = self._prepare(route, x)
            if b is None:
                return _run_chunked(route.fn, x, route.input_shape[0])
        return b.submit(x)

    def _decode_body(self, route: Route, body: bytes,
                     content_type: str) -> np.ndarray:
        """An image body -> uint8 [1, h, w, C] (``serving_http.py:300-
        329``'s geometry, before its normalize); a JSON body -> float32
        [N, h, w, C] in [0, 1]."""
        h, w, nch = route.input_shape[1:]
        if content_type.startswith("image/"):
            if route.kind == "flow":
                raise ValueError(
                    f"flow routes take JSON instances of [H, W, {nch}] "
                    "blobs (two stacked frames), not a single image")
            import io

            from myconvnet_tpu_torch.data.pipeline import pil_image
            image = pil_image("the image route", "the request body")
            img = image.open(io.BytesIO(body)).convert(
                "L" if nch == 1 else "RGB")
            img = img.resize((w, h), image.BILINEAR)
            x = np.array(img, np.uint8)[None]   # a writable copy
            return x[..., None] if nch == 1 else x
        payload = json.loads(body.decode("utf-8"))
        if not isinstance(payload, dict) or "instances" not in payload:
            raise ValueError('JSON body needs an "instances" list')
        x = np.asarray(payload["instances"], np.float32)
        if x.ndim == 3:
            x = x[None]
        if x.ndim != 4 or x.shape[1:] != (h, w, nch):
            raise ValueError(
                f"instances shape {x.shape} != [N, {h}, {w}, {nch}]")
        return x

    def predict(self, name: str, body: bytes,
                content_type: str = "application/json") -> dict:
        route = self.routes.get(name)
        if route is None:
            raise KeyError(name)
        x = self._decode_body(route, body, content_type)
        if route.kind == "classify":
            from myconvnet_tpu_torch.eval.evaluators import \
                decode_predictions
            if x.dtype != np.uint8:
                x = (x - route.mean) / route.std
            logits = self._execute(route, x)
            names = route.class_names or [
                str(i) for i in range(logits.shape[-1])]
            rows = decode_predictions(logits, names, route.topk)
            return {"predictions": [
                [{"label": n, "prob": round(float(p), 6)} for n, p in row]
                for row in rows]}
        if route.kind == "segment":
            classes, conf = self._execute(route, x)
            return {"segmentations": [{
                "size": list(c.shape),
                "rle": _rle_encode(c.reshape(-1)),
                "coverage": _class_coverage(c, route.class_names),
                "mean_conf": round(float(np.mean(p)), 4)}
                for c, p in zip(classes, conf)]}
        from myconvnet_tpu_torch.utils.images import png_bytes
        if route.kind == "translate":
            out = self._execute(route, x)
            return {"images": [base64.b64encode(png_bytes(
                (np.clip(y, 0.0, 1.0) * 255).astype(np.uint8))).decode(
                    "ascii") for y in out]}
        from myconvnet_tpu_torch.utils.images import flow_to_color
        f = np.asarray(self._execute(route, x), np.float32)
        out = []
        for fi in f:
            mag = np.sqrt((fi ** 2).sum(-1))
            out.append({
                "size": list(fi.shape[:2]),
                "mean_mag": round(float(mag.mean()), 4),
                "max_mag": round(float(mag.max()), 4),
                "png": base64.b64encode(png_bytes(flow_to_color(
                    fi))).decode("ascii")})
        return {"flows": out}

    def models(self) -> dict:
        return {"models": [r.describe() for r in self.routes.values()]}


def make_http_server(server: ModelServer, host: str = "127.0.0.1",
                     port: int = 0) -> ThreadingHTTPServer:
    """Bind the route table to a ThreadingHTTPServer (port 0 = ephemeral;
    read the bound port off ``httpd.server_address``).  The caller owns
    the serve_forever thread and shutdown."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet: the CLI prints its own line
            pass

        def _send(self, code: int, payload: dict):
            blob = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(blob)))
            self.end_headers()
            self.wfile.write(blob)

        def do_GET(self):
            if self.path == "/healthz":
                return self._send(200, {"status": "ok"})
            if self.path == "/v1/models":
                return self._send(200, server.models())
            return self._send(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            path = self.path.split("?", 1)[0]
            if not (path.startswith("/v1/models/")
                    and path.endswith(":predict")):
                return self._send(404, {"error": f"no route {path}"})
            name = path[len("/v1/models/"):-len(":predict")]
            body = self.rfile.read(int(self.headers.get("Content-Length",
                                                        0)))
            ctype = self.headers.get("Content-Type", "application/json")
            try:
                result = server.predict(name, body, ctype)
            except KeyError:
                return self._send(404, {"error": f"no model {name!r}"})
            except (ValueError, OSError) as e:  # bad payload
                return self._send(400, {"error": str(e)})
            return self._send(200, result)

    return ThreadingHTTPServer((host, port), Handler)
