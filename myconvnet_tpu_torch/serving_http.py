"""HTTP model server on the Python stdlib, classify routes.

Port of the classify path of ``myconvnet_tpu/serving_http.py``:

    GET  /healthz                    -> {"status": "ok"}
    GET  /v1/models                  -> {"models": [{name, kind, ...}]}
    POST /v1/models/<name>:predict
         body: a JPEG/PNG (Content-Type image/*; needs Pillow), or JSON
         {"instances": [[H,W,C float rows], ...]} in [0, 1]
         -> {"predictions": [[{"label", "prob"} x topk], ...]}

``ModelServer.predict`` decodes the body and normalizes it with the
recipe's mean/std: an image body is decoded on the host with JAX's
geometry (Pillow ``convert``, then a BILINEAR ``resize`` to the route's
size), kept as uint8 and normalized on the route's device by the
``normalize_u8`` kernel, one launch a request (a quarter of float32's bytes
cross to the device); a JSON body is normalized on the host in float32, as
JAX does (``serving_http.py:373-374``).  It then runs the route's
fixed-batch program through :func:`_run_chunked` under one device lock and
decodes the top-k.  A route is built from a recipe config plus a JAX
checkpoint, or plus parameter trees in memory.  The other route kinds, the micro-batcher and
loading an exported artifact come with later slices.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from myconvnet_tpu_torch.ops.kernels.normalize_u8 import (device_stats,
                                                          normalize_u8)

KINDS = ("classify",)


@dataclass
class Route:
    """One served model: its fixed-batch program plus request codec."""

    name: str
    kind: str
    fn: Callable                   # [B, H, W, C] -> [B, classes] tensor
    input_shape: tuple             # (B, H, W, C)
    mean: np.ndarray = None
    std: np.ndarray = None
    topk: int = 5
    device: str | torch.device = "cpu"   # where an image body is normalized

    def describe(self) -> dict:
        return {"name": self.name, "kind": self.kind,
                "input": list(self.input_shape)}


def build_route(name: str, kind: str, config: str | dict, *,
                ckpt: Optional[str] = None, params=None, state=None,
                batch: int = 8, device: str | torch.device = "cuda",
                topk: int = 5) -> Route:
    """Build the recipe's model, load a JAX checkpoint (``ckpt``) or
    parameter trees (``params``, ``state``) into it, and wrap its
    inference function as a route with a fixed batch of ``batch``."""
    from myconvnet_tpu_torch import models, recipes, serving
    from myconvnet_tpu_torch.core.precision import get_policy
    from myconvnet_tpu_torch.weights import load_jax_checkpoint

    if kind not in KINDS:
        raise ValueError(f"route {name!r}: the port serves {KINDS}, not "
                         f"{kind!r}")
    cfg = recipes.load_config(config) if isinstance(config, str) \
        else dict(config)
    if (ckpt is None) == (params is None):
        raise ValueError("pass exactly one of ckpt or params")
    if ckpt is not None:
        params, state = load_jax_checkpoint(ckpt)
    h, w = cfg.get("input_hw", (224, 224))
    model = models.get_model(cfg["model"], cfg["num_classes"],
                             **cfg.get("model_kwargs", {}))
    fn = serving.make_inference_fn(
        model, params, state or {}, device=device,
        policy=get_policy(cfg.get("precision", "f32")))
    mean, std = recipes.normalization(cfg, 3)
    return Route(name=name, kind=kind, fn=fn, input_shape=(batch, h, w, 3),
                 mean=mean, std=std, topk=topk, device=device)


def _run_chunked(fn, x, batch: int) -> np.ndarray:
    """Pad/chunk a request of any size (a numpy array or a tensor) through
    the route's fixed batch."""
    x = torch.as_tensor(x)
    outs = []
    for i in range(0, len(x), batch):
        chunk = x[i:i + batch]
        n = len(chunk)
        if n < batch:
            chunk = torch.cat([chunk,
                               chunk.new_zeros((batch - n, *x.shape[1:]))])
        out = fn(chunk)
        outs.append(out[:n].float().cpu().numpy())
    return np.concatenate(outs)


class ModelServer:
    """The route table + device lock; http handlers delegate here."""

    def __init__(self, routes: Sequence[Route]):
        if not routes:
            raise ValueError("no routes")
        self.routes = {r.name: r for r in routes}
        if len(self.routes) != len(routes):
            raise ValueError("duplicate route names")
        self._lock = threading.Lock()
        # each route's (mean, std) as float32 tensors on its device
        self._stats = {}

    def _execute(self, route: Route, x: np.ndarray) -> np.ndarray:
        """The route's outputs of a float32 request, or of a uint8 one
        normalized on the route's device first (one normalize_u8 launch)."""
        with self._lock:
            if x.dtype == np.uint8:
                if route.name not in self._stats:
                    self._stats[route.name] = device_stats(
                        route.mean, route.std, route.device)
                x = normalize_u8(torch.from_numpy(x).to(route.device),
                                 *self._stats[route.name])
            return _run_chunked(route.fn, x, route.input_shape[0])

    def _decode_body(self, route: Route, body: bytes,
                     content_type: str) -> np.ndarray:
        """An image body -> uint8 [1, h, w, C] (``serving_http.py:300-
        329``'s geometry, before its normalize); a JSON body -> float32
        [N, h, w, C] in [0, 1]."""
        h, w, nch = route.input_shape[1:]
        if content_type.startswith("image/"):
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
        from myconvnet_tpu_torch.eval.evaluators import decode_predictions

        route = self.routes.get(name)
        if route is None:
            raise KeyError(name)
        x = self._decode_body(route, body, content_type)
        if x.dtype != np.uint8:
            x = (x - route.mean) / route.std
        logits = self._execute(route, x)
        names = [str(i) for i in range(logits.shape[-1])]
        rows = decode_predictions(logits, names, route.topk)
        return {"predictions": [
            [{"label": n, "prob": round(float(p), 6)} for n, p in row]
            for row in rows]}

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
