"""The segment, translate and flow routes and the micro-batcher of the
port's HTTP server (``serving_http.py``) against the JAX package's, on
the CPU.

A tiny DeepLabv3+ (ResNet-18 backbone, narrow ASPP and decoder), a
5-level U-Net and the CPU PWC-Net, each at 64x64 in float32 with seeded
JAX-layout weights, served by the port from the recipe and the trees and
by JAX's ``ModelServer`` from an artifact of the same weights exported in
the test (``serving.export_segmentation``, ``export_image_to_image`` with
pix2pix's pre/post, ``export_fn`` of the flow chain, as
``tests/test_serve_http.py`` exports them).  Held: segment confidences
at 1e-5 and classes equal except at pixels whose top-2 logit gap is
under 1e-5 (counted, and held at that count); translate PNGs decoded
within 1 level; flows within 1e-4 of their largest with ``mean_mag`` and
``max_mag`` equal after rounding.  Then the bad requests, ``_run_chunked``
with tuple outputs, the batcher's coalescing, passthrough and error
paths (``test_serve_http.py:438-520``), and one live HTTP round trip over
two routes.
"""

import base64
import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu import serving_http as jhttp
from myconvnet_tpu.core import transform
from myconvnet_tpu_torch import models, recipes, recipes_gan, serving, \
    serving_http
from myconvnet_tpu_torch.core.precision import get_policy
from myconvnet_tpu_torch.weights import random_jax_params

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (2), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(2)


HW, BATCH = 64, 2
SEG_KW = dict(backbone_depth=18, aspp_features=32, decoder_low_features=8)
SEG_CFG = dict(task="segmentation", model="deeplab_v3_plus",
               model_kwargs=SEG_KW, dataset="voc", num_classes=21,
               input_hw=(HW, HW), augment=dict(out_hw=(HW, HW)),
               precision="f32")
P2P_CFG = dict(task="gan", gan_kind="pix2pix", dataset="pairs",
               image_size=HW, generator_kwargs=dict(base_features=8,
                                                    n_levels=5),
               discriminator_kwargs=dict(base_features=8, n_layers=2),
               precision="f32")
FLOW_CFG = dict(task="flow", model="tinypwc", model_kwargs={},
                dataset="flow", input_hw=(HW, HW), precision="f32")
# pixels of the request below whose top-2 logits sit closer than 1e-5
# (a class may go either way there); the seeded weights and frames give
# none
NEAR_TIES = 0


def _write(path, cfg):
    path.write_text(f"config = {cfg!r}\n")
    return str(path)


def _frames(n, c=3, seed=0):
    return np.random.RandomState(seed).rand(n, HW, HW, c).astype(np.float32)


def _json(x):
    return json.dumps({"instances": x.tolist()}).encode()


def _png(x):
    buf = io.BytesIO()
    Image.fromarray((x * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{kind: (port route, JAX route, trees)} of the three routes."""
    tmp = tmp_path_factory.mktemp("routes")
    out = {}
    seg = models.get_model("deeplab_v3_plus", 21, input_hw=(HW, HW),
                           **SEG_KW)
    p, s = random_jax_params(seg, 0)
    jnet = transform(lambda x, train=False: jmodels.deeplab_v3_plus(
        x, 21, train=train, **SEG_KW))
    path = str(tmp / "seg.hlo")
    mean, std = recipes.normalization(SEG_CFG, 3)
    jserving.export_segmentation(jnet, p, s, np.zeros((BATCH, HW, HW, 3),
                                                      np.float32), path,
                                 mean=mean, std=std)
    out["segment"] = (
        serving_http.build_route("seg", "segment", SEG_CFG, params=p,
                                 state=s, batch=BATCH, device="cpu"),
        jhttp.build_route("seg", "segment", path,
                          config=_write(tmp / "seg.py", SEG_CFG)), (p, s))

    gen = recipes_gan.gan_generator(P2P_CFG)
    p, s = random_jax_params(gen, 1)
    path = str(tmp / "p2p.hlo")
    jserving.export_image_to_image(
        jrecipes.gan_generator(P2P_CFG), p, s,
        np.zeros((BATCH, HW, HW, 3), np.float32), path,
        pre=lambda x: x * 2.0 - 1.0, post=lambda y: (y + 1.0) / 2.0,
        fold_bn=False)
    out["translate"] = (
        serving_http.build_route("p2p", "translate", P2P_CFG, params=p,
                                 state=s, batch=BATCH, device="cpu"),
        jhttp.build_route("p2p", "translate", path), (p, s))

    flow = models.FLOW_MODELS["tinypwc"](0)
    p, _ = random_jax_params(flow, 2)
    jflow = transform(lambda x, train=False: jmodels.tinypwc(
        x, 0, train=train))
    path = str(tmp / "flow.hlo")
    jserving.export_fn(
        lambda x: jflow.apply(p, {}, None, x, False)[0].astype(jnp.float32),
        np.zeros((BATCH, HW, HW, 6), np.float32), path)
    out["flow"] = (
        serving_http.build_route("flow", "flow", FLOW_CFG, params=p,
                                 batch=BATCH, device="cpu"),
        jhttp.build_route("flow", "flow", path), (p, {}))
    return out


def _servers(served, kind, **kw):
    port, jroute, _ = served[kind]
    return (serving_http.ModelServer([port], **kw),
            jhttp.ModelServer([jroute]), port.name)


# -------------------------------------------------------- the routes

def _seg_logits(trees, x):
    model = models.get_model("deeplab_v3_plus", 21, input_hw=(HW, HW),
                             **SEG_KW)
    fn = serving.make_inference_fn(model, *trees, device="cpu",
                                   policy=get_policy("f32"))
    mean, std = recipes.normalization(SEG_CFG, 3)
    return fn(torch.from_numpy((x - mean) / std)).numpy()


@pytest.mark.parametrize("body", ["json", "image"])
def test_segment_route_matches_jax(served, body):
    port, jax_srv, name = _servers(served, "segment")
    x = _frames(3)
    if body == "json":
        req, ctype = [_json(x)], "application/json"
        got = port.predict(name, req[0], ctype)["segmentations"]
        want = jax_srv.predict(name, req[0], ctype)["segmentations"]
        route = port.routes[name]
        classes, conf = port._execute(route, x)
        jclasses, jconf = jax_srv._execute(jax_srv.routes[name], x)
    else:
        got, want = [], []
        for img in x:
            blob = _png(img)
            got += port.predict(name, blob, "image/png")["segmentations"]
            want += jax_srv.predict(name, blob, "image/png")[
                "segmentations"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["size"] == w["size"] == [HW, HW]
        gmap = np.repeat(g["rle"][0::2], g["rle"][1::2])
        wmap = np.repeat(w["rle"][0::2], w["rle"][1::2])
        assert int((gmap != wmap).sum()) <= NEAR_TIES
        assert abs(g["mean_conf"] - w["mean_conf"]) <= 1e-4
        assert set(g["coverage"]) <= set(
            jhttp._dataset_class_names(SEG_CFG, "segment"))
    if body == "json":
        np.testing.assert_allclose(conf, jconf, rtol=0, atol=1e-5)
        logits = _seg_logits(served["segment"][2], x)
        top2 = np.sort(logits, -1)[..., -2:]
        near = (top2[..., 1] - top2[..., 0]) < 1e-5
        assert int(near.sum()) == NEAR_TIES
        assert np.array_equal(classes[~near], jclasses[~near])
        assert classes.dtype == np.int32 and conf.dtype == np.float32


@pytest.mark.parametrize("body", ["json", "image"])
def test_translate_route_matches_jax(served, body):
    port, jax_srv, name = _servers(served, "translate")
    x = _frames(3, seed=1)
    if body == "json":
        got = port.predict(name, _json(x))["images"]
        want = jax_srv.predict(name, _json(x))["images"]
    else:
        got = [port.predict(name, _png(i), "image/png")["images"][0]
               for i in x]
        want = [jax_srv.predict(name, _png(i), "image/png")["images"][0]
                for i in x]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        gi = np.asarray(Image.open(io.BytesIO(base64.b64decode(g))),
                        np.int16)
        wi = np.asarray(Image.open(io.BytesIO(base64.b64decode(w))),
                        np.int16)
        assert gi.shape == wi.shape == (HW, HW, 3)
        assert np.abs(gi - wi).max() <= 1


def test_flow_route_matches_jax(served):
    port, jax_srv, name = _servers(served, "flow")
    x = _frames(3, c=6, seed=2)
    got = port.predict(name, _json(x))["flows"]
    want = jax_srv.predict(name, _json(x))["flows"]
    for g, w in zip(got, want):
        assert g["size"] == w["size"] == [HW, HW]
        assert g["mean_mag"] == w["mean_mag"]
        assert g["max_mag"] == w["max_mag"]
        Image.open(io.BytesIO(base64.b64decode(g["png"]))).verify()
    f = port._execute(port.routes[name], x)
    jf = np.asarray(jax_srv._execute(jax_srv.routes[name], x))
    assert f.shape == (3, HW, HW, 2) and f.dtype == np.float32
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-4 * np.abs(jf).max())


def test_flow_to_color_matches_jax():
    from myconvnet_tpu.utils.images import flow_to_color as jcolor
    from myconvnet_tpu_torch.utils.images import flow_to_color
    f = np.random.RandomState(3).randn(9, 11, 2).astype(np.float32) * 4
    f[0, 0] = np.nan
    np.testing.assert_array_equal(flow_to_color(f), jcolor(f))
    np.testing.assert_array_equal(flow_to_color(f, 2.0), jcolor(f, 2.0))


def test_routes_describe_and_class_names(served):
    seg = served["segment"][0]
    assert seg.describe() == {"name": "seg", "kind": "segment",
                              "input": [BATCH, HW, HW, 3], "classes": 21}
    assert list(seg.class_names) == list(
        jhttp._dataset_class_names(SEG_CFG, "segment"))
    assert served["flow"][0].input_shape == (BATCH, HW, HW, 6)


# ------------------------------------------------------- bad requests

def test_bad_requests(served):
    server = serving_http.ModelServer([r for r, _, _ in served.values()])
    with pytest.raises(KeyError):
        server.predict("nope", _json(_frames(1)))
    with pytest.raises(ValueError, match="instances shape"):
        server.predict("seg", _json(_frames(1)[:, :32]))
    with pytest.raises(ValueError, match='"instances"'):
        server.predict("seg", b'{"x": 1}')
    with pytest.raises(ValueError, match="JSON instances"):
        server.predict("flow", b"\x89PNGfake", "image/png")
    with pytest.raises(ValueError, match="instances shape"):
        server.predict("flow", _json(_frames(1)))


@pytest.mark.parametrize("kind,cfg,match", [
    ("caption", SEG_CFG, "serves"),
    ("segment", FLOW_CFG, "segmentation recipe"),
    ("translate", dict(P2P_CFG, gan_kind="dcgan"), "latents"),
    ("translate", SEG_CFG, "gan recipe")],
    ids=["unknown_kind", "wrong_task", "dcgan", "not_gan"])
def test_build_route_refusals(kind, cfg, match):
    with pytest.raises(ValueError, match=match):
        serving_http.build_route("r", kind, cfg, params={}, device="cpu")


def test_build_route_needs_one_weight_source():
    with pytest.raises(ValueError, match="exactly one"):
        serving_http.build_route("r", "flow", FLOW_CFG, device="cpu")


def test_parse_route_spec():
    assert serving_http.parse_route_spec("s=segment:c.py:runs/x") == (
        "s", "segment", "c.py", "runs/x", None)
    for bad in ("noequals", "name=onlykind", "n=segment:c.py", "=a:b:c"):
        with pytest.raises(ValueError, match="NAME=KIND:CONFIG:CKPT"):
            serving_http.parse_route_spec(bad)


def test_route_from_a_gan_checkpoint(tmp_path, served):
    """A translate route reads a pix2pix checkpoint's generator trees."""
    from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
    p, s = served["translate"][2]
    ckpt_lib.save_checkpoint(str(tmp_path), 3, {"g_params": p,
                                                "g_state": s})
    route = serving_http.build_route("p2p", "translate", P2P_CFG,
                                     ckpt=str(tmp_path), batch=BATCH,
                                     device="cpu")
    x = _frames(2, seed=4)
    a = serving_http.ModelServer([route]).predict("p2p", _json(x))
    b = serving_http.ModelServer([served["translate"][0]]).predict(
        "p2p", _json(x))
    assert a == b


# ----------------------------------------------------- _run_chunked

def test_run_chunked_handles_tuples():
    calls = []

    def fn(x):
        calls.append(x.shape[0])
        return (x.sum(1), (x * 2).to(torch.int32))

    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    s, d = serving_http._run_chunked(fn, x, batch=4)
    assert set(calls) == {4}
    assert s.shape == (10,) and d.shape == (10, 3) and d.dtype == np.int32
    np.testing.assert_allclose(s, x.sum(1))
    np.testing.assert_array_equal(d, (x * 2).astype(np.int32))
    js, jd = jhttp._run_chunked(lambda a: (a.sum(1), a * 2), x, batch=4)
    np.testing.assert_array_equal(s, js)


# ------------------------------------------------------- the batcher

def _counting(route, calls):
    inner = route.fn

    def fn(x):
        calls.append(int(x.shape[0]))
        return inner(x)
    return fn


def _concurrently(fns):
    results = [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def work(i):
        barrier.wait()
        try:
            results[i] = fns[i]()
        except Exception as e:
            results[i] = e
    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return results


def test_micro_batching_coalesces_concurrent_requests(served):
    """Three single-frame segment requests inside a 300 ms window run as
    one epoch (two device calls of the route's batch of 2); every request
    gets exactly its own rows, equal to the unbatched server's."""
    port, _, name = _servers(served, "segment")
    route = port.routes[name]
    calls = []
    batched_route = serving_http.Route(**{**route.__dict__,
                                          "fn": _counting(route, calls)})
    batched = serving_http.ModelServer([batched_route],
                                       batch_window_ms=300)
    bodies = [_json(_frames(1, seed=10 + i)) for i in range(3)]
    results = _concurrently([lambda b=b: batched.predict(name, b)
                             for b in bodies])
    assert calls == [2, 2], calls
    for body, got in zip(bodies, results):
        assert got == port.predict(name, body)


def test_micro_batching_single_request_passthrough(served):
    port, _, name = _servers(served, "flow")
    batched, _, _ = _servers(served, "flow", batch_window_ms=20)
    body = _json(_frames(3, c=6, seed=5))
    assert batched.predict(name, body) == port.predict(name, body)


def test_micro_batching_error_reaches_every_follower(served):
    route = served["translate"][0]

    def boom(x):
        raise RuntimeError("device fault")

    server = serving_http.ModelServer(
        [serving_http.Route(**{**route.__dict__, "fn": boom})],
        batch_window_ms=300)
    body = _json(_frames(1))
    results = _concurrently([lambda: server.predict("p2p", body)] * 3)
    msgs = sorted(str(r) for r in results)
    assert all(isinstance(r, RuntimeError) for r in results)
    assert msgs.count("device fault") == 1
    assert sum(m.startswith("batched device call failed: device fault")
               for m in msgs) == 2


def test_micro_batching_coalesces_image_bodies_after_b2(served):
    """Image bodies are normalized (B2 on a CUDA tensor, its plain version
    here) one request at a time before the batcher concatenates the
    rows."""
    port, _, name = _servers(served, "translate")
    route = port.routes[name]
    calls = []
    batched = serving_http.ModelServer(
        [serving_http.Route(**{**route.__dict__,
                               "fn": _counting(route, calls)})],
        batch_window_ms=300)
    imgs = [_png(f) for f in _frames(2, seed=6)]
    results = _concurrently([lambda b=b: batched.predict(name, b,
                                                         "image/png")
                             for b in imgs])
    assert calls == [2]
    for b, got in zip(imgs, results):
        assert got == port.predict(name, b, "image/png")


# ---------------------------------------------------------- live HTTP

def test_segment_and_translate_over_live_http(served):
    server = serving_http.ModelServer(
        [served["segment"][0], served["translate"][0]], batch_window_ms=20)
    httpd = serving_http.make_http_server(server)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        host, port = httpd.server_address
        base = f"http://{host}:{port}"
        listed = json.loads(urllib.request.urlopen(
            f"{base}/v1/models", timeout=30).read())["models"]
        assert {m["kind"] for m in listed} == {"segment", "translate"}
        body = _json(_frames(1))
        for name, key in (("seg", "segmentations"), ("p2p", "images")):
            req = urllib.request.Request(
                f"{base}/v1/models/{name}:predict", data=body,
                headers={"Content-Type": "application/json"})
            out = json.loads(urllib.request.urlopen(req, timeout=60).read())
            assert len(out[key]) == 1
            assert out == server.predict(name, body)
    finally:
        httpd.shutdown()
        httpd.server_close()


# ------------------------------------------------ kernel routing (bf16)

def _spies(monkeypatch):
    from myconvnet_tpu_torch.models import blocks
    from myconvnet_tpu_torch.models import resnet as resnet_mod
    calls = {"b5": 0, "b4": 0, "b1": 0, "b2": 0}

    def spy(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call
    for mod, attr, key in ((resnet_mod, "conv1x1_conv3x3_bn_relu", "b5"),
                           (blocks, "conv3x3_bn_relu", "b4"),
                           (blocks, "fused_scale_shift_act", "b1"),
                           (serving_http, "normalize_u8", "b2")):
        monkeypatch.setattr(mod, attr, spy(key, getattr(mod, attr)))
    return calls


@pytest.mark.parametrize("kind,cfg,hw,per_call", [
    ("segment", dict(SEG_CFG, model_kwargs={}, precision="bf16",
                     input_hw=(33, 33), augment=dict(out_hw=(33, 33))),
     33, {"b5": 11, "b4": 2, "b1": 18}),
    ("translate", dict(P2P_CFG, image_size=256, precision="bf16",
                       generator_kwargs=dict(base_features=8)),
     256, {"b5": 0, "b4": 0, "b1": 13})], ids=["segment", "translate"])
def test_bf16_routes_reach_the_kernels_once_a_device_call(
        monkeypatch, kind, cfg, hw, per_call):
    """Under bf16 (the recipes' policy) each device call of the segment
    route (DeepLabv3+ at output_stride 16, BN folded) reaches B5 11, B4 2
    and B1 18 times, of the translate route (the 8-level U-Net, not
    folded) B1 13; an image body adds one B2 (spies on the wrappers,
    which run their plain versions on the CPU)."""
    if kind == "segment":
        model = models.get_model("deeplab_v3_plus", 21, input_hw=(hw, hw))
    else:
        model = recipes_gan.gan_generator(cfg)
    p, s = random_jax_params(model, 3)
    route = serving_http.build_route(kind, kind, cfg, params=p, state=s,
                                     batch=1, device="cpu")
    calls = _spies(monkeypatch)
    server = serving_http.ModelServer([route])
    x = np.random.RandomState(0).rand(1, hw, hw, 3).astype(np.float32)
    server.predict(kind, _json(x))
    assert calls == {**per_call, "b2": 0}
    server.predict(kind, _png(x[0]), "image/png")
    assert calls == {k: 2 * v for k, v in per_call.items()} | {"b2": 1}


# ------------------------------------------------------------ serve.py

def test_serve_cli_builds_routes_from_specs(tmp_path, served, monkeypatch,
                                            capsys):
    """``serve.py --route NAME=KIND:CONFIG:CKPT`` (repeatable) with
    ``--batch_window_ms``: the routes from the configs and checkpoints,
    every one behind a batcher; the HTTP server is a stub here."""
    from myconvnet_tpu_torch import serve
    from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
    seg_p, seg_s = served["segment"][2]
    ckpt_lib.save_checkpoint(str(tmp_path / "seg"), 1, {
        "params": seg_p, "model_state": seg_s})
    flow_p, _ = served["flow"][2]
    ckpt_lib.save_checkpoint(str(tmp_path / "flow"), 1, {"params": flow_p})
    made = {}

    class Stub:
        server_address = ("127.0.0.1", 1234)

        def serve_forever(self):
            pass

        def server_close(self):
            made["closed"] = True

    def fake(server, host, port):
        made["server"] = server
        return Stub()
    monkeypatch.setattr(serving_http, "make_http_server", fake)
    serve.main(["--serve", "127.0.0.1:0", "--device", "cpu", "--batch", "2",
                "--batch_window_ms", "5",
                "--route", f"seg=segment:{_write(tmp_path / 's.py', SEG_CFG)}"
                f":{tmp_path / 'seg'}",
                "--route", f"fl=flow:{_write(tmp_path / 'f.py', FLOW_CFG)}"
                f":{tmp_path / 'flow'}"])
    server = made["server"]
    assert made["closed"] and set(server.routes) == {"seg", "fl"}
    assert set(server._batchers) == {"seg", "fl"}
    assert server.routes["seg"].input_shape == (2, HW, HW, 3)
    assert "batch window 5 ms" in capsys.readouterr().out
    x = _json(_frames(1))
    assert server.predict("seg", x) == \
        serving_http.ModelServer([served["segment"][0]]).predict("seg", x)


@pytest.mark.parametrize("argv,match", [
    (["--serve", "h:1"], "--config/--ckpt or a --route"),
    (["--latency", "--route", "a=flow:b:c"], "--latency needs"),
    (["--serve", "h:1", "--config", "c.py"], "go together"),
    (["--serve", "h:1", "--route", "bad"], "NAME=KIND:CONFIG:CKPT")],
    ids=["nothing", "latency", "half", "spec"])
def test_serve_cli_refusals(argv, match):
    from myconvnet_tpu_torch import serve
    with pytest.raises((SystemExit, ValueError), match=match):
        serve.main(argv + ["--device", "cpu"])
