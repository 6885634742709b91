"""The port's serving path against the JAX serving path, on the CPU.

The same request bodies go to the JAX ``ModelServer`` (its route built
from ``make_inference_fn`` directly, no export) and to the port's
``ModelServer`` (its route built by ``build_route`` from a recipe dict and
the same parameter trees).  Also: bucketing, latency percentiles, the
HTTP front end and the ``serve`` CLI.
"""

import io
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import jax

from myconvnet_tpu import serving as jserving
from myconvnet_tpu import serving_http as jhttp
from myconvnet_tpu.models.base import ConvNet
from myconvnet_tpu import models as jmodels
from myconvnet_tpu_torch import serve as serve_cli
from myconvnet_tpu_torch import serving, serving_http
from myconvnet_tpu_torch.core.precision import BF16

torch.set_num_threads(1)

HW, CLASSES, BATCH = 32, 10, 4
CFG = dict(model="resnet50", model_kwargs=dict(width=8),
           num_classes=CLASSES, input_hw=(HW, HW), precision="f32",
           augment=dict(out_hw=(HW, HW)))


@pytest.fixture(scope="module")
def trees():
    net = ConvNet(jmodels.resnet50, input_shape=(HW, HW, 3),
                  num_classes=CLASSES, width=8).build()
    rng = np.random.RandomState(0)
    params = {k: {n: np.array(v) for n, v in d.items()}
              for k, d in net.state.params.items()}
    state = {k: {n: np.array(v) for n, v in d.items()}
             for k, d in net.state.model_state.items()}
    for scope, p in params.items():
        if "gamma" in p:
            c = p["gamma"].shape[0]
            p["gamma"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
            state[scope]["moving_var"] = rng.uniform(
                0.5, 1.5, c).astype(np.float32)
    # small logits, so the top-5 probabilities are spread out
    params["logits"]["w"] = params["logits"]["w"] * np.float32(2e-3)
    return net, params, state


def _servers(trees, precision):
    net, params, state = trees
    jnet = ConvNet(jmodels.resnet50, input_shape=(HW, HW, 3),
                   num_classes=CLASSES, precision=precision, width=8)
    fn = jserving.make_inference_fn(jnet._transformed, params, state,
                                    bn_eps=1e-5)
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    jroute = jhttp.Route(name="cls", kind="classify", fn=jax.jit(fn),
                         input_shape=(BATCH, HW, HW, 3), mean=mean,
                         std=std)
    proute = serving_http.build_route(
        "cls", "classify", dict(CFG, precision=precision), params=params,
        state=state, batch=BATCH, device="cpu")
    np.testing.assert_array_equal(proute.mean, mean)
    np.testing.assert_array_equal(proute.std, std)
    return jhttp.ModelServer([jroute]), serving_http.ModelServer([proute])


def _body(n, seed):
    x = np.random.RandomState(seed).rand(n, HW, HW, 3)
    return json.dumps({"instances": x.tolist()}).encode()


@pytest.mark.parametrize("n", [1, 3, 5])
def test_predict_matches_jax_f32(trees, n):
    jserver, pserver = _servers(trees, "f32")
    body = _body(n, seed=n)
    ref = jserver.predict("cls", body)["predictions"]
    out = pserver.predict("cls", body)["predictions"]
    assert len(out) == n
    for r_row, o_row in zip(ref, out):
        assert [e["label"] for e in o_row] == [e["label"] for e in r_row]
        # float32 logits agree to ~1e-6; probabilities are rounded to 6
        # decimals in the response
        np.testing.assert_allclose([e["prob"] for e in o_row],
                                   [e["prob"] for e in r_row], atol=2e-6)


def test_predict_matches_jax_bf16(trees):
    jserver, pserver = _servers(trees, "bf16")
    body = _body(3, seed=7)
    ref = jserver.predict("cls", body)["predictions"]
    out = pserver.predict("cls", body)["predictions"]
    for r_row, o_row in zip(ref, out):
        # bf16 logits differ by ~2% of their scale (see test_torch_resnet);
        # the top class and its probability hold
        assert o_row[0]["label"] == r_row[0]["label"]
        assert abs(o_row[0]["prob"] - r_row[0]["prob"]) < 0.02


def test_predict_image_body_matches_jax(trees):
    from PIL import Image
    jserver, pserver = _servers(trees, "f32")
    img = (np.random.RandomState(3).rand(40, 50, 3) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    ref = jserver.predict("cls", buf.getvalue(), "image/png")
    out = pserver.predict("cls", buf.getvalue(), "image/png")
    assert [e["label"] for e in out["predictions"][0]] == \
        [e["label"] for e in ref["predictions"][0]]


def test_bad_requests(trees):
    _, pserver = _servers(trees, "f32")
    with pytest.raises(KeyError):
        pserver.predict("nope", _body(1, 0))
    with pytest.raises(ValueError):
        pserver.predict("cls", json.dumps({"instances": [[0.0]]}).encode())
    with pytest.raises(ValueError):
        pserver.predict("cls", b"{}")
    with pytest.raises(ValueError):
        serving_http.build_route("x", "detect", CFG, params={}, state={},
                                 device="cpu")


def test_batched_server_buckets_and_latency(trees):
    _, params, state = trees
    from myconvnet_tpu_torch import models
    fn = serving.make_inference_fn(models.resnet50(CLASSES, width=8),
                                   params, state, device="cpu",
                                   policy=BF16)
    serve = serving.make_batched_server(fn, batch_sizes=(2, 4))
    x = np.random.RandomState(0).randn(9, HW, HW, 3).astype(np.float32)
    whole = serve(x)
    assert whole.shape == (9, CLASSES)
    # padding and chunking do not change a row's answer
    for i in (0, 5, 8):
        torch.testing.assert_close(serve(x[i:i + 1])[0], whole[i])
    with pytest.raises(ValueError):
        serve(x[:0])
    stats = serving.measure_latency(serve, (HW, HW, 3),
                                    request_sizes=(1, 3), iters=3,
                                    warmup=1)
    assert set(stats) == {1, 3}
    assert {"p50", "p95", "p99", "mean", "qps",
            "images_per_sec"} <= set(stats[3])


def test_http_round_trip(trees):
    _, pserver = _servers(trees, "f32")
    httpd = serving_http.make_http_server(pserver, "127.0.0.1", 0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    # the server is on this host: no proxy from the environment
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    try:
        with opener.open(base + "/healthz", timeout=30) as r:
            assert json.load(r) == {"status": "ok"}
        with opener.open(base + "/v1/models", timeout=30) as r:
            assert json.load(r)["models"][0]["input"] == [BATCH, HW, HW, 3]
        req = urllib.request.Request(
            base + "/v1/models/cls:predict", data=_body(2, 1),
            headers={"Content-Type": "application/json"})
        with opener.open(req, timeout=60) as r:
            out = json.load(r)
        assert len(out["predictions"]) == 2
        assert out == pserver.predict("cls", _body(2, 1))
    finally:
        httpd.shutdown()
        httpd.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_serve_cli_latency(trees, tmp_path, capsys):
    net, params, state = trees
    net.state = net.state._replace(params=params, model_state=state)
    net.save(str(tmp_path / "ckpt"))
    cfg = tmp_path / "tiny_r50.py"
    cfg.write_text(f"config = {CFG!r}\n")
    serve_cli.main(["--config", str(cfg), "--ckpt", str(tmp_path / "ckpt"),
                    "--device", "cpu", "--latency", "--sizes", "1"])
    assert "n=1" in capsys.readouterr().out
