"""The port's artifacts (``torch.export``) against the JAX package's
(StableHLO), on the CPU.

Each kind the port exports, at a tiny size, from one set of seeded
JAX-layout weights: classify on a bf16 ResNet-50 at width 16 (its
stride-1 bottlenecks reach the ``mcn::conv_pair`` op, the other conv ->
BN -> ReLU sites ``mcn::bn_act``) and on a bf16 ``tinyvit``, segment on a
float32 DeepLabv3+ (ResNet-18 backbone), DCGAN's sampler and pix2pix's
U-Net in float32, and the float32 ``tinypwc`` flow.  The port's artifact
(``serving.export_*``) and JAX's (``myconvnet_tpu.serving.export_*`` run
through its ``load_inference``; BN folded by JAX's ``fold_batch_norms``
at the zoo's eps, as its exporters fold after ``resolve_bn_eps``, whose
eager probe forwards would take most of this file's time) take the same
wire rows.  Held, as the
route tests hold them: float32 logits within 1e-4 of max |JAX|, bf16
logits within 0.05 of it; segment classes equal wherever the top-2 logit
gap exceeds 1e-5 and confidences within 1e-5; images (translate, sample)
within 1 level of 255; flows within 1e-4 of their largest.  Each port
artifact also gives its in-memory program's bits on the same rows, and
its graph holds exactly the ``mcn::`` ops that program calls (counted by
a dispatch mode), which the card launches one each: the CPU export of a
bf16 model reaches B1, B4 and B5 because their routing is by dtype;
attention (B6) is routed by device and stays out of a CPU graph.

Then the entry points: ``test --export`` end to end on checkpoints the
port writes (classification bf16 and float32, segmentation, DCGAN with and
without ``--ema``, pix2pix, flow), ``serve --artifact`` in each mode
against the JAX ``serve.py`` functions on the JAX artifacts of the same
weights, artifact routes against JAX's ``ModelServer``, both route-spec
forms, the refusals by name, and an artifact loaded in a fresh process
without the model code.  Every artifact is exported once, in module
fixtures.
"""

import argparse
import base64
import collections
import importlib.util
import io
import json
import os
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch
from PIL import Image
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from myconvnet_tpu import models as jmodels
from myconvnet_tpu import serving as jserving
from myconvnet_tpu import serving_http as jhttp
from myconvnet_tpu.core import transform
from myconvnet_tpu.core.precision import BF16 as JBF16
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.models.base import ConvNet as JConvNet
from myconvnet_tpu.models.folding import fold_batch_norms as jfold
from myconvnet_tpu_torch import (models, recipes, serve, serving,
                                 serving_http, test as test_entry)
from myconvnet_tpu_torch.core.precision import BF16, FULL
from myconvnet_tpu_torch.weights import random_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (2), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(2)


CLASSES, BATCH = 10, 2
# (hw of the wire rows) and the configs the routes read
R50_KW, R50_HW = dict(width=16), 32
VIT_HW = 8
SEG_HW, SEG_KW = 64, dict(backbone_depth=18, aspp_features=32,
                          decoder_low_features=8)
SEG_CFG = dict(task="segmentation", model="deeplab_v3_plus",
               model_kwargs=SEG_KW, dataset="voc", num_classes=21,
               input_hw=(SEG_HW, SEG_HW),
               augment=dict(out_hw=(SEG_HW, SEG_HW)), precision="f32")
DCGAN_KW = dict(image_size=16, base_features=16)
P2P_HW, P2P_KW = 32, dict(base_features=8, n_levels=5)
P2P_CFG = dict(task="gan", gan_kind="pix2pix", dataset="pairs",
               image_size=P2P_HW, generator_kwargs=P2P_KW,
               discriminator_kwargs=dict(base_features=8, n_layers=2),
               precision="f32")
FLOW_HW = 64
FLOW_CFG = dict(task="flow", model="tinypwc", model_kwargs={},
                dataset="flow", input_hw=(FLOW_HW, FLOW_HW),
                precision="f32")
CLS_CFG = dict(task="classification", model="resnet50",
               model_kwargs=R50_KW, num_classes=CLASSES,
               input_hw=(R50_HW, R50_HW), dataset="imagenet",
               augment=dict(out_hw=(R50_HW, R50_HW)), precision="bf16")
# the mcn:: nodes of each CPU graph (and the ops its in-memory program
# calls): the width-16 ResNet-50 has 10 stride-1 bottlenecks whose
# channels B5 takes and 13 other conv -> BN -> ReLU sites (at width 64,
# the card's, 13 and 7); the float32 DeepLab has B1 only, at its 18
# conv -> BN -> ReLU sites; the 16 x 16 DCGAN B1 at its 2 BN sites, the
# 5-level U-Net at its 7; tinypwc a cost volume at each of its 2 levels
OPS = {"classify": {"conv_pair": 10, "bn_act": 13}, "vit": {},
       "segment": {"bn_act": 18}, "sample": {"bn_act": 2},
       "translate": {"bn_act": 7}, "flow": {"correlation_fwd": 2}}
LOGIT_TOL = {"f32": 1e-4, "bf16": 0.05}


class OpCalls(TorchDispatchMode):
    """Counts the ``mcn::`` ops a block calls (each a kernel launch on a
    CUDA tensor)."""

    def __init__(self):
        super().__init__()
        self.calls = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "mcn":
            self.calls[func._schema.name.split("::")[1]] += 1
        return func(*args, **(kwargs or {}))


def _rows(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).rand(*shape) * scale).astype(
        np.float32)


def _np(out):
    if isinstance(out, tuple):
        return tuple(_np(t) for t in out)
    return out.float().numpy() if out.is_floating_point() else out.numpy()


def _write(path, cfg):
    path.write_text(f"config = {cfg!r}\n")
    return str(path)


def _jax_serve():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_entry", os.path.join(ROOT, "serve.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """{name: dict(port=load_inference fn, jax=load_inference fn,
    program=the in-memory program, wire=[rows], trees, kind)}."""
    tmp = tmp_path_factory.mktemp("artifacts")
    out = {}

    def add(name, kind, port_export, jax_export, program, wire, trees):
        port_path, jax_path = str(tmp / f"{name}.pt2"), str(tmp / name)
        port_export(port_path)
        jax_export(jax_path)
        out[name] = dict(kind=kind, port=serving.load_inference(port_path),
                         jax=jserving.load_inference(jax_path),
                         port_path=port_path, jax_path=jax_path,
                         program=program, wire=wire, trees=trees)

    # classify: bf16 ResNet-50 at width 16 (normalized rows)
    model = models.resnet50(CLASSES, **R50_KW)
    p, s = random_jax_params(model, 0)
    sample = np.zeros((BATCH, R50_HW, R50_HW, 3), np.float32)
    jnet = JConvNet(jmodels.resnet50, input_shape=(R50_HW, R50_HW, 3),
                    num_classes=CLASSES, precision="bf16", **R50_KW)
    route = serving_http.build_route("c", "classify", CLS_CFG, params=p,
                                     state=s, batch=BATCH, device="cpu")
    add("classify", "classify",
        lambda path: serving.export_inference(
            model, p, s, sample, path, device="cpu", policy=BF16),
        lambda path: jserving.export_inference(
            jnet._transformed, *jfold(p, s, 1e-5), sample, path,
            fold_bn=False),
        route.fn, _rows(sample.shape, 1, 4.0) - 2.0, (p, s))

    # classify: bf16 tinyvit
    vit = models.get_model("tinyvit", CLASSES, input_hw=(VIT_HW, VIT_HW))
    vp, _ = random_jax_params(vit, 1)
    vsample = np.zeros((BATCH, VIT_HW, VIT_HW, 3), np.float32)
    jvit = importlib.import_module("myconvnet_tpu.models.vit")

    def jax_vit(path):
        with policy_scope(JBF16):
            jserving.export_inference(
                transform(lambda x, train=False: jvit.vit(
                    x, CLASSES, train=train, variant="test")),
                vp, {}, vsample, path, fold_bn=False)
    vroute = serving_http.build_route(
        "v", "classify", dict(CLS_CFG, model="tinyvit", model_kwargs={},
                              input_hw=(VIT_HW, VIT_HW)),
        params=vp, state={}, batch=BATCH, device="cpu")
    add("vit", "classify",
        lambda path: serving.export_inference(
            vit, vp, {}, vsample, path, device="cpu", policy=BF16),
        jax_vit, vroute.fn, _rows(vsample.shape, 2, 4.0) - 2.0, (vp, {}))

    # segment: float32 DeepLabv3+ (raw [0, 1] frames)
    seg = models.get_model("deeplab_v3_plus", 21,
                           input_hw=(SEG_HW, SEG_HW), **SEG_KW)
    p, s = random_jax_params(seg, 0)
    mean, std = recipes.normalization(SEG_CFG, 3)
    ssample = np.zeros((BATCH, SEG_HW, SEG_HW, 3), np.float32)
    jseg = transform(lambda x, train=False: jmodels.deeplab_v3_plus(
        x, 21, train=train, **SEG_KW))
    sroute = serving_http.build_route("s", "segment", SEG_CFG, params=p,
                                      state=s, batch=BATCH, device="cpu")
    add("segment", "segment",
        lambda path: serving.export_segmentation(
            seg, p, s, ssample, path, mean=mean, std=std, device="cpu",
            policy=FULL),
        lambda path: jserving.export_segmentation(
            jseg, *jfold(p, s, 1e-5), ssample, path, mean=mean, std=std,
            fold_bn=False),
        lambda x: sroute.fn(sroute.pre(x)), _rows(ssample.shape, 3),
        (p, s))

    # sample: DCGAN's generator (latents)
    gen = models.DCGANGenerator(100, **DCGAN_KW)
    p, s = random_jax_params(gen, 4)
    zsample = np.zeros((BATCH, 100), np.float32)
    jgen = transform(lambda z, train=False: jmodels.dcgan_generator(
        z, train=train, **DCGAN_KW))
    dprog = serving.image_to_image_program(
        serving.make_inference_fn(models.DCGANGenerator(100, **DCGAN_KW),
                                  p, s, fold_bn=False, device="cpu",
                                  policy=FULL), post=serving.from_tanh)
    add("sample", "sample",
        lambda path: serving.export_image_to_image(
            gen, p, s, zsample, path, post=serving.from_tanh,
            fold_bn=False, kind="sample", device="cpu", policy=FULL),
        lambda path: jserving.export_image_to_image(
            jgen, p, s, zsample, path, post=lambda y: (y + 1.0) / 2.0,
            fold_bn=False),
        dprog, np.random.RandomState(5).standard_normal(
            zsample.shape).astype(np.float32), (p, s))

    # translate: pix2pix's U-Net ([0, 1] in and out)
    unet = models.UNetGenerator(image_size=P2P_HW, **P2P_KW)
    p, s = random_jax_params(unet, 6)
    tsample = np.zeros((BATCH, P2P_HW, P2P_HW, 3), np.float32)
    junet = transform(lambda x, train=False: jmodels.unet_generator(
        x, train=train, **P2P_KW))
    troute = serving_http.build_route("t", "translate", P2P_CFG, params=p,
                                      state=s, batch=BATCH, device="cpu")
    add("translate", "translate",
        lambda path: serving.export_image_to_image(
            unet, p, s, tsample, path,
            pre=serving.normalizer(0.5, 0.5, "cpu"),
            post=serving.from_tanh, fold_bn=False, device="cpu",
            policy=FULL),
        lambda path: jserving.export_image_to_image(
            junet, p, s, tsample, path, pre=lambda x: x * 2.0 - 1.0,
            post=lambda y: (y + 1.0) / 2.0, fold_bn=False),
        lambda x: troute.fn(troute.pre(x)), _rows(tsample.shape, 7),
        (p, s))

    # flow: tinypwc (raw [0, 1] pairs)
    flow = models.FLOW_MODELS["tinypwc"](0)
    p, _ = random_jax_params(flow, 8)
    fsample = np.zeros((BATCH, FLOW_HW, FLOW_HW, 6), np.float32)
    jflow = transform(lambda x, train=False: jmodels.tinypwc(
        x, 0, train=train))
    froute = serving_http.build_route("f", "flow", FLOW_CFG, params=p,
                                      batch=BATCH, device="cpu")

    def port_flow(path):
        fn = serving.make_inference_fn(flow, p, {}, fold_bn=False,
                                       device="cpu", policy=FULL)
        serving.export_fn(fn.program, fn.model, fsample, path, kind="flow",
                          policy=FULL, device="cpu")
    add("flow", "flow", port_flow,
        lambda path: jserving.export_fn(
            lambda x: jflow.apply(p, {}, None, x, False)[0].astype(
                jnp.float32), fsample, path),
        froute.fn, _rows(fsample.shape, 9), (p, {}))
    return out


NAMES = ["classify", "vit", "segment", "sample", "translate", "flow"]


# ---------------------------------------------------------- the artifacts

@pytest.mark.parametrize("name", NAMES)
def test_artifact_matches_jax(arts, name):
    a = arts[name]
    got = _np(a["port"](a["wire"]))
    want = a["jax"](a["wire"])
    kind = a["kind"]
    if kind == "segment":
        (cls, conf), (jcls, jconf) = got, (np.asarray(t) for t in want)
        assert cls.dtype == np.int32 and conf.dtype == np.float32
        np.testing.assert_allclose(conf, jconf, rtol=0, atol=1e-5)
        mean, std = recipes.normalization(SEG_CFG, 3)
        fn = serving.make_inference_fn(
            models.get_model("deeplab_v3_plus", 21,
                             input_hw=(SEG_HW, SEG_HW), **SEG_KW),
            *a["trees"], device="cpu", policy=FULL)
        top2 = np.sort(fn((a["wire"] - mean) / std).numpy(), -1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) >= 1e-5
        np.testing.assert_array_equal(cls[sure], jcls[sure])
        return
    want = np.asarray(want, np.float32)
    assert got.dtype == np.float32 and got.shape == want.shape
    if kind in ("sample", "translate"):
        assert got.min() >= 0.0 and got.max() <= 1.0
        level = np.abs(np.round(got * 255) - np.round(want * 255))
        assert level.max() <= 1
        return
    tol = LOGIT_TOL[serving.artifact_meta(a["port_path"])["policy"]]
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("name", NAMES)
def test_artifact_gives_the_in_memory_programs_bits(arts, name):
    """A route (or the sampler's chain) and its artifact run one program:
    the same rows give the same bits, and the graph's mcn:: nodes are the
    ops the in-memory program calls."""
    a = arts[name]
    x = torch.from_numpy(a["wire"])
    with torch.inference_mode(), OpCalls() as calls:
        want = a["program"](x)
    got = a["port"](x)
    for g, w in zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,)))):
        assert g.dtype == w.dtype and torch.equal(g, w)
    meta = a["port"].meta
    assert meta["ops"] == dict(calls.calls) == OPS[name]
    program = torch.export.load(a["port_path"])
    from myconvnet_tpu_torch.ops.kernels import _ops
    assert dict(_ops.op_nodes(program.graph)) == OPS[name]


def test_artifact_metadata(arts):
    meta = arts["segment"]["port"].meta
    assert meta["format"] == serving.FORMAT and meta["kind"] == "segment"
    assert meta["input_shape"] == [BATCH, SEG_HW, SEG_HW, 3]
    assert (meta["device"], meta["policy"]) == ("cpu", "f32")
    assert serving.artifact_meta(arts["classify"]["port_path"])[
        "policy"] == "bf16"
    assert arts["flow"]["port"].input_shapes == (
        (BATCH, FLOW_HW, FLOW_HW, 6),)
    assert serving.is_artifact(arts["flow"]["port_path"])
    assert not serving.is_artifact(arts["flow"]["jax_path"])
    # the tracer's metadata asserts and the identity casts are pruned
    graph = torch.export.load(arts["classify"]["port_path"]).graph
    targets = [n.target for n in graph.nodes if n.op == "call_function"]
    assert torch.ops.aten._assert_tensor_metadata.default not in targets
    for n in graph.nodes:
        if n.target == torch.ops.aten.to.dtype:
            assert n.args[0].meta["val"].dtype != n.meta["val"].dtype


def test_artifact_loads_without_the_model_code(arts):
    """A fresh process loads and runs an artifact importing nothing under
    myconvnet_tpu_torch.models, nor JAX or the JAX package."""
    a = arts["sample"]
    np.save(a["port_path"] + ".x.npy", a["wire"])
    code = (
        "import json, sys, numpy as np\n"
        "from myconvnet_tpu_torch import serving\n"
        f"fn = serving.load_inference({a['port_path']!r})\n"
        f"y = fn(np.load({a['port_path'] + '.x.npy'!r})).numpy()\n"
        f"np.save({a['port_path'] + '.y.npy'!r}, y)\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.startswith("
        "('myconvnet_tpu_torch.models', 'myconvnet_tpu.', 'jax')) or m "
        "in ('myconvnet_tpu', 'jax'))))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    np.testing.assert_array_equal(np.load(a["port_path"] + ".y.npy"),
                                  _np(a["port"](a["wire"])))


def test_artifact_refuses_another_device(arts, tmp_path):
    """An artifact is bound to the device type it was exported on."""
    path = arts["flow"]["port_path"]
    with pytest.raises(ValueError, match="exported for cpu, not cuda"):
        serving.load_inference(path, "cuda")
    # the same file as a CUDA export would say it
    moved = str(tmp_path / "cuda.pt2")
    with zipfile.ZipFile(path) as src, zipfile.ZipFile(moved, "w") as dst:
        for item in src.infolist():
            data = src.read(item)
            if item.filename.endswith("/extra/" + serving.META):
                meta = json.loads(data)
                data = json.dumps(dict(meta, device="cuda")).encode()
            dst.writestr(item, data)
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        serving.load_inference(moved, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not available"):
            serving.load_inference(moved)
    plain = str(tmp_path / "plain.zip")
    with zipfile.ZipFile(plain, "w") as z:
        z.writestr("x/data", b"")
    with pytest.raises(ValueError, match="not an artifact"):
        serving.artifact_meta(plain)


# ------------------------------------------------------------- the routes

def _json(x):
    return json.dumps({"instances": x.tolist()}).encode()


def _png(x):
    buf = io.BytesIO()
    Image.fromarray((x * 255).astype(np.uint8)).save(buf, "PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def configs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("configs")
    return {"segment": _write(tmp / "seg.py", SEG_CFG),
            "classify": _write(tmp / "cls.py", CLS_CFG),
            "translate": _write(tmp / "p2p.py", P2P_CFG),
            "flow": _write(tmp / "flow.py", FLOW_CFG)}


@pytest.fixture(scope="module")
def route_servers(arts, configs):
    """(port ModelServer, JAX ModelServer) with an artifact route of each
    kind over the artifacts of the same weights, top 3."""
    port, jax_routes = [], []
    for name in ("classify", "segment", "translate", "flow"):
        a = arts[name]
        port.append(serving_http.artifact_route(
            name, name, a["port_path"], configs[name], device="cpu",
            topk=3))
        jax_routes.append(jhttp.build_route(name, name, a["jax_path"],
                                            config=configs[name], topk=3))
    return (serving_http.ModelServer(port),
            jhttp.ModelServer(jax_routes))


@pytest.mark.parametrize("name,body", [
    ("segment", "json"), ("segment", "image"), ("translate", "json"),
    ("translate", "image"), ("flow", "json"), ("classify", "json")])
def test_artifact_route_matches_jax(arts, route_servers, name, body):
    """Artifact routes of both packages over the artifacts of the same
    weights: the responses agree (segment maps equal, confidences within
    1e-4 after rounding; PNGs within 1 level; flow magnitudes equal after
    rounding; classify top-k probabilities within 0.05 of bf16)."""
    port, jax_srv = route_servers
    x = arts[name]["wire"]
    if name == "classify":
        x = _rows(x.shape, 11)
    if body == "image":
        req, ctype = _png(x[0]), "image/png"
    else:
        req, ctype = _json(x), "application/json"
    got = port.predict(name, req, ctype)
    want = jax_srv.predict(name, req, ctype)
    assert got.keys() == want.keys()
    if name == "segment":
        for g, w in zip(got["segmentations"], want["segmentations"]):
            assert g["size"] == w["size"] and g["rle"] == w["rle"]
            assert abs(g["mean_conf"] - w["mean_conf"]) <= 1e-4
    elif name == "translate":
        for g, w in zip(got["images"], want["images"]):
            gi, wi = (np.asarray(Image.open(io.BytesIO(
                base64.b64decode(v))), np.int16) for v in (g, w))
            assert gi.shape == wi.shape and np.abs(gi - wi).max() <= 1
    elif name == "flow":
        for g, w in zip(got["flows"], want["flows"]):
            assert (g["size"], g["mean_mag"], g["max_mag"]) == (
                w["size"], w["mean_mag"], w["max_mag"])
    else:
        for g, w in zip(got["predictions"], want["predictions"]):
            gp = {e["label"]: e["prob"] for e in g}
            for e in w:
                if e["label"] in gp:
                    assert abs(gp[e["label"]] - e["prob"]) <= 0.05


@pytest.mark.parametrize("name", ["segment", "translate", "flow"])
def test_artifact_route_gives_the_in_memory_routes_replies(
        arts, route_servers, name):
    """A JSON body through the artifact route and through the route built
    in memory from the same trees: the same reply; with the micro-batcher
    the artifact route's reply is the same again."""
    a = arts[name]
    cfg = {"segment": SEG_CFG, "translate": P2P_CFG, "flow": FLOW_CFG}[name]
    p, s = a["trees"]
    mem = serving_http.ModelServer([serving_http.build_route(
        name, name, cfg, params=p, state=s, batch=BATCH, device="cpu")])
    art = route_servers[0].routes[name]
    body = _json(a["wire"][:1])
    want = mem.predict(name, body)
    assert route_servers[0].predict(name, body) == want
    batched = serving_http.ModelServer([art], batch_window_ms=1.0)
    assert batched.predict(name, body) == want
    assert art.describe()["artifact"] == a["port_path"]


def test_route_specs_both_forms(arts, configs, tmp_path):
    art = arts["translate"]["port_path"]
    spec = serving_http.parse_route_spec(f"s=translate:{art}")
    assert spec == ("s", "translate", None, None, art)
    spec = serving_http.parse_route_spec(
        f"s=translate:{art}:{configs['translate']}")
    assert spec.artifact == art and spec.config == configs["translate"]
    spec = serving_http.parse_route_spec(
        f"s=segment:{configs['segment']}:{tmp_path}")
    assert spec == ("s", "segment", configs["segment"], str(tmp_path),
                    None)
    with pytest.raises(ValueError, match="ambiguous"):
        serving_http.parse_route_spec(f"s=translate:{art}:{tmp_path}")
    with pytest.raises(ValueError, match="not an artifact file"):
        serving_http.parse_route_spec(f"s=segment:{configs['segment']}")
    route = serving_http.route_from_spec(
        serving_http.parse_route_spec(f"s=translate:{art}"), device="cpu")
    assert route.input_shape == (BATCH, P2P_HW, P2P_HW, 3)
    assert route.artifact == art and route.kind == "translate"
    np.testing.assert_array_equal(route.mean, np.zeros(3, np.float32))


@pytest.mark.parametrize("name,kind,match", [
    ("segment", "classify", "'segment' artifact, not 'classify'"),
    ("sample", "translate", "latent-input generator"),
    ("flow", "track", "the port serves")],
    ids=["wrong_kind", "dcgan", "unknown_kind"])
def test_artifact_route_refusals(arts, name, kind, match):
    with pytest.raises(ValueError, match=match):
        serving_http.artifact_route("r", kind, arts[name]["port_path"],
                                    device="cpu")


def test_serve_cli_artifact_routes(arts, configs, monkeypatch, capsys):
    """``serve --serve`` with ``--artifact`` (the 'default' route) and a
    ``--route`` of each form; the HTTP server is a stub here."""
    made = {}

    class Stub:
        server_address = ("127.0.0.1", 1234)

        def serve_forever(self):
            pass

        def server_close(self):
            made["closed"] = True

    monkeypatch.setattr(serving_http, "make_http_server",
                        lambda server, host, port: made.setdefault(
                            "server", server) and Stub())
    seg = arts["segment"]["port_path"]
    serve.main(["--serve", "127.0.0.1:0", "--device", "cpu",
                "--artifact", arts["translate"]["port_path"], "--translate",
                "--route", f"seg=segment:{seg}:{configs['segment']}",
                "--batch_window_ms", "2"])
    server = made["server"]
    assert made["closed"] and set(server.routes) == {"default", "seg"}
    assert server.routes["default"].kind == "translate"
    assert server.routes["seg"].class_names is not None
    assert set(server._batchers) == {"default", "seg"}
    assert "batch window 2 ms" in capsys.readouterr().out


# ------------------------------------------------------- serve --artifact

def _images(directory, n, seed, hw=40):
    os.makedirs(directory, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray((rs.rand(hw, hw, 3) * 255).astype(np.uint8)).save(
            os.path.join(directory, f"im{i}.png"))
    return directory


def _args(**kw):
    base = dict(images=None, out=None, config=None, seed=0, sample=0,
                topk=5)
    return argparse.Namespace(**{**base, **kw})


def _pngs(directory, suffix):
    return {f: np.asarray(Image.open(os.path.join(directory, f)), np.int16)
            for f in sorted(os.listdir(directory)) if f.endswith(suffix)}


@pytest.mark.parametrize("mode", ["segment", "translate", "flow"])
def test_serve_artifact_modes_match_jax(arts, configs, tmp_path, mode,
                                        capsys):
    jserve = _jax_serve()
    a = arts[mode]
    images = str(tmp_path / "in")
    if mode == "flow":
        os.makedirs(images)
        rs = np.random.RandomState(12)
        for name in ("p0", "p1", "p2"):
            for tag in "ab":
                Image.fromarray((rs.rand(FLOW_HW, FLOW_HW, 3) * 255).astype(
                    np.uint8)).save(os.path.join(images,
                                                 f"{name}_{tag}.png"))
    else:
        _images(images, 3, 12)
    jout, pout = str(tmp_path / "jax"), str(tmp_path / "port")
    shape = a["jax"].input_shapes[0]
    getattr(jserve, f"run_{mode}")(a["jax"], shape, _args(
        images=images, out=jout, config=configs[mode]))
    want = capsys.readouterr().out.replace(jout, "OUT").splitlines()
    got = serve.main(["--artifact", a["port_path"], f"--{mode}",
                      "--images", images, "--out", pout, "--config",
                      configs[mode], "--device", "cpu"])
    lines = capsys.readouterr().out.replace(pout, "OUT").splitlines()
    assert len(got) == 3 and lines == want
    suffix = {"segment": "_mask.png", "translate": "_out.png",
              "flow": "_flow.png"}[mode]
    jp, pp = _pngs(jout, suffix), _pngs(pout, suffix)
    assert jp.keys() == pp.keys() and len(jp) == 3
    for k in jp:
        assert jp[k].shape == pp[k].shape
        assert np.abs(jp[k] - pp[k]).max() <= (0 if mode == "segment" else 1)


def test_serve_sample_matches_jax(arts, tmp_path, capsys):
    """``--sample N --seed S``: the latents drawn as JAX draws them, the
    grid within 1 level."""
    jserve = _jax_serve()
    a = arts["sample"]
    jserve.run_sample(a["jax"], a["jax"].input_shapes[0], _args(
        sample=5, seed=3, out=str(tmp_path / "j.png")))
    imgs = serve.main(["--artifact", a["port_path"], "--sample", "5",
                       "--seed", "3", "--out", str(tmp_path / "p.png"),
                       "--device", "cpu"])
    assert imgs.shape == (5, 16, 16, 3)
    j = np.asarray(Image.open(tmp_path / "j.png"), np.int16)
    p = np.asarray(Image.open(tmp_path / "p.png"), np.int16)
    assert j.shape == p.shape and np.abs(j - p).max() <= 1
    assert "wrote 5 samples" in capsys.readouterr().out


def test_serve_latency_of_an_artifact(arts, capsys):
    stats = serve.main(["--artifact", arts["vit"]["port_path"], "--latency",
                        "--sizes", "1,3", "--device", "cpu"])
    assert set(stats) == {1, 3} and all(r["p50"] > 0 for r in stats.values())
    out = capsys.readouterr().out
    assert "n=1 " in out and "n=3 " in out
    with pytest.raises(SystemExit, match="fixed input"):
        serve.main(["--artifact", arts["vit"]["port_path"], "--latency",
                    "--hw", "16,16", "--device", "cpu"])


# ----------------------------------------------- test --export end to end

@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """A CIFAR-100 ResNet-18 at width 8 written by the port (bf16 and
    float32 runs of one seed), exported by ``test --export``."""
    tmp = tmp_path_factory.mktemp("cifar")
    out = {}
    for precision in ("bf16", "f32"):
        sets = ["--set", "model_kwargs.width=8", "--set",
                f"precision={precision}", "--set", "synthetic_n=16"]
        cfg = recipes.apply_overrides(recipes.load_config(os.path.join(
            ROOT, "configs", "cifar100_resnet18.py")),
            [s for s in sets if s != "--set"])
        net, _, _ = recipes.build_classifier(cfg, True,
                                             device=torch.device("cpu"))
        net.build(recipes.optimizer_factory(cfg["optimizer"]))
        ckpt = str(tmp / f"ckpt_{precision}")
        net.save(ckpt)
        path = str(tmp / f"r18_{precision}.pt2")
        got = test_entry.main(["--config", os.path.join(
            ROOT, "configs", "cifar100_resnet18.py"), "--synthetic",
            "--ckpt", ckpt, "--device", "cpu", "--export", path, *sets])
        assert got == path
        out[precision] = dict(path=path, ckpt=ckpt, net=net)
    return out


def test_export_cli_classification(cifar, capsys):
    """bf16: the eval forward's conv_fused 5 and bn_act 4; the artifact
    gives the restored net's predict logits."""
    from myconvnet_tpu_torch.weights import load_jax_checkpoint
    meta = serving.artifact_meta(cifar["bf16"]["path"])
    assert meta["ops"] == {"bn_act": 4, "conv_fused": 5}
    assert meta["input_shape"] == [8, 32, 32, 3]
    assert serving.artifact_meta(cifar["f32"]["path"])["ops"] == {
        "bn_act": 9}
    fn = serving.load_inference(cifar["bf16"]["path"])
    x = _rows((8, 32, 32, 3), 13, 2.0) - 1.0
    p, s = load_jax_checkpoint(cifar["bf16"]["ckpt"])
    mem = serving.make_inference_fn(models.resnet18(100, width=8), p, s,
                                    device="cpu", policy=BF16)
    assert torch.equal(fn(x), mem(x))


def test_serve_classify_images_matches_jax(cifar, tmp_path, monkeypatch,
                                           capsys):
    """``serve --artifact --images --config --topk --calibration`` prints
    JAX's lines on JAX's artifact of the same float32 weights."""
    from myconvnet_tpu_torch.weights import load_jax_checkpoint
    p, s = load_jax_checkpoint(cifar["f32"]["ckpt"])
    jpath = str(tmp_path / "r18.hlo")
    jserving.export_inference(
        transform(lambda x, train=False: jmodels.resnet18(
            x, 100, train=train, width=8)), *jfold(p, s, 1e-5),
        np.zeros((8, 32, 32, 3), np.float32), jpath, fold_bn=False)
    images = _images(str(tmp_path / "in"), 3, 14)
    cal = tmp_path / "calibration.json"
    cal.write_text(json.dumps({"temperature": 1.7}))
    cfg = os.path.join(ROOT, "configs", "cifar100_resnet18.py")
    monkeypatch.setattr(sys, "argv", [
        "serve.py", "--artifact", jpath, "--images", images, "--config",
        cfg, "--topk", "3", "--calibration", str(cal)])
    _jax_serve().main()
    want = capsys.readouterr().out.splitlines()
    rows = serve.main(["--artifact", cifar["f32"]["path"], "--images",
                       images, "--config", cfg, "--topk", "3",
                       "--calibration", str(cal), "--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want
    assert len(rows) == 3 and len(rows[0][1]) == 3


@pytest.fixture(scope="module")
def task_ckpts(tmp_path_factory):
    """Checkpoints the port writes for a DeepLab, a DCGAN (with an EMA of
    G), a pix2pix and a tinypwc recipe, and their configs."""
    tmp = tmp_path_factory.mktemp("tasks")
    out = {}
    specs = {
        "segment": ("voc_deeplabv3plus.py", [
            "model_kwargs.backbone_depth=18", "model_kwargs.aspp_features=16",
            "model_kwargs.decoder_low_features=8", "synthetic_n=4"]),
        "dcgan": ("dcgan_cifar10.py", [
            "generator_kwargs.base_features=16",
            "discriminator_kwargs.base_features=8",
            "g_optimizer.ema_decay=0.5", "synthetic_n=8"]),
        "pix2pix": ("pix2pix.py", [
            "image_size=32", "generator_kwargs.base_features=8",
            "generator_kwargs.n_levels=5",
            "discriminator_kwargs.base_features=8",
            "discriminator_kwargs.n_layers=2", "synthetic_n=4"]),
        "flow": ("chairs_pwcnet.py", [
            "model=tinypwc", "input_hw=[32,32]", "synthetic_n=4"])}
    cpu = torch.device("cpu")
    for name, (config, sets) in specs.items():
        cfg = recipes.apply_overrides(recipes.load_config(
            os.path.join(ROOT, "configs", config)), sets)
        ckpt = str(tmp / name)
        if name in ("dcgan", "pix2pix"):
            from myconvnet_tpu_torch import recipes_gan
            trainer, _ = recipes_gan.build_gan(cfg, True, device=cpu)
            if name == "dcgan":
                # parameters unlike their EMA (a copy made at build), so
                # --ema shows
                with torch.no_grad():
                    for _, q in trainer.g_opt.named:
                        q.add_(0.1)
            trainer.save(ckpt)
        else:
            net, _, _ = recipes.convnet_builder(cfg["task"])(
                cfg, True, device=cpu)
            net.build(recipes.optimizer_factory(cfg["optimizer"]))
            net.save(ckpt)
        out[name] = (os.path.join(ROOT, "configs", config),
                     [a for s in sets for a in ("--set", s)], ckpt)
    return out


# the recipes as written are bf16 except DCGAN: the ResNet-18 DeepLab
# reaches B4 at its 4 stride-1 basic blocks and its 2 refine convs
@pytest.mark.parametrize("name,extra,line,kind,ops", [
    ("segment", [], "exported segmentation artifact", "segment",
     {"bn_act": 12, "conv_fused": 6}),
    ("dcgan", [], "exported dcgan generator artifact", "sample",
     {"bn_act": 3}),
    ("dcgan", ["--ema"], "exporting EMA generator", "sample",
     {"bn_act": 3}),
    ("pix2pix", [], "exported pix2pix generator artifact", "translate",
     {"bn_act": 7}),
    ("flow", [], "exported flow artifact", "flow",
     {"correlation_fwd": 2})],
    ids=["segment", "dcgan", "dcgan_ema", "pix2pix", "flow"])
def test_export_cli_tasks(task_ckpts, tmp_path, capsys, name, extra, line,
                          kind, ops):
    config, sets, ckpt = task_ckpts[name]
    path = str(tmp_path / f"{name}.pt2")
    assert test_entry.main(["--config", config, "--ckpt", ckpt,
                            "--synthetic", "--device", "cpu", "--export",
                            path, *extra, *sets]) == path
    out = capsys.readouterr().out
    assert line in out and "artifact graph: " in out
    meta = serving.artifact_meta(path)
    assert meta["kind"] == kind and meta["ops"] == ops
    # the synthetic segmenter is built at 96 x 96 and the export takes
    # the built net's size; export_batch 4 everywhere
    assert meta["input_shape"] == {
        "segment": [4, 96, 96, 3], "dcgan": [4, 100],
        "pix2pix": [4, 32, 32, 3], "flow": [4, 32, 32, 6]}[name]
    if name == "dcgan":
        # with --ema the EMA generator, else the parameters: they differ
        other = str(tmp_path / "other.pt2")
        test_entry.main(["--config", config, "--ckpt", ckpt, "--synthetic",
                         "--device", "cpu", "--export", other, *sets,
                         *([] if extra else ["--ema"])])
        z = _rows((4, 100), 16)
        y = serving.load_inference(path)(z)
        assert torch.isfinite(y).all() and y.shape == (4, 32, 32, 3)
        assert not torch.equal(y, serving.load_inference(other)(z))


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("config,extra,match", [
    ("cifar100_resnet18.py", ["--int8"], "A17's quantization"),
    ("got10k_siamfc.py", [], "export_tracking"),
    ("kinetics_r3d18.py", [], "video family"),
    ("srgan.py", [], "other GAN kinds"),
    ("cyclegan.py", [], "other GAN kinds"),
    ("imagenet_repvgg_a0.py", ["--set", "model_kwargs.width=8"],
     "no deploy-forward equivalent")],
    ids=["int8", "tracking", "video", "srgan", "cyclegan", "repvgg"])
def test_export_refusals(tmp_path, config, extra, match):
    with pytest.raises(SystemExit, match=match):
        test_entry.main(["--config", os.path.join(ROOT, "configs", config),
                         "--ckpt", str(tmp_path), "--device", "cpu",
                         "--export", str(tmp_path / "a.pt2"), *extra])


@pytest.mark.parametrize("mode", ["--text", "--track", "--clips=d",
                                  "--wav=d"])
def test_serve_refuses_unported_modes(arts, mode):
    with pytest.raises(SystemExit, match="ROADMAP A17's"):
        serve.main(["--artifact", arts["flow"]["port_path"], mode,
                    "--device", "cpu"])


def test_serve_refuses_a_mode_of_another_kind(arts):
    with pytest.raises(SystemExit, match="a 'flow' artifact"):
        serve.main(["--artifact", arts["flow"]["port_path"], "--segment",
                    "--images", ".", "--device", "cpu"])
