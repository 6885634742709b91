"""The FCOS and Faster R-CNN recipes through the port's entry points on the
CPU, against the JAX package's.

``train.main`` (2 steps, ``val_mAP`` logged) and ``test.main`` (VOC and
COCO mAP) on the tiny recipes at their own knobs, against JAX's
``test.py`` on the port's checkpoint; the detect artifact (``test
--export``) of a checkpoint of seeded trees against JAX's artifact of the
same checkpoint and bit for bit against its in-memory program, then
``serve --artifact --detect`` and the ``detect`` route on it.

The artifact's trees draw the RPN's objectness as
``test_torch_two_stage.make_trees`` does, at that file's cut knobs, so that
the proposals stand apart.  Tolerances: the mAP within 1e-4; the
artifact's ``valid`` and labels equal to JAX's, boxes and scores within
1e-4; the artifact and its program bit for bit.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu import serving as jserving
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu_torch import (recipes, recipes_detection, serve, serving,
                                 serving_http, weights)
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry

from test_torch_two_stage import TINY, make_trees

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_io", "voc")
CONFIGS = {"tinyfcos": os.path.join(ROOT, "configs", "voc_fcos.py"),
           "tinyfrcnn": os.path.join(ROOT, "configs", "voc_faster_rcnn.py")}


def sets(name, kw):
    return [f"model={name}", "input_hw=[128,128]", f"model_kwargs={kw!r}",
            "precision=f32"]


def argv(name, kw):
    return ["--config", CONFIGS[name], "--synthetic", "--device", "cpu",
            *[a for kv in sets(name, kw) for a in ("--set", kv)]]


def _jax_entry(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_entry", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", list(TINY))
def test_train_and_test_entry_points_match_jax(name, tmp_path, monkeypatch,
                                               capsys):
    """``train.main`` 2 steps (``val_mAP`` logged at the recipe's own tiny
    knobs), ``test.main`` VOC and COCO mAP, against JAX's ``test.py`` on
    the port's checkpoint."""
    out = str(tmp_path / "run")
    kw = {"width": 8}
    common = argv(name, kw)
    trainer = train_entry.main(common + ["--steps", "2", "--batch", "8",
                                         "--val_every", "2", "--set",
                                         "log_every=1", "--out", out])
    assert trainer.step == 2 and trainer.family in ("fcos", "two_stage")
    with open(os.path.join(out, "detection.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert any("val_mAP" in r for r in rows)
    assert all(np.isfinite(r["loss"]) for r in rows if "loss" in r)
    for extra in ([], ["--coco"]):
        score, _ = test_entry.main(common + ["--ckpt", out, "--batch", "16",
                                             *extra])
        mine = capsys.readouterr().out.splitlines()
        monkeypatch.setattr(sys, "argv", [
            "test.py", "--config", CONFIGS[name], "--ckpt", out,
            "--synthetic", "--batch", "16", *extra,
            *[a for kv in sets(name, kw) for a in ("--set", kv)]])
        _jax_entry("test").main()
        theirs = capsys.readouterr().out.splitlines()
        head = theirs[-1] if not extra else theirs[-11]
        assert head.startswith("mAP")
        assert abs(float(head.split()[-1]) - score) <= 1e-4
        assert mine[-1].split(":")[0] == theirs[-1].split(":")[0]


@pytest.fixture(scope="module", params=list(TINY))
def exported(request, tmp_path_factory):
    """A checkpoint of seeded trees, the port's artifact of it (``test
    --export``) and JAX's (its ``export_detection``)."""
    name = request.param
    kw, seed, _ = TINY[name]
    tmp = tmp_path_factory.mktemp(name)
    cfg = recipes.apply_overrides(recipes.load_config(CONFIGS[name]),
                                  sets(name, kw))
    tr, _, _ = recipes_detection.build_detector(cfg, True,
                                                device=torch.device("cpu"))
    weights.from_jax(tr.model, *make_trees(name, kw, seed))
    ckpt = str(tmp / "ckpt")
    tr.save(ckpt)
    port = str(tmp / "det.pt2")
    test_entry.main(argv(name, kw) + ["--ckpt", ckpt, "--export", port])
    jstate, _, predict, _, _ = jrecipes.build_detector(cfg, synthetic=True)
    jstate = type(jstate)(**jckpt.restore_checkpoint(ckpt,
                                                     jstate._asdict()))
    jpath = str(tmp / "det.hlo")
    jserving.export_detection(predict, jstate, np.zeros(
        (8, 128, 128, 3), np.float32), jpath)
    return dict(name=name, cfg=cfg, ckpt=ckpt, port=port, jpath=jpath,
                tmp=tmp)


def test_detect_artifact_matches_jax_and_its_program(exported):
    """The artifact (every NMS fixed-trip): bit for bit against its
    in-memory program, and the same valid detections as JAX's artifact
    of the same weights."""
    meta = serving.artifact_meta(exported["port"])
    assert meta["kind"] == "detect" and meta["input_shape"] == [8, 128, 128,
                                                                 3]
    x = np.random.RandomState(3).rand(8, 128, 128, 3).astype(np.float32)
    got = serving.load_inference(exported["port"], "cpu")(x)
    route = serving_http.build_route("d", "detect", exported["cfg"],
                                     ckpt=exported["ckpt"], device="cpu")
    for a, b in zip(got, route.fn(torch.from_numpy(x))):
        assert torch.equal(a, b)
    want = [np.asarray(w) for w in jserving.load_inference(
        exported["jpath"])(x)]
    v = want[3]
    np.testing.assert_array_equal(got[3].numpy(), v)
    assert v.any()
    np.testing.assert_array_equal(got[2].numpy()[v], want[2][v])
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy()[v], w[v], atol=1e-4)


def test_serve_artifact_and_the_route(exported, capsys):
    """``serve --artifact --detect`` on the fixture JPEGs, and the
    artifact route's detections equal to the in-memory route's."""
    config = CONFIGS[exported["name"]]
    rows = serve.main(["--artifact", exported["port"], "--detect",
                       "--images", os.path.join(FIXTURES, "JPEGImages"),
                       "--det_threshold", "0.05", "--config", config,
                       "--device", "cpu"])
    assert len(rows) == 4 and capsys.readouterr().out
    x = np.random.RandomState(4).rand(3, 128, 128, 3).astype(np.float32)
    body = json.dumps({"instances": x.tolist()}).encode()
    replies = [serving_http.ModelServer([route]).predict(
        "d", body, threshold=0.05)["detections"] for route in (
        serving_http.artifact_route("d", "detect", exported["port"], config,
                                    device="cpu"),
        serving_http.build_route("d", "detect", exported["cfg"],
                                 ckpt=exported["ckpt"], device="cpu"))]
    assert len(replies[0]) == 3 and replies[0] == replies[1]
    assert sum(len(r) for r in replies[0]) > 0
