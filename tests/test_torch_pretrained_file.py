"""The torch-file warm start (``models/pretrained.py``
``import_torch_resnet_file``, ``recipes.apply_pretrained``) and ``train
--tensorboard`` of the port, on the CPU.

A torchvision-layout ResNet-18, -50 and -101 built in torch (the exact
``state_dict`` keys, BN running buffers pushed off their init, seeded) is
saved with ``torch.save``; JAX's ``import_torch_resnet_file`` and the
port's map it onto the same trees bit for bit, and the port's ResNet with
``torch_padding`` gives the torch model's logits within 1e-5 of their
largest.  The recipe's ``pretrained`` block warm-starts a classifier and
DeepLabv3+'s backbone (``prefix="backbone/"``).  ``--tensorboard`` writes
an events file where ``tensorboard`` imports, and the run trains without
a writer where the import fails.
"""

import os
import sys

import numpy as np
import pytest
import torch

from myconvnet_tpu.models import pretrained as jpre
from myconvnet_tpu_torch import models, recipes, train, weights
from myconvnet_tpu_torch.models import pretrained
from myconvnet_tpu_torch.models.base import ConvNet
from test_pretrained_torch_file import _Basic, _Bottleneck, \
    _save_torch_resnet

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (2), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(2)


CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
NETS = {18: (_Basic, [2, 2, 2, 2]), 50: (_Bottleneck, [3, 4, 6, 3]),
        101: (_Bottleneck, [3, 4, 23, 3])}


def _tree_equal(a, b):
    assert set(a) == set(b)
    for scope in a:
        assert set(a[scope]) == set(b[scope]), scope
        for name in a[scope]:
            np.testing.assert_array_equal(np.asarray(a[scope][name]),
                                          np.asarray(b[scope][name]),
                                          err_msg=f"{scope}/{name}")


@pytest.mark.parametrize("depth", [18, 50, 101])
def test_torch_file_maps_as_jax_maps_and_gives_torch_logits(tmp_path,
                                                            depth):
    path = str(tmp_path / f"r{depth}.pth")
    block, layers = NETS[depth]
    tm = _save_torch_resnet(block, layers, 10, path, seed=depth)
    port = models.get_model(f"resnet{depth}", 10, torch_padding=True)
    params, state = weights.to_jax(port)
    got = pretrained.import_torch_resnet_file(path, params, state,
                                              depth=depth)
    want = jpre.import_torch_resnet_file(path, params, state, depth=depth)
    for g, w in zip(got, want):
        _tree_equal(g, w)
    weights.from_jax(port, *got).eval()
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
        out = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the head stays where load_head is off
    kept = pretrained.import_torch_resnet_file(path, params, state,
                                               depth=depth, load_head=False)
    np.testing.assert_array_equal(kept[0]["logits"]["w"],
                                  params["logits"]["w"])


def test_torch_file_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "r18.pth")
    _save_torch_resnet(_Basic, [2, 2, 2, 2], 10, path)
    narrow = models.get_model("resnet18", 10, width=8)
    with pytest.raises(ValueError, match="stem/conv"):
        pretrained.import_torch_resnet_file(path, *weights.to_jax(narrow),
                                            depth=18)


def _classifier_net():
    net = ConvNet(models.resnet50, input_shape=(32, 32, 3), num_classes=10,
                  device="cpu", torch_padding=True)
    return net.build()


def test_recipe_warm_start_from_a_torch_file(tmp_path, capsys):
    path = str(tmp_path / "r50.pth")
    _save_torch_resnet(_Bottleneck, [3, 4, 6, 3], 1000, path)
    net = _classifier_net()
    before = weights.to_jax(net.trainer.model)
    recipes.apply_pretrained(net, {"pretrained": dict(
        path=path, depth=50, load_head=False)})
    got = weights.to_jax(net.trainer.model)
    want = jpre.import_torch_resnet_file(path, *before, depth=50,
                                         load_head=False)
    for g, w in zip(got, want):
        _tree_equal(g, w)
    np.testing.assert_array_equal(got[0]["logits"]["w"],
                                  before[0]["logits"]["w"])
    assert f"warm-started from {path}" in capsys.readouterr().out


def test_recipe_warm_start_of_deeplabs_backbone(tmp_path):
    path = str(tmp_path / "r18.pth")
    _save_torch_resnet(_Basic, [2, 2, 2, 2], 1000, path)
    cfg = recipes.load_config(os.path.join(CONFIGS, "voc_deeplabv3plus.py"))
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], backbone_depth=18)
    cfg["pretrained"] = dict(path=path, depth=18, prefix="backbone/",
                             load_head=False)
    net, _, _ = recipes.build_segmenter(cfg, True,
                                        device=torch.device("cpu"))
    net.build(recipes.optimizer_factory(cfg["optimizer"]))
    before = weights.to_jax(net.trainer.model)
    recipes.apply_pretrained(net, cfg)
    got = weights.to_jax(net.trainer.model)
    want = jpre.import_torch_resnet_file(path, *before, depth=18,
                                         load_head=False,
                                         prefix="backbone/")
    for g, w in zip(got, want):
        _tree_equal(g, w)
    assert not np.array_equal(got[0]["backbone/stem/conv"]["w"],
                              before[0]["backbone/stem/conv"]["w"])


def test_torch_file_form_on_a_model_without_a_resnet_stem_is_refused():
    net = ConvNet(models.smallnet, input_shape=(16, 16, 3), num_classes=4,
                  width=4, device="cpu").build()
    with pytest.raises(ValueError, match="'pretrained'.*stem/conv"):
        recipes.apply_pretrained(net, {"pretrained": dict(path="x.pth")})


# ------------------------------------------------------- tensorboard

TB_ARGS = ["--config", os.path.join(CONFIGS, "cifar10_smallnet.py"),
           "--synthetic", "--device", "cpu", "--steps", "2", "--batch", "8",
           "--val_every", "1", "--set", "model_kwargs.width=4",
           "--set", "synthetic_n=16", "--tensorboard"]


def test_tensorboard_writes_an_events_file(tmp_path):
    pytest.importorskip("tensorboard")
    out = tmp_path / "run"
    net = train.main(TB_ARGS + ["--out", str(out)])
    assert net.trainer.step == 2
    events = [f for f in os.listdir(out / "tb") if "tfevents" in f]
    assert events and os.path.getsize(out / "tb" / events[0]) > 0
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(str(out / "tb"))
    acc.Reload()
    assert "loss" in acc.Tags()["scalars"]


def test_tensorboard_without_a_writer_still_trains(tmp_path, monkeypatch,
                                                   capsys):
    """Where no writer imports (the card's machine), the logger is
    JAX's: no writer, a run that trains, and one line saying so."""
    from myconvnet_tpu_torch.utils import logging as tlog
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert tlog._make_tb_writer(str(tmp_path / "x")) is None
    out = tmp_path / "run"
    net = train.main(TB_ARGS + ["--out", str(out)])
    assert net.trainer.step == 2 and net.logger._tb is None
    assert not (out / "tb").exists()
    assert "tensorboard: no writer could be made" in capsys.readouterr().out
