"""BASELINE configs #1-#3 through the port's entry points on the CPU.

``python -m myconvnet_tpu_torch.train`` then ``.test`` on the checkpoint
it wrote, at tiny sizes: SmallNet at width 8 on CIFAR-10 (as written and
under ``precision=bf16``), SVHN and Fashion-MNIST; VGG-16 (its widths are
fixed) and DenseNet-121 at growth_rate 4 on 32x32 crops of 40x40 synthetic
ImageNet images; ResNet-50 at width 8 under
``augment.interp_dtype=bfloat16``.  Two or three steps each: every loss
finite, the checkpoint restored bit for bit, a top-1 in [0, 1].  On the
CPU every kernel wrapper runs its plain version.
"""

import json
import os

import numpy as np
import pytest
import torch

from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
IMAGENET_32 = ["input_hw=[32,32]", "augment.out_hw=[32,32]",
               "raw_hw=[40,40]"]
# recipe: (overrides, steps, batch, expected (H, W, C) of the images)
RECIPES = {
    "cifar10_smallnet": (["model_kwargs.width=8"], 3, 16, (32, 32, 3)),
    "cifar10_smallnet-bf16": (["model_kwargs.width=8", "precision=bf16"], 2,
                              16, (32, 32, 3)),
    "svhn_smallnet": (["model_kwargs.width=8"], 2, 16, (32, 32, 3)),
    "fashion_mnist_smallnet": (["model_kwargs.width=8"], 2, 16,
                               (28, 28, 3)),
    "imagenet_vgg16": (IMAGENET_32, 2, 8, (40, 40, 3)),
    "imagenet_densenet121": (["model_kwargs.growth_rate=4", *IMAGENET_32,
                              "accum_steps=2"], 2, 8, (40, 40, 3)),
    "imagenet_resnet50-bf16interp": (["model_kwargs.width=8", *IMAGENET_32,
                                      "augment.interp_dtype=bfloat16",
                                      "accum_steps=2"], 2, 8, (40, 40, 3)),
}


def config_name(recipe):
    return recipe.split("-")[0]


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_recipe_trains_and_tests_on_the_cpu(recipe, tmp_path):
    sets, steps, batch, hwc = RECIPES[recipe]
    config = os.path.join(CONFIGS, config_name(recipe) + ".py")
    out = str(tmp_path / "run")
    common = ["--config", config, "--synthetic", "--device", "cpu",
              *[a for kv in sets for a in ("--set", kv)]]
    net = train_entry.main(common + [
        "--steps", str(steps), "--batch", str(batch), "--val_every", "0",
        "--set", "log_every=1", "--out", out])
    trainer = net.trainer
    assert trainer.step == steps
    with open(os.path.join(out, "train.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    assert len(losses) == steps and np.isfinite(losses).all()
    with open(os.path.join(out, "config.json")) as f:
        model = json.load(f)["model"]
    assert model == {"imagenet_vgg16": "vgg16",
                     "imagenet_densenet121": "densenet121"}.get(
        config_name(recipe), "resnet50" if "resnet" in recipe
        else "smallnet")
    score, restored_net = test_entry.main(common + ["--ckpt", out, "--batch",
                                                    "64"])
    restored = restored_net.trainer
    assert 0.0 <= score <= 1.0 and restored.step == steps
    a, b = trainer.state(), restored.state()
    for field in ("params", "model_state"):
        for scope, d in getattr(a, field).items():
            for name, v in d.items():
                np.testing.assert_array_equal(getattr(b, field)[scope][name],
                                              v)
    x = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (2, *hwc), dtype=np.uint8))
    logits = restored.eval_step(x)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    if "bf16interp" in recipe:
        assert restored.augment.interp_dtype == "bfloat16"

