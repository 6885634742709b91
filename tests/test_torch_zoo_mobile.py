"""The port's depthwise families against the JAX package, on the CPU:
MobileNetV2, MobileNetV3 Large and Small at width_multiplier 0.25,
EfficientNet-B0 and EfficientNetV2-S (their narrowest: neither has a
width knob), at 32x32 and 10 classes.  The machinery and the tolerances
are ``test_torch_zoo``'s: float32 eval logits within 1e-4 of max |JAX
logit|; the train step at batch 8 (logits, loss, every leaf's gradient
and the BN moving statistics within 1e-4, with JAX's dropout and
drop-path draws handed to the port by site) on weights whose gradients
the test first shows to be well conditioned, except MobileNetV2 at 0.25
and EfficientNetV2-S, which are ill conditioned at every seed and batch
tried and are held at ``test_torch_zoo``'s ``CHAOTIC`` bounds.
"""

import os

import numpy as np
import pytest
import torch

from myconvnet_tpu_torch import models, serving_http, train, weights
from test_torch_zoo import (NEW_NAMES, check_builds, check_eval,
                            check_scopes, check_train_step, make_trees)

# test name: (registry name, kwargs, the seed of its weights)
MOBILE = {
    "mobilenet_v2": ("mobilenet_v2", dict(width_multiplier=0.25), 0),
    "mobilenet_v3_large": ("mobilenet_v3_large",
                           dict(width_multiplier=0.25), 1),
    "mobilenet_v3_small": ("mobilenet_v3_small",
                           dict(width_multiplier=0.25), 2),
    "efficientnet_b0": ("efficientnet_b0", {}, 3),
    "efficientnet_v2_s": ("efficientnet_v2_s", {}, 4),
}
CHAOTIC = ("mobilenet_v2", "efficientnet_v2_s")


@pytest.mark.parametrize("case", list(MOBILE))
def test_scopes_match_the_jax_init_tree(case):
    check_scopes(*MOBILE[case][:2])


@pytest.mark.parametrize("case", list(MOBILE))
def test_eval_logits_match_jax(case):
    name, kw, seed = MOBILE[case]
    check_eval(name, kw, make_trees(name, kw, seed))


@pytest.mark.parametrize("case", list(MOBILE))
def test_train_step_matches_jax_f32(case, monkeypatch):
    name, kw, seed = MOBILE[case]
    check_train_step(name, kw, make_trees(name, kw, seed), monkeypatch,
                     chaotic=case in CHAOTIC)


@pytest.mark.parametrize("name", [n for n in NEW_NAMES if n.startswith(
    ("mobilenet", "efficientnet"))])
def test_listed_name_builds_with_the_jax_tree(name):
    check_builds(name)


def test_the_recipe_checkpoint_serves_on_the_classify_route(tmp_path):
    """``configs/imagenet_mobilenet_v2.py`` at 0.25 through ``train.main``
    (one step, float32), then its checkpoint behind the classify route:
    the route's logits (BN folded) within 1e-4 of max |logit| of the
    restored model's unfolded eval forward."""
    config = os.path.join(os.path.dirname(__file__), "..", "configs",
                          "imagenet_mobilenet_v2.py")
    sets = ["--set", "input_hw=[32,32]", "--set", "augment.out_hw=[32,32]",
            "--set", "raw_hw=[40,40]", "--set", "synthetic_n=8", "--set",
            "model_kwargs.width_multiplier=0.25", "--set", "precision=f32"]
    ckpt = str(tmp_path / "run")
    train.main(["--config", config, "--synthetic", "--device", "cpu",
                "--steps", "1", "--batch", "4", "--out", ckpt, *sets])
    cfg = os.path.join(ckpt, "config.json")
    route = serving_http.build_route("mv2", "classify", cfg, ckpt=ckpt,
                                     batch=2, device="cpu")
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    got = route.fn(x).numpy()
    model = weights.from_jax(
        models.get_model("mobilenet_v2", 1000, width_multiplier=0.25),
        *weights.load_jax_checkpoint(ckpt)).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
