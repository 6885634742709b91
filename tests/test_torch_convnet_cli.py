"""The port's train and test entry points through ``ConvNet``, on the CPU.

The SmallNet recipe (``configs/cifar10_smallnet.py``) at width 4 on a
64-image synthetic split, driven in-process through ``main(argv)``: the
restart loop and fault injection, ``--resume``, ``--epochs``,
``--summary`` and ``--trace``; the test flags ``--tta``, ``--topk``,
``--report``, ``--best``, ``--average`` and ``--ema``; reduce-on-plateau
and the preemption guard; checkpoints with EMA and lookahead states
across the packages in both directions; and every key and flag the port
does not take, refused by name.  The models of the JAX side's tests are
``tests/test_cli.py:53``, ``:70``, ``:90``, ``:106``, ``:150`` and
``:236``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.train import optim as joptim
from myconvnet_tpu_torch import recipes, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.train import optim
from myconvnet_tpu_torch.utils.preemption import PreemptionGuard

torch.set_num_threads(1)

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs",
                      "cifar10_smallnet.py")
TINY = ["--set", "model_kwargs.width=4", "--set", "synthetic_n=64",
        "--set", "log_every=1"]
COMMON = ["--config", CONFIG, "--synthetic", "--device", "cpu",
          "--batch", "16", *TINY]
WRAPPED = ["--set", "optimizer.ema_decay=0.9", "--set",
           "optimizer.lookahead=2"]


def _train(out, *extra):
    return train_entry.main(COMMON + ["--out", str(out), *extra])


def _records(out):
    with open(os.path.join(out, "train.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_resume_continues_the_step_counter(tmp_path, capsys):
    out = tmp_path / "run"
    assert _train(out, "--steps", "2", "--val_every", "0").trainer.step == 2
    net = _train(out, "--steps", "4", "--val_every", "0", "--resume")
    assert net.trainer.step == 4
    assert "resumed from step 2" in capsys.readouterr().out
    steps = [r["step"] for r in _records(out) if "loss" in r]
    assert steps == [1, 2, 3, 4]


def test_fault_injection_restarts_once_and_fails_without_restarts(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("MYCONVNET_FAULT_ONCE", "1")
    out = tmp_path / "ok"
    net = _train(out, "--steps", "2", "--val_every", "0",
                 "--max_restarts", "1")
    printed = capsys.readouterr().out
    assert "[restart 1/1] after RuntimeError: injected fault" in printed
    assert "resumed from step 2" in printed
    assert "final val accuracy" in printed and net.trainer.step == 2
    assert os.path.exists(out / ".fault_injected")
    with pytest.raises(RuntimeError, match="injected fault"):
        _train(tmp_path / "fails", "--steps", "1", "--val_every", "0")


def test_epochs_resolve_the_schedules_horizon(tmp_path):
    out = tmp_path / "run"
    net = _train(out, "--epochs", "2", "--val_every", "0")
    # 64 images at batch 16, whole batches: 4 steps an epoch
    assert net.trainer.step == 8
    with open(out / "config.json") as f:
        cfg = json.load(f)
    assert cfg["total_steps"] == 8 and cfg["optimizer"]["lr"][
        "total_steps"] == 8
    lr = net.optimizer.schedule
    assert lr(8) == 0.0 < lr(7)


def test_summary_and_trace(tmp_path, capsys):
    out = tmp_path / "run"
    _train(out, "--steps", "1", "--val_every", "0", "--summary", "--trace")
    printed = capsys.readouterr().out
    assert "forward GFLOPs/img" in printed and "total" in printed
    with open(out / "trace" / "trace.json") as f:
        assert json.load(f)["traceEvents"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """Four steps with EMA and lookahead, a validation (and checkpoint)
    every step; ``best.npz`` at the first."""
    out = tmp_path_factory.mktemp("wrapped") / "run"
    _train(out, "--steps", "4", "--val_every", "1", *WRAPPED)
    return str(out)


@pytest.mark.parametrize("flags,printed", [
    (["--tta", "flip"], "accuracy:"),
    (["--tta", "ten_crop"], "accuracy:"),
    (["--topk", "5"], "top5_accuracy:"),
    (["--report"], "macro f1"),
    (["--topk", "3", "--report", "--tta", "flip"], "macro f1"),
    (["--best"], "accuracy:"),
    (["--average", "2"], "averaged params over the last 2 checkpoints"),
    (["--ema"], "evaluating EMA parameters")],
    ids=["tta_flip", "tta_ten_crop", "topk", "report", "topk_report_tta",
         "best", "average", "ema"])
def test_test_flags_run_and_print(run_dir, capsys, flags, printed):
    score, net = test_entry.main(COMMON + WRAPPED + ["--ckpt", run_dir,
                                                     *flags])
    out = capsys.readouterr().out
    assert printed in out and 0.0 <= score <= 1.0
    if "--topk" in flags:
        assert f"top{flags[flags.index('--topk') + 1]}_accuracy:" in out


def test_best_average_and_ema_restore_what_they_name(run_dir):
    _, best = test_entry.main(COMMON + WRAPPED + ["--ckpt", run_dir,
                                                  "--best"])
    with open(os.path.join(run_dir, "best.json")) as f:
        assert best.trainer.step == json.load(f)["step"] == 1
    _, avg = test_entry.main(COMMON + WRAPPED + ["--ckpt", run_dir,
                                                 "--average", "2"])
    a, b = (np.load(os.path.join(run_dir, f"ckpt-{s}.npz")) for s in (3, 4))
    got = weights.to_jax(avg.trainer.model)[0]
    for key in a.files:
        if key.startswith("params::"):
            _, scope, name = key.split("::")
            want = ((a[key].astype(np.float64) + b[key]) / 2).astype(
                np.float32)
            np.testing.assert_array_equal(got[scope][name], want)
    assert avg.trainer.step == 4
    _, ema = test_entry.main(COMMON + WRAPPED + ["--ckpt", run_dir,
                                                 "--ema"])
    got = weights.to_jax(ema.trainer.model)[0]
    with np.load(os.path.join(run_dir, "ckpt-4.npz")) as f:
        for key in f.files:
            if key.startswith("opt_state::.ema::"):
                scope, name = key.split("::")[2:]
                np.testing.assert_array_equal(got[scope][name], f[key])


def test_ema_without_the_wrapper_is_refused(run_dir, tmp_path):
    out = tmp_path / "plain"
    _train(out, "--steps", "1", "--val_every", "0")
    with pytest.raises(ValueError, match="no EMA"):
        test_entry.main(COMMON + ["--ckpt", str(out), "--ema"])


def test_plateau_halves_the_scale_after_each_round_without_gain(tmp_path):
    """lr 0: the weights never move, so every validation after the first
    is no gain, and with patience 1 the scale halves at each."""
    out = tmp_path / "run"
    net = _train(out, "--steps", "4", "--val_every", "1",
                 "--set", "optimizer.lr=0.0", "--set",
                 "optimizer.plateau=True", "--set", "plateau_factor=0.5",
                 "--set", "plateau_patience=1")
    scales = [r["lr_scale"] for r in _records(out) if "lr_scale" in r]
    assert scales == [0.5, 0.25, 0.125]
    assert optim.plateau_scale(net.optimizer) == 0.125
    with pytest.raises(ValueError, match="plateau"):
        _train(tmp_path / "refused", "--steps", "1", "--val_every", "1",
               "--set", "optimizer.plateau=True", "--set",
               "optimizer.lookahead=2", "--set", "plateau_factor=0.5",
               "--set", "plateau_patience=1", "--max_restarts", "0")


def test_preemption_stops_saves_and_returns(tmp_path):
    cfg = recipes.apply_overrides(recipes.load_config(CONFIG),
                                  [t for t in TINY if t != "--set"])
    net, train_set, _ = recipes.build_classifier(
        cfg, True, device=torch.device("cpu"), ckpt_dir=str(tmp_path))
    guard = PreemptionGuard()
    net.preemption_guard = guard
    net.train(train_set, batch_size=16, total_steps=3)
    assert net.trainer.step == 3
    guard.trigger()
    net.train(train_set, batch_size=16, total_steps=6)
    assert net.trainer.step == 3      # stopped before a step, saved
    assert os.path.exists(tmp_path / "ckpt-3.npz")


# --------------------------------------- checkpoints across the packages


def _jax_cfg():
    cfg = jrecipes.load_config(CONFIG)
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], width=4)
    cfg["optimizer"] = dict(cfg["optimizer"], ema_decay=0.9, lookahead=2)
    return cfg


def test_a_jax_checkpoint_with_ema_and_lookahead_is_scored_with_ema(
        tmp_path):
    """Three JAX steps with EMA and lookahead (a lookahead sync at step
    2); the port's ``test.main --ema`` restores every state and scores
    the EMA weights: its logits are JAX's with the EMA in place, 1e-5."""
    cfg = _jax_cfg()
    out = str(tmp_path / "jax")
    net, train_set, val_set = jrecipes.build_classifier(cfg, True,
                                                        ckpt_dir=out)
    opt = jrecipes.make_optimizer(cfg["optimizer"])
    net.train(train_set, batch_size=16, total_steps=3, optimizer=opt)
    net.save(out)
    score, port = test_entry.main(COMMON + WRAPPED + ["--ckpt", out,
                                                      "--ema"])
    st = port.trainer.state()
    assert int(st.step) == 3
    state = net.state
    assert int(state.opt_state.inner.count) == 1
    np.testing.assert_array_equal(
        st.opt_state[".inner"][".slow"]["conv"]["w"],
        np.asarray(state.opt_state.inner.slow["conv"]["w"]))
    ema = joptim.extract_ema(state.opt_state)
    net.state = state._replace(params=jax.tree.map(
        lambda p, e: e.astype(p.dtype), state.params, ema))
    x = val_set.source.images[:8]
    _close = np.testing.assert_allclose
    want = net.predict(x, batch_size=8)
    _close(port.predict(x, batch_size=8), want, rtol=1e-5,
           atol=1e-5 * np.abs(want).max())


def test_a_port_checkpoint_with_ema_and_lookahead_restores_in_jax(
        tmp_path):
    out = tmp_path / "port"
    port = _train(out, "--steps", "3", "--val_every", "0", *WRAPPED)
    cfg = _jax_cfg()
    net, _, _ = jrecipes.build_classifier(cfg, True)
    net.build(jrecipes.make_optimizer(cfg["optimizer"]))
    restored = jckpt.restore_checkpoint(str(out), net.state._asdict())
    mine = port.trainer.state()._asdict()
    flat = jckpt._flatten(restored)
    assert set(flat) == set(recipes_flat(mine))
    for key, value in recipes_flat(mine).items():
        np.testing.assert_array_equal(np.asarray(flat[key]), value,
                                      err_msg=key)
    assert int(restored["opt_state"].inner.count) == 1
    assert isinstance(restored["opt_state"], joptim.EmaOptState)


def recipes_flat(state):
    from myconvnet_tpu_torch.ckpt.checkpoint import flatten
    return flatten(state)


# ---------------------------------------------------- keys and refusals


def _cfg(**sets):
    cfg = recipes.load_config(CONFIG)
    cfg["model_kwargs"] = dict(cfg["model_kwargs"], width=4)
    cfg["synthetic_n"] = 64
    for key, value in sets.items():
        *path, last = key.split(".")
        target = cfg
        for part in path:
            target[part] = dict(target[part])
            target = target[part]
        target[last] = value
    return cfg


# the keys the JAX builders read that the port trains now, each at the
# value the repo's recipes document or a small one, and what it sets
NOW_TRAINED = {
    "erase_prob": (0.25, lambda t: t.erase_prob == 0.25),
    "sam_rho": (0.05, lambda t: t.sam_rho == 0.05),
    "optimizer.ema_decay": (0.9999, lambda t: isinstance(
        t.optimizer, optim.Ema) and t.optimizer.decay == 0.9999),
    "optimizer.plateau": (True, lambda t: optim.plateau_scale(
        t.optimizer) == 1.0),
    "optimizer.lookahead": (5, lambda t: isinstance(
        t.optimizer, optim.Lookahead) and t.optimizer.sync_period == 5),
    "optimizer.freeze": (["conv/"], lambda t: isinstance(
        t.optimizer, optim.Frozen) and len(t.optimizer.frozen) == 1),
    "cls_loss": ("focal", None),
}


@pytest.mark.parametrize("key", list(NOW_TRAINED))
def test_recipe_keys_the_port_now_trains(key):
    value, check = NOW_TRAINED[key]
    cfg = _cfg(**{key: value})
    if key == "cls_loss":
        cfg["mix"] = None
    trainer, train_set, _ = recipes.build_trainer(
        cfg, True, device=torch.device("cpu"))
    if check is not None:
        assert check(trainer)
    x, y = train_set.source.get_batch(np.arange(16))
    metrics = trainer.train_step(torch.from_numpy(x), torch.from_numpy(y))
    assert trainer.step == 1 and np.isfinite(float(metrics["loss"]))


@pytest.mark.parametrize("sets,match", [
    (dict(cls_loss="focal", mix=dict(mixup_alpha=0.2)), "'mix'"),
    (dict(cls_loss="focal", label_smoothing=0.1), "label_smoothing"),
    (dict(cls_loss="hinge"), "cls_loss"),
    (dict(pretrained=dict(path="r50.pth")), "'pretrained'"),
    (dict(pretrained="encoder.npz"), "'pretrained'"),
    (dict(task="detection"), "tasks")],
    ids=["focal_mix", "focal_smoothing", "unknown_loss", "torch_file",
         "bare_path", "task"])
def test_recipe_values_are_refused_by_name(sets, match):
    with pytest.raises(ValueError, match=match):
        recipes.build_trainer(_cfg(**sets), True,
                              device=torch.device("cpu"))


@pytest.mark.parametrize("entry,flags,match", [
    ("train", ["--mesh", "4x2"], "--mesh"),
    ("test", ["--fid"], "--fid"),
    ("test", ["--export", "x", "--int8"], "--int8"),
    ("test", ["--tta", "x8"], "x8")],
    ids=["mesh", "fid", "export", "tta_x8"])
def test_flags_the_port_does_not_take_are_refused_by_name(tmp_path, entry,
                                                          flags, match):
    if entry == "train":
        with pytest.raises(SystemExit, match=match):
            _train(tmp_path / "run", "--steps", "1", *flags)
    else:
        with pytest.raises(SystemExit, match=match):
            test_entry.main(COMMON + ["--ckpt", str(tmp_path), *flags])


def test_port_modules_import_no_jax():
    """No module of the port that these tests loaded imports JAX or the
    JAX package."""
    import sys
    port = [m for m in sys.modules if m.startswith("myconvnet_tpu_torch")]
    for name in port:
        mod = sys.modules[name]
        src = getattr(mod, "__file__", None)
        if src and src.endswith(".py"):
            with open(src) as f:
                text = f.read()
            assert "import jax" not in text and \
                "from myconvnet_tpu." not in text and \
                "from myconvnet_tpu " not in text, name
