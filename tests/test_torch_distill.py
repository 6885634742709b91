"""The port's knowledge distillation against the JAX package, on the CPU.

``distillation_loss``, one step of ``configs/cifar10_distill_r18_smallnet.py``
(a SmallNet student at width 8, a ResNet-18 teacher at width 8) through
``recipes_distill.build_distill``, the teacher's three weight sources
against JAX's ``build_distill``, the checkpoint across the packages, the
entry points end to end (a teacher trained by the port's ``train.main``),
and the refusals.  Inputs are seeded numpy; weights are made in the JAX
layout and loaded through ``weights.from_jax``; the crop and flip of the
shared view come from JAX's key.  Tolerances: the loss within 1e-6
(relative) and its gradient within 1e-5 of the largest; the step's
teacher logits within 1e-5 of their largest, its loss within 1e-5, its
gradients and the parameters after the update within 1e-4 of each leaf's
largest (each ReLU's derivative where JAX's pre-activation is positive, a
disagreement within 1e-5 of 0); weight trees exactly.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from myconvnet_tpu import recipes as jrecipes
from myconvnet_tpu.ckpt import checkpoint as jckpt
from myconvnet_tpu.core.precision import FULL as JFULL
from myconvnet_tpu.core.precision import policy_scope
from myconvnet_tpu.data import augment as jaug
from myconvnet_tpu.recipes.representation import make_policy_net
from myconvnet_tpu.train import distill as jdistill
from myconvnet_tpu_torch import recipes, recipes_distill, serving, weights
from myconvnet_tpu_torch import test as test_entry
from myconvnet_tpu_torch import train as train_entry
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.train.distill import DistillDraws, \
    distillation_loss
from test_torch_seg_family import KINK, spy_relus, traced_step
from test_torch_train import _torchvision_file
from test_torch_zoo import assert_trees_close, grad_tree

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _torch_threads():
    """Each test runs at this module's thread count (1), whatever module
    was imported last: a float32 reduction's order follows the threads."""
    torch.set_num_threads(1)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "cifar10_distill_r18_smallnet.py")
CPU = torch.device("cpu")
N = 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return {s: {n: np.asarray(v) for n, v in d.items()}
            for s, d in tree.items()}


def _cfg(**distill):
    cfg = recipes.load_config(CONFIG)
    cfg.update(model_kwargs=dict(width=8, dropout_rate=0.0), batch_size=N,
               synthetic_n=32)
    cfg["distill"] = dict(cfg["distill"], teacher_kwargs=dict(width=8),
                          **distill)
    return cfg


@pytest.mark.parametrize("temperature,alpha,smoothing",
                         [(4.0, 0.9, 0.0), (2.0, 0.5, 0.1), (1.0, 1.0, 0.0)])
def test_distillation_loss_matches_jax(temperature, alpha, smoothing):
    rng = np.random.RandomState(0)
    s = (3 * rng.randn(6, 10)).astype(np.float32)
    t = (3 * rng.randn(6, 10)).astype(np.float32)
    t[0, 3] = 80.0      # a teacher row whose softmax underflows to 0
    y = rng.randint(0, 10, 6)
    st = torch.tensor(s, requires_grad=True)
    got = distillation_loss(st, _t(t), _t(y), temperature=temperature,
                            alpha=alpha, label_smoothing=smoothing)
    got.backward()
    want, jgrad = jax.value_and_grad(lambda v: jdistill.distillation_loss(
        v, jnp.asarray(t), jnp.asarray(y), temperature=temperature,
        alpha=alpha, label_smoothing=smoothing))(jnp.asarray(s))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(st.grad.numpy(), jgrad, rtol=1e-5,
                               atol=1e-5 * np.abs(jgrad).max())


def _nets(cfg):
    """JAX's student and teacher (``make_policy_net``, as build_distill
    makes them)."""
    d = cfg["distill"]
    return (make_policy_net(cfg, cfg["model"], cfg["model_kwargs"]),
            make_policy_net(cfg, d["teacher"], d["teacher_kwargs"]))


def test_distill_step_matches_jax(monkeypatch):
    """One step through ``build_distill``'s trainer at float32 with JAX's
    view: the teacher's logits, the loss, the metrics, every student
    gradient, the student's parameters after the recipe's momentum and
    its BN moving statistics; the teacher is left as it was."""
    cfg = _cfg(allow_random=True)
    trainer, train_set, _ = recipes_distill.build_distill(cfg, True,
                                                          device=CPU)
    sp, ss = weights.random_jax_params(trainer.model, 1)
    tp, ts = weights.random_jax_params(trainer.teacher, 2)
    weights.from_jax(trainer.teacher, tp, ts)
    x, y = train_set.source.get_batch(np.arange(N))
    jcfg = jrecipes.make_augment(cfg["augment"])
    k_aug = jax.random.PRNGKey(3)
    boxes, flip, _ = jaug._sample_geometry(jax.random.split(k_aug, 3)[0], N,
                                           (32, 32), jcfg)
    xa = jaug.augment_train(k_aug, jnp.asarray(x), jcfg)
    student, teacher = _nets(cfg)
    relus = spy_relus(monkeypatch)
    d = cfg["distill"]

    def jax_loss(p):
        relus.clear()
        with policy_scope(JFULL):
            t_logits, _ = teacher.apply(tp, ts, None, xa, False)
            t_logits = jax.lax.stop_gradient(t_logits)
            s_logits, new_state = student.apply(p, ss, None, xa, True)
        loss = jdistill.distillation_loss(
            s_logits, t_logits, jnp.asarray(y),
            temperature=d["temperature"], alpha=d["alpha"])
        return loss, (new_state, t_logits, s_logits, list(relus))

    (jloss, (jstate, jt, js, jzs)), jgrads = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(sp)
    jopt = jrecipes.make_optimizer(cfg["optimizer"])
    jparams, _ = jopt.update(jgrads, jopt.init(sp), sp,
                             jnp.asarray(0, jnp.int32))
    draws = DistillDraws((_t(boxes), _t(flip), None, None), None)

    def port_step():
        t, _, _ = recipes_distill.build_distill(cfg, True, device=CPU)
        weights.from_jax(t.model, sp, ss)
        weights.from_jax(t.teacher, tp, ts)
        out = t.loss(torch.from_numpy(x), torch.from_numpy(y), draws)
        out["loss"].backward()
        grads = grad_tree(t.model)
        t.optimizer.step(0)
        return t, out, grads

    _, zs = traced_step(port_step, None, monkeypatch)
    assert [tuple(z.shape) for z in zs] == [tuple(z.shape) for z in jzs]
    keeps = []
    for z, jz in zip(zs, jzs):
        jz = torch.from_numpy(np.array(jz))
        differ = (z > 0) != (jz > 0)
        if differ.any():
            assert z[differ].abs().max() <= KINK * z.abs().max()
        keeps.append(jz > 0)
    (t, out, grads), _ = traced_step(port_step, keeps, monkeypatch)
    jt = np.asarray(jt)
    np.testing.assert_allclose(out["teacher_logits"].numpy(), jt, rtol=0,
                               atol=1e-5 * np.abs(jt).max())
    np.testing.assert_allclose(float(out["loss"].detach()), float(jloss),
                               rtol=1e-5)
    assert_trees_close(grads, _np_tree(jgrads), 1e-4, "grad",
                       zero_leaves=True)
    got_p, got_s = weights.to_jax(t.model)
    assert_trees_close(got_p, _np_tree(jparams), 1e-4, "params")
    assert_trees_close(got_s, _np_tree(jstate), 1e-4, "bn state")
    tp2, ts2 = weights.to_jax(t.teacher)
    assert_trees_close(tp2, tp, 0.0, "teacher")
    # the step's metrics: the student's and the teacher's argmax
    metrics = t.train_step(torch.from_numpy(x), torch.from_numpy(y), draws)
    assert set(metrics) == {"loss", "accuracy", "teacher_agreement"}
    assert 0.0 <= float(metrics["teacher_agreement"]) <= 1.0


@pytest.fixture(scope="module")
def teacher_files(tmp_path_factory):
    """A ResNet-18 classification checkpoint (the JAX trainer's layout),
    the same trees as a flat npz, and a torchvision-layout .pth."""
    tmp = tmp_path_factory.mktemp("teacher")
    cfg = _cfg(allow_random=True)
    trainer, _, _ = recipes_distill.build_distill(cfg, True, device=CPU)
    params, state = weights.random_jax_params(trainer.teacher, 5)
    ckpt = str(tmp / "run")
    ckpt_lib.save_checkpoint(ckpt, 7, {"params": params,
                                       "model_state": state})
    npz = str(tmp / "t.npz")
    np.savez(npz, **{f"{s}::{n}": v for s, d in params.items()
                     for n, v in d.items()})
    pth = str(tmp / "r18.pth")
    _torchvision_file(pth, trainer.teacher)
    return dict(ckpt=ckpt, npz=npz, torch=dict(path=pth, depth=18)), params


@pytest.mark.parametrize("source", ["ckpt", "npz", "torch"])
def test_teacher_sources_load_what_jax_loads(teacher_files, source):
    """Each source gives the teacher JAX's ``build_distill`` gives it (the
    npz holds no BN statistics: both keep their initial 0 and 1; the
    torchvision file no head: each package keeps its own random one): the
    trees equal bit for bit."""
    files, params = teacher_files
    cfg = _cfg(**{source: files[source]})
    trainer, _, _ = recipes_distill.build_distill(cfg, True, device=CPU)
    got_p, got_s = weights.to_jax(trainer.teacher)
    jstate = jrecipes.build_distill(cfg, synthetic=True)[0]
    want_p = _np_tree(jstate.teacher_params)
    if source == "torch":
        got_p.pop("logits")
        want_p.pop("logits")
    else:
        assert_trees_close(got_p, params, 0.0, "teacher params")
    assert_trees_close(got_p, want_p, 0.0, "teacher params")
    assert_trees_close(got_s, _np_tree(jstate.teacher_state), 0.0,
                       "teacher state")


@pytest.mark.parametrize("over,match", [
    ({}, "gives no teacher weights"),
    (dict(ckpt="a", npz="b.npz"), "over-specified"),
    ("no-teacher", "needs distill=dict")])
def test_distill_refusals(over, match):
    cfg = _cfg()
    if over == "no-teacher":
        cfg["distill"] = {}
    else:
        cfg["distill"].update(over)
    with pytest.raises(ValueError, match=match):
        recipes_distill.build_distill(cfg, True, device=CPU)
    with pytest.raises(ValueError, match=match):
        jrecipes.build_distill(cfg, synthetic=True)


def test_checkpoint_crosses_the_packages(tmp_path):
    """The port's DistillState checkpoint restores in JAX (its keys
    ``student::.params::...``, the teacher beside them) and JAX's in the
    port, every tree equal."""
    cfg = _cfg(allow_random=True)
    trainer, _, _ = recipes_distill.build_distill(cfg, True, device=CPU)
    sp, ss = weights.random_jax_params(trainer.model, 8)
    weights.from_jax(trainer.model, sp, ss)
    trainer.step = 3
    trainer.save(str(tmp_path / "port"))
    jstate = jrecipes.build_distill(cfg, synthetic=True)[0]
    back = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                    jstate._asdict())
    assert_trees_close(_np_tree(back["student"].params), sp, 0.0, "student")
    assert int(back["student"].step) == 3
    tp = weights.to_jax(trainer.teacher)[0]
    assert_trees_close(_np_tree(back["teacher_params"]), tp, 0.0, "teacher")
    jckpt.save_checkpoint(str(tmp_path / "jax"), 5, jstate._asdict())
    trainer.restore(str(tmp_path / "jax"))
    assert trainer.step == int(jstate.student.step) == 0
    assert_trees_close(weights.to_jax(trainer.model)[0],
                       _np_tree(jstate.student.params), 0.0, "student")
    assert_trees_close(weights.to_jax(trainer.teacher)[0],
                       _np_tree(jstate.teacher_params), 0.0, "teacher")
    # the trees one by one, as a route or a warm start reads them
    for fields, want in ((("student::.params", "student::.model_state"),
                          jstate.student),
                         (("teacher_params", "teacher_state"),
                          (jstate.teacher_params, jstate.teacher_state))):
        p, s = weights.load_jax_checkpoint(str(tmp_path / "jax"), fields)
        assert_trees_close(p, _np_tree(want[0]), 0.0, fields[0])
        assert_trees_close(s, _np_tree(want[1]), 0.0, fields[1])


def test_entry_points_with_a_trained_teacher(tmp_path, capsys):
    """A ResNet-18 teacher trained by ``train.main``, the student distilled
    from its run directory, scored from the self-contained checkpoint
    (the teacher's run gone), and ``test --export`` of the student: a
    classify artifact with the student's eval forward."""
    import shutil
    teacher = str(tmp_path / "teacher")
    train_entry.main([
        "--config", os.path.join(ROOT, "configs", "cifar100_resnet18.py"),
        "--synthetic", "--device", "cpu", "--steps", "2", "--batch", "16",
        "--set", "model_kwargs.width=8", "--set", "num_classes=10",
        "--set", "dataset=cifar10", "--out", teacher])
    common = ["--config", CONFIG, "--synthetic", "--device", "cpu",
              "--batch", "16", "--set", "model_kwargs.width=8",
              "--set", "distill.teacher_kwargs={'width': 8}",
              "--set", f"distill.ckpt={teacher}"]
    out = str(tmp_path / "kd")
    trainer = train_entry.main(common + ["--steps", "3", "--out", out,
                                         "--set", "log_every=1",
                                         "--set", "val_every=2"])
    text = capsys.readouterr().out
    assert "step 2: val_acc" in text and "final val_acc" in text
    assert trainer.step == 3
    assert sorted(os.listdir(out)).count("best.npz") == 1
    shutil.rmtree(teacher)
    art = str(tmp_path / "student.pt2")
    acc, restored = test_entry.main(common + ["--ckpt", out, "--export",
                                              art])
    assert "student val accuracy" in capsys.readouterr().out
    assert 0.0 <= acc <= 1.0 and restored.step == 3
    meta = serving.artifact_meta(art)
    assert meta["kind"] == "classify" and meta["input_shape"] == [8, 32, 32,
                                                                  3]
    rows = np.random.RandomState(0).randn(8, 32, 32, 3).astype(np.float32)
    logits = serving.load_inference(art, "cpu")(rows)
    assert logits.shape == (8, 10) and torch.isfinite(logits).all()
