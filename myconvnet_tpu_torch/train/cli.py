"""Training entry point of the port (classification, segmentation,
optical-flow, metric-learning, depth, detection, GAN, self-supervised,
semi-supervised and distillation recipes).

    python -m myconvnet_tpu_torch.train --config configs/cifar100_resnet18.py \\
        --synthetic --steps N --out DIR [--batch N] [--val_every N] \\
        [--epochs N] [--accum_steps N] [--resume] [--max_restarts N] \\
        [--summary] [--trace] [--set KEY=VALUE ...] [--device cuda]

Port of ``train.py:22-213``: config -> the task's ``ConvNet`` builder ->
:func:`run_supervised` (``train.py:141-206``): ``--epochs`` resolved into
``total_steps`` (and the schedule's) before the optimizer is built, a
``pretrained`` warm start unless resuming, ``--resume`` from the newest
checkpoint under ``--out``, ``ConvNet.train`` under a
:class:`PreemptionGuard` (and a ``torch.profiler`` trace under
``--out/trace`` with ``--trace``), the final validation (the state
saved once a step: ``train.py``'s save after it rewrites what ``fit``
wrote, and is left out).  A
crash restarts from the newest checkpoint up to ``--max_restarts`` times
(``train.py:124-138``); ``MYCONVNET_FAULT_ONCE`` injects one crash after
training, to test that path.  A GAN recipe (``task="gan"``) goes to
:func:`run_gan`, the port of ``run_steploop`` with ``adapt_gan``
(``train.py:216``, ``:450``); a self-supervised (``task="ssl"``), FixMatch
(``task="semisup"``) or distillation (``task="distill"``) one to
:func:`run_steploop` (``train.py:216-327``) through :func:`adapt_ssl`,
:func:`adapt_semisup` or :func:`adapt_distill` (``:358-404``), a
one-stage detection recipe (``task="detection"``) through
:func:`adapt_detection` (``:339-355``: ``val_mAP`` the validation score);
a metric-learning or depth recipe is a ConvNet run.  A recipe
with a ``pipeline`` block (GPipe, ``train.py:112-122``) is refused by
name (ROADMAP A16).  ``--tensorboard``
logs to a ``SummaryWriter`` under ``--out/tb`` where the ``tensorboard``
package imports, and says so and trains without one where it does not
(the card's machine); ``--mesh`` is refused by name (ROADMAP A16).
``--device`` defaults to ``cuda``; without CUDA that is an error (pass
``--device cpu`` to train on the host).  ``main(argv)`` returns the
``ConvNet`` (its ``trainer`` holds the step, the model and the
optimizer), or the GAN, SSL, FixMatch or distillation trainer.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch


def resolve_device(name: str) -> torch.device:
    """The requested device; a CUDA device without CUDA raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: CUDA is not available (pass "
                         "--device cpu to run on the host)")
    return device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--synthetic", action="store_true",
                    help="use generated data (no corpus required)")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None,
                    help="train for N epochs of the train split "
                         "(overrides total_steps)")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--out", default=None, help="run dir (ckpts + logs)")
    ap.add_argument("--val_every", type=int, default=None)
    ap.add_argument("--accum_steps", type=int, default=None,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--mesh", default=None,
                    help="not ported (ROADMAP A16)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --out")
    ap.add_argument("--max_restarts", type=int, default=0,
                    help="on a crash, restart from the latest checkpoint "
                         "up to N times")
    ap.add_argument("--tensorboard", action="store_true",
                    help="also log scalars and images to TensorBoard "
                         "under --out/tb (where the tensorboard package "
                         "imports)")
    ap.add_argument("--trace", action="store_true",
                    help="write a torch.profiler Chrome trace of the run "
                         "under --out/trace")
    ap.add_argument("--summary", action="store_true",
                    help="print the model's per-scope parameter table "
                         "(+ forward GFLOPs) before training")
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE", dest="overrides",
                    help="override a config entry (repeatable; dotted "
                         "keys reach nested dicts)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh:
        raise SystemExit("train --mesh is not ported (ROADMAP A16)")

    from myconvnet_tpu_torch import recipes

    device = resolve_device(args.device)
    cfg = recipes.load_config(args.config)
    for key, value in (("total_steps", args.steps),
                       ("epochs", args.epochs),
                       ("batch_size", args.batch),
                       ("data_dir", args.data_dir),
                       ("val_every", args.val_every),
                       ("accum_steps", args.accum_steps)):
        if value is not None:
            cfg[key] = value
    cfg = recipes.apply_overrides(cfg, args.overrides)
    out = args.out or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(out, exist_ok=True)
    # reproducibility: the resolved config (file + command-line overrides)
    write_config(cfg, out)

    task = recipes.check_task(cfg)
    if task == "gan":
        return run_gan(cfg, args.synthetic, out, device)
    if task in STEPLOOP_ADAPTERS:
        return run_steploop(cfg, args, out, device, STEPLOOP_ADAPTERS[task])
    try:
        recipes.refuse_pipeline(cfg)
    except ValueError as e:
        raise SystemExit(f"train: {e}") from e
    attempts = 0
    while True:
        try:
            return run_supervised(cfg, args, out, device,
                                  resume=args.resume or attempts > 0)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:  # a crash: resume from the newest ckpt
            attempts += 1
            if attempts > args.max_restarts:
                raise
            print(f"[restart {attempts}/{args.max_restarts}] after "
                  f"{type(e).__name__}: {e}; resuming from latest "
                  f"checkpoint in {out}", flush=True)


def write_config(cfg: dict, out: str) -> None:
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1, default=str)


def run_supervised(cfg: dict, args, out: str, device: torch.device,
                   resume: bool):
    """One attempt of a ConvNet-API run (``train.py:141-206``); returns
    the net."""
    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
    from myconvnet_tpu_torch.utils.preemption import PreemptionGuard

    builder = recipes.convnet_builder(cfg["task"])
    net, train_set, val_set = builder(cfg, args.synthetic, device=device,
                                      ckpt_dir=out, log_dir=out)
    with PreemptionGuard() as guard:
        net.preemption_guard = guard
        if args.tensorboard:
            from myconvnet_tpu_torch.utils.logging import MetricLogger
            net.logger.close()
            net.logger = MetricLogger(out, tensorboard=True)
        if cfg.get("epochs"):
            # before the optimizer is built, so that a schedule's horizon
            # is the run's
            spe = max(len(train_set) // cfg["batch_size"], 1)
            cfg["total_steps"] = int(cfg["epochs"]) * spe
            lr = cfg.get("optimizer", {}).get("lr")
            if isinstance(lr, dict) and "total_steps" in lr:
                lr["total_steps"] = cfg["total_steps"]
            write_config(cfg, out)
        evaluator = recipes.build_evaluator(cfg)
        optimizer = recipes.optimizer_factory(cfg["optimizer"])
        if args.summary:
            net.build(optimizer)
            net.summary()
        if cfg.get("pretrained") and not resume:
            # the checkpoint of a resumed run holds the trained weights
            net.build(optimizer)
            recipes.apply_pretrained(net, cfg)
        if resume and ckpt_lib.latest_checkpoint(out):
            net.build(optimizer)
            net.restore(out)
            print(f"resumed from step {net.trainer.step}", flush=True)
        train_kw = dict(batch_size=cfg["batch_size"],
                        total_steps=cfg["total_steps"],
                        optimizer=optimizer, evaluator=evaluator,
                        val_every=cfg.get("val_every", 0),
                        early_stop_patience=cfg.get("early_stop_patience",
                                                    0),
                        plateau_factor=cfg.get("plateau_factor", 0.0),
                        plateau_patience=cfg.get("plateau_patience", 0))
        if args.trace:
            from myconvnet_tpu_torch.utils.profiling import trace
            with trace(os.path.join(out, "trace")):
                net.train(train_set, val_set, **train_kw)
            print(f"trace: {os.path.join(out, 'trace')}", flush=True)
        else:
            net.train(train_set, val_set, **train_kw)
        # a crash exactly once, after training (a checkpoint exists) and
        # before the evaluation: the restart path's test
        if os.environ.get("MYCONVNET_FAULT_ONCE"):
            marker = os.path.join(out, ".fault_injected")
            if not os.path.exists(marker):
                open(marker, "w").close()
                raise RuntimeError("injected fault (MYCONVNET_FAULT_ONCE)")
        score = net.evaluate(val_set, evaluator,
                             batch_size=cfg["batch_size"])
        print(f"final val {evaluator.name}: {score:.4f}", flush=True)
        # (no save here, as train.py has: net.train's fit wrote this
        # state, and the evaluation changes nothing of it)
    net.logger.close()
    return net


def run_gan(cfg: dict, synthetic: bool, out: str, device: torch.device):
    """A GAN recipe's step loop: a log line and a checkpoint every
    ``log_every`` steps, a sample grid every ``sample_every`` (DCGAN: 16
    samples from seed 0; pix2pix: the first batch's 16 inputs translated),
    the final checkpoint.  Returns the trainer."""
    from myconvnet_tpu_torch import recipes_gan
    from myconvnet_tpu_torch.utils.images import make_grid
    from myconvnet_tpu_torch.utils.logging import MetricLogger

    trainer, train_set = recipes_gan.build_gan(cfg, synthetic,
                                               device=device)
    name = f"gan_{trainer.kind}"
    logger = MetricLogger(out, name=name)
    sample_every = cfg.get("sample_every", 0)
    sampler = recipes_gan.make_gan_sampler(cfg) if sample_every else None

    def sample(step, first):
        imgs = (sampler(trainer, 16, seed=0) if trainer.kind == "dcgan"
                else sampler(trainer, first[0]))
        logger.log_image(step, "samples", make_grid(imgs.cpu().numpy()))

    trainer.fit(train_set.train_iter(cfg["batch_size"], device),
                total_steps=cfg["total_steps"],
                log_every=cfg.get("log_every", 100), logger=logger,
                ckpt_dir=out, sample_every=sample_every,
                sample=sample if sampler else None)
    logger.close()
    print(f"{name} training done at step {trainer.step}", flush=True)
    return trainer


def knn_kwargs(cfg: dict) -> dict:
    """The probe's settings of a recipe (``train.py:364-367``)."""
    return dict(k=cfg.get("knn_k", 20), num_classes=cfg["num_classes"],
                max_bank=cfg.get("knn_bank", 4096),
                max_query=cfg.get("knn_query", 2048))


def run_steploop(cfg: dict, args, out: str, device: torch.device,
                 adapter):
    """The step loop of a fused-step family (``train.py:216-327``):
    ``adapter(cfg, args, out, device)`` gives the spec (``name``, ``trainer``
    with ``step``, ``train_step(*batch)``, ``save`` and ``restore``,
    ``make_iter`` of batches of device tensors, optional ``validate``
    returning (metric name, score), ``display`` names for the printed
    metric and ``finalize`` run after the final validation); ``--resume``
    from the newest checkpoint, the metrics (with the uint8 images a
    second) and a checkpoint every ``log_every`` steps (the newest two
    kept), the validation every ``val_every`` steps (``best.npz`` when it
    improves), the final checkpoint (unless the last step's was just
    written) and validation.  Returns the
    trainer."""
    from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
    from myconvnet_tpu_torch.utils.logging import MetricLogger
    from myconvnet_tpu_torch.utils.preemption import PreemptionGuard

    spec = adapter(cfg, args, out, device)
    trainer, name = spec["trainer"], spec["name"]
    if args.resume and ckpt_lib.latest_checkpoint(out):
        trainer.restore(out)
        print(f"resumed {name} from step {trainer.step}", flush=True)
    log_every = cfg.get("log_every", 100)
    val_every = cfg.get("val_every", 0)
    validate = spec.get("validate")
    display = spec.get("display", {})
    best = saved_at = None
    logger = MetricLogger(out, name=name)
    with PreemptionGuard() as guard:
        it = spec["make_iter"]()
        t0, window = time.perf_counter(), 0
        try:
            while trainer.step < cfg["total_steps"]:
                if guard.preempted:
                    logger.log(trainer.step, {"preempted": 1.0})
                    break
                try:
                    batch = next(it)
                except StopIteration:
                    break
                metrics = trainer.train_step(*batch)
                window += sum(len(b) for b in batch
                              if b.dtype == torch.uint8)
                if trainer.step % log_every == 0:
                    host = {k: float(v) for k, v in metrics.items()}
                    host["images_per_sec"] = window / (time.perf_counter()
                                                       - t0)
                    logger.log(trainer.step, host)
                    trainer.save(out)
                    saved_at = trainer.step
                    t0, window = time.perf_counter(), 0
                if validate is not None and val_every \
                        and trainer.step % val_every == 0:
                    key, score = validate()
                    logger.log(trainer.step, {key: score})
                    print(f"step {trainer.step}: {display.get(key, key)} "
                          f"{score:.4f}", flush=True)
                    if best is None or score > best:
                        best = score
                        trainer.save(out, metric=score, is_best=True)
                        saved_at = trainer.step
        finally:
            if hasattr(it, "close"):
                it.close()
        if saved_at != trainer.step:   # else written at this very step
            trainer.save(out)
        if validate is not None:
            key, score = validate()
            top = best if best is not None and best > score else score
            extra = f" (best {top:.4f})" if best is not None else ""
            print(f"final {display.get(key, key)}: {score:.4f}{extra}",
                  flush=True)
        if spec.get("finalize") is not None:
            spec["finalize"]()
    logger.close()
    print(f"{name} training done at step {trainer.step}", flush=True)
    return trainer


def adapt_ssl(cfg: dict, args, out: str, device: torch.device) -> dict:
    """A self-supervised recipe's spec (``train.py:358-383``): the train
    split's images (the labels reach only the probe), the kNN probe as
    ``knn_top1``, then ``<out>/encoder.npz``."""
    from myconvnet_tpu_torch import recipes_ssl

    trainer, train_set, val_set = recipes_ssl.build_ssl(
        cfg, args.synthetic, device=device)
    batch = cfg["batch_size"]

    def images():
        it = train_set.train_iter(batch, device)
        try:
            for x, _ in it:
                yield (x,)
        finally:
            it.close()

    def finalize():
        enc = trainer.export_encoder(os.path.join(out, "encoder.npz"))
        print(f"encoder exported: {enc}", flush=True)

    return dict(name=f"ssl_{trainer.kind}", trainer=trainer,
                make_iter=images, display={"knn_top1": "kNN top-1"},
                validate=lambda: ("knn_top1", trainer.knn(
                    train_set.eval_iter(batch, device),
                    val_set.eval_iter(batch, device), **knn_kwargs(cfg))),
                finalize=finalize)


def adapt_semisup(cfg: dict, args, out: str, device: torch.device) -> dict:
    """FixMatch's spec (``train.py:386-393``): the zipped labeled and
    unlabeled batches, the EMA top-1 as ``val_acc``."""
    from myconvnet_tpu_torch import recipes_semisup

    trainer, batches, val_set = recipes_semisup.build_semisup(
        cfg, args.synthetic, device=device)
    eval_batch = cfg.get("eval_batch", cfg["batch_size"])
    return dict(name="semisup_fixmatch", trainer=trainer,
                make_iter=batches,
                validate=lambda: ("val_acc", trainer.evaluate(
                    val_set.eval_iter(eval_batch, device))))


def adapt_distill(cfg: dict, args, out: str, device: torch.device) -> dict:
    """Distillation's spec (``train.py:396-404``): the train split's
    batches, the student's top-1 as ``val_acc``."""
    from myconvnet_tpu_torch import recipes_distill

    trainer, train_set, val_set = recipes_distill.build_distill(
        cfg, args.synthetic, device=device)
    eval_batch = cfg.get("eval_batch", cfg["batch_size"])
    return dict(name="distill", trainer=trainer,
                make_iter=lambda: train_set.train_iter(cfg["batch_size"],
                                                       device),
                validate=lambda: ("val_acc", trainer.evaluate(
                    val_set.eval_iter(eval_batch, device))))


def adapt_detection(cfg: dict, args, out: str, device: torch.device
                    ) -> dict:
    """A detection recipe's spec (``train.py:339-355``): the train split's
    (images, boxes, labels) batches, the val split's mAP as ``val_mAP``."""
    from myconvnet_tpu_torch import recipes, recipes_detection

    trainer, train_set, val_set = recipes_detection.build_detector(
        cfg, args.synthetic, device=device)
    evaluator = recipes.build_evaluator(cfg)
    batch = cfg["batch_size"]
    return dict(name="detection", trainer=trainer,
                make_iter=lambda: train_set.train_iter(batch, device),
                display={"val_mAP": "val mAP"},
                validate=lambda: ("val_mAP",
                                  recipes_detection.evaluate_detection(
                                      trainer, val_set, batch, evaluator)))


# task -> its run_steploop adapter (``train.py:476-484``, the tasks the
# port has)
STEPLOOP_ADAPTERS = {"ssl": adapt_ssl, "semisup": adapt_semisup,
                     "distill": adapt_distill, "detection": adapt_detection}


if __name__ == "__main__":
    main()
