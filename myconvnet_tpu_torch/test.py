"""Evaluation entry point of the port (classification, segmentation,
optical-flow and pix2pix recipes).

    python -m myconvnet_tpu_torch.test --config configs/cifar100_resnet18.py \\
        --synthetic --ckpt DIR [--batch N] [--best | --average N] [--ema] \\
        [--tta flip|ten_crop] [--topk K] [--report] [--calibrate] \\
        [--scales S,S,...] [--set KEY=VALUE ...] [--device cuda]

Port of ``test.py:148-240`` (``eval_convnet``): build the recipe's
``ConvNet`` with its optimizer, restore ``--ckpt`` (a ``.npz`` or the
directory holding them, written by either package; ``--best`` its
``best.npz``, ``--average N`` the float64 mean of the last N
checkpoints' parameters), put the EMA in place of the parameters with
``--ema``, and score the validation split: top-k accuracy with
``--topk``, a per-class report with ``--report`` (both in one pass
together), the flip or ten-crop TTA with ``--tta``, or segmentation's
multi-scale + flip protocol with ``--scales``.  ``--calibrate`` (a
classifier) fits a softmax temperature on the validation logits, prints
the ECE before and after, and writes ``calibration.json`` beside the
checkpoint (``test.py:242-267``).  ``--tta x8`` (the super-resolution
self-ensemble, ROADMAP A17), ``--fid`` (ROADMAP A8) and ``--export``
(ROADMAP A15) are refused by name.  A GAN recipe goes to :func:`eval_gan` (``test.py:120``): pix2pix
is scored on the val pairs with PSNR and SSIM (``eval_pix2pix``,
``test.py:646``), each batch rescaled by B2 and translated by G's eval
forward; an unconditional DCGAN checkpoint is not scored here.
``main(argv)`` returns (score, net); for pix2pix (psnr, ssim) and the
GAN trainer.
"""

from __future__ import annotations

import argparse
import os

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint .npz or its directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--best", action="store_true",
                    help="restore best.npz instead of the newest")
    ap.add_argument("--average", type=int, default=0, metavar="N",
                    help="average the params of the last N checkpoints")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--data_dir", default=None)
    ap.add_argument("--tta", default=None,
                    choices=("flip", "ten_crop", "x8"),
                    help="classification test-time augmentation (x8 is "
                         "not ported)")
    ap.add_argument("--ema", action="store_true",
                    help="evaluate the EMA parameters (needs "
                         "optimizer.ema_decay in the config)")
    ap.add_argument("--topk", type=int, default=1,
                    help="score top-k accuracy (classification)")
    ap.add_argument("--report", action="store_true",
                    help="print the per-class precision/recall/F1 report "
                         "(classification)")
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE", dest="overrides")
    ap.add_argument("--scales", default=None,
                    help="segmentation: comma-separated input scales of the "
                         "multi-scale + flip eval")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit a softmax temperature on the val split and "
                         "report ECE before/after (classification)")
    ap.add_argument("--fid", action="store_true",
                    help="not ported (FID needs eval/gan_metrics.py)")
    ap.add_argument("--export", default=None,
                    help="not ported (the exporters are ROADMAP A15)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for flag, where in (("fid", "eval/gan_metrics.py, ROADMAP A8"),
                        ("export", "export_cli.py, ROADMAP A15")):
        if getattr(args, flag):
            raise SystemExit(f"test --{flag} is not ported ({where})")
    if args.tta == "x8":
        raise SystemExit("test --tta x8 is not ported (the "
                         "super-resolution self-ensemble, ROADMAP A17)")

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.train.cli import resolve_device

    device = resolve_device(args.device)
    cfg = recipes.apply_overrides(recipes.load_config(args.config),
                                  args.overrides)
    for key, value in (("batch_size", args.batch),
                       ("data_dir", args.data_dir)):
        if value is not None:
            cfg[key] = value
    if recipes.check_task(cfg) == "gan":
        return eval_gan(cfg, args, device)
    return eval_convnet(cfg, args, device)


def eval_convnet(cfg: dict, args, device):
    """Restore, then score; returns (score, net)."""
    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
    from myconvnet_tpu_torch.eval.evaluators import (AccuracyEvaluator,
                                                     ConfusionMatrixEvaluator,
                                                     JointEvaluator)
    from myconvnet_tpu_torch.train import optim

    task = cfg["task"]
    net, _, val_set = recipes.convnet_builder(task)(
        cfg, args.synthetic, device=device, ckpt_dir=args.ckpt)
    evaluator = recipes.build_evaluator(cfg)
    if args.topk > 1 and task == "classification":
        evaluator = AccuracyEvaluator(k=args.topk)
    if args.report and task == "classification":
        cm = ConfusionMatrixEvaluator(cfg["num_classes"])
        # with --topk: top-k scored and the report made in one pass
        evaluator = JointEvaluator(evaluator, cm) if args.topk > 1 else cm
    net.build(recipes.optimizer_factory(cfg["optimizer"]))
    path = args.ckpt
    if args.best:
        path = ckpt_lib.best_checkpoint(args.ckpt)
        if path is None:
            raise SystemExit(f"no best.npz under {args.ckpt!r}")
    if args.average > 1:
        ckpt_dir = (os.path.dirname(args.ckpt)
                    if os.path.isfile(args.ckpt) else args.ckpt)
        net.state = net.state._replace(**ckpt_lib.average_checkpoints(
            ckpt_dir, net.state._asdict(), n_last=args.average))
        print(f"averaged params over the last "
              f"{min(args.average, len(ckpt_lib.all_steps(ckpt_dir)))} "
              "checkpoints", flush=True)
    else:
        net.restore(path)
    if args.ema:
        # the EMA is float32; each parameter takes it in its own dtype
        ema = optim.extract_ema(net.optimizer)
        with torch.no_grad():
            for path_, p in net.optimizer.named:
                p.copy_(ema[path_].to(p.dtype))
        print("evaluating EMA parameters", flush=True)
    batch = cfg["batch_size"]
    if args.tta and task == "classification":
        evaluator.reset()
        for x, y in val_set.eval_iter(batch, device):
            evaluator.update(net.predict(x, batch_size=len(x),
                                         tta=args.tta), y)
        score = evaluator.score()
    elif args.scales and task == "segmentation":
        scales = tuple(float(s) for s in args.scales.split(","))
        evaluator.reset()
        for x, y in val_set.eval_iter(batch, device):
            evaluator.update(net.predict_segmentation(
                x, scales=scales, flip=True, batch_size=len(x)), y)
        score = evaluator.score()
    else:
        score = net.evaluate(val_set, evaluator, batch_size=batch)
    print(f"{evaluator.name}: {score:.4f}", flush=True)
    if args.calibrate and task == "classification":
        calibrate(net, val_set, batch, args.ckpt)
    if args.report and hasattr(evaluator, "report"):
        print(evaluator.report(getattr(val_set.source, "class_names",
                                       None)), flush=True)
    return score, net


def calibrate(net, val_set, batch: int, ckpt: str) -> dict:
    """Fit a temperature on the validation logits, print the ECE before
    and after and write ``calibration.json`` beside the checkpoint."""
    import json

    import numpy as np

    from myconvnet_tpu_torch.eval.calibration import (
        expected_calibration_error, fit_temperature)
    logits, labels = [], []
    for x, y in val_set.eval_iter(batch, net.device):
        logits.append(net.predict(x, batch_size=len(x)))
        labels.append(y.cpu().numpy())
    logits, labels = np.concatenate(logits), np.concatenate(labels)
    temp = fit_temperature(logits, labels)
    ece_raw = expected_calibration_error(logits, labels)
    ece_cal = expected_calibration_error(logits, labels, temperature=temp)
    print(f"temperature: {temp:.3f}  ece: {ece_raw:.4f} -> {ece_cal:.4f}",
          flush=True)
    out_dir = (ckpt if os.path.isdir(ckpt)
               else os.path.dirname(ckpt) or ".")
    record = {"temperature": temp, "ece_raw": ece_raw,
              "ece_calibrated": ece_cal}
    path = os.path.join(out_dir, "calibration.json")
    with open(path, "w") as f:
        json.dump(record, f)
    print(f"wrote {path}", flush=True)
    return record


def eval_gan(cfg: dict, args, device):
    """pix2pix: restore ``--ckpt`` and print the val pairs' mean PSNR and
    SSIM of G's translations against the targets, both in [0, 1]."""
    from myconvnet_tpu_torch import recipes_gan
    from myconvnet_tpu_torch.data.pipeline import DataSet
    from myconvnet_tpu_torch.eval.image_metrics import PairedImageEvaluator

    if recipes_gan.gan_kind(cfg) != "pix2pix":
        raise SystemExit("unconditional GAN checkpoints: use python -m "
                         "myconvnet_tpu_torch.generate (sample grids); "
                         "paired translation (pix2pix) is scored here with "
                         "PSNR/SSIM")
    trainer, _ = recipes_gan.build_gan(cfg, args.synthetic, device=device)
    trainer.restore(args.ckpt)
    sampler = recipes_gan.make_gan_sampler(cfg)
    val = DataSet(recipes_gan.gan_source(cfg, args.synthetic, "val"))
    ev_psnr, ev_ssim = PairedImageEvaluator("psnr"), \
        PairedImageEvaluator("ssim")
    for a, b in val.eval_iter(cfg["batch_size"], device):
        pred = sampler(trainer, trainer.to_unit_range(a)).float() / 255.0
        target = b.float() / 255.0
        ev_psnr.update(pred, target)
        ev_ssim.update(pred, target)
    psnr, ssim = ev_psnr.score(), ev_ssim.score()
    print(f"psnr: {psnr:.2f} dB", flush=True)
    print(f"ssim: {ssim:.4f}", flush=True)
    return (psnr, ssim), trainer


if __name__ == "__main__":
    main()
