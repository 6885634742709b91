"""Evaluation entry point of the port (classification, segmentation,
optical-flow and pix2pix recipes).

    python -m myconvnet_tpu_torch.test --config configs/cifar100_resnet18.py \\
        --synthetic --ckpt DIR [--batch N] [--set KEY=VALUE ...] \\
        [--device cuda]

Port of ``test.py:148-240`` (``eval_convnet``) without test-time
augmentation, EMA or checkpoint averaging: build the recipe's model,
restore ``--ckpt`` (a ``ckpt-<step>.npz`` or the directory holding them,
written by either package's trainer), score the validation split and print
the metric.  A GAN recipe goes to :func:`eval_gan` (``test.py:120``):
pix2pix is scored on the val pairs with PSNR and SSIM (``eval_pix2pix``,
``test.py:646``), each batch rescaled by B2 and translated by G's eval
forward; an unconditional DCGAN checkpoint is not scored here.  ``--fid``
(``eval/gan_metrics.py``, ROADMAP A8) and ``--export`` (ROADMAP A15) are
refused by name.  ``main(argv)`` returns (score, trainer); for pix2pix
the score is (psnr, ssim).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint .npz or its directory")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE", dest="overrides")
    ap.add_argument("--scales", default=None,
                    help="segmentation: comma-separated input scales of the "
                         "multi-scale + flip eval")
    ap.add_argument("--fid", action="store_true",
                    help="not ported (FID needs eval/gan_metrics.py)")
    ap.add_argument("--export", default=None,
                    help="not ported (the exporters are ROADMAP A15)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fid:
        raise SystemExit("test --fid is not ported (eval/gan_metrics.py, "
                         "ROADMAP A8)")
    if args.export:
        raise SystemExit("test --export is not ported (export_cli.py, "
                         "ROADMAP A15)")

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.train.cli import resolve_device

    device = resolve_device(args.device)
    cfg = recipes.apply_overrides(recipes.load_config(args.config),
                                  args.overrides)
    if args.batch is not None:
        cfg["batch_size"] = args.batch
    if cfg.get("task") == "gan":
        return eval_gan(cfg, args, device)
    trainer, _, val_set = recipes.build_trainer(
        cfg, synthetic=args.synthetic, device=device)
    trainer.restore(args.ckpt)
    batches = val_set.eval_iter(cfg["batch_size"], device)
    if args.scales and cfg["task"] == "segmentation":
        from myconvnet_tpu_torch.eval.seg_inference import \
            predict_segmentation
        scales = tuple(float(s) for s in args.scales.split(","))
        mean, std = recipes.normalization(cfg)
        evaluator = trainer.evaluator
        evaluator.reset()
        for x, y in batches:
            evaluator.update(predict_segmentation(
                trainer.forward_eval, x, mean, std, scales=scales,
                flip=True), y)
        score = evaluator.score()
    else:
        score = trainer.evaluate(batches)
    print(f"{trainer.evaluator.name}: {score:.4f}", flush=True)
    return score, trainer


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
