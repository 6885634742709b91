"""Evaluation entry point of the port (classification and optical-flow
recipes).

    python -m myconvnet_tpu_torch.test --config configs/cifar100_resnet18.py \\
        --synthetic --ckpt DIR [--batch N] [--set KEY=VALUE ...] \\
        [--device cuda]

Port of ``test.py:148-240`` (``eval_convnet``) without test-time
augmentation, EMA or checkpoint averaging: build the recipe's model,
restore ``--ckpt`` (a ``ckpt-<step>.npz`` or the directory holding them,
written by either package's trainer), score the validation split and print
the metric.  ``main(argv)`` returns (score, trainer).
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
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.train.cli import resolve_device

    device = resolve_device(args.device)
    cfg = recipes.apply_overrides(recipes.load_config(args.config),
                                  args.overrides)
    if args.batch is not None:
        cfg["batch_size"] = args.batch
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


if __name__ == "__main__":
    main()
