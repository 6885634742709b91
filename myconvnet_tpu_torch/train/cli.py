"""Training entry point of the port (classification, segmentation,
optical-flow and GAN recipes).

    python -m myconvnet_tpu_torch.train --config configs/cifar100_resnet18.py \\
        --synthetic --steps N --out DIR [--batch N] [--val_every N] \\
        [--set KEY=VALUE ...] [--device cuda]

Port of ``train.py:22-213`` (``main`` and ``run_supervised``) for the
classification and flow tasks: config -> data sets -> model -> trainer,
the step loop with periodic validation and checkpoints under ``--out``,
then a final validation.  A GAN recipe (``task="gan"``) goes to
:func:`run_gan`, the port of ``run_steploop`` with ``adapt_gan``
(``train.py:216``, ``:450``).  ``--device`` defaults to ``cuda``; without
CUDA that is an error (pass ``--device cpu`` to train on the host).
``main(argv)`` returns the trainer, so a script can drive a run
in-process.
"""

from __future__ import annotations

import argparse
import json
import os

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
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--out", default=None, help="run dir (ckpts + logs)")
    ap.add_argument("--val_every", type=int, default=None)
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE", dest="overrides",
                    help="override a config entry (repeatable; dotted "
                         "keys reach nested dicts)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from myconvnet_tpu_torch import recipes

    device = resolve_device(args.device)
    cfg = recipes.load_config(args.config)
    for key, value in (("total_steps", args.steps),
                       ("batch_size", args.batch),
                       ("val_every", args.val_every)):
        if value is not None:
            cfg[key] = value
    cfg = recipes.apply_overrides(cfg, args.overrides)
    out = args.out or os.path.join(
        "runs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(out, exist_ok=True)
    # reproducibility: the resolved config (file + command-line overrides)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1, default=str)

    if cfg.get("task") == "gan":
        return run_gan(cfg, args.synthetic, out, device)
    trainer, train_set, val_set = recipes.build_trainer(
        cfg, synthetic=args.synthetic, device=device, ckpt_dir=out,
        log_dir=out)
    batch = cfg["batch_size"]
    trainer.fit(train_set.train_iter(batch, device),
                total_steps=cfg["total_steps"],
                val_iter_fn=lambda: val_set.eval_iter(batch, device),
                val_every=cfg.get("val_every", 0),
                early_stop_patience=cfg.get("early_stop_patience", 0))
    score = trainer.evaluate(val_set.eval_iter(batch, device))
    print(f"final val {trainer.evaluator.name}: {score:.4f}", flush=True)
    trainer.logger.close()
    return trainer


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


if __name__ == "__main__":
    main()
