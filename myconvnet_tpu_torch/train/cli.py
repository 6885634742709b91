"""Training entry point of the port (classification and optical-flow
recipes).

    python -m myconvnet_tpu_torch.train --config configs/cifar100_resnet18.py \\
        --synthetic --steps N --out DIR [--batch N] [--val_every N] \\
        [--set KEY=VALUE ...] [--device cuda]

Port of ``train.py:22-213`` (``main`` and ``run_supervised``) for the
classification and flow tasks: config -> data sets -> model -> trainer,
the step loop with periodic validation and checkpoints under ``--out``,
then a final validation.  ``--device`` defaults to ``cuda``; without CUDA that is an
error (pass ``--device cpu`` to train on the host).  ``main(argv)``
returns the trainer, so a script can drive a run in-process.
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


if __name__ == "__main__":
    main()
