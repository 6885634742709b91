"""Evaluation entry point of the port (classification, segmentation,
optical-flow, pix2pix and self-supervised recipes).

    python -m myconvnet_tpu_torch.test --config configs/cifar100_resnet18.py \\
        --synthetic --ckpt DIR [--batch N] [--best | --average N] [--ema] \\
        [--tta flip|ten_crop] [--topk K] [--report] [--calibrate] \\
        [--scales S,S,...] [--set KEY=VALUE ...] [--device cuda]
    python -m myconvnet_tpu_torch.test --config configs/sngan_cifar10.py \\
        --synthetic --ckpt DIR --fid \\
        --fid_extractor configs/cifar100_resnet18.py:CLS_DIR [--fid_samples 256]
    python -m myconvnet_tpu_torch.test --config configs/imagenet_resnet50.py \
        --ckpt DIR --export model.pt2 [--ema] [--device cuda]

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
checkpoint (``test.py:242-267``).  ``--export PATH`` writes the restored
model (after ``--best``, ``--average`` or ``--ema``) as a ``torch.export``
artifact for ``serve --artifact`` instead of scoring it
(``test.py:108-123``, ``:197-203``; ``export_cli``): classification,
segmentation and flow recipes, DCGAN and pix2pix checkpoints; ``--int8``
and the exporters of unported tasks are refused by name
(``export_cli.refuse_unported``).  ``--tta x8`` (the super-resolution
self-ensemble, ROADMAP A17) is refused by name.  A GAN recipe goes to :func:`eval_gan` (``test.py:120``): with
``--fid``, :func:`eval_gan_fid` (``test.py:565-642``) scores
``--fid_samples`` generated images against as many of the recipe's real
ones through ``--fid_extractor CONFIG:CKPT_DIR`` (:func:`_fid_extractor`,
``test.py:455-498``: any trained classifier's ``features``); else pix2pix
is scored on the val pairs with PSNR and SSIM (``eval_pix2pix``,
``test.py:646``), each batch rescaled by B2 and translated by G's eval
forward, and an unconditional DCGAN checkpoint is not scored.  The
``inception:WEIGHTS.npz`` extractor (weights the repo does not hold; the
JAX ``inception_v3`` tags no ``features`` map) and ``task="diffusion"``
stay refused by name.  A self-supervised recipe (``task="ssl"``) goes to
:func:`eval_ssl` (``test.py:350-377``): the kNN probe, then the encoder
re-exported beside the checkpoint (``--export`` adds nothing there, as in
JAX).  ``main(argv)`` returns (score, net); for pix2pix (psnr, ssim)
and the GAN trainer, for ``--fid`` (fid, trainer), for an SSL recipe
(kNN top-1, trainer), for ``--export`` the artifact's path.
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
                    help="GAN configs: FID between generated samples and "
                         "the real split through --fid_extractor")
    ap.add_argument("--fid_extractor", default=None, metavar="SPEC",
                    help="feature extractor for --fid: 'CONFIG:CKPT_DIR' "
                         "of any trained classifier (its 'features' are "
                         "the embedding)")
    ap.add_argument("--fid_samples", type=int, default=256,
                    help="sample count per side for --fid")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="write the restored model as a torch.export "
                         "artifact (serve --artifact) instead of scoring")
    ap.add_argument("--int8", action="store_true",
                    help="not ported (quantization is ROADMAP A17)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
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
    if args.export or args.int8:
        from myconvnet_tpu_torch import export_cli
        export_cli.refuse_unported(cfg, args)
    if cfg.get("task") == "diffusion" and args.fid:
        raise SystemExit("test --fid of a diffusion recipe is not ported "
                         "(the diffusion family, ROADMAP A17)")
    task = recipes.check_task(cfg)
    if task == "gan":
        return eval_gan(cfg, args, device)
    if task == "ssl":
        return eval_ssl(cfg, args, device)
    if args.fid:
        raise SystemExit("test --fid scores GAN checkpoints (dcgan, "
                         f"pix2pix), not a {cfg['task']} recipe")
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
    if args.export:
        from myconvnet_tpu_torch import export_cli
        export_cli.CONVNET_EXPORTERS[task](cfg, args, net, val_set)
        return args.export
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


def _fid_extractor(spec: str, device):
    """``feature_fn(images) -> [N, D]`` float32 tensor on ``device``, from
    ``CONFIG:CKPT_DIR``: the classifier
    recipe built with its own optimizer (the checkpoint's optimizer state
    must fit) and restored; images (uint8 [N, H, W, C]) go to ``x / 255``,
    a bilinear resize to the recipe's ``input_hw``, ``ConvNet.features``
    and a global average pool of a spatial map."""
    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.ops.resize import resize_bilinear

    kind, _, rest = spec.partition(":")
    if kind == "inception":
        raise SystemExit("--fid_extractor inception:WEIGHTS.npz is not "
                         "ported: it needs Inception-v3 weights the repo "
                         "does not hold, and the JAX inception_v3 tags no "
                         "'features' map to extract; pass CONFIG:CKPT_DIR "
                         "of a trained classifier")
    if not rest:
        raise SystemExit(f"--fid_extractor {spec!r}: want CONFIG:CKPT_DIR")
    ecfg = recipes.load_config(kind)
    net, _, _ = recipes.build_classifier(ecfg, True, device=device,
                                         ckpt_dir=rest)
    net.build(recipes.optimizer_factory(ecfg["optimizer"]))
    net.restore(rest)
    hw = tuple(ecfg["input_hw"])

    def feature_fn(images_u8) -> torch.Tensor:
        x = torch.as_tensor(images_u8).to(device).float() / 255.0
        if tuple(x.shape[1:3]) != hw:
            x = resize_bilinear(x, hw)
        feats = torch.from_numpy(net.features(x, tag="features"))
        if feats.ndim == 4:
            feats = feats.mean((1, 2))
        return feats.to(device)

    return feature_fn


def _first(batches, n: int) -> torch.Tensor:
    """The first ``n`` rows of a stream of batches, concatenated."""
    out, have = [], 0
    for x in batches:
        out.append(x)
        have += len(x)
        if have >= n:
            break
    return torch.cat(out)[:n]


def fid_image_sets(cfg: dict, trainer, n: int, synthetic: bool, device
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """(reals, fakes), uint8 [n, H, W, C] on ``device``, as
    ``test.py:593-639`` makes them: dcgan fakes from the sampler with
    seed i for the chunk starting at i and the reals from the recipe's
    val split; pix2pix fakes translated from the val pairs' inputs, the
    reals their targets."""
    from myconvnet_tpu_torch import recipes, recipes_gan
    from myconvnet_tpu_torch.data.pipeline import DataSet

    sampler = recipes_gan.make_gan_sampler(cfg)
    batch = cfg["batch_size"]
    if trainer.kind == "dcgan":
        chunk = min(batch, n)
        fakes = torch.cat([sampler(trainer, min(chunk, n - i), seed=i)
                           for i in range(0, n, chunk)])[:n]
        _, val_src = recipes.make_sources(
            dict(cfg, dataset=cfg.get("dataset", "cifar10")), synthetic)
        reals = _first((x for x, _ in DataSet(val_src).eval_iter(
            batch, device)), n)
        return reals, fakes
    val = DataSet(recipes_gan.gan_source(cfg, synthetic, "val"))
    fakes = _first((sampler(trainer, trainer.to_unit_range(a))
                    for a, _ in val.eval_iter(batch, device)), n)
    reals = _first((b for _, b in val.eval_iter(batch, device)), n)
    return reals, fakes


def eval_gan_fid(cfg: dict, args, device):
    """FID between ``--fid_samples`` generated images and as many real
    ones (``test.py:565-642``; :func:`fid_image_sets`).  Returns (fid,
    trainer)."""
    from myconvnet_tpu_torch import recipes_gan
    from myconvnet_tpu_torch.eval.gan_metrics import fid_from_features

    if not args.fid_extractor:
        raise SystemExit("--fid needs --fid_extractor CONFIG:CKPT_DIR (any "
                         "trained classifier)")
    feature_fn = _fid_extractor(args.fid_extractor, device)
    trainer, _ = recipes_gan.build_gan(cfg, args.synthetic, device=device)
    trainer.restore(args.ckpt)
    n = args.fid_samples
    reals, fakes = fid_image_sets(cfg, trainer, n, args.synthetic, device)
    fid = fid_from_features(feature_fn(reals), feature_fn(fakes))
    print(f"fid: {fid:.3f} (n={n}, extractor={args.fid_extractor})",
          flush=True)
    return fid, trainer


def eval_ssl(cfg: dict, args, device):
    """Score a self-supervised checkpoint with the kNN probe (frozen
    features, the labelled bank from the train split) and re-export
    ``encoder.npz`` beside the checkpoint (``test.py:350-377``).  Returns
    (kNN top-1, trainer)."""
    from myconvnet_tpu_torch import recipes_ssl
    from myconvnet_tpu_torch.train.cli import knn_kwargs

    trainer, train_set, val_set = recipes_ssl.build_ssl(
        cfg, args.synthetic, device=device)
    trainer.restore(args.ckpt)
    batch = cfg["batch_size"]
    knn = trainer.knn(train_set.eval_iter(batch, device),
                      val_set.eval_iter(batch, device), **knn_kwargs(cfg))
    print(f"{trainer.kind} kNN top-1: {knn:.4f}", flush=True)
    out_dir = (args.ckpt if os.path.isdir(args.ckpt)
               else os.path.dirname(args.ckpt))
    enc = trainer.export_encoder(os.path.join(out_dir, "encoder.npz"))
    print(f"encoder exported: {enc}", flush=True)
    return knn, trainer


def eval_gan(cfg: dict, args, device):
    """``--export``: ``export_cli.export_gan``.  ``--fid``:
    :func:`eval_gan_fid`.  pix2pix: restore ``--ckpt`` and
    print the val pairs' mean PSNR and SSIM of G's translations against
    the targets, both in [0, 1]."""
    from myconvnet_tpu_torch import recipes_gan
    from myconvnet_tpu_torch.data.pipeline import DataSet
    from myconvnet_tpu_torch.eval.image_metrics import PairedImageEvaluator

    if args.export:
        from myconvnet_tpu_torch import export_cli
        export_cli.export_gan(cfg, args, device)
        return args.export
    if args.fid:
        return eval_gan_fid(cfg, args, device)
    if recipes_gan.gan_kind(cfg) != "pix2pix":
        raise SystemExit("unconditional GAN checkpoints: use python -m "
                         "myconvnet_tpu_torch.generate (sample grids) or "
                         "test --fid --fid_extractor CONFIG:CKPT; paired "
                         "translation (pix2pix) is scored here with "
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
