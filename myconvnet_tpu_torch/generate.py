"""GAN sample grids and translations from a checkpoint.

    python -m myconvnet_tpu_torch.generate --config configs/dcgan_cifar10.py \
        --ckpt DIR [--n 64] [--seed 0] [--out samples.png] [--ema] \
        [--input DIR] [--device cuda]

Port of the GAN branch of ``generate.py`` (``:103-150``): restore G from
``--ckpt`` (either package's checkpoint), with ``--ema`` put the
generator optimizer's EMA (``g_optimizer.ema_decay`` in the config) in
place of its parameters, and write one PNG.  DCGAN: ``--n`` samples from
latents drawn from ``--seed`` (a ``torch.Generator``, so not JAX's draws
for the same seed).  pix2pix: the first ``--n`` inputs beside their
translations (input | output): the images of the ``--input`` directory
(sorted, each resized by Pillow's BILINEAR to the recipe's size), else
the synthetic val inputs.  ``main(argv)`` returns the uint8 grid.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

_EXTS = (".jpg", ".jpeg", ".png")


def load_inputs(directory: str, n: int, size: int) -> np.ndarray:
    """The first ``n`` images of ``directory`` by sorted path, each
    converted to RGB and resized to ``size`` x ``size`` (Pillow BILINEAR):
    uint8 [n', size, size, 3] (``generate.py:121-134``)."""
    from myconvnet_tpu_torch.data.pipeline import pil_image

    paths = sorted(os.path.join(directory, f) for f in os.listdir(directory)
                   if f.lower().endswith(_EXTS))[:n]
    if not paths:
        raise SystemExit(f"no images under {directory!r}")
    image = pil_image("generate --input", directory)
    return np.stack([np.asarray(image.open(p).convert("RGB").resize(
        (size, size), image.BILINEAR), np.uint8) for p in paths])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--out", default="samples.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--input", default=None,
                    help="directory of images to translate (pix2pix)")
    ap.add_argument("--ema", action="store_true",
                    help="sample with the generator's EMA "
                         "(g_optimizer.ema_decay in the config)")
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE", dest="overrides")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from myconvnet_tpu_torch import recipes, recipes_gan
    from myconvnet_tpu_torch.train import optim
    from myconvnet_tpu_torch.train.cli import resolve_device
    from myconvnet_tpu_torch.utils.images import make_grid, save_png

    device = resolve_device(args.device)
    cfg = recipes.apply_overrides(recipes.load_config(args.config),
                                  args.overrides)
    if cfg.get("task") != "gan":
        raise SystemExit("the port's generate is for gan configs")
    trainer, _ = recipes_gan.build_gan(cfg, True, device=device)
    trainer.restore(args.ckpt)
    if args.ema:
        # the EMA is float32; each parameter takes it in its own dtype
        ema = optim.extract_ema(trainer.g_opt)
        with torch.no_grad():
            for path, p in trainer.g_opt.named:
                p.copy_(ema[path].to(p.dtype))
        print("sampling with EMA generator", flush=True)
    sampler = recipes_gan.make_gan_sampler(cfg)
    if trainer.kind == "dcgan":
        grid = make_grid(sampler(trainer, args.n, seed=args.seed)
                         .cpu().numpy(), pad=0)
        save_png(args.out, grid)
        print(f"wrote {args.n} samples to {args.out}", flush=True)
        return grid
    if args.input:
        raw = load_inputs(args.input, args.n, cfg.get("image_size", 32))
    else:
        src = recipes_gan.gan_source(cfg, True, "val")
        raw = src.get_batch(np.arange(min(args.n, len(src))))[0]
    x = trainer.to_unit_range(torch.from_numpy(raw).to(device))
    out = sampler(trainer, x).cpu().numpy()
    grid = make_grid(np.concatenate([raw, out], axis=2))  # input | output
    save_png(args.out, grid)
    print(f"wrote {len(raw)} translations to {args.out}", flush=True)
    return grid


if __name__ == "__main__":
    main()
