"""GAN sample grids and translations from a checkpoint.

    python -m myconvnet_tpu_torch.generate --config configs/dcgan_cifar10.py \
        --ckpt DIR [--n 64] [--seed 0] [--out samples.png] [--device cuda]

Port of the GAN branch of ``generate.py`` (``:103-150``): restore G from
``--ckpt`` (either package's checkpoint) and write one PNG.  DCGAN:
``--n`` samples from latents drawn from ``--seed`` (a ``torch.Generator``,
so not JAX's draws for the same seed).  pix2pix: the first ``--n``
synthetic val inputs beside their translations (input | output).
``--input`` (a directory of images, decoded with Pillow) and ``--ema``
(the EMA wrapper is ROADMAP A8) are refused by name.  ``main(argv)``
returns the uint8 grid.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True)
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--out", default="samples.png")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--input", default=None,
                    help="not ported (decodes images with Pillow)")
    ap.add_argument("--ema", action="store_true",
                    help="not ported (ROADMAP A8)")
    ap.add_argument("--set", action="append", default=None,
                    metavar="KEY=VALUE", dest="overrides")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.input:
        raise SystemExit("generate --input is not ported (it decodes "
                         "images with Pillow); omit it for synthetic inputs")
    if args.ema:
        raise SystemExit("generate --ema is not ported (the optimizer's "
                         "EMA wrapper is ROADMAP A8)")

    import numpy as np

    from myconvnet_tpu_torch import recipes, recipes_gan
    from myconvnet_tpu_torch.train.cli import resolve_device
    from myconvnet_tpu_torch.utils.images import make_grid, save_png

    device = resolve_device(args.device)
    cfg = recipes.apply_overrides(recipes.load_config(args.config),
                                  args.overrides)
    if cfg.get("task") != "gan":
        raise SystemExit("the port's generate is for gan configs")
    trainer, _ = recipes_gan.build_gan(cfg, True, device=device)
    trainer.restore(args.ckpt)
    sampler = recipes_gan.make_gan_sampler(cfg)
    if trainer.kind == "dcgan":
        grid = make_grid(sampler(trainer, args.n, seed=args.seed)
                         .cpu().numpy(), pad=0)
        save_png(args.out, grid)
        print(f"wrote {args.n} samples to {args.out}", flush=True)
        return grid
    src = recipes_gan.gan_source(cfg, True, "val")
    raw = src.get_batch(np.arange(min(args.n, len(src))))[0]
    import torch
    x = trainer.to_unit_range(torch.from_numpy(raw).to(device))
    out = sampler(trainer, x).cpu().numpy()
    grid = make_grid(np.concatenate([raw, out], axis=2))  # input | output
    save_png(args.out, grid)
    print(f"wrote {len(raw)} translations to {args.out}", flush=True)
    return grid


if __name__ == "__main__":
    main()
