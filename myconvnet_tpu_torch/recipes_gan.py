"""The GAN recipes (``configs/dcgan_cifar10.py``, ``configs/pix2pix.py``)
wired without the JAX package.

Port of the ``dcgan`` and ``pix2pix`` branches of
``myconvnet_tpu/recipes/gan_style.py``: ``gan_generator`` (``:21``, the one
generator module that training, sampling and evaluation share),
``build_gan`` (``:57``: G and D initialised from ``cfg["seed"]``, one
optimizer each through ``recipes.make_optimizer``, the precision policy,
the train split) and ``make_gan_sampler`` (``:269``).  pix2pix runs bf16
under its policy; its losses and L1 target stay float32.

Refused by name: ``gan_kind`` cyclegan and srgan (``resnet_generator``,
``make_cyclegan_step``, the SR discriminator) and ``spectral_norm`` in the
discriminator's kwargs.  DCGAN reads a CIFAR-10 ``data_dir`` with the
port's pickle reader, pix2pix a combined or two-directory pairs
``data_dir`` with ``subsets.pairs.PairFileSource`` (``gan_style.py:119-
125``), as JAX does.  ``synthetic_n`` sizes a rendered split (the port's
own key; the JAX recipes keep each module's default, 512 CIFAR-10 images
and 64 pairs).
"""

from __future__ import annotations

import torch
from torch import nn

from myconvnet_tpu_torch import models
from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.pipeline import DataSet
from myconvnet_tpu_torch.recipes import make_optimizer
from myconvnet_tpu_torch.subsets import cifar10, pairs
from myconvnet_tpu_torch.train.gan import KINDS, GANTrainer
from myconvnet_tpu_torch.utils.images import to_uint8

UNPORTED_KINDS = {"cyclegan": "resnet_generator, make_cyclegan_step",
                  "srgan": "srresnet, sr_discriminator"}


def gan_kind(cfg: dict) -> str:
    kind = cfg.get("gan_kind", "dcgan")
    if kind in UNPORTED_KINDS:
        raise ValueError(f"gan_kind {kind!r} is not ported (the JAX recipe "
                         f"builds it from {UNPORTED_KINDS[kind]}, "
                         "recipes/gan_style.py:159-262)")
    if kind not in KINDS:
        raise ValueError(f"unknown gan kind {kind!r}")
    return kind


def gan_generator(cfg: dict) -> nn.Module:
    """The recipe's generator module (uninitialised)."""
    size = cfg.get("image_size", 32)
    gkw = dict(cfg.get("generator_kwargs", {}))
    if gan_kind(cfg) == "dcgan":
        return models.DCGANGenerator(cfg.get("latent_dim", 100),
                                     image_size=size, **gkw)
    return models.UNetGenerator(image_size=size, **gkw)


def gan_discriminator(cfg: dict) -> nn.Module:
    dkw = dict(cfg.get("discriminator_kwargs", {}))
    if gan_kind(cfg) == "dcgan":
        return models.DCGANDiscriminator(
            image_size=cfg.get("image_size", 32), **dkw)
    return models.PatchGANDiscriminator(**dkw)


def gan_source(cfg: dict, synthetic: bool, split: str = "train"):
    """The recipe's split: CIFAR-10 images for DCGAN, (input, target)
    pairs at ``image_size`` for pix2pix."""
    kind, data_dir = gan_kind(cfg), cfg.get("data_dir")
    kw = ({"synthetic_n": int(cfg["synthetic_n"])}
          if cfg.get("synthetic_n") is not None else {})
    if kind == "dcgan":
        if cfg.get("dataset", "cifar10") != "cifar10":
            raise ValueError(f"dcgan dataset {cfg['dataset']!r}")
        return cifar10.make_source(data_dir, "train" if split == "train"
                                   else "test",
                                   synthetic=synthetic or data_dir is None,
                                   **kw)
    size = cfg.get("image_size", 256)
    return pairs.make_source(data_dir, split,
                             synthetic=synthetic or data_dir is None,
                             raw_hw=(size, size), **kw)


def build_gan(cfg: dict, synthetic: bool = False, *,
              device: torch.device) -> tuple[GANTrainer, DataSet]:
    """(trainer, train set): G and D initialised from ``cfg["seed"]`` (N(0,
    0.02) weights), an optimizer each, the recipe's objective."""
    kind = gan_kind(cfg)
    seed = cfg.get("seed", 0)
    gen = torch.Generator().manual_seed(seed)
    g = init_model(gan_generator(cfg), gen)
    d = init_model(gan_discriminator(cfg), gen)
    policy = get_policy(cfg.get("precision", "f32"))
    apply_backend_flags(policy)
    g.to(device)
    d.to(device)
    trainer = GANTrainer(
        kind, g, d, make_optimizer(g, cfg["g_optimizer"]),
        make_optimizer(d, cfg["d_optimizer"]), device=device, policy=policy,
        seed=seed, latent_dim=cfg.get("latent_dim", 100),
        gan_loss=cfg.get("gan_loss", "nonsaturating"),
        l1_weight=cfg.get("l1_weight", 100.0))
    src = gan_source(cfg, synthetic)
    # the batch order: DataSet's default seed for DCGAN, the recipe's for
    # pix2pix (gan_style.py:88, :126)
    return trainer, DataSet(src, seed=seed if kind == "pix2pix" else 0)


def make_gan_sampler(cfg: dict):
    """dcgan: ``sample(trainer, n=64, seed=0)`` -> uint8 [n, H, W, 3] on
    the device from latents drawn from ``seed``; pix2pix: ``sample(trainer,
    x)`` translating images in [-1, 1].  G's eval forward."""
    if gan_kind(cfg) == "dcgan":
        latent = cfg.get("latent_dim", 100)

        def sample(trainer, n: int = 64, seed: int = 0):
            gen = torch.Generator(device=trainer.device).manual_seed(seed)
            z = torch.randn(n, latent, generator=gen, device=trainer.device)
            return to_uint8(trainer.generate(z))
    else:
        def sample(trainer, x):
            return to_uint8(trainer.generate(x))
    return sample
