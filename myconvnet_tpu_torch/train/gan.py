"""GAN training: the fused dual-optimizer step of DCGAN and pix2pix, its
checkpoints, and the step loop (BASELINE config #5).

Port of ``myconvnet_tpu/train/gan.py`` (``GANState:29``,
``init_gan_state:40``, ``make_dcgan_step:52``, ``make_pix2pix_step:121``)
and of the GAN part of ``train.py`` (``run_steploop:216`` with
``adapt_gan:450``).  The update order is JAX's:

1. D is updated first, against the current G: D runs in train mode on the
   real batch, then on the fake batch (G's output, no gradient into G),
   and its BN moving statistics take both updates, real then fake; so do a
   spectral-normalized D's ``sn_u`` vectors (two power iterations a step,
   the fake pass starting from the real pass's vector).
2. G is then updated against the updated D: D runs in train mode on batch
   statistics, but the moving statistics and ``sn_u`` it would write are
   dropped (``frozen_stats``), and G's loss reaches G's parameters only
   (``backward(inputs=...)``; D's optimizer sees no gradient of it).
3. G's moving statistics are those of the G-loss pass.  DCGAN's two G
   passes share parameters, z and key, so one train forward serves both
   (its output detached for D).  pix2pix draws other dropout keys for the
   two passes (``kg``, ``kg2``, ``:135``), so it runs G twice, the first
   time without gradient and with its statistics frozen.

Randomness: JAX draws z and the U-Net's dropout masks from ``fold_in(rng,
step)``; here :meth:`GANTrainer.sample` draws them from a
``torch.Generator`` reseeded from (seed, step), and ``train_step`` takes
them as :class:`GANDraws`, so a test can hand over JAX's.

The uint8 batches are rescaled to [-1, 1] in float32 on the device by the
``normalize_u8`` kernel (B2) at mean = std = 0.5: (x / 255 - 0.5) / 0.5
folds to x * fl(1 / 127.5) - 1 where JAX computes x / 127.5 - 1.0
(``recipes/gan_style.py:92-94``, ``:129-130``); the two agree within a
float32 ulp at magnitude 1 (``tests/test_torch_gan.py``).  Float32, so
pix2pix's L1 target is not rounded to bf16.

A checkpoint is the ``GANState`` of JAX as numpy trees (``g_params``,
``g_state``, ``d_params``, ``d_state``, ``g_opt`` and ``d_opt`` as
{".mu", ".nu"} Adam trees, ``step``, ``rng`` as JAX's uint32 [2] key
data), so either package restores the other's.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch import weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.core.precision import Policy
from myconvnet_tpu_torch.ops.kernels.normalize_u8 import normalize_u8
from myconvnet_tpu_torch.train.losses import get_gan_losses, l1_loss
from myconvnet_tpu_torch.train.optim import Adam, SGD
from myconvnet_tpu_torch.train.trainer import frozen_stats, rng_data, \
    seed_of
from myconvnet_tpu_torch.utils.logging import MetricLogger

KINDS = ("dcgan", "pix2pix")
KEEP = 2    # checkpoints kept, as the JAX step loop keeps them


class GANState(NamedTuple):
    """The training state as numpy trees in the JAX layout."""
    g_params: dict
    g_state: dict
    d_params: dict
    d_state: dict
    g_opt: dict
    d_opt: dict
    step: np.ndarray    # int32 scalar
    rng: np.ndarray     # uint32 [2], JAX's key data of key(seed)


class GANDraws(NamedTuple):
    """One step's random numbers: DCGAN's latents [N, latent_dim], or the
    U-Net's dropout keep masks by site for the D-update pass and for the
    G-loss pass."""
    z: torch.Tensor | None = None
    d_masks: dict | None = None
    g_masks: dict | None = None


class GANTrainer:
    """Holds G, D and their optimizers; ``train_step`` is one fused step of
    ``kind`` ("dcgan" or "pix2pix")."""

    def __init__(self, kind: str, generator: nn.Module,
                 discriminator: nn.Module, g_opt: SGD | Adam,
                 d_opt: SGD | Adam, *, device: torch.device, policy: Policy,
                 seed: int = 0, latent_dim: int = 100,
                 gan_loss: str = "nonsaturating", l1_weight: float = 100.0):
        if kind not in KINDS:
            raise ValueError(f"the port has GAN kinds {list(KINDS)}, not "
                             f"{kind!r}")
        self.kind = kind
        self.device = torch.device(device)
        self.generator = generator.to(self.device)
        self.discriminator = discriminator.to(self.device)
        self.g_opt, self.d_opt = g_opt, d_opt
        self.policy = policy
        self.seed = seed
        self.latent_dim = latent_dim
        self.d_loss_of, self.g_loss_of = get_gan_losses(gan_loss)
        # D's decision boundary for the accuracies: 0.5 for LSGAN's
        # regression to {0, 1}, 0 for logits
        self.threshold = 0.5 if gan_loss == "lsgan" else 0.0
        self.l1_weight = float(l1_weight)
        self.step = 0
        self._gen = torch.Generator(device=self.device)
        self._half = {}

    # ------------------------------------------------------------- input

    def to_unit_range(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 [N, H, W, C] -> float32 in [-1, 1] (B2 on the card)."""
        c = images.shape[-1]
        if c not in self._half:
            half = torch.full((c,), 0.5, device=images.device)
            self._half[c] = (half, half)
        return normalize_u8(images, *self._half[c], torch.float32)

    def prepare(self, batch):
        """A loader batch -> the step's input: DCGAN's real images from
        (images, labels), pix2pix's (input, target) pair, in [-1, 1]."""
        if self.kind == "dcgan":
            return self.to_unit_range(batch[0])
        return tuple(self.to_unit_range(t) for t in batch)

    def sample(self, n: int) -> GANDraws:
        """This step's draws, a function of (seed, step)."""
        self._gen.manual_seed((self.seed << 32) + self.step)
        if self.kind == "dcgan":
            return GANDraws(z=torch.randn(n, self.latent_dim,
                                          generator=self._gen,
                                          device=self.device))
        g = self.generator
        return GANDraws(d_masks=g.sample_masks(n, self._gen),
                        g_masks=g.sample_masks(n, self._gen))

    # ------------------------------------------------------------- steps

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, self.policy.compute_dtype)

    def train_step(self, batch, draws: GANDraws | None = None) -> dict:
        """One fused step on :meth:`prepare`'s output; ``draws`` defaults
        to :meth:`sample`.  Returns the metrics as device tensors."""
        n = (batch if self.kind == "dcgan" else batch[0]).shape[0]
        if draws is None:
            draws = self.sample(n)
        self.generator.train()
        self.discriminator.train()
        self.g_opt.zero_grad()
        self.d_opt.zero_grad()
        if self.kind == "dcgan":
            metrics = self._dcgan_step(batch, draws)
        else:
            metrics = self._pix2pix_step(*batch, draws)
        self.step += 1
        return metrics

    def _update_d(self, real_args, fake_args):
        """D against the current G: the loss and its update; D's BN
        statistics take the real pass, then the fake pass."""
        d = self.discriminator
        real = d(*real_args).float()
        fake = d(*fake_args).float()
        loss = self.d_loss_of(real, fake)
        loss.backward(inputs=list(d.parameters()))
        self.d_opt.step(self.step)
        return loss.detach(), real.detach(), fake.detach()

    def _g_logits(self, *args) -> torch.Tensor:
        """The updated D on G's output, its statistics dropped."""
        with frozen_stats(self.discriminator):
            return self.discriminator(*args).float()

    def _dcgan_step(self, real, draws):
        fake = self.generator(self._compute(draws.z))
        d_loss, real_logits, fake_logits = self._update_d(
            (self._compute(real),), (fake.detach(),))
        g_loss = self.g_loss_of(self._g_logits(fake))
        g_loss.backward(inputs=list(self.generator.parameters()))
        self.g_opt.step(self.step)
        thr = self.threshold
        return {"d_loss": d_loss, "g_loss": g_loss.detach(),
                "d_real_acc": (real_logits > thr).float().mean(),
                "d_fake_acc": (fake_logits < thr).float().mean()}

    def _pix2pix_step(self, x, target, draws):
        g = self.generator
        xc = self._compute(x)
        with torch.no_grad(), frozen_stats(g):
            fake = g(xc, draws.d_masks)
        d_loss, _, _ = self._update_d((xc, self._compute(target)),
                                      (xc, fake))
        fake2 = g(xc, draws.g_masks)
        adv = self.g_loss_of(self._g_logits(xc, fake2))
        l1 = l1_loss(fake2, target)
        total = adv + self.l1_weight * l1
        total.backward(inputs=list(g.parameters()))
        self.g_opt.step(self.step)
        return {"d_loss": d_loss, "g_loss": total.detach(),
                "g_adv": adv.detach(), "g_l1": l1.detach()}

    @torch.no_grad()
    def generate(self, x: torch.Tensor) -> torch.Tensor:
        """G's eval forward (B1 at its BN sites) on latents or images in
        [-1, 1], in the compute dtype."""
        self.generator.eval()
        return self.generator(self._compute(x))

    # ----------------------------------------------------------- running

    def fit(self, batches: Iterable, *, total_steps: int, log_every: int,
            logger: MetricLogger, ckpt_dir: str | None = None,
            sample_every: int = 0,
            sample: Callable[[int, object], None] | None = None) -> None:
        """The step loop of ``run_steploop``: a step a batch until
        ``total_steps``; every ``log_every`` steps the metrics and a
        checkpoint (the newest KEEP kept); every ``sample_every`` steps
        ``sample(step, first)`` with the first 16 prepared examples; then
        the final checkpoint."""
        first = None
        it = iter(batches)
        try:
            while self.step < total_steps:
                try:
                    batch = self.prepare(next(it))
                except StopIteration:
                    break
                if sample is not None and first is None:
                    first = (batch[:16] if self.kind == "dcgan"
                             else tuple(t[:16] for t in batch))
                metrics = self.train_step(batch)
                if self.step % log_every == 0:
                    logger.log(self.step,
                               {k: float(v) for k, v in metrics.items()})
                    if ckpt_dir:
                        self.save(ckpt_dir)
                if sample is not None and sample_every \
                        and self.step % sample_every == 0:
                    sample(self.step, first)
        finally:
            if hasattr(it, "close"):
                it.close()
        if ckpt_dir:
            self.save(ckpt_dir)

    # ------------------------------------------------------ checkpoints

    def state(self) -> GANState:
        g_params, g_state = weights.to_jax(self.generator)
        d_params, d_state = weights.to_jax(self.discriminator)
        return GANState(
            g_params, g_state, d_params, d_state,
            weights.optimizer_to_jax(self.generator, self.g_opt),
            weights.optimizer_to_jax(self.discriminator, self.d_opt),
            np.asarray(self.step, np.int32), rng_data(self.seed))

    @torch.no_grad()
    def load_state(self, state: GANState) -> None:
        weights.from_jax(self.generator, state.g_params, state.g_state)
        weights.from_jax(self.discriminator, state.d_params, state.d_state)
        weights.optimizer_from_jax(self.generator, self.g_opt, state.g_opt)
        weights.optimizer_from_jax(self.discriminator, self.d_opt,
                                   state.d_opt)
        self.step = int(state.step)
        self.seed = seed_of(state.rng)

    def save(self, directory: str, keep: int = KEEP) -> str:
        return ckpt_lib.save_checkpoint(directory, self.step,
                                        self.state()._asdict(), keep=keep)

    def restore(self, path: str) -> None:
        """Load a checkpoint file, or the newest one in a directory."""
        restored = ckpt_lib.restore_checkpoint(path, self.state()._asdict())
        self.load_state(GANState(**restored))
