"""Semi-supervised training: FixMatch with an EMA of the whole model.

Port of ``myconvnet_tpu/train/semisup.py``:

* :class:`FixMatchTrainer`, the step of ``make_fixmatch_step``
  (``:58-118``): the labeled batch and the unlabeled batch's weak and
  strong views run as ONE [B + 2 mu B] train-mode batch (BN statistics
  over the whole mixture); pseudo-labels from the weak branch without a
  gradient, kept where their confidence reaches ``threshold``; the
  unsupervised CE summed over the kept rows and divided by mu B (the
  whole unlabeled batch); then the update and the EMA at decay
  ``min(d, (1 + t) / (10 + t))`` (t the step before it, in float32 as
  JAX computes it) of the parameters AND the BN moving statistics
  (``_ema_tree``, ``:45-52``), held in a second copy of the model;
* :meth:`FixMatchTrainer.evaluate`, ``make_eval_fn`` (``:121-147``):
  top-1 of the EMA model's eval forward on ``augment_eval`` of the
  batch;
* :func:`labeled_subset` (``:150-166``): the labeled split, the same
  numpy draws;
* the checkpoint in JAX's ``SemiState`` layout (``params``,
  ``model_state``, ``ema_params``, ``ema_model_state``, ``opt``,
  ``step``, ``rng``).

Randomness: :meth:`FixMatchTrainer.sample` draws the three views (each
a crop and flip, the strong one also its RandAugment layers) and the
model's dropout masks from a ``torch.Generator`` reseeded from (seed,
step); a test hands JAX's over instead.
"""

from __future__ import annotations

import copy
from typing import Iterable, NamedTuple

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch import weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.core.precision import Policy
from myconvnet_tpu_torch.nn import BatchNorm
from myconvnet_tpu_torch.train.losses import softmax_cross_entropy
from myconvnet_tpu_torch.train.ssl import ViewFns
from myconvnet_tpu_torch.train.trainer import KEEP, rng_data, seed_of, top1


def labeled_subset(images, labels, per_class: int, num_classes: int,
                   seed: int = 0):
    """The FixMatch protocol's labeled split: ``per_class`` examples of
    each class, drawn with ``RandomState(seed)``; the unlabeled pool keeps
    every example."""
    rng = np.random.RandomState(seed)
    picks = []
    labels = np.asarray(labels)
    for c in range(num_classes):
        idx = np.flatnonzero(labels == c)
        if len(idx) == 0:
            continue
        rng.shuffle(idx)
        picks.append(idx[:per_class])
    picks = np.concatenate(picks) if picks else np.arange(0)
    return images[picks], labels[picks]


def ema_decay_at(step: int, decay: float) -> tuple[float, float]:
    """(d, 1 - d) of step ``step``, each a float32 value, as JAX computes
    ``minimum(decay, (1 + t) / (10 + t))`` and ``1 - d`` from an int32
    step."""
    ramp = np.float32(1.0 + step) / np.float32(10.0 + step)
    d = np.minimum(np.float32(decay), ramp)
    return float(d), float(np.float32(1.0) - d)


def averaged_tensors(model: nn.Module) -> list[torch.Tensor]:
    """What the EMA averages: every parameter, then the BN moving
    statistics (JAX's params and model_state trees)."""
    out = list(model.parameters())
    for m in model.modules():
        if isinstance(m, BatchNorm):
            out += [m.moving_mean, m.moving_var]
    return out


class SemiDraws(NamedTuple):
    """One step's random numbers: the labeled batch's weak view, the
    unlabeled batch's weak and strong views, and the model's dropout masks
    of the [B + 2 mu B] batch (None where it has no random site)."""
    labeled: tuple
    weak: tuple
    strong: tuple
    masks: object = None


class FixMatchTrainer:
    """The model, its optimizer, and ``ema_model`` (the EMA copy the
    evaluation scores)."""

    def __init__(self, model: nn.Module, optimizer, weak: ViewFns,
                 strong: ViewFns, *, device: torch.device, policy: Policy,
                 seed: int = 0, threshold: float = 0.95,
                 lambda_u: float = 1.0, ema_decay: float = 0.999):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.ema_model = copy.deepcopy(self.model)
        for p in self.ema_model.parameters():
            p.requires_grad_(False)
        self.optimizer = optimizer
        self.weak = weak
        self.strong = strong
        self.policy = policy
        self.seed = seed
        self.threshold = float(threshold)
        self.lambda_u = float(lambda_u)
        self.ema_decay = float(ema_decay)
        self.step = 0
        self._gen = torch.Generator(device=self.device)

    def sample(self, n_l: int, n_u: int, hw: tuple[int, int]) -> SemiDraws:
        """This step's draws, a function of (seed, step)."""
        self._gen.manual_seed((self.seed << 32) + self.step)
        g = self._gen
        views = (self.weak.sample(g, n_l, hw), self.weak.sample(g, n_u, hw),
                 self.strong.sample(g, n_u, hw))
        masks = (self.model.sample_masks(n_l + 2 * n_u, g)
                 if hasattr(self.model, "sample_masks") else None)
        return SemiDraws(*views, masks)

    def loss(self, x_l: torch.Tensor, y_l: torch.Tensor, x_u: torch.Tensor,
             draws: SemiDraws) -> dict:
        """The three views in one train-mode forward and the FixMatch
        objective, with the graph for backward; also the metrics."""
        nl, nu = x_l.shape[0], x_u.shape[0]
        xb = torch.cat([self.weak.apply(x_l, draws.labeled),
                        self.weak.apply(x_u, draws.weak),
                        self.strong.apply(x_u, draws.strong)])
        xb = xb.to(self.policy.compute_dtype)
        self.model.train()
        logits = (self.model(xb) if draws.masks is None
                  else self.model(xb, draws.masks)).float()
        lg_l, lg_w, lg_s = logits[:nl], logits[nl:nl + nu], logits[nl + nu:]
        sup = softmax_cross_entropy(lg_l, y_l)
        probs = torch.softmax(lg_w.detach(), dim=-1)
        conf, pseudo = probs.amax(-1), probs.argmax(-1)
        mask = (conf >= self.threshold).float()
        per = -torch.log_softmax(lg_s, dim=-1).gather(
            -1, pseudo[:, None])[:, 0]
        unsup = (per * mask).sum() / nu
        return {"loss": sup + self.lambda_u * unsup, "sup_loss": sup,
                "unsup_loss": unsup, "mask_rate": mask.mean()}

    @torch.no_grad()
    def update_ema(self, step: int) -> None:
        """ema = ema d + new (1 - d) over the parameters and BN moving
        statistics, d of ``step`` (:func:`ema_decay_at`)."""
        d, rest = ema_decay_at(step, self.ema_decay)
        ema = averaged_tensors(self.ema_model)
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, torch._foreach_mul(
            averaged_tensors(self.model), rest))

    def train_step(self, x_l: torch.Tensor, y_l: torch.Tensor,
                   x_u: torch.Tensor, draws: SemiDraws | None = None
                   ) -> dict:
        """One step on the labeled uint8 batch, its labels and the
        unlabeled uint8 batch, on the device; the metrics as device
        tensors (no sync)."""
        if draws is None:
            draws = self.sample(x_l.shape[0], x_u.shape[0],
                                tuple(x_l.shape[1:3]))
        self.optimizer.zero_grad()
        out = self.loss(x_l, y_l, x_u, draws)
        out["loss"].backward()
        self.optimizer.step(self.step)
        self.update_ema(self.step)
        self.step += 1
        return {k: v.detach() for k, v in out.items()}

    @torch.no_grad()
    def predict(self, x_u8: torch.Tensor, use_ema: bool = True
                ) -> torch.Tensor:
        """Classes of a uint8 batch: ``augment_eval`` of the weak config,
        the eval forward of the EMA model (or the trained one), the argmax
        of the float32 logits."""
        model = self.ema_model if use_ema else self.model
        model.eval()
        x = self.weak.eval(x_u8).to(self.policy.compute_dtype)
        return model(x).float().argmax(-1)

    def evaluate(self, batches: Iterable, use_ema: bool = True) -> float:
        """Top-1 over (uint8, labels) batches."""
        return top1(lambda x: self.predict(x, use_ema), batches)

    # ------------------------------------------------------ checkpoints

    def state(self) -> dict:
        """JAX's ``SemiState._asdict()``."""
        params, model_state = weights.to_jax(self.model)
        ema_params, ema_state = weights.to_jax(self.ema_model)
        return {"params": params, "model_state": model_state,
                "ema_params": ema_params, "ema_model_state": ema_state,
                "opt": weights.optimizer_to_jax(self.model, self.optimizer),
                "step": np.asarray(self.step, np.int32),
                "rng": rng_data(self.seed)}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        weights.from_jax(self.model, state["params"], state["model_state"])
        weights.from_jax(self.ema_model, state["ema_params"],
                         state["ema_model_state"])
        weights.optimizer_from_jax(self.model, self.optimizer, state["opt"])
        self.step = int(state["step"])
        self.seed = seed_of(state["rng"])

    def save(self, directory: str, metric: float | None = None,
             is_best: bool = False) -> str:
        return ckpt_lib.save_checkpoint(directory, self.step, self.state(),
                                        keep=KEEP, metric=metric,
                                        is_best=is_best)

    def restore(self, path: str) -> None:
        """Load a checkpoint file, or the newest one in a directory."""
        self.load_state(ckpt_lib.restore_checkpoint(path, self.state()))
