"""Training driver: the train step, validation, logging and checkpoints.

Port of ``myconvnet_tpu/train/trainer.py``: ``TrainState`` (``:43-62``),
``train_step`` (``:211-274``) with gradient accumulation (``accum_steps``,
``:183-249``: the whole batch is augmented and mixed, then split into
microbatches whose gradients are summed in float32 and divided by
``accum_steps``; the loss is the microbatches' mean), ``eval_step``
(``:276-282``), ``fit`` (``:361-501``) and ``evaluate``/``save``/
``restore`` (``:550-621``), and what ``models/base.py:65-113`` hands it
for a recipe with its own input chain: ``augment_fns`` (here
:class:`InputFns`, the recipe's draws split from their application) and
``accuracy_metric=False`` for dense float targets, where the model may
return a list of outputs (the flow pyramid) and the best checkpoint is the
evaluator's ``is_better``, lower or higher.  A recipe whose targets are
masks (segmentation, ``paired_targets`` in JAX) gives :class:`InputFns`
an ``eval_pair`` that transforms the mask with the image in validation,
as JAX's ``eval_step`` does (``:276-282``).  Also random erasing after
MixUp/CutMix (``models/base.py:185-199``), sharpness-aware minimization
(``sam_rho``, ``:187-210``: per microbatch, the ascent pass under
:func:`frozen_stats`, the descent gradient and the BN statistics from
the perturbed pass), reduce-on-plateau in ``fit`` (``:370-377``,
``:463-492``, over ``optim.Plateau``) and the preemption guard
(``:406-420``).  Remat, ZeRO, dispatch chaining and the mesh are not
ported.

Where JAX compiles one program per step, the port runs eagerly and keeps
the step free of host syncs: the augmentation draws are made on the
device (``data.augment.sample_geometry`` and ``sample_policy``, the
RandAugment or AutoAugment draws) or copied from pinned memory
(``data.mix.sample_mix``), and ``fit`` reads each step's metrics one step
late, as the JAX loop does, so the host enqueues step k+1 while the
device runs step k.

Random numbers are a function of (seed, step), as JAX's ``fold_in(key,
step)``: :meth:`Trainer.sample` reseeds its generators from both before
each step, so a restored run draws what the original would have. A model
with random sites (the ViT's drop-path, DeepLab's ASPP dropout) has a
``sample_masks(n, generator)``; the trainer draws one batch of masks per
microbatch there and passes them to ``model(x, masks)``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch import weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.core.precision import Policy
from myconvnet_tpu_torch.data.augment import (AugmentConfig, augment_eval,
                                              augment_train, config_jitter,
                                              sample_geometry, sample_policy,
                                              stats)
from myconvnet_tpu_torch.data.mix import (EraseDraws, MixConfig, MixDraws,
                                          mixup_cutmix, random_erasing,
                                          sample_erasing, sample_mix)
from myconvnet_tpu_torch.eval.evaluators import Evaluator
from myconvnet_tpu_torch.nn import BatchNorm
from myconvnet_tpu_torch.train import optim
from myconvnet_tpu_torch.utils.logging import MetricLogger


# checkpoints the task trainers (self-supervised, distillation, FixMatch)
# keep, as the JAX step loop keeps them
KEEP = 2


class TrainState(NamedTuple):
    """The full training state as numpy trees in the JAX layout: the
    checkpoint unit."""
    params: dict
    model_state: dict       # BN moving statistics
    opt_state: dict         # momentum buffers, or {".mu", ".nu"} for Adam,
    #                         laid out as params; a wrapper's under
    #                         ".inner" beside its own fields
    step: np.ndarray        # int32 scalar
    rng: np.ndarray         # uint32 [2], the seed every draw derives from,
    #                         laid out as JAX's key data of key(seed)


def rng_data(seed: int) -> np.ndarray:
    """uint32 [2]: JAX's key data of ``key(seed)`` (the checkpoint's
    ``rng``)."""
    return np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def seed_of(rng) -> int:
    """The seed a checkpoint's ``rng`` holds (:func:`rng_data`)."""
    v = [int(x) for x in np.asarray(rng).reshape(-1)]
    return v[0] if len(v) == 1 else (v[0] << 32) | v[1]


def top1(predict, batches: Iterable) -> float:
    """The share of labels ``predict`` (uint8 batch -> classes) gets right
    over (uint8, labels) batches, a short tail included as it comes."""
    correct = total = 0
    try:
        for x, y in batches:
            pred = predict(x).cpu().numpy()
            y = y.cpu().numpy()
            correct += int((pred[:len(y)] == y).sum())
            total += len(y)
    finally:
        if hasattr(batches, "close"):
            batches.close()
    return correct / max(total, 1)


@contextlib.contextmanager
def frozen_stats(model: nn.Module):
    """Train-mode BNs of ``model`` normalize with batch statistics but
    leave their moving statistics as they are, and spectral-normalized
    layers leave their power-iteration vector."""
    held = [m for m in model.modules() if isinstance(m, BatchNorm)
            or getattr(m, "spectral_norm", False)]
    for m in held:
        m.update_stats = False
    try:
        yield
    finally:
        for m in held:
            m.update_stats = True


class StepDraws(NamedTuple):
    """One train step's random numbers, on the device."""
    boxes: torch.Tensor | None   # [N, 4] crop boxes (y0, x0, h, w)
    flip: torch.Tensor | None    # [N] bool
    mix: MixDraws | None
    masks: list | None = None    # per microbatch, the model's keep masks
    policy: tuple | None = None  # RandAugment or AutoAugment draws
    jitter: tuple | None = None  # colour-jitter factors
    recipe: tuple | None = None  # the draws of the recipe's InputFns
    erase: EraseDraws | None = None  # random erasing's


class InputFns(NamedTuple):
    """A recipe's own input chain, in place of the ``AugmentConfig`` one
    (the JAX package's ``augment_fns``), with the random draws split from
    their application so that a test can hand over another package's."""
    sample: Callable    # (generator, n, hw) -> draws, on the generator's
    #                     device (hw: the uint8 batch's size)
    train: Callable     # (x_u8, y, draws) -> (x, y)
    eval: Callable      # (x_u8) -> x
    eval_pair: Callable | None = None   # (x_u8, y) -> (x, y): targets
    #                                     that move with the image


class Trainer:
    """Drives training of ``model`` (``forward(x)`` on NHWC input in the
    policy's compute dtype; train mode by ``module.training``)."""

    def __init__(self, model: nn.Module, optimizer,
                 loss_fn: Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor], *,
                 device: torch.device, policy: Policy, num_classes: int,
                 augment: AugmentConfig | None = None,
                 mix: MixConfig | None = None,
                 evaluator: Evaluator | None = None, seed: int = 0,
                 ckpt_dir: str | None = None, keep_checkpoints: int = 3,
                 log_every: int = 50, logger: MetricLogger | None = None,
                 accum_steps: int = 1, accum_dtype: str = "float32",
                 input_fns: InputFns | None = None,
                 accuracy_metric: bool = True, erase_prob: float = 0.0,
                 channels: int = 3, sam_rho: float = 0.0,
                 preemption_guard=None, plateau_factor: float = 0.0,
                 plateau_patience: int = 0, min_lr_scale: float = 1e-4):
        if input_fns is not None and (augment is not None
                                      or mix is not None):
            raise ValueError("input_fns replaces augment and mix")
        self.input_fns = input_fns
        self.accuracy_metric = accuracy_metric
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.policy = policy
        self.num_classes = num_classes
        self.augment = augment
        self.mix = mix
        self.evaluator = evaluator
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.keep_checkpoints = keep_checkpoints
        self.log_every = log_every
        self.logger = logger or MetricLogger()
        self.accum_steps = max(int(accum_steps), 1)
        if accum_dtype != "float32":
            # gradients of float32 parameters sum in float32 in .grad
            raise ValueError(f"the port accumulates in float32, not "
                             f"{accum_dtype!r}")
        # random erasing of the augmented batch (images of ``channels``)
        self.erase_prob = float(erase_prob)
        self.channels = channels
        self.sam_rho = float(sam_rho)
        # utils.preemption.PreemptionGuard: fit stops, saves and returns
        # when it trips
        self.preemption_guard = preemption_guard
        # reduce-on-plateau (factor 0 disables); needs optim.Plateau
        self.plateau_factor = plateau_factor
        self.plateau_patience = plateau_patience
        self.min_lr_scale = min_lr_scale
        self.step = 0
        self._mean_std = stats(augment, self.device) if augment else None
        self._gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------- steps

    def sample(self, n: int, hw: tuple[int, int]) -> StepDraws:
        """This step's draws, a function of (seed, step)."""
        boxes = flip = mix = masks = policy = jitter = recipe = None
        erase = None
        self._gen.manual_seed((self.seed << 32) + self.step)
        if self.input_fns is not None:
            recipe = self.input_fns.sample(self._gen, n, hw)
        if self.augment is not None:
            boxes, flip = sample_geometry(self._gen, n, hw, self.augment)
            policy = sample_policy(self._gen, n, self.augment)
            jitter = config_jitter(self._gen, n, self.augment)
        if self.mix is not None:
            rng = np.random.default_rng([self.seed, self.step])
            mix = sample_mix(rng, n, self.mix, self.device)
        if hasattr(self.model, "sample_masks"):
            micro = n // self.accum_steps
            masks = [self.model.sample_masks(micro, self._gen)
                     for _ in range(self.accum_steps)]
        if self.erase_prob > 0.0:
            out_hw = tuple(self.augment.out_hw) if self.augment else hw
            erase = sample_erasing(self._gen, (n, *out_hw, self.channels),
                                   prob=self.erase_prob)
        return StepDraws(boxes, flip, mix, masks, policy, jitter, recipe,
                         erase)

    def _forward(self, x, masks):
        x = x.to(self.policy.compute_dtype)
        out = self.model(x) if masks is None else self.model(x, masks)
        if isinstance(out, (list, tuple)):   # a multi-scale pyramid
            return [o.float() for o in out]
        return out.float()

    def loss_and_grads(self, x: torch.Tensor, y: torch.Tensor,
                       draws: StepDraws | None = None):
        """Augment, mix, forward in train mode (BN moving statistics
        update) and backward, one microbatch at a time: (loss, logits,
        labels after mixing), with the gradients (the microbatches' mean)
        in each parameter's ``.grad``.  Without the accuracy metric the
        outputs are not kept and ``logits`` is None."""
        if draws is None:
            draws = self.sample(x.shape[0], tuple(x.shape[1:3]))
        if self.input_fns is not None:
            x, y = self.input_fns.train(x, y, draws.recipe)
        if self.augment is not None:
            x = augment_train(x, draws.boxes, draws.flip, self.augment,
                              self._mean_std, draws.policy, draws.jitter)
        if self.mix is not None:
            x, y = mixup_cutmix(x, y, self.num_classes, self.mix, draws.mix)
        if self.erase_prob > 0.0:
            x = random_erasing(x, draws.erase)
        self.model.train()
        self.optimizer.zero_grad()
        accum = self.accum_steps
        if x.shape[0] % accum:
            raise ValueError(f"batch {x.shape[0]} does not split into "
                             f"{accum} microbatches")
        losses, logits = [], []
        for i, (xi, yi) in enumerate(zip(x.chunk(accum), y.chunk(accum))):
            masks = None if draws.masks is None else draws.masks[i]
            kept = (self._sam_ascend(xi, yi, masks) if self.sam_rho > 0.0
                    else None)
            out = self._forward(xi, masks)
            loss = self.loss_fn(out, yi)
            loss.backward()  # .grad sums the microbatches in float32
            if kept is not None:   # back from the perturbed point
                with torch.no_grad():
                    torch._foreach_copy_(kept[0], kept[1])
            losses.append(loss.detach())
            if self.accuracy_metric:
                logits.append(out.detach())
        if not self.accuracy_metric:
            logits = [None]
        if accum == 1:
            return losses[0], logits[0], y
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        torch._foreach_div_(grads, float(accum))
        return (torch.stack(losses).mean(),
                torch.cat(logits) if self.accuracy_metric else None, y)

    def _sam_ascend(self, x, y, masks):
        """SAM's first pass on one microbatch: its gradient g at the
        current weights (BN moving statistics untouched), then the weights
        moved to p + rho g / max(||g||, 1e-12).  Returns (parameters,
        their values before the move)."""
        params = [p for p in self.model.parameters() if p.requires_grad]
        with frozen_stats(self.model):
            loss = self.loss_fn(self._forward(x, masks), y)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        with torch.no_grad():
            scale = self.sam_rho / torch.clamp(optim.global_norm(grads),
                                               min=1e-12)
            kept = [p.detach().clone() for p in params]
            torch._foreach_add_(params, torch._foreach_mul(grads, scale))
        return params, kept

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   draws: StepDraws | None = None) -> dict:
        """One step on a uint8 batch x [N, H, W, C] and int labels y [N]
        on the device; ``draws`` defaults to :meth:`sample`.  Returns the
        metrics as device tensors (no sync).  The optimizer may reuse the
        ``.grad`` tensors as scratch (torch's foreach SGD adds the nesterov
        term into them), so read gradients from :meth:`loss_and_grads`."""
        loss, logits, y = self.loss_and_grads(x, y, draws)
        self.optimizer.step(self.step)
        self.step += 1
        metrics = {"loss": loss}
        if not self.accuracy_metric:    # dense regression: the evaluator
            return metrics
        pred = logits.argmax(-1)
        if logits.dim() == y.dim() + 1:
            # a class per example or per pixel (JAX counts the ignore
            # label's pixels too, trainer.py:262-264)
            metrics["accuracy"] = (pred == y).float().mean()
        else:  # soft labels (MixUp/CutMix): the dominant mix component
            metrics["accuracy"] = (pred == y.argmax(-1)).float().mean()
        return metrics

    @torch.no_grad()
    def eval_step(self, x: torch.Tensor) -> torch.Tensor:
        """float32 outputs of a uint8 batch, eval mode (kernels on)."""
        if self.input_fns is not None:
            x = self.input_fns.eval(x)
        if self.augment is not None:
            x = augment_eval(x, self.augment, self._mean_std)
        return self.forward_eval(x)

    @torch.no_grad()
    def forward_eval(self, x: torch.Tensor) -> torch.Tensor:
        """float32 outputs of an input batch already transformed, eval
        mode (kernels on)."""
        self.model.eval()
        return self._forward(x, None)

    @torch.no_grad()
    def eval_batch(self, x: torch.Tensor, y: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """(float32 outputs, targets) of a uint8 batch and its targets,
        the targets transformed with the image where the recipe's chain
        pairs them (``InputFns.eval_pair``)."""
        fns = self.input_fns
        if fns is not None and fns.eval_pair is not None:
            x, y = fns.eval_pair(x, y)
            return self.forward_eval(x), y
        return self.eval_step(x), y

    # ----------------------------------------------------------- running

    def fit(self, train_iter: Iterable, *, total_steps: int,
            val_iter_fn: Callable[[], Iterable] | None = None,
            val_every: int = 0, early_stop_patience: int = 0) -> None:
        """Run the step loop until ``total_steps``; validate every
        ``val_every`` steps (saving a checkpoint each time, ``best.npz``
        when the score improves) and save the final state."""
        best = self.evaluator.worst_score() if self.evaluator else None
        bad_rounds = plateau_bad = 0
        plateau = bool(self.plateau_factor and self.plateau_patience)
        guard = self.preemption_guard
        # (end step, start step, metrics), read one step late so that the
        # host's read does not wait on the step it just enqueued
        pending = None
        saved_at = None   # the step of this run's newest checkpoint
        t0, window, input_wait = time.perf_counter(), 0, 0.0
        it = iter(train_iter)
        try:
            if plateau:
                # fail fast: without optim.Plateau the first plateau would
                # raise only then
                optim.plateau_scale(self.optimizer)
            while self.step < total_steps:
                if guard is not None and guard.preempted:
                    self.logger.log(self.step, {"preempted": 1.0})
                    break
                t_in = time.perf_counter()
                try:
                    x, y = next(it)
                except StopIteration:
                    break
                input_wait += time.perf_counter() - t_in
                if guard is not None and guard.preempted:
                    # the signal came while waiting on input: enqueue
                    # nothing more, save what is done
                    self.logger.log(self.step, {"preempted": 1.0})
                    break
                prev = self.step
                metrics = self.train_step(x, y)
                window += int(x.shape[0])
                if pending is not None and (pending[0] // self.log_every
                                            > pending[1] // self.log_every):
                    self._log_train(pending[0], pending[2], window, t0,
                                    input_wait)
                    window, t0, input_wait = 0, time.perf_counter(), 0.0
                pending = (self.step, prev, metrics)
                if (val_every and self.step % val_every == 0
                        and val_iter_fn is not None and self.evaluator):
                    score = self.evaluate(val_iter_fn())
                    self.logger.log(self.step,
                                    {f"val_{self.evaluator.name}": score})
                    improved = self.evaluator.is_better(score, best)
                    if improved:
                        best, bad_rounds, plateau_bad = score, 0, 0
                    else:
                        bad_rounds += 1
                        plateau_bad += 1
                    if plateau and plateau_bad >= self.plateau_patience:
                        scale = max(optim.plateau_scale(self.optimizer)
                                    * self.plateau_factor,
                                    self.min_lr_scale)
                        optim.set_plateau_scale(self.optimizer, scale)
                        self.logger.log(self.step, {"lr_scale": scale})
                        plateau_bad = 0
                    if self.ckpt_dir:
                        self.save(metric=score, is_best=improved)
                        saved_at = self.step
                    if early_stop_patience \
                            and bad_rounds >= early_stop_patience:
                        self.logger.log(self.step, {"early_stop": 1.0})
                        break
            if pending is not None:
                self._log_train(pending[0], pending[2], window, t0,
                                input_wait)
            if self.ckpt_dir and saved_at != self.step:
                # (a validation just wrote this step's state)
                self.save()
        finally:
            if hasattr(train_iter, "close"):
                train_iter.close()

    def _log_train(self, step, metrics, window, t0, input_wait):
        host = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if window and dt > 0:
            host["images_per_sec"] = window / dt
            # share of wall time the host sat waiting on input
            host["input_wait_frac"] = input_wait / dt
        self.logger.log(step, host)

    def evaluate(self, data_iter: Iterable) -> float:
        """Score every example of ``data_iter`` (uint8 batches and labels
        on the device) with the evaluator.  A short tail batch is padded
        with zeros to the first batch's size and its outputs sliced back
        (``trainer.py:550-573``): a kernel's launch plan (conv_fused's
        split of K) follows the batch, so the tail's outputs then have the
        bits its images would have inside a full batch."""
        if self.evaluator is None:
            raise ValueError("no evaluator configured")
        self.evaluator.reset()
        full = None
        try:
            for x, y in data_iter:
                n = x.shape[0]
                full = n if full is None else full
                if n < full:
                    x = torch.cat([x, x.new_zeros((full - n, *x.shape[1:]))])
                    y = torch.cat([y, y.new_zeros((full - n, *y.shape[1:]))])
                out, target = self.eval_batch(x, y)
                self.evaluator.update(out[:n], target[:n])
        finally:
            if hasattr(data_iter, "close"):
                data_iter.close()
        return self.evaluator.score()

    # ------------------------------------------------------ checkpoints

    def state(self) -> TrainState:
        params, model_state = weights.to_jax(self.model)
        return TrainState(params, model_state,
                          weights.optimizer_to_jax(self.model,
                                                   self.optimizer),
                          np.asarray(self.step, np.int32), rng_data(self.seed))

    @torch.no_grad()
    def load_state(self, state: TrainState) -> None:
        weights.from_jax(self.model, state.params, state.model_state)
        weights.optimizer_from_jax(self.model, self.optimizer,
                                   state.opt_state)
        self.step = int(state.step)
        self.seed = seed_of(state.rng)

    def save(self, metric: float | None = None,
             is_best: bool = False) -> str:
        if not self.ckpt_dir:
            raise ValueError("no checkpoint directory configured")
        return ckpt_lib.save_checkpoint(
            self.ckpt_dir, self.step, self.state()._asdict(),
            keep=self.keep_checkpoints, metric=metric, is_best=is_best)

    def restore(self, path: str | None = None) -> None:
        """Load a checkpoint file, or the newest one in a directory."""
        path = path or self.ckpt_dir
        if not path:
            raise ValueError("no checkpoint path given")
        restored = ckpt_lib.restore_checkpoint(path, self.state()._asdict())
        self.load_state(TrainState(**restored))
