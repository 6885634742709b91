"""Knowledge distillation: a frozen teacher supervises a student.

Port of ``myconvnet_tpu/train/distill.py`` and of ``adapt_distill``'s
state (``train.py:394-404``):

* :func:`distillation_loss` (``:23-45``): alpha T² KL(teacher_T ||
  student_T) + (1 - alpha) CE(labels), in float32;
* :class:`DistillTrainer`, the step of ``make_distill_step``
  (``:53-99``): one augmented view a step, shared by teacher and student;
  the teacher in eval mode under ``no_grad`` (so its BN -> ReLU sites run
  the eval routing's kernels, ``models/blocks.py``), the student in train
  mode; the metrics ``loss``, ``accuracy`` and ``teacher_agreement``;
  the student's top-1 with the eval input chain (``augment_eval``), as
  ``build_distill``'s ``eval_fn`` scores it;
* the checkpoint in JAX's ``DistillState`` layout: the student's
  ``TrainState`` under ``student`` (JAX's keys ``student::.params::...``:
  a NamedTuple field inside the state dict), the teacher's trees under
  ``teacher_params`` and ``teacher_state``, so the checkpoint holds the
  teacher and either package restores the other's.

Randomness: :meth:`DistillTrainer.sample` draws the view (crop, flip, and
a policy or jitter where the config has them) and the student's dropout
masks from a ``torch.Generator`` reseeded from (seed, step); a test hands
JAX's over instead.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch import weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.core.precision import Policy
from myconvnet_tpu_torch.train.losses import softmax_cross_entropy
from myconvnet_tpu_torch.train.ssl import ViewFns
from myconvnet_tpu_torch.train.trainer import KEEP, rng_data, seed_of, top1


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, labels: torch.Tensor, *,
                      temperature: float = 4.0, alpha: float = 0.9,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """alpha T² KL(softmax(t / T) || softmax(s / T)) + (1 - alpha)
    CE(s, labels); T² keeps the soft gradient's size independent of T."""
    sl = student_logits.float()
    tl = teacher_logits.float()
    log_p_s = torch.log_softmax(sl / temperature, dim=-1)
    p_t = torch.softmax(tl / temperature, dim=-1)
    kl = (p_t * (torch.log(torch.clamp(p_t, min=1e-12)) - log_p_s)).sum(-1)
    soft = kl.mean() * (temperature ** 2)
    hard = softmax_cross_entropy(sl, labels,
                                 label_smoothing=label_smoothing)
    return alpha * soft + (1.0 - alpha) * hard


class DistillDraws(NamedTuple):
    """One step's random numbers: the view's draws and the student's
    dropout masks (None where it has no random site)."""
    view: tuple
    masks: object = None


class DistillTrainer:
    """The student, its optimizer and the frozen teacher."""

    def __init__(self, student: nn.Module, teacher: nn.Module, optimizer,
                 views: ViewFns, *, device: torch.device, policy: Policy,
                 seed: int = 0, temperature: float = 4.0,
                 alpha: float = 0.9):
        self.device = torch.device(device)
        self.model = student.to(self.device)
        self.teacher = teacher.to(self.device).eval()
        for p in self.teacher.parameters():
            p.requires_grad_(False)
        self.optimizer = optimizer
        self.views = views
        self.policy = policy
        self.seed = seed
        self.temperature = float(temperature)
        self.alpha = float(alpha)
        self.step = 0
        self._gen = torch.Generator(device=self.device)

    def sample(self, n: int, hw: tuple[int, int]) -> DistillDraws:
        """This step's draws, a function of (seed, step)."""
        self._gen.manual_seed((self.seed << 32) + self.step)
        view = self.views.sample(self._gen, n, hw)
        masks = (self.model.sample_masks(n, self._gen)
                 if hasattr(self.model, "sample_masks") else None)
        return DistillDraws(view, masks)

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.policy.compute_dtype)

    def loss(self, x_u8: torch.Tensor, y: torch.Tensor,
             draws: DistillDraws) -> dict:
        """The shared view, the teacher's eval forward (no gradient), the
        student's train forward and the loss, with the graph for
        backward; also both float32 logits."""
        x = self._compute(self.views.apply(x_u8, draws.view))
        with torch.no_grad():
            self.teacher.eval()
            t_logits = self.teacher(x).float()
        self.model.train()
        s_logits = (self.model(x) if draws.masks is None
                    else self.model(x, draws.masks)).float()
        loss = distillation_loss(s_logits, t_logits, y,
                                 temperature=self.temperature,
                                 alpha=self.alpha)
        return {"loss": loss, "student_logits": s_logits,
                "teacher_logits": t_logits}

    def train_step(self, x_u8: torch.Tensor, y: torch.Tensor,
                   draws: DistillDraws | None = None) -> dict:
        """One step on a uint8 batch and its labels on the device; the
        metrics as device tensors (no sync)."""
        if draws is None:
            draws = self.sample(x_u8.shape[0], tuple(x_u8.shape[1:3]))
        self.optimizer.zero_grad()
        out = self.loss(x_u8, y, draws)
        out["loss"].backward()
        self.optimizer.step(self.step)
        self.step += 1
        s_pred = out["student_logits"].detach().argmax(-1)
        return {"loss": out["loss"].detach(),
                "accuracy": (s_pred == y).float().mean(),
                "teacher_agreement": (s_pred == out["teacher_logits"]
                                      .argmax(-1)).float().mean()}

    @torch.no_grad()
    def predict(self, x_u8: torch.Tensor) -> torch.Tensor:
        """The student's classes of a uint8 batch: the eval input chain,
        the eval forward, the argmax of the float32 logits."""
        self.model.eval()
        x = self._compute(self.views.eval(x_u8))
        return self.model(x).float().argmax(-1)

    def evaluate(self, batches: Iterable) -> float:
        """The student's top-1 over (uint8, labels) batches."""
        return top1(self.predict, batches)

    # ------------------------------------------------------ checkpoints

    def state(self) -> dict:
        """JAX's ``DistillState._asdict()``: the student's TrainState under
        ``student`` (its fields as JAX's tree path names them), the
        teacher's trees beside it."""
        params, model_state = weights.to_jax(self.model)
        t_params, t_state = weights.to_jax(self.teacher)
        student = {".params": params, ".model_state": model_state,
                   ".opt_state": weights.optimizer_to_jax(self.model,
                                                          self.optimizer),
                   ".step": np.asarray(self.step, np.int32),
                   ".rng": rng_data(self.seed)}
        return {"student": student, "teacher_params": t_params,
                "teacher_state": t_state}

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        st = state["student"]
        weights.from_jax(self.model, st[".params"], st[".model_state"])
        weights.optimizer_from_jax(self.model, self.optimizer,
                                   st[".opt_state"])
        weights.from_jax(self.teacher, state["teacher_params"],
                         state.get("teacher_state", {}))
        self.step = int(st[".step"])
        self.seed = seed_of(st[".rng"])

    def save(self, directory: str, metric: float | None = None,
             is_best: bool = False) -> str:
        return ckpt_lib.save_checkpoint(directory, self.step, self.state(),
                                        keep=KEEP, metric=metric,
                                        is_best=is_best)

    def restore(self, path: str) -> None:
        """Load a checkpoint file, or the newest one in a directory."""
        self.load_state(ckpt_lib.restore_checkpoint(path, self.state()))

