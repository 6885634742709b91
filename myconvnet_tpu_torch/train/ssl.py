"""Self-supervised pretraining: MAE (masked reconstruction) and SimCLR
(contrastive), the kNN probe and the encoder export.

Port of ``myconvnet_tpu/train/ssl.py`` and of ``adapt_ssl`` under
``run_steploop`` (``train.py:216``, ``:358-383``):

* :func:`masked_mse` (``:41-51``) and :func:`nt_xent` (``:90-110``) in
  float32;
* :class:`SSLTrainer`: the MAE step (``:54-85``: one view, forward,
  backward, update) and the SimCLR step (``:113-145``: two views of the
  batch concatenated into one [2N] batch, so that train-mode BN sees
  both), and the checkpoint in JAX's ``TrainState`` layout (either
  package restores the other's); ``train/cli.run_steploop`` drives it,
  as JAX's ``run_steploop`` drives ``adapt_ssl``;
* :func:`export_encoder_npz` (``:151-173``): the flat ``scope::name``
  file of the encoder, with JAX's exclusions, that ``pretrained=dict(
  path=...)`` warm-starts a ViT (or any classifier) from;
* :func:`knn_classify` and :func:`knn_eval` (``:176-223``): the weighted
  cosine-kNN probe of frozen features.

Randomness: JAX splits ``fold_in(rng, step)`` into the view keys and the
model key.  Here :meth:`SSLTrainer.sample` draws a step's views (crop
boxes, flips, jitter factors, SimCLR's grayscale choice) and MAE's
masking noise from a ``torch.Generator`` reseeded from (seed, step), and
``train_step`` takes them as :class:`SSLDraws`, so that a test can hand
over JAX's.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from myconvnet_tpu_torch import weights
from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
from myconvnet_tpu_torch.core.precision import Policy
from myconvnet_tpu_torch.train.trainer import (KEEP, TrainState, rng_data,
                                              seed_of)

KINDS = ("mae", "simclr")
# the encoder export's excluded top-level scopes (``ssl.py:151-153``)
ENCODER_EXCLUDE = ("decoder", "projector", "logits", "head", "fc1", "fc2")


# ------------------------------------------------------------ objectives


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Mean squared error over the masked patches (mask 1), float32.
    pred/target: [B, N, D], mask: [B, N]."""
    per_patch = (pred.float() - target.float()).square().mean(-1)
    mask = mask.float()
    return (per_patch * mask).sum() / mask.sum().clamp(min=1.0)


def _unit(z: torch.Tensor) -> torch.Tensor:
    z = z.float()
    return z / torch.linalg.vector_norm(z, dim=-1,
                                        keepdim=True).clamp(min=1e-12)


def nt_xent(z: torch.Tensor, temperature: float = 0.5
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized-temperature cross entropy over z [2N, D], rows i and
    i + N the two views of example i: (loss, contrastive top-1
    accuracy), float32."""
    two_n = z.shape[0]
    n = two_n // 2
    z = _unit(z)
    sim = (z @ z.T) / temperature
    eye = torch.eye(two_n, dtype=torch.bool, device=z.device)
    sim = sim.masked_fill(eye, -1e9)
    idx = torch.arange(n, device=z.device)
    labels = torch.cat([idx + n, idx])
    loss = F.cross_entropy(sim, labels)
    acc = (sim.argmax(-1) == labels).float().mean()
    return loss, acc


# --------------------------------------------------------- encoder export


def export_encoder_npz(params: dict, path: str,
                       exclude: tuple[str, ...] = ENCODER_EXCLUDE) -> str:
    """Write the encoder subset of a JAX-layout parameter tree
    (``weights.to_jax(model)[0]``) as a flat ``scope::name`` npz; a scope
    whose top-level component is in ``exclude`` is left out.  Returns
    ``path``."""
    flat = {}
    for scope, bucket in params.items():
        if scope.split("/", 1)[0] in exclude:
            continue
        for name, arr in bucket.items():
            flat[f"{scope}::{name}"] = np.asarray(arr)
    np.savez(path, **flat)
    return path


# ---------------------------------------------------------------- probe


def knn_classify(bank_z: torch.Tensor, bank_y: torch.Tensor,
                 query_z: torch.Tensor, *, k: int = 20,
                 num_classes: int = 10,
                 temperature: float = 0.07) -> torch.Tensor:
    """Weighted cosine-kNN labels [Q] of query_z [Q, D] over a labelled
    bank (bank_z [M, D], bank_y [M] int): the top-k similarities, each
    voting exp(s / T) for its label (one-hot votes, summed in the
    neighbours' order), and the first largest vote."""
    bz, qz = _unit(bank_z), _unit(query_z)
    sim = qz @ bz.T
    k = min(k, bz.shape[0])
    top_sim, top_idx = torch.topk(sim, k, dim=-1)
    top_y = bank_y.to(top_idx.device).long()[top_idx]
    weights_ = torch.exp(top_sim / temperature)
    votes = (weights_[:, :, None]
             * F.one_hot(top_y, num_classes).float()).sum(1)
    return votes.argmax(-1)


def knn_eval(feats_fn: Callable[[torch.Tensor], torch.Tensor],
             bank_iter: Iterable, query_iter: Iterable, *, k: int = 20,
             num_classes: int = 10, max_bank: int = 4096,
             max_query: int = 2048) -> float:
    """kNN top-1 of frozen features: embed a labelled bank and a query
    split with ``feats_fn(x_u8) -> [N, D]`` (the batches of each iterator
    until its cap is reached), then classify by :func:`knn_classify`."""
    def embed(it, cap):
        zs, ys, seen = [], [], 0
        try:
            for x, y in it:
                if seen >= cap:
                    break
                zs.append(feats_fn(x).float())
                ys.append(y)
                seen += len(zs[-1])
        finally:
            if hasattr(it, "close"):
                it.close()
        return torch.cat(zs)[:cap], torch.cat(ys)[:cap]

    bank_z, bank_y = embed(bank_iter, max_bank)
    query_z, query_y = embed(query_iter, max_query)
    pred = knn_classify(bank_z, bank_y, query_z, k=k,
                        num_classes=num_classes)
    return float((pred.cpu() == query_y.cpu().long()).double().mean())


# --------------------------------------------------------------- trainer


class ViewFns(NamedTuple):
    """One stochastic view of a uint8 batch, its draws split from their
    application."""
    sample: Callable    # (generator, n, hw) -> draws on its device
    apply: Callable     # (x_u8, draws) -> x, float
    eval: Callable      # (x_u8) -> x: the probe's eval input


class SSLDraws(NamedTuple):
    """One step's random numbers: a view's draws per view (one for MAE,
    two for SimCLR), and the model's (MAE's masking noise [N, tokens]; the
    keep masks by site of a SimCLR backbone that has random sites)."""
    views: tuple
    model: object = None


class SSLTrainer:
    """Holds the model and its optimizer; ``train_step`` is one fused
    step of ``kind`` ("mae": ``model(x, noise) -> (pred, target, mask)``;
    "simclr": ``model(x[, masks]) -> z``), ``embed`` the probe's
    features (``model.features`` for MAE, ``model(x, features_only=True)``
    for SimCLR)."""

    def __init__(self, kind: str, model: nn.Module, optimizer,
                 views: ViewFns, *, device: torch.device, policy: Policy,
                 seed: int = 0, temperature: float = 0.5):
        if kind not in KINDS:
            raise ValueError(f"unknown ssl_kind {kind!r}; valid: "
                             f"{list(KINDS)}")
        self.kind = kind
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.optimizer = optimizer
        self.views = views
        self.policy = policy
        self.seed = seed
        self.temperature = float(temperature)
        self.step = 0
        self._gen = torch.Generator(device=self.device)

    # ------------------------------------------------------------- steps

    def sample(self, n: int, hw: tuple[int, int]) -> SSLDraws:
        """This step's draws, a function of (seed, step)."""
        self._gen.manual_seed((self.seed << 32) + self.step)
        count = 1 if self.kind == "mae" else 2
        views = tuple(self.views.sample(self._gen, n, hw)
                      for _ in range(count))
        if self.kind == "mae":
            return SSLDraws(views, self.model.sample_noise(n, self._gen))
        if hasattr(self.model, "sample_masks"):
            return SSLDraws(views, self.model.sample_masks(2 * n, self._gen))
        return SSLDraws(views)

    def _compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.policy.compute_dtype)

    def loss(self, x_u8: torch.Tensor, draws: SSLDraws) -> dict:
        """The views, the train-mode forward and the loss (``"loss"``,
        and SimCLR's ``"contrast_acc"``), with the graph for backward."""
        self.model.train()
        if self.kind == "mae":
            x = self._compute(self.views.apply(x_u8, draws.views[0]))
            pred, target, mask = self.model(x, draws.model)
            return {"loss": masked_mse(pred, target, mask)}
        x = torch.cat([self.views.apply(x_u8, d) for d in draws.views])
        z = (self.model(self._compute(x)) if draws.model is None
             else self.model(self._compute(x), draws.model))
        loss, acc = nt_xent(z.float(), self.temperature)
        return {"loss": loss, "contrast_acc": acc}

    def train_step(self, x_u8: torch.Tensor,
                   draws: SSLDraws | None = None) -> dict:
        """One step on a uint8 batch [N, H, W, C] on the device;
        ``draws`` defaults to :meth:`sample`.  Returns the metrics as
        device tensors (no sync)."""
        if draws is None:
            draws = self.sample(x_u8.shape[0], tuple(x_u8.shape[1:3]))
        self.optimizer.zero_grad()
        out = self.loss(x_u8, draws)
        out["loss"].backward()
        self.optimizer.step(self.step)
        self.step += 1
        return {k: v.detach() for k, v in out.items()}

    @torch.no_grad()
    def embed(self, x_u8: torch.Tensor) -> torch.Tensor:
        """The probe's float32 features [N, D] of a uint8 batch: the eval
        input chain and the eval-mode features forward."""
        self.model.eval()
        x = self._compute(self.views.eval(x_u8))
        if self.kind == "mae":
            return self.model.features(x).float()
        return self.model(x, features_only=True).float()

    def knn(self, bank_iter: Iterable, query_iter: Iterable, **kw) -> float:
        """:func:`knn_eval` of :meth:`embed`."""
        return knn_eval(self.embed, bank_iter, query_iter, **kw)

    # ------------------------------------------------------ checkpoints

    def state(self) -> TrainState:
        params, model_state = weights.to_jax(self.model)
        return TrainState(params, model_state,
                          weights.optimizer_to_jax(self.model,
                                                   self.optimizer),
                          np.asarray(self.step, np.int32),
                          rng_data(self.seed))

    @torch.no_grad()
    def load_state(self, state: TrainState) -> None:
        weights.from_jax(self.model, state.params, state.model_state)
        weights.optimizer_from_jax(self.model, self.optimizer,
                                   state.opt_state)
        self.step = int(state.step)
        self.seed = seed_of(state.rng)

    def save(self, directory: str, metric: float | None = None,
             is_best: bool = False) -> str:
        return ckpt_lib.save_checkpoint(directory, self.step,
                                        self.state()._asdict(), keep=KEEP,
                                        metric=metric, is_best=is_best)

    def restore(self, path: str) -> None:
        """Load a checkpoint file, or the newest one in a directory."""
        restored = ckpt_lib.restore_checkpoint(path, self.state()._asdict())
        self.load_state(TrainState(**restored))

    def export_encoder(self, path: str) -> str:
        """:func:`export_encoder_npz` of the model's parameters."""
        return export_encoder_npz(weights.to_jax(self.model)[0], path)
