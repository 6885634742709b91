"""ConvNet: the reference's model API over the port's trainer.

Port of ``myconvnet_tpu/models/base.py``.  ``build()`` makes the module
(from ``model_fn(num_classes, **model_kwargs)`` or the subclass hook
:meth:`ConvNet._build_model`), initialises it from ``seed`` and binds the
optimizer to it; ``train()`` runs ``Trainer.fit``; ``predict()`` scores
images, with flip or ten-crop test-time augmentation;
``predict_segmentation()`` runs the multi-scale or sliding-window
protocol; ``features()`` returns the backbone map the JAX zoo tags
``"features"``; ``evaluate()``, ``save()``, ``restore()`` and ``close()``
complete it.

Where JAX keeps a pure ``TrainState`` beside a stateless trainer, the
port's state lives in the module and the optimizer, which the
:class:`Trainer` holds with the step; :attr:`ConvNet.state` reads and
writes it as the JAX ``TrainState`` of numpy trees.  So an optimizer is
bound to parameters: ``build``/``train`` take an optimizer *factory*,
``model -> optimizer`` (``recipes.optimizer_factory(cfg["optimizer"])``),
and a different factory object resets the state, as a different JAX
optimizer does (``base.py:231-238``).

``predict`` and ``features`` pad a short tail batch with zeros to the
full batch, as JAX does for its static shape (``base.py:372-379``):
B4's planner picks its split of K by the batch, and the split changes
the order of a sum, so only at the full batch's plan does an image get
the bits it gets inside a full batch.  JAX's ``augment_fns`` (an image-output recipe's
key-taking chain: super-resolution) is not ported; the port's own
recipes with a chain of their own (segmentation, flow) pass
``input_fns``, its draws split from their application.  ``mesh`` and
``use_mesh`` are refused by name (ROADMAP A16); ``remat``,
``chain_steps``, ``zero_sharding`` and ``spatial`` change how JAX runs a
step over a mesh, not what it computes, and are accepted and ignored.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.core.init import init_model
from myconvnet_tpu_torch.core.precision import apply_backend_flags, \
    get_policy
from myconvnet_tpu_torch.data.augment import (AugmentConfig, JitterDraws,
                                              augment_eval,
                                              augment_eval_pair,
                                              augment_train_pair,
                                              batched_crop_resize,
                                              config_jitter, normalize,
                                              sample_geometry, stats)
from myconvnet_tpu_torch.data.mix import MixConfig
from myconvnet_tpu_torch.eval.evaluators import (AccuracyEvaluator,
                                                 Evaluator, MeanIoUEvaluator)
from myconvnet_tpu_torch.train import optim
from myconvnet_tpu_torch.train.losses import softmax_cross_entropy
from myconvnet_tpu_torch.train.trainer import InputFns, Trainer, TrainState
from myconvnet_tpu_torch.utils.logging import MetricLogger
from myconvnet_tpu_torch.weights import param_views, to_jax

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PairDraws(NamedTuple):
    """One segmentation train step's draws: the crop boxes [N, 4], the
    flips [N] bool and the colour-jitter factors (None when off)."""
    boxes: torch.Tensor
    flip: torch.Tensor
    jitter: JitterDraws | None


def segmentation_input_fns(cfg: AugmentConfig, device) -> InputFns:
    """The paired-target input chain over uint8 images and int masks
    (``base.py:170-179``): one geometry for image and mask
    (``augment_train_pair``), jitter on the image alone; in validation
    the whole frame resized, mask with image (``augment_eval_pair``); the
    image alone for prediction."""
    mean_std = stats(cfg, device)

    def sample(generator, n, hw):
        boxes, flip = sample_geometry(generator, n, hw, cfg)
        return PairDraws(boxes, flip, config_jitter(generator, n, cfg))

    def train(x_u8, y, draws):
        return augment_train_pair(x_u8, y, draws.boxes, draws.flip, cfg,
                                  mean_std, draws.jitter)

    def eval_pair(x_u8, y):
        return augment_eval_pair(x_u8, y, cfg, mean_std)

    def eval_image(x_u8):
        return augment_eval_pair(x_u8, None, cfg, mean_std)[0]

    return InputFns(sample, train, eval_image, eval_pair)


def default_optimizer(model: nn.Module) -> optim.SGD:
    """``optim.momentum(0.01, 0.9)``, the JAX ConvNet's default."""
    return optim.SGD([(path, p) for path, p, _ in param_views(model)],
                     0.01, momentum=0.9)


class ConvNet:
    """The reference's model wrapper.

    Example::

        net = ConvNet(resnet50, input_shape=(224, 224, 3),
                      num_classes=1000, precision="bf16", device="cuda")
        net.build()
        net.train(train_set, val_set, batch_size=256, total_steps=1000)
        logits = net.predict(images)
        net.save("ckpts/")
    """

    def __init__(self, model_fn: Callable[..., nn.Module] | None = None, *,
                 input_shape: tuple[int, ...] = (32, 32, 3),
                 num_classes: int = 10, precision: str = "f32",
                 loss_fn: Callable | None = None,
                 augment: AugmentConfig | None = None,
                 mix: MixConfig | None = None, erase_prob: float = 0.0,
                 paired_targets: bool = False,
                 input_fns: InputFns | None = None,
                 augment_fns: tuple | None = None, mesh=None,
                 use_mesh: bool = False, remat: bool = False,
                 accum_steps: int = 1, accum_dtype: str = "float32",
                 spatial: bool = False, zero_sharding: bool = False,
                 sam_rho: float = 0.0, chain_steps: int = 1,
                 accuracy_metric: bool = True, seed: int = 0,
                 ckpt_dir: str | None = None, log_dir: str | None = None,
                 log_every: int = 50, device="cuda", **model_kwargs):
        if model_fn is None and type(self)._build_model is \
                ConvNet._build_model:
            raise ValueError("pass model_fn or subclass and override "
                             "_build_model")
        if augment_fns is not None:
            raise ValueError("ConvNet argument 'augment_fns' is not ported "
                             "(the image-output recipes that pass it, "
                             "super-resolution, are ROADMAP A17); a recipe "
                             "with its own chain passes input_fns")
        if mesh is not None or use_mesh:
            raise ValueError("ConvNet arguments 'mesh'/'use_mesh' are not "
                             "ported (ROADMAP A16: the port trains on one "
                             "device)")
        self._model_fn = model_fn
        self.input_shape = tuple(input_shape)
        self.num_classes = num_classes
        self.policy = get_policy(precision)
        self.loss_fn = loss_fn or (
            lambda logits, y: softmax_cross_entropy(logits, y))
        self.augment = augment
        self.mix = mix
        self.erase_prob = erase_prob
        self.paired_targets = paired_targets
        self.input_fns = input_fns
        self.accum_steps = accum_steps
        self.accum_dtype = accum_dtype
        self.sam_rho = sam_rho
        self.accuracy_metric = accuracy_metric
        self.seed = seed
        self.ckpt_dir = ckpt_dir
        self.log_every = log_every
        self.device = torch.device(device)
        self.model_kwargs = model_kwargs
        self.logger = MetricLogger(log_dir)
        # utils.preemption.PreemptionGuard, handed to the trainer
        self.preemption_guard = None
        self.model: nn.Module | None = None
        self.optimizer = None
        self._optimizer = None
        self._trainer: Trainer | None = None
        self._tta_cache: dict = {}
        self._flops_cache: dict = {}

    # ------------------------------------------------------------ model

    def _build_model(self) -> nn.Module:
        """Subclass hook (the reference's abstract ``_build_model``)."""
        return self._model_fn(self.num_classes, **self.model_kwargs)

    # ------------------------------------------------------------ build

    def build(self, optimizer: Callable | None = None,
              batch_size: int = 2) -> "ConvNet":
        """Make the module, initialise it from ``seed`` and bind the
        optimizer (``optimizer(model)``; momentum 0.01/0.9 by default).
        Idempotent.  ``batch_size`` is JAX's init sample's and unused."""
        if self._trainer is not None:
            return self
        factory = optimizer or self._optimizer or default_optimizer
        self._optimizer = factory
        model = self._build_model()
        init_model(model, torch.Generator().manual_seed(self.seed))
        apply_backend_flags(self.policy)
        self.model = model.to(self.device)
        self.optimizer = factory(self.model)
        self._trainer = self._make_trainer(None)
        return self

    def _make_trainer(self, evaluator: Evaluator | None) -> Trainer:
        """The trainer over the built module and optimizer: the recipe's
        ``input_fns``; for paired targets (segmentation) the paired chain
        of ``augment``; otherwise ``augment`` -> MixUp/CutMix -> random
        erasing (``base.py:163-214``)."""
        fns, augment, mix, erase = self.input_fns, None, None, 0.0
        if fns is None and self.paired_targets:
            if self.augment is None:
                raise ValueError("paired targets need an augment config "
                                 "(its out_hw is the training crop)")
            fns = segmentation_input_fns(self.augment, self.device)
        elif fns is None:
            augment, mix, erase = self.augment, self.mix, self.erase_prob
        return Trainer(self.model, self.optimizer, self.loss_fn,
                       device=self.device, policy=self.policy,
                       num_classes=self.num_classes, augment=augment,
                       mix=mix, evaluator=evaluator, seed=self.seed,
                       ckpt_dir=self.ckpt_dir, log_every=self.log_every,
                       logger=self.logger, accum_steps=self.accum_steps,
                       accum_dtype=self.accum_dtype, input_fns=fns,
                       accuracy_metric=self.accuracy_metric,
                       erase_prob=erase, channels=self.input_shape[-1],
                       sam_rho=self.sam_rho,
                       preemption_guard=self.preemption_guard)

    @property
    def trainer(self) -> Trainer:
        """The :class:`Trainer` over the built net (builds if needed)."""
        self.build()
        return self._trainer

    @property
    def state(self) -> TrainState:
        """The full training state as JAX's ``TrainState`` of numpy
        trees; assigning one loads it."""
        return self.trainer.state()

    @state.setter
    def state(self, state: TrainState) -> None:
        self.trainer.load_state(state)

    # ------------------------------------------------------------ train

    def train(self, train_set, val_set=None, *, batch_size: int = 128,
              total_steps: int = 1000, epochs: int | None = None,
              optimizer: Callable | None = None,
              evaluator: Evaluator | None = None, val_every: int = 0,
              early_stop_patience: int = 0, plateau_factor: float = 0.0,
              plateau_patience: int = 0) -> "ConvNet":
        """Run the step loop to ``total_steps`` (or ``epochs`` of the
        train split, whole batches), validating every ``val_every``
        steps; returns the net (its state is :attr:`state`)."""
        if epochs is not None:
            total_steps = epochs * max(len(train_set) // batch_size, 1)
        if optimizer is not None and optimizer is not self._optimizer:
            # another optimizer invalidates the state; the same one (the
            # resume flow: build(opt) -> restore -> train(opt)) keeps it
            self._optimizer = optimizer
            self._trainer = None
        self.build()
        if evaluator is None:
            evaluator = (MeanIoUEvaluator(self.num_classes)
                         if self.paired_targets else AccuracyEvaluator())
        trainer = self._trainer
        trainer.evaluator = evaluator
        trainer.logger = self.logger
        trainer.preemption_guard = self.preemption_guard
        on = bool(plateau_factor and plateau_patience)
        trainer.plateau_factor = plateau_factor if on else 0.0
        trainer.plateau_patience = plateau_patience if on else 0
        val_iter_fn = ((lambda: val_set.eval_iter(batch_size, self.device))
                       if val_set is not None else None)
        trainer.fit(train_set.train_iter(batch_size, self.device),
                    total_steps=total_steps, val_iter_fn=val_iter_fn,
                    val_every=val_every,
                    early_stop_patience=early_stop_patience)
        return self

    # ---------------------------------------------------------- inspect

    def count_params(self) -> int:
        """Trainable parameters, counted in the JAX tree."""
        self.build()
        return sum(p.numel() for _, p, _ in param_views(self.model))

    def forward_flops(self, batch_size: int = 1) -> float | None:
        """FLOPs an image of one eval forward at ``input_shape``, counted
        by ``torch.utils.flop_counter.FlopCounterMode`` (convolutions and
        matmuls, two a multiply-add) on a fresh host copy of the module,
        where every layer runs its plain PyTorch version; None when
        nothing is counted.  Cached by batch size."""
        if batch_size in self._flops_cache:
            return self._flops_cache[batch_size]
        from torch.utils.flop_counter import FlopCounterMode
        model = self._build_model().eval()
        x = torch.zeros((batch_size, *self.input_shape),
                        dtype=self.policy.compute_dtype)
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(x)
        flops = counter.get_total_flops()
        out = flops / batch_size if flops else None
        self._flops_cache[batch_size] = out
        return out

    def summary(self, depth: int = 1, print_fn=print) -> str:
        """Parameters by scope (the first ``depth`` path segments), with
        each group's largest shape, the total, the BN statistics and the
        forward GFLOPs an image."""
        self.build()
        params, model_state = to_jax(self.model)
        groups: dict[str, tuple[int, list]] = {}
        for scope, entries in params.items():
            key = "/".join(scope.split("/")[:depth])
            tot, shapes = groups.get(key, (0, []))
            groups[key] = (tot + sum(int(np.prod(p.shape))
                                     for p in entries.values()),
                           shapes + [tuple(p.shape)
                                     for p in entries.values()])
        state_n = sum(int(np.prod(p.shape)) for b in model_state.values()
                      for p in b.values())
        width = max([len(k) for k in groups] + [10]) + 2
        lines = [f"{'scope':<{width}}{'params':>12}  largest shape",
                 "-" * (width + 30)]
        for k, (tot, shapes) in groups.items():
            big = max(shapes, key=np.prod) if shapes else ()
            lines.append(f"{k:<{width}}{tot:>12,}  {big}")
        lines.append("-" * (width + 30))
        lines.append(f"{'total':<{width}}{self.count_params():>12,}")
        if state_n:
            lines.append(f"{'(state: BN stats etc.)':<{width}}"
                         f"{state_n:>12,}")
        flops = self.forward_flops()
        if flops:
            lines.append(f"{'forward GFLOPs/img':<{width}}"
                         f"{flops / 1e9:>12.2f}")
        text = "\n".join(lines)
        if print_fn:
            print_fn(text)
        return text

    # ---------------------------------------------------------- predict

    def _on_device(self, images) -> torch.Tensor:
        return torch.as_tensor(np.asarray(images) if not isinstance(
            images, torch.Tensor) else images).to(self.device)

    def _batches(self, images, batch_size: int):
        """(batch on the device, its real size): ``batch_size`` images at
        a time, the tail padded with zeros to the full batch."""
        full = min(batch_size, len(images))
        for i in range(0, len(images), batch_size):
            x = self._on_device(images[i:i + batch_size])
            k = x.shape[0]
            if k < full:
                x = torch.cat([x, x.new_zeros((full - k, *x.shape[1:]))])
            yield x, k

    def predict(self, images, batch_size: int = 256,
                tta: str | None = None) -> np.ndarray:
        """float32 outputs of ``images`` (raw uint8 frames where the net
        has an augment config), ``batch_size`` at a time (the tail
        padded); under ``tta`` ('flip' or 'ten_crop') the log of the
        view-averaged softmax."""
        trainer = self.trainer
        step = self._tta_step(tta) if tta is not None else None
        outs = []
        for x, k in self._batches(images, batch_size):
            out = step(x) if step is not None else trainer.eval_step(x)
            outs.append(out[:k].float().cpu().numpy())
        return np.concatenate(outs)

    def _tta_step(self, mode: str):
        """x -> log of the mean softmax over the views (``base.py:388-
        474``), the views made on the device and run one after another
        at the batch's size."""
        if mode in self._tta_cache:
            return self._tta_cache[mode]
        if mode not in ("flip", "x8", "ten_crop"):
            raise ValueError(f"unknown tta mode {mode!r}")
        if self.input_fns is not None or mode == "x8":
            # image-output self-ensembles need JAX's augment_fns (the
            # super-resolution family, ROADMAP A17)
            raise ValueError(f"tta {mode!r} for image-output nets is not "
                             "ported (augment_fns, ROADMAP A17); "
                             "classifiers take 'flip' or 'ten_crop'")
        if mode == "ten_crop" and self.augment is None:
            raise ValueError("ten_crop TTA needs an augment config "
                             "(raw-image inputs)")
        cfg, trainer = self.augment, self.trainer
        mean_std = stats(cfg, self.device) if cfg is not None else None

        def views(x):
            if cfg is None:   # pre-processed float inputs: mirror only
                return [x, x.flip(2)]
            if mode == "flip":
                v = augment_eval(x, cfg, mean_std)
                return [v, v.flip(2)]
            n, h, w, _ = x.shape
            side = 0.875 * min(h, w)
            ys = (0.0, h - side, (h - side) / 2.0)
            xs = (0.0, w - side, (w - side) / 2.0)
            out = []
            for by, bx in ((0, 0), (0, 1), (1, 0), (1, 1), (2, 2)):
                box = torch.tensor([ys[by], xs[bx], side, side],
                                   dtype=torch.float32, device=x.device)
                v = batched_crop_resize(x, box.expand(n, 4),
                                        tuple(cfg.out_hw))
                v = normalize(v * (1.0 / 255.0), cfg.mean, cfg.std).to(
                    _DTYPES[cfg.out_dtype])
                out += [v, v.flip(2)]
            return out

        @torch.no_grad()
        def step(x):
            probs = [torch.softmax(trainer.forward_eval(v), dim=-1)
                     for v in views(x)]
            return torch.log(torch.stack(probs).mean(0) + 1e-12)

        self._tta_cache[mode] = step
        return step

    def predict_segmentation(self, images, *, scales=(1.0,),
                             flip: bool = False,
                             tile_hw: tuple[int, int] | None = None,
                             batch_size: int = 16) -> np.ndarray:
        """Class map [N, H, W] of raw frames with the DeepLab protocol:
        softmax averaged over ``scales`` (and mirrors with ``flip``), or
        overlapping windows of ``tile_hw``.  Frames are divided by 255
        when uint8 and normalized by the augment config's mean and std
        when there is one."""
        from myconvnet_tpu_torch.eval.seg_inference import (
            multiscale_logits, sliding_window_logits)
        trainer, cfg = self.trainer, self.augment
        outs = []
        for i in range(0, len(images), batch_size):
            raw = self._on_device(images[i:i + batch_size])
            x = raw.float()
            if raw.dtype == torch.uint8:
                x = x * (1.0 / 255.0)
            if cfg is not None:
                x = normalize(x, cfg.mean, cfg.std)
            if tile_hw is not None:
                logits = sliding_window_logits(trainer.forward_eval, x,
                                               tuple(tile_hw))
            else:
                logits = multiscale_logits(trainer.forward_eval, x,
                                           scales=scales, flip=flip)
            outs.append(logits.argmax(-1).cpu().numpy())
        return np.concatenate(outs)

    @torch.no_grad()
    def features(self, images, batch_size: int = 256,
                 tag: str = "features") -> np.ndarray:
        """The backbone map the JAX zoo tags ``"features"`` (before the
        pooling), by the module's ``features`` method, or an embedding
        net's unit-norm ``"embedding"`` (its ``embedding`` method), of
        input batches in the net's input layout (no input chain, as JAX
        applies none)."""
        model = self.trainer.model
        if tag not in ("features", "embedding") \
                or not hasattr(model, tag):
            raise ValueError(f"no intermediate tagged {tag!r} in "
                             f"{type(model).__name__} (the port tags "
                             "'features' on models with a features "
                             "method, 'embedding' on embedding nets)")
        model.eval()
        outs = []
        for x, k in self._batches(images, batch_size):
            f = getattr(model, tag)(x.to(self.policy.compute_dtype))
            outs.append(f[:k].float().cpu().numpy())
        return np.concatenate(outs)

    def evaluate(self, data_set, evaluator: Evaluator | None = None,
                 batch_size: int = 256) -> float:
        trainer = self.trainer
        trainer.evaluator = evaluator or AccuracyEvaluator()
        return trainer.evaluate(data_set.eval_iter(batch_size, self.device))

    # ------------------------------------------------------------- ckpt

    def save(self, path: str | None = None) -> str:
        from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
        if self._trainer is None:
            raise ValueError("nothing to save; call build or train")
        directory = path or self.ckpt_dir
        if not directory:
            raise ValueError("no checkpoint directory given")
        return ckpt_lib.save_checkpoint(directory, self._trainer.step,
                                        self._trainer.state()._asdict())

    def restore(self, path: str | None = None) -> "ConvNet":
        """Load a checkpoint file, or the newest in a directory, written
        by either package."""
        self.trainer.restore(path or self.ckpt_dir)
        return self

    def close(self) -> None:
        """Drop the module, optimizer and trainer (``Session.close``)."""
        self.model = self.optimizer = self._trainer = None
        self._tta_cache = {}
