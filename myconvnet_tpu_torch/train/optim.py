"""SGD with (nesterov) momentum, Adam/AdamW, gradient clipping, the
weight-decay mask, LR schedules.

Port of the parts of ``myconvnet_tpu/train/optim.py`` the CIFAR and ViT
recipes use: ``cosine_decay``/``cosine_restarts`` (``:62-101``),
``polynomial_decay`` (``:70-77``, DeepLab's "poly"),
``warmup`` (``:104-112``), ``norm_and_bias_exclusion`` and the decay mask
(``:131-157``), ``sgd``/``momentum`` (``:159-199``), ``adam``/``adamw``
(``:202-249``), ``lars`` (``:252-293``, :class:`LARS`),
``make_schedule`` / ``make_optimizer`` (``:374-415``),
``global_norm``/``clip_by_global_norm``/``with_gradient_clipping``
(``:416-437``) and the wrappers of ``:440-644`` (freeze, lookahead,
reduce-on-plateau and EMA; see :class:`Frozen` and below).

A schedule is a function of the step counter evaluated in float32, as the
JAX schedules are inside the jitted step.  The update is the JAX one:

    gd = g + wd * p        (coupled L2; 0 for excluded parameters)
    m  = momentum * m + gd (m starts at 0, so the first m is gd)
    d  = gd + momentum * m (nesterov) or m
    p  = p - lr(step) * d

``torch.optim.SGD`` with ``dampening=0`` computes exactly this (its first
step copies gd into the buffer, which equals 0.9 * 0 + gd), so
:class:`SGD` drives it with two parameter groups, decayed and excluded,
and sets the learning rate of both before every step.

:class:`Adam` writes the JAX update out, in float32, with ``count`` the
step + 1 (``:215-232``):

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2
    d  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    d += wd p    (decoupled, AdamW: decayed parameters only; coupled Adam
                  adds wd p to g instead)
    p -= lr(step) d

``torch.optim.AdamW`` decays p by lr * wd before the moment update and
``torch.optim.Adam`` couples the decay, so neither is used.  Clipping is
JAX's: g *= min(1, max_norm / max(||g||, 1e-12)) over the global norm
(``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6).  Both run as
``torch._foreach_*`` ops on device tensors: no host sync in a step.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

Schedule = Callable[[int], float]
F32 = np.float32


def constant(lr: float) -> Schedule:
    return lambda step: float(F32(lr))


def cosine_decay(lr: float, total_steps: int, alpha: float = 0.0
                 ) -> Schedule:
    def fn(step):
        t = np.clip(F32(step) / F32(total_steps), F32(0), F32(1))
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi) * t))
        return float(F32(lr) * ((F32(1) - F32(alpha)) * cos + F32(alpha)))
    return fn


def polynomial_decay(lr: float, total_steps: int, end_lr: float = 0.0,
                     power: float = 0.9) -> Schedule:
    """DeepLab's poly schedule: (lr - end_lr) (1 - t)^power + end_lr at
    t = step / total_steps clipped to [0, 1]."""
    def fn(step):
        t = np.clip(F32(step) / F32(total_steps), F32(0), F32(1))
        return float((F32(lr) - F32(end_lr)) * (F32(1) - t) ** F32(power)
                     + F32(end_lr))
    return fn


def cosine_restarts(lr: float, first_decay_steps: int, t_mul: float = 2.0,
                    m_mul: float = 1.0, alpha: float = 0.0) -> Schedule:
    """SGDR: cosine cycles of geometrically growing length (t_mul) and
    decaying peak (m_mul), in the JAX closed form (the cycle index comes
    from a log, not a loop)."""
    def fn(step):
        t = F32(step) / F32(first_decay_steps)
        if t_mul == 1.0:
            i = np.floor(t)
            frac = t - i
        else:
            i = np.floor(np.log1p(t * F32(t_mul - 1.0)) / np.log(F32(t_mul)))
            start = (F32(t_mul) ** i - F32(1)) / F32(t_mul - 1.0)
            frac = (t - start) / (F32(t_mul) ** i)
        peak = F32(m_mul) ** i
        cos = F32(0.5) * (F32(1) + np.cos(F32(math.pi)
                                          * np.clip(frac, F32(0), F32(1))))
        return float(F32(lr) * peak
                     * ((F32(1) - F32(alpha)) * cos + F32(alpha)))
    return fn


def warmup(schedule: Schedule, warmup_steps: int) -> Schedule:
    """Linear warmup wrapped around any schedule; step 0 already gets
    1 / warmup_steps of it, as ``(step + 1) / warmup_steps`` in JAX."""
    if warmup_steps <= 0:
        return schedule

    def fn(step):
        scale = min(F32(1), F32(step + 1) / F32(warmup_steps))
        return float(F32(scale) * F32(schedule(step)))
    return fn


def make_schedule(cfg: dict) -> Schedule:
    """Config-dict schedule: {"kind": ..., "lr": ..., "warmup_steps": ...}."""
    cfg = dict(cfg)
    kind = cfg.pop("kind", "constant")
    warmup_steps = cfg.pop("warmup_steps", 0)
    table = {"constant": constant, "cosine": cosine_decay,
             "cosine_restarts": cosine_restarts, "poly": polynomial_decay,
             "polynomial": polynomial_decay}
    if kind not in table:
        raise ValueError(f"the port has schedules {sorted(table)}, not "
                         f"{kind!r}")
    return warmup(table[kind](**cfg), warmup_steps)


def norm_and_bias_exclusion(path: str, p) -> bool:
    """Exclude biases and norm scales/offsets from weight decay (any
    rank <= 1 parameter, plus b/beta/gamma by name, and the ViT embedding
    tokens).  ``path`` is the JAX scope path, ``stage1/block1/bn_a/gamma``."""
    name = path.rsplit("/", 1)[-1]
    return (name in ("b", "beta", "gamma", "cls_token", "pos_embed")
            or getattr(p, "ndim", 2) <= 1)


def decay_mask(named_params: Iterable[tuple[str, torch.Tensor]],
               exclude=None) -> dict[str, bool]:
    """{path: True where weight decay applies} (``_decay_mask``)."""
    return {path: exclude is None or not exclude(path, p)
            for path, p in named_params}


class SGD:
    """``optim.sgd``/``momentum`` over (JAX path, parameter) pairs, with
    the optional global-norm clipping of ``with_gradient_clipping``;
    ``step(i)`` applies the update with ``lr(i)``."""

    def __init__(self, named_params: list[tuple[str, torch.Tensor]], lr, *,
                 momentum: float = 0.0, nesterov: bool = False,
                 weight_decay: float = 0.0, weight_decay_exclude=None,
                 clip_norm: float | None = None):
        self.schedule = lr if callable(lr) else constant(float(lr))
        self.clip_norm = clip_norm
        self.named = list(named_params)
        self.paths = {p: path for path, p in named_params}
        mask = decay_mask(named_params, weight_decay_exclude)
        groups = [
            {"params": [p for path, p in named_params if mask[path]],
             "weight_decay": weight_decay},
            {"params": [p for path, p in named_params if not mask[path]],
             "weight_decay": 0.0}]
        self.opt = torch.optim.SGD([g for g in groups if g["params"]],
                                   lr=0.0, momentum=momentum,
                                   nesterov=nesterov)
        self.momentum = momentum

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, step: int) -> float:
        lr = self.schedule(step)
        if self.clip_norm:
            clip_by_global_norm([p.grad for p in self.paths
                                 if p.grad is not None], self.clip_norm)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return lr

    def momentum_buffers(self) -> dict[str, torch.Tensor]:
        """{path: momentum buffer}, zeros before the first step (as the
        JAX state starts)."""
        if self.momentum == 0.0:
            return {}
        out = {}
        for p, path in self.paths.items():
            buf = self.opt.state.get(p, {}).get("momentum_buffer")
            out[path] = torch.zeros_like(p) if buf is None else buf
        return out

    def load_momentum_buffers(self, buffers: dict[str, torch.Tensor]
                              ) -> None:
        for p, path in self.paths.items():
            if path in buffers:  # in the parameter's memory layout
                self.opt.state[p]["momentum_buffer"] = \
                    torch.empty_like(p).copy_(buffers[path])

    def state_trees(self) -> dict[str, dict[str, torch.Tensor]]:
        """The optimizer state as {field: {path: tensor}}; the field ""
        is the JAX state itself (the momentum tree, empty without
        momentum)."""
        return {"": self.momentum_buffers()}

    def load_state_trees(self, trees: dict) -> None:
        self.load_momentum_buffers(trees.get("", {}))


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32, on the
    device."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> torch.Tensor:
    """Scale ``grads`` in place so their global norm is <= max_norm
    (JAX's min(1, max_norm / max(norm, 1e-12))); returns the norm before
    clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    torch._foreach_mul_(grads, scale)
    return norm


class Adam:
    """``optim.adam``/``adamw`` over (JAX path, parameter) pairs, with the
    optional global-norm clipping of ``with_gradient_clipping``;
    ``step(i)`` applies the update with ``lr(i)``."""

    def __init__(self, named_params: list[tuple[str, torch.Tensor]], lr, *,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, decoupled: bool = False,
                 weight_decay_exclude=None, clip_norm: float | None = None):
        self.schedule = lr if callable(lr) else constant(float(lr))
        self.named = list(named_params)
        self.params = [p for _, p in self.named]
        mask = decay_mask(self.named, weight_decay_exclude)
        # indices of the decayed parameters
        self.decayed = [i for i, (path, _) in enumerate(self.named)
                        if mask[path] and weight_decay > 0.0]
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.decoupled = weight_decay, decoupled
        self.clip_norm = clip_norm
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, step: int) -> float:
        lr = self.schedule(step)
        count = F32(step + 1)
        bc1 = float(F32(1) - F32(self.b1) ** count)
        bc2 = float(F32(1) - F32(self.b2) ** count)
        grads = [torch.zeros_like(p) if p.grad is None else p.grad.float()
                 for p in self.params]
        if self.clip_norm:
            clip_by_global_norm(grads, float(self.clip_norm))
        wd = self.weight_decay
        if not self.decoupled:
            for i in self.decayed:
                grads[i] = grads[i] + wd * self.params[i]
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - b2)
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        d = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(d, denom)
        if self.decoupled and self.decayed:
            torch._foreach_add_([d[i] for i in self.decayed],
                                [self.params[i] for i in self.decayed],
                                alpha=wd)
        torch._foreach_add_(self.params, d, alpha=-lr)
        return lr

    def state_trees(self) -> dict[str, dict[str, torch.Tensor]]:
        """{".mu": {path: mu}, ".nu": {path: nu}}: the fields of JAX's
        ``AdamState``, as ``tree_flatten_with_path`` names them in a
        checkpoint (``opt_state::.mu::<scope>::<name>``)."""
        paths = [path for path, _ in self.named]
        return {".mu": dict(zip(paths, self.mu)),
                ".nu": dict(zip(paths, self.nu))}

    @torch.no_grad()
    def load_state_trees(self, trees: dict) -> None:
        for field, bufs in ((".mu", self.mu), (".nu", self.nu)):
            for (path, _), buf in zip(self.named, bufs):
                if path in trees.get(field, {}):
                    buf.copy_(trees[field][path])


class LARS:
    """``optim.lars`` (``:252-293``): layer-wise trust-ratio momentum over
    (JAX path, parameter) pairs, with the optional global-norm clipping of
    ``with_gradient_clipping``; ``step(i)`` applies the update with
    ``lr(i)``.  Per leaf, in float32:

        gd    = g + wd p
        ratio = eta ||p|| / (||gd|| + eps) where both norms are > 0, else 1
        m     = momentum m + lr(step) ratio gd
        p     = p - m

    A leaf that ``weight_decay_exclude`` matches gets neither decay nor
    the ratio (plain momentum).  The state is the momentum tree, laid out
    as the parameters (the JAX state itself)."""

    def __init__(self, named_params: list[tuple[str, torch.Tensor]], lr, *,
                 momentum_coef: float = 0.9, eta: float = 0.001,
                 weight_decay: float = 0.0, eps: float = 1e-9,
                 weight_decay_exclude=None, clip_norm: float | None = None):
        self.schedule = lr if callable(lr) else constant(float(lr))
        self.named = list(named_params)
        self.params = [p for _, p in self.named]
        mask = decay_mask(self.named, weight_decay_exclude)
        self.adaptive = [i for i, (path, _) in enumerate(self.named)
                         if mask[path]]
        self.plain = [i for i, (path, _) in enumerate(self.named)
                      if not mask[path]]
        self.momentum, self.eta = momentum_coef, eta
        self.weight_decay, self.eps = weight_decay, eps
        self.clip_norm = clip_norm
        self.m = [torch.zeros_like(p, dtype=torch.float32)
                  for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, step: int) -> float:
        lr = self.schedule(step)
        grads = [torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad.float() for p in self.params]
        if self.clip_norm:
            clip_by_global_norm(grads, float(self.clip_norm))
        scaled = [None] * len(grads)
        if self.adaptive:
            ps = [self.params[i].float() for i in self.adaptive]
            gd = [grads[i] for i in self.adaptive]
            if self.weight_decay:
                gd = torch._foreach_add(gd, ps, alpha=self.weight_decay)
            w_norm = torch.stack(torch._foreach_norm(ps))
            g_norm = torch.stack(torch._foreach_norm(gd))
            ratio = torch.where((w_norm > 0.0) & (g_norm > 0.0),
                                self.eta * w_norm / (g_norm + self.eps),
                                torch.ones_like(w_norm))
            coef = (lr * ratio).unbind()
            for j, i in enumerate(self.adaptive):
                scaled[i] = gd[j] * coef[j]
        for i in self.plain:
            scaled[i] = grads[i] * lr
        torch._foreach_mul_(self.m, self.momentum)
        torch._foreach_add_(self.m, scaled)
        torch._foreach_sub_(self.params, self.m)
        return lr

    def state_trees(self) -> dict[str, dict[str, torch.Tensor]]:
        """{"": {path: momentum}}: the JAX state is the momentum tree."""
        return {"": {path: m for (path, _), m in zip(self.named, self.m)}}

    @torch.no_grad()
    def load_state_trees(self, trees: dict) -> None:
        for (path, _), m in zip(self.named, self.m):
            if path in trees.get("", {}):
                m.copy_(trees[""][path])


def make_optimizer(named_params, name: str, lr, **kwargs):
    """Config-string optimizer factory (``sgd``, ``momentum``, ``adam``,
    ``adamw``, ``lars``); ``clip_norm`` clips the gradients' global norm
    before the update (``recipes/common.py:101-102``)."""
    named_params = list(named_params)
    if name == "lars":
        return LARS(named_params, lr, **kwargs)
    if name in ("adam", "adamw"):
        if name == "adamw":
            kwargs.setdefault("weight_decay", 1e-4)
            kwargs["decoupled"] = True
        return Adam(named_params, lr, **kwargs)
    if name == "momentum":
        kwargs["momentum"] = kwargs.pop("momentum_coef", 0.9)
    elif name != "sgd":
        raise ValueError(f"the port has optimizers ['adam', 'adamw', "
                         f"'lars', 'momentum', 'sgd'], not {name!r}")
    return SGD(named_params, lr, **kwargs)


# ------------------------------------------------------------ wrappers
#
# Port of ``optim.py:440-644``.  Each wrapper holds an inner optimizer
# (``SGD``, ``Adam`` or another wrapper) over the same (JAX path,
# parameter) pairs and exposes the same ``step(i)``, ``zero_grad`` and
# ``state_trees``/``load_state_trees``.  ``state_trees`` names a field by
# its JAX path, the NamedTuple fields joined by ``SEP`` (``.inner::.mu``
# is ``EmaOptState.inner.mu``), as the checkpoint flattens them; a field
# holds {path: tensor} laid out as the parameters, or one scalar tensor.

SEP = "::"


def _nested(prefix: str, trees: dict) -> dict:
    """``trees``' fields under ``prefix`` (``""``, the tree itself, maps
    to ``prefix``)."""
    return {(f"{prefix}{SEP}{f}" if f else prefix): v
            for f, v in trees.items()}


def _inner_of(prefix: str, trees: dict) -> dict:
    """The fields of ``trees`` under ``prefix``, without it."""
    out = {}
    for f, v in trees.items():
        if f == prefix:
            out[""] = v
        elif f.startswith(prefix + SEP):
            out[f[len(prefix) + len(SEP):]] = v
    return out


class _Wrapper:
    def __init__(self, inner):
        self.inner = inner
        self.named = list(inner.named)
        self.params = [p for _, p in self.named]

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    def _fields(self) -> dict:
        return {}

    def _load_fields(self, trees: dict) -> None:
        pass

    def state_trees(self) -> dict:
        return {**_nested(".inner", self.inner.state_trees()),
                **self._fields()}

    @torch.no_grad()
    def load_state_trees(self, trees: dict) -> None:
        self.inner.load_state_trees(_inner_of(".inner", trees))
        self._load_fields(trees)


def as_frozen_predicate(frozen):
    """``with_frozen``'s ``frozen`` argument, a ``(path, param) -> bool``
    predicate or an iterable of scope-path prefixes, as a predicate (a
    bare string is one prefix)."""
    if callable(frozen):
        return frozen
    if isinstance(frozen, str):
        frozen = (frozen,)
    prefixes = tuple(str(p) for p in frozen)
    return lambda path, p, _pre=prefixes: path.startswith(_pre)


class Frozen(_Wrapper):
    """``with_frozen``: the frozen parameters' gradients are zeroed before
    the inner step (so before the clip inside ``SGD``/``Adam`` takes its
    global norm) and their exact values are put back after it.  It adds no
    state: its checkpoint fields are the inner optimizer's."""

    def __init__(self, inner, frozen):
        super().__init__(inner)
        pred = as_frozen_predicate(frozen)
        self.frozen = [p for path, p in self.named if pred(path, p)]

    def state_trees(self) -> dict:
        return self.inner.state_trees()

    def load_state_trees(self, trees: dict) -> None:
        self.inner.load_state_trees(trees)

    @torch.no_grad()
    def step(self, step: int) -> float:
        kept = [p.detach().clone() for p in self.frozen]
        for p in self.frozen:
            if p.grad is not None:
                p.grad.zero_()
        lr = self.inner.step(step)
        if kept:
            torch._foreach_copy_(self.frozen, kept)
        return lr


class Lookahead(_Wrapper):
    """``with_lookahead``: float32 slow weights; after every
    ``sync_period`` inner steps they move ``slow_step`` of the way to the
    fast weights, ``s + slow_step (f - s)``, and the fast weights are set
    to them.  The step count since the last sync is a host integer (a
    checkpoint holds it as JAX's int32 ``count``), so no step syncs."""

    def __init__(self, inner, sync_period: int = 5, slow_step: float = 0.5):
        super().__init__(inner)
        self.sync_period, self.slow_step = int(sync_period), slow_step
        self.slow = [p.detach().float().clone() for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, step: int) -> float:
        lr = self.inner.step(step)
        self.count += 1
        if self.count >= self.sync_period:
            d = torch._foreach_sub([p.float() for p in self.params],
                                   self.slow)
            torch._foreach_mul_(d, self.slow_step)
            torch._foreach_add_(self.slow, d)
            torch._foreach_copy_(self.params, self.slow)
            self.count = 0
        return lr

    def _fields(self) -> dict:
        return {".slow": {path: s for (path, _), s
                          in zip(self.named, self.slow)},
                ".count": torch.tensor(self.count, dtype=torch.int32)}

    def _load_fields(self, trees: dict) -> None:
        slow = trees.get(".slow", {})
        for (path, _), s in zip(self.named, self.slow):
            if path in slow:
                s.copy_(slow[path])
        if ".count" in trees:
            self.count = int(trees[".count"])


class Plateau(_Wrapper):
    """``with_plateau``: a host-set LR multiplier ``lr_scale`` applied to
    the step's delta in float32, ``p + s (p' - p)`` (every step, also at
    s = 1, as JAX does)."""

    def __init__(self, inner):
        super().__init__(inner)
        self.lr_scale = 1.0

    @torch.no_grad()
    def step(self, step: int) -> float:
        before = [p.detach().float().clone() for p in self.params]
        lr = self.inner.step(step)
        d = torch._foreach_sub([p.float() for p in self.params], before)
        torch._foreach_mul_(d, float(F32(self.lr_scale)))
        torch._foreach_add_(before, d)
        torch._foreach_copy_(self.params, before)
        return lr

    def _fields(self) -> dict:
        return {".lr_scale": torch.tensor(self.lr_scale,
                                          dtype=torch.float32)}

    def _load_fields(self, trees: dict) -> None:
        if ".lr_scale" in trees:
            self.lr_scale = float(trees[".lr_scale"])


class Ema(_Wrapper):
    """``with_ema``: a float32 Polyak average of the parameters after each
    step, ``decay e + (1 - decay) p``, started from the parameters the
    optimizer was made over."""

    def __init__(self, inner, decay: float = 0.999):
        super().__init__(inner)
        self.decay = float(decay)
        self.ema = [p.detach().float().clone() for p in self.params]

    @torch.no_grad()
    def step(self, step: int) -> float:
        lr = self.inner.step(step)
        torch._foreach_mul_(self.ema, self.decay)
        torch._foreach_add_(self.ema, torch._foreach_mul(
            [p.float() for p in self.params], 1.0 - self.decay))
        return lr

    def _fields(self) -> dict:
        return {".ema": {path: e for (path, _), e
                         in zip(self.named, self.ema)}}

    def _load_fields(self, trees: dict) -> None:
        ema = trees.get(".ema", {})
        for (path, _), e in zip(self.named, self.ema):
            if path in ema:
                e.copy_(ema[path])


def _find_plateau(opt) -> Plateau:
    # JAX searches through EmaOptState only (optim.py:573-597); Frozen
    # holds no state of its own, so its state is the inner one's
    if isinstance(opt, Plateau):
        return opt
    if isinstance(opt, (Ema, Frozen)):
        return _find_plateau(opt.inner)
    raise ValueError("optimizer state has no plateau scale (wrap the "
                     "optimizer with optim.with_plateau, inside with_ema)")


def plateau_scale(opt) -> float:
    """The LR multiplier of a :class:`Plateau` in ``opt``."""
    return _find_plateau(opt).lr_scale


def set_plateau_scale(opt, scale: float) -> None:
    """Set the LR multiplier of the :class:`Plateau` in ``opt``."""
    _find_plateau(opt).lr_scale = float(F32(scale))


def extract_ema(opt) -> dict[str, torch.Tensor]:
    """{path: float32 EMA} of an :class:`Ema` optimizer (the caller casts
    to the parameters' dtype)."""
    if not isinstance(opt, Ema):
        raise ValueError("optimizer state has no EMA (wrap the optimizer "
                         "with optim.with_ema)")
    return {path: e for (path, _), e in zip(opt.named, opt.ema)}
