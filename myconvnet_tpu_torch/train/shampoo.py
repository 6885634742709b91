"""Shampoo and blocked Shampoo over the JAX layout's matrices.

Port of ``myconvnet_tpu/train/shampoo.py``.  Each parameter is seen in
the JAX layout (``views``: HWIO convs, [in, out] dense weights; the
identity elsewhere) and, from rank 2, as a matrix G [m, n] with n its last
axis.  Per step, in float32:

    gd = g + wd p                        (coupled; 0 where excluded)
    L += G G^T,  R += G^T G              (unnormalized running sums)
    every ``precond_every`` steps from ``start_step`` on:
        P_L = (L + eps I)^(-1/4),  P_R = (R + eps I)^(-1/4)
    D  = P_L G P_R, rescaled to ||G|| (grafted to the SGD step length);
         G itself before ``start_step`` and for rank < 2
    m  = momentum m + D
    p  = p - lr(step) m

The inverse fourth root is ``torch.linalg.eigh`` of L + eps I with the
eigenvalues clamped at eps (``_inv_fourth_root``, ``:62-66``).
:func:`shampoo` skips an axis longer than ``max_dim`` (its
preconditioner is the identity); :func:`blocked_shampoo` (``:236-331``)
cuts every matrix into zero-padded ``block_size`` tiles, stacks all of
the network's tiles into [T, b, b], refreshes them with one batched
``eigh`` and grafts per tile.  Its ``mesh`` (the tile axis sharded over
a device mesh) is refused by name: the port's trainer runs on one card
(ROADMAP A16).

The state is JAX's ``ShampooState`` / ``BlockedShampooState``: per-leaf
fields indexed by the leaf's position in JAX's tree order (scopes, then
names, sorted), a capped axis or a vector holding nothing, so a
checkpoint reads ``opt_state::.stats_l::<i>`` and ``.momentum::<i>`` as
JAX writes them; ``state_trees`` gives those fields as lists (``None``
where JAX holds an empty tuple) and the blocked statistics as single
[T, b, b] tensors.
"""

from __future__ import annotations

import torch

from myconvnet_tpu_torch.train.optim import (clip_by_global_norm, constant,
                                             decay_mask)


def _inv_fourth_root(s: torch.Tensor, eps: float) -> torch.Tensor:
    """(S + eps I)^(-1/4) of symmetric PSD ``s`` ([..., d, d]) by eigh,
    the eigenvalues clamped at eps."""
    d = s.shape[-1]
    w, v = torch.linalg.eigh(s + eps * torch.eye(d, dtype=s.dtype,
                                                 device=s.device))
    return (v * w.clamp_min(eps).pow(-0.25).unsqueeze(-2)) \
        @ v.transpose(-1, -2)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _as_matrix(shape) -> tuple[int, int] | None:
    """[m, n] of a rank >= 2 shape (n its last axis), else None."""
    if len(shape) < 2:
        return None
    n = shape[-1]
    m = 1
    for d in shape[:-1]:
        m *= d
    return m, n


class _ShampooBase:
    """The parameters in JAX's leaf order, their JAX-layout views, the
    decay mask, the schedule and the per-leaf momentum."""

    def __init__(self, named_params, lr, momentum_coef, precond_every,
                 start_step, eps, weight_decay, weight_decay_exclude,
                 clip_norm, views):
        self.schedule = lr if callable(lr) else constant(float(lr))
        self.named = list(named_params)
        self.params = [p for _, p in self.named]
        views = views or {}
        mask = decay_mask(self.named, weight_decay_exclude)
        # JAX's tree order: the {scope: {name: leaf}} dicts' sorted keys
        self.order = sorted(range(len(self.named)), key=lambda i: tuple(
            self.named[i][0].rsplit("/", 1)))
        self.leaves = [(self.named[i][1],
                        views.get(self.named[i][0], _identity),
                        mask[self.named[i][0]] and weight_decay > 0.0)
                       for i in self.order]
        self.momentum = momentum_coef
        self.precond_every = int(precond_every)
        self.start_step = (2 * self.precond_every if start_step is None
                           else int(start_step))
        self.eps, self.weight_decay = eps, weight_decay
        self.clip_norm = clip_norm
        self.mom = [torch.zeros(tuple(view(p).shape), dtype=torch.float32,
                                device=p.device)
                    for p, view, _ in self.leaves]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _grads(self) -> list[torch.Tensor]:
        """Each leaf's gradient in the JAX layout, float32, clipped and
        decayed."""
        grads = [torch.zeros(tuple(view(p).shape), dtype=torch.float32,
                             device=p.device) if p.grad is None
                 else view(p.grad).float() for p, view, _ in self.leaves]
        if self.clip_norm:
            clip_by_global_norm(grads, float(self.clip_norm))
        return [g + self.weight_decay * view(p).float() if decayed else g
                for g, (p, view, decayed) in zip(grads, self.leaves)]

    def _apply(self, lr: float, directions) -> None:
        for (p, view, _), m, d in zip(self.leaves, self.mom, directions):
            m.mul_(self.momentum).add_(d)
            view(p).copy_(view(p).float() - lr * m)

    def _phase(self, step: int) -> tuple[bool, bool]:
        started = step >= self.start_step
        return started, started and step % self.precond_every == 0


class Shampoo(_ShampooBase):
    """``shampoo`` (``:68-193``)."""

    def __init__(self, named_params, lr, momentum_coef: float = 0.9, *,
                 precond_every: int = 10, start_step: int | None = None,
                 max_dim: int = 1024, eps: float = 1e-6,
                 weight_decay: float = 0.0, weight_decay_exclude=None,
                 clip_norm: float | None = None, views=None):
        super().__init__(named_params, lr, momentum_coef, precond_every,
                         start_step, eps, weight_decay,
                         weight_decay_exclude, clip_norm, views)
        self.stats_l, self.stats_r, self.pre_l, self.pre_r = [], [], [], []
        for p, view, _ in self.leaves:
            mn = _as_matrix(tuple(view(p).shape))
            for dim, stats, pre in ((None if mn is None else mn[0],
                                     self.stats_l, self.pre_l),
                                    (None if mn is None else mn[1],
                                     self.stats_r, self.pre_r)):
                if dim is None or dim > max_dim:
                    stats.append(None)
                    pre.append(None)
                else:
                    stats.append(torch.zeros(dim, dim, device=p.device))
                    pre.append(torch.eye(dim, device=p.device))

    @torch.no_grad()
    def step(self, step: int) -> float:
        lr = self.schedule(step)
        started, refresh = self._phase(step)
        directions = []
        for i, g in enumerate(self._grads()):
            mn = _as_matrix(tuple(g.shape))
            if mn is None:
                directions.append(g)
                continue
            gm = g.reshape(mn)
            if self.stats_l[i] is not None:
                self.stats_l[i].add_(gm @ gm.T)
                if refresh:
                    self.pre_l[i] = _inv_fourth_root(self.stats_l[i],
                                                     self.eps)
            if self.stats_r[i] is not None:
                self.stats_r[i].add_(gm.T @ gm)
                if refresh:
                    self.pre_r[i] = _inv_fourth_root(self.stats_r[i],
                                                     self.eps)
            if not started:
                directions.append(g)
                continue
            pg = gm
            if self.pre_l[i] is not None:
                pg = self.pre_l[i] @ pg
            if self.pre_r[i] is not None:
                pg = pg @ self.pre_r[i]
            scale = torch.linalg.vector_norm(gm) / torch.linalg.vector_norm(
                pg).clamp_min(1e-16)
            directions.append((pg * scale).reshape(g.shape))
        self._apply(lr, directions)
        return lr

    def state_trees(self) -> dict:
        """JAX's ``ShampooState`` fields as lists in JAX's leaf order."""
        return {".stats_l": self.stats_l, ".stats_r": self.stats_r,
                ".precond_l": self.pre_l, ".precond_r": self.pre_r,
                ".momentum": self.mom}

    @torch.no_grad()
    def load_state_trees(self, trees: dict) -> None:
        for field, bufs in self.state_trees().items():
            for buf, value in zip(bufs, trees.get(field, ())):
                if buf is not None and value is not None:
                    buf.copy_(value)


def _tile_plan(shapes, block: int):
    """Per shape: (m, n, row tiles, column tiles, offset of its first
    tile in the stack), None under rank 2; and the stack's tile count."""
    plan, offset = [], 0
    for shape in shapes:
        mn = _as_matrix(shape)
        if mn is None:
            plan.append(None)
            continue
        m, n = mn
        bm, bn = -(-m // block), -(-n // block)
        plan.append((m, n, bm, bn, offset))
        offset += bm * bn
    return plan, offset


def _to_tiles(gm, m, n, bm, bn, block):
    """[m, n] -> [bm * bn, block, block] zero-padded tiles, row-major."""
    pad = gm.new_zeros(bm * block, bn * block)
    pad[:m, :n] = gm
    return pad.reshape(bm, block, bn, block).transpose(1, 2).reshape(
        bm * bn, block, block)


def _from_tiles(t, m, n, bm, bn, block):
    pad = t.reshape(bm, bn, block, block).transpose(1, 2)
    return pad.reshape(bm * block, bn * block)[:m, :n]


class BlockedShampoo(_ShampooBase):
    """``blocked_shampoo`` (``:236-331``)."""

    def __init__(self, named_params, lr, momentum_coef: float = 0.9, *,
                 block_size: int = 128, precond_every: int = 10,
                 start_step: int | None = None, eps: float = 1e-6,
                 weight_decay: float = 0.0, weight_decay_exclude=None,
                 mesh=None, clip_norm: float | None = None, views=None):
        if mesh is not None:
            raise ValueError("blocked_shampoo(mesh=...) shards the tile "
                             "stack over a device mesh; the port trains "
                             "on one card (ROADMAP A16)")
        super().__init__(named_params, lr, momentum_coef, precond_every,
                         start_step, eps, weight_decay,
                         weight_decay_exclude, clip_norm, views)
        self.block = b = int(block_size)
        self.plan, total = _tile_plan(
            [tuple(view(p).shape) for p, view, _ in self.leaves], b)
        dev = self.params[0].device if self.params else None
        t = max(total, 1)
        self.stats_l = torch.zeros(t, b, b, device=dev)
        self.stats_r = torch.zeros(t, b, b, device=dev)
        self.pre_l = torch.eye(b, device=dev).expand(t, b, b).clone()
        self.pre_r = self.pre_l.clone()

    @torch.no_grad()
    def step(self, step: int) -> float:
        lr = self.schedule(step)
        started, refresh = self._phase(step)
        grads = self._grads()
        b = self.block
        tiles = [_to_tiles(g.reshape(pl[0], pl[1]), *pl[:4], b)
                 for g, pl in zip(grads, self.plan) if pl is not None]
        pg_t = None
        if tiles:
            gt = torch.cat(tiles)
            self.stats_l.add_(gt @ gt.transpose(1, 2))
            self.stats_r.add_(gt.transpose(1, 2) @ gt)
            if refresh:
                self.pre_l = _inv_fourth_root(self.stats_l, self.eps)
                self.pre_r = _inv_fourth_root(self.stats_r, self.eps)
            if started:
                pg_t = self.pre_l @ gt @ self.pre_r
                g_n = torch.linalg.vector_norm(gt, dim=(1, 2), keepdim=True)
                p_n = torch.linalg.vector_norm(
                    pg_t, dim=(1, 2), keepdim=True).clamp_min(1e-16)
                pg_t = pg_t * (g_n / p_n)
            else:
                pg_t = gt
        directions = []
        for g, pl in zip(grads, self.plan):
            if pl is None:
                directions.append(g)
                continue
            m, n, bm, bn, off = pl
            directions.append(_from_tiles(pg_t[off:off + bm * bn], m, n,
                                          bm, bn, b).reshape(g.shape))
        self._apply(lr, directions)
        return lr

    def state_trees(self) -> dict:
        """JAX's ``BlockedShampooState``: the stacked statistics and
        preconditioners, the momentum as a list in JAX's leaf order."""
        return {".stats_l": self.stats_l, ".stats_r": self.stats_r,
                ".precond_l": self.pre_l, ".precond_r": self.pre_r,
                ".momentum": self.mom}

    @torch.no_grad()
    def load_state_trees(self, trees: dict) -> None:
        for field, buf in self.state_trees().items():
            if field == ".momentum":
                for m, value in zip(buf, trees.get(field, ())):
                    if value is not None:
                        m.copy_(value)
            elif field in trees:
                buf.copy_(trees[field])


def shampoo(named_params, lr, **kwargs) -> Shampoo:
    return Shampoo(named_params, lr, **kwargs)


def blocked_shampoo(named_params, lr, **kwargs) -> BlockedShampoo:
    return BlockedShampoo(named_params, lr, **kwargs)
