"""Weight bridge between the JAX package's trees and the port's modules.

The JAX package keeps parameters and state as numpy-convertible trees
``{scope: {name: array}}`` (``myconvnet_tpu/core/module.py``), with scopes
like ``stage1/block1/conv_a``.  The port's module paths are the same
scopes with "/" read as "." (``stage1.block1.conv_a``), so the mapping is
by name:

* ``Conv``: ``w`` HWIO <-> ``weight`` OIHW (channels_last); optional ``b``;
  a grouped conv's ``w`` [kh, kw, cin / g, cout] <-> ``weight``
  [cout, cin / g, kh, kw];
* ``DepthwiseConv``: ``w`` [kh, kw, C, m] <-> ``weight`` [C * m, 1, kh,
  kw] (channels_last), output channel c * m + k from ``w[..., c, k]``;
* ``ConvTranspose``: ``w`` HWIO <-> ``weight`` [Cin, Cout, kh, kw]
  (channels_last), a permutation: the op flips the kernel in space at use,
  so the stored kernel is JAX's; optional ``b``;
* ``BatchNorm``: params ``gamma``, ``beta``; state ``moving_mean``,
  ``moving_var``.  A scope missing from the tree means the JAX fold removed
  it (``models/folding.py``), and the module is marked folded;
* ``Dense``: ``w`` [in, out] <-> ``weight`` [out, in]; optional ``b``;
* a spectral-normalized ``Conv`` or ``Dense``: state ``sn_u`` (its power
  iteration's vector, ``nn.py:236``);
* ``LayerNorm``, ``InstanceNorm``: params ``gamma``, ``beta`` (no state);
* parameters a module holds itself (the ViT's and MAE's ``cls_token``
  and ``pos_embed``, MAE's ``decoder/mask_token`` and
  ``decoder/pos_embed``, a Swin block's ``attn/rel_bias`` table) sit in
  that module's scope, ``~`` for the root module as in the JAX tree
  (``core/module.py:133-147``).

:func:`load_jax_checkpoint` reads the ``.npz`` the JAX trainer writes
(``ckpt/checkpoint.py``): keys ``params::<scope>::<name>`` and
``model_state::<scope>::<name>``, or any other pair of trees (a
distillation checkpoint's teacher and student, a FixMatch checkpoint's
EMA).  An ``embedding_net`` carries JAX's scopes: the backbone's under
``backbone/``, the margin head's class weights as ``margin_head/w``
(``[D, C]``, a parameter of its own).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.ckpt.checkpoint import SEP, latest_checkpoint
from myconvnet_tpu_torch.nn import (BatchNorm, Conv, ConvTranspose, Dense,
                                   DepthwiseConv, InstanceNorm, LayerNorm)

Tree = dict[str, dict[str, np.ndarray]]
ROOT = "~"  # the JAX tree's scope of the root module's own parameters
LAYERS = (Conv, ConvTranspose, BatchNorm, Dense, LayerNorm, InstanceNorm)
NORMS = (LayerNorm, InstanceNorm)   # gamma and beta, no state


def _scope(path: str) -> str:
    return path.replace(".", "/") or ROOT


def _layers(model: nn.Module):
    for path, m in model.named_modules():
        if isinstance(m, LAYERS):
            yield _scope(path), m


def _own_params(model: nn.Module):
    """(scope, name, parameter) of parameters held by modules that are
    not layers (the ViT's embedding tokens)."""
    for path, m in model.named_modules():
        if not isinstance(m, LAYERS):
            for name, p in m.named_parameters(recurse=False):
                yield _scope(path), name, p


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _hwio(t: torch.Tensor) -> torch.Tensor:
    return t.permute(2, 3, 1, 0)


def _transpose(t: torch.Tensor) -> torch.Tensor:
    return t.t()


def _iohw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(2, 3, 0, 1)


def _depthwise(groups: int):
    def view(t: torch.Tensor) -> torch.Tensor:
        kh, kw = t.shape[2:]
        return _hwio(t).view(kh, kw, groups, t.shape[0] // groups)
    return view


def _weight_view(m: nn.Module):
    """The view of a layer's weight in the JAX layout."""
    if isinstance(m, DepthwiseConv):
        return _depthwise(m.groups)
    if isinstance(m, Conv):
        return _hwio
    return _iohw if isinstance(m, ConvTranspose) else _transpose


def param_views(model: nn.Module):
    """(JAX path ``scope/name``, parameter, view) for every parameter,
    where ``view(t)`` shows a tensor of the parameter's shape in the JAX
    layout (HWIO for a conv weight, plain or transposed, [in, out] for a
    dense weight).  The optimizer's state goes through the same views."""
    for scope, name, p in _own_params(model):
        yield f"{scope}/{name}", p, _same
    for scope, m in _layers(model):
        if isinstance(m, (BatchNorm, *NORMS)):
            if not getattr(m, "folded", False):
                yield f"{scope}/gamma", m.gamma, _same
                yield f"{scope}/beta", m.beta, _same
            continue
        yield f"{scope}/w", m.weight, _weight_view(m)
        if m.bias is not None:
            yield f"{scope}/b", m.bias, _same


def _set(param: torch.Tensor, value: np.ndarray, scope: str, name: str):
    if tuple(param.shape) != tuple(np.shape(value)):
        raise ValueError(f"{scope}:{name}: shape {np.shape(value)} does "
                         f"not fit {tuple(param.shape)}")
    param.copy_(torch.as_tensor(np.array(value, np.float32)))


def _new_param(value: np.ndarray, like: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.array(value, np.float32)).to(
        device=like.device, dtype=like.dtype))


@torch.no_grad()
def from_jax(model: nn.Module, params: Tree, state: Tree) -> nn.Module:
    """Load JAX-layout trees into ``model`` in place; every scope of the
    trees must land on a module and every module must be covered."""
    used = set()
    for scope, name, param in _own_params(model):
        if name not in params.get(scope, {}):
            raise KeyError(f"no parameter {scope}/{name}")
        _set(param, params[scope][name], scope, name)
        used.add(scope)
    for scope, m in _layers(model):
        p = params.get(scope)
        if p is None and not isinstance(m, BatchNorm):
            raise KeyError(f"no parameters for {scope}")
        if isinstance(m, NORMS):
            _set(m.gamma, p["gamma"], scope, "gamma")
            _set(m.beta, p["beta"], scope, "beta")
            used.add(scope)
            continue
        if isinstance(m, BatchNorm):
            if p is None:
                m.mark_folded()
                continue
            s = state[scope]
            if m.folded:
                raise ValueError(f"{scope}: module already folded")
            _set(m.gamma, p["gamma"], scope, "gamma")
            _set(m.beta, p["beta"], scope, "beta")
            _set(m.moving_mean, s["moving_mean"], scope, "moving_mean")
            _set(m.moving_var, s["moving_var"], scope, "moving_var")
            used.add(scope)
            continue
        if getattr(m, "spectral_norm", False):
            if "sn_u" not in state.get(scope, {}):
                raise KeyError(f"no state {scope}/sn_u")
            _set(m.sn_u, state[scope]["sn_u"], scope, "sn_u")
        if isinstance(m, Conv):
            _set(m.w, p["w"], scope, "w")
            if "b" not in p:
                m.bias = None
            elif m.bias is None:  # a folded BN's bias
                m.bias = _new_param(p["b"], m.weight)
            else:  # in place: an optimizer may hold the parameter
                _set(m.bias, p["b"], scope, "b")
        else:
            _set(m.w if isinstance(m, ConvTranspose) else m.weight,
                 np.asarray(p["w"]) if isinstance(m, ConvTranspose)
                 else np.asarray(p["w"]).T, scope, "w")
            if (m.bias is None) != ("b" not in p):
                raise KeyError(f"{scope}: the tree's bias does not fit the "
                               f"layer's (use_bias={m.bias is not None})")
            if m.bias is not None:
                _set(m.bias, p["b"], scope, "b")
        used.add(scope)
    extra = (set(params) | set(state)) - used
    if extra:
        raise KeyError(f"scopes with no module: {sorted(extra)[:5]}")
    return model


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def to_jax(model: nn.Module) -> tuple[Tree, Tree]:
    """The inverse of :func:`from_jax`: float32 numpy trees."""
    params, state = {}, {}
    for scope, name, p in _own_params(model):
        params.setdefault(scope, {})[name] = _np(p)
    for scope, m in _layers(model):
        if isinstance(m, NORMS):
            params[scope] = {"gamma": _np(m.gamma), "beta": _np(m.beta)}
        elif isinstance(m, BatchNorm):
            if m.folded:
                continue
            params[scope] = {"gamma": _np(m.gamma), "beta": _np(m.beta)}
            state[scope] = {"moving_mean": _np(m.moving_mean),
                            "moving_var": _np(m.moving_var)}
        else:
            params[scope] = {"w": _np(m.w) if isinstance(
                m, (Conv, ConvTranspose)) else _np(m.weight).T.copy()}
            if m.bias is not None:
                params[scope]["b"] = _np(m.bias)
            if getattr(m, "spectral_norm", False):
                state[scope] = {"sn_u": _np(m.sn_u)}
    return params, state


def _field_tree(root: dict, field: str, create: bool):
    """The dict at ``field`` (``::``-joined JAX field names; "" is
    ``root``) and the last field name, or (None, name) when absent."""
    parts = field.split(SEP) if field else []
    tree = root
    for part in parts[:-1]:
        if part not in tree:
            if not create:
                return None, parts[-1]
            tree[part] = {}
        tree = tree[part]
    return tree, (parts[-1] if parts else "")


def optimizer_to_jax(model: nn.Module, optimizer) -> dict:
    """``optimizer``'s state over ``model``'s parameters as the JAX
    optimizer state tree: the ``state_trees`` fields nested by their
    ``::``-joined JAX names (the momentum tree at the root, Adam's
    ``.mu``/``.nu``, a wrapper's ``.inner``, ``.ema``, ``.slow``), each a
    tree laid out as the parameters, a tensor in its own dtype (the
    scalars ``.count`` and ``.lr_scale``, blocked Shampoo's stacked
    tiles) or a list of per-leaf arrays in JAX's leaf order (Shampoo's
    statistics and momentum), keyed by position as JAX's checkpoints key
    a tuple's entries, a ``None`` entry left out."""
    out = {}
    views = list(param_views(model))
    for field, value in optimizer.state_trees().items():
        parent, name = _field_tree(out, field, create=True)
        if isinstance(value, torch.Tensor):
            parent[name] = value.detach().cpu().numpy().copy()
            continue
        if isinstance(value, list):
            parent[name] = {str(i): _np(t) for i, t in enumerate(value)
                            if t is not None}
            continue
        tree = parent.setdefault(name, {}) if name else parent
        for path, _, view in views:
            if path in value:
                scope, pname = path.rsplit("/", 1)
                tree.setdefault(scope, {})[pname] = _np(view(value[path]))
    return out


@torch.no_grad()
def optimizer_from_jax(model: nn.Module, optimizer, opt_state: dict
                       ) -> None:
    """Load a JAX optimizer state tree (:func:`optimizer_to_jax`'s
    layout) into ``optimizer``."""
    trees = {}
    for field, value in optimizer.state_trees().items():
        parent, name = _field_tree(opt_state, field, create=False)
        if parent is None:
            continue
        if isinstance(value, torch.Tensor):
            if name in parent:
                trees[field] = torch.from_numpy(np.array(parent[name]))
            continue
        if isinstance(value, list):
            sub = parent.get(name, {})
            trees[field] = [
                torch.from_numpy(np.array(sub[str(i)], np.float32))
                if str(i) in sub else None for i in range(len(value))]
            continue
        tree = parent.get(name, {}) if name else parent
        buffers = {}
        for path, p, view in param_views(model):
            scope, pname = path.rsplit("/", 1)
            arr = tree.get(scope, {}).get(pname)
            if arr is not None:
                buf = torch.empty_like(p)
                view(buf).copy_(torch.from_numpy(np.array(arr, np.float32)))
                buffers[path] = buf
        trees[field] = buffers
    optimizer.load_state_trees(trees)


def load_jax_checkpoint(path: str, fields=("params", "model_state")
                        ) -> tuple[Tree, Tree]:
    """(params, model_state) from a JAX ``.npz`` checkpoint, or from the
    newest ``ckpt-<step>.npz`` when ``path`` is a directory; ``fields``
    names the two trees (a GAN checkpoint's generator: ``("g_params",
    "g_state")``; a distillation checkpoint's teacher ``("teacher_params",
    "teacher_state")`` or student ``("student::.params",
    "student::.model_state")``, a NamedTuple field in JAX's key path; a
    FixMatch checkpoint's EMA ``("ema_params", "ema_model_state")``)."""
    if os.path.isdir(path):
        found = latest_checkpoint(path)
        if found is None:
            raise FileNotFoundError(f"no ckpt-<step>.npz in {path!r}")
        path = found
    trees = {f: {} for f in fields}
    with np.load(path) as data:
        for key in data.files:
            field, _, rest = key.rpartition(SEP)
            field, _, scope = field.rpartition(SEP)
            if field in trees and scope:
                trees[field].setdefault(scope, {})[rest] = data[key]
    if not trees[fields[0]]:
        raise ValueError(f"{path!r} holds no {fields[0]}::<scope>::<name> "
                         "keys")
    return trees[fields[0]], trees[fields[1]]


def random_jax_params(model: nn.Module, seed: int) -> tuple[Tree, Tree]:
    """JAX-layout trees of random weights for ``model``'s shapes, made
    from ``seed`` with numpy: He-normal convs, Glorot-uniform dense,
    BN with random gamma, beta and moving statistics (a block's last BN,
    ``bn_c`` of a bottleneck, ``bn_b`` of a basic block or ``bn_project``
    of an inverted residual, gets a small gamma, as the zero-init recipe
    intends, so the residual stream stays in range through 16 blocks; the
last BN of each of Xception's residual blocks, ``sep3/bn_pw``, one in
[0.01, 0.03], so it does through 20, train-mode BN included), LN
    with gamma near 1 and a small beta, the ViT's tokens from
    normal(0.02) and a 0-d scale in [0.8, 1.2].  A depthwise conv's He scale counts its window only
    (one input channel an output)."""
    rng = np.random.RandomState(seed)
    params, state = to_jax(model)
    layers = dict(_layers(model))
    for scope in sorted(params):
        p = params[scope]
        m = layers.get(scope)
        if m is None:  # a module's own parameters
            for name in sorted(p):
                if p[name].ndim == 0:   # a learnable scale (FCOS's)
                    p[name] = np.float32(rng.uniform(0.8, 1.2))
                    continue
                p[name] = (0.02 * rng.randn(*p[name].shape)).astype(
                    np.float32)
        elif isinstance(m, NORMS):
            c = p["gamma"].shape[0]
            p["gamma"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            p["beta"] = (0.05 * rng.randn(c)).astype(np.float32)
        elif isinstance(m, BatchNorm):
            c = p["gamma"].shape[0]
            last = scope.endswith(("bn_c", "bn_project")) or (
                scope.endswith("bn_b") and scope[:-1] + "c" not in params)
            lo, hi = (0.1, 0.3) if last else (0.5, 1.0)
            if scope.endswith("sep3/bn_pw") and "exit2/" not in scope:
                lo, hi = 0.01, 0.03    # Xception's 20 residual branches
            p["gamma"] = rng.uniform(lo, hi, c).astype(np.float32)
            p["beta"] = (0.1 * rng.randn(c)).astype(np.float32)
            state[scope] = {
                "moving_mean": (0.1 * rng.randn(c)).astype(np.float32),
                "moving_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
        elif p["w"].ndim == 4:
            kh, kw, cin, _ = p["w"].shape
            if isinstance(m, DepthwiseConv):
                cin = 1
            std = np.sqrt(2.0 / (kh * kw * cin))
            p["w"] = (std * rng.randn(*p["w"].shape)).astype(np.float32)
        else:
            cin, cout = p["w"].shape
            lim = np.sqrt(6.0 / (cin + cout))
            p["w"] = rng.uniform(-lim, lim, (cin, cout)).astype(np.float32)
            if "b" in p:
                p["b"] = np.zeros(cout, np.float32)
    return params, state
