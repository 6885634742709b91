"""Frozen inference functions, exported artifacts, request bucketing and
latency percentiles.

Port of ``myconvnet_tpu/serving.py``: ``make_inference_fn`` (``:58-93``),
the exporters ``export_inference`` (``:96``), ``export_fn`` (``:131``),
``export_segmentation`` (``:220``) and ``export_image_to_image``
(``:377``), ``load_inference`` (``:430``), ``make_batched_server``
(``:447-485``) and ``measure_latency`` (``:488-521``).  Where the JAX
package closes a jitted function over folded weights, the port loads the
weights into the module, folds BN in place (each BN with its own eps, so
``resolve_bn_eps``'s guess has no counterpart), moves it to the device and
casts convs and dense layers to the policy's compute dtype once;
``make_inference_fn`` then runs the eval forward eagerly.

An artifact is one ``torch.export.save`` file of that same program
(``fn.program``), traced by ``torch.export`` (non-strict, under
``torch.no_grad``) on the device it will run on: the weights travel in the
file, and the hand-written kernels of the path stay in the graph as the
``mcn::`` custom ops (``ops/kernels/_ops.py``).  ``extra_files`` carries
:data:`META` (JSON): the kind, the wire format, the input shape and dtype,
the device type, the policy and the ``mcn::`` nodes of the graph.  The
model sites choose their kernels in Python while tracing, by the
activations' device and dtype, so an artifact is bound to the device type
it was exported on, as JAX's StableHLO is bound to its platform:
:func:`load_inference` refuses another.  Each kind speaks the wire format
of JAX's artifact of the same kind: classify takes normalized rows and
returns float32 logits; segment takes raw [0, 1] frames (the recipe's
mean and std applied inside) and returns (classes int32, max softmax
float32); translate takes [0, 1] images and returns [0, 1] images,
clipped; sample takes [N, latent] latents and returns [0, 1] images; flow
takes raw [0, 1] frame pairs [N, H, W, 6] and returns float32 [N, H, W,
2]; embed (a metric recipe's eval forward) takes normalized rows and
returns the unit-norm float32 embeddings; depth takes raw [0, 1] frames
and returns metres [N, H, W] float32 (:func:`depth_map`); detect takes raw
[0, 1] frames (the recipe's mean and std applied inside) and returns
(boxes, scores, labels, valid) padded to ``max_detections`` rows, its NMS
the fixed-trip form (``recipes_detection.make_detector_inference``).  The
in-memory routes (``serving_http``) run the same programs:
:func:`segment_program`, :func:`image_to_image_program`,
:func:`depth_map` and :func:`normalizer` are theirs too.

:func:`load_inference` imports ``torch`` and ``ops.kernels`` (which
registers the ops) and nothing of ``models``: an artifact runs without
the model code.
"""

from __future__ import annotations

import json
import os
import time
import warnings
import zipfile

import numpy as np
import torch
from torch import nn

from myconvnet_tpu_torch.core.precision import (BF16, Policy,
                                                apply_backend_flags,
                                                get_policy)

# the artifact's metadata: a JSON file in torch.export.save's extra_files
META = "mcn_artifact.json"
FORMAT = "myconvnet_tpu_torch.export/1"
# the wire format of each kind (JAX's artifact of the same kind speaks it)
WIRE = {"classify": "normalized float32 [N, H, W, C] -> float32 logits",
        "segment": "raw [0, 1] float32 [N, H, W, 3] -> (classes int32 "
                   "[N, H, W], max softmax float32 [N, H, W])",
        "translate": "[0, 1] float32 [N, H, W, 3] -> [0, 1] float32 "
                     "images, clipped",
        "sample": "float32 latents [N, D] -> [0, 1] float32 images, "
                  "clipped",
        "flow": "raw [0, 1] float32 frame pairs [N, H, W, 6] -> float32 "
                "flow [N, H, W, 2]",
        "embed": "normalized float32 [N, H, W, C] -> unit-norm float32 "
                 "embeddings [N, D]",
        "depth": "raw [0, 1] float32 [N, H, W, 3] -> metric depth float32 "
                 "[N, H, W]",
        "detect": "raw [0, 1] float32 [N, H, W, 3] -> (boxes float32 [N, D, "
                  "4] normalized xyxy, scores float32 [N, D], labels int32 "
                  "[N, D], valid bool [N, D])"}


def _prepare(model: nn.Module, params, state, fold_bn: bool,
             device: torch.device, policy: Policy) -> nn.Module:
    from myconvnet_tpu_torch.models.folding import fold_batch_norms
    from myconvnet_tpu_torch.nn import Conv, Dense
    from myconvnet_tpu_torch.weights import from_jax

    if params is not None:
        from_jax(model, params, state)
    if fold_bn:
        fold_batch_norms(model)
    model.eval().to(device)
    for m in model.modules():
        if isinstance(m, (Conv, Dense)):
            m.to(policy.compute_dtype)
    apply_backend_flags(policy)
    return model


def make_inference_fn(model: nn.Module, params, state, *,
                      fold_bn: bool = True,
                      device: str | torch.device = "cuda",
                      policy: Policy = BF16):
    """Return ``fn(x) -> logits`` for ``x`` [B, H, W, C] (numpy or tensor,
    already normalized); logits are a float32 tensor on ``device``.
    ``params``/``state`` are JAX-layout trees (None: the module's own
    weights, as a restored net holds them); with ``fold_bn`` each BN is
    folded into its conv with its own eps, in place.  ``fn.model`` is the prepared
    module, ``fn.program`` the function an artifact exports: rows on the
    device -> the policy's compute dtype -> the eval forward -> float32."""
    device = torch.device(device)
    model = _prepare(model, params, state, fold_bn, device, policy)

    def program(x):
        return model(x.to(policy.compute_dtype)).float()

    @torch.inference_mode()
    def fn(x):
        return program(torch.as_tensor(x).to(device=device,
                                             dtype=policy.compute_dtype))

    fn.model = model
    fn.program = program
    fn.policy = policy
    return fn


def normalizer(mean, std, device):
    """``x -> (x - mean) / std`` with float32 per-channel statistics on
    ``device`` (the segment and translate routes' step before the
    forward, and their artifacts' first)."""
    from myconvnet_tpu_torch.ops.kernels.normalize_u8 import device_stats
    m, s = device_stats(mean, std, device)
    return lambda x: (x - m) / s


def segment_program(fn, hw):
    """normalized frames -> (classes int32 [N, H, W], max softmax float32
    [N, H, W]), the logits upsampled to ``hw`` where they are not at it
    (``serving.py:262-270``)."""
    from myconvnet_tpu_torch.ops.resize import resize_bilinear

    def segment(x):
        logits = fn(x)
        if tuple(logits.shape[1:3]) != tuple(hw):
            logits = resize_bilinear(logits, tuple(hw), align_corners=False)
        probs = torch.softmax(logits, -1)
        return logits.argmax(-1).to(torch.int32), probs.amax(-1)
    return segment


def depth_map(d: torch.Tensor) -> torch.Tensor:
    """A depth model's [N, H, W, 1] output -> [N, H, W] float32 metres
    (``export_cli.py:399-400``)."""
    return d[..., 0].float()


def from_tanh(y):
    """A tanh generator's [-1, 1] output -> [0, 1]."""
    return (y + 1.0) / 2.0


def image_to_image_program(fn, pre=None, post=None):
    """``clip(post(fn(pre(x))), 0, 1)`` in float32 (``serving.py:414-
    419``)."""
    def chain(x):
        y = fn(pre(x) if pre is not None else x).float()
        if post is not None:
            y = post(y)
        return y.clamp(0.0, 1.0)
    return chain


def _policy_name(policy: Policy) -> str:
    return "bf16" if policy.compute_dtype == torch.bfloat16 else "f32"


class Program(nn.Module):
    """The root module an artifact exports: ``fn`` over ``model``'s
    weights (registered here, so the export lifts them)."""

    def __init__(self, fn, model: nn.Module):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _drop_identities(program) -> int:
    """Remove the exported graph's nodes that do nothing at run time: the
    tracer's ``_assert_tensor_metadata`` checks (one each ``.to()`` of the
    traced code; the program's input guards already hold the input's
    metadata, and every tensor inside follows from it) and ``.to(dtype)``
    to the dtype and device a tensor already has (an alias in eager mode).
    Each is a Python-level op call a run: 187 of a ResNet-50 graph's 507
    nodes, a quarter of its host time.  Returns the nodes removed."""
    graph = program.graph
    removed = 0
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target == torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
            removed += 1
        elif (node.target == torch.ops.aten.to.dtype
              and not node.kwargs.get("copy", False)
              and len(node.args) <= 2
              # an output keeps its node: the signature names it
              and all(u.op != "output" for u in node.users)):
            src, out = node.args[0].meta["val"], node.meta["val"]
            if (src.dtype, src.device) == (out.dtype, out.device):
                node.replace_all_uses_with(node.args[0])
                graph.erase_node(node)
                removed += 1
    graph.lint()
    program.graph_module.recompile()
    return removed


def export_fn(fn, model: nn.Module, sample_input, path: str, *, kind: str,
              policy: Policy, device: str | torch.device = "cuda") -> int:
    """Export ``fn`` (one float32 tensor on ``device`` in, a tensor or a
    tuple of tensors out), which closes over ``model``'s weights, at
    ``sample_input``'s shape to ``path``; returns the file's bytes.  The
    generic core under the task exporters (flow's chain goes straight
    here)."""
    from myconvnet_tpu_torch.ops.kernels import _ops

    if kind not in WIRE:
        raise ValueError(f"artifact kinds are {sorted(WIRE)}, not {kind!r}")
    device = torch.device(device)
    sample = torch.as_tensor(sample_input).to(device=device,
                                              dtype=torch.float32)
    with torch.no_grad():
        program = torch.export.export(Program(fn, model), (sample,),
                                      strict=False)
    _drop_identities(program)
    meta = dict(format=FORMAT, kind=kind, wire=WIRE[kind],
                input_shape=list(sample.shape), input_dtype="float32",
                device=device.type, policy=_policy_name(policy),
                ops=dict(sorted(_ops.op_nodes(program.graph).items())))
    with warnings.catch_warnings():
        # torch's writer warns of every weight that is not a contiguous
        # view of its whole storage (a channels_last conv weight is one);
        # it then writes that whole storage, which is right for these
        warnings.filterwarnings("ignore", "No complete tensor found")
        torch.export.save(program, path,
                          extra_files={META: json.dumps(meta)})
    return os.path.getsize(path)


def export_inference(model: nn.Module, params, state, sample_input,
                     path: str, *, fold_bn: bool = True,
                     device: str | torch.device = "cuda",
                     policy: Policy = BF16) -> int:
    """Export the classify program (:func:`make_inference_fn`'s) to
    ``path``: normalized rows in, float32 logits out."""
    fn = make_inference_fn(model, params, state, fold_bn=fold_bn,
                           device=device, policy=policy)
    return export_fn(fn.program, fn.model, sample_input, path,
                     kind="classify", policy=policy, device=device)


def export_segmentation(model: nn.Module, params, state, sample_images,
                        path: str, *, mean=(0.485, 0.456, 0.406),
                        std=(0.229, 0.224, 0.225), fold_bn: bool = True,
                        device: str | torch.device = "cuda",
                        policy: Policy = BF16) -> int:
    """Export the segment program to ``path``: raw [0, 1] frames, the
    recipe's ``mean``/``std`` applied inside, the forward, the logits
    upsampled to the input size, (argmax classes int32, max softmax
    float32)."""
    fn = make_inference_fn(model, params, state, fold_bn=fold_bn,
                           device=device, policy=policy)
    seg = segment_program(fn.program, tuple(np.shape(sample_images)[1:3]))
    norm = normalizer(mean, std, device)
    return export_fn(lambda x: seg(norm(x)), fn.model, sample_images, path,
                     kind="segment", policy=policy, device=device)


def export_image_to_image(model: nn.Module, params, state, sample_input,
                          path: str, *, pre=None, post=None,
                          fold_bn: bool = True, kind: str = "translate",
                          device: str | torch.device = "cuda",
                          policy: Policy = BF16) -> int:
    """Export ``clip(post(model(pre(x))), 0, 1)`` to ``path``
    (:func:`image_to_image_program`): ``pre`` maps the wire format into
    the model's input space, ``post`` its output back to [0, 1].  ``kind``
    "translate" (images in) or "sample" (latents in)."""
    fn = make_inference_fn(model, params, state, fold_bn=fold_bn,
                           device=device, policy=policy)
    return export_fn(image_to_image_program(fn.program, pre, post),
                     fn.model, sample_input, path, kind=kind,
                     policy=policy, device=device)


def is_artifact(path: str) -> bool:
    """Whether ``path`` is a file holding an artifact's :data:`META`."""
    if not os.path.isfile(path) or not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.endswith("/extra/" + META) for n in z.namelist())


def artifact_meta(path: str) -> dict:
    """The :data:`META` record of an artifact, read without loading it."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith("/extra/" + META)]
        if len(names) != 1:
            raise ValueError(f"{path} is not an artifact of this package "
                             f"(no {META})")
        meta = json.loads(z.read(names[0]))
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: artifact format {meta.get('format')!r}, "
                         f"this package reads {FORMAT!r}")
    return meta


def load_inference(path: str, device: str | torch.device | None = None):
    """Load an artifact; returns ``fn(x)`` (numpy or tensor rows, moved to
    the device as float32) with the artifact's input shape as
    ``fn.input_shapes`` (one fixed shape: callers pad and chunk to it),
    its metadata as ``fn.meta`` and the device as ``fn.device``.  The
    device defaults to the one the artifact was exported for; another
    device type raises, as does a CUDA artifact without CUDA."""
    import myconvnet_tpu_torch.ops.kernels  # noqa: F401  the mcn:: ops

    meta = artifact_meta(path)
    device = torch.device(meta["device"] if device is None else device)
    if device.type != meta["device"]:
        raise ValueError(
            f"{path} was exported for {meta['device']}, not "
            f"{device.type}: its graph holds the kernels and weights of "
            f"that device; export it again with --device {device.type}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{path} runs on CUDA, which is not available")
    module = torch.export.load(path).module()
    apply_backend_flags(get_policy(meta["policy"]))

    @torch.inference_mode()
    def fn(x):
        return module(torch.as_tensor(x).to(device=device,
                                            dtype=torch.float32))

    fn.input_shapes = (tuple(meta["input_shape"]),)
    fn.meta = meta
    fn.device = device
    return fn


def make_batched_server(fn, batch_sizes=(1, 8, 32, 128)):
    """Serve any request size on a fixed set of batch shapes: a request
    goes to the smallest bucket >= n, padded with zeros and sliced back;
    larger requests are chunked through the biggest bucket.  Fixed shapes
    keep the kernels' launch shapes to a known set.  A tuple output (the
    segment program's) is sliced and joined member by member."""
    buckets = sorted(set(int(b) for b in batch_sizes))
    if not buckets or buckets[0] < 1:
        raise ValueError(f"bad batch_sizes {batch_sizes!r}")

    def _run_padded(x, bucket):
        n = x.shape[0]
        if n < bucket:
            pad = torch.zeros((bucket - n, *x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            out = fn(torch.cat([x, pad]))
            return (tuple(t[:n] for t in out) if isinstance(out, tuple)
                    else out[:n])
        return fn(x)

    def serve(x):
        x = torch.as_tensor(x)
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty batch")
        for b in buckets:
            if n <= b:
                return _run_padded(x, b)
        big = buckets[-1]
        outs = [_run_padded(x[i:i + big], big) for i in range(0, n, big)]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(ts) for ts in zip(*outs))
        return torch.cat(outs)

    return serve


def measure_latency(serve, sample_shape, *, request_sizes=(1, 4, 16, 64),
                    iters: int = 50, warmup: int = 5) -> dict:
    """Per-request latency percentiles of a serve fn.  Each request ends
    in a read of the result (every member of a tuple) to the host, so a
    number covers host -> device -> result readback, as in the JAX
    version.

    Returns {size: {"p50": ms, ..., "mean": ms, "qps": requests/s,
    "images_per_sec": n * qps}}.
    """
    def read(out):
        return sum(float(t.float().sum()) for t in (
            out if isinstance(out, tuple) else (out,)))

    results = {}
    rs = np.random.RandomState(0)
    for n in request_sizes:
        x = rs.standard_normal((n, *sample_shape)).astype(np.float32)
        for _ in range(warmup):
            read(serve(x))
        times = []
        for i in range(iters):
            # evolve the payload so no layer can replay a cached result
            x_i = x + np.float32(i * 1e-6)
            t0 = time.perf_counter()
            read(serve(x_i))
            times.append(time.perf_counter() - t0)
        arr = np.asarray(times) * 1e3
        row = {f"p{p}": float(np.percentile(arr, p)) for p in (50, 95, 99)}
        row["mean"] = float(arr.mean())
        row["qps"] = float(1e3 / arr.mean())
        row["images_per_sec"] = float(n * 1e3 / arr.mean())
        results[int(n)] = row
    return results
