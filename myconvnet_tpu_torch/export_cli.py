"""``test --export`` implementations: freeze checkpoints as artifacts.

Port of ``myconvnet_tpu/export_cli.py`` for the tasks whose models the
port has: ``export_classification`` (``:14``), ``export_segmentation``
(``:99``), ``export_gan`` (``:161``; DCGAN and pix2pix), ``_dense_chain``
(``:355``), ``export_depth`` (``:386``), ``export_flow`` (``:408``),
``export_metric`` (``:429``) and ``CONVNET_EXPORTERS`` (``:525``)
restricted to them, and the detection export of ``test.py:396-424``
(``serving.export_detection``: the fused normalize -> forward ->
post-process chain, its NMS the fixed-trip form).  Each writes one
``torch.export`` artifact (``serving.export_*``) on the device the entry
point runs on, with the wire format of JAX's artifact of the same kind,
and prints JAX's artifact line and then the artifact's ``mcn::`` kernel
nodes.

A RepVGG recipe (a name of ``models.DEPLOY_FORWARDS``) exports its
reparameterized deploy form (``export_cli.py:34-60``): the restored train
form's branches folded by ``models.repvgg.deploy_params`` into the plain
3x3 stack, whose graph holds ``mcn::conv_fused`` at the stride-1 blocks
on the card and no BN; ``model_kwargs`` other than ``a``, ``b`` and
``stages`` (and the train-only ``dropout_rate``) have no deploy
equivalent and are refused, as in JAX.

Refused by name: ``--int8`` (the quantized programs, ROADMAP A17's
quantization), the GAN kinds the port does not have (srgan, cyclegan) and
the other seven exporters (:data:`UNPORTED_EXPORTERS`), each with its A17
family.
"""

from __future__ import annotations

# task -> (the JAX exporter it would port, its ROADMAP A17 family)
UNPORTED_EXPORTERS = {
    "tracking": ("export_tracking (export_cli.py:75)", "tracking"),
    "sr": ("export_sr (export_cli.py:134)", "style and super-resolution"),
    "diffusion": ("export_diffusion (export_cli.py:241)", "diffusion"),
    "style": ("export_style (export_cli.py:298)",
              "style and super-resolution"),
    "audio": ("export_audio (export_cli.py:328)", "audio"),
    "ocr": ("export_ocr (export_cli.py:466)", "OCR"),
    "video": ("export_video (export_cli.py:493)", "video"),
}


def refuse_unported(cfg, args) -> None:
    """SystemExit for what this port does not export (before any model is
    built): ``--int8``, the unported tasks, a RepVGG whose
    ``model_kwargs`` have no deploy equivalent and the GAN kinds the port
    does not train."""
    if args.int8:
        raise SystemExit("test --export --int8 is not ported: the int8 "
                         "programs (core/quantize.py, ops/quantized.py) "
                         "are ROADMAP A17's quantization; export without "
                         "--int8 for the float program")
    task = cfg.get("task", "classification")
    if task in UNPORTED_EXPORTERS:
        fn, family = UNPORTED_EXPORTERS[task]
        raise SystemExit(f"test --export of a {task} recipe is not ported "
                         f"({fn}, ROADMAP A17's {family} family)")
    if task == "classification":
        _deploy_kwargs(cfg)
    if task == "gan":
        from myconvnet_tpu_torch.recipes_gan import UNPORTED_KINDS
        kind = cfg.get("gan_kind", "dcgan")
        if kind in UNPORTED_KINDS:
            raise SystemExit(f"test --export of a {kind} checkpoint is not "
                             f"ported (its generator, "
                             f"{UNPORTED_KINDS[kind]}, is ROADMAP A17's "
                             "other GAN kinds)")


def _deploy_kwargs(cfg) -> dict | None:
    """A RepVGG recipe's deploy-form keywords (``model_kwargs`` without
    the train-only ``dropout_rate``), None for another model; SystemExit
    for keywords the deploy form does not take (``export_cli.py:44-
    53``)."""
    from myconvnet_tpu_torch.models import DEPLOY_FORWARDS

    if cfg.get("model") not in DEPLOY_FORWARDS:
        return None
    mk = {k: v for k, v in (cfg.get("model_kwargs") or {}).items()
          if k != "dropout_rate"}
    unknown = set(mk) - {"a", "b", "stages"}
    if unknown:
        raise SystemExit(f"model_kwargs {sorted(unknown)} have no deploy-"
                         "forward equivalent; cannot export a matching "
                         "reparameterized artifact")
    return mk


def _report(what, path, size, shape, tail=""):
    from myconvnet_tpu_torch import serving

    print(f"exported {what} artifact: {path} ({size / 1e6:.1f} MB, "
          f"{shape}{tail})", flush=True)
    meta = serving.artifact_meta(path)
    ops = ", ".join(f"mcn::{k} {v}" for k, v in meta["ops"].items())
    print(f"artifact graph: {ops or 'no mcn:: op'} ({meta['device']}, "
          f"{meta['policy']})", flush=True)


def export_classification(cfg, args, net, val_set):
    """Normalized rows [export_batch (8), H, W, 3] at the eval crop
    (``augment.out_hw``, else ``input_hw``) in, float32 logits out."""
    import numpy as np

    from myconvnet_tpu_torch import serving

    hw = tuple((cfg.get("augment") or {}).get(
        "out_hw", cfg.get("input_hw", (224, 224))))
    sample = np.zeros((cfg.get("export_batch", 8), *hw, 3), np.float32)
    mk = _deploy_kwargs(cfg)
    if mk is not None:
        # structural re-parameterization: the folded plain 3x3 stack
        from myconvnet_tpu_torch.models.repvgg import deploy_model
        dep = deploy_model(net.model, cfg["model"], cfg["num_classes"],
                           **mk)
        size = serving.export_inference(dep, None, None, sample,
                                        args.export, fold_bn=False,
                                        device=net.device, policy=net.policy)
        _report("classification", args.export, size,
                f"input {sample.shape}", ", reparameterized")
        return
    size = serving.export_inference(net.model, None, None, sample,
                                    args.export, device=net.device,
                                    policy=net.policy)
    _report("classification", args.export, size, f"input {sample.shape}")


def export_segmentation(cfg, args, net, val_set):
    """Raw [0, 1] frames [export_batch (4), H, W, 3] at the built net's
    crop (a synthetic run's is 96 x 96, as the net is built) in, (classes
    int32, max softmax float32) out; the recipe's mean and std inside."""
    import numpy as np

    from myconvnet_tpu_torch import recipes, serving

    hw = tuple(net.augment.out_hw)
    sample = np.zeros((cfg.get("export_batch", 4), *hw, 3), np.float32)
    mean, std = recipes.normalization(cfg, 3)
    size = serving.export_segmentation(net.model, None, None, sample,
                                       args.export, mean=mean, std=std,
                                       device=net.device, policy=net.policy)
    _report("segmentation", args.export, size, f"input {sample.shape}")


def export_gan(cfg, args, device):
    """The restored (with ``--ema`` the EMA) generator: DCGAN takes
    [export_batch (4), latent] latents, pix2pix [0, 1] images (``x * 2 -
    1`` inside); both give [0, 1] images, clipped."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes_gan, serving
    from myconvnet_tpu_torch.train import optim

    trainer, _ = recipes_gan.build_gan(cfg, args.synthetic, device=device)
    trainer.restore(args.ckpt)
    if args.ema:
        ema = optim.extract_ema(trainer.g_opt)
        with torch.no_grad():
            for path, p in trainer.g_opt.named:
                p.copy_(ema[path].to(p.dtype))
        print("exporting EMA generator", flush=True)
    nb = cfg.get("export_batch", 4)
    common = dict(post=serving.from_tanh, fold_bn=False, device=device,
                  policy=trainer.policy)
    if trainer.kind == "dcgan":
        sample = np.zeros((nb, cfg.get("latent_dim", 100)), np.float32)
        n = serving.export_image_to_image(trainer.generator, None, None,
                                          sample, args.export,
                                          kind="sample", **common)
        _report("dcgan generator", args.export, n, f"latents {sample.shape}")
        return
    size = int(cfg.get("image_size", 256))
    sample = np.zeros((nb, size, size, 3), np.float32)
    n = serving.export_image_to_image(
        trainer.generator, None, None, sample, args.export,
        pre=serving.normalizer(0.5, 0.5, device), kind="translate",
        **common)
    _report(f"{trainer.kind} generator", args.export, n,
            f"input {sample.shape}")


def _dense_chain(net, take):
    """(fn, model): the net's eval forward (the in-memory route's program,
    BN unfolded) post-processed by ``take``."""
    from myconvnet_tpu_torch import serving

    fn = serving.make_inference_fn(net.model, None, None, fold_bn=False,
                                   device=net.device, policy=net.policy)
    return (lambda x: take(fn.program(x))), fn.model


def export_depth(cfg, args, net, val_set):
    """Raw [0, 1] frames [export_batch (4), H, W, 3] in, metric depth [N,
    H, W] float32 out (in the recipe's range by the head's sigmoid)."""
    import numpy as np

    from myconvnet_tpu_torch import serving
    from myconvnet_tpu_torch.subsets import depth as depth_mod

    hw = tuple(cfg.get("input_hw", depth_mod.DEFAULT_HW))
    sample = np.zeros((cfg.get("export_batch", 4), *hw, 3), np.float32)
    fn, model = _dense_chain(net, serving.depth_map)
    size = serving.export_fn(fn, model, sample, args.export, kind="depth",
                             policy=net.policy, device=net.device)
    _report("depth", args.export, size, f"input {sample.shape}",
            ", meters out")


def export_flow(cfg, args, net, val_set):
    """Raw [0, 1] frame pairs [export_batch (4), H, W, 6] in, float32
    flow [N, H, W, 2] in pixels out."""
    import numpy as np

    from myconvnet_tpu_torch import serving
    from myconvnet_tpu_torch.subsets import flow as flow_mod

    hw = tuple(cfg.get("input_hw", flow_mod.DEFAULT_HW))
    sample = np.zeros((cfg.get("export_batch", 4), *hw, 6), np.float32)
    fn, model = _dense_chain(net, lambda f: f.float())
    size = serving.export_fn(fn, model, sample, args.export, kind="flow",
                             policy=net.policy, device=net.device)
    _report("flow", args.export, size, f"input {sample.shape}",
            ", px flow out")


def export_metric(cfg, args, net, val_set):
    """Normalized rows [export_batch (8), H, W, 3] at the eval crop
    (``augment.out_hw``, else ``input_hw``) in, the eval forward's
    unit-norm embeddings [N, D] out (the margin head is train-only); the
    ``embed`` route's producer."""
    import numpy as np

    from myconvnet_tpu_torch import serving

    hw = tuple((cfg.get("augment") or {}).get(
        "out_hw", cfg.get("input_hw", (112, 112))))
    sample = np.zeros((cfg.get("export_batch", 8), *hw, 3), np.float32)
    fn = serving.make_inference_fn(net.model, None, None, device=net.device,
                                   policy=net.policy)
    size = serving.export_fn(fn.program, fn.model, sample, args.export,
                             kind="embed", policy=net.policy,
                             device=net.device)
    dim = cfg.get("model_kwargs", {}).get("embed_dim", 512)
    _report("metric", args.export, size, f"input {sample.shape}",
            f", {dim}-d embeddings")


def export_detection(cfg, args, trainer, device):
    """The restored detector's chain (``recipes_detection.
    make_detector_inference``): raw [0, 1] frames [export_batch (8), H, W,
    3] in, (boxes, scores, labels, valid) with ``max_detections`` rows
    out."""
    import numpy as np

    from myconvnet_tpu_torch import recipes_detection, serving

    chain = recipes_detection.detector_chain(cfg)
    sample = np.zeros((cfg.get("export_batch", 8), *chain.hw, 3),
                      np.float32)
    fn, model = recipes_detection.make_detector_inference(
        cfg, trainer.model, device)
    size = serving.export_fn(fn, model, sample, args.export, kind="detect",
                             policy=trainer.policy, device=device)
    _report("detection", args.export, size, f"input {sample.shape}")


# ConvNet-family exporters keyed by task (GAN checkpoints go to
# export_gan from test.eval_gan, a distilled student to
# export_classification from test.eval_distill)
CONVNET_EXPORTERS = {
    "classification": export_classification,
    "segmentation": export_segmentation,
    "flow": export_flow,
    "metric": export_metric,
    "depth": export_depth,
}
