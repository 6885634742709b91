"""PyTorch/CUDA port of ``myconvnet_tpu`` for one NVIDIA H100.

The JAX package beside this one is the reference; module paths here mirror
its paths where that helps a reader find the counterpart
(``myconvnet_tpu/serving.py`` -> ``myconvnet_tpu_torch/serving.py``).
This package imports ``torch`` and ``numpy``, never ``jax``.

Slice 1 covers the eval/serving path of the ResNet-50 recipe
(``configs/imagenet_resnet50.py``), slice 2 the training and evaluation
path of the CIFAR-100 ResNet-18 recipe (``configs/cifar100_resnet18.py``,
``python -m myconvnet_tpu_torch.train`` and ``.test``); later slices add
the ViT-B/16 recipe with its RandAugment and AutoAugment policies, the
optical-flow recipes (PWC-Net, FlowNetC, FlowNetS) and the BASELINE
configs, the GANs (``python -m myconvnet_tpu_torch.generate`` writes
their samples), then the JAX package's public model API,
``from myconvnet_tpu_torch import ConvNet`` (``models/base.py``), which
the train and test entry points drive: NHWC activations,
cuDNN convolutions, and hand-written CUDA kernels (``ops/kernels``) where
the JAX package has Pallas kernels for the same math.
"""


def __getattr__(name):
    # the public model API, imported on first use as the JAX package's
    # lazy ``myconvnet_tpu.ConvNet``
    if name == "ConvNet":
        from myconvnet_tpu_torch.models.base import ConvNet
        return ConvNet
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
