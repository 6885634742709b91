from torch import nn

from myconvnet_tpu_torch.models.densenet import (DenseNet, densenet121,
                                                 densenet169, densenet201)
from myconvnet_tpu_torch.models.flow import (FLOW_MODELS, flownet_c,
                                             flownet_s, pwcnet, tinyflow,
                                             tinypwc)
from myconvnet_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                               resnet50)
from myconvnet_tpu_torch.models.smallnet import SmallNet, smallnet
from myconvnet_tpu_torch.models.vgg import VGG, vgg11, vgg16, vgg19
from myconvnet_tpu_torch.models.vit import (VARIANTS, ViT, tinyvit, vit,
                                            vit_b16, vit_b32, vit_l16,
                                            vit_s16, vit_ti16)

VITS = {"vit_ti16": vit_ti16, "vit_s16": vit_s16, "vit_b16": vit_b16,
        "vit_b32": vit_b32, "vit_l16": vit_l16, "tinyvit": tinyvit}
VGGS = {"vgg11": vgg11, "vgg16": vgg16, "vgg19": vgg19}
# the names of myconvnet_tpu/models/__init__.py:89-99
MODELS = {"smallnet": smallnet,
          "resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
          **VGGS, "densenet121": densenet121, "densenet169": densenet169,
          "densenet201": densenet201, **VITS, **FLOW_MODELS}


def get_model(name: str, num_classes: int,
              input_hw: tuple[int, int] | None = None, **kwargs
              ) -> nn.Module:
    """The recipe's model; a ViT also takes the input size its position
    embedding is made for and a VGG the one its classic head's ``fc1`` is
    made for (``input_hw``, as the JAX model reads it from the sample input
    at init)."""
    if name not in MODELS:
        raise ValueError(f"the port has models {sorted(MODELS)}, not "
                         f"{name!r}")
    if (name in VITS or name in VGGS) and input_hw is not None:
        kwargs["input_hw"] = tuple(input_hw)
    return MODELS[name](num_classes, **kwargs)


__all__ = ["DenseNet", "FLOW_MODELS", "MODELS", "ResNet", "SmallNet",
           "VARIANTS", "VGG", "VGGS", "VITS", "ViT", "densenet121",
           "densenet169", "densenet201", "flownet_c", "flownet_s",
           "get_model", "pwcnet", "resnet18", "resnet34", "resnet50",
           "smallnet", "tinyflow", "tinypwc", "tinyvit", "vgg11", "vgg16",
           "vgg19", "vit", "vit_b16", "vit_b32", "vit_l16", "vit_s16",
           "vit_ti16"]
