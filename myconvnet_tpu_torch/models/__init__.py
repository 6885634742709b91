from torch import nn

from myconvnet_tpu_torch.models.flow import (FLOW_MODELS, flownet_c,
                                             flownet_s, pwcnet, tinyflow,
                                             tinypwc)
from myconvnet_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                               resnet50)
from myconvnet_tpu_torch.models.vit import (VARIANTS, ViT, tinyvit, vit,
                                            vit_b16, vit_b32, vit_l16,
                                            vit_s16, vit_ti16)

VITS = {"vit_ti16": vit_ti16, "vit_s16": vit_s16, "vit_b16": vit_b16,
        "vit_b32": vit_b32, "vit_l16": vit_l16, "tinyvit": tinyvit}
MODELS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
          **VITS, **FLOW_MODELS}


def get_model(name: str, num_classes: int,
              input_hw: tuple[int, int] | None = None, **kwargs
              ) -> nn.Module:
    """The recipe's model; a ViT also takes the input size its position
    embedding is made for (``input_hw``, as the JAX model reads it from
    the sample input at init)."""
    if name not in MODELS:
        raise ValueError(f"the port has models {sorted(MODELS)}, not "
                         f"{name!r}")
    if name in VITS and input_hw is not None:
        kwargs["input_hw"] = tuple(input_hw)
    return MODELS[name](num_classes, **kwargs)


__all__ = ["FLOW_MODELS", "MODELS", "ResNet", "VARIANTS", "VITS", "ViT",
           "flownet_c", "flownet_s", "get_model", "pwcnet", "resnet18",
           "resnet34", "resnet50", "tinyflow", "tinypwc", "tinyvit", "vit",
           "vit_b16", "vit_b32", "vit_l16", "vit_s16", "vit_ti16"]
