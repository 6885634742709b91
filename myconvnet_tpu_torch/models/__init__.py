from torch import nn

from myconvnet_tpu_torch.models.deeplab import (DeepLabV3Plus,
                                                deeplab_v3_plus)
from myconvnet_tpu_torch.models.densenet import (DenseNet, densenet121,
                                                 densenet169, densenet201)
from myconvnet_tpu_torch.models.gan import (DCGANDiscriminator,
                                           DCGANGenerator,
                                           PatchGANDiscriminator,
                                           UNetGenerator)
from myconvnet_tpu_torch.models.flow import (FLOW_MODELS, flownet_c,
                                             flownet_s, pwcnet, tinyflow,
                                             tinypwc)
from myconvnet_tpu_torch.models.resnet import (ResNet, ResNetBackbone,
                                               resnet18, resnet34, resnet50)
from myconvnet_tpu_torch.models.mae import (MAE, mae_b16, mae_l16, patchify,
                                            tinymae, unpatchify)
from myconvnet_tpu_torch.models.smallnet import SmallNet, smallnet
from myconvnet_tpu_torch.models.swin import (Swin, swin_b, swin_s, swin_t,
                                             tinyswin)
from myconvnet_tpu_torch.models.vgg import VGG, vgg11, vgg16, vgg19
from myconvnet_tpu_torch.models.vit import (VARIANTS, ViT, tinyvit, vit,
                                            vit_b16, vit_b32, vit_l16,
                                            vit_s16, vit_ti16)

VITS = {"vit_ti16": vit_ti16, "vit_s16": vit_s16, "vit_b16": vit_b16,
        "vit_b32": vit_b32, "vit_l16": vit_l16, "tinyvit": tinyvit}
VGGS = {"vgg11": vgg11, "vgg16": vgg16, "vgg19": vgg19}
SWINS = {"swin_t": swin_t, "swin_s": swin_s, "swin_b": swin_b,
         "tinyswin": tinyswin}
# the names of myconvnet_tpu/models/__init__.py:89-129
MODELS = {"smallnet": smallnet,
          "resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
          **VGGS, "densenet121": densenet121, "densenet169": densenet169,
          "densenet201": densenet201, **VITS, **SWINS, **FLOW_MODELS,
          "deeplab_v3_plus": deeplab_v3_plus}
# models made for one input size: a ViT's position embedding, a VGG's
# classic head, DeepLab's dropout mask, a Swin's window masks
SIZED = {*VITS, *VGGS, *SWINS, "deeplab_v3_plus"}
# the self-supervised forwards (models/__init__.py:245-249): not
# classifiers; SimCLR takes any MODELS entry with a ``features`` method
SSL_MODELS = {"mae_b16": mae_b16, "mae_l16": mae_l16, "tinymae": tinymae}


def get_model(name: str, num_classes: int,
              input_hw: tuple[int, int] | None = None, **kwargs
              ) -> nn.Module:
    """The recipe's model; a ViT also takes the input size its position
    embedding is made for, a VGG the one its classic head's ``fc1`` is
    made for, DeepLab the one its train-mode dropout mask is drawn for and
    a Swin the one its window masks are made for (``input_hw``, as the JAX
    model reads it from the sample input at
    init)."""
    if name not in MODELS:
        raise ValueError(f"the port has models {sorted(MODELS)}, not "
                         f"{name!r}")
    if name in SIZED and input_hw is not None:
        kwargs["input_hw"] = tuple(input_hw)
    return MODELS[name](num_classes, **kwargs)


__all__ = ["DCGANDiscriminator", "DCGANGenerator", "DeepLabV3Plus",
           "DenseNet", "FLOW_MODELS", "MAE", "PatchGANDiscriminator",
           "UNetGenerator", "MODELS", "ResNet",
           "ResNetBackbone", "SIZED", "SSL_MODELS", "SWINS", "SmallNet",
           "Swin", "VARIANTS", "VGG", "VGGS", "VITS", "ViT", "mae_b16",
           "mae_l16", "patchify", "swin_b", "swin_s", "swin_t", "tinymae",
           "tinyswin", "unpatchify", "deeplab_v3_plus", "densenet121",
           "densenet169", "densenet201", "flownet_c", "flownet_s", "get_model", "pwcnet",
           "resnet18", "resnet34", "resnet50", "smallnet", "tinyflow",
           "tinypwc", "tinyvit", "vgg11", "vgg16", "vgg19", "vit", "vit_b16",
           "vit_b32", "vit_l16", "vit_s16", "vit_ti16"]
