from torch import nn

from myconvnet_tpu_torch.models.convnext import (ConvNeXt, convnext_small,
                                                 convnext_tiny)
from myconvnet_tpu_torch.models.deeplab import (DeepLabV3Plus,
                                                deeplab_v3_plus)
from myconvnet_tpu_torch.models.inception import InceptionV3, inception_v3
from myconvnet_tpu_torch.models.pspnet import FCN, PSPNet, fcn, pspnet
from myconvnet_tpu_torch.models.squeezenet import (AlexNet, SqueezeNet,
                                                   alexnet, squeezenet)
from myconvnet_tpu_torch.models.unet import UNet, unet
from myconvnet_tpu_torch.models.xception import (Xception65,
                                                 XceptionBackbone,
                                                 xception65)
from myconvnet_tpu_torch.models.embedding import (EmbeddingNet,
                                                  embedding_net, tinyembed)
from myconvnet_tpu_torch.models.depth import (DEPTH_MODELS, DepthUNet,
                                              TinyDepth, depth_unet,
                                              tinydepth)
from myconvnet_tpu_torch.models.densenet import (DenseNet, densenet121,
                                                 densenet169, densenet201)
from myconvnet_tpu_torch.models.gan import (DCGANDiscriminator,
                                           DCGANGenerator,
                                           PatchGANDiscriminator,
                                           UNetGenerator)
from myconvnet_tpu_torch.models.flow import (FLOW_MODELS, flownet_c,
                                             flownet_s, pwcnet, tinyflow,
                                             tinypwc)
from myconvnet_tpu_torch.models import efficientnet as _effnet
from myconvnet_tpu_torch.models import efficientnetv2 as _effnetv2
from myconvnet_tpu_torch.models import regnet as _regnet
from myconvnet_tpu_torch.models.mobilenet import MobileNetV2, mobilenet_v2
from myconvnet_tpu_torch.models.mobilenetv3 import (MobileNetV3,
                                                    mobilenet_v3_large,
                                                    mobilenet_v3_small)
from myconvnet_tpu_torch.models.repvgg import (DEPLOY_FORWARDS, RepVGG,
                                               RepVGGDeploy, repvgg_a0,
                                               repvgg_a1, tinyrepvgg)
from myconvnet_tpu_torch.models.retinanet import (RetinaNet, TinyRetina,
                                                  retinanet, tinyretina)
from myconvnet_tpu_torch.models.fcos import FCOS, TinyFCOS, fcos, tinyfcos
from myconvnet_tpu_torch.models.faster_rcnn import (FasterRCNN, TinyFRCNN,
                                                    faster_rcnn, tinyfrcnn)
from myconvnet_tpu_torch.models.resnet import (ResNet, ResNetBackbone,
                                               resnet18, resnet34, resnet50,
                                               resnet101, resnet152,
                                               resnext50_32x4d,
                                               resnext101_32x8d,
                                               se_resnet50, se_resnet101,
                                               se_resnext50_32x4d)
from myconvnet_tpu_torch.models.shufflenet import ShuffleNetV2, \
    shufflenet_v2
from myconvnet_tpu_torch.models.wideresnet import (WideResNet, wide_resnet,
                                                   wrn_16_8, wrn_28_10)
from myconvnet_tpu_torch.models.mae import (MAE, mae_b16, mae_l16, patchify,
                                            tinymae, unpatchify)
from myconvnet_tpu_torch.models.smallnet import SmallNet, smallnet
from myconvnet_tpu_torch.models.ssd import SSD, TinyDet, ssd300, ssd512, \
    tinydet
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
WRNS = {"wrn_28_10": wrn_28_10, "wrn_16_8": wrn_16_8,
        "wide_resnet": wide_resnet}
# the grouped and depthwise families (models/__init__.py:92-121)
ZOO = {"resnet101": resnet101, "resnet152": resnet152,
       "se_resnet50": se_resnet50, "se_resnet101": se_resnet101,
       "resnext50_32x4d": resnext50_32x4d,
       "resnext101_32x8d": resnext101_32x8d,
       "se_resnext50_32x4d": se_resnext50_32x4d,
       "mobilenet_v2": mobilenet_v2,
       "mobilenet_v3_large": mobilenet_v3_large,
       "mobilenet_v3_small": mobilenet_v3_small,
       **_effnet.VARIANTS, **_effnetv2.VARIANTS, **WRNS,
       "shufflenet_v2": shufflenet_v2, "repvgg_a0": repvgg_a0,
       "repvgg_a1": repvgg_a1, "tinyrepvgg": tinyrepvgg,
       **_regnet.VARIANTS}
# the rest of the classifier zoo (models/__init__.py:89-127)
ZOO_REST = {"alexnet": alexnet, "inception_v3": inception_v3,
            "squeezenet": squeezenet, "xception65": xception65,
            "convnext_tiny": convnext_tiny,
            "convnext_small": convnext_small}
# the segmenters (models/__init__.py:128-133)
SEGMENTERS = {"deeplab_v3_plus": deeplab_v3_plus, "unet": unet,
              "fcn": fcn, "pspnet": pspnet}
# the names of myconvnet_tpu/models/__init__.py:89-133
MODELS = {"smallnet": smallnet,
          "resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50,
          **VGGS, "densenet121": densenet121, "densenet169": densenet169,
          "densenet201": densenet201, **ZOO, **ZOO_REST, **VITS, **SWINS,
          **FLOW_MODELS, **SEGMENTERS}
# models made for one input size: a ViT's position embedding, a VGG's or
# AlexNet's classic head, the dropout masks of DeepLab, PSPNet, FCN,
# SqueezeNet and a WRN, a Swin's window masks
SIZED = {*VITS, *VGGS, *SWINS, *WRNS, "deeplab_v3_plus", "pspnet", "fcn",
         "alexnet", "squeezenet"}
# the self-supervised forwards (models/__init__.py:245-249): not
# classifiers; SimCLR takes any MODELS entry with a ``features`` method
SSL_MODELS = {"mae_b16": mae_b16, "mae_l16": mae_l16, "tinymae": tinymae}
# the metric-learning embedders (models/__init__.py:181-184): any
# classifier above as the backbone, re-headed to a unit-norm embedding
EMBEDDING_MODELS = {"embedding_net": embedding_net, "tinyembed": tinyembed}
# the detectors (models/__init__.py:134-152): each carries input_hw; the
# anchored one-stage family anchor_spec (RetinaNet's anchor_kind "retina"
# and head "sigmoid_focal"), FCOS point_spec and family "fcos", the
# two-stage family rpn_spec and family "two_stage"
DETECTORS = {"ssd300": ssd300, "ssd512": ssd512, "tinydet": tinydet,
             "retinanet": retinanet, "tinyretina": tinyretina,
             "fcos": fcos, "tinyfcos": tinyfcos,
             "faster_rcnn": faster_rcnn, "tinyfrcnn": tinyfrcnn}
# the JAX detector names the port refuses, with their ROADMAP item
UNPORTED_DETECTORS = dict.fromkeys(
    ("mask_rcnn", "tinymask", "keypoint_rcnn", "tinykp", "panoptic_fpn",
     "tinypan"), "A17c(iii), masks, keypoints and panoptic")


def get_model(name: str, num_classes: int,
              input_hw: tuple[int, int] | None = None, **kwargs
              ) -> nn.Module:
    """The recipe's model; a ViT also takes the input size its position
    embedding is made for, a VGG or AlexNet the one its classic head's
    ``fc1`` is made for, DeepLab, PSPNet, FCN and SqueezeNet the one their
    train-mode dropout masks are drawn for and a Swin the one its window
    masks are made for (``input_hw``, as the JAX model reads it from the
    sample input at init)."""
    if name not in MODELS:
        raise ValueError(f"the port has models {sorted(MODELS)}, not "
                         f"{name!r}")
    if name in SIZED and input_hw is not None:
        kwargs["input_hw"] = tuple(input_hw)
    return MODELS[name](num_classes, **kwargs)


__all__ = ["AlexNet", "ConvNeXt", "EMBEDDING_MODELS", "EmbeddingNet",
           "embedding_net", "tinyembed", "FCN", "InceptionV3", "PSPNet",
           "SEGMENTERS", "SqueezeNet", "UNet", "Xception65",
           "XceptionBackbone", "ZOO_REST", "alexnet", "convnext_small",
           "convnext_tiny", "fcn", "inception_v3", "pspnet", "squeezenet",
           "unet", "xception65", "DEPLOY_FORWARDS", "MobileNetV2", "MobileNetV3", "RepVGG",
           "RepVGGDeploy", "ShuffleNetV2", "WideResNet", "WRNS", "ZOO",
           "DCGANDiscriminator", "DCGANGenerator", "DeepLabV3Plus",
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
