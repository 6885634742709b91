from myconvnet_tpu_torch.models.resnet import (ResNet, resnet18, resnet34,
                                               resnet50)

MODELS = {"resnet18": resnet18, "resnet34": resnet34, "resnet50": resnet50}


def get_model(name: str, num_classes: int, **kwargs) -> ResNet:
    if name not in MODELS:
        raise ValueError(f"the port has models {sorted(MODELS)}, not "
                         f"{name!r}")
    return MODELS[name](num_classes, **kwargs)


__all__ = ["MODELS", "ResNet", "get_model", "resnet18", "resnet34",
           "resnet50"]
