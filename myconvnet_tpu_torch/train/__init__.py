"""Training: losses, optimizers, the trainer, and the entry point

    python -m myconvnet_tpu_torch.train --config configs/cifar100_resnet18.py \\
        --synthetic --steps N --out DIR [--device cuda]

(``train/cli.py``; ``main(argv)`` runs it in-process).
"""


def main(argv=None):
    from myconvnet_tpu_torch.train.cli import main as cli_main
    return cli_main(argv)
