from myconvnet_tpu_torch.train.cli import main

main()
