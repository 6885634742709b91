# Developer entry points. Tests force the CPU backend with an 8-device
# virtual mesh (tests/conftest.py finishes the setup).

PY ?= python

.PHONY: test test-fast tour bench bench-detection native smoke smoke-torch clean

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -m "not slow"

tour:
	$(PY) examples/library_tour.py

bench:
	$(PY) bench.py

bench-detection:  ## per-architecture detection train-step sweep (TPU)
	$(PY) bench_detection.py

native:
	$(MAKE) -C native

smoke:  ## 50-step CIFAR e2e on synthetic data (CPU-ok)
	$(PY) train.py --config configs/cifar10_smallnet.py --synthetic \
	    --steps 50 --batch 32 --platform cpu --out /tmp/mcn_smoke
	$(PY) test.py --config configs/cifar10_smallnet.py \
	    --ckpt /tmp/mcn_smoke --synthetic --batch 32 --platform cpu

smoke-torch:  ## the same 50-step CIFAR run through the PyTorch port (CPU)
	$(PY) -m myconvnet_tpu_torch.train --config configs/cifar10_smallnet.py \
	    --synthetic --steps 50 --batch 32 --device cpu --out build/smoke_torch
	$(PY) -m myconvnet_tpu_torch.test --config configs/cifar10_smallnet.py \
	    --ckpt build/smoke_torch --synthetic --batch 32 --device cpu

clean:
	rm -rf .pytest_cache
	$(MAKE) -C native clean
