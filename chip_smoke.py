#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Needs CUDA and this checkout; prints the card (nvidia-smi name and
   power limit), the torch and nvcc versions.
2. Builds the hand-written kernels from ``myconvnet_tpu_torch/csrc`` (one
   nvcc per source, all at once) in a background thread and prints the
   build time.  correlation.cu alone takes most of it (~55 s of the
   build on an H100 host, the other sources ~17 s), so meanwhile the
   work that launches none of these kernels runs: the Swin-T phase (24
   below) and step 1 of ResNet-50, VGG-16 and DenseNet-121 (14, 16); the
   script fails if that work loaded the library.
3. Holds each kernel against its plain PyTorch version at every shape the
   main paths give it: the served ResNet-50 (batch 8, 224x224) and the
   CIFAR-100 ResNet-18 recipe (batch 128, 32x32); the input kernels
   (normalize_u8, pad_crop_u8) also at fashion_mnist_smallnet's [128, 28,
   28, 1], with bf16 output, and at [256, 224, 224, 3], each row with its
   plan and the wrapper's host time (normalize_u8's with one
   ``torch.addcmul`` as its library time; pad_crop_u8 at the recipe's
   shape with each staging mode forced).  Max error against the
   stated tolerance, and both device times from CUDA events with the
   stream held (plus cuDNN's unfused bf16 version of conv_pair and
   conv_fused, cuDNN's conv alone and the launch plan, blocks and split of
   K, at each conv_fused site, and the conv_pair wrapper's host time a
   launch).  For
   conv_pair also a sweep of launch geometries at the served sites, batch
   8 and 1: every tile TH x TW and cluster size CS the kernel takes from a
   small set, each held against the plain version and bit-exact against
   the planner's plan (each output is summed in one order whatever the
   geometry), and timed beside it (the best of all, and the best with a
   block per SM); a row past batch 8 also holds its last 8 images
   bit-exact against the same images launched alone.
4. Serving: builds ResNet-50 at full width from ``configs/imagenet_resnet50.py``
   with random weights made from a seed in the JAX layout, loads them
   through ``weights.from_jax``, folds BN, and serves a classify route
   over HTTP on localhost; sends 3 predict requests (JSON bodies of 1, 3
   and 8 images), counts the kernel launches they cause (13 conv_pair and
   7 bn_act per device call), checks the logits against the plain path
   (the same module on the host CPU, where each wrapper runs its plain
   version), prints measure_latency p50 for request sizes 1 and 8, the
   frozen forward's device busy time and top kernels at batch 8, and each
   bn_act launch's device time inside that forward (torch.profiler).
5. Training: step 1 of ``configs/cifar100_resnet18.py`` at full width from
   seeded JAX-layout weights, with the same batch and draws, on the card
   and on the host (loss and every gradient's norm compared); then
   ``myconvnet_tpu_torch.train.main`` for 20 steps at batch 128 with a
   validation every 10 steps, counting launches (pad_crop_u8 once a train
   step; normalize_u8 once, conv_fused 5 and bn_act 4 times an eval
   batch), checking every loss is finite and the BN moving statistics
   moved, then the train step's images/s (CUDA events), host ms and
   device busy time (torch.profiler).
6. Eval: ``myconvnet_tpu_torch.test.main`` restores the checkpoint just
   written and scores the 512-image synthetic split (launches counted);
   the restored model's logits must equal the writer's, and agree with
   the plain path on the host.
7. Flash attention: the forward, dQ and dK/dV kernels against their plain
   versions at ViT-B/16's [128, 12, 197, 64] and [256, 12, 197, 64] and at
   [32, 12, 577, 64] (ViT-B/16 at 384), bf16, with the kernel, plain and
   ``scaled_dot_product_attention`` times (the last a yardstick only).
8. RandAugment kernels: ``shear_rows`` (row and column shears at slopes
   over +-0.3, the three-shear rotate at angles over +-30 degrees) and
   ``randaugment_ew`` (a random op per image, and each of its 8 ops forced
   for the batch, on its one-pass path and its two-pass path forced, with
   the CUDA kernels a layer) against their plain versions at [1024, 224,
   224, 3] and [256, 224, 224, 3] float32, with ``F.grid_sample`` of the
   same shear as the shear's yardstick.
9. ViT-B/16 (``configs/imagenet_vit_b16.py`` as written, RandAugment
   (2, 9) over the FAST pool): augment_train of 8 images on the card
   against the host with the same draws, for the recipe and its three
   settings that reach the RandAugment kernels (the pallas backend, the
   canonical pool, AutoAugment "imagenet"); step 1 at batch 8 on the card
   against the host from seeded JAX-layout weights with the same draws and
   drop-path masks; ``train.main`` for 5 steps at batch 256 as 2
   microbatches with a validation at step 5 (12 forward, 12 dQ and 12
   dK/dV launches a microbatch, 12 forward launches an eval batch, no
   RandAugment kernel; every loss finite, every parameter moved); the
   recipe's batch of 1024 as 4 microbatches of 256 (images/s, device busy
   time, peak memory); ``test.main`` on the checkpoint (restored logits
   equal the writer's and agree with the host's plain path).
10. The three settings through ``train.main``, 4 steps of 256 as 2
    microbatches and one validation each, with their exact launch counts
    (randaugment_ew 2 a step under the pallas backend, shear_rows 10 a step
    under the canonical pool and 7 under AutoAugment), and the
    device-timed augmentation rate: ``augment_train`` of 1024 images under
    CUDA events with RandAugment off, as written, and under each setting.

11. Correlation kernels (``csrc/correlation.cu``): the forward and the
    two backward kernels against the plain version and its autograd at
    the six sites the flow recipes give them (PWC-Net's levels 2 to 6 and
    FlowNetC's 1/8 map, batch 32 of 384x512, d = 4), bf16 (the
    tensor-core kernels; each row carries the planner's launch plan) and
    float32 (the CUDA-core kernels) inputs.
12. PWC-Net (``configs/chairs_pwcnet.py`` as written, full width): step 1
    at batch 2 of 384x512 on the card against the host from seeded
    JAX-layout weights that are non-zero in the flow heads too (their zero
    init would make every upstream gradient zero), with the same flips and
    jitter factors, and the eval flows from those weights (whole pixels)
    against the host's plain path; ``train.main`` for 5 steps at batch 32
    with a validation at step 5 on 32 rendered scenes (5 forward launches a
    train forward and an eval batch, 5 of each backward kernel a step, no
    other kernel; every loss finite, every parameter moved); the step's
    pairs/s, host enqueue ms, device busy ms, idle share, top kernels and
    peak memory; ``test.main`` on the checkpoint (restored flows equal the
    writer's and agree with the host's plain path).
13. FlowNetC (``configs/chairs_flownet_s.py`` with ``model=flownet_c``):
    4 steps at batch 32 and the final validation (1 forward launch a
    forward, 1 of each backward kernel a step).
14. ResNet-50 training (``configs/imagenet_resnet50.py`` as written):
    step 1 at batch 8 on the card against the host (float32 policy), from
    seeded JAX-layout weights with the same crop boxes, flips and jitter
    factors (run beside the build, step 2); ``train.main`` for
    R50_STEPS steps at the recipe's 1024 as 2
    microbatches of 512 on a rendered split of 1024 images, its
    validation and ``test.main`` on the checkpoint (13 conv_pair and 7
    bn_act launches an eval batch, none in a train step; restored logits
    equal the writer's and agree with the host's plain path); the step's
    images/s, host enqueue ms, device busy ms, idle share and peak memory;
    the step again under ``augment.interp_dtype`` bfloat16, and
    ``augment_train`` alone at 1024 x 256² -> 224² under each
    interpolation dtype.
15. SmallNet (``configs/{cifar10,svhn,fashion_mnist}_smallnet.py``):
    CIFAR-10 as written (float32) and under ``precision=bf16``, 20 steps
    of 128 with a validation every 10; SVHN and Fashion-MNIST 5 steps
    each; ``test.main`` on each checkpoint (pad_crop_u8 once a step;
    normalize_u8 once and bn_act 6, or under bf16 conv_fused 5 and bn_act
    1, an eval batch), and each step's rate.
16. VGG-16 (``configs/imagenet_vgg16.py``, batch 512) and DenseNet-121
    (``configs/imagenet_densenet121.py``, batch 1024), each in one pass as
    written (the microbatch count on a line with the peak memory): step 1 at
    batch 4 against the host, ``train.main`` for 4 steps and
    ``test.main`` (conv_fused 12 and bn_act 1, or bn_act 121, an eval
    forward), and the step's rate and peak memory. conv_fused is held at
    VGG-16's eight eval shapes (batch 512, 224² down to 14²) beside
    cuDNN, and bn_act at DenseNet-121's largest and smallest sites (step
    3's rows).

17. DeepLabv3+ (``configs/voc_deeplabv3plus.py``, BASELINE config #4,
    ResNet-50 at output_stride 16, bf16): conv_pair, conv_fused and
    bn_act at every site of its eval forward at the recipe's batch of 16,
    on 513 x 513 crops (129², 65² and 33² maps; conv_fused with 304 input
    channels), on the 96 x 96 crops of its synthetic run and at the 72 x 72
    and 120 x 120 inputs of its multi-scale eval (step 3's rows, path
    ``deeplab_513``, ``deeplab_96``, ``deeplab_72`` and ``deeplab_120``;
    every launch of the runs below is recorded with its shape, and each
    shape must be one a row holds); step 1 at batch 4 of 257 x 257 crops
    on the card against the host (float32 and bf16, the same pairs,
    boxes, flips and ASPP dropout mask, the rounding witnesses and bounds
    of step 16's but the host's step one ulp over); ``train.main`` on the
    recipe as written (its synthetic run at 96 x 96) for 10 steps of 16
    with a validation every 5, ``test.main`` on its checkpoint with and
    without ``--scales 0.75,1.0,1.25`` (mIoU; conv_pair 11, conv_fused 2
    and bn_act 18 launches an eval forward, none in a train step; restored
    outputs equal the writer's and agree with the host's plain path, under
    ``--scales`` each forward's logits and the averaged probabilities);
    then the recipe's 513 x 513 crops of 512 x 512 frames at batch 16 from
    ``recipes.segmenter_trainer``:
    10 steps through ``Trainer.fit``, a validation that launches one eval
    forward's kernels, the logits against the host's, and the step's
    images/s, host enqueue ms, device busy ms, idle share, top kernels and
    peak memory.
18. The GAN recipes (BASELINE config #5): bn_act at every site of the
    generators' eval forwards, DCGAN's three (float32, ReLU) at 16 and 64
    samples and the U-Net's 13 (bf16; six leaky ReLU, seven ReLU) at batch
    16, and normalize_u8 at both recipes' train batches ([128, 32, 32, 3]
    and [16, 256, 256, 3], mean = std = 0.5, float32 out), each against
    its plain version with its bound (step 3's rows, paths ``dcgan_16``,
    ``dcgan_64`` and ``pix2pix``); DCGAN step 1 at batch 128 on the card
    against the host (float32: d_loss, g_loss and every gradient norm of
    both nets, step 16's bounds); ``train.main`` on
    ``configs/dcgan_cifar10.py`` as written for 20 steps of 128 with a log
    line, a checkpoint and a 16-sample grid every 10 (normalize_u8 once a
    step, bn_act 3 a grid; every metric finite; both nets' BN statistics
    moved) and ``generate.main``'s grid of 64 from the checkpoint (bn_act
    3; equal to the writer's samples, both under cuDNN's deterministic
    algorithms); ``train.main`` on
    ``configs/pix2pix.py`` as written (bf16, 256x256) for 20 steps of 16
    (normalize_u8 twice a step, no bn_act) and ``test.main`` on its
    checkpoint (PSNR and SSIM over 64 rendered val pairs; normalize_u8
    once and bn_act 13 a batch; the restored output equal to the writer's
    under cuDNN's deterministic algorithms, and within 0.05 of max
    |output| of the host's plain path); every launch recorded with its shape and held by a row; each recipe's train
    step rate.
16. The ConvNet API (``models/base.py``) through the entry points
    (``convnet_api_run``).  (a) ResNet-50 at full width: ``train.main`` on
    ``configs/imagenet_resnet50.py`` at 1024 as 2 x 512 (bf16) for 10
    steps, validating every 5, with EMA 0.9999, lookahead and random
    erasing 0.25 (conv_pair 13 and bn_act 7 an eval batch, none in a
    step), ``test.main --best --ema --tta ten_crop --topk 5 --report``
    (130 and 70: ten views of one batch; the report goes to
    ``chiprun_out/api_r50_report.txt``) and ``test.main --average 2``;
    losses finite, ``best.npz``'s step, the reader's EMA equal to the
    writer's, the ten-crop log-probabilities of 8 images on the card
    against the host's plain path, and the step's rate and peak memory
    with the wrappers on beside step 9's plain step.  (b) The CIFAR-100
    ResNet-18: ``train.main`` for 20 steps validating every 5 with SAM
    (rho 0.05), reduce-on-plateau (factor 0.5, patience 1) and the stem
    frozen (pad_crop_u8 once a step; normalize_u8 1, conv_fused 5 and
    bn_act 4 an eval batch); the stem's weights bit-identical to the
    seeded ones, the logged LR scale against the validation record, SAM's
    step against the plain step's device time, a padded tail batch of
    ``predict`` against the same images inside a full batch (bit for
    bit); ``test.main --tta flip --average 3`` (normalize_u8 1,
    conv_fused 10 and bn_act 8 a batch); a focal-loss run of 4 steps.
    Every launch recorded with its shape and held by a row.
20. Image files (``files_run``).  First, before any phase, what the
    machine has: the C++ compiler's ``jpeglib.h`` and ``png.h``, Pillow,
    the CPU count and affinity (one line); the port's host library
    (``csrc/host/dataloader.cc``) is built with g++ into
    ``build/host/<hash>/`` then, with libjpeg and libpng where their
    headers are, and the phases below that the machine can run are fixed.
    C6: ``Trainer.evaluate`` of the CIFAR-100 ResNet-18 over 192 images at
    batch 128 pads its tail, whose logits equal the same images' inside a
    full batch, bit for bit.  ResNet-50 as written through ``train.main
    --data_dir`` on an ImageNet layout of 1000 class directories (2048
    train and 512 val files linked from ``tests/fixtures/torch_io``) at
    1024 as 2 x 512, 6 steps validating once, then ``test.main``: the
    step's ms, images/s and input_wait_frac from the run's log beside the
    synthetic run of step 14, peak memory, B5 13 and B1 7 an eval batch of
    512 held by shape (step 3's rows at batch 512), the restored logits
    against the writer's and the host's; then the trained step fed by the
    files and by an in-memory source, each plain and under torch.profiler
    (step ms, input wait, host enqueue, device busy, idle share); the
    JPEGs decode natively where the machine has ``jpeglib.h``, else
    through FileSource's Pillow path.  With Pillow: DeepLabv3+ through
    ``train.main --data_dir`` on a VOCdevkit layout at its 513 x 513 crop,
    batch 16, 10 steps and ``test.main`` (B5 11, B4 2, B1 18 an eval
    forward); pix2pix on a combined layout, 10 steps with the generator's
    EMA (B2 2 a step), ``generate.main --input`` over 16 images with and
    without ``--ema`` (B2 1, B1 13 each); 3 image bodies through
    ``ModelServer.predict`` on the served ResNet-50 (B2 1 at [1, 224, 224,
    3], B5 13, B1 7 a request; logits against the host's).  Then the host
    decode rate of 512 fixture JPEGs at 256 x 256 over 1, 2, 4, 8 and all
    threads (the native path, or Pillow's), a core's rate and the cores
    that feed the ResNet-50 steps of this call.  A line before the kernels'
    record names what the machine lacked and what ran instead or was
    skipped.
21. Routes (``routes_run``): one HTTP server on localhost with four
    routes at full width from seeded JAX-layout weights, each behind the
    micro-batcher (``batch_window_ms`` 250): segment (DeepLabv3+ of
    ``configs/voc_deeplabv3plus.py`` at 513 x 513, bf16, BN folded), translate
    (``configs/pix2pix.py``'s U-Net at 256 x 256, bf16), flow
    (``configs/chairs_pwcnet.py`` at 384 x 512, bf16), each at a route batch
    of 4, and the served ResNet-50 (classify, batch 8).  JSON bodies of 1
    and 3 images (pairs for flow) and a fixture JPEG body to each image
    route, every request one device call, its launches held exactly
    (segment conv_pair 11, conv_fused 2, bn_act 18; translate bn_act 13;
    flow the correlation forward 5; an image body normalize_u8 1 at [1, h,
    w, 3]) and every launch by shape; the responses' form; each route's
    device busy time a call (torch.profiler) and one request on the card
    against the same route on the host (plain versions).  Classify: a lone
    request's p50 with and without the window, and 8 concurrent one-image
    JPEG requests that become one device call (normalize_u8 8, conv_pair
    13, bn_act 7) under a window of 2 s, with the spread of their arrivals
    at the batcher.  Paths ``routes_segment``, ``routes_translate``,
    ``routes_flow`` and ``routes_classify``, held at step 3's rows at the
    routes' shapes.
22. SN-GAN and FID (``sngan_fid_run``): ``train.main`` on
    ``configs/sngan_cifar10.py`` as written (spectral-normalized D, hinge
    loss, batch 64) for 20 steps (normalize_u8 once a step, nothing else),
    every loss finite, every ``sn_u`` moved, each SN layer's
    ``matrix_norm(w / sigma, 2)`` in SN_BAND, the step's rate and idle
    share; then ``test.main --fid --fid_extractor
    configs/cifar100_resnet18.py:<the CIFAR phase's checkpoint>
    --fid_samples 256`` (bn_act 3 a sampler chunk of 64; conv_fused 5 and
    bn_act 4 a feature batch of 256, real and fake), the FID finite and,
    over the same features, within FID_RTOL of the host's (path
    ``sngan_fid``).
23. Export (``export_run``): each task kind the port exports, at full
    width from the recipe as written (weights from its seed and a few
    steps of its family phase's run, synthetic splits cut to a few
    items): ResNet-50, ViT-B/16 and Swin-T (classify,
    batch 8; Swin-T's graph holds no mcn:: op), DeepLabv3+ at 513 x 513
    (segment, from a VOCdevkit corpus of the fixtures, batch 4), pix2pix (translate, 4), DCGAN (sample, 4) and
    PWC-Net (flow, 4).  Each: the checkpoint of its family phase's
    ``train.main`` run (kept for this phase by ``keep_run``; a recipe
    seed's checkpoint where a phase kept none), ``test.main --export`` (no
    launch: traced with fake tensors; the seconds and MB; the graph's
    mcn:: nodes), ``serve.main --artifact`` in the kind's mode over the
    fixtures (one device call), the artifact against the route program
    built in memory from the same checkpoint on one batch of wire rows
    (the same launches by shape, recorded inside the ops, and the same
    bits, DCGAN within EXPORT_TOL), and for ResNet-50 ``serve.main
    --artifact --latency`` (p50, p95 at sizes 1 and 8) beside the
    in-memory program's at the artifact's batch.  Then the DeepLab artifact
    behind the ``NAME=KIND:ARTIFACT:CONFIG`` route spec over HTTP: a
    fixture JPEG
    (B2 1 at [1, 513, 513, 3], then B5 11, B4 2, B1 18).  Paths
    ``export_*``.

24. Swin-T (``swin_run``): ``configs/imagenet_swin_t.py`` as written
    (bf16, RandAugment (2, 9) over the FAST pool, MixUp/CutMix, drop-path
    0.2, AdamW with clipping): step 1 at batch 4 on the card against the
    host (the same draws and drop-path masks); ``train.main`` for 3 steps
    of 1024 as 4 microbatches and ``test.main`` on its checkpoint, no
    kernel launched in either (the window attention is plain ops: the
    flash kernels take no additive bias); restored logits equal the
    writer's and agree with the host's plain path; the step's images/s,
    host enqueue, device busy, idle share, peak memory, and the window
    attention modules' forward and backward alone at the step's shapes
    beside the busy time.
25. MAE ViT-B/16 (``mae_run``): ``configs/imagenet_mae_vit_b16.py`` at
    MAE_BATCH, the largest batch that fitted when it was chosen (not
    checked here; its ``mesh=dict(data=None)``
    is the one card): step 1 at batch 4 against the host with the same
    views and masking draw; ``train.main`` for 2 steps with the kNN probe
    at the end and ``test.main`` (the probe, the encoder re-exported):
    each flash kernel 12 times at the encoder's [B, 12, 50, 64] and 8 at
    the decoder's [B, 16, 197, 32] a step, the forward 12 at [B, 12, 197,
    64] a probe batch, every launch held by shape (the backward's inside
    the autograd Function); losses finite; the restored probe features
    equal the writer's and agree with the host's; ``encoder.npz``
    warm-starts ``vit_b16`` bit for bit; the step's rate.  Step 3's flash
    rows hold MAE's three
    shapes (path ``mae``).  Then ``configs/cifar10_mae.py`` as written
    (``tinymae``, float32, batch 128; ``mae_cifar_run``): step 1 against
    the host, train.main and test.main (no kernel in a step: float32
    attention is the einsum path; normalize_u8 once a probe batch).
26. SimCLR (``simclr_run``): ``configs/cifar10_simclr.py`` as written
    (SmallNet, float32, batch 128) and ``configs/imagenet_simclr_resnet50.py``
    (ResNet-50, bf16, LARS) at SIMCLR_R50_BATCH, the largest batch that
    fitted when it was chosen (not checked here): step 1 of each at batch 4 against the host (both views'
    draws), ``train.main`` for 2 steps with the probe and ``test.main``:
    no kernel in a train step; a probe batch SmallNet's 6 bn_act and 1
    normalize_u8, or ResNet-50's 13 conv_pair and 7 bn_act, held by shape
    at step 3's rows (paths ``simclr_smallnet``, ``simclr_resnet50``);
    loss and contrast_acc finite; the probe features against the host's;
    each step's rate.
27. The grouped and depthwise families (``zoo_run``): ZOO_RECIPES, the
    recipes as written (ResNeXt-50 32x4d at 1024 as 2 x 512, WRN-28-10 at
    128, MobileNetV2, MobileNetV3-Large and EfficientNet-B0 at 1024 in one
    pass, RepVGG-A0 at 256), each through ``train.main`` and ``test.main``
    from synthetic data (``classifier_run``: launches, finite losses,
    restored logits, card against host); every launch of an eval forward
    held by shape to the model's own sites (``zoo_sites``: the modules run
    on the meta device with the kernel wrappers recording, so the host
    derives what the card must launch: B1 35 ReLU6 a MobileNetV2 batch, 33
    a ResNeXt-50's, 11 a MobileNetV3's, B1 15 and B4 10 a WRN-28-10's);
    the step's ms, images/s, idle share and peak memory.  ResNet-101,
    ResNet-152 and SE-ResNet-50 served at batch 8 (B5 30, 47 and 13, B1 7
    each, by shape; logits against the host).  RepVGG-A0's
    ``test --export`` writes its reparameterized deploy stack (mcn::
    nodes B4 17 and B1 5); ``serve --artifact`` serves it, and it gives
    the bits of the in-memory deploy program (``deploy_params`` of the
    same checkpoint), launch by launch and shape by shape.  Step 3's rows
    hold every one of these shapes (``check_zoo_kernels``; paths
    ``zoo_*`` and ``export_repvgg_a0``).
28. The segmenters beside DeepLab (``seg_family_run``):
    ``configs/voc_unet.py`` and ``configs/voc_pspnet.py`` as written (full
    width, bf16): step 1 on the card against the host at SEG_FAMILY_STEP1,
    the step at 16 on their 512² and 473² crops (ms, images/s, idle
    share, peak memory), an eval forward of 4 and a ``segment`` route's
    image request (B4 17 and B1 1 a U-Net forward; B5 6, B4 1, B1 25 a
    PSPNet one; + B2 1 the image), each held by shape to the model's
    sites, the eval logits against the host; DeepLabv3+ on Xception-65's
    eval forward of 4 at 513² (B4 3, B1 74) held the same way.
29. The rest of the zoo (``zoo_rest_run``): Inception-v3 (299²),
    Xception-65, ConvNeXt-T/S, SqueezeNet and AlexNet (224²) through the
    ImageNet recipe, the step at 128 and a served call of 8 held by shape
    (B4 10 / B1 84, 1 / 67, none, none, 8 / 18, 3 / 2), its logits against
    the host; one Adagrad and three Shampoo steps of the CIFAR-100
    ResNet-18 recipe, each from the card's state: its gradients against
    the host's, then each parameter's update against the host's from the
    card's gradients (Shampoo's control: without its preconditioner the
    host's update misses the bound).
    ``check_seg_family_kernels`` adds the rows of paths ``seg_*`` and
    ``zoo_rest_*`` to step 3's.
30. The classification-side tasks (``representation_run``): a ResNet-18
    teacher trained by ``train.main`` on CIFAR-10 (2 steps), then four
    recipes as written through ``train.main`` and ``test.main``:
    ``configs/cifar10_distill_r18_smallnet.py`` (that checkpoint as the
    teacher; B3 1 and the float32 teacher's B1 9 a step, B2 1 and the
    student's B1 6 an eval batch), ``cifar10_fixmatch.py`` (B3 2 a step,
    the strong RandAugment view in plain ops; B2 1, B4 10, B1 15 an EMA
    eval batch of WRN-28-2 in bf16), ``cifar10_triplet.py`` (B3 1; B2 1,
    B1 6) and ``faces_arcface_r50.py`` (512 at 112², no kernel in the
    step; B5 13 and B1 7 an eval batch, B5 at the 4² map of stage 4),
    each held by shape to the models' sites and in total; step 1 against
    the host at REPR_STEP1; the step's ms, idle share and peak memory.
    ArcFace served: ``test --export`` (an ``embed`` artifact), ``serve
    --artifact --images``, the artifact against its in-memory program
    (bits, launches by shape), and an ``embed`` route's JSON and JPEG
    requests (unit norm; against the host's route within EMBED_REL_TOL).
    ``check_repr_kernels`` adds the rows of paths ``repr_*`` to step 3's.
31. Monocular depth and one-stage detection (``depth_detection_run``):
    ``configs/nyu_depth_unet.py`` (64 at 224 x 288), ``voc_ssd300.py``
    (32 at 300²) and ``voc_retinanet.py`` (16 at 512²) as written (bf16,
    synthetic scenes), each: step 1 on the card against the host
    (float32, TF32 off, batch DET_STEP1); ``train.main`` 2 steps with a
    validation (AbsRel, val_mAP finite); the step's ms, idle share and
    peak memory; ``test.main`` on its checkpoint (depth with
    ``--save_preds``: the 16-bit files equal the eval forward's depth x
    1000); an eval forward held by shape to the model's sites and B2 1
    (depth: B4 15, B1 4; SSD300: B4 12, B1 11; RetinaNet: B5 13, B1 7,
    B4 40); for the detectors the post-process on the card against the
    host on the same logits and the blocked NMS's host syncs an eval
    batch; ``test --export``, ``serve --artifact --depth|--detect``, the
    artifact bit for bit against the in-memory program from the same
    checkpoint; a route's JPEG request (B2 1, then one device call), the
    depth route against the host's, the detect artifact route's
    detections against the in-memory route's.  ``check_det_kernels``
    adds the rows of paths ``det_*`` to step 3's.

Every kernel's record carries its bound: the larger of the bytes it must
move over 3.35 TB/s and the operations it must do over the peak rate of
their type (989 TFLOP/s bf16 tensor-core products, 67 TFLOP/s float32
elementwise), from this run's shapes.

``python3 chip_smoke.py --compare DIR`` (DIR: another checkout, e.g. the
parent commit unpacked by ``git archive``) runs only the kernel timing of
normalize_u8, pad_crop_u8, conv_pair and bn_act (``time_tree_kernels``;
conv_pair at shapes with and without single-tile passes) and the served
ResNet-50's p50 at sizes 1 and 8, once a process, for
DIR, this checkout, this checkout, DIR in that order on the same card:
each tree's kernels built from its own sources, timed back to back at
the shapes of the input rows above (pad_crop_u8 also with each staging
mode forced where a tree has them) and conv_pair at COMPARE_PAIR_SHAPES,
each held against its plain version,
with its wrapper's host time.  It prints one line a kernel and case with
the four times and writes ``chiprun_out/compare.json``; it exits non-zero
if a run fails or a kernel disagrees with its plain version.

``python3 chip_smoke.py --sweep-inputs`` times normalize_u8 and
pad_crop_u8 at those shapes under other launch geometries than their
planners' (``sweep_input_plans``: each planner run with one of its
constants changed), each held against its plain version, and writes
``chiprun_out/input_sweep.json``.

Exits non-zero on any failure.  The second-to-last line of stdout is the
kernels' JSON record (thirteen entries; bn_act's ``by_path`` has the GAN
paths ``dcgan`` and ``pix2pix``, and the routes' and ``sngan_fid``, and
with conv_pair's the SimCLR probes'; each flash kernel's ``vit`` and
``mae``; a
correlation entry's ``ms``, ``plain_ms`` and ``bound_ms`` sum one PWC-Net
and one FlowNetC train step, and the forward's one flow-route forward too,
its ``launches`` the paths' runs, and ``by_path`` splits them), the last
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "imagenet_resnet50.py")
SEED = 0
BATCH = 8

# conv_pair sites of ResNet-50 at 224, batch 8: (n, h, w, cin, cm, cout)
# and how many blocks of one forward run at that shape
PAIR_SITES = [((BATCH, 56, 56, 64, 64, 64), 1),       # stage1.block1
              ((BATCH, 56, 56, 256, 64, 64), 2),      # stage1.block2-3
              ((BATCH, 28, 28, 512, 128, 128), 3),    # stage2.block2-4
              ((BATCH, 14, 14, 1024, 256, 256), 5),   # stage3.block2-6
              ((BATCH, 7, 7, 2048, 512, 512), 2)]     # stage4.block2-3
# bn_act sites: the conv outputs [n, h, w, c] that get bias + ReLU
ACT_SITES = [("stem.conv", (BATCH, 112, 112, 64)),
             ("stage2.block1.conv_a", (BATCH, 56, 56, 128)),
             ("stage2.block1.conv_b", (BATCH, 28, 28, 128)),
             ("stage3.block1.conv_a", (BATCH, 28, 28, 256)),
             ("stage3.block1.conv_b", (BATCH, 14, 14, 256)),
             ("stage4.block1.conv_a", (BATCH, 14, 14, 512)),
             ("stage4.block1.conv_b", (BATCH, 7, 7, 512))]
PER_CALL = {"conv_pair": 13, "bn_act": 7}
BN_ACT_KERNEL = "scale_shift_act"   # in the name of every bn_act kernel

# CIFAR-100 ResNet-18 at 32x32, batch 128: the stem runs at 16x16, the
# four stages at 8x8, 4x4, 2x2 and 1x1
CIFAR_CONFIG = os.path.join(ROOT, "configs", "cifar100_resnet18.py")
TRAIN_BATCH = 128
TRAIN_STEPS = 20
VAL_EVERY = 10
EVAL_BATCHES = 4    # the 512-image synthetic split at batch 128
# conv_fused sites (n, h, w, c, cout) and how many run at that shape in
# one eval forward: stage1.block1-2, stage2-4.block2
FUSED_SITES = [((TRAIN_BATCH, 8, 8, 64, 64), 2),
               ((TRAIN_BATCH, 4, 4, 128, 128), 1),
               ((TRAIN_BATCH, 2, 2, 256, 256), 1),
               ((TRAIN_BATCH, 1, 1, 512, 512), 1)]
# ResNet-18's bn_act sites: the stem and the stride-2 conv_a of stages 2-4
ACT_SITES_R18 = [("r18 stem.conv", (TRAIN_BATCH, 16, 16, 64)),
                 ("r18 stage2.block1.conv_a", (TRAIN_BATCH, 4, 4, 128)),
                 ("r18 stage3.block1.conv_a", (TRAIN_BATCH, 2, 2, 256)),
                 ("r18 stage4.block1.conv_a", (TRAIN_BATCH, 1, 1, 512))]
INPUT_SHAPE = (TRAIN_BATCH, 32, 32, 3)
# the input kernels (B2 normalize_u8, B3 pad_crop_u8) at the recipe's
# batch and at the design checks of their redesign: (case, [N, H, W, C],
# out dtype, B3's pad and flip, per-channel mean and std (None: the CIFAR
# recipe's), whether it is the CIFAR recipe's main path)
INPUT_CASES = [
    ("cifar", INPUT_SHAPE, "float32", 4, True, None, True),
    ("fashion_mnist_smallnet", (TRAIN_BATCH, 28, 28, 1), "float32", 2,
     False, ((0.2860,), (0.3530,)), False),
    ("cifar bf16", INPUT_SHAPE, "bfloat16", 4, True, None, False),
    ("imagenet 224", (256, 224, 224, 3), "float32", 4, True,
     ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225)), False)]
PER_TRAIN_STEP = {"pad_crop_u8": 1}
PER_EVAL_BATCH = {"normalize_u8": 1, "conv_fused": 5, "bn_act": 4}

# kernel vs plain: bn_act, normalize_u8 and pad_crop_u8 round like their
# plain versions (bit-exact expected; 1 bf16 or 1 float32 ulp allowed);
# conv_pair and conv_fused sum in another order, which can move the bf16
# output (or conv_pair's intermediate) by an ulp (2 bf16 ulps allowed; a
# conv_pair element past them must be explained by its intermediate's
# rounding, PAIR_OUTLIERS)
ULP32 = dict(rtol=2 ** -23, atol=2 ** -30)
TOL = {"bn_act": dict(rtol=2 ** -8, atol=1e-6),
       "conv_pair": dict(rtol=2 ** -6, atol=2 ** -7),
       "normalize_u8": ULP32, "pad_crop_u8": ULP32,
       "conv_fused": dict(rtol=2 ** -6, atol=2 ** -7),
       # each product, sum and quotient rounded as the plain version
       # rounds it (no FMA): bit-exact expected, 1 float32 ulp allowed
       "shear_rows": ULP32, "randaugment_ew": ULP32}
# conv_pair: at most this many elements outside TOL, each explained by
# intermediate elements that may round either way (pair_flip_slack); at
# ResNet-50's eval batch of 1024 (1e8-2e8 outputs a shape) 0-2 a shape lie
# outside, each by one intermediate element at a midpoint
PAIR_OUTLIERS = 1024
# step 1 on the card vs the host, both bf16 (cuDNN vs the CPU's convs,
# rounding at other points): the loss within 2e-2 and each gradient's
# norm within 5e-2 relative, plus 1e-3 of the largest norm for the
# small ones
STEP1_LOSS_RTOL = 2e-2
STEP1_GRAD_RTOL = 5e-2
STEP1_GRAD_ATOL = 1e-3
# step 1 of ResNet-50, VGG-16 and DenseNet-121 under the float32 policy
# (TF32 off), card vs host, on an H100 80GB HBM3: each side's augmented
# batch differs by up to 6.7e-5 of max |x| (STEP1_INPUTS_RTOL); from
# those, the loss read up to 1.4e-6 apart and the gradient norms up to
# 1.37% apart, on BN gammas and betas whose norms are 0.7-1.7% of the
# largest (their sums cancel: a BN's backward leaves each channel's
# gradient summing to zero); the host given the card's augmented batch
# read up to 6.6e-8 and 0.21% (the _MODEL bounds), as far as float32
# rounding alone moves them (the weights one ulp over on the host: 0.34%;
# the card without cuDNN: 0.27%).  Each bound about twice its reading.
STEP1_INPUTS_RTOL = 2e-4
STEP1_F32_LOSS_RTOL = 1e-5
STEP1_F32_GRAD_RTOL = 2e-2
STEP1_F32_GRAD_ATOL = 1e-4
STEP1_F32_MODEL_LOSS_RTOL = 1e-6
STEP1_F32_MODEL_GRAD_RTOL = 5e-3
# under bf16 the host's own bf16 step moves those norms 15-17% from its
# float32 one (W, bf16's reach; the card's bf16 step sits 13-15% from the
# host's, at 8 and at 32 images alike): held at 2W, and only while W stays
# under STEP1_BF16_MAX_REACH
STEP1_BF16_MAX_REACH = 0.25
# served logits (bf16 on the card) vs the plain path on the host, as a
# fraction of max |logit|: the CPU test of the same comparison against JAX
# holds 0.05 (tests/test_torch_resnet.py)
LOGIT_REL_TOL = 0.05
# the same under the float32 policy (TF32 off): the SmallNet runs read
# 6.7e-7 to 1.1e-6 of max |logit| on an H100 80GB HBM3; 1e-5 is the CPU
# tests' float32 bound against JAX
LOGIT_REL_TOL_F32 = 1e-5
# ViT-B/16 as written: RandAugment (2, 9) over the FAST pool (the XLA
# where-fold, no kernel)
VIT_CONFIG = os.path.join(ROOT, "configs", "imagenet_vit_b16.py")
VIT_SET = []
VIT_BATCH, VIT_ACCUM, VIT_STEPS, VIT_VAL_EVERY = 256, 2, 5, 5
VIT_STEP1_BATCH = 8
VIT_SPLIT = 256   # images in each synthetic split, as the JAX package
VIT_RECIPE_BATCH, VIT_RECIPE_ACCUM = 1024, 4
VIT_DEPTH = 12
# The self-supervised recipes (task "ssl") and Swin-T: MAE ViT-B/16 and the
# ImageNet SimCLR ResNet-50 at a batch cut to what fitted the card when it
# was chosen (twice the batch did not fit on an H100 80GB HBM3; a reading
# of an earlier run that this script no longer checks), a few steps each; step 1 of each at SSL_STEP1_BATCH on
# the card against the host.  MAE's flash sites a step: the encoder's 12
# blocks on the kept quarter of the 196 patches and the class token (L =
# 50, 12 heads of 64), the decoder's 8 blocks on all 197 tokens (16 heads
# of 32); a probe batch runs the encoder on all 197.
MAE_CONFIG = os.path.join(ROOT, "configs", "imagenet_mae_vit_b16.py")
MAE_BATCH, MAE_DEPTH, MAE_DEC_DEPTH = 1024, 12, 8
MAE_SITES = [((MAE_BATCH, 12, 50, 64), MAE_DEPTH),
             ((MAE_BATCH, 16, 197, 32), MAE_DEC_DEPTH)]
MAE_PROBE_SHAPE = (MAE_BATCH, 12, 197, 64)
# the CPU-size MAE recipe as written (tinymae, float32: its attention is
# the einsum path; B2 once a probe batch of 128 at 32 x 32)
MAE_CIFAR_CONFIG = os.path.join(ROOT, "configs", "cifar10_mae.py")
SIMCLR_CIFAR_CONFIG = os.path.join(ROOT, "configs", "cifar10_simclr.py")
SIMCLR_R50_CONFIG = os.path.join(ROOT, "configs",
                                 "imagenet_simclr_resnet50.py")
SIMCLR_R50_BATCH = 512
SSL_STEPS, SSL_STEP1_BATCH = 2, 4
# Swin-T as written at its batch of 1024 as SWIN_ACCUM microbatches, on a
# rendered split of one batch (on an H100 80GB HBM3 the step at 4 x 256
# peaked at 26.2 GiB, at 8 x 128 at 13.8; MAE-B16 at 1024 at 70.3 GiB,
# 2048 did not fit; SimCLR ResNet-50 at 512 at 47.1 GiB, 1024 did not: the
# last two are readings of an earlier run, not checked here any more)
SWIN_CONFIG = os.path.join(ROOT, "configs", "imagenet_swin_t.py")
SWIN_BATCH, SWIN_ACCUM, SWIN_STEPS, SWIN_SPLIT = 1024, 4, 3, 1024
SWIN_STEP1_BATCH = 4
# flash shapes [B, H, L, D], how many launches of each kernel one forward
# (and backward) of the path's train step (ViT: its recipe's microbatch of
# 256) makes there, and the path; (BATCH, ...) is the ViT-B/16 artifact's
# call in the export phase, MAE_PROBE_SHAPE a MAE probe batch's forward
FLASH_SITES = [((128, 12, 197, 64), 0, "vit"),
               ((256, 12, 197, 64), VIT_DEPTH, "vit"),
               ((32, 12, 577, 64), 0, "vit"), ((BATCH, 12, 197, 64), 0, "vit"),
               *((shape, sites, "mae") for shape, sites in MAE_SITES),
               (MAE_PROBE_SHAPE, 0, "mae")]
FLASH = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")
# kernel vs plain: the kernel rounds P (and dS) to bf16 before the second
# product and sums in another order: the output within 2 bf16 ulps of
# max |O|, each gradient within 2^-6 of its max; lse and D are float32
# sums of the same products (2^-16 of their max)
FLASH_OUT_ULPS = 2
FLASH_GRAD_TOL = 2 ** -6
FLASH_STAT_TOL = 2 ** -16
# the recipe's documented settings that reach the RandAugment kernels:
# overrides, then the launches a train step makes (B7 shear_rows: rotate
# 3 + shear_x 1 + shear_y 1 a layer of the canonical pool, AutoAugment's
# rotate + shear_x in step 0 and rotate in step 1; B8 randaugment_ew: one
# a layer)
POLICY_RUNS = {
    "pallas": (["augment.randaugment_backend=pallas"], {"randaugment_ew": 2}),
    "canonical": (["augment.randaugment_ops=canonical"], {"shear_rows": 10}),
    "autoaugment": (["augment.randaugment=None",
                     "augment.autoaugment=imagenet"], {"shear_rows": 7})}
POLICY_STEPS = 2
# augmentation alone at the recipe's batch, per policy
AUG_POLICIES = {"off": ["augment.randaugment=None"], "fast": [],
                **{k: v for k, (v, _) in POLICY_RUNS.items()}}
# RandAugment kernels at the recipe's batch and train.main's; "sites" are
# the launches of one recipe step of 1024 at that shape: the canonical
# pool's 6 row and 4 column shears, the pallas backend's 2 layers
RA_SHAPES = [(VIT_RECIPE_BATCH, 224, 224, 3), (VIT_BATCH, 224, 224, 3)]
RA_SITES = {("shear_rows", 2): 6, ("shear_rows", 1): 4,
            ("randaugment_ew", "random"): 2}
# randaugment_ew's paths: one kernel a layer over a cluster's shared memory
# (the planner's at 224 x 224 x 3), and the statistics and apply kernels
# forced
RA_PATHS = ("one_pass", "two_pass")
# the policies on the card against the host at batch 8 of 224x224: the
# crop matmuls differ by float32 round-off, which posterize, solarize and
# equalize can turn into a whole level at a rare pixel: 1e-4 (normalized
# units) on all but 0.1% of the elements
POLICY_TOL, POLICY_FRAC = 1e-4, 1e-3
# the flow recipes: PWC-Net as written (batch 32 of 384x512, bf16) on 32
# rendered scenes per split, FlowNetC through the FlowNetS recipe
PWC_CONFIG = os.path.join(ROOT, "configs", "chairs_pwcnet.py")
FLOWNET_CONFIG = os.path.join(ROOT, "configs", "chairs_flownet_s.py")
FLOW_BATCH, FLOW_SCENES = 32, 32
PWC_STEPS, PWC_VAL_EVERY, PWC_STEP1_BATCH = 5, 5, 2
PWC_LEVELS = 5          # cost volumes of one PWC-Net forward
FLOWNETC_STEPS = 4
CORR = ("correlation_fwd", "correlation_bwd_f1", "correlation_bwd_f2")
CORR_D = 4
# (site, f1/f2 shape, the path whose train step launches each kernel once
# there)
CORR_SITES = [("PWC-Net level 2", (FLOW_BATCH, 96, 128, 32), "pwcnet"),
              ("PWC-Net level 3", (FLOW_BATCH, 48, 64, 64), "pwcnet"),
              ("PWC-Net level 4", (FLOW_BATCH, 24, 32, 96), "pwcnet"),
              ("PWC-Net level 5", (FLOW_BATCH, 12, 16, 128), "pwcnet"),
              ("PWC-Net level 6", (FLOW_BATCH, 6, 8, 196), "pwcnet"),
              ("FlowNetC 1/8", (FLOW_BATCH, 48, 64, 256), "flownet_c")]
# the runs that count a path's launches
CORR_PATH_RUNS = {"pwcnet": ("pwc_train", "pwc_test"),
                  "flownet_c": ("flownetc_train",),
                  "routes_flow": ("routes_flow_json1", "routes_flow_json3"),
                  "export_pwcnet": tuple(f"export_pwcnet_{part}" for part in (
                      "export", "serve", "artifact", "memory"))}
# kernel vs plain: float32 sums of exact products in another order, 2^-18
# of max |volume| (and of the largest gradient for float32 inputs); bf16
# gradients are rounded once from a float32 sum, 2 bf16 ulps of the largest
CORR_TOL = 2 ** -18
CORR_GRAD_ULPS = 2
# eval flows (bf16 on the card) vs the plain path on the host, as a
# fraction of max |flow|: the CPU test against JAX holds the same
FLOW_REL_TOL = 0.05
# BASELINE configs #1-#3 (and ResNet-50 training, config #2): the recipes as
# written, full width, on synthetic splits of one recipe batch
R50_BATCH, R50_ACCUM, R50_STEPS = 1024, 2, 4
STEP1_BATCH = {"resnet50": 8, "vgg16": 4, "densenet121": 4}
CLASSIFIER_NAMES = {"resnet50": "ResNet-50", "vgg16": "VGG-16",
                    "densenet121": "DenseNet-121"}
# eval forward launches: ResNet-50 unfolded (validation and test.main),
# SmallNet under each policy, VGG-16 and DenseNet-121 under bf16
FORWARD = {"resnet50": {"conv_pair": 13, "bn_act": 7},
           "smallnet f32": {"bn_act": 6},
           "smallnet bf16": {"conv_fused": 5, "bn_act": 1},
           "vgg16": {"conv_fused": 12, "bn_act": 1},
           "densenet121": {"bn_act": 121},
           # DeepLabv3+ (bf16, output_stride 16): the 11 undilated
           # stride-1 bottlenecks, refine1 and refine2, the 18 other sites
           "deeplab": {"conv_pair": 11, "conv_fused": 2, "bn_act": 18},
           # the GAN generators' eval forwards (the discriminators and
           # every train step are plain)
           "dcgan": {"bn_act": 3}, "pix2pix": {"bn_act": 13}}
SMALLNET_CONFIGS = {name: os.path.join(ROOT, "configs", f"{name}_smallnet.py")
                    for name in ("cifar10", "svhn", "fashion_mnist")}
# (run, recipe, overrides, steps, val_every); the rendered splits hold 512
# images, 4 eval batches of 128
SMALLNET_RUNS = [("cifar10 f32", "cifar10", [], 20, 10),
                 ("cifar10 bf16", "cifar10", ["precision=bf16"], 20, 10),
                 ("svhn f32", "svhn", [], 5, 0),
                 ("fashion_mnist f32", "fashion_mnist", [], 5, 0)]
SMALLNET_BATCH, SMALLNET_SPLIT = 128, 512
VGG_CONFIG = os.path.join(ROOT, "configs", "imagenet_vgg16.py")
DENSENET_CONFIG = os.path.join(ROOT, "configs", "imagenet_densenet121.py")
# the recipes' global batches, the microbatches a step splits them into
# (1: as written; on an H100 80GB HBM3 VGG-16 at 512 peaked at 43.6 GiB
# and DenseNet-121 at 1024 at 67.7 of 79.2, so neither needs a reduction)
# and the train.main steps
BIG_RUNS = {"vgg16": (VGG_CONFIG, 512, 1, 4),
            "densenet121": (DENSENET_CONFIG, 1024, 1, 4)}
# VGG-16's conv_fused shapes (n, h, w, c, cout) at its eval batch of 512
# and how many of its 12 sites run at each
VGG_FUSED_SITES = [((512, 224, 224, 64, 64), 1), ((512, 112, 112, 64, 128), 1),
                   ((512, 112, 112, 128, 128), 1),
                   ((512, 56, 56, 128, 256), 1), ((512, 56, 56, 256, 256), 2),
                   ((512, 28, 28, 256, 512), 1), ((512, 28, 28, 512, 512), 2),
                   ((512, 14, 14, 512, 512), 3)]
# ResNet-50's eval batch on its training path (validation and test.main,
# one batch of R50_BATCH): the served conv_pair and bn_act sites at 1024
R50_PAIR_SITES = [((R50_BATCH, *shape[1:]), count)
                  for shape, count in PAIR_SITES]
R50_ACT_SITES = [(f"r50 eval {site}", (R50_BATCH, *shape[1:]), 1)
                 for site, shape in ACT_SITES]
# VGG-16's bn_act site: the first conv (C = 3, cuDNN) at its eval batch
VGG_ACT_SITES = [("vgg16 conv", (512, 224, 224, 64), 1)]
# SmallNet (width 32) at its eval batch of 128 on CIFAR's 32x32: the six
# conv outputs that take bn_act under float32 (block 1 at 32², 2 at 16²,
# 3 at 8²); under bf16 the first (C = 3) and conv_fused's five sites
# (n, h, w, c, cout)
SMALLNET_ACT_SITES = [
    ("smallnet f32 conv", (128, 32, 32, 32), 2, "float32"),
    ("smallnet f32 conv_2", (128, 16, 16, 64), 2, "float32"),
    ("smallnet f32 conv_4", (128, 8, 8, 128), 2, "float32"),
    ("smallnet bf16 conv", (128, 32, 32, 32), 1, "bfloat16")]
SMALLNET_FUSED_SITES = [((128, 32, 32, 32, 32), 1),
                        ((128, 16, 16, 32, 64), 1),
                        ((128, 16, 16, 64, 64), 1),
                        ((128, 8, 8, 64, 128), 1),
                        ((128, 8, 8, 128, 128), 1)]
# DenseNet-121's largest bn_act sites (the stem's conv output and the first
# transition's BN, 822M elements each) and its smallest (the bottleneck
# epilogue of block 4's 16 layers) at the eval batch of 1024
DENSENET_ACT_SITES = [("densenet stem.conv", (1024, 112, 112, 64), 1),
                      ("densenet transition1.bn", (1024, 56, 56, 256), 1),
                      ("densenet block4 bn_1", (1024, 7, 7, 128), 16)]
# BASELINE config #4, DeepLabv3+ on ResNet-50 at output_stride 16
# (configs/voc_deeplabv3plus.py): the recipe as written through train.main
# and test.main, which a synthetic run shrinks to 96 x 96 crops (64 rendered
# pairs a split, 4 eval batches of 16), and the recipe's own 513 x 513
# crops of 512 x 512 frames at its batch of 16, built from its parts
VOC_CONFIG = os.path.join(ROOT, "configs", "voc_deeplabv3plus.py")
SEG_BATCH, SEG_HW, SEG_RAW = 16, (513, 513), (512, 512)
SEG_STEPS, SEG_VAL_EVERY, SEG_SPLIT = 10, 5, 64
SEG_SCALES = (0.75, 1.0, 1.25)
# the sides test.main --scales feeds the model: SEG_SCALES of the 96 x 96
# frames (72, 96, 120)
SEG_SCALE_HW = tuple(int(round(96 * s)) for s in SEG_SCALES)
# step 1 on the card against the host: at 2 images the pooling branch's BN
# normalizes each channel over two values (a sign; tests/test_torch_deeplab
# .py), so step 1 takes 4
SEG_STEP1_BATCH = 4
# ... at crops of SEG_STEP1_HW, the host's float32 and bf16 passes a
# quarter of the minutes of its CPU they took at 513 x 513
SEG_STEP1_HW = (257, 257)
# eval images held card against host: at 96 x 96 (test.main's) and 513
SEG_CHECK_N, SEG_CHECK_N_513 = 4, 1


# BASELINE config #5, the GAN recipes as written through train.main:
# DCGAN (configs/dcgan_cifar10.py: float32, batch 128, 32x32, G base 256,
# D base 64) with a 16-sample grid every 10 steps, then generate.main's
# grid of 64; pix2pix (configs/pix2pix.py: bf16, batch 16, 256x256, U-Net
# of 8 levels, 70x70 PatchGAN) on 64 rendered pairs a split, then
# test.main (4 val batches of 16); GAN_STEPS steps each, a log line and a
# checkpoint every GAN_LOG_EVERY
DCGAN_CONFIG = os.path.join(ROOT, "configs", "dcgan_cifar10.py")
PIX2PIX_CONFIG = os.path.join(ROOT, "configs", "pix2pix.py")
GAN_STEPS, GAN_LOG_EVERY = 20, 10
DCGAN_BATCH, DCGAN_SAMPLES, DCGAN_GRID = 128, 16, 64
# the DCGAN sampler artifact's batch (the export phase; export_batch's
# default)
EXPORT_GAN_BATCH = 4
PIX2PIX_BATCH, PIX2PIX_SPLIT = 16, 64
# pix2pix eval images held card against host (the host's bf16 U-Net at
# 256x256 is the slow side)
PIX2PIX_CHECK_N = 2
# B2's launches a train step (the rescale of each uint8 batch)
GAN_B2_PER_STEP = {"dcgan": 1, "pix2pix": 2}
GAN_INPUT_SHAPES = {"dcgan": (DCGAN_BATCH, 32, 32, 3),
                    "pix2pix": (PIX2PIX_BATCH, 256, 256, 3)}


def dcgan_sites(n):
    """B1's sites in one DCGAN eval forward of n samples (ReLU, float32):
    bn_project and the two deconv BNs."""
    return [("bn_project", (n, 4, 4, 256)), ("bn", (n, 8, 8, 128)),
            ("bn_1", (n, 16, 16, 64))]


def unet_sites(n):
    """B1's sites in one pix2pix U-Net eval forward of n images (bf16):
    the six encoder BNs (leaky ReLU), the seven decoder BNs (ReLU)."""
    def feats(i):
        return min(64 << (i - 1), 512)
    return ([(f"enc{i}/bn", (n, 256 >> i, 256 >> i, feats(i)), "leaky_relu")
             for i in range(2, 8)]
            + [(f"dec{i + 1}/bn", (n, 256 >> i, 256 >> i, feats(i)), "relu")
               for i in range(7, 0, -1)])


def deeplab_sites(n, hw):
    """The kernels' sites in one bf16 eval forward of DeepLabv3+ on an
    hw x hw input at batch n (SAME: each stride 2 halves a side, rounding
    up): conv_pair (n, h, w, cin, cm, cout) and conv_fused (n, h, w, c,
    cout) shapes with their counts, bn_act (site, [n, h, w, c], count)."""
    def half(v):
        return -(-v // 2)
    s = half(hw)     # the stem conv's output
    q = half(s)      # stage 1 (after the max-pool), the low-level map
    r = half(q)      # stage 2
    t = half(r)      # stages 3 and 4 and the ASPP (output_stride 16)
    pair = [((n, q, q, 64, 64, 64), 1), ((n, q, q, 256, 64, 64), 2),
            ((n, r, r, 512, 128, 128), 3), ((n, t, t, 1024, 256, 256), 5)]
    fused = [((n, q, q, 304, 256), 1), ((n, q, q, 256, 256), 1)]
    act = [("stem.conv", (n, s, s, 64), 1),
           ("stage2.block1.conv_a", (n, q, q, 128), 1),
           ("stage2.block1.conv_b", (n, r, r, 128), 1),
           ("stage3.block1.conv_a", (n, r, r, 256), 1),
           ("stage3.block1.conv_b", (n, t, t, 256), 1),
           ("stage4 conv_a, conv_b", (n, t, t, 512), 6),
           ("aspp_1x1, aspp_rate*, aspp_project", (n, t, t, 256), 5),
           ("aspp_pool", (n, 1, 1, 256), 1),
           ("decoder.low_level_project", (n, q, q, 48), 1)]
    return pair, fused, act


# the ConvNet API phase: (a) the ResNet-50 recipe at full width with the
# EMA of configs/imagenet_mobilenet_v3.py:26, lookahead (its defaults) and
# the random erasing of configs/imagenet_resnext50.py:35; (b) the CIFAR-100
# ResNet-18 with SAM, reduce-on-plateau and the stem frozen, then the
# focal loss
API_R50_SETS = [f"accum_steps={R50_ACCUM}", f"synthetic_n={R50_BATCH}",
                "optimizer.ema_decay=0.9999", "optimizer.lookahead=True",
                "erase_prob=0.25"]
API_R50_STEPS, API_R50_VAL_EVERY, TEN_CROP_VIEWS, API_TTA_CHECK_N = \
    4, 2, 10, 8
API_R18_SETS = ["sam_rho=0.05", "optimizer.plateau=True",
                "plateau_factor=0.5", "plateau_patience=1",
                "optimizer.freeze=['stem']"]
API_R18_STEPS, API_R18_VAL_EVERY, API_FOCAL_STEPS = 20, 5, 4
# a flip-TTA batch of the CIFAR-100 ResNet-18: one normalize, two forwards
FLIP_EVAL_BATCH = {"normalize_u8": 1, "conv_fused": 10, "bn_act": 8}
# SAM's step does a second forward and backward: its device time over the
# plain step's is at least this
SAM_MIN_RATIO = 1.3
# Image files: corpora built by copying (hard-linking) the committed
# fixtures of tests/fixtures/torch_io (eight ImageNet-like JPEGs, four VOC
# image/palette-mask pairs, two combined pix2pix pairs).  ResNet-50 trains
# on an ImageNet layout of FILES_CLASSES class directories, FILES_TRAIN
# train and FILES_VAL val files, at the recipe's 1024 as 2 x 512 (its
# validation and test.main: one eval batch of FILES_VAL); DeepLabv3+ on a
# VOCdevkit layout (VOC_FILES_TRAIN and VOC_FILES_VAL ids, the fixtures in
# turn) at its 513 x 513 crop, batch 16; pix2pix on a combined layout of
# PAIRS_FILES_TRAIN images with the generator's EMA, then generate.main
# --input over GENERATE_INPUTS images, with and without --ema.
FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_io")
# (FILES_STEPS is 2, to keep the script inside its time with the export,
# Swin, self-supervised, zoo and representation phases)
FILES_CLASSES, FILES_TRAIN, FILES_VAL, FILES_STEPS = 1000, 2048, 512, 2
# steps of a file run left out of its rate (the first cuDNN plans, the
# prefetcher filling)
FILES_WARMUP = 3
# the file-fed loop (and its in-memory control): warm-up steps, then steps
# once plain and once under torch.profiler (one step of each keeps the
# script inside its time)
FED_WARMUP, FED_STEPS = 1, 1
R50_FILES_PAIR_SITES = [((FILES_VAL, *shape[1:]), count)
                        for shape, count in PAIR_SITES]
R50_FILES_ACT_SITES = [(f"r50 files eval {site}", (FILES_VAL, *shape[1:]), 1)
                       for site, shape in ACT_SITES]
VOC_FILES_TRAIN, VOC_FILES_VAL, VOC_FILES_BATCH, VOC_FILES_STEPS = \
    160, 32, 16, 10
PAIRS_FILES_TRAIN, PAIRS_FILES_STEPS, GENERATE_INPUTS = 32, 10, 16
# the host decode budget: this many fixture JPEGs at the ImageNet recipe's
# raw 256 x 256, over 1, 8 and all threads
BUDGET_IMAGES, BUDGET_HW, BUDGET_THREADS = 512, (256, 256), (1, 8)
IMAGE_ROUTE_REQUESTS = 3
# C6: Trainer.evaluate over EVAL_TAIL_SPLIT images at the CIFAR-100
# ResNet-18's batch of 128 (a tail of 64)
EVAL_TAIL_SPLIT = 192
# The zoo phase (step 27): the grouped and depthwise families' recipes as
# written, at full width from their seeds, on synthetic splits: name (the
# registry's) -> (config, batch, microbatches, train steps, the val
# split's images).  A batch the card does not hold in one pass runs as
# microbatches (``accum_steps``, the ResNet-50 recipe's cut: ResNeXt-50's
# 512 images a microbatch peaked at 32.0 GiB on an H100 80GB).  The val
# split is one eval batch (two of WRN-28-10's 128).
ZOO_RECIPES = {
    "resnext50_32x4d": ("imagenet_resnext50.py", 1024, 2, 2, 1024),
    "wrn_28_10": ("cifar10_wrn28_10.py", 128, 1, 2, 256),
    "mobilenet_v2": ("imagenet_mobilenet_v2.py", 1024, 1, 2, 1024),
    "mobilenet_v3_large": ("imagenet_mobilenet_v3.py", 1024, 1, 2, 1024),
    "efficientnet_b0": ("imagenet_efficientnet_b0.py", 1024, 1, 2, 1024),
    "repvgg_a0": ("imagenet_repvgg_a0.py", 256, 1, 2, 256),
}
# the CIFAR recipe's input kernels: (a train step's, an eval batch's)
ZOO_INPUT = {"wrn_28_10": ({"pad_crop_u8": 1}, {"normalize_u8": 1})}
# each zoo path's launches of one bf16 eval forward, as ROADMAP B lists
# them; the shapes come from the models themselves (``zoo_sites``)
ZOO_FORWARD = {"resnext50_32x4d": {"bn_act": 33},
               "wrn_28_10": {"conv_fused": 10, "bn_act": 15},
               "mobilenet_v2": {"bn_act": 35},
               "mobilenet_v3_large": {"bn_act": 11},
               "efficientnet_b0": {}, "repvgg_a0": {},
               "resnet101": {"conv_pair": 30, "bn_act": 7},
               "resnet152": {"conv_pair": 47, "bn_act": 7},
               "se_resnet50": {"conv_pair": 13, "bn_act": 7},
               "repvgg_a0_deploy": {"conv_fused": 17, "bn_act": 5}}
# the deep ResNets' served forwards (seeded JAX-layout weights, BN folded,
# bf16) at the served batch
ZOO_SERVED = ("resnet101", "resnet152", "se_resnet50")
# RepVGG-A0's reparameterized artifact, as the export phase's cases
ZOO_EXPORT = {"repvgg_a0": (
    os.path.join(ROOT, "configs", "imagenet_repvgg_a0.py"), "classify",
    ZOO_FORWARD["repvgg_a0_deploy"], BATCH, ["synthetic_n=8"])}
# The seg_family phase: configs/voc_unet.py and configs/voc_pspnet.py as
# written (full width, bf16, their crops of SEG_RAW frames, batch 16 in
# one pass): step 1 on the card against the host (at SEG_FAMILY_STEP1's
# crop and batch: the host's float32 and bf16 passes at the full crops
# would take minutes of its CPU), the step's rate, an eval forward of
# SEG_FAMILY_EVAL frames and a segment route's image request at that
# route batch (launches held by shape to the model's own sites, logits
# card against host); then DeepLabv3+ on Xception-65 at 513 x 513, one
# eval forward of SEG_FAMILY_EVAL.  name -> (config, crop)
SEG_FAMILY = {
    "unet": ("voc_unet.py", (512, 512)),
    "pspnet": ("voc_pspnet.py", (473, 473)),
}
SEG_FAMILY_BATCH, SEG_FAMILY_EVAL = 16, 4
# step 1's (crop, batch): U-Net's BN in train mode over 2 x 192 x 192
# pixels, PSPNet's pyramid BN at one bin over 4 values (DeepLab's reason
# for 4, SEG_STEP1_BATCH)
SEG_FAMILY_STEP1 = {"unet": ((192, 192), 2), "pspnet": ((193, 193), 4)}
DEEPLAB_X_KW = dict(backbone="xception")
# The zoo_rest phase: the six classifiers through the ImageNet recipe
# (configs/imagenet_resnet50.py, bf16) with --set model=<name>: the train
# step's rate at ZOO_REST_BATCH, a served call of BATCH (seeded
# JAX-layout weights, BN folded) held by shape, its logits against the
# host's; then the optimizers: one Adagrad step and three Shampoo steps
# (the preconditioner refreshed and applied on steps 2 and 3) of the
# CIFAR-100 ResNet-18 recipe (configs/cifar100_resnet18.py) with the
# optimizer replaced, each step card against host (optimizer_steps).
# name -> input size
ZOO_REST = {"inception_v3": (299, 299), "xception65": (224, 224),
            "convnext_tiny": (224, 224), "convnext_small": (224, 224),
            "squeezenet": (224, 224), "alexnet": (224, 224)}
ZOO_REST_BATCH = 128
ZOO_REST_OPTIMIZERS = {
    "adagrad": (dict(name="adagrad", lr=0.1, weight_decay=5e-4,
                     wd_exclude_norms=True), 1),
    "shampoo": (dict(name="shampoo", lr=0.1, momentum_coef=0.9,
                     precond_every=1, start_step=1, weight_decay=5e-4,
                     wd_exclude_norms=True), 3)}
# each parameter's update on the card against the host's from the same
# state and gradients, ||diff|| / ||host||: float32 on both (the card's
# matmuls without TF32), so only the summation orders and the two eigh
# routines differ: 3.2e-8 for Adagrad, up to 6.8e-3 for Shampoo on an
# NVIDIA H100 (logits/w: after two steps its R [100, 100] has ten
# eigenvalues below 1e-5 of a largest 1.13, within float32 eigh's reach
# of eps, where (lambda + eps)^(-1/4) weighs most); Shampoo's update
# without its preconditioner misses by 0.52-0.63 (optimizer_steps'
# control)
OPT_UPDATE_RTOL = 5e-2
# the paths of conv_pair, bn_act and conv_fused: the runs whose launches
# each path counts and the ``path`` of the rows that hold its shapes
KERNEL_PATH_RUNS = {
    "resnet50_serve": ("serve",),
    "resnet18_cifar": ("train", "test"),
    "resnet50_train": ("resnet50_train", "resnet50_test"),
    "smallnet_f32": tuple(f"smallnet_{run.replace(' ', '_')}_{part}"
                          for run, _, sets, _, _ in SMALLNET_RUNS
                          if "precision=bf16" not in sets
                          for part in ("train", "test")),
    "smallnet_bf16": ("smallnet_cifar10_bf16_train",
                      "smallnet_cifar10_bf16_test"),
    "vgg16": ("vgg16_train", "vgg16_test"),
    "densenet121": ("densenet121_train", "densenet121_test"),
    "deeplab_96": ("deeplab_train", "deeplab_test"),
    "deeplab_scales": ("deeplab_test_scales",),
    "deeplab_513": ("deeplab_513_train", "deeplab_513_eval"),
    "dcgan": ("dcgan_train", "dcgan_generate"),
    "pix2pix": ("pix2pix_train", "pix2pix_test"),
    "resnet50_api": ("api_r50_train", "api_r50_ten_crop", "api_r50_average"),
    "resnet18_api": ("api_r18_train", "api_r18_flip", "api_r18_focal"),
    "resnet18_eval_tail": ("c6_evaluate",),
    "resnet50_files": ("files_r50_train", "files_r50_test"),
    "deeplab_files": ("files_deeplab_train", "files_deeplab_test"),
    "pix2pix_files": ("files_pix2pix_train", "files_pix2pix_generate"),
    "image_route": ("image_route",),
    **{f"routes_{kind}": tuple(f"routes_{kind}_{body}" for body in
                               ("json1", "json3", "image"))
       for kind in ("segment", "translate")},
    "routes_classify": ("routes_classify_lone", "routes_classify_concurrent"),
    "sngan_fid": ("sngan_train", "sngan_fid"),
    # the export phase: test --export, serve --artifact, the artifact and
    # the in-memory program on one batch of wire rows (the route process's
    # request is on export_route)
    **{f"export_{name}": tuple(f"export_{name}_{part}" for part in (
        "export", "serve", "artifact", "memory"))
       for name in ("resnet50", "deeplab", "pix2pix", "dcgan")},
    "export_route": ("export_route",),
    # the SimCLR probes: SmallNet's eval forward at 128, ResNet-50's at
    # SIMCLR_R50_BATCH
    "simclr_smallnet": ("simclr_cifar_train", "simclr_cifar_test"),
    "simclr_resnet50": ("simclr_r50_train", "simclr_r50_test"),
    # the zoo phase: each recipe's train.main and test.main, the deep
    # ResNets' served forwards and RepVGG-A0's artifact runs
    **{f"zoo_{name}": (f"zoo_{name}_train", f"zoo_{name}_test")
       for name in ZOO_RECIPES},
    **{f"zoo_{name}": (f"zoo_{name}_serve",) for name in ZOO_SERVED},
    "export_repvgg_a0": tuple(f"export_repvgg_a0_{part}" for part in (
        "export", "serve", "artifact", "memory")),
    # the seg_family phase: each segmenter's eval forward and route call,
    # DeepLab-Xception's eval forward; the zoo_rest phase's served calls
    **{f"seg_{name}": (f"seg_{name}_eval", f"seg_{name}_route")
       for name in SEG_FAMILY},
    "seg_deeplab_xception": ("seg_deeplab_xception_eval",),
    **{f"zoo_rest_{name}": (f"zoo_rest_{name}_serve",)
       for name in ZOO_REST}}
# the file phases' runs (a run of a phase the machine cannot run counts 0)
FILE_RUNS = ("c6_evaluate", "files_r50_train", "files_r50_test",
             "files_deeplab_train", "files_deeplab_test",
             "files_pix2pix_train", "files_pix2pix_generate", "image_route")
# a path whose forwards run at several sizes: the ``path`` of the rows
# that hold its shapes (one row set a size)
PATH_ROWS = {"deeplab_scales": tuple(f"deeplab_{hw}" for hw in SEG_SCALE_HW),
             # the API runs' forwards are at the rows of these paths
             "resnet50_api": ("resnet50_train",),
             "resnet18_api": ("resnet18_cifar",),
             "resnet18_eval_tail": ("resnet18_cifar",),
             "deeplab_files": ("deeplab_513",),
             "pix2pix_files": ("pix2pix",),
             "image_route": ("resnet50_serve",),
             "routes_classify": ("resnet50_serve",),
             # the FID run: the SN-GAN sampler's chunks of 64 (DCGAN's
             # generator widths) and the extractor's ResNet-18 features
             "sngan_fid": (f"dcgan_{DCGAN_GRID}", "sngan_fid"),
             "dcgan": (f"dcgan_{DCGAN_SAMPLES}", f"dcgan_{DCGAN_GRID}"),
             # the artifacts' batches are the served and the routes' ones
             "export_resnet50": ("resnet50_serve",),
             "export_deeplab": ("routes_segment",),
             "export_route": ("routes_segment",),
             "export_pix2pix": ("routes_translate",),
             "export_dcgan": (f"dcgan_{EXPORT_GAN_BATCH}",),
             "export_pwcnet": ("routes_flow",),
             "simclr_smallnet": ("smallnet_f32",),
             # the artifact's batch is the served one
             "export_repvgg_a0": ("zoo_repvgg_a0_deploy",)}
# The routes phase: one HTTP server on localhost with a route of each kind
# at full width from seeded JAX-layout weights, every route behind the
# micro-batcher (ROUTE_WINDOW_MS): segment (configs/voc_deeplabv3plus.py at
# 513 x 513, bf16), translate (configs/pix2pix.py's U-Net at 256 x 256,
# bf16) and flow (configs/chairs_pwcnet.py at 384 x 512, bf16) at a route
# batch of ROUTE_BATCH, and the served ResNet-50 (classify, batch 8).  The
# image routes take JSON bodies of 1 and 3 images and an image body (a
# fixture JPEG, B2 once on the card), flow JSON bodies of 1 and 3 pairs;
# each request is one device call with these launches:
ROUTE_BATCH, ROUTE_WINDOW_MS = 4, 250.0
ROUTE_CONFIGS = {"segment": VOC_CONFIG, "translate": PIX2PIX_CONFIG,
                 "flow": PWC_CONFIG, "classify": CONFIG}
ROUTE_PER_CALL = {"segment": {"conv_pair": 11, "conv_fused": 2,
                              "bn_act": 18},
                  "translate": {"bn_act": 13},
                  "flow": {"correlation_fwd": PWC_LEVELS},
                  "classify": PER_CALL}
# ROUTE_CONCURRENT one-image classify requests (image bodies) at once
# become one device call; a lone request's p50 over ROUTE_LATENCY_ITERS
# with and without the window.  The burst runs under ROUTE_BURST_WINDOW_MS:
# its requests reach the batcher over a few hundred ms of a shared host's
# time, and at the served 250 ms a slow host split them into two device
# calls, which tests the host's scheduling rather than the batching.
ROUTE_CONCURRENT, ROUTE_LATENCY_ITERS = 8, 10
ROUTE_BURST_WINDOW_MS = 2000.0
# each route on the card against the same route on the host (plain
# versions, one request of 1 image at a route batch of 1): segment
# confidences within SEG_CONF_TOL and at most SEG_CLASS_FRAC of the pixels'
# classes differing; translate outputs (in [0, 1]) within LOGIT_REL_TOL,
# flows within FLOW_REL_TOL of their largest
SEG_CONF_TOL, SEG_CLASS_FRAC = 0.05, 0.05
# The sngan_fid phase: configs/sngan_cifar10.py as written (D with spectral
# norm, hinge loss, Adam b1 = 0) through train.main for SNGAN_STEPS steps
# of SNGAN_BATCH; after them every SN layer's normalized weight has its
# spectral norm in SN_BAND (the vector has had two power iterations a
# step: 1.0-1.03 after 40 at fixed weights on the host); then test.main
# --fid over FID_SAMPLES a side through the CIFAR-100 ResNet-18 of the
# CIFAR phase, the card's FID within FID_RTOL of the host's over the same
# features (the CPU parity test's bound at N < D against JAX)
SNGAN_CONFIG = os.path.join(ROOT, "configs", "sngan_cifar10.py")
SNGAN_BATCH, SNGAN_STEPS, FID_SAMPLES = 64, 20, 256
SN_BAND, FID_RTOL = (0.999, 1.10), 2e-4
# The export phase: each task kind the port exports, at full width from
# the recipe as written (weights from its seed), through the entry points
# as users run them: a checkpoint, ``test --export`` (traced with fake
# tensors: no launch), one ``serve --artifact`` run in the kind's mode (one
# device call of EXPORT_CASES' launches; the artifact's batch), the
# artifact against the route program built in memory from the same
# checkpoint on the same wire rows (the same launches by shape, the same
# bits), and (EXPORT_LATENCY_SIZES) ``serve --artifact --latency --sizes
# 1,8`` beside the in-memory program's latency at the artifact's one
# batch.  name ->
# (config, kind, launches a call, the artifact's batch, the recipe's
# synthetic splits cut to a few items: test --export builds them beside
# the net and reads none)
EXPORT_CASES = {
    "resnet50": (CONFIG, "classify", PER_CALL, BATCH, ["synthetic_n=8"]),
    "vit_b16": (VIT_CONFIG, "classify", {"flash_attention_fwd": VIT_DEPTH},
                BATCH, ["synthetic_n=8"]),
    # Swin-T: plain ops only (its window attention takes no flash kernel)
    "swin_t": (SWIN_CONFIG, "classify", {}, BATCH, ["synthetic_n=8"]),
    "deeplab": (VOC_CONFIG, "segment", ROUTE_PER_CALL["segment"],
                ROUTE_BATCH, []),
    "pix2pix": (PIX2PIX_CONFIG, "translate", ROUTE_PER_CALL["translate"],
                ROUTE_BATCH, ["synthetic_n=4"]),
    "dcgan": (DCGAN_CONFIG, "sample", {"bn_act": 3}, EXPORT_GAN_BATCH, []),
    "pwcnet": (PWC_CONFIG, "flow", ROUTE_PER_CALL["flow"], ROUTE_BATCH,
               ["synthetic_n=4"])}
EXPORT_SIZES = (1, 8)
# the artifacts whose latency the phase measures: the served ResNet-50's
# (the other kinds' latency runs, ~25 s, and RepVGG-A0's deploy stack's
# are left out to keep the script inside its time with the zoo, zoo_rest
# and representation phases)
EXPORT_LATENCY_SIZES = {"resnet50": EXPORT_SIZES}
# the artifact against the in-memory program: bit for bit, but DCGAN's
# float32 [0, 1] images within 4 ulps of 1.0 (its transposed convs go
# through cuDNN's backward-data algorithms, whose choice and order the
# exported graph and the eager module need not share; 1 ulp apart on an
# H100)
EXPORT_TOL = {"dcgan": 2 ** -22}
# conv_pair in ``--compare``: shapes whose plans have a pass of a single
# 64x64 tile (the served 7x7 at batch 8 and 1, DeepLab's 12², 9², 6² and
# 5² at batch 16) and two whose plans have none
COMPARE_PAIR_SHAPES = [(8, 7, 7, 2048, 512, 512), (1, 7, 7, 2048, 512, 512),
                       (16, 12, 12, 512, 128, 128), (16, 9, 9, 512, 128, 128),
                       (16, 6, 6, 1024, 256, 256), (16, 5, 5, 1024, 256, 256),
                       (8, 56, 56, 64, 64, 64), (16, 33, 33, 1024, 256, 256)]
# launches a kernel row times (3 at maps of over 1M pixels a channel too),
# few enough to keep the script inside its time with every phase
ROW_ITERS = 3
# peak rates of the H100 SXM (NVIDIA's data sheet): HBM bytes/s, dense
# bf16 tensor-core and float32 FLOP/s
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
SOURCES = {"conv_pair": ("myconvnet_tpu_torch/csrc/conv_pair.cu",
                         "myconvnet_tpu/ops/pallas/conv_pair.py:101"),
           "bn_act": ("myconvnet_tpu_torch/csrc/bn_act.cu",
                      "myconvnet_tpu/ops/pallas/bn_act.py:48"),
           "normalize_u8": ("myconvnet_tpu_torch/csrc/normalize_u8.cu",
                            "myconvnet_tpu/ops/pallas/normalize_u8.py:34"),
           "pad_crop_u8": ("myconvnet_tpu_torch/csrc/pad_crop_u8.cu",
                           "myconvnet_tpu/ops/pallas/pad_crop_u8.py:68"),
           "conv_fused": ("myconvnet_tpu_torch/csrc/conv_fused.cu",
                          "myconvnet_tpu/ops/pallas/conv_fused.py:82"),
           "flash_attention_fwd": (
               "myconvnet_tpu_torch/csrc/flash_attention.cu",
               "myconvnet_tpu/ops/pallas/flash_attention.py:108"),
           "flash_attention_dq": (
               "myconvnet_tpu_torch/csrc/flash_attention.cu",
               "myconvnet_tpu/ops/pallas/flash_attention.py:153"),
           "flash_attention_dkv": (
               "myconvnet_tpu_torch/csrc/flash_attention.cu",
               "myconvnet_tpu/ops/pallas/flash_attention.py:161"),
           "shear_rows": ("myconvnet_tpu_torch/csrc/affine.cu",
                          "myconvnet_tpu/ops/pallas/affine.py:92"),
           "randaugment_ew": (
               "myconvnet_tpu_torch/csrc/randaugment_ew.cu",
               "myconvnet_tpu/ops/pallas/randaugment_ew.py:109"),
           # the Pallas kernel is forward-only; its XLA op's gradient is
           # what the two backward kernels replace
           **{name: ("myconvnet_tpu_torch/csrc/correlation.cu",
                     "myconvnet_tpu/ops/pallas/correlation.py:67")
              for name in CORR}}


def log(*a):
    print(*a, flush=True)


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


def cuda_ms(fn, iters=10, warmup=2, sleep_cycles=5_000_000):
    """Device ms per call of ``fn``.  A sleep kernel holds the stream while
    the host enqueues every call, so the events time the launches back to
    back on the device, not the host's launch rate (a small kernel takes
    less time on the card than its Python wrapper takes on the host)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    if start.query():  # the device caught up with the host: sleep longer
        torch.cuda.synchronize()
        if sleep_cycles >= 10 ** 9:
            raise RuntimeError("the host enqueues too slowly to time fn")
        return cuda_ms(fn, iters, 0, 4 * sleep_cycles)
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn):
    """Device ms per call of ``fn`` for a plain version of hundreds of
    small launches: more than CUDA's launch queue takes behind a held
    stream, and the card runs them faster than the host enqueues them.  The
    call is captured once as a CUDA graph and its replays are timed as
    ``cuda_ms`` times a kernel (timing only; the port replays no graph)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        kept = fn()  # the capture's outputs live as long as the graph
    ms = cuda_ms(graph.replay, iters=5, warmup=1)
    del kept, graph
    return ms


def host_samples(fn, iters, samples):
    """Host microseconds per call of ``fn`` (a kernel's wrapper: checks,
    tensor-map encoding, the launch), the device left to run behind: one
    reading a run of ``iters`` calls, each run started on an idle device,
    ``samples`` runs, sorted."""
    import torch
    fn()
    out = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        out.append((time.perf_counter() - t0) * 1e6 / iters)
    torch.cuda.synchronize()
    return sorted(out)


def host_us(fn, iters=50):
    """Host microseconds per call of ``fn``: one run of ``host_samples``."""
    return host_samples(fn, iters, 1)[0]


@contextlib.contextmanager
def staged(pc, mode):
    """pad_crop_u8 (the module ``pc``) launched with its planner's plan at
    staging ``mode`` ("copy" or "direct") in place of its own pick."""
    planned = pc._launch_plan
    pc._launch_plan = functools.lru_cache()(
        lambda *a: pc.launch_args(pc.plan(*a, mode=mode)))
    try:
        yield
    finally:
        pc._launch_plan = planned


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block.  A transposed
    conv runs as cuDNN's backward-data, whose default float32 algorithm
    on an H100 may sum in another order from one call to the next (the
    DCGAN generator against itself: 1-2 ulps, EXPORT_TOL), so two calls
    held bit for bit run here."""
    import torch
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = before


def compare(out, ref, rtol, atol):
    """(max |out - ref|, whether every element is within atol + rtol|ref|)."""
    import torch
    d = (out.float() - ref.float()).abs()
    ok = bool(torch.all(d <= atol + rtol * ref.float().abs()))
    return float(d.max()), ok


def bound(nbytes, ops, ops_rate):
    """(least ms the card needs, "bytes" or "operations"): bytes over the
    HBM rate against operations over their peak rate."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def taps(size):
    """Input positions a 3x3 SAME conv reads inside the frame along one
    axis of ``size`` (the padding taps multiply zeros)."""
    return 3 * size - 2 if size > 1 else 1


def pair_args(shape, g):
    """conv_pair's inputs at (n, h, w, cin, cm, cout) on g's device: the
    weights HWIO views of OIHW channels_last tensors, as ``nn.Conv`` holds
    them (the wrapper then copies nothing)."""
    import torch

    n, h, w, cin, cm, co = shape

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=g.device) * scale

    x = randn(n, h, w, cin).to(torch.bfloat16)
    w1 = randn(cm, 1, 1, cin, scale=cin ** -0.5).to(
        torch.bfloat16).permute(1, 2, 3, 0)
    w3 = randn(co, 3, 3, cm, scale=(9 * cm) ** -0.5).to(
        torch.bfloat16).permute(1, 2, 3, 0)
    s1, s3 = randn(cm).abs() + 0.5, randn(co).abs() + 0.5
    b1, b3 = randn(cm, scale=0.3), randn(co, scale=0.3)
    return x, w1, s1, b1, w3, s3, b3


def cudnn_pair_bf16(x, w1, s1, b1, w3, s3, b3):
    """The cuDNN bf16 pair with eager epilogues, for timing only."""
    import torch
    import torch.nn.functional as F

    def conv(v, w, pad):
        return F.conv2d(v.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                        padding=pad)
    y = torch.relu(conv(x, w1, 0) * s1[:, None, None]
                   + b1[:, None, None]).to(torch.bfloat16)
    z = torch.relu(conv(y.permute(0, 2, 3, 1), w3, 1)
                   * s3[:, None, None] + b3[:, None, None])
    return z.to(torch.bfloat16).permute(0, 2, 3, 1)


def pair_flip_slack(args, idx):
    """How far conv_pair's output may move at the elements ``idx`` ([k, 4]
    of n, h, w, c) when intermediate elements round to the other bf16
    neighbour: a float32 sum of Cin products lands within delta = (Cin + 2)
    2^-24 (|s1| sum |x w1| + |b1|) of its float64 value, so an element
    within delta of a rounding midpoint may take either neighbour, which
    moves the output by |s3 w3| times the step.  Float64 on the card."""
    import torch

    x, w1, s1, b1, w3, s3, _ = args
    n, h, w, c = idx.t()
    H, W, cin = x.shape[1:]
    taps = torch.arange(-1, 2, device=x.device)
    ys = (h[:, None] + taps.repeat_interleave(3)[None])          # [k, 9]
    xs = (w[:, None] + taps.repeat(3)[None])
    inside = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
    xv = x[n[:, None], ys.clamp(0, H - 1), xs.clamp(0, W - 1)].double()
    w1d, s1d, b1d = w1[0, 0].double(), s1.double(), b1.double()
    mid = (xv @ w1d) * s1d + b1d                                  # [k, 9, cm]
    delta = (cin + 2) * 2.0 ** -24 * ((xv.abs() @ w1d.abs()) * s1d.abs()
                                      + b1d.abs())

    def bf16(v):
        return torch.relu(v).to(torch.bfloat16).double()

    centre = bf16(mid)
    step = torch.maximum((bf16(mid + delta) - centre).abs(),
                         (centre - bf16(mid - delta)).abs())
    w3k = w3.double().permute(3, 0, 1, 2)[c].reshape(len(c), 9, -1)
    return ((step * w3k.abs()).sum(2) * inside).sum(1) \
        * s3.double()[c].abs()


# the kernel rows measured in this run, by (kernel, shape, dtype, act): a
# shape that several paths share is measured once and its row copied into
# each path (check_kernels empties it)
_ROWS: dict = {}


def _row_again(key, path, count, **fields):
    """The row already measured at ``key``, as a row of ``path`` with
    ``count`` sites (None if none is)."""
    if key not in _ROWS:
        return None
    r = dict(_ROWS[key], path=path, sites=count,
             measured_for=_ROWS[key]["path"], **fields)
    log(f"{key[0]} {path} {list(key[1])} x{count}: the row of "
        f"{r['measured_for']}'s shape")
    return r


def _keep_row(key, r):
    _ROWS[key] = r
    return r


# train.main runs whose checkpoints the export phase reuses: a phase moves
# its run directory here (keep_run) instead of deleting it, and
# export_case freezes that run's newest checkpoint rather than writing a
# fresh one (one checkpoint a family for its test, export and route
# checks; the export phase empties it)
KEPT = os.path.join(ROOT, "build", "chip_smoke_kept")


def keep_run(run_dir, name):
    """Move a finished run's directory to KEPT/``name`` (an EXPORT_CASES
    name)."""
    import shutil
    dst = os.path.join(KEPT, name)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(KEPT, exist_ok=True)
    os.replace(run_dir, dst)


def conv_pair_row(shape, count, path, g):
    """conv_pair at (n, h, w, cin, cm, cout) against its plain version,
    with its bound and plan, beside cuDNN's unfused bf16 pair: one row
    (``count`` sites of one forward of ``path``; a shape measured before
    in this run is that row again)."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import conv_pair

    key = ("conv_pair", tuple(shape), None, None)
    again = _row_again(key, path, count)
    if again is not None:
        return again
    n, h, w, cin, cm, co = shape
    args = pair_args(shape, g)
    out = conv_pair.conv1x1_conv3x3_bn_relu(*args)
    ref = conv_pair.conv_pair_reference(*args)
    torch.cuda.synchronize()
    err, ok = compare(out, ref, **TOL["conv_pair"])
    # an element outside the 2 ulps passes only where intermediate
    # elements near a rounding midpoint explain it (at most PAIR_OUTLIERS)
    d = (out.float() - ref.float()).abs()
    lim = TOL["conv_pair"]["atol"] + TOL["conv_pair"]["rtol"] * ref.float().abs()
    idx = (d > lim).nonzero()
    explained = 0
    if 0 < len(idx) <= PAIR_OUTLIERS:
        at = tuple(idx.t())
        explained = int((d[at].double() <= lim[at].double()
                         + pair_flip_slack(args, idx)).sum())
        ok = explained == len(idx)
    # images at the end of a large batch give the bits they give alone
    # (under the planner's geometry for 8 images: every geometry sums in
    # one order)
    plan = conv_pair.plan(n, h, w, cin, cm, co)
    alone = n <= 8 or torch.equal(conv_pair.conv1x1_conv3x3_bn_relu(
        args[0][-8:].contiguous(), *args[1:]), out[-8:])
    ok &= alone
    del out, ref, d, lim
    b_ms, b_by = bound(
        2 * n * h * w * (cin + co) + 2 * (cin * cm + 9 * cm * co)
        + 8 * (cm + co),
        2 * n * h * w * cin * cm + 2 * n * taps(h) * taps(w) * cm * co,
        BF16_FLOPS)
    iters = 3 if n * h * w > 10 ** 6 else ROW_ITERS
    row = dict(kernel="conv_pair", path=path, shape=list(shape),
               sites=count, max_abs_err=err, ok=ok, outside_2_ulps=len(idx),
               explained_by_rounding=explained, last_images_alone=alone,
               bound_ms=b_ms,
               bound_by=b_by, library_ms=None, plan=plan,
               ms=cuda_ms(lambda: conv_pair.conv1x1_conv3x3_bn_relu(*args),
                          iters),
               plain_ms=cuda_ms(lambda: conv_pair.conv_pair_reference(
                   *args), iters),
               cudnn_bf16_ms=cuda_ms(lambda: cudnn_pair_bf16(*args), iters),
               host_us=host_us(lambda: conv_pair.conv1x1_conv3x3_bn_relu(
                   *args)))
    log(f"conv_pair {path} {row['shape']} x{count} plan {row['plan']}: "
        f"max_abs_err={err:.3g} "
        f"(tol rtol={TOL['conv_pair']['rtol']:.3g} "
        f"atol={TOL['conv_pair']['atol']:.3g}; {len(idx)} of {n * h * w * co}"
        f" outside, {explained} of them within an intermediate's rounding"
        f"{'' if n <= 8 else f'; last 8 images alone bit-exact {alone}'})"
        f" ok={ok} "
        f"kernel={row['ms']:.4f}ms plain={row['plain_ms']:.4f}ms "
        f"cudnn_bf16_unfused={row['cudnn_bf16_ms']:.4f}ms "
        f"bound={b_ms:.4f}ms ({b_by}) "
        f"wrapper host time={row['host_us']:.1f}us a launch")
    return _keep_row(key, row)


def bn_act_row(site, x, a, b, count, path, act="relu", **extra):
    """bn_act (``act``, ReLU by default) on ``x`` against its plain
    version, with its bound and any ``extra`` yardsticks timed: one row
    (``count`` sites of one forward of ``path``; without ``extra``, a
    shape measured before in this run is that row again)."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import bn_act

    key = ("bn_act", tuple(x.shape), _name(x.dtype), act)
    if not extra:
        again = _row_again(key, path, count, site=site)
        if again is not None:
            return again

    out = bn_act.fused_scale_shift_act(x, a, b, act)
    ref = bn_act.scale_shift_act_reference(x, a, b, act)
    torch.cuda.synchronize()
    err, ok = compare(out, ref, **TOL["bn_act"])
    del out, ref
    b_ms, b_by = bound(2 * x.element_size() * x.numel() + 8 * x.shape[-1],
                       3 * x.numel(), F32_FLOPS)
    iters = 3 if x.numel() > 10 ** 9 else ROW_ITERS
    r = dict(kernel="bn_act", path=path, site=site, shape=list(x.shape),
             dtype=str(x.dtype).split(".")[-1], act=act, sites=count,
             max_abs_err=err, ok=ok, bound_ms=b_ms, bound_by=b_by,
             library_ms=None,
             ms=cuda_ms(lambda: bn_act.fused_scale_shift_act(
                 x, a, b, act), iters),
             plain_ms=cuda_ms(lambda: bn_act.scale_shift_act_reference(
                 x, a, b, act), iters),
             **{k: cuda_ms(f, iters) for k, f in extra.items()})
    log(f"bn_act {site} {r['shape']} {r['dtype']} {act} x{count}: "
        f"max_abs_err={err:.3g} (tol rtol={TOL['bn_act']['rtol']:.3g} "
        f"atol={TOL['bn_act']['atol']:.3g}) ok={ok} "
        + " ".join(f"{k}={r[k]:.4f}ms" for k in ("ms", "plain_ms", *extra))
        + f" bound={b_ms:.4f}ms ({b_by})")
    return r if extra else _keep_row(key, r)


def check_kernels(dev, plan=None):
    """Kernel vs plain at every slice shape (those of the file phases that
    ``plan`` runs too); returns the per-kernel summary (times summed over
    every row's sites: one forward of each path) and the details."""
    import torch

    g = torch.Generator(device=dev).manual_seed(SEED)
    _ROWS.clear()

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    details, summary = [], {}
    for shape, count in PAIR_SITES:
        details.append(conv_pair_row(shape, count, "resnet50_serve", g))
    for path, sites in (("resnet50_serve", ACT_SITES),
                        ("resnet18_cifar", ACT_SITES_R18)):
        for site, shape in sites:
            x = randn(*shape).to(torch.bfloat16)
            c = shape[-1]
            details.append(bn_act_row(site, x, torch.ones(c, device=dev),
                                      randn(c, scale=0.5), 1, path))
    details += check_cifar_kernels(dev, g)
    details += check_classifier_kernels(dev, g)
    details += check_flash_kernels(dev, g)
    details += check_randaugment_kernels(dev, g)
    details += check_correlation_kernels(dev, g)
    details += check_deeplab_kernels(dev, g)
    details += check_gan_kernels(dev, g)
    details += check_io_kernels(dev, g, plan or {})
    details += check_route_kernels(dev, g)
    details += check_ssl_kernels(dev, g)
    details += check_zoo_kernels(dev, g)
    details += check_seg_family_kernels(dev, g)
    details += check_repr_kernels(dev, g)
    details += check_det_kernels(dev, g)
    for name in SOURCES:
        rows = [r for r in details if r["kernel"] == name]
        on_path = [r for r in rows if r["sites"]]
        lib = [r["library_ms"] for r in on_path]
        summary[name] = dict(
            ok=all(r["ok"] for r in rows),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            ms=sum(r["ms"] * r["sites"] for r in rows),
            plain_ms=sum(r["plain_ms"] * r["sites"] for r in rows),
            bound_ms=sum(r["bound_ms"] * r["sites"] for r in rows),
            bound_by=max(on_path, key=lambda r: r["bound_ms"] * r["sites"]
                         )["bound_by"],
            library_ms=(None if None in lib else
                        sum(t * r["sites"] for t, r in zip(lib, on_path))))
    return summary, details


def sweep_conv_pair_plans(dev, g):
    """conv_pair at the served sites, batch 8 and 1, under every launch
    geometry from a small set (TH in 1-14, TW in 4, 7, 14, CS in 1-8) that
    the kernel takes, each against the plain version and bit-exact
    against the planner's plan (every geometry sums in one order), timed
    beside it.  Returns a row per shape and whether every launch
    agreed."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import conv_pair

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, all_ok = [], True
    for batch in (BATCH, 1):
        for (_, h, w, cin, cm, co), _ in PAIR_SITES:
            shape = (batch, h, w, cin, cm, co)
            args = pair_args(shape, g)
            ref = conv_pair.conv_pair_reference(*args)
            base = conv_pair.conv1x1_conv3x3_bn_relu(*args)

            def measure(tile):
                p = conv_pair.plan(*shape, tile=tile)
                out = conv_pair.conv1x1_conv3x3_bn_relu(*args, tile=tile)
                torch.cuda.synchronize()
                clusters = batch * -(-h // p["th"]) * -(-w // p["tw"])
                return dict(
                    tile=[p["th"], p["tw"], p["cs"]],
                    blocks=clusters * p["cs"],
                    clusters_at_once=p["clusters_at_once"],
                    waves=-(-clusters // max(p["clusters_at_once"], 1)),
                    ok=compare(out, ref, **TOL["conv_pair"])[1],
                    same_bits=bool(torch.equal(out, base)),
                    ms=cuda_ms(lambda: conv_pair.conv1x1_conv3x3_bn_relu(
                        *args, tile=tile)))

            planned = measure(None)
            tried = []
            for th in (1, 2, 3, 4, 5, 7, 8, 14):
                for tw in (4, 7, 14):
                    for cs in (1, 2, 4, 8):
                        if th > h or tw > w or cm % (16 * cs) \
                                or co % (16 * cs):
                            continue
                        try:
                            conv_pair.plan(*shape, tile=(th, tw, cs))
                        except RuntimeError:  # no room in shared memory
                            continue
                        tried.append(measure((th, tw, cs)))
            full = [t for t in tried if t["blocks"] >= sms]
            row = dict(shape=list(shape), plan=planned,
                       best=min(tried, key=lambda t: t["ms"]),
                       best_a_block_per_sm=(min(full, key=lambda t: t["ms"])
                                            if full else None),
                       tried=len(tried),
                       same_bits=sum(t["same_bits"] for t in tried),
                       ok=all(t["ok"] and t["same_bits"]
                              for t in [planned, *tried]))
            all_ok &= row["ok"]
            rows.append(row)
            log(f"conv_pair plans {shape}: plan {planned}; best of "
                f"{len(tried)} {row['best']}; best with >= {sms} blocks "
                f"{row['best_a_block_per_sm']}; {row['same_bits']} of "
                f"{len(tried)} bit-exact against the plan; all within "
                f"tolerance and bit-exact {row['ok']}")
    return rows, all_ok


def correlation_by_path(name, details, runs):
    """A correlation kernel's launches and times path by path: the launches
    of the path's runs beside the kernel, plain and bound ms of one train
    step of that path (its bf16 rows), so that both cover the same set."""
    out = {}
    for path, names in CORR_PATH_RUNS.items():
        rows = [r for r in details if r["kernel"] == name
                and r.get("path") in PATH_ROWS.get(path, (path,))
                and r["sites"]]
        launches = sum(runs[k][name] for k in names)
        if not rows and not launches:
            continue     # the flow route runs the forward only
        if not rows:
            raise AssertionError(f"{name} launched on {path} but held at "
                                 "none of its shapes")
        out[path] = dict(
            launches=launches,
            **{k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms")},
            bound_by=max(rows, key=lambda r: r["bound_ms"])["bound_by"])
    return out


def input_kernel_inputs(case, dev, g):
    """(images, offsets, flip, mean, std, out dtype, pad) of an INPUT_CASES
    row on ``dev``: seeded images, offsets in [-pad, pad], flips on half the
    images (none where the case has no flip)."""
    import torch

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.data.augment import stats
    _, shape, dtype, pad, flips, mean_std, _ = case
    n = shape[0]
    x = torch.randint(0, 256, shape, generator=g, device=dev,
                      dtype=torch.uint8)
    off = torch.randint(-pad, pad + 1, (n, 2), generator=g, device=dev,
                        dtype=torch.int32)
    flip = (torch.rand(n, generator=g, device=dev) < 0.5) & flips
    if mean_std is None:
        mean, std = stats(recipes.make_augment(
            recipes.load_config(CIFAR_CONFIG)["augment"]), dev)
    else:
        mean, std = (torch.tensor(v, device=dev) for v in mean_std)
    return x, off, flip, mean, std, getattr(torch, dtype), pad


def input_bytes(kernel, x, out_dtype):
    """Bytes an input kernel must move: x read once, y written once, mean
    and std (and pad_crop_u8's offsets and flips) read once."""
    import torch
    n, c = x.shape[0], x.shape[-1]
    out = torch.empty((), dtype=out_dtype).element_size()
    extra = 8 * c + (9 * n if kernel == "pad_crop_u8" else 0)
    return x.numel() * (1 + out) + extra


def check_cifar_kernels(dev, g):
    """normalize_u8 and pad_crop_u8 against their plain versions at every
    INPUT_CASES row (the CIFAR recipe's shape on the main path; the rest
    design checks, sites 0), each with its bound, plan, wrapper host time,
    and for normalize_u8 at float32 one ``torch.addcmul`` as the library
    time and two yardsticks of PyTorch's own streams over the output
    (``torch_fill_ms``: a write of it; ``torch_copy_ms``: the uint8 images
    cast into it, the kernel's bytes less mean and std); pad_crop_u8 at the recipe's
    shape also with each staging mode forced; then conv_fused at the
    recipe's sites.  One row per shape."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import normalize_u8, pad_crop_u8

    def row(kernel, shape, sites, out, ref, fn, plain_fn, nbytes, ops,
            rate, iters=20, library=None, **extra):
        torch.cuda.synchronize()
        err, ok = compare(out, ref, **TOL[kernel])
        b_ms, b_by = bound(nbytes, ops, rate)
        r = dict(kernel=kernel, shape=list(shape), sites=sites,
                 max_abs_err=err, ok=ok, bound_ms=b_ms, bound_by=b_by,
                 library_ms=library and cuda_ms(library, iters),
                 ms=cuda_ms(fn, iters), plain_ms=cuda_ms(plain_fn),
                 **{k: cuda_ms(f, iters) for k, f in extra.items()})
        log(f"{kernel} {r['shape']} x{sites}: max_abs_err={err:.3g} "
            f"(tol rtol={TOL[kernel]['rtol']:.3g} "
            f"atol={TOL[kernel]['atol']:.3g}) ok={ok} "
            + " ".join(f"{k}={r[k]:.5f}ms" for k in
                       ("ms", "plain_ms", "bound_ms", *extra))
            + ("" if library is None else
               f" library_ms={r['library_ms']:.5f}ms"))
        return r

    rows = []
    for case in INPUT_CASES:
        name, shape, _, _, _, _, main = case
        x, off, flip, mean, std, dt, pad = input_kernel_inputs(case, dev, g)
        sites = 1 if main else 0
        scale, shift = normalize_u8.scale_shift(mean, std, dev)
        y = torch.empty(shape, dtype=dt, device=dev)
        rows.append(row(
            "normalize_u8", shape, sites,
            normalize_u8.normalize_u8(x, mean, std, dt),
            normalize_u8.normalize_u8_reference(x, mean, std, dt),
            lambda: normalize_u8.normalize_u8(x, mean, std, dt),
            lambda: normalize_u8.normalize_u8_reference(x, mean, std, dt),
            input_bytes("normalize_u8", x, dt), 2 * x.numel(), F32_FLOPS,
            iters=100, library=(lambda: torch.addcmul(shift, x, scale))
            if dt == torch.float32 else None,
            **({} if dt != torch.float32 else dict(
                torch_fill_ms=lambda: y.fill_(0.5),
                torch_copy_ms=lambda: y.copy_(x)))))
        del y
        rows[-1].update(
            case=name, out_dtype=str(dt).split(".")[-1],
            plan=normalize_u8.plan(x.numel(), shape[-1], dt),
            host_us=host_us(lambda: normalize_u8.normalize_u8(
                x, mean, std, dt)))
        args = (x, off, flip, mean, std)
        kw = dict(pad=pad, out_dtype=dt)
        rows.append(row(
            "pad_crop_u8", shape, sites,
            pad_crop_u8.pad_crop_flip_normalize(*args, **kw),
            pad_crop_u8.pad_crop_reference(*args, **kw),
            lambda: pad_crop_u8.pad_crop_flip_normalize(*args, **kw),
            lambda: pad_crop_u8.pad_crop_reference(*args, **kw),
            input_bytes("pad_crop_u8", x, dt), 2 * x.numel(), F32_FLOPS,
            iters=100))
        rows[-1].update(
            case=name, out_dtype=str(dt).split(".")[-1],
            plan=pad_crop_u8.plan(*shape, dt),
            host_us=host_us(lambda: pad_crop_u8.pad_crop_flip_normalize(
                *args, **kw)))
        if main:   # each staging mode forced, timed and held like the plan
            ref = pad_crop_u8.pad_crop_reference(*args, **kw)
            for mode in ("copy", "direct"):
                with staged(pad_crop_u8, mode):
                    err, ok = compare(pad_crop_u8.pad_crop_flip_normalize(
                        *args, **kw), ref, **TOL["pad_crop_u8"])
                    rows[-1][f"{mode}_ms"] = cuda_ms(
                        lambda: pad_crop_u8.pad_crop_flip_normalize(
                            *args, **kw), iters=100)
                rows[-1]["ok"] &= ok
                rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"], err)
                log(f"  pad_crop_u8 {name} {mode} staging forced: "
                    f"{rows[-1][f'{mode}_ms']:.5f}ms ok={ok}")
            del ref
        for r in rows[-2:]:
            log(f"  {r['kernel']} {name} plan {r['plan']} wrapper host "
                f"time {r['host_us']:.1f}us a launch")
        del x, off, flip, args
        torch.cuda.empty_cache()

    for shape, count in FUSED_SITES:
        rows.append(conv_fused_row(shape, count, "resnet18_cifar", g))
    return rows


def conv_fused_row(shape, count, path, g):
    """conv_fused at (n, h, w, c, cout) against its plain version, with its
    bound and plan, beside cuDNN's bf16 conv with an eager epilogue and
    cuDNN's conv alone: one row (``count`` sites of one forward of
    ``path``; a shape measured before in this run is that row again)."""
    import torch
    import torch.nn.functional as F

    from myconvnet_tpu_torch.ops.kernels import conv_fused

    key = ("conv_fused", tuple(shape), None, None)
    again = _row_again(key, path, count)
    if again is not None:
        return again

    def cudnn_conv(x, w3):
        return F.conv2d(x.permute(0, 3, 1, 2), w3.permute(3, 2, 0, 1),
                        padding=1)

    def cudnn_bf16(x, w3, s, b):
        y = cudnn_conv(x, w3)
        return torch.relu(y * s[:, None, None] + b[:, None, None]
                          ).to(torch.bfloat16).permute(0, 2, 3, 1)

    n, h, w, c, co = shape
    dev = g.device
    x = torch.randn(n, h, w, c, generator=g, device=dev).to(torch.bfloat16)
    w3 = (torch.randn(co, 3, 3, c, generator=g, device=dev)
          * (9 * c) ** -0.5).to(torch.bfloat16).permute(1, 2, 3, 0)
    s = torch.rand(co, generator=g, device=dev) + 0.5
    b = torch.randn(co, generator=g, device=dev) * 0.3
    a = (x, w3, s, b)
    out = conv_fused.conv3x3_bn_relu(*a)
    ref = conv_fused.conv3x3_bn_relu_reference(*a)
    torch.cuda.synchronize()
    err, ok = compare(out, ref, **TOL["conv_fused"])
    del out, ref
    b_ms, b_by = bound(2 * n * h * w * (c + co) + 18 * c * co + 8 * co,
                       2 * n * taps(h) * taps(w) * c * co, BF16_FLOPS)
    iters = 3 if h * w * n > 10 ** 6 else ROW_ITERS
    r = dict(kernel="conv_fused", path=path, shape=list(shape),
             sites=count, max_abs_err=err, ok=ok, bound_ms=b_ms,
             bound_by=b_by, plan=conv_fused.plan(n, h, w, c, co),
             library_ms=None,
             ms=cuda_ms(lambda: conv_fused.conv3x3_bn_relu(*a), iters),
             plain_ms=cuda_ms(
                 lambda: conv_fused.conv3x3_bn_relu_reference(*a), iters),
             cudnn_bf16_ms=cuda_ms(lambda: cudnn_bf16(*a), iters),
             cudnn_conv_ms=cuda_ms(lambda: cudnn_conv(x, w3), iters))
    log(f"conv_fused {path} {r['shape']} x{count} plan {r['plan']}: "
        f"max_abs_err={err:.3g} (tol rtol={TOL['conv_fused']['rtol']:.3g}"
        f" atol={TOL['conv_fused']['atol']:.3g}) ok={ok} "
        + " ".join(f"{k}={r[k]:.4f}ms" for k in (
            "ms", "plain_ms", "cudnn_bf16_ms", "cudnn_conv_ms",
            "bound_ms")) + f" ({b_by})")
    return _keep_row(key, r)


def check_classifier_kernels(dev, g):
    """The kernels at the classifier paths' eval shapes against their plain
    versions, with their bounds, one row per shape: conv_pair and bn_act at
    ResNet-50's eval batch of 1024 (its training path's validation and
    test.main); conv_fused at VGG-16's sites (batch 512) and bn_act at its
    first conv; bn_act at DenseNet-121's largest and smallest sites (batch
    1024), beside a ``torch.addcmul``, a ReLU and the cast (a yardstick of
    three calls, so not its library time); bn_act and conv_fused at
    SmallNet's sites (batch 128) under float32 and bf16.  conv_pair stands
    beside cuDNN's unfused bf16 pair, conv_fused beside cuDNN's bf16 conv
    with an eager epilogue and cuDNN's conv alone."""
    import torch

    def act_inputs(shape, dtype=torch.bfloat16):
        x = torch.randn(*shape, generator=g, device=dev).to(dtype)
        c = shape[-1]
        return (x, torch.rand(c, generator=g, device=dev) + 0.5,
                torch.randn(c, generator=g, device=dev) * 0.5)

    rows = []
    for shape, count in R50_PAIR_SITES:
        rows.append(conv_pair_row(shape, count, "resnet50_train", g))
        torch.cuda.empty_cache()
    for site, shape, count in R50_ACT_SITES:
        rows.append(bn_act_row(site, *act_inputs(shape), count,
                               "resnet50_train"))
        torch.cuda.empty_cache()
    for shape, count in VGG_FUSED_SITES:
        rows.append(conv_fused_row(shape, count, "vgg16", g))
        torch.cuda.empty_cache()
    for site, shape, count in VGG_ACT_SITES:
        rows.append(bn_act_row(site, *act_inputs(shape), count, "vgg16"))
        torch.cuda.empty_cache()
    for site, shape, count in DENSENET_ACT_SITES:
        x, a, b = act_inputs(shape)
        rows.append(bn_act_row(
            site, x, a, b, count, "densenet121",
            torch_addcmul_relu_ms=lambda: torch.relu(
                torch.addcmul(b, x, a)).to(torch.bfloat16)))
        del x
        torch.cuda.empty_cache()
    for site, shape, count, dtype in SMALLNET_ACT_SITES:
        path = "smallnet_" + ("f32" if dtype == "float32" else "bf16")
        rows.append(bn_act_row(site, *act_inputs(
            shape, getattr(torch, dtype)), count, path))
    for shape, count in SMALLNET_FUSED_SITES:
        rows.append(conv_fused_row(shape, count, "smallnet_bf16", g))
    return rows


def check_deeplab_kernels(dev, g):
    """conv_pair, conv_fused and bn_act at every site of DeepLabv3+'s bf16
    eval forward, at the recipe's batch of 16 on its 513 x 513 crops
    (129², 65² and 33² maps: odd sides, partial tiles; conv_fused with 304
    input channels) and on the 96 x 96 crops of the recipe's synthetic run,
    each against its plain version with its bound, beside cuDNN's unfused
    pair or conv (rows as check_classifier_kernels makes them); and at the
    72 x 72 and 120 x 120 inputs of the multi-scale eval (path
    ``deeplab_{hw}``)."""
    import torch

    rows = []
    for path, hw in (("deeplab_513", SEG_HW[0]),
                     *((f"deeplab_{hw}", hw) for hw in SEG_SCALE_HW)):
        pair, fused, act = deeplab_sites(SEG_BATCH, hw)
        for shape, count in pair:
            rows.append(conv_pair_row(shape, count, path, g))
            torch.cuda.empty_cache()
        for shape, count in fused:
            rows.append(conv_fused_row(shape, count, path, g))
            torch.cuda.empty_cache()
        for site, shape, count in act:
            x = torch.randn(*shape, generator=g, device=dev).to(
                torch.bfloat16)
            c = shape[-1]
            rows.append(bn_act_row(
                f"deeplab {site}", x,
                torch.rand(c, generator=g, device=dev) + 0.5,
                torch.randn(c, generator=g, device=dev) * 0.5, count, path))
    return rows


def gan_input_row(case, shape, g, mean=None, std=None):
    """normalize_u8 at a GAN recipe's train batch, mean = std = 0.5 (or
    at another input with its ``mean`` and ``std``), float32 out, against
    its plain version: its bound, plan, wrapper host time and one
    ``torch.addcmul`` as its library time (one row, one site a step or a
    request of that path)."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import normalize_u8

    dev = g.device
    x = torch.randint(0, 256, shape, generator=g, device=dev,
                      dtype=torch.uint8)
    half = torch.full((shape[-1],), 0.5, device=dev)
    mean, std = normalize_u8.device_stats(
        half if mean is None else mean, half if std is None else std, dev)
    f32 = torch.float32
    scale, shift = normalize_u8.scale_shift(mean, std, dev)
    err, ok = compare(normalize_u8.normalize_u8(x, mean, std, f32),
                      normalize_u8.normalize_u8_reference(x, mean, std,
                                                          f32),
                      **TOL["normalize_u8"])
    b_ms, b_by = bound(input_bytes("normalize_u8", x, f32), 2 * x.numel(),
                       F32_FLOPS)
    r = dict(kernel="normalize_u8", path=case, case=case, shape=list(shape),
             dtype="float32", out_dtype="float32", sites=1,
             max_abs_err=err, ok=ok, bound_ms=b_ms, bound_by=b_by,
             ms=cuda_ms(lambda: normalize_u8.normalize_u8(x, mean, std,
                                                          f32), 100),
             plain_ms=cuda_ms(lambda: normalize_u8.normalize_u8_reference(
                 x, mean, std, f32)),
             library_ms=cuda_ms(lambda: torch.addcmul(shift, x, scale), 100),
             plan=normalize_u8.plan(x.numel(), shape[-1], f32),
             host_us=host_us(lambda: normalize_u8.normalize_u8(
                 x, mean, std, f32)))
    log(f"normalize_u8 {case} {r['shape']} -> float32 (mean "
        f"{mean.tolist()}, std {std.tolist()}): "
        f"max_abs_err={err:.3g} ok={ok} "
        + " ".join(f"{k}={r[k]:.5f}ms" for k in
                   ("ms", "plain_ms", "bound_ms", "library_ms"))
        + f" plan {r['plan']} wrapper host time {r['host_us']:.1f}us")
    return r


def check_gan_kernels(dev, g):
    """bn_act at every site of the GAN generators' eval forwards, each
    against its plain version with its bound: DCGAN's three (float32,
    ReLU) at the 16 samples of train.main's grids, the 64 of
    generate.main's and the 4 of the export phase's sampler artifact
    (paths ``dcgan_16``, ``dcgan_64``, ``dcgan_4``), the U-Net's 13
    (bf16; six leaky ReLU, seven ReLU) at test.main's batch of 16 (path
    ``pix2pix``); normalize_u8 at both recipes' train batches."""
    import torch

    def act_inputs(shape, dtype):
        c = shape[-1]
        return (torch.randn(*shape, generator=g, device=dev).to(dtype),
                torch.rand(c, generator=g, device=dev) + 0.5,
                torch.randn(c, generator=g, device=dev) * 0.5)

    rows = []
    for n in (DCGAN_SAMPLES, DCGAN_GRID, EXPORT_GAN_BATCH):
        for site, shape in dcgan_sites(n):
            rows.append(bn_act_row(f"dcgan {site}", *act_inputs(
                shape, torch.float32), 1, f"dcgan_{n}"))
    for site, shape, act in unet_sites(PIX2PIX_BATCH):
        rows.append(bn_act_row(f"pix2pix {site}", *act_inputs(
            shape, torch.bfloat16), 1, "pix2pix", act=act))
    for case, shape in GAN_INPUT_SHAPES.items():
        rows.append(gan_input_row(case, shape, g))
    return rows


def shape_key(kernel, shape, dtype=None, act="relu"):
    """What a launch of conv_pair, conv_fused, bn_act or normalize_u8 is
    held by: its shape (n, h, w, cin, cm, cout), (n, h, w, c, cout),
    bn_act's [n, h, w, c], dtype and activation, or normalize_u8's
    [n, h, w, c] and output dtype."""
    tail = {"bn_act": [dtype, act], "normalize_u8": [dtype]}.get(kernel, [])
    return (kernel, *shape, *tail)


def _name(dtype):
    return str(dtype).split(".")[-1]


def _arg(args, kw, i, name, default):
    return args[i] if len(args) > i else kw.get(name, default)


@contextlib.contextmanager
def _recording(counter, sites):
    """While the block runs, each ``(module, attribute, key)`` of ``sites``
    counts ``key(x, args, kwargs)`` into ``counter`` when it is called on a
    CUDA tensor x (a wrapper called on a CPU tensor launches nothing)."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]

    def recording(fn, key):
        def call(x, *args, **kw):
            if x.device.type == "cuda":
                counter[key(x, args, kw)] += 1
            return fn(x, *args, **kw)
        return call

    for (mod, attr, fn), (_, _, key) in zip(saved, sites):
        setattr(mod, attr, recording(fn, key))
    try:
        yield counter
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def _b2_site(mod):
    return (mod, "normalize_u8", lambda x, a, kw: shape_key(
        "normalize_u8", tuple(x.shape),
        _name(_arg(a, kw, 2, "out_dtype", "float32"))))


def launch_shapes(counter):
    """Count into ``counter`` the :func:`shape_key` of every launch of
    conv_pair, conv_fused and bn_act, and the input shape of every launch
    of the flash and correlation forwards, while the block runs: inside
    the kernel modules' ``launch_cuda`` / ``launch_fwd_cuda``, which the
    wrappers call on CUDA tensors and the mcn:: ops' CUDA implementations
    call from an exported program's graph; with normalize_u8 from the GAN
    trainer (``train.gan``), the image route (``serving_http``), the depth
    recipe's input chain (``recipes``) and the detection input
    (``train.detection``)."""
    from myconvnet_tpu_torch import recipes, serving_http
    from myconvnet_tpu_torch.ops.kernels import (bn_act, conv_fused,
                                                 conv_pair, correlation)
    from myconvnet_tpu_torch.ops.kernels import flash_attention as fa
    from myconvnet_tpu_torch.train import detection, gan

    return _recording(counter, [
        (conv_pair, "launch_cuda", lambda x, a, kw: shape_key(
            "conv_pair", (*x.shape, a[0].shape[-1], a[3].shape[-1]))),
        (conv_fused, "launch_cuda", lambda x, a, kw: shape_key(
            "conv_fused", (*x.shape, a[0].shape[-1]))),
        (bn_act, "launch_cuda", lambda x, a, kw: shape_key(
            "bn_act", tuple(x.shape), _name(x.dtype),
            _arg(a, kw, 2, "act", "relu"))),
        (fa, "launch_fwd_cuda", lambda x, a, kw: (
            "flash_attention_fwd", *x.shape)),
        (correlation, "launch_fwd_cuda", lambda x, a, kw: (
            "correlation_fwd", *x.shape)),
        _b2_site(gan), _b2_site(serving_http), _b2_site(recipes),
        _b2_site(detection)])


def kernel_by_path(name, details, runs, shapes):
    """conv_pair's, bn_act's or conv_fused's launches and times path by
    path: the launches of the path's runs beside the kernel, plain and
    bound ms summed over the rows held at the path's shapes (``sites``:
    how many of one forward's launches those rows cover, one forward at
    each size of a PATH_ROWS path).  Where the path's runs recorded their
    launches shape by shape (``shapes``: run -> Counter of
    :func:`shape_key`), every launch must be at a shape a row holds."""
    out = {}
    for path, names in KERNEL_PATH_RUNS.items():
        rows = [r for r in details if r["kernel"] == name
                and r.get("path") in PATH_ROWS.get(path, (path,))
                and r["sites"]]
        launches = sum(runs[k][name] for k in names)
        if not launches and not rows:
            continue
        if not rows:
            raise AssertionError(f"{name} launched on {path} but held at "
                                 "none of its shapes")
        out[path] = dict(
            launches=launches, sites=sum(r["sites"] for r in rows),
            **{k: sum(r[k] * r["sites"] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms")},
            bound_by=max(rows, key=lambda r: r["bound_ms"] * r["sites"]
                         )["bound_by"],
            # cuDNN's unfused bf16 pair (conv_pair) or its conv with an
            # eager epilogue (conv_fused) at the same rows
            library_ms=(sum(r["cudnn_bf16_ms"] * r["sites"] for r in rows)
                        if all("cudnn_bf16_ms" in r for r in rows)
                        else None))
        if not all(k in shapes for k in names):
            continue
        seen = {}
        for k in names:
            for key, calls in shapes[k].items():
                if key[0] == name:
                    seen[key] = seen.get(key, 0) + calls
        held = {shape_key(name, r["shape"], r.get("dtype"),
                          r.get("act", "relu")) for r in rows}
        unheld = sorted(map(str, set(seen) - held))
        if sum(seen.values()) != launches or unheld:
            raise AssertionError(
                f"{name} on {path}: {sum(seen.values())} launches recorded "
                f"by shape of {launches}; at shapes no row holds: {unheld}")
        out[path]["shapes"] = {" ".join(map(str, k[1:])): c
                               for k, c in sorted(seen.items())}
    return out


def sweep_input_plans():
    """``--sweep-inputs``: normalize_u8 and pad_crop_u8 at every
    INPUT_CASES row under other launch geometries than their planners':
    each planner run with one of its constants changed (its cached
    ``_launch_plan`` cleared, and restored after): normalize_u8's
    BYTES_THREAD at 4-64 and BLOCKS_SM at 1-16 (a geometry tried once);
    pad_crop_u8's THREADS at 96-512 and, where an image is cut into bands,
    BAND_BYTES at 4-48 rows of source (MIN_FILL 0, so the bands are those
    rows).  Each launch is held against the plain
    version and timed back to back (100 launches).  Prints a row a
    launch, writes ``chiprun_out/input_sweep.json`` and returns whether
    every launch agreed."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import normalize_u8 as nu
    from myconvnet_tpu_torch.ops.kernels import pad_crop_u8 as pc

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    @contextlib.contextmanager
    def planned_with(module, **constants):
        kept = {k: getattr(module, k) for k in constants}
        vars(module).update(constants)
        module._launch_plan.cache_clear()
        try:
            yield
        finally:
            vars(module).update(kept)
            module._launch_plan.cache_clear()

    def measure(kernel, case, geometry, fn, ref, is_plan):
        ok = bool(torch.equal(fn(), ref))
        rows.append(dict(kernel=kernel, case=case, planned=is_plan, ok=ok,
                         ms=cuda_ms(fn, iters=100), **geometry))
        log(json.dumps(rows[-1]))

    for case in INPUT_CASES:
        name, shape = case[0], case[1]
        x, off, flip, mean, std, dt, pad = input_kernel_inputs(case, dev, g)
        ref = nu.normalize_u8_reference(x, mean, std, dt)
        own = nu.plan(x.numel(), shape[-1], dt)["blocks"]
        seen = []
        for over in ([dict(BYTES_THREAD=b) for b in (4, 8, 16, 32, 64)]
                     + [dict(BLOCKS_SM=k) for k in (1, 2, 8, 16)]):
            with planned_with(nu, **over):
                blocks = nu.plan(x.numel(), shape[-1], dt)["blocks"]
                if blocks in seen:
                    continue
                seen.append(blocks)
                measure("normalize_u8", name, dict(
                    blocks=blocks, **{k.lower(): v for k, v in over.items()}),
                    lambda: nu.normalize_u8(x, mean, std, dt), ref,
                    blocks == own)
        ref = pc.pad_crop_reference(x, off, flip, mean, std, pad=pad,
                                    out_dtype=dt)
        _, h, w, c = shape
        keys = ("threads", "rows", "blocks", "smem")
        own = {k: v for k, v in pc.plan(*shape, dt).items() if k in keys}
        bands = [{}] if own["rows"] == h else [
            dict(BAND_BYTES=r * w * c, MIN_FILL=0.0)
            for r in (4, 8, 12, 16, 23, 32, 48)]
        seen = []
        for over in [{}] + [dict(THREADS=t, **b) for b in bands
                            for t in (96, 192, 256, 384, 512)]:
            with planned_with(pc, **over):
                p = {k: v for k, v in pc.plan(*shape, dt).items()
                     if k in keys}
                if p in seen:
                    continue
                seen.append(p)
                measure("pad_crop_u8", name, p,
                        lambda: pc.pad_crop_flip_normalize(
                            x, off, flip, mean, std, pad=pad, out_dtype=dt),
                        ref, p == own)
        del x, off, flip, ref
        torch.cuda.empty_cache()
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "input_sweep.json"), "w") as f:
        json.dump(dict(card=run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"]), rows=rows), f,
                  indent=1)
    return all(r["ok"] for r in rows)


def check_flash_kernels(dev, g):
    """The three flash-attention kernels against their plain versions at
    FLASH_SITES; each kernel gets the plain version's residuals (lse, D)
    so that it is held on its own.  One row per kernel and shape."""
    import torch
    import torch.nn.functional as F

    from myconvnet_tpu_torch.ops.kernels import flash_attention as fa

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(
            torch.bfloat16)

    def err_of(out, ref, tol):
        d = float((out.float() - ref.float()).abs().max())
        return d, d <= tol and bool(torch.isfinite(out).all())

    rows = []
    for (b, h, l, d), sites, path in FLASH_SITES:
        # q, k and v as the ViT hands them over: views of a packed qkv
        q, k, v = (t.transpose(1, 2) for t in rnd(b, l, 3, h, d).unbind(2))
        do = rnd(b, h, l, d)
        qc, kc, vc, doc = (t.contiguous() for t in (q, k, v, do))
        out, lse = fa.flash_attention_fwd(q, k, v)
        o_ref, lse_ref = fa.flash_fwd_reference(q, k, v)
        dq, dl = fa.flash_attention_dq(q, k, v, o_ref, do, lse_ref)
        dq_ref, dl_ref = fa.flash_dq_reference(q, k, v, o_ref, do, lse_ref)
        dk, dv = fa.flash_attention_dkv(q, k, v, do, lse_ref, dl_ref)
        dk_ref, dv_ref = fa.flash_dkv_reference(q, k, v, do, lse_ref,
                                                dl_ref)
        torch.cuda.synchronize()
        top = float(o_ref.float().abs().max())
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        checks = {
            "flash_attention_fwd": [
                ("out", out, o_ref, FLASH_OUT_ULPS * ulp),
                ("lse", lse, lse_ref,
                 FLASH_STAT_TOL * float(lse_ref.abs().max()))],
            "flash_attention_dq": [
                ("dq", dq, dq_ref,
                 FLASH_GRAD_TOL * float(dq_ref.float().abs().max())),
                ("D", dl, dl_ref,
                 FLASH_STAT_TOL * float(dl_ref.abs().max()))],
            "flash_attention_dkv": [
                (n, t, r, FLASH_GRAD_TOL * float(r.float().abs().max()))
                for n, t, r in (("dk", dk, dk_ref), ("dv", dv, dv_ref))]}
        bhld, bhl, sq = b * h * l * d, b * h * l, b * h * l * l * d
        sizes = {"flash_attention_fwd": (8 * bhld + 4 * bhl, 4 * sq),
                 "flash_attention_dq": (12 * bhld + 8 * bhl, 6 * sq),
                 "flash_attention_dkv": (12 * bhld + 8 * bhl, 8 * sq)}
        fns = {"flash_attention_fwd": (
                   lambda: fa.flash_attention_fwd(q, k, v),
                   lambda: fa.flash_fwd_reference(q, k, v),
                   lambda: F.scaled_dot_product_attention(qc, kc, vc)),
               "flash_attention_dq": (
                   lambda: fa.flash_attention_dq(q, k, v, o_ref, do,
                                                 lse_ref),
                   lambda: fa.flash_dq_reference(q, k, v, o_ref, do,
                                                 lse_ref), None),
               "flash_attention_dkv": (
                   lambda: fa.flash_attention_dkv(q, k, v, do, lse_ref,
                                                  dl_ref),
                   lambda: fa.flash_dkv_reference(q, k, v, do, lse_ref,
                                                  dl_ref), None)}
        for name in FLASH:
            errs = {what: err_of(t, r, tol) + (tol,)
                    for what, t, r, tol in checks[name]}
            fn, plain_fn, lib_fn = fns[name]
            b_ms, b_by = bound(*sizes[name], BF16_FLOPS)
            r = dict(kernel=name, shape=[b, h, l, d], sites=sites,
                     path=path,
                     max_abs_err=max(e for e, _, _ in errs.values()),
                     errors={w: [e, t] for w, (e, _, t) in errs.items()},
                     ok=all(ok for _, ok, _ in errs.values()),
                     bound_ms=b_ms, bound_by=b_by, ms=cuda_ms(fn),
                     plain_ms=cuda_ms(plain_fn, iters=5),
                     library_ms=cuda_ms(lib_fn) if lib_fn else None)
            rows.append(r)
            log(f"{name} {r['shape']} x{sites}: "
                + " ".join(f"{w} err={e:.3g} (tol {t:.3g})"
                           for w, (e, t) in r["errors"].items())
                + f" ok={r['ok']} kernel={r['ms']:.4f}ms "
                f"plain={r['plain_ms']:.4f}ms bound={b_ms:.4f}ms ({b_by})"
                + (f" sdpa={r['library_ms']:.4f}ms" if lib_fn else ""))
        # the library's backward (dq, dk, dv in one call), beside dQ + dK/dV
        qs, ks, vs = (t.detach().requires_grad_() for t in (qc, kc, vc))
        o_lib = F.scaled_dot_product_attention(qs, ks, vs)
        bwd = cuda_ms(lambda: torch.autograd.grad(
            o_lib, (qs, ks, vs), doc, retain_graph=True))
        rows[-1]["sdpa_bwd_ms"] = bwd
        log(f"scaled_dot_product_attention backward {[b, h, l, d]}: "
            f"{bwd:.4f}ms (dq + dk + dv in one call)")
        del o_lib
    return rows


def shear_grid(slope, offset, shape, axis):
    """The sampling grid of a shear for ``F.grid_sample`` (align_corners,
    coordinates in [-1, 1]): the library yardstick of shear_rows."""
    import torch
    n, h, w, _ = shape
    ys = torch.arange(h, dtype=torch.float32, device=slope.device)
    xs = torch.arange(w, dtype=torch.float32, device=slope.device)
    ys, xs = ys[None, :, None].expand(n, h, w), xs[None, None, :].expand(
        n, h, w)
    s, t = slope[:, None, None], offset[:, None, None]
    if axis == 2:
        xs = xs + s * ys + t
    else:
        ys = ys + s * xs + t
    return torch.stack([2 * xs / (w - 1) - 1, 2 * ys / (h - 1) - 1], -1)


def check_randaugment_kernels(dev, g):
    """shear_rows (B7: row and column shears at slopes over +-0.3, and
    the three-shear rotate at angles over +-30 degrees) and
    randaugment_ew (B8: a random op per image, and each op forced for the
    batch, on each path of RA_PATHS) against their plain versions at
    RA_SHAPES; one row per kernel, case, path and shape."""
    import torch
    import torch.nn.functional as F

    from myconvnet_tpu_torch.ops.kernels import affine, randaugment_ew

    def row(kernel, case, shape, sites, out, ref, fn, plain_fn, nbytes,
            ops, lib_fn=None, **extra):
        torch.cuda.synchronize()
        err, ok = compare(out, ref, **TOL[kernel])
        b_ms, b_by = bound(nbytes, ops, F32_FLOPS)
        r = dict(kernel=kernel, case=case, shape=list(shape), sites=sites,
                 max_abs_err=err, ok=ok, bound_ms=b_ms, bound_by=b_by,
                 ms=cuda_ms(fn, iters=10),
                 plain_ms=cuda_ms(plain_fn, iters=3, warmup=1),
                 library_ms=cuda_ms(lib_fn, iters=10) if lib_fn else None,
                 **{k: cuda_ms(f, iters=10) for k, f in extra.items()})
        log(f"{kernel} {case} {r['shape']} x{sites}: max_abs_err={err:.3g} "
            f"ok={ok} kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
            f"bound={b_ms:.4f}ms ({b_by})"
            + (f" grid_sample={r['library_ms']:.4f}ms" if lib_fn else "")
            + "".join(f" {k}={r[k]:.4f}ms" for k in extra))
        return r

    rows = []
    for shape in RA_SHAPES:
        n, h, w, _ = shape
        x = torch.rand(shape, generator=g, device=dev)
        numel = x.numel()
        slope = torch.linspace(-0.3, 0.3, n, device=dev)
        for axis in (2, 1):
            off = affine._centered(slope, shape[3 - axis])
            args = (x, slope, off)
            grid = shear_grid(slope, off, shape, axis)
            xn = x.permute(0, 3, 1, 2)
            rows.append(row(
                "shear_rows", f"axis {axis}", shape,
                RA_SITES[("shear_rows", axis)] if n == VIT_RECIPE_BATCH
                else 0,
                affine.shear_rows(*args, axis=axis),
                affine.shear_reference(*args, axis=axis),
                lambda: affine.shear_rows(*args, axis=axis),
                lambda: affine.shear_reference(*args, axis=axis),
                8 * numel + 8 * n, 6 * numel,
                lambda: F.grid_sample(xn, grid, mode="bilinear",
                                      padding_mode="zeros",
                                      align_corners=True)))
            del grid
        angle = slope * (math.pi / 6 / 0.3)

        def plain_rotate():
            a, b = torch.tan(angle / 2.0), -torch.sin(angle)
            y = x
            for s_, ax in ((a, 2), (b, 1), (a, 2)):
                y = affine.shear_reference(
                    y, s_, affine._centered(s_, shape[3 - ax]), axis=ax)
            return y

        rows.append(row(
            "shear_rows", "rotate (3 launches)", shape, 0,
            affine.rotate(x, angle, max_abs_radians=math.pi / 6),
            plain_rotate(),
            lambda: affine.rotate(x, angle, max_abs_radians=math.pi / 6),
            plain_rotate, 3 * (8 * numel + 8 * n), 18 * numel))
        mag = torch.rand(n, generator=g, device=dev) * 2 - 1
        planned = randaugment_ew.plan(shape)
        for case in ("random", *randaugment_ew.PALLAS_POOL):
            if case == "random":
                idx = torch.randint(0, 8, (n,), generator=g, device=dev)
            else:
                idx = torch.full((n,), randaugment_ew.PALLAS_POOL.index(
                    case), device=dev, dtype=torch.int64)
            args = (x, idx, mag)
            ref = randaugment_ew.apply_layer_reference(*args)
            # one read and one write of x, the op and magnitude an image;
            # each path as planned and forced, the planner's path at the
            # recipe's batch counted as the step's two layers
            for path in RA_PATHS:
                def fn(path=path):
                    return randaugment_ew.apply_layer(*args, path=path)
                on_path = n == VIT_RECIPE_BATCH and path == planned["path"]
                r = row(
                    "randaugment_ew", f"{case} {path}", shape,
                    RA_SITES.get(("randaugment_ew", case), 0)
                    if on_path else 0,
                    fn(), ref, fn,
                    lambda: randaugment_ew.apply_layer_reference(*args),
                    8 * numel + 12 * n, 8 * numel)
                r["path"] = path
                r["plan"] = randaugment_ew.plan(shape, path=path)
                if case == "random":
                    r["kernels_per_layer"] = device_busy(fn, iters=3)[2]
                    log(f"randaugment_ew random {path} {list(shape)}: "
                        f"{r['kernels_per_layer']:g} CUDA kernels a layer "
                        f"(torch.profiler), plan {r['plan']}")
                rows.append(r)
            del ref
        del x
        torch.cuda.empty_cache()
    return rows


def corr_taps(size, d):
    """Taps of the (2d + 1) displacements along one axis of ``size`` that
    fall inside the frame, summed over the axis (the others read zeros)."""
    return sum(max(size - abs(e), 0) for e in range(-d, d + 1))


def check_correlation_kernels(dev, g):
    """The correlation forward and both backward kernels against the
    plain version and its autograd at CORR_SITES, bf16 and float32 inputs,
    d = CORR_D; one row per kernel, site and dtype.  ``sites`` counts the
    launches of one train step of the row's ``path`` at the recipe's batch
    (bf16 rows; the recipes never give the kernels float32).  The plain
    backward is autograd of the plain version, its forward included, giving
    both gradients at once: one time for both rows.  Kernel and plain
    times are both ``cuda_ms`` (stream held), the plain version's through
    ``graph_ms``.  The operations' bound takes
    the rate of the inputs' type: a bf16 product summed in float32 is what
    the tensor cores compute."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import correlation as corr

    d, k = CORR_D, (2 * CORR_D + 1) ** 2
    rows = []
    for site, shape, path in CORR_SITES:
        n, h, w, c = shape
        for dtype in (torch.bfloat16, torch.float32):
            f1, f2 = (torch.randn(shape, generator=g, device=dev).to(dtype)
                      for _ in range(2))
            grad = torch.randn((n, h, w, k), generator=g, device=dev)
            out = corr.correlation_fwd(f1, f2, d)
            ref = corr.correlation_reference(f1, f2, d)
            d1 = corr.correlation_bwd_f1(grad, f1, f2, d)
            d2 = corr.correlation_bwd_f2(grad, f1, f2, d)
            r1, r2 = corr.correlation_bwd_reference(grad, f1, f2, d)
            torch.cuda.synchronize()

            def grad_tol(r):
                top = float(r.float().abs().max())
                if dtype == torch.float32:
                    return CORR_TOL * top
                return CORR_GRAD_ULPS * 2.0 ** (math.floor(math.log2(top))
                                                - 7)

            checks = {
                "correlation_fwd": (out, ref,
                                    CORR_TOL * float(ref.abs().max())),
                "correlation_bwd_f1": (d1, r1, grad_tol(r1)),
                "correlation_bwd_f2": (d2, r2, grad_tol(r2))}
            elt = f1.element_size()
            ops = 2 * n * corr_taps(h, d) * corr_taps(w, d) * c
            vol = 4 * n * h * w * k
            sizes = {"correlation_fwd": 2 * elt * f1.numel() + vol,
                     "correlation_bwd_f1": vol + 2 * elt * f1.numel(),
                     "correlation_bwd_f2": vol + 2 * elt * f1.numel()}
            fns = {"correlation_fwd":
                   lambda: corr.correlation_fwd(f1, f2, d),
                   "correlation_bwd_f1":
                   lambda: corr.correlation_bwd_f1(grad, f1, f2, d),
                   "correlation_bwd_f2":
                   lambda: corr.correlation_bwd_f2(grad, f1, f2, d)}
            plain = {"correlation_fwd": graph_ms(
                lambda: corr.correlation_reference(f1, f2, d))}
            plain["correlation_bwd_f1"] = plain["correlation_bwd_f2"] = \
                graph_ms(lambda: corr.correlation_bwd_reference(
                    grad, f1, f2, d))
            rate = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
            for name in CORR:
                got, want, tol = checks[name]
                err = float((got.float() - want.float()).abs().max())
                ok = err <= tol and bool(torch.isfinite(got).all())
                b_ms, b_by = bound(sizes[name], ops, rate)
                mode = {"correlation_fwd": "fwd", "correlation_bwd_f1":
                        "bwd_f1", "correlation_bwd_f2": "bwd_f2"}[name]
                r = dict(kernel=name, site=site, path=path,
                         plan=corr.plan(mode, shape, d, dtype),
                         shape=list(shape), dtype=str(dtype).split(".")[-1],
                         sites=int(dtype == torch.bfloat16),
                         max_abs_err=err, tol=tol, ok=ok, bound_ms=b_ms,
                         bound_by=b_by, ms=cuda_ms(fns[name]),
                         plain_ms=plain[name], library_ms=None)
                rows.append(r)
                log(f"{name} {site} {r['shape']} {r['dtype']}: "
                    f"max_abs_err={err:.3g} (tol {tol:.3g}) ok={ok} "
                    f"kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
                    f"bound={b_ms:.4f}ms ({b_by})")
            del f1, f2, grad, out, ref, d1, d2, r1, r2
        torch.cuda.empty_cache()
    return rows


def time_tree_kernels(root):
    """For ``--time-kernels ROOT`` (one process a tree): the kernels of the
    checkout at ROOT built from its sources, and normalize_u8 (B2) and
    pad_crop_u8 (B3) timed by ``cuda_ms`` (100 launches back to back) at
    every INPUT_CASES row, conv_pair (B5) at COMPARE_PAIR_SHAPES and bn_act
    (B1) at the served ResNet-50's smallest site, each held against its
    plain version, and on a tree with the mcn:: ops B1 and B5 (at the
    first two shapes) through the op too (rows "bn_act op", "conv_pair
    op"), then that ResNet-50 served in memory (rows "served resnet50":
    ``ms`` the p50 of a request of 1 and of 8 images, with its p95), with
    the wrapper's host time a launch
    (``host_us``, the median of 21 runs of 200 calls, and ``host_us_q``,
    their quartiles); for a tree whose pad_crop_u8 has staging modes, also
    each mode forced at the recipe's shape.  Returns {"card", "build_s",
    "rows": [...]}."""
    import torch
    sys.path.insert(0, root)
    from myconvnet_tpu_torch.core.precision import FULL, apply_backend_flags
    from myconvnet_tpu_torch.ops.kernels import _build, conv_pair, \
        normalize_u8, pad_crop_u8
    assert os.path.dirname(os.path.abspath(_build.__file__)).startswith(
        os.path.abspath(root)), "kernels imported from another tree"
    apply_backend_flags(FULL)
    _, build_s = _build.build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    def add(kernel, case, x, out, ref, fn, tol):
        err, ok = compare(out, ref, **tol)
        host = host_samples(fn, 200, 21)
        rows.append(dict(kernel=kernel, case=case, shape=list(x.shape),
                         max_abs_err=err, ok=ok, ms=cuda_ms(fn, iters=100),
                         host_us=host[10], host_us_q=[host[5], host[15]]))

    for case in INPUT_CASES:
        name, dtype, main = case[0], case[2], case[6]
        x, off, flip, mean, std, dt, pad = input_kernel_inputs(case, dev, g)
        label = f"{name} {dtype}"
        add("normalize_u8", label, x, normalize_u8.normalize_u8(
                x, mean, std, dt),
            normalize_u8.normalize_u8_reference(x, mean, std, dt),
            lambda: normalize_u8.normalize_u8(x, mean, std, dt),
            TOL["normalize_u8"])
        args, kw = (x, off, flip, mean, std), dict(pad=pad, out_dtype=dt)
        ref = pad_crop_u8.pad_crop_reference(*args, **kw)
        modes = [None]
        if main and hasattr(pad_crop_u8, "launch_args"):
            modes += ["copy", "direct"]
        for m in modes:
            with (staged(pad_crop_u8, m) if m else contextlib.nullcontext()):
                add("pad_crop_u8", label + (f" {m} forced" if m else ""),
                    x, pad_crop_u8.pad_crop_flip_normalize(*args, **kw),
                    ref, lambda: pad_crop_u8.pad_crop_flip_normalize(
                        *args, **kw), TOL["pad_crop_u8"])
        del x, off, flip, args, ref
        torch.cuda.empty_cache()
    for shape in COMPARE_PAIR_SHAPES:
        args = pair_args(shape, g)
        add("conv_pair", str(shape), args[0],
            conv_pair.conv1x1_conv3x3_bn_relu(*args),
            conv_pair.conv_pair_reference(*args),
            lambda: conv_pair.conv1x1_conv3x3_bn_relu(*args),
            TOL["conv_pair"])
    # bn_act at the served ResNet-50's smallest site (its launch cost is
    # most of its time), then that ResNet-50 served in memory (random
    # weights from SEED, bf16, BN folded) through serve --latency's
    # measure: p50 and p95 at sizes 1 and 8, buckets 1, 8, 32, 128
    from myconvnet_tpu_torch import models, serving
    from myconvnet_tpu_torch.core.precision import BF16
    from myconvnet_tpu_torch.ops.kernels import bn_act
    from myconvnet_tpu_torch.weights import random_jax_params
    site = ACT_SITES[-1][1]
    x, a, b = _act_inputs(site, torch.bfloat16, g)
    add("bn_act", str(site), x, bn_act.fused_scale_shift_act(x, a, b),
        bn_act.scale_shift_act_reference(x, a, b),
        lambda: bn_act.fused_scale_shift_act(x, a, b), TOL["bn_act"])
    # on a tree with the mcn:: ops, the same launches through the op's
    # dispatcher, which an artifact's graph calls (rows "... op")
    if hasattr(bn_act, "_OP"):
        add("bn_act op", str(site), x, bn_act._OP(x, a, b, "relu"),
            bn_act.scale_shift_act_reference(x, a, b),
            lambda: bn_act._OP(x, a, b, "relu"), TOL["bn_act"])
        for shape in COMPARE_PAIR_SHAPES[:2]:
            args = pair_args(shape, g)
            add("conv_pair op", str(shape), args[0], conv_pair._OP(*args),
                conv_pair.conv_pair_reference(*args),
                lambda: conv_pair._OP(*args), TOL["conv_pair"])
    model = models.resnet50(1000)
    fn = serving.make_inference_fn(model, *random_jax_params(model, SEED),
                                   device=dev, policy=BF16)
    stats = serving.measure_latency(serving.make_batched_server(fn),
                                    (224, 224, 3), request_sizes=(1, BATCH))
    for n, row in stats.items():
        rows.append(dict(kernel="served resnet50", case=f"n={n} p50",
                         shape=[n, 224, 224, 3], max_abs_err=0.0, ok=True,
                         ms=row["p50"], p95_ms=row["p95"]))
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    return dict(card=card, build_s=build_s, rows=rows)


def compare_trees(other):
    """``--compare OTHER``: time_tree_kernels of OTHER and of this
    checkout, one process each, in the order other, this, this, other;
    prints a line a kernel and case with the four times ("-" where a tree
    has no such row) and returns 0 when every run finished and every
    kernel agreed with its plain version."""
    order = [("other", other), ("this", ROOT), ("this", ROOT),
             ("other", other)]
    runs = []
    for label, root in order:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time-kernels",
             os.path.abspath(root)], capture_output=True, text=True,
            timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if proc.returncode != 0 or not lines:
            log(f"chip_smoke --time-kernels {root} failed "
                f"({proc.returncode}):\n{proc.stderr[-3000:]}")
            return 1
        runs.append(dict(label=label, root=root, **json.loads(lines[-1])))
    log(runs[0]["card"])
    log("kernel case [shape]: other, this, this, other ms; max abs error "
        "this (other)")
    keys = []
    for r in (runs[1], runs[0]):
        keys += [(row["kernel"], row["case"]) for row in r["rows"]
                 if (row["kernel"], row["case"]) not in keys]
    bad = []
    for key in keys:
        found = [next((row for row in r["rows"]
                       if (row["kernel"], row["case"]) == key), None)
                 for r in runs]
        times = ", ".join("-" if row is None else f"{row['ms']:.5f}"
                          for row in found)
        errs = " ".join(f"{row['max_abs_err']:.3g}" for row in found[:2]
                        if row is not None)
        shape = next(row["shape"] for row in found if row is not None)
        extra = "; host_us " + ", ".join(
            "-" if row is None or "host_us" not in row
            else f"{row['host_us']:.1f}"
            + ("" if "host_us_q" not in row else
               " [{:.1f}-{:.1f}]".format(*row["host_us_q"]))
            for row in found)
        log(f"{key[0]} {key[1]} {shape}: {times}; err {errs}{extra}")
        bad += [(r["label"], *key) for r, row in zip(runs, found)
                if row is not None and not row["ok"]]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "compare.json"), "w") as f:
        json.dump(runs, f, indent=1)
    if bad:
        log(f"kernels outside tolerance: {bad}")
        return 1
    return 0


def post(url, body, content_type="application/json"):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": content_type})
    # no proxy from the environment: the server is on this host
    opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))
    with opener.open(req, timeout=300) as r:
        return json.load(r)


def serve_and_check(dev):
    """Drive the served main path; returns (launch counts, checks)."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import models, recipes, serving, serving_http
    from myconvnet_tpu_torch.core.precision import get_policy
    from myconvnet_tpu_torch.ops import kernels
    from myconvnet_tpu_torch.weights import random_jax_params

    cfg = recipes.load_config(CONFIG)
    h, w = cfg["input_hw"]
    template = models.get_model(cfg["model"], cfg["num_classes"],
                                **cfg["model_kwargs"])
    params, state = random_jax_params(template, SEED)
    t0 = time.perf_counter()
    route = serving_http.build_route("resnet50", "classify", CONFIG,
                                     params=params, state=state,
                                     batch=BATCH, device=dev)
    log(f"route built (from_jax + fold + to {dev}): "
        f"{time.perf_counter() - t0:.2f}s, policy={cfg['precision']}, "
        f"input {route.input_shape}")
    server = serving_http.ModelServer([route])
    httpd = serving_http.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/v1/models/resnet50:predict")
    rs = np.random.RandomState(SEED)
    images = {n: rs.rand(n, h, w, 3).astype(np.float32) for n in (1, 3, 8)}
    bodies = {n: json.dumps({"instances": x.tolist()}).encode()
              for n, x in images.items()}
    post(url, bodies[1])  # warm-up request (cuDNN autotuning, allocator)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    replies, calls = {}, 0
    try:
        for n, body in bodies.items():
            t0 = time.perf_counter()
            replies[n] = post(url, body)
            log(f"predict n={n}: {len(replies[n]['predictions'])} rows in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (HTTP, JSON "
                f"decode included); top-1 "
                f"{replies[n]['predictions'][0][0]}")
            calls += -(-n // BATCH)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    log(f"launch counts over {calls} device calls: {counts}")
    checks = {}
    for name, per in PER_CALL.items():
        if counts[name] != per * calls:
            raise AssertionError(f"{name}: {counts[name]} launches, want "
                                 f"{per} x {calls} device calls")
        log(f"{name}: {counts[name] // calls} launches per device call "
            f"(want {per}) ok")
    for n, rep in replies.items():
        rows = rep["predictions"]
        if len(rows) != n or any(len(r) != route.topk for r in rows):
            raise AssertionError(f"reply to n={n} has the wrong shape")
        if not all(0.0 <= e["prob"] <= 1.0 for r in rows for e in r):
            raise AssertionError(f"reply to n={n} has bad probabilities")

    # latency before the host reference below, whose CPU threads would
    # compete with the serving thread
    lat = serving.measure_latency(serving.make_batched_server(route.fn),
                                  (h, w, 3), request_sizes=(1, 8),
                                  iters=30, warmup=3)
    for n, row in lat.items():
        log(f"measure_latency n={n}: p50={row['p50']:.3f}ms "
            f"p95={row['p95']:.3f}ms mean={row['mean']:.3f}ms "
            f"images/s={row['images_per_sec']:.1f}")
    checks["latency_ms"] = {n: row for n, row in lat.items()}

    # the frozen forward at batch 8 on the device: busy time (union of the
    # kernels' intervals) and the kernels that take it
    x8 = (images[8] - route.mean) / route.std
    busy, span, n_kernels, top = device_busy(lambda: route.fn(x8))
    checks["forward_b8"] = dict(device_busy_ms=busy, device_span_ms=span,
                                kernels=n_kernels, top_kernels=top)
    log(f"served forward, batch 8 (torch.profiler, 5 calls): device busy "
        f"{busy if busy is None else round(busy, 4)} ms over "
        f"{n_kernels:.0f} kernels; top: " + "; ".join(
            f"{name[:60]} {ms:.4f} ms x{k:g}" for name, ms, k in top[:5]))

    # bn_act's launches inside one forward, each as long as the profiler
    # saw it there (not back to back, as cuda_ms times them)
    checks["bn_act_in_forward_ms"] = [
        ms for _, ms in kernel_times(lambda: route.fn(x8), BN_ACT_KERNEL)]
    log(f"bn_act in the served forward (torch.profiler): "
        f"{[round(t, 4) for t in checks['bn_act_in_forward_ms']]} ms, "
        f"sum {sum(checks['bn_act_in_forward_ms']):.4f} ms")
    if len(checks["bn_act_in_forward_ms"]) != PER_CALL["bn_act"]:
        raise AssertionError("the profiler did not see bn_act's launches "
                             "in the served forward")

    # logits on the card vs the plain path (same trees, host CPU)
    x = (images[8] - route.mean) / route.std
    card = route.fn(x).float().cpu().numpy()
    host = serving.make_inference_fn(
        models.get_model(cfg["model"], cfg["num_classes"]), params, state,
        device="cpu", policy=get_policy(cfg["precision"]))
    plain = host(x).float().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    top1 = float((card.argmax(1) == plain.argmax(1)).mean())
    finite = bool(np.isfinite(card).all())
    log(f"logits {card.shape}: finite={finite} max|card-plain|/max|plain|"
        f"={rel:.4g} (tol {LOGIT_REL_TOL}) top-1 agreement={top1:.3f} "
        f"max|logit|={np.abs(plain).max():.3g}")
    if not finite or card.shape != (BATCH, cfg["num_classes"]) \
            or rel > LOGIT_REL_TOL:
        raise AssertionError("served logits disagree with the plain path")
    checks.update(logit_rel_err=rel, top1_agreement=top1)

    return counts, calls, checks


def device_busy(fn, iters=5, warm=True):
    """torch.profiler (device activity only) over ``iters`` calls of
    ``fn``, after a warm-up call unless ``warm`` is false: (device busy ms
    per call = the union of the kernels' intervals, span ms per call from
    the first kernel's start to the last one's end, kernels per call, the
    ten kernels with the most device time as [name, ms per call, launches
    per call]); busy is None when the trace shows no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = device_events(prof)
    if not events:
        return None, None, 0, []
    by_name = {}
    for e in events:
        t, k = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    top = [[name[:90], t / 1e3 / iters, k / iters]
           for name, (t, k) in top]
    busy, span = busy_us(events)
    return busy / 1e3 / iters, span / 1e3 / iters, len(events) / iters, top


def device_events(prof):
    """The device kernels, copies and fills of a torch.profiler run; not
    the record_function ranges (Optimizer.step, ...) that the profiler
    mirrors onto the device."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def busy_us(events):
    """(the union of the events' intervals, first start to last end), in
    microseconds."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    return busy, max(b for _, b in spans) - spans[0][0]


def kernel_times(fn, match):
    """[name, device ms] of each kernel of one call of ``fn`` whose name
    holds ``match``, in launch order (torch.profiler, after a warm-up
    call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA and match in e.name)
    return [[name[:90], (b - a) / 1e3] for a, b, name in events]


def read_losses(run_dir, steps, what):
    import numpy as np
    with open(os.path.join(run_dir, "train.jsonl")) as f:
        losses = [r["loss"] for r in map(json.loads, f) if "loss" in r]
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        raise AssertionError(f"{what}: losses not all finite: {losses}")
    return losses


def check_counts(counts, expect, what):
    for name, want in expect.items():
        if counts[name] != want:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times, want {want}")
    log(f"{what}: launches {counts} ok")


def step_one_verdict(what, card, host, loss_card, loss_host, note="", *,
                     loss_rtol=STEP1_LOSS_RTOL, grad_rtol=STEP1_GRAD_RTOL,
                     grad_atol=STEP1_GRAD_ATOL):
    """Hold step 1 on the card against the host: the loss within
    ``loss_rtol`` and every parameter's gradient norm within ``grad_rtol``
    (plus ``grad_atol`` of the largest); ``card`` and ``host`` the
    trainers or their :func:`grad_norms`; returns the record."""
    import numpy as np

    if not isinstance(card, dict):
        card, host = grad_norms(card), grad_norms(host)
    norms = [(path, card[path], h) for path, h in host.items()]
    biggest = max(h for _, _, h in norms)
    bad = [(p, c, h) for p, c, h in norms
           if abs(c - h) > grad_rtol * h + grad_atol * biggest]
    worst = max(abs(c - h) / max(h, 1e-30) for _, c, h in norms)
    loss_rel = abs(loss_card - loss_host) / abs(loss_host)
    log(f"{what}, card vs host: loss {loss_card:.6f} vs {loss_host:.6f} "
        f"(rel {loss_rel:.3g}, tol {loss_rtol:.3g}); {len(norms)} "
        f"gradient norms, worst rel diff {worst:.3g} (tol "
        f"{grad_rtol:.3g} + {grad_atol:.3g} of the largest), outside: "
        f"{len(bad)}{note}")
    if not (np.isfinite(loss_card) and loss_rel <= loss_rtol):
        raise AssertionError(f"{what}: the loss disagrees with the host")
    if bad:
        raise AssertionError(f"{what}: gradient norms disagree: {bad[:5]}")
    return dict(loss_card=loss_card, loss_host=loss_host, loss_rel=loss_rel,
                grad_worst_rel=worst, n_grads=len(norms),
                smallest_host_norm=min(h for _, _, h in norms))


def step_one_against_host(dev):
    """Step 1 of the recipe from the same seeded JAX-layout weights,
    batch and draws on the card and on the host (where every kernel
    wrapper runs its plain version)."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, weights
    from myconvnet_tpu_torch.data.mix import MixDraws
    from myconvnet_tpu_torch.train.trainer import StepDraws

    cfg = recipes.load_config(CIFAR_CONFIG)
    card, train_set, _ = recipes.build_trainer(cfg, True, device=dev)
    host, _, _ = recipes.build_trainer(cfg, True,
                                       device=torch.device("cpu"))
    params, state = weights.random_jax_params(card.model, SEED)
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    xs, ys = train_set.source.get_batch(np.arange(TRAIN_BATCH))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    draws = card.sample(TRAIN_BATCH, INPUT_SHAPE[1:3])
    on_host = StepDraws(draws.boxes.cpu(), draws.flip.cpu(),
                        MixDraws(*(t.cpu() for t in draws.mix)))
    t0 = time.perf_counter()
    loss_card = float(card.loss_and_grads(x.to(dev), y.to(dev), draws)[0])
    t1 = time.perf_counter()
    loss_host = float(host.loss_and_grads(x, y, on_host)[0])
    t2 = time.perf_counter()
    return step_one_verdict(
        "step 1", card, host, loss_card, loss_host,
        f"; card {t1 - t0:.2f}s (first, cold), host {t2 - t1:.2f}s")


def train_and_check(dev):
    """Drive the train and test entry points; returns (launch counts of
    the two runs, checks).  The run's checkpoints (~90 MB each at full
    width) go under build/, which is git-ignored, and are removed."""
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, test, train
    from myconvnet_tpu_torch.nn import BatchNorm
    from myconvnet_tpu_torch.ops import kernels

    checks = {"step1": step_one_against_host(dev)}
    run_dir = os.path.join(ROOT, "build", "chip_smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    net = train.main([
        "--config", CIFAR_CONFIG, "--synthetic", "--steps", str(TRAIN_STEPS),
        "--val_every", str(VAL_EVERY), "--batch", str(TRAIN_BATCH),
        "--out", run_dir, "--set", "log_every=1", "--device", "cuda"])
    trainer = net.trainer
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    log(f"train.main: {TRAIN_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f}s (first steps build cuDNN plans)")
    evals = (TRAIN_STEPS // VAL_EVERY + 1) * EVAL_BATCHES
    check_counts(train_counts, {
        "pad_crop_u8": PER_TRAIN_STEP["pad_crop_u8"] * TRAIN_STEPS,
        **{k: v * evals for k, v in PER_EVAL_BATCH.items()},
        "conv_pair": 0}, f"train.main ({TRAIN_STEPS} steps, {evals} eval "
                         "batches)")
    losses = read_losses(run_dir, TRAIN_STEPS, "ResNet-18")
    bns = [m for m in trainer.model.modules() if isinstance(m, BatchNorm)]
    still = [m for m in bns if not bool(
        (m.moving_mean != 0).any() and (m.moving_var != 1).any())]
    if still:
        raise AssertionError(f"{len(still)} of {len(bns)} BN moving stats "
                             "did not move")
    log(f"losses finite: first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"moving stats of all {len(bns)} BNs moved")
    checks.update(losses=losses)

    kernels.reset_launch_counts()
    score, restored_net = test.main(["--config", CIFAR_CONFIG, "--synthetic",
                                     "--ckpt", run_dir, "--device", "cuda"])
    restored = restored_net.trainer
    torch.cuda.synchronize()
    eval_counts = kernels.launch_counts()
    check_counts(eval_counts, {
        **{k: v * EVAL_BATCHES for k, v in PER_EVAL_BATCH.items()},
        "pad_crop_u8": 0, "conv_pair": 0}, "test.main")
    _, _, val_set = recipes.build_trainer(
        recipes.load_config(CIFAR_CONFIG), True, device=torch.device("cpu"))
    xs, _ = val_set.source.get_batch(np.arange(TRAIN_BATCH))
    x = torch.from_numpy(xs)
    writer = trainer.eval_step(x.to(dev))
    reread = restored.eval_step(x.to(dev))
    host, _, _ = recipes.build_trainer(
        recipes.load_config(CIFAR_CONFIG), True, device=torch.device("cpu"))
    host.load_state(trainer.state())
    plain = host.eval_step(x).numpy()
    card = writer.cpu().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    same = bool(torch.equal(writer, reread))
    log(f"test.main top-1 {score:.4f} on {EVAL_BATCHES * TRAIN_BATCH} "
        f"images; restored logits equal the writer's: {same}; card vs host "
        f"plain path max|diff|/max|logit| = {rel:.4g} (tol "
        f"{LOGIT_REL_TOL}); finite {bool(np.isfinite(card).all())}")
    if not same:
        raise AssertionError("restored model's logits differ")
    if card.shape != (TRAIN_BATCH, 100) or not np.isfinite(card).all() \
            or rel > LOGIT_REL_TOL:
        raise AssertionError("eval logits disagree with the plain path")
    # the checkpoint stays for the sngan_fid phase's extractor, which
    # removes it
    checks.update(top1=score, eval_logit_rel_err=rel, ckpt_dir=run_dir)

    # the train step's rate, after the runs above (it moves the weights)
    xd = x.to(dev)
    yd = torch.from_numpy(val_set.source.labels[:TRAIN_BATCH]).to(dev)
    for _ in range(3):
        trainer.train_step(xd, yd)
    torch.cuda.synchronize()
    iters = 20
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer.train_step(xd, yd)
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / iters
    busy, span, n_kernels, top = device_busy(
        lambda: trainer.train_step(xd, yd))
    rate = dict(step_ms=step_ms, images_per_sec=TRAIN_BATCH * 1e3 / step_ms,
                host_enqueue_ms=host_ms, device_busy_ms=busy,
                device_span_ms=span, kernels_per_step=n_kernels,
                top_kernels=top)
    log(f"train step (batch {TRAIN_BATCH}, CUDA events over {iters} steps "
        f"after 3 warm-up): {step_ms:.3f} ms, "
        f"{rate['images_per_sec']:.1f} images/s; host enqueue "
        f"{host_ms:.3f} ms/step; torch.profiler: device busy "
        f"{busy if busy is None else round(busy, 3)} ms/step over "
        f"{n_kernels:.0f} kernels")
    checks["train_step"] = rate
    return train_counts, eval_counts, checks


def vit_cfg(sets=()):
    from myconvnet_tpu_torch import recipes
    return recipes.apply_overrides(recipes.load_config(VIT_CONFIG),
                                   [*VIT_SET, *sets])


def policy_launches(name, steps=1):
    """RandAugment kernel launches of ``steps`` train steps under a
    policy of AUG_POLICIES."""
    per_step = POLICY_RUNS[name][1] if name in POLICY_RUNS else {}
    return {k: per_step.get(k, 0) * steps
            for k in ("shear_rows", "randaugment_ew")}


def on_cpu(draws):
    """RandAugment or AutoAugment draws (a tuple of tensors) on the host."""
    return None if draws is None else type(draws)(*(t.cpu() for t in draws))


def check_policies_against_host(dev):
    """augment_train of VIT_STEP1_BATCH synthetic images (256x256 -> 224
    crops) with the same boxes, flips and policy draws on the card
    (kernels) and on the host (plain versions), for the recipe as written
    and each setting of POLICY_RUNS; launches counted on the card."""
    import torch

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.data import augment
    from myconvnet_tpu_torch.ops import kernels

    xs = torch.from_numpy(recipes.make_sources(vit_cfg(), True, splits=(
        "train",))[0].images[:VIT_STEP1_BATCH])
    n = len(xs)
    g = torch.Generator(device=dev)
    out = {}
    for name, sets in AUG_POLICIES.items():
        if name == "off":
            continue
        cfg = recipes.make_augment(vit_cfg(sets)["augment"])
        g.manual_seed(SEED)
        boxes, flip = augment.sample_geometry(g, n, tuple(xs.shape[1:3]),
                                              cfg)
        draws = augment.sample_policy(g, n, cfg)
        kernels.reset_launch_counts()
        card = augment.augment_train(xs.to(dev), boxes, flip, cfg,
                                     policy=draws)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        host = augment.augment_train(xs, boxes.cpu(), flip.cpu(), cfg,
                                     policy=on_cpu(draws))
        diff = (card.cpu() - host).abs()
        frac = float((diff > POLICY_TOL).float().mean())
        ok = bool(torch.isfinite(card).all()) and frac <= POLICY_FRAC \
            and card.shape == host.shape == (n, 224, 224, 3)
        out[name] = dict(max_abs_diff=float(diff.max()), frac_over_tol=frac,
                         ok=ok)
        log(f"{name} policy, augment_train of {n} on the card vs the host: "
            f"max |diff| {float(diff.max()):.3g}, share of elements over "
            f"{POLICY_TOL:g}: {frac:.3g} (tol {POLICY_FRAC:g}) ok={ok}")
        check_counts(counts, policy_launches(name), f"{name} policy on the "
                     "card (one batch)")
        if not ok:
            raise AssertionError(f"{name} policy: the card disagrees with "
                                 "the host")
    return out


def vit_step_one(dev, cfg=None, n=VIT_STEP1_BATCH, what="ViT-B/16"):
    """Step 1 of the ViT-B/16 recipe (or another attention classifier's,
    ``cfg``) at batch ``n`` from seeded JAX-layout weights, with the same
    batch, crop boxes, flips, MixUp/CutMix draws and drop-path masks on
    the card and on the host."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, weights
    from myconvnet_tpu_torch.data.mix import MixDraws
    from myconvnet_tpu_torch.train.trainer import StepDraws

    cfg = cfg or vit_cfg()
    card, train_set, _ = recipes.build_trainer(cfg, True, device=dev)
    host, _, _ = recipes.build_trainer(cfg, True,
                                       device=torch.device("cpu"))
    params, state = weights.random_jax_params(card.model, SEED)
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    xs, ys = train_set.source.get_batch(np.arange(n))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    draws = card.sample(n, tuple(xs.shape[1:3]))
    on_host = StepDraws(draws.boxes.cpu(), draws.flip.cpu(),
                        MixDraws(*(t.cpu() for t in draws.mix)),
                        [{k: m.cpu() for k, m in d.items()}
                         for d in draws.masks], on_cpu(draws.policy))
    t0 = time.perf_counter()
    loss_card = float(card.loss_and_grads(x.to(dev), y.to(dev), draws)[0])
    t1 = time.perf_counter()
    loss_host = float(host.loss_and_grads(x, y, on_host)[0])
    t2 = time.perf_counter()
    dropped = sum(int((~m).sum()) for m in draws.masks[0].values())
    return step_one_verdict(
        f"{what} step 1 (batch {n})", card, host, loss_card, loss_host,
        f"; {len(draws.masks[0])} drop-path masks, {dropped} paths dropped; "
        f"card {t1 - t0:.2f}s (first, cold), host {t2 - t1:.2f}s")


def events_ms(fn, iters):
    """CUDA-event ms per call of ``fn`` from an idle device (host gaps
    included), host enqueue ms per call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms



def vit_train_and_check(dev):
    """ViT-B/16: step 1 against the host, train.main, the recipe's batch
    of 1024 and test.main; returns (train launches, test launches,
    checks)."""
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, test, train, weights
    from myconvnet_tpu_torch.ops import kernels

    checks = {"step1": vit_step_one(dev)}
    run_dir = os.path.join(ROOT, "build", "chip_smoke_vit")
    shutil.rmtree(run_dir, ignore_errors=True)
    sets = [a for kv in VIT_SET for a in ("--set", kv)]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    net = train.main([
        "--config", VIT_CONFIG, "--synthetic", "--steps", str(VIT_STEPS),
        "--val_every", str(VIT_VAL_EVERY), "--batch", str(VIT_BATCH),
        "--out", run_dir, *sets, "--set", f"accum_steps={VIT_ACCUM}",
        "--set", "log_every=1", "--device", dev.type])
    trainer = net.trainer
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    log(f"ViT train.main: {VIT_STEPS} steps of {VIT_BATCH} as {VIT_ACCUM} "
        f"microbatches in {time.perf_counter() - t0:.1f}s (checkpoints "
        "included)")
    micro = VIT_STEPS * VIT_ACCUM
    evals = (VIT_STEPS // VIT_VAL_EVERY + 1) * -(-VIT_SPLIT // VIT_BATCH)
    none = {k: 0 for k in kernels.WRAPPERS if k not in FLASH}
    check_counts(train_counts, {
        "flash_attention_fwd": VIT_DEPTH * (micro + evals),
        "flash_attention_dq": VIT_DEPTH * micro,
        "flash_attention_dkv": VIT_DEPTH * micro, **none},
        f"ViT train.main ({micro} microbatches, {evals} eval batches)")
    losses = read_losses(run_dir, VIT_STEPS, "ViT")
    cfg = vit_cfg()
    start, _, val_set = recipes.build_trainer(
        cfg, True, device=torch.device("cpu"))
    p0, _ = weights.to_jax(start.model)
    p1, _ = weights.to_jax(trainer.model)
    still = [f"{s}/{k}" for s in p0 for k in p0[s]
             if np.array_equal(p0[s][k], p1[s][k])]
    if still:
        raise AssertionError(f"parameters that did not move: {still[:5]}")
    log(f"ViT losses finite: first {losses[0]:.4f} last {losses[-1]:.4f}; "
        f"all {sum(len(v) for v in p0.values())} parameters moved")
    checks.update(losses=losses)

    kernels.reset_launch_counts()
    score, restored_net = test.main(["--config", VIT_CONFIG, "--synthetic",
                                     "--ckpt", run_dir, *sets,
                                     "--batch", str(VIT_BATCH),
                                     "--device", dev.type])
    restored = restored_net.trainer
    torch.cuda.synchronize()
    eval_counts = kernels.launch_counts()
    batches = -(-VIT_SPLIT // VIT_BATCH)
    check_counts(eval_counts, {"flash_attention_fwd": VIT_DEPTH * batches,
                               "flash_attention_dq": 0,
                               "flash_attention_dkv": 0, **none},
                 f"ViT test.main ({batches} eval batches)")
    xs, _ = val_set.source.get_batch(np.arange(VIT_STEP1_BATCH))
    x = torch.from_numpy(xs)
    writer = trainer.eval_step(x.to(dev))
    reread = restored.eval_step(x.to(dev))
    start.load_state(trainer.state())
    plain = start.eval_step(x).numpy()
    card = writer.cpu().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    same = bool(torch.equal(writer, reread))
    log(f"ViT test.main top-1 {score:.4f} on {len(val_set)} images; "
        f"restored logits equal the writer's: {same}; card vs host plain "
        f"path max|diff|/max|logit| = {rel:.4g} (tol {LOGIT_REL_TOL}); "
        f"finite {bool(np.isfinite(card).all())}")
    if not same:
        raise AssertionError("restored ViT's logits differ")
    if card.shape != (VIT_STEP1_BATCH, 1000) \
            or not np.isfinite(card).all() or rel > LOGIT_REL_TOL:
        raise AssertionError("ViT eval logits disagree with the plain path")
    checks.update(top1=score, eval_logit_rel_err=rel)
    keep_run(run_dir, "vit_b16")
    del start, restored

    # the recipe's batch: 1024 as 4 microbatches of 256, on the 256
    # synthetic images tiled four times
    train_set = recipes.make_sources(cfg, True, splits=("train",))[0]
    reps = VIT_RECIPE_BATCH // len(train_set)
    xd = torch.from_numpy(train_set.images).to(dev).repeat(reps, 1, 1, 1)
    yd = torch.from_numpy(train_set.labels).to(dev).repeat(reps)
    trainer.accum_steps = VIT_RECIPE_ACCUM
    for _ in range(2):
        trainer.train_step(xd, yd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    iters = 3
    step_ms, host_ms = events_ms(lambda: trainer.train_step(xd, yd),
                                 iters)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, span, n_kernels, top = device_busy(
        lambda: trainer.train_step(xd, yd), iters=1, warm=False)
    rate = dict(batch=VIT_RECIPE_BATCH, accum_steps=VIT_RECIPE_ACCUM,
                step_ms=step_ms,
                images_per_sec=VIT_RECIPE_BATCH * 1e3 / step_ms,
                host_enqueue_ms=host_ms, device_busy_ms=busy,
                device_span_ms=span,
                idle_share=None if busy is None else 1 - busy / step_ms,
                kernels_per_step=n_kernels, top_kernels=top,
                max_memory_allocated_gb=peak / 2 ** 30)
    log(f"ViT-B/16 recipe step (batch {VIT_RECIPE_BATCH} as "
        f"{VIT_RECIPE_ACCUM} x {VIT_RECIPE_BATCH // VIT_RECIPE_ACCUM}, CUDA "
        f"events over {iters} steps after 2 warm-up): {step_ms:.1f} ms, "
        f"{rate['images_per_sec']:.1f} images/s; host enqueue "
        f"{host_ms:.1f} ms/step; torch.profiler: device busy "
        f"{busy if busy is None else round(busy, 1)} ms/step over "
        f"{n_kernels:.0f} kernels, idle share "
        f"{rate['idle_share'] if busy is None else round(rate['idle_share'], 3)}"
        f"; max_memory_allocated {rate['max_memory_allocated_gb']:.1f} GiB")
    checks["recipe_step"] = rate

    return train_counts, eval_counts, checks


def vit_policy_runs(dev):
    """``train.main`` under each setting of POLICY_RUNS: POLICY_STEPS
    steps of VIT_BATCH as VIT_ACCUM microbatches and the final validation;
    returns ({setting: launch counts}, checks)."""
    import shutil

    import torch

    from myconvnet_tpu_torch import train
    from myconvnet_tpu_torch.ops import kernels

    micro = POLICY_STEPS * VIT_ACCUM
    evals = -(-VIT_SPLIT // VIT_BATCH)
    runs, checks = {}, {}
    for name, (sets, _) in POLICY_RUNS.items():
        run_dir = os.path.join(ROOT, "build", f"chip_smoke_vit_{name}")
        shutil.rmtree(run_dir, ignore_errors=True)
        t0 = time.perf_counter()
        kernels.reset_launch_counts()
        train.main([
            "--config", VIT_CONFIG, "--synthetic", "--steps",
            str(POLICY_STEPS), "--val_every", "0", "--batch", str(VIT_BATCH),
            "--out", run_dir,
            *[a for kv in (*VIT_SET, *sets) for a in ("--set", kv)],
            "--set", f"accum_steps={VIT_ACCUM}", "--set", "log_every=1",
            "--device", dev.type])
        torch.cuda.synchronize()
        runs[name] = kernels.launch_counts()
        seconds = time.perf_counter() - t0
        check_counts(runs[name], {
            **{k: 0 for k in kernels.WRAPPERS},
            "flash_attention_fwd": VIT_DEPTH * (micro + evals),
            "flash_attention_dq": VIT_DEPTH * micro,
            "flash_attention_dkv": VIT_DEPTH * micro,
            **policy_launches(name, POLICY_STEPS)},
            f"ViT train.main with {' '.join(sets)} ({POLICY_STEPS} steps, "
            f"{micro} microbatches, {evals} eval batches)")
        losses = read_losses(run_dir, POLICY_STEPS, name)
        log(f"{name}: losses {[round(v, 4) for v in losses]} in "
            f"{seconds:.1f}s (checkpoint included)")
        checks[name] = dict(losses=losses, seconds=seconds)
        shutil.rmtree(run_dir)
    return runs, checks


def augment_rates(dev):
    """``augment_train`` of VIT_RECIPE_BATCH images (the synthetic split
    tiled), its draws made once, under each policy of AUG_POLICIES: ms by
    CUDA events from an idle device (host gaps included) and the host's
    enqueue ms per call, device busy ms per call (torch.profiler), and the
    device-timed rate, images per second of device busy time.  One call
    runs under ``torch.cuda.set_sync_debug_mode("warn")`` to count the
    host syncs it makes."""
    import warnings

    import torch

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.data import augment

    src = recipes.make_sources(vit_cfg(), True, splits=("train",))[0]
    x = torch.from_numpy(src.images).to(dev).repeat(
        VIT_RECIPE_BATCH // len(src), 1, 1, 1)
    g = torch.Generator(device=dev).manual_seed(SEED)
    rates = {}
    for name, sets in AUG_POLICIES.items():
        cfg = recipes.make_augment(vit_cfg(sets)["augment"])
        mean_std = augment.stats(cfg, dev)
        boxes, flip = augment.sample_geometry(g, len(x), tuple(x.shape[1:3]),
                                              cfg)
        draws = augment.sample_policy(g, len(x), cfg)

        def fn():
            return augment.augment_train(x, boxes, flip, cfg, mean_std,
                                         draws)

        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = [str(w.message)[:120] for w in caught
                 if "synchroniz" in str(w.message)]
        ms, host_ms = events_ms(fn, 5)
        busy, _, n_kernels, top = device_busy(fn, iters=3)
        rates[name] = dict(
            ms=ms, host_enqueue_ms=host_ms, device_busy_ms=busy,
            kernels=n_kernels, host_syncs=len(syncs), sync_examples=syncs[:3],
            images_per_sec=None if busy is None else len(x) * 1e3 / busy,
            top_kernels=top[:5])
        log(f"augment_train of {len(x)} ({name}{': ' if sets else ''}"
            f"{' '.join(sets)}): {ms:.3f} ms by events, host enqueue "
            f"{host_ms:.3f} ms, device busy "
            f"{busy if busy is None else round(busy, 3)} ms over "
            f"{n_kernels:.0f} kernels -> {rates[name]['images_per_sec']} "
            f"images/s of device time; host syncs in a call: {len(syncs)} "
            f"{syncs[:1]}")
    return rates


def flow_cfg(path, sets=()):
    from myconvnet_tpu_torch import recipes
    return recipes.apply_overrides(
        recipes.load_config(path),
        [f"synthetic_n={FLOW_SCENES}", *sets])


def pwc_step_one(dev):
    """Step 1 of the PWC-Net recipe at batch PWC_STEP1_BATCH of 384x512
    from seeded JAX-layout weights, random and non-zero in the flow heads
    too, with the same pairs, flips and jitter factors on the card (the
    correlation kernels, forward and backward) and on the host (the plain
    version and its autograd)."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, weights
    from myconvnet_tpu_torch.data.augment import JitterDraws
    from myconvnet_tpu_torch.ops import kernels
    from myconvnet_tpu_torch.train.trainer import StepDraws

    n = PWC_STEP1_BATCH
    cfg = flow_cfg(PWC_CONFIG, [f"synthetic_n={n}"])
    card, train_set, _ = recipes.build_trainer(cfg, True, device=dev)
    host, _, _ = recipes.build_trainer(cfg, True, device=torch.device("cpu"))
    params, state = weights.random_jax_params(card.model, SEED)
    heads = [s for s in params if s.split("/")[-1] == "flow"]
    if len(heads) != PWC_LEVELS + 1 or not all(
            np.any(params[s]["w"]) for s in heads):
        raise AssertionError(f"flow heads not random: {heads}")
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    xs, ys = train_set.source.get_batch(np.arange(n))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    draws = card.sample(n, tuple(xs.shape[1:3]))
    flip, jitter = draws.recipe
    on_host = StepDraws(None, None, None, recipe=type(draws.recipe)(
        flip.cpu(), JitterDraws(*(None if t is None else t.cpu()
                                  for t in jitter))))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss_card = float(card.loss_and_grads(x.to(dev), y.to(dev), draws)[0])
    t1 = time.perf_counter()
    counts = kernels.launch_counts()
    loss_host = float(host.loss_and_grads(x, y, on_host)[0])
    t2 = time.perf_counter()
    check_counts(counts, {**{k: 0 for k in kernels.WRAPPERS},
                          **{k: PWC_LEVELS for k in CORR}},
                 "PWC-Net step 1 on the card")
    record = step_one_verdict(
        f"PWC-Net step 1 (batch {n} of {xs.shape[1]}x{xs.shape[2]})", card,
        host, loss_card, loss_host,
        f"; card {t1 - t0:.2f}s (first, cold), host {t2 - t1:.2f}s")
    if record["smallest_host_norm"] == 0.0:
        raise AssertionError("PWC-Net step 1: a gradient vanishes; the "
                             "flow heads must not be zero")
    # the eval flows from the same random weights: flows of whole pixels
    # (a trained-from-zero head's are hundredths of one), so a wrong volume
    # or warp shows
    flow_card = card.eval_step(x.to(dev)).float().cpu().numpy()
    flow_host = host.eval_step(x).float().numpy()
    top = float(np.abs(flow_host).max())
    rel = float(np.abs(flow_card - flow_host).max() / top)
    log(f"PWC-Net eval flows from random heads, card vs host plain path: "
        f"max|diff|/max|flow| = {rel:.4g} (tol {FLOW_REL_TOL}); max|flow| "
        f"{top:.3g} px")
    if flow_card.shape != (n, *xs.shape[1:3], 2) \
            or not np.isfinite(flow_card).all() or top < 1.0 \
            or rel > FLOW_REL_TOL:
        raise AssertionError("PWC-Net eval flows from random heads disagree "
                             "with the plain path")
    record.update(eval_flow_rel_err=rel, eval_flow_max_px=top)
    return record


def pwc_train_and_check(dev):
    """PWC-Net at full width: step 1 against the host, ``train.main``,
    the step's rate and ``test.main``; returns (train launches, test
    launches, checks)."""
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import models, recipes, test, train, weights
    from myconvnet_tpu_torch.core.init import init_model
    from myconvnet_tpu_torch.ops import kernels

    checks = {"step1": pwc_step_one(dev)}
    torch.cuda.empty_cache()
    run_dir = os.path.join(ROOT, "build", "chip_smoke_pwc")
    shutil.rmtree(run_dir, ignore_errors=True)
    sets = ["--set", f"synthetic_n={FLOW_SCENES}"]
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    net = train.main([
        "--config", PWC_CONFIG, "--synthetic", "--steps", str(PWC_STEPS),
        "--val_every", str(PWC_VAL_EVERY), "--batch", str(FLOW_BATCH),
        "--out", run_dir, *sets, "--set", "log_every=1",
        "--device", dev.type])
    trainer = net.trainer
    torch.cuda.synchronize()
    train_counts = kernels.launch_counts()
    log(f"PWC-Net train.main: {PWC_STEPS} steps of {FLOW_BATCH} pairs in "
        f"{time.perf_counter() - t0:.1f}s (rendering 2 x {FLOW_SCENES} "
        "scenes and the checkpoints included)")
    batches = -(-FLOW_SCENES // FLOW_BATCH)
    evals = (PWC_STEPS // PWC_VAL_EVERY + 1) * batches
    check_counts(train_counts, {
        **{k: 0 for k in kernels.WRAPPERS},
        "correlation_fwd": PWC_LEVELS * (PWC_STEPS + evals),
        "correlation_bwd_f1": PWC_LEVELS * PWC_STEPS,
        "correlation_bwd_f2": PWC_LEVELS * PWC_STEPS},
        f"PWC-Net train.main ({PWC_STEPS} steps, {evals} eval batches)")
    losses = read_losses(run_dir, PWC_STEPS, "PWC-Net")
    cfg = flow_cfg(PWC_CONFIG)
    start = init_model(models.pwcnet(0), torch.Generator().manual_seed(
        cfg["seed"]))
    p0, _ = weights.to_jax(start)
    p1, _ = weights.to_jax(trainer.model)
    still = [f"{s}/{k}" for s in p0 for k in p0[s]
             if np.array_equal(p0[s][k], p1[s][k])]
    if still:
        raise AssertionError(f"parameters that did not move: {still[:5]}")
    log(f"PWC-Net losses finite: first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}; all {sum(len(v) for v in p0.values())} "
        "parameters moved (flow heads and pyramid among them)")
    checks.update(losses=losses)

    kernels.reset_launch_counts()
    score, restored_net = test.main(["--config", PWC_CONFIG, "--synthetic",
                                     "--ckpt", run_dir, *sets,
                                     "--batch", str(FLOW_BATCH),
                                     "--device", dev.type])
    restored = restored_net.trainer
    torch.cuda.synchronize()
    eval_counts = kernels.launch_counts()
    check_counts(eval_counts, {**{k: 0 for k in kernels.WRAPPERS},
                               "correlation_fwd": PWC_LEVELS * batches},
                 f"PWC-Net test.main ({batches} eval batches)")
    small = flow_cfg(PWC_CONFIG, [f"synthetic_n={FLOW_BATCH}"])
    host, _, val_set = recipes.build_trainer(small, True,
                                             device=torch.device("cpu"))
    xs, ys = val_set.source.get_batch(np.arange(FLOW_BATCH))
    x = torch.from_numpy(xs)
    few = x[:PWC_STEP1_BATCH]
    writer = trainer.eval_step(few.to(dev))
    reread = restored.eval_step(few.to(dev))
    host.load_state(trainer.state())
    plain = host.eval_step(few).numpy()
    card = writer.cpu().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    same = bool(torch.equal(writer, reread))
    log(f"PWC-Net test.main AEPE {score:.4f} on {FLOW_SCENES} pairs; "
        f"restored flows equal the writer's: {same}; card vs host plain "
        f"path max|diff|/max|flow| = {rel:.4g} (tol {FLOW_REL_TOL}); "
        f"max|flow| {np.abs(plain).max():.3g}; finite "
        f"{bool(np.isfinite(card).all())}")
    if not same:
        raise AssertionError("restored PWC-Net's flows differ")
    if card.shape != (PWC_STEP1_BATCH, *xs.shape[1:3], 2) \
            or not np.isfinite(card).all() or not np.isfinite(score) \
            or rel > FLOW_REL_TOL:
        raise AssertionError("PWC-Net eval flows disagree with the plain "
                             "path")
    checks.update(aepe=score, eval_flow_rel_err=rel)
    keep_run(run_dir, "pwcnet")
    del host, restored, restored_net

    # the recipe's step at batch 32, after the runs above (it moves the
    # weights)
    xd, yd = x.to(dev), torch.from_numpy(ys).to(dev)
    for _ in range(2):
        trainer.train_step(xd, yd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    iters = 5
    step_ms, host_ms = events_ms(lambda: trainer.train_step(xd, yd), iters)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, span, n_kernels, top = device_busy(
        lambda: trainer.train_step(xd, yd), iters=2)
    rate = dict(batch=FLOW_BATCH, step_ms=step_ms,
                pairs_per_sec=FLOW_BATCH * 1e3 / step_ms,
                host_enqueue_ms=host_ms, device_busy_ms=busy,
                device_span_ms=span,
                idle_share=None if busy is None else 1 - busy / step_ms,
                kernels_per_step=n_kernels, top_kernels=top,
                max_memory_allocated_gb=peak / 2 ** 30)
    idle = rate["idle_share"]
    log(f"PWC-Net recipe step (batch {FLOW_BATCH} of {xs.shape[1]}x"
        f"{xs.shape[2]}, CUDA events over {iters} steps after 2 warm-up): "
        f"{step_ms:.1f} ms, {rate['pairs_per_sec']:.1f} pairs/s; host "
        f"enqueue {host_ms:.1f} ms/step; torch.profiler: device busy "
        f"{busy if busy is None else round(busy, 1)} ms/step over "
        f"{n_kernels:.0f} kernels, idle share "
        f"{idle if idle is None else round(idle, 3)}"
        f"; max_memory_allocated {rate['max_memory_allocated_gb']:.1f} GiB")
    for name, ms, per in top[:6]:
        log(f"  {ms:8.3f} ms/step x{per:5.0f}  {name}")
    checks["recipe_step"] = rate
    return train_counts, eval_counts, checks


def flownetc_run(dev):
    """FlowNetC at width 64 through the FlowNetS recipe: FLOWNETC_STEPS
    steps at batch 32 and the final validation of one batch; returns
    (launches, checks)."""
    import shutil

    import torch

    from myconvnet_tpu_torch import train
    from myconvnet_tpu_torch.ops import kernels

    run_dir = os.path.join(ROOT, "build", "chip_smoke_flownetc")
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    net = train.main([
        "--config", FLOWNET_CONFIG, "--synthetic", "--steps",
        str(FLOWNETC_STEPS), "--val_every", "0", "--batch", str(FLOW_BATCH),
        "--out", run_dir, "--set", "model=flownet_c", "--set",
        f"synthetic_n={FLOW_BATCH}", "--set", "log_every=1",
        "--device", dev.type])
    trainer = net.trainer
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    seconds = time.perf_counter() - t0
    check_counts(counts, {**{k: 0 for k in kernels.WRAPPERS},
                          "correlation_fwd": FLOWNETC_STEPS + 1,
                          "correlation_bwd_f1": FLOWNETC_STEPS,
                          "correlation_bwd_f2": FLOWNETC_STEPS},
                 f"FlowNetC train.main ({FLOWNETC_STEPS} steps, 1 eval "
                 "batch)")
    losses = read_losses(run_dir, FLOWNETC_STEPS, "FlowNetC")
    if type(trainer.model).__name__ != "FlowNetC":
        raise AssertionError("the run did not build FlowNetC")
    log(f"FlowNetC: losses {[round(v, 4) for v in losses]} in "
        f"{seconds:.1f}s (rendering and checkpoint included)")
    shutil.rmtree(run_dir)
    return counts, dict(losses=losses, seconds=seconds)


def classifier_cfg(path, sets=()):
    from myconvnet_tpu_torch import recipes
    return recipes.apply_overrides(recipes.load_config(path), list(sets))


def grad_norms(trainer):
    """{JAX path: the norm of the parameter's gradient}."""
    from myconvnet_tpu_torch import weights
    return {path: 0.0 if p.grad is None else float(p.grad.float().norm())
            for path, p, _ in weights.param_views(trainer.model)}


def norm_gaps(got, want):
    """[(|got - want| / want, path, want / the largest want)], worst
    first."""
    biggest = max(want.values())
    return sorted(((abs(got[k] - v) / max(v, 1e-30), k, v / biggest)
                   for k, v in want.items()), reverse=True)


def nudged(params, seed):
    """The parameter tree with every non-zero value moved one float32 ulp
    up or down (seeded signs): a float32 rounding of the weights."""
    import numpy as np
    rng = np.random.RandomState(seed)

    def move(v):
        to = np.where(rng.rand(*v.shape) < 0.5, np.inf, -np.inf)
        return np.where(v == 0, v, np.nextafter(v, to.astype(np.float32)))

    return {s: {k: move(v) for k, v in d.items()}
            for s, d in params.items()}


def step_one_classifier(dev, what, cfg, n):
    """Step 1 of a classification recipe at batch ``n`` from seeded
    JAX-layout weights, with the same batch and draws (crop boxes, flips,
    colour-jitter factors, dropout masks) on the card and on the host,
    under the float32 policy (TF32 off) and under the recipe's bf16, with
    witnesses of how far rounding alone moves each gradient norm: the
    host's float32 step with the weights moved one float32 ulp, the
    card's float32 step without cuDNN (another summation order), and the
    host's bf16 step against its float32 one.  Float32: the two sides'
    augmented batches within STEP1_INPUTS_RTOL, the steps within
    STEP1_F32_*, and the host's step on the card's augmented batch within
    STEP1_F32_MODEL_*; bf16 at STEP1_GRAD_RTOL or twice bf16's own reach
    on the host (W), whichever is larger."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, weights
    from myconvnet_tpu_torch.data.augment import JitterDraws, augment_train
    from myconvnet_tpu_torch.train.trainer import StepDraws

    def cpu(t):
        return None if t is None else t.cpu()

    def on_host(d):
        return StepDraws(
            cpu(d.boxes), cpu(d.flip), None,
            None if d.masks is None else
            [{k: m.cpu() for k, m in m_.items()} for m_ in d.masks], None,
            None if d.jitter is None else JitterDraws(*map(cpu, d.jitter)))

    params = state = draws = None
    runs, seconds = {}, {}
    for prec in ("f32", "bf16"):
        c = dict(cfg, synthetic_n=n, precision=prec)
        card, train_set, _ = recipes.build_trainer(c, True, device=dev)
        host, _, _ = recipes.build_trainer(c, True,
                                           device=torch.device("cpu"))
        if params is None:
            params, state = weights.random_jax_params(card.model, SEED)
            xs, ys = train_set.source.get_batch(np.arange(n))
            x, y = torch.from_numpy(xs), torch.from_numpy(ys)
            draws = card.sample(n, tuple(xs.shape[1:3]))
            if draws.mix is not None or draws.policy is not None:
                raise AssertionError(f"{what}: draws this check does not "
                                     "carry")
        todo = [("card", card, params, x.to(dev), y.to(dev), draws),
                ("host", host, params, x, y, on_host(draws))]
        if prec == "f32":
            # the augmented batch on each side (crop-resize, jitter,
            # normalize), and the host's step on the card's
            sides = ((card, x.to(dev), draws), (host, x, on_host(draws)))
            aug = [augment_train(xi, d.boxes, d.flip, t.augment,
                                 t._mean_std, None, d.jitter)
                   for t, xi, d in sides]
            inputs_rel = float((aug[0].cpu() - aug[1]).abs().max()
                               / aug[1].abs().max())
            # the same without the colour jitter: crop-resize and normalize
            plain = [augment_train(xi, d.boxes, d.flip, t.augment._replace(
                brightness=0.0, contrast=0.0, saturation=0.0, hue=0.0),
                t._mean_std) for t, xi, d in sides]
            crop_rel = float((plain[0].cpu() - plain[1]).abs().max()
                             / plain[1].abs().max())
            del plain
            todo += [("host nudged", host, nudged(params, SEED + 1), x, y,
                      on_host(draws)),
                     ("card without cuDNN", card, params, x.to(dev),
                      y.to(dev), draws),
                     ("host on the card's inputs", host, params,
                      aug[0].cpu(), y, on_host(draws))]
        for where, t, p, xi, yi, d in todo:
            weights.from_jax(t.model, p, state)
            t0 = time.perf_counter()
            # only this flag: cudnn.flags() would set the others, TF32 on
            torch.backends.cudnn.enabled = "without cuDNN" not in where
            augment = t.augment
            if "inputs" in where:
                t.augment = None
            try:
                loss = float(t.loss_and_grads(xi, yi, d)[0])
            finally:
                torch.backends.cudnn.enabled = True
                t.augment = augment
            seconds[where, prec] = time.perf_counter() - t0
            runs[where, prec] = (loss, grad_norms(t))
        del card, host
    masks = sum(len(d) for d in draws.masks or [])
    out = {}
    for key, (a, b) in {
            "card vs host, float32": (("card", "f32"), ("host", "f32")),
            "host nudged vs host, float32": (("host nudged", "f32"),
                                             ("host", "f32")),
            "card without cuDNN vs card, float32": (
                ("card without cuDNN", "f32"), ("card", "f32")),
            "card vs host on the card's inputs, float32": (
                ("card", "f32"), ("host on the card's inputs", "f32")),
            "card vs host, bf16": (("card", "bf16"), ("host", "bf16")),
            "host bf16 vs host float32": (("host", "bf16"), ("host", "f32")),
            "card bf16 vs card float32": (("card", "bf16"), ("card", "f32"))
            }.items():
        gaps = norm_gaps(runs[a][1], runs[b][1])
        loss_rel = abs(runs[a][0] - runs[b][0]) / abs(runs[b][0])
        out[key] = dict(loss_rel=loss_rel, worst=gaps[:5],
                        over_1e_3=sum(g > 1e-3 for g, _, _ in gaps))
        log(f"{what} step 1 (batch {n}) {key}: loss rel {loss_rel:.3g}; "
            f"{len(gaps)} gradient norms, {out[key]['over_1e_3']} over "
            f"1e-3 rel; worst: " + "; ".join(
                f"{k} {g:.3g} (norm {r:.3g} of the largest)"
                for g, k, r in gaps[:3]))
    log(f"{what} step 1 (batch {n}): augmented inputs, card vs host, max "
        f"|diff| / max |x| {inputs_rel:.3g} ({crop_rel:.3g} without the "
        "colour jitter)")
    log(f"{what} step 1 (batch {n}): {masks} dropout masks; seconds "
        + ", ".join(f"{w} {p} {t:.2f}" for (w, p), t in seconds.items()))
    if not inputs_rel <= STEP1_INPUTS_RTOL:
        raise AssertionError(f"{what}: the augmented batches differ by "
                             f"{inputs_rel:.3g} of max |x|")
    (lc, nc), (lh, nh) = runs["card", "f32"], runs["host", "f32"]
    f32 = step_one_verdict(
        f"{what} step 1 (batch {n}, float32)", nc, nh, lc, lh,
        loss_rtol=STEP1_F32_LOSS_RTOL, grad_rtol=STEP1_F32_GRAD_RTOL,
        grad_atol=STEP1_F32_GRAD_ATOL)
    lm, nm = runs["host on the card's inputs", "f32"]
    model = step_one_verdict(
        f"{what} step 1 (batch {n}, float32, the card's augmented batch on "
        "both)", nc, nm, lc, lm, loss_rtol=STEP1_F32_MODEL_LOSS_RTOL,
        grad_rtol=STEP1_F32_MODEL_GRAD_RTOL, grad_atol=STEP1_F32_GRAD_ATOL)
    # bf16: W, the furthest the host's bf16 step moves a gradient norm
    # from its float32 one (leaves above STEP1_GRAD_ATOL of the largest),
    # is how far bf16 rounding reaches here; two bf16 roundings of one
    # float32 step may sit 2W apart
    hb, hf = runs["host", "bf16"][1], runs["host", "f32"][1]
    big = max(hf.values())
    reach = max(abs(hb[k] - v) / v for k, v in hf.items()
                if v >= STEP1_GRAD_ATOL * big)
    if reach > STEP1_BF16_MAX_REACH:
        raise AssertionError(f"{what}: bf16 moves the host's gradient norms "
                             f"by {reach:.3g}; a bound of twice that holds "
                             "nothing")
    (lcb, ncb), (lhb, nhb) = runs["card", "bf16"], runs["host", "bf16"]
    bf16 = step_one_verdict(
        f"{what} step 1 (batch {n}, bf16)", ncb, nhb, lcb, lhb,
        f"; bf16's own reach on the host W = {reach:.3g}",
        grad_rtol=max(STEP1_GRAD_RTOL, 2 * reach))
    return dict(f32, on_the_cards_inputs=model, bf16=dict(bf16, reach=reach),
                comparisons=out, inputs_rel=inputs_rel,
                inputs_rel_without_jitter=crop_rel,
                seconds={f"{w} {p}": t for (w, p), t in seconds.items()})


def step_rate(dev, trainer, batch, raw_hw, iters, masks=False, warmup=1,
              args=None):
    """The train step at ``batch`` seeded uint8 images of ``raw_hw`` (and
    class masks of that size when ``masks``, else a label an image), or on
    the step's prepared arguments ``args`` (``batch`` then the images they
    hold), after ``warmup`` steps (1 where ``train.main`` has run the
    trainer, 2 for a fresh one): CUDA-event ms from an idle device (host
    gaps included), host enqueue ms, device busy ms and top kernels
    (torch.profiler), the idle share and the peak of allocated memory.
    Returns (that dict, the arguments)."""
    import torch

    if args is None:
        g = torch.Generator(device=dev).manual_seed(SEED)
        xd = torch.randint(0, 256, (batch, *raw_hw, 3), generator=g,
                           device=dev, dtype=torch.uint8)
        yd = torch.randint(0, trainer.num_classes,
                           (batch, *raw_hw) if masks else (batch,),
                           generator=g, device=dev,
                           dtype=torch.int32 if masks else torch.int64)
        args = (xd, yd)
    for _ in range(warmup):
        trainer.train_step(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, host_ms = events_ms(lambda: trainer.train_step(*args), iters)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, span, n_kernels, top = device_busy(
        lambda: trainer.train_step(*args), iters=1, warm=False)
    # (the distillation and FixMatch trainers take no microbatches)
    return dict(batch=batch, accum_steps=getattr(trainer, "accum_steps", 1),
                step_ms=step_ms, images_per_sec=batch * 1e3 / step_ms,
                host_enqueue_ms=host_ms, device_busy_ms=busy,
                device_span_ms=span,
                idle_share=None if busy is None else 1 - busy / step_ms,
                kernels_per_step=n_kernels, top_kernels=top,
                max_memory_allocated_gb=peak / 2 ** 30), args


def log_rate(what, r):
    log(f"{what} train step (batch {r['batch']} as {r['accum_steps']} x "
        f"{r['batch'] // r['accum_steps']}): {r['step_ms']:.2f} ms, "
        f"{r['images_per_sec']:.1f} images/s; host enqueue "
        f"{r['host_enqueue_ms']:.2f} ms/step; device busy "
        f"{r['device_busy_ms']} ms/step over {r['kernels_per_step']:.0f} "
        f"kernels, idle share {r['idle_share']}; max_memory_allocated "
        f"{r['max_memory_allocated_gb']:.2f} GiB; top: "
        + "; ".join(f"{n[:50]} {ms:.2f} ms x{k:g}"
                    for n, ms, k in r["top_kernels"][:3]))


def classifier_run(dev, what, config, sets, *, steps, batch, val_every,
                   forward, split, check_n, per_step=None, eval_input=None,
                   rate_iters=3, raw_hw=None, shapes=None, keep=None):
    """``train.main`` for ``steps`` steps at ``batch`` (``sets``: the
    overrides) validating every ``val_every`` steps and at the end, then
    ``test.main`` on its checkpoint: each run's launches against
    ``forward`` (an eval forward's) times the eval batches of the
    ``split``-image split plus ``eval_input`` (an eval batch's input
    kernels) and ``per_step`` (a train step's); every loss finite; the
    restored logits equal the writer's and agree with the host's plain
    path on ``check_n`` images; then the step's rate (:func:`step_rate`).
    With ``shapes`` (a dict) each run's launches are also recorded by
    shape (:func:`launch_shapes`) into ``shapes["train"]`` and
    ``shapes["test"]``.  ``keep``: the run is kept for the export phase's
    case of that name (:func:`keep_run`).  Returns (train launches, test
    launches, checks, trainer)."""
    import shutil
    from collections import Counter

    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, test, train
    from myconvnet_tpu_torch.ops import kernels

    run_dir = os.path.join(ROOT, "build", "chip_smoke_" + "".join(
        c if c.isalnum() else "_" for c in what.lower()))
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", config, "--synthetic", "--batch", str(batch),
            *[a for kv in sets for a in ("--set", kv)], "--device", dev.type]
    def recorded(run):
        if shapes is None:
            return contextlib.nullcontext()
        return launch_shapes(shapes.setdefault(run, Counter()))

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with recorded("train"):
        net = train.main(args + ["--steps", str(steps), "--val_every",
                                 str(val_every), "--out", run_dir, "--set",
                                 "log_every=1"])
        torch.cuda.synchronize()
    trainer = net.trainer
    train_counts = kernels.launch_counts()
    seconds = time.perf_counter() - t0
    batches = -(-split // batch)
    evals = ((steps // val_every if val_every else 0) + 1) * batches

    def expect(n_steps, n_batches):
        want = Counter({k: 0 for k in kernels.WRAPPERS})
        for k, v in (per_step or {}).items():
            want[k] += v * n_steps
        for k, v in {**forward, **(eval_input or {})}.items():
            want[k] += v * n_batches
        return dict(want)

    check_counts(train_counts, expect(steps, evals),
                 f"{what} train.main ({steps} steps, {evals} eval batches)")
    losses = read_losses(run_dir, steps, what)
    logged = logged_rate(run_dir, batch)
    log(f"{what}: train.main {steps} steps of {batch} in {seconds:.1f}s "
        f"(data, cuDNN plans and checkpoint included); losses finite, "
        f"first {losses[0]:.4f} last {losses[-1]:.4f}")

    kernels.reset_launch_counts()
    with recorded("test"):
        score, restored_net = test.main(args + ["--ckpt", run_dir])
        torch.cuda.synchronize()
    restored = restored_net.trainer
    eval_counts = kernels.launch_counts()
    check_counts(eval_counts, expect(0, batches),
                 f"{what} test.main ({batches} eval batches)")
    cfg = classifier_cfg(config, sets)
    val = recipes.make_sources(dict(cfg, synthetic_n=check_n), True,
                               splits=("val",))[0]
    x = torch.from_numpy(val.images)
    writer = trainer.eval_step(x.to(dev))
    reread = restored.eval_step(x.to(dev))
    host, _, _ = recipes.build_trainer(dict(cfg, synthetic_n=check_n),
                                       True, device=torch.device("cpu"))
    host.load_state(trainer.state())
    plain = host.eval_step(x).numpy()
    card = writer.cpu().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    tol = LOGIT_REL_TOL if cfg.get("precision") == "bf16" \
        else LOGIT_REL_TOL_F32
    same = bool(torch.equal(writer, reread))
    log(f"{what} test.main top-1 {score:.4f}; restored logits equal the "
        f"writer's: {same}; card vs host plain path on {check_n} images "
        f"max|diff|/max|logit| = {rel:.4g} (tol {tol}); finite "
        f"{bool(np.isfinite(card).all())}")
    if not same:
        raise AssertionError(f"{what}: restored logits differ")
    if card.shape != (check_n, cfg["num_classes"]) \
            or not np.isfinite(card).all() or rel > tol:
        raise AssertionError(f"{what}: eval logits disagree with the "
                             "plain path")
    if keep:
        keep_run(run_dir, keep)
    else:
        shutil.rmtree(run_dir)
    del restored, host, restored_net
    rate, batch_xy = step_rate(dev, trainer, batch,
                               raw_hw or tuple(x.shape[1:3]), rate_iters)
    log_rate(what, rate)
    checks = dict(losses=losses, train_seconds=seconds, top1=score,
                  eval_logit_rel_err=rel, step=rate, logged_rate=logged)
    return train_counts, eval_counts, checks, trainer, batch_xy


def resnet50_train_and_check(dev, step1):
    """ResNet-50 training, the recipe as written: step 1 on the card
    against the host; ``train.main`` for R50_STEPS steps of R50_BATCH as
    R50_ACCUM microbatches and ``test.main`` (13 conv_pair and 7 bn_act
    launches an eval batch, none in a train step); the step's rate, then
    again with ``augment.interp_dtype`` bfloat16, and the augmentation
    alone under each interpolation dtype."""
    import torch

    from myconvnet_tpu_torch.data import augment

    cfg = classifier_cfg(CONFIG)
    checks = {"step1": step1}
    train_counts, eval_counts, run, trainer, (xd, yd) = classifier_run(
        dev, "ResNet-50", CONFIG,
        [f"accum_steps={R50_ACCUM}", f"synthetic_n={R50_BATCH}"],
        steps=R50_STEPS, batch=R50_BATCH, val_every=0,
        forward=FORWARD["resnet50"], split=R50_BATCH,
        check_n=STEP1_BATCH["resnet50"], raw_hw=tuple(cfg["raw_hw"]),
        keep="resnet50")
    checks.update(run)
    f32_cfg = trainer.augment
    bf16_cfg = f32_cfg._replace(interp_dtype="bfloat16")
    trainer.augment = bf16_cfg
    try:
        trainer.train_step(xd, yd)
        torch.cuda.synchronize()
        ms, host_ms = events_ms(lambda: trainer.train_step(xd, yd), 3)
    finally:
        trainer.augment = f32_cfg
    checks["step_bf16_interp"] = dict(
        step_ms=ms, images_per_sec=R50_BATCH * 1e3 / ms,
        host_enqueue_ms=host_ms)
    log(f"ResNet-50 train step under augment.interp_dtype=bfloat16: "
        f"{ms:.2f} ms, {R50_BATCH * 1e3 / ms:.1f} images/s (float32: "
        f"{run['step']['step_ms']:.2f} ms)")
    # the augmentation alone; its colour jitter makes host syncs (a
    # constant copied to the device each call), so the stream cannot be
    # held: CUDA events from an idle device and the device busy time, as
    # augment_rates times the ViT's
    draws = trainer.sample(R50_BATCH, tuple(xd.shape[1:3]))
    crop = {}
    for cfg_dt in (f32_cfg, bf16_cfg):
        def fn():
            return augment.augment_train(xd, draws.boxes, draws.flip,
                                         cfg_dt, trainer._mean_std, None,
                                         draws.jitter)
        fn()
        ms, host_ms = events_ms(fn, 5)
        busy, _, n_kernels, _ = device_busy(fn, iters=3)
        crop[cfg_dt.interp_dtype] = dict(ms=ms, host_enqueue_ms=host_ms,
                                         device_busy_ms=busy,
                                         kernels=n_kernels)
    checks["augment_train"] = crop
    log(f"augment_train of {R50_BATCH} x {list(xd.shape[1:3])} -> "
        f"{list(f32_cfg.out_hw)} (crop-resize, jitter, normalize): "
        + ", ".join(
            f"{k} {v['ms']:.3f} ms by events, device busy "
            f"{v['device_busy_ms']} ms over {v['kernels']:.0f} kernels"
            for k, v in crop.items()))
    return train_counts, eval_counts, checks


def smallnet_runs(dev):
    """SmallNet through train.main and test.main on CIFAR-10 as written
    (float32) and under precision=bf16, then short runs on SVHN and
    Fashion-MNIST: pad_crop_u8 once a train step; normalize_u8 once and the
    forward's launches an eval batch.  Returns ({run: (train, test)
    launches}, checks)."""
    counts, checks = {}, {}
    for run, recipe, sets, steps, val_every in SMALLNET_RUNS:
        policy = "bf16" if "precision=bf16" in sets else "f32"
        train_c, test_c, checks[run], trainer, _ = classifier_run(
            dev, f"SmallNet {run}", SMALLNET_CONFIGS[recipe], sets,
            steps=steps, batch=SMALLNET_BATCH, val_every=val_every,
            forward=FORWARD[f"smallnet {policy}"], split=SMALLNET_SPLIT,
            check_n=SMALLNET_BATCH, per_step={"pad_crop_u8": 1},
            eval_input={"normalize_u8": 1}, rate_iters=20)
        counts[run] = (train_c, test_c)
        del trainer
    return counts, checks


def big_classifier_run(dev, name, step1):
    """VGG-16 or DenseNet-121 (BIG_RUNS), with its step 1 on the card
    against the host (``step1``, :func:`classifier_step_ones`'s);
    ``train.main`` for a few steps at the recipe's global batch in
    its microbatches and ``test.main``; the step's rate and peak memory.
    Returns (train launches, test launches, checks)."""
    import torch

    config, batch, accum, steps = BIG_RUNS[name]
    what = CLASSIFIER_NAMES[name]
    cfg = classifier_cfg(config)
    checks = {"step1": step1}
    train_counts, eval_counts, run, trainer, _ = classifier_run(
        dev, what, config, [f"accum_steps={accum}", f"synthetic_n={batch}"],
        steps=steps, batch=batch, val_every=0, forward=FORWARD[name],
        split=batch, check_n=STEP1_BATCH[name], rate_iters=3,
        raw_hw=tuple(cfg["raw_hw"]))
    checks.update(run)
    peak = run["step"]["max_memory_allocated_gb"]
    log(f"{what}: the recipe's batch of {batch} ran as {accum} "
        f"microbatch{'es' if accum > 1 else ''} of {batch // accum}; peak "
        f"memory {peak:.2f} GiB of "
        f"{torch.cuda.get_device_properties(dev).total_memory / 2 ** 30:.1f}")
    del trainer
    return train_counts, eval_counts, checks


def deeplab_trainer(cfg, device, *, run_dir=None, hw=SEG_HW):
    """A segmentation recipe's trainer at crops of ``hw`` (DeepLabv3+'s
    own SEG_HW by default; ``recipes.build_segmenter`` shrinks a
    synthetic run to 96 x 96): ``recipes.segmenter_trainer`` of its
    ``augment`` block at ``hw``, metrics logged every step to
    ``run_dir``."""
    from myconvnet_tpu_torch import recipes

    aug = recipes.make_augment(cfg["augment"])._replace(out_hw=tuple(hw))
    return recipes.segmenter_trainer(dict(cfg, log_every=1), aug, device,
                                     log_dir=run_dir)


def step_one_segmenter(dev, cfg, n, *, hw=SEG_HW, what="DeepLabv3+"):
    """Step 1 of the DeepLabv3+ recipe (or the segmentation recipe ``cfg``
    names, ``what``) at crops of ``hw`` (its 513 x 513), batch ``n``,
    from seeded JAX-layout weights with the same pairs and draws (crop
    boxes, flips, the ASPP dropout mask) on the card and on the host, under
    the float32 policy (TF32 off) and the recipe's bf16, with the rounding
    witnesses of :func:`step_one_classifier` but the host's step from
    weights one ulp over, and its bounds: the augmented images within
    STEP1_INPUTS_RTOL and the masks equal, float32 at STEP1_F32_*, the host
    on the card's augmented pairs at STEP1_F32_MODEL_*, bf16 at
    STEP1_GRAD_RTOL or twice bf16's reach on the host."""
    import torch

    from myconvnet_tpu_torch import weights
    from myconvnet_tpu_torch.subsets import voc
    from myconvnet_tpu_torch.train.trainer import StepDraws

    def on_host(d):
        rec = d.recipe
        return StepDraws(None, None, None,
                         None if d.masks is None else
                         [{k: m.cpu() for k, m in m_.items()}
                          for m_ in d.masks],
                         recipe=type(rec)(rec.boxes.cpu(), rec.flip.cpu(),
                                          None))

    xs, ys = voc.synthetic_subset(n, SEG_RAW, SEED)
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    params = state = draws = None
    runs, seconds = {}, {}
    cpu = torch.device("cpu")
    for prec in ("f32", "bf16"):
        c = dict(cfg, precision=prec)
        card, host = (deeplab_trainer(c, dev, hw=hw),
                      deeplab_trainer(c, cpu, hw=hw))
        if params is None:
            params, state = weights.random_jax_params(card.model, SEED)
            draws = card.sample(n, SEG_RAW)
            if draws.recipe.jitter is not None:
                raise AssertionError(f"{what} step 1: jitter draws this "
                                     "check does not carry")
        todo = [("card", card, params, x.to(dev), y.to(dev), draws),
                ("host", host, params, x, y, on_host(draws))]
        if prec == "f32":
            aug = [t.input_fns.train(xi, yi, d.recipe) for t, xi, yi, d in (
                (card, x.to(dev), y.to(dev), draws),
                (host, x, y, on_host(draws)))]
            inputs_rel = float((aug[0][0].cpu() - aug[1][0]).abs().max()
                               / aug[1][0].abs().max())
            masks_equal = bool(torch.equal(aug[0][1].cpu(), aug[1][1]))
            todo += [("card without cuDNN", card, params, x.to(dev),
                      y.to(dev), draws),
                     ("host on the card's inputs", host, params,
                      aug[0][0].cpu(), aug[0][1].cpu(), on_host(draws))]
        for where, t, p, xi, yi, d in todo:
            weights.from_jax(t.model, p, state)
            t0 = time.perf_counter()
            torch.backends.cudnn.enabled = "without cuDNN" not in where
            fns = t.input_fns
            if "inputs" in where:
                t.input_fns = None
            try:
                loss = float(t.loss_and_grads(xi, yi, d)[0])
            finally:
                torch.backends.cudnn.enabled = True
                t.input_fns = fns
            seconds[where, prec] = time.perf_counter() - t0
            runs[where, prec] = (loss, grad_norms(t))
        del card, host
    out = {}
    for key, (a, b) in {
            "card vs host, float32": (("card", "f32"), ("host", "f32")),
            "card without cuDNN vs card, float32": (
                ("card without cuDNN", "f32"), ("card", "f32")),
            "card vs host on the card's inputs, float32": (
                ("card", "f32"), ("host on the card's inputs", "f32")),
            "card vs host, bf16": (("card", "bf16"), ("host", "bf16")),
            "host bf16 vs host float32": (("host", "bf16"), ("host", "f32"))
            }.items():
        gaps = norm_gaps(runs[a][1], runs[b][1])
        loss_rel = abs(runs[a][0] - runs[b][0]) / abs(runs[b][0])
        out[key] = dict(loss_rel=loss_rel, worst=gaps[:5],
                        over_1e_3=sum(g > 1e-3 for g, _, _ in gaps))
        log(f"{what} step 1 (batch {n}) {key}: loss rel {loss_rel:.3g}; "
            f"{len(gaps)} gradient norms, {out[key]['over_1e_3']} over "
            f"1e-3 rel; worst: " + "; ".join(
                f"{k} {g:.3g} (norm {r:.3g} of the largest)"
                for g, k, r in gaps[:3]))
    log(f"{what} step 1 (batch {n}): augmented images, card vs host, "
        f"max |diff| / max |x| {inputs_rel:.3g}; masks equal {masks_equal};"
        " seconds " + ", ".join(f"{w} {p} {t:.2f}"
                                for (w, p), t in seconds.items()))
    if not (inputs_rel <= STEP1_INPUTS_RTOL and masks_equal):
        raise AssertionError(f"{what}: the augmented pairs differ "
                             f"({inputs_rel:.3g}, masks {masks_equal})")
    (lc, nc), (lh, nh) = runs["card", "f32"], runs["host", "f32"]
    f32 = step_one_verdict(
        f"{what} step 1 (batch {n}, float32)", nc, nh, lc, lh,
        loss_rtol=STEP1_F32_LOSS_RTOL, grad_rtol=STEP1_F32_GRAD_RTOL,
        grad_atol=STEP1_F32_GRAD_ATOL)
    lm, nm = runs["host on the card's inputs", "f32"]
    model = step_one_verdict(
        f"{what} step 1 (batch {n}, float32, the card's augmented pairs "
        "on both)", nc, nm, lc, lm, loss_rtol=STEP1_F32_MODEL_LOSS_RTOL,
        grad_rtol=STEP1_F32_MODEL_GRAD_RTOL, grad_atol=STEP1_F32_GRAD_ATOL)
    hb, hf = runs["host", "bf16"][1], runs["host", "f32"][1]
    big = max(hf.values())
    reach = max(abs(hb[k] - v) / v for k, v in hf.items()
                if v >= STEP1_GRAD_ATOL * big)
    if reach > STEP1_BF16_MAX_REACH:
        raise AssertionError(f"{what}: bf16 moves the host's gradient norms"
                             f" by {reach:.3g}; a bound of twice that holds "
                             "nothing")
    (lcb, ncb), (lhb, nhb) = runs["card", "bf16"], runs["host", "bf16"]
    bf16 = step_one_verdict(
        f"{what} step 1 (batch {n}, bf16)", ncb, nhb, lcb, lhb,
        f"; bf16's own reach on the host W = {reach:.3g}",
        grad_rtol=max(STEP1_GRAD_RTOL, 2 * reach))
    return dict(f32, on_the_cards_inputs=model, bf16=dict(bf16, reach=reach),
                comparisons=out, inputs_rel=inputs_rel,
                masks_equal=masks_equal,
                seconds={f"{w} {p}": t for (w, p), t in seconds.items()})


def seg_expect(forwards, what, counts):
    """Hold ``counts`` to ``forwards`` DeepLab eval forwards' launches and
    no other kernel launch."""
    from myconvnet_tpu_torch.ops import kernels
    want = {k: FORWARD["deeplab"].get(k, 0) * forwards
            for k in kernels.WRAPPERS}
    check_counts(counts, want, what)


def seg_logits_vs_host(what, trainer, host, x, dev):
    """The card's eval logits of uint8 frames ``x`` against the host's
    plain path from the same state (bf16 both): max |diff| over max
    |logit|, held at LOGIT_REL_TOL."""
    import numpy as np

    host.load_state(trainer.state())
    card = trainer.eval_step(x.to(dev)).cpu().numpy()
    plain = host.eval_step(x).numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    agree = float((card.argmax(-1) == plain.argmax(-1)).mean())
    log(f"{what}: card vs host plain path on {len(x)} frames "
        f"max|diff|/max|logit| = {rel:.4g} (tol {LOGIT_REL_TOL}); argmax "
        f"agreement {agree:.5f}; finite {bool(np.isfinite(card).all())}")
    if not np.isfinite(card).all() or rel > LOGIT_REL_TOL:
        raise AssertionError(f"{what}: eval logits disagree with the host")
    return dict(rel=rel, argmax_agreement=agree)


def seg_scales_vs_host(trainer, restored, host, x, dev, mean, std):
    """``test.main --scales``'s protocol (the softmax averaged over
    SEG_SCALES and mirrors) on uint8 frames ``x``: the restored trainer's
    output equal to the writer's on the card, and the card's against the
    host's plain path from the same state: each of the six forwards'
    logits at LOGIT_REL_TOL of max |logit|, and the averaged probabilities
    within half the largest logit gap (a softmax moves no probability by
    more than half the largest change of its logits, and the resize back
    and the average move none further)."""
    import torch

    from myconvnet_tpu_torch.eval.seg_inference import multiscale_logits, \
        normalize_frames

    def protocol(t, frames):
        logits = []

        def forward(v):
            z = t.forward_eval(v)
            logits.append(z.float().cpu())
            return z
        out = multiscale_logits(forward, normalize_frames(frames, mean, std),
                                scales=SEG_SCALES, flip=True)
        return out.cpu(), logits

    host.load_state(trainer.state())
    card, card_z = protocol(trainer, x.to(dev))
    same = bool(torch.equal(card, protocol(restored, x.to(dev))[0]))
    plain, plain_z = protocol(host, x)
    rels = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip(card_z, plain_z)]
    gap = max(float((a - b).abs().max()) for a, b in zip(card_z, plain_z))
    dp = float((card.exp() - plain.exp()).abs().max())
    agree = float((card.argmax(-1) == plain.argmax(-1)).float().mean())
    finite = bool(torch.isfinite(card).all())
    log(f"DeepLabv3+ --scales {','.join(map(str, SEG_SCALES))} + flip on "
        f"{len(x)} frames: restored equal to the writer's {same}; card vs "
        f"host plain path, {len(rels)} forwards' max|diff|/max|logit| "
        + ", ".join(f"{r:.4g}" for r in rels) + f" (tol {LOGIT_REL_TOL}); "
        f"averaged probabilities max|diff| {dp:.4g} (bound {gap / 2:.4g}, "
        f"half the largest logit gap); argmax agreement {agree:.5f}; "
        f"finite {finite}")
    if not same:
        raise AssertionError("DeepLab --scales: restored output differs")
    if not finite or max(rels) > LOGIT_REL_TOL or dp > 0.5 * gap + 1e-6:
        raise AssertionError("DeepLab --scales: card and host disagree")
    return dict(restored_equal=same, forward_rel=rels, prob_diff=dp,
                logit_gap=gap, argmax_agreement=agree)


def deeplab_run(dev):
    """BASELINE config #4, DeepLabv3+ (``configs/voc_deeplabv3plus.py``):
    step 1 at SEG_STEP1_HW on the card against the host; ``train.main`` on the
    recipe as written (its synthetic 96 x 96 run) for SEG_STEPS steps of 16
    with a validation every SEG_VAL_EVERY, ``test.main`` on its checkpoint
    with and without ``--scales`` (mIoU; restored outputs equal the
    writer's; card against host); then the recipe's 513 x 513 crops of
    512 x 512 frames at batch 16 from its parts: SEG_STEPS steps through
    ``Trainer.fit``, a validation whose launches are one eval forward's,
    card against host, and the step's rate.  Every run's launches are
    counted and recorded shape by shape.  Returns ({run: launches},
    {run: Counter of launch shapes}, checks)."""
    import shutil

    import torch

    from myconvnet_tpu_torch import recipes, test, train
    from myconvnet_tpu_torch.data.pipeline import DataSet
    from myconvnet_tpu_torch.subsets import voc

    cfg = recipes.load_config(VOC_CONFIG)
    cpu = torch.device("cpu")
    checks = {"step1": step_one_segmenter(dev, cfg, SEG_STEP1_BATCH,
                                          hw=SEG_STEP1_HW)}
    counted = Counted()
    runs, shapes = counted.runs, counted.shapes
    torch.cuda.empty_cache()

    # the recipe as written: train.main and test.main (96 x 96 crops)
    run_dir = os.path.join(ROOT, "build", "chip_smoke_deeplab")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", VOC_CONFIG, "--synthetic", "--batch", str(SEG_BATCH),
            "--device", dev.type]
    batches = -(-SEG_SPLIT // SEG_BATCH)
    t0 = time.perf_counter()
    net = counted("deeplab_train", train.main, args + [
        "--steps", str(SEG_STEPS), "--val_every", str(SEG_VAL_EVERY),
        "--out", run_dir, "--set", "log_every=1"])
    trainer = net.trainer
    seconds = time.perf_counter() - t0
    seg_expect((SEG_STEPS // SEG_VAL_EVERY + 1) * batches,
               f"DeepLabv3+ train.main ({SEG_STEPS} steps of {SEG_BATCH})",
               runs["deeplab_train"])
    losses = read_losses(run_dir, SEG_STEPS, "DeepLabv3+")
    log(f"DeepLabv3+ train.main {SEG_STEPS} steps of {SEG_BATCH} at 96x96 "
        f"in {seconds:.1f}s; losses finite, first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}")
    score, restored_net = counted("deeplab_test", test.main,
                                  args + ["--ckpt", run_dir])
    restored = restored_net.trainer
    seg_expect(batches, "DeepLabv3+ test.main", runs["deeplab_test"])
    ms_score, ms_net = counted(
        "deeplab_test_scales", test.main, args + [
            "--ckpt", run_dir, "--scales", ",".join(map(str, SEG_SCALES))])
    ms_restored = ms_net.trainer
    seg_expect(batches * 2 * len(SEG_SCALES),
               "DeepLabv3+ test.main --scales", runs["deeplab_test_scales"])
    val = recipes.make_sources(cfg, True, splits=("val",))[0]
    x = torch.from_numpy(val.images[:SEG_CHECK_N])
    same = bool(torch.equal(trainer.eval_step(x.to(dev)),
                            restored.eval_step(x.to(dev))))
    log(f"DeepLabv3+ test.main mIoU {score:.4f}, with --scales "
        f"{','.join(map(str, SEG_SCALES))} {ms_score:.4f}; restored logits "
        f"equal the writer's: {same}")
    if not same:
        raise AssertionError("DeepLab: restored logits differ")
    host = recipes.build_trainer(cfg, True, device=cpu)[0]
    checks["recipe"] = dict(
        losses=losses, train_seconds=seconds, miou=score,
        miou_scales=ms_score,
        host=seg_logits_vs_host("DeepLabv3+ 96x96", trainer, host, x, dev),
        scales=seg_scales_vs_host(trainer, ms_restored, host, x, dev,
                                  *recipes.normalization(cfg)))
    keep_run(run_dir, "deeplab")
    del trainer, restored, ms_restored, host, net, restored_net, ms_net
    torch.cuda.empty_cache()

    # the recipe's 513 x 513 crops of 512 x 512 frames, batch 16
    run_dir = os.path.join(ROOT, "build", "chip_smoke_deeplab_513")
    shutil.rmtree(run_dir, ignore_errors=True)
    trainer = deeplab_trainer(cfg, dev, run_dir=run_dir)
    train_set = DataSet(voc.PairArraySource(*voc.synthetic_subset(
        SEG_BATCH, SEG_RAW, 0)))
    val_set = DataSet(voc.PairArraySource(*voc.synthetic_subset(
        SEG_BATCH, SEG_RAW, 1)))
    t0 = time.perf_counter()
    counted("deeplab_513_train", trainer.fit,
            train_set.train_iter(SEG_BATCH, dev), total_steps=SEG_STEPS)
    seconds = time.perf_counter() - t0
    seg_expect(0, f"DeepLabv3+ 513x513 fit ({SEG_STEPS} steps)",
               runs["deeplab_513_train"])
    losses = read_losses(run_dir, SEG_STEPS, "DeepLabv3+ 513x513")
    trainer.logger.close()
    score = counted("deeplab_513_eval", trainer.evaluate,
                    val_set.eval_iter(SEG_BATCH, dev))
    seg_expect(1, "DeepLabv3+ 513x513 validation (one eval forward)",
               runs["deeplab_513_eval"])
    log(f"DeepLabv3+ 513x513: {SEG_STEPS} steps of {SEG_BATCH} in "
        f"{seconds:.1f}s; losses finite, first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}; validation mIoU {score:.4f} "
        f"(pixel accuracy {trainer.evaluator.pixel_accuracy():.4f})")
    xv = torch.from_numpy(val_set.source.images[:SEG_CHECK_N_513])
    host = deeplab_trainer(cfg, cpu)
    vs_host = seg_logits_vs_host("DeepLabv3+ 513x513", trainer, host, xv,
                                 dev)
    del host
    shutil.rmtree(run_dir)
    rate, _ = step_rate(dev, trainer, SEG_BATCH, SEG_RAW, 5, masks=True)
    log_rate("DeepLabv3+ 513x513", rate)
    checks["513"] = dict(losses=losses, train_seconds=seconds, miou=score,
                         pixel_accuracy=trainer.evaluator.pixel_accuracy(),
                         host=vs_host, step=rate)
    del trainer
    return runs, shapes, checks


def gan_grad_norms(trainer):
    """{"G/" or "D/" + JAX path: the norm of the parameter's gradient}."""
    from myconvnet_tpu_torch import weights
    return {f"{tag}/{path}": float(p.grad.float().norm())
            for tag, model in (("G", trainer.generator),
                               ("D", trainer.discriminator))
            for path, p, _ in weights.param_views(model)}


def dcgan_step_one(dev, cfg):
    """DCGAN step 1 at the recipe's batch on the card against the host
    (float32, TF32 off): the same initial state, uint8 batch (B2 on the
    card, its plain version on the host) and z; d_loss and g_loss within
    STEP1_F32_LOSS_RTOL, every gradient norm of G (its loss) and D (its
    loss) within STEP1_F32_GRAD_RTOL plus STEP1_F32_GRAD_ATOL of the
    largest, the classifiers' float32 bounds."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes_gan
    from myconvnet_tpu_torch.train.gan import GANDraws

    cpu = torch.device("cpu")
    host, train_set = recipes_gan.build_gan(cfg, True, device=cpu)
    card, _ = recipes_gan.build_gan(cfg, True, device=dev)
    card.load_state(host.state())
    x = torch.from_numpy(train_set.source.get_batch(
        np.arange(DCGAN_BATCH))[0])
    draws = host.sample(DCGAN_BATCH)
    t0 = time.perf_counter()
    m_card = card.train_step(card.prepare((x.to(dev), None)),
                             GANDraws(z=draws.z.to(dev)))
    m_card = {k: float(v) for k, v in m_card.items()}
    t1 = time.perf_counter()
    m_host = {k: float(v) for k, v in host.train_step(
        host.prepare((x, None)), draws).items()}
    t2 = time.perf_counter()
    out = step_one_verdict(
        "DCGAN step 1 (d_loss; G and D gradients)", gan_grad_norms(card),
        gan_grad_norms(host), m_card["d_loss"], m_host["d_loss"],
        f"; card {t1 - t0:.2f}s (first, cold), host {t2 - t1:.2f}s",
        loss_rtol=STEP1_F32_LOSS_RTOL, grad_rtol=STEP1_F32_GRAD_RTOL,
        grad_atol=STEP1_F32_GRAD_ATOL)
    g_rel = abs(m_card["g_loss"] - m_host["g_loss"]) / abs(m_host["g_loss"])
    log(f"DCGAN step 1 g_loss card {m_card['g_loss']:.6f} host "
        f"{m_host['g_loss']:.6f} (rel {g_rel:.3g}, tol "
        f"{STEP1_F32_LOSS_RTOL:.3g})")
    if not g_rel <= STEP1_F32_LOSS_RTOL:
        raise AssertionError("DCGAN step 1: g_loss disagrees with the host")
    return dict(out, g_loss_rel=g_rel, card=m_card, host=m_host)


def gan_step_rate(dev, trainer, iters=10, shape=None):
    """A GAN train step on seeded uint8 batches at the recipe's shape (B2
    included; ``shape``, else GAN_INPUT_SHAPES's): CUDA-event ms from an
    idle device, host enqueue ms, device busy ms, kernels and top kernels
    (torch.profiler), the idle share and the peak of allocated memory."""
    import torch

    shape = shape or GAN_INPUT_SHAPES[trainer.kind]
    g = torch.Generator(device=dev).manual_seed(SEED)
    batch = tuple(torch.randint(0, 256, shape, generator=g, device=dev,
                                dtype=torch.uint8) for _ in range(2))

    def step():
        trainer.train_step(trainer.prepare(batch))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, host_ms = events_ms(step, iters)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, span, n_kernels, top = device_busy(step, iters=2)
    r = dict(batch=shape[0], accum_steps=1, step_ms=step_ms,
             images_per_sec=shape[0] * 1e3 / step_ms,
             host_enqueue_ms=host_ms, device_busy_ms=busy,
             device_span_ms=span,
             idle_share=None if busy is None else 1 - busy / step_ms,
             kernels_per_step=n_kernels, top_kernels=top,
             max_memory_allocated_gb=peak / 2 ** 30)
    log_rate(f"{trainer.kind}", r)
    return r


def gan_losses(run_dir, kind, keys):
    """The logged metrics of ``keys`` at every GAN_LOG_EVERY step; fails
    unless each is finite."""
    import numpy as np
    with open(os.path.join(run_dir, f"gan_{kind}.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "d_loss" in r]
    if [r["step"] for r in rows] != list(range(
            GAN_LOG_EVERY, GAN_STEPS + 1, GAN_LOG_EVERY)) or not all(
                np.isfinite(r[k]) for r in rows for k in keys):
        raise AssertionError(f"{kind}: metrics not all finite: {rows}")
    return rows


def b2_shapes(shapes, shape, want, what):
    """Every normalize_u8 launch of a run at ``shape`` (a GAN recipe's
    batch, the image route's one image), float32 out: ``want`` of
    them."""
    held = shape_key("normalize_u8", shape, "float32")
    seen = {k: c for k, c in shapes.items() if k[0] == "normalize_u8"}
    if seen != ({held: want} if want else {}):
        raise AssertionError(f"{what}: normalize_u8 launches by shape "
                             f"{seen}, want {want} at {held}")


def gan_run(dev):
    """BASELINE config #5 through the entry points: DCGAN step 1 on the
    card against the host; ``train.main`` on each recipe as written for
    GAN_STEPS steps, ``generate.main`` on DCGAN's checkpoint (its samples
    equal the writer's), ``test.main`` on pix2pix's (PSNR, SSIM; restored
    output equal to the writer's, both bit for bit under
    :func:`cudnn_deterministic`, and within LOGIT_REL_TOL of max |output|
    of the host's plain path); every run's launches counted and recorded
    shape by shape; each recipe's step rate.  Returns ({run: launches},
    {run: Counter of launch shapes}, checks)."""
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import (generate, recipes, recipes_gan, test,
                                     train)
    from myconvnet_tpu_torch.utils.images import make_grid

    counted = Counted()
    runs, shapes, checks = counted.runs, counted.shapes, {}
    cpu = torch.device("cpu")

    # DCGAN (float32)
    cfg = recipes.load_config(DCGAN_CONFIG)
    checks["dcgan_step1"] = dcgan_step_one(dev, cfg)
    run_dir = os.path.join(ROOT, "build", "chip_smoke_dcgan")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", DCGAN_CONFIG, "--device", dev.type]
    t0 = time.perf_counter()
    trainer = counted("dcgan_train", train.main, args + [
        "--synthetic", "--steps", str(GAN_STEPS), "--out", run_dir,
        "--set", f"log_every={GAN_LOG_EVERY}",
        "--set", f"sample_every={GAN_LOG_EVERY}"])
    seconds = time.perf_counter() - t0
    grids = GAN_STEPS // GAN_LOG_EVERY
    expect_only(runs["dcgan_train"], {"normalize_u8": GAN_STEPS,
                                     "bn_act": 3 * grids},
               f"DCGAN train.main ({GAN_STEPS} steps, {grids} grids)")
    b2_shapes(shapes["dcgan_train"], GAN_INPUT_SHAPES["dcgan"], GAN_STEPS,
              "dcgan")
    rows = gan_losses(run_dir, "dcgan", ("d_loss", "g_loss", "d_real_acc",
                                         "d_fake_acc"))
    init = recipes_gan.build_gan(cfg, True, device=cpu)[0].state()
    end = trainer.state()
    still = [(tree, scope, k) for tree in ("g_state", "d_state")
             for scope, d in getattr(init, tree).items() for k, v in d.items()
             if np.array_equal(v, getattr(end, tree)[scope][k])]
    if still:
        raise AssertionError(f"DCGAN: BN statistics did not move: {still}")
    images = sorted(os.listdir(os.path.join(run_dir, "images")))
    png = os.path.join(run_dir, "samples.png")
    sampler = recipes_gan.make_gan_sampler(cfg)
    # the generator against itself under cuDNN's default algorithms: the
    # drift that holding the samples bit for bit must not see
    z = torch.randn(DCGAN_GRID, cfg.get("latent_dim", 100), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad():
        drift = float((trainer.generate(z) - trainer.generate(z)).abs()
                      .max())
    with cudnn_deterministic():
        grid = counted("dcgan_generate", generate.main, args + [
            "--ckpt", run_dir, "--n", str(DCGAN_GRID), "--out", png])
        writer = make_grid(sampler(trainer, DCGAN_GRID, seed=0)
                           .cpu().numpy(), pad=0)
    expect_only(runs["dcgan_generate"], {"bn_act": 3},
               f"DCGAN generate.main ({DCGAN_GRID} samples)")
    same = bool(np.array_equal(grid, writer))
    log(f"DCGAN train.main {GAN_STEPS} steps of {DCGAN_BATCH} in "
        f"{seconds:.1f}s; metrics finite (d_loss {rows[0]['d_loss']:.4f} -> "
        f"{rows[-1]['d_loss']:.4f}, g_loss {rows[0]['g_loss']:.4f} -> "
        f"{rows[-1]['g_loss']:.4f}); G's and D's BN statistics moved; "
        f"sample grids {images}; generate.main's {DCGAN_GRID} samples "
        f"equal the writer's (cuDNN deterministic): {same}; the generator "
        f"against itself by default: max |diff| {drift:.3g}")
    if not same:
        raise AssertionError(
            f"DCGAN: generate.main's samples differ from the writer's at "
            f"{int((grid != writer).sum())} of {grid.size} values")
    if len(images) != grids:
        raise AssertionError(f"DCGAN: sample grids {images}, want {grids}")
    keep_run(run_dir, "dcgan")
    checks["dcgan"] = dict(metrics=rows, train_seconds=seconds,
                           grids=images, generator_drift=drift,
                           step=gan_step_rate(dev, trainer))
    del trainer
    torch.cuda.empty_cache()

    # pix2pix (bf16)
    cfg = recipes.load_config(PIX2PIX_CONFIG)
    run_dir = os.path.join(ROOT, "build", "chip_smoke_pix2pix")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", PIX2PIX_CONFIG, "--device", dev.type, "--synthetic"]
    t0 = time.perf_counter()
    trainer = counted("pix2pix_train", train.main, args + [
        "--steps", str(GAN_STEPS), "--out", run_dir,
        "--set", f"log_every={GAN_LOG_EVERY}"])
    seconds = time.perf_counter() - t0
    expect_only(runs["pix2pix_train"], {"normalize_u8": 2 * GAN_STEPS},
               f"pix2pix train.main ({GAN_STEPS} steps)")
    b2_shapes(shapes["pix2pix_train"], GAN_INPUT_SHAPES["pix2pix"],
              2 * GAN_STEPS, "pix2pix")
    rows = gan_losses(run_dir, "pix2pix", ("d_loss", "g_loss", "g_adv",
                                           "g_l1"))
    (psnr, ssim), restored = counted("pix2pix_test", test.main, args + [
        "--ckpt", run_dir])
    batches = PIX2PIX_SPLIT // PIX2PIX_BATCH
    expect_only(runs["pix2pix_test"], {"normalize_u8": batches,
                                      "bn_act": 13 * batches},
               f"pix2pix test.main ({batches} batches)")
    b2_shapes(shapes["pix2pix_test"], GAN_INPUT_SHAPES["pix2pix"], batches,
              "pix2pix")
    val = recipes_gan.gan_source(cfg, True, "val")
    x = torch.from_numpy(val.get_batch(np.arange(PIX2PIX_CHECK_N))[0])
    xd = trainer.to_unit_range(x.to(dev))
    with cudnn_deterministic():
        out = trainer.generate(xd)
        same = bool(torch.equal(out, restored.generate(xd)))
    host = recipes_gan.build_gan(cfg, True, device=cpu)[0]
    host.load_state(trainer.state())
    t1 = time.perf_counter()
    want = host.generate(host.to_unit_range(x)).float()
    err = float((out.float().cpu() - want).abs().max())
    rel = err / float(want.abs().max())
    log(f"pix2pix train.main {GAN_STEPS} steps of {PIX2PIX_BATCH} at "
        f"256x256 in {seconds:.1f}s; metrics finite (g_l1 "
        f"{rows[0]['g_l1']:.4f} -> {rows[-1]['g_l1']:.4f}); test.main "
        f"psnr {psnr:.2f} dB, ssim {ssim:.4f}; restored output equal to the "
        f"writer's: {same}; card vs host on {PIX2PIX_CHECK_N} images: max "
        f"|diff| {err:.4g} = {rel:.4g} of max |output| (tol "
        f"{LOGIT_REL_TOL}; host {time.perf_counter() - t1:.1f}s)")
    if not same or not rel <= LOGIT_REL_TOL:
        raise AssertionError("pix2pix: restored output differs or the card "
                             "disagrees with the host")
    keep_run(run_dir, "pix2pix")
    del restored, host
    checks["pix2pix"] = dict(metrics=rows, train_seconds=seconds, psnr=psnr,
                             ssim=ssim, host_rel=rel,
                             step=gan_step_rate(dev, trainer))
    del trainer
    torch.cuda.empty_cache()
    return runs, shapes, checks


def convnet_api_run(dev, plain_step):
    """The ConvNet API through ``train.main`` and ``test.main`` (step 16
    of the module docstring); ``plain_step`` is the ResNet-50 phase's
    plain step rate (:func:`step_rate`).  Returns (runs, shapes, checks):
    each run's launch counts and shapes for the kernels' record."""
    import collections
    import io
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, test, train, weights
    from myconvnet_tpu_torch.ckpt import checkpoint as ckpt_lib
    from myconvnet_tpu_torch.ops import kernels
    from myconvnet_tpu_torch.train import optim

    runs, shapes, checks = {}, {}, {}
    cpu = torch.device("cpu")

    def counted(run, fn, *args, report=None):
        """fn(*args), the launch counts set to 0 just before it and read,
        with the launches' shapes, just after it; with ``report`` its
        printout goes to that file, and its last lines to the log."""
        shapes[run] = collections.Counter()
        out = io.StringIO()
        with launch_shapes(shapes[run]):
            kernels.reset_launch_counts()
            if report:
                with contextlib.redirect_stdout(out):
                    result = fn(*args)
            else:
                result = fn(*args)
            torch.cuda.synchronize()
            runs[run] = kernels.launch_counts()
        if report:
            with open(report, "w") as f:
                f.write(out.getvalue())
            for line in out.getvalue().splitlines()[-3:]:
                log(f"  {line}")
        return result

    def expect(run, what, *, steps=0, forwards=0, forward=None):
        want = {k: 0 for k in kernels.WRAPPERS}
        for k, v in PER_TRAIN_STEP.items():
            want[k] += v * steps
        for k, v in (forward or {}).items():
            want[k] += v * forwards
        check_counts(runs[run], want, what)

    def flags(sets):
        return [a for kv in sets for a in ("--set", kv)]

    # (a) ResNet-50 at full width, 1024 as 2 x 512, bf16
    cfg = classifier_cfg(CONFIG, API_R50_SETS)
    run_dir = os.path.join(ROOT, "build", "chip_smoke_api_r50")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", CONFIG, "--synthetic", "--batch", str(R50_BATCH),
            *flags(API_R50_SETS), "--device", dev.type]
    t0 = time.perf_counter()
    net = counted("api_r50_train", train.main, args + [
        "--steps", str(API_R50_STEPS), "--val_every",
        str(API_R50_VAL_EVERY), "--out", run_dir, "--set", "log_every=1"])
    seconds = time.perf_counter() - t0
    evals = API_R50_STEPS // API_R50_VAL_EVERY + 1
    # the ResNet-50 train step launches none of the kernels
    expect("api_r50_train", f"ResNet-50 API train.main ({API_R50_STEPS} "
           f"steps, {evals} eval batches)", forwards=evals,
           forward=FORWARD["resnet50"])
    losses = read_losses(run_dir, API_R50_STEPS, "ResNet-50 API")
    log(f"ResNet-50 API train.main with {' '.join(API_R50_SETS[2:])}: "
        f"{API_R50_STEPS} steps of {R50_BATCH} in {seconds:.1f}s; losses "
        f"finite, first {losses[0]:.4f} last {losses[-1]:.4f}")
    writer_ema = {k: v.clone()
                  for k, v in optim.extract_ema(net.optimizer).items()}
    report = os.path.join(ROOT, "chiprun_out", "api_r50_report.txt")
    top5, tta_net = counted(
        "api_r50_ten_crop", test.main,
        args + ["--ckpt", run_dir, "--best", "--ema", "--tta", "ten_crop",
                "--topk", "5", "--report"], report=report)
    expect("api_r50_ten_crop", "ResNet-50 test.main --best --ema --tta "
           f"ten_crop (one batch of {TEN_CROP_VIEWS} views)",
           forwards=TEN_CROP_VIEWS, forward=FORWARD["resnet50"])
    best_step = ckpt_lib.checkpoint_step(ckpt_lib.best_checkpoint(run_dir))
    if best_step not in (API_R50_VAL_EVERY, API_R50_STEPS) \
            or tta_net.trainer.step != best_step:
        raise AssertionError(f"best.npz: step {best_step}, restored "
                             f"{tta_net.trainer.step}")
    top1_avg, avg_net = counted("api_r50_average", test.main,
                                args + ["--ckpt", run_dir, "--average", "2"])
    expect("api_r50_average", "ResNet-50 test.main --average 2",
           forwards=1, forward=FORWARD["resnet50"])
    reader_ema = optim.extract_ema(avg_net.optimizer)
    same_ema = all(torch.equal(v, reader_ema[k])
                   for k, v in writer_ema.items())
    del writer_ema, reader_ema, avg_net
    if not same_ema:
        raise AssertionError("ResNet-50: the checkpoint's EMA differs from "
                             "the writer's")
    val = recipes.make_sources(dict(cfg, synthetic_n=API_TTA_CHECK_N), True,
                               splits=("val",))[0]
    x = val.images
    card = tta_net.predict(x, batch_size=len(x), tta="ten_crop")
    host, _, _ = recipes.build_classifier(cfg, True, device=cpu)
    host.build(recipes.optimizer_factory(cfg["optimizer"]))
    host.trainer.load_state(tta_net.trainer.state())
    t0 = time.perf_counter()
    plain = host.predict(x, batch_size=len(x), tta="ten_crop")
    host_s = time.perf_counter() - t0
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    agree = float((card.argmax(-1) == plain.argmax(-1)).mean())
    log(f"ResNet-50 ten-crop TTA (EMA weights of best.npz, step "
        f"{best_step}): top-5 {top5:.4f}; --average 2 top-1 "
        f"{top1_avg:.4f}; the reader's EMA equals the writer's; card vs "
        f"host plain path on {len(x)} images: max|diff|/max|log p| = "
        f"{rel:.4g} (tol {LOGIT_REL_TOL}), top-1 agreement {agree:.3f} "
        f"(host {host_s:.1f}s)")
    if card.shape != (len(x), cfg["num_classes"]) \
            or not np.isfinite(card).all() or rel > LOGIT_REL_TOL:
        raise AssertionError("ResNet-50: ten-crop log-probabilities "
                             "disagree with the plain path")
    del tta_net, host
    rate, _ = step_rate(dev, net.trainer, R50_BATCH, tuple(cfg["raw_hw"]),
                        3)
    log_rate("ResNet-50 API (EMA, lookahead, erasing)", rate)
    cost = rate["step_ms"] / plain_step["step_ms"] - 1.0
    log(f"ResNet-50 step with the wrappers on: {rate['step_ms']:.2f} ms, "
        f"{rate['images_per_sec']:.1f} images/s, max_memory_allocated "
        f"{rate['max_memory_allocated_gb']:.2f} GiB; the plain step in "
        f"this call {plain_step['step_ms']:.2f} ms, "
        f"{plain_step['images_per_sec']:.1f} images/s, "
        f"{plain_step['max_memory_allocated_gb']:.2f} GiB: the wrappers "
        f"cost {100 * cost:.1f}% of the step")
    checks["resnet50"] = dict(
        losses=losses, train_seconds=seconds, top5_ten_crop=top5,
        top1_average=top1_avg, best_step=best_step,
        ten_crop_rel_err=rel, ten_crop_top1_agreement=agree,
        host_ten_crop_seconds=host_s, step=rate,
        plain_step_ms=plain_step["step_ms"], wrapper_cost=cost)
    del net
    shutil.rmtree(run_dir)
    torch.cuda.empty_cache()

    # (b) the CIFAR-100 ResNet-18: SAM, reduce-on-plateau, the stem frozen
    cfg = classifier_cfg(CIFAR_CONFIG, API_R18_SETS)
    run_dir = os.path.join(ROOT, "build", "chip_smoke_api_r18")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", CIFAR_CONFIG, "--synthetic", "--batch",
            str(TRAIN_BATCH), *flags(API_R18_SETS), "--device", dev.type]
    t0 = time.perf_counter()
    net = counted("api_r18_train", train.main, args + [
        "--steps", str(API_R18_STEPS), "--val_every",
        str(API_R18_VAL_EVERY), "--out", run_dir, "--set", "log_every=1"])
    seconds = time.perf_counter() - t0
    evals = (API_R18_STEPS // API_R18_VAL_EVERY + 1) * EVAL_BATCHES
    expect("api_r18_train", f"ResNet-18 API train.main ({API_R18_STEPS} "
           f"steps, {evals} eval batches)", steps=API_R18_STEPS,
           forwards=evals, forward=PER_EVAL_BATCH)
    losses = read_losses(run_dir, API_R18_STEPS, "ResNet-18 API")
    seeded, _, _ = recipes.build_trainer(cfg, True, device=cpu)
    p0 = weights.to_jax(seeded.model)[0]
    p1 = weights.to_jax(net.trainer.model)[0]
    del seeded
    stem = [(s, n) for s in p0 if s.startswith("stem") for n in p0[s]]
    stem_kept = all(np.array_equal(p0[s][n], p1[s][n]) for s, n in stem)
    others_moved = any(not np.array_equal(p0[s][n], p1[s][n])
                       for s in p0 if not s.startswith("stem")
                       for n in p0[s])
    with open(os.path.join(run_dir, "train.jsonl")) as f:
        records = [json.loads(line) for line in f]
    vals = [(r["step"], r["val_accuracy"]) for r in records
            if "val_accuracy" in r]
    logged = [(r["step"], r["lr_scale"]) for r in records
              if "lr_scale" in r]
    want, best, scale = [], -math.inf, 1.0
    for step, acc in vals:
        if acc > best:
            best = acc
        else:
            scale = max(scale * 0.5, 1e-4)
            want.append((step, scale))
    log(f"ResNet-18 API train.main with {' '.join(API_R18_SETS)}: "
        f"{API_R18_STEPS} steps in {seconds:.1f}s; losses finite, first "
        f"{losses[0]:.4f} last {losses[-1]:.4f}; the stem's {len(stem)} "
        f"leaves bit-identical to the seeded ones: {stem_kept} (the rest "
        f"moved: {others_moved}); validations {vals}; lr_scale logged "
        f"{logged}, by the rule {want}")
    if not (stem_kept and others_moved):
        raise AssertionError("ResNet-18: freeze did not keep the stem")
    if logged != want or optim.plateau_scale(net.optimizer) != scale:
        raise AssertionError("ResNet-18: the plateau scale does not follow "
                             "the validations")
    val = recipes.make_sources(cfg, True, splits=("val",))[0]
    x = val.images[:TRAIN_BATCH + TRAIN_BATCH // 2]
    tail = net.predict(x, batch_size=TRAIN_BATCH)[TRAIN_BATCH:]
    inside = net.predict(x[TRAIN_BATCH // 2:],
                         batch_size=TRAIN_BATCH)[TRAIN_BATCH // 2:]
    tail_same = bool(np.array_equal(tail, inside))
    log(f"ResNet-18 predict: a padded tail batch of {len(tail)} gives the "
        f"bits of the same images inside a full batch: {tail_same}")
    if not tail_same:
        raise AssertionError("ResNet-18: predict's tail batch differs")
    trainer = net.trainer
    sam = step_rate(dev, trainer, TRAIN_BATCH, (32, 32), 5)[0]
    trainer.sam_rho = 0.0
    plain = step_rate(dev, trainer, TRAIN_BATCH, (32, 32), 5)[0]
    trainer.sam_rho = 0.05
    key = "device_busy_ms" if sam["device_busy_ms"] and \
        plain["device_busy_ms"] else "step_ms"
    ratio = sam[key] / plain[key]
    log(f"ResNet-18 SAM step {sam['step_ms']:.2f} ms (device busy "
        f"{sam['device_busy_ms']} ms) vs the plain step "
        f"{plain['step_ms']:.2f} ms ({plain['device_busy_ms']} ms): "
        f"{key} x{ratio:.2f}")
    if ratio < SAM_MIN_RATIO:
        raise AssertionError(f"ResNet-18: the SAM step is x{ratio:.2f} "
                             "the plain step's")
    flip_score, _ = counted("api_r18_flip", test.main, args + [
        "--ckpt", run_dir, "--tta", "flip", "--average", "3"])
    expect("api_r18_flip", "ResNet-18 test.main --tta flip --average 3",
           forwards=EVAL_BATCHES, forward=FLIP_EVAL_BATCH)
    shutil.rmtree(run_dir)
    focal_dir = os.path.join(ROOT, "build", "chip_smoke_api_focal")
    shutil.rmtree(focal_dir, ignore_errors=True)
    counted("api_r18_focal", train.main, [
        "--config", CIFAR_CONFIG, "--synthetic", "--batch",
        str(TRAIN_BATCH), "--set", "cls_loss=focal", "--set", "mix=None",
        "--device", dev.type, "--steps", str(API_FOCAL_STEPS),
        "--val_every", "0", "--out", focal_dir, "--set", "log_every=1"])
    expect("api_r18_focal", f"ResNet-18 focal train.main ({API_FOCAL_STEPS}"
           " steps)", steps=API_FOCAL_STEPS, forwards=EVAL_BATCHES,
           forward=PER_EVAL_BATCH)
    focal = read_losses(focal_dir, API_FOCAL_STEPS, "ResNet-18 focal")
    shutil.rmtree(focal_dir)
    log(f"ResNet-18 test.main --tta flip --average 3: top-1 "
        f"{flip_score:.4f}; focal loss run: {[round(v, 4) for v in focal]}")
    checks["resnet18"] = dict(
        losses=losses, train_seconds=seconds, validations=vals,
        lr_scales=logged, stem_kept=stem_kept, tail_batch_bits=tail_same,
        sam_step=sam, plain_step=plain, sam_ratio=ratio, sam_ratio_of=key,
        top1_flip_average=flip_score, focal_losses=focal)
    return runs, shapes, checks


def io_environment():
    """What the machine has for the file phases: the C++ compiler's
    ``jpeglib.h`` and ``png.h``, Pillow, the CPU count and this process's
    CPU affinity; and the plan of file phases that decides which run."""
    from myconvnet_tpu_torch.data import native_loader

    try:
        import PIL
        pillow = PIL.__version__
    except ImportError:
        pillow = None
    env = {"jpeglib.h": native_loader.has_header("jpeglib.h"),
           "png.h": native_loader.has_header("png.h"), "Pillow": pillow,
           "cpu_count": os.cpu_count(),
           "sched_getaffinity": len(os.sched_getaffinity(0))}
    log("host I/O: " + ", ".join(f"{k} {v}" for k, v in env.items()))
    # a JPEG corpus decodes natively (jpeglib.h) or through FileSource's
    # Pillow path; VOC masks, pix2pix pairs, generate --input and the image
    # route need Pillow
    jpeg = env["jpeglib.h"] or bool(pillow)
    plan = {"budget": jpeg, "resnet50_files": jpeg,
            "deeplab_files": bool(pillow), "pix2pix_files": bool(pillow),
            "image_route": bool(pillow)}
    notes = []
    if not env["jpeglib.h"]:
        notes.append("jpeglib.h missing: no native JPEG decode; "
                     + ("the decode budget and ResNet-50 from files run "
                        "through FileSource's Pillow path" if pillow else
                        "skipped the decode budget and ResNet-50 from "
                        "files"))
    if not env["png.h"]:
        notes.append("png.h missing: VOC masks decode through Pillow")
    if not pillow:
        notes.append("Pillow missing: skipped DeepLabv3+ from files, "
                     "pix2pix from files, generate --input/--ema and the "
                     "image route")
    return env, plan, "; ".join(notes)


def check_io_kernels(dev, g, plan):
    """The kernels at the file phases' shapes that no other row holds:
    conv_pair and bn_act at ResNet-50's eval batch of FILES_VAL (path
    ``resnet50_files``), normalize_u8 at the image route's one image of
    224 x 224 with the ImageNet mean and std (path ``image_route``)."""
    import torch

    rows = []
    if plan.get("resnet50_files"):
        for shape, count in R50_FILES_PAIR_SITES:
            rows.append(conv_pair_row(shape, count, "resnet50_files", g))
            torch.cuda.empty_cache()
        for site, shape, count in R50_FILES_ACT_SITES:
            x = torch.randn(*shape, generator=g, device=dev).bfloat16()
            c = shape[-1]
            rows.append(bn_act_row(site, x, torch.rand(
                c, generator=g, device=dev) + 0.5, torch.randn(
                c, generator=g, device=dev) * 0.5, count, "resnet50_files"))
            del x
        torch.cuda.empty_cache()
    if plan.get("image_route"):
        from myconvnet_tpu_torch import recipes
        mean, std = recipes.normalization(recipes.load_config(CONFIG), 3)
        rows.append(gan_input_row("image_route", (1, 224, 224, 3), g,
                                  mean, std))
    return rows


def _link(src, dst):
    """Hard-link ``src`` to ``dst`` (copy across file systems)."""
    os.makedirs(os.path.dirname(dst), exist_ok=True)
    try:
        os.link(src, dst)
    except OSError:
        import shutil
        shutil.copyfile(src, dst)


def _fixture_jpegs():
    d = os.path.join(FIXTURES, "imagenet")
    return [os.path.join(d, f) for f in sorted(os.listdir(d))]


def imagenet_files_corpus(root):
    """FILES_CLASSES class directories under train/ and val/ (every class
    in both, as ImageNet's, so the labels agree), FILES_TRAIN and
    FILES_VAL files spread over the classes, the fixture JPEGs in turn."""
    jpegs = _fixture_jpegs()
    for split, n in (("train", FILES_TRAIN), ("val", FILES_VAL)):
        for c in range(FILES_CLASSES):
            os.makedirs(os.path.join(root, split, f"n{c:08d}"),
                        exist_ok=True)
        for i in range(n):
            _link(jpegs[i % len(jpegs)], os.path.join(
                root, split, f"n{i % FILES_CLASSES:08d}",
                f"{split}_{i:05d}.JPEG"))
    return root


def voc_files_corpus(root):
    """A VOCdevkit/VOC2012 layout whose split lists name the fixture pairs
    in turn."""
    base = os.path.join(root, "VOCdevkit", "VOC2012")
    stems = sorted(f[:-4] for f in os.listdir(os.path.join(
        FIXTURES, "voc", "JPEGImages")))
    for stem in stems:
        for sub, ext in (("JPEGImages", ".jpg"),
                         ("SegmentationClass", ".png")):
            _link(os.path.join(FIXTURES, "voc", sub, stem + ext),
                  os.path.join(base, sub, stem + ext))
    lists = os.path.join(base, "ImageSets", "Segmentation")
    os.makedirs(lists, exist_ok=True)
    for split, n in (("train", VOC_FILES_TRAIN), ("val", VOC_FILES_VAL)):
        with open(os.path.join(lists, f"{split}.txt"), "w") as f:
            f.write("".join(stems[i % len(stems)] + "\n" for i in range(n)))
    return root


def pairs_files_corpus(root):
    """The combined pix2pix layout: PAIRS_FILES_TRAIN images under train/
    and PIX2PIX_BATCH under val/, the fixture pairs in turn."""
    d = os.path.join(FIXTURES, "pairs")
    pairs_ = [os.path.join(d, f) for f in sorted(os.listdir(d))]
    for split, n in (("train", PAIRS_FILES_TRAIN), ("val", PIX2PIX_BATCH)):
        for i in range(n):
            _link(pairs_[i % len(pairs_)],
                  os.path.join(root, split, f"{i:04d}.jpg"))
    return root


def logged_rate(run_dir, batch):
    """A train.main run's own record (train.jsonl, a line a step): the
    median step ms and images/s and the mean input_wait_frac over its
    steps after the first FILES_WARMUP (fewer in a shorter run)."""
    import numpy as np
    with open(os.path.join(run_dir, "train.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "images_per_sec" in r]
    skip = min(FILES_WARMUP, len(rows) - 1)
    rows = rows[skip:]
    if not rows:
        raise AssertionError(f"{run_dir}: no rate logged past step {skip}")
    ips = float(np.median([r["images_per_sec"] for r in rows]))
    return dict(steps=len(rows), images_per_sec=ips,
                step_ms=batch * 1e3 / ips,
                input_wait_frac=float(np.mean([r["input_wait_frac"]
                                               for r in rows])))


def fed_rate(dev, trainer, data_set, batch, steps):
    """The train step fed by ``data_set.train_iter`` as ``Trainer.fit``
    feeds it (each step's metrics read after the next step is enqueued):
    FED_WARMUP steps, then ``steps`` plain and ``steps`` under
    torch.profiler (device activity only).  For each of the two: step ms
    (wall clock, the device drained at both ends), images/s,
    input_wait_frac (the loop's wait for a batch) and host enqueue ms a
    step (the ``train_step`` call); for the profiled one, device busy ms a
    step (the union of its kernels' intervals) and the idle share
    1 - busy / step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    it = data_set.train_iter(batch, dev)

    def run(n):
        wait = enqueue = 0.0
        pending = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            t1 = time.perf_counter()
            x, y = next(it)
            t2 = time.perf_counter()
            metrics = trainer.train_step(x, y)
            enqueue += time.perf_counter() - t2
            wait += t2 - t1
            if pending is not None:
                [float(v) for v in pending.values()]
            pending = metrics
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return dict(step_ms=wall * 1e3 / n, images_per_sec=n * batch / wall,
                    input_wait_frac=wait / wall,
                    host_enqueue_ms=enqueue * 1e3 / n)

    try:
        run(FED_WARMUP)
        plain = run(steps)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            profiled = run(steps)
    finally:
        it.close()
    events = device_events(prof)
    if not events:
        raise AssertionError("the fed train step's profile shows no device "
                             "activity")
    busy = busy_us(events)[0] / 1e3 / steps
    profiled.update(device_busy_ms=busy,
                    kernels_per_step=len(events) / steps,
                    idle_share=1 - busy / profiled["step_ms"])
    return dict(steps=steps, plain=plain, profiled=profiled)


def gather_ms(images, batch):
    """Best of 3 host ms of one shuffled batch's gather from ``images``:
    the host library's threaded copy (``ArraySource.get_batch``) and
    numpy's indexing."""
    import numpy as np

    from myconvnet_tpu_torch.data import native_loader

    idx = np.random.RandomState(SEED).permutation(len(images))[:batch]
    out = {}
    for name, fn in (("native", native_loader.gather_batch),
                     ("numpy", lambda a, i: np.ascontiguousarray(a[i]))):
        best = None
        for _ in range(3):
            t0 = time.perf_counter()
            fn(images, idx)
            dt = (time.perf_counter() - t0) * 1e3
            best = dt if best is None else min(best, dt)
        out[name] = best
    return out


def decode_budget(images_per_sec, card):
    """The host decode rate of BUDGET_IMAGES fixture JPEGs at BUDGET_HW:
    the host library's libjpeg batch (``decode_jpeg_batch``) where it has
    JPEG, else FileSource's Pillow path (Pillow's decode and
    ``cover_resize_center_crop`` over a pool of threads); images/s at each
    thread count, a
    core's rate (one thread) and the cores that feed each of
    ``images_per_sec`` (a step's measured rate)."""
    import io
    from concurrent.futures import ThreadPoolExecutor

    from myconvnet_tpu_torch.data import native_loader
    from myconvnet_tpu_torch.data.pipeline import cover_resize_center_crop

    blobs = []
    for path in _fixture_jpegs():
        with open(path, "rb") as f:
            blobs.append(f.read())
    blobs = [blobs[i % len(blobs)] for i in range(BUDGET_IMAGES)]
    native = native_loader.backend()["jpeg"]

    def decode(k):
        if native:
            return native_loader.decode_jpeg_batch(blobs, BUDGET_HW,
                                                   n_threads=k)
        from PIL import Image
        with ThreadPoolExecutor(max_workers=k) as pool:
            return list(pool.map(lambda b: cover_resize_center_crop(
                Image.open(io.BytesIO(b)).convert("RGB"), BUDGET_HW), blobs))

    decode(2)   # warm: page cache, the library, Pillow's plugins
    rates = {}
    for k in sorted({*BUDGET_THREADS, os.cpu_count() or 1}):
        best = None
        for _ in range(2):
            t0 = time.perf_counter()
            decode(k)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        rates[k] = BUDGET_IMAGES / best
    per_core = rates[1]
    out = dict(path="native libjpeg" if native else "Pillow",
               raw_hw=list(BUDGET_HW), images=BUDGET_IMAGES,
               images_per_sec=rates, per_core=per_core,
               cores_needed={k: v / per_core
                             for k, v in images_per_sec.items()})
    log(f"{card}: host decode budget ({out['path']}, {BUDGET_IMAGES} "
        f"fixture JPEGs "
        f"-> {list(BUDGET_HW)}): " + ", ".join(
            f"{k} threads {v:.1f} images/s" for k, v in rates.items())
        + f"; {per_core:.1f} images/s a core; cores to feed "
        + ", ".join(f"{k} ({v:.1f} images/s): {out['cores_needed'][k]:.2f}"
                    for k, v in images_per_sec.items()))
    return out


def eval_tail_check(dev, counted):
    """C6: ``Trainer.evaluate`` over EVAL_TAIL_SPLIT images of the CIFAR-100
    ResNet-18 at its batch of 128 (bf16; B2 1, B4 5, B1 4 an eval batch)
    pads the tail to 128: the tail's logits equal the same images' logits
    inside a full batch, bit for bit."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.data.pipeline import ArraySource, DataSet
    from myconvnet_tpu_torch.eval.evaluators import AccuracyEvaluator
    from myconvnet_tpu_torch.weights import from_jax, random_jax_params

    cfg = recipes.load_config(CIFAR_CONFIG)
    net, _, val_set = recipes.build_classifier(cfg, True, device=dev)
    trainer = net.trainer
    from_jax(trainer.model, *random_jax_params(trainer.model, SEED))
    x = val_set.source.images[:EVAL_TAIL_SPLIT]
    y = val_set.source.labels[:EVAL_TAIL_SPLIT]
    evaluator = trainer.evaluator = AccuracyEvaluator()
    seen, update = [], evaluator.update
    evaluator.update = lambda out, t: (seen.append(out.clone()),
                                       update(out, t))
    score = counted("c6_evaluate", trainer.evaluate,
                    DataSet(ArraySource(x, y)).eval_iter(TRAIN_BATCH, dev))
    batches = -(-EVAL_TAIL_SPLIT // TRAIN_BATCH)
    check_counts(counted.runs["c6_evaluate"],
                 {k: v * batches for k, v in PER_EVAL_BATCH.items()},
                 f"Trainer.evaluate ({batches} batches)")
    inside = trainer.eval_batch(
        torch.from_numpy(x[-TRAIN_BATCH:]).to(dev),
        torch.from_numpy(y[-TRAIN_BATCH:]).to(dev))[0]
    tail = EVAL_TAIL_SPLIT - (batches - 1) * TRAIN_BATCH
    same = bool(torch.equal(seen[-1], inside[-tail:]))
    log(f"C6: Trainer.evaluate over {EVAL_TAIL_SPLIT} images at batch "
        f"{TRAIN_BATCH} ran batches of {[len(o) for o in seen]} outputs "
        f"(the tail padded to {TRAIN_BATCH}); the tail's logits equal the "
        f"same images inside a full batch: {same}; top-1 {score:.4f}")
    if not same:
        raise AssertionError("C6: evaluate's tail logits differ from the "
                             "full batch's")
    return dict(tail_bits_equal=same, top1=score,
                batch_sizes=[len(o) for o in seen],
                finite=bool(np.isfinite(seen[-1].cpu().numpy()).all()))


class Counted:
    """``counted(run, fn, ...)``: fn(...) with the launch counts set to 0
    just before it and read, with the launches' shapes
    (:func:`launch_shapes`), just after it, into ``runs[run]`` and
    ``shapes[run]``."""

    def __init__(self):
        self.runs, self.shapes = {}, {}

    def __call__(self, run, fn, *args, **kwargs):
        import collections

        import torch

        from myconvnet_tpu_torch.ops import kernels
        self.shapes[run] = collections.Counter()
        with launch_shapes(self.shapes[run]):
            kernels.reset_launch_counts()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.runs[run] = kernels.launch_counts()
        return out


def expect_only(counts, want, what):
    """Hold ``counts`` to ``want`` and no other kernel launch."""
    from myconvnet_tpu_torch.ops import kernels
    check_counts(counts, {k: want.get(k, 0) for k in kernels.WRAPPERS}, what)


def resnet50_files_run(dev, counted, corpus, synthetic, card):
    """The ResNet-50 recipe as written (bf16, 1024 as 2 x 512) on the
    ImageNet-layout file corpus: ``train.main --data_dir`` for FILES_STEPS
    steps validating once, then ``test.main``; no kernel in a step, B5 13
    and B1 7 an eval batch of FILES_VAL; every loss finite; the restored
    logits equal the writer's and agree with the host's plain path on the
    first val files.  The step's ms, images/s and input_wait_frac from the
    run's own log, beside those of the synthetic ArraySource run of the
    same recipe in this call (``synthetic``: its checks); peak memory;
    then ``fed_runs``: the step's idle share, host enqueue and input wait
    when the files feed it, beside an in-memory source."""
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, test, train
    from myconvnet_tpu_torch.data import native_loader

    run_dir = os.path.join(ROOT, "build", "chip_smoke_r50_files")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", CONFIG, "--data_dir", corpus, "--batch",
            str(R50_BATCH), "--set", f"accum_steps={R50_ACCUM}",
            "--device", dev.type]
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    net = counted("files_r50_train", train.main, args + [
        "--steps", str(FILES_STEPS), "--val_every", str(FILES_STEPS),
        "--out", run_dir, "--set", "log_every=1"])
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    trainer = net.trainer
    expect_only(counted.runs["files_r50_train"],
                {k: 2 * v for k, v in FORWARD["resnet50"].items()},
                f"ResNet-50 from files train.main ({FILES_STEPS} steps, 2 "
                f"eval batches of {FILES_VAL})")
    losses = read_losses(run_dir, FILES_STEPS, "ResNet-50 from files")
    rate = logged_rate(run_dir, R50_BATCH)
    rate["max_memory_allocated_gb"] = peak
    backend = native_loader.backend()
    (score, restored_net) = counted("files_r50_test", test.main, args + [
        "--ckpt", run_dir])
    expect_only(counted.runs["files_r50_test"], FORWARD["resnet50"],
                "ResNet-50 from files test.main (1 eval batch)")
    restored = restored_net.trainer
    (val_src,) = recipes.make_sources(dict(
        classifier_cfg(CONFIG), data_dir=corpus), False, ("val",))
    x = torch.from_numpy(val_src.get_batch(np.arange(
        STEP1_BATCH["resnet50"]))[0])
    val_src.close()
    writer = trainer.eval_step(x.to(dev))
    same = bool(torch.equal(writer, restored.eval_step(x.to(dev))))
    host, _, _ = recipes.build_trainer(classifier_cfg(CONFIG), True,
                                       device=torch.device("cpu"))
    host.load_state(trainer.state())
    plain = host.eval_step(x).numpy()
    logits = writer.float().cpu().numpy()
    rel = float(np.abs(logits - plain).max() / np.abs(plain).max())
    syn = synthetic["logged_rate"]
    log(f"{card}: ResNet-50 from files ({FILES_TRAIN} train / {FILES_VAL} "
        f"val JPEGs in {FILES_CLASSES} classes; host decode: "
        f"{'native libjpeg' if backend['jpeg'] else 'Pillow'}): train.main "
        f"{FILES_STEPS} steps in {seconds:.1f}s, losses finite "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step {rate['step_ms']:.2f} ms"
        f", {rate['images_per_sec']:.1f} images/s, input_wait_frac "
        f"{rate['input_wait_frac']:.4f}, max_memory_allocated {peak:.2f} GiB "
        f"(steps {FILES_WARMUP + 1}-{FILES_STEPS}); the synthetic "
        f"ArraySource run of this call: step {syn['step_ms']:.2f} ms, "
        f"{syn['images_per_sec']:.1f} images/s, input_wait_frac "
        f"{syn['input_wait_frac']:.4f}, "
        f"{synthetic['step']['max_memory_allocated_gb']:.2f} GiB; test.main "
        f"top-1 {score:.4f}; restored logits equal the writer's: {same}; "
        f"card vs host plain path on {len(x)} files {rel:.4g} (tol "
        f"{LOGIT_REL_TOL})")
    if not same or not np.isfinite(logits).all() or rel > LOGIT_REL_TOL:
        raise AssertionError("ResNet-50 from files: restored logits differ "
                             "or the card disagrees with the host")
    shutil.rmtree(run_dir)
    fed = fed_runs(dev, trainer, corpus, card)
    return dict(losses=losses, train_seconds=seconds, rate=rate,
                synthetic_rate=syn, top1=score, backend=backend,
                eval_logit_rel_err=rel, **fed)


def fed_runs(dev, trainer, corpus, card):
    """The file run's own device profile: the trained ResNet-50 step fed
    by the corpus's train FileSource (``fed_rate``), and as its control
    the same step fed by an in-memory ArraySource of as many seeded images
    at the recipe's raw size (no decoding); the two sources' gather of a
    batch on the host (``gather_ms``)."""
    import numpy as np

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.data.pipeline import ArraySource, DataSet

    cfg = dict(classifier_cfg(CONFIG), data_dir=corpus)
    (train_src,) = recipes.make_sources(cfg, False, ("train",))
    try:
        files = fed_rate(dev, trainer, DataSet(train_src), R50_BATCH,
                         FED_STEPS)
    finally:
        train_src.close()
    rs = np.random.RandomState(SEED)
    images = rs.randint(0, 256, (FILES_TRAIN, *cfg["raw_hw"], 3),
                        dtype=np.uint8)
    labels = rs.randint(0, FILES_CLASSES, FILES_TRAIN).astype(np.int32)
    memory = fed_rate(dev, trainer, DataSet(ArraySource(images, labels)),
                      R50_BATCH, FED_STEPS)
    gather = gather_ms(images, R50_BATCH)
    for what, r in (("files", files), ("in-memory ArraySource", memory)):
        p, q = r["plain"], r["profiled"]
        log(f"{card}: ResNet-50 step fed by {what} ({FED_STEPS} steps "
            f"after {FED_WARMUP}): {p['step_ms']:.2f} ms, "
            f"{p['images_per_sec']:.1f} images/s, input_wait_frac "
            f"{p['input_wait_frac']:.4f}, host enqueue "
            f"{p['host_enqueue_ms']:.2f} ms a step; under torch.profiler "
            f"{q['step_ms']:.2f} ms, host enqueue "
            f"{q['host_enqueue_ms']:.2f} ms, device busy "
            f"{q['device_busy_ms']:.2f} ms over {q['kernels_per_step']:.0f} "
            f"kernels, idle share {q['idle_share']:.4f}")
    log(f"{card}: host gather of {R50_BATCH} of {FILES_TRAIN} images "
        f"{list(images.shape[1:])}: the host library "
        f"{gather['native']:.2f} ms, numpy {gather['numpy']:.2f} ms")
    return dict(fed_files=files, fed_memory=memory, gather_ms=gather)


def deeplab_files_run(dev, counted, corpus):
    """DeepLabv3+ as written (bf16, output_stride 16) on the VOCdevkit
    corpus at its 513 x 513 crop: ``train.main --data_dir`` for
    VOC_FILES_STEPS steps of VOC_FILES_BATCH validating once, then
    ``test.main`` (mIoU); no kernel in a step, B5 11, B4 2 and B1 18 an
    eval forward; every loss finite."""
    import shutil

    import numpy as np

    from myconvnet_tpu_torch import test, train

    run_dir = os.path.join(ROOT, "build", "chip_smoke_deeplab_files")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", VOC_CONFIG, "--data_dir", corpus, "--batch",
            str(VOC_FILES_BATCH), "--device", dev.type]
    t0 = time.perf_counter()
    counted("files_deeplab_train", train.main, args + [
        "--steps", str(VOC_FILES_STEPS), "--val_every",
        str(VOC_FILES_STEPS), "--out", run_dir, "--set", "log_every=1"])
    seconds = time.perf_counter() - t0
    batches = VOC_FILES_VAL // VOC_FILES_BATCH
    expect_only(counted.runs["files_deeplab_train"],
                {k: 2 * batches * v for k, v in FORWARD["deeplab"].items()},
                f"DeepLabv3+ from files train.main ({VOC_FILES_STEPS} "
                f"steps, {2 * batches} eval batches)")
    losses = read_losses(run_dir, VOC_FILES_STEPS, "DeepLabv3+ from files")
    rate = logged_rate(run_dir, VOC_FILES_BATCH)
    miou, _ = counted("files_deeplab_test", test.main, args + [
        "--ckpt", run_dir])
    expect_only(counted.runs["files_deeplab_test"],
                {k: batches * v for k, v in FORWARD["deeplab"].items()},
                f"DeepLabv3+ from files test.main ({batches} eval batches)")
    log(f"DeepLabv3+ from files ({VOC_FILES_TRAIN} train / {VOC_FILES_VAL} "
        f"val VOC pairs at 513x513): train.main {VOC_FILES_STEPS} steps in "
        f"{seconds:.1f}s, losses finite {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step {rate['step_ms']:.2f} ms, "
        f"{rate['images_per_sec']:.1f} images/s, input_wait_frac "
        f"{rate['input_wait_frac']:.4f}; test.main mIoU {miou:.4f}")
    if not 0.0 <= miou <= 1.0 or not np.isfinite(miou):
        raise AssertionError(f"DeepLabv3+ from files: mIoU {miou}")
    shutil.rmtree(run_dir)
    return dict(losses=losses, train_seconds=seconds, rate=rate, miou=miou)


def pix2pix_files_run(dev, counted, corpus, inputs):
    """pix2pix as written (bf16, 256 x 256, batch 16) on the combined
    corpus with the generator's EMA (``g_optimizer.ema_decay``):
    ``train.main --data_dir`` for PAIRS_FILES_STEPS steps (B2 2 a step),
    then ``generate.main --input`` over GENERATE_INPUTS images, with and
    without ``--ema`` (B2 1 and B1 13 each); every metric finite; the
    grids' inputs equal the directory's images resized as JAX's generate
    resizes them; the EMA translates otherwise."""
    import shutil

    import numpy as np

    from myconvnet_tpu_torch import generate, recipes, train
    from myconvnet_tpu_torch.utils import images

    run_dir = os.path.join(ROOT, "build", "chip_smoke_pix2pix_files")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", PIX2PIX_CONFIG, "--device", dev.type, "--set",
            "g_optimizer.ema_decay=0.999"]
    t0 = time.perf_counter()
    counted("files_pix2pix_train", train.main, args + [
        "--data_dir", corpus, "--steps", str(PAIRS_FILES_STEPS), "--out",
        run_dir, "--set", f"log_every={PAIRS_FILES_STEPS}"])
    seconds = time.perf_counter() - t0
    expect_only(counted.runs["files_pix2pix_train"],
                {"normalize_u8": 2 * PAIRS_FILES_STEPS},
                f"pix2pix from files train.main ({PAIRS_FILES_STEPS} steps)")
    b2_shapes(counted.shapes["files_pix2pix_train"],
              GAN_INPUT_SHAPES["pix2pix"], 2 * PAIRS_FILES_STEPS,
              "pix2pix from files")
    with open(os.path.join(run_dir, "gan_pix2pix.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "d_loss" in r]
    if not rows or not all(np.isfinite(r[k]) for r in rows
                           for k in ("d_loss", "g_loss", "g_l1")):
        raise AssertionError(f"pix2pix from files: metrics {rows}")
    grids = []
    make_grid = images.make_grid

    def record(a, **kw):
        grids.append(a)
        return make_grid(a, **kw)

    images.make_grid = record
    try:
        def both():
            for ema in ([], ["--ema"]):
                generate.main(args + [
                    "--ckpt", run_dir, "--input", inputs, "--n",
                    str(GENERATE_INPUTS), "--out",
                    os.path.join(run_dir, f"gen{len(ema)}.png"), *ema])
        counted("files_pix2pix_generate", both)
    finally:
        images.make_grid = make_grid
    expect_only(counted.runs["files_pix2pix_generate"],
                {"normalize_u8": 2, "bn_act": 2 * FORWARD["pix2pix"][
                    "bn_act"]}, "generate.main --input, --input --ema")
    b2_shapes(counted.shapes["files_pix2pix_generate"],
              GAN_INPUT_SHAPES["pix2pix"], 2, "generate --input")
    size = recipes.load_config(PIX2PIX_CONFIG)["image_size"]
    raw = generate.load_inputs(inputs, GENERATE_INPUTS, size)
    plain, ema = grids
    same_inputs = all(np.array_equal(g[:, :, :size], raw) for g in grids)
    differ = not np.array_equal(plain[:, :, size:], ema[:, :, size:])
    log(f"pix2pix from files ({PAIRS_FILES_TRAIN} combined pairs): "
        f"train.main {PAIRS_FILES_STEPS} steps in {seconds:.1f}s, metrics "
        f"finite (g_l1 {rows[-1]['g_l1']:.4f}); generate.main --input over "
        f"{GENERATE_INPUTS} images: inputs as read {same_inputs}, --ema "
        f"translates otherwise {differ}")
    if not same_inputs or not differ:
        raise AssertionError("generate --input/--ema: inputs differ or the "
                             "EMA changed nothing")
    shutil.rmtree(run_dir)
    return dict(metrics=rows, train_seconds=seconds)


def image_route_run(dev, counted):
    """One image body (a fixture JPEG) a request, IMAGE_ROUTE_REQUESTS
    requests, through ``ModelServer.predict`` on the served ResNet-50
    (bf16, batch 8): decoded to uint8 on the host, normalized on the card
    by B2 (1 a request, [1, 224, 224, 3]), B5 13 and B1 7 a request; the
    logits within LOGIT_REL_TOL of max |logit| of the same route on the
    host (plain versions)."""
    import numpy as np

    from myconvnet_tpu_torch import models, recipes, serving_http
    from myconvnet_tpu_torch.weights import random_jax_params

    cfg = recipes.load_config(CONFIG)
    params, state = random_jax_params(models.get_model(
        cfg["model"], cfg["num_classes"], **cfg["model_kwargs"]), SEED)

    def server(device):
        return serving_http.ModelServer([serving_http.build_route(
            "resnet50", "classify", CONFIG, params=params, state=state,
            batch=BATCH, device=device)])

    with open(_fixture_jpegs()[0], "rb") as f:
        body = f.read()
    card = server(dev)
    card.predict("resnet50", body, "image/jpeg")   # warm-up
    t0 = time.perf_counter()
    replies = counted("image_route", lambda: [
        card.predict("resnet50", body, "image/jpeg")
        for _ in range(IMAGE_ROUTE_REQUESTS)])
    ms = (time.perf_counter() - t0) * 1e3 / IMAGE_ROUTE_REQUESTS
    expect_only(counted.runs["image_route"],
                {k: IMAGE_ROUTE_REQUESTS * v for k, v in
                 {"normalize_u8": 1, **PER_CALL}.items()},
                f"image route ({IMAGE_ROUTE_REQUESTS} requests)")
    route = card.routes["resnet50"]
    b2_shapes(counted.shapes["image_route"], (1, *route.input_shape[1:]),
              IMAGE_ROUTE_REQUESTS, "image route")
    x = card._decode_body(route, body, "image/jpeg")
    logits = card._execute(route, x)
    host = server("cpu")
    want = host._execute(host.routes["resnet50"], x)
    rel = float(np.abs(logits - want).max() / np.abs(want).max())
    log(f"image route: {IMAGE_ROUTE_REQUESTS} JPEG requests, "
        f"{ms:.2f} ms a request (decode, B2, forward, top-5); uint8 "
        f"{list(x.shape)} to the card; top-1 "
        f"{replies[-1]['predictions'][0][0]}; logits card vs host plain "
        f"path {rel:.4g} (tol {LOGIT_REL_TOL})")
    if not np.isfinite(logits).all() or rel > LOGIT_REL_TOL:
        raise AssertionError("image route: the card disagrees with the host")
    return dict(ms_per_request=ms, logit_rel_err=rel)


def files_run(dev, plan, synthetic, card):
    """The file phases that ``plan`` runs (corpora under build/, removed
    after), then the host decode budget against this call's ResNet-50 step
    rates (``card``: the card's name and power limit, printed beside the
    rates).  Returns ({run: launches}, {run: Counter of launch shapes},
    checks)."""
    import shutil

    import torch

    from myconvnet_tpu_torch.ops import kernels

    counted = Counted()
    checks = {"c6": eval_tail_check(dev, counted)}
    torch.cuda.empty_cache()
    root = os.path.join(ROOT, "build", "chip_smoke_corpora")
    shutil.rmtree(root, ignore_errors=True)
    try:
        if plan["resnet50_files"]:
            checks["resnet50_files"] = phase(
                "ResNet-50 from files", resnet50_files_run, dev, counted,
                imagenet_files_corpus(os.path.join(root, "imagenet")),
                synthetic, card)
            torch.cuda.empty_cache()
        if plan["deeplab_files"]:
            checks["deeplab_files"] = phase(
                "DeepLabv3+ from files", deeplab_files_run, dev, counted,
                voc_files_corpus(os.path.join(root, "voc")))
            torch.cuda.empty_cache()
        if plan["pix2pix_files"]:
            inputs = os.path.join(root, "generate_inputs")
            jpegs = _fixture_jpegs()
            for i in range(GENERATE_INPUTS):
                _link(jpegs[i % len(jpegs)],
                      os.path.join(inputs, f"{i:03d}.jpg"))
            checks["pix2pix_files"] = phase(
                "pix2pix from files", pix2pix_files_run, dev, counted,
                pairs_files_corpus(os.path.join(root, "pairs")), inputs)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if plan["image_route"]:
        checks["image_route"] = image_route_run(dev, counted)
    if plan["budget"]:
        rates = {"resnet50 synthetic step": synthetic["step"][
            "images_per_sec"]}
        if "resnet50_files" in checks:
            rates["resnet50 file run"] = checks["resnet50_files"]["rate"][
                "images_per_sec"]
        checks["decode_budget"] = decode_budget(rates, card)
    zero = {k: 0 for k in kernels.WRAPPERS}
    runs = {k: counted.runs.get(k, zero) for k in FILE_RUNS}
    return runs, counted.shapes, checks


def _act_inputs(shape, dtype, g):
    """bn_act's inputs at ``shape``: x in ``dtype``, per-channel float32
    scale and shift."""
    import torch
    c = shape[-1]
    return (torch.randn(*shape, generator=g, device=g.device).to(dtype),
            torch.rand(c, generator=g, device=g.device) + 0.5,
            torch.randn(c, generator=g, device=g.device) * 0.5)


def corr_fwd_row(site, shape, path, g):
    """The correlation forward at ``shape`` (bf16, d = CORR_D) against its
    plain version, with its bound: one row, one launch of a forward of
    ``path``."""
    import torch

    from myconvnet_tpu_torch.ops.kernels import correlation as corr

    d, k = CORR_D, (2 * CORR_D + 1) ** 2
    n, h, w, c = shape
    f1, f2 = (torch.randn(shape, generator=g, device=g.device).bfloat16()
              for _ in range(2))
    out = corr.correlation_fwd(f1, f2, d)
    ref = corr.correlation_reference(f1, f2, d)
    torch.cuda.synchronize()
    tol = CORR_TOL * float(ref.abs().max())
    err = float((out - ref).abs().max())
    ok = err <= tol and bool(torch.isfinite(out).all())
    b_ms, b_by = bound(2 * f1.element_size() * f1.numel() + 4 * n * h * w * k,
                       2 * n * corr_taps(h, d) * corr_taps(w, d) * c,
                       BF16_FLOPS)
    r = dict(kernel="correlation_fwd", site=site, path=path,
             plan=corr.plan("fwd", shape, d, torch.bfloat16),
             shape=list(shape), dtype="bfloat16", sites=1, max_abs_err=err,
             tol=tol, ok=ok, bound_ms=b_ms, bound_by=b_by,
             ms=cuda_ms(lambda: corr.correlation_fwd(f1, f2, d)),
             plain_ms=graph_ms(lambda: corr.correlation_reference(f1, f2, d)),
             library_ms=None)
    log(f"correlation_fwd {path} {site} {r['shape']} bfloat16: "
        f"max_abs_err={err:.3g} (tol {tol:.3g}) ok={ok} "
        f"kernel={r['ms']:.4f}ms plain={r['plain_ms']:.4f}ms "
        f"bound={b_ms:.4f}ms ({b_by})")
    return r


def check_route_kernels(dev, g):
    """The kernels at the shapes of the routes and sngan_fid phases that no
    other row holds: conv_pair, conv_fused and bn_act at DeepLabv3+'s eval
    forward at the route batch on 513 x 513 (path ``routes_segment``),
    bn_act at the U-Net's 13 sites at the route batch
    (``routes_translate``), the correlation forward at PWC-Net's five
    levels at the route batch (``routes_flow``), conv_fused and bn_act at
    the CIFAR-100 ResNet-18's sites at FID_SAMPLES (the FID extractor's
    features, ``sngan_fid``), normalize_u8 at each image route's one image
    and at the SN-GAN train batch."""
    import torch

    from myconvnet_tpu_torch import recipes

    bf16 = torch.bfloat16
    rows = []
    pair, fused, act = deeplab_sites(ROUTE_BATCH, SEG_HW[0])
    for shape, count in pair:
        rows.append(conv_pair_row(shape, count, "routes_segment", g))
        torch.cuda.empty_cache()
    for shape, count in fused:
        rows.append(conv_fused_row(shape, count, "routes_segment", g))
    for site, shape, count in act:
        rows.append(bn_act_row(f"route deeplab {site}",
                               *_act_inputs(shape, bf16, g), count,
                               "routes_segment"))
    for site, shape, act in unet_sites(ROUTE_BATCH):
        rows.append(bn_act_row(f"route pix2pix {site}",
                               *_act_inputs(shape, bf16, g), 1,
                               "routes_translate", act=act))
    for site, shape, _ in CORR_SITES[:PWC_LEVELS]:
        rows.append(corr_fwd_row(site, (ROUTE_BATCH, *shape[1:]),
                                 "routes_flow", g))
    torch.cuda.empty_cache()
    for shape, count in FUSED_SITES:
        rows.append(conv_fused_row((FID_SAMPLES, *shape[1:]), count,
                                   "sngan_fid", g))
    for site, shape in ACT_SITES_R18:
        rows.append(bn_act_row(f"fid {site}", *_act_inputs(
            (FID_SAMPLES, *shape[1:]), bf16, g), 1, "sngan_fid"))
    for kind, config, hw in (("segment", VOC_CONFIG, SEG_HW),
                             ("classify", CONFIG, (224, 224))):
        mean, std = recipes.normalization(recipes.load_config(config), 3)
        rows.append(gan_input_row(f"routes_{kind}_image", (1, *hw, 3), g,
                                  mean, std))
    rows.append(gan_input_row("routes_translate_image", (1, 256, 256, 3), g))
    rows.append(gan_input_row("sngan", (SNGAN_BATCH, 32, 32, 3), g))
    return rows


def top_convs(fn, n=4):
    """The ``n`` convolutions of one call of ``fn`` with the most device
    time, by input shapes (torch.profiler, shapes recorded): [shapes, ms,
    calls]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "device_time_total",
                       getattr(e, "cuda_time_total", 0.0))
    convs = [e for e in prof.key_averages(group_by_input_shape=True)
             if e.key == "aten::cudnn_convolution"]
    top = [[str(e.input_shapes), dev_us(e) / 1e3, e.count] for e in sorted(
        convs, key=dev_us, reverse=True)[:n]]
    log("  convolutions by device time: " + "; ".join(
        f"{sh} {ms:.3f} ms x{k}" for sh, ms, k in top))
    return top


def route_trees(kind):
    """(config, params, state) of a route's model at full width, random
    JAX-layout weights from SEED."""
    from myconvnet_tpu_torch import models, recipes, recipes_gan
    from myconvnet_tpu_torch.weights import random_jax_params

    cfg = recipes.load_config(ROUTE_CONFIGS[kind])
    kw = cfg.get("model_kwargs", {})
    if kind == "segment":
        model = models.get_model(cfg["model"], cfg["num_classes"],
                                 input_hw=SEG_HW, **kw)
    elif kind == "translate":
        model = recipes_gan.gan_generator(cfg)
    elif kind == "flow":
        model = models.FLOW_MODELS[cfg["model"]](0, **kw)
    else:
        model = models.get_model(cfg["model"], cfg["num_classes"], **kw)
    return (cfg, *random_jax_params(model, SEED))


def route_vs_host(kind, card_server, card_route, host_route, x):
    """One request of the route on the card against the same route on the
    host (plain versions, a route batch of 1)."""
    import numpy as np

    from myconvnet_tpu_torch import serving_http

    card = card_server._execute(card_route, x)
    host = serving_http.ModelServer([host_route])._execute(host_route, x)
    if kind == "segment":
        (cls_c, conf_c), (cls_h, conf_h) = card, host
        out = dict(conf_max_abs_diff=float(np.abs(conf_c - conf_h).max()),
                   class_mismatch_frac=float((cls_c != cls_h).mean()))
        ok = (out["conf_max_abs_diff"] <= SEG_CONF_TOL
              and out["class_mismatch_frac"] <= SEG_CLASS_FRAC
              and bool(np.isfinite(conf_c).all()))
        tol = f"conf {SEG_CONF_TOL}, classes {SEG_CLASS_FRAC}"
    else:
        rel = float(np.abs(card - host).max() / np.abs(host).max())
        out = dict(rel_err=rel)
        tol = LOGIT_REL_TOL if kind == "translate" else FLOW_REL_TOL
        ok = rel <= tol and bool(np.isfinite(card).all())
    log(f"{kind} route: card vs host plain path {out} (tol {tol}) ok={ok}")
    if not ok:
        raise AssertionError(f"{kind} route: the card disagrees with the "
                             "host")
    return out


def _reply_ok(kind, reply, n, hw):
    """A route's response: n entries of the route's size, finite."""
    import base64
    import io

    import numpy as np
    from PIL import Image

    key = {"segment": "segmentations", "translate": "images",
           "flow": "flows"}[kind]
    rows = reply[key]
    if len(rows) != n:
        raise AssertionError(f"{kind}: {len(rows)} entries for {n} inputs")
    for r in rows:
        if kind == "segment":
            rle = np.asarray(r["rle"])
            good = (r["size"] == list(hw) and int(rle[1::2].sum())
                    == hw[0] * hw[1] and 0.0 < r["mean_conf"] <= 1.0)
        elif kind == "translate":
            good = Image.open(io.BytesIO(base64.b64decode(r))).size == \
                (hw[1], hw[0])
        else:
            good = (r["size"] == list(hw) and 0.0 <= r["mean_mag"]
                    <= r["max_mag"] and np.isfinite(r["max_mag"]))
        if not good:
            raise AssertionError(f"{kind}: a malformed entry {str(r)[:200]}")


def routes_run(dev):
    """The routes phase (step 21 of the module docstring).  Returns ({run:
    launches}, {run: Counter of launch shapes}, checks)."""
    import collections

    import numpy as np
    import torch

    from myconvnet_tpu_torch import serving_http

    counted = Counted()
    trees = {kind: route_trees(kind) for kind in ROUTE_CONFIGS}

    def build(kind, device, batch):
        cfg, params, state = trees[kind]
        return serving_http.build_route(kind, kind, cfg, params=params,
                                        state=state, batch=batch,
                                        device=device)

    t0 = time.perf_counter()
    routes = {k: build(k, dev, BATCH if k == "classify" else ROUTE_BATCH)
              for k in ROUTE_CONFIGS}
    log(f"routes built: {[r.describe() for r in routes.values()]} in "
        f"{time.perf_counter() - t0:.1f}s")
    calls = collections.Counter()

    def calling(kind, fn):
        def call(x):
            calls[kind] += 1
            return fn(x)
        return call

    for kind, r in routes.items():
        r.fn = calling(kind, r.fn)
    server = serving_http.ModelServer(list(routes.values()),
                                      batch_window_ms=ROUTE_WINDOW_MS)
    httpd = serving_http.make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/v1/models/"
    with open(_fixture_jpegs()[0], "rb") as f:
        jpeg = f.read()
    rs = np.random.RandomState(SEED)
    checks = {}
    try:
        for kind in ("segment", "translate", "flow"):
            route = routes[kind]
            h, w, c = route.input_shape[1:]
            xs = {n: rs.rand(n, h, w, c).astype(np.float32) for n in (1, 3)}
            bodies = {f"json{n}": (json.dumps({"instances": x.tolist()})
                                   .encode(), "application/json", n)
                      for n, x in xs.items()}
            if kind != "flow":
                bodies["image"] = (jpeg, "image/jpeg", 1)
            post(base + f"{kind}:predict", *bodies["json1"][:2])  # warm-up
            torch.cuda.synchronize()
            out = {}
            for name, (body, ctype, n) in bodies.items():
                run = f"routes_{kind}_{name}"
                calls.clear()
                t0 = time.perf_counter()
                reply = counted(run, post, base + f"{kind}:predict", body,
                                ctype)
                ms = (time.perf_counter() - t0) * 1e3
                want = dict(ROUTE_PER_CALL[kind])
                if name == "image":
                    want["normalize_u8"] = 1
                    b2_shapes(counted.shapes[run], (1, h, w, 3), 1,
                              f"{kind} route, image body")
                expect_only(counted.runs[run], want,
                            f"{kind} route, {name} body")
                if calls[kind] != 1:
                    raise AssertionError(f"{kind} route, {name} body: "
                                         f"{calls[kind]} device calls")
                _reply_ok(kind, reply, n, (h, w))
                out[name] = dict(ms=ms, bytes=len(body))
                log(f"{kind} route, {name} body ({len(body)} bytes): "
                    f"{ms:.1f} ms over HTTP (decode, normalize, window "
                    f"{ROUTE_WINDOW_MS:g} ms, forward, encode); 1 device "
                    f"call, launches {want}")
            x = server._prepare(route, rs.rand(ROUTE_BATCH, h, w, c).astype(
                np.float32))
            x = torch.as_tensor(x).to(dev)
            busy, span, n_kernels, top = device_busy(lambda: route.fn(x))
            out["device_call"] = dict(device_busy_ms=busy,
                                      device_span_ms=span,
                                      kernels=n_kernels, top_kernels=top)
            log(f"{kind} route device call (batch {ROUTE_BATCH}, "
                f"torch.profiler): busy "
                f"{busy if busy is None else round(busy, 3)} ms over "
                f"{n_kernels:.0f} kernels; top: " + "; ".join(
                    f"{nm[:50]} {t:.3f} ms" for nm, t, _ in top[:3]))
            if kind == "segment":
                out["top_convs"] = top_convs(lambda: route.fn(x))
            del x
            out["vs_host"] = route_vs_host(kind, server, route,
                                           build(kind, "cpu", 1), xs[1])
            checks[kind] = out
            torch.cuda.empty_cache()

        route = routes["classify"]
        h, w, _ = route.input_shape[1:]
        one = json.dumps({"instances": rs.rand(1, h, w, 3).astype(
            np.float32).tolist()}).encode()
        plain = serving_http.ModelServer([route])
        lone = {}
        for what, srv in (("without window", plain), ("with window",
                                                       server)):
            srv.predict("classify", one)
            times = []
            for _ in range(ROUTE_LATENCY_ITERS):
                t0 = time.perf_counter()
                srv.predict("classify", one)
                times.append((time.perf_counter() - t0) * 1e3)
            lone[what] = float(np.percentile(times, 50))
        log(f"classify route, a lone 1-image request (ModelServer.predict, "
            f"{ROUTE_LATENCY_ITERS} after a warm-up): p50 "
            f"{lone['without window']:.2f} ms without the window, "
            f"{lone['with window']:.2f} ms with {ROUTE_WINDOW_MS:g} ms")
        calls.clear()
        reply = counted("routes_classify_lone", post, base
                        + "classify:predict", one)
        expect_only(counted.runs["routes_classify_lone"], PER_CALL,
                    "classify route, a lone request")
        if calls["classify"] != 1:
            raise AssertionError("classify route: a lone request made "
                                 f"{calls['classify']} device calls")

        def concurrent():
            out = [None] * ROUTE_CONCURRENT
            barrier = threading.Barrier(ROUTE_CONCURRENT)

            def work(i):
                barrier.wait()
                out[i] = post(base + "classify:predict", jpeg, "image/jpeg")
            threads = [threading.Thread(target=work, args=(i,))
                       for i in range(ROUTE_CONCURRENT)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return out

        batcher = server._batchers["classify"]
        arrivals = []

        def submit(x, submit=batcher.submit):
            arrivals.append(time.perf_counter())
            return submit(x)
        batcher.submit, batcher.window = submit, ROUTE_BURST_WINDOW_MS / 1e3
        calls.clear()
        t0 = time.perf_counter()
        try:
            replies = counted("routes_classify_concurrent", concurrent)
        finally:
            del batcher.submit
            batcher.window = ROUTE_WINDOW_MS / 1e3
        ms = (time.perf_counter() - t0) * 1e3
        spread = ((max(arrivals) - min(arrivals)) * 1e3 if arrivals
                  else float("nan"))
        n_calls = calls["classify"]
        log(f"classify route: {ROUTE_CONCURRENT} concurrent one-image "
            f"requests in {ms:.1f} ms under a {ROUTE_BURST_WINDOW_MS:g} ms "
            f"window, their arrivals at the batcher spread over "
            f"{spread:.1f} ms, {n_calls} device call(s)")
        run = "routes_classify_concurrent"
        expect_only(counted.runs[run], {
            "normalize_u8": ROUTE_CONCURRENT, **PER_CALL},
            f"classify route, {ROUTE_CONCURRENT} concurrent requests")
        b2_shapes(counted.shapes[run], (1, h, w, 3), ROUTE_CONCURRENT,
                  "classify route, concurrent image bodies")
        alone = server.predict("classify", jpeg, "image/jpeg")
        if n_calls != 1 or None in replies or any(
                r["predictions"][0][0]["label"]
                != alone["predictions"][0][0]["label"] for r in replies):
            raise AssertionError(
                f"classify route: {ROUTE_CONCURRENT} concurrent requests "
                f"made {n_calls} device calls (want 1), or a reply differs "
                "from a lone request's")
        log(f"classify route: the burst's launches B2 {ROUTE_CONCURRENT}, "
            "then B5 13, B1 7 once; top-1 as a lone request's")
        x = torch.as_tensor(server._prepare(route, rs.rand(
            BATCH, h, w, 3).astype(np.float32))).to(dev)
        busy, span, n_kernels, _ = device_busy(lambda: route.fn(x))
        checks["classify"] = dict(
            lone_p50_ms=lone, concurrent_ms=ms,
            concurrent_window_ms=ROUTE_BURST_WINDOW_MS,
            arrival_spread_ms=spread,
            device_call=dict(device_busy_ms=busy, device_span_ms=span,
                             kernels=n_kernels))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    return counted.runs, counted.shapes, checks


def sngan_fid_run(dev, cifar_dir, card):
    """The sngan_fid phase (step 22 of the module docstring); removes the
    CIFAR phase's checkpoint ``cifar_dir`` after.  Returns ({run:
    launches}, {run: Counter of launch shapes}, checks)."""
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import nn as tnn
    from myconvnet_tpu_torch import recipes, recipes_gan, test, train
    from myconvnet_tpu_torch.eval.gan_metrics import fid_from_features

    counted = Counted()
    run_dir = os.path.join(ROOT, "build", "chip_smoke_sngan")
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    trainer = counted("sngan_train", train.main, [
        "--config", SNGAN_CONFIG, "--synthetic", "--steps",
        str(SNGAN_STEPS), "--batch", str(SNGAN_BATCH), "--set",
        "log_every=1", "--set", "sample_every=0", "--out", run_dir,
        "--device", str(dev)])
    train_s = time.perf_counter() - t0
    expect_only(counted.runs["sngan_train"], {"normalize_u8": SNGAN_STEPS},
                f"SN-GAN train.main ({SNGAN_STEPS} steps)")
    b2_shapes(counted.shapes["sngan_train"], (SNGAN_BATCH, 32, 32, 3),
              SNGAN_STEPS, "SN-GAN train.main")
    with open(os.path.join(run_dir, "gan_dcgan.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "d_loss" in r]
    if [r["step"] for r in rows] != list(range(1, SNGAN_STEPS + 1)) \
            or not all(np.isfinite(r[k]) for r in rows
                       for k in ("d_loss", "g_loss")):
        raise AssertionError(f"SN-GAN losses not all finite: {rows}")
    cfg = recipes.load_config(SNGAN_CONFIG)
    fresh = [m for m in recipes_gan.gan_discriminator(cfg).modules()
             if getattr(m, "spectral_norm", False)]
    sn = [m for m in trainer.discriminator.modules()
          if getattr(m, "spectral_norm", False)]
    moved = [not torch.equal(m.sn_u.cpu(), f.sn_u)
             for m, f in zip(sn, fresh) if m.sn_u.numel() > 1]
    norms = []
    with torch.no_grad():
        for m in sn:
            was = m.training
            w = m.w if isinstance(m, tnn.Conv) else m.weight.t()
            w_sn = tnn.spectral_normalize(m.eval(), w).double()
            m.train(was)
            norms.append(float(torch.linalg.matrix_norm(
                w_sn.reshape(-1, w_sn.shape[-1]), ord=2)))
    log(f"SN-GAN train.main: {SNGAN_STEPS} steps of {SNGAN_BATCH} in "
        f"{train_s:.1f}s; d_loss {rows[0]['d_loss']:.4f} -> "
        f"{rows[-1]['d_loss']:.4f}, g_loss {rows[0]['g_loss']:.4f} -> "
        f"{rows[-1]['g_loss']:.4f}; sn_u moved in {sum(moved)} of "
        f"{len(moved)} layers (the head's [1] is always 1); "
        f"||w / sigma||_2 per SN layer {[round(v, 4) for v in norms]} "
        f"(band {SN_BAND})")
    if not all(moved) or len(sn) != len(fresh) or not all(
            SN_BAND[0] <= v <= SN_BAND[1] for v in norms):
        raise AssertionError("SN-GAN: sn_u did not move, or a layer's "
                             "spectral norm is outside the band")
    rate = gan_step_rate(dev, trainer, shape=(SNGAN_BATCH, 32, 32, 3))
    del trainer
    torch.cuda.empty_cache()

    spec = f"{CIFAR_CONFIG}:{cifar_dir}"
    t0 = time.perf_counter()
    fid, fid_trainer = counted("sngan_fid", test.main, [
        "--config", SNGAN_CONFIG, "--synthetic", "--ckpt", run_dir, "--fid",
        "--fid_extractor", spec, "--fid_samples", str(FID_SAMPLES),
        "--device", str(dev)])
    fid_s = time.perf_counter() - t0
    chunks = -(-FID_SAMPLES // SNGAN_BATCH)
    expect_only(counted.runs["sngan_fid"], {
        "bn_act": 3 * chunks + 2 * PER_EVAL_BATCH["bn_act"],
        "conv_fused": 2 * PER_EVAL_BATCH["conv_fused"]},
        f"test.main --fid ({chunks} sample chunks, 2 feature batches)")
    feature_fn = test._fid_extractor(spec, dev)
    reals, fakes = test.fid_image_sets(cfg, fid_trainer, FID_SAMPLES, True,
                                       dev)
    fr, ff = feature_fn(reals), feature_fn(fakes)
    fid_card = fid_from_features(fr, ff)
    fid_host = fid_from_features(fr.cpu(), ff.cpu())
    rel = abs(fid_card - fid_host) / abs(fid_host)
    log(f"FID {fid:.4f} (test.main, {FID_SAMPLES} a side, {fr.shape[-1]}-d "
        f"features, {fid_s:.1f}s); over the same features card "
        f"{fid_card:.6f} vs host {fid_host:.6f}, {rel:.3g} apart (tol "
        f"{FID_RTOL}); SN-GAN step {rate['step_ms']:.2f} ms, idle share "
        f"{rate['idle_share']}; {card}")
    if not (np.isfinite(fid) and np.isfinite(fid_card)) or rel > FID_RTOL \
            or abs(fid - fid_card) > FID_RTOL * abs(fid_host):
        raise AssertionError("FID: not finite, or the card's disagrees "
                             "with the host's")
    shutil.rmtree(run_dir)
    shutil.rmtree(cifar_dir)
    return counted.runs, counted.shapes, dict(
        losses=rows, sn_norms=norms, step=rate, fid=fid, fid_card=fid_card,
        fid_host=fid_host, fid_rel=rel, train_s=train_s, fid_s=fid_s)


def export_inputs(root):
    """``serve --artifact``'s inputs, linked from the fixtures: the eight
    ImageNet-like JPEGs (classify), four of them (translate), the four VOC
    JPEGs (segment) and four frame pairs ``pair<i>_a/_b`` (flow)."""
    jpegs = _fixture_jpegs()
    voc_dir = os.path.join(FIXTURES, "voc", "JPEGImages")
    voc = [os.path.join(voc_dir, f) for f in sorted(os.listdir(voc_dir))]
    dirs = {}
    for kind, files in (("classify", jpegs[:BATCH]),
                        ("translate", jpegs[:ROUTE_BATCH]),
                        ("segment", voc[:ROUTE_BATCH])):
        dirs[kind] = os.path.join(root, "inputs", kind)
        for f in files:
            _link(f, os.path.join(dirs[kind], os.path.basename(f)))
    dirs["flow"] = os.path.join(root, "inputs", "flow")
    for i in range(ROUTE_BATCH):
        _link(jpegs[i], os.path.join(dirs["flow"], f"pair{i}_a.jpg"))
        _link(jpegs[i + 1], os.path.join(dirs["flow"], f"pair{i}_b.jpg"))
    return dirs


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def export_case(dev, name, counted, root, inputs, voc_root, case=None):
    """One artifact of the export phase (``case``, else EXPORT_CASES[name]):
    the checkpoint of the family phase's ``train.main`` run of the recipe
    (KEPT), or the recipe's net (or G and D) from its seed saved as one,
    ``test.main --export``, ``serve.main --artifact`` in the kind's mode,
    the artifact and the in-memory route program on the same wire rows (a
    RepVGG's: its reparameterized deploy program, built from the same
    checkpoint), and both programs' latency.  Raises on a failed check;
    returns the record."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import (recipes, recipes_gan, serve, serving,
                                     serving_http, test)
    from myconvnet_tpu_torch.core.precision import get_policy
    from myconvnet_tpu_torch.weights import load_jax_checkpoint

    config, kind, per_call, batch, sets = case or EXPORT_CASES[name]
    cfg = recipes.apply_overrides(recipes.load_config(config), sets)
    d = os.path.join(root, name)
    ckpt, path = os.path.join(d, "ckpt"), os.path.join(d, f"{name}.pt2")
    kept = os.path.join(KEPT, name)
    data = ["--synthetic"]
    if name == "deeplab":
        # the recipe's 513 x 513 crop: a synthetic segmenter is built at 96
        cfg["data_dir"] = voc_root
        data = ["--data_dir", voc_root]
    os.makedirs(d, exist_ok=True)
    t0 = time.perf_counter()
    if os.path.isdir(kept):
        # the family phase's train.main run of this recipe
        ckpt = kept
    elif kind in ("translate", "sample"):
        trainer, _ = recipes_gan.build_gan(cfg, True, device=dev)
        trainer.save(ckpt)
        del trainer
    else:
        net, _, _ = recipes.convnet_builder(cfg["task"])(
            cfg, name != "deeplab", device=dev)
        net.build(recipes.optimizer_factory(cfg["optimizer"]))
        net.save(ckpt)
        del net
    torch.cuda.empty_cache()
    out = dict(ckpt_s=time.perf_counter() - t0,
               ckpt_from="train.main run" if ckpt == kept else "recipe seed")
    argv = ["--config", config, "--ckpt", ckpt, "--device", dev.type,
            *data, *[a for kv in sets for a in ("--set", kv)]]
    t0 = time.perf_counter()
    counted(f"export_{name}_export", test.main, [*argv, "--export", path])
    out["export_s"] = time.perf_counter() - t0
    out["mb"] = os.path.getsize(path) / 1e6
    expect_only(counted.runs[f"export_{name}_export"], {},
                f"{name}: test --export (traced with fake tensors)")
    meta = serving.artifact_meta(path)
    out["meta"] = meta
    if (meta["device"] != dev.type or meta["ops"] != per_call
            or meta["input_shape"][0] != batch):
        raise AssertionError(f"{name}: artifact {meta}; want cuda, mcn:: "
                             f"nodes {per_call}, batch {batch}")

    # serve --artifact in the kind's mode, as users run it: one call
    mode = {"classify": ["--images", inputs["classify"], "--config",
                         config],
            "segment": ["--segment", "--images", inputs["segment"],
                        "--config", config],
            "translate": ["--translate", "--images", inputs["translate"]],
            "flow": ["--flow", "--images", inputs["flow"]],
            "sample": ["--sample", str(batch)]}[kind]
    if kind != "classify":
        mode += ["--out", os.path.join(d, "samples.png" if kind == "sample"
                                       else "out")]
    t0 = time.perf_counter()
    served = counted(f"export_{name}_serve", serve.main,
                     ["--artifact", path, "--device", dev.type, *mode])
    out["serve_s"] = time.perf_counter() - t0
    expect_only(counted.runs[f"export_{name}_serve"], per_call,
                f"{name}: serve --artifact, one device call")
    if len(served) != batch:
        raise AssertionError(f"{name}: serve --artifact gave {len(served)} "
                             f"results for {batch} inputs")

    # the artifact against the route program built in memory from the
    # same checkpoint, on one batch of wire rows
    fn = serving.load_inference(path)
    shape = fn.input_shapes[0]
    rs = np.random.RandomState(SEED)
    x = (rs.standard_normal(shape) if kind in ("classify", "sample")
         else rs.rand(*shape)).astype(np.float32)
    xd = torch.from_numpy(x).to(dev)
    if kind == "sample":
        prog = serving.make_inference_fn(
            recipes_gan.gan_generator(cfg),
            *load_jax_checkpoint(ckpt, ("g_params", "g_state")),
            fold_bn=False, device=dev,
            policy=get_policy(cfg.get("precision", "f32")))
        mem = serving.image_to_image_program(prog, post=serving.from_tanh)
    elif name.startswith("repvgg"):
        from myconvnet_tpu_torch import models
        from myconvnet_tpu_torch.models.repvgg import deploy_model
        from myconvnet_tpu_torch.weights import from_jax
        train_form = from_jax(models.get_model(cfg["model"],
                                               cfg["num_classes"]),
                              *load_jax_checkpoint(ckpt)).to(dev).eval()
        prog = serving.make_inference_fn(
            deploy_model(train_form, cfg["model"], cfg["num_classes"]),
            None, None, fold_bn=False, device=dev,
            policy=get_policy(cfg.get("precision", "f32")))
        mem = torch.no_grad()(prog.program)
    else:
        route = serving_http.build_route(name, kind, cfg, ckpt=ckpt,
                                         batch=batch, device=dev)
        mem = route.fn if route.pre is None else (
            lambda v: route.fn(route.pre(v)))
    got = _outputs(counted(f"export_{name}_artifact", fn, xd))
    want = _outputs(counted(f"export_{name}_memory", mem, xd))
    for part in ("artifact", "memory"):
        expect_only(counted.runs[f"export_{name}_{part}"], per_call,
                    f"{name}: the {part} program, one call")
    by_shape = [dict(counted.shapes[f"export_{name}_{part}"])
                for part in ("artifact", "memory")]
    if by_shape[0] != by_shape[1]:
        raise AssertionError(f"{name}: launches by shape, artifact "
                             f"{by_shape[0]} vs in memory {by_shape[1]}")
    out["launches_by_shape"] = {" ".join(map(str, k)): c
                                for k, c in sorted(by_shape[0].items())}
    # the flash forward has no by_path: hold its shapes to FLASH_SITES
    held = {("flash_attention_fwd", *s) for s, *_ in FLASH_SITES}
    unheld = [k for k in by_shape[0]
              if k[0] == "flash_attention_fwd" and k not in held]
    if unheld:
        raise AssertionError(f"{name}: flash forward launched at shapes no "
                             f"FLASH_SITES row holds: {unheld}")
    diffs = [float((g.float() - w.float()).abs().max()) for g, w in
             zip(got, want)]
    out["artifact_vs_memory_max_abs_diff"] = diffs
    out["bit_exact"] = all(torch.equal(g, w) for g, w in zip(got, want))
    # the in-memory program against itself: a nondeterministic op shows
    # here
    again = _outputs(mem(xd))
    out["memory_vs_itself_max_abs_diff"] = [
        float((g.float() - w.float()).abs().max())
        for g, w in zip(again, want)]
    del again
    tol = EXPORT_TOL.get(name, 0.0)
    finite = all(bool(torch.isfinite(g.float()).all()) for g in got)
    log(f"export {name}: checkpoint ({out['ckpt_from']}) "
        f"{out['ckpt_s']:.1f}s, test --export "
        f"{out['export_s']:.1f}s, {out['mb']:.1f} MB, mcn:: nodes "
        f"{meta['ops']}; serve --artifact {out['serve_s']:.1f}s; artifact "
        f"vs in-memory program at {list(shape)}: bit-exact "
        f"{out['bit_exact']} (max abs diff {diffs}, tol {tol:.3g}; the "
        f"in-memory program against itself "
        f"{out['memory_vs_itself_max_abs_diff']}), launches by shape "
        f"equal: {out['launches_by_shape']}")
    if max(diffs) > tol or not finite:
        raise AssertionError(f"{name}: the artifact's outputs differ from "
                             f"the in-memory program's by {diffs} (tol "
                             f"{tol:.3g}; finite {finite})")
    del got, want, xd

    # latency: the artifact through serve --latency, the in-memory program
    # at the artifact's one batch through the same measure
    request_sizes = EXPORT_LATENCY_SIZES.get(name)
    if not request_sizes:
        del fn, mem
        torch.cuda.empty_cache()
        return out
    sizes = ",".join(map(str, request_sizes))
    lat = serve.main(["--artifact", path, "--latency", "--sizes", sizes,
                      "--device", dev.type])
    mem_lat = serving.measure_latency(
        serving.make_batched_server(
            lambda v: mem(torch.as_tensor(v).to(dev)), batch_sizes=(batch,)),
        shape[1:], request_sizes=request_sizes)
    out["latency_ms"] = {
        n: {"artifact": {k: lat[n][k] for k in ("p50", "p95")},
            "memory": {k: mem_lat[n][k] for k in ("p50", "p95")}}
        for n in request_sizes}
    log(f"export {name} latency (p50/p95 ms, artifact | in memory): "
        + "; ".join(f"n={n} {r['artifact']['p50']:.2f}/"
                    f"{r['artifact']['p95']:.2f} | {r['memory']['p50']:.2f}/"
                    f"{r['memory']['p95']:.2f}"
                    for n, r in out["latency_ms"].items()))
    del fn, mem
    torch.cuda.empty_cache()
    return out


def export_route_run(dev, counted, path):
    """The segment artifact behind ``serve --serve``'s route spec
    ``NAME=KIND:ARTIFACT:CONFIG`` (parse_route_spec, route_from_spec,
    ModelServer, the HTTP server on localhost), sent one fixture JPEG:
    B2 once at [1, 513, 513, 3], then one device call."""
    from myconvnet_tpu_torch import serving_http

    spec = serving_http.parse_route_spec(f"seg=segment:{path}:{VOC_CONFIG}")
    route = serving_http.route_from_spec(spec, device=dev)
    httpd = serving_http.make_http_server(
        serving_http.ModelServer([route]), "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}/v1/models/"
           "seg:predict")
    voc = os.path.join(FIXTURES, "voc", "JPEGImages")
    with open(os.path.join(voc, sorted(os.listdir(voc))[0]), "rb") as f:
        jpeg = f.read()
    try:
        post(url, jpeg, "image/jpeg")     # the route's first call
        t0 = time.perf_counter()
        reply = counted("export_route", post, url, jpeg, "image/jpeg")
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if thread.is_alive():
        raise RuntimeError("HTTP server thread did not stop")
    expect_only(counted.runs["export_route"], {
        "normalize_u8": 1, **ROUTE_PER_CALL["segment"]},
        "the artifact route, a JPEG body")
    b2_shapes(counted.shapes["export_route"], (1, *SEG_HW, 3), 1,
              "the artifact route, a JPEG body")
    _reply_ok("segment", reply, 1, SEG_HW)
    log(f"artifact route seg=segment:ARTIFACT:CONFIG: a JPEG body in "
        f"{ms:.1f} ms over HTTP; B2 1, then B5 11, B4 2, B1 18")
    return dict(ms=ms, bytes=len(jpeg), describe=route.describe())


def export_run(dev):
    """The export phase (step 23 of the module docstring): every
    EXPORT_CASES artifact, then the artifact route.  Returns ({run:
    launches}, {run: Counter of launch shapes}, checks)."""
    import shutil

    root = os.path.join(ROOT, "build", "chip_smoke_export")
    shutil.rmtree(root, ignore_errors=True)
    counted = Counted()
    inputs = export_inputs(root)
    voc_root = voc_files_corpus(os.path.join(root, "voc"))
    checks = {}
    try:
        for name in EXPORT_CASES:
            checks[name] = export_case(dev, name, counted, root, inputs,
                                       voc_root)
        checks["route"] = export_route_run(
            dev, counted, os.path.join(root, "deeplab", "deeplab.pt2"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
        shutil.rmtree(KEPT, ignore_errors=True)
    return counted.runs, counted.shapes, checks


def swin_attention_ms(trainer, micro):
    """CUDA-event ms of the window-attention modules (qkv, the float32
    score chain with the bias and the mask, proj) forward and backward
    alone, summed over the blocks of one train step of ``micro`` x the
    step's microbatches, each at its block's [B * nW, 49, C] bf16 input."""
    import torch

    total = 0.0
    for block in trainer.model.blocks():
        h, w = block.hw
        c = block.ln1.gamma.shape[0]
        rows = micro * (h // block.ws) * (w // block.ws)
        x = torch.randn(rows, block.ws ** 2, c, device=block.ln1.gamma.device,
                        dtype=torch.bfloat16, requires_grad=True)

        def fwd_bwd():
            out = block.attn(x)
            torch.autograd.grad(out, [x, *block.attn.parameters()],
                                torch.ones_like(out))

        total += cuda_ms(fwd_bwd, iters=3, warmup=1)
        del x
    trainer.model.zero_grad(set_to_none=True)
    return total * trainer.accum_steps


def swin_run(dev):
    """Swin-T (``configs/imagenet_swin_t.py`` as written: bf16, RandAugment
    (2, 9) over the FAST pool, MixUp/CutMix, drop-path 0.2, AdamW with
    clipping): step 1 at SWIN_STEP1_BATCH on the card against the host
    with the same draws and drop-path masks; ``train.main`` for SWIN_STEPS
    steps of SWIN_BATCH as SWIN_ACCUM microbatches and ``test.main`` (no
    kernel launched: the window attention is plain ops and takes no flash
    kernel); the step's rate, idle share and peak memory, and the window
    attention modules' share of its device busy time.  Returns
    (train launches, test launches, checks)."""
    checks = {"step1": vit_step_one(dev, classifier_cfg(SWIN_CONFIG),
                                    SWIN_STEP1_BATCH, "Swin-T")}
    train_counts, eval_counts, run, trainer, _ = classifier_run(
        dev, "Swin-T", SWIN_CONFIG,
        [f"accum_steps={SWIN_ACCUM}", f"synthetic_n={SWIN_SPLIT}"],
        steps=SWIN_STEPS, batch=SWIN_BATCH, val_every=0, forward={},
        split=SWIN_SPLIT, check_n=SWIN_STEP1_BATCH, rate_iters=2,
        raw_hw=(256, 256), keep="swin_t")
    checks.update(run)
    attn = swin_attention_ms(trainer, SWIN_BATCH // SWIN_ACCUM)
    busy = run["step"]["device_busy_ms"]
    checks["window_attention_ms"] = attn
    checks["window_attention_share"] = None if busy is None else attn / busy
    log(f"Swin-T window attention (qkv, float32 scores, proj; forward and "
        f"backward alone at the step's shapes): {attn:.1f} ms a step of "
        f"{SWIN_BATCH}, share of device busy "
        f"{checks['window_attention_share']}")
    return train_counts, eval_counts, checks


def flash_backward_shapes(counter):
    """Count ("flash_attention_dq", b, h, l, d) and its dK/dV twin a
    backward of the flash autograd Function on CUDA tensors (each launches
    one dQ and one dK/dV kernel) into ``counter`` while the block runs."""
    from myconvnet_tpu_torch.ops.kernels import flash_attention as fa

    @contextlib.contextmanager
    def patched():
        orig = fa.FlashAttention.backward

        def backward(ctx, do):
            if do.device.type == "cuda":
                for name in FLASH[1:]:
                    counter[(name, *do.shape)] += 1
            return orig(ctx, do)

        fa.FlashAttention.backward = staticmethod(backward)
        try:
            yield counter
        finally:
            fa.FlashAttention.backward = staticmethod(orig)
    return patched()


def to_cpu(obj):
    """Tensors of a draw (tuples, NamedTuples, dicts) on the host."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        items = [to_cpu(v) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else tuple(items)
    return obj


def ssl_step_one(dev, what, cfg, n):
    """Step 1 of a self-supervised recipe at batch ``n`` from seeded
    JAX-layout weights, with the same batch and draws (the views' boxes,
    flips, jitter factors and grayscale choices, MAE's masking draw) on
    the card and on the host."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes_ssl, weights

    card, train_set, _ = recipes_ssl.build_ssl(cfg, True, device=dev)
    host, _, _ = recipes_ssl.build_ssl(cfg, True, device=torch.device("cpu"))
    params, state = weights.random_jax_params(card.model, SEED)
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    x = torch.from_numpy(train_set.source.get_batch(np.arange(n))[0])
    draws = card.sample(n, tuple(x.shape[1:3]))
    t0 = time.perf_counter()
    loss_card = card.loss(x.to(dev), draws)["loss"]
    loss_card.backward()
    loss_card = float(loss_card.detach())
    t1 = time.perf_counter()
    loss_host = host.loss(x, to_cpu(draws))["loss"]
    loss_host.backward()
    t2 = time.perf_counter()
    return step_one_verdict(
        f"{what} step 1 (batch {n})", card, host, loss_card,
        float(loss_host.detach()),
        f"; card {t1 - t0:.2f}s (first, cold), host {t2 - t1:.2f}s")


def ssl_run(dev, what, config, sets, *, steps, batch, split, per_step,
            per_probe_batch, check_n, b2_per_probe=0):
    """``train.main`` on a self-supervised recipe for ``steps`` steps of
    ``batch`` (a log line and a checkpoint a step; the kNN probe at the
    end over the train and val splits of ``split`` images), then
    ``test.main`` (the probe again, the encoder re-exported): each run's
    launches held by shape against ``per_step`` (a train step's) and
    ``per_probe_batch`` (a probe batch's), each a {key: count} of
    :func:`shape_key`-style keys, and normalize_u8's total against
    ``b2_per_probe`` a probe batch; the losses (and SimCLR's contrast_acc)
    finite, ``encoder.npz`` written; the restored trainer's probe
    features equal the writer's and agree with the host's plain path on
    ``check_n`` images; the step's rate.  Returns (train launches, test
    launches, {run: launches by shape}, checks, trainer)."""
    import shutil
    from collections import Counter

    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes_ssl, test, train
    from myconvnet_tpu_torch.ops import kernels

    tag = "".join(c if c.isalnum() else "_" for c in what.lower())
    run_dir = os.path.join(ROOT, "build", f"chip_smoke_{tag}")
    shutil.rmtree(run_dir, ignore_errors=True)
    args = ["--config", config, "--synthetic", "--batch", str(batch),
            *[a for kv in [*sets, f"synthetic_n={split}"]
              for a in ("--set", kv)], "--device", dev.type]
    probes = 2 * -(-split // batch)    # the bank's and the query's batches

    def run(fn, argv, n_steps, n_probe):
        kernels.reset_launch_counts()
        shapes = Counter()
        with launch_shapes(shapes), flash_backward_shapes(shapes):
            out = fn(argv)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = Counter()
        for key, k in per_step.items():
            want[key] += k * n_steps
        for key, k in per_probe_batch.items():
            want[key] += k * n_probe
        want = {k: v for k, v in want.items() if v}
        by_shape = {k: v for k, v in shapes.items()
                    if k[0] != "normalize_u8"}
        if by_shape != want:
            raise AssertionError(f"{what}: launches by shape {by_shape}, "
                                 f"want {dict(want)}")
        totals = {name: sum(v for k, v in want.items() if k[0] == name)
                  for name in kernels.WRAPPERS}
        totals["normalize_u8"] = b2_per_probe * n_probe
        check_counts(counts, totals, f"{what} ({n_steps} steps, {n_probe} "
                     "probe batches)")
        return out, counts, shapes

    t0 = time.perf_counter()
    trainer, train_counts, train_shapes = run(
        train.main, args + ["--steps", str(steps), "--out", run_dir,
                            "--set", "log_every=1", "--set", "val_every=0"],
        steps, probes)
    seconds = time.perf_counter() - t0
    with open(os.path.join(run_dir, f"ssl_{trainer.kind}.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "loss" in r]
    keys = ("loss", "contrast_acc") if trainer.kind == "simclr" \
        else ("loss",)
    if len(rows) != steps or not all(np.isfinite(r[k]) for r in rows
                                     for k in keys):
        raise AssertionError(f"{what}: metrics not all finite: {rows}")
    enc = os.path.join(run_dir, "encoder.npz")
    with np.load(enc) as f:
        n_keys = len(f.files)
    log(f"{what}: train.main {steps} steps of {batch} in {seconds:.1f}s "
        f"(probe and checkpoints included); " + ", ".join(
            f"{k} first {rows[0][k]:.4f} last {rows[-1][k]:.4f}"
            for k in keys) + f"; encoder.npz {n_keys} arrays")
    (knn, restored), test_counts, test_shapes = run(
        test.main, args + ["--ckpt", run_dir], 0, probes)
    cfg = classifier_cfg(config, sets)
    x = torch.from_numpy(recipes_ssl.make_sources(
        dict(cfg, synthetic_n=check_n), True, splits=("val",))[0].images)
    writer = trainer.embed(x.to(dev))
    reread = restored.embed(x.to(dev))
    host, _, _ = recipes_ssl.build_ssl(dict(cfg, synthetic_n=check_n), True,
                                       device=torch.device("cpu"))
    host.load_state(trainer.state())
    plain = host.embed(x).numpy()
    card = writer.cpu().numpy()
    rel = float(np.abs(card - plain).max() / np.abs(plain).max())
    tol = LOGIT_REL_TOL if cfg.get("precision") == "bf16" \
        else LOGIT_REL_TOL_F32
    same = bool(torch.equal(writer, reread))
    log(f"{what} test.main kNN top-1 {knn:.4f}; restored features equal "
        f"the writer's: {same}; card vs host plain path on {check_n} "
        f"images max|diff|/max|feature| = {rel:.4g} (tol {tol})")
    if not same or not np.isfinite(card).all() or rel > tol:
        raise AssertionError(f"{what}: probe features disagree")
    shutil.rmtree(run_dir)
    del restored, host
    # the step's rate on the split's first batch
    xd = torch.from_numpy(recipes_ssl.make_sources(
        dict(cfg, synthetic_n=batch), True, splits=("train",))[0].images
        ).to(dev)
    for _ in range(2):
        trainer.train_step(xd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    step_ms, host_ms = events_ms(lambda: trainer.train_step(xd), 3)
    peak = torch.cuda.max_memory_allocated(dev)
    busy, span, n_kernels, top = device_busy(
        lambda: trainer.train_step(xd), iters=1)
    rate = dict(batch=batch, accum_steps=1, step_ms=step_ms,
                images_per_sec=batch * 1e3 / step_ms,
                host_enqueue_ms=host_ms, device_busy_ms=busy,
                device_span_ms=span,
                idle_share=None if busy is None else 1 - busy / step_ms,
                kernels_per_step=n_kernels, top_kernels=top,
                max_memory_allocated_gb=peak / 2 ** 30)
    log_rate(what, rate)
    checks = dict(metrics=rows, train_seconds=seconds, knn_top1=knn,
                  probe_feature_rel_err=rel, step=rate,
                  encoder_arrays=n_keys)
    shapes = {f"{tag}_train": train_shapes, f"{tag}_test": test_shapes}
    return train_counts, test_counts, shapes, checks, trainer


def flash_keys(shape, count, kernels=FLASH):
    return {(name, *shape): count for name in kernels}


def mae_run(dev):
    """MAE ViT-B/16 (``configs/imagenet_mae_vit_b16.py``, bf16, its
    ``mesh=dict(data=None)``) at MAE_BATCH, the largest batch that fitted
    the card when it was chosen (a cut in batch only; not checked here):
    step 1 against the host; train.main and test.main through
    :func:`ssl_run` (each flash kernel 12 times at the encoder's [B, 12,
    50, 64] and 8 at the decoder's [B, 16, 197, 32] a step, the forward 12
    at [B, 12, 197, 64] a probe batch); the encoder file warm-starts
    ``vit_b16``.  Returns (train launches, test launches, shapes,
    checks)."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, weights

    checks = {"step1": ssl_step_one(dev, "MAE-B16",
                                    classifier_cfg(MAE_CONFIG),
                                    SSL_STEP1_BATCH)}
    per_step = {**flash_keys(MAE_SITES[0][0], MAE_DEPTH),
                **flash_keys(MAE_SITES[1][0], MAE_DEC_DEPTH)}
    per_probe = flash_keys(MAE_PROBE_SHAPE, MAE_DEPTH, FLASH[:1])
    train_counts, test_counts, shapes, run, trainer = ssl_run(
        dev, "MAE-B16", MAE_CONFIG, [], steps=SSL_STEPS, batch=MAE_BATCH,
        split=MAE_BATCH, per_step=per_step, per_probe_batch=per_probe,
        check_n=SSL_STEP1_BATCH)
    checks.update(run)
    # the encoder file warm-starts the ViT-B/16 classifier
    path = os.path.join(ROOT, "build", "chip_smoke_mae_encoder.npz")
    trainer.export_encoder(path)
    cfg = classifier_cfg(VIT_CONFIG, ["synthetic_n=8"])
    cfg["pretrained"] = dict(path=path)
    vit, _, _ = recipes.build_trainer(cfg, True, device=torch.device("cpu"))
    got, _ = weights.to_jax(vit.model)
    want, _ = weights.to_jax(trainer.model)
    loaded = [f"{s}/{k}" for s in want if not s.startswith("decoder")
              for k in want[s] if np.array_equal(got[s][k], want[s][k])]
    total = sum(len(d) for s, d in want.items()
                if not s.startswith("decoder"))
    os.remove(path)
    log(f"MAE-B16 encoder.npz -> vit_b16: {len(loaded)} of {total} encoder "
        "arrays loaded bit for bit")
    if len(loaded) != total:
        raise AssertionError("the MAE encoder did not warm-start vit_b16")
    checks["warm_start_arrays"] = len(loaded)
    return train_counts, test_counts, shapes, checks


def mae_cifar_run(dev):
    """``configs/cifar10_mae.py`` as written (``tinymae``, float32, batch
    128): step 1 against the host; train.main and test.main through
    :func:`ssl_run` (no kernel in a step; normalize_u8 once a probe batch
    of the 512-image splits).  Returns (train launches, test launches,
    checks)."""
    checks = {"step1": ssl_step_one(dev, "MAE CIFAR-10",
                                    classifier_cfg(MAE_CIFAR_CONFIG),
                                    SSL_STEP1_BATCH)}
    train_counts, test_counts, _, run, _ = ssl_run(
        dev, "MAE CIFAR", MAE_CIFAR_CONFIG, [], steps=SSL_STEPS,
        batch=SMALLNET_BATCH, split=SMALLNET_SPLIT, per_step={},
        per_probe_batch={}, check_n=SSL_STEP1_BATCH, b2_per_probe=1)
    checks.update(run)
    return train_counts, test_counts, checks


def simclr_run(dev):
    """SimCLR: ``configs/cifar10_simclr.py`` as written (SmallNet, float32,
    batch 128) and ``configs/imagenet_simclr_resnet50.py`` (ResNet-50,
    bf16, LARS, its ``mesh=dict(data=None)``) at SIMCLR_R50_BATCH, the
    largest batch that fitted the card when it was chosen (not checked
    here): step 1 of each against the host; train.main and test.main
    through :func:`ssl_run` (no kernel in a train step; a probe batch
    SmallNet's 6 bn_act and normalize_u8 once, or ResNet-50's 13
    conv_pair and 7 bn_act, held by shape).  Returns
    (train and test launches by run, shapes, checks)."""
    checks, runs, shapes = {}, {}, {}
    for tag, config, batch, split, forward, b2 in (
            ("simclr_cifar", SIMCLR_CIFAR_CONFIG, SMALLNET_BATCH,
             SMALLNET_SPLIT, smallnet_probe_keys(), 1),
            ("simclr_r50", SIMCLR_R50_CONFIG, SIMCLR_R50_BATCH,
             SIMCLR_R50_BATCH, r50_probe_keys(SIMCLR_R50_BATCH), 0)):
        cfg = classifier_cfg(config)
        checks[f"{tag}_step1"] = ssl_step_one(dev, tag, cfg,
                                              SSL_STEP1_BATCH)
        tr, te, sh, checks[tag], trainer = ssl_run(
            dev, tag, config, [], steps=SSL_STEPS, batch=batch,
            split=split, per_step={}, per_probe_batch=forward,
            check_n=SSL_STEP1_BATCH, b2_per_probe=b2)
        del trainer
        runs[f"{tag}_train"], runs[f"{tag}_test"] = tr, te
        shapes.update(sh)
    return runs, shapes, checks


def smallnet_probe_keys():
    """SmallNet's (width 32, float32) bn_act launches by shape a probe
    batch of 128."""
    return {shape_key("bn_act", shape, dtype): count
            for _, shape, count, dtype in SMALLNET_ACT_SITES
            if dtype == "float32"}


def r50_probe_keys(batch):
    """ResNet-50's conv_pair and bn_act launches by shape an eval batch."""
    keys = {}
    for shape, count in PAIR_SITES:
        key = shape_key("conv_pair", (batch, *shape[1:]))
        keys[key] = keys.get(key, 0) + count
    for _, shape in ACT_SITES:
        key = shape_key("bn_act", (batch, *shape[1:]), "bfloat16")
        keys[key] = keys.get(key, 0) + 1
    return keys


def check_ssl_kernels(dev, g):
    """conv_pair and bn_act at the ResNet-50 SimCLR probe's eval batch
    (path ``simclr_resnet50``) against their plain versions, one row per
    shape."""
    import torch

    rows = []
    for shape, count in PAIR_SITES:
        rows.append(conv_pair_row((SIMCLR_R50_BATCH, *shape[1:]), count,
                                  "simclr_resnet50", g))
        torch.cuda.empty_cache()
    for site, shape in ACT_SITES:
        x = torch.randn(SIMCLR_R50_BATCH, *shape[1:], generator=g,
                        device=dev).bfloat16()
        c = shape[-1]
        rows.append(bn_act_row(f"simclr r50 {site}", x, torch.rand(
            c, generator=g, device=dev) + 0.5, torch.randn(
            c, generator=g, device=dev) * 0.5, 1, "simclr_resnet50"))
        del x
    torch.cuda.empty_cache()
    return rows


def flash_by_path(name, details, runs):
    """A flash kernel's launches and times path by path: ViT's (its
    train, test, policy and artifact runs) and MAE's (``mae_b16_*``),
    beside the kernel, plain and bound ms of the rows of one train step
    (one microbatch for ViT) at the path's shapes."""
    out = {}
    for path in ("vit", "mae"):
        names = [k for k in runs if (k.startswith("mae_b16") if path == "mae"
                                     else not k.startswith("mae_b16"))]
        rows = [r for r in details if r["kernel"] == name
                and r.get("path") == path and r["sites"]]
        launches = sum(runs[k][name] for k in names)
        if not launches:
            continue
        if not rows:
            raise AssertionError(f"{name} launched on {path} but held at "
                                 "none of its shapes")
        out[path] = dict(
            launches=launches,
            **{k: sum(r[k] * r["sites"] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms")},
            bound_by=max(rows, key=lambda r: r["bound_ms"] * r["sites"]
                         )["bound_by"],
            library_ms=(sum(r["library_ms"] * r["sites"] for r in rows)
                        if all(r["library_ms"] is not None for r in rows)
                        else None))
    return out


def classifier_step_ones(dev):
    """Step 1 of ResNet-50, VGG-16 and DenseNet-121 at STEP1_BATCH, each
    on the card against the host (:func:`step_one_classifier`).  A train
    step launches no kernel of the library, so this runs while it
    compiles."""
    configs = {"resnet50": CONFIG, **{k: v[0] for k, v in BIG_RUNS.items()}}
    return {name: step_one_classifier(dev, CLASSIFIER_NAMES[name],
                                      classifier_cfg(configs[name]), n)
            for name, n in STEP1_BATCH.items()}


def step_one_only(specs):
    """Step 1 of ResNet-50, VGG-16 and DenseNet-121, or of a
    REPR_RECIPES recipe, against the host alone (``name:batch`` specs,
    default each classifier at STEP1_BATCH; ``name:batch:seed`` for a
    recipe's weights from another seed), records in
    chiprun_out/step_one.json."""
    import torch

    sys.path.insert(0, ROOT)
    from myconvnet_tpu_torch.core.precision import FULL, apply_backend_flags
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    apply_backend_flags(FULL)
    configs = {"resnet50": CONFIG, **{k: v[0] for k, v in BIG_RUNS.items()}}
    out = {}
    for spec in specs or [f"{k}:{v}" for k, v in STEP1_BATCH.items()]:
        name, n, *seed = spec.split(":")
        if name in REPR_RECIPES:
            out[spec] = repr_step_one(torch.device("cuda", 0), name,
                                      repr_cfg(name), int(*seed or [SEED]),
                                      int(n))
            continue
        out[spec] = step_one_classifier(
            torch.device("cuda", 0), name, classifier_cfg(configs[name]),
            int(n))
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "step_one.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


def zoo_sites(name, n, hw, classes=1000, dtype="bfloat16", **kw):
    """The :func:`shape_key` Counter of one eval forward in ``dtype`` of
    the registry model ``name`` (an ``EMBEDDING_MODELS`` name too;
    ``repvgg_a0_deploy``: RepVGG-A0's deploy form; a (factory, kwargs)
    pair: ``factory(classes, **kwargs)``; ``kw`` its keyword
    arguments) on ``n`` images of ``hw``, derived on the host from the
    model itself: its modules run on the meta device (no data, no launch)
    with the kernel wrappers the models call replaced by recorders, so
    each site is counted where the model's static routing sends it."""
    import collections

    import torch

    from myconvnet_tpu_torch import models
    from myconvnet_tpu_torch.models import blocks, repvgg, resnet

    sites = collections.Counter()

    def b1(x, a, b, act="relu"):
        sites[shape_key("bn_act", tuple(x.shape), _name(x.dtype), act)] += 1
        return torch.empty_like(x)

    def b4(x, w, a, b, **kw):
        sites[shape_key("conv_fused", (*x.shape, w.shape[-1]))] += 1
        return x.new_empty(*x.shape[:3], w.shape[-1])

    def b5(x, w1, a1, b1_, w3, a3, b3, **kw):
        sites[shape_key("conv_pair", (*x.shape, w1.shape[-1],
                                      w3.shape[-1]))] += 1
        return x.new_empty(*x.shape[:3], w3.shape[-1])

    fakes = [(blocks, "fused_scale_shift_act", b1),
             (blocks, "conv3x3_bn_relu", b4),
             (resnet, "conv1x1_conv3x3_bn_relu", b5)]
    saved = [(m, a, getattr(m, a)) for m, a, _ in fakes]
    try:
        for m, a, f in fakes:
            setattr(m, a, f)
        dtype = getattr(torch, dtype)
        with torch.device("meta"), torch.no_grad():
            if isinstance(name, tuple):   # (factory, its kwargs)
                model = name[0](classes, **name[1])
            elif name == "repvgg_a0_deploy":
                model = repvgg.DEPLOY_FORWARDS["repvgg_a0"](1000)
            elif name in models.EMBEDDING_MODELS:
                model = models.EMBEDDING_MODELS[name](
                    classes, input_hw=tuple(hw), **kw)
            else:
                model = models.get_model(name, classes, input_hw=tuple(hw),
                                         **kw)
            model.to(dtype).eval()(torch.empty(n, *hw, 3, dtype=dtype))
    finally:
        for m, a, f in saved:
            setattr(m, a, f)
    return sites


def zoo_totals(sites):
    """{kernel: launches} of a :func:`zoo_sites` Counter."""
    out = {}
    for key, count in sites.items():
        out[key[0]] = out.get(key[0], 0) + count
    return out


def zoo_paths():
    """(path, model, batch, hw) of each zoo path's eval forward: the six
    recipes at their eval batch and size, the deep ResNets and RepVGG-A0's
    deploy form at the served batch."""
    out = []
    for name, (config, batch, *_) in ZOO_RECIPES.items():
        hw = tuple(classifier_cfg(os.path.join(ROOT, "configs", config))[
            "input_hw"])
        out.append((f"zoo_{name}", name, batch, hw))
    out += [(f"zoo_{name}", name, BATCH, (224, 224)) for name in ZOO_SERVED]
    out.append(("zoo_repvgg_a0_deploy", "repvgg_a0_deploy", BATCH,
                (224, 224)))
    return out


def site_rows(dev, g, path, sites, want):
    """B1, B4 and B5 rows (path ``path``) at every site of a
    :func:`zoo_sites` Counter, each against its plain version, one row a
    shape with its count in one forward; the totals held to ``want``
    ({kernel: launches}) first."""
    import torch

    want = {k: v for k, v in want.items() if v}
    if zoo_totals(sites) != want:
        raise AssertionError(f"{path}: one eval forward's sites "
                             f"{zoo_totals(sites)}, want {want}")
    rows = []
    for key, count in sorted(sites.items(), key=str):
        kernel, *rest = key
        if kernel == "bn_act":
            shape, act = tuple(rest[:4]), rest[5]
            again = _row_again(("bn_act", shape, rest[4], act), path, count,
                               site=f"{path} {act}")
            if again is not None:
                rows.append(again)
                continue
            x = torch.randn(*shape, generator=g, device=dev).to(
                getattr(torch, rest[4]))
            c = shape[-1]
            rows.append(bn_act_row(
                f"{path} {act}", x,
                torch.rand(c, generator=g, device=dev) + 0.5,
                torch.randn(c, generator=g, device=dev) * 0.5, count,
                path, act=act))
            del x
        elif kernel == "conv_fused":
            rows.append(conv_fused_row(tuple(rest), count, path, g))
        else:
            rows.append(conv_pair_row(tuple(rest), count, path, g))
        torch.cuda.empty_cache()
    return rows


def check_zoo_kernels(dev, g):
    """B1, B4 and B5 at every site of the zoo paths' eval forwards
    (:func:`zoo_sites`: MobileNetV2's ReLU6 sites, RepVGG-A0's deploy
    sites, ResNet-101's pairs, ...) against their plain versions
    (:func:`site_rows`); each path's totals held to ZOO_FORWARD first."""
    rows = []
    for path, model, n, hw in zoo_paths():
        rows += site_rows(dev, g, path, zoo_sites(model, n, hw),
                          ZOO_FORWARD[path[len("zoo_"):]])
    return rows


def seg_family_paths():
    """(path, registry model, its kwargs, batch, hw, classes) of each
    seg_family path's eval forward: the two recipes' at SEG_FAMILY_EVAL
    on their crops, DeepLab-Xception's at 513 x 513."""
    from myconvnet_tpu_torch import recipes

    out = []
    for name, (config, hw) in SEG_FAMILY.items():
        cfg = recipes.load_config(os.path.join(ROOT, "configs", config))
        out.append((f"seg_{name}", cfg["model"], cfg["model_kwargs"],
                    SEG_FAMILY_EVAL, hw, cfg["num_classes"]))
    out.append(("seg_deeplab_xception", "deeplab_v3_plus", DEEPLAB_X_KW,
                SEG_FAMILY_EVAL, SEG_HW, 21))
    return out


# each new path's launches of one bf16 eval forward (ROADMAP B); the
# shapes come from the models (``zoo_sites``)
SEG_FAMILY_FORWARD = {"seg_unet": {"conv_fused": 17, "bn_act": 1},
                      "seg_pspnet": {"conv_pair": 6, "conv_fused": 1,
                                     "bn_act": 25},
                      "seg_deeplab_xception": {"conv_fused": 3,
                                               "bn_act": 74}}
ZOO_REST_FORWARD = {"inception_v3": {"conv_fused": 10, "bn_act": 84},
                    "xception65": {"conv_fused": 1, "bn_act": 67},
                    "convnext_tiny": {}, "convnext_small": {},
                    "squeezenet": {"conv_fused": 8, "bn_act": 18},
                    "alexnet": {"conv_fused": 3, "bn_act": 2}}


def check_seg_family_kernels(dev, g):
    """B1, B4 and B5 at every site of the seg_family and zoo_rest paths'
    eval forwards (:func:`site_rows`): U-Net's 512² double convs, PSPNet's
    pairs, pyramid and head, DeepLab-Xception's depthwise BN -> ReLUs, the
    six classifiers' served forwards."""
    rows = []
    for path, model, kw, n, hw, classes in seg_family_paths():
        rows += site_rows(dev, g, path,
                          zoo_sites(model, n, hw, classes, **kw),
                          SEG_FAMILY_FORWARD[path])
    for name, hw in ZOO_REST.items():
        rows += site_rows(dev, g, f"zoo_rest_{name}",
                          zoo_sites(name, BATCH, hw),
                          ZOO_REST_FORWARD[name])
    return rows


def zoo_served(dev, counted, name, hw=(224, 224), run=None):
    """The classifier ``name`` served: seeded JAX-layout weights through
    ``weights.from_jax``, BN folded, bf16, one batch of BATCH rows of
    ``hw`` through ``serving.make_inference_fn`` (the run ``run``); its
    launches by shape against :func:`zoo_sites`, its logits against the
    host's plain path."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import models, serving
    from myconvnet_tpu_torch.core.precision import BF16
    from myconvnet_tpu_torch.weights import random_jax_params

    hw = tuple(hw)
    run = run or f"zoo_{name}_serve"
    model = models.get_model(name, 1000, input_hw=hw)
    params, state = random_jax_params(model, SEED)
    fn = serving.make_inference_fn(model, params, state, device=dev,
                                   policy=BF16)
    x = np.random.RandomState(SEED).standard_normal(
        (BATCH, *hw, 3)).astype(np.float32)
    fn(x)
    card = counted(run, fn, x).cpu().numpy()
    want = zoo_sites(name, BATCH, hw)
    if dict(counted.shapes[run]) != dict(want):
        raise AssertionError(f"{name}: launches by shape "
                             f"{dict(counted.shapes[run])}, want {want}")
    expect_only(counted.runs[run], zoo_totals(want), f"{name} served")
    host = serving.make_inference_fn(models.get_model(
        name, 1000, input_hw=hw), params, state, device="cpu", policy=BF16)
    plain = host(x[:1]).numpy()
    rel = float(np.abs(card[:1] - plain).max() / np.abs(plain).max())
    # a call from the host's rows: CUDA events from an idle device
    ms, _ = events_ms(lambda: fn(x), 5)
    log(f"{name} served (batch {BATCH}, BN folded, bf16): {ms:.2f} ms a "
        f"call; launches by shape as the model's sites "
        f"{zoo_totals(want)}; card vs host plain path max|diff|/max|logit| "
        f"= {rel:.4g} (tol {LOGIT_REL_TOL})")
    if not np.isfinite(card).all() or rel > LOGIT_REL_TOL:
        raise AssertionError(f"{name}: served logits disagree with the "
                             "plain path")
    return dict(ms=ms, logit_rel_err=rel)


def zoo_run(dev):
    """The zoo phase (step 27): each ZOO_RECIPES recipe as written through
    ``train.main`` and ``test.main`` (:func:`classifier_run`), its eval
    forwards' launches held by shape to the model's sites; the deep
    ResNets served; RepVGG-A0's reparameterized artifact exported, served
    and held bit for bit to its in-memory deploy program.  Returns ({run:
    launches}, {run: Counter of launch shapes}, checks)."""
    import shutil

    import torch

    runs, shapes, checks = {}, {}, {}
    for name, (config, batch, accum, steps, split) in ZOO_RECIPES.items():
        path = os.path.join(ROOT, "configs", config)
        cfg = classifier_cfg(path)
        per_step, eval_input = ZOO_INPUT.get(name, ({}, {}))
        hw = tuple(cfg["input_hw"])
        sites = zoo_sites(name, batch, hw)
        recorded = {}
        t0 = time.perf_counter()
        train_c, test_c, run, trainer, _ = classifier_run(
            dev, f"zoo {name}", path,
            [f"accum_steps={accum}", f"synthetic_n={split}"], steps=steps,
            batch=batch, val_every=0, forward=zoo_totals(sites),
            split=split, check_n=4, per_step=per_step,
            eval_input=eval_input, rate_iters=2,
            raw_hw=tuple(cfg.get("raw_hw") or hw), shapes=recorded)
        del trainer
        torch.cuda.empty_cache()
        evals = -(-split // batch)
        for part in ("train", "test"):
            got = {k: v for k, v in recorded[part].items()
                   if k[0] in ("bn_act", "conv_fused", "conv_pair")}
            want = {k: v * evals for k, v in sites.items()}
            if got != want:
                raise AssertionError(f"zoo {name} {part}: launches by shape "
                                     f"{got}, want {want}")
            runs[f"zoo_{name}_{part}"] = (train_c if part == "train"
                                          else test_c)
            shapes[f"zoo_{name}_{part}"] = recorded[part]
        step = run["step"]
        run["seconds"] = time.perf_counter() - t0
        run["batch_as"] = f"{batch} as {accum} x {batch // accum}"
        checks[name] = run
        log(f"zoo {name}: {batch} as {accum} x {batch // accum}, step "
            f"{step['step_ms']:.1f} ms, {step['images_per_sec']:.1f} "
            f"images/s, idle share {step['idle_share']}, peak "
            f"{step['max_memory_allocated_gb']:.2f} GiB; eval launches by "
            f"shape as the model's sites {zoo_totals(sites)} a batch; "
            f"{run['seconds']:.1f}s")
    counted = Counted()
    for name in ZOO_SERVED:
        checks[name] = zoo_served(dev, counted, name)
        torch.cuda.empty_cache()
    root = os.path.join(ROOT, "build", "chip_smoke_zoo_export")
    shutil.rmtree(root, ignore_errors=True)
    try:
        inputs = export_inputs(root)
        for name, case in ZOO_EXPORT.items():
            checks[f"export_{name}"] = export_case(dev, name, counted, root,
                                                   inputs, None, case)
            if not checks[f"export_{name}"]["bit_exact"]:
                raise AssertionError(f"{name}: the artifact's bits differ "
                                     "from the in-memory deploy program's")
            got = dict(counted.shapes[f"export_{name}_artifact"])
            want = dict(zoo_sites("repvgg_a0_deploy", BATCH, (224, 224)))
            if got != want:
                raise AssertionError(f"{name} artifact: launches by shape "
                                     f"{got}, want {want}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs.update(counted.runs)
    shapes.update(counted.shapes)
    return runs, shapes, checks


def seg_family_run(dev):
    """The seg_family phase: for U-Net and PSPNet (SEG_FAMILY) step 1 on
    the card against the host (:func:`step_one_segmenter` at
    SEG_FAMILY_STEP1), the recipe's train step at SEG_FAMILY_BATCH on its
    crops of SEG_RAW frames (:func:`step_rate`), an eval forward of
    SEG_FAMILY_EVAL frames and a segment route's image request at that
    route batch, each held by shape to the model's sites
    (:func:`zoo_sites`), the eval logits against the host's plain path;
    then DeepLabv3+ on Xception-65 at 513 x 513, one eval forward of
    SEG_FAMILY_EVAL held the same way.  Returns ({run: launches}, {run:
    Counter of launch shapes}, checks)."""
    import torch

    from myconvnet_tpu_torch import recipes, serving_http, weights
    from myconvnet_tpu_torch.subsets import voc

    counted = Counted()
    checks = {}
    cpu = torch.device("cpu")
    frames = torch.from_numpy(voc.synthetic_subset(SEG_FAMILY_EVAL, SEG_RAW,
                                                   1)[0])
    with open(_fixture_jpegs()[0], "rb") as f:
        jpeg = f.read()
    for path, model, kw, n, hw, classes in seg_family_paths():
        t0 = time.perf_counter()
        name = path[len("seg_"):]
        what = f"{name} {hw[0]}x{hw[1]}"
        config = SEG_FAMILY.get(name, (VOC_CONFIG,))[0]
        cfg = recipes.load_config(os.path.join(ROOT, "configs", config))
        cfg["model_kwargs"] = dict(cfg["model_kwargs"], **kw)
        sites = zoo_sites(model, n, hw, classes, **kw)
        check = {}
        if name in SEG_FAMILY:
            crop, n1 = SEG_FAMILY_STEP1[name]
            check["step1"] = step_one_segmenter(dev, cfg, n1, hw=crop,
                                                what=name)
            torch.cuda.empty_cache()
        trainer = deeplab_trainer(cfg, dev, hw=hw)
        params, state = weights.random_jax_params(trainer.model, SEED)
        weights.from_jax(trainer.model, params, state)
        if name in SEG_FAMILY:
            check["step"], _ = step_rate(dev, trainer, SEG_FAMILY_BATCH,
                                         SEG_RAW, 3, masks=True, warmup=2)
            log_rate(what, check["step"])
        x = frames.to(dev)
        trainer.eval_step(x)
        run = f"{path}_eval"
        out = counted(run, trainer.eval_step, x)
        if dict(counted.shapes[run]) != dict(sites) \
                or tuple(out.shape) != (n, *hw, classes):
            raise AssertionError(f"{what} eval: launches by shape "
                                 f"{dict(counted.shapes[run])}, want "
                                 f"{dict(sites)}; output {out.shape}")
        expect_only(counted.runs[run], zoo_totals(sites), f"{what} eval")
        check["eval_ms"], _ = events_ms(lambda: trainer.eval_step(x), 3)
        host = deeplab_trainer(cfg, cpu, hw=hw)
        check["host"] = seg_logits_vs_host(what, trainer, host,
                                           frames[:1], dev)
        del host
        if name in SEG_FAMILY:
            p2, s2 = weights.to_jax(trainer.model)
            route = serving_http.build_route(name, "segment", cfg,
                                             params=p2, state=s2, batch=n,
                                             device=dev)
            server = serving_http.ModelServer([route])
            server.predict(name, jpeg, "image/jpeg")
            run = f"{path}_route"
            t1 = time.perf_counter()
            reply = counted(run, server.predict, name, jpeg, "image/jpeg")
            check["route_ms"] = (time.perf_counter() - t1) * 1e3
            _reply_ok("segment", reply, 1, hw)
            got = dict(counted.shapes[run])
            b2 = got.pop(shape_key("normalize_u8", (1, *hw, 3), "float32"),
                         0)
            if got != dict(sites) or b2 != 1:
                raise AssertionError(f"{what} route: launches by shape "
                                     f"{dict(counted.shapes[run])}, want "
                                     f"{dict(sites)} and one normalize_u8")
            expect_only(counted.runs[run],
                        dict(zoo_totals(sites), normalize_u8=1),
                        f"{what} route")
            del route, server
        del trainer
        torch.cuda.empty_cache()
        check["seconds"] = time.perf_counter() - t0
        checks[name] = check
        log(f"{what}: eval forward of {n} {check['eval_ms']:.2f} ms, "
            f"launches by shape as the model's sites {zoo_totals(sites)}"
            + (f"; route request {check['route_ms']:.1f} ms (one image at "
               f"a route batch of {n})" if "route_ms" in check else "")
            + f"; {check['seconds']:.1f}s")
    return counted.runs, counted.shapes, checks


def update_gaps(got, want):
    """[(||got - want|| / ||want||, path)] over the parameters' updates,
    worst first."""
    return sorted((float((got[k] - v).norm() / v.norm().clamp_min(1e-30)),
                   k) for k, v in want.items())[::-1]


def optimizer_steps(dev, name, opt_cfg, steps):
    """``steps`` steps of the CIFAR-100 ResNet-18 recipe with the
    optimizer ``opt_cfg`` from seeded JAX-layout weights on the card;
    before each the host takes the card's whole state (weights, BN
    statistics, the optimizer's state through its JAX layout) and the
    same batch and draws.  Each step is held alone: the loss and every
    parameter's gradient norm (:func:`step_one_verdict`); then the host
    takes the card's gradients as well, and each parameter's update (its
    change in the step) on the card is held to the host's within
    OPT_UPDATE_RTOL of the host's update's norm.  Shampoo's control: on
    each step from its ``start_step`` on, the host's step with the
    preconditioner skipped (its start put past the run) must miss the
    host's update by more than OPT_UPDATE_RTOL, so that the check tells a
    card step without its preconditioner from a sound one."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, weights
    from myconvnet_tpu_torch.data.mix import MixDraws
    from myconvnet_tpu_torch.train.trainer import StepDraws

    cfg = dict(recipes.load_config(CIFAR_CONFIG), optimizer=opt_cfg)
    card, train_set, _ = recipes.build_trainer(cfg, True, device=dev)
    host, _, _ = recipes.build_trainer(cfg, True, device=torch.device("cpu"))
    params, state = weights.random_jax_params(card.model, SEED)
    for t in (card, host):
        weights.from_jax(t.model, params, state)
    xs, ys = train_set.source.get_batch(np.arange(TRAIN_BATCH))
    x, y = torch.from_numpy(xs), torch.from_numpy(ys)
    out = []

    def leaves(t):
        return {path: p for path, p, _ in weights.param_views(t.model)}

    def moved(t, before):
        return {k: p.detach().float().cpu() - before[k]
                for k, p in leaves(t).items()}

    for step in range(steps):
        snapshot = card.state()
        host.load_state(snapshot)
        draws = card.sample(TRAIN_BATCH, INPUT_SHAPE[1:3])
        on_host = StepDraws(draws.boxes.cpu(), draws.flip.cpu(),
                            MixDraws(*(t.cpu() for t in draws.mix)))
        before = {k: p.detach().float().cpu().clone()
                  for k, p in leaves(card).items()}
        loss_card = float(card.loss_and_grads(x.to(dev), y.to(dev),
                                              draws)[0])
        loss_host = float(host.loss_and_grads(x, y, on_host)[0])
        grads = step_one_verdict(f"{name} step {step + 1} gradients", card,
                                 host, loss_card, loss_host)
        mine = leaves(host)
        for k, p in leaves(card).items():
            mine[k].grad = p.grad.detach().cpu().clone()
        skipped = None
        if card.step >= opt_cfg.get("start_step", float("inf")):
            opt = host.optimizer
            start, opt.start_step = opt.start_step, 1 << 30
            try:
                opt.step(host.step)
            finally:
                opt.start_step = start
            skipped = moved(host, before)
            host.load_state(snapshot)     # the gradients stay
        for t in (card, host):
            t.optimizer.step(t.step)
            t.step += 1
        want = moved(host, before)
        gaps = update_gaps(moved(card, before), want)
        record = dict(grads=grads, update_worst=gaps[:5])
        log(f"{name} step {step + 1} updates from the same state and "
            f"gradients, card vs host: {len(gaps)} parameters, worst "
            f"||diff|| / ||host||: " + "; ".join(
                f"{k} {g:.3g}" for g, k in gaps[:3])
            + f" (tol {OPT_UPDATE_RTOL:.3g})")
        if gaps[0][0] > OPT_UPDATE_RTOL:
            raise AssertionError(f"{name} step {step + 1}: the card's "
                                 f"updates disagree: {gaps[:5]}")
        if skipped is not None:
            control = update_gaps(skipped, want)
            record["control_worst"] = control[:5]
            log(f"{name} step {step + 1} control, the host's update "
                "without the preconditioner vs with it: worst " + "; ".join(
                    f"{k} {g:.3g}" for g, k in control[:3]))
            if not control[0][0] > OPT_UPDATE_RTOL:
                raise AssertionError(f"{name} step {step + 1}: skipping the "
                                     "preconditioner moves no update past "
                                     f"{OPT_UPDATE_RTOL}")
        out.append(record)
    del card, host
    torch.cuda.empty_cache()
    return out


def zoo_rest_run(dev):
    """The zoo_rest phase: each ZOO_REST classifier through the ImageNet
    recipe (``--set model=<name>``, bf16, at its input size in one pass)
    built by ``recipes.build_trainer``: the train step's rate at
    ZOO_REST_BATCH, and a served call of BATCH held by shape with its
    logits against the host's (:func:`zoo_served`); then
    ZOO_REST_OPTIMIZERS' steps of the CIFAR-100 ResNet-18 recipe, card
    against host (:func:`optimizer_steps`).  Returns ({run: launches},
    {run: Counter of launch shapes}, checks)."""
    import torch

    from myconvnet_tpu_torch import recipes

    counted = Counted()
    checks = {}
    for name, hw in ZOO_REST.items():
        t0 = time.perf_counter()
        raw = tuple(v * 8 // 7 for v in hw)    # 256 for 224, as the recipe
        cfg = classifier_cfg(CONFIG, [
            f"model={name}", "model_kwargs={}", f"input_hw={list(hw)}",
            f"augment.out_hw={list(hw)}", f"raw_hw={list(raw)}",
            "accum_steps=1", "synthetic_n=8"])
        trainer = recipes.build_trainer(cfg, True, device=dev)[0]
        step, _ = step_rate(dev, trainer, ZOO_REST_BATCH, raw, 3, warmup=2)
        log_rate(f"{name} {hw[0]}x{hw[1]}", step)
        del trainer
        torch.cuda.empty_cache()
        served = zoo_served(dev, counted, name, hw,
                            run=f"zoo_rest_{name}_serve")
        checks[name] = dict(step=step, served=served,
                            seconds=time.perf_counter() - t0)
        log(f"zoo_rest {name}: {checks[name]['seconds']:.1f}s")
        torch.cuda.empty_cache()
    for name, (opt_cfg, steps) in ZOO_REST_OPTIMIZERS.items():
        t0 = time.perf_counter()
        checks[name] = dict(steps=optimizer_steps(dev, name, opt_cfg,
                                                  steps),
                            seconds=time.perf_counter() - t0)
        log(f"zoo_rest {name}: {steps} steps, card against host, "
            f"{checks[name]['seconds']:.1f}s")
    return counted.runs, counted.shapes, checks


# The representation phase: the classification-side tasks' four
# recipes as written, at their own batch and width, seeded synthetic data:
# distillation (SmallNet-32 student, float32; the ResNet-18 teacher's
# checkpoint from a short train.main run of configs/cifar100_resnet18.py
# on CIFAR-10, never random), FixMatch (WRN-28-2, 64 labeled + 448 weak +
# 448 strong views a step, bf16, EMA 0.999), batch-hard triplet (PK 8 x 8,
# SmallNet-16, 64-d, float32) and ArcFace (ResNet-50, 512 at 112², 10,572
# identities, accum_steps=2, bf16).  name -> (config, steps)
REPR_RECIPES = {"distill": ("cifar10_distill_r18_smallnet.py", 2),
                "fixmatch": ("cifar10_fixmatch.py", 2),
                "triplet": ("cifar10_triplet.py", 2),
                "arcface": ("faces_arcface_r50.py", 2)}
# the eval forwards on each path, at its batch (the shapes from the models
# on the meta device, ``zoo_sites``): (registry model, kwargs, batch, hw,
# classes, dtype, launches of one forward as ROADMAP B lists them); the
# distillation teacher's forward runs in every train step
REPR_FORWARDS = {
    "distill": [
        ("resnet18", {}, 128, (32, 32), 10, "float32", {"bn_act": 9}),
        ("smallnet", dict(width=32, dropout_rate=0.0), 128, (32, 32), 10,
         "float32", {"bn_act": 6})],
    "fixmatch": [("wide_resnet", dict(depth=28, width_mult=2), 64, (32, 32),
                  10, "bfloat16", {"conv_fused": 10, "bn_act": 15})],
    "triplet": [("embedding_net", dict(
        backbone="smallnet", embed_dim=64, head="triplet",
        backbone_kwargs=dict(width=16, dropout_rate=0.0)), 64, (32, 32), 10,
        "float32", {"bn_act": 6})],
    "arcface": [("embedding_net", dict(
        backbone="resnet50", embed_dim=512, head="arcface"), 512,
        (112, 112), 10572, "bfloat16", {"conv_pair": 13, "bn_act": 7})]}
# the input kernels: (a train step's, an eval batch's); FixMatch's strong
# view (RandAugment) and ArcFace's crop-resize are plain ops
REPR_INPUT = {"distill": ({"pad_crop_u8": 1}, {"normalize_u8": 1}),
              "fixmatch": ({"pad_crop_u8": 2}, {"normalize_u8": 1}),
              "triplet": ({"pad_crop_u8": 1}, {"normalize_u8": 1}),
              "arcface": ({}, {})}
# step 1 card against host at a batch the host's pass fits in the phase
# (cut from the recipe's but for the triplet): labeled images (FixMatch
# with its mu = 7 unlabeled twice over)
REPR_STEP1 = {"distill": 32, "fixmatch": 4, "triplet": 64, "arcface": 16}
# the ArcFace artifact's batch (export_batch 8) and the embed route's
REPR_SERVED = 8
# a served embedding on the card against the host's plain path, as a
# fraction of max |x|
EMBED_REL_TOL = 0.05


# the representation paths' runs (kernel_by_path): each recipe's
# train.main and test.main, ArcFace's served calls at REPR_SERVED
KERNEL_PATH_RUNS.update({
    **{f"repr_{name}": (f"repr_{name}_train", f"repr_{name}_test")
       for name in REPR_RECIPES},
    "repr_arcface_served": ("repr_arcface_serve", "repr_arcface_artifact",
                            "repr_arcface_memory", "repr_arcface_route_json",
                            "repr_arcface_route_jpeg")})


def forward_sites(entry, batch=None):
    """The :func:`zoo_sites` Counter of one REPR_FORWARDS entry's eval
    forward (at ``batch`` where given), its totals held to ROADMAP B's."""
    model, kw, n, hw, classes, dtype, want = entry
    sites = zoo_sites(model, batch or n, hw, classes, dtype, **kw)
    if zoo_totals(sites) != {k: v for k, v in want.items() if v}:
        raise AssertionError(f"{model}: one eval forward's sites "
                             f"{zoo_totals(sites)}, want {want}")
    return sites


def repr_sites(name, batch=None):
    """The sites of all of REPR_FORWARDS[name]'s forwards together."""
    import collections

    out = collections.Counter()
    for entry in REPR_FORWARDS[name]:
        out.update(forward_sites(entry, batch))
    return out


def check_repr_kernels(dev, g):
    """B1, B4 and B5 at every site of the representation paths' eval
    forwards (:func:`repr_sites`; ArcFace's also at the served batch,
    where B5 meets the 4² map of stage 4), each against its plain
    version (:func:`site_rows`)."""
    rows = []
    for name in REPR_RECIPES:
        rows += site_rows(dev, g, f"repr_{name}", repr_sites(name),
                          zoo_totals(repr_sites(name)))
    served = repr_sites("arcface", REPR_SERVED)
    rows += site_rows(dev, g, "repr_arcface_served", served,
                      zoo_totals(served))
    return rows


def repr_cfg(name, sets=()):
    return classifier_cfg(os.path.join(ROOT, "configs",
                                       REPR_RECIPES[name][0]), sets)


def repr_trainer(name, cfg, dev):
    """The recipe's trainer on ``dev``, as the entry point builds it."""
    from myconvnet_tpu_torch import recipes, recipes_distill, recipes_semisup
    if name == "distill":
        return recipes_distill.build_distill(cfg, True, device=dev)[0]
    if name == "fixmatch":
        return recipes_semisup.build_semisup(cfg, True, device=dev)[0]
    return recipes.build_trainer(cfg, True, device=dev)[0]


def repr_batch(name, cfg, n):
    """Step-1 inputs of ``n`` (labeled) images from the recipe's train
    split: (x, y), a PK batch for the triplet, (x_l, y_l, x_u) for
    FixMatch."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.data.pipeline import pk_batch_indices

    src = recipes.make_sources(cfg, True, splits=("train",))[0]
    if name == "triplet":
        idx = next(pk_batch_indices(src.labels, *cfg["pk"], seed=SEED))
    else:
        idx = np.arange(n)
    x, y = (torch.from_numpy(a) for a in src.get_batch(idx))
    if name != "fixmatch":
        return x, y
    x_u = torch.from_numpy(src.get_batch(np.arange(cfg["mu"] * n))[0])
    return x, y, x_u


def repr_loss(name, trainer, batch, draws):
    """The recipe's step-1 loss with the graph for backward."""
    if name in ("distill", "fixmatch"):
        return trainer.loss(*batch, draws)["loss"]
    return trainer.loss_and_grads(*batch, draws)[0]


def repr_step_one(dev, name, cfg, seed=SEED, n=None):
    """Step 1 at ``n`` images (default REPR_STEP1's) from JAX-layout
    weights seeded with ``seed`` (the teacher's too), the same batch and
    draws on the card and on the host, under the float32 policy (the loss
    and every gradient norm at the float32 bounds) and, for a bf16
    recipe, under bf16 at twice bf16's own reach on the host (W: how far
    the host's bf16 step moves a gradient norm from its float32 one, as
    ``step_one_classifier``); the card's own reach and the worst leaves
    are recorded beside it."""
    import torch

    from myconvnet_tpu_torch import weights

    n = n or REPR_STEP1[name]
    cfg = dict(cfg, batch_size=n, accum_steps=min(cfg.get("accum_steps", 1),
                                                  n // 8 or 1))
    if name == "distill":
        cfg["distill"] = dict(cfg["distill"], allow_random=True)
    precisions = ["f32"] + (["bf16"] if cfg.get("precision") == "bf16"
                            else [])
    runs, seconds, params = {}, {}, None
    for prec in precisions:
        c = dict(cfg, precision=prec)
        card = repr_trainer(name, c, dev)
        host = repr_trainer(name, c, torch.device("cpu"))
        if params is None:
            params, state = weights.random_jax_params(card.model, seed)
            if name == "distill":
                teacher = weights.random_jax_params(card.teacher, seed + 1)
            batch = repr_batch(name, c, n)
            hw = tuple(batch[0].shape[1:3])
            draws = (card.sample(n, c["mu"] * n, hw) if name == "fixmatch"
                     else card.sample(len(batch[0]), hw))
        for where, t, b, d in (("card", card, [v.to(dev) for v in batch],
                                draws),
                               ("host", host, list(batch), to_cpu(draws))):
            weights.from_jax(t.model, params, state)
            if name == "distill":
                weights.from_jax(t.teacher, *teacher)
            t0 = time.perf_counter()
            if name in ("distill", "fixmatch"):
                t.optimizer.zero_grad()
                loss = repr_loss(name, t, b, d)
                loss.backward()
            else:
                loss = repr_loss(name, t, b, d)
            runs[where, prec] = (float(loss.detach()), grad_norms(t))
            seconds[f"{where} {prec}"] = time.perf_counter() - t0
        del card, host
    labeled = ", labeled" if name == "fixmatch" else ""
    what = f"{name} step 1 (batch {n}{labeled}"
    (lc, nc), (lh, nh) = runs["card", "f32"], runs["host", "f32"]
    out = step_one_verdict(
        f"{what}, float32)", nc, nh, lc, lh, f"; seconds {seconds}",
        loss_rtol=STEP1_F32_LOSS_RTOL, grad_rtol=STEP1_F32_GRAD_RTOL,
        grad_atol=STEP1_F32_GRAD_ATOL)
    if "bf16" not in precisions:
        return out
    def own_reach(where):
        b, f = runs[where, "bf16"][1], runs[where, "f32"][1]
        big = max(f.values())
        return max(abs(b[k] - v) / v for k, v in f.items()
                   if v >= STEP1_GRAD_ATOL * big)

    reach, card_reach = own_reach("host"), own_reach("card")
    if reach > STEP1_BF16_MAX_REACH:
        raise AssertionError(f"{name}: bf16 moves the host's gradient norms "
                             f"by {reach:.3g}; a bound of twice that holds "
                             "nothing")
    (lcb, ncb), (lhb, nhb) = runs["card", "bf16"], runs["host", "bf16"]
    worst = [(k, g, r) for g, k, r in norm_gaps(ncb, nhb)[:3]]
    bf16 = step_one_verdict(
        f"{what}, bf16)", ncb, nhb, lcb, lhb,
        f"; bf16's own reach on the host W = {reach:.3g}, on the card "
        f"{card_reach:.3g}; worst leaves (gap, norm of the largest) "
        + ", ".join(f"{k} {g:.3g} {r:.3g}" for k, g, r in worst),
        grad_rtol=max(STEP1_GRAD_RTOL, 2 * reach))
    return dict(out, bf16=dict(bf16, reach=reach, card_reach=card_reach,
                               worst=worst))


def repr_args(dev, name, cfg):
    """A train step's arguments at the recipe's batch, seeded on the card:
    uint8 images and labels (a PK batch for the triplet), FixMatch's
    unlabeled images too."""
    import torch

    batch = cfg["batch_size"]
    hw = tuple(cfg.get("raw_hw") or cfg["augment"]["out_hw"])
    g = torch.Generator(device=dev).manual_seed(SEED)

    def images(n):
        return torch.randint(0, 256, (n, *hw, 3), generator=g, device=dev,
                             dtype=torch.uint8)

    if name == "triplet":
        y = torch.arange(cfg["pk"][0], device=dev).repeat_interleave(
            cfg["pk"][1])
    else:
        y = torch.randint(0, cfg["num_classes"], (batch,), generator=g,
                          device=dev)
    return ((images(batch), y, images(cfg["mu"] * batch))
            if name == "fixmatch" else (images(batch), y))


def repr_launches(name, n_steps, n_evals):
    """The launches by shape and the totals of ``n_steps`` train steps and
    ``n_evals`` eval batches of the recipe ``name``."""
    import collections

    from myconvnet_tpu_torch.ops import kernels

    if name == "distill":   # the teacher's forward in every train step
        teacher, student = REPR_FORWARDS[name]
        teacher, evals = forward_sites(teacher), forward_sites(student)
    else:
        teacher, evals = collections.Counter(), repr_sites(name)
    shapes = collections.Counter()
    for key, c in teacher.items():
        shapes[key] += c * n_steps
    for key, c in evals.items():
        shapes[key] += c * n_evals
    shapes = +shapes    # no zero entries (test.main runs no train step)
    per_step, per_eval = REPR_INPUT[name]
    totals = {k: 0 for k in kernels.WRAPPERS}
    for key, c in shapes.items():
        totals[key[0]] += c
    for k, v in per_step.items():
        totals[k] += v * n_steps
    for k, v in per_eval.items():
        totals[k] += v * n_evals
    return dict(shapes), totals


def repr_recipe_run(dev, name, teacher_dir=None):
    """One recipe through ``train.main`` (REPR_RECIPES' steps, a log line
    and a checkpoint a step, the final validation) and ``test.main`` on
    its checkpoint: each run's launches held by shape and in total to
    REPR_FORWARDS and REPR_INPUT; the metrics finite; step 1 against the
    host; the step's rate.  Returns (runs, shapes, checks, run_dir, what
    ``test.main`` restored)."""
    import collections
    import shutil

    import numpy as np
    import torch

    from myconvnet_tpu_torch import test, train
    from myconvnet_tpu_torch.ops import kernels

    config, steps = REPR_RECIPES[name]
    path = os.path.join(ROOT, "configs", config)
    sets = ["synthetic_n=512"] if name == "arcface" else []
    if name == "distill":
        sets.append(f"distill.ckpt={teacher_dir}")
    cfg = repr_cfg(name, sets)
    run_dir = os.path.join(ROOT, "build", f"chip_smoke_repr_{name}")
    shutil.rmtree(run_dir, ignore_errors=True)
    argv = ["--config", path, "--synthetic", "--device", dev.type,
            *[a for kv in sets for a in ("--set", kv)]]
    eval_batch = cfg.get("eval_batch", cfg["batch_size"])
    n_evals = -(-512 // eval_batch)     # each val split holds 512 images
    runs, shapes = {}, {}
    checks = {"step1": repr_step_one(dev, name, cfg)}

    def counted_run(run, fn, args, n_steps):
        shapes[run] = collections.Counter()
        with launch_shapes(shapes[run]):
            kernels.reset_launch_counts()
            out = fn(args)
            torch.cuda.synchronize()
            runs[run] = kernels.launch_counts()
        want_shapes, totals = repr_launches(name, n_steps, n_evals)
        got = {k: v for k, v in shapes[run].items()
               if k[0] in ("bn_act", "conv_fused", "conv_pair")}
        if got != want_shapes:
            raise AssertionError(f"{name} {run}: launches by shape {got}, "
                                 f"want {want_shapes}")
        check_counts(runs[run], totals, f"{name} {run} ({n_steps} steps, "
                     f"{n_evals} eval batches)")
        return out

    t0 = time.perf_counter()
    out = counted_run(f"repr_{name}_train", train.main,
                      argv + ["--steps", str(steps), "--out", run_dir,
                              "--set", "log_every=1", "--set",
                              "val_every=0"], steps)
    trainer = out.trainer if hasattr(out, "trainer") else out
    seconds = time.perf_counter() - t0
    log_name = {"distill": "distill", "fixmatch": "semisup_fixmatch"}.get(
        name, "train")
    with open(os.path.join(run_dir, f"{log_name}.jsonl")) as f:
        metrics = [r for r in map(json.loads, f) if "loss" in r]
    if len(metrics) != steps or not all(np.isfinite(v) for r in metrics
                                        for k, v in r.items()
                                        if k != "step"):
        raise AssertionError(f"{name}: metrics not all finite: {metrics}")
    score, restored = counted_run(f"repr_{name}_test", test.main,
                                  argv + ["--ckpt", run_dir], 0)
    n = cfg["batch_size"] * (1 + 2 * cfg.get("mu", 0))
    rate, _ = step_rate(dev, trainer, n, None, 3,
                        args=repr_args(dev, name, cfg))
    log_rate(f"{name} ({config})", rate)
    checks.update(train_seconds=seconds, metrics=metrics, test_score=score,
                  step=rate)
    log(f"{name}: train.main {steps} steps in {seconds:.1f}s; first loss "
        f"{metrics[0]['loss']:.4f}, last {metrics[-1]['loss']:.4f}; "
        f"test.main score {score:.4f}; launches by shape as the models' "
        "sites")
    return runs, shapes, checks, run_dir, restored


def embed_served(dev, counted, run_dir, cfg, restored):
    """ArcFace served: ``test --export`` of its checkpoint (an embed
    artifact at REPR_SERVED x 112²), ``serve --artifact --images`` over
    the fixture JPEGs, the artifact against the in-memory program of the
    net ``test.main`` restored (``restored``) on the same rows (bits,
    launches by shape), and an embed route behind the
    HTTP server's codec: a JSON body and a JPEG body (B2 on the card), the
    embeddings unit-norm and against the host's in-memory route within
    EMBED_REL_TOL of max |x|."""
    import glob

    import numpy as np
    import torch

    from myconvnet_tpu_torch import serve, serving, serving_http, test

    config = os.path.join(ROOT, "configs", REPR_RECIPES["arcface"][0])
    art = os.path.join(run_dir, "arcface.pt2")
    argv = ["--config", config, "--synthetic", "--device", dev.type,
            "--set", "synthetic_n=512", "--ckpt", run_dir]
    counted("repr_arcface_export", test.main, argv + ["--export", art])
    expect_only(counted.runs["repr_arcface_export"], {},
                "ArcFace test --export (traced, no launch)")
    meta = serving.artifact_meta(art)
    want = repr_sites("arcface", REPR_SERVED)
    if meta["kind"] != "embed" or meta["ops"] != zoo_totals(want):
        raise AssertionError(f"ArcFace artifact {meta}")
    jpegs = sorted(glob.glob(os.path.join(FIXTURES, "imagenet", "*.jpg")))
    images = os.path.join(run_dir, "images")
    os.makedirs(images, exist_ok=True)
    for p in jpegs[:REPR_SERVED]:
        _link(p, os.path.join(images, os.path.basename(p)))
    served = counted("repr_arcface_serve", serve.main, [
        "--artifact", art, "--images", images, "--config", config,
        "--device", dev.type])
    norms = [float(np.linalg.norm(e)) for _, e in served]
    fn = serving.load_inference(art, dev)
    rows = np.random.RandomState(SEED).standard_normal(
        meta["input_shape"]).astype(np.float32)
    fn(rows)
    got = counted("repr_arcface_artifact", fn, rows)
    mem = serving.make_inference_fn(restored.model, None, None, device=dev,
                                    policy=restored.policy)
    ref = counted("repr_arcface_memory", mem.program,
                  torch.from_numpy(rows).to(dev))
    bit_exact = bool(torch.equal(got, ref))
    for run in ("repr_arcface_artifact", "repr_arcface_memory"):
        if dict(counted.shapes[run]) != dict(want):
            raise AssertionError(f"{run}: launches by shape "
                                 f"{dict(counted.shapes[run])}, want {want}")
    route = serving_http.artifact_route("face", "embed", art, config,
                                        device=dev)
    server = serving_http.ModelServer([route])
    host = serving_http.ModelServer([serving_http.build_route(
        "face", "embed", cfg, ckpt=run_dir, batch=REPR_SERVED,
        device="cpu")])
    x = np.random.RandomState(SEED + 1).rand(
        2, *meta["input_shape"][1:]).astype(np.float32)
    with open(jpegs[0], "rb") as f:
        jpeg = f.read()
    replies = {}
    for body, req, ctype in (
            ("json", json.dumps({"instances": x.tolist()}).encode(),
             "application/json"), ("jpeg", jpeg, "image/jpeg")):
        card = np.asarray(counted(f"repr_arcface_route_{body}",
                                  server.predict, "face", req,
                                  ctype)["embeddings"])
        plain = np.asarray(host.predict("face", req, ctype)["embeddings"])
        rel = float(np.abs(card - plain).max() / np.abs(plain).max())
        unit = float(np.abs(np.linalg.norm(card, axis=-1) - 1).max())
        replies[body] = dict(rows=len(card), rel_err=rel, unit_err=unit)
        if card.shape != plain.shape or rel > EMBED_REL_TOL \
                or unit > 1e-5:
            raise AssertionError(f"embed route {body}: {replies[body]}")
    expect_only(counted.runs["repr_arcface_route_jpeg"],
                {**zoo_totals(want), "normalize_u8": 1},
                "embed route, a JPEG body")
    log(f"ArcFace served: artifact {meta['ops']} ({meta['policy']}), "
        f"{len(served)} images by serve --artifact (norms "
        f"{min(norms):.4f}-{max(norms):.4f}); artifact vs in-memory program "
        f"bit-exact {bit_exact}, launches by shape as the model's sites; "
        f"embed route vs host {replies}")
    if not bit_exact:
        raise AssertionError("ArcFace: the artifact's bits differ from the "
                             "in-memory program's")
    return dict(bit_exact=bit_exact, served=len(served), norms=norms,
                route=replies)


def representation_run(dev):
    """The representation phase: the ResNet-18 teacher's run, then
    each REPR_RECIPES recipe (:func:`repr_recipe_run`), ArcFace served
    (:func:`embed_served`).  Returns ({run: launches}, {run: Counter of
    launch shapes}, checks)."""
    import shutil

    import torch

    from myconvnet_tpu_torch import train

    teacher = os.path.join(ROOT, "build", "chip_smoke_repr_teacher")
    shutil.rmtree(teacher, ignore_errors=True)
    t0 = time.perf_counter()
    train.main(["--config", CIFAR_CONFIG, "--synthetic", "--device",
                dev.type, "--steps", "2", "--val_every", "0", "--out",
                teacher, "--set", "dataset=cifar10", "--set",
                "num_classes=10"])
    log(f"distill teacher: ResNet-18 on CIFAR-10 by train.main, 2 steps, "
        f"{time.perf_counter() - t0:.1f}s")
    runs, shapes, checks = {}, {}, {}
    counted = Counted()
    try:
        for name in REPR_RECIPES:
            torch.cuda.empty_cache()
            r, s, checks[name], run_dir, restored = repr_recipe_run(
                dev, name, teacher)
            runs.update(r)
            shapes.update(s)
            if name == "arcface":
                checks["arcface_served"] = embed_served(
                    dev, counted, run_dir,
                    repr_cfg(name, ["synthetic_n=512"]), restored)
            del restored
            shutil.rmtree(run_dir, ignore_errors=True)
    finally:
        shutil.rmtree(teacher, ignore_errors=True)
    runs.update(counted.runs)
    shapes.update(counted.shapes)
    return runs, shapes, checks


# The depth_detection phase: the monocular-depth recipe and the two
# one-stage detectors through the port's entry points at the recipes'
# widths on synthetic scenes (config, sets, eval batch = the recipe's
# batch, input hw, the artifact's batch = export_batch's default):
DEPTH_CONFIG = os.path.join(ROOT, "configs", "nyu_depth_unet.py")
SSD_CONFIG = os.path.join(ROOT, "configs", "voc_ssd300.py")
RETINA_CONFIG = os.path.join(ROOT, "configs", "voc_retinanet.py")
DET_FAMILIES = {"depth": (DEPTH_CONFIG, ["synthetic_n=64"], 64, (224, 288),
                          4),
                "ssd300": (SSD_CONFIG, [], 32, (300, 300), 8),
                "retinanet": (RETINA_CONFIG, [], 16, (512, 512), 8)}
# one bf16 eval forward's launches (ROADMAP B), the shapes from the models
# (``zoo_sites``): the depth net's encoder as ResNet-18's and its decoder's
# ten 3x3 convs through B4; SSD300's trunk through B4, its first conv, fc6,
# fc7 and extras through B1; RetinaNet's ResNet-50 and its heads' 40
# relu(conv + bias) through B4
DET_FORWARD = {"depth": {"conv_fused": 15, "bn_act": 4},
               "ssd300": {"conv_fused": 12, "bn_act": 11},
               "retinanet": {"conv_pair": 13, "bn_act": 7,
                             "conv_fused": 40}}
# step 1 card against host at this batch, float32 with TF32 off (its
# host halves run in a background thread beside the phase's card work)
DET_STEP1 = 2
# the depth route on the card against the host's plain path: depth within
# DEPTH_REL_TOL of the largest
DEPTH_REL_TOL = 0.05
# the paths' runs at the eval batch (the rows' shapes): train.main's
# validations and test.main
KERNEL_PATH_RUNS.update({
    f"det_{name}": (f"det_{name}_train", f"det_{name}_test")
    for name in DET_FAMILIES})


def det_sites(name, n=None):
    """The :func:`zoo_sites` Counter of one eval forward of family
    ``name`` at batch ``n`` (its eval batch by default), held to
    DET_FORWARD."""
    from myconvnet_tpu_torch import recipes
    from myconvnet_tpu_torch.models.depth import DEPTH_MODELS

    config, sets, batch, hw, _ = DET_FAMILIES[name]
    cfg = recipes.apply_overrides(recipes.load_config(config), sets)
    if name == "depth":
        kw, build = recipes.depth_model_kwargs(cfg), \
            DEPTH_MODELS[cfg["model"]]
    else:
        from myconvnet_tpu_torch import models
        kw, build = dict(cfg.get("model_kwargs", {})), \
            models.DETECTORS[cfg["model"]]
    sites = zoo_sites((build, kw), n or batch, hw,
                      cfg.get("num_classes", 0))
    if zoo_totals(sites) != DET_FORWARD[name]:
        raise AssertionError(f"{name}: one eval forward's sites "
                             f"{zoo_totals(sites)}, want {DET_FORWARD[name]}")
    return sites


def check_det_kernels(dev, g):
    """B1, B4 and B5 at every site of the depth and detection eval
    forwards (:func:`det_sites`: the depth decoder's 224 x 288 maps,
    RetinaNet's head levels 64² to 4² and its 128² stage-1 pairs), each
    against its plain version beside cuDNN's (:func:`site_rows`), and B2
    at each eval batch's input (:func:`gan_input_row`)."""
    from myconvnet_tpu_torch.data.augment import IMAGENET_MEAN, \
        IMAGENET_STD

    rows = []
    for name, (_, _, batch, hw, _) in DET_FAMILIES.items():
        rows += site_rows(dev, g, f"det_{name}", det_sites(name),
                          DET_FORWARD[name])
        # B2 on an eval batch: x / 255 for depth, the recipe's ImageNet
        # statistics for the detectors
        stats = ((0.0,) * 3, (1.0,) * 3) if name == "depth" \
            else (IMAGENET_MEAN, IMAGENET_STD)
        rows.append(gan_input_row(f"det_{name}_input", (batch, *hw, 3), g,
                                  *stats))
    return rows


def _tf32_off():
    """True float32 convolutions and matmuls inside the block."""
    import torch

    @contextlib.contextmanager
    def block():
        before = (torch.backends.cudnn.allow_tf32,
                  torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = before
    return block()


def _on(obj, dev):
    """Tensors of a draw (tuples, NamedTuples) on ``dev``."""
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.to(dev)
    if isinstance(obj, tuple):
        items = [_on(v, dev) for v in obj]
        return type(obj)(*items) if hasattr(obj, "_fields") \
            else tuple(items)
    return obj


def det_step_half(dev, name, cfg):
    """(loss, {path: gradient norm}) of step 1 of the family's recipe on
    ``dev`` under float32 (TF32 off on the card) at batch DET_STEP1: the
    seeded JAX-layout weights, the split's first images and draws made on
    the host from SEED, so that the card's half and the host's take the
    same ones (:func:`det_step_one` holds them)."""
    import numpy as np
    import torch

    from myconvnet_tpu_torch import recipes, recipes_detection, weights
    from myconvnet_tpu_torch.train.detection import sample_draws
    from myconvnet_tpu_torch.train.trainer import StepDraws

    n = DET_STEP1
    # the splits rendered at the batch's size (the port's synthetic_n)
    cfg = dict(cfg, precision="f32", synthetic_n=n)
    g = torch.Generator().manual_seed(SEED)
    if name == "depth":
        net, train_set, _ = recipes.build_depth(cfg, True, device=dev)
        net.build(recipes.optimizer_factory(cfg["optimizer"]))
        trainer = net.trainer
        draws = StepDraws(None, None, None, recipe=_on(
            trainer.input_fns.sample(g, n), dev))
    else:
        trainer, train_set, _ = recipes_detection.build_detector(
            cfg, True, device=dev)
        draws = _on(sample_draws(g, n, trainer.augment), dev)
    weights.from_jax(trainer.model,
                     *weights.random_jax_params(trainer.model, SEED))
    batch = [torch.from_numpy(np.asarray(a)).to(dev) for a in
             train_set.source.get_batch(np.arange(n))]
    with _tf32_off() if dev.type == "cuda" else contextlib.nullcontext():
        if name == "depth":
            loss, _, _ = trainer.loss_and_grads(*batch, draws)
        else:
            trainer.optimizer.zero_grad()
            loss, _ = trainer.loss(*batch, draws)
            loss.backward()
    return float(loss.detach()), grad_norms(trainer)


def det_step_one(name, card, host):
    """Hold the card's step 1 (:func:`det_step_half`) against the host's
    within :func:`step_one_verdict`'s own bounds (STEP1_LOSS_RTOL,
    STEP1_GRAD_*): SSD's hard-negative mining ranks thousands of anchors
    by float32 cross-entropies the two devices sum apart, so a negative
    near the cut may be mined on one and not the other."""
    return step_one_verdict(
        f"{name} step 1 (float32, batch {DET_STEP1})", card[1], host[1],
        card[0], host[0])


def _det_frames(name, root):
    """``serve --artifact``'s inputs: the four VOC fixture JPEGs."""
    d = os.path.join(root, "frames")
    voc = os.path.join(FIXTURES, "voc", "JPEGImages")
    for f in sorted(os.listdir(voc)):
        _link(os.path.join(voc, f), os.path.join(d, f))
    return d


def det_family_run(dev, name, counted, root, host_step):
    """One family of the depth_detection phase: step 1 on the card against
    the host's (``host_step``, a future of :func:`det_step_half` on the
    host); ``train.main`` 2 steps at the recipe's batch with a validation
    at step 2 (AbsRel or val_mAP finite); ``test.main`` on the checkpoint
    (depth with ``--save_preds``: the 16-bit files equal the eval
    forward's depth x 1000, clipped), its eval forwards held by shape to
    the model's sites, B2 once each; for the detectors the blocked NMS's
    host syncs an eval batch and the post-process on the card against the
    host on the same logits; ``test --export``, ``serve --artifact`` (one
    device call, held), the artifact bit for bit against the in-memory
    program built from the same checkpoint, launch by launch; a route's
    JPEG request (B2 once, then one device call); the depth route
    against the host's within DEPTH_REL_TOL, the detect artifact route's
    detections against the in-memory route's.  Returns (the record, the
    trained trainer and a batch of its step's arguments, for
    :func:`det_rates`)."""
    import shutil

    import numpy as np
    import torch
    from PIL import Image

    from myconvnet_tpu_torch import (recipes, recipes_detection, serve,
                                     serving, serving_http, test, train)
    from myconvnet_tpu_torch.ops import boxes
    from myconvnet_tpu_torch.subsets import depth as depth_mod
    from myconvnet_tpu_torch.subsets import voc
    from myconvnet_tpu_torch.train.detection import (make_postprocess,
                                                     preprocess_batch)

    config, sets, batch, hw, art_batch = DET_FAMILIES[name]
    cfg = recipes.apply_overrides(recipes.load_config(config), sets)
    kind = "depth" if name == "depth" else "detect"
    d = os.path.join(root, name)
    out_dir = os.path.join(d, "run")
    argv = ["--config", config, "--synthetic", "--device", dev.type,
            *[a for kv in sets for a in ("--set", kv)]]
    check, secs = {}, {}
    t0 = time.perf_counter()

    def lap(what, since):
        secs[what] = time.perf_counter() - since
        return time.perf_counter()

    card = det_step_half(dev, name, cfg)
    torch.cuda.empty_cache()
    t1 = lap("step1_card", t0)
    trained = counted(f"det_{name}_train", train.main, argv + [
        "--steps", "2", "--val_every", "2", "--set", "log_every=1000",
        "--out", out_dir])
    t1 = lap("train", t1)
    # B2 once a step; two validations (at step 2 and the final one), each
    # over the 64-image val split at the recipe's batch
    evals = 2 * (64 // batch)
    expect_only(counted.runs[f"det_{name}_train"],
                {**{k: evals * v for k, v in DET_FORWARD[name].items()},
                 "normalize_u8": 2 + evals},
                f"{name} train.main, 2 steps and {evals} eval forwards")
    log_name = "train.jsonl" if kind == "depth" else "detection.jsonl"
    with open(os.path.join(out_dir, log_name)) as f:
        rows = [json.loads(line) for line in f]
    val_key = "val_depth" if kind == "depth" else "val_mAP"
    vals = [r[val_key] for r in rows if val_key in r]
    if not vals or not all(np.isfinite(vals)):
        raise AssertionError(f"{name}: validation scores {vals}")
    check[val_key] = vals
    # the train step's rate is timed after the phase's host work
    # (det_rates) on the trained trainer and a seeded batch
    src = trained.trainer if kind == "depth" else trained
    if kind == "depth":
        xs, ys = depth_mod.synthetic_depth_scenes(batch, hw, seed=SEED)
        args = (torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev))
    else:
        xs, bs, ls = voc.synthetic_detection_subset(batch, hw, SEED, 8)
        args = tuple(torch.from_numpy(a).to(dev) for a in (xs, bs, ls))
    # test.main on the checkpoint: every eval forward held by shape (the
    # val split is 64 images: depth one batch, scored and then predicted
    # for --save_preds; the detectors 64 / batch)
    preds = os.path.join(d, "preds")
    extra = ["--save_preds", preds] if kind == "depth" else []
    boxes.reset_sync_count()
    score, restored = counted(f"det_{name}_test", test.main,
                              argv + ["--ckpt", out_dir, *extra])
    forwards = 2 if kind == "depth" else 64 // batch
    if kind == "detect":
        check["nms_syncs_an_eval_batch"] = boxes.sync_count() / forwards
    t1 = lap("test", t1)
    check["test_score"] = score
    if not np.isfinite(score):
        raise AssertionError(f"{name}: test.main scored {score}")
    sites = det_sites(name)
    b2 = shape_key("normalize_u8", (batch, *hw, 3), "float32")
    want = {k: forwards * v for k, v in sites.items()}
    want[b2] = forwards
    if dict(counted.shapes[f"det_{name}_test"]) != want:
        raise AssertionError(f"{name} test.main: launches by shape "
                             f"{dict(counted.shapes[f'det_{name}_test'])}, "
                             f"want {want}")
    expect_only(counted.runs[f"det_{name}_test"],
                {**{k: forwards * v for k, v in zoo_totals(sites).items()},
                 "normalize_u8": forwards},
                f"{name} test.main, {forwards} eval forwards")
    if kind == "depth":
        # the val split's first frame (split seed 1, as test.main renders
        # it) in its eval batch
        with cudnn_deterministic():
            val = depth_mod.synthetic_depth_scenes(batch, hw, seed=1)[0]
            depth = restored.predict(val, batch_size=batch)[0, ..., 0]
        mm = np.asarray(Image.open(os.path.join(preds, "00000_depth16.png")))
        check["save_preds_equal"] = bool(np.array_equal(
            mm, np.clip(depth * 1000.0, 0, 65535).astype(np.uint16)))
        if not check["save_preds_equal"]:
            raise AssertionError("depth: --save_preds' 16-bit file differs "
                                 "from the forward's depth")
    else:
        # the post-process alone, card against host, on the same logits
        cls, loc = restored.forward_eval(preprocess_batch(
            args[0], restored.mean, restored.std))
        chain = recipes_detection.detector_chain(cfg)
        got = restored.postprocess(cls, loc)
        host = make_postprocess(torch.from_numpy(chain.anchors),
                                cfg["num_classes"], **chain.post_kwargs)(
            cls.cpu(), loc.cpu())
        same = [torch.equal(a.cpu(), b) for a, b in zip(got, host)]
        box_diff = float((got[0].cpu() - host[0]).abs().max())
        check["post_card_vs_host"] = dict(
            indices_labels_valid_equal=same[2] and same[3],
            boxes_equal=same[0], scores_equal=same[1],
            box_max_abs_diff=box_diff, valid=int(host[3].sum()))
        if not (same[2] and same[3] and box_diff <= 1e-6):
            raise AssertionError(f"{name}: the post-process on the card "
                                 f"differs from the host's: "
                                 f"{check['post_card_vs_host']}")
        del cls, loc, got
    del restored
    t1 = lap("eval_checks", t1)
    # the artifact: test --export (traced with fake tensors), serve
    # --artifact (one device call), the artifact bit for bit against the
    # in-memory program from the same checkpoint
    art = os.path.join(d, f"{name}.pt2")
    counted(f"det_{name}_export", test.main, argv + ["--ckpt", out_dir,
                                                     "--export", art])
    expect_only(counted.runs[f"det_{name}_export"], {},
                f"{name}: test --export (traced with fake tensors)")
    t1 = lap("export", t1)
    art_sites = det_sites(name, art_batch)
    frames = _det_frames(name, d)
    served = counted(f"det_{name}_serve", serve.main, [
        "--artifact", art, f"--{kind}", "--images", frames, "--device",
        dev.type, *(["--out", os.path.join(d, "out")] if kind == "depth"
                    else ["--config", config])])
    expect_only(counted.runs[f"det_{name}_serve"], zoo_totals(art_sites),
                f"{name}: serve --artifact, one device call")
    if len(served) != 4:
        raise AssertionError(f"{name}: serve --artifact gave {len(served)} "
                             "results for 4 images")
    t1 = lap("serve", t1)
    fn = serving.load_inference(art)
    route = serving_http.build_route(name, kind, cfg, ckpt=out_dir,
                                     batch=art_batch, device=dev)
    rows_in = torch.from_numpy(np.random.RandomState(SEED).rand(
        art_batch, *hw, 3).astype(np.float32)).to(dev)
    with cudnn_deterministic():
        a = _outputs(counted(f"det_{name}_artifact", fn, rows_in))
        m = _outputs(counted(f"det_{name}_memory", route.fn, rows_in))
    check["artifact_bit_exact"] = all(torch.equal(u, v) for u, v in
                                      zip(a, m))
    for part in ("artifact", "memory"):
        expect_only(counted.runs[f"det_{name}_{part}"],
                    zoo_totals(art_sites), f"{name}: the {part} program")
    if not check["artifact_bit_exact"] \
            or dict(counted.shapes[f"det_{name}_artifact"]) != art_sites \
            or dict(counted.shapes[f"det_{name}_memory"]) != art_sites:
        raise AssertionError(f"{name}: the artifact differs from its "
                             "in-memory program (or its launches by shape)")
    check["artifact_ops"] = serving.artifact_meta(art)["ops"]
    t1 = lap("artifact_vs_memory", t1)
    # the route: a fixture JPEG (B2 once at the route's size), then one
    # device call
    with open(sorted(os.path.join(frames, f)
                     for f in os.listdir(frames))[0], "rb") as f:
        body = f.read()
    server = serving_http.ModelServer([route])
    reply = counted(f"det_{name}_route", server.predict, name, body,
                    "image/jpeg")
    expect_only(counted.runs[f"det_{name}_route"],
                dict(zoo_totals(art_sites), normalize_u8=1),
                f"{name} route, a JPEG body")
    if kind == "depth":
        host_route = serving_http.build_route(
            name, kind, cfg, ckpt=out_dir, batch=1,
            device=torch.device("cpu"))
        one = rows_in[:1]
        card_d = route.fn(one).float().cpu()
        host_d = host_route.fn(one.cpu()).float()
        gap = float((card_d - host_d).abs().max() / host_d.abs().max())
        check["route_vs_host_rel"] = gap
        if not (gap <= DEPTH_REL_TOL and len(reply["depths"]) == 1):
            raise AssertionError(f"depth route: card vs host {gap:.3g} "
                                 f"(tol {DEPTH_REL_TOL})")
    else:
        # the artifact route's codec over the artifact loaded above
        art_route = serving_http.Route(
            name, kind, fn, tuple(fn.input_shapes[0]),
            mean=np.zeros(3, np.float32), std=np.ones(3, np.float32),
            device=dev, class_names=route.class_names, artifact=art,
            threshold=0.0)
        body_rows = json.dumps({"instances": rows_in[:2].cpu().tolist()}
                               ).encode()
        with cudnn_deterministic():
            r1 = serving_http.ModelServer([art_route]).predict(
                name, body_rows, threshold=0.0)
            r2 = serving_http.ModelServer([route]).predict(
                name, body_rows, threshold=0.0)
        check["route_detections"] = [len(r) for r in r1["detections"]]
        if r1 != r2 or len(reply["detections"]) != 1:
            raise AssertionError(f"{name}: the artifact route's detections "
                                 "differ from the in-memory route's")
    del route, fn, server
    shutil.rmtree(d, ignore_errors=True)
    torch.cuda.empty_cache()
    t1 = lap("route", t1)
    check["step1"] = det_step_one(name, card, host_step.result())
    check["seconds"] = secs
    log(f"{name} {hw[0]}x{hw[1]}: step 1 card vs host ok; train.main 2 "
        f"steps ({val_key} {vals}); test.main {score:.4f}, {forwards} eval "
        f"forwards held by shape as the model's sites {zoo_totals(sites)} "
        f"+ B2 1 each"
        + (f", NMS host syncs {check['nms_syncs_an_eval_batch']:g} a batch"
           if kind == "detect" else "")
        + f"; artifact bit for bit against its program "
        f"{check['artifact_bit_exact']} ({check['artifact_ops']}); "
        + ", ".join(f"{k} {v:.1f}s" for k, v in secs.items()))
    return check, src, args


def det_rates(dev, name, trainer, args):
    """The train step's rate at the recipe's batch (:func:`step_rate`)
    and one eval forward's CUDA-event ms, on the trained trainer."""
    import torch

    from myconvnet_tpu_torch.train.detection import preprocess_batch

    _, _, batch, hw, _ = DET_FAMILIES[name]
    out = {}
    out["step"], _ = step_rate(dev, trainer, batch, hw, 3, args=args)
    log_rate(f"{name} {hw[0]}x{hw[1]}", out["step"])
    if name == "depth":
        x = args[0]
        forward = trainer.eval_step
    else:
        x = preprocess_batch(args[0], trainer.mean, trainer.std)
        forward = trainer.forward_eval
    forward(x)
    out["eval_ms"], _ = events_ms(lambda: forward(x), 3)
    del x
    torch.cuda.empty_cache()
    return out


def depth_detection_run(dev):
    """The depth_detection phase: the host's halves of the three step-1
    checks in a background thread (host work only: the card's flags and
    counts are the main thread's), each DET_FAMILIES family through
    :func:`det_family_run`, then each family's step rate alone
    (:func:`det_rates`).  Returns ({run: launches}, {run: Counter of
    launch shapes}, checks)."""
    import shutil

    import torch

    from myconvnet_tpu_torch import recipes

    root = os.path.join(ROOT, "build", "chip_smoke_det")
    shutil.rmtree(root, ignore_errors=True)
    counted = Counted()
    checks, keep = {}, {}
    cpu = torch.device("cpu")
    cfgs = {name: recipes.apply_overrides(recipes.load_config(config), sets)
            for name, (config, sets, *_) in DET_FAMILIES.items()}
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            hosts = {name: pool.submit(det_step_half, cpu, name, cfgs[name])
                     for name in DET_FAMILIES}
            for name in DET_FAMILIES:
                checks[name], *keep[name] = det_family_run(
                    dev, name, counted, root, hosts[name])
        for name, (trainer, args) in keep.items():
            checks[name].update(det_rates(dev, name, trainer, args))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counted.runs, counted.shapes, checks


def phase(name, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f}s")
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from myconvnet_tpu_torch.core.precision import FULL, \
            apply_backend_flags
        from myconvnet_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not here ({e}); run from "
              "a checkout of the repo", file=sys.stderr)
        return 1
    for path in (CONFIG, CIFAR_CONFIG, VIT_CONFIG, PWC_CONFIG,
                 FLOWNET_CONFIG, VGG_CONFIG, DENSENET_CONFIG, VOC_CONFIG,
                 DCGAN_CONFIG, PIX2PIX_CONFIG, *SMALLNET_CONFIGS.values(),
                 SNGAN_CONFIG, FIXTURES, SWIN_CONFIG, MAE_CONFIG,
                 SIMCLR_CIFAR_CONFIG, SIMCLR_R50_CONFIG, MAE_CIFAR_CONFIG,
                 DEPTH_CONFIG, SSD_CONFIG, RETINA_CONFIG,
                 *(os.path.join(ROOT, "configs", c)
                   for c, *_ in (*ZOO_RECIPES.values(),
                                 *SEG_FAMILY.values(),
                                 *REPR_RECIPES.values()))):
        if not os.path.exists(path):
            print(f"chip_smoke: {path} is missing", file=sys.stderr)
            return 1

    dev = torch.device("cuda", 0)
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"])
    log(card)
    import shutil
    shutil.rmtree(KEPT, ignore_errors=True)   # runs of an earlier call
    nvcc = run([_build.nvcc_path(), "--version"]).splitlines()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{nvcc[-1] if nvcc else 'nvcc ?'}")
    # plain versions are the float32 references: true float32 on the card
    apply_backend_flags(FULL)

    # the host library (g++) and the file phases this machine can run,
    # decided before any phase
    from myconvnet_tpu_torch.data import native_loader
    env, plan, io_note = io_environment()
    t0 = time.perf_counter()
    host_lib = native_loader.backend()
    log(f"host library built: {host_lib} in "
        f"{time.perf_counter() - t0:.1f}s")
    if host_lib["built"] is None or host_lib["jpeg"] != env["jpeglib.h"] \
            or host_lib["png"] != env["png.h"]:
        raise AssertionError(f"host library {host_lib} for {env}")

    # the library compiles in the background while the work that launches
    # none of its kernels runs (module docstring, step 2)
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        built = pool.submit(_build.build)
        swin_train, swin_test, swin_checks = phase("swin_t", swin_run, dev)
        torch.cuda.empty_cache()
        step1 = phase("step 1 of ResNet-50, VGG-16, DenseNet-121",
                      classifier_step_ones, dev)
        torch.cuda.empty_cache()
        if _build.library.cache_info().currsize:
            raise AssertionError("the work beside the build loaded the "
                                 "kernel library")
        beside = time.perf_counter() - t0
        lib_path, compile_s = built.result()
    _build.library()
    log(f"kernels built: {lib_path.relative_to(ROOT)} compile "
        f"{compile_s:.1f}s beside {beside:.1f}s of phases, ready "
        f"{time.perf_counter() - t0:.1f}s after the build began")

    summary, details = phase("kernel rows", check_kernels, dev, plan)
    pair_plans, plans_ok = phase(
        "conv_pair plans", sweep_conv_pair_plans, dev,
        torch.Generator(device=dev).manual_seed(SEED))
    summary["conv_pair"]["ok"] &= plans_ok
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    counts, calls, checks = phase("serving", serve_and_check, dev)
    train_counts, eval_counts, checks["cifar"] = phase(
        "CIFAR-100 ResNet-18", train_and_check, dev)
    torch.cuda.empty_cache()
    checks["policies_vs_host"] = phase("policies vs host",
                                       check_policies_against_host, dev)
    vit_train, vit_test, checks["vit"] = phase("ViT-B/16",
                                               vit_train_and_check, dev)
    torch.cuda.empty_cache()
    policy_runs, checks["vit_policies"] = phase("ViT policies",
                                                vit_policy_runs, dev)
    checks["augment_rate"] = phase("augment rates", augment_rates, dev)
    torch.cuda.empty_cache()
    pwc_train, pwc_test, checks["pwcnet"] = phase(
        "PWC-Net", pwc_train_and_check, dev)
    torch.cuda.empty_cache()
    flownetc_counts, checks["flownetc"] = phase("FlowNetC", flownetc_run,
                                                dev)
    torch.cuda.empty_cache()
    r50_train, r50_test, checks["resnet50"] = phase(
        "ResNet-50 training", resnet50_train_and_check, dev,
        step1["resnet50"])
    torch.cuda.empty_cache()
    smallnet_counts, checks["smallnet"] = phase("SmallNet", smallnet_runs,
                                                dev)
    big = {}
    for name in BIG_RUNS:
        torch.cuda.empty_cache()
        *big[name], checks[name] = phase(name, big_classifier_run, dev,
                                         name, step1[name])
    torch.cuda.empty_cache()
    seg_runs, seg_shapes, checks["deeplab"] = phase("DeepLabv3+",
                                                    deeplab_run, dev)
    torch.cuda.empty_cache()
    gan_runs, gan_shapes, checks["gan"] = phase("GAN", gan_run, dev)
    torch.cuda.empty_cache()
    api_runs, api_shapes, checks["convnet_api"] = phase(
        "ConvNet API", convnet_api_run, dev, checks["resnet50"]["step"])
    torch.cuda.empty_cache()
    file_runs, file_shapes, checks["files"] = phase(
        "image files", files_run, dev, plan, checks["resnet50"], card)
    checks["io_environment"] = dict(env, plan=plan, host_library=host_lib)
    torch.cuda.empty_cache()
    route_runs, route_shapes, checks["routes"] = phase("routes", routes_run,
                                                       dev)
    torch.cuda.empty_cache()
    sngan_runs, sngan_shapes, checks["sngan_fid"] = phase(
        "sngan_fid", sngan_fid_run, dev, checks["cifar"]["ckpt_dir"], card)
    torch.cuda.empty_cache()
    export_runs, export_shapes, checks["export"] = phase("export",
                                                         export_run, dev)
    checks["swin_t"] = swin_checks
    torch.cuda.empty_cache()
    mae_train, mae_test, mae_shapes, checks["mae_b16"] = phase(
        "mae_b16", mae_run, dev)
    checks["mae_b16"]["launches_by_shape"] = {
        run: {" ".join(map(str, k)): v for k, v in sorted(counter.items())}
        for run, counter in mae_shapes.items()}
    torch.cuda.empty_cache()
    mae_cifar_train, mae_cifar_test, checks["mae_cifar"] = phase(
        "mae_cifar", mae_cifar_run, dev)
    torch.cuda.empty_cache()
    simclr_runs, simclr_shapes, checks["simclr"] = phase("simclr",
                                                         simclr_run, dev)
    torch.cuda.empty_cache()
    zoo_runs, zoo_shapes, checks["zoo"] = phase("zoo", zoo_run, dev)
    torch.cuda.empty_cache()
    seg_runs2, seg_shapes2, checks["seg_family"] = phase(
        "seg_family", seg_family_run, dev)
    torch.cuda.empty_cache()
    rest_runs, rest_shapes, checks["zoo_rest"] = phase(
        "zoo_rest", zoo_rest_run, dev)
    torch.cuda.empty_cache()
    repr_runs, repr_shapes, checks["representation"] = phase(
        "representation", representation_run, dev)
    torch.cuda.empty_cache()
    det_runs, det_shapes, checks["depth_detection"] = phase(
        "depth_detection", depth_detection_run, dev)
    runs = {"serve": counts, "train": train_counts, "test": eval_counts,
            "vit_train": vit_train, "vit_test": vit_test,
            **{f"vit_train_{k}": v for k, v in policy_runs.items()},
            "pwc_train": pwc_train, "pwc_test": pwc_test,
            "flownetc_train": flownetc_counts,
            "resnet50_train": r50_train, "resnet50_test": r50_test,
            **{f"smallnet_{k.replace(' ', '_')}_{part}": c
               for k, pair in smallnet_counts.items()
               for part, c in zip(("train", "test"), pair)},
            **{f"{k}_{part}": c for k, pair in big.items()
               for part, c in zip(("train", "test"), pair)},
            **seg_runs, **gan_runs, **api_runs, **file_runs,
            **route_runs, **sngan_runs, **export_runs,
            "swin_t_train": swin_train, "swin_t_test": swin_test,
            "mae_b16_train": mae_train, "mae_b16_test": mae_test,
            "mae_cifar_train": mae_cifar_train,
            "mae_cifar_test": mae_cifar_test, **simclr_runs, **zoo_runs,
            **seg_runs2, **rest_runs, **repr_runs, **det_runs}
    launches = {name: sum(c[name] for c in runs.values())
                for name in SOURCES}
    in_forward = checks["bn_act_in_forward_ms"]
    for r, ms in zip([r for r in details if r["kernel"] == "bn_act"
                      and r["site"] in dict(ACT_SITES)], in_forward):
        r["in_forward_ms"] = ms
    summary["bn_act"]["in_forward_ms"] = sum(in_forward)

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         **{k: summary[name][k] for k in (
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         **({"by_path": correlation_by_path(name, details, runs)}
            if name in CORR else {}),
         **({"by_path": flash_by_path(name, details, runs)}
            if name in FLASH else {}),
         **({"by_path": kernel_by_path(name, details, runs,
                                       {**seg_shapes, **gan_shapes,
                                        **api_shapes, **file_shapes,
                                        **route_shapes, **sngan_shapes,
                                        **export_shapes, **simclr_shapes,
                                        **zoo_shapes, **seg_shapes2,
                                        **rest_shapes, **repr_shapes,
                                        **det_shapes})}
            if name in ("conv_pair", "bn_act", "conv_fused") else {}),
         **({"in_forward_ms": summary[name]["in_forward_ms"]}
            if name == "bn_act" else {})}
        for name in SOURCES]}
    bad = [n for n, s in summary.items() if not s["ok"]]
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "kernels": record["kernels"], "per_shape": details,
                   "conv_pair_plans": pair_plans,
                   "device_calls": calls, "launches": runs,
                   "checks": checks, "failed": bad}, f, indent=1)
    if bad:
        raise AssertionError(f"kernels outside tolerance: {bad}")
    log(f"file phases: {io_note or 'all ran, the JPEG decode native'}")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if len(sys.argv) == 3 and sys.argv[1] == "--time-kernels":
            print(json.dumps(time_tree_kernels(sys.argv[2])), flush=True)
            code = 0
        elif len(sys.argv) == 3 and sys.argv[1] == "--compare":
            code = compare_trees(sys.argv[2])
        elif len(sys.argv) >= 2 and sys.argv[1] == "--step-one":
            code = step_one_only(sys.argv[2:])
        elif len(sys.argv) == 2 and sys.argv[1] == "--sweep-inputs":
            sys.path.insert(0, ROOT)
            code = 0 if sweep_input_plans() else 1
        else:
            code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
