#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hygrid_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernel-times   # phases 1-2, then kernel_times()

Phases, each of which raises on failure (the script then exits non-zero):

1. device: needs ``torch.cuda.is_available()``; prints the card, its power
   limit and the torch / CUDA versions;
2. build: compiles ``hygrid_tpu_torch/csrc/*.cu`` with nvcc (timed),
   logs each kernel's registers and spills, and counts the tensor-core
   instructions (HGMMA/HMMA, ``cuobjdump -sass``) in every bf16
   instantiation of kernel B's conv kernel, ``hex_conv_kernel<N, bf16,
   out, split, stats>``, of ``hex_conv_single_mma_kernel<N>``, of the dW
   GEMM,
   ``wgrad_mma_kernel<N>``, and of the fused stack,
   ``fused_stack_mma_kernel<N>``: each must have some (bf16 runs on the
   tensor cores, float32 on the CUDA cores);
3. kernel A (plan_gather) against its plain version at the main paths'
   plans, C=3, float32 and bfloat16: HexCNN-512's rect->hex 512^2->256^2
   bilinear at b=32, 16 and 8, P-512's hex->rect 256^2->512^2 linear at
   b=16 and BN-CIFAR's rect->hex 32^2->16^2 at b=256; two launches
   bit-equal; each rect->hex plan on its factored weight table, and
   ``torch.equal`` to a launch on the per-pixel table; per call (CUDA
   events), device-alone (CUDA graph), the wrapper's host time a call and
   plain times, the bound from what the kernel reads (its own table once)
   and the bound with the dense plan once in its place, the table's form,
   bytes and host build time, and the grid the C side chose;
4. kernel B (hex_conv_layer) against its plain version at the six
   HexCNN-small layer shapes, b=32, GroupNorm(8) + ReLU, float32 and
   bfloat16, two launches bit-equal, with kernel and plain times, cuDNN's
   conv, the bound, the achieved TFLOP/s and, in bf16, the tile's N and
   the HGMMA/HMMA count of the instantiation the layer launches, and the
   layer split by torch.profiler into the conv pass (its epilogue sums the
   GN statistics) and the GN half after it, beside the GN tail's bound
   (read the float32 pre-activation, write the output) and the library's
   tail (``torch.nn.functional.group_norm`` on the same pre-activation,
   NHWC viewed as NCHW, then ReLU and the cast);
5. the serving slice: HexCNN-small (norm="GN", bf16, random weights from a
   seed) serves distinct b=32 batches of 512^2 RGB images, rect->hex
   included; the launch counters must show one kernel-A launch, six
   kernel-B layers and two max-pools (``hex_max_pool``) per request, the
   logits must be finite, and one
   request must agree with the plain path run in float32 on the card;
   a torch.profiler split of one request by kernel group;
6. the backward kernels against their plain versions at the six layer
   shapes, b=32, float32 and bfloat16: dL/dx (the conv pass on the
   adjoint tap table) and dL/dW (``hex_conv_wgrad``), with kernel and
   plain times, cuDNN's backward, the bound and the achieved TFLOP/s (dx
   and dW in bf16 with their tile's N and HGMMA/HMMA count, dW with its
   row chunks); two dW launches must be bit-equal;
6b. the GN/ReLU tail's backward (``gn_relu_backward``,
   ``csrc/gn_backward.cu``) against its plain version at HexCNN-small's six
   GN layers (b=32) and HexUNet-small's five (b=8), float32 and bfloat16:
   gpre, dgamma, dbeta and dbias, two launches bit-equal, with the plain
   time, the library's (the ReLU mask and
   ``aten.native_group_norm_backward`` on NCHW float32), the bound, the
   rate at the function's bytes and the walk ``gn_backward_plan`` chose;
6c. the hex max-pool (``csrc/hex_pool.cu``: ``hex_max_pool`` and
   ``hex_max_pool_backward``) against ``hex_pool2d``'s plain path and its
   autograd at the models' two pools (256^2 x 32 and 128x127 x 64, 2 x 2
   windows at stride 2), bf16 at b=128 and float32 at b=512, ReLU'd
   values on a coarse grid with a NaN cell: values and input gradient bit
   for bit; each kernel's ms (the forward without and with the tie mask),
   the plain ms and the bound (bytes);
7. the training slice: HexCNN-small (norm="GN", bf16 compute, float32
   parameters) with AdamW takes one warm-up and 4 timed steps on distinct
   b=32 512^2 float32 batches (rect->hex, forward, one-hot cross-entropy,
   backward, update); per step the counters must show 1 kernel-A launch,
   6 kernel-B layers, 5 dL/dx, 6 dL/dW and 6 GN backward launches (no
   autograd of the plain GN tail), 2 max-pools and their 2 backward;
   losses must be finite; a torch.profiler split of one step by kernel
   group; one step's loss and every parameter's grad must agree with the
   plain path run in float32 on the card (and, tighter, the float32
   kernel path with it);
7f. HexCNN-small in its default dtype, float32 (``hexcnn_small(norm="GN")``
   with no dtype, as users build it: every conv pass, dx and dW on the
   float32 tiles), at phase 7's shapes: 4 requests and 4 AdamW steps by
   CUDA events, images/s, the steps' peak memory, a request's and a
   step's launches held as in phases 5 and 7, a torch.profiler split of
   one step, and one step's loss and every grad against the plain float32
   path (phase 7's gates);
8. kernel C (shift_resample) against its plain version, float32 and
   bfloat16, on the 720p rect->hex bilinear plan (b=1 and b=8, C=3), the
   4K mosaic (540x960 -> 2160x3840, C=3, bit-equal), the 1080p rect->hex
   plan in float32 (the shape where the TPU kernel bands its source) and
   the 512^2 same-size hex->rect linear plan (which routes to
   plan_gather); with kernel, plain and plan_gather times per call (CUDA
   events, as for every kernel), the kernel's and plan_gather's device
   times by CUDA-graph replay (the host's dispatch left out) beside them,
   and the bound from the bytes the function needs (source, output and the
   plan's indices and weights; the kernel's own weight table, its form
   and bytes beside the phase or dense table's, is its overhead);
9. the video slice: the default 720p frame processor (bf16, hex 640x360,
   7-tap Gaussian): device ms per frame over 32 pre-staged frames (CUDA
   events), then 64 distinct numpy frames streamed through
   ``process_stream(depth=8)`` and again with ``microbatch=8`` (frames/s
   by wall clock); one shift_resample launch and no plan_gather launch per
   call; every streamed frame within 2e-2 of the plain float32 path on the
   card, microbatched frames within one bf16 ulp of per-frame ones;
10. the mosaic slice: 20 renders each of a float32 and a uint8 540x960
    image at 2160x3840 (frames/s by CUDA events), one shift_resample
    launch per render, both bit-equal to the plain gather; the render's
    kernel call and plan_gather's on the device alone, and the plan's
    weight table (form, bytes);
11. the TPU's banded and phased tiers on the port's kernels, float32 and
    bfloat16, with kernel, plain and bound times: hex_conv_layer at the
    P-4K stack layer (1x1080x1920, 16->16, no norm, ReLU; TPU kernel #9,
    cuDNN's time, the bound, TFLOP/s and the bf16 tile's N and HGMMA/HMMA
    count beside it) and plan_gather, checked as in phase 3, at P-4K's
    two legs (the rect->hex one is #2's plan, with shift_resample beside
    it), a 3-phase 512^2 plan (#3) and the 4K->4K resample4k plan (#4);
12. the fused stack (hex_conv_fused_stack, TPU kernel #11) at the P-512
    stack (16x256x256x16, 11 layers), float32 and bfloat16: it and chained
    hex_conv_layer launches against the plain version; fused and chained
    bit-equal in both dtypes (kernel B's CUDA-core tile in float32, its
    tensor-core tile on row bands in bfloat16); the tile the C side chose
    (band rows, grid, shared memory, the weights mode), held to its
    invariants in bfloat16; its time, the chained
    time, the plain time and the bound;
13. the north-star pipeline (bench.py's build_pipeline on the port):
    P-512 (b=16 RGB 512^2, bf16) unfused and fused, and P-4K (b=1 RGB
    2160x3840): 8 calls on distinct inputs by CUDA events (Mpix/s of rect
    input, peak memory), launches per call (2 plan_gather, 0
    shift_resample, 11 hex_conv_layer or 1 fused stack), one call against
    the plain float32 path, one P-512 call (unfused and fused) replayed in
    a CUDA graph (the device alone, beside the event-timed calls), and a
    torch.profiler split of one P-4K call;
14. the single-op conv (hex_conv_single, TPU kernels #7 and #8) against
    its plain version at the per-module route's five kernel layers
    (BN-512 float32 and bfloat16, BN-CIFAR float32), at odd parity,
    dilation 2 and radius 3; at BN-512's first layer band_rows=32 must be
    bit-equal to it, and hex_conv_layer on the same input bit-equal in
    both dtypes (each within its tolerance of the plain version); cuDNN's
    time (hex_conv2d(impl="direct")), the bound, TFLOP/s and (bf16) the
    tile's N and HGMMA/HMMA count beside the kernel's, and the sums over
    each configuration's five layers;
15. the per-module route: HexCNN-small with BatchNorm (eval, running
    statistics drawn from a seed), float32, at BN-512 (b=32 512^2 RGB)
    and BN-CIFAR (b=256 32^2 RGB), one model served as users build it
    (hexcnn_small(norm="BN"), convs impl="auto": cuDNN) and on the kernel
    route (build_permodule_hexcnn: the same model, convs impl="pallas"):
    on 4 distinct requests peak memory, launches per request (1
    plan_gather; 5 hex_conv_single on the kernel route, none on the
    other) and logits against the plain float32 path; images/s by CUDA
    events, the median and spread of 3 windows of at least 1 s each, the
    routes alternating; a torch.profiler split of one request;
16. the split layer (hex_conv_layer_split, TPU kernel #10 with
    split=True) against its plain version, float32 and bfloat16, at
    HexUNet-small's two skip-join layers (dec0 8x128x127 64+64->64, dec1
    8x256x256 32+32->32, GN(8) + ReLU) and at a split whose 16-channel
    staging chunk straddles the two inputs (24+8->32, no norm); bit-equal
    to hex_conv_layer on the torch.cat concatenation; its time beside
    concat + kernel B's, the plain time, cuDNN's conv, the bound, TFLOP/s
    and the bf16 tile's N and HGMMA/HMMA count;
17. HexUNet-small serving (GN(8), widths 32/64/128, depth 1, bf16, random
    weights from a seed) on distinct b=8 512^2 RGB batches, rect->hex
    included: per request 1 plan_gather, 3 hex_conv_layer (the encoder),
    2 hex_max_pool and 2 split layers (the decoder), no other kernel;
    logits (8, 4, 256, 256) finite and within 5e-2 of the plain float32
    path, the pixel-shuffle decoder too; images/s by CUDA events, the
    median and spread of 3 windows of at least 1 s; peak memory; a
    torch.profiler split of one request by kernel group;
18. the split layer's backward (TPU kernel #12 on the split layer, 12s:
    the dgrad pass on Ka and on Kb, the dW kernel on (A, g) and on (B, g))
    at dec0, dec1 and two splits of uneven widths (24+8->32, 40+24->64),
    b=8, float32 and bfloat16: split dgrad bit-equal to kernel B's dgrad
    cut at Ca, split wgrad bit-equal to the dW kernel run on each input
    and to a second launch, both against their plain versions; beside
    each time the plain time, cuDNN's backward, the bound, TFLOP/s and
    (bf16) each launch's tile N and HGMMA/HMMA count;
19. HexUNet-small training (the serving model of phase 17, AdamW) on
    distinct b=8 512^2 float32 batches with per-cell labels drawn as
    benchmarks/suite.py draws them: per step 1 plan_gather, 3
    hex_conv_layer, 2 split layers, 2 dgrad, 4 split dgrad, 3 wgrad, 4
    split wgrad, 5 GN backward, 2 max-pool and 2 max-pool backward
    launches, no other kernel; finite losses; images/s by
    CUDA events, the median and spread of 3 windows of at least 1 s;
    peak memory; a torch.profiler split of one step by kernel group; one
    step of the timed state, its loss, every grad and mean IoU against
    the plain float32 path, the float32 kernel path beside it, and the
    grads against the bfloat16 plain path; then 60 fit steps on
    synthetic_hex_shapes(size=64) batches, whose loss must fall;
20. the affine layer's backward (TPU kernel #12 on ("affine", scale,
    shift) layers, 12s on the split layer: the tail pulled back by
    affine_relu_backward, its ReLU mask the layer's output, dx and dW by
    the dgrad pass and hex_conv_wgrad)
    at HexCNN-small's six layer shapes (b=32) and HexUNet-small's dec1
    split layer (b=8, 32+32->32), float32 and bfloat16, scale and shift
    drawn from the seed: the pre-activation the forward kept against the
    plain conv's, and gpre, dx, dW, dbias, dscale and dshift against the
    plain backward at that pre-activation (the tail by float64 autograd,
    then the plain dgrad and wgrad); two backward runs bit-equal; beside
    each the plain time (autograd of the plain layer), the library's
    (autograd of hex_conv2d(impl="direct") + affine + ReLU), the bound
    and TFLOP/s; then hex_conv_stack with affine norms through its public
    entry, forward and backward (HexCNN-small's first stage, b=32, and
    HexUNet-small's dec1 skip-join stage, b=8, bf16), with its launches;
21. HexViT serving at benchmarks/suite.py::bench_hexvit's config (d192,
    6 blocks, 3 heads, 4 halvings: 256^2 hex -> 256 tokens; bf16, random
    weights from a seed) on distinct b=32 512^2 RGB batches, rect->hex
    included: per request 1 plan_gather and no other hand-written kernel
    (the stem convs are cuDNN, attention scaled_dot_product_attention);
    logits finite and within 5e-2 of the plain float32 path; images/s by
    CUDA events, the median and spread of 3 windows of at least 1 s; one
    request replayed in a CUDA graph (the device alone); peak memory; a
    torch.profiler split by kernel group; the request's work and bound;
22. training the new families with AdamW, 1 warm-up and 4 timed steps on
    distinct batches each (images/s by CUDA events, launches counted,
    finite losses), then one step's loss and every grad against the plain
    float32 path on the card (1e-1 relative for bf16 compute, 1e-3 for
    float32; each leaf against its own size, the key biases, whose grad
    is zero by construction, against the largest grad): HexViT (phase
    21's model, float32 parameters, its position embedding drawn at std
    0.3 so that its tokens differ, b=32 512^2 gratings, rect->hex in the
    step), HexCNN-small with norm="BN" in float32 (b=32 512^2; every
    running mean must move at every step; its only hand-written kernel is
    plan_gather, so against the plain path on plan_gather's input this is
    a check that the step is deterministic, beside plan_gather's input
    check) and HexResNet at its default widths on synthetic_hex_cifar at
    b=256 (each batch hexified on the card);
23. HexCNN-small training with hex augmentation (examples/train_hexcnn.py
    --augment): phase 7's model and step on distinct b=32 512^2 batches,
    each hexified (rect->hex, plan_gather) and then augmented on the card
    by augment_hex_batch (rotate, flip, translate 2: torch ops, no kernel
    of ours); runs of 4 augmented and of 4 plain steps in turns (aug,
    plain, plain, aug) by CUDA events (images/s of each), the launches of
    the first augmented run (phase 7's a step); every
    augmented batch torch.equal to the plain transforms on its CPU copy at
    the same draws (augment_draws replayed) and each image one of the 12
    dihedral images of its input, shifted by its even row and free column
    draws; one augmented step's loss against the plain float32 path on
    the same draws (phase 7's gate); the augmentation's ms a batch beside
    its bound (the batch read and written once);
23b. hexrot60 on plan_gather's dense form (a rotation plan has no row-band
    form) at b=32 C=3 256^2, k = 1..5, default pivot, float32, bfloat16
    and uint8 (through bfloat16): the dense index form, two plan_gather
    launches for two calls, torch.equal to apply_plan and between the
    launches; per-call, device (CUDA graph) and plain ms beside the bound
    from the dense table's bytes;
24. raster ingest of one Sentinel-2 L2A 10 m tile (4 bands, 10980^2,
    uint16, from a seed): written as an uncompressed GeoTIFF (EPSG:32633)
    by codecs.write_raster into a temporary directory under build/, read
    by IMAGE (the TiffWindowReader handle), the rect->hex plan, then
    tiled_rect_to_hex to 5490^2 bilinear with tile_rows=2048 (one
    plan_gather a tile), hex_impad_to_multiple(., 4), HEXIMAGE on a
    540x960 window and Hex_imshow at 2160x3840 (one shift_resample), and
    a .heximg round trip: the seconds of each stage, the tiled run again
    (its sub-plans and their tables kept on the plan) split into host->
    device, kernel and device->host,
    the kernel's ms beside the monolithic rect_to_hex_resample's and the
    bound, Mpix/s end to end (read, plan, tiled); tiled bit-equal to the
    monolithic resample on the card (or within 1e-6 relative, said which),
    the pad a zero pad, the mosaic bit-equal to render_mosaic;
25. the parallel package in this process, a world of one rank on NCCL
    (parallel.initialize_multihost): fit(mesh=create_mesh({"dp": 1}),
    checkpoint_path=) on phase 7's model and batches, one step an epoch,
    each step's loss (fit's history) and parameters (its epoch's .npz)
    within 1e-6 relative of train_step without a mesh from the same
    weights, phase 7's launches, a gradient all-reduce a step, the last
    checkpoint restored into a fresh model with torch.equal logits; the
    4K chain (sharded_resample 2160x3840 RGB -> hex 1080x1920 bilinear,
    zero-padded to 16 channels, four sharded_hex_conv2d 16->16 radius 2
    impl="pallas", sharded_resample back, linear) on an sp mesh of one,
    float32 and bfloat16, against the same ops unsharded (1e-5 and 5e-2
    relative), 2 resample launches (plan_gather, or shift_resample where
    a shard's plan takes that route) and 4 hex_conv_single a chain, no
    all-reduce or broadcast, the per-shard plan builds' seconds; the
    pipeline (pipeline_hex_conv_stack, 8 layers 16 channels, b=16 256^2
    float32) forward and kernel grad against the sequential stack on the
    same microbatches (1e-5 and 1e-4 relative);
26. four ranks on the one card over gloo (torch.multiprocessing spawn,
    each rank on cuda:0, the kernels from phase 2's build/ cache): the
    chain at sp=4 (540 source and 270 hex rows a rank; halos by send/recv
    through host memory, the only transport gloo has; no all-reduce or
    broadcast), one dp=4 training step of phase 25's model on its first
    batch (8 images a rank, at least one gradient all-reduce, phase 7's
    launches), the pipeline at pp=4; each held to phase 25's result; per
    rank the wall ms of each call, the plan builds' seconds, the halo
    bytes sent and the collectives' counts.  Four processes share one
    card there: the times are no measure of scaling;
27. ``utils/export.py`` on the card: HexCNN-small (phase 5's model)
    exported with a symbolic batch from a b=32 example, saved under
    build/, loaded and served at b=32 and b=8, ``torch.equal`` to the
    eager kernel path with 1 plan_gather, 6 hex_conv_layer and 2
    hex_max_pool launches a call; the same weights exported on the CPU
    (b=2, platforms cpu and cuda) and moved to the card at load, likewise
    at b=32 (no hex_max_pool: the CPU trace took the pools' plain path);
    export and load seconds, artifact bytes; a request from the artifact
    against the eager one in turns, 3 windows of at least 1 s each (CUDA
    events), and each one's host ms; the host ms a call of
    plan_gather and a GN hex_conv_layer through the wrapper, the op and
    the op's CUDA implementation called directly; then one program for
    each other op, saved, loaded, ``torch.equal`` to its eager call with
    its launches: HexUNet-small b=2 (1 plan_gather, 3 hex_conv_layer, 2
    hex_max_pool, 2 split layers), BN-512's kernel route b=2 (1 plan_gather, 5
    hex_conv_single), P-512 fused b=2 (2 plan_gather, 1 fused stack),
    the 720p frame processor (1 shift_resample).

Beside kernel B, the backward kernels, the split layer and the single-op
conv the kernels line carries cuDNN's time (``hex_conv2d(impl="direct")``
in the activations' dtype, TF32 off; its autograd for the backward) as
``library_ms``, the median of 5 timings of 10 calls each (their range is
logged).  Kernel B, dx, dW, the fused stack and the split layer and its
backward carry their float32 sums over the same layers under ``f32``
(ms, plain and library ms, bound).  The last lines are the kernel summary (with each kernel's bound: the bytes
it must move at 3.35 TB/s or its operations at the card's peak for their
type, whichever takes longer; plan_gather's bytes are its source, output
and own table, and ``dense_bound_ms`` puts the dense plan in the table's
place), the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""
import functools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
BATCH = 32
N_REQUESTS = 4
# (Cin, Cout, H, W) of the six conv layers of HexCNN-small on 512^2 input
LAYERS = [(3, 32, 256, 256), (32, 32, 256, 256), (32, 64, 128, 127),
          (64, 64, 128, 127), (64, 128, 64, 63), (128, 128, 64, 63)]
N_STEPS = 4
TOL = {"a_f32_abs": 1e-6, "a_bf16_rel": 1e-2, "b_f32_rel": 1e-4,
       "b_bf16_rel": 3e-2, "slice_rel": 5e-2, "loss_rel": 1e-2,
       "grad_bf16_rel": 1e-1, "grad_f32_rel": 1e-3, "video_rel": 2e-2}
# the card's published peaks (H100 SXM data sheet, dense, at 700 W)
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
VIDEO_FRAMES, VIDEO_TIMED, MICROBATCH, MOSAIC_RENDERS = 64, 32, 8, 20
# grad_bf16_rel: bf16 compute alone moves single leaves by up to 6e-2
# against the float32 plain path (the bf16 plain path as much as the bf16
# kernel path; PERF.md, findings on the training step), so the bound is
# 1e-1; the float32 kernel path is held to 1e-3.


def log(msg):
    print(msg, flush=True)


def cuda_ms(torch, fn, iters=10, warmup=2):
    """Mean device time of ``fn`` in ms: CUDA events around ``iters`` calls
    after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(torch, fn, calls=50, repeats=5):
    """Host time of one ``fn`` call in ms: the wrapper's Python and the
    launch's enqueue, by the host's clock over ``calls`` calls back to back
    after a synchronise (fewer than the launch queue holds, so the host
    never waits for the device); the median of ``repeats``."""
    times = []
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e3)
        torch.cuda.synchronize()
    return sorted(times)[len(times) // 2]


def graph_ms(torch, fn, iters=20):
    """Device time of one ``fn`` call in ms, without the host's dispatch:
    ``iters`` calls captured in one CUDA graph, replayed between CUDA
    events after a warm-up replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_err(got, want):
    """(max abs error, max abs error relative to max |want|), in float32."""
    diff = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def require(ok, what):
    if not ok:
        raise AssertionError(what)


# HGMMA/HMMA instructions in each bf16 instantiation of the tensor-core
# kernels, filled by mma_instructions(): kernel B's conv kernel, (N, GN
# pre-activation out with the stats epilogue, split) -> count;
# hex_conv_single's, the dW GEMM's and the fused stack's, N -> count
MMA_COUNTS = {}
SINGLE_MMA_COUNTS = {}
WGRAD_MMA_COUNTS = {}
FUSED_MMA_COUNTS = {}
# the instantiations: hex_conv_kernel<N, bf16, bf16, split, false> and
# <N, bf16, float, split, true> (GN) for N in 16-128, hex_conv_single_mma_kernel<N> for N in 16-128,
# wgrad_mma_kernel<N> for N in 8-32, fused_stack_mma_kernel<N> for N in
# 16-128
MMA_INSTANTIATIONS = (16, 4, 3, 4)


def mma_instructions(lib_path):
    """Count the tensor-core instructions (HGMMA, HMMA) in the SASS of every
    bf16 instantiation of ``hex_conv_kernel``, ``hex_conv_single_mma_kernel``,
    ``wgrad_mma_kernel`` and ``fused_stack_mma_kernel`` in the built
    library, by ``cuobjdump -sass``; fills the four count dicts."""
    import shutil
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True).stdout
    counts = key = None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1)
            # mangled: hex_conv_kernel<N, __nv_bfloat16, Tout, split,
            # stats>; float Tout comes with the stats epilogue only
            m = re.search(r"hex_conv_kernelILi(\d+)E13__nv_bfloat16(S1_|f)"
                          r"Lb([01])ELb([01])E", name)
            s = re.search(r"hex_conv_single_mma_kernelILi(\d+)E", name)
            w = re.search(r"wgrad_mma_kernelILi(\d+)E", name)
            f = re.search(r"fused_stack_mma_kernelILi(\d+)E", name)
            if m:
                require((m.group(2) == "f") == (m.group(4) == "1"),
                        f"{name}: a float32 output without the stats "
                        "epilogue, or the reverse")
            counts, key = (
                (MMA_COUNTS, (int(m.group(1)), m.group(2) == "f",
                              m.group(3) == "1")) if m
                else (SINGLE_MMA_COUNTS, int(s.group(1))) if s
                else (WGRAD_MMA_COUNTS, int(w.group(1))) if w
                else (FUSED_MMA_COUNTS, int(f.group(1))) if f
                else (None, None))
            if counts is not None:
                counts[key] = 0
        elif counts is not None and ("HGMMA" in line or "HMMA" in line):
            counts[key] += 1
    for what, found, n in zip(
            ("hex_conv_kernel<bf16>", "hex_conv_single_mma_kernel",
             "wgrad_mma_kernel", "fused_stack_mma_kernel"),
            (MMA_COUNTS, SINGLE_MMA_COUNTS, WGRAD_MMA_COUNTS,
             FUSED_MMA_COUNTS),
            MMA_INSTANTIATIONS):
        require(len(found) == n and all(found.values()),
                f"{what}: tensor-core instructions {found}")


def mma_note(cin, cout, gn=False, split=False, radius=2, adjoint=False,
             dilation=1):
    """The bf16 tile's N for a kernel B launch and the HGMMA/HMMA count of
    the instantiation it runs."""
    import torch
    from hygrid_tpu_torch.kernels import conv_stack as cs
    n = cs._tile_n(torch.bfloat16, cin, cout, 3 * radius * (radius - 1) + 1,
                   *cs._mma_patch_shape(radius, dilation, adjoint))
    return (f"tile N={n}, HGMMA/HMMA in hex_conv_kernel<{n}, bf16, "
            f"{'float' if gn else 'bf16'}, {str(split).lower()}, "
            f"{str(gn).lower()}>={MMA_COUNTS[(n, gn, split)]}")


def single_mma_note(cin, cout, radius=2, dilation=1):
    """The tile N of a bf16 ``hex_conv_single`` launch and the HGMMA/HMMA
    count of ``hex_conv_single_mma_kernel<N>``."""
    import torch
    from hygrid_tpu_torch.kernels import conv_stack as cs
    n = cs._tile_n(torch.bfloat16, cin, cout, 3 * radius * (radius - 1) + 1,
                   *cs._patch_shape(radius, dilation, False))
    return (f"tile N={n}, HGMMA/HMMA in hex_conv_single_mma_kernel<{n}>="
            f"{SINGLE_MMA_COUNTS[n]}")


def wgrad_mma_note(cin, cout, rows):
    """The tile of a bf16 dW launch (N input channels, 64 output channels,
    7 taps a block), its row chunks, and the HGMMA/HMMA count of
    ``wgrad_mma_kernel<N>``."""
    import torch
    from hygrid_tpu_torch.kernels import conv_stack as cs
    n, _, _ = cs._wgrad_tile(torch.bfloat16, cin, cout, 7)
    rpc, chunks = cs._wgrad_chunks(torch.bfloat16, rows, cin, cout, 7)
    return (f"tile N={n} x M=64, {chunks} chunks of {rpc} rows, HGMMA/HMMA "
            f"in wgrad_mma_kernel<{n}>={WGRAD_MMA_COUNTS[n]}")


def tflops(flops, ms):
    return flops / ms / 1e9


def cross_kernel_note(got, want):
    """How two results of different conv tiles differ: the max abs
    difference, it over max|want|, the share of elements that differ, and
    the largest difference in ulps of the output dtype at the element."""
    import torch
    g, w = got.float(), want.float()
    d = (g - w).abs()
    bits = 8 if got.dtype == torch.bfloat16 else 24
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - bits)
    return (f"max_abs_diff={d.max().item()!r} "
            f"({d.max().item() / max(w.abs().max().item(), 1e-30)!r} of "
            f"max|out|), {(g != w).float().mean().item() * 100:.4f} % of "
            f"elements differ, at most {(d / ulp).max().item():.0f} ulp")


def bound(nbytes, flops, peak):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of moving ``nbytes`` once and doing ``flops`` at ``peak``."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[peak] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def summed_bound(parts):
    """Sum of per-call bounds; named by the kind that bounds more of it."""
    total = sum(ms for ms, _ in parts)
    by_bytes = sum(ms for ms, by in parts if by == "bytes")
    return dict(bound_ms=total,
                bound_by="bytes" if by_bytes >= total - by_bytes
                else "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def cudnn_ms(torch, x, k, grad=None, repeats=5, iters=10):
    """The library yardstick of a 'same' hex conv layer (radius 2): cuDNN
    through ``hex_conv2d(impl="direct")`` in the activations' dtype (TF32
    off), on NHWC ``x`` ``(B, H, W, Cin)`` and ``k`` ``(Cout, Cin, kn)``.
    The forward's ms, or with ``grad`` "x" or "k" the ms of its backward to
    that input alone (``torch.autograd.grad`` on a kept graph: the
    forward is not timed).  Returns ``(median, (min, max))`` over
    ``repeats`` timings of ``iters`` calls each."""
    from hygrid_tpu_torch.nn.functional import hex_conv2d
    xn = x.permute(0, 3, 1, 2).contiguous()
    kw = dict(radius=2, padding=1, impl="direct")
    if grad is None:
        fn = functools.partial(hex_conv2d, xn, k, **kw)
    else:
        with torch.enable_grad():
            leaf = (xn if grad == "x" else k).detach().requires_grad_()
            y = (hex_conv2d(leaf, k, **kw) if grad == "x"
                 else hex_conv2d(xn, leaf, **kw))
        g = torch.randn_like(y)
        fn = functools.partial(torch.autograd.grad, y, leaf, g,
                               retain_graph=True)
    times = sorted(cuda_ms(torch, fn, iters=iters) for _ in range(repeats))
    return times[len(times) // 2], (times[0], times[-1])


def check_gather(torch, name, plan, x, factored=None):
    """One plan_gather case of phases 3 and 11: the kernel against its
    plain version (TOL a_f32_abs / a_bf16_rel), two launches bit-equal,
    with ``factored`` the factored table required and ``torch.equal`` to
    a launch on the per-pixel table; times per call (CUDA events), on the
    device alone (CUDA graph), the wrapper's host time a call, and plain;
    the bound from what the kernel reads (source, output and its own
    table once: ``bound_ms``) and, beside it, with the dense plan once in
    place of the table (``dense_bound_ms``); the host seconds of one table
    build.  Logs a line; returns its numbers."""
    from hygrid_tpu_torch.kernels import resample
    from hygrid_tpu_torch.ops import sampling
    dtype = x.dtype
    t0 = time.perf_counter()        # one build of the tables, uncached
    resample.gather_tables(plan, x.element_size())
    build_s = time.perf_counter() - t0
    tables = resample.gather_tables_cached(plan, x.element_size())
    got = resample.plan_gather(x, plan)
    launch = resample.last_launch()
    again = resample.plan_gather(x, plan)
    want = sampling.apply_plan(x, plan)
    torch.cuda.synchronize()
    require(got.shape == want.shape and got.dtype == dtype,
            f"plan_gather {name}: shape/dtype {got.shape} {got.dtype}")
    require(torch.equal(got, again),
            f"plan_gather {name} {dtype}: two launches differ")
    err, rel = max_err(got, want)
    if dtype == torch.float32:
        require(err <= TOL["a_f32_abs"],
                f"plan_gather {name} f32: max abs err {err}")
    else:
        require(rel <= TOL["a_bf16_rel"],
                f"plan_gather {name} bf16: relative err {rel}")
    line = ""
    if factored:
        require(tables.weight_form == "factored",
                f"plan_gather {name}: {tables.weight_form} weights, not the "
                "factored table")
        pixel = resample.gather_tables(plan, x.element_size(),
                                       factored=False)
        require(torch.equal(got, resample._launch(x, plan, pixel)),
                f"plan_gather {name} {dtype}: the factored table differs "
                "from the per-pixel one")
        line = (f"; torch.equal to the per-pixel table ({pixel.table_bytes} "
                "bytes)")
    ms = cuda_ms(torch, lambda: resample.plan_gather(x, plan))
    dev = graph_ms(torch, lambda: resample.plan_gather(x, plan))
    host = host_ms(torch, lambda: resample.plan_gather(x, plan))
    plain = cuda_ms(torch, lambda: sampling.apply_plan(x, plan))
    idx, wts = plan.tensors(x.device)
    flops = 2 * got.numel() * idx.shape[0]
    b_ms, b_by = bound(nbytes(x, got) + tables.table_bytes, flops, "f32")
    d_ms, _ = bound(nbytes(x, got, idx, wts), flops, "f32")
    log(f"plan_gather {name} {str(dtype)[6:]} K={idx.shape[0]}: "
        f"max_abs_err={err!r} rel={rel!r} kernel_ms={ms!r} "
        f"device_ms={dev!r} (CUDA graph) host_ms={host!r} (the wrapper's "
        f"enqueue) plain_ms={plain!r} bound_ms={b_ms!r} ({b_by}, "
        f"{tables.index_form}/{tables.weight_form} table "
        f"{tables.table_bytes} bytes, built in {build_s:.3f} s on the "
        f"host) dense_bound_ms={d_ms!r} (dense plan {nbytes(idx, wts)} "
        f"bytes); launch {launch}; two launches bit-equal{line}")
    return dict(max_abs_err=err, ms=ms, device_ms=dev, host_ms=host,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                dense_bound_ms=d_ms, table_build_s=build_s)


# phase 3's plans: (name, (geometry plan function, its arguments), lead
# dims, factored table)
GATHER_PLANS = [
    ("HexCNN-512 rect->hex 512^2->256^2 bilinear b=32",
     ("rect_to_hex", 512, 512, 256, 256, "bilinear"), (BATCH, 3), True),
    ("HexCNN-512 rect->hex b=16",
     ("rect_to_hex", 512, 512, 256, 256, "bilinear"), (16, 3), True),
    ("HexCNN-512 rect->hex b=8",
     ("rect_to_hex", 512, 512, 256, 256, "bilinear"), (8, 3), True),
    ("P-512 hex->rect 256^2->512^2 linear b=16",
     ("hex_to_rect", 256, 256, 512, 512, "linear"), (16, 3), False),
    ("BN-CIFAR rect->hex 32^2->16^2 bilinear b=256",
     ("rect_to_hex", 32, 32, 16, 16, "bilinear"), (256, 3), True),
]


def check_kernel_a(torch, gen):
    """Phase 3: plan_gather at the plans of the main paths, float32 and
    bfloat16 (check_gather).  Returns the kernels line's numbers: the
    HexCNN-512 b=32 rect->hex plan in bfloat16."""
    from hygrid_tpu_torch.ops import geometry
    summary = None
    for name, (kind, *args), lead, factored in GATHER_PLANS:
        plan = getattr(geometry, f"{kind}_plan")(*args)
        x32 = torch.rand(lead + plan.src_shape, generator=gen, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            res = check_gather(torch, name, plan, x32.to(dtype), factored)
            if summary is None and dtype == torch.bfloat16:
                summary = dict(res, library_ms=None)
    return summary


def _gn_half(torch, fn, calls=5):
    """Device ms a call of kernel B's conv pass, of its GN passes after it,
    and of the statistics fold among them, from torch.profiler over
    ``calls`` calls of ``fn``."""
    kernels = _profiled_kernels(torch, lambda: [fn() for _ in range(calls)])
    conv = sum(us for k, us in kernels if _conv_args(k) is not None)
    gn = sum(us for k, us in kernels if _is_gn_pass(k))
    fold = sum(us for k, us in kernels
               if re.search(r"\bgn_(stats|finalize)_kernel", k))
    return conv / 1e3 / calls, gn / 1e3 / calls, fold / 1e3 / calls


def check_kernel_b(torch, gen):
    from hygrid_tpu_torch.kernels import conv_stack
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    kn = hex_kernel_num(2)
    errs, ms_sum, plain_sum, lib_sum, bounds = [], 0.0, 0.0, 0.0, []
    gn = dict(conv_pass_ms=0.0, gn_half_ms=0.0, gn_fold_ms=0.0,
              gn_half_bound_ms=0.0, gn_library_ms=0.0)
    f32, f32_bounds = _f32_sums(), []
    for li, (cin, cout, h, w) in enumerate(LAYERS):
        groups = math.gcd(8, cout)
        k = torch.randn((cout, cin, kn), generator=gen, device="cuda") \
            / math.sqrt(cin * kn)
        gamma = 1 + 0.1 * torch.rand((cout,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        x32 = torch.rand((BATCH, h, w, cin), generator=gen, device="cuda")
        norm = ("gn", groups, gamma, beta)
        line = f"hex_conv_layer L{li} {cin}->{cout} {h}x{w} b={BATCH} GN({groups})+ReLU:"
        for dtype in (torch.float32, torch.bfloat16):
            x, kd = x32.to(dtype), k.to(dtype)

            def kernel():
                return conv_stack.hex_conv_layer(x, kd, radius=2, norm=norm,
                                                 relu=True)

            def plain():
                return conv_stack.hex_conv_layer_plain(x, kd, radius=2,
                                                       norm=norm, relu=True)

            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"hex_conv_layer L{li}: shape/dtype {got.shape} {got.dtype}")
            require(torch.equal(got, again),
                    f"hex_conv_layer L{li} {dtype}: two launches differ")
            err, rel = max_err(got, want)
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            require(rel <= tol, f"hex_conv_layer L{li} {dtype}: relative "
                                f"err {rel} > {tol}")
            ms = cuda_ms(torch, kernel, iters=5)
            pms = cuda_ms(torch, plain, iters=5)
            lms, lms_rng = cudnn_ms(torch, x, kd)
            flops = 2 * kn * BATCH * h * w * cin * cout
            b_ms, b_by = bound(nbytes(x, kd, gamma, beta, got), flops,
                               "bf16" if dtype == torch.bfloat16 else "f32")
            line += (f" {str(dtype)[6:]} max_abs_err={err!r} rel={rel!r} "
                     f"kernel_ms={ms!r} ({tflops(flops, ms)!r} TFLOP/s) "
                     f"plain_ms={pms!r} "
                     f"cudnn_conv_ms={lms!r} (range {lms_rng}) "
                     f"bound_ms={b_ms!r} ({b_by});")
            if dtype == torch.bfloat16:
                line += f" {mma_note(cin, cout, gn=True)};"
                # the GN half: the passes after the conv, the tail's bound
                # (read y, write out) and the library's tail on the same
                # float32 pre-activation
                conv_ms, gn_ms, fold_ms = _gn_half(torch, kernel)
                y = conv_stack._layer_forward(x, kd, None, 2, 1, norm,
                                              True)[1]
                tail_ms, _ = bound(nbytes(y, got), 0, "f32")
                fgn = torch.nn.functional.group_norm

                def library_tail():
                    return torch.relu(fgn(y.permute(0, 3, 1, 2), groups,
                                          gamma, beta, eps=1e-5)).to(dtype)

                gn_lms = cuda_ms(torch, library_tail, iters=5)
                line += (f" conv pass {conv_ms!r} ms + GN half {gn_ms!r} ms "
                         f"(profiler; the statistics fold {fold_ms!r} ms of "
                         f"it), GN tail bound {tail_ms!r} ms, library "
                         f"tail {gn_lms!r} ms (group_norm on the NHWC "
                         "pre-activation viewed as NCHW, relu, the cast);")
                gn["conv_pass_ms"] += conv_ms
                gn["gn_half_ms"] += gn_ms
                gn["gn_fold_ms"] += fold_ms
                gn["gn_half_bound_ms"] += tail_ms
                gn["gn_library_ms"] += gn_lms
                del y
            if dtype == torch.bfloat16:
                errs.append(err)
                ms_sum += ms
                plain_sum += pms
                lib_sum += lms
                bounds.append((b_ms, b_by))
            else:
                _add_f32(f32, f32_bounds, err, ms, pms, lms, (b_ms, b_by))
        log(line)
    log(f"hex_conv_layer six GN layers bf16: {gn}")
    # library: cuDNN's conv alone (the kernel adds bias, GN and ReLU)
    return dict(max_abs_err=max(errs), ms=ms_sum, plain_ms=plain_sum,
                **summed_bound(bounds), library_ms=lib_sum, **gn,
                f32=dict(f32, **summed_bound(f32_bounds)))


def run_slice(torch):
    from hygrid_tpu_torch.models import hexcnn_small, hexify_batch
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda",
                         generator=gen).eval()
    in_gen = torch.Generator(device="cuda").manual_seed(1)
    warm = torch.rand((BATCH, 3, 512, 512), generator=in_gen, device="cuda")
    requests = [torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                           device="cuda") for _ in range(N_REQUESTS)]

    def serve(batch):
        return model(hexify_batch(batch.to(torch.bfloat16)))

    with torch.inference_mode():
        serve(warm)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        logits = [serve(r) for r in requests]
        end.record()
        end.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in _launches().items()
                    if k in ("plan_gather", "hex_conv_layer",
                             "hex_max_pool")}
        peak = torch.cuda.max_memory_allocated()
        dev_ms = start.elapsed_time(end)
        require(launches["hex_max_pool"] == 2 * N_REQUESTS,
                f"hex_max_pool launches {launches['hex_max_pool']} for "
                f"{N_REQUESTS} requests")
        require(launches["plan_gather"] == N_REQUESTS,
                f"plan_gather launches {launches['plan_gather']} for "
                f"{N_REQUESTS} requests")
        require(launches["hex_conv_layer"] == 6 * N_REQUESTS,
                f"hex_conv_layer layers {launches['hex_conv_layer']} for "
                f"{N_REQUESTS} requests")
        for i, out in enumerate(logits):
            require(out.shape == (BATCH, 10) and out.dtype == torch.bfloat16,
                    f"request {i}: logits {tuple(out.shape)} {out.dtype}")
            require(bool(torch.isfinite(out).all()),
                    f"request {i}: non-finite logits")
        require(not torch.equal(logits[0], logits[1]),
                "distinct requests returned equal logits")
        ref_model = hexcnn_small(norm="GN", dtype=torch.float32, device="cuda")
        ref_model.load_state_dict(model.state_dict())
        ref = ref_model(hexify_batch(requests[0], plain=True), plain=True)
        err, rel = max_err(logits[0], ref)
        require(rel <= TOL["slice_rel"],
                f"slice logits vs plain f32: relative err {rel}")
        split = _profile_split(torch, lambda: serve(requests[0]),
                               dev_ms / N_REQUESTS, HEXCNN_GROUPS)
    log(f"slice HexCNN-small GN bf16 b={BATCH} 512^2: {N_REQUESTS} requests "
        f"in {dev_ms!r} ms (CUDA events), {wall!r} s host; "
        f"images/s={BATCH * N_REQUESTS / (dev_ms / 1e3)!r}; "
        f"peak_mem_bytes={peak}; launches={launches}; "
        f"logits vs plain f32 max_abs_err={err!r} rel={rel!r}")
    log(f"slice torch.profiler, one request: {split}")
    return launches


def _f32_sums():
    return dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)


def _add_f32(acc, bounds, err, ms, pms, lms, b):
    """Adds one float32 layer's figures to a kernel's ``f32`` summary (the
    kernels line's float32 sums beside the bf16 ones)."""
    acc["max_abs_err"] = max(acc["max_abs_err"], err)
    acc["ms"] += ms
    acc["plain_ms"] += pms
    acc["library_ms"] += lms
    bounds.append(b)


def _conv_args(k):
    """The template arguments of a kernel B launch in a profiler kernel
    name (``hex_conv_kernel<N, Tin, Tout, split, stats>``; four before the
    stats epilogue; the float32 pass ``hex_conv_fma_kernel<COB, split,
    stats>`` read as ``<COB, float, float, split, stats>``), or None for
    another kernel."""
    m = re.search(r"hex_conv_(fma_)?kernel<([^>]*)>", k)
    if m is None:
        return None
    args = [a.strip() for a in m.group(2).split(",")]
    return [args[0], "float", "float", *args[1:]] if m.group(1) else args


def _is_gn_conv(k):
    """Kernel B's conv pass of a GN layer (its stats epilogue; before the
    epilogue, the only float32 output in bf16), not split."""
    a = _conv_args(k)
    if a is None or a[3] != "false":
        return False
    return a[4] == "true" if len(a) > 4 else a[2] == "float"


def _is_split_conv(k):
    a = _conv_args(k)
    return a is not None and a[3] == "true"


def _is_gn_pass(k):
    """The port's GN passes after the conv (this tree's stats fold and
    apply; an older tree's partial, finalize and apply)."""
    return re.search(r"\bgn_(stats|apply|partial|finalize)_kernel", k) \
        is not None


def _is_gn_bwd(k):
    return re.search(r"\bgn_bwd_\w+_kernel", k) is not None


# kernel groups of a HexCNN-small request and training step (GN layers: the
# forward conv pass writes the float32 pre-activation, dx writes bf16)
HEXCNN_GROUPS = [
    ("kernel B conv", _is_gn_conv),
    ("dgrad", lambda k: _conv_args(k) is not None),
    ("wgrad", lambda k: "wgrad_" in k),
    ("GN passes", _is_gn_pass),
    ("GN backward", _is_gn_bwd),
    ("plan_gather", lambda k: "plan_gather" in k),
    ("AdamW", lambda k: "adam" in k.lower() or "multi_tensor" in k),
    ("max-pool", lambda k: "max_pool" in k),
    ("reductions", lambda k: "reduce_kernel" in k),
]


def check_backward(torch, gen):
    """Phase 6: dL/dx and dL/dW against their plain versions.  Returns the
    summaries of both for the kernels line: bf16 errors, and kernel and
    plain ms summed over the layers the training step runs them on (dx
    skips layer 0, whose input needs no grad), the float32 ones under
    ``f32``."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    kn = hex_kernel_num(2)
    sums = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
            for name in ("dgrad", "wgrad")}
    bounds = {"dgrad": [], "wgrad": []}
    f32 = {name: _f32_sums() for name in sums}
    f32_bounds = {name: [] for name in sums}
    for li, (cin, cout, h, w) in enumerate(LAYERS):
        k = torch.randn((cout, cin, kn), generator=gen, device="cuda") \
            / math.sqrt(cin * kn)
        x32 = torch.rand((BATCH, h, w, cin), generator=gen, device="cuda")
        g32 = torch.randn((BATCH, h, w, cout), generator=gen, device="cuda")
        line = f"backward L{li} {cin}->{cout} {h}x{w} b={BATCH}:"
        for dtype in (torch.float32, torch.bfloat16):
            x, g, kd = x32.to(dtype), g32.to(dtype), k.to(dtype)
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            pairs = {
                "dgrad": (lambda: cs.hex_conv_layer_dgrad(g, kd, radius=2),
                          lambda: cs.hex_conv_layer_dgrad_plain(g, kd,
                                                                radius=2)),
                "wgrad": (lambda: cs.hex_conv_layer_wgrad(x, g, radius=2),
                          lambda: cs.hex_conv_layer_wgrad_plain(x, g,
                                                                radius=2)),
            }
            for name, (kernel, plain) in pairs.items():
                got, want = kernel(), plain()
                again = kernel() if name == "wgrad" else got
                torch.cuda.synchronize()
                want_shape = x.shape if name == "dgrad" else k.shape
                require(got.shape == want_shape,
                        f"{name} L{li}: shape {tuple(got.shape)}")
                require(torch.equal(got, again),
                        f"wgrad L{li} {dtype}: two launches differ")
                err, rel = max_err(got, want)
                require(rel <= tol, f"{name} L{li} {dtype}: relative err "
                                    f"{rel} > {tol}")
                ms = cuda_ms(torch, kernel, iters=5)
                pms = cuda_ms(torch, plain, iters=5)
                lms, lms_rng = cudnn_ms(torch, x, kd,
                               grad="x" if name == "dgrad" else "k")
                flops = 2 * kn * BATCH * h * w * cin * cout
                b_ms, b_by = bound(
                    nbytes(g, kd, got) if name == "dgrad"
                    else nbytes(x, g, got), flops,
                    "bf16" if dtype == torch.bfloat16 else "f32")
                line += (f" {name} {str(dtype)[6:]} max_abs_err={err!r} "
                         f"rel={rel!r} kernel_ms={ms!r} "
                         f"({tflops(flops, ms)!r} TFLOP/s) plain_ms={pms!r} "
                         f"cudnn_bwd_ms={lms!r} (range {lms_rng}) "
                         f"bound_ms={b_ms!r} ({b_by});")
                if dtype == torch.bfloat16 and name == "dgrad":
                    line += f" {mma_note(cout, cin, adjoint=True)};"
                if dtype == torch.bfloat16 and name == "wgrad":
                    line += f" {wgrad_mma_note(cin, cout, BATCH * h)};"
                if dtype == torch.bfloat16 and (name == "wgrad" or li > 0):
                    acc = sums[name]
                    acc["max_abs_err"] = max(acc["max_abs_err"], err)
                    acc["ms"] += ms
                    acc["plain_ms"] += pms
                    acc["library_ms"] += lms
                    bounds[name].append((b_ms, b_by))
                elif name == "wgrad" or li > 0:
                    _add_f32(f32[name], f32_bounds[name], err, ms, pms, lms,
                             (b_ms, b_by))
        log(line)
    for name in sums:
        sums[name].update(summed_bound(bounds[name]))
        sums[name]["f32"] = dict(f32[name], **summed_bound(f32_bounds[name]))
    return sums


def check_gn_backward(torch, gen):
    """Phase 6b: the GN/ReLU tail's backward (``gn_relu_backward``) against
    its plain version at HexCNN-small's six GN layers (b=32) and
    HexUNet-small's five (b=8: the encoder's three, the decoder's two
    split layers), GN(8) + ReLU, gout float32 and bfloat16: gpre within the
    layer's tolerance, dgamma, dbeta and dbias within the float32 one, two
    launches bit-equal.  Beside each time: the plain time, the library's
    (the ReLU mask and ``aten.native_group_norm_backward``), the bound
    (y, gout and gpre once each), the rate at the function's bytes, and
    the planner's walk (``gn_backward_plan``: chunk pixels, staged pixels,
    samples a wave, waves = items a block, stages, shared bytes, grid).
    Returns the bf16 summaries over each model's layers for the kernels
    line."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    aten = torch.ops.aten
    card = cs.gn_backward_device(torch.device("cuda"))
    layers = ([("HexCNN-small", f"L{i}", BATCH, cout, h, w)
               for i, (_, cout, h, w) in enumerate(LAYERS)]
              + [("HexUNet-small", name, UNET_BATCH, c, h, w)
                 for name, c, h, w in UNET_GN_LAYERS])
    sums = {m: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
            for m in ("HexCNN-small", "HexUNet-small")}
    bounds = {m: [] for m in sums}
    for model, name, b, c, h, w in layers:
        groups = math.gcd(8, c)
        y = 1.5 * torch.randn((b, h, w, c), generator=gen, device="cuda") \
            + 0.2
        gamma = 1 + 0.1 * torch.rand((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        g32 = torch.randn((b, h, w, c), generator=gen, device="cuda")
        mean, rstd = cs.gn_stats_plain(y, groups)
        yn = y.permute(0, 3, 1, 2).contiguous()
        mask = torch.nn.functional.group_norm(yn, groups, gamma, beta) > 0
        line = (f"gn_relu_backward {model} {name} b={b} {c}x{h}x{w} "
                f"GN({groups})+ReLU:")
        for dtype in (torch.float32, torch.bfloat16):
            gout = g32.to(dtype)
            args = (y, mean, rstd, gamma, beta, gout, groups, True)
            kernel = functools.partial(cs.gn_relu_backward, *args)
            plain = functools.partial(cs.gn_relu_backward_plain, *args)
            got, again, want = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            require(all(torch.equal(u, v) for u, v in zip(got, again)),
                    f"gn_relu_backward {model} {name} {dtype}: two launches "
                    "differ")
            require(got[0].shape == y.shape and got[0].dtype == dtype,
                    f"gn_relu_backward {name}: {tuple(got[0].shape)} "
                    f"{got[0].dtype}")
            err, rel = max_err(got[0], want[0])
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            require(rel <= tol, f"gn_relu_backward {model} {name} {dtype}: "
                                f"gpre relative err {rel} > {tol}")
            sum_rels = [max_err(u, v)[1] for u, v in zip(got[1:], want[1:])]
            require(max(sum_rels) <= TOL["b_f32_rel"],
                    f"gn_relu_backward {model} {name} {dtype}: dgamma, "
                    f"dbeta, dbias relative errs {sum_rels}")
            ms = cuda_ms(torch, kernel, iters=5)
            pms = cuda_ms(torch, plain, iters=5)
            gn = gout.float().permute(0, 3, 1, 2).contiguous()

            def library():
                return aten.native_group_norm_backward(
                    gn * mask, yn, mean, rstd, gamma, b, c, h * w, groups,
                    [True, True, True])

            lms = cuda_ms(torch, library, iters=5)
            del gn
            b_ms, b_by = bound(nbytes(y, gout, got[0]), 12 * y.numel(),
                               "f32")
            plan = cs.gn_backward_plan(b, h * w, c, gout.element_size(),
                                       *card)
            line += (f" {str(dtype)[6:]} max_abs_err={err!r} rel={rel!r} "
                     f"(dgamma, dbeta, dbias rel {sum_rels}) "
                     f"kernel_ms={ms!r} plain_ms={pms!r} library_ms={lms!r} "
                     f"(mask + native_group_norm_backward on NCHW float32) "
                     f"bound_ms={b_ms!r} ({b_by}) "
                     f"GB/s={nbytes(y, gout, got[0]) / ms / 1e6!r} "
                     f"plan={plan._asdict()};")
            if dtype == torch.bfloat16:
                acc = sums[model]
                acc["max_abs_err"] = max(acc["max_abs_err"], err)
                acc["ms"] += ms
                acc["plain_ms"] += pms
                acc["library_ms"] += lms
                bounds[model].append((b_ms, b_by))
        log(line)
        del y, yn, mask, g32
    for model in sums:
        sums[model].update(summed_bound(bounds[model]))
    log(f"gn_relu_backward bf16 sums: {sums}")
    unet = sums.pop("HexUNet-small")
    return dict(sums["HexCNN-small"], hexunet_ms=unet["ms"],
                hexunet_plain_ms=unet["plain_ms"],
                hexunet_library_ms=unet["library_ms"],
                hexunet_bound_ms=unet["bound_ms"])


# phase 6c's pools: (name, H, W, C) of the models' two max-pools (2 x 2
# windows at stride 2), at the batch of each dtype's cells: bf16 serving at
# b=128, float32 training at b=512
POOL_LAYERS = [("first", 256, 256, 32), ("second", 128, 127, 64)]
POOL_BATCHES = {"bf16": 128, "f32": 512}


def _float_bits(torch, t):
    """``t``'s bit patterns, every NaN as one pattern."""
    t = torch.where(torch.isnan(t), torch.nan, t)
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_pool(torch, gen):
    """Phase 6c: the hex max-pool (``kernels/pool.py::hex_max_pool``,
    ``csrc/hex_pool.cu``) against ``hex_pool2d``'s plain path
    (``_window_reduce``: the window gather, NaN as -inf, two ``amax``
    stages) and its autograd at the models' two pools, bf16 at b=128 and
    float32 at b=512, on ReLU'd values on a coarse grid (most windows tie)
    with a NaN cell: the values and the input gradient bit for bit, the
    forward under ``inference_mode`` equal to the one that keeps the mask.
    Beside each kernel (the forward without and with the tie mask, the
    backward from the mask) its ms, the plain ms (the backward on a kept
    graph) and the bound: the windows' cells read and the output written
    once; the output gradient read and the input gradient written once.
    Returns the bf16 sums for the kernels line, the float32 sums under
    ``f32``."""
    from hygrid_tpu_torch.kernels import pool
    from hygrid_tpu_torch.nn import functional as F
    op = torch.ops.hygrid
    sums = {"forward": {}, "backward": {}}
    for tag, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        b = POOL_BATCHES[tag]
        fwd = dict(ms=0.0, mask_ms=0.0, plain_ms=0.0)
        bwd = dict(ms=0.0, plain_ms=0.0)
        f_bounds, b_bounds = [], []
        for name, h, w, c in POOL_LAYERS:
            x = torch.randn((b, h, w, c), generator=gen, device="cuda")
            x = torch.clamp(torch.round(x * 2) / 2, min=0).to(dtype)
            x[0, 0, 0, 0] = float("nan")
            hn, wn = pool.pool_shape(h, w, 2, 2, 2, 2)
            g = torch.randn((b, hn, wn, c), generator=gen,
                            device="cuda").to(dtype)

            def plain(t):
                return F._window_reduce(t.permute(0, 3, 1, 2), "max", hn, wn,
                                        2, 2, 2, 2, 1, True)

            t = x.clone().requires_grad_()
            want = plain(t)
            want.backward(g)
            k = x.clone().requires_grad_()
            got = pool.hex_max_pool(k, (2, 2), (2, 2))
            got.backward(g)
            with torch.inference_mode():
                served = pool.hex_max_pool(x, (2, 2), (2, 2))
            torch.cuda.synchronize()
            what = f"hex_max_pool {name} pool {tag} b={b} {h}x{w}x{c}"
            require(torch.equal(_float_bits(torch, got),
                                _float_bits(torch, want)),
                    f"{what}: values differ from the plain path's")
            require(torch.equal(_float_bits(torch, k.grad),
                                _float_bits(torch, t.grad)),
                    f"{what}: the input gradient differs from the plain "
                    "path's")
            require(torch.equal(_float_bits(torch, served),
                                _float_bits(torch, got)),
                    f"{what}: inference_mode differs from the masked call")
            del t, k, want, got, served
            _, mask = op.hex_max_pool(x, 2, 2, 2, 2, True)
            ms = cuda_ms(torch, lambda: op.hex_max_pool(x, 2, 2, 2, 2, False))
            mask_ms = cuda_ms(torch,
                              lambda: op.hex_max_pool(x, 2, 2, 2, 2, True))
            bms = cuda_ms(torch, lambda: op.hex_max_pool_backward(
                g, mask, h, w, 2, 2, 2, 2))
            with torch.inference_mode():
                pms = cuda_ms(torch, lambda: plain(x), iters=5)
            xr = x.clone().requires_grad_()
            out = plain(xr)

            def plain_backward():
                xr.grad = None
                out.backward(g, retain_graph=True)

            pbms = cuda_ms(torch, plain_backward, iters=5)
            e = x.element_size()
            f_b = bound(e * b * hn * wn * c * 5, 0, "f32")
            b_b = bound(nbytes(g, x), 0, "f32")
            log(f"{what}: values and input gradient bit-equal to the plain "
                f"path; forward kernel_ms={ms!r} with the mask {mask_ms!r} "
                f"plain_ms={pms!r} bound_ms={f_b[0]!r} "
                f"({100 * f_b[0] / ms:.1f} % of it); backward "
                f"kernel_ms={bms!r} plain_ms={pbms!r} (autograd on a kept "
                f"graph) bound_ms={b_b[0]!r} ({100 * b_b[0] / bms:.1f} %)")
            for acc, vals in ((fwd, (ms, mask_ms, pms)), (bwd, (bms, pbms))):
                for key, v in zip(acc, vals):
                    acc[key] += v
            f_bounds.append(f_b)
            b_bounds.append(b_b)
            del x, g, mask, xr, out
            torch.cuda.empty_cache()
        fwd.update(summed_bound(f_bounds))
        bwd.update(summed_bound(b_bounds))
        for part, acc in (("forward", fwd), ("backward", bwd)):
            if tag == "bf16":
                sums[part].update(acc, max_abs_err=0.0)
            else:
                sums[part]["f32"] = dict(acc, max_abs_err=0.0)
    log(f"hex_max_pool sums over the two pools: {sums}")
    return sums


def run_training(torch):
    """Phase 7: the training slice.  Returns the per-kernel launches."""
    from hygrid_tpu_torch.models import (create_train_state,
                                         dense_onehot_xent, hexcnn_small,
                                         hexify_batch, train_step)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda",
                         generator=gen)
    state = create_train_state(model)
    in_gen = torch.Generator(device="cuda").manual_seed(2)
    batches = [torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                          device="cuda") for _ in range(N_STEPS + 2)]
    labels = torch.arange(BATCH, device="cuda") % 10

    def step(batch):
        return train_step(state, hexify_batch(batch), labels)[1]

    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics = [step(b) for b in batches[1:N_STEPS + 1]]
    end.record()
    end.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in _launches().items()
                if k in TRAIN_STEP_LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    dev_ms = start.elapsed_time(end)
    for name, n in TRAIN_STEP_LAUNCHES.items():
        require(launches[name] == n * N_STEPS,
                f"training: {name} launched {launches[name]} times in "
                f"{N_STEPS} steps, want {n * N_STEPS}")
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(v) for v in losses),
            f"training: non-finite losses {losses}")
    split = _profile_split(torch, lambda: step(batches[1]), dev_ms / N_STEPS,
                           HEXCNN_GROUPS)

    # one more step from a snapshot, against the plain path in float32;
    # the float32 kernel path and the bfloat16 plain path are logged beside
    # it (the first must agree tightly, the second shows what bf16 alone
    # moves)
    batch = batches[-1]
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    loss = float(step(batch)["loss"])
    runs = {"bf16 kernel": (loss, {n: p.grad for n, p in
                                   model.named_parameters()})}
    for label, dtype, plain in (("f32 plain", torch.float32, True),
                                ("f32 kernel", torch.float32, False),
                                ("bf16 plain", torch.bfloat16, True)):
        m = hexcnn_small(norm="GN", dtype=dtype, device="cuda")
        m.load_state_dict(snapshot)
        ref_loss = dense_onehot_xent(
            m(hexify_batch(batch, plain=plain), plain=plain), labels)
        ref_loss.backward()
        runs[label] = (float(ref_loss.detach()),
                       {n: p.grad for n, p in m.named_parameters()})
    ref_loss, ref_grads = runs.pop("f32 plain")
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    rels = {label: {n: max_err(g[n], want)[1] if g[n] is not None else None
                    for n, want in ref_grads.items()}
            for label, (_, g) in runs.items()}
    log(f"training HexCNN-small GN bf16 AdamW b={BATCH} 512^2: {N_STEPS} "
        f"steps in {dev_ms!r} ms (CUDA events), {wall!r} s host; "
        f"images/s={BATCH * N_STEPS / (dev_ms / 1e3)!r}; "
        f"peak_mem_bytes={peak}; launches={launches}; losses={losses}")
    log(f"training torch.profiler, one step: {split}")
    log(f"training step vs plain f32 on the card: loss {loss!r} vs "
        f"{ref_loss!r} (rel {loss_rel!r})")
    for label, leaf in rels.items():
        log(f"training grads, {label} path vs plain f32 (rel max-abs): "
            + ", ".join(f"{n}={r!r}" for n, r in leaf.items()))
    require(loss_rel <= TOL["loss_rel"],
            f"training loss {loss} vs plain f32 {ref_loss}: rel {loss_rel}")
    for label in ("bf16 kernel", "f32 kernel"):
        for n, r in rels[label].items():
            tol = TOL["grad_f32_rel" if label == "f32 kernel" else
                      "grad_bf16_rel"]
            require(r is not None and r <= tol,
                    f"{label} path grad {n}: relative err {r} > {tol}")
    return launches


def run_training_f32(torch):
    """Phase 7f: HexCNN-small as users build it, in its default dtype
    (``hexcnn_small(norm="GN")`` with no dtype: float32, its GN stages on
    ``hex_conv_layer``, so every conv pass, dx and dW runs the float32
    tiles), at phase 7's shapes (b=32 RGB 512^2 through ``hexify_batch``):
    N_REQUESTS requests and N_STEPS AdamW steps of ``train_step`` by CUDA
    events, images/s, the steps' peak memory, the launches (a request's
    SERVE_LAUNCHES, a step's TRAIN_STEP_LAUNCHES), one step's profiler
    split, and one step's loss (loss_rel) and every grad (grad_f32_rel)
    against the plain float32 path.  Returns the launches of the requests
    and steps."""
    from hygrid_tpu_torch.models import (create_train_state,
                                         dense_onehot_xent, hexcnn_small,
                                         hexify_batch, train_step)
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = hexcnn_small(norm="GN", device="cuda", generator=gen)
    serve_model = hexcnn_small(norm="GN", device="cuda",
                               generator=gen).eval()
    require(all(p.dtype == torch.float32 for p in model.parameters()),
            "phase 7f: hexcnn_small's default dtype is not float32")
    state = create_train_state(model)
    in_gen = torch.Generator(device="cuda").manual_seed(8)
    batches = [torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                          device="cuda") for _ in range(N_STEPS + 2)]
    labels = torch.arange(BATCH, device="cuda") % 10

    def serve(batch):
        return serve_model(hexify_batch(batch))

    def step(batch):
        return train_step(state, hexify_batch(batch), labels)[1]

    def timed(fn, items):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = [fn(b) for b in items]
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def launches():
        return {k: v for k, v in _launches().items()
                if k in TRAIN_STEP_LAUNCHES}

    with torch.inference_mode():
        serve(batches[0])
        torch.cuda.synchronize()
        _zero_launches()
        logits, serve_ms = timed(serve, batches[1:N_REQUESTS + 1])
        served = launches()
    for name, n in SERVE_LAUNCHES.items():
        require(served[name] == n * N_REQUESTS,
                f"phase 7f serving: {name} launched {served[name]} times in "
                f"{N_REQUESTS} requests, want {n * N_REQUESTS}")
    for i, out in enumerate(logits):
        require(out.shape == (BATCH, 10) and out.dtype == torch.float32
                and bool(torch.isfinite(out).all()),
                f"phase 7f request {i}: {tuple(out.shape)} {out.dtype} or "
                "non-finite")

    step(batches[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    metrics, train_ms = timed(step, batches[1:N_STEPS + 1])
    trained = launches()
    peak = torch.cuda.max_memory_allocated()
    for name, n in TRAIN_STEP_LAUNCHES.items():
        require(trained[name] == n * N_STEPS,
                f"phase 7f training: {name} launched {trained[name]} times "
                f"in {N_STEPS} steps, want {n * N_STEPS}")
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(v) for v in losses),
            f"phase 7f: non-finite losses {losses}")
    split = _profile_split(torch, lambda: step(batches[1]),
                           train_ms / N_STEPS, HEXCNN_GROUPS)

    # one more step from a snapshot, against the plain float32 path
    batch = batches[-1]
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    loss = float(step(batch)["loss"])
    grads = {n: p.grad for n, p in model.named_parameters()}
    ref = hexcnn_small(norm="GN", device="cuda")
    ref.load_state_dict(snapshot)
    ref_loss = dense_onehot_xent(ref(hexify_batch(batch, plain=True),
                                     plain=True), labels)
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    rels = {n: max_err(grads[n], p.grad)[1] if grads[n] is not None
            else None for n, p in ref.named_parameters()}
    log(f"phase 7f HexCNN-small GN float32 (default dtype) b={BATCH} 512^2: "
        f"serving {N_REQUESTS} requests in {serve_ms!r} ms (CUDA events), "
        f"{serve_ms / N_REQUESTS!r} ms a request, images/s="
        f"{BATCH * N_REQUESTS / (serve_ms / 1e3)!r}, launches={served}; "
        f"training {N_STEPS} AdamW steps in {train_ms!r} ms, "
        f"{train_ms / N_STEPS!r} ms a step, images/s="
        f"{BATCH * N_STEPS / (train_ms / 1e3)!r}, peak_mem_bytes={peak}, "
        f"launches={trained}, losses={losses}")
    log(f"phase 7f torch.profiler, one float32 step: {split}")
    log(f"phase 7f step vs plain f32: loss {loss!r} vs {ref_loss!r} (rel "
        f"{loss_rel!r}); grads (rel max-abs): "
        + ", ".join(f"{n}={r!r}" for n, r in rels.items()))
    require(loss_rel <= TOL["loss_rel"],
            f"phase 7f loss {loss} vs plain f32 {ref_loss}: rel {loss_rel}")
    for n, r in rels.items():
        require(r is not None and r <= TOL["grad_f32_rel"],
                f"phase 7f grad {n}: relative err {r} > "
                f"{TOL['grad_f32_rel']}")
    return {k: served[k] + trained[k] for k in served}


def _shift_plans(torch):
    """Phase 8's plans: (name, plan, lead dims, dtypes, main path, whether
    apply_plan_auto routes it to shift_resample)."""
    from hygrid_tpu_torch.ops import geometry
    from hygrid_tpu_torch.viz import render
    p720 = geometry.rect_to_hex_plan(720, 1280, 360, 640, "bilinear")
    both = (torch.float32, torch.bfloat16)
    return [
        ("720p rect->hex 1280x720->640x360 bilinear", p720, (1, 3), both,
         "video", True),
        ("720p rect->hex 1280x720->640x360 bilinear", p720, (8, 3), both,
         None, True),
        ("4K mosaic 540x960->2160x3840",
         render._mosaic_sample_plan(540, 960, 2160, 3840, 0, None), (3,),
         both, "mosaic", True),
        ("1080p rect->hex 1920x1080->960x540 bilinear",
         geometry.rect_to_hex_plan(1080, 1920, 540, 960, "bilinear"),
         (1, 3), (torch.float32,), None, True),
        ("512^2 same-size hex->rect linear",
         geometry.hex_to_rect_plan(512, 512, 512, 512, "linear"), (1, 3),
         both, None, False),
    ]


def check_kernel_c(torch, gen):
    """Phase 8: shift_resample against its plain version.  Returns the
    summary over the main paths' shapes (720p b=1 and the mosaic, bf16):
    ``ms`` and ``plain_ms`` per call by CUDA events, as for every kernel,
    and ``graph_ms`` the kernel's device time alone."""
    from hygrid_tpu_torch.kernels import resample, resample_shift as rs
    from hygrid_tpu_torch.ops import sampling
    main = []
    for name, plan, lead, dtypes, path, shift in _shift_plans(torch):
        require(sampling.takes_shift_route(plan, 2) is shift,
                f"{name}: apply_plan_auto routes to "
                f"{'plan_gather' if shift else 'shift_resample'}")
        geo = rs.shift_decompose_cached(plan)
        x32 = torch.rand(lead + plan.src_shape, generator=gen, device="cuda")
        for dtype in dtypes:
            x = x32.to(dtype)
            got = rs.shift_resample(x, plan)
            want = rs.shift_resample_plain(x, plan)
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"shift_resample {name}: shape/dtype {got.shape} "
                    f"{got.dtype}")
            err, rel = max_err(got, want)
            if plan.exact_select:
                require(torch.equal(got, want),
                        f"shift_resample {name} {dtype}: not bit-equal")
            elif dtype == torch.float32:
                require(err <= TOL["a_f32_abs"],
                        f"shift_resample {name} f32: max abs err {err}")
            else:
                require(rel <= TOL["a_bf16_rel"],
                        f"shift_resample {name} bf16: relative err {rel}")
            ms = cuda_ms(torch, lambda: rs.shift_resample(x, plan))
            plain = cuda_ms(torch, lambda: rs.shift_resample_plain(x, plan))
            pg = cuda_ms(torch, lambda: resample.plan_gather(x, plan))
            dev = graph_ms(torch, lambda: rs.shift_resample(x, plan))
            pg_dev = graph_ms(torch, lambda: resample.plan_gather(x, plan))
            # what the function needs: the source, the output and the
            # plan's (idx, weights); the kernel's dense weight table is
            # its own overhead on top
            idx, wts = plan.tensors(x.device)
            moved = nbytes(x, got, idx, wts)
            b_ms, b_by = bound(moved, 2 * idx.shape[0] * got.numel(), "f32")
            line = (f"shift_resample {name} lead={lead} "
                    f"{str(dtype)[6:]}: slots={len(geo.slots)} "
                    f"num={geo.num} den={geo.den} ({geo.n_phases} phases) "
                    f"max_abs_err={err!r} rel={rel!r} per call (CUDA "
                    f"events): kernel_ms={ms!r} plain_ms={plain!r} "
                    f"plan_gather_ms={pg!r}; device alone (CUDA graph): "
                    f"kernel_ms={dev!r} plan_gather_ms={pg_dev!r}; "
                    f"bytes={moved} bound_ms={b_ms!r} ({b_by}); "
                    f"{table_note(geo, x.device)}")
            log(line)
            if path is not None and dtype == torch.bfloat16:
                main.append((err, ms, plain, dev, (b_ms, b_by)))
    return dict(max_abs_err=max(m[0] for m in main),
                ms=sum(m[1] for m in main), plain_ms=sum(m[2] for m in main),
                graph_ms=sum(m[3] for m in main),
                **summed_bound([m[4] for m in main]), library_ms=None)


def table_note(geo, device):
    """The kernel's weight table (its overhead on top of the function's
    bytes): its form and bytes, beside the bytes of the phase or dense
    float32 table that shift_decompose falls back to."""
    old = geo.wphase.nbytes if geo.phase_mode else geo.wplanes.nbytes
    return (f"weight table {geo.form} {geo.tensors(device)['table_bytes']} "
            f"bytes ({'phase' if geo.phase_mode else 'dense'} table {old} "
            f"bytes)")


def _bf16_ulp(torch, a, b):
    """Spacing of bfloat16 numbers at max(|a|, |b|), elementwise."""
    mag = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def run_video(torch):
    """Phase 9: the 720p video slice.  Returns the launches of the
    streamed run."""
    from hygrid_tpu_torch.models import video
    from hygrid_tpu_torch.nn import filters
    from hygrid_tpu_torch.ops import geometry, sampling
    h, w = 720, 1280
    proc = video.make_frame_processor(h, w)
    batch = video.make_batch_processor(h, w)
    rng = np.random.default_rng(4)
    frames = [rng.random((3, h, w), dtype=np.float32)
              for _ in range(VIDEO_FRAMES)]
    staged = [torch.from_numpy(f).cuda() for f in frames[:VIDEO_TIMED]]
    with torch.inference_mode():
        proc(staged[0])
        batch(torch.stack(staged[:MICROBATCH]))
        torch.cuda.synchronize()
        _zero_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for f in staged:
            proc(f)
        end.record()
        end.synchronize()
        dev_ms = start.elapsed_time(end) / VIDEO_TIMED
        got = _launches()
        require((got["shift_resample"], got["plan_gather"])
                == (VIDEO_TIMED, 0),
                f"video: {got['shift_resample']} shift_resample and "
                f"{got['plan_gather']} plan_gather launches for "
                f"{VIDEO_TIMED} frames")

        graph_frame_ms = graph_ms(torch, lambda: proc(staged[0]))
        runs = {}
        for label, processor, mb in (("per-frame", proc, 1),
                                     ("microbatch", batch, MICROBATCH)):
            # warm-up: pinned staging buffers and the stream's first calls
            list(video.process_stream(iter(frames[:2 * mb]), processor,
                                      microbatch=mb))
            stats = video.StreamStats()
            _zero_launches()
            outs = list(video.process_stream(iter(frames), processor, stats,
                                             depth=8, microbatch=mb))
            launches = {k: v for k, v in _launches().items()
                        if k in ("shift_resample", "plan_gather")}
            calls = -(-VIDEO_FRAMES // mb)
            require(launches == {"shift_resample": calls, "plan_gather": 0},
                    f"video {label} stream: launches {launches} for "
                    f"{calls} calls")
            require(stats.frames == len(outs) == VIDEO_FRAMES,
                    f"video {label} stream: {len(outs)} frames out")
            runs[label] = (outs, stats.fps, launches)

        plan = geometry.rect_to_hex_plan(h, w, h // 2, w // 2, "bilinear")
        taps = filters.hex_gaussian_kernel(1.0)
        worst = 0.0
        for i, (frame, out) in enumerate(zip(frames, runs["per-frame"][0])):
            require(out.shape == (3, h // 2, w // 2)
                    and out.dtype == torch.bfloat16,
                    f"video frame {i}: {tuple(out.shape)} {out.dtype}")
            x = torch.from_numpy(frame).cuda()[None]
            ref = filters.hex_filter(sampling.apply_plan(x, plan), taps)[0]
            rel = max_err(out, ref)[1]
            worst = max(worst, rel)
            require(rel <= TOL["video_rel"],
                    f"video frame {i} vs plain f32: relative err {rel}")
        for i, (a, b) in enumerate(zip(runs["microbatch"][0],
                                       runs["per-frame"][0])):
            require(bool(((a.float() - b.float()).abs()
                          <= _bf16_ulp(torch, a, b)).all()),
                    f"video frame {i}: microbatched differs from per-frame "
                    f"by more than one bf16 ulp")
    log(f"video 720p bf16 hex 640x360 + 7-tap Gaussian: device "
        f"{dev_ms!r} ms/frame over {VIDEO_TIMED} pre-staged frames "
        f"(fps={1e3 / dev_ms!r}), {graph_frame_ms!r} ms/frame on the device "
        f"alone (CUDA graph); process_stream(depth=8) "
        f"{VIDEO_FRAMES} numpy f32 frames: fps={runs['per-frame'][1]!r}, "
        f"microbatch={MICROBATCH}: fps={runs['microbatch'][1]!r}; "
        f"launches per-frame {runs['per-frame'][2]}, microbatch "
        f"{runs['microbatch'][2]}; worst frame vs plain f32 rel={worst!r}")
    return runs["per-frame"][2]


def run_mosaic(torch):
    """Phase 10: the 4K mosaic slice.  Returns the launches of the timed
    renders."""
    from hygrid_tpu_torch.kernels import resample, resample_shift as rs
    from hygrid_tpu_torch.ops import sampling
    from hygrid_tpu_torch.viz import render
    out_size = (2160, 3840)
    gen = torch.Generator(device="cuda").manual_seed(5)
    img32 = torch.rand((3, 540, 960), generator=gen, device="cuda") * 255
    img8 = img32.to(torch.uint8)
    plan = render._mosaic_sample_plan(540, 960, *out_size, 0, None)
    launches = {"shift_resample": 0, "plan_gather": 0}
    line = "mosaic 540x960 -> 2160x3840 C=3:"
    with torch.inference_mode():
        for img in (img32, img8):
            render.render_mosaic(img, out_size)
            torch.cuda.synchronize()
            _zero_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(MOSAIC_RENDERS):
                frame = render.render_mosaic(img, out_size)
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end) / MOSAIC_RENDERS
            got = _launches()
            require((got["shift_resample"], got["plan_gather"])
                    == (MOSAIC_RENDERS, 0),
                    f"mosaic {img.dtype}: {got['shift_resample']} "
                    f"shift_resample and {got['plan_gather']} plan_gather "
                    f"launches for {MOSAIC_RENDERS} renders")
            launches["shift_resample"] += got["shift_resample"]
            want = sampling.apply_plan(
                img.to(torch.bfloat16) if img.dtype == torch.float32
                else img, plan).to(img.dtype)
            require(frame.dtype == img.dtype and torch.equal(frame, want),
                    f"mosaic {img.dtype}: not bit-equal to the plain gather")
            line += (f" {str(img.dtype)[6:]} {ms!r} ms/frame "
                     f"(fps={1e3 / ms!r}), bit-equal;")
        # the render's kernel call (on the bf16 frame) on the device alone
        xb = img32.to(torch.bfloat16)
        dev = graph_ms(torch, lambda: rs.shift_resample(xb, plan))
        pg_dev = graph_ms(torch, lambda: resample.plan_gather(xb, plan))
    log(line + f" launches {launches}; device alone (CUDA graph, bf16): "
        f"shift_resample_ms={dev!r} plan_gather_ms={pg_dev!r}; "
        f"{table_note(rs.shift_decompose_cached(plan), img32.device)}")
    return launches


# the bench.py pipeline (the north star): bench.py's own size and a 4K
# frame; the 11-layer C=16 stack is bench.py's (layers=10 plus the
# projection)
PIPE_CHANNELS, PIPE_LAYERS, PIPE_RADIUS = 16, 10, 2
PIPELINES = [("P-512", 16, (512, 512), False),
             ("P-512 fused", 16, (512, 512), True),
             ("P-4K", 1, (2160, 3840), False)]
PIPE_CALLS = 8


def build_pipeline(shape, channels, layers, radius, dtype, *, fused=False,
                   plain=False, device="cuda"):
    """``bench.py::build_pipeline`` composed from the port's public
    functions, with bench.py's weights (numpy ``default_rng(0)``, drawn in
    its order).  rect->hex bilinear to half of ``shape``; channels padded
    from 3 to ``channels``; ``hex_conv_stack`` of ``layers + 1`` layers
    without norms or biases (a stem whose inputs >= 3 are zero,
    ``layers - 1`` full layers, a projection whose outputs >= 3 are zero;
    ReLU on all but the last), ``fused`` as given; the first 3 channels;
    hex->rect linear back to ``shape``, in float32.  ``plain=True`` runs the
    plain versions (``apply_plan``, plain layers) on any device.  Returns
    ``(pipeline, kernels)``."""
    import torch
    from hygrid_tpu_torch.kernels.conv_stack import hex_conv_stack
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    from hygrid_tpu_torch.ops import geometry, sampling
    h, w = shape
    rng = np.random.default_rng(0)
    kn = hex_kernel_num(radius)
    stem = np.zeros((channels, channels, kn), np.float32)
    stem[:, :3] = rng.normal(0, 0.1, (channels, 3, kn))
    draws = [stem] + [rng.normal(0, 0.1, (channels, channels, kn))
                      for _ in range(layers - 1)]
    proj = np.zeros((channels, channels, kn), np.float32)
    proj[:3] = rng.normal(0, 0.1, (3, channels, kn))
    draws.append(proj)
    kernels = [torch.as_tensor(k, dtype=torch.float32).to(device=device,
                                                          dtype=dtype)
               for k in draws]

    def pipeline(x):
        x = x.to(dtype)
        if plain:
            hexed = sampling.apply_plan(x, geometry.rect_to_hex_plan(
                h, w, h // 2, w // 2, "bilinear"))
        else:
            hexed = geometry.rect_to_hex_resample(x, (h // 2, w // 2),
                                                  "bilinear")
        v = torch.nn.functional.pad(hexed, (0, 0, 0, 0, 0, channels - 3))
        v = hex_conv_stack(v, kernels, None, radius=radius,
                           final_activation=False, fused=fused,
                           plain=plain)[:, :3]
        if plain:
            out = sampling.apply_plan(v, geometry.hex_to_rect_plan(
                h // 2, w // 2, h, w, "linear"))
        else:
            out = geometry.hex_to_rect_resample(v, (h, w), "linear")
        return out.float()

    return pipeline, kernels


def set_conv_impl(model, impl):
    """Switch every ``HexConv2d`` of ``model`` to ``hex_conv2d(impl=impl)``:
    the same layers ``HexConvModule(conv_cfg=dict(type="HexConv2d",
    impl=impl))`` builds.  Returns ``model``."""
    from hygrid_tpu_torch.nn import HexConv2d
    for mod in model.modules():
        if isinstance(mod, HexConv2d):
            mod.impl = impl
    return model


def build_permodule_hexcnn(*, impl="pallas", device="cuda", generator=None,
                           **kw):
    """The per-module HexCNN route on the single-op conv kernel: the model
    users build, ``hexcnn_small(norm="BN", **kw)`` (per stage ``depth``
    ``HexConvModule`` conv -> BN -> ReLU bundles, a hex max-pool 2x2/2
    between stages, global average pool, linear head), with each
    ``HexConv2d`` on ``impl``.  Its forward is HexCNN's own, so it differs
    from route (a) only in the conv."""
    from hygrid_tpu_torch.models import hexcnn_small
    return set_conv_impl(hexcnn_small(norm="BN", device=device,
                                      generator=generator, **kw), impl)


def check_tiers(torch, gen):
    """Phase 11: the TPU's banded and phased tiers, which compute what the
    port's kernels compute, checked at the shapes they served: the P-4K
    stack layer (#9, on hex_conv_layer) and, on plan_gather
    (check_gather), P-4K's two legs (the rect->hex one is #2's plan;
    shift_resample beside it), a 3-phase plan under 8 MiB (#3) and the
    resample4k plan (#4)."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    from hygrid_tpu_torch.kernels import resample_shift as rs
    from hygrid_tpu_torch.ops import geometry, sampling
    both = (torch.float32, torch.bfloat16)
    x32 = torch.rand((1, 1080, 1920, 16), generator=gen, device="cuda")
    k32 = torch.randn((16, 16, 7), generator=gen, device="cuda") / math.sqrt(
        16 * 7)
    line = ("tier #9 (hex_conv_layer) P-4K stack layer 1x1080x1920 16->16, "
            "no norm, no bias, ReLU:")
    for dtype in both:
        x, k = x32.to(dtype), k32.to(dtype)

        def kernel():
            return cs.hex_conv_layer(x, k, radius=2, relu=True)

        def plain():
            return cs.hex_conv_layer_plain(x, k, radius=2, relu=True)

        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err, rel = max_err(got, want)
        tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
        require(rel <= tol, f"tier #9 {dtype}: relative err {rel} > {tol}")
        ms = cuda_ms(torch, kernel, iters=5)
        pms = cuda_ms(torch, plain, iters=5)
        lms, lms_rng = cudnn_ms(torch, x, k)
        flops = 2 * 7 * x.numel() * 16
        b_ms, b_by = bound(nbytes(x, k, got), flops,
                           "bf16" if dtype == torch.bfloat16 else "f32")
        line += (f" {str(dtype)[6:]} max_abs_err={err!r} rel={rel!r} "
                 f"kernel_ms={ms!r} ({tflops(flops, ms)!r} TFLOP/s) "
                 f"plain_ms={pms!r} cudnn_conv_ms={lms!r} "
                 f"(range {lms_rng}) "
                 f"bound_ms={b_ms!r} ({b_by});")
        if dtype == torch.bfloat16:
            line += f" {mma_note(16, 16)};"
    log(line)

    t0 = time.perf_counter()
    plans = [
        ("#2 P-4K rect->hex 2160x3840->1080x1920 bilinear",
         geometry.rect_to_hex_plan(2160, 3840, 1080, 1920, "bilinear"),
         (1, 3), True),
        ("P-4K hex->rect 1080x1920->2160x3840 linear",
         geometry.hex_to_rect_plan(1080, 1920, 2160, 3840, "linear"), (1, 3),
         False),
        ("#3 512^2 same-size hex->rect linear",
         geometry.hex_to_rect_plan(512, 512, 512, 512, "linear"), (16, 3),
         False),
        ("#4 resample4k 4K->4K hex->rect linear",
         geometry.hex_to_rect_plan(2160, 3840, 2160, 3840, "linear"), (3,),
         False),
    ]
    log(f"tier plans built in {time.perf_counter() - t0:.1f} s (numpy)")
    for name, plan, lead, factored in plans:
        x32 = torch.rand(lead + plan.src_shape, generator=gen, device="cuda")
        for dtype in both:
            x = x32.to(dtype)
            require(not sampling.takes_shift_route(plan, x.element_size()),
                    f"tier {name}: routed to shift_resample")
            check_gather(torch, f"tier {name} lead={lead}", plan, x,
                         factored)
            if name.startswith("#2"):
                # ROADMAP item 12b: the shift kernel on the same plan
                log(f"tier {name} {str(dtype)[6:]}: shift_resample "
                    f"kernel_ms="
                    f"{cuda_ms(torch, lambda: rs.shift_resample(x, plan))!r}"
                    f" device_ms="
                    f"{graph_ms(torch, lambda: rs.shift_resample(x, plan))!r}")


def check_fused(torch, gen):
    """Phase 12: hex_conv_fused_stack and chained hex_conv_layer launches
    against the plain version at the P-512 stack, and against each other
    (bit for bit in float32 and bfloat16), with the tile the C side chose
    (held to its invariants in bfloat16).  Returns the bf16
    summary for the kernels line, with the float32 one under ``f32``."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    b, h, w, c = 16, 256, 256, PIPE_CHANNELS
    x32 = torch.rand((b, h, w, c), generator=gen, device="cuda")
    summary = f32 = None
    line = f"fused stack P-512 {b}x{h}x{w}x{c}, {PIPE_LAYERS + 1} layers:"
    for dtype in (torch.float32, torch.bfloat16):
        _, ks = build_pipeline((512, 512), c, PIPE_LAYERS, PIPE_RADIUS, dtype)
        x = x32.to(dtype)
        relus = [True] * (len(ks) - 1) + [False]

        def fused():
            return cs.hex_conv_fused_stack(x, ks, radius=PIPE_RADIUS,
                                           relus=relus)

        def chained():
            v = x
            for k, relu in zip(ks, relus):
                v = cs.hex_conv_layer(v, k, radius=PIPE_RADIUS, relu=relu)
            return v

        def plain():
            return cs.hex_conv_fused_stack_plain(
                x, ks, [None] * len(ks), radius=PIPE_RADIUS, relus=relus)

        got, ch, want = fused(), chained(), plain()
        torch.cuda.synchronize()
        err, rel = max_err(got, want)
        tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
        require(rel <= tol, f"fused stack {dtype}: relative err {rel} > {tol}")
        ch_rel = max_err(ch, want)[1]
        require(ch_rel <= tol, f"chained hex_conv_layer {dtype}: relative "
                               f"err {ch_rel} > {tol}")
        plan = dict(cs.LAST_FUSED_PLAN)
        equal = torch.equal(got, ch)
        cross = cross_kernel_note(got, ch)
        log(f"fused stack vs chained hex_conv_layer {str(dtype)[6:]}: "
            f"bit-equal={equal} {cross}; tile: {plan['n']} channels x "
            f"{plan['rows']} rows, {plan['threads']} threads, grid "
            f"{plan['grid']} ({plan['blocks_per_sm']} blocks an SM), "
            f"{plan['smem']} bytes of shared memory, weights "
            f"{plan['weights']}, batch group {plan['group']}")
        # the same tile and order as kernel B's in each dtype (the CUDA-core
        # tile in float32, the tensor-core tile on row bands in bfloat16)
        require(equal, f"fused stack {dtype}: differs from chained "
                       f"hex_conv_layer ({cross})")
        if dtype == torch.bfloat16:
            # C = 16: N = 16, RW = 4 rows a warpgroup, one layer's weights
            # staged a block, within a block's 227 KB
            require(plan["n"] == 16 and plan["rows"] == 4 * plan["threads"]
                    // 128 and plan["weights"] == "layer"
                    and plan["smem"] <= cs._MMA_MAX_SMEM,
                    f"fused stack bf16: the C side's tile {plan} breaks "
                    f"the tile's invariants")
        ms = cuda_ms(torch, fused, iters=5)
        cms = cuda_ms(torch, chained, iters=5)
        pms = cuda_ms(torch, plain, iters=3)
        b_ms, b_by = bound(nbytes(x, got, *ks),
                           2 * ks[0].shape[-1] * x.numel() * c * len(ks),
                           "bf16" if dtype == torch.bfloat16 else "f32")
        line += (f" {str(dtype)[6:]} max_abs_err={err!r} rel={rel!r} "
                 f"bit-equal to chained={equal} kernel_ms={ms!r} "
                 f"chained_ms={cms!r} plain_ms={pms!r} bound_ms={b_ms!r} "
                 f"({b_by}), rows={plan['rows']} grid={plan['grid']} "
                 f"smem={plan['smem']} weights={plan['weights']};")
        if dtype == torch.bfloat16:
            summary = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                           **summed_bound([(b_ms, b_by)]), library_ms=None,
                           f32=f32)
        else:
            f32 = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                       chained_ms=cms, **summed_bound([(b_ms, b_by)]),
                       library_ms=None, tile=plan)
    log(line)
    return summary


def _profiled_kernels(torch, fn, ops=False):
    """``[(kernel name, device us)]`` of one ``fn`` call, from
    torch.profiler, largest first; with ``ops``, the host-side ops (aten
    ops, autograd nodes) by the device time of the kernels each launched
    itself."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()

    def dev(e):
        return getattr(e, "self_device_time_total", 0) or 0

    # kernels only, or ops only: an op carries its kernels' time too
    return sorted(((e.key, dev(e)) for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA") != ops
                   and dev(e) > 0),
                  key=lambda kv: kv[1], reverse=True)


def _profile_split(torch, fn, call_ms, groups=None):
    """Device time of one ``fn`` call by kernel, from torch.profiler, and
    the share of ``call_ms`` (the call's time by CUDA events) that no
    kernel ran.  ``groups``, ``[(label, predicate on the kernel name)]``,
    sums the kernels by the first group whose predicate holds ("other"
    for none) before the six largest kernels are listed."""
    kernels = _profiled_kernels(torch, fn)
    total = sum(us for _, us in kernels)
    if not total:
        return "no device time in the profile"
    head = (f"kernels {total / 1e3!r} ms of {call_ms!r} ms a call (idle "
            f"{100 * (1 - total / 1e3 / call_ms):.2f} %): ")
    if groups:
        sums = dict.fromkeys([label for label, _ in groups] + ["other"], 0)
        for key, us in kernels:
            sums[next((label for label, hit in groups if hit(key)),
                      "other")] += us
        head += ", ".join(f"{label} {us / 1e3!r} ms "
                          f"({100 * us / total:.2f} %)"
                          for label, us in sums.items()) + "; largest: "
    return head + ", ".join(f"{key[:48]} {us / 1e3!r} ms "
                            f"({100 * us / total:.2f} %)"
                            for key, us in kernels[:6])


def _run_pipeline(torch, name, batch, shape, fused):
    """One configuration of phase 13; returns its launches.  A function of
    its own, so that one configuration's tensors are freed before the
    next one's peak memory is read."""
    t0 = time.perf_counter()
    pipe, _ = build_pipeline(shape, PIPE_CHANNELS, PIPE_LAYERS, PIPE_RADIUS,
                             torch.bfloat16, fused=fused)
    ref, _ = build_pipeline(shape, PIPE_CHANNELS, PIPE_LAYERS, PIPE_RADIUS,
                            torch.float32, plain=True)
    gen = torch.Generator(device="cuda").manual_seed(6)
    xs = [torch.rand((batch, 3) + shape, generator=gen, device="cuda")
          for _ in range(PIPE_CALLS + 1)]
    with torch.inference_mode():
        pipe(xs[0])                     # plans, device copies, the build
        torch.cuda.synchronize()
        setup = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = [pipe(x) for x in xs[1:]]
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / PIPE_CALLS
        peak = torch.cuda.max_memory_allocated()
        launches = {k: v for k, v in _launches().items()
                    if k in ("plan_gather", "shift_resample",
                             "hex_conv_layer", "hex_conv_fused_stack")}
        n_layers = PIPE_LAYERS + 1
        want = {"plan_gather": 2, "shift_resample": 0,
                "hex_conv_layer": 0 if fused else n_layers,
                "hex_conv_fused_stack": 1 if fused else 0}
        require(launches == {k: v * PIPE_CALLS for k, v in want.items()},
                f"pipeline {name}: launches {launches} in {PIPE_CALLS} "
                f"calls, want {want} per call")
        for i, out in enumerate(outs):
            require(out.shape == (batch, 3) + shape
                    and out.dtype == torch.float32
                    and bool(torch.isfinite(out).all()),
                    f"pipeline {name} call {i}: {tuple(out.shape)} "
                    f"{out.dtype} or non-finite")
        require(not torch.equal(outs[0], outs[1]),
                f"pipeline {name}: distinct inputs gave equal outputs")
        err, rel = max_err(outs[0], ref(xs[1]))
        require(rel <= TOL["slice_rel"],
                f"pipeline {name} vs plain f32: relative err {rel}")
        split = (_profile_split(torch, lambda: pipe(xs[1]), ms)
                 if name == "P-4K" else None)
        graph = None
        if name != "P-4K":
            # the same call with the host's dispatch left out (ROADMAP item
            # 23): one input, replayed in a CUDA graph
            try:
                graph = f"{graph_ms(torch, lambda: pipe(xs[1]), iters=4)!r} ms"
            except RuntimeError as e:
                graph = f"not captured ({str(e).splitlines()[0][:160]})"
    mpix = batch * shape[0] * shape[1] / 1e6
    log(f"pipeline {name} b={batch} {shape[0]}x{shape[1]} bf16: {ms!r} ms "
        f"a call over {PIPE_CALLS} distinct inputs (CUDA events), "
        f"Mpix/s={mpix / (ms / 1e3)!r}, calls/s={1e3 / ms!r}; "
        f"peak_mem_bytes={peak} (the {PIPE_CALLS + 1} inputs and "
        f"{PIPE_CALLS} outputs included); set-up {setup:.1f} s; "
        f"launches={launches}; vs plain f32 max_abs_err={err!r} "
        f"rel={rel!r}" + (f"; one call replayed in a CUDA graph (device "
                          f"alone): {graph}" if graph else ""))
    if split:
        log(f"pipeline {name} torch.profiler, one call: {split}")
    return launches


def run_pipelines(torch):
    """Phase 13: the north-star pipeline end to end, P-512 unfused and
    fused, and P-4K.  Returns the launches per path."""
    return {name: _run_pipeline(torch, name, batch, shape, fused)
            for name, batch, shape, fused in PIPELINES}


# the per-module route: HexCNN-small with BN, served in float32.  The five
# convs after the stem take hex_conv2d(impl="pallas")'s kernel; (Cin, Cout,
# H, W) of their unpadded inputs (padding 1 each)
PERMODULE = [("BN-512", 32, 512), ("BN-CIFAR", 256, 32)]
SINGLE_LAYERS = {
    "BN-512": [(32, 32, 256, 256), (32, 64, 128, 127), (64, 64, 128, 127),
               (64, 128, 64, 63), (128, 128, 64, 63)],
    "BN-CIFAR": [(32, 32, 16, 16), (32, 64, 8, 7), (64, 64, 8, 7),
                 (64, 128, 4, 3), (128, 128, 4, 3)],
}
SINGLE_TOL = {"f32_rel": 1e-4, "bf16_rel": 3e-2, "logits_rel": 1e-3}
# phase 15 times each route over windows of at least this many ms, the
# routes alternating; the spread of the windows is printed
PERMODULE_WINDOW_MS = 1000.0
PERMODULE_WINDOWS = 3
# hygrid_tpu's _CONV_BAND_THRESHOLD (conv_pallas.py:65): padded inputs of
# more elements ran the banded TPU kernel (#8), others #7 (labels only)
TPU_BAND_THRESHOLD = 2 ** 23


def check_single(torch, gen):
    """Phase 14: hex_conv_single against its plain version at the per-module
    route's layer shapes (BN-512 in float32 and bfloat16, BN-CIFAR in
    float32), at odd input parity, dilation 2 and radius 3; at BN-512's
    first layer a band_rows=32 call bit for bit, and on the input padded by
    r-1 hex_conv_layer (kernel B, no norm, no ReLU) bit for bit in both
    dtypes (bfloat16: both on the tensor-core tile).  Beside each time: the
    plain version's and cuDNN's (hex_conv2d(impl="direct") in the
    activations' dtype; the plain version computes in float32), the bound,
    TFLOP/s and, in bfloat16, the tile's N and HGMMA/HMMA count; then the
    sums over each configuration's five layers.  Returns the BN-512 float32
    summary for the kernels line (the dtype phase 15 serves in)."""
    from hygrid_tpu_torch.kernels import conv_single as cs
    from hygrid_tpu_torch.kernels import conv_stack
    from hygrid_tpu_torch.nn import functional as F
    summary = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, cudnn_direct_ms=0.0)
    bounds = []

    def case(label, batch, cin, cout, h, w, dtype, radius=2, dilation=1,
             offset=0, iters=5):
        kn = F.hex_kernel_num(radius)
        pad = dilation * (radius - 1)
        x = torch.rand((batch, cin, h, w), generator=gen,
                       device="cuda").to(dtype)
        k = (torch.randn((cout, cin, kn), generator=gen, device="cuda")
             / math.sqrt(cin * kn)).to(dtype)
        kw = dict(even_odd_offset=offset, radius=radius, padding=pad,
                  dilation=dilation)
        got = cs.hex_conv_single(x, k, **kw)
        want = cs.hex_conv_single_plain(x, k, **kw)
        torch.cuda.synchronize()
        require(got.shape == want.shape and got.dtype == dtype,
                f"hex_conv_single {label}: {tuple(got.shape)} {got.dtype}")
        err, rel = max_err(got, want)
        tol = SINGLE_TOL["f32_rel" if dtype == torch.float32 else "bf16_rel"]
        require(rel <= tol, f"hex_conv_single {label} {dtype}: relative err "
                            f"{rel} > {tol}")
        ms = cuda_ms(torch, lambda: cs.hex_conv_single(x, k, **kw),
                     iters=iters)
        pms = cuda_ms(torch, lambda: cs.hex_conv_single_plain(x, k, **kw),
                      iters=iters)
        dms = cuda_ms(torch, lambda: F.hex_conv2d(x, k, impl="direct", **kw),
                      iters=iters)
        ho, wo = got.shape[-2:]
        n_in = batch * cin * (h + 2 * pad) * (w + 2 * pad)  # padded input
        flops = 2 * kn * batch * cin * cout * ho * wo
        b_ms, b_by = bound(nbytes(x, k, got), flops,
                           "bf16" if dtype == torch.bfloat16 else "f32")
        note = (f" {single_mma_note(cin, cout, radius, dilation)};"
                if dtype == torch.bfloat16 else "")
        log(f"hex_conv_single {label} {cin}->{cout} {h}x{w} b={batch} "
            f"r={radius} d={dilation} offset={offset} {str(dtype)[6:]}: "
            f"max_abs_err={err!r} rel={rel!r} kernel_ms={ms!r} "
            f"({tflops(flops, ms)!r} TFLOP/s) "
            f"plain_ms={pms!r} cudnn_direct_ms={dms!r} bound_ms={b_ms!r} "
            f"({b_by});{note} TPU kernel "
            f"{'#8' if n_in > TPU_BAND_THRESHOLD else '#7'}")
        return x, k, kw, err, ms, pms, dms, (b_ms, b_by)

    def cross_check(x, k, kw, dtype):
        """band_rows=32 and kernel B on the 'same' conv of the same input."""
        got = cs.hex_conv_single(x, k, **kw)
        banded = cs.hex_conv_single(x, k, band_rows=32, **kw)
        layer = conv_stack.hex_conv_layer(
            x.permute(0, 2, 3, 1).contiguous(), k, radius=kw["radius"]
        ).permute(0, 3, 1, 2)
        torch.cuda.synchronize()
        require(torch.equal(banded, got),
                f"hex_conv_single band_rows=32 {dtype}: differs")
        diff, diff_rel = max_err(got, layer)
        want = cs.hex_conv_single_plain(x, k, **kw)
        layer_rel = max_err(layer, want)[1]
        require(layer_rel <= SINGLE_TOL["f32_rel" if dtype == torch.float32
                                        else "bf16_rel"],
                f"hex_conv_layer on the 'same' conv {dtype}: relative err "
                f"{layer_rel}")
        log(f"hex_conv_single vs hex_conv_layer ('same' conv, the input "
            f"padded by {kw['padding']}, {tuple(x.shape)}) {str(dtype)[6:]}: "
            f"bit-equal={torch.equal(got, layer)} "
            f"{cross_kernel_note(got, layer)}; hex_conv_layer vs plain "
            f"rel={layer_rel!r}; band_rows=32 bit-equal to unbanded")
        # one tile and one K order in each dtype: bit for bit
        require(torch.equal(got, layer),
                f"hex_conv_single {dtype}: differs from hex_conv_layer by "
                f"{diff} ({diff_rel} of max|out|)")

    sums = {}     # (config, dtype) -> [ms, plain ms, cuDNN ms, bounds]
    for config, layers in SINGLE_LAYERS.items():
        batch = dict((n, b) for n, b, _ in PERMODULE)[config]
        dtypes = ((torch.float32, torch.bfloat16) if config == "BN-512"
                  else (torch.float32,))
        for li, (cin, cout, h, w) in enumerate(layers):
            for dtype in dtypes:
                x, k, kw, err, ms, pms, dms, b = case(
                    f"{config} L{li + 1}", batch, cin, cout, h, w, dtype)
                if config == "BN-512" and li == 0:
                    cross_check(x, k, kw, dtype)
                acc = sums.setdefault((config, str(dtype)[6:]),
                                      [0.0, 0.0, 0.0, []])
                acc[0] += ms
                acc[1] += pms
                acc[2] += dms
                acc[3].append(b)
                if config == "BN-512" and dtype == torch.float32:
                    summary["max_abs_err"] = max(summary["max_abs_err"], err)
                    summary["ms"] += ms
                    summary["plain_ms"] += pms
                    summary["cudnn_direct_ms"] += dms
                    bounds.append(b)
    for (config, dt), (ms, pms, dms, bs) in sums.items():
        log(f"hex_conv_single {config} {dt}, five layers: kernel_ms={ms!r} "
            f"plain_ms={pms!r} cudnn_direct_ms={dms!r} "
            f"bound_ms={summed_bound(bs)['bound_ms']!r}")
    for dtype in (torch.float32, torch.bfloat16):
        case("odd parity", 8, 32, 64, 64, 63, dtype, offset=1)
        case("dilation 2", 8, 32, 64, 64, 63, dtype, dilation=2)
        case("radius 3", 8, 32, 64, 64, 63, dtype, radius=3, offset=1)
    summary.update(summed_bound(bounds),
                   library_ms=summary["cudnn_direct_ms"])
    return summary


def _bn_stats(torch, model, gen):
    """BN running statistics (and affine) drawn from ``gen``, variances
    positive, so that no BN is the identity."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen,
                                            device=buf.device))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen,
                                           device=buf.device))
        for name, p in model.named_parameters():
            if ".norm." in name:
                p.add_(0.1 * torch.randn(p.shape, generator=gen,
                                         device=p.device))


def _time_route(torch, serve, xs, n):
    """Milliseconds a request, by CUDA events around ``n`` requests that
    cycle over the distinct inputs ``xs``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n):
        serve(xs[i % len(xs)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def _timed_windows(torch, routes, xs, first_ms):
    """``(n, {route: [ms a request per window]})``: ``PERMODULE_WINDOWS``
    windows of ``n`` requests per route by CUDA events, the routes
    alternating.  ``routes`` maps a name to ``(prepare, serve)``;
    ``prepare()`` runs before each of the route's windows, untimed.  ``n``
    starts from ``first_ms`` (a request's time by the host clock) and
    grows, and the windows are timed again, until every window lasts at
    least ``PERMODULE_WINDOW_MS``."""
    n = max(N_REQUESTS, math.ceil(PERMODULE_WINDOW_MS / first_ms))
    while True:
        times = {route: [] for route in routes}
        for _ in range(PERMODULE_WINDOWS):
            for route, (prepare, serve) in routes.items():
                prepare()
                times[route].append(_time_route(torch, serve, xs, n))
        shortest = n * min(min(t) for t in times.values())
        if shortest >= PERMODULE_WINDOW_MS:
            return n, times
        n = math.ceil(n * 1.1 * PERMODULE_WINDOW_MS / shortest)


KERNELS = {"plan_gather": "plan_gather",
           "shift_resample": "shift_resample",
           "hex_conv_layer": "hex_conv_layer",
           "hex_conv_layer_split": "hex_conv_layer_split",
           "hex_conv_layer_dgrad": "hex_conv_layer_dgrad",
           "hex_conv_wgrad": "hex_conv_layer_wgrad",
           "hex_conv_layer_split_dgrad": "hex_conv_layer_split_dgrad",
           "hex_conv_wgrad_split": "hex_conv_layer_split_wgrad",
           "gn_relu_backward": "gn_relu_backward",
           "hex_conv_fused_stack": "hex_conv_fused_stack",
           "hex_conv_single": "hex_conv_single",
           "hex_max_pool": "hex_max_pool",
           "hex_max_pool_backward": "hex_max_pool_backward"}
"""Every kernel's launch counter: ``{label on this script's lines: its
name in hygrid_tpu_torch.utils.profiling.counts()}``."""
_LAUNCH_ZERO: dict = {}


def _zero_launches():
    """Count kernel launches from here on (:func:`_launches`)."""
    from hygrid_tpu_torch.utils.profiling import counts
    _LAUNCH_ZERO.clear()
    _LAUNCH_ZERO.update(counts())


def _launches() -> dict:
    """Every kernel's launches since the last :func:`_zero_launches`, by
    label (:data:`KERNELS`)."""
    from hygrid_tpu_torch.utils.profiling import counts
    now = counts()
    return {label: now.get(name, 0) - _LAUNCH_ZERO.get(name, 0)
            for label, name in KERNELS.items()}


def _run_permodule(torch, config, batch, size):
    """One configuration of phase 15: one ``hexcnn_small(norm="BN")``
    served on route (a), its convs as users build them, and on route (b),
    the same model with its convs on the single-op kernel.  Each route's
    launches, logits and peak memory come from ``N_REQUESTS`` distinct
    requests; its images/s from ``PERMODULE_WINDOWS`` windows of at least
    ``PERMODULE_WINDOW_MS`` each, the routes alternating.  Returns the
    launches per route."""
    from hygrid_tpu_torch.models import hexcnn_small, hexify_batch
    gen = torch.Generator(device="cuda").manual_seed(7)
    model = hexcnn_small(norm="BN", device="cuda", generator=gen).eval()
    _bn_stats(torch, model, gen)
    impls = {"a": "auto", "b": "pallas"}

    def serve(x):
        return model(hexify_batch(x))

    in_gen = torch.Generator(device="cuda").manual_seed(8)
    xs = [torch.rand((batch, 3, size, size), generator=in_gen,
                     device="cuda") for _ in range(N_REQUESTS + 1)]
    counters = KERNELS
    per_request = {"a": {"plan_gather": 1}, "b": {"plan_gather": 1,
                                                  "hex_conv_single": 5}}
    launches, first_ms, reports = {}, {}, {}
    with torch.inference_mode():
        set_conv_impl(model, "auto")
        ref = model(hexify_batch(xs[1], plain=True))
        for route, impl in impls.items():
            set_conv_impl(model, impl)
            serve(xs[0])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_launches()
            t0 = time.perf_counter()
            outs = [serve(x) for x in xs[1:]]
            torch.cuda.synchronize()
            first_ms[route] = (time.perf_counter() - t0) * 1e3 / N_REQUESTS
            peak = torch.cuda.max_memory_allocated()
            got = _launches()
            want = {name: per_request[route].get(name, 0) * N_REQUESTS
                    for name in counters}
            require(got == want, f"{config} route ({route}): launches "
                                 f"{got}, want {want}")
            got = {k: v for k, v in got.items() if v}
            for i, out in enumerate(outs):
                require(out.shape == (batch, 10) and out.dtype == torch.float32
                        and bool(torch.isfinite(out).all()),
                        f"{config} ({route}) request {i}: "
                        f"{tuple(out.shape)} {out.dtype} or non-finite")
            require(not torch.equal(outs[0], outs[1]),
                    f"{config} ({route}): distinct requests, equal logits")
            err, rel = max_err(outs[0], ref)
            require(rel <= SINGLE_TOL["logits_rel"],
                    f"{config} ({route}) vs plain f32: relative err {rel}")
            launches[f"{config} ({route})"] = got
            reports[route] = (f"peak_mem_bytes={peak}; launches={got}; "
                              f"logits vs plain f32 max_abs_err={err!r} "
                              f"rel={rel!r}")
        n, times = _timed_windows(
            torch, {route: (functools.partial(set_conv_impl, model, impl),
                            serve) for route, impl in impls.items()},
            xs[1:], min(first_ms.values()))
        for route, impl in impls.items():
            set_conv_impl(model, impl)
            ms = sorted(times[route])
            med = ms[len(ms) // 2]
            log(f"per-module {config} route ({route}) HexCNN-small BN f32 "
                f"b={batch} {size}^2: {med!r} ms a request, median of "
                f"{PERMODULE_WINDOWS} windows of {n} requests cycling over "
                f"{N_REQUESTS} distinct inputs (CUDA events; windows "
                f"{[round(t * n) for t in times[route]]} ms), images/s="
                f"{batch / (med / 1e3)!r} (windows {min(ms)!r}-{max(ms)!r} "
                f"ms: {batch / (ms[-1] / 1e3)!r}-{batch / (ms[0] / 1e3)!r}); "
                f"{reports[route]}")
            split = _profile_split(torch, lambda: serve(xs[1]), med)
            log(f"per-module {config} route ({route}) torch.profiler, one "
                f"request: {split}")
    return launches


def run_permodule(torch):
    """Phase 15: the per-module route, BN-512 and BN-CIFAR, each served as
    users build it (a: hexcnn_small(norm="BN"), convs impl="auto") and on
    the kernel route (b: build_permodule_hexcnn, impl="pallas")."""
    launches = {}
    for config, batch, size in PERMODULE:
        launches.update(_run_permodule(torch, config, batch, size))
    return launches


# HexUNet-small (benchmarks/suite.py::bench_hexunet): b=8 512^2 RGB -> 256^2
# hex; the decoder's skip-join layers (name, B, H, W, Ca, Cb, Cout, GN);
# the last case's 16-channel staging chunk straddles the two inputs
UNET_BATCH = 8
UNET_SIZE = 512    # phase 19's rect input
SPLIT_LAYERS = [("dec0", UNET_BATCH, 128, 127, 64, 64, 64, True),
                ("dec1", UNET_BATCH, 256, 256, 32, 32, 32, True),
                ("straddle", UNET_BATCH, 128, 127, 24, 8, 32, False)]
# HexUNet-small's GN layers (name, Cout, H, W): the encoder's three and
# the decoder's two split layers
UNET_GN_LAYERS = [("enc0", 32, 256, 256), ("enc1", 64, 128, 127),
                  ("enc2", 128, 64, 63), ("dec0", 64, 128, 127),
                  ("dec1", 32, 256, 256)]


def check_split(torch, gen):
    """Phase 16: the split layer against its plain version and bit-equal
    to kernel B on the concatenation.  Returns the bf16 summary over dec0
    and dec1 (the serving path's layers) for the kernels line, the float32
    one under ``f32``."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    kn = hex_kernel_num(2)
    summary = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                   concat_kernel_b_ms=0.0, library_ms=0.0)
    bounds = []
    f32, f32_bounds = _f32_sums(), []
    for name, b, h, w, ca, cb, cout, gn in SPLIT_LAYERS:
        k = torch.randn((cout, ca + cb, kn), generator=gen, device="cuda") \
            / math.sqrt((ca + cb) * kn)
        a32 = torch.rand((b, h, w, ca), generator=gen, device="cuda")
        b32 = torch.rand((b, h, w, cb), generator=gen, device="cuda")
        bias = norm = None
        if gn:
            norm = ("gn", 8,
                    1 + 0.1 * torch.rand((cout,), generator=gen,
                                         device="cuda"),
                    0.1 * torch.randn((cout,), generator=gen, device="cuda"))
        else:
            bias = 0.1 * torch.randn((cout,), generator=gen, device="cuda")
        line = (f"hex_conv_layer_split {name} {ca}+{cb}->{cout} {h}x{w} "
                f"b={b} {'GN(8)' if gn else 'bias'}+ReLU:")
        for dtype in (torch.float32, torch.bfloat16):
            xa, xb, kd = a32.to(dtype), b32.to(dtype), k.to(dtype)
            kw = dict(radius=2, norm=norm, relu=True)

            def kernel():
                return cs.hex_conv_layer_split(xa, xb, kd, bias, **kw)

            def concat():
                return cs.hex_conv_layer(torch.cat([xa, xb], -1), kd, bias,
                                         **kw)

            def plain():
                return cs.hex_conv_layer_split_plain(xa, xb, kd, bias, **kw)

            got, cat, want = kernel(), concat(), plain()
            torch.cuda.synchronize()
            require(got.shape == want.shape and got.dtype == dtype,
                    f"split {name}: {tuple(got.shape)} {got.dtype}")
            equal = torch.equal(got, cat)
            require(equal, f"split {name} {dtype}: differs from concat + "
                           f"kernel B by {max_err(got, cat)[0]}")
            err, rel = max_err(got, want)
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            require(rel <= tol, f"split {name} {dtype}: relative err {rel} "
                                f"> {tol}")
            ms = cuda_ms(torch, kernel, iters=5)
            cms = cuda_ms(torch, concat, iters=5)
            pms = cuda_ms(torch, plain, iters=5)
            lms, lms_rng = cudnn_ms(torch, torch.cat([xa, xb], -1), kd)
            params = [kd] + [t for t in (bias, *(norm or ())[2:])
                             if t is not None]
            flops = 2 * kn * (ca + cb) * cout * h * w * b
            b_ms, b_by = bound(nbytes(xa, xb, got, *params), flops,
                               "bf16" if dtype == torch.bfloat16 else "f32")
            line += (f" {str(dtype)[6:]} max_abs_err={err!r} rel={rel!r} "
                     f"bit-equal to concat+kernel B={equal} "
                     f"kernel_ms={ms!r} ({tflops(flops, ms)!r} TFLOP/s) "
                     f"concat_kernel_b_ms={cms!r} "
                     f"plain_ms={pms!r} cudnn_conv_ms={lms!r} "
                     f"(range {lms_rng}) "
                     f"bound_ms={b_ms!r} ({b_by});")
            if dtype == torch.bfloat16:
                line += f" {mma_note(ca + cb, cout, gn=gn, split=True)};"
            if dtype == torch.bfloat16 and name.startswith("dec"):
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
                summary["ms"] += ms
                summary["plain_ms"] += pms
                summary["concat_kernel_b_ms"] += cms
                summary["library_ms"] += lms
                bounds.append((b_ms, b_by))
            elif name.startswith("dec"):
                _add_f32(f32, f32_bounds, err, ms, pms, lms, (b_ms, b_by))
        log(line)
    summary.update(summed_bound(bounds))
    summary["f32"] = dict(f32, **summed_bound(f32_bounds))
    return summary


UNET_GROUPS = [
    ("split layers", _is_split_conv),
    ("kernel B conv", lambda k: _conv_args(k) is not None),
    ("GN passes", _is_gn_pass),
    ("plan_gather", lambda k: "plan_gather" in k),
    ("cuDNN (transposed convs)", lambda k: any(
        s in k.lower() for s in ("xmma", "cudnn", "conv", "gemm", "cutlass"))),
    ("max-pool", lambda k: "max_pool" in k),
]


def run_hexunet(torch):
    """Phase 17: HexUNet-small serving.  Returns the launches of the
    counted requests."""
    from hygrid_tpu_torch.models import HexUNet, hexify_batch
    gen = torch.Generator(device="cuda").manual_seed(9)
    kw = dict(num_classes=4, widths=(32, 64, 128), norm="GN")
    model = HexUNet(dtype=torch.bfloat16, generator=gen, **kw).eval()
    in_gen = torch.Generator(device="cuda").manual_seed(10)
    xs = [torch.rand((UNET_BATCH, 3, 512, 512), generator=in_gen,
                     device="cuda") for _ in range(N_REQUESTS + 1)]

    def serve(x, m=model):
        return m(hexify_batch(x.to(torch.bfloat16)))

    counters = KERNELS
    per_request = {"plan_gather": 1, "hex_conv_layer": 3,
                   "hex_conv_layer_split": 2, "hex_max_pool": 2}

    def counted(fn, n):
        _zero_launches()
        out = fn()
        got = _launches()
        want = {name: per_request.get(name, 0) * n for name in counters}
        require(got == want, f"HexUNet: launches {got}, want {want}")
        return out, {k: v for k, v in got.items() if v}

    with torch.inference_mode():
        serve(xs[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        outs, launches = counted(lambda: [serve(x) for x in xs[1:]],
                                 N_REQUESTS)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / N_REQUESTS
        peak = torch.cuda.max_memory_allocated()
        for i, out in enumerate(outs):
            require(out.shape == (UNET_BATCH, 4, 256, 256)
                    and out.dtype == torch.bfloat16
                    and bool(torch.isfinite(out).all()),
                    f"HexUNet request {i}: {tuple(out.shape)} {out.dtype} "
                    f"or non-finite")
        require(not torch.equal(outs[0], outs[1]),
                "HexUNet: distinct requests, equal logits")
        ref_model = HexUNet(dtype=torch.float32, **kw)
        ref_model.load_state_dict(model.state_dict())
        ref = ref_model(hexify_batch(xs[1], plain=True), plain=True)
        err, rel = max_err(outs[0], ref)
        require(rel <= TOL["slice_rel"],
                f"HexUNet vs plain f32: relative err {rel}")
        del ref_model, ref

        ps = HexUNet(upsample="pixelshuffle", dtype=torch.bfloat16,
                     generator=gen, **kw).eval()
        ps_ref = HexUNet(upsample="pixelshuffle", dtype=torch.float32, **kw)
        ps_ref.load_state_dict(ps.state_dict())
        ps_out, ps_launches = counted(lambda: serve(xs[1], ps), 1)
        ps_err, ps_rel = max_err(ps_out, ps_ref(
            hexify_batch(xs[1], plain=True), plain=True))
        require(ps_rel <= TOL["slice_rel"],
                f"HexUNet pixelshuffle vs plain f32: relative err {ps_rel}")
        del ps, ps_ref, ps_out

        n, times = _timed_windows(torch, {"transpose": (lambda: None,
                                                         serve)},
                                  xs[1:], first_ms)
        times = sorted(times["transpose"])
        med = times[len(times) // 2]
        split = _profile_split(torch, lambda: serve(xs[1]), med,
                               UNET_GROUPS)
    log(f"HexUNet-small GN bf16 b={UNET_BATCH} 512^2 (transpose decoder): "
        f"{med!r} ms a request, median of {PERMODULE_WINDOWS} windows of "
        f"{n} requests cycling over {N_REQUESTS} distinct inputs (CUDA "
        f"events; windows {[round(t * n) for t in times]} ms), "
        f"images/s={UNET_BATCH / (med / 1e3)!r} (windows "
        f"{UNET_BATCH / (times[-1] / 1e3)!r}-{UNET_BATCH / (times[0] / 1e3)!r}); "
        f"peak_mem_bytes={peak} (the {N_REQUESTS + 1} inputs and "
        f"{N_REQUESTS} outputs included); launches={launches} in "
        f"{N_REQUESTS} requests; logits vs plain f32 max_abs_err={err!r} "
        f"rel={rel!r}; pixelshuffle decoder: launches={ps_launches}, vs "
        f"plain f32 max_abs_err={ps_err!r} rel={ps_rel!r}")
    log(f"HexUNet-small torch.profiler, one request: {split}")
    return launches


# phase 18's split layers (name, B, H, W, Ca, Cb, Cout): HexUNet-small's
# dec0 and dec1, and two splits of uneven widths (Cb below the 16-channel
# staging chunk; Ca not a multiple of the 32-channel output tile)
SPLIT_BWD_LAYERS = [("dec0", UNET_BATCH, 128, 127, 64, 64, 64),
                    ("dec1", UNET_BATCH, 256, 256, 32, 32, 32),
                    ("uneven", UNET_BATCH, 128, 127, 24, 8, 32),
                    ("uneven-out", UNET_BATCH, 128, 127, 40, 24, 64)]


def check_split_backward(torch, gen):
    """Phase 18: the split layer's backward against its plain versions:
    split dgrad (the dgrad pass on Ka and on Kb) bit-equal to kernel B's
    dgrad cut at Ca, split wgrad (the dW kernel on (A, g) and on (B, g))
    bit-equal to hex_conv_layer_wgrad on each input and to a second
    launch.  Beside each: the plain time and cuDNN's backward.  Returns the
    bf16 summaries over dec0 and dec1 (the training path's layers) for the
    kernels line, each with its float32 one under ``f32``."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    kn = hex_kernel_num(2)
    sums = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0)
            for name in ("dgrad", "wgrad")}
    bounds = {"dgrad": [], "wgrad": []}
    f32 = {kind: _f32_sums() for kind in sums}
    f32_bounds = {kind: [] for kind in sums}
    for name, b, h, w, ca, cb, cout in SPLIT_BWD_LAYERS:
        k = torch.randn((cout, ca + cb, kn), generator=gen, device="cuda") \
            / math.sqrt((ca + cb) * kn)
        a32 = torch.rand((b, h, w, ca), generator=gen, device="cuda")
        b32 = torch.rand((b, h, w, cb), generator=gen, device="cuda")
        g32 = torch.randn((b, h, w, cout), generator=gen, device="cuda")
        line = f"split backward {name} {ca}+{cb}->{cout} {h}x{w} b={b}:"
        for dtype in (torch.float32, torch.bfloat16):
            xa, xb, g, kd = (t.to(dtype) for t in (a32, b32, g32, k))
            xcat = torch.cat([xa, xb], -1)
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            peak = "bf16" if dtype == torch.bfloat16 else "f32"
            flops = 2 * kn * b * h * w * (ca + cb) * cout
            cases = {
                "dgrad": dict(
                    kernel=lambda: cs.hex_conv_layer_split_dgrad(
                        g, kd, ca, radius=2),
                    plain=lambda: cs.hex_conv_layer_split_dgrad_plain(
                        g, kd, ca, radius=2),
                    library=lambda: cudnn_ms(torch, xcat, kd, grad="x")),
                "wgrad": dict(
                    kernel=lambda: cs.hex_conv_layer_split_wgrad(
                        xa, xb, g, radius=2),
                    plain=lambda: cs.hex_conv_layer_split_wgrad_plain(
                        xa, xb, g, radius=2),
                    library=lambda: cudnn_ms(torch, xcat, kd, grad="k")),
            }
            for kind, fns in cases.items():
                got = fns["kernel"]()
                if kind == "dgrad":
                    dx = cs.hex_conv_layer_dgrad(g, kd, radius=2)
                    want = torch.cat(fns["plain"](), -1)
                    equal = (torch.equal(got[0], dx[..., :ca])
                             and torch.equal(got[1], dx[..., ca:]))
                    out = torch.cat(got, -1)
                    require(got[0].shape == xa.shape and got[1].shape ==
                            xb.shape and out.dtype == dtype,
                            f"split dgrad {name}: {tuple(out.shape)}")
                    b_ms, b_by = bound(nbytes(g, kd, *got), flops, peak)
                else:
                    halves = torch.cat(
                        [cs.hex_conv_layer_wgrad(xa, g, radius=2),
                         cs.hex_conv_layer_wgrad(xb, g, radius=2)], 1)
                    again = fns["kernel"]()
                    want = fns["plain"]()
                    equal = torch.equal(got, halves)
                    require(torch.equal(got, again),
                            f"split wgrad {name} {dtype}: two launches differ")
                    require(got.shape == k.shape, f"split wgrad {name}: "
                                                  f"{tuple(got.shape)}")
                    out = got
                    b_ms, b_by = bound(nbytes(xa, xb, g, got), flops, peak)
                torch.cuda.synchronize()
                require(equal, f"split {kind} {name} {dtype}: not bit-equal "
                               "to the unsplit kernel on each part")
                err, rel = max_err(out, want)
                require(rel <= tol, f"split {kind} {name} {dtype}: relative "
                                    f"err {rel} > {tol}")
                ms = cuda_ms(torch, fns["kernel"], iters=5)
                pms = cuda_ms(torch, fns["plain"], iters=5)
                lms, lms_rng = fns["library"]()
                line += (f" {kind} {str(dtype)[6:]} max_abs_err={err!r} "
                         f"rel={rel!r} bit-equal to unsplit parts={equal} "
                         f"kernel_ms={ms!r} ({tflops(flops, ms)!r} TFLOP/s) "
                         f"plain_ms={pms!r} "
                         f"cudnn_bwd_ms={lms!r} (range {lms_rng}) "
                         f"bound_ms={b_ms!r} ({b_by});")
                if dtype == torch.bfloat16 and kind == "dgrad":
                    line += (f" Ka: {mma_note(cout, ca, adjoint=True)}, Kb: "
                             f"{mma_note(cout, cb, adjoint=True)};")
                if dtype == torch.bfloat16 and kind == "wgrad":
                    line += (f" A: {wgrad_mma_note(ca, cout, b * h)}, B: "
                             f"{wgrad_mma_note(cb, cout, b * h)};")
                if dtype == torch.bfloat16 and name.startswith("dec"):
                    acc = sums[kind]
                    acc["max_abs_err"] = max(acc["max_abs_err"], err)
                    acc["ms"] += ms
                    acc["plain_ms"] += pms
                    acc["library_ms"] += lms
                    bounds[kind].append((b_ms, b_by))
                elif name.startswith("dec"):
                    _add_f32(f32[kind], f32_bounds[kind], err, ms, pms, lms,
                             (b_ms, b_by))
        log(line)
    for kind in sums:
        sums[kind].update(summed_bound(bounds[kind]))
        sums[kind]["f32"] = dict(f32[kind], **summed_bound(f32_bounds[kind]))
    return sums


UNET_TRAIN_GROUPS = [
    ("split layers' conv", _is_split_conv),
    ("kernel B conv", _is_gn_conv),
    ("dgrad", lambda k: _conv_args(k) is not None),
    ("wgrad", lambda k: "wgrad_" in k),
    ("GN passes", _is_gn_pass),
    ("GN backward", _is_gn_bwd),
    ("plan_gather", lambda k: "plan_gather" in k),
    ("cuDNN (transposed convs)", lambda k: any(
        s in k.lower() for s in ("xmma", "cudnn", "conv", "gemm", "cutlass"))),
    ("AdamW", lambda k: "adam" in k.lower() or "multi_tensor" in k),
    ("reductions", lambda k: "reduce_kernel" in k),
    ("gathers and scatters", lambda k: any(
        s in k for s in ("index", "gather", "scatter"))),
]
FIT_STEPS, FIT_BATCH = 60, 8


def _unet_step_vs_plain(torch, model, step, kw, batch, labels):
    """One training step of the timed state (``step``, the bf16 kernel
    path), and one forward and backward of copies of ``model``'s weights
    before it on the float32 plain path (the reference), the float32
    kernel path and the bf16 plain path.  Returns ``(loss rel err, {path:
    {leaf: grad rel err}} against the float32 plain path, the bf16 kernel
    path's largest leaf rel err against the bf16 plain path, a summary
    line)``; mean IoU is read from each path's logits (the kernel path's
    from a forward of the same weights without grad)."""
    from hygrid_tpu_torch.models import (HexUNet, dense_onehot_xent,
                                         hexify_batch, mean_iou)
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        iou = float(mean_iou(model(hexify_batch(batch)), labels, 4))
    loss = float(step((batch, labels))["loss"])
    runs = {"bf16 kernel": (loss, {n: p.grad for n, p in
                                   model.named_parameters()}, iou)}
    for label, dtype, plain in (("f32 plain", torch.float32, True),
                                ("f32 kernel", torch.float32, False),
                                ("bf16 plain", torch.bfloat16, True)):
        m = HexUNet(dtype=dtype, **kw)
        m.load_state_dict(snapshot)
        logits = m(hexify_batch(batch, plain=plain), plain=plain)
        ref = dense_onehot_xent(torch.movedim(logits, 1, -1), labels)
        ref.backward()
        runs[label] = (float(ref.detach()),
                       {n: p.grad for n, p in m.named_parameters()},
                       float(mean_iou(logits.detach(), labels, 4)))
        del m, logits, ref
    ref_loss, ref_grads, ref_iou = runs.pop("f32 plain")
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    rels = {label: {n: max_err(g[n], want)[1] if g[n] is not None else None
                    for n, want in ref_grads.items()}
            for label, (_, g, _) in runs.items()}
    kernel_vs_plain = max(max_err(runs["bf16 kernel"][1][n], g)[1]
                          for n, g in runs["bf16 plain"][1].items())
    summary = (f"loss {loss!r} vs {ref_loss!r} (rel {loss_rel!r}); mean_iou "
               + ", ".join(f"{label} {r[2]!r}" for label, r in runs.items())
               + f", f32 plain {ref_iou!r}; bf16 kernel path vs bf16 plain "
               f"path, largest leaf rel err {kernel_vs_plain!r}")
    return loss_rel, rels, kernel_vs_plain, summary


def run_hexunet_training(torch):
    """Phase 19: HexUNet-small training.  Returns the launches of the
    counted steps."""
    from hygrid_tpu_torch.models import (HexUNet, create_train_state, fit,
                                         hexify_batch, synthetic_hex_shapes,
                                         train_step)
    gen = torch.Generator(device="cuda").manual_seed(12)
    kw = dict(num_classes=4, widths=(32, 64, 128), norm="GN")
    model = HexUNet(dtype=torch.bfloat16, generator=gen, **kw)
    state = create_train_state(model)
    in_gen = torch.Generator(device="cuda").manual_seed(13)
    rng = np.random.default_rng(0)     # labels as suite.py draws them
    size = UNET_SIZE
    data = [(torch.rand((UNET_BATCH, 3, size, size), generator=in_gen,
                        device="cuda"),
             torch.as_tensor(rng.integers(0, 4, (UNET_BATCH, size // 2,
                                                 size // 2)), device="cuda"))
            for _ in range(N_STEPS + 2)]

    def step(batch):
        return train_step(state, hexify_batch(batch[0]), batch[1])[1]

    counters = KERNELS
    per_step = {"plan_gather": 1, "hex_conv_layer": 3,
                "hex_conv_layer_split": 2, "hex_conv_layer_dgrad": 2,
                "hex_conv_layer_split_dgrad": 4, "hex_conv_wgrad": 3,
                "hex_conv_wgrad_split": 4, "gn_relu_backward": 5,
                "hex_max_pool": 2, "hex_max_pool_backward": 2}
    step(data[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    metrics = [step(b) for b in data[1:N_STEPS + 1]]
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3 / N_STEPS
    got = _launches()
    want = {name: per_step.get(name, 0) * N_STEPS for name in counters}
    require(got == want, f"HexUNet training: launches {got}, want {want}")
    launches = {k: v for k, v in got.items() if v}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(v) for v in losses),
            f"HexUNet training: non-finite losses {losses}")

    # one more step of the timed state (after the warm-up and the counted
    # steps, as in phase 7), against the plain path in float32.  On random
    # per-cell labels the model soon sits at the class prior, its grads
    # become sums that cancel, and bf16 rounding alone (the plain bf16
    # path's too) moves them by tens of percent against float32 (PERF.md,
    # §6); the bf16 plain path, which rounds as the kernel path does, holds
    # the kernel path at any step
    batch, labels = data[-1]
    check_steps = state.step
    check = _unet_step_vs_plain(torch, model, step, kw, batch, labels)

    n, times = _timed_windows(torch, {"train": (lambda: None, step)},
                              data[1:N_STEPS + 1], first_ms)
    times = sorted(times["train"])
    med = times[len(times) // 2]
    split = _profile_split(torch, lambda: step(data[1]), med,
                           UNET_TRAIN_GROUPS)

    # fit: 60 steps on synthetic_hex_shapes batches, a fresh model
    images, masks = synthetic_hex_shapes(np.random.default_rng(14),
                                         FIT_STEPS * FIT_BATCH, size=64)
    fit_data = [(images[i:i + FIT_BATCH], masks[i:i + FIT_BATCH])
                for i in range(0, FIT_STEPS * FIT_BATCH, FIT_BATCH)]
    fit_model = HexUNet(dtype=torch.bfloat16, generator=gen, **kw)
    t0 = time.perf_counter()
    _, history = fit(fit_model, fit_data, log_every=1)
    fit_s = time.perf_counter() - t0
    fit_losses = history["loss"]
    first10 = float(np.mean(fit_losses[:10]))
    last10 = float(np.mean(fit_losses[-10:]))

    log(f"HexUNet-small GN bf16 AdamW training b={UNET_BATCH} {size}^2 "
        f"(transpose decoder): {med!r} ms a step, median of "
        f"{PERMODULE_WINDOWS} windows of {n} steps cycling over {N_STEPS} "
        f"distinct batches (CUDA events; windows "
        f"{[round(t * n) for t in times]} ms), "
        f"images/s={UNET_BATCH / (med / 1e3)!r} (windows "
        f"{UNET_BATCH / (times[-1] / 1e3)!r}-"
        f"{UNET_BATCH / (times[0] / 1e3)!r}); peak_mem_bytes={peak}; "
        f"launches={launches} in {N_STEPS} steps; losses={losses}")
    log(f"HexUNet-small training torch.profiler, one step: {split}")
    loss_rel, rels, kernel_vs_plain, summary = check
    log(f"HexUNet training step after {check_steps} steps vs plain f32 on "
        f"the card: {summary}")
    for label, leaf in rels.items():
        log(f"HexUNet training grads after {check_steps} steps, {label} path "
            f"vs plain f32 (rel max-abs): "
            + ", ".join(f"{k}={r!r}" for k, r in leaf.items()))
    log(f"HexUNet fit: {FIT_STEPS} steps of b={FIT_BATCH} "
        f"synthetic_hex_shapes(size=64) in {fit_s!r} s (host clock); mean "
        f"loss of the first 10 steps {first10!r}, of the last 10 "
        f"{last10!r}; losses={fit_losses}")
    require(loss_rel <= TOL["loss_rel"],
            f"HexUNet training loss vs plain f32: rel {loss_rel}")
    for label in ("bf16 kernel", "f32 kernel"):
        tol = TOL["grad_f32_rel" if label == "f32 kernel" else
                  "grad_bf16_rel"]
        for k, r in rels[label].items():
            require(r is not None and r <= tol,
                    f"HexUNet {label} path grad {k}: relative err {r} > {tol}")
    require(kernel_vs_plain <= TOL["b_bf16_rel"],
            f"HexUNet bf16 kernel path grads vs bf16 plain path: largest "
            f"leaf relative err {kernel_vs_plain} > {TOL['b_bf16_rel']}")
    require(len(fit_losses) == FIT_STEPS
            and all(math.isfinite(v) for v in fit_losses),
            f"HexUNet fit: losses {fit_losses}")
    require(last10 < first10, f"HexUNet fit: the loss did not fall "
                              f"({first10} -> {last10})")
    return launches


# phase 20's affine layers (name, B, H, W, Ca, Cb, Cout): HexCNN-small's six
# at b=32, and HexUNet-small's dec1 split layer (Cb > 0: the split layer)
AFFINE_LAYERS = ([(f"L{i}", BATCH, h, w, cin, 0, cout)
                  for i, (cin, cout, h, w) in enumerate(LAYERS)]
                 + [("dec1", UNET_BATCH, 256, 256, 32, 32, 32)])


def _affine_layer_graph(torch, xs, k, vecs, plain):
    """One affine + ReLU layer (the split layer for two inputs) on fresh
    leaves ``(*xs, k, bias, scale, shift)``, under grad: ``(out,
    leaves)``."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    leaves = [t.detach().requires_grad_() for t in (*xs, k, *vecs)]
    xl, (kl, bias, scale, shift) = leaves[:len(xs)], leaves[len(xs):]
    if len(xs) == 2:
        fn = cs.hex_conv_layer_split_plain if plain else cs.hex_conv_layer_split
    else:
        fn = cs.hex_conv_layer_plain if plain else cs.hex_conv_layer
    with torch.enable_grad():
        out = fn(*xl, kl, bias, radius=2, norm=("affine", scale, shift),
                 relu=True)
    return out, leaves


def _affine_library_graph(torch, xs, k, vecs):
    """The library's version of the same layer: ``hex_conv2d(impl=
    "direct")`` (cuDNN) on the NCHW concatenation in the activations'
    dtype, then the affine and ReLU in float32, under grad."""
    from hygrid_tpu_torch.nn.functional import hex_conv2d
    xn = torch.cat(xs, -1).permute(0, 3, 1, 2).contiguous()
    leaves = [t.detach().requires_grad_() for t in (xn, k, *vecs)]
    xl, kl, bias, scale, shift = leaves
    with torch.enable_grad():
        y = hex_conv2d(xl, kl, bias, radius=2, padding=1, impl="direct")
        out = torch.relu(y * scale[:, None, None] + shift[:, None, None])
        out = out.to(xn.dtype)
    return out, leaves


def _affine_stack_path(torch, gen):
    """Phase 20's path through the public entry point: ``hex_conv_stack``
    with affine norms, forward and backward, at HexCNN-small's first stage
    (b=32, 256^2, 3 -> 32 -> 32, the image needs no grad) and HexUNet-
    small's dec1 skip-join stage (b=8, 256^2, 32+32 -> 32 -> 32, both
    inputs need grads), bf16.  Returns the launches, counted from 0."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    kn = 7

    def affine(c):
        return ("affine",
                (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
                 ).requires_grad_(),
                (0.1 * torch.randn(c, generator=gen, device="cuda")
                 ).requires_grad_())

    def kernel(cout, cin):
        return (torch.randn((cout, cin, kn), generator=gen, device="cuda")
                / math.sqrt(cin * kn)).requires_grad_()

    image = torch.rand((BATCH, 256, 256, 3), generator=gen, device="cuda"
                       ).to(torch.bfloat16)
    up, skip = (torch.rand((UNET_BATCH, 256, 256, 32), generator=gen,
                           device="cuda").to(torch.bfloat16).requires_grad_()
                for _ in range(2))
    stages = [dict(x=image, kernels=[kernel(32, 3), kernel(32, 32)]),
              dict(x=up, extra_input=skip,
                   kernels=[kernel(32, 64), kernel(32, 32)])]
    counters = KERNELS
    _zero_launches()
    for st in stages:
        norms = [affine(32) for _ in st["kernels"]]
        out = cs.hex_conv_stack(
            st["x"], [k.to(torch.bfloat16) for k in st["kernels"]],
            radius=2, norms=norms, data_format="NHWC",
            extra_input=st.get("extra_input"))
        out.float().square().mean().backward()
        grads = [k.grad for k in st["kernels"]] + [
            t.grad for n in norms for t in n[1:]]
        require(all(g is not None and bool(torch.isfinite(g).all())
                    for g in grads), "affine stack: missing or non-finite "
                                     "grads")
    torch.cuda.synchronize()
    got = _launches()
    want = {"hex_conv_layer": 3, "hex_conv_layer_split": 1,
            "hex_conv_layer_dgrad": 2, "hex_conv_layer_split_dgrad": 2,
            "hex_conv_wgrad": 3, "hex_conv_wgrad_split": 2}
    require(got == {n: want.get(n, 0) for n in counters},
            f"affine stack: launches {got}, want {want}")
    require(up.grad is not None and skip.grad is not None,
            "affine stack: no grad for the split stage's inputs")
    return {k: v for k, v in got.items() if v}


def _affine_backward_plain(torch, x, k, y, scale, shift, g):
    """The plain version of an affine + ReLU layer's backward at the
    pre-activation ``y`` the forward kept: the tail pulled back by torch
    autograd in float64 (its ReLU mask is the sign of the exact ``y *
    scale + shift``, as the kernel's fmaf rounds it), then
    ``hex_conv_layer_dgrad_plain`` / ``_wgrad_plain`` on ``gpre`` rounded
    to the activations' dtype.  Returns ``(gpre, dx, dW, dbias, dscale,
    dshift)``, dx cut at the inputs' channels by the caller."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    leaves = [t.detach().double().requires_grad_() for t in (y, scale, shift)]
    with torch.enable_grad():
        out = torch.relu(leaves[0] * leaves[1] + leaves[2])
        gpre, dscale, dshift = torch.autograd.grad(out, leaves, g.double())
    dbias = gpre.sum((0, 1, 2))
    gpre = gpre.to(g.dtype)
    return (gpre, cs.hex_conv_layer_dgrad_plain(gpre, k, radius=2),
            cs.hex_conv_layer_wgrad_plain(x, gpre, radius=2), dbias, dscale,
            dshift)


def check_affine_backward(torch, gen):
    """Phase 20: the affine layer's backward (TPU kernel #12 in affine
    mode; 12s on the split layer) against its plain version at the
    pre-activation the forward kept (:func:`_affine_backward_plain`), and
    that pre-activation against the plain conv's.  Returns the launches of
    the public-entry path (:func:`_affine_stack_path`)."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    sums = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound=[])
    for name, b, h, w, ca, cb, cout in AFFINE_LAYERS:
        cin = ca + cb
        k = torch.randn((cout, cin, 7), generator=gen, device="cuda") \
            / math.sqrt(cin * 7)
        x32 = [torch.rand((b, h, w, c), generator=gen, device="cuda")
               for c in ((ca, cb) if cb else (ca,))]
        vecs = [0.1 * torch.randn(cout, generator=gen, device="cuda"),
                1 + 0.2 * torch.randn(cout, generator=gen, device="cuda"),
                0.1 * torch.randn(cout, generator=gen, device="cuda")]
        g32 = torch.randn((b, h, w, cout), generator=gen, device="cuda")
        line = (f"affine backward {name} {ca}{f'+{cb}' if cb else ''}->{cout}"
                f" {h}x{w} b={b} (affine + ReLU):")
        for dtype in (torch.float32, torch.bfloat16):
            xs, kd, g = [t.to(dtype) for t in x32], k.to(dtype), g32.to(dtype)
            tol = TOL["b_f32_rel" if dtype == torch.float32 else "b_bf16_rel"]
            out_k, leaves_k = _affine_layer_graph(torch, xs, kd, vecs, False)

            def kernel():
                return torch.autograd.grad(out_k, leaves_k, g,
                                           retain_graph=True)

            got, again = kernel(), kernel()
            require(all(torch.equal(u, v) for u, v in zip(got, again)),
                    f"affine backward {name} {dtype}: two launches differ")
            norm = ("affine", vecs[1], vecs[2])
            o_k, y_k = cs._layer_forward(xs[0], kd, vecs[0], 2, 1, norm,
                                         True, xs[1] if cb else None,
                                         save_pre=True)[:2]
            xcat = torch.cat(xs, -1)
            errs = {"pre": max_err(y_k, cs._pre_plain(xcat, kd, vecs[0], 2,
                                                       1))[1]}
            gpre_k = cs.affine_relu_backward(y_k, vecs[1], g, o_k)[0]
            want = _affine_backward_plain(torch, xcat, kd, y_k, *vecs[1:], g)
            dx = torch.cat(got[:len(xs)], -1)
            for n, u, v in zip(("gpre", "dx", "dW", "dbias", "dscale",
                                "dshift"), (gpre_k, dx, *got[len(xs):]),
                               want):
                errs[n] = max_err(u, v)[1]
            torch.cuda.synchronize()
            bad = {n: e for n, e in errs.items() if not e <= tol}
            require(not bad, f"affine backward {name} {dtype}: relative "
                             f"errs {bad} > {tol}")
            out_p, leaves_p = _affine_layer_graph(torch, xs, kd, vecs, True)
            ms = cuda_ms(torch, kernel, iters=5)
            pms = cuda_ms(torch, lambda: torch.autograd.grad(
                out_p, leaves_p, g, retain_graph=True), iters=5)
            del out_p, leaves_p
            out_l, leaves_l = _affine_library_graph(torch, xs, kd, vecs)
            gn = g.permute(0, 3, 1, 2).contiguous()
            lms = cuda_ms(torch, lambda: torch.autograd.grad(
                out_l, leaves_l, gn, retain_graph=True), iters=5)
            flops = 2 * 2 * 7 * b * h * w * cin * cout
            b_ms, b_by = bound(nbytes(*xs, g, y_k, o_k, kd, *got), flops,
                               "bf16" if dtype == torch.bfloat16 else "f32")
            line += (f" {str(dtype)[6:]} rel errs {errs} bit-equal twice; "
                     f"kernel_ms={ms!r} ({tflops(flops, ms)!r} TFLOP/s) "
                     f"plain_ms={pms!r} library_ms={lms!r} "
                     f"bound_ms={b_ms!r} ({b_by});")
            if dtype == torch.bfloat16 and not cb:
                sums["ms"] += ms
                sums["plain_ms"] += pms
                sums["library_ms"] += lms
                sums["bound"].append((b_ms, b_by))
            del out_k, leaves_k, out_l, leaves_l, gn, got, again, want
            del y_k, gpre_k, dx, xcat
        log(line)
    sums.update(summed_bound(sums.pop("bound")))
    log(f"affine backward, HexCNN-small's six layers in bf16 (the tail, dx "
        f"and dW by the Function's backward; plain: autograd of the plain "
        f"layer; library: autograd of cuDNN's conv + affine + ReLU): {sums}")
    return _affine_stack_path(torch, gen)


HEXVIT = dict(dim=192, depth=6, heads=3, patch_halvings=4,
              hex_size=(256, 256))     # benchmarks/suite.py::bench_hexvit
HEXVIT_GROUPS = [
    ("plan_gather", lambda k: "plan_gather" in k),
    ("attention", lambda k: any(s in k.lower() for s in (
        "flash", "fmha", "attention", "sdpa"))),
    ("cuDNN convs", lambda k: any(s in k.lower() for s in (
        "conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn", "nchw",
        "nhwc"))),
    ("GEMMs", lambda k: any(s in k.lower() for s in (
        "gemm", "nvjet", "cutlass", "xmma", "matmul"))),
    ("LN/GELU", lambda k: any(s in k.lower() for s in (
        "layer_norm", "layernorm", "gelu"))),
]


def hexvit_cost(model, batch):
    """``(flops, parameter bytes)`` of one HexViT forward on ``batch``
    images of the model's hex size: the stem convs (2 x pixels x Cout x Cin
    x taps each), a block's four d x d projections and two MLP matmuls per
    token, attention's two T x T x d products, the head."""
    flops, t = 0, model.pos_embedding.shape[1]
    h, w = model.hex_size
    for i in range(model.patch_halvings):
        cout, cin, kn = getattr(model, f"stem{i}").kernel.shape
        h, w = h // 2, w // 2
        flops += 2 * batch * h * w * cout * cin * kn
    for i in range(model.depth):
        blk = getattr(model, f"block{i}")
        d, hidden = blk.fc1.in_features, blk.fc1.out_features
        flops += 2 * batch * t * (4 * d * d + 2 * d * hidden)
        flops += 2 * 2 * batch * t * t * d
    flops += 2 * batch * model.head.in_features * model.head.out_features
    return flops, sum(p.numel() * p.element_size() for p in model.parameters())


def run_hexvit(torch):
    """Phase 21: HexViT serving at ``bench_hexvit``'s config.  Returns the
    launches of the counted requests."""
    from hygrid_tpu_torch.models import HexViT, hexify_batch
    gen = torch.Generator(device="cuda").manual_seed(15)
    model = HexViT(dtype=torch.bfloat16, generator=gen, **HEXVIT).eval()
    in_gen = torch.Generator(device="cuda").manual_seed(16)
    xs = [torch.rand((BATCH, 3, 512, 512), generator=in_gen, device="cuda")
          for _ in range(N_REQUESTS + 1)]

    def serve(x, m=model):
        return m(hexify_batch(x.to(torch.bfloat16)))

    counters = KERNELS
    with torch.inference_mode():
        serve(xs[0])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.perf_counter()
        outs = [serve(x) for x in xs[1:]]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3 / N_REQUESTS
        got = _launches()
        want = {name: N_REQUESTS if name == "plan_gather" else 0
                for name in counters}
        require(got == want, f"HexViT: launches {got}, want {want}")
        peak = torch.cuda.max_memory_allocated()
        for i, out in enumerate(outs):
            require(out.shape == (BATCH, 10) and out.dtype == torch.bfloat16
                    and bool(torch.isfinite(out).all()),
                    f"HexViT request {i}: {tuple(out.shape)} {out.dtype} or "
                    f"non-finite")
        require(not torch.equal(outs[0], outs[1]),
                "HexViT: distinct requests, equal logits")
        ref_model = HexViT(dtype=torch.float32, **HEXVIT)
        ref_model.load_state_dict(model.state_dict())
        err, rel = max_err(outs[0], ref_model(hexify_batch(xs[1],
                                                           plain=True)))
        require(rel <= TOL["slice_rel"],
                f"HexViT vs plain f32: relative err {rel}")
        del ref_model
        n, times = _timed_windows(torch, {"serve": (lambda: None, serve)},
                                  xs[1:], first_ms)
        times = sorted(times["serve"])
        med = times[len(times) // 2]
        try:
            graph = f"{graph_ms(torch, lambda: serve(xs[1]), iters=4)!r} ms"
        except RuntimeError as e:
            graph = f"not captured ({str(e).splitlines()[0][:160]})"
        split = _profile_split(torch, lambda: serve(xs[1]), med,
                               HEXVIT_GROUPS)
    flops, param_bytes = hexvit_cost(model, BATCH)
    b_ms, b_by = bound(nbytes(xs[1].to(torch.bfloat16), outs[0])
                       + param_bytes, flops, "bf16")
    log(f"HexViT d192/L6/3 heads, 4 halvings, bf16 b={BATCH} 512^2 (256 "
        f"tokens): {med!r} ms a request, median of {PERMODULE_WINDOWS} "
        f"windows of {n} requests cycling over {N_REQUESTS} distinct inputs "
        f"(CUDA events; windows {[round(t * n) for t in times]} ms), "
        f"images/s={BATCH / (med / 1e3)!r} (windows "
        f"{BATCH / (times[-1] / 1e3)!r}-{BATCH / (times[0] / 1e3)!r}); one "
        f"request replayed in a CUDA graph (device alone): {graph}; "
        f"peak_mem_bytes={peak} (the {N_REQUESTS + 1} inputs and "
        f"{N_REQUESTS} outputs included); launches={got} in {N_REQUESTS} "
        f"requests; logits vs plain f32 max_abs_err={err!r} rel={rel!r}; "
        f"work {flops / 1e9!r} GFLOP a request, bound_ms={b_ms!r} ({b_by}, "
        f"{tflops(flops, med)!r} TFLOP/s achieved)")
    log(f"HexViT torch.profiler, one request: {split}")
    return {k: v for k, v in got.items() if v}


def _ref_grads(torch, make, snapshot, x, labels):
    """``(loss, {leaf: grad})`` of one forward (``train=True``) and
    backward of ``make()`` loaded with ``snapshot``."""
    from hygrid_tpu_torch.models import dense_onehot_xent
    ref = make()
    ref.load_state_dict(snapshot)
    loss = dense_onehot_xent(ref(x, train=True), labels)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  ref.named_parameters()}


def _step_vs_plain(torch, state, step, refs, labels, zero):
    """One step of the timed state (``step()``, the kernel path) and one
    forward and backward of each reference path in ``refs``, ``{label:
    (make_model, input)}``, loaded with the state's weights and buffers
    from before the step (the first is the plain float32 path), all with
    deterministic library algorithms (cuDNN's, index_put's), so that the
    paths differ by what they compute and not by the order of atomic adds.
    Returns ``(loss, {label: (loss, {leaf: grad})}, {leaf: grad})``, the
    last the kernel path's grads, and, from two runs of the plain float32
    path with the default (nondeterministic) algorithms, the largest leaf
    relative difference between them (``zero`` as in :func:`_grad_rels`):
    the library's own spread."""
    snapshot = {k: v.clone() for k, v in state.model.state_dict().items()}
    make, x = next(iter(refs.values()))
    spread = [_ref_grads(torch, make, snapshot, x, labels)[1]
              for _ in range(2)]
    spread = max(_grad_rels(*spread, 2.0 ** -24, zero).values())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True, allow_tf32=False):
            loss = float(step()["loss"])
            runs = {label: _ref_grads(torch, make, snapshot, x, labels)
                    for label, (make, x) in refs.items()}
    finally:
        torch.use_deterministic_algorithms(False)
    return loss, runs, {n: p.grad for n, p in
                        state.model.named_parameters()}, spread


def _grad_rels(got, want, unit, zero=()):
    """``{leaf: rel max-abs err}`` of the grads ``got`` against ``want``,
    each leaf's error over its own largest magnitude; a leaf in ``zero``,
    whose grad is zero by construction (HexViT's key biases: the softmax
    cancels a shift of every key), over ``unit`` (the unit roundoff of the
    compute dtype) times the largest grad of any leaf, the rounding
    residue a computation in that dtype leaves there."""
    top = max(float(g.abs().max()) for g in want.values())
    rels = {}
    for n, w in want.items():
        err = float((got[n].float() - w.float()).abs().max())
        mag = unit * top if n in zero else float(w.abs().max())
        rels[n] = err / mag if mag else (0.0 if err == 0 else math.inf)
    return rels


def _train_model(torch, label, state, batches, labels, refs, per_step,
                 unit, groups=None, stats_change=False, zero=()):
    """Phase 22 for one model: the fresh state's first step (on the last
    batch) against the reference paths ``refs`` (:func:`_step_vs_plain`;
    grads by :func:`_grad_rels` at ``unit`` and ``zero``; first, because
    AdamW's first steps at the default rate shrink HexViT's query and key
    grads of blocks 2-5 below what bf16 resolves), then a warm-up step and
    ``N_STEPS`` timed AdamW steps on the distinct ``batches`` (hex images,
    or callables that make them from the rect input: the rect->hex
    resample is then part of the step), timed by CUDA events (with
    ``stats_change`` every BatchNorm running mean must move at every
    step), the launches counted from 0 (``per_step`` of each kernel a
    step) and a torch.profiler split of one step.  Returns the launches,
    and the loss and grads' relative errors by path."""
    from hygrid_tpu_torch.models import train_step

    def step(batch, y):
        return train_step(state, batch() if callable(batch) else batch, y)[1]

    check_steps = state.step
    loss, runs, grads, spread = _step_vs_plain(
        torch, state, lambda: step(batches[-1], labels[-1]), refs,
        labels[-1], zero)
    step(batches[0], labels[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = KERNELS
    _zero_launches()
    means = [b for n, b in state.model.named_buffers()
             if n.endswith("running_mean")]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = []
    for batch, y in zip(batches[1:N_STEPS + 1], labels[1:N_STEPS + 1]):
        before = [m.clone() for m in means] if stats_change else []
        metrics.append(step(batch, y))
        require(all(not torch.equal(a, m) for a, m in zip(before, means)),
                f"{label}: a running mean did not change in a step")
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / N_STEPS
    peak = torch.cuda.max_memory_allocated()
    got = _launches()
    want = {name: per_step.get(name, 0) * N_STEPS for name in counters}
    require(got == want, f"{label}: launches {got}, want {want}")
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(v) for v in losses),
            f"{label}: non-finite losses {losses}")
    split = _profile_split(torch, lambda: step(batches[1], labels[1]), ms,
                           groups)
    b = labels[0].shape[0]
    log(f"{label}: {ms!r} ms a step over {N_STEPS} distinct batches (CUDA "
        f"events), images/s={b / (ms / 1e3)!r}; peak_mem_bytes={peak}; "
        f"launches={got} in {N_STEPS} steps; losses={losses}")
    log(f"{label} torch.profiler, one step: {split}")
    log(f"{label}: two runs of the plain float32 path with the default "
        f"library algorithms differ by {spread!r} (the largest leaf rel "
        f"max-abs): the library's own spread; the checks below run "
        f"deterministic algorithms")
    path, (_, ref_grads) = next(iter(runs.items()))
    mags = {n: float(g.abs().max()) for n, g in ref_grads.items()}
    low = min((n for n in mags if n not in zero), key=mags.get)
    log(f"{label}: the smallest leaf grad (max-abs) of the {path} path is "
        f"{low}'s, {mags[low] / max(mags.values())!r} of the largest; "
        f"measured against the largest grad (zero by construction): "
        f"{sorted(zero)}")
    rels = {}
    for path, (ref_loss, ref_grads) in runs.items():
        rels[path] = (abs(loss - ref_loss) / abs(ref_loss),
                      _grad_rels(grads, ref_grads, unit, zero))
        log(f"{label}: the step after {check_steps} steps vs the {path} "
            f"path: loss {loss!r} vs {ref_loss!r} (rel {rels[path][0]!r}); "
            f"grads (rel max-abs): " + ", ".join(
                f"{n}={r!r}" for n, r in rels[path][1].items()))
    return {k: v for k, v in got.items() if v}, rels, runs


def _require_close(label, rels, path, tol):
    loss_rel, leaves = rels[path]
    require(loss_rel <= TOL["loss_rel"],
            f"{label}: loss vs the {path} path, rel {loss_rel}")
    bad = {n: r for n, r in leaves.items() if not r <= tol}
    require(not bad, f"{label}: grads vs the {path} path {bad} > {tol}")


HEXRESNET_BATCH = 256
TRAIN_GROUPS = HEXVIT_GROUPS + [
    ("AdamW", lambda k: "adam" in k.lower() or "multi_tensor" in k),
    ("reductions", lambda k: "reduce_kernel" in k)]


def gratings(torch, gen, n, size, num_classes=10):
    """``n`` float32 RGB ``size``^2 images on the card and their int64
    labels, drawn from ``gen``: ``synthetic_hex_cifar``'s class-dependent
    oriented gratings (the class sets the angle and the frequency) plus
    noise of standard deviation 0.3."""
    labels = torch.randint(0, num_classes, (n,), generator=gen,
                           device="cuda")
    yy, xx = torch.meshgrid(*[torch.arange(size, device="cuda") / size] * 2,
                            indexing="ij")
    angle = (math.pi / num_classes) * labels[:, None, None]
    freq = 2 + labels[:, None, None] % 3
    wave = torch.sin(2 * math.pi * freq * (torch.cos(angle) * xx
                                           + torch.sin(angle) * yy))
    noise = torch.randn((n, 3, size, size), generator=gen, device="cuda")
    return wave[:, None] + 0.3 * noise, labels


def run_new_training(torch):
    """Phase 22: HexViT (phase 21's model, position embedding std 0.3, on
    gratings), HexCNN-small with BatchNorm (f32, b=32 512^2) and HexResNet
    (default widths, synthetic_hex_cifar at b=256) train with AdamW.  BN HexCNN-small's
    only hand-written kernel is plan_gather, so on the card its step
    against the plain path on plan_gather's input (the same model code)
    checks that the step is deterministic, beside plan_gather's input
    against the plain gather's; its training is held to the reference on
    the CPU (tests/test_torch_bn_train.py).  Returns the launches by
    path."""
    from hygrid_tpu_torch.models import (HexResNet, HexViT,
                                         create_train_state, hexcnn_small,
                                         hexify_batch, synthetic_hex_cifar)
    paths = {}
    in_gen = torch.Generator(device="cuda").manual_seed(17)

    # HexViT on gratings, its position embedding drawn at std 0.3: at the
    # reference's std 0.02 the 256 tokens of blocks 2-5 are nearly equal
    # on any input (noise, gratings, block patterns), attention is near
    # uniform, and bf16 cannot resolve the query and key grads there (they
    # come out 2 to 40 times their size off); tokens that differ give
    # every grad but the key biases' a size bf16 resolves (the smallest is
    # logged)
    t0 = time.perf_counter()
    vit_gen = torch.Generator(device="cuda").manual_seed(21)
    rects, labels = zip(*[gratings(torch, vit_gen, BATCH, 512)
                          for _ in range(N_STEPS + 2)])
    batches = [functools.partial(hexify_batch, r) for r in rects]
    plain_input = hexify_batch(rects[-1], plain=True)
    kernel_input = hexify_batch(rects[-1])
    gen = torch.Generator(device="cuda").manual_seed(15)
    model = HexViT(dtype=torch.bfloat16, generator=gen, **HEXVIT)
    with torch.no_grad():
        model.pos_embedding.normal_(0, 0.3, generator=gen)
    label = (f"HexViT d192/L6 bf16 (f32 parameters, position embedding "
             f"std 0.3) AdamW gratings b={BATCH} 512^2")
    paths["hexvit_train"], rels, _ = _train_model(
        torch, label, create_train_state(model), batches, labels,
        {"f32 plain": (lambda: HexViT(**HEXVIT), plain_input),
         "f32 kernel": (lambda: HexViT(**HEXVIT), kernel_input),
         "bf16 plain": (lambda: HexViT(dtype=torch.bfloat16, **HEXVIT),
                        plain_input)},
        {"plan_gather": 1}, 2.0 ** -8, TRAIN_GROUPS,
        zero={n for n, _ in model.named_parameters()
              if n.endswith("attn.key.bias")})
    _require_close(label, rels, "f32 plain", TOL["grad_bf16_rel"])
    del model, rects, labels, batches, plain_input, kernel_input
    log(f"phase 22 HexViT: {time.perf_counter() - t0:.1f} s")

    rects = [torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                        device="cuda") for _ in range(N_STEPS + 2)]
    batches = [functools.partial(hexify_batch, r) for r in rects]
    labels = [torch.randint(0, 10, (BATCH,), generator=in_gen,
                            device="cuda") for _ in rects]
    plain_input = hexify_batch(rects[-1], plain=True)
    kernel_input = hexify_batch(rects[-1])

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(18)
    label = f"HexCNN-small BN f32 AdamW b={BATCH} 512^2"
    # the model's sensitivity to its input at the ulp: the plain input
    # moved by one float32 ulp up or down at random
    up = torch.randint(0, 2, plain_input.shape, generator=in_gen,
                       device="cuda", dtype=torch.bool)
    ulp_input = torch.nextafter(plain_input, torch.where(
        up, torch.inf, -torch.inf))
    paths["bn_train"], rels, _ = _train_model(
        torch, label, create_train_state(hexcnn_small(norm="BN",
                                                      generator=gen)),
        batches, labels,
        {"f32 plain": (lambda: hexcnn_small(norm="BN"), plain_input),
         "f32 plain on the kernel's input": (lambda: hexcnn_small(norm="BN"),
                                             kernel_input),
         "f32 plain on the plain input moved by one ulp": (
             lambda: hexcnn_small(norm="BN"), ulp_input)},
        {"plan_gather": 1}, 2.0 ** -24, TRAIN_GROUPS, stats_change=True)
    # plan_gather is the step's only hand-written kernel, and its float32
    # output is within phase 3's tolerance of the plain gather's; BN
    # HexCNN-small's grads move by more than 1e-3 when its input moves by
    # one ulp (logged above), so the step is held to the plain path on
    # the kernel's input (the same model code: a check that the step is
    # deterministic), and its loss to the plain path's
    in_err = max_err(kernel_input, plain_input)[0]
    log(f"{label}: the hex input, plan_gather vs the plain gather: "
        f"max_abs_err={in_err!r}")
    require(in_err <= TOL["a_f32_abs"], f"{label}: plan_gather's input "
                                        f"max_abs_err {in_err}")
    _require_close(label, rels, "f32 plain on the kernel's input",
                   TOL["grad_f32_rel"])
    require(rels["f32 plain"][0] <= TOL["loss_rel"],
            f"{label}: loss vs the f32 plain path, rel {rels['f32 plain'][0]}")
    del rects, batches, plain_input, kernel_input
    log(f"phase 22 BN HexCNN-small: {time.perf_counter() - t0:.1f} s")

    # HexResNet on the reference's own data for it, each batch hexified on
    # the card (one plan_gather a batch, in the counted path) and, for the
    # check, on the CPU (the plain version)
    t0 = time.perf_counter()
    counters = KERNELS
    _zero_launches()
    data = [synthetic_hex_cifar(np.random.default_rng(20 + i),
                                HEXRESNET_BATCH, device="cuda")
            for i in range(N_STEPS + 2)]
    prep = _launches()
    require(prep == {n: len(data) if n == "plan_gather" else 0
                     for n in counters},
            f"HexResNet data: launches {prep}")
    plain_input = synthetic_hex_cifar(
        np.random.default_rng(20 + N_STEPS + 1), HEXRESNET_BATCH,
        device="cpu")[0].cuda()
    gen = torch.Generator(device="cuda").manual_seed(19)
    label = (f"HexResNet 32/64/128 x2 f32 AdamW synthetic_hex_cifar "
             f"b={HEXRESNET_BATCH} 32^2 -> 16^2 hex")
    _, rels, _ = _train_model(
        torch, label, create_train_state(HexResNet(generator=gen)),
        [x for x, _ in data], [y for _, y in data],
        {"f32 plain": (HexResNet, plain_input)}, {}, 2.0 ** -24,
        TRAIN_GROUPS)
    _require_close(label, rels, "f32 plain", TOL["grad_f32_rel"])
    paths["hexresnet_train"] = {"plan_gather": prep["plan_gather"]}
    log(f"phase 22 HexResNet: {time.perf_counter() - t0:.1f} s")
    return paths


# phase 23's augmentation: augment_hex_batch's draws on HexCNN-small's
# 256^2 hex batches (examples/train_hexcnn.py --augment)
AUGMENT = dict(rotate=True, flip=True, translate=2)


def _dihedral_hits(torch, x, out, draws):
    """Whether each image of ``out`` is one of the 12 dihedral images of
    its input in ``x`` (same-canvas rotations, each mirrored or not),
    shifted by its drawn (dy, dx)."""
    from hygrid_tpu_torch.ops import augment
    hits = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    for k in range(6):
        rot = augment.hexrot60_same(x, k)
        for cand in (rot, torch.flip(rot, dims=(-1,))):
            cand = augment.hex_translate(cand, draws["dy"], draws["dx"])
            hits |= (cand == out).flatten(1).all(1)
    return hits


def run_augment_training(torch):
    """Phase 23: HexCNN-small training with hex augmentation on the card.
    Returns the per-kernel launches of the augmented steps."""
    from hygrid_tpu_torch.models import (create_train_state,
                                         dense_onehot_xent, hexcnn_small,
                                         hexify_batch, train_step)
    from hygrid_tpu_torch.ops import augment
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda",
                         generator=gen)
    state = create_train_state(model)
    in_gen = torch.Generator(device="cuda").manual_seed(23)
    batches = [torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                          device="cuda") for _ in range(N_STEPS + 1)]
    labels = torch.arange(BATCH, device="cuda") % 10
    aug_gen = torch.Generator(device="cuda").manual_seed(230)
    # the checked run's generator state before each step's draws, its hex
    # input and its augmented input
    kept = []

    def step(batch, aug=True, keep=False):
        x = hexify_batch(batch)
        if not aug:
            return train_step(state, x, labels)[1]
        seed_state = aug_gen.get_state() if keep else None
        xa = augment.augment_hex_batch(aug_gen, x, **AUGMENT)
        if keep:
            kept.append((seed_state, x, xa))
        return train_step(state, xa, labels)[1]

    def timed(aug):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for b in batches[:N_STEPS]:
            step(b, aug)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    step(batches[0])
    step(batches[0], aug=False)
    counters = KERNELS
    _zero_launches()
    # the checked run: N_STEPS augmented steps whose draws and batches are
    # kept for the checks below, outside the timed runs
    metrics = [step(b, keep=True) for b in batches[:N_STEPS]]
    torch.cuda.synchronize()
    launches = {n: v for n, v in _launches().items() if v}
    # augmented and plain runs in turns (aug, plain, plain, aug), each over
    # the same N_STEPS distinct batches, with no bookkeeping in them
    aug_ms = [timed(True)]
    plain_ms = [timed(False), timed(False)]
    aug_ms.append(timed(True))
    per_step = {"plan_gather": 1, "hex_conv_layer": 6,
                "hex_conv_layer_dgrad": 5, "hex_conv_wgrad": 6,
                "gn_relu_backward": 6, "hex_max_pool": 2,
                "hex_max_pool_backward": 2}
    require(launches == {n: k * N_STEPS for n, k in per_step.items()},
            f"augmented training: launches {launches} in {N_STEPS} steps, "
            f"want {per_step} a step")
    losses = [float(m["loss"]) for m in metrics]
    require(all(math.isfinite(v) for v in losses),
            f"augmented training: non-finite losses {losses}")

    # each augmented batch against the plain transforms on its CPU copy at
    # the same draws, and in the dihedral orbit of its input
    for i, (seed_state, x, xa) in enumerate(kept):
        aug_gen.set_state(seed_state)
        draws = augment.augment_draws(aug_gen, BATCH, **AUGMENT)
        want = augment.apply_augment(
            x.cpu(), {n: v.cpu() for n, v in draws.items()})
        require(torch.equal(xa.cpu(), want),
                f"augmented batch {i}: not equal to the plain transforms "
                "on the CPU at the same draws")
        hits = _dihedral_hits(torch, x, xa, draws)
        require(bool(hits.all()), f"augmented batch {i}: images "
                f"{(~hits).nonzero().flatten().tolist()} are no dihedral "
                "image of their input, shifted")
        require(bool((draws["dy"] % 2 == 0).all()),
                f"augmented batch {i}: odd row shifts {draws['dy']}")

    # the augmentation alone, its host and device parts apart: per call
    # (CUDA events), the host's enqueue of a call, the draws by events,
    # and the transforms at fixed draws on the device alone (CUDA graph)
    x = kept[0][1]
    aug_call_ms = cuda_ms(torch, lambda: augment.augment_hex_batch(
        aug_gen, x, **AUGMENT))
    aug_host_ms = host_ms(torch, lambda: augment.augment_hex_batch(
        aug_gen, x, **AUGMENT), calls=20)
    draws_ms = cuda_ms(torch, lambda: augment.augment_draws(
        aug_gen, BATCH, **AUGMENT))
    fixed = augment.augment_draws(aug_gen, BATCH, **AUGMENT)
    apply_ms = cuda_ms(torch, lambda: augment.apply_augment(x, fixed))
    apply_dev_ms = graph_ms(torch, lambda: augment.apply_augment(x, fixed))
    aug_bound, aug_by = bound(2 * nbytes(x), 0, "f32")

    # one more step from a snapshot, against the plain path in float32 on
    # the same augmented input (phase 7's gate)
    batch = batches[-1]
    snapshot = {k: v.clone() for k, v in model.state_dict().items()}
    loss = float(step(batch, keep=True)["loss"])
    seed_state, _, xa = kept[-1]
    aug_gen.set_state(seed_state)
    draws = augment.augment_draws(aug_gen, BATCH, **AUGMENT)
    m = hexcnn_small(norm="GN", dtype=torch.float32, device="cuda")
    m.load_state_dict(snapshot)
    x_plain = augment.apply_augment(hexify_batch(batch, plain=True), draws)
    with torch.no_grad():
        ref_loss = float(dense_onehot_xent(m(x_plain, plain=True), labels))
    loss_rel = abs(loss - ref_loss) / abs(ref_loss)
    in_err = max_err(xa, x_plain)

    def rates(times):
        return [BATCH * N_STEPS / (t / 1e3) for t in times]

    log(f"augmented training HexCNN-small GN bf16 AdamW b={BATCH} 512^2 "
        f"(augment_hex_batch {AUGMENT} on the 256^2 hex batch), runs of "
        f"{N_STEPS} steps in turns (aug, plain, plain, aug), CUDA events: "
        f"augmented {aug_ms!r} ms, images/s={rates(aug_ms)!r}; without "
        f"augmentation {plain_ms!r} ms, images/s={rates(plain_ms)!r}; "
        f"launches {launches}; losses={losses}")
    step_ms = sum(aug_ms) / len(aug_ms) / N_STEPS
    added_ms = (sum(aug_ms) - sum(plain_ms)) / len(aug_ms) / N_STEPS
    log(f"augmentation b={BATCH} C=3 256^2 float32: {aug_call_ms!r} ms a "
        f"batch (CUDA events, {100 * aug_call_ms / step_ms:.2f} "
        f"% of an augmented step; the augmented step is {added_ms!r} ms "
        f"longer than the plain one), the host's enqueue {aug_host_ms!r} "
        f"ms a call; the draws {draws_ms!r} ms (CUDA events), the "
        f"transforms at fixed draws {apply_ms!r} ms (CUDA events) and "
        f"{apply_dev_ms!r} ms on the device alone (CUDA graph); bound "
        f"{aug_bound!r} ms ({aug_by}: the batch read and written once, "
        f"{2 * nbytes(x)} bytes); the {N_STEPS} batches of the checked run "
        "torch.equal to the plain transforms on their CPU copies and each "
        "image in its dihedral orbit, shifted")
    log(f"augmented step vs plain f32 on the card (same draws): loss "
        f"{loss!r} vs {ref_loss!r} (rel {loss_rel!r}); input vs the plain "
        f"gather's {in_err}")
    require(loss_rel <= TOL["loss_rel"],
            f"augmented training loss {loss} vs plain f32 {ref_loss}: rel "
            f"{loss_rel}")
    return launches


def check_hexrot(torch, gen):
    """Phase 23b: hexrot60 on plan_gather's dense form.  Returns the
    launches of its calls and the kernels line's numbers."""
    from hygrid_tpu_torch.kernels import resample
    from hygrid_tpu_torch.ops import hexrot, sampling
    x32 = torch.rand((BATCH, 3, 256, 256), generator=gen,
                     device="cuda") * 255
    xs = {"float32": x32, "bfloat16": x32.to(torch.bfloat16),
          "uint8": x32.to(torch.uint8)}
    counters = KERNELS
    launches, summary = {}, {}
    for k in range(1, 6):
        plan = hexrot.rot_plan(256, 256, k)
        line = f"hexrot60 k={k} 256^2->{plan.out_shape} b={BATCH} C=3:"
        for name, x in xs.items():
            esz = 2 if name == "uint8" else x.element_size()
            tables = resample.gather_tables_cached(plan, esz)
            require(tables.index_form == "dense",
                    f"hexrot60 k={k}: {tables.index_form} index form, not "
                    "dense")
            _zero_launches()
            got = hexrot.hexrot60(x, k)
            again = hexrot.hexrot60(x, k)
            torch.cuda.synchronize()
            used = {n: v for n, v in _launches().items() if v}
            require(used == {"plan_gather": 2},
                    f"hexrot60 k={k} {name}: launches {used}")
            for n, c in used.items():
                launches[n] = launches.get(n, 0) + c
            want = sampling.apply_plan(x, plan)
            require(got.dtype == x.dtype and torch.equal(got, want),
                    f"hexrot60 k={k} {name}: not torch.equal to apply_plan")
            require(torch.equal(got, again),
                    f"hexrot60 k={k} {name}: two launches differ")
            ms = cuda_ms(torch, lambda: hexrot.hexrot60(x, k))
            xk = x if name != "uint8" else x.to(torch.bfloat16)
            dev = graph_ms(torch, lambda: resample.plan_gather(xk, plan))
            plain = cuda_ms(torch, lambda: sampling.apply_plan(x, plan))
            b_ms, b_by = bound(nbytes(xk) + got.numel() * xk.element_size()
                               + tables.table_bytes, 0, "f32")
            line += (f" {name} {ms!r} ms a call, device {dev!r} ms (CUDA "
                     f"graph), plain {plain!r} ms, bound {b_ms!r} ms "
                     f"({b_by}, dense table {tables.table_bytes} bytes);")
            if k == 1 and name == "float32":
                summary = dict(hexrot_ms=ms, hexrot_device_ms=dev,
                               hexrot_plain_ms=plain, hexrot_bound_ms=b_ms)
        log(line + " torch.equal to apply_plan, two launches bit-equal")
    return launches, summary


# phase 24: one Sentinel-2 L2A 10 m tile (B02, B03, B04, B08), its UTM zone,
# the tiled resample's default tile, and the viewer's window
S2_BANDS, S2_SIZE, S2_HEX = 4, 10980, (5490, 5490)
S2_GEO = (399960.0, 10.0, 0.0, 5000040.0, 0.0, -10.0)
S2_PROJ = "EPSG:32633"
S2_TILE_ROWS = 2048
VIEW_WINDOW, VIEW_OUT = (540, 960), (2160, 3840)
# plan_gather against apply_plan on the raster's values (0..9999): the
# kernel's fmaf chain and the plain product-then-sum may round apart, so
# the gate is phase 3's a_f32_abs on [0, 1) inputs, relative to the
# largest value
PLAIN_REL = 1e-6


def run_ingest(torch):
    """Phase 24: raster ingest at a deployment's size.  Returns the
    launches of the main path and the kernels line's numbers."""
    from hygrid_tpu_torch.image import HEXIMAGE, IMAGE, codecs
    from hygrid_tpu_torch.kernels import resample
    from hygrid_tpu_torch.ops import geometry, pad, sampling, tiled
    from hygrid_tpu_torch.viz import render
    import os
    os.environ.pop("DISPLAY", None)     # Hex_imshow shows no window
    secs = {}

    def stage(name, t0):
        secs[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    rng = np.random.default_rng(24)
    raster = rng.integers(0, 10000, (S2_BANDS, S2_SIZE, S2_SIZE),
                          dtype=np.uint16)
    stage("make", t0)
    (ROOT / "build").mkdir(exist_ok=True)
    counters = KERNELS
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "s2_l2a_10m.tif")
        t0 = time.perf_counter()
        codecs.write_raster(path, raster, S2_GEO, S2_PROJ, compress="none")
        stage("write", t0)
        _zero_launches()
        # the main path: disk -> IMAGE -> tiled rect->hex on the card ->
        # pad -> HEXIMAGE window -> mosaic -> .heximg round trip
        t0 = time.perf_counter()
        img = IMAGE(path)
        stage("read", t0)
        require(img._reader is not None and img.shape == raster.shape
                and img.proj == S2_PROJ and np.allclose(img.geotrans, S2_GEO)
                and np.array_equal(img.Image, raster),
                "ingest: IMAGE did not read the raster back through its "
                "window reader with its tags")
        t0 = time.perf_counter()
        geometry.rect_to_hex_plan(S2_SIZE, S2_SIZE, *S2_HEX, "bilinear")
        stage("plan", t0)
        t0 = time.perf_counter()
        hexed = tiled.tiled_rect_to_hex(img.Image, S2_HEX, "bilinear",
                                        tile_rows=S2_TILE_ROWS)
        stage("tiled", t0)
        t0 = time.perf_counter()
        hwc = torch.from_numpy(hexed).to("cuda").permute(1, 2, 0)
        padded = pad.hex_impad_to_multiple(hwc, 4)
        torch.cuda.synchronize()
        stage("pad", t0)
        r0, c0 = 2000, 2400
        window = np.ascontiguousarray(
            hexed[:3, r0:r0 + VIEW_WINDOW[0], c0:c0 + VIEW_WINDOW[1]] / 40.0,
            np.float32)
        t0 = time.perf_counter()
        him = HEXIMAGE(data=window, geotrans=S2_GEO, proj=S2_PROJ)
        frame = him.Hex_imshow(out_size=VIEW_OUT)
        stage("view", t0)
        t0 = time.perf_counter()
        him.SaveHexImage(str(Path(tmp) / "window.heximg"))
        back = HEXIMAGE(str(Path(tmp) / "window.heximg"))
        stage("heximg", t0)
        launches = {n: v for n, v in _launches().items() if v}
        n_tiles = -(-S2_HEX[0] // S2_TILE_ROWS)
        require(launches == {"plan_gather": n_tiles, "shift_resample": 1},
                f"ingest: launches {launches}, want {n_tiles} plan_gather "
                "and 1 shift_resample")
        require(back.shape == him.shape and np.array_equal(
            back.HexagonImage, window) and back.proj == S2_PROJ
            and back.geotrans == S2_GEO, "ingest: the .heximg round trip "
            "changed the window")

    # the tiled resample again on the same shape, its stages split (the
    # calls of tiled._tiled_apply, synchronised between stages), each
    # tile's kernel on its sub-plan held against the plain gather of the
    # same band and sub-plan
    plan = geometry.rect_to_hex_plan(S2_SIZE, S2_SIZE, *S2_HEX, "bilinear")
    split = dict.fromkeys(("sub_plans", "tables", "h2d", "kernel", "d2h"),
                          0.0)
    kernel_ms, tiles, forms, vs_plain = 0.0, [], set(), []

    def vs(got, want):
        """'bit-equal', or the relative error within PLAIN_REL."""
        if torch.equal(got, want):
            return "bit-equal"
        _, rel = max_err(got, want)
        require(rel <= PLAIN_REL, f"ingest: plan_gather vs apply_plan rel "
                f"{rel} > {PLAIN_REL}")
        return f"rel {rel!r}"

    for r0 in range(0, S2_HEX[0], S2_TILE_ROWS):
        t0 = time.perf_counter()
        lo, hi, sub = plan.row_slice(r0, min(r0 + S2_TILE_ROWS, S2_HEX[0]))
        split["sub_plans"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        tables = resample.gather_tables_cached(sub, 4)
        split["tables"] += time.perf_counter() - t0
        require(tables.weight_form == "factored",
                f"ingest tile at row {r0}: {tables.weight_form} weights, "
                "not the plan's factored table")
        forms.add(f"{tables.index_form}/{tables.weight_form}")
        t0 = time.perf_counter()
        band = torch.from_numpy(np.ascontiguousarray(
            img.Image[:, lo:hi + 1])).to("cuda").float()
        torch.cuda.synchronize()
        split["h2d"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        out = sampling.apply_plan_auto(band, sub)
        torch.cuda.synchronize()
        split["kernel"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        tiles.append(out.cpu().numpy())
        split["d2h"] += time.perf_counter() - t0
        vs_plain.append(vs(out, sampling.apply_plan(band, sub)))
        kernel_ms += cuda_ms(torch, lambda: sampling.apply_plan_auto(
            band, sub), iters=5, warmup=1)
    require(np.array_equal(np.concatenate(tiles, axis=-2), hexed),
            "ingest: the split run differs from tiled_rect_to_hex")
    # against the monolithic resample of the whole raster on the card, and
    # that against the plain gather
    full = torch.from_numpy(img.Image).to("cuda").float()
    mono = geometry.rect_to_hex_resample(full, S2_HEX, "bilinear")
    mono_vs_plain = vs(mono, sampling.apply_plan(full, plan))
    mono_np = mono.cpu().numpy()
    equal = bool(np.array_equal(mono_np, hexed))
    _, rel = max_err(torch.from_numpy(hexed), torch.from_numpy(mono_np))
    require(equal or rel <= 1e-6, f"ingest: tiled vs monolithic rel {rel}")
    mono_ms = cuda_ms(torch, lambda: geometry.rect_to_hex_resample(
        full, S2_HEX, "bilinear"), iters=3, warmup=1)
    b_ms, b_by = bound(nbytes(full, mono), 0, "f32")
    # the pad and the mosaic against their plain counterparts
    want_pad = np.zeros((5492, 5492, S2_BANDS), np.float32)
    want_pad[:S2_HEX[0], :S2_HEX[1]] = hexed.transpose(1, 2, 0)
    require(np.array_equal(padded.cpu().numpy(), want_pad),
            "ingest: hex_impad_to_multiple(., 4) is not the zero pad")
    want_frame = np.clip(render.render_mosaic(
        torch.from_numpy(window).to("cuda"), VIEW_OUT).cpu().numpy(),
        0, 255).astype(np.uint8)
    require(frame.shape == (3,) + VIEW_OUT
            and np.array_equal(frame, want_frame),
            "ingest: Hex_imshow differs from render_mosaic of the window")
    e2e = secs["read"] + secs["plan"] + secs["tiled"]
    mpix = S2_SIZE * S2_SIZE / 1e6
    log(f"ingest Sentinel-2 L2A 10 m tile {S2_BANDS}x{S2_SIZE}^2 uint16 "
        f"({raster.nbytes} bytes, uncompressed GeoTIFF, {S2_PROJ}) -> hex "
        f"{S2_HEX} bilinear, tile_rows={S2_TILE_ROWS}: seconds "
        + ", ".join(f"{n}={s!r}" for n, s in secs.items())
        + f"; tiled again, split ({len(tiles)} tiles, {sorted(forms)} "
        "tables): "
        + ", ".join(f"{n}={s!r}" for n, s in split.items())
        + f" (together {sum(split.values())!r} s against the first "
        f"call's {secs['tiled']!r}); kernel {kernel_ms!r} ms over the "
        "tiles (CUDA events, each tile's call repeated), "
        f"monolithic {mono_ms!r} ms, bound {b_ms!r} ms ({b_by}: "
        f"{nbytes(full, mono)} bytes); end to end (read, plan, tiled) "
        f"{mpix / e2e!r} Mpix/s; tiled vs monolithic "
        f"{'bit-equal' if equal else f'rel {rel!r} (not bit-equal)'}; "
        f"plan_gather vs apply_plan: tiles {vs_plain}, monolithic "
        f"{mono_vs_plain}; "
        f"launches {launches}; the mosaic bit-equal to render_mosaic, the "
        ".heximg round trip exact")
    return launches, dict(ingest_kernel_ms=kernel_ms,
                          ingest_monolithic_ms=mono_ms,
                          ingest_bound_ms=b_ms, ingest_s=e2e)


# phases 25-26: the parallel package (dp / sp / pp over torch.distributed)
# on the card.  The 4K chain of tests/test_models_parallel.py:843-871 at
# full size: a 2160x3840 RGB frame to hex 1080x1920 (bilinear), padded to
# 16 channels, four 16->16 radius-2 hex convs on hex_conv_single, and back
# to 2160x3840 (linear); phase 26 runs it on RANKS ranks, each holding 540
# source and 270 hex rows.
CHAIN_SRC = (2160, 3840)
CHAIN_HEX = (1080, 1920)
CHAIN_C = 16
CHAIN_LAYERS = 4
# the pipeline at P-512's width: 16 channels, 8 layers, b=16 on 256^2 hex
# (its own names: P-512 itself keeps PIPE_LAYERS)
PAR_PIPE_SHAPE = (16, 16, 256, 256)
PAR_PIPE_LAYERS = 8
RANKS = 4
RANKS_TIMEOUT_S = 600
PAR_TOL = {"f32_rel": 1e-5, "bf16_rel": 5e-2, "fit_rel": 1e-6,
           "pipe_grad_rel": 1e-4}
# one HexCNN-small training step's launches (phase 7)
TRAIN_STEP_LAUNCHES = {"plan_gather": 1, "hex_conv_layer": 6,
                       "hex_conv_layer_dgrad": 5, "hex_conv_wgrad": 6,
                       "gn_relu_backward": 6, "hex_max_pool": 2,
                       "hex_max_pool_backward": 2}


def chain_frame(torch, r0, r1):
    """Rows ``r0:r1`` of the chain's 3 x 2160 x 3840 float32 frame, as
    ``(1, 3, r1 - r0, 3840)`` on the card: each pixel a function of its
    global coordinates (waves and a hashed noise), so that a rank makes
    its own rows and nothing else."""
    i = torch.arange(r0, r1, device="cuda", dtype=torch.float32)[:, None]
    j = torch.arange(CHAIN_SRC[1], device="cuda", dtype=torch.float32)[None]
    planes = []
    for c in range(3):
        wave = 0.5 + 0.25 * torch.sin(0.0123 * i + 0.0071 * j + 2.1 * c)
        noise = torch.frac(torch.sin(i * 12.9898 + j * 78.233 + 37.719 * c)
                           * 43758.5453)
        planes.append(wave + 0.25 * noise)
    return torch.stack(planes)[None]


def chain_kernels(torch):
    gen = torch.Generator(device="cuda").manual_seed(25)
    return [torch.randn((CHAIN_C, CHAIN_C, 7), generator=gen, device="cuda")
            * 0.1 for _ in range(CHAIN_LAYERS)]


def _pad_channels(torch, h):
    return torch.cat([h, h.new_zeros((h.shape[0], CHAIN_C - h.shape[1])
                                     + tuple(h.shape[2:]))], 1)


def sharded_chain(torch, parallel, mesh, x, kernels):
    """The 4K chain on this rank's slab ``x`` of the frame, row-sharded over
    ``mesh``'s ``"sp"`` axis; returns this rank's slab of the output."""
    h = parallel.sharded_resample(x, mesh, "rect_to_hex", CHAIN_HEX,
                                  "bilinear", size=CHAIN_SRC)
    h = _pad_channels(torch, h)
    for k in kernels:
        h = parallel.sharded_hex_conv2d(h, k.to(h.dtype), mesh, radius=2,
                                        impl="pallas", size=CHAIN_HEX)
    return parallel.sharded_resample(h, mesh, "hex_to_rect", CHAIN_SRC,
                                     "linear", size=CHAIN_HEX)


class _PlanTimes:
    """Record the host seconds of every per-shard plan build
    (``spatial.shard_plans``, which ``sharded_resample`` calls once a
    call) while the block runs."""

    def __enter__(self):
        from hygrid_tpu_torch.parallel import spatial
        self.seconds, self._orig = [], spatial.shard_plans

        def timed(*args, **kwargs):
            plans = self._orig(*args, **kwargs)
            self.seconds.append(plans.seconds)
            return plans

        spatial.shard_plans = timed
        return self

    def __exit__(self, *exc):
        from hygrid_tpu_torch.parallel import spatial
        spatial.shard_plans = self._orig


def _counts():
    """(kernel launches, collectives) since the last :func:`_zero_counts`,
    only those that are not zero."""
    from hygrid_tpu_torch.parallel import _comm
    launches = _launches()
    return ({k: v for k, v in launches.items() if v},
            {k: v for k, v in _comm.COUNTS.items() if v})


def _zero_counts():
    from hygrid_tpu_torch.parallel import _comm
    _zero_launches()
    _comm.reset_counts()


def pipeline_inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(26)
    c = PAR_PIPE_SHAPE[1]
    ks = torch.randn((PAR_PIPE_LAYERS, c, c, 7),
                     generator=gen, device="cuda") * 0.1
    x = torch.randn(PAR_PIPE_SHAPE, generator=gen, device="cuda")
    w = torch.randn(PAR_PIPE_SHAPE, generator=gen, device="cuda")
    return ks, x, w


class _EpochBatches:
    """Epoch ``e`` of ``fit`` yields batch ``e`` alone, hexified when the
    step reads it, so each epoch's checkpoint holds one step's
    parameters."""

    def __init__(self, hexify, xs, labels):
        self.hexify, self.xs, self.labels, self.epoch = hexify, xs, labels, 0

    def __iter__(self):
        x = self.xs[self.epoch]
        self.epoch += 1
        yield self.hexify(x), self.labels


def _par_train(torch, parallel, tmp):
    """Phase 25's data-parallel training: ``fit`` over a ``dp`` mesh of one
    rank against ``train_step`` without a mesh, step by step."""
    from hygrid_tpu_torch.models import (create_train_state, fit,
                                         hexcnn_small, hexify_batch,
                                         train_step)
    from hygrid_tpu_torch.utils import restore_checkpoint
    mesh = parallel.create_mesh({"dp": 1})
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda",
                         generator=gen)
    twin = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda")
    twin.load_state_dict(model.state_dict())
    in_gen = torch.Generator(device="cuda").manual_seed(2)
    xs = [torch.rand((BATCH, 3, 512, 512), generator=in_gen, device="cuda")
          for _ in range(N_STEPS)]
    labels = torch.arange(BATCH, device="cuda") % 10
    ck = str(Path(tmp) / "ck")

    torch.cuda.synchronize()
    _zero_counts()
    t0 = time.perf_counter()
    _, hist = fit(model, _EpochBatches(hexify_batch, xs, labels),
                  num_epochs=N_STEPS, mesh=mesh, checkpoint_path=ck,
                  log_every=1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / N_STEPS
    launches, comm = _counts()
    want = {k: n * N_STEPS for k, n in TRAIN_STEP_LAUNCHES.items()}
    require(launches == want, f"phase 25 fit(mesh=dp 1): launches "
                              f"{launches}, want {want} (phase 7's)")
    require(comm.get("all_reduce", 0) >= N_STEPS,
            f"phase 25 fit: {comm} has no gradient all-reduce a step")

    # the twin: train_step without a mesh from the same weights; each
    # step's loss against fit's history, its parameters against the
    # epoch's checkpoint
    state = create_train_state(twin)
    worst = {"loss": 0.0, "params": 0.0}
    first = None
    for e in range(N_STEPS):
        _, m = train_step(state, hexify_batch(xs[e]), labels)
        loss = float(m["loss"])
        if first is None:
            first = {"loss": loss, "grads": {
                n: p.grad.float().cpu() for n, p in twin.named_parameters()}}
        worst["loss"] = max(worst["loss"],
                            abs(loss - hist["loss"][e]) / abs(loss))
        saved = restore_checkpoint(f"{ck}_e{e}.npz")
        for n, p in twin.named_parameters():
            got = torch.from_numpy(saved[f"[{n!r}]"]).to(p.device)
            worst["params"] = max(worst["params"], max_err(got, p)[1])
    fresh = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda")
    restore_checkpoint(f"{ck}_e{N_STEPS - 1}.npz", fresh)
    with torch.inference_mode():
        xh = hexify_batch(xs[0])
        restored_equal = torch.equal(fresh(xh), model(xh))
    log(f"phase 25 fit(mesh=dp 1, NCCL, checkpoint_path=) HexCNN-small GN "
        f"bf16 b={BATCH} 512^2, {N_STEPS} one-step epochs: {wall!r} ms a "
        f"step (host clock, the checkpoint write included); launches "
        f"{launches}; collectives {comm}; losses {hist['loss']}; against "
        f"train_step without a mesh: loss rel {worst['loss']!r}, params "
        f"rel {worst['params']!r} (max over steps); restored checkpoint "
        f"logits torch.equal: {restored_equal}")
    require(max(worst.values()) <= PAR_TOL["fit_rel"],
            f"phase 25 fit(mesh=) vs train_step: {worst}")
    require(restored_equal, "phase 25: restored checkpoint's logits differ")
    return launches, first


def _par_chain(torch, parallel):
    """Phase 25's 4K chain on an ``sp`` mesh of one rank, float32 and
    bfloat16, against the same ops unsharded."""
    from hygrid_tpu_torch.nn.functional import hex_conv2d
    from hygrid_tpu_torch.ops.geometry import (hex_to_rect_resample,
                                               rect_to_hex_resample)
    mesh = parallel.create_mesh({"sp": 1})
    frame = chain_frame(torch, 0, CHAIN_SRC[0])
    kernels = chain_kernels(torch)
    launches, outs = {}, {}
    for dtype, tol in ((torch.float32, "f32_rel"),
                       (torch.bfloat16, "bf16_rel")):
        x = frame.to(dtype)
        torch.cuda.synchronize()
        _zero_counts()
        with _PlanTimes() as plans:
            t0 = time.perf_counter()
            got = sharded_chain(torch, parallel, mesh, x, kernels)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        counts, comm = _counts()
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        h = _pad_channels(torch, rect_to_hex_resample(x, CHAIN_HEX,
                                                      "bilinear"))
        for k in kernels:
            h = hex_conv2d(h, k.to(dtype), radius=2, padding=1,
                           impl="pallas")
        want = hex_to_rect_resample(h, CHAIN_SRC, "linear")
        err, rel = max_err(got, want)
        name = str(dtype).replace("torch.", "")
        log(f"phase 25 sharded 4K chain (sp 1, NCCL) {name}: {wall!r} ms "
            f"(host clock, per-shard plans built in the call: "
            f"{[round(s, 3) for s in plans.seconds]} s); launches {counts}; "
            f"collectives {comm}; vs unsharded ops max_abs_err={err!r} "
            f"rel={rel!r}, bit-equal {torch.equal(got, want)}")
        require(counts.get("plan_gather", 0)
                + counts.get("shift_resample", 0) == 2
                and counts.get("hex_conv_single") == CHAIN_LAYERS,
                f"phase 25 chain {name}: launches {counts}")
        require(not comm.get("all_reduce") and not comm.get("broadcast"),
                f"phase 25 chain {name}: collectives {comm}")
        require(bool(torch.isfinite(got).all())
                and tuple(got.shape) == (1, CHAIN_C) + CHAIN_SRC,
                f"phase 25 chain {name}: {tuple(got.shape)} or non-finite")
        require(rel <= PAR_TOL[tol], f"phase 25 chain {name}: rel {rel}")
        outs[name] = got
    return launches, outs


def _pipeline_step(torch, parallel, mesh, ks, x, w):
    ks = ks.clone().requires_grad_(True)
    y = parallel.pipeline_hex_conv_stack(x, ks, mesh, radius=2)
    (y * w).sum().backward()
    return y.detach(), ks.grad


def _par_pipeline(torch, parallel):
    """Phase 25's pipeline on a ``pp`` mesh of one rank, forward and grad,
    against the sequential stack on the same microbatches."""
    from hygrid_tpu_torch.nn.functional import hex_conv2d
    mesh = parallel.create_mesh({"pp": 1})
    ks, x, w = pipeline_inputs(torch)
    t0 = time.perf_counter()
    y, g = _pipeline_step(torch, parallel, mesh, ks, x, w)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kseq = ks.clone().requires_grad_(True)
    parts = []
    for xm in x.split(PAR_PIPE_SHAPE[0] // 4):   # its default 4 microbatches
        for k in kseq:
            xm = hex_conv2d(xm, k, radius=2, padding=1)
        parts.append(xm)
    seq = torch.cat(parts)
    (seq * w).sum().backward()
    err, rel = max_err(y, seq)
    gerr, grel = max_err(g, kseq.grad)
    log(f"phase 25 pipeline (pp 1) {PAR_PIPE_LAYERS} layers x "
        f"{PAR_PIPE_SHAPE} "
        f"f32, forward and grad: {wall!r} ms (host clock); vs the "
        f"sequential stack: out rel {rel!r} (bit-equal "
        f"{torch.equal(y, seq)}), kernel grad rel {grel!r}")
    require(rel <= PAR_TOL["f32_rel"] and grel <= PAR_TOL["pipe_grad_rel"],
            f"phase 25 pipeline: out rel {rel}, grad rel {grel}")
    return y, g


def run_parallel(torch, tmp):
    """Phase 25: the parallel package in this process, a world of one rank
    on NCCL.  Returns the launches and the results phase 26 is held to."""
    import torch.distributed as dist
    from hygrid_tpu_torch import parallel
    parallel.initialize_multihost(f"file://{tmp}/rendezvous25", 1, 0,
                                  device="cuda")
    require(dist.get_backend() == "nccl", "phase 25: the backend is "
                                          f"{dist.get_backend()}, not nccl")
    try:
        launches, train = _par_train(torch, parallel, tmp)
        chain_launches, chain = _par_chain(torch, parallel)
        pipe = _par_pipeline(torch, parallel)
    finally:
        dist.destroy_process_group()
    for k, v in chain_launches.items():
        launches[k] = launches.get(k, 0) + v
    return launches, {"train": train, "chain": chain, "pipe": pipe}


def _rank26(rank, tmp, q):
    """Phase 26's rank ``rank``: the chain at sp=4, one dp=4 training step
    and the pp=4 pipeline, on ``cuda:0`` over gloo.  Large results go to
    files in ``tmp``; the rest back through ``q`` as numpy arrays (a
    tensor would travel as a handle to this process's memory, gone when it
    exits)."""
    import traceback
    try:
        import torch
        from hygrid_tpu_torch import parallel
        from hygrid_tpu_torch.models import (create_train_state, hexcnn_small,
                                             hexify_batch, train_step)
        torch.cuda.set_device(0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        parallel.initialize_multihost(f"file://{tmp}/rendezvous26", RANKS,
                                      rank, backend="gloo")
        sp = parallel.create_mesh({"sp": RANKS})
        dp = parallel.create_mesh({"dp": RANKS})
        pp = parallel.create_mesh({"pp": RANKS})
        out = {}
        rows = CHAIN_SRC[0] // RANKS
        frame = chain_frame(torch, rank * rows, (rank + 1) * rows)
        kernels = chain_kernels(torch)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            x = frame.to(dtype)
            torch.cuda.synchronize()
            _zero_counts()
            with _PlanTimes() as plans:
                t0 = time.perf_counter()
                got = sharded_chain(torch, parallel, sp, x, kernels)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            launches, comm = _counts()
            torch.save(got.cpu(), f"{tmp}/chain_{name}_{rank}.pt")
            out[f"chain_{name}"] = dict(ms=wall, plan_s=plans.seconds,
                                        launches=launches, comm=comm,
                                        slab=tuple(x.shape[-2:]))
        # one data-parallel step of phase 25's model on its first batch
        gen = torch.Generator(device="cuda").manual_seed(0)
        model = hexcnn_small(norm="GN", dtype=torch.bfloat16, device="cuda",
                             generator=gen)
        parallel.replicate(model, dp)
        state = create_train_state(model)
        in_gen = torch.Generator(device="cuda").manual_seed(2)
        batch = torch.rand((BATCH, 3, 512, 512), generator=in_gen,
                           device="cuda")
        xs = parallel.shard_batch(batch, dp)
        ys = parallel.shard_batch(torch.arange(BATCH, device="cuda") % 10, dp)
        del batch
        hexify_batch(xs)   # the rect->hex plan and its table, built once
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        _, metrics = train_step(state, hexify_batch(xs), ys, mesh=dp)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches, comm = _counts()
        out["train"] = dict(ms=wall, launches=launches, comm=comm,
                            loss=float(metrics["loss"]), grads={
                                n: p.grad.float().cpu().numpy()
                                for n, p in model.named_parameters()})
        # the pipeline, a stage a rank
        ks, x, w = pipeline_inputs(torch)
        _zero_counts()
        t0 = time.perf_counter()
        y, g = _pipeline_step(torch, parallel, pp, ks, x, w)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launches, comm = _counts()
        per = PAR_PIPE_LAYERS // RANKS
        out["pipe"] = dict(ms=wall, comm=comm,
                           grad=g[rank * per:(rank + 1) * per].cpu().numpy())
        if rank == 0:
            torch.save(y.cpu(), f"{tmp}/pipe_0.pt")
        torch.distributed.destroy_process_group()
        q.put((rank, True, out))
    except BaseException:
        q.put((rank, False, traceback.format_exc()))
        raise


def _spawn_ranks(tmp):
    """Start ``RANKS`` processes of :func:`_rank26`; return their results,
    or raise when one fails or ``RANKS_TIMEOUT_S`` passes.  Every process
    is joined or killed before this returns."""
    import multiprocessing as mp
    import queue
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank26, args=(r, tmp, q))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    results, error = [None] * RANKS, None
    try:
        while any(r is None for r in results) and error is None:
            try:
                rank, ok, value = q.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead:
                    error = f"ranks {dead} died"
                elif time.monotonic() > deadline:
                    error = f"no result within {RANKS_TIMEOUT_S} s"
                continue
            if ok:
                results[rank] = value
            else:
                error = f"rank {rank}:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=30 if error is None else 5)
            if p.is_alive():
                p.kill()
                p.join(10)
    if error is not None:
        raise RuntimeError(f"phase 26: {error}")
    return results


def run_parallel_ranks(torch, tmp, ref):
    """Phase 26: ``RANKS`` processes on the one card over gloo, each held to
    phase 25's single-process result."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _spawn_ranks(tmp)
    log(f"phase 26: {RANKS} ranks on one card over gloo "
        f"(four processes sharing one card: no measure of scaling), "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    for name, tol in (("float32", "f32_rel"), ("bfloat16", "bf16_rel")):
        got = torch.cat([torch.load(f"{tmp}/chain_{name}_{r}.pt")
                         for r in range(RANKS)], -2)
        got = got.cuda()
        err, rel = max_err(got, ref["chain"][name])
        for r, res in enumerate(ranks):
            c = res[f"chain_{name}"]
            log(f"phase 26 rank {r} sharded 4K chain {name} (sp {RANKS}, "
                f"slab {c['slab']} source rows/cols): {c['ms']!r} ms, plans "
                f"{[round(s, 3) for s in c['plan_s']]} s, halo bytes sent "
                f"{c['comm'].get('p2p_bytes', 0)}, collectives {c['comm']}, "
                f"launches {c['launches']}")
            # a shard's plan may take the shift route (#5/#6), as in
            # hygrid_tpu: apply_plan_auto decides by its structure
            legs = (c["launches"].get("plan_gather", 0)
                    + c["launches"].get("shift_resample", 0))
            require(legs == 2
                    and c["launches"].get("hex_conv_single") == CHAIN_LAYERS,
                    f"phase 26 rank {r} chain {name}: {c['launches']}")
            require(c["comm"].get("send", 0) == c["comm"].get("recv", 0) > 0
                    and not c["comm"].get("all_reduce")
                    and not c["comm"].get("broadcast"),
                    f"phase 26 rank {r} chain {name}: collectives "
                    f"{c['comm']}, want send/recv of halos alone")
        log(f"phase 26 chain {name} vs phase 25 (sp 1): max_abs_err={err!r} "
            f"rel={rel!r}, bit-equal {torch.equal(got, ref['chain'][name])}")
        require(rel <= PAR_TOL[tol], f"phase 26 chain {name}: rel {rel}")
    want = ref["train"]
    loss_rel = max(abs(r["train"]["loss"] - want["loss"]) / abs(want["loss"])
                   for r in ranks)
    grad_rel = max(max_err(torch.from_numpy(r["train"]["grads"][n]), g)[1]
                   for r in ranks for n, g in want["grads"].items())
    for r, res in enumerate(ranks):
        t = res["train"]
        log(f"phase 26 rank {r} dp {RANKS} train_step HexCNN-small GN bf16 "
            f"b={BATCH // RANKS} of {BATCH}: {t['ms']!r} ms (host clock); "
            f"launches {t['launches']}; collectives {t['comm']}")
        require(t["comm"].get("all_reduce", 0) >= 1,
                f"phase 26 rank {r}: no gradient all-reduce")
        require(t["launches"] == TRAIN_STEP_LAUNCHES,
                f"phase 26 rank {r} train launches {t['launches']}")
    log(f"phase 26 dp {RANKS} step vs phase 25's step on the global batch: "
        f"loss rel {loss_rel!r}, grads rel max-abs {grad_rel!r} (max over "
        f"ranks and leaves)")
    require(loss_rel <= TOL["loss_rel"] and grad_rel <= TOL["grad_bf16_rel"],
            f"phase 26 dp step: loss rel {loss_rel}, grad rel {grad_rel}")
    y = torch.load(f"{tmp}/pipe_0.pt").cuda()
    g = torch.cat([torch.from_numpy(r["pipe"]["grad"]) for r in ranks]).cuda()
    _, rel = max_err(y, ref["pipe"][0])
    _, grel = max_err(g, ref["pipe"][1])
    for r, res in enumerate(ranks):
        log(f"phase 26 rank {r} pipeline (pp {RANKS}): {res['pipe']['ms']!r} "
            f"ms forward and grad; collectives {res['pipe']['comm']}")
    log(f"phase 26 pipeline vs phase 25: out rel {rel!r}, grad rel {grel!r}")
    require(rel <= PAR_TOL["f32_rel"] and grel <= PAR_TOL["pipe_grad_rel"],
            f"phase 26 pipeline: out rel {rel}, grad rel {grel}")


# phase 27: torch.export on the card.  HexCNN-small (phase 5's model) is
# exported with a symbolic batch from a b=BATCH example and served from the
# reloaded artifact at EXPORT_BATCHES; the other programs at EXPORT_BATCH
EXPORT_BATCHES = (BATCH, 8)
EXPORT_BATCH = 2
SERVE_LAUNCHES = {"plan_gather": 1, "hex_conv_layer": 6, "hex_max_pool": 2}
# a program exported on the CPU traced the pools' plain path (the kernel
# takes CUDA tensors alone), so it launches no pool kernel on the card
CPU_EXPORT_LAUNCHES = {k: v for k, v in SERVE_LAUNCHES.items()
                       if k != "hex_max_pool"}


def _export_artifact(torch, tmp, name, export, device=None):
    """``export()`` (an ``Exported``) saved to ``tmp`` and loaded again
    (moved to ``device`` when given): ``(program, export_s, load_s,
    artifact_bytes)``."""
    from hygrid_tpu_torch.utils import export as texp
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    exp = export()
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    path = Path(tmp) / f"{name}.pt2"
    texp.save_exported(str(path), exp)
    t0 = time.perf_counter()
    program = texp.load_exported(str(path), device=device)
    return program, export_s, time.perf_counter() - t0, path.stat().st_size


def _counted(torch, fn, x):
    """``(fn(x), the launches of that call)``."""
    _zero_counts()
    out = fn(x)
    torch.cuda.synchronize()
    return out, _counts()[0]


def _export_other(torch, tmp, name, eager, export, x, launches):
    """One of phase 27's other programs: ``export()`` saved, loaded and
    called on ``x``, ``torch.equal`` to ``eager(x)``, with ``launches`` a
    call.  Returns the launches."""
    program, export_s, load_s, size = _export_artifact(torch, tmp, name,
                                                       export)
    with torch.inference_mode():
        got, counts = _counted(torch, program, x)
        want = eager(x)
    log(f"phase 27 {name} {tuple(x.shape)} {x.dtype}: export_s={export_s!r} "
        f"load_s={load_s!r} artifact_bytes={size}; launches {counts}; "
        f"torch.equal to eager {torch.equal(got, want)}")
    require(counts == launches, f"phase 27 {name}: launches {counts}, "
                                f"want {launches}")
    require(torch.equal(got, want), f"phase 27 {name}: the loaded program "
                                    "differs from the eager call")
    return counts


def _dispatch_cost(torch):
    """Host ms a call (median of 5 ``host_ms`` timings of 30 calls) of
    ``plan_gather`` at HexCNN-512's plan (b=32 bf16) and of one GN
    ``hex_conv_layer`` (64->64 at 128x127, b=32 bf16): through the
    wrapper, through the op, and the op's CUDA implementation called
    directly (what the dispatcher adds is op minus implementation)."""
    from hygrid_tpu_torch.kernels import conv_stack, resample
    from hygrid_tpu_torch.ops import geometry
    gen = torch.Generator(device="cuda").manual_seed(28)
    bf = torch.bfloat16
    plan = geometry.rect_to_hex_plan(512, 512, 256, 256, "bilinear")
    x = torch.rand((BATCH, 3, 512, 512), generator=gen,
                   device="cuda").to(bf)
    h = torch.rand((BATCH, 128, 127, 64), generator=gen,
                   device="cuda").to(bf)
    k = (torch.randn((64, 64, 7), generator=gen, device="cuda")
         * 0.05).to(bf)
    gamma, beta = torch.ones(64, device="cuda"), torch.zeros(64,
                                                             device="cuda")
    gather = resample._op_args(x, plan)
    layer = (h, None, k, None, gamma, beta, 2, 1, "gn", 8, True, False)
    fns = {
        "plan_gather wrapper": lambda: resample.plan_gather(x, plan),
        "plan_gather op": lambda: resample._OP(*gather),
        "plan_gather implementation": lambda: resample._plan_gather_cuda(
            *gather),
        "hex_conv_layer wrapper": lambda: conv_stack.hex_conv_layer(
            h, k, radius=2, norm=("gn", 8, gamma, beta), relu=True),
        "hex_conv_layer op": lambda: conv_stack._LAYER_OP(*layer),
        "hex_conv_layer implementation": lambda: conv_stack._layer_cuda(
            *layer)}
    with torch.inference_mode():
        return {name: sorted(host_ms(torch, fn, calls=30)
                             for _ in range(5))[2]
                for name, fn in fns.items()}


def run_export(torch, tmp):
    """Phase 27: ``utils/export.py`` on the card.  Returns the launches of
    the loaded programs."""
    from hygrid_tpu_torch.models import HexUNet, hexcnn_small, hexify_batch
    from hygrid_tpu_torch.models import video
    from hygrid_tpu_torch.utils import export as texp
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = hexcnn_small(norm="GN", dtype=bf, device="cuda",
                         generator=gen).eval()
    in_gen = torch.Generator(device="cuda").manual_seed(27)

    def rect(b, dtype=bf):
        return torch.rand((b, 3, 512, 512), generator=in_gen,
                          device="cuda").to(dtype)

    def eager(x):
        return model(hexify_batch(x))

    example = rect(BATCH)
    xs = {b: rect(b) for b in EXPORT_BATCHES}
    loaded, export_s, load_s, size = _export_artifact(
        torch, tmp, "hexcnn_small", functools.partial(
            texp.export_inference, model, None, example,
            symbolic_batch=True))
    info = texp.exported_info(str(Path(tmp) / "hexcnn_small.pt2"))
    # the same weights exported on the CPU (from a b=2 example) for both
    # platforms, moved to the card at load
    cpu_model = hexcnn_small(norm="GN", dtype=bf, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    from_cpu, cpu_export_s, cpu_load_s, cpu_size = _export_artifact(
        torch, tmp, "hexcnn_small_cpu", functools.partial(
            texp.export_inference, cpu_model, None,
            example[:EXPORT_BATCH].cpu(), symbolic_batch=True,
            platforms=("cpu", "cuda")), device="cuda")
    launches = {}
    with torch.inference_mode():
        for label, program, batches in (("cuda", loaded, EXPORT_BATCHES),
                                        ("cpu->cuda", from_cpu, (BATCH,))):
            for b in batches:
                got, counts = _counted(torch, program, xs[b])
                want = eager(xs[b])
                log(f"phase 27 HexCNN-small artifact exported on {label}, "
                    f"b={b}: launches {counts}, logits {tuple(got.shape)} "
                    f"torch.equal to eager {torch.equal(got, want)}")
                want_launches = (SERVE_LAUNCHES if label == "cuda"
                                 else CPU_EXPORT_LAUNCHES)
                require(counts == want_launches,
                        f"phase 27 {label} b={b}: launches {counts}, want "
                        f"{want_launches} a call")
                require(got.shape == (b, 10)
                        and bool(torch.isfinite(got).all()),
                        f"phase 27 {label} b={b}: logits {tuple(got.shape)}")
                require(torch.equal(got, want),
                        f"phase 27 {label} b={b}: the loaded program's "
                        "logits differ from the eager kernel path's")
                for k, v in counts.items():
                    launches[k] = launches.get(k, 0) + v
        x = xs[BATCH]
        first_ms = cuda_ms(torch, lambda: loaded(x), iters=3)
        n, ms = _timed_windows(torch, {
            "loaded": (lambda: None, loaded), "eager": (lambda: None, eager)},
            [xs[BATCH]], first_ms)
        host = {name: host_ms(torch, functools.partial(fn, x), calls=10)
                for name, fn in (("loaded", loaded), ("eager", eager))}
    log(f"phase 27 export HexCNN-small GN bf16 512^2, symbolic batch "
        f"(example b={BATCH}): export_s={export_s!r} load_s={load_s!r} "
        f"artifact_bytes={size}; from the CPU (example b={EXPORT_BATCH}): "
        f"export_s={cpu_export_s!r} load_s={cpu_load_s!r} (moved to the "
        f"card) artifact_bytes={cpu_size}; exported_info {info}")
    log(f"phase 27 HexCNN-small b={BATCH} request, loaded against eager in "
        f"turns, {PERMODULE_WINDOWS} windows of {n} requests (CUDA "
        f"events): ms a request {ms}; host_ms a request {host}")
    log(f"phase 27 the ops' dispatch, host ms a call: "
        f"{_dispatch_cost(torch)}")

    g = torch.Generator(device="cuda").manual_seed(17)
    unet = HexUNet(num_classes=4, dtype=bf, generator=g).eval()
    bn = build_permodule_hexcnn(generator=g).eval()
    pipe, _ = build_pipeline((512, 512), PIPE_CHANNELS, PIPE_LAYERS,
                             PIPE_RADIUS, bf, fused=True)
    proc = video.make_frame_processor(720, 1280)
    frame = torch.rand((3, 720, 1280), generator=in_gen, device="cuda")
    x_bf, x_f32 = rect(EXPORT_BATCH), rect(EXPORT_BATCH, torch.float32)

    def served(m):
        return lambda v: m(hexify_batch(v))

    def inference(m, v):
        return functools.partial(texp.export_inference, m, None, v,
                                 symbolic_batch=True)

    others = [
        ("HexUNet-small", served(unet), inference(unet, x_bf), x_bf,
         {"plan_gather": 1, "hex_conv_layer": 3, "hex_conv_layer_split": 2,
          "hex_max_pool": 2}),
        ("BN-512 kernel route", served(bn), inference(bn, x_f32), x_f32,
         {"plan_gather": 1, "hex_conv_single": 5}),
        ("P-512 fused", pipe, functools.partial(
            texp.export_fn, pipe, (x_f32,), symbolic_batch=True), x_f32,
         {"plan_gather": 2, "hex_conv_fused_stack": 1}),
        ("720p frame processor", proc, functools.partial(
            texp.export_fn, proc, (frame,)), frame, {"shift_resample": 1}),
    ]
    for name, eager_fn, export, x, want in others:
        for k, v in _export_other(torch, tmp, name, eager_fn, export, x,
                                  want).items():
            launches[k] = launches.get(k, 0) + v
    return launches


def kernel_times(torch):
    """``python3 chip_smoke.py --kernel-times``: the times of the kernels
    every tree of the port with the split layer's backward shares, through
    the public wrappers only, so that a copy of this script in an older
    checkout times that checkout's kernels.  In bf16: kernel B's six
    HexCNN-small GN layers at b=32, the fused P-512 stack and the same
    layers chained, the split layer at dec0 + dec1, dx of layers 1-5, dW
    of all six and the split layer's dW at dec0 + dec1; hex_conv_single
    at the per-module route's five layers, BN-512 in bf16 and in f32 and
    BN-CIFAR in f32; the fused P-512 stack in f32 too; #9's P-4K stack
    layer (``p4k_layer``, 1x1080x1920, 16->16, ReLU); and on the device
    alone (CUDA-graph replay) shift_resample and plan_gather at the 4K
    mosaic's plan (C=3) and the 720p rect->hex plan at b=8, f32 and bf16,
    and plan_gather at the plans of phases 3 and 11 (``KT_GATHER``), with
    the wrapper's host time a call at those plans (``host_ms``).  First,
    the pipelines' set-up (``pipeline_setup_s``: P-512 and P-4K built and
    called once, in seconds, their plans and tables included); after the
    pipelines' times, ``pipeline_diag`` (:func:`_pipeline_diag`).
    Kernel B's six GN layers split by torch.profiler into the conv pass and
    the GN passes after it (``kernel_b_conv_pass``, ``kernel_b_gn_half``),
    and the same six layers forward and backward through
    ``hex_conv_layer`` (``gn_fwd_bwd``, bf16 activations and weights,
    float32 GN parameters, as the training step runs them); the GN
    backward alone at both models' layers beside its library call
    (:func:`_gn_bwd_calls`: ``gn_bwd``, ``gn_bwd_unet`` and their
    ``_library`` sums).  In float32, through the same wrappers: kernel B's
    six GN layers (``kernel_b_f32``, and split by the profiler as in bf16:
    ``kernel_b_f32_conv_pass``, ``kernel_b_f32_gn_half``), dx of layers 1-5
    (``dgrad_f32``), dW of all six (``wgrad_f32``) and the split layer at
    dec0 + dec1 (``split_f32``) with its backward (``split_dgrad_f32``,
    ``split_wgrad_f32``).  End to end
    (``e2e_ms``, ms a call, and ``images_s``): HexCNN-small (GN, bf16, b=32
    512^2; and in its default dtype, float32: ``*_hexcnn_f32``) and
    HexUNet-small (b=8) serving a request and taking an AdamW
    training step, and the pipelines of phase 13 (``pipeline_mpix_s``: one
    input, 5 calls a timing); and one HexCNN-small step's kernels by name from
    torch.profiler (``train_by_op``, ms: the 16 largest kernels, the 24
    largest host ops by the device time of the kernels they launched, and
    the sum of torch's own kernels; ``serve_hexcnn_largest``, the 12
    largest kernels of a HexCNN-small request).  Each sum is taken
    ``KERNEL_TIME_REPEATS``
    times; one JSON line."""
    from hygrid_tpu_torch.kernels import conv_single, resample
    from hygrid_tpu_torch.kernels import conv_stack as cs
    from hygrid_tpu_torch.kernels import resample_shift as rs
    from hygrid_tpu_torch.nn.functional import hex_kernel_num
    from hygrid_tpu_torch.ops import geometry
    from hygrid_tpu_torch.viz import render
    gen = torch.Generator(device="cuda").manual_seed(21)
    bf = torch.bfloat16
    kn = hex_kernel_num(2)
    setup_s = _pipeline_setup(torch, gen)

    def rand(*shape, scale=None):
        t = torch.randn(shape, generator=gen, device="cuda")
        return (t if scale is None else t * scale).to(bf)

    def gn(cout):
        return ("gn", math.gcd(8, cout), torch.ones(cout, device="cuda"),
                torch.zeros(cout, device="cuda"))

    fwd_bwd = []
    calls = {"kernel_b": [], "dgrad": [], "wgrad": [], "split": [],
             "fused": [], "chained": [], "split_wgrad": [],
             "single_bf16": [], "single_f32_512": [],
             "single_f32_cifar": [], "fused_f32": [], "p4k_layer": [],
             "kernel_b_f32": [], "dgrad_f32": [], "wgrad_f32": [],
             "split_f32": [], "split_dgrad_f32": [], "split_wgrad_f32": []}
    # on the device alone: name -> fn
    device_calls = {}
    for li, (cin, cout, h, w) in enumerate(LAYERS):
        x, g = rand(BATCH, h, w, cin), rand(BATCH, h, w, cout)
        k = rand(cout, cin, kn, scale=1 / math.sqrt(cin * kn))
        calls["kernel_b"].append(functools.partial(
            cs.hex_conv_layer, x, k, radius=2, norm=gn(cout), relu=True))
        leaves = [t.detach().requires_grad_() for t in
                  (x, k, *gn(cout)[2:])]
        if not li:
            leaves[0].requires_grad_(False)

        def layer_fwd_bwd(leaves=leaves, g=g):
            x, k, gamma, beta = leaves
            out = cs.hex_conv_layer(x, k, radius=2, relu=True,
                                    norm=("gn", math.gcd(8, k.shape[0]),
                                          gamma, beta))
            return torch.autograd.grad(
                out, [t for t in leaves if t.requires_grad], g)

        fwd_bwd.append(layer_fwd_bwd)
        calls["wgrad"].append(functools.partial(
            cs.hex_conv_layer_wgrad, x, g, radius=2))
        if li:
            calls["dgrad"].append(functools.partial(
                cs.hex_conv_layer_dgrad, g, k, radius=2))
        # the same layers in float32 (a default-dtype HexCNN's passes)
        x, g, k = x.float(), g.float(), k.float()
        calls["kernel_b_f32"].append(functools.partial(
            cs.hex_conv_layer, x, k, radius=2, norm=gn(cout), relu=True))
        calls["wgrad_f32"].append(functools.partial(
            cs.hex_conv_layer_wgrad, x, g, radius=2))
        if li:
            calls["dgrad_f32"].append(functools.partial(
                cs.hex_conv_layer_dgrad, g, k, radius=2))
    for _, b, h, w, ca, cb, cout, _ in SPLIT_LAYERS[:2]:
        k = rand(cout, ca + cb, kn, scale=1 / math.sqrt((ca + cb) * kn))
        xa, xb = rand(b, h, w, ca), rand(b, h, w, cb)
        g = rand(b, h, w, cout)
        calls["split"].append(functools.partial(
            cs.hex_conv_layer_split, xa, xb, k, radius=2, norm=gn(cout),
            relu=True))
        calls["split_wgrad"].append(functools.partial(
            cs.hex_conv_layer_split_wgrad, xa, xb, g, radius=2))
        xa, xb, g, k = xa.float(), xb.float(), g.float(), k.float()
        calls["split_f32"].append(functools.partial(
            cs.hex_conv_layer_split, xa, xb, k, radius=2, norm=gn(cout),
            relu=True))
        calls["split_dgrad_f32"].append(functools.partial(
            cs.hex_conv_layer_split_dgrad, g, k, ca, radius=2))
        calls["split_wgrad_f32"].append(functools.partial(
            cs.hex_conv_layer_split_wgrad, xa, xb, g, radius=2))
    for config, layers in SINGLE_LAYERS.items():
        batch = dict((n, b) for n, b, _ in PERMODULE)[config]
        for cin, cout, h, w in layers:
            x = torch.rand((batch, cin, h, w), generator=gen, device="cuda")
            k = torch.randn((cout, cin, kn), generator=gen, device="cuda") \
                / math.sqrt(cin * kn)
            names = (["single_bf16", "single_f32_512"] if config == "BN-512"
                     else ["single_f32_cifar"])
            for name in names:
                dt = bf if name == "single_bf16" else torch.float32
                calls[name].append(functools.partial(
                    conv_single.hex_conv_single, x.to(dt), k.to(dt),
                    radius=2, padding=1))
    # #9's P-4K stack layer (phase 11's), norm-free
    calls["p4k_layer"].append(functools.partial(
        cs.hex_conv_layer, rand(1, 1080, 1920, 16),
        rand(16, 16, kn, scale=1 / math.sqrt(16 * kn)), radius=2,
        relu=True))
    _, ks = build_pipeline((512, 512), PIPE_CHANNELS, PIPE_LAYERS,
                           PIPE_RADIUS, bf)
    relus = [True] * (len(ks) - 1) + [False]
    xs = rand(16, 256, 256, PIPE_CHANNELS)
    calls["fused"].append(functools.partial(
        cs.hex_conv_fused_stack, xs, ks, radius=PIPE_RADIUS, relus=relus))

    def chained():
        v = xs
        for k, relu in zip(ks, relus):
            v = cs.hex_conv_layer(v, k, radius=PIPE_RADIUS, relu=relu)
        return v

    calls["chained"].append(chained)
    _, ks32 = build_pipeline((512, 512), PIPE_CHANNELS, PIPE_LAYERS,
                             PIPE_RADIUS, torch.float32)
    calls["fused_f32"].append(functools.partial(
        cs.hex_conv_fused_stack, xs.float(), ks32, radius=PIPE_RADIUS,
        relus=relus))
    for label, plan, lead in (
            ("mosaic", render._mosaic_sample_plan(540, 960, 2160, 3840, 0,
                                                  None), (3,)),
            ("720p_b8", geometry.rect_to_hex_plan(720, 1280, 360, 640,
                                                  "bilinear"), (8, 3))):
        x32 = torch.rand(lead + plan.src_shape, generator=gen, device="cuda")
        for dt, tag in ((torch.float32, "f32"), (bf, "bf16")):
            x = x32.to(dt)
            device_calls[f"shift_{label}_{tag}"] = functools.partial(
                rs.shift_resample, x, plan)
            device_calls[f"plan_gather_{label}_{tag}"] = functools.partial(
                resample.plan_gather, x, plan)
    # plan_gather at the main paths' plans (phases 3 and 11)
    host = {}
    for label, (kind, *args), lead, dt in KT_GATHER:
        plan = getattr(geometry, f"{kind}_plan")(*args)
        x = torch.rand(lead + plan.src_shape, generator=gen,
                       device="cuda").to(bf if dt == "bf16" else
                                         torch.float32)
        device_calls[f"plan_gather_{label}"] = functools.partial(
            resample.plan_gather, x, plan)
    with torch.inference_mode():
        times = {name: [sum(cuda_ms(torch, fn) for fn in fns)
                        for _ in range(KERNEL_TIME_REPEATS)]
                 for name, fns in calls.items()}
        for name, fn in device_calls.items():
            fn()                  # the plan's tables, outside the capture
            times[name] = [graph_ms(torch, fn)
                           for _ in range(KERNEL_TIME_REPEATS)]
            if name[len("plan_gather_"):] in {lb for lb, *_ in KT_GATHER}:
                host[name] = [host_ms(torch, fn)
                              for _ in range(KERNEL_TIME_REPEATS)]
        for tag in ("", "_f32"):
            halves = [[_gn_half(torch, fn) for fn in calls[f"kernel_b{tag}"]]
                      for _ in range(KERNEL_TIME_REPEATS)]
            times[f"kernel_b{tag}_conv_pass"] = [sum(c for c, _, _ in h)
                                                 for h in halves]
            times[f"kernel_b{tag}_gn_half"] = [sum(g for _, g, _ in h)
                                               for h in halves]
            times[f"kernel_b{tag}_gn_fold"] = [sum(f for _, _, f in h)
                                               for h in halves]
    times["gn_fwd_bwd"] = [sum(cuda_ms(torch, fn) for fn in fwd_bwd)
                           for _ in range(KERNEL_TIME_REPEATS)]
    for name, fns in _gn_bwd_calls(torch, gen).items():
        times[name] = [sum(cuda_ms(torch, fn, iters=5) for fn in fns)
                       for _ in range(KERNEL_TIME_REPEATS)]
    del calls, device_calls, fwd_bwd
    e2e, images, by_op = _e2e_times(torch, gen)
    mpix, pipe_diag = {}, {}
    for name, batch, shape, fused in PIPELINES:
        pipe, _ = build_pipeline(shape, PIPE_CHANNELS, PIPE_LAYERS,
                                 PIPE_RADIUS, bf, fused=fused)
        x = torch.rand((batch, 3) + shape, generator=gen, device="cuda")
        with torch.inference_mode():
            e2e[name] = [cuda_ms(torch, functools.partial(pipe, x), iters=5)
                         for _ in range(KERNEL_TIME_REPEATS)]
            pipe_diag[name] = _pipeline_diag(torch, functools.partial(pipe,
                                                                      x))
        mpix[name] = [batch * shape[0] * shape[1] / 1e3 / ms
                      for ms in e2e[name]]
    print(json.dumps({"kernel_times_ms": times, "e2e_ms": e2e,
                      "images_s": images, "pipeline_mpix_s": mpix,
                      "host_ms": host, "pipeline_setup_s": setup_s,
                      "pipeline_diag": pipe_diag,
                      "train_by_op": by_op, "root": str(ROOT)}))
    return 0


def _gn_bwd_calls(torch, gen):
    """``kernel_times``' GN backward sums: ``gn_bwd`` (HexCNN-small's six
    GN layers, b=32) and ``gn_bwd_unet`` (HexUNet-small's five, b=8), each
    ``gn_relu_backward`` on float32 y, bf16 gout and its statistics, as
    phase 6b's bf16 case; and ``gn_bwd_library``, ``gn_bwd_unet_library``,
    the ReLU mask and ``aten.native_group_norm_backward`` on the same
    inputs, as phase 6b times them (NCHW float32 copies and the mask made
    before timing, the masking timed).  Only the public
    wrapper and the plain statistics: it runs on any tree since PR 11."""
    from hygrid_tpu_torch.kernels import conv_stack as cs
    aten = torch.ops.aten
    out = {"gn_bwd": [], "gn_bwd_unet": [], "gn_bwd_library": [],
           "gn_bwd_unet_library": []}
    layers = ([("gn_bwd", BATCH, cout, h, w) for _, cout, h, w in LAYERS]
              + [("gn_bwd_unet", UNET_BATCH, c, h, w)
                 for _, c, h, w in UNET_GN_LAYERS])
    for name, b, c, h, w in layers:
        groups = math.gcd(8, c)
        y = 1.5 * torch.randn((b, h, w, c), generator=gen, device="cuda") \
            + 0.2
        gamma = 1 + 0.1 * torch.rand((c,), generator=gen, device="cuda")
        beta = 0.1 * torch.randn((c,), generator=gen, device="cuda")
        gout = torch.randn((b, h, w, c), generator=gen,
                           device="cuda").to(torch.bfloat16)
        mean, rstd = cs.gn_stats_plain(y, groups)
        out[name].append(functools.partial(
            cs.gn_relu_backward, y, mean, rstd, gamma, beta, gout, groups,
            True))
        yn = y.permute(0, 3, 1, 2).contiguous()
        mask = torch.nn.functional.group_norm(yn, groups, gamma, beta) > 0
        gn = gout.float().permute(0, 3, 1, 2).contiguous()

        def library(gn=gn, mask=mask, yn=yn, mean=mean, rstd=rstd,
                    gamma=gamma, b=b, c=c, hw=h * w, groups=groups):
            return aten.native_group_norm_backward(
                gn * mask, yn, mean, rstd, gamma, b, c, hw, groups,
                [True, True, True])

        out[f"{name}_library"].append(library)
    return out


def _pipeline_diag(torch, fn, calls=5):
    """Where a pipeline call's time goes: ``kernels_ms``, the device time
    of its kernels a call (torch.profiler over ``calls`` calls), beside
    the event-timed ms, and ``largest``, its four largest kernels (ms a
    call); ``device_allocs`` and ``device_frees``, the caching
    allocator's cudaMalloc and cudaFree calls during ``calls``
    event-timed calls after warm-up (each may stall the host)."""
    cuda_ms(torch, fn, iters=calls)
    before = torch.cuda.memory_stats()
    cuda_ms(torch, fn, iters=calls, warmup=0)
    after = torch.cuda.memory_stats()
    kernels = _profiled_kernels(torch, lambda: [fn() for _ in range(calls)])
    return dict(kernels_ms=sum(us for _, us in kernels) / 1e3 / calls,
                largest=[[k[:70], us / 1e3 / calls] for k, us in kernels[:4]],
                **{k: after.get(f"num_{k[:-1]}", 0) - before.get(
                    f"num_{k[:-1]}", 0)
                   for k in ("device_allocs", "device_frees")})


def _pipeline_setup(torch, gen):
    """``kernel_times``' set-up part: ``{name: seconds}`` from building
    P-512 and P-4K (bf16) to the end of their first call, on plans this
    process has not built before (so their numpy plans, their kernel
    tables and the first launches are in it), after one small call has
    loaded the kernels' library."""
    from hygrid_tpu_torch.ops import geometry
    warm = torch.rand((1, 3, 16, 16), generator=gen, device="cuda")
    geometry.rect_to_hex_resample(warm, (8, 8), "bilinear")
    torch.cuda.synchronize()
    setup = {}
    for name, batch, shape, fused in PIPELINES:
        if fused:
            continue
        x = torch.rand((batch, 3) + shape, generator=gen, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipe, _ = build_pipeline(shape, PIPE_CHANNELS, PIPE_LAYERS,
                                 PIPE_RADIUS, torch.bfloat16)
        with torch.inference_mode():
            pipe(x)
        torch.cuda.synchronize()
        setup[name] = time.perf_counter() - t0
    return setup


# kernel_times' plan_gather plans, on the device alone: (label, plan
# function and arguments, lead dims, dtype)
KT_GATHER = [
    ("r2h512_b32_bf16", ("rect_to_hex", 512, 512, 256, 256, "bilinear"),
     (32, 3), "bf16"),
    ("r2h512_b16_bf16", ("rect_to_hex", 512, 512, 256, 256, "bilinear"),
     (16, 3), "bf16"),
    ("r2h512_b8_bf16", ("rect_to_hex", 512, 512, 256, 256, "bilinear"),
     (8, 3), "bf16"),
    ("h2r512_b16_bf16", ("hex_to_rect", 256, 256, 512, 512, "linear"),
     (16, 3), "bf16"),
    ("p4k_r2h_bf16", ("rect_to_hex", 2160, 3840, 1080, 1920, "bilinear"),
     (1, 3), "bf16"),
    ("p4k_h2r_bf16", ("hex_to_rect", 1080, 1920, 2160, 3840, "linear"),
     (1, 3), "bf16"),
    ("cifar_b256_f32", ("rect_to_hex", 32, 32, 16, 16, "bilinear"),
     (256, 3), "f32"),
    ("3phase_b16_bf16", ("hex_to_rect", 512, 512, 512, 512, "linear"),
     (16, 3), "bf16"),
    ("resample4k_bf16", ("hex_to_rect", 2160, 3840, 2160, 3840, "linear"),
     (3,), "bf16"),
]


def _e2e_times(torch, gen):
    """``kernel_times``' end-to-end part: ``({name: [ms a call]}, {name:
    [images/s]}, HexCNN-small's training step by kernel)``, through the
    public model API only, as users call it."""
    from hygrid_tpu_torch.models import (HexUNet, create_train_state,
                                         hexcnn_small, hexify_batch,
                                         train_step)
    bf = torch.bfloat16
    unet_kw = dict(num_classes=4, widths=(32, 64, 128), norm="GN")
    x_cnn = torch.rand((BATCH, 3, 512, 512), generator=gen, device="cuda")
    x_unet = torch.rand((UNET_BATCH, 3, 512, 512), generator=gen,
                        device="cuda")
    cnn_labels = torch.arange(BATCH, device="cuda") % 10
    unet_labels = torch.randint(0, 4, (UNET_BATCH, 256, 256), generator=gen,
                                device="cuda")
    cnn = hexcnn_small(norm="GN", dtype=bf, device="cuda", generator=gen)
    unet = HexUNet(dtype=bf, generator=gen, **unet_kw)
    cnn_state, unet_state = create_train_state(cnn), create_train_state(unet)
    # HexCNN-small in its default dtype (float32), as users build it
    cnn32_state = create_train_state(hexcnn_small(norm="GN", device="cuda",
                                                  generator=gen))
    serve_cnn32 = hexcnn_small(norm="GN", device="cuda",
                               generator=gen).eval()
    serve_cnn = hexcnn_small(norm="GN", dtype=bf, device="cuda",
                             generator=gen).eval()
    serve_unet = HexUNet(dtype=bf, generator=gen, **unet_kw).eval()
    runs = {
        "serve_hexcnn": (BATCH, True,
                         lambda: serve_cnn(hexify_batch(x_cnn.to(bf)))),
        "train_hexcnn": (BATCH, False, lambda: train_step(
            cnn_state, hexify_batch(x_cnn), cnn_labels)),
        "serve_hexunet": (UNET_BATCH, True,
                          lambda: serve_unet(hexify_batch(x_unet.to(bf)))),
        "train_hexunet": (UNET_BATCH, False, lambda: train_step(
            unet_state, hexify_batch(x_unet), unet_labels)),
        "serve_hexcnn_f32": (BATCH, True,
                             lambda: serve_cnn32(hexify_batch(x_cnn))),
        "train_hexcnn_f32": (BATCH, False, lambda: train_step(
            cnn32_state, hexify_batch(x_cnn), cnn_labels)),
    }
    e2e, images = {}, {}
    for name, (batch, serving, fn) in runs.items():
        with torch.inference_mode(serving):
            e2e[name] = [cuda_ms(torch, fn)
                         for _ in range(KERNEL_TIME_REPEATS)]
        images[name] = [batch / (ms / 1e3) for ms in e2e[name]]
    kernels = _profiled_kernels(torch, runs["train_hexcnn"][2])
    ops = _profiled_kernels(torch, runs["train_hexcnn"][2], ops=True)

    def ported(k):
        return (_conv_args(k) is not None or _is_gn_pass(k) or _is_gn_bwd(k)
                or "wgrad_" in k or "plan_gather" in k)

    with torch.inference_mode():
        serve = _profiled_kernels(torch, runs["serve_hexcnn"][2])
    by_op = {"torch_kernels_ms": sum(us for k, us in kernels
                                     if not ported(k)) / 1e3,
             "all_kernels_ms": sum(us for _, us in kernels) / 1e3,
             "largest": [[k[:100], us / 1e3] for k, us in kernels[:16]],
             "by_op": [[k, us / 1e3] for k, us in ops[:24]],
             "serve_hexcnn_largest": [[k[:100], us / 1e3]
                                      for k, us in serve[:12]]}
    return e2e, images, by_op


KERNEL_TIME_REPEATS = 3


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import hygrid_tpu_torch
    from hygrid_tpu_torch.kernels import _build
    pkg = Path(hygrid_tpu_torch.__file__).resolve().parent
    if pkg.parent != ROOT:
        raise RuntimeError(f"hygrid_tpu_torch imported from {pkg}, not from "
                           f"this checkout ({ROOT})")
    require("jax" not in sys.modules, "the port imported jax")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")
    # full float32 in the plain references: cuDNN convs default to TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    _build.load_library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {_build.build_info['path']}")
    kernel = None
    for line in _build.build_info.get("log", "").splitlines():
        entry = re.search(r"Compiling entry function '\w*?\d+([a-z_]+_kernel)"
                          r"(I\w*?E)?E", line)
        if entry:  # mangled: <length><name>I<template args>E
            kernel = entry.group(1) + (entry.group(2) or "").replace(
                "13__nv_bfloat16", "bf16")
        elif "spill" in line or "Used" in line:
            log(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    if sys.argv[1:] == ["--kernel-times"]:
        return kernel_times(torch)
    mma_instructions(_build.build_info["path"])
    log("tensor-core instructions (HGMMA/HMMA, cuobjdump -sass) in "
        "hex_conv_kernel<N, bf16, out, split, stats>: " + ", ".join(
            f"<{n}, {'float' if f else 'bf16'}, {str(sp).lower()}, "
            f"{str(f).lower()}> {c}"
            for (n, f, sp), c in sorted(MMA_COUNTS.items()))
        + "; hex_conv_single_mma_kernel<N>: " + ", ".join(
            f"<{n}> {c}" for n, c in sorted(SINGLE_MMA_COUNTS.items()))
        + "; wgrad_mma_kernel<N>: " + ", ".join(
            f"<{n}> {c}" for n, c in sorted(WGRAD_MMA_COUNTS.items()))
        + "; fused_stack_mma_kernel<N>: " + ", ".join(
            f"<{n}> {c}" for n, c in sorted(FUSED_MMA_COUNTS.items())))

    gen = torch.Generator(device="cuda").manual_seed(1234)
    with torch.inference_mode():
        a = check_kernel_a(torch, gen)
        b = check_kernel_b(torch, gen)
    paths = {"serve": run_slice(torch)}
    bwd = check_backward(torch, gen)
    gn_bwd = check_gn_backward(torch, gen)
    pools = check_pool(torch, gen)
    paths["train"] = run_training(torch)
    t0 = time.perf_counter()
    paths["train_f32"] = run_training_f32(torch)
    log(f"phase 7f: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        c = check_kernel_c(torch, gen)
    paths["video"] = run_video(torch)
    paths["mosaic"] = run_mosaic(torch)
    log(f"phases 8-10: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        check_tiers(torch, gen)
        fused = check_fused(torch, gen)
    paths.update(run_pipelines(torch))
    log(f"phases 11-13: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        single = check_single(torch, gen)
    paths.update(run_permodule(torch))
    log(f"phases 14-15: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        split = check_split(torch, gen)
    paths["hexunet"] = run_hexunet(torch)
    log(f"phases 16-17: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    split_bwd = check_split_backward(torch, gen)
    paths["hexunet_train"] = run_hexunet_training(torch)
    log(f"phases 18-19: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["affine_train"] = check_affine_backward(torch, gen)
    log(f"phase 20: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["hexvit"] = run_hexvit(torch)
    log(f"phase 21: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths.update(run_new_training(torch))
    log(f"phase 22: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    paths["augment_train"] = run_augment_training(torch)
    with torch.inference_mode():
        paths["hexrot"], rot = check_hexrot(torch, gen)
    log(f"phases 23-23b: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with torch.inference_mode():
        paths["ingest"], ingest = run_ingest(torch)
    log(f"phase 24: {time.perf_counter() - t0:.1f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        paths["parallel"], par_ref = run_parallel(torch, tmp)
        log(f"phase 25: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        run_parallel_ranks(torch, tmp, par_ref)
        log(f"phase 26: {time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        t0 = time.perf_counter()
        paths["export"] = run_export(torch, tmp)
        log(f"phase 27: {time.perf_counter() - t0:.1f} s")

    def count(name):
        by_path = {p: n[name] for p, n in paths.items() if n.get(name)}
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    kernels = [
        dict(name="plan_gather", route="cuda",
             source="hygrid_tpu_torch/csrc/plan_gather.cu",
             replaces="hygrid_tpu/kernels/resample_pallas.py:358",
             also_replaces=["hygrid_tpu/kernels/resample_pallas.py:374",
                            "hygrid_tpu/kernels/resample_pallas.py:289",
                            "hygrid_tpu/kernels/resample_pallas.py:315"],
             **count("plan_gather"), **a, **rot, **ingest),
        dict(name="hex_conv_layer", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_layer.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:807",
             also_replaces=["hygrid_tpu/kernels/conv_pallas.py:374"],
             **count("hex_conv_layer"), **b),
        dict(name="hex_conv_layer_dgrad", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_layer.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:1402",
             **count("hex_conv_layer_dgrad"), **bwd["dgrad"]),
        dict(name="hex_conv_wgrad", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_wgrad.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:1402",
             **count("hex_conv_wgrad"), **bwd["wgrad"]),
        dict(name="shift_resample", route="cuda",
             source="hygrid_tpu_torch/csrc/shift_resample.cu",
             replaces="hygrid_tpu/kernels/resample_shift.py:215",
             also_replaces="hygrid_tpu/kernels/resample_shift.py:234",
             **count("shift_resample"), **c),
        dict(name="hex_conv_fused_stack", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_fused_stack.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:965",
             **count("hex_conv_fused_stack"), **fused),
        dict(name="hex_conv_single", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_single.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:106",
             also_replaces="hygrid_tpu/kernels/conv_pallas.py:127",
             **count("hex_conv_single"), **single),
        dict(name="hex_conv_layer_split", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_layer.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:807",
             replaces_mode="split=True, conv_pallas.py:838-871",
             **count("hex_conv_layer_split"), **split),
        dict(name="hex_conv_layer_split_dgrad", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_layer.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:1402",
             replaces_mode="dx on the split layer, _stack_bwd_pallas "
                           "conv_pallas.py:2050-2064",
             **count("hex_conv_layer_split_dgrad"), **split_bwd["dgrad"]),
        dict(name="hex_conv_wgrad_split", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_conv_wgrad.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:1402",
             replaces_mode="dW on the split layer, _stack_bwd_pallas "
                           "conv_pallas.py:2050-2064",
             **count("hex_conv_wgrad_split"), **split_bwd["wgrad"]),
        dict(name="gn_relu_backward", route="cuda",
             source="hygrid_tpu_torch/csrc/gn_backward.cu",
             replaces="hygrid_tpu/kernels/conv_pallas.py:2023-2029",
             replaces_mode="jax.vjp of _make_post (conv_pallas.py:1752-1800) "
                           "under XLA, not a Pallas kernel",
             **count("gn_relu_backward"), **gn_bwd),
        dict(name="hex_max_pool", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_pool.cu",
             replaces="none: hygrid_tpu's pools are XLA "
                      "(hygrid_tpu/nn/functional.py::_hex_window_reduce)",
             **count("hex_max_pool"), **pools["forward"]),
        dict(name="hex_max_pool_backward", route="cuda",
             source="hygrid_tpu_torch/csrc/hex_pool.cu",
             replaces="none: autograd of the XLA pool",
             **count("hex_max_pool_backward"), **pools["backward"]),
    ]
    for k in kernels:
        require(k["launches"] > 0, f"{k['name']}: no launch on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
