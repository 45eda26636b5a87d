#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``nerf_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):
1. device: the card's name and power limit (nvidia-smi);
2. build: compiles csrc/fused_mlp_fwd.cu (K1, K2), csrc/fused_mlp_bwd.cu
   (K4, K3), csrc/fused_render.cu (K5, K6's compositing backward),
   csrc/probe_overlap.cu (K7) and csrc/fused_mlp_wide.cu (K1w-K6w) with
   nvcc (sm_90a), one process each, at once;
   prints the backward's weight-grad kernel (``wgrad_bf16``, in both
   libraries that build it) with its registers and spills and its wgmma
   (HGMMA), TMA-load (UTMALDG) and multicast TMA-load counts (cuobjdump),
   and fails on a spill, on HMMA, or without wgmma and multicast loads;
   prints each instantiation of K1's and K2's bf16 forward
   (``fwd_bf16_sm90``), of K5's (``render_bf16_sm90``), of the backward's
   recompute (``bwd_recompute_sm90``, with and without raw), all on one
   tile, of the backward's cotangent chain (``bwd_chain_sm90``, that tile's
   ring and warpgroups), each also as the stacked launch of multi-scene
   training (K1s, K2s, K5s; K4s's and K3s's recompute and chain), and of
   K7's nine probe bodies (``probe_sm90``, that
   tile or its pieces) with its registers, stack and spill bytes
   (cuobjdump -res-usage, ptxas) and its HGMMA, UTMALDG, HMMA and STG.E.128
   counts; fails on a spill, and unless these issue wgmma and TMA loads and
   no warp-level MMA (HMMA); K6's compositing pass (``composite_bwd``, a
   warp per ray, staged and not) with its registers and spills; fails if
   any kernel of the four libraries holds an HMMA;
3. kernel: K1 against its plain PyTorch version at the full 8x256 width,
   in f32 and bf16;
4. render: renders the first 3 poses of the 40-pose orbit at the lego
   half-res recipe (400x400, 64+128 samples, bf16, white background)
   through ``render_path``; checks shapes, finiteness, 30 K1 launches and
   no other, and 4,096 rays strided over frame 0 against the plain
   (unfused) path (where the kernel path composites K1's planes by the bf16
   matmul scan, the plain path does too: ``plain_compositor``; phases 8,
   22 and 27 likewise);
5. times: K1 at the serving path's shapes (a 32,768-ray chunk, both
   levels), checked against its plain version there and timed beside its
   bound, its plain version and a bf16 ``torch.matmul`` chain, with the
   bytes of weights its tiles stream from L2 and their rate;
6. grad: K4 against its plain version at 8x256, f32 and bf16, R=1024 and
   ragged R=1000, S=64 and 192, and (bf16) at the training shapes R=4096;
   two launches must be bit-identical; then recompute, the gate of ROADMAP
   C.4: the bf16 backward's recompute launch alone, with raw, at phase 14's
   shapes and K4's training shapes in ray mode and at K3's in points mode:
   its raw bit for bit K1's (K2's), its mask words those of its own
   workspace rows' signs, each layer's rows within a bf16 ulp of that
   layer's plain version on the kernel's own inputs, small shares of rows
   and of mask bits differing from the whole plain chain, all written to
   the last padded point, and the launch without raw writing the same rows
   and words; then chain, the chain's gate: the recompute and chain launches
   alone at W=256 and 128, in ray and points mode, a direction per ray and
   per point, with and without input grads, at 1, 127, 129 and 33,984
   points and K4's coarse training shape: each of the chain's blocks within
   a bf16 ulp of its one product on the kernel's own inputs, a small share
   of them differing, zeros past the points (NaN before), its f32 d_hv,
   bias partials, dx and dv close to theirs, and two launches
   bit-identical;
7. train: ``train()`` at the lego recipe with N_rand=4096 on 8 views of
   400x400 rendered by a seeded teacher net through ``render_path``: 3
   warm-up and 30 timed steps with exactly 2 K1 and 2 K4 launches each and
   no K2/K3, finite and falling loss, ms/step, rays/s and MFU; then 3 steps
   under ``torch.profiler`` for the device time by kernel and the idle share;
   then the step's compositing of K1's planes (ROADMAP A.7: both levels,
   forward and backward) in both forms on the same inputs, nerf_tpu's
   matmul scan (the bf16 path's) and the exact cumprod: device ms per step
   from a profiled window of each, and the two within nerf_tpu's bound;
8. grads: one fused step's weight grads against the plain (unfused) path
   on the same batch and draws;
9. bwd times: K4 at the training shapes beside its bound, its plain
   version and the backward's big products as bf16 ``torch.matmul``; 10
   profiled steps of K4 (coarse + fine) split by its launches, phase 1's
   recompute (``bwd_recompute_sm90``) and chain (``bwd_chain_sm90``) each
   beside its own bound and its own products as bf16 ``torch.matmul`` (10
   and 9), and the weight-grad phase (``wgrad_bf16``) beside its own bound
   and its 10 weight-grad products as bf16 ``torch.matmul`` (each product's
   two operands distinct tensors), with each launch's cluster size and
   grid (fails without a cluster);
9b. wgrad: the weight-grad launch alone (``tools/wgrad_check.py``) against
   its plain version within 4e-5 relative L2 (``wgrad_check.REL_L2``: twice
   the kernel's measured distance from f64 sums) and twice, bit for bit, at
   the main path's 1,048,576 points (W = 256), W = 512 and 1024 dense and
   a direction per ray, and 8 stacked scenes at W = 256 and 512; with
   NERF_WGRAD_PARENT set to another checkout's root, whether that
   checkout's kernel gives the same bits.
The points-in path (K2 forward, K3 backward), at the 63+128 recipe: 63
coarse samples and 191 fine are not multiples of 8, so both levels query
points (``query_raw`` -> ``fused_query``) with a view direction per point:
10. kernel2 / grad3: K2 and K3 against their plain versions at 8x256, f32
   and bf16, a direction per point (spr=1) and per ray (spr=S), K3 with
   and without input grads (dx, dv) and twice, bit-identical;
11. render: phase 4 at 63+128: 10 K2 launches a frame and no other;
12. train / grads: phases 7 and 8 at 63+128 on the same views: 2 K2 and 2
   K3 launches a step and no K1/K4;
13. k2_times / k3_times: K2 at the chunk's and the step's shapes, K3 at the
   step's, beside their bounds, plain versions and library chains.
The fused-render path (``--fused_render``: K5 from rays to maps with the
compositing in the kernel, K6 its backward), at 64+128 on both levels:
14. kernel5 / grad6: K5 and K6 against their plain versions at 8x256, f32
   and bf16, R=1024 and ragged R=1000, S=64, 192 and 200 (bf16: ray
   groups of 2, 2 and 16 rays; f32: a one-ray group at 200), white
   background on and off, sigma noise on; K5 twice and once serving (no
   raw planes), bit-identical; K6 with one-signed cotangents on all four
   maps, twice, bit-identical; and K6's two halves apart: the compositing
   backward's cotangent of raw against its plain version (f32, within
   ``COMPOSITE_F32_TOL``) and twice, bit-identical, and K4's phases on the
   plain cotangent against the plain weight grads of it; K5's raw equal to
   K1's on the same inputs in both dtypes (one tile body); K6's counter
   moves by 2 and its compositing pass's by 4 (K6's and the halves');
15. render: phase 4 with ``fused_render``: 10 K5 launches a frame and no
   other kernel;
16. train / grads: phases 7 and 8 with ``fused_render`` on the same views:
   2 K5 and 2 K6 launches a step (each K6 one compositing pass) and none of
   K1-K4; the profile splits out the compositing pass;
17. k5_times / k6_times / composite_times: K5 per chunk (serving) beside K1
   on the same inputs, and K6 per step, beside their bounds, plain versions
   and library chains; K6's compositing pass alone per step beside its byte
   bound and plain version.
The probe path (K7, ``python -m nerf_tpu_torch.tools.probe_overlap``) and
the user's entry path (``cli.train`` / ``cli.render`` on a blender scene):
18. probe: each of K7's nine bodies (the script's eight and ``products``)
   against its plain version at 8x256 on 192 tiles of 128 points (one
   launch each), ``full``'s channels 0..3 equal to K2's raw on the same
   blob (it is K1's tile), then the tool's ``main`` at 786,432 points: 1 +
   30 launches a body, its time the median of 5 windows of 6, beside its
   bound and plain version, ``matmul_only`` beside its ``torch.matmul``
   chain, and lockstep over ping-pong (``bias_relu / interleaved``,
   ``embed_trunk / embed_trunk_il``);
19. cli train: phase 7's teacher views written as an 800x800 RGBA blender
   scene (6 train, 1 val, 1 test; PNGs through ``write_png``), then
   ``cli.train.main`` with configs/lego.txt (half_res, 64+128, N_rand
   4096) for 24 steps with i_print, i_img, i_weights, i_testset, i_video
   and trace all firing: the [EVAL] lines, a .tar at each i_weights event
   (named 4 steps ahead after the trace's extra steps, as nerf_tpu does),
   the test-set PNG, the 40 spiral frames, a trace.json naming K1's and
   K4's kernels, 2 K1 + 2 K4 launches a step and 10 K1 a frame, nothing
   else, and a finite, falling loss;
20. resume / render: the newest .tar holds the trained state; a second
   ``cli.train.main`` resumes from it (step and learning rate) for 8 more
   steps, and ``cli.render.main --render_test`` renders the test view from
   the .tar it saved, with a finite PSNR and the video.
The scene formats, each written by the port's scene writer from the
procedural field (``data/synth.py``) and trained through ``cli.train``:
21. synth: ``render_gt_rays`` on the card against the CPU on 256 rays of
   64 samples, both fields (within ``SYNTH_TOL``), and in chunks of 100
   bit-equal; then the synthff scene (``tools/make_llff_benchmark_scene.py``)
   written at the tool's 756x1008 with 12 of its 24 views (time: ~5.4 s a
   view), seconds a view;
22. cli llff: ``_minify`` writes images_2/ at 378x504 through the native
   Lanczos (equal to it, timed); ``cli.train.main`` with configs/synthff.txt
   for 32 steps with every cadence firing: NDC rays (the step's transform,
   origins on z = -1), the batching sampler, the sigma noise in every
   step's draws, 2 K1 + 2 K4 a step and 12 K1 a 378x504 frame (the
   120-frame spiral, the 2 test views, 2 holdout views) and nothing else,
   a falling loss, finite holdout PSNRs; 6 spiral frames timed (12 K1
   each), the first's 4,096 strided rays and an NDC batch's grads against
   the plain path (phases 4 and 8's bounds); ROADMAP C.6: on 4 NDC batches
   the kernel path's and the bf16 plain path's grads, each against the
   plain path in f32, and K4's phases and its bf16 plain version on the
   cotangent the kernel path hands K4, each against K4's f32 plain version
   (printed, no bound); then phase 7's timed and profiled windows on the
   recipe;
23. cli dv / cli linemod: the DeepVoxels and LINEMOD scenes at the tools'
   512x512 and 400x400 with 6 train views and one or two held out (the
   tools write 40/10/10 and 30/6/6: a smoke run needs a few),
   ``cli.train.main`` with configs/synth_dv.txt (batching) and
   configs/synth_linemod.txt (no_batching, precrop) for 24 steps each: 2 K1
   + 2 K4 a step, a falling loss, finite holdout PSNRs, the loaders'
   near/far (the hemisphere's 1 and 3; the json's floor and ceil, 2 and 6)
   and, with the json's principal point moved by ``LINEMOD_PP_SHIFT``, its
   K in every get_rays call of the sampler; then phase 7's windows on each.
Data parallelism (``parallel/mesh.py``, ``parallel/distributed.py``):
24. dp: phase 19's teacher scene, ``cli.train.main`` at the lego recipe
   (N_rand 4096) for 16 steps with i_print, i_img, i_weights and i_testset
   firing, once in this process and once over 2 gloo ranks that
   ``distributed.launch`` starts on cuda:0 (one card, so no rate is
   printed): each rank 2 K1 + 2 K4 launches a step at 2,048 rays (the
   counters and ray counts come back from the ranks), its rows of the
   holdout frames and its share of the test frame, a finite and falling
   loss, the two ranks' parameters and Adam moments ``torch.equal``, the
   loss at each i_print and the final parameters within the CPU test's
   bounds of the one-process run, one .tar equal to rank 0's state, the
   test-set PNG; the gloo ranks print the ``[FUSE]`` line of a group whose
   collectives a CUDA graph cannot hold and step one by one. Then NCCL, a
   card a rank (``tools/dp_time.py``'s ranks): with two or more cards the
   same run step by step, ``train()`` at the lego recipe for 2 chunks of
   ``fuse_steps`` 4 against ``fuse_steps`` 1 (``dp_time.check_rank``:
   history, parameters and Adam's state ``torch.equal`` on every rank, one
   CUDA graph replay a chunk, 2 K1 + 2 K4 a step either way), and the bf16
   step's ms/step, device ms, all-reduce device ms, idle share and peak
   memory from rank 0's profile, step by step and fused; with one card a
   one-rank NCCL group (``train()`` over its mesh, the all-reduces over
   itself) makes the same fused check, then 2 steps and one all-reduce.
Multi-scene training (``parallel/multi_scene.py``, ``cli/train_multi.py``):
25. multi: the port's ``tools/make_multi_scenes.py`` writes the 8 scenes of
   configs/multi (3 / 1 / 1 views of the tool's 15 / 3 / 3) and
   ``cli.train_multi.main`` trains configs/multi/scene_0..7.txt for 24
   steps, i_print and i_weights firing: 2 stacked K1 and 2 stacked K4
   launches a step for all 8 scenes (K1s, K4s; each K4s one recompute and
   one chain) and none of K1-K6, a finite loss a scene, 8 .tar files each
   loading into the one-scene model with its trained weights; the same 24
   steps with ``--N_samples 63`` (63 + 191: 2 stacked K2 and 2 stacked K3
   a step, K2s / K3s) and with ``--fused_render`` (64 + 192: 2 stacked K5
   and 2 stacked K6 a step, K5s / K6s, each K6s one compositing pass) and
   nothing else, no call of the stacked plain MLP, each scene's loss
   finite and falling, 8 .tar files with the trained weights; on the
   trained fine nets the stacked K1, K2 and K5 and their bf16 plain
   versions against the f32 plain version (printed); the stacked K1 and K4
   at 8 x 1024 rays, 64 and 192 samples, the stacked K2 and K3 at 63 and
   191 (a direction per point), the stacked K5 and K6 at 64 and 192:
   against their plain versions (phase 3's and phase 6's bounds), against
   8 single-scene K1-K6 launches (raw, maps and grads bit for bit; the
   stacked K4's grads printed), timed per step beside their bounds, plain
   versions and the same products as bf16 ``torch.bmm``; phase 7's windows on the
   stacked step of each branch (each scene's loss falling) beside scene 0 trained alone
   through ``train()`` on its config and phase 23's LINEMOD recipe (one
   scene, N_rand 1024, 64+64); then 8 steps in one process and over 2
   gloo ranks on this card (4 scenes each), each scene within phase 24's
   bounds of the one-process run, and with two or more cards the same on
   NCCL.
The wide kernel family (``csrc/fused_mlp_wide.cu``, ``ops/fused_mlp_wide.py``:
K1-K6 at the widths and octave counts the W <= 256 tile is not built for):
26. wide: K1w, K2w, K4w, K3w (with dx and dv), K5w and K6w against their
   plain versions in bf16 at W = 384, 512 and 1024 with 10 / 4 octaves and
   at W = 256 with 16 / 6, and in f32 at 384, at 1, 127, 129 and 33,984
   points (K5w / K6w at S = 64), each call counted once and nothing else;
   then the wide GEMM alone (``gemm_bf16_sm90``: persistent, 128 x 256
   tiles on wgmma with B MN-major, its epilogue's TMA stores) against its
   plain version at M = 4 .. 1024, one and two sources, each epilogue
   step, one scene and three, and one tile whose four swizzle atoms differ;
   then each timed at W = 512 beside its bound, its plain version and the
   same products as bf16 torch.matmul; then K1w's chunk and K4w's step
   split by kernel (tools/wide_split.py), with K4w's weight grads one
   cluster launch of 14 whole products a call, each launch's cluster size
   and grid printed (phase 2 also checks the wide GEMM for wgmma, TMA loads
   and TMA stores, and its ``wgrad_bf16`` for wgmma and multicast TMA
   loads, no HMMA and no spill);
27. wide path: the lego recipe at --netwidth 512 --netwidth_fine 512:
   train() for 24 steps (phase 7's timed window and profile, 2 K1w + 2 K4w
   a step), one 400x400 frame through render_path (2 K1w a chunk; against
   the plain path on 4,096 rays), 8 steps at --N_samples 63 (2 K2w + 2 K3w)
   and with --fused_render (2 K5w + 2 K6w); no call of the single-scene
   plain MLP (``NeRFMLP.plain_calls``) and a falling loss in each;
28. the same recipe at W = 256 with --multires 16 --multires_views 6: 8
   steps, 2 K1w + 2 K4w a step;
29. stacked wide: the stacked backward's workspace at 8 x 1024 rays of
   192 samples, W = 512, reckoned against the card's free memory; then
   ``cli.train_multi.main`` on configs/multi's 8 scenes at --netwidth 512
   --netwidth_fine 512 for 24 steps at 64 + 128 (2 K1ws + 2 K4ws a step for
   all 8 scenes), 63 + 128 (K2ws / K3ws) and --fused_render (K5ws / K6ws,
   each K6ws one compositing pass), nothing else, no call of the stacked
   plain MLP, each scene's loss falling, a .tar a scene with its trained
   weights; one step at W = 256 with 16 / 6 octaves (2 K1ws + 2 K4ws);
   then K1ws-K6ws at 8 x 1024 rays against their plain versions and
   against 8 single-scene wide launches (bit for bit), timed per step
   beside their bounds, plain versions and the same products as bf16
   ``torch.bmm``.
The backward's workspace bound and the fused loop:
30. c8 (ROADMAP C.8): tools/bwd_memory.py's four shapes, two steps each
   with their peak device memory (W = 512 at N_rand 16384; 16 stacked
   scenes of 1024 rays at W = 512; 8 at W = 1024; mip-NeRF 360's NeRF
   shape, W = 1024 at N_rand 16384, whose fine backward the budget cuts
   into slices and which must train); then the backward under a budget
   forced small (slices of 256 rays or views) against the one launch, K4,
   K3, K6, K4w and the stacked K4 in f32 (per-leaf relative L2 <= 1e-5)
   and bf16 (< 0.05), a launch a slice;
31. fuse: ``train()`` with fuse_steps k and with 1 on the same config,
   seed and views: the lego recipe at N_rand 4096 on the raygen path, at
   63 + 128, with --fused_render, at W = 512, with a precrop boundary that
   cuts a would-be chunk (two graphs), and a batching run over one view
   whose chunks cross an epoch wrap: histories, parameters and Adam's
   state ``torch.equal``, the same launch counts, one CUDA graph replay a
   chunk and none step by step; then wall ms/step of both loops through
   ``train()`` at N_rand 4096 and 1024 and a profiled window of each (the
   idle share), beside the card's name and power limit.
The DP×TP step (ROADMAP A.8b, ``parallel/mesh.py``,
``parallel/tensor_parallel.py``):
32. tp: ``make_sharded_train_step(shard_model_axis=True)`` at NeRF-W's
   8×512 (viewdirs, posenc 10/4, 64+128, the plain MLP: no kernel runs on
   this path, as none runs on nerf_tpu's) on batches of the teacher views:
   one process, then data 1 × model 2 on 2 gloo ranks on cuda:0 (with two
   or more cards the same on NCCL a card a rank, with four data 2 × model
   2): each rank at its (data, model) place, 3 f32 steps at 512 rays
   against the one process's (losses, the gathered weights and Adam's
   moments within the CPU test's bounds, equal on every rank, the
   model-parallel nets run and the whole ones not), then bf16 ms/step and
   peak GiB per rank beside the one process's, at the N_rand the one
   process's f32 peak leaves room for two ranks (printed).
The multi-scene sweep (``tools/multiscene_sweep.py``, nerf_tpu's
tools/multiscene_sweep.py):
33. sweep, on phase 25's 8 scenes: (a) after the chunk that captures, one
   chunk of the S = 8 graph (the sweep's ``Pack``: 50 stacked steps with
   their ``StackedImageSampler`` draws) is one ``CUDAGraph.replay()`` and
   ``torch.equal`` to the same 50 steps run eagerly from the same state
   and generators (weights, Adam's moments and counts, losses, the
   generators' states), with the same launches, 2 K1s + 2 K4s a step; a
   profiled chunk and 10 profiled eager steps (device ms/step, idle
   share); (b) the tool's ``main`` at --n_iters 100 (S = 1, 2, 4, 8, then
   sequential x8 through the S = 1 graph): its rows (ms/step, rays/s,
   holdout PSNRs), 2 K1s + 2 K4s a step and 4 K1 a holdout frame, one
   capture an S and one replay a chunk; (c) each scene's per-step losses
   in the S = 8 pack against its sequential run within 0.1 dB (2.3%), its
   weights' max abs difference, whether the pack is bit-equal, and the
   step's parts and plain ops that differ between a pack and a scene
   alone (``sweep_pack_split``).

The last two lines are a JSON object of kernel numbers (K1-K7, the
backward's recompute and chain launches, K6's compositing pass, K7's
``matmul_only`` beside its library chain, the stacked K1-K6, the wide
K1w-K6w and their stacked plans K1ws-K6ws) and the
``{"ok": true, "device": ...}`` result (K7's ``full`` beside its 10
products as bf16 ``torch.matmul``). Weights are random, from seeds.
The script imports nothing of JAX or of ``nerf_tpu``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

H = W = 400  # lego half-res
FOCAL = 555.555
NEAR, FAR = 2.0, 6.0
CHUNK = 32 * 1024
N_SAMPLES, N_IMPORTANCE = 64, 128
POINTS_SAMPLES = 63  # the points-in slice: 63 coarse, 191 fine, neither a multiple of 8
N_FRAMES = 3
WIDTH = 256
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
F32_TOL = 1e-4  # summation order + sincosf vs torch.sin ulps only
# bf16 kernel vs its plain version: nerf_tpu's bound (0.25,
# tests/test_fused_mlp.py:186-194) tightened to 5x the largest max abs seen
# on an H100 (4.1e-4, a 32,768-ray chunk at S=192; PERF.md). Both sides round
# the same operands to bf16 and differ only where an f32 sum in another order
# puts an activation on the other side of a bf16 rounding edge. The bound
# must stay below the input-dependent part of raw (``spread``, the mean
# |raw - its channel mean|, printed and checked), or a kernel that lost it
# would pass on the biases alone.
BF16_TOL = 2e-3
# The fused and the plain path sum in other orders (the kernel merges layer
# 0 with the skip, and rgb with alpha), so a few activations round to the
# other bf16 neighbour; one such 1-ulp flip moves rgb_map by up to ~1e-3.
RENDER_RGB_TOL = 1e-3
RENDER_CHECK_RAYS = 4096  # a strided sample over the whole frame
CHECK_RAYS, RAGGED_RAYS = 1024, 1000  # kernel checks: full tiles, and a ragged last tile
N_RAND = 4096  # the training batch (the reference's default)
TRAIN_VIEWS = 8
WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 30, 3
K4_F32_TOL = 1e-4  # per-leaf relative L2; sums over points in another order only
# K4 bf16 against its plain version, per-leaf relative L2: both round the
# same operands, and a cotangent whose f32 sum lands on the other side of a
# bf16 rounding edge rounds to the other neighbour. ~7x the largest value
# measured on an H100 (1.345e-4, W05e at R=1024, S=64; PERF.md), far inside
# nerf_tpu's 0.05 (tests/test_fused_mlp.py:175-183).
K4_BF16_TOL = 1e-3
# K6's compositing half alone, the cotangent of raw, per-tensor relative L2:
# f32 on both sides, exp/log ulps and the prefix sums' order apart (measured
# up to 7.4e-7 on an H100; PERF.md)
COMPOSITE_F32_TOL = 1e-5
# one fused training step's grads against the plain (unfused) path, per-leaf
# relative L2: the paths round to bf16 at other places (the plain path rounds
# the embedding per input, the kernels merge layer 0 with the skip), and the
# fine depths follow the coarse weights. nerf_tpu's bf16 grad bound.
STEP_GRAD_TOL = 5e-2
# the matmul scan against the exact cumprod (phase 7's scan line):
# nerf_tpu's own bound on the two forms (tests/test_compositing.py::
# test_planes_matmul_scan_close), on the weights and the grads of raw
SCAN_ATOL, SCAN_RTOL = 1e-3, 2e-3
SCAN_REPS = 10
# the recompute's workspace rows against their plain version, each layer on
# the kernel's own inputs (fused_mlp.recompute_layers_reference): both round
# the same operands and differ only where an f32 sum in another order lands
# on the other side of a bf16 rounding edge, which moves the value by one
# ulp (2^-7 of its magnitude or less), plus the sums' own difference where
# a relu output is near zero, RECOMPUTE_ULP_ATOL (measured on an H100 up to
# 8.5e-8 beyond the ulp; bound ~11x). At most RECOMPUTE_LAYER_SHARE of a
# block's elements may differ (measured up to 7.5e-5 here and 1.0e-4 in the
# card test; bound ~5x). Against the whole plain chain, ulps move on from
# layer to layer and no per-element bound is tight, so the share of a
# block's elements that differ is capped (measured up to 4.2e-3; bound ~5x)
# and the share of mask bits, the relu signs, that differ (measured up to
# 1.2e-6 here and 6.1e-6 in the card test; bound ~5x the latter). PERF.md.
RECOMPUTE_ULP = 2.0 ** -7
RECOMPUTE_ULP_ATOL = 2.0 ** -20
RECOMPUTE_LAYER_SHARE = 5e-4
RECOMPUTE_CHAIN_SHARE = 2e-2
RECOMPUTE_MASK_SHARE = 3e-5
# the chain's blocks against each block's one product on the kernel's own
# inputs (fused_mlp.chain_layers_reference): both round the same operands
# and differ only where an f32 sum in another order lands on the other side
# of a bf16 rounding edge, one ulp of the larger side (CHAIN_ULP), plus the
# sums' own difference where a cotangent is small beside its block's
# largest magnitude, CHAIN_ULP_ATOL of that (measured on an H100 up to
# 5.7e-8; bound ~17x). At most CHAIN_LAYER_SHARE of a case's elements, all
# blocks pooled, may differ (per block measured up to 1.2e-4 in the card
# test; a 1-point case has 2,436 elements at W=256, so one flip is 4.1e-4).
# The f32 results (d_hv for phase 2, the bias partials, dx, dv) lie within
# CHAIN_F32_REL (relative L2) of theirs (measured up to 2.2e-7; bound ~9x).
# PERF.md.
CHAIN_ULP, CHAIN_ULP_ATOL = 2.0 ** -7, 2.0 ** -20
CHAIN_LAYER_SHARE, CHAIN_F32_REL = 2e-3, 2e-6
# K3's dx and dv against its plain version, per-tensor relative L2. Unlike a
# weight grad, dx and dv are per point: no sum over points averages a
# point's error away. A relu input that the two forwards put on opposite
# sides of zero (f32: within ~1e-7; bf16: at a rounding edge) switches that
# point's whole cotangent chain, and dx multiplies the top octave's d_e by
# 2^9. Measured on an H100 (PERF.md): f32 up to 5.2e-4 (dx, R=1000, S=191),
# bf16 up to 3.3e-3 (dx); bounds ~4x and ~3x that.
K3_INPUT_F32_TOL = 2e-3
K3_INPUT_BF16_TOL = 1e-2
# K7's bodies against their plain versions, relative to the output's largest
# magnitude: two bf16 ulps there (an ulp of a value in [2^k, 2^(k+1)) is
# 2^(k-7)). Both sides round the same operands to bf16 and differ where an
# f32 sum in another order crosses a rounding edge, which moves one output
# by an ulp; measured on an H100 up to 6.1e-3 of the largest magnitude
# (bias_relu, 192 tiles; PERF.md). The bound must stay below the output's
# input-dependent spread (the mean |out - its column mean|), checked.
PROBE_TOL_REL = 2.0 ** -6
PROBE_CHECK_POINTS = 128 * 192  # 192 tiles of 128 points, 128 rays of 192
# the user's entry path: 24 steps with every cadence firing
CLI_STEPS, CLI_RESUMED_STEPS = 24, 8
CLI_CADENCES = {"i_print": 4, "i_img": 8, "i_weights": 12, "i_testset": 24, "i_video": 24}
TRACE_AT, TRACE_STEPS = 12, 4  # nerf_tpu's trace: 4 more steps at start + 12
LEGO_CAMERA_ANGLE_X = 0.6911112070083618  # the lego scene's: focal 1111.11 at 800 pixels
# the scene formats (phases 21-23). The analytic field on the card against
# the CPU on 256 rays of 64 samples, max abs: exp/sin/cos ulps and the
# primitives' sums (tests/test_torch_port_data.py's bound against nerf_tpu,
# which measured up to 1.7e-6 on the CPU); the same rays in chunks of 100
# must give the same bits.
SYNTH_RAYS, SYNTH_SAMPLES, SYNTH_CHUNK = 256, 64, 100
SYNTH_TOL = 1e-5
# half of the tool's 24 views: a view takes ~5.4 s on an H100 (PERF.md), and
# all 24 would add ~65 s to a run kept near five minutes; llffhold 8 still
# holds out views 0 and 8
SYNTHFF_VIEWS = 12
LLFF_MINIFIED = (378, 504)  # round(756 / 2), round(1008 / 2)
LLFF_SPIRAL = 120  # render_path_spiral's N_views
LLFF_TIMED_FRAMES = 6  # spiral frames timed after the run (its spiral warmed up)
LLFF_STEPS = 32  # a few dozen steps, every cadence firing at least once
LLFF_CADENCES = {"i_print": 4, "i_img": 16, "i_weights": 32, "i_testset": 32, "i_video": 32}
# DeepVoxels and LINEMOD at the tools' 512x512 and 400x400 with fewer views
# (the tools write 40/10/10 and 30/6/6): a smoke run needs a few; testskip 8
# keeps one view of each held-out split
DV_COUNTS = {"train": 6, "validation": 1, "test": 2}
LINEMOD_COUNTS = {"train": 6, "val": 1, "test": 1}
FORMAT_STEPS = 24
FORMAT_CADENCES = {"i_print": 2, "i_img": 8, "i_weights": 0, "i_testset": 0, "i_video": 0}
# the LINEMOD tool's K is default_intrinsics' (principal point at 200, 200):
# phase 23 moves the json's principal point by this many pixels, so that
# Scene.K differs from it and its use in get_rays shows
LINEMOD_PP_SHIFT = (3.5, -2.5)
# K1's and K4's symbols
# the SASS of a TMA load multicast to several CTAs of a cluster
# (cp.async.bulk.tensor.2d ... .multicast::cluster)
MULTICAST_TMA = "UTMALDG.2D.MULTICAST"
TRACE_KERNELS = ("fwd_bf16_sm90", "bwd_recompute_sm90", "bwd_chain_sm90", "wgrad_bf16")
# bytes of stack frame that sincosf's slow-path range reduction (embed_row in
# csrc/fused_mlp_common.cuh) gives every kernel that embeds points; a
# register spill would grow the frame beyond it
SINCOS_STACK = 32
# data parallelism (phase 24): 16 steps of the lego recipe over 2 ranks,
# i_print, i_img, i_weights and i_testset firing, held to one process's run
# of the same steps by tests/test_torch_port_parallel.py's bounds: the loss
# at each i_print within DP_LOSS_RTOL, each weight within 4 lr and each
# leaf's update within DP_UPDATE_TOL relative L2 (Adam moves a weight by
# about lr a step whatever the size of its grad, so f32 sums in another
# order move a weight by up to a few lr). Like that test, in float32 (the
# config's "strict parity" dtype, K1's and K4's f32 kernels): in bf16 a
# weight that moved by a sum's last bit rounds some activations to the
# other bf16 neighbour, and the teacher scene's loss, ~1e-4 (an mse of two
# near-white images), moved by 1.6e-3 of itself on an H100 (PERF.md)
DP_PARITY_DTYPE = "float32"
DP_RANKS, DP_STEPS = 2, 16
DP_CADENCES = {"i_print": 4, "i_img": 8, "i_weights": 16, "i_testset": 16, "i_video": 0}
DP_LOSS_RTOL, DP_UPDATE_TOL = 1e-5, 5e-2
# the steps of the one-rank NCCL group on a machine with one card
DP_ONE_RANK_STEPS = 2
# multi-scene training (phase 25): the port's tool writes configs/multi's 8
# scenes at its 200x200 with 3 / 1 / 1 of its 15 / 3 / 3 views (a smoke
# run samples a few train views; the held-out splits are only written),
# and cli.train_multi trains them for MULTI_STEPS steps; the stacked
# kernels are checked at N_rand 1024 (the configs'), 64 + 192 samples; the
# sharded run is MULTI_DP_STEPS steps over MULTI_RANKS ranks, held to phase
# 24's bounds
MULTI_SCENES, MULTI_RAYS, MULTI_STEPS = 8, 1024, 24
MULTI_COUNTS = {"train": 3, "val": 1, "test": 1}
MULTI_CADENCES = {"i_print": 8, "i_weights": 24}
MULTI_PATH_PRINT = 4  # i_print of the points-in and fused-render runs
# ROADMAP C.6: the NDC batches whose grads phase 22 holds to an f32 plain path
NDC_BATCHES = 4
MULTI_DP_STEPS, MULTI_RANKS = 8, 2
MULTI_DP_CADENCES = {"i_print": 4, "i_weights": 0}
MULTI_LRATE = 5e-4  # configs/multi's (the default)
# phase 32, the DP×TP step: NeRF-W's width; f32 parity steps; bf16 timing
# after a warm-up step of TP_WARMUP_RAYS rays (first calls, the ranks'
# connections), at the largest power of two of rays up to N_RAND whose two
# ranks fit TP_CARD_SHARE of the card with TP_ROOM over the one process's
# peak each. Two gloo ranks on one card move every gathered activation
# through the host (20-33 s a bf16 step at 2,048 rays, PERF.md §6): one
# timed step. At 256 f32 rays Adam's updates on small grads drift further
# apart (4.1e-2 of the 5e-2 bound at data 2 x model 2, PERF.md §6): 512
TP_WIDTH = 512
TP_PARITY_RAYS, TP_PARITY_STEPS = 512, 3
TP_WARMUP_RAYS, TP_TIMED = 64, 1
TP_ROOM, TP_CARD_SHARE = 1.5, 0.85
TP_SEED = 23


def counters():
    """The launch counters of K1-K7, of the bf16 backward's recompute and
    chain launches (K4's, K3's, K6's and the stacked K4's, K3's and K6's
    first two), of K6's compositing pass (the stacked K6's and K6w's too),
    of the stacked K1-K6 of multi-scene training (K1s-K6s) and of the wide
    family (K1w-K6w, and its stacked plans K1ws-K6ws: a call each, whatever
    the launches it makes), by name."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_wide
    from nerf_tpu_torch.tools import probe_overlap

    return {"K1": fused_mlp.fused_rays_planes, "K2": fused_mlp.fused_points,
            "K3": fused_mlp.fused_points_bwd, "K4": fused_mlp.fused_rays_planes_bwd,
            "K5": fused_render.fused_render_fwd, "K6": fused_render.fused_render_bwd,
            "K7": probe_overlap.probe, "recompute": fused_mlp.bwd_recompute,
            "chain": fused_mlp.bwd_chain, "composite": fused_render.composite_bwd,
            "K1s": fused_mlp.fused_rays_planes_stacked,
            "K4s": fused_mlp.fused_rays_planes_stacked_bwd,
            "K2s": fused_mlp.fused_points_stacked, "K3s": fused_mlp.fused_points_stacked_bwd,
            "K5s": fused_render.fused_render_stacked_fwd,
            "K6s": fused_render.fused_render_stacked_bwd,
            "K1w": fused_mlp_wide.fused_rays_planes_wide, "K2w": fused_mlp_wide.fused_points_wide,
            "K3w": fused_mlp_wide.fused_points_wide_bwd,
            "K4w": fused_mlp_wide.fused_rays_planes_wide_bwd,
            "K5w": fused_render.fused_render_wide_fwd, "K6w": fused_render.fused_render_wide_bwd,
            "K1ws": fused_mlp_wide.fused_rays_planes_wide_stacked,
            "K4ws": fused_mlp_wide.fused_rays_planes_wide_stacked_bwd,
            "K2ws": fused_mlp_wide.fused_points_wide_stacked,
            "K3ws": fused_mlp_wide.fused_points_wide_stacked_bwd,
            "K5ws": fused_render.fused_render_wide_stacked_fwd,
            "K6ws": fused_render.fused_render_wide_stacked_bwd}


def reset_counts() -> None:
    from nerf_tpu_torch.tools import probe_overlap

    for fn in counters().values():
        fn.launches = 0
    probe_overlap.probe.by_body = dict.fromkeys(probe_overlap.BODIES, 0)


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def check_counts(got, want, what: str) -> None:
    """Exactly ``want`` launches of the named kernels and none of the others."""
    want = {name: want.get(name, 0) for name in got}
    if got != want:
        raise RuntimeError(f"{what}: launches {got}, expected {want}")


def phase(tag: str, **fields) -> None:
    print(f"[{tag}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def cuobjdump(*args) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, *map(str, args)], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(lib, function: str, opcodes) -> dict:
    """{kernel name: {opcode: count}}: how often each of ``opcodes`` appears
    in the SASS of every kernel whose name holds ``function`` in the built
    library (cuobjdump)."""
    blocks = re.split(r"\n\s*Function : ", cuobjdump("-sass", lib))[1:]
    return {b.split("\n", 1)[0].strip(): {op: b.count(op) for op in opcodes}
            for b in blocks if function in b.split("\n", 1)[0]}


def res_usage(lib, function: str) -> dict:
    """{kernel name: {"REG": n, "STACK": bytes, "LOCAL": bytes}} of every
    kernel whose name holds ``function`` in the built library
    (cuobjdump -res-usage)."""
    found = {}
    for m in re.finditer(r"Function (\S+):\s*\n\s*(REG:[^\n]*)", cuobjdump("-res-usage", lib)):
        if function in m.group(1):
            found[m.group(1)] = {k: int(v) for k, v in re.findall(r"(REG|STACK|LOCAL):(\d+)",
                                                                   m.group(2))}
    return found


def ptxas_spills(log: str, function: str) -> dict:
    """{kernel name: (spill store bytes, spill load bytes)} from nvcc's
    -Xptxas=-v output, for the kernels whose name holds ``function``."""
    pattern = (r"Function properties for (\S+)\n\s*\d+ bytes stack frame, (\d+) bytes spill "
               r"stores, (\d+) bytes spill loads")
    return {m.group(1): (int(m.group(2)), int(m.group(3))) for m in re.finditer(pattern, log)
            if function in m.group(1)}


def in_w_label(name: str) -> str:
    """An instantiation's template arguments from its mangled name: RaysIn /
    PointsIn x W = 128 / 256, a bool template argument, as the recompute's
    raw (a kernel without an input-mode parameter reads rays), and the
    stacked launches' walk (SceneWalk, K5's SceneGroupWalk: a net per
    scene)."""
    inst = f"{'PointsIn' if 'PointsIn' in name else 'RaysIn'},W={256 if 'Li256E' in name else 128}"
    stacked = "SceneWalk" in name or "SceneGroupWalk" in name
    return inst + (",raw" if "Lb1E" in name else "") + (",stacked" if stacked else "")


def first_arg_label(name: str) -> str:
    """A kernel's one int or bool template argument (K7's body, K6's pass
    staged or not) from its mangled name."""
    return re.search(r"IL[ib](\d+)E", name).group(1)


def instantiations(source: str, function: str, opcodes, expected: int = 4,
                   label=in_w_label) -> dict:
    """Each of the ``expected`` instantiations of ``function`` in
    csrc/<source>.cu's built library, named by ``label``, one line each: its
    registers, stack and spill bytes (cuobjdump -res-usage, ptxas) and how
    often each of ``opcodes`` appears in its SASS. Fails on a spill or a
    frame beyond the trig's. Returns the opcode counts by instantiation."""
    from nerf_tpu_torch.ops import _build

    lib = _build._lib_path(source)
    usage = res_usage(lib, function)
    ops = sass_counts(lib, function, opcodes)
    spills = ptxas_spills(_build.build_log(source), function)
    if len(usage) != expected or set(usage) != set(ops) or set(spills) != set(usage):
        raise RuntimeError(f"expected {expected} {function} kernels in the SASS and the ptxas "
                           f"log, found {sorted(usage)} and {sorted(spills)}")
    found = {}
    for name, u in sorted(usage.items()):
        spill = spills[name]  # (store, load) bytes
        inst = label(name)
        phase("sass", kernel=f"{function}<{inst}>", regs=u["REG"], stack_bytes=u["STACK"],
              local_bytes=u["LOCAL"], spill_store_load_bytes=spill, **ops[name])
        if u["STACK"] > SINCOS_STACK or u["LOCAL"] or any(spill):
            raise RuntimeError(f"{function}<{inst}> spills: {u}, {spill}")
        found[inst] = ops[name]
    return found


def matmul_chain(kp, n_pts: int):
    """The forward's 10 large matmuls (W05e, W1..W7, Wf, Wvf) as bf16
    torch.matmul calls at the kernel's shapes: a library yardstick, timed
    here only and used nowhere in the port."""
    from nerf_tpu_torch.ops import fused_mlp

    dev = kp["W1"].device
    ke = fused_mlp.embed_pad(*fused_mlp._num_freqs(kp))[0]  # the tile's 64 at 10 octaves
    e = torch.randn(n_pts, ke, dtype=torch.bfloat16, device=dev)
    h = torch.randn(n_pts, kp["W1"].shape[0], dtype=torch.bfloat16, device=dev)
    w05 = torch.nn.functional.pad(kp["W05e"], (0, 0, 0, ke - kp["W05e"].shape[0]))
    ws = [kp[f"W{i}"] for i in range(1, 8)] + [kp["Wf"], kp["Wvf"]]

    def run():
        torch.matmul(e, w05)
        for w in ws:
            torch.matmul(h, w)

    return run


def check_kernel(out, ref, tol: float, **fields) -> float:
    """Hold kernel output to its plain version; print the max and mean
    difference beside the plain raw's mean magnitude and its
    input-dependent spread. Returns the max abs difference."""
    d = (out - ref).abs()
    err = float(d.max())
    spread = float((ref - ref.mean(dim=(1, 2), keepdim=True)).abs().mean(dim=(1, 2)).min())
    phase("kernel", **fields, max_abs=f"{err:.3e}", mean_abs=f"{float(d.mean()):.3e}",
          tol=tol, raw_mean_abs=f"{float(ref.abs().mean()):.3e}", spread=f"{spread:.3e}")
    if not bool(torch.isfinite(out).all()) or not err <= tol:
        raise RuntimeError(f"kernel disagrees with its plain version: {err} > {tol}")
    if not tol < spread:
        raise RuntimeError(f"bound {tol} is not below the raw's input-dependent spread {spread}")
    return err


def make_rays(rng: np.random.Generator, R: int, S: int, dev):
    """Rays from a radius-4 sphere towards the origin, depths in [near, far]."""
    ro = rng.standard_normal((R, 3)).astype(np.float32)
    ro = 4.0 * ro / np.linalg.norm(ro, axis=-1, keepdims=True)
    rd = (-ro / 4.0 + 0.3 * rng.standard_normal((R, 3))).astype(np.float32)
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    z = np.sort(rng.uniform(NEAR, FAR, (R, S)).astype(np.float32), -1)
    return [torch.from_numpy(a).to(dev) for a in (ro, rd, vd, z)]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from nerf_tpu_torch.data.scene import Scene, default_intrinsics
    from nerf_tpu_torch.geom.poses import spherical_render_poses
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
    from nerf_tpu_torch.ops import _build, fused_mlp
    from nerf_tpu_torch.render.network import NeRFModel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    phase("device", name=kind, count=torch.cuda.device_count(), nvidia_smi=repr(smi))

    # 2. build (one nvcc per source, all at once)
    t0 = time.perf_counter()
    sources = ["fused_mlp_fwd", "fused_mlp_bwd", "fused_render", "probe_overlap", "fused_mlp_wide"]
    _build.load_all(sources)
    phase("build", seconds=f"{time.perf_counter() - t0:.1f}", sources=len(sources))
    for name in sources:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line:
                print(f"  ptxas {name}:", line.strip(), flush=True)
    # the weight grads (wgrad_sm90.cuh, in both libraries that build it):
    # wgmma, TMA loads multicast to the cluster's CTAs, no mma.sync, no spill
    for source in ("fused_mlp_bwd", "fused_mlp_wide"):
        for inst, ops in instantiations(source, "wgrad_bf16",
                                        ("HGMMA", "UTMALDG", MULTICAST_TMA, "HMMA"), 1,
                                        lambda name: "bf16").items():
            if not (ops["HGMMA"] and ops[MULTICAST_TMA]) or ops["HMMA"]:
                raise RuntimeError(f"{source}'s wgrad_bf16 issues no wgmma or no multicast TMA "
                                   f"load, or an HMMA: {ops}")
    # the bf16 forward of K1 and K2, K5's and the backward's recompute, all
    # on one tile, and the backward's chain on that tile's ring and
    # warpgroups, each also as the stacked launch of multi-scene training
    # (K1's, K2's, K5's, and K4's and K3's recompute and chain): wgmma and
    # TMA loads, and no mma.sync (and their 16-byte global stores: the
    # workspace rows) (K7's nine bodies, each on that tile or its pieces, by
    # body number)
    for source, function, expected, label in (
            ("fused_mlp_fwd", "fwd_bf16_sm90", 8, in_w_label),
            ("fused_render", "render_bf16_sm90", 4, in_w_label),
            ("fused_mlp_bwd", "bwd_recompute_sm90", 12, in_w_label),
            ("fused_mlp_bwd", "bwd_chain_sm90", 8, in_w_label),
            ("probe_overlap", "probe_sm90", 9, first_arg_label)):
        found = instantiations(source, function, ("HGMMA", "UTMALDG", "HMMA", "STG.E.128"),
                               expected, label)
        for inst, ops in found.items():
            if not (ops["HGMMA"] and ops["UTMALDG"]) or ops["HMMA"]:
                raise RuntimeError(f"{function}<{inst}> is not the wgmma + TMA tile: {ops}")
        # the recompute at both widths (each checked above: no spill, HGMMA)
        widths = {w for inst in found for w in ("W=128", "W=256") if w in inst}
        if function == "bwd_recompute_sm90" and widths != {"W=128", "W=256"}:
            raise RuntimeError(f"bwd_recompute_sm90 lacks a width: {sorted(found)}")
    # K6's compositing pass, staged (<1>) and in device memory (<0>)
    instantiations("fused_render", "composite_bwd", ("HMMA",), 2, first_arg_label)
    # the wide family's GEMM (one bf16 instantiation: TMA loads, wgmma with
    # B transposed, its epilogue's TMA stores, no spill)
    for inst, ops in instantiations("fused_mlp_wide", "gemm_bf16_sm90",
                                    ("HGMMA", "UTMALDG", "UTMASTG", "HMMA", "STG.E.128"), 1,
                                    lambda name: "bf16").items():
        if not (ops["HGMMA"] and ops["UTMALDG"] and ops["UTMASTG"]) or ops["HMMA"]:
            raise RuntimeError(f"gemm_bf16_sm90<{inst}> issues no wgmma, TMA load or TMA "
                               f"store: {ops}")
    # no warp-level MMA left in any kernel of the port's libraries
    hmma = {name: ops["HMMA"] for source in sources
            for name, ops in sass_counts(_build._lib_path(source), "", ("HMMA",)).items()
            if ops["HMMA"]}
    phase("sass", kernels_with_hmma=len(hmma))
    if hmma:
        raise RuntimeError(f"kernels still issue HMMA: {hmma}")

    # 3. kernel against its plain version at full width
    cfg = MLPConfig(width=WIDTH)
    pe_pts, pe_views = PosEncConfig(10), PosEncConfig(4)
    coarse = NeRFMLP(cfg, seed=0, device=dev)
    fine = NeRFMLP(cfg, seed=1, device=dev)
    rng = np.random.default_rng(0)
    bf16_errs = []
    with torch.no_grad():
        for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
            kp = fused_mlp.pack_params(coarse, pe_pts, pe_views, dtype)
            for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
                rays = make_rays(rng, CHECK_RAYS, S, dev)
                before = fused_mlp.fused_rays_planes.launches
                out = fused_mlp.fused_rays_planes(kp, *rays)
                torch.cuda.synchronize()
                if fused_mlp.fused_rays_planes.launches != before + 1:
                    raise RuntimeError("the launch counter did not move")
                ref = fused_mlp.fused_rays_planes_reference(kp, *rays)
                err = check_kernel(out, ref, tol, dtype=str(dtype).split(".")[-1], R=CHECK_RAYS,
                                   S=S)
                if dtype == torch.bfloat16:
                    bf16_errs.append(err)

    # 4. render_path over 3 orbit poses
    model = NeRFModel(pe_pts, pe_views, cfg, cfg, compute_dtype="bfloat16", fused=True)
    scene = Scene(images=np.zeros((0, H, W, 3), np.float32), poses=np.zeros((0, 3, 4)),
                  render_poses=spherical_render_poses(40), hwf=(H, W, FOCAL),
                  K=default_intrinsics(H, W, FOCAL), i_train=np.zeros(0, int),
                  i_val=np.zeros(0, int), i_test=np.zeros(0, int), near=NEAR, far=FAR)
    nets = {"coarse": coarse, "fine": fine}
    render = render_phase(nets, model, scene, N_SAMPLES, "K1", dev)

    # 5. times at the main path's shapes (one 32,768-ray chunk, both levels)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    kp, blobs = fused_mlp.packed_params(coarse, pe_pts, pe_views, torch.bfloat16)
    wbytes = sum(v.numel() * v.element_size() for v in kp.values())
    totals = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    chunk_rays = [t[:CHUNK] for t in render["rays"]]
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
            u = torch.rand(CHUNK, S, device=dev, generator=gen)
            z = torch.sort(u * (FAR - NEAR) + NEAR, -1).values
            args = (*chunk_rays, z)
            n_pts = CHUNK * S
            out = fused_mlp.fused_rays_planes(kp, *args, blobs)
            ref = fused_mlp.fused_rays_planes_reference(kp, *args)
            err = check_kernel(out, ref, BF16_TOL, dtype="bfloat16", R=CHUNK, S=S)
            del out, ref
            bf16_errs.append(err)
            ms = cuda_ms(lambda: fused_mlp.fused_rays_planes(kp, *args, blobs), reps=10, warmup=2)
            plain_ms = cuda_ms(lambda: fused_mlp.fused_rays_planes_reference(kp, *args), reps=2)
            torch.cuda.empty_cache()
            chain = matmul_chain(kp, n_pts)
            library_ms = cuda_ms(chain, reps=5)
            del chain
            torch.cuda.empty_cache()
            io_bytes = CHUNK * 9 * 4 + n_pts * 4 + n_pts * 16 + wbytes
            ops_ms = 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
            bytes_ms = 1e3 * io_bytes / PEAK_BYTES
            bound_ms = max(ops_ms, bytes_ms)
            # the weights the tiles stream from L2, once a tile
            stream = -(-n_pts // fused_mlp.FWD_TILE) * fused_mlp.fwd_weight_bytes_per_tile(cfg)
            phase("times", S=S, points=n_pts, ms=f"{ms:.3f}", bound_ms=f"{bound_ms:.3f}",
                  plain_ms=f"{plain_ms:.3f}", library_ms=f"{library_ms:.3f}",
                  tflops=f"{n_pts * flops_pt / ms / 1e9:.1f}",
                  weight_stream_gb=f"{stream / 1e9:.3f}",
                  weight_stream_tb_per_s=f"{stream / ms / 1e9:.3f}")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                         ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
                totals[k] += v

    # 6.-9. the training slice
    k4_errs = check_k4(coarse, pe_pts, pe_views, rng, dev)
    recompute_errs = check_recompute(coarse, pe_pts, pe_views, dev)
    chain_errs = check_chain(coarse, pe_pts, pe_views, dev)
    train_info = train_phase(scene, dev, N_SAMPLES, "K1", "K4")
    scan_phase(dev)
    step_grads_phase(train_info, dev)
    k4, recompute, chain = k4_times(cfg, pe_pts, pe_views, dev)
    wgrad_phase()

    # 10.-13. the points-in slice at 63+128
    k2_errs, k3_errs = check_k23(coarse, pe_pts, pe_views, rng, dev)
    render63 = render_phase(nets, model, scene, POINTS_SAMPLES, "K2", dev)
    train63 = train_phase(scene, dev, POINTS_SAMPLES, "K2", "K3", views=train_info["views"])
    step_grads_phase(train63, dev)
    k2, k3 = k23_times(cfg, pe_pts, pe_views, render63["rays"], k2_errs, dev)

    # 14.-17. the fused-render path at 64+128
    k5_errs, k6_errs, composite_errs = check_k56(coarse, pe_pts, pe_views, rng, dev)
    model_fr = dataclasses.replace(model, fused_render=True)
    render_fr = render_phase(nets, model_fr, scene, N_SAMPLES, "K5", dev)
    train_fr = train_phase(scene, dev, N_SAMPLES, "K5", "K6", views=train_info["views"],
                           fused_render=True)
    step_grads_phase(train_fr, dev)
    k5, k6, composite = k56_times(cfg, pe_pts, pe_views, render["rays"], dev)

    # 18.-20. the probe path and the user's entry path
    k7 = probe_phase(dev)
    cli = cli_train_phase(train_info["views"])
    resume_render_phase(cli, dev)

    # 21.-23. the scene formats: the generator's scenes through cli.train
    formats_root = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    synthff = synth_phase(formats_root, dev)
    cli_llff_phase(formats_root, synthff, dev)
    one_scene = cli_formats_phase(formats_root, dev)
    shutil.rmtree(formats_root)

    # 24. data parallelism: cli.train over ranks
    dp_phase(train_info["views"], dev)

    # 25. multi-scene training: cli.train_multi, the stacked K1 and K4
    multi_root = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    multi = multi_phase(one_scene, multi_root, dev)

    # 26.-28. the wide family: its kernels against their plain versions and
    # timed, then the W = 512 and 16-octave lego paths
    wide = wide_kernel_phase(dev)
    wide_path = wide_path_phase(scene, train_info["views"], dev)

    # 29. the stacked wide path: cli.train_multi at W = 512, K1ws-K6ws
    stacked_wide = stacked_wide_phase(dev)

    # 30. ROADMAP C.8: the backward's workspace bounded, sliced over points
    c8_phase(dev)

    # 31. the fused loop: chunks of k steps, a CUDA graph replay each
    fuse_phase(train_info["views"], smi, dev)

    # 32. ROADMAP A.8b: the DP×TP step over a model group
    tp_phase(train_info["views"], smi, dev)

    # 33. the multi-scene sweep on phase 25's scenes: S scenes as one CUDA
    # graph a chunk against the same scenes one after another
    sweep_phase(multi_root, smi, dev)
    shutil.rmtree(multi_root)

    def row(name, source, replaces, launches, err, t):
        return {
            "name": name, "route": "cuda", "source": f"nerf_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": max(t["ops_ms"], t["bytes_ms"]),
            "bound_by": "operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
            "library_ms": t["library_ms"],
        }

    def probe_row(name, launches, r):
        return {"name": name, "route": "cuda", "source": "nerf_tpu_torch/csrc/probe_overlap.cu",
                "replaces": "tools/probe_overlap.py:79,181", "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}

    kernels = [
        # serving's 30 (3 frames) plus training's 60 (30 steps); bf16 max abs
        # over R=1024 and the chunk shapes; ms per 32,768-ray chunk (S=64 + S=192)
        row("fused_mlp_fwd", "fused_mlp_fwd.cu", "nerf_tpu/ops/fused_mlp.py:464",
            render["counts"]["K1"] + train_info["counts"]["K1"], max(bf16_errs), totals),
        # training's 60; bf16 weight grads; ms per training step (S=64 + S=192)
        row("fused_mlp_bwd", "fused_mlp_bwd.cu", "nerf_tpu/ops/fused_mlp.py:621",
            train_info["counts"]["K4"], max(k4_errs), k4),
        # the first launch of K4's, K3's and K6's bf16 backward: the forward
        # recompute (nerf_tpu's _trunk_forward and _head_forward inside
        # _make_bwd_kernel_rays) on K1's tile; training's 60 on K4's path,
        # where it is timed (the other two paths' are checked by
        # check_counts); max abs of its workspace rows against the plain
        # chain over phase 6's gate; ms per K4 training step (S=64 + S=192),
        # its own products as the library's
        row("bwd_recompute", "fused_mlp_bwd.cu", "nerf_tpu/ops/fused_mlp.py:621",
            train_info["counts"]["recompute"], max(recompute_errs), recompute),
        # the second launch of K4's, K3's and K6's bf16 backward: the
        # cotangent chain (nerf_tpu's _mlp_backward_math from gc down to d0
        # inside _make_bwd_kernel_rays) on the same tile; training's 60 on
        # K4's path; max abs of its rows against each block's one product on
        # its own inputs over phase 6's chain gate; ms per K4 training step,
        # its plain version's time, its own 9 products as the library's
        row("bwd_chain", "fused_mlp_bwd.cu", "nerf_tpu/ops/fused_mlp.py:621",
            train_info["counts"]["chain"], max(chain_errs), chain),
        # the 63+128 serving (30) and training (60) launches; bf16 max abs over
        # phase 10's and the chunk shapes; ms per 32,768-ray chunk (S=63 + S=191,
        # a direction per point)
        row("fused_mlp_fwd_points", "fused_mlp_fwd.cu", "nerf_tpu/ops/fused_mlp.py:454",
            render63["counts"]["K2"] + train63["counts"]["K2"], max(k2_errs), k2),
        # the 63+128 training's 60; ms per training step (S=63 + S=191)
        row("fused_mlp_bwd_points", "fused_mlp_bwd.cu", "nerf_tpu/ops/fused_mlp.py:584",
            train63["counts"]["K3"], max(k3_errs), k3),
        # the fused-render serving (30) and training (60) launches; bf16 max
        # abs of the maps over phase 14; ms per 32,768-ray chunk (S=64 + S=192)
        row("fused_render_fwd", "fused_render.cu", "nerf_tpu/experimental/fused_render.py:162",
            render_fr["counts"]["K5"] + train_fr["counts"]["K5"], max(k5_errs), k5),
        # the fused-render training's 60; bf16 weight grads (max abs); ms per
        # training step (S=64 + S=192)
        row("fused_render_bwd", "fused_render.cu", "nerf_tpu/experimental/fused_render.py:182",
            train_fr["counts"]["K6"], max(k6_errs), k6),
        # K6's compositing pass (its first launch), both levels: the
        # fused-render training's 60; max abs of the cotangent of raw over
        # phase 14 (f32 on both sides); ms per training step (S=64 + S=192);
        # no one PyTorch call computes it
        {"name": "composite_bwd", "route": "cuda",
         "source": "nerf_tpu_torch/csrc/fused_render.cu",
         "replaces": "nerf_tpu/experimental/fused_render.py:213",
         "launches": train_fr["counts"]["composite"], "max_abs_err": max(composite_errs),
         "ms": composite["ms"], "plain_ms": composite["plain_ms"],
         "bound_ms": composite["bytes_ms"], "bound_by": "bytes", "library_ms": None},
        # the probe tool's 9 x (1 + 30) launches; the full body (K1's whole
        # tile) at 786,432 points: its max abs error, ms, plain ms and bound;
        # its 10 large products as bf16 torch.matmul as the library's
        probe_row("probe_overlap", k7["launches"], k7["full"]),
        # its matmul_only body's 1 + 30, beside the 8 bf16 torch.matmul
        probe_row("probe_overlap_matmul_only", k7["by_body"]["matmul_only"],
                  k7["matmul_only"]),
        # the stacked K1 of multi-scene training (K1's tile on a scene's
        # weights a tile): cli.train_multi's 48 launches (24 steps, 8
        # scenes each); bf16 max abs over phase 25's both levels; ms per
        # step (S = 8, N_rand 1024, 64 + 192), the same products as bf16
        # torch.bmm over the scenes as the library's
        row("fused_mlp_fwd_stacked", "fused_mlp_fwd.cu",
            "nerf_tpu/ops/fused_mlp.py:464 (vmapped, nerf_tpu/parallel/multi_scene.py:64)",
            multi["counts"]["K1s"], multi["k1_err"], multi["k1"]),
        # the stacked K4 (its three phases, each one launch for 8 scenes):
        # cli.train_multi's 48; bf16 weight grads (max abs); ms per step
        row("fused_mlp_bwd_stacked", "fused_mlp_bwd.cu",
            "nerf_tpu/ops/fused_mlp.py:621 (vmapped, nerf_tpu/parallel/multi_scene.py:64)",
            multi["counts"]["K4s"], multi["k4_err"], multi["k4"]),
        # the stacked K2 (K2's tile on a scene's weights a tile, a direction
        # per point): cli.train_multi --N_samples 63's 48 launches; bf16 max
        # abs over phase 25's both levels; ms per step (S = 8, N_rand 1024,
        # 63 + 191), the same products as bf16 torch.bmm as the library's
        row("fused_mlp_fwd_points_stacked", "fused_mlp_fwd.cu",
            "nerf_tpu/ops/fused_mlp.py:454 (vmapped, nerf_tpu/parallel/multi_scene.py:64)",
            multi["path_counts"]["K2s"]["K2s"], multi["k2_err"], multi["k2"]),
        # the stacked K3 (its three phases, each one launch for 8 scenes, no
        # input grads): that run's 48; bf16 weight grads (max abs)
        row("fused_mlp_bwd_points_stacked", "fused_mlp_bwd.cu",
            "nerf_tpu/ops/fused_mlp.py:584 (vmapped, nerf_tpu/parallel/multi_scene.py:64)",
            multi["path_counts"]["K2s"]["K3s"], multi["k3_err"], multi["k3"]),
        # the stacked K5 (K5's ray groups within a scene a row of the grid):
        # cli.train_multi --fused_render's 48; bf16 max abs of the maps; ms
        # per step (64 + 192) with raw kept, as training launches it
        row("fused_render_fwd_stacked", "fused_render.cu",
            "nerf_tpu/experimental/fused_render.py:162 (vmapped, nerf_tpu/parallel/multi_scene.py:64)",
            multi["path_counts"]["K5s"]["K5s"], multi["k5_err"], multi["k5"]),
        # the stacked K6 (one compositing pass over every scene's rays, then
        # the stacked K4's phases): that run's 48; bf16 weight grads (max abs)
        row("fused_render_bwd_stacked", "fused_render.cu",
            "nerf_tpu/experimental/fused_render.py:182 (vmapped, nerf_tpu/parallel/multi_scene.py:64)",
            multi["path_counts"]["K5s"]["K6s"], multi["k6_err"], multi["k6"]),
    ]
    # the wide family (csrc/fused_mlp_wide.cu), each a call of its wrapper:
    # launches on phases 27-28's main paths (W = 512: training, the frame,
    # 63 + 128 and --fused_render; 16 octaves: training); its largest error
    # against its plain version over phase 26's cases (the forwards' max
    # abs of raw or the maps, the backwards' worst per-leaf relative L2);
    # times at W = 512 with 10 / 4 octaves: per 32,768-ray chunk (64 + 192;
    # K2w 63 + 191) and per N_rand 4096 step, the same products as bf16
    # torch.matmul as the library's
    for name, tpu, key in (
            ("fused_mlp_wide_fwd", "nerf_tpu/ops/fused_mlp.py:464", "K1w"),
            ("fused_mlp_wide_bwd", "nerf_tpu/ops/fused_mlp.py:621", "K4w"),
            ("fused_mlp_wide_fwd_points", "nerf_tpu/ops/fused_mlp.py:454", "K2w"),
            ("fused_mlp_wide_bwd_points", "nerf_tpu/ops/fused_mlp.py:584", "K3w"),
            ("fused_render_wide_fwd", "nerf_tpu/experimental/fused_render.py:162", "K5w"),
            ("fused_render_wide_bwd", "nerf_tpu/experimental/fused_render.py:182", "K6w")):
        kernels.append(row(name, "fused_mlp_wide.cu", tpu, wide_path["launches"][key],
                           wide["errs"][key], wide["times"][key]))
    # the wide family's stacked plans (K1ws-K6ws, one set of launches for 8
    # scenes): launches on phase 29's cli.train_multi runs (W = 512 on each
    # branch, and the 16 / 6-octave step); the forwards' max abs of raw or
    # the maps, the backwards' worst per-leaf relative L2, against their
    # plain versions at 8 x 1024 rays; ms per step (64 + 192; K2ws/K3ws 63 +
    # 191), the same products as bf16 torch.bmm over the scenes as the
    # library's
    vmapped = " (vmapped, nerf_tpu/parallel/multi_scene.py:64)"
    for name, tpu, key in (
            ("fused_mlp_wide_fwd_stacked", "nerf_tpu/ops/fused_mlp.py:464", "K1ws"),
            ("fused_mlp_wide_bwd_stacked", "nerf_tpu/ops/fused_mlp.py:621", "K4ws"),
            ("fused_mlp_wide_fwd_points_stacked", "nerf_tpu/ops/fused_mlp.py:454", "K2ws"),
            ("fused_mlp_wide_bwd_points_stacked", "nerf_tpu/ops/fused_mlp.py:584", "K3ws"),
            ("fused_render_wide_fwd_stacked", "nerf_tpu/experimental/fused_render.py:162", "K5ws"),
            ("fused_render_wide_bwd_stacked", "nerf_tpu/experimental/fused_render.py:182",
             "K6ws")):
        kernels.append(row(name, "fused_mlp_wide.cu", tpu + vmapped,
                           stacked_wide["launches"][key], stacked_wide["errs"][key],
                           stacked_wide["times"][key]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def render_phase(nets, model, scene, n_samples: int, kernel: str, dev):
    """4 / 11 / 15. render_path over N_FRAMES orbit poses at n_samples + 128:
    shapes, finiteness, exactly 2 launches of ``kernel`` per chunk and none
    of any other, and 4,096 rays strided over frame 0 against the plain
    (unfused) path. Returns the counts, and frame 0's rays for phase 5."""
    from nerf_tpu_torch.render.renderer import RenderSettings
    from nerf_tpu_torch.train.loop import render_path

    rs = RenderSettings(n_samples=n_samples, n_importance=N_IMPORTANCE, perturb=True,
                        use_viewdirs=True, white_bkgd=True)
    poses = scene.render_poses[:N_FRAMES]
    render_path(nets, model, rs, scene, poses[:1], chunk=CHUNK)  # warm-up frame
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rgbs, disps = render_path(nets, model, rs, scene, poses, chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    n_chunks = -(-H * W // CHUNK)
    if rgbs.shape != (N_FRAMES, H, W, 3) or disps.shape != (N_FRAMES, H, W):
        raise RuntimeError(f"bad output shapes {rgbs.shape} {disps.shape}")
    if not (np.isfinite(rgbs).all() and np.isfinite(disps).all()):
        raise RuntimeError("non-finite frame values")
    check_counts(counts, {kernel: N_FRAMES * 2 * n_chunks}, f"render at S={n_samples}")

    render_err, fused_rgb, rays = rgb_against_plain(nets, model, rs, rgbs[0], scene.K, poses[0],
                                                    (H, W, FOCAL), NEAR, FAR, dev)
    phase("render", S=n_samples, frames=N_FRAMES, shape=rgbs.shape, launches=counts,
          compositor="matmul_scan" if kernel_scans(model, rs) else "cumprod",
          ms_per_frame=f"{1e3 * seconds / N_FRAMES:.2f}",
          rays_per_s=f"{N_FRAMES * H * W / seconds:.0f}",
          rgb_vs_plain_max_abs=f"{render_err:.3e}", tol=RENDER_RGB_TOL,
          rgb_mean=f"{rgbs.mean():.4f}", rgb_std_checked=f"{fused_rgb.std():.3e}")
    if not render_err <= RENDER_RGB_TOL:
        raise RuntimeError(f"fused render disagrees with the plain path: {render_err}")
    return {"counts": counts, "rays": rays}


def kernel_scans(model, rs) -> bool:
    """Whether ``render_rays`` composites the kernel path's levels with
    nerf_tpu's matmul scan (ROADMAP A.7): the planes branch (K1 / K1w:
    ``fused``, not ``fused_render``, both levels' sample counts multiples of
    8) in bf16."""
    return (model.fused and not model.fused_render and model.compute_dtype == "bfloat16"
            and rs.n_samples % 8 == 0 and (rs.n_samples + rs.n_importance) % 8 == 0)


@contextlib.contextmanager
def plain_compositor(scan: bool):
    """The plain (unfused) path's compositing as the kernel path's: with
    ``scan``, ``render_rays``' points-in ``raw2outputs`` is replaced, for the
    block, by ``raw2outputs_planes(matmul_scan=True)`` on the same raw as
    planes, so that a gate holding the planes branch to the plain path
    charges the kernels alone, not the two compositors' gap."""
    from nerf_tpu_torch.render import renderer

    real = renderer.raw2outputs

    def scanned(raw, z_vals, rays_d, **kwargs):
        return renderer.raw2outputs_planes(raw.movedim(-1, 0), z_vals, rays_d,
                                           matmul_scan=True, **kwargs)

    if scan:
        renderer.raw2outputs = scanned
    try:
        yield
    finally:
        renderer.raw2outputs = real


def rgb_against_plain(nets, model, rs, rgb, K, c2w, hwf, near: float, far: float, dev):
    """RENDER_CHECK_RAYS rays strided over a frame ``rgb`` [H, W, 3] that
    ``render_path`` rendered for the pose ``c2w``, through the plain
    (unfused) path with the kernel path's compositor (``plain_compositor``):
    the max abs difference of rgb_map, the checked rays' rgb, and the
    frame's rays (ro, rd, vd) as ``render_rays`` takes them."""
    from nerf_tpu_torch.geom.rays import get_rays
    from nerf_tpu_torch.render.renderer import prepare_rays, render_rays

    h, w, focal = hwf
    plain = dataclasses.replace(model, fused=False, fused_render=False)
    c2w = torch.as_tensor(np.asarray(c2w)[:3, :4], dtype=torch.float32, device=dev)
    ro, rd, vd, nv, fv = prepare_rays(*get_rays(h, w, K, c2w), rs, h, w, focal, near, far)
    idx = torch.arange(RENDER_CHECK_RAYS, device=dev) * (h * w // RENDER_CHECK_RAYS)
    with torch.no_grad(), plain_compositor(kernel_scans(model, rs)):
        ref = render_rays(nets, plain, rs.eval_mode(), *(t[idx] for t in (ro, rd, vd, nv, fv)))
    fused_rgb = rgb.reshape(-1, 3)[idx.cpu().numpy()]
    err = float(np.abs(fused_rgb - ref["rgb_map"].cpu().numpy()).max())
    return err, fused_rgb, (ro, rd, vd)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def check_k4(mlp, pe_pts, pe_views, rng, dev):
    """6. K4 against its plain version; returns the bf16 max abs errors."""
    from nerf_tpu_torch.ops import fused_mlp

    errs = []
    shapes = [(CHECK_RAYS, N_SAMPLES), (RAGGED_RAYS, N_SAMPLES),
              (CHECK_RAYS, N_SAMPLES + N_IMPORTANCE), (RAGGED_RAYS, N_SAMPLES + N_IMPORTANCE)]
    cases = [(torch.float32, K4_F32_TOL, shapes), (torch.bfloat16, K4_BF16_TOL, shapes + [
        (N_RAND, N_SAMPLES), (N_RAND, N_SAMPLES + N_IMPORTANCE)])]
    gen = torch.Generator(device=dev).manual_seed(1)
    for dtype, tol, dtype_shapes in cases:
        with torch.no_grad():
            kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, dtype)
        for R, S in dtype_shapes:
            rays = make_rays(rng, R, S, dev)
            # the cotangent of an image loss: small and of one sign per channel
            g = (0.5 + torch.rand(4, R, S, device=dev, generator=gen)) * 1e-4
            before = fused_mlp.fused_rays_planes_bwd.launches
            got = fused_mlp.fused_rays_planes_bwd(kp, *rays, g)
            again = fused_mlp.fused_rays_planes_bwd(kp, *rays, g)
            torch.cuda.synchronize()
            if fused_mlp.fused_rays_planes_bwd.launches != before + 2:
                raise RuntimeError("the K4 launch counter did not move")
            ref = fused_mlp.fused_rays_planes_bwd_reference(kp, *rays, g)
            worst, leaf = max((rel_l2(got[n], ref[n]), n) for n in fused_mlp.KP_NAMES)
            max_abs = max(float((got[n] - ref[n]).abs().max()) for n in fused_mlp.KP_NAMES)
            scale = max(float(ref[n].abs().max()) for n in fused_mlp.KP_NAMES)
            same = all(torch.equal(got[n], again[n]) for n in fused_mlp.KP_NAMES)
            finite = all(bool(torch.isfinite(got[n]).all()) for n in fused_mlp.KP_NAMES)
            phase("grad", dtype=str(dtype).split(".")[-1], R=R, S=S,
                  worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=tol,
                  max_abs=f"{max_abs:.3e}", grad_max_abs=f"{scale:.3e}",
                  bit_identical=same)
            if not (finite and same and worst <= tol):
                raise RuntimeError(f"K4 disagrees with its plain version or is not "
                                   f"deterministic: {leaf} {worst} > {tol}, same={same}")
            if dtype == torch.bfloat16:
                errs.append(max_abs)
            del got, again, ref
            torch.cuda.empty_cache()
    return errs


def rows_against(got: dict, ref: dict):
    """(max abs, largest share of elements that differ in a block, worst
    excess of |d| over one bf16 ulp of the larger side and
    RECOMPUTE_ULP_ATOL) of the workspace rows ``got`` (their first columns)
    against ``ref``, block by block."""
    worst, share, excess = 0.0, 0.0, -1.0
    for name, r in ref.items():
        g = got[name][:, : r.shape[1]].float()
        d = (g - r).abs()
        over = d - RECOMPUTE_ULP * torch.maximum(g.abs(), r.abs()) - RECOMPUTE_ULP_ATOL
        worst, share = max(worst, float(d.max())), max(share, float((d > 0).float().mean()))
        excess = max(excess, float(over.max()))
    return worst, share, excess


@torch.no_grad()
def check_recompute(mlp, pe_pts, pe_views, dev):
    """6. The gate of ROADMAP C.4: the bf16 backward's recompute launch (K4's
    and K3's first, K1's tile) alone, with raw, in ray mode at phase 14's
    shapes and K4's training shapes, and in points mode at phase 10's kind
    of shapes and K3's training shapes (a direction per point or per ray):
    its raw bit for bit K1's (K2's) on the same inputs; its mask words
    exactly the signs of its own workspace rows h0..h7 and hv; each block of
    its rows within a bf16 ulp (RECOMPUTE_ULP, RECOMPUTE_ULP_ATOL) of that
    layer's plain version on the kernel's own inputs, at most
    RECOMPUTE_LAYER_SHARE of them differing; against the whole plain chain
    at most RECOMPUTE_CHAIN_SHARE of the rows and RECOMPUTE_MASK_SHARE of
    the mask bits differing; all finite up to the last padded point (the
    buffer is NaN before the launch); and the launch without raw (the
    backward's) writing the same rows and words. Its inputs come from a
    generator of its own, so the later phases draw what they drew before
    it. Returns the max abs errors of the rows against the plain chain."""
    from nerf_tpu_torch.ops import fused_mlp

    rng = np.random.default_rng(6)
    W = mlp.cfg.width
    kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, torch.bfloat16)
    blobs = fused_mlp.kernel_blobs(kp)
    fine, fine63 = N_SAMPLES + N_IMPORTANCE, POINTS_SAMPLES + N_IMPORTANCE
    rays_shapes = [(R, S) for S in (N_SAMPLES, fine, 200) for R in (CHECK_RAYS, RAGGED_RAYS)] + \
        [(N_RAND, N_SAMPLES), (N_RAND, fine)]
    point_shapes = [(CHECK_RAYS, POINTS_SAMPLES, 1), (RAGGED_RAYS, fine63, 1),
                    (CHECK_RAYS, N_SAMPLES, N_SAMPLES), (RAGGED_RAYS, 200, 200),
                    (N_RAND, POINTS_SAMPLES, 1), (N_RAND, fine63, 1)]
    layers = [(f"h{i}", i * (W // 32), W) for i in range(8)] + \
        [("hv", 8 * (W // 32), W // 2)]
    errs = []
    for mode, shapes in (("rays", rays_shapes), ("points", point_shapes)):
        for shape in shapes:
            R, S = shape[:2]
            n = R * S
            if mode == "rays":
                rays = make_rays(rng, R, S, dev)
                got = fused_mlp.bwd_recompute_rays(kp, *rays, raw=True, blobs=blobs)
                bare = fused_mlp.bwd_recompute_rays(kp, *rays, blobs=blobs)
                fwd = fused_mlp.fused_rays_planes(kp, *rays, blobs).reshape(4, n).T
                x, v, spr = fused_mlp._ray_points(*rays[:2], rays[3]), rays[2], S
                del rays
            else:
                spr = shape[2]
                x, v = ray_points(rng, R, S, spr, dev)
                got = fused_mlp.bwd_recompute(kp, x, v, spr, raw=True, blobs=blobs)
                bare = fused_mlp.bwd_recompute(kp, x, v, spr, blobs=blobs)
                fwd = fused_mlp.fused_points(kp, x, v, spr, blobs)
            torch.cuda.synchronize()
            raw_same = same_bits(got.raw, fwd)
            del fwd
            masks_own = all(
                torch.equal(fused_mlp.unpack_mask_bits(got.masks[m0 : m0 + k // 32], k),
                            (got.rows[name] > 0).T)
                for name, m0, k in layers)
            bare_same = (sorted(bare.rows) == sorted(got.rows)
                         and torch.equal(bare.masks, got.masks)
                         and all(same_bits(bare.rows[k], got.rows[k]) for k in got.rows))
            del bare
            padded = all(bool(torch.isfinite(t).all()) for t in got.rows.values())
            plain, plain_ok = recompute_against_plain(kp, got, x, v, spr)
            del got, x, v
            torch.cuda.empty_cache()
            errs.append(plain["chain_max_abs"])
            phase("recompute", mode=mode, R=R, S=S, spr=spr, raw_bits_equal_forward=raw_same,
                  masks_are_rows_signs=masks_own, without_raw_same=bare_same,
                  padded_rows_finite=padded, **{k: f"{v:.3e}" for k, v in plain.items()},
                  ulp=RECOMPUTE_ULP, atol=RECOMPUTE_ULP_ATOL, layer_share=RECOMPUTE_LAYER_SHARE,
                  chain_share=RECOMPUTE_CHAIN_SHARE, mask_share=RECOMPUTE_MASK_SHARE)
            if not (raw_same and masks_own and bare_same and padded and plain_ok):
                raise RuntimeError(f"the recompute launch fails the C.4 gate at {mode} {shape}: "
                                   f"raw={raw_same} masks={masks_own} bare={bare_same} "
                                   f"padded={padded} against the plain version {plain}")
    return errs


def recompute_against_plain(kp, got, x, v, spr: int):
    """(the numbers, within the bounds) of a recompute ``got`` on points x
    and directions v against its plain version: each layer on the kernel's
    own inputs (the worst excess over a bf16 ulp and RECOMPUTE_ULP_ATOL, at
    most 0; the share of elements that differ, at most
    RECOMPUTE_LAYER_SHARE), and the whole plain chain (max abs; the share
    of elements, at most RECOMPUTE_CHAIN_SHARE, and of mask bits, at most
    RECOMPUTE_MASK_SHARE, that differ)."""
    from nerf_tpu_torch.ops import fused_mlp

    n = x.shape[0]
    lay = fused_mlp.recompute_layers_reference(kp, got.rows, x, v, spr)
    ref = fused_mlp.bwd_recompute_reference(kp, x, v, spr)
    if "ev" not in got.rows:  # a direction per ray: the kernel keeps no ev rows
        del lay["ev"], ref.rows["ev"]
    _, lay_share, lay_excess = rows_against(got.rows, lay)
    worst, share, chain_excess = rows_against(got.rows, ref.rows)
    flips = got.masks[:, :n] ^ ref.masks
    mask_share = sum(int(((flips >> b) & 1).sum()) for b in range(32)) / (32 * flips.numel())
    out = {"layer_excess_over_ulp": lay_excess, "layer_share_differing": lay_share,
           "chain_max_abs": worst, "chain_share_differing": share,
           "chain_excess_over_ulp": chain_excess, "mask_bits_share_differing": mask_share}
    return out, (lay_excess <= 0 and lay_share <= RECOMPUTE_LAYER_SHARE
                 and share <= RECOMPUTE_CHAIN_SHARE and mask_share <= RECOMPUTE_MASK_SHARE)


@torch.no_grad()
def check_chain(mlp, pe_pts, pe_views, dev):
    """6. The chain's gate: the bf16 backward's recompute and chain launches
    alone (K4's, K3's and K6's first two), at W=256 (``mlp``) and W=128, in
    ray mode and in points mode with a direction per point and per ray, with
    and without input grads, at 1, 127, 129 and 33,984 points and at K4's
    coarse training shape: each of the chain's blocks (gc, d_hv, d_feat,
    d0..d7) within a bf16 ulp of its one product on the kernel's own inputs
    (CHAIN_ULP, CHAIN_ULP_ATOL of the block's largest magnitude), at most
    CHAIN_LAYER_SHARE of the case's elements differing, exact zeros past the
    points (the workspace is NaN before); the f32 d_hv rows, the bias
    partials, dx and dv within CHAIN_F32_REL of theirs, zero past the
    points; two launches bit-identical. Returns the max abs of the blocks
    against their products."""
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp

    rng = np.random.default_rng(8)
    nets = {256: mlp, 128: NeRFMLP(MLPConfig(width=128), seed=128, device=dev)}
    # (mode, R, S, spr, input grads)
    edges = [("rays", 1, 1, 1, False), ("rays", 127, 1, 1, False), ("rays", 3, 43, 43, False),
             ("rays", 531, 64, 64, False), ("points", 127, 1, 1, True),
             ("points", 129, 1, 1, False), ("points", 3, 43, 43, True),
             ("points", 1, 127, 127, False), ("points", 531, 64, 1, True),
             ("points", 531, 64, 64, False)]
    cases = [(256, c) for c in edges + [("rays", N_RAND, N_SAMPLES, N_SAMPLES, False)]] + \
        [(128, c) for c in edges]
    errs = []
    for width, (mode, R, S, spr, input_grads) in cases:
        kp = fused_mlp.pack_params(nets[width], pe_pts, pe_views, torch.bfloat16)
        n = R * S
        g = torch.from_numpy(((0.5 + rng.random((n, 4))) * 1e-4).astype(np.float32)).to(dev)
        if mode == "rays":
            rays = make_rays(rng, R, S, dev)
            gp = g.T.reshape(4, R, S).contiguous()
            runs = [fused_mlp.bwd_chain_rays(kp, *rays, gp) for _ in range(2)]
            x, v = fused_mlp._ray_points(*rays[:2], rays[3]), rays[2]
            del rays, gp
        else:
            x, v = ray_points(rng, R, S, spr, dev)
            runs = [fused_mlp.bwd_chain(kp, x, v, spr, g, input_grads) for _ in range(2)]
        torch.cuda.synchronize()
        (rec, got), (_, again) = runs
        lay = fused_mlp.chain_layers_reference(kp, got.rows, rec.masks, g, spr,
                                               x if input_grads else None, v)
        same, zeros, worst, excess, differ, total = True, True, 0.0, -1.0, 0, 0
        for name, rows in got.rows.items():
            same = same and same_bits(rows, again.rows[name])
            zeros = zeros and bool((rows[:, n:] == 0).all())
            ref, r = lay.rows[name], rows[:, :n].float()
            d = (r - ref).abs()
            over = d - CHAIN_ULP * torch.maximum(r.abs(), ref.abs())
            scale = float(ref.abs().max())
            worst = max(worst, float(d.max()))
            excess = max(excess, float(over.max()) / scale if scale > 0 else float("inf"))
            differ, total = differ + int((d > 0).sum()), total + d.numel()
        share = differ / total
        f32 = {f"bias.{k}": (t, lay.bias[k], again.bias[k]) for k, t in got.bias.items()}
        if spr > 1:
            f32["dhv32"] = (got.dhv32, lay.dhv32, again.dhv32)
        if input_grads:
            f32["dx"] = (got.dx, lay.dx, again.dx)
        if got.dv is not None:
            f32["dv"] = (got.dv, lay.dv, again.dv)
        rels = {}
        for name, (t, ref, t2) in f32.items():
            same = same and same_bits(t, t2)
            zeros = zeros and bool((t[ref.shape[0]:] == 0).all())
            rels[name] = rel_l2(t[: ref.shape[0]], ref)
        f32_worst = max(rels.values())
        dv_ok = (got.dv is not None) == (input_grads and spr == 1)
        errs.append(worst)
        phase("chain", W=width, mode=mode, R=R, S=S, spr=spr, input_grads=input_grads,
              bit_identical=same, padded_zero=zeros, max_abs=f"{worst:.3e}",
              excess_over_ulp_of_max=f"{excess:.3e}", share_differing=f"{share:.3e}",
              f32_worst=max(rels, key=rels.get), f32_rel_l2=f"{f32_worst:.3e}",
              atol=CHAIN_ULP_ATOL, layer_share=CHAIN_LAYER_SHARE, f32_rel=CHAIN_F32_REL)
        if not (same and zeros and dv_ok and excess <= CHAIN_ULP_ATOL
                and share <= CHAIN_LAYER_SHARE and f32_worst <= CHAIN_F32_REL):
            raise RuntimeError(f"the chain launch fails its gate at W={width} {mode} "
                               f"{(R, S, spr, input_grads)}: same={same} zeros={zeros} "
                               f"dv={dv_ok} excess={excess} share={share} f32={rels}")
        del runs, rec, got, again, lay, x, v, g
        torch.cuda.empty_cache()
    return errs


def train_phase(scene, dev, n_samples: int, fwd: str, bwd: str, views=None,
                fused_render: bool = False):
    """7 / 12 / 16. train() at the lego recipe with n_samples + 128 samples,
    N_rand=4096, on 8 views rendered by a teacher (rendered here unless
    ``views`` are given): exactly 2 launches of ``fwd`` and of ``bwd`` a
    step and none of any other kernel, a finite and falling loss, the rates,
    and a short profiled window."""
    from nerf_tpu_torch import config
    from nerf_tpu_torch.data.scene import Scene
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.train.loop import render_path, render_settings_from_config

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = config.load_config([
        f"--config={os.path.join(here, 'configs', 'lego.txt')}", f"--N_rand={N_RAND}",
        f"--N_samples={n_samples}",
        f"--n_iters={WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS}", "--i_print=10", "--i_img=0",
        "--i_weights=0", "--i_testset=0", "--i_video=0", "--data_axis=1",
        f"--basedir={os.path.join(here, 'build', 'chip_smoke')}",
        f"--fused_render={fused_render}",
    ])
    model = make_model(cfg)
    rs = render_settings_from_config(cfg)
    if views is None:
        # the targets: 8 views on the orbit rendered by a teacher seeded apart
        teacher = {"coarse": NeRFMLP(model.coarse, seed=1000, device=dev),
                   "fine": NeRFMLP(model.fine, seed=1001, device=dev)}
        poses = scene.render_poses[:: len(scene.render_poses) // TRAIN_VIEWS][:TRAIN_VIEWS]
        images, _ = render_path(teacher, model, rs, scene, poses, chunk=CHUNK, device=dev)
        views = Scene(images=images, poses=np.asarray(poses)[:, :3, :4].astype(np.float32),
                      render_poses=scene.render_poses, hwf=scene.hwf, K=scene.K,
                      i_train=np.arange(TRAIN_VIEWS), i_val=np.zeros(0, int),
                      i_test=np.zeros(0, int), near=NEAR, far=FAR)
    info = timed_train(cfg, views, dev, fwd, bwd)
    return {**info, "model": model, "rs": rs, "views": views}


def timed_train(cfg, views, dev, fwd: str, bwd: str,
                steps=(WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS), wide: bool = False, **fields):
    """train() on ``views`` with ``cfg`` (its cadences off) for ``steps``'
    warm-up, timed and profiled steps (cfg.n_iters their sum): exactly 2
    launches of ``fwd`` and of ``bwd`` a timed step and none of any other
    kernel (``wide``: the wide family's, without the tile's recompute and
    chain launches, and no call of the single-scene plain MLP), a finite and
    falling loss, ms/step, rays/s and MFU, then the profiled window's device
    time. ``fields`` go on the phase's line."""
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.train.loop import train
    from nerf_tpu_torch.utils.profiler import StepTimer, device_peak_flops

    model = make_model(cfg)
    n_samples, n_rand = cfg.N_samples, cfg.N_rand
    losses, marks = [], {}
    warmup, timed, profiled = steps
    end = warmup + timed
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def on_step(i, state, aux):
        if i <= end:
            losses.append(aux["loss"])
        if i in (warmup, end, end + profiled):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
            if i == warmup:  # the main path's counts start here
                reset_counts()
                NeRFMLP.plain_calls = 0
            elif i == end:  # ... and end here; a short profiled window follows
                marks["counts"] = read_counts()
                marks["plain"] = NeRFMLP.plain_calls
                prof.__enter__()
            else:
                prof.__exit__(None, None, None)

    result = train(cfg, views, hooks={"on_step": on_step}, device=dev)
    counts = marks["counts"]
    seconds = marks[end] - marks[warmup]
    loss = torch.stack(losses).cpu().numpy()
    timer = StepTimer(n_rand, 2 * n_samples + cfg.N_importance,
                      fused_mlp.flops_per_point(model.coarse, model.pe_pts, model.pe_views),
                      peak=device_peak_flops(dev))
    rep = timer.report(steps=timed, elapsed=seconds)
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    phase("train", **fields, S=n_samples, steps=timed, n_rand=n_rand,
          ms_per_step=f"{1e3 * seconds / timed:.3f}",
          rays_per_s=f"{rep['rays_per_sec']:.0f}",
          mfu="unknown card" if rep["mfu"] is None else f"{rep['mfu']:.4f}",
          launches=counts, plain_mlp_calls=marks["plain"], loss_first5=f"{first:.6f}",
          loss_last5=f"{last:.6f}",
          psnr_last=f"{result.history[-1][2]:.3f}" if result.history else "none")
    if not np.isfinite(loss).all():
        raise RuntimeError("non-finite training loss")
    # the tile's bf16 backward's first two launches, the recompute and the
    # chain, a backward each (the wide family counts its calls alone)
    want = {fwd: 2 * timed, bwd: 2 * timed}
    if not wide:
        want.update(recompute=2 * timed, chain=2 * timed)
    if bwd in ("K6", "K6w"):  # and K6's compositing pass, one a backward
        want["composite"] = 2 * timed
    check_counts(counts, want, f"{timed} steps at S={n_samples}")
    if wide and marks["plain"]:
        raise RuntimeError(f"the plain MLP ran {marks['plain']} times on the wide path")
    if not last < first:
        raise RuntimeError(f"the loss did not fall: {first} -> {last}")
    profile = profile_report(prof, marks[end + profiled] - marks[end], fwd, bwd, steps=profiled,
                             **fields)
    return {"cfg": cfg, "nets": result.state.nets, "counts": counts, "profile": profile,
            "ms_per_step": 1e3 * seconds / timed}


def profile_report(prof, seconds: float, fwd: str, bwd: str, steps: int = PROFILED_STEPS,
                   **fields) -> None:
    """Device time of ``steps`` profiled training steps, by kernel and by
    group (the forward kernel ``fwd``, the backward ``bwd``'s kernels, the
    rest; the wide family's kernels, forward and backward alike, as one
    group ``fwd``+``bwd``), and the device's idle share of the window. The
    step's launch counts show which forward and backward ran: the two pairs
    share their kernels' names."""
    from nerf_tpu_torch.tools.bwd_phase1 import K4_LAUNCHES
    from nerf_tpu_torch.utils.profiler import device_rows

    # the backward's own workspace memset is one of the step's few "Memset"
    # entries; those stay in "other", so its share reads ~0.01 ms low
    k4 = K4_LAUNCHES[:-1]
    groups = {fwd: ("render_bf16_sm90",) if fwd.startswith("K5") else ("fwd_bf16_sm90",),
              bwd: ("composite_bwd",) + k4 if bwd.startswith("K6") else k4}
    if fwd.endswith("w"):
        groups = {f"{fwd}+{bwd}": WIDE_KERNELS}
    rows = device_rows(prof)
    busy_us = sum(r[0] for r in rows)
    # ROADMAP C.7: the device's user annotations (record_function ranges,
    # Adam's among them) span kernels that are rows of their own; the
    # trace's own kernel, copy and set events are the check of the sum
    notes_us = sum(r[0] for r in device_rows(prof, annotations=True))
    trace_us = trace_device_us(prof)
    share = {g: 0.0 for g in list(groups) + ["other"]}
    for us, key, _ in rows:
        g = next((g for g, keys in groups.items() if any(k in key for k in keys)), "other")
        share[g] += us
    wall_ms = 1e3 * seconds
    # K6's compositing pass apart (within the backward's share)
    apart = {}
    if bwd.startswith("K6"):
        apart["composite_bwd"] = sum(us for us, key, _ in rows if "composite_bwd" in key)
    phase("profile", **fields, steps=steps, wall_ms_per_step=f"{wall_ms / steps:.3f}",
          device_ms_per_step=f"{busy_us / 1e3 / steps:.3f}",
          idle_share=f"{max(0.0, 1 - busy_us / 1e3 / wall_ms):.3f}" if busy_us else "not measured",
          annotation_ms_per_step=f"{notes_us / 1e3 / steps:.3f}",
          idle_share_with_annotations=f"{max(0.0, 1 - (busy_us + notes_us) / 1e3 / wall_ms):.3f}",
          **{f"trace_{cat}_ms_per_step": f"{us / 1e3 / steps:.3f}"
             for cat, us in trace_us.items()},
          **{f"{g}_ms_per_step": f"{v / 1e3 / steps:.3f}"
             for g, v in {**share, **apart}.items()})
    for us, key, count in sorted(rows, reverse=True)[:12]:
        print(f"  device {us / 1e3 / steps:8.3f} ms/step  x{count // steps:<4d} {key[:90]}",
              flush=True)
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "idle_share": max(0.0, 1 - busy_us / 1e3 / wall_ms) if busy_us else None,
            **{f"{g}_ms_per_step": v / 1e3 / steps for g, v in share.items()}}


def trace_device_us(prof) -> dict:
    """Device us of a profile by the Chrome trace's own categories: the
    kernels, copies and sets, and the user annotations apart."""
    path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_trace_"), "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)
    shutil.rmtree(os.path.dirname(path))
    events = events["traceEvents"] if isinstance(events, dict) else events
    total = {"kernel_copy_set": 0.0, "gpu_user_annotation": 0.0}
    for e in events:
        cat = e.get("cat", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            total["kernel_copy_set"] += float(e.get("dur", 0))
        elif cat == "gpu_user_annotation":
            total["gpu_user_annotation"] += float(e.get("dur", 0))
    return total


def step_grads_phase(info, dev):
    """8 / 12 / 16. one fused step's grads against the plain (unfused) path."""
    from nerf_tpu_torch.geom.rays import get_rays

    model, rs, views, nets = info["model"], info["rs"], info["views"], info["nets"]
    c2w = torch.as_tensor(views.poses[0], device=dev)
    ro, rd = (t.reshape(-1, 3) for t in get_rays(H, W, views.K, c2w))
    idx = torch.arange(CHECK_RAYS, device=dev) * (H * W // CHECK_RAYS)
    ro, rd = ro[idx], rd[idx]
    target = torch.as_tensor(views.images[0], device=dev).reshape(-1, 3)[idx]
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    grads_against_plain(nets, model, rs, ro, rd, vd, NEAR, FAR, target, dev)


def scan_phase(dev) -> dict:
    """7 (ROADMAP A.7). The lego bf16 step's compositing of K1's planes, both
    levels (N_rand 4096 rays at S = 64 and 192, white background), forward
    and backward, in both forms on the same inputs: nerf_tpu's matmul scan
    (the bf16 planes branch's) and the exact cumprod (the f32 path's). Device
    ms per step from a profiled window of SCAN_REPS steps each, the two
    forms' weights and grads of raw within nerf_tpu's bound on them, and the
    number of device kernels a form's step runs."""
    from nerf_tpu_torch.ops.compositing import raw2outputs_planes
    from nerf_tpu_torch.utils.profiler import device_rows

    gen = torch.Generator(device=dev).manual_seed(3)
    cases = []
    for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        raw4 = (2 * torch.randn(4, N_RAND, S, generator=gen, device=dev)).requires_grad_(True)
        u = torch.rand(N_RAND, S, generator=gen, device=dev)
        z = torch.sort(u * (FAR - NEAR) + NEAR, -1).values
        rd = torch.randn(N_RAND, 3, generator=gen, device=dev)
        cot = torch.rand(N_RAND, 3, generator=gen, device=dev)
        cases.append((raw4, z, rd, cot))

    def step(scan: bool):
        outs = []
        for raw4, z, rd, cot in cases:
            o = raw2outputs_planes(raw4, z, rd, white_bkgd=True, matmul_scan=scan)
            loss = (o.rgb * cot).sum() + o.acc.sum() + o.disp.sum()
            outs.append((o.weights.detach(), torch.autograd.grad(loss, raw4)[0]))
        return outs

    scan_out, exact_out = step(True), step(False)
    w_err = max(float((a[0] - b[0]).abs().max()) for a, b in zip(scan_out, exact_out))
    g_err = max(float((a[1] - b[1]).abs().max()) for a, b in zip(scan_out, exact_out))
    close = all(torch.allclose(a[i], b[i], rtol=SCAN_RTOL, atol=SCAN_ATOL)
                for a, b in zip(scan_out, exact_out) for i in (0, 1))
    ms, kernels = {}, {}
    for name, scan in (("matmul_scan", True), ("cumprod", False)):
        step(scan)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(SCAN_REPS):
                step(scan)
            torch.cuda.synchronize()
        rows = device_rows(prof)
        ms[name] = sum(r[0] for r in rows) / 1e3 / SCAN_REPS
        kernels[name] = len(rows)
    phase("scan", n_rand=N_RAND, S=f"{N_SAMPLES}+{N_SAMPLES + N_IMPORTANCE}",
          matmul_scan_device_ms_per_step=f"{ms['matmul_scan']:.4f}",
          cumprod_device_ms_per_step=f"{ms['cumprod']:.4f}",
          device_kernels=kernels, weights_max_abs_diff=f"{w_err:.3e}",
          grad_max_abs_diff=f"{g_err:.3e}", atol=SCAN_ATOL, rtol=SCAN_RTOL)
    if not close:
        raise RuntimeError(f"the matmul scan is {w_err} / {g_err} from the cumprod")
    return ms


def grads_against_plain(nets, model, rs, ro, rd, vd, near, far, target, dev, **fields):
    """One fused step's weight grads on the rays (ro, rd, as the step's
    ``loss_fn`` takes them: after NDC where the scene has it; viewdirs vd)
    against the plain (unfused) path's, with the kernel path's compositor
    (``plain_compositor``), on the same draws."""
    from nerf_tpu_torch.train.step import draw_overrides, loss_fn

    n_rays = ro.shape[0]
    near = torch.full((n_rays,), near, device=dev)
    far = torch.full((n_rays,), far, device=dev)
    ov = draw_overrides(torch.Generator(device=dev).manual_seed(7), n_rays, rs)
    params = [p for level in ("coarse", "fine") for p in nets[level].parameters()]
    names = [f"{level}.{n}" for level in ("coarse", "fine") for n, _ in nets[level].named_parameters()]
    grads = {}
    for fused in (True, False):
        m = model if fused else dataclasses.replace(model, fused=False, fused_render=False)
        with plain_compositor(not fused and kernel_scans(model, rs)):
            loss, _ = loss_fn(nets, m, rs, ro, rd, vd, near, far, target, overrides=ov)
        grads[fused] = torch.autograd.grad(loss, params)
    worst, leaf = max((rel_l2(a, b), n) for n, a, b in zip(names, grads[True], grads[False]))
    phase("grads", **fields, S=rs.n_samples, rays=n_rays, worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf,
          tol=STEP_GRAD_TOL)
    if not worst <= STEP_GRAD_TOL:
        raise RuntimeError(f"fused step grads disagree with the plain path: {leaf} {worst}")


def backward_matmul_chain(kp, n_pts: int, part: str = "all"):
    """The backward's big products as bf16 torch.matmul calls at K4's
    shapes: the forward recompute (W05e, W1..W7, Wf, Wvf), the cotangents
    d·Wᵀ (Wvf, Wf, W7..W1) and the weight grads aᵀ·d (W05e, W1..W7, Wf,
    Wvf); only one group with ``part`` "recompute" (10), "chain" (9) or
    "weight_grads" (10). A library yardstick, timed here only and used
    nowhere in the port."""
    from nerf_tpu_torch.ops import fused_mlp

    dev, Wd = kp["W1"].device, kp["W1"].shape[0]
    ke = fused_mlp.embed_pad(*fused_mlp._num_freqs(kp))[0]  # the tile's 64 at 10 octaves
    bf = torch.bfloat16
    e = torch.randn(n_pts, ke, dtype=bf, device=dev)
    a = torch.randn(n_pts, Wd, dtype=bf, device=dev)
    # the weight grads' second operand apart from the first, as the kernel's
    # d rows are apart from its h rows: aᵀ·a reads one tensor for both and
    # moves half the bytes
    d = torch.randn(n_pts, Wd, dtype=bf, device=dev) if part in ("all", "weight_grads") else a
    ah = torch.randn(n_pts, Wd // 2, dtype=bf, device=dev)
    d05 = torch.randn(n_pts, 2 * Wd, dtype=bf, device=dev)
    w05 = torch.nn.functional.pad(kp["W05e"], (0, 0, 0, ke - kp["W05e"].shape[0]))
    trunk = [kp[f"W{i}"] for i in range(1, 8)] + [kp["Wf"]]

    def run():
        if part in ("all", "recompute"):
            torch.matmul(e, w05)
            for w in trunk + [kp["Wvf"]]:
                torch.matmul(a, w)
        if part in ("all", "chain"):
            torch.matmul(ah, kp["Wvf"].T)
            for w in trunk:
                torch.matmul(a, w.T)
        if part in ("all", "weight_grads"):
            torch.matmul(e.T, d05)
            for _ in trunk:
                torch.matmul(a.T, d)
            torch.matmul(a.T, ah)

    return run


def k4_times(cfg, pe_pts, pe_views, dev):
    """9. K4 at the training shapes: one coarse and one fine launch a step.
    Then 10 profiled steps of both launches split by K4's kernels: phase 1's
    recompute (``bwd_recompute_sm90``) and chain (``bwd_chain_sm90``), each
    beside its own bound and its own products as bf16 torch.matmul (10 and
    9), and the weight-grad phase (``wgrad_bf16``) beside its own bound
    (each workspace row and per-ray row read once, the grads written once)
    and its 10 weight-grad products as bf16 torch.matmul. Returns K4's
    numbers per step, the recompute's and the chain's (their plain
    versions' times: the plain recompute and the plain chain at both
    shapes)."""
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import _build, fused_mlp
    from nerf_tpu_torch.tools.bwd_phase1 import k4_split
    from nerf_tpu_torch.tools.wgrad_check import last_launch

    mlp = NeRFMLP(cfg, seed=2, device=dev)
    with torch.no_grad():
        kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, torch.bfloat16)
    blobs = fused_mlp.kernel_blobs(kp)
    wbytes = sum(t.numel() * t.element_size() for t in blobs) + 2 * sum(
        kp[n].numel() for n in ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "Wf", "Wvf"))
    gbytes = 4 * sum(v.numel() for v in kp.values())
    rng = np.random.default_rng(5)
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    out, wgrad, recompute, chain = dict(zero), dict(zero), dict(zero), dict(zero)
    step, launches = [], {}
    for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        rays = make_rays(rng, N_RAND, S, dev)
        g = torch.rand(4, N_RAND, S, device=dev) * 1e-4
        step.append((*rays, g))
        n_pts = N_RAND * S
        ms = cuda_ms(lambda: fused_mlp.fused_rays_planes_bwd(kp, *rays, g, blobs), reps=10, warmup=2)
        launches[f"S={S}"] = last_launch(_build.load("fused_mlp_bwd"))  # phase 3's clusters
        plain_ms = cuda_ms(lambda: fused_mlp.fused_rays_planes_bwd_reference(kp, *rays, g), reps=2)
        torch.cuda.empty_cache()
        products = backward_matmul_chain(kp, n_pts)
        library_ms = cuda_ms(products, reps=5)
        del products
        for part, t in (("weight_grads", wgrad), ("recompute", recompute), ("chain", chain)):
            products = backward_matmul_chain(kp, n_pts, part)
            t["library_ms"] += cuda_ms(products, reps=5)
            del products
        x = fused_mlp._ray_points(rays[0], rays[1], rays[3])
        recompute["plain_ms"] += cuda_ms(
            lambda: fused_mlp.bwd_recompute_reference(kp, x, rays[2], S), reps=2)
        g_rows = g.reshape(4, n_pts).T
        chain["plain_ms"] += cuda_ms(
            lambda: fused_mlp.bwd_chain_reference(kp, x, rays[2], S, g_rows), reps=2)
        del x, g_rows
        torch.cuda.empty_cache()
        flops = fused_mlp.bwd_flops(cfg, pe_pts, pe_views, N_RAND, S)
        io_bytes = N_RAND * 9 * 4 + n_pts * 4 + n_pts * 16 + wbytes + gbytes
        ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * io_bytes / PEAK_BYTES
        phase("bwd_times", S=S, points=n_pts, ms=f"{ms:.3f}", bound_ms=f"{max(ops_ms, bytes_ms):.3f}",
              plain_ms=f"{plain_ms:.3f}", library_ms=f"{library_ms:.3f}",
              tflops=f"{flops / ms / 1e9:.1f}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
            out[k] += v
        wgrad["ops_ms"] += 1e3 * fused_mlp.wgrad_flops(cfg, pe_pts, pe_views, N_RAND, S) / PEAK_BF16_FLOPS
        rows_bytes = n_pts * fused_mlp.wgrad_bytes_per_point(cfg) + \
            N_RAND * 2 * (fused_mlp.KV + cfg.width // 2)
        wgrad["bytes_ms"] += 1e3 * (rows_bytes + gbytes) / PEAK_BYTES
        # phase 1's two launches, each its own work and bytes: the recompute
        # its rows and masks and z a point, the rays and the forward blobs;
        # the chain its rows, d_hv, the masks and g a point, the weights and
        # a tile's bias sums (the kernel writes one per 64 points)
        recompute["ops_ms"] += 1e3 * fused_mlp.recompute_flops(
            cfg, pe_pts, pe_views, N_RAND, S) / PEAK_BF16_FLOPS
        fwd_blobs = sum(t.numel() * t.element_size() for t in blobs)
        recompute["bytes_ms"] += 1e3 * (n_pts * fused_mlp.recompute_bytes_per_point(cfg)
                                        + N_RAND * 9 * 4 + fwd_blobs) / PEAK_BYTES
        chain["ops_ms"] += 1e3 * fused_mlp.chain_flops(cfg, pe_pts, pe_views, N_RAND, S) / \
            PEAK_BF16_FLOPS
        chain["bytes_ms"] += 1e3 * (n_pts * fused_mlp.chain_bytes_per_point(cfg) + wbytes
                                    + -(-n_pts // 128) * blobs[1].numel() * 4) / PEAK_BYTES

    split = k4_split(kp, blobs, step, reps=10)
    wgrad["ms"], recompute["ms"] = split["wgrad_bf16"], split["bwd_recompute_sm90"]
    chain["ms"] = split["bwd_chain_sm90"]
    phase("k4_split", per="step (S=64 + S=192)", **{f"{k}_ms": f"{v:.3f}" for k, v in split.items()},
          device_ms=f"{sum(split.values()):.3f}")
    phase("wgrad_launch", kernel="wgrad_bf16 (thread-block clusters, TMA multicast)",
          **{s: f"cluster {v['cluster']}x1x1, grid {v['grid_x']}x{v['grid_y']}, "
                f"{v['problems']} problems" for s, v in launches.items()})
    if any(v["cluster"] < 2 for v in launches.values()):
        raise RuntimeError(f"K4's weight grads launched without a cluster: {launches}")
    for tag, t in (("recompute_times", recompute), ("chain_times", chain), ("wgrad_times", wgrad)):
        bound = max(t["ops_ms"], t["bytes_ms"])
        phase(tag, per="step (S=64 + S=192)", ms=f"{t['ms']:.3f}", bound_ms=f"{bound:.3f}",
              bound_by="operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
              ops_ms=f"{t['ops_ms']:.3f}", bytes_ms=f"{t['bytes_ms']:.3f}",
              library_ms=f"{t['library_ms']:.3f}", x_bound=f"{t['ms'] / bound:.3f}",
              x_library=f"{t['ms'] / t['library_ms']:.3f}")
    return out, recompute, chain


def wgrad_phase() -> None:
    """9b. The weight-grad launch alone (``tools/wgrad_check.py``):
    ``wgrad_bf16`` in thread-block clusters against its plain version (each
    product in f32) within ``wgrad_check.REL_L2`` relative L2 in every
    weight grad (each case's distance from f64 sums beside it), and two
    launches bit for bit, at the main path's 1,048,576 points at W = 256, W
    = 512 and 1024 dense and with a direction per ray, and 8 stacked scenes
    at W = 256 and 512, each with its launch's cluster size and grid. With
    NERF_WGRAD_PARENT naming another checkout's root (the parent, unpacked
    from a git archive), the same cases through that checkout's kernel in
    a process of its own, reported bit-equal or not."""
    from nerf_tpu_torch.tools import wgrad_check

    tmp = tempfile.mkdtemp(prefix="chip_smoke_wgrad_")
    mine = os.path.join(tmp, "change.pt")
    with contextlib.redirect_stdout(io.StringIO()) as out:
        bad = wgrad_check.check(mine)
    rows = [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]
    for r in rows:
        phase("wgrad", **r)
    if bad or len(rows) != len(wgrad_check.CASES):
        raise RuntimeError(f"wgrad_bf16 disagrees with its plain version or with itself in "
                           f"{bad} of {len(wgrad_check.CASES)} cases")
    if any(r["cluster"] < 2 for r in rows):
        raise RuntimeError("a weight-grad case launched without a cluster")
    parent = os.environ.get("NERF_WGRAD_PARENT")
    if parent:
        theirs = os.path.join(tmp, "parent.pt")
        tool = os.path.join(os.path.dirname(os.path.abspath(__file__)), "nerf_tpu_torch", "tools",
                            "wgrad_check.py")
        run = subprocess.run([sys.executable, tool, "check", theirs], capture_output=True,
                             text=True, env={**os.environ, "PYTHONPATH": os.path.abspath(parent)})
        for line in run.stdout.splitlines():
            if line.startswith("{"):
                phase("wgrad_parent_case", **json.loads(line))
        if not os.path.exists(theirs):
            raise RuntimeError(f"the parent's weight-grad check failed: {run.stderr[-2000:]}")
        with contextlib.redirect_stdout(io.StringIO()) as out:
            wgrad_check.compare(mine, theirs)
        phase("wgrad_parent", root=parent, **json.loads(out.getvalue().strip().splitlines()[-1]))
    else:
        phase("wgrad_parent", compared="no parent checkout given (NERF_WGRAD_PARENT)")
    shutil.rmtree(tmp)


def ray_points(rng, R: int, S: int, spr: int, dev):
    """(x [R*S, 3], v [R*S/spr, 3]): points on make_rays' rays, as the
    renderer makes them (PyTorch's multiply, then add), and their view
    directions per ray (spr = S) or per point (spr = 1)."""
    ro, rd, vd, z = make_rays(rng, R, S, dev)
    x = (ro[:, None, :] + rd[:, None, :] * z[..., None]).reshape(R * S, 3)
    return x, (vd if spr > 1 else vd.repeat_interleave(S, 0))


def check_k23(mlp, pe_pts, pe_views, rng, dev):
    """10. K2 and K3 against their plain versions; returns the bf16 max abs
    errors of K2's raw and of K3's weight grads."""
    from nerf_tpu_torch.ops import fused_mlp

    fine = POINTS_SAMPLES + N_IMPORTANCE
    # (R, S, spr): a direction per point (the renderer's mode here) and per
    # ray (fused_query's at S % 8 == 0), full and ragged tiles
    shapes = [(CHECK_RAYS, POINTS_SAMPLES, 1), (RAGGED_RAYS, POINTS_SAMPLES, 1),
              (RAGGED_RAYS, fine, 1), (CHECK_RAYS, N_SAMPLES, N_SAMPLES),
              (RAGGED_RAYS, N_SAMPLES, N_SAMPLES)]
    cases = [(torch.float32, F32_TOL, K4_F32_TOL, K3_INPUT_F32_TOL, shapes),
             (torch.bfloat16, BF16_TOL, K4_BF16_TOL, K3_INPUT_BF16_TOL,
              shapes + [(N_RAND, POINTS_SAMPLES, 1), (N_RAND, fine, 1)])]
    gen = torch.Generator(device=dev).manual_seed(3)
    k2_errs, k3_errs = [], []
    for dtype, tol, wtol, itol, dtype_shapes in cases:
        dname = str(dtype).split(".")[-1]
        with torch.no_grad():
            kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, dtype)
        for R, S, spr in dtype_shapes:
            x, v = ray_points(rng, R, S, spr, dev)
            before = read_counts()
            out = fused_mlp.fused_points(kp, x, v, spr)
            torch.cuda.synchronize()
            ref = fused_mlp.fused_points_reference(kp, x, v, spr)
            err = check_kernel(out.T.reshape(4, R, S), ref.T.reshape(4, R, S), tol, kernel="K2",
                               dtype=dname, R=R, S=S, spr=spr)
            if dtype == torch.bfloat16:
                k2_errs.append(err)
            del out, ref
            g = (0.5 + torch.rand(R * S, 4, device=dev, generator=gen)) * 1e-4
            weights = {}
            for input_grads in (True, False):
                got = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads)
                again = fused_mlp.fused_points_bwd(kp, x, v, g, spr, input_grads)
                torch.cuda.synchronize()
                ref = fused_mlp.fused_points_bwd_reference(kp, x, v, g, spr, input_grads)
                worst, leaf = max((rel_l2(got[0][n], ref[0][n]), n) for n in fused_mlp.KP_NAMES)
                max_abs = max(float((got[0][n] - ref[0][n]).abs().max())
                              for n in fused_mlp.KP_NAMES)
                same = all(torch.equal(got[0][n], again[0][n]) for n in fused_mlp.KP_NAMES)
                finite = all(bool(torch.isfinite(got[0][n]).all()) for n in fused_mlp.KP_NAMES)
                inputs = {}
                if input_grads:
                    for k, name in ((1, "dx"), (2, "dv")):
                        inputs[name] = rel_l2(got[k], ref[k])
                        same = same and torch.equal(got[k], again[k])
                        finite = finite and bool(torch.isfinite(got[k]).all())
                else:
                    finite = finite and got[1] is None and got[2] is None
                weights[input_grads] = got[0]
                phase("grad3", dtype=dname, R=R, S=S, spr=spr, input_grads=input_grads,
                      worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=wtol,
                      max_abs=f"{max_abs:.3e}", bit_identical=same,
                      **{f"{k}_rel_l2": f"{e:.3e}" for k, e in inputs.items()}, input_tol=itol)
                if not (finite and same and worst <= wtol and all(e <= itol for e in inputs.values())):
                    raise RuntimeError(f"K3 disagrees with its plain version or is not "
                                       f"deterministic: {leaf} {worst} {inputs}, same={same}")
                if dtype == torch.bfloat16:
                    k3_errs.append(max_abs)
                del got, again, ref
            # the input-grad branch changes no weight grad
            if not all(torch.equal(weights[True][n], weights[False][n]) for n in fused_mlp.KP_NAMES):
                raise RuntimeError("K3's weight grads depend on input_grads")
            after = read_counts()
            if after["K2"] != before["K2"] + 1 or after["K3"] != before["K3"] + 4:
                raise RuntimeError(f"the K2/K3 launch counters did not move: {before} {after}")
            del weights
            torch.cuda.empty_cache()
    return k2_errs, k3_errs


def k23_times(cfg, pe_pts, pe_views, rays, k2_errs, dev):
    """13. K2 at the serving chunk's shapes (32,768 rays, S=63 and 191, a
    direction per point; checked against its plain version there, the max
    abs errors appended to ``k2_errs``) and at the training step's (4,096
    rays), K3 at the step's without input grads (and once with them), each
    beside its bound, its plain version and the bf16 torch.matmul chain of
    the same products. Returns K2's numbers per chunk and K3's per step."""
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp

    mlp = NeRFMLP(cfg, seed=3, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, pe_pts, pe_views, torch.bfloat16)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    wbytes = sum(t.numel() * t.element_size() for t in kp.values())
    chain_bytes = 2 * sum(kp[n].numel() for n in ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "Wf",
                                                   "Wvf", "W05e", "Wve"))
    gbytes = 4 * sum(v.numel() for v in kp.values())
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    k2, k2_step, k3 = dict(zero), dict(zero), dict(zero)
    gen = torch.Generator(device=dev).manual_seed(4)
    ro, rd, vd = (t[:CHUNK] for t in rays)
    for S in (POINTS_SAMPLES, POINTS_SAMPLES + N_IMPORTANCE):
        z = torch.sort(torch.rand(CHUNK, S, device=dev, generator=gen) * (FAR - NEAR) + NEAR,
                       -1).values
        for R, total in ((CHUNK, k2), (N_RAND, k2_step)):
            x = (ro[:R, None, :] + rd[:R, None, :] * z[:R, :, None]).reshape(R * S, 3)
            v = vd[:R].repeat_interleave(S, 0)
            n_pts = R * S
            with torch.no_grad():
                if R == CHUNK:
                    out = fused_mlp.fused_points(kp, x, v, 1, blobs)
                    ref = fused_mlp.fused_points_reference(kp, x, v, 1)
                    k2_errs.append(check_kernel(out.T.reshape(4, R, S), ref.T.reshape(4, R, S),
                                                BF16_TOL, kernel="K2", dtype="bfloat16", R=R,
                                                S=S, spr=1))
                    del out, ref
                ms = cuda_ms(lambda: fused_mlp.fused_points(kp, x, v, 1, blobs), reps=10, warmup=2)
                plain_ms = cuda_ms(lambda: fused_mlp.fused_points_reference(kp, x, v, 1), reps=2)
            torch.cuda.empty_cache()
            chain = matmul_chain(kp, n_pts)
            library_ms = cuda_ms(chain, reps=5)
            del chain
            torch.cuda.empty_cache()
            ops_ms = 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
            bytes_ms = 1e3 * (n_pts * (12 + 12 + 16) + wbytes) / PEAK_BYTES
            phase("k2_times", R=R, S=S, points=n_pts, ms=f"{ms:.3f}",
                  bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
                  library_ms=f"{library_ms:.3f}", tflops=f"{n_pts * flops_pt / ms / 1e9:.1f}")
            for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                         ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
                total[k] += t
            if R == N_RAND:  # K3 at the step's shape
                g = torch.rand(n_pts, 4, device=dev, generator=gen) * 1e-4
                ms = cuda_ms(lambda: fused_mlp.fused_points_bwd(kp, x, v, g, 1, False, blobs),
                             reps=10, warmup=2)
                ms_in = cuda_ms(lambda: fused_mlp.fused_points_bwd(kp, x, v, g, 1, True, blobs),
                                reps=5, warmup=1)
                plain_ms = cuda_ms(
                    lambda: fused_mlp.fused_points_bwd_reference(kp, x, v, g, 1, False), reps=2)
                torch.cuda.empty_cache()
                chain = backward_matmul_chain(kp, n_pts)
                library_ms = cuda_ms(chain, reps=5)
                del chain
                torch.cuda.empty_cache()
                # a direction per point: dWve sums over points (n_samples=1)
                flops = fused_mlp.bwd_flops(cfg, pe_pts, pe_views, n_pts, 1)
                ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
                bytes_ms = 1e3 * (n_pts * (12 + 12 + 16) + wbytes + chain_bytes + gbytes) / PEAK_BYTES
                phase("k3_times", R=R, S=S, points=n_pts, ms=f"{ms:.3f}",
                      ms_with_input_grads=f"{ms_in:.3f}",
                      bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
                      library_ms=f"{library_ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")
                for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                             ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
                    k3[k] += t
    phase("k2_step", ms=f"{k2_step['ms']:.3f}", bound_ms=f"{max(k2_step['ops_ms'], k2_step['bytes_ms']):.3f}",
          plain_ms=f"{k2_step['plain_ms']:.3f}", library_ms=f"{k2_step['library_ms']:.3f}")
    return k2, k3


def same_bits(a, b) -> bool:
    """a and b hold the same f32 bits (an empty ray's NaN disp included)."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))


def check_maps(out, ref, tol: float, **fields) -> float:
    """Hold K5's maps to its plain version's: rgb, disp (where finite in
    both, the same rays), acc and w; the bound must stay below the rgb
    map's input-dependent spread. Returns the max abs difference."""
    errs = {}
    for name, a, b in zip(("rgb", "disp", "acc", "w"), out, ref):
        f = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), f):
            raise RuntimeError(f"K5's {name} is finite where its plain version's is not")
        errs[name] = float((a[f] - b[f]).abs().max())
    err = max(errs.values())
    spread = float((ref.rgb - ref.rgb.mean(0)).abs().mean(0).min())
    phase("kernel5", **fields, **{f"{k}_max_abs": f"{v:.3e}" for k, v in errs.items()}, tol=tol,
          rgb_spread=f"{spread:.3e}")
    if not err <= tol:
        raise RuntimeError(f"K5 disagrees with its plain version: {errs} > {tol}")
    if not tol < spread:
        raise RuntimeError(f"bound {tol} is not below the rgb map's spread {spread}")
    return err


@torch.no_grad()
def check_k56(mlp, pe_pts, pe_views, rng, dev):
    """14. K5 and K6 against their plain versions; returns the bf16 max abs
    errors of K5's maps and of K6's weight grads, and the max abs errors of
    K6's compositing pass (both dtypes)."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp

    shapes = [(R, S) for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE, 200)
              for R in (CHECK_RAYS, RAGGED_RAYS)]
    gen = torch.Generator(device=dev).manual_seed(5)
    k5_errs, k6_errs, composite_errs = [], [], []
    halves = {"float32": [], "bfloat16": []}  # (K6 worst leaf, raw cotangent, K4's phases)
    k1_vs_k5 = {"float32": [], "bfloat16": []}  # (equal, max abs, share of elements differing)
    for dtype, tol, wtol in ((torch.float32, F32_TOL, K4_F32_TOL),
                             (torch.bfloat16, BF16_TOL, K4_BF16_TOL)):
        dname = str(dtype).split(".")[-1]
        kp = fused_mlp.pack_params(mlp, pe_pts, pe_views, dtype)
        for R, S in shapes:
            rays = make_rays(rng, R, S, dev)
            noise = torch.randn(R, S, device=dev, generator=gen) * 0.5
            for white in (True, False):
                before = read_counts()
                out = fused_render.fused_render_fwd(kp, *rays, noise, white, keep_raw=True)
                torch.cuda.synchronize()
                ref = fused_render.fused_render_reference(kp, *rays, noise, white)
                err = check_maps(out, ref, tol, dtype=dname, R=R, S=S, white=white)
                # a second launch, and a serving one (no raw planes: the bf16
                # kernel's slab): the same outputs bit for bit
                again = fused_render.fused_render_fwd(kp, *rays, noise, white, keep_raw=True)
                served = fused_render.fused_render_fwd(kp, *rays, noise, white)
                k5_same = (all(same_bits(a, b) for a, b in zip(again, out))
                           and all(same_bits(a, b) for a, b in zip(served[:4], out[:4])))
                del again, served
                # K1's raw against K5's: one tile body in both dtypes (a gate)
                k1_raw = fused_mlp.fused_rays_planes(kp, *rays)
                same_raw = torch.equal(out.raw, k1_raw)
                raw_diff = (out.raw - k1_raw).abs()
                k1_vs_k5[dname].append((same_raw, float(raw_diff.max()),
                                        float((raw_diff > 0).float().mean())))
                del k1_raw, raw_diff
                # the cotangents of an image loss and its companions: one-signed
                g = [(0.5 + torch.rand(*shape, device=dev, generator=gen)) * 1e-4
                     for shape in ((R, 3), (R,), (R,), (R, S))]
                got = fused_render.fused_render_bwd(kp, *rays, noise, out.raw, *g, white)
                again = fused_render.fused_render_bwd(kp, *rays, noise, out.raw, *g, white)
                torch.cuda.synchronize()
                gref = fused_render.fused_render_bwd_reference(kp, *rays, noise, out.raw, *g,
                                                               white)
                worst, leaf = max((rel_l2(got[n], gref[n]), n) for n in fused_mlp.KP_NAMES)
                # K6's halves apart (ROADMAP C.2), no launch counted: the
                # compositing backward's cotangent of raw against its plain
                # version, both f32; K4's phases on the plain cotangent
                # against the plain weight grads of that cotangent
                planes = fused_render._launch_composite_bwd(out.raw, rays[1], rays[3], noise, *g,
                                                            white)
                planes_same = same_bits(planes, fused_render._launch_composite_bwd(
                    out.raw, rays[1], rays[3], noise, *g, white))
                want = fused_render.composite_bwd_reference(out.raw, rays[1], rays[3], noise, *g,
                                                            white)
                half = fused_mlp._launch_bwd(kp, *rays, want, None)
                half_ref = fused_mlp.fused_rays_planes_bwd_reference(kp, *rays, want)
                planes_err = rel_l2(planes, want)
                planes_max_abs = float((planes - want).abs().max())
                half_worst, half_leaf = max((rel_l2(half[n], half_ref[n]), n)
                                            for n in fused_mlp.KP_NAMES)
                halves[dname].append((worst, planes_err, half_worst))
                max_abs = max(float((got[n] - gref[n]).abs().max()) for n in fused_mlp.KP_NAMES)
                same = all(torch.equal(got[n], again[n]) for n in fused_mlp.KP_NAMES)
                finite = all(bool(torch.isfinite(got[n]).all()) for n in fused_mlp.KP_NAMES)
                phase("grad6", dtype=dname, R=R, S=S, white=white,
                      worst_leaf_rel_l2=f"{worst:.3e}", leaf=leaf, tol=wtol,
                      max_abs=f"{max_abs:.3e}", bit_identical=same, raw_is_k1=same_raw,
                      k5_bit_identical=k5_same,
                      k1_vs_k5_raw_max_abs=f"{k1_vs_k5[dname][-1][1]:.3e}",
                      k1_vs_k5_raw_share_differing=f"{k1_vs_k5[dname][-1][2]:.4f}",
                      raw_cotangent_rel_l2=f"{planes_err:.3e}",
                      raw_cotangent_max_abs=f"{planes_max_abs:.3e}",
                      raw_cotangent_bit_identical=planes_same,
                      k4_phases_on_plain_cotangent_rel_l2=f"{half_worst:.3e}",
                      k4_phases_leaf=half_leaf)
                if not (finite and same and same_raw and k5_same and planes_same
                        and worst <= wtol and half_worst <= wtol
                        and planes_err <= COMPOSITE_F32_TOL):
                    raise RuntimeError(f"K6 or one of its halves disagrees with its plain "
                                       f"version, or K5 or K6 is not deterministic, or K5's raw "
                                       f"is not K1's: {leaf} {worst}, raw cotangent "
                                       f"{planes_err} (same={planes_same}), K4's phases "
                                       f"{half_worst}, same={same}, k5_same={k5_same}, "
                                       f"raw={same_raw}")
                after = read_counts()
                moved = {k: after[k] - before[k] for k in after}
                # bf16: K6's two backwards and its halves' K4 phases each
                # launch the recompute and the chain; K6's two backwards and
                # the halves' two launch the compositing pass
                recomputes = 3 if dtype == torch.bfloat16 else 0
                want = {"K1": 1, "K5": 3, "K6": 2, "recompute": recomputes,
                        "chain": recomputes, "composite": 4}
                if moved != {k: want.get(k, 0) for k in moved}:
                    raise RuntimeError(f"the K5/K6 launch counters moved wrongly: {moved}")
                if dtype == torch.bfloat16:
                    k5_errs.append(err)
                    k6_errs.append(max_abs)
                composite_errs.append(planes_max_abs)
                del out, ref, got, again, gref, planes, want, half, half_ref
            torch.cuda.empty_cache()
    for dname, rows in halves.items():  # the largest of each over the cases
        k6, planes, k4 = (max(col) for col in zip(*rows))
        phase("k6_halves", dtype=dname, k6_worst_leaf_rel_l2=f"{k6:.3e}",
              raw_cotangent_rel_l2=f"{planes:.3e}", k4_phases_on_plain_cotangent_rel_l2=f"{k4:.3e}")
        equal, diff, share = zip(*k1_vs_k5[dname])
        phase("k1_vs_k5_raw", dtype=dname, cases=len(equal), all_equal=all(equal),
              max_abs=f"{max(diff):.3e}", largest_share_differing=f"{max(share):.4f}",
              mean_share_differing=f"{sum(share) / len(share):.4f}")
        if not all(equal):
            raise RuntimeError(f"K5's {dname} raw is not K1's")
    return k5_errs, k6_errs, composite_errs


def k56_times(cfg, pe_pts, pe_views, rays, dev):
    """17. K5 at the serving chunk's shapes (32,768 rays of frame 0, S=64 and
    192, no noise, no raw kept) and K6 at the training step's (4,096 rays,
    with noise, from K5's raw), each beside its bound, its plain version and
    the bf16 torch.matmul chain of the same products; and K6's compositing
    pass alone beside its byte bound and plain version. Returns K5's numbers
    per chunk, K6's and the pass's per step."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.utils.profiler import launch_split

    mlp = NeRFMLP(cfg, seed=6, device=dev)
    kp, blobs = fused_mlp.packed_params(mlp, pe_pts, pe_views, torch.bfloat16)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    wbytes = sum(t.numel() * t.element_size() for t in kp.values())
    chain_bytes = 2 * sum(kp[n].numel() for n in ("W1", "W2", "W3", "W4", "W5", "W6", "W7", "Wf",
                                                   "Wvf"))
    gbytes = 4 * sum(v.numel() for v in kp.values())
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    k5, k6, comp = dict(zero), dict(zero), dict(zero)
    k1_ms = 0.0  # K1 on K5's inputs, beside it: what the compositing costs
    gen = torch.Generator(device=dev).manual_seed(6)
    ro, rd, vd = (t[:CHUNK] for t in rays)
    for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):
        z = torch.sort(torch.rand(CHUNK, S, device=dev, generator=gen) * (FAR - NEAR) + NEAR,
                       -1).values
        args = (ro, rd, vd, z, None, True)
        n_pts = CHUNK * S
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_render.fused_render_fwd(kp, *args, blobs), reps=10, warmup=2)
            k1 = cuda_ms(lambda: fused_mlp.fused_rays_planes(kp, ro, rd, vd, z, blobs), reps=10,
                         warmup=2)
            plain_ms = cuda_ms(lambda: fused_render.fused_render_reference(kp, *args), reps=2)
        torch.cuda.empty_cache()
        chain = matmul_chain(kp, n_pts)
        library_ms = cuda_ms(chain, reps=5)
        del chain
        torch.cuda.empty_cache()
        # rays and z in; rgb, disp, acc and w out
        io_bytes = CHUNK * 9 * 4 + n_pts * 4 + CHUNK * 5 * 4 + n_pts * 4 + wbytes
        ops_ms = 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * io_bytes / PEAK_BYTES
        phase("k5_times", R=CHUNK, S=S, points=n_pts, ms=f"{ms:.3f}", k1_ms=f"{k1:.3f}",
              bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
              library_ms=f"{library_ms:.3f}", tflops=f"{n_pts * flops_pt / ms / 1e9:.1f}")
        k1_ms += k1
        for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
            k5[k] += t
        # K6 at the step's shape: 4,096 rays with noise, from K5's raw
        R = N_RAND
        step = (ro[:R], rd[:R], vd[:R], z[:R])
        noise = torch.randn(R, S, device=dev, generator=gen)
        raw = fused_render.fused_render_fwd(kp, *step, noise, True, blobs, keep_raw=True).raw
        g = [torch.rand(*shape, device=dev, generator=gen) * 1e-4
             for shape in ((R, 3), (R,), (R,), (R, S))]
        n_pts = R * S
        ms = cuda_ms(lambda: fused_render.fused_render_bwd(kp, *step, noise, raw, *g, True, blobs),
                     reps=10, warmup=2)
        plain_ms = cuda_ms(
            lambda: fused_render.fused_render_bwd_reference(kp, *step, noise, raw, *g, True), reps=2)
        torch.cuda.empty_cache()
        chain = backward_matmul_chain(kp, n_pts)
        library_ms = cuda_ms(chain, reps=5)
        del chain
        torch.cuda.empty_cache()
        flops = fused_mlp.bwd_flops(cfg, pe_pts, pe_views, R, S)
        # rays, z, noise, raw and g_w in per point, g_rgb/disp/acc per ray, the
        # weights (and their [in, out] copy) in, the grads out
        io_bytes = (R * 9 * 4 + n_pts * (4 + 4 + 16 + 4) + R * 5 * 4 + wbytes + chain_bytes
                    + gbytes)
        ops_ms = 1e3 * flops / PEAK_BF16_FLOPS
        bytes_ms = 1e3 * io_bytes / PEAK_BYTES
        phase("k6_times", R=R, S=S, points=n_pts, ms=f"{ms:.3f}",
              bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
              library_ms=f"{library_ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")
        for k, t in (("ms", ms), ("plain_ms", plain_ms), ("ops_ms", ops_ms),
                     ("bytes_ms", bytes_ms), ("library_ms", library_ms)):
            k6[k] += t
        # K6's compositing pass alone: raw, z, noise and g_w in and g out a
        # point, rays_d and g_rgb/disp/acc a ray; no one PyTorch call
        # computes it. Its ms is the profiler's device time: a launch takes
        # ~10-20 us, less than the wrapper's host time, so CUDA events
        # around back-to-back calls (events_ms) time the host
        cargs = (raw, step[1], step[3], noise, *g, True)
        ms = launch_split(lambda: fused_render._launch_composite_bwd(*cargs), ("composite_bwd",),
                          reps=20, warmup=2)["composite_bwd"]
        events_ms = cuda_ms(lambda: fused_render._launch_composite_bwd(*cargs), reps=20, warmup=2)
        plain_ms = cuda_ms(lambda: fused_render.composite_bwd_reference(*cargs), reps=2)
        bytes_ms = 1e3 * (n_pts * (16 + 4 + 4 + 4 + 16) + R * (12 + 12 + 4 + 4)) / PEAK_BYTES
        phase("composite_times", R=R, S=S, points=n_pts, ms=f"{ms:.4f}",
              events_ms=f"{events_ms:.4f}", bound_ms=f"{bytes_ms:.4f}",
              plain_ms=f"{plain_ms:.3f}")
        for k, t in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", bytes_ms)):
            comp[k] += t
        del raw, g
        torch.cuda.empty_cache()
    phase("k5_vs_k1", per="32,768-ray chunk (S=64 + S=192)", k5_ms=f"{k5['ms']:.3f}",
          k1_ms=f"{k1_ms:.3f}", k5_minus_k1_ms=f"{k5['ms'] - k1_ms:.3f}",
          k5_over_k1=f"{k5['ms'] / k1_ms:.4f}", library_ms=f"{k5['library_ms']:.3f}")
    comp["library_ms"] = None
    phase("composite_per_step", ms=f"{comp['ms']:.4f}", bound_ms=f"{comp['bytes_ms']:.4f}",
          plain_ms=f"{comp['plain_ms']:.3f}")
    return k5, k6, comp


def probe_phase(dev):
    """18. K7's bodies against their plain versions (one launch each), and
    ``full`` (K1's tile) against K2 on the same blob, bit for bit; then the
    probe tool at the script's size, and full's products as bf16
    torch.matmul. Returns the tool's rows by body and its launch counts, in
    all and by body."""
    from nerf_tpu_torch.tools import probe_overlap as P

    inp = P.make_inputs(npts=PROBE_CHECK_POINTS, seed=1).to(dev)
    for body in P.BODIES:
        before = P.probe.launches
        out = P.probe(body, inp)
        torch.cuda.synchronize()
        if P.probe.launches != before + 1:
            raise RuntimeError("the K7 launch counter did not move by one")
        ref = P.probe_reference(body, inp)
        live = ref[:, :4] if body == "full" else ref  # full's channels 4.. are zeros
        tol = PROBE_TOL_REL * float(live.abs().max())
        err = float((out - ref).abs().max())
        spread = float((live - live.mean(0)).abs().mean())
        phase("probe", body=body, points=PROBE_CHECK_POINTS, max_abs=f"{err:.3e}",
              tol=f"{tol:.3e}", rel=f"{err / float(live.abs().max()):.3e}", spread=f"{spread:.3e}")
        if not bool(torch.isfinite(out).all()) or not err <= tol:
            raise RuntimeError(f"K7 {body} disagrees with its plain version: {err} > {tol}")
        if not tol < spread:
            raise RuntimeError(f"K7 {body}: bound {tol} is not below the spread {spread}")
        if body == "full":  # the gate: K7 times the production tile
            k2 = P.k2_raw(inp)
            full_is_k2 = torch.equal(out[:, :4], k2)
            phase("probe_full_vs_k2", points=PROBE_CHECK_POINTS, equal=full_is_k2,
                  max_abs=f"{float((out[:, :4] - k2).abs().max()):.3e}",
                  channels_4_on_zero=not bool(out[:, 4:].any()))
            if not full_is_k2 or bool(out[:, 4:].any()):
                raise RuntimeError("K7's full is not K2's raw bit for bit, or not zero past it")
        del out, ref
    torch.cuda.empty_cache()
    reset_counts()
    rows = P.main(device=dev)
    counts = read_counts()
    check_counts(counts, {"K7": len(P.BODIES) * (1 + P.REPS)}, "the probe tool")
    by_body = {r["body"]: r for r in rows}
    for r in rows:
        tol = PROBE_TOL_REL * r["plain_max_abs"]
        if not r["max_abs_err"] <= tol:
            raise RuntimeError(f"K7 {r['body']} at {P.NPTS} points: {r['max_abs_err']} > {tol}")
    bare = by_body["matmul_only"]["ms"]
    phase("probe_times", points=P.NPTS, launches=counts["K7"],
          **{f"{b}_ms": f"{r['ms']:.3f}" for b, r in by_body.items()},
          **{f"{b}_vs_matmul_only": f"{r['ms'] / bare:.4f}" for b, r in by_body.items()},
          matmul_chain_ms=f"{by_body['matmul_only']['library_ms']:.3f}")
    # what ping-pong buys on K1's tile: the same work in lockstep over it
    phase("probe_lockstep_over_ping_pong",
          **{f"{a}/{b}": f"{by_body[a]['ms'] / by_body[b]['ms']:.4f}"
             for a, b in P.LOCKSTEP_OVER_PING_PONG})
    # full is K2's tile plus the zero rows: K2 on the same inputs beside it
    # (after the tool's counts) says what writing the rows costs
    big = P.make_inputs().to(dev)
    P.k2_raw(big)
    k2_ms = cuda_ms(lambda: P.k2_raw(big), reps=P.REPS)
    # full's library time: its 10 large products (the embedding's, the
    # trunk's, the feature's and the view layer's) as bf16 torch.matmul at
    # the tool's points, phase 5's chain for K1
    chain = matmul_chain(big.kernel_params, P.NPTS)
    by_body["full"]["library_ms"] = cuda_ms(chain, reps=P.REPS)
    phase("probe_full_vs_k2_time", points=P.NPTS, full_ms=f"{by_body['full']['ms']:.3f}",
          k2_ms=f"{k2_ms:.3f}", rows_ms=f"{by_body['full']['ms'] - k2_ms:.3f}",
          full_library_ms=f"{by_body['full']['library_ms']:.3f}")
    del big, chain
    torch.cuda.empty_cache()
    return {"launches": counts["K7"], "by_body": dict(P.probe.by_body), **by_body}


class Tee:
    """Copies what is written to it into the real stdout and a buffer."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, text):
        self.parts.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()

    def text(self) -> str:
        return "".join(self.parts)


def run_cli(fn, argv):
    """fn(argv) on the card (no device argument: the entry point's default),
    its stdout shown and returned."""
    tee = Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        result = fn(argv)
    torch.cuda.synchronize()
    return result, tee.text()


def write_blender_scene(views, datadir: str) -> None:
    """Phase 7's 400x400 teacher views as an 800x800 RGBA blender scene:
    each pixel repeated 2x2 (so half_res's 2x2 mean gives the 8-bit view
    back), alpha 1, views 0-5 train, 6 val, 7 test, the lego camera angle."""
    from nerf_tpu_torch.utils.io import write_png
    from nerf_tpu_torch.utils.metrics import to8b

    splits = {"train": range(0, 6), "val": range(6, 7), "test": range(7, 8)}
    for split, ids in splits.items():
        os.makedirs(os.path.join(datadir, split), exist_ok=True)
        frames = []
        for k, v in enumerate(ids):
            rgb = to8b(views.images[v]).repeat(2, 0).repeat(2, 1)
            rgba = np.concatenate([rgb, np.full(rgb.shape[:2] + (1,), 255, np.uint8)], -1)
            write_png(os.path.join(datadir, split, f"r_{k}.png"), rgba)
            pose = np.concatenate([views.poses[v], [[0.0, 0.0, 0.0, 1.0]]], 0)
            frames.append({"file_path": f"./{split}/r_{k}", "transform_matrix": pose.tolist()})
        with open(os.path.join(datadir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": LEGO_CAMERA_ANGLE_X, "frames": frames}, f)


def cli_argv(root: str, n_iters: int, trace: bool):
    here = os.path.dirname(os.path.abspath(__file__))
    return [f"--config={os.path.join(here, 'configs', 'lego.txt')}",
            f"--datadir={os.path.join(root, 'lego')}", f"--basedir={os.path.join(root, 'logs')}",
            "--expname=cli", f"--N_rand={N_RAND}", f"--n_iters={n_iters}", "--data_axis=1",
            f"--trace={trace}"] + [f"--{k}={v}" for k, v in CLI_CADENCES.items()]


def cli_train_phase(views):
    """19. ``cli.train.main`` on a blender scene written from phase 7's
    teacher views, every cadence and the trace firing."""
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.data.blender import load_blender_scene
    from nerf_tpu_torch.utils.io import read_png

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    t0 = time.perf_counter()
    write_blender_scene(views, os.path.join(root, "lego"))
    scene = load_blender_scene(os.path.join(root, "lego"), half_res=True, testskip=8,
                               white_bkgd=True)
    scene_err = float(np.abs(scene.images - views.images).max())
    if scene.images.shape != (8, H, W, 3) or not scene_err <= 1.0 / 255:
        raise RuntimeError(f"the written scene does not load back: {scene.images.shape}, {scene_err}")
    if abs(scene.focal - FOCAL) > 1e-2:
        raise RuntimeError(f"focal {scene.focal}, the teacher's {FOCAL}")
    write_s = time.perf_counter() - t0

    reset_counts()
    t0 = time.perf_counter()
    result, out = run_cli(cli_train.main, cli_argv(root, CLI_STEPS, trace=True))
    seconds = time.perf_counter() - t0
    counts = read_counts()
    expdir = os.path.join(root, "logs", "cli")
    steps = CLI_STEPS + TRACE_STEPS
    c = CLI_CADENCES
    frames = (CLI_STEPS // c["i_img"]) + (CLI_STEPS // c["i_testset"]) * 1 + (
        CLI_STEPS // c["i_video"]) * 40
    n_chunks = -(-H * W // CHUNK)
    check_counts(counts, {"K1": 2 * steps + 2 * n_chunks * frames, "K4": 2 * steps,
                          "recompute": 2 * steps, "chain": 2 * steps},
                 f"cli.train: {steps} steps and {frames} eval frames")
    evals = [float(m) for m in re.findall(r"\[EVAL\] Iter: \d+ holdout view 6 PSNR: (\S+)", out)]
    if len(evals) != CLI_STEPS // c["i_img"] or not np.isfinite(evals).all():
        raise RuntimeError(f"expected {CLI_STEPS // c['i_img']} holdout evals, got {evals}")
    # a .tar at each i_weights event, named by state.step: 4 ahead after the trace
    want_tars = [f"{i + (TRACE_STEPS if i >= TRACE_AT else 0):06d}.tar"
                 for i in range(c["i_weights"], CLI_STEPS + 1, c["i_weights"])]
    tars = sorted(f for f in os.listdir(expdir) if f.endswith(".tar"))
    if tars != want_tars or result.state.step != steps:
        raise RuntimeError(f"checkpoints {tars} (want {want_tars}), step {result.state.step}")
    test_png = read_png(os.path.join(expdir, f"testset_{CLI_STEPS:06d}", "000.png"))
    spiral = [f for f in os.listdir(expdir) if f.startswith(f"cli_spiral_{CLI_STEPS:06d}_rgb")]
    n_spiral = (40 if spiral and spiral[0].endswith(".mp4") else
                len(os.listdir(os.path.join(expdir, spiral[0]))) if spiral else 0)
    if test_png.shape != (H, W, 3) or n_spiral != 40:
        raise RuntimeError(f"test PNG {test_png.shape}, spiral {spiral} with {n_spiral} frames")
    with open(os.path.join(expdir, "trace", "trace.json")) as f:
        trace_text = f.read()
    trace_kernels = {k: trace_text.count(k) for k in TRACE_KERNELS}
    if not all(trace_kernels.values()):
        raise RuntimeError(f"trace.json names no K1/K4 kernel: {trace_kernels}")
    losses = [h[1] for h in result.history]
    phase("cli_train", steps=steps, seconds=f"{seconds:.2f}", scene_write_load_s=f"{write_s:.2f}",
          scene_vs_views_max_abs=f"{scene_err:.2e}", launches=counts, eval_frames=frames,
          holdout_psnr=[f"{p:.3f}" for p in evals], tars=tars,
          spiral=f"{spiral[0]} ({n_spiral} frames)", trace_bytes=len(trace_text),
          trace_kernel_events=trace_kernels, loss_first=f"{losses[0]:.6f}",
          loss_last=f"{losses[-1]:.6f}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"the loss is not finite and falling: {losses}")
    return {"root": root, "expdir": expdir, "state": result.state}


def resume_render_phase(cli, dev):
    """20. The newest .tar holds phase 19's final state; ``cli.train.main``
    resumes from it (step and learning rate); ``cli.render.main
    --render_test`` renders the test view from the .tar that run saved."""
    from nerf_tpu_torch.cli import render as cli_render
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.train.loop import TrainResult
    from nerf_tpu_torch.train.step import lr_schedule
    from nerf_tpu_torch.utils import checkpoint
    from nerf_tpu_torch.utils.io import read_png

    root, expdir, trained = cli["root"], cli["expdir"], cli["state"]
    start = trained.step
    argv = cli_argv(root, start + CLI_RESUMED_STEPS, trace=False)
    cfg = load_config(argv)
    newest = checkpoint.find_checkpoints(cfg.basedir, cfg.expname)[-1]
    saved = checkpoint.load_checkpoint(newest, make_model(cfg), cfg.lrate, device=dev)
    same = saved.step == start and all(
        torch.equal(a, b) for lvl in ("coarse", "fine")
        for a, b in zip(saved.nets[lvl].parameters(), trained.nets[lvl].parameters()))
    same = same and all(
        torch.equal(saved.optimizer.state[a][k], trained.optimizer.state[b][k])
        for lvl in ("coarse", "fine")
        for a, b in zip(saved.nets[lvl].parameters(), trained.nets[lvl].parameters())
        for k in ("exp_avg", "exp_avg_sq"))
    if not same:
        raise RuntimeError(f"{newest} does not hold the trained state")
    reset_counts()
    result, _ = run_cli(cli_train.main, argv)
    resumed_counts = read_counts()
    # the schedule carried on from the step: the last update used lr(step - 1)
    # (the optimizer holds it as a float32 tensor, train/step.py::set_lr)
    last_lr = float(result.state.optimizer.param_groups[0]["lr"])
    want_lr = float(np.float32(lr_schedule(cfg.lrate, cfg.lrate_decay)(
        start + CLI_RESUMED_STEPS - 1)))
    first_print = result.history[0][0] if result.history else None
    every = CLI_CADENCES["i_print"]
    if result.state.step != start + CLI_RESUMED_STEPS or last_lr != want_lr or \
            first_print != (start // every + 1) * every:
        raise RuntimeError(f"the resumed run did not carry on from {newest}: step "
                           f"{result.state.step}, lr {last_lr} (want {want_lr}), first "
                           f"print at {first_print}")
    n_chunks = -(-H * W // CHUNK)
    evals = sum(1 for i in range(start + 1, start + CLI_RESUMED_STEPS + 1)
                if i % CLI_CADENCES["i_img"] == 0)
    check_counts(resumed_counts, {"K1": 2 * CLI_RESUMED_STEPS + 2 * n_chunks * evals,
                                  "K4": 2 * CLI_RESUMED_STEPS,
                                  "recompute": 2 * CLI_RESUMED_STEPS,
                                  "chain": 2 * CLI_RESUMED_STEPS}, "the resumed run")

    reset_counts()
    rendered, out = run_cli(cli_render.main, argv + ["--render_test"])
    render_counts = read_counts()
    check_counts(render_counts, {"K1": 2 * n_chunks}, "cli.render --render_test")
    psnr = [float(m) for m in re.findall(r"\[EVAL\] mean PSNR over 1 views: (\S+)", out)]
    savedir = os.path.join(expdir, f"renderonly_test_{rendered.state.step:06d}")
    png = read_png(os.path.join(savedir, "000.png"))
    video = sorted(f for f in os.listdir(savedir) if f.startswith("video"))
    phase("resume_render", newest=os.path.basename(newest), resumed_from=start,
          first_print=first_print, last_lr=f"{last_lr:.6e}", resumed_launches=resumed_counts,
          render_step=rendered.state.step, render_launches=render_counts,
          test_psnr=psnr, png=png.shape, video=video)
    if not (isinstance(rendered, TrainResult) and rendered.state.step == start + CLI_RESUMED_STEPS
            and len(psnr) == 1 and np.isfinite(psnr[0]) and png.shape == (H, W, 3) and video):
        raise RuntimeError("cli.render did not render the test view from the newest .tar")
    shutil.rmtree(root)


@contextlib.contextmanager
def spy(module, name: str, calls: list):
    """While inside, record (args, kwargs, result) of each call of
    ``module.name``: what the path passed and got, seen from outside."""
    fn = getattr(module, name)

    def record(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, fn)


@contextlib.contextmanager
def graph_calls():
    """While inside, count CUDA graph captures and replays (train()'s fused
    loop, train/graph.py): a chunk's k steps run their Python once, at the
    graph's capture, after one warm-up step that is undone; each replay runs
    them again without it."""
    record = {"captures": 0, "replays": 0}
    begin, replay = torch.cuda.CUDAGraph.capture_begin, torch.cuda.CUDAGraph.replay

    def counted_begin(graph, *args, **kwargs):
        record["captures"] += 1
        return begin(graph, *args, **kwargs)

    def counted_replay(graph):
        record["replays"] += 1
        return replay(graph)

    torch.cuda.CUDAGraph.capture_begin = counted_begin
    torch.cuda.CUDAGraph.replay = counted_replay
    try:
        yield record
    finally:
        torch.cuda.CUDAGraph.capture_begin = begin
        torch.cuda.CUDAGraph.replay = replay


def quiet(fn, *args, **kwargs):
    """fn's result, its stdout (a scene writer's line a view) dropped."""
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def synth_phase(root: str, dev) -> str:
    """21. The analytic field's render on the card against the CPU's, both
    fields, and in chunks; then the synthff scene written by the port's
    writer at the tool's 756x1008, backdrop on. Returns its directory."""
    from nerf_tpu_torch.data import synth
    from nerf_tpu_torch.tools import make_llff_benchmark_scene as tool

    rng = np.random.default_rng(21)
    ro = np.array([0.0, 0.0, 4.0]) + rng.uniform(-0.4, 0.4, (SYNTH_RAYS, 3))
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (SYNTH_RAYS, 2)), -np.ones((SYNTH_RAYS, 1))], -1)
    ro, rd = (torch.as_tensor(a, dtype=torch.float32) for a in (ro, rd))
    errs, spreads, chunks_equal = [], [], True
    with torch.no_grad():
        for backdrop in (False, True):
            fp = synth.make_field(0, backdrop=backdrop)
            cpu = synth.render_gt_rays(fp, ro, rd, 2.0, 6.0, SYNTH_SAMPLES)
            ro_d, rd_d = ro.to(dev), rd.to(dev)
            card = synth.render_gt_rays(fp, ro_d, rd_d, 2.0, 6.0, SYNTH_SAMPLES)
            parts = torch.cat([synth.render_gt_rays(fp, ro_d[i : i + SYNTH_CHUNK],
                                                    rd_d[i : i + SYNTH_CHUNK], 2.0, 6.0,
                                                    SYNTH_SAMPLES)
                               for i in range(0, SYNTH_RAYS, SYNTH_CHUNK)])
            chunks_equal = chunks_equal and torch.equal(parts, card)
            errs.append(float((card.cpu() - cpu).abs().max()))
            spreads.append(float(cpu.std()))
    datadir = os.path.join(root, "synthff")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quiet(tool.write_scene, datadir, n_views=SYNTHFF_VIEWS, device=dev)
    seconds = time.perf_counter() - t0
    phase("synth", rays=SYNTH_RAYS, samples=SYNTH_SAMPLES,
          card_vs_cpu_max_abs=[f"{e:.3e}" for e in errs], tol=SYNTH_TOL,
          std=[f"{v:.3f}" for v in spreads], chunks_bit_equal=chunks_equal,
          views=f"{SYNTHFF_VIEWS} of the tool's {tool.N_VIEWS} (cut for time)", resolution=f"{tool.H}x{tool.W}",
          s_per_view=f"{seconds / SYNTHFF_VIEWS:.3f}")
    if not (max(errs) <= SYNTH_TOL and chunks_equal and min(spreads) > 0.05):
        raise RuntimeError(f"the field's render on the card: errors {errs}, chunks equal "
                           f"{chunks_equal}, spreads {spreads}")
    return datadir


def format_argv(root: str, config: str, datadir: str, expname: str, n_iters: int, cadences):
    here = os.path.dirname(os.path.abspath(__file__))
    return [f"--config={os.path.join(here, 'configs', config)}", f"--datadir={datadir}",
            f"--basedir={os.path.join(root, 'logs')}", f"--expname={expname}",
            f"--n_iters={n_iters}", "--data_axis=1"] + [f"--{k}={v}" for k, v in cadences.items()]


def check_loss_falls(history, what: str) -> list:
    """The printed losses: finite, the mean of the last two below the
    first two's (one batch's loss is noisy)."""
    losses = [h[1] for h in history]
    if not (len(losses) >= 4 and np.isfinite(losses).all() and
            np.mean(losses[-2:]) < np.mean(losses[:2])):
        raise RuntimeError(f"{what}: the loss is not finite and falling: {losses}")
    return losses


def timed_format_run(root: str, config: str, datadir: str, scene, dev, path: str):
    """phase 7's timed and profiled windows on a loaded scene, its config's
    recipe (cadences off)."""
    from nerf_tpu_torch.config import load_config

    n_iters = WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    off = {"i_print": 10, "i_img": 0, "i_weights": 0, "i_testset": 0, "i_video": 0}
    cfg = load_config(format_argv(root, config, datadir, f"{path}_timed", n_iters, off))
    return timed_train(cfg, scene, dev, "K1", "K4", path=path)


def cli_llff_phase(root: str, datadir: str, dev) -> None:
    """22. ``cli.train.main`` with configs/synthff.txt on phase 21's scene:
    _minify's images_2/ through the native Lanczos, NDC rays, the batching
    sampler and the sigma noise, 2 K1 + 2 K4 a step and 12 K1 a frame,
    every cadence (the 120-frame spiral among them), a falling loss and a
    finite holdout PSNR; an NDC frame and an NDC batch's grads against the
    plain path; then the recipe's timed and profiled windows."""
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.data import llff
    from nerf_tpu_torch.data.rays_dataset import BatchedRaySampler
    from nerf_tpu_torch.geom.rays import ndc_rays
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.train import loop
    from nerf_tpu_torch.train import step as step_lib
    from nerf_tpu_torch.utils.io import read_png

    t0 = time.perf_counter()
    imgdir = llff._minify(datadir, 2)
    minify_s = time.perf_counter() - t0
    names = sorted(os.listdir(imgdir))
    small = read_png(os.path.join(imgdir, names[0]))
    want = llff.minify_downsample(read_png(os.path.join(datadir, "images", names[0])), 2)
    want = np.clip(np.round(want), 0, 255).astype(np.uint8)
    if len(names) != SYNTHFF_VIEWS or small.shape != LLFF_MINIFIED + (3,) or \
            not np.array_equal(small, want):
        raise RuntimeError(f"images_2/: {len(names)} views of {small.shape}, equal to the "
                           f"native Lanczos: {np.array_equal(small, want)}")

    argv = format_argv(root, "synthff.txt", datadir, "llff", LLFF_STEPS, LLFF_CADENCES)
    cfg = load_config(argv)
    t0 = time.perf_counter()
    scene = loop.load_scene(cfg)
    load_s = time.perf_counter() - t0
    samplers, ndc, draws = [], [], []
    reset_counts()
    t0 = time.perf_counter()
    with spy(loop, "make_sampler", samplers), spy(step_lib, "ndc_rays", ndc), \
            spy(step_lib, "draw_overrides", draws), graph_calls() as graphs:
        result, out = run_cli(cli_train.main, argv)
    seconds = time.perf_counter() - t0
    counts = read_counts()

    steps, c = LLFF_STEPS, LLFF_CADENCES
    # the step's Python runs once a step one by one, and at a graph's
    # warm-up and capture (k + 1) for the k steps each replay runs again
    k = min(cfg.fuse_steps, *(v for v in c.values() if v > 0))
    calls = steps - k * graphs["replays"] + (k + 1) * graphs["captures"]
    n_chunks = -(-scene.H * scene.W // CHUNK)
    frames = steps // c["i_img"] + steps // c["i_testset"] * len(scene.i_test) + \
        steps // c["i_video"] * LLFF_SPIRAL
    check_counts(counts, {"K1": 2 * steps + 2 * n_chunks * frames, "K4": 2 * steps,
                          "recompute": 2 * steps, "chain": 2 * steps},
                 f"cli.train llff: {steps} steps and {frames} eval frames")
    ndc_z = [float(o[0][..., 2].max()) for _, _, o in ndc[:1]] + \
        [float(o[0][..., 2].min()) for _, _, o in ndc[:1]]
    noisy = all("noise0" in d and "noise1" in d for _, _, d in draws)
    sampler = type(samplers[0][2]).__name__ if len(samplers) == 1 else samplers
    if not (cfg.ndc and len(ndc) == calls and max(abs(z + 1.0) for z in ndc_z) < 1e-4 and
            sampler == BatchedRaySampler.__name__ and len(draws) == calls and noisy and
            cfg.raw_noise_std == 1.0):
        raise RuntimeError(f"not the llff recipe: ndc {cfg.ndc}, {len(ndc)} NDC transforms "
                           f"(want {calls}: {graphs}), ray origins at z {ndc_z}, sampler "
                           f"{sampler}, sigma noise {noisy}")
    evals = [float(m) for m in re.findall(r"\[EVAL\] Iter: \d+ holdout view \d+ PSNR: (\S+)", out)]
    if len(evals) != steps // c["i_img"] or not np.isfinite(evals).all():
        raise RuntimeError(f"expected {steps // c['i_img']} holdout evals, got {evals}")
    expdir = os.path.join(root, "logs", "llff")
    tars = sorted(f for f in os.listdir(expdir) if f.endswith(".tar"))
    test_png = read_png(os.path.join(expdir, f"testset_{steps:06d}", "000.png"))
    spiral = [f for f in os.listdir(expdir) if f.startswith(f"llff_spiral_{steps:06d}_rgb")]
    n_spiral = (LLFF_SPIRAL if spiral and spiral[0].endswith(".mp4") else
                len(os.listdir(os.path.join(expdir, spiral[0]))) if spiral else 0)
    if tars != [f"{steps:06d}.tar"] or test_png.shape != LLFF_MINIFIED + (3,) or \
            n_spiral != LLFF_SPIRAL:
        raise RuntimeError(f"tars {tars}, test PNG {test_png.shape}, spiral {spiral} "
                           f"({n_spiral} frames)")
    losses = check_loss_falls(result.history, "cli.train llff")

    # spiral frames timed (12 K1 each), the first against the plain path;
    # an NDC batch's grads against the plain path
    model, rs = make_model(cfg), loop.render_settings_from_config(cfg)
    nets = result.state.nets
    poses = scene.render_poses[:LLFF_TIMED_FRAMES]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rgbs, _ = loop.render_path(nets, model, rs, scene, poses, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    frame_ms = 1e3 * (time.perf_counter() - t0) / len(poses)
    check_counts(read_counts(), {"K1": 2 * n_chunks * len(poses)}, "llff spiral frames")
    frame_err, _, _ = rgb_against_plain(nets, model, rs, rgbs[0], scene.K, poses[0], scene.hwf,
                                        0.0, 1.0, dev)
    batch = BatchedRaySampler(scene, CHECK_RAYS, torch.Generator(device=dev).manual_seed(5),
                              device=dev)
    ro, rd, target = batch.next_batch()
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    ro, rd = ndc_rays(scene.H, scene.W, scene.focal, 1.0, ro, rd)
    phase("cli_llff", steps=steps, seconds=f"{seconds:.2f}", minify_s=f"{minify_s:.3f}",
          images_2=f"{len(names)} x {small.shape}", load_s=f"{load_s:.3f}",
          sampler=sampler, ndc_transforms=len(ndc), ray_origin_z=ndc_z, noisy_draws=len(draws),
          graph_captures=graphs["captures"], graph_replays=graphs["replays"],
          launches=counts, eval_frames=frames, k1_per_frame=2 * n_chunks,
          holdout_psnr=[f"{p:.3f}" for p in evals], tars=tars,
          spiral=f"{spiral[0]} ({n_spiral} frames)", loss_first=f"{losses[0]:.6f}",
          loss_last=f"{losses[-1]:.6f}", spiral_ms_per_frame=f"{frame_ms:.2f}",
          ndc_rgb_vs_plain_max_abs=f"{frame_err:.3e}", tol=RENDER_RGB_TOL)
    if not frame_err <= RENDER_RGB_TOL:
        raise RuntimeError(f"the NDC frame disagrees with the plain path: {frame_err}")
    grads_against_plain(nets, model, rs, ro, rd, vd, 0.0, 1.0, target, dev, path="llff (NDC)")
    ndc_grads_vs_f32(nets, model, rs, scene, batch, (ro, rd, vd, target), dev)
    timed_format_run(root, "synthff.txt", datadir, scene, dev, "llff")


def ndc_grads_vs_f32(nets, model, rs, scene, sampler, first, dev):
    """22. ROADMAP C.6: on NDC_BATCHES of the synthff recipe's NDC batches
    (``first``, the batch and draws grads_against_plain took, then the
    sampler's next ones; CHECK_RAYS rays each), the kernel path's (K1/K4,
    bf16) and the plain path's (bf16) weight grads of one step, each
    against the plain path's in f32 (the same f32 weights), worst leaf
    (relative L2), and at the leaf where the two bf16 paths lie furthest
    apart (phase 8's measure) each one's distance from f32; and split by
    k6_halves' method: K4's phases and K4's bf16 plain version, each on the
    cotangent of raw planes that the kernel path's backward hands K4 at
    each level, against K4's f32 plain version on that cotangent (the f32
    packing of the same net). A measurement: phase 8's bound
    (grads_against_plain) stays as it is."""
    from nerf_tpu_torch.geom.rays import ndc_rays
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.train.step import draw_overrides, loss_fn

    pe_pts, pe_views = PosEncConfig(10), PosEncConfig(4)
    levels = ("coarse", "fine")
    params = [p for level in levels for p in nets[level].parameters()]
    names = [f"{level}.{n}" for level in levels for n, _ in nets[level].named_parameters()]
    models = {"kernel": model, "plain": dataclasses.replace(model, fused=False, fused_render=False),
              "f32": dataclasses.replace(model, fused=False, fused_render=False,
                                         compute_dtype="float32")}
    kp32 = {S: fused_mlp.pack_params(nets[level], pe_pts, pe_views, torch.float32)
            for level, S in (("coarse", rs.n_samples), ("fine", rs.n_samples + rs.n_importance))}
    kp32 = {S: {k: v.detach() for k, v in kp.items()} for S, kp in kp32.items()}
    worst = {"kernel": (0.0, ""), "plain": (0.0, ""), "k4_phases": (0.0, ""),
             "k4_plain": (0.0, "")}
    apart = (0.0, "")  # phase 8's measure: the kernel path against the bf16 plain path
    original = fused_mlp._FusedRaysPlanes.backward
    for b in range(NDC_BATCHES):
        if b == 0:  # grads_against_plain's batch and draws
            ro, rd, vd, target = first
        else:
            ro, rd, target = sampler.next_batch()
            vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
            ro, rd = ndc_rays(scene.H, scene.W, scene.focal, 1.0, ro, rd)
        n = ro.shape[0]
        near, far = torch.zeros(n, device=dev), torch.ones(n, device=dev)
        ov = draw_overrides(torch.Generator(device=dev).manual_seed(7 if b == 0 else 100 + b), n,
                            rs)
        seen = []  # (packed leaves, rays, depths, cotangent) K4 gets at each level

        def record(ctx, g):
            seen.append((ctx.saved_tensors, g.detach().clone()))
            return original(ctx, g)

        grads = {}
        for key, m in models.items():
            fused_mlp._FusedRaysPlanes.backward = staticmethod(record)
            try:
                loss, _ = loss_fn(nets, m, rs, ro, rd, vd, near, far, target, overrides=ov)
                grads[key] = torch.autograd.grad(loss, params)
            finally:
                fused_mlp._FusedRaysPlanes.backward = original
        line = {}
        for key in ("kernel", "plain"):
            err, leaf = max((rel_l2(a, w), name) for name, a, w in
                            zip(names, grads[key], grads["f32"]))
            line[f"{key}_vs_f32"] = f"{err:.3e} ({leaf})"
            worst[key] = max(worst[key], (err, leaf))
        # phase 8's measure, and each path's distance from f32 at its leaf
        err, i = max((rel_l2(a, w), i) for i, (a, w) in enumerate(zip(grads["kernel"],
                                                                     grads["plain"])))
        line["kernel_vs_plain"] = f"{err:.3e} ({names[i]})"
        apart = max(apart, (err, f"batch {b} {names[i]}"))
        line["there_kernel_plain_vs_f32"] = (f"{rel_l2(grads['kernel'][i], grads['f32'][i]):.3e} "
                                             f"{rel_l2(grads['plain'][i], grads['f32'][i]):.3e}")
        if len(seen) != 2:
            raise RuntimeError(f"the kernel path's backward ran K4 {len(seen)} times, not 2")
        with torch.no_grad():
            for saved, g in seen:
                ro_, rd_, vd_, z_, *leaves = saved
                kp = dict(zip(fused_mlp.KP_NAMES, leaves))
                S = z_.shape[1]
                k4 = fused_mlp.fused_rays_planes_bwd(kp, ro_, rd_, vd_, z_, g)
                plain = fused_mlp.fused_rays_planes_bwd_reference(kp, ro_, rd_, vd_, z_, g)
                f32 = fused_mlp.fused_rays_planes_bwd_reference(kp32[S], ro_, rd_, vd_, z_, g)
                for key, got in (("k4_phases", k4), ("k4_plain", plain)):
                    err, leaf = max((rel_l2(got[k], f32[k]), k) for k in fused_mlp.KP_NAMES)
                    line[f"{key}_vs_f32_S{S}"] = f"{err:.3e} ({leaf})"
                    worst[key] = max(worst[key], (err, f"S={S} {leaf}"))
        phase("ndc_grads_vs_f32", batch=b, rays=n, **line)
    phase("ndc_grads_vs_f32_worst", batches=NDC_BATCHES, phase8_tol=STEP_GRAD_TOL,
          kernel_vs_plain=f"{apart[0]:.3e} ({apart[1]})",
          **{f"{k}_vs_f32": f"{e:.3e} ({leaf})" for k, (e, leaf) in worst.items()})


def cli_formats_phase(root: str, dev) -> dict:
    """23. The DeepVoxels and LINEMOD scenes written at the tools' 512x512
    and 400x400 (fewer views), each through ``cli.train.main`` with its
    config (batching; no_batching with precrop): 2 K1 + 2 K4 a step, a
    falling loss, the loader's near/far, for LINEMOD the json's K in
    get_rays; then each recipe's timed and profiled windows, which it
    returns by scene ("dv", "linemod")."""
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.data import rays_dataset
    from nerf_tpu_torch.data.scene import default_intrinsics
    from nerf_tpu_torch.tools import make_deepvoxels_scene, make_linemod_scene
    from nerf_tpu_torch.train import loop

    timed = {}
    for path, tool, config, views, sampler_want in (
            ("dv", make_deepvoxels_scene, "synth_dv.txt", DV_COUNTS, "BatchedRaySampler"),
            ("linemod", make_linemod_scene, "synth_linemod.txt", LINEMOD_COUNTS,
             "ImageRaySampler")):
        datadir = os.path.join(root, path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet(tool.write_scene, datadir, views, device=dev)
        write_s = (time.perf_counter() - t0) / sum(views.values())
        if path == "linemod":
            for split in views:
                meta_path = os.path.join(datadir, f"transforms_{split}.json")
                with open(meta_path) as f:
                    meta = json.load(f)
                for frame in meta["frames"]:
                    frame["intrinsic_matrix"][0][2] += LINEMOD_PP_SHIFT[0]
                    frame["intrinsic_matrix"][1][2] += LINEMOD_PP_SHIFT[1]
                with open(meta_path, "w") as f:
                    json.dump(meta, f)
        argv = format_argv(root, config, datadir, path, FORMAT_STEPS, FORMAT_CADENCES)
        cfg = load_config(argv)
        scene = loop.load_scene(cfg)
        default_k = default_intrinsics(scene.H, scene.W, scene.focal)
        if path == "dv":
            bounds_ok = abs(scene.near - 1.0) < 1e-4 and abs(scene.far - 3.0) < 1e-4
        else:
            bounds_ok = (scene.near, scene.far) == (2.0, 6.0) and \
                abs(scene.K[0, 2] - default_k[0, 2] - LINEMOD_PP_SHIFT[0]) < 1e-4 and \
                abs(scene.K[1, 2] - default_k[1, 2] - LINEMOD_PP_SHIFT[1]) < 1e-4
        samplers, get_rays_calls = [], []
        reset_counts()
        t0 = time.perf_counter()
        with spy(loop, "make_sampler", samplers), spy(rays_dataset, "get_rays", get_rays_calls):
            result, out = run_cli(cli_train.main, argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        steps = FORMAT_STEPS
        n_chunks = -(-scene.H * scene.W // CHUNK)
        evals = steps // FORMAT_CADENCES["i_img"]
        check_counts(counts, {"K1": 2 * steps + 2 * n_chunks * evals, "K4": 2 * steps,
                              "recompute": 2 * steps, "chain": 2 * steps},
                     f"cli.train {path}: {steps} steps and {evals} holdout frames")
        sampler = type(samplers[0][2]).__name__ if len(samplers) == 1 else samplers
        rays_k = [np.asarray(args[2]) for args, _, _ in get_rays_calls]
        k_reached = bool(rays_k) and all(np.array_equal(k, scene.K) for k in rays_k) and \
            not np.array_equal(scene.K, default_k)
        psnr = [float(m) for m in re.findall(r"\[EVAL\] Iter: \d+ holdout view \d+ PSNR: (\S+)", out)]
        losses = check_loss_falls(result.history, f"cli.train {path}")
        phase(f"cli_{path}", views=views, resolution=f"{scene.H}x{scene.W}",
              s_per_view=f"{write_s:.3f}", near=f"{scene.near:.6f}", far=f"{scene.far:.6f}",
              K=scene.K.tolist(), steps=steps, seconds=f"{seconds:.2f}", sampler=sampler,
              launches=counts, holdout_psnr=[f"{p:.3f}" for p in psnr],
              get_rays_calls_with_scene_K=f"{len(rays_k)} ({k_reached})",
              loss_first=f"{losses[0]:.6f}", loss_last=f"{losses[-1]:.6f}")
        if not (bounds_ok and sampler == sampler_want and len(psnr) == evals and
                np.isfinite(psnr).all() and (path == "dv" or k_reached)):
            raise RuntimeError(f"cli.train {path}: bounds {bounds_ok} ({scene.near}, "
                               f"{scene.far}), sampler {sampler}, holdout {psnr}, K in "
                               f"get_rays {k_reached}")
        timed[path] = timed_format_run(root, config, datadir, scene, dev, path)
    return timed


def dp_state(state) -> dict:
    """A train state's step, parameters and Adam moments on the CPU, by
    level and parameter name."""
    return {
        "step": state.step,
        "params": {lvl: {n: p.detach().cpu() for n, p in net.named_parameters()}
                   for lvl, net in state.nets.items()},
        "moments": {lvl: {n: [state.optimizer.state[p][k].cpu() for k in ("exp_avg", "exp_avg_sq")]
                          for n, p in net.named_parameters() if p in state.optimizer.state}
                    for lvl, net in state.nets.items()},
    }


def dp_rank(device, argv):
    """24. ``cli.train.main(argv)`` on ``device``, in the rank's group (or
    alone), with the launch counters and the ray count of each K1 and K4
    launch; returns them with the history, the final state and the
    ``[FUSE]`` lines it printed."""
    from nerf_tpu_torch.cli import train as cli_train
    from nerf_tpu_torch.ops import fused_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the wrappers' launch helpers (the wrappers hold the counters)
    rays = {"K1": [], "K4": []}
    fwd, bwd = fused_mlp._launch, fused_mlp._launch_bwd

    def k1(kp, rays_o, *args):
        rays["K1"].append(rays_o.shape[0])
        return fwd(kp, rays_o, *args)

    def k4(kp, rays_o, *args):
        rays["K4"].append(rays_o.shape[0])
        return bwd(kp, rays_o, *args)

    reset_counts()
    fused_mlp._launch, fused_mlp._launch_bwd = k1, k4
    tee = Tee(sys.stdout)
    try:
        with contextlib.redirect_stdout(tee):
            result = cli_train.main(argv, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        fused_mlp._launch, fused_mlp._launch_bwd = fwd, bwd
    return {"counts": read_counts(), "rays": rays, "history": result.history,
            "state": dp_state(result.state), "chunks": result.chunks,
            "fuse_lines": [ln for ln in tee.text().splitlines() if ln.startswith("[FUSE]")]}


def dp_argv(root: str, expname: str, data_axis: int, dtype: str = DP_PARITY_DTYPE):
    here = os.path.dirname(os.path.abspath(__file__))
    return [f"--config={os.path.join(here, 'configs', 'lego.txt')}",
            f"--datadir={os.path.join(root, 'lego')}", f"--basedir={os.path.join(root, 'logs')}",
            f"--expname={expname}", f"--N_rand={N_RAND}", f"--n_iters={DP_STEPS}",
            f"--data_axis={data_axis}", f"--compute_dtype={dtype}"] + \
        [f"--{k}={v}" for k, v in DP_CADENCES.items()]


def dp_check_run(ranks, one, root: str, expname: str, start, what: str) -> dict:
    """24. The ranks of one run against each other and against the
    one-process run ``one``: launches, ray counts, replicas, the loss and
    the parameters, the .tar and the test-set PNG. Returns the numbers."""
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.utils import checkpoint
    from nerf_tpu_torch.utils.io import read_png

    n, steps = len(ranks), DP_STEPS
    evals = steps // DP_CADENCES["i_img"]
    frame_chunks = -(-H * W // CHUNK)
    # a rank renders its rows of each holdout frame, and rank 0 the test view
    rank_rows = -(-H * W // n)
    rank_chunks = -(-rank_rows // min(CHUNK, rank_rows))
    for r, out in enumerate([one] + list(ranks)):
        tag, rays = ("one process", N_RAND) if r == 0 else (f"rank {r - 1}", N_RAND // n)
        k1 = 2 * steps + 2 * evals * (frame_chunks if r == 0 else rank_chunks) + \
            (2 * frame_chunks if r <= 1 else 0)
        # (the recompute and chain launches are the bf16 backward's)
        phase1 = 2 * steps if DP_PARITY_DTYPE == "bfloat16" else 0
        check_counts(out["counts"], {"K1": k1, "K4": 2 * steps, "recompute": phase1,
                                     "chain": phase1}, f"{what}, {tag}")
        if out["rays"]["K1"].count(rays) != 2 * steps or \
                out["rays"]["K4"] != [rays] * (2 * steps):
            raise RuntimeError(f"{what}, {tag}: K1 launches at {rays} rays "
                               f"{out['rays']['K1'].count(rays)}, K4's rays {out['rays']['K4']}")
    losses = check_loss_falls(ranks[0]["history"], what)
    if any(out["history"] != ranks[0]["history"] for out in ranks):
        raise RuntimeError(f"{what}: the ranks' histories differ")
    equal = all(torch.equal(a, out["state"]["params"][lvl][name])
                for out in ranks[1:] for lvl, ps in ranks[0]["state"]["params"].items()
                for name, a in ps.items())
    equal = equal and all(torch.equal(a, b) for out in ranks[1:]
                          for lvl, ms in ranks[0]["state"]["moments"].items()
                          for name, pair in ms.items()
                          for a, b in zip(pair, out["state"]["moments"][lvl][name]))
    if not equal:
        raise RuntimeError(f"{what}: the ranks' parameters or moments differ")
    want_losses = [h[1] for h in one["history"]]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    cfg = load_config(dp_argv(root, expname, n))
    worst_abs, worst_update = 0.0, (0.0, "")
    for lvl, ps in ranks[0]["state"]["params"].items():
        for name, got in ps.items():
            want, p0 = one["state"]["params"][lvl][name], start[lvl][name]
            worst_abs = max(worst_abs, float((got - want).abs().max()))
            moved = float(torch.linalg.norm(want - p0))
            if moved > 0:
                worst_update = max(worst_update,
                                   (float(torch.linalg.norm(got - want)) / moved, f"{lvl}.{name}"))
    expdir = os.path.join(root, "logs", expname)
    tars = [os.path.basename(t) for t in checkpoint.find_checkpoints(cfg.basedir, cfg.expname)]
    saved = checkpoint.load_checkpoint(os.path.join(expdir, f"{steps:06d}.tar"), make_model(cfg),
                                       cfg.lrate, device="cpu")
    tar_equal = saved.step == steps and all(
        torch.equal(p, ranks[0]["state"]["params"][lvl][name])
        and all(torch.equal(saved.optimizer.state[p][k], m) for k, m in
                zip(("exp_avg", "exp_avg_sq"), ranks[0]["state"]["moments"][lvl][name]))
        for lvl, net in saved.nets.items() for name, p in net.named_parameters())
    png = read_png(os.path.join(expdir, f"testset_{steps:06d}", "000.png"))
    numbers = {"loss_max_rel_err": loss_rel, "param_max_abs_diff": worst_abs,
               "worst_update_rel_l2": worst_update, "tars": tars, "tar_equals_rank0": tar_equal,
               "test_png": png.shape, "losses": [f"{x:.6f}" for x in losses]}
    if not (loss_rel <= DP_LOSS_RTOL and worst_abs <= 4 * cfg.lrate and
            worst_update[0] <= DP_UPDATE_TOL and tars == [f"{steps:06d}.tar"] and tar_equal
            and png.shape == (H, W, 3)):
        raise RuntimeError(f"{what} against one process: {numbers}")
    return numbers


def dp_nccl_rank(device, views, timed):
    """24. A rank of the NCCL group: ``dp_time.check_rank`` (the fused loop
    against step by step through ``train()`` on ``views``), then
    ``dp_time.time_rank(device, *timed)``."""
    from nerf_tpu_torch.tools import dp_time

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"check": dp_time.check_rank(device, views), "time": dp_time.time_rank(device, *timed)}


def dp_fuse_check(ranks, what: str) -> dict:
    """24. Every rank's ``dp_time.check_rank``: ``torch.equal``, CHECK_CHUNKS
    chunks fused, each one graph replay, none step by step, the same
    launches either way, 2 K1 + 2 K4 a step (the bf16 backward's recompute
    and chain each too) and no other; the ranks' histories equal. Returns
    rank 0's numbers."""
    from nerf_tpu_torch.tools import dp_time

    steps = dp_time.CHECK_K * dp_time.CHECK_CHUNKS
    want = {name: 2 * steps for name in ("fused_rays_planes", "fused_rays_planes_bwd",
                                         "bwd_recompute", "bwd_chain")}
    for r, out in enumerate(c["check"] for c in ranks):
        fused, per_step = out["fused"], out["per_step"]
        ok = (out["equal"] and fused["chunks"] == fused["replays"] == dp_time.CHECK_CHUNKS
              and per_step["chunks"] == per_step["replays"] == 0
              and fused["launches"] == per_step["launches"] == want
              and not any(ln.startswith("[FUSE]") and "not fused" in ln for ln in fused["lines"])
              and out["history"] == ranks[0]["check"]["history"])
        if not ok:
            raise RuntimeError(f"{what}, rank {r}: the fused loop against step by step: {out}")
    out = ranks[0]["check"]
    return {"fuse_steps": dp_time.CHECK_K, "fused_steps": steps, "fused_equal": True,
            "fused_chunks": out["fused"]["chunks"], "fused_replays": out["fused"]["replays"],
            "fused_launches": out["fused"]["launches"], "fused_history": out["history"],
            "mesh_line": next((ln for ln in out["fused"]["lines"] if ln.startswith("[MESH]")), None)}


def dp_phase(views, dev):
    """24. Data parallelism through ``cli.train.main`` on phase 19's teacher
    scene: one process, then 2 gloo ranks on this card (step by step: gloo
    is no capturable group), then NCCL with a card a rank (or a one-rank
    NCCL group): the fused loop against step by step, and the times."""
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.models.factory import init_nets, make_model
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.tools import dp_time

    root = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    write_blender_scene(views, os.path.join(root, "lego"))
    cfg = load_config(dp_argv(root, "one", 1))
    start = {lvl: {n: p.detach().cpu() for n, p in net.named_parameters()}
             for lvl, net in init_nets(make_model(cfg), cfg.seed, dev).items()}
    t0 = time.perf_counter()
    # step by step: dp_rank reads each launch's rays in Python, which a
    # fused chunk runs only at its capture (the fused loop is held to this
    # below, and in phase 31)
    one = dp_rank(dev, dp_argv(root, "one", 1) + ["--fuse_steps=1"])
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    # the config's fuse_steps: gloo ranks on a card step one by one, and
    # rank 0 says so
    ranks = distributed.launch(dp_rank, DP_RANKS, "cuda:0", backend="gloo",
                               args=(dp_argv(root, "gloo", DP_RANKS),))
    gloo_s = time.perf_counter() - t0
    numbers = dp_check_run(ranks, one, root, "gloo", start, "dp gloo")
    fuse_lines = ranks[0]["fuse_lines"]
    if len(fuse_lines) != 1 or "gloo" not in fuse_lines[0] or \
            not fuse_lines[0].endswith("step by step") or any(out["chunks"] for out in ranks):
        raise RuntimeError(f"dp gloo: [FUSE] lines {fuse_lines}, chunks "
                           f"{[out['chunks'] for out in ranks]}")
    # two processes time-slice one card here: their speed means nothing
    phase("dp", backend="gloo", ranks=DP_RANKS, devices="cuda:0 for both ranks (one card)",
          steps=DP_STEPS, n_rand=N_RAND, rays_per_rank=N_RAND // DP_RANKS, dtype=DP_PARITY_DTYPE,
          launches=[out["counts"] for out in ranks], one_process_launches=one["counts"],
          replicas_equal=True, one_process_s=f"{one_s:.2f}", launch_s=f"{gloo_s:.2f}",
          fuse_line=repr(fuse_lines[0]), **numbers)
    cards = torch.cuda.device_count()
    if cards >= 2:
        ranks = distributed.launch(dp_rank, DP_RANKS, "cuda",
                                   args=(dp_argv(root, "nccl", DP_RANKS) + ["--fuse_steps=1"],))
        numbers = dp_check_run(ranks, one, root, "nccl", start, "dp nccl")
        # the fused loop, then the bf16 step's time step by step and fused,
        # a card a rank (tools/dp_time.py's ranks)
        nccl = distributed.launch(dp_nccl_rank, DP_RANKS, "cuda", args=(views, ()))
        fused = dp_fuse_check(nccl, "dp nccl")
        timed = [o["time"] for o in nccl]
        devices = sorted({t["device"] for t in timed})
        if len(devices) != DP_RANKS or any(t["all_reduce_of_ones"] != [DP_RANKS] * 8 for t in timed):
            raise RuntimeError(f"dp nccl: devices {devices}, all-reduce {timed}")
        t = timed[0]
        phase("dp", backend="nccl", ranks=DP_RANKS, devices=devices, cards=cards, steps=DP_STEPS,
              launches=[out["counts"] for out in ranks], replicas_equal=True, **numbers, **fused,
              timed_dtype="bfloat16", ms_per_step=f"{t['ms_per_step']:.3f}",
              window_ms_per_step=[f"{x:.3f}" for x in t["window_ms_per_step"]],
              device_ms_per_step=f"{t['device_ms_per_step']:.3f}",
              allreduce_device_ms_per_step=f"{t['allreduce_ms_per_step']:.3f}",
              idle_share=t["idle_share"], peak_gib=f"{t['peak_gib']:.2f}",
              fused_ms_per_step=f"{t['fused_ms_per_step']:.3f}",
              fused_device_ms_per_step=f"{t['fused_device_ms_per_step']:.3f}",
              fused_allreduce_device_ms_per_step=f"{t['fused_allreduce_ms_per_step']:.3f}",
              fused_idle_share=t["fused_idle_share"], fused_peak_gib=f"{t['fused_peak_gib']:.2f}",
              allreduce_kernels=t["allreduce_kernels"])
    else:
        (out,) = distributed.launch(dp_nccl_rank, 1, "cuda",
                                    args=(views, (0, 0, 0, DP_ONE_RANK_STEPS, 0)))
        fused = dp_fuse_check([out], "dp nccl, one rank")
        t = out["time"]
        if t["all_reduce_of_ones"] != [1.0] * 8 or not np.isfinite(t["loss"]) or \
                fused["mesh_line"] is None:
            raise RuntimeError(f"dp nccl, one rank: {out}")
        phase("dp", backend="nccl", ranks=1, devices=[t["device"]],
              note="a second card was not present: a one-rank NCCL group", **fused,
              steps=DP_ONE_RANK_STEPS, loss=f"{t['loss']:.6f}",
              allreduce_device_ms_per_step=f"{t['allreduce_ms_per_step']:.3f}",
              allreduce_kernels=t["allreduce_kernels"], all_reduce_of_ones="ok")
    shutil.rmtree(root)


def tp_rank(device, job: dict) -> dict:
    """32. On a rank of the ``job["mesh"]`` (n_data, n_model) mesh, the
    DP×TP step (``make_sharded_train_step(shard_model_axis=True)`` on
    ``shard_state``'s state); with no mesh, one process's plain step. In
    f32, TP_PARITY_STEPS steps on ``job["parity"]``'s batches from one draw
    seed (the whole state back by ``gather_state``); then in bf16, a
    warm-up step at TP_WARMUP_RAYS rays and TP_TIMED steps at ``n_rand``
    rays (the one process picks it: the largest power of two up to N_RAND
    whose two ranks fit the card with room, from its f32 peak) for ms/step
    and the peak memory. Both runs count the plain MLPs' calls (whole and
    model-parallel)."""
    from nerf_tpu_torch.models.factory import init_nets
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.parallel import mesh as pmesh
    from nerf_tpu_torch.parallel.tensor_parallel import ShardedNeRFMLP
    from nerf_tpu_torch.train.step import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = None if job["mesh"] is None else pmesh.make_mesh(*job["mesh"], device=device)
    rs, lrate, decay = job["rs"], job["lrate"], job["lrate_decay"]

    def run(dtype: str, batches, timed: int):
        model = dataclasses.replace(job["model"], compute_dtype=dtype)
        state = init_train_state(init_nets(model, job["seed"], device), lrate)
        if mesh is None:
            step = make_train_step(model, rs, lrate, decay)
        else:
            state = pmesh.shard_state(mesh, pmesh.place_state(mesh, state))
            step = pmesh.make_sharded_train_step(mesh, model, rs, lrate, decay,
                                                 shard_model_axis=True)
        gen = torch.Generator(device).manual_seed(job["seed"])
        NeRFMLP.plain_calls = ShardedNeRFMLP.plain_calls = 0
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        losses, t0 = [], None
        for i, batch in enumerate(batches):
            if i == len(batches) - timed:
                torch.cuda.synchronize(device)
                if mesh is not None:
                    distributed.barrier(mesh.group)
                t0 = time.perf_counter()
            rows = tuple(torch.from_numpy(a).to(device) for a in batch)
            if mesh is not None:
                rows = pmesh.shard_batch(mesh, *rows)
            losses.append(step(state, *rows, generator=gen)["loss"])
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0 if timed else 0.0
        return state, {"losses": [float(x) for x in losses],
                       "ms_per_step": 1e3 * seconds / timed if timed else None,
                       "peak_gib": torch.cuda.max_memory_allocated(device) / 2 ** 30,
                       "plain_calls": (NeRFMLP.plain_calls, ShardedNeRFMLP.plain_calls)}

    state, f32 = run("float32", job["parity"], 0)
    f32["state"] = on_cpu(pmesh.gather_state(mesh, state))  # whole nets: no collective
    del state
    n_rand = job["n_rand"]
    if n_rand is None:  # the one process: two ranks, each with room, on the card
        total = torch.cuda.get_device_properties(device).total_memory / 2 ** 30
        n_rand = TP_PARITY_RAYS
        while n_rand < N_RAND and 2 * TP_ROOM * f32["peak_gib"] * 2 * n_rand / \
                TP_PARITY_RAYS <= TP_CARD_SHARE * total:
            n_rand *= 2
    first, *timed = job["timed"]
    batches = [tuple(a[:TP_WARMUP_RAYS] for a in first)] + \
        [tuple(a[:n_rand] for a in b) for b in timed]
    _, bf16 = run("bfloat16", batches, TP_TIMED)
    return {"device": str(device), "f32": f32, "bf16": bf16, "n_rand": n_rand,
            "rank": None if mesh is None else (mesh.rank, mesh.data_index, mesh.model_index)}


def on_cpu(tree):
    """A nest of dicts, tuples and tensors with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(on_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def tp_batches(views, n_batches: int, n_rays: int, seed: int):
    """``n_batches`` batches of ``n_rays`` rays drawn from the teacher views
    (a view a batch, pixels at random): (rays_o, rays_d, near, far, target)
    as numpy float32."""
    from nerf_tpu_torch.geom.rays import get_rays_np

    rng = np.random.default_rng(seed)
    h, w = views.images.shape[1:3]
    out = []
    for b in range(n_batches):
        v = b % len(views.images)
        ro, rd = get_rays_np(h, w, views.K, views.poses[v])
        idx = rng.choice(h * w, n_rays, replace=False)
        out.append((np.ascontiguousarray(ro.reshape(-1, 3)[idx], np.float32),
                    np.ascontiguousarray(rd.reshape(-1, 3)[idx], np.float32),
                    np.full(n_rays, NEAR, np.float32), np.full(n_rays, FAR, np.float32),
                    np.ascontiguousarray(views.images[v].reshape(-1, 3)[idx], np.float32)))
    return out


def tp_check(ranks, one, start, lrate: float, what: str) -> dict:
    """32. Every rank's gathered f32 state against the one process's within
    the CPU test's bounds (tests/test_torch_port_parallel.py: the losses
    within DP_LOSS_RTOL, each weight within 4 lr, each leaf's update and
    each Adam moment within DP_UPDATE_TOL relative L2), the ranks' gathered
    states equal, the model-parallel nets run and the whole ones not.
    Returns the worst numbers."""
    ref = one["f32"]
    worst = {"loss_rel": 0.0, "abs": 0.0, "update": 0.0, "moment": 0.0}
    for r, out in enumerate(ranks):
        got = out["f32"]
        if got["plain_calls"] != (0, 2 * TP_PARITY_STEPS) or \
                out["bf16"]["plain_calls"] != (0, 2 * (1 + TP_TIMED)):
            raise RuntimeError(f"{what}, rank {r}: plain calls {got['plain_calls']} "
                               f"{out['bf16']['plain_calls']}")
        if not np.isfinite(out["bf16"]["losses"]).all():
            raise RuntimeError(f"{what}, rank {r}: bf16 losses {out['bf16']['losses']}")
        worst["loss_rel"] = max(worst["loss_rel"], max(
            abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])))
        for lvl, ps in ref["state"]["params"].items():
            for name, want in ps.items():
                g, p0 = got["state"]["params"][lvl][name], start[lvl][name]
                if r and not torch.equal(g, ranks[0]["f32"]["state"]["params"][lvl][name]):
                    raise RuntimeError(f"{what}: ranks 0 and {r} gathered other {lvl}.{name}")
                worst["abs"] = max(worst["abs"], float((g - want).abs().max()))
                moved = float(torch.linalg.norm(want - p0))
                if moved > 0:
                    worst["update"] = max(worst["update"],
                                          float(torch.linalg.norm(g - want)) / moved)
                for a, b in zip(got["state"]["moments"][lvl][name],
                                ref["state"]["moments"][lvl][name]):
                    if float(torch.linalg.norm(b)) > 0:
                        worst["moment"] = max(worst["moment"], rel_l2(a, b))
    if not (worst["loss_rel"] <= DP_LOSS_RTOL and worst["abs"] <= 4 * lrate and
            worst["update"] <= DP_UPDATE_TOL and worst["moment"] <= DP_UPDATE_TOL):
        raise RuntimeError(f"{what}: against one process {worst}")
    return {f"f32_{k}": f"{v:.3e}" for k, v in worst.items()}


def tp_phase(views, smi: str, dev) -> None:
    """32 (ROADMAP A.8b). The DP×TP step on the card at NeRF-W's 8×512
    (viewdirs, posenc 10/4, 64+128, the plain MLP): one process first, then
    data 1 × model 2 on 2 gloo ranks on cuda:0 (one card), with two or more
    cards data 1 × model 2 on NCCL a card a rank, with four or more data 2 ×
    model 2 on NCCL; each run's f32 steps against the one process's
    (``tp_check``), then bf16 ms/step and peak GiB per rank beside the one
    process's, with the card's name and power limit."""
    from nerf_tpu_torch.models.factory import init_nets
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.render.network import NeRFModel
    from nerf_tpu_torch.render.renderer import RenderSettings

    cfg = MLPConfig(width=TP_WIDTH)
    model = NeRFModel(PosEncConfig(10), PosEncConfig(4), cfg, cfg, "float32")
    rs = RenderSettings(n_samples=N_SAMPLES, n_importance=N_IMPORTANCE, perturb=True,
                        use_viewdirs=True, white_bkgd=True)
    job = {"mesh": None, "n_rand": None, "model": model, "rs": rs, "lrate": MULTI_LRATE,
           "lrate_decay": 500, "seed": TP_SEED,
           "parity": tp_batches(views, TP_PARITY_STEPS, TP_PARITY_RAYS, TP_SEED),
           "timed": tp_batches(views, 1 + TP_TIMED, N_RAND, TP_SEED + 1)}
    start = {lvl: {n: p.detach() for n, p in net.named_parameters()}
             for lvl, net in init_nets(model, TP_SEED, "cpu").items()}
    t0 = time.perf_counter()
    (one,) = distributed.launch(tp_rank, 1, "cuda:0", backend="gloo", args=(job,))
    job["n_rand"] = one["n_rand"]
    runs = [("gloo", "cuda:0", (1, 2))]
    cards = torch.cuda.device_count()
    if cards >= 2:
        runs.append(("nccl", "cuda", (1, 2)))
    if cards >= 4:
        runs.append(("nccl", "cuda", (2, 2)))
    for backend, device, shape in runs:
        ranks = distributed.launch(tp_rank, shape[0] * shape[1], device, backend=backend,
                                   args=({**job, "mesh": shape},))
        if [out["rank"] for out in ranks] != [(r, r // shape[1], r % shape[1])
                                              for r in range(len(ranks))]:
            raise RuntimeError(f"tp {backend}: ranks {[out['rank'] for out in ranks]}")
        numbers = tp_check(ranks, one, start, job["lrate"], f"tp {backend} {shape}")
        phase("tp", backend=backend, mesh=f"data {shape[0]} x model {shape[1]}",
              devices=sorted({out["device"] for out in ranks}), width=TP_WIDTH,
              samples=f"{N_SAMPLES}+{N_IMPORTANCE}", f32_steps=TP_PARITY_STEPS,
              f32_n_rand=TP_PARITY_RAYS, **numbers, bf16_n_rand=job["n_rand"],
              bf16_ms_per_step=[f"{out['bf16']['ms_per_step']:.3f}" for out in ranks],
              one_process_bf16_ms_per_step=f"{one['bf16']['ms_per_step']:.3f}",
              peak_gib_per_rank=[f"{out['bf16']['peak_gib']:.2f}" for out in ranks],
              one_process_peak_gib=f"{one['bf16']['peak_gib']:.2f}",
              f32_peak_gib_per_rank=[f"{out['f32']['peak_gib']:.2f}" for out in ranks],
              one_process_f32_peak_gib=f"{one['f32']['peak_gib']:.2f}",
              bf16_loss_last=f"{ranks[0]['bf16']['losses'][-1]:.6f}",
              one_process_bf16_loss_last=f"{one['bf16']['losses'][-1]:.6f}",
              card=repr(smi))
    phase("tp", seconds=f"{time.perf_counter() - t0:.1f}", runs=len(runs))


def multi_rank(device, argv):
    """25. ``cli.train_multi.main(argv)`` on ``device`` in the rank's group:
    its scenes, history, parameters (on the CPU) and the stacked launch
    counts."""
    from nerf_tpu_torch.cli import train_multi

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_counts()
    with contextlib.redirect_stdout(io.StringIO()):
        result = train_multi.main(argv, device=device)
    torch.cuda.synchronize()
    return {"scenes": result.scenes, "history": result.history, "counts": read_counts(),
            "params": {lvl: {n: p.detach().cpu() for n, p in net.named_parameters()}
                       for lvl, net in result.state.nets.items()}}


def multi_argv(root: str, expname: str, n_iters: int, cadences, data_axis: int = 1):
    """cli.train_multi on the repository's configs/multi/scene_*.txt (their
    datadirs are relative: run from ``root``), logs under ``root``."""
    here = os.path.dirname(os.path.abspath(__file__))
    configs = [os.path.join(here, "configs", "multi", f"scene_{k}.txt")
               for k in range(MULTI_SCENES)]
    return (["--configs", *configs, f"--basedir={os.path.join(root, 'logs', expname)}",
             f"--n_iters={n_iters}", f"--data_axis={data_axis}"]
            + [f"--{k}={v}" for k, v in cadences.items()])


def stacked_matmul_chain(kp, n_pts: int, backward: bool):
    """The stacked K1's 10 large products (``backward``: the stacked K4's
    recompute, cotangent and weight-grad products, backward_matmul_chain's)
    as bf16 torch.bmm over the scene axis at n_pts points a scene: a
    library yardstick, timed here only and used nowhere in the port."""
    dev, S, Wd = kp["W1"].device, kp["W1"].shape[0], kp["W1"].shape[-1]
    bf = torch.bfloat16
    e = torch.randn(S, n_pts, 64, dtype=bf, device=dev)
    a = torch.randn(S, n_pts, Wd, dtype=bf, device=dev)
    ah = torch.randn(S, n_pts, Wd // 2, dtype=bf, device=dev)
    d05 = torch.randn(S, n_pts, 2 * Wd, dtype=bf, device=dev)
    w05 = torch.nn.functional.pad(kp["W05e"], (0, 0, 0, 64 - kp["W05e"].shape[-2]))
    trunk = [kp[f"W{i}"] for i in range(1, 8)] + [kp["Wf"]]

    def run():
        torch.bmm(e, w05)
        for w in trunk + [kp["Wvf"]]:
            torch.bmm(a, w)
        if backward:
            torch.bmm(ah, kp["Wvf"].mT)
            for w in trunk:
                torch.bmm(a, w.mT)
            torch.bmm(e.mT, d05)
            for _ in trunk:
                torch.bmm(a.mT, a)
            torch.bmm(a.mT, ah)

    return run


def multi_kernels(trained, dev):
    """25. The stacked K1 and K4 at the main path's shapes (8 scenes of 1024
    rays, 64 and 192 samples) on stacked nets of random weights from seeds,
    as phases 3 and 6 take theirs: against their plain versions (those
    phases' bounds) and against 8 single-scene K1 and K4 launches (raw bit
    for bit; the grads bit for bit where each scene's points split as K4's
    alone would: R a multiple of 64), then timed per step beside their
    bounds, plain versions and the same products as bf16 torch.bmm. On the
    ``trained`` nets too, K1's raw against 8 single-scene launches (bit for
    bit) and its distance from the plain version (printed)."""
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    pe_pts, pe_views = PosEncConfig(10), PosEncConfig(4)
    cfg = trained["coarse"].cfg
    nets = {level: StackedNeRFMLP.from_nets([NeRFMLP(cfg, seed=100 + 2 * k + j, device=dev)
                                             for k in range(MULTI_SCENES)])
            for j, level in enumerate(("coarse", "fine"))}
    rng = np.random.default_rng(24)
    with torch.no_grad():
        kp = fused_mlp.pack_params(trained["fine"], pe_pts, pe_views, torch.bfloat16)
        rays = [torch.stack(t) for t in zip(*(make_rays(rng, MULTI_RAYS, N_SAMPLES, dev)
                                               for _ in range(MULTI_SCENES)))]
        out = fused_mlp.fused_rays_planes_stacked(kp, *rays)
        trained_err = float((out - fused_mlp.fused_rays_planes_stacked_reference(kp, *rays))
                            .abs().max())
        trained_same = all(torch.equal(out[:, s], fused_mlp.fused_rays_planes(
            {k: v[s].contiguous() for k, v in kp.items()}, *(t[s] for t in rays)))
            for s in range(MULTI_SCENES))
    phase("multi_trained", level="fine (24 steps)", scenes=MULTI_SCENES, R=MULTI_RAYS,
          S=N_SAMPLES, raw_bit_equal_8_single_k1=trained_same,
          k1_max_abs_vs_plain=f"{trained_err:.3e}",
          note="phase 3's bound is taken on random weights")
    del out, kp, rays
    if not trained_same:
        raise RuntimeError("the stacked K1's raw on the trained nets is not 8 K1 launches'")
    trained_vs_f32(trained["fine"], dev)
    rng = np.random.default_rng(25)
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    k1, k4 = dict(zero), dict(zero)
    k1_errs, k4_errs, k4_rel, same_raw, same_grads = [], [], [], True, True
    for level, S in (("coarse", N_SAMPLES), ("fine", N_SAMPLES + N_IMPORTANCE)):
        with torch.no_grad():
            kp = fused_mlp.pack_params(nets[level], pe_pts, pe_views, torch.bfloat16)
        blobs = fused_mlp.kernel_blobs(kp)
        rays = [torch.stack(t) for t in zip(*(make_rays(rng, MULTI_RAYS, S, dev)
                                               for _ in range(MULTI_SCENES)))]
        g = (0.5 + torch.rand(4, MULTI_SCENES, MULTI_RAYS, S, device=dev)) * 1e-4
        with torch.no_grad():
            out = fused_mlp.fused_rays_planes_stacked(kp, *rays, blobs)
            ref = fused_mlp.fused_rays_planes_stacked_reference(kp, *rays)
            k1_errs.append(check_kernel(out.reshape(4, -1, S), ref.reshape(4, -1, S), BF16_TOL,
                                        dtype="bfloat16", stacked=MULTI_SCENES, R=MULTI_RAYS, S=S))
            del ref
            grads = fused_mlp.fused_rays_planes_stacked_bwd(kp, *rays, g, blobs)
            ref_g = fused_mlp.fused_rays_planes_stacked_bwd_reference(kp, *rays, g)
            for k in ref_g:
                for s in range(MULTI_SCENES):
                    k4_rel.append(rel_l2(grads[k][s], ref_g[k][s]))
                    k4_errs.append(float((grads[k][s] - ref_g[k][s]).abs().max()))
            del ref_g
            for s in range(MULTI_SCENES):
                kp_s = {k: v[s].contiguous() for k, v in kp.items()}
                one = [t[s] for t in rays]
                same_raw = same_raw and torch.equal(out[:, s], fused_mlp.fused_rays_planes(kp_s, *one))
                single = fused_mlp.fused_rays_planes_bwd(kp_s, *one, g[:, s].contiguous())
                same_grads = same_grads and all(torch.equal(grads[k][s], v) for k, v in single.items())
            del out, grads
            torch.cuda.empty_cache()
            n_pts = MULTI_SCENES * MULTI_RAYS * S
            k1["ms"] += cuda_ms(lambda: fused_mlp.fused_rays_planes_stacked(kp, *rays, blobs),
                                reps=10, warmup=2)
            k4["ms"] += cuda_ms(lambda: fused_mlp.fused_rays_planes_stacked_bwd(kp, *rays, g, blobs),
                                reps=5, warmup=1)
            k1["plain_ms"] += cuda_ms(
                lambda: fused_mlp.fused_rays_planes_stacked_reference(kp, *rays), reps=1)
            k4["plain_ms"] += cuda_ms(
                lambda: fused_mlp.fused_rays_planes_stacked_bwd_reference(kp, *rays, g), reps=1)
            torch.cuda.empty_cache()
            for t, backward in ((k1, False), (k4, True)):
                chain = stacked_matmul_chain(kp, MULTI_RAYS * S, backward)
                t["library_ms"] += cuda_ms(chain, reps=3)
                del chain
                torch.cuda.empty_cache()
        # the bounds: the single-scene kernels' work and bytes, once a scene
        wbytes = sum(t.numel() * t.element_size() for t in blobs)
        io_in = MULTI_SCENES * MULTI_RAYS * 9 * 4 + n_pts * 4
        k1["ops_ms"] += 1e3 * n_pts * fused_mlp.flops_per_point(cfg, pe_pts, pe_views) / PEAK_BF16_FLOPS
        k1["bytes_ms"] += 1e3 * (io_in + n_pts * 16 + wbytes) / PEAK_BYTES
        k4["ops_ms"] += 1e3 * MULTI_SCENES * fused_mlp.bwd_flops(
            cfg, pe_pts, pe_views, MULTI_RAYS, S) / PEAK_BF16_FLOPS
        gbytes = 4 * sum(v.numel() for v in kp.values())
        k4["bytes_ms"] += 1e3 * (io_in + n_pts * 16 + 2 * wbytes + gbytes) / PEAK_BYTES
        ws_gb = fused_mlp.stacked_workspace_bytes(cfg.width, MULTI_SCENES, MULTI_RAYS, S) / 1e9
        phase("multi_kernels", level=level, scenes=MULTI_SCENES, R=MULTI_RAYS, S=S,
              k1_max_abs=f"{k1_errs[-1]:.3e}", k4_worst_leaf_rel_l2=f"{max(k4_rel):.3e}",
              k4_tol=K4_BF16_TOL, raw_bit_equal_8_single_k1=same_raw,
              grads_bit_equal_8_single_k4=same_grads, k4_workspace_gb=f"{ws_gb:.3f}",
              weight_stream_gb=f"{-(-n_pts // fused_mlp.FWD_TILE) * fused_mlp.fwd_weight_bytes_per_tile(cfg) / 1e9:.3f}")
    if not (same_raw and max(k4_rel) <= K4_BF16_TOL):
        raise RuntimeError(f"stacked kernels: raw equal to single launches {same_raw}, K4 worst "
                           f"leaf {max(k4_rel)} (bound {K4_BF16_TOL})")
    for tag, t in (("k1s_times", k1), ("k4s_times", k4)):
        print_stacked_times(tag, t, "S=64 + S=192")
    return {"k1": k1, "k4": k4, "k1_err": max(k1_errs), "k4_err": max(k4_errs),
            "grads_bit_equal": same_grads, **multi_kernels_points_render(nets, dev)}


def print_stacked_times(tag: str, t: dict, samples: str) -> None:
    bound = max(t["ops_ms"], t["bytes_ms"])
    phase(tag, per=f"step ({MULTI_SCENES} scenes, N_rand {MULTI_RAYS}, {samples})",
          ms=f"{t['ms']:.3f}", bound_ms=f"{bound:.3f}",
          bound_by="operations" if t["ops_ms"] >= t["bytes_ms"] else "bytes",
          plain_ms=f"{t['plain_ms']:.3f}", library_ms=f"{t['library_ms']:.3f}",
          x_bound=f"{t['ms'] / bound:.3f}", x_library=f"{t['ms'] / t['library_ms']:.3f}")


def stacked_points(rays, N: int):
    """(x [S, R*N, 3], v [S, R*N, 3]) of stacked rays [S, R, ...] and depths
    [S, R, N]: the renderer's points, a direction per point (spr = 1)."""
    ro, rd, vd, z = rays
    S, R = z.shape[:2]
    x = (ro[:, :, None] + rd[:, :, None] * z[..., None]).reshape(S, R * N, 3)
    return x, vd[:, :, None].expand(S, R, N, 3).reshape(S, R * N, 3)


def trained_vs_f32(fine, dev):
    """25. On the fine nets that cli.train_multi trained, the stacked K1, K2
    and K5 and their bf16 plain versions, each against the f32 plain version
    (the nets packed in f32), at 8 x 1024 rays of 64 samples (K2: 63, a
    direction per point), max abs of raw (K5: and of rgb): whether the tile
    or the bf16 plain version moves K1's distance from its plain version on
    trained weights past phase 3's bound, which random weights set. A
    measurement: no bound."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.ops import fused_mlp

    pe_pts, pe_views = PosEncConfig(10), PosEncConfig(4)
    rng = np.random.default_rng(26)
    with torch.no_grad():
        kp = fused_mlp.pack_params(fine, pe_pts, pe_views, torch.bfloat16)
        kp32 = fused_mlp.pack_params(fine, pe_pts, pe_views, torch.float32)
        out = {}
        for name, n in (("K1s", N_SAMPLES), ("K2s", POINTS_SAMPLES), ("K5s", N_SAMPLES)):
            rays = [torch.stack(t) for t in zip(*(make_rays(rng, MULTI_RAYS, n, dev)
                                                   for _ in range(MULTI_SCENES)))]
            if name == "K1s":
                got = [fused_mlp.fused_rays_planes_stacked(kp, *rays),
                       fused_mlp.fused_rays_planes_stacked_reference(kp, *rays),
                       fused_mlp.fused_rays_planes_stacked_reference(kp32, *rays)]
            elif name == "K2s":
                x, v = stacked_points(rays, n)
                got = [fused_mlp.fused_points_stacked(kp, x, v, 1),
                       fused_mlp.fused_points_stacked_reference(kp, x, v, 1),
                       fused_mlp.fused_points_stacked_reference(kp32, x, v, 1)]
            else:
                maps = [fused_render.fused_render_stacked_fwd(kp, *rays, None, True, keep_raw=True),
                        fused_render.fused_render_stacked_reference(kp, *rays, None, True),
                        fused_render.fused_render_stacked_reference(kp32, *rays, None, True)]
                got = [m.raw for m in maps]
                rgb = [m.rgb for m in maps]
                out["K5s_rgb"] = (float((rgb[0] - rgb[2]).abs().max()),
                                  float((rgb[1] - rgb[2]).abs().max()),
                                  float((rgb[0] - rgb[1]).abs().max()))
            out[name] = (float((got[0] - got[2]).abs().max()), float((got[1] - got[2]).abs().max()),
                         float((got[0] - got[1]).abs().max()))
            del got, rays
            torch.cuda.empty_cache()
    for name, (k, p, kpl) in out.items():
        phase("multi_trained_vs_f32", kernel=name, level="fine (24 steps)", scenes=MULTI_SCENES,
              R=MULTI_RAYS, kernel_vs_f32_max_abs=f"{k:.3e}", bf16_plain_vs_f32_max_abs=f"{p:.3e}",
              kernel_vs_bf16_plain_max_abs=f"{kpl:.3e}", phase3_tol=BF16_TOL)


def multi_kernels_points_render(nets, dev):
    """25. The stacked K2/K3 (63 and 191 samples, a direction per point) and
    K5/K6 (64 and 192, sigma noise, a white background) at 8 scenes of 1024
    rays on the stacked nets of random weights that multi_kernels takes:
    against their plain versions (K2's raw and K5's maps at phase 3's bf16
    bound, K1's; K3's and K6's grads at phase 6's per-leaf bound, K4's),
    and against 8 single-scene K2, K3, K5 and K6 launches, bit for bit (raw,
    maps, grads: a scene's points are whole tiles and its rays whole ray
    groups and 64-ray columns at these shapes, so each tile computes what
    the single launch computes for it, and each scene's weight grads split
    as the single launch's); then each timed per step beside its bound, its
    plain version and the same products as bf16 torch.bmm. K5 is timed as
    training launches it, raw kept for K6."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.ops import fused_mlp

    pe_pts, pe_views = PosEncConfig(10), PosEncConfig(4)
    cfg = nets["coarse"].cfg
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    rng = np.random.default_rng(27)
    gen = torch.Generator(device=dev).manual_seed(27)
    zero = {"ms": 0.0, "plain_ms": 0.0, "ops_ms": 0.0, "bytes_ms": 0.0, "library_ms": 0.0}
    k2, k3, k5, k6 = (dict(zero) for _ in range(4))
    errs = {"k2": [], "k3": [], "k5": [], "k6": []}
    rels = {"k3": [], "k6": []}
    halves = {"composite": [], "k4s_vs_plain": [], "k4s_vs_f32": [], "plain_vs_f32": []}
    same = {"k2": True, "k3": True, "k5": True, "k6": True}
    Sc, R = MULTI_SCENES, MULTI_RAYS
    for level, (n2, n5) in (("coarse", (POINTS_SAMPLES, N_SAMPLES)),
                            ("fine", (POINTS_SAMPLES + N_IMPORTANCE, N_SAMPLES + N_IMPORTANCE))):
        with torch.no_grad():
            kp = fused_mlp.pack_params(nets[level], pe_pts, pe_views, torch.bfloat16)
            kp32 = fused_mlp.pack_params(nets[level], pe_pts, pe_views, torch.float32)
        blobs = fused_mlp.kernel_blobs(kp)
        wbytes = sum(t.numel() * t.element_size() for t in blobs)
        gbytes = 4 * sum(v.numel() for v in kp.values())
        singles = [{k: v[s].contiguous() for k, v in kp.items()} for s in range(Sc)]
        # the stacked K2 and K3
        rays = [torch.stack(t) for t in zip(*(make_rays(rng, R, n2, dev) for _ in range(Sc)))]
        x, v = stacked_points(rays, n2)
        del rays
        g = (0.5 + torch.rand(Sc, R * n2, 4, device=dev, generator=gen)) * 1e-4
        n_pts = Sc * R * n2
        with torch.no_grad():
            out = fused_mlp.fused_points_stacked(kp, x, v, 1, blobs)
            ref = fused_mlp.fused_points_stacked_reference(kp, x, v, 1)
            errs["k2"].append(check_kernel(out.permute(2, 0, 1), ref.permute(2, 0, 1), BF16_TOL,
                                           kernel="K2s", dtype="bfloat16", stacked=Sc, R=R, S=n2,
                                           spr=1))
            del ref
            grads = fused_mlp.fused_points_stacked_bwd(kp, x, v, g, 1, blobs)
            ref_g = fused_mlp.fused_points_stacked_bwd_reference(kp, x, v, g, 1)
            for k in ref_g:
                for s in range(Sc):
                    rels["k3"].append(rel_l2(grads[k][s], ref_g[k][s]))
                    errs["k3"].append(float((grads[k][s] - ref_g[k][s]).abs().max()))
            del ref_g
            for s in range(Sc):
                same["k2"] &= torch.equal(out[s], fused_mlp.fused_points(singles[s], x[s], v[s], 1))
                one, _, _ = fused_mlp.fused_points_bwd(singles[s], x[s], v[s], g[s].contiguous(), 1,
                                                       False)
                same["k3"] &= all(torch.equal(grads[k][s], t) for k, t in one.items())
            del out, grads
            torch.cuda.empty_cache()
            k2["ms"] += cuda_ms(lambda: fused_mlp.fused_points_stacked(kp, x, v, 1, blobs),
                                reps=10, warmup=2)
            k3["ms"] += cuda_ms(lambda: fused_mlp.fused_points_stacked_bwd(kp, x, v, g, 1, blobs),
                                reps=5, warmup=1)
            k2["plain_ms"] += cuda_ms(lambda: fused_mlp.fused_points_stacked_reference(kp, x, v, 1),
                                      reps=1)
            k3["plain_ms"] += cuda_ms(
                lambda: fused_mlp.fused_points_stacked_bwd_reference(kp, x, v, g, 1), reps=1)
        torch.cuda.empty_cache()
        for t, backward in ((k2, False), (k3, True)):
            chain = stacked_matmul_chain(kp, R * n2, backward)
            t["library_ms"] += cuda_ms(chain, reps=3)
            del chain
            torch.cuda.empty_cache()
        # x, v (a direction per point) in, raw out; K3: g in, the weights'
        # two layouts in and the grads out
        k2["ops_ms"] += 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
        k2["bytes_ms"] += 1e3 * (n_pts * (12 + 12 + 16) + wbytes) / PEAK_BYTES
        k3["ops_ms"] += 1e3 * Sc * fused_mlp.bwd_flops(cfg, pe_pts, pe_views, R * n2, 1) / PEAK_BF16_FLOPS
        k3["bytes_ms"] += 1e3 * (n_pts * (12 + 12 + 16) + 2 * wbytes + gbytes) / PEAK_BYTES
        k3_ws = fused_mlp.stacked_points_workspace_bytes(cfg.width, Sc, R * n2, 1) / 1e9
        del x, v, g
        torch.cuda.empty_cache()
        # the stacked K5 and K6
        ro, rd, vd, z = [torch.stack(t) for t in zip(*(make_rays(rng, R, n5, dev)
                                                         for _ in range(Sc)))]
        noise = torch.randn(Sc, R, n5, device=dev, generator=gen) * 0.5
        gm = [(0.5 + torch.rand(Sc, *sh, device=dev, generator=gen)) * 1e-4
              for sh in ((R, 3), (R,), (R,), (R, n5))]
        n_pts = Sc * R * n5
        with torch.no_grad():
            out = fused_render.fused_render_stacked_fwd(kp, ro, rd, vd, z, noise, True, blobs,
                                                        keep_raw=True)
            ref = fused_render.fused_render_stacked_reference(kp, ro, rd, vd, z, noise, True)
            flat = lambda m: fused_render.Maps(*(t.flatten(0, 1) for t in m[:4]), None)  # noqa: E731
            errs["k5"].append(check_maps(flat(out), flat(ref), BF16_TOL, kernel="K5s",
                                         dtype="bfloat16", stacked=Sc, R=R, S=n5))
            del ref
            grads = fused_render.fused_render_stacked_bwd(kp, ro, rd, vd, z, noise, out.raw, *gm,
                                                          True, blobs)
            ref_g = fused_render.fused_render_stacked_bwd_reference(kp, ro, rd, vd, z, noise,
                                                                    out.raw, *gm, True)
            for k in ref_g:
                for s in range(Sc):
                    rels["k6"].append(rel_l2(grads[k][s], ref_g[k][s]))
                    errs["k6"].append(float((grads[k][s] - ref_g[k][s]).abs().max()))
            del ref_g
            # k6_halves' method (ROADMAP C.2): the compositing pass alone
            # against its plain version (f32 on both sides), and the stacked
            # K4's phases and their bf16 plain version on the plain
            # cotangent, each against the f32 plain version on it
            flat = [t.flatten(0, 1) for t in (rd, z, noise, *gm)]
            raw_flat = out.raw.flatten(1, 2)
            planes = fused_render.composite_bwd(raw_flat, *flat[:3], *flat[3:], True)
            want = fused_render.composite_bwd_reference(raw_flat, *flat[:3], *flat[3:], True)
            halves["composite"].append(rel_l2(planes, want))
            want = want.view(4, Sc, R, n5)
            k4_half = fused_mlp.fused_rays_planes_stacked_bwd(kp, ro, rd, vd, z, want, blobs)
            plain_half = fused_mlp.fused_rays_planes_stacked_bwd_reference(kp, ro, rd, vd, z, want)
            f32_half = fused_mlp.fused_rays_planes_stacked_bwd_reference(kp32, ro, rd, vd, z, want)
            for key, got, ref_ in (("k4s_vs_plain", k4_half, plain_half),
                                   ("k4s_vs_f32", k4_half, f32_half),
                                   ("plain_vs_f32", plain_half, f32_half)):
                halves[key].append(max(rel_l2(got[k][s], ref_[k][s]) for k in got
                                       for s in range(Sc)))
            del planes, want, k4_half, plain_half, f32_half
            for s in range(Sc):
                one_in = [t[s] for t in (ro, rd, vd, z, noise)]
                one = fused_render.fused_render_fwd(singles[s], *one_in, True, keep_raw=True)
                same["k5"] &= all(same_bits(a[s], b) for a, b in zip(out[:4], one[:4]))
                single = fused_render.fused_render_bwd(singles[s], *one_in, one.raw,
                                                       *(t[s].contiguous() for t in gm), True)
                same["k6"] &= all(torch.equal(grads[k][s], t) for k, t in single.items())
            raw = out.raw
            del out, grads
            torch.cuda.empty_cache()
            fwd = (ro, rd, vd, z, None, True)  # training's: raw kept, no noise (configs/multi)
            k5["ms"] += cuda_ms(lambda: fused_render.fused_render_stacked_fwd(kp, *fwd, blobs,
                                                                               keep_raw=True),
                                reps=10, warmup=2)
            k6["ms"] += cuda_ms(lambda: fused_render.fused_render_stacked_bwd(
                kp, ro, rd, vd, z, noise, raw, *gm, True, blobs), reps=5, warmup=1)
            k5["plain_ms"] += cuda_ms(
                lambda: fused_render.fused_render_stacked_reference(kp, *fwd), reps=1)
            k6["plain_ms"] += cuda_ms(lambda: fused_render.fused_render_stacked_bwd_reference(
                kp, ro, rd, vd, z, noise, raw, *gm, True), reps=1)
        del raw
        torch.cuda.empty_cache()
        for t, backward in ((k5, False), (k6, True)):
            chain = stacked_matmul_chain(kp, R * n5, backward)
            t["library_ms"] += cuda_ms(chain, reps=3)
            del chain
            torch.cuda.empty_cache()
        # K5: rays and z in, rgb, disp, acc, w and the kept raw out; K6: rays,
        # z, noise, raw and g_w in a point, g_rgb/disp/acc a ray, the
        # weights' two layouts in, the grads out
        k5["ops_ms"] += 1e3 * n_pts * flops_pt / PEAK_BF16_FLOPS
        k5["bytes_ms"] += 1e3 * (Sc * R * (9 + 5) * 4 + n_pts * (4 + 4 + 16) + wbytes) / PEAK_BYTES
        k6["ops_ms"] += 1e3 * Sc * fused_mlp.bwd_flops(cfg, pe_pts, pe_views, R, n5) / PEAK_BF16_FLOPS
        k6["bytes_ms"] += 1e3 * (Sc * R * (9 + 5) * 4 + n_pts * (4 + 4 + 16 + 4) + 2 * wbytes
                                 + gbytes) / PEAK_BYTES
        phase("multi_kernels_points_render", level=level, scenes=Sc, R=R, k2_S=n2, k5_S=n5,
              k2_max_abs=f"{errs['k2'][-1]:.3e}", k3_worst_leaf_rel_l2=f"{max(rels['k3']):.3e}",
              k5_maps_max_abs=f"{errs['k5'][-1]:.3e}",
              k6_worst_leaf_rel_l2=f"{max(rels['k6']):.3e}", k4_tol=K4_BF16_TOL,
              k6_halves=", ".join(f"{k} {v[-1]:.3e}" for k, v in halves.items()),
              bit_equal_8_single=same, k3_workspace_gb=f"{k3_ws:.3f}",
              k6_workspace_gb=f"{fused_mlp.stacked_workspace_bytes(cfg.width, Sc, R, n5) / 1e9:.3f}")
        del ro, rd, vd, z, noise, gm
        torch.cuda.empty_cache()
    if not (all(same.values()) and max(rels["k3"]) <= K4_BF16_TOL
            and max(rels["k6"]) <= K4_BF16_TOL):
        raise RuntimeError(f"stacked K2/K3/K5/K6: bit-equal to 8 single launches {same}, K3 "
                           f"worst leaf {max(rels['k3'])}, K6 {max(rels['k6'])} "
                           f"(bound {K4_BF16_TOL})")
    for tag, t, samples in (("k2s_times", k2, "S=63 + S=191"), ("k3s_times", k3, "S=63 + S=191"),
                            ("k5s_times", k5, "S=64 + S=192"), ("k6s_times", k6, "S=64 + S=192")):
        print_stacked_times(tag, t, samples)
    return {"k2": k2, "k3": k3, "k5": k5, "k6": k6, "k2_err": max(errs["k2"]),
            "k3_err": max(errs["k3"]), "k5_err": max(errs["k5"]), "k6_err": max(errs["k6"])}


def multi_phase(one_scene: dict, root: str, dev) -> dict:
    """25. Multi-scene training: the port's tool writes the 8 scenes (fewer
    views) under ``root`` (phase 33 trains them again), then
    ``cli.train_multi.main`` with configs/multi/scene_0..7.txt for
    MULTI_STEPS steps with i_print and i_weights firing: exactly 2
    stacked K1 and 2 stacked K4 launches a step for all 8 scenes and
    nothing else of K1-K6, a finite loss a scene, 8 .tar files each loading
    into the one-scene model with the scene's trained weights; the same at
    63 + 128 samples (the stacked K2/K3) and with --fused_render (the
    stacked K5/K6: multi_path_run); the stacked kernels at the main shapes
    (multi_kernels); phase 7's windows on the stacked step of each of the
    three branches (multi_window), each scene's loss falling, beside scene
    0 trained alone on its config and phase 23's one-scene N_rand 1024
    numbers; then 2 gloo
    ranks on this card (4 scenes each)
    through ``distributed.launch``, scene by scene the one-process run's
    (and NCCL, a card a rank, with two or more cards)."""
    from nerf_tpu_torch.cli import train_multi
    from nerf_tpu_torch.models.factory import init_nets, make_model
    from nerf_tpu_torch.parallel import distributed
    from nerf_tpu_torch.parallel.multi_scene import scene_seed
    from nerf_tpu_torch.tools import make_multi_scenes

    here = os.getcwd()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    quiet(make_multi_scenes.write_scenes, os.path.join(root, "data", "nerf_synthetic"),
          MULTI_SCENES, MULTI_COUNTS, device=dev)
    write_s = time.perf_counter() - t0
    os.chdir(root)  # the configs' datadirs are relative
    try:
        argv = multi_argv(root, "cadence", MULTI_STEPS, MULTI_CADENCES)
        cfgs = train_multi.load_configs(argv)
        reset_counts()
        t0 = time.perf_counter()
        result, out = run_cli(train_multi.main, argv)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        check_counts(counts, {"K1s": 2 * MULTI_STEPS, "K4s": 2 * MULTI_STEPS,
                              "recompute": 2 * MULTI_STEPS, "chain": 2 * MULTI_STEPS},
                     f"cli.train_multi: {MULTI_STEPS} steps of {MULTI_SCENES} scenes")
        losses = np.stack([h[1] for h in result.history])
        prints = out.count("[TRAIN-MULTI] Iter")
        tars_ok = multi_tars_ok(cfgs, result, MULTI_STEPS, dev)
        phase("multi", scenes=MULTI_SCENES, views=f"{MULTI_COUNTS} of the tool's "
              f"{make_multi_scenes.COUNTS} (cut for time)", s_per_view=f"{write_s / MULTI_SCENES / sum(MULTI_COUNTS.values()):.3f}",
              steps=MULTI_STEPS, seconds=f"{seconds:.2f}", launches=counts, prints=prints,
              loss_first=[f"{v:.5f}" for v in losses[0]], loss_last=[f"{v:.5f}" for v in losses[-1]],
              tars_load_with_trained_weights=tars_ok)
        if not (np.isfinite(losses).all() and all(tars_ok) and
                prints == MULTI_STEPS // MULTI_CADENCES["i_print"]):
            raise RuntimeError(f"cli.train_multi: losses {losses}, tars {tars_ok}, prints {prints}")
        # the points-in and fused-render branches of the stacked step, at
        # full width: the stacked K2/K3 (63 + 191 samples) and K5/K6
        # (--fused_render, 64 + 192)
        path_counts = {
            "K2s": multi_path_run(root, "points", ["--N_samples=63"], "K2s", "K3s", dev),
            "K5s": multi_path_run(root, "fused_render", ["--fused_render"], "K5s", "K6s", dev)}
        kernels = multi_kernels(result.state.nets, dev)
        del result
        torch.cuda.empty_cache()

        # phase 7's windows on the stacked step (cadences off), on each branch
        ms_step, prof_out = multi_window(root, "timed", [], "K1s", "K4s", dev)
        windows = {flags[0]: multi_window(root, name, flags, fwd, bwd, dev)
                   for name, flags, fwd, bwd in (("timed_points", ["--N_samples=63"], "K2s", "K3s"),
                                                 ("timed_fr", ["--fused_render"], "K5s", "K6s"))}
        # one scene alone on the same recipe: scene 0 through train()
        from nerf_tpu_torch.config import load_config
        from nerf_tpu_torch.train.loop import load_scene

        cfg0 = load_config(["--config", multi_argv(root, "", 1, {})[1], "--data_axis=1",
                            f"--basedir={os.path.join(root, 'logs', 'alone')}",
                            f"--n_iters={WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS}", "--i_print=10", "--i_img=0", "--i_weights=0",
                            "--i_testset=0", "--i_video=0"])
        alone = timed_train(cfg0, load_scene(cfg0), dev, "K1", "K4", path="multi_scene_0_alone")
        single = one_scene["linemod"]  # configs/synth_linemod.txt: N_rand 1024, no_batching
        phase("multi_vs_one_scene", scenes=MULTI_SCENES,
              stacked_wall_ms_per_step=f"{prof_out['wall_ms_per_step']:.3f}",
              stacked_device_ms_per_step=f"{prof_out['device_ms_per_step']:.3f}",
              stacked_idle_share=f"{prof_out['idle_share']:.3f}",
              stacked_k1_ms_per_step=f"{prof_out['K1s_ms_per_step']:.3f}",
              stacked_k4_ms_per_step=f"{prof_out['K4s_ms_per_step']:.3f}",
              scene_0_alone_wall_ms_per_step=f"{alone['profile']['wall_ms_per_step']:.3f}",
              scene_0_alone_device_ms_per_step=f"{alone['profile']['device_ms_per_step']:.3f}",
              scene_0_alone_idle_share=f"{alone['profile']['idle_share']:.3f}",
              scene_0_alone_timed_ms_per_step=f"{alone['ms_per_step']:.3f}",
              one_scene="phase 23 linemod (N_rand 1024, 64+64, no_batching, precrop)",
              one_scene_wall_ms_per_step=f"{single['profile']['wall_ms_per_step']:.3f}",
              one_scene_device_ms_per_step=f"{single['profile']['device_ms_per_step']:.3f}",
              one_scene_idle_share=f"{single['profile']['idle_share']:.3f}",
              one_scene_timed_ms_per_step=f"{single['ms_per_step']:.3f}",
              stacked_timed_ms_per_step=f"{ms_step:.3f}")
        for flag, (ms, prof_b) in windows.items():
            fwd, bwd = ("K2s", "K3s") if "N_samples" in flag else ("K5s", "K6s")
            phase("multi_branch", flags=flag, scenes=MULTI_SCENES, timed_ms_per_step=f"{ms:.3f}",
                  wall_ms_per_step=f"{prof_b['wall_ms_per_step']:.3f}",
                  device_ms_per_step=f"{prof_b['device_ms_per_step']:.3f}",
                  idle_share=f"{prof_b['idle_share']:.3f}",
                  **{f"{k.lower()}_ms_per_step": f"{prof_b[f'{k}_ms_per_step']:.3f}"
                     for k in (fwd, bwd)},
                  raygen_device_ms_per_step=f"{prof_out['device_ms_per_step']:.3f}")

        # the scene axis over 2 gloo ranks on this card, against one process
        dp_args = multi_argv(root, "one", MULTI_DP_STEPS, MULTI_DP_CADENCES)
        one = multi_rank(dev, dp_args)
        torch.cuda.empty_cache()
        model = make_model(cfgs[0])
        start = [{lvl: {n: p.detach().cpu() for n, p in net.named_parameters()}
                  for lvl, net in init_nets(model, scene_seed(cfgs[0].seed, k), dev).items()}
                 for k in range(MULTI_SCENES)]
        backends = [("gloo", "cuda:0")]
        if torch.cuda.device_count() >= 2:
            backends.append(("nccl", "cuda"))
        for backend, where in backends:
            t0 = time.perf_counter()
            ranks = distributed.launch(multi_rank, MULTI_RANKS, where, backend=backend,
                                       args=(multi_argv(root, backend, MULTI_DP_STEPS,
                                                        MULTI_DP_CADENCES, MULTI_RANKS),))
            launch_s = time.perf_counter() - t0
            per = MULTI_SCENES // MULTI_RANKS
            worst, bit_equal = multi_check_ranks(ranks, one, start, per, backend)
            phase("multi_dp", backend=backend, ranks=MULTI_RANKS, devices=where,
                  scenes_per_rank=[r["scenes"] for r in ranks], steps=MULTI_DP_STEPS,
                  launches=[{k: v for k, v in r["counts"].items() if v} for r in ranks],
                  worst_weight_vs_one_process=f"{worst:.3e}", bit_equal=bit_equal,
                  launch_s=f"{launch_s:.2f}")
    finally:
        os.chdir(here)
    return {"counts": counts, "path_counts": path_counts, **kernels}


def multi_window(root: str, expname: str, flags, fwd: str, bwd: str, dev):
    """25. Phase 7's windows on the stacked step of cli.train_multi's
    train_multi with ``flags`` (cadences off): WARMUP_STEPS, then
    TIMED_STEPS timed with exactly 2 ``fwd`` and 2 ``bwd`` launches each and
    nothing else, every scene's loss falling (the mean of the first five
    steps against the last five), then PROFILED_STEPS under the profiler.
    Returns (ms/step, profile_report's numbers)."""
    from nerf_tpu_torch.cli import train_multi

    n_iters = WARMUP_STEPS + TIMED_STEPS + PROFILED_STEPS
    cfgs = train_multi.load_configs(multi_argv(root, expname, n_iters, {"i_print": 10,
                                                                        "i_weights": 0})
                                    + list(flags))
    step_losses, marks = [], {}
    end = WARMUP_STEPS + TIMED_STEPS
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])

    def on_step(i, state, aux):
        if i <= end:
            step_losses.append(aux["loss"])
        if i in (WARMUP_STEPS, end, end + PROFILED_STEPS):
            torch.cuda.synchronize()
            marks[i] = time.perf_counter()
            if i == WARMUP_STEPS:
                reset_counts()
            elif i == end:
                marks["counts"] = read_counts()
                prof.__enter__()
            else:
                prof.__exit__(None, None, None)

    with contextlib.redirect_stdout(io.StringIO()):
        train_multi.train_multi(cfgs, device=dev, hooks={"on_step": on_step})
    n = 2 * TIMED_STEPS
    check_counts(marks["counts"], {fwd: n, bwd: n, "recompute": n, "chain": n,
                                   **({"composite": n} if bwd == "K6s" else {})},
                 f"{TIMED_STEPS} timed stacked steps {' '.join(flags)}")
    per_step = torch.stack(step_losses).cpu().numpy()  # [steps, scenes]
    first, last = per_step[:5].mean(0), per_step[-5:].mean(0)
    ms_step = 1e3 * (marks[end] - marks[WARMUP_STEPS]) / TIMED_STEPS
    rays_s = MULTI_SCENES * cfgs[0].N_rand * 1e3 / ms_step
    phase("multi_train", flags=" ".join(flags) or "-",
          samples=f"{cfgs[0].N_samples}+{cfgs[0].N_importance}", scenes=MULTI_SCENES,
          steps=TIMED_STEPS, n_rand=cfgs[0].N_rand, ms_per_step=f"{ms_step:.3f}",
          rays_per_s=f"{rays_s:.0f}", loss_first5=[f"{v:.5f}" for v in first],
          loss_last5=[f"{v:.5f}" for v in last])
    if not (np.isfinite(per_step).all() and (last < first).all()):
        raise RuntimeError(f"stacked training {flags}: each scene's loss must fall: "
                           f"{first} -> {last}")
    prof_out = profile_report(prof, marks[end + PROFILED_STEPS] - marks[end], fwd, bwd,
                              path="multi " + (" ".join(flags) or "-"))
    return ms_step, prof_out


def multi_tars_ok(cfgs, result, steps: int, dev):
    """For each scene, whether its .tar at ``steps`` loads into the
    one-scene model with the scene's trained weights."""
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.utils import checkpoint

    model = make_model(cfgs[0])
    ok = []
    for k, cfg in enumerate(cfgs):
        tar = os.path.join(cfg.basedir, cfg.expname, f"{steps:06d}.tar")
        loaded = checkpoint.load_checkpoint(tar, model, cfg.lrate, dev)
        ok.append(all(torch.equal(p, result.state.nets[lvl].scene_state_dict(k)[n])
                      for lvl, net in loaded.nets.items() for n, p in net.named_parameters()))
    return ok


def multi_path_run(root: str, expname: str, flags, fwd: str, bwd: str, dev) -> dict:
    """25. ``cli.train_multi.main`` on configs/multi's 8 scenes with
    ``flags`` (another branch of the stacked step) for MULTI_STEPS steps,
    i_print every MULTI_PATH_PRINT and i_weights firing: exactly 2 ``fwd``
    and 2 ``bwd`` stacked launches a step for all 8 scenes (each ``bwd``
    one recompute and one chain; K6s also one compositing pass) and nothing
    else of K1-K6, no call of the stacked plain MLP, each scene's loss
    finite and falling (the mean of the first two prints against the last
    two), 8 .tar files each loading into the one-scene model with the
    scene's trained weights. Returns the launch counts."""
    from nerf_tpu_torch.cli import train_multi
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    argv = multi_argv(root, expname, MULTI_STEPS, {"i_print": MULTI_PATH_PRINT,
                                                   "i_weights": MULTI_STEPS}) + list(flags)
    cfgs = train_multi.load_configs(argv)
    plain = StackedNeRFMLP.plain_calls
    reset_counts()
    t0 = time.perf_counter()
    result, _ = run_cli(train_multi.main, argv)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    plain = StackedNeRFMLP.plain_calls - plain
    n = 2 * MULTI_STEPS
    want = {fwd: n, bwd: n, "recompute": n, "chain": n, **({"composite": n} if bwd == "K6s" else {})}
    check_counts(counts, want, f"cli.train_multi {' '.join(flags)}: {MULTI_STEPS} steps of "
                               f"{MULTI_SCENES} scenes")
    losses = np.stack([h[1] for h in result.history])  # [prints, scenes]
    first, last = losses[:2].mean(0), losses[-2:].mean(0)
    tars_ok = multi_tars_ok(cfgs, result, MULTI_STEPS, dev)
    phase("multi_path", flags=" ".join(flags), samples=f"{cfgs[0].N_samples}+{cfgs[0].N_importance}",
          scenes=MULTI_SCENES, steps=MULTI_STEPS, seconds=f"{seconds:.2f}", launches=counts,
          stacked_plain_mlp_calls=plain, loss_first2=[f"{v:.5f}" for v in first],
          loss_last2=[f"{v:.5f}" for v in last], tars_load_with_trained_weights=tars_ok)
    if plain or not (np.isfinite(losses).all() and (last < first).all() and all(tars_ok)):
        raise RuntimeError(f"cli.train_multi {flags}: plain MLP calls {plain}, losses {losses}, "
                           f"tars {tars_ok}")
    del result
    torch.cuda.empty_cache()
    return counts


def multi_check_ranks(ranks, one, start, per: int, what: str):
    """Each rank trained its contiguous scenes with 2 stacked K1 + 2 K4 a
    step, and each scene as the one-process run did: its loss at each
    i_print within DP_LOSS_RTOL, its weights within 4 lr and each leaf's
    update within DP_UPDATE_TOL (phase 24's bounds). Returns the worst
    weight difference and whether every weight is equal."""
    worst, equal = 0.0, True
    for r, rank in enumerate(ranks):
        mine = list(range(r * per, (r + 1) * per))
        want = {"K1s": 2 * MULTI_DP_STEPS, "K4s": 2 * MULTI_DP_STEPS,
                "recompute": 2 * MULTI_DP_STEPS, "chain": 2 * MULTI_DP_STEPS}
        check_counts(rank["counts"], want, f"multi {what} rank {r}")
        if rank["scenes"] != mine:
            raise RuntimeError(f"multi {what}: rank {r} trained scenes {rank['scenes']}")
        for (_, got, _), (_, ref, _) in zip(rank["history"], one["history"]):
            np.testing.assert_allclose(got, ref[mine], rtol=DP_LOSS_RTOL)
        for j, k in enumerate(mine):
            for lvl, params in rank["params"].items():
                for name, p in params.items():
                    w, p0 = one["params"][lvl][name][k], start[k][lvl][name]
                    d = float((p[j] - w).abs().max())
                    worst, equal = max(worst, d), equal and d == 0.0
                    moved = float(torch.linalg.norm(w - p0))
                    if d > 4 * MULTI_LRATE or (moved > 0 and float(torch.linalg.norm(p[j] - w)) / moved > DP_UPDATE_TOL):
                        raise RuntimeError(f"multi {what}: scene {k} {lvl}.{name} off the "
                                           f"one-process run by {d}")
    return worst, equal


# the wide family (phases 26-28, csrc/fused_mlp_wide.cu): its kernels'
# names in a profile (forward and backward share the GEMM), the card tests'
# configurations (width, point and view octaves) and shapes (R, S), the W =
# 512 path's width (NeRF in the Wild's MLP) and the 16-octave path's
# octaves (mip-NeRF's 16 point degrees), and the training windows'
# (warm-up, timed, profiled) steps: 24 at W = 512, 8 on the other branches
WIDE_KERNELS = ("gemm_bf16_sm90", "gemm_f32", "embed_cols", "head_cols", "gc_rows", "ray_sums",
                "embed_backward_cols", "wgrad_bf16", "reduce_splits", "reduce_tiles",
                "composite_planes", "composite_bwd")
WIDE_CONFIGS = ((384, 10, 4), (512, 10, 4), (1024, 10, 4), (256, 16, 6))
WIDE_CASES = ((1, 1), (127, 1), (129, 1), (531, 64))
# the main path's shapes at W = 512 (phases 27-28), bf16: (R, S, kernels,
# slices of the plain forward): 4,096 rays at 64 and 1,024 at 192 samples
# (a training step's levels, K5w and K6w with --fused_render), 63 and 191
# (the points-in levels), and a serving frame's 8,192 rays at 192 and 191
# samples, 1.5M points: past the forwards' SLICE_POINTS
WIDE_PATH_CASES = ((4096, 64, ("K1w", "K4w", "K5w", "K6w"), 1),
                   (1024, 192, ("K1w", "K4w", "K5w", "K6w"), 1),
                   (4096, 63, ("K2w", "K3w"), 1), (1024, 191, ("K2w", "K3w"), 1),
                   (8192, 192, ("K1w", "K5w"), 4), (8192, 191, ("K2w",), 4))
# the bf16 grads' witness (wide_witness): the card tests' worst cases
# (K4w/K3w at W = 1024 on 127 and 129 points, K6w on 127 rays x 8)
WIDE_WITNESS_WIDTH = 1024
WIDE_WITNESS_CASES = ((127, 1), (129, 1), (127, 8), (129, 8))
WIDE_WIDTH, WIDE_OCTAVES = 512, (16, 6)
WIDE_STEPS, WIDE_SHORT_STEPS = (3, 18, 3), (2, 4, 2)
# the card tests' bounds (tests/test_torch_port_kernels.py, measured there):
# f32 raw 1e-5; grads per-leaf relative L2, bf16 3e-2 and f32 5e-4; dx and
# dv bf16 5e-2 and f32 2e-3; bf16 raw and maps phase 3's BF16_TOL. The bf16
# grads' bound is the two roundings' distance: wide_witness holds it so
WIDE_F32_TOL = 1e-5
WIDE_GRAD_TOL = {torch.bfloat16: 3e-2, torch.float32: 5e-4}
WIDE_INPUT_GRAD_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-3}


def wide_net(W: int, fp: int, fv: int, dtype, seed: int, dev):
    """(MLPConfig, point and view PosEncConfig, packed params) of a random
    net of a wide configuration."""
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp

    cfg = MLPConfig(width=W, input_ch=3 + 6 * fp, input_ch_views=3 + 6 * fv)
    pp, pv = PosEncConfig(fp), PosEncConfig(fv)
    with torch.no_grad():
        kp = fused_mlp.pack_params(NeRFMLP(cfg, seed=seed, device=dev), pp, pv, dtype)
    if not (fused_mlp.supports(cfg, pp, pv) and fused_mlp.is_wide(kp)):
        raise RuntimeError(f"{W} {fp}/{fv} is not a wide configuration")
    return cfg, pp, pv, kp


def maps_err(got, ref) -> float:
    """The largest |difference| of rgb, disp (where finite), acc and w."""
    errs = []
    for a, b in zip(got[:4], ref[:4]):
        if not torch.equal(torch.isfinite(a), torch.isfinite(b)):
            raise RuntimeError("the maps are finite at other rays than their plain version's")
        f = torch.isfinite(b)
        errs.append(float((a[f] - b[f]).abs().max()))
    return max(errs)


def wide_case(kp, R: int, S: int, names, rng, gen, dev, input_grads: bool = True,
              parts: int = 1) -> dict:
    """One case of phase 26: each named wide kernel (K1w, K2w, K4w, K3w,
    K5w, K6w) called once on R rays of S samples (K2w and K3w on their
    points, a direction per ray; K3w's dx and dv with ``input_grads``),
    against its plain version on the same inputs (the forwards' over
    ``parts`` slices of the rays): {name: error}, the forwards' max abs of
    raw or the maps, the backwards' worst per-leaf relative L2 for a
    one-signed cotangent. Fails unless each call was counted once, no other
    kernel's counter moved, the raw is finite and the maps are finite where
    the plain maps are."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp

    ro, rd, vd, z = make_rays(rng, R, S, dev)
    x = fused_mlp._ray_points(ro, rd, z)
    g = (0.5 + torch.rand(4, R, S, device=dev, generator=gen)) * 1e-4
    g_rows = g.reshape(4, -1).T.contiguous()

    def in_parts(fn, *ts):  # fn over ``parts`` slices of the rays
        return [fn(*part) for part in zip(*(t.chunk(parts) for t in ts))]

    e, out = {}, []  # out: the raw planes, to be finite
    reset_counts()
    with torch.no_grad():  # the wrappers alone, no autograd
        if "K1w" in names:
            out.append(fused_mlp.fused_rays_planes(kp, ro, rd, vd, z))
            ref = torch.cat(in_parts(lambda *a: fused_mlp.fused_rays_planes_reference(kp, *a),
                                     ro, rd, vd, z), 1)
            e["K1w"] = float((out[-1] - ref).abs().max())
            del ref
        if "K2w" in names:
            out.append(fused_mlp.fused_points(kp, x, vd, S))
            ref = torch.cat(in_parts(lambda *a: fused_mlp.fused_points_reference(kp, *a, S),
                                     x, vd))
            e["K2w"] = float((out[-1] - ref).abs().max())
            del ref
        if "K4w" in names:
            got = fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, g)
            ref = fused_mlp.fused_rays_planes_bwd_reference(kp, ro, rd, vd, z, g)
            e["K4w"] = max(rel_l2(got[n], ref[n]) for n in fused_mlp.KP_NAMES)
            del got, ref
        if "K3w" in names:
            got, dx, dv = fused_mlp.fused_points_bwd(kp, x, vd, g_rows, S, input_grads)
            ref, rdx, rdv = fused_mlp.fused_points_bwd_reference(kp, x, vd, g_rows, S,
                                                                 input_grads)
            e["K3w"] = max(rel_l2(got[n], ref[n]) for n in fused_mlp.KP_NAMES)
            if input_grads:
                e["dx"], e["dv"] = rel_l2(dx, rdx), rel_l2(dv, rdv)
            del got, ref
        if "K5w" in names:
            noise = torch.randn(R, S, device=dev, generator=gen) * 0.5
            maps = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, True,
                                                 keep_raw="K6w" in names)
            ref5 = [torch.cat(m) for m in zip(*(m[:4] for m in in_parts(
                lambda *a: fused_render.fused_render_reference(kp, *a, True),
                ro, rd, vd, z, noise)))]
            e["K5w"] = maps_err(maps, ref5)  # finite where the plain maps are
            del ref5
        if "K6w" in names:
            cot = [(0.5 + torch.rand(t.shape, device=dev, generator=gen)) * 1e-3
                   for t in maps[:4]]
            got = fused_render.fused_render_bwd(kp, ro, rd, vd, z, noise, maps.raw, *cot, True)
            ref = fused_render.fused_render_bwd_reference(kp, ro, rd, vd, z, noise, maps.raw,
                                                          *cot, True)
            e["K6w"] = max(rel_l2(got[n], ref[n]) for n in fused_mlp.KP_NAMES)
            del got, ref
    torch.cuda.synchronize()
    want = {k: 1 for k in names}
    if "K6w" in names:
        want["composite"] = 1  # K6w's compositing pass
    check_counts(read_counts(), want, f"wide R={R} S={S} {'+'.join(names)}")
    if not all(bool(torch.isfinite(t).all()) for t in out):
        raise RuntimeError(f"wide R={R} S={S}: K1w's or K2w's raw is not finite")
    return e


def wide_witness(kp, kp32, R: int, S: int, rng, gen, dev) -> dict:
    """26, the bf16 grads' witness: K4w's, K3w's (with dx, dv) and, at S %
    8 == 0, K6w's bf16 grads and their bf16 plain versions', each leaf's
    relative L2 from the f32 plain version on the same weights (``kp32``)
    and inputs: {name: (kernel's worst leaf, plain version's worst leaf,
    the largest ratio of a leaf's two, the plain one at least 1e-3)}. Fails
    if the kernel is on any leaf more than twice as far from f32 as
    the bf16 plain version, plus 1e-3: a kernel-against-plain distance of
    the bound's size is then the two roundings', not the kernel's."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp

    ro, rd, vd, z = make_rays(rng, R, S, dev)
    x = fused_mlp._ray_points(ro, rd, z)
    g = (0.5 + torch.rand(4, R, S, device=dev, generator=gen)) * 1e-4
    g_rows = g.reshape(4, -1).T.contiguous()
    with torch.no_grad():
        runs = {"K4w": [fused_mlp.fused_rays_planes_bwd(kp, ro, rd, vd, z, g)] + [
            fused_mlp.fused_rays_planes_bwd_reference(k, ro, rd, vd, z, g) for k in (kp, kp32)]}
        k3 = [fused_mlp.fused_points_bwd(kp, x, vd, g_rows, S, True)] + [
            fused_mlp.fused_points_bwd_reference(k, x, vd, g_rows, S, True) for k in (kp, kp32)]
        runs["K3w"] = [dict(t[0], dx=t[1], dv=t[2]) for t in k3]
        if S % 8 == 0:
            noise = torch.randn(R, S, device=dev, generator=gen) * 0.5
            maps = fused_render.fused_render_fwd(kp, ro, rd, vd, z, noise, True, keep_raw=True)
            raw32 = fused_mlp.fused_rays_planes_reference(kp32, ro, rd, vd, z).contiguous()
            cot = [(0.5 + torch.rand(t.shape, device=dev, generator=gen)) * 1e-3
                   for t in maps[:4]]
            runs["K6w"] = [fused_render.fused_render_bwd(kp, ro, rd, vd, z, noise, maps.raw,
                                                         *cot, True)] + [
                fused_render.fused_render_bwd_reference(k, ro, rd, vd, z, noise, raw, *cot, True)
                for k, raw in ((kp, maps.raw), (kp32, raw32))]
    out = {}
    for name, (got, plain, f32) in runs.items():
        d = {n: (rel_l2(got[n], f32[n]), rel_l2(plain[n], f32[n])) for n in got}
        bad = [n for n, (a, b) in d.items() if not a <= 2 * b + 1e-3]
        out[name] = (max(a for a, _ in d.values()), max(b for _, b in d.values()),
                     max(a / max(b, 1e-3) for a, b in d.values()))
        phase("wide_witness", R=R, S=S, kernel=name,
              kernel_vs_f32=f"{out[name][0]:.3e}", plain_vs_f32=f"{out[name][1]:.3e}",
              worst_leaf_ratio=f"{out[name][2]:.2f}",
              **{f"{n}": f"{a:.2e}/{b:.2e}" for n, (a, b) in d.items() if n in ("dx", "dv")})
        if bad:
            raise RuntimeError(f"wide {name} R={R} S={S}: farther from f32 than its bf16 plain "
                               f"version on {bad}: {[d[n] for n in bad]}")
    return out


def wide_kernel_phase(dev) -> dict:
    """26. The wide family against its plain versions: at the card tests'
    configurations and shapes (bf16 at W = 384, 512, 1024 with 10 / 4
    octaves and at W = 256 with 16 / 6; f32 at 384; S = 64 adds K5w and
    K6w); at W = 512 at the main path's shapes (``WIDE_PATH_CASES``: a
    training step's levels, the points-in levels with a direction per ray
    and no input grads, and a forward past ``SLICE_POINTS``); and, at W =
    1024, the bf16 grads' distance from f32 beside the bf16 plain
    version's (``wide_witness``); then the times (``wide_times``). Returns
    the bf16 errors' maxima, the witness and the times."""
    from nerf_tpu_torch.ops import fused_mlp_wide

    names = ("K1w", "K2w", "K3w", "K4w", "K5w", "K6w")
    errs = {k: 0.0 for k in names}
    rng = np.random.default_rng(26)
    gen = torch.Generator(device=dev).manual_seed(26)
    cases = [(c, torch.bfloat16) for c in WIDE_CONFIGS] + [((384, 10, 4), torch.float32)]
    path_cases = [(R, S, kernels, parts, False) for R, S, kernels, parts in WIDE_PATH_CASES]
    if not any(R * S > fused_mlp_wide.SLICE_POINTS for R, S, *_ in path_cases):
        raise RuntimeError("no case of phase 26 is past the forwards' slice")
    witness = {}
    for (W, fp, fv), dtype in cases:
        _, _, _, kp = wide_net(W, fp, fv, dtype, W + fp, dev)
        bf16 = dtype == torch.bfloat16
        ftol = BF16_TOL if bf16 else WIDE_F32_TOL
        gtol, itol = WIDE_GRAD_TOL[dtype], WIDE_INPUT_GRAD_TOL[dtype]
        todo = [(R, S, names if S % 8 == 0 else names[:4], 1, True) for R, S in WIDE_CASES]
        if bf16 and (W, fp, fv) == (WIDE_WIDTH, 10, 4):
            todo += path_cases
        for R, S, kernels, parts, input_grads in todo:
            e = wide_case(kp, R, S, kernels, rng, gen, dev, input_grads, parts)
            phase("wide", config=f"W={W},{fp}/{fv}", dtype=str(dtype).split(".")[-1], R=R, S=S,
                  **{k: f"{v:.3e}" for k, v in e.items()}, raw_tol=ftol, grad_tol=gtol,
                  input_grad_tol=itol)
            bad = [k for k, v in e.items()
                   if not v <= (ftol if k in ("K1w", "K2w", "K5w") else
                                itol if k in ("dx", "dv") else gtol)]
            if bad:
                raise RuntimeError(f"wide kernels disagree with their plain versions: {bad} {e}")
            if bf16:
                for k in names:
                    errs[k] = max(errs[k], e.get(k, 0.0))
            torch.cuda.empty_cache()
        if bf16 and W == WIDE_WITNESS_WIDTH:
            _, _, _, kp32 = wide_net(W, fp, fv, torch.float32, W + fp, dev)
            for R, S in WIDE_WITNESS_CASES:
                witness[(R, S)] = wide_witness(kp, kp32, R, S, rng, gen, dev)
            del kp32
            torch.cuda.empty_cache()
    return {"errs": errs, "witness": witness, "gemm": wide_gemm_phase(dev),
            "times": wide_times(dev), "split": wide_split_phase()}


# the wide GEMM alone (phase 26, gemm_bf16_sm90): M at and around the
# 64-row warpgroup and 128-row tile edges, one and three scenes
WIDE_GEMM_MS = (4, 8, 128, 192, 256, 320, 448, 512, 1024)


def wide_gemm_phase(dev) -> float:
    """26, the GEMM alone against PlainOps.gemm (its plain version) on the
    same operands, bf16: for each M of WIDE_GEMM_MS, one and three scenes
    (each its own weights, bias and per-view terms), a scene's points one
    256-point tile or several, one source or two (k = 4 .. 264), and each
    epilogue step in turn (relu, mask, per-view term, bias partials, bf16
    and f32 rows); then one tile whose four 64-point swizzle atoms of B
    hold other constants (a wrong atom stride reads another atom's). Fails
    where an output is off by more than 2^-7 of its largest |value| (an
    ulp of bf16: both sides round the same f32 sums of the same products,
    in another order) or a bias partial past 1e-3 of its largest, or a
    second launch's rows are not bit-identical. Returns the largest error
    relative to the largest |value|."""
    from nerf_tpu_torch.ops import fused_mlp_wide as wide

    ops, plain = wide.Ops(torch.bfloat16, dev), wide.PlainOps()
    gen = torch.Generator(device=dev).manual_seed(26)
    rnd = lambda *shape: torch.randn(*shape, device=dev, generator=gen)  # noqa: E731
    opts = ({}, {"relu": True}, {"mask": True}, {"add": 64}, {"relu": True, "add": 8})
    worst = 0.0
    for scenes in (1, 3):
        for i, M in enumerate(WIDE_GEMM_MS):
            C = wide.TILE * (1 + i % 3)
            N = scenes * C
            k0, k1 = (64, 0) if i % 2 else (192 + 8 * i, 4 + 8 * i)
            opt = opts[(i + scenes) % len(opts)]
            lda = lambda k: -(-(k + 8) // 8) * 8  # noqa: E731  rows 16-byte aligned
            a0 = rnd(scenes, M, lda(k0)).to(torch.bfloat16)
            srcs = [(a0 if scenes > 1 else a0[0], k0, rnd(k0, N).to(torch.bfloat16))]
            if k1:
                a1 = rnd(scenes, M, lda(k1)).to(torch.bfloat16)
                srcs.append((a1 if scenes > 1 else a1[0], k1, rnd(k1, N).to(torch.bfloat16)))
            bias = rnd(scenes, M)
            kw = dict(bias=bias if scenes > 1 else bias[0], relu=opt.get("relu", False),
                      scenes=scenes)
            if "mask" in opt:
                kw["mask"] = rnd(M, N).to(torch.bfloat16)
            if "add" in opt:
                add = rnd(M, scenes, C // opt["add"]).permute(1, 0, 2)
                kw.update(add=add if scenes > 1 else add[0], add_div=opt["add"])
            got = [torch.full((M, N), float("nan"), dtype=torch.bfloat16, device=dev),
                   torch.full((M, N), float("nan"), device=dev),
                   torch.full((N // wide.TILE, M), float("nan"), device=dev)]
            want = [torch.empty_like(t) for t in got]
            ops.gemm(M, N, srcs, out=got[0], out32=got[1], bsum=got[2], **kw)
            again = torch.empty_like(got[0])
            ops.gemm(M, N, srcs, out=again, **kw)
            plain.gemm(M, N, srcs, out=want[0], out32=want[1], bsum=want[2], **kw)
            torch.cuda.synchronize()
            scale = float(want[1].abs().max())
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got[:2], want[:2]))
            berr = float((got[2] - want[2]).abs().max()) / max(float(want[2].abs().max()), 1e-30)
            same = torch.equal(got[0], again)
            worst = max(worst, err / scale)
            phase("wide_gemm", scenes=scenes, M=M, C=C, k=f"{k0}+{k1}", opts=opt or "bias",
                  max_abs=f"{err:.3e}", of=f"{scale:.3e}", bsum_rel=f"{berr:.2e}",
                  second_launch_bit_equal=same)
            if not (err <= 2.0 ** -7 * scale and berr <= 1e-3 and same):
                raise RuntimeError(f"wide GEMM S={scenes} M={M}: {err} of {scale}, bsum {berr}, "
                                   f"bit-equal {same}")
    a = torch.zeros(128, 64, device=dev, dtype=torch.bfloat16)
    a[:, 0] = 1  # C[m][n] = B[0][n]
    b = torch.full((64, wide.TILE), 100.0, device=dev, dtype=torch.bfloat16)
    b[0] = (torch.arange(wide.TILE, device=dev) // 64 + 1).to(torch.bfloat16)
    out = torch.full((128, wide.TILE), float("nan"), device=dev)
    ops.gemm(128, wide.TILE, [(a, 64, b)], out32=out)
    torch.cuda.synchronize()
    atoms = [float(v) for v in out[0, ::64]]
    phase("wide_gemm_swizzle_atoms", atom_values=atoms, want=[1.0, 2.0, 3.0, 4.0])
    if not torch.equal(out, b[0].float().expand(128, -1)):
        raise RuntimeError(f"the wide GEMM read B's swizzle atoms out of place: {atoms}")
    return worst


def wide_split_phase() -> dict:
    """26, the split: K1w on a 32,768-ray chunk and K4w on an N_rand 4096
    step (64 + 192 samples, W = 512) profiled by kernel name
    (tools/wide_split.py, which also profiles another checkout)."""
    from nerf_tpu_torch.tools import wide_split

    with contextlib.redirect_stdout(io.StringIO()) as out:
        wide_split.main()
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    for key in ("K1w_per_chunk", "K4w_per_step"):
        phase("wide_split", per=key, **{k: f"{v}" for k, v in res[key].items() if v})
    launches = res["wgrad_launches"]
    phase("wide_split", kernel="wgrad_bf16 (thread-block clusters, TMA multicast)",
          **{f"S={S}": f"cluster {v['cluster']}x1x1, grid {v['grid_x']}x{v['grid_y']}, "
                       f"{v['problems']} problems" for S, v in zip((64, 192), launches)})
    if len(launches) != 2 or any(v["cluster"] < 2 or v["problems"] != 14 for v in launches):
        raise RuntimeError(f"K4w's weight grads: not one cluster launch of 14 problems a call: "
                           f"{launches}")
    torch.cuda.empty_cache()
    return res


def sliced(fn, tensors, parts: int, dim: int = 0):
    """fn over ``parts`` equal slices of the tensors along ``dim`` (the
    plain versions at the timed shapes, within the card's memory)."""
    def run():
        n = tensors[0].shape[dim]
        for i in range(parts):
            fn(*(t.narrow(dim, i * n // parts, n // parts) for t in tensors))
    return run


def wide_times(dev) -> dict:
    """26, times: each wide kernel at W = 512 with 10 / 4 octaves beside its
    bound, its plain version (over slices of the work) and the same products
    as bf16 torch.matmul: K1w, K2w (63 + 191, a direction per point) and K5w
    (serving, no raw kept) per 32,768-ray chunk; K4w, K3w (63 + 191, no
    input grads) and K6w per N_rand 4096 step."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.ops import fused_mlp

    cfg, pp, pv, kp = wide_net(WIDE_WIDTH, 10, 4, torch.bfloat16, 7, dev)
    blobs = fused_mlp.kernel_blobs(kp)
    wbytes = sum(t.numel() * t.element_size() for t in blobs)
    gbytes = 4 * sum(v.numel() for v in kp.values())
    flops_pt = fused_mlp.flops_per_point(cfg, pp, pv)
    keys = ("ms", "plain_ms", "ops_ms", "bytes_ms", "library_ms")
    t = {k: dict.fromkeys(keys, 0.0) for k in ("K1w", "K2w", "K3w", "K4w", "K5w", "K6w")}
    rng = np.random.default_rng(27)

    def add(name, ms, plain_ms, flops, io_bytes, library_ms, **fields):
        ops_ms, bytes_ms = 1e3 * flops / PEAK_BF16_FLOPS, 1e3 * io_bytes / PEAK_BYTES
        for k, v in zip(keys, (ms, plain_ms, ops_ms, bytes_ms, library_ms)):
            t[name][k] += v
        phase("wide_times", kernel=name, **fields, ms=f"{ms:.3f}",
              bound_ms=f"{max(ops_ms, bytes_ms):.3f}", plain_ms=f"{plain_ms:.3f}",
              library_ms=f"{library_ms:.3f}", tflops=f"{flops / ms / 1e9:.1f}")

    with torch.no_grad():
        for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):  # a serving chunk
            rays = make_rays(rng, CHUNK, S, dev)
            n = CHUNK * S
            chain = matmul_chain(kp, n)
            library_ms = cuda_ms(chain, reps=3)
            del chain
            torch.cuda.empty_cache()
            add("K1w", cuda_ms(lambda: fused_mlp.fused_rays_planes(kp, *rays, blobs), reps=3),
                cuda_ms(sliced(lambda *a: fused_mlp.fused_rays_planes_reference(kp, *a), rays, 8),
                        reps=1),
                n * flops_pt, CHUNK * 9 * 4 + n * 20 + wbytes, library_ms, per="chunk", S=S)
            add("K5w", cuda_ms(lambda: fused_render.fused_render_fwd(kp, *rays, None, True, blobs),
                               reps=3),
                cuda_ms(sliced(lambda *a: fused_render.fused_render_reference(kp, *a, None, True),
                               rays, 8), reps=1),
                n * flops_pt, CHUNK * (9 * 4 + 20) + n * 8 + wbytes, library_ms, per="chunk", S=S)
            del rays
            x, v = ray_points(rng, CHUNK, S - 1, 1, dev)
            n = CHUNK * (S - 1)
            chain = matmul_chain(kp, n)
            library_ms = cuda_ms(chain, reps=3)
            del chain
            torch.cuda.empty_cache()
            add("K2w", cuda_ms(lambda: fused_mlp.fused_points(kp, x, v, 1, blobs), reps=3),
                cuda_ms(sliced(lambda *a: fused_mlp.fused_points_reference(kp, *a, 1), (x, v), 8),
                        reps=1),
                n * flops_pt, n * 40 + wbytes, library_ms, per="chunk", S=S - 1)
            del x, v
            torch.cuda.empty_cache()
    for S in (N_SAMPLES, N_SAMPLES + N_IMPORTANCE):  # a training step
        rays = make_rays(rng, N_RAND, S, dev)
        n = N_RAND * S
        g = torch.rand(4, N_RAND, S, device=dev) * 1e-4
        chain = backward_matmul_chain(kp, n)
        library_ms = cuda_ms(chain, reps=3)
        del chain
        torch.cuda.empty_cache()
        flops = fused_mlp.bwd_flops(cfg, pp, pv, N_RAND, S)
        io_bytes = N_RAND * 9 * 4 + n * 20 + wbytes + gbytes
        add("K4w", cuda_ms(lambda: fused_mlp.fused_rays_planes_bwd(kp, *rays, g, blobs), reps=3),
            cuda_ms(sliced(lambda *a: fused_mlp.fused_rays_planes_bwd_reference(kp, *a[:4], a[4].permute(2, 0, 1)),
                           (*rays, g.permute(1, 2, 0)), 4), reps=1),
            flops, io_bytes, library_ms, per="step", S=S)
        with torch.no_grad():
            maps = fused_render.fused_render_fwd(kp, *rays, None, True, blobs, keep_raw=True)
        cot = [torch.rand(m.shape, device=dev) * 1e-3 for m in maps[:4]]
        raw_r = maps.raw.permute(1, 2, 0)  # rays first, for the slices
        add("K6w", cuda_ms(lambda: fused_render.fused_render_bwd(kp, *rays, None, maps.raw, *cot,
                                                                  True, blobs), reps=3),
            cuda_ms(sliced(lambda *a: fused_render.fused_render_bwd_reference(
                kp, *a[:4], None, a[4].permute(2, 0, 1), *a[5:], True), (*rays, raw_r, *cot), 4),
                reps=1),
            flops, io_bytes + n * 24 + N_RAND * 32, library_ms, per="step", S=S)
        del maps, cot, raw_r, rays, g
        x, v = ray_points(rng, N_RAND, S - 1, 1, dev)
        n = N_RAND * (S - 1)
        gp = torch.rand(n, 4, device=dev) * 1e-4
        chain = backward_matmul_chain(kp, n)
        library_ms = cuda_ms(chain, reps=3)
        del chain
        torch.cuda.empty_cache()
        add("K3w", cuda_ms(lambda: fused_mlp.fused_points_bwd(kp, x, v, gp, 1, False, blobs),
                           reps=3),
            cuda_ms(sliced(lambda *a: fused_mlp.fused_points_bwd_reference(kp, *a[:2], a[2], 1,
                                                                             False), (x, v, gp), 4),
                    reps=1),
            fused_mlp.bwd_flops(cfg, pp, pv, n, 1), n * 40 + wbytes + gbytes, library_ms,
            per="step", S=S - 1)
        del x, v, gp
        torch.cuda.empty_cache()
    for name, v in t.items():
        bound = max(v["ops_ms"], v["bytes_ms"])
        phase("wide_times", kernel=name, per="chunk" if name in ("K1w", "K2w", "K5w") else "step",
              ms=f"{v['ms']:.3f}", bound_ms=f"{bound:.3f}", x_bound=f"{v['ms'] / bound:.2f}",
              plain_ms=f"{v['plain_ms']:.3f}", library_ms=f"{v['library_ms']:.3f}",
              x_library=f"{v['ms'] / v['library_ms']:.2f}")
    return t


def wide_path_phase(scene, views, dev) -> dict:
    """27. The lego recipe at --netwidth 512 --netwidth_fine 512 (NeRF in
    the Wild's width; 64 + 128, N_rand 4096, bf16) on phase 7's teacher
    views: train() for 24 steps with phase 7's timed window and profile, 2
    K1w and 2 K4w a step; one 400x400 frame through render_path (2 K1w a
    chunk) against the plain path on 4,096 of its rays; 8 steps at
    --N_samples 63 (2 K2w + 2 K3w a step) and with --fused_render (2 K5w + 2
    K6w a step, each K6w one compositing pass). 28. The same recipe at W =
    256 with --multires 16 --multires_views 6 (mip-NeRF's 16 point degrees):
    8 steps, 2 K1w + 2 K4w a step. In every window no other kernel and no
    call of the single-scene plain MLP, and the loss falls. Returns the
    wide kernels' launches over these runs."""
    from nerf_tpu_torch import config
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.train.loop import render_path, render_settings_from_config

    here = os.path.dirname(os.path.abspath(__file__))

    def lego(steps, *extra):
        return config.load_config([
            f"--config={os.path.join(here, 'configs', 'lego.txt')}", f"--N_rand={N_RAND}",
            f"--n_iters={sum(steps)}", "--i_print=10", "--i_img=0", "--i_weights=0",
            "--i_testset=0", "--i_video=0", "--data_axis=1",
            f"--basedir={os.path.join(here, 'build', 'chip_smoke')}", *extra])

    launches = {k: 0 for k in ("K1w", "K2w", "K3w", "K4w", "K5w", "K6w")}

    def tally(counts):
        for k in launches:
            launches[k] += counts.get(k, 0)

    w512 = (f"--netwidth={WIDE_WIDTH}", f"--netwidth_fine={WIDE_WIDTH}")
    cfg = lego(WIDE_STEPS, *w512, f"--N_samples={N_SAMPLES}")
    info = timed_train(cfg, views, dev, "K1w", "K4w", steps=WIDE_STEPS, wide=True,
                       path=f"W={WIDE_WIDTH}")
    tally(info["counts"])
    model, rs = make_model(cfg), render_settings_from_config(cfg)
    poses = scene.render_poses[:2]
    render_path(info["nets"], model, rs, scene, poses[:1], chunk=CHUNK)  # warm-up frame
    torch.cuda.synchronize()
    reset_counts()
    NeRFMLP.plain_calls = 0
    t0 = time.perf_counter()
    rgbs, disps = render_path(info["nets"], model, rs, scene, poses[1:], chunk=CHUNK)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts, plain = read_counts(), NeRFMLP.plain_calls
    if rgbs.shape != (1, H, W, 3) or not (np.isfinite(rgbs).all() and np.isfinite(disps).all()):
        raise RuntimeError(f"bad wide frame: {rgbs.shape}, finite {np.isfinite(rgbs).all()}")
    check_counts(counts, {"K1w": 2 * -(-H * W // CHUNK)}, f"W={WIDE_WIDTH} frame")
    err, _, _ = rgb_against_plain(info["nets"], model, rs, rgbs[0], scene.K, poses[1],
                                  (H, W, FOCAL), NEAR, FAR, dev)
    phase("wide_render", width=WIDE_WIDTH, ms_per_frame=f"{1e3 * seconds:.2f}", launches=counts,
          plain_mlp_calls=plain, rgb_vs_plain_max_abs=f"{err:.3e}", tol=RENDER_RGB_TOL)
    if plain or not err <= RENDER_RGB_TOL:
        raise RuntimeError(f"wide frame: {plain} plain MLP calls, rgb off the plain path by {err}")
    tally(counts)
    branches = (((f"--N_samples={POINTS_SAMPLES}",), "K2w", "K3w"),
                ((f"--N_samples={N_SAMPLES}", "--fused_render=True"), "K5w", "K6w"))
    for flags, fwd, bwd in branches:
        cfg = lego(WIDE_SHORT_STEPS, *w512, *flags)
        tally(timed_train(cfg, views, dev, fwd, bwd, steps=WIDE_SHORT_STEPS, wide=True,
                          path=f"W={WIDE_WIDTH} {' '.join(flags)}")["counts"])
    cfg = lego(WIDE_SHORT_STEPS, f"--multires={WIDE_OCTAVES[0]}",
               f"--multires_views={WIDE_OCTAVES[1]}", f"--N_samples={N_SAMPLES}")
    tally(timed_train(cfg, views, dev, "K1w", "K4w", steps=WIDE_SHORT_STEPS, wide=True,
                      path=f"octaves {WIDE_OCTAVES[0]}/{WIDE_OCTAVES[1]}")["counts"])
    phase("wide_paths", launches=launches, ms_per_frame=f"{1e3 * seconds:.2f}")
    return {"launches": launches, "ms_per_frame": 1e3 * seconds}


# the stacked wide path (phase 29): cli.train_multi on configs/multi's 8
# scenes at NeRF-W's width (W = 512) for phase 25's MULTI_STEPS steps a
# branch (i_print every MULTI_PATH_PRINT, a .tar a scene at the end), one
# step at W = 256 with 16 / 6 octaves; the stacked wide kernels at 8 scenes
# of MULTI_RAYS rays
STACKED_WIDE_BRANCHES = (("raygen", [f"--N_samples={N_SAMPLES}"], "K1ws", "K4ws"),
                         ("points", [f"--N_samples={POINTS_SAMPLES}"], "K2ws", "K3ws"),
                         ("fused_render", [f"--N_samples={N_SAMPLES}", "--fused_render"],
                          "K5ws", "K6ws"))


def stacked_wide_phase(dev) -> dict:
    """29. The stacked wide path (ROADMAP C.3b): the port's tool writes
    configs/multi's 8 scenes, then ``cli.train_multi.main`` at --netwidth
    512 --netwidth_fine 512 on each branch of the stacked step
    (STACKED_WIDE_BRANCHES: 64 + 128, 63 + 128, --fused_render) for
    MULTI_STEPS steps, each with exactly 2 stacked wide forwards and 2
    backwards a step for all 8 scenes (K6ws: and its compositing pass) and
    no other kernel, no call of the stacked plain MLP, each scene's loss
    finite and falling (the mean of the first two prints against the last
    two, as multi_path_run's), a .tar a scene holding its trained weights;
    then one step at W = 256 with --multires 16 --multires_views 6 (2 K1ws
    + 2 K4ws). Before the runs, the stacked backward's workspace at 8 x
    MULTI_RAYS rays of 192 fine samples is reckoned against the card's free
    memory. Then the stacked wide kernels (stacked_wide_kernels). Returns
    the launches of the runs and the kernels' errors and times."""
    from nerf_tpu_torch.cli import train_multi
    from nerf_tpu_torch.ops import fused_mlp_wide
    from nerf_tpu_torch.render.network import StackedNeRFMLP
    from nerf_tpu_torch.tools import make_multi_scenes

    ws = fused_mlp_wide.stacked_workspace_bytes(WIDE_WIDTH, 10, 4, MULTI_SCENES, MULTI_RAYS,
                                                N_SAMPLES + N_IMPORTANCE)
    free, total = torch.cuda.mem_get_info()
    phase("stacked_wide_workspace", width=WIDE_WIDTH, scenes=MULTI_SCENES, rays=MULTI_RAYS,
          fine_samples=N_SAMPLES + N_IMPORTANCE, workspace_gb=f"{ws / 1e9:.2f}",
          per_point_kb=f"{ws / (MULTI_SCENES * MULTI_RAYS * (N_SAMPLES + N_IMPORTANCE)) / 1e3:.2f}",
          free_gb=f"{free / 1e9:.2f}", total_gb=f"{total / 1e9:.2f}")
    if ws > 0.8 * free:
        raise RuntimeError(f"the stacked wide workspace ({ws / 1e9:.1f} GB) does not fit beside "
                           f"the rest ({free / 1e9:.1f} GB free)")
    root = tempfile.mkdtemp(prefix="chip_smoke_stacked_wide_")
    here = os.getcwd()
    quiet(make_multi_scenes.write_scenes, os.path.join(root, "data", "nerf_synthetic"),
          MULTI_SCENES, MULTI_COUNTS, device=dev)
    os.chdir(root)  # the configs' datadirs are relative
    launches = {k: 0 for k in ("K1ws", "K2ws", "K3ws", "K4ws", "K5ws", "K6ws")}
    try:
        w512 = [f"--netwidth={WIDE_WIDTH}", f"--netwidth_fine={WIDE_WIDTH}"]
        runs = [(name, w512 + flags, fwd, bwd, MULTI_STEPS)
                for name, flags, fwd, bwd in STACKED_WIDE_BRANCHES]
        runs.append(("octaves", [f"--multires={WIDE_OCTAVES[0]}",
                                 f"--multires_views={WIDE_OCTAVES[1]}",
                                 f"--N_samples={N_SAMPLES}"], "K1ws", "K4ws", 1))
        for name, flags, fwd, bwd, steps in runs:
            argv = multi_argv(root, f"wide_{name}", steps,
                              {"i_print": min(MULTI_PATH_PRINT, steps), "i_weights": steps}) + flags
            cfgs = train_multi.load_configs(argv)
            plain = StackedNeRFMLP.plain_calls
            reset_counts()
            t0 = time.perf_counter()
            result, _ = run_cli(train_multi.main, argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts, plain = read_counts(), StackedNeRFMLP.plain_calls - plain
            n = 2 * steps
            check_counts(counts, {fwd: n, bwd: n, **({"composite": n} if bwd == "K6ws" else {})},
                         f"stacked wide {name}: {steps} steps of {MULTI_SCENES} scenes")
            for k in launches:
                launches[k] += counts[k]
            losses = np.stack([h[1] for h in result.history])  # [prints, scenes]
            tars_ok = multi_tars_ok(cfgs, result, steps, dev)
            first, last = losses[:2].mean(0), losses[-2:].mean(0)  # as multi_path_run's
            falls = steps == 1 or bool((last < first).all())
            phase("stacked_wide_train", branch=name, width=cfgs[0].netwidth,
                  octaves=f"{cfgs[0].multires}/{cfgs[0].multires_views}",
                  samples=f"{cfgs[0].N_samples}+{cfgs[0].N_importance}", scenes=MULTI_SCENES,
                  n_rand=cfgs[0].N_rand, steps=steps, seconds=f"{seconds:.2f}",
                  launches={k: v for k, v in counts.items() if v}, stacked_plain_mlp_calls=plain,
                  loss_first2=[f"{v:.5f}" for v in first], loss_last2=[f"{v:.5f}" for v in last],
                  tars_load_with_trained_weights=tars_ok)
            if plain or not (np.isfinite(losses).all() and falls and all(tars_ok)):
                raise RuntimeError(f"stacked wide {name}: plain MLP calls {plain}, losses {losses}, "
                                   f"tars {tars_ok}")
            del result
            torch.cuda.empty_cache()
    finally:
        os.chdir(here)
        shutil.rmtree(root)
    return {"launches": launches, **stacked_wide_kernels(dev)}


def stacked_wide_kernels(dev) -> dict:
    """29. K1ws-K6ws at 8 scenes of MULTI_RAYS rays on stacked W = 512 nets
    of random weights from seeds (10 / 4 octaves, bf16), each level of a
    step (K1ws/K4ws and K5ws/K6ws at 64 and 192 samples, K5ws with sigma
    noise and a white background; K2ws/K3ws at 63 and 191, a direction a
    point): against their plain versions (the forwards' raw and maps at
    phase 3's bf16 bound, the grads' worst per-leaf relative L2 at phase
    26's WIDE_GRAD_TOL) and against 8 single-scene wide launches, bit for
    bit (raw, maps, grads: a scene's columns are the single launch's), then
    timed per step beside the bound (8 scenes of the single-scene work),
    the plain versions and the same products as bf16 torch.bmm over the
    scenes (stacked_matmul_chain)."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp
    from nerf_tpu_torch.render.network import StackedNeRFMLP

    cfg, pe_pts, pe_views = MLPConfig(width=WIDE_WIDTH), PosEncConfig(10), PosEncConfig(4)
    flops_pt = fused_mlp.flops_per_point(cfg, pe_pts, pe_views)
    Sc, R = MULTI_SCENES, MULTI_RAYS
    rng = np.random.default_rng(29)
    gen = torch.Generator(device=dev).manual_seed(29)
    keys = ("ms", "plain_ms", "ops_ms", "bytes_ms", "library_ms")
    t = {k: dict.fromkeys(keys, 0.0) for k in ("K1ws", "K2ws", "K3ws", "K4ws", "K5ws", "K6ws")}
    errs = {k: 0.0 for k in t}
    same = {k: True for k in t}
    for j, (n1, n2) in enumerate(((N_SAMPLES, POINTS_SAMPLES),
                                  (N_SAMPLES + N_IMPORTANCE, POINTS_SAMPLES + N_IMPORTANCE))):
        stacked = StackedNeRFMLP.from_nets([NeRFMLP(cfg, seed=290 + 2 * k + j, device=dev)
                                            for k in range(Sc)])
        with torch.no_grad():
            kp = fused_mlp.pack_params(stacked, pe_pts, pe_views, torch.bfloat16)
        del stacked
        blobs = fused_mlp.kernel_blobs(kp)
        wbytes = sum(b.numel() * b.element_size() for b in blobs)
        gbytes = 4 * sum(v.numel() for v in kp.values())
        singles = [{k: v[s].contiguous() for k, v in kp.items()} for s in range(Sc)]
        ro, rd, vd, z = [torch.stack(a) for a in zip(*(make_rays(rng, R, n1, dev)
                                                         for _ in range(Sc)))]
        noise = torch.randn(Sc, R, n1, device=dev, generator=gen) * 0.5
        g = (0.5 + torch.rand(4, Sc, R, n1, device=dev, generator=gen)) * 1e-4
        gm = [(0.5 + torch.rand(Sc, *sh, device=dev, generator=gen)) * 1e-4
              for sh in ((R, 3), (R,), (R,), (R, n1))]
        x, v = stacked_points([torch.stack(a) for a in zip(*(make_rays(rng, R, n2, dev)
                                                              for _ in range(Sc)))], n2)
        gp = (0.5 + torch.rand(Sc, R * n2, 4, device=dev, generator=gen)) * 1e-4
        rays = (ro, rd, vd, z)
        calls = {  # name: (kernel, plain version, the single-scene launch of scene s)
            "K1ws": (lambda: fused_mlp.fused_rays_planes_stacked(kp, *rays, blobs),
                     lambda: fused_mlp.fused_rays_planes_stacked_reference(kp, *rays),
                     lambda s: fused_mlp.fused_rays_planes(singles[s], *(a[s] for a in rays))),
            "K4ws": (lambda: fused_mlp.fused_rays_planes_stacked_bwd(kp, *rays, g, blobs),
                     lambda: fused_mlp.fused_rays_planes_stacked_bwd_reference(kp, *rays, g),
                     lambda s: fused_mlp.fused_rays_planes_bwd(
                         singles[s], *(a[s] for a in rays), g[:, s].contiguous())),
            "K2ws": (lambda: fused_mlp.fused_points_stacked(kp, x, v, 1, blobs),
                     lambda: fused_mlp.fused_points_stacked_reference(kp, x, v, 1),
                     lambda s: fused_mlp.fused_points(singles[s], x[s], v[s], 1)),
            "K3ws": (lambda: fused_mlp.fused_points_stacked_bwd(kp, x, v, gp, 1, blobs),
                     lambda: fused_mlp.fused_points_stacked_bwd_reference(kp, x, v, gp, 1),
                     lambda s: fused_mlp.fused_points_bwd(singles[s], x[s], v[s],
                                                          gp[s].contiguous(), 1, False)[0]),
            "K5ws": (lambda: fused_render.fused_render_stacked_fwd(kp, *rays, noise, True, blobs,
                                                                    keep_raw=True),
                     lambda: fused_render.fused_render_stacked_reference(kp, *rays, noise, True),
                     lambda s: fused_render.fused_render_fwd(singles[s], *(a[s] for a in rays),
                                                             noise[s], True, keep_raw=True))}
        with torch.no_grad():
            maps = None
            for name, (kernel, ref_fn, single) in calls.items():
                out, ref = kernel(), ref_fn()
                if name in ("K1ws", "K2ws"):
                    errs[name] = max(errs[name], float((out - ref).abs().max()))
                    same[name] &= all(torch.equal(out[:, s] if name == "K1ws" else out[s],
                                                  single(s)) for s in range(Sc))
                elif name == "K5ws":
                    errs[name] = max(errs[name], maps_err(
                        fused_render.Maps(*(a.flatten(0, 1) for a in out[:4]), None),
                        [a.flatten(0, 1) for a in ref[:4]]))
                    same[name] &= all(all(same_bits(a[s], b) for a, b in zip(out[:4],
                                                                              single(s)[:4]))
                                      for s in range(Sc))
                    maps = out
                else:
                    errs[name] = max(errs[name], max(rel_l2(out[k][s], ref[k][s]) for k in ref
                                                     for s in range(Sc)))
                    same[name] &= all(all(torch.equal(out[k][s], b) for k, b in single(s).items())
                                      for s in range(Sc))
                del out, ref
                torch.cuda.empty_cache()
            raw = maps.raw
            del maps
            k6 = (lambda: fused_render.fused_render_stacked_bwd(kp, *rays, noise, raw, *gm, True,
                                                                 blobs),
                  lambda: fused_render.fused_render_stacked_bwd_reference(kp, *rays, noise, raw,
                                                                          *gm, True))
            out, ref = k6[0](), k6[1]()
            errs["K6ws"] = max(errs["K6ws"], max(rel_l2(out[k][s], ref[k][s]) for k in ref
                                                 for s in range(Sc)))
            for s in range(Sc):
                one_in = [a[s] for a in (*rays, noise)]
                one = fused_render.fused_render_fwd(singles[s], *one_in, True, keep_raw=True)
                single_g = fused_render.fused_render_bwd(singles[s], *one_in, one.raw,
                                                         *(a[s].contiguous() for a in gm), True)
                same["K6ws"] &= all(torch.equal(out[k][s], b) for k, b in single_g.items())
            del out, ref
            torch.cuda.empty_cache()
            calls["K6ws"] = k6
            for name, fns in calls.items():
                fwd = name in ("K1ws", "K2ws", "K5ws")
                t[name]["ms"] += cuda_ms(fns[0], reps=5 if fwd else 3, warmup=1)
                t[name]["plain_ms"] += cuda_ms(fns[1], reps=1)
                torch.cuda.empty_cache()
            del raw
        for names, n, backward in ((("K1ws", "K5ws"), n1, False), (("K4ws", "K6ws"), n1, True),
                                   (("K2ws",), n2, False), (("K3ws",), n2, True)):
            chain = stacked_matmul_chain(kp, R * n, backward)
            library_ms = cuda_ms(chain, reps=3)
            del chain
            torch.cuda.empty_cache()
            n_pts = Sc * R * n
            for name in names:
                t[name]["library_ms"] += library_ms
                if backward:
                    flops = Sc * fused_mlp.bwd_flops(cfg, pe_pts, pe_views, R * n, 1)
                    io = n_pts * (12 + 16) + Sc * R * 9 * 4 + 2 * Sc * wbytes + gbytes
                else:
                    flops = n_pts * flops_pt
                    io = n_pts * (4 + 16) + Sc * R * 9 * 4 + Sc * wbytes
                t[name]["ops_ms"] += 1e3 * flops / PEAK_BF16_FLOPS
                t[name]["bytes_ms"] += 1e3 * io / PEAK_BYTES
        phase("stacked_wide_kernels", level=("coarse", "fine")[j], scenes=Sc, R=R, S=n1,
              points_S=n2, errs={k: f"{e:.3e}" for k, e in errs.items()},
              bit_equal_8_single=same, raw_tol=BF16_TOL,
              grad_tol=WIDE_GRAD_TOL[torch.bfloat16])
        del kp, blobs, singles, ro, rd, vd, z, noise, g, gm, x, v, gp, rays, calls
        torch.cuda.empty_cache()
    bad = [k for k, e in errs.items()
           if not e <= (BF16_TOL if k in ("K1ws", "K2ws", "K5ws") else WIDE_GRAD_TOL[torch.bfloat16])]
    if bad or not all(same.values()):
        raise RuntimeError(f"stacked wide kernels: off their plain versions {bad} {errs}, "
                           f"bit-equal to 8 single launches {same}")
    for name, v in t.items():
        print_stacked_times(name.lower() + "_times", v,
                            "S=63 + S=191" if name in ("K2ws", "K3ws") else "S=64 + S=192")
    return {"times": t, "errs": errs}



# ROADMAP C.8 (phase 30): the sliced backward against the one launch, the
# budget forced down to slices of C8_SLICE rays (views) of C8_RAYS; the
# tolerances are ROADMAP's ("Tolerances"): the slices' grads sum in another
# order, f32 per-leaf relative L2 within 1e-5, bf16 below nerf_tpu's 0.05
C8_RAYS, C8_SLICE, C8_SCENES = 1024, 256, 2
C8_TOLS = {torch.float32: 1e-5, torch.bfloat16: 5e-2}


def c8_phase(dev) -> None:
    """30. tools/bwd_memory.py's four shapes through the port's steps, two
    steps each: the peak device memory and ms of a step; every shape
    trains, and mip-NeRF 360's, whose workspace ran out of memory unsliced,
    runs its fine backward in slices. Then ``c8_sliced``."""
    import gc

    from nerf_tpu_torch.tools import bwd_memory

    for name, kw in bwd_memory.CONFIGS.items():
        row = bwd_memory.measure(name, **kw, dev=dev)
        gc.collect()
        torch.cuda.empty_cache()
        phase("c8_memory", **{k: (f"{v:.3f}" if isinstance(v, float) else v)
                              for k, v in row.items()})
        if not np.isfinite(row["loss"]):
            raise RuntimeError(f"{name}: non-finite loss {row['loss']}")
        if name == "mipnerf360" and not row["backward_calls_per_step"] > 2:
            raise RuntimeError(f"{name}: the backward was not sliced: {row}")
    c8_sliced(dev)


def c8_sliced(dev) -> None:
    """The sliced backward of each autograd Function against its one
    launch on the card, the budget (``fused_mlp.WORKSPACE_BUDGET``) forced
    to C8_SLICE rays (views) of C8_RAYS: K4 (64 samples), K3 (63, a
    direction per point), K6 (64, with noise), K4w (W = 512) and the stacked
    K4 (C8_SCENES scenes), each in f32 and bf16: per-leaf relative L2 within
    C8_TOLS, the wrapper launched once a slice."""
    from nerf_tpu_torch.experimental import fused_render
    from nerf_tpu_torch.models.embedding import PosEncConfig
    from nerf_tpu_torch.models.nerf_mlp import MLPConfig, NeRFMLP
    from nerf_tpu_torch.ops import fused_mlp, fused_mlp_wide

    rng = np.random.default_rng(30)
    pe = (PosEncConfig(10), PosEncConfig(4))
    R = C8_RAYS

    def cot(*shape):
        return torch.from_numpy((0.5 + rng.random(shape)).astype(np.float32) * 1e-2).to(dev)

    def leaves_of(width, dtype, scenes=0):
        nets = [NeRFMLP(MLPConfig(width=width), seed=30 + s, device=dev)
                for s in range(max(1, scenes))]
        with torch.no_grad():
            kps = [fused_mlp.pack_params(n, *pe, dtype) for n in nets]
        return [(torch.stack([kp[n] for kp in kps]) if scenes else kps[0][n])
                .detach().clone().requires_grad_(True) for n in fused_mlp.KP_NAMES]

    def case(name, dtype):
        """(leaves, run(), wrapper counted, items, item bytes, align)"""
        S = POINTS_SAMPLES if name == "K3" else N_SAMPLES
        width = WIDE_WIDTH if name == "K4w" else WIDTH
        leaves = leaves_of(width, dtype, C8_SCENES if name == "K4s" else 0)
        kp = dict(zip(fused_mlp.KP_NAMES, leaves))
        ro, rd, vd, z = make_rays(rng, R, S, dev)
        pb = fused_mlp.bwd_point_bytes(kp, S)
        if name in ("K4", "K4w"):
            g = cot(4, R, S)
            fn = (fused_mlp_wide.fused_rays_planes_wide_bwd if name == "K4w"
                  else fused_mlp.fused_rays_planes_bwd)
            return (leaves, lambda: fused_mlp._FusedRaysPlanes.apply(ro, rd, vd, z, *leaves)
                    .backward(g), fn, R, S * pb, fused_mlp.SLICE_COLS)
        if name == "K3":
            x = fused_mlp._ray_points(ro, rd, z)
            v = vd.repeat_interleave(S, 0)
            g = cot(R * S, 4)
            return (leaves, lambda: fused_mlp._FusedPoints.apply(x, v, 1, False, *leaves)
                    .backward(g), fused_mlp.fused_points_bwd, R * S,
                    fused_mlp.bwd_point_bytes(kp, 1), fused_mlp.view_align(1))
        if name == "K6":
            noise = torch.from_numpy(rng.standard_normal((R, S)).astype(np.float32)).to(dev)
            gs = [cot(R, 3), cot(R), cot(R), cot(R, S)]
            return (leaves, lambda: torch.autograd.backward(
                fused_render._FusedRender.apply(ro, rd, vd, z, noise, True, *leaves), gs),
                fused_render.fused_render_bwd, R, S * pb, fused_mlp.SLICE_COLS)
        sto, std, stv, stz = (torch.stack([t, t.flip(0)]) for t in (ro, rd, vd, z))
        g = cot(4, C8_SCENES, R, S)
        return (leaves, lambda: fused_mlp._FusedRaysPlanesStacked.apply(
            sto, std, stv, stz, *leaves).backward(g), fused_mlp.fused_rays_planes_stacked_bwd,
            R, C8_SCENES * S * pb, fused_mlp.SLICE_COLS)

    def grads(leaves, run):
        for t in leaves:
            t.grad = None
        run()
        torch.cuda.synchronize()
        return [t.grad.float().clone() for t in leaves]

    default = fused_mlp.WORKSPACE_BUDGET
    worst = {}
    for name in ("K4", "K3", "K6", "K4w", "K4s"):
        for dtype in (torch.float32, torch.bfloat16):
            leaves, run, wrapper, n, item, align = case(name, dtype)
            unit = (C8_SLICE if name != "K3" else C8_SLICE * POINTS_SAMPLES) // align * align
            before = wrapper.launches
            one = grads(leaves, run)
            ones = wrapper.launches - before
            try:
                fused_mlp.WORKSPACE_BUDGET = unit * item
                slices = fused_mlp.bwd_slices(n, item, align)
                before = wrapper.launches
                sliced = grads(leaves, run)
                launches = wrapper.launches - before
            finally:
                fused_mlp.WORKSPACE_BUDGET = default
            errs = {k: rel_l2(a, b) for k, a, b in zip(fused_mlp.KP_NAMES, sliced, one)}
            label = f"{name} {str(dtype).split('.')[-1]}"
            worst[label] = max(errs.values())
            phase("c8_sliced", case=label, slices=len(slices), launches=launches,
                  one_launch=ones, worst_leaf=max(errs, key=errs.get),
                  rel_l2=f"{worst[label]:.3e}", tol=C8_TOLS[dtype])
            if ones != 1 or launches != len(slices) or len(slices) < 2:
                raise RuntimeError(f"{label}: {ones} / {launches} launches for {len(slices)} slices")
            if not worst[label] <= C8_TOLS[dtype]:
                raise RuntimeError(f"{label}: sliced grads off the one launch's: {errs}")
            del leaves, run, one, sliced
            torch.cuda.empty_cache()


# the fused loop (phase 31): train() with fuse_steps FUSE_K and with 1 on
# the lego recipe, FUSE_PRINT apart; (name, flags, forward, backward, steps,
# chunks): the chunks of FUSE_K that train()'s rule makes (1-4 and 6-9 of
# 10, steps 5 and 10 alone at i_print 5; with precrop_iters 7, 1-4 cropped,
# 5 and 6 alone, 7-10 and 11-14 full frame; batching with fuse 8 and
# i_print 16 on one 400x400 view, 39 steps an epoch: 1-8 .. 33-40, the
# last across the wrap, then 41-44 alone)
FUSE_K, FUSE_PRINT = 4, 5
FUSE_CASES = (
    ("raygen", [f"--N_samples={N_SAMPLES}"], "K1", "K4", 10, 2),
    ("points", [f"--N_samples={POINTS_SAMPLES}"], "K2", "K3", 10, 2),
    ("fused_render", [f"--N_samples={N_SAMPLES}", "--fused_render=True"], "K5", "K6", 10, 2),
    ("wide", [f"--N_samples={N_SAMPLES}", f"--netwidth={WIDE_WIDTH}",
              f"--netwidth_fine={WIDE_WIDTH}"], "K1w", "K4w", 10, 2),
    ("precrop", [f"--N_samples={N_SAMPLES}", "--precrop_iters=7"], "K1", "K4", 14, 3),
    ("batching", [f"--N_samples={N_SAMPLES}", "--no_batching=False", "--fuse_steps=8",
                  "--i_print=16"], "K1", "K4", 44, 5),
)
# the loops' profiled window: FUSE_PROFILED_CHUNKS chunks of FUSE_TIMED_K
# steps (tools/loop_time.py's chunk) after one that captures
FUSE_TIMED_K, FUSE_PROFILED_CHUNKS = 10, 3


def fuse_cfg(n_iters: int, *flags):
    from nerf_tpu_torch import config

    here = os.path.dirname(os.path.abspath(__file__))
    return config.load_config([
        f"--config={os.path.join(here, 'configs', 'lego.txt')}", f"--N_rand={N_RAND}",
        f"--n_iters={n_iters}", f"--i_print={FUSE_PRINT}", "--i_img=0", "--i_weights=0",
        "--i_testset=0", "--i_video=0", "--data_axis=1", f"--fuse_steps={FUSE_K}",
        f"--basedir={os.path.join(here, 'build', 'chip_smoke')}", *flags])


def fused_run(cfg, views, dev):
    """train() with counts, CUDA graph replays and chunks (samplers'
    ``advance``) recorded."""
    from nerf_tpu_torch.data import rays_dataset
    from nerf_tpu_torch.models.nerf_mlp import NeRFMLP
    from nerf_tpu_torch.train.loop import train

    chunks = []
    advances = {cls: cls.advance for cls in (rays_dataset.BatchedRaySampler,
                                              rays_dataset.ImageRaySampler)}
    reset_counts()
    NeRFMLP.plain_calls = 0
    for cls, real in advances.items():
        cls.advance = lambda self, k, real=real: chunks.append(k) or real(self, k)
    try:
        with graph_calls() as graphs:
            result = train(cfg, views, device=dev)
            torch.cuda.synchronize()
    finally:
        for cls, real in advances.items():
            cls.advance = real
    return result, read_counts(), {**graphs, "chunks": chunks}


def fuse_phase(views, smi: str, dev) -> None:
    """31. Each FUSE_CASES path through train() with fuse_steps FUSE_K and
    with 1 on the same config, seed and views: history, parameters and
    Adam's state ``torch.equal``; the same launch counts, 2 of the path's
    forward and backward a step (the tile's recompute and chain, K6's
    compositing pass) and nothing else; one replay a chunk, the chunks the
    rule's. Then ``fuse_times``."""
    from nerf_tpu_torch.data.scene import Scene

    one_view = Scene(images=views.images[:1], poses=views.poses[:1],
                     render_poses=views.render_poses, hwf=views.hwf, K=views.K,
                     i_train=np.arange(1), i_val=np.zeros(0, int), i_test=np.zeros(0, int),
                     near=views.near, far=views.far)
    for name, flags, fwd, bwd, n, chunks in FUSE_CASES:
        scene = one_view if name == "batching" else views
        t0 = time.perf_counter()
        fused, counts, rec = fused_run(fuse_cfg(n, *flags), scene, dev)
        fused_s = time.perf_counter() - t0
        one, one_counts, one_rec = fused_run(fuse_cfg(n, *flags, "--fuse_steps=1"), scene, dev)
        same = fused.history == one.history and fused.state.step == one.state.step == n
        for level in ("coarse", "fine"):
            for a, b in zip(fused.state.nets[level].parameters(),
                            one.state.nets[level].parameters()):
                same = same and torch.equal(a, b)
                sa, sb = fused.state.optimizer.state[a], one.state.optimizer.state[b]
                same = same and all(torch.equal(sa[k], sb[k]) for k in sb)
        k = int(next((f.split("=")[1] for f in flags if f.startswith("--fuse_steps")), FUSE_K))
        phase("fuse", path=name, steps=n, fuse_steps=k, chunks=rec["chunks"],
              replays=rec["replays"], per_step_replays=one_rec["replays"], equal=same,
              launches=counts, history=[(i, f"{loss:.6f}") for i, loss, _ in fused.history],
              seconds=f"{fused_s:.2f}")
        if not same:
            raise RuntimeError(f"{name}: the fused loop's state or history differs from the "
                               f"per-step loop's: {fused.history} against {one.history}")
        if rec["chunks"] != [k] * chunks or rec["replays"] != chunks or one_rec["replays"]:
            raise RuntimeError(f"{name}: chunks {rec['chunks']}, replays {rec['replays']} "
                               f"(want {chunks} of {k}); per step {one_rec['replays']}")
        want = {fwd: 2 * n, bwd: 2 * n}
        if not fwd.endswith("w"):
            want.update(recompute=2 * n, chain=2 * n)
        if bwd == "K6":
            want["composite"] = 2 * n
        check_counts(one_counts, want, f"{name}: {n} steps one by one")
        if counts != one_counts:
            raise RuntimeError(f"{name}: launches {counts} fused, {one_counts} one by one")
        del fused, one
        torch.cuda.empty_cache()
    fuse_times(views, smi, dev)


def fuse_times(views, smi: str, dev) -> None:
    """Both loops' wall ms/step through train() on the lego recipe's
    raygen path at N_rand 4096 and 1024 (``tools/loop_time.py::measure`` on
    phase 7's teacher views: the difference of a 210- and a 10-step run,
    medians of two). Then a profiled window of FUSE_PROFILED_CHUNKS chunks
    of the loop's own pieces (``ChunkRunner``, its sampler and step) after
    a chunk that captures, and as many steps one by one: device ms/step
    and the idle share of each."""
    from nerf_tpu_torch.data.rays_dataset import make_sampler
    from nerf_tpu_torch.models.factory import init_nets, make_model
    from nerf_tpu_torch.tools import loop_time
    from nerf_tpu_torch.train.graph import ChunkRunner
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import init_train_state, lr_schedule, make_train_step

    k = FUSE_TIMED_K
    for n_rand, ms in loop_time.measure(views, dev, fuse=k).items():
        phase("fuse_ms", card=repr(smi), n_rand=n_rand, fuse_steps=k,
              fused_ms_per_step=f"{ms['fused']:.3f}", per_step_ms_per_step=f"{ms['per_step']:.3f}",
              ratio=f"{ms['per_step'] / ms['fused']:.3f}")

    cfg = fuse_cfg(k * (1 + FUSE_PROFILED_CHUNKS), f"--N_samples={N_SAMPLES}")
    model, rs = make_model(cfg), render_settings_from_config(cfg)
    steps = k * FUSE_PROFILED_CHUNKS
    for fused in (True, False):
        state = init_train_state(init_nets(model, cfg.seed, dev), cfg.lrate)
        step_fn = make_train_step(model, rs, cfg.lrate, cfg.lrate_decay)
        sampler = make_sampler(views, cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
        gen = torch.Generator(device=dev).manual_seed(2)
        near = torch.full((cfg.N_rand,), NEAR, device=dev)
        far = torch.full((cfg.N_rand,), FAR, device=dev)
        schedule = lr_schedule(cfg.lrate, cfg.lrate_decay)
        table = torch.tensor([schedule(t) for t in range(cfg.n_iters)], dtype=torch.float32,
                             device=dev)
        runner = ChunkRunner(functools.partial(step_fn, generator=gen), state, k, near, far,
                             [gen, sampler.generator], table, 0)

        def chunk(i):
            if fused:
                runner.run("crop", lambda j, _: sampler.next_batch(i + j))
            else:
                for j in range(k):
                    ro, rd, target = sampler.next_batch(i + j)
                    step_fn(state, ro, rd, near, far, target, generator=gen)

        chunk(1)  # captures (fused), or a warm-up chunk
        torch.cuda.synchronize()
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            for c in range(FUSE_PROFILED_CHUNKS):
                chunk(1 + k * (c + 1))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        profile_report(prof, seconds, "K1", "K4", steps=steps, card=repr(smi),
                       loop="fused" if fused else "per_step", fuse_steps=k if fused else 1,
                       replays=runner.replays)


# phase 33, the multi-scene sweep (tools/multiscene_sweep.py) on phase 25's
# scenes, at SWEEP_ITERS steps a run: one warm-up chunk of the sweep's FUSE
# steps and one timed. A scene's per-step losses in the S = 8 pack are held
# to its sequential run within SWEEP_LOSS_RTOL: 0.1 dB of PSNR (an mse
# 10^0.01 = 1.023 times another), the smallest pack-against-alone drift
# nerf_tpu's own sweep records between its S = 1 and S >= 2 columns
# (MULTISCENE.md: 0.1-1 dB after 2000 bf16 steps), since a sum that the
# pack runs over [S*R] rays where the scene alone runs over [R] may add in
# another order (tests/test_torch_port_multi.py's STEP_LOSS_RTOL on the
# CPU). The eager steps of the profiled window beside the S = 8 chunk's
SWEEP_ITERS, SWEEP_EAGER_PROFILED = 100, 10
SWEEP_LOSS_RTOL = 10 ** 0.01 - 1
# draws of [8, 3072] squared errors whose mean a scene is held to the
# scene's alone, value by value (one draw gives one value a scene)
SWEEP_MEAN_DRAWS = 64


def sweep_snapshot(pack):
    """Copies of what a chunk changes in the sweep's ``Pack``: parameters,
    Adam's state, the generators' states and the step."""
    opt = pack.state.optimizer
    params = [p for group in opt.param_groups for p in group["params"]]
    return {"params": [p.detach().clone() for p in params],
            "moments": [{k: v.clone() for k, v in opt.state[p].items()} for p in params],
            "gens": [g.get_state() for g in pack.runner.generators], "step": pack.state.step}


def sweep_restore(pack, snap) -> None:
    opt = pack.state.optimizer
    params = [p for group in opt.param_groups for p in group["params"]]
    with torch.no_grad():
        for p, v, held in zip(params, snap["params"], snap["moments"]):
            p.copy_(v)
            for k, m in held.items():
                opt.state[p][k].copy_(m)
    for g, st in zip(pack.runner.generators, snap["gens"]):
        g.set_state(st)
    pack.state.step = snap["step"]


def sweep_same(a, b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a["params"], b["params"]))
            and all(torch.equal(x[k], y[k]) for x, y in zip(a["moments"], b["moments"])
                    for k in x)
            and all(torch.equal(x, y) for x, y in zip(a["gens"], b["gens"]))
            and a["step"] == b["step"])


def sweep_graph_vs_eager(cfgs, scenes, smi: str, dev) -> None:
    """33 (a). The S = 8 pack of the sweep (its ``Pack``: one
    ``ChunkRunner`` over the stacked step and ``StackedImageSampler``):
    after the chunk that captures, one chunk is one ``CUDAGraph.replay()``
    and ``torch.equal`` to the same FUSE stacked steps run eagerly from the
    same state and generators (weights, Adam's moments and counts, losses,
    the generators' states), with the same launches, 2 K1s + 2 K4s a step
    and nothing else. Then a profiled chunk and SWEEP_EAGER_PROFILED
    profiled eager steps: device ms/step and idle share of each."""
    from nerf_tpu_torch.parallel.multi_scene import scene_seed
    from nerf_tpu_torch.tools import multiscene_sweep as sweep
    from nerf_tpu_torch.train.step import lr_schedule

    k, S = sweep.FUSE, len(scenes)
    c0 = cfgs[0]
    schedule = lr_schedule(c0.lrate, c0.lrate_decay)
    table = torch.tensor([schedule(t) for t in range(4 * k)], dtype=torch.float32, device=dev)
    pack = sweep.Pack(c0, scenes, [scene_seed(c0.seed, s) for s in range(S)], k, table, dev)
    with graph_calls() as graphs:
        pack.chunk()  # captures, then replays
        torch.cuda.synchronize()
        start = sweep_snapshot(pack)
        reset_counts()
        graph_loss = pack.chunk()["loss"]
        torch.cuda.synchronize()
        graph_counts = read_counts()
    graph_end = sweep_snapshot(pack)
    sweep_restore(pack, start)
    reset_counts()
    eager_loss = []
    for j in range(k):
        ro, rd, tgt = pack.sampler.next_batch(pack.state.step + 1)
        eager_loss.append(pack.runner.step_fn(pack.state, ro, rd, pack.runner.near,
                                              pack.runner.far, tgt)["loss"])
    torch.cuda.synchronize()
    eager_counts = read_counts()
    eager_end = sweep_snapshot(pack)
    same = sweep_same(graph_end, eager_end) and torch.equal(graph_loss, torch.stack(eager_loss))
    phase("sweep_graph_vs_eager", scenes=S, fuse=k, captures=graphs["captures"],
          replays=graphs["replays"], equal=same, launches_graph=graph_counts,
          launches_eager=eager_counts)
    n = 2 * k
    check_counts(graph_counts, {"K1s": n, "K4s": n, "recompute": n, "chain": n},
                 f"one replay of the {S}-scene chunk of {k} steps")
    if not same or graphs != {"captures": 1, "replays": 2} or graph_counts != eager_counts:
        raise RuntimeError(f"the {S}-scene chunk's replay is not its {k} eager steps: equal "
                           f"{same}, graphs {graphs}, launches {graph_counts} / {eager_counts}")

    # the idle share: a profiled chunk, then profiled eager steps
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    idle = {}
    for name, steps in (("fused", k), ("per_step", SWEEP_EAGER_PROFILED)):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if name == "fused":
                pack.chunk()
            else:
                for _ in range(steps):
                    ro, rd, tgt = pack.sampler.next_batch(pack.state.step + 1)
                    pack.runner.step_fn(pack.state, ro, rd, pack.runner.near, pack.runner.far,
                                        tgt)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        idle[name] = profile_report(prof, seconds, "K1s", "K4s", steps=steps, card=repr(smi),
                                    path=f"sweep S={S}", loop=name)
    phase("sweep_idle", card=repr(smi), scenes=S,
          **{f"{n}_{key}": "not measured" if v[key] is None else f"{v[key]:.3f}"
             for n, v in idle.items()
             for key in ("wall_ms_per_step", "device_ms_per_step", "idle_share")})


def sweep_pack_split(cfgs, scenes, dev) -> dict:
    """33 (c). Where a scene in a pack of 8 and the scene alone part, on
    one step's inputs (scene 0's fresh nets, batch and draws in both): the
    coarse and fine maps of ``render_rays``, the per-scene losses, scene 0's
    grads, each bit for bit; and the plain ops the stacked step runs over
    [8 R] rows where the scene alone runs over [R], on the step's own
    shapes: the matmul scan's product and its backward's (compositing,
    ``_ExclusiveSum``), the row sums of the maps, sample_pdf's cumsum, and
    the mse's mean a scene over SWEEP_MEAN_DRAWS draws."""
    from nerf_tpu_torch.models.factory import make_model
    from nerf_tpu_torch.ops.compositing import _ExclusiveSum
    from nerf_tpu_torch.parallel.multi_scene import (
        StackedImageSampler, init_multi_scene_state, scene_seed)
    from nerf_tpu_torch.render.renderer import render_rays
    from nerf_tpu_torch.train.loop import render_settings_from_config
    from nerf_tpu_torch.train.step import draw_overrides, stacked_loss_fn

    c0 = cfgs[0]
    S, R = len(scenes), c0.N_rand
    model, rs = make_model(c0), render_settings_from_config(c0)
    seeds = [scene_seed(c0.seed, s) for s in range(S)]
    gens = [torch.Generator(device=dev).manual_seed(s + 1) for s in seeds]
    ro, rd, tgt = StackedImageSampler(scenes, R, gens, device=dev).next_batch(1)
    per = [draw_overrides(torch.Generator(device=dev).manual_seed(s + 2), R, rs) for s in seeds]
    ov = {key: torch.stack([d[key] for d in per]) for key in per[0]}
    near = torch.full((S, R), scenes[0].near, device=dev)
    far = torch.full((S, R), scenes[0].far, device=dev)
    got = {}
    for n in (S, 1):
        state = init_multi_scene_state(model, seeds[:n], c0.lrate, dev)
        rays = [t[:n].flatten(0, 1) for t in (ro, rd, near, far, tgt)]
        vd = rays[1] / torch.linalg.norm(rays[1], dim=-1, keepdim=True)
        out = render_rays(state.nets, model, rs, rays[0], rays[1], vd, rays[2], rays[3],
                          overrides={key: v[:n].flatten(0, 1) for key, v in ov.items()})
        loss, aux = stacked_loss_fn(state.nets, model, rs, n, rays[0], rays[1], vd, rays[2],
                                    rays[3], rays[4],
                                    overrides={key: v[:n].flatten(0, 1) for key, v in ov.items()})
        loss.backward()
        got[n] = {"coarse_map": out["rgb0"][:R], "fine_map": out["rgb_map"][:R],
                  "loss": aux["loss"][:1],
                  "grads": [p.grad[0] for net in state.nets.values() for p in net.parameters()]}
    stages = {key: (all(map(torch.equal, got[S][key], got[1][key])) if key == "grads"
                    else torch.equal(got[S][key], got[1][key])) for key in got[S]}
    gen = torch.Generator(device=dev).manual_seed(3)
    ops = {}
    for N in (c0.N_samples, c0.N_samples + c0.N_importance):
        x = torch.log(torch.rand(S * R, N, device=dev, generator=gen) + 1e-3)
        g = torch.randn(S * R, N, device=dev, generator=gen)
        scan = {}
        for rows in (S * R, R):
            xr = x[:rows].clone().requires_grad_()
            y = _ExclusiveSum.apply(xr)
            y.backward(g[:rows])
            scan[rows] = (y.detach()[:R], xr.grad[:R])
        ops[f"scan_fwd_{N}"] = torch.equal(scan[S * R][0], scan[R][0])
        ops[f"scan_bwd_{N}"] = torch.equal(scan[S * R][1], scan[R][1])
        w = torch.rand(3, S * R, N, device=dev, generator=gen)
        ops[f"row_sums_{N}"] = torch.equal(w.sum(-1)[:, :R], w[:, :R].sum(-1))
        ops[f"cumsum_{N}"] = torch.equal(torch.cumsum(w[0], -1)[:R], torch.cumsum(w[0, :R], -1))
    # the mse's mean is one value a scene: many draws of it
    d = torch.rand(SWEEP_MEAN_DRAWS, S, R * 3, device=dev, generator=gen)
    apart = sum(not torch.equal(d[t].mean(-1)[s], d[t, s : s + 1].mean(-1)[0])
                for t in range(SWEEP_MEAN_DRAWS) for s in range(S))
    ops["mse_mean"] = apart == 0
    phase("sweep_pack_split", scenes=S, rays=R, **{f"{k}_equal": v for k, v in stages.items()},
          **{f"{k}_equal": v for k, v in ops.items()},
          mse_mean_apart=f"{apart}/{SWEEP_MEAN_DRAWS * S}")
    return {**stages, **ops}


def sweep_phase(root: str, smi: str, dev) -> None:
    """33. The multi-scene sweep (``nerf_tpu_torch.tools.multiscene_sweep``)
    on phase 25's 8 scenes in ``root``, configs/multi copied beside them:
    (a) ``sweep_graph_vs_eager``; (b) the tool's ``main`` at --n_iters
    SWEEP_ITERS (S = 1, 2, 4, 8 and sequential x8): its rows, 2 K1s + 2 K4s
    a step of every run and 4 K1 a holdout frame, one capture an S and one
    replay a chunk; (c) each scene's per-step losses in the S = 8 run
    against its sequential run within SWEEP_LOSS_RTOL, its weights' max
    abs difference, whether the pack is bit-equal, and
    ``sweep_pack_split``."""
    from nerf_tpu_torch.config import load_config
    from nerf_tpu_torch.tools import multiscene_sweep as sweep
    from nerf_tpu_torch.train.loop import load_scene

    here = os.getcwd()
    t_start = time.perf_counter()
    shutil.copytree(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "multi"),
                    os.path.join(root, "configs", "multi"))
    os.chdir(root)
    try:
        cfgs = [load_config(["--config", f"configs/multi/scene_{k}.txt", "--precrop_iters", "0"])
                for k in range(MULTI_SCENES)]
        scenes = [load_scene(c) for c in cfgs]
        sweep_graph_vs_eager(cfgs, scenes, smi, dev)
        torch.cuda.empty_cache()
        t_a = time.perf_counter()

        # (b) the tool itself
        reset_counts()
        out = io.StringIO()
        with graph_calls() as graphs, contextlib.redirect_stdout(out):
            result = sweep.main(["--n_iters", str(SWEEP_ITERS), "--scenes", str(MULTI_SCENES),
                                 "--out", os.path.join(root, "multiscene_sweep.json")])
        counts = read_counts()
        t_b = time.perf_counter()
        print("\n".join(line for line in out.getvalue().splitlines()
                        if line.startswith("[SWEEP]")), flush=True)
        rec = result.record
        for row in rec["runs"]:
            phase("sweep_row", card=repr(rec["card"]), **row)
        runs = result.runs
        steps = sum(r.losses.shape[0] for r in runs)
        frames = sum(len(r.scenes) for r in runs)
        per_frame = 2 * -(-(scenes[0].H * scenes[0].W) // cfgs[0].chunk)
        phase("sweep_launches", steps=steps, frames=frames, launches=counts, **graphs)
        check_counts(counts, {"K1s": 2 * steps, "K4s": 2 * steps, "recompute": 2 * steps,
                              "chain": 2 * steps, "K1": per_frame * frames},
                     f"the sweep: {steps} stacked steps, {frames} holdout frames")
        concurrent = [s for s in sweep.CONCURRENT if s <= MULTI_SCENES]
        want = {"captures": len(concurrent), "replays": len(runs) * rec["n_iters"] // sweep.FUSE}
        if graphs != want:
            raise RuntimeError(f"the sweep's graphs {graphs}, expected {want}")

        # (c) a pack against its scenes alone
        pack = next(r for r in runs if r.label == f"concurrent_S{MULTI_SCENES}")
        alone = [r for r in runs if r.label.startswith("sequential_")]
        worst_loss, worst_w, losses_apart = 0.0, [], 0
        for k, one in enumerate(alone):
            a, b = pack.losses[:, k], one.losses[:, 0]
            worst_loss = max(worst_loss, float(np.max(np.abs(a - b) / np.abs(b))))
            losses_apart += int(np.sum(a != b))
            worst_w.append(max(float((pack.params[k][lvl][n] - p).abs().max())
                               for lvl, named in one.params[0].items()
                               for n, p in named.items()))
        split = sweep_pack_split(cfgs, scenes, dev)
        phase("sweep_pack_vs_alone", scenes=MULTI_SCENES, steps=rec["n_iters"],
              loss_max_rel=f"{worst_loss:.3e}", bound=f"{SWEEP_LOSS_RTOL:.3e}",
              losses_apart=f"{losses_apart}/{pack.losses.size}",
              weights_max_abs=[f"{w:.3e}" for w in worst_w],
              weights_bit_equal=not any(worst_w),
              psnr_equal=pack.psnrs == [p for r in alone for p in r.psnrs],
              parts_that_differ=[k for k, v in split.items() if not v] or "none",
              seconds_a=f"{t_a - t_start:.1f}", seconds_b=f"{t_b - t_a:.1f}",
              seconds=f"{time.perf_counter() - t_start:.1f}")
        if not worst_loss <= SWEEP_LOSS_RTOL:
            raise RuntimeError(f"a scene in the pack of {MULTI_SCENES} against alone: losses "
                               f"{worst_loss} apart, bound {SWEEP_LOSS_RTOL}")
    finally:
        os.chdir(here)


if __name__ == "__main__":
    sys.exit(main())
