"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

  1. device  the card (nvidia-smi name and power limit, capability); TF32 off
  2. build   every CUDA kernel of the serving and training paths, from
             moss_torch/csrc, one nvcc each, all at once
  3. kernel  the forward blend kernels against their plain PyTorch versions
             at 512x512 / 16x16 tiles on three scenes (bench.py's 46,080-splat
             scene, the same at opacity 0.01, a dense opaque one that
             exercises termination): tiles split into segments of at most
             rc.SEGMENT pairs against the plain blend and the plain segment
             scheme (ops/split_blend.py), bitwise repeatable, and unsplit
             (one segment a tile) against the plain blend; with the split
             and unsplit times, the times at the segment lengths SEG_LENS,
             the segment count, the binning's time, the plain version's, and
             the bound the card sets for the same work
  4. slice   the serving path through the user entry points: a 6,890-vertex
             synthetic SMPL scene, a 45,695-Gaussian cloud in a 46,080
             capacity, random MLPs, a 512x512 camera; render_frame on the full
             path (pose MLPs + LBS field + deform) and, after compacting the
             cloud, on the cached-transform path, each held to the same call
             through the plain rasterizer; the blend kernel's launch count is
             set to 0 just before one drive of the path and read just after
  5. train_kernel  the backward blend kernel plus the segment sum against
             autograd through the plain version (remat) at 512x512, on the
             bench scene and (in phase 6) on the training slice's own
             projected input: grads within the scaled atol, two backward passes
             bitwise equal, the split kernel's rows against the plain segment
             scheme's and its grads against the unsplit kernel's, with the
             split and unsplit times, those at SEG_LENS, the plain
             backward's, and bounds;
             the segment sum alone against its plain version and index_add_
             (1e-5 of the max), bitwise repeatable, its time beside
             index_add_'s, and the distribution of segment lengths
  6. train   the training path through the user entry points: the slice's
             cloud and MLPs, 4 frames from make_frames at 512x512, a 256x256
             crop, the six-term loss with the seeded random LPIPS backbone,
             make_train_step; one step's grads held to the same step through
             the plain rasterizer; then 2 warm-up and 5 timed steps, with every
             kernel's launch count set to 0 just before and read just after
             (one launch of each per step), and one profiled step; and the
             backward kernel's stages (phase 19) on the slice's projected input
  7. trainer  the Trainer, the user's entry point for training an avatar:
             6,890 initial points in the 46,080 capacity, 4 train frames and
             1 test frame from make_frames at 512x512 (the cloud on the SMPL
             vertices at TARGET_OPACITY, which the initial cloud does not
             reproduce), crop 256, SH degree 3, the compressed schedule
             TRAINER (60 iterations, densify rounds at 20, 30, 40 and 50, an
             opacity reset at 30, evals at 1, 20, 30, 31 and 60); the loss
             finite at every step, the live count within the capacity after
             every round, the evals at 20 and 30 PSNR_GAIN_DB above the one at
             1 and the last above the one right after the reset (31), the
             blend kernels and the segment sum launched once per step and eval
             frame (counts set to 0 just before the run and read just after);
             one run (phase 7b runs the schedule three times, bitwise equal);
             ms per iteration outside densify rounds, per round, per eval frame
 7b. engines  the trainer's dispatch engines (train/trainer.py): phase 7's
             scene, frames, crop, loss and schedule once per engine (eager,
             queued, scan); every queued and scan segment under torch.cuda's
             sync debug mode "error" (a host sync inside a segment fails the
             run);
             the scan engine's state (a CUDA graph of the step, replayed) and
             the queued one's bitwise eager's after iterations 20 and 60, its
             evals the same; rows 1, 2, 2b and svd3 launched in every run
             (their wrappers' counts: under scan only each capture's warm-up
             step; the profiled replays' trace must name all four kernels
             every step, and the kernels line gives scan's replays x calls
             captured apart from its launches); a forced overflow (half the
             probed pair need installed) counted, healed and regrown, the next
             segment reading 0; per engine ms per iteration outside rounds,
             evals and budget probes, a profiled call's kernel launches, graph
             launches, syncs and idle share a step, captures and ms per capture,
             the graph pool's MB and the budgets installed; rows 1, 2 and 2b
             at the budgeted capacity against the live list's (bitwise) and
             the plain blend of the kept pairs, with both times; csrc/svd3.cu
             against torch.linalg.svd on the pose MLPs' rotations and on a
             general batch of random matrices (svd3_check)
  8. checkpoint  save, resume, reload and serve the trained avatar: the
             trainer phase's run wrote chkpnt30.npz (the state after step 30,
             its round and its opacity reset); a fresh Trainer resume_latest's
             it and trains to 60, bitwise equal to the uninterrupted run in
             params, valid, moments, MLPs and statistics, with the same evals
             at 31 and 60; the final state saved as chkpnt npz and as the
             reference layout, each loaded into a fresh Trainer and compacted
             (compact_for_eval), the test frame on the full and the cached
             path held to the in-memory state's frame at full capacity under
             the image rule, live counts equal; the kernels' launches over the
             resume and the two serves; the train phase's state (45,695 live in
             46,080) bitwise through save_checkpoint / restore_checkpoint;
             host-clock ms of save, load and compact_for_eval, the files' MB,
             and the serving frame's ms on the trained cloud in the 46,080
             buffer and compacted, beside nvidia-smi's name and power limit;
             the compacted avatar's test frame on both paths through the
             installed budgets (render_zju's serving) bitwise the per-frame
             list's with overflow 0, counted, each binning's host ms (in
             turns), device-busy ms, launches and host syncs of a profiled
             frame
  9. densify  one densify_and_prune round at full width on the train
             phase's state after its steps (45,695 live in 46,080: the arena
             at the cap, so one clone turns split and merge off): host-clock ms
             of the round and of its parts (the k=5 kNN, the k=1 kNN to the
             SMPL vertices, eigh, the SVD, KL and curvature, the rest), its
             stats and a profiled round's idle share; rounds on 8,192-slot
             cuts (4,096 live, room for children) of that state and of the
             trainer's before each of its rounds, on the card and on the CPU
             with the same noise and normals: masks agree on all but
             DENSIFY_MASK_SHARE of the slots, params and moments within
             DENSIFY_RTOL of the max where they agree, and clone, split and
             merge each land in them; the share of slots whose curvature mask
             flips when the card computes its own normals
 10. smplx  the SMPL-X scene family (DNA-Rendering's body, J = 55) at full
             width: synthetic_smplx's 10,475 vertices (the SMPL-X mesh's count)
             in the big pose, every one a seed in the 46,080 capacity, SH
             degree 3, motion_offset=False; 4 train and 1 test frame at
             1224x1024 (DNA-Rendering's capture at the reader's 0.5 scale)
             rendered by the forward kernel from a target cloud on the body at
             random 165-dim poses, bound masks from the posed vertices, the crop
             autosize_crop's rule takes; the Trainer over SLICE_TRAINER (two
             densify rounds whose k=1 kNN runs to the SMPL-X vertices and whose
             Fisher fields are SVDs of zero matrices, one opacity reset), the
             eval at 20 above the one at 1, the kernels launched once per step
             and eval frame, under queued; a second run under scan (a CUDA
             graph of the step, captured at the start and after each state
             change) bitwise the first; every segment of both under the sync
             debug mode "error"; the scan run's captures (ms, graph pool, the
             card's reserved and allocated MB after each: reserved after the
             last within the second's plus one pool, allocated within
             CAPTURE_LEAK_MB of it) and a profiled 10-step scan call whose
             replays' trace must name each blend kernel every step (idle share,
             launch calls, syncs), ms an iteration outside rounds and evals
             under each engine; 7 more steps timed and
             one profiled (host ms, device-busy ms, idle share, launches, syncs);
             the trained avatar's test frame served on the full path against
             the plain blend (the image rule); rows 1, 2 and 2b on that frame's
             projected input (measure_rows: each plain version once), with
             segments and the longest tile
 11. static  the static family (a NeRF-synthetic Blender scene, no body) at
             full width: transforms_{train,test}.json with 4 and 1 cameras at
             800x800 written and read back through read_blender_scene (which
             needs neither imageio nor h5py), the extent from nerfpp_norm;
             100,000 seeds uniform in [-1.3, 1.3]^3 in a 131,072 capacity
             (static_scene_context); ground truth rendered by the forward kernel
             from a target cloud on the seeds, put into Frames directly; the
             Trainer with static_scene=True (densify_and_prune_static rounds)
             and everything else as in phase 10
 12. dna     where h5py imports: a DNA-Rendering capture pair of 2 poses at
             2448x2048 (JPEG colour, PNG masks, calibration, the SMPL-X block)
             and an SMPL-X asset (.npz, 400 shape columns) written from phase
             10's rig and target, read back through read_dna_rendering and
             load_smplx_npz: the rig bitwise, a loaded frame bitwise the same
             bytes decoded in memory by the reader's steps, the camera within
             1e-5; 3 training steps from the loaded frames. Elsewhere one line
             says h5py does not import
 13. novel_view  render_zju --novel_view's path on the trainer phase's
             avatar, compacted: the test frame's pose (its transforms cached by
             one full-path render) through ORBIT_VIEWS ZJU orbit cameras at
             512x512 and as many MonoCap ones at 1024x1024
             (render/novel_view.py), the subject moved to each orbit's centre
             by its SMPL translation; every view with alpha > 0.5 somewhere and
             its subject within a quarter of the frame of the centre, the views
             ORBIT_CHECKED against the plain blend; ms per orbit frame, every
             view's pairs and longest tile, row 1 on view 0; then each orbit
             as render_zju serves it, through the budgets of a Trainer built on
             its first view: every view bitwise the per-frame list's with
             overflow 0, counted, ms per orbit frame on each binning (in
             turns), and for view 0 each binning's host ms, device-busy ms,
             launches and host syncs
 14. viewer  the SIBR remote viewer (train/network_gui.py) on localhost while a
             Trainer trains VIEWER_ITERS iterations: a client thread sends three
             cameras (one at scale_modifier 0.5), one a poll; the bytes it gets
             equal the uint8 quantization of render_frame at the same camera and
             state; a viewer frame against the plain blend; ms of a serving
             poll, the round trip, and a poll's cost with no viewer
 15. sharded  parallel/sharded.py on two ranks of the one card (two processes
             on cuda:0 in a gloo group, the band gather a SUM all-reduce):
             meshes 1 x 2 (two 256-row bands) and 2 x 1 (two frames a step),
             SHARDED_STEPS steps each from the train phase's state, held to the
             same steps on one process (losses, first grads, params, densify
             statistics; tests/test_parallel.py's tolerances); the denser
             band's rows 1, 2 and 2b (BAND_ROWS); ms per step on each rank;
             then on each mesh the
             Trainer (phase 7's scene and crop, MESH_TRAINER: 12 iterations,
             one densify round, an eval) under the queued and the eager
             engine, bitwise equal on both ranks, the kernels counted, ms per
             iteration, a profiled call's launches and syncs a step, the band
             and eval budgets; and on this process a 1 x 1 mesh's queued
             segment under the sync debug mode "error" (no host sync)
 16. monocap  phase 10's path at MonoCap's 1024x1024 on a 6,890-vertex SMPL
             scene (the MLPs on), 46,080 capacity, the autosized crop, evals at
             MONOCAP_EVALS, a TBWriter where tensorboardX imports, and five
             steps under observability.profile_trace, whose trace must name
             both blend kernels; queued, then scan, as in phase 10
 16b. drivers  the users' main path from disk: a ZJU-MoCap-Refine subject
             (my_377 in the reader's layout: 1024x1024 JPEGs and PNG masks of
             the 12 train and 8 test frames, the 6,890-vertex synthetic rig
             posed per frame) and a MonoCap sequence (olek_images0812: 117
             frames at 1024x1024, soft masks) written with cv2 and
             readers.imwrite, every file read back through readers.imread
             (PNGs the array encoded, JPEGs cv2's decode of the bytes); then
             each driver's main() in this process with no --device: train_zju
             at 512x512 (the reader's 0.5 scale), 46,080 capacity, 6,890
             initial points, the autosized crop, DRIVER_ITERS iterations with
             evals and saves at DRIVER_CHECKS under queued (phase 16c trains
             from disk under scan and resumes, bitwise), render_zju
             --save_images (every
             served frame bitwise the per-frame list's, overflow 0, the PNGs
             the served frames), render_zju --rasterizer reference (the plain
             blend: no kernel launched, every frame within the image rule of
             the kernels', the PSNR within DRIVER_PSNR_ATOL dB), render_zju
             --novel_view, train_zju --rasterizer reference for 1 iteration
             (the first step's losses within DRIVER_LOSS_RTOL of the kernel
             run's; no blend kernel launched), train_monocap at 1024x1024
             under queued and under --dispatch scan (its chkpnt bitwise
             queued's), then render_monocap on the scan run's; every
             Trainer a driver builds runs its segments under the sync debug
             mode "error" (here and in phase 16c); the files each
             wrote loaded back; per call
             the kernels' launches (set to 0 just before, read just after),
             wall seconds, ms an iteration outside evals, saves and budget
             probes, and ms a served frame (1000 / the driver's fps); and
             Trainer(rasterizer="reference") under queued (segments under the
             sync debug mode "error") and scan (a CUDA graph of the plain
             blend), bitwise equal
 16c. reference_schedule  one whole avatar as a user trains and serves it,
             from phase 16b's ZJU-MoCap capture: train_zju with only
             --data_root, --subjects, --output, --result_file and --dispatch
             scan, so the default schedule (3000 iterations, 15 densify rounds
             at 500-1900, no opacity reset, evals, PLY saves and checkpoints at
             2500, 2700 and 3000), 512x512, the 46,080 capacity from 6,890
             points, SH degree 3; then --resume from its chkpnt2700 to 3000
             under scan; then render_zju --save_images on chkpnt3000
             (compacted). Gates: 3000 logged iterations with finite losses;
             rounds exactly at the schedule's iterations and no reset; the
             live count within the capacity; a CUDA graph captured after
             every round that gave the state new tensors and none that no
             round, reset or budget install called for; the card's reserved
             memory after the last capture within the second capture's plus
             one graph pool and its allocated memory within
             CAPTURE_LEAK_MB of it, every replaced graph freed; each SH degree's
             coefficients zero until the boundary after its first updating
             step; pairs dropped in training only with the trainer's heal;
             the PSNR at 2500 above phase 16b's 60-iteration run's last; the
             resume bitwise the uninterrupted chkpnt3000 with one capture;
             every served frame bitwise the per-frame list's, the PNGs the
             served frames. It prints the wall seconds by part (reads and
             decodes, set-up, steps, rounds, heals, captures, evals, saves),
             ms an iteration outside rounds, ms a round, each capture's ms,
             pool and reserved MB, peak allocated MB, the live count after
             each round with the round's stats and budgets, the evals, the
             resume's seconds, ms a served frame and raster_overflow
 17. tool_sort  moss_torch.tools.sort_micro, counted, which holds the two
             sort-pass kernels to their plain versions, exactly, at every
             stride of a 2^19-key network and times both at each stride at R
             and 4R (the 4R > 1.5 R gate at every lane and row stride), each
             with r = 0 and an empty kernel on the lane pass's grid, and
             prices the network with each stride's own time; the lane pass's
             SASS by stride and the row pass's
 18. tool_conv  the two 3x3 conv kernels against their plain version: the
             CUDA-core kernel in f32 (atol 1e-4) at the JAX tool's check()
             shapes and the eight VGG16 layer shapes, the tensor-core kernel
             in bf16 (2e-2 of the max) at the eight layers and at ragged
             shapes, bitwise repeatable, each shape on the route it should
             take, an unaligned input too; the tensor-core kernel's stages
             equal to their plain versions; then moss_torch.tools.conv_proto,
             counted, which prints per layer the tensor-core kernel's ms,
             TFLOP/s, share of the bound, cuDNN's ms and its stages' ms
 19. tool_bwd_floor  the backward kernel's stages: full and full_soa bitwise
             equal to the production kernel, every stage held to its plain
             version, with times and bounds; then
             moss_torch.tools.bwd_kernel_floor, counted
 20. tool_mxu  the twelve reductions and scans of csrc/reduce_scan.cu (CUDA
             cores, bf16, split2 and 3xTF32 tensor-core forms): their
             observers bitwise equal across the 256 tiles, a launch's time
             against REPS; the tensor-core kernels' layout tables against
             their Python copies, and moss_torch.tools.tc_rate (the tensor
             cores' TF32 and bf16 rates at N = 8 by instruction form, with
             and without their operand work beside them, and the check that
             they read only an operand's TF32 bits); then
             moss_torch.tools.mxu_micro, counted, which holds each run and
             the stages of the tensor-core cumsums, the log-space cumprod,
             the 3xTF32 kernels, the bf16 moments and the CUDA-core kernels
             against their plain versions (1e-5 of the max) and times them;
             registers and CTAs an SM of the CUDA-core kernels (the reshape
             too) and the bf16 forms
 21. timing  how many runs cuda_ms took again because the host had not
             queued them before their spin ended (0: every time above is the
             first run's), by phase and by kernel; each phase's seconds

Each tool phase sets its kernels' launch counts to 0 just before it drives
the tool's main() and reads them just after; each training path sets those
of the blend kernels, the segment sum and svd3 to 0 just before its run and
reads them just after (launch_counts). Then the kernels line and the last
line {"ok": true, "device": {...}}.
Needs a CUDA device and nvcc; builds into build/moss_torch/.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import gc
import glob
import hashlib
import json
import math
import os
import pickle
import shutil
import socket
import subprocess
import sys
import threading
import time
import weakref

import numpy as np
import torch

from moss_torch.config import Config, ModelConfig, OptimConfig, PipelineConfig
from moss_torch.data import colmap, dna, readers
from moss_torch.data.frames import Frame
from moss_torch.data.synthetic import bench_scene, make_camera, make_frames, make_scene, \
    orbit_krt, random_pose
from moss_torch.models import gaussians as G
from moss_torch.models import smpl as S
from moss_torch.models.lbs_field import LBSField
from moss_torch.models.pose_refine import PoseRefine
from moss_torch.ops import binning, bwd_stages, conv3x3 as conv, cuda_build, fisher, lpips, \
    rasterize_cuda as rc, reduce_scan as rs, sort_pass, split_blend
from moss_torch.ops.knn import knn
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.ops.transforms import inverse_sigmoid
from moss_torch.parallel.distributed import initialize_distributed
from moss_torch.parallel.sharded import make_mesh, make_sharded_train_step
from moss_torch.render import novel_view as nv
from moss_torch.render.camera import Camera
from moss_torch.render.render import SceneContext, render_frame
from moss_torch.tools import bwd_kernel_floor, conv_proto, mxu_micro, sort_micro, tc_rate, timing
from moss_torch.tools.timing import cuda_ms
from moss_torch.train import checkpoint as ckpt
from moss_torch.train import densify as D
from moss_torch.train import observability as obs
from moss_torch.train import optim
from moss_torch.train.losses import compute_losses, crop_window
from moss_torch.train.optim import GAUSS_GROUPS, AdamState
from moss_torch.train.network_gui import NetworkGUI, quantize
from moss_torch.train.train_step import (TrainState, TrainStep, active_sh_degree,
                                         device_state, make_train_many, make_train_step,
                                         stage_frames)
from moss_torch.train.trainer import Trainer

HW = 512
MODEL = ModelConfig()
CAPACITY = MODEL.capacity  # 46,080, bench.py:90-91
N_LIVE = 45695         # the reference's densification cap (gaussian_model.py:496)
N_VERTS = 6890
# H100 SXM peaks (NVIDIA datasheet): HBM bytes/s, f32 FLOP/s off the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# f32 operations of one (pair, pixel) evaluation in csrc/rasterize_fwd.cu
# (dx, dy; the quadratic form; expf; op*e; min) and the extra ones of a
# contribution (1 - alpha, T (1 - alpha), alpha T, five multiply-adds)
OPS_PER_EVAL = 14
OPS_PER_CONTRIB = 13
# f32 operations of one contribution in csrc/rasterize_bwd.cu beyond the
# evaluation: w, T (1 - alpha), dL/dw (4 multiply-adds), the prefix, s_after,
# dL/dpower (5), the ten per-pair values (10), and their ten adds into the
# tile's sum
OPS_PER_CONTRIB_BWD = 38
# image rule of tests/test_rasterize_tpu.py:50-59: atol, share of pixels
# allowed as termination-threshold flips, largest flip
ATOL, OUTLIER_FRAC, OUTLIER_ATOL, DEPTH_ATOL = 3e-5, 2e-3, 1.0, 1e-4
# grad rule of tests/test_rasterize_tpu.py:150 (divide by max|g_ref|) and :166
GRAD_ATOL, BG_RTOL = 5e-4, 1e-4
# the segment sum against its plain version and index_add_: max |a - b| / max |b|
SEGMENT_RTOL = 1e-5
# the CUDA sources under moss_torch/csrc
KERNELS = ("rasterize_fwd", "rasterize_bwd", "segment_sum", "svd3", "sort_pass", "conv3x3",
           "reduce_scan", "tc_rate")
PEAK_BF16 = 989e12  # dense bf16 FLOP/s on the tensor cores
# the sort passes' int32 min and max, counted at the f32 rate above: the
# datasheet gives no int32 rate, and the SMs have half as many int32 lanes as
# f32 ones, so this bound is low
PEAK_INT32 = PEAK_F32
# the kernels a cuda_ms site outside chip_smoke.py times (its file), for the
# timing line's runs retaken by kernel; a site of chip_smoke.py names its kernel
SITE_KERNELS = {"sort_micro.py": "sort_lane_pass/sort_row_pass",
                "conv_proto.py": "conv3x3/conv3x3_f32",
                "bwd_kernel_floor.py": "rasterize_bwd_stages", "mxu_micro.py": "mxu_*",
                "mxu": "mxu_*"}
# observer planes of the ablated backward stages against their plain version:
# max |a - b| / max |b| beyond this on at most OUTLIER_FRAC of the pixels
OBSERVE_RTOL = 1e-4
CROP = 256         # the trainer's crop (moss_tpu/train/trainer.py:139-140)
TRAIN_FRAMES = 4
# segment lengths the blend kernels are also timed at, beside rc.SEGMENT
SEG_LENS = (32, 64, 96, 128, 256)
# the densify round on the card against the CPU: the clone, split, merge and
# prune masks may differ on at most this share of the slots (kNN near-ties
# round differently), params and moments where they agree within this share
# of their max
DENSIFY_MASK_SHARE = 1e-3
DENSIFY_RTOL = 1e-5
DENSIFY_CUT = 8192
DENSIFY_MASKS = ("clone", "split", "merge", "prune")
# the trainer phase's compressed schedule: rounds at 20, 30, 40, 50, a reset at
# 30. The ground truth is the cloud on the SMPL vertices at opacity
# TARGET_OPACITY, which the initial cloud (opacity 0.1, other colours) does not
# reproduce. The evals at 20 and 30 (before the reset) must beat the one at 1
# by PSNR_GAIN_DB, the one at 60 the one right after the reset (label 31): the
# reset clamps the opacities to 0.01, which 30 steps at opacity_lr do not undo
TRAINER = dict(iterations=60, densify_from_iter=10, densify_until_iter=55,
               densification_interval=10, opacity_reset_interval=30)
TRAINER_EVALS = (1, 20, 30, 31, 60)
TARGET_OPACITY = 0.5
PSNR_GAIN_DB = 0.5
# the checkpoint phase resumes the trainer phase's run from the state after
# step RESUME_AT (after the round at 30 and the opacity reset), written here
RESUME_AT = 30
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "checkpoint")
# rounds of turns of the trained cloud's serving frame, in the buffer and
# compacted: a host-clock frame spreads by a third from run to run
FRAME_TURNS = 5
# the SMPL-X family (DNA-Rendering): the SMPL-X mesh's 10,475 vertices, every
# one a seed in the 46,080 capacity; frames of DNA-Rendering's 2448 x 2048
# capture at the reader's 0.5 scale (moss_tpu/data/dna.py:125), (H, W)
SMPLX_VERTS = 10475
SMPLX_HW = (1024, 1224)
# the static family (a NeRF-synthetic Blender scene): 800 x 800 frames, the
# lego scene's camera_angle_x, cameras on a sphere of radius 4.0311; 3DGS's
# random init for such a scene, 100,000 points uniform in [-1.3, 1.3]^3, in a
# 131,072 capacity
STATIC_HW = 800
STATIC_FOVX = 0.6911112070083618
STATIC_RADIUS = 4.0311
STATIC_SEEDS = 100_000
STATIC_CAPACITY = 131_072
# both families' trainer: 40 iterations, densify rounds at 20 and 30, an
# opacity reset after the round at 30 (so no round prunes by screen size,
# which would thin a cloud seen at 1224 x 1024), evals at 1, 20, 30 (before
# the round and the reset), 31 (after them) and 40; the eval at 20 must beat
# the one at 1
SLICE_TRAINER = dict(iterations=40, densify_from_iter=10, densify_until_iter=35,
                     densification_interval=10, opacity_reset_interval=30)
SLICE_EVALS = (1, 20, 30, 31, 40)
BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
STATIC_DIR = os.path.join(BUILD, "blender_scene")
DNA_DIR = os.path.join(BUILD, "dna_capture")
# the orbits of render_zju --novel_view (render/novel_view.py): views an orbit,
# frame sizes (ZJU's 512x512 after the reader's 0.5 scale, MonoCap's 1024x1024),
# the focal length in image heights (the synthetic body fits in view at either
# orbit's radius), and the views held against the plain blend
ORBIT_VIEWS = 36
MONOCAP_HW = 1024
ORBIT_HW = {"zju": HW, "monocap": MONOCAP_HW}
ORBIT_FOCAL = 1.0
ORBIT_CHECKED = (0, 9, 18, 27)
# the viewer phase's iterations (one poll each; the first three serve a camera)
VIEWER_ITERS = 10
# MonoCap's trainer: SLICE_TRAINER with evals at 1, 20 and 40
MONOCAP_EVALS = (1, 20, 40)
# the sharded phase: meshes (n_data, n_tile) of its two ranks, steps each,
# tests/test_parallel.py's tolerances, and the ranks' time limit in seconds
SHARDED_MESHES = ((1, 2), (2, 1))
SHARDED_STEPS = 3
# the bands whose rows 1, 2 and 2b are measured on a 1 x 2 mesh: the lower,
# denser one (band 1 holds most of the body's pairs), whose kernels pace the step
BAND_ROWS = (1,)
SHARDED_LOSS_RTOL, SHARDED_LOSS_ATOL = 1e-4, 1e-5
SHARDED_GRAD_RTOL, SHARDED_GRAD_ATOL = 1e-3, 1e-5
SHARDED_PARAM_ATOL = 2e-5
SHARDED_TIMEOUT = 600
SHARDED_DIR = os.path.join(BUILD, "sharded")
# the mesh trainer on both ranks and meshes: MESH_TRAINER (12 iterations, one
# densify round at 10, the eval at the end) under each of MESH_ENGINES, then
# MESH_PROFILE_STEPS steps a call of the queued engine's step profiled; on one
# process a 1 x 1 mesh's queued segment of MESH_SYNC_ITERS steps under the
# sync debug mode "error"
MESH_TRAINER = dict(iterations=12, densify_from_iter=5, densify_until_iter=15,
                    densification_interval=10, opacity_reset_interval=1000)
MESH_EVALS = (12,)
MESH_ENGINES = ("queued", "eager")
MESH_PROFILE_STEPS = 3
MESH_SYNC_ITERS = 6
SERVE_TURNS = 2  # turns of (per-frame list, budgets, budgets, per-frame list) a served frame
STAT_FIELDS = ("xyz_grad_accum", "denom", "max_radii2d")


def emit(obj):
    print(json.dumps(obj), flush=True)


def mismatch(a, b, atol=ATOL):
    """(pixels beyond atol, their allowance, max abs diff) of two images."""
    diff = (a - b).abs().reshape(-1)
    return int((diff > atol).sum()), OUTLIER_FRAC * diff.numel() + 1, float(diff.max())


def check_images(out, ref, what):
    """Hold `out` to `ref` under the image rule; max abs error over all images."""
    worst = 0.0
    for key, atol in (("color", ATOL), ("alpha", ATOL), ("depth", DEPTH_ATOL),
                      ("final_T", ATOL)):
        a, b = out[key], ref[key]
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{what} {key}: shape {tuple(a.shape)} or non-finite values")
        n_out, allowed, mx = mismatch(a, b, atol)
        if n_out > allowed or mx > OUTLIER_ATOL:
            raise AssertionError(
                f"{what} {key}: {n_out} pixels beyond {atol} (allowed {allowed:.0f}), max {mx:.3e}")
        worst = max(worst, mx)
    return worst


def host_ms(fn, n=10, warmup=2):
    """Median host-clock time of n calls of fn, each ended by a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def device_breakdown(fn, top=6):
    """One call of fn under torch.profiler: host wall time, device-busy time
    (the sum of its kernels' device times), idle share, and the kernels that
    took the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    for e in kernels:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    host = [(e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.key.startswith(("aten::", "cuda", "autograd::"))]
    syncs = sum(c for k, _, c in host if k in ("cudaStreamSynchronize", "cudaDeviceSynchronize"))
    # the (23, 3, 3) SVD of the Fisher loss, on the host and on the device
    svd = {"host_self_ms": sum(ms for k, ms, _ in host if "svd" in k.lower()),
           "device_ms": sum(ms for k, ms in by_name.items()
                            if any(w in k.lower() for w in ("svd", "gesvd", "jacobi")))}
    return {"wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
            "kernel_launches": len(kernels),
            "top": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
            "host_syncs": syncs, "svd": svd,
            "top_host_self_ms": [h[:2] for h in sorted(host, key=lambda h: -h[1])[:top]]}


def blend_work(proj, pairs, height, width, max_pairs=1 << 17):
    """(evaluations, contributions) that these inputs need: each pixel walks
    its tile's depth-ordered pairs until it stops (the stopping pair
    included); a contribution is an evaluation that is blended. Tiles are
    taken in groups of at most max_pairs pairs (a longer tile alone), so the
    (pair, pixel) tensors stay small on a large frame."""
    tile = rc.TILE
    grid_w = -(-width // tile)
    counts = pairs.tile_count.long()
    offsets = pairs.tile_offsets.long()
    lane = torch.arange(tile * tile, device=counts.device)
    evals = contribs = 0
    t0, n_tiles = 0, counts.numel()
    while t0 < n_tiles:
        t1 = int(torch.searchsorted(offsets, offsets[t0] + max_pairs, right=True)) - 1
        t1 = min(max(t1, t0 + 1), n_tiles)
        lo, hi = int(offsets[t0]), int(offsets[t1])
        if hi > lo:
            t = torch.repeat_interleave(torch.arange(t1 - t0, device=counts.device),
                                        counts[t0:t1])
            g = pairs.pair_gaussian[lo:hi].long()
            px = (((t + t0) % grid_w) * tile)[:, None] + lane % tile
            py = (((t + t0) // grid_w) * tile)[:, None] + lane // tile
            inside = (px < width) & (py < height)
            dx = proj.mean2d[g, 0:1] - px
            dy = proj.mean2d[g, 1:2] - py
            a, b, c = proj.conic[g, 0:1], proj.conic[g, 1:2], proj.conic[g, 2:3]
            power = -0.5 * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = torch.clamp_max(proj.opacity[g, None] * torch.exp(power), 0.99)
            m = (power <= 0) & (alpha >= 1.0 / 255.0) & inside
            start = offsets[t0:t1] - lo
            log_T = bwd_stages.seg_cumsum(torch.where(m, torch.log1p(-alpha.double()), 0.0),
                                          start, t)
            fired = m & (log_T < math.log(1e-4))
            before = bwd_stages.seg_cumsum(fired.int(), start, t) - fired.int()
            evaluated = (before == 0) & inside
            evals += int(evaluated.sum())
            contribs += int((evaluated & m & ~fired).sum())
        t0 = t1
    return evals, contribs


def kernel_bound(proj, pairs, height, width, work=None):
    evals, contribs = work or blend_work(proj, pairs, height, width)
    P = proj.mean2d.shape[0]
    bytes_ = 4 * (pairs.num_pairs + pairs.tile_offsets.numel() + 10 * P + 6 * height * width)
    flops = OPS_PER_EVAL * evals + OPS_PER_CONTRIB * contribs
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "evaluations": evals, "contributions": contribs, "bytes": bytes_, "flops": flops}


def segments(pairs, seg_len=rc.SEGMENT):
    """How the kernels cut this pair list at seg_len: the segments of the
    busy tiles, the tiles split, and the CTAs launched."""
    counts = pairs.tile_count.long()
    busy = counts[counts > 0]
    return {"seg_len": seg_len, "segments": int(((busy + seg_len - 1) // seg_len).sum()),
            "split_tiles": int((busy > seg_len).sum()),
            "slots": split_blend.num_slots(counts.numel(), pairs.num_pairs, seg_len)}


def unsplit_len(pairs):
    """A segment length no tile exceeds: one segment a tile, one kernel."""
    return max(1, pairs.num_pairs)


def as_images(img, bg):
    """rasterize_cuda's dict from the six planes."""
    return {"color": img[:3].permute(1, 2, 0) + img[5][..., None] * bg, "depth": img[3],
            "alpha": img[4], "final_T": img[5]}


def measure_kernel(proj, bg, height, width):
    """Kernels vs plain on one projected cloud, split and unsplit: errors,
    times and the bound."""
    out = rc.rasterize_cuda(proj, bg, height, width)
    ref = rasterize_reference(proj, bg, height, width, tile_h=rc.TILE, tile_w=rc.TILE)
    err = check_images(out, ref, "kernel vs plain")
    pairs = rc.bin_projected(proj, height, width)
    img, _ = rc.rasterize_pairs(pairs, proj, height, width)
    if not torch.equal(img, rc.rasterize_pairs(pairs, proj, height, width)[0]):
        raise AssertionError("two forward passes on the same input differ")
    plain_split, _ = split_blend.blend_split(pairs, proj, height, width, rc.SEGMENT)
    err_split = check_images(as_images(img, bg), as_images(plain_split, bg),
                             "kernel vs plain segment scheme")
    whole = unsplit_len(pairs)
    err_unsplit = check_images(as_images(rc.rasterize_pairs(pairs, proj, height, width, whole)[0],
                                         bg), ref, "unsplit kernel vs plain")
    return ref, {
        "pairs": pairs.num_pairs,
        "max_tile_pairs": int(pairs.tile_count.max()),
        "busy_tiles": int((pairs.tile_count > 0).sum()),
        **segments(pairs),
        "overflow": int(out["overflow"]),
        "max_abs_err": err,
        "max_abs_err_vs_plain_split": err_split, "max_abs_err_unsplit": err_unsplit,
        "bitwise_repeat": True,
        "ms": cuda_ms(lambda: rc.rasterize_pairs(pairs, proj, height, width),
                      site="rasterize_fwd"),
        "ms_unsplit": cuda_ms(lambda: rc.rasterize_pairs(pairs, proj, height, width, whole),
                              site="rasterize_fwd unsplit"),
        "ms_by_seg_len": {S: cuda_ms(lambda S=S: rc.rasterize_pairs(pairs, proj, height, width, S),
                                     site=f"rasterize_fwd S={S}") for S in SEG_LENS},
        "bin_ms": host_ms(lambda: rc.bin_projected(proj, height, width)),
        "plain_ms": host_ms(
            lambda: rasterize_reference(proj, bg, height, width, tile_h=rc.TILE, tile_w=rc.TILE),
            n=3, warmup=1),
        **kernel_bound(proj, pairs, height, width),
    }


def phase_kernel(dev, H=HW, P=CAPACITY):
    bg = torch.zeros(3, device=dev)
    for name, kw in (("bench", {}), ("bench_opacity_0.01", {"opacity": 0.01}),
                     ("dense_opaque", {"dense": True})):
        proj, _ = bench_scene(dev, H=H, P=P, **kw)
        ref, row = measure_kernel(proj, bg, H, H)
        if kw.get("dense"):
            min_T = float(ref["final_T"].min())
            if min_T >= 1e-3:
                raise AssertionError(f"dense scene did not exercise termination: min T {min_T}")
            row["min_final_T"] = min_T
        emit({"phase": "kernel", "scene": name, "hw": H, "gaussians": P, **row})


def make_cloud(scene, dev, capacity=CAPACITY, n_live=N_LIVE, seed=0):
    """Trained-scale cloud: points jittered 1 cm around the big-pose vertices,
    sigma <= 1 cm (tools/bench_eval_fps.py:96-103), opacity U(0.3, 0.95),
    SH degree 3 with small random higher coefficients."""
    rng = np.random.default_rng(seed)
    verts = scene.big_pose_vertices.cpu().numpy()
    pts = verts[rng.integers(0, verts.shape[0], n_live)] + rng.normal(0, 0.01, (n_live, 3))
    params, valid = G.create_from_points(
        pts.astype(np.float32), rng.uniform(size=(n_live, 3)), capacity, MODEL.sh_degree,
        device=dev)
    params.scaling = torch.clamp_max(params.scaling, math.log(0.01))
    op = torch.as_tensor(rng.uniform(0.3, 0.95, (capacity, 1)).astype(np.float32), device=dev)
    params.opacity = torch.where(valid[:, None], inverse_sigmoid(op), params.opacity)
    f_rest = rng.normal(0, 0.05, params.f_rest.shape).astype(np.float32)
    params.f_rest = torch.as_tensor(f_rest, device=dev) * valid[:, None, None]
    return params, valid


def phase_slice(dev, H=HW, n_verts=N_VERTS, capacity=CAPACITY, n_live=N_LIVE, frames=10):
    """The serving path end to end; returns (kernel row inputs, launches)."""
    scene = make_scene(n_verts=n_verts, device=dev)
    params, valid = make_cloud(scene, dev, capacity, n_live)
    gen = torch.Generator(device=dev).manual_seed(0)
    mlps = {"pose": PoseRefine(gen, dev), "lbs": LBSField(gen, dev)}
    cam = make_camera(H, H, device=dev)
    rng = np.random.default_rng(1)
    smpl_params = {
        "poses": torch.as_tensor(random_pose(rng), device=dev)[None],
        "shapes": torch.zeros((1, 10), device=dev),
        "R": torch.eye(3, device=dev),
        "Th": torch.zeros((1, 3), device=dev),
    }
    bg = torch.zeros(3, device=dev)

    def render(p, v, **kw):
        return render_frame(p, v, mlps, scene, smpl_params, cam, bg, MODEL.sh_degree,
                            motion_offset=MODEL.motion_offset,
                            static_scene=MODEL.static_scene, device=dev, **kw)

    def images(out):
        return {"color": out["render"], "alpha": out["render_alpha"],
                "depth": out["render_depth"], "final_T": out["final_T"]}

    # the serving path, driven once: a full-path frame, then compact, cache
    # the transforms on the compacted cloud (tools/bench_eval_fps.py:119-123)
    # and serve a cached-path frame; the launch count covers exactly this
    rc.launches = 0
    full = render(params, valid)
    params_c, valid_c = G.compact(params, valid)
    cache = render(params_c, valid_c)
    kw = {"cached_transforms": cache["transforms"], "cached_translation": cache["translation"]}
    cached = render(params_c, valid_c, **kw)
    launches = rc.launches
    if launches != 3:
        raise AssertionError(f"the serving path launched the blend kernel {launches} times, not 3")

    full_ref = render(params, valid, rasterize_fn=rasterize_reference)
    err_full = check_images(images(full), images(full_ref), "full path")
    cached_ref = render(params_c, valid_c, rasterize_fn=rasterize_reference, **kw)
    err_cached = check_images(images(cached), images(cached_ref), "cached path")
    full_ms = host_ms(lambda: render(params, valid), n=frames)
    cached_ms = host_ms(lambda: render(params_c, valid_c, **kw), n=frames)
    visible = int(full["visibility_filter"].sum())
    if visible == 0 or float(full["render_alpha"].max()) <= 0:
        raise AssertionError("the slice rendered nothing")
    emit({"phase": "slice", "hw": H, "capacity": capacity, "live": int(valid.sum()),
          "compacted": int(valid_c.numel()), "visible": visible,
          "overflow": int(full["overflow"]), "full_ms_per_frame": full_ms,
          "cached_ms_per_frame": cached_ms, "max_abs_err_full": err_full,
          "max_abs_err_cached": err_cached, "blend_launches": launches})
    emit({"phase": "profile", "path": "full", **device_breakdown(lambda: render(params, valid))})
    emit({"phase": "profile", "path": "cached",
          **device_breakdown(lambda: render(params_c, valid_c, **kw))})

    # the kernel at the shapes the serving path gives it: the full path's
    # projected cloud, captured at the rasterizer's door
    seen = []
    render(params, valid, rasterize_fn=lambda proj, *a: seen.append(proj) or rc.rasterize_cuda(proj, *a))
    _, row = measure_kernel(seen[0], bg, H, H)
    emit({"phase": "kernel", "scene": "slice_full_path", "hw": H, "gaussians": capacity, **row})
    row["max_abs_err"] = max(row["max_abs_err"], err_full, err_cached)
    return row, launches


def bwd_bound(proj, pairs, height, width, stage="full", work=None):
    """The least time for the backward kernel's work on these inputs, at
    `stage` (ops/bwd_stages.py): the pair list, ten floats per Gaussian and
    six gradient planes read, ten floats per pair (and an ablated stage's
    observer plane) written; the operations: load adds six staged values per
    walked (pair, pixel); the other stages do the forward's evaluations and,
    per contribution, 3 (w, T, the observer), 15 (+ dL/dw, prefix, s_after,
    dL/dpower) or OPS_PER_CONTRIB_BWD. work: blend_work's (evaluations,
    contributions), computed if not given."""
    evals, contribs = work or blend_work(proj, pairs, height, width)
    P = proj.mean2d.shape[0]
    bytes_ = 4 * (pairs.num_pairs + pairs.tile_offsets.numel() + 10 * P + 6 * height * width
                  + rc.GRAD_COLS * pairs.num_pairs
                  + (height * width if stage in bwd_stages.ABLATED else 0))
    if stage == "load":
        flops = 6 * pairs.num_pairs * rc.TILE * rc.TILE  # H and W are multiples of the tile
    else:
        per = {"recompute": 3, "suffix": 15}.get(stage, OPS_PER_CONTRIB_BWD)
        flops = OPS_PER_EVAL * evals + per * contribs
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "evaluations": evals, "contributions": contribs, "bytes": bytes_, "flops": flops}


def segment_bound(pairs, P):
    """Rows and positions read once, the (P, 10) sums written; one add per value."""
    bytes_ = 4 * (rc.GRAD_COLS * pairs.num_pairs + pairs.num_pairs + (P + 1) + rc.GRAD_COLS * P)
    flops = rc.GRAD_COLS * pairs.num_pairs
    t_bytes, t_ops = bytes_ / PEAK_BYTES, flops / PEAK_F32
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def segment_lengths(pairs):
    """The distribution of the segment sum's segments (pairs per Gaussian)."""
    lengths = (pairs.gaussian_offsets[1:] - pairs.gaussian_offsets[:-1]).long()
    live = lengths[lengths > 0]
    edges = (0, 1, 2, 3, 5, 9, 17, rc.SEGMENT_LONG + 1)
    hist = {(f"{lo}" if hi == lo + 1 else f"{lo}-{hi - 1}"):
            int(((lengths >= lo) & (lengths < hi)).sum()) for lo, hi in zip(edges, edges[1:])}
    hist[f">{rc.SEGMENT_LONG}"] = int((lengths > rc.SEGMENT_LONG).sum())
    return {"gaussians": lengths.numel(), "empty": int((lengths == 0).sum()),
            "mean_nonempty": float(live.float().mean()) if live.numel() else 0.0,
            "max": int(lengths.max()) if lengths.numel() else 0, "histogram": hist}


def blend_grads(proj, bg, height, width, upstream, raster):
    """Grads of sum(out * upstream) for the five kernel fields and bg."""
    grads, out, _, _ = timed_blend_grads(proj, bg, height, width, upstream, raster, clock=False)
    return grads, out


def timed_blend_grads(proj, bg, height, width, upstream, raster, clock=True):
    """blend_grads with the forward and the backward each on the host clock
    (ended by a synchronize; None with clock=False): (grads, the forward's
    images detached, forward ms, backward ms)."""
    leaves = [getattr(proj, f).detach().clone().requires_grad_() for f in rc._KERNEL_FIELDS]
    bg = bg.detach().clone().requires_grad_()

    def forward():
        return raster(proj._replace(**dict(zip(rc._KERNEL_FIELDS, leaves))), bg, height, width)

    def backward():
        loss = sum((out[k] * upstream[k]).sum() for k in upstream)
        return torch.autograd.grad(loss, leaves + [bg])

    out, fwd_ms = clocked_ms(forward) if clock else (forward(), None)
    grads, bwd_ms = clocked_ms(backward) if clock else (backward(), None)
    return grads, {k: v.detach() for k, v in out.items()}, fwd_ms, bwd_ms


def scaled_err(g, g_ref):
    return float((g - g_ref).abs().max()) / (float(g_ref.abs().max()) + 1e-8)


def measure_backward(proj, bg, height, width, seed=0):
    """Backward kernel + segment sum vs autograd through the plain version
    (remat) on one projected cloud, with upstream grads drawn from `seed`:
    errors, bitwise repeat, times and bounds."""
    gen = torch.Generator(device=bg.device).manual_seed(seed)
    up = {k: torch.randn(s, generator=gen, device=bg.device)
          for k, s in (("color", (height, width, 3)), ("depth", (height, width)),
                       ("alpha", (height, width)), ("final_T", (height, width)))}
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE, remat=True)
    g, out = blend_grads(proj, bg, height, width, up, rc.rasterize_cuda)
    again, _ = blend_grads(proj, bg, height, width, up, rc.rasterize_cuda)
    if not all(torch.equal(a, b) for a, b in zip(g, again)):
        raise AssertionError("two backward passes on the same input differ")
    g_ref, _ = blend_grads(proj, bg, height, width, up, plain)
    errs = {f: scaled_err(a, b) for f, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1])}
    bg_rel = float(((g[-1] - g_ref[-1]).abs() / g_ref[-1].abs()).max())
    if max(errs.values()) > GRAD_ATOL or bg_rel > BG_RTOL or not all(torch.isfinite(x).all() for x in g):
        raise AssertionError(f"backward kernel vs plain: scaled errors {errs}, bg rel {bg_rel:.2e}")

    # the kernels alone, at the inputs the autograd.Function gives them
    pairs = rc.bin_projected(proj, height, width)
    img, state = rc.rasterize_pairs(pairs, proj, height, width)
    # the grads of the six planes; final_T also carries the bg term
    g_img = torch.stack([up["color"][..., 0], up["color"][..., 1], up["color"][..., 2],
                         up["depth"], up["alpha"], up["final_T"] + (up["color"] * bg).sum(-1)])
    gimg = torch.cat([g_img[:5], (g_img * img).sum(0, keepdim=True)]).contiguous()
    rows = rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width, state)
    # the split kernel's rows against the plain segment scheme's, and its
    # grads against the unsplit kernel's (one segment a tile)
    _, plain_state = split_blend.blend_split(pairs, proj, height, width, rc.SEGMENT)
    split_errs = {"rows_vs_plain_split": scaled_err(
        rows, split_blend.blend_split_bwd(pairs, proj, gimg, height, width, plain_state))}
    whole = unsplit_len(pairs)
    _, whole_state = rc.rasterize_pairs(pairs, proj, height, width, whole)

    def unsplit():
        return rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width, whole_state, whole)

    split_errs["grads_vs_unsplit"] = scaled_err(rc.segment_sum(rows, pairs),
                                                rc.segment_sum(unsplit(), pairs))
    if max(split_errs.values()) > GRAD_ATOL:
        raise AssertionError(f"split backward kernel: scaled errors {split_errs}")
    P = proj.mean2d.shape[0]
    index = pairs.pair_gaussian.long()

    def library():
        return torch.zeros((P, rc.GRAD_COLS), device=rows.device).index_add_(0, index, rows)

    seg = rc.segment_sum(rows, pairs)
    if not torch.equal(seg, rc.segment_sum(rows, pairs)):
        raise AssertionError("two segment sums of the same rows differ")
    seg_errs = {"plain": scaled_err(seg, rc.segment_sum_plain(rows, pairs)),
                "index_add_": scaled_err(seg, library())}
    if max(seg_errs.values()) > SEGMENT_RTOL:
        raise AssertionError(f"segment sum vs plain and index_add_: scaled errors {seg_errs}")

    def plain_fwd():
        with torch.no_grad():
            plain(proj, bg, height, width)

    fwd_ms = host_ms(plain_fwd, n=2, warmup=1)
    fwd_bwd_ms = host_ms(lambda: blend_grads(proj, bg, height, width, up, plain), n=2, warmup=1)
    bound = bwd_bound(proj, pairs, height, width)
    segment = {"ms": cuda_ms(lambda: rc.segment_sum(rows, pairs), site="segment_sum"),
               "library_ms": cuda_ms(library, site="segment_sum index_add_"),
               "plain_ms": cuda_ms(lambda: rc.segment_sum_plain(rows, pairs),
                                   site="segment_sum plain"),
               "max_abs_err": float((seg - rc.segment_sum_plain(rows, pairs)).abs().max()),
               "scaled_err": seg_errs, "bitwise_repeat": True, "lengths": segment_lengths(pairs),
               **segment_bound(pairs, P)}
    print(f"segment sum {segment['ms']:.5f} ms, index_add_ {segment['library_ms']:.5f} ms, "
          f"bound {segment['bound_ms']:.5f} ms; pairs per Gaussian {segment['lengths']}",
          flush=True)

    def split_at(S):
        _, st = rc.rasterize_pairs(pairs, proj, height, width, S)
        return lambda: rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width, st, S)

    return {
        "pairs": pairs.num_pairs,
        "max_tile_pairs": int(pairs.tile_count.max()),
        "busy_tiles": int((pairs.tile_count > 0).sum()),
        **segments(pairs),
        "scaled_err": errs, "bg_rel_err": bg_rel, "bitwise_repeat": True,
        "split_scaled_err": split_errs,
        "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(g[:-1], g_ref[:-1])),
        "ms": cuda_ms(lambda: rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width, state),
                      site="rasterize_bwd"),
        "ms_unsplit": cuda_ms(unsplit, site="rasterize_bwd unsplit"),
        "ms_by_seg_len": {S: cuda_ms(split_at(S), site=f"rasterize_bwd S={S}")
                          for S in SEG_LENS},
        "plain_ms": fwd_bwd_ms - fwd_ms, "plain_fwd_bwd_ms": fwd_bwd_ms,
        **bound,
        "segment": segment,
    }


def raster_grads(step, ts, frame, feat, raster, g_img=None):
    """Grads of the step's params and zero mean2d offset through one render
    with `raster`, for image grads g_img of (render, render_alpha), by default
    the six-term loss's own; returns ({group: {name: grad}}, g_img)."""
    gauss = ts.params["gauss"]
    leaves = G.GaussianParams(**{f: getattr(gauss, f).detach().requires_grad_() for f in G.FIELDS})
    offset = torch.zeros((gauss.capacity, 2), device=gauss.xyz.device, requires_grad=True)
    mlps = ts.params["mlps"]
    out = render_frame(leaves, ts.gstate.valid, mlps, step.scene, frame.smpl_params,
                       frame.camera, step.bg, MODEL.sh_degree, rasterize_fn=raster,
                       mean2d_offset=offset, active_sh=0, device=gauss.xyz.device)
    images = [out["render"], out["render_alpha"]]
    if g_img is None:
        total, _ = compute_losses(out, frame.image, frame.bkgd_mask, frame.bound_mask,
                                  frame.pose_rotmats, frame.crop_y0, frame.crop_x0,
                                  step.crop_h, step.crop_w, lpips_params=step.lpips_params,
                                  weights=step.weights, gt_lpips_feats=feat)
        g_img = torch.autograd.grad(total, images, retain_graph=True)
    groups = {**{f: {f: getattr(leaves, f)} for f in G.FIELDS},
              **{k: dict(m.named_parameters()) for k, m in mlps.items()},
              "mean2d_offset": {"mean2d_offset": offset}}
    names = [(k, n) for k, tensors in groups.items() for n in tensors]
    flat = torch.autograd.grad(images, [groups[k][n] for k, n in names], grad_outputs=g_img,
                               allow_unused=True)
    grads = {k: {} for k in groups}
    for (k, n), gr in zip(names, flat):
        grads[k][n] = torch.zeros_like(groups[k][n]) if gr is None else gr
    return grads, g_img


def grad_errors(g, g_ref):
    """{group.name: max|g - g_ref| / scale}: scale is the leaf's max|g_ref|,
    or for an MLP the max over the whole MLP, some of whose parameters have a
    grad that is 0 but for rounding (tests/test_torch_grads.py)."""
    errs = {}
    for group, ref in g_ref.items():
        mlp_scale = max(float(t.abs().max()) for t in ref.values())
        for name, b in ref.items():
            scale = mlp_scale if group in ("pose", "lbs") else float(b.abs().max())
            errs[f"{group}.{name}"] = float((g[group][name] - b).abs().max()) / (scale + 1e-30)
    return errs


def phase_train_kernel(dev, H=HW, P=CAPACITY):
    proj, _ = bench_scene(dev, H=H, P=P)
    row = measure_backward(proj, torch.zeros(3, device=dev), H, H)
    emit({"phase": "train_kernel", "scene": "bench", "hw": H, "gaussians": P, **row})
    return row


def phase_train(dev, H=HW, n_verts=N_VERTS, capacity=CAPACITY, n_live=N_LIVE,
                n_frames=TRAIN_FRAMES, crop=CROP, steps=5, warmup=2):
    """The training path end to end; returns (the backward kernel's row at
    its input, launches of each kernel in the driven run)."""
    scene = make_scene(n_verts=n_verts, device=dev)
    params, valid = make_cloud(scene, dev, capacity, n_live)
    gen = torch.Generator(device=dev).manual_seed(0)
    mlps = {"pose": PoseRefine(gen, dev), "lbs": LBSField(gen, dev)}
    frames, _ = make_frames(scene, n_frames=n_frames, H=H, W=H, crop=crop)
    lp = lpips.init_random(3407, device=dev)
    feats = [lpips.gt_features(lp, crop_window(f.image, f.crop_y0, f.crop_x0, crop, crop))
             for f in frames]
    cfg = Config(model=MODEL)
    init, step = make_train_step(scene, cfg, None, lp, crop, crop, device=dev)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE, remat=True)
    _, plain_step = make_train_step(scene, cfg, plain, lp, crop, crop, device=dev)
    state = {"gauss": params, "mlps": mlps}
    ts = TrainState(state, init(state), G.initial_state(valid), 0)

    # one step through the kernels against the same step through the plain
    # rasterizer, from the same state. The gate holds the loss's image grads
    # fixed (taken once, from the kernel's render) and sends them back through
    # both renders: the bf16 LPIPS towers turn the two renders' 1e-6
    # differences into image grads that differ by up to 1e-3 (PERF.md, Findings),
    # a sensitivity of the loss, not of the rasterizer. The whole step's grads
    # through each path are reported beside it.
    g, g_img = raster_grads(step, ts, frames[0], feats[0], None)
    g_ref, _ = raster_grads(step, ts, frames[0], feats[0], plain, g_img)
    errs = grad_errors(g, g_ref)
    if max(errs.values()) > GRAD_ATOL:
        raise AssertionError(f"train step grads, kernel vs plain: {errs}")
    _, logs, _, gw, offw = step.grads(ts, frames[0], 0, feats[0])
    _, logs_ref, _, gw_ref, offw_ref = plain_step.grads(ts, frames[0], 0, feats[0])
    whole = grad_errors({**gw, "mean2d_offset": {"mean2d_offset": offw}},
                        {**gw_ref, "mean2d_offset": {"mean2d_offset": offw_ref}})
    loss_rel = abs(float(logs["loss"]) - float(logs_ref["loss"])) / abs(float(logs_ref["loss"]))

    # the kernels at the shapes the training path gives them
    seen = []
    render_frame(params, valid, mlps, scene, frames[0].smpl_params, frames[0].camera,
                 step.bg, MODEL.sh_degree, device=dev,
                 rasterize_fn=lambda proj, *a: seen.append(proj) or rc.rasterize_cuda(proj, *a))
    proj = rc.Projected(*(t.detach() if torch.is_tensor(t) else t for t in seen[0]))
    row = measure_backward(proj, step.bg, H, H)
    emit({"phase": "train_kernel", "scene": "train_slice", "hw": H, "gaussians": capacity, **row})
    emit({"phase": "tool_bwd_floor", "scene": "train_slice", "hw": H, "gaussians": capacity,
          **measure_stages(proj, H, H)})
    emit({"phase": "kernel", "scene": "train_slice", "hw": H, "gaussians": capacity,
          **measure_kernel(proj, step.bg, H, H)[1]})

    # the training path, driven once: warm-up and timed steps
    zero_launch_counts()
    times, losses = [], []
    for i in range(warmup + steps):
        k = i % n_frames
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, logs = step(ts, frames[k], 0, feats[k])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(logs["loss"]))
        if int(logs["raster_overflow"]) != 0:
            raise AssertionError("the pair list overflowed")
    launches = launch_counts()
    if any(n != warmup + steps for n in blend(launches).values()):
        raise AssertionError(f"{warmup + steps} steps launched the kernels {launches} times")
    gs = ts.gstate
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    if float(gs.xyz_grad_accum.max()) <= 0 or float(gs.denom.max()) <= 0:
        raise AssertionError("the densify statistics stayed 0")
    emit({"phase": "train", "hw": H, "capacity": capacity, "live": int(valid.sum()), "crop": crop,
          "frames": n_frames, "ms_per_step": float(np.median(times[warmup:])),
          "step_ms": times, "losses": losses,
          "loss_terms": {k: float(v) for k, v in logs.items()},
          "kernel_vs_plain_grad_scaled_err": max(errs.values()),
          "whole_step_grad_scaled_err": {k: max(v for n, v in whole.items()
                                                if n.split(".")[0] == k)
                                         for k in {n.split(".")[0] for n in whole}},
          "kernel_vs_plain_loss_rel_err": loss_rel,
          "xyz_grad_accum_max": float(gs.xyz_grad_accum.max()),
          "denom_max": float(gs.denom.max()), "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    holder = [ts]

    def one_step():
        holder[0], _ = step(holder[0], frames[0], 0, feats[0])

    emit({"phase": "profile", "path": "train_step", **device_breakdown(one_step, top=10)})
    return row, launches, (holder[0], scene)


def densify_agreement(out, ref):
    """A densify round against a reference round on the same inputs:
    (the share of slots where a clone, split, merge or prune mask differs,
    {field or moment: max |a - b| / max |b|} over the slots live in the
    reference where the masks and valid agree)."""
    (params, gstate, opt, stats), (rparams, rgstate, ropt, rstats) = out, ref
    diff = torch.zeros_like(rgstate.valid)
    for k in DENSIFY_MASKS:
        diff |= stats["masks"][k].cpu() != rstats["masks"][k]
    keep = ~diff & (gstate.valid.cpu() == rgstate.valid) & rgstate.valid
    errs = {}
    for f in G.FIELDS:
        errs[f] = scaled_err(getattr(params, f).cpu()[keep], getattr(rparams, f)[keep])
        for m in ("mu", "nu"):
            a, b = getattr(opt[f], m)[f].cpu()[keep], getattr(ropt[f], m)[f][keep]
            errs[f"{f}.{m}"] = scaled_err(a, b)
    return float(diff.float().mean()), errs


def cut_state(ts, n):
    """An n-slot arena cut from a TrainState, on the CPU: the n // 2 live
    Gaussians of least x (a slab of the body, whose neighbourhoods stay whole
    but at its face) in slot order, then free slots (the state's own, repeated
    where it has too few), so that a round's children have room; their window
    statistics and Gaussian moments."""
    g, gs = ts.params["gauss"], ts.gstate
    live = torch.nonzero(gs.valid)[:, 0]
    keep = live[torch.argsort(g.xyz[live, 0], stable=True)[:n // 2]].sort().values
    free = torch.nonzero(~gs.valid)[:, 0]
    idx = torch.cat([keep, free[torch.arange(n - keep.numel(), device=free.device) % free.numel()]])

    def cut(x):
        return x[idx].cpu()

    params = G.GaussianParams(**{f: cut(getattr(g, f)) for f in G.FIELDS})
    gstate = G.GaussianState(valid=cut(gs.valid), max_radii2d=cut(gs.max_radii2d),
                             xyz_grad_accum=cut(gs.xyz_grad_accum), denom=cut(gs.denom),
                             joint_F=gs.joint_F.cpu(), lbs_weight_sum=cut(gs.lbs_weight_sum))
    opt = {f: AdamState(ts.opt_state[f].count, {f: cut(ts.opt_state[f].mu[f])},
                        {f: cut(ts.opt_state[f].nu[f])}) for f in GAUSS_GROUPS}
    return params, gstate, opt


def to_device(state, dev):
    """A cut_state arena on `dev`."""
    params, gstate, opt = state
    return (G.GaussianParams(**{f: getattr(params, f).to(dev) for f in G.FIELDS}),
            G.GaussianState(**{f: getattr(gstate, f).to(dev) for f in (
                "valid", "max_radii2d", "xyz_grad_accum", "denom", "joint_F",
                "lbs_weight_sum")}),
            {g: AdamState(o.count, {k: v.to(dev) for k, v in o.mu.items()},
                          {k: v.to(dev) for k, v in o.nu.items()}) for g, o in opt.items()})


def phase_densify(dev, ts, scene, cuts):
    """One densification round at full width on the train phase's state,
    timed by part; rounds on DENSIFY_CUT-slot cuts (cut_state) of that state
    and of the trainer's states before its rounds (`cuts`: (iteration,
    state) pairs) held to the CPU's. At full width the arena is at the cap,
    so a clone stops the split and the merge; the cuts leave room."""
    cfg = OptimConfig()
    params, gstate, opt = ts.params["gauss"], ts.gstate, ts.opt_state
    verts = scene.big_pose_vertices
    P = params.capacity
    noise = torch.randn((3, P, 3), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)

    def round_():
        return D.densify_and_prune(params, gstate, opt, noise, cfg, 1.0, verts, False)

    out = round_()
    stats = {k: float(v) for k, v in out[3].items() if k != "masks"}
    live = int(out[1].valid.sum())
    if live > P or not all(bool(torch.isfinite(getattr(out[0], f)[out[1].valid]).all())
                           for f in G.FIELDS):
        raise AssertionError(f"the round left {live} live of {P}, or non-finite params")
    ms = host_ms(round_, n=3, warmup=1)

    # its parts, each a call of densify.py's own functions on the round's
    # inputs; the rest (the appends, the prune, the masks) is the remainder
    nbr5 = D.neighbours(params, gstate.valid)
    normals = D.pca_normals(params.xyz, nbr5)
    scaling = G.get_scaling(params)
    nb = nbr5[:, 1].long()

    def kl_and_curvature():
        D.kl_div_gaussians(params.xyz, params.rotation, scaling, params.xyz[nb],
                           params.rotation[nb], scaling[nb])
        D.angle_change_mask(params.xyz, normals, nbr5)

    parts = {name: host_ms(fn, n=3, warmup=1) for name, fn in (
        ("knn_k5", lambda: D.neighbours(params, gstate.valid)),
        ("knn_k1_smpl", lambda: knn(params.xyz, verts, k=1)),
        ("eigh", lambda: D.pca_normals(params.xyz, nbr5)),
        ("svd", lambda: D.fisher_fields(gstate)),
        ("kl_and_curvature", kl_and_curvature))}
    parts["rest"] = ms - sum(parts.values())
    profile = device_breakdown(round_)

    # the share of slots whose curvature mask flips between the card's
    # normals and the CPU's, at full width on the same neighbours
    cpu_normals = D.pca_normals(params.xyz.cpu(), nbr5.cpu()).to(dev)
    valid = gstate.valid
    curv_flip_full = float((D.angle_change_mask(params.xyz, normals, nbr5)
                            != D.angle_change_mask(params.xyz, cpu_normals, nbr5))[valid]
                           .float().mean())
    normal_sign_flip_full = float(((normals * cpu_normals).sum(-1) < 0)[valid].float().mean())

    # the cuts' rounds, on the card and on the CPU, with the same noise and
    # normals; every op must land in them
    cut_rows = []
    landed = {"cloned": 0, "split": 0, "merged": 0}
    for it, state in [(0, cut_state(ts, DENSIFY_CUT))] + list(cuts):
        p_cpu, gs_cpu, o_cpu = state
        p_dev, gs_dev, o_dev = to_device(state, dev)
        cut = p_cpu.capacity
        noise_cut = torch.randn((3, cut, 3), generator=torch.Generator().manual_seed(it))
        cut_normals = D.pca_normals(p_cpu.xyz, D.neighbours(p_cpu, gs_cpu.valid))
        ref = D.densify_and_prune(p_cpu, gs_cpu, o_cpu, noise_cut, cfg, 1.0, verts.cpu(), False,
                                  normals=cut_normals)
        card = D.densify_and_prune(p_dev, gs_dev, o_dev, noise_cut.to(dev), cfg, 1.0, verts,
                                   False, normals=cut_normals.to(dev))
        share, errs = densify_agreement(card, ref)
        stats_cpu = {k: float(v) for k, v in ref[3].items() if k != "masks"}
        stats_card = {k: float(v) for k, v in card[3].items() if k != "masks"}
        if share > DENSIFY_MASK_SHARE or max(errs.values()) > DENSIFY_RTOL:
            raise AssertionError(f"densify on the card vs the CPU, round {it}: masks differ on "
                                 f"{share:.2e} of the slots, scaled errors {errs}")
        for k in landed:
            landed[k] += int(stats_cpu[k])
        own = D.densify_and_prune(p_dev, gs_dev, o_dev, noise_cut.to(dev), cfg, 1.0, verts,
                                  False)
        curv_flip = float((own[3]["masks"]["curv"].cpu() != ref[3]["masks"]["curv"])
                          [gs_cpu.valid].float().mean())
        cut_rows.append({"round": it or "train", "capacity": cut, "live": int(gs_cpu.valid.sum()),
                         "mask_disagree_share": share, "max_scaled_err": max(errs.values()),
                         "scaled_err": errs, "stats_card": stats_card, "stats_cpu": stats_cpu,
                         "curv_flip_share_own_normals": curv_flip})
    if min(landed.values()) == 0:
        raise AssertionError(f"the cut rounds landed {landed}: every op must land")
    flips = [r["curv_flip_share_own_normals"] for r in cut_rows]
    print(f"densify round {ms:.2f} ms at {P} capacity, {int(gstate.valid.sum())} live; parts "
          f"{parts}; cut rounds {[r['round'] for r in cut_rows]} landed {landed}; curvature "
          f"mask flips with the card's own normals: {flips} of the cuts' live slots, "
          f"{curv_flip_full:.4f} at full width", flush=True)
    emit({"phase": "densify", "capacity": P, "live_before": int(gstate.valid.sum()),
          "stats": stats, "ms": ms, "parts_ms": parts, "profile": profile,
          "cuts": cut_rows, "cuts_landed": landed,
          "curv_flip_share_full": curv_flip_full,
          "normal_sign_flip_share_full": normal_sign_flip_full})


def trainer_config():
    return Config(model=MODEL, optim=OptimConfig(**TRAINER),
                  pipe=PipelineConfig(test_iterations=TRAINER_EVALS, save_iterations=()))


def trainer_run(dev, scene, frames, lp, timed=False, ckpt_dir=None):
    """One Trainer run of the TRAINER schedule: (trainer, the rounds' stats,
    host-clock ms of steps, rounds and eval frames when timed, and each
    round's iteration with a DENSIFY_CUT cut of the state it started from,
    cut_state). With ckpt_dir, its ckpt_fn writes chkpnt{RESUME_AT}.npz
    there, the state after step RESUME_AT."""
    cfg = trainer_config()
    tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], cfg, lp,
                 crop_hw=(CROP, CROP), device=dev)
    rounds, cuts, times = [], [], {"step": [], "densify": [], "eval": []}

    def clocked(fn, key):
        def run(*a, **kw):
            if timed:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if timed:
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    densify = clocked(tr.densify, "densify")

    def counted_densify(it):
        if timed:
            cuts.append((it, cut_state(tr.ts, DENSIFY_CUT)))
        stats = densify(it)
        live = int(tr.ts.gstate.valid.sum())
        rounds.append({"round": it, "live": live,
                       **{k: int(v) for k, v in stats.items() if k != "masks"}})
        if live > cfg.model.capacity or int(stats["count_after"]) != live:
            raise AssertionError(f"round {it}: {live} live in {cfg.model.capacity}")
        return stats

    tr.densify = counted_densify
    tr.evaluate = clocked(tr.evaluate, "eval")
    with clocked_steps(clocked):
        tr.train(ckpt_fn=None if ckpt_dir is None else lambda it: tr.save(
            os.path.join(ckpt_dir, f"chkpnt{it}.npz")) if it == RESUME_AT else None)
    return tr, rounds, times, cuts


@contextlib.contextmanager
def clocked_steps(clocked):
    """Every TrainStep call clocked (clocked(fn, "step")), the steps the
    trainer rebuilds when a budget grows included."""
    call = TrainStep.__call__
    TrainStep.__call__ = clocked(call, "step")
    try:
        yield
    finally:
        TrainStep.__call__ = call


def phase_trainer(dev, H=HW, n_verts=N_VERTS, ckpt_dir=CKPT_DIR):
    """The trainer path end to end, once (the engines phase runs its schedule
    three times, bitwise equal); returns the kernels' launches in the run,
    its rounds' cuts and (trainer, scene, frames, LPIPS params) of that run,
    which also wrote chkpnt{RESUME_AT}.npz to ckpt_dir."""
    scene = make_scene(n_verts=n_verts, device=dev)
    frames, _ = make_frames(scene, n_frames=TRAIN_FRAMES + 1, H=H, W=H, crop=CROP,
                            opacity=TARGET_OPACITY)
    lp = lpips.init_random(3407, device=dev)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    os.makedirs(ckpt_dir)
    zero_launch_counts()
    tr, rounds, times, cuts = trainer_run(dev, scene, frames, lp, timed=True, ckpt_dir=ckpt_dir)
    launches = launch_counts()
    iters = TRAINER["iterations"]
    eval_frames = len(TRAINER_EVALS) * (len(frames) - TRAIN_FRAMES)
    want = {"rasterize_fwd": iters + eval_frames, "rasterize_bwd": iters, "segment_sum": iters}
    if blend(launches) != want:
        raise AssertionError(f"the trainer launched the kernels {launches} times, not {want}")
    hist = tr.metrics_history
    psnr = {m["iteration"]: m["psnr"] for m in hist}
    if [m["iteration"] for m in hist] != list(TRAINER_EVALS) or \
            not min(psnr[20], psnr[30]) >= psnr[1] + PSNR_GAIN_DB or \
            not psnr[60] > psnr[31]:
        raise AssertionError(f"the trainer's evals: {hist}")
    if len(rounds) != 4 or sum(r["cloned"] + r["split"] for r in rounds) == 0:
        raise AssertionError(f"the rounds: {rounds}")

    steps = np.array(times["step"])
    outside = [t for i, t in enumerate(steps, 1) if i not in {r["round"] for r in rounds}]
    counts = [r["live"] for r in rounds]
    print(f"trainer: {float(np.median(outside)):.2f} ms per iteration, densify rounds "
          f"{[round(t, 1) for t in times['densify']]} ms, eval frames "
          f"{[round(t, 1) for t in times['eval']]} ms, live after the rounds {counts}, "
          f"psnr {psnr}", flush=True)
    emit({"phase": "trainer", "hw": H, "crop": CROP, "capacity": MODEL.capacity,
          "initial_points": N_VERTS, "target_opacity": TARGET_OPACITY, "schedule": TRAINER,
          "evals": TRAINER_EVALS, "ms_per_iteration": float(np.median(outside)),
          "step_ms": times["step"], "ms_per_densify_round": times["densify"],
          "ms_per_eval_frame": float(np.median(times["eval"])), "eval_ms": times["eval"],
          "live_after_rounds": counts, "rounds": rounds, "metrics_history": hist,
          "s_to_best_pre_reset_eval": max((m for m in hist if m["iteration"] <= 30),
                                          key=lambda m: m["psnr"])["elapsed_s"],
          "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return launches, cuts, (tr, scene, frames, lp)


# the engines phase: the trainer phase's scene and schedule under each of the
# trainer's dispatch engines, states compared at ENGINE_CHECKS; steps of a
# profiled call; the forced overflow's run (a budget of half the need)
ENGINES = ("eager", "queued", "scan")
ENGINE_CHECKS = (20, 60)
PROFILE_STEPS = 10
HEAL_ITERS = 12
HEAL_EVALS = (4, HEAL_ITERS)
# the 3x3 SVD kernel against torch.linalg.svd: S within this share of the
# largest singular value, U diag(g) V^T within SVD_ATOL where the values are apart
SVD_RTOL, SVD_ATOL = 1e-5, 1e-4
# f32 operations of one matrix in csrc/svd3.cu: 8 sweeps of 3 rotations (the
# three dot products, zeta, t, c, s and the two rotated column pairs), then
# the norms, u1, u2, u3 and s3
SVD_OPS = 8 * 3 * 52 + 100
SVD_BYTES = 4 * (9 + 9 + 3 + 9 + 1)


def launch_counts():
    """The training path's kernels' launches since zero_launch_counts, as
    their wrappers counted them (calls recorded into a CUDA graph are not)."""
    return {"rasterize_fwd": rc.launches, "rasterize_bwd": rc.bwd_launches,
            "segment_sum": rc.segment_launches, "svd3": fisher.launches}


def zero_launch_counts():
    rc.launches = rc.bwd_launches = rc.segment_launches = fisher.launches = 0


BLEND_KERNELS = ("rasterize_fwd", "rasterize_bwd", "segment_sum")


def blend(launches):
    """The blend kernels' part of launch_counts()."""
    return {k: launches[k] for k in BLEND_KERNELS}


def engine_run(dev, scene, frames, lp, engine):
    """One TRAINER run under `engine` (queued and scan with every segment
    under torch.cuda's sync debug mode "error"): (trainer, the flattened
    state after each of ENGINE_CHECKS, its timings, the kernels' launches in
    the run)."""
    tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], trainer_config(), lp,
                 crop_hw=(CROP, CROP), device=dev)
    if engine != "eager":
        tr.segment_sync_mode = "error"
    states, host = {}, {"densify": [], "eval": [], "budgets": [], "checkpoint": []}

    def timed(fn, key):
        def run(*a, **kw):
            out, ms = clocked_ms(lambda: fn(*a, **kw))
            host[key].append(ms)
            return out
        return run

    tr.densify = timed(tr.densify, "densify")
    tr.evaluate = timed(tr.evaluate, "eval")
    tr._resize_pair_buffer = timed(tr._resize_pair_buffer, "budgets")
    ckpt_fn = timed(lambda it: states.__setitem__(it, ckpt.flatten(tr.ts)), "checkpoint")
    zero_launch_counts()
    _, wall = clocked_ms(lambda: tr.train(eval_iters=ENGINE_CHECKS, ckpt_fn=ckpt_fn,
                                          dispatch_engine=engine))
    launches = launch_counts()
    iters = TRAINER["iterations"]
    steps_ms = wall - sum(sum(v) for v in host.values())
    many = tr._many
    return tr, states, {
        "wall_ms": wall, "host_work_ms": {k: sum(v) for k, v in host.items()},
        "ms_per_iteration": steps_ms / iters,
        "ms_per_iteration_without_captures": (steps_ms - sum(many.capture_ms)) / iters,
        "captures": many.captures, "replays": many.replays,
        "captured_launches": dict(many.captured_launches), "capture_ms": list(many.capture_ms),
        "pool_mb": many.pool_mb if engine == "scan" else 0.0}, launches


def trace_events(prof):
    """(name, device type, us) of each event a stopped torch.profiler
    recorded, read from its raw results: the events, names and durations
    prof.events() and key_averages() are built from (less the profiler's own,
    which they drop too), without building their objects, which took 10-36 s
    a profile at 6,000 launches a step."""
    from torch.autograd.profiler_util import _filter_name

    results = prof.profiler.kineto_results
    t0, out = results.trace_start_ns(), []
    for e in results.events():
        name = e.name()
        if not (_filter_name(name) or getattr(e, "is_hidden_event", lambda: False)()):
            # from the trace's start, as FunctionEvent's time range
            out.append((name, e.device_type(), (e.end_ns() - t0) / 1e3 - (e.start_ns() - t0) / 1e3))
    return out


def engine_breakdown(fn, steps):
    """fn (steps training steps and their log read) once to warm up, once on
    the host clock (steady ms a step), then once under torch.profiler:
    device-busy ms and the idle share, device ops, the port's four training
    kernels found by name in the trace, kernel-launch and graph-launch API
    calls, host syncs and the kernels that took the most device time, each a
    step (the profiler slows the host's launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    _, steady = clocked_ms(fn)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = trace_events(prof)
    device = [(name, us) for name, kind, us in events if kind == DeviceType.CUDA]
    busy = sum(us for _, us in device) / 1e3
    # the port's kernels by name in the trace (a graph's replays list each kernel they run)
    named = {k: sum(1 for name, _ in device if f"{k}_kernel" in name) / steps
             for k in ("rasterize_fwd", "rasterize_bwd", "segment_sum", "svd3")}
    if busy <= 0:
        raise AssertionError("the profiler recorded no device time")
    calls = collections.Counter(name for name, _, _ in events)
    by_name = {}
    for name, us in device:
        by_name[name[:70]] = by_name.get(name[:70], 0.0) + us / 1e3

    def n(*keys):
        return sum(calls.get(k, 0) for k in keys)

    return {"steady_ms_per_step": steady / steps, "wall_ms": wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall,
            "device_ops_per_step": len(device) / steps, "kernels_traced_per_step": named,
            "launch_calls_per_step": n("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                                       "cuLaunchKernelEx") / steps,
            "graph_launches_per_step": n("cudaGraphLaunch") / steps,
            "syncs_per_step": n("cudaStreamSynchronize", "cudaDeviceSynchronize",
                                "cudaEventSynchronize") / steps,
            "memcpy_calls_per_step": n("cudaMemcpyAsync", "cudaMemcpy") / steps,
            "top_device_ms_per_step": [(k, v / steps) for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:12]]}


def engine_profile(tr, engine, steps=PROFILE_STEPS):
    """Steps past the run's end (tables for a longer run, no skips there) of
    the trained state, as `engine` runs them: eager a step a call and its
    logs read every 10, queued one call and one read, scan one call of a
    captured graph and one read; engine_breakdown of that."""
    cfg = dataclasses.replace(tr.cfg.optim, iterations=int(tr.ts.step) + 4 * steps)
    tr._train_step.tables = optim.step_tables(cfg, False, optim.param_groups(tr.ts.params),
                                              tr.extent, tr.device)
    frames = stage_frames(tr.train_frames)
    feats = tr._gt_lpips_features()
    stacked = None if feats is None else [torch.stack(f) for f in zip(*feats)]
    order = torch.arange(steps, device=tr.device) % len(tr.train_frames)
    many = make_train_many(tr.step_fn, tr.cfg.model.sh_degree, per_step_logs=True,
                           graph=engine == "scan")
    ts = device_state(tr.ts)

    def run():
        if engine == "eager":
            for i in range(steps):
                _, logs = many(ts, frames, order[i:i + 1], stacked)
                if (i + 1) % 10 == 0:
                    logs["loss"].cpu()
        else:
            _, logs = many(ts, frames, order, stacked)
            logs["loss"].cpu()

    out = engine_breakdown(run, steps)
    out["captures"], out["replays"] = many.captures, many.replays
    return out


def capture_line(many, replaced):
    """The capture `many` (a make_train_many) just made: its ms and graph
    pool MB, the card's reserved and allocated MB just after, and whether
    the graph it replaced (a weakref, or None) was freed."""
    return {"ms": many.capture_ms[-1], "pool_mb": many.pool_mb,
            "reserved_mb": torch.cuda.memory_reserved() / 2**20,
            "allocated_mb": torch.cuda.memory_allocated() / 2**20,
            "replaced_graph_freed": None if replaced is None else replaced() is None}


@contextlib.contextmanager
def captures_recorded(out, extra=lambda: {}):
    """Every CUDA graph capture a make_train_many makes inside, appended to
    `out` as its capture_line and extra()'s keys."""
    from moss_torch.train.train_step import TrainMany

    run_graph = TrainMany._run_graph

    def spy(many, *a, **kw):
        old = None if many._graph is None else weakref.ref(many._graph)
        n = many.captures
        result = run_graph(many, *a, **kw)
        if many.captures != n:
            out.append({**extra(), **capture_line(many, old)})
        return result

    TrainMany._run_graph = spy
    try:
        yield out
    finally:
        TrainMany._run_graph = run_graph


def capture_memory_gate(caps, what):
    """The reference schedule's rule on a run's captures (capture_line
    each, two at least): the graph pools do not pile up (the card's
    reserved MB after the last capture at most that after the second plus
    the largest pool) and
    nothing a capture leaves lives on (its allocated MB at most
    CAPTURE_LEAK_MB above the second's: the state's capacity is fixed; a
    warm-up stream a capture left ~65 MB of cuBLAS workspace allocated each
    time), every replaced graph freed. Returns what it read."""
    if len(caps) < 2:
        raise AssertionError(f"{what}: {len(caps)} captures")
    pool = max(c["pool_mb"] for c in caps)
    grew = caps[-1]["allocated_mb"] - caps[1]["allocated_mb"]
    if caps[-1]["reserved_mb"] > caps[1]["reserved_mb"] + pool or grew > CAPTURE_LEAK_MB or \
            not all(c["replaced_graph_freed"] in (None, True) for c in caps):
        raise AssertionError(f"{what}: the graph pools pile up: reserved "
                             f"{caps[1]['reserved_mb']:.0f} MB after the second capture, "
                             f"{caps[-1]['reserved_mb']:.0f} after the last, a pool {pool:.0f}; "
                             f"allocated {grew:.1f} MB more; {caps}")
    return {"captures": len(caps), "reserved_bound_mb": caps[1]["reserved_mb"] + pool,
            "allocated_growth_mb": grew}


def captured_projection(tr, frame):
    """The Projected that tr's render of `frame` hands its rasterizer."""
    got = {}

    def capture(proj, bg, h, w):
        got["proj"] = proj
        z = torch.zeros((h, w), device=bg.device)
        return {"color": torch.zeros((h, w, 3), device=bg.device), "depth": z, "alpha": z,
                "final_T": z}

    with torch.no_grad():
        render_frame(tr.ts.params["gauss"], tr.ts.gstate.valid, tr.ts.params["mlps"], tr.scene,
                     frame.smpl_params, frame.camera, tr.bg, MODEL.sh_degree,
                     rasterize_fn=capture, device=tr.device)
    return got["proj"]


def capacity_rows(proj, bg, height, width, pair_budget, max_tiles):
    """Rows 1, 2 and 2b at the budgeted capacity NPb (CTAs num_tiles + ceil(NPb /
    S), surplus ones returning) against the per-frame list's: the same image,
    rows and sums bit for bit (the kept pairs are the live ones: overflow 0);
    the image against the plain blend of the kept pairs and the grads against
    autograd through it (remat); each kernel's time at both sizes."""
    cap = rc.bin_projected(proj, height, width, pair_budget, max_tiles)
    live = rc.bin_projected(proj, height, width)
    n = live.num_pairs
    if int(cap.overflow) != 0 or int(cap.tile_offsets[-1]) != n or \
            not torch.equal(cap.pair_gaussian[:n], live.pair_gaussian):
        raise AssertionError(f"the budgeted list is not the live one: overflow {int(cap.overflow)}")
    img_c, state_c = rc.rasterize_pairs(cap, proj, height, width)
    img_l, state_l = rc.rasterize_pairs(live, proj, height, width)
    if not torch.equal(img_c, img_l):
        raise AssertionError("the forward kernel at capacity differs from the live list's")
    mask = binning.kept_pair_mask(cap, proj.mean2d.shape[0], cap.tile_offsets.numel() - 1)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE, remat=True,
                              pair_mask=mask)
    err_fwd = check_images(as_images(img_c, bg), plain(proj, bg, height, width),
                           "capacity kernel vs plain")
    gen = torch.Generator(device=bg.device).manual_seed(5)
    up = {"color": torch.randn((height, width, 3), generator=gen, device=bg.device)}
    kernel = functools.partial(rc.rasterize_cuda, pair_budget=pair_budget,
                               max_tiles_per_gaussian=max_tiles)
    g, _ = blend_grads(proj, bg, height, width, up, kernel)
    g_ref, _ = blend_grads(proj, bg, height, width, up, plain)
    errs = {f: scaled_err(a, b) for f, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1])}
    if max(errs.values()) > GRAD_ATOL:
        raise AssertionError(f"capacity backward vs plain: scaled errors {errs}")
    gimg = torch.randn((6, height, width), generator=gen, device=bg.device)
    rows_c = rc.rasterize_pairs_bwd(cap, proj, gimg, height, width, state_c)
    rows_l = rc.rasterize_pairs_bwd(live, proj, gimg, height, width, state_l)
    if not (torch.equal(rows_c[:n], rows_l) and not rows_c[n:].any()):
        raise AssertionError("the backward kernel's rows at capacity differ from the live list's")
    if not torch.equal(rc.segment_sum(rows_c, cap), rc.segment_sum(rows_l, live)):
        raise AssertionError("the segment sum at capacity differs from the live list's")
    S = rc.SEGMENT
    return {"pairs": n, "npb": cap.num_pairs, "slots_live": split_blend.num_slots(
        live.tile_count.numel(), n, S), "slots_capacity": split_blend.num_slots(
        cap.tile_count.numel(), cap.num_pairs, S), "max_abs_err": err_fwd, "grad_scaled_err": errs,
        "rasterize_fwd": {"ms_capacity": cuda_ms(lambda: rc.rasterize_pairs(
            cap, proj, height, width), site="rasterize_fwd capacity"),
            "ms_live": cuda_ms(lambda: rc.rasterize_pairs(live, proj, height, width),
                               site="rasterize_fwd")},
        "rasterize_bwd": {"ms_capacity": cuda_ms(lambda: rc.rasterize_pairs_bwd(
            cap, proj, gimg, height, width, state_c), site="rasterize_bwd capacity"),
            "ms_live": cuda_ms(lambda: rc.rasterize_pairs_bwd(
                live, proj, gimg, height, width, state_l), site="rasterize_bwd")},
        "segment_sum": {"ms_capacity": cuda_ms(lambda: rc.segment_sum(rows_c, cap),
                                               site="segment_sum capacity"),
                        "ms_live": cuda_ms(lambda: rc.segment_sum(rows_l, live),
                                           site="segment_sum")},
        "bin_ms_capacity": host_ms(lambda: rc.bin_projected(proj, height, width, pair_budget,
                                                            max_tiles)),
        "bin_ms_live": host_ms(lambda: rc.bin_projected(proj, height, width))}


SVD_GENERAL = 4096   # random 3x3 matrices with well-separated singular values
SVD_NEAR_EYE = 1024  # and near-identity ones, in svd3_row's general batch
# an f32 SVD fixes a singular vector only to about eps |A| / gap, so U diag(g)
# V^T is held at SVD_ATOL where every gap between singular values is above
# SVD_APART of the largest
SVD_APART = 1e-2


def svd3_general(dev, seed=0):
    """svd3_row's general batch from a seed: Q1 diag(s) Q2 with Haar-random
    orthogonal Q1, Q2 (reflections included) and s drawn in [2, 3], [0.9,
    1.6], [0.05, 0.5], then I + 1e-3 noise."""
    rng = np.random.default_rng(seed)
    q1 = np.linalg.qr(rng.standard_normal((SVD_GENERAL, 3, 3)))[0]
    q2 = np.linalg.qr(rng.standard_normal((SVD_GENERAL, 3, 3)))[0]
    sv = np.stack([rng.uniform(2.0, 3.0, SVD_GENERAL), rng.uniform(0.9, 1.6, SVD_GENERAL),
                   rng.uniform(0.05, 0.5, SVD_GENERAL)], 1)
    sep = np.einsum("bij,bj,bjk->bik", q1, sv, q2)
    eye = np.eye(3) + 1e-3 * rng.standard_normal((SVD_NEAR_EYE, 3, 3))
    return torch.as_tensor(np.concatenate([sep, eye]).astype(np.float32), device=dev)


def svd3_check(F_, what):
    """csrc/svd3.cu on (n, 3, 3) F_ against torch.linalg.svd (svd3_plain):
    bitwise repeatable; S and the proper S within SVD_RTOL of each matrix's
    largest singular value; U diag(S) V^T rebuilding F_ within SVD_ATOL of
    it; where the singular values are SVD_APART apart, U diag(g) V^T (the
    gradient's form) within SVD_ATOL of the plain one's (backward_err None
    where none is). Returns the errors and how many matrices were apart."""
    U, S, V, sign = fisher.svd3(F_)
    again = fisher.svd3(F_)
    if not all(torch.equal(a, b) for a, b in zip((U, S, V, sign), again)):
        raise AssertionError(f"svd3 {what}: two launches on the same input differ")
    Ur, Sr, Vr, sr = fisher.svd3_plain(F_)
    scale = Sr[:, :1].clamp_min(1.0)

    def proper(S, s):
        return S * torch.stack([torch.ones_like(s), torch.ones_like(s), s], 1)

    err_s = float(((S - Sr).abs() / scale).max())
    err_p = float(((proper(S, sign) - proper(Sr, sr)).abs() / scale).max())
    rebuilt = torch.einsum("bik,bk,bjk->bij", U, S, V)
    err_a = float((rebuilt - F_).abs().max())
    g = torch.tensor([0.3, -1.2, 0.7], device=F_.device)
    apart = ((Sr[:, :2] - Sr[:, 1:]) > SVD_APART * scale).all(1)
    back = torch.einsum("bik,bk,bjk->bij", U, proper(g.expand_as(S), sign), V)
    back_r = torch.einsum("bik,bk,bjk->bij", Ur, proper(g.expand_as(Sr), sr), Vr)
    err_b = float((back - back_r)[apart].abs().max()) if bool(apart.any()) else None
    out = {"matrices": F_.shape[0], "apart": int(apart.sum()), "s_err": err_s,
           "proper_s_err": err_p, "rebuild_err": err_a, "backward_err": err_b}
    if max(err_s, err_p) > SVD_RTOL or err_a > SVD_ATOL or (err_b is not None
                                                             and err_b > SVD_ATOL):
        raise AssertionError(f"svd3 {what} vs torch.linalg.svd: {out}")
    return out


def svd3_row(Rs):
    """csrc/svd3.cu against torch.linalg.svd (the plain version and the
    library call), svd3_check on two inputs: the pose MLPs' 23 rotations
    (the path's shape; all their singular values are 1, so none is apart)
    and svd3_general's batch, in which matrices must be apart. Times and the
    bound on the rotations. Its launches are not counted."""
    F_ = Rs.detach().reshape(-1, 3, 3).contiguous()
    before = fisher.launches
    rot = svd3_check(F_, "on the rotations")
    general = svd3_check(svd3_general(F_.device), "on the general batch")
    if general["apart"] < SVD_GENERAL:
        raise AssertionError(f"svd3: {general['apart']} of the general batch apart, want at "
                             f"least {SVD_GENERAL}")
    n = F_.shape[0]
    t_bytes, t_ops = n * SVD_BYTES / PEAK_BYTES, n * SVD_OPS / PEAK_F32
    row = {"matrices": n, "max_abs_err": max(rot["proper_s_err"], general["proper_s_err"]),
           "backward_err": general["backward_err"], "rebuild_err": max(
               rot["rebuild_err"], general["rebuild_err"]), "rotations": rot,
           "general": general, "bitwise_repeat": True,
           "ms": cuda_ms(lambda: fisher.svd3(F_), site="svd3"),
           "plain_ms": cuda_ms(lambda: fisher.svd3_plain(F_), site="svd3 plain"),
           "library_ms": cuda_ms(lambda: torch.linalg.svd(F_, full_matrices=False),
                                 site="svd3 torch.linalg.svd"),
           "bound_ms": 1e3 * max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes > t_ops else "operations"}
    fisher.launches = before  # a comparison: not counted
    return row


def phase_engines(dev, smi):
    """The trainer's three dispatch engines at full width (phase 7b): the
    trainer phase's scene, frames, capacity, crop, loss and TRAINER schedule
    (60 iterations, rounds at 20-50, a reset at 30) once per engine. Gates:
    every queued and scan segment under the sync debug mode "error"; the scan
    engine's state (a CUDA graph of the step, replayed) and the queued one's
    bitwise eager's after ENGINE_CHECKS; each kernel of the step launched in
    every run; a forced overflow (half the probed need
    installed) counted, healed and regrown, the next segment reading 0. Per
    engine: ms per iteration outside the rounds, evals and budget probes, a
    profiled call's launches, syncs and idle share a step, captures and ms per
    capture, the graph pool's MB, the budgets installed. Rows 1, 2 and 2b at
    the budgeted capacity against the live list's and the plain blend, with
    both times; svd3 against torch.linalg.svd. Launches are the wrappers'
    counts: under scan only the warm-up step of each capture; its replays are
    shown by the profiled replays' trace, which must name each kernel every
    step, and reported as replays x calls captured. Returns ({engine:
    launches}, the scan graph's counts, the capacity rows, the svd3 row)."""
    scene = make_scene(n_verts=N_VERTS, device=dev)
    frames, _ = make_frames(scene, n_frames=TRAIN_FRAMES + 1, H=HW, W=HW, crop=CROP,
                            opacity=TARGET_OPACITY)
    lp = lpips.init_random(3407, device=dev)
    runs, launches, rows = {}, {}, {}
    ref_states = None
    for engine in ENGINES:
        tr, states, timing_row, launches[engine] = engine_run(dev, scene, frames, lp, engine)
        if sorted(states) != list(ENGINE_CHECKS):
            raise AssertionError(f"{engine}: states at {sorted(states)}")
        if any(n == 0 for n in launches[engine].values()):
            raise AssertionError(f"{engine}: a kernel of the step never launched: "
                                 f"{launches[engine]}")
        if engine == "eager":
            ref_states, ref_hist = states, tr.metrics_history
        else:
            for it in ENGINE_CHECKS:
                diff = [k for k in ref_states[it] if not np.array_equal(ref_states[it][k],
                                                                        states[it][k])]
                if diff or sorted(states[it]) != sorted(ref_states[it]):
                    raise AssertionError(f"{engine} differs from eager after {it}: {diff[:8]}")
            strip = [{k: v for k, v in m.items() if k != "elapsed_s"} for m in tr.metrics_history]
            if strip != [{k: v for k, v in m.items() if k != "elapsed_s"} for m in ref_hist]:
                raise AssertionError(f"{engine}: evals differ from eager's")
        if engine == "queued" and launches["queued"] != launches["eager"]:
            raise AssertionError(f"queued launched {launches['queued']}, eager "
                                 f"{launches['eager']}")
        timing_row["budgets"] = tr.budgets
        timing_row["profile"] = prof = engine_profile(tr, engine)
        runs[engine] = timing_row
        if engine == "scan":
            # the wrappers counted the warm-up step of each capture; the
            # replays ran the other steps, which the trace must show by name
            many = tr._many
            graph = {"captures": many.captures, "replays": many.replays,
                     "captured_launches": dict(many.captured_launches),
                     "replays_x_captured": {k: many.replays * n
                                            for k, n in many.captured_launches.items()},
                     "profiled_replays": prof["replays"],
                     "traced_per_replay": prof["kernels_traced_per_step"]}
            if many.captures < 1 or many.pool_mb <= 0 or \
                    many.captures + many.replays != TRAINER["iterations"]:
                raise AssertionError(f"scan: {graph}, pool {many.pool_mb} MB")
            if any(launches["scan"][k] != many.captures for k in ("rasterize_bwd",
                                                                  "segment_sum")):
                raise AssertionError(f"scan launched {launches['scan']} outside its graphs in "
                                     f"{many.captures} warm-up steps")
            if prof["captures"] != 1 or prof["replays"] != 3 * PROFILE_STEPS - 1 or \
                    prof["launch_calls_per_step"] >= 1 or prof["graph_launches_per_step"] != 1:
                raise AssertionError(f"scan's profiled call was not all replays: {prof}")
            traced = prof["kernels_traced_per_step"]
            if any(traced[k] < max(n, 1) or traced[k] != int(traced[k])
                   for k, n in many.captured_launches.items()):
                raise AssertionError(f"scan's replays ran {traced} a step by name, the "
                                     f"capture recorded {many.captured_launches}")
        if engine == "queued":
            b = tr.budgets
            proj = captured_projection(tr, tr.train_frames[0])
            rows = capacity_rows(proj, tr.bg, HW, HW, b["pair_budget"], b["max_tiles"])
            with torch.no_grad():
                Rs = tr.ts.params["mlps"]["pose"](tr.train_frames[0].poses)["Rs"]
            svd_row = svd3_row(Rs)
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # the forced overflow: half the probed need installed for the first segment
    heal_cfg = dataclasses.replace(trainer_config(), optim=OptimConfig(
        iterations=HEAL_ITERS, densify_from_iter=100, densify_until_iter=0))
    overflows = {}
    tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], heal_cfg, lp,
                 crop_hw=(CROP, CROP), device=dev,
                 log_fn=lambda it, logs: overflows.__setitem__(it, logs["raster_overflow"]))
    tr.segment_sync_mode = "error"
    need = int(tr._probe_pair_need(tr._probe_frames(), tr._max_tiles)[0])
    half = need // 2
    tr._install_budgets(half, tr._max_tiles)
    tr.train(eval_iters=HEAL_EVALS)
    first = HEAL_EVALS[0] - 1  # the eval at 4's pre-step boundary ends the first segment
    heal = {"need": need, "installed": half, "healed_to": tr.budgets, "heal_events":
            tr._heal_events, "overflow_by_iteration": overflows}
    if not (all(overflows[i] > 0 for i in range(1, first + 1)) and tr._heal_events >= 1
            and tr.budgets["npb"] > half
            and all(overflows[i] == 0 for i in range(first + 1, HEAL_ITERS + 1))):
        raise AssertionError(f"the forced overflow did not heal: {heal}")
    del tr
    for engine, r in runs.items():
        p = r["profile"]
        print(f"engines {engine} ({smi}): {r['ms_per_iteration']:.2f} ms per iteration outside "
              f"rounds ({r['ms_per_iteration_without_captures']:.2f} without captures), "
              f"{p['steady_ms_per_step']:.2f} ms a step in a {PROFILE_STEPS}-step call; a step "
              f"{p['launch_calls_per_step']:.0f} kernel launches, "
              f"{p['graph_launches_per_step']:.0f} graph launches, {p['device_ops_per_step']:.0f}"
              f" device ops, {p['syncs_per_step']:.2f} syncs, idle share {p['idle_share']:.3f}; "
              f"{r['captures']} captures at {[round(x, 1) for x in r['capture_ms']]} ms, graph "
              f"pool {r['pool_mb']:.1f} MB; budgets {r['budgets']}; device ms a step by kernel "
              f"{[(k, round(v, 3)) for k, v in p['top_device_ms_per_step'][:8]]}", flush=True)
    print(f"engines heal ({smi}): need {need}, installed {half}, overflow "
          f"{[overflows[i] for i in range(1, HEAL_ITERS + 1)]}, healed to {heal['healed_to']}",
          flush=True)
    print(f"engines scan graph ({smi}): {graph['captures']} captures (the wrappers counted "
          f"their warm-up steps: {launches['scan']}), {graph['replays']} replays of "
          f"{graph['captured_launches']} recorded calls; the profiled replays' trace a step "
          f"{graph['traced_per_replay']}", flush=True)
    print(f"engines capacity rows ({smi}): NPb {rows['npb']} for {rows['pairs']} live pairs; "
          + ", ".join(f"{k} {rows[k]['ms_capacity']:.4f} ms at capacity, "
                      f"{rows[k]['ms_live']:.4f} live" for k in ("rasterize_fwd", "rasterize_bwd",
                                                                 "segment_sum"))
          + f"; svd3 {svd_row['ms']:.4f} ms, torch.linalg.svd {svd_row['library_ms']:.4f} ms",
          flush=True)
    emit({"phase": "engines", "nvidia_smi": smi, "hw": HW, "crop": CROP,
          "capacity": MODEL.capacity, "schedule": TRAINER, "checks": ENGINE_CHECKS,
          "bitwise_vs_eager": {e: True for e in ENGINES[1:]},
          "sync_debug_mode": {"queued": "error", "scan": "error"},
          "runs": runs, "launches": launches, "scan_graph": graph, "heal": heal,
          "capacity_rows": rows, "svd3": svd_row})
    return launches, graph, rows, svd_row


def flat_equal(a, b):
    """Names of the checkpoint leaves (train/checkpoint.flatten) that differ."""
    return sorted(k for k in set(a) | set(b) if k not in a or k not in b
                  or a[k].dtype != b[k].dtype or not np.array_equal(a[k], b[k]))


def clocked_ms(fn):
    """(fn's result, host-clock ms of the call, ended by a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def serving_images(tr, frame, cache=None, raster=None):
    """The test frame through the full path (MLPs + deform) or, with the
    transforms of an earlier full-path render, the cached path; on the
    per-frame pair list, or binned by `raster` (the trainer's _eval_raster:
    the installed budgets, as render_zju serves)."""
    ts = tr.ts
    kw = {} if cache is None else {"cached_transforms": cache["transforms"],
                                   "cached_translation": cache["translation"]}
    with torch.no_grad():
        out = render_frame(ts.params["gauss"], ts.gstate.valid, ts.params["mlps"], tr.scene,
                           frame.smpl_params, frame.camera, tr.bg, MODEL.sh_degree,
                           rasterize_fn=raster, device=tr.device, **kw)
    return out, {"color": out["render"], "alpha": out["render_alpha"],
                 "depth": out["render_depth"], "final_T": out["final_T"]}


def phase_checkpoint(dev, trained, train_ts, ckpt_dir=CKPT_DIR, smi=""):
    """Save, resume, reload and serve a trained avatar, at full width.

    Resume: a fresh Trainer resume_latest's the trainer phase's
    chkpnt{RESUME_AT}.npz and trains to the end; its final state (params,
    valid, moments, MLPs, statistics) is bitwise the trainer phase's
    uninterrupted run's, and so are its evals (the one at RESUME_AT + 1 fires
    again at the resume point). Serve: the final state saved both ways
    (chkpnt npz, reference layout), each loaded into a fresh Trainer and
    compacted; the test frame on the full and the cached path held to the same
    frame rendered from the in-memory state at full capacity (the image rule;
    compaction reorders slots, so pairs of equal depth may swap), live counts
    equal. The kernels' launches are counted over these two. Then the train
    phase's state (45,695 live in 46,080) through save_checkpoint and
    restore_checkpoint, bitwise; and the host-clock ms of save, load and
    compact_for_eval, the files' MB, and the serving frame's ms on the trained
    cloud inside the 46,080 buffer and after compaction (host clock, the
    median of 2 FRAME_TURNS turns each, and the device-busy ms of a profiled
    frame); the compacted avatar served through its budgets
    (served_through_budgets), whose launches join the phase's."""
    tr, scene, frames, lp = trained
    test = frames[TRAIN_FRAMES]

    def fresh():
        return Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], trainer_config(), lp,
                       crop_hw=(CROP, CROP), device=dev)

    # the baseline: the in-memory final state at full capacity, kernel renders
    _, ref = serving_images(tr, test)
    final = tr.ts
    live = int(final.gstate.valid.sum())
    npz = os.path.join(ckpt_dir, "final.npz")  # not chkpnt*: no resume candidate
    layout_dir = os.path.join(ckpt_dir, "layout")
    _, save_ms = clocked_ms(lambda: ckpt.save_checkpoint(npz, final))
    _, layout_save_ms = clocked_ms(
        lambda: ckpt.save_reference_layout(layout_dir, TRAINER["iterations"], final))

    # the path, driven once: resume and train to the end, then serve both layouts
    zero_launch_counts()
    again = fresh()
    start = again.resume_latest(ckpt_dir)
    again.train()
    resumed = launch_counts()
    served, errs, times = {}, {}, {}
    for name in ("npz", "reference_layout"):
        srv = fresh()
        if name == "npz":
            _, times["load_ms"] = clocked_ms(lambda: srv.load(npz))
        else:
            _, times["layout_load_ms"] = clocked_ms(lambda: srv.set_state(
                ckpt.load_reference_layout(layout_dir, TRAINER["iterations"], srv.ts)))
        cap, ms = clocked_ms(srv.compact_for_eval)
        times.setdefault("compact_ms", ms)
        full, full_img = serving_images(srv, test)
        _, cached_img = serving_images(srv, test, full)
        served[name] = srv
        errs[name] = {"capacity": cap, "live": int(srv.ts.gstate.valid.sum()),
                      "max_abs_err_full": check_images(full_img, ref, f"{name} full path"),
                      "max_abs_err_cached": check_images(cached_img, ref, f"{name} cached path")}
    launches = launch_counts()

    steps = TRAINER["iterations"] - RESUME_AT
    evals = [i for i in TRAINER_EVALS if i > RESUME_AT]
    want_resume = {"rasterize_fwd": steps + len(evals), "rasterize_bwd": steps,
                   "segment_sum": steps}
    want = {**want_resume, "rasterize_fwd": want_resume["rasterize_fwd"] + 2 * len(served)}
    if start != RESUME_AT or blend(resumed) != want_resume or blend(launches) != want:
        raise AssertionError(f"resumed at {start}, launches {resumed} then {launches}, not "
                             f"{RESUME_AT}, {want_resume}, {want}")
    differ = flat_equal(ckpt.flatten(again.ts), ckpt.flatten(final))
    hist = [{k: v for k, v in m.items() if k != "elapsed_s"} for m in again.metrics_history]
    ref_hist = [{k: v for k, v in m.items() if k != "elapsed_s"} for m in tr.metrics_history
                if m["iteration"] in evals]
    if differ or hist != ref_hist:
        raise AssertionError(f"the resumed run differs from the uninterrupted one: {differ[:8]}, "
                             f"evals {hist} against {ref_hist}")
    if any(e["live"] != live for e in errs.values()):
        raise AssertionError(f"live counts after loading: {errs}, in memory {live}")

    # the train phase's full-width state through the npz, bitwise
    wide = os.path.join(ckpt_dir, "wide.npz")
    _, wide_save_ms = clocked_ms(lambda: ckpt.save_checkpoint(wide, train_ts))
    back, wide_load_ms = clocked_ms(lambda: ckpt.restore_checkpoint(wide, dev))
    wide_differ = flat_equal(ckpt.flatten(back), ckpt.flatten(train_ts))
    if wide_differ:
        raise AssertionError(f"the full-width round trip differs: {wide_differ[:8]}")

    # the serving frame on the trained cloud, in the 46,080 buffer and
    # compacted: host clock in FRAME_TURNS rounds of turns (buffer, compacted,
    # compacted, buffer), and the device-busy ms of a profiled frame
    srv = served["npz"]
    caches = {"in_buffer": (tr, serving_images(tr, test)[0]),
              "compacted": (srv, serving_images(srv, test)[0])}
    frame_ms, device_ms = {}, {}
    for path in ("full_path", "cached_path"):
        for where in ("in_buffer", "compacted", "compacted", "in_buffer") * FRAME_TURNS:
            t, cache = caches[where]
            fn = functools.partial(serving_images, t, test,
                                   cache if path == "cached_path" else None)
            key = f"{path}_{where}"
            frame_ms.setdefault(key, []).append(host_ms(fn))
            if key not in device_ms:
                device_ms[key] = device_breakdown(fn)["device_busy_ms"]
    budgeted = served_through_budgets(srv, test, "checkpoint", smi)
    launches = {k: v + budgeted["launches"][k] for k, v in launches.items()}
    mb = {"trained": os.path.getsize(npz) / 1e6, "train_phase_state": os.path.getsize(wide) / 1e6,
          "reference_layout": sum(os.path.getsize(os.path.join(d, f))
                                  for d, _, fs in os.walk(layout_dir) for f in fs) / 1e6}
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"checkpoint ({smi}): save {save_ms:.1f} ms, load {times['load_ms']:.1f} ms, "
          f"compact {times['compact_ms']:.1f} ms, {mb['trained']:.1f} MB for {live} live in "
          f"{MODEL.capacity}; frame ms, median of {2 * FRAME_TURNS} turns: "
          f"{ {k: float(np.median(v)) for k, v in frame_ms.items()} }, device busy ms {device_ms}",
          flush=True)
    emit({"phase": "checkpoint", "nvidia_smi": smi, "hw": HW, "capacity": MODEL.capacity,
          "live": live, "resumed_at": start, "resume_bitwise": True, "resumed_evals": hist,
          "served": errs, "compacted_capacity": errs["npz"]["capacity"],
          "save_ms": save_ms, "layout_save_ms": layout_save_ms, **times,
          "train_phase_state": {"live": int(train_ts.gstate.valid.sum()),
                                "capacity": train_ts.params["gauss"].capacity,
                                "save_ms": wide_save_ms, "load_ms": wide_load_ms,
                                "bitwise": True},
          "file_mb": mb, "frame_ms": {k: float(np.median(v)) for k, v in frame_ms.items()},
          "frame_ms_turns": frame_ms, "frame_device_busy_ms": device_ms,
          "served_through_budgets": budgeted, "launches_resume": resumed,
          "launches": launches})
    return launches


def binning_times(fns, turns=SERVE_TURNS):
    """{binning: host ms (the median over turns of host_ms, the binnings taken
    in turns: a, b, b, a), device-busy ms, kernel launches, host syncs and
    idle share of a profiled call} of each call in fns."""
    ms = {b: [] for b in fns}
    order = list(fns) + list(fns)[::-1]
    for _ in range(turns):
        for b in order:
            ms[b].append(host_ms(fns[b]))
    out = {}
    for b, fn in fns.items():
        prof = device_breakdown(fn)
        out[b] = {"host_ms": float(np.median(ms[b])), "host_ms_turns": ms[b],
                  "device_busy_ms": prof["device_busy_ms"],
                  "kernel_launches": prof["kernel_launches"], "host_syncs": prof["host_syncs"],
                  "idle_share": prof["idle_share"]}
    return out


def same_images(a, b):
    return all(torch.equal(a[k], b[k]) for k in ("color", "alpha", "depth", "final_T"))


def served_through_budgets(srv, frame, what, smi):
    """render_zju's serving of `frame` by a loaded, compacted Trainer: the
    full and the cached path through its installed budgets (_eval_raster)
    against the per-frame pair list, bitwise equal with overflow 0; each
    path's binning_times for both binnings."""
    raster = srv._eval_raster
    full, _ = serving_images(srv, frame)
    cache = {"transforms": full["transforms"], "translation": full["translation"]}
    paths = (("full_path", None), ("cached_path", cache))
    budgeted, n = counted(lambda: {path: serving_images(srv, frame, c, raster)
                                   for path, c in paths})
    if raster is None or n["rasterize_fwd"] != len(paths):
        raise AssertionError(f"{what}: the budgeted frames launched {n} (raster {raster})")
    out = {"budgets": srv.budgets, "launches": n}
    for path, c in paths:
        plain = serving_images(srv, frame, c)
        if not same_images(budgeted[path][1], plain[1]) or \
                int(budgeted[path][0]["overflow"]) != 0:
            raise AssertionError(f"{what} {path}: the frame through the budgets is not the "
                                 f"per-frame list's (overflow "
                                 f"{int(budgeted[path][0]['overflow'])})")
        fns = {b: functools.partial(serving_images, srv, frame, c, r)
               for b, r in (("per_frame_list", None), ("budgets", raster))}
        out.update({f"{path}_{b}": v for b, v in binning_times(fns).items()})
    print(f"{what} served through the budgets ({smi}): bitwise the per-frame list's, overflow 0; "
          f"budgets {out['budgets']['eval']}; "
          + "; ".join(f"{k}: {v['host_ms']:.2f} host ms, {v['device_busy_ms']:.2f} busy ms, "
                      f"{v['host_syncs']} syncs" for k, v in out.items()
                      if k not in ("budgets", "launches"))
          + " (a profiled frame's syncs count the synchronize that ends it)", flush=True)
    return out


# ---- the SMPL-X and static scene families ------------------------------------------


def smplx_frames(scene, dev, H=SMPLX_HW[0], W=SMPLX_HW[1], n_frames=TRAIN_FRAMES + 1, seed=0):
    """Ground truth for the SMPL-X phase, as make_frames makes SMPL's (which
    is SMPL-only: 72-dim poses): a target cloud on the big-pose vertices
    (random colours, opacity TARGET_OPACITY) posed at random 165-dim full
    poses by the deform (no MLPs) and rendered by the forward kernel, one
    orbit camera a frame; each frame's bound mask from its posed vertices
    (+- 5 cm, the DNA reader's, data/dna.py) and its crop window centred on
    the bound rect. Returns (frames, crop (h, w), (target, valid)): the crop
    autosize_crop's rule takes for these rects, the target cloud."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(seed)
    model = scene.smpl
    verts = scene.big_pose_vertices.cpu().numpy()
    target, valid = G.create_from_points(verts, rng.uniform(0.2, 0.9, (verts.shape[0], 3)),
                                         verts.shape[0], device=dev)
    target.opacity = torch.full_like(target.opacity, math.log(TARGET_OPACITY / (1 - TARGET_OPACITY)))
    shots = []
    for i in range(n_frames):
        poses = np.zeros(165, np.float32)
        poses[3:] = rng.normal(0, 0.25, 162)
        sp = {"poses": torch.as_tensor(poses, device=dev)[None],
              "shapes": torch.zeros((1, 20), device=dev), "R": torch.eye(3, device=dev),
              "Th": torch.zeros((1, 3), device=dev)}
        K, R, T = orbit_krt(H, W, 2.5, 2 * np.pi * i / n_frames)
        cam = Camera.from_KRT(K, R.T, T, H, W, device=dev)
        with torch.no_grad():
            out = render_frame(target, valid, None, scene, sp, cam, torch.zeros(3, device=dev), 0,
                               motion_offset=False, device=dev)
        v, _ = S.lbs_vertices(model, sp["poses"][0], sp["shapes"][0])
        v = v.cpu().numpy()
        bound = np.stack([v.min(0) - 0.05, v.max(0) + 0.05])
        bound_mask = readers.get_bound_2d_mask(bound, K, np.concatenate([R, T[:, None]], 1), H, W)
        ys, xs = np.nonzero(bound_mask)
        rots = Rotation.from_rotvec(poses.reshape(-1, 3)[1:] + 1e-8).as_matrix()
        shots.append((cam, out, bound_mask, (ys.min(), ys.max(), xs.min(), xs.max()), sp, rots))
    crop = readers.crop_for_rects([(y1 - y0 + 1, x1 - x0 + 1) for _, _, _, (y0, y1, x0, x1), _, _
                                   in shots], (H, W))
    frames = []
    for i, (cam, out, bound_mask, (y0, y1, x0, x1), sp, rots) in enumerate(shots):
        frames.append(Frame(
            camera=cam, image=out["render"], bkgd_mask=out["render_alpha"],
            bound_mask=torch.as_tensor(bound_mask.astype(np.float32), device=dev), **sp,
            pose_rotmats=torch.as_tensor(rots.astype(np.float32), device=dev),
            crop_y0=int(np.clip((y0 + y1) // 2 - crop[0] // 2, 0, H - crop[0])),
            crop_x0=int(np.clip((x0 + x1) // 2 - crop[1] // 2, 0, W - crop[1])), pose_id=i))
    return frames, crop, (target, valid)


def blender_scene(root, n_train=TRAIN_FRAMES, n_test=1, seed=0):
    """A NeRF-synthetic scene's transforms_{train,test}.json (no images):
    cameras on a sphere of radius STATIC_RADIUS at random azimuths and
    elevations in [10, 60] degrees, looking at the origin, OpenGL axes, z up,
    camera_angle_x STATIC_FOVX."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for split, n in (("train", n_train), ("test", n_test)):
        frames = []
        for i in range(n):
            az, el = rng.uniform(0, 2 * np.pi), np.deg2rad(rng.uniform(10, 60))
            back = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
            right = np.cross([0.0, 0.0, 1.0], back)
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, :3] = np.stack([right, np.cross(back, right), back], axis=1)
            c2w[:3, 3] = STATIC_RADIUS * back
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": STATIC_FOVX, "frames": frames}, f)


def static_frames(scene, specs, dev, seed=1):
    """Ground truth for the static phase, put into Frames directly (nothing
    is decoded): a target cloud on the seeds (other colours, opacity
    TARGET_OPACITY) rendered by the forward kernel for each Blender spec's
    camera (K from camera_angle_x, as colmap.frame_from_spec builds it), all-
    ones masks, zero SMPL fields and the crop at (0, 0), as frame_from_spec
    gives them."""
    rng = np.random.default_rng(seed)
    seeds = scene.big_pose_vertices
    target, valid = G.create_from_points(seeds.cpu().numpy(),
                                         rng.uniform(0.1, 0.9, (seeds.shape[0], 3)),
                                         seeds.shape[0], device=dev)
    target.opacity = torch.full_like(target.opacity, math.log(TARGET_OPACITY / (1 - TARGET_OPACITY)))
    H = W = STATIC_HW
    frames = []
    for spec in specs:
        f = 0.5 * W / np.tan(0.5 * spec["fovx"])
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
        cam = Camera.from_KRT(K, spec["R_w2c"].T, spec["T_w2c"][:, 0], H, W, device=dev)
        with torch.no_grad():
            out = render_frame(target, valid, None, scene, None, cam, torch.zeros(3, device=dev),
                               0, motion_offset=False, static_scene=True, device=dev)
        ones = torch.ones((H, W), device=dev)
        frames.append(Frame(
            camera=cam, image=out["render"], bkgd_mask=ones, bound_mask=ones,
            poses=torch.zeros((1, 72), device=dev), shapes=torch.zeros((1, 10), device=dev),
            R=torch.eye(3, device=dev), Th=torch.zeros((1, 3), device=dev),
            pose_rotmats=torch.zeros((23, 3, 3), device=dev), crop_y0=0, crop_x0=0,
            pose_id=len(frames)))
    return frames


def measure_rows(proj, bg, height, width, seed=0):
    """Rows 1, 2 and 2b on a full-size input, where the plain blend takes
    seconds: the plain blend run once, forward (remat: the same values as
    without) and backward each clocked; the forward kernel against its
    images, the backward kernel + segment sum against its grads, the segment
    sum against its plain version and index_add_, each kernel bitwise
    repeatable; the kernels' times split and unsplit, bounds (kernel_bound,
    bwd_bound, segment_bound), segments and the longest tile. Returns (the
    rows, the plain blend's images)."""
    gen = torch.Generator(device=bg.device).manual_seed(seed)
    up = {k: torch.randn(s, generator=gen, device=bg.device)
          for k, s in (("color", (height, width, 3)), ("depth", (height, width)),
                       ("alpha", (height, width)), ("final_T", (height, width)))}
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE, remat=True)
    g_ref, ref, plain_ms, plain_bwd_ms = timed_blend_grads(proj, bg, height, width, up, plain)
    pairs = rc.bin_projected(proj, height, width)
    img, state = rc.rasterize_pairs(pairs, proj, height, width)
    if not torch.equal(img, rc.rasterize_pairs(pairs, proj, height, width)[0]):
        raise AssertionError("two forward passes on the same input differ")
    err_fwd = check_images(as_images(img, bg), ref, "kernel vs plain")
    g, _ = blend_grads(proj, bg, height, width, up, rc.rasterize_cuda)
    again, _ = blend_grads(proj, bg, height, width, up, rc.rasterize_cuda)
    if not all(torch.equal(a, b) for a, b in zip(g, again)):
        raise AssertionError("two backward passes on the same input differ")
    errs = {f: scaled_err(a, b) for f, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1])}
    bg_rel = float(((g[-1] - g_ref[-1]).abs() / g_ref[-1].abs()).max())
    if max(errs.values()) > GRAD_ATOL or bg_rel > BG_RTOL or \
            not all(torch.isfinite(x).all() for x in g):
        raise AssertionError(f"backward kernel vs plain: scaled errors {errs}, bg rel {bg_rel:.2e}")
    gimg = torch.stack([up["color"][..., 0], up["color"][..., 1], up["color"][..., 2],
                        up["depth"], up["alpha"], up["final_T"] + (up["color"] * bg).sum(-1)])
    gimg = torch.cat([gimg[:5], (gimg * img).sum(0, keepdim=True)]).contiguous()
    rows = rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width, state)
    seg = rc.segment_sum(rows, pairs)
    if not torch.equal(seg, rc.segment_sum(rows, pairs)):
        raise AssertionError("two segment sums of the same rows differ")
    P = proj.mean2d.shape[0]
    index = pairs.pair_gaussian.long()

    def library():
        return torch.zeros((P, rc.GRAD_COLS), device=rows.device).index_add_(0, index, rows)

    seg_plain = rc.segment_sum_plain(rows, pairs)
    seg_errs = {"plain": scaled_err(seg, seg_plain), "index_add_": scaled_err(seg, library())}
    if max(seg_errs.values()) > SEGMENT_RTOL:
        raise AssertionError(f"segment sum vs plain and index_add_: scaled errors {seg_errs}")
    whole = unsplit_len(pairs)
    _, whole_state = rc.rasterize_pairs(pairs, proj, height, width, whole)
    work = blend_work(proj, pairs, height, width)
    return {
        "pairs": pairs.num_pairs, "max_tile_pairs": int(pairs.tile_count.max()),
        "busy_tiles": int((pairs.tile_count > 0).sum()), **segments(pairs),
        "rasterize_fwd": {
            "max_abs_err": err_fwd, "bitwise_repeat": True,
            "ms": cuda_ms(lambda: rc.rasterize_pairs(pairs, proj, height, width),
                          site="rasterize_fwd"),
            "ms_unsplit": cuda_ms(lambda: rc.rasterize_pairs(pairs, proj, height, width, whole),
                                  site="rasterize_fwd unsplit"),
            "plain_ms": plain_ms, **kernel_bound(proj, pairs, height, width, work)},
        "rasterize_bwd": {
            "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(g[:-1], g_ref[:-1])),
            "scaled_err": errs, "bg_rel_err": bg_rel, "bitwise_repeat": True,
            "ms": cuda_ms(lambda: rc.rasterize_pairs_bwd(pairs, proj, gimg, height, width, state),
                          site="rasterize_bwd"),
            "ms_unsplit": cuda_ms(lambda: rc.rasterize_pairs_bwd(
                pairs, proj, gimg, height, width, whole_state, whole),
                site="rasterize_bwd unsplit"),
            "plain_ms": plain_bwd_ms, "plain_fwd_bwd_ms": plain_ms + plain_bwd_ms,
            **bwd_bound(proj, pairs, height, width, work=work)},
        "segment_sum": {
            "max_abs_err": float((seg - seg_plain).abs().max()), "scaled_err": seg_errs,
            "bitwise_repeat": True,
            "ms": cuda_ms(lambda: rc.segment_sum(rows, pairs), site="segment_sum"),
            "library_ms": cuda_ms(library, site="segment_sum index_add_"),
            "plain_ms": cuda_ms(lambda: rc.segment_sum_plain(rows, pairs),
                                site="segment_sum plain"),
            "lengths": segment_lengths(pairs), **segment_bound(pairs, P)},
    }, ref


def slice_trainer_config(model, **optim):
    return Config(model=model, optim=OptimConfig(**SLICE_TRAINER, **optim),
                  pipe=PipelineConfig(test_iterations=SLICE_EVALS, save_iterations=()))


def counted(fn):
    """fn's result and the training path's kernels' launches in its run
    (launch_counts, the counts set to 0 just before)."""
    zero_launch_counts()
    out = fn()
    return out, launch_counts()


def phase_scene_family(name, dev, scene, frames, cfg, lp, crop, extent, smi, steps=5, warmup=2,
                       tb=None, trace_dir=None):
    """A scene family's main path at full width: the Trainer over
    SLICE_TRAINER (two rounds, one opacity reset, evals at the config's
    test_iterations) under queued, then under scan (a CUDA graph of the step,
    captured at the start and after each state change, replayed), bitwise
    the queued run, every segment of both under the sync debug mode "error";
    the scan run's captures (ms, pool, reserved and allocated MB after each,
    capture_memory_gate) and a profiled 10-step scan call whose replays'
    trace must name each blend kernel every step; ms an iteration outside
    rounds and evals under each; training steps timed and one profiled; the
    trained avatar's test frame served on the full path, the kernel against
    the plain blend; rows 1, 2 and 2b on that frame's projected input. A body
    without pose MLPs has zero Fisher fields, which must come out zero. tb:
    the first run's TBWriter. trace_dir: five more steps under
    observability.profile_trace there, whose trace must name both blend
    kernels. Returns ({path: launches}, the rows, the scan run's graph
    counts)."""
    H, W = frames[0].camera.height, frames[0].camera.width
    model = cfg.model
    evals = tuple(cfg.pipe.test_iterations)

    def run(engine):
        """One Trainer run under `engine` with every segment under the sync
        debug mode "error": (trainer, rounds, host-work ms by part, the
        run's wall ms, each capture's capture_line). The first (queued) run
        gets tb."""
        tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], cfg, lp, crop_hw=crop,
                     extent=extent, tb=tb if engine == "queued" else None, device=dev)
        tr.segment_sync_mode = "error"
        rounds, host, caps = [], {"densify": [], "eval": [], "budgets": []}, []

        def clocked(fn, key):
            def go(*a, **kw):
                out, ms = clocked_ms(lambda: fn(*a, **kw))
                host[key].append(ms)
                return out
            return go

        densify = clocked(tr.densify, "densify")

        def counted_densify(it):
            stats = densify(it)
            live = int(tr.ts.gstate.valid.sum())
            rounds.append({"round": it, "live": live,
                           **{k: int(v) for k, v in stats.items() if k != "masks"}})
            if live > model.capacity or int(stats["count_after"]) != live:
                raise AssertionError(f"{name} round {it}: {live} live in {model.capacity}")
            return stats

        tr.densify = counted_densify
        tr.evaluate = clocked(tr.evaluate, "eval")
        tr._resize_pair_buffer = clocked(tr._resize_pair_buffer, "budgets")
        with captures_recorded(caps):
            _, wall = clocked_ms(lambda: tr.train(dispatch_engine=engine))
        return tr, rounds, host, wall, caps

    def ms_per_iteration(host, wall, captures_ms=0.0):
        return (wall - sum(sum(v) for v in host.values()) - captures_ms) / iters

    # the Fisher fields of a body's rounds: at J=55 with no pose MLPs, SVDs
    # (densify.fisher_fields' torch.linalg.svd, cuSOLVER; the step's Fisher
    # loss runs its SVDs on csrc/svd3.cu) of 23 zero matrices weighted by zero
    # LBS sums, which must come out zero and finite
    fields, fisher = [], D.fisher_fields
    D.fisher_fields = lambda gs: fields.append(fisher(gs)) or fields[-1]
    try:
        (tr, rounds, times, wall, _), trainer_launches = counted(lambda: run("queued"))
    finally:
        D.fisher_fields = fisher
    fisher_max = [max(float(x.abs().max()) for x in f) for f in fields]
    if not all(bool(torch.isfinite(x).all()) for f in fields for x in f) or \
            (any(fisher_max) and not model.motion_offset) or \
            len(fields) != (0 if model.static_scene else 2):
        raise AssertionError(f"{name}: the rounds' Fisher fields: max |.| {fisher_max}")
    iters = SLICE_TRAINER["iterations"]
    eval_frames = len(evals) * (len(frames) - TRAIN_FRAMES)
    want = {"rasterize_fwd": iters + eval_frames, "rasterize_bwd": iters, "segment_sum": iters}
    if blend(trainer_launches) != want:
        raise AssertionError(f"{name}: the trainer launched {trainer_launches}, not {want}")
    hist = tr.metrics_history
    psnr = {m["iteration"]: m["psnr"] for m in hist}
    if [m["iteration"] for m in hist] != list(evals) or \
            not all(math.isfinite(v) for m in hist for v in (m["psnr"], m["ssim"], m["lpips"])) \
            or not psnr[20] > psnr[1]:
        raise AssertionError(f"{name}: the trainer's evals {hist}")
    if [r["round"] for r in rounds] != [20, 30] or sum(r["cloned"] + r["split"]
                                                       for r in rounds) == 0:
        raise AssertionError(f"{name}: the rounds {rounds}")
    queued = {"ms_per_iteration": ms_per_iteration(times, wall), "wall_ms": wall,
              "host_work_ms": {k: sum(v) for k, v in times.items()}}
    # the second run under scan, bitwise the first
    (again, scan_rounds, scan_host, scan_wall, caps), scan_launches = counted(lambda: run("scan"))
    many = again._many
    scan = {"ms_per_iteration": ms_per_iteration(scan_host, scan_wall),
            "ms_per_iteration_without_captures": ms_per_iteration(scan_host, scan_wall,
                                                                  sum(many.capture_ms)),
            "wall_ms": scan_wall, "host_work_ms": {k: sum(v) for k, v in scan_host.items()},
            "launches": scan_launches, "captures": many.captures, "replays": many.replays,
            "captured_launches": dict(many.captured_launches),
            "replays_x_captured": {k: many.replays * n for k, n in many.captured_launches.items()},
            "capture_lines": caps, "memory": capture_memory_gate(caps, name),
            "rounds": scan_rounds}
    scan_want = {"rasterize_fwd": many.captures + eval_frames,
                 "rasterize_bwd": many.captures, "segment_sum": many.captures}
    if many.captures + many.replays != iters or blend(scan_launches) != scan_want or \
            any(many.captured_launches[k] < 1 for k in BLEND_KERNELS) or scan_rounds != rounds:
        raise AssertionError(f"{name} under scan: {many.captures} captures, {many.replays} "
                             f"replays, the wrappers launched {scan_launches} (want "
                             f"{scan_want}), captured {many.captured_launches}; rounds "
                             f"{scan_rounds}, queued's {rounds}")
    a, b = tr.ts, again.ts
    same = {"valid": torch.equal(a.gstate.valid, b.gstate.valid),
            **{f: torch.equal(getattr(a.params["gauss"], f), getattr(b.params["gauss"], f))
               for f in G.FIELDS},
            **{f"{g}.{m}.{n}": torch.equal(getattr(a.opt_state[g], m)[n],
                                          getattr(b.opt_state[g], m)[n])
               for g in a.opt_state for m in ("mu", "nu") for n in a.opt_state[g].mu},
            **{f"{g}.count": a.opt_state[g].count == b.opt_state[g].count for g in a.opt_state},
            **{f"gstate.{f}": torch.equal(getattr(a.gstate, f), getattr(b.gstate, f))
               for f in STAT_FIELDS},
            "metrics_history": [{k: v for k, v in m.items() if k != "elapsed_s"} for m in hist]
            == [{k: v for k, v in m.items() if k != "elapsed_s"} for m in again.metrics_history]}
    if not all(same.values()):
        raise AssertionError(f"{name}: the scan run differs from the queued run: "
                             f"{[k for k, v in same.items() if not v]}")
    # 10 steps past the run's end as one call of a captured graph, profiled;
    # the replays' trace must name each blend kernel every step
    prof = engine_profile(again, "scan")
    traced = prof["kernels_traced_per_step"]
    scan["profile"] = {k: prof[k] for k in (
        "steady_ms_per_step", "device_busy_ms", "idle_share", "device_ops_per_step",
        "kernels_traced_per_step", "launch_calls_per_step", "graph_launches_per_step",
        "syncs_per_step", "memcpy_calls_per_step", "captures", "replays")}
    if prof["captures"] != 1 or prof["replays"] != 3 * PROFILE_STEPS - 1 or \
            prof["launch_calls_per_step"] >= 1 or prof["graph_launches_per_step"] != 1 or \
            any(traced[k] < max(n, 1 if k in BLEND_KERNELS else 0) or traced[k] != int(traced[k])
                for k, n in many.captured_launches.items()):
        raise AssertionError(f"{name}: the profiled scan call was not all replays of the "
                             f"captured step: {scan['profile']}, captured "
                             f"{many.captured_launches}")

    # training steps on the second run's final state: host clock, launches,
    # one profiled step
    feats = again._gt_lpips_features()
    holder = [again.ts]

    def one_step(k=0):
        holder[0], logs = again.step_fn(holder[0], frames[k], active_sh_degree(1, model.sh_degree),
                                        None if feats is None else feats[k])
        return logs

    def timed_steps():
        out = []
        for i in range(warmup + steps):
            logs, ms = clocked_ms(lambda i=i: one_step(i % TRAIN_FRAMES))
            out.append(ms)
            if not math.isfinite(float(logs["loss"])):
                raise AssertionError(f"{name}: non-finite loss {logs}")
        return out

    step_ms, step_launches = counted(timed_steps)
    if any(n != warmup + steps for n in blend(step_launches).values()):
        raise AssertionError(f"{name}: {warmup + steps} steps launched {step_launches}")
    profile = device_breakdown(one_step, top=10)
    trace = None
    if trace_dir is not None:
        shutil.rmtree(trace_dir, ignore_errors=True)
        with obs.profile_trace(trace_dir):
            for i in range(5):
                one_step(i % TRAIN_FRAMES)
            torch.cuda.synchronize()
        files = glob.glob(os.path.join(trace_dir, "trace_*.json"))
        text = open(files[0]).read() if len(files) == 1 else ""
        trace = {"file_mb": os.path.getsize(files[0]) / 1e6 if files else 0,
                 **{k: k in text for k in ("rasterize_fwd_kernel", "rasterize_bwd_kernel")}}
        if not all(trace[k] for k in ("rasterize_fwd_kernel", "rasterize_bwd_kernel")):
            raise AssertionError(f"{name}: profile_trace wrote {files}, naming {trace}")
        shutil.rmtree(trace_dir, ignore_errors=True)

    # the trained avatar served: the test frame on the full path
    test = frames[TRAIN_FRAMES]
    seen = []

    def serve(raster=None):
        with torch.no_grad():
            return render_frame(tr.ts.params["gauss"], tr.ts.gstate.valid,
                                tr.ts.params.get("mlps"), scene, test.smpl_params, test.camera,
                                tr.bg, model.sh_degree, rasterize_fn=raster,
                                motion_offset=model.motion_offset,
                                static_scene=model.static_scene, device=dev)

    full, serve_launches = counted(lambda: serve(
        lambda proj, *a: seen.append(proj) or rc.rasterize_cuda(proj, *a)))
    if serve_launches["rasterize_fwd"] != 1:
        raise AssertionError(f"{name}: the served frame launched {serve_launches}")
    proj = seen[0]
    rows, ref = measure_rows(proj, tr.bg, H, W)
    images = {"color": full["render"], "alpha": full["render_alpha"],
              "depth": full["render_depth"], "final_T": full["final_T"]}
    err_served = check_images(images, ref, f"{name} served frame")
    if float(full["render_alpha"].max()) <= 0:
        raise AssertionError(f"{name}: the served frame is empty")
    serve_ms = host_ms(serve, n=5, warmup=1)
    launches = {"trainer": trainer_launches, "trainer_scan": scan_launches,
                "steps": step_launches, "serve": serve_launches}
    row_line = {k: {f: rows[k][f] for f in ("ms", "ms_unsplit", "plain_ms", "bound_ms",
                                            "bound_by") if f in rows[k]}
                for k in ("rasterize_fwd", "rasterize_bwd", "segment_sum")}
    print(f"{name} ({smi}): {W}x{H}, crop {crop}, {model.capacity} capacity; trainer "
          f"{queued['ms_per_iteration']:.2f} ms per iteration outside rounds and evals under "
          f"queued, rounds {[round(t, 1) for t in times['densify']]} ms, eval frames "
          f"{[round(t, 1) for t in times['eval']]} ms, live after the rounds "
          f"{[r['live'] for r in rounds]}, psnr {psnr}; step {float(np.median(step_ms[warmup:])):.2f}"
          f" ms, device busy {profile['device_busy_ms']:.2f} ms, idle "
          f"{profile['idle_share']:.3f}, {profile['kernel_launches']} launches, "
          f"{profile['host_syncs']} syncs; served frame {serve_ms:.2f} ms; pairs {rows['pairs']}, "
          f"longest tile {rows['max_tile_pairs']}, segments {rows['segments']}; rows {row_line}",
          flush=True)
    p, mem = scan["profile"], scan["memory"]
    print(f"{name} scan ({smi}): bitwise queued's; {scan['ms_per_iteration']:.2f} ms per "
          f"iteration outside rounds and evals ({scan['ms_per_iteration_without_captures']:.2f}"
          f" without captures; queued {queued['ms_per_iteration']:.2f}); {scan['captures']} "
          f"captures at {[round(c['ms'], 1) for c in scan['capture_lines']]} ms, pools "
          f"{[round(c['pool_mb'], 1) for c in scan['capture_lines']]} MB, reserved after each "
          f"{[round(c['reserved_mb']) for c in scan['capture_lines']]} MB, allocated "
          f"{[round(c['allocated_mb'], 1) for c in scan['capture_lines']]} MB (bound "
          f"{mem['reserved_bound_mb']:.0f}, growth {mem['allocated_growth_mb']:.1f}); "
          f"{scan['replays']} replays of {scan['captured_launches']}; a {PROFILE_STEPS}-step "
          f"call {p['steady_ms_per_step']:.2f} ms a step, idle {p['idle_share']:.3f}, "
          f"{p['launch_calls_per_step']:.2f} launch calls, {p['graph_launches_per_step']:.0f} "
          f"graph launches, {p['syncs_per_step']:.2f} syncs a step, traced "
          f"{p['kernels_traced_per_step']}", flush=True)
    emit({"phase": name, "nvidia_smi": smi, "hw": [H, W], "crop": list(crop),
          "capacity": model.capacity, "initial_points": model.n_init_points,
          "sh_degree": model.sh_degree, "extent": extent, "schedule": SLICE_TRAINER,
          "evals": evals, "ms_per_iteration": queued["ms_per_iteration"], "queued": queued,
          "scan": scan, "ms_per_densify_round": times["densify"],
          "eval_ms": times["eval"], "live_after_rounds": [r["live"] for r in rounds],
          "rounds": rounds, "fisher_fields_max_abs": fisher_max, "metrics_history": hist,
          "scan_bitwise_queued": True, "sync_debug_mode": "error",
          "ms_per_step": float(np.median(step_ms[warmup:])), "step_ms": step_ms,
          "profile_step": profile, "profile_trace": trace, "served_ms_per_frame": serve_ms,
          "max_abs_err_served": err_served, "launches": launches,
          "kernel_rows": rows, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    graph = {**{k: scan[k] for k in ("captures", "replays", "captured_launches",
                                     "replays_x_captured")},
             "traced_per_profiled_replay": traced}
    return {k: sum(p[k] for p in launches.values()) for k in trainer_launches}, rows, graph


def phase_smplx(dev, smi, n_verts=SMPLX_VERTS, hw=SMPLX_HW):
    """The SMPL-X family at full width (module docstring, phase 10)."""
    model = S.synthetic_smplx(n_verts=n_verts, n_shapes=20, device=dev)
    big = S.big_pose_params_smplx(device=dev)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    scene = SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=v_big)
    frames, crop, target = smplx_frames(scene, dev, *hw)
    cfg = slice_trainer_config(ModelConfig(smpl_type="smplx", motion_offset=False,
                                           n_init_points=n_verts))
    print(f"smplx: crop {crop} (autosize_crop's rule on the frames' bound rects)", flush=True)
    out = phase_scene_family("smplx", dev, scene, frames, cfg, lpips.init_random(3407, device=dev),
                             crop, 1.0, smi)
    return out, (scene, frames, target)


def phase_static(dev, smi, root=STATIC_DIR, n_seeds=STATIC_SEEDS, capacity=STATIC_CAPACITY):
    """The static family at full width (module docstring, phase 11)."""
    shutil.rmtree(root, ignore_errors=True)
    blender_scene(root)
    specs = colmap.read_blender_scene(root, "train") + colmap.read_blender_scene(root, "test")
    extent = colmap.nerfpp_norm(specs)["radius"]
    rng = np.random.default_rng(0)
    scene = colmap.static_scene_context(rng.uniform(-1.3, 1.3, (n_seeds, 3)), device=dev)
    frames = static_frames(scene, specs, dev)
    cfg = slice_trainer_config(ModelConfig(static_scene=True, motion_offset=False,
                                           capacity=capacity, n_init_points=n_seeds), w_mask=0.0)
    crop = (min(STATIC_HW, CROP), min(STATIC_HW, CROP))
    out = phase_scene_family("static", dev, scene, frames, cfg,
                             lpips.init_random(3407, device=dev), crop, extent, smi)
    shutil.rmtree(root, ignore_errors=True)
    return out


def write_smplx_asset(path, model):
    """The rig as an SMPL-X .npz of the real asset's layout: (V, 3, 400)
    shapedirs with the betas in columns [:10] and the expressions in
    [300:310], parents in kintree_table (load_smplx_npz reads it back)."""
    sd = model.shapedirs.cpu().numpy()
    full = np.zeros(sd.shape[:2] + (400,), np.float32)
    full[..., :10], full[..., 300:310] = sd[..., :10], sd[..., 10:20]
    parents = np.array(model.parents, np.int64)
    np.savez(path, v_template=model.v_template.cpu().numpy(), shapedirs=full,
             posedirs=model.posedirs.cpu().numpy(), J_regressor=model.J_regressor.cpu().numpy(),
             weights=model.weights.cpu().numpy(), f=model.faces.cpu().numpy().astype(np.uint32),
             kintree_table=np.stack([parents, np.arange(len(parents))]))


def phase_dna(dev, smi, world, root=DNA_DIR, n_poses=2):
    """The DNA-Rendering reader on the card's machine (module docstring,
    phase 12), where h5py imports; otherwise one line says it does not."""
    try:
        import h5py
    except ImportError:
        print("dna: h5py does not import on this machine: no DNA-Rendering capture is read here "
              "(data/smc.py and data/dna.py are checked on the CPU only)", flush=True)
        emit({"phase": "dna", "skipped": "h5py does not import"})
        return None
    import cv2

    scene, frames, (target, valid) = world
    h, w = SMPLX_HW
    H, W = 2 * h, 2 * w  # the 5-megapixel capture; the reader halves it
    K, R, T = orbit_krt(h, w, 2.5, 0.0)
    cam = Camera.from_KRT(K, R.T, T, h, w, device=dev)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    asset = os.path.join(root, "SMPLX_NEUTRAL.npz")
    write_smplx_asset(asset, scene.smpl)
    main = os.path.join(root, "0007_01_main.smc")
    annots = os.path.join(root, "0007_01_annotations_annots.smc")
    poses = np.stack([f.poses[0].cpu().numpy() for f in frames[:n_poses]])
    jpgs, sources = [], []
    with h5py.File(main, "w") as fm, h5py.File(annots, "w") as fa:
        g = fa.create_group("Camera_Parameter/26")
        Kc = K.copy()
        Kc[:2] *= 2
        c2w = np.linalg.inv(np.vstack([np.concatenate([R, T[:, None]], 1), [0, 0, 0, 1]]))
        for k, v in (("K", Kc), ("D", np.zeros(5)), ("RT", c2w), ("Color_Calibration", np.eye(3))):
            g.create_dataset(k, data=v)
        for i in range(n_poses):
            sp = {"poses": torch.as_tensor(poses[i:i + 1], device=dev),
                  "shapes": torch.zeros((1, 20), device=dev), "R": torch.eye(3, device=dev),
                  "Th": torch.zeros((1, 3), device=dev)}
            with torch.no_grad():
                out = render_frame(target, valid, None, scene, sp, cam, torch.zeros(3, device=dev),
                                   0, motion_offset=False, device=dev)
            sources.append(out["render"])
            rgb = (out["render"].clamp(0, 1) * 255).round().to(torch.uint8).cpu().numpy()
            big = cv2.resize(rgb[..., ::-1], (W, H), interpolation=cv2.INTER_LINEAR)
            msk = ((out["render_alpha"] > 0.05).to(torch.uint8) * 255).cpu().numpy()
            msk = cv2.resize(np.repeat(msk[..., None], 3, 2), (W, H),
                             interpolation=cv2.INTER_NEAREST)
            jpgs.append(cv2.imencode(".jpg", big)[1])
            fm.create_dataset(f"Camera_5mp/26/color/{i}",
                              data=np.frombuffer(jpgs[-1].tobytes(), np.uint8))
            fa.create_dataset(f"Mask/26/mask/{i}",
                              data=np.frombuffer(cv2.imencode(".png", msk)[1].tobytes(), np.uint8))
        sx = fa.create_group("SMPLx")
        for k, v in (("betas", np.zeros((n_poses, 10))), ("expression", np.zeros((n_poses, 10))),
                     ("fullpose", poses), ("transl", np.zeros((n_poses, 3)))):
            sx.create_dataset(k, data=v.astype(np.float32))
        sx.create_dataset("scale", data=np.float32(1.0))

    (read_scene, specs), read_ms = clocked_ms(lambda: dna.read_dna_rendering(
        main, "train", smplx_path=asset, device=dev))
    if [s.frame_id for s in specs] != list(range(n_poses)) or not all(
            torch.equal(getattr(read_scene.smpl, f), getattr(scene.smpl, f))
            for f in ("v_template", "shapedirs", "posedirs", "J_regressor", "weights")):
        raise AssertionError(f"dna: the reader's specs {[s.frame_id for s in specs]} or rig differ")
    crop = (min(h, CROP), min(w, CROP))
    loaded, load_ms = clocked_ms(lambda: [s.load(crop, device=dev) for s in specs])

    # the frame in memory: the same bytes through the reader's steps
    img = cv2.cvtColor(cv2.imdecode(jpgs[0], cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    img = cv2.undistort(img.astype(np.float32) / 255.0, Kc, np.zeros(5))
    with h5py.File(annots, "r") as fa:
        m = np.max(cv2.imdecode(fa["Mask/26/mask/0"][()], cv2.IMREAD_COLOR), axis=2)
    m = cv2.undistort((m != 0).astype(np.float32), Kc, np.zeros(5))
    img[m == 0] = 0.0
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
    f0 = loaded[0]
    cam_err = max(float((getattr(f0.camera, k) - getattr(cam, k)).abs().max()
                        / (getattr(cam, k).abs().max() + 1e-12))
                  for k in ("world_view", "full_proj", "cam_center"))
    psnr_vs_render = float(-10 * torch.log10(((f0.image - sources[0]) ** 2).mean()))
    if not np.array_equal(f0.image.cpu().numpy(), img) or cam_err > 1e-5 or \
            not np.array_equal(f0.poses.cpu().numpy(), poses[:1]) or \
            tuple(f0.image.shape) != (h, w, 3) or f0.pose_rotmats.shape != (54, 3, 3):
        raise AssertionError(f"dna: the loaded frame differs from the one in memory "
                             f"(camera {cam_err:.2e})")

    # three training steps from the loaded frames
    cfg = slice_trainer_config(ModelConfig(smpl_type="smplx", motion_offset=False,
                                           n_init_points=SMPLX_VERTS))
    tr = Trainer(read_scene, loaded, loaded[-1:], cfg, lpips.init_random(3407, device=dev),
                 crop_hw=crop, device=dev)
    losses = []
    tr.log_fn = lambda it, logs: losses.append(logs["loss"])
    _, launches = counted(lambda: tr.train(3, eval_iters=[]))
    if len(losses) != 3 or not all(math.isfinite(x) for x in losses) or \
            any(n != 3 for n in blend(launches).values()):
        raise AssertionError(f"dna: three steps gave losses {losses}, launches {launches}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"dna ({smi}): a {W}x{H} capture pair of {n_poses} poses read in {read_ms:.1f} ms, "
          f"frames decoded in {load_ms:.1f} ms, {w}x{h} frames bitwise the in-memory decode, "
          f"PSNR {psnr_vs_render:.2f} dB against the source render (JPEG and the 2x resizes); "
          f"3 steps, losses {losses}", flush=True)
    emit({"phase": "dna", "nvidia_smi": smi, "capture_hw": [H, W], "frame_hw": [h, w],
          "poses": n_poses, "read_ms": read_ms, "load_ms": load_ms, "camera_rel_err": cam_err,
          "psnr_vs_source_render": psnr_vs_render, "losses": losses, "launches": launches})
    return launches


# ---- orbits, the viewer, MonoCap and the sharded step ---------------------------------


def orbit_frames(scene, base, dataset, H, dev, n=None):
    """The n orbit views of `dataset` (render/novel_view.py) about base's
    pose at H x H, the subject moved to the orbit's centre by its SMPL
    translation (the posed body's mean vertex onto it): base's Frame with
    the orbit's camera and that Th."""
    fn = nv.orbit_w2c_zju if dataset == "zju" else nv.orbit_w2c_monocap
    n = n or ORBIT_VIEWS
    v, _ = S.lbs_vertices(scene.smpl, base.poses[0], base.shapes[0])
    world = v @ base.R.T + base.Th
    Th = base.Th + (torch.tensor(nv.ORBIT_CENTER[dataset], device=dev) - world.mean(0))
    K = np.array([[ORBIT_FOCAL * H, 0, H / 2], [0, ORBIT_FOCAL * H, H / 2], [0, 0, 1.0]])
    frames = []
    for i in range(n):
        w2c = fn(i, n)
        frames.append(dataclasses.replace(base, Th=Th, camera=Camera.from_KRT(
            K, w2c[:3, :3].T, w2c[:3, 3], H, H, device=dev)))
    return frames


def cached_render(tr, frame, cache, raster=None):
    """render_zju's serving render: the MLP-free path on a pose's cached transforms."""
    ts = tr.ts
    with torch.no_grad():
        return render_frame(ts.params["gauss"], ts.gstate.valid, ts.params["mlps"], tr.scene,
                            frame.smpl_params, frame.camera, tr.bg, MODEL.sh_degree,
                            cached_transforms=cache["transforms"],
                            cached_translation=cache["translation"], rasterize_fn=raster,
                            device=tr.device)


def plane_images(out):
    return {"color": out["render"], "alpha": out["render_alpha"], "depth": out["render_depth"],
            "final_T": out["final_T"]}


def phase_novel_view(dev, trained, smi):
    """Orbit views of the trained avatar, compacted, as render_zju
    --novel_view serves them: the test frame's pose, its transforms cached
    once by a full-path render, ORBIT_VIEWS ZJU views at 512x512 and as many
    MonoCap views at 1024x1024 on the cached path. Every view has alpha > 0.5
    somewhere and its subject within a quarter of the frame of the centre
    (tests/test_novel_view.py:147-187); the views ORBIT_CHECKED of each orbit
    against the plain blend (the image rule). Host-clock ms per orbit frame,
    the pairs and longest tile of every view, and row 1 on view 0: the
    kernel's ms, its bound and the plain blend's ms. Returns ({orbit:
    launches}, {input: row})."""
    tr, scene, frames, lp = trained
    cap = tr.compact_for_eval()
    live = int(tr.ts.gstate.valid.sum())
    base = frames[TRAIN_FRAMES]
    launches, rows, lines = {}, {}, {}
    for dataset in ("zju", "monocap"):
        H = ORBIT_HW[dataset]
        views = orbit_frames(scene, base, dataset, H, dev)
        seen = {}

        def drive():
            full, _ = serving_images(tr, views[0])
            cache = {"transforms": full["transforms"], "translation": full["translation"]}
            outs = [cached_render(tr, f, cache, lambda proj, *a, i=i: seen.__setitem__(i, proj)
                                  or rc.rasterize_cuda(proj, *a)) for i, f in enumerate(views)]
            return cache, outs

        (cache, outs), n = counted(drive)
        if n != {"rasterize_fwd": 1 + len(views), "rasterize_bwd": 0, "segment_sum": 0,
                 "svd3": 0}:
            raise AssertionError(f"novel_view {dataset}: launches {n}")
        launches[dataset] = n
        offsets = []
        for i, out in enumerate(outs):
            alpha = out["render_alpha"]
            ys, xs = torch.nonzero(alpha > 0.1, as_tuple=True)
            if float(alpha.max()) <= 0.5 or not len(ys):
                raise AssertionError(f"novel_view {dataset} view {i}: subject not visible")
            off = max(abs(float(ys.float().mean()) - H / 2), abs(float(xs.float().mean()) - H / 2))
            offsets.append(off / H)
            if off > 0.25 * H:
                raise AssertionError(f"novel_view {dataset} view {i}: subject {off:.0f} px off "
                                     "the centre")
        errs, plain_ms = {}, []
        for i in ORBIT_CHECKED:
            ref, ms = clocked_ms(lambda i=i: rasterize_reference(
                seen[i], tr.bg, H, H, tile_h=rc.TILE, tile_w=rc.TILE))
            plain_ms.append(ms)
            errs[i] = check_images(plane_images(outs[i]), ref, f"novel_view {dataset} view {i}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in views:
            cached_render(tr, f, cache)
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3 / len(views)
        budgeted = orbit_through_budgets(tr, lp, views, cache, outs, f"novel_view {dataset}", smi)
        n = {k: v + budgeted["launches"][k] for k, v in n.items()}
        launches[dataset] = n
        bins = [rc.bin_projected(seen[i], H, H) for i in range(len(views))]
        pairs = [p.num_pairs for p in bins]
        longest = [int(p.tile_count.max()) for p in bins]
        p0, proj0 = bins[0], seen[0]
        rows[f"orbit_{dataset}_{H}x{H}"] = {
            "pairs": p0.num_pairs, "max_tile_pairs": int(p0.tile_count.max()), **segments(p0),
            "rasterize_fwd": {
                "max_abs_err": max(errs.values()), "plain_ms": plain_ms[0],
                "ms": cuda_ms(lambda: rc.rasterize_pairs(p0, proj0, H, H),
                              site="rasterize_fwd orbit"),
                "ms_unsplit": cuda_ms(lambda: rc.rasterize_pairs(p0, proj0, H, H,
                                                                 unsplit_len(p0)),
                                      site="rasterize_fwd orbit unsplit"),
                **kernel_bound(proj0, p0, H, H)}}
        lines[dataset] = {"hw": H, "views": len(views), "ms_per_frame": frame_ms,
                          "served_through_budgets": budgeted,
                          "pairs": pairs, "max_tile_pairs": longest,
                          "subject_offset_share_max": max(offsets), "max_abs_err": errs,
                          "plain_ms": plain_ms, "launches": n}
        print(f"novel_view {dataset} ({smi}): {len(views)} views at {H}x{H}, {frame_ms:.2f} ms "
              f"per orbit frame (cached path, host clock), pairs {min(pairs)}-{max(pairs)} "
              f"(median {int(np.median(pairs))}), longest tile {min(longest)}-{max(longest)}; "
              f"view 0's forward {rows[f'orbit_{dataset}_{H}x{H}']['rasterize_fwd']['ms']:.4f} ms, "
              f"bound {rows[f'orbit_{dataset}_{H}x{H}']['rasterize_fwd']['bound_ms']:.4f} ms",
              flush=True)
    emit({"phase": "novel_view", "nvidia_smi": smi, "live": live, "capacity": cap,
          "orbit_focal_heights": ORBIT_FOCAL, **lines})
    return launches, rows


def orbit_through_budgets(tr, lp, views, cache, outs, what, smi):
    """render_zju --novel_view's serving of an orbit: a Trainer whose train
    split is the orbit's first view, given the compacted avatar's state, so
    its budgets are probed at the orbit's size (render_zju builds its
    Trainer on the first served frame); every view on the cached path through
    those budgets (_eval_raster), counted, bitwise the per-frame list's
    (outs) with overflow 0; ms per orbit frame over the views on each
    binning (host clock, SERVE_TURNS turns), and for view 0 on both
    binnings binning_times."""
    srv = Trainer(tr.scene, views[:1], views, tr.cfg, lp, device=tr.device)
    srv.set_state(tr.ts)
    raster = srv._eval_raster
    got, n = counted(lambda: [cached_render(srv, f, cache, raster) for f in views])
    if raster is None or n["rasterize_fwd"] != len(views):
        raise AssertionError(f"{what}: the budgeted orbit launched {n}")
    over = [int(o["overflow"]) for o in got]
    same = [same_images(plane_images(a), plane_images(b)) for a, b in zip(got, outs)]
    if any(over) or not all(same):
        raise AssertionError(f"{what}: through the budgets, overflow {over}, views not bitwise "
                             f"the per-frame list's: {[i for i, x in enumerate(same) if not x]}")
    def orbit(r):
        for f in views:
            cached_render(srv, f, cache, r)

    loops = {b: [] for b in ("per_frame_list", "budgets")}
    for _ in range(SERVE_TURNS):
        for b in ("per_frame_list", "budgets", "budgets", "per_frame_list"):
            _, ms = clocked_ms(functools.partial(orbit, raster if b == "budgets" else None))
            loops[b].append(ms / len(views))
    out = {"budgets": srv.budgets, "launches": n,
           "ms_per_frame": {b: float(np.median(v)) for b, v in loops.items()},
           "ms_per_frame_turns": loops}
    out.update({f"view0_{b}": v for b, v in binning_times(
        {b: functools.partial(cached_render, srv, views[0], cache, r)
         for b, r in (("per_frame_list", None), ("budgets", raster))}).items()})
    print(f"{what} served through the budgets ({smi}): {len(views)} views bitwise the per-frame "
          f"list's, overflow 0; ms per orbit frame (median of {2 * SERVE_TURNS} loops each, in "
          f"turns) {out['ms_per_frame']}; budgets {out['budgets']['eval']}; "
          + "; ".join(f"{k}: {v['host_ms']:.2f} host ms, {v['device_busy_ms']:.2f} busy ms, "
                      f"{v['host_syncs']} syncs" for k, v in out.items() if k.startswith("view0"))
          + " (a profiled frame's syncs count the synchronize that ends it)", flush=True)
    del srv
    return out


def phase_viewer(dev, trained, smi, iters=VIEWER_ITERS):
    """The SIBR remote viewer on localhost while a Trainer (the trainer
    phase's scene and frames) trains `iters` iterations: a client thread
    speaks the protocol, one message a poll, the first three with a camera
    (a train view, the test view, the train view at scale_modifier 0.5), the
    rest idle (resolution 0). The bytes it gets must equal the uint8
    quantization of render_frame at the same camera and state, rendered
    outside the viewer's path; one viewer frame against the plain blend.
    Host-clock ms of a poll that serves a camera, the client's round trip
    (which waits for the next poll, one iteration), and the poll's cost with
    no client. Returns the kernels' launches in the run."""
    _, scene, frames, lp = trained
    gui = NetworkGUI(port=0)
    gui.init()
    port = gui.listener.getsockname()[1]
    tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], trainer_config(), lp,
                 crop_hw=(CROP, CROP), gui=gui, source_path="synthetic", device=dev)
    cams = [(frames[0].camera, 1.0), (frames[TRAIN_FRAMES].camera, 1.0), (frames[0].camera, 0.5)]
    expected, seen, poll_ms = [], [], []
    render = tr._gui_render

    def gui_render(spec):
        counts = (rc.launches, rc.bwd_launches, rc.segment_launches)
        with torch.no_grad():
            out = render_frame(tr.ts.params["gauss"], tr.ts.gstate.valid, tr.ts.params["mlps"],
                               scene, frames[0].smpl_params,
                               Camera.from_viewer_spec(spec, device=dev), tr.bg,
                               MODEL.sh_degree, scaling_modifier=float(spec["scale_modifier"]),
                               rasterize_fn=lambda proj, *a: seen.append(proj)
                               or rc.rasterize_cuda(proj, *a), device=dev)
        expected.append(quantize(out["render"]))
        rc.launches, rc.bwd_launches, rc.segment_launches = counts  # a comparison: not counted
        return render(spec)

    tr._gui_render = gui_render
    poll = gui.poll

    def timed_poll(*a, **kw):
        out, ms = clocked_ms(lambda: poll(*a, **kw))
        poll_ms.append(ms)
        return out

    gui.poll = timed_poll
    got, rtt, err = [], [], []
    # connected before training starts: the first poll accepts it
    c = socket.create_connection(("127.0.0.1", port), timeout=120)
    c.settimeout(120)

    def client():
        try:
            for i in range(iters):
                cam, scale = cams[i] if i < len(cams) else (None, 1.0)
                H, W = (cam.height, cam.width) if cam is not None else (0, 0)
                msg = {"resolution_x": W, "resolution_y": H, "train": True,
                       "fov_y": 2 * math.atan(float(cam.tan_fovy)) if cam else 0.0,
                       "fov_x": 2 * math.atan(float(cam.tan_fovx)) if cam else 0.0,
                       "z_near": 0.01, "z_far": 100.0, "shs_python": False,
                       "rot_scale_python": False, "keep_alive": False, "scale_modifier": scale,
                       "view_matrix": (cam.world_view.cpu().numpy().reshape(-1).tolist()
                                       if cam else [0.0] * 16),
                       "view_projection_matrix": (cam.full_proj.cpu().numpy().reshape(-1)
                                                  .tolist() if cam else [0.0] * 16)}
                body = json.dumps(msg).encode()
                t0 = time.perf_counter()
                c.sendall(len(body).to_bytes(4, "little") + body)
                img = recv_exact(c, H * W * 3)
                n = int.from_bytes(recv_exact(c, 4), "little")
                if recv_exact(c, n) != b"synthetic":
                    raise AssertionError("the viewer's source path")
                rtt.append((time.perf_counter() - t0) * 1e3)
                if cam is not None:
                    got.append(np.frombuffer(img, np.uint8).reshape(H, W, 3))
            c.close()
        except Exception as e:  # raised below
            err.append(e)

    thread = threading.Thread(target=client)
    thread.start()
    try:
        # eager: the viewer is polled after every iteration, one message a poll
        _, launches = counted(lambda: tr.train(iters, eval_iters=[], dispatch_engine="eager"))
    finally:
        thread.join(timeout=600)
        gui.close()
    want = {"rasterize_fwd": iters + len(cams), "rasterize_bwd": iters, "segment_sum": iters}
    if err or len(got) != len(cams) or blend(launches) != want:
        raise AssertionError(f"viewer: client {err}, {len(got)} images, launches {launches} "
                             f"(want {want})")
    for i, (a, b) in enumerate(zip(got, expected)):
        if not np.array_equal(a, b):
            raise AssertionError(f"viewer: camera {i}'s bytes differ from the quantized render "
                                 f"({int((a != b).sum())} bytes)")
    if np.array_equal(got[0], got[2]):
        raise AssertionError("viewer: scale_modifier 0.5 rendered the same bytes")
    cam0 = cams[0][0]
    ref = rasterize_reference(seen[0], tr.bg, cam0.height, cam0.width, tile_h=rc.TILE,
                              tile_w=rc.TILE)
    err_fwd = check_images(rc.rasterize_cuda(seen[0], tr.bg, cam0.height, cam0.width), ref,
                           "viewer frame")
    idle = NetworkGUI(port=0)
    idle.init()
    n_idle = 2000
    t0 = time.perf_counter()
    for _ in range(n_idle):
        idle.poll(None, "synthetic", training_done=False)
    idle_us = (time.perf_counter() - t0) * 1e6 / n_idle
    idle.close()
    served = [poll_ms[i] for i in range(len(cams))]
    print(f"viewer ({smi}): {len(cams)} cameras served during {iters} iterations, bytes equal "
          f"to the quantized render; a serving poll {[round(x, 2) for x in served]} ms, client "
          f"round trip {[round(x, 2) for x in rtt[:len(cams)]]} ms (waits for the next poll); "
          f"a poll with no viewer {idle_us:.2f} us", flush=True)
    emit({"phase": "viewer", "nvidia_smi": smi, "hw": HW, "iterations": iters,
          "cameras": len(cams), "bytes_equal": True, "max_abs_err_vs_plain": err_fwd,
          "serving_poll_ms": served, "idle_poll_ms": poll_ms[len(cams):],
          "round_trip_ms": rtt, "poll_without_viewer_us": idle_us, "launches": launches})
    return launches


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("the viewer server hung up")
        buf += chunk
    return buf


def monocap_frames(scene, dev, H=None, n_frames=TRAIN_FRAMES + 1):
    """make_frames at MonoCap's H x H (the target on the SMPL vertices at
    TARGET_OPACITY), with the crop autosize_crop's rule takes for the
    subjects' rects (alpha > 0.05), each frame's window centred on its rect."""
    H = H or MONOCAP_HW
    frames, _ = make_frames(scene, n_frames=n_frames, H=H, W=H, crop=CROP, opacity=TARGET_OPACITY)
    rects = []
    for f in frames:
        ys, xs = np.nonzero((f.bkgd_mask > 0.05).cpu().numpy())
        rects.append((ys.min(), ys.max(), xs.min(), xs.max()))
    crop = readers.crop_for_rects([(y1 - y0 + 1, x1 - x0 + 1) for y0, y1, x0, x1 in rects], (H, H))
    return [dataclasses.replace(
        f, crop_y0=int(np.clip((y0 + y1) // 2 - crop[0] // 2, 0, H - crop[0])),
        crop_x0=int(np.clip((x0 + x1) // 2 - crop[1] // 2, 0, H - crop[1])))
        for f, (y0, y1, x0, x1) in zip(frames, rects)], crop


def phase_monocap(dev, smi):
    """MonoCap's frame size through the Trainer: phase_scene_family on a
    6,890-vertex SMPL scene at 1024x1024 (the MLPs on), 46,080 capacity,
    the autosized crop, SLICE_TRAINER with evals at MONOCAP_EVALS under
    queued (a TBWriter where tensorboardX imports) and scan, five steps
    under profile_trace."""
    scene = make_scene(n_verts=N_VERTS, device=dev)
    frames, crop = monocap_frames(scene, dev)
    cfg = Config(model=MODEL, optim=OptimConfig(**SLICE_TRAINER),
                 pipe=PipelineConfig(test_iterations=MONOCAP_EVALS, save_iterations=()))
    logdir = os.path.join(BUILD, "monocap_tb")
    shutil.rmtree(logdir, ignore_errors=True)
    tb = obs.TBWriter(logdir)
    tb_on = tb.writer is not None
    print(f"monocap: {MONOCAP_HW}x{MONOCAP_HW}, crop {crop}; tensorboardX "
          f"{'imports: TBWriter on' if tb_on else 'does not import: TBWriter off'}", flush=True)
    # the second run under scan, as for the other families; the drivers phase
    # runs train_monocap from disk under both engines
    out = phase_scene_family("monocap", dev, scene, frames, cfg,
                             lpips.init_random(3407, device=dev), crop, 1.0, smi, tb=tb,
                             trace_dir=os.path.join(BUILD, "monocap_trace"))
    tb.close()
    events = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
    if tb_on and not events:
        raise AssertionError("monocap: the TBWriter wrote no event file")
    shutil.rmtree(logdir, ignore_errors=True)
    emit({"phase": "monocap_tensorboard", "tensorboardx": tb_on, "event_files": len(events)})
    return out


def reference_batch_step(step, ts, frames, idx, feats):
    """The data-parallel step on one process, the plain reference of the
    sharded one: the grads of each frame's loss (TrainStep.grads) averaged,
    AdamW with the step's skips, and each frame's densify statistics
    summed. Returns (TrainState, mean loss, grads)."""
    runs = [step.grads(ts, frames[i], 0, feats[i]) for i in idx]
    grads = {g: {n: sum(r[3][g][n] for r in runs) / len(runs) for n in runs[0][3][g]}
             for g in runs[0][3]}
    cfg = step.cfg
    skip = optim.skipped_groups(cfg.optim, cfg.model.white_background, ts.step + 1)
    opt_state = optim.adamw_step(cfg.optim, ts.params, grads, ts.opt_state, skip)
    gs = ts.gstate
    with torch.no_grad():
        for i, (_, _, out, _, off) in zip(idx, runs):
            cam = frames[i].camera
            gnorm = torch.linalg.norm(off * torch.tensor([cam.width * 0.5, cam.height * 0.5],
                                                         device=off.device), dim=-1)
            vis = out["visibility_filter"]
            gs = dataclasses.replace(
                gs, xyz_grad_accum=gs.xyz_grad_accum + torch.where(vis, gnorm, 0.0),
                denom=gs.denom + vis.to(torch.float32),
                max_radii2d=torch.maximum(gs.max_radii2d, torch.where(
                    vis, out["radii"].to(torch.float32), 0.0)),
                joint_F=gs.joint_F + out["pose_out"]["Rs"].detach(),
                lbs_weight_sum=gs.lbs_weight_sum + out["lbs_weights"].detach())
    loss = float(sum(float(r[0]) for r in runs) / len(runs))
    return TrainState(ts.params, opt_state, gs, ts.step + 1), loss, grads


def flat_params(params):
    """{group.name: tensor} of the trained tensors, the grads' keys."""
    out = {f"{f}.{f}": getattr(params["gauss"], f).detach() for f in G.FIELDS}
    out.update({f"{k}.{n}": t.detach() for k, m in params["mlps"].items()
                for n, t in m.named_parameters()})
    return out


def sharded_inputs(dev):
    """What both the ranks and the reference start from: the train phase's
    scene and frames (rebuilt, bitwise, from their seeds), the seeded LPIPS
    backbone, the frames' ground-truth LPIPS towers, and the step."""
    scene = make_scene(n_verts=N_VERTS, device=dev)
    frames, _ = make_frames(scene, n_frames=TRAIN_FRAMES, H=HW, W=HW, crop=CROP)
    lp = lpips.init_random(3407, device=dev)
    feats = [lpips.gt_features(lp, crop_window(f.image, f.crop_y0, f.crop_x0, CROP, CROP))
             for f in frames]
    return scene, frames, lp, feats, Config(model=MODEL)


def mesh_indices(k, n_data):
    """The frames of step k's data rows."""
    return [(k * n_data + d) % TRAIN_FRAMES for d in range(n_data)]


def sharded_rank(rank, port, outdir, device):
    """One of the sharded phase's two ranks (`python chip_smoke.py
    --sharded-rank R PORT DIR DEVICE`): both on DEVICE in a gloo group; for each
    mesh of SHARDED_MESHES, SHARDED_STEPS steps of make_sharded_train_step
    (its eager form, each band at the default budgets) from the train phase's
    state (DIR/start.npz), timed, counted; rank 0 writes the losses, the first
    step's grads, the params after the first and the last step and the densify
    statistics; on the 1 x 2 mesh the ranks of BAND_ROWS measure rows 1, 2
    and 2b on their band's input (one rank at a time); then the mesh
    trainer's runs
    (mesh_trainer_runs)."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    initialize_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    probe = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(probe)  # gloo takes CUDA tensors for all_reduce
    if not torch.equal(probe, torch.full((4,), 3.0, device=dev)):
        raise AssertionError(f"gloo's all_reduce of a CUDA tensor gave {probe}")
    scene, frames, lp, feats, cfg = sharded_inputs(dev)
    report = {"rank": rank, "gloo_cuda_all_reduce": True, "meshes": {}}
    for n_data, n_tile in SHARDED_MESHES:
        name = f"{n_data}x{n_tile}"
        mesh = make_mesh(n_data, n_tile, [0, 1], device=dev)
        bands = []
        _, step = make_sharded_train_step(
            scene, cfg, mesh, CROP, CROP, lp,
            rasterize=lambda proj, *a, **k: bands.append(proj) or rc.rasterize_cuda(proj, *a, **k))
        ts = ckpt.restore_checkpoint(os.path.join(outdir, "start.npz"), dev)
        first = {}
        grads_of = step.mesh_grads

        def mesh_grads(*a, **k):
            out = grads_of(*a, **k)
            first.setdefault("r", out)
            return out

        step.mesh_grads = mesh_grads
        losses, times = [], []
        zero_launch_counts()
        for k in range(SHARDED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, logs = step(ts, frames, mesh_indices(k, n_data), 0, feats)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(logs["loss"]))
            if k == 0:
                after_first = {k2: v.clone() for k2, v in flat_params(ts.params).items()}
                stats_first = {f: getattr(ts.gstate, f).clone() for f in STAT_FIELDS}
        launches = launch_counts()
        row = None
        if n_tile > 1:
            hb = HW // n_tile
            band = rc.Projected(*(t.detach() if torch.is_tensor(t) else t for t in bands[0]))
            for r in range(2):
                dist.barrier()
                if r == rank and mesh.tile_index in BAND_ROWS:
                    row, _ = measure_rows(band, step.bg, hb, HW)
            dist.barrier()
        report["meshes"][name] = {"mesh": [mesh.data_index, mesh.tile_index], "losses": losses,
                                  "step_ms": times, "launches": launches, "band_rows": row,
                                  "trainer": mesh_trainer_runs(mesh, dev)}
        if rank == 0:
            arrays = {f"first.{k2}": v.cpu().numpy() for k2, v in after_first.items()}
            arrays.update({f"last.{k2}": v.cpu().numpy()
                           for k2, v in flat_params(ts.params).items()})
            arrays.update({f"grad.{g}.{n}": t.cpu().numpy()
                           for g, gr in first["r"][2].items() for n, t in gr.items()})
            arrays.update({f"stats_first.{f}": v.cpu().numpy() for f, v in stats_first.items()})
            arrays.update({f"stats_last.{f}": getattr(ts.gstate, f).cpu().numpy()
                           for f in STAT_FIELDS})
            np.savez(os.path.join(outdir, f"{name}.npz"), **arrays)
        del step, ts, bands
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.barrier()
    dist.destroy_process_group()


def mesh_trainer_config(**optim_kw):
    return Config(model=MODEL, optim=OptimConfig(**{**MESH_TRAINER, **optim_kw}),
                  pipe=PipelineConfig(test_iterations=MESH_EVALS, save_iterations=()))


def mesh_trainer_inputs(dev):
    """The trainer phase's scene, frames (4 train, 1 test) and LPIPS backbone."""
    scene = make_scene(n_verts=N_VERTS, device=dev)
    frames, _ = make_frames(scene, n_frames=TRAIN_FRAMES + 1, H=HW, W=HW, crop=CROP,
                            opacity=TARGET_OPACITY)
    return scene, frames, lpips.init_random(3407, device=dev)


def mesh_profile(tr, engine, steps=MESH_PROFILE_STEPS):
    """engine_breakdown of `steps` mesh steps a call past the run's end (tables
    for a longer run, no skips there), launched as the engine launches them:
    each step with no host read, the loss read once at the end of the call
    (eager reads every 10th, which a call of `steps` < 10 does not reach)."""
    cfg = dataclasses.replace(tr.cfg.optim, iterations=int(tr.ts.step) + 4 * steps)
    tr._train_step.tables = optim.step_tables(cfg, False, optim.param_groups(tr.ts.params),
                                              tr.extent, tr.device)
    frames = stage_frames(tr.train_frames)
    feats = tr._gt_lpips_features()
    stacked = None if feats is None else [torch.stack(f) for f in zip(*feats)]
    order = torch.arange(steps * tr.mesh.n_data, device=tr.device) % len(tr.train_frames)
    ts = device_state(tr.ts)

    def run():
        if engine == "eager":
            for i in range(steps):
                logs = tr._mesh_steps(ts, frames, order, stacked, i + 1, i + 1)
        else:
            logs = tr._mesh_steps(ts, frames, order, stacked, 1, steps)
        logs["loss"].cpu()

    return engine_breakdown(run, steps)


def mesh_trainer_runs(mesh, dev):
    """The Trainer over `mesh` (this rank's part), MESH_TRAINER under each of
    MESH_ENGINES from the same init: ms per iteration outside its host work
    (the round, the eval, the budget probes), the kernels' launches in the
    run, the installed band and eval budgets, a profiled call of the queued
    engine's step;
    whether queued and eager end bitwise equal (state and evals), and a
    digest of the state for the ranks' comparison."""
    scene, frames, lp = mesh_trainer_inputs(dev)
    out, states, hists = {}, {}, {}
    for engine in MESH_ENGINES:
        tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:], mesh_trainer_config(),
                     lp, crop_hw=(CROP, CROP), mesh=mesh, device=dev)
        host = {"densify": [], "eval": [], "budgets": []}

        def timed(fn, key):
            def run(*a, **kw):
                res, ms = clocked_ms(lambda: fn(*a, **kw))
                host[key].append(ms)
                return res
            return run

        tr.densify = timed(tr.densify, "densify")
        tr.evaluate = timed(tr.evaluate, "eval")
        tr._resize_pair_buffer = timed(tr._resize_pair_buffer, "budgets")
        zero_launch_counts()
        _, wall = clocked_ms(lambda: tr.train(eval_iters=MESH_EVALS, dispatch_engine=engine))
        launches = launch_counts()
        # copies: the profiled call below advances the state in place
        states[engine] = {k: np.array(v) for k, v in ckpt.flatten(tr.ts).items()}
        hists[engine] = [{k: v for k, v in m.items() if k != "elapsed_s"}
                         for m in tr.metrics_history]
        iters = MESH_TRAINER["iterations"]
        out[engine] = {"wall_ms": wall, "host_work_ms": {k: sum(v) for k, v in host.items()},
                       "ms_per_iteration": (wall - sum(sum(v) for v in host.values())) / iters,
                       "launches": launches, "budgets": tr.budgets, "evals": hists[engine],
                       "rounds": len(host["densify"])}
        if engine == "queued":  # eager launches the same step, its logs read every 10th
            out[engine]["profile"] = mesh_profile(tr, engine)
        del tr
        gc.collect()
        torch.cuda.empty_cache()
    a, b = states[MESH_ENGINES[0]], states[MESH_ENGINES[1]]
    out["bitwise"] = sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a) \
        and hists[MESH_ENGINES[0]] == hists[MESH_ENGINES[1]]
    digest = hashlib.sha256()
    for k in sorted(a):
        digest.update(k.encode() + np.ascontiguousarray(a[k]).tobytes())
    out["state_digest"] = digest.hexdigest()
    return out


def mesh_sync_free(dev):
    """A 1 x 1 mesh (no process group) on this process: the Trainer's queued
    segment of MESH_SYNC_ITERS steps of the sharded step under the sync debug
    mode "error", so that one host sync inside it fails the phase (two gloo
    ranks cannot show this: gloo's CUDA all-reduce stages through the host);
    its launches and a profiled call of the step."""
    scene, frames, lp = mesh_trainer_inputs(dev)
    tr = Trainer(scene, frames[:TRAIN_FRAMES], frames[TRAIN_FRAMES:],
                 mesh_trainer_config(iterations=MESH_SYNC_ITERS, densify_from_iter=100,
                                     densify_until_iter=0), lp,
                 crop_hw=(CROP, CROP), mesh=make_mesh(1, 1, device=dev), device=dev)
    tr.segment_sync_mode = "error"
    zero_launch_counts()
    tr.train(eval_iters=[], dispatch_engine="queued")
    launches = launch_counts()
    want = {k: MESH_SYNC_ITERS for k in BLEND_KERNELS}
    if blend(launches) != want or launches["svd3"] != MESH_SYNC_ITERS:
        raise AssertionError(f"the 1 x 1 mesh launched {launches}, not {want} and svd3")
    out = {"iterations": MESH_SYNC_ITERS, "sync_debug_mode": "error", "syncs_in_segment": 0,
           "launches": launches, "budgets": tr.budgets, "profile": mesh_profile(tr, "queued")}
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def assert_sharded_params(name, got, ref, grads, lr_steps, cfg):
    """Params within PARAM_ATOL, but where a reference grad of some step lay
    within the grad rule's atol of zero: there up to 2 lr a step (at eps
    1e-15 an Adam step is about lr sign(g), and such a sign is not fixed by
    the rule; tests/test_torch_parallel.py)."""
    worst = 0.0
    for k, v in ref.items():
        group, pname = k.split(".", 1)
        diff = np.abs(got[k] - v)
        lr = optim.group_lr(cfg.optim, group, 0)
        bad = (diff > SHARDED_PARAM_ATOL) & ~(grads[k] & (diff <= 2 * lr * lr_steps
                                                          + SHARDED_PARAM_ATOL))
        if bad.any():
            raise AssertionError(f"sharded {name}: {k} differs in {int(bad.sum())} slots, "
                                 f"max {float(diff.max()):.3e}")
        worst = max(worst, float(np.where(grads[k], 0.0, diff).max()) if diff.size else 0.0)
    return worst


def phase_sharded(dev, train_ts, smi):
    """Training over pixel bands and frames on two ranks of the one card
    (parallel/sharded.py): two processes, both on cuda:0, in a gloo group
    (NCCL refuses two ranks on one device), the band gather a SUM all-reduce
    of zero-padded bands. Each mesh of SHARDED_MESHES (1 x 2: two bands of
    256 rows; 2 x 1: two frames a step) runs SHARDED_STEPS steps from the
    train phase's state; held to the same steps on one process
    (TrainStep for one frame a step, reference_batch_step for two): each
    step's loss (rtol 1e-4, atol 1e-5), the first step's grads (rtol 1e-3,
    atol 1e-5), the params after the first and the last step (atol 2e-5,
    assert_sharded_params), the densify denom exactly and accum to the grad
    rule. The denser band's rows 1, 2 and 2b (BAND_ROWS: its input against
    the plain versions), each rank's step ms. The mesh trainer on each mesh
    (mesh_trainer_runs, gated by mesh_trainer_line) and a 1 x 1 mesh's
    sync-free queued segment on this process (mesh_sync_free). Returns
    ({mesh or mesh_trainer_engine: launches}, the band rows of rank 0)."""
    outdir = SHARDED_DIR
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    ckpt.save_checkpoint(os.path.join(outdir, "start.npz"), train_ts)
    scene, frames, lp, feats, cfg = sharded_inputs(dev)
    _, step = make_train_step(scene, cfg, None, lp, CROP, CROP, device=dev)
    refs = {}
    for n_data, n_tile in SHARDED_MESHES:
        ts = ckpt.restore_checkpoint(os.path.join(outdir, "start.npz"), dev)
        losses, undecided = [], None
        for k in range(SHARDED_STEPS):
            idx = mesh_indices(k, n_data)
            if n_data == 1:
                _, _, _, grads, _ = step.grads(ts, frames[idx[0]], 0, feats[idx[0]])
                ts, logs = step(ts, frames[idx[0]], 0, feats[idx[0]])
                loss = float(logs["loss"])
            else:
                ts, loss, grads = reference_batch_step(step, ts, frames, idx, feats)
            flat_g = {f"{g}.{n}": t for g, gr in grads.items() for n, t in gr.items()}
            small = {kk: (v.abs() <= SHARDED_GRAD_ATOL).cpu().numpy() for kk, v in flat_g.items()}
            undecided = small if undecided is None else {kk: undecided[kk] | small[kk]
                                                         for kk in small}
            losses.append(loss)
            if k == 0:
                # copies: the step updates the params in place
                first = {kk: v.cpu().numpy().copy() for kk, v in flat_params(ts.params).items()}
                stats_first = {f: getattr(ts.gstate, f).cpu().numpy().copy() for f in STAT_FIELDS}
                first_grads = {kk: v.cpu().numpy().copy() for kk, v in flat_g.items()}
                first_small = small
        refs[n_data, n_tile] = dict(
            losses=losses, first=first, grads=first_grads, first_small=first_small,
            undecided=undecided, last={kk: v.cpu().numpy() for kk, v in flat_params(
                ts.params).items()}, stats_first=stats_first,
            stats_last={f: getattr(ts.gstate, f).cpu().numpy() for f in STAT_FIELDS})
    del step, ts
    gc.collect()
    torch.cuda.empty_cache()
    sync_free = mesh_sync_free(dev)

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    logs = [open(os.path.join(outdir, f"rank{r}.log"), "w") for r in range(2)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank",
                               str(r), str(port), outdir, str(dev)], stdout=logs[r],
                              stderr=subprocess.STDOUT, cwd=os.path.dirname(os.path.abspath(
                                  __file__))) for r in range(2)]
    try:
        rcs = [p.wait(timeout=SHARDED_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    if any(rcs):
        tails = [open(os.path.join(outdir, f"rank{r}.log")).read()[-3000:] for r in range(2)]
        raise AssertionError(f"sharded: the ranks exited {rcs}:\n" + "\n".join(tails))
    reports = [json.load(open(os.path.join(outdir, f"rank{r}.json"))) for r in range(2)]
    launches, lines, band_rows = {}, {}, {}
    for n_data, n_tile in SHARDED_MESHES:
        name = f"{n_data}x{n_tile}"
        ref = refs[n_data, n_tile]
        got = dict(np.load(os.path.join(outdir, f"{name}.npz")))
        ranks = [r["meshes"][name] for r in reports]
        for r in ranks:
            np.testing.assert_allclose(r["losses"], ref["losses"], rtol=SHARDED_LOSS_RTOL,
                                       atol=SHARDED_LOSS_ATOL, err_msg=f"sharded {name} losses")
        grad_err = 0.0
        for kk, g_ref in ref["grads"].items():
            g = got[f"grad.{kk}"]
            np.testing.assert_allclose(g, g_ref, rtol=SHARDED_GRAD_RTOL, atol=SHARDED_GRAD_ATOL,
                                       err_msg=f"sharded {name} grad {kk}")
            grad_err = max(grad_err, float(np.abs(g - g_ref).max()))
        err_first = assert_sharded_params(name, {kk: got[f"first.{kk}"] for kk in ref["first"]},
                                          ref["first"], ref["first_small"], 1, cfg)
        err_last = assert_sharded_params(name, {kk: got[f"last.{kk}"] for kk in ref["last"]},
                                         ref["last"], ref["undecided"], SHARDED_STEPS, cfg)
        # the densify statistics: after the first step as tests/test_parallel.py
        # holds them; after the last, denom exactly, and accum's spread only
        # reported (a slot whose Adam sign flipped moves its splat by 2 lr, and
        # that splat's screen-space grads in the later steps with it)
        for when in ("stats_first", "stats_last"):
            np.testing.assert_array_equal(got[f"{when}.denom"], ref[when]["denom"],
                                          err_msg=f"sharded {name} {when} denom")
        np.testing.assert_allclose(got["stats_first.xyz_grad_accum"],
                                   ref["stats_first"]["xyz_grad_accum"], rtol=SHARDED_GRAD_RTOL,
                                   atol=SHARDED_GRAD_ATOL,
                                   err_msg=f"sharded {name} first step's xyz_grad_accum")
        np.testing.assert_array_equal(got["stats_first.max_radii2d"],
                                      ref["stats_first"]["max_radii2d"],
                                      err_msg=f"sharded {name} first step's max_radii2d")
        a, b = got["stats_last.xyz_grad_accum"], ref["stats_last"]["xyz_grad_accum"]
        beyond = np.abs(a - b) > SHARDED_GRAD_ATOL + SHARDED_GRAD_RTOL * np.abs(b)
        accum_last = {"slots_beyond_grad_rule": int(beyond.sum()),
                      "max_rel_err": float((np.abs(a - b) / np.maximum(np.abs(b), 1e-12))[
                          b != 0].max()) if (b != 0).any() else 0.0}
        per = {"rasterize_fwd": SHARDED_STEPS, "rasterize_bwd": SHARDED_STEPS,
               "segment_sum": SHARDED_STEPS}
        if any(blend(r["launches"]) != per for r in ranks):
            raise AssertionError(f"sharded {name}: launches {[r['launches'] for r in ranks]}")
        launches[name] = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
        lines[name] = {"losses": ranks[0]["losses"], "reference_losses": ref["losses"],
                       "step_ms": [r["step_ms"] for r in ranks],
                       "ms_per_step": [float(np.median(r["step_ms"][1:])) for r in ranks],
                       "grad_max_abs_err": grad_err, "param_max_abs_err_first": err_first,
                       "param_max_abs_err_last": err_last, "denom_exact": True,
                       "accum_after_last_step": accum_last,
                       "launches_per_rank": per}
        lines[name]["trainer"] = mesh_trainer_line(name, [r["trainer"] for r in ranks], smi)
        for engine in MESH_ENGINES:
            launches[f"{name}_trainer_{engine}"] = {
                k: sum(r["trainer"][engine]["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
        if n_tile > 1:
            measured = [(r, rank) for r, rank in zip(ranks, range(2)) if r["band_rows"]]
            for r, rank in measured:
                band_rows[f"band{rank}_{HW // n_tile}x{HW}"] = r["band_rows"]
            lines[name]["bands"] = {
                f"band{rank}": {k: {f: r["band_rows"][k][f] for f in (
                    "ms", "ms_unsplit", "plain_ms", "bound_ms", "bound_by") if f in
                    r["band_rows"][k]} for k in ("rasterize_fwd", "rasterize_bwd",
                                                  "segment_sum")}
                for r, rank in measured}
        print(f"sharded {name} ({smi}): {SHARDED_STEPS} steps from the train state on 2 ranks "
              f"of {dev} (gloo): step ms per rank {lines[name]['ms_per_step']}; losses "
              f"{ranks[0]['losses']} against one process's {ref['losses']}; grads max abs err "
              f"{grad_err:.2e}, params {err_first:.2e} after one step, {err_last:.2e} after "
              f"{SHARDED_STEPS}; denom exact; accum after {SHARDED_STEPS} steps {accum_last}"
              + (f"; bands {lines[name]['bands']}" if n_tile > 1 else ""), flush=True)
    launches["1x1_trainer_queued"] = sync_free["launches"]
    p = sync_free["profile"]
    print(f"sharded 1x1 ({smi}): a queued segment of {MESH_SYNC_ITERS} mesh steps under the "
          f"sync debug mode \"error\" on one process, no host sync; a profiled call "
          f"{p['steady_ms_per_step']:.2f} ms a step, {p['launch_calls_per_step']:.0f} kernel "
          f"launches, {p['syncs_per_step']:.2f} syncs a step (the call's log read and the "
          f"synchronizes that end it), idle "
          f"share {p['idle_share']:.3f}; budgets {sync_free['budgets']}", flush=True)
    shutil.rmtree(outdir, ignore_errors=True)
    emit({"phase": "sharded", "nvidia_smi": smi, "hw": HW, "capacity": CAPACITY,
          "backend": "gloo", "ranks_on_one_device": 2, "gloo_cuda_all_reduce": all(
              r["gloo_cuda_all_reduce"] for r in reports), "steps": SHARDED_STEPS, **lines,
          "trainer_schedule": MESH_TRAINER, "trainer_evals": MESH_EVALS,
          "sync_free_1x1": sync_free,
          "nccl": "not run: NCCL takes one rank a device, and this card is one device"})
    return launches, band_rows


def mesh_trainer_line(name, ranks, smi):
    """Gate and print the mesh trainer's runs of one mesh on the two ranks
    (mesh_trainer_runs): queued and eager bitwise equal on each rank, one
    state digest on both, every kernel of the step launched, once a step
    and eval frame for the blend kernels. Returns the phase line's part."""
    iters = MESH_TRAINER["iterations"]
    want = {"rasterize_fwd": iters + len(MESH_EVALS), "rasterize_bwd": iters,
            "segment_sum": iters}
    digests = {r["state_digest"] for r in ranks}
    if not all(r["bitwise"] for r in ranks) or len(digests) != 1:
        raise AssertionError(f"sharded {name} trainer: queued and eager not bitwise equal "
                             f"({[r['bitwise'] for r in ranks]}) or the ranks differ {digests}")
    for engine in MESH_ENGINES:
        got = [r[engine]["launches"] for r in ranks]
        if any(blend(n) != want or n["svd3"] < 1 for n in got):
            raise AssertionError(f"sharded {name} trainer {engine}: launches {got}, not {want}")
        if any(r[engine]["rounds"] != 1 for r in ranks) or any(
                m["raster_overflow"] for r in ranks for m in r[engine]["evals"]):
            raise AssertionError(f"sharded {name} trainer {engine}: rounds or eval overflow "
                                 f"{[(r[engine]['rounds'], r[engine]['evals']) for r in ranks]}")
    line = {"bitwise_queued_eager": True, "state_digest": digests.pop(),
            "budgets": [r["queued"]["budgets"] for r in ranks]}
    for engine in MESH_ENGINES:
        rows = [r[engine] for r in ranks]
        line[engine] = {
            "ms_per_iteration": [x["ms_per_iteration"] for x in rows],
            "host_work_ms": [x["host_work_ms"] for x in rows],
            "launches_per_rank": [x["launches"] for x in rows], "evals": rows[0]["evals"]}
        print(f"sharded {name} trainer {engine} ({smi}): {iters} iterations, one round, an eval; "
              f"ms per iteration outside host work a rank "
              f"{[round(x['ms_per_iteration'], 2) for x in rows]}", flush=True)
    prof = [r["queued"]["profile"] for r in ranks]
    line["queued"]["profile"] = [{k: x[k] for k in (
        "steady_ms_per_step", "launch_calls_per_step", "syncs_per_step", "memcpy_calls_per_step",
        "device_busy_ms", "idle_share", "kernels_traced_per_step", "top_device_ms_per_step")}
        for x in prof]
    print(f"sharded {name} trainer queued, a profiled {MESH_PROFILE_STEPS}-step call ({smi}): "
          f"{[round(x['steady_ms_per_step'], 2) for x in prof]} ms a step, "
          f"{[round(x['launch_calls_per_step']) for x in prof]} kernel launches and "
          f"{[round(x['syncs_per_step'], 2) for x in prof]} syncs a step, idle "
          f"{[round(x['idle_share'], 3) for x in prof]}", flush=True)
    b = line["budgets"][0]
    print(f"sharded {name} trainer ({smi}): queued and eager bitwise equal on both ranks; band "
          f"budgets pair_budget {b['pair_budget']}, rect cap {b['max_tiles']}, NPb {b['npb']}; "
          f"eval budgets {b['eval']}", flush=True)
    return line


def phase_tool_sort(dev):
    """The tool, which holds both passes at every stride of its 2^19-key
    network to their plain versions and times each at R and 4R (gated 4R >
    1.5 R at every stride), and the SASS of both kernels."""
    R = sort_pass.R
    x = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1 << 30, (sort_pass.ROWS, sort_pass.LANES), np.int32), device=dev)
    plain = {"lane": cuda_ms(lambda: sort_pass.lane_pass_plain(x, 64, R), n=5, reps=2,
                             site="sort_lane_pass plain"),
             "row": cuda_ms(lambda: sort_pass.row_pass_plain(x, 64, R), n=5, reps=2,
                            site="sort_row_pass plain")}

    sort_pass.lane_launches = sort_pass.row_launches = 0
    res = sort_micro.main(dev)
    launches = {"lane": sort_pass.lane_launches, "row": sort_pass.row_launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"the sort tool launched the pass kernels {launches} times")
    # a compare-exchange is idempotent: if the compiler had folded the
    # repeats, four times R would take about the time of R
    vs_r = {**{f"lane_s{s}": t for s, t in res["lane_ms_by_stride"].items()},
            **{f"row_S{s}": t for s, t in res["row_ms_by_stride"].items()}}
    for name, t in vs_r.items():
        if t[4 * R] < 1.5 * t[R]:
            raise AssertionError(f"{name}: {t} ms at R and 4R; the repeats were folded")
    # one launch = R passes over the block: read once, written once, one
    # int32 min or max per element and pass
    t_bytes = 2 * x.numel() * 4 / PEAK_BYTES
    t_ops = R * x.numel() / PEAK_INT32
    bound = {"bound_ms": 1e3 * max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes > t_ops else "operations",
             "issue_floor_ms": res["issue_floor_ms"]}
    # the library cell: torch.sort of the block's 2^19 keys, a whole sort and not a pass
    rows = {k: {"ms": res[f"{k}_pass_ms"] * R, "plain_ms": plain[k], "max_abs_err": 0.0,
                "library_ms": res["torch_sort_ms"][x.numel()], **bound} for k in ("lane", "row")}
    # static instructions (cuobjdump -sass) of the lane pass at each stride and of the row pass
    sass = {**cuda_build.sass_opcodes("sort_pass", "lane_pass_kernel"),
            **cuda_build.sass_opcodes("sort_pass", "row_pass_kernel")}
    for kernel, ops in sass.items():
        print(f"sass sort_pass: {kernel}: " + ", ".join(f"{k} {v}" for k, v in
                                                        list(ops.items())[:12]), flush=True)
    emit({"phase": "tool_sort", "keys": x.numel(), "reps": R, "ms_vs_reps": vs_r,
          "launches": launches, "plain_ms_per_launch": plain,
          **{k: v for k, v in res.items() if k != "torch_sort_ms"},
          "torch_sort_ms": {str(k): v for k, v in res["torch_sort_ms"].items()}, **bound,
          "sass": sass})
    return rows, launches


def phase_tool_conv(dev):
    """The two conv kernels against their plain version (f32 at the tool's
    check() shapes and the eight VGG16 layers on the CUDA cores, bf16 at the
    layers and ragged shapes on the tensor cores), each shape on its route,
    the tensor-core kernel bitwise repeatable; then the tool, counted.
    Returns ({kernel: row}, {kernel: launches})."""
    f32_err, bf16_err, bf16_abs = 0.0, 0.0, 0.0
    vs_f64 = {"kernel": 0.0, "plain": 0.0}  # both f32 versions against an f64 conv

    def routed(fn, tensor_cores):
        """fn() after checking that it launched the kernel of its route once."""
        before = (conv.launches, conv.tc_launches)
        y = fn()
        after = (conv.launches, conv.tc_launches)
        if after != (before[0] + (not tensor_cores), before[1] + tensor_cores):
            raise AssertionError(f"conv3x3 took the wrong route: launches {before} -> {after}")
        return y

    def check_f32(x, w, b, relu=True):
        """The CUDA-core kernel in f32 against its plain version and an f64
        conv; a second call bitwise the first."""
        y = routed(lambda: conv.conv3x3(x, w, b, relu=relu), False)
        ref = conv.conv3x3_plain(x, w, b, relu=relu)
        exact = torch.nn.functional.conv2d(
            x.double().permute(2, 0, 1)[None], w.double().permute(3, 2, 0, 1), padding=1)[0] \
            .permute(1, 2, 0) + b.double()
        exact = torch.relu(exact) if relu else exact
        for k, v in (("kernel", y), ("plain", ref)):
            vs_f64[k] = max(vs_f64[k], float((v.double() - exact).abs().max()))
        repeat[f"f32 {tuple(x.shape)}->{w.shape[3]}"] = torch.equal(
            y, conv.conv3x3(x, w, b, relu=relu))
        return float((y - ref).abs().max())

    def check_bf16(x, w, b, relu=True, tensor_cores=True):
        nonlocal bf16_err, bf16_abs
        y = routed(lambda: conv.conv3x3(x, w, b, relu=relu), tensor_cores)
        ref = conv.conv3x3_plain(x, w, b, relu=relu)
        bf16_err = max(bf16_err, conv_proto.scaled_err(y, ref))
        bf16_abs = max(bf16_abs, float((y.float() - ref.float()).abs().max()))
        return y

    def check_stages_conv(x, w, b, y):
        """Every stage of the tensor-core kernel equal to its plain version
        (full: bitwise to the production call's y, relu off)."""
        out = {s: conv.conv3x3_tc_stage(x, w, b, s, relu=False) for s in conv.STAGES}
        return torch.equal(out.pop("full"), y) and all(
            torch.equal(v, conv.conv3x3_stage_plain(x, w, b, s, relu=False))
            for s, v in out.items())

    repeat, stages_exact = {}, {}
    for _, x, w, b in conv_proto.check_inputs(dev):
        f32_err = max(f32_err, check_f32(x, w, b))
    for layer, x, w, b in conv_proto.layer_inputs(dev):
        f32_err = max(f32_err, check_f32(x, w, b))
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        for relu in (True, False):
            y = check_bf16(xb, wb, b, relu)
        repeat[str(layer)] = torch.equal(y, conv.conv3x3(xb, wb, b, relu=False))
    # ragged shapes: Cin not a multiple of 64, Cout not one of the tile's
    # channels, H and W not multiples of the tile; Cin 5 takes the CUDA cores.
    # The stages there, with a bias that is not zero
    rng = np.random.default_rng(2)
    for H, W, cin, cout in ((13, 29, 5, 70), (13, 29, 48, 72)):
        x, w, b = (torch.as_tensor(a.astype(np.float32), device=dev)
                   for a in (rng.normal(size=(H, W, cin)), rng.normal(0, 0.1, (3, 3, cin, cout)),
                             rng.normal(0, 0.1, cout)))
        f32_err = max(f32_err, check_f32(x, w, b, relu=False))
        x, w, b = x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)
        y = check_bf16(x, w, b, False, tensor_cores=cin % 8 == 0)
        repeat[str((H, W, cin, cout))] = torch.equal(y, conv.conv3x3(x, w, b, relu=False))
        if cin % 8 == 0:
            stages_exact[str((H, W, cin, cout))] = check_stages_conv(x, w, b, y)
    # an x that does not start on 16 bytes is copied to one that does
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape).copy_(x)
    repeat["unaligned"] = torch.equal(routed(lambda: conv.conv3x3(xs, w, b, relu=False), True),
                                      conv.conv3x3(x, w, b, relu=False))
    if f32_err > conv_proto.F32_ATOL or bf16_err > conv_proto.BF16_RTOL:
        raise AssertionError(f"conv3x3 vs plain: f32 max abs err {f32_err}, bf16 {bf16_err}")
    if not all(repeat.values()):
        raise AssertionError(f"conv3x3: two calls on the same input differ: {repeat}")
    if not all(stages_exact.values()):
        raise AssertionError(f"conv3x3 stages differ from their plain version: {stages_exact}")

    conv.launches = conv.tc_launches = conv.stage_launches = 0
    res = conv_proto.main(dev)
    launches = {"conv3x3": conv.tc_launches, "conv3x3_f32": conv.launches,
                "conv3x3_stages": conv.stage_launches}
    if min(launches.values()) == 0:
        raise AssertionError(f"the conv tool launched the conv kernels {launches} times")

    def summed(rows, flops_peak, err):
        t_ops = sum(r["flops"] for r in rows) / flops_peak
        t_bytes = sum(r["bytes"] for r in rows) / PEAK_BYTES
        return {**{k: sum(r[k] for r in rows) for k in ("ms", "plain_ms", "library_ms",
                                                           "bound_ms")},
                "bound_by": "operations" if t_ops >= t_bytes else "bytes", "max_abs_err": err}

    def by_shape(rows):
        return {"x".join(map(str, r["shape"])): {k: r[k] for k in (
            "ms", "library_ms", "bound_ms", "max_abs_err", "bitwise_repeat")} | {
            "tile": {k: r["tile"][k] for k in ("code", "rows", "channels", "split", "ctas")}}
            for r in rows}

    f32_layers = summed(res["f32_layers"], PEAK_F32,
                        max(r["max_abs_err"] for r in res["f32_layers"]))
    kernels = {"conv3x3": {**summed(res["layers"], PEAK_BF16, bf16_abs),
                           "stage_ms": {s: sum(r["stage_ms"][s] for r in res["layers"])
                                        for s in conv.STAGES}},
               "conv3x3_f32": {**summed(res["checks"], PEAK_F32,
                                        max(r["max_abs_err"] for r in res["checks"])),
                               "by_shape": by_shape(res["checks"]),
                               "f32_layers": f32_layers,
                               "f32_layers_by_shape": by_shape(res["f32_layers"])}}
    emit({"phase": "tool_conv", "f32_max_abs_err": f32_err, "f32_max_abs_err_vs_f64": vs_f64,
          "bf16_scaled_err": bf16_err, "bf16_max_abs_err": bf16_abs, "bitwise_repeat": repeat,
          "stages_exact": stages_exact, "launches": launches, "tiles": res["tiles"],
          "f32_tiles": conv.f32_tiles(dev), "checks": res["checks"],
          "f32_layers": res["f32_layers"], "sum_over_f32_layers": f32_layers,
          "layers": res["layers"], "sum_over_layers": kernels["conv3x3"],
          "sum_over_checks": kernels["conv3x3_f32"]})
    return kernels, launches


def check_stages(proj, height, width):
    """Every stage of the backward kernel against its plain version
    (ops/bwd_stages.py): (pairs, gimg, errors)."""
    pairs, gimg, state = bwd_kernel_floor.floor_inputs(proj, height, width)
    errs = {}
    for stage in bwd_stages.STAGES:
        rows, obs = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, height, width, stage, state)
        rows_p, obs_p = bwd_stages.bwd_stage_plain(pairs, proj, gimg, height, width, stage)
        if stage in bwd_stages.ABLATED:
            if not torch.equal(rows, rows_p):
                raise AssertionError(f"stage {stage}: staged rows differ from the plain version")
            scale = float(obs_p.abs().max())
            n_out, allowed, mx = mismatch(obs / scale, obs_p / scale, OBSERVE_RTOL)
            if n_out > allowed or not torch.isfinite(obs).all():
                raise AssertionError(f"stage {stage}: observer off its plain version on {n_out} "
                                     f"pixels (allowed {allowed:.0f}), max {mx:.2e} of the max")
            errs[stage] = mx
        else:
            errs[stage] = scaled_err(rows, rows_p)
            errs[f"{stage}_max_abs"] = float((rows - rows_p).abs().max())
            if errs[stage] > GRAD_ATOL:
                raise AssertionError(f"stage {stage}: rows off the plain version by "
                                     f"{errs[stage]:.2e} of the max")
    return pairs, gimg, errs


def measure_stages(proj, height, width, drive=None):
    """The backward kernel's stages on one projected cloud: each held to its
    plain version; then drive(), by default the tool's measure() on proj,
    which holds full and full_soa bitwise to the production kernel and times
    every stage; beside it the plain versions' times and the bounds."""
    pairs, gimg, errs = check_stages(proj, height, width)
    res = drive() if drive else bwd_kernel_floor.measure(proj, height, width)
    work = blend_work(proj, pairs, height, width)
    plain_ms = {s: cuda_ms(lambda s=s: bwd_stages.bwd_stage_plain(pairs, proj, gimg, height,
                                                                     width, s),
                           n=3, reps=1, warmup=1, site="rasterize_bwd_stages plain")
                for s in bwd_stages.STAGES}
    bounds = {s: {k: v for k, v in bwd_bound(proj, pairs, height, width, s, work).items()
                  if k.startswith("bound")} for s in bwd_stages.STAGES}
    return {**res, "scaled_err_vs_plain": errs, "plain_ms": plain_ms, "bounds": bounds,
            "evaluations": work[0], "contributions": work[1]}


def phase_tool_bwd_floor(dev, H=HW, P=CAPACITY):
    """The stages on bench's scene through the tool's main(), counted."""
    proj, _ = bench_scene(dev, H=H, P=P)
    counted = {}

    def drive():
        bwd_stages.launches = 0
        res = bwd_kernel_floor.main(dev, H=H, P=P)
        counted["launches"] = bwd_stages.launches
        if counted["launches"] < len(bwd_stages.STAGES):
            raise AssertionError(f"the stage tool launched the stages {counted} times")
        return res

    row = measure_stages(proj, H, H, drive)
    bounds = row["bounds"].values()
    bound_ms = sum(b["bound_ms"] for b in bounds)
    by_bytes = sum(b["bound_ms"] for b in bounds if b["bound_by"] == "bytes")
    total = {"ms": sum(row["stage_ms"].values()), "plain_ms": sum(row["plain_ms"].values()),
             "bound_ms": bound_ms, "bound_by": "bytes" if by_bytes > bound_ms / 2 else "operations",
             "max_abs_err": max(row["scaled_err_vs_plain"][f"{s}_max_abs"]
                                for s in ("full", "full_soa"))}
    emit({"phase": "tool_bwd_floor", "scene": "bench", "hw": H, "gaussians": P,
          "launches": counted["launches"], **row, "sum_over_stages": total})
    return total, counted["launches"]


# the four kernels of csrc/reduce_scan.cu: (kernels-line name, launch-count
# key, the runs of rs.RUNS it carries, the TPU kernels it replaces)
MXU_KERNELS = (
    ("mxu_moments", "moments", ("moments",), "tools/mxu_micro.py:58",
     "kern_moments_vpu :58, kern_moments_mxu :81"),
    ("mxu_reshape", "reshape", ("reshape",), "tools/mxu_micro.py:94", "kern_reshape_only :94"),
    ("mxu_acc", "acc", ("acc",), "tools/mxu_micro.py:102", "kern_acc_vpu :102, kern_acc_mxu :116"),
    ("mxu_scan", "scan", ("cumsum", "cumprod"), "tools/mxu_micro.py:153",
     "kern_cumsum_vpu :153, kern_cumsum_mxu :175, kern_cumprod_vpu :192, "
     "kern_cumprod_logmxu :203"),
)


def phase_tool_mxu(dev):
    """The twelve reduction and scan runs: their observers across tiles and a
    launch's time against REPS; the card test of the CUDA-core moments,
    accumulators, cumsum and cumprod, the two tensor-core cumsums, the
    log-space cumprod, the two 3xTF32 forms, the bf16 moments and
    accumulators and the reshape three times over (the CUDA-core cumsum and
    cumprod, the bf16 forms and the reshape also at REPS / 3 and 4 REPS); the
    moments against an f64 sum
    (the f32-class forms gated at 1e-6, bf16 reported); the tensor-core
    layout tables and tc_rate; then the tool, counted, which holds each run
    to its plain version (raising past mxu_micro.RTOL) and times it, with
    the SFU bound and the stages of the cumsum, cumprod, 3xTF32, bf16 and
    CUDA-core kernels; the CUDA-core kernels' and the bf16 forms' registers
    and CTAs an SM. Returns
    ({kernel: row summed over its runs}, {kernel: launches}, {stage family:
    launches})."""
    x, s = mxu_micro.inputs(dev)
    checks = {}
    for name, *_ in rs.RUNS:
        _, obs = rs.run(name, x, s)
        if not torch.equal(obs, obs[:1].expand_as(obs)):
            raise AssertionError(f"{name}: the tiles' observers differ")
        # had the compiler folded the repeats, 4 REPS would take about REPS's time
        vs_reps = {r: cuda_ms(lambda r=r: rs.run(name, x, s, reps=r), site=f"mxu {name}")
                   for r in (rs.REPS, 4 * rs.REPS)}
        if vs_reps[4 * rs.REPS] <= 1.5 * vs_reps[rs.REPS]:
            raise AssertionError(f"{name}: {vs_reps} ms at REPS and 4 REPS; the repeats were "
                                 "folded")
        checks[name] = {"observers_equal": True, "observer_shape": list(obs.shape),
                        "ms_vs_reps": vs_reps}
    # the card test's cases tests/test_torch_cuda.py::test_reduce_scan_matches_plain
    # [moments_cuda-*, acc_cuda-*, cumsum_bf16-*, cumsum_split2-*, cumprod_logsplit2-*,
    # moments_tf32x3-*, acc_tf32x3-*, cumprod_cuda-*, moments_bf16-*, cumsum_cuda-*,
    # acc_bf16-*, reshape_only-*], three times over, the last five also at the reps of
    # test_redesigned_kernels_at_more_reps: kernel within RTOL of plain, observers equal
    redesigned = ("cumprod_cuda", "moments_bf16", "cumsum_cuda", "acc_bf16", "reshape_only")
    for name in ("moments_cuda", "acc_cuda", "cumsum_bf16", "cumsum_split2",
                 "cumprod_logsplit2", "moments_tf32x3", "acc_tf32x3", *redesigned):
        repeats = []
        more = (rs.REPS // 3, 4 * rs.REPS) if name in redesigned else ()
        for _ in range(3):
            for reps in (rs.REPS, 3, *more):
                out, obs = rs.run(name, x, s, reps=reps)
                err = mxu_micro.scaled_err(out, rs.run_plain(name, x, s, reps=reps))
                if not (err <= mxu_micro.RTOL and torch.equal(obs, obs[:1].expand_as(obs))):
                    raise AssertionError(f"{name} at reps {reps}: {err:.2e} of the max, or the "
                                         "tiles' observers differ")
                repeats.append({"reps": reps, "scaled_err": err})
        checks[name]["repeated_card_test"] = repeats
    # the moments against an f64 sum at REPS (the JAX tool's numeric line), on the
    # columns all compute: the f32-class forms within 1e-6 of the max, bf16 (its
    # operands rounded to 8 bits) reported only
    ref = sum((x.double().reshape(rs.K, rs.PIX) + i) @ rs.basis(dev).double()
              for i in range(rs.REPS))
    for name in ("moments_cuda", "moments_tf32x3", "moments_bf16"):
        f64_err = mxu_micro.scaled_err(rs.run(name, x, s)[0].double()[:, :6], ref[:, :6])
        if name != "moments_bf16" and not f64_err < 1e-6:
            raise AssertionError(f"{name}: {f64_err:.2e} of the max from the f64 sum")
        checks[name]["err_of_max_vs_f64"] = f64_err
    print(f"moments_bf16: {checks['moments_bf16']['err_of_max_vs_f64']:.3e} of the max from the "
          "f64 sum (not gated)", flush=True)
    for family in ("moments", "acc"):
        if not torch.equal(rs.tf32x3_order(family), rs.tf32x3_order_plain(family)):
            raise AssertionError(f"the 3xTF32 {family} kernel's layout table differs from "
                                 "ops/reduce_scan.py's copy")
    if not torch.equal(rs.bf16_order(), rs.bf16_order_plain()):
        raise AssertionError("the bf16 moments kernel's layout table differs from "
                             "ops/reduce_scan.py's copy")
    rates = tc_rate.main(dev)

    rs.reset_launch_counts()
    res = mxu_micro.main(dev)
    launches = rs.launch_counts()
    forms = dict(rs.form_launches)
    stage_launches = {"scan": rs.stage_launches, "cumsum": rs.cumsum_stage_launches,
                      "tf32x3": rs.tf32x3_stage_launches, "cuda": rs.cuda_stage_launches,
                      "bf16": rs.bf16_stage_launches}
    if rs.stage_launches < len(rs.SCAN_STAGES):
        raise AssertionError(f"the mxu tool launched the scan stages {rs.stage_launches} times")
    if rs.cumsum_stage_launches < len(rs.CUMSUM_MODES) * len(rs.CUMSUM_STAGES):
        raise AssertionError("the mxu tool launched the cumsum stages "
                             f"{rs.cumsum_stage_launches} times")
    if rs.tf32x3_stage_launches < 2 * len(rs.TF32X3_STAGES):
        raise AssertionError("the mxu tool launched the 3xTF32 stages "
                             f"{rs.tf32x3_stage_launches} times")
    if rs.cuda_stage_launches < len(rs.CUDA_FAMILIES) * len(rs.CUDA_STAGES):
        raise AssertionError("the mxu tool launched the CUDA-core stages "
                             f"{rs.cuda_stage_launches} times")
    if rs.bf16_stage_launches < len(rs.BF16_FAMILIES) * len(rs.BF16_STAGES):
        raise AssertionError(f"the mxu tool launched the bf16 stages {rs.bf16_stage_launches} "
                             "times")
    if min(launches.values()) == 0:
        raise AssertionError(f"the mxu tool launched the kernels {launches} times")
    rows = res["runs"]
    kernels = {}
    for kname, key, families, _, _ in MXU_KERNELS:
        names = [n for n, fam, *_ in rs.RUNS if fam in families]
        by_ops = sum(rows[n]["bound_ms"] for n in names if rows[n]["bound_by"] == "operations")
        bound_ms = sum(rows[n]["bound_ms"] for n in names)
        kernels[kname] = {
            # each timed over a launch's TILES x REPS chunk-ops
            **{k: sum(rows[n][k] for n in names) for k in ("ms", "plain_ms", "library_ms")},
            "bound_ms": bound_ms, "bound_by": "operations" if by_ops >= bound_ms / 2 else "bytes",
            "max_abs_err": max(rows[n]["max_abs_err"] for n in names),
            "variants": {n: {"launches": forms.get(n, 0),
                             **{k: rows[n][k] for k in ("ms", "ns_per_chunk_op", "bound_ms",
                                                        "bound_by", "plain_ms", "library_ms",
                                                        "max_abs_err", "sfu_bound_ms",
                                                        "issue_floor_ms")
                                if k in rows[n]}}
                         for n in names}}
    kernels["mxu_scan"]["cumprod_stage_ms"] = {k: v["ms"] for k, v in res["scan_stages"].items()}
    kernels["mxu_scan"]["cumsum_stage_ms"] = {
        mode: {k: v["ms"] for k, v in rows.items()} for mode, rows in res["cumsum_stages"].items()}
    for kname, family in (("mxu_moments", "moments"), ("mxu_acc", "acc")):
        kernels[kname]["tf32x3_stage_ms"] = {
            k: v["ms"] for k, v in res["tf32x3_stages"][family].items()}
    for kname, family, key in (("mxu_moments", "moments", "cuda_stage_ms"),
                               ("mxu_acc", "acc", "cuda_stage_ms"),
                               ("mxu_scan", "cumprod", "cuda_stage_ms"),
                               ("mxu_scan", "cumsum", "cumsum_cuda_stage_ms"),
                               ("mxu_reshape", "reshape", "cuda_stage_ms")):
        kernels[kname][key] = {k: v["ms"] for k, v in res["cuda_stages"][family].items()}
    for kname, family in (("mxu_moments", "moments"), ("mxu_acc", "acc")):
        kernels[kname]["bf16_stage_ms"] = {
            k: v["ms"] for k, v in res["bf16_stages"][family].items()}
    # static instructions (cuobjdump -sass): the tensor-core scans (a rep's
    # body of 32 elements a thread, the cumprod's stages beside it) and the
    # contractions (the 3xTF32 and CUDA-core kernels' stages beside them)
    sass = {}
    for prefix in ("scan_tc_kernel", "moments_tf32x3_kernel", "acc_tf32x3_kernel",
                   "moments_bf16_kernel", "acc_bf16_kernel", "moments_cuda_kernel",
                   "acc_cuda_kernel", "cumsum_cuda_kernel", "cumprod_cuda_kernel",
                   "reshape_kernel"):
        sass.update(cuda_build.sass_opcodes("reduce_scan", prefix))
    for kernel, ops in sass.items():
        print(f"sass reduce_scan: {kernel}: " + ", ".join(f"{k} {v}" for k, v in
                                                          list(ops.items())[:12]), flush=True)
    # the CUDA-core kernels' and the bf16 forms' registers (ptxas, the
    # production form, stage 0) and CTAs an SM (occupancy query)
    regs = {k["kernel"]: k["registers"] for k in cuda_build.ptxas_report("reduce_scan")}
    ctas = {}
    for name in rs.CTAS_KERNELS:
        full = [k for k in regs if k.startswith(f"{name}_kernel ") and "ILi0E" in k]
        ctas[name] = {"registers": regs[full[0]] if full else None,
                      "ctas_per_sm": rs.ctas_per_sm(name)}
        print(f"{name}: {ctas[name]['registers']} registers, {ctas[name]['ctas_per_sm']} CTAs "
              "an SM", flush=True)
    emit({"phase": "tool_mxu", "reps": rs.REPS, "tiles": rs.TILES, "checks": checks,
          "launches": launches, "form_launches": forms, "stage_launches": stage_launches,
          "tc_rate": rates, **res, "sass": sass, "ctas": ctas})
    return kernels, {k[0]: launches[k[1]] for k in MXU_KERNELS}, stage_launches


# ---- the users' drivers, from disk ----------------------------------------------

DRIVERS_DIR = os.path.join(BUILD, "drivers")
DRIVER_RAW = 1024      # ZJU-MoCap's published frame; the reader scales it by 0.5 to 512
DRIVER_ZJU_FRAMES = 60  # -> 12 train frames (view 4, stride 5), 8 test (2 poses x 4 views)
DRIVER_ITERS = 60
DRIVER_CHECKS = (30, 60)
DRIVER_NOVEL_VIEWS = 4
DRIVER_MONOCAP_SEQ = "olek_images0812"  # soft masks, multiplied in (readers.read_monocap)
DRIVER_MONOCAP_ITERS = 40
DRIVER_REFERENCE_ITERS = 1  # the first step's losses are what it checks
DRIVER_LOSS_RTOL = 1e-4
DRIVER_PSNR_ATOL = 1e-3
DRIVER_ENGINE_HW = 128   # the plain blend under the engines, at a small size
DRIVER_KERNELS = ("rasterize_fwd", "rasterize_bwd", "segment_sum", "svd3")


def smooth_image(rng, H, W):
    """A seeded uint8 RGB frame: a coarse random field resized up, with noise."""
    coarse = (rng.random((12, 12, 3)) * 200 + 20).astype(np.float32)
    img = readers.cv2.resize(coarse, (W, H), interpolation=readers.cv2.INTER_CUBIC)
    return np.clip(img, 0, 239).astype(np.uint8) + rng.integers(0, 16, (H, W, 3), dtype=np.uint8)


def body_mask(xyz, K, RT, H, W, soft=False):
    """255 inside the convex hull of the body's projected vertices; with
    soft, 128 on a band along its edge (MonoCap's soft masks)."""
    cv2 = readers.cv2
    uv = np.round(readers.project_points_np(xyz, K, RT)).astype(np.int32)
    hull = cv2.convexHull(uv)
    mask = np.zeros((H, W), np.uint8)
    cv2.fillConvexPoly(mask, hull, 255)
    if soft:
        inner = cv2.erode(mask, np.ones((9, 9), np.uint8))
        mask = np.where((mask > 0) & (inner == 0), 128, mask).astype(np.uint8)
    return mask


class FrameFiles:
    """The frame files a dataset writer writes, on a pool of host threads
    (cv2 and numpy release the interpreter lock), each made by a function of
    its own and read back through readers.imread at once: the PNGs against
    the array encoded, the JPEGs against what cv2 decodes from the same
    bytes. wait() raises the first failure and counts the files."""

    def __init__(self, workers=8):
        self.n_png = self.n_jpg = 0
        self._pool = concurrent.futures.ThreadPoolExecutor(workers)
        self._jobs = []

    def jpeg(self, path, make):
        self._jobs.append(self._pool.submit(self._jpeg, path, make))

    def png(self, path, make):
        self._jobs.append(self._pool.submit(self._png, path, make))

    @staticmethod
    def _jpeg(path, make):
        cv2, rgb = readers.cv2, make()
        if not cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1])):
            raise AssertionError(f"cv2 did not write {path}")
        with open(path, "rb") as f:
            raw = cv2.imdecode(np.frombuffer(f.read(), np.uint8), cv2.IMREAD_UNCHANGED)
        back = readers.imread(path)
        if back.shape != rgb.shape or not np.array_equal(back, raw[..., ::-1]):
            raise AssertionError(f"{path}: readers.imread is not cv2's decode of the bytes")
        return "jpg"

    @staticmethod
    def _png(path, make):
        img = make()
        readers.imwrite(path, img)
        back = readers.imread(path)
        if back.dtype != img.dtype or not np.array_equal(back, img):
            raise AssertionError(f"{path}: readers.imread does not give back the array")
        return "png"

    def wait(self):
        try:
            kinds = [j.result() for j in self._jobs]
        finally:
            self._pool.shutdown(cancel_futures=True)
        self.n_jpg, self.n_png = kinds.count("jpg"), kinds.count("png")


def posed_body(model, params):
    """The synthetic rig's vertices at a frame's SMPL params, in the world."""
    v, _ = S.lbs_vertices(model, torch.as_tensor(params["poses"].reshape(72)),
                          torch.as_tensor(params["shapes"].reshape(-1)))
    R = readers.rodrigues_np(params["Rh"])
    return v.numpy() @ R.T + params["Th"].reshape(1, 3)


def smpl_param_draw(rng):
    return {"poses": rng.normal(0, 0.1, (1, 72)).astype(np.float32),
            "shapes": rng.normal(0, 0.5, (1, 10)).astype(np.float32),
            "Rh": rng.normal(0, 0.1, (1, 3)).astype(np.float32),
            "Th": rng.normal(0, 0.05, (1, 3)).astype(np.float32)}


def write_zju_capture(root, files, n_frames, raw, n_views=6, seed=0):
    """A ZJU-MoCap-Refine subject in tests/test_readers.py::_write_zju_fixture's
    layout at the published frame: raw x raw JPEGs and PNG masks of the frames
    the reader's two splits take, annots.npy with n_views cameras 2 m from
    the body, smpl_params/ and 6,890-vertex smpl_vertices/ of the synthetic
    rig posed per frame; images from a seed (one stream a file), masks the
    posed body's hull. The files are written on files' pool."""
    rng = np.random.default_rng(seed)
    model = S.synthetic_smpl(device="cpu")
    f0 = 0.9 * raw
    cams = {"K": [np.array([[f0 * (1 + 0.01 * i), 0, raw / 2], [0, f0 * (1 + 0.01 * i), raw / 2],
                            [0, 0, 1.0]]) for i in range(n_views)],
            "D": [np.zeros(5) for _ in range(n_views)],
            "R": [np.eye(3) for _ in range(n_views)],
            "T": [np.array([[0.0], [0.0], [2000.0]]) for _ in range(n_views)]}
    ims = [{"ims": [f"images/{v:02d}/{f:06d}.jpg" for v in range(n_views)]}
           for f in range(n_frames)]
    needed = {(4, f) for f in range(0, min(n_frames, 500), 5)}
    needed |= {(v, f) for f in range(0, min(n_frames, 510), 30) for v in range(n_views)
               if v not in (3, 4)}
    for d in ("smpl_vertices", "smpl_params"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    bodies = {}
    for v, f in sorted(needed, key=lambda x: (x[1], x[0])):
        if f not in bodies:
            params = smpl_param_draw(rng)
            bodies[f] = posed_body(model, params).astype(np.float32)
            np.save(os.path.join(root, "smpl_vertices", f"{f}.npy"), bodies[f])
            np.save(os.path.join(root, "smpl_params", f"{f}.npy"), params)
        for d in ("images", "mask"):
            os.makedirs(os.path.join(root, d, f"{v:02d}"), exist_ok=True)
        RT = np.concatenate([cams["R"][v], cams["T"][v] / 1000.0], axis=1)
        files.jpeg(os.path.join(root, "images", f"{v:02d}", f"{f:06d}.jpg"),
                   functools.partial(smooth_image, np.random.default_rng((seed, v, f)), raw, raw))
        files.png(os.path.join(root, "mask", f"{v:02d}", f"{f:06d}.png"),
                  functools.partial(body_mask, bodies[f], cams["K"][v], RT, raw, raw))
    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims})


def write_monocap_capture(root, files, hw, seed=1):
    """A MonoCap sequence in tests/test_torch_readers.py::write_monocap_fixture's
    layout (olek_images0812's views 44 and 45, poses from 1, soft masks) at
    hw x hw: the 100 train and 17 test frames, cameras 2.5 m from the body
    with a small distortion, params/ per pose; the synthetic rig posed as
    read_monocap poses it, images from a seed (one stream a file), masks its
    hull. The files are written on files' pool."""
    rng = np.random.default_rng(seed)
    model = S.synthetic_smpl(device="cpu")
    train_view, test_view, start = [44], [45], 1
    n_views = max(train_view + test_view) + 1
    f0 = 0.6 * hw
    cams = {"K": [np.array([[f0 * (1 + 0.01 * v), 0, hw / 2], [0, f0 * (1 + 0.01 * v), hw / 2],
                            [0, 0, 1.0]]) for v in range(n_views)],
            "D": [np.array([0.01, -0.01, 0.0, 0.0, 0.0]) for _ in range(n_views)],
            "R": [np.eye(3) for _ in range(n_views)],
            "T": [np.array([[0.05 * (v % 3)], [0.0], [2500.0]]) for v in range(n_views)]}
    needed = [(v, p) for v in train_view for p in range(start, start + 500, 5)]
    needed += [(v, p) for v in test_view for p in range(start, start + 510, 30)]
    os.makedirs(os.path.join(root, "params"), exist_ok=True)
    bodies = {}
    for v, p in needed:
        vz, pz = str(v).zfill(2), str(p).zfill(6)
        for d in ("images", "mask"):
            os.makedirs(os.path.join(root, d, vz), exist_ok=True)
        if p not in bodies:
            params = smpl_param_draw(rng)
            np.save(os.path.join(root, "params", f"{p}.npy"), params)
            bodies[p] = posed_body(model, params)
        RT = np.concatenate([cams["R"][v], cams["T"][v] / 1000.0], axis=1)
        files.jpeg(os.path.join(root, "images", vz, pz + ".jpg"),
                   functools.partial(smooth_image, np.random.default_rng((seed, v, p)), hw, hw))
        files.png(os.path.join(root, "mask", vz, pz + ".png"),
                  functools.partial(body_mask, bodies[p], cams["K"][v], RT, hw, hw, soft=True))
    np.save(os.path.join(root, "annots.npy"), {"cams": cams})


class DriverSpies:
    """What a driver call did, read from inside this process: every
    iteration's logs (the drivers' EMALogger sees each), the Trainers built,
    the host ms of Trainer.train and of the evals, saves and budget probes
    inside it (outermost calls only), and each served frame's render_frame
    call."""

    def __init__(self):
        self.logs, self.trainers, self.served = [], [], []
        self.ms = {"train": 0.0, "host_work": 0.0, "init": 0.0}
        self.work = []  # (method, ms, grow_from) of each clocked host-work call, in order
        self.first_init = None  # perf_counter at the first Trainer.__init__'s start
        self._depth, self._in_train = 0, False

    @contextlib.contextmanager
    def installed(self):
        from moss_torch.cli import render_zju, train_zju
        from moss_torch.train.trainer import Trainer

        spies = self
        HOST_WORK = ("evaluate", "densify", "_resize_pair_buffer", "save")
        patched = {(train_zju, "EMALogger"), (render_zju, "render_frame"),
                   (train_zju, "save_reference_layout"), (Trainer, "__init__"),
                   (Trainer, "train"), *((Trainer, k) for k in HOST_WORK)}
        orig = {(obj, k): getattr(obj, k) for obj, k in patched}

        class Logger(obs.EMALogger):
            def update(self, logs):
                spies.logs.append(dict(logs))
                return super().update(logs)

        def served(*a, **kw):
            out = orig[render_zju, "render_frame"](*a, **kw)
            if kw.get("cached_transforms") is not None:
                spies.served.append((a, kw, out))
            return out

        def host_work(fn):
            def go(*a, **kw):
                spies._depth += 1
                try:
                    if spies._depth > 1 or not spies._in_train:
                        return fn(*a, **kw)
                    out, ms = clocked_ms(lambda: fn(*a, **kw))
                    spies.ms["host_work"] += ms
                    spies.work.append((fn.__name__, ms, kw.get("grow_from", 0)))
                    return out
                finally:
                    spies._depth -= 1
            return go

        def init(tr, *a, **kw):
            if spies.first_init is None:
                spies.first_init = time.perf_counter()
            _, ms = clocked_ms(lambda: orig[Trainer, "__init__"](tr, *a, **kw))
            spies.ms["init"] += ms
            spies.trainers.append(tr)

        def train(tr, *a, **kw):
            spies._in_train = True
            try:
                out, ms = clocked_ms(lambda: orig[Trainer, "train"](tr, *a, **kw))
            finally:
                spies._in_train = False
            spies.ms["train"] += ms
            return out

        train_zju.EMALogger = Logger
        render_zju.render_frame = served
        train_zju.save_reference_layout = host_work(orig[train_zju, "save_reference_layout"])
        Trainer.__init__, Trainer.train = init, train
        for k in HOST_WORK:
            setattr(Trainer, k, host_work(orig[Trainer, k]))
        try:
            yield self
        finally:
            for (obj, k), v in orig.items():
                setattr(obj, k, v)


@contextlib.contextmanager
def segments_sync_error():
    """Every Trainer built inside runs its segments under torch.cuda's sync
    debug mode "error" (Trainer.segment_sync_mode)."""
    init = Trainer.__init__

    def go(tr, *a, **kw):
        init(tr, *a, **kw)
        tr.segment_sync_mode = "error"

    Trainer.__init__ = go
    try:
        yield
    finally:
        Trainer.__init__ = init


def driver_call(name, main, argv, results, launch_gate, watch=contextlib.nullcontext):
    """main(argv) in this process under DriverSpies (and the context manager
    watch() inside them), every Trainer it builds running its segments under
    the sync debug mode "error" (segments_sync_error), its kernels counted
    (the counts set to 0 just before and read just after) and held to
    launch_gate ({kernel: True} must launch, False must not); its line."""
    gc.collect()
    torch.cuda.empty_cache()
    spies = DriverSpies()
    zero_launch_counts()
    t0 = time.perf_counter()
    with spies.installed(), watch(), segments_sync_error():
        out = main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    for k, must in launch_gate.items():
        if (launches[k] > 0) != must:
            raise AssertionError(f"drivers {name}: {k} launched {launches[k]} times, expected "
                                 f"{'some' if must else 'none'}")
    line = {"call": name, "argv": " ".join(argv), "wall_s": wall, "launches": launches}
    if spies.first_init is not None:  # the reads and decodes before the first Trainer
        line["read_s"] = spies.first_init - t0
    msg = f"drivers {name}: {wall:.1f} s, launches {launches}"
    if spies.logs:  # a training driver
        n = len(spies.logs)
        line.update(iterations=n, host_work_ms=spies.ms["host_work"],
                    ms_per_iteration=(spies.ms["train"] - spies.ms["host_work"]) / n)
        msg += f", {line['ms_per_iteration']:.2f} ms an iteration outside evals, saves and probes"
    else:  # a render driver: its result line
        line.update(ms_per_served_frame=1e3 / out[0]["fps"],
                    result={k: v for k, v in out[0].items() if not isinstance(v, str)})
        msg += f", {line['ms_per_served_frame']:.2f} ms a served frame"
    results.append(line)
    print(msg, flush=True)
    return out, spies


def planes(out):
    return {"color": out["render"], "alpha": out["render_alpha"], "depth": out["render_depth"],
            "final_T": out["final_T"]}


def check_served(spies, what):
    """Every frame served through the installed budgets bitwise the same
    render on the per-frame pair list, overflow 0 (the per-frame renders
    made here, after the driver's timed loop)."""
    if not spies.served:
        raise AssertionError(f"{what}: no frame was served")
    with torch.no_grad():
        for a, kw, out in spies.served:
            raster = kw["rasterize_fn"]
            if raster is None or raster.func is not rc.rasterize_cuda or \
                    raster.keywords["max_tiles_per_gaussian"] < 16:
                raise AssertionError(f"{what}: a frame served without the budgets ({raster})")
            ref = render_frame(*a, **{**kw, "rasterize_fn": None})
            if int(out["overflow"]) != 0 or not same_images(planes(out), planes(ref)):
                raise AssertionError(f"{what}: a served frame is not the per-frame list's "
                                     f"(overflow {int(out['overflow'])})")
    return len(spies.served)


def check_outputs(model_path, iteration, n_test, dev, result_file):
    """The training driver's files exist and load back."""
    ts = ckpt.restore_checkpoint(os.path.join(model_path, f"chkpnt{iteration}.npz"), dev)
    if int(ts.step) != iteration:
        raise AssertionError(f"{model_path}: chkpnt{iteration}.npz holds step {ts.step}")
    from moss_torch.data.ply import load_ply

    ply = load_ply(os.path.join(model_path, "point_cloud.ply"))
    live = int(ts.gstate.valid.sum())
    n_ply = len(next(iter(ply.values())))
    cams = json.load(open(os.path.join(model_path, "cameras.json")))
    cfg = json.load(open(os.path.join(model_path, "cfg.json")))
    lines = [x for x in open(result_file).read().splitlines() if x.strip()]
    for rel in (f"point_cloud/iteration_{iteration}/point_cloud.ply",
                f"mlp_ckpt/iteration_{iteration}/ckpt.npz"):
        if not os.path.exists(os.path.join(model_path, rel)):
            raise AssertionError(f"{model_path}: no {rel}")
    if n_ply != live or len(cams) < n_test or cfg["pipe"]["rasterizer"] not in (
            "pallas", "reference") or not lines:
        raise AssertionError(f"{model_path}: ply {n_ply} points for {live} live, "
                             f"{len(cams)} cameras, cfg {cfg['pipe']}, {len(lines)} result lines")
    return ts, {"live": live, "cameras": len(cams), "result_lines": len(lines)}


def flat_equal_npz(a, b):
    """Two chkpnt npz files: the same keys, every array bitwise equal."""
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files)


def plain_blend_engines(dev):
    """Trainer(rasterizer="reference") under the engines on the card at
    DRIVER_ENGINE_HW: the queued segments under torch.cuda's sync debug mode
    "error" (a host read in a segment raises), then scan, whose CUDA graph
    must capture the plain blend's chunk loop and its remat backward; the two
    states bitwise equal. No blend kernel launches."""
    scene = make_scene(n_verts=300, device=dev)
    crop = DRIVER_ENGINE_HW * 3 // 4
    frames, _ = make_frames(scene, n_frames=3, H=DRIVER_ENGINE_HW, W=DRIVER_ENGINE_HW,
                            crop=crop, opacity=TARGET_OPACITY)
    cfg = Config(model=ModelConfig(capacity=2048, n_init_points=300),
                 optim=OptimConfig(iterations=12, densify_from_iter=4, densify_until_iter=10,
                                   densification_interval=4, opacity_reset_interval=8),
                 pipe=PipelineConfig(rasterizer="reference", test_iterations=(12,),
                                     save_iterations=()))
    lp = lpips.init_random(3407, device=dev)
    out, states = {}, {}
    for engine in ("queued", "scan"):
        tr = Trainer(scene, frames[:2], frames[2:], cfg, lp, crop_hw=(crop, crop), device=dev)
        tr.segment_sync_mode = "error"
        (_, ms), n = counted(lambda: clocked_ms(lambda: tr.train(dispatch_engine=engine)))
        if any(n[k] for k in BLEND_KERNELS) or not n["svd3"]:
            raise AssertionError(f"plain blend under {engine}: launches {n}")
        states[engine] = ckpt.flatten(tr.ts)
        out[engine] = {"ms": ms, "launches": n, "captures": tr._many.captures,
                       "replays": tr._many.replays, "pool_mb": tr._many.pool_mb,
                       "capture_ms": list(tr._many.capture_ms),
                       "psnr": tr.metrics_history[-1]["psnr"]}
    if dev.type == "cuda" and not (out["scan"]["captures"] and out["scan"]["replays"]):
        raise AssertionError(f"plain blend under scan: no graph ({out['scan']})")
    differ = flat_equal(states["queued"], states["scan"])
    if differ:
        raise AssertionError(f"plain blend: scan's state is not queued's in {differ[:8]}")
    return out


def phase_drivers(dev, smi):
    """The users' main path on the card: train_zju -> render_zju and
    train_monocap -> render_monocap from files on disk, each main() called in
    this process with no --device. Module docstring, phase 16b."""
    from moss_torch.cli import render_monocap, render_zju, train_monocap, train_zju

    shutil.rmtree(DRIVERS_DIR, ignore_errors=True)
    files = FrameFiles()
    t0 = time.perf_counter()
    zju_root = os.path.join(DRIVERS_DIR, "zju", "my_377")
    write_zju_capture(zju_root, files, DRIVER_ZJU_FRAMES, DRIVER_RAW)
    mono_root = os.path.join(DRIVERS_DIR, "monocap", DRIVER_MONOCAP_SEQ)
    write_monocap_capture(mono_root, files, DRIVER_RAW)
    files.wait()
    write_s = time.perf_counter() - t0
    print(f"drivers: wrote {files.n_jpg} JPEGs and {files.n_png} PNGs in {write_s:.1f} s, each read "
          "back through readers.imread", flush=True)
    results = []
    every = dict.fromkeys(DRIVER_KERNELS, True)
    serve_only = {"rasterize_fwd": True, "rasterize_bwd": False, "segment_sum": False,
                  "svd3": False}
    out_dir = {k: os.path.join(DRIVERS_DIR, f"out_{k}") for k in ("queued", "reference", "monocap",
                                                                 "monocap_scan")}
    zju = ["--data_root", os.path.dirname(zju_root), "--subjects", "377"]
    train = zju + ["--iterations", str(DRIVER_ITERS),
                   "--test_iterations", *map(str, DRIVER_CHECKS),
                   "--save_iterations", *map(str, DRIVER_CHECKS),
                   "--capacity", str(CAPACITY), "--n_init", str(N_VERTS)]

    # train_zju under queued (phase reference_schedule trains from disk under
    # scan and resumes, bitwise)
    argv = train + ["--output", out_dir["queued"], "--dispatch", "queued",
                    "--result_file", os.path.join(out_dir["queued"], "ZJU.txt")]
    metrics, queued = driver_call("train_zju_queued", train_zju.main, argv, results, every)
    ts, files_line = check_outputs(os.path.join(out_dir["queued"], "my_377"), DRIVER_ITERS,
                                   8, dev, os.path.join(out_dir["queued"], "ZJU.txt"))
    queued_psnr = [m["psnr"] for m in metrics[0]]
    results[-1].update(files_line, psnr=queued_psnr, budgets=queued.trainers[-1].budgets)
    if len(queued.logs) != DRIVER_ITERS or not all(math.isfinite(x["loss"]) for x in queued.logs):
        raise AssertionError(f"train_zju queued: {len(queued.logs)} logged iterations")
    if any(x.get("raster_overflow", 0) for x in queued.logs):
        raise AssertionError("train_zju queued: pairs dropped in training")

    # render_zju: the budgets' serving, the plain blend on the same checkpoint, novel views
    model_path = os.path.join(out_dir["queued"], "my_377")
    serve = zju + ["--iterations", "-1", "--output", out_dir["queued"]]
    (res,), spies = driver_call("render_zju", render_zju.main, serve + ["--save_images"],
                                results, serve_only)
    kernel_frames = [planes(o) for _, _, o in spies.served]
    results[-1]["served_bitwise"] = check_served(spies, "render_zju")
    pngs = sorted(glob.glob(os.path.join(model_path, "renders", f"iteration_{DRIVER_ITERS}",
                                         "*.png")))
    if len(pngs) != 8 or res["raster_overflow"] != 0:
        raise AssertionError(f"render_zju: {len(pngs)} PNGs, overflow {res['raster_overflow']}")
    for path, (_, _, o) in zip(pngs, spies.served[1:]):
        want = (torch.clamp(o["render"], 0.0, 1.0).cpu().numpy() * 255).astype(np.uint8)
        if not np.array_equal(readers.imread(path), want):
            raise AssertionError(f"{path}: not the served frame")
    with open(os.path.join(model_path, "smpl_rot", f"iteration_{DRIVER_ITERS}",
                           "smpl_rot.pickle"), "rb") as f:
        if len(pickle.load(f)) != 2:
            raise AssertionError("render_zju: smpl_rot holds no transforms of the 2 test poses")
    del spies
    (ref_res,), spies = driver_call("render_zju_reference", render_zju.main,
                                    serve + ["--rasterizer", "reference"], results,
                                    dict.fromkeys(DRIVER_KERNELS, False))
    worst = 0.0
    for i, ((_, kw, o), k) in enumerate(zip(spies.served, kernel_frames)):
        if kw["rasterize_fn"].func is not rasterize_reference:
            raise AssertionError("render_zju --rasterizer reference: served by "
                                 f"{kw['rasterize_fn']}")
        worst = max(worst, check_images(k, planes(o), f"render_zju frame {i}: kernel vs plain"))
    if abs(ref_res["psnr"] - res["psnr"]) > DRIVER_PSNR_ATOL:
        raise AssertionError(f"render_zju: PSNR {res['psnr']} with the kernels, "
                             f"{ref_res['psnr']} with the plain blend")
    results[-1].update(max_abs_err=worst, psnr_diff_db=ref_res["psnr"] - res["psnr"])
    del spies, kernel_frames
    (nv,), _ = driver_call("render_zju_novel_view", render_zju.main,
                           serve + ["--novel_view", str(DRIVER_NOVEL_VIEWS)], results, serve_only)
    n_nv = len(glob.glob(os.path.join(nv["img_dir"], "*.png")))
    if nv["novel_views"] != 2 * DRIVER_NOVEL_VIEWS or n_nv != nv["novel_views"] or \
            nv["raster_overflow"] != 0:
        raise AssertionError(f"render_zju --novel_view: {nv}, {n_nv} PNGs")

    # train_zju --rasterizer reference: the first step's losses against the kernels'
    no_evals = [str(DRIVER_ITERS + 1)]
    _, spies = driver_call(
        "train_zju_reference", train_zju.main,
        zju + ["--iterations", str(DRIVER_REFERENCE_ITERS), "--test_iterations", *no_evals,
               "--save_iterations", *no_evals, "--capacity", str(CAPACITY), "--n_init",
               str(N_VERTS), "--rasterizer", "reference", "--output", out_dir["reference"],
               "--result_file", os.path.join(out_dir["reference"], "ZJU.txt")],
        results, {"rasterize_fwd": False, "rasterize_bwd": False, "segment_sum": False,
                  "svd3": True})
    first, kfirst = spies.logs[0], queued.logs[0]
    rel = {k: abs(first[k] - kfirst[k]) / max(abs(kfirst[k]), 1e-12)
           for k in ("loss", "l1", "mask", "ssim", "lpips", "nll", "s3im") if k in kfirst}
    if max(rel.values()) > DRIVER_LOSS_RTOL:
        raise AssertionError(f"train_zju --rasterizer reference: first-step losses {rel}")
    results[-1]["first_step_rel_err"] = rel
    del spies, queued

    # train_monocap at 1024 x 1024 under queued, then under scan (bitwise its
    # checkpoint); then render_monocap on the scan run's
    mono = ["--data_root", os.path.dirname(mono_root)]
    mono_train = mono + ["--sequences", DRIVER_MONOCAP_SEQ, "--iterations",
                         str(DRIVER_MONOCAP_ITERS), "--test_iterations", str(DRIVER_MONOCAP_ITERS),
                         "--save_iterations", str(DRIVER_MONOCAP_ITERS), "--capacity",
                         str(CAPACITY), "--n_init", str(N_VERTS)]
    mono_ckpts = {}
    for engine, key in (("queued", "monocap"), ("scan", "monocap_scan")):
        metrics, spies = driver_call(
            "train_monocap" + ("_scan" if engine == "scan" else ""), train_monocap.main,
            mono_train + ["--output", out_dir[key], "--dispatch", engine,
                          "--result_file", os.path.join(out_dir[key], "monocap.txt")],
            results, every)
        model_path = os.path.join(out_dir[key], DRIVER_MONOCAP_SEQ)
        check_outputs(model_path, DRIVER_MONOCAP_ITERS, 17, dev,
                      os.path.join(out_dir[key], "monocap.txt"))
        mono_ckpts[engine] = sorted(glob.glob(os.path.join(model_path, "chkpnt*.npz")))
        tr = spies.trainers[-1]
        results[-1].update(psnr=[m["psnr"] for m in metrics[0]], crop=list(tr.crop_hw),
                           budgets=tr.budgets)
        if engine == "scan":
            many = tr._many
            names = [[os.path.basename(p) for p in mono_ckpts[e]] for e in ("queued", "scan")]
            same = names[0] == names[1] and len(names[0]) > 0 and all(
                flat_equal_npz(q, c) for q, c in zip(mono_ckpts["queued"], mono_ckpts["scan"]))
            results[-1].update(captures=many.captures, replays=many.replays,
                               capture_ms=list(many.capture_ms), pool_mb=many.pool_mb,
                               captured_launches=dict(many.captured_launches),
                               checkpoints=names[1], bitwise_queued=same)
            if not same or many.captures < 1 or \
                    many.captures + many.replays != DRIVER_MONOCAP_ITERS:
                raise AssertionError(f"train_monocap --dispatch scan: checkpoints {names} "
                                     f"bitwise queued's: {same}; {many.captures} captures, "
                                     f"{many.replays} replays")
        del spies, tr
    (mres,), spies = driver_call(
        "render_monocap", render_monocap.main,
        mono + ["--subjects", DRIVER_MONOCAP_SEQ, "--iterations", "-1", "--output",
                out_dir["monocap_scan"]], results, serve_only)
    results[-1]["served_bitwise"] = check_served(spies, "render_monocap")
    if mres["raster_overflow"] != 0 or not np.isfinite(mres["psnr"]):
        raise AssertionError(f"render_monocap: {mres}")
    del spies

    engines = plain_blend_engines(dev)
    emit({"phase": "drivers", "nvidia_smi": smi, "frame_files": {"jpeg": files.n_jpg,
                                                                 "png": files.n_png},
          "write_s": write_s, "calls": results, "plain_blend_engines": engines})
    for d in out_dir.values():  # the capture stays for phase reference_schedule
        shutil.rmtree(d, ignore_errors=True)
    return {r["call"]: r["launches"] for r in results}, zju_root, queued_psnr[-1]


# ---- the reference schedule from disk, then serving ---------------------------------

SCHEDULE_DIR = os.path.join(DRIVERS_DIR, "reference_schedule")
SH_BANDS = ((0, 3), (3, 8), (8, 15))  # f_rest's rows of SH degrees 1, 2 and 3
# the most the card's allocated memory may grow from the second capture to
# the last: half the cuBLAS workspace a new warm-up stream a capture left
CAPTURE_LEAK_MB = 32


class ScheduleSpies:
    """What a train_zju run did to its state, read from inside this process
    beside DriverSpies: each densify round (its iteration, the live count
    before, its stats, whether the state got new tensors, the budgets the
    resize after it left and whether that rebuilt the step), each opacity
    reset and budget install, each CUDA graph capture (the rounds before it,
    its ms and pool MB, the card's reserved and allocated MB just after,
    whether the graph it replaced was freed), and at each host boundary which
    SH degrees' coefficients are nonzero. `events` keeps rounds, resets,
    installs and captures in their order."""

    def __init__(self):
        self.rounds, self.resets, self.captures, self.bands, self.events = [], [], [], [], []

    @contextlib.contextmanager
    def installed(self):
        spies = self
        names = ((Trainer, "densify"), (Trainer, "reset_opacity"), (Trainer, "_install_budgets"),
                 (Trainer, "_resize_pair_buffer"), (Trainer, "_log_segment"))
        orig = {(c, k): getattr(c, k) for c, k in names}

        def densify(tr, it):
            live, ptr = int(tr.ts.gstate.valid.sum()), tr.ts.params["gauss"].xyz.data_ptr()
            stats = orig[Trainer, "densify"](tr, it)
            spies.rounds.append({"iteration": it, "live_before": live,
                                 **{k: int(v) for k, v in stats.items() if k != "masks"},
                                 "new_tensors": tr.ts.params["gauss"].xyz.data_ptr() != ptr,
                                 "installs_before": tr.budgets["installs"]})
            spies.events.append(("round", it))
            return stats

        def resize(tr, *a, **kw):
            out = orig[Trainer, "_resize_pair_buffer"](tr, *a, **kw)
            last = spies.rounds[-1] if spies.rounds else {}
            if last and "budgets" not in last and not kw.get("grow_from"):
                last["budgets"] = tr.budgets
                last["rebuilt"] = last["budgets"]["installs"] != last["installs_before"]
            return out

        def reset(tr):
            spies.resets.append(int(tr.ts.step))
            spies.events.append(("reset", int(tr.ts.step)))
            return orig[Trainer, "reset_opacity"](tr)

        def install(tr, *a, **kw):
            spies.events.append(("install", tr._budget_version + 1))
            return orig[Trainer, "_install_budgets"](tr, *a, **kw)

        def log_segment(tr, prev, bound, seg, **kw):
            out = orig[Trainer, "_log_segment"](tr, prev, bound, seg, **kw)
            f = tr.ts.params["gauss"].f_rest
            spies.bands.append((bound, torch.stack([(f[:, a:b] != 0).any()
                                                    for a, b in SH_BANDS]).tolist()))
            return out

        def capture():
            spies.events.append(("capture", len(spies.captures) + 1))
            return {"rounds_before": len(spies.rounds)}

        Trainer.densify, Trainer.reset_opacity, Trainer._install_budgets = densify, reset, install
        Trainer._resize_pair_buffer, Trainer._log_segment = resize, log_segment
        try:
            with captures_recorded(self.captures, capture):
                yield self
        finally:
            for (c, k), v in orig.items():
                setattr(c, k, v)


def schedule_split(line, spies, captures_ms):
    """A training driver call's wall seconds by part: the reads and decodes
    before the Trainer, its construction (the cloud, the first budget probe),
    the steps (train less the parts below), the rounds (densify and the
    resize after it), the heals, the captures, the evals, the saves (PLY and
    MLP layout, chkpnt npz), and what main did after train."""
    work = spies.work

    def of(*names, heal=False):
        return sum(ms for n, ms, g in work if n in names and bool(g) == heal) / 1e3

    train = spies.ms["train"] / 1e3
    split = {"read_s": line["read_s"], "setup_s": spies.ms["init"] / 1e3,
             "rounds_s": of("densify", "_resize_pair_buffer"),
             "heals_s": of("_resize_pair_buffer", heal=True), "captures_s": captures_ms / 1e3,
             "evals_s": of("evaluate"), "saves_s": of("save", "save_reference_layout")}
    split["steps_s"] = train - spies.ms["host_work"] / 1e3 - split["captures_s"]
    split["finish_s"] = line["wall_s"] - split["read_s"] - split["setup_s"] - train
    return split


def round_ms(spies):
    """Each round's ms: its densify and the budget resize right after it."""
    out, work = [], spies.work
    for i, (name, ms, _) in enumerate(work):
        if name == "densify":
            nxt = work[i + 1] if i + 1 < len(work) else None
            out.append(ms + (nxt[1] if nxt and nxt[0] == "_resize_pair_buffer" and not nxt[2]
                             else 0.0))
    return out


def schedule_gates(spies, sched, cfg, iters, capacity, dev):
    """Gates 1-5 of phase reference_schedule on a train_zju run (each
    raises), with the SH degrees' step-ups and the captures' causes; returns
    what they read."""
    o = cfg.optim
    # 1. every iteration logged, every loss finite
    if len(spies.logs) != iters or not all(math.isfinite(x["loss"]) for x in spies.logs):
        raise AssertionError(f"reference schedule: {len(spies.logs)} logged iterations of "
                             f"{iters}, or a loss not finite")
    # 2. rounds exactly at the schedule's iterations, no opacity reset
    want = [i for i in range(o.densification_interval, iters + 1, o.densification_interval)
            if o.densify_from_iter < i < o.densify_until_iter]
    got = [r["iteration"] for r in sched.rounds]
    if got != want or sched.resets:
        raise AssertionError(f"reference schedule: rounds at {got}, want {want}; resets at "
                             f"{sched.resets}")
    # 3. the live count never above the capacity
    live = [r["count_after"] for r in sched.rounds]
    most = max(live + [int(x["num_points"]) for x in spies.logs])
    if most > capacity:
        raise AssertionError(f"reference schedule: {most} live in a {capacity} capacity")
    # the SH degree steps up inside the replays: degree k's coefficients are
    # 0 until the first step at degree k that updates f_rest (a round's step
    # skips the Gaussians' update, the last iteration's every update), nonzero
    # from the host boundary after it
    step_ups = {}
    for k in range(1, cfg.model.sh_degree + 1):
        first_step = next((s for s in range(1, iters + 1)
                           if active_sh_degree(s, cfg.model.sh_degree) >= k and "f_rest" not in
                           optim.skipped_groups(o, cfg.model.white_background, s)), None)
        if first_step is None:
            continue
        want_b = min(b for b, _ in sched.bands if b >= first_step)
        got_b = next((b for b, nz in sched.bands if nz[k - 1]), None)
        step_ups[k] = {"step": first_step, "first_nonzero_boundary": got_b}
        if got_b != want_b:
            raise AssertionError(f"SH degree {k}: its coefficients nonzero first at boundary "
                                 f"{got_b}, want {want_b}")
    # overflow in training only with the trainer's heal after it
    dropped = [i + 1 for i, x in enumerate(spies.logs) if x.get("raster_overflow", 0)]
    heals = sum(1 for n, _, g in spies.work if n == "_resize_pair_buffer" and g)
    if dropped and not heals:
        raise AssertionError(f"pairs dropped at iterations {dropped[:10]} and no heal")
    out = {"rounds": got, "live_after_round": live, "max_live": most, "sh_step_ups": step_ups,
           "overflow_iterations": dropped, "heals": heals}
    if dev.type != "cuda":  # the CPU captures no graph
        return out
    caps = sched.captures
    # 4. a capture after each round that gave the state new tensors
    missing = [r["iteration"] for i, r in enumerate(sched.rounds) if r["new_tensors"] and not any(
        c["rounds_before"] == i + 1 for c in caps)]
    # and none that nothing called for: each capture after the first follows a
    # round, a reset or a budget install since the one before it
    uncalled, since = [], set()
    for kind, n in sched.events:
        if kind == "capture":
            if n > 1 and not since:
                uncalled.append(n)
            since = set()
        else:
            since.add(kind)
    if missing or uncalled:
        raise AssertionError(f"captures: none after the rounds at {missing}; captures "
                             f"{uncalled} with no round, reset or install before them")
    # 5. the graph pools do not pile up, and nothing a capture leaves lives on
    out.update(capture_memory_gate(caps, "reference schedule"))
    return out


def phase_reference_schedule(dev, smi, zju_root, baseline_psnr):
    """The avatar trained at the reference schedule from disk and served
    (module docstring, phase 16c): train_zju on phase drivers' capture with
    only --data_root, --subjects, --output, --result_file and --dispatch scan,
    then --resume from its chkpnt at the second eval, then render_zju
    --save_images on its last checkpoint. baseline_psnr: the PSNR phase
    drivers' queued run reached at its last eval on the same test frames.
    Returns {call: launches}."""
    from moss_torch.cli import render_zju, train_zju

    shutil.rmtree(SCHEDULE_DIR, ignore_errors=True)
    zju = ["--data_root", os.path.dirname(zju_root), "--subjects", "377"]
    args = train_zju.parse_args(zju)
    iters, checks, capacity = args.iterations, sorted(args.test_iterations), args.capacity
    out = {k: os.path.join(SCHEDULE_DIR, k) for k in ("run", "resume")}
    model_path = {k: os.path.join(d, "my_377") for k, d in out.items()}
    every = dict.fromkeys(DRIVER_KERNELS, True)
    results = []

    def argv(k):
        return zju + ["--output", out[k], "--result_file", os.path.join(out[k], "ZJU.txt"),
                      "--dispatch", "scan"]

    # the whole schedule under scan
    sched = ScheduleSpies()
    torch.cuda.reset_peak_memory_stats()
    metrics, spies = driver_call("train_zju", train_zju.main, argv("run"), results, every,
                                 sched.installed)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    tr = spies.trainers[-1]
    if tr.cfg.optim != OptimConfig(iterations=iters):
        raise AssertionError(f"reference schedule: the run's schedule is not the default: "
                             f"{tr.cfg.optim}")
    gates = schedule_gates(spies, sched, tr.cfg, iters, capacity, dev)
    _, files_line = check_outputs(model_path["run"], iters, 8, dev,
                                  os.path.join(out["run"], "ZJU.txt"))
    for c in checks:
        for rel in (f"chkpnt{c}.npz", f"point_cloud/iteration_{c}/point_cloud.ply"):
            if not os.path.exists(os.path.join(model_path["run"], rel)):
                raise AssertionError(f"reference schedule: no {rel}")
    evals = {m["iteration"]: {k: m[k] for k in ("psnr", "ssim", "lpips", "raster_overflow")}
             for m in metrics[0]}
    # 6. the first eval above the 60-iteration run's last
    if sorted(evals) != checks or not evals[checks[0]]["psnr"] > baseline_psnr:
        raise AssertionError(f"reference schedule: evals {evals}; the 60-iteration run "
                             f"reached {baseline_psnr}")
    many = tr._many
    split = schedule_split(results[-1], spies, sum(many.capture_ms))
    rms = round_ms(spies)
    line = {**results[-1], **files_line, "gates": gates, "split": split,
            "ms_per_iteration_outside_rounds": split["steps_s"] * 1e3 / iters,
            "round_ms": rms, "round_ms_median": float(np.median(rms)) if rms else None,
            "round_ms_max": max(rms, default=None), "rounds": sched.rounds,
            "captures": sched.captures, "capture_count": many.captures,
            "replays": many.replays, "peak_allocated_mb": peak_mb, "evals": evals,
            "psnr_margin_db": evals[checks[0]]["psnr"] - baseline_psnr,
            "baseline_psnr": baseline_psnr, "budgets": tr.budgets,
            "heal_events": tr._heal_events, "sh_bands_nonzero": sched.bands}
    results[-1] = line
    del spies, tr, many, sched
    print(f"reference_schedule ({smi}): train_zju {iters} iterations under scan in "
          f"{line['wall_s']:.1f} s: " + ", ".join(f"{k[:-2]} {v:.1f}" for k, v in split.items())
          + f" s; {line['ms_per_iteration_outside_rounds']:.2f} ms an iteration outside rounds, "
          f"a round {line['round_ms_median']:.1f} ms median, {line['round_ms_max']:.1f} max; "
          f"{line['capture_count']} captures at "
          f"{[round(c['ms'], 1) for c in line['captures']]} ms, pools "
          f"{[round(c['pool_mb'], 1) for c in line['captures']]} MB, reserved after each "
          f"{[round(c['reserved_mb']) for c in line['captures']]} MB; peak allocated "
          f"{peak_mb:.0f} MB; live after each round {gates['live_after_round']}; evals {evals}",
          flush=True)

    # 7. --resume from the second eval's checkpoint, bitwise the uninterrupted run
    resume_at = checks[-2]
    os.makedirs(model_path["resume"])
    shutil.copy(os.path.join(model_path["run"], f"chkpnt{resume_at}.npz"), model_path["resume"])
    _, spies = driver_call("train_zju_resume", train_zju.main, argv("resume") + ["--resume"],
                           results, every)
    final = f"chkpnt{iters}.npz"
    if len(spies.logs) != iters - resume_at or not flat_equal_npz(
            os.path.join(model_path["run"], final), os.path.join(model_path["resume"], final)):
        raise AssertionError(f"train_zju --resume from {resume_at}: {len(spies.logs)} iterations, "
                             "or not bitwise the uninterrupted run")
    captures = spies.trainers[-1]._many.captures
    if dev.type == "cuda" and captures != 1:  # no round after resume_at: one graph serves
        raise AssertionError(f"train_zju --resume: {captures} captures")
    results[-1].update(resumed_from=resume_at, captures=captures)
    del spies

    # 8. render_zju on the last checkpoint: served bitwise, the PNGs the served frames
    (res,), spies = driver_call(
        "render_zju", render_zju.main,
        zju + ["--iterations", str(iters), "--output", out["run"], "--save_images"], results,
        {"rasterize_fwd": True, "rasterize_bwd": False, "segment_sum": False, "svd3": False})
    print(f"reference_schedule render_zju ({smi}): {results[-1]['ms_per_served_frame']:.2f} ms a "
          f"served frame, raster_overflow {res['raster_overflow']}", flush=True)
    results[-1]["served_bitwise"] = check_served(spies, "render_zju at the reference schedule")
    pngs = sorted(glob.glob(os.path.join(model_path["run"], "renders", f"iteration_{iters}",
                                         "*.png")))
    if len(pngs) != 8:
        raise AssertionError(f"render_zju: {len(pngs)} PNGs")
    for path, (_, _, o) in zip(pngs, spies.served[1:]):
        want = (torch.clamp(o["render"], 0.0, 1.0).cpu().numpy() * 255).astype(np.uint8)
        if not np.array_equal(readers.imread(path), want):
            raise AssertionError(f"{path}: not the served frame")
    del spies
    emit({"phase": "reference_schedule", "nvidia_smi": smi, "iterations": iters,
          "checks": checks, "capacity": capacity, "calls": results})
    shutil.rmtree(DRIVERS_DIR, ignore_errors=True)
    return {r["call"]: r["launches"] for r in results}


def main():
    if len(sys.argv) == 6 and sys.argv[1] == "--sharded-rank":
        return sharded_rank(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "capability": list(torch.cuda.get_device_capability(0)),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    cuda_build.build_all(KERNELS)
    seconds = time.perf_counter() - t0
    ptxas = {n: cuda_build.ptxas_report(n) for n in KERNELS}
    for n, kernels in ptxas.items():
        for k in kernels:
            print(f"ptxas {n}: {k['kernel']}: {k['registers']} registers, {k['smem_bytes']} bytes "
                  f"static smem, spills {k['spill_stores']} / {k['spill_loads']} bytes", flush=True)
    emit({"phase": "build", "seconds": seconds, "ptxas": ptxas})

    timing.runs_retaken = 0
    timing.retaken_by_site.clear()
    by_phase, seconds = {}, {}

    def phase(name, fn, *args):
        """fn(*args), with the runs cuda_ms retook in it counted by site and
        its seconds; the card's memory of earlier phases (trainers hold
        reference cycles) freed first."""
        gc.collect()
        torch.cuda.empty_cache()
        before = dict(timing.retaken_by_site)
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {seconds[name]:.1f} s", flush=True)
        by_phase[name] = {k: v - before.get(k, 0) for k, v in timing.retaken_by_site.items()
                          if v != before.get(k, 0)}
        return out

    with torch.inference_mode():
        phase("kernel", phase_kernel, dev)
        row, serve_launches = phase("slice", phase_slice, dev)
    phase("train_kernel", phase_train_kernel, dev)
    bwd, train_launches, (train_ts, train_scene) = phase("train", phase_train, dev)
    trainer_launches, cuts, trained = phase("trainer", phase_trainer, dev)
    ckpt_launches = phase("checkpoint", phase_checkpoint, dev, trained, train_ts, CKPT_DIR, smi)
    orbit_launches, orbit_rows = phase("novel_view", phase_novel_view, dev, trained, smi)
    viewer_launches = phase("viewer", phase_viewer, dev, trained, smi)
    del trained
    engine_launches, scan_graph, cap_rows, svd_row = phase("engines", phase_engines, dev, smi)
    phase("densify", phase_densify, dev, train_ts, train_scene, cuts)
    sharded_launches, band_rows = phase("sharded", phase_sharded, dev, train_ts, smi)
    del train_ts, cuts
    (smplx_launches, smplx_rows, smplx_graph), smplx_world = phase("smplx", phase_smplx, dev,
                                                                    smi)
    static_launches, static_rows, static_graph = phase("static", phase_static, dev, smi)
    dna_launches = phase("dna", phase_dna, dev, smi, smplx_world)
    del smplx_world
    monocap_launches, monocap_rows, monocap_graph = phase("monocap", phase_monocap, dev, smi)
    family_graphs = {"smplx": smplx_graph, "static": static_graph, "monocap": monocap_graph}
    driver_launches, zju_root, driver_psnr = phase("drivers", phase_drivers, dev, smi)
    schedule_launches = phase("reference_schedule", phase_reference_schedule, dev, smi, zju_root,
                              driver_psnr)
    # the later paths' launches, and rows 1, 2 and 2b on their inputs
    zero = {"rasterize_fwd": 0, "rasterize_bwd": 0, "segment_sum": 0, "svd3": 0}
    families = {"smplx": smplx_launches, "static": static_launches,
                **({"dna": dna_launches} if dna_launches else {}),
                "novel_view": {k: sum(n[k] for n in orbit_launches.values()) for k in zero},
                "viewer": viewer_launches, "monocap": monocap_launches,
                "sharded": {k: sum(n[k] for m, n in sharded_launches.items()
                                   if "trainer" not in m) for k in zero},
                "sharded_trainer": {k: sum(n[k] for m, n in sharded_launches.items()
                                           if "trainer" in m) for k in zero},
                "engines": {k: sum(n[k] for n in engine_launches.values()) for k in zero},
                **{f"drivers_{call}": n for call, n in driver_launches.items()},
                "reference_schedule": {k: sum(n[k] for n in schedule_launches.values())
                                       for k in zero}}
    by_input = {f"smplx_{SMPLX_HW[1]}x{SMPLX_HW[0]}": smplx_rows,
                f"static_{STATIC_HW}x{STATIC_HW}": static_rows,
                f"monocap_{MONOCAP_HW}x{MONOCAP_HW}": monocap_rows, **orbit_rows,
                **band_rows}

    def family_rows(kernel):
        keep = ("ms", "ms_unsplit", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
                "library_ms", "runs_retaken")
        return {name: {"pairs": r["pairs"], "max_tile_pairs": r["max_tile_pairs"],
                       "segments": r["segments"], "split_tiles": r["split_tiles"],
                       **{k: v for k, v in r[kernel].items() if k in keep}}
                for name, r in by_input.items() if kernel in r}
    sort_rows, sort_launches = phase("tool_sort", phase_tool_sort, dev)
    conv_rows, conv_launches = phase("tool_conv", phase_tool_conv, dev)
    floor_row, floor_launches = phase("tool_bwd_floor", phase_tool_bwd_floor, dev)
    mxu_rows, mxu_launches, mxu_stage_launches = phase("tool_mxu", phase_tool_mxu, dev)
    by_kernel = {}
    for site, n in timing.retaken_by_site.items():
        key = site.split(":")[0].split()[0]
        kernel = SITE_KERNELS.get(key, key)
        by_kernel[kernel] = by_kernel.get(kernel, 0) + n
    emit({"phase": "timing", "runs_retaken": timing.runs_retaken, "by_phase": by_phase,
          "by_kernel": by_kernel, "phase_seconds": seconds})
    grad_tol = f"grads: max|g - g_plain| / max|g_plain| <= {GRAD_ATOL}; bg rtol {BG_RTOL}"

    def entry(name, source, replaces, launches, by_path, measured, tolerance, library_ms=None,
              **extra):
        retaken = sum(n for k, n in by_kernel.items()
                      if name == k or name in k.split("/") or (k == "mxu_*" and "mxu" in name))
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "launches_by_path": by_path,
                "max_abs_err": measured["max_abs_err"], "ms": measured["ms"],
                "plain_ms": measured["plain_ms"], "bound_ms": measured["bound_ms"],
                "bound_by": measured["bound_by"], "library_ms": library_ms,
                "tolerance": tolerance, "runs_retaken": retaken, **extra}

    def split(measured):
        return {k: measured[k] for k in ("ms_unsplit", "seg_len", "segments", "split_tiles",
                                         "max_tile_pairs")}

    def replayed(kernel):
        """The scan engine's graphs: what their replays ran, derived, not
        counted; the engines phase's, then each family phase's."""
        out = {"label": "the scan runs: replays x calls the last capture recorded; not in "
                        "launches, which count only what the wrapper launched",
               "captures": scan_graph["captures"], "replays": scan_graph["replays"],
               "captured": scan_graph["captured_launches"][kernel],
               "replays_x_captured": scan_graph["replays_x_captured"][kernel],
               "traced_per_profiled_replay": scan_graph["traced_per_replay"][kernel]}
        out["by_path"] = {name: {"captures": g["captures"], "replays": g["replays"],
                                 "captured": g["captured_launches"][kernel],
                                 "replays_x_captured": g["replays_x_captured"][kernel],
                                 "traced_per_profiled_replay":
                                     g["traced_per_profiled_replay"][kernel]}
                          for name, g in family_graphs.items()}
        return out

    def capacity(kernel):
        """The kernel at the engines phase's budgeted capacity and on the live list."""
        return {"npb": cap_rows["npb"], "pairs": cap_rows["pairs"],
                "slots_capacity": cap_rows["slots_capacity"], "slots_live": cap_rows["slots_live"],
                **cap_rows[kernel]}

    mxu_tol = (f"max|out - plain| <= {mxu_micro.RTOL} max|plain| (tensor-core forms against a "
               "plain version rounding as the kernel does); observers bitwise equal across "
               "tiles; ms, bound, plain (on the TILES chunks stacked) and library (one "
               "PyTorch call over the TILES x REPS chunks) each of a launch's TILES x REPS "
               "chunk-ops, summed over the variants")

    emit({"kernels": [
        entry("rasterize_fwd", "moss_torch/csrc/rasterize_fwd.cu",
              "moss_tpu/ops/rasterize_tpu.py:288",
              serve_launches + sum(p["rasterize_fwd"] for p in (
                  train_launches, trainer_launches, ckpt_launches, *families.values())),
              {"serve": serve_launches, "train": train_launches["rasterize_fwd"],
               "trainer": trainer_launches["rasterize_fwd"],
               "checkpoint": ckpt_launches["rasterize_fwd"],
               **{k: v["rasterize_fwd"] for k, v in families.items()}}, row,
              f"atol {ATOL} (depth {DEPTH_ATOL}); at most {OUTLIER_FRAC} of pixels beyond; "
              "against the plain blend and the plain segment scheme; bitwise repeatable; ms "
              "on the serving input, one call being two launches of the kernel",
              **split(row), by_input=family_rows("rasterize_fwd"),
              at_capacity=capacity("rasterize_fwd"),
              scan_graph=replayed("rasterize_fwd")),
        entry("rasterize_bwd", "moss_torch/csrc/rasterize_bwd.cu",
              "moss_tpu/ops/rasterize_tpu.py:383",
              sum(p["rasterize_bwd"] for p in (train_launches, trainer_launches, ckpt_launches,
                                               *families.values())),
              {"train": train_launches["rasterize_bwd"],
               "trainer": trainer_launches["rasterize_bwd"],
               "checkpoint": ckpt_launches["rasterize_bwd"],
               **{k: v["rasterize_bwd"] for k, v in families.items()}}, bwd,
              grad_tol + "; rows against the plain segment scheme, grads against the unsplit "
              "kernel, the same; ms on the training input", **split(bwd),
              by_input=family_rows("rasterize_bwd"), at_capacity=capacity("rasterize_bwd"),
              scan_graph=replayed("rasterize_bwd")),
        entry("segment_sum", "moss_torch/csrc/segment_sum.cu", "moss_tpu/ops/binning.py:51",
              sum(p["segment_sum"] for p in (train_launches, trainer_launches, ckpt_launches,
                                             *families.values())),
              {"train": train_launches["segment_sum"],
               "trainer": trainer_launches["segment_sum"],
               "checkpoint": ckpt_launches["segment_sum"],
               **{k: v["segment_sum"] for k, v in families.items()}},
              bwd["segment"], "1e-5 of the max against index_add_; grads as rasterize_bwd",
              library_ms=bwd["segment"]["library_ms"], by_input=family_rows("segment_sum"),
              at_capacity=capacity("segment_sum"),
              scan_graph=replayed("segment_sum")),
        entry("svd3", "moss_torch/csrc/svd3.cu",
              "moss_tpu/ops/fisher.py:111 (XLA's SVD; no Pallas kernel)",
              sum(p["svd3"] for p in (train_launches, trainer_launches, ckpt_launches,
                                      *families.values())),
              {"train": train_launches["svd3"], "trainer": trainer_launches["svd3"],
               "checkpoint": ckpt_launches["svd3"],
               **{k: v["svd3"] for k, v in families.items()}}, svd_row,
              f"S and proper S within {SVD_RTOL} of the largest singular value, U diag(g) V^T "
              f"within {SVD_ATOL} of torch.linalg.svd's (the plain version and the library "
              "call), U diag(S) V^T within it of the input, on the pose MLPs' 23 rotations "
              f"and {SVD_GENERAL} well-separated plus {SVD_NEAR_EYE} near-identity random "
              "matrices; bitwise repeatable; ms on the rotations",
              library_ms=svd_row["library_ms"], scan_graph=replayed("svd3")),
        *(entry(f"sort_{k}_pass", "moss_torch/csrc/sort_pass.cu", f"tools/sort_micro.py:{line}",
                sort_launches[k], {"tools": sort_launches[k]}, sort_rows[k],
                f"exact, every stride; ms per launch of R = 64 passes at {at} = 64",
                library_ms=sort_rows[k]["library_ms"],
                library_call="torch.sort of the 2^19 keys: a whole sort, not a pass",
                issue_floor_ms=sort_rows[k]["issue_floor_ms"],
                issue_floor="one IMNMX an element and pass, 64 lanes a clock an SM")
          for k, line, at in (("lane", 47, "s"), ("row", 68, "S"))),
        *(entry(name, "moss_torch/csrc/conv3x3.cu", "tools/conv_pallas_proto.py:28",
                conv_launches[name], {"tools": conv_launches[name]}, conv_rows[name], tol,
                library_ms=conv_rows[name]["library_ms"], **extra)
          for name, tol, extra in (
              ("conv3x3", f"bf16 on the tensor cores: max|y - y_plain| <= {conv_proto.BF16_RTOL} "
                          "max|y_plain|, bitwise repeatable; ms summed over the eight VGG16 "
                          "layers, library cuDNN bf16",
               {"stage_launches": conv_launches["conv3x3_stages"],
                "stage_ms": conv_rows["conv3x3"]["stage_ms"]}),
              ("conv3x3_f32", f"f32 on the CUDA cores: atol {conv_proto.F32_ATOL}, bitwise "
                              "repeatable; ms summed over check()'s three shapes, library cuDNN "
                              "f32 (TF32 off), which is the plain version too",
               {k: conv_rows["conv3x3_f32"][k] for k in ("by_shape", "f32_layers",
                                                           "f32_layers_by_shape")}))),
        entry("rasterize_bwd_stages", "moss_torch/csrc/rasterize_bwd.cu",
              "tools/bwd_kernel_floor.py:97", floor_launches, {"tools": floor_launches},
              floor_row, "full, full_soa bitwise equal to rasterize_bwd; rows vs plain "
              f"{GRAD_ATOL} of the max, observers {OBSERVE_RTOL}; ms summed over the five "
              "stages on bench"),
        *(entry(kname, "moss_torch/csrc/reduce_scan.cu", replaces, mxu_launches[kname],
                {"tools": mxu_launches[kname]}, mxu_rows[kname], mxu_tol,
                library_ms=mxu_rows[kname]["library_ms"],
                replaces_all=f"tools/mxu_micro.py: {all_}",
                variants=mxu_rows[kname]["variants"],
                **({"cumprod_stage_ms": mxu_rows[kname]["cumprod_stage_ms"],
                    "stage_launches": mxu_stage_launches["scan"],
                    "cumsum_stage_ms": mxu_rows[kname]["cumsum_stage_ms"],
                    "cumsum_stage_launches": mxu_stage_launches["cumsum"]}
                   if kname == "mxu_scan" else {}),
                **({"tf32x3_stage_ms": mxu_rows[kname]["tf32x3_stage_ms"],
                    "stage_launches": mxu_stage_launches["tf32x3"]}
                   if kname in ("mxu_moments", "mxu_acc") else {}),
                **({"issue_floor_ms": mxu_rows[kname]["variants"]["reshape_only"]["issue_floor_ms"],
                    "issue_floor": "2 FADDs an element and rep, 128 lanes a clock an SM"}
                   if kname == "mxu_reshape" else {}),
                cuda_stage_ms=mxu_rows[kname]["cuda_stage_ms"],
                cuda_stage_launches=mxu_stage_launches["cuda"],
                **({"cumsum_cuda_stage_ms": mxu_rows[kname]["cumsum_cuda_stage_ms"]}
                   if kname == "mxu_scan" else {}),
                **({"bf16_stage_ms": mxu_rows[kname]["bf16_stage_ms"],
                    "bf16_stage_launches": mxu_stage_launches["bf16"]}
                   if kname in ("mxu_moments", "mxu_acc") else {}))
          for kname, _, _, replaces, all_ in MXU_KERNELS),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
