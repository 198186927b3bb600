#!/usr/bin/env python3
"""Card smoke run of the PyTorch/CUDA port (bilateral_driving_tpu_torch).

Renders the flagship omnire_ms_bilateral scene at full width on one NVIDIA
GPU through the port's entry points (eval.render_loop.render_images and
train.trainer.forward), takes flagship training steps on it
(train.trainer.train_step), does the same for omnire_bilateral (SMPL
pedestrians and the single bilateral grid) and omnire (the affine
appearance codes with camera refinement), takes a step of each other
appearance model (the neural, multi-scale neural and CP-4D grids, the
multi-scale grids with the cycle loss), of the PVG and DeformableGS
backgrounds and of the options no YAML turns on (the MLP sky, no sky, the
voxel skinning deformer, the rigid and Background regularisers), runs the
parallel layer at world size 1 over NCCL (data-parallel and tile steps,
an image in bands, the CLI's parallel flags), computes
LPIPS, trains, resumes and evaluates a scene from disk through the port's
CLI (tools.train, tools.eval) with every preset and from YAML files,
renders the trained run's splits and a novel trajectory (tools.render),
compares the trained run's gradients past its densification with the
plain versions', edits the flagship scene's cars (scene.rigid's
remove_instances and replace_instances) and bins it with the standalone
binning.bin_gaussians, and holds every hand-written kernel of those paths
against its plain PyTorch version.
Phases, each printed on its own line with its result and elapsed seconds:

  env       PyTorch and CUDA versions, nvcc, ninja, PyYAML, PIL, the card
  build     nvcc builds of csrc/*.cu, cold and warm
  scene     the flagship scene from a seed: nuScenes at 1/3 (533 x 300),
            1,000,000 live background Gaussians in a 2,097,152 capacity,
            16 rigid x 4,096 and 8 deformable x 4,096 points, EnvLight
            R=1024, multi-scale bilateral grids over 240 images; the
            intersection capacity from probe_num_isects + autotune_capacity
  kernels   each render kernel against its plain version at the main
            path's shapes: the expansion also on edge cases (a sparse
            table, num_isects 0, equal to and above capacity, one
            Gaussian over three 1,024-entry windows, N = 1), each launched
            twice and bit-exact; the compositing forward's two instances
            each launched twice (bit-equal), n_live equal to the plain
            version's, with the render path's live chunks per tile; both
            kernels' registers, shared memory and resident blocks per SM,
            and the forward's cluster size and the clusters resident on
            the card at once (tools/kernel_resources.py); the prefix
            scan at tools/driver_smoke.py's
            shapes (float32 sum, max, min), on the main path's int32
            tile counts (cumsum) and a capacity-long int32 cummax, at
            int32 lengths around its tile and 3 rows x 20,000 (sum, max,
            min), on a sum that wraps past 2^31, and on the main path's
            counts 200 times back to back between other lengths, every
            int32 result bit-exact
  render    6 frames (train views, test views with neighbour-averaged
            affines, one novel view) with the launch counters read per frame
  reference one frame again through the plain versions, compared
  times     CUDA-event times of each render kernel and the scan, its plain
            version, its bound and (the scan) torch.cumsum; the device
            time alone of each kernel and library call, from the profiler
  profile   one frame under torch.profiler: device busy time, idle share,
            the number of device operations and those that take the most
            device time
  edit      the offline rigid-instance editing API on the flagship state:
            the first train view in which two cars each cover 100 pixels
            with a visible weight (their share of the pixel's alpha) above
            0.5, the larger removed
            (scene.rigid.remove_instances) and the other replaced by a
            third car's Gaussians (replace_instances), the state's tensors
            left as they were; the edited view through the kernels
            (counters from 0: the expansion, compositing forward and scan
            launched, nothing else) and through the plain versions (no
            launch), rgb and alpha within 3e-5 and depth within 1e-3 where
            alpha > 0.2; the removed car's pixels changed, the tiles no
            span of the edited cars touches unmoved (3e-5; 1e-4, the early
            stop's transmittance, in tiles every pixel of which reaches
            it); binning.bin_gaussians on the edited render's projection
            on the card (only the scan launched): num_isects the render's,
            the tile counts summing to it, its sorted entries the render's
            and none of the removed car, and counts, starts, offsets,
            owning tiles, entries, num_isects and overflow bit-equal to
            bin_gaussians on the CPU
  targets   training targets: renders of a second state drawn from another
            seed, 1 - its alpha as the sky mask and 5% of its depths
            where alpha > 0.5 as the lidar map
  grads     the first step's gradients through the kernels against the
            same step with every kernel reference pointed at its plain
            version
  train     4 training steps from step 3398 (3400 refines), the launch
            counters read per step
  train_steps    the ordinary step 3399 timed 5 times, each from a copy
            of the state saved before it (the synthetic state blows up
            within five steps, so the main path cannot simply run on):
            median, spread; the first and the refining step of the train
            phase apart
  train_profile  the same step once more under torch.profiler: device busy
            time, idle share of the median ordinary step, device
            operations, top items
  train_kernels  each training kernel against its plain version on inputs
            captured from the train phase, the compositing backward also
            launched twice (bit-equal) with the spread of live chunks over
            tiles, and on edge cases (a tile with no live chunk, a range
            that starts mid-chunk, a chunk shared by two tiles, a tile of
            over 200 live chunks, a tile whose every pair the alpha gate
            drops, an opaque tile that stops early, a tile that stops on
            its last chunk), each launched twice; the compositing forward
            on the captured inputs and the edge cases as in kernels; the
            splat per (face, channel) row
            with its share of zero cotangents, and the strides of the sky
            texture's gradient against the texture's own; the splat
            launched SPLAT_REPEATS times on the captured input (R=1024) and
            on one like the SMPL quality protocol's (R=64, 1,536 sky
            pixels), every launch bit-equal to the first and to the plain
            version's index_add_ on the CPU; segment_sum_rows,
            which the main path does not call, on the main path's
            segment_sum rows; the segment lengths there; the segment sums
            on edge cases (one Gaussian owning 100,000 entries, a Gaussian
            count that is not a multiple of 32, offsets clamped at cap,
            every segment empty, row0 > 0, 1 and 16 input rows), each
            launched twice and bit-equal
  train_times    CUDA-event times of each training kernel, its plain
            version, one library call that computes the same function, and
            its bound, and of the compositing forward with residuals (the
            splat also at the R=64 input); the device time alone of each
            kernel and library call, from the profiler
  cli       the port's CLI in subprocesses with PIL blocked:
            tools.train on tests/fixtures/proto_scene (its pixel pack) at
            the flagship widths for CLI_STEPS steps (two refines, a
            resolution-schedule crossing, checkpoints), a resume from the
            step-150 checkpoint, and tools.eval; steps/s, peak memory,
            guards, refinements and kernel launches of the train run, the
            metrics finite, the step-0 snapshot (logging.vis_freq) a PNG
  render_cli  tools.render on the cli run with PIL blocked: the test and
            full splits (rgb, depth) and a 60-frame front_center_interp
            trajectory as PNG frames; ms per novel frame, one expansion,
            compositing forward and scan per frame, every frame finite and
            every PNG's IDAT the image's bytes
  cli_grads the cli run's state past its densification, rebuilt from its
            config.json and step-150 checkpoint as tools.eval rebuilds it:
            at steps 151-154, at the refining step 200 and at 201 the
            kernel step's gradients against the all-plain step's from the
            same state (every leaf and the screen-space means, relative
            norm within 1e-3), teacher-forced (the kernel step advances
            the state after each comparison and at every step between),
            with the worst leaf, the live Gaussians of each class and
            num_isects of each compared step, the refinement at 200
            changing the live counts, and the launches over the 51 steps
  bilateral_scene   omnire_bilateral (configs.OMNIRE_BILATERAL_TREE) on the
            same scene plus 8 SMPL walkers of 6,890 vertices each (55,120
            Gaussians, each walker in view of one camera, its own random
            body) and the single grids (240, 12, 8, 16, 16); the
            intersection capacity, and the walkers' own intersections in
            each view
  bilateral_render  a train view and a test view (the walkers' poses
            slerped, neighbouring grids averaged) through render_images,
            3 times each, counters from 0: median, spread, one frame
            profiled
  bilateral_targets .. bilateral_train_profile   the flagship's training
            phases on this configuration, with steps 3398-3400 (the SMPL
            leaves among the compared gradients, the SMPL point count
            checked each step)
  bilateral_kernels each kernel of the path against its plain version on
            the arguments of its first launch in bilateral_train
  omnire_scene .. omnire_kernels   the same phases for omnire on the same
            scene (the state's draws as far as the appearance model as
            bilateral_scene's): the affine codes in place of the grids and
            the camera poses refined, both moved off their zero init; the
            Affine and CamPose leaves among the compared gradients
  appearance_variants   for the neural, multi-scale neural and CP-4D
            grids and the multi-scale grids with the cycle loss
            (affine_inverse 1): each preset's state on the same scene, one
            step's gradients against the all-plain step (every leaf), the
            step timed 3 times from a copy of the state, its launches
            (one of each training kernel) and finite parameters, a test
            view with neighbour-averaged appearance
  background_variants   pvg and deformablegs on the same scene at full
            width (2,097,152 background slots, 1,000,000 live, EnvLight
            R=1024, affine codes, camera refinement; DeformableGS's 8 x 256
            network over every slot): one step's gradients against the
            all-plain step (every leaf, PVG's taus, life spans and
            velocities and the network's among them, none zero), the step
            timed 3 times, its launches, a test view, the peak memory
  option_variants   the options of the JAX trainer that no YAML turns
            on, each beside omnire_bilateral on the omnire scene at full
            width: the MLP sky, no sky, the voxel skinning deformer (eight
            (24, 16, 64, 64) voxels, their set-up timed and rebuilt
            bit-equal, the correction moved off zero), rigid temporal
            smoothness with the Background's flatten, sparse_reg and
            max_s_square_reg terms (the cars' quaternion tracks moved off
            their one heading): one step's gradients against the
            all-plain step (the option's leaves among them, none zero),
            the step timed 3 times, its launches (the splat none without
            an EnvLight texture), a test view (the MLP sky at the mean
            code), the peak memory
  parallel  the parallel layer on one card: distributed.maybe_initialize
            joins a world-size-1 NCCL group over tcp://127.0.0.1; one
            data_parallel step and one tile_train_step of omnire_bilateral's
            state at step 3398 on the omnire scene, each timed after a first
            call that sets up the communicators, against train_step from a
            copy of the state (the data step's parameters bit-equal or
            within 1e-6 per leaf, the tile step's parameters and its band
            path's gradients within 1e-3); image 0 whole and as 2 and 4
            bands through tile_parallel.render_band (stitched rgb and alpha
            within 1e-4, num_isects equal, the band-summed gradients of the
            per-band losses within 1e-4, CUDA-event ms of each band's
            forward and backward beside the whole image's); a band of
            transparent Gaussians (no entries) forward and backward; then
            three CLI runs on the fixture side by side: plain,
            `--data_parallel -1 --project p` (metrics.json equal to the plain
            run's) and `--coordinator --num_processes 1 --process_id 0
            --project p`, 5 steps each with cli_presets' overrides (20
            before the preprocess phase came: a cut of depth for time)
  lpips     LPIPS (eval/lpips.py) with weights drawn from a seed and
            written in tools/export_lpips_weights.py's layout: two sky
            variants' 533 x 300 test views and their target on the card
            against the plain path on the CPU in float64, ms per image
            pair, eval/metrics.lpips through BILATERAL_LPIPS_WEIGHTS
  cli_yaml  tools.train --config_file (omnire_bilateral with every option
            above, written as YAML) --dataset_file (a proto_scene rig)
            smpl.model_path=synthetic for 50 steps with PIL blocked, a
            resume from checkpoint_26 bit-equal at step 50 beside
            tools.eval with the lpips weights (a finite lpips)
  cli_smpl  tools.train --config omnire_bilateral on proto_scene with
            smpl.model_path=synthetic for CLI_SMPL_STEPS steps (its
            pedestrian in SMPLNodes), then tools.eval: test PSNR and the
            human-masked test PSNR
  cli_omnire  the same with --config omnire, a resume from its step-51
            checkpoint for 20 steps, then tools.eval: steps/s, test PSNR,
            non-finite parameters
  cli_presets  the CLI with each other preset this port added
            (omnire_extended_cam, the neural, multi-scale neural and CP-4D
            grids, omnire_ms_bilateral_extended, pvg, deformablegs): 5
            steps of the fixture, the seven side by side, the test PSNR
            of each run's own evaluation; then a resume of each from step
            3 beside tools.eval --max_images 1 of each (the first test and
            the first image of the full split from its last checkpoint,
            finite metrics); 20 steps and a whole evaluation of each
            before the preprocess phase came (a cut of depth for time)
  cli_synthetic  tools.train --config synthetic at the YAML's full size
            for its 200 steps with the live viewer on (a frame and the
            stats fetched while training is paused), a resume from the
            step-100 checkpoint bit-equal to the uninterrupted run at step
            200, the TensorBoard event file read back, the source backup,
            the final background exported as a ply
  cli_downscale  tools.train on proto_scene with data.downscale=2 (the
            port's resize at load, PIL blocked) for 5 steps with
            cli_presets' overrides (20 before the preprocess phase came: a
            cut of depth for time), side by side with cli_synthetic's
            resume
  preprocess  offline preprocessing from a raw log to a trained scene:
            tools/raw_scene.py writes a nuScenes v1.0-mini log from the
            seed at the published sensor sizes (6 cameras at 1600 x 900,
            34,720-point lidar sweeps, 3 keyframes, 36 annotations a
            keyframe); preprocess.cli converts it with --device cuda and
            with --device cpu side by side (images, calib, lidar, the
            dynamic masks filled on the device, objects, ego-mask
            placeholders), the tracker outputs of tools/raw_scene.py are
            matched into smpl.pkl on both trees, SegFormer-b5 (random
            weights at the published widths, drawn as transformers draws
            them, from a checkpoint directory the port writes and reads)
            writes the cuda tree's sky masks; every file of the cpu tree
            equal to the cuda tree's, smpl.pkl with every pedestrian;
            once the cpu conversion has ended, SegFormer on one image in
            float32 and float64 (TF32 off): the logits' relative error
            (within 1e-5, which a TF32 matmul would exceed), the share of
            pixels whose class differs (each a near-tie), ms per image and
            the peak memory; then, with nothing else running,
            tools.train with omnire_ms_bilateral, SMPL on and the
            nuscenes/3cams rig on the converted scene for 20 steps (no
            non-finite parameter, every train-path kernel launched each
            step, a finite test PSNR); stage seconds, steps/s and peaks
  total     the run's seconds

Then a `kernels` JSON line (each entry also with its launches on the
edit, omnire_bilateral, omnire, background_variants, option_variants,
parallel, cli_yaml, render_cli, cli_grads, cli_synthetic, cli_downscale
and preprocess paths),
the card's name and power limit as
nvidia-smi gives them, and, last, {"ok": true, "device": {...}}. Any failed
check raises, so the run exits non-zero and prints no result line; so does
a run without CUDA or outside a checkout of the repository.

Usage: python3 chip_smoke.py [--seed N]
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 533, 300          # nuScenes 1600 x 900 at 1/3
FOCAL = 1266.0 / 3.0              # nuScenes front camera fx at 1/3
NUM_FRAMES, NUM_CAMS = 40, 6      # 240 images
NUM_BG, RIGID, DEFORM, PTS = 1_000_000, 16, 8, 4096
TEST_STRIDE = 10
TRAIN_VIEWS = (0, 13, 62)         # image = frame * NUM_CAMS + camera
TEST_VIEWS = (60, 125)
RASTER_ATOL, RASTER_RTOL = 1e-4, 1e-5   # kernel vs plain, per element
FRAME_ATOL = 1e-4                       # rendered rgb, kernels vs plain
# training: images of training frames (frame = image // 6, frames 10, 20,
# ... are test frames), the first step, and how often the ordinary step
# after it is timed
TRAIN_IMAGES = (1, 14, 33, 75)
TRAIN_STEP0 = 3398
TIMED_STEPS = 5
# kernel vs plain, per output row as the relative norm of the difference:
# compositing backward (sums over 1,024 pixels in other orders), segment
# sums and the splat (a few adds per element, the plain versions' and the
# splat's in atomic order)
BWD_RTOL = 1e-4
SUM_RTOL = 1e-5
# one step's gradients, kernels vs plain, relative norm per parameter leaf
GRADS_RTOL = 1e-3
# scan against its plain version: max and min and every int32 scan
# bit-exact; float32 sums to tools/driver_smoke.py's rtol/atol and, per
# element, within SCAN_SUM_REL of the prefix sum of |x| (the two sum the
# same terms in other groupings)
SCAN_RTOL, SCAN_ATOL, SCAN_SUM_REL = 1e-4, 1e-3, 1e-5
# the CLI run: proto_scene at the flagship widths (data.downscale=1: the
# fixture is 96 x 64 already)
CLI_STEPS, CLI_RESUME_STEP, CLI_RESUME_STEPS = 300, 151, 20
CLI_OVERRIDES = [
    "data.scene_dir=tests/fixtures/proto_scene",
    "data.pixel_pack=tests/fixtures/proto_scene_pixels.npz",
    "data.cameras=[0,1]", "data.num_cams=2", "data.downscale=1",
    f"trainer.max_steps={CLI_STEPS}",
    "res_schedule.double_steps=100", "res_schedule.downscale_times=1",
    "density.warmup_steps=100", "density.refine_interval=100",
    "trainer.steps_per_dispatch=4", "logging.ckpt_every=150",
    "logging.log_every=50"]
# cli_grads: the cli run's state from its step-150 checkpoint, the
# kernel step's gradients against the all-plain step's (teacher-forced)
# at the four steps after it, at the refining step 200 and at 201, the
# first step on the densified state
CLI_GRAD_STEPS = (151, 152, 153, 154, 200, 201)
# edit: the first train view in which two cars each cover EDIT_MIN_PIXELS
# pixels with a visible weight above 0.5 (their share of the pixel's
# alpha); a pixel of the removed car counts as changed where the rendered
# rgb moved by more than EDIT_CHANGED, and EDIT_CHANGED_SHARE of them
# must; renders held to the port's render tolerances (ROADMAP.md,
# Tolerances)
EDIT_MIN_PIXELS = 100
EDIT_CHANGED, EDIT_CHANGED_SHARE = 1e-3, 0.9
RENDER_ATOL, DEPTH_ATOL = 3e-5, 1e-3
# omnire_bilateral on the same scene: 8 SMPL walkers of 6,890 vertices
# (the SMPL mesh's count; each its own random body) and the single grids
# (240, 12, 8, 16, 16); a train and a test view rendered 3 times each; its
# training as the flagship's
SMPL_WALKERS, SMPL_VERTS = 8, 6890
BILATERAL_VIEWS = (0, 60)
# the first, the ordinary and the refining step (3398-3400): the fourth
# step of this synthetic state overflowed the intersection capacity (the
# state runs away within a few steps, as the flagship's does: ROADMAP.md)
BILATERAL_TRAIN_IMAGES = TRAIN_IMAGES[:3]
FRAME_REPEATS = 3
# the CLI with the omnire_bilateral preset on proto_scene, its pedestrian
# in SMPLNodes with the synthetic body
CLI_SMPL_STEPS = 100
CLI_SMPL_OVERRIDES = [
    o for o in CLI_OVERRIDES if not o.startswith(
        ("trainer.max_steps", "res_schedule", "density", "logging"))] + [
    f"trainer.max_steps={CLI_SMPL_STEPS}", "smpl.model_path=synthetic",
    "res_schedule.double_steps=50", "res_schedule.downscale_times=1",
    "density.warmup_steps=50", "density.refine_interval=50",
    "logging.ckpt_every=1000000", "logging.log_every=50"]
# omnire (the affine codes and camera refinement) on the omnire_bilateral
# phases' scene, its views and steps; then the other appearance models on
# the same scene, one training step each (every gradient leaf against the
# all-plain step) timed VARIANT_TIMED_STEPS times, and a test view: the
# trainer's appearance branch, the preset and its overrides
VARIANTS = (
    ("neural_bilateral", "omnire_neuralbilateral", []),
    ("multiscale_neural_bilateral", "omnire_ms_neuralbilateral", []),
    ("cp4d", "omnire_cp4d", []),
    ("multiscale_bilateral_inverse", "omnire_ms_bilateral",
     ["losses.affine_inverse=1.0"]))
VARIANT_TIMED_STEPS = 3
# the CLI with the omnire preset, as cli_smpl, then a resume from the
# step-CLI_OMNIRE_RESUME checkpoint for CLI_OMNIRE_RESUME_STEPS steps
CLI_OMNIRE_RESUME, CLI_OMNIRE_RESUME_STEPS = 51, 20
CLI_OMNIRE_OVERRIDES = [o for o in CLI_SMPL_OVERRIDES
                        if not o.startswith("logging.ckpt_every")] + [
    "logging.ckpt_every=50"]
# the other presets through the CLI on the fixture: each trains
# CLI_PRESET_STEPS steps and resumes from its step-CLI_PRESET_RESUME
# checkpoint, the seven runs side by side (no steps/s from them), with
# 262,144 background slots (checkpoints of a fifth the size; cli and
# cli_omnire run the flagship widths). Each run refines and crosses the
# resolution schedule. Since the preprocess phase came, 5 steps and
# tools.eval of one image a split (beside the resumes) keep chip_smoke
# within its time: 20 steps, a resume and a whole evaluation of each took
# 213 s of a run's 871 s; 5 steps with whole evaluations beside the
# resumes 103-167 s
CLI_PRESETS = ("omnire_extended_cam", "omnire_neuralbilateral",
               "omnire_ms_neuralbilateral", "omnire_cp4d",
               "omnire_ms_bilateral_extended", "pvg", "deformablegs")
CLI_PRESET_STEPS, CLI_PRESET_RESUME = 5, 3
CLI_PRESET_OVERRIDES = [
    o for o in CLI_SMPL_OVERRIDES if not o.startswith(
        ("trainer.max_steps", "res_schedule", "density", "logging"))] + [
    f"trainer.max_steps={CLI_PRESET_STEPS}", "logging.ckpt_every=2",
    "logging.log_every=2", "density.warmup_steps=2",
    "density.refine_interval=2", "res_schedule.double_steps=2",
    "res_schedule.downscale_times=1", "background_init.capacity=262144"]
# the splat relaunched on one input, every launch bit-equal to the first:
# the train phase's captured input (R=1024) and one shaped like the SMPL
# quality protocol's first step (EnvLight R=64, 1,536 sky pixels with a
# cotangent, the top 16 rows of a 96 x 64 view)
SPLAT_REPEATS = 20
SPLAT_Q_RES, SPLAT_Q_W, SPLAT_Q_H, SPLAT_Q_SKY_ROWS = 64, 96, 64, 16
# tools.render on the cli phase's run: the test and full splits and a
# novel trajectory of RENDER_FRAMES frames
RENDER_TRAJ, RENDER_FRAMES = "front_center_interp", 60
# the PVG and DeformableGS backgrounds (their presets) on the omnire scene
# at full width: one step's gradients against the all-plain step, the step
# timed BACKGROUND_TIMED_STEPS times, a test view
BACKGROUNDS = (("pvg", "pvg"), ("deformgs", "deformablegs"))
BACKGROUND_TIMED_STEPS = 3
# the synthetic preset through the CLI at its full size (128 x 96, 3,000 of
# 8,192 background slots, SH 1, EnvLight 32) for its 200 steps with the
# live viewer on: a frame fetched once /stats reports step SYNTH_VIEW_STEP;
# then a resume from the checkpoint written after step 100
# (checkpoint_101), bit-equal to the uninterrupted run at step 200; the
# final background exported as a ply above SYNTH_PLY_ALPHA
SYNTH_STEPS, SYNTH_RESUME, SYNTH_HW = 200, 101, (96, 128)
SYNTH_VIEW_STEP, SYNTH_PLY_ALPHA = 20, 0.05
# proto_scene (96 x 64) loaded at half size by the port's resize with PIL
# blocked, the presets' 5 steps
DOWNSCALE_OVERRIDES = [o for o in CLI_PRESET_OVERRIDES
                       if not o.startswith("data.downscale")] + [
    "data.downscale=2"]
DOWNSCALE_HW = (32, 48)
# runs a module as __main__ with PIL made unimportable
NO_PIL = ("import runpy, sys; sys.modules['PIL'] = None; "
          "sys.argv = sys.argv[1:]; runpy.run_module(sys.argv[0], "
          "run_name='__main__', alter_sys=True)")
# the options of the JAX trainer that no YAML turns on, each beside
# omnire_bilateral on the omnire scene at full width: the overrides, the
# gradient leaves they add (each must have a gradient) and the splat's
# launches per step (0 without an EnvLight texture)
OPTION_VARIANTS = (
    ("sky_mlp", ["trainer.sky_model=mlp"], ("Sky/",), 0),
    ("sky_none", ["trainer.sky_model=none"], (), 0),
    ("voxel_deformer", ["trainer.use_voxel_deformer=true"],
     ("SMPLNodes/voxel_w_correction",), 1),
    ("regularisers", ["losses.rigid_temporal=0.01",
                      "background_reg.flatten={w: 0.01}",
                      "background_reg.sparse_reg={w: 0.01}",
                      "background_reg.max_s_square_reg={w: 0.01}"],
     ("RigidNodes/instances_quats", "RigidNodes/instances_trans"), 1))
OPTION_TIMED_STEPS = 3
OPTION_LOSSES = ("Background_flatten", "Background_sparse_reg",
                 "Background_max_s_square", "RigidNodes_temporal")
# LPIPS of two 533 x 300 renders on the card (float32, TF32 off) against
# the plain path on the CPU in float64, relative; LPIPS_REPEATS timed pairs
LPIPS_RTOL, LPIPS_REPEATS = 1e-4, 5
# the CLI from YAML files: a method file (omnire_bilateral with every
# option above) and a rig file for proto_scene, CLI_YAML_STEPS steps, a
# resume from checkpoint_CLI_YAML_RESUME bit-equal at the last step, eval
# with LPIPS weights
CLI_YAML_STEPS, CLI_YAML_RESUME = 50, 26
# the preprocess phase: tools/raw_scene.py's nuScenes log at the published
# sensor sizes (6 cameras at 1600 x 900, 34,720-point lidar sweeps, 3
# keyframes: 11 frames), converted by preprocess.cli with --device cuda and
# --device cpu side by side (PRE_KEYS, the ego-mask placeholders, then
# humanpose on both, sky_masks on the card with SegFormer-b5 at the
# published widths and random weights); SegFormer on one image in float32
# and float64 (logits within PRE_LOGIT_RTOL of the largest: ten times or
# less what the card reads, 3.17e-6, where TF32's 10-bit mantissa would
# give about 1e-3), timed over PRE_SEG_REPEATS images with nothing else
# running; the cuda tree trained PRE_TRAIN_STEPS steps by
# tools.train with omnire_ms_bilateral, SMPL on (the converted smpl.pkl,
# the synthetic body) and the nuscenes/3cams rig (533 x 300, test stride
# 10)
PRE_KEYS = ("images", "calib", "lidar", "dynamic_masks", "objects")
PRE_LOGIT_RTOL, PRE_SEG_REPEATS = 1e-5, 5
PRE_TRAIN_STEPS = 20
PRE_TRAIN_OVERRIDES = [
    "dataset=nuscenes/3cams", "trainer.use_smpl=true",
    "smpl.model_path=synthetic", f"trainer.max_steps={PRE_TRAIN_STEPS}",
    "logging.ckpt_every=1000000", "logging.log_every=10"]
# the parallel phase, on one card: NCCL at world size 1; a data-parallel
# step of omnire_bilateral's state at step TRAIN_STEP0 against train_step
# (bit-equal, else within PARALLEL_STEP_RTOL per leaf), a tile step (its
# parameters and its band path's gradients within GRADS_RTOL);
# image 0 as PARALLEL_BANDS bands through the per-band function, stitched
# within BAND_ATOL of the full render, the band-summed gradients within
# BAND_GRAD_RTOL; the CLI's parallel flags on the fixture for
# CLI_PRESET_STEPS steps (cut with cli_presets' depth) beside a plain run
PARALLEL_BANDS = (2, 4)
BAND_ATOL, BAND_GRAD_RTOL, PARALLEL_STEP_RTOL = 1e-4, 1e-4, 1e-6
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
FP32_OPS_PER_S = 67e12            # H100 SXM, outside the tensor cores
# The least work each kernel must do on its inputs, for its bound.
# Expansion reads table rows 0-14 of each Gaussian that has entries (row 15
# is padding; row 3, the segment start, is what the search in offsets finds)
# and writes key, gid and 10 features per entry.
EXPAND_ROWS_READ = 15
# Compositing, in f32 operations: per live entry and tile, the mean relative
# to the tile origin and the halved a and c (4); per live entry and pixel
# row of the tile, the least sigma along the row, where the row's pixels can
# pass the gate at all: dy, b dy, c/2 dy^2 - logop, the vertex clamped to
# the row and sigma there, the test (14); per (entry, pixel) pair in a row
# the entry may reach, dx, dy and sigma = dx (a/2 dx + b dy) + dy (c/2 dy)
# - logop (10), then exp, clamp and the 1/255 gate (3); per pair past the
# gate, the weight, 4 channels x (multiply, add) and the transmittance
# update (10). A pair in a row the entry cannot reach is one the gate drops:
# no work of the function needs it.
ENTRY_OPS, ROW_OPS, PAIR_OPS, BLEND_OPS = 4, 14, 13, 10
# csrc/rasterize_fwd.cu's row test: the gate passes only where sigma <=
# ln(255), and a row is left out only where its least sigma is above this
# plus 1e-5 of the terms' size
GATE_SIGMA = 5.5413 + 1e-3
# Compositing backward, in f32 operations: the forward's row tests (14)
# and, per (entry, pixel) pair in a row the entry may reach, the forward's
# sigma, exp, clamp and gate once (13); per pair past the gate
# G = colour . cotangent (9), the weight (1), the suffix bookkeeping (4),
# d_alpha (4), d_sigma (1), the six geometry terms (11), the four colour
# terms (4) and the ten sums over pixels (10).
BWD_BLEND_OPS = 44
FEAT_BYTES = 4 * 10                    # one entry's 10 feature rows
PIX_BYTES = 4 * 1024                   # one tile plane of f32


class SmokeError(RuntimeError):
    pass


def check(cond, what: str):
    if not cond:
        raise SmokeError(what)


def phase(name: str, t0: float, **result):
    print(f"phase {name}: {json.dumps(result)} ({time.perf_counter() - t0:.2f} s)",
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def patched(*changes):
    """Set (object, attribute, value) for a block. The pipeline reaches its
    kernels through its module references (expand_cuda, rasterize_cuda,
    segsum_cuda) and the cube-map backward through cubemap.cubemap_cuda,
    so replacing those points every kernel call at a stand-in."""
    real = [(obj, name, getattr(obj, name)) for obj, name, _ in changes]
    for obj, name, value in changes:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in real:
            setattr(obj, name, value)


def plain_scans():
    """binning's scan_utils with the scan's plain version in place of the
    kernel."""
    from bilateral_driving_tpu_torch.ops import scan_cuda

    def scan(op):
        return lambda x: scan_cuda.scan_rows_plain(x[None], op)[0]

    return types.SimpleNamespace(cumsum=scan("sum"), cummax=scan("max"),
                                 cummin=scan("min"))


def kernels_replaced(pipeline, binning, expand_gather, rasterize_fwd,
                     scans):
    """Point the pipeline's two render kernel calls and binning's prefix
    scans (`scans`: a stand-in for ops.scan_utils) at stand-ins."""
    return patched(
        (pipeline, "expand_cuda",
         types.SimpleNamespace(expand_gather=expand_gather)),
        (pipeline, "rasterize_cuda",
         types.SimpleNamespace(rasterize_fwd=rasterize_fwd)),
        (binning, "scan_utils", scans))


def capturing(captured, name, fn):
    """fn, recording the arguments of its first call under `name`."""
    def wrapped(*a, **kw):
        captured.setdefault(name, (a, kw))
        return fn(*a, **kw)
    return wrapped


def pipeline_captured(captured):
    """Route the pipeline's and the cube map's kernel calls through
    stand-ins that record, under each kernel's name, the arguments of its
    first call (the compositing forward's first with residuals) and then
    call the kernel."""
    from bilateral_driving_tpu_torch.ops import (binning, cubemap,
                                                 cubemap_cuda, expand_cuda,
                                                 pipeline, rasterize_cuda,
                                                 scan_utils, segsum_cuda)

    return patched(
        (pipeline, "expand_cuda", types.SimpleNamespace(
            expand_gather=capturing(captured, "expand",
                                    expand_cuda.expand_gather))),
        (pipeline, "rasterize_cuda", types.SimpleNamespace(
            rasterize_fwd=capturing_residuals(captured),
            rasterize_bwd=capturing(captured, "rasterize_bwd",
                                    rasterize_cuda.rasterize_bwd))),
        (pipeline, "segsum_cuda", types.SimpleNamespace(
            segment_sum=capturing(captured, "segment_sum",
                                  segsum_cuda.segment_sum))),
        (cubemap, "cubemap_cuda", types.SimpleNamespace(
            splat_grad=capturing(captured, "splat_grad",
                                 cubemap_cuda.splat_grad))),
        (binning, "scan_utils", types.SimpleNamespace(
            cumsum=capturing(captured, "scan", scan_utils.cumsum),
            cummax=scan_utils.cummax)))


def capturing_residuals(captured):
    """The compositing forward, recording under "rasterize_fwd" the
    arguments of its first call with residuals (a training step's)."""
    from bilateral_driving_tpu_torch.ops import rasterize_cuda

    def wrapped(*a, **kw):
        if kw.get("residuals"):
            captured.setdefault("rasterize_fwd", (a, kw))
        return rasterize_cuda.rasterize_fwd(*a, **kw)
    return wrapped


def rel_norm(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def row_rel_norms(a, b) -> list:
    """rel_norm of each row of the leading axis."""
    return [rel_norm(a[r], b[r]) for r in range(b.shape[0])]


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def device_ms(fn, reps: int = 20):
    """Device time of one call of fn apart from the host's: the profiler's
    device events (kernels, fills, copies) of `reps` calls after a warm-up,
    summed and divided by reps; with the names of those events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    return (total / reps if total else "not measured",
            sorted(e.key[:60] for e in events))


def timed(name, source, replaces, launches, err, fn, plain, lib, nbytes,
          nops, plain_reps: int = 3) -> dict:
    """One entry of the `kernels` line: the kernel's, its plain version's
    and its library call's times, device times and bound."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * nops / FP32_OPS_PER_S
    dev_ms, events = device_ms(fn)
    lib_dev_ms, lib_events = (None, None) if lib is None else device_ms(lib)
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err,
        "ms": cuda_ms(fn, 20),
        "plain_ms": cuda_ms(plain, plain_reps),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None if lib is None else cuda_ms(lib, 20),
        "device_ms": dev_ms, "device_events": events,
        "library_device_ms": lib_dev_ms, "library_device_events": lib_events,
    }


def device_profile(fn, median_ms: float) -> dict:
    """Device busy time, idle share of `median_ms`, device operation count
    and top device items of one call of fn under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t1)
    # device-side events only (kernels, copies): the operator events above
    # them carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    return dict(
        profiled_ms=round(wall_ms, 3),
        device_busy_ms=round(busy_ms, 3) if busy_ms else "not measured",
        device_ops=sum(e.count for e in events),
        device_idle_share_of_median=(round(1.0 - busy_ms / median_ms, 4)
                                     if busy_ms else "not measured"),
        top_device_ms=[[e.key[:70], round(e.self_device_time_total / 1e3, 3),
                        e.count] for e in top])


def snapshot(state):
    """A copy of a training state, its generator apart (torch.Generator
    does not copy)."""
    return copy.deepcopy({f.name: getattr(state, f.name)
                          for f in dataclasses.fields(state)
                          if f.name != "generator"})


def restore(saved, generator):
    """A fresh training state from a snapshot; the optimizer of the copy
    holds the copy's parameters."""
    from bilateral_driving_tpu_torch.train import trainer

    return trainer.TrainerState(**copy.deepcopy(saved), generator=generator)


def tile_live_entries(starts, counts, n_live):
    """(n_tiles,) int64 entries of each tile's range inside its live
    chunks."""
    import torch

    start = starts.long()
    live_end = torch.minimum(
        start + counts.long(),
        (torch.div(start, 128, rounding_mode="floor") + n_live.long()) * 128)
    return torch.clamp(live_end - start, min=0)


def edge_tiles(dev, seed: int):
    """Compositing inputs built to reach the kernels' edges, one tile each
    of a 192 x 32 image: a tile with no entries (0 live chunks), a range
    that starts mid-chunk and shares its last chunk with the next tile, a
    tile of 204 live chunks (its Gaussians leave a strip of pixels
    uncovered, so it never stops), a tile whose every pair the 1/255 gate
    drops, an opaque tile that stops after 2 of its 16 chunks, and a tile
    whose stop falls on its last chunk (faint Gaussians the gate drops,
    then opaque ones filling the last chunk). Returns (feats, starts,
    counts, width, height, a cotangent for the backward)."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 4)
    # (count, mean x range, scale range, opacity range) per tile; the
    # ranges follow one another from entry 64
    tiles = [(0, None, None, None),
             (300, (-4.0, 36.0), (1.5, 8.0), (0.05, 0.95)),
             (26_000, (0.0, 12.0), (1.5, 3.0), (0.3, 0.95)),
             (500, (-4.0, 36.0), (1.5, 8.0), (0.001, 0.003)),
             (2000, (-4.0, 36.0), (4.5, 24.0), (0.9, 0.999)),
             (400, (-4.0, 36.0), (24.0, 48.0), (0.001, 0.003))]
    width, height = 32 * len(tiles), 32
    starts, pos = [], 64
    for n, *_ in tiles:
        starts.append(pos)
        pos += n
    cap = -(-pos // 128) * 128 + 128
    feats = torch.zeros((10, cap), device=dev)
    feats[5] = -30.0

    def uniform(lo, hi, n):
        return lo + (hi - lo) * torch.rand(n, generator=gen, device=dev)

    for t, (n, mx, sc_r, op_r) in enumerate(tiles):
        if n == 0:
            continue
        s = slice(starts[t], starts[t] + n)
        sc = uniform(*sc_r, n)
        feats[0, s] = 32 * t + uniform(*mx, n)
        feats[1, s] = uniform(-4.0, 36.0, n) if t != 2 else uniform(0, 32, n)
        feats[2, s] = 1 / sc ** 2
        feats[3, s] = uniform(-0.3, 0.3, n) / sc ** 2
        feats[4, s] = 1 / sc ** 2
        feats[5, s] = torch.log(uniform(*op_r, n))
        feats[6:9, s] = torch.rand((3, n), generator=gen, device=dev)
        feats[9, s] = torch.sort(uniform(1.0, 50.0, n)).values
    # the last tile's last chunk: opaque Gaussians near its centre
    last = slice((starts[5] + tiles[5][0] - 1) // 128 * 128,
                 starts[5] + tiles[5][0])
    n_last = last.stop - last.start
    feats[0, last] = 32 * 5 + uniform(8.0, 24.0, n_last)
    feats[1, last] = uniform(8.0, 24.0, n_last)
    feats[5, last] = torch.log(uniform(0.9, 0.999, n_last))
    st = torch.tensor(starts, dtype=torch.int32, device=dev)
    cn = torch.tensor([n for n, *_ in tiles], dtype=torch.int32, device=dev)
    gout = torch.randn((len(tiles), 5, 1024), generator=gen, device=dev)
    return feats, st, cn, width, height, gout


def bwd_edge_cases(dev, seed: int) -> dict:
    """The compositing backward on edge_tiles, from the forward kernel's
    residuals. Launched twice (bit-equal) and held against its plain
    version per output row; returns what it measured."""
    import torch

    from bilateral_driving_tpu_torch.ops import rasterize_cuda

    feats, st, cn, width, height, gout = edge_tiles(dev, seed)
    starts = st.tolist()
    tiles = cn.tolist()
    cap = feats.shape[1]
    img, n_live, ckpt_off, ckpt = rasterize_cuda.rasterize_fwd(
        feats, st, cn, width, height, residuals=True)
    check(torch.equal(n_live, rasterize_cuda.rasterize_fwd_plain(
        feats, st, cn, width, height).n_live),
          "edge cases: the forward kernel stops tiles elsewhere than its "
          "plain version")
    nch = rasterize_cuda._chunk_counts(st, cn)[3]
    nl = n_live.tolist()
    # the last tile composites every chunk, went on after its next-to-last
    # (its last checkpoint has a pixel above 1e-4) and ends below 1e-4
    check(nl[0] == 0 and nl[2] >= 200 and nl[3] == int(nch[3])
          and nl[4] < int(nch[4]) and starts[1] % 128
          and (starts[2] - 1) // 128 == starts[2] // 128
          and nl[5] == int(nch[5]) >= 2
          and float(ckpt[int(ckpt_off[5]) + nl[5] - 1].max()) > 1e-4
          and float((1.0 - img[5, 4]).max()) <= 1.1e-4,
          f"edge cases do not reach their edges: n_live {nl}, chunks "
          f"{nch.tolist()}")
    args = (feats, st, cn, n_live, ckpt_off, ckpt, gout, width, height)
    got = [rasterize_cuda.rasterize_bwd(*args) for _ in range(2)]
    want = rasterize_cuda.rasterize_bwd_plain(*args)
    check(torch.equal(got[0], got[1]),
          "compositing backward differs between two launches: edge cases")
    rels = row_rel_norms(got[0], want)
    check(max(rels) <= BWD_RTOL, f"compositing backward differs from its "
          f"plain version on the edge cases (row relative norms {rels})")
    dropped = slice(starts[3], starts[3] + tiles[3])
    live = torch.zeros(cap, dtype=torch.bool, device=dev)
    for s0, n in zip(starts, tile_live_entries(st, cn, n_live).tolist()):
        live[s0:s0 + n] = True
    check(not bool(got[0][:, dropped].any())
          and not bool(got[0][:, ~live].any()),
          "compositing backward wrote a gradient where the gate dropped "
          "every pair or past the live chunks")
    return {"n_live": nl, "row_rel_norms": [float(f"{x:.3g}") for x in rels],
            "max_abs_err": float((got[0] - want).abs().max()),
            "bit_equal_across_launches": True}


def live_slots(ckpt_off, n_live, slots: int):
    """(slots,) bool: the checkpoint slots of the tiles' live chunks (the
    only ones the forward writes for certain and the backward reads)."""
    import torch

    live = torch.zeros(slots, dtype=torch.bool, device=n_live.device)
    for off, n in zip(ckpt_off.tolist(), n_live.tolist()):
        live[off:off + n] = True
    return live


def forward_check(name: str, feats, starts, counts, width: int,
                  height: int) -> dict:
    """The compositing forward on one input, each of its two instances
    launched twice: the image bit-equal across all four launches, n_live
    and the live checkpoints across the two with residuals; against its
    plain version n_live equal, the image and the live checkpoints within
    RASTER_ATOL + RASTER_RTOL. Returns what it measured and the plain
    version's result."""
    import torch

    from bilateral_driving_tpu_torch.ops import rasterize_cuda

    args = (feats, starts, counts, width, height)
    imgs = [rasterize_cuda.rasterize_fwd(*args) for _ in range(2)]
    res = [rasterize_cuda.rasterize_fwd(*args, residuals=True)
           for _ in range(2)]
    plain = rasterize_cuda.rasterize_fwd_plain(*args)
    img, n_live, ckpt_off, ckpt = res[0]
    live = live_slots(ckpt_off, n_live, ckpt.shape[0])
    check(all(torch.equal(imgs[0], x) for x in (imgs[1], res[0][0],
                                                 res[1][0]))
          and torch.equal(n_live, res[1][1])
          and torch.equal(ckpt[live], res[1][3][live]),
          f"compositing forward differs between launches: {name}")
    check(bool(torch.isfinite(img).all()),
          f"compositing forward not finite: {name}")
    check(torch.equal(n_live, plain.n_live), f"compositing forward stops "
          f"tiles elsewhere than its plain version: {name}")
    err = (img - plain.img).abs()
    ckpt_err = (ckpt[live] - plain.ckpt[live]).abs()
    check(bool(torch.all(err <= RASTER_ATOL + RASTER_RTOL * plain.img.abs()))
          and bool(torch.all(ckpt_err <= RASTER_ATOL
                             + RASTER_RTOL * plain.ckpt[live].abs())),
          f"compositing forward differs from its plain version: {name} "
          f"(max abs err {float(err.max())})")
    return {"max_abs_err": float(err.max()),
            "ckpt_max_abs_err": float(ckpt_err.max()) if live.any() else 0.0,
            "live_chunks": int(n_live.sum()),
            "bit_equal_across_launches_and_instances": True}, plain


def live_chunk_spread(starts, counts, n_live) -> dict:
    """The live chunks per tile: the heaviest tile's walk bounds a kernel
    that walks each tile's chunks in turn."""
    import torch

    tile_live = tile_live_entries(starts, counts, n_live)
    nl = n_live.long()
    heavy = int(torch.argmax(tile_live))
    return {"tiles": int(nl.numel()), "live_chunks": int(nl.sum()),
            "n_live_max": int(nl.max()),
            "n_live_mean": round(float(nl.float().mean()), 3),
            "tiles_with_no_live_chunk": int((nl == 0).sum()),
            "heaviest_tile": heavy,
            "heaviest_tile_live_entries": int(tile_live[heavy]),
            "heaviest_tile_n_live": int(nl[heavy]),
            "live_entries": int(tile_live.sum())}


def may_reach_rows(mx, my, ha, b, hc, lg):
    """(n, 32) bool: csrc/rasterize_fwd.cu's may_reach of n entries, from
    their prepared f32 values (mean relative to the tile origin, a/2, b,
    c/2, logop), for each of the tile's 32 pixel rows: the least of
    sigma's quadratic along the row, in float64, against the gate plus
    1e-5 of the terms' size; an entry with a value that is not finite may
    reach every row."""
    import torch

    mx, my, ha, b, hc, lg = (x.double()[:, None]
                             for x in (mx, my, ha, b, hc, lg))
    finite = (torch.isfinite(mx) & torch.isfinite(my) & torch.isfinite(ha)
              & torch.isfinite(b) & torch.isfinite(hc) & torch.isfinite(lg))
    py = torch.arange(32, dtype=torch.float64, device=mx.device) + 0.5
    dy = py - my
    lo, hi = 0.5 - mx, 31.5 - mx
    qa, qb, qc = ha, b * dy, hc * dy * dy - lg
    least = torch.minimum((qa * lo + qb) * lo + qc, (qa * hi + qb) * hi + qc)
    x = -qb / (2.0 * qa)
    inner = (qa > 0) & (x > lo) & (x < hi)
    least = torch.where(inner, torch.minimum(least, (qa * x + qb) * x + qc),
                        least)
    d = torch.maximum(lo.abs(), hi.abs())
    size = qa.abs() * d * d + hc.abs() * dy * dy + qb.abs() * d + lg.abs()
    return ~finite | ~(least > GATE_SIGMA + 1e-5 * size)


def compositing_work(feats, starts, counts, n_live, width: int,
                     blend_pairs: int, entry_ops: int,
                     blend_ops: int) -> dict:
    """The operations compositing must do on these inputs, for its bound:
    entry_ops per live entry (its tile's range inside the live chunks),
    ROW_OPS per live entry and pixel row, PAIR_OPS per (entry, pixel) pair
    in the rows may_reach_rows keeps, blend_ops per pair past the gate.
    `live_pairs` counts every live (entry, pixel) pair, the count the
    bound used before rows were left out."""
    import torch

    ntx = -(-width // 32)
    live = tile_live_entries(starts, counts, n_live)
    n = int(live.sum())
    tile = torch.repeat_interleave(
        torch.arange(live.numel(), device=live.device), live)
    first = torch.repeat_interleave(starts.long() - (torch.cumsum(live, 0)
                                                     - live), live)
    idx = first + torch.arange(n, device=live.device)
    rows = 0
    for s in range(0, n, 1 << 16):
        i, t = idx[s:s + (1 << 16)], tile[s:s + (1 << 16)]
        f = feats[:6, i]
        rows += int(may_reach_rows(
            f[0] - (t % ntx * 32).float(),
            f[1] - (torch.div(t, ntx, rounding_mode="floor") * 32).float(),
            0.5 * f[2], f[3], 0.5 * f[4], f[5]).sum())
    reach_pairs = rows * 32
    return {"live_entries": n, "row_tests": n * 32,
            "reach_pairs": reach_pairs, "live_pairs": n * 1024,
            "blend_pairs": blend_pairs,
            "ops": (n * entry_ops + n * 32 * ROW_OPS + reach_pairs * PAIR_OPS
                    + blend_pairs * blend_ops)}


def expand_table(gen, n: int, ntx: int, nty: int, live: int,
                 max_span: int, cap: int, dev):
    """A per-Gaussian table (16, n) as the pipeline builds it, its offsets
    (n + 1,) clamped to cap and num_isects (int32, before truncation):
    spans of up to max_span x max_span tiles of an ntx x nty grid, `live`
    Gaussians at random with entries."""
    import torch

    def randint(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, device=dev)

    tx0, ty0 = randint(ntx, n), randint(nty, n)
    sw = torch.minimum(randint(max_span, n) + 1, ntx - tx0)
    sh = torch.minimum(randint(max_span, n) + 1, nty - ty0)
    counts = sw * sh
    counts[torch.randperm(n, generator=gen, device=dev)[live:]] = 0
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    num_isects = offsets[-1].int()
    offsets = torch.clamp(offsets, max=cap).int()
    table = torch.randn((16, n), generator=gen, device=dev)
    table[0], table[1], table[2] = tx0.float(), ty0.float(), sw.float()
    table[3] = offsets[:-1].float()
    table[13] = 0.5 + 49.5 * torch.rand(n, generator=gen, device=dev)
    table[14] = torch.arange(n, device=dev).float()
    table[15] = 0.0
    return table, offsets, num_isects


def expand_check(name: str, args) -> dict:
    """The expansion on one input, launched twice: bit-equal between the
    launches and to its plain version. Returns its entries, capacity and
    largest difference from the plain version (keys and gids as
    integers, features where not both NaN)."""
    import torch

    from bilateral_driving_tpu_torch.ops import expand_cuda

    got = [expand_cuda.expand_gather(*args) for _ in range(2)]
    want = expand_cuda.expand_gather_plain(*args)
    bits = lambda xs: [x.view(torch.int32) for x in xs]
    check(all(torch.equal(a, b) for a, b in zip(bits(got[0]), bits(got[1]))),
          f"expansion differs between two launches: {name}")
    (k1, g1, f1), (k2, g2, f2) = got[0], want
    err = max([float((k1.long() - k2.long()).abs().max()),
               float((g1.long() - g2.long()).abs().max()),
               float(torch.where(torch.isnan(f1) & torch.isnan(f2),
                                 0.0, (f1 - f2).abs()).max())]
              if k1.numel() else [0.0])
    check(all(torch.equal(a, b) for a, b in zip(bits(got[0]), bits(want))),
          f"expansion differs from its plain version: {name} (max abs err "
          f"{err})")
    return {"gaussians": int(args[1].numel()) - 1,
            "num_isects": int(args[2]), "capacity": int(args[3]),
            "max_abs_err": err}


def expand_cases(ea, dev, seed: int) -> dict:
    """The expansion on the main path's inputs and on edge cases, each
    as expand_check."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    ntx, n_tiles = ea[4], ea[5]
    nty = n_tiles // ntx
    cases = {"main path": ea}
    # Background capacity 512 with 300 live: the table that breaks the
    # JAX Pallas expansion kernel (ROADMAP.md)
    tab, off, ni = expand_table(gen, 512, ntx, nty, 300, 3, 1 << 20, dev)
    cases["sparse, 512 slots, 300 live"] = (
        tab, off, ni, -(-int(ni) // 128) * 128, ntx, n_tiles, 512)
    tab, off, ni = expand_table(gen, 50_000, ntx, nty, 15_000, 4, 1 << 24,
                                dev)
    total = int(ni)
    cases["num_isects 0"] = (tab, torch.zeros_like(off),
                             torch.zeros_like(ni), 4096, ntx, n_tiles,
                             50_000)
    cases["num_isects equal to cap"] = (tab, off, ni, total, ntx, n_tiles,
                                        50_000)
    half = total // 2
    cases["num_isects above cap"] = (tab, torch.clamp(off, max=half), ni,
                                     half, ntx, n_tiles, 50_000)
    # one Gaussian over 50 x 50 tiles (2,500 entries, three 1,024-entry
    # windows) between others of one to four tiles
    tab, off, ni = expand_table(gen, 3000, 64, 64, 1500, 2, 1 << 24, dev)
    tab[0:3, 1500] = torch.tensor([5.0, 7.0, 50.0], device=dev)
    counts = (off[1:] - off[:-1]).long()
    counts[1500] = 50 * 50
    off = torch.cat([off.new_zeros(1), torch.cumsum(counts, 0).int()])
    tab[3] = off[:-1].float()
    cases["one Gaussian over three windows"] = (
        tab, off, off[-1].clone(), -(-int(off[-1]) // 128) * 128, 64,
        64 * 64, 3000)
    tab, off, ni = expand_table(gen, 1, ntx, nty, 1, 4, 1 << 20, dev)
    cases["N = 1"] = (tab, off, ni, 128, ntx, n_tiles, 1)
    out = {name: expand_check(name, args) for name, args in cases.items()}
    span = cases["one Gaussian over three windows"][1]
    check(int(span[1501] - span[1500]) == 2500
          and int(cases["num_isects above cap"][2])
          > cases["num_isects above cap"][3], "expansion edge cases do not "
          "reach their edges")
    return out


def segsum_edge_cases(offs_main, cap_main: int, dev, seed: int) -> dict:
    """The segment sums on edge cases, each launched twice (bit-equal) and
    held against its plain version per output row; returns each case's
    largest row relative norm. Payloads are standard normal but for the
    long segment's."""
    import torch

    from bilateral_driving_tpu_torch.ops import segsum_cuda

    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    n_main = offs_main.shape[0] - 1

    def offsets(counts, cap):
        return torch.clamp(torch.cat([counts.new_zeros(1),
                                      torch.cumsum(counts, 0)]),
                           max=cap).int()

    def data(n_rows, cap):
        return torch.randn((n_rows, cap), generator=gen, device=dev)

    # one Gaussian owning 100,000 entries among the main path's count of
    # Gaussians, 85% of them empty and the rest owning 1-8 entries. Its
    # payloads are multiples of 1/64 in [-1, 1], whose sums float32 holds
    # exactly in any order: a float32 sum of 100,000 standard normal terms
    # rounds by about 1e-5 of its size, which the plain version's atomic
    # adds would bring into the comparison
    c = torch.randint(1, 9, (n_main,), generator=gen, device=dev)
    c[torch.rand(n_main, generator=gen, device=dev) < 0.85] = 0
    c[n_main // 2] = 100_000
    long_offs = offsets(c, int(c.sum()))
    long_data = torch.randint(-64, 65, (10, int(long_offs[-1])),
                              generator=gen, device=dev).float() / 64
    c = torch.randint(0, 5, (1_000_003,), generator=gen, device=dev)
    odd_offs = offsets(c, int(c.sum()))
    c = torch.randint(0, 7, (200_003,), generator=gen, device=dev)
    clamp_cap = int(c.sum()) // 2
    clamp_offs = offsets(c, clamp_cap)
    check(int((clamp_offs == clamp_cap).sum()) > 1000,
          "the clamped case has no truncated segments")
    empty_offs = torch.zeros(n_main + 1, dtype=torch.int32, device=dev)
    main16 = data(16, cap_main)
    cases = [
        ("one Gaussian owning 100,000 entries", long_data, long_offs, None),
        ("1,000,003 Gaussians", data(10, int(odd_offs[-1])), odd_offs, None),
        ("offsets clamped at cap", data(10, clamp_cap), clamp_offs, None),
        ("every segment empty", data(10, 1024), empty_offs, None),
        ("segment_sum_rows at row0 6", long_data, long_offs, 6),
        ("1 input row", main16[:1], offs_main, None),
        ("16 input rows", main16, offs_main, None),
        ("segment_sum_rows, 1 row at row0 15", main16[:1], offs_main, 15),
        ("segment_sum_rows, 16 rows", main16, offs_main, 0)]
    out = {}
    for name, x, o, row0 in cases:
        if row0 is None:
            got = [segsum_cuda.segment_sum(x, o) for _ in range(2)]
            want = segsum_cuda.segment_sum_plain(list(x), o)
        else:
            got = [segsum_cuda.segment_sum_rows(list(x), o, row0=row0)
                   for _ in range(2)]
            want = segsum_cuda.segment_sum_plain(list(x), o,
                                                 segsum_cuda.OUT_ROWS, row0)
        check(torch.equal(got[0], got[1]),
              f"segment sums differ between two launches: {name}")
        rel = max(row_rel_norms(got[0], want))
        check(rel <= SUM_RTOL, f"segment sums differ from their plain "
              f"version: {name} (row relative norm {rel})")
        out[name] = rel
    check(not bool(segsum_cuda.segment_sum(data(10, 1024), empty_offs).any()),
          "empty segments do not sum to 0")
    return out


def quality_splat_input(dev, seed: int):
    """Splat arguments like the SMPL quality protocol's first step: the
    view directions of a SPLAT_Q_W x SPLAT_Q_H view (yawed and pitched
    from the seed) at EnvLight R=SPLAT_Q_RES, a cotangent on the top
    SPLAT_Q_SKY_ROWS rows (the sky) and 0 elsewhere."""
    import torch

    from bilateral_driving_tpu_torch.ops import cubemap

    g = torch.Generator().manual_seed(seed + 5)
    w, h, f = SPLAT_Q_W, SPLAT_Q_H, 0.9 * SPLAT_Q_W
    xs = (torch.arange(w) + 0.5 - w / 2) / f
    ys = (torch.arange(h) + 0.5 - h / 2) / f
    d = torch.stack(torch.broadcast_tensors(
        xs[None, :], ys[:, None], torch.ones(1, 1)), dim=-1)
    yaw, pitch = (float(a) for a in torch.rand(2, generator=g) - 0.5)
    cy, sy, cp, sp = math.cos(yaw), math.sin(yaw), math.cos(pitch), \
        math.sin(pitch)
    rot = torch.tensor([[cy, 0.0, sy], [0.0, 1.0, 0.0], [-sy, 0.0, cy]]) \
        @ torch.tensor([[1.0, 0.0, 0.0], [0.0, cp, -sp], [0.0, sp, cp]])
    face, u0, v0, fu, fv = cubemap.corner_data((d @ rot.T).to(dev),
                                               SPLAT_Q_RES)
    gout = torch.zeros((h, w, 3))
    gout[:SPLAT_Q_SKY_ROWS] = 1e-3 * torch.randn(
        (SPLAT_Q_SKY_ROWS, w, 3), generator=g)
    return (face, u0, v0, fu, fv, gout.reshape(-1, 3).to(dev), SPLAT_Q_RES)


def splat_repeats(name: str, pa) -> dict:
    """The splat launched SPLAT_REPEATS times on one input: every launch
    bit-equal to the first, within SUM_RTOL of its plain version per (face,
    channel) row, and equal bit for bit to the plain version's index_add_
    on the CPU (the order the kernel sums in); with the longest run of
    entries one texel sums."""
    import torch

    from bilateral_driving_tpu_torch.ops import cubemap_cuda

    first = cubemap_cuda.splat_grad(*pa)
    differ = [int((cubemap_cuda.splat_grad(*pa) != first).sum())
              for _ in range(SPLAT_REPEATS - 1)]
    check(not any(differ), f"splat differs between launches on {name}: "
          f"{differ} elements")
    splat_rows = lambda z: z.permute(0, 3, 1, 2).reshape(18, -1)
    rel = max(row_rel_norms(splat_rows(first),
                            splat_rows(cubemap_cuda.splat_grad_plain(*pa))))
    check(rel <= SUM_RTOL, f"splat differs from its plain version on {name} "
          f"(row relative norm {rel})")
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in pa]
    equal_cpu = torch.equal(first.cpu(), cubemap_cuda.splat_grad_plain(*cpu))
    check(equal_cpu, f"splat differs from index_add_ on the CPU: {name}")
    res = pa[-1]
    keys = cubemap_cuda.splat_keys_plain(pa[0], pa[1], pa[2], pa[5], res)
    live = keys[keys < 6 * res * res]
    runs = torch.unique(live, return_counts=True)[1]
    return {"launches": SPLAT_REPEATS, "differing_elements": differ,
            "row_rel_norm": rel, "equal_to_cpu_index_add": equal_cpu,
            "pixels": int(pa[0].shape[0]), "texture": res,
            "entries": int(live.numel()), "texels": int(runs.numel()),
            "longest_run": int(runs.max()) if runs.numel() else 0}


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by the name of its `kernels` entry;
    each counts its launches in `.launches`."""
    from bilateral_driving_tpu_torch.ops import (cubemap_cuda, expand_cuda,
                                                 rasterize_cuda, scan_cuda,
                                                 segsum_cuda)

    return {"expand": expand_cuda.expand_gather,
            "rasterize_fwd": rasterize_cuda.rasterize_fwd,
            "rasterize_bwd": rasterize_cuda.rasterize_bwd,
            "segment_sum": segsum_cuda.segment_sum,
            "segment_sum_rows": segsum_cuda.segment_sum_rows,
            "splat_grad": cubemap_cuda.splat_grad,
            "scan": scan_cuda.scan_rows}


# the training main path's kernels: its backward sums segments with
# segment_sum, never segment_sum_rows
TRAIN_PATH = ("expand", "rasterize_fwd", "rasterize_bwd", "segment_sum",
              "splat_grad", "scan")


# the render path's kernels
RENDER_PATH = ("expand", "rasterize_fwd", "scan")


def counts(wrappers) -> dict:
    return {k: f.launches for k, f in wrappers.items()}


def zero_launches(wrappers) -> dict:
    """Every wrapper's count, then every count set to 0."""
    now = counts(wrappers)
    for f in wrappers.values():
        f.launches = 0
    return now


def isect_capacity(cfg, state, full_statics, views, width, height, K):
    """The intersection capacity of a configuration: probe_num_isects of
    each (batch, in_test_set) view over its live Gaussians (dead slots
    never get entries), then autotune_capacity with a 10% margin. Returns
    (capacity, probes)."""
    from bilateral_driving_tpu_torch.ops import pipeline
    from bilateral_driving_tpu_torch.ops.camera import viewmat_from_c2w
    from bilateral_driving_tpu_torch.train import trainer

    probes = []
    for batch, test in views:
        merged, _ = trainer.collect_gaussians(
            cfg, state.params, full_statics, state.masks,
            batch["camera_to_world"][:3, 3], state.step, batch["frame_idx"],
            batch["normed_time"], test)
        live = merged.opacities > 0
        probes.append(pipeline.probe_num_isects(
            merged.means[live], merged.quats[live], merged.scales[live],
            viewmat_from_c2w(batch["camera_to_world"]), K, width, height,
            pipeline.RasterizeConfig(near_plane=cfg.near_plane,
                                     far_plane=cfg.far_plane)))
    return pipeline.autotune_capacity(max(probes), margin=1.1), probes


def train_path(prefix, args, cfg, scene, state, statics, dev, images):
    """The training phases of one configuration on its synthetic state,
    each named with `prefix`: targets, grads, train (a step on each of
    `images`, from step TRAIN_STEP0), train_steps, train_profile. Returns
    (the first main-path arguments of each kernel, the launches of the
    train run, its steps)."""
    import torch

    from bilateral_driving_tpu_torch import configs
    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.train import trainer

    wrappers = kernel_wrappers()
    smpl_verts = (state.masks["SMPLNodes"].shape[0]
                  // scene.inst["SMPLNodes"]["trans"].shape[1]
                  if cfg.use_smpl else 0)

    # ---- targets: renders of a second state drawn from another seed
    t0 = time.perf_counter()
    g2 = torch.Generator().manual_seed(args.seed + 1)
    other, other_statics = synthetic.random_state(
        scene, cfg, g2, configs.FLAGSHIP_BG_CAPACITY, TRAIN_STEP0,
        device=dev, smpl_verts=smpl_verts)
    gpick = torch.Generator(device=dev).manual_seed(args.seed + 2)
    batches = []
    with torch.no_grad():
        for idx in images:
            b = synthetic.make_batch(scene, idx)
            o = trainer.forward(cfg, other.params,
                                trainer.merge_statics(other_statics,
                                                      other.aux),
                                other.masks, b, TRAIN_STEP0)
            alpha = o["opacity"][..., 0]
            hit = (alpha > 0.5) & (torch.rand(alpha.shape, generator=gpick,
                                              device=dev) < 0.05)
            batches.append(synthetic.make_batch(
                scene, idx, torch.clamp(o["rgb"], 0.0, 1.0), 1.0 - alpha,
                torch.where(hit, o["depth"][..., 0],
                            torch.zeros_like(alpha))))
    del other, other_statics
    torch.cuda.synchronize()
    phase(f"{prefix}targets", t0, images=list(images),
          sky_share=[round(float(b["sky_masks"].mean()), 4)
                     for b in batches],
          lidar_points=[int((b["lidar_depth_map"] > 0).sum())
                        for b in batches])

    # ---- grads: the first step's gradients, kernels against plain
    # versions (later steps of this synthetic state are not compared: after
    # four steps at the deformation network's learning rate its scale head
    # has grown some DeformableNodes scales until their projection
    # overflows to NaN, in the JAX package's projection as in this one;
    # the cli_grads phase compares a trained state's steps past its
    # densification instead)
    t0 = time.perf_counter()
    tstate = trainer.init_state(
        cfg, state.params, state.masks, state.aux, step=TRAIN_STEP0,
        generator=torch.Generator(device=dev).manual_seed(args.seed))
    batch = batches[0]
    mid = counts(wrappers)
    _, _, _, g_k, gd_k = trainer.compute_grads(cfg, statics, tstate, batch)
    torch.cuda.synchronize()
    check(all(counts(wrappers)[k] > mid[k] for k in TRAIN_PATH),
          "the kernel step missed a kernel")
    mid = counts(wrappers)

    _, _, _, g_p, gd_p = plain_step_grads(cfg, statics, tstate, batch)
    torch.cuda.synchronize()
    check(counts(wrappers) == mid,
          "a kernel launched in the plain-version step")
    # the texture's gradient, as the step hands it to Adam, in the
    # texture's own layout
    base = tstate.params["Sky"]["base"]
    base_strides = {"param": list(base.stride()),
                    "grad": list(g_k["Sky/base"].stride())}
    check(base_strides["grad"] == base_strides["param"],
          f"the sky texture's gradient has other strides: {base_strides}")
    g_k["means2d"], g_p["means2d"] = gd_k, gd_p
    rels = {k: rel_norm(g_k[k], g_p[k]) for k in g_k}
    worst = max(rels, key=rels.get)
    zero = sorted(k for k in g_p if not bool(g_p[k].any()))
    phase(f"{prefix}grads", t0, leaves=len(rels), worst_leaf=worst,
          worst_rel_norm=rels[worst], tolerance=GRADS_RTOL,
          zero_leaves=zero, sky_base_strides=base_strides,
          rel_norm={k: float(f"{v:.3g}") for k, v in rels.items()
                    if "trunk" not in k},
          norm={k: float(f"{float(g_p[k].norm()):.3g}") for k in g_p
                if "trunk" not in k})
    check(rels[worst] <= GRADS_RTOL,
          f"gradient of {worst} differs from the plain step by "
          f"{rels[worst]}")
    check(not any(k.startswith(("SMPLNodes/", "Affine/", "CamPose"))
                  for k in zero),
          f"an SMPLNodes, Affine or CamPose leaf has no gradient: {zero}")
    del g_k, g_p, gd_k, gd_p

    # ---- train: the training main path, counters from 0
    t0 = time.perf_counter()
    captured = {}
    capture = pipeline_captured(captured)
    for f in wrappers.values():
        f.launches = 0
    before = counts(wrappers)
    steps, step_ms, saved = [], [], None
    with capture:
        for i, batch in enumerate(batches):
            step = tstate.step
            if i == 1:
                saved = snapshot(tstate)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tstate, m = trainer.train_step(cfg, statics, tstate, batch)
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t1))
            now = counts(wrappers)
            check(all(now[k] > before[k] for k in TRAIN_PATH),
                  f"a kernel did not launch in step {step}: {before} -> {now}")
            before = now
            vals = {k: float(v) for k, v in m.items()}
            check(all(math.isfinite(v) for v in vals.values()),
                  f"non-finite metric in step {step}: {vals}")
            check(vals["nonfinite_params"] == 0,
                  f"non-finite parameters after step {step}")
            check(vals["isect_overflow"] == 0, f"overflow in step {step}")
            refined = step % cfg.density.refine_interval == 0
            if refined:
                # SMPLNodes are not refined: their statistics run on
                check(all(not bool(st.vis_count.any())
                          for name, st in tstate.stats.items()
                          if name != "SMPLNodes"),
                      f"step {step} did not restart the statistics")
            if cfg.use_smpl:
                check(vals["num_points/SMPLNodes"]
                      == state.masks["SMPLNodes"].shape[0],
                      f"step {step} changed the SMPL point count")
            steps.append({"step": step, "refined": refined,
                          "loss": round(vals["loss"], 5),
                          "psnr": round(vals["psnr"], 3),
                          "num_isects": int(vals["num_isects"]),
                          "refine_dropped": int(vals["refine_dropped"]),
                          "num_points": {k[11:]: int(v) for k, v in
                                         vals.items()
                                         if k.startswith("num_points/")},
                          "losses": {k[5:]: round(v, 5) for k, v in
                                     vals.items() if k.startswith("loss/")}})
    launches = counts(wrappers)
    check(launches["segment_sum_rows"] == 0,
          "segment_sum_rows launched on the main path")
    check(any(s["refined"] for s in steps), "no refining step")
    check(set(captured) == {"expand", "rasterize_fwd", "rasterize_bwd",
                            "segment_sum", "splat_grad", "scan"},
          f"captured {sorted(captured)}")
    phase(f"{prefix}train", t0, steps=steps, launches=launches,
          ms_per_step=[round(x, 2) for x in step_ms])

    # ---- train_steps: the ordinary step 3399, each time from the state
    # saved before it
    t0 = time.perf_counter()
    ordinary_ms = []
    for _ in range(TIMED_STEPS):
        st = restore(saved, tstate.generator)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, m = trainer.train_step(cfg, statics, st, batches[1])
        torch.cuda.synchronize()
        ordinary_ms.append(1e3 * (time.perf_counter() - t1))
        check(abs(float(m["loss"]) - steps[1]["loss"]) <= 1e-4,
              "the restored step computed another loss")
        del st
    step_median = sorted(ordinary_ms)[len(ordinary_ms) // 2]
    first_ms, refine_ms = step_ms[0], step_ms[[s["refined"] for s in steps]
                                              .index(True)]
    phase(f"{prefix}train_steps", t0, step=TRAIN_STEP0 + 1,
          ms=[round(x, 3) for x in ordinary_ms],
          median_ms=round(step_median, 3),
          spread_ms=round(max(ordinary_ms) - min(ordinary_ms), 3),
          first_step_ms=round(first_ms, 3),
          refining_step_ms=round(refine_ms, 3))

    # ---- train_profile: the same step under the profiler
    t0 = time.perf_counter()
    st = restore(saved, tstate.generator)
    profiled = device_profile(
        lambda: trainer.train_step(cfg, statics, st, batches[1]),
        step_median)
    del st, saved
    phase(f"{prefix}train_profile", t0, step=TRAIN_STEP0 + 1, **profiled)
    return captured, launches, steps, batches


def plain_step_grads(cfg, statics, tstate, batch, time_offset=None):
    """trainer.compute_grads with every kernel reference of the pipeline
    pointed at its plain version."""
    from bilateral_driving_tpu_torch.ops import (binning, cubemap,
                                                 cubemap_cuda, expand_cuda,
                                                 pipeline, rasterize_cuda,
                                                 segsum_cuda)
    from bilateral_driving_tpu_torch.train import trainer

    def fwd_plain(f, st, c, w, h, residuals=False):
        o = rasterize_cuda.rasterize_fwd_plain(f, st, c, w, h)
        return (o.img, o.n_live, o.ckpt_off, o.ckpt) if residuals else o.img

    with patched(
            (pipeline, "expand_cuda", types.SimpleNamespace(
                expand_gather=expand_cuda.expand_gather_plain)),
            (pipeline, "rasterize_cuda", types.SimpleNamespace(
                rasterize_fwd=fwd_plain,
                rasterize_bwd=rasterize_cuda.rasterize_bwd_plain)),
            (pipeline, "segsum_cuda", types.SimpleNamespace(
                segment_sum=lambda d, o: segsum_cuda.segment_sum_plain(
                    list(d), o))),
            (cubemap, "cubemap_cuda", types.SimpleNamespace(
                splat_grad=cubemap_cuda.splat_grad_plain)),
            (binning, "scan_utils", plain_scans())):
        return trainer.compute_grads(cfg, statics, tstate, batch,
                                     time_offset=time_offset)


def tile_cover(sp, select, ntx: int, nty: int):
    """(nty, ntx) bool: the tiles the spans `sp` (binning.Spans) of the
    Gaussians in `select` (N,) bool touch."""
    import torch

    hit = select & (sp.counts > 0)
    x0, y0 = sp.tx0[hit].long(), sp.ty0[hit].long()
    x1 = x0 + sp.span_w[hit].long()
    y1 = y0 + torch.div(sp.counts[hit], sp.span_w[hit],
                        rounding_mode="floor").long()
    # a 2-D difference array: +1 at each span's corner, prefix sums over
    # both axes count the spans over each tile
    d = torch.zeros((nty + 1, ntx + 1), dtype=torch.int64,
                    device=sp.counts.device)
    for ys, xs, v in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
        d.index_put_((ys, xs), torch.full_like(ys, v), accumulate=True)
    return d.cumsum(0).cumsum(1)[:nty, :ntx] > 0


def instance_weights(cfg, state, full_statics, batch):
    """trainer.forward of one view with each rigid instance's visible
    weight (the share of the pixel's alpha its Gaussians composite) beside
    it, from renders of the same Gaussians coloured by three instance
    indicators at a time: the forward's outputs, the (I, H, W) weights and
    the render's spans arguments (means2d, radii, valid)."""
    import torch

    from bilateral_driving_tpu_torch.ops import binning, pipeline
    from bilateral_driving_tpu_torch.train import trainer

    n_bg = state.masks["Background"].shape[0]
    pid = full_statics["RigidNodes"]["point_ids"].long()
    n_inst = state.params["RigidNodes"]["instances_quats"].shape[1]
    weights, spans_args = [], {}

    def fn(means, quats, scales, opac, colors, viewmat, K, w, h, rcfg,
           **kw):
        inst = torch.full((means.shape[0],), -1, dtype=torch.long,
                          device=means.device)
        inst[n_bg:n_bg + pid.shape[0]] = pid
        for i0 in range(0, n_inst, 3):
            ind = torch.stack([(inst == i0 + c).to(colors.dtype)
                               for c in range(3)], dim=-1)
            rgb = pipeline.rasterize(means, quats, scales, opac, ind,
                                     viewmat, K, w, h, rcfg)["rgb"]
            weights.extend(rgb[..., c] for c in range(min(3, n_inst - i0)))
        with patched((binning, "spans",
                      capturing(spans_args, "spans", binning.spans))):
            return pipeline.rasterize(means, quats, scales, opac, colors,
                                      viewmat, K, w, h, rcfg, **kw)

    o = trainer.forward(cfg, state.params, full_statics, state.masks, batch,
                        state.step, rasterize_fn=fn)
    return o, torch.stack(weights), spans_args["spans"][0]


def edit_phase(cfg, data, state, statics, dev) -> dict:
    """The edit phase: the offline rigid-instance editing API and the
    standalone binning on the flagship state at full width. Returns the
    launches of the edited render and of bin_gaussians."""
    import torch

    from bilateral_driving_tpu_torch.ops import (binning, expand_cuda,
                                                 pipeline, rasterize_cuda)
    from bilateral_driving_tpu_torch.scene import rigid
    from bilateral_driving_tpu_torch.train import trainer

    t0 = time.perf_counter()
    full_statics = trainer.merge_statics(statics, state.aux)
    # the first train view in which two cars each cover EDIT_MIN_PIXELS
    # pixels with a visible weight above 0.5 (the synthetic scene's
    # clutter hides much of a car: its alpha alone overstates it)
    train_views = [i for i in range(data.num_images)
                   if i // NUM_CAMS == 0 or (i // NUM_CAMS) % TEST_STRIDE]
    best = []
    for idx in train_views:
        batch = data.get_batch(idx)
        # the view's own capacity where it has more entries than the
        # views the configuration's was probed on
        cap, _ = isect_capacity(cfg, state, full_statics, [(batch, False)],
                                WIDTH, HEIGHT, batch["intrinsics"])
        vcfg = dataclasses.replace(
            cfg, isect_capacity=max(cap, cfg.isect_capacity))
        o0, weights, spans0 = instance_weights(vcfg, state, full_statics,
                                               batch)
        cover = (weights > 0.5).sum((1, 2))
        top = torch.argsort(cover, descending=True)[:2].tolist()
        best.append((int(cover[top[1]]), idx))
        if best[-1][0] >= EDIT_MIN_PIXELS:
            break
    else:
        raise SmokeError("no train view shows two cars of "
                         f"{EDIT_MIN_PIXELS} pixels: (second car's pixels, "
                         f"view) {sorted(best)[-5:]}")
    removed, target = top
    donor = min(set(range(cover.numel())) - {removed, target})
    n_bg = state.masks["Background"].shape[0]
    rp, rs = state.params["RigidNodes"], full_statics["RigidNodes"]
    rm = state.masks["RigidNodes"]
    kept = (rm.clone(), rs["point_ids"].clone(), rp["means"].clone())
    p_e, s_e, m_e = rigid.replace_instances(rp, rs, rm, {target: donor})
    m_e = rigid.remove_instances(s_e, m_e, [removed])
    check(torch.equal(rm, kept[0]) and torch.equal(rs["point_ids"], kept[1])
          and torch.equal(rp["means"], kept[2]),
          "the editing API wrote into the state")
    pid_e = s_e["point_ids"]
    live = m_e > 0
    live_of = {i: int((live & (pid_e == i)).sum())
               for i in (removed, target, donor)}
    check(live_of[removed] == 0 and live_of[target] == live_of[donor]
          == int(((rm > 0) & (rs["point_ids"] == donor)).sum()),
          f"edited live counts {live_of}")
    params_e = {**state.params, "RigidNodes": p_e}
    statics_e = {**full_statics, "RigidNodes": s_e}
    masks_e = {**state.masks, "RigidNodes": m_e}

    # the edited render: kernels, counters from 0
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    captured = {}
    with patched((binning, "spans",
                  capturing(captured, "spans", binning.spans))):
        o1 = trainer.forward(vcfg, params_e, statics_e, masks_e, batch,
                             state.step)
    spans1 = captured["spans"][0]
    torch.cuda.synchronize()
    render_l = counts(wrappers)
    check(all(render_l[k] > 0 for k in RENDER_PATH)
          and all(render_l[k] == 0 for k in render_l
                  if k not in RENDER_PATH),
          f"the edited render's launches: {render_l}")
    # ... and through the plain versions
    with kernels_replaced(
            pipeline, binning, expand_cuda.expand_gather_plain,
            lambda *a: rasterize_cuda.rasterize_fwd_plain(*a).img,
            plain_scans()):
        o1p = trainer.forward(vcfg, params_e, statics_e, masks_e, batch,
                              state.step)
    check(counts(wrappers) == render_l,
          "a kernel launched in the plain edited render")
    errs = {k: float((o1[k] - o1p[k]).abs().max())
            for k in ("rgb", "opacity")}
    hit = o1p["opacity"] > 0.2
    errs["depth"] = float((o1["depth"] - o1p["depth"])[hit].abs().max())
    check(errs["rgb"] <= RENDER_ATOL and errs["opacity"] <= RENDER_ATOL
          and errs["depth"] <= DEPTH_ATOL,
          f"the edited render differs from its plain render: {errs}")
    check(int(o1["info"]["num_isects"]) == int(o1p["info"]["num_isects"])
          and not bool(o0["info"]["overflow"] | o1["info"]["overflow"]),
          "the edited render's num_isects differs from the plain render's, "
          "or a render overflowed")

    # the removed car's pixels changed. Tiles that no span of the removed
    # car, the replaced car or its copy touches keep their entries: where
    # a pixel of such a tile keeps a transmittance above the early stop's
    # STOP_T, the tile composites every entry in both renders (within
    # rounding: the plain version sums within 128-entry chunks); a
    # tile whose every pixel falls to STOP_T may stop one 128-entry chunk
    # earlier or later (its entries start at another place in the
    # chunks), which moves a pixel by at most STOP_T
    removed_px = weights[removed] > 0.5
    moved = (o1["rgb_gaussians"] - o0["rgb_gaussians"]).abs().amax(-1)
    changed = int((removed_px & (moved > EDIT_CHANGED)).sum())
    ntx, nty = binning.num_tiles(WIDTH, HEIGHT)
    sp1 = binning.spans(*spans1)
    n_all = sp1.counts.numel()

    def of(pid, m, ids):
        sel = torch.zeros(n_all, dtype=torch.bool, device=dev)
        sel[n_bg:n_bg + pid.numel()] = (m > 0) & torch.isin(
            pid, torch.tensor(ids, dtype=pid.dtype, device=dev))
        return sel

    near = (tile_cover(binning.spans(*spans0),
                       of(rs["point_ids"], rm, [removed, target]), ntx, nty)
            | tile_cover(sp1, of(pid_e, m_e, [target]), ntx, nty))

    def per_pixel(t):
        return t.repeat_interleave(binning.TILE, 0).repeat_interleave(
            binning.TILE, 1)[:HEIGHT, :WIDTH]

    def saturated(o):
        pad = torch.ones((nty * binning.TILE, ntx * binning.TILE),
                         device=dev)
        pad[:HEIGHT, :WIDTH] = o["opacity"][..., 0]
        return (1.0 - pad).view(nty, binning.TILE, ntx, binning.TILE).amax(
            (1, 3)) <= rasterize_cuda.STOP_T

    sat = saturated(o0) | saturated(o1)
    far = {}
    stop_t = rasterize_cuda.STOP_T
    for name, tiles, bound in (("open", ~near & ~sat, RENDER_ATOL),
                               ("saturated", ~near & sat, stop_t)):
        px = per_pixel(tiles)
        far[name] = {"tiles": int(tiles.sum()), "pixels": int(px.sum()),
                     "bound": bound}
        for k in ("rgb_gaussians", "opacity"):
            d = (o1[k] - o0[k])[px].abs()
            far[name][k] = float(d.max()) if d.numel() else 0.0
            check(far[name][k] <= bound, f"the image away from the edited "
                  f"cars moved in {name} tiles: {far[name]}")
    check(changed >= EDIT_CHANGED_SHARE * int(removed_px.sum()),
          f"{changed} of the removed car's {int(removed_px.sum())} pixels "
          "changed")

    # bin_gaussians on the edited render's projection, on the card and on
    # the CPU
    m2d, radii, valid = spans1[:3]
    depths = o1["info"]["depths"]
    zero_launches(wrappers)
    isect = binning.bin_gaussians(m2d, radii, depths, valid, WIDTH, HEIGHT,
                                  vcfg.isect_capacity)
    torch.cuda.synchronize()
    bin_l = counts(wrappers)
    check(bin_l["scan"] >= 2 and all(
        v == 0 for k, v in bin_l.items() if k != "scan"),
          f"bin_gaussians' launches: {bin_l}")
    n_isects = int(isect.num_isects)
    check(n_isects == int(o1["info"]["num_isects"])
          and not bool(isect.overflow)
          and int(isect.tile_counts.long().sum()) == n_isects,
          f"bin_gaussians: {n_isects} entries, overflow "
          f"{bool(isect.overflow)}, tile counts summing to "
          f"{int(isect.tile_counts.long().sum())}; the render: "
          f"{int(o1['info']['num_isects'])}")
    gids = isect.gauss_ids[:n_isects]
    check(torch.equal(gids, o1["info"]["gauss_ids"][:n_isects]),
          "bin_gaussians' entries differ from the render's sorted entries")
    gone = n_bg + torch.nonzero(pid_e == removed)[:, 0]
    check(not bool(torch.isin(gids, gone.to(gids.dtype)).any()),
          "an entry carries a Gaussian of the removed car")
    cpu = binning.bin_gaussians(m2d.cpu(), radii.cpu(), depths.cpu(),
                                valid.cpu(), WIDTH, HEIGHT,
                                vcfg.isect_capacity)
    same = {k: torch.equal(getattr(isect, k).cpu(), getattr(cpu, k))
            for k in ("tile_counts", "tile_starts", "offsets", "num_isects",
                      "overflow", "isect_tile")}
    same["gauss_ids"] = torch.equal(gids.cpu(), cpu.gauss_ids[:n_isects])
    check(all(same.values()), f"bin_gaussians on the card and on the CPU "
          f"differ: {same}")
    phase("edit", t0, image=idx, isect_capacity=vcfg.isect_capacity,
          removed=removed, replaced=target,
          donor=donor, cover_pixels=cover.tolist(), live=live_of,
          max_abs_err=errs, tolerance={"rgb_alpha": RENDER_ATOL,
                                       "depth_alpha_0.2": DEPTH_ATOL},
          removed_pixels=int(removed_px.sum()), removed_changed=changed,
          near_tiles=int(near.sum()), tiles=ntx * nty, far=far,
          num_isects=n_isects, launches=render_l, bin_launches=bin_l,
          bin_bit_equal_cpu=sorted(same))
    return {"render": render_l, "bin_gaussians": bin_l}


def training(args, cfg, scene, state, statics, dev):
    """The flagship's training phases (targets .. train_times); returns
    the four training kernels' entries of the `kernels` line and the
    train run's scan launches per step."""
    import torch

    from bilateral_driving_tpu_torch.ops import (cubemap_cuda, pipeline,
                                                 rasterize_cuda, segsum_cuda)

    captured, launches, steps, _ = train_path("", args, cfg, scene, state,
                                           statics, dev, TRAIN_IMAGES)
    # ---- train_kernels: each training kernel against its plain version
    t0 = time.perf_counter()
    ba = captured["rasterize_bwd"][0]
    d_k = rasterize_cuda.rasterize_bwd(*ba)
    d_p = rasterize_cuda.rasterize_bwd_plain(*ba)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(d_k).all()), "backward kernel not finite")
    bwd_rel = max(row_rel_norms(d_k, d_p))
    bwd_err = float((d_k - d_p).abs().max())
    check(bwd_rel <= BWD_RTOL, f"compositing backward kernel differs from "
          f"its plain version (row relative norm {bwd_rel})")
    check(torch.equal(rasterize_cuda.rasterize_bwd(*ba), d_k),
          "compositing backward differs between two launches on its "
          "main-path input")
    # entries outside every tile's live chunks keep exactly 0
    tile_live = tile_live_entries(ba[1], ba[2], ba[3])
    live_mask = torch.zeros(d_k.shape[1], dtype=torch.bool, device=dev)
    for lo, n in zip(ba[1].tolist(), tile_live.tolist()):
        live_mask[lo:lo + n] = True
    check(not bool(d_k[:, ~live_mask].any()),
          "backward kernel wrote past a tile's live chunks")
    live_spread = live_chunk_spread(ba[1], ba[2], ba[3])
    # the forward on the same inputs, with and without residuals, and on
    # the edge cases
    fa = captured["rasterize_fwd"][0]
    train_fwd, train_fwd_plain = forward_check("train inputs", *fa)
    edge_fwd, _ = forward_check("edge cases",
                                *edge_tiles(dev, args.seed)[:5])
    bwd_edges = bwd_edge_cases(dev, args.seed)

    sa = captured["segment_sum"][0]
    d_rows, offs = sa
    rows = list(d_rows)
    s_k = segsum_cuda.segment_sum(*sa)
    s_p = segsum_cuda.segment_sum_plain(rows, offs)
    seg_rel = row_rel_norms(s_k, s_p)
    seg_err = float((s_k - s_p).abs().max())
    check(max(seg_rel) <= SUM_RTOL, f"segment_sum kernel differs from its "
          f"plain version (row relative norms {seg_rel})")
    r0, r1 = pipeline.FEAT0, pipeline.FEAT0 + len(rows)
    r_k = segsum_cuda.segment_sum_rows(rows, offs, row0=r0)
    r_p = segsum_cuda.segment_sum_plain(rows, offs, segsum_cuda.OUT_ROWS, r0)
    rows_rel = row_rel_norms(r_k[r0:r1], r_p[r0:r1])
    rows_err = float((r_k - r_p).abs().max())
    check(max(rows_rel) <= SUM_RTOL and not bool(r_k[:r0].any())
          and not bool(r_k[r1:].any()),
          f"segment_sum_rows kernel differs from its plain version "
          f"(row relative norms {rows_rel})")
    check(torch.equal(r_k[r0:r1], s_k),
          "segment_sum_rows differs from segment_sum on the same rows")
    check(torch.equal(segsum_cuda.segment_sum(*sa), s_k)
          and torch.equal(segsum_cuda.segment_sum_rows(rows, offs, row0=r0),
                          r_k),
          "a segment sum differs between two launches on its main-path "
          "input")
    seg_len = offs[1:].long() - offs[:-1].long()
    block0 = torch.arange(0, seg_len.numel(), 32, device=dev)
    segment_lengths = {
        "gaussians": int(seg_len.numel()),
        "non_empty": int((seg_len > 0).sum()),
        "largest": int(seg_len.max()),
        "entries": int(offs[-1]),
        "blocks_of_32": int(block0.numel()),
        "non_empty_blocks_of_32": int((offs[torch.clamp(
            block0 + 32, max=seg_len.numel())] > offs[block0]).sum())}
    seg_edges = segsum_edge_cases(offs, d_rows.shape[1], dev, args.seed)
    pa = captured["splat_grad"][0]
    z_k = cubemap_cuda.splat_grad(*pa)
    z_p = cubemap_cuda.splat_grad_plain(*pa)
    check(z_k.shape == z_p.shape and z_k.is_contiguous(),
          f"splat kernel output {tuple(z_k.shape)} is not the texture's "
          "layout")
    # per (face, channel) row
    splat_rows = lambda z: z.permute(0, 3, 1, 2).reshape(18, -1)
    splat_rel = row_rel_norms(splat_rows(z_k), splat_rows(z_p))
    splat_err = float((z_k - z_p).abs().max())
    check(max(splat_rel) <= SUM_RTOL, f"splat kernel differs from its plain "
          f"version (row relative norms {splat_rel})")
    kept = pa[0] >= 0
    splat_zero_share = float((pa[5][kept] == 0).all(1).float().mean())
    qa = quality_splat_input(dev, args.seed)
    splat_repeat = {"r1024_train_input": splat_repeats("the train input", pa),
                    "r64_quality_input": splat_repeats("the R=64 input", qa)}
    g3 = lambda xs: [float(f"{x:.3g}") for x in xs]
    phase("train_kernels", t0, rasterize_bwd_row_rel_norm=bwd_rel,
          rasterize_bwd_max_abs_err=bwd_err,
          rasterize_bwd_tolerance=f"row relative norm {BWD_RTOL}",
          segment_sum_row_rel_norms=g3(seg_rel),
          segment_sum_row_norms=g3(s_p.norm(dim=1).tolist()),
          segment_sum_max_abs_err=seg_err,
          segment_sum_rows_row_rel_norms=g3(rows_rel),
          segment_sum_rows_max_abs_err=rows_err,
          rasterize_bwd_bit_equal_across_launches=True,
          live_chunk_spread=live_spread,
          rasterize_fwd_train_inputs=train_fwd,
          rasterize_fwd_edge_cases=edge_fwd,
          rasterize_bwd_edge_cases=bwd_edges,
          splat_grad_row_rel_norms=g3(splat_rel),
          splat_grad_row_norms=g3(splat_rows(z_p).norm(dim=1).tolist()),
          splat_grad_max_abs_err=splat_err,
          splat_zero_cotangent_share=splat_zero_share,
          splat_repeats=splat_repeat,
          segment_lengths=segment_lengths,
          segment_edge_cases_row_rel_norm=seg_edges,
          segment_sums_bit_equal_across_launches=True,
          sum_tolerance=f"row relative norm {SUM_RTOL}",
          capacity=int(ba[0].shape[1]), gaussians=int(offs.shape[0]) - 1,
          texture=int(pa[-1]), pixels=int(pa[0].shape[0]))

    # ---- train_times: kernels, plain versions, library calls, bounds
    t0 = time.perf_counter()
    feats_s, starts, counts_t, n_live = ba[0], ba[1], ba[2], ba[3]
    fp = rasterize_cuda.rasterize_fwd_plain(feats_s, starts, counts_t,
                                            ba[7], ba[8])
    check(torch.equal(fp.n_live, n_live),
          "plain forward stops tiles elsewhere than the kernel")
    live_entries = int(tile_live.sum())
    live_chunks = int(n_live.sum())
    n_tiles = int(starts.numel())
    blend_pairs = int(fp.n_blend)
    bwd_work = compositing_work(feats_s, starts, counts_t, n_live, ba[7],
                                blend_pairs, 0, BWD_BLEND_OPS)
    bwd_ops = bwd_work["ops"]
    bwd_bytes = (2 * live_entries * FEAT_BYTES + live_chunks * PIX_BYTES
                 + n_tiles * (rasterize_cuda.N_OUT * PIX_BYTES + 16))

    n_g = int(offs.numel()) - 1
    entries = int(offs[-1])
    # both read the 10 payload rows of each entry and the offsets;
    # segment_sum writes 10 rows per Gaussian, segment_sum_rows all 16
    seg_bytes = entries * FEAT_BYTES + (n_g + 1) * 4 + len(rows) * n_g * 4
    seg_rows_bytes = seg_bytes + (segsum_cuda.OUT_ROWS - len(rows)) * n_g * 4
    ids = segsum_cuda.segment_ids(offs, d_rows.shape[1])[:entries]

    out = []
    for name, source, replaces, fn, plain, lib, nbytes, nops, err in [
            ("rasterize_bwd", "bilateral_driving_tpu_torch/csrc/rasterize_bwd.cu",
             "bilateral_driving_tpu/ops/rasterize_pallas.py:572",
             lambda: rasterize_cuda.rasterize_bwd(*ba),
             lambda: rasterize_cuda.rasterize_bwd_plain(*ba), None,
             bwd_bytes, bwd_ops, bwd_err),
            ("segment_sum", "bilateral_driving_tpu_torch/csrc/segsum.cu",
             "bilateral_driving_tpu/ops/segsum_pallas.py:261",
             lambda: segsum_cuda.segment_sum(*sa),
             lambda: segsum_cuda.segment_sum_plain(rows, offs),
             lambda: torch.zeros((len(rows), n_g), device=dev)
             .index_add_(1, ids, d_rows[:, :entries]),
             seg_bytes, entries * 10, seg_err),
            ("segment_sum_rows", "bilateral_driving_tpu_torch/csrc/segsum.cu",
             "bilateral_driving_tpu/ops/segsum_pallas.py:316",
             lambda: segsum_cuda.segment_sum_rows(rows, offs, row0=r0),
             lambda: segsum_cuda.segment_sum_plain(
                 rows, offs, segsum_cuda.OUT_ROWS, r0),
             lambda: torch.zeros((segsum_cuda.OUT_ROWS, n_g), device=dev)
             .narrow(0, r0, len(rows))
             .index_add_(1, ids, d_rows[:, :entries]),
             seg_rows_bytes, entries * 10, rows_err)]:
        out.append(timed(name, source, replaces, launches[name], err, fn,
                         plain, lib, nbytes, nops))
        out[-1]["launches_per_step"] = launches[name] / len(steps)
    out.append(splat_times(pa, dev, launches["splat_grad"]))
    out[-1]["launches_per_step"] = launches["splat_grad"] / len(steps)
    # the splat again at the quality protocol's R=64 (its longest runs)
    out[-1]["r64_quality_input"] = splat_times(qa, dev, 0)
    # the forward with its residuals at the training inputs: the render
    # path's bound, plus the checkpoints and n_live written
    fwd_work = compositing_work(fa[0], fa[1], fa[2], train_fwd_plain.n_live,
                                fa[3], int(train_fwd_plain.n_blend),
                                ENTRY_OPS, BLEND_OPS)
    f_live = fwd_work["live_entries"]
    f_chunks = int(train_fwd_plain.n_live.sum())
    fwd_ops = fwd_work["ops"]
    fwd_bytes = (f_live * FEAT_BYTES + f_chunks * PIX_BYTES
                 + n_tiles * (12 + rasterize_cuda.N_OUT * PIX_BYTES))
    fwd_train = timed(
        "rasterize_fwd", "bilateral_driving_tpu_torch/csrc/rasterize_fwd.cu",
        "bilateral_driving_tpu/ops/rasterize_pallas.py:370",
        launches["rasterize_fwd"], train_fwd["max_abs_err"],
        lambda: rasterize_cuda.rasterize_fwd(*fa, residuals=True),
        lambda: rasterize_cuda.rasterize_fwd_plain(*fa), None, fwd_bytes,
        fwd_ops)
    fwd_train["launches_per_step"] = launches["rasterize_fwd"] / len(steps)
    phase("train_times", t0, live_entries=live_entries, live_chunks=live_chunks,
          blend_pairs=blend_pairs, bwd_work=bwd_work, bwd_bytes=bwd_bytes,
          segment_entries=entries, segment_bytes=seg_bytes,
          segment_rows_bytes=seg_rows_bytes,
          splat_pixels=out[3]["pixels"], splat_texels=out[3]["texels"],
          splat_bytes=out[3]["bytes"],
          splat_bytes_if_only_touched_texels_written=out[3][
              "bytes_if_only_touched_texels_written"],
          fwd_work=fwd_work, fwd_bytes=fwd_bytes,
          nvidia_smi=nvidia_smi())

    return out, launches["scan"] / len(steps), fwd_train


def splat_times(pa, dev, launches: int) -> dict:
    """timed() of the splat on one input, with its bound (32 bytes per
    kept pixel and the dense write) and zeros().index_add_."""
    import torch

    from bilateral_driving_tpu_torch.ops import cubemap_cuda

    face, u0, v0, fu, fv, g, res = pa
    keep = face >= 0
    cell = ((face[keep].long() * res + v0[keep].long()) * res
            + u0[keep].long())
    cells4 = torch.cat([cell, cell + 1, cell + res, cell + res + 1])
    wu, wv = fu[keep][:, None], fv[keep][:, None]
    gk = g[keep]
    vals4 = torch.cat([gk * (1 - wv) * (1 - wu), gk * (1 - wv) * wu,
                       gk * wv * (1 - wu), gk * wv * wu])
    npix = int(keep.sum())
    touched = int(torch.unique(cells4).numel())
    # the function returns the dense (6, R, R, 3) gradient: every texel is
    # written, touched or not. Counting only the touched texels (printed
    # beside it) undercounts that write
    nbytes = npix * 32 + 6 * res * res * 3 * 4
    err = float((cubemap_cuda.splat_grad(*pa)
                 - cubemap_cuda.splat_grad_plain(*pa)).abs().max())
    out = timed("splat_grad",
                "bilateral_driving_tpu_torch/csrc/cubemap_splat.cu",
                "bilateral_driving_tpu/ops/cubemap.py:228", launches, err,
                lambda: cubemap_cuda.splat_grad(*pa),
                lambda: cubemap_cuda.splat_grad_plain(*pa),
                lambda: torch.zeros((6 * res * res, 3), device=dev)
                .index_add_(0, cells4, vals4),
                nbytes, npix * 4 * 3 * 3)
    out.update(pixels=npix, texture=res, texels=touched, bytes=nbytes,
               bytes_if_only_touched_texels_written=npix * 32
               + touched * 3 * 4)
    return out


def path_kernels(name: str, captured, dev) -> dict:
    """Each kernel of a training path against its plain version on the
    arguments it was first given there: the expansion and the scan
    bit-exact, the compositing forward as forward_check, the backward,
    the segment sums and the splat (where the path has a sky to splat)
    per output row within BWD_RTOL and SUM_RTOL. Returns the errors."""
    import torch

    from bilateral_driving_tpu_torch.ops import (cubemap_cuda, rasterize_cuda,
                                                 scan_cuda, scan_utils,
                                                 segsum_cuda)

    out = {"expand": expand_check(name, captured["expand"][0])}
    fa = captured["rasterize_fwd"][0]
    out["rasterize_fwd"] = forward_check(name, *fa)[0]
    ba = captured["rasterize_bwd"][0]
    d_k = rasterize_cuda.rasterize_bwd(*ba)
    d_p = rasterize_cuda.rasterize_bwd_plain(*ba)
    rel = max(row_rel_norms(d_k, d_p))
    check(bool(torch.isfinite(d_k).all()) and rel <= BWD_RTOL,
          f"compositing backward differs from its plain version: {name} "
          f"(row relative norm {rel})")
    out["rasterize_bwd"] = {"row_rel_norm": rel,
                            "max_abs_err": float((d_k - d_p).abs().max())}
    d_rows, offs = captured["segment_sum"][0]
    s_k = segsum_cuda.segment_sum(d_rows, offs)
    s_p = segsum_cuda.segment_sum_plain(list(d_rows), offs)
    rel = max(row_rel_norms(s_k, s_p))
    check(rel <= SUM_RTOL, f"segment_sum differs from its plain version: "
          f"{name} (row relative norm {rel})")
    out["segment_sum"] = {"row_rel_norm": rel,
                          "max_abs_err": float((s_k - s_p).abs().max())}
    if "splat_grad" in captured:      # a path with an EnvLight sky
        pa = captured["splat_grad"][0]
        splat_rows = lambda z: z.permute(0, 3, 1, 2).reshape(18, -1)
        z_k = cubemap_cuda.splat_grad(*pa)
        z_p = cubemap_cuda.splat_grad_plain(*pa)
        rel = max(row_rel_norms(splat_rows(z_k), splat_rows(z_p)))
        check(rel <= SUM_RTOL, f"splat differs from its plain version: "
              f"{name} (row relative norm {rel})")
        out["splat_grad"] = {"row_rel_norm": rel,
                             "max_abs_err": float((z_k - z_p).abs().max())}
    sc = captured["scan"][0][0]
    check(torch.equal(scan_utils.cumsum(sc),
                      scan_cuda.scan_rows_plain(sc[None], "sum")[0]),
          f"scan differs from its plain version: {name}")
    out["scan"] = {"elements": int(sc.numel()), "max_abs_err": 0.0}
    return out


def smpl_preset(prefix: str, preset: str, args, dev, scene_rng=None):
    """The phases of an SMPL preset on the flagship's scene plus the
    walkers (<prefix>scene .. <prefix>kernels). `scene_rng` (scene,
    generator state after drawing it) reuses an earlier call's scene, and
    the state's draws start where they did there. Returns each kernel's
    launches in the <prefix>render frames and in the <prefix>train steps,
    the counts of both, scene_rng and the training batches."""
    import torch

    from bilateral_driving_tpu_torch import configs
    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.eval import render_loop
    from bilateral_driving_tpu_torch.ops import pipeline
    from bilateral_driving_tpu_torch.ops.camera import viewmat_from_c2w
    from bilateral_driving_tpu_torch.tools import common
    from bilateral_driving_tpu_torch.train import trainer
    from bilateral_driving_tpu_torch.utils.config import wrap

    # ---- <prefix>scene: the flagship's scene plus the walkers
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(args.seed)
    if scene_rng is None:
        scene = synthetic.make_scene(
            g, num_bg=NUM_BG, num_frames=NUM_FRAMES, num_cams=NUM_CAMS,
            width=WIDTH, height=HEIGHT, focal=FOCAL, num_rigid=RIGID,
            rigid_pts=PTS, num_deformable=DEFORM, deformable_pts=PTS,
            num_smpl=SMPL_WALKERS, device=dev)
        scene_rng = (scene, g.get_state())
    scene = scene_rng[0]
    g.set_state(scene_rng[1])
    data = synthetic.SyntheticData(scene)
    cfg = common.trainer_config_from(wrap(configs.PRESETS[preset]),
                                     data.num_images, NUM_FRAMES, 1.0)
    state, statics = synthetic.random_state(
        scene, cfg, g, configs.FLAGSHIP_BG_CAPACITY, TRAIN_STEP0,
        device=dev, smpl_verts=SMPL_VERTS)
    full_statics = trainer.merge_statics(statics, state.aux)
    neighbor_map = data.neighbor_train_indices(TEST_STRIDE)
    check(BILATERAL_VIEWS[1] in neighbor_map, f"{prefix}test view")
    views = [(data.get_batch(i), i in neighbor_map)
             for i in BILATERAL_VIEWS + BILATERAL_TRAIN_IMAGES]
    cap, probes = isect_capacity(cfg, state, full_statics, views, WIDTH,
                                 HEIGHT, scene.K)
    cfg = dataclasses.replace(cfg, isect_capacity=cap)
    # the walkers in view: intersections of the SMPL Gaussians alone
    smpl_isects = []
    for batch, test in views:
        merged, labels = trainer.collect_gaussians(
            cfg, state.params, full_statics, state.masks,
            batch["camera_to_world"][:3, 3], state.step, batch["frame_idx"],
            batch["normed_time"], test)
        keep = (labels == 2) & (merged.opacities > 0)
        smpl_isects.append(pipeline.probe_num_isects(
            merged.means[keep], merged.quats[keep], merged.scales[keep],
            viewmat_from_c2w(batch["camera_to_world"]), scene.K, WIDTH,
            HEIGHT, pipeline.RasterizeConfig(near_plane=cfg.near_plane,
                                             far_plane=cfg.far_plane)))
    check(all(n > 0 for n in smpl_isects),
          f"a walker-free view: {smpl_isects}")
    torch.cuda.synchronize()
    phase(f"{prefix}scene", t0, config=preset,
          smpl_walkers=SMPL_WALKERS, smpl_points=int(
              state.masks["SMPLNodes"].sum()),
          smpl_verts_per_body=SMPL_VERTS,
          affine={k: list(p.shape) for k, p in trainer.named_leaves(
              state.params["Affine"])},
          camera_opt=cfg.use_camera_opt,
          bg_live=int(state.masks["Background"].sum()),
          rigid_points=int(state.masks["RigidNodes"].sum()),
          deformable_points=int(state.masks["DeformableNodes"].sum()),
          views=list(BILATERAL_VIEWS + BILATERAL_TRAIN_IMAGES),
          probe_num_isects=probes, smpl_num_isects=smpl_isects,
          isect_capacity=cap)

    # ---- <prefix>render: a train and a test view, each FRAME_REPEATS
    # times, counters from 0
    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    for f in wrappers.values():
        f.launches = 0
    before = counts(wrappers)
    frames, frame_ms = [], []
    for idx in BILATERAL_VIEWS:
        for _ in range(FRAME_REPEATS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = render_loop.render_images(cfg, state, statics, data, [idx],
                                            neighbor_map)
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t1))
            now = counts(wrappers)
            check(all(now[k] > before[k] for k in RENDER_PATH),
                  f"a kernel did not launch for view {idx}")
            before = now
        rgb = res["rgbs"][0]
        check(rgb.shape == (HEIGHT, WIDTH, 3)
              and all(bool(torch.isfinite(x).all()) for x in
                      (rgb, res["depths"][0], res["opacities"][0]))
              and not bool(res["overflow"][0])
              and int(res["num_isects"][0]) > 0,
              f"{prefix}render of view {idx}: {res['num_isects'][0]}")
        frames.append({"image": idx, "test_view": idx in neighbor_map,
                       "num_isects": int(res["num_isects"][0]),
                       "rgb_mean": round(float(rgb.mean()), 4)})
    render_launches = counts(wrappers)
    frame_median = sorted(frame_ms)[len(frame_ms) // 2]
    prof = device_profile(lambda: render_loop.render_images(
        cfg, state, statics, data, [BILATERAL_VIEWS[1]], neighbor_map),
        frame_median)
    phase(f"{prefix}render", t0, frames=frames, launches=render_launches,
          ms_per_frame=[round(x, 3) for x in frame_ms],
          median_ms=round(frame_median, 3),
          spread_ms=round(max(frame_ms) - min(frame_ms), 3),
          profiled_frame_ms=prof.pop("profiled_ms"),
          device_idle_share_of_median_frame=prof.pop(
              "device_idle_share_of_median"), **prof,
          nvidia_smi=nvidia_smi())

    captured, launches, steps, batches = train_path(
        prefix, args, cfg, scene, state, statics, dev,
        BILATERAL_TRAIN_IMAGES)

    # ---- <prefix>kernels: each kernel of the path against its plain
    # version on the path's own inputs
    t0 = time.perf_counter()
    errs = path_kernels(f"{preset} train inputs", captured, dev)
    phase(f"{prefix}kernels", t0, **errs,
          tolerance={"expand": "bit-exact", "scan": "bit-exact",
                     "rasterize_fwd": f"atol {RASTER_ATOL} + rtol "
                                      f"{RASTER_RTOL}",
                     "rasterize_bwd": f"row relative norm {BWD_RTOL}",
                     "segment_sum": f"row relative norm {SUM_RTOL}",
                     "splat_grad": f"row relative norm {SUM_RTOL}"},
          nvidia_smi=nvidia_smi())
    return (render_launches, len(frame_ms), launches, len(steps), scene_rng,
            batches)


def variant_step(name: str, cfg, state, statics, batch, data, neighbor_map,
                 seed: int, splats: int = 1, timed: int = 3):
    """One training step of a variant's state on the omnire scene: the
    intersection capacity of its training view and test image 60; the
    step's gradients through the kernels against the all-plain step at one
    temporal-smoothing offset (PVG draws it per step), every leaf within
    GRADS_RTOL and no kernel launched by the plain step; the step's median
    over `timed` runs from a copy of the state; its launches (`splats`
    splats, one of each other path kernel, segment_sum_rows none); every
    parameter finite after it; test image 60 rendered. Returns (cfg with
    the capacity, the state after the step, a dict of what was seen: rels
    by leaf, zero leaves, step metrics, ms, launches, the test frame)."""
    import torch

    from bilateral_driving_tpu_torch.eval import render_loop
    from bilateral_driving_tpu_torch.train import trainer

    dev = batch["pixels"].device
    wrappers = kernel_wrappers()
    views = [(batch, False), (data.get_batch(BILATERAL_VIEWS[1]), True)]
    cap, _ = isect_capacity(cfg, state, trainer.merge_statics(
        statics, state.aux), views, WIDTH, HEIGHT, data.scene.K)
    cfg = dataclasses.replace(cfg, isect_capacity=cap)
    tstate = trainer.init_state(
        cfg, state.params, state.masks, state.aux, step=TRAIN_STEP0,
        generator=torch.Generator(device=dev).manual_seed(seed))
    offset = trainer.temporal_offset(cfg, tstate.generator)
    for f in wrappers.values():
        f.launches = 0
    _, loss_k, _, g_k, gd_k = trainer.compute_grads(
        cfg, statics, tstate, batch, time_offset=offset)
    grad_launches = counts(wrappers)
    _, _, _, g_p, gd_p = plain_step_grads(cfg, statics, tstate, batch,
                                          time_offset=offset)
    torch.cuda.synchronize()
    check(counts(wrappers) == grad_launches,
          f"{name}: a kernel launched in the plain-version step")
    path_launches = lambda got: (
        got["splat_grad"] == splats and got["scan"] >= 1
        and got["segment_sum_rows"] == 0
        and all(got[k] == 1 for k in TRAIN_PATH
                if k not in ("scan", "splat_grad")))
    check(path_launches(grad_launches),
          f"{name}: the gradient step's launches {grad_launches}")
    g_k["means2d"], g_p["means2d"] = gd_k, gd_p
    rels = {k: rel_norm(g_k[k], g_p[k]) for k in g_k}
    worst = max(rels, key=rels.get)
    zero = sorted(k for k in g_p if not bool(g_p[k].any()))
    check(rels[worst] <= GRADS_RTOL,
          f"{name}: gradient of {worst} differs from the plain step by "
          f"{rels[worst]}")
    del g_k, g_p, gd_k, gd_p

    saved = snapshot(tstate)
    for f in wrappers.values():
        f.launches = 0
    ms = []
    for i in range(timed):
        st = restore(saved, tstate.generator) if i else tstate
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        st, m = trainer.train_step(cfg, statics, st, batch)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t1))
        if i == 0:
            step_launches = counts(wrappers)
            vals = {k: float(v) for k, v in m.items()}
            tstate = st
        del st
    check(path_launches(step_launches),
          f"{name}: the step's launches {step_launches}")
    check(all(math.isfinite(v) for v in vals.values())
          and vals["nonfinite_params"] == 0
          and vals["isect_overflow"] == 0,
          f"{name}: step metrics {vals}")
    check(all(bool(torch.isfinite(p).all())
              for _, p in trainer.named_leaves(tstate.params)),
          f"{name}: a parameter is not finite")
    del saved

    for f in wrappers.values():
        f.launches = 0
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = render_loop.render_images(cfg, tstate, statics, data,
                                    [BILATERAL_VIEWS[1]], neighbor_map)
    torch.cuda.synchronize()
    frame_ms = 1e3 * (time.perf_counter() - t1)
    frame_launches = counts(wrappers)
    rgb = res["rgbs"][0]
    check(all(frame_launches[k] == 1 for k in ("expand", "rasterize_fwd"))
          and frame_launches["scan"] >= 1
          and bool(torch.isfinite(rgb).all())
          and not bool(res["overflow"][0]),
          f"{name}: test frame {frame_launches}")
    return cfg, tstate, {
        "rels": rels, "worst": worst, "zero": zero, "loss_k": loss_k,
        "offset": offset, "vals": vals, "ms": ms,
        "step_launches": step_launches, "frame_ms": frame_ms,
        "frame_launches": frame_launches, "res": res,
        "summary": {
            "isect_capacity": cap, "grads_worst_leaf": worst,
            "grads_worst_rel_norm": rels[worst], "zero_leaves": zero,
            "loss": round(vals["loss"], 5),
            "losses": {k[5:]: round(v, 6) for k, v in vals.items()
                       if k.startswith("loss/")},
            "step_ms": [round(x, 3) for x in ms],
            "step_median_ms": round(sorted(ms)[len(ms) // 2], 3),
            "step_launches": step_launches,
            "test_frame_ms": round(frame_ms, 3),
            "test_frame_launches": frame_launches,
            "test_frame_rgb_mean": round(float(rgb.mean()), 4)}}


def variant_state(preset: str, over, args, dev, scene_rng, num_images: int,
                  smpl_verts: int = SMPL_VERTS):
    """A preset's (with overrides) TrainerConfig and random_state on the
    omnire scene, its draws starting where the omnire phases' did."""
    import torch

    from bilateral_driving_tpu_torch import configs
    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.tools import common
    from bilateral_driving_tpu_torch.utils.config import (apply_dotlist,
                                                          wrap)

    g = torch.Generator().manual_seed(args.seed)
    g.set_state(scene_rng[1])
    cfg = common.trainer_config_from(
        apply_dotlist(wrap(configs.PRESETS[preset]), over), num_images,
        NUM_FRAMES, 1.0)
    state, statics = synthetic.random_state(
        scene_rng[0], cfg, g, configs.FLAGSHIP_BG_CAPACITY, TRAIN_STEP0,
        device=dev, smpl_verts=smpl_verts)
    return cfg, state, statics


def appearance_variants(args, dev, scene_rng, batches):
    """The appearance_variants phase: on the omnire scene, for each of
    VARIANTS its preset's state and variant_step (one step's gradients
    against the all-plain step, the step timed VARIANT_TIMED_STEPS times,
    its launches, finite parameters, a test view with neighbour-averaged
    appearance); no SMPLNodes or Affine leaf without a gradient."""
    from bilateral_driving_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    data = synthetic.SyntheticData(scene_rng[0])
    neighbor_map = data.neighbor_train_indices(TEST_STRIDE)
    out = {}
    for name, preset, over in VARIANTS:
        cfg, state, statics = variant_state(preset, over, args, dev,
                                            scene_rng, data.num_images)
        check(cfg.affine_model == name.removesuffix("_inverse"),
              f"{preset}: affine_model {cfg.affine_model}")
        cfg, tstate, seen = variant_step(
            name, cfg, state, statics, batches[0], data, neighbor_map,
            args.seed, timed=VARIANT_TIMED_STEPS)
        check(not any(k.startswith(("SMPLNodes/", "Affine/"))
                      for k in seen["zero"]),
              f"{name}: an SMPLNodes or Affine leaf has no gradient: "
              f"{seen['zero']}")
        out[name] = {
            "preset": preset, "overrides": over, **seen["summary"],
            "affine_rel_norm": {k: float(f"{v:.3g}")
                                for k, v in seen["rels"].items()
                                if k.startswith("Affine/")},
            "loss_affine": seen["vals"]["loss/affine"]}
        del tstate, state, statics, seen
    phase("appearance_variants", t0, variants=out, tolerance=GRADS_RTOL,
          nvidia_smi=nvidia_smi())


def background_variants(args, dev, scene_rng, batches):
    """The background_variants phase: on the omnire scene, for each of
    BACKGROUNDS (PVG, DeformableGS) its preset's state at full width (the
    flagship's 2,097,152 background slots with 1,000,000 live, EnvLight
    R=1024, the affine codes over 240 images, camera refinement; PVG's
    taus, life spans and velocities and the DeformableGS network moved off
    their init) and variant_step, every leaf with a gradient, and the peak
    device memory from the state's build to the test view. Returns each
    kernel's launches per background."""
    import torch

    from bilateral_driving_tpu_torch.data import synthetic

    t0 = time.perf_counter()
    data = synthetic.SyntheticData(scene_rng[0])
    neighbor_map = data.neighbor_train_indices(TEST_STRIDE)
    out, launched = {}, {}
    for name, preset in BACKGROUNDS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg, state, statics = variant_state(preset, [], args, dev,
                                            scene_rng, data.num_images)
        check(cfg.background_model == name and not cfg.use_rigid
              and not cfg.use_deformable and cfg.use_camera_opt,
              f"{preset}: {cfg.background_model}")
        cfg, tstate, seen = variant_step(
            name, cfg, state, statics, batches[0], data, neighbor_map,
            args.seed, timed=BACKGROUND_TIMED_STEPS)
        check(not seen["zero"], f"{name}: leaves without gradient: "
              f"{seen['zero']}")
        launched[name] = seen["step_launches"]
        out[name] = {
            "preset": preset, **seen["summary"],
            "bg_slots": int(state.masks["Background"].shape[0]),
            "bg_live": int(state.masks["Background"].sum()),
            "envlight_resolution": cfg.envlight_resolution,
            "time_offset": float(seen["offset"]),
            "background_rel_norm": {
                k: float(f"{v:.3g}") for k, v in seen["rels"].items()
                if k.startswith("Background/") and "trunk" not in k},
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
        del tstate, state, statics, seen
    phase("background_variants", t0, backgrounds=out, tolerance=GRADS_RTOL,
          nvidia_smi=nvidia_smi())
    return launched


def option_variants(args, dev, scene_rng, batches):
    """The option_variants phase: on the omnire scene, for each of
    OPTION_VARIANTS omnire_bilateral's state at full width (2,097,152
    background slots, 1,000,000 live, 8 SMPL walkers of 6,890 vertices,
    the single grids) with the option on, and variant_step: the option's
    own leaves among the compared gradients, each with a gradient (the
    voxel correction moved off zero by random_state, the cars' quaternion
    tracks off their one heading here), its splats (none without an
    EnvLight texture), a test view (the MLP sky at the mean code, no sky
    at zero), the peak device memory; for the voxel deformer the seconds
    of its set-up (eight (24, 16, 64, 64) voxels, built again and
    bit-equal to the state's). Returns each kernel's launches per variant
    and the two sky variants' test-view renders with its target."""
    import torch

    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.scene import voxel_deformer as vd

    t0 = time.perf_counter()
    data = synthetic.SyntheticData(scene_rng[0])
    neighbor_map = data.neighbor_train_indices(TEST_STRIDE)
    out, launched, renders = {}, {}, {}
    for name, over, new_leaves, splats in OPTION_VARIANTS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t1 = time.perf_counter()
        cfg, state, statics = variant_state(
            "omnire_bilateral", over, args, dev, scene_rng, data.num_images)
        torch.cuda.synchronize()
        state_s = time.perf_counter() - t1
        check(cfg.use_smpl and cfg.affine_model == "bilateral",
              f"{name}: {cfg.affine_model}")
        voxel = {}
        if cfg.use_voxel_deformer:
            tmpl = statics["SMPLNodes"]["template"]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            again, _ = vd.init_voxel_deformer(tmpl.verts_canonical,
                                              tmpl.lbs_weights)
            torch.cuda.synchronize()
            base = statics["SMPLNodes"]["vd_statics"].lbs_voxel_base
            check(torch.equal(again.lbs_voxel_base, base),
                  f"{name}: the voxel set-up is not deterministic")
            corr = state.params["SMPLNodes"]["voxel_w_correction"]
            voxel = {"setup_s": round(time.perf_counter() - t1, 3),
                     "voxels": list(base.shape),
                     "correction_abs_mean": float(corr.abs().mean())}
            check(tuple(base.shape) == (SMPL_WALKERS, 24, 16, 64, 64)
                  and bool(corr.any()), f"{name}: voxels {voxel}")
            del again
        if cfg.w_rigid_temporal > 0:
            # the scene's cars keep one heading: their quaternion tracks
            # (a new tensor: the scene's own is shared) moved off it, so
            # the smoothness term has a quaternion gradient in every frame
            rigid = state.params["RigidNodes"]
            q = rigid["instances_quats"].detach()
            rigid["instances_quats"] = q + 0.01 * torch.randn(
                q.shape, generator=torch.Generator().manual_seed(
                    args.seed + 5)).to(dev)
        check(("Sky" in state.params) == (cfg.sky_model != "none"),
              f"{name}: Sky parameters")
        cfg, tstate, seen = variant_step(
            name, cfg, state, statics, batches[0], data, neighbor_map,
            args.seed, splats=splats, timed=OPTION_TIMED_STEPS)
        zero = seen["zero"]
        new = sorted(k for k in seen["rels"] if k.startswith(new_leaves))
        check(all(any(k.startswith(p) for k in new) for p in new_leaves)
              and not any(k in zero for k in new),
              f"{name}: its leaves {new} or their gradients missing: "
              f"{zero}")
        check(not any(k.startswith(("SMPLNodes/", "Affine/"))
                      for k in zero),
              f"{name}: an SMPLNodes or Affine leaf has no gradient: {zero}")
        loss_k = seen["loss_k"]
        if name == "regularisers":
            check(all(float(loss_k[k]) > 0 for k in OPTION_LOSSES)
                  and "Background_sharp_shape_reg" in loss_k,
                  f"{name}: losses {sorted(loss_k)}")
        res = seen["res"]
        sky_rgb = res["sky_rgbs"][0]
        if name == "sky_none":
            check(not bool(sky_rgb.any()), f"{name}: a sky colour")
        if name == "sky_mlp":
            # the test view's sky: the MLP at the mean appearance code
            check(bool(((sky_rgb > 0) & (sky_rgb < 1)).all()),
                  f"{name}: sky colours outside (0, 1)")
        if name.startswith("sky_"):
            renders[name] = res["rgbs"][0]
            renders["target"] = res["gt_rgbs"][0]
        launched[name] = seen["step_launches"]
        out[name] = {
            "overrides": over, **seen["summary"],
            "state_s": round(state_s, 3),
            **({"voxel": voxel} if voxel else {}),
            "new_leaves_rel_norm": {k: float(f"{seen['rels'][k]:.3g}")
                                    for k in new},
            "test_frame_sky_mean": round(float(sky_rgb.mean()), 4),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
        del tstate, state, statics, seen, res
    phase("option_variants", t0, variants=out, tolerance=GRADS_RTOL,
          nvidia_smi=nvidia_smi())
    return launched, renders


def lpips_phase(dev, renders) -> str:
    """The lpips phase: weights drawn from a seeded generator
    (eval/lpips.init_random) written in tools/export_lpips_weights.py's
    layout to bilateral_driving_tpu_torch/_build/lpips_vgg.npz (git
    ignored); LPIPS of two 533 x 300 renders (option_variants' test view
    with the MLP sky and with none) and of each against its target on the
    card in float32 (TF32 off), against the plain path on the CPU in
    float64 (relative, within LPIPS_RTOL); ms per image pair over
    LPIPS_REPEATS; eval/metrics.lpips through BILATERAL_LPIPS_WEIGHTS.
    Returns the weights' path."""
    import numpy as np
    import torch

    from bilateral_driving_tpu_torch.eval import lpips, metrics

    t0 = time.perf_counter()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    path = os.path.join(ROOT, "bilateral_driving_tpu_torch", "_build",
                        "lpips_vgg.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lpips.save_weights_npz(lpips.init_random(
        torch.Generator().manual_seed(7)), path)
    on_card = lpips.load_weights_npz(path, dev)
    on_cpu = lpips.load_weights_npz(path, "cpu", torch.float64)
    pairs = {"mlp_vs_none": (renders["sky_mlp"], renders["sky_none"]),
             "mlp_vs_target": (renders["sky_mlp"], renders["target"]),
             "none_vs_target": (renders["sky_none"], renders["target"])}
    vals, rels = {}, {}
    for k, (a, b) in pairs.items():
        check(tuple(a.shape) == (HEIGHT, WIDTH, 3), f"lpips input {a.shape}")
        with torch.no_grad():
            got = float(lpips.lpips(on_card, a.float(), b.float()))
            want = float(lpips.lpips(on_cpu, a.double().cpu(),
                                     b.double().cpu()))
        rels[k] = abs(got - want) / max(abs(want), 1e-30)
        vals[k] = {"card_f32": got, "cpu_f64": want}
        check(math.isfinite(got) and got > 0 and rels[k] <= LPIPS_RTOL,
              f"lpips {k}: card {got}, CPU float64 {want}")
    a, b = pairs["mlp_vs_target"]
    ms = []
    with torch.no_grad():
        for _ in range(LPIPS_REPEATS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            lpips.lpips(on_card, a.float(), b.float())
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t1))
    os.environ["BILATERAL_LPIPS_WEIGHTS"] = path
    try:
        via = metrics.lpips(a.cpu().numpy(), b.cpu().numpy(), device=dev)
    finally:
        del os.environ["BILATERAL_LPIPS_WEIGHTS"]
    check(via is not None and abs(via - vals["mlp_vs_target"]["card_f32"])
          <= 1e-6 * vals["mlp_vs_target"]["card_f32"],
          f"metrics.lpips {via} against {vals['mlp_vs_target']}")
    check((torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32) == tf32,
          "lpips left the TF32 settings changed")
    phase("lpips", t0, image_hw=[HEIGHT, WIDTH], values=vals,
          rel_to_cpu_f64=rels, tolerance=LPIPS_RTOL,
          ms_per_pair=[round(x, 3) for x in ms],
          ms_per_pair_median=round(sorted(ms)[len(ms) // 2], 3),
          metrics_lpips=via, weights=os.path.relpath(path, ROOT),
          weights_bytes=os.path.getsize(path), nvidia_smi=nvidia_smi())
    return path


def yaml_text(tree, indent: int = 0) -> str:
    """A config tree as block YAML that utils/config.load_yaml and PyYAML
    read back alike: mappings as blocks, lists as flow sequences, floats
    always with a point (YAML 1.1 reads 1e-05 as a string)."""
    def scalar(v):
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, float):
            r = repr(v)
            if "e" in r and "." not in r.split("e")[0]:
                r = r.replace("e", ".0e")
            return r
        if isinstance(v, (list, tuple)):
            return "[" + ", ".join(scalar(x) for x in v) + "]"
        return str(v)

    lines = []
    for k, v in tree.items():
        if isinstance(v, dict):
            lines.append(" " * indent + f"{k}:")
            lines.append(yaml_text(v, indent + 2))
        else:
            lines.append(" " * indent + f"{k}: {scalar(v)}")
    return "\n".join(x for x in lines if x)


def cli_yaml(dev, weights: str):
    """The cli_yaml phase: a method YAML (omnire_bilateral's tree with the
    MLP sky, the voxel deformer, rigid temporal smoothness and the
    flatten, sparse_reg and max_s_square_reg terms) and a rig YAML for
    tests/fixtures/proto_scene, written by yaml_text and read back by
    utils/config.load_yaml; tools.train --config_file --dataset_file
    smpl.model_path=synthetic for CLI_YAML_STEPS steps with PIL blocked;
    then, side by side with BILATERAL_LPIPS_WEIGHTS naming the lpips
    phase's weights, a resume from checkpoint_CLI_YAML_RESUME (bit-equal
    to the uninterrupted run's final checkpoint) and tools.eval of the
    uninterrupted run (a finite lpips in metrics_test.json).
    The run directories go to work_dirs/chip_smoke_cli_yaml and are
    removed after. Returns the train run's launches."""
    import torch

    from bilateral_driving_tpu_torch import configs
    from bilateral_driving_tpu_torch.utils import config

    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_cli_yaml")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    method = config.apply_dotlist(
        config.wrap(configs.PRESETS["omnire_bilateral"]),
        [o for name, over, _, _ in OPTION_VARIANTS if name != "sky_none"
         for o in over])
    rig = {"data": {"scene_dir": "tests/fixtures/proto_scene",
                    "pixel_pack": "tests/fixtures/proto_scene_pixels.npz",
                    "cameras": [0, 1], "num_cams": 2, "downscale": 1,
                    "test_image_stride": 10}}
    files = {}
    for name, tree in (("method", method), ("rig", rig)):
        files[name] = os.path.join(out, f"{name}.yaml")
        with open(files[name], "w") as f:
            f.write(yaml_text(tree) + "\n")
        check(config.load_yaml(files[name]) == tree,
              f"{name}.yaml does not read back")
    check(method["trainer"]["sky_model"] == "mlp"
          and method["trainer"]["use_voxel_deformer"] is True
          and method["losses"]["rigid_temporal"] == 0.01
          and {"flatten", "sparse_reg", "max_s_square_reg"}
          <= set(method["background_reg"]), f"method tree {method}")
    over = [f"trainer.max_steps={CLI_YAML_STEPS}", "smpl.model_path=synthetic",
            "res_schedule.double_steps=25", "res_schedule.downscale_times=1",
            "density.warmup_steps=10", "density.refine_interval=20",
            "logging.ckpt_every=25", "logging.log_every=25"]
    argv = ["--config_file", files["method"], "--dataset_file", files["rig"],
            "--output_root", out]
    train_s = run_cli("train", *argv, "--run_name", "yaml", *over)
    run_dir = os.path.join(out, "yaml")
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    launched = summ["launches"]
    check(summ["steps"] == CLI_YAML_STEPS
          and summ["final_points"].get("SMPLNodes", 0) > 0,
          f"trained {summ['steps']} steps, {summ['final_points']}")
    check(launched["segment_sum_rows"] == 0 and launched["splat_grad"] == 0
          and all(launched[k] >= CLI_YAML_STEPS for k in TRAIN_PATH
                  if k != "splat_grad"),
          f"the CLI run's launches {launched}")
    check(summ["nonfinite_params_max"] == 0 and summ["overflow_steps"] == 0,
          f"guards: {summ}")
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    check(saved["trainer"]["sky_model"] == "mlp"
          and saved["data"]["cameras"] == [0, 1],
          f"config.json {saved['trainer']} {saved['data']}")
    ckpt = os.path.join(run_dir, "checkpoints",
                        f"checkpoint_{CLI_YAML_RESUME}.pt")
    check(os.path.exists(ckpt), f"no checkpoint {ckpt}")
    # the resume and the evaluation of the uninterrupted run side by side,
    # both with the lpips weights named
    os.environ["BILATERAL_LPIPS_WEIGHTS"] = weights
    t1 = time.perf_counter()
    try:
        run_clis(("train", *argv, "--run_name", "resume", "--resume_from",
                  ckpt, *over), ("eval", "--log_dir", run_dir))
    finally:
        del os.environ["BILATERAL_LPIPS_WEIGHTS"]
    resume_eval_s = time.perf_counter() - t1
    final = [torch.load(os.path.join(out, r, "checkpoints",
                                     f"checkpoint_{CLI_YAML_STEPS}.pt"),
                        map_location="cpu", weights_only=False)
             for r in ("yaml", "resume")]
    check("voxel_w_correction" in final[0]["params"]["SMPLNodes"]
          and "embedding" in final[0]["params"]["Sky"],
          "the checkpoint lacks the voxel correction or the MLP sky")
    for k in ("params", "aux", "masks", "stats", "opt", "step", "updates",
              "generator", "extra"):
        bit_equal(final[0][k], final[1][k], k)
    with open(os.path.join(run_dir, "metrics_test.json")) as f:
        test = json.load(f)
    check(isinstance(test.get("lpips"), float) and math.isfinite(
        test["lpips"]) and math.isfinite(test["psnr"]),
          f"metrics_test.json: {test}")
    phase("cli_yaml", t0, steps=summ["steps"],
          steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          peak_mem_bytes=summ["peak_mem_bytes"],
          final_points=summ["final_points"], refines=summ["refines"],
          launches=launched, resumed_from=CLI_YAML_RESUME,
          resume_bit_equal=True, test_psnr=test["psnr"],
          test_lpips=test["lpips"], train_s=round(train_s, 2),
          resume_and_eval_s=round(resume_eval_s, 2), device=str(dev),
          nvidia_smi=nvidia_smi())
    shutil.rmtree(out)
    return launched


def png_rows(path: str):
    """(height, width, channels) of an 8-bit PNG file and the bytes its
    IDAT chunks decompress to (png_blob_rows)."""
    with open(path, "rb") as f:
        return png_blob_rows(f.read(), path)


def png_blob_rows(blob: bytes, path: str = "PNG"):
    """(height, width, channels) of 8-bit PNG bytes and the bytes their
    IDAT chunks decompress to, read with zlib and struct (no PIL)."""
    import struct
    import zlib

    check(blob[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    w, h, depth, colour = ihdr[:4]
    check(depth == 8, f"{path}: bit depth {depth}")
    return h, w, {0: 1, 2: 3, 6: 4}[colour], len(zlib.decompress(idat))


def render_cli(dev, run_dir: str) -> dict:
    """The render_cli phase: tools.render on the cli phase's run with PIL
    blocked: the test and full splits (rgb and depth) and a
    RENDER_FRAMES-frame RENDER_TRAJ trajectory; ms per novel frame
    (synchronized host clock, median), one expansion, compositing forward
    and scan launched per novel frame, every frame finite, and every PNG's
    IDAT decompressing to H x W x 3 bytes plus a filter byte per row.
    Returns the launches of the novel frames."""
    t0 = time.perf_counter()
    render_s = run_cli("render", "--log_dir", run_dir, "--traj", RENDER_TRAJ,
                       "--frames", str(RENDER_FRAMES))
    videos = os.path.join(run_dir, "videos")
    with open(os.path.join(videos, "render_summary.json")) as f:
        summ = json.load(f)
    check(summ["novel_frames"] == RENDER_FRAMES and summ["novel_finite"]
          and summ["splits"].get("test", 0) > 0
          and summ["splits"].get("full", 0) > 0,
          f"render summary {summ['splits']}, {summ['novel_frames']} frames")
    per_frame = summ["novel_launches"]
    check(all(fl["expand"] == 1 and fl["rasterize_fwd"] == 1
              and fl["scan"] == 1 and fl["rasterize_bwd"] == 0
              for fl in per_frame),
          f"novel frame launches {per_frame[:3]}")
    h, w = summ["size"]
    pngs = 0
    for name, n in [("test", summ["splits"]["test"]),
                    ("test_depth", summ["splits"]["test"]),
                    ("full", summ["splits"]["full"]),
                    ("full_depth", summ["splits"]["full"]),
                    (f"novel_{RENDER_TRAJ}", RENDER_FRAMES)]:
        files = sorted(os.listdir(os.path.join(videos, name)))
        check(files == [f"{i:04d}.png" for i in range(n)],
              f"{name}: {len(files)} frames")
        for fname in files:
            check(png_rows(os.path.join(videos, name, fname))
                  == (h, w, 3, h * (w * 3 + 1)), f"{name}/{fname}")
            pngs += 1
    launches = {k: sum(fl[k] for fl in per_frame) for k in per_frame[0]}
    ms = summ["novel_ms"]
    phase("render_cli", t0, traj=RENDER_TRAJ, frames=RENDER_FRAMES,
          splits=summ["splits"], size=summ["size"], pngs_checked=pngs,
          ms_per_frame_median=summ["novel_ms_median"],
          ms_per_frame=[round(x, 3) for x in ms],
          spread_ms=round(max(ms) - min(ms), 3),
          launches_per_frame=per_frame[0], launches=launches,
          render_s=round(render_s, 2), device=str(dev),
          nvidia_smi=nvidia_smi())
    return launches


def cli_smpl(dev):
    """The cli_smpl phase: tools.train --config omnire_bilateral on
    proto_scene with the synthetic body (its pedestrian in SMPLNodes),
    then tools.eval; the test PSNR and the human-masked test PSNR. The
    run directory goes to work_dirs/chip_smoke_cli_smpl and is removed
    after."""
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_cli_smpl")
    shutil.rmtree(out, ignore_errors=True)
    run_dir = os.path.join(out, "smpl")
    train_s = run_cli("train", "--config", "omnire_bilateral",
                      "--output_root", out, "--run_name", "smpl",
                      *CLI_SMPL_OVERRIDES)
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    check(summ["steps"] == CLI_SMPL_STEPS, f"trained {summ['steps']} steps")
    check(summ["final_points"].get("SMPLNodes", 0) > 0
          and "DeformableNodes" not in summ["final_points"],
          f"the pedestrian is not in SMPLNodes: {summ['final_points']}")
    launched = summ["launches"]
    check(launched["segment_sum_rows"] == 0 and all(
        launched[k] >= CLI_SMPL_STEPS for k in TRAIN_PATH),
          f"a kernel missed training steps of the CLI run: {launched}")
    check(summ["nonfinite_params_max"] == 0 and summ["overflow_steps"] == 0,
          f"guards: {summ}")
    eval_s = run_cli("eval", "--log_dir", run_dir, "--compute_geo")
    with open(os.path.join(run_dir, "metrics_test.json")) as f:
        test = {k: v for k, v in json.load(f).items()
                if isinstance(v, float)}
    check(all(math.isfinite(test[k]) for k in ("psnr", "human_psnr")),
          f"metrics_test.json: {test}")
    phase("cli_smpl", t0, steps=summ["steps"],
          steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          peak_mem_bytes=summ["peak_mem_bytes"],
          final_points=summ["final_points"], refines=summ["refines"],
          launches=launched, test_psnr=test["psnr"],
          test_human_psnr=test["human_psnr"], metrics_test=test,
          train_s=round(train_s, 2), eval_s=round(eval_s, 2),
          device=str(dev), nvidia_smi=nvidia_smi())
    shutil.rmtree(out)


def cli_omnire(dev):
    """The cli_omnire phase: tools.train --config omnire on proto_scene
    with the synthetic body for CLI_SMPL_STEPS steps, a resume from its
    step-CLI_OMNIRE_RESUME checkpoint, then tools.eval: steps/s, the test
    PSNR and the non-finite parameters (0). The run directory goes to
    work_dirs/chip_smoke_cli_omnire and is removed after."""
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_cli_omnire")
    shutil.rmtree(out, ignore_errors=True)
    run_dir = os.path.join(out, "omnire")
    train_s = run_cli("train", "--config", "omnire", "--output_root", out,
                      "--run_name", "omnire", *CLI_OMNIRE_OVERRIDES)
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    check(summ["steps"] == CLI_SMPL_STEPS, f"trained {summ['steps']} steps")
    check(summ["final_points"].get("SMPLNodes", 0) > 0,
          f"the pedestrian is not in SMPLNodes: {summ['final_points']}")
    launched = summ["launches"]
    check(launched["segment_sum_rows"] == 0 and all(
        launched[k] >= CLI_SMPL_STEPS for k in TRAIN_PATH),
          f"a kernel missed training steps of the CLI run: {launched}")
    check(summ["nonfinite_params_max"] == 0 and summ["overflow_steps"] == 0,
          f"guards: {summ}")
    ckpt = os.path.join(run_dir, "checkpoints",
                        f"checkpoint_{CLI_OMNIRE_RESUME}.pt")
    check(os.path.exists(ckpt), f"no checkpoint {ckpt}")
    resume_s = run_cli(
        "train", "--config", "omnire", "--output_root", out, "--run_name",
        "resume", "--resume_from", ckpt, *CLI_OMNIRE_OVERRIDES,
        f"trainer.max_steps={CLI_OMNIRE_RESUME + CLI_OMNIRE_RESUME_STEPS}")
    with open(os.path.join(out, "resume", "train_summary.json")) as f:
        resumed = json.load(f)
    check((resumed["start_step"], resumed["end_step"])
          == (CLI_OMNIRE_RESUME, CLI_OMNIRE_RESUME + CLI_OMNIRE_RESUME_STEPS)
          and resumed["nonfinite_params_max"] == 0,
          f"resumed {resumed['start_step']}..{resumed['end_step']}")
    eval_s = run_cli("eval", "--log_dir", run_dir, "--compute_geo")
    with open(os.path.join(run_dir, "metrics_test.json")) as f:
        test = {k: v for k, v in json.load(f).items()
                if isinstance(v, float)}
    check(all(math.isfinite(test[k]) for k in ("psnr", "human_psnr")),
          f"metrics_test.json: {test}")
    phase("cli_omnire", t0, steps=summ["steps"],
          steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          peak_mem_bytes=summ["peak_mem_bytes"],
          nonfinite_params=summ["nonfinite_params_max"],
          final_points=summ["final_points"], refines=summ["refines"],
          launches=launched,
          resumed_steps=[resumed["start_step"], resumed["end_step"]],
          resumed_nonfinite_params=resumed["nonfinite_params_max"],
          test_psnr=test["psnr"], test_human_psnr=test["human_psnr"],
          metrics_test=test, train_s=round(train_s, 2),
          resume_s=round(resume_s, 2), eval_s=round(eval_s, 2),
          device=str(dev), nvidia_smi=nvidia_smi())
    shutil.rmtree(out)


def cli_presets(dev):
    """The cli_presets phase: tools.train for each of CLI_PRESETS side by
    side, then each one's resume from its step-CLI_PRESET_RESUME
    checkpoint beside tools.eval --max_images 1 of each run (its last
    checkpoint restored, one test and one full-split image rendered);
    per preset its guards, launches, resumed steps, test PSNR (the
    training run's own evaluation of the test split, test_metrics.json)
    and the evaluation's finite metrics. The run directories go to
    work_dirs/chip_smoke_cli_presets and are removed after."""
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_cli_presets")
    shutil.rmtree(out, ignore_errors=True)

    def summary(name):
        with open(os.path.join(out, name, "train_summary.json")) as f:
            return json.load(f)

    run_clis(*[("train", "--config", p, "--output_root", out, "--run_name",
                p, *CLI_PRESET_OVERRIDES) for p in CLI_PRESETS])
    run_clis(*[("train", "--config", p, "--output_root", out, "--run_name",
                f"{p}_resume", "--resume_from", os.path.join(
                    out, p, "checkpoints",
                    f"checkpoint_{CLI_PRESET_RESUME}.pt"),
                *CLI_PRESET_OVERRIDES) for p in CLI_PRESETS],
             *[("eval", "--log_dir", os.path.join(out, p), "--max_images",
                "1") for p in CLI_PRESETS])
    runs = {}
    for p in CLI_PRESETS:
        summ, resumed = summary(p), summary(f"{p}_resume")
        launched = summ["launches"]
        check(summ["steps"] == CLI_PRESET_STEPS
              and launched["segment_sum_rows"] == 0
              and all(launched[k] >= CLI_PRESET_STEPS for k in TRAIN_PATH),
              f"{p}: {summ['steps']} steps, launches {launched}")
        check(summ["nonfinite_params_max"] == 0
              and summ["overflow_steps"] == 0
              and resumed["nonfinite_params_max"] == 0
              and (resumed["start_step"], resumed["end_step"])
              == (CLI_PRESET_RESUME, CLI_PRESET_STEPS),
              f"{p}: guards or resume {summ} {resumed}")
        with open(os.path.join(out, p, "test_metrics.json")) as f:
            psnr = json.load(f)["psnr"]
        check(math.isfinite(psnr), f"{p}: test PSNR {psnr}")
        evaluated = {}
        for split in ("test", "full"):
            with open(os.path.join(out, p, f"metrics_{split}.json")) as f:
                evaluated[split] = {k: v for k, v in json.load(f).items()
                                    if isinstance(v, float)}
            check(evaluated[split] and all(
                math.isfinite(v) for v in evaluated[split].values()),
                  f"{p}: tools.eval metrics_{split}.json {evaluated[split]}")
        runs[p] = {"steps": summ["steps"], "launches": launched,
                   "refines": len(summ["refines"]),
                   "final_points": summ["final_points"],
                   "resumed_steps": [resumed["start_step"],
                                     resumed["end_step"]],
                   "nonfinite_params": summ["nonfinite_params_max"],
                   "test_psnr": psnr,
                   "eval_psnr": {k: v["psnr"] for k, v in evaluated.items()}}
    phase("cli_presets", t0, runs=runs,
          side_by_side="the presets ran at once: no steps/s from them",
          device=str(dev), nvidia_smi=nvidia_smi())
    shutil.rmtree(out)


def parallel_phase(args, dev, scene_rng, batches) -> dict:
    """The parallel phase: the parallel layer on one card.

    maybe_initialize joins a world-size-1 process group over
    tcp://127.0.0.1 (NCCL on the card). From omnire_bilateral's state at
    step TRAIN_STEP0 on the omnire scene, one data_parallel step and one
    tile_train_step (a 1 x 1 hybrid mesh) each against train_step from a
    copy of the same state, parameters compared leaf by leaf, and the
    tile path's gradients against the whole image's. Image 0 of
    the same state rendered whole and as 2 and 4 bands through
    tile_parallel.render_band (no collective): the stitched rgb and alpha
    within BAND_ATOL of the whole render, num_isects summed over the bands
    equal to the whole image's, the per-band losses' parameter gradients
    summed over the bands within BAND_GRAD_RTOL of the whole image's,
    every kernel of every band against its plain version on the
    arguments it was given at the band's shapes (path_kernels), and
    CUDA-event ms of each band's forward and backward beside the whole
    image's; a band of zero-opacity Gaussians (no entries) forward and
    backward. Then three CLI runs on the fixture side by side: a plain
    one, `--data_parallel -1 --project p` (world size 1 on the card,
    metrics.json equal to the plain run's) and `--coordinator
    --num_processes 1 --process_id 0 --project p` (writes
    <root>/p/<run>), CLI_PRESET_STEPS (5) steps each with cli_presets'
    overrides: 20 before the preprocess phase came, cut with cli_presets'
    depth to keep chip_smoke within its time. Every count is set to 0
    when the phase starts.
    Returns each path's launches, read just after one run of it: the
    data step's and the tile step's (one step each), each band count's
    (every band's forward once, then every band's loss and gradients
    once), the empty band's and the data-parallel CLI run's."""
    import torch
    import torch.distributed as dist

    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.ops import pipeline
    from bilateral_driving_tpu_torch.ops.camera import viewmat_from_c2w
    from bilateral_driving_tpu_torch.parallel import (data_parallel,
                                                      distributed,
                                                      tile_parallel)
    from bilateral_driving_tpu_torch.train import trainer

    t0 = time.perf_counter()
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    launched = {}       # each path's launches, read just after one run of it
    gen = lambda: torch.Generator(device=dev).manual_seed(args.seed)
    data = synthetic.SyntheticData(scene_rng[0])
    cfg, state, statics = variant_state("omnire_bilateral", [], args, dev,
                                        scene_rng, data.num_images)
    image0 = data.get_batch(0)
    cap, _ = isect_capacity(cfg, state, trainer.merge_statics(
        statics, state.aux), [(batches[0], False), (image0, False)], WIDTH,
        HEIGHT, data.scene.K)
    cfg = dataclasses.replace(cfg, isect_capacity=cap)
    saved = snapshot(trainer.init_state(
        cfg, state.params, state.masks, state.aux, step=TRAIN_STEP0,
        generator=gen()))
    del state

    port = free_port()
    multi = distributed.maybe_initialize(distributed.DistConfig(
        f"127.0.0.1:{port}", 1, 0), dev)
    backend = dist.get_backend()
    check(not multi and dist.get_world_size() == 1 and backend == "nccl",
          f"process group: multi {multi}, backend {backend}")
    try:
        # ---- the two parallel steps against train_step
        mesh = distributed.global_mesh(dev)
        hmesh = tile_parallel.make_hybrid_mesh(1, 1, dev)
        batch = data_parallel.shard_batch(
            data_parallel.stack_batches([batches[0]]), mesh)
        steps = {}
        step_rtol = {"data_parallel": PARALLEL_STEP_RTOL,
                     "tile_parallel": GRADS_RTOL}
        for name, step_fn in (
                ("data_parallel",
                 data_parallel.parallel_train_step(cfg, statics, mesh)),
                ("tile_parallel",
                 tile_parallel.tile_train_step(cfg, statics, hmesh))):
            # the first call sets up the collectives' communicators
            ms = []
            for _ in range(2):
                st = restore(saved, gen())
                zero_launches(wrappers)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                st, m = step_fn(st, batch)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t1))
            step_launches = zero_launches(wrappers)
            launched[name.replace("_parallel", "_step")] = step_launches
            check(all(step_launches[k] >= 1 for k in TRAIN_PATH)
                  and step_launches["segment_sum_rows"] == 0,
                  f"{name}: the step's launches {step_launches}")
            ref = restore(saved, gen())
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ref, m_ref = trainer.train_step(cfg, statics, ref, batches[0])
            torch.cuda.synchronize()
            ref_ms = 1e3 * (time.perf_counter() - t1)
            zero_launches(wrappers)
            got = dict(trainer.named_leaves(st.params))
            want = dict(trainer.named_leaves(ref.params))
            check(got.keys() == want.keys(), f"{name}: other leaves")
            equal = all(torch.equal(got[k], want[k]) for k in want)
            rels = {k: rel_norm(got[k], want[k]) for k in want}
            worst = max(rels, key=rels.get)
            check(rels[worst] <= step_rtol[name],
                  f"{name}: {worst} differs from train_step's by "
                  f"{rels[worst]}")
            grads = {}
            if name == "tile_parallel":
                # the band path's gradients against the whole image's:
                # Adam's first update divides each gradient by its size,
                # which turns rounding-level gradients apart into moves
                # apart, so the step's parameters say less
                g_t, g_s = [trainer.compute_grads(
                    cfg, statics, restore(saved, gen()), batch,
                    rasterize_fn=rfn) for rfn in (
                        tile_parallel.banded_rasterize_fn(hmesh.tile),
                        None)]
                zero_launches(wrappers)
                grels = {k: rel_norm(g_t[3][k], g_s[3][k]) for k in g_s[3]}
                grels["means2d"] = rel_norm(g_t[4], g_s[4])
                gworst = max(grels, key=grels.get)
                check(grels[gworst] <= GRADS_RTOL,
                      f"{name}: the gradient of {gworst} differs from the "
                      f"whole image's by {grels[gworst]}")
                grads = {"grads_bit_equal": all(
                    torch.equal(g_t[3][k], g_s[3][k]) for k in g_s[3]),
                    "grads_worst_leaf": gworst,
                    "grads_worst_rel_norm": grels[gworst]}
                del g_t, g_s
            vals = {k: float(v) for k, v in m.items()}
            check(vals["nonfinite_params"] == 0
                  and vals["isect_overflow"] == 0
                  and vals["num_isects"] == float(m_ref["num_isects"]),
                  f"{name}: metrics {vals}")
            steps[name] = {
                "params_bit_equal": equal, "worst_leaf": worst,
                "worst_rel_norm": rels[worst],
                "tolerance": step_rtol[name], **grads,
                "loss": vals["loss"], "train_step_loss": float(
                    m_ref["loss"]), "psnr": vals["psnr"],
                "train_step_psnr": float(m_ref["psnr"]),
                "num_isects": int(vals["num_isects"]),
                "first_ms": round(ms[0], 3), "ms": round(ms[1], 3),
                "train_step_ms": round(ref_ms, 3),
                "launches": step_launches}
            del st, ref, got, want

        # ---- image 0 whole and in bands, no collective
        st = restore(saved, gen())
        merged, _ = trainer.collect_gaussians(
            cfg, st.params, trainer.merge_statics(statics, st.aux),
            st.masks, image0["camera_to_world"][:3, 3], st.step,
            image0["frame_idx"], image0["normed_time"])
        leaves = [x.detach() for x in (merged.means, merged.quats,
                                       merged.scales, merged.opacities,
                                       merged.rgbs)]
        del st, merged
        cam = (viewmat_from_c2w(image0["camera_to_world"]),
               image0["intrinsics"])
        rcfg = pipeline.RasterizeConfig(
            near_plane=cfg.near_plane, far_plane=cfg.far_plane,
            radius_clip=cfg.radius_clip, antialiased=cfg.antialiased,
            isect_capacity=cap)
        whole = lambda *g: pipeline.rasterize(*g, *cam, WIDTH, HEIGHT, rcfg)
        band = lambda b, nb, *g: tile_parallel.render_band(
            *g, *cam, WIDTH, HEIGHT, rcfg, b, nb)
        img_loss = lambda o: (o["rgb"] ** 2).sum() + o["alpha"].sum()
        full = whole(*leaves)
        full_isects = int(full["info"]["num_isects"])
        full_fwd_ms = cuda_ms(lambda: whole(*leaves), 5)
        g_leaves = [x.clone().requires_grad_() for x in leaves]
        with torch.enable_grad():
            full_loss = img_loss(whole(*g_leaves))
            g_full = torch.autograd.grad(full_loss, g_leaves,
                                         retain_graph=True)
            full_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                full_loss, g_leaves, retain_graph=True), 3)
        bands = {}
        for nb in PARALLEL_BANDS:
            # the stitch: every band's forward once, counters from 0
            zero_launches(wrappers)
            outs = [band(b, nb, *leaves) for b in range(nb)]
            fwd_launches = zero_launches(wrappers)
            rgb = torch.cat([o["rgb"] for o in outs])[:HEIGHT]
            alpha = torch.cat([o["alpha"] for o in outs])[:HEIGHT]
            isects = [int(o["info"]["num_isects"]) for o in outs]
            rgb_err = float((rgb - full["rgb"]).abs().max())
            alpha_err = float((alpha - full["alpha"]).abs().max())
            check(rgb_err <= BAND_ATOL and alpha_err <= BAND_ATOL
                  and sum(isects) == full_isects
                  and not any(bool(o["info"]["overflow"]) for o in outs),
                  f"{nb} bands: rgb {rgb_err}, alpha {alpha_err}, "
                  f"isects {isects} of {full_isects}")
            stitch_bit_equal = (torch.equal(rgb, full["rgb"])
                                and torch.equal(alpha, full["alpha"]))
            del outs, rgb, alpha
            # each band's loss and gradients once, counters from 0, every
            # kernel's arguments captured at the band's shapes
            g_sum, band_kernels = None, []
            zero_launches(wrappers)
            for b in range(nb):
                captured = {}
                with torch.enable_grad(), pipeline_captured(captured):
                    loss = img_loss(band(b, nb, *g_leaves))
                    if not loss.requires_grad:
                        continue      # a band wholly past the image
                    g = torch.autograd.grad(loss, g_leaves)
                g_sum = g if g_sum is None else [
                    a + c for a, c in zip(g_sum, g)]
                band_kernels.append(captured)
                del loss, g
            grad_launches = zero_launches(wrappers)
            check(all(fwd_launches[k] >= 1 for k in RENDER_PATH)
                  and all(grad_launches[k] >= 1 for k in TRAIN_PATH
                          if k != "splat_grad"),
                  f"{nb} bands: launches {fwd_launches}, {grad_launches}")
            launched[f"bands_{nb}"] = {k: fwd_launches[k] + grad_launches[k]
                                       for k in wrappers}
            rels = [rel_norm(a, c) for a, c in zip(g_sum, g_full)]
            check(max(rels) <= BAND_GRAD_RTOL,
                  f"{nb} bands: gradients {rels}")
            del g_sum
            # every kernel of every band against its plain version on the
            # arguments it was given there
            kernel_errs = [path_kernels(f"band {b} of {nb}", captured, dev)
                           for b, captured in enumerate(band_kernels)]
            del band_kernels
            fwd_ms = [cuda_ms(lambda: band(b, nb, *leaves), 5)
                      for b in range(nb)]
            bwd_ms = []
            with torch.enable_grad():
                for b in range(nb):
                    loss = img_loss(band(b, nb, *g_leaves))
                    if loss.requires_grad:
                        bwd_ms.append(cuda_ms(lambda: torch.autograd.grad(
                            loss, g_leaves, retain_graph=True), 3))
                    del loss
            zero_launches(wrappers)
            bands[nb] = {"band_height": tile_parallel.band_height(
                HEIGHT, nb), "num_isects": isects,
                "rgb_max_abs_err": rgb_err, "alpha_max_abs_err": alpha_err,
                "stitch_bit_equal": stitch_bit_equal,
                "grad_rel_norm": dict(zip(
                    ("means", "quats", "scales", "opacities", "colors"),
                    rels)),
                "kernels_vs_plain": kernel_errs,
                "launches_forward": fwd_launches,
                "launches_gradients": grad_launches,
                "fwd_ms": [round(x, 4) for x in fwd_ms],
                "bwd_ms": [round(x, 4) for x in bwd_ms]}
        # a band whose Gaussians are all transparent: no entries at all
        zero_launches(wrappers)
        with torch.enable_grad():
            clear = torch.zeros_like(leaves[3]).requires_grad_()
            g_means = g_leaves[0]
            out = tile_parallel.render_band(
                g_means, *leaves[1:3], clear, leaves[4], *cam, WIDTH,
                HEIGHT, rcfg, 0, 2)
            g_clear = torch.autograd.grad(img_loss(out), [g_means, clear])
        empty_launches = zero_launches(wrappers)
        launched["empty_band"] = empty_launches
        check(int(out["info"]["num_isects"]) == 0
              and not bool(out["rgb"].any()) and not bool(out["alpha"].any())
              and all(bool(torch.isfinite(g).all()) and not bool(g.any())
                      for g in g_clear)
              and all(empty_launches[k] >= 1 for k in TRAIN_PATH
                      if k != "splat_grad"),
              f"empty band: {int(out['info']['num_isects'])} entries, "
              f"launches {empty_launches}")
        del out, g_clear, g_leaves, leaves, g_full, full, saved
    finally:
        dist.destroy_process_group()

    # ---- the CLI: a plain run, --data_parallel -1 and one process of a
    # multi-process run, side by side
    t1 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_parallel")
    shutil.rmtree(out, ignore_errors=True)
    common = ["--output_root", out, *CLI_PRESET_OVERRIDES]
    run_clis(("train", "--run_name", "plain", *common),
             ("train", "--project", "p", "--run_name", "dp",
              "--data_parallel", "-1", *common),
             ("train", "--project", "p", "--run_name", "mp",
              "--coordinator", f"127.0.0.1:{free_port()}",
              "--num_processes", "1", "--process_id", "0", *common))
    summ, metrics = {}, {}
    for name, rel in (("plain", "plain"), ("dp", "p/dp"), ("mp", "p/mp")):
        with open(os.path.join(out, rel, "train_summary.json")) as f:
            summ[name] = json.load(f)
        with open(os.path.join(out, rel, "metrics.json")) as f:
            metrics[name] = [json.loads(x) for x in f if x.strip()]
    check(metrics["dp"] == metrics["plain"] and metrics["plain"],
          "the --data_parallel -1 run's metrics.json differs from the "
          "plain run's")
    check(summ["dp"]["parallel"] == {"ranks": 1, "rank": 0, "data": 1,
                                     "tile": 1, "backend": "nccl"}
          and summ["mp"]["steps"] == CLI_PRESET_STEPS
          and all(s["nonfinite_params_max"] == 0 for s in summ.values()),
          f"parallel CLI runs: {[s['parallel'] for s in summ.values()]}")
    cli_launches = summ["dp"]["launches"]
    check(all(cli_launches[k] >= CLI_PRESET_STEPS for k in TRAIN_PATH),
          f"the --data_parallel run's launches {cli_launches}")
    phase("parallel", t0, backend=backend,
          nccl_version=".".join(map(str, torch.cuda.nccl.version())),
          isect_capacity=cap, steps=steps,
          tolerance={"steps": f"bit-equal or {PARALLEL_STEP_RTOL} relative "
                              "norm per leaf",
                     "bands": f"rgb, alpha atol {BAND_ATOL}, num_isects "
                              f"equal, gradients {BAND_GRAD_RTOL} relative "
                              "norm"},
          whole_image={"num_isects": full_isects,
                       "fwd_ms": round(full_fwd_ms, 4),
              "bwd_ms": round(full_bwd_ms, 4)},
          bands=bands, empty_band_launches=empty_launches,
          cli={name: {k: s[k] for k in (
              "steps", "steps_per_s_after_warmup", "peak_mem_bytes",
              "parallel", "launches")} for name, s in summ.items()},
          cli_metrics_equal=True, cli_s=round(time.perf_counter() - t1, 2),
          device=str(dev), nvidia_smi=nvidia_smi())
    shutil.rmtree(out)
    launched["cli_data_parallel"] = cli_launches
    return launched


def free_port() -> int:
    """A TCP port on 127.0.0.1 that is free now."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http(port: int, path: str, post: bool = False):
    """(content type, body) of a request to the viewer on 127.0.0.1."""
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=b"" if post else None,
                                 method="POST" if post else "GET")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.headers.get("Content-Type"), r.read()


def watch_viewer(proc, port: int) -> dict:
    """While a training CLI with --viewer_port runs: poll /stats until it
    reports step SYNTH_VIEW_STEP, pause training (POST /pause), fetch the
    page and one frame, read /stats (paused), resume. Returns what was
    seen."""
    import urllib.error

    while True:
        check(proc.poll() is None, "the CLI exited before its viewer "
              f"reported step {SYNTH_VIEW_STEP}")
        try:
            stats = json.loads(http(port, "/stats")[1])
        except (urllib.error.URLError, ConnectionError):
            stats = None
        if stats is not None and stats["step"] >= SYNTH_VIEW_STEP:
            break
        time.sleep(0.05)
    paused = json.loads(http(port, "/pause", post=True)[1])["paused"]
    page_type, page = http(port, "/")
    t1 = time.perf_counter()
    frame_type, frame = http(port, "/frame?eye=0,-3,-6&look=0,0,12&t=0.5")
    frame_s = time.perf_counter() - t1
    during = json.loads(http(port, "/stats")[1])
    resumed = json.loads(http(port, "/pause", post=True)[1])["paused"]
    check(paused and during["paused"] and not resumed,
          f"pause toggles: {paused}, {during}, {resumed}")
    check(page_type == "text/html" and b"/frame?eye=" in page,
          f"viewer page: {page_type}")
    check(frame_type == "image/png", f"frame type {frame_type}")
    h, w = SYNTH_HW
    check(png_blob_rows(frame, "viewer frame") == (h, w, 3, h * (w * 3 + 1)),
          "viewer frame size")
    return {"stats": stats, "stats_while_paused": during,
            "frame_bytes": len(frame), "frame_s": round(frame_s, 3)}


def bit_equal(a, b, path: str = "") -> None:
    """Raise unless two checkpoint trees hold the same keys and the same
    bits in every tensor and array."""
    import numpy as np
    import torch

    if isinstance(a, dict):
        check(set(a) == set(b), f"{path}: keys differ")
        for k in a:
            bit_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"{path}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            bit_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(
            a.reshape(-1).view(torch.uint8),
            b.reshape(-1).view(torch.uint8)), f"{path}: bits differ")
    elif isinstance(a, np.ndarray):
        check(a.dtype == b.dtype and a.tobytes() == b.tobytes(),
              f"{path}: bits differ")
    else:
        check(a == b, f"{path}: {a!r} != {b!r}")


def cli_synthetic(dev):
    """The cli_synthetic phase: tools.train --config synthetic (the
    generated scene, its ground truth rendered by the forward, every
    parameter perturbed) for SYNTH_STEPS steps with PIL blocked and the
    live viewer on a free port (watch_viewer); then a resume from its
    checkpoint_SYNTH_RESUME (side by side with the cli_downscale run),
    bit-equal to the uninterrupted run's final checkpoint; the tb/ event
    file read back (utils/tb.read_events: every
    CRC valid, the scalar tags and steps the CLI logs), backup/ holding
    tools/train.py, and the final background exported as a ply whose
    vertex count is that of the live Gaussians above SYNTH_PLY_ALPHA; then
    the cli_downscale phase. The run directories go to
    work_dirs/chip_smoke_cli_synthetic and are removed after. Returns the
    launches of the train run and of the cli_downscale run."""
    import torch

    from bilateral_driving_tpu_torch.utils import export, tb

    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_cli_synthetic")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    run_dir = os.path.join(out, "synthetic")
    port = free_port()
    t1 = time.perf_counter()
    with open(os.path.join(out, "train.log"), "w+") as log:
        proc = subprocess.Popen(
            [sys.executable, "-c", NO_PIL,
             "bilateral_driving_tpu_torch.tools.train", "--config",
             "synthetic", "--output_root", out, "--run_name", "synthetic",
             "--viewer_port", str(port)],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
        try:
            viewer = watch_viewer(proc, port)
            proc.wait(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log.seek(0)
        check(proc.returncode == 0, f"tools.train exited {proc.returncode}:"
              f"\n{log.read()[-3000:]}")
    train_s = time.perf_counter() - t1
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    launched = summ["launches"]
    check(summ["steps"] == SYNTH_STEPS, f"trained {summ['steps']} steps")
    check(launched["segment_sum_rows"] == 0 and all(
        launched[k] >= SYNTH_STEPS for k in TRAIN_PATH),
          f"a kernel missed training steps of the CLI run: {launched}")
    check(summ["nonfinite_params_max"] == 0 and summ["overflow_steps"] == 0,
          f"guards: {summ}")
    first, last = summ["first_metrics"], summ["last_metrics"]
    check(first["step"] == 0 and last["step"] == SYNTH_STEPS - 1
          and last["loss"] < first["loss"] and last["psnr"] > first["psnr"],
          f"loss and PSNR did not improve: {first} -> {last}")
    check(summ["viewer_frames"] >= 1 and tuple(summ["image_hw"]) == SYNTH_HW,
          f"viewer frames {summ['viewer_frames']}, size {summ['image_hw']}")
    with open(os.path.join(run_dir, "test_metrics.json")) as f:
        frames_psnr = json.load(f)["psnr"]
    check(math.isfinite(frames_psnr), f"frames PSNR {frames_psnr}")

    ckpt = os.path.join(run_dir, "checkpoints",
                        f"checkpoint_{SYNTH_RESUME}.pt")
    check(os.path.exists(ckpt), f"no checkpoint {ckpt}")
    # the resume and the cli_downscale run (which needs no steps/s of its
    # own) side by side
    t1 = time.perf_counter()
    run_clis(("train", "--config", "synthetic", "--output_root", out,
              "--run_name", "resume", "--resume_from", ckpt),
             ("train", "--output_root", out, "--run_name", "half",
              *DOWNSCALE_OVERRIDES))
    resume_s = time.perf_counter() - t1
    final = [torch.load(os.path.join(out, r, "checkpoints",
                                     f"checkpoint_{SYNTH_STEPS}.pt"),
                        map_location="cpu", weights_only=False)
             for r in ("synthetic", "resume")]
    for k in ("params", "aux", "masks", "stats", "opt", "step", "updates",
              "generator", "extra"):
        bit_equal(final[0][k], final[1][k], k)

    tb_dir = os.path.join(run_dir, "tb")
    files = os.listdir(tb_dir)
    check(len(files) == 1 and files[0].startswith("events.out.tfevents."),
          f"tb/: {files}")
    events = tb.read_events(os.path.join(tb_dir, files[0]))
    check(events[0]["file_version"] == tb.FILE_VERSION, "file_version")
    logged = {}
    for ev in events[1:]:
        for v in ev["values"]:
            logged.setdefault(v["tag"], []).append(ev["step"])
    want_steps = list(range(0, SYNTH_STEPS, 20))
    check({"loss", "psnr", "num_points/Background"} <= set(logged)
          and all(steps == want_steps for steps in logged.values()),
          f"tb scalars: { {k: v[:3] for k, v in logged.items()} }")
    check(os.path.exists(os.path.join(run_dir, "backup", "tools",
                                      "train.py")), "backup/tools/train.py")

    params = final[0]["params"]["Background"]
    mask = final[0]["masks"]["Background"]
    ply = os.path.join(out, "background.ply")
    written = export.export_gaussians_to_ply(ply, params, mask,
                                             SYNTH_PLY_ALPHA)
    live = int((mask.bool() & (torch.sigmoid(params["logit_opacities"][:, 0])
                               > SYNTH_PLY_ALPHA)).sum())
    with open(ply) as f:
        header = [next(f) for _ in range(3)]
    check(header[2] == f"element vertex {live}\n" and written == live > 0,
          f"ply header {header[2]!r}, {live} live above {SYNTH_PLY_ALPHA}")
    phase("cli_synthetic", t0, steps=summ["steps"],
          steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          peak_mem_bytes=summ["peak_mem_bytes"],
          nonfinite_params=summ["nonfinite_params_max"],
          first=first, last=last, frames_psnr=frames_psnr,
          refines=summ["refines"], final_points=summ["final_points"],
          launches=launched, viewer=viewer,
          viewer_frames=summ["viewer_frames"],
          resumed_from=SYNTH_RESUME, resume_bit_equal=True,
          tb_events=len(events), tb_tags=len(logged), ply_points=live,
          train_s=round(train_s, 2),
          resume_and_downscale_s=round(resume_s, 2), device=str(dev),
          nvidia_smi=nvidia_smi())
    half_launches = cli_downscale(dev, out)
    shutil.rmtree(out)
    return launched, half_launches


def cli_downscale(dev, out: str):
    """The cli_downscale phase: the run cli_synthetic started beside its
    resume under <out>/half, tools.train on proto_scene with
    data.downscale=2 and PIL blocked (the port's resize at load), the
    presets' 5 steps (20 before the preprocess phase came, cut with
    cli_presets' depth to keep chip_smoke within its time): the images at
    half size, the test PSNR finite. Returns its launches."""
    t0 = time.perf_counter()
    with open(os.path.join(out, "half", "train_summary.json")) as f:
        summ = json.load(f)
    with open(os.path.join(out, "half", "test_metrics.json")) as f:
        psnr = json.load(f)["psnr"]
    launched = summ["launches"]
    check(tuple(summ["image_hw"]) == DOWNSCALE_HW,
          f"images loaded at {summ['image_hw']}")
    check(summ["steps"] == CLI_PRESET_STEPS and all(
        launched[k] >= CLI_PRESET_STEPS for k in TRAIN_PATH)
          and summ["nonfinite_params_max"] == 0 and math.isfinite(psnr),
          f"{summ['steps']} steps, launches {launched}, test PSNR {psnr}")
    phase("cli_downscale", t0, image_hw=summ["image_hw"],
          steps=summ["steps"],
          steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          peak_mem_bytes=summ["peak_mem_bytes"], test_psnr=psnr,
          launches=launched, steps_side_by_side="with the synthetic "
          "resume: no steps/s from them", device=str(dev),
          nvidia_smi=nvidia_smi())
    return launched


def run_clis(*calls):
    """Run (module, *argv) CLI calls of the port side by side, each in a
    subprocess with PIL blocked and its output in a file; raises with the
    end of a failed one's output."""
    procs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (module, *argv) in enumerate(calls):
            log = open(os.path.join(tmp, f"{i}.log"), "w+")
            procs.append((module, log, subprocess.Popen(
                [sys.executable, "-c", NO_PIL,
                 f"bilateral_driving_tpu_torch.tools.{module}", *argv],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for module, log, proc in procs:
            proc.wait()
            log.seek(0)
            if proc.returncode != 0:
                failed.append(f"tools.{module} exited {proc.returncode}:\n"
                              f"{log.read()[-3000:]}")
            log.close()
    if failed:
        raise SmokeError("\n".join(failed))


def run_cli(module: str, *argv) -> float:
    """Run a CLI module of the port in a subprocess with PIL blocked;
    raises with its output's end if it fails. Returns seconds."""
    t1 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", NO_PIL,
                        f"bilateral_driving_tpu_torch.tools.{module}", *argv],
                       cwd=ROOT, capture_output=True, text=True)
    if r.returncode != 0:
        raise SmokeError(f"tools.{module} exited {r.returncode}:\n"
                         f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return time.perf_counter() - t1


def cli(dev):
    """The cli phase: train, resume and evaluate proto_scene through the
    port's CLI, then render_cli and cli_grads on its run. The run
    directories (their checkpoints hold parameters and Adam moments of
    2,097,152 background slots) go to work_dirs/chip_smoke_cli in the
    checkout and are removed after. Returns the launches of render_cli and
    of cli_grads."""
    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_cli")
    shutil.rmtree(out, ignore_errors=True)
    run_dir = os.path.join(out, "train")
    train_s = run_cli("train", "--output_root", out, "--run_name", "train",
                      *CLI_OVERRIDES)
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    check(summ["steps"] == CLI_STEPS, f"trained {summ['steps']} steps")
    launched = summ["launches"]
    check(launched["segment_sum_rows"] == 0 and all(
        launched[k] >= CLI_STEPS for k in launched
        if k != "segment_sum_rows"),
          f"a kernel missed training steps of the CLI run: {launched}")
    check(summ["nonfinite_params_max"] == 0 and summ["overflow_steps"] == 0,
          f"guards: {summ}")
    check(len(summ["refines"]) >= 2, f"refines: {summ['refines']}")
    check(len(summ["downscales"]) >= 2, "no resolution-schedule crossing")
    # the preset's logging.vis_freq snapshot of step 0, written without PIL
    snap = png_rows(os.path.join(run_dir, "images", "step_0.png"))

    ckpt = os.path.join(run_dir, "checkpoints",
                        f"checkpoint_{CLI_RESUME_STEP}.pt")
    check(os.path.exists(ckpt), f"no checkpoint {ckpt}")
    resume_s = run_cli(
        "train", "--output_root", out, "--run_name", "resume",
        "--resume_from", ckpt, *CLI_OVERRIDES,
        f"trainer.max_steps={CLI_RESUME_STEP + CLI_RESUME_STEPS}")
    with open(os.path.join(out, "resume", "train_summary.json")) as f:
        resumed = json.load(f)
    check((resumed["start_step"], resumed["end_step"])
          == (CLI_RESUME_STEP, CLI_RESUME_STEP + CLI_RESUME_STEPS),
          f"resumed {resumed['start_step']}..{resumed['end_step']}")

    eval_s = run_cli("eval", "--log_dir", run_dir, "--compute_geo")
    metrics = {}
    for split in ("test", "full"):
        with open(os.path.join(run_dir, f"metrics_{split}.json")) as f:
            metrics[split] = {k: v for k, v in json.load(f).items()
                              if isinstance(v, float)}
        check(metrics[split] and all(math.isfinite(v)
                                     for v in metrics[split].values()),
              f"metrics_{split}.json not finite: {metrics[split]}")
    phase("cli", t0, steps=summ["steps"],
          steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          warmup_steps=summ["warmup_steps"],
          peak_mem_bytes=summ["peak_mem_bytes"],
          nonfinite_params=summ["nonfinite_params_max"],
          overflow_steps=summ["overflow_steps"],
          isect_capacity=summ["isect_capacity"],
          rebuckets=summ["rebuckets"], refines=summ["refines"],
          steps_per_downscale=summ["downscales"],
          final_points=summ["final_points"], launches=launched,
          resumed_steps=[resumed["start_step"], resumed["end_step"]],
          resumed_launches=resumed["launches"],
          metrics_test=metrics["test"],
          metrics_full={k: metrics["full"][k] for k in ("psnr", "ssim")},
          train_s=round(train_s, 2), resume_s=round(resume_s, 2),
          eval_s=round(eval_s, 2), snapshot_step_0=snap[:3],
          device=str(dev), nvidia_smi=nvidia_smi())
    render_launches = render_cli(dev, run_dir)
    grads_launches = cli_grads(dev, run_dir)
    shutil.rmtree(out)
    return render_launches, grads_launches


def cli_grads(dev, run_dir: str) -> dict:
    """The cli_grads phase: the cli run's state past a densification,
    rebuilt from its config.json and step-150 checkpoint as tools.eval
    rebuilds it, the kernel step's gradients held against the all-plain
    step's from the same state at CLI_GRAD_STEPS, teacher-forced: after
    each comparison and each step between them the kernel step advances
    the state. Returns the launches over those steps."""
    import torch

    from bilateral_driving_tpu_torch.tools import train as train_cli
    from bilateral_driving_tpu_torch.train import checkpoint, trainer
    from bilateral_driving_tpu_torch.utils import config as config_lib

    t0 = time.perf_counter()
    cfg = config_lib.load_config(os.path.join(run_dir, "config.json"))
    tcfg, data, statics, state = train_cli.build(cfg, 0, dev)
    state, extra = checkpoint.restore_checkpoint(os.path.join(
        run_dir, "checkpoints", f"checkpoint_{CLI_RESUME_STEP}.pt"), state)
    tcfg = dataclasses.replace(tcfg, isect_capacity=extra["isect_capacity"])
    check(state.step == CLI_GRAD_STEPS[0],
          f"the checkpoint holds step {state.step}")
    # past the resolution schedule's last doubling: full resolution
    check(state.step >= cfg.get_path("res_schedule.double_steps")
          * cfg.get_path("res_schedule.downscale_times"),
          "the checkpoint is inside the resolution schedule")
    train_idx, _ = data.split_train_test(
        cfg.get_path("data.test_image_stride", 10))
    classes = trainer.gaussian_classes(tcfg)
    wrappers = kernel_wrappers()
    zero_launches(wrappers)
    compared = []
    while state.step <= CLI_GRAD_STEPS[-1]:
        step = state.step
        batch = data.get_batch(int(train_idx[step % len(train_idx)]))
        if step not in CLI_GRAD_STEPS:
            state, m = trainer.train_step(tcfg, statics, state, batch)
            continue
        live = {c: int(state.masks[c].sum()) for c in classes}
        before = counts(wrappers)
        total, loss, out, g_k, gd_k = trainer.compute_grads(
            tcfg, statics, state, batch)
        mid = counts(wrappers)
        check(all(mid[k] > before[k] for k in TRAIN_PATH),
              f"the kernel step {step} missed a kernel: {before} -> {mid}")
        _, _, _, g_p, gd_p = plain_step_grads(tcfg, statics, state, batch)
        check(counts(wrappers) == mid,
              f"a kernel launched in the plain-version step {step}")
        rels = {k: rel_norm(g_k[k], g_p[k]) for k in g_k}
        rels["means2d"] = rel_norm(gd_k, gd_p)
        worst = max(rels, key=rels.get)
        state, m = trainer.apply_grads_and_refine(
            tcfg, statics, state, batch, total, loss, out, g_k, gd_k)
        compared.append({
            "step": step, "worst_leaf": worst, "worst_rel_norm": rels[worst],
            "leaves": len(rels), "live": live,
            "num_isects": int(out["info"]["num_isects"]),
            "overflow": bool(out["info"]["overflow"]),
            "refined": step % tcfg.density.refine_interval == 0,
            "live_after": {c: int(m[f"num_points/{c}"]) for c in classes}})
        check(rels[worst] <= GRADS_RTOL,
              f"step {step}: gradient of {worst} differs from the plain "
              f"step by {rels[worst]}")
        check(float(m["nonfinite_params"]) == 0,
              f"non-finite parameters after step {step}")
        del g_k, g_p, gd_k, gd_p, out
    torch.cuda.synchronize()
    launched = counts(wrappers)
    refined = [c for c in compared if c["refined"]]
    check(refined and refined[0]["live_after"] != refined[0]["live"],
          f"no densification among the compared steps: {compared}")
    phase("cli_grads", t0, checkpoint_step=CLI_GRAD_STEPS[0],
          compared=compared, tolerance=GRADS_RTOL, launches=launched,
          steps=CLI_GRAD_STEPS[-1] + 1 - CLI_GRAD_STEPS[0],
          nvidia_smi=nvidia_smi())
    return launched


def start_port(started: list, module: str, *argv):
    """Start `python -m bilateral_driving_tpu_torch.<module> *argv` with
    PIL importable (the preprocessing decodes and writes JPEG and PNG
    files), its output in a temporary file, and add it to `started`;
    finish_port waits for it."""
    log = tempfile.TemporaryFile("w+")
    started.append((module, log, subprocess.Popen(
        [sys.executable, "-m", f"bilateral_driving_tpu_torch.{module}",
         *argv], cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)))
    return started[-1]


def finish_port(module: str, log, proc) -> str:
    """Wait for a start_port process; its output, or raise with its end."""
    proc.wait()
    log.seek(0)
    text = log.read()
    if proc.returncode != 0:
        raise SmokeError(f"{module} exited {proc.returncode}:\n"
                         f"{text[-3000:]}")
    return text


def preprocess_cli(*argv) -> dict:
    """preprocess.cli in this process; its stage seconds."""
    import io

    from bilateral_driving_tpu_torch.preprocess import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    return stage_seconds(buf.getvalue())


def stage_seconds(log: str) -> dict:
    """The `stage <name>: <s> s` lines of a preprocess.cli run."""
    out = {}
    for line in log.splitlines():
        if line.startswith("stage ") and line.endswith(" s"):
            name, sec = line[len("stage "):-2].split(": ")
            out[name] = float(sec)
    return out


def same_trees(a: str, b: str, skip=()) -> int:
    """Raise unless every file under `a` (outside the `skip` directories)
    equals its counterpart under `b` and `b` has no other: byte for byte,
    JSON as parsed, pickles (smpl.pkl) bit for bit. Returns the count."""
    import pickle

    def files(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs
                      if os.path.relpath(d, root).split(os.sep)[0]
                      not in skip)

    names = files(a)
    check(names == files(b), f"the trees' files differ: "
          f"{sorted(set(names) ^ set(files(b)))[:10]}")
    for rel in names:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            da, db = fa.read(), fb.read()
        if rel.endswith(".json"):
            check(json.loads(da) == json.loads(db), f"{rel} differs")
        elif rel.endswith(".pkl"):
            bit_equal(pickle.loads(da), pickle.loads(db), rel)
        else:
            check(da == db, f"{rel} differs")
    return len(names)


def segformer_check(ckpt: str, image_path: str, dev) -> dict:
    """SegFormer from the checkpoint directory on one image: float32
    against float64 (the logits' error relative to the largest float64
    logit; the pixels whose upsampled argmax differs, each of which must
    be a near-tie: its two best float64 classes at most twice the largest
    upsampled difference apart), the image processor's output on the
    card equal to the CPU's and the least ms of each over PRE_SEG_REPEATS
    runs, segment_image's ms per image over PRE_SEG_REPEATS runs (CUDA
    events), the process's peak memory over the float32
    forward and that peak less what was allocated before it."""
    import numpy as np
    import torch
    from PIL import Image

    from bilateral_driving_tpu_torch.preprocess import masks

    check(not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32), "TF32 is on")
    model, proc = masks.load_segmenter(ckpt, device=dev)
    img = np.asarray(Image.open(image_path).convert("RGB"))
    x = proc(img, dev)
    # the image processor (data/scene.resize, rescale, normalise) on the
    # card and on the CPU: the same bits, and the time of each
    check(torch.equal(x.cpu(), proc(img, "cpu")),
          "the image processor differs between the card and the CPU")
    proc_ms = {}
    for where in (dev, "cpu"):
        times = []
        for _ in range(PRE_SEG_REPEATS):
            t1 = time.perf_counter()
            proc(img, where)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        proc_ms[str(where)] = min(times)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.no_grad():
        l32 = model(x)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    masks.segment_image(model, proc, img)
    ms = cuda_ms(lambda: masks.segment_image(model, proc, img),
                 PRE_SEG_REPEATS)
    model64 = copy.deepcopy(model).double()
    with torch.no_grad():
        l64 = model64(x.double())
    del model64
    rel = float((l32.double() - l64).abs().max() / l64.abs().max())
    up32, up64 = (torch.nn.functional.interpolate(
        lg, size=img.shape[:2], mode="bilinear", align_corners=False)[0]
        for lg in (l32.double(), l64))
    err = float((up32 - up64).abs().max())
    differ = up32.argmax(0) != up64.argmax(0)
    top2 = up64[:, differ].topk(2, dim=0).values
    gaps = (top2[0] - top2[1]) if int(differ.sum()) else top2.new_zeros(1)
    check(rel <= PRE_LOGIT_RTOL, f"SegFormer float32 logits {rel} from "
          "float64 relative")
    check(bool((gaps <= 2 * err).all()), "a pixel's class differs between "
          "float32 and float64 where its two best classes are apart")
    return {"params": sum(p.numel() for p in model.parameters()),
            "input_hw": list(x.shape[2:]), "logits_hw": list(l32.shape[2:]),
            "logits_rel_err_f32_vs_f64": rel,
            "upsampled_max_abs_err": err,
            "pixels_class_differs_share": float(differ.float().mean()),
            "largest_gap_where_differs": float(gaps.max()),
            "tolerance": f"logits {PRE_LOGIT_RTOL} relative; a differing "
                         "class only where its float64 top two are within "
                         "twice the largest upsampled difference",
            "ms_per_image": ms,
            "processor_equal_cuda_cpu": True,
            "processor_min_ms": proc_ms,
            "peak_mem_bytes": peak,
            "forward_peak_above_allocated_bytes": peak - base,
            "weights_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters())}


def preprocess_phase(dev, seed: int) -> dict:
    """The preprocess phase (module docstring). The log, the two trees,
    the checkpoint and the run directory go to
    work_dirs/chip_smoke_preprocess and are removed after. Returns the
    training run's launches. Every process it starts has ended when it
    returns or raises."""
    started = []
    try:
        return _preprocess(dev, seed, started)
    finally:
        for _, log, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()


def _preprocess(dev, seed: int, started: list) -> dict:
    import torch

    from bilateral_driving_tpu_torch.models import segformer
    from bilateral_driving_tpu_torch.preprocess import masks
    from bilateral_driving_tpu_torch.tools import raw_scene

    t0 = time.perf_counter()
    out = os.path.join(ROOT, "work_dirs", "chip_smoke_preprocess")
    shutil.rmtree(out, ignore_errors=True)
    raw = raw_scene.write_raw_log(os.path.join(out, "raw"), seed)
    seconds = {"raw_log": time.perf_counter() - t0}
    trees = {d: os.path.join(out, d) for d in ("cuda", "cpu")}
    scenes = {d: os.path.join(t, "000") for d, t in trees.items()}
    common = ["--dataset", "nuscenes", "--data_root", raw]
    # the cpu tree's conversion in a process of its own, beside the cuda
    # tree's stages in this one
    cpu_run = start_port(started, "preprocess.cli", *common, "--target_dir",
                         trees["cpu"], "--device", "cpu", "--process_keys",
                         *PRE_KEYS)
    t1 = time.perf_counter()
    stages = {"cuda": preprocess_cli(*common, "--target_dir", trees["cuda"],
                                     "--device", "cuda", "--process_keys",
                                     *PRE_KEYS)}
    seconds["convert_cuda"] = time.perf_counter() - t1
    # the tracker outputs, then a SegFormer-b5 checkpoint of random weights
    t1 = time.perf_counter()
    trackers = raw_scene.write_humanpose(scenes["cuda"], seed)
    cfg = segformer.SegformerConfig(**segformer.B5_CITYSCAPES)
    with torch.device(dev):
        net = segformer.SegformerForSemanticSegmentation(cfg)
    segformer.init_weights(net, torch.Generator(device=dev).manual_seed(seed))
    ckpt = masks.write_checkpoint(
        os.path.join(out, "segformer_b5"), cfg, net,
        masks.ImageProcessor(size=segformer.B5_INPUT_HW))
    del net
    seconds["trackers_and_checkpoint"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    stages["cuda"].update(preprocess_cli(
        *common, "--target_dir", trees["cuda"], "--device", "cuda",
        "--process_keys", "sky_masks", "humanpose", "--checkpoint", ckpt))
    seconds["sky_and_humanpose_cuda"] = time.perf_counter() - t1
    images = sorted(os.listdir(os.path.join(scenes["cuda"], "images")))
    # the cpu tree: its conversion's end, then its tracks matched; the
    # trees held against each other
    t1 = time.perf_counter()
    stages["cpu"] = stage_seconds(finish_port(*cpu_run))
    seconds["convert_cpu_waited"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    os.makedirs(os.path.join(scenes["cpu"], "humanpose"))
    for path in trackers.values():
        shutil.copy(path, os.path.join(scenes["cpu"], "humanpose"))
    stages["cpu"].update(preprocess_cli(
        *common, "--target_dir", trees["cpu"], "--device", "cpu",
        "--process_keys", "humanpose"))
    check(set(stages["cuda"]) == {"convert", "ego_masks", "sky_masks",
                                  "humanpose"}
          and set(stages["cpu"]) == {"convert", "ego_masks", "humanpose"},
          f"stages {stages}")
    n_files = same_trees(scenes["cpu"], scenes["cuda"], skip=("sky_masks",))
    n_frames, n_cams = 11, len(raw_scene.CAMERA_RIG)
    check(len(images) == n_frames * n_cams and sorted(os.listdir(
        os.path.join(scenes["cuda"], "sky_masks"))) == [
            f.replace(".jpg", ".png") for f in images],
          "not one sky mask per image")
    import pickle

    with open(os.path.join(scenes["cuda"], "humanpose", "smpl.pkl"),
              "rb") as f:
        smpl = pickle.load(f)
    with open(os.path.join(scenes["cuda"], "instances",
                           "instances_info.json")) as f:
        info = json.load(f)
    walkers = [k for k, v in info.items()
               if v["class_name"].startswith("human.pedestrian")]
    check(len(info) == raw_scene.ANNOTATIONS
          and sorted(smpl) == sorted(int(k) for k in walkers)
          and all(v["valid_mask"].any() for v in smpl.values()),
          f"smpl.pkl holds {sorted(smpl)}, the pedestrians are {walkers}")
    seconds["cpu_tracks_and_compare"] = time.perf_counter() - t1
    # with nothing else running: SegFormer's check and timing, then the
    # converted scene trained through the CLI in a process of its own
    seg = segformer_check(ckpt, os.path.join(scenes["cuda"], "images",
                                             images[0]), dev)
    t_train = time.perf_counter()
    train_log = finish_port(*start_port(
        started, "tools.train", "--config", "omnire_ms_bilateral",
        "--output_root", out, "--run_name", "train",
        f"data.scene_dir={scenes['cuda']}", *PRE_TRAIN_OVERRIDES))
    seconds["train"] = time.perf_counter() - t_train
    built = [line.split("built in ")[-1] for line in train_log.splitlines()
             if "built in " in line]
    run_dir = os.path.join(out, "train")
    with open(os.path.join(run_dir, "train_summary.json")) as f:
        summ = json.load(f)
    with open(os.path.join(run_dir, "test_metrics.json")) as f:
        test = json.load(f)
    launched = summ["launches"]
    check(summ["steps"] == PRE_TRAIN_STEPS
          and launched["segment_sum_rows"] == 0
          and all(launched[k] >= PRE_TRAIN_STEPS for k in TRAIN_PATH),
          f"{summ['steps']} steps, launches {launched}")
    check(summ["nonfinite_params_max"] == 0
          and summ["final_points"].get("SMPLNodes", 0) > 0,
          f"guards or SMPL: {summ}")
    check(math.isfinite(test["psnr"]), f"test PSNR {test['psnr']}")
    phase("preprocess", t0, raw_log={
              "cameras": n_cams, "image_wh": [raw_scene.WIDTH,
                                              raw_scene.HEIGHT],
              "lidar_points_per_sweep": raw_scene.BEAMS * raw_scene.AZIMUTHS,
              "keyframes": raw_scene.NUM_KEYFRAMES,
              "annotations_per_keyframe": raw_scene.ANNOTATIONS},
          frames=n_frames, files_equal_cuda_cpu=n_files,
          pedestrians_in_smpl_pkl=len(smpl), stage_s={"cuda": stages["cuda"],
                                                       "cpu": stages["cpu"]},
          wall_s={k: round(v, 3) for k, v in seconds.items()},
          segformer=seg, train_steps=summ["steps"], train_built_in=built,
          train_steps_per_s_after_warmup=summ["steps_per_s_after_warmup"],
          train_peak_mem_bytes=summ["peak_mem_bytes"],
          final_points=summ["final_points"], launches=launched,
          test_psnr=test["psnr"], device=str(dev), nvidia_smi=nvidia_smi())
    shutil.rmtree(out)
    return launched


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "bilateral_driving_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    torch.set_grad_enabled(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from bilateral_driving_tpu_torch import configs
    from bilateral_driving_tpu_torch.data import synthetic
    from bilateral_driving_tpu_torch.eval import render_loop
    from bilateral_driving_tpu_torch.ops import (binning, cuda_build,
                                                 expand_cuda, pipeline,
                                                 rasterize_cuda, scan_cuda,
                                                 scan_utils)
    from bilateral_driving_tpu_torch.tools import kernel_resources
    from bilateral_driving_tpu_torch.train import trainer

    # ---- env
    t0 = time.perf_counter()
    nvcc = cuda_build.nvcc()
    nvcc_ver = subprocess.run([nvcc, "--version"], capture_output=True,
                              text=True, check=True).stdout.strip()
    smi = nvidia_smi()
    phase("env", t0, torch=torch.__version__, cuda=torch.version.cuda,
          python=sys.version.split()[0], nvcc=nvcc,
          nvcc_version=nvcc_ver.splitlines()[-1],
          ninja=shutil.which("ninja"),
          yaml=importlib.util.find_spec("yaml") is not None,
          pil=importlib.util.find_spec("PIL") is not None,
          device=torch.cuda.get_device_name(0),
          device_count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- build
    t0 = time.perf_counter()
    cold = cuda_build.build()
    cold_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    warm = cuda_build.build()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    phase("build", t0, cold_s=round(cold_s, 3), compiled=cold,
          warm_s=round(time.perf_counter() - t1, 4), warm_compiled=warm)

    # ---- scene
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(args.seed)
    scene = synthetic.make_scene(
        g, num_bg=NUM_BG, num_frames=NUM_FRAMES, num_cams=NUM_CAMS,
        width=WIDTH, height=HEIGHT, focal=FOCAL, num_rigid=RIGID,
        rigid_pts=PTS, num_deformable=DEFORM, deformable_pts=PTS, device=dev)
    data = synthetic.SyntheticData(scene)
    cfg = configs.flagship_config(data.num_images, NUM_FRAMES)
    state, statics = synthetic.random_state(
        scene, cfg, g, configs.FLAGSHIP_BG_CAPACITY,
        configs.FLAGSHIP_MAX_STEPS, device=dev)
    full_statics = trainer.merge_statics(statics, state.aux)
    neighbor_map = data.neighbor_train_indices(TEST_STRIDE)
    check(all(i in neighbor_map for i in TEST_VIEWS), "test views")

    novel = synthetic.make_batch(scene, 0)
    c2w = novel["camera_to_world"].clone()
    yaw = math.radians(5.0)
    rot = torch.tensor([[math.cos(yaw), 0.0, math.sin(yaw)], [0.0, 1.0, 0.0],
                        [-math.sin(yaw), 0.0, math.cos(yaw)]], device=dev)
    c2w[:3, :3] = rot @ c2w[:3, :3]
    c2w[:3, 3] += torch.tensor([-0.5, -0.2, 0.0], device=dev)
    novel["camera_to_world"] = c2w
    novel["viewdirs"] = synthetic.pixel_viewdirs(HEIGHT, WIDTH, scene.K, c2w)

    cap, probes = isect_capacity(
        cfg, state, full_statics,
        [(data.get_batch(i), False) for i in TRAIN_VIEWS]
        + [(data.get_batch(i), True) for i in TEST_VIEWS] + [(novel, True)],
        WIDTH, HEIGHT, scene.K)
    cfg = configs.flagship_config(data.num_images, NUM_FRAMES,
                                  isect_capacity=cap)
    torch.cuda.synchronize()
    phase("scene", t0, width=WIDTH, height=HEIGHT,
          images=data.num_images, bg_capacity=configs.FLAGSHIP_BG_CAPACITY,
          bg_live=int(state.masks["Background"].sum()),
          rigid_points=int(state.masks["RigidNodes"].sum()),
          deformable_points=int(state.masks["DeformableNodes"].sum()),
          envlight_resolution=cfg.envlight_resolution,
          probe_num_isects=probes, isect_capacity=cap)

    # ---- kernels: capture the main path's kernel inputs on one frame; the
    # stand-ins record the arguments and call the real wrappers
    t0 = time.perf_counter()
    captured = {}
    with kernels_replaced(
            pipeline, binning,
            capturing(captured, "expand", expand_cuda.expand_gather),
            capturing(captured, "rasterize_fwd",
                      rasterize_cuda.rasterize_fwd),
            types.SimpleNamespace(
                cumsum=capturing(captured, "scan", scan_utils.cumsum),
                cummax=scan_utils.cummax)):
        render_loop.render_images(cfg, state, statics, data, TRAIN_VIEWS[:1])
    check(set(captured) == {"expand", "rasterize_fwd", "scan"},
          f"captured {sorted(captured)}")

    ea = captured["expand"][0]
    expand_checked = expand_cases(ea, dev, args.seed)
    expand_err = expand_checked["main path"]["max_abs_err"]

    ra = captured["rasterize_fwd"][0]
    render_fwd, plain_fwd = forward_check("render path", *ra)
    raster_err = render_fwd["max_abs_err"]
    n_live, n_blend = plain_fwd.n_live, plain_fwd.n_blend
    # registers, shared memory, resident blocks per SM and, for the
    # forward's clusters, its cluster size and the clusters resident on the
    # card at once, of the two kernels redesigned for Hopper last, at the
    # block sizes they launch (their launch bounds)
    driver = kernel_resources.driver()
    resources = {name: kernel_resources.resources(
        str(cuda_build.library_path(name)), None, driver)
        for name in ("rasterize_fwd", "expand")}
    check(all(r.get("clusters_on_card", 0) > 0
              for r in resources["rasterize_fwd"]),
          f"compositing forward: no cluster fits the card: {resources}")
    # the scan: tools/driver_smoke.py's float32 shapes, then the main
    # path's int32 tile counts and a capacity-long int32 cummax
    gs = torch.Generator(device=dev).manual_seed(args.seed)
    scan_cases = {}
    xs = {"rows": torch.randn((4, 1 << 16), generator=gs, device=dev),
          "1d": torch.randn((1, 1 << 17), generator=gs, device=dev)}
    for shape, x in xs.items():
        for op in ("sum", "max", "min") if shape == "rows" else ("sum",):
            got = (scan_cuda.scan_rows(x, op) if shape == "rows"
                   else scan_cuda.scan1d(x[0], op)[None])
            want = scan_cuda.scan_rows_plain(x, op)
            err = float((got - want).abs().max())
            if op == "sum":
                ok = bool(torch.all(
                    (got - want).abs() <= SCAN_ATOL + SCAN_RTOL * want.abs())
                    and torch.all((got.double() - want.double()).abs()
                                  <= SCAN_SUM_REL * torch.cumsum(
                                      x.double().abs(), 1)))
            else:
                ok = torch.equal(got, want)
            scan_cases[f"{shape} {tuple(x.shape)} f32 {op}"] = err
            check(ok, f"scan {op} {tuple(x.shape)} differs from its plain "
                  f"version (max abs err {err})")
    scan_counts = captured["scan"][0][0]
    got = scan_utils.cumsum(scan_counts)
    want_counts = scan_cuda.scan_rows_plain(scan_counts[None], "sum")[0]
    check(got.dtype == torch.int32 and torch.equal(got, want_counts),
          "scan cumsum differs from its plain version on the main path's "
          "tile counts")
    scan_err = float((got.long() - want_counts.long()).abs().max())
    scan_cases[f"main path ({scan_counts.numel()},) i32 sum"] = scan_err
    n_g = int(ea[1].shape[0]) - 1
    mono_k = binning.fill_monotone(
        torch.arange(n_g, dtype=torch.int32, device=dev), ea[1][:-1], ea[3])
    with patched((binning, "scan_utils", plain_scans())):
        mono_p = binning.fill_monotone(
            torch.arange(n_g, dtype=torch.int32, device=dev), ea[1][:-1],
            ea[3])
    check(torch.equal(mono_k, mono_p), "scan cummax differs from its plain "
          "version on a capacity-long int32 input")
    scan_cases[f"fill_monotone ({ea[3]},) i32 max"] = float(
        (mono_k.long() - mono_p.long()).abs().max())
    # the look-back's edges: int32 lengths around a tile (a row's masked
    # tail, its first look-back) and rows that each start a new walk
    tile = scan_cuda.TILE
    others = []
    for shape in [(1,), (31,), (tile - 1,), (tile,), (tile + 1,),
                  (3, 20_000)]:
        x = torch.randint(-1000, 1000, shape, generator=gs, device=dev,
                          dtype=torch.int32)
        want = {op: scan_cuda.scan_rows_plain(x.view(-1, shape[-1]), op)
                .view(shape) for op in ("sum", "max", "min")}
        others.append((x, want["sum"]))
        for op in ("sum", "max", "min"):
            got = (scan_cuda.scan_rows(x, op) if x.dim() == 2
                   else scan_cuda.scan1d(x, op))
            check(torch.equal(got, want[op]), f"scan {op} of int32 "
                  f"{shape} differs from its plain version")
        scan_cases[f"{shape} i32 sum, max, min"] = 0.0
    # a sum past 2^31, held against its plain version and the int64 sum
    # wrapped to 32 bits
    big = torch.randint(2 ** 28, 2 ** 30, (100_003,), generator=gs,
                        device=dev, dtype=torch.int32)
    wrapped = ((torch.cumsum(big.long(), 0) + 2 ** 31) % 2 ** 32
               - 2 ** 31).int()
    got = scan_utils.cumsum(big)
    check(torch.equal(got, scan_cuda.scan_rows_plain(big[None], "sum")[0])
          and torch.equal(got, wrapped),
          "scan sum past 2^31 does not wrap like its plain version")
    scan_cases["(100003,) i32 sum past 2^31"] = 0.0
    others.append((big, wrapped))
    # the main path's counts 200 times back to back, another length
    # between any two: a stale status word or a wrong counter base would
    # give a wrong prefix
    for i in range(200):
        check(torch.equal(scan_utils.cumsum(scan_counts), want_counts),
              f"scan of the main path's counts differs at repeat {i}")
        x, want = others[i % len(others)]
        got = (scan_cuda.scan_rows(x, "sum") if x.dim() == 2
               else scan_utils.cumsum(x))
        check(torch.equal(got, want), f"scan sum of {tuple(x.shape)} "
              f"differs from its plain version at repeat {i}")
    scan_cases[f"main path ({scan_counts.numel()},) i32 sum x 200, "
               "interleaved"] = 0.0
    phase("kernels", t0, expand_bit_exact=True,
          expand_cases=expand_checked,
          gaussians=int(ea[1].shape[0]) - 1, capacity=ea[3],
          rasterize_fwd_render_path=render_fwd,
          rasterize_tolerance=f"atol {RASTER_ATOL} + rtol {RASTER_RTOL}",
          kernel_resources=resources,
          render_live_chunk_spread=live_chunk_spread(ra[1], ra[2], n_live),
          tiles=int(ra[1].shape[0]), live_chunks=int(n_live.sum()),
          scan_max_abs_err=scan_cases,
          scan_tolerance=(f"max, min and int32 bit-exact; f32 sum atol "
                          f"{SCAN_ATOL} + rtol {SCAN_RTOL} and within "
                          f"{SCAN_SUM_REL} x cumsum(|x|)"))

    # ---- render: the main path, counters from 0
    t0 = time.perf_counter()
    render_wrappers = (expand_cuda.expand_gather,
                       rasterize_cuda.rasterize_fwd, scan_cuda.scan_rows)
    launches = [0, 0, 0]
    for f in render_wrappers:
        f.launches = 0
    frames, frame_s = [], []
    views = ([(i, None) for i in TRAIN_VIEWS] + [(i, None) for i in TEST_VIEWS]
             + [(None, novel)])
    for idx, batch in views:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if batch is None:
            res = render_loop.render_images(cfg, state, statics, data, [idx],
                                            neighbor_map)
            rgb, depth, opac = (res["rgbs"][0], res["depths"][0],
                                res["opacities"][0])
            num_isects, overflow = res["num_isects"][0], res["overflow"][0]
        else:
            o = trainer.forward(cfg, state.params, full_statics, state.masks,
                                batch, state.step, in_test_set=True,
                                novel_view=True)
            rgb, depth, opac = o["rgb"], o["depth"][..., 0], o["opacity"][..., 0]
            num_isects, overflow = o["info"]["num_isects"], o["info"]["overflow"]
        torch.cuda.synchronize()
        frame_s.append(time.perf_counter() - t1)
        now = [f.launches for f in render_wrappers]
        check(all(a > b for a, b in zip(now, launches)),
              f"a kernel did not launch for view {idx}: {launches} -> {now}")
        launches = now
        check(rgb.shape == (HEIGHT, WIDTH, 3), f"rgb shape {rgb.shape}")
        check(all(bool(torch.isfinite(x).all()) for x in (rgb, depth, opac)),
              f"non-finite output for view {idx}")
        check(not bool(overflow), f"intersection overflow for view {idx}")
        check(int(num_isects) > 0, f"no intersections for view {idx}")
        frames.append({"image": idx, "num_isects": int(num_isects),
                       "opacity_mean": round(float(opac.mean()), 4),
                       "rgb_mean": round(float(rgb.mean()), 4)})
    n_frames = len(views)
    phase("render", t0, frames=frames,
          launches={"expand": launches[0], "rasterize_fwd": launches[1],
                    "scan": launches[2]},
          ms_per_frame=[round(1e3 * s, 2) for s in frame_s])

    # ---- reference: one frame through the plain versions
    t0 = time.perf_counter()
    batch = data.get_batch(TRAIN_VIEWS[0])
    o_k = trainer.forward(cfg, state.params, full_statics, state.masks,
                          batch, state.step)
    counts_before = [f.launches for f in render_wrappers]
    with kernels_replaced(
            pipeline, binning, expand_cuda.expand_gather_plain,
            lambda *a: rasterize_cuda.rasterize_fwd_plain(*a).img,
            plain_scans()):
        o_p = trainer.forward(cfg, state.params, full_statics, state.masks,
                              batch, state.step)
    check([f.launches for f in render_wrappers] == counts_before,
          "a kernel launched in the plain reference frame")
    frame_err = float((o_k["rgb"] - o_p["rgb"]).abs().max())
    check(frame_err <= FRAME_ATOL,
          f"frame differs from its plain render by {frame_err}")
    phase("reference", t0, frame_max_abs_err=frame_err,
          tolerance=FRAME_ATOL)

    # ---- times, and each kernel's bound from this run's inputs
    t0 = time.perf_counter()
    offsets, e_cap = ea[1].long(), ea[3]
    used_gaussians = int((offsets[1:] > offsets[:-1]).sum())
    expand_bytes = (used_gaussians * EXPAND_ROWS_READ * 4 + 4
                    + e_cap * (4 + 4 + 4 * expand_cuda.NFEAT))
    starts = ra[1]
    raster_work = compositing_work(ra[0], starts, ra[2], n_live, ra[3],
                                   int(n_blend), ENTRY_OPS, BLEND_OPS)
    live_entries = raster_work["live_entries"]
    raster_ops = raster_work["ops"]
    raster_bytes = (live_entries * 4 * rasterize_cuda.NFEAT
                    + starts.numel() * (8 + rasterize_cuda.N_OUT * PIX_BYTES))
    kernels = []
    for name, source, replaces, fn, plain, nbytes, nops, err in [
            ("expand", "bilateral_driving_tpu_torch/csrc/expand.cu",
             "bilateral_driving_tpu/ops/expand_pallas.py:159",
             lambda: expand_cuda.expand_gather(*ea),
             lambda: expand_cuda.expand_gather_plain(*ea),
             expand_bytes, 0, expand_err),
            ("rasterize_fwd", "bilateral_driving_tpu_torch/csrc/rasterize_fwd.cu",
             "bilateral_driving_tpu/ops/rasterize_pallas.py:370",
             lambda: rasterize_cuda.rasterize_fwd(*ra),
             lambda: rasterize_cuda.rasterize_fwd_plain(*ra),
             raster_bytes, raster_ops, raster_err)]:
        kernels.append(timed(name, source, replaces, launches[len(kernels)],
                             err, fn, plain, None, nbytes, nops))
    # the scan at the main path's shape: one int32 read and one int32
    # write per element, one add each
    n_scan = scan_counts.numel()
    scan_bytes = 8 * n_scan
    kernels.append(timed(
        "scan", "bilateral_driving_tpu_torch/csrc/scan.cu",
        "bilateral_driving_tpu/ops/scan_pallas.py:74", launches[2], scan_err,
        lambda: scan_utils.cumsum(scan_counts),
        lambda: scan_cuda.scan_rows_plain(scan_counts[None], "sum"),
        lambda: torch.cumsum(scan_counts, 0, dtype=torch.int32),
        scan_bytes, n_scan, plain_reps=20))
    for k in kernels:
        k["launches_per_frame"] = k["launches"] / n_frames
    phase("times", t0, ms_per_frame_median=round(
        1e3 * sorted(frame_s)[len(frame_s) // 2], 2),
          used_gaussians=used_gaussians, expand_bytes=expand_bytes,
          raster_work=raster_work, scan_elements=n_scan,
          scan_bytes=scan_bytes,
          nvidia_smi=nvidia_smi())

    # ---- profile: where one frame's device time goes
    t0 = time.perf_counter()
    render_loop.render_images(cfg, state, statics, data, TRAIN_VIEWS[:1])
    median_ms = 1e3 * sorted(frame_s)[len(frame_s) // 2]
    prof = device_profile(lambda: render_loop.render_images(
        cfg, state, statics, data, TRAIN_VIEWS[:1]), median_ms)
    phase("profile", t0, profiled_frame_ms=prof.pop("profiled_ms"),
          device_idle_share_of_median_frame=prof.pop(
              "device_idle_share_of_median"), **prof)

    edit_l = edit_phase(cfg, data, state, statics, dev)

    train_kernels, scan_per_step, fwd_train = training(
        args, cfg, scene, state, statics, dev)
    kernels[2]["launches_per_step"] = scan_per_step
    # the forward's second row: with residuals, at the training inputs
    kernels[1]["residuals_at_train_inputs"] = fwd_train
    kernels += train_kernels
    for k in kernels:
        k["launches_edit"] = {path: launched[k["name"]]
                              for path, launched in edit_l.items()}

    # every kernel's launches on the omnire_bilateral path: render frames
    # and training steps
    render_l, n_frames, train_l, n_steps, scene_rng, _ = smpl_preset(
        "bilateral_", "omnire_bilateral", args, dev)
    for k in kernels:
        k["launches_omnire_bilateral"] = {
            "render": render_l[k["name"]], "frames": n_frames,
            "train": train_l[k["name"]], "steps": n_steps}
    # omnire on the same scene, then the other appearance models
    render_l, n_frames, train_l, n_steps, _, batches = smpl_preset(
        "omnire_", "omnire", args, dev, scene_rng)
    for k in kernels:
        k["launches_omnire"] = {
            "render": render_l[k["name"]], "frames": n_frames,
            "train": train_l[k["name"]], "steps": n_steps}
    appearance_variants(args, dev, scene_rng, batches)
    bg_launches = background_variants(args, dev, scene_rng, batches)
    for k in kernels:
        k["launches_background_variants"] = {
            name: {"train": launched[k["name"]], "steps": 1}
            for name, launched in bg_launches.items()}
    opt_launches, renders = option_variants(args, dev, scene_rng, batches)
    for k in kernels:
        k["launches_option_variants"] = {
            name: {"train": launched[k["name"]], "steps": 1}
            for name, launched in opt_launches.items()}
    par_launches = parallel_phase(args, dev, scene_rng, batches)
    for k in kernels:
        k["launches_parallel"] = {
            path: launched[k["name"]]
            for path, launched in par_launches.items()}
        k["launches_parallel"]["cli_steps"] = CLI_PRESET_STEPS
    del scene_rng, batches
    lpips_weights = lpips_phase(dev, renders)
    del renders
    yaml_l = cli_yaml(dev, lpips_weights)
    for k in kernels:
        k["launches_cli_yaml"] = {"train": yaml_l[k["name"]],
                                  "steps": CLI_YAML_STEPS}

    render_l, grads_l = cli(dev)
    for k in kernels:
        k["launches_render_cli"] = {"novel": render_l[k["name"]],
                                    "frames": RENDER_FRAMES}
        k["launches_cli_grads"] = {
            "train": grads_l[k["name"]],
            "steps": CLI_GRAD_STEPS[-1] + 1 - CLI_GRAD_STEPS[0]}
    cli_smpl(dev)
    cli_omnire(dev)
    cli_presets(dev)
    synth_l, half_l = cli_synthetic(dev)
    for k in kernels:
        k["launches_cli_synthetic"] = {"train": synth_l[k["name"]],
                                       "steps": SYNTH_STEPS}
        k["launches_cli_downscale"] = {"train": half_l[k["name"]],
                                       "steps": CLI_PRESET_STEPS}

    pre_l = preprocess_phase(dev, args.seed)
    for k in kernels:
        k["launches_preprocess"] = {"train": pre_l[k["name"]],
                                    "steps": PRE_TRAIN_STEPS}

    phase("total", t_start, seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
