#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (unicorn_torch) on one NVIDIA card.

    python3 chip_smoke.py            # every phase, as the port's quickest proof

Phases (each must pass, else the exit code is 1):
  build      the card's name and power limit; every CUDA source of csrc/
             built with nvcc (dwconv7x7, dw7x7_wgrad, convnext_block, msda,
             correlation, correlation_train, tracker_step) and the host
             libraries (the image codec
             imcodec.cpp, the evaluators' RLE codec rle.cpp and COCOeval
             matcher cocoeval.cpp, the ingest's space-to-depth packer
             pack.cpp) with the system C++ compiler, in parallel
  kernels    each kernel against its plain PyTorch version at the main
             paths' shapes and at ragged ones (the training correlation at
             K = 1 and at the VOS + MOTS step's K = 3, both timed; the
             correlation kernels also at K = 17 and 33 label maps, one
             launch a group of 16; dw7x7
             and MSDA also at widths the wrapper zero-pads: C = 12, 20 and
             D = 6), in bf16 and fp32, with times (dw7x7 per shape, with
             the tiling its launcher picks; the fused block per shape, with
             its plan, each kernel's time per launch and, at C <= 256, the
             other route; dw7x7 also at the r50 head's, at
             unicorn_track_tiny_rt's 640x1024 shapes and at the shapes of
             a rank of the 800x1280 frame split over 4 (7 or 6 units of
             32 rows and the halo), MSDA and the serving
             correlation at _rt's, each with its path in `per_shape`)
             of kernel, plain version and the PyTorch library call that
             computes the same function, and the bound; the dw7x7 filter
             gradient (dw7x7_wgrad) at every shape of the uni step in bf16
             and fp32 and at the serving shapes, two calls bit-equal,
             timed beside cuDNN's dgrad + wgrad of the same (x, dy); the
             gradients of the dw7x7, fused-block and MSDA autograd
             Functions against autograd of their plain versions
  model      the ConvNeXt-Tiny Unicorn at 800x1280 in bf16 (seeded random
             weights): forward_whole through the dw7x7 kernel vs the same
             model through the plain version, on the card
  main       the MOT path: MOTDriver.update over synthetic 1080x1920 uint8
             frames, letterboxed on the card; frames/s, per-stage ms, dets
             and tracks per frame, launch counts (27 dw7x7 per frame); with
             set_fast_norms one frame's decoded anchors against the exact
             norms (the drift printed against JAX's bounds, 2e-2 and 1.0
             px, and held within twice the fp32 model's distance from the
             bf16 one), 16 frames/s with the switch, forward_whole's
             device ms each way, whether PyTorch's norms take a bf16 map
             with an fp32 affine, the exact and fast norm forms' ms
  block_model  the same model with each of its 27 ConvNeXt blocks run as
             one convnext_block call (the fused block kernels) against the
             model's own blocks; 27 launches of the op; ms per frame for the
             27 blocks each way
  stream     the streaming MOT path: tracker_step on the card against the
             same function on the CPU over a synthetic detection clip; the
             tracker step's kernel against the plain form on the card at the
             serving cell's shapes (S 8, T 256, D 256) over 60 crowded
             frames, with its launches, auction rounds and device us a
             frame beside the plain form's host ms; then
             StreamingMOTPipeline (3 warm-up frames, 16 push_frame, the same
             frames as two run_chunk of 8, one run_chunk with n_streams=2);
             frames/s beside MOTDriver.update on the same frames, tracker ms,
             tracker launches, auction rounds and host synchronisations per
             frame, the tracker's outputs at the pipeline's shapes (S 1,
             T 128, D 64) against the plain form, 27 dw7x7 launches per frame
  sot_model  the served model (bf16 trunk, bf16 interaction): one SOT frame
             through the three kernels vs through their plain versions
  sot        the SOT path: SOTDriver.initialize, 16 track calls, one
             track_window of 8 frames (window 4), then 4 track calls with
             the MSDA kernel's direct mode; frames/s, per-stage ms, launch
             counts (27 dw7x7, 1 msda, 1 correlation per frame or chunk)
  inst       instance segmentation (ExpDetMask.get_inst_forward on the
             unicorn_inst_convnext_tiny_800x1280 YOLOXDet, bf16, 80
             classes): one image through the dw7x7 kernel vs its plain
             version (raw logits, controllers, mask features, masks); 3
             warm-up and 16 timed 1080x1920 uint8 frames (device letterbox,
             forward, decode + NMS, CondInst mask decode): frames/s,
             per-stage ms, detections per frame, peak memory, 27 dw7x7
             launches a frame; one frame of the unicorn_track_tiny_mask
             Unicorn through forward_whole and forward_mask_branch
  vos        VOS serving (VOSDriver on the served unicorn_track_tiny_mask
             Unicorn, bf16, RAFT up-mask at rate 4; 480x854 uint8 frames
             letterboxed into 800x1280): one general-path frame at K = 4
             through the dw7x7, MSDA and correlation kernels vs their plain
             versions (priors, top detections, masks); initialize with 4
             objects, 3 warm-up and 16 timed track calls on the
             shared-reference path, add_objects with a fifth, 8 timed track
             calls on the general path: frames/s, per-stage ms, the head
             as K batch-1 calls beside the batched one, launches per frame
             (27 dw7x7, 1 msda, 1 correlation), peak memory; one
             shared-path frame at K = 17 (the correlation in 2 groups of
             label maps) and one general-path frame at K = 17 (MSDA at
             batch 17)
  omni       the omni path (MOTOmniDriver as tools/track_omni.py builds
             it: test_conf 0.01, nms 0.65, max_out 128, biases raised by
             6): one 720x1280 frame of the served unicorn_track_tiny_mask
             model through the dw7x7 and MSDA kernels vs their plain
             versions from the same previous frame (top score, box,
             embeddings, mask; MSDA in bf16); unicorn_track_tiny on
             1080x1920 frames (MOT17) and unicorn_track_tiny_mask with
             masks on 720x1280 frames (BDD100K seg_track), each 3 warm-up
             and 16 timed QDTrack updates, then 8 DeepSORT updates:
             frames/s, per-stage ms, bytes fetched a frame, launches per
             frame (27 dw7x7, 1 msda, 0 correlation), peak memory; one
             frame each way at conf_thre 1.0 (the empty mask grid)
  train_model  the model as trained (bf16 trunk, fp32 interaction): one
             uni_loss_fn forward + backward on a mixed SOT/MOT batch through
             the kernels vs through their plain versions; loss and every
             parameter's gradient
  train      the training path: ExpTrack.get_train_step / get_optimizer
             with TrainState (AdamW, gradient accumulation, EMA) at B = 2
             pairs of 800x1280 on synthetic batches: 2 warm-up and 8 timed
             steps alternating an SOT and a MOT batch, 6 steps on one SOT
             batch (the loss must fall), 2 steps with their stages timed
             apart; ms/step, peak memory, launch counts per step (36 dw7x7,
             1 msda, 2 each of the three correlation training kernels);
             with set_dw_custom_vjp one forward + backward against the
             default backward leaf by leaf (TF32 off), the filter-gradient
             calls' shapes, then 8 timed steps each way in turns (72 dw7x7
             and 72 dw7x7_wgrad launches (36 calls) a step with the switch)
  inst_train the inst stage's training step (ExpDetMask.get_optimizer:
             SGD, mask-only, EMA; get_train_step) on the
             unicorn_inst_convnext_tiny_800x1280 YOLOXDet at B = 2 images
             of 800x1280 with 16 boxes and elliptic masks an image: one
             step's loss and trainable gradients through the dw7x7 kernel
             vs its plain version; 2 + 8 timed steps (ms/step, images/s,
             peak memory, 27 dw7x7 launches a step); the frozen tensors
             bit-identical after them; two BoxInst steps (projection and
             pairwise terms finite and > 0)
  mask_train the VOS + MOTS stage's training step (ExpTrackMask:
             AdamW, accumulation over 2, mask-only) on the
             unicorn_track_tiny_mask Unicorn at B = 2 pairs of 800x1280,
             one VOS and one MOTS pair, masks at d_rate 2: one step
             through the dw7x7, MSDA and training-correlation kernels vs
             their plain versions; 2 + 8 timed steps (ms/step, pairs/s,
             peak memory; 36 dw7x7, 1 MSDA, 1 fwd_lse at K = 3 label maps
             a step); the frozen tensors bit-identical; with every tensor
             training, one step kernels vs plain (the embedding layers'
             gradients) and two timed steps, bwd_i and bwd_j once a step
  trainer    the training loop: Trainer(exp, {"batch_size": 2}).train()
             on unicorn_track_tiny (AdamW, accumulation 2, EMA) from an
             in-memory omni dataset of seeded 1080x1920 uint8 frames (SOT
             sequences of one box, MOT of 8-12 with ids): 2 epochs of 12
             iterations (a multiscale draw at iteration 10 of each, the L1
             switch at epoch 1, no eval: phase eval runs it), ms / iteration,
             pairs/s, data against step ms an iteration, peak memory,
             launches (36 / 1 / 2 / 2 / 2 a step), metrics.jsonl's keys,
             the sizes of the batches run; at each multiscale size run
             besides 800x1280, one step through the kernels against their
             plain versions on the trained weights (every call, the
             correlation's gradients, the loss) and on the trainer's
             seeded initial weights (the gradient leaves too, at
             train_model's bounds);
             the save time blocking and asynchronous, the file size; 12
             iterations with 4 loader workers; load_pretrained from a
             checkpoint of the seeded inst YOLOXDet (tensors copied, cls
             gathered, *_sot duplicated), SIGTERM after iteration 3
             (`latest` written, the run stops), resume (model, EMA and AdamW
             moments bit-equal to the checkpoint, counters rewound) to the
             end; one epoch of 4 iterations each of ExpTrackMask
             (UniMaskLoader, 480x854 frames with masks) and the inst stage
             (InstLoader, 480x640 images)
  disk       training from files on disk: every fixture of
             tests/torch_fixtures decoded by the port's reader
             (data/image_io.py) against the digests of cv2's / PIL's
             decodes (hashes.json); the decode ms of the 1080x1920
             baseline and progressive JPEGs and the 480x854 palette mask
             on 1 and 4 threads; the mixes' reference layouts (LaSOT,
             GOT10K, COCO with polygon and RLE masks, MOT17, DAVIS,
             MOTS-Challenge) written under chiprun_out/disk_data from the
             fixtures; with UNICORN_DATADIR there, Trainer.train through
             the exps' own get_data_loader: unicorn_track_tiny 6
             iterations (AdamW, accumulation 2, EMA), the first batch's
             step kernels vs plain at train_model's bounds, the VOS + MOTS
             and inst stages 4 iterations each; ms / iteration, data vs
             step ms, the loader's ms a batch and its decode share, peak
             memory, launches (36 / 1 / 2 / 2 / 2, 36 / 1 / fwd_lse 1, 27)
  det        mosaic detection pretraining: with UNICORN_DATADIR at the
             COCO layout of phase disk (written again under
             chiprun_out/det_data), Trainer.train on
             unicorn_det_convnext_tiny_800x1280 (SGD, Nesterov, EMA) 2
             epochs of 3 iterations at B = 2, 800x1280: mosaic and MixUp,
             then close_mosaic and L1; ms / iteration, data vs step ms,
             the loader's ms a batch, peak memory, 27 dw7x7 launches a
             step; the first mosaic batch's step kernels vs plain; the
             chain: unicorn_track_tiny's load_pretrained reads the stage's
             `latest` (trunk equal, cls_preds 80 -> 8), one uni step; the
             convnext_large YOLOXDet (bf16, B = 2, 800x1280) one det step
             each under remat False (twice), True and "dw": loss, gradients
             against the two-run spread, ms/step, peak memory, dw7x7
             launches 45 / 81 / 45; one unicorn_track_tiny uni step with
             backbone_map against without (fp32 with TF32 off: the loss
             within 1e-5; bf16 as trained: within 0.02)
  backbones  the other trunks and exps, through unicorn_torch.exp.base
             get_exp, seed 0, bf16: unicorn_track_r50 (ResNet-50) served,
             one MOT frame (forward_whole) and one SOT frame kernels vs
             plain, then 3 + 16 MOTDriver.update and 16 SOTDriver.track
             on 1080x1920 frames (frames/s, per-stage ms, peak memory,
             launches a frame: 9 dw7x7, the head's; 1 MSDA and 1
             correlation a SOT frame); its uni step at B = 2 pairs kernels
             vs plain at train_model's bounds and 2 + 8 timed, one det step
             of unicorn_det_r50_800x1280 and one mask-only VOS + MOTS step
             of unicorn_track_r50_mask, each kernels vs plain and 2 + 4
             timed (ms/step, peak memory, launches 18 / 9 / 18 dw7x7 a
             step); a Swin-T Unicorn (unicorn_track_tiny's exp with
             backbone_name swin_tiny) forward_whole kernels vs plain and
             its ms a frame, one uni step under remat False twice and True
             with deterministic algorithms (loss and every gradient leaf
             within the two-run spread); unicorn_track_tiny_rt at 640x1024
             as unicorn_track_r50 (27 dw7x7 a frame); every one of the 18
             exps' models built on the card, its parameters counted
  eval       the evaluators, on val sets written under
             chiprun_out/eval_data (8 copies of the 1080x1920 fixture
             frames with seeded boxes and masks; BDD100K seg_track, 2
             videos of 4 720x1280 frames): (a) the native rle / cocoeval
             codecs against their plain forms, bit for bit; (b)
             unicorn_track_tiny's get_trainer_evaluator (COCO box AP over
             the MOT val set) at 800x1280: a ground-truth forward scores
             AP 1.0, the served bf16 model (biases raised) 27 dw7x7
             launches an image, its decoded outputs kernel vs plain, images/s
             and ms an image of load, forward, NMS and mAP; (c) the inst
             exp's get_evaluator (box and mask AP): AP 1.0 from the ground
             truth, the model's ms and launches; (d) BDDEvaluator
             evaluate_mot and evaluate_seg_mot with MOTOmniDriver on the
             served unicorn_track_tiny_mask (27 dw7x7, 1 MSDA a frame), the
             bitmask PNGs read back; (e) Trainer.train of 2 iterations with
             eval_interval 1: an eval record and `best`
  harness    the SOT / VOS benchmark harness, with UNICORN_DATADIR at
             layouts written under chiprun_out/harness_data from the
             fixtures (GOT-10k val and LaSOT: copies of the 1080x1920
             JPEG, seeded boxes; DAVIS 2017 val: the 480x854 JPEG and its
             3-object mask; YouTube-VOS 2018: an object entering on frame
             3): (a) tools/test.py unicorn_sot on GOT-10k val (a result txt
             a sequence; AUC 20/21 from the ground truth; the GOT-10k and
             TrackingNet zips read back); LaSOT through run_sequence_sot on
             phase sot's model; (b) tools/test.py unicorn_vos on DAVIS and
             YT-VOS (a PNG a frame read back equal; MSDA at batch K after
             the entry; J&F 1.0 from the ground truth); (c) one SOT and one
             DAVIS sequence through the runners with the kernels vs their
             plain versions; (d) launches a frame (27 / 1 / 1), runner
             frames/s at window 8 and 1, the frame reads' share, VOS
             frames/s, J&F ms a frame; (e) csrc/pack.cpp vs numpy at
             800x1280x3, utils.profiling.trace around one SOT frame,
             device_memory_stats, utils.model_utils.get_model_info
  tools      the command-line tools (python -m unicorn_torch.tools.*), with
             UNICORN_DATADIR at sets written under chiprun_out/tools_data
             (phase disk's layouts, phase eval's BDD100K seg_track set, a
             MOT17-style test set of 2 videos x 8 copies of the 1080x1920
             JPEG with seeded moving boxes), unicorn_track_tiny and
             unicorn_track_tiny_mask at full width, bf16, seed 0, biases
             raised, saved as port checkpoints for -c: (a) track on the
             host path and --fused --chunk 8 (27 dw7x7 a frame, frames/s,
             the frame reads' and letterbox's share); (b) track_omni with
             QDTrack, and --dataset bdd --mots (27 dw7x7 + 1 MSDA a
             frame, seg_scores.json); (c) demo image on 2 frames and video
             on a 4-frame directory (PNGs); (d) export_model whole and
             decode (27 unicorn_torch.dwconv7x7 nodes, the reloaded
             program 27 launches a call and bit-equal to eager, export
             seconds, ms a frame against eager); (e) train 2 iterations on
             phase disk's layout (36 / 1 / 2 / 2 / 2 a step); (f)
             analysis_results --plot without matplotlib; (g) debug_only's
             PNGs, no step
  parallel   the batched and multi-process forms, on unicorn_track_tiny
             and unicorn_track_tiny_mask at full width, bf16, seed 0: (a)
             StreamingMOTPipeline(pipelined=True) against the plain chunk
             (2 x 8 letterboxed 1080x1920 frames, bit-equal, frames/s
             each way, 27 dw7x7 a frame); (b) MultiStreamMOT at 4 streams,
             8 ticks, equal to run_chunk(n_streams=4), each stream's ids
             against an independent pipeline, frames/s (27 a tick); (c)
             make_sot_seq_parallel_fn at 4 sequences, 8 lockstep frames
             against 4 sequential track runs, raw logits against each
             sequence's batch-1 forward (27 / 1 / 1 a step), and
             make_vos_shared_seq_parallel_fn at 2 sequences of 5 slots
             against each sequence's own shared path; (d) data-parallel
             training: a world of 1 over NCCL against the single-card uni
             step (deterministic algorithms; bit-equal where that step
             repeats itself), then 2 gloo ranks on the one card at B = 1
             (spawned after the build) against the one-process B = 2
             step at train_model's bounds, ms/step and peak memory a
             rank, 36 / 1 / 2 / 2 / 2 launches a rank and step
  multicard  the multi-card forms on the one card, unicorn_track_tiny at
             800x1280, seed 0, biases raised: (a) a world of 1 over NCCL,
             spatial_detect_fn at sp = 1 (the row plan, halo and
             GroupNorm exchanges, gather) against the one-card detector,
             fp32 with TF32 off at JAX's bounds, bf16 printed, 27 dw7x7;
             (b) 4 gloo ranks sharing the card (spawned): gloo's int32
             all-reduce on card tensors, spatial_detect_fn at sp = 4
             (7 / 6 / 6 / 6 units of 32 rows) at (a)'s bounds, 27 dw7x7 a
             frame and rank, the kernel against its plain version at each
             rank's call shapes, ms a frame a rank (one shared card's);
             MultiStreamMOT over a "stream" mesh (a stream a rank, 8
             ticks) bit-equal to the one-card form; lockstep SOT over a
             "seq" mesh (a sequence a rank) bit-equal to each sequence
             alone at batch 1, 27 / 1 / 1 a step; (c) the Swin-T trunk
             (phase backbones' model) split by rows at sp = 1 over NCCL
             and sp = 4 on gloo ranks, fp32 at (a)'s bounds against the
             one-card Swin-T detector, 9 dw7x7 a frame and rank held
             against the plain version at the ranks' shapes; (d) the
             (dcn, data) pod mesh's uni step, B = 1 pair a rank: (1, 1)
             over NCCL bit-equal to the one-process step, (2, 2) on gloo
             ranks (two nodes of two) in fp32 within 1e-5 of each
             gradient leaf's largest of the flat step's, one state on
             every rank, 36 / 1 / 2 / 2 / 2 launches a rank and step,
             each call held against its plain version
`--only profile` adds a torch.profiler breakdown of the paths.
The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or without the rest of the
repo beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"

FRAME_HW = (1080, 1920)   # the synthetic uint8 frames of both paths
N_FRAMES = 16             # MOTDriver.update calls of the MOT path
N_TRACK = 16              # SOTDriver.track calls of the SOT path
N_WINDOW = 8              # frames of its one track_window call
WINDOW = 4                # frames per chunk of that call
N_DIRECT = 4              # track calls with the MSDA kernel's direct mode
INIT_BOX = [800.0, 400.0, 240.0, 180.0]   # x, y, w, h in the first frame

# published peaks by card name: (memory bytes/s, fp32 FLOP/s outside the
# tensor cores, bf16 FLOP/s of the tensor cores); NVIDIA data sheets, dense,
# at the full power limit
PEAKS = {
    "H100 PCIe": (2.0e12, 51e12, 756e12),
    "H100 NVL": (3.9e12, 60e12, 835e12),
    "H100": (3.35e12, 67e12, 989e12),   # SXM5 (name "NVIDIA H100 80GB HBM3")
}


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    raise RuntimeError(f"no published peaks for card {name!r}")


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time of one call of fn: `iters` calls captured in a CUDA graph
    and replayed `reps` times between CUDA events, so that the host's
    per-call overhead (larger than these kernels) leaves no gaps. Inputs
    stay warm in L2, as they are on the path, where each map was just
    written by the op before."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                 # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * iters)


@contextlib.contextmanager
def tf32_off():
    """fp32 plain versions are references only with TF32 off (cuDNN has it
    on by default); the phases that time a path run with PyTorch's own
    settings, as a caller's program would."""
    import torch

    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


def bf16_ulp(t):
    """One bf16 ulp of each element's magnitude (8 significant bits)."""
    import torch

    a = t.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


# ---------------------------------------------------------------- phase 1
def phase_card_and_build(report):
    import torch

    from unicorn_torch.csrc import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(card)
    name = torch.cuda.get_device_name(0)
    key, (bw, fp32, bf16) = peaks_for(name)
    print(f"card: {name} | power: {card} | peaks ({key}): "
          f"{bw / 1e12:.2f} TB/s, {fp32 / 1e12:.0f} TFLOP/s fp32, "
          f"{bf16 / 1e12:.0f} TFLOP/s bf16 | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    host = ("imcodec", "rle", "cocoeval", "pack")
    logs = build.build(["dwconv7x7", "dw7x7_wgrad", "convnext_block", "msda",
                        "correlation", "correlation_train", "tracker_step",
                        *host])
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for n, log in logs.items():
        for line in log.strip().splitlines():
            print(f"  {'c++' if n in host else 'nvcc'} {n}: {line}")
    report["card"] = card
    report["peaks"] = (bw, fp32, bf16)


def roofline(nbytes, flops, bw, peak):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------- phase 2
def phase_kernels(report):
    """Every kernel against its plain version; all three are checked even
    when one disagrees."""
    bad = []
    with tf32_off():
        for check in (kernels_dw7x7, kernels_dw7x7_wgrad,
                      kernels_convnext_block, kernels_msda,
                      kernels_correlation, kernels_correlation_train,
                      kernels_backward):
            if not check(report):
                bad.append(check.__name__)
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def dw_beyond_tolerance_bf16(x, k, b, yk, yp) -> int:
    """How many bf16 outputs of the dw7x7 kernel (yk) lie further from the
    plain version's (yp) than one bf16 ulp of the output plus the bound on
    two fp32 sums of the same 50 terms taken in different orders
    (50 * 2^-24 * sum|x*w|), which decides outputs near zero."""
    import torch

    from unicorn_torch.ops import dwconv7x7 as dw

    mag = dw.dwconv7x7_plain(x.float().abs(), k.to(x.dtype).abs(),
                             b.to(x.dtype).abs())
    tol = (bf16_ulp(torch.maximum(yk.float().abs(), yp.float().abs()))
           + 50 * 2.0 ** -24 * mag)
    return int(((yk.float() - yp.float()).abs() > tol).sum().item())


# dw7x7 shapes (H, W, C) and launches a frame of the other configurations:
# the head's 3 levels x 3 blocks at width 0.5 (C = 128) on ResNet-50, whose
# trunk has none (Swin-T at width 1.0 runs the ConvNeXt head's shapes);
# unicorn_track_tiny_rt's trunk and head at 640x1024, 4/5 of 800x1280; and
# a rank's rows of the 800x1280 frame split over 4 ranks (phase multicard:
# 7 or 6 units of 32 rows, plus 3 halo rows each side at every stride)
DW_OTHER_SHAPES = {
    "r50 head": (((100, 160, 128), 3), ((50, 80, 128), 3),
                 ((25, 40, 128), 3)),
    "tiny_rt 640x1024": (((160, 256, 96), 3), ((80, 128, 192), 3),
                         ((40, 64, 384), 9), ((20, 32, 768), 3),
                         ((80, 128, 256), 3), ((40, 64, 256), 3),
                         ((20, 32, 256), 3)),
    **{f"sp4 rank of {u} units": tuple(
        ((u * 32 // s + 6, W, C), n) for s, W, C, n in (
            (4, 320, 96, 3), (8, 160, 192, 3), (16, 80, 384, 9),
            (32, 40, 768, 3), (8, 160, 256, 3), (16, 80, 256, 3),
            (32, 40, 256, 3))) for u in (7, 6)},
}


def kernels_dw7x7(report) -> bool:
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import dwconv7x7 as dw

    bw, fp32_peak, _ = report["peaks"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               bytes_ms=0.0, ops_ms=0.0)
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    print("dw7x7  H x W x C     dtype  n  max|err|  tol      kernel_ms "
          "plain_ms  conv2d_ms bound_ms bound_by  tiling")
    for dtype in (torch.bfloat16, torch.float32):
        for (H, W, C), n in dw.PATH_SHAPES:
            x = torch.randn(1, H, W, C, device=dev, generator=g).to(dtype)
            k = (0.1 * torch.randn(7, 7, C, device=dev, generator=g))
            b = (0.1 * torch.randn(C, device=dev, generator=g))
            yk = dw.dwconv7x7_cuda(x, k, b)
            yp = dw.dwconv7x7_plain(x, k, b)
            torch.cuda.synchronize()
            diff = (yk.float() - yp.float()).abs()
            err = diff.max().item()
            if dtype == torch.bfloat16:
                tol_desc = "1ulp+sum"
                nbad = dw_beyond_tolerance_bf16(x, k, b, yk, yp)
                good = nbad == 0
                if nbad:
                    print(f"       {nbad} elements beyond tolerance")
            else:
                tol_desc = "1e-4"
                good = err <= 1e-4
            good = good and bool(torch.isfinite(yk.float()).all().item())
            ok &= good
            max_err[dtype] = max(max_err[dtype], err)
            esz = x.element_size()
            nbytes = (2 * x.numel() + 50 * C) * esz
            flops = 2 * 49 * x.numel()
            t_bytes, t_ops = nbytes / bw * 1e3, flops / fp32_peak * 1e3
            bound = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            taps, bt, y = k.to(dtype), b.to(dtype), torch.empty_like(x)
            t_k = graph_time_ms(lambda: dw.launch(x, taps, bt, y))
            t_p = graph_time_ms(lambda: dw.dwconv7x7_plain(x, k, b))
            xc = x.permute(0, 3, 1, 2)        # NCHW view, channels_last
            wl = taps.permute(2, 0, 1).unsqueeze(1).contiguous()
            t_l = graph_time_ms(
                lambda: F.conv2d(xc, wl, bt, padding=3, groups=C))
            pl = dw.plan(1, H, W, C)
            blocks = pl["grid_x"] * pl["grid_y"] * pl["grid_z"]
            lanes = H * W * C / (pl["grid_x"] * pl["columns"] * pl["strips"]
                                 * pl["rows"] * pl["grid_z"] * pl["pairs"] * 2)
            print(f"       {H:3d}x{W:3d}x{C:<4d} {str(dtype)[6:]:8s} {n} "
                  f"{err:.2e}  {tol_desc:7s}  {t_k:.4f}    {t_p:.4f}   "
                  f"{t_l:.4f}    {bound:.4f}   {bound_by:10s} "
                  f"{pl['pairs']} pairs x {pl['columns']} cols x "
                  f"{pl['rows']} rows, {blocks} blocks "
                  f"({blocks / n_sm:.2f} per SM), lanes {lanes:.0%}"
                  f"{'' if good else '  FAIL'}")
            if dtype == torch.bfloat16:
                per_shape.append(dict(shape=[H, W, C], launches=n, ms=t_k,
                                      plain_ms=t_p, library_ms=t_l,
                                      bound_ms=bound, blocks=blocks,
                                      lanes=lanes))
                tot["ms"] += n * t_k
                tot["plain_ms"] += n * t_p
                tot["library_ms"] += n * t_l
                tot["bound_ms"] += n * bound
                tot["bytes_ms"] += n * t_bytes
                tot["ops_ms"] += n * t_ops
    # the SOT window path runs the same shapes at its batch of WINDOW frames
    for (H, W, C), _ in dw.PATH_SHAPES:
        x = torch.randn(WINDOW, H, W, C, device=dev,
                        generator=g).to(torch.bfloat16)
        k = 0.1 * torch.randn(7, 7, C, device=dev, generator=g)
        b = 0.1 * torch.randn(C, device=dev, generator=g)
        yk, yp = dw.dwconv7x7_cuda(x, k, b), dw.dwconv7x7_plain(x, k, b)
        nbad = dw_beyond_tolerance_bf16(x, k, b, yk, yp)
        if nbad:
            print(f"       B={WINDOW} {H}x{W}x{C} bf16: {nbad} elements "
                  "beyond tolerance  FAIL")
        ok &= nbad == 0
    print(f"       the 7 shapes at B={WINDOW} (bf16, 1ulp+sum): "
          f"{'ok' if ok else 'FAIL'}")
    # maps that end mid-tile and mid-strip, maps below the 7 x 7 reach, and
    # widths that are no multiple of the 16-byte vector (zero-padded by the
    # wrapper: one launch on the padded copy), in both dtypes
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, W, C in ((1, 13, 17, 40), (1, 5, 3, 16), (1, 1, 1, 8),
                           (2, 13, 17, 12), (2, 13, 17, 20)):
            x = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
            k = 0.1 * torch.randn(7, 7, C, device=dev, generator=g)
            b = 0.1 * torch.randn(C, device=dev, generator=g)
            n0 = dw.launches
            yk = dw.dwconv7x7_cuda(x, k, b)
            yp = dw.dwconv7x7_plain(x, k, b)
            one = dw.launches == n0 + 1
            if dtype == torch.bfloat16:
                good = dw_beyond_tolerance_bf16(x, k, b, yk, yp) == 0
            else:
                good = (yk - yp).abs().max().item() <= 1e-4
            good = good and one and tuple(yk.shape) == (B, H, W, C)
            ok &= good
            print(f"       {B}x{H}x{W}x{C} {str(dtype)[6:]}: "
                  f"{'ok' if good else 'FAIL'}")
    print(f"dw7x7 per frame (bf16, 27 launches): kernel {tot['ms']:.4f} ms, "
          f"plain {tot['plain_ms']:.4f} ms, F.conv2d {tot['library_ms']:.4f} "
          f"ms, bound {tot['bound_ms']:.4f} ms")
    # the shapes of the other configurations' frames (bf16, as served):
    # each beside its plain version, timed; their sum a frame
    for path, shapes in DW_OTHER_SHAPES.items():
        frame = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0)
        for (H, W, C), n in shapes:
            x = torch.randn(1, H, W, C, device=dev,
                            generator=g).to(torch.bfloat16)
            k = 0.1 * torch.randn(7, 7, C, device=dev, generator=g)
            b = 0.1 * torch.randn(C, device=dev, generator=g)
            yk, yp = dw.dwconv7x7_cuda(x, k, b), dw.dwconv7x7_plain(x, k, b)
            nbad = dw_beyond_tolerance_bf16(x, k, b, yk, yp)
            good = nbad == 0 and bool(torch.isfinite(yk.float()).all())
            ok &= good
            err = (yk.float() - yp.float()).abs().max().item()
            max_err[torch.bfloat16] = max(max_err[torch.bfloat16], err)
            bound, _ = roofline((2 * x.numel() + 50 * C) * 2,
                                2 * 49 * x.numel(), bw, fp32_peak)
            taps, bt, y = k.to(x.dtype), b.to(x.dtype), torch.empty_like(x)
            t_k = graph_time_ms(lambda: dw.launch(x, taps, bt, y))
            t_p = graph_time_ms(lambda: dw.dwconv7x7_plain(x, k, b))
            xc, wl = x.permute(0, 3, 1, 2), taps.permute(2, 0, 1).unsqueeze(
                1).contiguous()
            t_l = graph_time_ms(
                lambda: F.conv2d(xc, wl, bt, padding=3, groups=C))
            pl = dw.plan(1, H, W, C)
            print(f"       {path}: {H:3d}x{W:3d}x{C:<4d} bf16 {n} {err:.2e}"
                  f"  1ulp+sum  {t_k:.4f}    {t_p:.4f}   {t_l:.4f}    "
                  f"{bound:.4f}   {pl['pairs']} pairs x {pl['columns']} "
                  f"cols x {pl['rows']} rows{'' if good else '  FAIL'}")
            per_shape.append(dict(shape=[H, W, C], path=path, launches=n,
                                  ms=t_k, plain_ms=t_p, library_ms=t_l,
                                  bound_ms=bound))
            for key, t in (("ms", t_k), ("plain_ms", t_p),
                           ("library_ms", t_l), ("bound_ms", bound)):
                frame[key] += n * t
        print(f"dw7x7 per frame of {path} (bf16, "
              f"{sum(n for _, n in shapes)} launches): kernel "
              f"{frame['ms']:.4f} ms, plain {frame['plain_ms']:.4f} ms, "
              f"F.conv2d {frame['library_ms']:.4f} ms, bound "
              f"{frame['bound_ms']:.4f} ms")
    report.setdefault("kernels", {})["dwconv7x7"] = dict(
        name="dwconv7x7", route="cuda",
        source="unicorn_torch/csrc/dwconv7x7.cu",
        replaces="unicorn_tpu/ops/pallas_convnext.py:196",
        launches=None, max_abs_err=max_err[torch.bfloat16],
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                  else "operations"),
        library_ms=tot["library_ms"], per_shape=per_shape)
    return ok


# (B, H, W, C) of the dw7x7 calls of one uni training step at TRAIN_B = 2
# pairs of 800x1280 with mhs, and how many calls run at each: the trunk's 18
# blocks on the 2B frames as one batch, the head's 9 attention blocks (hidden
# 256) at batch B in each of its two calls
UNI_STEP_DW_SHAPES = (
    ((4, 200, 320, 96), 3), ((4, 100, 160, 192), 3), ((4, 50, 80, 384), 9),
    ((4, 25, 40, 768), 3), ((2, 100, 160, 256), 6), ((2, 50, 80, 256), 6),
    ((2, 25, 40, 256), 6))


def wgrad_tolerance(x, dy, plan):
    """Per output of dw7x7_wgrad: twice the first-order bound of the
    kernel's longest chain of fp32 additions (a lane's products down its
    band and halo rows, its block's 8 warps, the workspace slots: 8 a warp
    of the fixed-order sum, then its 8 warps) times the sum of the terms'
    magnitudes, which the plain version gives on |x| and |dy|."""
    from unicorn_torch.ops import dwconv7x7 as dw

    mk, mb = dw.dw7x7_wgrad_plain(x.abs(), dy.abs())
    chain = (plan["rows"] + 6) * 4 + 8 + -(-plan["slots"] // 8) + 8
    u = 2 * chain * 2.0 ** -24
    return u * mk, u * mb


def kernels_dw7x7_wgrad(report) -> bool:
    """The filter-gradient kernel against its plain version at every
    (B, H, W, C) of the uni step, in bf16 (the step's) and fp32, and at the
    serving shapes (B = 1, bf16); two calls bit-equal at each; timed beside
    the plain version, beside the library call that computes the same dW
    and db (aten.convolution_backward of the grouped conv with only the
    weight and bias gradients asked for, cuDNN's wgrad: `library_ms`) and
    beside cuDNN's dgrad + wgrad (autograd of F.conv2d(groups=C), the
    default backward's library work: `dgrad_wgrad_ms`) on the same
    (x, dy). Tolerance: `wgrad_tolerance`."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import dwconv7x7 as dw

    bw, fp32_peak, _ = report["peaks"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    ok = True
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, dgrad_wgrad_ms=0.0,
               bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0)
    max_err, per_shape = 0.0, []
    cases = [(s, n, dt, "uni step") for dt in (torch.bfloat16, torch.float32)
             for s, n in UNI_STEP_DW_SHAPES]
    cases += [((1, *s), n, torch.bfloat16, "serving")
              for s, n in dw.PATH_SHAPES]
    cases += [(s, 1, dt, "ragged") for dt in (torch.bfloat16, torch.float32)
              for s in ((2, 13, 17, 12), (1, 5, 3, 16), (1, 1, 1, 8),
                        (3, 9, 70, 40))]
    print("dw7x7_wgrad  B x H x W x C        dtype  n  worst err/tol  "
          "equal  kernel_ms plain_ms wgrad_ms dgrad+wgrad_ms bound_ms "
          "bound_by  split")
    for (B, H, W, C), n, dtype, path in cases:
        x = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
        dy = torch.randn(B, H, W, C, device=dev, generator=g).to(dtype)
        k1, b1 = dw.dw7x7_wgrad_cuda(x, dy)
        k2, b2 = dw.dw7x7_wgrad_cuda(x, dy)
        kp, bp = dw.dw7x7_wgrad_plain(x, dy)
        pl = dw.wgrad_plan(B, H, W, C)
        tk, tb = wgrad_tolerance(x, dy, pl)
        torch.cuda.synchronize()
        ratio = max(((k1 - kp).abs() / tk.clamp_min(1e-30)).max().item(),
                    ((b1 - bp).abs() / tb.clamp_min(1e-30)).max().item())
        equal = torch.equal(k1, k2) and torch.equal(b1, b2)
        good = (ratio <= 1.0 and equal and bool(torch.isfinite(k1).all())
                and tuple(k1.shape) == (7, 7, C))
        ok &= good
        err = max((k1 - kp).abs().max().item(), (b1 - bp).abs().max().item())
        line = (f"             {B}x{H:3d}x{W:3d}x{C:<4d} {path:9s} "
                f"{str(dtype)[6:]:8s} {n} {ratio:.2e}  {equal}")
        if path == "ragged":
            print(line + ("" if good else "  FAIL"))
            continue
        max_err = max(max_err, err)
        N = x.numel()
        t_bytes = (2 * N * x.element_size() + 50 * C * 4) / bw * 1e3
        t_ops = (2 * 49 + 1) * N / fp32_peak * 1e3
        bound = max(t_bytes, t_ops)
        t_k = graph_time_ms(lambda: dw.dw7x7_wgrad_cuda(x, dy))
        t_p = graph_time_ms(lambda: dw.dw7x7_wgrad_plain(x, dy), iters=3,
                            reps=2)
        xc = x.permute(0, 3, 1, 2).detach().requires_grad_()
        wc = (0.1 * torch.randn(C, 1, 7, 7, device=dev, generator=g)).to(
            dtype).requires_grad_()
        bc = torch.zeros(C, device=dev, dtype=dtype, requires_grad=True)
        dyc = dy.permute(0, 3, 1, 2)

        def library():
            return torch.ops.aten.convolution_backward(
                dyc, xc, wc, [C], [1, 1], [3, 3], [1, 1], False, [0, 0], C,
                [False, True, True])

        def dgrad_wgrad():
            y = F.conv2d(xc, wc, bc, padding=3, groups=C)
            return torch.autograd.grad(y, (xc, wc, bc), dyc)

        t_l = event_time_ms(library, iters=5)
        t_dw = event_time_ms(dgrad_wgrad, iters=5)
        print(f"{line}   {t_k:.4f}    {t_p:.4f}   {t_l:.4f}   {t_dw:.4f}"
              f"        {bound:.4f}"
              f"   {'bytes' if t_bytes >= t_ops else 'operations':10s} "
              f"{pl['tiles']} tiles x {pl['slabs']} slabs x {pl['bands']} "
              f"bands of {pl['rows']} rows, {pl['slots']} slots"
              f"{'' if good else '  FAIL'}")
        per_shape.append(dict(shape=[B, H, W, C], dtype=str(dtype)[6:],
                              path=path, launches=n, ms=t_k, plain_ms=t_p,
                              library_ms=t_l, dgrad_wgrad_ms=t_dw,
                              bound_ms=bound, err_over_tol=ratio))
        if path == "uni step" and dtype == torch.bfloat16:
            for key, t in (("ms", t_k), ("plain_ms", t_p),
                           ("library_ms", t_l), ("dgrad_wgrad_ms", t_dw),
                           ("bound_ms", bound),
                           ("bytes_ms", t_bytes), ("ops_ms", t_ops)):
                tot[key] += n * t
    print(f"dw7x7_wgrad per uni step (bf16, 36 calls): kernel "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f} ms, cuDNN wgrad "
          f"{tot['library_ms']:.4f} ms, cuDNN dgrad + wgrad "
          f"{tot['dgrad_wgrad_ms']:.4f} ms, bound {tot['bound_ms']:.4f} ms")
    report.setdefault("kernels", {})["dw7x7_wgrad"] = dict(
        name="dw7x7_wgrad", route="cuda",
        source="unicorn_torch/csrc/dw7x7_wgrad.cu",
        replaces="unicorn_tpu/ops/pallas_convnext.py:341",
        launches=None, max_abs_err=max_err, ms=tot["ms"],
        plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by=("bytes" if tot["bytes_ms"] >= tot["ops_ms"]
                  else "operations"),
        library_ms=tot["library_ms"], dgrad_wgrad_ms=tot["dgrad_wgrad_ms"],
        per_shape=per_shape)
    return ok


def _cb_params(C, g, dev):
    """Seeded parameters of one ConvNeXt block under the port's names:
    lecun-scaled weights, small biases, LayerNorm scale about 1, gamma about
    0.5 so that the block's branch weighs as much as the residual."""
    import torch

    def rn(*shape, s=1.0):
        return s * torch.randn(*shape, device=dev, generator=g)

    return {
        "dwconv": {"weight": rn(C, 1, 7, 7, s=0.1), "bias": rn(C, s=0.1)},
        "norm": {"weight": 1 + rn(C, s=0.1), "bias": rn(C, s=0.1)},
        "pwconv1": {"weight": rn(4 * C, C, s=C ** -0.5),
                    "bias": rn(4 * C, s=0.1)},
        "pwconv2": {"weight": rn(C, 4 * C, s=(4 * C) ** -0.5),
                    "bias": rn(C, s=0.1)},
        "gamma": 0.5 + rn(C, s=0.1),
    }


def cb_disagreement(x, p, exact_gelu, yk, yp):
    """(outputs of the convnext_block kernel beyond tolerance, share of
    outputs that differ at all, max |d|) against the plain version.
    Tolerance, set before the first run and widened once after it (the
    second term of the bf16 bound was missing). fp32: 5e-5 + 5e-5 |plain|
    (the same fp32 sums of up to 4C terms in other orders). bf16: kernel
    and plain version round at the same five places, so they differ only
    where another summation order moves one rounding of yn or of the hidden
    map h. The bound is 2 bf16 ulps of the largest of |kernel|, |plain| and
    |x| (the output is x + gamma * y: where the two cancel, the terms'
    rounding steps are the scale), plus 2^-7 of the root-sum-square over k
    of gamma_c * h_k * W2_ck: what product 2 would move by if every hidden
    value moved one ulp with random signs (in fact about 1% of them move).
    At most 2% of the outputs may differ at all: the share grows with the
    number of terms (measured 0.09% at C = 96, 0.93% at C = 768)."""
    import torch

    from unicorn_torch.ops import convnext_block as cb

    d = (yk.float() - yp.float()).abs()
    if x.dtype == torch.float32:
        nbad = int((d > 5e-5 + 5e-5 * yp.abs()).sum().item())
    else:
        mag = torch.maximum(torch.maximum(yk.float().abs(), yp.float().abs()),
                            x.float().abs())
        h = cb.plain_hidden(x, p, exact_gelu).float()
        w2 = p["pwconv2"]["weight"].to(x.dtype).float()
        rss = torch.sqrt((h * h) @ (w2 * w2).t()) * p["gamma"].abs()
        nbad = int((d > 2 * bf16_ulp(mag) + 2.0 ** -7 * rss).sum().item())
    return nbad, (d > 0).float().mean().item(), d.max().item()


def kernels_convnext_block(report) -> bool:
    """The fused ConvNeXt block kernels against convnext_block_plain at the
    seven served shapes, at a ragged shape with a C that is no multiple of
    16 and at B = 2, in bf16 and fp32 and with both GELUs; times of the
    kernel, the plain version, the composition on library calls
    (F.conv2d(groups=C) + F.layer_norm + F.linear) and the ConvNeXtBlock
    module as served (dw7x7 kernel + F.layer_norm + F.linear), with erf GELU
    as the model runs it. Per served shape: the plan (`plan`), each
    kernel's device time per launch (torch.profiler), and in bf16 at C <=
    FUSED_MAX_C the route the plan did not pick, checked and timed."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.models.blocks import ConvNeXtBlock
    from unicorn_torch.ops import convnext_block as cb
    from unicorn_torch.ops import dwconv7x7 as dw

    bw, fp32_peak, bf16_peak = report["peaks"]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    ok = True
    keys = ("ms", "plain_ms", "library_ms", "served_ms", "bound_ms",
            "bytes_ms", "ops_ms")
    tot = {dt: dict.fromkeys(keys, 0.0)
           for dt in (torch.bfloat16, torch.float32)}
    max_err = {torch.bfloat16: 0.0, torch.float32: 0.0}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    per_shape = []
    print("block  B x H x W x C    dtype    n  max|err|  differ   kernel_ms "
          "plain_ms  library_ms served_ms bound_ms bound_by")
    shapes = [((1, H, W, C), n) for (H, W, C), n in dw.PATH_SHAPES]
    shapes += [((2, 13, 17, 24), 0), ((1, 9, 70, 40), 0),
               ((2, 50, 80, 384), 0)]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, n in shapes:
            B, H, W, C = shape
            x = torch.randn(*shape, device=dev, generator=g).to(dtype)
            p = _cb_params(C, g, dev)
            good, err, differ = True, 0.0, 0.0
            for exact_gelu in (True, False):
                n0 = cb.launches
                yk = cb.convnext_block_cuda(x, p, exact_gelu)
                assert cb.launches == n0 + 1
                yp = cb.convnext_block_plain(x, p, exact_gelu)
                torch.cuda.synchronize()
                nbad, share, e = cb_disagreement(x, p, exact_gelu, yk, yp)
                err, differ = max(err, e), max(differ, share)
                fine = (nbad == 0 and (dtype == torch.float32 or share <= 0.02)
                        and bool(torch.isfinite(yk.float()).all().item()))
                if not fine:
                    print(f"       {shape} {dtype} exact_gelu={exact_gelu}: "
                          f"{nbad} outputs beyond tolerance, {share:.2%} "
                          "differ")
                good &= fine
            ok &= good
            max_err[dtype] = max(max_err[dtype], err)
            if n == 0:
                print(f"       {B}x{H:3d}x{W:3d}x{C:<4d} {str(dtype)[6:]:8s} - "
                      f"{err:.2e}  {differ:.2e}{'' if good else '  FAIL'}")
                continue
            # bound: x in, y out and every parameter once; the products'
            # operations at the tensor-core rate in bf16, the dw taps'
            # fp32 FMAs at the fp32 rate
            P, esz = B * H * W, x.element_size()
            nbytes = (2 * P * C + 8 * C * C) * esz + 58 * C * 4
            mm_peak = bf16_peak if dtype == torch.bfloat16 else fp32_peak
            t_bytes = nbytes / bw * 1e3
            t_ops = (16 * P * C * C / mm_peak + 98 * P * C / fp32_peak) * 1e3
            bound = max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            pl = cb.device_plan(x)
            prepared, buffers = cb.prepare(x, p), cb.scratch(x, pl)
            y = torch.empty_like(x)
            t_k = graph_time_ms(
                lambda: cb.launch(x, prepared, buffers, y, True, pl), iters=10)
            # the other route where the shape has one, checked and timed
            other = {}
            if dtype == torch.bfloat16 and C <= cb.FUSED_MAX_C:
                alt = cb.device_plan(
                    x, "split" if pl["route"] == "fused" else "fused")
                buf_alt = cb.scratch(x, alt)
                cb.launch(x, prepared, buf_alt, y, True, alt)
                nbad, share, _ = cb_disagreement(
                    x, p, True, y, cb.convnext_block_plain(x, p, True))
                alt_ok = (nbad == 0 and share <= 0.02
                          and bool(torch.isfinite(y.float()).all().item()))
                ok &= alt_ok
                good &= alt_ok
                other[alt["route"]] = graph_time_ms(
                    lambda: cb.launch(x, prepared, buf_alt, y, True, alt),
                    iters=10)
            split = kernel_split(
                lambda: cb.launch(x, prepared, buffers, y, True, pl))
            t_p = graph_time_ms(
                lambda: cb.convnext_block_plain(x, p, True), iters=3, reps=3)
            # the composition on library calls, in x.dtype
            xc = x.permute(0, 3, 1, 2)
            cast = {k: (v.to(dtype) if not isinstance(v, dict) else
                        {kk: vv.to(dtype) for kk, vv in v.items()})
                    for k, v in p.items()}

            def library():
                t = F.conv2d(xc, cast["dwconv"]["weight"],
                             cast["dwconv"]["bias"], padding=3, groups=C)
                t = F.layer_norm(t.permute(0, 2, 3, 1).float(), (C,),
                                 p["norm"]["weight"], p["norm"]["bias"],
                                 1e-6).to(dtype)
                t = F.gelu(F.linear(t, cast["pwconv1"]["weight"],
                                    cast["pwconv1"]["bias"]))
                t = F.linear(t, cast["pwconv2"]["weight"],
                             cast["pwconv2"]["bias"])
                return x + t * cast["gamma"]

            t_l = graph_time_ms(library, iters=10)
            block = ConvNeXtBlock(C, 1.0, dtype=dtype, exact_gelu=True).to(dev)
            with torch.no_grad():
                for dst, src in zip(cb.flatten_params(cb.block_params(block)),
                                    cb.flatten_params(p)):
                    dst.copy_(src)
                t_s = graph_time_ms(lambda: block(xc), iters=10)
            print(f"       {B}x{H:3d}x{W:3d}x{C:<4d} {str(dtype)[6:]:8s} {n}  "
                  f"{err:.2e}  {differ:.2e}  {t_k:.4f}    {t_p:.4f}   "
                  f"{t_l:.4f}     {t_s:.4f}    {bound:.4f}   {bound_by}"
                  f"{'' if good else '  FAIL'}")
            blocks = [g[0] * g[1] for g in (pl["grid1"], pl["grid2"]) if g]
            print(f"         plan: {pl['route']}, m1 {pl['m1']} n1 "
                  f"{pl['n1']} stages {pl['stages1']}"
                  + (f", p2 {pl['m2']} x {pl['n2']} stages {pl['stages2']}"
                     if pl["route"] == "split" else "")
                  + f", blocks {blocks} on {n_sm} SMs, smem "
                  f"{pl['smem1']}/{pl['smem2']} B; per launch (profiler, "
                  "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
                  + "".join(f"; {r} route {t:.4f} ms" for r, t in
                            other.items()))
            if dtype == torch.bfloat16:
                per_shape.append(dict(
                    shape=[B, H, W, C], launches=n, ms=t_k, plain_ms=t_p,
                    library_ms=t_l, served_module_ms=t_s, bound_ms=bound,
                    route=pl["route"], plan=list(pl["ints"]),
                    kernel_ms=split,
                    **{f"{r}_route_ms": t for r, t in other.items()}))
            for key, val in zip(keys, (t_k, t_p, t_l, t_s, bound, t_bytes,
                                       t_ops)):
                tot[dtype][key] += n * val
    for dtype, t in tot.items():
        print(f"block per frame ({str(dtype)[6:]}, 27 blocks): kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
              f"composition {t['library_ms']:.4f} ms, module as served "
              f"{t['served_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms")
    t = tot[torch.bfloat16]
    report.setdefault("kernels", {})["convnext_block"] = dict(
        name="convnext_block", route="cuda",
        source="unicorn_torch/csrc/convnext_block.cu",
        replaces="unicorn_tpu/ops/pallas_convnext.py:54",
        launches=None, max_abs_err=max_err[torch.bfloat16], ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
        bound_by="bytes" if t["bytes_ms"] >= t["ops_ms"] else "operations",
        library_ms=t["library_ms"], served_module_ms=t["served_ms"],
        fp32_ms=tot[torch.float32]["ms"],
        fp32_served_module_ms=tot[torch.float32]["served_ms"],
        fp32_bound_ms=tot[torch.float32]["bound_ms"], per_shape=per_shape)
    return ok


def kernel_split(fn, calls: int = 10) -> dict:
    """Device ms of each kernel one call of fn launches, by kernel name
    (torch.profiler over `calls` eager calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"\w*kernel\w*", e.key)
            name = m.group(0) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / (
                calls * 1e3)
    return out


def _msda_inputs(shape, dtype, g, served):
    """value, locations, weights for one MSDA check. served: the reference
    points of the SOT path (every cell centre of both levels) plus offsets
    of a few cells, as its offset bias gives; else uniform locations that
    reach outside [0, 1]."""
    import torch

    B, L, H, W, M, D, Lq, P = shape
    dev = torch.device("cuda")
    value = torch.randn(B, L, H, W, M, D, device=dev, generator=g).to(dtype)
    if served:
        ys = (torch.arange(H, device=dev) + 0.5) / H
        xs = (torch.arange(W, device=dev) + 0.5) / W
        ref = torch.stack([xs[None].expand(H, W), ys[:, None].expand(H, W)],
                          -1).reshape(H * W, 2).repeat(L, 1)
        off = 3.0 * torch.randn(B, Lq, M, L, P, 2, device=dev, generator=g)
        locs = ref[None, :, None, None, None] + off / torch.tensor(
            [W, H], device=dev, dtype=torch.float32)
    else:
        locs = torch.rand(B, Lq, M, L, P, 2, device=dev,
                          generator=g) * 1.4 - 0.2
    attw = torch.softmax(torch.randn(B, Lq, M, L * P, device=dev,
                                     generator=g), -1)
    return value, locs.contiguous(), attw.reshape(B, Lq, M, L, P).to(dtype)


def kernels_msda(report) -> bool:
    """Kernel A in both modes against each mode's plain version. Tolerance,
    set before the first run: kernel and plain version compute the same
    corner weights bit for bit (each product and difference rounded apart),
    so they differ by two fp32 orders of the same L*P*4 terms,
    L*P*4 * 2^-24 * sum|w*v|, and in bf16 by one ulp of the output where
    that moves the final rounding."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import deform_attn as da

    bw, fp32_peak, _ = report["peaks"]
    g = torch.Generator(device="cuda").manual_seed(1)
    served = (1, 2, 50, 80, 8, 32, 8000, 4)
    rt = (1, 2, 40, 64, 8, 32, 5120, 4)       # unicorn_track_tiny_rt's
    window = (WINDOW,) + served[1:]           # a track_window chunk
    ragged = (2, 2, 13, 17, 3, 8, 29, 4)
    padded = (2, 2, 13, 17, 3, 6, 29, 4)      # D zero-padded by the wrapper
    ok = True
    print("msda   mode     shape (B,L,H,W,M,D,Lq,P)          dtype    "
          "max|err|  kernel_ms plain_ms  grid_sample_ms bound_ms bound_by")
    per_shape = []
    for mode in ("factored", "direct"):
        for shape in (served, rt, window, ragged, padded):
            for dtype in (torch.bfloat16, torch.float32):
                value, locs, attw = _msda_inputs(
                    shape, dtype, g, shape in (served, rt, window))
                B, L, H, W, M, D, Lq, P = shape
                yk = da.ms_deform_attn_cuda(value, locs, attw, mode)
                yp = da.ms_deform_attn_plain(value, locs, attw, mode)
                torch.cuda.synchronize()
                diff = (yk.float() - yp.float()).abs()
                err = diff.max().item()
                mag = da.ms_deform_attn_plain(value.float().abs(), locs,
                                              attw.float(), "direct")
                tol = L * P * 4 * 2.0 ** -24 * mag + 1e-7
                if dtype == torch.bfloat16:
                    tol = tol + bf16_ulp(torch.maximum(yk.float().abs(),
                                                       yp.float().abs()))
                nbad = int((diff > tol).sum().item())
                good = nbad == 0 and bool(torch.isfinite(yk.float()).all())
                ok &= good
                nbytes = (value.numel() * value.element_size()
                          + locs.numel() * 4
                          + attw.numel() * attw.element_size()
                          + yk.numel() * yk.element_size())
                flops = 2 * B * Lq * M * L * P * 4 * D
                bound, bound_by = roofline(nbytes, flops, bw, fp32_peak)
                out = torch.empty_like(yk)
                if shape is padded:      # the pad, the launch, the slice
                    t_k = graph_time_ms(lambda: da.ms_deform_attn_cuda(
                        value, locs, attw, mode))
                else:
                    t_k = graph_time_ms(
                        lambda: da.launch(value, locs, attw, out, mode))
                t_p = graph_time_ms(
                    lambda: da.ms_deform_attn_plain(value, locs, attw, mode),
                    iters=5)
                # library yardstick: F.grid_sample per level over (B*M, D,
                # H, W), then the weighted sum; in fp32, because grid_sample
                # wants input and grid in one dtype and bf16 locations would
                # lose the sub-cell position (the casts are not timed)
                vf = value.float().permute(0, 1, 4, 5, 2, 3).reshape(
                    B, L, M, D, H, W)
                grid = (2 * locs - 1).permute(0, 2, 3, 1, 4, 5).reshape(
                    B * M, L, Lq, P, 2)
                wf = attw.float().permute(0, 2, 1, 3, 4).reshape(
                    B * M, 1, Lq, L * P)

                def library():
                    s = torch.cat([F.grid_sample(
                        vf[:, l].reshape(B * M, D, H, W), grid[:, l],
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False) for l in range(L)], -1)
                    return (s * wf).sum(-1).reshape(B, M * D, Lq).transpose(
                        1, 2)

                lib_err = (library().float() - yp.float()).abs().max().item()
                t_l = graph_time_ms(library, iters=5)
                print(f"       {mode:8s} {str(shape):34s} {str(dtype)[6:]:8s} "
                      f"{err:.2e}  {t_k:.4f}    {t_p:.4f}   {t_l:.4f}"
                      f"         {bound:.4f}   {bound_by}  (grid_sample vs "
                      f"plain {lib_err:.1e}){'' if good else '  FAIL'}")
                if nbad:
                    print(f"       {nbad} elements beyond tolerance")
                if shape is rt and mode == "factored":
                    per_shape.append(dict(
                        shape=list(shape), path="tiny_rt 640x1024",
                        dtype=str(dtype)[6:], max_abs_err=err, ms=t_k,
                        plain_ms=t_p, bound_ms=bound, bound_by=bound_by,
                        library_ms=t_l))
                if shape is served and dtype == torch.bfloat16:
                    src = {"factored": "unicorn_tpu/ops/deform_attn.py:294",
                           "direct": "unicorn_tpu/ops/deform_attn.py:204"}
                    report.setdefault("kernels", {})[f"msda_{mode}"] = dict(
                        name=f"msda_{mode}", route="cuda",
                        source="unicorn_torch/csrc/msda.cu",
                        replaces=src[mode], launches=None, max_abs_err=err,
                        ms=t_k, plain_ms=t_p, bound_ms=bound,
                        bound_by=bound_by, library_ms=t_l)
                    if mode == "factored":
                        report["kernels"]["msda_factored"]["per_shape"] = \
                            per_shape
    return ok


def kernels_correlation(report) -> bool:
    """Kernel B against its plain version, both bf16_dots settings.
    Tolerance, set before the first run: the outputs are averages of labels
    in [0, 1); kernel and plain version take the same scores (exact bf16
    products, or fp32 products) in other summation orders, and another exp:
    rtol 1e-4, atol 1e-5. With embeddings scaled x10 the scores reach
    several hundred, an fp32 ulp of a score is 3e-5 and enters the
    exponential: rtol 1e-3 there, and every output finite."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import correlation_kernel as ck

    bw, fp32_peak, bf16_peak = report["peaks"]
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    # (B, N, C, K, scale, rtol); the first is the SOT path's shape, the
    # second a track_window chunk's (and the VOS general path's at K = 4),
    # the third the timed VOS general path's; the VOS shared path's at K = 5
    # and 17; K = 17 goes in two kernel calls; the last the SOT path's of
    # unicorn_track_tiny_rt (640x1024: N = 80 x 128)
    vos_k = VOS_OBJECTS + 1
    cases = ((1, 16000, 128, 1, 0.3, 1e-4), (WINDOW, 16000, 128, 1, 0.3, 1e-4),
             (vos_k, 16000, 128, 1, 0.3, 1e-4),
             (1, 16000, 128, vos_k, 0.3, 1e-4),
             (1, 16000, 128, VOS_K_WIDE, 0.3, 1e-4),
             (1, 1000, 128, 3, 0.3, 1e-4), (2, 77, 16, 16, 1.0, 1e-4),
             (1, 1000, 16, 3, 10.0, 1e-3), (2, 1000, 128, 17, 0.3, 1e-4),
             (1, 10240, 128, 1, 0.3, 1e-4))
    paths = {(1, 16000, 1): "sot", (WINDOW, 16000, 1): f"sot window, vos "
             f"general K = {WINDOW}",
             (vos_k, 16000, 1): f"vos general K = {vos_k}",
             (1, 16000, vos_k): f"vos shared K = {vos_k}",
             (1, 16000, VOS_K_WIDE): f"vos shared K = {VOS_K_WIDE}",
             (1, 10240, 1): "sot tiny_rt 640x1024"}
    per_shape = []
    ok = True
    print("corr   B N     C   K  scale bf16_dots max|err|  kernel_ms plain_ms "
          " sdpa_ms  bound_ms bound_by")
    for B, N, C, K, scale, rtol in cases:
        e0 = scale * torch.randn(B, N, C, device=dev, generator=g)
        e1 = scale * torch.randn(B, N, C, device=dev, generator=g)
        v = torch.rand(B, K, N, device=dev, generator=g)
        for bf16_dots in (True, False):
            n0 = ck.launches
            yk = ck.correlation_propagate_cuda(e0, e1, v, bf16_dots=bf16_dots)
            calls = ck.launches - n0
            yp = ck.correlation_propagate_plain(e0, e1, v,
                                                bf16_dots=bf16_dots)
            torch.cuda.synchronize()
            diff = (yk - yp).abs()
            err = diff.max().item()
            nbad = int((diff > 1e-5 + rtol * yp.abs()).sum().item())
            good = (nbad == 0 and bool(torch.isfinite(yk).all())
                    and calls == -(-K // ck.K_MAX))
            ok &= good
            nbytes = (e0.numel() + e1.numel() + v.numel() + yk.numel()) * 4
            flops = 2 * B * N * N * (C + K)
            bound, bound_by = roofline(
                nbytes, flops, bw, bf16_peak if bf16_dots else fp32_peak)
            t_k = graph_time_ms(lambda: ck.correlation_propagate_cuda(
                e0, e1, v, bf16_dots=bf16_dots), iters=5)
            t_p = graph_time_ms(
                lambda: ck.correlation_propagate_plain(
                    e0, e1, v, bf16_dots=bf16_dots), iters=3)
            t_l = None
            if bf16_dots:
                # library yardstick: attention with q = e1, k = e0, scale 1,
                # in bf16; the value v^T is zero-padded from K to C columns,
                # the head width the fused backends take
                q = e1.bfloat16()[:, None]
                k = e0.bfloat16()[:, None]
                vv = torch.zeros(B, 1, N, C, device=dev, dtype=torch.bfloat16)
                vv[:, 0, :, :K] = v.transpose(1, 2).bfloat16()
                lib = F.scaled_dot_product_attention(q, k, vv, scale=1.0)
                lib_err = (lib[:, 0, :, :K].transpose(1, 2).float()
                           - yp).abs().max()
                t_l = graph_time_ms(
                    lambda: F.scaled_dot_product_attention(q, k, vv,
                                                           scale=1.0),
                    iters=5)
            print(f"       {B} {N:<5d} {C:<3d} {K:<2d} {scale:<5.1f} "
                  f"{str(bf16_dots):9s} {err:.2e}  {t_k:.4f}    {t_p:.4f}   "
                  + (f"{t_l:.4f}" if t_l is not None else "  -   ")
                  + f"   {bound:.4f}   {bound_by}"
                  + (f"  (sdpa vs plain {lib_err.item():.1e})"
                     if t_l is not None else "")
                  + ("" if good else "  FAIL"))
            print(f"         {calls} kernel call(s), "
                  f"{flops / t_k / 1e9:.1f} TFLOP/s, {bound / t_k:.1%} "
                  "of the bound"
                  + (f", kernel / sdpa {t_k / t_l:.3f}" if t_l is not None
                     else ""))
            if nbad:
                print(f"       {nbad} elements beyond tolerance")
            if (B, N, K) == (1, 16000, 1) and bf16_dots:
                report.setdefault("kernels", {})["correlation"] = dict(
                    name="correlation", route="cuda",
                    source="unicorn_torch/csrc/correlation.cu",
                    replaces="unicorn_tpu/ops/pallas_correlation.py:24",
                    launches=None, max_abs_err=err, ms=t_k, plain_ms=t_p,
                    bound_ms=bound, bound_by=bound_by, library_ms=t_l,
                    per_shape=per_shape)
            elif (B, N, K) in paths and bf16_dots:
                per_shape.append(dict(
                    shape=[B, N, C, K], path=paths[B, N, K],
                    kernel_calls=calls,
                    max_abs_err=err, ms=t_k, plain_ms=t_p, bound_ms=bound,
                    bound_by=bound_by, library_ms=t_l))
    return ok


def event_time_ms(fn, iters: int = 3) -> float:
    """Device time of one call of fn between CUDA events, eager: for calls
    of several ms (autograd backward passes), where the host's overhead is
    small beside the device's work."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


TRAIN_SHAPE = (2, 16000, 128, 1)   # B, N, C, K of one 800x1280 training step
# the VOS + MOTS step's: its three VOS slots propagate as K = 3 label maps
TRAIN_SHAPE_K3 = (2, 16000, 128, 3)


def kernels_correlation_train(report) -> bool:
    """The three training kernels (forward with logsumexp, bwd_i, bwd_j)
    against their plain versions in fp32, and correlation_propagate_train
    under autograd against the plain streaming version under autograd.
    Tolerances, set before the first run. out: the serving kernel's (rtol
    1e-4, atol 1e-5; rtol 1e-3 with embeddings x10, where an fp32 ulp of a
    score of several hundred is 3e-5 and enters the exponential). lse: 1e-5
    + 2e-6 |lse| (16 fp32 ulps: two orders of the same N-term sum). dE0, dE1,
    dV: every entry within 1e-4 (x10: 1e-3) of the tensor's largest
    magnitude (plus 1e-6: with a nearly one-hot softmax dE0 and dE1 are all
    cancellation); each is a sum of N products of P, which carries the
    exponential's relative error, taken in another order. Both backward
    kernels and their plain versions get the kernel forward's lse and c.
    Every case goes through the grouping of label maps (ck.fwd_lse_grouped,
    ck.bwd_grouped): one launch of each kernel a group of at most 16 maps,
    held against the plain versions over all K at once."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops.correlation import correlation_propagate

    bw, fp32_peak, _ = report["peaks"]
    g = torch.Generator(device="cuda").manual_seed(5)
    dev = torch.device("cuda")
    # (B, N, C, K, scale, rtol): the training step's shape, a ragged one, a
    # sharp one, a width that fills only part of the channel tile, and two
    # or three groups of label maps
    cases = (TRAIN_SHAPE + (0.3, 1e-4), TRAIN_SHAPE_K3 + (0.3, 1e-4),
             (2, 77, 16, 16, 1.0, 1e-4),
             (2, 1000, 16, 3, 10.0, 1e-3), (1, 300, 96, 2, 1.0, 1e-4),
             (2, 300, 128, 17, 1.0, 1e-4), (1, 257, 128, 33, 1.0, 1e-4))
    ok = True
    print("corr_train B N     C   K  scale  d_out    d_lse    d_dE0/max "
          "d_dE1/max d_dV/max  vjp_vs_autograd")
    for B, N, C, K, scale, rtol in cases:
        e0 = scale * torch.randn(B, N, C, device=dev, generator=g)
        e1 = scale * torch.randn(B, N, C, device=dev, generator=g)
        v = torch.rand(B, K, N, device=dev, generator=g)
        dout = torch.randn(B, K, N, device=dev, generator=g)
        n0 = dict(ck.train_launches)
        out, lse = ck.fwd_lse_grouped(ck.correlation_fwd_lse_cuda, e0, e1, v)
        de0, de1, dv = ck.bwd_grouped(ck.correlation_bwd_i_cuda,
                                      ck.correlation_bwd_j_cuda, e0, e1, v,
                                      out, lse, dout)
        groups = -(-K // ck.K_MAX)
        assert ck.train_launches == {k: n + groups for k, n in n0.items()}
        c = (out * dout).sum(1, keepdim=True)
        out_p, lse_p = ck.correlation_fwd_lse_plain(e0, e1, v)
        de0_p, dv_p = ck.correlation_bwd_i_plain(e0, e1, v, lse, dout, c)
        de1_p = ck.correlation_bwd_j_plain(e0, e1, v, lse, dout, c)
        torch.cuda.synchronize()
        good = all(bool(torch.isfinite(t).all())
                   for t in (out, lse, de0, de1, dv))
        d_out = (out - out_p).abs()
        good &= not bool((d_out > 1e-5 + rtol * out_p.abs()).any())
        d_lse = (lse - lse_p).abs()
        good &= not bool((d_lse > 1e-5 + 2e-6 * lse_p.abs()).any())
        rels = []
        for a, b in ((de0, de0_p), (de1, de1_p), (dv, dv_p)):
            rels.append(((a - b).abs().max() / b.abs().max()).item())
            good &= bool((a - b).abs().max() <= rtol * b.abs().max() + 1e-6)
        vjp = "-"
        if N <= 1000:
            # the Function's gradients against autograd of the plain
            # streaming version (its own softmax, its own order): 10 x rtol
            leaves = [t.clone().requires_grad_() for t in (e0, e1, v)]
            y = ck.correlation_propagate_train(*leaves)
            gk = torch.autograd.grad(y, leaves, dout)
            leaves_p = [t.clone().requires_grad_() for t in (e0, e1, v)]
            gp = torch.autograd.grad(correlation_propagate(*leaves_p),
                                     leaves_p, dout)
            worst = max(((a - b).abs().max()
                         / (b.abs().max() + 1e-3)).item()
                        for a, b in zip(gk, gp))
            good &= worst <= 10 * rtol
            vjp = f"{worst:.1e}"
        ok &= good
        print(f"           {B} {N:<5d} {C:<3d} {K:<2d} {scale:<5.1f}  "
              f"{d_out.max().item():.2e} {d_lse.max().item():.2e} "
              f"{rels[0]:.2e}  {rels[1]:.2e}  {rels[2]:.2e}  {vjp}"
              f"{'' if good else '  FAIL'}")
        if (B, N, C, K) not in (TRAIN_SHAPE, TRAIN_SHAPE_K3):
            continue

        # times, bounds and the library yardstick at the training shapes
        nb_in = (e0.numel() + e1.numel() + v.numel()) * 4
        nb_bwd = nb_in + (lse.numel() + dout.numel() + c.numel()) * 4
        work = {   # name: (bytes, operations, launch, plain)
            "fwd_lse": (nb_in + (out.numel() + lse.numel()) * 4,
                        2 * B * N * N * (C + K),
                        lambda: ck.launch_train("fwd_lse", e0, e1, v,
                                                out, lse),
                        lambda: ck.correlation_fwd_lse_plain(e0, e1, v)),
            "bwd_i": (nb_bwd + (de0.numel() + dv.numel()) * 4,
                      2 * B * N * N * (2 * C + 2 * K),
                      lambda: ck.launch_train("bwd_i", e0, e1, v, lse,
                                              dout, c, de0, dv),
                      lambda: ck.correlation_bwd_i_plain(e0, e1, v, lse, dout,
                                                         c)),
            "bwd_j": (nb_bwd + de1.numel() * 4,
                      2 * B * N * N * (2 * C + K),
                      lambda: ck.launch_train("bwd_j", e0, e1, v, lse,
                                              dout, c, de1),
                      lambda: ck.correlation_bwd_j_plain(e0, e1, v, lse, dout,
                                                         c)),
        }
        # library yardstick: fp32 attention with q = e1, k = e0, scale 1, the
        # value v^T zero-padded from K to C columns; its backward through
        # autograd gives dq, dk, dv: the two backward kernels together
        q = e1[:, None].clone().requires_grad_()
        kk = e0[:, None].clone().requires_grad_()
        vv = torch.zeros(B, 1, N, C, device=dev)
        vv[:, 0, :, :K] = v.transpose(1, 2)
        vv.requires_grad_()
        gg = torch.zeros(B, 1, N, C, device=dev)
        gg[:, 0, :, :K] = dout.transpose(1, 2)
        lib = F.scaled_dot_product_attention(q, kk, vv, scale=1.0)
        lib_err = (lib[:, 0, :, :K].transpose(1, 2) - out_p).abs().max().item()
        dq, dk, _ = torch.autograd.grad(lib, (q, kk, vv), gg,
                                        retain_graph=True)
        lib_gerr = max(((dq[:, 0] - de1_p).abs().max()
                        / de1_p.abs().max()).item(),
                       ((dk[:, 0] - de0_p).abs().max()
                        / de0_p.abs().max()).item())
        with torch.no_grad():
            t_lib_f = graph_time_ms(lambda: F.scaled_dot_product_attention(
                q, kk, vv, scale=1.0), iters=3)
        t_lib_b = event_time_ms(lambda: torch.autograd.grad(
            lib, (q, kk, vv), gg, retain_graph=True))
        print(f"           sdpa fp32 at {(B, N, C, K)}: forward {t_lib_f:.3f} "
              f"ms (vs plain {lib_err:.1e}), backward {t_lib_b:.3f} ms (dq, "
              f"dk vs plain, share of max {lib_gerr:.1e})")
        errs = {"fwd_lse": d_out.max().item(),
                "bwd_i": (de0 - de0_p).abs().max().item(),
                "bwd_j": (de1 - de1_p).abs().max().item()}
        lines = {"fwd_lse": 156, "bwd_i": 191, "bwd_j": 231}
        for name, (nbytes, flops, launch, plain) in work.items():
            bound, bound_by = roofline(nbytes, flops, bw, fp32_peak)
            t_k = graph_time_ms(launch, iters=3)
            t_p = graph_time_ms(plain, iters=2, reps=3)
            print(f"           {name:8s} B={B}: kernel {t_k:.3f} ms, plain "
                  f"{t_p:.3f} ms, bound {bound:.3f} ms ({bound_by}), "
                  f"{flops / t_k / 1e9:.1f} TFLOP/s fp32, {bound / t_k:.1%} "
                  "of the bound")
            entry = dict(
                name=f"correlation_{name}", route="cuda",
                source="unicorn_torch/csrc/correlation_train.cu",
                replaces=f"unicorn_tpu/ops/pallas_correlation.py:{lines[name]}",
                launches=None, max_abs_err=errs[name], ms=t_k, plain_ms=t_p,
                bound_ms=bound, bound_by=bound_by,
                library_ms=t_lib_f if name == "fwd_lse" else t_lib_b)
            if name != "fwd_lse":
                entry["library_covers"] = "sdpa backward: bwd_i and bwd_j"
            ker = report.setdefault("kernels", {})
            if (B, N, C, K) == TRAIN_SHAPE:
                entry["per_shape"] = ker.get(f"correlation_{name}", {}).get(
                    "per_shape", [])
                ker[f"correlation_{name}"] = entry
            else:   # the K = 3 shape, after the K = 1 one
                ker[f"correlation_{name}"]["per_shape"].append(dict(
                    shape=[B, N, C, K], ms=t_k, plain_ms=t_p, bound_ms=bound,
                    bound_by=bound_by, library_ms=entry["library_ms"],
                    max_abs_err=errs[name]))
    return ok


def kernels_backward(report) -> bool:
    """The dw7x7, fused-block and MSDA autograd Functions (forward = kernel,
    backward = autograd of the plain version; of the composition for the
    fused block) against autograd of those, at one served shape each, with
    the time of the plain backward.
    Tolerance: the forwards differ as the forward checks allow, the
    backwards are the same plain code on the same saved inputs: every
    gradient within 1e-5 of its largest magnitude in fp32 (scatter-adds in
    another order), within 2^-7 (one bf16 ulp of the largest) in bf16."""
    import torch

    from unicorn_torch.ops import convnext_block as cb
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    ok = True

    def grads_of(fn, inputs, needs, gy=None):
        leaves = [t.clone().requires_grad_(n) for t, n in zip(inputs, needs)]
        y = fn(*leaves)
        if gy is None:
            gy = torch.randn(y.shape, device=dev, generator=g).to(y.dtype)
        wanted = [t for t, n in zip(leaves, needs) if n]
        return y, wanted, gy

    def compare(label, fn_k, fn_p, inputs, needs, tol):
        nonlocal ok
        y_k, in_k, gy = grads_of(fn_k, inputs, needs)
        y_p, in_p, _ = grads_of(fn_p, inputs, needs, gy)
        g_k = torch.autograd.grad(y_k, in_k, gy, retain_graph=True)
        g_p = torch.autograd.grad(y_p, in_p, gy)
        worst = max(((a.float() - b.float()).abs().max()
                     / b.float().abs().max()).item()
                    for a, b in zip(g_k, g_p))
        t_b = event_time_ms(lambda: torch.autograd.grad(
            y_k, in_k, gy, retain_graph=True), iters=5)
        good = worst <= tol
        ok &= good
        print(f"backward {label}: worst gradient difference, share of max "
              f"{worst:.2e} (tol {tol:.1e}); plain backward {t_b:.3f} ms"
              f"{'' if good else '  FAIL'}")

    for dtype, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        x = torch.randn(2, 50, 80, 384, device=dev, generator=g).to(dtype)
        k = 0.1 * torch.randn(7, 7, 384, device=dev, generator=g)
        b = 0.1 * torch.randn(384, device=dev, generator=g)
        n0 = dw.launches
        compare(f"dw7x7 2x50x80x384 {str(dtype)[6:]}", dw.dwconv7x7,
                dw.dwconv7x7_plain, (x, k, b), (True, True, True), tol)
        assert dw.launches == n0 + 1, "dwconv7x7 did not launch its kernel"
    # the fused block op: x and the nine leaves; the backward is autograd of
    # the composition on the saved inputs, whatever the forward gave
    for dtype, tol in ((torch.bfloat16, 2.0 ** -7), (torch.float32, 1e-5)):
        x = torch.randn(2, 50, 80, 384, device=dev, generator=g).to(dtype)
        leaves = cb.flatten_params(_cb_params(384, g, dev))
        n0 = cb.launches
        compare(f"convnext_block 2x50x80x384 {str(dtype)[6:]}",
                lambda x_, *l: cb.convnext_block(
                    x_, cb.unflatten_params(l), True),
                lambda x_, *l: cb.convnext_block_ref(
                    x_, cb.unflatten_params(l), True),
                (x, *leaves), (True,) * 10, tol)
        assert cb.launches == n0 + 1, "convnext_block did not launch"
    value, locs, attw = _msda_inputs((2, 2, 50, 80, 8, 32, 8000, 4),
                                     torch.float32, g, True)
    for method, mode in (("auto", "factored"), ("pallas", "direct")):
        n0 = da.launches_by_mode[mode]
        compare(f"msda {mode} fp32 B=2 50x80", lambda v, l, a: da.ms_deform_attn(
            v, l, a, method), lambda v, l, a: da.ms_deform_attn_plain(
                v, l, a, mode), (value, locs, attw), (True, True, True), 1e-5)
        assert da.launches_by_mode[mode] == n0 + 1
    return ok


def _model(report, raised_priors=False):
    """The unicorn_track_tiny Unicorn (ConvNeXt-Tiny, bf16) on the card,
    seeded random weights; built once per run. raised_priors: the obj/cls
    prediction biases raised by 6 (once), so that the random-weight
    detector's scores clear ByteTrack's thresholds and a tracker has work
    to do."""
    import torch

    from unicorn_torch.exp.unicorn_track_tiny import Exp

    if "model" not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0))
        report["model"] = (exp, model.to(DEVICE).eval())
    if raised_priors and not report.get("raised_priors"):
        _raise_priors(report["model"][1])
        report["raised_priors"] = True
    return report["model"]


# ---------------------------------------------------------------- phase 3
def _forward_whole_check(label, exp, model, n_dw):
    """forward_whole of a bf16 model through the dw7x7 kernel vs through
    the plain version, on the same image at the exp's test size; n_dw
    kernel launches expected. Tolerance, set before the first run: the two
    dw7x7 forms differ by at most about an ulp at each block of random
    weights, so the decoded scores (sigmoids) may move by up to 0.05, and
    the raw logits by up to 5% of their largest magnitude (the bound the
    CPU tests hold bf16 PyTorch against bf16 JAX to)."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.models import blocks
    from unicorn_torch.models.heads import decode_for_inference
    from unicorn_torch.ops import dwconv7x7 as dw

    H, W = exp.test_size
    rng = np.random.RandomState(0)
    img = torch.from_numpy((rng.rand(1, H, W, 3) * 255).round()
                           .astype(np.float32)).to(DEVICE)
    x = img.permute(0, 3, 1, 2)
    with torch.inference_mode():
        n0 = dw.launches
        raw_k = model.forward_whole(x)[0]
        n_k = dw.launches - n0
        with mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain):
            raw_p = model.forward_whole(x)[0]
        dec_k = decode_for_inference(raw_k, (8, 16, 32))
        dec_p = decode_for_inference(raw_p, (8, 16, 32))
        torch.cuda.synchronize()
    d_raw = max(
        ((lk[key].float() - lp[key].float()).abs().max()
         / lp[key].float().abs().max()).item()
        for lk, lp in zip(raw_k, raw_p) for key in ("_cls_packed",
                                                     "_reg_packed"))
    A = (H // 8) * (W // 8) + (H // 16) * (W // 16) + (H // 32) * (W // 32)
    assert tuple(dec_k.shape) == (1, A, 5 + exp.num_classes), dec_k.shape
    assert bool(torch.isfinite(dec_k).all()) and bool(
        torch.isfinite(dec_p).all())
    d_scores = (dec_k[..., 4:] - dec_p[..., 4:]).abs().max().item()
    d_boxes = ((dec_k[..., :4] - dec_p[..., :4]).abs()
               / dec_p[..., :4].abs().clamp_min(1.0)).max().item()
    print(f"{label} {H}x{W} bf16: decoded {tuple(dec_k.shape)}, "
          f"kernel vs plain: max |d score| {d_scores:.3e} (tol 0.05), "
          f"max rel |d box| {d_boxes:.3e}, raw logits max |d| / max|plain| "
          f"{d_raw:.3e} (tol 0.05); dw7x7 launches {n_k}")
    assert n_k == n_dw, n_k
    assert d_scores <= 0.05 and d_raw <= 0.05


def phase_model(report):
    """forward_whole through the kernel vs through the plain version, on the
    unicorn_track_tiny model (`_forward_whole_check`, 27 launches)."""
    exp, model = _model(report)
    _forward_whole_check("forward_whole", exp, model, 27)


# ---------------------------------------------------------------- phase 4
def _mot_path(label, exp, model, n_frames, warmup=3, seed=1):
    """MOTDriver.update over n_frames synthetic FRAME_HW uint8 frames (a
    panning random texture) after `warmup` untimed ones, letterboxed on the
    card, conf_thre 0.0 so that NMS sees its 512 candidates; then the same
    frames with the stages synchronised apart. Prints frames/s, per-stage
    ms, dets and tracks per frame and the peak memory of the timed run;
    returns (frames/s, launch counts of the timed run, tracks per frame,
    dets per frame)."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.mot import MOTDriver

    driver = MOTDriver(model, input_size=exp.test_size,
                       num_classes=exp.num_classes, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    rng = np.random.RandomState(seed)
    fh, fw = FRAME_HW
    base = (rng.rand(fh, fw + 4 * n_frames, 3) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 4 * t:4 * t + fw])
              for t in range(n_frames)]
    for f in frames[:warmup]:                  # warm-up, not counted
        driver.update(f)
    driver.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_kernel_counts()
    tracks = []
    t0 = time.perf_counter()
    for f in frames:
        tracks.append(driver.update(f))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fps = n_frames / wall
    print(f"{label}: {n_frames} frames {fh}x{fw} -> {exp.test_size}, "
          f"{fps:.2f} frames/s ({wall / n_frames * 1e3:.2f} ms/frame); "
          f"launches {counts}; peak memory {peak:.2f} GiB")

    # per-stage times: the same stages as update(), synchronised apart
    driver.reset()
    stages = {"letterbox": [], "forward": [], "decode+nms": [],
              "fetch+tracker": []}
    dets_n, tracks_n = [], []
    for f in frames:
        t = [time.perf_counter()]
        img, r = driver.preprocess(f)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        raw = driver.forward(img)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        dets, valid = driver.postprocess(raw)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        views = driver.track(dets, valid, r)
        t.append(time.perf_counter())
        for k, name in enumerate(stages):
            stages[name].append((t[k + 1] - t[k]) * 1e3)
        dets_n.append(int(valid.sum()))
        tracks_n.append(len(views))
    print("  per-stage ms (median of %d, synchronised): " % n_frames
          + ", ".join(f"{k} {np.median(v):.3f}" for k, v in stages.items()))
    print(f"  dets/frame mean {np.mean(dets_n):.1f} (min {min(dets_n)}, "
          f"max {max(dets_n)}); tracks/frame mean {np.mean(tracks_n):.1f} "
          f"(first {tracks_n[0]}, last {tracks_n[-1]})")
    assert all(np.isfinite(v.tlbr).all() for vs in tracks for v in vs)
    ids = sorted({v.track_id for views in tracks for v in views})
    assert min(dets_n) > 0 and ids, f"{label} produced no tracks"
    return fps, counts, tracks, dets_n


def phase_main(report):
    """MOTDriver.update over N_FRAMES synthetic 1080x1920 uint8 frames on
    the model with raised priors (`_mot_path`): 27 dw7x7 launches a
    frame."""
    exp, model = _model(report, raised_priors=True)
    fps, counts, _, _ = _mot_path("main path", exp, model, N_FRAMES)
    launches = counts["dwconv7x7"]
    report.setdefault("kernels", {}).setdefault("dwconv7x7", {}).update(
        launches=launches, launches_by_path={"mot": launches})
    report["fps"] = fps
    assert launches == 27 * N_FRAMES, launches
    _main_fast_norms(report, exp, model, fps)


def _norm_forms(report):
    """What the card's norms do with a bf16 map: whether F.group_norm /
    F.layer_norm take it with an fp32 affine, the dtype of F.group_norm's
    statistics on it (aten.native_group_norm), how many outputs of
    F.group_norm on the bf16 map (affine rounded) differ from the exact
    form's; then GroupNorm32 and the ConvNeXt LayerNorm32 (perturbed
    affine) with the switch off and on: device ms from CUDA-graph replays
    (no host gaps: the fast GroupNorm's statistics take about three times
    the exact form's eager calls, which frames/s shows), bytes allocated
    beyond the output per element, outputs that differ."""
    import torch
    import torch.nn.functional as F

    from unicorn_torch.models import blocks

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    bf = torch.bfloat16
    CL = torch.channels_last
    for kind, (H, W, C) in (("group_norm", (100, 160, 256)),
                            ("layer_norm", (200, 320, 96))):
        x = (3 * torch.randn(1, C, H, W, device=dev, generator=g) + 1).to(
            bf).contiguous(memory_format=CL)
        if kind == "group_norm":
            mod = blocks.GroupNorm32(C, dtype=bf).to(dev)
            arg = x
        else:
            mod = blocks.LayerNorm32(C, dtype=bf, fast_norms=True).to(dev)
            arg = x.permute(0, 2, 3, 1)         # (1, H, W, C) contiguous
        with torch.no_grad():
            mod.weight.copy_(1 + 0.2 * torch.randn(C, device=dev,
                                                   generator=g))
            mod.bias.copy_(0.2 * torch.randn(C, device=dev, generator=g))
            w, b = mod.weight.detach(), mod.bias.detach()
            ref = mod(arg)
            try:
                if kind == "group_norm":
                    F.group_norm(x, 16, w, b, 1e-3)
                else:
                    F.layer_norm(arg, (C,), w, b, 1e-6)
                mixed = "accepted"
            except RuntimeError as e:
                mixed = f"refused ({str(e).splitlines()[0]})"
            note = ""
            if kind == "group_norm":
                _, mean, _ = torch.ops.aten.native_group_norm(
                    x.contiguous(), None, None, 1, C, H * W, 16, 1e-3)
                y_bf = F.group_norm(x, 16, w.to(bf), b.to(bf), 1e-3)
                note = (f"; its statistics on a bf16 map are {mean.dtype}, "
                        f"{(y_bf != ref).float().mean().item():.4f} of its "
                        f"outputs differ from the exact form's")
        out = {}
        for fast in (False, True):
            blocks.set_fast_norms(fast)
            try:
                with torch.no_grad():
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                    y = mod(arg)
                    torch.cuda.synchronize()
                    extra = (torch.cuda.max_memory_allocated() - base
                             - y.numel() * y.element_size()) / y.numel()
                    t = graph_time_ms(lambda: mod(arg))
            finally:
                blocks.set_fast_norms(False)
            out["fast" if fast else "exact"] = (y, t, extra)
        differ = (out["fast"][0] != out["exact"][0]).float().mean().item()
        print(f"  {kind} 1x{H}x{W}x{C} bf16, fp32 affine: {mixed}{note}. "
              + "; ".join(f"{type(mod).__name__} {k} {t:.4f} ms, {e:.2f} "
                          f"bytes/element beyond the output"
                          for k, (_, t, e) in out.items())
              + f"; fast outputs differing from exact {differ:.4f}")
        report.setdefault("norm_forms", {})[kind] = dict(
            mixed=mixed, differ=differ,
            **{f"{k}_ms": t for k, (_, t, _) in out.items()})


def _decode_drift(a, b):
    """(score drift, box drift px, box drift over the 200 anchors of
    highest objectness in a (all of them if fewer), median box drift) of
    two decoded (1, A, 5+K) outputs."""
    d = (a - b).abs()
    top = a[0, :, 4].topk(min(200, a.shape[1])).indices
    return (d[..., 4:].max().item(), d[..., :4].max().item(),
            d[0, top, :4].max().item(), d[..., :4].median().item())


def _bf16_steps(a, b):
    """Elementwise |a - b| less 1e-5, in bf16 steps at the larger of |a|,
    |b| (8 bits of mantissa); the largest, and the share of a != b."""
    import torch

    a, b = a.float(), b.float()
    m = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    step = torch.exp2(torch.floor(torch.log2(m)) - 7)
    d = ((a - b).abs() - 1e-5).clamp_min(0) / step
    return d.max().item(), (a != b).float().mean().item()


def _fast_sites(model):
    """(name, module) of every norm of the model that honours
    set_fast_norms."""
    from unicorn_torch.models import blocks

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, blocks.GroupNorm32)
            or (isinstance(m, blocks.LayerNorm32) and m.fast_norms)]


def _one_step_drift(model, forward, decoded, name):
    """The decoded frame's drift (`_decode_drift`) from `decoded` when one
    element of norm `name`'s output, in the middle of its map, is moved
    up by one bf16 step in the exact forward: the least change a norm
    form that is not the exact program can make."""
    import torch

    def bump(mod, args, out):
        o = out.clone()
        i = tuple(d // 2 for d in o.shape)
        v = o[i].float()
        step = torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(
            2.0 ** -100))) - 7)
        o[i] = (v + step).to(o.dtype)
        return o

    h = dict(model.named_modules())[name].register_forward_hook(bump)
    try:
        with torch.no_grad():
            return _decode_drift(decoded, forward())
    finally:
        h.remove()


def _one_step_floor(model, forward, decoded):
    """`_one_step_drift` at the first, the middle and the last norm site
    that honours the switch: {site: drift}."""
    names = [n for n, _ in _fast_sites(model)]
    return {n: _one_step_drift(model, forward, decoded, n)
            for n in dict.fromkeys((names[0], names[len(names) // 2],
                                    names[-1]))}


def _norm_sites(model, forward):
    """Every norm of the model that honours set_fast_norms (GroupNorm32,
    LayerNorm32 with fast_norms), on the input the exact forward gives it:
    its output with the switch on against its exact output, in bf16 steps
    (`_bf16_steps`). (sites, bf16 sites, worst steps, its site, the share
    of outputs that differ over the bf16 sites)."""
    import torch

    from unicorn_torch.models import blocks

    sites = _fast_sites(model)
    res, busy = {}, []

    def hook(name):
        def fn(mod, args, out):
            if busy:
                return
            busy.append(1)
            blocks.set_fast_norms(True)
            try:
                fast = mod(*args)
            finally:
                blocks.set_fast_norms(False)
                busy.pop()
            steps, share = _bf16_steps(fast, out)
            res.setdefault(name, []).append(
                (steps, share, out.numel(), out.dtype == torch.bfloat16))
        return fn

    handles = [m.register_forward_hook(hook(n)) for n, m in sites]
    try:
        with torch.no_grad():
            forward()
    finally:
        for h in handles:
            h.remove()
    flat = [(n, *r) for n, rs in res.items() for r in rs]
    bf = [f for f in flat if f[4]]
    worst = max(flat, key=lambda f: f[1])
    share = (sum(f[2] * f[3] for f in bf) / max(1, sum(f[3] for f in bf)))
    return len(sites), len({f[0] for f in bf}), worst[1], worst[0], share


def _fast_norms_jax_case(report):
    """JAX's own case of the switch (tests/test_models.py
    test_fast_norms_serving_drift_bounded: ConvNeXt-Tiny at full width
    under the conv interaction with no attention blocks, one seeded 64x96
    image; tests/test_torch_port_fast_norms.py runs it on the CPU) on the
    card: the fp32 model bit-identical with the switch; bf16 fast against
    bf16 exact, decoded, within JAX's bounds (scores 2e-2, boxes 1.0 px),
    at flax's init affine and at a perturbed one (every norm's scale
    1 + 0.2 N(0, 1), bias 0.2 N(0, 1), seed 1, as the CPU test). Held:
    the fp32 bits and the scores' bound. The boxes are printed against
    JAX's 1.0 px beside `_one_step_floor`, the drift of one bf16 step in
    one element of a norm's output: on the card that step alone moves
    the boxes past 1.0 px, so JAX's box bound holds only for a form that
    is the exact program, as JAX's fast form is; `_norm_sites` is the
    gate a wrong norm fails."""
    import numpy as np
    import torch

    from unicorn_torch.models import blocks
    from unicorn_torch.models.heads import decode_for_inference
    from unicorn_torch.models.unicorn import Unicorn

    cfg = dict(num_classes=1, backbone_name="convnext_tiny",
               in_channels=(192, 384, 768), interact_mode="conv",
               n_layer_att=0, use_attention=False)
    m32 = Unicorn(**cfg, generator=torch.Generator().manual_seed(0))
    state = m32.state_dict()
    m16 = Unicorn(**cfg, dtype=torch.bfloat16,
                  generator=torch.Generator().manual_seed(0))
    models = (m32.to(DEVICE).eval(), m16.to(DEVICE).eval())
    imgs = torch.from_numpy((np.random.RandomState(0).rand(1, 64, 96, 3)
                             * 255).astype(np.float32)).permute(
        0, 3, 1, 2).contiguous(memory_format=torch.channels_last).to(DEVICE)

    def run(m, fast=False):
        blocks.set_fast_norms(fast)
        try:
            with torch.no_grad():
                raw, _ = m.forward_whole(imgs)
                return decode_for_inference(raw, (8, 16, 32),
                                            mode="mot").float()
        finally:
            blocks.set_fast_norms(False)

    res, ok = {}, True
    for affine in ("init", "perturbed"):
        for m in models:
            m.load_state_dict(state)
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for n in m.modules():
                    if affine == "perturbed" and isinstance(
                            n, (blocks.GroupNorm32, blocks.LayerNorm32)):
                        n.weight.copy_(1 + 0.2 * torch.randn(
                            n.weight.shape, generator=g))
                        n.bias.copy_(0.2 * torch.randn(n.bias.shape,
                                                       generator=g))
        f32_equal = torch.equal(run(models[0]), run(models[0], True))
        exact, fast = run(models[1]), run(models[1], True)
        d = _decode_drift(exact, fast)
        floor = _one_step_floor(models[1], lambda: run(models[1]), exact)
        good = f32_equal and d[0] <= 2e-2
        ok &= good
        res[affine] = dict(fp32_equal=f32_equal, drift=d, one_step=floor)
        print(f"  JAX's case (ConvNeXt-Tiny, conv interaction, 64x96), "
              f"{affine} affine: fp32 bit-identical {f32_equal}; bf16 fast "
              f"against exact: scores {d[0]:.3e} (bound 2e-2), boxes "
              f"{d[1]:.3e} px (JAX's 1.0 px "
              f"{'met' if d[1] <= 1.0 else 'not met'}); one bf16 step in "
              f"one element of a norm's output: "
              + ", ".join(f"{n} scores {o[0]:.3e} boxes {o[1]:.3e} px"
                          for n, o in floor.items())
              + f"{'' if good else '  FAIL'}")
    report["fast_norms_jax_case"] = res
    del models
    torch.cuda.empty_cache()
    assert ok, res


def _main_fast_norms(report, exp, model, fps_exact):
    """set_fast_norms on the served model, on one letterboxed MOT frame.
    (a) Every norm that honours the switch, on the input the exact forward
    gives it: its fast output within one bf16 step of its exact output at
    every element (both are roundings of the same value up to fp32
    error; a wrong norm misses by many steps). (b) forward_whole and the
    decode each way: the drift of every anchor's scores and boxes against
    JAX's bounds (2e-2, 1.0 px; tests/test_models.py
    test_fast_norms_serving_drift_bounded), in px and in bf16 steps of the
    decoded value, beside the same drift of the fp32 model (the same
    weights) from the exact bf16 one, bf16's own. The detections kept
    each way; then N_FRAMES MOTDriver.update with the switch
    (`_mot_path`), frames/s beside the exact run's, and forward_whole's
    device time each way (CUDA-graph replays); the norm forms
    (`_norm_forms`)."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.mot import MOTDriver
    from unicorn_torch.exp.unicorn_track_tiny import Exp
    from unicorn_torch.models import blocks
    from unicorn_torch.models.heads import decode_for_inference

    def driver_of(m):
        return MOTDriver(m, input_size=exp.test_size,
                         num_classes=exp.num_classes, conf_thre=0.0,
                         nms_thre=exp.nmsthre, device=DEVICE)

    driver = driver_of(model)
    fh, fw = FRAME_HW
    frame = (np.random.RandomState(9).rand(fh, fw, 3) * 255).astype(np.uint8)
    img, _ = driver.preprocess(frame)
    n_sites, n_bf, worst, worst_at, share = _norm_sites(
        model, lambda: driver.forward(img))
    print(f"main fast norms: {n_sites} norm sites honour the switch, "
          f"{n_bf} of them bf16; fast against exact on the exact forward's "
          f"inputs: worst {worst:.3f} bf16 steps (bound 1) at {worst_at}, "
          f"{share:.3e} of the bf16 sites' outputs differ")
    dec, kept = {}, {}
    for fast in (False, True):
        blocks.set_fast_norms(fast)
        try:
            with torch.no_grad():
                raw = driver.forward(img)
                dec[fast] = decode_for_inference(raw, (8, 16, 32),
                                                 mode="mot").float()
                kept[fast] = int(driver.postprocess(raw)[1].sum())
        finally:
            blocks.set_fast_norms(False)
    e32 = Exp()
    e32.bf16 = False
    m32 = e32.get_model(torch.Generator().manual_seed(0))
    m32.load_state_dict(model.state_dict())
    with torch.no_grad():
        raw = driver_of(m32.to(DEVICE).eval()).forward(img)
        dec32 = decode_for_inference(raw, (8, 16, 32), mode="mot").float()
    del m32, raw
    drift = _decode_drift(dec[False], dec[True])
    own = _decode_drift(dec[False], dec32)
    jax_met = drift[0] <= 2e-2 and drift[1] <= 1.0
    differ = (dec[True] != dec[False]).float().mean().item()
    floor = _one_step_floor(model, lambda: decode_for_inference(
        driver.forward(img), (8, 16, 32), mode="mot").float(), dec[False])
    print(f"main fast norms: one {fh}x{fw} frame, {dec[True].shape[1]} "
          f"anchors, fast against exact bf16: scores drift {drift[0]:.3e}, "
          f"boxes {drift[1]:.3e} px (JAX's bounds 2e-2 and 1.0 px: "
          f"{'met' if jax_met else 'not met'}), {differ:.3e} of the decoded "
          f"values differ; "
          f"{drift[2]:.3e} px over the 200 of highest objectness, median "
          f"{drift[3]:.3e}; the fp32 model against the exact bf16 one: "
          f"scores {own[0]:.3e}, boxes {own[1]:.3e} px, top 200 "
          f"{own[2]:.3e}, median {own[3]:.3e}; detections kept "
          f"{kept[True]} fast / {kept[False]} exact")
    for name, d in floor.items():
        print(f"  one bf16 step in one element of {name}'s output (exact "
              f"forward): scores drift {d[0]:.3e}, boxes {d[1]:.3e} px, "
              f"top 200 {d[2]:.3e}, median {d[3]:.3e}")
    blocks.set_fast_norms(True)
    try:
        fps, counts, _, _ = _mot_path("main path, fast norms", exp, model,
                                      N_FRAMES)
    finally:
        blocks.set_fast_norms(False)
    print(f"  frames/s exact {fps_exact:.2f}, fast norms {fps:.2f}")
    # the forward's device time each way, without the host's gaps (what a
    # caller replaying the forward as a CUDA graph would see)
    fwd_ms = {}
    for fast in (False, True):
        blocks.set_fast_norms(fast)
        try:
            with torch.no_grad():
                fwd_ms[fast] = graph_time_ms(lambda: driver.forward(img),
                                             iters=3, reps=3)
        finally:
            blocks.set_fast_norms(False)
    print(f"  forward_whole device ms (CUDA-graph replay): exact "
          f"{fwd_ms[False]:.3f}, fast norms {fwd_ms[True]:.3f}")
    _norm_forms(report)
    _fast_norms_jax_case(report)
    report["fast_norms"] = dict(
        fps=fps, fps_exact=fps_exact, forward_device_ms=fwd_ms, drift=drift,
        fp32_drift=own, jax_bounds_met=jax_met, site_steps=worst,
        site_share=share, decoded_differ=differ, one_step_drift=floor)
    assert counts["dwconv7x7"] == 27 * N_FRAMES, counts
    assert bool(torch.isfinite(dec[True]).all())
    assert worst <= 1.0 and n_bf > 0, (worst, worst_at, n_bf)


# ------------------------------------------------- fused block in the model
def _fused_block_forward(self, t):
    """A ConvNeXtBlock's forward as one convnext_block call on the block's
    own parameters: NCHW in and out, as the module's."""
    from unicorn_torch.models.blocks import CL
    from unicorn_torch.ops import convnext_block as cb

    tn = t.to(self.dtype).contiguous(memory_format=CL)
    y = cb.convnext_block(tn.permute(0, 2, 3, 1), cb.block_params(self),
                          exact_gelu=self.approximate == "none")
    return y.permute(0, 3, 1, 2)


def phase_block_model(report):
    """The full-width bf16 model with each of its 27 ConvNeXt blocks (18 of
    the trunk, 9 of the head's attention) run as one `convnext_block` call
    on the block's own parameters, against the model's own blocks (dw7x7
    kernel + F.layer_norm + F.linear). The stem, the downsample layers, the
    PAFPN and the rest of the head are the model's in both runs; the
    harness is the patch below, the model has no switch for it. The
    trunk's layer scales, 1e-6 at init (each block would be the identity to
    bf16), are set to seeded values in [0.05, 0.15] for both runs and put
    back afterwards; the head's are 1.0. Bounds, set before the first run:
    the two forms round at different places (the op keeps fp32 through
    LayerNorm, the biases and gamma), about a bf16 ulp of each block's
    branch, over 18 + 3 blocks in a row: raw logits within 0.1 of their
    largest magnitude, decoded scores within 0.1."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.models import blocks
    from unicorn_torch.models.heads import decode_for_inference
    from unicorn_torch.ops import convnext_block as cb
    from unicorn_torch.ops import dwconv7x7 as dw

    exp, model = _model(report)
    H, W = exp.test_size
    rng = np.random.RandomState(0)
    img = torch.from_numpy((rng.rand(1, H, W, 3) * 255).round()
                           .astype(np.float32)).to(DEVICE)
    x = img.permute(0, 3, 1, 2)
    all_blocks = [m for m in model.modules()
                  if isinstance(m, blocks.ConvNeXtBlock)]
    trunk = [m for m in model.backbone.backbone.modules()
             if isinstance(m, blocks.ConvNeXtBlock)]
    assert (len(all_blocks), len(trunk)) == (27, 18)

    saved = [m.gamma.detach().clone() for m in trunk]
    g = torch.Generator(device=DEVICE).manual_seed(8)
    try:
        with torch.inference_mode():
            for m in trunk:
                m.gamma.copy_(0.05 + 0.1 * torch.rand(
                    m.gamma.shape, device=DEVICE, generator=g))
            inputs = {}
            hooks = [m.register_forward_pre_hook(
                lambda mod, args: inputs.__setitem__(mod, args[0]))
                for m in all_blocks]
            dw.launches = cb.launches = 0
            raw_m = model.forward_whole(x)[0]
            n_m = (dw.launches, cb.launches)
            for h in hooks:
                h.remove()
            dw.launches = cb.launches = 0
            with mock.patch.object(blocks.ConvNeXtBlock, "forward",
                                   _fused_block_forward):
                raw_k = model.forward_whole(x)[0]
            n_k = (dw.launches, cb.launches)
            dec_k = decode_for_inference(raw_k, (8, 16, 32))
            dec_m = decode_for_inference(raw_m, (8, 16, 32))
            torch.cuda.synchronize()
            pairs = [(m, inputs[m]) for m in all_blocks]
            t_op = graph_time_ms(
                lambda: [_fused_block_forward(m, t) for m, t in pairs], iters=3)
            t_mod = graph_time_ms(lambda: [m(t) for m, t in pairs], iters=3)
    finally:
        with torch.no_grad():
            for m, gm in zip(trunk, saved):
                m.gamma.copy_(gm)
    d_raw = max(
        ((lk[key].float() - lm[key].float()).abs().max()
         / lm[key].float().abs().max()).item()
        for lk, lm in zip(raw_k, raw_m) for key in ("_cls_packed",
                                                     "_reg_packed"))
    assert bool(torch.isfinite(dec_k).all()) and tuple(dec_k.shape) == tuple(
        dec_m.shape)
    d_scores = (dec_k[..., 4:] - dec_m[..., 4:]).abs().max().item()
    print(f"forward_whole {H}x{W} bf16, 27 blocks as convnext_block calls vs "
          f"the model's own blocks: raw logits max |d| / max|model| "
          f"{d_raw:.3e} (bound 0.1), max |d score| {d_scores:.3e} (bound "
          f"0.1); launches (dw7x7, convnext_block): model's own {n_m}, "
          f"fused {n_k}")
    print(f"the 27 blocks of one frame, wrappers included (graph replay): "
          f"convnext_block {t_op:.4f} ms, the model's blocks {t_mod:.4f} ms")
    report.setdefault("kernels", {}).setdefault(
        "convnext_block", {})["launches"] = n_k[1]
    report["block_frame_ms"] = (t_op, t_mod)
    assert n_m == (27, 0) and n_k == (0, 27), (n_m, n_k)
    assert d_raw <= 0.1 and d_scores <= 0.1


# ------------------------------------------------------------ streaming MOT
STREAM_FRAMES = 16        # push_frame calls; then two run_chunk of 8
STREAM_CHUNK = 8


def _detection_clip(n_frames=40, n_obj=20, seed=0):
    """Synthetic detections per frame, (n, 5) [x1, y1, x2, y2, score]: moving
    boxes with jitter, dropouts, low-score frames, a crossing pair and
    clutter."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pos = rng.uniform(50, 400, (n_obj, 2))
    vel = rng.uniform(-5, 5, (n_obj, 2))
    vel[1] = (pos[0] - pos[1]) / 20.0      # object 1 crosses object 0
    size = rng.uniform(30, 80, (n_obj, 2))
    for t in range(n_frames):
        rows = []
        for i in range(n_obj):
            if rng.rand() < 0.1:           # missed detection
                continue
            tl = pos[i] + t * vel[i] + rng.randn(2) * 1.5
            rows.append(np.r_[tl, tl + size[i],
                              rng.choice([0.95, 0.8, 0.4, 0.2])])
        for _ in range(rng.randint(0, 3)):  # clutter
            tl = rng.uniform(0, 450, 2)
            rows.append(np.r_[tl, tl + rng.uniform(20, 60, 2),
                              rng.uniform(0.05, 0.7)])
        yield np.asarray(rows, np.float32).reshape(-1, 5)


# the TrackState fields the tracker kernel holds bit-equal to the plain form
TRACKER_INT_FIELDS = ("state", "activated", "track_id", "last_frame",
                      "start_frame", "next_id", "frame_id")


def crowded_clip(S=8, D=256, n_frames=60, n_obj=31, seed=0, extent=480.0):
    """(n_frames, S, D, 5) detections and (n_frames, S, D) valid flags of
    crowded streams: n_obj objects a stream moving inside `extent` px (so
    that boxes overlap in clusters), each seen with probability 0.9 at a high
    score; a third of them leave for frames 12-47 (their tracks are lost and
    expire); every visible object also gives low-score jittered copies and
    there is low-score clutter, up to D - 6 valid rows. Coordinates are whole
    pixels and scores two decimals, and some detections are repeated
    exactly, so that costs tie."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    dets = np.zeros((n_frames, S, D, 5), np.float32)
    valid = np.zeros((n_frames, S, D), bool)
    for s in range(S):
        centre = rng.uniform(0.25 * extent, 0.75 * extent, (4, 2))
        pos = centre[rng.randint(0, 4, n_obj)] + rng.uniform(-60, 60,
                                                            (n_obj, 2))
        vel = rng.uniform(-3, 3, (n_obj, 2))
        size = rng.uniform(24, 110, (n_obj, 2))
        away = rng.rand(n_obj) < 1 / 3
        for f in range(n_frames):
            rows = []
            for i in range(n_obj):
                if away[i] and 12 <= f < 48 or rng.rand() < 0.1:
                    continue
                tl = np.round(pos[i] + f * vel[i] + rng.randn(2) * 2.0)
                box = np.r_[tl, tl + np.round(size[i])]
                rows.append(np.r_[box, np.round(rng.uniform(0.62, 0.97), 2)])
                if rng.rand() < 0.15:                  # an exact duplicate
                    rows.append(rows[-1].copy())
            for i in range(n_obj):                     # low-score copies
                for _ in range(rng.randint(3, 6)):
                    tl = np.round(pos[i] + f * vel[i] + rng.randn(2) * 6.0)
                    box = np.r_[tl, tl + np.round(size[i]
                                                  * rng.uniform(0.8, 1.2))]
                    rows.append(np.r_[box,
                                      np.round(rng.uniform(0.12, 0.58), 2)])
            while len(rows) < D - 6:                   # clutter
                tl = np.round(rng.uniform(0, extent, 2))
                rows.append(np.r_[tl, tl + np.round(rng.uniform(15, 80, 2)),
                                  np.round(rng.uniform(0.02, 0.58), 2)])
            rows = np.asarray(rows[:D - 6], np.float32)
            order = rng.permutation(len(rows))
            dets[f, s, :len(rows)] = rows[order]
            valid[f, s, :len(rows)] = True
    return torch.from_numpy(dets), torch.from_numpy(valid)


def stream_tracker_kernel(n_frames=60):
    """The tracker step's kernel (csrc/tracker_step.cu) at the serving
    cell's shapes, S 8, T 256, D 256, over `crowded_clip`: held against the
    plain form on the card frame by frame (valid masks, ids and every
    integer field of the state equal, scores equal, boxes within 1e-4 px),
    then timed: its launches, auction rounds and device us a frame (CUDA
    events around the frames' launches, enqueued behind a device sleep so
    that the host's dispatch stays out), its host us a call, and the plain
    form's host ms a frame (synchronised)."""
    import torch

    from unicorn_torch.tracker import device_tracker as dtk

    S, T, D = 8, 256, 256
    dets, valid = (x.to(DEVICE) for x in crowded_clip(S, D, n_frames))
    ts_k = dtk.init_state(T, S, device=DEVICE)
    ts_p = dtk.init_state(T, S, device=DEVICE)
    d_box = 0.0
    for f in range(n_frames):
        ts_k, out_k, ov_k = dtk.tracker_step(ts_k, dets[f], valid[f])
        ts_p, out_p, ov_p = dtk.tracker_step_plain(ts_p, dets[f], valid[f])
        assert torch.equal(ov_k, ov_p), f"valid mask, frame {f}"
        assert torch.equal(out_k[..., 4:], out_p[..., 4:]), f"ids, {f}"
        for name in TRACKER_INT_FIELDS:
            assert torch.equal(getattr(ts_k, name), getattr(ts_p, name)), (
                f"{name}, frame {f}")
        d_box = max(d_box, (out_k[..., :4] - out_p[..., :4]).abs().max()
                    .item())
    assert d_box <= 1e-4, d_box

    def plain():
        ts = dtk.init_state(T, S, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in range(n_frames):
            ts = dtk.tracker_step_plain(ts, dets[f], valid[f])[0]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n_frames * 1e3

    def kernel():
        ts = dtk.init_state(T, S, device=DEVICE)
        torch.cuda.synchronize()
        l0 = dtk.auction_stats["fused_steps"]
        r0 = dtk.fused_rounds(DEVICE).clone()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(200_000_000)        # ~0.1 s: the host runs ahead
        e0.record()
        t0 = time.perf_counter()
        for f in range(n_frames):
            ts = dtk.tracker_step(ts, dets[f], valid[f])[0]
        host_us = (time.perf_counter() - t0) / n_frames * 1e6
        e1.record()
        torch.cuda.synchronize()
        rounds = (dtk.fused_rounds(DEVICE) - r0).tolist()
        return (e0.elapsed_time(e1) / n_frames * 1e3, host_us,
                (dtk.auction_stats["fused_steps"] - l0) / n_frames,
                [r / n_frames for r in rounds])

    plain_ms = [plain()]
    k1 = kernel()
    k2 = kernel()
    plain_ms.append(plain())
    print(f"tracker_step kernel, S {S} T {T} D {D}, {n_frames} crowded "
          f"frames: equal to the plain form on the card (valid, ids, scores,"
          f" slot states; boxes within {d_box:.3g} px); {k1[2]:.1f} launches"
          f" a frame; auction rounds a frame (summed over streams) "
          f"{', '.join(f'{r:.1f}' for r in k1[3])}; device "
          f"{k1[0]:.1f} / {k2[0]:.1f} us a frame, host {k1[1]:.1f} / "
          f"{k2[1]:.1f} us a call; the plain form {plain_ms[0]:.2f} / "
          f"{plain_ms[1]:.2f} ms a frame (host clock, synchronised)")
    return {"device_us": [k1[0], k2[0]], "host_us": [k1[1], k2[1]],
            "launches": k1[2], "rounds": k1[3], "plain_ms": plain_ms}


def phase_stream(report):
    """The streaming MOT path, tracker on the card. (i) tracker_step over a
    synthetic detection clip on the card against the same function on the
    CPU: valid masks and ids equal frame by frame. (ii)
    StreamingMOTPipeline on the full-width bf16 model with raised priors,
    the JAX bench's settings (conf 0.1, nms 0.8, 128 candidates, 64
    detections, 128 track slots): 3 warm-up frames, STREAM_FRAMES
    push_frame calls on synthetic 1080x1920 uint8 frames letterboxed on the
    card, the same frames again as two run_chunk calls (which must give the
    pushed frames' rows), one run_chunk with n_streams=2; frames/s beside
    MOTDriver.update on the same frames in the same call, in the order MOT,
    stream, stream, MOT."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.mot import MOTDriver
    from unicorn_torch.drivers.stream import StreamingMOTPipeline
    from unicorn_torch.ops import dwconv7x7 as dw
    from unicorn_torch.ops.letterbox import letterbox_device
    from unicorn_torch.tracker import device_tracker as dtk

    # (i) the device tracker on the card against itself on the CPU
    T, D = 64, 32
    ts_c = dtk.init_state(T, device="cpu")
    ts_g = dtk.init_state(T, device=DEVICE)
    emitted = 0
    for t, rows in enumerate(_detection_clip()):
        dets = torch.zeros(1, D, 5)
        dets[0, :len(rows)] = torch.from_numpy(rows)
        valid = (torch.arange(D) < len(rows))[None]
        ts_c, out_c, ov_c = dtk.tracker_step(ts_c, dets, valid)
        ts_g, out_g, ov_g = dtk.tracker_step(ts_g, dets.to(DEVICE),
                                             valid.to(DEVICE))
        assert torch.equal(ov_g.cpu(), ov_c), f"valid mask, frame {t}"
        assert torch.equal(out_g.cpu()[..., 5], out_c[..., 5]), f"ids, {t}"
        assert torch.equal(ts_g.track_id.cpu(), ts_c.track_id)
        assert torch.equal(ts_g.state.cpu(), ts_c.state)
        d_box = (out_g.cpu()[ov_c][:, :4] - out_c[ov_c][:, :4]).abs()
        assert not len(d_box) or d_box.max().item() < 1e-2
        emitted += int(ov_c.sum())
    print(f"tracker_step, 40 frames of 20 objects: card == CPU (valid, ids, "
          f"slot states; boxes within 1e-2 px); {emitted} rows emitted, "
          f"{int(ts_c.next_id[0]) - 1} ids given")
    assert emitted > 300
    report["tracker_step"] = stream_tracker_kernel()

    # (ii) the pipeline
    exp, model = _model(report, raised_priors=True)
    kw = dict(input_size=exp.test_size, num_classes=exp.num_classes,
              conf_thre=0.1, nms_thre=0.8, max_dets=64, max_tracks=128,
              n_cand=128)
    pipe = StreamingMOTPipeline(model, device=DEVICE, **kw)
    mot = MOTDriver(model, input_size=exp.test_size,
                    num_classes=exp.num_classes, conf_thre=0.1, nms_thre=0.8,
                    max_out=64, device=DEVICE)
    rng = np.random.RandomState(1)
    fh, fw = FRAME_HW
    n = STREAM_FRAMES
    base = (rng.rand(fh, fw + 4 * n, 3) * 255).astype(np.uint8)
    frames = [np.ascontiguousarray(base[:, 4 * t:4 * t + fw])
              for t in range(n)]

    def ingest(f):
        """uint8 frame -> (1, H, W, 3) float32 on the card, letterboxed."""
        return letterbox_device(torch.from_numpy(f).to(DEVICE),
                                exp.test_size)[0][None]

    def run_mot():
        mot.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for f in frames:
            mot.update(f)
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    def run_stream():
        pipe.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [pipe.push_frame(ingest(f)) for f in frames]
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0), torch.stack(outs)

    for f in frames[:3]:                       # warm-up, not counted
        pipe.push_frame(ingest(f))
        mot.update(f)
    fps_mot = [run_mot()]
    dw.launches = 0
    for k in dtk.auction_stats:
        dtk.auction_stats[k] = 0
    r0 = dtk.fused_rounds(DEVICE).clone()
    fps_stream, pushed = run_stream()
    launches = dw.launches
    stats = dict(dtk.auction_stats)
    rounds = (dtk.fused_rounds(DEVICE) - r0).sum().item()
    frame_id = int(pipe.ts.frame_id[0])
    fps_stream2, pushed2 = run_stream()
    fps_mot.append(run_mot())
    print(f"stream path: push_frame x {n}, {fh}x{fw} -> {exp.test_size}, "
          f"upload and letterbox included: {fps_stream:.2f} and "
          f"{fps_stream2:.2f} frames/s; MOTDriver.update on the same frames "
          f"before and after: {fps_mot[0]:.2f} and {fps_mot[1]:.2f} frames/s; "
          f"dw7x7 launches {launches} (27 x {n} = {27 * n})")
    print(f"  per frame: {stats['fused_steps'] / n:.1f} tracker kernel "
          f"launches, {rounds / n:.1f} auction rounds on the card, "
          f"{stats['syncs'] / n:.2f} host synchronisations in the tracker")
    assert stats["fused_steps"] == n and stats["syncs"] == 0, stats

    # the same frames as two chunks, then tracker-only timing on their dets
    stack = torch.cat([ingest(f) for f in frames])
    pipe.reset()
    chunks = torch.cat([pipe.run_chunk(stack[:STREAM_CHUNK]),
                        pipe.run_chunk(stack[STREAM_CHUNK:])])
    torch.cuda.synchronize()
    same_valid = torch.equal(chunks[..., 6], pushed[..., 6])
    same_ids = torch.equal(chunks[..., 5], pushed[..., 5])
    d_rows = (chunks - pushed).abs().max().item()
    n_valid = int((pushed[..., 6] > 0.5).sum())
    with torch.inference_mode():
        dets = [pipe.detect(stack[t:t + 1]) for t in range(n)]
        pipe.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = [pipe.associate(d5, v) for d5, v in dets]
        torch.cuda.synchronize()
        tracker_ms = (time.perf_counter() - t0) / n * 1e3
        # the kernel against the plain form at the pipeline's own shapes
        ts_p = dtk.init_state(pipe.ts.state.shape[-1], device=DEVICE)
        for t, (d5, v) in enumerate(dets):
            ts_p, out_p, ov_p = dtk.tracker_step_plain(ts_p, d5, v,
                                                       **pipe._track_kw)
            assert torch.equal(fused[t][..., 6] > 0.5, ov_p), f"valid, {t}"
            assert torch.equal(fused[t][..., 4:6], out_p[..., 4:6]), (
                f"scores and ids, frame {t}")
            assert (fused[t][..., :4] - out_p[..., :4]).abs().max() <= 1e-4
        for name in TRACKER_INT_FIELDS:
            assert torch.equal(getattr(pipe.ts, name), getattr(ts_p, name))
    n_dets = float(np.mean([int(v.sum()) for _, v in dets]))
    print(f"  run_chunk 2 x {STREAM_CHUNK} vs the pushed frames: valid equal "
          f"{same_valid}, ids equal {same_ids}, max |d| {d_rows:.2e}; "
          f"{n_valid / n:.1f} tracks emitted per frame, {n_dets:.1f} "
          f"detections per frame; tracker_step {tracker_ms:.2f} ms per frame "
          f"(host clock, detections ready), equal to the plain form on the "
          f"card at S 1, T {pipe.ts.state.shape[-1]}, D {dets[0][1].shape[-1]}"
          f" (valid, scores, ids, slot states; boxes within 1e-4 px)")

    # two streams through one detector batch
    pipe2 = StreamingMOTPipeline(model, device=DEVICE, n_streams=2, **kw)
    two = stack.reshape(2, STREAM_CHUNK, *stack.shape[1:])
    pipe2.run_chunk(two[:, :2])                # warm-up, not counted
    pipe2.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2 = pipe2.run_chunk(two)
    torch.cuda.synchronize()
    fps2 = 2 * STREAM_CHUNK / (time.perf_counter() - t0)
    ids_s0 = (out2[0][..., 5] == chunks[:STREAM_CHUNK][..., 5]).float().mean()
    print(f"  n_streams=2, run_chunk of {STREAM_CHUNK}: {fps2:.2f} frames/s "
          f"over both streams; stream 0 gives the single stream's ids at "
          f"{ids_s0.item():.1%} of the slots (a batch of 2 moves bf16 "
          f"roundings); frame_id {pipe2.ts.frame_id.tolist()}")
    report["stream_fps"] = (fps_stream, fps_stream2)
    dwk = report.setdefault("kernels", {}).setdefault("dwconv7x7", {})
    dwk.setdefault("launches_by_path", {})["stream"] = launches
    dwk["launches"] = (dwk.get("launches") or 0) + launches

    assert launches == 27 * n, launches
    assert frame_id == n and pipe2.ts.frame_id.tolist() == [STREAM_CHUNK] * 2
    assert tuple(pushed.shape) == (n, 128, 7)
    assert tuple(out2.shape) == (2, STREAM_CHUNK, 128, 7)
    for t in (pushed, pushed2, chunks, out2):
        assert bool(torch.isfinite(t).all())
    assert same_valid and same_ids and d_rows < 1e-3
    assert torch.equal(pushed2[..., 5], pushed[..., 5])
    assert n_valid > 0, "the stream path emitted no track"


# ------------------------------------------------------------ SOT phases
def _sot_model(report, msda_method="auto"):
    """The served unicorn_track_tiny Unicorn (bf16 trunk and head, bf16
    interaction) on the card, seeded random weights; one per MSDA method,
    with the same weights."""
    import torch

    from unicorn_torch.exp.unicorn_track_tiny import Exp

    key = f"sot_model_{msda_method}"
    if key not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0), serve=True,
                              msda_method=msda_method)
        report[key] = (exp, model.to(DEVICE).eval())
    return report[key]


def _sot_frames(n, seed, hw=None):
    """n + 1 synthetic uint8 frames of FRAME_HW (or hw): a panning random
    texture."""
    import numpy as np

    rng = np.random.RandomState(seed)
    fh, fw = hw or FRAME_HW
    base = (rng.rand(fh, fw + 4 * (n + 1), 3) * 255).astype(np.uint8)
    return [np.ascontiguousarray(base[:, 4 * t:4 * t + fw])
            for t in range(n + 1)]


def _kernel_counts():
    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    return dict(dwconv7x7=dw.launches, msda_factored=da.launches_by_mode[
        "factored"], msda_direct=da.launches_by_mode["direct"],
        correlation=ck.launches)


def _reset_kernel_counts():
    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    dw.launches = dw.wgrad_launches = da.launches = ck.launches = 0
    da.launches_by_mode.update(factored=0, direct=0)


@contextlib.contextmanager
def _plain_serving_kernels(which=("dwconv7x7", "msda", "correlation")):
    """The serving path's wrappers named in `which` patched to their plain
    versions, as phases sot_model and vos patch them."""
    from unittest import mock

    from unicorn_torch.drivers import sot as sot_mod
    from unicorn_torch.drivers import vos as vos_mod
    from unicorn_torch.models import blocks, interaction
    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    def corr(e0, e1, v):
        return ck.correlation_propagate_plain(e0, e1, v, bf16_dots=True)

    patches = {
        "dwconv7x7": [(blocks, "dwconv7x7", dw.dwconv7x7_plain)],
        "msda": [(interaction, "ms_deform_attn",
                  lambda v, l, a, method: da.ms_deform_attn_plain(
                      v, l, a, "factored"))],
        "correlation": [(sot_mod, "correlation_propagate_auto", corr),
                        (vos_mod, "correlation_propagate_auto", corr)]}
    with contextlib.ExitStack() as stack:
        for name in which:
            for mod, attr, fn in patches[name]:
                stack.enter_context(mock.patch.object(mod, attr, fn))
        yield


def _sot_frame_check(label, exp, model, expected):
    """One SOT frame on a served model through the three kernels vs the
    same through their plain versions (the wrappers patched out); the
    launches as `expected`. Tolerances, set before the first run: the two
    dw7x7 forms differ by about a bf16 ulp at each block and the two MSDA
    forms by an ulp of their output, so the bf16 embeddings and the SOT
    branch's raw logits may move by up to 5% of their largest magnitude
    (the bound of phase model); the propagated prior is an average of
    labels in [0, 1] under a softmax of scores that move with the
    embeddings: up to 0.05."""
    import torch

    from unicorn_torch.drivers.sot import SOTDriver

    driver = SOTDriver(model, input_size=exp.test_size, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    frames = _sot_frames(1, seed=3)
    driver.initialize(frames[0], INIT_BOX)
    img, _ = driver.preprocess(frames[1])

    def one_frame():
        fpn_outs, feat_cur = driver.backbone(img)
        emb_ref, emb_cur = driver.embed(feat_cur)
        priors = driver.propagate(emb_ref, emb_cur, fpn_outs)
        raw = driver.head(fpn_outs, priors)
        torch.cuda.synchronize()
        return emb_ref, emb_cur, priors[0], raw

    _reset_kernel_counts()
    out_k = one_frame()
    counts = _kernel_counts()
    with _plain_serving_kernels():
        out_p = one_frame()
    assert _kernel_counts() == counts, "a plain version launched a kernel"

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    H, W = exp.test_size
    d_emb = max(rel(out_k[0], out_p[0]), rel(out_k[1], out_p[1]))
    d_prior = (out_k[2].float() - out_p[2].float()).abs().max().item()
    d_raw = max(rel(lk[key], lp[key]) for lk, lp in zip(out_k[3], out_p[3])
                for key in ("cls_sot", "reg_sot", "obj_sot"))
    assert tuple(out_k[1].shape) == (1, exp.embed_dim, H // 8, W // 8)
    assert out_k[1].dtype == torch.bfloat16
    assert tuple(out_k[2].shape) == (1, 1, H // 8, W // 8)
    for t in (*out_k[:3], *(lv[k] for lv in out_k[3]
                            for k in ("cls_sot", "reg_sot", "obj_sot"))):
        assert bool(torch.isfinite(t.float()).all())
    print(f"{label} {H}x{W}, bf16 trunk + bf16 interaction, kernel vs "
          f"plain: embeddings max |d| / max|plain| {d_emb:.3e} (tol 0.05), "
          f"prior max |d| {d_prior:.3e} (tol 0.05; prior in "
          f"[{out_k[2].min().item():.3f}, {out_k[2].max().item():.3f}]), "
          f"sot raw logits max |d| / max|plain| {d_raw:.3e} (tol 0.05); "
          f"launches {counts}")
    assert counts == expected, counts
    assert d_emb <= 0.05 and d_prior <= 0.05 and d_raw <= 0.05


SOT_LAUNCHES = dict(dwconv7x7=27, msda_factored=1, msda_direct=0,
                    correlation=1)   # a frame of unicorn_track_tiny's SOT


def phase_sot_model(report):
    """One SOT frame on the served unicorn_track_tiny model, kernels vs
    plain (`_sot_frame_check`)."""
    exp, model = _sot_model(report)
    _sot_frame_check("sot frame", exp, model, SOT_LAUNCHES)


def _sot_stage_ms(label, driver, frames):
    """The stages of SOTDriver.track on each frame, synchronised apart:
    prints their median ms; returns the last frame's packed output."""
    import numpy as np
    import torch

    stages = {"letterbox": [], "backbone": [], "interaction+upsample": [],
              "correlation+priors": [], "head": [], "decode+nms": [],
              "fetch": []}
    for f in frames:
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        img, _ = driver.preprocess(f)
        lap()
        fpn_outs, feat_cur = driver.backbone(img)
        lap()
        emb_ref, emb_cur = driver.embed(feat_cur)
        lap()
        priors = driver.propagate(emb_ref, emb_cur, fpn_outs)
        lap()
        raw = driver.head(fpn_outs, priors)
        lap()
        packed = driver.postprocess(raw)
        lap()
        packed = packed.cpu().numpy()
        lap()
        for k, name in enumerate(stages):
            stages[name].append((t[k + 1] - t[k]) * 1e3)
    print(f"{label} per-stage ms (median of {len(frames)}, synchronised): "
          + ", ".join(f"{k} {np.median(v):.3f}" for k, v in stages.items()))
    return packed


def phase_sot(report):
    """The SOT path: SOTDriver.initialize on a synthetic 1080x1920 uint8
    frame with a box, N_TRACK track calls on the panning frames, one
    track_window of N_WINDOW frames; then N_DIRECT track calls on the same
    weights with the MSDA kernel's direct mode (method "pallas").
    conf_thre is 0.0 so that the random-weight SOT branch always yields a
    box and NMS sees its 256 candidates."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.sot import SOTDriver

    exp, model = _sot_model(report)
    kw = dict(input_size=exp.test_size, conf_thre=0.0, nms_thre=exp.nmsthre,
              device=DEVICE)
    driver = SOTDriver(model, **kw)
    frames = _sot_frames(N_TRACK + N_WINDOW, seed=4)
    fh, fw = FRAME_HW
    driver.initialize(frames[0], INIT_BOX)
    for f in frames[1:3]:                      # warm-up, not counted
        driver.track(f)
    driver.track_window(frames[1:1 + WINDOW], window=WINDOW)
    driver.initialize(frames[0], INIT_BOX)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_kernel_counts()
    t0 = time.perf_counter()
    boxes = [driver.track(f)["target_bbox"] for f in frames[1:1 + N_TRACK]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    boxes += [o["target_bbox"] for o in driver.track_window(
        frames[1 + N_TRACK:], window=WINDOW)]
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    counts = _kernel_counts()
    n_chunks = N_WINDOW // WINDOW
    calls = N_TRACK + n_chunks
    print(f"sot path: track x {N_TRACK}, {fh}x{fw} -> {exp.test_size}: "
          f"{N_TRACK / wall:.2f} frames/s ({wall / N_TRACK * 1e3:.2f} "
          f"ms/frame); track_window {N_WINDOW} frames in chunks of {WINDOW}: "
          f"{N_WINDOW / wall_w:.2f} frames/s; launches {counts} "
          f"(27 / 1 / 1 per frame or chunk x {calls})")
    report["sot_fps"] = N_TRACK / wall
    ker = report.setdefault("kernels", {})
    for name in ("msda_factored", "correlation"):
        ker.setdefault(name, {}).update(
            launches=counts[name], launches_by_path={"sot": counts[name]})
    dwk = ker.setdefault("dwconv7x7", {})
    dwk.setdefault("launches_by_path", {})["sot"] = counts["dwconv7x7"]
    dwk["launches"] = (dwk.get("launches") or 0) + counts["dwconv7x7"]

    packed = _sot_stage_ms("sot", driver, frames[1:1 + N_TRACK])
    print(f"sot peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; last packed row {np.round(packed[0, 0], 3).tolist()}")

    # the same weights with MSDA method "pallas": the kernel's direct mode
    _, model_d = _sot_model(report, msda_method="pallas")
    driver_d = SOTDriver(model_d, **kw)
    driver_d.initialize(frames[0], INIT_BOX)
    driver_d.track(frames[1])                  # warm-up, not counted
    driver_d.initialize(frames[0], INIT_BOX)
    _reset_kernel_counts()
    boxes_d = [driver_d.track(f)["target_bbox"]
               for f in frames[1:1 + N_DIRECT]]
    torch.cuda.synchronize()
    counts_d = _kernel_counts()
    ker.setdefault("msda_direct", {})["launches"] = counts_d["msda_direct"]
    print(f"sot path, msda method 'pallas' x {N_DIRECT}: launches {counts_d};"
          f" box of frame 1 {np.round(boxes_d[0], 2).tolist()} vs factored "
          f"{np.round(boxes[0], 2).tolist()}")

    assert counts == dict(dwconv7x7=27 * calls, msda_factored=calls,
                          msda_direct=0, correlation=calls), counts
    assert counts_d == dict(dwconv7x7=27 * N_DIRECT, msda_factored=0,
                            msda_direct=N_DIRECT,
                            correlation=N_DIRECT), counts_d
    # boxes are finite, have a positive size and lie inside the letterboxed
    # canvas taken back to frame coordinates (the frame plus its padding)
    H, W = exp.test_size
    r = min(H / fh, W / fw)
    assert len(boxes) == N_TRACK + N_WINDOW
    for x, y, w, h in boxes + boxes_d:
        assert np.isfinite([x, y, w, h]).all() and w > 0 and h > 0
        assert x >= 0 and y >= 0 and x + w <= W / r + 1e-3 \
            and y + h <= H / r + 1e-3, (x, y, w, h)


# ---------------------------------------------- instance segmentation
INST_FRAMES = 16          # timed frames of the inst path
INST_WARMUP = 3


def _inst_model(report):
    """The unicorn_inst_convnext_tiny_800x1280 YOLOXDet (ConvNeXt-Tiny, three
    head attention blocks a level, 80 classes, bf16, the CondInst
    controllers and mask branch) on the card, seeded random weights, with
    the obj/cls prediction biases raised by 6 as _model raises them, so
    that the NMS keeps rows and the mask decode has slots to fill."""
    import torch

    from unicorn_torch.exp.unicorn_inst_convnext_tiny_800x1280 import Exp

    if "inst_model" not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0))
        with torch.no_grad():
            for name, p in model.head.named_parameters():
                if name.startswith(("obj_preds.", "cls_preds.")) and \
                        name.endswith(".bias"):
                    p.add_(6.0)
        report["inst_model"] = (exp, model.to(DEVICE).eval())
    return report["inst_model"]


def phase_inst(report):
    """Instance segmentation: ExpDetMask.get_inst_forward on the inst
    model. (1) One image through the dw7x7 kernel and through its plain
    version. Tolerances, set before the first run: the raw outputs, the
    controllers included, and the mask features within 5% of their largest
    magnitude (phase model's bound); the masks (sigmoid scores) of the
    slots whose anchor index agrees within 0.05, on at least half of the
    slots. (2) INST_WARMUP + INST_FRAMES frames of 1080x1920 uint8:
    letterbox on the card, forward, decode + NMS, mask decode; frames/s,
    per-stage ms, detections per frame, peak memory, 27 dw7x7 launches a
    frame. (3) One frame of the unicorn_track_tiny_mask Unicorn through
    forward_whole and forward_mask_branch: shapes and finite values."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.exp.unicorn_track_tiny_mask import Exp as TrackMaskExp
    from unicorn_torch.models import blocks
    from unicorn_torch.ops import dwconv7x7 as dw

    exp, model = _inst_model(report)
    fwd = exp.get_inst_forward(model, device=DEVICE)
    H, W = exp.test_size
    rng = np.random.RandomState(0)
    img = torch.from_numpy((rng.rand(1, H, W, 3) * 255).round().astype(
        np.float32)).to(DEVICE).permute(0, 3, 1, 2)

    def one(x):
        raw, mask_out = fwd.forward(x)
        flat, dets, valid, idx = fwd.detect(raw)
        masks = fwd.masks(flat, idx, mask_out)
        torch.cuda.synchronize()
        return raw, mask_out[0], valid[0], idx[0], masks

    n0 = dw.launches
    out_k = one(img)
    n_k = dw.launches - n0
    with mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain):
        out_p = one(img)
    assert dw.launches == n0 + n_k, "the plain version launched a kernel"

    def rel(a, b):
        return ((a.float() - b.float()).abs().max()
                / b.float().abs().max()).item()

    d_raw = max(rel(lk[key], lp[key]) for lk, lp in zip(out_k[0], out_p[0])
                for key in ("_cls_packed", "_reg_packed"))
    d_ctrl = max(rel(lk["ctrl"], lp["ctrl"])
                 for lk, lp in zip(out_k[0], out_p[0]))
    d_feats = rel(out_k[1], out_p[1])
    same = (out_k[3] == out_p[3]) & out_k[2] & out_p[2]
    n_same = int(same.sum())
    d_masks = ((out_k[4] - out_p[4]).abs()[same].max().item()
               if n_same else float("inf"))
    K = fwd.max_out
    assert tuple(out_k[4].shape) == (K, H // 4, W // 4), out_k[4].shape
    assert tuple(out_k[1].shape) == (1, 8, H // 8, W // 8)
    assert all(lv["ctrl"].shape[1] == 169 for lv in out_k[0])
    assert bool(torch.isfinite(out_k[4]).all())
    print(f"inst image {H}x{W} bf16, 80 classes, kernel vs plain: raw logits"
          f" max |d| / max|plain| {d_raw:.3e}, controllers {d_ctrl:.3e}, "
          f"mask features {d_feats:.3e} (tol 0.05 each); masks of the "
          f"{n_same} of {K} slots whose anchor agrees: max |d| "
          f"{d_masks:.3e} (tol 0.05); valid slots {int(out_k[2].sum())}; "
          f"dw7x7 launches {n_k}")
    assert n_k == 27, n_k
    assert max(d_raw, d_ctrl, d_feats) <= 0.05
    assert n_same >= K // 2 and d_masks <= 0.05
    del out_k, out_p

    # the inst path over synthetic frames
    frames = _sot_frames(INST_WARMUP + INST_FRAMES - 1, seed=5)

    def path(f):
        x, _ = fwd.preprocess(f, exp.test_size)
        return fwd(x)

    for f in frames[:INST_WARMUP]:
        path(f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    timed = frames[INST_WARMUP:]
    dw.launches = 0
    # a server holds one frame's outputs at a time: keep, per frame, only
    # its detection count, a finiteness flag and the masks' range, reduced
    # on the card, so that the peak counts no earlier frame's masks
    kept = []
    t0 = time.perf_counter()
    for f in timed:
        dets, valid, masks = path(f)
        kept.append(torch.stack([
            valid.sum().float(),
            (torch.isfinite(dets).all() & torch.isfinite(masks).all()).float(),
            masks.min(), masks.max()]))
        del dets, valid, masks
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dw.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    fh, fw = FRAME_HW
    fps = INST_FRAMES / wall
    print(f"inst path: {INST_FRAMES} frames {fh}x{fw} -> {exp.test_size}, "
          f"{fps:.2f} frames/s ({wall / INST_FRAMES * 1e3:.2f} ms/frame); "
          f"dw7x7 launches {launches} (27 x {INST_FRAMES} = "
          f"{27 * INST_FRAMES}); peak memory {peak:.2f} GiB ({resident:.2f}"
          f" GiB held before the first timed frame: the inst model and the "
          f"earlier phases' models)")
    report["inst_fps"] = fps
    dwk = report.setdefault("kernels", {}).setdefault("dwconv7x7", {})
    dwk.setdefault("launches_by_path", {})["inst"] = launches
    dwk["launches"] = (dwk.get("launches") or 0) + launches

    # per-stage times: the stages of one call, synchronised apart
    stages = {"letterbox": [], "forward": [], "decode+nms": [],
              "mask decode": []}
    for f in timed:
        t = [time.perf_counter()]

        def lap():
            torch.cuda.synchronize()
            t.append(time.perf_counter())

        x, _ = fwd.preprocess(f, exp.test_size)
        lap()
        raw, mask_out = fwd.forward(x)
        lap()
        flat, dets, valid, idx = fwd.detect(raw)
        lap()
        fwd.masks(flat, idx, mask_out)
        lap()
        for k, name in enumerate(stages):
            stages[name].append((t[k + 1] - t[k]) * 1e3)
    kept = torch.stack(kept).cpu().numpy()
    n_dets = kept[:, 0].astype(int)
    print("inst per-stage ms (median of %d, synchronised): " % INST_FRAMES
          + ", ".join(f"{k} {np.median(v):.3f}" for k, v in stages.items()))
    print(f"inst dets/frame mean {np.mean(n_dets):.1f} (min {min(n_dets)}, "
          f"max {max(n_dets)}); masks ({K}, {H // 4}, {W // 4}) in "
          f"[{kept[:, 2].min():.3f}, {kept[:, 3].max():.3f}]")
    assert launches == 27 * INST_FRAMES, launches
    assert min(n_dets) > 0, "the inst path kept no detection"
    assert kept[:, 1].all(), "the inst path gave a value that is not finite"
    report.pop("inst_model")

    # the mask stage's unified model: one frame through its mask branch
    texp = TrackMaskExp()
    uni = texp.get_model(torch.Generator().manual_seed(0), serve=True)
    uni = uni.to(DEVICE).eval()
    x, _ = fwd.preprocess(frames[0], texp.test_size)
    n0 = dw.launches
    with torch.inference_mode():
        raw, feat_s16 = uni.forward_whole(x)
        feats, up_mask, _ = uni.forward_mask_branch(
            uni.forward_backbone(x)[0])
        torch.cuda.synchronize()
    n_u = dw.launches - n0
    h8, w8 = texp.test_size[0] // 8, texp.test_size[1] // 8
    print(f"unicorn_track_tiny_mask frame (forward_whole, then "
          f"forward_mask_branch on the FPN maps): mask features "
          f"{tuple(feats.shape)}, up-mask {tuple(up_mask.shape)}, "
          f"controllers {tuple(raw[0]['ctrl'].shape)}; dw7x7 launches {n_u}")
    assert tuple(feats.shape) == (1, 8, h8, w8), feats.shape
    assert tuple(up_mask.shape) == (1, 9 * texp.up_rate ** 2, h8, w8)
    assert tuple(raw[0]["ctrl"].shape) == (1, 169, h8, w8)
    assert n_u == 27 + 18, n_u      # forward_whole, then the trunk again
    for t in (feats, up_mask, raw[0]["ctrl"], feat_s16):
        assert bool(torch.isfinite(t.float()).all())


# ------------------------------------------------------------------ VOS
VOS_FRAME_HW = (480, 854)  # DAVIS 480p: letterboxed into 800x1280 at r ~ 1.50
VOS_OBJECTS = 4           # objects at initialize; one more enters later
VOS_WARMUP = 3
VOS_SHARED = 16           # timed track calls on the shared-reference path
VOS_GENERAL = 8           # timed track calls on the general path
VOS_K_WIDE = 17           # label maps of the frames that need two groups


def _served_model(report, key, exp_cls):
    """A served Unicorn (bf16 trunk and head, bf16 interaction) of exp_cls
    on the card, seeded random weights, with the obj/cls prediction biases
    of both branches raised by 6 as _model raises them, so that the NMS
    keeps detections over conf_thre and the trackers' thresholds; built
    once under report[key]."""
    import torch

    if key not in report:
        exp = exp_cls()
        model = exp.get_model(torch.Generator().manual_seed(0), serve=True)
        with torch.no_grad():
            for name, p in model.head.named_parameters():
                if name.startswith(("obj_preds", "cls_preds")) and \
                        name.endswith(".bias"):
                    p.add_(6.0)
        report[key] = (exp, model.to(DEVICE).eval())
    return report[key]


def _vos_model(report):
    """The served unicorn_track_tiny_mask Unicorn (ConvNeXt-Tiny, the
    CondInst controllers and mask branch, RAFT up-mask at rate 4), biases
    raised, so that every slot keeps detections over conf_thre."""
    from unicorn_torch.exp.unicorn_track_tiny_mask import Exp

    return _served_model(report, "vos_model", Exp)


def _vos_masks(ids, hw=None):
    """An (H, W) label mask of rectangles, one per id, on a grid of cells."""
    import numpy as np

    fh, fw = hw or VOS_FRAME_HW
    cols = int(np.ceil(np.sqrt(len(ids) * fw / fh)))
    rows = -(-len(ids) // cols)
    ch, cw = fh // rows, fw // cols
    m = np.zeros((fh, fw), np.uint8)
    for n, oid in enumerate(ids):
        r, c = divmod(n, cols)
        m[r * ch + ch // 6:(r + 1) * ch - ch // 6,
          c * cw + cw // 6:(c + 1) * cw - cw // 6] = oid
    return m


def _vos_driver(report, K):
    from unicorn_torch.drivers.vos import VOSDriver

    exp, model = _vos_model(report)
    return exp, VOSDriver(model, input_size=exp.test_size, max_objects=K,
                          use_raft=exp.use_raft, up_rate=exp.up_rate,
                          device=DEVICE)


def _vos_stages(driver, f, shared, head_loop=None):
    """One frame of the shared or the general path, its stages synchronised
    apart -> ms per stage. head_loop: a list that receives the ms of the
    head run as K batch-1 calls on the same priors (not part of the
    path)."""
    import torch

    K = driver.K
    t = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        t.append(time.perf_counter())

    img, r = driver.preprocess(f)
    lap()
    fpn_outs, feat_cur = driver.backbone(img)
    lap()
    if shared:
        emb = driver.embed(driver.feat_ref1, feat_cur)
        lbs = driver.lbs_ref.reshape(1, K, -1)
    else:
        emb = driver.embed(driver.feat_ref, feat_cur.expand(K, -1, -1, -1))
        lbs = driver.lbs_ref
    lap()
    priors = driver.propagate(*emb, lbs)
    lap()
    flat, dets, valid, idx = driver.head(fpn_outs, priors)
    lap()
    masks = driver.mask_decode(fpn_outs, flat, idx)
    lap()
    driver.postprocess_masks_host(dets, valid, masks, r)
    lap()
    if head_loop is not None:
        t0 = time.perf_counter()
        for k in range(K):
            driver.head(fpn_outs, priors[k:k + 1])
        torch.cuda.synchronize()
        head_loop.append((time.perf_counter() - t0) * 1e3)
    names = ("letterbox", "backbone", "interaction+upsample", "correlation",
             f"head over {K} slots", "mask decode", "aggregation+fetch")
    return {n: (t[k + 1] - t[k]) * 1e3 for k, n in enumerate(names)}


def phase_vos(report):
    """VOS serving on the served unicorn_track_tiny_mask model, 480x854
    uint8 frames (DAVIS 480p) letterboxed into 800x1280.

    (1) Kernel against plain: one general-path frame at K = 4 (three
    objects at initialize, one entering on the next frame) through the
    dw7x7, MSDA and correlation kernels and through their plain versions
    (the three wrappers patched out). Tolerances, those of phases sot_model
    and inst: the embeddings of both sides within 5% of their largest
    magnitude; the priors (averages of labels in [0, 1]) within 0.05 and
    within 2% of the largest prior; each slot's top score within 0.05 (a maximum over anchors,
    so it moves no more than the scores, as phase model bounds them); at
    the kernel run's top anchor of each slot, the plain run's box within
    5% of the box's larger side + 2 px (a 5%-of-|max| move of the
    regression logits, through exp) and its mask probabilities within
    0.05 (phase inst's bound); every slot keeps a detection in both runs.
    (2) initialize with VOS_OBJECTS objects, VOS_WARMUP + VOS_SHARED track
    calls on the shared-reference path; add_objects with one more object,
    VOS_GENERAL track calls on the general path; frames/s, per-stage ms,
    the head as K batch-1 calls beside the batched one, launches of each
    kernel a frame, peak memory with one frame's outputs held. (3) One
    shared-path frame at K = 17 (the correlation in two groups of label
    maps) and one general-path frame at K = 17 (MSDA at batch 17): shapes,
    finite values, launches."""
    import numpy as np
    import torch

    from unicorn_torch.models.heads import decode_boxes
    from unicorn_torch.ops import correlation_kernel as ck

    frames = _sot_frames(VOS_WARMUP + VOS_SHARED + VOS_GENERAL + 2, seed=6,
                         hw=VOS_FRAME_HW)
    fh, fw = VOS_FRAME_HW

    # (1) one general-path frame, kernels against plain versions
    exp, drv = _vos_driver(report, 4)
    H, W = exp.test_size
    drv.initialize(frames[0], _vos_masks([1, 2, 3]))
    entry = _vos_masks([1, 2, 3, 4])
    drv.add_objects(frames[1], entry * (entry == 4))
    assert not drv.shared_ref and drv.obj_ids == [1, 2, 3, 4]
    img, _ = drv.preprocess(frames[2])

    def one():
        fpn_outs, feat_cur = drv.backbone(img)
        emb = drv.embed(drv.feat_ref, feat_cur.expand(4, -1, -1, -1))
        priors = drv.propagate(*emb, drv.lbs_ref)
        flat, dets, valid, idx = drv.head(fpn_outs, priors)
        torch.cuda.synchronize()
        return fpn_outs, priors, flat, dets, valid, idx, emb

    _reset_kernel_counts()
    out_k = one()
    counts = _kernel_counts()
    with _plain_serving_kernels():
        out_p = one()
        # the masks of the kernel run's top anchors, from each run's
        # controllers (the mask branch runs the trunk's maps, no kernel)
        masks_k = drv.mask_decode(out_k[0], out_k[2], out_k[5])
        masks_p = drv.mask_decode(out_p[0], out_p[2], out_k[5])
        torch.cuda.synchronize()
    assert _kernel_counts() == counts, "a plain version launched a kernel"
    d_emb = max(((ek.float() - ep.float()).abs().max()
                 / ep.float().abs().max()).item()
                for ek, ep in zip(out_k[6], out_p[6]))
    d_prior = (out_k[1] - out_p[1]).abs().max().item()
    prior_tol = min(0.05, 0.02 * out_p[1].max().item())
    d_score = (out_k[3][:, 0, 4] * out_k[3][:, 0, 5]
               - out_p[3][:, 0, 4] * out_p[3][:, 0, 5]).abs().max().item()
    a = out_k[5][:, 0].long()
    rows = torch.arange(4, device=a.device)
    bk = decode_boxes(out_k[2]["reg_raw"], out_k[2]["hw"], (8, 16, 32))[
        rows, a]
    bp = decode_boxes(out_p[2]["reg_raw"], out_p[2]["hw"], (8, 16, 32))[
        rows, a]
    box_tol = 0.05 * bp[:, 2:].amax(1, keepdim=True) + 2.0
    box_bad = int(((bk - bp).abs() > box_tol).sum())
    d_box = (bk - bp).abs().max().item()
    d_mask = (masks_k - masks_p).abs().max().item()
    same_top = int((out_k[5][:, 0] == out_p[5][:, 0]).sum())
    kept = (int(out_k[4][:, 0].sum()), int(out_p[4][:, 0].sum()))
    assert tuple(out_k[1].shape) == (4, 1, H // 8, W // 8)
    assert tuple(masks_k.shape) == (4, H, W) and masks_k.dtype == torch.float32
    for t in (out_k[1], out_k[3], masks_k):
        assert bool(torch.isfinite(t).all())
    print(f"vos general-path frame {H}x{W}, K = 4, kernel vs plain: "
          f"embeddings max |d| / max|plain| {d_emb:.3e} (tol 0.05), priors "
          f"max |d| {d_prior:.3e} (tol {prior_tol:.3e}; priors in "
          f"[{out_k[1].min().item():.3f}, {out_k[1].max().item():.3f}]), top "
          f"score max |d| {d_score:.3e} (tol 0.05), top-anchor box max |d| "
          f"{d_box:.3f} px ({box_bad} coordinates beyond 5% of the larger "
          f"side + 2 px), masks max |d| {d_mask:.3e} (tol 0.05); top "
          f"anchors agree in {same_top} of 4 slots; slots with a detection "
          f"{kept}; launches {counts}")
    assert counts == dict(dwconv7x7=27, msda_factored=1, msda_direct=0,
                          correlation=1), counts
    assert d_emb <= 0.05 and d_prior <= prior_tol
    assert d_score <= 0.05 and box_bad == 0
    assert d_mask <= 0.05 and kept == (4, 4)
    del out_k, out_p, masks_k, masks_p, drv

    # (2) the timed run: shared path, then the general path after an entry
    K = VOS_OBJECTS + 1
    _, drv = _vos_driver(report, K)
    ids0 = list(range(1, VOS_OBJECTS + 1))
    mask0 = _vos_masks(ids0)
    mask_new = _vos_masks(ids0 + [K])
    mask_new = mask_new * (mask_new == K)
    drv.initialize(frames[0], mask0)
    for f in frames[1:1 + VOS_WARMUP]:
        drv.track(f)
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    n0 = 1 + VOS_WARMUP + VOS_SHARED
    shared_frames = frames[1 + VOS_WARMUP:n0]
    general_frames = frames[n0 + 1:n0 + 1 + VOS_GENERAL]
    res = {}
    for path, fr in (("shared", shared_frames), ("general", general_frames)):
        if path == "general":
            drv.add_objects(frames[n0], mask_new)
            assert not drv.shared_ref and len(drv.obj_ids) == K
            drv.track(frames[n0])   # the entry frame (GT overlay), not timed
            torch.cuda.synchronize()
        labels = []
        _reset_kernel_counts()
        t0 = time.perf_counter()
        for f in fr:
            out, _ = drv.track(f)       # one frame's outputs held at a time
            labels.append(np.bincount(out.ravel(), minlength=K + 1))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernel_counts()
        res[path] = dict(fps=len(fr) / wall, counts=counts, n=len(fr),
                         labels=np.stack(labels))
        print(f"vos {path} path: track x {len(fr)}, {fh}x{fw} -> "
              f"{exp.test_size} (r {drv.scale:.4f}), K = {K} slots, "
              f"{len(drv.obj_ids)} objects: {len(fr) / wall:.2f} frames/s "
              f"({wall / len(fr) * 1e3:.2f} ms/frame); launches {counts} "
              f"({ {k: v / len(fr) for k, v in counts.items()} } a frame)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"vos peak memory {peak:.2f} GiB over both timed loops ("
          f"{resident:.2f} GiB held before the first timed frame: the "
          f"models of this and earlier phases and the driver's state)")
    report["vos_fps"] = {p: r["fps"] for p, r in res.items()}

    # per-stage times, each path again, synchronised apart
    head_loop = {"general": [], "shared": []}
    stage_ms = {"general": [_vos_stages(drv, f, False, head_loop["general"])
                            for f in general_frames]}
    drv.initialize(frames[0], mask0)
    stage_ms["shared"] = [_vos_stages(drv, f, True, head_loop["shared"])
                          for f in shared_frames]
    for path in ("shared", "general"):
        med = {k: np.median([s[k] for s in stage_ms[path]])
               for k in stage_ms[path][0]}
        print(f"vos {path} per-stage ms (median of {len(stage_ms[path])}, "
              "synchronised): " + ", ".join(f"{k} {v:.3f}"
                                            for k, v in med.items())
              + f"; the head as {drv.K} batch-1 calls instead: "
              f"{np.median(head_loop[path]):.3f}")

    ker = report.setdefault("kernels", {})
    for name in ("dwconv7x7", "msda_factored", "correlation"):
        k = ker.setdefault(name, {})
        by_path = k.setdefault("launches_by_path", {})
        for path, r in res.items():
            by_path[f"vos_{path}"] = r["counts"][name]
            k["launches"] = (k.get("launches") or 0) + r["counts"][name]
    for path, r in res.items():
        n = r["n"]
        assert r["counts"] == dict(dwconv7x7=27 * n, msda_factored=n,
                                   msda_direct=0, correlation=n), r["counts"]
        # every frame labels pixels of at least one object; no label beyond
        # the slots in use
        lab = r["labels"]
        assert (lab[:, 1:].sum(1) > 0).all(), f"{path}: no object labelled"
    assert res["shared"]["labels"][:, K:].sum() == 0

    # (3) K = 17: the correlation in two groups, then MSDA at batch 17
    del drv
    ids = list(range(1, VOS_K_WIDE + 1))
    _, drv = _vos_driver(report, VOS_K_WIDE)
    drv.initialize(frames[0], _vos_masks(ids))
    _reset_kernel_counts()
    out_s, boxes_s = drv.track(frames[1])
    counts_s = _kernel_counts()
    drv.initialize(frames[0], _vos_masks(ids[:-1]))
    wide = _vos_masks(ids)
    drv.add_objects(frames[1], wide * (wide == ids[-1]))
    img, r = drv.preprocess(frames[2])
    _reset_kernel_counts()
    dets, valid, masks = drv.track_fn(img)
    torch.cuda.synchronize()
    counts_g = _kernel_counts()
    out_g, boxes_g = drv.postprocess_masks_host(dets, valid, masks, r)
    groups = -(-VOS_K_WIDE // ck.K_MAX)
    print(f"vos K = {VOS_K_WIDE}: shared-path frame launches {counts_s} "
          f"(correlation in {groups} groups of label maps), objects with a "
          f"box {len(boxes_s)}, labels {sorted(np.unique(out_s).tolist())}; "
          f"general-path frame (MSDA at batch {VOS_K_WIDE}) launches "
          f"{counts_g}, dets {tuple(dets.shape)}, masks {tuple(masks.shape)}"
          f", objects with a box {len(boxes_g)}")
    assert counts_s == dict(dwconv7x7=27, msda_factored=1, msda_direct=0,
                            correlation=groups), counts_s
    assert counts_g == dict(dwconv7x7=27, msda_factored=1, msda_direct=0,
                            correlation=1), counts_g
    assert tuple(dets.shape) == (VOS_K_WIDE, 8, 7)
    assert tuple(masks.shape) == (VOS_K_WIDE, H, W)
    assert bool(torch.isfinite(dets).all() & torch.isfinite(masks).all())
    assert out_s.shape == out_g.shape == (fh, fw)
    assert len(boxes_s) == len(boxes_g) == VOS_K_WIDE
    report.pop("vos_model")


# ---------------------------------------------------------------- omni
OMNI_WARMUP = 3           # update calls before each model's timed QDTrack run
OMNI_QD = 16              # timed update calls of each QDTrack run
OMNI_DEEPSORT = 8         # timed update calls of each DeepSORT run
OMNI_MOTS_HW = (720, 1280)  # BDD100K seg_track frames (MOT17's: FRAME_HW)


def _omni_driver(report, with_mask, tracker="qd", **kw):
    """MOTOmniDriver as tools/track_omni.py builds it (the exp's test
    size, classes, test_conf and nmsthre; max_out 128; use_raft left at
    its default, False) on the served unicorn_track_tiny model or, with
    with_mask, the served unicorn_track_tiny_mask model."""
    from unicorn_torch.drivers.mot import MOTOmniDriver
    from unicorn_torch.exp.unicorn_track_tiny import Exp

    exp, model = (_vos_model(report) if with_mask else
                  _served_model(report, "omni_model", Exp))
    args = dict(num_classes=exp.num_classes, conf_thre=exp.test_conf,
                nms_thre=exp.nmsthre, max_out=128, with_mask=with_mask,
                tracker=tracker, device=DEVICE)
    return exp, MOTOmniDriver(model, exp.test_size, **{**args, **kw})


def _omni_stages(drv, f):
    """One update, its stages synchronised apart -> (ms per stage, bytes of
    the packed fetch, bytes of the mask fetch). The output is dropped, as a
    caller that holds one frame's output at a time drops it, so that the
    mask fetch reuses its page-locked block."""
    import torch

    t = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        t.append(time.perf_counter())

    img, r = drv.preprocess(f)
    lap()
    fpn_outs, feat_cur = drv.backbone(img)
    lap()
    raw = drv.head(fpn_outs)
    lap()
    flat, dets, valid, idx = drv.detect(raw)
    lap()
    prev = feat_cur if drv.feat_prev is None else drv.feat_prev
    embeds = drv.embed(prev, feat_cur, dets)
    lap()
    masks = drv.mask_decode(fpn_outs, flat, idx) if drv.with_mask else None
    lap()
    drv.feat_prev = feat_cur
    drv.frame_id += 1
    packed = drv.fetch(dets, valid, embeds)
    lap()
    _, rows = drv.associate(packed, r)
    lap()
    mask_bytes = 0
    if drv.with_mask:
        drv.fetch_masks(masks, rows)
        mask_bytes = len(rows) * masks[0].numel() * 4    # float32 rows
    lap()
    names = ("letterbox", "backbone", "head", "decode+nms",
             "interaction+upsample+sample", "mask decode", "fetch",
             "tracker", "mask fetch")
    return ({n: (t[k + 1] - t[k]) * 1e3 for k, n in enumerate(names)},
            packed.nbytes, mask_bytes)


def phase_omni(report):
    """The omni path (MOTOmniDriver): MOT and MOTS with QDTrack or DeepSORT
    association on the served models, 800x1280.

    (1) Kernel against plain: on the unicorn_track_tiny_mask model, one
    720x1280 frame after a first one (the same feat_prev) through the
    dw7x7 and MSDA kernels and through their plain versions (the wrappers
    patched out). Tolerances, phase vos's: the top score within 0.05; at
    the kernel run's top anchor the plain run's box within 5% of its larger
    side + 2 px and its mask within 0.05; the embeddings of both runs at
    the kernel run's boxes within 5% of their largest magnitude. The MSDA
    kernel must see bf16 values (the served interaction), once.
    (2) unicorn_track_tiny, 1080x1920 uint8 frames (MOT17's size; a panning
    texture): OMNI_WARMUP + OMNI_QD QDTrack updates, then OMNI_DEEPSORT
    DeepSORT updates; unicorn_track_tiny_mask with masks, 720x1280 frames
    (BDD100K seg_track's size): the same. Frames/s of the four runs,
    launches a frame (27 dw7x7, 1 MSDA, 0 correlation), peak memory; then
    every run again with its stages synchronised apart (medians) and the
    bytes fetched a frame. (3) DeepSORT with masks on one frame repeated
    (tracks confirm), then at conf_thre 1.0 (they coast with zero masks);
    one frame each way at conf_thre 1.0 on fresh drivers: the empty mask
    grid (0, H/4, W/4)."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.models import blocks, interaction
    from unicorn_torch.models.heads import decode_boxes
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw

    mots_frames = _sot_frames(OMNI_WARMUP + OMNI_QD + OMNI_DEEPSORT, seed=7,
                              hw=OMNI_MOTS_HW)
    mot_frames = _sot_frames(OMNI_WARMUP + OMNI_QD + OMNI_DEEPSORT, seed=8)

    # (1) one frame, kernels against plain versions, the same feat_prev
    exp, drv = _omni_driver(report, True)
    H, W = exp.test_size
    drv.update(mots_frames[0])
    img, _ = drv.preprocess(mots_frames[1])
    msda_dtypes = []
    msda = interaction.ms_deform_attn

    def recording(value, *a, **k):
        msda_dtypes.append(value.dtype)
        return msda(value, *a, **k)

    def one():
        fpn_outs, feat_cur = drv.backbone(img)
        flat, dets, valid, idx = drv.detect(drv.head(fpn_outs))
        torch.cuda.synchronize()
        return fpn_outs, feat_cur, flat, dets, valid, idx

    _reset_kernel_counts()
    with mock.patch.object(interaction, "ms_deform_attn", recording):
        out_k = one()
        emb_k = drv.embed(drv.feat_prev, out_k[1], out_k[3])
        masks_k = drv.mask_decode(out_k[0], out_k[2], out_k[5])
        torch.cuda.synchronize()
    counts = _kernel_counts()
    with mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain), \
            mock.patch.object(
                interaction, "ms_deform_attn",
                lambda v, l, a, method: da.ms_deform_attn_plain(
                    v, l, a, "factored")):
        out_p = one()
        # the plain run's embeddings and masks at the kernel run's boxes
        # and anchors
        emb_p = drv.embed(drv.feat_prev, out_p[1], out_k[3])
        masks_p = drv.mask_decode(out_p[0], out_p[2], out_k[5])
        torch.cuda.synchronize()
    assert _kernel_counts() == counts, "a plain version launched a kernel"
    n_valid = int(out_k[4].sum())
    d_emb = ((emb_k[:n_valid] - emb_p[:n_valid]).abs().max()
             / emb_p[:n_valid].abs().max()).item()
    d_score = abs((out_k[3][0, 0, 4] * out_k[3][0, 0, 5]
                   - out_p[3][0, 0, 4] * out_p[3][0, 0, 5]).item())
    a = out_k[5][0, 0].long()
    bk = decode_boxes(out_k[2]["reg_raw"], out_k[2]["hw"], (8, 16, 32))[0, a]
    bp = decode_boxes(out_p[2]["reg_raw"], out_p[2]["hw"], (8, 16, 32))[0, a]
    box_bad = int(((bk - bp).abs() > 0.05 * bp[2:].max() + 2.0).sum())
    d_box = (bk - bp).abs().max().item()
    d_mask = (masks_k[0].float() - masks_p[0].float()).abs().max().item()
    d_mask_all = (masks_k[:n_valid].float()
                  - masks_p[:n_valid].float()).abs().max().item()
    grid = (H // 4, W // 4)
    assert tuple(masks_k.shape) == (128,) + grid, masks_k.shape
    assert masks_k.dtype == torch.float16 and emb_k.dtype == torch.float32
    for t in (out_k[3], emb_k, masks_k):
        assert bool(torch.isfinite(t).all())
    print(f"omni frame {H}x{W} (unicorn_track_tiny_mask), kernel vs plain "
          f"from the same feat_prev: top score |d| {d_score:.3e} (tol "
          f"0.05), top-anchor box max |d| {d_box:.3f} px ({box_bad} "
          f"coordinates beyond 5% of the larger side + 2 px), embeddings "
          f"of the {n_valid} kept rows max |d| / max|plain| {d_emb:.3e} "
          f"(tol 0.05), top-anchor mask max |d| {d_mask:.3e} (tol 0.05; "
          f"all {n_valid} kept rows {d_mask_all:.3e}); top anchors "
          f"{'agree' if bool(out_k[5][0, 0] == out_p[5][0, 0]) else 'differ'}"
          f"; MSDA value dtypes {msda_dtypes}; launches {counts}")
    assert counts == dict(dwconv7x7=27, msda_factored=1, msda_direct=0,
                          correlation=0), counts
    assert msda_dtypes == [torch.bfloat16], msda_dtypes
    assert d_score <= 0.05 and box_bad == 0
    assert d_emb <= 0.05 and d_mask <= 0.05 and n_valid > 0
    del out_k, out_p, emb_k, emb_p, masks_k, masks_p, drv

    # (2) the four timed runs, then their stages
    runs = {}
    for with_mask, frames in ((False, mot_frames), (True, mots_frames)):
        exp, drv = _omni_driver(report, with_mask)
        for f in frames[:OMNI_WARMUP]:
            drv.update(f)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        timed = frames[OMNI_WARMUP:]
        for kind, fr in (("qd", timed[:OMNI_QD]),
                         ("deepsort",
                          timed[OMNI_QD:OMNI_QD + OMNI_DEEPSORT])):
            if kind == "deepsort":
                drv = _omni_driver(report, with_mask, "deepsort")[1]
            else:
                drv.reset()
            name = f"{'mots' if with_mask else 'mot'} {kind}"
            n_out = []
            _reset_kernel_counts()
            t0 = time.perf_counter()
            for f in fr:
                out = drv.update(f)     # one frame's outputs held at a time
                n_out.append(len(out[0]))
                assert all(np.isfinite(o).all() for o in out)
                if with_mask:
                    assert out[3].shape == (len(out[0]), H // 4, W // 4)
                    assert 0.0 <= out[3].min(initial=0.0) and \
                        out[3].max(initial=0.0) <= 1.0
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            table = len(drv.tracker.track_id if kind == "deepsort"
                        else drv.tracker.tracklets)
            runs[name] = dict(fps=len(fr) / wall, counts=_kernel_counts(),
                              n=len(fr), rows=n_out, frames=fr,
                              with_mask=with_mask, kind=kind, table=table)
            print(f"omni {name}: update x {len(fr)}, {fr[0].shape[0]}x"
                  f"{fr[0].shape[1]} -> {exp.test_size}: "
                  f"{len(fr) / wall:.2f} frames/s ({wall / len(fr) * 1e3:.2f}"
                  f" ms/frame); rows out a frame {n_out}; tracks in the "
                  f"tracker's table {table}; launches {runs[name]['counts']}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"omni {'mots' if with_mask else 'mot'} peak memory "
              f"{peak:.2f} GiB over its two timed runs ({resident:.2f} GiB "
              f"held before them: the models of this and earlier phases "
              f"and the driver's state); the path's own "
              f"{peak - resident:.2f} GiB")
    report["omni_fps"] = {k: r["fps"] for k, r in runs.items()}

    for name, r in runs.items():
        drv = _omni_driver(report, r["with_mask"], r["kind"])[1]
        staged = [_omni_stages(drv, f) for f in r["frames"]]
        med = {k: np.median([s[0][k] for s in staged]) for k in staged[0][0]}
        packed_b = staged[0][1]
        mask_b = [s[2] for s in staged]
        line = ", ".join(f"{k} {v:.3f}" for k, v in med.items()
                         if r["with_mask"] or k not in ("mask decode",
                                                        "mask fetch"))
        print(f"omni {name} per-stage ms (median of {len(staged)}, "
              f"synchronised): {line}; fetched a frame: {packed_b} B packed"
              + (f" + masks {int(np.median(mask_b))} B median (min "
                 f"{min(mask_b)}, max {max(mask_b)}), where JAX's fetch of "
                 f"all 128 rows in float16 is {128 * (H // 4) * (W // 4) * 2}"
                 " B"
                 if r["with_mask"] else ""))

    ker = report.setdefault("kernels", {})
    for kname in ("dwconv7x7", "msda_factored"):
        k = ker.setdefault(kname, {})
        by_path = k.setdefault("launches_by_path", {})
        for name, r in runs.items():
            by_path["omni_" + name.replace(" ", "_")] = r["counts"][kname]
            k["launches"] = (k.get("launches") or 0) + r["counts"][kname]
    for name, r in runs.items():
        n = r["n"]
        assert r["counts"] == dict(dwconv7x7=27 * n, msda_factored=n,
                                   msda_direct=0, correlation=0), \
            (name, r["counts"])
        # QDTrack starts a track for every row over init_score_thr; the
        # random-weight detections reshuffle among near-equal anchors as
        # the texture pans, so DeepSORT may confirm none (3 hits in a row)
        # but must hold tentative rows
        assert r["table"] > 0, f"omni {name}: the tracker holds no track"
        assert r["kind"] == "deepsort" or min(r["rows"]) > 0, name

    # (3) DeepSORT's lifecycle with masks on a still scene (the same frame
    # 4 times: the detections repeat, so tracks confirm on their third
    # hit), then a frame where no detection passes (conf_thre 1.0): the
    # confirmed tracks coast with zero masks; fresh drivers at conf_thre
    # 1.0 return the empty shapes with the mask grid
    grid = (H // 4, W // 4)
    _, drv = _omni_driver(report, True, "deepsort")
    for f in [mots_frames[0]] * 4:
        out = drv.update(f)
    rows = np.asarray(drv.tracker.last_det_indices)
    n_conf = len(out[0])
    drv.conf_thre = 1.0
    coast = drv.update(mots_frames[0])
    print(f"omni mots deepsort, one frame 4 times: {n_conf} confirmed "
          f"tracks, detection rows {int((rows >= 0).sum())}, masks "
          f"{out[3].shape} in [{out[3].min(initial=0):.3f}, "
          f"{out[3].max(initial=0):.3f}]; then at conf_thre 1.0: "
          f"{len(coast[0])} coasting tracks, masks {coast[3].shape}, "
          f"max {coast[3].max(initial=0):.3f}")
    assert n_conf > 0 and (rows >= 0).all() and out[3].shape[1:] == grid
    assert out[3].max() > 0
    assert len(coast[0]) == n_conf and not coast[3].any()
    assert drv.tracker.last_det_indices == [-1] * n_conf
    for kind in ("qd", "deepsort"):
        _, drv = _omni_driver(report, True, kind, conf_thre=1.0)
        out = drv.update(mots_frames[0])
        print(f"omni mots {kind} at conf_thre 1.0: shapes "
              f"{[o.shape for o in out]}")
        assert [o.shape for o in out] == [(0, 5), (0,), (0,), (0,) + grid]
    report.pop("vos_model")
    report.pop("omni_model")


# -------------------------------------------------------- training phases
TRAIN_B = 2               # image pairs per training batch
TRAIN_LABELS = 100        # padded gt slots per frame (the JAX exp's max_labels)
TRAIN_WARMUP = 2          # training steps before the timed ones
TRAIN_STEPS = 8           # timed steps, alternating an SOT and a MOT batch
TRAIN_REPEAT = 6          # further steps on one repeated SOT batch
TRAIN_ITERS_PER_EPOCH = 8  # so that the schedule's warm-up ends within the run
# kernel launches of one training step with mhs: the correlation runs for the
# main and for the mhs priors; dw7x7 18 trunk blocks (the 2B frames as one
# batch) + 9 head blocks for each of the two head calls; one interaction
TRAIN_LAUNCHES = dict(dwconv7x7=36, msda_factored=1, msda_direct=0,
                      correlation=0, correlation_fwd_lse=2,
                      correlation_bwd_i=2, correlation_bwd_j=2)


# a uni step's launches with set_dw_custom_vjp: each dw7x7 call's backward
# launches the dw7x7 kernel again (dx) and the filter-gradient kernel once
DW_VJP_LAUNCHES = dict(TRAIN_LAUNCHES, dwconv7x7=72, dw7x7_wgrad=72)


def _train_model(report):
    """The unicorn_track_tiny Unicorn as trained (bf16 trunk and head, fp32
    interaction and embeddings) on the card, seeded random weights."""
    import torch

    from unicorn_torch.exp.unicorn_track_tiny import Exp

    if "train_model" not in report:
        exp = Exp()
        model = exp.get_model(torch.Generator().manual_seed(0))
        report["train_model"] = (exp, model.to(DEVICE).train())
    return report["train_model"]


def _train_batch(exp, task: int, seed: int, n_obj: int, size=None):
    """One synthetic batch on the card from a numpy seed: images
    (B, 2, 3, H, W) float32 in [0, 255] (a random texture, the second frame
    shifted by 4 px) at `size` (H, W), else the exp's input size, targets
    (B, 2, M, 6) [cls, cx, cy, w, h, track id] with n_obj boxes that drift
    by a few px between the frames, task_ids (B,)."""
    import numpy as np
    import torch

    H, W = size or exp.input_size
    rng = np.random.RandomState(seed)
    base = (rng.rand(TRAIN_B, 3, H, W + 4) * 255).round().astype(np.float32)
    images = np.stack([base[..., :W], base[..., 4:]], 1)
    targets = np.zeros((TRAIN_B, 2, TRAIN_LABELS, 6), np.float32)
    for b in range(TRAIN_B):
        wh = rng.uniform(40, 240, (n_obj, 2))
        cxy = rng.uniform(0.15, 0.85, (n_obj, 2)) * [W, H]
        cls = rng.randint(0, exp.num_classes, n_obj) if task == 2 else 0
        for f in range(2):
            targets[b, f, :n_obj, 0] = cls
            targets[b, f, :n_obj, 1:3] = cxy + f * rng.uniform(-6, 6, (n_obj, 2))
            targets[b, f, :n_obj, 3:5] = wh * (1 + f * rng.uniform(
                -0.05, 0.05, (n_obj, 2)))
            targets[b, f, :n_obj, 5] = np.arange(1, n_obj + 1)
    return (torch.from_numpy(images).to(DEVICE),
            torch.from_numpy(targets).to(DEVICE),
            torch.full((TRAIN_B,), task, dtype=torch.int64, device=DEVICE))


def _all_counts():
    from unicorn_torch.ops import correlation_kernel as ck

    return dict(_kernel_counts(), **{f"correlation_{k}": n for k, n
                                     in ck.train_launches.items()})


def _reset_all_counts():
    from unicorn_torch.ops import correlation_kernel as ck

    _reset_kernel_counts()
    for k in ck.train_launches:
        ck.train_launches[k] = 0


def _uni_loss_kwargs(exp):
    """The arguments ExpTrack.get_train_step gives uni_loss_fn."""
    return dict(img_size=exp.input_size, mot_weight=float(exp.mot_weight)
                if exp.scale_all_mot else 1.0, bidirect=exp.bidirect,
                use_l1=exp.always_l1, num_classes=exp.num_classes,
                mhs=exp.mhs)


def _kernel_checkers(beyond, dw_differ):
    """(checked_dw, checked_msda, checked_corr): the dw7x7, MSDA and
    training-correlation wrappers, each launching its kernel (counted) and
    holding the output against its plain version on the same inputs (not
    counted), at the kernels phase's tolerances; a correlation call that
    needs a gradient also holds the backward kernels' gradients against
    autograd of the plain version. Each call appends (kernel, shape,
    outputs beyond tolerance) to `beyond`; dw_differ counts the dw7x7
    outputs unequal to plain, of all."""
    import torch

    from unicorn_torch.ops import correlation_kernel as ck
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw
    from unicorn_torch.ops.correlation import correlation_propagate

    def checked_dw(x, k, b):
        y = dw.dwconv7x7(x, k, b)
        with torch.no_grad():
            yp = dw.dwconv7x7_plain(x, k, b)
            if x.dtype == torch.bfloat16:
                nbad = dw_beyond_tolerance_bf16(x, k, b, y, yp)
            else:
                nbad = int(((y - yp).abs() > 1e-4).sum())
            dw_differ[0] += int((y != yp).sum())
            dw_differ[1] += y.numel()
        beyond.append(("dw7x7", tuple(x.shape), nbad))
        return y

    def checked_msda(v, l, a, method):
        y = da.ms_deform_attn(v, l, a, method)
        with torch.no_grad():
            yp = da.ms_deform_attn_plain(v, l, a, "factored")
            mag = da.ms_deform_attn_plain(v.float().abs(), l, a.float(),
                                          "direct")
            tol = v.shape[1] * l.shape[4] * 4 * 2.0 ** -24 * mag + 1e-7
            if v.dtype == torch.bfloat16:
                tol = tol + bf16_ulp(torch.maximum(y.float().abs(),
                                                   yp.float().abs()))
            nbad = int(((y.float() - yp.float()).abs() > tol).sum())
        beyond.append(("msda", tuple(v.shape), nbad))
        return y

    def checked_corr(e0, e1, v):
        y = ck.correlation_propagate_train(e0, e1, v)
        with torch.no_grad():
            yp = correlation_propagate(e0, e1, v)
            nbad = int(((y - yp).abs() > 1e-5 + 1e-4 * yp.abs()).sum())
        beyond.append(("correlation_train", tuple(v.shape), nbad))
        if y.requires_grad:
            inputs = [t.detach() for t in (e0, e1, v)]
            y.register_hook(lambda g: check_corr_grads(inputs, g))
        return y

    def check_corr_grads(inputs, g):
        """The backward kernels' gradients of one call against autograd of
        the plain version, on the call's inputs and upstream gradient,
        within 1e-3 of each input's largest gradient (the kernels phase's
        bound of the Function against autograd); the launches of this
        recomputation are not counted."""
        launched = dict(ck.train_launches)
        with torch.enable_grad():
            leaves = [t.clone().requires_grad_() for t in inputs]
            gk = torch.autograd.grad(
                ck.correlation_propagate_train(*leaves), leaves, g)
            leaves = [t.clone().requires_grad_() for t in inputs]
            gp = torch.autograd.grad(correlation_propagate(*leaves), leaves,
                                     g)
        ck.train_launches.update(launched)
        nbad = sum(int(((a - b).abs() > 1e-3 * b.abs().max()).sum())
                   for a, b in zip(gk, gp))
        beyond.append(("correlation_train_grad", tuple(inputs[2].shape),
                       nbad))

    return checked_dw, checked_msda, checked_corr


def _kernels_vs_plain(run, corr_modules):
    """run() -> (total loss, loss dict, gradients) twice: once with every
    wrapper pointed at its plain version (dw7x7, MSDA, and the training
    correlation where each module of `corr_modules` imports it), recording
    the YOLOX loss's discrete choices, then through the kernels, replaying
    them, each dw7x7, MSDA and training-correlation forward checked against
    its plain version on the same inputs at the kernels phase's
    tolerances. The choices are SimOTA's assignment, the IoU term's
    corners (which box gives each side of the intersection) and overlap
    test, and the L1 term's signs. A few ulps in the head's bf16 outputs
    flip one for an anchor on its boundary, and the flip moves that
    anchor's gradient by the term's full size: an assignment changes a
    sample's fg count, an L1 sign of a trained regression (its residual
    near zero) can move its level's reg_preds gradient by as much as the
    leaf holds, and the trunk's through it. No kernel tolerance bounds a
    flip; the
    kernels' own choices that differ are printed. TF32 is off for every
    run. Returns (plain, kernels, beyond, dw_differ, counts): beyond lists
    (kernel, shape, outputs beyond tolerance) per call, dw_differ (dw7x7
    outputs unequal to plain, of all), counts the launches of the
    kernels' run."""
    from unittest import mock

    import torch

    from unicorn_torch.losses import det as det_mod
    from unicorn_torch.models import blocks, interaction
    from unicorn_torch.ops import deform_attn as da
    from unicorn_torch.ops import dwconv7x7 as dw
    from unicorn_torch.ops.correlation import correlation_propagate

    assigned, beyond = [], []
    dw_differ = [0, 0]
    simota = det_mod.simota_assign
    choices, fg = [], [None]
    flips = {"iou": [0, 0], "l1": [0, 0]}  # fg anchors / coordinates

    def record(*args, **kwargs):
        assigned.append(simota(*args, **kwargs))
        fg[0] = assigned[-1].fg_mask
        return assigned[-1]

    def replayed_simota(*args, **kwargs):
        out = next(replay)
        fg[0] = out.fg_mask
        return out

    def iou_choosing(pred, target, given=None):
        """det.iou_elementwise_cxcywh through the corner and overlap
        choices `given`, else its own -> (IoU, its own choices)."""
        p_tl = pred[..., :2] - pred[..., 2:] / 2
        t_tl = target[..., :2] - target[..., 2:] / 2
        p_br = pred[..., :2] + pred[..., 2:] / 2
        t_br = target[..., :2] + target[..., 2:] / 2
        own_tl, own_br = p_tl >= t_tl, p_br <= t_br
        own_en = (torch.where(own_tl, p_tl, t_tl)
                  < torch.where(own_br, p_br, t_br)).all(-1)
        m_tl, m_br, en = given or (own_tl, own_br, own_en)
        tl = torch.where(m_tl, p_tl, t_tl)
        br = torch.where(m_br, p_br, t_br)
        area_p = pred[..., 2] * pred[..., 3]
        area_g = target[..., 2] * target[..., 3]
        area_i = (br - tl).prod(-1) * en
        return (area_i / (area_p + area_g - area_i + 1e-16),
                (own_tl, own_br, own_en))

    def record_iou(pred, target):
        iou, own = iou_choosing(pred, target)
        choices.append(own)
        return iou

    def replay_iou(pred, target):
        given = next(replay_choices)
        iou, own = iou_choosing(pred, target, given)
        differ = ((own[0] != given[0]).any(-1) | (own[1] != given[1]).any(-1)
                  | (own[2] != given[2])) & fg[0]
        flips["iou"][0] += int(differ.sum())
        flips["iou"][1] += int(fg[0].sum())
        return iou

    def record_l1(pred, target):
        d = pred - target
        choices.append(torch.sign(d.detach()))
        return d * choices[-1]

    def replay_l1(pred, target):
        d = pred - target
        sign = next(replay_choices)
        differ = (torch.sign(d.detach()) != sign) & fg[0][..., None]
        flips["l1"][0] += int(differ.sum())
        flips["l1"][1] += 4 * int(fg[0].sum())
        return d * sign

    checked_dw, checked_msda, checked_corr = _kernel_checkers(beyond,
                                                              dw_differ)

    def patched(dw_fn, msda_fn, corr_fn, simota_fn, iou_fn, l1_fn):
        return [mock.patch.object(blocks, "dwconv7x7", dw_fn),
                mock.patch.object(interaction, "ms_deform_attn", msda_fn),
                mock.patch.object(det_mod, "simota_assign", simota_fn),
                mock.patch.object(det_mod, "iou_elementwise_cxcywh", iou_fn),
                mock.patch.object(det_mod, "l1_elementwise", l1_fn)] + [
            mock.patch.object(m, "correlation_propagate_train", corr_fn)
            for m in corr_modules]

    def under(patches):
        with tf32_off(), contextlib.ExitStack() as stack:
            for ptc in patches:
                stack.enter_context(ptc)
            return run()

    _reset_all_counts()
    plain = under(patched(
        dw.dwconv7x7_plain,
        lambda v, l, a, method: da.ms_deform_attn_plain(v, l, a, "factored"),
        correlation_propagate, record, record_iou, record_l1))
    assert all(n == 0 for n in _all_counts().values()), \
        "a plain version launched a kernel"
    replay, replay_choices = iter(assigned), iter(choices)
    kernels = under(patched(checked_dw, checked_msda, checked_corr,
                            replayed_simota, replay_iou, replay_l1))
    counts = _all_counts()
    assert next(replay, None) is None, "the runs made other assignments"
    assert next(replay_choices, None) is None, "the runs made other choices"
    print("  the kernels' run's own choices that differ from the plain "
          "run's, replayed: IoU corners or overlap at "
          f"{flips['iou'][0]} of {flips['iou'][1]} fg anchors, L1 signs at "
          f"{flips['l1'][0]} of {flips['l1'][1]} fg coordinates")
    return plain, kernels, beyond, dw_differ, counts


def _grad_shares(grads_p, grads_k, names=None):
    """Each gradient leaf's largest difference as a share of its largest
    magnitude -> (shares, worst name, median share)."""
    import numpy as np
    import torch

    shares = {}
    for name, gp in grads_p.items():
        if names is not None and name not in names:
            continue
        gk = grads_k[name]
        assert bool(torch.isfinite(gk).all()), name
        shares[name] = ((gk - gp).abs().max()
                        / gp.abs().max().clamp_min(1e-30)).item()
    worst = max(shares, key=shares.get)
    return shares, worst, float(np.median(list(shares.values())))


def _loss_and_grads(model, loss):
    """loss() -> (total, loss dict) forward + backward on model -> (total,
    {name: value}, {name: gradient} of the tensors that require one)."""
    import torch

    model.zero_grad(set_to_none=True)
    total, loss_dict = loss()
    total.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return total.item(), {k: v.item() for k, v in loss_dict.items()}, grads


def phase_train_model(report):
    """One uni_loss_fn forward + backward of the full-width model on one
    mixed batch (an SOT and a MOT sample) with every wrapper pointed at its
    plain version, then through the kernels (`_kernels_vs_plain`: each
    dw7x7, MSDA and correlation call against its plain version, at the
    plain run's SimOTA assignment). Compared: the total loss and the
    gradient of every parameter, each leaf's largest difference as a share
    of that leaf's largest magnitude. The kernels' run without the plain
    run's assignment is printed beside. Bounds, set before the first run:
    the bf16 trunk turns the kernels' one-ulp differences into about 1e-2
    of a gradient leaf, so the worst leaf may reach 0.1 and the loss 0.02
    of its value; the median leaf stays under 0.02. TF32 is off for every
    run: with it the fp32 plain dw7x7 is no reference (worst leaf 0.15,
    median 0.04)."""
    import numpy as np

    from unicorn_torch.core.train_step import uni_loss_fn
    from unicorn_torch.losses import uni as uni_mod

    exp, model = _train_model(report)
    images, targets, task_ids = _train_batch(exp, 2, seed=10, n_obj=8)
    task_ids[0] = 1
    kw = _uni_loss_kwargs(exp)

    def run():
        return _loss_and_grads(model, lambda: uni_loss_fn(
            model, images, targets, task_ids, **kw))

    ((loss_p, dict_p, grads_p), (loss_k, dict_k, grads_k), beyond,
     dw_differ, counts) = _kernels_vs_plain(run, (uni_mod,))
    with tf32_off():
        loss_free, dict_free, _ = run()

    shares, worst, median = _grad_shares(grads_p, grads_k)
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    nbad = sum(n for _, _, n in beyond)
    H, W = exp.input_size
    print(f"train model {H}x{W}, B={TRAIN_B} pairs, bf16 trunk + fp32 "
          f"interaction, kernels vs plain at the plain run's SimOTA "
          f"assignment: total_loss {loss_k:.5f} vs {loss_p:.5f} (rel "
          f"{d_loss:.2e}, bound 0.02); {len(shares)} gradient leaves, worst "
          f"{shares[worst]:.3e} of its max at {worst} (bound 0.1), median "
          f"{median:.3e} (bound 0.02); {len(beyond)} dw7x7 / MSDA / "
          f"correlation calls against their plain versions, {nbad} elements "
          f"beyond tolerance (dw7x7: {dw_differ[0]} of {dw_differ[1]} "
          f"outputs differ from the plain version at all); launches {counts}")
    print(f"  kernels' run with its own assignment: total_loss "
          f"{loss_free:.5f} (rel {abs(loss_free - loss_p) / abs(loss_p):.2e}"
          f"), fg per sample {dict_free.get('num_fg_sot')} / "
          f"{dict_free.get('num_fg_mot')} against the plain run's "
          f"{dict_p.get('num_fg_sot')} / {dict_p.get('num_fg_mot')}")
    print("  loss dict (kernels): " + ", ".join(
        f"{k} {v:.4f}" for k, v in dict_k.items()))
    assert counts == TRAIN_LAUNCHES, counts
    assert nbad == 0, [b for b in beyond if b[2]]
    assert np.isfinite(loss_k) and d_loss <= 0.02
    assert shares[worst] <= 0.1 and median <= 0.02


def phase_train(report):
    """The training path: ExpTrack.get_train_step / get_optimizer on the
    card, AdamW with gradient accumulation over 2 micro-steps and EMA;
    TRAIN_WARMUP steps, then TRAIN_STEPS timed steps alternating an all-SOT
    and an all-MOT batch, then TRAIN_REPEAT steps on the SOT batch alone,
    then two steps with their stages synchronised apart."""
    import numpy as np
    import torch

    from unicorn_torch.core.train_state import TrainState
    from unicorn_torch.core.train_step import uni_loss_fn

    exp, model = _train_model(report)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    step = exp.get_train_step(TRAIN_B)
    batches = [_train_batch(exp, 1, seed=11, n_obj=1),
               _train_batch(exp, 2, seed=12, n_obj=12)]
    for t in range(TRAIN_WARMUP):
        step(state, *batches[t % 2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _reset_all_counts()
    t0 = time.perf_counter()
    dicts = [step(state, *batches[t % 2])[1] for t in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    H, W = exp.input_size
    print(f"train path: {TRAIN_STEPS} steps, B={TRAIN_B} pairs of {H}x{W}, "
          f"mhs, AdamW, grad_accum {state.tx.grad_accum}, EMA: "
          f"{wall / TRAIN_STEPS * 1e3:.1f} ms/step "
          f"({TRAIN_STEPS * TRAIN_B / wall:.2f} pairs/s); peak memory "
          f"{peak:.2f} GiB; launches {counts} = {TRAIN_STEPS} x "
          f"{TRAIN_LAUNCHES}; lr of the next update {state.lr():.3e}; TF32 "
          f"for fp32 convs {torch.backends.cudnn.allow_tf32}, for fp32 "
          f"matmuls {torch.backends.cuda.matmul.allow_tf32}")
    for t, d in enumerate(dicts):
        print(f"  step {t} ({'SOT' if t % 2 == 0 else 'MOT'}): " + ", ".join(
            f"{k} {v.item():.4f}" for k, v in d.items()))
    _record_launches(report, "train", counts)

    finite = all(bool(torch.isfinite(v).all()) for d in dicts
                 for v in d.values())

    rep = [step(state, *batches[0])[1]["total_loss"].item()
           for _ in range(TRAIN_REPEAT)]
    print(f"  {TRAIN_REPEAT} further steps on the SOT batch: total_loss "
          + " ".join(f"{v:.4f}" for v in rep))

    # the stages of a step, synchronised apart, over the two micro-steps of
    # one optimizer update; every parameter that got a gradient must move
    kw = _uni_loss_kwargs(exp)
    stages = {"forward+loss": [], "backward": [], "optimizer+ema": []}
    assert state.mini_step == 0
    names = [n for n, _ in state.model.named_parameters()]
    before = [p.detach().clone() for p in state.model.parameters()]
    ema_before = [p.detach().clone() for p in state.ema_model.parameters()]
    grad_norms = torch.zeros(len(names), device=DEVICE)
    for t in range(2):
        state.model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        ts = [time.perf_counter()]
        total, _ = uni_loss_fn(state.model, *batches[t % 2], **kw)
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        total.backward()
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        grad_norms += torch.stack([
            p.grad.float().abs().sum() if p.grad is not None
            else grad_norms.new_zeros(()) for p in state.model.parameters()])
        torch.cuda.synchronize()
        ts[-1] = time.perf_counter()
        state.apply_gradients()
        torch.cuda.synchronize()
        ts.append(time.perf_counter())
        for k, name in enumerate(stages):
            stages[name].append((ts[k + 1] - ts[k]) * 1e3)
    has_grad = (grad_norms > 0).tolist()
    stuck = [n for n, g, p, b in zip(names, has_grad,
                                     state.model.parameters(), before)
             if g and torch.equal(p, b)]
    ema_stuck = [n for n, g, p, b in zip(
        names, has_grad, state.ema_model.parameters(), ema_before)
        if g and torch.equal(p, b)]
    no_grad = [n for n, g in zip(names, has_grad) if not g]
    print(f"  one optimizer update: {sum(has_grad)} of {len(names)} "
          f"parameters got a gradient, {len(stuck)} of them did not move "
          f"(EMA: {len(ema_stuck)}); zero gradient (no fg anchor at that "
          f"level): {no_grad}")
    print("  per-stage ms (SOT step, MOT step; the MOT step runs the "
          "optimizer): " + ", ".join(
              f"{k} {v[0]:.1f} / {v[1]:.1f}" for k, v in stages.items()))
    report["train_ms_per_step"] = wall / TRAIN_STEPS * 1e3

    assert finite, "a loss is not finite"
    assert counts == {k: n * TRAIN_STEPS for k, n in TRAIN_LAUNCHES.items()}, \
        counts
    assert not stuck, f"parameters that did not move: {stuck[:8]}"
    assert not ema_stuck, f"EMA tensors that did not move: {ema_stuck[:8]}"
    assert np.isfinite(rep).all() and rep[-1] < rep[0], rep
    _train_dw_vjp(report, exp, state, step, batches)


def _train_dw_vjp(report, exp, state, step, batches):
    """The uni step with set_dw_custom_vjp on: every dw7x7 call's backward
    is dx on the dw7x7 kernel (flipped taps) and dW, db on dw7x7_wgrad.
    (a) One forward + backward on a mixed batch each way, TF32 off, leaf by
    leaf: the loss equal within 1e-6 of its value (the forward is the same),
    the worst leaf within 0.1 and the median within 0.02 of its largest
    magnitude (phase train_model's bounds: the bf16 trunk turns one-ulp
    differences of dx into about 1e-2 of a leaf); the shapes of the
    filter-gradient calls those of UNI_STEP_DW_SHAPES. (b) TRAIN_WARMUP +
    TRAIN_STEPS steps of the step each way, alternating the SOT and MOT
    batches, ms/step, PyTorch's TF32 settings; the launches a step: 72
    dw7x7 (36 forwards, 36 dx), 72 dw7x7_wgrad (36 calls), the rest as
    TRAIN_LAUNCHES."""
    import collections

    import numpy as np
    import torch

    from unicorn_torch.core.train_step import uni_loss_fn
    from unicorn_torch.ops import dwconv7x7 as dw

    model = state.model
    images, targets, task_ids = _train_batch(exp, 2, seed=13, n_obj=8)
    task_ids[0] = 1
    kw = _uni_loss_kwargs(exp)
    shapes = collections.Counter()
    wgrad = dw.dw7x7_wgrad_cuda

    def spy(x, dy):
        shapes[(tuple(x.shape), x.dtype)] += 1
        return wgrad(x, dy)

    def run():
        return _loss_and_grads(model, lambda: uni_loss_fn(
            model, images, targets, task_ids, **kw))

    with tf32_off():
        loss_d, _, grads_d = run()
        dw.set_dw_custom_vjp(True)
        dw.dw7x7_wgrad_cuda = spy
        try:
            loss_f, _, grads_f = run()
        finally:
            dw.set_dw_custom_vjp(False)
            dw.dw7x7_wgrad_cuda = wgrad
    shares, worst, median = _grad_shares(grads_d, grads_f)
    d_loss = abs(loss_f - loss_d) / abs(loss_d)
    dt = torch.bfloat16 if exp.bf16 else torch.float32
    want = collections.Counter({(s, dt): n for s, n in UNI_STEP_DW_SHAPES})
    print(f"train dw_custom_vjp: restructured against default backward, "
          f"TF32 off: total_loss {loss_f:.6f} vs {loss_d:.6f} (rel "
          f"{d_loss:.2e}, bound 1e-6); {len(shares)} gradient leaves, worst "
          f"{shares[worst]:.3e} of its max at {worst} (bound 0.1), median "
          f"{median:.3e} (bound 0.02); filter-gradient calls "
          f"{sum(shapes.values())} at {len(shapes)} shapes, as "
          f"UNI_STEP_DW_SHAPES: {shapes == want}")

    timed = {}
    for on in (False, True, True, False):     # in turns
        dw.set_dw_custom_vjp(on)
        try:
            for t in range(TRAIN_WARMUP):
                step(state, *batches[t % 2])
            torch.cuda.synchronize()
            _reset_all_counts()
            t0 = time.perf_counter()
            losses = [step(state, *batches[t % 2])[1]["total_loss"]
                      for t in range(TRAIN_STEPS)]
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
            counts = dict(_all_counts(), dw7x7_wgrad=dw.wgrad_launches)
        finally:
            dw.set_dw_custom_vjp(False)
        timed.setdefault(on, []).append(ms)
        assert all(bool(torch.isfinite(v)) for v in losses)
        per = {k: n // TRAIN_STEPS for k, n in counts.items()}
        want_per = DW_VJP_LAUNCHES if on else dict(TRAIN_LAUNCHES,
                                                   dw7x7_wgrad=0)
        if on:
            if "dw_vjp_counts" not in report:
                report["dw_vjp_counts"] = counts
                _record_launches(report, "train_dw_vjp", counts)
        print(f"  {TRAIN_STEPS} steps {'restructured' if on else 'default'}"
              f" backward: {ms:.1f} ms/step; launches a step {per}")
        assert per == want_per and all(
            n % TRAIN_STEPS == 0 for n in counts.values()), counts
    print(f"  ms/step default {' / '.join(f'{t:.1f}' for t in timed[False])}"
          f", restructured {' / '.join(f'{t:.1f}' for t in timed[True])}")
    report["train_dw_vjp_ms"] = {"default": timed[False],
                                 "restructured": timed[True]}
    assert shapes == want, shapes
    assert np.isfinite(loss_f) and d_loss <= 1e-6
    assert shares[worst] <= 0.1 and median <= 0.02


# ------------------------------------------------- mask-stage training
MASK_TRAIN_WARMUP = 2     # steps before the timed ones, in each phase
MASK_TRAIN_STEPS = 8      # timed steps
INST_TRAIN_LABELS = 120   # padded gt slots per image (ExpDet.max_labels)
INST_TRAIN_BOXES = 16     # boxes per image
MASK_TRAIN_ITERS_PER_EPOCH = 4  # so that the warm-up ends within the run
MOVED_CHECK_STEPS = 8     # untimed steps after the timed ones that watch
#                           the gradients (at the schedule's peak rate)
SMALL_BOXES = 4           # boxes of 10-30 px an image (inst) or a frame
#                           (VOS + MOTS), so that stride-8 anchors get slots
# kernel launches of one step. inst: 18 trunk + 9 head dw7x7 blocks.
# VOS + MOTS: 18 trunk blocks (the 2B frames as one batch), 9 for the VOS
# head at B*K and 9 for the MOTS head at B; one interaction; one
# correlation at K = 3 label maps, whose backward kernels run only when the
# embeddings train
INST_TRAIN_LAUNCHES = dict(dwconv7x7=27, msda_factored=0, msda_direct=0,
                           correlation=0, correlation_fwd_lse=0,
                           correlation_bwd_i=0, correlation_bwd_j=0)
MASK_TRAIN_LAUNCHES = dict(dwconv7x7=36, msda_factored=1, msda_direct=0,
                           correlation=0, correlation_fwd_lse=1,
                           correlation_bwd_i=0, correlation_bwd_j=0)
MASK_TRAIN_FULL_LAUNCHES = dict(MASK_TRAIN_LAUNCHES, correlation_bwd_i=1,
                                correlation_bwd_j=1)


def _mask_stage_model(report, key, exp_cls):
    """The training model of a mask-stage exp (bf16 trunk and head; the
    Unicorn's interaction and embeddings fp32) on the card, seeded random
    weights, built once under report[key]."""
    import torch

    if key not in report:
        exp = exp_cls()
        model = exp.get_model(torch.Generator().manual_seed(0))
        report[key] = (exp, model.to(DEVICE).train())
    return report[key]


def _inst_train_model(report):
    from unicorn_torch.exp.unicorn_inst_convnext_tiny_800x1280 import Exp

    return _mask_stage_model(report, "inst_train_model", Exp)


def _mask_train_model(report):
    from unicorn_torch.exp.unicorn_track_tiny_mask import Exp

    return _mask_stage_model(report, "mask_train_model", Exp)


def _ellipse_masks(boxes, d_rate, Hm, Wm):
    """Filled ellipses inscribed in boxes (..., 4) cxcywh at input scale ->
    (..., Hm, Wm) float32 masks at the d_rate grid (zero boxes: empty)."""
    import torch

    ys = (torch.arange(Hm, device=boxes.device) + 0.5) * d_rate
    xs = (torch.arange(Wm, device=boxes.device) + 0.5) * d_rate
    cx, cy, w, h = (t[..., None, None] for t in boxes.unbind(-1))
    inside = (((xs - cx) / (w / 2).clamp_min(1e-6)) ** 2
              + ((ys[:, None] - cy) / (h / 2).clamp_min(1e-6)) ** 2) <= 1.0
    return inside.float()


def _inst_train_batch(exp, seed: int):
    """images (B, 3, H, W) float32 in [0, 255] (a random texture), labels
    (B, 120, 5) with INST_TRAIN_BOXES boxes of random classes an image
    (SMALL_BOXES of them 10-30 px on a side), masks (B, 120, H / 4, W / 4) float32: ellipses inside the boxes."""
    import numpy as np
    import torch

    H, W = exp.input_size
    rng = np.random.RandomState(seed)
    images = (rng.rand(TRAIN_B, 3, H, W) * 255).round().astype(np.float32)
    labels = np.zeros((TRAIN_B, INST_TRAIN_LABELS, 5), np.float32)
    n = INST_TRAIN_BOXES
    labels[:, :n, 0] = rng.randint(0, exp.num_classes, (TRAIN_B, n))
    labels[:, :n, 1:3] = rng.uniform(0.15, 0.85, (TRAIN_B, n, 2)) * [W, H]
    labels[:, :n, 3:5] = rng.uniform(0.05, 0.3, (TRAIN_B, n, 2)) * [W, H]
    labels[:, :SMALL_BOXES, 3:5] = rng.uniform(10, 30, (TRAIN_B, SMALL_BOXES,
                                                        2))
    labels = torch.from_numpy(labels).to(DEVICE)
    masks = _ellipse_masks(labels[..., 1:5], exp.d_rate, H // exp.d_rate,
                           W // exp.d_rate)
    return torch.from_numpy(images).to(DEVICE), labels, masks


def _mask_train_batch(exp, seed: int):
    """One VOS and one MOTS pair (task ids 1, 2) as UniMaskLoader yields
    them: images (B, 2, 3, H, W) float32 (a random texture, the second
    frame shifted by 4 px), targets (B, 2, 100, 6) with 8-12 instances a
    frame whose track ids carry across the pair (one leaves, one enters;
    SMALL_BOXES in both frames 10-30 px on a side), masks (B, 2, 100, H / d_rate, W / d_rate) float32 ellipses inside the
    boxes."""
    import numpy as np
    import torch

    H, W = exp.input_size
    rng = np.random.RandomState(seed)
    base = (rng.rand(TRAIN_B, 3, H, W + 4) * 255).round().astype(np.float32)
    images = np.stack([base[..., :W], base[..., 4:]], 1)
    targets = np.zeros((TRAIN_B, 2, TRAIN_LABELS, 6), np.float32)
    for b in range(TRAIN_B):
        n = rng.randint(8, 12)
        wh = rng.uniform(0.03, 0.19, (n + 1, 2)) * [W, H]
        wh[1:1 + SMALL_BOXES] = rng.uniform(10, 30, (SMALL_BOXES, 2))
        cxy = rng.uniform(0.15, 0.85, (n + 1, 2)) * [W, H]
        cls = rng.randint(0, exp.num_classes, n + 1) if b else np.zeros(n + 1)
        for f, rows in enumerate((np.arange(n), np.arange(1, n + 1))):
            targets[b, f, :n, 0] = cls[rows]
            targets[b, f, :n, 1:3] = cxy[rows] + f * rng.uniform(-6, 6, (n, 2))
            targets[b, f, :n, 3:5] = wh[rows]
            targets[b, f, :n, 5] = rows + 1
    targets = torch.from_numpy(targets).to(DEVICE)
    masks = _ellipse_masks(targets[..., 1:5], exp.d_rate, H // exp.d_rate,
                           W // exp.d_rate)
    return (torch.from_numpy(images).to(DEVICE), targets,
            torch.tensor([1, 2], device=DEVICE), masks)


def _record_launches(report, path, counts):
    """Add a path's launch counts to the kernels JSON (by path and in
    all)."""
    ker = report.setdefault("kernels", {})
    for name, n in counts.items():
        if n:
            k = ker.setdefault(name, {})
            k.setdefault("launches_by_path", {})[path] = n
            k["launches"] = (k.get("launches") or 0) + n


def _timed_steps(step, state, batches, launches, label, unit, steps=None):
    """MASK_TRAIN_WARMUP steps, then `steps` (MASK_TRAIN_STEPS) timed ones
    over the batches in turn: prints ms/step, units/s, peak memory and the
    launches; returns (loss dicts, counts, ms/step)."""
    import torch

    steps = steps or MASK_TRAIN_STEPS
    for t in range(MASK_TRAIN_WARMUP):
        step(state, *batches[t % len(batches)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    dicts = [step(state, *batches[t % len(batches)])[1]
             for t in range(steps)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = wall / steps * 1e3
    print(f"{label}: {steps} steps, {ms:.1f} ms/step "
          f"({steps * TRAIN_B / wall:.2f} {unit}/s); peak memory "
          f"{peak:.2f} GiB; launches {counts} = {steps} x "
          f"{launches}; lr of the next update {state.lr():.3e}")
    print("  last step: " + ", ".join(f"{k} {v.item():.4f}"
                                      for k, v in dicts[-1].items()))
    assert all(bool(torch.isfinite(v).all()) for d in dicts
               for v in d.values()), "a loss is not finite"
    assert counts == {k: n * steps for k, n in launches.items()}, counts
    return dicts, counts, ms


def _frozen_unchanged(model, frozen):
    """Assert that every tensor of `frozen` ({name: snapshot}) is
    bit-identical to the model's."""
    import torch

    names = dict(model.named_parameters())
    changed = [n for n, t in frozen.items() if not torch.equal(names[n], t)]
    assert not changed, f"frozen tensors that moved: {changed[:8]}"


def _below_spacing(state, p):
    """True where the update rule is SGD and its step on p, the rate times
    (1 + momentum) times the momentum buffer, stays under fp32's spacing
    at p in every element: such a tensor may round back to itself."""
    import torch

    buf = state.optimizer.state[p].get("momentum_buffer")
    if state.tx.kind != "sgd" or buf is None:
        return False
    spacing = torch.minimum(torch.nextafter(p, p.new_tensor(float("inf"))) - p,
                            p - torch.nextafter(p, p.new_tensor(-float("inf"))))
    step = state.lr() * (1.0 + state.tx.momentum) * buf.abs()
    return bool((step < spacing).all())


def _moved_check(step, state, batches, frozen):
    """MOVED_CHECK_STEPS more steps of the path with a hook on every
    trainable tensor that records whether its gradient held a nonzero
    element. Then: every frozen tensor is bit-identical to `frozen`; every
    trainable tensor had a nonzero gradient (the batches' small boxes give
    the stride-8 level slots, so the level-0 controllers train too) and a
    nonzero first moment in the optimizer's state (SGD's momentum buffer,
    AdamW's exp_avg); and every one moved, save under SGD a tensor whose
    step stays under fp32's spacing (`_below_spacing`: at SGD's small
    rates the mask branch's GroupNorm scales, at 1.0, move by less than
    half an ulp a step; AdamW's step is about the rate whatever the
    gradient)."""
    import torch

    named = {n: p for n, p in state.model.named_parameters()
             if p.requires_grad}
    start = {n: p.detach().clone() for n, p in named.items()}
    nonzero = {n: torch.zeros((), dtype=torch.bool, device=p.device)
               for n, p in named.items()}

    def watch(name):
        def hook(g):
            nonzero[name].logical_or_(g.ne(0).any())
        return hook

    handles = [p.register_hook(watch(n)) for n, p in named.items()]
    try:
        for t in range(MOVED_CHECK_STEPS):
            step(state, *batches[t % len(batches)])
    finally:
        for h in handles:
            h.remove()
    silent = [n for n, v in nonzero.items() if not bool(v)]
    stateless = [n for n, p in named.items() if not bool(
        state.optimizer.state[p].get(
            "momentum_buffer", state.optimizer.state[p].get("exp_avg",
                                                             p.new_zeros(())))
        .ne(0).any())]
    unmoved = [n for n, t in start.items() if torch.equal(named[n], t)]
    fine = [n for n in unmoved if _below_spacing(state, named[n])]
    stuck = [n for n in unmoved if n not in fine]
    _frozen_unchanged(state.model, frozen)
    print(f"  {len(frozen)} frozen tensors bit-identical; {len(start)} "
          f"trainable tensors over {MOVED_CHECK_STEPS} more steps: without a "
          f"gradient {silent}, without optimizer state {stateless}, unmoved "
          f"with a step under fp32's spacing {fine}, unmoved otherwise "
          f"{stuck}")
    assert not silent, f"trainable tensors without a gradient: {silent}"
    assert not stateless, f"trainable tensors the optimizer skipped: " \
        f"{stateless}"
    assert not stuck, f"tensors that did not move: {stuck}"


def _frozen_params(model):
    """{name: snapshot} of the parameters that do not require a gradient."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if not p.requires_grad}


def _kernel_check_report(what, plain, kernels, beyond, dw_differ, counts,
                         expected, names=None, leaf_bounds=(0.1, 0.02)):
    """Print and assert a `_kernels_vs_plain` comparison: the total loss
    within 0.02 of its value, each other loss term within 0.02 of its value
    plus 1e-3, the worst gradient leaf (of `names`, else all) and the
    median leaf, each as a share of the leaf's largest magnitude, within
    `leaf_bounds` (phase train_model's 0.1 / 0.02 for leaves behind the
    bf16 trunk and head; None: printed, not bounded); no kernel output
    beyond tolerance; the launches as `expected`."""
    import numpy as np

    (loss_p, dict_p, grads_p), (loss_k, dict_k, grads_k) = plain, kernels
    shares, worst, median = _grad_shares(grads_p, grads_k, names)
    d_loss = abs(loss_k - loss_p) / abs(loss_p)
    d_terms = {k: abs(dict_k[k] - v) for k, v in dict_p.items()}
    bad_terms = [k for k, d in d_terms.items()
                 if d > 0.02 * abs(dict_p[k]) + 1e-3]
    nbad = sum(n for _, _, n in beyond)
    calls = {}
    for kind, _, _ in beyond:
        calls[kind] = calls.get(kind, 0) + 1
    print(f"{what}, kernels vs plain at the plain run's SimOTA assignment: "
          f"total_loss {loss_k:.5f} vs {loss_p:.5f} (rel {d_loss:.2e}, bound "
          f"0.02); loss terms beyond 0.02 + 1e-3: {bad_terms}; "
          f"{len(shares)} gradient leaves, worst {shares[worst]:.3e} of its "
          f"max at {worst} (bound {(leaf_bounds or '-')[0]}), median "
          f"{median:.3e} (bound {(leaf_bounds or '-')[-1]}); calls checked "
          f"{calls}, {nbad} outputs "
          f"beyond tolerance (dw7x7: {dw_differ[0]} of {dw_differ[1]} "
          f"outputs differ at all); launches {counts}")
    print("  loss dict (kernels): " + ", ".join(
        f"{k} {v:.4f}" for k, v in dict_k.items()))
    assert counts == expected, counts
    assert nbad == 0, [b for b in beyond if b[2]]
    assert np.isfinite(loss_k) and d_loss <= 0.02 and not bad_terms
    assert leaf_bounds is None or (shares[worst] <= leaf_bounds[0]
                                   and median <= leaf_bounds[1])
    return shares


def phase_inst_train(report):
    """The inst stage's training step: ExpDetMask.get_optimizer (SGD,
    Nesterov, mask-only: the controllers and the mask branch train) and
    get_train_step on unicorn_inst_convnext_tiny_800x1280's YOLOXDet at
    B = 2 images of 800x1280, EMA on. (1) One step's loss and gradients
    (of the trainable tensors) through the dw7x7 kernel vs its plain
    version (`_kernels_vs_plain`). (2) MASK_TRAIN_WARMUP + MASK_TRAIN_STEPS
    timed steps over two batches: ms/step, images/s, peak memory, 27 dw7x7
    launches a step; then `_moved_check`: the frozen tensors bit-identical,
    every trainable one with a gradient, and moved. (3) Two steps with
    BoxInst: the projection and pairwise terms finite and > 0."""
    import torch

    from unicorn_torch.core.train_state import TrainState
    from unicorn_torch.core.train_step import det_mask_loss_fn

    exp, model = _inst_train_model(report)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, MASK_TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    batches = [_inst_train_batch(exp, seed) for seed in (20, 21)]
    H, W = exp.input_size

    def run():
        return _loss_and_grads(model, lambda: det_mask_loss_fn(
            model, *batches[0], exp.input_size, exp.always_l1,
            d_rate=exp.d_rate))

    _kernel_check_report(
        f"inst train {H}x{W}, B={TRAIN_B}, bf16, mask-only",
        *_kernels_vs_plain(run, ()), INST_TRAIN_LAUNCHES)

    frozen = _frozen_params(model)
    step = exp.get_train_step(TRAIN_B)
    _, counts, ms = _timed_steps(
        step, state, batches, INST_TRAIN_LAUNCHES,
        f"inst train path, B={TRAIN_B} images of {H}x{W}, SGD, mask-only, "
        f"EMA", "images")
    _moved_check(step, state, batches, frozen)
    _record_launches(report, "inst_train", counts)
    report["inst_train_ms_per_step"] = ms

    exp.boxinst = True
    box_step = exp.get_train_step(TRAIN_B)
    dicts = [box_step(state, *batches[t])[1] for t in range(2)]
    for t, d in enumerate(dicts):
        print(f"  BoxInst step {t}: " + ", ".join(
            f"{k} {v.item():.4f}" for k, v in d.items()))
        for k in ("boxinst_prj_loss", "boxinst_pairwise_loss"):
            v = d[k].item()
            assert torch.isfinite(d[k]) and v > 0, (k, v)
    exp.boxinst = False
    _frozen_unchanged(model, frozen)
    del state
    torch.cuda.empty_cache()


EMBEDDING_LAYERS = ("bottleneck.", "upsample_layer.", "transformer.",
                    "pos_emb.")
# Worst and median leaf of the embedding layers (fp32, ahead of the bf16
# head only through the priors), kernels vs plain with every tensor
# training: about 10x the largest readings on an H100, 4.66e-4 / 2.39e-4
# (the batches without small boxes; 1.93e-4 / 7.5e-5 with them).
EMBEDDING_LEAF_BOUNDS = (5e-3, 2e-3)


def phase_mask_train(report):
    """The VOS + MOTS stage's training step: ExpTrackMask.get_optimizer
    (AdamW, accumulation over 2, mask-only, EMA off) and get_train_step on
    unicorn_track_tiny_mask's Unicorn at B = 2 pairs of 800x1280, one VOS
    and one MOTS pair, masks at d_rate 2. (1) One step's loss and the
    trainable tensors' gradients through the dw7x7, MSDA and training
    correlation kernels vs their plain versions (`_kernels_vs_plain`):
    dw7x7 36, MSDA 1 (fp32), correlation forward 1 at K = 3, no backward
    kernel. (2) MASK_TRAIN_WARMUP + MASK_TRAIN_STEPS timed steps: ms/step,
    pairs/s, peak memory, launches; then `_moved_check`: frozen tensors
    bit-identical, every trainable one with a gradient, and moved. (3) One
    step with train_mask_only False, kernels vs plain: the backward kernels
    run once each at K = 3; the embedding layers' gradients compared at
    EMBEDDING_LEAF_BOUNDS."""
    import torch

    from unicorn_torch.core.train_state import TrainState
    from unicorn_torch.core.train_step import uni_mask_loss_fn
    from unicorn_torch.losses import vos as vos_mod

    exp, model = _mask_train_model(report)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, MASK_TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    batches = [_mask_train_batch(exp, seed) for seed in (30, 31)]
    H, W = exp.input_size
    kw = dict(mot_weight=float(exp.mot_weight) if exp.scale_all_mot else 1.0,
              bidirect=exp.bidirect, use_l1=exp.always_l1,
              up_rate=exp.up_rate)

    def run():
        return _loss_and_grads(model, lambda: uni_mask_loss_fn(
            model, *batches[0], exp.input_size, **kw))

    _kernel_check_report(
        f"mask train {H}x{W}, B={TRAIN_B} pairs (VOS, MOTS), mask-only",
        *_kernels_vs_plain(run, (vos_mod,)), MASK_TRAIN_LAUNCHES)

    frozen = _frozen_params(model)
    step = exp.get_train_step(TRAIN_B)
    _, counts, ms = _timed_steps(
        step, state, batches, MASK_TRAIN_LAUNCHES,
        f"mask train path, B={TRAIN_B} pairs of {H}x{W} (VOS, MOTS), "
        f"AdamW, grad_accum {state.tx.grad_accum}, mask-only", "pairs")
    _moved_check(step, state, batches, frozen)
    _record_launches(report, "mask_train", counts)
    report["mask_train_ms_per_step"] = ms

    # every tensor trains: the correlation's backward kernels run
    del state
    exp.train_mask_only = False
    full = TrainState.create(model, exp.get_optimizer(
        TRAIN_B, MASK_TRAIN_ITERS_PER_EPOCH), use_ema=False, device=DEVICE)
    assert all(p.requires_grad for p in model.parameters())
    names = {n for n, _ in model.named_parameters()
             if n.startswith(EMBEDDING_LAYERS)}
    shares = _kernel_check_report(
        "mask train, every tensor training", *_kernels_vs_plain(
            run, (vos_mod,)), MASK_TRAIN_FULL_LAUNCHES, names,
        EMBEDDING_LEAF_BOUNDS)
    print(f"  embedding layers: {len(shares)} leaves")
    # two steps of the path (one AdamW update) with every tensor training
    full_step = exp.get_train_step(TRAIN_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    dicts = [full_step(full, *batches[t])[1] for t in range(2)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _all_counts()
    print(f"mask train path, every tensor training: 2 steps, "
          f"{wall / 2 * 1e3:.1f} ms/step; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
          f"{counts} = 2 x {MASK_TRAIN_FULL_LAUNCHES}")
    assert all(bool(torch.isfinite(v).all()) for d in dicts
               for v in d.values()), "a loss is not finite"
    assert counts == {k: 2 * n for k, n in MASK_TRAIN_FULL_LAUNCHES.items()}, \
        counts
    assert full.opt_count == 1
    _record_launches(report, "mask_train_full", counts)
    exp.train_mask_only = True
    del full
    torch.cuda.empty_cache()


# -------------------------------------------------------- the trainer
TRAINER_FRAME_HW = (1080, 1920)  # the omni datasets' frames (uni stage)
TRAINER_MASK_HW = (480, 854)     # the VOS + MOTS datasets' frames
TRAINER_INST_HW = (480, 640)     # the inst dataset's images
TRAINER_SAMPLES = 24             # pairs an epoch: 12 iterations at B = 2
TRAINER_EPOCHS = 2               # the second without augmentation (L1)
TRAINER_SHORT_SAMPLES = 8        # 4 iterations: the other runs
TRAINER_SIGTERM_ITER = 3         # the SIGTERM lands after this iteration
TRAINER_EXP_FIELDS = {}          # fields set on every exp of the phases
#                                  trainer, disk, det and backbones
# the loss keys of JAX's uni step with mhs (its metrics.jsonl records hold
# these beside epoch and iter; tests/test_torch_port_trainer.py holds the
# port's against JAX's)
UNI_LOSS_KEYS = {"total_loss", "mhs_loss"} | {
    f"{k}_{t}" for k in ("corr_loss", "iou_loss", "conf_loss", "cls_loss",
                         "l1_loss", "num_fg") for t in ("sot", "mot")}


class _MemorySeqs:
    """In-memory sequences of two seeded uint8 frames each (a random
    texture, the second shifted by 8 px) with boxes that drift by a few
    px between them: `pull_item_omni(seq, n)` -> n frames of (img, res
    (N, 5 | 6) [xyxy, cls(, track id)](, masks (H, W, N) float32 filled
    ellipses)). sot: one box without an id column."""

    def __init__(self, n_seq, n_obj, hw, seed, sot=False, masked=False,
                 num_classes=8, with_ids=True):
        import numpy as np

        rng = np.random.RandomState(seed)
        h, w = hw
        self.items = []
        for _ in range(n_seq):
            base = rng.randint(0, 256, (h, w + 8, 3), dtype=np.uint8)
            n = 1 if sot else rng.randint(n_obj[0], n_obj[1] + 1)
            wh = rng.uniform(0.04, 0.25, (n, 2)) * [w, h]
            cxy = rng.uniform(0.2, 0.8, (n, 2)) * [w, h]
            cls = np.zeros(n) if sot else rng.randint(0, num_classes, n)
            frames = []
            for f in range(2):
                c = cxy + f * rng.uniform(-6, 6, (n, 2))
                boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).clip(
                    0, [w, h, w, h])
                cols = [boxes, cls[:, None]]
                if not sot and with_ids:
                    cols.append(np.arange(1, n + 1)[:, None])
                item = [np.ascontiguousarray(base[:, 8 * f:8 * f + w]),
                        np.hstack(cols).astype(np.float32)]
                if masked:
                    item.append(self._ellipses(boxes, h, w))
                frames.append(tuple(item))
            self.items.append(frames)

    @staticmethod
    def _ellipses(boxes, h, w):
        import numpy as np

        masks = np.zeros((h, w, len(boxes)), np.float32)
        for k, (x0, y0, x1, y1) in enumerate(boxes):
            ys, xs = np.ogrid[int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1))]
            inside = (((xs + 0.5 - (x0 + x1) / 2) / max((x1 - x0) / 2, 1e-6)) ** 2
                      + ((ys + 0.5 - (y0 + y1) / 2) / max((y1 - y0) / 2, 1e-6))
                      ** 2) <= 1.0
            masks[int(y0):int(np.ceil(y1)), int(x0):int(np.ceil(x1)), k] = inside
        return masks

    def __len__(self):
        return len(self.items)

    def pull_item_omni(self, seq_id, num_frames=2, rng=None):
        return [tuple(a.copy() for a in fr)
                for fr in self.items[seq_id][:num_frames]]


def _trainer_exp(base, out_dir, samples, max_epoch, datasets=None,
                 loader=None, **fields):
    """An instance of a subclass of the exp class `base` writing under
    out_dir, samples_per_epoch = samples, whose get_dataset passes the
    in-memory `datasets` (two groups) or whose get_data_loader is
    `loader(exp, batch_size)`."""
    class Exp(base):
        def get_dataset(self, *groups):
            return super().get_dataset(*datasets)

        if loader is not None:
            def get_data_loader(self, batch_size):
                return loader(self, batch_size)

    exp = Exp()
    exp.output_dir = out_dir
    exp.samples_per_epoch = samples
    exp.max_epoch = max_epoch
    exp.pretrain_name = None
    exp.print_interval = 4
    for k, v in {**TRAINER_EXP_FIELDS, **fields}.items():
        setattr(exp, k, v)
    return exp


def _uni_datasets(seed):
    hw = TRAINER_FRAME_HW
    return ([_MemorySeqs(3, None, hw, seed, sot=True)],
            [_MemorySeqs(3, (8, 12), hw, seed + 1)])


def _trainer_run(trainer, label, launches, unit="pairs"):
    """trainer.train() with the launch counts zeroed just before and read
    after; prints ms / iteration, pairs/s, data and step ms an iteration
    (host clocks inside the loop), peak memory. Returns (counts, iters,
    loop seconds)."""
    import torch

    t = {}
    orig = trainer.before_train

    def timed_before_train():
        orig()
        torch.cuda.synchronize()
        t["loop"] = time.perf_counter()

    trainer.before_train = timed_before_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    trainer.train()
    torch.cuda.synchronize()
    loop = time.perf_counter() - t["loop"]
    counts = _all_counts()
    iters = trainer.state.step - trainer.start_epoch * trainer.iters_per_epoch
    data, step = trainer.meters["data_time"], trainer.meters["step_time"]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    H, W = trainer.input_size
    print(f"{label}: {iters} iterations of B={trainer.batch_size} at "
          f"{H}x{W} in {loop:.2f} s: {loop / iters * 1e3:.1f} ms/iteration "
          f"({iters * trainer.batch_size / loop:.2f} {unit}/s); an iteration, "
          f"mean (median of the last {len(data._deque)}): data "
          f"{data.global_avg * 1e3:.1f} ({data.median * 1e3:.1f}) ms "
          f"(waiting on the loader, {trainer.loader.workers} workers, and "
          f"the copy up), step {step.global_avg * 1e3:.1f} "
          f"({step.median * 1e3:.1f}) ms (host clock, no synchronise); "
          f"peak memory {peak:.2f} GiB; launches {counts}"
          + (f" = {iters} x {launches}" if launches is not None else ""))
    if launches is not None:
        assert counts == {k: n * iters for k, n in launches.items()}, counts
    return counts, iters, loop


def _record_sizes(trainer):
    """Wrap trainer.device_batch to record the (H, W) of every batch the
    loop moves to the card, in order; returns that list."""
    sizes = []
    put = trainer.device_batch

    def recording(batch):
        out = put(batch)
        sizes.append(tuple(out[0].shape[-2:]))
        return out

    trainer.device_batch = recording
    return sizes


def _check_at_size(trained, seeded, exp, size, seed):
    """The uni step at a multiscale `size`, kernels vs plain
    (`_kernels_vs_plain`: every dw7x7, MSDA and training-correlation call
    at this size's stage, level and N shapes against its plain version,
    the correlation's gradients too, the loss's discrete choices replayed)
    on one mixed batch (an SOT and a MOT sample, 8 boxes) at that size,
    with the exp's loss weights and L1 setting, twice:

    - on the loop's `trained` weights: every call within tolerance, the
      loss and its terms within phase train_model's bounds; the gradient
      leaves printed, not bounded. Where training left them depends on
      the run (the kernels' atomics, cuDNN), and at some such states the
      bf16 trunk turns the calls' one-ulp differences into leaf shares
      past train_model's bounds while every call agrees (PERF.md §6);
    - on `seeded`, the trainer's initial weights (the exp's seed, the
      same in every run), with everything above and the leaves within
      train_model's 0.1 / 0.02 (`_kernel_check_report`)."""
    from unicorn_torch.core.train_step import uni_loss_fn
    from unicorn_torch.losses import uni as uni_mod

    images, targets, task_ids = _train_batch(exp, 2, seed=seed, n_obj=8,
                                             size=size)
    task_ids[0] = 1
    kw = dict(_uni_loss_kwargs(exp), img_size=tuple(size))
    H, W = size
    for model, which, bounds in ((trained, "trained", None),
                                 (seeded, "seeded", (0.1, 0.02))):
        def run():
            return _loss_and_grads(model, lambda: uni_loss_fn(
                model, images, targets, task_ids, **kw))

        _kernel_check_report(
            f"trainer, multiscale {H}x{W} (use_l1 {kw['use_l1']}), {which} "
            f"weights", *_kernels_vs_plain(run, (uni_mod,)), TRAIN_LAUNCHES,
            leaf_bounds=bounds)


def _check_metrics(trainer, keys):
    """Every metrics.jsonl record holds epoch, iter and `keys`, finite."""
    import math

    path = os.path.join(trainer.output_dir, "metrics.jsonl")
    with open(path) as f:
        records = [json.loads(line) for line in f]
    assert records, "no metrics.jsonl record"
    for r in records:
        assert set(r) == {"epoch", "iter"} | keys, sorted(set(r) ^ keys)
        assert all(math.isfinite(v) for v in r.values()), r
    return records


def _states_equal(a: dict, b: dict, what):
    import torch

    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k].cpu(), b[k].cpu()), (what, k)


def phase_trainer(report):
    """The training loop: Trainer(exp, {"batch_size": 2}).train() on
    unicorn_track_tiny at full width from an in-memory omni dataset
    (seeded 1080x1920 frames; SOT sequences of one box, MOT of 8-12 with
    ids): 2 epochs of 12 iterations (a multiscale draw at iteration 10,
    the L1 switch at epoch 1), and at each size run besides the input
    size one step kernels vs plain (`_check_at_size`); then 12 iterations
    with 4 loader workers;
    save times and file size; load_pretrained of a detector checkpoint
    (the seeded inst YOLOXDet), SIGTERM after iteration 3, resume
    bit-equal and to the end; one epoch of 4 iterations each of
    ExpTrackMask (UniMaskLoader, 480x854 frames) and the inst stage
    (InstLoader, 480x640 images)."""
    import logging
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from unicorn_torch.core.checkpoint import (load_checkpoint,
                                               save_checkpoint,
                                               wait_for_checkpoints)
    from unicorn_torch.core.trainer import Trainer
    from unicorn_torch.data.loader import InstLoader
    from unicorn_torch.data.transforms import TrainTransformIns
    from unicorn_torch.exp import unicorn_inst_convnext_tiny_800x1280 as inst
    from unicorn_torch.exp import unicorn_track_tiny as track
    from unicorn_torch.exp import unicorn_track_tiny_mask as track_mask

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_")
    cwd = os.getcwd()
    logger = logging.getLogger("unicorn_torch")
    try:
        out = tmp.name
        # -- two epochs at full width
        exp = _trainer_exp(track.Exp, out, TRAINER_SAMPLES, TRAINER_EPOCHS,
                           _uni_datasets(40), no_aug_epochs=1,
                           multiscale_range=2)
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        sizes = _record_sizes(tr)
        counts, iters, _ = _trainer_run(tr, "trainer, 2 epochs",
                                        TRAIN_LAUNCHES)
        _record_launches(report, "trainer", counts)
        assert iters == TRAINER_EPOCHS * TRAINER_SAMPLES // TRAIN_B
        assert tr.no_aug and exp.always_l1 and tr.state.opt_count == iters // 2
        records = _check_metrics(tr, UNI_LOSS_KEYS)
        draws = [np.random.RandomState((e * 100003 + 9) % 2 ** 32).randint(
            len(tr.size_list)) for e in range(TRAINER_EPOCHS)]
        runs = [[sizes[0], 1]]
        for hw in sizes[1:]:
            if hw == runs[-1][0]:
                runs[-1][1] += 1
            else:
                runs.append([hw, 1])
        print(f"  sizes {tr.size_list}; drawn at iteration 10 of each epoch: "
              f"{[tr.size_list[i] for i in draws]}; batches run, in order: "
              + ", ".join(f"{n} x {h}x{w}" for (h, w), n in runs)
              + f"; loader now at {tr.loader.input_size}; {len(records)} "
              f"metrics records, total_loss "
              f"{[round(r['total_loss'], 3) for r in records]}")
        assert len(sizes) == iters and tr.loader.input_size == \
            tr.size_list[draws[-1]]
        # every size the loop ran besides the input size: the same step
        # through the kernels against their plain versions
        others = sorted(set(sizes) - {tuple(exp.input_size)})
        assert others, "no multiscale size was run"
        seeded = exp.get_model(torch.Generator().manual_seed(
            exp.seed or 0)).to(DEVICE).train()
        for i, hw in enumerate(others):
            _check_at_size(tr.state.model, seeded, exp, hw, seed=13 + i)
        del seeded
        for name in ("latest", "last_mosaic_epoch"):
            assert os.path.isfile(os.path.join(tr.output_dir, name)), name
        # eval_interval (10) lies beyond the run: no eval, no `best`
        # (phase eval runs the in-training eval)
        assert not os.path.exists(os.path.join(tr.output_dir, "best"))
        # save times: blocking, and the return of an asynchronous save
        t0 = time.perf_counter()
        tr.save_ckpt("timed_blocking", blocking=True)
        t_block = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr.save_ckpt("timed_async")
        t_async = time.perf_counter() - t0
        wait_for_checkpoints()
        t_async_done = time.perf_counter() - t0
        size = os.path.getsize(os.path.join(tr.output_dir, "latest"))
        print(f"  checkpoint {size / 2 ** 20:.1f} MiB: blocking save "
              f"{t_block * 1e3:.0f} ms; asynchronous save returns in "
              f"{t_async * 1e3:.0f} ms (copy to host), written after "
              f"{t_async_done * 1e3:.0f} ms")
        shutil.rmtree(tr.output_dir)  # 4 checkpoints of the full state
        del tr
        torch.cuda.empty_cache()

        # -- the same with 4 loader workers
        exp = _trainer_exp(track.Exp, os.path.join(out, "w4"),
                           TRAINER_SAMPLES, 1, _uni_datasets(41),
                           data_num_workers=4)
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        _trainer_run(tr, "trainer, 4 loader workers", TRAIN_LAUNCHES)
        _check_metrics(tr, UNI_LOSS_KEYS)
        shutil.rmtree(tr.output_dir)
        del tr
        torch.cuda.empty_cache()

        # -- load_pretrained from a detector checkpoint, SIGTERM, resume
        os.chdir(out)
        dexp = inst.Exp()
        for k, v in TRAINER_EXP_FIELDS.items():
            setattr(dexp, k, v)
        det = dexp.get_model(torch.Generator().manual_seed(0)).state_dict()
        save_checkpoint(os.path.join(out, "Unicorn_outputs", "det_smoke"),
                        {"model": det, "ema_model": det})

        class Preempted(Trainer):
            def before_train(self):
                super().before_train()
                got = {k: v.cpu() for k, v in self.model.state_dict().items()}
                gather = [0, 0, 2, 7, 5, 6, 3, 1]
                n = 0
                for k, v in det.items():
                    if k in got and "cls_preds" in k and \
                            v.shape != got[k].shape:
                        v = v[gather]
                    if k in got and v.shape == got[k].shape:
                        assert torch.equal(got[k], v), k
                        n += 1
                sot = [k for k in got if "_sot." in k and (
                    "obj_preds" in k or "reg_preds" in k)]
                for k in sot:
                    assert torch.equal(got[k], det[k.replace("_sot", "")]), k
                print(f"  load_pretrained: {n} of {len(got)} tensors equal "
                      f"to the detector's ({len(det)}), cls_preds gathered "
                      f"80 -> 8, {len(sot)} *_sot tensors duplicated")
                assert n > len(got) // 2 and len(sot) == 12

            def _get_step_fn(self, size):
                fn = super()._get_step_fn(size)

                def hooked(*a):
                    res = fn(*a)
                    if self.iter == TRAINER_SIGTERM_ITER - 1:
                        os.kill(os.getpid(), signal.SIGTERM)
                    return res

                return hooked

        def preempt_exp():
            return _trainer_exp(track.Exp, os.path.join(out, "pre"),
                                TRAINER_SHORT_SAMPLES, 1, _uni_datasets(42),
                                pretrain_name="det_smoke")

        before = signal.getsignal(signal.SIGTERM)
        tr = Preempted(preempt_exp(), {"batch_size": TRAIN_B}, device=DEVICE)
        _reset_all_counts()
        tr.train()
        assert tr._preempted == signal.SIGTERM and tr.iter == \
            TRAINER_SIGTERM_ITER - 1
        assert signal.getsignal(signal.SIGTERM) is before
        pre_counts = _all_counts()
        assert pre_counts == {k: n * TRAINER_SIGTERM_ITER
                              for k, n in TRAIN_LAUNCHES.items()}, pre_counts
        saved = load_checkpoint(tr.output_dir, "latest")
        assert (saved["epoch"], saved["step"], saved["opt_count"],
                saved["mini_step"]) == (0, 3, 1, 1), saved["step"]
        mine = tr.state.state_dict()
        _states_equal(mine["model"], saved["model"], "model as saved")
        print(f"  SIGTERM after iteration {TRAINER_SIGTERM_ITER}: `latest` "
              f"written (epoch 0, step 3, opt_count 1, mini_step 1), the run "
              f"stopped; launches {pre_counts}")
        del tr, mine
        torch.cuda.empty_cache()

        class Resumed(Trainer):
            def before_train(self):
                super().before_train()
                sd = self.state.state_dict()
                _states_equal(sd["model"], saved["model"], "model")
                _states_equal(sd["ema_model"], saved["ema_model"], "ema")
                opt, s_opt = sd["optimizer"]["state"], \
                    saved["optimizer"]["state"]
                assert opt.keys() == s_opt.keys() and opt
                for i in opt:
                    for k in ("exp_avg", "exp_avg_sq"):
                        assert torch.equal(opt[i][k].cpu(),
                                           s_opt[i][k]), (i, k)
                    assert float(opt[i]["step"]) == 0
                st = self.state
                assert (st.step, st.opt_count, st.mini_step) == (0, 0, 0)
                assert all(not a.any() for a in st._acc)
                print(f"  resume: model, EMA and AdamW moments of {len(opt)} "
                      f"tensors bit-equal to the checkpoint; counters "
                      f"rewound to the epoch-0 boundary")

        exp = preempt_exp()
        exp.pretrain_name = None
        tr = Resumed(exp, {"batch_size": TRAIN_B, "resume": True},
                     device=DEVICE)
        _trainer_run(tr, "trainer, resumed run", TRAIN_LAUNCHES)
        assert tr._preempted is None and tr.state.step == tr.iters_per_epoch
        _check_metrics(tr, UNI_LOSS_KEYS)
        os.chdir(cwd)
        shutil.rmtree(tr.output_dir)
        del tr, saved
        torch.cuda.empty_cache()

        # -- the mask stages, one epoch of 4 iterations each
        mh = TRAINER_MASK_HW
        exp = _trainer_exp(
            track_mask.Exp, os.path.join(out, "mask"), TRAINER_SHORT_SAMPLES,
            1, ([_MemorySeqs(2, (1, 3), mh, 50, masked=True)],
                [_MemorySeqs(2, (8, 12), mh, 51, masked=True)]))
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        counts, _, _ = _trainer_run(tr, "trainer, VOS + MOTS stage",
                                    MASK_TRAIN_LAUNCHES)
        _record_launches(report, "trainer_mask", counts)
        shutil.rmtree(tr.output_dir)
        del tr
        torch.cuda.empty_cache()

        def inst_loader(exp, batch_size):
            return InstLoader(
                _MemorySeqs(3, (8, 16), TRAINER_INST_HW, 60, masked=True,
                            num_classes=exp.num_classes, with_ids=False),
                TrainTransformIns(exp.max_labels, exp.flip_prob,
                                  exp.hsv_prob, d_rate=exp.d_rate),
                batch_size, exp.input_size, seed=exp.seed or 0,
                workers=exp.data_num_workers)

        exp = _trainer_exp(inst.Exp, os.path.join(out, "inst"),
                           TRAINER_SHORT_SAMPLES, 1, loader=inst_loader)
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        counts, _, _ = _trainer_run(tr, "trainer, inst stage",
                                    INST_TRAIN_LAUNCHES, unit="images")
        _record_launches(report, "trainer_inst", counts)
        del tr
        torch.cuda.empty_cache()
    finally:
        os.chdir(cwd)
        wait_for_checkpoints()
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        tmp.cleanup()


# --------------------------------------------------- training from disk
FIXTURES = os.path.join(ROOT, "tests", "torch_fixtures")
DISK_ROOT = os.path.join(ROOT, "chiprun_out", "disk_data")
DISK_FRAMES = ("frame_1080x1920_q90.jpg",
               "frame_1080x1920_q90_progressive.jpg")
DISK_DECODES = 20        # timed decodes of a file on each thread
DISK_UNI_SAMPLES = 12    # pairs of the uni run: 6 iterations at B = 2
DISK_MASK_SAMPLES = 8    # pairs or images of a mask-stage run: 4 iterations
DISK_EXP_FIELDS = dict(mot_test_name="motchallenge", no_aug_epochs=0)


def _fixtures():
    """tests/torch_fixtures/make_fixtures.py as a module (`digest`; it
    imports cv2 and PIL only inside its writers)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _disk_decode(report):
    """Every fixture decoded by the port's reader against the digests of
    cv2's / PIL's decodes in hashes.json; then the decode time of each
    1080x1920 JPEG (imread) and of the 480x854 palette mask
    (read_indexed_mask): DISK_DECODES on one thread, and on each of 4
    threads at once."""
    from concurrent.futures import ThreadPoolExecutor

    from unicorn_torch.data import image_io

    digest = _fixtures().digest
    with open(os.path.join(FIXTURES, "hashes.json")) as f:
        hashes = json.load(f)
    bad, n = [], 0
    for name, want in sorted(hashes.items()):
        path = os.path.join(FIXTURES, name)
        for kind, d in want.items():
            got = image_io.read_indexed_mask(path) if kind == "index" else \
                image_io.imread(path, image_io.IMREAD_COLOR if kind == "color"
                                else image_io.IMREAD_GRAYSCALE)
            n += 1
            if digest(got) != d:
                bad.append((name, kind))
    print(f"disk ({report.get('card', '')}): {n} decodes of {len(hashes)} "
          f"fixtures (JPEG baseline, "
          f"progressive, restart, EXIF, 4:2:0 / 4:2:2 / 4:4:4 / 4:4:0, gray; "
          f"PNG every colour type and depth) against cv2 / PIL's digests in "
          f"hashes.json: {len(bad)} differ {bad}")
    assert not bad, bad
    out = {}
    for name, fn in ((DISK_FRAMES[0], image_io.imread),
                     (DISK_FRAMES[1], image_io.imread),
                     ("davis_480x854_mask.png", image_io.read_indexed_mask)):
        path = os.path.join(FIXTURES, name)
        fn(path)
        t0 = time.perf_counter()
        for _ in range(DISK_DECODES):
            fn(path)
        one = (time.perf_counter() - t0) / DISK_DECODES * 1e3
        with ThreadPoolExecutor(4) as ex:
            t0 = time.perf_counter()
            list(ex.map(lambda _: fn(path), range(4 * DISK_DECODES)))
            four = (time.perf_counter() - t0) / (4 * DISK_DECODES) * 1e3
        out[name] = (one, four)
        print(f"  decode {name} ({os.path.getsize(path)} bytes): {one:.2f} ms "
              f"on 1 thread ({1e3 / one:.1f} images/s); 4 threads "
              f"{1e3 / four:.1f} images/s ({one / four:.2f}x)")
    report["disk_decode"] = out


def _write_disk_layouts(root):
    """The reference layouts of the mixes' datasets under root, their
    frames copies of the fixtures: LaSOT (cat/cat-1: img/*.jpg,
    groundtruth.txt, full_occlusion.txt, out_of_view.txt), GOT10K (a
    sequence, absence.label, list.txt), COCO (instances_train2017.json,
    polygon and RLE masks), MOT17 (mot/annotations/train_omni.json, 10
    pedestrians with track ids), DAVIS (JPEGImages/480p, palette
    Annotations/480p, ImageSets/2017/train.txt), MOTS-Challenge
    (MOTS/annotations/train_mots.json, RLE)."""
    import shutil

    import numpy as np

    from unicorn_torch.evaluators import rle

    H, W = 1080, 1920
    rng = np.random.RandomState(15)

    def copy(name, *path):
        dst = os.path.join(root, *path)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(os.path.join(FIXTURES, name), dst)

    def text(lines, *path):
        with open(os.path.join(root, *path), "w") as f:
            f.write("\n".join(lines) + "\n")

    def dump(obj, *path):
        os.makedirs(os.path.dirname(os.path.join(root, *path)), exist_ok=True)
        with open(os.path.join(root, *path), "w") as f:
            json.dump(obj, f)

    def ellipse(x, y, w, h):
        m = np.zeros((H, W), np.uint8)
        ys, xs = np.ogrid[:H, :W]
        m[((xs + 0.5 - x - w / 2) / (w / 2)) ** 2
          + ((ys + 0.5 - y - h / 2) / (h / 2)) ** 2 <= 1] = 1
        return m

    for t in range(6):
        copy(DISK_FRAMES[t % 2], "LaSOT", "cat", "cat-1", "img",
             f"{t + 1:08d}.jpg")
    text([f"{700 + 9 * t},{400 + 5 * t},260,200" for t in range(6)],
         "LaSOT", "cat", "cat-1", "groundtruth.txt")
    text(["0,0,0,1,0,0"], "LaSOT", "cat", "cat-1", "full_occlusion.txt")
    text(["0,0,0,0,0,1"], "LaSOT", "cat", "cat-1", "out_of_view.txt")
    got = ("GOT10K", "train", "GOT-10k_Train_000001")
    for t in range(4):
        copy(DISK_FRAMES[t % 2], *got, f"{t + 1:08d}.jpg")
    text([f"{300 + 11 * t}.5,{250 + 4 * t},{320 - 6 * t},180" for t in
          range(4)], *got, "groundtruth.txt")
    text(["0", "0", "1", "0"], *got, "absence.label")
    text(["GOT-10k_Train_000001"], "GOT10K", "train", "list.txt")

    images, anns = [], []
    for i, name in enumerate(DISK_FRAMES):
        copy(name, "coco", "train2017", f"{i + 1:012d}.jpg")
        images.append({"id": i + 1, "file_name": f"{i + 1:012d}.jpg",
                       "width": W, "height": H})
        for k in range(6):
            x, y = rng.uniform(0, W - 420), rng.uniform(0, H - 320)
            w, h = rng.uniform(60, 400), rng.uniform(60, 300)
            a = {"id": len(anns) + 1, "image_id": i + 1,
                 "category_id": (1, 2, 3)[k % 3], "bbox": [x, y, w, h],
                 "area": w * h, "iscrowd": 0}
            if k % 2:
                a["segmentation"] = rle.encode(ellipse(x, y, w, h))
            else:  # a polygon, one of them on the frame's right border
                a["segmentation"] = [[x, y, x + w, y + 0.2 * h,
                                      float(W) if k == 0 else x + w, y + h,
                                      x + 0.3 * w, y + 0.8 * h]]
            anns.append(a)
    dump({"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "person"},
                         {"id": 2, "name": "bicycle"},
                         {"id": 3, "name": "car"}]},
         "coco", "annotations", "instances_train2017.json")

    images, anns = [], []
    start = rng.uniform([0, 0], [W - 200, H - 300], (10, 2))
    for t in range(6):
        name = f"MOT17-02-FRCNN/img1/{t + 1:06d}.jpg"
        copy(DISK_FRAMES[t % 2], "mot", "train", name)
        images.append({"id": t + 1, "file_name": name, "width": W,
                       "height": H, "video_id": 1, "frame_id": t + 1})
        for k, (x, y) in enumerate(start + t * 6):
            anns.append({"id": len(anns) + 1, "image_id": t + 1,
                         "category_id": 1, "bbox": [x, y, 90, 240],
                         "track_id": k + 1, "iscrowd": 0})
    dump({"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "pedestrian"}]},
         "mot", "annotations", "train_omni.json")

    for t in range(4):
        copy("davis_480x854.jpg", "DAVIS", "JPEGImages", "480p", "bear",
             f"{t:05d}.jpg")
        copy("davis_480x854_mask.png", "DAVIS", "Annotations", "480p",
             "bear", f"{t:05d}.png")
    os.makedirs(os.path.join(root, "DAVIS", "ImageSets", "2017"))
    text(["bear"], "DAVIS", "ImageSets", "2017", "train.txt")

    images, anns = [], []
    for t in range(4):
        name = f"train/0002/{t + 1:06d}.jpg"
        copy(DISK_FRAMES[t % 2], "MOTS", name)
        images.append({"id": t + 1, "file_name": name, "width": W,
                       "height": H, "video_id": 2, "frame_id": t + 1})
        for k, (x, y) in enumerate(start[:6] + t * 6):
            anns.append({"id": len(anns) + 1, "image_id": t + 1,
                         "category_id": 1, "bbox": [x, y, 90, 240],
                         "track_id": 2000 + k, "iscrowd": 0,
                         "segmentation": rle.encode(ellipse(x, y, 90, 240))})
    dump({"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "pedestrian"}]},
         "MOTS", "annotations", "train_mots.json")


def _disk_run(report, tr, label, launches, path, unit="pairs"):
    """_trainer_run with the loader's batch builds and the reader's decodes
    timed (in the loader's thread): prints their ms a batch and the decode
    share; records the launches under `path`."""
    from unittest import mock

    from unicorn_torch.data import image_io
    from unicorn_torch.data import loader as tl

    acc = {"build": 0.0, "batches": 0, "decode": 0.0, "files": 0}

    def timed(fn, key, count):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                acc[key] += time.perf_counter() - t0
                acc[count] += 1
        return wrapper

    patches = [mock.patch.object(image_io, f, timed(getattr(image_io, f),
                                                    "decode", "files"))
               for f in ("_jpeg", "_png")]
    patches += [mock.patch.object(c, "_make_batch", timed(
        c._make_batch, "build", "batches"))
        for c in (tl.UniLoader, tl.UniMaskLoader, tl.InstLoader,
                  tl.DetLoader)]
    with contextlib.ExitStack() as stack:
        for ptc in patches:
            stack.enter_context(ptc)
        counts, iters, loop = _trainer_run(tr, label, launches, unit)
    nb = max(acc["batches"], 1)
    print(f"  loader thread: {acc['batches']} batches built, "
          f"{acc['build'] / nb * 1e3:.1f} ms a batch, of which decoding "
          f"{acc['files'] / nb:.1f} files {acc['decode'] / nb * 1e3:.1f} ms "
          f"({acc['decode'] / max(acc['build'], 1e-9) * 100:.1f}%)")
    _record_launches(report, path, counts)
    return counts, acc


def phase_disk(report):
    """Training from files on disk: the fixtures decoded against cv2's /
    PIL's digests and timed (`_disk_decode`); the mixes' reference layouts
    written under chiprun_out/disk_data from the fixtures
    (`_write_disk_layouts`); with UNICORN_DATADIR there, Trainer(exp,
    {"batch_size": 2}).train() through the exps' own get_data_loader:
    unicorn_track_tiny (mot_test_name motchallenge: COCOSOT, LaSOT,
    GOT10K and MOT17 found, the others skipped) 1 epoch of 6 iterations
    at 800x1280, AdamW, accumulation 2, EMA; then the first on-disk batch's
    step, kernels vs plain at phase train_model's bounds; the
    unicorn_track_tiny_mask stage (COCO instances and DAVIS; COCO persons
    and MOTS-Challenge) and the inst stage (COCO, polygon and RLE masks),
    4 iterations each. Launches 36 / 1 / 2 / 2 / 2, 36 / 1 / fwd_lse 1
    and 27 a step."""
    import logging
    import shutil
    import tempfile

    import torch

    from unicorn_torch.core.checkpoint import wait_for_checkpoints
    from unicorn_torch.core.train_step import uni_loss_fn
    from unicorn_torch.core.trainer import Trainer
    from unicorn_torch.exp import unicorn_inst_convnext_tiny_800x1280 as inst
    from unicorn_torch.exp import unicorn_track_tiny as track
    from unicorn_torch.exp import unicorn_track_tiny_mask as track_mask
    from unicorn_torch.losses import uni as uni_mod

    _disk_decode(report)
    shutil.rmtree(DISK_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    _write_disk_layouts(DISK_ROOT)
    print(f"  layouts written under {os.path.relpath(DISK_ROOT, ROOT)} in "
          f"{time.perf_counter() - t0:.2f} s")
    env = os.environ.get("UNICORN_DATADIR")
    os.environ["UNICORN_DATADIR"] = DISK_ROOT
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_disk_")
    logger = logging.getLogger("unicorn_torch")
    try:
        exp = _trainer_exp(track.Exp, os.path.join(tmp.name, "uni"),
                           DISK_UNI_SAMPLES, 1, (), **DISK_EXP_FIELDS)
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        first = []
        put = tr.device_batch

        def keep_first(batch):
            out = put(batch)
            if not first:
                first.extend(out)
            return out

        tr.device_batch = keep_first
        _disk_run(report, tr, "trainer from disk, uni", TRAIN_LAUNCHES,
                  "trainer_disk")
        names = [type(d).__name__ for g in (tr.loader.dataset.sot_dataset,
                                            tr.loader.dataset.mot_dataset)
                 for d in g.datasets]
        print(f"  mix found: {names}")
        assert names == ["COCOSOT", "Lasot", "Got10k", "MOTOmniDataset"], names
        images, targets, task_ids = first
        kw = _uni_loss_kwargs(exp)
        model = tr.state.model

        def run():
            return _loss_and_grads(model, lambda: uni_loss_fn(
                model, images, targets, task_ids, **kw))

        _kernel_check_report(
            f"trainer from disk, first batch (task {int(task_ids[0])}, "
            f"{int((targets[:, 1, :, 3] > 0).sum())} boxes in frame 2)",
            *_kernels_vs_plain(run, (uni_mod,)), TRAIN_LAUNCHES)
        del tr, model, first, images, targets
        torch.cuda.empty_cache()

        exp = _trainer_exp(track_mask.Exp, os.path.join(tmp.name, "mask"),
                           DISK_MASK_SAMPLES, 1, (), **DISK_EXP_FIELDS)
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        _disk_run(report, tr, "trainer from disk, VOS + MOTS stage",
                  MASK_TRAIN_LAUNCHES, "trainer_disk_mask")
        names = [type(d).__name__ for g in (tr.loader.dataset.sot_dataset,
                                            tr.loader.dataset.mot_dataset)
                 for d in g.datasets]
        print(f"  mix found: {names}")
        assert names == ["COCOMOTSDataset", "DAVISTrainDataset",
                         "COCOMOTSDataset", "MOTSVideoDataset"], names
        del tr
        torch.cuda.empty_cache()

        exp = _trainer_exp(inst.Exp, os.path.join(tmp.name, "inst"),
                           DISK_MASK_SAMPLES, 1, no_aug_epochs=0)
        tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
        _disk_run(report, tr, "trainer from disk, inst stage",
                  INST_TRAIN_LAUNCHES, "trainer_disk_inst", unit="images")
        del tr
        torch.cuda.empty_cache()
        shutil.rmtree(DISK_ROOT)
    finally:
        if env is None:
            os.environ.pop("UNICORN_DATADIR", None)
        else:
            os.environ["UNICORN_DATADIR"] = env
        wait_for_checkpoints()
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        tmp.cleanup()


DET_ROOT = os.path.join(ROOT, "chiprun_out", "det_data")
DET_SAMPLES = 6          # images an epoch: 3 iterations at B = 2
# dw7x7 launches of one det step: 18 trunk blocks of ConvNeXt-Tiny (36 of
# ConvNeXt-Large) and 9 head attention blocks; under remat=True the
# backward recomputes the trunk's blocks, under "dw" it keeps their output
DET_LAUNCHES = dict(INST_TRAIN_LAUNCHES)
DET_LARGE_LAUNCHES = {False: dict(DET_LAUNCHES, dwconv7x7=45),
                      True: dict(DET_LAUNCHES, dwconv7x7=81),
                      "dw": dict(DET_LAUNCHES, dwconv7x7=45)}
REMAT_STEPS = 3          # timed steps of each remat mode, after a warm-up
# backbone_map: the trunk runs once a frame, 4 frames of a B = 2 batch
MAP_LAUNCHES = dict(TRAIN_LAUNCHES, dwconv7x7=4 * 18 + 2 * 9)


def _det_batch(exp, seed, n_obj=12):
    """One synthetic detection batch on the card: images (B, 3, H, W)
    float32 in [0, 255] (a random texture), labels (B, max_labels, 5)
    [cls, cx, cy, w, h] with n_obj boxes of 30-300 px."""
    import numpy as np
    import torch

    H, W = exp.input_size
    rng = np.random.RandomState(seed)
    images = (rng.rand(TRAIN_B, 3, H, W) * 255).round().astype(np.float32)
    labels = np.zeros((TRAIN_B, exp.max_labels, 5), np.float32)
    scale = min(H / 800, W / 1280)
    for b in range(TRAIN_B):
        labels[b, :n_obj, 0] = rng.randint(0, exp.num_classes, n_obj)
        labels[b, :n_obj, 1:3] = rng.uniform(0.15, 0.85, (n_obj, 2)) * [W, H]
        labels[b, :n_obj, 3:5] = rng.uniform(30, 300, (n_obj, 2)) * scale
    return (torch.from_numpy(images).to(DEVICE),
            torch.from_numpy(labels).to(DEVICE))


def _det_stage(report, tmp):
    """Trainer.train on unicorn_det_convnext_tiny_800x1280 over the COCO
    layout under UNICORN_DATADIR: 2 epochs of 3 iterations, mosaic and
    MixUp in the first, closed in the second (L1 on). Returns (trainer,
    the first batch on the card, the items built with and without
    mosaic)."""
    from unittest import mock

    from unicorn_torch.core.trainer import Trainer
    from unicorn_torch.data import mosaic as tm
    from unicorn_torch.exp import unicorn_det_convnext_tiny_800x1280 as det

    exp = _trainer_exp(det.Exp, os.path.join(tmp, "Unicorn_outputs"),
                       DET_SAMPLES, 2, (), no_aug_epochs=1,
                       print_interval=DET_SAMPLES // TRAIN_B)
    tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
    first, built = [], {"mosaic": 0, "plain": 0}
    put, get_item = tr.device_batch, tm.MosaicDetection.get_item

    def keep_first(batch):
        out = put(batch)
        if not first:
            first.extend(out)
        return out

    def counting(self, idx, **kw):
        built["mosaic" if self.enable_mosaic else "plain"] += 1
        return get_item(self, idx, **kw)

    tr.device_batch = keep_first
    with mock.patch.object(tm.MosaicDetection, "get_item", counting):
        _disk_run(report, tr, "det stage (mosaic pretraining) from disk",
                  DET_LAUNCHES, "det", unit="images")
    return tr, first, built


def _remat_large(report):
    """One det step (forward + backward) of the
    unicorn_det_convnext_large_800x1280 YOLOXDet (bf16, seed-0 weights, B =
    2 of 800x1280) on one synthetic batch under remat False (twice: the
    two-run spread of the kernels), True and "dw": the loss, the gradient
    leaves' largest difference from the first run as a share of the leaf's
    largest magnitude, ms/step (the median of REMAT_STEPS after a warm-up
    step), the step's peak memory above what was allocated before it, and
    the dw7x7 launches."""
    import torch

    from unicorn_torch.core.train_step import det_loss_fn
    from unicorn_torch.exp import unicorn_det_convnext_large_800x1280 as large

    exp = large.Exp()
    for k, v in TRAINER_EXP_FIELDS.items():
        setattr(exp, k, v)
    model = exp.get_model(torch.Generator().manual_seed(0)).to(
        DEVICE).train()
    images, labels = _det_batch(exp, seed=30)
    H, W = exp.input_size
    blocks = [b for s in model.backbone.backbone.stages for b in s]

    def step():
        return _loss_and_grads(model, lambda: det_loss_fn(
            model, images, labels, exp.input_size))

    runs = {}
    for mode in (False, False, True, "dw"):
        for b in blocks:
            b.remat = mode
        # the warm-up grows the allocator's cache to this mode's working
        # set, so that the timed steps make no cudaMalloc calls
        torch.cuda.empty_cache()
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        _reset_all_counts()
        times = []
        for _ in range(REMAT_STEPS):
            t0 = time.perf_counter()
            loss, _, grads = step()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = sorted(times)[len(times) // 2]
        grads = {k: g.cpu() for k, g in grads.items()}
        counts = {k: n // REMAT_STEPS for k, n in _all_counts().items()}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
        key = "spread" if mode is False and False in runs else mode
        runs[key] = (loss, grads)
        shares = (_grad_shares(runs[False][1], grads)
                  if key is not False else None)
        print(f"remat {mode!r}{' (second run)' if key == 'spread' else ''}: "
              f"{exp.backbone_name} YOLOXDet {H}x{W}, B={TRAIN_B}, "
              f"{'bf16' if exp.bf16 else 'fp32'}: loss "
              f"{loss:.6f}, {ms:.1f} ms/step (forward + backward, the "
              f"median of {REMAT_STEPS}: "
              f"{', '.join(f'{t:.1f}' for t in times)}), peak "
              f"memory {peak:.2f} GiB above the {held:.2f} GiB held before "
              f"the step (the weights and what earlier phases keep), "
              f"launches a step {counts}"
              + (f"; gradient leaves against the first remat False run: "
                 f"worst {shares[0][shares[1]]:.3e} of its max at "
                 f"{shares[1]}, median {shares[2]:.3e}" if shares else ""))
        report.setdefault("det_remat", {})[repr(key)] = (ms, peak, loss)
        _record_launches(report, f"det_large_remat_{mode}", counts)
        assert counts == DET_LARGE_LAUNCHES[mode], counts
        assert torch.isfinite(torch.tensor(loss))
    loss0 = runs[False][0]
    spread_loss = abs(runs["spread"][0] - loss0)
    spread = max(_grad_shares(runs[False][1], runs["spread"][1])[0].values())
    for mode in (True, "dw"):
        loss, grads = runs[mode]
        worst = max(_grad_shares(runs[False][1], grads)[0].values())
        print(f"  remat {mode!r} against remat False: loss {loss - loss0:+.3e}"
              f" (two-run spread {spread_loss:.3e}); worst gradient leaf "
              f"{worst:.3e} of its max (two-run spread {spread:.3e}, the "
              f"bound)")
        assert abs(loss - loss0) <= spread_loss, (mode, loss, loss0)
        assert worst <= spread, (mode, worst, spread)
    for b in blocks:
        b.remat = exp.remat
    del model, runs
    torch.cuda.empty_cache()


def phase_det(report):
    """Mosaic detection pretraining and what it feeds. With
    UNICORN_DATADIR at the COCO layout that phase disk writes (written
    again under chiprun_out/det_data): Trainer(unicorn_det_convnext_tiny_
    800x1280, {"batch_size": 2}).train() at 800x1280, 2 epochs of 3
    iterations (mosaic and MixUp, then no-aug with L1), SGD with Nesterov
    and EMA (ms / iteration, data and step ms, the loader's ms a batch,
    peak memory, 27 dw7x7 launches a step); the first mosaic batch's step
    kernels vs plain (on the trained and on the seeded weights, at
    train_model's bounds); the chain: unicorn_track_tiny's load_pretrained
    reads the stage's `latest` (trunk tensors equal, cls_preds gathered
    80 -> 8) and one uni step runs from those weights; remat False / True
    / "dw" on the convnext_large YOLOXDet (`_remat_large`); one
    unicorn_track_tiny uni step with backbone_map against without
    (`_backbone_map`)."""
    import logging
    import shutil
    import tempfile

    import torch

    from unicorn_torch.core.checkpoint import (load_checkpoint,
                                               wait_for_checkpoints)
    from unicorn_torch.core.train_state import TrainState
    from unicorn_torch.core.train_step import det_loss_fn
    from unicorn_torch.exp import unicorn_det_convnext_tiny_800x1280 as det
    from unicorn_torch.exp import unicorn_track_tiny as track

    print(f"det ({report.get('card', '')})")
    shutil.rmtree(DET_ROOT, ignore_errors=True)
    _write_disk_layouts(DET_ROOT)
    env = os.environ.get("UNICORN_DATADIR")
    os.environ["UNICORN_DATADIR"] = DET_ROOT
    cwd = os.getcwd()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_det_")
    logger = logging.getLogger("unicorn_torch")
    try:
        tr, first, built = _det_stage(report, tmp.name)
        exp = tr.exp
        print(f"  items built: {built['mosaic']} with mosaic, "
              f"{built['plain']} after close_mosaic; L1 on: "
              f"{exp.always_l1}; lr of the next update {tr.state.lr():.3e}")
        assert built["mosaic"] > 0 and built["plain"] > 0, built
        assert not tr.loader.dataset.enable_mosaic and exp.always_l1
        records = _check_metrics(tr, {"total_loss", "iou_loss", "conf_loss",
                                      "cls_loss", "l1_loss", "num_fg"})
        print(f"  metrics.jsonl: {records}")
        assert records[-1]["l1_loss"] > 0, records

        images, labels = first
        n_boxes = int((labels[..., 3] > 0).sum())
        seeded = det.Exp()
        for k, v in TRAINER_EXP_FIELDS.items():
            setattr(seeded, k, v)
        seeded = seeded.get_model(torch.Generator().manual_seed(0)).to(
            DEVICE).train()
        for model, which, bounds in ((tr.state.model, "trained", None),
                                     (seeded, "seeded", (0.1, 0.02))):
            def run():
                return _loss_and_grads(model, lambda: det_loss_fn(
                    model, images, labels, exp.input_size, False))

            _kernel_check_report(
                f"det stage, first mosaic batch ({n_boxes} boxes), {which} "
                f"weights", *_kernels_vs_plain(run, ()), DET_LAUNCHES,
                leaf_bounds=bounds)
        del seeded, first, images, labels
        wait_for_checkpoints()
        latest = load_checkpoint(tr.output_dir, "latest")["model"]
        del tr
        torch.cuda.empty_cache()

        os.chdir(tmp.name)
        texp = track.Exp()
        for k, v in TRAINER_EXP_FIELDS.items():
            setattr(texp, k, v)
        assert texp.pretrain_name == exp.exp_name
        model = texp.get_model(torch.Generator().manual_seed(0))
        got = texp.load_pretrained(model.state_dict())
        trunk = [k for k in latest if k.startswith("backbone.backbone.")]
        for k in trunk:
            assert torch.equal(got[k], latest[k]), k
        gather = [0, 0, 2, 7, 5, 6, 3, 1]
        cls = [k for k in latest if "cls_preds" in k]
        for k in cls:
            assert torch.equal(got[k], latest[k][gather]), k
        model.load_state_dict(got)
        print(f"  chain: unicorn_track_tiny's load_pretrained read "
              f"{exp.exp_name}/latest: {len(trunk)} trunk tensors equal, "
              f"{len(cls)} cls_preds tensors gathered 80 -> 8")
        model = model.to(DEVICE).train()
        state = TrainState.create(
            model, texp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH),
            use_ema=texp.ema, device=DEVICE)
        step = texp.get_train_step(TRAIN_B)
        batch = _train_batch(texp, 2, seed=31, n_obj=8)
        _reset_all_counts()
        _, loss_dict = step(state, *batch)
        counts = _all_counts()
        total = loss_dict["total_loss"].item()
        print(f"  one uni step from the det stage's weights: total_loss "
              f"{total:.4f}; launches {counts}")
        assert counts == TRAIN_LAUNCHES and torch.isfinite(
            loss_dict["total_loss"])
        _record_launches(report, "det_chain", counts)
        del state, model, step
        torch.cuda.empty_cache()
        shutil.rmtree(DET_ROOT)
    finally:
        os.chdir(cwd)
        if env is None:
            os.environ.pop("UNICORN_DATADIR", None)
        else:
            os.environ["UNICORN_DATADIR"] = env
        wait_for_checkpoints()
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        tmp.cleanup()

    _remat_large(report)
    _backbone_map(report)


def _backbone_map(report):
    """One unicorn_track_tiny uni step (forward + backward) with
    backbone_map against without, on one mixed batch: in fp32 with TF32
    off, where batch 1 and batch 4 differ only in the order of fp32 sums
    (the loss within 1e-5 relative), and as trained, in bf16, where they
    round at other points and SimOTA may assign otherwise (the loss
    within phase train_model's 0.02); the gradient leaves printed; 90
    dw7x7 launches against 36."""
    import torch

    from unicorn_torch.core.train_step import uni_loss_fn
    from unicorn_torch.exp.unicorn_track_tiny import Exp

    exp32 = Exp()
    for k, v in {**TRAINER_EXP_FIELDS, "bf16": False}.items():
        setattr(exp32, k, v)
    fp32 = exp32.get_model(torch.Generator().manual_seed(0)).to(
        DEVICE).train()
    for label, (texp, model), bound in (
            ("fp32, TF32 off", (exp32, fp32), 1e-5),
            ("bf16, as trained", _train_model(report), 0.02)):
        images, targets, task_ids = _train_batch(texp, 2, seed=32, n_obj=8)
        task_ids[0] = 1
        kw = _uni_loss_kwargs(texp)
        out = {}
        for bmap, launches in ((False, TRAIN_LAUNCHES),
                               (True, MAP_LAUNCHES)):
            _reset_all_counts()
            with (tf32_off() if model is fp32 else contextlib.nullcontext()):
                loss, _, grads = _loss_and_grads(model, lambda: uni_loss_fn(
                    model, images, targets, task_ids, backbone_map=bmap,
                    **kw))
            counts = _all_counts()
            out[bmap] = (loss, grads)
            assert counts == launches, (bmap, counts)
            _record_launches(report, f"uni_backbone_map_{bmap}", counts)
        rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
        shares, worst, median = _grad_shares(out[False][1], out[True][1])
        print(f"backbone_map on one unicorn_track_tiny uni step, {label} "
              f"(B={TRAIN_B} pairs, the 4 frames' trunk at batch 1): "
              f"total_loss {out[True][0]:.6f} vs {out[False][0]:.6f} (rel "
              f"{rel:.2e}, bound {bound:g}); gradient leaves worst "
              f"{shares[worst]:.3e} of its max at {worst}, median "
              f"{median:.3e}; launches {MAP_LAUNCHES}")
        assert rel <= bound, (label, rel)
    del fp32
    torch.cuda.empty_cache()


# ------------------------------------------- other backbones, every exp
BACKBONE_FRAMES = 16      # timed frames of each driver run of the phase
BACKBONE_WARMUP = 3       # untimed frames before them
BACKBONE_UNI_STEPS = 8    # timed uni steps of unicorn_track_r50
BACKBONE_STEPS = 4        # timed det and mask-stage steps of the r50 exps
BACKBONE_FORWARDS = 8     # timed forward_whole calls of the Swin-T model
# Launches, predicted from the code before the first run. ResNet-50 and
# Swin have no dw7x7 in the trunk; the head's 3 levels x 3 attention
# blocks keep theirs: 9 a frame against ConvNeXt-Tiny's 27; a uni or a
# VOS + MOTS step calls the head twice (18 against 36), a det step once.
# The interaction and the correlation run as on ConvNeXt-Tiny.
HEAD_ONLY_FRAME = dict(dwconv7x7=9, msda_factored=0, msda_direct=0,
                       correlation=0)
HEAD_ONLY_SOT = dict(SOT_LAUNCHES, dwconv7x7=9)
HEAD_ONLY_UNI = dict(TRAIN_LAUNCHES, dwconv7x7=18)
HEAD_ONLY_DET = dict(DET_LAUNCHES, dwconv7x7=9)
HEAD_ONLY_MASK = dict(MASK_TRAIN_LAUNCHES, dwconv7x7=18)
TINY_FRAME = dict(HEAD_ONLY_FRAME, dwconv7x7=27)   # unicorn_track_tiny_rt's


def _backbone_exp(name, **fields):
    """The port's copy of exps/default/<name>.py through get_exp, with
    TRAINER_EXP_FIELDS and `fields` set on it."""
    from unicorn_torch.exp.base import get_exp

    exp = get_exp(exp_name=name)
    for k, v in {**TRAINER_EXP_FIELDS, **fields}.items():
        setattr(exp, k, v)
    return exp


def _raise_priors(model):
    """The obj / cls prediction biases raised by 6, so that the
    random-weight detector's scores clear ByteTrack's thresholds."""
    import torch

    with torch.no_grad():
        for name, p in model.head.named_parameters():
            if name.startswith(("obj_preds.", "cls_preds.")) and \
                    name.endswith(".bias"):
                p.add_(6.0)


def _sot_path(label, exp, model, n, seed=4):
    """SOTDriver.initialize on a synthetic FRAME_HW frame, 2 untimed track
    calls, initialize again, n timed track calls, then their stages
    synchronised apart; prints frames/s, launches and peak memory; returns
    (frames/s, launch counts)."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.sot import SOTDriver

    driver = SOTDriver(model, input_size=exp.test_size, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    frames = _sot_frames(n, seed)
    driver.initialize(frames[0], INIT_BOX)
    for f in frames[1:3]:                      # warm-up, not counted
        driver.track(f)
    driver.initialize(frames[0], INIT_BOX)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    boxes = [driver.track(f)["target_bbox"] for f in frames[1:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    print(f"{label}: track x {n}, {FRAME_HW[0]}x{FRAME_HW[1]} -> "
          f"{exp.test_size}: {n / wall:.2f} frames/s ({wall / n * 1e3:.2f} "
          f"ms/frame); launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    _sot_stage_ms(label, driver, frames[1:])
    for x, y, w, h in boxes:
        assert np.isfinite([x, y, w, h]).all() and w > 0 and h > 0
    return n / wall, counts


def _serving_paths(report, name, label, frame, sot):
    """The served model of exp `name` (bf16, seed 0): one MOT frame
    (`_forward_whole_check`) and one SOT frame (`_sot_frame_check`) kernels
    vs plain, then `_mot_path` and `_sot_path`; launches a frame as
    `frame` / `sot`."""
    import torch

    exp = _backbone_exp(name)
    model = exp.get_model(torch.Generator().manual_seed(0),
                          serve=True).to(DEVICE).eval()
    _forward_whole_check(f"{label} forward_whole", exp, model,
                         frame["dwconv7x7"])
    _sot_frame_check(f"{label} sot frame", exp, model, sot)
    _raise_priors(model)
    _, counts, _, _ = _mot_path(f"{label} mot path", exp, model,
                                BACKBONE_FRAMES, BACKBONE_WARMUP)
    print(f"  launches a frame predicted {frame}")
    assert counts == {k: n * BACKBONE_FRAMES for k, n in frame.items()}, \
        counts
    _record_launches(report, f"{label}_mot", counts)
    _, counts = _sot_path(f"{label} sot path", exp, model, BACKBONE_FRAMES)
    print(f"  launches a frame predicted {sot}")
    assert counts == {k: n * BACKBONE_FRAMES for k, n in sot.items()}, \
        counts
    _record_launches(report, f"{label}_sot", counts)
    del model
    torch.cuda.empty_cache()


def _backbones_r50_training(report):
    """unicorn_track_r50's uni step at B = 2 pairs (kernels vs plain at
    train_model's bounds, 2 + BACKBONE_UNI_STEPS timed), then one det step
    of unicorn_det_r50_800x1280 and one mask-only VOS + MOTS step of
    unicorn_track_r50_mask (each kernels vs plain, 2 + BACKBONE_STEPS
    timed)."""
    import torch

    from unicorn_torch.core.train_state import TrainState
    from unicorn_torch.core.train_step import (det_loss_fn,
                                               make_det_train_step,
                                               uni_loss_fn, uni_mask_loss_fn)
    from unicorn_torch.losses import uni as uni_mod
    from unicorn_torch.losses import vos as vos_mod

    gen = torch.Generator().manual_seed(0)
    exp = _backbone_exp("unicorn_track_r50")
    model = exp.get_model(gen).to(DEVICE).train()
    H, W = exp.input_size
    images, targets, task_ids = _train_batch(exp, 2, seed=50, n_obj=8)
    task_ids[0] = 1
    kw = _uni_loss_kwargs(exp)

    def run():
        return _loss_and_grads(model, lambda: uni_loss_fn(
            model, images, targets, task_ids, **kw))

    _kernel_check_report(f"r50 uni step {H}x{W}, B={TRAIN_B} pairs",
                         *_kernels_vs_plain(run, (uni_mod,)), HEAD_ONLY_UNI)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    batches = [_train_batch(exp, 1, seed=51, n_obj=1),
               _train_batch(exp, 2, seed=52, n_obj=12)]
    _, counts, _ = _timed_steps(
        exp.get_train_step(TRAIN_B), state, batches, HEAD_ONLY_UNI,
        f"r50 uni train path, B={TRAIN_B} pairs of {H}x{W}, AdamW, "
        f"grad_accum {state.tx.grad_accum}, EMA", "pairs",
        BACKBONE_UNI_STEPS)
    _record_launches(report, "r50_train", counts)
    del state, model
    torch.cuda.empty_cache()

    exp = _backbone_exp("unicorn_det_r50_800x1280")
    model = exp.get_model(gen.manual_seed(0)).to(DEVICE).train()
    batches = [_det_batch(exp, seed) for seed in (53, 54)]

    def run():
        return _loss_and_grads(model, lambda: det_loss_fn(
            model, *batches[0], exp.input_size))

    _kernel_check_report(f"r50 det step {H}x{W}, B={TRAIN_B}",
                         *_kernels_vs_plain(run, ()), HEAD_ONLY_DET)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, MASK_TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    _, counts, _ = _timed_steps(
        make_det_train_step(exp.input_size, exp.always_l1), state, batches,
        HEAD_ONLY_DET, f"r50 det train path, B={TRAIN_B} images of "
        f"{H}x{W}, SGD, EMA", "images", BACKBONE_STEPS)
    _record_launches(report, "r50_det", counts)
    del state, model
    torch.cuda.empty_cache()

    exp = _backbone_exp("unicorn_track_r50_mask")
    model = exp.get_model(gen.manual_seed(0)).to(DEVICE).train()
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, MASK_TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    batches = [_mask_train_batch(exp, seed) for seed in (55, 56)]
    kw = dict(mot_weight=float(exp.mot_weight) if exp.scale_all_mot else 1.0,
              bidirect=exp.bidirect, use_l1=exp.always_l1,
              up_rate=exp.up_rate)

    def run():
        return _loss_and_grads(model, lambda: uni_mask_loss_fn(
            model, *batches[0], exp.input_size, **kw))

    _kernel_check_report(
        f"r50 mask step {H}x{W}, B={TRAIN_B} pairs (VOS, MOTS), mask-only",
        *_kernels_vs_plain(run, (vos_mod,)), HEAD_ONLY_MASK)
    _, counts, _ = _timed_steps(
        exp.get_train_step(TRAIN_B), state, batches, HEAD_ONLY_MASK,
        f"r50 mask train path, B={TRAIN_B} pairs of {H}x{W} (VOS, MOTS), "
        f"AdamW, mask-only", "pairs", BACKBONE_STEPS)
    _record_launches(report, "r50_mask_train", counts)
    del state, model
    torch.cuda.empty_cache()


def _backbones_swin(report):
    """A Swin-T Unicorn (unicorn_track_tiny's fields with backbone_name
    swin_tiny: in_channels 192 / 384 / 768 at width 1.0, so no adjust
    convs): forward_whole kernels vs plain and its ms a frame (bf16,
    served); one uni step (bf16 as trained) under remat False twice and
    True, with cuDNN and PyTorch's deterministic algorithms on (the ops
    without one warn, and are named): the loss and every gradient leaf of
    remat True within the two remat False runs' spread."""
    import warnings

    import numpy as np
    import torch

    from unicorn_torch.core.train_step import uni_loss_fn

    exp = _backbone_exp("unicorn_track_tiny", backbone_name="swin_tiny")
    gen = torch.Generator().manual_seed(0)
    model = exp.get_model(gen, serve=True).to(DEVICE).eval()
    _forward_whole_check("swin-t forward_whole", exp, model,
                         HEAD_ONLY_FRAME["dwconv7x7"])
    H, W = exp.test_size
    x = torch.from_numpy((np.random.RandomState(5).rand(1, 3, H, W) * 255)
                         .astype(np.float32)).to(DEVICE)
    times = []
    with torch.inference_mode():
        for t in range(BACKBONE_WARMUP + BACKBONE_FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward_whole(x)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    times = times[BACKBONE_WARMUP:]
    print(f"swin-t forward_whole {H}x{W} bf16: median "
          f"{np.median(times):.2f} ms a frame (min {min(times):.2f}, "
          f"{len(times)} calls)")
    del model
    torch.cuda.empty_cache()

    model = exp.get_model(gen.manual_seed(0)).to(DEVICE).train()
    trunk = model.backbone.backbone
    H, W = exp.input_size
    images, targets, task_ids = _train_batch(exp, 2, seed=57, n_obj=8)
    task_ids[0] = 1
    kw = _uni_loss_kwargs(exp)
    runs, flags = {}, (torch.backends.cudnn.deterministic,
                       torch.are_deterministic_algorithms_enabled(),
                       torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for key, remat in (("False", False), ("spread", False),
                               ("True", True)):
                trunk.remat = remat
                _reset_all_counts()
                t0 = time.perf_counter()
                loss, _, grads = _loss_and_grads(model, lambda: uni_loss_fn(
                    model, images, targets, task_ids, **kw))
                ms = (time.perf_counter() - t0) * 1e3
                counts = _all_counts()
                runs[key] = (loss, {k: g.cpu() for k, g in grads.items()})
                print(f"swin-t uni step {H}x{W}, B={TRAIN_B} pairs, remat "
                      f"{remat}: loss {loss:.6f}, {ms:.1f} ms (forward + "
                      f"backward, deterministic algorithms), launches "
                      f"{counts} (predicted {HEAD_ONLY_UNI})")
                assert counts == HEAD_ONLY_UNI, counts
                assert np.isfinite(loss)
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])
        trunk.remat = False
    without = sorted({str(w.message).split(" does not have")[0][:80]
                      for w in caught})
    print(f"  ops without a deterministic algorithm: {without or 'none'}")
    _record_launches(report, "swin_uni", counts)
    loss0, grads0 = runs["False"]
    spread_loss = abs(runs["spread"][0] - loss0)
    spread = max(_grad_shares(grads0, runs["spread"][1])[0].values())
    shares, worst, median = _grad_shares(grads0, runs["True"][1])
    print(f"  remat True against False: loss {runs['True'][0] - loss0:+.3e} "
          f"(two-run spread {spread_loss:.3e}); worst gradient leaf "
          f"{shares[worst]:.3e} of its max at {worst}, median {median:.3e} "
          f"(two-run spread {spread:.3e}, the bound)")
    assert abs(runs["True"][0] - loss0) <= spread_loss
    assert shares[worst] <= spread
    del model, runs
    torch.cuda.empty_cache()


def _backbones_every_exp(report):
    """Every exp of unicorn_torch/exp/ (the 18 of exps/default/) through
    get_exp, its model built on the card (a generator on the card, so that
    the init runs there) and its parameters counted (kept in
    report["exp_params"])."""
    import torch

    from unicorn_torch.exp.base import EXP_DIR, get_exp

    names = sorted(f[:-3] for f in os.listdir(EXP_DIR)
                   if f.startswith("unicorn_") and f.endswith(".py"))
    assert len(names) == 18, names
    for name in names:
        exp = get_exp(exp_name=name)
        t0 = time.perf_counter()
        with torch.device(DEVICE):
            model = exp.get_model(torch.Generator(DEVICE).manual_seed(0))
        model.to(DEVICE)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        n = sum(p.numel() for p in model.parameters())
        report.setdefault("exp_params", {})[name] = n
        on_card = {p.device.type for p in model.parameters()} | {
            b.device.type for b in model.buffers()}
        print(f"  {name}: {type(model).__name__} on {exp.backbone_name} "
              f"(in_channels {exp.in_channels}, width {exp.width}), "
              f"{n:,} parameters, built in {ms:.0f} ms")
        assert on_card == {torch.device(DEVICE).type}, on_card
        del model
        torch.cuda.empty_cache()


def phase_backbones(report):
    """The ResNet-50 and Swin backbones, the real-time setting and every
    exp, all from seed 0, served in bf16 at the exps' sizes:
    (a) unicorn_track_r50 through get_exp: one MOT and one SOT frame
    kernels vs plain, MOTDriver and SOTDriver (BACKBONE_WARMUP +
    BACKBONE_FRAMES 1080x1920 frames each): frames/s, per-stage ms,
    launches a frame (9 dw7x7: the head's only), peak memory;
    (b) `_backbones_r50_training`; (c) `_backbones_swin`;
    (d) unicorn_track_tiny_rt at 640x1024 as (a), 27 dw7x7 a frame;
    (e) `_backbones_every_exp`."""
    print(f"backbones ({report.get('card', '')})")
    _serving_paths(report, "unicorn_track_r50", "r50", HEAD_ONLY_FRAME,
                   HEAD_ONLY_SOT)
    _backbones_r50_training(report)
    _backbones_swin(report)
    _serving_paths(report, "unicorn_track_tiny_rt", "tiny_rt", TINY_FRAME,
                   SOT_LAUNCHES)
    print("every exp, its model built on the card:")
    _backbones_every_exp(report)


# ------------------------------------------------------------ phase eval
EVAL_ROOT = os.path.join(ROOT, "chiprun_out", "eval_data")
EVAL_IMAGES = 8           # 1080x1920 images of the COCO-format val sets
EVAL_BDD_VIDEOS = 2       # BDD100K seg_track videos ...
EVAL_BDD_FRAMES = 4       # ... of this many 720x1280 frames
EVAL_BDD_HW = (720, 1280)
EVAL_TRAIN_SAMPLES = 4    # pairs of the trainer run: 2 iterations at B = 2
EVAL_EXP_FIELDS = {}      # fields set on every exp of the phase
# launches an image (COCO box and inst eval) and a BDD frame
EVAL_LAUNCHES = dict(dwconv7x7=27, msda_factored=0, msda_direct=0,
                     correlation=0)
EVAL_OMNI_LAUNCHES = dict(EVAL_LAUNCHES, msda_factored=1)


def _eval_boxes(rng, h, w):
    """2-4 boxes an image, one to a quadrant (no two overlap, so that the
    NMS keeps every ground-truth box), 300-534 px on a 6-px grid: the
    1080x1920 -> 800x1280 letterbox maps them onto the stride-4 mask grid
    exactly, and a mask decoded from that grid overlaps its box at IoU >=
    0.95 (the ground-truth forwards score AP 1.0)."""
    boxes = []
    for q in rng.permutation(4)[:rng.randint(2, 5)]:
        qy, qx = (q // 2) * h // 2, (q % 2) * w // 2
        bh, bw = 6 * rng.randint(50, 90, 2)
        y = qy + 6 * rng.randint(0, (h // 2 - bh) // 6)
        x = qx + 6 * rng.randint(0, (w // 2 - bw) // 6)
        boxes.append((int(x), int(y), int(bw), int(bh)))
    return boxes


def _write_eval_sets(root):
    """The COCO-format MOT val set (mot/annotations/test.json, mot/test/)
    and the COCO val set (coco/annotations/instances_val2017.json with RLE
    masks, coco/val2017/) on EVAL_IMAGES copies of the fixture frames with
    seeded boxes (`_eval_boxes`), and the BDD100K seg_track layout (PNG
    frames of the fixture resized to 720x1280 and panning, labels with
    box2d and RLE) under root. Returns {image id: boxes}."""
    import shutil

    import numpy as np

    from unicorn_torch.data.image_io import imread, write_png
    from unicorn_torch.data.preproc import resize_linear
    from unicorn_torch.evaluators import rle

    H, W = 1080, 1920
    rng = np.random.RandomState(21)
    images, anns, gt = [], [], {}
    for i in range(EVAL_IMAGES):
        name = f"{i + 1:06d}.jpg"
        for sub in (("mot", "test"), ("coco", "val2017")):
            os.makedirs(os.path.join(root, *sub), exist_ok=True)
            shutil.copyfile(os.path.join(FIXTURES, DISK_FRAMES[i % 2]),
                            os.path.join(root, *sub, name))
        images.append({"id": i + 1, "file_name": name, "height": H,
                       "width": W, "frame_id": i + 1, "video_id": 1})
        gt[i + 1] = _eval_boxes(rng, H, W)
        for x, y, w, h in gt[i + 1]:
            m = np.zeros((H, W), np.uint8)
            m[y:y + h, x:x + w] = 1
            anns.append({"id": len(anns) + 1, "image_id": i + 1,
                         "category_id": 1, "bbox": [x, y, w, h],
                         "area": w * h, "iscrowd": 0, "track_id": len(anns),
                         "segmentation": rle.encode(m)})
    cats = [{"id": 1, "name": "pedestrian"}]
    for sub, ann in (("mot", "test.json"),
                     ("coco", "instances_val2017.json")):
        os.makedirs(os.path.join(root, sub, "annotations"), exist_ok=True)
        with open(os.path.join(root, sub, "annotations", ann), "w") as f:
            json.dump({"images": images, "annotations": anns,
                       "categories": cats}, f)
    # BDD100K seg_track: panning frames, three moving objects
    bh, bw = EVAL_BDD_HW
    big = resize_linear(imread(os.path.join(FIXTURES, DISK_FRAMES[0])),
                        (bw + 8 * EVAL_BDD_FRAMES, bh))
    frames = []
    for v in range(EVAL_BDD_VIDEOS):
        video = f"bdd{v}"
        os.makedirs(os.path.join(root, "bdd", "images", "track", "val",
                                 video), exist_ok=True)
        for t in range(EVAL_BDD_FRAMES):
            name = f"{video}-{t:07d}.png"
            img = big[:, 8 * t:8 * t + bw, ::-1]   # written RGB, read BGR
            write_png(os.path.join(root, "bdd", "images", "track", "val",
                                   video, name), np.ascontiguousarray(img))
            labels = []
            for k, cat in enumerate(("car", "pedestrian", "car")):
                x, y = 100 + 350 * k + 6 * t + 40 * v, 200 + 60 * k
                m = np.zeros((bh, bw), np.uint8)
                m[y:y + 180, x:x + 240] = 1
                labels.append({"id": 10 * v + k + 1, "category": cat,
                               "box2d": {"x1": float(x), "y1": float(y),
                                         "x2": float(x + 240),
                                         "y2": float(y + 180)},
                               "rle": rle.encode(m)})
            frames.append({"name": name, "videoName": video,
                           "frameIndex": t, "labels": labels})
    lbl = os.path.join(root, "bdd", "labels", "seg_track_20", "rles")
    os.makedirs(lbl, exist_ok=True)
    with open(os.path.join(lbl, "val.json"), "w") as f:
        json.dump(frames, f)
    return gt


def _eval_exp(name, **fields):
    """The port's exp `name` with EVAL_EXP_FIELDS and `fields` set."""
    return _backbone_exp(name, **{**EVAL_EXP_FIELDS, **fields})


def _eval_native(report):
    """(a) The native codecs against their plain forms, bit for bit, on
    seeded 720x1280 masks (encode, string, decode, merge, IoU) and IoU
    matrices (COCOeval's matcher); the encode and IoU ms each way."""
    import numpy as np

    from unicorn_torch.csrc import native
    from unicorn_torch.evaluators import coco_map, rle

    rng = np.random.RandomState(3)
    H, W = 720, 1280
    masks = []
    for _ in range(6):
        m = np.zeros((H, W), np.uint8)
        for _ in range(rng.randint(1, 4)):
            y, x = rng.randint(0, H), rng.randint(0, W)
            m[y:y + rng.randint(1, H), x:x + rng.randint(1, W)] = 1
        m ^= (rng.rand(H, W) < 0.01).astype(np.uint8)
        masks.append(m)
    t_n = t_p = 0.0
    enc = []
    for m in masks:
        t0 = time.perf_counter()
        c = rle.encode(m)
        t1 = time.perf_counter()
        p = rle.compress_plain(rle.encode_counts_plain(m))
        t_n += t1 - t0
        t_p += time.perf_counter() - t1
        assert c == p
        assert rle.decompress(c) == rle.decompress_plain(c)
        assert np.array_equal(rle.decode(c), m)
        assert np.array_equal(rle.decode_plain(c), m)
        assert rle.area(c) == rle.area_plain(c) == int(m.sum())
        enc.append(c)
    for inter in (False, True):
        assert rle.merge(enc[:3], inter) == rle.merge_plain(enc[:3], inter)
    t0 = time.perf_counter()
    iou = rle.iou_rle(enc[:3], enc[3:], [0, 1, 0])
    t1 = time.perf_counter()
    iou_p = rle.iou_rle_plain(enc[:3], enc[3:], [0, 1, 0])
    t2 = time.perf_counter()
    assert np.array_equal(iou.view(np.int64), iou_p.view(np.int64))
    n_cases = 0
    for _ in range(40):
        D, G = rng.randint(1, 60), rng.randint(1, 30)
        ious = rng.rand(D, G)
        gt_ig = np.sort(rng.rand(G) < 0.3)
        crowd = gt_ig & (rng.rand(G) < 0.5)
        a = native.evaluate_img(ious, gt_ig, crowd, coco_map.IOU_THRS)
        b = coco_map.match_plain(ious, gt_ig, crowd, coco_map.IOU_THRS)
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        n_cases += 1
    print(f"  (a) native rle / cocoeval equal to the plain forms on "
          f"{len(masks)} masks of {H}x{W} and {n_cases} matcher cases; "
          f"encode {t_n / len(masks) * 1e3:.2f} ms a mask native vs "
          f"{t_p / len(masks) * 1e3:.2f} plain; IoU 3x3 "
          f"{(t1 - t0) * 1e3:.2f} ms native vs {(t2 - t1) * 1e3:.2f} plain "
          f"(host, {report.get('card', '')})")


def _gt_decoded(ev, gt, num_classes):
    """A forward_fn for COCOEvaluator `ev` that decodes to the ground truth
    of each image of the batch (cxcywh in letterbox coordinates, obj 1,
    class 0 at 1), the other anchors zero."""
    import torch

    H, W = ev.img_size
    A = sum((H // s) * (W // s) for s in (8, 16, 32))
    order = [ev.dataset.ids[i] for i in range(len(ev.dataset))]

    def forward(images):
        B = images.shape[0]
        out = torch.zeros(B, A, 5 + num_classes, device=images.device)
        for b in range(B):
            img_id = order[forward.n + b]
            im = ev.dataset.coco.imgs[img_id]
            r = min(H / im["height"], W / im["width"])
            for k, (x, y, w, h) in enumerate(gt[img_id]):
                out[b, k] = torch.tensor([(x + w / 2) * r, (y + h / 2) * r,
                                          w * r, h * r, 1.0, 1.0]
                                         + [0.0] * (num_classes - 1))
        forward.n += B
        return out
    forward.n = 0
    return forward


def _eval_coco(report, gt):
    """(b) ExpTrack.get_trainer_evaluator of unicorn_track_tiny (COCO box
    AP over the MOT val set) at 800x1280: the ground-truth forward scores
    AP 1.0; the served bf16 model (seed 0, biases raised) through the
    dw7x7 kernel: finite metrics, 27 launches an image, its decoded
    outputs against the plain version's (phase model's bound, 0.05 on the
    scores); images/s and ms an image of load, forward, NMS and mAP."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.device import images_to_device
    from unicorn_torch.evaluators.coco_evaluator import decode_forward
    from unicorn_torch.models import blocks
    from unicorn_torch.ops import dwconv7x7 as dw

    exp = _eval_exp("unicorn_track_tiny")
    ev = exp.get_trainer_evaluator(device=DEVICE)
    m_gt = ev.evaluate(_gt_decoded(ev, gt, exp.num_classes))
    print(f"  (b) ground-truth forward: AP {m_gt['AP']}, AP50 "
          f"{m_gt['AP50']}, AR {m_gt['AR']}, {m_gt['n_images']} images")
    assert m_gt["AP"] == 1.0 and m_gt["n_images"] == EVAL_IMAGES, m_gt

    model = exp.get_model(torch.Generator().manual_seed(0), serve=True)
    _raise_priors(model)
    model = model.to(DEVICE).eval()
    forward = decode_forward(model)
    decs = {"kernel": [], "plain": []}

    def recording(key):
        def f(images):
            d = forward(images)
            decs[key].append(d.float().clone())
            return d
        return f

    ev.evaluate(forward, max_images=1)          # warm-up
    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    metrics = ev.evaluate(recording("kernel"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    n0 = dw.launches
    with mock.patch.object(blocks, "dwconv7x7", dw.dwconv7x7_plain):
        m_plain = ev.evaluate(recording("plain"))
    assert dw.launches == n0, "the plain run launched the kernel"
    d_score = max((a[..., 4:] - b[..., 4:]).abs().max().item()
                  for a, b in zip(decs["kernel"], decs["plain"]))
    d_box = max(((a[..., :4] - b[..., :4]).abs()
                 / b[..., :4].abs().clamp_min(1.0)).max().item()
                for a, b in zip(decs["kernel"], decs["plain"]))
    # the stages apart, synchronised
    stages = {"load": [], "forward": [], "nms": []}
    results = []
    with torch.inference_mode():
        for i in range(EVAL_IMAGES):
            t = [time.perf_counter()]
            imgs, infos, ids = ev.load([i])
            x = images_to_device(imgs, ev.device)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            dec = forward(x)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            results += ev.to_coco(ev.nms(dec), infos, ids)
            t.append(time.perf_counter())
            for k, name in enumerate(stages):
                stages[name].append((t[k + 1] - t[k]) * 1e3)
    t0 = time.perf_counter()
    m_stage = ev.score(results, EVAL_IMAGES)
    t_map = (time.perf_counter() - t0) * 1e3
    keys = ("AP", "AP50", "AP75", "APs", "APm", "APl", "AR")
    print(f"  (b) model ({report.get('card', '')}): {EVAL_IMAGES} images "
          f"1080x1920 -> {ev.img_size}, {EVAL_IMAGES / wall:.2f} images/s "
          f"({wall / EVAL_IMAGES * 1e3:.1f} ms an image, evaluate() "
          f"whole); per image (median, synchronised): "
          + ", ".join(f"{k} {np.median(v):.2f} ms" for k, v in stages.items())
          + f", mAP {t_map / EVAL_IMAGES:.2f} ms ({t_map:.1f} ms for the "
          f"set); {len(results)} results; launches {counts}")
    print(f"  (b) kernel vs plain: max |d score| {d_score:.3e} (tol 0.05), "
          f"max rel |d box| {d_box:.3e}; AP {metrics['AP']:.4f} vs "
          f"{m_plain['AP']:.4f}; metrics {({k: metrics[k] for k in keys})}")
    assert all(np.isfinite(metrics[k]) for k in keys)
    assert metrics["n_images"] == EVAL_IMAGES
    assert {k: m_stage[k] for k in keys} == {k: metrics[k] for k in keys}
    assert counts == {k: v * EVAL_IMAGES for k, v in EVAL_LAUNCHES.items()}, \
        counts
    assert d_score <= 0.05, d_score
    _record_launches(report, "eval_coco", counts)
    del model
    torch.cuda.empty_cache()


def _eval_inst(report, gt):
    """(c) ExpDetMask.get_evaluator of unicorn_inst_convnext_tiny_800x1280
    (box and mask AP) over the COCO val set of the same images with
    masks: the ground-truth forward scores box and mask AP 1.0; the bf16
    inst model (seed 0, biases raised) through get_inst_forward: finite
    metrics, 27 dw7x7 launches an image, ms an image."""
    import numpy as np
    import torch

    exp = _eval_exp("unicorn_inst_convnext_tiny_800x1280")
    ev = exp.get_evaluator(device=DEVICE)
    H, W = ev.img_size
    Hm, Wm = H // exp.d_rate, W // exp.d_rate
    order = [ev.dataset.ids[i] for i in range(len(ev.dataset))]
    n = {"i": 0}

    def gt_forward(images):
        img_id = order[n["i"]]
        n["i"] += 1
        im = ev.dataset.coco.imgs[img_id]
        r = min(H / im["height"], W / im["width"])
        boxes = gt[img_id]
        dets = torch.zeros(8, 7, device=images.device)
        masks = torch.zeros(8, Hm, Wm, device=images.device)
        for k, (x, y, w, h) in enumerate(boxes):
            dets[k] = torch.tensor([x * r, y * r, (x + w) * r, (y + h) * r,
                                    1.0, 1.0, 0.0])
            g = r / exp.d_rate            # image px -> mask grid
            masks[k, round(y * g):round((y + h) * g),
                  round(x * g):round((x + w) * g)] = 1.0
        valid = torch.arange(8, device=images.device) < len(boxes)
        return dets, valid, masks

    m_gt = ev.evaluate(gt_forward)
    print(f"  (c) ground-truth forward: box AP {m_gt['box_AP']}, mask AP "
          f"{m_gt['mask_AP']}, {m_gt['n_images']} images")
    assert m_gt["box_AP"] == 1.0 and m_gt["mask_AP"] == 1.0, m_gt

    model = exp.get_model(torch.Generator().manual_seed(0))
    _raise_priors(model)
    forward = exp.get_inst_forward(model, device=DEVICE)
    ev.evaluate(forward, max_images=1)          # warm-up
    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    metrics = ev.evaluate(forward)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    keys = [k for k in metrics if k.startswith(("box_", "mask_"))]
    print(f"  (c) model ({report.get('card', '')}): {EVAL_IMAGES} images, "
          f"{EVAL_IMAGES / wall:.2f} images/s ({wall / EVAL_IMAGES * 1e3:.1f}"
          f" ms an image: forward, decode + NMS, masks, the host resize and "
          f"RLE of every kept mask); launches {counts}; box AP "
          f"{metrics['box_AP']:.4f}, mask AP {metrics['mask_AP']:.4f}")
    assert all(np.isfinite(metrics[k]) for k in keys)
    assert metrics["n_images"] == EVAL_IMAGES
    assert counts == {k: v * EVAL_IMAGES for k, v in EVAL_LAUNCHES.items()}, \
        counts
    _record_launches(report, "eval_inst", counts)
    del model, forward
    torch.cuda.empty_cache()


def _bitmask(labels, shape):
    """The seg_track bitmask write_bdd_bitmask paints from scalabel labels
    (ascending score, R = class + 1, B / A = the id's bytes)."""
    import numpy as np

    from unicorn_torch.evaluators import bdd_evaluator as bdd
    from unicorn_torch.evaluators import rle

    bm = np.zeros(shape + (4,), np.uint8)
    order = np.argsort([lab["score"] for lab in labels], kind="stable")
    for k in order:
        lab = labels[k]
        tid = int(lab["id"])
        bm[rle.decode(lab["rle"]).astype(bool)] = (
            bdd.BDD_CLASSES.index(lab["category"]) + 1, 0, (tid >> 8) & 255,
            tid & 255)
    return bm


def _eval_bdd(report, out_dir):
    """(d) BDDEvaluator.evaluate_mot and evaluate_seg_mot on the
    BDD100K layout (EVAL_BDD_VIDEOS x EVAL_BDD_FRAMES frames of
    720x1280) with MOTOmniDriver as `_omni_driver` builds it on the served
    unicorn_track_tiny_mask model (without and with masks): launches a
    frame (27 dw7x7, 1 MSDA, as phase omni), every bitmask PNG read back
    by the port's reader equal to the labels it was painted from, the
    scalabel scores finite; ms a frame."""
    import numpy as np
    import torch

    from unicorn_torch.data.datasets.bdd import BDDEvalDataset
    from unicorn_torch.data.image_io import read_png
    from unicorn_torch.drivers.mot import MOTOmniDriver
    from unicorn_torch.evaluators.bdd_evaluator import (
        BDDEvaluator, score_scalabel, score_scalabel_seg)

    root = os.path.join(EVAL_ROOT, "bdd")
    ds = BDDEvalDataset(root, split="val", label_path=os.path.join(
        root, "labels", "seg_track_20", "rles", "val.json"))
    n = len(ds)
    assert n == EVAL_BDD_VIDEOS * EVAL_BDD_FRAMES
    # the served mask model, as `_vos_model` builds it
    exp, model = _served_model(
        report, "vos_model", lambda: _eval_exp("unicorn_track_tiny_mask"))
    for with_mask in (False, True):
        drv = MOTOmniDriver(model, exp.test_size, num_classes=exp.num_classes,
                            conf_thre=exp.test_conf, nms_thre=exp.nmsthre,
                            max_out=128, with_mask=with_mask, tracker="qd",
                            device=DEVICE)
        ev = BDDEvaluator(ds, exp.test_size, device=DEVICE)
        run = ev.evaluate_seg_mot if with_mask else ev.evaluate_mot
        run(drv, max_frames=1)                  # warm-up
        torch.cuda.synchronize()
        _reset_kernel_counts()
        t0 = time.perf_counter()
        results, frames = run(drv, out_dir=out_dir)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _kernel_counts()
        if with_mask:
            scores = score_scalabel_seg(frames, ds.gt_frames())
            n_png = 0
            for f in frames:
                path = os.path.join(out_dir, "seg_track", f["videoName"],
                                    os.path.splitext(f["name"])[0] + ".png")
                got = read_png(path)
                want = (_bitmask(f["labels"], EVAL_BDD_HW) if f["labels"]
                        else np.zeros((1, 1, 4), np.uint8))
                assert np.array_equal(got, want), path
                n_png += 1
            assert n_png == n
            keys = ("mMOTSA", "msMOTSA", "mIDF1")
        else:
            scores = score_scalabel(frames, ds.gt_frames())
            keys = ("mMOTA", "mIDF1")
        n_tracks = sum(len(fr["labels"]) for fr in frames)
        print(f"  (d) {'evaluate_seg_mot' if with_mask else 'evaluate_mot'} "
              f"({report.get('card', '')}): {n} frames {EVAL_BDD_HW} -> "
              f"{exp.test_size}, {wall / n * 1e3:.1f} ms a frame (with the "
              f"host's json{' and PNG' if with_mask else ''} writes); "
              f"{n_tracks} tracked labels; launches {counts} "
              f"({counts['dwconv7x7'] / n:.0f} dw7x7, "
              f"{counts['msda_factored'] / n:.0f} MSDA a frame; phase omni: "
              f"27 / 1); {({k: scores[k] for k in keys})}"
              + (f"; {n} bitmask PNGs read back equal" if with_mask else ""))
        assert all(np.isfinite(scores[k]) for k in keys)
        assert counts == {k: v * n for k, v in EVAL_OMNI_LAUNCHES.items()}, \
            counts
        _record_launches(report, "eval_bdd_seg" if with_mask else "eval_bdd",
                         counts)


def _eval_trainer(report, out_dir):
    """(e) Trainer.train on unicorn_track_tiny, one epoch of 2 iterations
    (B = 2 pairs of 800x1280 from the in-memory omni sets) with
    eval_interval 1, the model's obj and class-0 biases raised: the
    in-training eval runs get_trainer_evaluator over the MOT val images,
    whose ground truth here is the seeded model's own detections (score
    above 0.3), so that the EMA model after 2 small steps scores AP > 0;
    it must write an eval record to metrics.jsonl and `best`."""
    import numpy as np
    import torch

    from unicorn_torch.core.trainer import Trainer
    from unicorn_torch.device import images_to_device
    from unicorn_torch.evaluators.coco_evaluator import decode_forward
    from unicorn_torch.exp import unicorn_track_tiny as track

    class Raised(track.Exp):
        def get_model(self, generator=None, serve=False,
                      msda_method="auto"):
            model = super().get_model(generator, serve, msda_method)
            with torch.no_grad():
                for name, p in model.head.named_parameters():
                    if name.endswith(".bias"):
                        if name.startswith("obj_preds."):
                            p.add_(6.0)
                        elif name.startswith("cls_preds."):
                            p[0] += 6.0
            return model

    exp = _trainer_exp(Raised, out_dir, EVAL_TRAIN_SAMPLES, 1,
                       _uni_datasets(43), eval_interval=1,
                       test_data_dir=os.path.join(EVAL_ROOT, "mot"),
                       **EVAL_EXP_FIELDS)
    # the val json: the seeded model's detections as ground truth
    model = exp.get_model(torch.Generator().manual_seed(exp.seed or 0))
    model = model.to(DEVICE).eval()
    ev = exp.get_trainer_evaluator(device=DEVICE)
    forward = decode_forward(model)
    anns = []
    with torch.inference_mode():
        for i in range(len(ev.dataset)):
            imgs, infos, ids = ev.load([i])
            for r in ev.to_coco(ev.nms(forward(images_to_device(
                    imgs, ev.device))), infos, ids):
                if r["score"] > 0.3 and r["category_id"] == 1:
                    x, y, w, h = r["bbox"]
                    anns.append({"id": len(anns) + 1, "image_id": ids[0],
                                 "category_id": 1, "bbox": [x, y, w, h],
                                 "area": w * h, "iscrowd": 0})
    del model, forward
    d = dict(ev.dataset.coco.dataset, annotations=anns)
    with open(os.path.join(EVAL_ROOT, "mot", "annotations", "trainer.json"),
              "w") as f:
        json.dump(d, f)
    exp.test_ann = "trainer.json"
    tr = Trainer(exp, {"batch_size": TRAIN_B}, device=DEVICE)
    t0 = time.perf_counter()
    tr.train()
    wall = time.perf_counter() - t0
    with open(os.path.join(tr.output_dir, "metrics.jsonl")) as f:
        evals = [r for r in map(json.loads, f) if r.get("eval")]
    print(f"  (e) Trainer.train ({report.get('card', '')}): "
          f"{EVAL_TRAIN_SAMPLES // TRAIN_B} iterations and the in-training "
          f"eval ({len(anns)} ground-truth boxes from the seeded model) in "
          f"{wall:.1f} s; eval record {evals}; best written: "
          f"{os.path.isfile(os.path.join(tr.output_dir, 'best'))}")
    assert len(evals) == 1 and evals[0]["n_images"] == EVAL_IMAGES
    assert np.isfinite(evals[0]["AP"]) and evals[0]["AP"] > 0
    assert os.path.isfile(os.path.join(tr.output_dir, "best"))
    assert all(m.training for m in tr.state.model.modules())
    del tr
    torch.cuda.empty_cache()


def phase_eval(report):
    """The evaluators: (a) `_eval_native`, (b) `_eval_coco`, (c)
    `_eval_inst`, (d) `_eval_bdd`, (e) `_eval_trainer`, on the val sets
    that `_write_eval_sets` writes under chiprun_out/eval_data (removed
    when the phase passes)."""
    import shutil
    import tempfile

    print(f"eval ({report.get('card', '')})")
    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    gt = _write_eval_sets(EVAL_ROOT)
    print(f"  val sets written under {EVAL_ROOT} in "
          f"{time.perf_counter() - t0:.1f} s")
    env = os.environ.get("UNICORN_DATADIR")
    os.environ["UNICORN_DATADIR"] = EVAL_ROOT
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_eval_")
    try:
        _eval_native(report)
        _eval_coco(report, gt)
        _eval_inst(report, gt)
        _eval_bdd(report, os.path.join(tmp.name, "bdd"))
        _eval_trainer(report, os.path.join(tmp.name, "trainer"))
    finally:
        tmp.cleanup()
        if env is None:
            os.environ.pop("UNICORN_DATADIR", None)
        else:
            os.environ["UNICORN_DATADIR"] = env
    shutil.rmtree(EVAL_ROOT)


# ------------------------------------------------------------ phase harness
HARNESS_ROOT = os.path.join(ROOT, "chiprun_out", "harness_data")
HARNESS_GOT_FRAMES = 9      # frames of each GOT-10k val sequence (2)
HARNESS_LASOT = ("airplane-1", "basketball-1")
HARNESS_LASOT_FRAMES = 17   # frames of each LaSOT sequence: 2 windows of 8
HARNESS_DAVIS_FRAMES = 6    # frames of each DAVIS 2017 val sequence (2)
HARNESS_YT_FRAMES = 6       # frames of the YouTube-VOS sequence ...
HARNESS_YT_ENTRY = 3        # ... whose frame 3 annotation adds object 4
HARNESS_PACK_REPS = 20      # timed packs of an 800x1280x3 frame each way
HARNESS_CLI_EXPS = {"unicorn_sot": "unicorn_track_tiny",
                    "unicorn_vos": "unicorn_track_tiny_mask"}
# launches of a tracked frame (or a window of frames) and of the trunk alone
# (SOTDriver / VOSDriver initialize, VOSDriver add_objects)
HARNESS_FRAME = dict(SOT_LAUNCHES)
HARNESS_TRUNK = dict(dwconv7x7=18, msda_factored=0, msda_direct=0,
                     correlation=0)


def _harness_expect(n_trunk, n_frames):
    return {k: n_trunk * HARNESS_TRUNK[k] + n_frames * HARNESS_FRAME[k]
            for k in HARNESS_FRAME}


def _harness_box(rng):
    """An integer xywh box inside a 1080x1920 frame."""
    w, h = rng.randint(80, 400, 2)
    return [int(rng.randint(0, 1920 - w)), int(rng.randint(0, 1080 - h)),
            int(w), int(h)]


def _write_harness_layouts(root):
    """The benchmark layouts the harness reads, from the fixtures: GOT-10k
    val (list.txt, 2 sequences of HARNESS_GOT_FRAMES copies of the
    1080x1920 JPEG, seeded integer ground truth), LaSOT (HARNESS_LASOT,
    HARNESS_LASOT_FRAMES frames each), DAVIS 2017 val (2 sequences of
    HARNESS_DAVIS_FRAMES copies of the 480x854 JPEG and its 3-object
    palette mask) and YouTube-VOS 2018 valid (one sequence, objects 1-3
    annotated on frame 0, object 4 entering on frame HARNESS_YT_ENTRY, with
    meta.json). Returns {sequence name: (N, 4) ground truth} of the SOT
    sequences."""
    import shutil

    import numpy as np

    from unicorn_torch.data.image_io import read_indexed_mask, write_png

    rng = np.random.RandomState(19)
    jpg = os.path.join(FIXTURES, DISK_FRAMES[0])
    gts = {}

    def sot_seq(sdir, names, gt):
        os.makedirs(sdir, exist_ok=True)
        for name in names:
            shutil.copyfile(jpg, os.path.join(sdir, name))
        return np.asarray(gt, np.float64)

    got = os.path.join(root, "GOT10K", "val")
    names = [f"GOT-10k_Val_{k:06d}" for k in (7, 3)]   # list.txt's order
    for name in names:
        gt = [_harness_box(rng) for _ in range(HARNESS_GOT_FRAMES)]
        gts[name] = sot_seq(os.path.join(got, name), [
            f"{i + 1:08d}.jpg" for i in range(HARNESS_GOT_FRAMES)], gt)
        np.savetxt(os.path.join(got, name, "groundtruth.txt"), gts[name],
                   delimiter=",", fmt="%d")
    with open(os.path.join(got, "list.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    for name in HARNESS_LASOT:
        sdir = os.path.join(root, "LaSOT", name.split("-")[0], name)
        gt = [_harness_box(rng) for _ in range(HARNESS_LASOT_FRAMES)]
        gts[name] = sot_seq(os.path.join(sdir, "img"), [
            f"{i + 1:08d}.jpg" for i in range(HARNESS_LASOT_FRAMES)], gt)
        np.savetxt(os.path.join(sdir, "groundtruth.txt"), gts[name],
                   delimiter=",", fmt="%d")
    davis = os.path.join(root, "DAVIS")
    os.makedirs(os.path.join(davis, "ImageSets", "2017"))
    with open(os.path.join(davis, "ImageSets", "2017", "val.txt"), "w") as f:
        f.write("dogs\nhorses\n")
    src_jpg = os.path.join(FIXTURES, "davis_480x854.jpg")
    src_png = os.path.join(FIXTURES, "davis_480x854_mask.png")
    for name in ("dogs", "horses"):
        for t in range(HARNESS_DAVIS_FRAMES):
            for sub, src, ext in (("JPEGImages", src_jpg, "jpg"),
                                  ("Annotations", src_png, "png")):
                d = os.path.join(davis, sub, "480p", name)
                os.makedirs(d, exist_ok=True)
                shutil.copyfile(src, os.path.join(d, f"{t:05d}.{ext}"))
    yt = os.path.join(root, "ytbvos18", "valid")
    vid = "0062f687f1"
    stems = [f"{5 * t:05d}" for t in range(HARNESS_YT_FRAMES)]
    for stem in stems:
        d = os.path.join(yt, "JPEGImages", vid)
        os.makedirs(d, exist_ok=True)
        shutil.copyfile(src_jpg, os.path.join(d, f"{stem}.jpg"))
    mask = read_indexed_mask(src_png)
    entry = np.zeros_like(mask)                   # object 4: a new region
    entry[300:420, 600:780] = 4
    write_png(os.path.join(yt, "Annotations", vid, f"{stems[0]}.png"), mask)
    write_png(os.path.join(yt, "Annotations", vid,
                           f"{stems[HARNESS_YT_ENTRY]}.png"), entry)
    objs = {str(i): {"frames": [stems[0]]} for i in (1, 2, 3)}
    objs["4"] = {"frames": [stems[HARNESS_YT_ENTRY]]}
    with open(os.path.join(yt, "meta.json"), "w") as f:
        json.dump({"videos": {vid: {"objects": objs}}}, f)
    return gts


@contextlib.contextmanager
def _timed_attrs(pairs, tally):
    """Each (module, attribute) function of `pairs` timed into
    tally[attribute] (seconds)."""
    from unittest import mock

    def timed(fn, key):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                tally[key] = tally.get(key, 0.0) + time.perf_counter() - t0
        return wrapper

    with contextlib.ExitStack() as stack:
        for mod, attr in pairs:
            stack.enter_context(mock.patch.object(
                mod, attr, timed(getattr(mod, attr), attr)))
        yield


def _harness_cli(tracker, dataset, out):
    """tools/test.py main on the exp of HARNESS_CLI_EXPS -> (its return,
    the launches it made, seconds)."""
    import torch

    from unicorn_torch.tools import test as test_tool

    _reset_kernel_counts()
    t0 = time.perf_counter()
    res = test_tool.main([tracker, "--dataset", dataset, "-n",
                          HARNESS_CLI_EXPS[tracker], "--result-dir", out,
                          "--device", DEVICE])
    torch.cuda.synchronize()
    return res, _kernel_counts(), time.perf_counter() - t0


def _zip_numbers(path, delimiter):
    import zipfile

    import numpy as np

    with zipfile.ZipFile(path) as z:
        return {n: np.loadtxt(z.read(n).decode().splitlines(),
                              delimiter=delimiter, ndmin=1)
                for n in z.namelist()}


def _harness_sot(report, gts, out):
    """(a) tools/test.py unicorn_sot on GOT-10k val (the CLI's own seeded
    unicorn_track_tiny, 800x1280, bf16): a result txt of the sequence's
    frame count each, launches (18 dw7x7 at initialize, then 27 / 1 / 1 a
    window of 8), AUC exactly 20/21 with the ground truth as the
    prediction, the GOT-10k and TrackingNet zips read back; then LaSOT
    through the runners on phase sot's served model (conf_thre 0): (c) one
    sequence with the kernels and with their plain versions, the boxes
    within 5% of the box's larger side + 2 letterbox px; (d)
    run_dataset_sot (window 8) against run_sequence_sot at window 1,
    frames/s, the share of runner time spent reading frames, launches a
    frame (27 / 1 / 1) recorded as harness_sot."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.sot import SOTDriver
    from unicorn_torch.harness import analysis, datasets, running, submission

    res, counts, wall = _harness_cli("unicorn_sot", "got10k_val", out)
    seqs = datasets.get_dataset("got10k_val")
    rdir = os.path.join(out, "unicorn_sot", "got10k_val")
    chunks = -(-(HARNESS_GOT_FRAMES - 1) // 8)
    n = len(seqs)
    assert [s.name for s in seqs] == list(res["results"]) and n == 2
    for s in seqs:
        txt = np.loadtxt(os.path.join(rdir, f"{s.name}.txt"), delimiter="\t")
        assert txt.shape == (len(s.frames), 4), txt.shape
        assert np.array_equal(txt[0], gts[s.name][0])
        assert np.isfinite(res["results"][s.name]).all()
    assert counts == _harness_expect(n, n * chunks), counts
    exact = analysis.evaluate_sot(gts, gts)
    assert exact["AUC"] == 20 / 21 and exact["Precision@20"] == 1.0, exact
    t0 = time.perf_counter()
    zg = submission.transform_got10k(rdir, os.path.join(out, "sub_got"))
    t1 = time.perf_counter()
    zt = submission.transform_trackingnet(rdir, os.path.join(out, "sub_tn"))
    t2 = time.perf_counter()
    members_g, members_t = _zip_numbers(zg, ","), _zip_numbers(zt, ",")
    for s in seqs:
        txt = np.loadtxt(os.path.join(rdir, f"{s.name}.txt"), delimiter="\t")
        assert np.array_equal(members_g[f"{s.name}/{s.name}_001.txt"], txt)
        assert len(members_g[f"{s.name}/{s.name}_time.txt"]) == len(txt)
        assert np.array_equal(members_t[f"{s.name}.txt"], txt)
    print(f"  (a) tools/test.py unicorn_sot got10k_val "
          f"({report.get('card', '')}): {n} sequences of "
          f"{HARNESS_GOT_FRAMES} 1080x1920 frames in {wall:.1f} s (the "
          f"model's build included); launches {counts}; metrics "
          f"{res['metrics']}; ground truth as prediction {exact}; packers: "
          f"GOT-10k {(t1 - t0) * 1e3:.2f} ms ({len(members_g)} members), "
          f"TrackingNet {(t2 - t1) * 1e3:.2f} ms ({len(members_t)})")

    exp, model = _sot_model(report)
    H, W = exp.test_size

    def driver():
        return SOTDriver(model, exp.test_size, conf_thre=0.0,
                         nms_thre=exp.nmsthre, device=DEVICE)

    lasot = datasets.load_lasot(names=list(HARNESS_LASOT))
    # (c) kernels against plain versions through the runner (window 8; the
    # kernel run is also the warm-up of the batch of 8)
    boxes_k = running.run_sequence_sot(driver(), lasot[0])[0]
    _reset_kernel_counts()
    with _plain_serving_kernels():
        boxes_p = running.run_sequence_sot(driver(), lasot[0])[0]
    torch.cuda.synchronize()
    assert sum(_kernel_counts().values()) == 0, "a plain version launched"
    r = min(H / 1080, W / 1920)
    tol = 0.05 * boxes_p[:, 2:].max(1, keepdims=True) + 2.0 / r
    d_box = np.abs(boxes_k - boxes_p)
    print(f"  (c) sot sequence {lasot[0].name}, {len(boxes_k)} frames, "
          f"kernels vs plain through run_sequence_sot: boxes max |d| "
          f"{d_box.max():.3f} px, {int((d_box > tol).sum())} coordinates "
          f"beyond 5% of the larger side + {2.0 / r:.2f} px")
    assert (d_box <= tol).all()
    # (d) window 1 (run_sequence_sot) against window 8 (run_dataset_sot,
    # its default), the reads timed; frames/s over every frame, the
    # initialize included
    runs = {}
    n_all = sum(len(s.frames) for s in lasot)
    for window in (1, 8):
        reads = {}
        _reset_kernel_counts()
        t0 = time.perf_counter()
        with _timed_attrs([(running, "imread")], reads):
            if window == 8:
                boxes = list(running.run_dataset_sot(driver, lasot,
                                                     verbose=False).values())
            else:
                boxes = [running.run_sequence_sot(driver(), s, window=1)[0]
                         for s in lasot]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[window] = dict(
            fps=n_all / wall, read_share=reads.get("imread", 0.0) / wall,
            counts=_kernel_counts(), boxes=np.concatenate(boxes), wall=wall,
            read_ms=reads.get("imread", 0.0) / n_all * 1e3)
    tracked = HARNESS_LASOT_FRAMES - 1
    nl = len(lasot)
    chunks = -(-tracked // 8)
    assert runs[1]["counts"] == _harness_expect(nl, nl * tracked), \
        runs[1]["counts"]
    assert runs[8]["counts"] == _harness_expect(nl, nl * chunks), \
        runs[8]["counts"]
    _record_launches(report, "harness_sot", runs[1]["counts"])
    d_win = np.abs(runs[8]["boxes"] - runs[1]["boxes"]).max()
    print(f"  (d) the SOT runners on LaSOT ({report.get('card', '')}): "
          f"{nl} sequences of {HARNESS_LASOT_FRAMES} 1080x1920 frames, "
          f"frames/s with initialize; "
          + "; ".join(f"window {w}: {v['fps']:.2f} frames/s, reading "
                      f"frames {v['read_share'] * 100:.1f}% of "
                      f"{v['wall']:.2f} s ({v['read_ms']:.1f} ms a frame), "
                      f"launches {v['counts']}" for w, v in runs.items())
          + f"; window 8 vs 1 boxes max |d| {d_win:.3f} px; 27 / 1 / 1 "
          f"launches a frame at window 1")
    report["harness_sot_fps"] = {w: v["fps"] for w, v in runs.items()}


def _harness_vos(report, out):
    """(b) tools/test.py unicorn_vos on DAVIS 2017 val and YouTube-VOS 2018
    (the CLI's own seeded unicorn_track_tiny_mask): a PNG a frame, read
    back equal to the returned label map; launches (18 dw7x7 at initialize
    and add_objects, 27 / 1 / 1 a frame; MSDA at batch K on the YT-VOS
    general path), recorded as harness_vos; the ground truth scores J&F
    exactly 1.0. Then DAVIS through run_sequence_vos on the served mask
    model with raised biases (phase vos's): (c) one sequence with the
    kernels and with their plain versions (all three, then each alone):
    each slot's top score within 0.05 and its top box within 5% of the
    box's larger side + 2 px (phase vos's bounds); its mask probabilities
    within 0.01 on average and beyond 0.05 on at most 1% of the pixels
    (the maximum and the label maps' agreement printed); the MSDA kernel
    against its plain version on the run's own inputs at phase kernels'
    bound; (d) frames/s; J&F scoring ms a frame at 480x854."""
    from unittest import mock

    import numpy as np
    import torch

    from unicorn_torch.data.image_io import read_indexed_mask
    from unicorn_torch.drivers.vos import VOSDriver
    from unicorn_torch.harness import datasets, davis_metrics, running
    from unicorn_torch.models import interaction
    from unicorn_torch.ops import deform_attn as da

    def stem(p):
        return os.path.splitext(os.path.basename(p))[0]

    msda_batch = []
    msda = interaction.ms_deform_attn

    def recorded(v, locs, attw, method):
        msda_batch.append(v.shape[0])
        return msda(v, locs, attw, method)

    total = {}
    for dataset in ("dv2017", "yt2018"):
        msda_batch.clear()
        with mock.patch.object(interaction, "ms_deform_attn", recorded):
            res, counts, wall = _harness_cli("unicorn_vos", dataset, out)
        seqs = datasets.get_dataset(dataset)
        K = max(len({int(i) for m in s.masks
                     for i in np.unique(read_indexed_mask(m)) if i})
                for s in seqs)
        n_frames = sum(len(s.frames) for s in seqs)
        entries = (1 if dataset == "yt2018" else 0)
        for s in seqs:
            preds = res["preds"][s.name]
            assert len(preds) == len(s.frames)
            for p, m in zip(s.frames, preds):
                png = os.path.join(out, "unicorn_vos", dataset, s.name,
                                   stem(p) + ".png")
                assert np.array_equal(read_indexed_mask(png), m), png
        tracked = n_frames - len(seqs)
        assert counts == _harness_expect(len(seqs) + entries, tracked), \
            counts
        if dataset == "yt2018":
            # shared path until the entry, then the general path at batch K
            n_shared = HARNESS_YT_ENTRY - 1
            assert msda_batch == [1] * n_shared + [K] * (
                tracked - n_shared), msda_batch
        gts = {s.name: [read_indexed_mask(m) for m in s.masks] for s in seqs}
        skip = dataset != "yt2018"   # YT-VOS: 2 sparse annotations
        exact = davis_metrics.evaluate_davis(gts, gts, skip_first_last=skip)
        assert exact["J&F"] == 1.0, exact
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        print(f"  (b) tools/test.py unicorn_vos {dataset} "
              f"({report.get('card', '')}): {len(seqs)} sequences, "
              f"{n_frames} 480x854 frames, K = {K}, in {wall:.1f} s (the "
              f"model's build included); launches {counts} (MSDA batches "
              f"{msda_batch}); {res['metrics']}; every PNG read back "
              f"equal; ground truth as prediction J&F {exact['J&F']} over "
              f"{exact['n_objects']} objects")
    _record_launches(report, "harness_vos", total)

    exp, model = _vos_model(report)

    def driver():
        return VOSDriver(model, exp.test_size, max_objects=3,
                         use_raft=exp.use_raft, up_rate=exp.up_rate,
                         device=DEVICE)

    davis = datasets.get_dataset("dv2017")
    # (c) one sequence, kernels against plain versions: each frame's top
    # detection and mask probabilities of every slot, as the tail
    # receives them; then each wrapper plain alone, to attribute them
    def run(which):
        d = driver()
        seen = []
        tail = d.postprocess_masks_host

        def watch(dets, valid, masks, r):
            seen.append((dets[:, 0].float().cpu(), masks.float().cpu()))
            return tail(dets, valid, masks, r)

        d.postprocess_masks_host = watch
        _reset_kernel_counts()
        with _plain_serving_kernels(which):
            labels = running.run_sequence_vos(d, davis[0])
        torch.cuda.synchronize()
        if len(which) == 3:
            assert sum(_kernel_counts().values()) == 0, "plain launched"
        return (labels, torch.stack([t for t, _ in seen]),
                torch.stack([m for _, m in seen]))

    def compare(a, b):
        (lab_a, top_a, m_a), (lab_b, top_b, m_b) = a, b
        d_score = (top_a[..., 4] * top_a[..., 5]
                   - top_b[..., 4] * top_b[..., 5]).abs().max().item()
        side = (top_b[..., 2:4] - top_b[..., 0:2]).amax(-1, keepdim=True)
        d_box = (top_a[..., :4] - top_b[..., :4]).abs()
        d_m = (m_a - m_b).abs()
        agree = [float((x == y).mean()) for x, y in zip(lab_a[1:], lab_b[1:])]
        return dict(score=d_score, box=d_box.max().item(),
                    box_bad=int((d_box > 0.05 * side + 2.0).sum()),
                    mask=d_m.max().item(), mask_mean=d_m.mean().item(),
                    mask_over=float((d_m > 0.05).float().mean()),
                    labels=min(agree))

    captured = []

    def capture(v, locs, attw, method):
        if not captured:
            captured.append((v.clone(), locs.clone(), attw.clone(), method))
        return msda(v, locs, attw, method)

    with mock.patch.object(interaction, "ms_deform_attn", capture):
        kern = run(())
    cmp = {"all three": compare(kern, run(("dwconv7x7", "msda",
                                            "correlation")))}
    for name in ("dwconv7x7", "msda", "correlation"):
        cmp[name] = compare(kern, run((name,)))
    for name, c in cmp.items():
        print(f"  (c) vos sequence {davis[0].name}, "
              f"{len(davis[0].frames) - 1} tracked frames x 3 slots, "
              f"kernels vs plain ({name}) through run_sequence_vos: top "
              f"score max |d| {c['score']:.3e} (tol 0.05), top box max |d| "
              f"{c['box']:.3f} px ({c['box_bad']} coordinates beyond 5% of "
              f"the larger side + 2 px), mask probabilities max |d| "
              f"{c['mask']:.3e} (tol 0.05), mean {c['mask_mean']:.3e}, "
              f"{c['mask_over'] * 100:.4f}% beyond 0.05; label maps equal "
              f"on {c['labels'] * 100:.3f}% of a frame's pixels at least")
    # the MSDA kernel against its plain version on the first frame's
    # inputs, at phase kernels' bound (accumulation order, and a bf16 ulp of
    # the output)
    v, locs, attw, method = captured[0]
    yk = msda(v, locs, attw, method)
    yp = da.ms_deform_attn_plain(v, locs, attw, "factored")
    mag = da.ms_deform_attn_plain(v.float().abs(), locs, attw.float(),
                                  "direct")
    L, P = locs.shape[3], locs.shape[4]
    tol = L * P * 4 * 2.0 ** -24 * mag + 1e-7
    if yk.dtype == torch.bfloat16:
        tol = tol + bf16_ulp(torch.maximum(yk.float().abs(),
                                           yp.float().abs()))
    diff = (yk.float() - yp.float()).abs()
    msda_bad = int((diff > tol).sum())
    print(f"  (c) the MSDA kernel vs its plain version on that run's first "
          f"frame ({tuple(v.shape)} {v.dtype}): max |d| "
          f"{diff.max().item():.3e}, {msda_bad} outputs beyond phase "
          f"kernels' bound")
    # scores and boxes at phase vos's bounds; the mask probabilities, which
    # the bf16 mask head moves by up to 0.065 under the MSDA kernel's
    # ulp-level difference alone, by their mean and the share beyond 0.05
    c = cmp["all three"]
    assert msda_bad == 0 and c["score"] <= 0.05 and c["box_bad"] == 0
    assert c["mask_mean"] <= 0.01 and c["mask_over"] <= 0.01
    # (d) VOS frames/s through the runner, then J&F's cost
    _reset_kernel_counts()
    reads = {}
    t0 = time.perf_counter()
    with _timed_attrs([(running, "imread")], reads):
        preds = {s.name: running.run_sequence_vos(driver(), s)
                 for s in davis}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    n_frames = sum(len(s.frames) for s in davis)
    tracked = n_frames - len(davis)
    assert counts == _harness_expect(len(davis), tracked), counts
    gts = {s.name: [read_indexed_mask(m) for m in s.masks] for s in davis}
    t0 = time.perf_counter()
    scores = davis_metrics.evaluate_davis(preds, gts)
    jf_s = time.perf_counter() - t0
    scored = sum(len(g) - 2 for g in gts.values())
    print(f"  (d) run_sequence_vos on DAVIS ({report.get('card', '')}): "
          f"{n_frames} frames of 480x854 -> {exp.test_size}, "
          f"{n_frames / wall:.2f} frames/s with initialize, reading frames "
          f"{reads.get('imread', 0.0) / wall * 100:.1f}% of {wall:.2f} s; "
          f"launches "
          f"{counts}; J&F {scores} in {jf_s * 1e3:.1f} ms, "
          f"{jf_s / scored * 1e3:.1f} ms a scored frame "
          f"({scores['n_objects']} objects, host dilation)")
    report["harness_vos_fps"] = n_frames / wall


def _harness_utils(report, out):
    """(e) csrc/pack.cpp against the numpy form at 800x1280x3, ms each;
    utils.profiling.trace around one SOT frame (a Chrome trace with the
    annotated region; its CUDA kernel events counted); device_memory_stats;
    utils.model_utils.get_model_info on phase sot's served
    unicorn_track_tiny at 800x1280, its parameter count equal to phase
    backbones' count of the exp."""
    import glob

    import numpy as np
    import torch

    from unicorn_torch.csrc import native
    from unicorn_torch.data.image_io import imread
    from unicorn_torch.drivers.sot import SOTDriver
    from unicorn_torch.drivers.stream import pack_frames_np, pack_frames_plain
    from unicorn_torch.utils import model_utils, profiling

    frame = imread(os.path.join(FIXTURES, DISK_FRAMES[0]))[None, :800, :1280]
    frame = np.ascontiguousarray(frame)
    packed = native.pack_frames_s2d4(frame)
    assert np.array_equal(packed, pack_frames_plain(frame))
    assert np.array_equal(pack_frames_np(frame), packed)
    ms = {}
    for name, fn in (("native", native.pack_frames_s2d4),
                     ("numpy", pack_frames_plain)):
        t = []
        for _ in range(HARNESS_PACK_REPS):
            t0 = time.perf_counter()
            fn(frame)
            t.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(t))
    print(f"  (e) pack 1x800x1280x3 -> {packed.shape}: native equal to the "
          f"numpy form bit for bit; median of {HARNESS_PACK_REPS}: native "
          f"{ms['native']:.3f} ms, numpy {ms['numpy']:.3f} ms (host, "
          f"{report.get('card', '')})")

    exp, model = _sot_model(report)
    drv = SOTDriver(model, exp.test_size, conf_thre=0.0, device=DEVICE)
    frames = _sot_frames(2, seed=19)
    drv.initialize(frames[0], INIT_BOX)
    drv.track(frames[1])
    log_dir = os.path.join(out, "trace")
    with profiling.trace(log_dir):
        with profiling.span("harness_sot_frame"):
            drv.track(frames[2])
            torch.cuda.synchronize()
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert any(e.get("name") == "harness_sot_frame" for e in events)
    stats = profiling.device_memory_stats()
    s0 = stats["cuda:0"]
    assert 0 < s0["bytes_in_use"] <= s0["peak_bytes_in_use"] <= \
        s0["bytes_limit"], s0
    t0 = time.perf_counter()
    info = model_utils.get_model_info(model, (1, *exp.test_size, 3))
    torch.cuda.synchronize()
    info_ms = (time.perf_counter() - t0) * 1e3
    n = model_utils.count_params(model)
    want = report.get("exp_params", {}).get("unicorn_track_tiny")
    print(f"  (e) trace of one SOT frame: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0]) / 1e6:.2f} MB, {len(events)} events, "
          f"{len(kernels)} CUDA kernel events; device_memory_stats {stats}; "
          f"get_model_info: {info} ({n:,} parameters; phase backbones "
          f"counted {want if want is None else f'{want:,}'}), "
          f"{info_ms:.0f} ms")
    assert want is None or n == want
    assert info.startswith(f"Params: {n / 1e6:.2f}M, GFLOPs: ")


def phase_harness(report):
    """The SOT / VOS benchmark harness on layouts written under
    chiprun_out/harness_data from the fixtures (`_write_harness_layouts`,
    removed when the phase passes), with UNICORN_DATADIR there: (a) and the
    SOT halves of (c), (d) `_harness_sot`; (b) and the VOS halves
    `_harness_vos`; (e) `_harness_utils`."""
    import shutil
    import tempfile

    print(f"harness ({report.get('card', '')})")
    shutil.rmtree(HARNESS_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    gts = _write_harness_layouts(HARNESS_ROOT)
    print(f"  layouts written under {HARNESS_ROOT} in "
          f"{time.perf_counter() - t0:.1f} s")
    env = os.environ.get("UNICORN_DATADIR")
    os.environ["UNICORN_DATADIR"] = HARNESS_ROOT
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_harness_")
    try:
        _harness_sot(report, gts, tmp.name)
        _harness_vos(report, tmp.name)
        _harness_utils(report, tmp.name)
    finally:
        tmp.cleanup()
        if env is None:
            os.environ.pop("UNICORN_DATADIR", None)
        else:
            os.environ["UNICORN_DATADIR"] = env
    shutil.rmtree(HARNESS_ROOT)


# --------------------------------------------------------------- phase tools
TOOLS_ROOT = os.path.join(ROOT, "chiprun_out", "tools_data")
TOOLS_VIDEOS = 2          # videos of the MOT17-style test set ...
TOOLS_FRAMES = 8          # ... of this many copies of the 1080x1920 JPEG
TOOLS_DEMO_VIDEO = 4      # frames of the demo's video directory
TOOLS_TIMED = 10          # timed calls of the exported program and eager
TOOLS_TRAIN_ITERS = 2     # iterations of tools.train at B = 2
TOOLS_TEST = ["test_ann", "tools_test.json", "test_name", "tools_test"]
# launches a frame of the detection tools (forward_whole) and of the omni
# driver (MSDA once a frame)
TOOLS_FRAME = dict(dwconv7x7=27, msda_factored=0, msda_direct=0,
                   correlation=0)
TOOLS_OMNI = dict(TOOLS_FRAME, msda_factored=1)
TOOLS_DW_NODES = 27       # unicorn_torch.dwconv7x7 nodes of the export


def _write_tools_sets(root):
    """Under root: phase disk's reference layouts (`_write_disk_layouts`),
    phase eval's BDD100K seg_track set (`_write_eval_sets`) moved to
    bdd100k/ with its labels also as box_track_20/val.json (the tools'
    default), and a MOT17-style COCO-video test set mot/tools_test/ of
    TOOLS_VIDEOS videos x TOOLS_FRAMES copies of the 1080x1920 JPEG with
    seeded moving boxes and track ids (mot/annotations/tools_test.json).
    Returns the number of test frames."""
    import shutil

    import numpy as np

    _write_disk_layouts(root)
    _write_eval_sets(root)
    shutil.move(os.path.join(root, "bdd"), os.path.join(root, "bdd100k"))
    labels = os.path.join(root, "bdd100k", "labels")
    os.makedirs(os.path.join(labels, "box_track_20"))
    shutil.copyfile(os.path.join(labels, "seg_track_20", "rles", "val.json"),
                    os.path.join(labels, "box_track_20", "val.json"))
    rng = np.random.RandomState(20)
    images, anns = [], []
    for v in range(TOOLS_VIDEOS):
        video = f"MOT17-{v + 2:02d}-FRCNN"
        os.makedirs(os.path.join(root, "mot", "tools_test", video))
        start = rng.randint(100, 1400, (5, 2))
        for t in range(TOOLS_FRAMES):
            name = f"{video}/{t + 1:06d}.jpg"
            shutil.copyfile(os.path.join(FIXTURES, DISK_FRAMES[0]),
                            os.path.join(root, "mot", "tools_test", name))
            images.append({"id": len(images) + 1, "file_name": name,
                           "height": 1080, "width": 1920,
                           "frame_id": t + 1, "video_id": v + 1})
            for k, (x, y) in enumerate(start + 8 * t):
                anns.append({"id": len(anns) + 1, "image_id": len(images),
                             "category_id": 1,
                             "bbox": [int(x), int(y) // 2, 90, 240],
                             "area": 90 * 240, "iscrowd": 0,
                             "track_id": 10 * v + k})
    with open(os.path.join(root, "mot", "annotations", "tools_test.json"),
              "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "pedestrian"}]}, f)
    got = os.path.join(root, "GOT10K", "val")
    seq = os.path.join(got, "GOT-10k_Val_000001")
    os.makedirs(seq)
    for t in range(3):
        shutil.copyfile(os.path.join(FIXTURES, DISK_FRAMES[0]),
                        os.path.join(seq, f"{t + 1:08d}.jpg"))
    np.savetxt(os.path.join(seq, "groundtruth.txt"),
               [[400 + 20 * t, 300, 240, 180] for t in range(3)],
               delimiter=",", fmt="%d")
    with open(os.path.join(got, "list.txt"), "w") as f:
        f.write("GOT-10k_Val_000001\n")
    return TOOLS_VIDEOS * TOOLS_FRAMES


def _tools_ckpt(name, path):
    """The port's seed-0 init of exp `name`, its obj / cls biases raised
    (`_raise_priors`), saved as a port checkpoint at path; returns path."""
    import torch

    from unicorn_torch.exp.base import get_exp

    model = get_exp(exp_name=name).get_model(torch.Generator().manual_seed(0))
    _raise_priors(model)
    torch.save({"model": model.state_dict()}, path)
    return path


def _tool(main, argv):
    """main(argv) with the launch counts zeroed just before and read after
    -> (its return, counts, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    _reset_all_counts()
    t0 = time.perf_counter()
    out = main(argv)
    torch.cuda.synchronize()
    return out, _all_counts(), time.perf_counter() - t0


def _expect(per_frame, n):
    return {k: n * per_frame.get(k, 0) for k in _all_counts()}


def _tools_track(report, ckpt, out, n_frames):
    """(a) tools.track on the host path and --fused --chunk 8: a txt a
    video, 27 dw7x7 launches a frame, frames/s of the tracking loop and
    the share of it spent reading (imread) and letterboxing frames."""
    import numpy as np

    from unicorn_torch.data import transforms
    from unicorn_torch.data.datasets import mot as mot_ds
    from unicorn_torch.tools import track

    for mode, extra in (("host", []), ("fused", ["--fused", "--chunk", "8"])):
        rdir = os.path.join(out, f"track_{mode}")
        tally = {}
        loop = (track, "run_fused") if mode == "fused" else (
            track.MOTEvaluator, "evaluate")
        with _timed_attrs([(mot_ds, "imread"), (transforms, "letterbox"),
                           loop], tally):
            res, counts, wall = _tool(track.main, [
                "-n", "unicorn_track_tiny", "-c", ckpt, "--result-dir", rdir,
                "--device", DEVICE, *extra, *TOOLS_TEST])
        assert counts == _expect(TOOLS_FRAME, n_frames), counts
        assert sorted(os.listdir(rdir)) == sorted(f"{v}.txt" for v in res)
        assert len(res) == TOOLS_VIDEOS
        rows = sum(len(np.loadtxt(os.path.join(rdir, f), delimiter=",",
                                  ndmin=2)) for f in os.listdir(rdir))
        n_tracks = sum(len(f[1]) for v in res.values() for f in v)
        assert rows == n_tracks > 0, (rows, n_tracks)
        t_loop = tally[loop[1]]
        print(f"  (a) tools.track {mode} ({report.get('card', '')}): "
              f"{n_frames} 1080x1920 frames in {wall:.2f} s with the "
              f"model's build, the tracking loop {t_loop:.2f} s = "
              f"{n_frames / t_loop:.2f} frames/s, reading frames "
              f"{tally['imread'] / t_loop * 100:.1f}% "
              f"({tally['imread'] / n_frames * 1e3:.1f} ms a frame) and the "
              f"host letterbox {tally['letterbox'] / t_loop * 100:.1f}% "
              f"({tally['letterbox'] / n_frames * 1e3:.1f} ms) of it; "
              f"{n_tracks} track rows; launches {counts}")
        _record_launches(report, f"tools_track_{mode}", counts)
        report.setdefault("tools_fps", {})[mode] = n_frames / t_loop


def _tools_omni(report, ckpt, mask_ckpt, out, n_frames):
    """(b) tools.track_omni with QDTrack on the MOT17-style set
    (unicorn_track_tiny) and --dataset bdd --mots
    (unicorn_track_tiny_mask): 27 dw7x7 + 1 MSDA a frame, the txts and
    seg_scores.json written."""
    import numpy as np

    from unicorn_torch.tools import track_omni

    rdir = os.path.join(out, "omni_mot")
    res, counts, wall = _tool(track_omni.main, [
        "-n", "unicorn_track_tiny", "-c", ckpt, "--result-dir", rdir,
        "--device", DEVICE, *TOOLS_TEST])
    assert counts == _expect(TOOLS_OMNI, n_frames), counts
    assert sorted(os.listdir(rdir)) == sorted(f"{v}.txt" for v in res)
    n_tracks = sum(len(f[1]) for v in res.values() for f in v)
    assert n_tracks > 0
    print(f"  (b) tools.track_omni qd ({report.get('card', '')}): "
          f"{n_frames} frames in {wall:.2f} s with the model's build; "
          f"{n_tracks} track rows; launches {counts}")
    _record_launches(report, "tools_track_omni", counts)
    rdir = os.path.join(out, "omni_bdd")
    n_bdd = EVAL_BDD_VIDEOS * EVAL_BDD_FRAMES
    scores, counts, wall = _tool(track_omni.main, [
        "-n", "unicorn_track_tiny_mask", "-c", mask_ckpt, "--dataset", "bdd",
        "--mots", "--result-dir", rdir, "--device", DEVICE])
    assert counts == _expect(TOOLS_OMNI, n_bdd), counts
    with open(os.path.join(rdir, "seg_scores.json")) as f:
        written = json.load(f)
    assert all(np.isfinite(written[k]) for k in ("mMOTSA", "mIDF1"))
    assert written["mMOTSA"] == float(scores["mMOTSA"])
    print(f"  (b) tools.track_omni --dataset bdd --mots: {n_bdd} 720x1280 "
          f"frames in {wall:.2f} s with the model's build; seg_scores.json "
          f"mMOTSA {written['mMOTSA']:.4f} mIDF1 {written['mIDF1']:.4f}; "
          f"launches {counts}")
    _record_launches(report, "tools_track_omni_bdd_mots", counts)


def _tools_demo(report, ckpt, out):
    """(c) tools.demo image on 2 frames and video on a TOOLS_DEMO_VIDEO
    frame directory: the drawn PNGs written, 27 dw7x7 a frame."""
    import shutil

    from unicorn_torch.data.image_io import read_png
    from unicorn_torch.tools import demo

    src = os.path.join(TOOLS_ROOT, "mot", "tools_test", "MOT17-02-FRCNN")
    for sub, n in (("demo_images", 2), ("demo_video", TOOLS_DEMO_VIDEO)):
        os.makedirs(os.path.join(out, sub))
        for t in range(n):
            shutil.copyfile(os.path.join(src, f"{t + 1:06d}.jpg"),
                            os.path.join(out, sub, f"{t:04d}.jpg"))
    for mode, path, n, save in (
            ("image", "demo_images", 2, "demo_image_out"),
            ("video", "demo_video", TOOLS_DEMO_VIDEO, "demo_video_out")):
        save = os.path.join(out, save)
        dets, counts, wall = _tool(demo.main, [
            mode, "-n", "unicorn_track_tiny", "-c", ckpt, "--path",
            os.path.join(out, path), "--save-dir", save, "--device", DEVICE])
        assert counts == _expect(TOOLS_FRAME, n), counts
        pngs = (sorted(os.listdir(save)) if mode == "image" else
                sorted(os.listdir(os.path.join(save, "demo_out"))))
        assert len(pngs) == n, pngs
        first = read_png(os.path.join(
            save if mode == "image" else os.path.join(save, "demo_out"),
            pngs[0]))
        assert first.shape == (1080, 1920, 3)
        print(f"  (c) tools.demo {mode}: {n} frames in {wall:.2f} s with the "
              f"model's build, {sum(len(d) for d in dets.values())} "
              f"detections drawn, PNGs {pngs}; launches {counts}")
        _record_launches(report, f"tools_demo_{mode}", counts)


def _tools_export(report, ckpt, out):
    """(d) tools.export_model in both modes: 27 unicorn_torch.dwconv7x7
    nodes, the reloaded program 27 launches a call and the eager model's
    output bit for bit, the eager model's kernels vs its plain route at
    phase model's bounds; export seconds, the loaded program's ms a frame
    against eager (CUDA events over TOOLS_TIMED calls each)."""
    import numpy as np
    import torch
    import torch.utils._pytree as pytree

    from unicorn_torch.device import resolve_device
    from unicorn_torch.exp.base import get_exp
    from unicorn_torch.tools import export_model
    from unicorn_torch.tools.common import load_model

    exp = get_exp(exp_name="unicorn_track_tiny")
    model = load_model(exp, ckpt).to(resolve_device(DEVICE))
    _forward_whole_check("  (d) the exported model, eager,", exp, model,
                         TOOLS_FRAME["dwconv7x7"])
    rng = np.random.RandomState(5)
    x = torch.from_numpy((rng.rand(1, *exp.test_size, 3) * 255).round()
                         .astype(np.float32)).to(DEVICE).permute(0, 3, 1, 2)
    for mode in ("whole", "decode"):
        path = os.path.join(out, f"unicorn_track_tiny_{mode}.pt2")
        t0 = time.perf_counter()
        program, _ = export_model.main([
            "-n", "unicorn_track_tiny", "-c", ckpt, "--out", path, "--mode",
            mode, "--device", DEVICE])
        t_export = time.perf_counter() - t0
        loaded = torch.export.load(path).module()
        eager = export_model.ExportForward(model, mode == "decode")
        assert export_model.dw_nodes(program) == TOOLS_DW_NODES
        with torch.inference_mode():
            want = eager(x)
            torch.cuda.synchronize()
            _reset_all_counts()
            got = loaded(x)
            torch.cuda.synchronize()
            counts = _all_counts()
            assert counts == _expect(TOOLS_FRAME, 1), counts
            _record_launches(report, f"tools_export_{mode}", counts)
            a, b = pytree.tree_leaves(got), pytree.tree_leaves(want)
            assert len(a) == len(b)
            d = max((u.float() - v.float()).abs().max().item()
                    for u, v in zip(a, b))
            ms = {}
            for name, fn in (("loaded", loaded), ("eager", eager)):
                fn(x)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(TOOLS_TIMED):
                    fn(x)
                end.record()
                torch.cuda.synchronize()
                ms[name] = start.elapsed_time(end) / TOOLS_TIMED
        print(f"  (d) tools.export_model {mode} ({report.get('card', '')}): "
              f"exported in {t_export:.1f} s with the model's build, "
              f"{os.path.getsize(path) / 2 ** 20:.1f} MiB; "
              f"{export_model.dw_nodes(program)} unicorn_torch.dwconv7x7 "
              f"nodes; the reloaded program: "
              f"launches {counts}, max |d| against eager {d:.3e}, "
              f"{ms['loaded']:.2f} ms a frame against eager's "
              f"{ms['eager']:.2f} (CUDA events, {TOOLS_TIMED} calls)")
        assert d == 0.0, d
        report.setdefault("tools_export", {})[mode] = (t_export, ms)


def _tools_train(report, out):
    """(e) tools.train -n unicorn_track_tiny -b 2 for TOOLS_TRAIN_ITERS
    iterations on phase disk's layout: 36 / 1 / 2 / 2 / 2 launches a step;
    (g) the same with debug_only: a PNG a frame of the first batch under
    debug_data, no step, no launch."""
    from unicorn_torch.data.image_io import read_png
    from unicorn_torch.tools import train

    opts = ["samples_per_epoch", str(2 * TOOLS_TRAIN_ITERS), "max_epoch",
            "1", "print_interval", "1", "pretrain_name", "none",
            *sum(([k, str(v)] for k, v in DISK_EXP_FIELDS.items()), [])]
    for k, v in TRAINER_EXP_FIELDS.items():
        opts += [k, repr(v)]
    tr, counts, wall = _tool(train.main, [
        "-n", "unicorn_track_tiny", "-b", "2", "--device", DEVICE,
        "output_dir", os.path.join(out, "train"), *opts])
    assert tr.state.step == TOOLS_TRAIN_ITERS
    assert counts == _expect(TRAIN_LAUNCHES, TOOLS_TRAIN_ITERS), counts
    assert os.path.isfile(os.path.join(tr.output_dir, "latest"))
    print(f"  (e) tools.train unicorn_track_tiny -b 2 from disk "
          f"({report.get('card', '')}): {TOOLS_TRAIN_ITERS} iterations in "
          f"{wall:.2f} s with the build, the loader and the save; launches "
          f"{counts}")
    _record_launches(report, "tools_train", counts)
    tr, counts, wall = _tool(train.main, [
        "-n", "unicorn_track_tiny", "-b", "2", "--device", DEVICE,
        "output_dir", os.path.join(out, "debug"), "debug_only", "True",
        *opts])
    dump = os.path.join(tr.output_dir, "debug_data")
    names = sorted(os.listdir(dump))
    assert tr.state.step == 0 and sum(counts.values()) == 0, counts
    assert [n[:16] for n in names] == [f"batch_b{b}_f{f}_task"
                                       for b in (0, 1) for f in (0, 1)]
    H, W = tr.input_size
    assert read_png(os.path.join(dump, names[0])).shape == (H, W, 3)
    print(f"  (g) debug_only: {names} ({H}x{W}) in {wall:.2f} s, no step")


def _tools_plot(report, out):
    """(f) tools.analysis_results --plot with matplotlib not importable: the
    PNG of PLOT_SIZE."""
    from unittest import mock

    import numpy as np

    from unicorn_torch.data.image_io import read_png
    from unicorn_torch.harness import analysis
    from unicorn_torch.tools import analysis_results

    res = os.path.join(out, "sot_results")
    os.makedirs(res)
    gt = np.loadtxt(os.path.join(TOOLS_ROOT, "GOT10K", "val",
                                 "GOT-10k_Val_000001", "groundtruth.txt"),
                    delimiter=",")
    np.savetxt(os.path.join(res, "GOT-10k_Val_000001.txt"), gt + 6,
               delimiter="\t")
    png = os.path.join(out, "ope.png")
    blocked = {m: None for m in list(sys.modules) + ["matplotlib"]
               if m.split(".")[0] == "matplotlib"}
    with mock.patch.dict(sys.modules, blocked):
        metrics = analysis_results.main([
            "--dataset", "got10k_val", "--result-dir", res, "--plot", png])
    assert read_png(png).shape == analysis.PLOT_SIZE + (3,)
    print(f"  (f) tools.analysis_results --plot without matplotlib: {png} "
          f"{analysis.PLOT_SIZE}, {metrics}")


def phase_tools(report):
    """The command-line tools on unicorn_track_tiny (and
    unicorn_track_tiny_mask) at full width, bf16, seed-0 weights with the
    obj / cls biases raised, saved as port checkpoints for -c, with
    UNICORN_DATADIR at the sets `_write_tools_sets` writes under
    chiprun_out/tools_data (removed when the phase passes): (a)
    `_tools_track`, (b) `_tools_omni`, (c) `_tools_demo`, (d)
    `_tools_export`, (e) and (g) `_tools_train`, (f) `_tools_plot`."""
    import shutil
    import tempfile

    print(f"tools ({report.get('card', '')})")
    shutil.rmtree(TOOLS_ROOT, ignore_errors=True)
    t0 = time.perf_counter()
    n_frames = _write_tools_sets(TOOLS_ROOT)
    print(f"  sets written under {os.path.relpath(TOOLS_ROOT, ROOT)} in "
          f"{time.perf_counter() - t0:.1f} s")
    env = os.environ.get("UNICORN_DATADIR")
    os.environ["UNICORN_DATADIR"] = TOOLS_ROOT
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_tools_")
    try:
        ckpt = _tools_ckpt("unicorn_track_tiny",
                           os.path.join(tmp.name, "track_ckpt"))
        mask_ckpt = _tools_ckpt("unicorn_track_tiny_mask",
                                os.path.join(tmp.name, "mask_ckpt"))
        _tools_track(report, ckpt, tmp.name, n_frames)
        _tools_omni(report, ckpt, mask_ckpt, tmp.name, n_frames)
        _tools_demo(report, ckpt, tmp.name)
        _tools_export(report, ckpt, tmp.name)
        _tools_train(report, tmp.name)
        _tools_plot(report, tmp.name)
    finally:
        tmp.cleanup()
        if env is None:
            os.environ.pop("UNICORN_DATADIR", None)
        else:
            os.environ["UNICORN_DATADIR"] = env
    shutil.rmtree(TOOLS_ROOT)


# ------------------------------------- batched and multi-process forms
PAR_CHUNK = 8             # (a) frames a run_chunk call, two calls
PAR_STREAMS = 4           # (b) MultiStreamMOT streams ...
PAR_TICKS = 8             # ... and ticks
PAR_SEQS = 4              # (c) SOT sequences in lockstep ...
PAR_SOT_FRAMES = 8        # ... and their frames after the first
PAR_CHECKED = 2           # lockstep frames checked against batch-1 runs
PAR_VOS_SEQS = 2          # VOS sequences of the shared form ...
PAR_VOS_K = 5             # ... with this many object slots ...
PAR_VOS_FRAMES = 4        # ... over this many frames
PAR_DP_WARMUP = 2         # (d) untimed steps of each rank ...
PAR_DP_STEPS = 4          # ... and timed ones
PAR_FRAME = dict(dwconv7x7=27, msda_factored=0, msda_direct=0,
                 correlation=0)   # a detector frame of unicorn_track_tiny


def _par_frames(n, seed, shift=4):
    """n uint8 FRAME_HW frames of a panning random texture."""
    import numpy as np

    rng = np.random.RandomState(seed)
    fh, fw = FRAME_HW
    base = (rng.rand(fh, fw + shift * n, 3) * 255).astype(np.uint8)
    return [np.ascontiguousarray(base[:, shift * t:shift * t + fw])
            for t in range(n)]


def _ingest(exp, f):
    """uint8 frame -> (1, H, W, 3) float32 on the card, letterboxed."""
    import torch

    from unicorn_torch.ops.letterbox import letterbox_device

    return letterbox_device(torch.from_numpy(f).to(DEVICE),
                            exp.test_size)[0][None]


def _stream_kw(exp):
    """The streaming settings of phase stream (the JAX bench's)."""
    return dict(input_size=exp.test_size, num_classes=exp.num_classes,
                conf_thre=0.1, nms_thre=0.8, max_dets=64, max_tracks=128,
                n_cand=128)


def _parallel_stream(report):
    """(a) StreamingMOTPipeline(pipelined=True) against the plain pipeline:
    two run_chunk calls of PAR_CHUNK letterboxed frames each, in the order
    plain, pipelined, pipelined, plain; the outputs bit-equal (the same
    kernels in the same order on other CUDA streams); frames/s of both
    forms, 27 dw7x7 a frame."""
    import torch

    from unicorn_torch.drivers.stream import StreamingMOTPipeline

    exp, model = _model(report, raised_priors=True)
    n = 2 * PAR_CHUNK
    stack = torch.cat([_ingest(exp, f) for f in _par_frames(n, seed=21)])
    plain = StreamingMOTPipeline(model, device=DEVICE, **_stream_kw(exp))
    piped = StreamingMOTPipeline(model, device=DEVICE, pipelined=True,
                                 **_stream_kw(exp))
    for pipe in (plain, piped):                # warm-up, not counted
        pipe.run_chunk(stack[:2])

    def run(pipe):
        pipe.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = torch.cat([pipe.run_chunk(stack[:PAR_CHUNK]),
                         pipe.run_chunk(stack[PAR_CHUNK:])])
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0), out

    fps_plain, out_plain = run(plain)
    _reset_kernel_counts()
    fps_piped, out_piped = run(piped)
    counts = _kernel_counts()
    fps_piped2, out_piped2 = run(piped)
    fps_plain2, out_plain2 = run(plain)
    n_valid = int((out_plain[..., 6] > 0.5).sum())
    same = torch.equal(out_piped, out_plain) and torch.equal(
        out_piped2, out_plain2) and torch.equal(out_piped, out_piped2)
    print(f"  (a) pipelined run_chunk, 2 x {PAR_CHUNK} frames at "
          f"{exp.test_size}: {fps_piped:.2f} / {fps_piped2:.2f} frames/s "
          f"against the plain chunk's {fps_plain:.2f} / {fps_plain2:.2f} "
          f"(order plain, pipelined, pipelined, plain; host clock); outputs "
          f"bit-equal {same}; {n_valid / n:.1f} tracks a frame; launches "
          f"{counts}")
    report["parallel_stream_fps"] = dict(plain=(fps_plain, fps_plain2),
                                         pipelined=(fps_piped, fps_piped2))
    _record_launches(report, "parallel_pipelined", counts)
    assert counts == {k: v * n for k, v in PAR_FRAME.items()}, counts
    assert same and n_valid > 0
    assert int(piped.ts.frame_id[0]) == n


def _parallel_multistream(report):
    """(b) MultiStreamMOT at PAR_STREAMS streams, PAR_TICKS ticks of one
    letterboxed frame a stream: equal to run_chunk(n_streams=S) on the same
    frames; each stream's ids against an independent single-stream
    pipeline (printed: a batch of S moves bf16 roundings, ROADMAP Queue 3);
    frames/s a stream and in all, 27 dw7x7 a tick."""
    import torch

    from unicorn_torch.drivers.stream import (MultiStreamMOT,
                                              StreamingMOTPipeline)

    exp, model = _model(report, raised_priors=True)
    S, T = PAR_STREAMS, PAR_TICKS
    frames = torch.stack([torch.cat([_ingest(exp, f) for f in
                                     _par_frames(T, seed=30 + s)])
                          for s in range(S)])      # (S, T, H, W, 3)
    multi = MultiStreamMOT(model, S, device=DEVICE, **_stream_kw(exp))
    multi.tick(frames[:, 0])                       # warm-up, not counted
    multi.pipe.reset()
    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    ticks = [multi.tick(frames[:, t]) for t in range(T)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    out = torch.stack(ticks, 1)
    chunk = StreamingMOTPipeline(model, device=DEVICE, n_streams=S,
                                 **_stream_kw(exp))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = chunk.run_chunk(frames)
    torch.cuda.synchronize()
    wall_chunk = time.perf_counter() - t0
    shares = []
    for s in range(S):
        one = StreamingMOTPipeline(model, device=DEVICE, **_stream_kw(exp))
        o = one.run_chunk(frames[s])
        shares.append((o[..., 5] == out[s][..., 5]).float().mean().item())
    n_valid = int((out[..., 6] > 0.5).sum())
    print(f"  (b) MultiStreamMOT, {S} streams x {T} ticks: {S * T / wall:.2f}"
          f" frames/s in all, {T / wall:.2f} a stream (run_chunk(n_streams="
          f"{S}) on the same frames {S * T / wall_chunk:.2f} in all); equal "
          f"to run_chunk {torch.equal(out, ref)}; each stream's ids equal to "
          f"an independent pipeline's at "
          f"{', '.join(f'{x:.1%}' for x in shares)} of the slots; "
          f"{n_valid / (S * T):.1f} tracks a frame; launches {counts}")
    report["parallel_multistream_fps"] = (S * T / wall, T / wall,
                                          S * T / wall_chunk)
    _record_launches(report, "parallel_multistream", counts)
    assert counts == {k: v * T for k, v in PAR_FRAME.items()}, counts
    assert torch.equal(out, ref) and n_valid > 0
    assert bool(torch.isfinite(out).all())
    assert multi.states.frame_id.tolist() == [T] * S


def _rel(a, b):
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max()).item()


def _parallel_sot(report):
    """(c) make_sot_seq_parallel_fn at PAR_SEQS sequences, each with its own
    first frame and box: PAR_SOT_FRAMES lockstep steps (upload, letterbox,
    the step and the fetch of the packed rows), 27 dw7x7 + 1 MSDA + 1
    correlation a step, against PAR_SEQS sequential SOTDriver.track runs.
    On PAR_CHECKED steps each slot's SOT raw logits against the same
    sequence alone at the lockstep's batch (its frame and references in
    every slot): a slot's computation reads no other slot, so they agree
    within 1e-3 of the largest magnitude (bit for bit where the card's
    kernels pick per shape alone; printed), and the slots' outputs are
    distinct (each reads its own references); the lockstep through the
    three kernels against the same through their plain versions, at phase
    sot_model's bound (5% of the largest magnitude). Against the
    sequence's batch-1 forward they differ as track_window's batch does
    from track's (bf16 rounded in other orders at another batch): printed
    through the kernels and through the plain versions, with the
    sequential runs' final boxes."""
    import numpy as np
    import torch

    from unicorn_torch.drivers.seq_parallel import make_sot_seq_parallel_fn
    from unicorn_torch.drivers.sot import SOTDriver

    exp, model = _sot_model(report)
    S, T = PAR_SEQS, PAR_SOT_FRAMES
    driver = SOTDriver(model, input_size=exp.test_size, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    seqs = [_sot_frames(T, seed=40 + s) for s in range(S)]
    fh, fw = FRAME_HW
    boxes = [[INIT_BOX[0] + fw // 32 * s, INIT_BOX[1] + fh // 36 * s,
              *INIT_BOX[2:]] for s in range(S)]
    refs = [driver.init_refs(seq[0], b) for seq, b in zip(seqs, boxes)]
    feat = torch.stack([r[0] for r in refs])
    lbs = torch.stack([r[1] for r in refs])
    fn = make_sot_seq_parallel_fn(driver)

    def imgs(t):
        return torch.cat([driver.preprocess(seq[t])[0] for seq in seqs])

    fn(feat, lbs, imgs(1)).cpu()                   # warm-up, not counted
    torch.cuda.synchronize()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    packed = [fn(feat, lbs, imgs(t)).cpu() for t in range(1, T + 1)]
    wall = time.perf_counter() - t0
    counts = _kernel_counts()
    t0 = time.perf_counter()
    final = []
    for seq, b in zip(seqs, boxes):
        driver.initialize(seq[0], b)
        for f in seq[1:]:
            state = driver.track(f)["target_bbox"]
        final.append(state)
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    d_alone = d_one = d_plain = d_one_plain = 0.0
    bitwise, distinct = True, True
    keys = ("cls_sot", "reg_sot", "obj_sot")
    with torch.inference_mode():
        for t in range(1, PAR_CHECKED + 1):
            x = imgs(t)
            raw = driver.forward(x, feat.reshape(S, *feat.shape[-3:]),
                                 lbs.reshape(S, 1, -1))
            with _plain_serving_kernels():
                raw_p = driver.forward(x, feat.reshape(S, *feat.shape[-3:]),
                                       lbs.reshape(S, 1, -1))
                ones_p = [driver.forward(x[s:s + 1], *refs[s][:2])
                          for s in range(S)]
            d_plain = max(d_plain, max(_rel(lv[key], lp[key]) for lv, lp
                                       in zip(raw, raw_p) for key in keys))
            for s in range(S):
                d_one_plain = max(d_one_plain, max(
                    _rel(lp[key][s:s + 1], lo[key]) for lp, lo in
                    zip(raw_p, ones_p[s]) for key in keys))
            for s in range(S):
                alone = driver.forward(
                    torch.cat([x[s:s + 1]] * S),
                    torch.stack([refs[s][0]] * S).reshape(
                        S, *feat.shape[-3:]),
                    torch.stack([refs[s][1]] * S).reshape(S, 1, -1))
                one = driver.forward(x[s:s + 1], *refs[s][:2])
                for lv, la, lo in zip(raw, alone, one):
                    for key in keys:
                        a, b = lv[key][s:s + 1], la[key][:1]
                        bitwise &= torch.equal(a, b)
                        d_alone = max(d_alone, _rel(a, b))
                        d_one = max(d_one, _rel(b, lo[key]))
            distinct &= all(not torch.equal(packed[t - 1][s],
                                            packed[t - 1][0])
                            for s in range(1, S))
    # the lockstep's boxes after T frames, with the host's state carry
    r = min(exp.test_size[0] / fh, exp.test_size[1] / fw)
    states = [list(b) for b in boxes]
    for p in packed:
        states = [SOTDriver.update_state_from_packed(
            p[s].numpy(), r, states[s], exp.test_size) for s in range(S)]
    d_box = float(np.abs(np.asarray(states) - np.asarray(final)).max())
    print(f"  (c) SOT, {S} sequences x {T} frames in lockstep: "
          f"{S * T / wall:.2f} sequence-frames/s against "
          f"{S * T / wall_seq:.2f} as {S} sequential track runs (upload, "
          f"letterbox and fetch included); sot raw logits against each "
          f"sequence alone at batch {S}: max |d| / max|alone| "
          f"{d_alone:.3e} (tol 1e-3), bit-equal {bitwise}; kernels "
          f"against plain versions at batch {S}: {d_plain:.3e} (tol 0.05); "
          f"the sequence alone at batch {S} against batch 1 (printed): "
          f"{d_one:.3e} through the kernels, {d_one_plain:.3e} through the "
          f"plain versions; final boxes against the sequential runs max "
          f"|d| {d_box:.2f} px; slots distinct {distinct}; launches "
          f"{counts}")
    report["parallel_sot_fps"] = (S * T / wall, S * T / wall_seq)
    _record_launches(report, "parallel_sot", counts)
    assert counts == {k: v * T for k, v in SOT_LAUNCHES.items()}, counts
    assert d_alone <= 1e-3 and distinct and d_plain <= 0.05
    assert all(np.isfinite(p.numpy()).all() for p in packed)


def _parallel_vos(report):
    """(c) make_vos_shared_seq_parallel_fn at PAR_VOS_SEQS sequences of
    PAR_VOS_K slots (5 and 3 objects) on VOS_FRAME_HW frames, PAR_VOS_FRAMES
    lockstep steps with each sequence's tail, 27 / 1 / 1 a step. Each
    sequence's outputs against the sequence alone at the lockstep's batch
    (top detections and mask probabilities within 1e-3, bit-equal
    printed); the lockstep through the three kernels against the same
    through their plain versions at phase harness's VOS bound (top scores
    within 0.05, the masks' mean |d| <= 0.01 with at most 1% of the pixels
    beyond 0.05); and against its own batch-1 track_fn_shared and tail,
    one sequence a call (timed; the top scores, the masks' mean |d| and
    share beyond 0.05 and the label maps' agreement printed, and the
    masks' mean |d| through the plain versions: bf16 at another batch, as
    in (c) SOT)."""
    import copy

    import torch

    from unicorn_torch.drivers.seq_parallel import \
        make_vos_shared_seq_parallel_fn

    exp, drv = _vos_driver(report, PAR_VOS_K)
    S, T, K = PAR_VOS_SEQS, PAR_VOS_FRAMES, PAR_VOS_K
    seqs = [_sot_frames(T, seed=50 + s, hw=VOS_FRAME_HW) for s in range(S)]
    ids = [list(range(1, K + 1)), [1, 2, 3]]
    par, seq_drv = [], []
    for s in range(S):
        for group in (par, seq_drv):
            d = copy.copy(drv)
            d.initialize(seqs[s][0], _vos_masks(ids[s]))
            group.append(d)
    feat1 = torch.stack([d.feat_ref1 for d in par])
    lbs = torch.stack([d.lbs_ref for d in par])
    fn = make_vos_shared_seq_parallel_fn(drv)

    def lockstep(t):
        pre = [par[s].preprocess(seqs[s][t]) for s in range(S)]
        dets, valid, masks = fn(feat1, lbs, torch.cat([p[0] for p in pre]))
        labs = [par[s].postprocess_masks_host(
            dets[s], valid[s], masks[s], pre[s][1])[0] for s in range(S)]
        return pre, (dets[:, :, 0].float(), masks.float()), labs

    for d in (par[0], seq_drv[0]):             # warm-up, tails included
        d.track(seqs[0][1])
    lockstep(1)
    torch.cuda.synchronize()
    _reset_kernel_counts()
    outs, labels, inputs, step_ms = [], [], [], []
    for t in range(1, T + 1):
        t0 = time.perf_counter()
        pre, out, labs = lockstep(t)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        inputs.append(pre)
        outs.append(out)
        labels.append(labs)
    wall = sum(step_ms) / 1e3
    counts = _kernel_counts()
    d_score = d_mean = over = 0.0
    agree = 1.0
    t0 = time.perf_counter()
    for t in range(1, T + 1):
        for s in range(S):
            d = seq_drv[s]
            img, r = d.preprocess(seqs[s][t])
            dets, valid, masks = d.track_fn_shared(img)
            lab = d.postprocess_masks_host(dets, valid, masks, r)[0]
            top_p, m_p = outs[t - 1][0][s], outs[t - 1][1][s]
            top = dets[:, 0].float()
            d_score = max(d_score, (top_p[:, 4] * top_p[:, 5] - top[:, 4]
                                    * top[:, 5]).abs().max().item())
            dm = (m_p - masks.float()).abs()
            d_mean = max(d_mean, dm.mean().item())
            over = max(over, (dm > 0.05).float().mean().item())
            agree = min(agree, float((lab == labels[t - 1][s]).mean()))
    torch.cuda.synchronize()
    wall_seq = time.perf_counter() - t0
    d_alone, bitwise = 0.0, True
    kp = dict(score=0.0, mean=0.0, over=0.0)
    d_mean_plain = 0.0
    for t in range(1, PAR_CHECKED + 1):
        x = torch.cat([p[0] for p in inputs[t - 1]])
        with _plain_serving_kernels():
            dets_p, _, masks_p = fn(feat1, lbs, x)
            ones_p = [seq_drv[s].track_fn_shared(x[s:s + 1])[2].float()
                      for s in range(S)]
        top_k, top_p = outs[t - 1][0], dets_p[:, :, 0].float()
        dm = (outs[t - 1][1] - masks_p.float()).abs()
        kp["score"] = max(kp["score"], (top_k[..., 4] * top_k[..., 5]
                                        - top_p[..., 4] * top_p[..., 5])
                          .abs().max().item())
        kp["mean"] = max(kp["mean"], dm.mean().item())
        kp["over"] = max(kp["over"], (dm > 0.05).float().mean().item())
        d_mean_plain = max(d_mean_plain, max(
            (masks_p[s].float() - ones_p[s]).abs().mean().item()
            for s in range(S)))
        for s in range(S):
            dets, _, masks = fn(torch.stack([par[s].feat_ref1] * S),
                                torch.stack([par[s].lbs_ref] * S),
                                torch.cat([inputs[t - 1][s][0]] * S))
            got = (outs[t - 1][0][s], outs[t - 1][1][s])
            alone = (dets[0, :, 0].float(), masks[0].float())
            bitwise &= all(torch.equal(a, b) for a, b in zip(got, alone))
            d_alone = max(d_alone, max((a - b).abs().max().item()
                                       for a, b in zip(got, alone)))
    print(f"  (c) VOS shared form, {S} sequences (K = {K} slots; {K} and 3 "
          f"objects) x {T} frames of {VOS_FRAME_HW[0]}x{VOS_FRAME_HW[1]} in "
          f"lockstep: {S * T / wall:.2f} sequence-frames/s (steps "
          f"{', '.join(f'{x:.1f}' for x in step_ms)} ms, each ending in its "
          f"tails' fetches) against {S * T / wall_seq:.2f} one sequence a "
          f"call (each with its tail); against each sequence alone at batch "
          f"{S}: top rows and "
          f"masks max |d| {d_alone:.3e} (tol 1e-3), bit-equal {bitwise}; "
          f"kernels against plain versions at batch {S}: top score max |d| "
          f"{kp['score']:.3e} (tol 0.05), masks mean |d| {kp['mean']:.3e} "
          f"(tol 0.01), {kp['over'] * 100:.4f}% beyond 0.05 (tol 1%); "
          f"against its own batch-1 path (printed): top score max |d| "
          f"{d_score:.3e}, masks mean |d| {d_mean:.3e} ({d_mean_plain:.3e} "
          f"through the plain versions), {over * 100:.4f}% beyond 0.05, "
          f"label maps equal on {agree * 100:.3f}% of a frame's pixels at "
          f"least; launches {counts}")
    report["parallel_vos_fps"] = (S * T / wall, S * T / wall_seq)
    _record_launches(report, "parallel_vos", counts)
    assert counts == {k: v * T for k, v in SOT_LAUNCHES.items()}, counts
    assert d_alone <= 1e-3
    assert kp["score"] <= 0.05 and kp["mean"] <= 0.01 and kp["over"] <= 0.01


def _free_port() -> int:
    """A free TCP port on the loopback address, for a world of 1."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_first_step(exp, batch, mesh=None):
    """A fresh seeded unicorn_track_tiny's uni step as trained
    (ExpTrack.get_train_step, AdamW, EMA; given `mesh`, its gradient sum)
    on `batch`, on the card -> the loss dict, the gradients it applied and
    the weights after the update, on the host."""
    import torch

    from unicorn_torch.core.train_state import TrainState

    model = exp.get_model(torch.Generator().manual_seed(0))
    state = TrainState.create(
        model.to(DEVICE).train(),
        exp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH), use_ema=exp.ema,
        device=DEVICE)
    grads, apply = {}, state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().float().cpu()
                      for n, p in state.model.named_parameters()
                      if p.grad is not None})
        return apply()

    state.apply_gradients = capture
    _, loss = exp.get_train_step(TRAIN_B, mesh=mesh)(state, *batch)
    state.apply_gradients = apply
    params = {n: p.detach().cpu() for n, p in state.model.named_parameters()}
    return dict(loss={k: v.item() for k, v in loss.items()}, grads=grads,
                params=params), state


def _dp_batch(exp):
    """phase train_model's mixed batch: an SOT and a MOT pair (8 boxes)."""
    images, targets, task_ids = _train_batch(exp, 2, seed=10, n_obj=8)
    task_ids[0] = 1
    return images, targets, task_ids


def _dp_rank(rank, world, store, out):
    """One rank of the gloo group on the card (spawned): its slice of the
    global batch through the first step of the model in fp32 with TF32 off
    (the comparison) and as trained (bf16 trunk), then PAR_DP_WARMUP +
    PAR_DP_STEPS timed steps as trained; writes both first steps, the
    launches of the timed steps, ms/step and peak memory to `out`."""
    import copy

    import torch
    import torch.distributed as dist

    from unicorn_torch.exp.unicorn_track_tiny import Exp
    from unicorn_torch.parallel import initialize_multihost, shard_batch

    initialize_multihost(num_processes=world, process_id=rank,
                         device=DEVICE, init_method="file://" + store,
                         backend="gloo", timeout_s=300)
    exp = Exp()
    exp32 = copy.copy(exp)
    exp32.bf16 = False
    batch = shard_batch(_dp_batch(exp))
    with tf32_off():
        first32 = _dp_first_step(exp32, batch)[0]
    first, state = _dp_first_step(exp, batch)
    step = exp.get_train_step(TRAIN_B)
    for _ in range(PAR_DP_WARMUP):
        step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_all_counts()
    t0 = time.perf_counter()
    for _ in range(PAR_DP_STEPS):
        step(state, *batch)
    torch.cuda.synchronize()
    torch.save(dict(fp32=first32, bf16=first,
                    ms=(time.perf_counter() - t0) / PAR_DP_STEPS * 1e3,
                    peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                    counts=_all_counts()), out)
    dist.destroy_process_group()


def _parallel_dp(report):
    """(d) Data-parallel training (the kernels built by the parent, phase
    build, before any rank starts): a world of 1 over NCCL against the
    single-card uni step as trained, both with cuDNN's and PyTorch's
    deterministic algorithms and run twice alone: bit-equal where the
    single-card step repeats itself bit for bit, else within its two-run
    spread. Then two ranks over gloo on the one card (NCCL refuses two
    ranks on one card) at B = 1 each against the one-process B = 2 step,
    in fp32 with TF32 off, at phase train_model's bounds (loss within 0.02,
    gradient leaves: worst 0.1, median 0.02, of the leaf's largest): as
    trained, a batch of 1 rounds the bf16 trunk otherwise than a batch of
    2 and flips SimOTA's choices on the anchors at their boundaries, which
    move a gradient by the term's full size (those shares are printed).
    ms/step and peak memory per rank as trained, 36 / 1 / 2 / 2 / 2
    launches a rank and step."""
    import copy
    import multiprocessing as mp
    import tempfile
    import warnings

    import torch
    import torch.distributed as dist

    from unicorn_torch.parallel import initialize_multihost

    exp, _ = _train_model(report)
    exp32 = copy.copy(exp)
    exp32.bf16 = False
    batch = _dp_batch(exp)
    with tf32_off():
        one32 = _dp_first_step(exp32, batch)[0]
    flags = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            single = [_dp_first_step(exp, batch)[0] for _ in range(2)]
            initialize_multihost(
                coordinator_address=f"127.0.0.1:{_free_port()}",
                num_processes=1, process_id=0, device=DEVICE, timeout_s=120)
            try:
                backend = dist.get_backend()
                world1 = _dp_first_step(exp, batch)[0]
            finally:
                dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])
    without = sorted({str(w.message).split(" does not have")[0][:80]
                      for w in caught if "deterministic" in str(w.message)})

    def bitwise(a, b):
        return a["loss"] == b["loss"] and all(
            torch.equal(a[k][n], b[k][n]) for k in ("grads", "params")
            for n in a[k])

    repeats = bitwise(single[0], single[1])
    if repeats:
        ok1 = bitwise(world1, single[0])
    else:
        spread = max(_grad_shares(single[0]["grads"],
                                  single[1]["grads"])[0].values())
        ok1 = max(_grad_shares(single[0]["grads"],
                               world1["grads"])[0].values()) <= spread
    print(f"  (d) world of 1 over {backend} against the single-card uni "
          f"step (B = {TRAIN_B}, deterministic algorithms; ops without "
          f"one: {without or 'none'}): the single-card step repeats bit for "
          f"bit {repeats}; world 1 "
          f"{'bit-equal' if repeats else 'within the two-run spread'} "
          f"{ok1} (loss {world1['loss']['total_loss']:.6f} vs "
          f"{single[0]['loss']['total_loss']:.6f})")
    assert ok1 and backend == ("nccl" if DEVICE.startswith("cuda")
                               else "gloo")
    torch.cuda.empty_cache()     # the ranks' own processes take the card

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dp_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(2)]
        procs = [ctx.Process(target=_dp_rank, args=(
            r, 2, os.path.join(tmp, "store"), outs[r])) for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        wall = time.perf_counter() - t0
        for p in procs:
            if p.is_alive():
                p.kill()
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        ranks = [torch.load(o) for o in outs]
    same = all(ranks[0][k]["loss"] == ranks[1][k]["loss"] and all(
        torch.equal(v, ranks[1][k]["params"][n])
        for n, v in ranks[0][k]["params"].items()) for k in ("fp32", "bf16"))
    shares, worst, median = _grad_shares(one32["grads"],
                                         ranks[0]["fp32"]["grads"])
    loss32 = ranks[0]["fp32"]["loss"]["total_loss"]
    d_loss = abs(loss32 - one32["loss"]["total_loss"]) \
        / abs(one32["loss"]["total_loss"])
    shares16, worst16, median16 = _grad_shares(single[0]["grads"],
                                               ranks[0]["bf16"]["grads"])
    for r, res in enumerate(ranks):
        print(f"  (d) gloo rank {r} of 2 on {DEVICE}, B = 1 of the global "
              f"{TRAIN_B}: {res['ms']:.1f} ms/step over {PAR_DP_STEPS} "
              f"steps, peak memory {res['peak']:.2f} GiB, launches "
              f"{res['counts']}")
    print(f"  (d) 2 gloo ranks against the one-process B = {TRAIN_B} step, "
          f"fp32 with TF32 off: ranks hold one state {same}; total_loss "
          f"{loss32:.5f} vs {one32['loss']['total_loss']:.5f} (rel "
          f"{d_loss:.2e}, bound 0.02); worst gradient leaf "
          f"{shares[worst]:.3e} of its max at {worst} (bound 0.1), median "
          f"{median:.3e} (bound 0.02); as trained (bf16 trunk, printed): "
          f"worst leaf {shares16[worst16]:.3e} at {worst16}, median "
          f"{median16:.3e}; the two ranks {wall:.1f} s from spawn to exit")
    report["parallel_dp"] = [(res["ms"], res["peak"]) for res in ranks]
    _record_launches(report, "parallel_dp_rank0", ranks[0]["counts"])
    for res in ranks:
        assert res["counts"] == {k: v * PAR_DP_STEPS
                                 for k, v in TRAIN_LAUNCHES.items()}, \
            res["counts"]
    assert same and d_loss <= 0.02
    assert shares[worst] <= 0.1 and median <= 0.02


def phase_parallel(report):
    """The batched and multi-process forms on one card: (a)
    `_parallel_stream`, (b) `_parallel_multistream`, (c) `_parallel_sot`
    and `_parallel_vos`, (d) `_parallel_dp`."""
    print(f"parallel ({report.get('card', '')})")
    _parallel_stream(report)
    _parallel_multistream(report)
    _parallel_sot(report)
    _parallel_vos(report)
    _parallel_dp(report)


# --------------------------------------------------------- multi-card forms
MC_RANKS = 4              # (b) gloo ranks sharing the card
MC_FRAMES = 2             # timed spatial frames a rank, after one warm-up
MC_STREAMS = 4            # (b) MultiStreamMOT streams over the ranks ...
MC_TICKS = 8              # ... and ticks
MC_SOT_STEPS = 2          # (b) lockstep SOT steps, one sequence a rank
MC_EXP_FIELDS = {}        # fields set on every exp of the phase
# spatial_detect_fn's defaults (JAX's): the detector of the streaming path
MC_DETECT = dict(conf_thre=0.1, nms_thre=0.8, n_cand=128, max_out=64)
# what a rank process takes of this module's settings
MC_SETTINGS = ("DEVICE", "FRAME_HW", "INIT_BOX", "MC_FRAMES", "MC_STREAMS",
               "MC_TICKS", "MC_SOT_STEPS", "MC_EXP_FIELDS")


def _sync():
    import torch

    if DEVICE.startswith("cuda"):
        torch.cuda.synchronize()


def _mc_exp(bf16=True, backbone=None):
    """unicorn_track_tiny with MC_EXP_FIELDS; with `backbone`, that trunk,
    as phase backbones builds it (`_backbone_exp`)."""
    from unicorn_torch.exp.unicorn_track_tiny import Exp

    exp = (Exp() if backbone is None else
           _backbone_exp("unicorn_track_tiny", backbone_name=backbone))
    for k, v in MC_EXP_FIELDS.items():
        setattr(exp, k, v)
    if not bf16:
        exp.bf16 = False
    return exp


def _mc_model(exp, serve=False):
    """The exp's model, seeded 0, on the card: with serve, the served SOT
    model; else the detector with its obj / cls biases raised by 6."""
    import torch

    gen = torch.Generator().manual_seed(0)
    if serve:
        return exp.get_model(gen, serve=True).to(DEVICE).eval()
    model = exp.get_model(gen)
    _raise_priors(model)
    return model.to(DEVICE).eval()


def _mc_image(exp):
    """One seeded frame at the exp's test size, (1, 3, H, W) float32 on the
    card."""
    import numpy as np
    import torch

    H, W = exp.test_size
    rng = np.random.RandomState(0)
    img = (rng.rand(1, H, W, 3) * 255).round().astype(np.float32)
    return torch.from_numpy(img).to(DEVICE).permute(0, 3, 1, 2)


def _mc_one_card(model, x, nc):
    """The one-card detector: forward_whole -> decode -> NMS."""
    import torch

    from unicorn_torch.models.heads import decode_for_inference
    from unicorn_torch.ops.nms import postprocess_device

    with torch.inference_mode():
        raw, _ = model.forward_whole(x)
        dec = decode_for_inference(raw, (8, 16, 32), mode="mot")
        return postprocess_device(dec, num_classes=nc,
                                  class_agnostic=nc == 1, **MC_DETECT)


def _mc_match(got, ref):
    """The spatial detector's (dets, valid) against the one-card one's, at
    JAX's bounds (tests/test_spatial.py:54-61): every valid score clear of
    conf_thre by 1e-4, and, index by index as JAX's test compares, the
    valid bits equal and each valid row within rtol 2e-4, atol 2e-3
    (`index_ok`, the verdict `ok`). Also each valid row of the reference
    against the spatial row nearest its box (`nearest_ok`; rows of
    near-equal scores may swap in the sorted output). Returns those, the
    valid counts, the share of equal valid bits and the largest box offset
    index by index and to the nearest box."""
    import torch

    dets, valid = (t.float().cpu() for t in got)
    dets_1, valid_1 = (t.float().cpu() for t in ref)
    valid, valid_1 = valid > 0.5, valid_1 > 0.5
    score = dets_1[..., 4] * dets_1[..., 5]
    clear = bool((~valid_1 | ((score - MC_DETECT["conf_thre"]).abs()
                              > 1e-4)).all())
    both = valid & valid_1
    within = (dets - dets_1).abs() <= 2e-3 + 2e-4 * dets_1.abs()
    index_ok = clear and bool(torch.equal(valid, valid_1)
                              and within.all(-1)[both].all()
                              and both.any())
    index_offset = float((dets[..., :4] - dets_1[..., :4]).abs()
                         .amax(-1)[both].max()) if both.any() else 0.0
    nearest_ok, offset = clear, 0.0
    for b in range(dets.shape[0]):
        want, have = dets_1[b][valid_1[b]], dets[b][valid[b]]
        nearest_ok &= len(want) == len(have) > 0
        for row in want:
            if not len(have):
                break
            d = (have[:, :4] - row[:4]).abs().max(1).values
            j = int(d.argmin())
            offset = max(offset, float(d[j]))
            nearest_ok &= bool(((have[j] - row).abs()
                                <= 2e-3 + 2e-4 * row.abs()).all())
    return dict(ok=index_ok, index_ok=index_ok, nearest_ok=nearest_ok,
                clear=clear, n=int(valid.sum()), n_ref=int(valid_1.sum()),
                equal_bits=float((valid == valid_1).float().mean()),
                index_offset=index_offset, offset=offset)


def _mc_str(m):
    return (f"{m['n']} / {m['n_ref']} valid, valid bits equal "
            f"{m['equal_bits']:.1%}, largest box offset index by index "
            f"{m['index_offset']:.2e} px (within bounds {m['index_ok']}), "
            f"to the nearest box {m['offset']:.2e} px (within bounds "
            f"{m['nearest_ok']})")


# the ops of models/blocks.py that run differently inside row_sharded, and
# the method that holds each one's row hook
MC_HOOKS = {"Conv2d": "forward", "GroupNorm32": "forward",
            "DepthwiseConv7x7": "forward_nhwc", "MaxPool2d": "forward"}


def _mc_hook_study(model, x, nc, mesh, ref):
    """bf16 at sp = 1, where every halo is padding: the packed head maps
    and the detections with every row hook on, with each hook of MC_HOOKS
    swapped back to its one-card op alone, and with all swapped back,
    against the one-card detector `ref`; and the one-card detector run
    again (is it deterministic?). Which op moves the bf16 boxes. Returns
    {variant: (maps differing, their share, max |diff|, _mc_match)}."""
    from unittest import mock

    import torch

    from unicorn_torch.models import blocks
    from unicorn_torch.parallel import rows
    from unicorn_torch.parallel.spatial import spatial_detect_fn

    def one_card(name):
        cls = getattr(blocks, name)
        real = getattr(cls, MC_HOOKS[name])

        def unhooked(self, *args):
            with rows.row_sharded(None):
                return real(self, *args)
        return mock.patch.object(cls, MC_HOOKS[name], unhooked)

    plan = rows.RowPlan((1,), 0, mesh.group)
    fn = spatial_detect_fn(model, mesh, num_classes=nc, **MC_DETECT)
    keys = ("_cls_packed", "_reg_packed")
    with torch.inference_mode():
        raw_1, _ = model.forward_whole(x)
    variants = [("every hook on", (), True)]
    variants += [(f"{n} one-card", (n,), True) for n in MC_HOOKS]
    variants += [("all one-card", tuple(MC_HOOKS), True),
                 ("one-card again", (), False)]
    out = {}
    for label, swapped, sharded in variants:
        with contextlib.ExitStack() as stack, torch.inference_mode():
            for name in swapped:
                stack.enter_context(one_card(name))
            if sharded:
                with rows.row_sharded(plan):
                    raw, _ = model.forward_whole(x)
                dets = fn(x)
            else:
                raw, _ = model.forward_whole(x)
                dets = _mc_one_card(model, x, nc)
        diff = [(r[k].float() - r1[k].float()).abs()
                for r, r1 in zip(raw, raw_1) for k in keys]
        n = sum(int((d != 0).sum()) for d in diff)
        out[label] = (n, n / sum(d.numel() for d in diff),
                      max(float(d.max()) for d in diff),
                      _mc_match(dets, ref))
    return out


def _multicard_world1(report):
    """(a) A world of 1 over NCCL: spatial_detect_fn at sp = 1 (the row
    plan, the halo and GroupNorm exchanges and the gather running) against
    the one-card detector, in fp32 with TF32 off at JAX's bounds, and in
    bf16 as served (printed), with which row hook moves the bf16 boxes
    (`_mc_hook_study`, printed); 27 dw7x7 launches a frame. Keeps the
    one-card detections for (b)."""
    import torch
    import torch.distributed as dist

    from unicorn_torch.parallel import initialize_multihost, make_mesh
    from unicorn_torch.parallel.spatial import spatial_detect_fn

    exp32, exp = _mc_exp(bf16=False), _mc_exp()
    nc = exp.num_classes
    x = _mc_image(exp)
    m32 = _mc_model(exp32)
    m16 = _mc_model(exp)
    initialize_multihost(coordinator_address=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, device=DEVICE,
                         timeout_s=120)
    try:
        backend = dist.get_backend()
        mesh = make_mesh((1,), ("sp",), device=DEVICE)
        with tf32_off():
            one32 = _mc_one_card(m32, x, nc)
            sp32 = spatial_detect_fn(m32, mesh, num_classes=nc,
                                     **MC_DETECT)(x)
        one16 = _mc_one_card(m16, x, nc)
        fn16 = spatial_detect_fn(m16, mesh, num_classes=nc, **MC_DETECT)
        fn16(x)                                     # warm-up, not counted
        _sync()
        _reset_kernel_counts()
        sp16 = fn16(x)
        _sync()
        counts = _kernel_counts()
        study = _mc_hook_study(m16, x, nc, mesh, one16)
        ms = {}
        for name, f in (("one-card", lambda: _mc_one_card(m16, x, nc)),
                        ("sp = 1", lambda: fn16(x))) * 2:
            t0 = time.perf_counter()
            for _ in range(MC_FRAMES):
                f()
            _sync()
            ms.setdefault(name, []).append(
                (time.perf_counter() - t0) / MC_FRAMES * 1e3)
    finally:
        dist.destroy_process_group()
    r32, r16 = _mc_match(sp32, one32), _mc_match(sp16, one16)
    H, W = exp.test_size
    print(f"  (a) world of 1 over {backend}, spatial_detect_fn at sp = 1 on "
          f"{H}x{W} against the one-card detector: fp32 (TF32 off) "
          f"{_mc_str(r32)}, within JAX's bounds {r32['ok']}; bf16 as served "
          f"(printed): {_mc_str(r16)}; launches {counts}; bf16 ms a frame "
          f"on {report.get('card', '')} (host clock, {MC_FRAMES} frames, "
          f"order one-card, sp = 1, one-card, sp = 1): one-card "
          f"{' / '.join(f'{v:.1f}' for v in ms['one-card'])}, sp = 1 "
          f"{' / '.join(f'{v:.1f}' for v in ms['sp = 1'])}")
    print("  (a) bf16 at sp = 1, which row hook moves the boxes: the packed "
          "head maps against the one-card detector's, and the detections")
    for label, (n, share, big, m) in study.items():
        print(f"    {label}: {n} map values differ ({share:.2%}), max |diff| "
              f"{big:.3e}; {_mc_str(m)}")
    report["mc_world1_ms"] = ms
    report["mc_one"] = dict(fp32=[t.cpu() for t in one32],
                            bf16=[t.cpu() for t in one16])
    _record_launches(report, "multicard_world1", counts)
    del m32, m16
    assert backend == ("nccl" if DEVICE.startswith("cuda") else "gloo")
    assert r32["ok"], r32
    assert counts == PAR_FRAME, counts


def _spawn_ranks(target):
    """MC_RANKS processes of target(rank, MC_RANKS, store, out, settings)
    sharing the card over gloo (NCCL refuses two ranks on one card),
    spawned, with the module's MC_SETTINGS; each must exit 0 within 600 s.
    Returns (what each wrote to its `out`, seconds from spawn to exit)."""
    import multiprocessing as mp
    import tempfile

    import torch

    if DEVICE.startswith("cuda"):
        torch.cuda.empty_cache()     # the ranks' own processes take the card
    settings = {k: globals()[k] for k in MC_SETTINGS}
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mc_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(MC_RANKS)]
        procs = [ctx.Process(target=target, args=(
            r, MC_RANKS, os.path.join(tmp, "store"), outs[r], settings))
            for r in range(MC_RANKS)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        wall = time.perf_counter() - t0
        for p in procs:
            if p.is_alive():
                p.kill()
        assert all(p.exitcode == 0 for p in procs), \
            [p.exitcode for p in procs]
        return [torch.load(o) for o in outs], wall


def _mc_spatial(exp32, exp, mesh, x):
    """spatial_detect_fn over the "sp" mesh on this rank's rows x of (a)'s
    frame, in fp32 with TF32 off and in bf16 (MC_FRAMES timed frames, their
    launches, each dw7x7 call's inputs of a frame recorded); one more frame
    with every exchange synchronised and timed alone; then the recorded
    calls through the kernel and the plain version. Returns what it found
    and the bf16 model."""
    from unittest import mock

    import torch

    from unicorn_torch.models import blocks
    from unicorn_torch.ops import dwconv7x7 as dw
    from unicorn_torch.parallel import rows
    from unicorn_torch.parallel.spatial import spatial_detect_fn

    nc = exp.num_classes
    res = {}
    m32 = _mc_model(exp32)
    with tf32_off():
        res["fp32"] = [o.cpu() for o in spatial_detect_fn(
            m32, mesh, num_classes=nc, **MC_DETECT)(x)]
    del m32
    m16 = _mc_model(exp)
    fn = spatial_detect_fn(m16, mesh, num_classes=nc, **MC_DETECT)
    calls, real = {}, blocks.dwconv7x7

    def record(xx, k, b):
        calls.setdefault(tuple(xx.shape), (xx.clone(), k.clone(), b.clone()))
        return real(xx, k, b)

    with mock.patch.object(blocks, "dwconv7x7", record):
        fn(x)                                       # warm-up, not counted
    _sync()
    _reset_kernel_counts()
    t0 = time.perf_counter()
    for _ in range(MC_FRAMES):
        got = fn(x)
    _sync()
    res["ms"] = (time.perf_counter() - t0) / MC_FRAMES * 1e3
    res["counts"] = _kernel_counts()
    res["bf16"] = [o.cpu() for o in got]
    # one more frame with every exchange timed alone (synchronised before
    # and after): how many a frame, their bytes, their share of the frame
    tally = dict(n=0, bytes=0, ms=0.0)
    reduce = rows.all_reduce

    def timed_reduce(t_, ranks):
        _sync()
        t1 = time.perf_counter()
        reduce(t_, ranks)
        _sync()
        tally["ms"] += (time.perf_counter() - t1) * 1e3
        tally["n"] += 1
        tally["bytes"] += t_.numel() * t_.element_size()
        return t_

    with mock.patch.object(rows, "all_reduce", timed_reduce):
        _sync()
        t0 = time.perf_counter()
        fn(x)
        _sync()
    res["exchanges"] = dict(tally, frame_ms=(time.perf_counter() - t0) * 1e3)
    res["dw"] = []
    with tf32_off():
        for shape, (xx, k, b) in calls.items():
            yk, yp = dw.dwconv7x7(xx, k, b), dw.dwconv7x7_plain(xx, k, b)
            err = float((yk.float() - yp.float()).abs().max())
            if xx.dtype == torch.bfloat16:
                good = dw_beyond_tolerance_bf16(xx, k, b, yk, yp) == 0
            else:
                good = err <= 1e-4 * max(1.0, float(yp.abs().max()))
            res["dw"].append((shape, str(xx.dtype), err, good))
    return res, m16


def _mc_rank(rank, world, store, out, settings):
    """One of MC_RANKS gloo ranks on the card (spawned): the int32
    all-reduce every exchange runs on; `_mc_spatial` over an "sp" mesh;
    MultiStreamMOT over a "stream" mesh against the one-card MultiStreamMOT
    on the rank's streams; lockstep SOT over a "seq" mesh against the
    rank's sequence alone at batch 1. Writes what it found to `out`."""
    globals().update(settings)

    import torch
    import torch.distributed as dist

    from unicorn_torch.drivers.seq_parallel import make_sot_seq_parallel_fn
    from unicorn_torch.drivers.sot import SOTDriver
    from unicorn_torch.drivers.stream import MultiStreamMOT
    from unicorn_torch.parallel import initialize_multihost, make_mesh
    from unicorn_torch.parallel.spatial import spatial_rows

    initialize_multihost(num_processes=world, process_id=rank,
                         device=DEVICE, init_method="file://" + store,
                         backend="gloo", timeout_s=300)
    res = {}
    t = torch.full((3,), rank + 1, dtype=torch.int32, device=DEVICE)
    dist.all_reduce(t)
    res["int32_sum"] = t.tolist()

    exp32, exp = _mc_exp(bf16=False), _mc_exp()
    sp = make_mesh((world,), ("sp",), device=DEVICE)
    x = _mc_image(exp)
    start, stop = res["rows"] = spatial_rows(sp, x.shape[2])
    found, m16 = _mc_spatial(exp32, exp, sp,
                             x[:, :, start:stop].contiguous())
    res.update(found)

    st = make_mesh((world,), ("stream",), device=DEVICE)
    multi = MultiStreamMOT(m16, MC_STREAMS, mesh=st, **_stream_kw(exp))
    mine = range(multi.first, multi.first + multi.local_streams)
    frames = torch.stack([torch.cat([_ingest(exp, f) for f in _par_frames(
        MC_TICKS, seed=30 + s)]) for s in mine])   # (S / W, T, H, W, 3)
    multi.tick(frames[:, 0])                        # warm-up
    multi.pipe.reset()
    _sync()
    t0 = time.perf_counter()
    out_m = torch.stack([multi.tick(frames[:, i]) for i in range(MC_TICKS)],
                        1)
    _sync()
    res["stream_ms"] = (time.perf_counter() - t0) / MC_TICKS * 1e3
    one = MultiStreamMOT(m16, multi.local_streams, device=DEVICE,
                         **_stream_kw(exp))
    ref = torch.stack([one.tick(frames[:, i]) for i in range(MC_TICKS)], 1)
    res["stream"] = dict(first=multi.first, equal=torch.equal(out_m, ref),
                         n_valid=int((out_m[..., 6] > 0.5).sum()))
    del m16, multi, one

    driver = SOTDriver(_mc_model(exp, serve=True), input_size=exp.test_size,
                       conf_thre=0.0, nms_thre=exp.nmsthre, device=DEVICE)
    fh, fw = FRAME_HW
    seqs = [_sot_frames(MC_SOT_STEPS, seed=40 + s) for s in range(world)]
    refs = [driver.init_refs(seq[0], [INIT_BOX[0] + fw // 32 * s,
                                      INIT_BOX[1] + fh // 36 * s,
                                      *INIT_BOX[2:]])
            for s, seq in enumerate(seqs)]
    feat = torch.stack([r[0] for r in refs])
    lbs = torch.stack([r[1] for r in refs])
    fn_seq = make_sot_seq_parallel_fn(
        driver, make_mesh((world,), ("seq",), device=DEVICE))
    alone = make_sot_seq_parallel_fn(driver)

    def imgs(i):
        return torch.cat([driver.preprocess(seq[i])[0] for seq in seqs])

    fn_seq(feat, lbs, imgs(1))                      # warm-up
    _sync()
    _reset_kernel_counts()
    packed = [fn_seq(feat, lbs, imgs(i)) for i in range(1, MC_SOT_STEPS + 1)]
    _sync()
    res["sot_counts"] = _kernel_counts()
    own = [alone(feat[rank:rank + 1], lbs[rank:rank + 1],
                 imgs(i)[rank:rank + 1]) for i in range(1, MC_SOT_STEPS + 1)]
    res["sot"] = dict(packed=[p.cpu() for p in packed],
                      own=[o.cpu() for o in own])
    torch.save(res, out)
    dist.destroy_process_group()


def _multicard_ranks(report):
    """(b) MC_RANKS gloo ranks sharing the card (NCCL refuses two ranks on
    one device), spawned as phase parallel's (d) spawns its two: gloo's
    int32 all-reduce on card tensors; spatial_detect_fn at sp = MC_RANKS
    (800 rows: 7 / 6 / 6 / 6 units of 32) in fp32 at (a)'s bounds against
    the one-card detector and in bf16 (printed), the ranks returning the
    same detections; 27 dw7x7 launches a frame and rank, the kernel
    against its plain version at each of the rank's call shapes (bf16:
    one ulp plus the bound on two fp32 sums; fp32: 1e-4 of the largest
    magnitude, or 1e-4 below 1); MultiStreamMOT at MC_STREAMS streams,
    each rank's equal bit for bit to the one-card form on its streams;
    lockstep SOT, one sequence a rank, every rank returning all sequences,
    each equal bit for bit to its sequence alone at batch 1, with phase
    sot's launches a step. ms a frame a rank are those of one shared card:
    no multi-card latency."""
    import torch

    from unicorn_torch.parallel.rows import split_units

    ranks, wall = _spawn_ranks(_mc_rank)
    one = report["mc_one"]
    card = report.get("card", "")
    H = _mc_exp().test_size[0]
    units = split_units(H, MC_RANKS)
    r32, r16 = _mc_match(ranks[0]["fp32"], one["fp32"]), _mc_match(
        ranks[0]["bf16"], one["bf16"])
    agree = all(torch.equal(a, b) for res in ranks[1:] for key in
                ("fp32", "bf16") for a, b in zip(res[key], ranks[0][key]))
    print(f"  (b) {MC_RANKS} gloo ranks on {DEVICE}, rows "
          f"{[res['rows'] for res in ranks]} ({units} units of 32); int32 "
          f"all-reduce {ranks[0]['int32_sum']}; spatial_detect_fn against "
          f"the one-card detector: fp32 (TF32 off) {_mc_str(r32)}, within "
          f"JAX's bounds {r32['ok']}; bf16 (printed) {_mc_str(r16)}; ranks "
          f"agree {agree}")
    for r, res in enumerate(ranks):
        shapes = ", ".join(f"{s[1]}x{s[2]}x{s[3]} {dt[6:]}"
                           for s, dt, _, _ in res["dw"])
        sot_alone = all(torch.equal(p[r], o[0]) for p, o in zip(
            res["sot"]["packed"], res["sot"]["own"]))
        print(f"  (b) rank {r} on {card}: {res['ms']:.1f} ms a frame over "
              f"{MC_FRAMES} bf16 frames and {res['stream_ms']:.1f} ms a "
              f"MultiStreamMOT "
              f"tick ({MC_RANKS} ranks sharing one card: not a multi-card "
              f"latency); launches {res['counts']}; dw7x7 kernel vs plain "
              f"at its {len(res['dw'])} call shapes ({shapes}): all "
              f"within tolerance {all(d[3] for d in res['dw'])}, max |err| "
              f"{max(d[2] for d in res['dw']):.3e}; streams "
              f"{res['stream']['first']}.. equal to the one-card form "
              f"{res['stream']['equal']} ({res['stream']['n_valid']} valid "
              f"rows); SOT slot equal to its sequence alone {sot_alone}, "
              f"launches {res['sot_counts']}")
    for r, res in enumerate(ranks):
        ex = res["exchanges"]
        print(f"  (b) rank {r} on {card}, one frame with each exchange "
              f"synchronised and timed alone: {ex['n']} all-reduces, "
              f"{ex['bytes'] / 2 ** 20:.1f} MiB summed, {ex['ms']:.1f} ms "
              f"of the frame's {ex['frame_ms']:.1f} inside them")
    print(f"  (b) the {MC_RANKS} ranks {wall:.1f} s from spawn to exit on "
          f"{card}")
    report["multicard_ms"] = [res["ms"] for res in ranks]
    _record_launches(report, "multicard_rank0", ranks[0]["counts"])
    assert r32["ok"] and agree, r32
    assert [tuple(res["rows"]) for res in ranks] == [
        (32 * sum(units[:r]), 32 * sum(units[:r + 1]))
        for r in range(MC_RANKS)]
    for r, res in enumerate(ranks):
        assert res["int32_sum"] == [MC_RANKS * (MC_RANKS + 1) // 2] * 3
        assert res["counts"] == {k: v * MC_FRAMES for k, v in
                                 PAR_FRAME.items()}, res["counts"]
        assert res["dw"] and all(d[3] for d in res["dw"]), res["dw"]
        assert res["stream"]["equal"] and res["stream"]["n_valid"] > 0
        assert res["sot_counts"] == {k: v * MC_SOT_STEPS for k, v in
                                     SOT_LAUNCHES.items()}, res["sot_counts"]
        for p, p0, o in zip(res["sot"]["packed"], ranks[0]["sot"]["packed"],
                            res["sot"]["own"]):
            assert torch.equal(p, p0) and torch.equal(p[r], o[0])


def _mc_swin_rank(rank, world, store, out, settings):
    """(c) One of MC_RANKS gloo ranks on the card (spawned): `_mc_spatial`
    of the Swin-T detector over an "sp" mesh on the rank's rows."""
    globals().update(settings)

    import torch
    import torch.distributed as dist

    from unicorn_torch.parallel import initialize_multihost, make_mesh
    from unicorn_torch.parallel.spatial import spatial_rows

    initialize_multihost(num_processes=world, process_id=rank,
                         device=DEVICE, init_method="file://" + store,
                         backend="gloo", timeout_s=300)
    exp32, exp = (_mc_exp(bf16=False, backbone="swin_tiny"),
                  _mc_exp(backbone="swin_tiny"))
    sp = make_mesh((world,), ("sp",), device=DEVICE)
    x = _mc_image(exp)
    res = {"rows": spatial_rows(sp, x.shape[2])}
    start, stop = res["rows"]
    res.update(_mc_spatial(exp32, exp, sp,
                           x[:, :, start:stop].contiguous())[0])
    torch.save(res, out)
    dist.destroy_process_group()


def _multicard_swin(report):
    """(c) unicorn_track_tiny with the Swin-T trunk (phase backbones' model)
    split by rows: spatial_detect_fn at sp = 1 on a world of 1 over NCCL
    and at sp = MC_RANKS on gloo ranks sharing the card (spawned; 7 / 6 /
    6 / 6 units), each in fp32 with TF32 off at (a)'s bounds against the
    one-card Swin-T detector, the ranks returning the same detections, and
    in bf16 as served (printed); 9 dw7x7 launches a frame and rank (the
    head's; the trunk has none), the kernel against its plain version at
    each rank's call shapes; ms a frame (sp = 1 beside the one-card
    detector; a rank's are those of one shared card, no multi-card
    latency)."""
    import torch
    import torch.distributed as dist

    from unicorn_torch.parallel import initialize_multihost, make_mesh
    from unicorn_torch.parallel.rows import split_units
    from unicorn_torch.parallel.spatial import spatial_detect_fn

    card = report.get("card", "")
    exp32, exp = (_mc_exp(bf16=False, backbone="swin_tiny"),
                  _mc_exp(backbone="swin_tiny"))
    nc = exp.num_classes
    x = _mc_image(exp)
    m32, m16 = _mc_model(exp32), _mc_model(exp)
    initialize_multihost(coordinator_address=f"127.0.0.1:{_free_port()}",
                         num_processes=1, process_id=0, device=DEVICE,
                         timeout_s=120)
    try:
        backend = dist.get_backend()
        mesh = make_mesh((1,), ("sp",), device=DEVICE)
        with tf32_off():
            one32 = _mc_one_card(m32, x, nc)
            sp32 = spatial_detect_fn(m32, mesh, num_classes=nc,
                                     **MC_DETECT)(x)
        one16 = _mc_one_card(m16, x, nc)
        fn16 = spatial_detect_fn(m16, mesh, num_classes=nc, **MC_DETECT)
        fn16(x)                                     # warm-up, not counted
        _sync()
        _reset_kernel_counts()
        sp16 = fn16(x)
        _sync()
        counts = _kernel_counts()
        ms = {}
        for name, f in (("one-card", lambda: _mc_one_card(m16, x, nc)),
                        ("sp = 1", lambda: fn16(x))) * 2:
            t0 = time.perf_counter()
            for _ in range(MC_FRAMES):
                f()
            _sync()
            ms.setdefault(name, []).append(
                (time.perf_counter() - t0) / MC_FRAMES * 1e3)
    finally:
        dist.destroy_process_group()
    del m32, m16
    r32, r16 = _mc_match(sp32, one32), _mc_match(sp16, one16)
    H, W = exp.test_size
    print(f"  (c) Swin-T, world of 1 over {backend}, spatial_detect_fn at "
          f"sp = 1 on {H}x{W} against the one-card Swin-T detector: fp32 "
          f"(TF32 off) {_mc_str(r32)}, within JAX's bounds {r32['ok']}; "
          f"bf16 as served (printed): {_mc_str(r16)}; launches {counts}; "
          f"bf16 ms a frame on {card} (host clock, {MC_FRAMES} frames, "
          f"order one-card, sp = 1, one-card, sp = 1): one-card "
          f"{' / '.join(f'{v:.1f}' for v in ms['one-card'])}, sp = 1 "
          f"{' / '.join(f'{v:.1f}' for v in ms['sp = 1'])}")
    _record_launches(report, "multicard_swin_world1", counts)
    assert backend == ("nccl" if DEVICE.startswith("cuda") else "gloo")
    assert r32["ok"], r32
    assert counts == HEAD_ONLY_FRAME, counts

    ranks, wall = _spawn_ranks(_mc_swin_rank)
    units = split_units(H, MC_RANKS)
    q32, q16 = _mc_match(ranks[0]["fp32"], one32), _mc_match(
        ranks[0]["bf16"], one16)
    agree = all(torch.equal(a, b) for res in ranks[1:] for key in
                ("fp32", "bf16") for a, b in zip(res[key], ranks[0][key]))
    print(f"  (c) Swin-T, {MC_RANKS} gloo ranks on {DEVICE}, rows "
          f"{[res['rows'] for res in ranks]} ({units} units of 32); "
          f"spatial_detect_fn against the one-card Swin-T detector: fp32 "
          f"(TF32 off) {_mc_str(q32)}, within JAX's bounds {q32['ok']}; "
          f"bf16 (printed) {_mc_str(q16)}; ranks agree {agree}")
    for r, res in enumerate(ranks):
        shapes = ", ".join(f"{s[1]}x{s[2]}x{s[3]} {dt[6:]}"
                           for s, dt, _, _ in res["dw"])
        ex = res["exchanges"]
        print(f"  (c) Swin-T rank {r} on {card}: {res['ms']:.1f} ms a frame "
              f"over {MC_FRAMES} bf16 frames ({MC_RANKS} ranks sharing one "
              f"card: not a multi-card latency); launches {res['counts']}; "
              f"dw7x7 kernel vs plain at its {len(res['dw'])} call shapes "
              f"({shapes}): all within tolerance "
              f"{all(d[3] for d in res['dw'])}, max |err| "
              f"{max(d[2] for d in res['dw']):.3e}; one frame with each "
              f"exchange synchronised and timed alone: {ex['n']} "
              f"all-reduces, {ex['bytes'] / 2 ** 20:.1f} MiB summed, "
              f"{ex['ms']:.1f} ms of the frame's {ex['frame_ms']:.1f} inside "
              f"them")
    print(f"  (c) the {MC_RANKS} ranks {wall:.1f} s from spawn to exit on "
          f"{card}")
    report["multicard_swin_ms"] = dict(world1=ms,
                                       ranks=[res["ms"] for res in ranks])
    _record_launches(report, "multicard_swin_rank0", ranks[0]["counts"])
    assert q32["ok"] and agree, q32
    assert [tuple(res["rows"]) for res in ranks] == [
        (32 * sum(units[:r]), 32 * sum(units[:r + 1]))
        for r in range(MC_RANKS)]
    for res in ranks:
        assert res["counts"] == {k: v * MC_FRAMES for k, v in
                                 HEAD_ONLY_FRAME.items()}, res["counts"]
        assert res["dw"] and all(d[3] for d in res["dw"]), res["dw"]


def _pod_batch(exp):
    """4 pairs, one a rank: phase train_model's SOT pairs (a box) and MOT
    pairs (8 boxes) in turn, so that each node of the (2, 2) mesh holds
    one of each."""
    import torch

    sot = _train_batch(exp, 1, seed=20, n_obj=1)
    mot = _train_batch(exp, 2, seed=21, n_obj=8)
    order = torch.tensor([0, 2, 1, 3], device=sot[0].device)
    return tuple(torch.cat([a, b])[order] for a, b in zip(sot, mot))


def _digest(tensors: dict) -> str:
    """A hash of the bytes of every tensor, in name order."""
    import hashlib

    import torch

    h = hashlib.sha256()
    for name in sorted(tensors):
        h.update(name.encode())
        h.update(tensors[name].contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def _mc_pod_rank(rank, world, store, out, settings):
    """(d) One of MC_RANKS gloo ranks on the card (spawned), torchrun's node
    variables set as two nodes of two ranks (ranks 0, 1 and 2, 3): the
    (2, 2) pod mesh, then the uni step of a fresh seeded
    unicorn_track_tiny on the rank's pair in fp32 with TF32 off, given the
    mesh (each dw7x7, MSDA and training-correlation call through its
    kernel, held against its plain version; the launches counted) and on
    the flat group; each step's loss dict, the pod step's gradient leaves
    against the flat step's, and digests of the weights after each."""
    from unittest import mock

    globals().update(settings)

    import torch
    import torch.distributed as dist

    from unicorn_torch.losses import uni as uni_mod
    from unicorn_torch.models import blocks, interaction
    from unicorn_torch.parallel import (initialize_multihost, make_pod_mesh,
                                        shard_batch)

    # the ranks share the card whatever LOCAL_RANK says
    dev = "cuda:0" if DEVICE.startswith("cuda") else DEVICE
    initialize_multihost(num_processes=world, process_id=rank, device=dev,
                         init_method="file://" + store, backend="gloo",
                         timeout_s=300)
    os.environ.update(GROUP_RANK=str(rank // 2), LOCAL_RANK=str(rank % 2),
                      LOCAL_WORLD_SIZE="2")
    mesh = make_pod_mesh(device=dev)
    res = dict(shape=mesh.shape,
               coords={a: mesh.coord(a) for a in mesh.axis_names},
               groups={a: dist.get_process_group_ranks(mesh.group_of(a))
                       for a in mesh.axis_names})
    exp32 = _mc_exp(bf16=False)
    batch = shard_batch(_pod_batch(exp32))
    beyond, dw_differ = [], [0, 0]
    checked = _kernel_checkers(beyond, dw_differ)
    with tf32_off():
        _reset_all_counts()
        with contextlib.ExitStack() as stack:
            for mod, name, fn in ((blocks, "dwconv7x7", checked[0]),
                                  (interaction, "ms_deform_attn", checked[1]),
                                  (uni_mod, "correlation_propagate_train",
                                   checked[2])):
                stack.enter_context(mock.patch.object(mod, name, fn))
            _sync()
            t0 = time.perf_counter()
            pod = _dp_first_step(exp32, batch, mesh)[0]
            _sync()
            res["ms"] = (time.perf_counter() - t0) * 1e3
        res["counts"] = _all_counts()
        flat = _dp_first_step(exp32, batch)[0]
    shares, worst, _ = _grad_shares(flat["grads"], pod["grads"])
    res.update(loss=pod["loss"], flat_loss=flat["loss"], worst=worst,
               share=shares[worst], n_leaves=len(shares), beyond=beyond,
               dw_differ=dw_differ, digest=_digest(pod["params"]),
               flat_digest=_digest(flat["params"]))
    torch.save(res, out)
    dist.destroy_process_group()


def _multicard_pod(report):
    """(d) The (dcn, data) pod mesh: the uni step of unicorn_track_tiny at
    full width, B = 1 pair a rank. make_pod_mesh on a world of 1 over NCCL
    (a (1, 1) mesh), as trained, with cuDNN's and PyTorch's deterministic
    algorithms, against the one-process step run twice (bit-equal where
    that repeats itself bit for bit, else within its two-run spread), as
    phase parallel's world of 1. Then MC_RANKS gloo ranks sharing the card
    (spawned) as a (2, 2) ("dcn", "data") mesh in fp32 with TF32 off: the
    mesh's coordinates and groups; the gradients within 1e-5 of each
    leaf's largest magnitude of the same ranks' flat data-parallel step;
    every rank ending with the same weights and loss dict; the kernels of
    the step (dw7x7, MSDA factored, the correlation's fwd_lse, bwd_i,
    bwd_j) held against their plain versions at each call, TRAIN_LAUNCHES
    a rank and step."""
    import warnings

    import torch
    import torch.distributed as dist

    from unicorn_torch.parallel import initialize_multihost, make_pod_mesh

    card = report.get("card", "")
    exp = _mc_exp()
    one = tuple(t[1:2] for t in _pod_batch(exp))          # a MOT pair
    flags = (torch.backends.cudnn.deterministic,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled())
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            single = [_dp_first_step(exp, one)[0] for _ in range(2)]
            initialize_multihost(
                coordinator_address=f"127.0.0.1:{_free_port()}",
                num_processes=1, process_id=0, device=DEVICE, timeout_s=120)
            try:
                backend = dist.get_backend()
                mesh = make_pod_mesh(device=DEVICE)
                world1 = _dp_first_step(exp, one, mesh)[0]
            finally:
                dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = flags[0]
        torch.use_deterministic_algorithms(flags[1], warn_only=flags[2])

    def bitwise(a, b):
        return a["loss"] == b["loss"] and all(
            torch.equal(a[k][n], b[k][n]) for k in ("grads", "params")
            for n in a[k])

    repeats = bitwise(single[0], single[1])
    if repeats:
        ok1 = bitwise(world1, single[0])
    else:
        spread = max(_grad_shares(single[0]["grads"],
                                  single[1]["grads"])[0].values())
        ok1 = max(_grad_shares(single[0]["grads"],
                               world1["grads"])[0].values()) <= spread
    print(f"  (d) make_pod_mesh on a world of 1 over {backend}: mesh "
          f"{mesh.shape}; its uni step (B = 1, deterministic algorithms) "
          f"against the one-process step: the one-process step repeats bit "
          f"for bit {repeats}; the pod step "
          f"{'bit-equal' if repeats else 'within the two-run spread'} {ok1} "
          f"(loss {world1['loss']['total_loss']:.6f} vs "
          f"{single[0]['loss']['total_loss']:.6f})")
    assert backend == ("nccl" if DEVICE.startswith("cuda") else "gloo")
    assert mesh.shape == {"dcn": 1, "data": 1} and ok1
    del single, world1

    ranks, wall = _spawn_ranks(_mc_pod_rank)
    rows_ = [[0, 1], [2, 3]]
    groups_ok = all(
        res["shape"] == {"dcn": 2, "data": 2}
        and res["coords"] == {"dcn": r // 2, "data": r % 2}
        and res["groups"] == {"data": rows_[r // 2],
                              "dcn": [rows_[0][r % 2], rows_[1][r % 2]]}
        for r, res in enumerate(ranks))
    same = all(res["loss"] == ranks[0]["loss"]
               and res["digest"] == ranks[0]["digest"]
               and res["flat_digest"] == ranks[0]["flat_digest"]
               for res in ranks)
    d_loss = max(abs(v - ranks[0]["flat_loss"][k]) / max(abs(v), 1e-12)
                 for k, v in ranks[0]["loss"].items())
    print(f"  (d) {MC_RANKS} gloo ranks on {DEVICE} as a (2, 2) (dcn, data) "
          f"pod mesh, B = 1 pair a rank, fp32 with TF32 off: coordinates "
          f"and groups as two nodes of two ranks {groups_ok}; ranks end "
          f"with one state {same}; total_loss "
          f"{ranks[0]['loss']['total_loss']:.6f} (flat step "
          f"{ranks[0]['flat_loss']['total_loss']:.6f}, largest relative "
          f"difference of a loss term {d_loss:.2e}); the ranks {wall:.1f} s "
          f"from spawn to exit on {card}")
    for r, res in enumerate(ranks):
        calls = {}
        for kind, _, _ in res["beyond"]:
            calls[kind] = calls.get(kind, 0) + 1
        nbad = sum(n for _, _, n in res["beyond"])
        print(f"  (d) rank {r} on {card}: pod step {res['ms']:.1f} ms with "
              f"every kernel call checked (the model built inside); "
              f"gradients against the flat step: worst of {res['n_leaves']} "
              f"leaves {res['share']:.3e} of its max at {res['worst']} "
              f"(bound 1e-5); launches {res['counts']}; calls checked "
              f"against the plain versions {calls}, {nbad} outputs beyond "
              f"tolerance (dw7x7: {res['dw_differ'][0]} of "
              f"{res['dw_differ'][1]} outputs differ at all)")
    _record_launches(report, "multicard_pod_rank0", ranks[0]["counts"])
    assert groups_ok and same
    for res in ranks:
        assert res["share"] <= 1e-5, (res["worst"], res["share"])
        assert res["counts"] == TRAIN_LAUNCHES, res["counts"]
        assert res["beyond"] and not any(n for _, _, n in res["beyond"]), \
            [b for b in res["beyond"] if b[2]]


def phase_multicard(report):
    """The multi-card forms on one card: (a) `_multicard_world1`, (b)
    `_multicard_ranks`, (c) `_multicard_swin`, (d) `_multicard_pod`."""
    print(f"multicard ({report.get('card', '')})")
    t0 = time.perf_counter()
    _multicard_world1(report)
    _multicard_ranks(report)
    _multicard_swin(report)
    _multicard_pod(report)
    print(f"  multicard: {time.perf_counter() - t0:.1f} s in all on "
          f"{report.get('card', '')}")


# ------------------------------------------------------ opt-in: profile
def _profile(label, step, frames, show=()):
    """torch.profiler over step(frame) for each frame: CUDA time by kernel
    and the device's busy share; the 20 longest kernels, and those whose
    names contain a string of `show` wherever they rank."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n = len(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            step(f)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profile {label}: {n} frames, wall {wall * 1e3:.1f} ms, device "
          f"busy {dev_ms:.1f} ms ({dev_ms / (wall * 10):.1f}% of wall), "
          f"{sum(e.count for e in kernels) / n:.0f} kernels/frame")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(kernels):
        if i < 20 or any(s in e.key for s in show):
            print(f"  {e.self_device_time_total / (n * 1e3):8.3f} ms/frame "
                  f"{e.count / n:6.1f}/frame  {e.key[:100]}")
    return {s: sum(e.count for e in kernels if s in e.key) / n for s in show}


def phase_profile(report):
    """torch.profiler over 4 frames each of the MOT path, the streaming path,
    the detector with fused blocks, the SOT path, the inst path and its
    mask decode alone, the VOS shared path, the omni MOTS path (QDTrack),
    4 uni training steps, and 4 steps each of the inst and the VOS + MOTS
    training steps. Opt-in: --only profile."""
    import numpy as np

    from unicorn_torch.drivers.mot import MOTDriver
    from unicorn_torch.drivers.sot import SOTDriver

    exp, model = _model(report)
    driver = MOTDriver(model, input_size=exp.test_size,
                       num_classes=exp.num_classes, conf_thre=0.0,
                       nms_thre=exp.nmsthre, device=DEVICE)
    rng = np.random.RandomState(2)
    frames = [(rng.rand(*FRAME_HW, 3) * 255).astype(np.uint8)
              for _ in range(6)]
    for f in frames[:2]:
        driver.update(f)
    _profile("mot", driver.update, frames[2:])

    # the streaming path, and the detector with its 27 blocks run as
    # convnext_block calls (the block's kernels by name: the dw sums, the
    # first product, and on the split route the second)
    import torch
    from unittest import mock

    from unicorn_torch.drivers.stream import StreamingMOTPipeline
    from unicorn_torch.models import blocks
    from unicorn_torch.ops.letterbox import letterbox_device

    exp, model = _model(report, raised_priors=True)
    pipe = StreamingMOTPipeline(model, input_size=exp.test_size,
                                num_classes=exp.num_classes, device=DEVICE)
    on_card = [letterbox_device(torch.from_numpy(f).to(DEVICE),
                                exp.test_size)[0][None] for f in frames]
    for f in on_card[:2]:
        pipe.push_frame(f)
    _profile("stream (push_frame, frames on the card)", pipe.push_frame,
             on_card[2:])
    with mock.patch.object(blocks.ConvNeXtBlock, "forward",
                           _fused_block_forward), torch.inference_mode():
        for f in on_card[:2]:
            pipe.detect(f)
        _profile("detector with fused blocks", pipe.detect, on_card[2:],
                 show=("dw7x7_nhwc_kernel", "mlp_kernel", "p2_kernel"))

    exp, model = _sot_model(report)
    sot = SOTDriver(model, input_size=exp.test_size, conf_thre=0.0,
                    nms_thre=exp.nmsthre, device=DEVICE)
    sot.initialize(frames[0], INIT_BOX)
    for f in frames[:2]:
        sot.track(f)
    counts = _profile("sot", sot.track, frames[2:],
                      show=("prep_kernel", "corr_tc_kernel", "msda"))
    # one call of the serving correlation op a frame: its CUDA launches
    print(f"  correlation op: {counts['prep_kernel']:.0f} prep_kernel + "
          f"{counts['corr_tc_kernel']:.0f} corr_tc_kernel launches a frame, "
          "one op call")

    # the inst path, and its mask decode alone (the stages after the NMS)
    exp, model = _inst_model(report)
    fwd = exp.get_inst_forward(model, device=DEVICE)

    def inst(f):
        return fwd(fwd.preprocess(f, exp.test_size)[0])

    for f in frames[:2]:
        inst(f)
    _profile("inst", inst, frames[2:], show=("dw7x7",))
    decoded = []
    for f in frames[2:]:
        raw, mask_out = fwd.forward(fwd.preprocess(f, exp.test_size)[0])
        flat, _, _, idx = fwd.detect(raw)
        decoded.append((flat, idx, mask_out))
    _profile("inst mask decode", lambda d: fwd.masks(*d), decoded)
    report.pop("inst_model")

    # the VOS shared-reference path at K = VOS_OBJECTS + 1 slots
    _, vos = _vos_driver(report, VOS_OBJECTS + 1)
    vos_frames = _sot_frames(6, seed=6, hw=VOS_FRAME_HW)
    vos.initialize(vos_frames[0], _vos_masks(range(1, VOS_OBJECTS + 1)))
    for f in vos_frames[1:3]:
        vos.track(f)
    _profile(f"vos shared path, K = {vos.K}", vos.track, vos_frames[3:],
             show=("dw7x7", "corr_tc_kernel", "msda"))

    # the omni path: MOTS with QDTrack, 720x1280 frames
    _, omni = _omni_driver(report, True)
    mots = _sot_frames(5, seed=7, hw=OMNI_MOTS_HW)
    for f in mots[:2]:
        omni.update(f)
    _profile("omni mots qd", omni.update, mots[2:], show=("dw7x7", "msda"))
    report.pop("vos_model")

    from unicorn_torch.core.train_state import TrainState

    exp, model = _train_model(report)
    state = TrainState.create(
        model, exp.get_optimizer(TRAIN_B, TRAIN_ITERS_PER_EPOCH),
        use_ema=exp.ema, device=DEVICE)
    step = exp.get_train_step(TRAIN_B)
    batches = [_train_batch(exp, 1, seed=11, n_obj=1),
               _train_batch(exp, 2, seed=12, n_obj=12)]
    for b in batches:
        step(state, *b)
    _profile("train (per step: SOT, MOT, SOT, MOT)",
             lambda b: step(state, *b), batches * 2,
             show=("fwd_lse_kernel", "bwd_i_kernel", "bwd_j_kernel"))
    del state
    report.pop("train_model")

    # the mask-stage steps as the phases inst_train and mask_train run them
    for build, make_batch, label in (
            (_inst_train_model, _inst_train_batch, "inst train (mask-only "
             "SGD, EMA)"),
            (_mask_train_model, _mask_train_batch, "mask train (VOS + MOTS, "
             "mask-only AdamW, accumulation 2)")):
        exp, model = build(report)
        state = TrainState.create(
            model, exp.get_optimizer(TRAIN_B, MASK_TRAIN_ITERS_PER_EPOCH),
            use_ema=exp.ema, device=DEVICE)
        step = exp.get_train_step(TRAIN_B)
        batches = [make_batch(exp, seed) for seed in (40, 41)]
        for b in batches:
            step(state, *b)
        _profile(f"{label}, per step", lambda b: step(state, *b),
                 batches * 2, show=("dw7x7", "fwd_lse_kernel", "msda"))
        del state


PHASES = {
    "build": phase_card_and_build,
    "kernels": phase_kernels,
    "model": phase_model,
    "main": phase_main,
    "block_model": phase_block_model,
    "stream": phase_stream,
    "sot_model": phase_sot_model,
    "sot": phase_sot,
    "inst": phase_inst,
    "vos": phase_vos,
    "omni": phase_omni,
    "train_model": phase_train_model,
    "train": phase_train,
    "inst_train": phase_inst_train,
    "mask_train": phase_mask_train,
    "trainer": phase_trainer,
    "disk": phase_disk,
    "det": phase_det,
    "backbones": phase_backbones,
    "eval": phase_eval,
    "harness": phase_harness,
    "tools": phase_tools,
    "parallel": phase_parallel,
    "multicard": phase_multicard,
    "profile": phase_profile,
}
DEFAULT_PHASES = ("build", "kernels", "model", "main", "block_model",
                  "stream", "sot_model", "sot", "inst", "vos", "omni",
                  "train_model", "train", "inst_train", "mask_train",
                  "trainer", "disk", "det", "backbones", "eval", "harness",
                  "tools", "parallel", "multicard")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None,
                    help="run only these phases (debugging)")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import unicorn_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})",
              file=sys.stderr)
        return 2

    report = {}
    failed = []
    wanted = DEFAULT_PHASES if args.only is None else ("build", *args.only)
    for name, fn in PHASES.items():
        if name not in wanted:
            continue
        print(f"== phase {name}", flush=True)
        t0 = time.perf_counter()
        try:
            fn(report)
        except Exception as e:  # report every phase, fail at the end
            import traceback

            traceback.print_exc()
            failed.append(name)
            print(f"== phase {name} FAILED: {type(e).__name__}: {e}")
            if name == "build":
                break
        print(f"== phase {name} {time.perf_counter() - t0:.1f} s", flush=True)
    kernels = list(report.get("kernels", {}).values())
    print(json.dumps({"kernels": kernels}))
    if failed:
        print(f"chip_smoke: FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
