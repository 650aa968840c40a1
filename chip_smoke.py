"""Smoke run of the PyTorch/CUDA port's serving and training paths on one
NVIDIA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the exit code is
not 0:

1. build   -- compile the CUDA kernels from dinounet_tpu_torch/csrc/; the
              registers and spills of the int8 kernels (the quantize passes
              and the s8 wgmma GEMM's instances in dense_q8.cu and
              qkv_q8_dmaj.cu) and of the 3x3 conv's four Cout instances
              (conv3x3_stats.cu) from ptxas.log.
2. kernels -- each of the 17 kernels against its plain PyTorch version on
              the card, at the shapes the dinounet_b tile forward gives it
              (tile batch 8; the MSDA backward at the train step's batch 2;
              the prepped-input MSDA forward also over two levels) and
              those of dinounet_7b (the row-major attention, the Dh-major
              one at Dh = 128, the MSDA forward at 128 channels a head, the
              two extractor junctions at D = 4096); the MSDA backward also
              at dinounet_l's and the 7B's train shapes and at a 1024^2
              patch, the MSDA forward at D = 32 on a 1024^2 patch, the
              Dh-major and row-major attention on a 1024^2 patch's 4101
              tokens (each attention case also prints its TFLOP/s and
              SDPA's); each within its stated tolerance; kernel, plain and
              library times
              (CUDA events, median of 20) and the bound (the larger of the
              bytes each call must move over 3.35 TB/s and its operations
              over the peak rate of their type: bf16 or int8 tensor cores,
              fp32). The library call is one PyTorch op computing the same
              function or, for the convs, the same conv alone (cuDNN on
              channels-last bf16, no prologue or statistics), for the int8
              ops torch._int_mm on the pre-quantized operands (the int8 GEMM
              alone), for the MSDA kernels grid_sample (bilinear, zero
              padding, align_corners=False) on the same map and points: the
              stock gather alone, without the prep or the weighted sum over
              points (the forwards: its forward on bf16; the backward: its
              backward to the map and the grid on fp32), timed as a
              yardstick and never called by the port.
              The int8 ops' bound counts their weight's cached int8 levels
              and scales (quantized once, not per call); each also prints
              TOPS and GB/s, its device time split into the quantize pass
              and the GEMM (a call must launch those two and nothing else),
              and the weight's one-time quantization; without the GELU
              their outputs must equal the plain versions' bit for bit, and
              qkv_q8_dmaj (tiles across images), dense_q8_stats and
              dense_cm_q8_stats are also held at edge shapes. Each conv3x3
              case (the seven of serve_cm, the four of serve_hwbc) also
              prints its device time a call split into the conv kernel and
              the memset of the sums (a call must launch those and nothing
              else: the packed weight is cached) and the weight's one-time
              pack. The transposed conv (serve_cm's five shapes), the
              three MSDA forwards (#1, #6 and #5 at D = 24, D = 128 and on
              the 1024^2 patch; the token-major copy only where not one
              16-byte cell of the map a position fits in shared memory: at
              none of these) and the MSDA backward (the memset of its gv
              scratch, its walk, its finishing transpose, the slice sums of
              a sliced head; the device-memory instance at none of its four
              shapes) likewise print their
              device time a call split by launch, and a call that launches
              anything else fails the run. serve_cm also prints the
              transposed conv's launches a tile-batch forward by shape.
3. serve   -- dinounet_b at full width with seeded random weights, behind the
              port's nnUNetPredictor (2d, 512 x 512 patches, step 0.5, tile
              batch 8, bf16): one 1 x 1280 x 1280 case = 16 tiles in 2
              batches. Checks the fp16 logits' shape and finiteness and that
              the kernels ran the path (per tile-batch forward: attention 12,
              cm-dense 18, row-dense 18, MSDA 6 launches). Tiles/s for
              information.
4. parity  -- one 512 x 512 tile through DinoUNet on the card in bf16 (the
              kernels) and on the CPU in fp32 (the plain versions), the same
              weights: relative L2 error of the logits <= PARITY_BOUND.
5. serve routes -- the same case served again with each route on (ROUTES:
              the channel-major decoder chain, upsampling and SPM stem; the
              HWBC decoder stages; the MSDA prep outside the kernel; the
              merged MSDA projection; the (B, 3, M, N, Dh) attention layout;
              the int8 serving mode, backbone only, with the adapter's
              junctions, and with the ndh layout): launch counts per
              tile-batch forward (PER_FORWARD_ROUTE sets the counts a route
              changes), finite fp16 logits, and the parity tile (in a batch
              of 8, as the HWBC stages need) against CPU fp32 logits within
              PARITY_BOUND: the stock model's for the conv routes, the same
              weights under the route (the plain versions) for the others. The int8 routes' batch is also held against the card's
              stock bf16 logits: relative L2 within INT8_BF16_BOUND, and the
              share of pixels whose argmax agrees. The int8 routes run last,
              with the backbone's LayerScale set to INT8_LAYERSCALE (at the
              init's 1e-5 the backbone's residual branches, and the int8
              error in them, vanish in bf16). Tiles/s, peak memory and
              the backbone, extractors, SPM, upsampling and decoder
              CUDA-event times per tile batch, beside the default route's;
              for the default route and serve_cm also one forward's device
              time by kernel family and the device's busy share.
              The environment is restored after each route.
6. serve_7b -- dinounet_7b at full width and depth (40 SwiGLU blocks)
              with seeded random weights drawn on the card (backbone
              matrices bf16, LayerScale INT8_LAYERSCALE), the same case at
              tile batch 8: launch counts per tile-batch forward (row-major
              attention 40, MSDA 6, dense 6 + 6, every other kernel 0),
              finite fp16 logits, tiles/s, peak memory and layer times; the
              int8 route (QuantDense) likewise and its parity batch against
              the card's bf16 logits (INT8_BF16_BOUND, argmax agreement);
              then the parity tile in bf16 (the kernels) against the same
              weights in fp32 with the plain versions on the card, TF32
              off, within PARITY_7B_BOUND (the bf16 model freed first).
7. train   -- a synthetic preprocessed 2-D dataset (6 cases of 640 x 640, a
              bright disk and a dark ring) in a temporary nnUNet_preprocessed;
              DinoUNetTrainer_b through run.get_trainer_from_args on cuda:0
              (512 x 512 patches, batch 2, bf16, random frozen backbone),
              run_training() for 2 epochs of TRAIN_ITERS steps and 2
              validation iterations. Checks: every logged loss finite, the
              launch counts of the run (per train step: attention 12, dense
              12 + 12 in the frozen backbone, MSDA forward 6 + 6 in the
              checkpointed recompute, MSDA backward 6; per validation
              forward the serve counts), checkpoint_final.pth written and
              loaded back by a fresh trainer with equal weights, and over
              LEARN_STEPS further steps on the same loader the mean loss of
              the last 10 below that of the first 10. Step time, steps/s and
              peak device memory for information. Then ROUTE_STEPS steps of
              a fresh DinoUNetTrainer_b under DINOUNET_TPU_MSDA_PREP=xla and
              of a fresh DinoUNetTrainer_l (ViT-L, 16 adapter heads of 32
              channels): finite losses and the launches of each step
              (PER_TRAIN_STEP_XLA, PER_TRAIN_STEP_L), step time and peak
              memory for information.
8. train parity -- one train step's loss and trainable gradients on the card
              (bf16, the kernels) against the CPU (fp32, the plain
              versions): same dinounet_b weights and 256 x 256 batch of 1,
              no augmentation, drop-path 0; relative L2 of the concatenated
              gradients <= TRAIN_GRAD_BOUND (those of the projections in
              front of the MSDA kernels, alone, <= TRAIN_MSDA_GRAD_BOUND),
              loss within TRAIN_LOSS_BOUND;
              an optimizer step on the card leaves every backbone parameter
              as it was.
9. pipeline -- the path from raw files to segmentation files. A raw NIfTI
              dataset (RAW_DATASET: RAW_TRAIN labelled and RAW_TEST test
              cases of one 800 x 800 slice at 0.8 mm, the disk and ring
              cases) with a hand-written plans file (2d, 1.0 mm: each case
              is resampled to 640 x 640, RAW_TILES tiles of 512^2 at step
              0.5), preprocess_dataset, then run.run_training of
              DinoUNetTrainer_b on fold 0 with the train phase's epochs and
              steps, ending in perform_actual_validation (mirror TTA) and
              its summary.json; then a fresh nnUNetPredictor on the card,
              initialize_from_trained_model_folder and predict_from_files
              over imagesTs with the probabilities saved. Checks: every
              validation and test case's segmentation file has its raw
              file's shape and geometry (the NIfTI affine: spacing and
              origin) and labels in {0, 1, 2}; summary.json's foreground
              mean Dice is finite; the launches of the whole phase are
              exactly the train steps' PER_TRAIN_STEP plus PER_FORWARD for
              every tile batch of the run (the epochs' validation batches,
              then cases x tile batches x mirrors for the validation and
              the prediction, and one batch for the parity case); one test
              case predicted on the card without mirroring (bf16, the
              kernels) against predict_single_npy_array of the same model
              folder on the CPU (fp32, the plain versions, no mirroring):
              relative L2 of the probabilities <= PARITY_BOUND, the labels'
              agreement for information. Seconds a case for preprocessing,
              prediction and export, the validation's total and
              predict_from_files' cases/s for information.
10. api     -- the end-to-end CLI's path. A raw PNG dataset (API_DATASET:
              API_CASES labelled grey cases of 800 x 800, the disk and ring
              cases) with a dataset.json and no plans file;
              dinounet_training_torch.main_dinov3("dinounet_b") on the card:
              fingerprint, plan (forced 512 x 512, 4 stages, 2d), preprocess,
              the planned network configuration injected into
              DinoUNetTrainer_b, training (the train phase's epochs and
              steps, by shortened_training) with its final validation, then
              api.evaluate. Checks: dataset_fingerprint.json and
              nnUNetPlans.json written, the 2d plans' patch 512^2 and 4
              stages, the trained network's configuration is the injected
              one's, every logged loss finite, checkpoint_final.pth written,
              summary.json's foreground mean Dice finite, evaluate's dict
              equal to the summary.json the validation wrote (read before
              evaluate rewrites it), and the launches of the whole phase
              exactly the train steps' PER_TRAIN_STEP plus PER_FORWARD for
              every tile batch (the epochs' validation batches, then the
              validation cases x 1 tile x mirrors). The plans' batch and
              patch size, the seconds of each stage and the peak device
              memory for information. The injection is class-level and
              stays for the rest of the process: the phases after it put it
              back as they found it.
11. pretrained -- a synthetic published-layout dinov3_vitb16 .pth (the
              manifest's keys and shapes, seeded fp32 values drawn on the
              card, bias_mask 1/0/1 over q/k/v, the ignored keys the layout
              has) in the api phase's directory; DinoUNetTrainer_b pointed at
              it by set_network_config(..., dinov3_pretrained_path=...) and
              set up on the api phase's preprocessed set. Checks: the load is
              logged, every backbone tensor equals the file's (the k bias
              zeroed), and again after ROUTE_STEPS train steps (finite
              losses); one tile through the loaded model, card bf16 (the
              kernels) vs CPU fp32 (the plain versions) within PARITY_BOUND;
              the launches exactly ROUTE_STEPS x PER_TRAIN_STEP plus one
              PER_FORWARD. Load seconds for information.
12. regions -- the api phase's PNG generator (API_CASES cases of 800^2),
              its labels declared as the overlapping regions REGION_LABELS
              with REGIONS_CLASS_ORDER; api.plan_and_preprocess (512^2, 4
              stages), the network configuration injected into
              DinoUNetTrainer_b, run_training as the train phase is
              shortened (DC+BCE on the two region channels), its final
              validation and export. Checks: finite losses, two finite
              region pseudo-Dice a validation epoch, summary.json's
              foreground mean Dice finite, each exported validation case
              800^2 with labels in {0, 1, 2}, the launches exactly the train
              steps' PER_TRAIN_STEP plus PER_FORWARD for every tile batch.
13. train_7b -- a synthetic published-layout dinov3_vit7b16 .pth in bf16
              (13.4 GB, drawn on the card as the pretrained phase draws;
              the free disk space checked first), then DinoUNetTrainer_7b
              through run.run_training on the api phase's set, shortened as
              the train phase is, with that file injected: dinounet_7b
              built on the card with the backbone's matrices in bf16, the
              file loaded tensor by tensor from its mapping, training, the
              final validation. To keep the script's disk writes near 30
              GB, run_training runs with disable_checkpointing and
              checkpoint_final.pth (~15 GB) is saved once after it (best
              and latest would add 30 GB); then a fresh nnUNetPredictor,
              initialize_from_trained_model_folder (the checkpoint mapped)
              and predict_from_files of one raw case. Checks: finite losses,
              every backbone tensor equal to the file's after training, the
              launches of run_training exactly the train steps'
              PER_TRAIN_STEP_7B plus the 7B's serve counts for every tile
              batch (and those of 3 more timed steps and of the
              prediction), the growth of anonymous memory across the load
              and across the reload under ANON_GROWTH_BOUND (the process's
              RssAnon, or the machine's AnonPages where the kernel reports
              no RssAnon; 1 GiB written on the host must show as 1 GiB),
              the predicted case 800^2 with labels in {0, 1, 2}. Seconds to write, load, step, save and reload, and the
              peak device memory for information.
14. unet_3d -- nnU-Net's own 3-D network. A raw NIfTI set (UNET3D_DATASET:
              UNET3D_TRAIN labelled and UNET3D_TEST test volumes of
              UNET3D_SIZE at 1 mm, a sphere and a shell) with no plans
              file; extract_fingerprints, plan_experiments (the default
              planner: 3d_fullres PlainConvUNet, 128^3 patches, batch 2,
              features 32 to 320, checked against PLANNED_3D), preprocess,
              then run.run_training of nnUNetTrainer on 3d_fullres with deep
              supervision at the plans' full width (the train phase's
              epochs and steps) ending in its final validation (8 mirror
              variants), a fresh nnUNetPredictor from the model folder and
              predict_from_files of one held-out case, then api.evaluate.
              Checks: the step losses finite and falling (the last 3 below
              the first 3 on average), every validation and test output
              with its raw file's shape and geometry, a finite Dice,
              evaluate equal to the validation's summary.json, no kernel
              launch (3-D runs stock convs); one 3-D tile of the held-out
              case, card bf16 vs CPU fp32, relative L2 <= PARITY_BOUND; the
              case's fp16 logits accumulated on the host
              (DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES=0) against on the card
              within HOST_ACCUM_RTOL. Step ms, peak memory, seconds a case
              for information.
15. resenc_3d -- nnUNetPlannerResEncM on the same set (its 3d_fullres
              reuses the preprocessed data): ResidualEncoderUNet (160^3,
              batch 2), RESENC_STEPS steps with deep supervision; finite
              losses, no kernel launch; step ms and peak memory.
16. unet_2d -- the default planner's 2d PlainConvUNet on a raw PNG set of
              UNET2D_CASES cases of UNET2D_SIZE^2 (512^2 patches, 8
              stages): UNET2D_STEPS steps with deep supervision (no
              launch), then one tile batch of TILE_BATCH through the
              trained network in eval mode, stock and under
              DINOUNET_TPU_DECODER_TAIL=auto: the chain's launches exactly
              PER_FORWARD_UNET2D_CHAIN (#14, #16, #15), its logits within
              PARITY_BOUND of the stock stages'.

Then the card's name and power limit, one JSON line of kernel results
(launches: the counts of the serve path, each route's, the train paths, the
pipeline, the api, pretrained, regions, train_7b, unet_3d, resenc_3d and
unet_2d phases), and as the last
line {"ok": true, "device": {...}}. Without a CUDA device the
script raises before printing any result.
"""

import contextlib
import dataclasses
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
import torch.nn.functional as F

import dinounet_training_torch
from dinounet_tpu_torch import api
from dinounet_tpu_torch.evaluation.metrics import load_summary_json
from dinounet_tpu_torch.imageio.natural_image import pil_image
from dinounet_tpu_torch.imageio.nifti import NiftiIO, read_nifti
from dinounet_tpu_torch.inference import export as export_module
from dinounet_tpu_torch.inference import predictor as predictor_module
from dinounet_tpu_torch.inference.predictor import nnUNetPredictor
from dinounet_tpu_torch.models.convert import checkpoint_manifest
from dinounet_tpu_torch.models.dinounet import DinoUNet, DinoUNetConfig
from dinounet_tpu_torch.models.vit import VIT_CONFIGS, rope_sincos
from dinounet_tpu_torch.ops import _build
from dinounet_tpu_torch.ops.attention import (fused_rope_attention,
                                              fused_rope_attention_premapped,
                                              fused_rope_attention_premapped_dmaj,
                                              rope_attention_dmaj_plain,
                                              rope_attention_ndh_plain,
                                              rope_attention_plain, rope_tables,
                                              rope_tables_dmaj)
from dinounet_tpu_torch.ops.conv_hwbc import conv3x3_hwbc, conv3x3_hwbc_plain
from dinounet_tpu_torch.ops.decoder_tail import (conv3x3_cm, conv3x3_cm_plain,
                                                 pack_conv_weight, pack_seg_weight,
                                                 pack_transpconv_weight, packed_conv_weight,
                                                 packed_seg_weight, packed_transpconv_weight,
                                                 seg_head_cm, seg_head_cm_plain,
                                                 transpconv2x2_cm,
                                                 transpconv2x2_cm_plain)
from dinounet_tpu_torch.ops.dense_q8 import (CACHE_ATTR, dense_cm_q8_residual_stats,
                                             dense_cm_q8_residual_stats_plain, dense_q8,
                                             dense_q8_plain, dense_q8_residual_stats,
                                             dense_q8_residual_stats_plain, qkv_q8_dmaj,
                                             qkv_q8_dmaj_plain, quantize_act_tokens,
                                             quantize_weight_dk, quantized_weight)
from dinounet_tpu_torch.ops.dense_stats import (dense_cm_residual_stats,
                                                dense_cm_residual_stats_plain,
                                                dense_residual_stats,
                                                dense_residual_stats_plain)
from dinounet_tpu_torch.ops.kernel_check import (KERNEL_TOLERANCES, STATS_TOLERANCE,
                                                 max_abs_err, max_excess, median_ms)
from dinounet_tpu_torch.ops.msda import (ms_deform_attn_premapped_backward_plain,
                                         ms_deform_attn_premapped_fused_merged_plain,
                                         ms_deform_attn_premapped_fused_plain,
                                         ms_deform_attn_premapped_plain,
                                         premapped_fused_prep)
from dinounet_tpu_torch.ops.msda_kernel import (bwd_plan, ms_deform_attn_premapped,
                                                ms_deform_attn_premapped_backward,
                                                ms_deform_attn_premapped_fused,
                                                ms_deform_attn_premapped_fused_merged)
from dinounet_tpu_torch.models.plain_unet import PlainConvUNet
from dinounet_tpu_torch.models.residual_unet import ResidualEncoderUNet
from dinounet_tpu_torch.planning.plan_and_preprocess_api import (extract_fingerprints,
                                                                 plan_experiments, preprocess,
                                                                 preprocess_dataset)
from dinounet_tpu_torch.planning.resenc_planner import nnUNetPlannerResEncM
from dinounet_tpu_torch.preprocessing.preprocessor import DefaultPreprocessor
from dinounet_tpu_torch.run import get_trainer_from_args, run_training
from dinounet_tpu_torch.training import dinounet_trainer as dinounet_trainer_module
from dinounet_tpu_torch.training.dinounet_trainer import (DinoUNetTrainer, DinoUNetTrainer_7b,
                                                          DinoUNetTrainer_b)
from dinounet_tpu_torch.training.losses import dc_and_ce_loss
from dinounet_tpu_torch.training.trainer import clip_and_step, nnUNetTrainer, sgd_nesterov
from dinounet_tpu_torch.utilities.plans_handler import PlansManager
from dinounet_tpu_torch.utilities.synthetic_dataset import (disk_ring_case,
                                                            write_disk_ring_dataset,
                                                            write_disk_ring_png_dataset,
                                                            write_disk_ring_raw_dataset,
                                                            write_sphere_shell_raw_dataset)

TILE_BATCH = 8
PATCH = 512
CASE = (1, 1, 1280, 1280)
N_CLASSES = 3
# bf16 on the card vs fp32 on the CPU, relative L2 of the logits; the JAX
# package holds its own bf16 path to 0.15 (tests/test_vit_parity.py)
PARITY_BOUND = 0.05
# the int8 mode against the stock bf16 model on the card, relative L2 of the
# logits: the JAX package's bound for its int8 mode (tests/test_vit_parity.py)
INT8_BF16_BOUND = 0.1
INT8_LAYERSCALE = 0.1
INT8_KERNELS = ("qkv_q8_dmaj", "dense_q8", "dense_q8_stats", "dense_cm_q8_stats")
INT8_ROUTES = ("serve_int8", "serve_int8_adapter", "serve_int8_ndh")
# the routes that swap a kernel of the model's own ops (the MSDA prep, the
# merged projection, the attention layout): their parity tile is held
# against the CPU fp32 plain versions under the same route
OP_ROUTES = ("serve_msda_xla", "serve_msda_merged", "serve_ndh")
# kernel launches per tile-batch forward of dinounet_b
PER_FORWARD = {"rope_attention": 12, "rope_attention_rm": 0, "rope_attention_ndh": 0,
               "dense_cm_stats": 18, "dense_rm_stats": 18, "msda_fwd": 6,
               "msda_fwd_premapped": 0, "msda_fwd_merged": 0, "msda_bwd": 0,
               "conv3x3_cm": 0, "transpconv2x2_cm": 0, "seg_head_cm": 0, "conv3x3_hwbc": 0,
               **dict.fromkeys(INT8_KERNELS, 0)}
# the routes, as environment settings, and the launches per tile-batch
# forward each sets (the others keep PER_FORWARD's). serve_cm: conv3x3_cm 2
# per decoder stage at 128^2, 256^2, 512^2 and the 2 SPM stem convs at 256^2;
# transpconv2x2_cm the 3 decoder upsamplings and the 4 LearnableUpsamples' 2
# doublings each; one seg head (no deep supervision). serve_hwbc: the
# 64-channel stage at 256^2 and the 32-channel stage at 512^2, 2 convs each
# (the 128-channel stage is not eligible). serve_int8: the 12 blocks' qkv,
# attention projection, fc1 and fc2 in int8, the 6 extractors' junctions
# bf16; serve_int8_adapter: those junctions in int8 too. serve_msda_xla and
# serve_msda_merged: the 6 extractors' MSDA through the prepped-input and
# the merged-buffer kernels; serve_ndh: the 12 blocks' attention over the
# (B, 3, M, N, Dh) layout, serve_int8_ndh with the int8 qkv into it (plain
# PyTorch, no kernel).
ROUTES = {
    "serve_cm": {"DINOUNET_TPU_DECODER_TAIL": "pallas", "DINOUNET_TPU_SPM_CM": "pallas"},
    "serve_hwbc": {"DINOUNET_TPU_DECODER_HWBC": "auto", "DINOUNET_TPU_DECODER_TAIL": "jax"},
    "serve_msda_xla": {"DINOUNET_TPU_MSDA_PREP": "xla"},
    "serve_msda_merged": {"DINOUNET_TPU_MSDA_MERGED_PROJ": "1"},
    "serve_ndh": {"DINOUNET_TPU_ATTN_LAYOUT": "ndh"},
    "serve_int8": {"DINOUNET_TPU_VIT_INT8": "1"},
    "serve_int8_adapter": {"DINOUNET_TPU_VIT_INT8": "1", "DINOUNET_TPU_INT8_ADAPTER": "1"},
    "serve_int8_ndh": {"DINOUNET_TPU_VIT_INT8": "1", "DINOUNET_TPU_ATTN_LAYOUT": "ndh"},
}
PER_FORWARD_ROUTE = {
    "serve_cm": {"conv3x3_cm": 8, "transpconv2x2_cm": 11, "seg_head_cm": 1},
    "serve_hwbc": {"conv3x3_hwbc": 4},
    "serve_int8": {"qkv_q8_dmaj": 12, "dense_cm_q8_stats": 12, "dense_q8": 12,
                   "dense_q8_stats": 12, "dense_cm_stats": 6, "dense_rm_stats": 6},
    "serve_int8_adapter": {"qkv_q8_dmaj": 12, "dense_cm_q8_stats": 18, "dense_q8": 12,
                           "dense_q8_stats": 18, "dense_cm_stats": 0, "dense_rm_stats": 0},
    "serve_msda_xla": {"msda_fwd": 0, "msda_fwd_premapped": 6},
    "serve_msda_merged": {"msda_fwd": 0, "msda_fwd_merged": 6},
    "serve_ndh": {"rope_attention": 0, "rope_attention_ndh": 12},
    "serve_int8_ndh": {"dense_cm_q8_stats": 12, "dense_q8": 12, "dense_q8_stats": 12,
                       "dense_cm_stats": 6, "dense_rm_stats": 6, "rope_attention": 0,
                       "rope_attention_ndh": 12},
    # dinounet_7b, bf16 or int8: its 40 unfused SwiGLU blocks launch only the
    # row-major attention (their dense layers are cuBLAS GEMMs, QuantDense's
    # torch._int_mm in int8); the 6 extractors their MSDA and two junctions
    **dict.fromkeys(("serve_7b", "serve_7b_int8"), {
        "rope_attention": 0, "rope_attention_rm": 40, "dense_cm_stats": 6,
        "dense_rm_stats": 6}),
}
SERVE_7B = ("serve_7b", "serve_7b_int8")
# the dense ops' outputs at the 7B junction shapes: out = res + gamma * y is
# the sum of two bf16 terms that reach |10| among 176M outputs (the kernel's
# default bound assumes |4|), and one accumulation-order flip of a term's
# bf16 rounding moves the output by that term's ulp, 0.0625 below 16,
# however small the sum; the statistics keep the kernel's bound
JUNCTION_7B_TOL = (6.25e-2, 1e-2)
# dinounet_7b, card bf16 (kernels) vs card fp32 (plain versions), relative L2
# of the parity tile's logits, with the backbone's LayerScale at
# INT8_LAYERSCALE: the same bound as dinounet_b's
PARITY_7B_BOUND = 0.05
# kernel launches per train step: the backbone's 12 blocks (attention, the
# channel-major attention projection, the row-major fc2); the adapter trains
# unfused, so its 6 extractors launch only the MSDA forward (twice: the
# checkpointed interaction blocks run it again in the backward) and backward
PER_TRAIN_STEP = {**dict.fromkeys(PER_FORWARD, 0), "rope_attention": 12,
                  "dense_cm_stats": 12, "dense_rm_stats": 12, "msda_fwd": 12, "msda_bwd": 6}
# DinoUNetTrainer_l: the ViT-L's 24 blocks, the adapter's 16 heads of 32
# channels (the MSDA backward's whole-head staged instance); DinoUNetTrainer_b
# under DINOUNET_TPU_MSDA_PREP=xla: the prepped-input forward in place of
# the fused one
PER_TRAIN_STEP_L = {**PER_TRAIN_STEP, "rope_attention": 24, "dense_cm_stats": 24,
                    "dense_rm_stats": 24}
PER_TRAIN_STEP_XLA = {**PER_TRAIN_STEP, "msda_fwd": 0, "msda_fwd_premapped": 12}
TRAIN_ITERS, TRAIN_EPOCHS, VAL_ITERS, LEARN_STEPS, ROUTE_STEPS = 5, 2, 2, 40, 5
TRAIN_DATASET = "Dataset998_SmokeTrain"
# the pipeline phase's raw dataset: one 800 x 800 slice a case at 0.8 mm,
# planned at 1.0 mm (640 x 640 after preprocessing); fold 0 of the 5-fold
# split of RAW_TRAIN cases validates RAW_VAL of them
RAW_DATASET = "Dataset997_SmokeRaw"
RAW_TRAIN, RAW_TEST, RAW_VAL = 8, 2, 2
RAW_SIZE, RAW_SPACING, PLANS_SPACING = 800, 0.8, 1.0
# the mirror-TTA variants of a 2-D network (axes 0 and 1: none, either, both)
MIRRORS = 4
# the api phase's raw PNG dataset: API_CASES labelled cases of RAW_SIZE^2,
# no plans file; the CLI's forced 512 x 512 shape makes each case one tile,
# and fold 0 of the 5-fold split validates API_VAL of them
API_DATASET_ID, API_DATASET = 995, "Dataset995_SmokePng"
API_CASES, API_VAL = 8, 2
# the regions phase: the api phase's PNG generator with its labels declared
# as overlapping regions (tests/test_training_e2e.py::test_region_based_training)
REGIONS_ID, REGIONS_DATASET = 994, "Dataset994_SmokeRegions"
REGION_LABELS = {"background": 0, "whole": [1, 2], "inner": [2]}
REGIONS_CLASS_ORDER = [1, 2]
# DinoUNetTrainer_7b's train step: the 40 unfused SwiGLU blocks of the frozen
# backbone launch the row-major attention (their dense layers are cuBLAS
# GEMMs); the adapter trains unfused, as dinounet_b's does
PER_TRAIN_STEP_7B = {**dict.fromkeys(PER_FORWARD, 0), "rope_attention_rm": 40,
                     "msda_fwd": 12, "msda_bwd": 6}
# the growth of the process's anonymous memory allowed across loading the
# 7B's 13.4 GB of weights from a file (mapped, copied a tensor at a time)
ANON_GROWTH_BOUND = 2 * 2**30
# one train step, card bf16 (kernels) vs CPU fp32 (plain versions), relative
# L2. bf16 keeps 8 significant bits and the ~60 layers of forward and
# backward each round activations and gradients at 2^-9 relative: the whole
# trainable gradient is held to 0.15, the JAX package's bound for its own
# bf16 forward (tests/test_vit_parity.py). The MSDA projections' gradients
# also go through the sampling position: bf16 offsets place a point only to
# ~1/64 pixel and the bilinear derivative jumps at pixel edges, so they are
# noisier (0.12 measured between the CPU's bf16 and fp32 plain versions at
# 64^2); they are held to 0.3 -- a dropped or zeroed MSDA gradient gives 1.0
TRAIN_GRAD_BOUND = 0.15
TRAIN_MSDA_GRAD_BOUND = 0.3
TRAIN_LOSS_BOUND = 0.02
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "rope_attention": ("dinounet_tpu_torch/csrc/rope_attention.cu",
                       "dinounet_tpu/ops/attention_pallas.py:110"),
    "rope_attention_rm": ("dinounet_tpu_torch/csrc/rope_attention.cu",
                          "dinounet_tpu/ops/attention_pallas.py:39"),
    "dense_cm_stats": ("dinounet_tpu_torch/csrc/dense_stats.cu",
                       "dinounet_tpu/ops/dense_stats_pallas.py:241"),
    "dense_rm_stats": ("dinounet_tpu_torch/csrc/dense_stats.cu",
                       "dinounet_tpu/ops/dense_stats_pallas.py:71"),
    "msda_fwd": ("dinounet_tpu_torch/csrc/msda_fwd.cu",
                 "dinounet_tpu/ops/msda_pallas.py:251"),
    "msda_bwd": ("dinounet_tpu_torch/csrc/msda_bwd.cu",
                 "dinounet_tpu/ops/msda_pallas.py:582"),
    "msda_fwd_premapped": ("dinounet_tpu_torch/csrc/msda_fwd_premapped.cu",
                           "dinounet_tpu/ops/msda_pallas.py:104"),
    "msda_fwd_merged": ("dinounet_tpu_torch/csrc/msda_fwd.cu",
                        "dinounet_tpu/ops/msda_pallas.py:274"),
    "rope_attention_ndh": ("dinounet_tpu_torch/csrc/rope_attention.cu",
                           "dinounet_tpu/ops/attention_pallas.py:73"),
    "conv3x3_cm": ("dinounet_tpu_torch/csrc/conv3x3_stats.cu",
                   "dinounet_tpu/ops/decoder_tail_pallas.py:141"),
    "transpconv2x2_cm": ("dinounet_tpu_torch/csrc/transpconv2x2.cu",
                         "dinounet_tpu/ops/decoder_tail_pallas.py:399"),
    "seg_head_cm": ("dinounet_tpu_torch/csrc/seg_head.cu",
                    "dinounet_tpu/ops/decoder_tail_pallas.py:207"),
    "conv3x3_hwbc": ("dinounet_tpu_torch/csrc/conv3x3_stats.cu",
                     "dinounet_tpu/ops/conv_hwbc_pallas.py:78"),
    "qkv_q8_dmaj": ("dinounet_tpu_torch/csrc/qkv_q8_dmaj.cu",
                    "dinounet_tpu/ops/dense_q8_pallas.py:457"),
    "dense_q8": ("dinounet_tpu_torch/csrc/dense_q8.cu",
                 "dinounet_tpu/ops/dense_q8_pallas.py:96"),
    "dense_q8_stats": ("dinounet_tpu_torch/csrc/dense_q8.cu",
                       "dinounet_tpu/ops/dense_q8_pallas.py:109"),
    "dense_cm_q8_stats": ("dinounet_tpu_torch/csrc/dense_q8.cu",
                          "dinounet_tpu/ops/dense_q8_pallas.py:130"),
}
# the unet_3d and resenc_3d phases: a raw 3-D NIfTI set of UNET3D_TRAIN
# labelled and UNET3D_TEST test cases of UNET3D_SIZE voxels at 1 mm (a sphere
# and a shell), planned by the default planner (3d_fullres: 128^3 patches,
# batch 2, features 32 to 320) and by nnUNetPlannerResEncM (160^3, batch 2);
# fold 0 validates UNET3D_VAL cases; a 3-D network's mirror TTA has 8
# variants and its predictor's tile batch is TILE_BATCH // 4
UNET3D_ID, UNET3D_DATASET = 993, "Dataset993_Smoke3d"
UNET3D_TRAIN, UNET3D_TEST, UNET3D_VAL = 8, 2, 2
UNET3D_SIZE = (160, 192, 192)
MIRRORS_3D = 8
PLANNED_3D = {"nnUNetPlans": ([128, 128, 128], 2), "nnUNetResEncUNetMPlans": ([160] * 3, 2)}
RESENC_STEPS = 5
# the unet_2d phase: a raw PNG set of UNET2D_CASES cases of UNET2D_SIZE^2
# planned by the default planner (2d: 512^2 patches, 8 stages, features 32
# to 512). The decoder's channel-major chain takes the trailing stages whose
# skip is a multiple of 128 wide (the JAX package's eligibility), here the
# three at 128^2, 256^2 and 512^2 (128, 64 and 32 channels): per tile-batch
# forward 2 convs each, 3 transposed convs and the top seg head. (The 3-D
# set's own 2d plan has 192^2 patches, which the chain does not take.)
UNET2D_ID, UNET2D_DATASET = 992, "Dataset992_Smoke2d"
UNET2D_CASES, UNET2D_SIZE, UNET2D_STEPS = 8, 512, 5
PER_FORWARD_UNET2D_CHAIN = {"conv3x3_cm": 6, "transpconv2x2_cm": 3, "seg_head_cm": 1}
# the logits of one case accumulated on the host against on the device: the
# same fp32 additions in the same order, so equal; held to one fp16 ulp
HOST_ACCUM_RTOL = 2.0 ** -10
# the card's published peaks (NVIDIA H100 SXM data sheet): HBM bytes/s, dense
# bf16 tensor-core FLOP/s, fp32 FLOP/s outside the tensor cores, dense int8
# tensor-core operations/s
HBM_BYTES_S, BF16_FLOP_S, FP32_FLOP_S = 3.35e12, 989e12, 67e12
INT8_OP_S = 1979e12
ARCH = {  # the plans' architecture of a 2d dinounet_b configuration
    "n_stages": 4, "features_per_stage": [32, 64, 128, 256],
    "kernel_sizes": [[3, 3]] * 4, "strides": [[1, 1], [2, 2], [2, 2], [2, 2]],
    "n_conv_per_stage": [2, 2, 2, 2], "n_conv_per_stage_decoder": [2, 2, 2],
    "conv_bias": True,
    "norm_op": "torch.nn.modules.instancenorm.InstanceNorm2d",
    "norm_op_kwargs": {"eps": 1e-05, "affine": True},
    "nonlin": "torch.nn.LeakyReLU", "nonlin_kwargs": {"inplace": True},
}
PLANS = {"dataset_name": "Dataset999_Smoke", "plans_name": "nnUNetPlans",
         "configurations": {"2d": {"patch_size": [PATCH, PATCH],
                                   "architecture": {"network_class_name": "DinoUNet",
                                                    "arch_kwargs": ARCH,
                                                    "_kw_requires_import": []}}}}
DATASET_JSON = {"labels": {"background": 0, "a": 1, "b": 2},
                "channel_names": {"0": "CT"}}


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.lib()
    log(f"[build] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().parent})")
    # the GEMM's instances: q8_gemm_kernel<epilogue, layout>, epilogue 0 the
    # residual + statistics (#11, #12), 1 plain (#10), 2 token columns (#13)
    ptxas_report("dense_q8.cu", {"q8_gemm_kernel (statistics)": "q8_gemm_kernelILi0E",
                                 "q8_gemm_kernel (plain)": "q8_gemm_kernelILi1E",
                                 "quant_cm_kernel": "quant_cm_kernel",
                                 "quant_rows_kernel (GELU)": "quant_rows_kernelILb1",
                                 "quant_rows_kernel": "quant_rows_kernelILb0"})
    ptxas_report("qkv_q8_dmaj.cu", {"q8_gemm_kernel (token columns)": "q8_gemm_kernelILi2E"})
    ptxas_report("conv3x3_stats.cu", {f"conv3x3_kernel<{co}>": f"conv3x3_kernelILi{co}E"
                                      for co in (16, 32, 64, 128)})


def ptxas_report(source: str, kernels: dict) -> None:
    """Registers and spills of `source`'s kernels (display name -> a
    substring of the mangled name), from the build's ptxas.log."""
    text = (_build.library_path().parent / "ptxas.log").read_text()
    part = text.split(f"== {source}:", 1)[1].split("\n== ", 1)[0]
    for entry in part.split("Compiling entry function '")[1:]:
        mangled = entry.split("'", 1)[0]
        for name, key in kernels.items():
            if key not in mangled:
                continue
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", entry)
            log(f"[build] {source} {name}: "
                f"{regs.group(1) if regs else 'not reported'} registers, spills "
                + (f"{spill.group(1)} B stored, {spill.group(2)} B loaded" if spill
                   else "not reported"))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _bound(nbytes: int, flops: float, peak: float):
    """The least time (ms) the card could take: bytes over the HBM rate or
    operations over their type's peak, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_launches(fn, iters: int = 5) -> dict:
    """Device time (ms) and launches per call of fn, by kernel name, from
    torch.profiler's CUDA activity over `iters` calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
        out = {e.key: (e.self_device_time_total / 1e3 / iters, e.count / iters)
               for e in events}
        if events and all(e.count % iters == 0 for e in events):
            return out
        # a window in which the profiler delivered no device activity, or the
        # activity of only some of the calls (a kernel counted 3 times in 5
        # calls), now and then on the card's machine, measured nothing
        # whole: measure again (a call that really launches a kernel a
        # fractional number of times shows it in every window)
        log(f"[profile] {'partial' if out else 'no'} device activity recorded (window "
            f"{attempt + 1}); measuring again")
    return out


def device_times(fn, iters: int = 5) -> dict:
    """Device time (ms) per call of fn, by kernel name."""
    return {k: ms for k, (ms, _) in device_launches(fn, iters).items()}


def _log_int8_breakdown(name, shape_desc, kernel_fn, event_ms, w, ops, nbytes) -> None:
    """An int8 wrapper's device time a call, split into its two launches,
    the quantize pass and the GEMM: anything else it launches (a PyTorch op
    quantizing the weight again, a statistics pass) fails the run. Then the
    one-time quantization of the weight (the cache's fill, by CUDA events),
    and the rates by device time; the rest of the event time is the
    host's."""
    parts = {"quantize pass": [0.0, 0.0], "gemm": [0.0, 0.0], "other": [0.0, 0.0]}
    for kernel, (ms, n) in device_launches(kernel_fn).items():
        part = ("quantize pass" if "quant_" in kernel else "gemm" if "gemm" in kernel
                else "other")
        parts[part][0] += ms
        parts[part][1] += n
    if any(n != want for (_, n), want in zip(parts.values(), (1, 1, 0))):
        raise AssertionError(f"{name} {shape_desc}: launches a call {parts}, not one "
                             "quantize pass and one GEMM")
    busy = sum(ms for ms, _ in parts.values())
    once_ms = median_ms(lambda: quantize_weight_dk(w), iters=5)
    log(f"[kernels] {name} {shape_desc}: device time {busy:.4f} ms a call ("
        + ", ".join(f"{k} {v[0]:.4f}" for k, v in parts.items() if k != "other")
        + f"; 2 launches, nothing else) = {ops / busy / 1e9:.1f} TOPS, "
        f"{nbytes / busy / 1e6:.1f} GB/s; {event_ms - busy:.4f} ms of the "
        f"{event_ms:.4f} ms event time idle; the weight's one-time quantization "
        f"{once_ms:.4f} ms (not a call's)")


def _log_conv_breakdown(name, shape_desc, kernel_fn, stats, w) -> None:
    """A conv3x3 wrapper's device time a call, split into the conv kernel
    and, where it returns statistics, the C entry's memset of the sums.
    Anything else (the weight packed again, a copy of an input) fails the
    run. Then the weight's one-time pack (the cache's fill, by CUDA
    events)."""
    _log_launch_split(name, shape_desc, kernel_fn,
                      {"conv kernel": "conv3x3_kernel", "sums memset": "Memset"},
                      {"conv kernel": 1, "sums memset": 1 if stats else 0},
                      ("the weight's one-time pack", lambda: pack_conv_weight(w)))


def _log_launch_split(name, shape_desc, kernel_fn, parts: dict, want: dict,
                      once=None) -> None:
    """A wrapper's device time a call, split by the kernels it launches
    (`parts`: label -> a substring of the kernel's name, first match wins):
    `want` holds the launches a call must make by label, and any other
    launch (a weight packed again, a copy of an input) or count fails the
    run. `once`: (label, fn) of a one-time cost timed beside it (the
    weight's pack)."""
    got = {label: [0.0, 0.0] for label in [*parts, "other"]}
    for kernel, (ms, n) in device_launches(kernel_fn).items():
        label = next((k for k, key in parts.items() if key.lower() in kernel.lower()),
                     "other")
        got[label][0] += ms
        got[label][1] += n
    counts = {k: round(v[1], 3) for k, v in got.items()}
    if counts != {**dict.fromkeys(got, 0), **want}:
        raise AssertionError(f"{name} {shape_desc}: launches a call {counts}, not {want}")
    busy = sum(ms for ms, _ in got.values())
    once_txt = ""
    if once is not None:
        once_txt = f"; {once[0]} {median_ms(once[1], iters=5):.4f} ms once (not a call's)"
    log(f"[kernels] {name} {shape_desc}: device time {busy:.4f} ms a call ("
        + ", ".join(f"{k} {v[0]:.4f} x{round(v[1])}" for k, v in got.items() if v[1])
        + f"; nothing else){once_txt}")


MSDA_FWD_PARTS = {"gathers": "msda_fwd_fused_kernel", "token-major copy": "transpose_kernel"}
MSDA_PREMAPPED_PARTS = {"gathers": "msda_fwd_premapped_kernel",
                        "token-major copy": "transpose_kernel"}
MSDA_BWD_PARTS = {"walk": "msda_bwd_kernel", "finish": "finish_kernel",
                  "slice sums": "sum_slices_kernel", "gv scratch memset": "Memset",
                  "device-memory walk": "msda_bwd_global_kernel",
                  "transposes": "transpose_kernel"}
GRID_SAMPLE_LABEL = "library (grid_sample alone: the stock gather, a partial yardstick)"


def _grid_sample_fwd(v, shapes, xs, ys):
    """grid_sample's forward on v's one level (B, M, D, S) at the points
    (xs, ys) (B, M, P, Lq) in pixels: bilinear, zero padding,
    align_corners=False, in v's dtype; no prep, no sum over points."""
    (H, W), = shapes
    B, M, D, _ = v.shape
    P, Lq = xs.shape[2], xs.shape[3]
    inp = v.reshape(B * M, D, H, W)
    grid = torch.stack([(xs + 0.5) * (2.0 / W) - 1.0, (ys + 0.5) * (2.0 / H) - 1.0], dim=-1)
    grid = grid.reshape(B * M, P, Lq, 2).transpose(1, 2).contiguous().to(v.dtype)
    return lambda: F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=False)


def _grid_sample_bwd(v, shapes, xs, ys, g):
    """grid_sample's backward to the map and the grid (fp32) at the same
    points, the cotangent g (B, M, D, Lq) spread over the points."""
    (H, W), = shapes
    B, M, D, _ = v.shape
    P, Lq = xs.shape[2], xs.shape[3]
    inp = v.float().reshape(B * M, D, H, W).requires_grad_(True)
    grid = torch.stack([(xs + 0.5) * (2.0 / W) - 1.0, (ys + 0.5) * (2.0 / H) - 1.0], dim=-1)
    grid = grid.reshape(B * M, P, Lq, 2).transpose(1, 2).contiguous().requires_grad_(True)
    out = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros", align_corners=False)
    cot = g.reshape(B * M, D, Lq, 1).expand(-1, -1, -1, P).contiguous()
    return lambda: torch.autograd.grad(out, (inp, grid), cot, retain_graph=True)


def _compare(name, shape_desc, kernel_fn, plain_fn, inputs, flops, peak,
             library_fn=None, tols=None, library_label="library", plain_iters=20,
             exact=False):
    """Kernel vs plain version on the same inputs; `inputs` are the tensors
    the function reads (each counted once in the bound, with the outputs);
    `tols` optionally one (atol, rtol) per output (default: the kernel's);
    `exact`: the first output must equal the plain one bit for bit; the
    plain version timed over `plain_iters` calls."""
    got, want = kernel_fn(), plain_fn()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    tols = tols or [KERNEL_TOLERANCES[name]] * len(got)
    excess = max(max_excess(g, w, tol) for g, w, tol in zip(got, want, tols))
    if exact and not torch.equal(got[0], want[0]):
        raise AssertionError(f"{name} {shape_desc}: output differs from the plain "
                             f"version's (max abs {max_abs_err(got[0], want[0])})")
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    rel = max(max_abs_err(g, w) / max(float(w.float().abs().max()), 1e-30)
              for g, w in zip(got, want))
    bound_ms, bound_by = _bound(_nbytes(*inputs, *got), flops, peak)
    ms, plain_ms = median_ms(kernel_fn), median_ms(plain_fn, iters=plain_iters)
    library_ms = median_ms(library_fn) if library_fn is not None else None
    lib_txt = f", {library_label} {library_ms:.4f} ms" if library_ms is not None else ""
    log(f"[kernels] {name} {shape_desc}: max abs err {err:.3e} (max rel "
        f"{rel:.3e}; bound atol {tols[0][0]} + rtol {tols[0][1]}*|ref|, excess "
        f"{excess:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_txt}; "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    if not excess <= 0:
        raise AssertionError(f"{name} {shape_desc}: kernel disagrees with its "
                             f"plain version (excess {excess})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def _conv_case(g, dev, B, C1, C2, H, W, Cout, prologue, slope=0.01):
    """Random bf16 inputs, (Cout, Cin, 3, 3) weights and an optional prologue
    (as an InstanceNorm apply gives it) for one 3x3 conv of the path."""
    bf = torch.bfloat16
    x = torch.randn((B, C1, H, W), generator=g, device=dev).to(bf)
    x2 = torch.randn((B, C2, H, W), generator=g, device=dev).to(bf) if C2 else None
    cin = C1 + C2
    w = torch.randn((Cout, cin, 3, 3), generator=g, device=dev) * (9 * cin) ** -0.5
    b = torch.randn((Cout,), generator=g, device=dev) * 0.1
    pro = None
    if prologue:
        pro = (torch.rand((B, cin), generator=g, device=dev) + 0.5,
               torch.randn((B, cin), generator=g, device=dev) * 0.3)
    return x, x2, w, b, pro, slope


def _conv_library(x, x2, w, b):
    """cuDNN's conv alone on channels-last bf16 (the concat made beforehand)."""
    xin = x if x2 is None else torch.cat([x, x2], dim=1)
    xin = xin.contiguous(memory_format=torch.channels_last)
    wl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bl = b.to(torch.bfloat16)
    return lambda: F.conv2d(xin, wl, bl, padding=1)


CUDNN_LABEL = "library (cuDNN conv alone, channels-last bf16)"
INT8MM_LABEL = "library (torch._int_mm alone, pre-quantized int8)"


def _normalized(out, n):
    """(y, sum, ssq) -> (y, sum / n, ssq / n): statistics compared as means."""
    return (out[0], out[1] / n, out[2] / n) if isinstance(out, tuple) else out


def phase_kernels(dev) -> dict:
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    B = TILE_BATCH

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    results = {}
    # attention: ViT-B, 12 heads of 64 over 5 + 32 * 32 tokens (a 512^2
    # tile); the same Dh-major kernel at Dh = 128 (the flash loop it shares
    # with the row-major one); both layouts again on a 1024^2 patch's
    # 5 + 64 * 64 tokens. Library: scaled_dot_product_attention on the
    # rotated q, k and v. Each case also prints its rate: 4 B M N^2 Dh FLOP
    # over the kernel's time, and over SDPA's

    def vit_tables(Dh, side):
        """A side x side patch grid's RoPE tables with the 5 prefix rows."""
        sin, cos = rope_sincos(side, side, Dh, device=dev)
        return (torch.cat([torch.zeros((5, Dh), device=dev), sin]),
                torch.cat([torch.ones((5, Dh), device=dev), cos]))

    def log_rate(name, N, flops, r, kernel_fn):
        """The case's rates, and its device time split by the profiler into
        the RoPE pre-pass and the flash loop (the loop's own rate beside)."""
        prep = loop = 0.0
        for kernel, ms in device_times(kernel_fn).items():
            if "rope_prep" in kernel:
                prep += ms
            elif "rope_attention_kernel" in kernel:
                loop += ms
        log(f"[kernels] {name} N={N}: {flops / r['ms'] / 1e9:.1f} TFLOP/s "
            f"({r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms = "
            f"{BF16_FLOP_S / 1e12:.0f} TFLOP/s; SDPA {r['library_ms']:.4f} ms = "
            f"{flops / r['library_ms'] / 1e9:.1f} TFLOP/s); device time: pre-pass "
            f"{prep:.4f} ms, loop {loop:.4f} ms = {flops / max(loop, 1e-9) / 1e9:.1f} TFLOP/s")

    for Bq, M, Dh, side in ((B, 12, 64, 32), (2, 32, 128, 32), (2, 12, 64, 64)):
        N = 5 + side * side
        qkv = randn(Bq, 3, M, Dh, N).to(bf)
        sin, cos = vit_tables(Dh, side)
        tables = rope_tables_dmaj(sin, cos, N, Dh, dev)

        def rotated(x):
            xf = x.float()
            r = xf * tables[1] + torch.roll(xf, Dh // 2, dims=-2) * tables[0]
            return r.to(bf).transpose(-1, -2).contiguous()  # (B, M, N, Dh)

        q, k = rotated(qkv[:, 0]), rotated(qkv[:, 1])
        v = qkv[:, 2].transpose(-1, -2).contiguous()
        flops = 4.0 * Bq * M * N * N * Dh
        r = _compare(
            "rope_attention", f"qkv {tuple(qkv.shape)}",
            lambda: fused_rope_attention_premapped_dmaj(qkv, sin, cos),
            lambda: rope_attention_dmaj_plain(qkv, *tables),
            (qkv, sin, cos), flops, BF16_FLOP_S,
            lambda: F.scaled_dot_product_attention(q, k, v))
        log_rate("rope_attention", N, flops, r,
                 lambda: fused_rope_attention_premapped_dmaj(qkv, sin, cos))
        results.setdefault("rope_attention", r)
        if Bq == B:  # the same qkv in the (B, 3, M, N, Dh) layout
            qkv_ndh = qkv.transpose(-1, -2).contiguous()
            tables_ndh = rope_tables(sin, cos, N, Dh, dev)
            results["rope_attention_ndh"] = _compare(
                "rope_attention_ndh", f"qkv {tuple(qkv_ndh.shape)}",
                lambda: fused_rope_attention_premapped(qkv_ndh, sin, cos),
                lambda: rope_attention_ndh_plain(qkv_ndh, *tables_ndh),
                (qkv_ndh, sin, cos), flops, BF16_FLOP_S,
                lambda: F.scaled_dot_product_attention(q, k, v))
            log_rate("rope_attention_ndh", N, flops, results["rope_attention_ndh"],
                     lambda: fused_rope_attention_premapped(qkv_ndh, sin, cos))
        del qkv, q, k, v

    # the row-major attention of dinounet_7b's SwiGLU blocks: 32 heads of 128,
    # at the tile batch on a 512^2 tile and at batch 2 on a 1024^2 patch
    M, Dh = 32, 128
    for Bq, side in ((B, 32), (2, 64)):
        N = 5 + side * side
        qkv = randn(Bq, N, 3, M, Dh).to(bf)
        sin, cos = vit_tables(Dh, side)
        sin_eff, cos_f = rope_tables(sin, cos, N, Dh, dev)

        def rotated_rm(x):  # (B, N, M, Dh) -> rotated (B, M, N, Dh)
            xf = x.float()
            r = xf * cos_f[:, None] + torch.roll(xf, Dh // 2, dims=-1) * sin_eff[:, None]
            return r.to(bf).transpose(1, 2).contiguous()

        q, k = rotated_rm(qkv[:, :, 0]), rotated_rm(qkv[:, :, 1])
        v = qkv[:, :, 2].transpose(1, 2).contiguous()
        flops = 4.0 * Bq * M * N * N * Dh
        r = _compare(
            "rope_attention_rm", f"qkv {tuple(qkv.shape)}",
            lambda: fused_rope_attention(qkv, sin, cos),
            lambda: rope_attention_plain(qkv, sin_eff, cos_f),
            (qkv, sin, cos), flops, BF16_FLOP_S,
            lambda: F.scaled_dot_product_attention(q, k, v),
            plain_iters=20 if side == 32 else 3)
        log_rate("rope_attention_rm", N, flops, r, lambda: fused_rope_attention(qkv, sin, cos))
        results.setdefault("rope_attention_rm", r)
        del qkv, q, k, v

    # dense + residual + stats: (K, N) of the ViT and of the adapter, D = 768,
    # then dinounet_7b's extractor junctions, D = 4096: the MSDA output
    # projection (K = 2048, channel-major) and the ConvFFN fc2 (K = 1024,
    # GELU). The weight is an fp32 Linear's (D, K) storage passed as its
    # transpose, as the models pass it. Library: the cuBLAS GEMM alone (a
    # lower yardstick: no epilogue). Each case also prints its rates and its
    # device time split by the profiler

    def log_dense(name, desc, r, kernel_fn, flops, nbytes):
        """TFLOP/s and GB/s by event time against the bound, and the device
        time split into the GEMM, the GELU pre-pass, a statistics pass and the
        wrapper's PyTorch ops (the weight's cast to bf16)."""
        parts = {"gemm": 0.0, "gelu pre-pass": 0.0, "statistics pass": 0.0,
                 "weight cast": 0.0}
        for kernel, ms in device_times(kernel_fn).items():
            part = ("gelu pre-pass" if "gelu_prepass" in kernel
                    else "statistics pass" if "row_stats" in kernel
                    else "gemm" if "dense_" in kernel else "weight cast")
            parts[part] += ms
        busy = sum(parts.values())
        log(f"[kernels] {name} {desc}: {flops / r['ms'] / 1e9:.1f} TFLOP/s, "
            f"{nbytes / r['ms'] / 1e6:.1f} GB/s by event time ({r['ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % "
            f"of it; cuBLAS GEMM alone {r['library_ms']:.4f} ms); device time "
            f"{busy:.4f} ms (" + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
            + f") = {flops / busy / 1e9:.1f} TFLOP/s, {nbytes / busy / 1e6:.1f} GB/s")

    D7 = 4096
    for K, N, D, cm, where in ((768, 1029, 768, True, "vit proj"),
                               (384, 5376, 768, True, "msda output proj"),
                               (3072, 1029, 768, False, "vit fc2 +GELU"),
                               (192, 5376, 768, False, "convffn fc2 +GELU"),
                               (2048, 5376, 4096, True, "7B msda output proj"),
                               (1024, 5376, 4096, False, "7B convffn fc2 +GELU")):
        h = randn(B, K, N).to(bf) if cm else randn(B, N, K).to(bf)
        w, b = randn(D, K, scale=K ** -0.5).t(), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        wb, hl = w.to(bf), (h.transpose(1, 2) if cm else h)
        name = "dense_cm_stats" if cm else "dense_rm_stats"
        if cm:
            kernel_fn = lambda: dense_cm_residual_stats(h, w, b, res, gamma)
            plain_fn = lambda: dense_cm_residual_stats_plain(h, w, b, res, gamma)
        else:
            kernel_fn = lambda: dense_residual_stats(h, w, b, res, gamma, apply_gelu=True)
            plain_fn = lambda: dense_residual_stats_plain(h, w, b, res, gamma, True)
        # the 7B junctions' outputs within JUNCTION_7B_TOL, the statistics
        # within the kernel's own
        tols = [JUNCTION_7B_TOL] + [KERNEL_TOLERANCES[name]] * 2 if D == D7 else None
        flops = 2.0 * B * N * K * D
        desc = f"{where} K={K} N={N} D={D}"
        r = _compare(name, desc, kernel_fn, plain_fn, (h, w, b, res, gamma), flops,
                     BF16_FLOP_S, lambda: torch.matmul(hl, wb), tols)
        log_dense(name, desc, r, kernel_fn, flops,
                  _nbytes(h, w, b, res, gamma) + B * N * (2 * D + 8))
        if D != D7:
            results.setdefault(name, r)
        del h, w, res

    # MSDA: 16 heads over the 32 x 32 ViT grid, 5376 queries around the
    # adapter's reference grid, 4 points: 24 channels a head (dinounet_b),
    # then 128 (dinounet_7b, the kernel's 32-channel slices); no library op
    # computes it: grid_sample on the same map and points (the gather alone)
    # stands in as a partial yardstick. Operations: 4 corners x 2 FLOP per
    # channel and point (fp32 FMA).
    Mq, Hv, P, Lq = 16, 32, 4, 5376
    base = torch.rand((2 * P, Lq), generator=g, device=dev) * Hv - 0.5

    def msda_forwards(Bw, Dw, Hw, Lw, bw, what, plain_iters=20):
        """#1, then #6 on the same inputs packed, then #5 on their prepped
        coordinates and weights; each held against its plain version, its
        device time split by launch. Returns the inputs and the three results."""
        vw = randn(Bw, Mq, Dw, Hw * Hw).to(bf)
        ow, lw = randn(Bw, Mq, 2 * P, Lw, scale=2.0).to(bf), randn(Bw, Mq, P, Lw).to(bf)
        shapes = ((Hw, Hw),)
        desc = f"{what}value {tuple(vw.shape)} Lq={Lw}"
        flops = 8.0 * Bw * Mq * Lw * P * Dw
        # the forwards stage slices as narrow as one 16-byte cell a position
        global_copy = 16 * Hw * Hw > 232448
        xw, yw, aww = (t.contiguous() for t in premapped_fused_prep(ow, lw, bw))
        library = _grid_sample_fwd(vw, shapes, xw, yw)
        r1 = _compare(
            "msda_fwd", desc,
            lambda: ms_deform_attn_premapped_fused(vw, shapes, ow, lw, bw),
            lambda: ms_deform_attn_premapped_fused_plain(vw, shapes, ow, lw, bw),
            (vw, ow, lw, bw), flops, FP32_FLOP_S, library, library_label=GRID_SAMPLE_LABEL,
            plain_iters=plain_iters)
        _log_launch_split("msda_fwd", desc,
                          lambda: ms_deform_attn_premapped_fused(vw, shapes, ow, lw, bw),
                          MSDA_FWD_PARTS, {"gathers": 1, "token-major copy": int(global_copy)})
        packed = torch.cat([ow, lw], dim=2)
        r6 = _compare(
            "msda_fwd_merged", f"{desc} packed {tuple(packed.shape)}",
            lambda: ms_deform_attn_premapped_fused_merged(vw, shapes, packed, bw),
            lambda: ms_deform_attn_premapped_fused_merged_plain(vw, shapes, packed, bw),
            (vw, packed, bw), flops, FP32_FLOP_S, library, library_label=GRID_SAMPLE_LABEL,
            plain_iters=plain_iters)
        _log_launch_split("msda_fwd_merged", desc,
                          lambda: ms_deform_attn_premapped_fused_merged(vw, shapes, packed, bw),
                          MSDA_FWD_PARTS, {"gathers": 1, "token-major copy": int(global_copy)})
        del packed
        r5 = _compare(
            "msda_fwd_premapped", f"{desc} L=1",
            lambda: ms_deform_attn_premapped(vw, shapes, xw, yw, aww),
            lambda: ms_deform_attn_premapped_plain(vw, shapes, xw, yw, aww),
            (vw, xw, yw, aww), flops, FP32_FLOP_S, library, library_label=GRID_SAMPLE_LABEL,
            plain_iters=plain_iters)
        _log_launch_split("msda_fwd_premapped", desc,
                          lambda: ms_deform_attn_premapped(vw, shapes, xw, yw, aww),
                          MSDA_PREMAPPED_PARTS,
                          {"gathers": 1, "token-major copy": int(global_copy)})
        del xw, yw, aww, library
        return (vw, ow, lw), (r1, r6, r5)

    for Dv in (24, 128):
        inputs, rs = msda_forwards(B, Dv, Hv, Lq, base, "")
        for name, r in zip(("msda_fwd", "msda_fwd_merged", "msda_fwd_premapped"), rs):
            results.setdefault(name, r)
        if Dv == 24:
            v, off, logits = inputs
        del inputs
    Dv = 24
    flops = 8.0 * B * Mq * Lq * P * Dv
    # the prepped-input forward (#5) over two levels (the map and a 16 x 16
    # one, 4 points each; coordinates past every edge)
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(off, logits, base))
    shapes2 = ((Hv, Hv), (Hv // 2, Hv // 2))
    v2 = torch.cat([v, randn(B, Mq, Dv, (Hv // 2) ** 2).to(bf)], dim=3).contiguous()
    xs2 = torch.cat([xs, torch.rand((B, Mq, P, Lq), generator=g, device=dev) * 20 - 2], 2)
    ys2 = torch.cat([ys, torch.rand((B, Mq, P, Lq), generator=g, device=dev) * 20 - 2], 2)
    aw2 = torch.softmax(randn(B, Mq, 2 * P, Lq), dim=2)
    _compare("msda_fwd_premapped", f"value {tuple(v2.shape)} L=2 Lq={Lq}",
             lambda: ms_deform_attn_premapped(v2, shapes2, xs2, ys2, aw2),
             lambda: ms_deform_attn_premapped_plain(v2, shapes2, xs2, ys2, aw2),
             (v2, xs2, ys2, aw2), 2 * flops, FP32_FLOP_S)
    del v2, xs2, ys2, aw2

    # MSDA backward at the train step's shapes (batch 2): the prepped
    # coordinates and weights of the forward's inputs, an fp32 cotangent.
    # Operations: per corner and channel the value-gradient scatter, the
    # attention-weight product and the two coordinate derivatives (8 FLOP).
    # Each call runs the staged instance (msda_kernel.bwd_plan: the whole
    # head at D 24 and 32 and on the patch, four slices at the 7B's D 128):
    # the memset of its gv scratch, the walk, the finishing transpose into
    # gv, and for a sliced head the sum of its slices' ga / gx / gy; never
    # the device-memory instance

    def msda_backward(vb, shapes, xb, yb, ab, cb, what, plain_iters=20):
        Bb, _, Db, Sb = vb.shape
        Lb = xb.shape[3]
        desc = f"{what}value {tuple(vb.shape)} Lq={Lb}"
        r = _compare(
            "msda_bwd", desc,
            lambda: ms_deform_attn_premapped_backward(vb, shapes, xb, yb, ab, cb),
            lambda: ms_deform_attn_premapped_backward_plain(vb, shapes, xb, yb, ab, cb),
            (vb, xb, yb, ab, cb), 32.0 * Bb * Mq * Lb * P * Db, FP32_FLOP_S,
            _grid_sample_bwd(vb, shapes, xb, yb, cb), library_label=GRID_SAMPLE_LABEL,
            plain_iters=plain_iters)
        plan = bwd_plan(Db, Sb, vb.element_size())
        if plan is None:
            raise AssertionError(f"msda_bwd {desc}: the device-memory instance")
        _log_launch_split("msda_bwd", desc,
                          lambda: ms_deform_attn_premapped_backward(vb, shapes, xb, yb, ab, cb),
                          MSDA_BWD_PARTS, {"walk": 1, "finish": 1, "gv scratch memset": 1,
                                           "slice sums": int(plan[1] > 1)})
        return r

    Bt = 2
    xs, ys, aw = (t.contiguous() for t in premapped_fused_prep(
        off[:Bt], logits[:Bt], base))
    cot = randn(Bt, Mq, Dv, Lq)
    vt = v[:Bt].contiguous()
    results["msda_bwd"] = msda_backward(vt, ((Hv, Hv),), xs, ys, aw, cot, "")
    # the backward at dinounet_l's train shape (16 heads of 32), the 7B's (of
    # 128) and at a 1024^2 patch (a 64 x 64 map, 21504 queries); the three
    # forwards at D 32 on that map (in 16-channel slices). Plain versions
    # timed over 3 calls
    for Dw, Hw, Bw, what in ((32, Hv, Bt, "dinounet_l train"), (128, Hv, Bt, "dinounet_7b train"),
                             (Dv, 2 * Hv, Bt, "1024^2 patch"), (32, 2 * Hv, B, "1024^2 patch")):
        Lw, Sw = 21 * (Hw // 2) ** 2, Hw * Hw
        vw = randn(Bw, Mq, Dw, Sw).to(bf)
        bw = torch.rand((2 * P, Lw), generator=g, device=dev) * Hw - 0.5
        ow, lw = randn(Bw, Mq, 2 * P, Lw, scale=2.0).to(bf), randn(Bw, Mq, P, Lw).to(bf)
        if Bw == Bt:
            xw, yw, aww = (t.contiguous() for t in premapped_fused_prep(ow, lw, bw))
            cw = randn(Bw, Mq, Dw, Lw)
            msda_backward(vw, ((Hw, Hw),), xw, yw, aww, cw, f"{what} ", plain_iters=3)
            del xw, yw, aww, cw
        else:
            del vw, ow, lw
            msda_forwards(Bw, Dw, Hw, Lw, bw, f"{what} ", plain_iters=3)
            continue
        del vw, ow, lw

    # the decoder/SPM conv family at the dinounet_b serve shapes (tile batch
    # 8, 512^2 tiles). The first of each kernel's shapes is the one its JSON
    # entry reports. A call reads the weight packed in bf16, made once per
    # weight version (packed_conv_weight, packed_transpconv_weight), so the
    # bound counts that, not the fp32 weight, as the int8 cases count the
    # cached int8 levels
    conv_cases = [  # (where, C1, C2, H, Cout, prologue, slope, stats)
        ("decoder conv0 512^2", 32, 32, 512, 32, False, 0.01, True),
        ("decoder conv1 512^2", 32, 0, 512, 32, True, 0.01, True),
        ("decoder conv0 256^2", 64, 64, 256, 64, False, 0.01, True),
        ("decoder conv1 256^2", 64, 0, 256, 64, True, 0.01, True),
        ("decoder conv0 128^2", 128, 128, 128, 128, False, 0.01, True),
        ("decoder conv1 128^2", 128, 0, 128, 128, True, 0.01, True),
        ("SPM stem3 256^2", 64, 0, 256, 64, True, 0.0, False),
    ]
    for where, C1, C2, H, Cout, pro, slope, stats in conv_cases:
        x, x2, w, b, p, slope = _conv_case(g, dev, B, C1, C2, H, H, Cout, pro, slope)
        n = H * H
        tols = [KERNEL_TOLERANCES["conv3x3_cm"]] + [STATS_TOLERANCE] * (2 if stats else 0)
        r = _compare(
            "conv3x3_cm", f"{where} ({C1}+{C2} -> {Cout})",
            lambda: _normalized(conv3x3_cm(x, w, b, p, slope, stats, x2), n),
            lambda: _normalized(conv3x3_cm_plain(x, w, b, p, slope, stats, x2), n),
            (x, x2, packed_conv_weight(w), b, *(p or ())), 2.0 * B * n * 9 * (C1 + C2) * Cout,
            BF16_FLOP_S,
            _conv_library(x, x2, w, b), tols, CUDNN_LABEL)
        _log_conv_breakdown("conv3x3_cm", f"{where} ({C1}+{C2} -> {Cout})",
                            lambda: conv3x3_cm(x, w, b, p, slope, stats, x2), stats, w)
        results.setdefault("conv3x3_cm", r)
    # the HWBC route's convs on (H, W, B, C) views of NCHW maps, as the
    # decoder calls them
    for where, C1, C2, H, Cout, pro in (("conv0 512^2", 32, 32, 512, 32, False),
                                        ("conv1 512^2", 32, 0, 512, 32, True),
                                        ("conv0 256^2", 64, 64, 256, 64, False),
                                        ("conv1 256^2", 64, 0, 256, 64, True)):
        x, x2, w, b, p, slope = _conv_case(g, dev, B, C1, C2, H, H, Cout, pro)
        xv, x2v = x.permute(2, 3, 0, 1), None if x2 is None else x2.permute(2, 3, 0, 1)
        n = H * H
        tols = [KERNEL_TOLERANCES["conv3x3_hwbc"], STATS_TOLERANCE, STATS_TOLERANCE]
        r = _compare(
            "conv3x3_hwbc", f"{where} ({C1}+{C2} -> {Cout})",
            lambda: _normalized(conv3x3_hwbc(xv, w, b, x2v, p, slope), n),
            lambda: _normalized(conv3x3_hwbc_plain(xv, w, b, x2v, p, slope), n),
            (x, x2, packed_conv_weight(w), b, *(p or ())), 2.0 * B * n * 9 * (C1 + C2) * Cout,
            BF16_FLOP_S,
            _conv_library(x, x2, w, b), tols, CUDNN_LABEL)
        _log_conv_breakdown("conv3x3_hwbc", f"{where} ({C1}+{C2} -> {Cout})",
                            lambda: conv3x3_hwbc(xv, w, b, x2v, p, slope), True, w)
        results.setdefault("conv3x3_hwbc", r)
    # transposed convs: the decoder's three (with the previous stage's
    # InstanceNorm apply after the first) and LearnableUpsample doublings
    for where, Cin, Cout, H, pro in (("decoder 256^2", 64, 32, 256, True),
                                     ("decoder 128^2", 128, 64, 128, True),
                                     ("decoder 64^2", 256, 128, 64, False),
                                     ("upsample 256^2", 32, 32, 256, False),
                                     ("upsample 32^2", 256, 256, 32, False)):
        x = randn(B, Cin, H, H).to(bf)
        w, b = randn(Cin, Cout, 2, 2, scale=Cin ** -0.5), randn(Cout, scale=0.1)
        p = (torch.rand((B, Cin), generator=g, device=dev) + 0.5,
             randn(B, Cin, scale=0.3)) if pro else None
        xl = x.contiguous(memory_format=torch.channels_last)
        wl, bl = w.to(bf), b.to(bf)
        r = _compare(
            "transpconv2x2_cm", f"{where} ({Cin} -> {Cout})",
            lambda: transpconv2x2_cm(x, w, b, p), lambda: transpconv2x2_cm_plain(x, w, b, p),
            (x, packed_transpconv_weight(w), b, *(p or ())), 2.0 * B * H * H * Cin * 4 * Cout,
            BF16_FLOP_S,
            lambda: F.conv_transpose2d(xl, wl, bl, stride=2), library_label=CUDNN_LABEL)
        _log_launch_split("transpconv2x2_cm", f"{where} ({Cin} -> {Cout})",
                          lambda: transpconv2x2_cm(x, w, b, p),
                          {"transpconv kernel": "transpconv2x2_kernel"},
                          {"transpconv kernel": 1},
                          ("the weight's pack", lambda: pack_transpconv_weight(w)))
        results.setdefault("transpconv2x2_cm", r)
    # the seg head over the last stage: (8, 32, 512, 512) -> 3 fp32 logits;
    # one launch a call, its (C, K) weight prepared once (the bound counts it)
    C, K, H = 32, N_CLASSES, PATCH
    x = randn(B, C, H, H).to(bf)
    w, b = randn(K, C, 1, 1, scale=C ** -0.5), randn(K, scale=0.1)
    p = (torch.rand((B, C), generator=g, device=dev) + 0.5, randn(B, C, scale=0.3))
    xl, wl = x.contiguous(memory_format=torch.channels_last), w.to(bf)
    desc = f"({B}, {C}, {H}, {H}) -> {K}"
    results["seg_head_cm"] = _compare(
        "seg_head_cm", desc,
        lambda: seg_head_cm(x, w, b, p), lambda: seg_head_cm_plain(x, w, b, p),
        (x, packed_seg_weight(w), b, *p), 2.0 * B * H * H * C * K, FP32_FLOP_S,
        lambda: F.conv2d(xl, wl), library_label=CUDNN_LABEL)
    _log_launch_split("seg_head_cm", desc, lambda: seg_head_cm(x, w, b, p),
                      {"seg head kernel": "seg_head"}, {"seg head kernel": 1},
                      ("the weight's preparation", lambda: pack_seg_weight(w)))

    # the int8 serving mode's w8a8 ops at the path's shapes, each fed an fp32
    # Linear weight's transpose as the models feed it. The weight is
    # quantized once (ops/dense_q8.py keeps its int8 levels on the tensor),
    # so the bound counts the cached int8 (D, Kpad) weight and its fp32
    # scales, not the fp32 weight, beside h, b, res, gamma and the outputs.
    # Library: torch._int_mm on the pre-quantized operands, the int8 GEMM
    # alone (no quantization, rescale or epilogue). Without the GELU the
    # outputs equal the plain versions' bit for bit
    def int8_case(name, desc, kernel_fn, plain_fn, h, w, rest, ops, channel_major=False,
                  exact=True):
        wq, ws = quantized_weight(w)
        xq = quantize_act_tokens(h, channel_major)[0]
        r = _compare(name, desc, kernel_fn, plain_fn, (h, wq, ws, *rest), ops, INT8_OP_S,
                     lambda: torch._int_mm(xq, wq.t()), library_label=INT8MM_LABEL,
                     exact=exact)
        out = kernel_fn()
        nbytes = _nbytes(h, wq, ws, *rest, *(out if isinstance(out, tuple) else (out,)))
        log(f"[kernels] {name} {desc}: {ops / r['ms'] / 1e9:.1f} TOPS, "
            f"{nbytes / r['ms'] / 1e6:.1f} GB/s by event time ({r['ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms by {r['bound_by']}, {100 * r['bound_ms'] / r['ms']:.1f} % "
            f"of it; _int_mm alone {r['library_ms']:.4f} ms)")
        _log_int8_breakdown(name, desc, kernel_fn, r["ms"], w, ops, nbytes)
        return r

    def linear_t(K, D):
        """An fp32 Linear weight (D, K) as its (K, D) transpose."""
        return randn(D, K, scale=K ** -0.5).t()

    C, N, D = 768, 1029, 768
    x = randn(B, N, C).to(bf)
    w, b = linear_t(C, 3 * C), randn(3 * C, scale=0.1)
    results["qkv_q8_dmaj"] = int8_case(
        "qkv_q8_dmaj", f"x {tuple(x.shape)} -> ({B}, 3, 12, 64, {N})",
        lambda: qkv_q8_dmaj(x, w, b, 12, 64), lambda: qkv_q8_dmaj_plain(x, w, b, 12, 64),
        x, w, (b,), 2.0 * B * N * C * 3 * C)
    # and at an edge shape (not timed): 3 images of 129 tokens, so that the
    # GEMM's 128-token tiles end inside images and span two
    xe = randn(3, 129, C).to(bf)
    got, want = qkv_q8_dmaj(xe, w, b, 12, 64), qkv_q8_dmaj_plain(xe, w, b, 12, 64)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"qkv_q8_dmaj x {tuple(xe.shape)}: differs from the plain "
                             f"version (max abs {max_abs_err(got, want)})")
    log(f"[kernels] qkv_q8_dmaj x {tuple(xe.shape)}: bit-equal to the plain version")
    for K, N, where in ((768, 1029, "vit proj"), (384, 5376, "msda output proj")):
        h = randn(B, K, N).to(bf)
        w, b = linear_t(K, D), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        r = int8_case("dense_cm_q8_stats", f"{where} K={K} N={N}",
                      lambda: dense_cm_q8_residual_stats(h, w, b, res, gamma),
                      lambda: dense_cm_q8_residual_stats_plain(h, w, b, res, gamma),
                      h, w, (b, res, gamma), 2.0 * B * N * K * D, channel_major=True)
        results.setdefault("dense_cm_q8_stats", r)
    K, N, Dff = 768, 1029, 3072
    h = randn(B, N, K).to(bf)
    w, b = linear_t(K, Dff), randn(Dff, scale=0.1)
    results["dense_q8"] = int8_case(
        "dense_q8", f"vit fc1 K={K} D={Dff} N={N}", lambda: dense_q8(h, w, b),
        lambda: dense_q8_plain(h, w, b), h, w, (b,), 2.0 * B * N * K * Dff)
    for K, N, where in ((3072, 1029, "vit fc2"), (192, 5376, "convffn fc2")):
        h = randn(B, N, K).to(bf)
        w, b = linear_t(K, D), randn(D, scale=0.1)
        res, gamma = randn(B, N, D).to(bf), randn(D, scale=0.5)
        r = int8_case("dense_q8_stats", f"{where} +GELU K={K} N={N}",
                      lambda: dense_q8_residual_stats(h, w, b, res, gamma, "gelu"),
                      lambda: dense_q8_residual_stats_plain(h, w, b, res, gamma, "gelu"),
                      h, w, (b, res, gamma), 2.0 * B * N * K * D, exact=False)
        results.setdefault("dense_q8_stats", r)
    # #11 and #12 at the card tests' edge shapes (not timed): rows not a
    # multiple of the GEMM's 64, D not one of its 256-feature pass, K not a
    # multiple of 16, 32 or 128 (37 not even one of 8)
    for Be, Ne, Ke, De in ((2, 21, 40, 24), (2, 130, 72, 136), (2, 100, 48, 264),
                           (2, 64, 37, 136), (3, 65, 200, 136)):
        for name in ("dense_q8_stats", "dense_cm_q8_stats"):
            cm = name == "dense_cm_q8_stats"
            h = randn(*((Be, Ke, Ne) if cm else (Be, Ne, Ke))).to(bf)
            w, b = linear_t(Ke, De), randn(De, scale=0.1)
            res, gamma = randn(Be, Ne, De).to(bf), randn(De, scale=0.5)
            if cm:
                got = dense_cm_q8_residual_stats(h, w, b, res, gamma)
                want = dense_cm_q8_residual_stats_plain(h, w, b, res, gamma)
            else:
                got = dense_q8_residual_stats(h, w, b, res, gamma, "gelu")
                want = dense_q8_residual_stats_plain(h, w, b, res, gamma, "gelu")
            torch.cuda.synchronize()
            excess = max(max_excess(g_, w_, KERNEL_TOLERANCES[name])
                         for g_, w_ in zip(got, want))
            if not excess <= 0 or (cm and not torch.equal(got[0], want[0])):
                raise AssertionError(f"{name} B={Be} N={Ne} K={Ke} D={De}: kernel "
                                     f"disagrees with its plain version (excess {excess})")
    log("[kernels] dense_q8_stats (+GELU) and dense_cm_q8_stats at 5 edge shapes (N 21-130, "
        "K 37-200, D 24-264): within their tolerances, dense_cm_q8_stats's out bit-equal")
    return results


def build_model() -> DinoUNet:
    pm = PlansManager(PLANS)
    arch = pm.get_configuration("2d").network_arch_init_kwargs
    cfg = DinoUNetConfig.from_plans_arch(arch, N_CLASSES, model_name="dinounet_b")
    return DinoUNet(cfg).init_weights(seed=0).eval()


@contextlib.contextmanager
def route_env(settings: dict):
    """Set the route variables for the block, then restore what was there."""
    saved = {k: os.environ.get(k) for k in settings}
    os.environ.update(settings)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_serve(dev, model: DinoUNet, path: str = "serve") -> dict:
    pm = PlansManager(PLANS)
    predictor = nnUNetPredictor(tile_step_size=0.5, use_mirroring=False,
                                device=dev, tile_batch=TILE_BATCH)
    predictor.manual_initialization(model, pm, pm.get_configuration("2d"), None,
                                    DATASET_JSON, "nnUNetTrainer", None)
    case = np.random.default_rng(0).standard_normal(CASE).astype(np.float32)
    n_tiles, n_batches = 16, 2
    tag = f"[{path}]" if path in ("serve",) + SERVE_7B else f"[serve routes: {path}]"

    shapes = {}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with transpconv_shapes(shapes):
        logits = predictor.predict_logits_from_preprocessed_data(case)
    first_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    log(f"{tag} first case {first_s:.2f} s; launches {counts}")
    per_forward = {**PER_FORWARD, **PER_FORWARD_ROUTE.get(path, {})}
    want = {k: n * n_batches for k, n in per_forward.items()}
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts}, the path makes {want}")
    if sum(shapes.values()) != counts["transpconv2x2_cm"]:
        raise AssertionError(f"{path}: transpconv2x2 C calls {shapes}, launches "
                             f"{counts['transpconv2x2_cm']}")
    if shapes:
        log(f"{tag} transpconv2x2_cm launches per tile-batch forward by shape (Cin -> Cout, "
            "input map, input layout, prologue): " + "; ".join(
                f"{k} x{n // n_batches}" for k, n in sorted(shapes.items())))
    if logits.shape != (N_CLASSES,) + CASE[1:] or logits.dtype != np.float16:
        raise AssertionError(f"{path}: logits {logits.shape} {logits.dtype}")
    if not np.all(np.isfinite(logits)):
        raise AssertionError(f"{path}: non-finite logits")
    log(f"{tag} logits {logits.shape} {logits.dtype}, all finite, "
        f"mean {float(logits.astype(np.float32).mean()):.4f} "
        f"std {float(logits.astype(np.float32).std()):.4f}")

    torch.cuda.reset_peak_memory_stats(dev)
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        predictor.predict_logits_from_preprocessed_data(case)
        rates.append(n_tiles / (time.perf_counter() - t0))
    log(f"{tag} tiles/s over 3 repeats: {', '.join(f'{r:.2f}' for r in rates)} "
        f"(median {sorted(rates)[1]:.2f}; tile batch {TILE_BATCH}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts


@contextlib.contextmanager
def transpconv_shapes(table: dict):
    """Count the transposed conv's kernel launches in the block by shape:
    the library's C entry wrapped by a function that notes (Cin -> Cout,
    H x W, the input's layout, prologue or not) and calls it."""
    lib = _build.lib()
    entry = lib.transpconv2x2

    def noted(x, sxb, sxc, sxh, sxw, *rest):
        ps, B, Cin, H, W, Cout = rest[3], *rest[7:12]
        layout = ("channel-major" if sxw == 1 else "channels-last" if sxc == 1
                  else "strided")
        key = (f"{Cin} -> {Cout}, {H}x{W}, {layout}, "
               f"{'prologue' if ps else 'no prologue'}")
        table[key] = table.get(key, 0) + 1
        return entry(x, sxb, sxc, sxh, sxw, *rest)

    lib.transpconv2x2 = noted
    try:
        yield table
    finally:
        lib.transpconv2x2 = entry


def phase_layer_times(dev, model: DinoUNet, path: str, iters: int = 5) -> dict:
    """CUDA-event times of the layers the routes change (the backbone, the
    six extractors, the SPM, the four LearnableUpsamples, the decoder) per
    tile-batch forward, from forward pre/post hooks, mean of `iters`
    forwards after one warm-up."""
    adapter = model.encoder.dinov3_adapter
    extractors = [ex for blk in adapter.interactions
                  for ex in [blk.extractor, *(blk.extra_extractors or [])]]
    layers = {"backbone": [adapter.backbone], "extractors": extractors,
              "spm": [adapter.spm], "upsample": list(model.encoder.ups),
              "decoder": [model.decoder]}
    events = {name: [] for name in layers}
    handles = []
    for name, mods in layers.items():
        def pre(mod, args, name=name):
            events[name].append([torch.cuda.Event(enable_timing=True), None])
            events[name][-1][0].record()

        def post(mod, args, out, name=name):
            events[name][-1][1] = torch.cuda.Event(enable_timing=True)
            events[name][-1][1].record()
        for m in mods:
            handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post)]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (TILE_BATCH, 1, PATCH, PATCH)).astype(np.float32)).to(dev)
    try:
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            for v in events.values():
                v.clear()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(iters):
                model(x)
            end.record()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    ms = {name: sum(a.elapsed_time(b) for a, b in v) / iters for name, v in events.items()}
    ms["forward"] = start.elapsed_time(end) / iters
    log(f"[layers: {path}] per tile-batch forward ({TILE_BATCH} x {PATCH}^2, CUDA "
        f"events, mean of "
        f"{iters}): " + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items()))
    return ms


def log_int8_cache(model: DinoUNet, tag: str) -> None:
    """The int8 levels and scales kept on the model's weights (quantized
    once, on the first int8 forward) and their device memory."""
    entries = [getattr(p, CACHE_ATTR) for p in model.parameters() if hasattr(p, CACHE_ATTR)]
    log(f"{tag} int8 weights cached on the card: {len(entries)} matrices, "
        f"{sum(_nbytes(wq, ws) for _, (wq, ws) in entries) / 2**20:.1f} MiB")


def cpu_logits(model: DinoUNet, tile):
    """The fp32 logits of `tile` from a CPU copy of `model` (the plain
    versions), under the current environment; and the seconds they took."""
    with torch.inference_mode():
        ref_model = DinoUNet(dataclasses.replace(model.cfg, dtype="float32")).eval()
        ref_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        t0 = time.perf_counter()
        want = ref_model(tile)
    return want, time.perf_counter() - t0


def rel_l2(got, want) -> float:
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want))


def phase_parity(dev, model: DinoUNet):
    """Card bf16 vs CPU fp32 on one tile; returns the tile and the CPU logits
    for the routes' parity checks."""
    tile = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 1, PATCH, PATCH)).astype(np.float32))
    with torch.inference_mode():
        got = model.to(dev)(tile.to(dev)).float().cpu()
    want, cpu_s = cpu_logits(model, tile)
    rel = rel_l2(got, want)
    log(f"[parity] 512x512 tile, card bf16 vs CPU fp32 ({cpu_s:.1f} s): relative "
        f"L2 error {rel:.4e} (bound {PARITY_BOUND}); max abs "
        f"{float((got - want).abs().max()):.4e} of max |ref| "
        f"{float(want.abs().max()):.4e}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"parity {rel} over {PARITY_BOUND}")
    return tile, want


def parity_batch(dev, tile):
    """The parity tile as the first of a tile batch of 8 (the HWBC stages
    need batch 8)."""
    others = np.random.default_rng(2).standard_normal(
        (TILE_BATCH - 1, 1, PATCH, PATCH)).astype(np.float32)
    return torch.cat([tile, torch.from_numpy(others)]).to(dev)


def card_logits(model: DinoUNet, batch):
    with torch.inference_mode():
        return model(batch).float().cpu()


def phase_route_parity(dev, model: DinoUNet, tile, want, path: str,
                       card_stock) -> float:
    """The parity batch on the card with the route on; its first tile
    against `want`, the CPU fp32 logits (of the stock model for a conv
    route, under the route for the others); the batch must launch the
    route's kernels. An int8 route's batch is also held against
    `card_stock`, the stock bf16 logits of the same batch on the card."""
    _build.reset_launch_counts()
    got_batch = card_logits(model, parity_batch(dev, tile))
    counts = _build.launch_counts()
    for k, n in PER_FORWARD_ROUTE[path].items():
        if counts[k] != n:
            raise AssertionError(f"{path} parity batch launched {counts}")
    got = got_batch[:1]
    rel = rel_l2(got, want)
    ref = "plain versions under the route" if path in INT8_ROUTES + OP_ROUTES else "stock"
    log(f"[parity: {path}] 512x512 tile, card bf16 with the route vs CPU fp32 "
        f"{ref}: relative L2 error {rel:.4e} (bound {PARITY_BOUND}); max abs "
        f"{float((got - want).abs().max()):.4e}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"{path} parity {rel} over {PARITY_BOUND}")
    if path in INT8_ROUTES:
        rel8 = rel_l2(got_batch, card_stock)
        agree = float((got_batch.argmax(1) == card_stock.argmax(1)).float().mean())
        log(f"[parity: {path}] the batch of {TILE_BATCH} tiles, card int8 vs card "
            f"bf16 stock: relative L2 {rel8:.4e} (bound {INT8_BF16_BOUND}), argmax "
            f"agreement {agree:.4%} of {card_stock[:, 0].numel()} pixels")
        if not rel8 <= INT8_BF16_BOUND:
            raise AssertionError(f"{path}: int8 vs bf16 {rel8} over {INT8_BF16_BOUND}")
    return rel


def build_model_7b(dev) -> DinoUNet:
    """dinounet_7b at full width and depth (40 SwiGLU blocks) with seeded
    random weights drawn on the card, the backbone's matrices held in bf16;
    the backbone's LayerScale at INT8_LAYERSCALE, so that the backbone's
    residual branches (and the kernels' error in them) reach the logits."""
    pm = PlansManager(PLANS)
    arch = pm.get_configuration("2d").network_arch_init_kwargs
    cfg = DinoUNetConfig.from_plans_arch(arch, N_CLASSES, model_name="dinounet_7b")
    t0 = time.perf_counter()
    model = DinoUNet.random_on(cfg, dev, seed=0).eval()
    backbone = model.encoder.dinov3_adapter.backbone
    with torch.no_grad():
        for blk in backbone.blocks:
            blk.ls1.gamma.fill_(INT8_LAYERSCALE)
            blk.ls2.gamma.fill_(INT8_LAYERSCALE)
    torch.cuda.synchronize()
    n_bb = sum(p.numel() for p in backbone.parameters())
    n_all = sum(p.numel() for p in model.parameters())
    log(f"[serve_7b] dinounet_7b built on the card in {time.perf_counter() - t0:.1f} s: "
        f"backbone {n_bb / 1e9:.3f}e9 parameters ({_nbytes(*backbone.parameters()) / 2**30:.2f} "
        f"GiB, matrices bf16), adapter + FAPM + decoder {(n_all - n_bb) / 1e6:.1f}e6 "
        f"(fp32); {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated")
    return model


# kernel-name substrings of each device-time family of a forward, first match
# wins (cuDNN's implicit-GEMM convs before the GEMMs; cuBLAS's Hopper GEMMs
# are named nvjet_*)
FAMILIES = (("port attention", ("rope_attention", "rope_prep")),
            ("port MSDA", ("msda_fwd",)),
            ("port convs", ("conv3x3_kernel", "transpconv2x2_kernel", "seg_head")),
            ("port dense + stats", ("dense_stats_kernel", "gelu_prepass")),
            ("cuDNN conv", ("fprop", "cudnn", "conv2d", "convolve", "xmma")),
            ("cuBLAS GEMM", ("nvjet", "gemm", "cutlass")),
            ("elementwise + reductions", ("elementwise", "reduce", "Reduce")),
            ("copies", ("copy", "Copy", "Memcpy", "Memset")))


def phase_profile(dev, model: DinoUNet, path: str) -> None:
    """Device time of one tile-batch forward by kernel family
    (torch.profiler, after a warm-up) against the forward's CUDA-event time
    taken outside the profiler: the device's busy and idle shares."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (TILE_BATCH, 1, PATCH, PATCH)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        model(x)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        model(x)
        end.record()
        torch.cuda.synchronize()
        wall = start.elapsed_time(end)
        times = device_times(lambda: model(x), iters=1)
    parts = {name: 0.0 for name, _ in FAMILIES}
    parts["other"] = 0.0
    for kernel, ms in times.items():
        family = next((name for name, keys in FAMILIES
                       if any(k in kernel for k in keys)), "other")
        parts[family] += ms
    busy = sum(parts.values())
    log(f"[profile: {path}] one tile-batch forward: {wall:.3f} ms by CUDA events; "
        f"device busy {busy:.3f} ms ({busy / wall:.1%}, idle {1 - busy / wall:.1%}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))


def phase_serve_7b(dev, model: DinoUNet, tile) -> tuple:
    """The 7B served (launch counts, logits, tiles/s, layer times), then the
    parity batch in bf16 and with the int8 mode on: int8 vs bf16 relative
    L2 and argmax agreement. Returns the counts of both paths and the bf16
    logits of the parity tile."""
    counts = {"serve_7b": phase_serve(dev, model, "serve_7b")}
    phase_layer_times(dev, model, "serve_7b", iters=3)
    phase_profile(dev, model, "serve_7b")
    batch = parity_batch(dev, tile)
    card_bf16 = card_logits(model, batch)
    with route_env(ROUTES["serve_int8"]):
        counts["serve_7b_int8"] = phase_serve(dev, model, "serve_7b_int8")
        log_int8_cache(model, "[serve_7b_int8]")
        phase_layer_times(dev, model, "serve_7b_int8", iters=3)
        card_int8 = card_logits(model, batch)
    rel8 = rel_l2(card_int8, card_bf16)
    agree = float((card_int8.argmax(1) == card_bf16.argmax(1)).float().mean())
    log(f"[parity: serve_7b_int8] the batch of {TILE_BATCH} tiles, card int8 vs card "
        f"bf16: relative L2 {rel8:.4e} (bound {INT8_BF16_BOUND}), argmax agreement "
        f"{agree:.4%} of {card_bf16[:, 0].numel()} pixels")
    if not rel8 <= INT8_BF16_BOUND:
        raise AssertionError(f"serve_7b_int8: int8 vs bf16 {rel8} over {INT8_BF16_BOUND}")
    return counts, card_bf16[:1]


@contextlib.contextmanager
def plain_versions():
    """The kernel ops the 7B path calls swapped for their plain versions,
    which run on any device: the fp32 reference of the 7B parity tile runs
    on the card (the wrappers take only bf16 there)."""
    import dinounet_tpu_torch.models.adapter as adapter_mod
    import dinounet_tpu_torch.models.vit as vit_mod

    def attention(qkv, sin, cos):
        return rope_attention_plain(qkv, *rope_tables(sin, cos, qkv.shape[1],
                                                      qkv.shape[4], qkv.device))

    def dense_rm(h, w, b, res, gamma, apply_gelu=False):
        return dense_residual_stats_plain(h, w, b, res, gamma, apply_gelu)

    swaps = {(vit_mod, "fused_rope_attention"): attention,
             (adapter_mod, "ms_deform_attn_premapped_fused"):
                 ms_deform_attn_premapped_fused_plain,
             (adapter_mod, "dense_cm_residual_stats"): dense_cm_residual_stats_plain,
             (adapter_mod, "dense_residual_stats"): dense_rm}
    saved = {key: getattr(*key) for key in swaps}
    for (mod, name), fn in swaps.items():
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def phase_parity_7b(dev, cfg: DinoUNetConfig, state: dict, tile, got) -> float:
    """The parity tile's card bf16 logits `got` (the kernels) against the
    same weights (`state`, on the host) in fp32 on the card with the plain
    versions, TF32 off."""
    t0 = time.perf_counter()
    with torch.device(dev):
        ref = DinoUNet(dataclasses.replace(cfg, dtype="float32")).eval()
    ref.load_state_dict(state)
    build_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    with plain_versions(), torch.inference_mode():
        t0 = time.perf_counter()
        want = ref(tile.to(dev)).float().cpu()
        fwd_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"the plain 7B reference launched kernels: {counts}")
    rel = rel_l2(got, want)
    log(f"[parity: serve_7b] 512x512 tile, card bf16 (kernels) vs card fp32 (plain "
        f"versions, TF32 off; built in {build_s:.1f} s, forward {fwd_s:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB): relative L2 error "
        f"{rel:.4e} (bound {PARITY_7B_BOUND}); max abs {float((got - want).abs().max()):.4e} "
        f"of max |ref| {float(want.abs().max()):.4e}")
    if not rel <= PARITY_7B_BOUND:
        raise AssertionError(f"7B parity {rel} over {PARITY_7B_BOUND}")
    return rel


def _train_env(root: str) -> None:
    for sub in ("preprocessed", "results"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    os.environ["nnUNet_preprocessed"] = os.path.join(root, "preprocessed")
    os.environ["nnUNet_results"] = os.path.join(root, "results")
    write_disk_ring_dataset(os.environ["nnUNet_preprocessed"], TRAIN_DATASET, 6,
                            (640, 640), (PATCH, PATCH), 2, ARCH, seed=0)


def _trainer(dev):
    trainer = get_trainer_from_args(TRAIN_DATASET, "2d", 0, "DinoUNetTrainer_b",
                                    device=dev)
    trainer.seed = 0
    trainer.num_epochs = TRAIN_EPOCHS
    trainer.num_iterations_per_epoch = TRAIN_ITERS
    trainer.num_val_iterations_per_epoch = VAL_ITERS
    return trainer


def phase_train(dev) -> dict:
    trainer = _trainer(dev)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    trainer.run_training()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    counts = _build.launch_counts()
    n_steps = TRAIN_EPOCHS * TRAIN_ITERS
    n_val = TRAIN_EPOCHS * VAL_ITERS
    want = {k: n_steps * PER_TRAIN_STEP[k] + n_val * PER_FORWARD[k] for k in PER_FORWARD}
    log(f"[train] run_training: {TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps + "
        f"{VAL_ITERS} validation batches in {run_s:.1f} s; launches {counts}")
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, the path makes {want}")
    logged = trainer.logger.my_fantastic_logging
    losses = logged["train_losses"] + logged["val_losses"]
    log(f"[train] train losses {logged['train_losses']}, val losses "
        f"{logged['val_losses']}, pseudo dice {logged['dice_per_class_or_region']}")
    if len(losses) != 2 * TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"logged losses {losses}")

    final = os.path.join(trainer.output_folder, "checkpoint_final.pth")
    if not os.path.isfile(final):
        raise AssertionError("no checkpoint_final.pth")
    fresh = _trainer(dev)
    fresh.load_checkpoint(final)
    trained = trainer.network.state_dict()
    for name, t in fresh.network.state_dict().items():
        if not torch.equal(t, trained[name]):
            raise AssertionError(f"checkpoint_final.pth restores {name} differently")
    if fresh.current_epoch != TRAIN_EPOCHS:
        raise AssertionError(f"resumed at epoch {fresh.current_epoch}")
    log(f"[train] checkpoint_final.pth ({os.path.getsize(final) / 2**20:.0f} MiB) "
        f"loaded into a fresh trainer: {len(trained)} tensors equal")
    del fresh

    _build.reset_launch_counts()
    trainer.train_step_host(trainer.dataloader_train.generate_train_batch())
    torch.cuda.synchronize()
    one = _build.launch_counts()
    if one != PER_TRAIN_STEP:
        raise AssertionError(f"one train step launched {one}, the path makes "
                             f"{PER_TRAIN_STEP}")

    torch.cuda.reset_peak_memory_stats(dev)
    step_losses, step_ms, load_ms = [], [], []
    for _ in range(LEARN_STEPS):
        t0 = time.perf_counter()
        batch = trainer.dataloader_train.generate_train_batch()
        t1 = time.perf_counter()
        step_losses.append(float(trainer.train_step_host(batch)))  # synchronises
        step_ms.append((time.perf_counter() - t1) * 1e3)
        load_ms.append((t1 - t0) * 1e3)
    first, last = float(np.mean(step_losses[:10])), float(np.mean(step_losses[-10:]))
    med = float(np.median(step_ms))
    log(f"[train] {LEARN_STEPS} more steps: mean loss of the first 10 {first:.4f}, "
        f"of the last 10 {last:.4f} (margin {first - last:.4f}); step "
        f"{med:.1f} ms median ({1e3 / med:.2f} steps/s, batch 2 x {PATCH}^2, "
        f"augmentation included; the host loader, which run_training overlaps "
        f"in a thread, {float(np.median(load_ms)):.1f} ms a batch); peak device "
        f"memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    if not np.all(np.isfinite(step_losses)) or not last < first:
        raise AssertionError(f"the loss did not fall: {step_losses}")
    for k, n in one.items():
        counts[k] += n
    return counts


def phase_train_steps(dev, trainer_name: str, path: str, per_step: dict) -> dict:
    """A fresh trainer on the synthetic dataset under the current
    environment: ROUTE_STEPS train steps after its set-up, finite losses,
    the launches of the steps (`per_step` each). Step time for
    information."""
    trainer = get_trainer_from_args(TRAIN_DATASET, "2d", 0, trainer_name, device=dev)
    trainer.seed = 0
    t0 = time.perf_counter()
    trainer.on_train_start()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(ROUTE_STEPS):
        batch = trainer.dataloader_train.generate_train_batch()
        t1 = time.perf_counter()
        losses.append(float(trainer.train_step_host(batch)))  # synchronises
        step_ms.append((time.perf_counter() - t1) * 1e3)
    counts = _build.launch_counts()
    want = {k: ROUTE_STEPS * n for k, n in per_step.items()}
    log(f"[{path}] {trainer_name}: set-up {setup_s:.1f} s, {ROUTE_STEPS} steps of batch "
        f"2 x {PATCH}^2, losses {[round(x, 4) for x in losses]}; step ms "
        f"{', '.join(f'{t:.1f}' for t in step_ms)} (median of the last "
        f"{ROUTE_STEPS - 1} {float(np.median(step_ms[1:])):.1f}); peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; launches {counts}")
    if counts != want:
        raise AssertionError(f"{path}: kernel launches {counts}, the steps make {want}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{path}: losses {losses}")
    return counts


def phase_train_parity(dev) -> None:
    pm = PlansManager(PLANS)
    arch = pm.get_configuration("2d").network_arch_init_kwargs
    cfg = DinoUNetConfig.from_plans_arch(arch, N_CLASSES, model_name="dinounet_b",
                                         drop_path_rate=0.0)
    card = DinoUNet(cfg).init_weights(seed=1).train()
    ref = DinoUNet(dataclasses.replace(cfg, dtype="float32")).train()
    ref.load_state_dict(card.state_dict())
    card.to(dev)
    img, seg = disk_ring_case(np.random.default_rng(2), 256, 256)
    x = torch.from_numpy(img)  # (1, 1, 256, 256)
    y = torch.from_numpy(seg[:, 0]).long()  # (1, 256, 256)

    def step(model, x, y):
        loss = dc_and_ce_loss(model(x), y, batch_dice=True, smooth=1e-5, do_bg=False)
        loss.backward()
        grads = {n: p.grad.float().flatten().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        return float(loss.detach()), grads

    def rel_l2(got, want, names):
        g = torch.cat([got[n] for n in names])
        w = torch.cat([want[n] for n in names])
        return float(torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w))

    backbone_before = [p.detach().clone() for p in
                       card.encoder.dinov3_adapter.backbone.parameters()]
    got_loss, got = step(card, x.to(dev), y.to(dev))
    t0 = time.perf_counter()
    want_loss, want = step(ref, x, y)
    cpu_s = time.perf_counter() - t0
    if got.keys() != want.keys():
        raise AssertionError("card and CPU steps give gradients to different parameters")
    names = sorted(want)
    # the projections in front of the MSDA kernels: their gradients are the
    # ones the MSDA backward kernel produces (checked on their own, since
    # they are a small part of the whole gradient's norm)
    msda = [n for n in names if ".attn." in n and "dinov3_adapter.interactions" in n]
    rel, rel_msda = rel_l2(got, want, names), rel_l2(got, want, msda)
    loss_rel = abs(got_loss - want_loss) / abs(want_loss)
    log(f"[train parity] 256x256 step, card bf16 vs CPU fp32 ({cpu_s:.1f} s): loss "
        f"{got_loss:.5f} vs {want_loss:.5f} (rel {loss_rel:.3e}, bound "
        f"{TRAIN_LOSS_BOUND}); relative L2 of the {len(names)} trainable gradient "
        f"tensors {rel:.4e} (bound {TRAIN_GRAD_BOUND}), of the {len(msda)} MSDA "
        f"projections' {rel_msda:.4e} (bound {TRAIN_MSDA_GRAD_BOUND})")
    if not (rel <= TRAIN_GRAD_BOUND and rel_msda <= TRAIN_MSDA_GRAD_BOUND
            and loss_rel <= TRAIN_LOSS_BOUND):
        raise AssertionError(f"train parity: gradients {rel}, MSDA projections "
                             f"{rel_msda}, loss {loss_rel}")
    opt = sgd_nesterov([p for p in card.parameters() if p.requires_grad], 1e-2, 3e-5)
    clip_and_step(opt, 12.0)
    torch.cuda.synchronize()
    backbone = list(card.encoder.dinov3_adapter.backbone.parameters())
    if not all(torch.equal(a, b) for a, b in zip(backbone_before, backbone)):
        raise AssertionError("the optimizer step changed a backbone parameter")
    log(f"[train parity] an optimizer step left all {len(backbone)} backbone "
        "tensors unchanged")


def raw_tiles() -> int:
    """Tiles of one preprocessed case: the slice resampled to PLANS_SPACING,
    padded to a multiple of half the patch, tiled at step 0.5."""
    side = round(RAW_SIZE * RAW_SPACING / PLANS_SPACING)
    padded = -(-max(side, PATCH) // (PATCH // 2)) * (PATCH // 2)
    steps = -(-(padded - PATCH) // (PATCH // 2)) + 1
    return steps * steps


@contextlib.contextmanager
def shortened_training(trainer_cls, built=None):
    """run.run_training builds its trainer itself: within the block,
    `trainer_cls` trains TRAIN_EPOCHS epochs of TRAIN_ITERS steps and
    VAL_ITERS validation batches, from seed 0; each trainer built is
    appended to `built` where it is a list."""
    had_own = "__init__" in vars(trainer_cls)
    init = trainer_cls.__init__

    def short_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        if built is not None:
            built.append(self)
        self.seed = 0
        self.num_epochs = TRAIN_EPOCHS
        self.num_iterations_per_epoch = TRAIN_ITERS
        self.num_val_iterations_per_epoch = VAL_ITERS

    trainer_cls.__init__ = short_init
    try:
        yield
    finally:
        if had_own:
            trainer_cls.__init__ = init
        else:
            del trainer_cls.__init__


@contextlib.contextmanager
def timed_calls(table: dict, more=()):
    """Seconds of each call, by stage, within the block: preprocessing a
    case (DefaultPreprocessor.run_case), its prediction on the device
    (predict_logits_from_preprocessed_data, which ends in the copy of the
    logits to the host), its export, the trainer's final validation, and
    the (owner, attribute, stage) triples of `more`."""
    patched = [(DefaultPreprocessor, "run_case", "preprocess"),
               (nnUNetPredictor, "predict_logits_from_preprocessed_data", "predict"),
               (export_module, "export_prediction_from_logits", "export"),
               (predictor_module, "export_prediction_from_logits", "export"),
               (nnUNetTrainer, "perform_actual_validation", "validation"), *more]
    saved = [getattr(owner, name) for owner, name, _ in patched]

    def timed(fn, stage):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            table.setdefault(stage, []).append(time.perf_counter() - t0)
            return out
        return call

    for (owner, name, stage), fn in zip(patched, saved):
        setattr(owner, name, timed(fn, stage))
    try:
        yield
    finally:
        for (owner, name, _), fn in zip(patched, saved):
            setattr(owner, name, fn)


def check_segmentation_file(out_file: str, raw_file: str) -> None:
    """A predicted segmentation has its raw image's shape, spacing and
    origin (the whole NIfTI affine) and labels within {0, 1, 2}."""
    seg, seg_props = NiftiIO().read_seg(out_file)
    img, img_props = NiftiIO().read_images([raw_file])
    if seg.shape != img.shape or seg_props["spacing"] != img_props["spacing"]:
        raise AssertionError(f"{out_file}: {seg.shape} at {seg_props['spacing']}, the raw "
                             f"image {img.shape} at {img_props['spacing']}")
    if not np.array_equal(read_nifti(out_file)[1]["affine"], read_nifti(raw_file)[1]["affine"]):
        raise AssertionError(f"{out_file}: its affine differs from {raw_file}'s")
    if not set(np.unique(seg).tolist()) <= {0, 1, 2}:
        raise AssertionError(f"{out_file}: labels {np.unique(seg)}")


def _per_case(times) -> str:
    return f"{float(np.median(times)):.3f} s a case (median of {len(times)})"


def phase_pipeline(dev, root: str) -> dict:
    for sub in ("raw", "preprocessed", "results"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        os.environ["nnUNet_" + sub] = os.path.join(root, sub)
    raw = write_disk_ring_raw_dataset(
        os.environ["nnUNet_raw"], os.environ["nnUNet_preprocessed"], RAW_DATASET,
        RAW_TRAIN, RAW_TEST, (RAW_SIZE, RAW_SIZE), RAW_SPACING, PLANS_SPACING,
        (PATCH, PATCH), 2, ARCH, seed=0)
    tiles = raw_tiles()
    batches = -(-tiles // TILE_BATCH)
    times = {}

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with timed_calls(times):
        preprocess_dataset(RAW_DATASET, configurations=["2d"], num_processes=[4])
        prep_s = time.perf_counter() - t0
        prep_times = times.pop("preprocess")
        with shortened_training(DinoUNetTrainer_b):
            trainer = run_training(RAW_DATASET, "2d", 0, "DinoUNetTrainer_b", device=dev)
        torch.cuda.synchronize()
        val_times = {k: times.pop(k) for k in list(times)}

        _, val_keys = trainer.do_split()
        if len(val_keys) != RAW_VAL:
            raise AssertionError(f"fold 0 validates {val_keys}")
        val_folder = os.path.join(trainer.output_folder, "validation")
        for k in val_keys:
            check_segmentation_file(os.path.join(val_folder, k + ".nii.gz"),
                                    os.path.join(raw, "imagesTr", k + "_0000.nii.gz"))
        with open(os.path.join(val_folder, "summary.json")) as f:
            dice = json.load(f)["foreground_mean"]["Dice"]
        if not np.isfinite(dice):
            raise AssertionError(f"summary.json: foreground mean Dice {dice}")
        model_folder = trainer.output_folder_base
        del trainer
        torch.cuda.empty_cache()

        predictor = nnUNetPredictor(device=dev)
        predictor.initialize_from_trained_model_folder(model_folder, use_folds=(0,))
        out = os.path.join(root, "predicted")
        t0 = time.perf_counter()
        written = predictor.predict_from_files(os.path.join(raw, "imagesTs"), out,
                                               save_probabilities=True)
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        if len(written) != RAW_TEST:
            raise AssertionError(f"predict_from_files wrote {written}")
        for ofile in written:
            check_segmentation_file(ofile + ".nii.gz", os.path.join(
                raw, "imagesTs", os.path.basename(ofile) + "_0000.nii.gz"))
        test_times = {k: times.pop(k) for k in list(times)}

        # the parity case, without mirroring
        case = os.path.join(raw, "imagesTs", f"case_{RAW_TRAIN:03d}_0000.nii.gz")
        predictor.use_mirroring = False
        predictor.predict_from_files([[case]], os.path.join(root, "parity"),
                                     save_probabilities=True)
    counts = _build.launch_counts()

    n_forwards = (TRAIN_EPOCHS * VAL_ITERS + (RAW_VAL + RAW_TEST) * batches * MIRRORS
                  + batches)
    want = {k: TRAIN_EPOCHS * TRAIN_ITERS * PER_TRAIN_STEP[k] + n_forwards * PER_FORWARD[k]
            for k in PER_FORWARD}
    log(f"[pipeline] {RAW_TRAIN} + {RAW_TEST} raw cases of {RAW_SIZE}^2 at {RAW_SPACING} mm "
        f"-> {tiles} tiles of {PATCH}^2 a case ({batches} tile batch of {TILE_BATCH}); "
        f"run_training: {TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps, {RAW_VAL} validation "
        f"cases x {MIRRORS} mirrors; {RAW_TEST} test cases x {MIRRORS} mirrors; 1 parity "
        f"case; launches {counts}")
    if counts != want:
        raise AssertionError(f"pipeline: kernel launches {counts}, the path makes {want}")

    p_card = np.load(os.path.join(root, "parity", f"case_{RAW_TRAIN:03d}.npz"))["probabilities"]
    cpu = nnUNetPredictor(use_mirroring=False, device="cpu", tile_batch=tiles)
    cpu.initialize_from_trained_model_folder(model_folder, use_folds=(0,))
    cpu.network = DinoUNet(dataclasses.replace(cpu.network.cfg, dtype="float32")).eval()
    image, props = NiftiIO().read_images([case])
    t0 = time.perf_counter()
    seg_cpu, p_cpu = cpu.predict_single_npy_array(image, props, None, None, True)
    cpu_s = time.perf_counter() - t0
    seg_card = NiftiIO().read_seg(os.path.join(root, "parity",
                                               f"case_{RAW_TRAIN:03d}.nii.gz"))[0][0]
    if p_card.shape != p_cpu.shape or p_card.shape != (N_CLASSES, 1, RAW_SIZE, RAW_SIZE):
        raise AssertionError(f"probabilities {p_card.shape} on the card, {p_cpu.shape} "
                             "on the CPU")
    rel = rel_l2(torch.from_numpy(p_card.astype(np.float32)),
                 torch.from_numpy(p_cpu.astype(np.float32)))
    agree = float(np.mean(seg_card == seg_cpu))
    log(f"[pipeline] validation: foreground mean Dice {dice:.4f} (summary.json); parity "
        f"case_{RAW_TRAIN:03d}, exported probabilities, card bf16 vs CPU fp32 "
        f"predict_single_npy_array ({cpu_s:.1f} s), no mirroring: relative L2 {rel:.4e} "
        f"(bound {PARITY_BOUND}), labels agree on {100 * agree:.3f} % of the pixels")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"pipeline parity {rel} over {PARITY_BOUND}")
    log(f"[pipeline] {card_line()}: preprocess_dataset {prep_s:.2f} s for {RAW_TRAIN} "
        f"cases (run_case {_per_case(prep_times)}, 4 threads); final validation "
        f"{val_times['validation'][0]:.2f} s for {RAW_VAL} cases (prediction on the "
        f"device {_per_case(val_times['predict'])}, export {_per_case(val_times['export'])}"
        f"); predict_from_files {predict_s:.2f} s for {RAW_TEST} cases, "
        f"{RAW_TEST / predict_s:.3f} cases/s (preprocessing "
        f"{_per_case(test_times['preprocess'])}, prediction on the device "
        f"{_per_case(test_times['predict'])}, export {_per_case(test_times['export'])})")
    return counts


def _same_json(a, b) -> bool:
    """Equality of JSON-like trees, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def phase_api(dev, root: str) -> dict:
    for sub in ("raw", "preprocessed", "results"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        os.environ["nnUNet_" + sub] = os.path.join(root, sub)
    write_disk_ring_png_dataset(os.environ["nnUNet_raw"], API_DATASET, API_CASES,
                                (RAW_SIZE, RAW_SIZE), seed=1)
    times, built, written = {}, [], {}
    evaluate = dinounet_training_torch.evaluate

    def evaluate_after_reading(dataset_id, result_folder):
        written["summary"] = load_summary_json(
            os.path.join(result_folder, "validation", "summary.json"))
        t0 = time.perf_counter()
        out = evaluate(dataset_id=dataset_id, result_folder=result_folder)
        times["evaluate"] = [time.perf_counter() - t0]
        return out

    stages = [(api, "extract_fingerprints", "fingerprint"), (api, "plan_experiments", "plan"),
              (api, "preprocess", "preprocess_dataset"),
              (nnUNetTrainer, "run_training", "training")]
    dinounet_training_torch.evaluate = evaluate_after_reading
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    try:
        with timed_calls(times, stages), shortened_training(DinoUNetTrainer_b, built):
            t0 = time.perf_counter()
            result_folder, training_log, results = dinounet_training_torch.main_dinov3(
                model_name="dinounet_b", dataset_id=API_DATASET_ID,
                num_epochs=TRAIN_EPOCHS, device=dev)
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
    finally:
        dinounet_training_torch.evaluate = evaluate
    counts = _build.launch_counts()
    injected = DinoUNetTrainer._network_config

    pre = os.path.join(os.environ["nnUNet_preprocessed"], API_DATASET)
    for name in ("dataset_fingerprint.json", "nnUNetPlans.json"):
        if not os.path.isfile(os.path.join(pre, name)):
            raise AssertionError(f"api: no {name} in {pre}")
    with open(os.path.join(pre, "nnUNetPlans.json")) as f:
        plan = json.load(f)["configurations"]["2d"]
    arch = plan["architecture"]["arch_kwargs"]
    if plan["patch_size"] != [PATCH, PATCH] or arch["n_stages"] != 4:
        raise AssertionError(f"api: the 2d plans have patch {plan['patch_size']} and "
                             f"{arch['n_stages']} stages")
    if len(built) != 1:
        raise AssertionError(f"api: {len(built)} DinoUNetTrainer_b built")
    trainer = built[0]
    want_cfg = DinoUNetConfig.from_plans_arch(injected["architecture"], N_CLASSES,
                                              model_name="dinounet_b",
                                              deep_supervision=False)
    if (DinoUNetTrainer._dinov3_model_name != "dinounet_b" or trainer.network.cfg != want_cfg
            or injected["architecture"]["features_per_stage"] != list(
                arch["features_per_stage"])):
        raise AssertionError(f"api: the trained network's configuration "
                             f"{trainer.network.cfg} is not the injected {injected} "
                             f"({DinoUNetTrainer._dinov3_model_name})")
    losses = training_log["train_losses"] + training_log["val_losses"]
    if len(losses) != 2 * TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"api: logged losses {losses}")
    if not os.path.isfile(os.path.join(result_folder, "checkpoint_final.pth")):
        raise AssertionError("api: no checkpoint_final.pth")
    dice = written["summary"]["foreground_mean"]["Dice"]
    if not np.isfinite(dice):
        raise AssertionError(f"api: summary.json's foreground mean Dice {dice}")
    if not _same_json(results, written["summary"]):
        raise AssertionError("api: evaluate returned another summary than the "
                             "trainer's validation wrote")
    _, val_keys = trainer.do_split()
    if len(val_keys) != API_VAL:
        raise AssertionError(f"api: fold 0 validates {val_keys}")
    n_forwards = TRAIN_EPOCHS * VAL_ITERS + API_VAL * MIRRORS  # one tile a case
    want = {k: TRAIN_EPOCHS * TRAIN_ITERS * PER_TRAIN_STEP[k] + n_forwards * PER_FORWARD[k]
            for k in PER_FORWARD}
    log(f"[api] main_dinov3('dinounet_b') on {API_CASES} raw PNG cases of {RAW_SIZE}^2: "
        f"plans' 2d batch size {plan['batch_size']}, patch {plan['patch_size']}, "
        f"{arch['n_stages']} stages, features {arch['features_per_stage']}; "
        f"{TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps, {API_VAL} validation cases x "
        f"{MIRRORS} mirrors; losses {[round(x, 4) for x in losses]}; foreground mean "
        f"Dice {dice:.4f}; launches {counts}")
    if counts != want:
        raise AssertionError(f"api: kernel launches {counts}, the path makes {want}")
    stage_s = {k: sum(v) for k, v in times.items()}
    log(f"[api] {card_line()}: main_dinov3 {total_s:.2f} s: fingerprint "
        f"{stage_s['fingerprint']:.2f} s, plan {stage_s['plan']:.2f} s, preprocess "
        f"{stage_s['preprocess_dataset']:.2f} s ({API_CASES} cases), training "
        f"{stage_s['training']:.2f} s (set-up and {TRAIN_EPOCHS * TRAIN_ITERS} steps), "
        f"final validation {stage_s['validation']:.2f} s ({API_VAL} cases), evaluate "
        f"{stage_s['evaluate']:.2f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    return counts


def anon_rss() -> tuple:
    """Anonymous resident memory in bytes and where it was read: the
    process's RssAnon (/proc/self/status), else the machine's AnonPages
    (/proc/meminfo), where a sandboxed kernel reports no per-process split
    and the machine runs this process alone. Pages mapped from a file (an
    mmapped checkpoint) are in neither."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon:"):
                return int(line.split()[1]) * 1024, "RssAnon"
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("AnonPages:"):
                return int(line.split()[1]) * 1024, "AnonPages"
    raise RuntimeError("neither RssAnon in /proc/self/status nor AnonPages in "
                       "/proc/meminfo: no measure of anonymous memory here")


def anon_sees(nbytes: int = 2**30) -> float:
    """The growth of `anon_rss` while `nbytes` of host memory are written
    (a measure that cannot see them would pass any bound)."""
    before = anon_rss()[0]
    block = torch.ones(nbytes // 4)
    grown = anon_rss()[0] - before
    del block
    return grown / nbytes


def published_backbone(model_name: str, dtype, dev, seed: int) -> dict:
    """Seeded tensors on the card in the published checkpoint's layout (the
    manifest's keys and shapes, the ignored keys included): matrices
    N(0, 1 / fan in), norm scales 1 + N(0, 0.01), other vectors and the
    LayerScale N(0, 0.01), bias_mask 1 / 0 / 1 over q / k / v."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for name, shape in checkpoint_manifest(model_name).items():
        if name.endswith("bias_mask"):
            t = torch.ones(shape, device=dev)
            t[shape[0] // 3:2 * shape[0] // 3] = 0
        elif len(shape) >= 2 and name not in ("cls_token", "storage_tokens", "mask_token"):
            t = torch.randn(shape, generator=g, device=dev) / float(np.sqrt(np.prod(shape[1:])))
        elif name in ("norm.weight",) or name.endswith((".norm1.weight", ".norm2.weight")):
            t = 1.0 + 0.1 * torch.randn(shape, generator=g, device=dev)
        else:
            t = 0.1 * torch.randn(shape, generator=g, device=dev)
        out[name] = t.to(dtype)
    return out


def loaded_as_file(backbone, sd: dict) -> int:
    """Every tensor of `backbone` equal to the file's `sd` (on any device),
    the qkv bias times its bias_mask, converted to the parameter's dtype;
    returns the count."""
    state = backbone.state_dict()
    for name, t in state.items():
        want = sd[name]
        if name.endswith("attn.qkv.bias"):
            want = want * sd[name + "_mask"]
        if not torch.equal(t, want.to(t.device, t.dtype)):
            raise AssertionError(f"backbone {name} differs from the file's")
    return len(state)


@contextlib.contextmanager
def injected(trainer_cls, config: dict, path: str, model_name: str):
    """set_network_config(config, path, model_name) on `trainer_cls` for the
    block; every DinoUNet trainer's class-level injection put back after."""
    classes, todo = [], [DinoUNetTrainer]
    while todo:
        cls = todo.pop()
        classes.append(cls)
        todo.extend(cls.__subclasses__())
    names = ("_network_config", "_dinov3_model_name", "_dinov3_pretrained_path")
    saved = [(cls, {a: vars(cls)[a] for a in names if a in vars(cls)}) for cls in classes]
    trainer_cls.set_network_config(config, dinov3_pretrained_path=path,
                                   dinov3_model_name=model_name)
    try:
        yield
    finally:
        for cls, attrs in saved:
            for a in names:
                if a in attrs:
                    setattr(cls, a, attrs[a])
                elif a in vars(cls):
                    delattr(cls, a)


@contextlib.contextmanager
def measured_loads(table: dict):
    """Seconds and anonymous-memory growth of each backbone load the DinoUNet
    trainers make within the block (``load_dinov3_backbone_``)."""
    load = dinounet_trainer_module.load_dinov3_backbone_

    def measured(*args, **kwargs):
        anon0, source = anon_rss()
        t0 = time.perf_counter()
        out = load(*args, **kwargs)
        torch.cuda.synchronize()
        table.setdefault("load", []).append(
            (time.perf_counter() - t0, anon_rss()[0] - anon0, source))
        return out

    dinounet_trainer_module.load_dinov3_backbone_ = measured
    try:
        yield
    finally:
        dinounet_trainer_module.load_dinov3_backbone_ = load


def phase_pretrained(dev, root: str) -> dict:
    path = os.path.join(root, "dinov3_vitb16_pretrain.pth")
    sd = published_backbone("dinov3_vitb16", torch.float32, dev, seed=3)
    torch.save(sd, path)
    loads = {}
    with injected(DinoUNetTrainer_b, DinoUNetTrainer._network_config, path, "dinounet_b"), \
            measured_loads(loads):
        trainer = get_trainer_from_args(API_DATASET, "2d", 0, "DinoUNetTrainer_b", device=dev)
        trainer.seed = 0
        trainer.on_train_start()
    with open(trainer.log_file) as f:
        if f"Loaded DINOv3 backbone weights from {path}" not in f.read():
            raise AssertionError("pretrained: the trainer did not log the load")
    backbone = trainer.network.encoder.dinov3_adapter.backbone
    n = loaded_as_file(backbone, sd)
    load_s, _, _ = loads["load"][0]

    _build.reset_launch_counts()
    losses = [float(trainer.train_step_host(trainer.dataloader_train.generate_train_batch()))
              for _ in range(ROUTE_STEPS)]
    loaded_as_file(backbone, sd)
    model = trainer.network.eval()
    tile = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 1, PATCH, PATCH)).astype(np.float32))
    with torch.inference_mode():
        got = model(tile.to(dev)).float().cpu()
    counts = _build.launch_counts()
    want_counts = {k: ROUTE_STEPS * PER_TRAIN_STEP[k] + PER_FORWARD[k] for k in PER_FORWARD}
    want, cpu_s = cpu_logits(model, tile)
    rel = rel_l2(got, want)
    log(f"[pretrained] DinoUNetTrainer_b pointed at a synthetic published-layout "
        f"dinov3_vitb16 .pth ({os.path.getsize(path) / 2**20:.0f} MiB, fp32, bias_mask "
        f"1/0/1) by set_network_config: loaded in {load_s:.2f} s, all {n} backbone tensors "
        f"equal to the file's (k bias zeroed), and again after {ROUTE_STEPS} train steps "
        f"(losses {[round(x, 4) for x in losses]}); serve forward of the loaded model, "
        f"{PATCH}x{PATCH} tile, card bf16 vs CPU fp32 ({cpu_s:.1f} s): relative L2 {rel:.4e} "
        f"(bound {PARITY_BOUND}); launches {counts}")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"pretrained: losses {losses}")
    if counts != want_counts:
        raise AssertionError(f"pretrained: kernel launches {counts}, the path makes "
                             f"{want_counts}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"pretrained parity {rel} over {PARITY_BOUND}")
    return counts


def phase_regions(dev, root: str) -> dict:
    folder = write_disk_ring_png_dataset(os.environ["nnUNet_raw"], REGIONS_DATASET,
                                         API_CASES, (RAW_SIZE, RAW_SIZE), seed=2)
    with open(os.path.join(folder, "dataset.json")) as f:
        dataset_json = json.load(f)
    dataset_json["labels"] = REGION_LABELS
    dataset_json["regions_class_order"] = REGIONS_CLASS_ORDER
    with open(os.path.join(folder, "dataset.json"), "w") as f:
        json.dump(dataset_json, f, indent=2)
    _, configs = api.plan_and_preprocess(
        REGIONS_ID, verify_dataset_integrity=True, force_target_shape=[PATCH, PATCH],
        force_n_stages=4, configurations=["2d"], verbose=False)
    times = {}
    _build.reset_launch_counts()
    with injected(DinoUNetTrainer_b, configs["2d"], None, "dinounet_b"), \
            shortened_training(DinoUNetTrainer_b), timed_calls(times):
        trainer = run_training(REGIONS_ID, "2d", 0, "DinoUNetTrainer_b", device=dev)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    logged = trainer.logger.my_fantastic_logging
    losses = logged["train_losses"] + logged["val_losses"]
    dice = logged["dice_per_class_or_region"]
    summary = os.path.join(trainer.output_folder, "validation", "summary.json")
    with open(summary) as f:
        mean_dice = json.load(f)["foreground_mean"]["Dice"]
    _, val_keys = trainer.do_split()
    n_forwards = TRAIN_EPOCHS * VAL_ITERS + len(val_keys) * MIRRORS  # one tile a case
    want = {k: TRAIN_EPOCHS * TRAIN_ITERS * PER_TRAIN_STEP[k] + n_forwards * PER_FORWARD[k]
            for k in PER_FORWARD}
    log(f"[regions] {API_CASES} raw PNG cases of {RAW_SIZE}^2 with the labels declared "
        f"as regions {REGION_LABELS} (order {REGIONS_CLASS_ORDER}), planned to "
        f"{PATCH}^2; run_training(DinoUNetTrainer_b): {TRAIN_EPOCHS} epochs x "
        f"{TRAIN_ITERS} steps, {len(val_keys)} validation cases x {MIRRORS} mirrors "
        f"({times['validation'][0]:.2f} s); losses {[round(x, 4) for x in losses]}; "
        f"region pseudo Dice {dice}; summary.json foreground mean Dice {mean_dice:.4f}; "
        f"launches {counts}")
    if not trainer.label_manager.has_regions or trainer.network.cfg.num_classes != 2:
        raise AssertionError("regions: the trainer does not train the two regions")
    if len(losses) != 2 * TRAIN_EPOCHS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"regions: logged losses {losses}")
    if any(len(d) != 2 or not np.all(np.isfinite(d)) for d in dice):
        raise AssertionError(f"regions: pseudo Dice {dice}")
    if not np.isfinite(mean_dice):
        raise AssertionError(f"regions: summary.json's foreground mean Dice {mean_dice}")
    for k in val_keys:
        seg = np.asarray(pil_image().open(os.path.join(
            trainer.output_folder, "validation", k + ".png")))
        if seg.shape != (RAW_SIZE, RAW_SIZE) or not set(np.unique(seg).tolist()) <= {0, 1, 2}:
            raise AssertionError(f"regions: {k}.png {seg.shape} labels {np.unique(seg)}")
    if counts != want:
        raise AssertionError(f"regions: kernel launches {counts}, the path makes {want}")
    return counts


def phase_train_7b(dev, root: str) -> dict:
    """DinoUNetTrainer_7b from a bf16 published-layout .pth, through
    run.run_training, its final validation, then the predictor from its
    folder."""
    cfg = dataclasses.replace(VIT_CONFIGS["dinov3_vit7b16"], dtype="bfloat16")
    backbone_bytes = sum(int(np.prod(s)) for s in checkpoint_manifest(
        "dinov3_vit7b16").values()) * 2
    free = shutil.disk_usage(root).free
    # the .pth and checkpoint_final.pth: the backbone and under 2 GiB of fp32
    # weights and momentum
    need = 2 * backbone_bytes + 2 * 2**30
    log(f"[train_7b] {root}: {free / 1e9:.1f} GB free, the phase writes up to "
        f"{need / 1e9:.1f} GB")
    if free < need:
        raise AssertionError(f"train_7b: {free / 1e9:.1f} GB free under {root}, the phase "
                             f"needs {need / 1e9:.1f} GB")
    path = os.path.join(root, "dinov3_vit7b16_pretrain.pth")
    t0 = time.perf_counter()
    sd = published_backbone("dinov3_vit7b16", torch.bfloat16, dev, seed=7)
    torch.save(sd, path)
    write_s = time.perf_counter() - t0
    n_keys = len(sd)
    del sd
    torch.cuda.empty_cache()

    times, loads, built = {}, {}, []
    more = [(nnUNetTrainer, "save_checkpoint", "save")]
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launch_counts()
    with injected(DinoUNetTrainer_7b, DinoUNetTrainer._network_config, path, "dinounet_7b"), \
            measured_loads(loads), shortened_training(DinoUNetTrainer_7b, built), \
            timed_calls(times, more):
        # the .pth and one ~15 GB checkpoint: checkpoint_best and _latest
        # would add 30 GB of disk writes to the script
        trainer = run_training(API_DATASET, "2d", 0, "DinoUNetTrainer_7b", device=dev,
                               disable_checkpointing=True)
        torch.cuda.synchronize()
        run_peak = torch.cuda.max_memory_allocated(dev)
        counts = _build.launch_counts()
        final = os.path.join(trainer.output_folder, "checkpoint_final.pth")
        nnUNetTrainer.save_checkpoint(trainer, final)
        backbone = trainer.network.encoder.dinov3_adapter.backbone
        if backbone.cfg != cfg or backbone.blocks[0].mlp.w1.weight.dtype != torch.bfloat16:
            raise AssertionError(f"train_7b: the trainer built {backbone.cfg}")
        on_file = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
        n = loaded_as_file(backbone, on_file)
        del on_file

        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launch_counts()
        step_ms, losses = [], []
        for _ in range(3):
            batch = trainer.dataloader_train.generate_train_batch()
            t1 = time.perf_counter()
            losses.append(float(trainer.train_step_host(batch)))  # synchronises
            step_ms.append((time.perf_counter() - t1) * 1e3)
        step_peak = torch.cuda.max_memory_allocated(dev)
        extra = _build.launch_counts()
        logged = trainer.logger.my_fantastic_logging
        logged_losses = logged["train_losses"] + logged["val_losses"]
        model_folder = trainer.output_folder_base
        final_bytes = os.path.getsize(final)
        del trainer, backbone, built[:]
        torch.cuda.empty_cache()

        anon0, source = anon_rss()
        t0 = time.perf_counter()
        predictor = nnUNetPredictor(device=dev)
        predictor.initialize_from_trained_model_folder(model_folder, use_folds=(0,))
        predictor._load(predictor.list_of_parameters[0])
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        anon_reload = anon_rss()[0] - anon0
        seen = anon_sees()
        case = os.path.join(os.environ["nnUNet_raw"], API_DATASET, "imagesTr",
                            "case_000_0000.png")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        written = predictor.predict_from_files([[case]], os.path.join(root, "predicted_7b"))
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predicted = _build.launch_counts()
    seg = np.asarray(pil_image().open(written[0] + ".png"))

    load_s, anon_load, _ = loads["load"][0]
    n_steps = TRAIN_EPOCHS * TRAIN_ITERS
    n_forwards = TRAIN_EPOCHS * VAL_ITERS + API_VAL * MIRRORS  # one tile a case
    per_forward = {**PER_FORWARD, **PER_FORWARD_ROUTE["serve_7b"]}
    want = {k: n_steps * PER_TRAIN_STEP_7B[k] + n_forwards * per_forward[k] for k in PER_FORWARD}
    log(f"[train_7b] a synthetic published-layout dinov3_vit7b16 .pth ({n_keys} keys, bf16, "
        f"{os.path.getsize(path) / 1e9:.2f} GB) drawn on the card and written in "
        f"{write_s:.1f} s; run_training(DinoUNetTrainer_7b): {TRAIN_EPOCHS} epochs x "
        f"{TRAIN_ITERS} steps, {API_VAL} validation cases x {MIRRORS} mirrors; losses "
        f"{[round(x, 4) for x in logged_losses]}; all {n} backbone tensors equal to the "
        f"file's after training; launches {counts}")
    log(f"[train_7b] {card_line()}: load {load_s:.2f} s ({anon_load / 2**20:.1f} MiB "
        f"{source} growth); step {float(np.median(step_ms)):.1f} ms median of 3 "
        f"({', '.join(f'{t:.1f}' for t in step_ms)}; batch 2 x {PATCH}^2, augmentation "
        f"included), peak device memory over those steps {step_peak / 2**30:.2f} GiB, over "
        f"run_training {run_peak / 2**30:.2f} GiB; checkpoint_final.pth "
        f"({final_bytes / 1e9:.2f} GB) saved in {times['save'][0]:.1f} s; final validation "
        f"{times['validation'][0]:.1f} s; "
        f"the predictor from the folder: build and reload {reload_s:.2f} s "
        f"({anon_reload / 2**20:.1f} MiB {source} growth; 1 GiB written on the host grows "
        f"it {seen:.3f} GiB), predict_from_files of one {RAW_SIZE}^2 case "
        f"{predict_s:.2f} s")
    if not np.all(np.isfinite(logged_losses + losses)) or len(logged_losses) != 2 * TRAIN_EPOCHS:
        raise AssertionError(f"train_7b: losses {logged_losses} then {losses}")
    if counts != want:
        raise AssertionError(f"train_7b: kernel launches {counts}, the path makes {want}")
    if extra != {k: 3 * n for k, n in PER_TRAIN_STEP_7B.items()}:
        raise AssertionError(f"train_7b: 3 more steps launched {extra}")
    if predicted != {k: MIRRORS * n for k, n in per_forward.items()}:
        raise AssertionError(f"train_7b: the prediction launched {predicted}")
    if seg.shape != (RAW_SIZE, RAW_SIZE) or not set(np.unique(seg).tolist()) <= {0, 1, 2}:
        raise AssertionError(f"train_7b: predicted {seg.shape} labels {np.unique(seg)}")
    if not 0.9 < seen < 1.1:
        raise AssertionError(f"train_7b: {source} grew {seen:.3f} GiB while 1 GiB was "
                             "written on the host: it does not measure this process")
    for what, grown in (("load", anon_load), ("reload", anon_reload)):
        if not grown < ANON_GROWTH_BOUND:
            raise AssertionError(f"train_7b: {source} grew {grown / 2**30:.2f} GiB across "
                                 f"the {what}")
    for k, n in predicted.items():
        counts[k] += n
    for k, n in extra.items():
        counts[k] += n
    return counts


def _nnunet_env(root: str) -> None:
    for sub in ("raw", "preprocessed", "results"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
        os.environ["nnUNet_" + sub] = os.path.join(root, sub)


@contextlib.contextmanager
def recorded_steps(table: dict):
    """Each nnUNetTrainer.train_step_host in the block, synchronised: its
    loss under "losses", its milliseconds under "step_ms"."""
    step = nnUNetTrainer.train_step_host

    def timed(self, batch):
        t0 = time.perf_counter()
        loss = step(self, batch)
        table.setdefault("losses", []).append(float(loss))  # synchronises
        table.setdefault("step_ms", []).append((time.perf_counter() - t0) * 1e3)
        return loss

    nnUNetTrainer.train_step_host = timed
    try:
        yield
    finally:
        nnUNetTrainer.train_step_host = step


def _steps_line(table: dict) -> str:
    ms = table["step_ms"]
    return (f"losses {[round(x, 4) for x in table['losses']]}; step ms "
            f"{', '.join(f'{t:.0f}' for t in ms)} (median after the first "
            f"{float(np.median(ms[1:])):.1f})")


def _check_plan(plans_id: str, configuration: str, cls) -> dict:
    with open(os.path.join(os.environ["nnUNet_preprocessed"], UNET3D_DATASET,
                           plans_id + ".json")) as f:
        plan = json.load(f)["configurations"][configuration]
    arch = plan["architecture"]
    if not arch["network_class_name"].endswith(cls.__name__):
        raise AssertionError(f"{plans_id} {configuration}: network {arch['network_class_name']}")
    return plan


def phase_unet_3d(dev, root: str) -> dict:
    """The plans' PlainConvUNet in 3-D: raw NIfTI volumes -> fingerprint ->
    default planner -> 3d_fullres preprocessing -> run_training with deep
    supervision and its final validation -> predict_from_files of a
    held-out case -> evaluate; a tile's parity and host accumulation."""
    _nnunet_env(root)
    times, steps = {}, {}
    t0 = time.perf_counter()
    raw = write_sphere_shell_raw_dataset(os.environ["nnUNet_raw"], UNET3D_DATASET,
                                         UNET3D_TRAIN, UNET3D_TEST, UNET3D_SIZE, seed=3)
    write_s = time.perf_counter() - t0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    extract_fingerprints([UNET3D_ID], num_processes=4)
    plans_id = plan_experiments([UNET3D_ID])
    plan_s = time.perf_counter() - t0
    plan = _check_plan(plans_id, "3d_fullres", PlainConvUNet)
    arch = plan["architecture"]["arch_kwargs"]
    if (plan["patch_size"], plan["batch_size"]) != PLANNED_3D[plans_id]:
        raise AssertionError(f"unet_3d: 3d_fullres patch {plan['patch_size']}, batch "
                             f"{plan['batch_size']}")
    t0 = time.perf_counter()
    preprocess([UNET3D_ID], plans_id, ["3d_fullres"], [4])
    prep_s = time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    with timed_calls(times), recorded_steps(steps), shortened_training(nnUNetTrainer):
        trainer = run_training(UNET3D_ID, "3d_fullres", 0, "nnUNetTrainer", plans_id,
                               device=dev)
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        if type(trainer.network) is not PlainConvUNet or not trainer.network.cfg.deep_supervision:
            raise AssertionError(f"unet_3d: trained {type(trainer.network).__name__} "
                                 f"{trainer.network.cfg}")
        losses = steps["losses"]
        if len(losses) != TRAIN_EPOCHS * TRAIN_ITERS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"unet_3d: step losses {losses}")
        if not np.mean(losses[-3:]) < np.mean(losses[:3]):
            raise AssertionError(f"unet_3d: the losses do not fall: {losses}")
        val_folder = os.path.join(trainer.output_folder, "validation")
        _, val_keys = trainer.do_split()
        if len(val_keys) != UNET3D_VAL:
            raise AssertionError(f"unet_3d: fold 0 validates {val_keys}")
        for k in val_keys:
            check_segmentation_file(os.path.join(val_folder, k + ".nii.gz"),
                                    os.path.join(raw, "imagesTr", k + "_0000.nii.gz"))
        summary = load_summary_json(os.path.join(val_folder, "summary.json"))
        val_times = {k: times.pop(k) for k in list(times)}
        model_folder = trainer.output_folder_base
        del trainer
        torch.cuda.empty_cache()

        predictor = nnUNetPredictor(device=dev)
        predictor.initialize_from_trained_model_folder(model_folder, use_folds=(0,))
        case = os.path.join(raw, "imagesTs", f"case_{UNET3D_TRAIN:03d}_0000.nii.gz")
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        written = predictor.predict_from_files([[case]], os.path.join(root, "predicted_3d"))
        torch.cuda.synchronize()
        predict_s = time.perf_counter() - t0
        predict_peak = torch.cuda.max_memory_allocated(dev) / 2**30
        test_times = {k: times.pop(k) for k in list(times)}
    check_segmentation_file(written[0] + ".nii.gz", case)
    t0 = time.perf_counter()
    evaluated = api.evaluate(UNET3D_ID, os.path.join(model_folder, "fold_0"), fold=0,
                             num_processes=4)
    evaluate_s = time.perf_counter() - t0
    dice = summary["foreground_mean"]["Dice"]
    if not np.isfinite(dice) or not _same_json(evaluated, summary):
        raise AssertionError(f"unet_3d: validation Dice {dice}; evaluate gave another "
                             "summary than the validation wrote")
    counts = _build.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"unet_3d: the 3-D path runs stock convs, launches {counts}")
    log(f"[unet_3d] {UNET3D_TRAIN} + {UNET3D_TEST} raw cases of {UNET3D_SIZE} at 1 mm "
        f"(written in {write_s:.1f} s); fingerprint + default planner {plan_s:.1f} s: "
        f"3d_fullres patch {plan['patch_size']}, batch {plan['batch_size']}, features "
        f"{arch['features_per_stage']}, strides {arch['strides']}; preprocess {prep_s:.1f} s")
    log(f"[unet_3d] {card_line()}: nnUNetTrainer 3d_fullres with deep supervision, "
        f"{TRAIN_EPOCHS} epochs x {TRAIN_ITERS} steps: {_steps_line(steps)}; peak device "
        f"memory {train_peak:.2f} GiB; final validation {val_times['validation'][0]:.1f} s "
        f"for {UNET3D_VAL} cases x {MIRRORS_3D} mirrors (prediction on the device "
        f"{_per_case(val_times['predict'])}), foreground mean Dice {dice:.4f}; "
        f"predict_from_files {predict_s:.2f} s for 1 case (preprocessing "
        f"{_per_case(test_times['preprocess'])}, prediction on the device "
        f"{_per_case(test_times['predict'])}, export {_per_case(test_times['export'])}), "
        f"peak device memory {predict_peak:.2f} GiB; evaluate {evaluate_s:.1f} s equals "
        f"the validation's summary.json; launches {counts}")

    # one tile: the card's bf16 forward against the fp32 plain forward on the CPU
    image, props = NiftiIO().read_images([case])
    cm = predictor.configuration_manager
    data, _ = cm.preprocessor_class().run_case_npy(image, None, props,
                                                  predictor.plans_manager, cm,
                                                  predictor.dataset_json)
    pz, py, px = cm.patch_size
    tile = torch.from_numpy(np.ascontiguousarray(data[None, :, :pz, :py, :px],
                                                 dtype=np.float32))
    network = predictor.network
    with torch.inference_mode():
        got = network(tile.to(dev)).float().cpu()
        ref = type(network)(dataclasses.replace(network.cfg, dtype="float32"),
                            network.input_channels).eval()
        ref.load_state_dict({k: v.cpu() for k, v in network.state_dict().items()})
        t0 = time.perf_counter()
        want = ref(tile)
        cpu_s = time.perf_counter() - t0
    del ref
    rel = rel_l2(got, want)
    log(f"[unet_3d] parity: one {cm.patch_size} tile, card bf16 vs CPU fp32 ({cpu_s:.1f} "
        f"s): relative L2 error {rel:.4e} (bound {PARITY_BOUND}); max abs "
        f"{float((got - want).abs().max()):.4e} of max |ref| {float(want.abs().max()):.4e}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"unet_3d parity {rel} over {PARITY_BOUND}")

    # the held-out case again, its accumulators on the host
    t0 = time.perf_counter()
    on_device = predictor.predict_logits_from_preprocessed_data(data)
    device_s = time.perf_counter() - t0
    with route_env({"DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES": "0"}):
        t0 = time.perf_counter()
        on_host = predictor.predict_logits_from_preprocessed_data(data)
        host_s = time.perf_counter() - t0
    a, b = on_host.astype(np.float32), on_device.astype(np.float32)
    n_diff = int(np.count_nonzero(a != b))
    excess = float(np.max(np.abs(a - b) - HOST_ACCUM_RTOL * np.abs(b)))
    log(f"[unet_3d] host accumulation (DINOUNET_TPU_SW_ACCUM_BUDGET_BYTES=0) vs the "
        f"device's, fp16 logits {on_host.shape}: {n_diff} of {a.size} differ, max abs "
        f"{float(np.max(np.abs(a - b))):.4e} (bound: one fp16 ulp, rtol "
        f"{HOST_ACCUM_RTOL}); {host_s:.2f} s on the host, {device_s:.2f} s on the device")
    if on_host.shape != on_device.shape or not excess <= 0:
        raise AssertionError(f"unet_3d: host accumulation differs by {excess} past one ulp")
    del predictor, network
    torch.cuda.empty_cache()
    return counts


def _plans_steps(dev, dataset_id, configuration: str, plans_id: str, n_steps: int,
                 tag: str):
    """nnUNetTrainer of the plans on the card: set-up, then `n_steps` train
    steps with deep supervision; returns the trainer and the steps' table."""
    trainer = get_trainer_from_args(dataset_id, configuration, 0, "nnUNetTrainer",
                                    plans_id, device=dev)
    trainer.seed = 0
    t0 = time.perf_counter()
    trainer.on_train_start()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    steps = {}
    with recorded_steps(steps):
        for _ in range(n_steps):
            trainer.train_step_host(trainer.dataloader_train.generate_train_batch())
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    cm = trainer.configuration_manager
    log(f"[{tag}] {card_line()}: {type(trainer.network).__name__} "
        f"({sum(p.numel() for p in trainer.network.parameters()) / 1e6:.1f} M parameters) "
        f"{configuration}, patch {cm.patch_size}, batch {cm.batch_size}, deep "
        f"supervision; set-up {setup_s:.1f} s; {n_steps} steps: {_steps_line(steps)}; peak "
        f"device memory {peak:.2f} GiB")
    if not np.all(np.isfinite(steps["losses"])):
        raise AssertionError(f"{tag}: losses {steps['losses']}")
    return trainer, steps


def phase_resenc_3d(dev) -> dict:
    """nnUNetPlannerResEncM's 3d_fullres ResidualEncoderUNet on the unet_3d
    phase's set (its preprocessed data reused): RESENC_STEPS steps."""
    _build.reset_launch_counts()
    plans_id = plan_experiments([UNET3D_ID], experiment_planner_class=nnUNetPlannerResEncM)
    plan = _check_plan(plans_id, "3d_fullres", ResidualEncoderUNet)
    if (plan["patch_size"], plan["batch_size"]) != PLANNED_3D[plans_id]:
        raise AssertionError(f"resenc_3d: 3d_fullres patch {plan['patch_size']}, batch "
                             f"{plan['batch_size']}")
    trainer, _ = _plans_steps(dev, UNET3D_ID, "3d_fullres", plans_id, RESENC_STEPS,
                              "resenc_3d")
    if type(trainer.network) is not ResidualEncoderUNet:
        raise AssertionError(f"resenc_3d: trained {type(trainer.network).__name__}")
    log(f"[resenc_3d] blocks per stage "
        f"{plan['architecture']['arch_kwargs']['n_conv_per_stage']}, features "
        f"{plan['architecture']['arch_kwargs']['features_per_stage']}")
    counts = _build.launch_counts()
    if any(counts.values()):
        raise AssertionError(f"resenc_3d: the 3-D path runs stock convs, launches {counts}")
    del trainer
    torch.cuda.empty_cache()
    return counts


def phase_unet_2d(dev, root: str) -> dict:
    """The default planner's 2d PlainConvUNet: UNET2D_STEPS steps with deep
    supervision, then one tile batch through the trained network in eval
    mode, stock and under DINOUNET_TPU_DECODER_TAIL=auto."""
    _nnunet_env(root)
    write_disk_ring_png_dataset(os.environ["nnUNet_raw"], UNET2D_DATASET, UNET2D_CASES,
                                (UNET2D_SIZE, UNET2D_SIZE), seed=2)
    extract_fingerprints([UNET2D_ID], num_processes=4)
    plans_id = plan_experiments([UNET2D_ID])
    preprocess([UNET2D_ID], plans_id, ["2d"], [4])
    _build.reset_launch_counts()
    trainer, _ = _plans_steps(dev, UNET2D_ID, "2d", plans_id, UNET2D_STEPS, "unet_2d")
    cm = trainer.configuration_manager
    arch = cm.network_arch_init_kwargs
    if cm.patch_size != [UNET2D_SIZE, UNET2D_SIZE] or arch["features_per_stage"][:3] != [
            32, 64, 128]:
        raise AssertionError(f"unet_2d: 2d patch {cm.patch_size}, features "
                             f"{arch['features_per_stage']}")
    train_counts = _build.launch_counts()
    if any(train_counts.values()):
        raise AssertionError(f"unet_2d: train steps launched {train_counts}")

    tiles = []
    while len(tiles) < TILE_BATCH:
        tiles.extend(trainer.dataloader_val.generate_train_batch()["data"])
    tiles = torch.from_numpy(np.stack(tiles[:TILE_BATCH]))
    network = trainer.network.eval()
    with torch.inference_mode():
        stock = network(tiles.to(dev)).float()
        with route_env({"DINOUNET_TPU_DECODER_TAIL": "auto"}):
            _build.reset_launch_counts()
            fused = network(tiles.to(dev)).float()
            counts = _build.launch_counts()
    want = {**dict.fromkeys(counts, 0), **PER_FORWARD_UNET2D_CHAIN}
    rel = rel_l2(fused, stock)
    agree = float((fused.argmax(1) == stock.argmax(1)).float().mean())
    log(f"[unet_2d] one tile batch of {len(tiles)} x {UNET2D_SIZE}^2 through the trained "
        f"network, the decoder chain (DINOUNET_TPU_DECODER_TAIL=auto) vs the stock stages, "
        f"both card bf16: relative L2 {rel:.4e} (bound {PARITY_BOUND}), argmax agreement "
        f"{agree:.4%}; launches {counts}")
    if counts != want:
        raise AssertionError(f"unet_2d: kernel launches {counts}, the chain makes {want}")
    if not rel <= PARITY_BOUND:
        raise AssertionError(f"unet_2d: chain vs stock {rel} over {PARITY_BOUND}")
    del trainer, network
    torch.cuda.empty_cache()
    return counts


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"[env] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; python {sys.version.split()[0]}")
    phase_build()
    kernel_results = phase_kernels(dev)
    model = build_model()
    counts = {"serve": phase_serve(dev, model)}
    phase_layer_times(dev, model, "serve")
    phase_profile(dev, model, "serve")
    tile, want = phase_parity(dev, model)
    card_stock = None
    for path, settings in ROUTES.items():
        if path in INT8_ROUTES and card_stock is None:
            with torch.no_grad():
                for blk in model.encoder.dinov3_adapter.backbone.blocks:
                    blk.ls1.gamma.fill_(INT8_LAYERSCALE)
                    blk.ls2.gamma.fill_(INT8_LAYERSCALE)
            card_stock = card_logits(model, parity_batch(dev, tile))
        with route_env(settings):
            counts[path] = phase_serve(dev, model, path)
            if path in INT8_ROUTES:
                log_int8_cache(model, f"[serve routes: {path}]")
            phase_layer_times(dev, model, path)
            if path == "serve_cm":
                phase_profile(dev, model, path)
            route_want = want
            if path in INT8_ROUTES + OP_ROUTES:
                route_want, cpu_s = cpu_logits(model, tile)
                log(f"[parity: {path}] CPU fp32 logits under the route ({cpu_s:.1f} s)")
            phase_route_parity(dev, model, tile, route_want, path, card_stock)
    del model
    torch.cuda.empty_cache()
    model7 = build_model_7b(dev)
    counts_7b, got_7b = phase_serve_7b(dev, model7, tile)
    counts.update(counts_7b)
    cfg7 = model7.cfg
    state7 = {k: v.cpu() for k, v in model7.state_dict().items()}
    del model7
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    phase_parity_7b(dev, cfg7, state7, tile, got_7b)
    del state7
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        _train_env(root)
        counts["train"] = phase_train(dev)
        with route_env({"DINOUNET_TPU_MSDA_PREP": "xla"}):
            counts["train_msda_xla"] = phase_train_steps(
                dev, "DinoUNetTrainer_b", "train_msda_xla", PER_TRAIN_STEP_XLA)
        counts["train_l"] = phase_train_steps(dev, "DinoUNetTrainer_l", "train_l",
                                              PER_TRAIN_STEP_L)
    phase_train_parity(dev)
    with tempfile.TemporaryDirectory() as root:
        counts["pipeline"] = phase_pipeline(dev, root)
    with tempfile.TemporaryDirectory() as root:
        counts["api"] = phase_api(dev, root)
        torch.cuda.empty_cache()
        counts["pretrained"] = phase_pretrained(dev, root)
        torch.cuda.empty_cache()
        counts["regions"] = phase_regions(dev, root)
        torch.cuda.empty_cache()
        counts["train_7b"] = phase_train_7b(dev, root)
    with tempfile.TemporaryDirectory() as root:
        counts["unet_3d"] = phase_unet_3d(dev, root)
        counts["resenc_3d"] = phase_resenc_3d(dev)
    with tempfile.TemporaryDirectory() as root:
        counts["unet_2d"] = phase_unet_2d(dev, root)

    log(card_line())
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": sum(c[name] for c in counts.values()),
         "launches_by_path": {path: c[name] for path, c in counts.items()},
         **kernel_results[name]}
        for name, (src, tpu) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
