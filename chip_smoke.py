#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels (hypervla_tpu_torch/csrc) with nvcc, one
   process per source, all at once.
2. Kernel phase: runs each kernel of the DINOv2 serving trunk, and the
   12-layer trunk, at the flagship's shapes (seq 257, width 768) against its
   plain PyTorch version on the same inputs, and times both. Then the
   kernels of the last redesign over the shapes a first version goes wrong
   at: the trunk's tensor-core attention at S = 257, 1, 16, 17, 64, 300 and
   widths 64, 128, 768, and over a hundred random draws at the serving shape
   (a row beyond one ulp must be one that a score at a bf16 rounding
   midpoint explains), the warp-per-row LayerNorm forward and backward in
   every type combination at 16448, 257 and 1001 rows, on shifted inputs, a
   batch against its two halves, and the widths that keep the first
   kernels; each twice bit for bit, the LayerNorm timed beside what it
   replaced. Then kernel 5, the one-pass serving LayerNorm a warp per row
   (16448, 257 and 1 rows of 768 and 31 of 1024, x and its vectors in both
   types, rows shifted by +100), and the layer backward's LayerScale pass
   on the column sum's grid (16448, 16485, 99 and 68 rows; dy the plain
   version's bits, a batch against its halves), each twice bit for bit;
   kernel 5 traced beside its first version (on unaligned rows), kernel 6's
   forward and F.layer_norm at the serving shape.
3. Slice phase: builds the full-width flagship from a seed, encodes an
   initial frame with the fp32 DINOv2, resets an InferenceWrapper with a
   random (1, 32, 768) instruction embedding and drives ~50 fused serving
   steps on random 256x256 frames (crop and ensembling on). Checks that every
   step went through the trunk kernels and that the actions match the same
   steps run with the plain trunk. Then a second serving configuration on
   the same weights: use_flash_attention=True and fused_layer_norm=True
   through the per-layer serving step (trunk_impl="layers"): 12 flash
   attention and 25 one-pass LayerNorm launches per step, the actions held
   against the same steps with both kernels' plain versions, timed beside
   the stacked-trunk step.
   Server phase, on the same flagship: saved with an EMA file into a
   temporary directory and loaded back by load_hypervla_policy on the card
   (the EMA params bit for bit); its host path (the JAX package's default
   path, over the stacked trunk kernel: one launch a step) for 5 steps
   against the fused kernel step; the fused kernel wrapper that
   load_hypervla_policy(fused_serving=True) builds behind the PolicyServer
   on 127.0.0.1, driven by a PolicyClient in this process (ping, reset,
   50 steps): every served
   action bit-equal to the in-process step's and one trunk launch per
   served step, the round trip timed beside the in-process step and
   traced; the K-tick step (K = 8 over 48 frames: bit-equal to 48 per-tick
   steps, 48 trunk launches) and the multi-task step (N = 4 tasks: each
   action bit-equal to its single-task step, 4 trunk launches a tick).
4. Row and flash kernel phase: the flash attention and the one-pass
   LayerNorm at the serving shapes (the flash attention also at B=64, as
   cross attention with 65 queries on 300 keys and at head dim 128; each
   twice bit for bit, its error against the exact function in fp64 beside
   that of the fp32-FMA kernel it replaced), the
   residual add + LayerNorm pair with and without LayerScale, forward and
   backward with both cotangents (each twice, bit-equal; also at ragged row
   counts and four chunks a lane, and at the widths and on the unaligned
   rows that keep the first kernels, in bf16 and fp32, timed beside them),
   and the fused exact GELU at the training shapes, each against its plain
   version, timed with its bound and the one PyTorch call for the same
   function. The differentiable flash attention (csrc/
   flash_attention_train.cu), forward and backward, bf16 and fp32, at the
   flagship's training shape (64, 257, 12, 64) and at S = 1, 17, 300 with
   head dims 32 and 128: against its plain versions, twice bit for bit,
   timed beside scaled_dot_product_attention's forward and backward; and
   its bf16 forward at the serving shape (1, 257, 12, 64) under
   torch.no_grad().
   The add + LayerNorm without LayerScale lies on no model path: its
   differentiable function is driven once, counted, forward and backward.
   Training kernel phase, at B=64, S=257, H=12, D=64, width 768, each
   kernel against its plain version, both timed: the fused training
   attention forward and backward; the layer forward without residuals (one
   layer and 12 stacked) and with them (all outputs); the layer backward
   (dx, the weight gradients, dpv, db1), which must also repeat bit for bit
   and equal the sum over two half batches; the training LayerNorm forward
   and backward; and each kernel of csrc/layer_backward.cu and each GEMM
   shape of the layer alone (the GELU backward's h also against kernel 9's
   and the plain version's, at the layer's input and at every finite bf16
   input). The column pass phase traces each column-sum pass, kernels 7
   and 8 and the GELU apart from their finishing launches, beside the first
   versions' device times.
5. Train phase: the full-width flagship at batch 64 through the entry
   points of scripts/bench_train.py (build_frozen_encoders,
   make_train_step), the frozen T5 and DINOv2 drawn from seeds, the LR at
   its peak, on one fixed batch, under four configurations: the fast
   training preset (fused attention in a cuBLAS trunk, the frozen encoder
   through the layer forward), and the fast preset with the layer-kernel
   trunk (hoist_shared_trunk, dino_layers_impl="pallas_train",
   fused_layer_norm="pallas_train": every trunk layer through the
   residual-saving layer forward and the layer backward, the final
   LayerNorm of both encoders through the training LayerNorm), and the fast
   preset with dino_fused_add_ln=True and HYPERVLA_FUSED_GELU=1 (set for
   that configuration's steps only): every residual boundary of the trunk
   through fused_add_scale_ln forward and backward, the trunk's GELU
   forward through the fused kernel, and the fast preset with
   dino_fused_attention=False, use_flash_attention=True and
   flash_attention_trainable=True (scripts/bench_train.py --flash): every
   trunk attention through the differentiable flash attention, forward and
   backward. For each:
   every step's launches, a finite and falling loss, and the first step
   against the plain path (the same step with the kernel switches off);
   all five timed in turns. Then, from the fast preset's starting state:
   the step with optimizer.packed=True (AdamW over one flat buffer per
   label and decay flag) beside the per-leaf step, the new params bit for
   bit, both traced for their kernels a step and timed in turns; and the
   step with delta-decay toward the trunk's initial params (base weight
   decay 0.25) beside the same step without it: every other leaf bit for
   bit, each trunk leaf moved by base_lr * 0.25 * its pretrained value
   (rtol 2e-4, atol 1e-6).
6. Trainer phase: the port's training command line on data, as a user
   runs it. Two datasets of 8 trajectories x 20 frames (256x256 uint8 RGB
   from a seed, JPEG where PIL is installed, else raw; half of the
   instructions drawer tasks) are written to a temporary directory and
   registered as an OXE named mix (data/oxe/fixture_mix.py). Run A:
   `main(["--config", "vit_t,oxe,fast", ...])` through the named-mix path at
   batch 64, resize 224, 6 steps, a checkpoint at steps 3 and 6: every step
   launches the fused training attention forward and backward (12 + 12)
   and the frozen encoder's no-residual layer forward (12), its loss is
   finite, and its first step's training_loss and grad_norm equal, bit for
   bit, make_train_step called directly on the same batch from the same
   state. Run B resumes to step 7: its first state is run A's last, bit for
   bit. Run C, 2 steps over a dataset_kwargs_list with a validation
   dataset and device_augment (random_resized_crop 0.8-1.0, brightness,
   contrast, saturation, hue on the card): a finite validation MSE, and the
   augmentation of a batch repeats bit for bit under its seed and step and
   differs from the frames it was given. Then run A's checkpoint is served
   through load_hypervla_policy(fused_serving=True) for 5 steps, one
   stacked-trunk launch each. Prints the trainer's median ms/step, its
   timer's dataset and train shares, samples/s, and one traced step's
   device busy, kernel count and idle share, beside the train phase's
   hand-fed fast-preset step.
   Fine-tuning, on the same data: a config file whose get_config returns
   the port's copy of the JAX fine-tune config
   (configs.py::finetune_config, "vit_t,fixture,head_only") with the fast
   preset, through `main([...])`, warm-started from run A's step-6 EMA
   params, with gradient accumulation 2 at batch 64 and the LR at its peak
   from the first applied update (warmup_steps=0), for 4 steps: 12 + 12 +
   12 launches of kernels 2 and 3 every step, every frozen leaf bit-equal
   to the warm start, every trainable leaf unchanged by steps 1 and 3 and
   moved by steps 2 and 4; ms/step, samples/s, peak memory, and an
   accumulating and an applying step traced without the logged step's
   norms (as the other phases trace a step), the applying one also with
   them.
7. SmallStem phase: the SmallStem HyperVLA at vit_t width, the published
   `vit_t,<dataset>` config with the two command-line overrides
   model_type=vit and action_head_type=continuous (a generated,
   weight-standardized conv stem (32, 96, 192, 384) at 224 px, the "full"
   generation strategy: one output head over ~1.03 M base-net params a
   task; no shared trunk, so no kernel of the port runs on this path).
   Built from a seed with a random (1, 32, 768) instruction embedding and
   random fan-out kernels: 50 fused serving steps and 5 host-path steps on
   256x256 frames (resize and crop to 224 on the card), timed and traced,
   against the same model and steps on the CPU in fp32 (TF32 off on the
   card): the card's resized pixels within one level of the CPU's on at
   most 0.1% of them (a value at .5 rounds either way), then, from the
   card's pixels, each action within 1e-4 of the CPU's.
   Then `main([...])` of the training command line on the trainer phase's
   fixture mix at batch 64 for 4 steps: finite losses, the first step's
   loss and grad_norm within 1e-4 and 1e-3 (relative) of the same step on
   the CPU, ms/step, samples/s, one traced step's device busy and idle
   share, and the peak memory; the checkpoint it saves is then served for
   5 fused steps.
8. Heads phase: the flagship with the diffusion head (the JAX default:
   an MLP-ResNet score net sampling in 20 denoising steps, 209 M params of
   fan-out heads) and with the discrete head (28 readout tokens, 256
   bins), `action_head_type` overridden in the vit_t,oxe recipe, random
   weights and fan-out kernels from a seed. Each is served through fused
   InferenceWrapper steps (20 each) on kernel 1, one trunk launch a
   step, against the same steps on kernel 1's plain version (the
   diffusion actions within 0.05 * max(scale, 1); the discrete head's
   logits within that bound and its clear argmax tokens equal), a second
   wrapper with the same init_rng bit-equal and one with another
   different (diffusion) or equal (discrete); then trained under the fast
   preset at batch 64 (3 and 2 steps) beside the mix head: finite losses,
   12 + 12 launches of kernel 2 and 12 of kernel 3 a step, the step from
   one state and (seed, step) bit-equal; ms/step, device busy, kernels,
   peak memory, the optimizer's update alone, and the kernels that take
   each head's device time beyond the mix head's.
9. Eval phase: the evaluators a user runs after training, on the
   full-width flagship from a seed. (a) Without the initial-image
   conditioning (the JAX default, which the pixel environment's resets
   need): its checkpoint served by `python -m
   hypervla_tpu_torch.eval.policy_server` (host path, 224 px, libero
   setup, ensembling) in a child process on the card, which loads while
   (a)'s in-process episodes, (b) and (c) run here: 3 episodes of
   PixelReachEnv (40 steps at most) in this process through
   load_hypervla_policy, one kernel 1 launch a tick; after (c), the same
   episodes through the server, driven by a PolicyClient in
   tools/eval_pixel_env.py::run_episodes, its JSON fields printed: the
   same steps and successes per episode, bit-equal actions. (b) The SIMPLER and LIBERO evaluators over the
   simulator stand-ins of tests/test_torch_sim_stubs.py: SIMPLER on the
   flagship as it is (conditioned on the initial image, through the
   evaluator's own fp32 DINOv2, drawn from a seed), one task of 2 episodes
   of at most 10 steps, its initial state's patch embeddings held to the
   same DINOv2 in fp32 on the CPU within 1e-4 of their scale; LIBERO on the model of (a), one task of
   2 episodes: the success JSON, one kernel 1 launch a tick, finite
   actions. (c) The trainer on the trainer phase's fixture at batch 64
   under the fast preset, the model of (a), with viz_datasets: 4 steps,
   the visualization callback at steps 2 and 4, every
   visualizer/<dataset>/<metric> finite, kernel 1's launches counted per
   call (one a frame: the stacked trunk takes one frame a launch), and the
   last call's policy on one trajectory through kernel 1 held to the same
   policy through its plain version. The script runs under
   PYTHONHASHSEED=0 (it starts itself again so where that is not set), so
   that the child server's FallbackTokenizer (its ids come from `hash`)
   tokenizes as this process does.
10. Multi-device phase: the port's training on a process group. (a) Two
   gloo ranks share the card (NCCL refuses two ranks on one device), the
   fast-preset flagship at full width, data-parallel, 32 rows of the
   fixed batch of 64 each, 3 steps from one state: each step's
   training_loss and grad_norm within rtol 2e-4, atol 1e-5 of the same
   steps in one process at batch 64, the two ranks' params bit-equal
   before and after every step, each rank launching kernels 2 and 3
   (12 + 12 and 12 a step). (b) The trainer on the trainer phase's
   fixture mix in an NCCL process group of one rank (a FileStore in a
   temporary directory): 4 steps bit-equal to run A's, which ran without
   a group, and an NCCL all-reduce on the card; its steps [2, 4) traced
   by the trainer's profile window, whose summary must name kernels 2 and
   3's CUDA kernels with their device ms per step. The ranks' step time
   is printed with the card, and is not a scaling number.
11. Octo phase: the Octo model of octo_pretrain_config("vit_s,oxe")
   (12 x 384, 6 heads, MLP 1536, SmallStem16 over the frame and the goal
   image's channels, the 20-step diffusion head), full width and depth,
   random weights from a seed, fp32. Serving through OctoInference
   (google_robot, horizon 2, ensembling, the port's seeded T5 with the
   fallback tokenizer), at 224 px, the size the model is built for (the
   JAX default of 256 px fails its shape check, as in the JAX package,
   checked here once): 50 steps, finite actions, a repeat from the same
   init_rng bit-equal, the first step's sample against the same model,
   observations and draws on the CPU within 1e-4; per-step ms (median,
   CUDA events), device busy, kernels and idle share from one trace. A
   checkpoint round trip (save_pretrained, load_pretrained onto the card):
   params and the next action bit-equal. One hand-fed train step at the
   config's batch of 256 (ms/step, samples/s, peak GiB, device busy), its
   loss and grad_norm against the same step on the CPU from the same
   state, T5 embedding and draws (1e-4 and 1e-3 relative; the CPU step
   runs in a thread beside the rest of this phase and the encoders phase,
   and is compared after them, as phase octo_cpu_step); then
   `octo_train.main` for 3 steps at batch 64 on the trainer phase's
   fixture mix, saving at step 3. None of the nine TPU kernels' wrappers
   is launched (their counters stay 0).

12. Encoders phase: A12.2's second half at full width, random weights
   from a seed. The flagship with differential attention: 20 fused ticks
   on kernel 1 against its plain trunk (0.05 max(scale, 1)), fast-preset
   steps at batch 64 on kernels 2 and 3-forward, the first against the
   plain step (loss and grad_norm 2e-2 relative, per-leaf update cosine
   > 0.98). The BaseModel ablation (base_pretrain_config): trained as a
   HyperVLA whose blocks are all shared (kernel 2, against plain), served
   as a BaseModel on kernel 1 (against plain), a save/load round trip
   bit-equal. The CLIP-base and EfficientNet-b3 HyperVLAs in the flagship
   recipe (the backbone shared): CLIP 20 fused ticks; the EfficientNet
   serving raises InvalidRngError, as the JAX package's; batch-64 steps
   with kernel 3-forward on the initial image; the card against the CPU
   in fp32 (actions 1e-4; one step at batch 2, its draws replayed: loss
   1e-4, grad_norm 1e-3 relative). SigLIP on precomputed (256, 1152)
   embeddings: 5 host ticks and a batch-64 step. The Octo model at vit_s
   on resnetv2-26-film over ImageNet-normalized frames, with the in-model
   T5-base LanguageTokenizer (the seeded t5-base.pt) as its text encoder:
   20 OctoInference ticks, the first sample against the CPU's. Each
   model's steps are timed (CUDA events) and traced once (device busy,
   kernels, idle share, peak GiB; the CLIP, EfficientNet and SigLIP steps
   untraced).
13. Entry phase: hypervla_tpu_torch/entry.py::entry(), the counterpart of
   __graft_entry__.py::entry(), at full width on the card (the flagship
   of build_flagship() with no arguments: fp32 trunk, the config's own
   switches), then its fn on its example args: a finite (1, 4, 7) action
   chunk, no launch of any of the ten kernel rows' wrappers (the path
   runs none), and the same fn on the CPU, params and inputs copied over,
   within 1e-4 (fp32, TF32 off). fn, its hypernetwork half and its
   base-net half are each timed (the median of 10 calls, CUDA events) and
   traced once (device busy, kernels, idle share).
Every phase prints its seconds as `phase <name> s <seconds>`.

The kernels redesigned for Hopper, the training attention (forward and
backward on the bf16 tensor cores), the layer and trunk GEMM (a pipelined
`wgmma` kernel), the layer backward's A^T.B weight gradients (`wgmma` on
MN-major operands, the rows split over blocks and finished in order), the
flash attention, the serving trunk's attention (bf16 tensor cores, four key
warps a row warp), the LayerNorm forward and backward and the residual add
+ LayerNorm and the one-pass LayerNorm (a warp per row), the column sum,
the LayerScale and the GELU backward passes (16-byte loads, a block a
256-column strip of a row range) and the GELU (64 bytes in flight a thread,
erfc by a Chebyshev fit), are
also run twice and compared bit for bit, at every
GEMM shape of the serving trunk and of the training layer (every epilogue,
both layouts of the weight); at M = 16448 the rows of the ragged last row
tile are checked on their own, and a row past M, poisoned before the launch,
is found untouched after it; the weight gradients also at M = 16485 and 99.

Beside each kernel's time the script prints the least time the card could
take for the same work (the larger of bytes moved over 3.35 TB/s and
operations over the peak rate for their type: 989 TFLOP/s bf16 on the
tensor cores, 67 TFLOP/s fp32) and, where one PyTorch call computes the
same function (torch.matmul, F.layer_norm, F.gelu,
F.scaled_dot_product_attention, a sum), that call's time: a yardstick that
the port never calls. `ms` is CUDA events around back-to-back calls, which
for a kernel of a few microseconds is the rate its wrapper launches at;
`device_ms` is the kernels' own device time over the same calls, from a
torch.profiler trace.

Each serving step and each train configuration is also traced once with
torch.profiler: its device busy time (the sum of its kernels' device time)
and kernel count beside the unprofiled step time, i.e. the device's idle
share.

Prints the card's name and power limit, the per-phase results, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed check raises and exits non-zero
without that line. Needs a CUDA device: exits non-zero without one.
"""
import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

STEPS = 50
SEED = 0
HOST_STEPS = 5        # host-path steps held against the fused step
SERVE_CKPT_STEP = 1   # the step directory the server phase saves
SCAN_K = 8            # ticks a call of the K-tick step
SCAN_FRAMES = 48      # frames through the K-tick step
TASKS = 4             # tasks a tick of the multi-task step
MULTI_TICKS = 5
SOURCES = ("dino_layer.cu", "fused_attention.cu", "layer_backward.cu",
           "row_kernels.cu", "flash_attention.cu", "flash_attention_train.cu")
# the slowest source to build by far, which no phase before the row and
# flash kernel phase launches
LATE_SOURCE = "flash_attention_train.cu"
TRUNK_SOURCE = "hypervla_tpu_torch/csrc/dino_layer.cu"
TPU_KERNEL = "hypervla_tpu/ops/dino_layer.py:87"  # `_kernel`, the Pallas body
# the training kernels: (source, the Pallas body each replaces)
TRAIN_KERNELS = {
    "mha_fused_train_fwd": ("hypervla_tpu_torch/csrc/fused_attention.cu",
                            "hypervla_tpu/ops/fused_attention.py:49"),
    "mha_fused_train_bwd": ("hypervla_tpu_torch/csrc/fused_attention.cu",
                            "hypervla_tpu/ops/fused_attention.py:78"),
    "dino_layer_train_fwd": ("hypervla_tpu_torch/ops/dino_layer_train.py",
                             "hypervla_tpu/ops/dino_layer_train.py:139"),
    "dino_layer_train_fwd_res": (
        "hypervla_tpu_torch/ops/dino_layer_train.py",
        "hypervla_tpu/ops/dino_layer_train.py:139"),
    "dino_layer_train_bwd": ("hypervla_tpu_torch/ops/dino_layer_train.py",
                             "hypervla_tpu/ops/dino_layer_train.py:188"),
    "layer_norm_pallas_fwd": ("hypervla_tpu_torch/csrc/dino_layer.cu",
                              "hypervla_tpu/ops/layer_norm.py:201"),
    "layer_norm_pallas_bwd": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                              "hypervla_tpu/ops/layer_norm.py:211"),
    # the launches a layer's backward adds to the forward's kernels
    "dino_gemm_train": ("hypervla_tpu_torch/csrc/dino_layer.cu",
                        "hypervla_tpu/ops/dino_layer_train.py:188"),
    "layer_gemm_tn": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                      "hypervla_tpu/ops/dino_layer_train.py:188"),
    "layer_norm_bwd_rows": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                            "hypervla_tpu/ops/dino_layer_train.py:82"),
    "layer_scale_grad": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                         "hypervla_tpu/ops/dino_layer_train.py:216"),
    "layer_gelu_bwd": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                       "hypervla_tpu/ops/dino_layer_train.py:90"),
    "layer_colsum": ("hypervla_tpu_torch/csrc/layer_backward.cu",
                     "hypervla_tpu/ops/dino_layer_train.py:289"),
}
# the forward-only serving kernels, the fused residual boundaries and the
# fused GELU: (source, the Pallas body each replaces)
ROW_SOURCE = "hypervla_tpu_torch/csrc/row_kernels.cu"
ROW_FLASH_KERNELS = {
    "flash_attention": ("hypervla_tpu_torch/csrc/flash_attention.cu",
                        "hypervla_tpu/ops/flash_attention.py:22"),
    "layer_norm": (ROW_SOURCE, "hypervla_tpu/ops/layer_norm.py:17"),
    "fused_add_ln_fwd": (ROW_SOURCE, "hypervla_tpu/ops/add_layer_norm.py:57"),
    "fused_add_ln_bwd": (ROW_SOURCE, "hypervla_tpu/ops/add_layer_norm.py:70"),
    "fused_add_scale_ln_fwd": (ROW_SOURCE,
                               "hypervla_tpu/ops/add_layer_norm.py:207"),
    "fused_add_scale_ln_bwd": (ROW_SOURCE,
                               "hypervla_tpu/ops/add_layer_norm.py:221"),
    "gelu_exact_fused": (ROW_SOURCE, "hypervla_tpu/ops/gelu.py:63"),
    # no Pallas kernel: the JAX function calls jax's library flash attention
    # on a TPU and runs the einsum attention elsewhere
    "mha_flash_trainable_fwd": (
        "hypervla_tpu_torch/csrc/flash_attention_train.cu",
        "hypervla_tpu/ops/flash_attention.py:124"),
    "mha_flash_trainable_bwd": (
        "hypervla_tpu_torch/csrc/flash_attention_train.cu",
        "hypervla_tpu/ops/flash_attention.py:124"),
    # the same entry points on fp32 tensors: the fp32 kernels
    "mha_flash_trainable_fwd_fp32": (
        "hypervla_tpu_torch/csrc/flash_attention_train.cu",
        "hypervla_tpu/ops/flash_attention.py:124"),
    "mha_flash_trainable_bwd_fp32": (
        "hypervla_tpu_torch/csrc/flash_attention_train.cu",
        "hypervla_tpu/ops/flash_attention.py:124"),
}
# the card's published peaks (H100 SXM): device memory, dense bf16 on the
# tensor cores, fp32 outside them
PEAK_BYTES, PEAK_BF16, PEAK_FP32 = 3.35e12, 989e12, 67e12
# the differentiable flash attention's fp32 route: each fp32 product is six
# bf16 term products on the tensor cores
PEAK_FP32_SPLIT = PEAK_BF16 / 6
# kernel-vs-plain bounds: one bf16 ulp of the output scale for one kernel
# launch; the bounds the JAX package holds between its own trunks for the
# 12-layer trunk and for the actions
ULP_BOUND = 2 ** -7
TRUNK_BOUND = 0.05
# the attention backward rounds ds to bf16 between two products; one
# composed layer is seven launches
GRAD_BOUND = 2 ** -5
LAYER_BOUND = 2 ** -6
# the train phase: batch, steps, and the bounds the JAX package holds
# between its own trunks (tests/test_layer_kernel_train_step.py)
TRAIN_BATCH = 64
# calls of a kernel traced for its device time
PROFILED_CALLS = 10
# device ms of the first versions of the kernels redesigned since (each
# with its finishing launch; their last full runs, NVIDIA H100 80GB HBM3,
# 700 W), logged beside the new ones: the first versions are gone, or kept
# only for the widths the new kernels do not take
FIRST_VERSION_DEVICE_MS = {"layer_colsum (16448, 2304)": 0.0455,
                           "gelu_exact_fused (64, 257, 3072) bf16": 0.0962,
                           "layer_gelu_bwd (16448, 3072)": 0.2135,
                           "fused_add_scale_ln_fwd (16448, 768)": 0.0546,
                           "fused_add_scale_ln_bwd (16448, 768)": 0.2176,
                           "fused_add_ln_fwd (16448, 768)": 0.0495,
                           "fused_add_ln_bwd (16448, 768)": 0.1868,
                           "layer_scale_grad (16448, 768)": 0.0379}
TRAIN_WARMUP, TRAIN_STEPS = 2, 4
#: the trainer phase: the command line's config and data, and its runs
TRAINER_CONFIG = "vit_t,oxe,fast"
TRAINER_BATCH = 64
TRAINER_FRAME = 256
TRAINER_DATASETS = 2
TRAINER_TRAJS, TRAINER_TRAJ_LEN = 8, 20
TRAINER_STEPS, TRAINER_SAVE_EVERY, TRAINER_RESUME_TO = 6, 3, 7
TRAINER_AUG_STEPS = 2
TRAINER_SHUFFLE = 256
TRAINER_SERVED = 5
#: half of them the drawer tasks whose losses the trainer logs apart
TRAINER_TASKS = (b"close top drawer", b"pick up the coke can",
                 b"close bottom drawer", b"move the sponge near the apple")
TRAINER_AUGMENT = dict(
    augment_order=["random_resized_crop", "random_brightness",
                   "random_contrast", "random_saturation", "random_hue"],
    random_resized_crop=dict(scale=[0.8, 1.0], ratio=[0.9, 1.1]),
    random_brightness=[0.1], random_contrast=[0.9, 1.1],
    random_saturation=[0.9, 1.1], random_hue=[0.05])
#: the fine-tune phase: the JAX package's fine-tune config (as a user's
#: config file returns it, with the fast preset) warm-started from the
#: trainer phase's step-TRAINER_STEPS EMA params, on the same fixture mix
FINETUNE_MODE = "head_only"
FINETUNE_STEPS, FINETUNE_ACCUMULATION = 4, 2
#: the delta-decay check's base_weight_decay (the JAX package's test's)
DELTA_DECAY = 0.25
# the layer backward: cosine per output against the plain version (the JAX
# package holds its kernel to 0.99 per leaf, tests/test_dino_layer_train.py)
GRAD_COSINE_BOUND = 0.999
STEP_REL_BOUND = 0.02
COSINE_BOUND = 0.98


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, iters):
    """Mean device ms per call of fn over `iters` calls (CUDA events)."""
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


def interleaved(kernel_fn, plain_fn, iters):
    """(kernel ms, plain ms), timed in turns: plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, iters)
    k1 = cuda_ms(kernel_fn, iters)
    k2 = cuda_ms(kernel_fn, iters)
    p2 = cuda_ms(plain_fn, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def _trace(fn, calls, host=True):
    """{device kernel: (mean device us a launch, launches a call)} from one
    torch.profiler trace of `calls` identical calls of fn; host=False
    records the device's activity alone (the trace of a step's ~18,000
    kernels is then read in a fraction of the time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    # a trace often lacks the record of a launch or two: each kernel's mean
    # time over the records that are there, times its launches a call (the
    # records over the calls, rounded)
    return {e.key: (e.self_device_time_total / e.count,
                    max(1, round(e.count / calls)))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count > 0}


#: the pauses (s) before each retrace of a trace that came back without its
#: device records; the profiler has lost up to four traces in a row
PROFILER_RETRY_PAUSES = (0.5, 1.0, 2.0, 4.0, 8.0)
#: the one key of a trace the profiler lost every time: CUDA events' time
EVENTS_KEY = "(CUDA events: the profiler saw no device time)"


class ProfilerLost(AssertionError):
    """Every trace of a function came back without its device records."""


def _device_trace(fn, calls, host=True, events_fallback=True):
    """_trace, taken again after a pause where it comes back without its
    device records (now and then one does, and on some hosts a few in a
    row). Where every retrace is empty too, {EVENTS_KEY: (us a call, 1)}
    from CUDA events around the same calls, or, for a caller that reads
    the kernels' names (events_fallback=False), ProfilerLost."""
    for attempt, pause in enumerate((0.0,) + PROFILER_RETRY_PAUSES):
        if pause:
            time.sleep(pause)
        per_call = _trace(fn, calls, host)
        if sum(mean_us * n for mean_us, n in per_call.values()) > 0:
            return per_call
        log(f"profiler: trace {attempt + 1} of {calls} calls held no device "
            "time")
    if not events_fallback:
        raise ProfilerLost("the profiler saw no device time")
    ms = cuda_ms(fn, calls)
    log(f"profiler: {len(PROFILER_RETRY_PAUSES) + 1} traces held no device "
        f"time; {ms:.6g} ms a call from CUDA events instead")
    return {EVENTS_KEY: (ms * 1e3, 1)}


def device_busy(fn, calls=1, host=True):
    """(device busy ms, device kernels) per call of fn, from a
    torch.profiler trace of `calls` identical calls: the sum of the kernels'
    own device time (one stream, so they do not overlap). Where the
    profiler lost every trace, the CUDA events' ms a call and nan kernels."""
    per_call = _device_trace(fn, calls, host)
    if EVENTS_KEY in per_call:
        return per_call[EVENTS_KEY][0] / 1e3, math.nan
    return (sum(mean_us * n for mean_us, n in per_call.values()) / 1e3,
            sum(n for _, n in per_call.values()))


def kernel_device_ms(fn, calls, events_fallback=True):
    """{kernel name: device ms per call of fn}, each device kernel apart (a
    pass and its finishing launch), from two traces of `calls` calls that
    agree (the same kernels and launches, total times within a quarter): a
    trace now and then comes back without any of one kernel's records,
    which a single trace cannot tell from a faster function. Each new trace
    is held against every earlier one (the profiler has been seen to
    alternate between a whole and a halved reading), up to six; where none
    agree, the longest. Where the profiler lost every trace, {EVENTS_KEY:
    ms}. With events_fallback False, either of these raises ProfilerLost."""
    def total(per):
        return sum(mean_us * n for mean_us, n in per.values())

    def agree(a, b):
        return ({k: n for k, (_, n) in a.items()}
                == {k: n for k, (_, n) in b.items()}
                and abs(total(a) - total(b)) <= 0.25 * max(total(a), total(b)))

    def by_name(cur, prev):
        out = {}
        for key in cur:
            name = (key if key == EVENTS_KEY
                    else key.removeprefix("void ").split("(")[0])
            out[name] = out.get(name, 0.0) + (
                cur[key][0] * cur[key][1] + prev[key][0] * prev[key][1]) / 2e3
        return out

    traces = [_device_trace(fn, calls, events_fallback=events_fallback)]
    for _ in range(5):
        cur = _device_trace(fn, calls, events_fallback=events_fallback)
        prev = next((t for t in traces if agree(t, cur)), None)
        if prev is not None:
            out = {}
            return by_name(cur, prev)
        log(f"profiler: trace {len(traces) + 1} ({total(cur) / 1e3:.6g} ms "
            f"in {len(cur)} kernels) agrees with no earlier one ("
            + ", ".join(f"{total(t) / 1e3:.6g}" for t in traces)
            + " ms); tracing again")
        traces.append(cur)
    if not events_fallback:
        raise ProfilerLost("no two of six profiler traces agree")
    # a lost record only shortens a trace: the longest is the most whole
    whole = max(traces, key=total)
    log(f"profiler: no two of six traces agree; the longest "
        f"({total(whole) / 1e3:.6g} ms) taken")
    return by_name(whole, whole)


def confirmed_device_ms(fn, calls):
    """Device ms per call of fn: its kernels' summed kernel_device_ms."""
    return sum(kernel_device_ms(fn, calls).values())


def bound_ms(nbytes, flops, peak=PEAK_BF16):
    """The least time the card could take: (ms, what sets it), the larger
    of the bytes moved over the memory rate and the operations over the
    peak rate for their type."""
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, flops / peak * 1e3
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class KernelTable:
    """Each kernel's times beside its bound. `add` times one call of a
    kernel in turns with its plain version, the one PyTorch call for the
    same function where there is one, and the kernel's device time from a
    profiler trace of the same calls; calls under one name add up (one
    layer's launches of that kernel). `rows` gives, per name, the keys the
    {"kernels": [...]} line carries."""

    def __init__(self):
        self._rows = {}

    def add(self, name, label, err, kernel_fn, plain_fn, iters, cost,
            library=None):
        """cost: (bytes moved, operations, the peak rate of their type)."""
        k_ms, p_ms = interleaved(kernel_fn, plain_fn, iters)
        lib_ms = cuda_ms(library, iters) if library else None
        # the same calls under the profiler: the kernels' own device time,
        # where `ms` of a short kernel is the rate its wrapper launches at
        calls = min(iters, PROFILED_CALLS)
        dev_ms = confirmed_device_ms(kernel_fn, calls)
        lib_dev = confirmed_device_ms(library, calls) if library else None
        least, by = bound_ms(*cost)

        def fmt(ms):
            return "none" if ms is None else format(ms, ".6g")

        log(f"kernel {name} {label}: ms {k_ms:.6g} device_ms {dev_ms:.6g} "
            f"plain_ms {p_ms:.6g} library_ms {fmt(lib_ms)} "
            f"library_device_ms {fmt(lib_dev)} bound_ms {least:.6g} ({by})")
        r = self._rows.setdefault(name, {
            "max_abs_err": 0.0, "ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0,
            "library_ms": None, "library_device_ms": None, "bytes": 0.0,
            "ops": 0.0, "peak": cost[2]})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += k_ms
        r["device_ms"] += dev_ms
        r["plain_ms"] += p_ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms
            r["library_device_ms"] = ((r["library_device_ms"] or 0.0)
                                      + lib_dev)
        r["bytes"] += cost[0]
        r["ops"] += cost[1]

    def log_rows(self, where):
        """Logs each name's summed row, labelled `where`; returns rows()."""
        results = self.rows()
        for name, r in results.items():
            log(f"kernel {name}{where}: " + " ".join(
                f"{key} {'none' if r[key] is None else format(r[key], '.6g')}"
                for key in ("ms", "device_ms", "plain_ms", "library_ms",
                            "library_device_ms", "bound_ms"))
                + f" ({r['bound_by']})")
        return results

    def rows(self):
        out = {}
        for name, r in self._rows.items():
            least, by = bound_ms(r["bytes"], r["ops"], r["peak"])
            out[name] = {key: r[key] for key in (
                "max_abs_err", "ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms")}
            out[name].update(bound_ms=least, bound_by=by)
        return out


def bf16_ulps(got, ref):
    """|got - ref| elementwise in bf16 spacings at ref's value (2^-133, the
    subnormal spacing, at and below the smallest normal); NaN where both
    are NaN counts 0 (the caller checks that the NaNs agree)."""
    import torch

    g, r = got.double(), ref.double()
    mag = r.abs().clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((g - r).abs() / ulp).nan_to_num(0.0)


def max_err(got, ref):
    import torch

    if not torch.isfinite(got.float()).all():
        raise AssertionError("non-finite kernel output")
    return ((got.float() - ref.float()).abs().max().item(),
            ref.float().abs().max().item())


def kernel_phase(device):
    """Checks and times every trunk kernel at the flagship's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import dino_layer as dl

    seq, hidden, layers = 257, 768, 12
    rng = np.random.default_rng(SEED)

    def t(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    x = t(rng.standard_normal((seq, hidden)) * 0.5, torch.bfloat16)
    w = t(rng.standard_normal((layers, 3, hidden, 4 * hidden)) * 0.02,
          torch.bfloat16)
    b = t(rng.standard_normal((layers, 3, 4 * hidden)) * 0.02)
    p = t(np.concatenate([
        1 + 0.1 * rng.standard_normal((layers, 1, hidden)),
        0.1 * rng.standard_normal((layers, 1, hidden)),
        1 + 0.1 * rng.standard_normal((layers, 1, hidden)),
        0.1 * rng.standard_normal((layers, 1, hidden)),
        0.1 + 0.02 * rng.standard_normal((layers, 2, hidden)),
    ], axis=1))
    h_in = t(rng.standard_normal((seq, 4 * hidden)) * 0.5, torch.bfloat16)
    qkv = t(rng.standard_normal((seq, 3 * hidden)) * 2.0, torch.bfloat16)
    hd = hidden

    def gemm_cost(a, w_t, *extra):
        m, k = a.shape
        n = w_t.numel() // k
        return nbytes(a, w_t, *extra) + 2 * m * n, 2 * m * n * k, PEAK_BF16

    def ln_case(label, s_row, b_row):
        sc, bi = p[0, s_row], p[0, b_row]
        sc16, bi16 = sc.bfloat16(), bi.bfloat16()
        return (label, dl.layer_norm_rows, dl.layer_norm_rows_reference,
                (x, sc, bi, 1e-6),
                lambda: F.layer_norm(x, (hidden,), sc16, bi16, 1e-6),
                (nbytes(x, x, sc, bi), 8 * x.numel(), PEAK_FP32))

    w_qkv, w_o = w[0, 0, :, :3 * hd], w[0, 0, :, 3 * hd:]
    heads = hidden // 64
    q4, k4, v4 = (qkv[:, i * hd:(i + 1) * hd].reshape(seq, heads, 64)
                  .transpose(0, 1)[None] for i in range(3))
    # one layer's launches of each kernel, as the trunk makes them:
    # (label, kernel, plain, args, the one PyTorch call, (bytes, ops, peak))
    cases = {
        "dino_layer_norm": [ln_case("ln1", dl.LN1_S, dl.LN1_B),
                            ln_case("ln2", dl.LN2_S, dl.LN2_B)],
        "dino_gemm": [
            ("qkv [257,768]x[768,2304]", dl.gemm, dl.gemm_reference,
             (x, w_qkv, b[0, 0, :3 * hd]), lambda: x @ w_qkv,
             gemm_cost(x, w_qkv, b[0, 0, :3 * hd])),
            ("out-proj [257,768]x[768,768] +residual", dl.gemm,
             dl.gemm_reference, (x, w_o, b[0, 0, 3 * hd:], "residual", x,
                                 p[0, dl.LS1]), lambda: x @ w_o,
             gemm_cost(x, w_o, b[0, 0, 3 * hd:], x, p[0, dl.LS1])),
            ("fc1 [257,768]x[768,3072] +gelu", dl.gemm, dl.gemm_reference,
             (x, w[0, 1], b[0, 1], "gelu"), lambda: x @ w[0, 1],
             gemm_cost(x, w[0, 1], b[0, 1])),
            ("fc2 [257,3072]x[768,3072]^T +residual", dl.gemm,
             dl.gemm_reference, (h_in, w[0, 2], b[0, 2, :hd], "residual", x,
                                 p[0, dl.LS2], True),
             lambda: h_in @ w[0, 2].t(),
             gemm_cost(h_in, w[0, 2], b[0, 2, :hd], x, p[0, dl.LS2])),
        ],
        "dino_attention": [
            ("12 heads x 257 tokens", dl.attention, dl.attention_reference,
             (qkv,), lambda: F.scaled_dot_product_attention(q4, k4, v4),
             (nbytes(qkv) + 2 * seq * hd, 4 * seq * seq * hd, PEAK_BF16)),
        ],
    }
    table = KernelTable()
    for name, calls in cases.items():
        for label, kern, plain, args, library, cost in calls:
            got = kern(*args)
            torch.cuda.synchronize()
            err, scale = max_err(got, plain(*args))
            bound = ULP_BOUND * max(scale, 1.0)
            note = ""
            if name == "dino_gemm":
                a, w_t = args[0], args[1]
                cfg = dl.gemm_config(a.shape[0], w_t.numel() // a.shape[1],
                                     a.shape[1])
                note = (f"; tile {cfg.block_m}x{cfg.block_n}, split-K "
                        f"{cfg.split_k}")
            log(f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
                f"{bound:.6g}); a second run is bit-equal{note}")
            if not err <= bound:
                raise AssertionError(f"{name} {label}: {err} > {bound}")
            if not torch.equal(got, kern(*args)):
                raise AssertionError(f"{name} {label}: two runs differ")
            table.add(name, label, err, lambda: kern(*args),
                      lambda: plain(*args), 200, cost, library)

    got = dl.dino_layers_serving(x, w, b, p)
    torch.cuda.synchronize()
    err, scale = max_err(got, dl.dino_layers_serving_reference(x, w, b, p))
    bound = TRUNK_BOUND * max(scale, 1.0)
    log(f"kernel dino_layers_serving 12 layers: max_abs_err {err:.6g} "
        f"(bound {bound:.6g})")
    if not err < bound:
        raise AssertionError(f"12-layer trunk: {err} >= {bound}")
    # each input read once, the output written once; per layer the four
    # GEMMs and the attention products
    trunk_ops = layers * (2 * seq * hidden * 12 * hidden
                          + 4 * seq * seq * hidden)
    table.add("dino_layers_serving", "12 layers", err,
              lambda: dl.dino_layers_serving(x, w, b, p),
              lambda: dl.dino_layers_serving_reference(x, w, b, p), 20,
              (nbytes(x, w, b, p, x), trunk_ops, PEAK_BF16))
    results = table.log_rows(" at bs=1, a layer's launches (the trunk: 12 "
                             "layers)")
    weight_bytes = w.numel() * 2
    trunk_ms = results["dino_layers_serving"]["ms"]
    log(f"trunk weights {weight_bytes / 1e6:.1f} MB; kernel trunk reads them "
        f"at {weight_bytes / (trunk_ms * 1e-3) / 1e9:.1f} GB/s effective")
    return results


def redesign_phase(device):
    """The redesigned kernels over the shapes their first versions go wrong
    at: the serving trunk's tensor-core attention (ragged last query and key
    tiles, one and twelve heads, a hundred random draws), the warp-per-row
    LayerNorm forward and backward (every type combination, a row count that
    is no multiple of a block's rows, a shifted input, a batch against its
    two halves), the one-pass serving LayerNorm a warp per row and the
    layer backward's LayerScale pass, each against its plain version and
    twice for the same bits. Times the LayerNorm kernels beside the first
    versions they replaced."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import layer_norm as tln

    rng = np.random.default_rng(SEED + 4)

    def t(shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return torch.tensor(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32),
            dtype=dtype, device=device)

    def held(name, got, ref, bound):
        err, scale = max_err(got, ref)
        limit = bound * max(scale, 1.0)
        if not err <= limit:
            raise AssertionError(f"{name}: {err} > {limit}")
        return err / limit

    def unaligned(a):
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=device)[1:]
        return flat.view(a.shape).copy_(a)

    # ---- kernel 1's attention: one bf16 ulp of the output scale ----
    worst = 0.0
    for seq in (257, 1, 16, 17, 64, 300):
        for hidden in (64, 128, 768):
            qkv = t((seq, 3 * hidden), scale=2.0)
            name = f"dino_attention S={seq} hidden={hidden}"
            got = dl.attention(qkv)
            torch.cuda.synchronize()
            worst = max(worst, held(name, got, dl.attention_reference(qkv),
                                    ULP_BOUND))
            if not torch.equal(got, dl.attention(qkv)):
                raise AssertionError(f"{name}: two runs differ")
    log("kernel dino_attention S in (257, 1, 16, 17, 64, 300) x hidden in "
        f"(64, 128, 768): within one bf16 ulp (worst {worst:.3f} of the "
        "bound), two runs bit-equal")
    # over random draws at the serving shape: the tensor cores' fp32 sums
    # differ from the plain version's in their last bits, which rounds a
    # score at the midpoint of two bf16 values to the other neighbour; where
    # that score leads its row the row moves by more than an ulp. Every row
    # (a query of a head) holds one ulp of the plain version, or of the plain
    # version recomputed with the other neighbour of such a score
    draws, outright, rows_over, worst = 100, 0, 0, 0.0
    for _ in range(draws):
        qkv = t((257, 2304), scale=2.0)
        got, ref = dl.attention(qkv), dl.attention_reference(qkv).float()
        scale = max(float(ref.abs().max()), 1.0)
        over, unexplained = dl.attention_unexplained_rows(qkv, got,
                                                          ULP_BOUND * scale)
        if unexplained:
            raise AssertionError(
                f"dino_attention: {unexplained} of {over} rows over one ulp "
                "that no score at a rounding midpoint explains")
        outright += over == 0
        rows_over += over
        worst = max(worst, float((got.float() - ref).abs().max()) / scale)
    log(f"kernel dino_attention over {draws} draws of std-2 inputs at 12 "
        f"heads x 257 tokens: {outright} hold one bf16 ulp outright; "
        f"{rows_over} of {draws * 12 * 257} rows over it (worst error "
        f"{worst:.4g} of the output scale), each within one ulp of the plain "
        "version with a midpoint score rounded to its other neighbour")
    heads, blocks = dl.attention_grid(12, 257)
    log(f"kernel dino_attention 12 heads x 257 tokens: grid ({heads}, "
        f"{blocks}) of {dl.attention_warps(12, 257)} row warps x 4 key warps")

    # ---- kernel 6: the LayerNorm forward and backward, a warp per row ----
    hidden = 768
    scale = t((hidden,), torch.float32, 0.1, 1.0)
    bias = t((hidden,), torch.float32, 0.1)
    modes = {"layer": (torch.bfloat16, torch.float32, True),
             "bf16": (torch.bfloat16, torch.bfloat16, False),
             "fp32": (torch.float32, torch.float32, False)}
    worst_f = worst_b = 0.0
    for rows in (TRAIN_BATCH * 257, 257, 1001):
        for shift in (0.0, 1.0):
            x32 = t((rows, hidden), torch.float32, 0.5, shift)
            g32 = t((rows, hidden), torch.float32)
            res = t((rows, hidden))
            for dtype in (torch.bfloat16, torch.float32):
                x = x32.to(dtype)
                name = f"layer_norm_rows ({rows}, {hidden}) {dtype} +{shift}"
                if dl.layer_norm_plan(rows, hidden, x).chunks != 3:
                    raise AssertionError(f"{name}: not the warp-per-row "
                                         "kernel")
                got = dl.layer_norm_rows(x, scale, bias, 1e-6)
                torch.cuda.synchronize()
                bound = ULP_BOUND if dtype == torch.bfloat16 else 1e-5
                worst_f = max(worst_f, held(
                    name, got,
                    dl.layer_norm_rows_reference(x, scale, bias, 1e-6),
                    bound))
                if not torch.equal(got, dl.layer_norm_rows(x, scale, bias,
                                                           1e-6)):
                    raise AssertionError(f"{name}: two runs differ")
            for mode, (tx, tg, with_res) in modes.items():
                args = (x32.to(tx), g32.to(tg), scale, 1e-6,
                        res if with_res else None)
                name = f"layer_norm_bwd_rows ({rows}, {hidden}) {mode} +{shift}"
                got = tln.layer_norm_bwd_rows(*args)
                torch.cuda.synchronize()
                ref = tln.layer_norm_bwd_rows_reference(*args)
                bounds = (ULP_BOUND if tx == torch.bfloat16 else 1e-5, 1e-4,
                          1e-4)
                worst_b = max(worst_b, *(held(name, a, b, bound) for a, b,
                                         bound in zip(got, ref, bounds)))
                again = tln.layer_norm_bwd_rows(*args)
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    raise AssertionError(f"{name}: two runs differ")
                if rows % 2 == 0:
                    # the rows are dealt to the warps of the grid in turn, so
                    # a batch's sums are its halves' in another order
                    half = rows // 2
                    parts = [tln.layer_norm_bwd_rows(
                        args[0][sl], args[1][sl], scale, 1e-6,
                        res[sl] if with_res else None)
                        for sl in (slice(0, half), slice(half, rows))]
                    for full, a, b in zip(got[1:], parts[0][1:],
                                          parts[1][1:]):
                        worst_b = max(worst_b, held(
                            name + " against two halves", full, a + b, 1e-4))
    log("kernel layer_norm_rows / layer_norm_bwd_rows at (16448 | 257 | 1001, "
        "768), bf16 and fp32 forward, the three type combinations backward, "
        "inputs shifted by 0 and 1: within the bounds (forward worst "
        f"{worst_f:.3f}, backward worst {worst_b:.3f} of them; column sums "
        "1e-4, a batch's within 1e-4 of its halves'), two runs bit-equal")
    # the widths the warp-per-row kernels do not take keep the first kernels
    for rows, d in ((300, 2048), (68, 100)):
        x, g = t((rows, d), scale=0.5, shift=0.3), t((rows, d))
        sc, bi = t((d,), torch.float32, 0.1, 1.0), t((d,), torch.float32, 0.1)
        if (dl.layer_norm_plan(rows, d, x).chunks
                or tln.layer_norm_bwd_plan(rows, d, x).chunks):
            raise AssertionError(f"width {d} took the warp-per-row kernel")
        held(f"layer_norm_rows ({rows}, {d})",
             dl.layer_norm_rows(x, sc, bi, 1e-6),
             dl.layer_norm_rows_reference(x, sc, bi, 1e-6), ULP_BOUND)
        for a, b, bound in zip(
                tln.layer_norm_bwd_rows(x, g, sc, 1e-6),
                tln.layer_norm_bwd_rows_reference(x, g, sc, 1e-6),
                (ULP_BOUND, 1e-4, 1e-4)):
            held(f"layer_norm_bwd_rows ({rows}, {d})", a, b, bound)
    log("kernel layer_norm_rows / layer_norm_bwd_rows at widths 2048 and 100: "
        "the block-per-row forward and the block-walk backward, within "
        "their bounds")

    # beside what they replaced, at the training and the serving shape: rows
    # that do not start at a multiple of 16 bytes take the first kernels
    for rows in (TRAIN_BATCH * 257, 257):
        x, g32, res = t((rows, hidden), scale=0.5), t(
            (rows, hidden), torch.float32), t((rows, hidden))
        g16, x_odd = g32.bfloat16(), unaligned(x)
        if (dl.layer_norm_plan(rows, hidden, x_odd).chunks
                or tln.layer_norm_bwd_plan(rows, hidden, x_odd).chunks
                or not dl.layer_norm_plan(rows, hidden, x).chunks):
            raise AssertionError("unaligned rows took the warp-per-row kernel")
        line = {}
        for label, fn in (
                ("forward", lambda x: dl.layer_norm_rows(
                    x, scale, bias, 1e-6)),
                ("backward bf16", lambda x: tln.layer_norm_bwd_rows(
                    x, g16, scale, 1e-6)),
                ("backward layer form", lambda x: tln.layer_norm_bwd_rows(
                    x, g32, scale, 1e-6, res))):
            line[label] = (
                confirmed_device_ms(lambda: fn(x), PROFILED_CALLS),
                confirmed_device_ms(lambda: fn(x_odd), PROFILED_CALLS))
        log(f"kernel LayerNorm ({rows}, {hidden}) device_ms, warp-per-row "
            "(first version, on unaligned rows; the backward's with the "
            "split finishing launch): " + ", ".join(
                f"{label} {new:.6g} ({was:.6g})"
                for label, (new, was) in line.items())
            + f"; grids forward {tuple(dl.layer_norm_plan(rows, hidden, x))} "
            f"backward {tuple(tln.layer_norm_bwd_plan(rows, hidden, x))}")

    # ---- kernel 5, the one-pass serving LayerNorm, a warp per row ----
    bf16, f32 = torch.bfloat16, torch.float32
    worst = 0.0
    for rows, d in ((257, 768), (1, 768), (TRAIN_BATCH * 257, 768),
                    (31, 1024)):
        for shift in (0.0, 100.0):
            x32 = t((rows, d), f32, 2.0, shift)
            for dtype, vdt in ((bf16, bf16), (bf16, f32), (f32, bf16),
                               (f32, f32)):
                x = x32.to(dtype)
                sc, bi = t((d,), vdt, 0.1, 1.0), t((d,), vdt, 0.1)
                name = (f"layer_norm ({rows}, {d}) x {str(dtype)[6:]} "
                        f"vectors {str(vdt)[6:]} +{shift}")
                if (tln.layer_norm_plan(rows, d, x, sc, bi).chunks
                        != (3 if d <= 768 else 4)):
                    raise AssertionError(f"{name}: not the warp-per-row "
                                         "kernel")
                got = tln.layer_norm(x, sc, bi, 1e-6)
                torch.cuda.synchronize()
                worst = max(worst, held(
                    name, got, tln.layer_norm_reference(x, sc, bi, 1e-6),
                    ULP_BOUND if dtype == bf16 else 1e-5))
                if not torch.equal(got, tln.layer_norm(x, sc, bi, 1e-6)):
                    raise AssertionError(f"{name}: two runs differ")
    log("kernel layer_norm (a warp per row) at (257 | 1 | 16448, 768) and "
        "(31, 1024), x and its vectors bf16 and fp32, inputs shifted by 0 "
        f"and 100: within the bounds (worst {worst:.3f} of them), two runs "
        "bit-equal")
    # unaligned rows and the widths the warp-per-row kernel does not take
    # keep the first kernel: the trace names the kernel that ran
    for label, rows, d in (("rows off a 16-byte boundary", 257, 768),
                           ("width 2048", 65, 2048), ("width 100", 68, 100)):
        x = t((rows, d), bf16, 2.0, 100.0)
        if rows == 257:
            x = unaligned(x)
        sc, bi = t((d,), bf16, 0.1, 1.0), t((d,), bf16, 0.1)
        if tln.layer_norm_plan(rows, d, x, sc, bi).chunks:
            raise AssertionError(f"layer_norm {label}: the warp-per-row "
                                 "kernel")
        ran = kernel_device_ms(lambda: tln.layer_norm(x, sc, bi, 1e-6), 2,
                               events_fallback=False)
        if [k.split("<")[0] for k in ran] != ["layer_norm_two_pass_kernel"]:
            raise AssertionError(f"layer_norm {label}: ran {list(ran)}")
        got = tln.layer_norm(x, sc, bi, 1e-6)
        held(f"layer_norm {label}", got,
             tln.layer_norm_reference(x, sc, bi, 1e-6), ULP_BOUND)
        if not torch.equal(got, tln.layer_norm(x, sc, bi, 1e-6)):
            raise AssertionError(f"layer_norm {label}: two runs differ")
    log("kernel layer_norm on rows off a 16-byte boundary and at widths 2048 "
        "and 100: the first kernel (layer_norm_two_pass_kernel in the "
        "trace), within its bound, two runs bit-equal")
    # at the serving shape, in one trace: the new kernel, the first (on
    # unaligned rows), kernel 6's forward (fp32 vectors) and F.layer_norm
    x = t((1, 257, hidden), scale=0.5, shift=0.3)
    sc, bi = t((hidden,), bf16, 0.1, 1.0), t((hidden,), bf16, 0.1)
    x_odd, x2 = unaligned(x), x.view(257, hidden)
    sc32, bi32 = sc.float(), bi.float()

    def serving_layer_norms():
        tln.layer_norm(x, sc, bi, 1e-6)
        tln.layer_norm(x_odd, sc, bi, 1e-6)
        dl.layer_norm_rows(x2, sc32, bi32, 1e-6)
        F.layer_norm(x, (hidden,), sc, bi, 1e-6)

    kinds = {"layer_norm_one_pass_rows_kernel": "warp per row",
             "layer_norm_two_pass_kernel": "first version",
             "layer_norm_rows_kernel": "kernel 6 layer_norm_rows"}
    split = kernel_device_ms(serving_layer_norms, PROFILED_CALLS,
                             events_fallback=False)
    line = {}
    for name, ms in split.items():
        kind = kinds.get(name.split("<")[0], "F.layer_norm")
        line[kind] = line.get(kind, 0.0) + ms
    if len(line) != 4:
        raise AssertionError(f"layer_norm trace: kernels {list(split)}")
    least, by = bound_ms(nbytes(x, x, sc, bi), 8 * x.numel(), PEAK_FP32)
    log("kernel layer_norm (1, 257, 768) bf16, bf16 vectors, device_ms in "
        "one trace: " + ", ".join(f"{k} {ms:.6g}" for k, ms in line.items())
        + f"; bound_ms {least:.6g} ({by}); grid "
        f"{tuple(tln.layer_norm_plan(257, hidden, x, sc, bi))}")

    # ---- the layer backward's LayerScale pass, on the column sum's grid ----
    worst = 0.0
    for rows, cols in ((TRAIN_BATCH * 257, 768), (TRAIN_BATCH * 257 + 37, 768),
                       (99, 768), (68, 128)):
        g, y = t((rows, cols)), t((rows, cols))
        ls = t((cols,), f32, 0.05, 0.3)
        name = f"layer_scale_grad ({rows}, {cols})"
        got = dlt.scale_grad(g, y, ls)
        torch.cuda.synchronize()
        ref = dlt.scale_grad_reference(g, y, ls)
        if not torch.equal(got[0], ref[0]):
            raise AssertionError(f"{name}: dy is not the plain version's")
        exact = ((g.double() * y.double()).sum(0), got[0].double().sum(0))
        for a, b, c in zip(got[1:], ref[1:], exact):
            worst = max(worst, held(name, a, b, 1e-4),
                        held(name + " against fp64", a, c, 1e-4))
        if not all(torch.equal(a, b)
                   for a, b in zip(got, dlt.scale_grad(g, y, ls))):
            raise AssertionError(f"{name}: two runs differ")
        if rows % 2 == 0:
            half = rows // 2
            lo, hi = (dlt.scale_grad(g[sl], y[sl], ls)
                      for sl in (slice(0, half), slice(half, rows)))
            for full, a, b in zip(got[1:], lo[1:], hi[1:]):
                worst = max(worst, held(name + " against two halves", full,
                                        a + b, 1e-4))
    try:
        dlt.scale_grad(g[:, :100].contiguous(), y[:, :100].contiguous(),
                       ls[:100].contiguous())
    except ValueError:
        pass
    else:
        raise AssertionError("layer_scale_grad took width 100")
    cfg = dlt.colsum_config(TRAIN_BATCH * 257, 768)
    log("kernel layer_scale_grad at (16448 | 16485 | 99, 768) and (68, 128): "
        "dy the plain version's bits, column sums within 1e-4 of the plain "
        f"version, of fp64 and of two halves' (worst {worst:.3f} of the "
        "bound), two runs bit-equal, width 100 refused; grid "
        f"({cfg.strips}, {cfg.parts}) of {cfg.warps} warps")


def row_flash_kernel_phase(device):
    """Checks and times the forward-only serving kernels at the serving
    shapes (the flash attention at B=64 too), the fused residual
    boundaries and the fused GELU at the training shapes, and the
    differentiable flash attention."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import add_layer_norm as aln
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import flash_attention as fa
    from hypervla_tpu_torch.ops import gelu as tg
    from hypervla_tpu_torch.ops import layer_norm as tln

    seq, heads, hidden, batch = 257, 12, 768, TRAIN_BATCH
    rng = np.random.default_rng(SEED + 3)

    def t(shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return torch.tensor(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32),
            dtype=dtype, device=device)

    def check(name, label, got, ref, bound=ULP_BOUND):
        err, ref_scale = max_err(got, ref)
        limit = bound * max(ref_scale, 1.0)
        log(f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
            f"{limit:.6g})")
        if not err <= limit:
            raise AssertionError(f"{name} {label}: {err} > {limit}")
        return err

    table = KernelTable()

    # ---- kernel 4: flash attention over (B, S, heads, d), as the layer
    # reshapes its Dense outputs; both products on the bf16 tensor cores, P
    # kept in fp32 as three bf16 terms ----
    def flash_case(name, b, q_len, kv_len, h, d, iters):
        q = t((b, q_len, h, d))
        k, v = (t((b, kv_len, h, d)) for _ in range(2))
        got = fa.mha_flash(q, k, v)
        torch.cuda.synchronize()
        shape = f"q ({b}, {q_len}, {h}, {d}) kv_len {kv_len} bf16"
        err = check(name, shape, got, fa.mha_flash_reference(q, k, v))
        if not torch.equal(got, fa.mha_flash(q, k, v)):
            raise AssertionError(f"{name}: two runs differ")
        # against the exact function (fp64 on the same bf16 inputs): the
        # tensor-core kernel beside the fp32-FMA kernel it replaced
        q64, k64, v64 = (a.double().transpose(1, 2) for a in (q, k, v))
        exact = (torch.softmax(q64 @ k64.transpose(-1, -2) / math.sqrt(d), -1)
                 @ v64).transpose(1, 2)
        fma = fa.mha_flash_fma(q, k, v)
        err_tc = float((got.double() - exact).abs().max())
        err_fma = float((fma.double() - exact).abs().max())
        err_plain = float((fa.mha_flash_reference(q, k, v).double()
                           - exact).abs().max())
        del q64, k64, v64
        warps = fa.flash_warps(b * h, q_len)
        log(f"kernel {name} {shape}: three-term P split, max_abs_err against "
            f"fp64 {err_tc:.6g} (the FMA kernel {err_fma:.6g}, the plain "
            f"version {err_plain:.6g}); two runs bit-equal; grid "
            f"({-(-q_len // (16 * warps))}, {b * h}) blocks of {warps} warps")
        # both round the same fp32 value up to the order of its sum
        slack = 1e-6 * max(float(exact.abs().max()), 1.0)
        if not err_tc <= err_fma + slack:
            raise AssertionError(f"{name}: error {err_tc} against fp64 above "
                                 f"the FMA kernel's {err_fma}")
        del exact
        qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))
        # q.k^T and one P.V product per bf16 term of P, on the tensor cores
        table.add(name, shape, err, lambda: fa.mha_flash(q, k, v),
                  lambda: fa.mha_flash_reference(q, k, v), iters,
                  (nbytes(q, k, v, got), 8 * b * h * q_len * kv_len * d,
                   PEAK_BF16),
                  lambda: F.scaled_dot_product_attention(qt, kt, vt))
        fma_ms = cuda_ms(lambda: fa.mha_flash_fma(q, k, v), iters)
        fma_dev = confirmed_device_ms(lambda: fa.mha_flash_fma(q, k, v),
                                      min(iters, PROFILED_CALLS))
        log(f"kernel {name} {shape}: the FMA kernel it replaced ms "
            f"{fma_ms:.6g} device_ms {fma_dev:.6g}")

    with torch.no_grad():
        flash_case("flash_attention", 1, seq, seq, heads, 64, 200)
        flash_case("flash_attention_b64", batch, seq, seq, heads, 64, 10)
        flash_case("flash_attention_cross", 2, 65, 300, heads, 64, 50)
        flash_case("flash_attention_d128", 2, seq, seq, 6, 128, 50)

        # ---- kernel 5: the one-pass LayerNorm, bf16-stored vectors ----
        x = t((1, seq, hidden), scale=0.5, shift=0.3)
        sc, bi = t((hidden,), scale=0.1, shift=1.0), t((hidden,), scale=0.1)
        got = tln.layer_norm(x, sc, bi, 1e-6)
        torch.cuda.synchronize()
        err = check("layer_norm", "(1, 257, 768) bf16", got,
                    tln.layer_norm_reference(x, sc, bi, 1e-6))
        table.add("layer_norm", "", err,
                  lambda: tln.layer_norm(x, sc, bi, 1e-6),
                  lambda: tln.layer_norm_reference(x, sc, bi, 1e-6), 200,
                  (nbytes(x, x, sc, bi), 8 * x.numel(), PEAK_FP32),
                  lambda: F.layer_norm(x, (hidden,), sc, bi, 1e-6))

        # ---- kernel 9: the fused GELU at the fc1 output's shape ----
        h = t((batch, seq, 4 * hidden), scale=1.5)
        got = tg.gelu_exact_fused(h)
        torch.cuda.synchronize()
        err = check("gelu_exact_fused", "(64, 257, 3072) bf16", got,
                    tg.gelu_exact_reference(h))
        # elementwise within one bf16 ulp of the plain version's value, at
        # the draw and at every finite bf16 input; twice bit for bit
        every = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                             device=device).to(torch.int16).view(
                                 torch.bfloat16)
        every = every[torch.isfinite(every.float())]
        for label, x in (("(64, 257, 3072) bf16", h),
                         (f"every finite bf16 input ({every.numel()})",
                          every)):
            out, ref = tg.gelu_exact_fused(x), tg.gelu_exact_reference(x)
            torch.cuda.synchronize()
            ulps = float(bf16_ulps(out, ref).max())
            differ = float((out != ref).float().mean())
            log(f"kernel gelu_exact_fused {label}: at most {ulps:g} bf16 "
                f"ulp of the plain version's value, {differ:.3g} of the "
                "outputs differ from it; two runs bit-equal")
            if not (ulps <= 1.0 and torch.equal(torch.isnan(out),
                                                torch.isnan(ref))):
                raise AssertionError(f"gelu_exact_fused {label}: {ulps} ulp")
            if not torch.equal(out, tg.gelu_exact_fused(x)):
                raise AssertionError(f"gelu_exact_fused {label}: two runs "
                                     "differ")
        del out, ref
        # fp32, a few elements and a tail, and a view that starts off a
        # 16-byte boundary (the scalar path)
        x32 = t((seq, 4 * hidden), torch.float32, 3.0)
        check("gelu_exact_fused", "(257, 3072) fp32", tg.gelu_exact_fused(x32),
              tg.gelu_exact_reference(x32), 1e-5)
        for label, x in (("5 elements bf16", t((5,), scale=3.0)),
                         ("1031 elements bf16", t((1031,), scale=3.0)),
                         ("1031 elements fp32", t((1031,), torch.float32,
                                                  3.0)),
                         ("2^20 - 1 elements off a 16-byte boundary",
                          h.view(-1)[1:2 ** 20])):
            bound = 1e-5 if x.dtype == torch.float32 else ULP_BOUND
            check("gelu_exact_fused", label, tg.gelu_exact_fused(x),
                  tg.gelu_exact_reference(x), bound)
        table.add("gelu_exact_fused", "", err,
                  lambda: tg.gelu_exact_fused(h),
                  lambda: tg.gelu_exact_reference(h), 20,
                  (nbytes(h, h), 20 * h.numel(), PEAK_FP32),
                  lambda: F.gelu(h))
        del h, got, every, x32

    # ---- kernels 7 and 8: the residual boundaries, forward and backward ----
    rows = batch * seq
    x, delta, gy, gxn = (t((rows, hidden), scale=s)
                         for s in (2.0, 1.0, 1.0, 1.0))
    ls = t((hidden,), torch.float32, 0.02, 0.1)
    scale = t((hidden,), torch.float32, 0.1, 1.0)
    bias = t((hidden,), torch.float32, 0.1)
    for name, vec in (("fused_add_ln", None), ("fused_add_scale_ln", ls)):
        xn, y = aln.add_ln_fwd(x, delta, vec, scale, bias, 1e-6)
        torch.cuda.synchronize()
        ref_xn, ref_y = aln.add_ln_fwd_reference(x, delta, vec, scale, bias,
                                                 1e-6)
        if not torch.equal(xn, ref_xn):
            raise AssertionError(f"{name}: x_new differs from the plain "
                                 "version's roundings")
        err = check(f"{name}_fwd", "y (16448, 768) bf16", y, ref_y)
        again = aln.add_ln_fwd(x, delta, vec, scale, bias, 1e-6)
        if not (torch.equal(xn, again[0]) and torch.equal(y, again[1])):
            raise AssertionError(f"{name}_fwd: two runs differ")
        log(f"kernel {name}_fwd x_new: bit-equal to the plain version; two "
            f"runs bit-equal; grid {tuple(dl.layer_norm_plan(rows, hidden))}")
        del again
        extra = () if vec is None else (vec,)
        table.add(f"{name}_fwd", "", err,
                  lambda: aln.add_ln_fwd(x, delta, vec, scale, bias, 1e-6),
                  lambda: aln.add_ln_fwd_reference(x, delta, vec, scale, bias,
                                                   1e-6), 50,
                  (nbytes(x, delta, xn, y, scale, bias, *extra),
                   12 * x.numel(), PEAK_FP32))
        got = aln.add_ln_bwd(gy, gxn, xn, delta, vec, scale, 1e-6)
        torch.cuda.synchronize()
        again = aln.add_ln_bwd(gy, gxn, xn, delta, vec, scale, 1e-6)
        ref = aln.add_ln_bwd_reference(gy, gxn, xn, delta, vec, scale, 1e-6)
        errs = []
        # dls, dscale, dbias: fp32 sums of 16448 terms in another order
        for out, a, b, c, bound in zip(
                ("dx", "ddelta", "dls", "dscale", "dbias"), got, again, ref,
                (ULP_BOUND, ULP_BOUND, 1e-4, 1e-4, 1e-4)):
            if c is None:
                continue
            if not torch.equal(a, b):
                raise AssertionError(f"{name}_bwd {out}: two runs differ")
            errs.append(check(f"{name}_bwd", out, a, c, bound))
        log(f"kernel {name}_bwd: two runs bit-equal; grid "
            f"{tuple(tln.layer_norm_bwd_plan(rows, hidden))}")
        if vec is None and got[0] is not got[1]:
            raise AssertionError("fused_add_ln: dx and ddelta are two buffers")
        moved = ((gy, gxn, xn, got[0], scale, scale, scale) if vec is None
                 else (gy, gxn, xn, delta, got[0], got[1], vec, vec, scale,
                       scale, scale))
        table.add(f"{name}_bwd", "", max(errs),
                  lambda: aln.add_ln_bwd(gy, gxn, xn, delta, vec, scale,
                                         1e-6),
                  lambda: aln.add_ln_bwd_reference(gy, gxn, xn, delta, vec,
                                                   scale, 1e-6), 50,
                  (nbytes(*moved), 24 * x.numel(), PEAK_FP32))
        del got, again, ref, xn, y, ref_xn, ref_y

    # the warp-per-row kernels at ragged row counts and four chunks a lane;
    # the first kernels at the widths the warp-per-row kernels do not take
    # (no multiple of 8, wider than 1024) and on a row off a 16-byte
    # boundary: each type and both kernels against the plain version, twice
    # bit for bit
    def unaligned(a):
        flat = torch.empty(a.numel() + 1, dtype=a.dtype, device=device)[1:]
        return flat.view(a.shape).copy_(a)

    worst = 0.0
    for n, d, odd in ((16485, 768, False), (1001, 1024, False),
                      (300, 96, False), (68, 100, False), (65, 2048, False),
                      (257, 768, True)):
        vecs = [t((d,), torch.float32, 0.1, s) for s in (0.1, 1.0, 0.0)]
        for dtype in (torch.bfloat16, torch.float32):
            xs, ds, gys, gxs = (t((n, d), dtype, s) for s in (2.0, 1, 1, 1))
            if odd:
                xs, gys = unaligned(xs), unaligned(gys)
            label = (f"({n}, {d}) {str(dtype)[6:]}"
                     + (", x and g_y off a 16-byte boundary" if odd else ""))
            want = 0 if d % 8 or d > 1024 or odd else 3 if d <= 768 else 4
            if (dl.layer_norm_plan(n, d, xs, ds).chunks != want
                    or tln.layer_norm_bwd_plan(n, d, gys, ds).chunks != want):
                raise AssertionError(f"add_ln {label}: not the {want}-chunk "
                                     "kernel")
            bound = ULP_BOUND if dtype == torch.bfloat16 else 1e-5
            for name, ls_ in (("fused_add_ln", None),
                              ("fused_add_scale_ln", vecs[0])):
                fwd = aln.add_ln_fwd(xs, ds, ls_, *vecs[1:], 1e-6)
                bwd = aln.add_ln_bwd(gys, gxs, fwd[0], ds, ls_, vecs[1], 1e-6)
                torch.cuda.synchronize()
                ref_f = aln.add_ln_fwd_reference(xs, ds, ls_, *vecs[1:], 1e-6)
                ref_b = aln.add_ln_bwd_reference(gys, gxs, ref_f[0], ds, ls_,
                                                 vecs[1], 1e-6)
                if not torch.equal(fwd[0], ref_f[0]):
                    raise AssertionError(f"{name} {label}: x_new differs")
                for out, a, b, bnd in zip(
                        ("y", "dx", "ddelta", "dls", "dscale", "dbias"),
                        fwd[1:] + bwd, ref_f[1:] + ref_b,
                        (bound, bound, bound, 1e-4, 1e-4, 1e-4)):
                    if b is not None:
                        err, sc_ = max_err(a, b)
                        if not err <= bnd * max(sc_, 1.0):
                            raise AssertionError(f"{name} {label} {out}: "
                                                 f"{err}")
                        worst = max(worst, err / (bnd * max(sc_, 1.0)))
                again = (aln.add_ln_fwd(xs, ds, ls_, *vecs[1:], 1e-6)
                         + aln.add_ln_bwd(gys, gxs, fwd[0], ds, ls_, vecs[1],
                                          1e-6))
                if not all(a is b is None or torch.equal(a, b)
                           for a, b in zip(fwd + bwd, again)):
                    raise AssertionError(f"{name} {label}: two runs differ")
            del xs, ds, gys, gxs, fwd, bwd, ref_f, ref_b, again
    log("kernel fused_add_ln / fused_add_scale_ln at (16485, 768), (1001, "
        "1024) and (300, 96) (a warp per row) and at (68, 100), (65, 2048) "
        "and on unaligned rows (the first kernels), bf16 and fp32, "
        "forward and backward: within the bounds (worst "
        f"{worst:.3f} of them), x_new the plain version's bits, two runs "
        "bit-equal")
    # beside the first kernels, at the training shape: an x (x_new) off a
    # 16-byte boundary takes them
    x_odd = unaligned(x)
    line = {}
    for name, vec in (("fused_add_scale_ln", ls), ("fused_add_ln", None)):
        for label, fn in (
                ("fwd", lambda xx: aln.add_ln_fwd(xx, delta, vec, scale, bias,
                                                  1e-6)),
                ("bwd", lambda xx: aln.add_ln_bwd(gy, gxn, xx, delta, vec,
                                                  scale, 1e-6))):
            line[f"{name}_{label}"] = (
                confirmed_device_ms(lambda: fn(x), PROFILED_CALLS),
                confirmed_device_ms(lambda: fn(x_odd), PROFILED_CALLS))
    log("kernel fused_add_(scale_)ln (16448, 768) bf16 device_ms, a warp per "
        "row (the first kernels, on an unaligned x; the backward's with its "
        "finishing launch): " + ", ".join(
            f"{label} {new:.6g} ({was:.6g})"
            for label, (new, was) in line.items()))
    del x_odd

    # fused_add_ln (no LayerScale) lies on no model path of either package:
    # its path is the differentiable function itself, driven once here with
    # the counts at zero, forward and backward with both cotangents, over
    # the trunk's (B, S, width) tensors
    aln.reset_launch_counts()
    shape = (batch, seq, hidden)
    leaves = [a.view(shape).requires_grad_(True) for a in (x, delta)]
    params = [a.clone().requires_grad_(True) for a in (scale, bias)]
    xn, y = aln.fused_add_ln(*leaves, *params, 1e-6)
    torch.autograd.backward((xn, y), (gxn.view(shape), gy.view(shape)))
    torch.cuda.synchronize()
    driven = {name: aln.LAUNCHES[name]
              for name in ("fused_add_ln_fwd", "fused_add_ln_bwd")}
    ref = aln.add_ln_bwd_reference(gy, gxn, xn.detach().view(rows, hidden),
                                   None, None, scale, 1e-6)
    check("fused_add_ln", "function dx", leaves[0].grad.view(rows, hidden),
          ref[0])
    check("fused_add_ln", "function dscale", params[0].grad, ref[3], 1e-4)
    check("fused_add_ln", "function dbias", params[1].grad, ref[4], 1e-4)
    check("fused_add_ln", "function ddelta",
          leaves[1].grad.view(rows, hidden), ref[1])
    log(f"fused_add_ln function launches: {driven}")
    if driven != {"fused_add_ln_fwd": 1, "fused_add_ln_bwd": 1}:
        raise AssertionError(f"fused_add_ln launches {driven}, want one "
                             "forward and one backward")
    del leaves, params, xn, y, ref

    trainable_flash_checks(table, t, check)
    return table.log_rows(", per launch"), driven


def trainable_flash_checks(table, t, check):
    """The differentiable flash attention (ops/flash_attention_train.py),
    forward and backward: against its plain versions and twice bit for
    bit, bf16 and fp32, at the flagship's training shape and at ragged
    sequences (1, 17, 300 keys) and head dims (32, 128: fp32(q) * scale as
    three bf16 terms), and the forward at the serving shape in both types.
    The training shape goes through `table` (its bound, device time and
    scaled_dot_product_attention's forward, and backward alone over a kept
    graph), fp32 under the names `*_fp32` (its bound at PEAK_FP32_SPLIT or
    the bytes); the others are timed by CUDA events, the serving forward
    by the profiler too."""
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import flash_attention_train as ft

    def case(b, s, h, d, dtype, iters):
        bf16 = dtype == torch.bfloat16
        q, k, v, g = (t((b, s, h, d), dtype) for _ in range(4))
        label = f"({b}, {s}, {h}, {d}) {str(dtype)[6:]}"
        bound = ULP_BOUND if bf16 else 1e-5
        o, m, n = ft.mha_flash_trainable_fwd(q, k, v)
        grads = ft.mha_flash_trainable_bwd(q, k, v, g, m, n)
        torch.cuda.synchronize()
        ref_o, ref_m, ref_n = ft.mha_flash_trainable_fwd_reference(q, k, v)
        err_f = check("mha_flash_trainable_fwd", f"{label} o", o, ref_o,
                      bound)
        check("mha_flash_trainable_fwd", f"{label} row max", m, ref_m, 1e-5)
        check("mha_flash_trainable_fwd", f"{label} row sum", n, ref_n, 1e-5)
        refs = ft.mha_flash_trainable_bwd_reference(q, k, v, g, m, n)
        err_b = max(check("mha_flash_trainable_bwd", f"{label} {name}", got,
                          ref, bound)
                    for name, got, ref in zip(("dq", "dk", "dv"), grads,
                                              refs))
        again = (*ft.mha_flash_trainable_fwd(q, k, v),
                 *ft.mha_flash_trainable_bwd(q, k, v, g, m, n))
        if not all(torch.equal(a, c) for a, c in zip((o, m, n, *grads),
                                                     again)):
            raise AssertionError(f"mha_flash_trainable {label}: two runs "
                                 "differ")
        del ref_o, ref_m, ref_n, refs, again
        # the library call on the same (B, heads, S, d) views: its forward,
        # and its backward alone, replayed over one kept graph
        qt, kt, vt, gt = (a.transpose(1, 2) for a in (q, k, v, g))
        leaves = [a.detach().requires_grad_(True) for a in (qt, kt, vt)]
        out = F.scaled_dot_product_attention(*leaves)
        fwd = (lambda: ft.mha_flash_trainable_fwd(q, k, v),
               lambda: ft.mha_flash_trainable_fwd_reference(q, k, v),
               lambda: F.scaled_dot_product_attention(qt, kt, vt))
        bwd = (lambda: ft.mha_flash_trainable_bwd(q, k, v, g, m, n),
               lambda: ft.mha_flash_trainable_bwd_reference(q, k, v, g, m,
                                                            n),
               lambda: torch.autograd.grad(out, leaves, gt,
                                           retain_graph=True))
        # scores and P.V forward; the backward's four products and the
        # scores again
        flops = 4 * b * h * s * s * d
        peak = PEAK_BF16 if bf16 else PEAK_FP32_SPLIT
        if s != 257:
            times = [(*interleaved(kernel, plain, iters),
                      cuda_ms(library, iters))
                     for kernel, plain, library in (fwd, bwd)]
            least = [bound_ms(nbytes(q, k, v, o, m, n), flops, peak),
                     bound_ms(nbytes(q, k, v, g, m, n, *grads), 2.5 * flops,
                              peak)]
            log(f"kernel mha_flash_trainable {label}: within the bounds, two "
                "runs bit-equal; ms fwd / bwd (CUDA events): kernel "
                f"{times[0][0]:.6g} / {times[1][0]:.6g}, plain "
                f"{times[0][1]:.6g} / {times[1][1]:.6g}, "
                "scaled_dot_product_attention "
                f"{times[0][2]:.6g} / {times[1][2]:.6g}; bound_ms "
                f"{least[0][0]:.6g} ({least[0][1]}) / {least[1][0]:.6g} "
                f"({least[1][1]})")
            return
        suffix = "" if bf16 else "_fp32"
        with torch.no_grad():
            table.add("mha_flash_trainable_fwd" + suffix, label, err_f,
                      *fwd[:2], iters, (nbytes(q, k, v, o, m, n), flops, peak),
                      fwd[2])
        table.add("mha_flash_trainable_bwd" + suffix, label, err_b, *bwd[:2],
                  iters, (nbytes(q, k, v, g, m, n, *grads), 2.5 * flops,
                          peak), bwd[2])
        log(f"kernel mha_flash_trainable {label}: within the bounds, two runs "
            "bit-equal")

    def serving(b, s, h, d, dtype, iters):
        """The forward alone at one image's 12 heads, as a serving model
        with the switch on calls it under torch.no_grad() (the plan's own
        grid: 16-row blocks), against its plain version, twice bit for
        bit, timed beside scaled_dot_product_attention."""
        q, k, v = (t((b, s, h, d), dtype) for _ in range(3))
        label = f"({b}, {s}, {h}, {d}) {str(dtype)[6:]} forward"
        bf16 = dtype == torch.bfloat16
        with torch.no_grad():
            o, m, n = ft.mha_flash_trainable_fwd(q, k, v)
            torch.cuda.synchronize()
            ref = ft.mha_flash_trainable_fwd_reference(q, k, v)
            check("mha_flash_trainable_fwd", f"{label} o", o, ref[0],
                  ULP_BOUND if bf16 else 1e-5)
            check("mha_flash_trainable_fwd", f"{label} row max", m, ref[1],
                  1e-5)
            check("mha_flash_trainable_fwd", f"{label} row sum", n, ref[2],
                  1e-5)
            if not all(torch.equal(a, c) for a, c in zip(
                    (o, m, n), ft.mha_flash_trainable_fwd(q, k, v))):
                raise AssertionError(f"mha_flash_trainable {label}: two "
                                     "runs differ")
            qt, kt, vt = (a.transpose(1, 2) for a in (q, k, v))

            def kernel():
                return ft.mha_flash_trainable_fwd(q, k, v)

            def library():
                return F.scaled_dot_product_attention(qt, kt, vt)

            k_ms, p_ms = interleaved(
                kernel, lambda: ft.mha_flash_trainable_fwd_reference(q, k, v),
                iters)
            lib_ms = cuda_ms(library, iters)
            calls = min(iters, PROFILED_CALLS)
            dev_ms = confirmed_device_ms(kernel, calls)
            lib_dev = confirmed_device_ms(library, calls)
        least, by = bound_ms(nbytes(q, k, v, o, m, n), 4 * b * h * s * s * d,
                             PEAK_BF16 if bf16 else PEAK_FP32_SPLIT)
        log(f"kernel mha_flash_trainable {label}: within the bounds, two runs "
            f"bit-equal; ms {k_ms:.6g} device_ms {dev_ms:.6g} plain_ms "
            f"{p_ms:.6g} library_ms {lib_ms:.6g} library_device_ms "
            f"{lib_dev:.6g} bound_ms {least:.6g} ({by})")

    for dtype in (torch.bfloat16, torch.float32):
        case(TRAIN_BATCH, 257, 12, 64, dtype, 10)
        for s in (1, 17, 300):
            for d in (32, 128):
                case(2, s, 3, d, dtype, 10)
    for dtype in (torch.bfloat16, torch.float32):
        serving(1, 257, 12, 64, dtype, 20)


def make_wrapper(model, trunk_impl):
    from hypervla_tpu_torch.eval.inference import InferenceWrapper

    return InferenceWrapper(model, policy_setup="google_robot",
                            image_size=224, action_ensemble=True, crop=True,
                            fused_serving=True, trunk_impl=trunk_impl)


def slice_phase(device):
    """Drives the full-width flagship through the serving entry points: the
    stacked-trunk step, then the per-layer step with the flash attention
    and the one-pass LayerNorm. Returns the launches of each."""
    import copy

    import numpy as np
    import torch

    from hypervla_tpu_torch.eval.inference import initial_state
    from hypervla_tpu_torch.flagship import build_flagship
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import flash_attention as fa
    from hypervla_tpu_torch.ops import layer_norm as tln

    rng = np.random.default_rng(SEED)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False]),
    }}
    t0 = time.perf_counter()
    model, batch = build_flagship(seed=SEED, encoder_dtype="bfloat16",
                                  device=device, dataset_statistics=stats)
    # random fan-out kernels make the generated weights depend on the task
    gen = torch.Generator().manual_seed(SEED + 1)
    for name, value in model.params.items():
        if name.startswith("output_head_") and name.endswith("/kernel"):
            value += (torch.randn(value.shape, generator=gen) * 0.02).to(
                value.device)
    torch.cuda.synchronize()
    log(f"slice flagship build s {time.perf_counter() - t0:.3f}")

    frames = rng.integers(0, 256, (STEPS + 1, 256, 256, 3), dtype=np.uint8)
    instruction = {"language_instruction":
                   batch["task"]["language_instruction"]}

    t0 = time.perf_counter()
    init = initial_state(model, frames[0])
    torch.cuda.synchronize()
    log(f"slice initial-image encode (fp32 DINOv2) ms "
        f"{(time.perf_counter() - t0) * 1e3:.3f}")
    policy = make_wrapper(model, "kernel")
    plain = make_wrapper(model, "reference")
    setup_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        policy.reset("pick up the cube", instruction, init)
        torch.cuda.synchronize()
        setup_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"slice episode setup ms (reset: hypernet + prepare + stack) "
        f"first {setup_ms[0]:.3f} then {setup_ms[1:]}")
    plain.reset("pick up the cube", instruction, init)

    # the main path, counted: every kernel launch below is the serving step's
    dl.reset_launch_counts()
    actions = [policy.step(f)[0] for f in frames[1:]]
    torch.cuda.synchronize()
    launches = dict(dl.LAUNCHES)
    log(f"slice launches over {STEPS} steps: {launches}")
    if launches["dino_layers_serving"] != STEPS:
        raise AssertionError("not every step went through the trunk kernel")
    depth = model.base_net.encoder.dino.num_hidden_layers
    width = model.base_net.encoder.dino.hidden_size
    # seven wrapper launches a layer; a split-K GEMM's finishing pass is a
    # second device kernel inside its one wrapper launch
    want = {"dino_layer_norm": 2 * depth * STEPS,
            "dino_gemm": 4 * depth * STEPS, "dino_attention": depth * STEPS,
            "dino_layers_serving": STEPS}
    if launches != want:
        raise AssertionError(f"stacked serving launches {launches}, want "
                             f"{want}")
    split = [dl.gemm_config(257, n, k).split_k
             for n, k in ((3 * width, width), (width, width),
                          (4 * width, width), (width, 4 * width))]
    log(f"slice stacked step: 7 launches a layer (2 LayerNorms, 4 GEMMs, 1 "
        f"attention); split-K of the 4 GEMMs {split}: "
        f"{sum(x > 1 for x in split)} finishing passes a layer")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched")
    actions = np.stack(actions)
    if actions.shape != (STEPS, 7) or not np.isfinite(actions).all():
        raise AssertionError(f"bad actions {actions.shape}")

    plain_actions = np.stack([plain.step(f)[0] for f in frames[1:]])
    scale = max(np.abs(plain_actions[:, :6]).max(), 1.0)
    arm_err = float(np.abs(actions[:, :6] - plain_actions[:, :6]).max())
    grip_agree = float((actions[:, 6] == plain_actions[:, 6]).mean())
    log(f"slice actions kernel vs plain trunk: arm max_abs_err {arm_err:.6g} "
        f"(bound {TRUNK_BOUND * scale:.6g}), gripper agreement "
        f"{grip_agree:.3f}; first action {actions[0].tolist()}")
    if not arm_err < TRUNK_BOUND * scale:
        raise AssertionError("actions disagree with the plain trunk")

    # the gripper logits themselves (a thresholded logit near 0 may flip)
    image = torch.as_tensor(frames[1][:224, :224], device=device)[None]
    logits = {}
    for impl in ("kernel", "reference"):
        tokens = model.base_net.encode(policy.base_params, image, impl)
        logits[impl] = model.base_net.action_head(policy.base_params,
                                                  tokens)[1].flatten()
    err, lscale = max_err(logits["kernel"], logits["reference"])
    log(f"slice gripper logits kernel vs plain: max_abs_err {err:.6g} "
        f"(bound {TRUNK_BOUND * max(lscale, 1.0):.6g})")
    if not err < TRUNK_BOUND * max(lscale, 1.0):
        raise AssertionError("gripper logits disagree with the plain trunk")

    # per-step time, in turns: plain, kernel, kernel, plain
    def window(wrapper, n=20):
        times = []
        for f in frames[1:n + 1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            wrapper.step(f)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return times

    plain_ms = window(plain)
    kernel_ms = window(policy) + window(policy)
    plain_ms += window(plain)
    k_med, p_med = statistics.median(kernel_ms), statistics.median(plain_ms)
    log(f"slice per-step ms (median of CUDA events): kernel trunk {k_med:.4f} "
        f"plain trunk {p_med:.4f}; actions/s kernel {1e3 / k_med:.1f} "
        f"plain {1e3 / p_med:.1f}")
    del plain

    # ---- the second serving configuration: the per-layer serving step ----
    # the same weights; attention through the flash kernel, every LayerNorm
    # of the trunk through the one-pass kernel, the Dense layers cuBLAS
    config = copy.deepcopy(model.config)
    config["base_net_kwargs"]["vit_kwargs"].update(
        use_flash_attention=True, fused_layer_norm=True,
        sow_dino_attention=False)
    flash_model = HyperVLA(model.hypernet,
                           BaseNetwork(**config["base_net_kwargs"]), config,
                           model.params, model.plan, stats, device)
    layers = make_wrapper(flash_model, "layers")
    layers_plain = make_wrapper(flash_model, "layers_reference")
    for wrapper in (layers, layers_plain):
        wrapper.reset("pick up the cube", instruction, init)
    depth = flash_model.base_net.encoder.dino.num_hidden_layers
    per_step = {"flash_attention": depth, "layer_norm": 2 * depth + 1}

    # the main path, counted: every launch below is the per-layer step's
    for module in (dl, fa, tln):
        module.reset_launch_counts()
    actions = [layers.step(f)[0] for f in frames[1:]]
    torch.cuda.synchronize()
    got = {"flash_attention": fa.LAUNCHES["flash_attention"],
           "layer_norm": tln.LAUNCHES["layer_norm"]}
    log(f"slice per-layer serving launches over {STEPS} steps: {got}")
    if got != {k: v * STEPS for k, v in per_step.items()}:
        raise AssertionError(f"per-layer serving launches {got}, want "
                             f"{per_step} per step")
    if any(dl.LAUNCHES.values()):
        raise AssertionError("the per-layer step went through the stacked "
                             "trunk's kernels")
    actions = np.stack(actions)
    if actions.shape != (STEPS, 7) or not np.isfinite(actions).all():
        raise AssertionError(f"bad per-layer actions {actions.shape}")
    plain_actions = np.stack([layers_plain.step(f)[0] for f in frames[1:]])
    if fa.LAUNCHES["flash_attention"] != got["flash_attention"]:
        raise AssertionError("the plain versions launched a kernel")
    scale = max(np.abs(plain_actions[:, :6]).max(), 1.0)
    arm_err = float(np.abs(actions[:, :6] - plain_actions[:, :6]).max())
    grip_agree = float((actions[:, 6] == plain_actions[:, 6]).mean())
    log(f"slice per-layer actions kernels vs their plain versions: arm "
        f"max_abs_err {arm_err:.6g} (bound {TRUNK_BOUND * scale:.6g}), "
        f"gripper agreement {grip_agree:.3f}; first action "
        f"{actions[0].tolist()}")
    if not arm_err < TRUNK_BOUND * scale:
        raise AssertionError("per-layer actions disagree with the plain "
                             "versions")
    # beside the stacked-trunk step, in turns
    stacked_ms = window(policy)
    layers_ms = window(layers) + window(layers)
    stacked_ms += window(policy)
    plain_ms = window(layers_plain)
    l_med, s_med = statistics.median(layers_ms), statistics.median(stacked_ms)
    log(f"slice per-step ms (median of CUDA events): per-layer step "
        f"{l_med:.4f} (plain versions {statistics.median(plain_ms):.4f}) "
        f"stacked-trunk step {s_med:.4f}; actions/s per-layer "
        f"{1e3 / l_med:.1f} stacked {1e3 / s_med:.1f}")
    # where the step's time is: device busy against the step's wall time
    for label, wrapper, med in (("stacked-trunk", policy, s_med),
                                ("per-layer", layers, l_med)):
        busy, count = device_busy(lambda: wrapper.step(frames[1]), 10)
        log(f"slice {label} step profiled: device busy ms {busy:.4f}, "
            f"{count:.0f} device kernels per step, idle share "
            f"{1 - busy / med:.3f} of the {med:.4f} ms step")
    launches.update(got)
    flagship = dict(model=model, instruction=instruction, frames=frames,
                    init={k: v.cpu().numpy() for k, v in init.items()})
    return launches, flagship


def server_phase(device, flagship):
    """Serves the slice phase's flagship as a user would: saved with an EMA
    file and loaded back through load_hypervla_policy on the card, once as
    the host path and once as the fused kernel step, which goes behind the
    PolicyServer on 127.0.0.1 driven by a PolicyClient; then the K-tick and
    the multi-task steps. Each host, served, scanned and multi-task tick
    must launch the stacked trunk once per frame, and each served, scanned
    and multi-task tick equal the in-process per-tick step bit for bit."""
    import socket
    import tempfile
    import threading

    import numpy as np
    import torch

    from hypervla_tpu_torch.eval.inference import InferenceWrapper
    from hypervla_tpu_torch.eval.model_loading import load_hypervla_policy
    from hypervla_tpu_torch.eval.policy_server import (
        PolicyClient,
        PolicyServer,
    )
    from hypervla_tpu_torch.models.hypervla import save_ema_params
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import serving

    model, instruction = flagship["model"], flagship["instruction"]
    frames, init = flagship["frames"], flagship["init"]
    task = "pick up the cube"
    # EMA params that differ from the trained ones wherever a task reads them
    ema = {k: v * 0.999 if k.startswith("output_head_") else v
           for k, v in model.params.items()}

    # ---- the checkpoint: save, then load on the card with the EMA swap ----
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        model.save_pretrained(SERVE_CKPT_STEP, root)
        save_ema_params(root, SERVE_CKPT_STEP, ema)
        save_s = time.perf_counter() - t0
        written = sum(os.path.getsize(os.path.join(d, f))
                      for d, _, files in os.walk(root) for f in files)
        t0 = time.perf_counter()
        policy = load_hypervla_policy(root, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        served_policy = load_hypervla_policy(root, device=device,
                                             fused_serving=True)
    loaded = policy.model
    for p in (policy, served_policy):
        if set(p.model.params) != set(ema) or not all(
                torch.equal(p.model.params[k], ema[k]) for k in ema):
            raise AssertionError("the loaded params are not the saved EMA "
                                 "params bit for bit")
    if not (served_policy.fused_serving
            and served_policy.trunk_impl == "kernel"):
        raise AssertionError("load_hypervla_policy(fused_serving=True) did "
                             "not build the fused kernel step")
    log(f"server checkpoint: save s {save_s:.3f} ({written} bytes: params "
        f"and EMA params of {len(ema)} tensors), load_hypervla_policy s "
        f"{load_s:.3f}; the EMA params loaded bit for bit, twice")

    def wrapper(**kwargs):
        return InferenceWrapper(loaded, policy_setup="google_robot",
                                image_size=224, action_ensemble=True,
                                crop=True, **kwargs)

    # ---- the host path (the JAX default) against the fused kernel step ----
    fused = wrapper(fused_serving=True, trunk_impl="kernel")
    if policy.fused_serving or policy.trunk_impl != "kernel":
        raise AssertionError("load_hypervla_policy did not build the host "
                             "path on the trunk kernel")
    host_actions, fused_actions, host_ms = [], [], []
    for w in (policy, fused):
        w.reset(task, instruction, init)
    host_launches = 0
    for f in frames[1:HOST_STEPS + 1]:
        dl.reset_launch_counts()
        t0 = time.perf_counter()
        host_actions.append(policy.step(f)[0])
        host_ms.append((time.perf_counter() - t0) * 1e3)
        host_launches += dl.LAUNCHES["dino_layers_serving"]
        fused_actions.append(fused.step(f)[0])
    if host_launches != HOST_STEPS:
        raise AssertionError(f"the host path launched the trunk kernel "
                             f"{host_launches} times in {HOST_STEPS} steps")
    host_actions, fused_actions = np.stack(host_actions), np.stack(
        fused_actions)
    scale = max(np.abs(fused_actions[:, :6]).max(), 1.0)
    arm_err = float(np.abs(host_actions[:, :6] - fused_actions[:, :6]).max())
    log(f"server host path ({HOST_STEPS} steps, trunk {policy.trunk_impl}, "
        f"{host_launches} trunk launches) vs the fused kernel step: arm max_abs_err {arm_err:.6g} (bound "
        f"{TRUNK_BOUND * scale:.6g}), gripper agreement "
        f"{float((host_actions[:, 6] == fused_actions[:, 6]).mean()):.3f}; "
        f"host step ms median {statistics.median(host_ms):.4f}")
    if not (np.isfinite(host_actions).all() and arm_err < TRUNK_BOUND * scale):
        raise AssertionError("the host path disagrees with the fused step")
    # the gripper logits of both trunks on one frame (a thresholded logit
    # near 0 may flip)
    image = torch.as_tensor(policy._resize_image(frames[1]), device=device)
    logits = [loaded.base_net.action_head(w.base_params, loaded.base_net.encode(
        w.base_params, image[None], w.trunk_impl))[1].flatten()
        for w in (policy, fused)]
    err, lscale = max_err(*logits)
    log(f"server gripper logits host path vs fused kernel step: max_abs_err "
        f"{err:.6g} (bound {TRUNK_BOUND * max(lscale, 1.0):.6g})")
    if not err < TRUNK_BOUND * max(lscale, 1.0):
        raise AssertionError("the host path's gripper logits disagree with "
                             "the fused step's")

    # ---- the policy server on 127.0.0.1, a client in this process ----
    server = PolicyServer(served_policy, lambda _: instruction,
                          host="127.0.0.1", port=0)
    listener = socket.socket()
    listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)

    def serve_one():
        conn, _ = listener.accept()
        server._handle(conn)

    thread = threading.Thread(target=serve_one, daemon=True)
    thread.start()
    client = PolicyClient("127.0.0.1", listener.getsockname()[1])
    local = wrapper(fused_serving=True, trunk_impl="kernel")
    try:
        if client.ping() != {"ok": True}:
            raise AssertionError("ping failed")
        client.reset(task, initial_state=init)
        local.reset(task, instruction, init)
        # the served path, counted: every launch below is a served step's
        dl.reset_launch_counts()
        replies, rtt_ms = [], []
        for f in frames[1:]:
            t0 = time.perf_counter()
            replies.append(client.step(f))
            rtt_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        served = dict(dl.LAUNCHES)
        local_ms = []
        for f, reply in zip(frames[1:], replies):
            t0 = time.perf_counter()
            raw, action, _, _, _ = local.step(f)
            local_ms.append((time.perf_counter() - t0) * 1e3)
            if not (np.array_equal(reply["raw_action"], raw)
                    and np.array_equal(reply["action"], action)):
                raise AssertionError("a served action differs from the "
                                     "in-process step's")
        log(f"server launches over {STEPS} served steps: {served}")
        if served["dino_layers_serving"] != STEPS:
            raise AssertionError("not every served step launched the trunk "
                                 "kernel once")
        rtt, step_ms = statistics.median(rtt_ms), statistics.median(local_ms)
        log(f"server round trip ms per step request (median of {STEPS}) "
            f"{rtt:.4f}, the in-process fused step {step_ms:.4f} (difference "
            f"{rtt - step_ms:.4f}); every served action bit-equal to the "
            "in-process step's")
        busy, count = device_busy(lambda: client.step(frames[1]), 10)
        log(f"server step profiled (client round trip): device busy ms "
            f"{busy:.4f}, {count:.0f} device kernels per request, idle share "
            f"{1 - busy / rtt:.3f} of the {rtt:.4f} ms round trip")
    finally:
        client.close()
        thread.join(timeout=60)
        listener.close()
    if thread.is_alive():
        raise AssertionError("the server thread did not end")

    # ---- K ticks a call ----
    stats = policy.unnormalization_statistics
    kwargs = dict(image_size=224, crop=True, ensemble=True,
                  trunk_impl="kernel")
    base, _ = loaded.create_tasks(instruction_dict=instruction,
                                  initial_state=init)
    params = serving.prepare_serving_params(loaded, base)
    tick, init_history = serving.make_serving_step(loaded, stats, **kwargs)
    scan, _ = serving.make_scan_serving_step(loaded, stats, SCAN_K, **kwargs)
    scan_frames = frames[1:SCAN_FRAMES + 1]

    def run_ticks():
        history, out = init_history(), []
        for i, f in enumerate(scan_frames):
            action, history = tick(params, f, history, i)
            out.append(action)
        return torch.stack(out), history

    def run_scan():
        history, out = init_history(), []
        for c in range(0, SCAN_FRAMES, SCAN_K):
            actions, history = scan(params, scan_frames[c:c + SCAN_K],
                                    history, c)
            out.append(actions)
        return torch.cat(out), history

    want, want_history = run_ticks()
    dl.reset_launch_counts()
    got, got_history = run_scan()
    torch.cuda.synchronize()
    scanned = dl.LAUNCHES["dino_layers_serving"]
    if scanned != SCAN_FRAMES:
        raise AssertionError(f"the K-tick step launched the trunk {scanned} "
                             f"times over {SCAN_FRAMES} frames")
    if not (torch.equal(got, want) and torch.equal(got_history,
                                                   want_history)):
        raise AssertionError("the K-tick step differs from the per-tick "
                             "steps")
    scan_ms = cuda_ms(run_scan, 2) / SCAN_FRAMES
    tick_ms = cuda_ms(run_ticks, 2) / SCAN_FRAMES
    log(f"server K-tick step (K={SCAN_K}, {SCAN_FRAMES} frames): "
        f"{scanned} trunk launches, bit-equal to {SCAN_FRAMES} per-tick "
        f"steps; ms per action {scan_ms:.4f} (per-tick {tick_ms:.4f})")

    # ---- N tasks a tick ----
    rng = np.random.default_rng(SEED + 3)
    tokens = instruction["language_instruction"]["token_embedding"]
    per_task = []
    for _ in range(TASKS):
        lang = dict(instruction["language_instruction"], token_embedding=(
            rng.standard_normal(tokens.shape).astype(np.float32)))
        base, _ = loaded.create_tasks(
            instruction_dict={"language_instruction": lang},
            initial_state=init)
        per_task.append(serving.prepare_serving_params(loaded, base))
    multi, _, stack = serving.make_multitask_serving_step(loaded, stats,
                                                          **kwargs)
    stacked = stack(per_task)
    histories = torch.stack([init_history()] * TASKS)
    singles = [init_history() for _ in range(TASKS)]
    dl.reset_launch_counts()
    multi_out = []
    for t in range(MULTI_TICKS):
        actions, histories = multi(stacked,
                                   frames[1 + t * TASKS:1 + (t + 1) * TASKS],
                                   histories, np.full(TASKS, t))
        multi_out.append(actions)
    torch.cuda.synchronize()
    multi_launches = dl.LAUNCHES["dino_layers_serving"]
    if multi_launches != TASKS * MULTI_TICKS:
        raise AssertionError(f"the multi-task step launched the trunk "
                             f"{multi_launches} times over {MULTI_TICKS} "
                             f"ticks of {TASKS} tasks")
    for t, actions in enumerate(multi_out):
        for i in range(TASKS):
            action, singles[i] = tick(per_task[i], frames[1 + t * TASKS + i],
                                      singles[i], t)
            if not torch.equal(actions[i], action):
                raise AssertionError(f"task {i} at tick {t} differs from "
                                     "its single-task step")
    if torch.equal(multi_out[0][0], multi_out[0][1]):
        raise AssertionError("two tasks gave the same action")
    multi_ms = cuda_ms(lambda: multi(stacked, frames[1:TASKS + 1], histories,
                                     np.full(TASKS, MULTI_TICKS)), 5)
    log(f"server multi-task step (N={TASKS}): {multi_launches} trunk "
        f"launches over {MULTI_TICKS} ticks, each task's action bit-equal "
        f"to its single-task step; ms per tick {multi_ms:.4f}")


def train_kernel_phase(device):
    """Checks and times the training kernels at the flagship's B=64."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.ops import gelu as tg
    from hypervla_tpu_torch.ops import layer_norm as tln

    batch, seq, heads, hidden = TRAIN_BATCH, 257, 12, 768
    mlp, m = 4 * hidden, TRAIN_BATCH * 257
    scale = 1.0 / 8.0
    rng = np.random.default_rng(SEED + 2)

    def t(a, dtype=torch.bfloat16):
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=device)

    def check(name, label, got, ref, bound, cosine=None):
        err, ref_scale = max_err(got, ref)
        limit = bound * max(ref_scale, 1.0)
        msg = (f"kernel {name} {label}: max_abs_err {err:.6g} (bound "
               f"{limit:.6g})")
        if cosine is not None:
            cos = _cosine(got, ref)
            msg += f" cosine {cos:.6f} (bound {cosine})"
            if not cos > cosine:
                raise AssertionError(f"{name} {label}: cosine {cos}")
        log(msg)
        if not err <= limit:
            raise AssertionError(f"{name} {label}: {err} > {limit}")
        return err

    table = KernelTable()
    timed = table.add

    # ---- kernel 2: the fused training attention ----
    q, k, v, g = (t(rng.standard_normal((batch, seq, hidden)))
                  for _ in range(4))
    attn_ops = 4 * batch * seq * seq * hidden  # q.k^T and P.v

    def split(a):
        return a.view(batch, seq, heads, 64).transpose(1, 2)

    o, probs = fa.mha_fused_train_fwd(q, k, v, heads, scale)
    torch.cuda.synchronize()
    ref_o, ref_p = fa.mha_fused_train_fwd_reference(q, k, v, heads, scale)
    err = max(check("mha_fused_train_fwd", "o", o, ref_o, ULP_BOUND),
              check("mha_fused_train_fwd", "P", probs, ref_p, ULP_BOUND))
    o2, p2 = fa.mha_fused_train_fwd(q, k, v, heads, scale)
    if not (torch.equal(o, o2) and torch.equal(probs, p2)):
        raise AssertionError("two runs of the attention forward differ")
    log(f"kernel mha_fused_train_fwd: two runs bit-equal; P row stride "
        f"{probs.stride(2)} values for {seq} columns")
    del o2, p2
    timed("mha_fused_train_fwd", "", err,
          lambda: fa.mha_fused_train_fwd(q, k, v, heads, scale),
          lambda: fa.mha_fused_train_fwd_reference(q, k, v, heads, scale),
          20, (nbytes(q, k, v, o, probs), attn_ops, PEAK_BF16),
          # the library call stores no P
          lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                 split(v)))

    # the plain forward's P, in the row-padded layout the kernels read (the
    # forward's own layout; a dense P would be copied into it at every call)
    ref_p = fa.padded_probs(ref_p)
    grads = fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale)
    torch.cuda.synchronize()
    refs = fa.mha_fused_train_bwd_reference(q, k, v, ref_p, g, heads, scale)
    err = max(check("mha_fused_train_bwd", name, a, b, GRAD_BOUND)
              for name, a, b in zip(("dq", "dk", "dv"), grads, refs))
    again = fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale)
    if not all(torch.equal(a, b) for a, b in zip(grads, again)):
        raise AssertionError("two runs of the attention backward differ")
    log("kernel mha_fused_train_bwd: two runs bit-equal")
    del again
    leaves = [split(a).detach().requires_grad_(True) for a in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    timed("mha_fused_train_bwd", "", err,
          lambda: fa.mha_fused_train_bwd(q, k, v, ref_p, g, heads, scale),
          lambda: fa.mha_fused_train_bwd_reference(q, k, v, ref_p, g, heads,
                                                   scale),
          20, (nbytes(q, k, v, ref_p, g, q, k, v), 2 * attn_ops, PEAK_BF16),
          lambda: torch.autograd.grad(sdpa_out, leaves, split(g),
                                      retain_graph=True))
    del leaves, sdpa_out, grads, refs, o, probs, ref_o, ref_p

    # ---- kernel 3: the layer, forward without and with residuals ----
    def layer_operands():
        weights = [t(rng.standard_normal(shape) * 0.02) for shape in
                   [(hidden, hidden)] * 4 + [(hidden, mlp), (mlp, hidden)]]
        pv = t(np.concatenate([
            0.02 * rng.standard_normal((5, hidden)),
            1 + 0.1 * rng.standard_normal((1, hidden)),
            0.1 * rng.standard_normal((1, hidden)),
            1 + 0.1 * rng.standard_normal((1, hidden)),
            0.1 * rng.standard_normal((1, hidden)),
            0.1 + 0.02 * rng.standard_normal((2, hidden)),
        ]), torch.float32)
        b1 = t(0.02 * rng.standard_normal((1, mlp)), torch.float32)
        return (*weights, pv, b1, heads, 1e-6)

    x = t(rng.standard_normal((batch, seq, hidden)) * 0.5)
    layer_args = [layer_operands() for _ in range(12)]
    ops = dlt.pack_operands(*layer_args[0][:8])
    gemm_ops = 2 * m * 12 * hidden * hidden  # qkv, out-proj, fc1, fc2
    got = dlt.dino_layer_train(x, *layer_args[0])
    torch.cuda.synchronize()
    err = check("dino_layer_train_fwd", "one layer (64, 257, 768)", got,
                dlt.dino_layer_train_reference(x, *layer_args[0]),
                LAYER_BOUND)
    timed("dino_layer_train_fwd", "one layer", err,
          lambda: dlt.dino_layer_train(x, *layer_args[0]),
          lambda: dlt.dino_layer_train_reference(x, *layer_args[0]), 10,
          (nbytes(x, *ops, x), gemm_ops + attn_ops, PEAK_BF16))
    got, ref = x, x
    for args in layer_args:
        got = dlt.dino_layer_train(got, *args)
        ref = dlt.dino_layer_train_reference(ref, *args)
    torch.cuda.synchronize()
    check("dino_layer_train_fwd", "12 stacked layers", got, ref, TRUNK_BOUND)
    del got, ref, layer_args

    out, res = dlt.forward_with_residuals(x, ops, heads, 1e-6)
    torch.cuda.synchronize()
    if not torch.equal(out, dlt.dino_layer_train_packed(x, ops, heads, 1e-6)):
        raise AssertionError("the residual-saving forward and the primal "
                             "differ")
    ref_out, ref_res = dlt.forward_with_residuals_reference(x, ops, heads,
                                                            1e-6)
    err = max(check("dino_layer_train_fwd_res", name, a, b, LAYER_BOUND)
              for name, a, b in zip(("out", *dlt.RESIDUALS), (out, *res),
                                    (ref_out, *ref_res)))
    timed("dino_layer_train_fwd_res", "one layer", err,
          lambda: dlt.forward_with_residuals(x, ops, heads, 1e-6),
          lambda: dlt.forward_with_residuals_reference(x, ops, heads, 1e-6),
          10, (nbytes(x, *ops, out, *res), gemm_ops + attn_ops, PEAK_BF16))
    del ref_out, ref_res

    # ---- kernel 3: the layer backward, on the kernel forward's residuals ----
    g = t(rng.standard_normal((batch, seq, hidden)))
    names = ("dx", "dwqkv", "dwo", "dw1", "dw2", "dpv", "db1")
    got = dlt.layer_backward(g, x, ops, res, heads, 1e-6)
    torch.cuda.synchronize()
    ref = dlt.layer_backward_reference(g, x, ops, res, heads, 1e-6)
    err = max(check("dino_layer_train_bwd", name, a, b, LAYER_BOUND,
                    GRAD_COSINE_BOUND)
              for name, a, b in zip(names, got, ref))
    again = dlt.layer_backward(g, x, ops, res, heads, 1e-6)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("two runs of the layer backward differ")
    half = batch // 2
    halves = [dlt.layer_backward(g[sl], x[sl], ops, [r[sl] for r in res],
                                 heads, 1e-6)
              for sl in (slice(0, half), slice(half, batch))]
    for name, full, a, b in zip(names[1:], got[1:], *(h[1:] for h in halves)):
        full, parts = full.float(), a.float() + b.float()
        # rtol 0.05 (the JAX package's bound) with one bf16 ulp of the
        # leaf's largest value: each call rounds its own sum once
        atol = float(ULP_BOUND * full.abs().max())
        worst = float((full - parts).abs().max())
        log(f"kernel dino_layer_train_bwd {name}: batch {batch} against "
            f"two halves max_abs_diff {worst:.6g} (atol {atol:.6g} + 0.05 "
            "rel)")
        if not bool(((full - parts).abs() <= atol + 0.05 * parts.abs()
                     ).all()):
            raise AssertionError(f"{name}: batch sum differs from its halves")
    log("kernel dino_layer_train_bwd: two runs bit-equal")
    timed("dino_layer_train_bwd", "one layer", err,
          lambda: dlt.layer_backward(g, x, ops, res, heads, 1e-6),
          lambda: dlt.layer_backward_reference(g, x, ops, res, heads, 1e-6),
          10, (nbytes(g, x, *ops, *res, *got),
               2 * gemm_ops + 2 * attn_ops, PEAK_BF16))
    del again, halves, ref

    # ---- kernel 6: the training LayerNorm at the trunk's final shape ----
    rows = x.view(m, hidden)
    ln_s, ln_b = ops[5][dlt.LN1_S], ops[5][dlt.LN1_B]
    s16, b16 = ln_s.bfloat16(), ln_b.bfloat16()
    g_rows = g.view(m, hidden)
    with torch.no_grad():
        y = tln.layer_norm_pallas(x, ln_s, ln_b, 1e-6)
    torch.cuda.synchronize()
    err = check("layer_norm_pallas_fwd", "(64, 257, 768) bf16", y.view(
        m, hidden), tln.layer_norm_pallas_reference(rows, ln_s, ln_b, 1e-6),
        ULP_BOUND)

    def ln_forward():
        with torch.no_grad():
            return tln.layer_norm_pallas(x, ln_s, ln_b, 1e-6)

    timed("layer_norm_pallas_fwd", "", err, ln_forward,
          lambda: tln.layer_norm_pallas_reference(rows, ln_s, ln_b, 1e-6),
          50, (nbytes(x, x, ln_s, ln_b), 8 * x.numel(), PEAK_FP32),
          lambda: F.layer_norm(x, (hidden,), s16, b16, 1e-6))
    got = tln.layer_norm_bwd_rows(rows, g_rows, ln_s, 1e-6)
    torch.cuda.synchronize()
    ref = tln.layer_norm_bwd_rows_reference(rows, g_rows, ln_s, 1e-6)
    # dscale, dbias: fp32 sums of 16448 terms in another order
    err = max(check("layer_norm_pallas_bwd", name, a, b, bound)
              for name, a, b, bound in zip(
                  ("dx", "dscale", "dbias"), got, ref,
                  (ULP_BOUND, 1e-4, 1e-4)))
    xl = x.detach().clone().requires_grad_(True)
    sl, bl = (a.detach().clone().requires_grad_(True) for a in (s16, b16))
    ln_out = F.layer_norm(xl, (hidden,), sl, bl, 1e-6)
    timed("layer_norm_pallas_bwd", "", err,
          lambda: tln.layer_norm_bwd_rows(rows, g_rows, ln_s, 1e-6),
          lambda: tln.layer_norm_bwd_rows_reference(rows, g_rows, ln_s, 1e-6),
          50, (nbytes(x, g, ln_s, x, ln_s, ln_s), 14 * x.numel(), PEAK_FP32),
          lambda: torch.autograd.grad(ln_out, (xl, sl, bl), g,
                                      retain_graph=True))
    del xl, ln_out, y

    # ---- the launches a layer is made of, each alone at its shape ----
    # every residual but the probabilities (index 2), as rows
    x1, qkv, hc, y1, y2, ao = (r.view(m, -1)
                               for i, r in enumerate(res) if i != 2)
    wqkv, _, wo, w1, w2, pv, b1 = ops
    n1 = dl.layer_norm_rows(rows, pv[dlt.LN1_S], pv[dlt.LN1_B], 1e-6)
    hid = dl.gemm(n1, w1, b1, "gelu")
    dy = g_rows
    dbig = t(rng.standard_normal((m, mlp)) * 0.1)
    dqkv = t(rng.standard_normal((m, 3 * hidden)) * 0.1)

    def ragged_rows(label, outs, refs, bound):
        """The rows of the last, ragged row tile (M = 16448 = 128 x 128 +
        64) against the plain version, on their own."""
        first = m - m % 128
        err = max(max_err(a_[first:], b_[first:])[0]
                  for a_, b_ in zip(outs, refs))
        limit = bound * max(max(float(b_.float().abs().max())
                                for b_ in refs), 1.0)
        log(f"kernel dino_gemm_train {label}: rows {first}..{m - 1} of the "
            f"ragged last tile max_abs_err {err:.6g} (bound {limit:.6g})")
        if not err <= limit:
            raise AssertionError(f"dino_gemm_train {label}: ragged tile "
                                 f"{err} > {limit}")

    def poisoned_row_case(label, a, w, transpose_w, epilogue, with_pre):
        """The launch writes M rows and nothing past them: row M of a
        larger `out` (and second output) keeps the value put there."""
        n = w.shape[0] if transpose_w else w.shape[1]
        dtype = torch.float32 if epilogue == "f32" else torch.bfloat16
        bias = None if epilogue == "f32" else b1[:n].contiguous()
        out = torch.full((m + 1, n), 777.0, device=device, dtype=dtype)
        pre = torch.full_like(out, 777.0) if with_pre else None
        dl._launch_gemm(a, w, transpose_w, bias, None, None, out, pre, n,
                        epilogue)
        torch.cuda.synchronize()
        want = dl.gemm(a, w, bias, epilogue, transpose_w=transpose_w,
                       with_pre=with_pre)
        want = want if with_pre else (want,)
        for got, ref in zip((out, pre) if with_pre else (out,), want):
            if not (bool((got[m] == 777.0).all())
                    and torch.equal(got[:m], ref)):
                raise AssertionError(f"dino_gemm_train {label}: wrote past "
                                     "row M or changed with the buffer")
        log(f"kernel dino_gemm_train {label}: row {m} past M poisoned before "
            "the launch, untouched after it")

    def gemm_case(label, args, kw, library, f32=False):
        a, w = args[0], args[1]
        got = dl.gemm(*args, **kw)
        torch.cuda.synchronize()
        ref = dl.gemm_reference(*args, **kw)
        pairs = zip(got, ref) if isinstance(got, tuple) else [(got, ref)]
        # fp32 out: sums of K products in another order
        err = max(check("dino_gemm_train", label, a_, b_,
                        1e-4 if f32 else ULP_BOUND) for a_, b_ in pairs)
        outs = got if isinstance(got, tuple) else (got,)
        ragged_rows(label, outs, ref if isinstance(ref, tuple) else (ref,),
                    1e-4 if f32 else ULP_BOUND)
        again = dl.gemm(*args, **kw)
        again = again if isinstance(again, tuple) else (again,)
        if not all(torch.equal(a_, b_) for a_, b_ in zip(outs, again)):
            raise AssertionError(f"dino_gemm_train {label}: two runs differ")
        cfg = dl.gemm_config(a.shape[0], w.numel() // a.shape[1], a.shape[1])
        log(f"kernel dino_gemm_train {label}: two runs bit-equal; tile "
            f"{cfg.block_m}x{cfg.block_n}, split-K {cfg.split_k}")
        del again
        extra = [v for v in (*args[2:], *kw.values())
                 if isinstance(v, torch.Tensor)]
        timed("dino_gemm_train", label, err, lambda: dl.gemm(*args, **kw),
              lambda: dl.gemm_reference(*args, **kw), 10,
              (nbytes(a, w, *extra, *outs), 2 * a.shape[0] * w.numel(),
               PEAK_BF16), library)

    gemm_case("qkv [16448,768]x[768,2304]", (n1, wqkv, ops[1]), {},
              lambda: n1 @ wqkv)
    gemm_case("out-proj [16448,768]x[768,768] +residual, y1 stored",
              (ao, wo, pv[dlt.BO], "residual", rows, pv[dlt.LS1]),
              {"with_pre": True}, lambda: ao @ wo)
    gemm_case("fc1 [16448,768]x[768,3072] +gelu, hc stored",
              (n1, w1, b1, "gelu"), {"with_pre": True}, lambda: n1 @ w1)
    gemm_case("fc2 [16448,3072]x[3072,768] +residual, y2 stored",
              (hid, w2, pv[dlt.B2], "residual", x1, pv[dlt.LS2]),
              {"with_pre": True}, lambda: hid @ w2)
    gemm_case("dh [16448,768]x[3072,768]^T", (dy, w2, None),
              {"transpose_w": True}, lambda: dy @ w2.t())
    gemm_case("dao [16448,768]x[768,768]^T", (dy, wo, None),
              {"transpose_w": True}, lambda: dy @ wo.t())
    gemm_case("dn2 [16448,3072]x[768,3072]^T fp32 out", (dbig, w1, None,
                                                         "f32"),
              {"transpose_w": True}, lambda: dbig @ w1.t(), f32=True)
    gemm_case("dn1 [16448,2304]x[768,2304]^T fp32 out", (dqkv, wqkv, None,
                                                         "f32"),
              {"transpose_w": True}, lambda: dqkv @ wqkv.t(), f32=True)

    poisoned_row_case("fc1 +gelu, hc stored", n1, w1, False, "gelu", True)
    poisoned_row_case("dn2 ^T fp32 out", dbig, w1, True, "f32", False)

    def gemm_tn_case(label, a, b, time_it):
        got = dlt.gemm_tn(a, b)
        torch.cuda.synchronize()
        err = check("layer_gemm_tn", label, got, dlt.gemm_tn_reference(a, b),
                    ULP_BOUND)
        if not torch.equal(got, dlt.gemm_tn(a, b)):
            raise AssertionError(f"layer_gemm_tn {label}: two runs differ")
        rows_a, k1, n = *a.shape, b.shape[1]
        cfg = dlt.gemm_tn_config(rows_a, k1, n)
        tiles = (k1 // cfg.block_m) * (n // cfg.block_n)
        log(f"kernel layer_gemm_tn {label}: two runs bit-equal; tile "
            f"{cfg.block_m}x{cfg.block_n}, {-(-rows_a // 64)} row tiles split "
            f"{cfg.split}, grid ({tiles}, {cfg.split}) of "
            f"{dlt.gemm_tn_blocks_per_wave(cfg)} blocks a wave")
        if time_it:
            timed("layer_gemm_tn", label, err, lambda: dlt.gemm_tn(a, b),
                  lambda: dlt.gemm_tn_reference(a, b), 10,
                  (nbytes(a, b, got), 2 * rows_a * k1 * n, PEAK_BF16),
                  lambda: a.t() @ b)

    for label, a, b in (("dW2 [16448,3072]^T x [16448,768]", hid, dy),
                        ("dW1 [16448,768]^T x [16448,3072]", n1, dbig),
                        ("dWo [16448,768]^T x [16448,768]", ao, dy),
                        ("dWqkv [16448,768]^T x [16448,2304]", n1, dqkv)):
        gemm_tn_case(label, a, b, True)
    # a ragged last row tile (the rows past M are zero-filled by the copy)
    # and fewer rows than two row tiles (the 64 x 64 tile, no split)
    more = t(rng.standard_normal((37, mlp)))
    gemm_tn_case("ragged dW1 [16485,768]^T x [16485,3072]",
                 torch.cat([n1, more[:, :hidden]]),
                 torch.cat([dbig, more * 0.1]), False)
    gemm_tn_case("ragged dWo [16485,768]^T x [16485,768]",
                 torch.cat([ao, more[:, :hidden]]),
                 torch.cat([dy, more[:, hidden:2 * hidden]]), False)
    gemm_tn_case("dWo [99,768]^T x [99,768]", ao[:99].contiguous(),
                 dy[:99].contiguous(), False)
    del more

    def pass_case(name, label, kern, plain, args, bounds, ops_per_elt,
                  library=None):
        got = kern(*args)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        ref = plain(*args)
        ref = ref if isinstance(ref, tuple) else (ref,)
        err = max(check(name, f"{label} output {i}", a_, b_, bound)
                  for i, (a_, b_, bound) in enumerate(zip(got, ref, bounds)))
        tensors = [v for v in args if isinstance(v, torch.Tensor)]
        timed(name, label, err, lambda: kern(*args), lambda: plain(*args),
              20, (nbytes(*tensors, *got), ops_per_elt * args[0].numel(),
                   PEAK_FP32), library)

    dn = t(rng.standard_normal((m, hidden)) * 0.1, torch.float32)
    # the library's LayerNorm backward over the same rows: one aten call
    # (the bf16 cotangent: it takes the input's type), its statistics taken
    # outside the timed call
    ln_w = pv[dlt.LN2_S].bfloat16()
    _, ln_mean, ln_rstd = torch.ops.aten.native_layer_norm(
        rows, [hidden], ln_w, torch.zeros_like(ln_w), 1e-6)
    dn16 = dn.bfloat16()
    # fp32 column sums: 16448 terms in another order, and one-ulp flips of
    # single bf16 terms
    pass_case("layer_norm_bwd_rows", "(16448, 768), fp32 cotangent, added "
              "to the residual gradient", tln.layer_norm_bwd_rows,
              tln.layer_norm_bwd_rows_reference,
              (rows, dn, pv[dlt.LN2_S], 1e-6, g_rows),
              (ULP_BOUND, 1e-4, 1e-4), 14,
              lambda: torch.ops.aten.native_layer_norm_backward(
                  dn16, rows, [hidden], ln_mean, ln_rstd, ln_w,
                  torch.zeros_like(ln_w), [True, True, True]))
    pass_case("layer_scale_grad", "(16448, 768)", dlt.scale_grad,
              dlt.scale_grad_reference, (g_rows, y2, pv[dlt.LS2]),
              (ULP_BOUND, 1e-4, 2 ** -9), 4)
    pass_case("layer_gelu_bwd", "(16448, 3072)", dlt.gelu_bwd,
              dlt.gelu_bwd_reference, (hc, dbig),
              (ULP_BOUND, ULP_BOUND, 2 ** -9), 30)
    # the GELU pass computes h with kernel 9's erfc fit, so its h is the
    # fused GELU's (counted); the plain version (and the layer forward's
    # epilogue) take erf, whose 1 + erf(x / sqrt 2) cancels for x below ~-4:
    # there the two differ by more than an ulp of the tiny value, within
    # 1e-6. Counted at the layer's hc and at every finite bf16 input (dh =
    # 1, so dhc = bf16(gelu'(x)))
    every = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32,
                         device=device).to(torch.int16).view(torch.bfloat16)
    every = every[torch.isfinite(every.float())].view(-1, 8)
    for label, a, b in (("(16448, 3072)", hc, dbig),
                        (f"every finite bf16 input {tuple(every.shape)}",
                         every, torch.ones_like(every))):
        h, dhc, _ = dlt.gelu_bwd(a, b)
        ref_h, ref_dhc, _ = dlt.gelu_bwd_reference(a, b)
        torch.cuda.synchronize()
        fused = tg.gelu_exact_fused(a)
        if not float(bf16_ulps(h, fused).max()) <= 1.0:
            raise AssertionError(f"layer_gelu_bwd {label}: h beyond one ulp "
                                 "of the fused GELU's")
        outs = (("h", h, ref_h),) + ((("dhc", dhc, ref_dhc),)
                                     if a is every else ())
        counts = []
        for out, got, ref in outs:
            over = bf16_ulps(got, ref) > 1
            far = float((got.float() - ref.float()).abs()[over].max()) \
                if bool(over.any()) else 0.0
            x_over = a.float()[over]
            counts.append(
                f"{out} {int(over.sum())} beyond one ulp (x in "
                + (f"[{float(x_over.min()):g}, {float(x_over.max()):g}]"
                   if x_over.numel() else "none")
                + f", within {far:.3g}), {int((got != ref).sum())} differ")
            if not far <= 1e-6:
                raise AssertionError(f"layer_gelu_bwd {label} {out}: {far} "
                                     "beyond one ulp and 1e-6")
        log(f"kernel layer_gelu_bwd {label}: h differs from "
            f"gelu_exact_fused's at {int((h != fused).sum())}; against the "
            "plain (erf) version: " + "; ".join(counts) + f" of {a.numel()}")
    del every, h, dhc, ref_h, ref_dhc, fused
    pass_case("layer_colsum", "(16448, 2304)", dlt.colsum,
              dlt.colsum_reference, (dqkv,), (1e-4,), 1,
              lambda: dqkv.sum(0, dtype=torch.float32))
    # the column sum over a ragged row range, fewer rows than two parts and
    # the cuda test's shapes too: against its plain version and fp64, twice
    # bit for bit
    more = t(rng.standard_normal((37, 3 * hidden)) * 0.1)
    cases = [("(16448, 2304)", dqkv), ("(16485, 2304)",
                                       torch.cat([dqkv, more])),
             ("(99, 2304)", dqkv[:99].contiguous())] + [
        (f"({r}, {c})", t(rng.standard_normal((r, c)) * 0.1))
        for r, c in ((68, 128), (1028, 768), (300, 3072))]
    for label, a in cases:
        got = dlt.colsum(a)
        torch.cuda.synchronize()
        check("layer_colsum", label, got, dlt.colsum_reference(a), 1e-4)
        check("layer_colsum", f"{label} against fp64", got,
              a.double().sum(0), 1e-4)
        if not torch.equal(got, dlt.colsum(a)):
            raise AssertionError(f"layer_colsum {label}: two runs differ")
        cfg = dlt.colsum_config(*a.shape)
        log(f"kernel layer_colsum {label}: two runs bit-equal; grid "
            f"({cfg.strips}, {cfg.parts}) of {cfg.warps} warps")
    del more, cases

    return table.log_rows(f" at B={batch}, per layer")


def column_pass_phase(device):
    """Each device kernel of the column-sum passes apart (a pass and its
    finishing launch) at the training shapes, beside the one PyTorch call
    for the same function where there is one and the bound: the column sum
    of dqkv, the LayerScale and GELU backward passes, kernels 7 and 8
    forward and backward, and kernel 9's GELU (one launch). It calls the
    wrappers by their public signatures only, so the same phase reads an
    earlier tree's kernels."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from hypervla_tpu_torch.ops import add_layer_norm as aln
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import gelu as tg

    rows, hidden = TRAIN_BATCH * 257, 768
    rng = np.random.default_rng(SEED + 5)

    def t(shape, dtype=torch.bfloat16, scale=1.0, shift=0.0):
        return torch.tensor(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32),
            dtype=dtype, device=device)

    g, y, xn, delta = (t((rows, hidden)) for _ in range(4))
    ls = t((hidden,), torch.float32, 0.02, 0.1)
    scale = t((hidden,), torch.float32, 0.1, 1.0)
    bias = t((hidden,), torch.float32, 0.1)
    hc = t((rows, 4 * hidden), scale=1.5)
    dh = t((rows, 4 * hidden), scale=0.1)
    dqkv = t((rows, 3 * hidden), scale=0.1)
    h = t((TRAIN_BATCH, 257, 4 * hidden), scale=1.5)
    # (the call, the one PyTorch call for the same function or None, the
    # bytes the function moves)
    calls = {
        "layer_colsum (16448, 2304)": (
            lambda: dlt.colsum(dqkv),
            lambda: dqkv.sum(0, dtype=torch.float32),
            nbytes(dqkv) + 4 * 3 * hidden),
        "layer_scale_grad (16448, 768)": (
            lambda: dlt.scale_grad(g, y, ls), None,
            nbytes(g, y, g) + 4 * 3 * hidden),
        "layer_gelu_bwd (16448, 3072)": (
            lambda: dlt.gelu_bwd(hc, dh), None,
            nbytes(hc, dh, hc, hc) + 4 * 4 * hidden),
        "fused_add_scale_ln_fwd (16448, 768)": (
            lambda: aln.add_ln_fwd(xn, delta, ls, scale, bias, 1e-6), None,
            nbytes(xn, delta, xn, xn) + 4 * 3 * hidden),
        "fused_add_scale_ln_bwd (16448, 768)": (
            lambda: aln.add_ln_bwd(g, y, xn, delta, ls, scale, 1e-6), None,
            nbytes(g, y, xn, delta, g, g) + 4 * 5 * hidden),
        "fused_add_ln_fwd (16448, 768)": (
            lambda: aln.add_ln_fwd(xn, delta, None, scale, bias, 1e-6), None,
            nbytes(xn, delta, xn, xn) + 4 * 2 * hidden),
        "fused_add_ln_bwd (16448, 768)": (
            lambda: aln.add_ln_bwd(g, y, xn, None, None, scale, 1e-6), None,
            nbytes(g, y, xn, g) + 4 * 3 * hidden),
        "gelu_exact_fused (64, 257, 3072) bf16": (
            lambda: tg.gelu_exact_fused(h), lambda: F.gelu(h),
            nbytes(h, h)),
    }
    out = {}
    for label, (fn, library, moved) in calls.items():
        split = kernel_device_ms(fn, PROFILED_CALLS)
        lib = (sum(kernel_device_ms(library, PROFILED_CALLS).values())
               if library else None)
        log(f"kernel split {label} device_ms: " + ", ".join(
            f"{name} {ms:.6g}" for name, ms in split.items())
            + f"; total {sum(split.values()):.6g}; library_device_ms "
            + ("none" if lib is None else f"{lib:.6g}")
            + f"; bound_ms {moved / PEAK_BYTES * 1e3:.6g} (bytes)"
            + (f"; first version {FIRST_VERSION_DEVICE_MS[label]:.6g} "
               "(quoted)" if label in FIRST_VERSION_DEVICE_MS else ""))
        out[label] = split
    return out


def _cosine(a, b):
    a, b = a.detach().double().flatten(), b.detach().double().flatten()
    n = float(a.norm() * b.norm())
    if n == 0.0:
        return 1.0 if float((a - b).abs().max()) == 0.0 else 0.0
    return float(a @ b) / n


@contextlib.contextmanager
def fused_gelu_env(on):
    """HYPERVLA_FUSED_GELU=1 inside the block if `on`, restored after."""
    old = os.environ.get("HYPERVLA_FUSED_GELU")
    if on:
        os.environ["HYPERVLA_FUSED_GELU"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("HYPERVLA_FUSED_GELU", None)
        else:
            os.environ["HYPERVLA_FUSED_GELU"] = old


def train_phase(device):
    """Drives the full-width flagship's training step through the entry
    points of scripts/bench_train.py under four kernel configurations (the
    fast preset; the fast preset with the layer-kernel trunk; the fast
    preset with the fused residual boundaries and the fused GELU; the fast
    preset with the differentiable flash attention) and on the plain path.
    Returns each kernel configuration's launches."""
    import copy

    import torch

    from hypervla_tpu_torch.configs import apply_fast_training_preset
    from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import add_layer_norm as aln
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import flash_attention_train as ft
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.ops import gelu as tg
    from hypervla_tpu_torch.ops import layer_norm as tln
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import make_train_step, to_tensors
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    t0 = time.perf_counter()
    model, _ = build_flagship(seed=SEED, encoder_dtype="bfloat16",
                              training=True, device=device)
    fast = apply_fast_training_preset(copy.deepcopy(model.config))
    model = HyperVLA.from_config(fast, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device)
    # the layer-kernel trunk: every trunk layer through the layer kernel,
    # forward with residuals and backward; the final LayerNorm of both
    # encoders through the training LayerNorm
    layer = copy.deepcopy(fast)
    layer["hoist_shared_trunk"] = True
    layer["base_net_kwargs"]["vit_kwargs"].update(
        dino_layers_impl="pallas_train", fused_layer_norm="pallas_train",
        fine_tune_pretrained_image_encoder=True)
    # the fused residual boundaries: every LayerScale multiply, residual add
    # and the LayerNorm after it as one kernel, forward and backward; with
    # HYPERVLA_FUSED_GELU=1 during its steps, the trunk's GELU forward too
    fused = copy.deepcopy(fast)
    fused["base_net_kwargs"]["vit_kwargs"]["dino_fused_add_ln"] = True
    # the differentiable flash attention (scripts/bench_train.py --flash):
    # every trunk attention through it, forward and backward; the fused
    # training attention, which the JAX trunk takes first, off
    flash = copy.deepcopy(fast)
    flash["base_net_kwargs"]["vit_kwargs"].update(
        dino_fused_attention=False, use_flash_attention=True,
        flash_attention_trainable=True)
    # the plain path: the fast preset's step with the kernel switches off
    plain = copy.deepcopy(fast)
    plain["base_net_kwargs"]["vit_kwargs"]["dino_fused_attention"] = False
    plain["frozen_encoder_layer_kernel"] = False
    configs = {"plain": plain, "fast_preset": fast, "layer_kernel": layer,
               "fused_add_ln": fused, "flash_trainable": flash}
    kernel_configs = ("fast_preset", "layer_kernel", "fused_add_ln",
                      "flash_trainable")

    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **fast["optimizer"])
    state0 = TrainState.create(model.params, tx,
                               track_ema=fast.get("save_param_EMA", True))
    # the LR at its peak: the schedules read the optimizer's update count
    warmup = fast["optimizer"]["learning_rate"]["warmup_steps"]
    state0.step = warmup
    state0.opt_state["count"] = warmup
    steps, encoders, dino_applies, applies = {}, {}, {}, {}
    t5_params = None
    for name, config in configs.items():
        variant = model if config is fast else HyperVLA(
            model.hypernet, BaseNetwork(**config["base_net_kwargs"]), config,
            model.params, model.plan, None, device)
        # the same draws for every configuration; the frozen DINOv2's layers
        # packed for the layer forward, or left for the plain loop
        text_apply, dino_apply, t5, dino_params = build_frozen_encoders(
            config, device=device, seed=SEED + 1)
        t5_params = t5_params if t5_params is not None else t5
        del t5
        steps[name] = make_train_step(variant, config, tx, lr_fn, base_lr_fn,
                                      pnorm_fn, text_encode=text_apply,
                                      dino_encode=dino_apply)
        encoders[name] = {"t5": t5_params, "dino": dino_params}
        dino_applies[name] = dino_apply
        applies[name] = (text_apply, dino_apply)
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    # the step embeds the instruction and the initial image itself
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    batch = to_tensors(batch, device)
    n_params = sum(v.numel() for v in model.params.values())
    torch.cuda.synchronize()
    log(f"train build s {time.perf_counter() - t0:.3f}; {n_params} trained "
        f"params, batch {TRAIN_BATCH}, lr {lr_fn(warmup):.6g}")

    layers = model.base_net.encoder.dino.num_hidden_layers
    # launches per step of each wrapper that a configuration must show
    per_step = {
        "plain": {},
        "fast_preset": {"mha_fused_train_fwd": layers,
                        "mha_fused_train_bwd": layers,
                        "dino_layer_train_fwd": layers},
        "layer_kernel": {"dino_layer_train_fwd_res": layers,
                         "dino_layer_train_bwd": layers,
                         "dino_layer_train_fwd": layers,
                         "layer_norm_pallas_fwd": 2,
                         "layer_norm_pallas_bwd": 1},
        # every residual boundary but the last, forward and backward; one
        # GELU per trunk layer (the frozen encoder's is the GEMM epilogue)
        "fused_add_ln": {"mha_fused_train_fwd": layers,
                         "mha_fused_train_bwd": layers,
                         "dino_layer_train_fwd": layers,
                         "fused_add_scale_ln_fwd": 2 * layers - 1,
                         "fused_add_scale_ln_bwd": 2 * layers - 1,
                         "gelu_exact_fused": layers},
        # the trunk's attention, forward and backward, and no fused
        # training attention
        "flash_trainable": {"mha_flash_trainable_fwd": layers,
                            "mha_flash_trainable_bwd": layers,
                            "dino_layer_train_fwd": layers},
    }
    counted = sorted(set().union(*per_step.values()))
    counting = (fa, dlt, tln, dl, aln, tg, ft)

    def counts():
        return {**fa.LAUNCHES, **dlt.LAUNCHES, **tln.LAUNCHES,
                **aln.LAUNCHES, **tg.LAUNCHES, **ft.LAUNCHES,
                "dino_gemm_train": dl.LAUNCHES["dino_gemm"]}

    totals = {name: dict.fromkeys(counts(), 0) for name in configs}
    infos = {name: [] for name in configs}
    peaks = dict.fromkeys(configs, 0)

    def run(name, state, n, with_metrics=False):
        """n steps of one configuration from state, its launches counted
        from zero; (state, per-step device ms)."""
        for module in counting:
            module.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(n):
            before = counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            with fused_gelu_env(name == "fused_add_ln"):
                state, info = steps[name](state, batch,
                                          encoder_params=encoders[name],
                                          with_metrics=with_metrics)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            infos[name].append(info)
            after = counts()
            got = {k: after[k] - before[k] for k in counted}
            want = {k: per_step[name].get(k, 0) for k in counted}
            if got != want:
                raise AssertionError(f"{name} step launches {got}, want "
                                     f"{want}")
        for k, v in counts().items():
            totals[name][k] += v
        peaks[name] = max(peaks[name], torch.cuda.max_memory_allocated())
        return state, times

    # the main paths, counted: every launch below is a training step's
    states = {name: run(name, state0, 1, True)[0] for name in configs}
    first_p = infos["plain"][0]

    def updates_of(name):
        return {k: states[name].params[k].detach() - v.detach()
                for k, v in state0.params.items()}

    plain_updates = updates_of("plain")
    typical = statistics.median(float(p.norm())
                                for p in plain_updates.values())
    # the update (new - old) per leaf: Adam's first step is ~lr * sign(g),
    # so this compares the two paths' gradients leaf by leaf. A leaf whose
    # exact gradient is 0 barely moves: the context encoder's (the output
    # heads start at zero, so the generated weights do not depend on it yet)
    # and the key biases (softmax ignores a uniform key shift). On such a
    # leaf the kernels must move as little (tests/test_torch_train_step.py
    # holds the port to JAX by the same rule)
    degenerate = [k for k, p in plain_updates.items()
                  if float(p.norm()) < 1e-3 * typical]
    for name in kernel_configs:
        first_k = infos[name][0]
        for key in ("training_loss", "grad_norm"):
            a, b = float(first_k[key]), float(first_p[key])
            log(f"train {name} first step {key}: kernels {a:.6g} plain "
                f"{b:.6g} (rel {abs(a - b) / abs(b):.3g}, bound "
                f"{STEP_REL_BOUND})")
            if not abs(a - b) <= STEP_REL_BOUND * abs(b):
                raise AssertionError(f"{name}: first-step {key} kernels vs "
                                     "plain")
        updates = updates_of(name)
        worst = min((_cosine(updates[k], plain_updates[k]), k)
                    for k in updates if k not in degenerate)
        log(f"train {name} first step updates, kernels vs plain: lowest "
            f"per-leaf cosine {worst[0]:.6f} ({worst[1]}), bound "
            f"{COSINE_BOUND}; {len(degenerate)} leaves barely move (update "
            "below 1e-3 of the median leaf's)")
        if not worst[0] > COSINE_BOUND:
            raise AssertionError(f"{name}: the updates disagree with the "
                                 "plain path")
        for k in degenerate:
            if not float(updates[k].norm()) < 1e-2 * typical:
                raise AssertionError(f"{name} {k}: the plain path leaves it "
                                     "at noise")
        # and the post-update params themselves
        worst = min((_cosine(states[name].params[k],
                             states["plain"].params[k]), k)
                    for k in updates if k not in degenerate)
        log(f"train {name} first step post-update params, kernels vs "
            f"plain: lowest per-leaf cosine {worst[0]:.6f} ({worst[1]}), "
            f"bound {COSINE_BOUND}")
        if not worst[0] > COSINE_BOUND:
            raise AssertionError(f"{name}: post-update params disagree with "
                                 "the plain path")
        # fp32 copies of the trained params: not to be counted in the peak
        del updates
    log(f"train leaves that barely move: {sorted(degenerate)}")
    del plain_updates

    for name in configs:
        states[name], _ = run(name, states[name], TRAIN_WARMUP - 1)
    # timed steps, in turns: plain, kernels, kernels, plain
    half = TRAIN_STEPS // 2
    times = {name: [] for name in configs}
    for name in ("plain", *kernel_configs, *reversed(kernel_configs),
                 "plain"):
        states[name], more = run(name, states[name], half)
        times[name] += more
    for name in kernel_configs:
        log(f"train {name} launches over {len(infos[name])} steps: "
            f"{ {k: v for k, v in totals[name].items() if v} }")

    # the frozen DINOv2 encode of the initial images alone, in turns
    images = batch["initial_state"]["image_primary"].squeeze(1)

    def encode_ms(name, n=5):
        out = []
        with torch.no_grad():
            for _ in range(n):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dino_applies[name](encoders[name]["dino"], images)
                end.record()
                end.synchronize()
                out.append(start.elapsed_time(end))
        return out

    enc = {name: [] for name in configs}
    for name in ("plain", *kernel_configs, *reversed(kernel_configs),
                 "plain"):
        enc[name] += encode_ms(name)
    log(f"train frozen DINOv2 encode of {TRAIN_BATCH} images ms (median of "
        "CUDA events): " + ", ".join(
            f"{name} {statistics.median(v):.4f}" for name, v in enc.items()))

    for name in kernel_configs:
        losses = [float(info["training_loss"]) for info in infos[name]]
        log(f"train {name} losses: {[round(x, 4) for x in losses]}")
        if not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: train loss not finite or not "
                                 "falling")
    for name in configs:
        med = statistics.median(times[name])
        log(f"train {name} ms/step (median of CUDA events, {TRAIN_STEPS} "
            f"steps): {med:.4f}; samples/s {TRAIN_BATCH * 1e3 / med:.1f}; "
            f"peak memory (max_memory_allocated) "
            f"{peaks[name] / 2 ** 30:.3f} GiB")
    # where the step's time is: one profiled step of each configuration,
    # its device busy time against the unprofiled median above
    hand_fed = {}
    for name in configs:
        def one_step(name=name):
            with fused_gelu_env(name == "fused_add_ln"):
                steps[name](states[name], batch,
                            encoder_params=encoders[name], with_metrics=False)

        busy, count = device_busy(one_step, host=False)
        med = statistics.median(times[name])
        log(f"train {name} step profiled: device busy ms {busy:.3f}, "
            f"{count:.0f} device kernels, idle share {1 - busy / med:.3f} "
            f"of the {med:.4f} ms step")
        hand_fed[name] = {"ms": med, "busy_ms": busy, "kernels": count}
    fast_args = (model, fast, applies["fast_preset"],
                 encoders["fast_preset"], state0, batch)
    packed_check(steps["fast_preset"], *fast_args)
    delta_decay_check(*fast_args)
    return ({name: totals[name] for name in kernel_configs},
            hand_fed["fast_preset"])


#: the fp32 `--flash` configuration: timed steps after its first
FP32_FLASH_STEPS = 2


def flash_fp32_phase(device):
    """The JAX scripts/bench_train.py --flash without --fast: the
    full-width flagship from build_flagship(training=True), its trunk at
    the builder's fp32, every trunk attention through the differentiable
    flash attention (fp32 kernels, forward and backward), at batch
    TRAIN_BATCH. Its first step from the peak LR against the same
    configuration with the flash switches off (fp32 einsum attention):
    loss, grad_norm and each leaf's update under the train phase's bounds
    (and the einsum step traced once); then FP32_FLASH_STEPS timed steps,
    one traced, the peak memory, and the launches of each entry point,
    every one on fp32 tensors: returns them (FP32_LAUNCHES over its
    counted steps)."""
    import torch

    from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
    from hypervla_tpu_torch.ops import flash_attention_train as ft
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import to_tensors
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    t0 = time.perf_counter()
    flash = dict(use_flash_attention=True, flash_attention_trainable=True,
                 sow_dino_attention=False)
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    batch = to_tensors(batch, device)
    first, updates, counted = {}, {}, {}
    for name, overrides in (("einsum", None), ("flash", flash)):
        model, _ = build_flagship(seed=SEED, training=True,
                                  vit_overrides=overrides, device=device)
        config = model.config
        vk = config["base_net_kwargs"]["vit_kwargs"]
        if vk.get("encoder_dtype", "float32") != "float32":
            raise AssertionError(f"the {name} trunk is {vk['encoder_dtype']}")
        applies = build_frozen_encoders(config, device=device, seed=SEED + 1)
        step, tx = _fast_step(model, config, applies[:2])
        encoders = {"t5": applies[2], "dino": applies[3]}
        state = TrainState.create(model.params, tx,
                                  track_ema=config.get("save_param_EMA",
                                                       True))
        warmup = config["optimizer"]["learning_rate"]["warmup_steps"]
        state.step = warmup
        _opt_counts(state.opt_state, warmup)
        before = {k: v.detach().clone() for k, v in state.params.items()}
        ft.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, info = step(state, batch, encoder_params=encoders,
                           with_metrics=True)
        torch.cuda.synchronize()
        first[name] = info
        updates[name] = {k: state.params[k].detach() - v
                         for k, v in before.items()}
        del before
        if name == "einsum":
            if any(ft.LAUNCHES.values()):
                raise AssertionError(f"the einsum step launched {ft.LAUNCHES}")
            busy, kernels = device_busy(
                lambda: step(state, batch, encoder_params=encoders,
                             with_metrics=False), host=False)
            log(f"train fp32 einsum (flash off) step profiled: device busy ms "
                f"{busy:.3f}, {kernels:.0f} device kernels; peak memory "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
            del model, state, step, tx, encoders, applies
            torch.cuda.empty_cache()
            continue
        times = []
        for _ in range(FP32_FLASH_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = step(state, batch, encoder_params=encoders,
                            with_metrics=False)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        steps = 1 + FP32_FLASH_STEPS
        counted = {"all": dict(ft.LAUNCHES), "fp32": dict(ft.FP32_LAUNCHES)}
        want = dict.fromkeys(ft.LAUNCHES,
                             steps * model.base_net.encoder.dino
                             .num_hidden_layers)
        if counted["all"] != want or counted["fp32"] != want:
            raise AssertionError(f"fp32 flash launches over {steps} steps "
                                 f"{counted}, want {want} on fp32 tensors")
        peak = torch.cuda.max_memory_allocated()

        def one_step():
            step(state, batch, encoder_params=encoders, with_metrics=False)

        busy, kernels = device_busy(one_step, host=False)
        med = statistics.median(times)
        log(f"train fp32 flash ms/step (median of CUDA events, "
            f"{FP32_FLASH_STEPS} steps): {med:.4f}; samples/s "
            f"{TRAIN_BATCH * 1e3 / med:.1f}; peak memory "
            f"(max_memory_allocated) {peak / 2 ** 30:.3f} GiB; profiled "
            f"step: device busy ms {busy:.3f}, {kernels:.0f} device kernels, "
            f"idle share {1 - busy / med:.3f}; launches over {steps} steps "
            f"{counted['fp32']} (all on fp32 tensors)")
        del model, state, step, tx, encoders, applies
    for key in ("training_loss", "grad_norm"):
        a, b = float(first["flash"][key]), float(first["einsum"][key])
        log(f"train fp32 flash first step {key}: flash {a!r} einsum {b!r} "
            f"(rel {abs(a - b) / abs(b):.3g}, bound {STEP_REL_BOUND})")
        if not abs(a - b) <= STEP_REL_BOUND * abs(b):
            raise AssertionError(f"fp32 flash: first-step {key} against the "
                                 "einsum step")
    ref, got = updates["einsum"], updates["flash"]
    typical = statistics.median(float(p.norm()) for p in ref.values())
    degenerate = [k for k, p in ref.items()
                  if float(p.norm()) < 1e-3 * typical]
    worst = min((_cosine(got[k], ref[k]), k) for k in ref
                if k not in degenerate)
    log(f"train fp32 flash first step updates against einsum: lowest "
        f"per-leaf cosine {worst[0]:.6f} (1 - cosine {1 - worst[0]:.3g}; "
        f"{worst[1]}), bound {COSINE_BOUND}; {len(degenerate)} leaves "
        f"barely move; the largest update difference "
        f"{max(float((got[k] - ref[k]).abs().max()) for k in ref):.3g}")
    if not worst[0] > COSINE_BOUND:
        raise AssertionError("fp32 flash: the updates disagree with the "
                             "einsum step")
    for k in degenerate:
        if not float(got[k].norm()) < 1e-2 * typical:
            raise AssertionError(f"fp32 flash {k}: the einsum step leaves it "
                                 "at noise")
    del updates, ref, got
    torch.cuda.empty_cache()
    log(f"train fp32 flash phase s {time.perf_counter() - t0:.1f}")
    return counted["fp32"]


def _opt_counts(opt_state, count):
    """Sets every AdamW update count of an optimizer state (per-leaf:
    {"count", ...}; packed: {group: {"count", ...}}), in place."""
    if "count" in opt_state:
        opt_state["count"] = count
    else:
        for group in opt_state.values():
            group["count"] = count


def _fast_step(model, config, applies, **kwargs):
    """(make_train_step for config over the frozen encoders `applies`, the
    optimizer it was given)."""
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_step import make_train_step

    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **config["optimizer"])
    return make_train_step(model, config, tx, lr_fn, base_lr_fn, pnorm_fn,
                           text_encode=applies[0], dino_encode=applies[1],
                           **kwargs), tx


def packed_check(per_leaf_step, model, config, applies, encoder_params,
                 state0, batch):
    """The hand-fed fast-preset step with optimizer.packed=True (AdamW over
    one flat buffer per (label, decayed) group) beside the per-leaf step,
    from the same state at the peak LR: the new params bit-equal, each
    step's kernels from a trace, both timed in turns."""
    import copy

    import torch

    from hypervla_tpu_torch.train.train_state import TrainState

    packed = copy.deepcopy(config)
    packed["optimizer"]["packed"] = True
    packed_step, tx = _fast_step(model, packed, applies)
    state = TrainState(step=state0.step, params=state0.params,
                       opt_state=tx.init(state0.params),
                       ema_params=state0.ema_params, seed=state0.seed)
    _opt_counts(state.opt_state, state0.step)
    runs = {"per-leaf": (per_leaf_step, state0), "packed": (packed_step,
                                                            state)}

    def call(name):
        step_fn, start = runs[name]
        return step_fn(start, batch, encoder_params=encoder_params,
                       with_metrics=False)[0]

    new = {name: {k: v.detach() for k, v in call(name).params.items()}
           for name in runs}
    differ = [k for k in new["per-leaf"]
              if not torch.equal(new["per-leaf"][k], new["packed"][k])]
    worst = max(float((new["per-leaf"][k] - new["packed"][k]).abs().max())
                for k in new["per-leaf"])
    groups = {k: v["mu"].numel() for k, v in state.opt_state.items()}
    log(f"train packed AdamW ({len(groups)} groups: {groups}) against the "
        f"per-leaf AdamW, one fast-preset step from the same state: "
        f"{len(differ)} of {len(new['packed'])} leaves differ, max abs "
        f"{worst!r} (bound: bit-equal)")
    if differ:
        raise AssertionError(f"packed AdamW: the params differ from the "
                             f"per-leaf step's in {differ[:5]}")
    del new
    times = {name: [] for name in runs}
    for name in ("per-leaf", "packed", "packed", "per-leaf"):
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call(name)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
    for name in runs:
        busy, kernels = device_busy(lambda name=name: call(name), host=False)
        log(f"train fast preset, {name} AdamW: {kernels:.0f} device kernels "
            f"a step, device busy ms {busy:.3f}, ms/step (median of 4, CUDA "
            f"events, in turns) {statistics.median(times[name]):.4f}")


def delta_decay_check(model, config, applies, encoder_params, state0,
                      batch):
    """One hand-fed fast-preset step with delta-decay toward "pretrained"
    params, the trunk's initial ones (its whole tree in the JAX nesting),
    beside the same step without them, from the same state: every other
    leaf bit-equal, each trunk leaf moved by base_lr * base_weight_decay *
    its pretrained value (tests/test_train_step_numerics.py's rule: rtol
    2e-4, atol 1e-6)."""
    import copy

    import numpy as np
    import torch

    from hypervla_tpu_torch.models.weight_plan import WeightPlan
    from hypervla_tpu_torch.train.optimizer import create_lr_schedule
    from hypervla_tpu_torch.train.train_state import TrainState

    decay = copy.deepcopy(config)
    decay["optimizer"]["base_weight_decay"] = DELTA_DECAY
    prefix = "encoder/image_encoder/"
    trunk = {k: v.detach().clone()
             for k, v in model.shared_params(prefix, state0.params).items()}
    pretrained = {}
    for path, value in trunk.items():
        *parents, last = path.split("/")
        node = pretrained
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    plain_step, tx = _fast_step(model, decay, applies)
    decay_step, _ = _fast_step(model, decay, applies,
                               pretrained_params=pretrained)
    state = TrainState(step=state0.step, params=state0.params,
                       opt_state=tx.init(state0.params), seed=state0.seed)
    _opt_counts(state.opt_state, state0.step)
    plain, decayed = ({k: v.detach() for k, v in step_fn(
        state, batch, encoder_params=encoder_params,
        with_metrics=False)[0].params.items()}
        for step_fn in (plain_step, decay_step))
    lr = decay["optimizer"]["base_learning_rate"]
    coef = float(np.float32(create_lr_schedule(**lr)(state.step))
                 * np.float32(DELTA_DECAY))
    names = {WeightPlan.flat_name(prefix + k): k for k in trunk}
    bad, worst, largest = [], 0.0, 0.0
    for name, value in plain.items():
        if name not in names:
            if not torch.equal(value, decayed[name]):
                bad.append(name)
            continue
        want = coef * trunk[names[name]].reshape(-1)
        err = ((decayed[name] - value) - want).abs()
        worst = max(worst, float(err.max()))
        largest = max(largest, float(want.abs().max()))
        if not bool((err <= 1e-6 + 2e-4 * want.abs()).all()):
            bad.append(name)
    log(f"train delta-decay step (base_weight_decay {DELTA_DECAY}, coef "
        f"{coef:.6g}, the trunk's {len(names)} leaves as pretrained): the "
        f"{len(plain) - len(names)} other leaves bit-equal to the plain "
        f"step's; each trunk leaf's move beside coef * p_pretrained: max "
        f"abs error {worst!r} (largest term {largest!r}; bound 1e-6 + "
        "2e-4 |term|)")
    if bad:
        raise AssertionError(f"delta-decay step: {bad[:5]}")


def write_trainer_fixture(root, seed=SEED):
    """TRAINER_DATASETS datasets of TRAINER_TRAJS npz trajectories of
    TRAINER_TRAJ_LEN frames each under root, registered as an OXE named mix
    in the port's registry; returns (mix name, dataset names, encoding).
    The frames are uint8 RGB from a seed, JPEG where PIL is installed and
    raw arrays otherwise (obs_transforms.decode_image passes arrays
    through); the instructions alternate between drawer tasks and others."""
    import io

    import numpy as np

    from hypervla_tpu_torch.data.oxe.fixture_mix import (
        dataset_name,
        register_fixture_mix,
    )
    from hypervla_tpu_torch.data.sources import NpzTrajectorySource

    try:
        from PIL import Image
    except ImportError:
        Image = None

    def encoded(frame):
        if Image is None:
            return frame
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG")
        return buf.getvalue()

    rng = np.random.default_rng(seed)
    mix, _ = register_fixture_mix(TRAINER_DATASETS)
    names = [dataset_name(i) for i in range(TRAINER_DATASETS)]
    for d, name in enumerate(names):
        os.makedirs(os.path.join(root, name))
        for ep in range(TRAINER_TRAJS):
            n = TRAINER_TRAJ_LEN
            frames = rng.integers(0, 256, (n, TRAINER_FRAME, TRAINER_FRAME,
                                           3), dtype=np.uint8)
            images = (frames if Image is None else
                      np.array([encoded(f) for f in frames], dtype=object))
            task = TRAINER_TASKS[(d + ep) % len(TRAINER_TASKS)]
            NpzTrajectorySource.write_trajectory(
                os.path.join(root, name, f"ep_{ep:03d}.npz"),
                {"observation": {"image": images},
                 "action": rng.standard_normal((n, 7)).astype(np.float32),
                 "language_instruction": np.array([task] * n, dtype=object)})
    return mix, names, "raw" if Image is None else "JPEG"


class TrainerSteps:
    """Stands in for the trainer's make_train_step while in a `with`
    block: builds the real step and wraps it to hold every call to the
    launches `per_step` wants of the counted wrappers (read with `counts`),
    to keep the first `keep` calls' arguments and info (`kept`; `first`
    the first's) and `record(new state)` of every call (`records`);
    `rebuild()` makes the step again from the trainer's own arguments."""

    def __init__(self, trainer_module, counts, per_step, keep=1,
                 record=None):
        self.trainer = trainer_module
        self.counts = counts
        self.per_step = per_step
        self.keep = keep
        self.record = record
        self.kept = []
        self.records = []
        self.first = None
        self.calls = 0

    def __enter__(self):
        self.real = self.trainer.make_train_step
        self.trainer.make_train_step = self.make
        return self

    def __exit__(self, *exc):
        self.trainer.make_train_step = self.real
        return False

    def make(self, *args, **kwargs):
        self.args = (args, kwargs)
        step_fn = self.real(*args, **kwargs)

        def counted(state, batch, task_index=None, encoder_params=None,
                    with_metrics=True):
            before = self.counts()
            new_state, info = step_fn(state, batch, task_index,
                                      encoder_params, with_metrics)
            after = self.counts()
            got = {k: after[k] - before[k] for k in self.per_step}
            if got != self.per_step:
                raise AssertionError(f"trainer step {self.calls + 1} "
                                     f"launches {got}, want {self.per_step}")
            if len(self.kept) < self.keep:
                self.kept.append(dict(state=state, batch=batch,
                                      task_index=task_index,
                                      encoder_params=encoder_params,
                                      with_metrics=with_metrics, info=info))
                self.first = self.kept[0]
            if self.record is not None:
                self.records.append(self.record(new_state))
            self.calls += 1
            return new_state, info

        return counted

    def rebuild(self):
        args, kwargs = self.args
        return self.real(*args, **kwargs)


class LogRecorder:
    """The trainer's wandb_run: the logged dicts by step."""

    def __init__(self):
        self.logs = {}

    def log(self, metrics, step):
        self.logs.setdefault(step, {}).update(metrics)


def _same_state(a, b):
    """Whether two TrainStates are equal bit for bit (step, params,
    optimizer state, EMA)."""
    import torch

    def same(x, y):
        return set(x) == set(y) and all(
            x[k].dtype == y[k].dtype and torch.equal(x[k].detach(),
                                                     y[k].detach())
            for k in x)

    return (a.step == b.step and same(a.params, b.params)
            and same(a.ema_params, b.ema_params)
            and a.opt_state["count"] == b.opt_state["count"]
            and same(a.opt_state["mu"], b.opt_state["mu"])
            and same(a.opt_state["nu"], b.opt_state["nu"]))


def trainer_counts():
    """The launches so far of the wrappers the trainer phase counts."""
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa

    return {**fa.LAUNCHES, **dlt.LAUNCHES, **dl.LAUNCHES}


def trainer_phase(device, card, hand_fed):
    """The port's trainer on data at full width through its command line
    (module docstring, phase 6). Returns the launches of run A, counted
    from zero before it and read after it, and run A's per-step
    training_loss (the multi-device phase's trainer without a group)."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from hypervla_tpu_torch.configs import dinov2_config
    from hypervla_tpu_torch.eval.model_loading import (
        build_text_encoder,
        load_hypervla_policy,
    )
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from hypervla_tpu_torch.train.callbacks import SaveCallback
    from hypervla_tpu_torch.train.train_step import (
        augment_generator,
        augment_specs,
        device_augment,
    )

    def counts():
        return trainer_counts()

    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="hypervla_trainer_")
    try:
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        mix, names, encoding = write_trainer_fixture(data)
        log(f"trainer data: {TRAINER_DATASETS} datasets x {TRAINER_TRAJS} "
            f"trajectories x {TRAINER_TRAJ_LEN} frames of {TRAINER_FRAME}x"
            f"{TRAINER_FRAME} ({encoding}), mix {mix}, written in "
            f"{time.perf_counter() - t0:.2f} s")
        layers = dinov2_config(cli.load_config(TRAINER_CONFIG)[
            "base_net_kwargs"]["vit_kwargs"].get(
                "pretrained_encoder_name", "dinov2-base")).num_hidden_layers
        per_step = {"mha_fused_train_fwd": layers,
                    "mha_fused_train_bwd": layers,
                    "dino_layer_train_fwd": layers}
        save_dir = os.path.join(root, "run")

        def argv(steps):
            return ["--config", TRAINER_CONFIG, "--save_dir", save_dir,
                    f"--config.dataset_kwargs.oxe_mix={mix!r}",
                    f"--config.dataset_kwargs.data_dir={data!r}",
                    f"--config.dataset_kwargs.batch_size={TRAINER_BATCH}",
                    "--config.dataset_kwargs.shuffle_buffer_size="
                    f"{TRAINER_SHUFFLE}",
                    "--config.dataset_kwargs.resize_size="
                    "{'primary': (224, 224)}",
                    f"--config.num_steps={steps}", "--config.log_interval=1",
                    f"--config.save_interval={TRAINER_SAVE_EVERY}",
                    *(["--cpu"] if device.type == "cpu" else [])]

        # ---- run A: the main path, counted from zero ----
        for module in (fa, dlt, dl):
            module.reset_launch_counts()
        recorder = LogRecorder()
        t0 = time.perf_counter()
        # the command line's wandb run is the recorder
        real_wandb = cli._wandb_run
        cli._wandb_run = lambda args, config: recorder
        try:
            with TrainerSteps(trainer, counts, per_step) as steps_a:
                state_a = cli.main(argv(TRAINER_STEPS))
        finally:
            cli._wandb_run = real_wandb
        torch.cuda.synchronize()
        run_a_s = time.perf_counter() - t0
        launches = {k: v for k, v in counts().items() if k in per_step}
        if (state_a.step != TRAINER_STEPS or steps_a.calls != TRAINER_STEPS
                or launches != {k: v * TRAINER_STEPS
                                for k, v in per_step.items()}):
            raise AssertionError(f"run A: step {state_a.step}, "
                                 f"{steps_a.calls} steps, launches "
                                 f"{launches}")
        losses = [recorder.logs[s]["training_loss"]
                  for s in range(1, TRAINER_STEPS + 1)]
        drawer = [recorder.logs[s]["task_loss_close top drawer"]
                  for s in range(1, TRAINER_STEPS + 1)]
        if not all(map(math.isfinite, losses + drawer)):
            raise AssertionError(f"run A losses {losses}, drawer {drawer}")
        for step in (TRAINER_SAVE_EVERY, TRAINER_STEPS):
            for name in ("params.pt", "EMA_params.pt"):
                if not os.path.exists(os.path.join(save_dir, str(step),
                                                   name)):
                    raise AssertionError(f"run A wrote no {step}/{name}")
        log(f"trainer run A: {TRAINER_STEPS} steps in {run_a_s:.2f} s, "
            f"launches {launches} ({per_step} every step), losses "
            f"{[round(x, 4) for x in losses]}, close-top-drawer losses "
            f"{[round(x, 4) for x in drawer]}")

        # the first step, again, from make_train_step called directly
        first = steps_a.first
        step_fn = steps_a.rebuild()
        _, info = step_fn(first["state"], first["batch"],
                          first["task_index"], first["encoder_params"],
                          with_metrics=True)
        for key in ("training_loss", "grad_norm"):
            a, b = first["info"][key], info[key]
            log(f"trainer first step {key}: trainer {float(a)!r}, "
                f"make_train_step {float(b)!r}")
            if not torch.equal(a, b):
                raise AssertionError(f"trainer first step {key} is not the "
                                     "hand-fed step's bit for bit")

        # where a trainer step's time goes
        totals = [recorder.logs[s]["timer/total"]
                  for s in range(2, TRAINER_STEPS + 1)]
        wait = [recorder.logs[s]["timer/dataset"]
                for s in range(2, TRAINER_STEPS + 1)]
        train_s = [recorder.logs[s]["timer/train"]
                   for s in range(2, TRAINER_STEPS + 1)]
        med_ms = statistics.median(totals) * 1e3

        def one_step():
            step_fn(first["state"], first["batch"], first["task_index"],
                    first["encoder_params"], with_metrics=False)

        busy, kernels = device_busy(one_step, host=False)

        def alone_ms(with_metrics, n=3):
            out = []
            for _ in range(n):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                step_fn(first["state"], first["batch"], first["task_index"],
                        first["encoder_params"], with_metrics=with_metrics)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t1) * 1e3)
            return statistics.median(out)

        log(f"trainer step alone (make_train_step on run A's first batch, "
            f"median of 3, host clock): with metrics "
            f"{alone_ms(True):.4f} ms, without {alone_ms(False):.4f} ms; "
            f"card {card}")
        log(f"trainer ms/step {med_ms:.4f} (median of the timer's total over "
            f"steps 2-{TRAINER_STEPS}: {[round(t * 1e3, 2) for t in totals]}"
            f"), samples/s {TRAINER_BATCH * 1e3 / med_ms:.1f}; dataset share "
            f"{sum(wait) / sum(totals):.3f}, train share "
            f"{sum(train_s) / sum(totals):.3f}; card {card}")
        log(f"trainer step profiled: device busy ms {busy:.3f}, "
            f"{kernels:.0f} device kernels, idle share "
            f"{1 - busy / med_ms:.3f} of the {med_ms:.4f} ms trainer step; "
            f"the train phase's hand-fed fast preset step: "
            f"{hand_fed['ms']:.4f} ms, device busy {hand_fed['busy_ms']:.3f}"
            f" ms, {hand_fed['kernels']:.0f} kernels; card {card}")
        del step_fn, first, steps_a

        # ---- run B: resume from state/latest.pt to TRAINER_RESUME_TO ----
        restored, restored_step = SaveCallback(save_dir).restore(state_a)
        if restored_step != TRAINER_STEPS or not _same_state(restored,
                                                             state_a):
            raise AssertionError("state/latest.pt is not run A's last state "
                                 "bit for bit")
        del restored
        t0 = time.perf_counter()
        with TrainerSteps(trainer, counts, per_step) as steps_b:
            state_b = cli.main(argv(TRAINER_RESUME_TO))
        if (state_b.step != TRAINER_RESUME_TO
                or steps_b.calls != TRAINER_RESUME_TO - TRAINER_STEPS
                or not _same_state(steps_b.first["state"], state_a)):
            raise AssertionError("run B did not resume from run A's last "
                                 "state bit for bit")
        log(f"trainer run B: resumed at step {TRAINER_STEPS} from run A's "
            f"last state (params, optimizer state and EMA bit for bit), "
            f"{steps_b.calls} steps to {state_b.step} in "
            f"{time.perf_counter() - t0:.2f} s")
        del state_b, steps_b

        # ---- run C: a dataset list, validation and device augmentation ----
        config = cli.load_config(TRAINER_CONFIG)
        dk = config["dataset_kwargs"]
        dk.update(oxe_mix=None, batch_size=TRAINER_BATCH,
                  shuffle_buffer_size=TRAINER_SHUFFLE, device_augment=True,
                  image_augment_kwargs=copy.deepcopy(TRAINER_AUGMENT),
                  dataset_kwargs_list=[dict(
                      name=name, data_dir=data,
                      image_obs_keys={"primary": "image"},
                      language_key="language_instruction",
                      action_proprio_normalization_type="normal",
                      add_initial_image=True) for name in names])
        config.update(eval_datasets=[names[0]],
                      eval_interval=TRAINER_AUG_STEPS, log_interval=1)
        recorder_c = LogRecorder()
        t0 = time.perf_counter()
        with TrainerSteps(trainer, counts, per_step) as steps_c:
            trainer.train(config, num_steps=TRAINER_AUG_STEPS,
                          wandb_run=recorder_c, device=device)
        mse = recorder_c.logs[TRAINER_AUG_STEPS][
            f"validation/{names[0]}/mse"]
        if not math.isfinite(mse):
            raise AssertionError(f"run C validation MSE {mse}")
        specs = augment_specs(config)
        frames = steps_c.first["batch"]["observation"]["image_primary"]

        def augmented():
            batch = {"observation": {"image_primary": frames}}
            device_augment(batch, specs, augment_generator(
                config["seed"], 0, device))
            return batch["observation"]["image_primary"]

        once, twice = augmented(), augmented()
        if not torch.equal(once, twice) or torch.equal(once, frames):
            raise AssertionError("device augmentation does not repeat under "
                                 "its seed, or is the identity")
        changed = float((once != frames).float().mean())
        log(f"trainer run C: {steps_c.calls} steps over a dataset list with "
            f"device augmentation in {time.perf_counter() - t0:.2f} s, "
            f"validation MSE {mse:.6g}; the augmentation of a "
            f"{tuple(frames.shape)} batch repeats bit for bit and changes "
            f"{changed:.3f} of its values")
        del steps_c, frames, once, twice

        # ---- serve run A's checkpoint on kernel 1 ----
        policy = load_hypervla_policy(save_dir, step=TRAINER_STEPS,
                                      device=device, fused_serving=True)
        encode = build_text_encoder(policy.model)
        _, dino_apply, _, dino_params = trainer.build_frozen_encoders(
            policy.model.config, device=device)
        rng = np.random.default_rng(SEED)
        served_frames = rng.integers(0, 256, (TRAINER_SERVED, 256, 256, 3),
                                     dtype=np.uint8)
        with torch.no_grad():
            patches = dino_apply(dino_params, torch.as_tensor(
                served_frames[:1, 16:240, 16:240], device=device))
        task = TRAINER_TASKS[0].decode()
        policy.reset(task, encode(task), {"patch_embeddings": patches})
        for i, frame in enumerate(served_frames):
            before = counts()["dino_layers_serving"]
            _, action, *_ = policy.step(frame)
            if (counts()["dino_layers_serving"] - before != 1
                    or action.shape != (7,)
                    or not np.isfinite(action).all()):
                raise AssertionError(f"served step {i}: action {action}")
        log(f"trainer checkpoint served: {TRAINER_SERVED} fused serving "
            f"steps of run A's step-{TRAINER_STEPS} EMA params through "
            "load_hypervla_policy(fused_serving=True), one stacked-trunk "
            "launch and a finite (7,) action each")
        del policy, state_a
        torch.cuda.empty_cache()
        finetune_phase(device, card, root, data, mix, save_dir, per_step)
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches, losses


FINETUNE_CONFIG_FILE = """from hypervla_tpu_torch.configs import (
    apply_fast_training_preset,
    finetune_config,
)


def get_config(string):
    config = apply_fast_training_preset(finetune_config(string))
    config["dataset_kwargs"].update(oxe_mix={mix!r}, data_dir={data!r})
    return config
"""


def finetune_phase(device, card, root, data, mix, pretrained, per_step):
    """Fine-tuning through the command line as a user runs it (module
    docstring, phase 6): a config file whose get_config returns the JAX
    package's fine-tune config for the fixture mix with the fast preset,
    FINETUNE_MODE, gradient accumulation FINETUNE_ACCUMULATION at batch
    TRAINER_BATCH, warm-started from `pretrained`'s step-TRAINER_STEPS EMA
    params, for FINETUNE_STEPS steps."""
    import torch

    from hypervla_tpu_torch.configs import FROZEN_KEYS_BY_MODE
    from hypervla_tpu_torch.models.hypervla import EMA_FILE
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from hypervla_tpu_torch.train.optimizer import frozen_names

    config_path = os.path.join(root, "finetune_fixture.py")
    with open(config_path, "w") as f:
        f.write(FINETUNE_CONFIG_FILE.format(mix=mix, data=data))
    warm = torch.load(os.path.join(pretrained, str(TRAINER_STEPS), EMA_FILE),
                      map_location=device, weights_only=True)["EMA_0.999"]
    frozen = frozen_names(warm, FROZEN_KEYS_BY_MODE[FINETUNE_MODE])
    trainable = sorted(set(warm) - frozen)
    argv = ["--config", f"{config_path}:vit_t,fixture,{FINETUNE_MODE}",
            "--save_dir", os.path.join(root, "finetune"),
            f"--config.pretrained_checkpoint_path={pretrained!r}",
            f"--config.pretrained_checkpoint_step={TRAINER_STEPS}",
            "--config.optimizer.grad_accumulation_steps="
            f"{FINETUNE_ACCUMULATION}",
            # the LR at its peak from the first applied update
            "--config.optimizer.learning_rate.warmup_steps=0",
            f"--config.dataset_kwargs.batch_size={TRAINER_BATCH}",
            f"--config.dataset_kwargs.shuffle_buffer_size={TRAINER_SHUFFLE}",
            f"--config.num_steps={FINETUNE_STEPS}", "--config.log_interval=1"]
    for module in (fa, dlt, dl):
        module.reset_launch_counts()
    recorder = LogRecorder()
    real_wandb = cli._wandb_run
    cli._wandb_run = lambda args, config: recorder
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with TrainerSteps(trainer, trainer_counts, per_step, keep=2,
                          record=lambda s: {k: s.params[k].detach().clone()
                                            for k in trainable}) as steps:
            state = cli.main(argv)
    finally:
        cli._wandb_run = real_wandb
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in trainer_counts().items() if k in per_step}
    if (state.step != FINETUNE_STEPS or steps.calls != FINETUNE_STEPS
            or launches != {k: v * FINETUNE_STEPS
                            for k, v in per_step.items()}):
        raise AssertionError(f"fine-tune: step {state.step}, {steps.calls} "
                             f"steps, launches {launches}")
    tx = steps.args[0][2]
    if tx.frozen != frozen or tx.k != FINETUNE_ACCUMULATION:
        raise AssertionError("fine-tune: the trainer's optimizer is not the "
                             "config's")
    moved_frozen = [k for k in frozen if not torch.equal(
        state.params[k].detach(), warm[k])]
    if moved_frozen:
        raise AssertionError(f"fine-tune: frozen leaves moved: "
                             f"{moved_frozen[:5]}")
    # each call's trainable leaves against the call before (the warm start
    # before the first): still on the calls that accumulate, moved on every
    # leaf on the calls that apply
    before = {k: warm[k] for k in trainable}
    for call, now in enumerate(steps.records, 1):
        applies = call % FINETUNE_ACCUMULATION == 0
        moved = [k for k in trainable if not torch.equal(now[k], before[k])]
        if moved != (trainable if applies else []):
            raise AssertionError(f"fine-tune step {call}: {len(moved)} of "
                                 f"{len(trainable)} trainable leaves moved")
        before = now
    losses = [recorder.logs[s]["training_loss"]
              for s in range(1, FINETUNE_STEPS + 1)]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"fine-tune losses {losses}")
    n_frozen = sum(warm[k].numel() for k in frozen)
    n_trainable = sum(warm[k].numel() for k in trainable)
    log(f"finetune: {FINETUNE_MODE} from the trainer's step-{TRAINER_STEPS} "
        f"EMA params, accumulation {FINETUNE_ACCUMULATION}, batch "
        f"{TRAINER_BATCH}: {FINETUNE_STEPS} steps in {run_s:.2f} s; "
        f"{len(frozen)} leaves ({n_frozen} params) frozen and bit-equal to "
        f"the warm start, the {len(trainable)} trainable ({n_trainable} "
        "params) still on the accumulating steps and all moved on the "
        f"applying ones; launches {launches} ({per_step} every step); "
        f"losses {[round(x, 4) for x in losses]}")
    totals = [recorder.logs[s]["timer/total"]
              for s in range(2, FINETUNE_STEPS + 1)]
    med_ms = statistics.median(totals) * 1e3
    step_fn = steps.rebuild()
    traced = []
    # without the logged step's norms, as the other phases trace a step,
    # and the applying step with them, as this run logged every step
    for kind, kept, with_metrics in (("accumulating", steps.kept[0], False),
                                     ("applying", steps.kept[1], False),
                                     ("applying, with metrics",
                                      steps.kept[1], True)):
        def one_step(kept=kept, with_metrics=with_metrics):
            step_fn(kept["state"], kept["batch"], kept["task_index"],
                    kept["encoder_params"], with_metrics=with_metrics)

        busy, kernels = device_busy(one_step, host=False)
        traced.append(f"{kind}: device busy ms {busy:.3f}, {kernels:.0f} "
                      f"device kernels, idle share {1 - busy / med_ms:.3f}")
    log(f"finetune ms/step {med_ms:.4f} (median of the timer's total over "
        f"steps 2-{FINETUNE_STEPS}: {[round(t * 1e3, 2) for t in totals]}, "
        f"logged every step), samples/s {TRAINER_BATCH * 1e3 / med_ms:.1f}; "
        f"peak memory (max_memory_allocated) {peak / 2 ** 30:.3f} GiB; "
        f"traced steps: {'; '.join(traced)}; card {card}")
    del steps, step_fn, state, warm
    torch.cuda.empty_cache()


#: the regularised phase: every dropout rate and the embedding noise, the
#: aux-loss coefficients, its timed steps, the remat settings in turns
REG_RATE = 0.1
REG_ENTROPY, REG_ALIGNMENT = 0.1, 0.2
REG_STEPS = 2
REMAT_SETTINGS = {"off": {}, "remat_dino": {"remat_dino": True},
                  "dots": {"dino_remat_policy": "dots"},
                  "nothing": {"dino_remat_policy": "nothing"}}
ROW_SUM_BOUND = 1e-3


def regularised_phase(device, card):
    """Drives the flagship's regularised training step (full width and
    depth, the fast preset, batch 64): (a) the six dropout rates and the
    trunk's embedding noise at REG_RATE on kernels 2 and 3, the step
    repeated from one state and (seed, step) bit for bit, each site's kept
    fraction, the loss beside the same step without them, ms/step, and
    device busy and kernels beside that step's; (b) the trunk's layer
    remat off, remat_dino, "dots" and "nothing" from one state with the
    same draws: the gradients against the step without remat, peak
    memory, device busy and kernel 2's launches; (c) both attention aux
    losses on the trunk's capture route, then one served
    InferenceWrapper(save_attention_map=True) step from the trained
    model's checkpoint: the maps' shapes and row sums.
    Returns the regularised step's launches."""
    import copy
    import tempfile

    import numpy as np
    import torch

    from hypervla_tpu_torch.configs import apply_fast_training_preset
    from hypervla_tpu_torch.eval.inference import (
        InferenceWrapper,
        initial_state,
    )
    from hypervla_tpu_torch.flagship import build_flagship, make_flagship_batch
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.draws import Draws, draws_generator
    from hypervla_tpu_torch.models.hypernetwork import HyperNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import (
        REFERENCE_MAP,
        make_train_step,
        to_tensors,
    )
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED + 15)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False]),
    }}
    base, _ = build_flagship(seed=SEED, encoder_dtype="bfloat16",
                             training=True, device=device)
    fast = apply_fast_training_preset(copy.deepcopy(base.config))
    del base
    reg = copy.deepcopy(fast)
    hk = reg["hypernet_kwargs"]
    hk.update(image_dropout=REG_RATE, embedding_dropout_rate=REG_RATE,
              final_dropout_rate=REG_RATE)
    hk["context_encoder_kwargs"].update(dropout_rate=REG_RATE,
                                        attention_dropout_rate=REG_RATE)
    reg["base_net_kwargs"]["vit_kwargs"].update(
        dropout_rate=REG_RATE, image_embedding_noise=REG_RATE)
    model = HyperVLA.from_config(reg, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device,
                                 dataset_statistics=stats)
    capture = copy.deepcopy(reg)
    capture["auxiliary_loss"].update(attention_entropy=REG_ENTROPY,
                                     attention_map_alignment=REG_ALIGNMENT)
    capture["base_net_kwargs"]["vit_kwargs"].update(
        return_attention_map=True, sow_dino_attention=True)
    configs = {"zero": fast, "dropout": reg, "capture": capture}
    for name, change in REMAT_SETTINGS.items():
        configs[f"remat_{name}"] = copy.deepcopy(reg)
        configs[f"remat_{name}"]["base_net_kwargs"]["vit_kwargs"].update(
            change)

    def variant(config):
        return HyperVLA(HyperNetwork(model.plan, config["hypernet_kwargs"]),
                        BaseNetwork(**config["base_net_kwargs"]), config,
                        model.params, model.plan, stats, device,
                        model.example_batch)

    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **reg["optimizer"])
    text_apply, dino_apply, t5, dino_params = build_frozen_encoders(
        reg, device=device, seed=SEED + 1)
    encoders = {"t5": t5, "dino": dino_params}
    models = {name: variant(config) for name, config in configs.items()}
    steps = {name: make_train_step(models[name], config, tx, lr_fn,
                                   base_lr_fn, pnorm_fn,
                                   text_encode=text_apply,
                                   dino_encode=dino_apply)
             for name, config in configs.items()}
    state0 = TrainState.create(model.params, tx, seed=SEED)
    warmup = reg["optimizer"]["learning_rate"]["warmup_steps"]
    state0.step = warmup
    state0.opt_state["count"] = warmup
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    reference = rng.random((TRAIN_BATCH, 12, 1, 257)).astype(np.float32)
    batch["observation"][REFERENCE_MAP] = reference / reference.sum(
        -1, keepdims=True)
    batch = to_tensors(batch, device)
    torch.cuda.synchronize()
    log(f"regularised build s {time.perf_counter() - t0:.3f}; batch "
        f"{TRAIN_BATCH}, every dropout rate and image_embedding_noise "
        f"{REG_RATE}; {card}")

    def counts():
        return {**fa.LAUNCHES, **dlt.LAUNCHES}

    def reset():
        for module in (fa, dlt):
            module.reset_launch_counts()

    def run(name, state=state0, draws=None):
        return steps[name](state, batch, encoder_params=encoders,
                           with_metrics=False, draws=draws)

    # ---- (a) dropout and noise, on kernels 2 and 3: the main path ----
    reset()
    first, info = run("dropout")
    torch.cuda.synchronize()
    launches = counts()
    log(f"regularised step launches: {launches}; {card}")
    for kernel in ("mha_fused_train_fwd", "mha_fused_train_bwd",
                   "dino_layer_train_fwd"):
        if not launches.get(kernel):
            raise AssertionError(f"the regularised step did not launch "
                                 f"{kernel}")
    again, _ = run("dropout")
    same = all(torch.equal(first.params[k], again.params[k])
               for k in first.params)
    log(f"regularised step repeated from one state and (seed, step): "
        f"new params bit-equal {same}; {card}")
    if not same:
        raise AssertionError("the regularised step does not repeat bit for "
                             "bit")
    del again
    draws = Draws(draws_generator(state0.seed, state0.step, device),
                  record=True)
    replayed, _ = run("dropout", draws=draws)
    if not all(torch.equal(first.params[k], replayed.params[k])
               for k in first.params):
        raise AssertionError("the step's own draws are not those of "
                             "draws_generator(seed, step)")
    del replayed
    kept = {}
    for site, value in sorted(draws.drawn.items()):
        if value.dtype == torch.bool:
            kept[site] = float(value.float().mean())
            sigma = (REG_RATE * (1 - REG_RATE) / value.numel()) ** 0.5
            if abs(kept[site] - (1 - REG_RATE)) > 6 * sigma:
                raise AssertionError(f"{site} keeps {kept[site]}")
        else:
            log(f"regularised embedding noise {tuple(value.shape)}: mean "
                f"{float(value.mean()):.6g}, std {float(value.std()):.6g}")
    del draws
    log(f"regularised kept fraction per site ({len(kept)} sites, rate "
        f"{REG_RATE}): " + ", ".join(f"{k} {v:.6f}" for k, v in kept.items())
        + f"; {card}")
    _, zero_info = run("zero")
    log(f"regularised loss {float(info['training_loss']):.6g}, the same step "
        f"without dropout and noise {float(zero_info['training_loss']):.6g}"
        f"; {card}")
    if not math.isfinite(float(info["training_loss"])):
        raise AssertionError("the regularised loss is not finite")
    times, state = [], first
    for _ in range(REG_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, _ = run("dropout", state)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del state, first
    busy, kernels = device_busy(lambda: run("dropout"), host=False)
    zero_busy, zero_kernels = device_busy(lambda: run("zero"), host=False)
    med = statistics.median(times)
    log(f"regularised ms/step (median of CUDA events, {REG_STEPS} steps) "
        f"{med:.4f}; step profiled: device busy ms {busy:.3f}, "
        f"{kernels:.0f} device kernels, idle share {1 - busy / med:.3f}; "
        f"the same step without dropout and noise: device busy ms "
        f"{zero_busy:.3f}, {zero_kernels:.0f} device kernels; {card}")

    # ---- (b) layer remat: the same state and draws, in turns ----
    def grads_of(name):
        for p in state0.params.values():
            p.grad = None
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset()
        run(name)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        fwd = fa.LAUNCHES["mha_fused_train_fwd"]
        bwd = fa.LAUNCHES["mha_fused_train_bwd"]
        return peak, fwd, bwd

    grads_off = None
    remat = {}
    for name in REMAT_SETTINGS:
        peak, fwd, bwd = grads_of(f"remat_{name}")
        if grads_off is None:
            grads_off = {k: p.grad.clone() for k, p in state0.params.items()
                         if p.grad is not None}
            diff = 0.0
        else:
            diff = max(float((state0.params[k].grad - g).abs().max())
                       for k, g in grads_off.items())
        remat[name] = {"peak": peak, "fwd": fwd, "bwd": bwd, "diff": diff}
    del grads_off
    for p in state0.params.values():
        p.grad = None
    for name in REMAT_SETTINGS:
        remat[name]["busy"], remat[name]["kernels"] = device_busy(
            lambda: run(f"remat_{name}"), host=False)
    for name, r in remat.items():
        log(f"regularised remat {name}: gradients against remat off max abs "
            f"diff {r['diff']:.6g}, peak memory (max_memory_allocated) "
            f"{r['peak'] / 2 ** 30:.3f} GiB, device busy ms {r['busy']:.3f} "
            f"({r['kernels']:.0f} device kernels), kernel 2 launches forward "
            f"{r['fwd']} backward {r['bwd']}; {card}")
        if r["diff"] != 0.0:
            raise AssertionError(f"remat {name} changes the gradients")

    # ---- (c) attention capture, both aux losses, save_attention_map ----
    reset()
    trained, info = run("capture")
    torch.cuda.synchronize()
    log("regularised capture step: loss "
        f"{float(info['training_loss']):.6g}, attention_entropy_loss "
        f"{float(info['attention_entropy_loss']):.6g}, "
        f"attention_alignment_loss "
        f"{float(info['attention_alignment_loss']):.6g}, launches "
        f"{ {k: v for k, v in counts().items() if v} }; {card}")
    for key in ("training_loss", "attention_entropy_loss",
                "attention_alignment_loss"):
        if not math.isfinite(float(info[key])):
            raise AssertionError(f"capture step {key} is not finite")
    served = models["capture"].replace(params={
        k: v.detach() for k, v in trained.params.items()})
    del trained
    frame = np.random.default_rng(SEED + 16).integers(
        0, 256, (256, 320, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as root:
        served.save_pretrained(1, root)
        loaded = HyperVLA.load_pretrained(root, device=device)
    wrapper = InferenceWrapper(
        loaded, policy_setup="google_robot", image_size=224, crop=True,
        fused_serving=True, save_attention_map=True,
        pred_action_horizon=capture["base_net_kwargs"]["action_horizon"])
    if wrapper.fused_serving or wrapper.trunk_impl != "layers":
        raise AssertionError("save_attention_map did not take the host "
                             "path's layer loop")
    full = {}
    extract = wrapper._extract_attention_maps
    wrapper._extract_attention_maps = lambda maps: (full.update(maps),
                                                    extract(maps))
    instruction = {"language_instruction": {
        k: v[:1] for k, v in make_flagship_batch(seed=SEED)["task"][
            "language_instruction"].items()}}
    wrapper.reset("pick up the cube", instruction,
                  initial_state(loaded, frame))
    raw, _, _, _, _ = wrapper.step(frame)
    sums = {name: max(float((torch.stack(full[name]).float().sum(-1) - 1
                             ).abs().max()), 0.0)
            for name in ("dino", "policy")}
    log(f"regularised served step: dino_attention_map "
        f"{wrapper.dino_attention_map.shape}, head_attention_map "
        f"{wrapper.head_attention_map.shape}; full rows: trunk "
        f"{tuple(torch.stack(full['dino']).shape)}, policy "
        f"{tuple(torch.stack(full['policy']).shape)}, largest |row sum - 1| "
        f"trunk {sums['dino']:.6g} policy {sums['policy']:.6g} (bound "
        f"{ROW_SUM_BOUND}); action finite {bool(np.isfinite(raw).all())}; "
        f"{card}")
    vit = loaded.base_net.encoder
    want = ((vit.dino.num_hidden_layers, vit.dino.num_attention_heads,
             vit.n_patch), (vit.num_layers, vit.num_heads, vit.n_patch))
    if ((wrapper.dino_attention_map.shape,
         wrapper.head_attention_map.shape) != want
            or max(sums.values()) > ROW_SUM_BOUND
            or not np.isfinite(raw).all()):
        raise AssertionError("the captured maps are not the expected shape "
                             "or their rows do not sum to 1")
    log(f"regularised phase s {time.perf_counter() - t0:.3f}")
    return launches


#: the SmallStem phase's config: the published vit_t config for a dataset
#: other than oxe, with the command-line overrides that make its base net
#: the SmallStem ViT with the continuous head
SMALLSTEM_CONFIG = "vit_t,fixture"
SMALLSTEM_OVERRIDES = ("--config.base_net_kwargs.model_type=vit",
                       "--config.base_net_kwargs.action_head_type=continuous")
SMALLSTEM_HOST_STEPS, SMALLSTEM_TRAIN_STEPS, SMALLSTEM_SERVED = 5, 4, 5
#: the bounds of the SmallStem phase's checks against the CPU
SMALLSTEM_ACTION_TOL = 1e-4
SMALLSTEM_LOSS_RTOL, SMALLSTEM_GRAD_NORM_RTOL = 1e-4, 1e-3


def _to(tree, device):
    """A nested dict (or TrainState field) of tensors moved to device;
    other leaves as they are."""
    import torch

    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return tree


def _pixels(frame, device):
    """A frame's resize and centre crop to 224 on device, as the serving
    steps of the SmallStem phase compute it, back on the host."""
    import torch

    from hypervla_tpu_torch.ops import preprocess

    image = preprocess.resize_image(torch.as_tensor(frame, device=device),
                                    (224, 224))
    return preprocess.center_crop(image, (224, 224)).cpu().numpy()


def _serve(wrapper, instruction, frames, card_sync=True):
    """Resets wrapper and steps it over frames; returns (raw actions,
    actions, host ms of each step)."""
    import numpy as np
    import torch

    wrapper.reset("pick up the cube", instruction)
    raws, actions, ms = [], [], []
    for frame in frames:
        t0 = time.perf_counter()
        raw, action, *_ = wrapper.step(frame)
        if card_sync:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        raws.append(raw)
        actions.append(action)
    return np.stack(raws), np.stack(actions), ms


def smallstem_phase(device, card):
    """The SmallStem HyperVLA at vit_t width through the serving and the
    training entry points (module docstring, phase 7)."""
    import tempfile

    import numpy as np
    import torch

    from hypervla_tpu_torch.eval.inference import InferenceWrapper
    from hypervla_tpu_torch.eval.model_loading import (
        build_text_encoder,
        load_hypervla_policy,
    )
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from hypervla_tpu_torch.train.train_state import TrainState

    config = cli.load_config(SMALLSTEM_CONFIG)
    cli.apply_overrides(config, list(SMALLSTEM_OVERRIDES))
    vk = config["base_net_kwargs"]["vit_kwargs"]
    rng = np.random.default_rng(SEED + 13)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False]),
    }}
    length = config["dataset_kwargs"]["tokenizer_max_length"]
    ids = np.arange(length, dtype=np.int32)[None]
    batch = {
        "observation": {"image_primary": np.zeros((1, 1, 224, 224, 3),
                                                  np.uint8)},
        "task": {"language_instruction": {
            "input_ids": ids, "attention_mask": np.ones_like(ids),
            "token_embedding": rng.standard_normal(
                (1, length, 768)).astype(np.float32)}},
    }
    t0 = time.perf_counter()
    model = HyperVLA.from_config(config, batch, seed=SEED, device=device,
                                 dataset_statistics=stats)
    # random fan-out kernels make the generated weights depend on the task
    gen = torch.Generator().manual_seed(SEED + 14)
    kernel = model.params["output_head/kernel"]
    kernel += (torch.randn(kernel.shape, generator=gen) * 0.02).to(device)
    torch.cuda.synchronize()
    plan = model.plan
    log(f"smallstem build: {vk['encoder_type']} {tuple(vk['cnn_channels'])}"
        f", hidden {vk['hidden_dim']} x {vk['num_layers']} layers, "
        f"{config['hypernet_kwargs']['generation_strategy']} generation of "
        f"{plan.total_param_num} base-net params a task "
        f"({len(plan.names)} blocks), hypernet "
        f"{sum(v.numel() for v in model.params.values())} params, "
        f"{config['base_net_kwargs']['action_head_type']} head; built in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- serving: the fused step and the host path, against the CPU ----
    frames = rng.integers(0, 256, (STEPS, 256, 256, 3), dtype=np.uint8)
    instruction = {"language_instruction":
                   batch["task"]["language_instruction"]}
    kwargs = dict(policy_setup="google_robot", image_size=224,
                  action_ensemble=True, pred_action_horizon=4)
    cpu_model = model.replace(params=_to(model.params, "cpu"),
                              device=torch.device("cpu"))
    # the card's pixels against the CPU's; the CPU's steps then start from
    # the card's (224 in: the resize returns them as they are, no crop)
    pixels = np.stack([_pixels(f, device) for f in frames])
    cpu_pixels = np.stack([_pixels(f, "cpu") for f in frames])
    flips = pixels != cpu_pixels
    levels = int(np.abs(pixels.astype(np.int16)
                        - cpu_pixels.astype(np.int16)).max())
    if levels > 1 or flips.mean() > 1e-3:
        raise AssertionError(f"smallstem resize: {flips.sum()} pixels off "
                             f"the CPU's, by up to {levels} levels")
    worst = 0.0
    timed = {}
    for fused, n in ((True, STEPS), (False, SMALLSTEM_HOST_STEPS)):
        card_w = InferenceWrapper(model, fused_serving=fused, crop=True,
                                  **kwargs)
        cpu_w = InferenceWrapper(cpu_model, fused_serving=fused, crop=False,
                                 **kwargs)
        raw, act, ms = _serve(card_w, instruction, frames[:n])
        ref_raw, ref_act, _ = _serve(cpu_w, instruction, pixels[:n],
                                     card_sync=False)
        err = max(float(np.abs(raw - ref_raw).max()),
                  float(np.abs(act - ref_act).max()))
        if not np.isfinite(raw).all() or err > SMALLSTEM_ACTION_TOL:
            raise AssertionError(f"smallstem {'fused' if fused else 'host'}"
                                 f" actions: max abs error {err} against "
                                 f"the CPU (bound {SMALLSTEM_ACTION_TOL})")
        worst = max(worst, err)
        timed[fused] = (card_w, statistics.median(ms[1:]))
    fused_w, fused_ms = timed[True]
    step_fn, history = fused_w._serving_step, fused_w._serving_history
    busy, kernels = device_busy(lambda: step_fn(
        fused_w.base_params, frames[0], history, STEPS))
    log(f"smallstem serving: {STEPS} fused steps and "
        f"{SMALLSTEM_HOST_STEPS} host-path steps; the card's resized pixels "
        f"off the CPU's on {int(flips.sum())} of {flips.size} by up to "
        f"{levels} level; from the card's pixels, actions within "
        f"{worst:.3g} of the CPU's in fp32 (bound {SMALLSTEM_ACTION_TOL}, "
        f"TF32 off); fused ms/step {fused_ms:.4f} (median, host clock), "
        f"actions/s {1e3 / fused_ms:.1f}; host path ms/step "
        f"{timed[False][1]:.4f}; fused step device busy {busy:.4f} ms in "
        f"{kernels:.0f} kernels, idle share {1 - busy / fused_ms:.3f}; "
        f"card {card}")
    del timed, fused_w, step_fn, cpu_model, model
    torch.cuda.empty_cache()

    # ---- training: the command line on the fixture mix ----
    root = tempfile.mkdtemp(prefix="hypervla_smallstem_")
    try:
        data = os.path.join(root, "data")
        mix, _, _ = write_trainer_fixture(data)
        save_dir = os.path.join(root, "run")
        argv = ["--config", SMALLSTEM_CONFIG, "--save_dir", save_dir,
                *SMALLSTEM_OVERRIDES,
                f"--config.dataset_kwargs.oxe_mix={mix!r}",
                f"--config.dataset_kwargs.data_dir={data!r}",
                f"--config.dataset_kwargs.batch_size={TRAINER_BATCH}",
                "--config.dataset_kwargs.shuffle_buffer_size="
                f"{TRAINER_SHUFFLE}",
                f"--config.num_steps={SMALLSTEM_TRAIN_STEPS}",
                "--config.log_interval=1", "--config.save_param_EMA=True",
                *(["--cpu"] if device.type == "cpu" else [])]
        recorder = LogRecorder()
        real_wandb = cli._wandb_run
        cli._wandb_run = lambda args, config: recorder
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with TrainerSteps(trainer, dict, {}) as steps:
                state = cli.main(argv)
        finally:
            cli._wandb_run = real_wandb
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        losses = [recorder.logs[s]["training_loss"]
                  for s in range(1, SMALLSTEM_TRAIN_STEPS + 1)]
        if (state.step != SMALLSTEM_TRAIN_STEPS
                or steps.calls != SMALLSTEM_TRAIN_STEPS
                or not all(map(math.isfinite, losses))):
            raise AssertionError(f"smallstem trainer: step {state.step}, "
                                 f"{steps.calls} steps, losses {losses}")

        # the first step again, on the CPU, from the same state and batch
        first = steps.first
        args, kwargs = steps.args
        card_model = args[0]
        cpu_params = {k: v.detach().cpu().requires_grad_(True)
                      for k, v in first["state"].params.items()}
        cpu_state = TrainState(
            step=first["state"].step, params=cpu_params,
            opt_state=_to(first["state"].opt_state, "cpu"),
            ema_params=_to(first["state"].ema_params, "cpu"),
            seed=first["state"].seed)
        cpu_step = steps.real(card_model.replace(
            params=cpu_params, device=torch.device("cpu")), *args[1:],
            **kwargs)
        _, cpu_info = cpu_step(cpu_state, _to(first["batch"], "cpu"),
                               _to(first["task_index"], "cpu"),
                               _to(first["encoder_params"], "cpu"),
                               with_metrics=True)
        for key, bound in (("training_loss", SMALLSTEM_LOSS_RTOL),
                           ("grad_norm", SMALLSTEM_GRAD_NORM_RTOL)):
            a, b = float(first["info"][key]), float(cpu_info[key])
            log(f"smallstem trainer first step {key}: card {a!r}, CPU "
                f"{b!r}, relative difference {abs(a - b) / abs(b):.3g} "
                f"(bound {bound})")
            if not abs(a - b) <= bound * abs(b):
                raise AssertionError(f"smallstem first step {key}: card {a}"
                                     f", CPU {b}")
        del cpu_step, cpu_state, cpu_params, cpu_info

        step_fn = steps.rebuild()

        def one_step():
            step_fn(first["state"], first["batch"], first["task_index"],
                    first["encoder_params"], with_metrics=False)

        per_kernel = _device_trace(one_step, 1)
        busy = sum(us * n for us, n in per_kernel.values()) / 1e3
        kernels = sum(n for _, n in per_kernel.values())
        top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0] * kv[1][1])
        log("smallstem trainer step's largest device kernels (ms a step, "
            "launches): " + "; ".join(
                f"{k.removeprefix('void ').split('(')[0][:60]} "
                f"{us * n / 1e3:.3f} x{n}" for k, (us, n) in top[:8]))
        totals = [recorder.logs[s]["timer/total"]
                  for s in range(2, SMALLSTEM_TRAIN_STEPS + 1)]
        med_ms = statistics.median(totals) * 1e3
        log(f"smallstem trainer: {SMALLSTEM_TRAIN_STEPS} steps at batch "
            f"{TRAINER_BATCH} in {run_s:.2f} s, losses "
            f"{[round(x, 4) for x in losses]}; ms/step {med_ms:.4f} (median "
            f"of the timer's total over steps 2-{SMALLSTEM_TRAIN_STEPS}), "
            f"samples/s {TRAINER_BATCH * 1e3 / med_ms:.1f}; one step traced: "
            f"device busy {busy:.3f} ms in {kernels:.0f} kernels, idle share "
            f"{1 - busy / med_ms:.3f}; peak {peak:.2f} GiB; card {card}")
        del step_fn, first, steps, state

        # ---- the saved checkpoint, served ----
        policy = load_hypervla_policy(save_dir, device=device,
                                      fused_serving=True)
        encode = build_text_encoder(policy.model)
        policy.reset("pick up the cube", encode("pick up the cube"))
        for i, frame in enumerate(frames[:SMALLSTEM_SERVED]):
            _, action, *_ = policy.step(frame)
            if action.shape != (7,) or not np.isfinite(action).all():
                raise AssertionError(f"smallstem served step {i}: {action}")
        log(f"smallstem checkpoint served: {SMALLSTEM_SERVED} fused steps of "
            f"the step-{SMALLSTEM_TRAIN_STEPS} EMA params through "
            "load_hypervla_policy(fused_serving=True), a finite (7,) action "
            "each")
        del policy
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()


#: the heads phase: head -> (fused serving steps, fast-preset train
#: steps at TRAIN_BATCH), on the flagship with that action head; the mix
#: head's train steps are the others' yardstick in the same run (its
#: serving is the slice phase's)
HEADS = {"mix": (0, 2), "diffusion": (20, 3), "discrete": (20, 2)}
#: the fast preset's launches of kernels 2 and 3 a train step
FAST_PRESET_LAUNCHES = {"mha_fused_train_fwd": 12, "mha_fused_train_bwd": 12,
                        "dino_layer_train_fwd": 12}


def serving_checks(head, model, wrapper, serve, steps, frames, card):
    """The heads phase's serving checks of one head (see heads_phase);
    returns kernel 1's launches over the counted steps."""
    import numpy as np
    import torch

    from hypervla_tpu_torch.ops import dino_layer as dl

    policy = wrapper("kernel", SEED)
    dl.reset_launch_counts()
    actions = serve(policy)
    torch.cuda.synchronize()
    launches = dict(dl.LAUNCHES)
    log(f"heads {head} serving launches over {steps} steps: {launches}")
    if launches["dino_layers_serving"] != steps:
        raise AssertionError(f"{head}: not every serving step went through "
                             "the trunk kernel")
    if actions.shape != (steps, 7) or not np.isfinite(actions).all():
        raise AssertionError(f"{head}: bad actions {actions.shape}")
    plain = serve(wrapper("reference", SEED))
    scale = max(float(np.abs(plain).max()), 1.0)
    err = float(np.abs(actions - plain).max())
    agree = float((actions == plain).mean())
    log(f"heads {head} actions kernel vs plain trunk: max_abs_err {err:.6g} "
        f"(bound {TRUNK_BOUND * scale:.6g}), equal entries {agree:.4f}; "
        f"first action {actions[0].tolist()}")
    if head == "discrete":
        # the logits before the argmax, and the argmax where it is clear
        image = torch.as_tensor(frames[1][:224, :224],
                                device=model.device)[None]
        logits = {impl: model.base_net.action_head(
            policy.base_params, model.base_net.encode(
                policy.base_params, image, impl)).flatten(0, -2)
            for impl in ("kernel", "reference")}
        lerr, lscale = max_err(logits["kernel"], logits["reference"])
        top2 = logits["reference"].topk(2, -1).values
        clear = (top2[:, 0] - top2[:, 1]) > 2 * lerr
        same = (logits["kernel"].argmax(-1) == logits["reference"].argmax(
            -1))[clear]
        log(f"heads discrete logits kernel vs plain: max_abs_err "
            f"{lerr:.6g} (bound {TRUNK_BOUND * max(lscale, 1.0):.6g}); "
            f"tokens with a clear argmax {int(clear.sum())} of "
            f"{clear.numel()}, equal {int(same.sum())}")
        if not lerr < TRUNK_BOUND * max(lscale, 1.0) or not bool(
                same.all()):
            raise AssertionError("discrete: logits or clear tokens disagree "
                                 "with the plain trunk")
    elif not err < TRUNK_BOUND * scale:
        raise AssertionError(f"{head}: actions disagree with the plain "
                             "trunk")
    again = serve(wrapper("kernel", SEED))
    other = serve(wrapper("kernel", SEED + 1))
    same, differ = np.array_equal(actions, again), not np.array_equal(
        actions, other)
    log(f"heads {head} init_rng: the same seed bit-equal {same}, another "
        f"seed different {differ} (max abs diff "
        f"{float(np.abs(actions - other).max()):.6g})")
    if not same or differ != (head == "diffusion"):
        raise AssertionError(f"{head}: init_rng does not seed the actions "
                             "as it should")
    times = []
    for f in frames[1:21]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        policy.step(f)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    busy, kernels = device_busy(lambda: policy.step(frames[1]))
    med = statistics.median(times)
    log(f"heads {head} serving ms/step (median of 20, CUDA events) "
        f"{med:.4f}; step profiled: device busy ms {busy:.3f}, "
        f"{kernels:.0f} device kernels, idle share {1 - busy / med:.3f}; "
        f"{card}")
    return launches


def heads_phase(device, card):
    """The flagship with the diffusion head and with the discrete head
    (action_head_type overridden in the vit_t,oxe recipe), full width and
    depth, random weights from a seed and random fan-out kernels. For
    each: `reset` and fused InferenceWrapper steps on kernel 1's stacked
    trunk (every step one trunk launch) against the same steps through
    kernel 1's plain version, a second wrapper with that init_rng
    bit-equal and one with another init_rng different (diffusion) or
    equal (discrete: argmax decode), ms/step, device busy and kernels a
    step. The diffusion actions are held within 0.05 * max(scale, 1) of
    the plain trunk's (the same init_rng, so the sampler draws the same
    numbers); the discrete head's argmax is a threshold, as the mix head's
    gripper is (slice phase), so its logits are held to that bound and its
    tokens must agree wherever the plain logits' top two lie further apart
    than twice the logits' error. Then fast-preset train steps at batch 64
    from one state, for these two heads and the mix head beside them: a
    finite loss, 12 + 12 launches of kernel 2 and 12 of kernel 3 every
    step, the step repeated from one state and (seed, step) bit-equal,
    ms/step, device busy, kernels and the peak memory of a step. Returns
    {head: {"serve": launches, "train": launches of a step}}."""
    import copy

    import numpy as np
    import torch

    from hypervla_tpu_torch.configs import (
        apply_fast_training_preset,
        flagship_pretrain_config,
    )
    from hypervla_tpu_torch.eval.inference import (
        InferenceWrapper,
        initial_state,
    )
    from hypervla_tpu_torch.flagship import make_flagship_batch
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.hypernetwork import HyperNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import (
        make_train_step,
        to_tensors,
    )
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 16)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False]),
    }}
    most = max(steps for steps, _ in HEADS.values())
    frames = rng.integers(0, 256, (most + 1, 256, 256, 3), dtype=np.uint8)
    example = make_flagship_batch(seed=SEED)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    batch = to_tensors(batch, device)
    encoders = None
    out, traced = {}, {}
    for head, (serve_steps, train_steps) in HEADS.items():
        t0 = time.perf_counter()
        config = flagship_pretrain_config()
        config["base_net_kwargs"]["action_head_type"] = head
        config["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] = "bfloat16"
        model = HyperVLA.from_config(config, example, seed=SEED,
                                     device=device, dataset_statistics=stats)
        # random fan-out kernels make the generated weights depend on the
        # task (at init they are 0)
        gen = torch.Generator(device=device).manual_seed(SEED + 17)
        for name, value in model.params.items():
            if name.startswith("output_head_") and name.endswith("/kernel"):
                value += 0.02 * torch.randn(value.shape, generator=gen,
                                            device=device)
        torch.cuda.synchronize()
        fan_out = sum(v.numel() for k, v in model.params.items()
                      if k.startswith("output_head_action_head"))
        total = sum(v.numel() for v in model.params.values())
        log(f"heads {head}: flagship built in "
            f"{time.perf_counter() - t0:.3f} s, {total} params, the action "
            f"head's fan-out heads {fan_out}; {card}")

        out[head] = {}
        # ---- serving: kernel 1 against its plain version ----
        init = initial_state(model, frames[0])

        def wrapper(trunk_impl, init_rng):
            w = InferenceWrapper(
                model, policy_setup="google_robot", image_size=224,
                action_ensemble=True, crop=True, fused_serving=True,
                trunk_impl=trunk_impl, init_rng=init_rng,
                pred_action_horizon=config["base_net_kwargs"][
                    "action_horizon"])
            w.reset("pick up the cube", instruction, init)
            return w

        def serve(w):
            return np.stack([w.step(f)[0] for f in frames[1:serve_steps + 1]])

        if serve_steps:
            out[head]["serve"] = serving_checks(
                head, model, wrapper, serve, serve_steps, frames, card)

        # ---- training: the fast preset at batch 64 ----
        fast = apply_fast_training_preset(copy.deepcopy(config))
        trained = HyperVLA(HyperNetwork(model.plan, fast["hypernet_kwargs"]),
                           BaseNetwork(**fast["base_net_kwargs"]), fast,
                           model.params, model.plan, stats, device,
                           model.example_batch)
        if encoders is None:
            text_apply, dino_apply, t5, dino_params = build_frozen_encoders(
                fast, device=device, seed=SEED + 1)
            encoders = {"t5": t5, "dino": dino_params}
        tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
            model.params, hn_param_type_tree(model.params),
            **fast["optimizer"])
        step_fn = make_train_step(trained, fast, tx, lr_fn, base_lr_fn,
                                  pnorm_fn, text_encode=text_apply,
                                  dino_encode=dino_apply)
        state0 = TrainState.create(model.params, tx, seed=SEED)
        warmup = fast["optimizer"]["learning_rate"]["warmup_steps"]
        state0.step = warmup
        state0.opt_state["count"] = warmup
        del model

        def run(state):
            return step_fn(state, batch, encoder_params=encoders,
                           with_metrics=False)

        def counts():
            return {k: v for k, v in {**fa.LAUNCHES, **dlt.LAUNCHES}.items()
                    if v}

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        first, info = run(state0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        again, _ = run(state0)
        same = all(torch.equal(first.params[k], again.params[k])
                   for k in first.params)
        del again
        log(f"heads {head} train step repeated from one state and (seed, "
            f"step): new params bit-equal {same}; {card}")
        if not same:
            raise AssertionError(f"{head}: the train step does not repeat "
                                 "bit for bit")
        state, times, losses, per_step = first, [], [
            float(info["training_loss"])], []
        for _ in range(train_steps):
            for module in (fa, dlt):
                module.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, info = run(state)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            per_step.append(counts())
            losses.append(float(info["training_loss"]))
        del state, first
        log(f"heads {head} train losses {losses}, launches a step "
            f"{per_step}; {card}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{head}: a train loss is not finite")
        for launched in per_step:
            for kernel, want in FAST_PRESET_LAUNCHES.items():
                if launched.get(kernel) != want:
                    raise AssertionError(
                        f"{head}: a train step launched {kernel} "
                        f"{launched.get(kernel)} times, want {want}")
        traced[head] = _device_trace(lambda: run(state0), 1, host=False)
        busy = sum(mean_us * n for mean_us, n in traced[head].values()) / 1e3
        kernels = sum(n for _, n in traced[head].values())
        # the optimizer's update alone, on the gradients that step left
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in state0.params.items()}
        with torch.no_grad():
            opt_busy, opt_kernels = device_busy(lambda: tx.update(
                grads, state0.opt_state, state0.params), host=False)
        del grads
        log(f"heads {head} optimizer update alone ({len(state0.params)} "
            f"leaves, {sum(p.numel() for p in state0.params.values())} "
            f"params): device busy ms {opt_busy:.3f}, {opt_kernels:.0f} "
            f"device kernels; {card}")
        med = statistics.median(times)
        log(f"heads {head} train ms/step (median of {train_steps}, CUDA "
            f"events, batch {TRAIN_BATCH}) {med:.4f}; step profiled: device "
            f"busy ms {busy:.3f}, {kernels:.0f} device kernels, idle share "
            f"{1 - busy / med:.3f}; peak memory (max_memory_allocated over "
            f"a step from the state) {peak / 2 ** 30:.3f} GiB; {card}")
        out[head]["train"] = per_step[-1]
        del state0, step_fn, trained, tx
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # where a head's step spends its device time beyond the mix head's
    def by_name(per):
        ms = {}
        for key, (mean_us, n) in per.items():
            name = key.removeprefix("void ").split("(")[0].split("<")[0]
            ms[name] = ms.get(name, 0.0) + mean_us * n / 1e3
        return ms

    base = by_name(traced["mix"])
    for head in traced:
        if head == "mix":
            continue
        ms = by_name(traced[head])
        extra = sorted(((ms.get(k, 0.0) - base.get(k, 0.0), k)
                        for k in set(ms) | set(base)), reverse=True)[:6]
        log(f"heads {head} train step's device ms over the mix head's, the "
            "six largest by kernel: " + ", ".join(
                f"{k} {d:+.3f}" for d, k in extra) + f"; {card}")
    log(f"heads phase s {time.perf_counter() - t_phase:.3f}")
    return out


#: the eval phase's pixel-environment episodes and their step cap
EVAL_EPISODES, EVAL_MAX_STEPS = 3, 40
#: SIMPLER's stand-in: one task of 2 episodes of at most 10 steps (the
#: first succeeds at its second step); LIBERO's: 2 episodes of 5 steps
SIMPLER_EPISODES, SIMPLER_MAX_STEPS = 2, 10
LIBERO_EPISODES, LIBERO_STEPS = 2, 5
#: the trainer run with the visualization callback
VIZ_STEPS, VIZ_INTERVAL = 4, 2
#: the SIMPLER initial state's separate DINOv2: fp32 on the card (TF32 off,
#: main) against the same fp32 network on the CPU, so a few fp32 roundings
#: apart, not TRUNK_BOUND's 12 stacked bf16 layers
INITIAL_STATE_BOUND = 1e-4
#: the hash seed this script runs under (main)
HASH_SEED = "0"


def _eval_flagship(device, conditioned, stats):
    """The full-width flagship (vit_t,oxe, bf16 trunk) from SEED, with or
    without the initial-image conditioning, its fan-out kernels perturbed
    so that the task matters."""
    import torch

    from hypervla_tpu_torch.configs import flagship_pretrain_config
    from hypervla_tpu_torch.flagship import make_flagship_batch
    from hypervla_tpu_torch.models.hypervla import HyperVLA

    config = flagship_pretrain_config()
    config["hypernet_kwargs"]["use_initial_image"] = conditioned
    config["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] = "bfloat16"
    model = HyperVLA.from_config(config, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device,
                                 dataset_statistics=stats)
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    for name, value in model.params.items():
        if name.startswith("output_head_") and name.endswith("/kernel"):
            value += 0.02 * torch.randn(value.shape, generator=gen,
                                        device=device)
    return model


class _Counting:
    """A policy whose steps are counted: kernel 1's launches each step
    (which must be one), and every action."""

    def __init__(self, policy):
        self.policy = policy
        self.model = policy.model
        self.actions = []

    def reset(self, *args, **kwargs):
        return self.policy.reset(*args, **kwargs)

    def step(self, image):
        from hypervla_tpu_torch.ops import dino_layer as dl

        before = dl.LAUNCHES["dino_layers_serving"]
        out = self.policy.step(image)
        launched = dl.LAUNCHES["dino_layers_serving"] - before
        if launched != 1:
            raise AssertionError(f"an eval tick launched kernel 1 "
                                 f"{launched} times")
        self.actions.append(out[1])
        return out


def eval_phase(device, card):
    """The evaluators on the full-width flagship (module docstring, phase
    9); kernel 1's launches over each part's ticks and viz calls, counted
    from zero before the part and read after it."""
    import json
    import tempfile

    import numpy as np
    import torch

    from hypervla_tpu_torch.eval import libero, simpler
    from hypervla_tpu_torch.eval.inference import InferenceWrapper
    from hypervla_tpu_torch.eval.model_loading import (
        build_text_encoder,
        load_hypervla_policy,
    )
    from hypervla_tpu_torch.eval.pixel_env import PixelReachEnv
    from hypervla_tpu_torch.eval.policy_server import PolicyClient
    from hypervla_tpu_torch.eval.visualization import (
        run_policy_on_trajectory,
    )
    from hypervla_tpu_torch.models.base_vit import normalize_pixels
    from hypervla_tpu_torch.models.encoders.dinov2 import dinov2_forward
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import preprocess
    from hypervla_tpu_torch.train import callbacks
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from tools import eval_pixel_env

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_sim_stubs as stubs

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 20)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False]),
    }}
    launches = {}
    root = tempfile.mkdtemp(prefix="hypervla_eval_")
    proc = None
    try:
        # ---- a. the pixel environment through the served checkpoint ----
        t0 = time.perf_counter()
        model = _eval_flagship(device, False, stats)
        ckpt = os.path.join(root, "ckpt")
        model.save_pretrained(0, ckpt)
        del model
        torch.cuda.empty_cache()
        log(f"eval flagship (use_initial_image=False) built and saved in "
            f"{time.perf_counter() - t0:.3f} s; {card}")
        # the server starts here and is driven after parts a-c, which run
        # in this process while it loads
        port = eval_pixel_env.free_port()
        t_server = time.perf_counter()
        proc = eval_pixel_env.start_server(eval_pixel_env.server_command(
            ckpt, port, image_size=224))

        policy = load_hypervla_policy(ckpt, policy_setup="libero",
                                      image_size=224, action_ensemble=True,
                                      crop=False, device=device)
        encode = build_text_encoder(policy.model)
        counted = _Counting(policy)

        class InProcess:
            def reset(self, task):
                counted.reset(task, encode(task))

            def step(self, frame):
                return {"action": counted.step(frame)[1]}

        dl.reset_launch_counts()
        local = eval_pixel_env.run_episodes(
            InProcess(), PixelReachEnv(seed=0, max_steps=EVAL_MAX_STEPS),
            EVAL_EPISODES, log=lambda m: log(f"eval in-process {m}"))
        torch.cuda.synchronize()
        ticks = sum(local["steps"])
        launches["pixel_env"] = dl.LAUNCHES["dino_layers_serving"]
        got = np.stack(counted.actions)
        libero_model = policy.model
        del policy, counted

        # ---- b. the SIMPLER and LIBERO evaluators on stand-ins ----
        t0 = time.perf_counter()
        conditioned = _eval_flagship(device, True, stats)
        frames = np.random.default_rng(SEED + 22)

        def simpler_frame(env, obs):
            return frames.integers(0, 256, (512, 640, 3), dtype=np.uint8)

        horizon = conditioned.config["base_net_kwargs"]["action_horizon"]
        spolicy = _Counting(InferenceWrapper(
            conditioned, policy_setup="google_robot", image_size=224,
            pred_action_horizon=horizon, action_ensemble=True))
        sencode = build_text_encoder(conditioned)
        task = "google_robot_close_top_drawer"
        with stubs.installed(stubs.install_mock_simpler,
                             lambda ep: ep == 0, frame_fn=simpler_frame,
                             max_episode_steps=SIMPLER_MAX_STEPS):
            dl.reset_launch_counts()
            results = simpler.evaluate(
                spolicy, sencode, tasks={task: (None, SIMPLER_EPISODES,
                                                None)},
                eval_path=os.path.join(root, "simpler"))
            torch.cuda.synchronize()
        launches["simpler"] = dl.LAUNCHES["dino_layers_serving"]
        with open(os.path.join(root, "simpler", "success_rate.json")) as f:
            written = json.load(f)
        sticks = len(spolicy.actions)
        log(f"eval SIMPLER stand-in ({SIMPLER_EPISODES} episodes, at most "
            f"{SIMPLER_MAX_STEPS} steps): {results}, {sticks} ticks, "
            f"{launches['simpler']} kernel 1 launches, in "
            f"{time.perf_counter() - t0:.3f} s with the build; {card}")
        if (results != written or results != {task: 0.5}
                or sticks != 2 + SIMPLER_MAX_STEPS
                or launches["simpler"] != sticks
                or not np.isfinite(np.stack(spolicy.actions)).all()):
            raise AssertionError("the SIMPLER stand-in run is wrong")
        # the initial state's encoder against the same DINOv2 on the CPU
        frame = simpler_frame(None, None)
        state = simpler._initial_state(spolicy, frame)
        name = conditioned.config["base_net_kwargs"]["vit_kwargs"].get(
            "pretrained_encoder_name", "dinov2-base")
        config, params = simpler.initial_image_encoder(name, device)
        # the same DINOv2 weights in fp32 on the CPU, on the card's pixels
        resized = torch.as_tensor(state["image_primary"][:, 0])
        with torch.no_grad():
            ref = dinov2_forward(config, {k: v.cpu() for k, v in
                                          params.items()},
                                 normalize_pixels(resized))
        ierr, iscale = max_err(torch.as_tensor(state["patch_embeddings"]),
                               ref)
        cpu_pixels = preprocess.resize_image(torch.as_tensor(frame),
                                             (224, 224)).numpy()
        pix = int(np.abs(resized[0].numpy().astype(int)
                         - cpu_pixels.astype(int)).max())
        ibound = INITIAL_STATE_BOUND * max(iscale, 1.0)
        log(f"eval SIMPLER initial state: patch embeddings {tuple(ref.shape)}"
            f" on the card against the fp32 DINOv2 on the CPU max_abs_err "
            f"{ierr:.6g} (bound {ibound:.6g}); the "
            f"card's resized pixels within {pix} level of the CPU's")
        if not (ierr < ibound and pix <= 1):
            raise AssertionError("the initial state's encoder disagrees "
                                 "with the CPU")
        del spolicy, conditioned, params, state
        torch.cuda.empty_cache()

        lpolicy = _Counting(InferenceWrapper(
            libero_model, policy_setup="libero", image_size=224,
            pred_action_horizon=horizon, action_ensemble=True))
        lframe = frames.integers(0, 256, (256, 256, 3), dtype=np.uint8)
        suite = {"libero_object": stubs.mock_suite(["pick_up_the_cube"])}
        with stubs.installed(stubs.install_mock_libero, suite,
                             done_after=LIBERO_STEPS, frame=lframe):
            dl.reset_launch_counts()
            results = libero.evaluate(
                lpolicy, encode, eval_path=os.path.join(root, "libero"),
                num_episodes=LIBERO_EPISODES)
            torch.cuda.synchronize()
        launches["libero"] = dl.LAUNCHES["dino_layers_serving"]
        with open(os.path.join(root, "libero", "libero_object.json")) as f:
            written = json.load(f)
        lticks = len(lpolicy.actions)
        log(f"eval LIBERO stand-in ({LIBERO_EPISODES} episodes): {results}, "
            f"{lticks} ticks, {launches['libero']} kernel 1 launches")
        if (results != written or results != {"pick_up_the_cube": 1.0}
                or lticks != LIBERO_EPISODES * LIBERO_STEPS
                or launches["libero"] != lticks
                or not np.isfinite(np.stack(lpolicy.actions)).all()):
            raise AssertionError("the LIBERO stand-in run is wrong")
        del lpolicy, libero_model, encode, sencode
        torch.cuda.empty_cache()

        # ---- c. the visualization callback during training ----
        t0 = time.perf_counter()
        data = os.path.join(root, "data")
        _, names, _ = write_trainer_fixture(data)
        config = cli.load_config(TRAINER_CONFIG)
        config["hypernet_kwargs"]["use_initial_image"] = False
        dk = config["dataset_kwargs"]
        dk.update(oxe_mix=None, batch_size=TRAINER_BATCH,
                  shuffle_buffer_size=TRAINER_SHUFFLE,
                  resize_size={"primary": (224, 224)},
                  dataset_kwargs_list=[dict(
                      name=name, data_dir=data,
                      image_obs_keys={"primary": "image"},
                      language_key="language_instruction",
                      action_proprio_normalization_type="normal")
                      for name in names])
        config.update(viz_datasets=[names[0]], viz_interval=VIZ_INTERVAL,
                      log_interval=1)
        per_call = []
        seen = {}
        real = trainer.VisualizationCallback

        class CountedViz(callbacks.VisualizationCallback):
            def __call__(self, params, step):
                seen.update(callback=self, params=params, step=step)
                torch.cuda.synchronize()
                before = dl.LAUNCHES["dino_layers_serving"]
                t1 = time.perf_counter()
                metrics = super().__call__(params, step)
                torch.cuda.synchronize()
                per_call.append((step, dl.LAUNCHES["dino_layers_serving"]
                                 - before, time.perf_counter() - t1))
                return metrics

        recorder = LogRecorder()
        trainer.VisualizationCallback = CountedViz
        try:
            dl.reset_launch_counts()
            state = trainer.train(config, num_steps=VIZ_STEPS,
                                  wandb_run=recorder, device=device)
            torch.cuda.synchronize()
        finally:
            trainer.VisualizationCallback = real
        launches["viz"] = dl.LAUNCHES["dino_layers_serving"]
        viz = {step: {k: v for k, v in recorder.logs.get(step, {}).items()
                      if k.startswith(f"visualizer/{names[0]}/")}
               for step in range(1, VIZ_STEPS + 1)}
        frames_per_call = config.get("viz_num_trajs", 4) * TRAINER_TRAJ_LEN
        log(f"eval trainer with viz_datasets: {state.step} steps in "
            f"{time.perf_counter() - t0:.3f} s, viz calls (step, kernel 1 "
            f"launches, s) {per_call}, {len(viz[VIZ_INTERVAL])} metrics a "
            f"call, e.g. mse {viz[VIZ_INTERVAL].get(f'visualizer/{names[0]}/mse')}"
            f"; {card}")
        wanted = [s for s in range(1, VIZ_STEPS + 1) if s % VIZ_INTERVAL == 0]
        if (state.step != VIZ_STEPS
                or [s for s in viz if viz[s]] != wanted
                or not all(math.isfinite(v) for s in wanted
                           for v in viz[s].values())
                or [c[1] for c in per_call] != [frames_per_call] * len(wanted)
                or launches["viz"] != frames_per_call * len(wanted)):
            raise AssertionError(f"the visualization callback's run is wrong:"
                                 f" {per_call}, {launches['viz']}")
        # the last viz call's policy on its first trajectory, through
        # kernel 1 and through its plain version
        cb = seen["callback"]
        viz_name, visualizer = next(iter(cb.visualizers.items()))
        traj = next(visualizer._iter_trajs(1))
        acts = {impl: run_policy_on_trajectory(
            cb._policy_fn(seen["params"], seen["step"], trunk_impl=impl),
            traj, text_processor=visualizer.text_processor)["pred_actions"]
            for impl in ("kernel", "reference")}
        verr, vscale = max_err(torch.as_tensor(acts["kernel"]),
                               torch.as_tensor(acts["reference"]))
        log(f"eval viz policy on {viz_name}'s first trajectory "
            f"{acts['kernel'].shape}: kernel 1 against its plain version "
            f"max_abs_err {verr:.6g} (bound "
            f"{TRUNK_BOUND * max(vscale, 1.0):.6g})")
        if not (np.isfinite(acts["kernel"]).all()
                and verr < TRUNK_BOUND * max(vscale, 1.0)):
            raise AssertionError("the viz policy through kernel 1 disagrees "
                                 "with its plain version")
        del seen, cb, visualizer

        # ---- a, served: the same episodes through the server ----
        client = eval_pixel_env.wait_for_server(
            PolicyClient, "127.0.0.1", port, proc, timeout_s=300)
        up_s = time.perf_counter() - t_server
        replies = []

        class Recorded:
            """The client, its replies kept."""

            def reset(self, task):
                client.reset(task)

            def step(self, frame):
                replies.append(client.step(frame))
                return replies[-1]

        served = eval_pixel_env.run_episodes(
            Recorded(), PixelReachEnv(seed=0, max_steps=EVAL_MAX_STEPS),
            EVAL_EPISODES, log=lambda m: log(f"eval served {m}"))
        client.close()
        proc.terminate()
        proc.wait(timeout=60)
        proc = None
        summary = eval_pixel_env.summary(served)
        log(f"eval pixel_env served (server answering {up_s:.3f} s after its "
            f"start, parts a-c run meanwhile; {card}): "
            + json.dumps(dict(summary, per_episode_steps=served["steps"],
                              card=card)))
        want = np.stack([r["action"] for r in replies])
        # one checkpoint, one kernel, no atomics: the served actions are
        # the in-process ones, bit for bit
        err = float(np.abs(got - want).max()) \
            if got.shape == want.shape else float("inf")
        log(f"eval pixel_env in-process: steps {local['steps']} "
            f"(served {served['steps']}), successes {local['successes']} "
            f"(served {served['successes']}), {launches['pixel_env']} "
            f"kernel 1 launches over {ticks} ticks, actions against the "
            f"served ones max_abs_err {err:.6g} (must be 0); model_ms_p50 "
            f"{np.median(local['model_ms']):.4f} in-process against "
            f"{summary['model_ms_p50']} through the server; {card}")
        if (local["steps"] != served["steps"]
                or local["successes"] != served["successes"]
                or launches["pixel_env"] != ticks
                or not np.isfinite(got).all() or err != 0):
            raise AssertionError("the in-process episodes differ from the "
                                 "served ones")
    finally:
        import shutil

        if proc is not None:
            proc.terminate()
            proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"eval phase kernel 1 launches: {launches}; eval phase s "
        f"{time.perf_counter() - t_phase:.3f}; {card}")


#: the multi-device phase: train steps of the two ranks on the card and of
#: the one process they are held to; trainer steps under NCCL and profiled
MULTI_STEPS = 3
MULTI_TRAINER_STEPS = 4
PROFILE_STEPS = (2, 4)
#: the JAX package's bound between a sharded step and one device's
MESH_RTOL, MESH_ATOL = 2e-4, 1e-5
#: seconds the two ranks may take, start-up and build included
RANKS_DEADLINE = 300
#: the CUDA kernels of kernels 2 (csrc/fused_attention.cu) and 3 (the
#: frozen encoder's layer forward, over csrc/dino_layer.cu) a profile
#: summary must name
PROFILE_KERNEL_2 = ("mha_fwd_kernel", "mha_bwd_dq_kernel",
                    "mha_bwd_dkv_kernel")
PROFILE_KERNEL_3 = ("gemm_tma_kernel", "gemm_kernel",
                    "layer_norm_rows_kernel", "layer_norm_kernel")


def _multi_device_setup(device):
    """The full-width flagship under the fast preset from SEED, its frozen
    encoders from SEED + 1, the optimizer and a state at the LR's peak, and
    the fixed global batch: (model, config, tx, step args, encoder params,
    state, batch), the same in every process."""
    import copy

    from hypervla_tpu_torch.configs import (
        apply_fast_training_preset,
        disable_unused_attention_capture,
        flagship_pretrain_config,
    )
    from hypervla_tpu_torch.flagship import make_flagship_batch
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.trainer import build_frozen_encoders

    config = flagship_pretrain_config()
    config["base_net_kwargs"]["vit_kwargs"]["encoder_dtype"] = "bfloat16"
    disable_unused_attention_capture(config)
    fast = apply_fast_training_preset(copy.deepcopy(config))
    model = HyperVLA.from_config(fast, make_flagship_batch(seed=SEED),
                                 seed=SEED, device=device)
    text_apply, dino_apply, t5, dino = build_frozen_encoders(
        fast, device=device, seed=SEED + 1)
    tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
        model.params, hn_param_type_tree(model.params), **fast["optimizer"])
    state = TrainState.create(model.params, tx,
                              track_ema=fast.get("save_param_EMA", True))
    warmup = fast["optimizer"]["learning_rate"]["warmup_steps"]
    state.step = warmup
    state.opt_state["count"] = warmup
    batch = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    del batch["task"]["language_instruction"]["token_embedding"]
    del batch["initial_state"]["patch_embeddings"]
    step_args = (tx, lr_fn, base_lr_fn, pnorm_fn)
    return (model, fast, step_args, (text_apply, dino_apply),
            {"t5": t5, "dino": dino}, state, batch)


def _same_on_ranks(params):
    """Whether every rank holds these params bit for bit: rank 0's flat
    copy is broadcast and compared on every rank, the verdicts reduced."""
    import torch
    import torch.distributed as dist

    flat = torch.cat([p.detach().reshape(-1) for p in params.values()])
    theirs = flat.clone()
    dist.broadcast(theirs, src=0)
    same = torch.tensor([int(torch.equal(flat, theirs))], device=flat.device)
    dist.all_reduce(same, op=dist.ReduceOp.MIN)
    return bool(same.item())


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _two_rank_child(rank, world, device_type):
    """One of two ranks on card 0 over gloo: the fast-preset flagship,
    data-parallel (fsdp = tp = 1), this rank's 32 rows of the fixed batch
    of 64, MULTI_STEPS steps; returns each step's info, host ms and whether
    the ranks' params agree bit for bit (before the first step too), and
    kernels 2 and 3's launches over the steps."""
    import torch

    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.parallel.mesh import create_mesh, shard_batch
    from hypervla_tpu_torch.train.train_step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device_type, 0)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model, config, args, (text_apply, dino_apply), encoders, state, batch \
        = _multi_device_setup(device)
    mesh = create_mesh()
    step_fn = make_train_step(model, config, *args, text_encode=text_apply,
                              dino_encode=dino_apply, mesh=mesh)
    layout = step_fn.layout
    state = layout.shard_state(state, args[0])
    rows = shard_batch(batch, mesh)
    same = [_same_on_ranks(state.params)]
    infos, ms = [], []
    for module in (fa, dlt):
        module.reset_launch_counts()
    for _ in range(MULTI_STEPS):
        _sync(device)
        t0 = time.perf_counter()
        state, info = step_fn(state, rows, None, encoders, with_metrics=True)
        infos.append({k: float(v) for k, v in info.items()})
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
        same.append(_same_on_ranks(state.params))
    launches = {k: v for k, v in {**fa.LAUNCHES, **dlt.LAUNCHES}.items()
                if k in FAST_PRESET_LAUNCHES}
    return {"infos": infos, "ms": ms, "same": same, "launches": launches,
            "rows": len(rows["action"]), "mesh": mesh.shape}


def multi_device_phase(device, card, no_group_losses):
    """The port's multi-device training on the one card: two gloo ranks
    sharing it against one process; the trainer in an NCCL process group
    of one rank, its steps profiled, against no_group_losses, the
    per-step training_loss of the same command line without a group (the
    trainer phase's run A). The two ranks' step time is not a scaling
    number: both share one card."""
    import logging
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from hypervla_tpu_torch.parallel.dryrun import run_ranks
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from hypervla_tpu_torch.train.train_step import make_train_step

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    # ---- (1) two ranks on the card over gloo, against one process ----
    model, config, args, (text_apply, dino_apply), encoders, state, batch \
        = _multi_device_setup(device)
    step_fn = make_train_step(model, config, *args, text_encode=text_apply,
                              dino_encode=dino_apply)
    ref = []
    for _ in range(MULTI_STEPS):
        state, info = step_fn(state, batch, None, encoders,
                              with_metrics=True)
        ref.append({k: float(v) for k, v in info.items()})
    del model, step_fn, state, encoders
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(2, _two_rank_child, device.type,
                      timeout=RANKS_DEADLINE)
    ranks_s = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        if got["launches"] != {k: v * MULTI_STEPS
                               for k, v in FAST_PRESET_LAUNCHES.items()}:
            raise AssertionError(f"rank {r} launches {got['launches']}, "
                                 f"want {FAST_PRESET_LAUNCHES} a step")
        if not all(got["same"]):
            raise AssertionError(f"the ranks' params differ: {got['same']} "
                                 "(before the first step, after each)")
        if got["infos"] != ranks[0]["infos"]:
            raise AssertionError("the ranks report different infos")
    for step, (got, want) in enumerate(zip(ranks[0]["infos"], ref), 1):
        for key in ("training_loss", "grad_norm"):
            if not math.isclose(got[key], want[key], rel_tol=MESH_RTOL,
                                abs_tol=MESH_ATOL):
                raise AssertionError(
                    f"step {step} {key}: two ranks {got[key]!r}, one "
                    f"process {want[key]!r}")
        log(f"two ranks step {step}: training_loss {got['training_loss']!r}"
            f" (one process {want['training_loss']!r}), grad_norm "
            f"{got['grad_norm']!r} (one process {want['grad_norm']!r})")
    log(f"two gloo ranks on one card, mesh {ranks[0]['mesh']}, "
        f"{ranks[0]['rows']} rows a rank: {MULTI_STEPS} steps within rtol "
        f"{MESH_RTOL}, atol {MESH_ATOL} of one process at batch "
        f"{TRAIN_BATCH}, params bit-equal on both ranks before and after "
        f"every step, launches a rank {ranks[0]['launches']}; step ms "
        f"(host clock, both ranks sharing the card, not a scaling number) "
        f"rank 0 {[round(x, 2) for x in ranks[0]['ms']]}, rank 1 "
        f"{[round(x, 2) for x in ranks[1]['ms']]}; the ranks' run "
        f"{ranks_s:.2f} s with start-up and build; card {card}")

    # ---- (2) the trainer in an NCCL group of one rank, (3) profiled ----
    root = tempfile.mkdtemp(prefix="hypervla_multi_")
    try:
        data = os.path.join(root, "data")
        mix, _, _ = write_trainer_fixture(data)
        # the trainer phase's run A without its save_dir: the config main()
        # builds from the command line
        config = cli.load_config(TRAINER_CONFIG)
        cli.apply_overrides(config, [
            f"--config.dataset_kwargs.oxe_mix={mix!r}",
            f"--config.dataset_kwargs.data_dir={data!r}",
            f"--config.dataset_kwargs.batch_size={TRAINER_BATCH}",
            f"--config.dataset_kwargs.shuffle_buffer_size={TRAINER_SHUFFLE}",
            "--config.dataset_kwargs.resize_size={'primary': (224, 224)}",
            f"--config.num_steps={TRAINER_STEPS}", "--config.log_interval=1"])
        lines = []

        class Lines(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("profile"):
                    lines.append(msg)

        profile_dir = os.path.join(root, "profile")
        # the window is one trace: where the profiler lost its device
        # records (the summary then falls back to host operators), the run
        # is made once more
        for attempt in range(2):
            recorder = LogRecorder()
            lines.clear()
            handler = Lines()
            logging.getLogger().addHandler(handler)
            t0 = time.perf_counter()
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                store=dist.FileStore(os.path.join(root, f"store{attempt}"),
                                     1),
                rank=0, world_size=1)
            try:
                trainer.train(config, num_steps=MULTI_TRAINER_STEPS,
                              wandb_run=recorder, profile_dir=profile_dir,
                              profile_steps=PROFILE_STEPS, device=device)
                one = torch.ones(1, device=device)
                dist.all_reduce(one)
                if one.item() != 1.0:
                    raise AssertionError(f"an all-reduce of one rank gave "
                                         f"{one.item()}")
            finally:
                dist.destroy_process_group()
                logging.getLogger().removeHandler(handler)
            lost = (device.type == "cuda" and lines
                    and not any("device/step" in x for x in lines))
            if not lost:
                break
            log(f"profile window: the profiler lost the device records of "
                f"run {attempt + 1} ({len(lines)} host lines); running the "
                "trainer again")
        group_s = time.perf_counter() - t0
        losses = [recorder.logs[s]["training_loss"]
                  for s in range(1, MULTI_TRAINER_STEPS + 1)]
        if losses != list(no_group_losses[:MULTI_TRAINER_STEPS]):
            raise AssertionError(f"the trainer in a group of one: losses "
                                 f"{losses}, without a group "
                                 f"{no_group_losses}")
        log(f"trainer in an NCCL group of one rank: {MULTI_TRAINER_STEPS} "
            f"steps bit-equal to the trainer phase's run A without a group "
            f"(losses {losses}), an NCCL all-reduce on the card; "
            f"{group_s:.2f} s with start-up and the profile window; card "
            f"{card}")
        trace = os.path.join(profile_dir, "trace_rank0.json")
        if not os.path.getsize(trace):
            raise AssertionError("the profile window wrote no trace")

        def named(kernels):
            return [x for x in lines if any(
                re.search(rf"\b{k}\b", x) for k in kernels)]

        k2, k3 = named(PROFILE_KERNEL_2), named(PROFILE_KERNEL_3)
        window = PROFILE_STEPS[1] - PROFILE_STEPS[0]
        where = "device" if device.type == "cuda" else "host"
        if (not k2 or not k3 or not all(f"ms {where}/step over {window} "
                                        "steps" in x for x in k2 + k3)):
            raise AssertionError(f"the profile summary does not name "
                                 f"kernels 2 and 3: {lines[:40]}")
        for line in k2 + k3:
            log(f"profile window [{PROFILE_STEPS[0]}, {PROFILE_STEPS[1]}): "
                f"{line}; card {card}")
        log(f"profile window: {len(lines)} summary lines, chrome trace "
            f"{os.path.getsize(trace)} bytes")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"multi-device phase s {time.perf_counter() - t_phase:.3f}; "
        f"card {card}")


OCTO_CONFIG = "octo_pretrain_config:vit_s,oxe"
OCTO_TASK = "pick up the coke can"
OCTO_REPEAT = 5          # steps of the repeat from the same init_rng
OCTO_TRAIN_BATCH = 256   # the config's own batch
OCTO_TIMED_STEPS = 2     # hand-fed steps timed after the compared one
OCTO_TRAINER_BATCH = 64
OCTO_TRAINER_STEPS = 3
OCTO_ACTION_TOL = 1e-4
OCTO_LOSS_TOL, OCTO_GRAD_TOL = 1e-4, 1e-3


def _nine_kernel_counts():
    """The launch counters of the nine TPU kernels' wrappers."""
    from hypervla_tpu_torch.ops import add_layer_norm as aln
    from hypervla_tpu_torch.ops import dino_layer as dl
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import flash_attention as fl
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.ops import gelu
    from hypervla_tpu_torch.ops import layer_norm as ln

    modules = (aln, dl, dlt, fl, fa, gelu, ln)
    return modules, lambda: {k: v for m in modules
                             for k, v in m.LAUNCHES.items()}


def _octo_batch(rng, tokenizer, batch, horizon=4):
    """A synthetic Octo training batch of `batch` rows at 224 px: one
    frame a row, its instruction tokenized, the last action dim of every
    fourth row's chunk padded."""
    import numpy as np

    words = [b"pick up the coke can", b"open the top drawer"]
    tokens = tokenizer.encode([words[i % 2] for i in range(batch)])
    act_mask = np.ones((batch, 1, horizon, 7), bool)
    act_mask[::4, :, :, -1] = False
    return {
        "observation": {
            "image_primary": rng.integers(0, 256, (batch, 1, 224, 224, 3),
                                          dtype=np.uint8),
            "timestep_pad_mask": np.ones((batch, 1), bool),
            "pad_mask_dict": {"image_primary": np.ones((batch, 1), bool)}},
        "task": {"language_instruction": {
            "input_ids": np.asarray(tokens["input_ids"]),
            "attention_mask": np.asarray(tokens["attention_mask"])},
            "pad_mask_dict": {"language_instruction": np.ones(batch, bool)}},
        "action": rng.uniform(-1, 1, (batch, 1, horizon, 7)).astype(
            np.float32),
        "action_pad_mask": act_mask,
    }


def _octo_setup(device):
    """(config, text_apply, t5_params, tokenizer, example batch) of the
    Octo model: the built-in config, the seeded T5 and fallback tokenizer,
    a one-frame example batch at 224 px with a goal image."""
    import numpy as np
    import torch

    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer

    config = cli.load_config(OCTO_CONFIG)
    text_apply, _, t5_params, _ = trainer.build_frozen_encoders(config,
                                                                device)
    tokenizer = trainer._tokenizer(config)
    tokens = tokenizer.encode([OCTO_TASK])
    with torch.no_grad():
        embedding = text_apply(
            t5_params, torch.as_tensor(tokens["input_ids"], device=device),
            torch.as_tensor(tokens["attention_mask"], device=device))
    example = {
        "observation": {"image_primary": np.zeros((1, 1, 224, 224, 3),
                                                  np.uint8),
                        "timestep_pad_mask": np.ones((1, 1), bool)},
        "task": {"image_primary": np.zeros((1, 224, 224, 3), np.uint8),
                 "language_instruction": dict(
                     tokens, token_embedding=embedding.cpu().numpy()),
                 "pad_mask_dict": {"language_instruction": np.ones(1, bool),
                                   "image_primary": np.ones(1, bool)}},
    }
    return config, text_apply, t5_params, tokenizer, example


def octo_reference(model, config, state0, batch, embedding, drawn):
    """The octo phase's CPU reference: the card's first hand-fed step
    again on the CPU, on every core, from the same initial params
    (state0), batch, T5 embedding and draws. Returns (loss, grad_norm,
    seconds, cores)."""
    import torch

    from hypervla_tpu_torch.models.draws import Draws
    from hypervla_tpu_torch.parallel.mesh import to_device
    from hypervla_tpu_torch.train import octo_train

    t0 = time.perf_counter()
    cores = len(os.sched_getaffinity(0))
    torch.set_num_threads(cores)
    cpu = torch.device("cpu")
    params = {k: v.clone().requires_grad_(True) for k, v in state0.items()}
    tx, step = octo_train.make_train_step(
        model.replace(params=params, device=cpu), config,
        lambda p, ids, mask: embedding, None)
    loss, grad_norm, _ = step(params, tx.init(params), to_device(batch, cpu),
                              Draws(replay=drawn), OCTO_TRAIN_BATCH)
    return (float(loss), float(grad_norm), time.perf_counter() - t0,
            cores)


def octo_phase(device, card):
    """The Octo model at vit_s width through OctoInference and the
    octo_train driver (module docstring, phase 11)."""
    import logging
    import shutil
    import tempfile

    import numpy as np
    import torch

    from hypervla_tpu_torch.eval.octo_inference import OctoInference
    from hypervla_tpu_torch.models.draws import Draws
    from hypervla_tpu_torch.models.octo_model import OctoModel
    from hypervla_tpu_torch.parallel.mesh import to_device
    from hypervla_tpu_torch.train import octo_train

    modules, counts = _nine_kernel_counts()
    for m in modules:
        m.reset_launch_counts()
    clock = time.perf_counter()

    def at(part):
        log(f"octo phase clock: {part} at {time.perf_counter() - clock:.1f} "
            "s")

    config, text_apply, t5_params, tokenizer, example = _octo_setup(device)

    @torch.no_grad()
    def embed(ids, mask):
        return text_apply(t5_params, torch.as_tensor(ids, device=device),
                          torch.as_tensor(mask, device=device))

    rng = np.random.default_rng(SEED + 41)
    action_stats = {
        "mean": (rng.standard_normal(7) * 0.1).astype(np.float32),
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False])}
    stats = {"fractal20220817_data": {"action": action_stats}}
    t0 = time.perf_counter()
    model = OctoModel.from_config(config, example, text_processor=tokenizer,
                                  rng=SEED, dataset_statistics=stats,
                                  text_embed_fn=embed, device=device)
    torch.cuda.synchronize()
    n_params = sum(v.numel() for v in model.params.values())
    log(f"octo build: {config['model']['token_embedding_size']} x "
        f"{config['model']['transformer_kwargs']['num_layers']} layers, "
        f"{n_params} params in {len(model.params)} leaves, built in "
        f"{time.perf_counter() - t0:.2f} s; {card}")

    # ---- serving ----
    at("built")
    frames = rng.integers(0, 256, (STEPS, 256, 256, 3), dtype=np.uint8)
    default = OctoInference(model, pred_action_horizon=4)
    default.reset(OCTO_TASK)
    try:
        default.step(frames[0])
    except AssertionError as e:
        log(f"octo serving at the JAX default image_size 256 fails as in "
            f"the JAX package ({e}); serving at 224, the model's size")
    else:
        raise AssertionError("octo: a 224-px model served 256-px frames")

    def wrapper():
        w = OctoInference(model, policy_setup="google_robot", horizon=2,
                          pred_action_horizon=4, image_size=224,
                          init_rng=SEED, action_ensemble=True)
        w.reset(OCTO_TASK)
        return w

    policy = wrapper()
    raws, acts, times = [], [], []
    for frame in frames:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        raw, act = policy.step(frame)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        raws.append(raw)
        acts.append(act)
    raws, acts = np.stack(raws), np.stack(acts)
    if acts.shape != (STEPS, 7) or not (np.isfinite(acts).all()
                                        and np.isfinite(raws).all()):
        raise AssertionError(f"octo serving: bad actions {acts.shape}")
    again = wrapper()
    repeat = np.stack([again.step(f)[0] for f in frames[:OCTO_REPEAT]])
    if not np.array_equal(repeat, raws[:OCTO_REPEAT]):
        raise AssertionError("octo serving: the same init_rng served other "
                             "actions")
    busy, kernels = device_busy(lambda: policy.step(frames[-1]))
    med = statistics.median(times[1:])
    log(f"octo serving: {STEPS} steps, ms/step (median of steps 2-{STEPS}, "
        f"CUDA events) {med:.4f}, first step {times[0]:.4f}; step "
        f"profiled: device busy ms {busy:.4f}, {kernels:.0f} device "
        f"kernels, idle share {1 - busy / med:.3f}; a repeat from the same "
        f"init_rng bit-equal over {OCTO_REPEAT} steps; first action "
        f"{acts[0].tolist()}; {card}")

    # the first step's sample on the card and on the CPU
    at("served")
    first = wrapper()
    first.step(frames[0])
    obs = {"image_primary": np.stack(first.image_history)[None],
           "timestep_pad_mask": np.ones((1, len(first.image_history)))}
    rec = Draws(torch.Generator(device=device).manual_seed(SEED),
                record=True)
    on_card = model.sample_actions(obs, first.task, action_stats, rng=rec)
    sample_draws = {k: v.cpu().numpy() for k, v in rec.drawn.items()}
    cpu_model = model.replace(params=_to(model.params, "cpu"),
                              device=torch.device("cpu"))
    on_cpu = cpu_model.sample_actions(obs, first.task, action_stats,
                                      rng=Draws(replay=sample_draws))
    err, scale = max_err(on_card.cpu(), on_cpu)
    log(f"octo first sample card vs CPU (fp32, TF32 off, the same "
        f"observations and draws): max_abs_err {err:.6g} (bound "
        f"{OCTO_ACTION_TOL * max(scale, 1.0):.6g})")
    if not err <= OCTO_ACTION_TOL * max(scale, 1.0):
        raise AssertionError("octo: the card's actions disagree with the "
                             "CPU's")

    # ---- one hand-fed train step at batch 256, against the CPU's ----
    at("first sample compared")
    root = tempfile.mkdtemp(prefix="hypervla_octo_")
    try:
        batch = _octo_batch(rng, tokenizer, OCTO_TRAIN_BATCH)
        on = to_device(batch, device)
        instr = on["task"]["language_instruction"]
        with torch.no_grad():
            emb = text_apply(t5_params, instr["input_ids"],
                             instr["attention_mask"]).float()
        tx, step = octo_train.make_train_step(
            model, config, lambda p, ids, mask: emb, None)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in model.params.items()}
        state0 = {k: v.detach().cpu().clone() for k, v in params.items()}
        opt_state = tx.init(params)
        rec = Draws(torch.Generator(device=device).manual_seed(SEED + 1),
                    record=True)
        torch.cuda.reset_peak_memory_stats()
        loss, grad_norm, opt_state = step(params, opt_state, on, rec,
                                          OCTO_TRAIN_BATCH)
        loss, grad_norm = float(loss), float(grad_norm)
        drawn = {k: v.cpu().numpy() for k, v in rec.drawn.items()}
        step_ms = []
        for i in range(OCTO_TIMED_STEPS):
            draws = Draws(torch.Generator(device=device).manual_seed(
                SEED + 2 + i))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, _, opt_state = step(params, opt_state, on, draws,
                                   OCTO_TRAIN_BATCH)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        peak = torch.cuda.max_memory_allocated() / 2**30
        busy, kernels = device_busy(lambda: step(
            params, opt_state, on, Draws(torch.Generator(
                device=device).manual_seed(SEED)), OCTO_TRAIN_BATCH),
            host=False)
        ms = statistics.median(step_ms)
        log(f"octo train step, batch {OCTO_TRAIN_BATCH}: ms/step "
            f"{ms:.2f} (median of {OCTO_TIMED_STEPS}: "
            f"{[round(t, 2) for t in step_ms]}), samples/s "
            f"{OCTO_TRAIN_BATCH * 1000 / ms:.1f}, peak {peak:.2f} GiB; "
            f"step profiled: device busy ms {busy:.2f}, {kernels:.0f} "
            f"device kernels, idle share {1 - busy / ms:.3f}; {card}")
        cpu_emb = emb.cpu()
        del params, opt_state, on, emb
        torch.cuda.empty_cache()
        # the same first step on the CPU, in a thread beside the checkpoint,
        # the driver's run and the encoders phase (their seconds are then
        # not a clean number); the callable this phase returns reads it
        threads = torch.get_num_threads()
        pool = ThreadPoolExecutor(max_workers=1)
        reference = pool.submit(octo_reference, model, config, state0, batch,
                                cpu_emb, drawn)
        at("card train steps")

        # ---- checkpoint ----
        path = os.path.join(root, "ckpt")
        t0 = time.perf_counter()
        model.save_pretrained(step=1, checkpoint_path=path)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = OctoModel.load_pretrained(path, device=device)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = all(torch.equal(loaded.params[k], v)
                   for k, v in model.params.items())
        a = model.sample_actions(obs, first.task, action_stats,
                                 rng=Draws(replay=sample_draws))
        b = loaded.sample_actions(obs, first.task, action_stats,
                                  rng=Draws(replay=sample_draws))
        log(f"octo checkpoint: save {save_s:.3f} s, load onto the card "
            f"{load_s:.3f} s; params bit-equal {same}, next action "
            f"bit-equal {bool(torch.equal(a, b))}")
        if not same or not torch.equal(a, b):
            raise AssertionError("octo: the checkpoint round trip changed "
                                 "the model")
        del loaded, cpu_model, a, b

        # ---- the driver on the fixture mix ----
        at("checkpoint")
        data = os.path.join(root, "data")
        mix, _, _ = write_trainer_fixture(data)
        save_dir = os.path.join(root, "run")
        argv = ["--config", OCTO_CONFIG, "--save_dir", save_dir,
                f"--config.dataset_kwargs.oxe_mix={mix!r}",
                f"--config.dataset_kwargs.data_dir={data!r}",
                f"--config.dataset_kwargs.batch_size={OCTO_TRAINER_BATCH}",
                "--config.dataset_kwargs.shuffle_buffer_size="
                f"{TRAINER_SHUFFLE}",
                f"--config.num_steps={OCTO_TRAINER_STEPS}",
                "--config.log_interval=1",
                f"--config.save_interval={OCTO_TRAINER_STEPS}",
                *(["--cpu"] if device.type == "cpu" else [])]
        losses = []

        class Losses(logging.Handler):
            def emit(self, record):
                found = re.match(r"step \d+: loss=(\S+)",
                                 record.getMessage())
                if found:
                    losses.append(float(found.group(1)))

        handler = Losses()
        logging.getLogger().addHandler(handler)
        t0 = time.perf_counter()
        try:
            _, final = octo_train.main(argv)
        finally:
            logging.getLogger().removeHandler(handler)
        run_s = time.perf_counter() - t0
        saved = OctoModel.load_pretrained(save_dir, device="cpu")
        if (len(losses) != OCTO_TRAINER_STEPS
                or not all(map(math.isfinite, losses))
                or not all(torch.equal(saved.params[k], v)
                           for k, v in final.items())):
            raise AssertionError(f"octo trainer: losses {losses}, or the "
                                 f"step-{OCTO_TRAINER_STEPS} checkpoint is "
                                 "not the final params")
        log(f"octo trainer: octo_train.main on {mix}, {OCTO_TRAINER_STEPS} "
            f"steps at batch {OCTO_TRAINER_BATCH} in {run_s:.2f} s with its "
            f"start, losses {losses}, the step-{OCTO_TRAINER_STEPS} "
            "checkpoint the final params")
        at("trainer")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launched = {k: v for k, v in counts().items() if v}
    log(f"octo phase launches of the nine TPU kernels' wrappers: "
        f"{launched or 'none'}")
    if launched:
        raise AssertionError(f"octo: a TPU kernel's wrapper launched on "
                             f"the Octo path: {launched}")

    def compare_to_cpu():
        """Waits for the CPU's step, which runs on beside the phases after
        this one, and holds the card's first step to it."""
        try:
            cpu_loss, cpu_norm, cpu_s, cores = reference.result(timeout=900)
        finally:
            torch.set_num_threads(threads)
            pool.shutdown()
        loss_rel = abs(loss - cpu_loss) / abs(cpu_loss)
        norm_rel = abs(grad_norm - cpu_norm) / abs(cpu_norm)
        log(f"octo train step card vs CPU (same state, T5 embedding and "
            f"draws; the CPU step {cpu_s:.1f} s on {cores} cores, beside the "
            f"checkpoint, the driver and the encoders phase): loss "
            f"{loss:.8g} vs {cpu_loss:.8g} (rel {loss_rel:.3g}, bound "
            f"{OCTO_LOSS_TOL}), grad_norm {grad_norm:.8g} vs {cpu_norm:.8g} "
            f"(rel {norm_rel:.3g}, bound {OCTO_GRAD_TOL})")
        if not (loss_rel <= OCTO_LOSS_TOL and norm_rel <= OCTO_GRAD_TOL):
            raise AssertionError("octo: the card's train step disagrees "
                                 "with the CPU's")

    return compare_to_cpu


#: the encoders phase: serving ticks and train steps of each model, the
#: SigLIP model's, the CPU comparison's batch, and the SigLIP embeddings'
#: shape (SigLIP so400m/14 at 224 px: 256 tokens of 1152)
ENC_SERVE_STEPS = 20
ENC_TRAIN_STEPS = 2
SIGLIP_SERVE_STEPS, SIGLIP_TRAIN_STEPS = 5, 1
SIGLIP_TOKENS, SIGLIP_DIM = 256, 1152
ENC_CPU_BATCH = 2
ENC_ACTION_TOL = 1e-4
ENC_LOSS_TOL, ENC_GRAD_TOL = 1e-4, 1e-3
EFFICIENTNET_SIZE = 300
#: the Octo model of the phase: the config's ImageTokenizer on
#: resnetv2-26-film over ImageNet-normalized frames, FiLM-conditioned on a
#: task key, and the in-model T5-base LanguageTokenizer as its text encoder
OCTO_RESNET_ENCODER = {"module": "hypervla_tpu_torch.models.vit_encoders",
                       "name": "ResNet26FILM", "args": (),
                       "kwargs": {"img_norm_type": "imagenet"}}
OCTO_FILM_KEY = "language_embedding"


def _compare_to_plain(name, state0, kernel, plain):
    """The first step's loss and grad_norm within STEP_REL_BOUND of the
    plain step's and every leaf's update within COSINE_BOUND (cosine) of
    the plain update's; kernel and plain are (new state, info). A leaf the
    plain step leaves at noise (its update below 1e-3 of the median leaf's)
    must move as little on the kernels."""
    for key in ("training_loss", "grad_norm"):
        a, b = float(kernel[1][key]), float(plain[1][key])
        log(f"encoders {name} first step {key}: kernels {a:.6g} plain "
            f"{b:.6g} (rel {abs(a - b) / abs(b):.3g}, bound "
            f"{STEP_REL_BOUND})")
        if not abs(a - b) <= STEP_REL_BOUND * abs(b):
            raise AssertionError(f"{name}: first-step {key} kernels vs plain")
    plain_up = {k: plain[0].params[k].detach() - v.detach()
                for k, v in state0.params.items()}
    typical = statistics.median(float(p.norm()) for p in plain_up.values())
    degenerate = {k for k, p in plain_up.items()
                  if float(p.norm()) < 1e-3 * typical}
    worst, moved = (2.0, None), 0.0
    for k, v in state0.params.items():
        up = kernel[0].params[k].detach() - v.detach()
        if k in degenerate:
            moved = max(moved, float(up.norm()) / typical)
        else:
            worst = min(worst, (_cosine(up, plain_up[k]), k))
    log(f"encoders {name} first step updates, kernels vs plain: lowest "
        f"per-leaf cosine {worst[0]:.6f} ({worst[1]}), bound {COSINE_BOUND};"
        f" {len(degenerate)} leaves barely move (largest kernel update of "
        f"those {moved:.3g} of the median leaf's)")
    if not worst[0] > COSINE_BOUND or not moved < 1e-2:
        raise AssertionError(f"{name}: the updates disagree with the plain "
                             "path")


def encoders_phase(device, card):
    """The second half of ROADMAP A12.2 at full width, random weights from
    a seed (module docstring, phase 12): the differential flagship, the
    BaseModel ablation, the CLIP-base, EfficientNet-b3 and SigLIP
    HyperVLAs and the Octo model on the ResNet-26 FiLM tokenizer with the
    in-model T5. Returns {model: launches of the nine TPU kernels'
    wrappers over its counted serving steps and train steps}."""
    import copy
    import shutil
    import tempfile

    import numpy as np
    import torch

    from hypervla_tpu_torch.configs import (
        apply_fast_training_preset,
        base_pretrain_config,
        flagship_pretrain_config,
    )
    from hypervla_tpu_torch.eval.inference import InferenceWrapper
    from hypervla_tpu_torch.eval.octo_inference import OctoInference
    from hypervla_tpu_torch.flagship import make_flagship_batch
    from hypervla_tpu_torch.models.base_model import BaseModel
    from hypervla_tpu_torch.models.base_network import BaseNetwork
    from hypervla_tpu_torch.models.draws import Draws, InvalidRngError
    from hypervla_tpu_torch.models.hypernetwork import HyperNetwork
    from hypervla_tpu_torch.models.hypervla import HyperVLA
    from hypervla_tpu_torch.models.octo_model import OctoModel
    from hypervla_tpu_torch.models.tokenizers import LanguageTokenizer
    from hypervla_tpu_torch.models.weight_plan import input_shapes
    from hypervla_tpu_torch.ops import dino_layer_train as dlt
    from hypervla_tpu_torch.ops import fused_attention as fa
    from hypervla_tpu_torch.train import main as cli
    from hypervla_tpu_torch.train import trainer
    from hypervla_tpu_torch.train.optimizer import (
        create_optimizer,
        hn_param_type_tree,
    )
    from hypervla_tpu_torch.train.train_state import TrainState
    from hypervla_tpu_torch.train.train_step import (
        make_train_step,
        to_tensors,
    )
    from hypervla_tpu_torch.utils.convert import trunk_depth

    t_phase = time.perf_counter()
    modules, counts = _nine_kernel_counts()
    rng = np.random.default_rng(SEED + 50)
    stats = {"action": {
        "mean": rng.standard_normal(7).astype(np.float32) * 0.1,
        "std": (1 + rng.random(7)).astype(np.float32),
        "mask": np.array([True] * 6 + [False])}}
    frames = rng.integers(0, 256, (ENC_SERVE_STEPS + 1, 256, 256, 3),
                          dtype=np.uint8)
    example = make_flagship_batch(seed=SEED)
    instruction = {"language_instruction":
                   example["task"]["language_instruction"]}
    init_state = {"patch_embeddings":
                  example["initial_state"]["patch_embeddings"]}
    big = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED)
    # the step embeds the instruction and the initial image itself
    del big["task"]["language_instruction"]["token_embedding"]
    del big["initial_state"]["patch_embeddings"]
    fast_flagship = apply_fast_training_preset(flagship_pretrain_config())
    depth = trunk_depth(fast_flagship)
    # a fast-preset step's launches: the fine-tuned trunk's attention
    # forward and backward (kernel 2), the frozen encode of the initial
    # image (kernel 3's no-residual forward), a launch a layer each
    fine_tuned = {"mha_fused_train_fwd": depth, "mha_fused_train_bwd": depth}
    frozen_only = {"dino_layer_train_fwd": depth}
    plain_flagship = copy.deepcopy(fast_flagship)
    plain_flagship["base_net_kwargs"]["vit_kwargs"][
        "dino_fused_attention"] = False
    plain_flagship["frozen_encoder_layer_kernel"] = False
    frozen = {}
    for kind, cfg in (("kernels", fast_flagship), ("plain", plain_flagship)):
        text_apply, dino_apply, t5, dino_params = (
            trainer.build_frozen_encoders(cfg, device=device,
                                          seed=SEED + 1))
        frozen[kind] = (text_apply, dino_apply, {"t5": t5,
                                                 "dino": dino_params})
    out = {}

    def randomize_heads(model):
        """Random fan-out kernels make the generated weights depend on
        the task (at init they are 0)."""
        gen = torch.Generator(device=device).manual_seed(SEED + 51)
        for name, value in model.params.items():
            if name.startswith("output_head_") and name.endswith("/kernel"):
                value += 0.02 * torch.randn(value.shape, generator=gen,
                                            device=device)

    def variant(model, config):
        return HyperVLA(HyperNetwork(model.plan, config["hypernet_kwargs"]),
                        BaseNetwork(**config["base_net_kwargs"],
                                    input_shapes=input_shapes(
                                        model.example_batch)),
                        config, model.params, model.plan, stats, device,
                        model.example_batch)

    def serve(model, trunk_impl, n, init=init_state, embeddings=None,
              host=False, image_size=224):
        """n ticks of an InferenceWrapper (fused unless host) from the
        same init_rng: (actions (n, 7), ms a tick, the wrapper)."""
        w = InferenceWrapper(
            model, policy_setup="google_robot", image_size=image_size,
            action_ensemble=True, crop=True, fused_serving=not host,
            trunk_impl=trunk_impl, init_rng=SEED,
            pred_action_horizon=model.config["base_net_kwargs"][
                "action_horizon"])
        w.reset("pick up the cube", instruction, init)
        actions, times = [], []
        for f in frames[1:n + 1]:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            actions.append(w.step(f, image_embeddings=embeddings)[0])
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return np.stack(actions), times, w

    def serve_against_plain(name, model):
        """ENC_SERVE_STEPS fused ticks on kernel 1's stacked trunk (one
        launch a tick) against the same ticks on its plain version."""
        for m in modules:
            m.reset_launch_counts()
        actions, times, w = serve(model, "kernel", ENC_SERVE_STEPS)
        torch.cuda.synchronize()
        launched = {k: v for k, v in counts().items() if v}
        plain, _, _ = serve(model, "reference", ENC_SERVE_STEPS)
        if launched.get("dino_layers_serving") != ENC_SERVE_STEPS:
            raise AssertionError(f"{name}: serving launches {launched}, "
                                 f"want {ENC_SERVE_STEPS} of kernel 1")
        if not np.isfinite(actions).all():
            raise AssertionError(f"{name}: non-finite actions")
        scale = max(float(np.abs(plain).max()), 1.0)
        err = float(np.abs(actions - plain).max())
        busy, kernels = device_busy(lambda: w.step(frames[1]))
        med = statistics.median(times[1:])
        log(f"encoders {name} serving: {ENC_SERVE_STEPS} fused steps on "
            f"kernel 1 ({launched}), actions vs the plain trunk max_abs_err "
            f"{err:.6g} (bound {TRUNK_BOUND * scale:.6g}); ms/step (median "
            f"of steps 2-{ENC_SERVE_STEPS}, CUDA events) {med:.4f}; step "
            f"profiled: device busy ms {busy:.4f}, {kernels:.0f} device "
            f"kernels, idle share {1 - busy / med:.3f}; first action "
            f"{actions[0].tolist()}; {card}")
        if not err < TRUNK_BOUND * scale:
            raise AssertionError(f"{name}: actions disagree with the plain "
                                 "trunk")
        return launched

    def trainer_of(model, config, kind="kernels"):
        text_apply, dino_apply, encoders = frozen[kind]
        tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
            model.params, hn_param_type_tree(model.params),
            **config["optimizer"])
        step_fn = make_train_step(model, config, tx, lr_fn, base_lr_fn,
                                  pnorm_fn, text_encode=text_apply,
                                  dino_encode=dino_apply)
        state0 = TrainState.create(model.params, tx, seed=SEED)
        warmup = config["optimizer"]["learning_rate"]["warmup_steps"]
        state0.step = warmup
        state0.opt_state["count"] = warmup
        return step_fn, state0, encoders

    def train_counts():
        """The launches of kernels 2 and 3's wrappers since the reset."""
        return {k: v for m in (fa, dlt) for k, v in m.LAUNCHES.items() if v}

    def train(name, model, config, batch, want, plain_config=None,
              n=ENC_TRAIN_STEPS, trace=True):
        """n fast-preset steps at batch 64 from one state, each launching
        the training kernels `want` says (kernels 2 and 3's wrappers; a
        layer call of kernel 3 also counts its GEMM and LayerNorm parts
        under kernel 1's module); with plain_config the first step also
        against the same step on the kernels' plain versions; with trace,
        one step traced. Returns the launches of the last step."""
        step_fn, state0, encoders = trainer_of(model, config)
        batch = to_tensors(batch, device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, times, losses, per_step = state0, [], [], []
        for i in range(n):
            for m in modules:
                m.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            # the first step with its norms, for the comparison
            new_state, info = step_fn(state, batch, encoder_params=encoders,
                                      with_metrics=i == 0)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
            per_step.append(train_counts())
            losses.append(float(info["training_loss"]))
            if i == 0:
                peak = torch.cuda.max_memory_allocated()
                first = (new_state, info)
            state = new_state
        if plain_config is not None:
            plain_model = variant(model, plain_config)
            plain_fn, _, plain_enc = trainer_of(plain_model, plain_config,
                                                "plain")
            plain = plain_fn(state0, batch, encoder_params=plain_enc)
            _compare_to_plain(name, state0, first, plain)
            del plain, plain_fn, plain_model
        del state, new_state, first
        for launched in per_step:
            if launched != want:
                raise AssertionError(f"{name}: a train step launched "
                                     f"{launched}, want {want}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{name}: a train loss is not finite")
        med = statistics.median(times[1:] or times)
        traced = "not traced"
        if trace:
            busy, kernels = device_busy(lambda: step_fn(
                state0, batch, encoder_params=encoders, with_metrics=False),
                host=False)
            traced = (f"step profiled: device busy ms {busy:.3f}, "
                      f"{kernels:.0f} device kernels, idle share "
                      f"{1 - busy / med:.3f}")
        log(f"encoders {name} train: losses {losses}; launches a step "
            f"{per_step[-1]}; ms/step (CUDA events, batch "
            f"{batch['action'].shape[0]}; the median of steps 2-{n}, the "
            f"first with its norms {times[0]:.4f}) {med:.4f}; {traced}; "
            f"peak memory (max_memory_allocated over the first step) "
            f"{peak / 2 ** 30:.3f} GiB; {card}")
        del step_fn, state0
        torch.cuda.empty_cache()
        return per_step[-1]

    def against_cpu(name, model, config, image_size=224, actions=True):
        """The card against the CPU in fp32 (TF32 off): with actions, the
        actions of one frame; then one train step at ENC_CPU_BATCH from
        the same state on a batch that carries its embeddings, its draws
        made on the CPU and replayed on the card."""
        cpu = torch.device("cpu")
        cores = len(os.sched_getaffinity(0))
        threads = torch.get_num_threads()
        torch.set_num_threads(cores)
        t0 = time.perf_counter()
        on_cpu = model.replace(params=_to(model.params, cpu), device=cpu)
        if actions:
            image = example["observation"]["image_primary"]
            got = []
            for m in (model, on_cpu):
                params, task = m.create_tasks(instruction_dict=instruction,
                                              initial_state=init_state)
                got.append(m.sample_actions(image, instruction, task, None,
                                            params).cpu())
            err, scale = max_err(got[0], got[1])
            log(f"encoders {name} actions card vs CPU (fp32, TF32 off): "
                f"max_abs_err {err:.6g} (bound "
                f"{ENC_ACTION_TOL * max(scale, 1.0):.6g})")
            if not err <= ENC_ACTION_TOL * max(scale, 1.0):
                raise AssertionError(f"{name}: the card's actions disagree "
                                     "with the CPU's")
        batch = make_flagship_batch(batch_size=ENC_CPU_BATCH, seed=SEED + 3,
                                    image_size=image_size)
        info = {}
        drawn = None
        for m, where in ((on_cpu, "cpu"), (model, "card")):
            tx, lr_fn, base_lr_fn, pnorm_fn = create_optimizer(
                m.params, hn_param_type_tree(m.params), **config["optimizer"])
            step_fn = make_train_step(m, config, tx, lr_fn, base_lr_fn,
                                      pnorm_fn)
            state = TrainState.create(
                {k: v.detach().clone().requires_grad_(True)
                 for k, v in m.params.items()}, tx, seed=SEED,
                track_ema=False)
            if drawn is None:
                draws = Draws(torch.Generator().manual_seed(SEED),
                              record=True)
            else:
                draws = Draws(replay=drawn)
            _, info[where] = step_fn(state, batch, draws=draws)
            if drawn is None:
                drawn = {k: v.numpy() for k, v in draws.drawn.items()}
            del state, step_fn, tx
        torch.set_num_threads(threads)
        for key, tol in (("training_loss", ENC_LOSS_TOL),
                         ("grad_norm", ENC_GRAD_TOL)):
            a, b = float(info["card"][key]), float(info["cpu"][key])
            log(f"encoders {name} train step card vs CPU (batch "
                f"{ENC_CPU_BATCH}, fp32, {len(drawn)} draw sites replayed): "
                f"{key} {a:.8g} vs {b:.8g} (rel {abs(a - b) / abs(b):.3g}, "
                f"bound {tol})")
            if not abs(a - b) <= tol * abs(b):
                raise AssertionError(f"{name}: the card's {key} disagrees "
                                     "with the CPU's")
        log(f"encoders {name} CPU comparison s {time.perf_counter() - t0:.1f}"
            f" ({cores} cores)")

    log(f"encoders frozen encoders at {time.perf_counter() - t_phase:.1f} s")
    # ---- the differential flagship ----
    clock = time.perf_counter()
    config = flagship_pretrain_config()
    vk = config["base_net_kwargs"]["vit_kwargs"]
    vk.update(use_differential_transformer=True, encoder_dtype="bfloat16")
    model = HyperVLA.from_config(config, example, seed=SEED, device=device,
                                 dataset_statistics=stats)
    randomize_heads(model)
    log(f"encoders differential clock: built at "
        f"{time.perf_counter() - clock:.1f} s")
    fast = apply_fast_training_preset(copy.deepcopy(config))
    plain = copy.deepcopy(fast)
    plain["base_net_kwargs"]["vit_kwargs"]["dino_fused_attention"] = False
    plain["frozen_encoder_layer_kernel"] = False
    served = serve_against_plain("differential", model)
    log(f"encoders differential clock: served at "
        f"{time.perf_counter() - clock:.1f} s")
    out["differential"] = {
        "serve": served,
        "train": train("differential", variant(model, fast), fast, big,
                       {**fine_tuned, **frozen_only}, plain)}
    del model
    log(f"encoders differential s {time.perf_counter() - clock:.1f}")

    # ---- the BaseModel ablation ----
    clock = time.perf_counter()
    fast = base_pretrain_config("vit_t,oxe,fast")
    plain = copy.deepcopy(fast)
    plain["base_net_kwargs"]["vit_kwargs"]["dino_fused_attention"] = False
    plain["frozen_encoder_layer_kernel"] = False
    # the trainer's view: a HyperVLA whose blocks are all shared
    hyper = HyperVLA.from_config(fast, example, seed=SEED, device=device,
                                 dataset_statistics=stats)
    trained = train("base_model", hyper, fast, big, fine_tuned, plain)
    log(f"encoders base_model clock: trained at "
        f"{time.perf_counter() - clock:.1f} s")
    # the same weights served as a BaseModel: every block is shared, so
    # the HyperVLA's flat params are the base net's, reshaped
    base = BaseModel(hyper.base_net, fast, hyper.shared_params(""),
                     hyper.example_batch, stats, hyper.plan, device)
    del hyper
    served = serve_against_plain("base_model", base)
    root = tempfile.mkdtemp(prefix="hypervla_base_model_")
    try:
        base.save_pretrained(1, checkpoint_path=root)
        loaded = BaseModel.load_pretrained(root, device=device)
        same = set(loaded.params) == set(base.params) and all(
            torch.equal(loaded.params[k], v) for k, v in base.params.items())
        again, _, _ = serve(loaded, "kernel", 3)
        first, _, _ = serve(base, "kernel", 3)
        log(f"encoders base_model save/load round trip: params bit-equal "
            f"{same}, the next 3 actions bit-equal "
            f"{np.array_equal(again, first)}")
        if not same or not np.array_equal(again, first):
            raise AssertionError("base_model: the round trip changed it")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["base_model"] = {"serve": served, "train": trained}
    del base, loaded
    torch.cuda.empty_cache()
    log(f"encoders base_model s {time.perf_counter() - clock:.1f}")

    # ---- CLIP-base and EfficientNet-b3 in the flagship recipe ----
    for name, size in (("CLIP", 224), ("EfficientNet", EFFICIENTNET_SIZE)):
        clock = time.perf_counter()
        config = flagship_pretrain_config()
        config["base_net_kwargs"]["vit_kwargs"]["encoder_type"] = name
        if name == "EfficientNet":
            # the JAX plan supports a shared backbone only; shared it is one
            # block of the base net, not a generated one per task
            config["hypernet_kwargs"]["shared_modules"] = ("image_encoder",
                                                           "EfficientNet")
        batch = make_flagship_batch(seed=SEED, image_size=size)
        model = HyperVLA.from_config(config, batch, seed=SEED,
                                     device=device, dataset_statistics=stats)
        randomize_heads(model)
        n_params = sum(v.numel() for v in model.params.values())
        log(f"encoders {name}: built in {time.perf_counter() - clock:.2f} "
            f"s, {n_params} params; {card}")
        if name == "CLIP":
            for m in modules:
                m.reset_launch_counts()
            actions, times, w = serve(model, None, ENC_SERVE_STEPS)
            busy, kernels = device_busy(lambda: w.step(frames[1]))
            med = statistics.median(times[1:])
            if not np.isfinite(actions).all():
                raise AssertionError("CLIP: non-finite actions")
            served = {k: v for k, v in counts().items() if v}
            log(f"encoders CLIP serving: {ENC_SERVE_STEPS} fused steps, "
                f"ms/step (median of steps 2-{ENC_SERVE_STEPS}) {med:.4f}; "
                f"step profiled: device busy ms {busy:.4f}, {kernels:.0f} "
                f"device kernels, idle share {1 - busy / med:.3f}; first "
                f"action {actions[0].tolist()}; {card}")
        else:
            # the JAX serving path gives the backbone no "drop_connect"
            # stream and fails at its first droppable block; so does this
            try:
                serve(model, None, 1, image_size=size)
            except InvalidRngError as e:
                log(f"encoders EfficientNet serving raises as in the JAX "
                    f"package: InvalidRngError({e})")
            else:
                raise AssertionError("EfficientNet: served where the JAX "
                                     "package raises InvalidRngError")
            served = {}
        big_enc = make_flagship_batch(batch_size=TRAIN_BATCH, seed=SEED,
                                      image_size=size)
        del big_enc["task"]["language_instruction"]["token_embedding"]
        # the frozen DINOv2 encodes the initial image at its own 224 px
        big_enc["initial_state"] = big["initial_state"]
        fast = apply_fast_training_preset(copy.deepcopy(config))
        trained = train(name, variant(model, fast), fast, big_enc,
                        frozen_only, trace=False)
        against_cpu(name, model, config, size, actions=name == "CLIP")
        out[name] = {"serve": served, "train": trained}
        del model
        torch.cuda.empty_cache()
        log(f"encoders {name} s {time.perf_counter() - clock:.1f}")

    # ---- SigLIP: precomputed embeddings ----
    clock = time.perf_counter()
    config = flagship_pretrain_config()
    config["base_net_kwargs"]["vit_kwargs"]["encoder_type"] = "Siglip"
    sig_example = make_flagship_batch(seed=SEED)
    sig_example["observation"]["patch_embeddings"] = rng.standard_normal(
        (1, SIGLIP_TOKENS, SIGLIP_DIM)).astype(np.float32)
    model = HyperVLA.from_config(config, sig_example, seed=SEED,
                                 device=device, dataset_statistics=stats)
    randomize_heads(model)
    for m in modules:
        m.reset_launch_counts()
    actions, times, _ = serve(
        model, None, SIGLIP_SERVE_STEPS, host=True,
        embeddings=sig_example["observation"]["patch_embeddings"])
    if not np.isfinite(actions).all():
        raise AssertionError("Siglip: non-finite actions")
    served = {k: v for k, v in counts().items() if v}
    log(f"encoders Siglip serving: {SIGLIP_SERVE_STEPS} host-path steps on "
        f"precomputed ({SIGLIP_TOKENS}, {SIGLIP_DIM}) embeddings, ms/step "
        f"(median) {statistics.median(times):.4f}; first action "
        f"{actions[0].tolist()}; {card}")
    big_sig = copy.deepcopy(big)
    big_sig["observation"]["patch_embeddings"] = rng.standard_normal(
        (TRAIN_BATCH, SIGLIP_TOKENS, SIGLIP_DIM)).astype(np.float32)
    fast = apply_fast_training_preset(copy.deepcopy(config))
    out["Siglip"] = {"serve": served,
                     "train": train("Siglip", variant(model, fast), fast,
                                    big_sig, frozen_only,
                                    n=SIGLIP_TRAIN_STEPS, trace=False)}
    del model
    torch.cuda.empty_cache()
    log(f"encoders Siglip s {time.perf_counter() - clock:.1f}")

    # ---- Octo on the ResNet-26 FiLM tokenizer and the in-model T5 ----
    clock = time.perf_counter()
    config = cli.load_config(OCTO_CONFIG)
    config["model"]["observation_tokenizers"]["primary"]["kwargs"] = {
        "obs_stack_keys": ["image_primary"], "task_stack_keys": [],
        "task_film_keys": [OCTO_FILM_KEY], "encoder": OCTO_RESNET_ENCODER}
    language = LanguageTokenizer(encoder="t5-base")
    unset = {k: torch.empty(s, device=device)
             for k, (s, _) in language.specs("language").items()}
    lang_params = language.load_weights(unset, "language", device)
    if lang_params is unset:
        raise AssertionError("octo: no t5-base weights for the "
                             "LanguageTokenizer's T5")
    log(f"encoders octo clock: the in-model T5 loaded at "
        f"{time.perf_counter() - clock:.1f} s")

    @torch.no_grad()
    def embed(ids, mask):
        return language(lang_params, "language", {}, {
            "language_instruction": {
                "input_ids": torch.as_tensor(ids, device=device),
                "attention_mask": torch.as_tensor(mask, device=device)}}
        ).tokens

    tokenizer = trainer._tokenizer(config)
    tokens = tokenizer.encode([OCTO_TASK])
    log(f"encoders octo clock: tokenizer at "
        f"{time.perf_counter() - clock:.1f} s")
    octo_example = {
        "observation": {"image_primary": np.zeros((1, 1, 224, 224, 3),
                                                  np.uint8),
                        "timestep_pad_mask": np.ones((1, 1), bool)},
        "task": {"language_instruction": dict(
                     tokens, token_embedding=embed(
                         tokens["input_ids"],
                         tokens["attention_mask"]).cpu().numpy()),
                 OCTO_FILM_KEY: np.zeros((1, 768), np.float32),
                 "pad_mask_dict": {"language_instruction": np.ones(1, bool),
                                   OCTO_FILM_KEY: np.ones(1, bool)}},
    }
    octo_stats = {"fractal20220817_data": stats}
    model = OctoModel.from_config(config, octo_example,
                                  text_processor=tokenizer, rng=SEED,
                                  dataset_statistics=octo_stats,
                                  text_embed_fn=embed, device=device)
    n_params = sum(v.numel() for v in model.params.values())
    log(f"encoders octo: vit_s on resnetv2-26-film (ImageNet-normalized, "
        f"FiLM on {OCTO_FILM_KEY}) with the in-model T5-base "
        f"LanguageTokenizer as its text encoder, {n_params} params, built "
        f"in {time.perf_counter() - clock:.2f} s; {card}")
    for m in modules:
        m.reset_launch_counts()
    policy = OctoInference(model, policy_setup="google_robot", horizon=2,
                           pred_action_horizon=4, image_size=224,
                           init_rng=SEED, action_ensemble=True)
    policy.reset(OCTO_TASK)
    acts, times = [], []
    for frame in frames[1:ENC_SERVE_STEPS + 1]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        acts.append(policy.step(frame)[1])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    acts = np.stack(acts)
    if acts.shape != (ENC_SERVE_STEPS, 7) or not np.isfinite(acts).all():
        raise AssertionError(f"octo resnet: bad actions {acts.shape}")
    served = {k: v for k, v in counts().items() if v}
    busy, kernels = device_busy(lambda: policy.step(frames[1]))
    med = statistics.median(times[1:])
    log(f"encoders octo serving: {ENC_SERVE_STEPS} OctoInference steps, "
        f"ms/step (median of steps 2-{ENC_SERVE_STEPS}) {med:.4f}; step "
        f"profiled: device busy ms {busy:.4f}, {kernels:.0f} device kernels,"
        f" idle share {1 - busy / med:.3f}; nine-kernel launches {served}; "
        f"first action {acts[0].tolist()}; {card}")
    first = OctoInference(model, policy_setup="google_robot", horizon=2,
                          pred_action_horizon=4, image_size=224,
                          init_rng=SEED, action_ensemble=True)
    first.reset(OCTO_TASK)
    first.step(frames[1])
    obs = {"image_primary": np.stack(first.image_history)[None],
           "timestep_pad_mask": np.ones((1, len(first.image_history)))}
    rec = Draws(torch.Generator(device=device).manual_seed(SEED),
                record=True)
    on_card = model.sample_actions(obs, first.task, stats["action"],
                                   rng=rec)
    cpu = torch.device("cpu")
    on_cpu = model.replace(params=_to(model.params, cpu), device=cpu
                           ).sample_actions(
        obs, first.task, stats["action"], rng=Draws(replay={
            k: v.cpu().numpy() for k, v in rec.drawn.items()}))
    err, scale = max_err(on_card.cpu(), on_cpu)
    log(f"encoders octo first sample card vs CPU (fp32, TF32 off, the same "
        f"observations and draws): max_abs_err {err:.6g} (bound "
        f"{OCTO_ACTION_TOL * max(scale, 1.0):.6g})")
    if not err <= OCTO_ACTION_TOL * max(scale, 1.0):
        raise AssertionError("octo resnet: the card's actions disagree with "
                             "the CPU's")
    out["octo"] = {"serve": served}
    del model
    torch.cuda.empty_cache()
    log(f"encoders octo s {time.perf_counter() - clock:.1f}")
    log(f"encoders phase s {time.perf_counter() - t_phase:.3f}")
    return out


#: calls of entry()'s fn timed on the card (the median is printed)
ENTRY_CALLS = 10
#: the entry phase's actions, card against CPU, fp32 with TF32 off
ENTRY_ACTION_TOL = 1e-4
#: the flagship's action chunk of one frame
ENTRY_ACTION_SHAPE = (1, 4, 7)


def _ten_kernel_counts():
    """The launch counters of the ten TPU kernel rows' wrappers (the nine
    TPU kernels' and the differentiable flash attention's)."""
    from hypervla_tpu_torch.ops import flash_attention_train as ft

    modules, counts = _nine_kernel_counts()
    modules = (*modules, ft)
    return modules, lambda: {**counts(), **ft.LAUNCHES,
                             **{f"{k}_fp32": v
                                for k, v in ft.FP32_LAUNCHES.items()}}


def entry_phase(device, card):
    """hypervla_tpu_torch/entry.py::entry() at full width on the card
    (module docstring, phase 13)."""
    import torch

    from hypervla_tpu_torch.entry import entry

    t_phase = time.perf_counter()
    fn, args = entry()
    params = args[0]
    if params[next(iter(params))].device.type != device.type:
        raise AssertionError("entry(): the params are not on the card")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_phase

    modules, counts = _ten_kernel_counts()
    for module in modules:
        module.reset_launch_counts()
    actions = fn(*args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in counts().items() if v}
    if launched:
        raise AssertionError(f"entry: kernels launched on a path that runs "
                             f"none (the fp32 trunk): {launched}")
    if tuple(actions.shape) != ENTRY_ACTION_SHAPE or not torch.isfinite(
            actions).all():
        raise AssertionError(f"entry: actions {tuple(actions.shape)} "
                             f"{actions}")

    # the same fn on the CPU, the params and inputs copied over
    cpu_args = (*(_to(a, "cpu") for a in args[:5]),
                torch.Generator().manual_seed(0))
    cpu_actions = fn(*cpu_args)
    err = float((actions.cpu() - cpu_actions).abs().max())
    if not err <= ENTRY_ACTION_TOL:
        raise AssertionError(f"entry: the card's actions {err} off the "
                             f"CPU's (bound {ENTRY_ACTION_TOL})")
    del cpu_args, cpu_actions

    def timed(call):
        """ms of each of ENTRY_CALLS calls (CUDA events), after one."""
        call()
        out = []
        for _ in range(ENTRY_CALLS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return out

    tasks, initial_state, images, rng = args[1], args[2], args[3], args[5]
    base_params = fn.generate(params, tasks, initial_state)
    calls = {
        "fn": lambda: fn(*args),
        "hypernet half": lambda: fn.generate(params, tasks, initial_state),
        "base-net half": lambda: fn.act(base_params, tasks, images, rng),
    }
    report = []
    for name, call in calls.items():
        ms = statistics.median(timed(call))
        busy, kernels = device_busy(call)
        report.append(f"{name} {ms:.4f} ms (median of {ENTRY_CALLS}, CUDA "
                      f"events), device busy {busy:.4f} ms in {kernels:.0f} "
                      f"kernels, idle share {1 - busy / ms:.3f}")
    log(f"entry: entry() built the flagship (fp32 trunk, "
        f"{sum(v.numel() for v in params.values())} params, the shared "
        f"DINOv2 among them) on the card in {build_s:.2f} s; fn's "
        f"{ENTRY_ACTION_SHAPE} actions within {err:.3g} of the CPU's (bound "
        f"{ENTRY_ACTION_TOL}, fp32, TF32 off), no kernel of the port "
        "launched; " + "; ".join(report) + f"; card {card}")
    del fn, args, params, base_params, calls
    torch.cuda.empty_cache()
    log(f"entry phase s {time.perf_counter() - t_phase:.3f}")


def seeded_pretrained_dir(root: str) -> None:
    """Writes the frozen encoders' seeded inits under root as the files
    the port loads from $HYPERVLA_PRETRAINED_DIR (models/encoders/
    pretrained.py): t5-base.pt, the T5 that build_frozen_encoders and the
    text encoder draw from seed 0 without it, and dinov2-base.pt, the
    frozen DINOv2 that build_frozen_encoders draws from seed 1. The values
    are those draws: every phase builds the encoders it built before, from
    a file instead of ~40 draws of 86-110 M values (the trunc-normal draw
    of DINOv2-base alone is seconds on the host)."""
    from hypervla_tpu_torch.configs import dinov2_config
    from hypervla_tpu_torch.models.encoders.dinov2 import dinov2_specs
    from hypervla_tpu_torch.models.encoders.t5 import t5_config, t5_specs
    from hypervla_tpu_torch.models.layers import init_params

    import torch

    torch.save(init_params(t5_specs(t5_config("t5-base")), 0),
               os.path.join(root, "t5-base.pt"))
    dino = init_params(dinov2_specs(dinov2_config("dinov2-base"), "dino"), 1)
    torch.save({k[len("dino/"):]: v for k, v in dino.items()},
               os.path.join(root, "dinov2-base.pt"))


def main() -> int:
    if os.environ.get("PYTHONHASHSEED") != HASH_SEED:
        # the eval phase's child server must tokenize as this process does
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  dict(os.environ, PYTHONHASHSEED=HASH_SEED))
    # no tokenizer files are in the checkout: the tokenizers fall back
    # without asking the network
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    # fp32 matmuls in full fp32 on the card (the plain versions' reference)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    device = torch.device("cuda", 0)

    from hypervla_tpu_torch.utils import cuda_build

    pretrained = None
    if not os.environ.get("HYPERVLA_PRETRAINED_DIR"):
        import atexit
        import shutil
        import tempfile

        pretrained = tempfile.mkdtemp(prefix="hypervla_seeded_")
        atexit.register(shutil.rmtree, pretrained, True)
    # one nvcc per source, all started together, so the build time stays
    # that of the slowest source as sources are added; the seeded encoders
    # are written beside them. LATE_SOURCE, the slowest, is waited for only
    # before the first phase that launches its kernels: its build overlaps
    # the phases before (cuda_build.build makes a phase that loads it
    # earlier wait for the same build)
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(max_workers=len(SOURCES) + 1)
    seeded = (pool.submit(seeded_pretrained_dir, pretrained)
              if pretrained else None)
    builds = {src: pool.submit(cuda_build.build, src) for src in SOURCES}
    for src in SOURCES:
        if src != LATE_SOURCE:
            builds[src].result()
    if seeded is not None:
        seeded.result()
        os.environ["HYPERVLA_PRETRAINED_DIR"] = pretrained
    log(f"build: {', '.join(s for s in SOURCES if s != LATE_SOURCE)} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc each, in parallel, "
        f"{LATE_SOURCE} too; beside them the seeded T5-base and "
        "DINOv2-base of every phase's frozen encoders, written to "
        "HYPERVLA_PRETRAINED_DIR)")

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"phase {name} s {time.perf_counter() - t0:.1f}")
        return out

    results = phase("kernel", kernel_phase, device)
    phase("redesign", redesign_phase, device)
    launches, flagship = phase("slice", slice_phase, device)
    phase("server", server_phase, device, flagship)
    del flagship
    t_late = time.perf_counter()
    builds[LATE_SOURCE].result()
    pool.shutdown()
    log(f"build: {LATE_SOURCE} waited for {time.perf_counter() - t_late:.2f} "
        f"s after the server phase ({time.perf_counter() - t0:.1f} s after "
        "the builds started)")
    row_results, add_ln_launches = phase(
        "row_flash_kernel", row_flash_kernel_phase, device)
    train_results = phase("train_kernel", train_kernel_phase, device)
    phase("column_pass", column_pass_phase, device)
    train_launches, hand_fed = phase("train", train_phase, device)
    fp32_launches = phase("flash_fp32", flash_fp32_phase, device)
    trainer_launches, trainer_losses = phase(
        "trainer", trainer_phase, device, card, hand_fed)
    phase("smallstem", smallstem_phase, device, card)
    phase("regularised", regularised_phase, device, card)
    phase("heads", heads_phase, device, card)
    phase("eval", eval_phase, device, card)
    phase("multi_device", multi_device_phase, device, card, trainer_losses)
    octo_cpu_step = phase("octo", octo_phase, device, card)
    phase("encoders", encoders_phase, device, card)
    phase("octo_cpu_step", octo_cpu_step)
    phase("entry", entry_phase, device, card)

    # the configuration whose steps launch each training kernel
    path_of = dict.fromkeys(TRAIN_KERNELS, "layer_kernel")
    path_of.update(mha_fused_train_fwd="fast_preset",
                   mha_fused_train_bwd="fast_preset",
                   dino_layer_train_fwd="fast_preset")
    kernels = [
        {"name": name, "route": "cuda", "source": TRUNK_SOURCE,
         "replaces": TPU_KERNEL, "launches": launches[name], **r}
        for name, r in results.items()
    ] + [
        {"name": name, "route": "cuda", "source": TRAIN_KERNELS[name][0],
         "replaces": TRAIN_KERNELS[name][1],
         "launches": trainer_launches.get(
             name, train_launches[path_of[name]][name]), **r}
        for name, r in train_results.items()
    ]
    # the kernels of the per-layer serving step and of the fused-add-LN train
    # step; fused_add_ln (no LayerScale) lies on no model path of either
    # package, so its launches are those of its own function, driven and
    # counted in the row kernel phase; flash_attention_b64 is the serving
    # kernel at another shape (logged)
    row_launches = {**train_launches["fused_add_ln"], **add_ln_launches,
                    **launches}
    row_launches.update(
        (name, train_launches["flash_trainable"][name])
        for name in ("mha_flash_trainable_fwd", "mha_flash_trainable_bwd"))
    row_launches.update((name + "_fp32", fp32_launches[name])
                        for name in fp32_launches)
    for name, (source, replaces) in ROW_FLASH_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": row_launches[name],
                        **row_results[name]})
    for kernel in kernels:
        if kernel["launches"] == 0:
            raise AssertionError(f"{kernel['name']} was not launched on its "
                                 "main path")
    log("kernels ms/device_ms/plain_ms/library_ms/bound_ms: per flagship "
        "layer for "
        "the serving kernels (2 LayerNorms, 4 GEMMs, 1 attention), per "
        "12-layer trunk for dino_layers_serving, per launch at B=64 for the "
        "training kernels, where dino_gemm_train and layer_gemm_tn add up "
        "one layer's launches (8 and 4 shapes); launches: over the serving "
        "steps for the first four, over the trainer's run A (the command "
        "line's 6 steps, fast preset) for "
        "mha_fused_train_* and dino_layer_train_fwd (mha_fused_train_fwd "
        "counts the trunk's attention forward; a layer call also launches "
        "the attention kernels, counted under the layer), over the "
        "layer-kernel trunk's train steps for the other training kernels; "
        "flash_attention and layer_norm per launch at the serving shapes, "
        "launches over the per-layer serving steps; fused_add_scale_ln_* "
        "and gelu_exact_fused per launch at B=64, launches over the "
        "fused-add-LN train steps; fused_add_ln_* per launch at B=64, "
        "launches of one counted call of the differentiable function, "
        "forward and backward (it lies on no model path); "
        "mha_flash_trainable_* per launch at B=64 in bf16, launches over "
        "the flash-trainable train steps, *_fp32 the same in fp32 (bound at "
        "989/6 TFLOP/s), launches over the fp32 --flash steps, library_ms "
        "scaled_dot_product_attention's forward, or its backward alone")
    log(f"chip_smoke total s {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
