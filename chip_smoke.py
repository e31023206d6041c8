#!/usr/bin/env python3
"""Drive the videoglamm_torch port once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases all|kernels,experiments,serve,predictors,sam1,train,cli,parity,f32,f32q,towers,parallel]

Run from the root of a checkout. `--phases` (default all, as the contract
runs it) picks phases 3 (kernels), the experiment harnesses, 4-5 (serve and
check), 6 (predictors), 7 (sam1), 8-10 (train), 11 (cli), 12 (parity), 13
(f32), 14 (f32q), 15 (towers) and 16 (parallel) to run; the build always
runs.
Phases, each fatal on failure:

1. device: needs CUDA; prints the card's name and power limit
   (nvidia-smi) and turns TF32 off for matmuls and cuDNN;
2. build: compiles the ten CUDA sources of videoglamm_torch/csrc (K1
   attention_fwd with its f32 staging pass, K2 gemm_epilogue, K4
   decode_attention_q8, K5 dequant_gemv, K6 flash_bwd, K7
   window_attention, K8 smallwin_attention, K9 decode_fused, and the
   full-precision f32 routes: attention_f32 for K1 and K6 and gemm_f32
   for K2, 3xTF32 on wgmma; K1, K2, K6, K7, attention_f32
   and gemm_f32 over csrc/sm90_common.cuh, the Hopper helpers, K1 and K7 also
   over csrc/attn_sm90.cuh) from the checkout with one nvcc process each,
   all started together, and JIT-compiles K3 (the Triton row norm),
   printing build seconds, the -Xptxas -v lines (registers and spills of
   every instantiation) and a line of K1's and K7's registers by padded
   head dim;
3. kernels: holds every kernel against its plain PyTorch twin on the same
   inputs at the main path's shapes, with the stated tolerance, and times
   the kernel, the twin and, where one PyTorch call computes the same
   function, that library call (a yardstick only; the port never calls it).
   Each timing is the median of 7 CUDA-event pairs after 2 warm-up calls;
   a pair spans a batch of launches sized to last at least 1 ms (8 ms for
   K6 and the calls timed beside it, whose single call of 1 to 2 ms would
   otherwise carry the host's enqueue of that call). K4 and K5
   rotate over operands larger than the L2 cache, as the decode loop finds
   them: K4 at Phi-3 over 32 layers of [1,3456,3072] (698 MB) and at
   Llama-3.1-8B's GQA over 32 layers of [1,3456,1024] (231 MB), then the
   host's microseconds an eager K4 call. K5 (int8 and int4) at the five decode products of Phi-3 with one
   row (and the sum of the five), and at qkv and gate_up with 4 rows (the
   speculative verify forward) and 8, held by max-norm and relative L2,
   beside torch's weight-only int8 / int4 products where this torch build
   has CUDA kernels for them. Beside each time stands the bound: the larger of bytes moved over
   3.35 TB/s and operations over the peak rate of their type. K6 (the
   flash-attention backward) is held against its twin at the training shape
   [2,32,3456,96] causal and non-causal and at the three small cases of
   the JAX package's own test, dq, dk and dv each by relative L2, with its
   TFLOP/s, the first (mma.sync) K6's recorded time beside this run's, and
   its three device kernels (the delta prepass, dq, dk/dv) timed apart
   under the profiler; K1's LSE
   output against the log-sum-exp of the twin's logits. K7 at the memory
   self-attention of the 32x32 grid [4,1,1024,256] f32 and at the two tower
   shapes its dispatch branch names, K8 at Hiera's stage-1 and stage-2
   windows over 8 frames and at an odd window count, K1 at head dim 256
   ([4,1,4096,256], f32 and bf16). K9's four fused decode-layer entries at
   the Phi-3 widths for 1, 4 and 8 rows and at a narrow case whose N and I
   are no multiples of 1024, each beside the unfused serving chain's time
   and their ratio; the W8A8 entry's s32 sums must EQUAL integer products
   of its own codes; 9 rows must take the unfused chain (K3, K5) and agree
   with its twin.
   K1 and K7 at the memory self-attention's shapes are timed as CUDA-graph
   replays (a call of an f32 route is two launches, the staging pass and
   the body, of some 0.03 to 0.15 ms, below the host's enqueue of them),
   and their staging pass and body apart under the profiler; the staging
   pass alone at the tracker's [4,1,4096,256] x 3 must equal
   `Tensor.to(bfloat16)`.
   `flash_attention_bshd` (K1 on BSHD views) at [1,3456,32,96] over 3520
   keys against its twin and against K1 on the contiguous copy. K1's
   window mode at all four Hiera stages' windows, K2 at the four products
   of Hiera stages 1 and 3 (F.linear with the bias as the library time),
   the fused block at all four stages. K1 counts its launches by route as
   well as by mode ("wgmma" for bf16 operands, "wgmma_f32" for f32 storage
   through the staging pass): every serving path must launch K1 on the
   "wgmma" route only, except the tracker's f32 memory self-attention,
   whose 60 launches a request take "wgmma_f32" and the staging pass;
   then the two experiment harnesses (the decode-layer A/B over 32 layers of
   stacked weights, eager and as CUDA-graph replays, and the BSHD attention
   harness), with the counters set to 0 just before and read just after;
4. serve: builds the flagship VideoGLaMM (seeded random weights, normal
   std 0.02, norm scales 1) on the card through `build_inference` and
   serves, with every launch counter set to 0 just before each path and
   read just after it:
   a. the bf16 path on preprocessed streams (1 warm-up + 1 timed request);
      then its state_dict goes through `io/reference.to_reference_layout`
      and `from_reference_layout` in memory, a second model is built from
      it, and one request on each must give equal tokens and bit-equal
      masks,
   b. the main path, the int8 LLM with the int8 KV cache from RAW uint8
      [1,16,480,854,3] frames (3 requests), then its decode step timed and
      profiled alone, with K4's and K5's shares of the device time (one K4
      device kernel a K4 call, or the run fails); then one batch-4 request
      (four seeded clips [4,16,480,854,3], prompts of 64, 40, 52 and 28
      tokens: the launches of one request, K4 and K5 at 4 rows), each row
      held to its clip served alone, teacher-forced over the row's own
      served tokens (16 logits, relative L2 within 0.1; token agreement
      printed), and the batch teacher-forced with the served cache length
      giving every served token,
   c. the video branch on the main path's model: 2 requests from raw
      frames with `use_video_branch=True`, all 16 frames to SAM, the 4
      [SEG] slots tracked through them by the SAM-2 memory tracker (K1 at
      head dim 256 on f32 storage: 4 layers x 15 frames a request, each
      after a staging launch), then the tracker alone under the profiler,
   d. the int4 LLM with the int8 KV cache from raw frames (1 warm-up + 1
      timed request),
   e. the tracker at SAM image size 512 (a 32x32 memory grid, so that the
      memory self-attention takes K7 after a staging launch), full width,
      bf16 LLM, 2 requests, then that tracker alone under the profiler,
   f. speculative serving on the main path's model (`draft_k=4`, 2 requests
      from raw frames: the K-row verify forwards take K5 at 4 rows and the
      plain attention, the epilogue step K4), the 4-row verify forward held
      against 4 single-row cached steps fed the same tokens and timed beside
      a plain step,
   g. sampled serving on the same model (temperature 0.7, a seeded
      generator: the same seed must give the same tokens twice),
   h. the Llama-3.1-8B base at full width and depth (bf16 weights, int8 KV
      cache, 2 requests from raw frames): K4's GQA branch (G = 4, head dim
      128) launches 32 x 64 times a request, K1 causal 32 times;
   each request is 16 frames, 8 SAM frames (16 when tracking), 64 prompt
   ids and 64 new tokens; a kernel of a path that was never launched, or
   launched another number of times than the path must, fails the run.
   Then the Hiera trunk of the 1024 model on 8 frames with
   `hoist_layout=False` against the hoisted encoder of the same weights:
   10 K8 launches and 32 super-window launches of K1 a forward, outputs
   equal within the stated bf16 tolerance;
5. check: the served outputs are finite and of the expected shapes; the
   cached decode (bf16 cache: plain attention; int8 cache and weights: K4
   and K5) agrees with one uncached forward (K1 causal) over the same
   teacher-forced token stream; and a narrow model whose shapes still take
   every kernel (real image sizes and sequence lengths, a few layers)
   agrees on the card in bf16 with the same weights run on the CPU in f32
   through the plain twins, which the CPU tests hold to the JAX package:
   float, then int8 and int4 LLMs with the int8 cache on the same codes
   (single-row steps and one 4-row cached forward; on the CPU the
   speculative and the plain greedy tokens must be equal);
   and a narrow tracker (narrow Hiera, full-width memory modules, 4 frames,
   2 objects, at 1024 and at 512) on the card against the CPU twins in
   f32, step by step on the reference's memory bank: all mask candidates,
   IoUs, object scores and the encoded memories;
6. predictors: SAM-2 alone at flagship width (`SAM2Config()`, Hiera-L at
   1024, seeded random weights) through `build_sam2`, its three surfaces
   with the counters set to 0 just before each path and read just after:
   the image predictor (`set_image` on a raw 480x854 uint8 frame, points
   with three masks, a box, a refinement fed the low-res logits back,
   `set_image_batch` of 4 and `predict_batch`, hole and sprinkle filling
   on, so that connected components run on the card); the automatic mask
   generator on a 1024x1024 uint8 image (32x32 grid, 64 points a batch, at
   the JAX defaults and with both thresholds at 0, then an 8x8 grid over
   one crop layer with m2m and small-region filling); the interactive
   predictor over 16 raw frames and 2 objects (points on frame 0, a box on
   8, a mask on 15, propagation forward from 0 and back from 15, with
   clear_non_cond_mem_around_input, then `to_video_res` with non-overlapping
   masks). Each image-encoder forward must launch K1 flash 3, K1 window 42,
   K2 168 and K3 85 times, whatever its batch; each propagated frame K1 at
   head dim 256 and its staging pass 4 times. Prints the stage times, the
   device-busy share of one AMG pass and of one propagation, then holds a
   narrow SAM-2 in bf16 on the card to its f32 CPU twin on each surface;
7. sam1: SAM-1 ViT-H with the ITM tracker (`SAM1Config.vit_h()`,
   `with_itm=True`, seeded random weights, bf16 encoder, f32 decoder)
   through `build_sam1`, the counters set to 0 just before each path and
   read just after: the image predictor on a raw 480x854 uint8 frame (2
   points with 3 masks, a box, the box with the low-res mask fed back), the
   automatic mask generator at the JAX defaults (32x32 grid, 64 points a
   batch) on that frame, and `track_frames` over 8 frames with 4
   text-embed objects. K3 is the path's only kernel: 66 launches an encode
   and, per decode, what `sam1_decode_k3` derives from `layer_norm`'s
   dispatch rule; nothing else may launch. Prints each path's ms, peak
   memory and K3 launches, the encode's FLOP bound and its multiple, and
   the device-busy share of an encode, an AMG pass and `track_frames`. Then
   a narrow SAM-1 (the real image size, a 256-wide 4-block encoder, the
   full decoder) in bf16 on the card against its f32 CPU twin: embedding,
   predictions, the AMG's candidates, scores and records, `track_frames`;
8. train: builds the flagship model for training through `build_training`
   (LoRA rank 8 on q and v, remat, f32 masters of the trainable weights,
   seeded random weights with a non-zero LoRA B) and takes four optimizer
   steps of two micro-steps each on a synthetic batch from the seed (2
   videos, 2 rows, 16 frames, 4 SAM frames at 1024 x 1024, 129 text tokens,
   so the LLM sees [2,3456,3072]), with the counters set to 0 just before
   and read just after. It fails unless every loss component is finite, the
   last loss is below the first, every frozen parameter is bit-equal to its
   start and a trainable one moved, K1 causal ran 2 x 32 and K6 32 times a
   micro-step, and a checkpoint saved and restored repeats the next step's
   loss. Prints per step the wall seconds, LLM positions/s, the forward /
   backward / optimizer split and the peak memory;
9. train check: a narrow model at the real sequence length (so K1 and K6
   are taken) in bf16 on the card against the same weights in f32 on the
   CPU through the plain twins: the loss and the gradient of every
   trainable leaf, by relative L2;
10. train CLI: `videoglamm_torch.cli.train.main` from dataset files written
   from the seed at 480x854 (a GCG train.json over frame directories with
   RLE masks, a MeViS-layout root, ReasonSeg train / val images with
   polygons, a VQA file), a word-level stand-in tokenizer with [SEG] at the
   config's id and the seeded weights handed over by patching the CLI's
   `load_tokenizer` and `load_model`: 3 optimizer steps of 2 micro-steps of
   2 one-row samples at 129 ids (the LLM sees [2,3456,3072], as in 8), the
   epoch checkpoint and both validators (2 samples each). It fails on a
   non-finite loss, a mask BCE of 0, launch counts a step other than 8's,
   a missing checkpoint or validator scalar, a fixture row that does not
   fit 129 ids with its [SEG] tokens, or a first device batch that is not
   bit-equal, copied back, to the host batch the prefetch thread pinned
   and copied. Prints the host seconds of a sample and of a collation,
   every step's wall seconds beside 8's and its share spent waiting on
   `next(batches)`, the checkpoint's and the validators' seconds;
11. cli: the serving CLIs' `main` at flagship width from fixture files
   written from the seed at 480x854 (an image; a GCG root of 2 videos x 16
   frames with gt.json and gt_masks; a MeViS-layout root of one 64-frame
   video with 2 expressions and its DAVIS-layout ground truth; 2 sentence
   records, A2D where h5py is installed, else JHMDB; a grounding question
   and an ActivityNet-Entities phrase over frame directories), with only
   `load_model` (the seeded bf16 state dict, made once on the card) and
   `load_tokenizer` (the word-level stand-in, with a decode) patched, all
   with --max_new_tokens 64: chat with --quant int8 --kv_cache int8
   --use_sam2_video_branch on the image, eval_gcg_infer with --quant int8
   --kv_cache int8 then eval_gcg_metrics over its output, eval_refer_infer
   on the MeViS root at its defaults (bf16, 64 SAM frames, framewise) then
   eval_referdavis_metrics, eval_refer_infer on the sentence records,
   eval_grounding and eval_anet_entities_infer. Each serving CLI runs with
   the counters set to 0 just before and read just after, and fails on a
   skipped sample, a missing output file, a summary that is not finite, or
   launches other than the serve phase's per-request formula (the video
   branch's at 16 frames for chat) times its requests. Then the 64-frame
   SAM-2 encode alone (ms, peak memory, its Hiera launches), the masks of
   4 forced [SEG] prompts over those frames resized to 480x854 on the card
   against the CPU f32 twin (equal but within 1e-4 of the threshold), and
   convert_checkpoint over the seeded weights written in the reference
   layout, read back bit-equal through `load_model`. Prints each CLI's
   wall seconds and seconds a sample. Then eval_gcg_infer once more on a
   narrow model (`small_config()`), its generation stubbed to a token
   stream holding two [SEG] (teacher-forced through the model's own
   prefill and cached decode, so the [SEG] hidden states are real), on the
   card in bf16 and on the CPU in f32: equal results JSON, the same PNGs
   but at pixels within the largest logit difference of the threshold;
12. parity: `verify_parity.main` on the card at flagship width, the
   import and quant stages with --int4 --tokens_advisory, on the cli
   phase's reference-layout checkpoint (or one written here from the
   seeded weights), inside `utils.profiling.profile_trace`: exit code 0,
   nothing unmatched or filled, each of the three `clip_run`s (float,
   int8 with the int8 cache, int4) launching what `parity_expected` says,
   the trace holding the runs' annotations and K1-K5. Prints token
   agreement, mask IoU, each run's valid [SEG], seconds and peak memory.
   Then `Sam2BoxSegmenter` on Hiera-L at 1024 (ms a frame, launches) and
   `extract_anet_gcg_masks` over 2 seeded videos; a narrow segmenter and a
   narrow `clip_run` on the card against their CPU f32 twins; the
   StepTimer summary and `device_memory_report()`;
13. f32: each full-precision f32 route against its f32 twin (TF32 off),
   relative L2 and max-norm ratio within 1e-5, timed beside its bound, the
   twin and SDPA / F.linear in f32: K1 "simt_f32" at the Phi-3 prefill
   [1,32,3391,96], the training forward with LSE [2,32,3456,96] (LSE held
   too), the Hiera globals [8,8,4096,72], the memory self-attention
   [4,1,4096,256], CLIP [16,577,16,64] and InternVideo2 [4,1025,16,88] in
   BSHD mode and the window mode at Hiera-L's four stages over 8 frames;
   K2's f32 route at the 16 products of those stages (with the plan each
   took, `k2_f32_plan`); K6's f32 route at
   [2,32,3456,96] causal and [8,8,4096,72]. Then the flagship in f32
   through `build_inference(dtype=torch.float32)`: 2 framewise requests
   and 1 on the video branch from raw frames, run under torch's default
   TF32 flags: every convolution must see TF32 off and the defaults must
   come back; launches by the bf16 formulas on the f32 routes, no staging
   launch; finite masks. Then 3 optimizer steps of 2 micro-steps of the
   f32 flagship through `build_training(dtype=torch.float32)` (finite,
   falling loss; frozen leaves bit-equal; K6 f32 32 times a micro-step;
   peak memory) and one more step under the profiler (wall, busy share,
   the top device operations), and a narrow f32 model on the card against its CPU f32
   twin within relative L2 1e-4: teacher-forced logits, mask logits, one
   training micro-step's loss and every trainable gradient;
14. f32q: the f32 routes of K4 (`vgt_decode_attention_q8_f32`), K5 (the
   `_f32` entries of dequant_gemv), K7 and K8 (K1's full-precision body
   from their wrappers) against their f32 twins with TF32 off, relative L2
   and max-norm ratio within 2e-6, each timed beside its bound, its twin
   and, for K7 and K8, SDPA in f32: K4 at Phi-3 over 32 stacked layers and
   at Llama-3.1-8B's GQA (two calls bit-equal), K5 int8 and int4 at the
   five Phi-3 decode products for 1, 2, 3, 4, 8 and 64 rows (the CUDA
   cores below the crossover, 2 rows for gate_up and lm_head, 4 for qkv,
   5 for o_proj and down_proj, the
   tensor cores from it over x's three bf16 planes,
   bound: bytes, or three bf16 products at 989 TFLOP/s; beside it the
   other route forced through its plan past one row: the earlier design
   and the crossover), K7 at [4,1,1024,256], K8 at the unhoisted Hiera-L's three
   small-window shapes.
   Then the f32 flagship with int8 weights and the int8 cache (1 framewise
   request; its Hiera-L unhoisted against hoisted in f32; a batch-4
   request as in 4b, its rows held to their clips alone within 1e-4, at
   most 1e-5 of their int8 cache codes one step apart), with int4
   weights (1 request) and at SAM image size 512 on the video branch (1
   request), each by the bf16 formula on the f32 routes (K4, K5 and K7
   never on their bf16 counters, nothing staged); a narrow f32 model with
   int8 weights and cache on the card against its CPU f32 twin through
   prefill and cached decode (logits, [SEG] hidden states, masks; the two
   caches compared code by code); and `verify_parity --dtype f32 --stages
   import,quant --int4 --tokens_advisory` at flagship scale (launches by
   `parity_expected` on the f32 routes) and at tiny scale, both exit 0;
15. towers: `freeze_towers=False` on a narrow model with Hiera-L's widths
   (head dim 72) whose projectors, an InternVideo2 block, a CLIP layer, a
   Hiera global block and a Hiera window block train: their gradients on
   the card in bf16 and in f32 against the CPU f32 twin (K1 BSHD with its
   recompute, the fused block's recompute, K6 at head dim 72, K3's
   recompute); then one forward and backward through the towers of the
   bf16 flagship (1 video, 1 row; InternVideo2 block 0, CLIP layer 0,
   Hiera blocks 0 and 23 and the projectors train), its seconds and peak
   memory;
16. parallel: the sharded train step over `torch.distributed`. (a) A
   process group of one rank over NCCL: the bf16 flagship built once takes
   3 optimizer steps of 2 micro-steps through `make_train_step`, then,
   from the same start, 3 through `make_sharded_train_step` on the mesh
   (1, 1): metrics, trainable parameters and moments bit-equal, frozen
   leaves untouched, the same launches (both runs under
   `torch.use_deterministic_algorithms`: the step's index backwards
   accumulate with atomics otherwise), the two step times, peak memory,
   no collective issued. (b) Two processes on the one card over gloo
   (which takes CUDA tensors: probed first) on the narrow model at meshes
   (2, 1) and (1, 2), 2 steps each in f32 and bf16, against the
   one-process step on the card: losses within 1e-5 relative in f32 and
   TOL_TRAIN_LOSS in bf16, the AdamW moments gathered through the
   checkpoint within 1e-4 (f32) and TOL_TRAIN_GRAD_ALL (bf16) relative
   L2; collectives a step and step times. (c) One bf16 flagship request
   before and after `shard_params` on the mesh (1, 1): the same tokens,
   bit-equal masks, the same launches.

Prints one {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Exits nonzero, printing no result, without
a card or outside the repository.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback

TOL_BF16_ATTN = 2e-2    # max|d| / max(1, max|ref|): a few bf16 ulps (2^-8)
TOL_BF16_GEMM = 2e-2    # K2 and the fused block: same rounding points,
                        # other summation order -> 1-2 bf16 ulps
TOL_BF16_NORM = 1e-2    # one bf16 rounding of O(1) outputs
TOL_F32_NORM = 1e-5     # f32 statistics, other reduction order
TOL_DECODE_Q8 = 2e-2    # K4: p * v_scale is rounded to bf16 relative to the
                        # running maximum, the twin rounds the normalised
                        # probability -> a few bf16 ulps of the output
TOL_GEMV = 1e-2         # K5: one bf16 rounding of an f32 sum taken in
                        # another order than the twin's -> at most one ulp
TOL_GEMV_L2 = 4e-3      # K5, relative L2: both sides round one f32 sum to
                        # bf16 once, so entries differ where that rounding
                        # flips, by one ulp (2^-8 relative); about 1e-3 over
                        # all entries. A dropped 16-byte chunk or a wrong
                        # group scale moves it by far more
TOL_FUSED_MLP = 2e-2    # K9 mlp: g, u and h are rounded to bf16 where the twin
                        # rounds them, after f32 sums in another order; a
                        # flipped rounding moves one of 8192 terms by 2^-8
TOL_SPEC_VERIFY = 5e-2  # relative L2, the 4-row verify forward (plain
                        # attention over the dequantised int8 cache, K5 at 4
                        # rows) against 4 single-row steps (K4 folding the
                        # scales, K5 at 1 row) through 32 layers of bf16
TOL_LLM_TF = 5e-2       # relative L2, cached bf16 decode vs uncached
                        # forward after 32 layers of bf16 rounding
TOL_LLM_TF_Q = 1e-1     # the same with int8 weights and the int8 cache: the
                        # uncached forward quantises its activations per
                        # row (W8A8, M >= 256) where the cached decode
                        # (M = 1) does not, and the cache rounds K/V to
                        # amax/127; the tiny f32 control of
                        # tests/test_torch_slice_quant.py holds the two
                        # paths' arithmetic to the JAX package
TOL_SMALL_REF = 5e-2    # relative L2, bf16 kernels on the card vs f32 plain
                        # twins on the CPU, through a few layers each

TOL_FLASH_BWD = 1e-2    # K6, relative L2 of dq, dk, dv each: kernel and twin
                        # round p and ds to bf16 at the same place and sum
                        # in f32 in another order; entries differ by one
                        # bf16 ulp (2^-8) where a rounding flips
# K6's first version (mma.sync, synchronous staging) at the training shape
# [2,32,3456,96], kv_lens (3456, 3300): its reading on an NVIDIA H100 80GB
# HBM3, 700.00 W (PERF.md section 6), printed beside this run's time
K6_MMA_SYNC_MS = {True: 6.6156, False: 11.6856}
K6_BATCH_MS = 8.0       # K6 and its yardsticks are timed over batches this long
TOL_LSE = 1e-3          # K1's LSE, max|d|: f32 sums of the same bf16
                        # products, exp2/log2 against exp/log
TOL_TRAIN_LOSS = 2e-2   # narrow model, bf16 card vs f32 CPU, relative
TOL_TRAIN_GRAD = 1.5e-1  # the same, per-leaf relative L2 of the gradients:
                        # a bf16 backward through two layers and the CE over
                        # 32065 logits rounds every activation gradient to
                        # 2^-8 (LoRA leaves: 3e-2); text_hidden_fcs sees
                        # only the few [SEG] hidden states, so their bf16
                        # rounding, and the ReLU gates that flip on it, are
                        # not averaged over positions (9e-2 at width 128)
TOL_TRAIN_GRAD_ALL = 5e-2   # all trainable leaves together, relative L2

TOL_F32_ATTN = 2e-2     # K1 and K7 on f32 operands against the f32 twin:
                        # q, k, v and p are rounded to bf16 on the way in, so
                        # the error is bf16-class, a few 2^-9 of the output
TOL_ATTN_L2 = 1e-2      # relative L2 of every attention kernel's output. An
                        # output over S keys of unit variance is far below 1
                        # (deviation about sqrt(e / S): 0.026 at 4096 keys),
                        # so the floor of 1 under the max-norm ratio above
                        # holds it to nothing; the relative L2 does. A
                        # dropped 32-key tile, a softmax scale off by a tenth
                        # or a last tile left unmasked each move it by 2e-2
                        # and more. K1 and K4 round exp(s - m) to bf16 before
                        # the row sum is known and K1 / K7 round f32 operands
                        # to bf16, where the twin rounds the normalised
                        # probability or nothing: 3e-3 measured
TOL_ATTN_L2_EXACT = 5e-4  # K7 on bf16 operands and K8 round where the twin
                        # rounds; what is left is a bf16 ulp of an output
                        # where the summation order flips a rounding: 4e-5
                        # to 1.3e-4 measured
TOL_HOIST = 5e-2        # relative L2, unhoisted Hiera (K8, super-windows,
                        # plain norms and linears) against the hoisted one
                        # (fused blocks): other bf16 rounding points over 48
                        # blocks
TOL_TRACK_REF = 2e-2    # relative L2, narrow tracker, bf16 image encoder and
                        # bf16-rounded attention operands on the card against
                        # the f32 twins on the CPU, step by step on the
                        # reference's bank and running free on its own

N_REQUESTS = 3          # on the main path (int8 + int8 KV, raw frames)
MAX_NEW = 64
S_TEXT = 64
T_SAM = 8
N_TRACK_REQUESTS = 2    # video branch: all 16 frames go to SAM
RAW_H, RAW_W = 480, 854
S_TEXT_TRAIN = 129      # + 3328 visual tokens - 1 placeholder = 3456
T_SAM_TRAIN = 4
GT_HW = 256             # ground-truth masks at SAM image size / 4
TRAIN_STEPS = 4
GRAD_ACCUM = 2

DRAFT_K = 4             # rows of a speculative iteration
N_SPEC_REQUESTS = 2
N_LLAMA_REQUESTS = 2
HARNESS_REPS = 8        # timed passes of each harness variant


HBM_BYTES_S = 3.35e12   # H100 SXM: device memory rate
PEAK_OPS = {"bf16": 989e12,    # dense tensor-core rate
            "int8": 1979e12,   # dense tensor-core rate, s8 x s8 -> s32
            # f32-accurate products: three TF32 products on the tensor cores
            # (495 TFLOP/s dense TF32), the least time the card can take
            # for f32 work at f32 accuracy (the CUDA cores' FFMA: 67)
            "f32": 495e12 / 3}


def log(*a):
    print(*a, flush=True)


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
            else f"nvidia-smi failed: {out.stderr.strip()}"
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi missing ({e})"


def time_ms(fn, reps: int = 7, warmup: int = 2, min_ms: float = 1.0,
            graphed: bool = False) -> float:
    """Median over `reps` event pairs of the time of one call; each pair
    spans a batch of calls sized (from one probe call) to last >= min_ms.

    graphed: the batch (10 to 200 calls) is captured once into a CUDA graph and
    the pairs time its replay. A launch of a few microseconds cannot be
    timed eagerly: Python enqueues one launch in tens of microseconds, so
    an eager batch measures the host. The replay measures the device."""
    import torch

    def pair(run, n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def batch(n):
        for _ in range(n):
            fn()

    for _ in range(warmup):
        fn()
    probe = max(pair(lambda: batch(1), 1), 1e-3)
    if graphed:
        n = int(min(200, max(10, math.ceil(4.0 / probe))))
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            batch(n)
        run = graph.replay
        run()                                    # first replay, untimed
    else:
        n = int(min(200, max(1, math.ceil(min_ms / probe))))
        run = lambda: batch(n)
    return statistics.median(pair(run, n) for _ in range(reps))


def rel_err(got, ref) -> tuple:
    d = (got.float() - ref.float()).abs().max().item()
    return d, d / max(1.0, ref.float().abs().max().item())


def rel_l2(got, ref) -> float:
    """|got - ref| / |ref| over all elements: unlike `rel_err` it has no
    floor of 1 under it, so it also holds outputs far smaller than 1 (an
    attention output over S keys of unit variance has a deviation of about
    sqrt(e / S))."""
    g, r = got.double(), ref.double()
    return ((g - r).norm() / r.norm().clamp_min(1e-30)).item()


class Kernels:
    """Collects the kernel-versus-plain measurements."""

    def __init__(self):
        self.rows = {}

    def compare(self, key, label, kernel_fn, plain_fn, tol, *, nbytes, ops,
                rate="bf16", library_fn=None, timed_fn=None, graphed=False,
                tol_l2=None):
        """tol holds max|d| / max(1, max|ref|); tol_l2, where given, also
        holds the relative L2 error, which is printed for every kernel.
        nbytes: each input read once and each output written once; ops:
        the operations this run's data needs, of type `rate`. timed_fn: the
        launch to time where it differs from the one compared (operands
        rotated past the L2 cache). graphed: time the kernel and the
        library call as CUDA-graph replays (launches of microseconds)."""
        import torch
        got = kernel_fn()
        ref = plain_fn()
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        l2 = rel_l2(got, ref)
        del got, ref
        ms = time_ms(timed_fn or kernel_fn, graphed=graphed)
        plain_ms = time_ms(plain_fn)
        library_ms = time_ms(library_fn, graphed=graphed) \
            if library_fn is not None else None
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS[rate] * 1e3
        bound_ms = max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        ok = rel <= tol and (tol_l2 is None or l2 <= tol_l2)
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        held = "" if tol_l2 is None else f" tol={tol_l2:g}"
        log(f"  {label}: max_abs_err={err:.3e} rel={rel:.3e} tol={tol:g} "
            f"rel_l2={l2:.3e}{held} kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={lib} "
            f"bound={bound_ms:.4f} ms ({bound_by}) {'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"{label}: kernel disagrees with its plain twin")
        if key is not None:
            self.rows[key] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, bound_by=bound_by,
                                  library_ms=library_ms)
        return ms


CUDA_SOURCES = ("attention_fwd", "gemm_epilogue", "decode_attention_q8",
                "dequant_gemv", "flash_bwd", "window_attention",
                "smallwin_attention", "decode_fused", "attention_f32",
                "gemm_f32")


def phase_build():
    import torch
    from videoglamm_torch.ops import _cuda, norms
    t0 = time.perf_counter()
    built = _cuda.load_all(CUDA_SOURCES)
    log(f"  {len(built)} nvcc builds side by side: "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in built.items():
        log(f"  built {name}: {b.seconds:.1f} s -> {b.path.name}")
        spills = 0
        for line in b.ptxas_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line \
                    or "Compiling entry" in line:
                log("   ", line.strip())
            if "bytes spill stores" in line and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                spills += 1
        if spills:
            raise AssertionError(f"{name}: {spills} instantiations spill")
    for name, body in (("attention_fwd", "attn_fwd_sm90"),
                       ("window_attention", "window_attn_sm90")):
        regs = registers_by_depth(built[name].ptxas_log, body)
        log(f"  {name} registers by padded head dim: "
            + ", ".join(f"{d}: {r}" for d, r in sorted(regs.items()))
            + " (at entry; setmaxnreg then gives the consumers 232, the "
            "producer 40)")
        if len(regs) != 6:
            raise AssertionError(f"{name}: {len(regs)} instantiations of {body}")
    t0 = time.perf_counter()
    x = torch.randn(8, 256, device="cuda")
    norms.row_norm(x, torch.ones(256, device="cuda"), None, 1e-6, rms=True)
    torch.cuda.synchronize()
    log(f"  K3 Triton JIT (first shape): {time.perf_counter() - t0:.1f} s")


def registers_by_depth(ptxas_log: str, body: str) -> dict:
    """{padded head dim: registers} of the instantiations of the kernel
    template `body` in nvcc's -Xptxas -v report."""
    import re
    regs, depth = {}, None
    for line in ptxas_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(body + r"ILi(\d+)E", line)
            depth = int(m.group(1)) if m else None
        elif depth is not None and "Used" in line and "registers" in line:
            regs[depth] = int(re.search(r"Used (\d+) registers", line).group(1))
            depth = None
    return regs


def device_split_ms(fn, parts: dict, calls: int = 10) -> dict:
    """Device ms a call of `fn` spends in each kernel whose name contains
    parts[label], from torch.profiler over `calls` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):     # a profiling window that missed one of the parts
        with profile(activities=[ProfilerActivity.CUDA]) as prof:   # is taken again
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            for label, key in parts.items():
                if key in e.key:
                    out[label] = out.get(label, 0.0) + _device_us(e) / 1e3 / calls
        if set(out) == set(parts):
            break
        log(f"    the profiler recorded {sorted(out)} of {sorted(parts)} in this "
            "window; profiling again")
    if set(out) != set(parts):
        raise AssertionError(f"the profiler saw {sorted(out)} of {sorted(parts)}")
    return out


def attn_cost(B, H, Sq, Sk, D, pairs=None, elt=2):
    """(bytes, ops) of attention over `elt`-byte operands: q, k, v read and
    o written once; two products of 2*D operations per attended (query,
    key) pair."""
    pairs = Sq * Sk if pairs is None else pairs
    return elt * B * H * D * (2 * Sq + 2 * Sk), 4 * B * H * D * pairs


def attended_pairs(Sq, Sk, kv_lens, q_start, causal) -> int:
    """(query, key) pairs per head that the mask lets through, from this
    run's kv_lens and q_start."""
    total = 0
    for kvl, qs in zip(kv_lens, q_start):
        kvl = min(kvl, Sk)
        for r in range(Sq):
            total += max(0, min(kvl, qs + r + 1)) if causal else kvl
    return total


def k6_parts_ms(bwd, calls: int = 5) -> dict:
    """Device ms a call of K6's three kernels (delta prepass, dq, dk/dv),
    from torch.profiler over `calls` calls of `bwd`."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    bwd()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            bwd()
        torch.cuda.synchronize()
    parts = {}
    for e in prof.key_averages():
        for part in ("delta", "dq", "dkv"):
            if f"flash_bwd_{part}" in e.key:
                parts[part] = parts.get(part, 0.0) + _device_us(e) / 1e3 / calls
    if set(parts) != {"delta", "dq", "dkv"}:
        raise AssertionError(f"K6: the profiler saw its kernels as {parts}")
    return parts


def phase_flash_bwd(K: Kernels, randn):
    """K6 against `_flash_bwd_plain` and K1's LSE against the twin's, the
    twin run head by head (a whole [2,32,3456,3456] f32 temporary is 3 GB)."""
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.ops import attention as A

    def by_heads(fn, tensors, n_out):
        """Apply fn to one (batch, head) slice at a time and stack."""
        B, H = tensors[0].shape[:2]
        outs = [[] for _ in range(n_out)]
        for b in range(B):
            for h in range(H):
                res = fn(b, *(t[b:b + 1, h:h + 1] for t in tensors))
                for o, r in zip(outs, res):
                    o.append(r)
        return [torch.cat(o, dim=1).reshape(B, H, *o[0].shape[2:]) for o in outs]

    def case(B, H, Sq, Sk, D, kv, qs, causal, key, time_it):
        q, k, v = (randn(B, H, s, D) for s in (Sq, Sk, Sk))
        # a gradient in the layout o.transpose(1, 2).reshape(...) hands back
        g = randn(B, Sq, H, D).transpose(1, 2)
        kvl = torch.tensor(kv, device="cuda", dtype=torch.int32)
        qst = kvl - Sq if qs is None else torch.tensor(
            qs, device="cuda", dtype=torch.int32)
        scale = D ** -0.5
        mode = "causal" if causal else "flash"
        out = torch.empty_like(q)
        lse = torch.empty(B, H, Sq, device="cuda", dtype=torch.float32)

        def fwd():
            A.attention_fwd_kernel(q, k, v, out, causal=causal, sm_scale=scale,
                                   mode=mode, kv_lens=kvl, q_start=qst, lse=lse)
            return lse

        def bwd():
            return A.flash_bwd_kernel(q, k, v, out, lse, g, causal=causal,
                                      sm_scale=scale, kv_lens=kvl, q_start=qst)

        def plain_fwd():
            return by_heads(lambda b, q_, k_, v_: A._flash_fwd_plain(
                q_, k_, v_, kvl[b:b + 1], qst[b:b + 1], causal, scale),
                (q, k, v), 2)

        def plain_bwd():
            return by_heads(lambda b, q_, k_, v_, o_, l_, g_: A._flash_bwd_plain(
                q_, k_, v_, o_, l_[:, :, :, 0], g_, kvl[b:b + 1], qst[b:b + 1],
                causal, scale), (q, k, v, out, lse[..., None], g), 3)

        label = (f"[{B},{H},{Sq},{D}] over Sk={Sk} "
                 f"{'causal' if causal else 'full'} kv_lens={tuple(kv)} "
                 f"q_start={'kv_len-Sq' if qs is None else tuple(qs)}")
        fwd()
        ref_out, ref_lse = plain_fwd()
        torch.cuda.synchronize()
        live = ref_lse > -1e29
        lse_err = (lse[live] - ref_lse[live]).abs().max().item()
        dead_ok = bool((lse[~live] == A.NEG_INF).all())
        out_rel, out_l2 = rel_err(out, ref_out)[1], rel_l2(out, ref_out)
        log(f"  K1 LSE {label}: max|d|={lse_err:.3e} (tol {TOL_LSE:g}), rows "
            f"with no key {int((~live).sum())} {'= -1e30' if dead_ok else 'WRONG'}, "
            f"out rel={out_rel:.3e} rel_l2={out_l2:.3e} (tol {TOL_ATTN_L2:g})")
        if not (lse_err <= TOL_LSE and dead_ok and out_rel <= TOL_BF16_ATTN
                and out_l2 <= TOL_ATTN_L2):
            raise AssertionError(f"K1 LSE {label}: disagrees with the plain twin")
        got = bwd()
        want = plain_bwd()
        torch.cuda.synchronize()
        errs, rels = [], []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise AssertionError(f"K6 {label}: non-finite {name}")
            errs.append((a.float() - b.float()).abs().max().item())
            rels.append(((a.float() - b.float()).norm()
                         / b.float().norm()).item())
        pairs = attended_pairs(Sq, Sk, kv, qst.tolist(), causal)
        # five products of 2*D operations per attended pair; q, k, v, out,
        # dO read and dq, dk, dv written once in bf16, lse read and delta
        # written once in f32
        ops = 5 * 2 * D * pairs * H
        nb = 2 * B * H * D * (5 * Sq + 3 * Sk) + 2 * 4 * B * H * Sq
        t_bytes, t_ops = nb / HBM_BYTES_S * 1e3, ops / PEAK_OPS["bf16"] * 1e3
        bound_ms, bound_by = max(t_bytes, t_ops), \
            "bytes" if t_bytes >= t_ops else "operations"
        ok = max(rels) <= TOL_FLASH_BWD
        line = (f"  K6 {label}: rel L2 dq={rels[0]:.3e} dk={rels[1]:.3e} "
                f"dv={rels[2]:.3e} (tol {TOL_FLASH_BWD:g}) "
                f"max_abs_err={max(errs):.3e}")
        if time_it:
            # batches of >= 8 ms: one call's host work (checks, TMA plan,
            # seven tensor maps) shows in a pair of one call, not of several
            ms = time_ms(bwd, min_ms=K6_BATCH_MS)
            parts = k6_parts_ms(bwd)
            fwd_ms = time_ms(fwd, min_ms=K6_BATCH_MS)
            plain_ms = time_ms(plain_bwd, reps=3, warmup=1)
            plain_fwd_ms = time_ms(plain_fwd, reps=3, warmup=1)
            ql, kl, vl = (t.detach().clone().requires_grad_(True)
                          for t in (q, k, v))

            def lib_fwd():
                with torch.no_grad():
                    return F.scaled_dot_product_attention(ql, kl, vl,
                                                          is_causal=causal)

            def lib_fwd_bwd():
                o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
                return torch.autograd.grad(o, (ql, kl, vl), g)

            lib_f = time_ms(lib_fwd, min_ms=K6_BATCH_MS)
            lib_fb = time_ms(lib_fwd_bwd, min_ms=K6_BATCH_MS)
            library_ms = lib_fb - lib_f
            line += (f" kernel={ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s of the "
                     f"five products; the first, mma.sync K6 read "
                     f"{K6_MMA_SYNC_MS[causal]:.4f} ms, "
                     f"{K6_MMA_SYNC_MS[causal] / ms:.2f}x this) "
                     f"plain={plain_ms:.4f} ms library="
                     f"{library_ms:.4f} ms (forward+backward {lib_fb:.4f} - "
                     f"forward {lib_f:.4f}) bound={bound_ms:.4f} ms ({bound_by}); "
                     f"K1 forward with LSE at this shape {fwd_ms:.4f} ms "
                     f"({4 * D * pairs * H / fwd_ms / 1e9:.1f} TFLOP/s), its "
                     f"plain twin head by head {plain_fwd_ms:.4f} ms")
            if key is not None:
                K.rows[key] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound_ms,
                                   bound_by=bound_by, library_ms=library_ms)
                # K1's forward with the LSE output at the training shape
                f_bytes = 2 * B * H * D * (2 * Sq + 2 * Sk) + 4 * B * H * Sq
                f_ops = 4 * D * pairs * H
                tb, to = f_bytes / HBM_BYTES_S * 1e3, f_ops / PEAK_OPS["bf16"] * 1e3
                K.rows[f"attention_fwd[{mode}]@train_lse"] = dict(
                    max_abs_err=(out.float() - ref_out.float()).abs().max().item(),
                    ms=fwd_ms, plain_ms=plain_fwd_ms, bound_ms=max(tb, to),
                    bound_by="bytes" if tb >= to else "operations",
                    library_ms=lib_f)
        log(line + (" ok" if ok else " MISS"))
        if time_it:
            log(f"  K6 {label}, its three device kernels under the profiler "
                "(ms a call): " + ", ".join(f"{n} {t:.4f}" for n, t in parts.items())
                + f"; {sum(parts.values()):.4f} together")
            log(f"  K6 delta prepass alone: {parts['delta']:.4f} ms (reading out "
                f"and dO once at the memory rate: "
                f"{2 * 2 * B * H * Sq * D / HBM_BYTES_S * 1e3:.4f} ms)")
        if not ok:
            raise AssertionError(f"K6 {label}: disagrees with its plain twin")

    case(2, 32, 3456, 3456, 96, (3456, 3300), (0, 0), True, "flash_bwd", True)
    case(2, 32, 3456, 3456, 96, (3456, 3300), (0, 0), False, None, True)
    # the three cases of the JAX package's backward test (tests/test_ops.py:489)
    case(2, 2, 200, 320, 64, (320, 260), (0, 0), True, None, False)
    case(2, 2, 200, 320, 64, (320, 260), None, True, None, False)
    case(2, 2, 200, 320, 64, (320, 260), None, False, None, False)
    # rows with no valid key (q_start < 0) and a zero-padded head dim
    case(1, 2, 96, 200, 80, (200,), (-40,), True, None, False)


def phase_kernels(K: Kernels):
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.ops import attention as A
    from videoglamm_torch.ops import fused_block as FB
    from videoglamm_torch.ops import norms as N
    from videoglamm_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, dtype=bf, scale=1.0):
        return (torch.randn(*shape, generator=g, device="cuda") * scale).to(dtype)

    # K1 causal: Phi-3 prefill [1,32,3391,96]
    S = 3391
    q, k, v = (randn(1, 32, S, 96) for _ in range(3))
    kvl = torch.tensor([S], device="cuda", dtype=torch.int32)
    qs = torch.zeros(1, device="cuda", dtype=torch.int32)
    nb, ops = attn_cost(1, 32, S, S, 96, pairs=S * (S + 1) // 2)
    K.compare("attention_fwd[causal]", "K1 causal Phi-3 prefill [1,32,3391,96]",
              lambda: A.flash_attention(q, k, v, causal=True, kv_lens=kvl,
                                        q_start=qs),
              lambda: A._attention_plain(q, k, v, causal=True,
                                         sm_scale=96 ** -0.5, kv_lens=kvl,
                                         q_start=qs), TOL_BF16_ATTN,
              nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  q, k, v, is_causal=True))
    # K1 flash: Hiera global block, 8 frames [8,8,4096,72] (BSHD views)
    qkv = randn(8, 4096, 3, 8, 72)
    gq, gk, gv = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    nb, ops = attn_cost(8, 8, 4096, 4096, 72)
    K.compare("attention_fwd[flash]", "K1 Hiera global [8,8,4096,72]",
              lambda: A.flash_attention(gq, gk, gv),
              lambda: A._attention_plain(gq, gk, gv, causal=False,
                                         sm_scale=72 ** -0.5), TOL_BF16_ATTN,
              nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(gq, gk, gv))
    del q, k, v, qkv, gq, gk, gv
    phase_flash_bwd(K, randn)
    # K1 BSHD: CLIP [16,577,16,64]; InternVideo2 fused qkv [4,1025,3,16,88]
    cq, ck, cv = (randn(16, 577, 16, 64) for _ in range(3))
    nb, ops = attn_cost(16, 16, 577, 577, 64)
    K.compare("attention_fwd[bshd]", "K1 CLIP BSHD [16,577,16,64]",
              lambda: A.attention_bshd(cq, ck, cv),
              lambda: A._attention_plain_bshd(cq, ck, cv, 64 ** -0.5),
              TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  cq.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)))
    iv = randn(4, 1025, 3 * 16 * 88)
    iv5 = iv.view(4, 1025, 3, 16, 88)
    nb, ops = attn_cost(4, 16, 1025, 1025, 88)
    K.compare("attention_fwd[bshd]@iv2", "K1 InternVideo2 fused qkv [4,1025,3*16*88]",
              lambda: A.attention_packed_qkv_padded(iv, 16, 88),
              lambda: A._attention_plain_bshd(iv5[:, :, 0], iv5[:, :, 1],
                                              iv5[:, :, 2], 88 ** -0.5
                                              ).reshape(4, 1025, 16 * 88),
              TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  *(iv5[:, :, i].transpose(1, 2) for i in range(3))))
    del cq, ck, cv, iv, iv5

    # K1 window mode as fused_window_block drives it (16/64/256 tokens),
    # windows folded into 128-row query tiles by FB.window_fold
    def window_case(NW, Sw, H, key):
        hd = 72
        fold = FB.window_fold(NW, Sw)
        B_, S_ = NW // fold, Sw * fold
        qkv5 = randn(B_, S_, 3, H, hd)
        out = torch.empty(B_, S_, H, hd, dtype=bf, device="cuda")
        views = [qkv5[:, :, i] for i in range(3)]
        win = Sw if fold > 1 else 0
        # the same windows as a batch, for the library call
        wins = [t.reshape(NW, Sw, H, hd).transpose(1, 2) for t in views]

        def kernel():
            A.attention_fwd_kernel(*(t.transpose(1, 2) for t in views),
                                   out.transpose(1, 2), causal=False,
                                   sm_scale=hd ** -0.5, mode="window", win=win)
            return out

        nb, ops = attn_cost(NW, H, Sw, Sw, hd)
        K.compare(key, f"K1 window S={Sw} NW={NW} H={H} (fold {fold}, win {win})",
                  kernel, lambda: A._attention_plain_bshd(*views, hd ** -0.5, win),
                  TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
                  library_fn=lambda: F.scaled_dot_product_attention(*wins))

    window_case(8192, 64, 2, "attention_fwd[window]")
    window_case(8192, 16, 4, "attention_fwd[window]@stage2")
    window_case(128, 256, 8, "attention_fwd[window]@stage3")
    window_case(128, 64, 16, "attention_fwd[window]@stage4")

    # K7 (whole-row softmax, two passes): the memory self-attention at the
    # 32x32 grid in f32, and the two tower shapes its dispatch branch names.
    # The bound takes the bf16 tensor-core rate for f32 operands too: the
    # least time any kernel that rounds as this one does could take.
    def l2_tol(dtype):
        return TOL_ATTN_L2 if dtype == torch.float32 else TOL_ATTN_L2_EXACT

    # Timed as graph replays: one call of the f32 route is two launches (the
    # staging pass, the body) whose device time is below the host's
    # enqueue of them. The staging pass and the body are timed apart under
    # the profiler.
    def split(fn, body, dtype):
        parts = {"body": body}
        if dtype == torch.float32:
            parts["staging"] = "stage_bf16_kernel"
        ms = device_split_ms(fn, parts)
        log("    under the profiler, ms a call: "
            + ", ".join(f"{n} {t:.4f}" for n, t in ms.items())
            + (f" (staging {ms['staging'] / sum(ms.values()):.0%} of the two)"
               if "staging" in ms else ""))

    def window_attn_case(B, H, S, D, dtype, key, what, tol):
        q, k, v = (randn(B, H, S, D, dtype=dtype) for _ in range(3))
        nb, ops = attn_cost(B, H, S, S, D, elt=q.element_size())
        K.compare(key, f"K7 {what} [{B},{H},{S},{D}] "
                  f"{'f32' if dtype == torch.float32 else 'bf16'}",
                  lambda: A.dot_product_attention(q, k, v),
                  lambda: A._window_attention_plain(q, k, v, D ** -0.5), tol,
                  nbytes=nb, ops=ops, tol_l2=l2_tol(dtype), graphed=True,
                  library_fn=lambda: F.scaled_dot_product_attention(q, k, v))
        split(lambda: A.dot_product_attention(q, k, v), "window_attn_sm90", dtype)

    window_attn_case(4, 1, 1024, 256, torch.float32, "window_attention",
                     "memory self-attention", TOL_F32_ATTN)
    window_attn_case(4, 16, 1025, 88, bf, None, "InternVideo2 shape",
                     TOL_BF16_ATTN)
    window_attn_case(16, 16, 577, 64, bf, None, "CLIP shape", TOL_BF16_ATTN)

    # K1 at head dim 256: the memory self-attention at the 64x64 grid
    def d256_case(dtype, key, tol):
        q, k, v = (randn(4, 1, 4096, 256, dtype=dtype) for _ in range(3))
        nb, ops = attn_cost(4, 1, 4096, 4096, 256, elt=q.element_size())
        K.compare(key, "K1 memory self-attention [4,1,4096,256] "
                  f"{'f32' if dtype == torch.float32 else 'bf16'}",
                  lambda: A.dot_product_attention(q, k, v),
                  lambda: A._attention_plain(q, k, v, causal=False,
                                             sm_scale=256 ** -0.5), tol,
                  nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2, graphed=True,
                  library_fn=lambda: F.scaled_dot_product_attention(q, k, v))
        split(lambda: A.dot_product_attention(q, k, v), "attn_fwd_sm90", dtype)
        return q, k, v

    q, k, v = d256_case(torch.float32, "attention_fwd[flash_d256]", TOL_F32_ATTN)
    # the staging pass alone at the tracker's shape: exact against
    # Tensor.to (both round to nearest even); 48 MB read, 24 MB written
    K.compare("stage_bf16", "staging pass f32 -> bf16 [4,1,4096,256] x 3",
              lambda: torch.cat([t.flatten() for t in A.stage_bf16(q, k, v)]),
              lambda: torch.cat([t.to(bf).flatten() for t in (q, k, v)]), 0.0,
              nbytes=3 * q.numel() * (4 + 2), ops=0, tol_l2=0.0,
              timed_fn=lambda: A.stage_bf16(q, k, v), graphed=True)
    del q, k, v
    d256_case(bf, None, TOL_BF16_ATTN)

    # K8: Hiera's stage-1 and stage-2 windows over 8 frames, and a window
    # count that no tile packing divides
    def smallwin_case(NW, Sw, H, key):
        hd = 72
        qkv = randn(NW, Sw, 3 * H * hd)
        x5 = qkv.view(NW, Sw, 3, H, hd)
        wins = [x5[:, :, i].transpose(1, 2) for i in range(3)]
        nb, ops = attn_cost(NW, H, Sw, Sw, hd)
        K.compare(key, f"K8 windows [{NW},{Sw},{3 * H * hd}] H={H}",
                  lambda: A.attention_packed_qkv_smallwin(qkv, H, hd),
                  lambda: A._smallwin_plain(qkv, H, hd ** -0.5), TOL_BF16_ATTN,
                  nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2_EXACT,
                  library_fn=lambda: F.scaled_dot_product_attention(*wins))

    smallwin_case(8192, 64, 2, "smallwin_attention")
    smallwin_case(8192, 16, 4, None)
    smallwin_case(1021, 64, 2, None)

    # K3: RMS at 3072 and 1408, LN at 1024 (with/without bias), 256 f32.
    # One read and one write per element; ~8 f32 operations per element.
    ones = lambda d: torch.ones(d, device="cuda")

    def norm_cost(x):
        return 2 * x.numel() * x.element_size(), 8 * x.numel()

    x = randn(3391, 3072)
    w = randn(3072, dtype=torch.float32, scale=0.1) + 1
    wb = w.to(bf)
    nb, ops = norm_cost(x)
    K.compare("row_norm[rms]", "K3 RMS Phi-3 [3391,3072] bf16",
              lambda: N.row_norm(x, w, None, 1e-5, rms=True),
              lambda: N._rms_norm_plain(x, w, 1e-5), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.rms_norm(x, (3072,), wb, 1e-5))
    x = randn(4, 1025, 1408)
    nb, ops = norm_cost(x)
    w1408 = ones(1408)              # made once: a fill in the timed call is not K3's
    o1408 = w1408.to(bf)
    K.compare(None, "K3 RMS InternVideo2 [4,1025,1408] bf16",
              lambda: N.row_norm(x, w1408, None, 1e-6, rms=True),
              lambda: N._rms_norm_plain(x, w1408, 1e-6), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.rms_norm(x, (1408,), o1408, 1e-6))
    x = randn(16, 577, 1024, scale=3.0)
    w = randn(1024, dtype=torch.float32, scale=0.1) + 1
    b = randn(1024, dtype=torch.float32, scale=0.1)
    wb, bb = w.to(bf), b.to(bf)
    nb, ops = norm_cost(x)
    K.compare("row_norm[ln]", "K3 LN CLIP [16,577,1024] bf16 +bias",
              lambda: N.row_norm(x, w, b, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-5), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (1024,), wb, bb, 1e-5))
    K.compare(None, "K3 LN CLIP [16,577,1024] bf16 no bias",
              lambda: N.row_norm(x, w, None, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, None, 1e-5), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (1024,), wb, None, 1e-5))
    # SAM-1 ViT-H's norm1 / norm2: one image's [1,64,64,1280] (10.5 MB, so
    # the replay reads it partly from L2), a width K3 pads to 2048
    x = randn(1, 64, 64, 1280, scale=3.0)
    w = randn(1280, dtype=torch.float32, scale=0.1) + 1
    b = randn(1280, dtype=torch.float32, scale=0.1)
    wb, bb = w.to(bf), b.to(bf)
    nb, ops = norm_cost(x)
    K.compare("row_norm[ln]@[1,64,64,1280]", "K3 LN SAM-1 ViT-H [1,64,64,1280] bf16 +bias",
              lambda: N.row_norm(x, w, b, 1e-6, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-6), TOL_BF16_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (1280,), wb, bb, 1e-6))
    x = randn(32, 4096, 256, dtype=torch.float32)
    w = randn(256, dtype=torch.float32, scale=0.1) + 1
    b = randn(256, dtype=torch.float32, scale=0.1)
    nb, ops = norm_cost(x)
    K.compare(None, "K3 LN SAM two-way [32,4096,256] f32 +bias",
              lambda: N.row_norm(x, w, b, 1e-5, rms=False),
              lambda: N._layer_norm_plain(x, w, b, 1e-5), TOL_F32_NORM,
              nbytes=nb, ops=ops, rate="f32", graphed=True,
              library_fn=lambda: F.layer_norm(x, (256,), w, b, 1e-5))
    del x

    # K2 at the four products of Hiera stage 1 (C = 144, 8 frames of 65,536
    # tokens) and stage 3 (C = 576, 32,768 rows). No single PyTorch call
    # computes bias + tanh-GELU or + residual after the product: the library
    # time is F.linear with the bias alone, the nearest one call.
    def gemm_case(Mg, Kg, Ng, key, label, gelu=False, res=False):
        a = randn(Mg, Kg, scale=0.5)
        w2 = randn(Ng, Kg, scale=Kg ** -0.5)
        b2 = randn(Ng, scale=0.02)
        r = randn(Mg, Ng) if res else None
        nb = 2 * (Mg * Kg + Ng * Kg + Ng + Mg * Ng * (2 if res else 1))
        K.compare(key, f"K2 {label} [{Mg},{Kg}]x[{Kg},{Ng}]"
                  + (" +GELU" if gelu else "") + (" +residual" if res else ""),
                  lambda: FB.gemm_epilogue(a, w2, b2, gelu=gelu, residual=r),
                  lambda: FB._gemm_plain(a, w2, b2, gelu=gelu, residual=r),
                  TOL_BF16_GEMM, nbytes=nb, ops=2 * Mg * Kg * Ng,
                  library_fn=lambda: F.linear(a, w2, b2))
        if gelu and Kg == 144:   # the bias-only launch beside F.linear
            K.compare(None, f"K2 bias only [{Mg},{Kg}]x[{Kg},{Ng}]",
                      lambda: FB.gemm_epilogue(a, w2, b2),
                      lambda: FB._gemm_plain(a, w2, b2), TOL_BF16_GEMM,
                      nbytes=2 * (Mg * Kg + Ng * Kg + Ng + Mg * Ng),
                      ops=2 * Mg * Kg * Ng, library_fn=lambda: F.linear(a, w2, b2))
        del a, r

    for s, (Mg, C) in enumerate(((524288, 144), (32768, 576))):
        st = ("stage1", "stage3")[s]
        gemm_case(Mg, C, 3 * C, f"gemm_epilogue@{st}_qkv", f"{st} qkv+bias")
        gemm_case(Mg, C, C, f"gemm_epilogue@{st}_proj", f"{st} proj+bias",
                  res=True)
        gemm_case(Mg, C, 4 * C, "gemm_epilogue" if s == 0
                  else f"gemm_epilogue@{st}_fc1", f"{st} fc1+bias", gelu=True)
        gemm_case(Mg, 4 * C, C, f"gemm_epilogue@{st}_fc2", f"{st} fc2+bias",
                  res=True)
        torch.cuda.empty_cache()

    # fused_window_block at the four Hiera-L geometries (fewer windows)
    def block_case(NW, Sw, C, H, key):
        M = 4 * C
        shapes = dict(ln1_weight=(C,), ln1_bias=(C,), qkv_weight=(3 * C, C),
                      qkv_bias=(3 * C,), proj_weight=(C, C), proj_bias=(C,),
                      ln2_weight=(C,), ln2_bias=(C,), fc1_weight=(M, C),
                      fc1_bias=(M,), fc2_weight=(C, M), fc2_bias=(C,))
        p = {}
        for n, shp in shapes.items():
            if n.startswith("ln"):
                p[n] = randn(*shp, dtype=torch.float32, scale=0.1) + (
                    1.0 if n.endswith("weight") else 0.0)
            else:
                p[n] = randn(*shp, scale=(shp[-1] if len(shp) == 2 else 2500) ** -0.5)
        xb = randn(NW, Sw, C, scale=0.5)
        rows = NW * Sw
        # x read and y written once, the weights once; the four products
        # (12 C^2 per row) and the window attention (2 Sw C per row)
        nb = 2 * (2 * rows * C + 12 * C * C)
        ops = 2 * rows * 12 * C * C + 4 * rows * Sw * C
        K.compare(key, f"fused_window_block S={Sw} C={C} NW={NW}",
                  lambda: FB.fused_window_block(xb, p, H),
                  lambda: FB._fused_block_ref(xb, p, H), TOL_BF16_GEMM,
                  nbytes=nb, ops=ops)

    block_case(2048, 64, 144, 2, "fused_window_block")
    block_case(2048, 16, 288, 4, "fused_window_block@stage2")
    block_case(128, 256, 576, 8, "fused_window_block@stage3")
    block_case(128, 64, 1152, 16, "fused_window_block@stage4")

    # K4: decode attention over a stacked int8 cache with different data
    # per layer; compared at one layer, timed rotating over the layers so
    # that every launch finds its slab outside the L2 cache
    def decode_case(L, Hq, Hkv, hd, C, kv_len, layer, key, label):
        HD = Hkv * hd
        kc, vc = (torch.randint(-127, 128, (L, 1, C, HD), dtype=torch.int8,
                                generator=g, device="cuda") for _ in range(2))
        ks, vs = (torch.rand(L, 1, Hkv, C, generator=g, device="cuda") * 0.02
                  + 0.005 for _ in range(2))
        dq = randn(1, Hq, 1, hd)
        kvl = torch.tensor([kv_len], device="cuda", dtype=torch.int32)
        qst = kvl - 1
        rot = itertools.count()

        def launch(layer_):
            return A.dot_product_attention(dq, kc, vc, causal=True, kv_lens=kvl,
                                           q_start=qst, k_scale=ks,
                                           v_scale=vs, layer=layer_)

        # live K and V rows, their scales, q and o; two FMAs per live code
        nb = 2 * kv_len * HD + 2 * Hkv * kv_len * 4 + 2 * Hq * hd * 2
        K.compare(key, label, lambda: launch(layer),
                  lambda: A._decode_attention_q8_plain(
                      dq, kc, vc, ks, vs, sm_scale=hd ** -0.5, kv_lens=kvl,
                      layer=layer), TOL_DECODE_Q8, tol_l2=TOL_ATTN_L2, nbytes=nb,
                  ops=4 * Hq * kv_len * hd, rate="f32", graphed=True,
                  timed_fn=lambda: launch(next(rot) % L))

    decode_case(32, 32, 32, 96, 3456, 3400, 17, "decode_attention_q8",
                "K4 decode Phi-3 [1,32,1,96] over [32,1,3456,3072] int8, "
                "layer 17, kv_len 3400")
    # Llama-3.1-8B's depth: 32 slabs of 7.3 MB (231 MB), past the 50 MB L2
    decode_case(32, 32, 8, 128, 3456, 3400, 2, "decode_attention_q8@gqa",
                "K4 decode GQA G=4 [1,32,1,128] over [32,1,3456,1024] int8, "
                "layer 2, kv_len 3400")
    k4_host_us()

    # K5: the five decode products of Phi-3 (M = 1), and qkv and gate_up at
    # M = 4 (the speculative verify forward) and M = 8, int8 and int4; timed
    # over a ring of weight copies larger than L2. Library: torch's
    # weight-only int8 / int4 products where this build has a CUDA kernel
    # for them (a yardstick of time: the int4 one rounds its scales to bf16)
    def int_pack_library(x, q8, s8, p4, s4, Nd):
        """{"int8": fn or None, "int4": fn or None} and a note on each."""
        lib, notes = {}, {}
        try:
            sb = s8.to(bf)
            q = q8[:Nd]
            torch._weight_int8pack_mm(x, q, sb)
            torch.cuda.synchronize()
            lib["int8"] = lambda: torch._weight_int8pack_mm(x, q, sb)
        except (RuntimeError, NotImplementedError) as e:
            lib["int8"], notes["int8"] = None, str(e).splitlines()[0][:100]
        try:
            # unsigned nibbles q = code + 8, dequantised as (q - 8) * scale + 0;
            # torch's packing takes N in multiples of 8 (the lm_head's 32065
            # rows gain 7 zero rows, 0.02% more work)
            pad = -Nd % 8
            u4 = F.pad(p4.view(torch.uint8) ^ 0x88, (0, 0, 0, pad)).contiguous()
            w4 = torch._convert_weight_to_int4pack(u4, 8)
            s4p = F.pad(s4, (0, 0, 0, pad)).t()
            sz = torch.stack([s4p, torch.zeros_like(s4p)], -1).to(bf).contiguous()
            torch._weight_int4pack_mm(x, w4, 128, sz)
            torch.cuda.synchronize()
            lib["int4"] = lambda: torch._weight_int4pack_mm(x, w4, 128, sz)
        except (RuntimeError, NotImplementedError) as e:
            lib["int4"], notes["int4"] = None, str(e).splitlines()[0][:100]
        for kind, note in notes.items():
            log(f"  library for K5 {kind} [{Nd}]: none: no CUDA kernel in "
                f"torch {torch.__version__} ({note})")
        return lib

    k5_sums = {"int8": [0.0, 0.0], "int4": [0.0, 0.0]}   # M = 1: ms, bound
    k5_path = {"int8": 0.0, "int4": 0.0}   # M = 1, each launch after a K3 norm

    def after_norm_ms(Kd, k5):
        """K5's time as the decode layer runs it: behind a kernel that does
        not trigger the programmatic launch (a K3 RMS norm of x, whose
        output K5 reads), so a K5 launch cannot overlap the one before it.
        The replay of norm + K5 less the replay of the norm alone."""
        xn = randn(1, Kd)
        wn = randn(Kd, dtype=torch.float32, scale=0.1) + 1
        norm = lambda: N.row_norm(xn, wn, None, 1e-5, rms=True)
        alone = time_ms(norm, graphed=True)
        both = time_ms(lambda: k5(norm()), graphed=True)
        return both - alone, both, alone

    def gemv_case(M, Kd, Nd, key8, key4, what):
        wf = randn(Nd, Kd, dtype=torch.float32, scale=Kd ** -0.5)
        x = randn(M, Kd)
        q8, s8 = Q.quantize_int8(wf)
        q8 = Q.pad_rows8(q8)
        p4, s4 = Q.quantize_int4(wf, 128)
        del wf
        ring = max(2, min(16, math.ceil(150e6 / (Nd * Kd))))
        ring8 = [q8] + [q8.clone() for _ in range(ring - 1)]
        ring4 = [(p4, s4)] + [(p4.clone(), s4.clone())
                              for _ in range(2 * ring - 1)]
        r8, r4 = itertools.count(), itertools.count()
        lib = int_pack_library(x, q8, s8, p4, s4, Nd)
        io = 2 * M * (Kd + Nd)
        # 1 to 3 rows of x sum in f32 FMAs; 4 and more take bf16 mma.sync
        rate = "f32" if M <= Q.K5_ROWS_MAX_M else "bf16"
        nb8 = Nd * Kd + 4 * Nd + io
        ms8 = K.compare(key8, f"K5 int8 {what} M={M} [{Nd},{Kd}]",
                        lambda: Q.dequant_matmul(x, q8, s8),
                        lambda: Q._dequant_matmul_plain(x, q8, s8), TOL_GEMV,
                        tol_l2=TOL_GEMV_L2, nbytes=nb8, ops=2 * M * Nd * Kd,
                        rate=rate, graphed=True, library_fn=lib["int8"],
                        timed_fn=lambda: Q.dequant_matmul(
                            x, ring8[next(r8) % len(ring8)], s8))
        nb4 = Nd * Kd // 2 + 4 * Nd * Kd // 128 + io
        ms4 = K.compare(key4, f"K5 int4 {what} M={M} [{Nd},{Kd}/2]",
                        lambda: Q.dequant4_matmul(x, p4, s4, 128),
                        lambda: Q._dequant4_matmul_plain(x, p4, s4, 128),
                        TOL_GEMV, tol_l2=TOL_GEMV_L2, nbytes=nb4,
                        ops=2 * M * Nd * Kd, rate=rate, graphed=True,
                        library_fn=lib["int4"],
                        timed_fn=lambda: Q.dequant4_matmul(
                            x, *ring4[next(r4) % len(ring4)], 128))
        if M == 1:
            for kind, ms, nb in (("int8", ms8, nb8), ("int4", ms4, nb4)):
                k5_sums[kind][0] += ms
                k5_sums[kind][1] += max(nb / HBM_BYTES_S,
                                        2 * Nd * Kd / PEAK_OPS["f32"]) * 1e3
            for kind, k5 in (
                    ("int8", lambda xn: Q.dequant_matmul(
                        xn, ring8[next(r8) % len(ring8)], s8)),
                    ("int4", lambda xn: Q.dequant4_matmul(
                        xn, *ring4[next(r4) % len(ring4)], 128))):
                ms, both, alone = after_norm_ms(Kd, k5)
                k5_path[kind] += ms
                log(f"  K5 {kind} {what} M=1 after a K3 norm (no K5-to-K5 "
                    f"overlap): {ms:.4f} ms (norm + K5 {both:.4f} less the "
                    f"norm alone {alone:.4f})")
        del ring8, ring4

    gemv_case(1, 3072, 9216, None, None, "qkv_proj")
    gemv_case(1, 3072, 3072, None, None, "o_proj")
    gemv_case(1, 3072, 16384, "dequant_gemv[int8]", "dequant_gemv[int4]",
              "gate_up_proj")
    gemv_case(1, 8192, 3072, None, None, "down_proj")
    gemv_case(1, 3072, 32065, None, None, "lm_head")
    for kind, (ms, bound) in k5_sums.items():
        log(f"  K5 {kind} M=1, sum of the five products: {ms:.4f} ms "
            f"back to back, {k5_path[kind]:.4f} ms each after a K3 norm, "
            f"bound {bound:.4f} ms")
    for M in (4, 8):
        gemv_case(M, 3072, 9216, None, None, "qkv_proj")
        gemv_case(M, 3072, 16384, None, None, "gate_up_proj")


def phase_decode_fused(K: Kernels):
    """K9's four entries and `flash_attention_bshd` against their twins, at
    the shapes of the Phi-3 decode layer. Each K9 entry is timed as graph
    replays rotating over stacked weight sets larger than the L2 cache, and
    beside it the port's unfused serving chain for the same function, timed
    the same way (no single PyTorch call computes these, so no library
    time)."""
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.experiments import bench_decode_fused as BD
    from videoglamm_torch.experiments import decode_mlp as DM
    from videoglamm_torch.experiments import flash_bshd as FB

    g = torch.Generator(device="cuda").manual_seed(9)
    bf = torch.bfloat16

    def w8a8_integers(x, w, l, group, what):
        """The W8A8 entry's integers: exact on its own codes, and its codes
        the twin's but where an f32 value that differs in its last bits
        (rsqrt, expf) falls across a rounding tie."""
        args = (x, w["nw"][l], w["wgu"][l], w["sgu"][l], w["wd"][l], w["sd"][l],
                BD.EPS)
        _, tr = DM.mlp_w8a8_kernel(*args, group, trace=True)
        _, rt = DM._mlp_w8a8_plain(*args, group, trace=True)
        torch.cuda.synchronize()
        grp = min(group, w["wd"].shape[-1])
        ok = torch.equal(tr.gu, DM._int_dot(tr.xq, w["wgu"][l]))
        for j in range(tr.down.shape[0]):
            cols = slice(j * grp, (j + 1) * grp)
            ok = ok and torch.equal(tr.down[j], DM._int_dot(
                tr.hq[:, cols], w["wd"][l][:, cols]))
        flips = {n: (a.int() - b.int()).abs() for n, a, b in
                 (("xq", tr.xq, rt.xq), ("hq", tr.hq, rt.hq))}
        same_codes = all(int(d.max()) == 0 for d in flips.values())
        if same_codes:
            ok = ok and torch.equal(tr.gu, rt.gu) and torch.equal(tr.down, rt.down)
        near = all(int(d.max()) <= 1 and float((d > 0).float().mean()) <= 2e-3
                   for d in flips.values())
        log(f"  K9 mlp_w8a8 {what}: s32 sums of gate/up {tuple(tr.gu.shape)} "
            f"and of down per group {tuple(tr.down.shape)} "
            f"{'EQUAL' if ok else 'DIFFER from'} the integer products of the "
            f"kernel's codes; codes differing from the twin's: "
            + ", ".join(f"{n} {int((d > 0).sum())} of {d.numel()}"
                        for n, d in flips.items())
            + (" (so the twin's sums are equal too)" if same_codes else ""))
        if not (ok and near):
            raise AssertionError(f"K9 mlp_w8a8 {what}: integer sums or codes "
                                 "disagree with the twin")

    def case(M, Kd, Id, Nq, ring, keyed, group=DM.W8A8_GROUP):
        w = BD.make_weights(ring, Kd, Id, Nq, "cuda", seed=2)
        x = torch.randn(M, Kd, generator=g, device="cuda").to(bf)
        o = torch.randn(M, Kd, generator=g, device="cuda").to(bf)

        def rotating(fn):
            c = itertools.count()
            return lambda: fn(next(c) % ring)

        def key(name):
            return f"decode_fused[{name}]" if keyed else None

        def chain_of(key_, variant, ms):
            chain_ms = time_ms(rotating(lambda l: BD.layer_fn(variant)(x, w, l)),
                               graphed=True)
            log(f"    the unfused chain ({variant}) over the same weights: "
                f"{chain_ms:.4f} ms, the fused entry {ms:.4f} ms, fused / chain "
                f"{ms / chain_ms:.3f}")
            if key_ is not None:
                K.rows[key_]["chain_ms"] = chain_ms
            return chain_ms

        shape = f"M={M} K={Kd}"
        io = lambda n: 2 * M * (Kd + n)
        # 1 to 3 rows sum in f32 FMAs (__dp4a for W8A8); 4 and more take mma.sync
        rate = "f32" if M <= DM.k9_constants()["ROWS_MAX_M"] else "bf16"
        # norm_matmul (qkv): weights, scales and the norm weight once
        ms = K.compare(
            key("norm_matmul"), f"K9 norm_matmul {shape} N={Nq}",
            lambda: DM.fused_norm_matmul_int8(x, w["nw"][0], w["wqkv"][0],
                                              w["sqkv"][0], BD.EPS),
            lambda: DM._norm_matmul_plain(x, w["nw"][0], w["wqkv"][0],
                                          w["sqkv"][0], BD.EPS), TOL_GEMV,
            nbytes=Nq * Kd + 4 * Nq + 4 * Kd + io(Nq), ops=2 * M * Nq * Kd,
            rate=rate, graphed=True,
            timed_fn=rotating(lambda l: DM.fused_norm_matmul_int8(
                x, w["nw"][l], w["wqkv"][l], w["sqkv"][l], BD.EPS)))
        chain_of(key("norm_matmul"), "qkv_chain", ms)
        # matmul_residual (o_proj): weights, scales, x, res and out
        ms = K.compare(
            key("matmul_residual"), f"K9 matmul_residual {shape} N={Kd}",
            lambda: DM.matmul_residual_int8(o, w["wo"][0], w["so"][0], x),
            lambda: DM._matmul_residual_plain(o, w["wo"][0], w["so"][0], x),
            TOL_GEMV, nbytes=Kd * Kd + 4 * Kd + 2 * M * 3 * Kd,
            ops=2 * M * Kd * Kd, rate=rate, graphed=True,
            timed_fn=rotating(lambda l: DM.matmul_residual_int8(
                o, w["wo"][l], w["so"][l], x)))
        chain_of(key("matmul_residual"), "o_chain", ms)
        # the MLP half: gate_up and down weights once
        mlp_bytes = 3 * Id * Kd + 4 * (2 * Id + Kd) + 4 * Kd + 2 * M * 2 * Kd
        mlp_args = lambda l: (x, w["nw"][l], w["wgu"][l], w["sgu"][l],
                              w["wd"][l], w["sd"][l], BD.EPS)
        ms = K.compare(
            key("mlp"), f"K9 mlp {shape} I={Id}",
            lambda: DM.fused_decode_mlp_int8(*mlp_args(0)),
            lambda: DM._mlp_plain(*mlp_args(0)), TOL_FUSED_MLP,
            tol_l2=TOL_ATTN_L2, nbytes=mlp_bytes, ops=2 * M * 3 * Id * Kd,
            rate=rate, graphed=True,
            timed_fn=rotating(lambda l: DM.fused_decode_mlp_int8(*mlp_args(l))))
        mlp_chain_ms = chain_of(key("mlp"), "chain", ms)
        w8a8_integers(x, w, 0, group, f"{shape} I={Id} group={min(group, Id)}")
        ms = K.compare(
            key("mlp_w8a8"), f"K9 mlp_w8a8 {shape} I={Id} group={min(group, Id)}",
            lambda: DM.fused_decode_mlp_int8(*mlp_args(0), w8a8=True, group=group),
            lambda: DM._mlp_w8a8_plain(*mlp_args(0), group), TOL_FUSED_MLP,
            tol_l2=TOL_ATTN_L2, nbytes=mlp_bytes, ops=2 * M * 3 * Id * Kd,
            rate="int8", graphed=True,
            timed_fn=rotating(lambda l: DM.fused_decode_mlp_int8(
                *mlp_args(l), w8a8=True, group=group)))
        log(f"    the unfused chain (chain) over the same weights: "
            f"{mlp_chain_ms:.4f} ms, the fused entry {ms:.4f} ms, fused / chain "
            f"{ms / mlp_chain_ms:.3f}")
        if keyed:
            K.rows[key("mlp_w8a8")]["chain_ms"] = K.rows[key("mlp")]["chain_ms"]

    for M in (1, 4, 8):
        case(M, BD.K, BD.I, BD.N_QKV, ring=3, keyed=M == 1)
    # N and I that no 1024 divides (three groups of 512, then one of 768)
    case(4, 256, 1536, 1000, ring=2, keyed=False, group=512)
    case(8, 256, 768, 1000, ring=2, keyed=False)
    torch.cuda.empty_cache()

    # more than 8 rows: the unfused chain of the port's own kernels (K3, K5),
    # as the JAX entries fall back; no K9 launch
    w = BD.make_weights(1, BD.K, BD.I, BD.N_QKV, "cuda", seed=3)
    x9 = torch.randn(9, BD.K, generator=g, device="cuda").to(bf)
    before = dict(DM.LAUNCHES)
    args = (x9, w["nw"][0], w["wgu"][0], w["sgu"][0], w["wd"][0], w["sd"][0],
            BD.EPS)
    got, ref = DM.fused_decode_mlp_int8(*args), DM._fused_mlp_ref(*args)
    qkv = DM.fused_norm_matmul_int8(x9, w["nw"][0], w["wqkv"][0], w["sqkv"][0],
                                    BD.EPS)
    qkv_ref = DM._norm_matmul_ref(x9, w["nw"][0], w["wqkv"][0], w["sqkv"][0],
                                  BD.EPS)
    torch.cuda.synchronize()
    (_, rel), (_, rel_q) = rel_err(got, ref), rel_err(qkv, qkv_ref)
    fused = {e: DM.LAUNCHES[e] - before.get(e, 0) for e in DM.ENTRIES}
    log(f"  9 rows through the unfused chain: mlp rel={rel:.3e}, norm_matmul "
        f"rel={rel_q:.3e} against the chain's twins; K9 launches {fused}")
    if rel > TOL_FUSED_MLP or rel_q > TOL_GEMV or any(fused.values()):
        raise AssertionError("9 rows: the chain disagrees with its twin or "
                             "launched K9")
    del w
    torch.cuda.empty_cache()

    # flash_attention_bshd: K1 through BSHD strides at the prefill shape
    B, Sq, Sk, H, D = 1, 3456, 3520, 32, 96
    q, k, v = (torch.randn(B, s, H, D, generator=g, device="cuda").to(bf)
               for s in (Sq, Sk, Sk))
    kvl = torch.full((B,), Sq, device="cuda", dtype=torch.int32)
    qs = torch.zeros(B, device="cuda", dtype=torch.int32)
    kw = dict(causal=True, sm_scale=D ** -0.5)
    nb, ops = attn_cost(B, H, Sq, Sk, D, pairs=Sq * (Sq + 1) // 2)
    K.compare("flash_bshd", f"flash_attention_bshd [{B},{Sq},{H},{D}] over "
              f"Sk={Sk} causal (K1 on BSHD views)",
              lambda: FB.flash_attention_bshd(q, k, v, kvl, qs, **kw),
              lambda: FB._flash_bshd_plain(q, k, v, kvl, qs, **kw),
              TOL_BF16_ATTN, nbytes=nb, ops=ops, tol_l2=TOL_ATTN_L2,
              library_fn=lambda: F.scaled_dot_product_attention(
                  q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  is_causal=True))
    via = FB.flash_attention_transposed(q, k, v, kvl, qs, **kw)
    got = FB.flash_attention_bshd(q, k, v, kvl, qs, **kw)
    torch.cuda.synchronize()
    t_ms = time_ms(lambda: FB.flash_attention_transposed(q, k, v, kvl, qs, **kw))
    same = torch.equal(via, got)
    log(f"  flash_attention_bshd against K1 on the contiguous [B,H,S,D] copy: "
        f"{'bit-equal' if same else 'DIFFERENT'}; transpose + contiguous + K1 + "
        f"transpose back {t_ms:.4f} ms")
    if not same:
        raise AssertionError("flash_attention_bshd differs from K1 on the "
                             "contiguous copy")


def phase_experiments():
    """The two harnesses at their real sizes, with the counters set to 0
    just before and read just after: the path that launches K9's four
    entries and `flash_attention_bshd`."""
    import torch
    from videoglamm_torch.experiments import bench_decode_fused as BD
    from videoglamm_torch.experiments import flash_bshd as FB

    reset_counts()
    rows = BD.run_harness(rows=(1, DRAFT_K), reps=HARNESS_REPS,
                          log=lambda line: log("  " + line))
    torch.cuda.empty_cache()
    res = FB.run_harness(reps=HARNESS_REPS, log=lambda line: log("  " + line))
    counts = read_counts()
    if not all(r["finite"] for r in rows):
        raise AssertionError("decode-layer harness: non-finite activations")
    if res["max_abs_diff"] != 0.0:
        raise AssertionError("BSHD harness: the two layouts differ by "
                             f"{res['max_abs_diff']}")
    # a variant runs 1 warm-up pass, the timed passes, one under the profiler
    # and one into the graph, for each of the two row counts; the attention
    # harness one warm-up chain, the timed chains and the compared call
    per_entry = 2 * BD.L * (HARNESS_REPS + 3)
    want = {f"decode_fused[{e}]": per_entry for e in
            ("norm_matmul", "matmul_residual", "mlp", "mlp_w8a8")}
    want["flash_bshd"] = 8 * (HARNESS_REPS + 1) + 1
    for name, n in want.items():
        if counts[name] != n:
            raise AssertionError(f"{name}: {counts[name]} launches in the "
                                 f"harnesses, expected {n}")
    log("  harness launches: " + json.dumps({k: counts[k] for k in want}))
    us = {(r["rows"], r["variant"]): r["graph_us"] for r in rows}
    for m in (1, DRAFT_K):
        log(f"  K9 against the chain, graph replays, us a layer, M={m}: "
            + ", ".join(f"{f} {us[m, f]:.1f} / {c} {us[m, c]:.1f} = "
                        f"{us[m, f] / us[m, c]:.3f}"
                        for f, c in (("fused", "chain"), ("w8a8", "chain"),
                                     ("qkv_fused", "qkv_chain"),
                                     ("o_fused", "o_chain"))))
    return counts


def seeded_init(model, g):
    """Random weights from a seed: normal std 0.02, norm scales 1, norm
    biases 0, the random-Fourier PE matrix standard normal."""
    import torch
    from videoglamm_torch.models.common import LayerNorm, RMSNorm
    norm_params = set()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (LayerNorm, RMSNorm)):
                m.weight.fill_(1.0)
                norm_params.add(id(m.weight))
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
                    norm_params.add(id(m.bias))
        for p in model.parameters():
            if id(p) not in norm_params:
                p.normal_(0.0, 0.02, generator=g)
        for b in model.buffers():     # the random-Fourier PE matrix
            b.normal_(0.0, 1.0, generator=g)
    return model


def build(cfg, quant: str, kv_cache: str, what: str):
    """The flagship model on the card through the port's own entry point,
    seeded random weights (quantised from their f32 values when asked)."""
    import torch
    from videoglamm_torch.inference.pipeline import build_inference

    t0 = time.perf_counter()
    gi = build_inference(
        cfg, device="cuda", dtype=torch.bfloat16, quant=quant,
        kv_cache=kv_cache, max_new_tokens=MAX_NEW,
        init=lambda m: seeded_init(
            m, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    n = sum(p.numel() for p in gi.model.parameters()) \
        + sum(b.numel() for b in gi.model.buffers())
    log(f"  flagship VideoGLaMM, {what}: {n / 1e9:.3f} B parameters and "
        f"buffer elements, bf16 compute, built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return gi


def make_request(cfg, seed: int):
    """Preprocessed streams, as the first slice served them."""
    import torch
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX
    g = torch.Generator(device="cuda").manual_seed(seed)
    T = cfg.num_frames
    bf = torch.bfloat16
    frames = torch.randn(1, T, 224, 224, 3, generator=g, device="cuda").to(bf)
    context = torch.randn(1, T, 336, 336, 3, generator=g, device="cuda").to(bf)
    sam = torch.randn(1, T_SAM, 1024, 1024, 3, generator=g, device="cuda").to(bf)
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g, device="cuda")
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.full((1,), S_TEXT, dtype=torch.long, device="cuda")
    return frames, context, sam, ids, lens


def make_raw_request(cfg, seed: int):
    """One raw decoded clip [1,16,480,854,3] uint8, prompt ids, lengths."""
    import torch
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX
    g = torch.Generator(device="cuda").manual_seed(seed)
    raw = torch.randint(0, 256, (1, cfg.num_frames, RAW_H, RAW_W, 3),
                        dtype=torch.uint8, generator=g, device="cuda")
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g, device="cuda")
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.full((1,), S_TEXT, dtype=torch.long, device="cuda")
    return raw, ids, lens


def _counters():
    from videoglamm_torch.experiments import decode_mlp
    from videoglamm_torch.ops import attention, fused_block, norms, quant
    return attention.LAUNCHES, fused_block.LAUNCHES, norms.LAUNCHES, \
        quant.LAUNCHES, decode_mlp.LAUNCHES


def reset_counts():
    for c in _counters():
        c.clear()


def read_counts() -> dict:
    attention, fused_block, norms, quant, fused = _counters()
    return {
        "attention_fwd[causal]": attention["causal"],
        "attention_fwd[flash]": attention["flash"],
        "attention_fwd[flash_d256]": attention["flash_d256"],
        "attention_fwd[bshd]": attention["bshd"],
        "attention_fwd[window]": attention["window"],
        "gemm_epilogue": fused_block["gemm"],
        "row_norm[rms]": norms["rms"],
        "row_norm[ln]": norms["ln"],
        "fused_window_block": fused_block["block"],
        "decode_attention_q8": attention["decode_q8"],
        "dequant_gemv[int8]": quant["int8"],
        "dequant_gemv[int4]": quant["int4"],
        "flash_bwd": attention["flash_bwd"],
        "window_attention": attention["window_attn"],
        "smallwin_attention": attention["smallwin"],
        "decode_fused[norm_matmul]": fused["norm_matmul"],
        "decode_fused[matmul_residual]": fused["matmul_residual"],
        "decode_fused[mlp]": fused["mlp"],
        "decode_fused[mlp_w8a8]": fused["mlp_w8a8"],
        "flash_bshd": attention["flash_bshd"],
        # K1 by route (csrc/attention_fwd.cu): every mode above that K1
        # serves, counted again by the way into its one body
        "k1_route[wgmma]": attention["route:wgmma"],
        "k1_route[wgmma_f32]": attention["route:wgmma_f32"],
        # the staging pass of f32 operands (K1's f32 route and K7)
        "stage_bf16": attention["stage_bf16"],
        # the full-precision f32 routes of an f32 model: K1's "simt_f32"
        # (every mode above), K2's and K6's f32 routes (counted again
        # under "gemm_epilogue" and "flash_bwd")
        "attention_fwd_f32": attention["route:simt_f32"],
        "gemm_epilogue_f32": fused_block["gemm:simt_f32"],
        "flash_bwd_f32": attention["flash_bwd:simt_f32"],
        # the f32 routes of K4, K5, K7 and K8 (an f32 model's serving
        # kernels), counted under these names only, never under their
        # kernel's bf16 counter above
        "decode_attention_q8_f32": attention["decode_q8:f32"],
        "dequant_gemv_f32[int8]": quant["gemv_int8:f32"],
        "dequant_gemv_f32[int4]": quant["gemv_int4:f32"],
        "window_attention_f32": attention["window:simt_f32"],
        "smallwin_attention_f32": attention["smallwin:simt_f32"],
    }


# launches one flagship request must make: Phi-3 prefill, 32 causal
# layers; 3 Hiera global blocks; CLIP 23 + InternVideo2 39 BSHD layers;
# 42 fused Hiera window blocks of 4 K2 GEMMs each. Every K1 launch of the
# main path is bf16 and takes the "wgmma" route; nothing is staged
K1_WGMMA = 32 + 3 + 62 + 42
EXPECTED_TOWERS = {"attention_fwd[causal]": 32, "attention_fwd[flash]": 3,
                   "attention_fwd[bshd]": 62, "attention_fwd[window]": 42,
                   "k1_route[wgmma]": K1_WGMMA, "k1_route[wgmma_f32]": 0,
                   "stage_bf16": 0, "attention_fwd_f32": 0,
                   "gemm_epilogue_f32": 0, "flash_bwd_f32": 0,
                   "decode_attention_q8_f32": 0, "dequant_gemv_f32[int8]": 0,
                   "dequant_gemv_f32[int4]": 0, "window_attention_f32": 0,
                   "smallwin_attention_f32": 0,
                   "fused_window_block": 42, "gemm_epilogue": 168,
                   "flash_bwd": 0, "attention_fwd[flash_d256]": 0,
                   "window_attention": 0, "smallwin_attention": 0,
                   # K9 and the BSHD launcher are experiments: no serving or
                   # training path calls them
                   "decode_fused[norm_matmul]": 0,
                   "decode_fused[matmul_residual]": 0, "decode_fused[mlp]": 0,
                   "decode_fused[mlp_w8a8]": 0, "flash_bshd": 0}
# the video branch: the memory self-attention runs once a memory-attention
# layer on every frame but the first (the cross-attention carries a kv_mask
# and is plain in both packages)
TRACK_SELF_ATTN = 4 * (16 - 1)
# one training micro-step: the towers once, without a gradient; with remat
# every LLM layer runs K1 causal twice (forward and recompute) and K6 once;
# no decode kernels
EXPECTED_PER_MICRO_STEP = dict(
    EXPECTED_TOWERS, **{"attention_fwd[causal]": 2 * 32, "flash_bwd": 32,
                        "k1_route[wgmma]": K1_WGMMA + 32,
                        "decode_attention_q8": 0, "dequant_gemv[int8]": 0,
                        "dequant_gemv[int4]": 0})
# int8 cache: one K4 launch per layer and decode step. Quantised weights:
# four K5 launches per layer and one for the lm_head per decode step, plus
# the lm_head on the last prompt position after the prefill. The prefill's
# own projections have M = 3391 rows and leave K5 (W8A8 resp. dequantise
# and matmul).
DECODE_Q8 = MAX_NEW * 32
GEMV = MAX_NEW * (4 * 32 + 1) + 1
EXPECTED_PER_REQUEST = {
    "bf16": dict(EXPECTED_TOWERS, **{"decode_attention_q8": 0,
                                     "dequant_gemv[int8]": 0,
                                     "dequant_gemv[int4]": 0}),
    "int8": dict(EXPECTED_TOWERS, **{"decode_attention_q8": DECODE_Q8,
                                     "dequant_gemv[int8]": GEMV,
                                     "dequant_gemv[int4]": 0}),
    "int4": dict(EXPECTED_TOWERS, **{"decode_attention_q8": DECODE_Q8,
                                     "dequant_gemv[int8]": 0,
                                     "dequant_gemv[int4]": GEMV}),
}
# tracking on the main path's model: the towers and the decode as on the
# int8 path (Hiera takes the 16 frames as one batch, so its launches do not
# change), plus K1 at head dim 256 for the memory self-attention over the
# 64x64 grid (f32 storage: the "wgmma_f32" route, one staging launch each)
EXPECTED_PER_REQUEST["track"] = dict(
    EXPECTED_PER_REQUEST["int8"],
    **{"attention_fwd[flash_d256]": TRACK_SELF_ATTN,
       "k1_route[wgmma_f32]": TRACK_SELF_ATTN, "stage_bf16": TRACK_SELF_ATTN})
# tracking at SAM image size 512, bf16 LLM: Hiera's three global blocks see
# 1024 tokens and take K1's BSHD mode, the memory self-attention over the
# 32x32 grid takes K7 (f32 storage: one staging launch each)
EXPECTED_PER_REQUEST["track512"] = dict(
    EXPECTED_PER_REQUEST["bf16"],
    **{"attention_fwd[flash]": 0, "attention_fwd[bshd]": 62 + 3,
       "window_attention": TRACK_SELF_ATTN, "stage_bf16": TRACK_SELF_ATTN})


# speculative decoding on the main path's model: every cached forward of the
# int8 LLM, of 1 row or of DRAFT_K, launches K5 four times a layer and once
# for the lm_head; only the epilogue step has one row and takes K4 (the
# K-row verify forwards take the plain attention over the dequantised
# cache). The number of verify forwards depends on the tokens, so K5's count
# is left out here and held by `phase_speculative`.
GEMV_FORWARD = 4 * 32 + 1
EXPECTED_PER_REQUEST["spec"] = {
    k: v for k, v in dict(EXPECTED_PER_REQUEST["int8"],
                          **{"decode_attention_q8": 32}).items()
    if k != "dequant_gemv[int8]"}
# the Llama-3.1 base: bf16 weights (no K5), the int8 cache through K4's GQA
# branch once a layer and decode step, a 32-layer causal prefill on K1
EXPECTED_PER_REQUEST["llama"] = dict(
    EXPECTED_PER_REQUEST["bf16"], **{"decode_attention_q8": DECODE_Q8})


# the kernels whose f32 route counts under a name of its own instead
F32_ROUTE_OF = {"decode_attention_q8": "decode_attention_q8_f32",
                "dequant_gemv[int8]": "dequant_gemv_f32[int8]",
                "dequant_gemv[int4]": "dequant_gemv_f32[int4]",
                "window_attention": "window_attention_f32",
                "smallwin_attention": "smallwin_attention_f32"}


def f32_formula(bf16: dict) -> dict:
    """An f32 model's launches from the bf16 model's: every K1 launch on
    the "simt_f32" route (attention_fwd_f32), none on a wgmma route and
    nothing staged; K2 and K6 as often, each on its f32 route; K4, K5, K7
    and K8 as often, each on its f32 route and none on its bf16 one."""
    out = dict(bf16)
    out["attention_fwd_f32"] = bf16["k1_route[wgmma]"] + bf16["k1_route[wgmma_f32]"]
    out.update({"k1_route[wgmma]": 0, "k1_route[wgmma_f32]": 0,
                "stage_bf16": 0, "gemm_epilogue_f32": bf16["gemm_epilogue"],
                "flash_bwd_f32": bf16["flash_bwd"]})
    for name, f32 in F32_ROUTE_OF.items():
        out[f32], out[name] = bf16[name], 0
    return out


# the f32 flagship: framewise requests, and the video branch (its memory
# self-attention on K1 "simt_f32" too, and so no staging launch at all)
EXPECTED_PER_REQUEST["f32"] = f32_formula(EXPECTED_PER_REQUEST["bf16"])
EXPECTED_PER_REQUEST["f32_track"] = f32_formula(dict(
    EXPECTED_PER_REQUEST["bf16"],
    **{"attention_fwd[flash_d256]": TRACK_SELF_ATTN,
       "k1_route[wgmma_f32]": TRACK_SELF_ATTN, "stage_bf16": TRACK_SELF_ATTN}))
EXPECTED_PER_MICRO_STEP_F32 = f32_formula(EXPECTED_PER_MICRO_STEP)
# the f32 flagship with quantised weights: the int8 main path and the int4
# path on the f32 routes of K4 and K5; the video branch at SAM image size
# 512 on the int8 model, its memory self-attention on K7's f32 route
EXPECTED_PER_REQUEST["f32_int8"] = f32_formula(EXPECTED_PER_REQUEST["int8"])
EXPECTED_PER_REQUEST["f32_int4"] = f32_formula(EXPECTED_PER_REQUEST["int4"])
EXPECTED_PER_REQUEST["f32_track512"] = f32_formula(dict(
    EXPECTED_PER_REQUEST["int8"],
    **{"attention_fwd[flash]": 0, "attention_fwd[bshd]": 62 + 3,
       "window_attention": TRACK_SELF_ATTN, "stage_bf16": TRACK_SELF_ATTN}))


def phase_serve(gi, cfg, mode: str, requests, raw: bool, track: bool = False,
                serve_kw=None, timings_out=None):
    """Serve `requests` through the entry point with the counters set to 0
    just before and read just after; `mode` names the path's expected
    launches. track: the video branch, every frame to SAM. serve_kw: a
    callable that makes the further keyword arguments of one request (a
    fresh seeded generator); timings_out: a list that receives each
    request's stage seconds."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    results = []
    for i, req in enumerate(requests):
        timings = {}
        t0 = time.perf_counter()
        kw = serve_kw() if serve_kw is not None else {}
        if track:
            out = gi.serve_raw(*req, timings=timings, use_video_branch=True)
        elif raw:
            out = gi.serve_raw(*req, num_sam_frames=T_SAM, timings=timings, **kw)
        else:
            out = gi(*req, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results.append(out)
        if timings_out is not None:
            timings_out.append(timings)
        masks = out.pred_masks
        B = req[0].shape[0]                  # clips a request
        log(f"  {mode} request {i}: wall {wall:.3f} s, "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + f", {B * cfg.num_frames / wall:.3f} frames/s ({B} x "
            f"{cfg.num_frames}), tokens "
            f"{'/'.join(str(int(n)) for n in out.lengths)} of {MAX_NEW}, "
            f"[SEG] {int(out.seg_valid.sum())}, "
            f"masks {tuple(masks.shape)} finite={bool(torch.isfinite(masks).all())}")
    counts = read_counts()
    log(f"  {mode}: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  {mode}: launches over {len(requests)} requests: " + json.dumps(counts))
    log(f"  {mode}: K1 by route: wgmma {counts['k1_route[wgmma]']}, wgmma_f32 "
        f"{counts['k1_route[wgmma_f32]']}, simt_f32 {counts['attention_fwd_f32']}; "
        f"staging launches {counts['stage_bf16']}")
    expected = EXPECTED_PER_REQUEST[mode]
    for name, n in counts.items():
        per = expected.get(name)
        if per is None:
            if n == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     f"{mode} path")
        elif n != per * len(requests):
            raise AssertionError(f"{name}: {n} launches on the {mode} path, "
                                 f"expected {per} per request x {len(requests)}")
    return results, counts


# batch 4 (bench.py's BENCH_BATCH=4, "batch 4 fits 16GB HBM"): four seeded
# clips and four prompts of different text lengths in one request; every
# row is held to its clip served alone at batch 1, teacher-forced over the
# batch row's own served tokens
BATCH_TEXT_LENS = (64, 40, 52, 28)
BATCH_TF_STEPS = 16
TOL_BATCH_BF16 = TOL_LLM_TF_Q   # relative L2 of a row's decode logits, bf16
                                # with int8 weights and cache: a row alone
                                # takes other GEMM shapes (the towers, the
                                # prefill) and K5's one-row route, rounded
                                # in bf16 elsewhere; the bound the cached
                                # decode holds against the uncached forward
TOL_BATCH_F32 = 1e-4            # the same in f32 (the f32 control): the same
                                # f32 function in another order
                                # (tests/test_torch_f32_batch.py's), with
TOL_BATCH_F32_FLIPS = 1e-5      # at most this share of the row's int8 cache
                                # codes one step from the lone row's: a
                                # last-bit difference before round() moves
                                # a code by one (64 to 97 codes a row
                                # measured); a row that lost precision
                                # moves far more, and fails here


def make_batch_request(cfg, seed: int):
    """Four raw clips [4,16,480,854,3] uint8 (`make_raw_request`'s, seeds
    seed..seed+3) and prompts of BATCH_TEXT_LENS tokens, zero-padded."""
    import torch
    reqs = [make_raw_request(cfg, seed + b) for b in range(len(BATCH_TEXT_LENS))]
    raw = torch.cat([r[0] for r in reqs])
    ids = torch.zeros(len(reqs), max(BATCH_TEXT_LENS), dtype=torch.long,
                      device="cuda")
    for b, n in enumerate(BATCH_TEXT_LENS):
        ids[b, :n] = reqs[b][1][0, :n]
    lens = torch.tensor(BATCH_TEXT_LENS, dtype=torch.long, device="cuda")
    return raw, ids, lens


def phase_batch(gi, cfg, mode: str, seed: int, tol: float, what: str,
                max_flips=None):
    """One batch-4 request through `serve_raw` (launches by `mode`'s
    per-request counts: the towers, prefill and decode launch once for the
    batch), then:
    - the batch again, teacher-forced over its served tokens with the
      served cache length: its argmax must give every served token of every
      row (the request itself held);
    - each row against its clip alone: the prefill's logits and
      BATCH_TF_STEPS cached decode steps fed the batch row's own served
      tokens, relative L2 within `tol`; with `max_flips` (f32) at most that
      share of the row's int8 cache codes may differ from the lone row's,
      each by one. The token agreement of the lone row's argmax with the
      served tokens is printed, not held."""
    import torch
    from videoglamm_torch.inference.generate import decode_step, prefill
    from videoglamm_torch.inference.pipeline import prepare_vision_inputs
    from videoglamm_torch.models.common import full_precision

    raw, ids, lens = make_batch_request(cfg, seed)
    results, _ = phase_serve(gi, cfg, mode, [(raw, ids, lens)], raw=True)
    check_outputs(cfg, results, what)
    tokens, served = results[0].tokens, results[0].lengths
    del results
    model, n = gi.model, BATCH_TF_STEPS
    dtype = model.llm.model.embed_tokens.weight.dtype

    def forced_logits(frames, context, ids_, lens_, tok, max_new):
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, last = prefill(model.llm, visual, ids_, lens_, max_new,
                                     quant_kv=model.quant_kv_int8)
        out = [last.float()]
        for j in range(n - 1):
            out.append(decode_step(model.llm, cache, tok[:, j],
                                   sp.attn_lens + j)[0].float())
        return torch.stack(out, dim=1), cache, sp.attn_lens   # [B, n, V]

    with torch.no_grad(), full_precision(gi.f32):
        frames, context, _ = prepare_vision_inputs(raw, cfg, num_sam_frames=T_SAM,
                                                   dtype=dtype)
        batch, bcache, blens = forced_logits(frames, context, ids, lens, tokens,
                                             gi.max_new_tokens)
        live = torch.arange(n, device=tokens.device)[None] < served[:, None]
        hit = (batch.argmax(-1) == tokens[:, :n]) | ~live
        same = hit.float().mean().item()
        worst = 0.0
        for b, L in enumerate(BATCH_TEXT_LENS):
            alone, acache, alens = forced_logits(
                frames[b:b + 1], context[b:b + 1], ids[b:b + 1, :L],
                lens[b:b + 1], tokens[b:b + 1], n)
            alone = alone[0]
            if int(alens[0]) != int(blens[b]):
                raise AssertionError(f"{what} row {b}: prompt length "
                                     f"{int(blens[b])} in the batch, "
                                     f"{int(alens[0])} alone")
            # the positions the row wrote: its prompt and n - 1 decode steps
            P = int(blens[b]) + n - 1
            flips, step, codes = 0, 0, 0
            for key in ("k", "v"):
                d = (bcache[key][:, b, :P].int() - acache[key][:, 0, :P].int()).abs()
                flips += int((d > 0).sum())
                step = max(step, int(d.max()))
                codes += d.numel()
            rel = rel_l2(batch[b], alone)
            agree = (alone.argmax(-1) == tokens[b, :n]).float().mean().item()
            log(f"  {what} row {b} ({L} text tokens) against its clip alone, "
                f"{n} teacher-forced logits: rel L2 {rel:.3e} (tol {tol:g}); "
                f"{flips} of {codes} int8 cache codes differ ({flips / codes:.2e}"
                f"{'' if max_flips is None else f', held at {max_flips:g}'}), "
                f"by {step} at most; token agreement {agree:.3f} (reported)")
            if max_flips is not None and (step > 1 or flips > max_flips * codes):
                raise AssertionError(f"{what} row {b}: its int8 cache codes "
                                     "differ from its clip alone's beyond last bits")
            if not rel <= tol:
                raise AssertionError(f"{what} row {b}: disagrees with its clip "
                                     f"alone, rel L2 {rel:.3e} > {tol:g}")
            worst = max(worst, rel)
    log(f"  {what}: the batch's teacher-forced argmax reproduces its served "
        f"tokens {same:.3f} (held at 1; rows of {served.tolist()} served "
        f"tokens); worst row rel L2 {worst:.3e}")
    if same != 1.0:
        raise AssertionError(f"{what}: the batch teacher-forced does not give "
                             "its served tokens")


def check_reference_round_trip(gi, cfg, request):
    """The served model's state_dict through `to_reference_layout` (the
    reference's HF export, InternVideo2 and CLIP checkpoints) and
    `from_reference_layout` in memory, a second model built from it through
    `build_inference`: one request on each gives equal tokens and
    bit-equal masks."""
    import torch
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.io.reference import (from_reference_layout,
                                               to_reference_layout)
    sd = gi.model.state_dict()
    hf, iv, clip = to_reference_layout(sd, cfg)
    back = from_reference_layout(hf, cfg, iv, clip)
    if set(back) != set(sd) or any(back[k] is not sd[k] for k in sd):
        raise AssertionError("reference layout: the round trip changed the state dict")
    t0 = time.perf_counter()
    gi2 = build_inference(cfg, back, device="cuda", dtype=torch.bfloat16,
                          max_new_tokens=MAX_NEW)
    build_s = time.perf_counter() - t0
    del sd, back
    outs = [g(*request) for g in (gi, gi2)]
    same_tokens = torch.equal(outs[0].tokens, outs[1].tokens) \
        and torch.equal(outs[0].lengths, outs[1].lengths)
    same_masks = torch.equal(outs[0].pred_masks, outs[1].pred_masks)
    log(f"  reference layout: {len(hf)} HF-export keys, {len(iv)} InternVideo2, "
        f"{len(clip)} CLIP; rebuilt in {build_s:.1f} s; one request on each: tokens "
        f"{'equal' if same_tokens else 'DIFFER'}, masks "
        f"{'bit-equal' if same_masks else 'DIFFER'} "
        f"{tuple(outs[0].pred_masks.shape)}")
    if not (same_tokens and same_masks):
        raise AssertionError("reference layout: the rebuilt model serves otherwise")
    del gi2, outs
    torch.cuda.empty_cache()


def check_outputs(cfg, results, what: str, t_sam: int = T_SAM):
    import torch
    E4 = 4 * cfg.sam2.low_res_size
    for i, out in enumerate(results):
        shape = (out.tokens.shape[0], cfg.max_seg_tokens, t_sam, E4, E4)
        if tuple(out.pred_masks.shape) != shape:
            raise AssertionError(f"{what} request {i}: masks "
                                 f"{tuple(out.pred_masks.shape)}")
        if not torch.isfinite(out.pred_masks).all():
            raise AssertionError(f"{what} request {i}: non-finite mask logits")
        invalid = ~out.seg_valid
        if not (out.pred_masks[invalid] <= -1e3).all():
            raise AssertionError(f"{what} request {i}: invalid [SEG] slots "
                                 "not masked")
        vocab = cfg.llm_config.vocab_size + 1
        if not ((out.tokens >= 0) & (out.tokens < vocab)).all():
            raise AssertionError(f"{what} request {i}: token ids out of range")
    log(f"  {what} outputs: finite, expected shapes, invalid slots <= -1e3, "
        "ids in vocab")


def check_teacher_forced(model, frames, context, ids, lens, tol, what: str):
    """Cached decode against one uncached forward (K1 causal) over the same
    teacher-forced stream, with the model's own weights and cache kind."""
    import torch
    from videoglamm_torch.inference.generate import decode_step, prefill
    from videoglamm_torch.models.multimodal import splice_visual_prefix

    g = torch.Generator(device="cuda").manual_seed(7)
    n = 16
    forced = torch.randint(1, 32000, (1, n), generator=g, device="cuda")
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, _ = prefill(model.llm, visual, ids, lens, n,
                                  quant_kv=model.quant_kv_int8)
        steps = [decode_step(model.llm, cache, forced[:, j], sp.attn_lens + j)[1]
                 for j in range(n)]
        got = torch.stack(steps, dim=1).float()
        full_ids = torch.cat([ids, forced], dim=1)
        spf = splice_visual_prefix(model.llm.embed(full_ids), full_ids, visual,
                                   lens + n)
        _, hidden, _ = model.llm(spf.embeds, spf.positions, spf.attn_lens)
        s0 = int(sp.attn_lens[0])
        ref = hidden[:, s0:s0 + n].float()
    rel = ((got - ref).norm() / ref.norm()).item()
    cos = torch.nn.functional.cosine_similarity(got.flatten(), ref.flatten(),
                                                dim=0).item()
    log(f"  LLM teacher-forced ({what}), {n} steps: cached decode vs uncached "
        f"K1 forward rel L2 {rel:.3e} (tol {tol:g}), cosine {cos:.6f}")
    if not rel <= tol:
        raise AssertionError(f"{what}: cached decode disagrees with the "
                             "uncached forward")


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v:
            return float(v)
    return 0.0


def k4_host_us(calls: int = 1000):
    """Host microseconds of one eager K4 call (the wrapper's checks, plan and
    launch), mean of `calls` calls at the Phi-3 geometry. kv_len is 1, so
    that the device keeps up with the enqueue: the host's work does not
    depend on it."""
    import torch
    from videoglamm_torch.ops import attention as A
    g = torch.Generator(device="cuda").manual_seed(7)
    kc, vc = (torch.randint(-127, 128, (2, 1, 3456, 3072), dtype=torch.int8,
                            generator=g, device="cuda") for _ in range(2))
    ks, vs = (torch.rand(2, 1, 32, 3456, generator=g, device="cuda") * 0.02
              for _ in range(2))
    q = torch.randn(1, 32, 1, 96, generator=g, device="cuda").to(torch.bfloat16)
    kvl = torch.ones(1, device="cuda", dtype=torch.int32)

    def call():
        return A.decode_attention_q8(q, kc, vc, ks, vs, kvl, 1,
                                     sm_scale=96 ** -0.5)

    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host_us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    log(f"  K4 host time per eager decode_attention_q8 call: {host_us:.2f} us "
        f"(mean of {calls}, Phi-3 geometry, kv_len 1)")


def source_kernels(name: str) -> tuple:
    """The __global__ functions of csrc/<name>.cu: the names under which the
    profiler lists that source's device kernels."""
    import re
    from videoglamm_torch.ops import _cuda
    text = (_cuda.CSRC / f"{name}.cu").read_text()
    return tuple(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                            r"\s*)?(\w+)\s*\(", text))


def measure_decode(model, frames, context, ids, lens, what: str, steps: int = 16,
                   rows: int = 1):
    """The decode step alone: host-clock ms per step over `steps` steps
    ending in a synchronise, then the same steps under torch.profiler for
    the device-busy share and the device launches per step. rows > 1: the
    step is one cached forward of `rows` tokens, as a speculative iteration
    makes it. Returns the host-clock ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoglamm_torch.inference.generate import prefill
    from videoglamm_torch.ops import attention as A

    llm = model.llm
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, logits = prefill(llm, visual, ids, lens, 3 * steps,
                                       quant_kv=model.quant_kv_int8, slack=rows)
        block = logits.argmax(dim=-1)[:, None].expand(-1, rows)
        ar = torch.arange(rows, device=block.device)[None]

        def run(first: int):
            for j in range(first, first + steps):
                pos = sp.attn_lens + j
                llm(llm.embed(block), pos[:, None] + ar, pos + rows, cache)
            torch.cuda.synchronize()

        run(0)                                   # warm-up
        t0 = time.perf_counter()
        run(steps)
        host_ms = (time.perf_counter() - t0) * 1e3 / steps
        k4_calls = A.LAUNCHES["decode_q8"]
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(2 * steps)
            prof_ms = (time.perf_counter() - t0) * 1e3 / steps
        k4_calls = (A.LAUNCHES["decode_q8"] - k4_calls) / steps
    # kernel rows only: an operator's row repeats its kernels' device time
    kernels = [e for e in prof.key_averages()
               if _device_us(e) > 0 and "cuda" in str(e.device_type).lower()]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    what = f"{what} decode step" if rows == 1 else \
        f"{what} cached forward of {rows} rows"
    if not kernels:
        log(f"  {what}: {host_ms:.3f} ms host clock (mean of "
            f"{steps}); device time not measured (the profiler saw none)")
        return host_ms
    top = sorted(kernels, key=_device_us, reverse=True)[:4]
    share = {}
    for label, src in (("K4", "decode_attention_q8"), ("K5", "dequant_gemv")):
        names = source_kernels(src)
        mine = [e for e in kernels if any(n in e.key for n in names)]
        share[label] = (sum(_device_us(e) for e in mine) / 1e3 / steps,
                        sum(e.count for e in mine) / steps)
    log(f"  {what}: {host_ms:.3f} ms host clock (mean of {steps}); "
        f"under the profiler {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
        f"({busy_ms / prof_ms:.2f}), {launches:.0f} device launches a step; "
        + "; ".join(f"{k} {ms:.3f} ms of it over {n:.0f} device launches"
                    for k, (ms, n) in share.items()) + "; top: "
        + "; ".join(f"{e.key[:48]} {_device_us(e) / 1e3 / steps:.3f} ms x"
                    f"{e.count / steps:.0f}" for e in top))
    # one device kernel a K4 call: a second kernel a call would double the
    # count; the profiler may drop a few records of a window, never add one
    if not 0.9 * k4_calls <= share["K4"][1] <= k4_calls:
        raise AssertionError(f"{what}: {share['K4'][1]:.1f} K4 device kernels "
                             f"a step for {k4_calls:.0f} calls")
    return host_ms


def phase_speculative(gi, cfg, raw_requests, frames, context, ids, lens,
                      plain_step_ms: float):
    """Speculative serving on the main path's model: requests through
    `serve_raw` with `draft_k=DRAFT_K`, then one verify forward by hand. Seeded random
    weights accept few drafts and greedy tokens flip under rounding between
    the K-row and the 1-row kernels, so the tokens are not held to the plain
    greedy run; held are the launches, the masks, `lengths` against `tokens`,
    and the K-row verify forward against K single-row steps fed the same
    tokens."""
    import torch
    from videoglamm_torch.inference.generate import (decode_step, prefill,
                                                     terminators_for)
    from videoglamm_torch.inference.pipeline import GroundedInference

    model = gi.model
    spec = GroundedInference(model, max_new_tokens=MAX_NEW, draft_k=DRAFT_K)
    requests = raw_requests[:N_SPEC_REQUESTS]
    stages = []
    results, counts = phase_serve(spec, cfg, "spec", requests, raw=True,
                                  timings_out=stages)
    check_outputs(cfg, results, "speculative")
    # every request: the lm_head on the last prompt position, then one cached
    # forward an iteration and the epilogue step
    n = len(requests)
    forwards, rest = divmod(counts["dequant_gemv[int8]"] - n, GEMV_FORWARD)
    iterations = forwards - n
    if rest or not 0 <= iterations <= n * (MAX_NEW - 1):
        raise AssertionError(f"speculative: {counts['dequant_gemv[int8]']} K5 "
                             f"launches are no whole number of cached forwards")
    stop = torch.tensor(terminators_for(cfg.llm_type), device="cuda")
    emitted = 0
    for i, out in enumerate(results):
        length = int(out.lengths[0])
        toks = out.tokens[0]
        if (toks[length:] != 0).any() or torch.isin(toks[:length], stop).any():
            raise AssertionError(f"speculative request {i}: lengths {length} "
                                 f"against tokens {toks.tolist()}")
        emitted += length
    gen_s = sum(t["generate"] for t in stages)
    log(f"  speculative, draft_k={DRAFT_K}: {iterations} iterations for "
        f"{emitted} tokens over {n} requests ({emitted / max(iterations, 1):.3f} "
        f"tokens an iteration), generate stage {gen_s / n:.3f} s a request "
        "(prefill included)")

    # one verify forward of DRAFT_K rows against DRAFT_K single-row steps fed
    # the same tokens at the same positions of the same cache
    g = torch.Generator(device="cuda").manual_seed(8)
    forced = torch.randint(1, 32000, (1, DRAFT_K), generator=g, device="cuda")
    llm = model.llm
    with torch.no_grad():
        visual = model.encode_visual_prefix(frames, context)
        _, cache, sp, _ = prefill(llm, visual, ids, lens, DRAFT_K,
                                  quant_kv=model.quant_kv_int8, slack=DRAFT_K)
        single = [decode_step(llm, cache, forced[:, j], sp.attn_lens + j)
                  for j in range(DRAFT_K)]
        ar = torch.arange(DRAFT_K, device="cuda")[None]
        reset_counts()
        lg, h, _ = llm(llm.embed(forced), sp.attn_lens[:, None] + ar,
                       sp.attn_lens + DRAFT_K, cache)
        torch.cuda.synchronize()
        one = read_counts()
    launched = {k: v for k, v in one.items() if v}
    log(f"  one verify forward of {DRAFT_K} rows launches: {json.dumps(launched)}")
    if launched != {"dequant_gemv[int8]": GEMV_FORWARD}:
        raise AssertionError("speculative: a verify forward must launch K5 "
                             f"{GEMV_FORWARD} times and no other kernel")
    for name, got, want in (
            ("logits", lg, torch.stack([s[0] for s in single], dim=1)),
            ("hidden", h, torch.stack([s[1] for s in single], dim=1))):
        rel = rel_l2(got, want)
        log(f"  verify forward {name} {tuple(got.shape)} vs {DRAFT_K} single-row "
            f"steps: rel L2 {rel:.3e} (tol {TOL_SPEC_VERIFY:g})")
        if not rel <= TOL_SPEC_VERIFY:
            raise AssertionError(f"speculative: the verify forward's {name} "
                                 "disagree with single-row steps")
    del cache
    verify_ms = measure_decode(model, frames, context, ids, lens,
                               "int8 + int8 KV", rows=DRAFT_K)
    log(f"  a speculative iteration ({DRAFT_K} rows) {verify_ms:.3f} ms beside a "
        f"plain step {plain_step_ms:.3f} ms: it pays from "
        f"{verify_ms / plain_step_ms:.2f} tokens an iteration on")
    return counts


def phase_sampled(gi, cfg, raw_request):
    """Sampled serving on the main path's model: the same request twice with
    temperature 0.7 and a generator seeded alike must give the same tokens."""
    import torch
    from videoglamm_torch.inference.pipeline import GroundedInference

    sampled = GroundedInference(gi.model, max_new_tokens=MAX_NEW, temperature=0.7)
    results, _ = phase_serve(
        sampled, cfg, "int8", [raw_request, raw_request], raw=True,
        serve_kw=lambda: dict(
            generator=torch.Generator(device="cuda").manual_seed(11)))
    check_outputs(cfg, results, "sampled")
    a, b = (r.tokens for r in results)
    log(f"  sampled, temperature 0.7, seed 11 twice: tokens "
        f"{'equal' if torch.equal(a, b) else 'DIFFER'}, "
        f"{a[0].unique().numel()} distinct ids in {a.shape[1]}")
    if not torch.equal(a, b):
        raise AssertionError("sampled: the same seed gave other tokens")


def phase_llama(cfg, raw_requests):
    """The Llama-3.1-8B base at full width and depth, bf16 weights and the
    int8 KV cache: the first path through K4's GQA branch (4 query heads a
    KV head, head dim 128)."""
    import torch
    from videoglamm_torch.inference.pipeline import prepare_vision_inputs

    lcfg = dataclasses.replace(cfg, llm_type="llama3_1")
    gi = build(lcfg, "none", "int8", "Llama-3.1-8B bf16 LLM")
    results, counts = phase_serve(gi, lcfg, "llama",
                                  raw_requests[:N_LLAMA_REQUESTS], raw=True)
    check_outputs(lcfg, results, "Llama-3.1")
    raw, ids, lens = raw_requests[0]
    with torch.no_grad():
        frames, context, _ = prepare_vision_inputs(
            raw, lcfg, num_sam_frames=T_SAM, dtype=torch.bfloat16)
    check_teacher_forced(gi.model, frames, context, ids, lens, TOL_LLM_TF_Q,
                         "Llama-3.1, bf16 weights, int8 cache")
    measure_decode(gi.model, frames, context, ids, lens, "Llama-3.1 bf16 + int8 KV")
    return counts


def small_config():
    """Flagship image sizes, frame counts and sequence lengths with narrow,
    shallow towers: every kernel still takes its main-path branch (CLIP
    S=577, InternVideo2 S=1025 at head dim 88, a 3391-token causal prefill,
    Hiera windows of 64/16/256 tokens and a 4096-token global block; K4 at
    head dim 64 and K5 at K = 128 and 256)."""
    from videoglamm_torch.config import HieraConfig, VideoGLaMMConfig
    f = VideoGLaMMConfig.flagship()
    R = dataclasses.replace
    return R(f,
             llm=R(f.llm, hidden_size=128, intermediate_size=256, num_layers=2,
                   num_heads=2, num_kv_heads=2, head_dim=64),
             clip=R(f.clip, hidden_size=128, num_layers=3, num_heads=2,
                    intermediate_size=256),
             internvideo=R(f.internvideo, embed_dim=176, depth=3, num_heads=2),
             sam2=R(f.sam2, d_model=32, hiera=HieraConfig(
                 embed_dim=16, num_heads=1, stages=(1, 2, 3, 1),
                 global_att_blocks=(5,))),
             out_dim=32)


def phase_small_reference():
    import torch
    from videoglamm_torch.inference.generate import (decode_step,
                                                     generate_with_prefix,
                                                     prefill)
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.models.videoglamm import SegExtraction
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX

    cfg = small_config()
    f32, bf = torch.float32, torch.bfloat16
    ref = build_inference(cfg, device="cpu", dtype=f32, init=lambda m: seeded_init(
        m, torch.Generator().manual_seed(3))).model
    dev = build_inference(cfg, ref.state_dict(), device="cuda", dtype=bf).model
    g = torch.Generator().manual_seed(4)
    T = cfg.num_frames
    frames = torch.randn(1, T, 224, 224, 3, generator=g).bfloat16()
    context = torch.randn(1, T, 336, 336, 3, generator=g).bfloat16()
    sam = torch.randn(1, 1, 1024, 1024, 3, generator=g).bfloat16()
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.tensor([S_TEXT])
    seg_emb = torch.randn(1, cfg.max_seg_tokens, cfg.out_dim, generator=g)
    seg = SegExtraction(seg_emb, torch.ones(1, cfg.max_seg_tokens, dtype=torch.bool),
                        torch.arange(cfg.max_seg_tokens)[None])
    n_forced = 4
    forced = torch.randint(1, 32000, (1, n_forced), generator=g)

    def run(model, device, dtype):
        on = lambda t: t.to(device)
        visual = model.encode_visual_prefix(on(frames).to(dtype), on(context).to(dtype))
        _, _, _, logits = prefill(model.llm, visual, on(ids), on(lens), 1)
        feats, _ = model.encode_sam_features(on(sam).to(dtype))
        masks = model.decode_masks(feats, SegExtraction(*map(on, seg)),
                                   torch.arange(1, device=device))
        return dict(visual=visual, prefill_logits=logits, sam_s0=feats[0],
                    sam_s1=feats[1], sam_embed=feats[2], masks=masks)

    def run_llm(model, device, dtype, visual):
        """Prefill and teacher-forced cached decode of a quantised LLM on a
        given visual prefix: W8A8 (int8) or dequantise-and-matmul (int4) at
        the 3391-row prefill, K4 and K5 (their twins on the CPU) at decode."""
        on = lambda t: t.to(device)
        _, cache, sp, logits = prefill(model.llm, on(visual).to(dtype), on(ids),
                                       on(lens), n_forced,
                                       quant_kv=model.quant_kv_int8)
        out = [decode_step(model.llm, cache, on(forced)[:, j], sp.attn_lens + j)
               for j in range(n_forced)]
        # the same tokens again as one cached forward of n_forced rows, as a
        # speculative iteration feeds them (K5 at 4 rows, plain attention)
        ar = torch.arange(n_forced, device=device)[None]
        block_logits, block_hidden, _ = model.llm(
            model.llm.embed(on(forced)), sp.attn_lens[:, None] + ar,
            sp.attn_lens + n_forced, cache)
        return dict(prefill_logits=logits,
                    step_logits=torch.stack([o[0] for o in out], dim=1),
                    step_hidden=torch.stack([o[1] for o in out], dim=1),
                    block_logits=block_logits, block_hidden=block_hidden)

    def hold(got, want, what):
        for k, w in want.items():
            a = got[k].float().cpu()
            rel = ((a - w).norm() / w.norm()).item()
            log(f"  small model{what}, {k} {tuple(w.shape)}: card bf16 vs CPU "
                f"f32 rel L2 {rel:.3e} (tol {TOL_SMALL_REF:g})")
            if not rel <= TOL_SMALL_REF:
                raise AssertionError(f"small model{what} {k}: kernels disagree "
                                     "with the CPU reference")

    with torch.no_grad():
        want = run(ref, "cpu", f32)
        hold(run(dev, "cuda", bf), want, "")
        del dev
        for quant in ("int8", "int4"):
            # quantise once on the CPU; the card gets the same codes
            ref_q = build_inference(cfg, ref.state_dict(), device="cpu",
                                    dtype=f32, quant=quant, kv_cache="int8").model
            dev_q = build_inference(cfg, ref_q.state_dict(), device="cuda",
                                    dtype=bf, quant=quant, kv_cache="int8").model
            reset_counts()
            got = run_llm(dev_q, "cuda", bf, want["visual"])
            counts = read_counts()
            hold(got, run_llm(ref_q, "cpu", f32, want["visual"]),
                 f" ({quant} LLM, int8 cache)")
            gemv = (n_forced + 1) * (4 * cfg.llm.num_layers + 1) + 1
            if counts["decode_attention_q8"] != n_forced * cfg.llm.num_layers \
                    or counts[f"dequant_gemv[{quant}]"] != gemv:
                raise AssertionError(f"small model ({quant}): K4/K5 launches "
                                     f"{counts}")
            if quant == "int8":
                # on the CPU, in f32, speculative decoding gives the plain
                # greedy tokens
                gen = [generate_with_prefix(
                    ref_q, want["visual"], ids, lens, max_new_tokens=12,
                    eos_id=-1, draft_k=k) for k in (0, n_forced)]
                same = torch.equal(gen[0].tokens, gen[1].tokens)
                log(f"  small model (int8 LLM, int8 cache) on the CPU: "
                    f"speculative (draft_k={n_forced}) and plain greedy tokens "
                    f"{'equal' if same else 'DIFFER'}: {gen[1].tokens[0].tolist()}")
                if not same:
                    raise AssertionError("small model: speculative decoding "
                                         "changed the greedy tokens on the CPU")
            del dev_q, ref_q


def device_busy(fn, what: str, smi: str = "", top: int = 6):
    """Run fn once under torch.profiler and log its wall ms, device-busy ms
    and their share, the device launches and the `top` kernels by device
    time. Returns (fn's result, the profiler rows with device time: empty
    when the profiler saw none, logged as a WARNING when fn launched work
    on the card: the profiler lost the window's device records)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from videoglamm_torch.utils.profiling import device_records_lost, port_launches
    tag = f" [{smi}]" if smi else ""
    torch.cuda.synchronize()
    launched = port_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages()
            if _device_us(e) > 0 and "cuda" in str(e.device_type).lower()]
    if not rows:
        lost = device_records_lost(prof, port_launches() - launched)
        log(f"  {'WARNING: ' if lost else ''}{what} under the profiler: "
            f"{wall_ms:.1f} ms; device time not measured (the profiler saw none"
            f"{', though the window launched work on the card' if lost else ''})"
            f"{tag}")
        return out, rows
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    best = sorted(rows, key=_device_us, reverse=True)[:top]
    log(f"  {what} under the profiler: {wall_ms:.1f} ms wall, device busy "
        f"{busy_ms:.1f} ms ({busy_ms / wall_ms:.3f}), "
        f"{sum(e.count for e in rows)} device launches; top: "
        + "; ".join(f"{e.key[:56]} {_device_us(e) / 1e3:.1f} ms x{e.count}"
                    for e in best) + tag)
    return out, rows


def profile_track(gi, cfg, raw):
    """The tracker alone under torch.profiler: `track_masks` on one clip's
    16 SAM frames and 4 seeded [SEG] prompts; wall, device-busy share,
    launches and the kernels that take most device time."""
    import torch
    from videoglamm_torch.ops.preprocess import preprocess_sam_stream

    m = gi.model
    g = torch.Generator(device="cuda").manual_seed(41)
    seg = torch.randn(cfg.max_seg_tokens, cfg.out_dim, generator=g, device="cuda")
    with torch.no_grad():
        frames_sam = preprocess_sam_stream(raw, cfg.sam2.image_size,
                                           torch.bfloat16)[0]
        m.track_masks(frames_sam, seg)                       # warm-up
        masks, rows = device_busy(
            lambda: m.track_masks(frames_sam, seg),
            f"tracker ({tuple(frames_sam.shape)} frames, "
            f"{cfg.max_seg_tokens} objects)", top=8)
    if not torch.isfinite(masks).all():
        raise AssertionError("profiled tracker: non-finite masks")
    if not rows:
        return
    # the memory self-attention: K1 (64x64 grid) or K7 (32x32) and the
    # staging pass of its f32 operands
    mem = [(name, [e for e in rows if key in e.key]) for name, key in
           (("K1 body", "attn_fwd_sm90<256>"), ("K7 body", "window_attn_sm90"),
            ("staging", "stage_bf16_kernel"))]
    log("  memory self-attention in that run: "
        + "; ".join(f"{name} {sum(_device_us(e) for e in es) / 1e3:.2f} ms "
                    f"x{sum(e.count for e in es)}" for name, es in mem if es))


def phase_unhoisted_hiera(trunk, dtype=None, tol=TOL_HOIST):
    """`Hiera(hoist_layout=False)` on 8 flagship frames against the hoisted
    encoder of the same weights: every windowed block partitions on its own
    and takes the unfused branches (stage 1 and 2: K8; stage 3: K1 under a
    block-diagonal mask over two folded 256-token windows). dtype: the
    frames' (bf16 by default); an f32 trunk of an f32 model takes K8's f32
    route, counted apart."""
    import torch
    dtype = dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(31)
    x = torch.randn(8, 1024, 1024, 3, generator=g, device="cuda").to(dtype)

    def run(hoist):
        trunk.hoist_layout = hoist
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            outs = trunk(x)
        torch.cuda.synchronize()
        return outs, read_counts(), time.perf_counter() - t0

    try:
        run(True)                                         # warm-up
        hoisted, c_h, t_h = run(True)
        run(False)
        plain, c_p, t_p = run(False)
    finally:
        trunk.hoist_layout = True
    # stage 1: 2 blocks, stage 2: 5 windowed blocks after its pooling block,
    # stage 4: 3 after its pooling block (128 windows of 64 tokens: K8 takes
    # any window count) -> 10 K8 launches; stage 3: 36 blocks less 1 pooling
    # and 3 global -> 32 super-window launches of K1 in BSHD mode; the 3
    # global blocks stay on K1 flash; no fused block
    want = {"smallwin_attention": 10, "attention_fwd[bshd]": 32,
            "attention_fwd[flash]": 3, "fused_window_block": 0,
            "attention_fwd[window]": 0, "smallwin_attention_f32": 0,
            "stage_bf16": 0}
    if dtype == torch.float32:
        want.update(smallwin_attention=0, smallwin_attention_f32=10)
    for name, n in want.items():
        if c_p[name] != n:
            raise AssertionError(f"unhoisted Hiera: {name} launched "
                                 f"{c_p[name]} times, expected {n}")
    if c_h["smallwin_attention"] != 0 or c_h["fused_window_block"] != 42:
        raise AssertionError(f"hoisted Hiera: launches {c_h}")
    for i, (a, b) in enumerate(zip(plain, hoisted)):
        rel = ((a.float() - b.float()).norm() / b.float().norm()).item()
        ok = rel <= tol and bool(torch.isfinite(a).all())
        log(f"  unhoisted Hiera stage {i} {tuple(a.shape)} {a.dtype}: rel L2 "
            f"against the hoisted path {rel:.3e} (tol {tol:g}) "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError("unhoisted Hiera disagrees with the hoisted path")
    k8 = c_p["smallwin_attention"] + c_p["smallwin_attention_f32"]
    log(f"  Hiera-L on 8 frames: hoisted {t_h:.3f} s (42 fused blocks), "
        f"unhoisted {t_p:.3f} s (K8 x{k8}, K1 "
        f"super-windows x{c_p['attention_fwd[bshd]']})")
    return c_p


def track_config(image_size: int):
    """A narrow Hiera under full-width memory modules (d_model 256, mem_dim
    64, one 256-wide attention head), one memory-attention layer: the
    memory self-attention takes K1 at head dim 256 (image size 1024, a
    64x64 grid) or K7 (512, a 32x32 grid), in f32."""
    from videoglamm_torch.config import HieraConfig, SAM2Config
    return SAM2Config(hiera=HieraConfig(embed_dim=16, num_heads=1,
                                        stages=(1, 2, 3, 1),
                                        global_att_blocks=(5,)),
                      image_size=image_size, memory_attention_layers=1)


def phase_small_track_reference(image_size: int):
    """The narrow tracker on the card (bf16 image encoder, f32 memory
    modules with K1 / K7 on the self-attention) against the same weights on
    the CPU in f32 through the plain twins, over 4 frames and 2 objects.
    First teacher-forced, frame by frame on the reference's memory bank, so
    that each step's error stands alone: all mask candidates, their IoUs,
    the object scores and the encoded memories. Then both trackers run
    free, each on its own bank written in place: the frames held by the two
    rings must be equal, the object-score gate must fall the same way on
    every frame, and for each object the chosen mask, its object score and
    the ring's memory and pointer are held on the frames up to which every
    multimask argmax agreed with the reference's (how many choices differed
    is printed). The free run's conditioning memory is printed and not
    held: frame 0's mask is binarised before it is encoded, a step function
    of logits that differ by rounding, and the same memory is held above on
    the reference's mask. `track_video` then runs for its launch count and
    must repeat the free run's masks bit for bit."""
    import torch
    from videoglamm_torch.models.common import cast_compute
    from videoglamm_torch.models.sam2 import video_predictor as VP
    from videoglamm_torch.models.sam2.sam2_base import SAM2Base

    cfg = track_config(image_size)
    T, B = 4, 2
    ref = seeded_init(SAM2Base(cfg), torch.Generator().manual_seed(21)).eval()
    with torch.no_grad():
        # the object-score gate decided by a margin far above bf16 rounding
        ref.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(2.0)
    dev = SAM2Base(cfg)
    dev.load_state_dict(ref.state_dict())
    dev = dev.cuda().eval()
    cast_compute(dev.image_encoder, torch.bfloat16)
    dev.sam_mask_decoder.conv_s0.to(torch.bfloat16)
    dev.sam_mask_decoder.conv_s1.to(torch.bfloat16)
    g = torch.Generator().manual_seed(22)
    frames = torch.randn(T, image_size, image_size, 3, generator=g)
    text = torch.randn(B, 1, cfg.d_model, generator=g)

    def hold(got, want, what, tol=TOL_TRACK_REF):
        a, w = got.float().cpu(), want.float()
        rel = ((a - w).norm() / w.norm().clamp_min(1e-12)).item()
        ok = rel <= tol and bool(torch.isfinite(a).all())
        log(f"  narrow tracker {image_size}, {what} {tuple(w.shape)}: card vs "
            f"CPU f32 rel L2 {rel:.3e} (tol {tol:g})"
            f"{'' if ok else ' MISS'}")
        if not ok:
            raise AssertionError(f"narrow tracker {image_size}, {what}: the "
                                 "card disagrees with the CPU reference")

    def per_obj(feats, t):
        return [f[t][None].expand(B, *f.shape[1:]) for f in feats]

    def bank_to(bank, device):
        return VP.MemoryBank(*(x.clone().to(device) for x in bank))

    with torch.no_grad():
        rfeats, rpos = ref.forward_image(frames)
        dfeats, dpos = dev.forward_image(frames.cuda().bfloat16())
        reset_counts()
        rheads, rbank = VP.track_init_frame(ref, per_obj(rfeats, 0), rpos[-1], text)
        dheads, _ = VP.track_init_frame(dev, per_obj(dfeats, 0), dpos[-1],
                                        text.cuda())
        for name in ("low_res_multimasks", "ious", "object_score_logits",
                     "obj_ptr"):
            hold(getattr(dheads, name), getattr(rheads, name), f"frame 0 {name}")
        mem, _ = dev.encode_new_memory(
            dfeats[-1][:1].expand(B, *dfeats[-1].shape[1:]),
            rheads.high_res_masks.permute(0, 2, 3, 1).cuda(),
            rheads.object_score_logits.cuda(), binarize=True)
        hold(mem, rbank.cond_mem, "frame 0 memory (binarised)")
        for t in range(1, T):
            dbank = bank_to(rbank, "cuda")
            rheads, rbank = VP.track_step(ref, per_obj(rfeats, t), rpos[-1],
                                          rbank, t, T)
            dheads, dbank = VP.track_step(dev, per_obj(dfeats, t), dpos[-1],
                                          dbank, t, T)
            for name in ("low_res_multimasks", "ious", "object_score_logits"):
                hold(getattr(dheads, name), getattr(rheads, name),
                     f"frame {t} {name}")
            mem, _ = dev.encode_new_memory(
                dfeats[-1][t:t + 1].expand(B, *dfeats[-1].shape[1:]),
                rheads.high_res_masks.permute(0, 2, 3, 1).cuda(),
                rheads.object_score_logits.cuda())
            hold(mem, rbank.mem_ring[:, t % rbank.mem_ring.shape[1]],
                 f"frame {t} memory")
        stepped = read_counts()

        def free_run(sam, feats, pos, txt):
            heads, bank = VP.track_init_frame(sam, per_obj(feats, 0), pos[-1], txt)
            frames_ = [heads]
            for t in range(1, T):
                heads, bank = VP.track_step(sam, per_obj(feats, t), pos[-1],
                                            bank, t, T)
                frames_.append(heads)
            return frames_, bank

        rfree, rbank = free_run(ref, rfeats, rpos, text)
        dfree, dbank = free_run(dev, dfeats, dpos, text.cuda())
        reset_counts()
        res = VP.track_video(dev, dfeats, dpos, text.cuda())
        torch.cuda.synchronize()
        counts = read_counts()
    key = "attention_fwd[flash_d256]" if image_size == 1024 else "window_attention"
    n = cfg.memory_attention_layers * (T - 1)
    if counts[key] != n or stepped[key] != n:
        raise AssertionError(f"narrow tracker {image_size}: {key} launched "
                             f"{stepped[key]} and {counts[key]} times, expected {n}")
    E4 = 4 * cfg.low_res_size
    if tuple(res.low_res_masks.shape) != (B, T, E4, E4) \
            or not torch.isfinite(res.low_res_masks).all():
        raise AssertionError(f"narrow tracker {image_size}: free-running masks")
    if not torch.equal(res.low_res_masks, torch.stack(
            [h.low_res_masks[:, 0] for h in dfree], dim=1)):
        raise AssertionError(f"narrow tracker {image_size}: track_video does "
                             "not repeat the step-by-step free run")

    # the free runs, each on its own bank
    for name in ("mem_frame", "ptr_frame"):
        got, want = getattr(dbank, name).cpu(), getattr(rbank, name)
        if not torch.equal(got, want):
            raise AssertionError(f"narrow tracker {image_size}: free run's "
                                 f"{name} {got.tolist()} != {want.tolist()}")
    pick = lambda run: torch.stack([h.ious.argmax(dim=-1).cpu() for h in run], 1)
    gate = lambda run: torch.stack(
        [h.object_score_logits[:, 0].float().cpu() > 0 for h in run], 1)
    same = pick(dfree) == pick(rfree)                        # [B, T]
    if not torch.equal(gate(dfree), gate(rfree)):
        raise AssertionError(f"narrow tracker {image_size}: the object-score "
                             "gate fell differently on the card")
    agreed = same.long().cumprod(dim=1).bool()    # every argmax so far agreed
    flipped = ((dfree[0].high_res_masks.cpu() > 0)
               != (rfree[0].high_res_masks > 0)).float().mean().item()
    log(f"  narrow tracker {image_size}, free run: ring frames "
        f"{dbank.mem_frame[0].tolist()}, pointer frames "
        f"{dbank.ptr_frame[0].tolist()} equal to the reference's; "
        f"{int((~same).sum())} of {B * T} (object, frame) argmax choices "
        f"differed, {int(agreed.sum())} compared")
    if not agreed[:, 0].all():
        raise AssertionError(f"narrow tracker {image_size}: the conditioning "
                             "frame's argmax differs, nothing to compare")
    S_ring, P_ring = rbank.mem_ring.shape[1], rbank.ptr_ring.shape[1]
    for t in range(T):
        objs = agreed[:, t].nonzero()[:, 0]
        if not len(objs):
            continue
        what = f"free run frame {t} (objects {objs.tolist()})"
        hold(dfree[t].low_res_masks.cpu()[objs], rfree[t].low_res_masks[objs],
             f"{what} mask")
        hold(dfree[t].object_score_logits.cpu()[objs],
             rfree[t].object_score_logits[objs], f"{what} object score")
        if t == 0:
            a, w = dbank.cond_mem.cpu()[objs], rbank.cond_mem[objs]
            log(f"  narrow tracker {image_size}, {what} conditioning memory, "
                f"each side from its own binarised mask ({flipped:.3e} of the "
                f"pixels differ): rel L2 {((a - w).norm() / w.norm()).item():.3e}"
                ", not held")
            hold(dbank.cond_ptr.cpu()[objs], rbank.cond_ptr[objs],
                 f"{what} conditioning pointer")
        else:
            hold(dbank.mem_ring.cpu()[objs, t % S_ring],
                 rbank.mem_ring[objs, t % S_ring], f"{what} ring memory")
            hold(dbank.ptr_ring.cpu()[objs, t % P_ring],
                 rbank.ptr_ring[objs, t % P_ring], f"{what} ring pointer")
    log(f"  narrow tracker {image_size}: track_video finite masks "
        f"{tuple(res.low_res_masks.shape)}, {key} x{counts[key]}")


def make_train_batch(cfg, seed: int, device="cuda", dtype=None, rows=2,
                     videos=2, text_lens=(S_TEXT_TRAIN, 73),
                     t_sam=T_SAM_TRAIN):
    """One synthetic micro-batch in the shapes the data layer's collate
    gives: `videos` clips of 16 frames (`t_sam` of them for SAM), `rows`
    conversations of S_TEXT_TRAIN ids with one image placeholder and one or
    two [SEG] tokens, labels that ignore the prompt, and binary masks at
    GT_HW with all-ignore padding for the unused [SEG] slots."""
    import torch
    from videoglamm_torch.constants import (IGNORE_INDEX, IMAGE_TOKEN_INDEX,
                                            MASK_IGNORE_INDEX)
    dtype = dtype or torch.bfloat16
    g = torch.Generator().manual_seed(seed)
    T = cfg.num_frames
    S = S_TEXT_TRAIN
    ims, cls_, sam_s = (cfg.internvideo.image_size, cfg.clip.image_size,
                        cfg.sam2.image_size)
    frames = torch.randn(videos, T, ims, ims, 3, generator=g)
    context = torch.randn(videos, T, cls_, cls_, 3, generator=g)
    frames_sam = torch.randn(videos, t_sam, sam_s, sam_s, 3, generator=g)
    ids = torch.randint(1, 32000, (rows, S), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    gt = torch.full((rows, cfg.max_seg_tokens, t_sam, GT_HW, GT_HW),
                    float(MASK_IGNORE_INDEX))
    for r in range(rows):
        n_seg = 1 + r % 2
        for j in range(n_seg):
            ids[r, 20 + 9 * j] = cfg.seg_token_idx
        gt[r, :n_seg] = (torch.rand(n_seg, t_sam, GT_HW, GT_HW,
                                    generator=g) > 0.5).float()
    labels = ids.clone()
    labels[labels < 0] = IGNORE_INDEX
    labels[:, :10] = IGNORE_INDEX                   # the prompt
    lens = torch.tensor(text_lens[:rows])
    batch = dict(frames=frames.to(dtype), context_images=context.to(dtype),
                 frames_sam=frames_sam.to(dtype), input_ids=ids, text_lens=lens,
                 labels=labels, video_idx=torch.arange(rows) % videos,
                 gt_masks=gt)
    return {k: v.to(device) for k, v in batch.items()}


def phase_train(cfg, seed: int):
    """Four optimizer steps at flagship width through `build_training` and
    its train step; returns the launch counts of the four steps and their
    wall seconds."""
    import tempfile
    import torch
    from videoglamm_torch.config import TrainConfig
    from videoglamm_torch.io.checkpoint import CheckpointManager
    from videoglamm_torch.training import build_training

    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       grad_accum_steps=GRAD_ACCUM)
    t0 = time.perf_counter()
    tr = build_training(
        cfg, tcfg, device="cuda", dtype=torch.bfloat16,
        init=lambda m: seeded_init(
            m, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    params = tr.state.params
    trainable = set(tr.tx.trainable)
    n_train = sum(params[n].numel() for n in trainable)
    n_all = sum(p.numel() for p in params.values())
    lora_b = [p for n, p in params.items() if "lora_b" in n]
    if not lora_b or not all(float(p.detach().abs().max()) > 0 for p in lora_b):
        raise AssertionError("train: LoRA B is zero (A would get no gradient)")
    log(f"  flagship VideoGLaMM for training: {n_all / 1e9:.3f} B parameters, "
        f"{n_train / 1e9:.3f} B trainable in {len(trainable)} leaves (f32 "
        f"masters), LoRA rank {tcfg.lora.r}, remat, bf16 compute, built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    micro = [make_train_batch(cfg, seed + i) for i in range(GRAD_ACCUM)]
    batch = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
    positions = GRAD_ACCUM * batch["input_ids"].shape[1] * (
        S_TEXT_TRAIN - 1 + 16 * (144 + 64))
    t0 = time.perf_counter()
    frozen0 = {n: p.detach().cpu() for n, p in params.items()
               if n not in trainable}
    moved0 = {n: params[n].detach().clone() for n in
              ("llm.lm_head.weight", "llm.model.layers.0.self_attn.q_lora_a.weight",
               "text_hidden_fcs.0.0.weight",
               "visual_model.sam_mask_decoder.mask_tokens.weight")}
    log(f"  copy of the {len(frozen0)} frozen leaves on the host: "
        f"{time.perf_counter() - t0:.1f} s")

    state = tr.state
    losses, walls = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(TRAIN_STEPS):
        timings = {}
        t0 = time.perf_counter()
        state, metrics = tr.train_step(state, batch, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        walls.append(wall)
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {i}: non-finite loss {m}")
        log(f"  train step {i}: wall {wall:.3f} s, {positions / wall:.1f} LLM "
            f"positions/s ({positions} positions in {GRAD_ACCUM} micro-steps), "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + ", " + ", ".join(f"{k} {v:.4f}" for k, v in m.items()))
    counts = read_counts()
    log(f"  train: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at micro-batch "
        f"{batch['input_ids'].shape[1]} rows x {S_TEXT_TRAIN - 1 + 16 * 208} positions")
    log(f"  train: launches over {TRAIN_STEPS} optimizer steps: "
        + json.dumps(counts))
    n_micro = TRAIN_STEPS * GRAD_ACCUM
    for name, n in counts.items():
        per = EXPECTED_PER_MICRO_STEP.get(name)
        if per is None:
            if n == 0:
                raise AssertionError(f"{name} was never launched on the "
                                     "training path")
        elif n != per * n_micro:
            raise AssertionError(f"{name}: {n} launches on the training path, "
                                 f"expected {per} per micro-step x {n_micro}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses}")
    if state.step != TRAIN_STEPS or state.opt_state["count"] != TRAIN_STEPS:
        raise AssertionError(f"train: step counter {state.step}")
    t0 = time.perf_counter()
    changed = [n for n, ref in frozen0.items()
               if not torch.equal(params[n].detach().cpu(), ref)]
    if changed:
        raise AssertionError(f"train: frozen parameters changed: {changed[:4]}")
    del frozen0
    still = [n for n, ref in moved0.items() if torch.equal(params[n], ref)]
    if still:
        raise AssertionError(f"train: trainable parameters did not move: {still}")
    log(f"  train: losses {', '.join(f'{x:.4f}' for x in losses)}: last below "
        f"first; all frozen leaves bit-equal to their start, the sampled "
        f"trainable leaves moved ({time.perf_counter() - t0:.1f} s)")

    # checkpoint: save, step, restore, step again -> the same loss
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, max_to_keep=1)
        t0 = time.perf_counter()
        ckpt.save(state.step, state, metadata={"epoch": 0})
        t_save = time.perf_counter() - t0
        state5, m5 = tr.train_step(state, batch)
        loss5 = float(m5["loss"])
        t0 = time.perf_counter()
        back = ckpt.restore(state5)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        if back.step != TRAIN_STEPS or ckpt.restore_metadata() != {"epoch": 0}:
            raise AssertionError("train: the checkpoint's step or metadata")
        loss5b = profile_train_step(tr, back, batch)
    log(f"  train: checkpoint of the whole state saved in {t_save:.1f} s, "
        f"restored in {t_load:.1f} s; next-step loss {loss5:.6f} before, "
        f"{loss5b:.6f} after the restore")
    if not abs(loss5 - loss5b) <= 1e-6 * abs(loss5):
        raise AssertionError("train: the restored state does not repeat the "
                             "next step's loss")
    return counts, walls


def profile_train_step(tr, state, batch) -> float:
    """One optimizer step under torch.profiler: wall, device-busy share, the
    device launches and the kernels that take most device time. Returns the
    step's loss."""
    (_, metrics), rows = device_busy(lambda: tr.train_step(state, batch),
                                     "train step", top=12)
    if not rows:
        return float(metrics["loss"])
    busy_ms = sum(_device_us(e) for e in rows) / 1e3
    # K6's kernels by name, in the top list or not
    k6 = {part: [e for e in rows if f"flash_bwd_{part}" in e.key]
          for part in ("delta", "dq", "dkv")}
    if not all(k6.values()):
        raise AssertionError("train step: the profiler does not name K6's "
                             f"kernels: {sorted(e.key[:56] for e in rows)}")
    k6_ms = {p: sum(_device_us(e) for e in es) / 1e3 for p, es in k6.items()}
    log("  train step, K6 under the profiler: "
        + ", ".join(f"{p} {k6_ms[p]:.1f} ms x{sum(e.count for e in k6[p])}"
                    for p in k6)
        + f"; {sum(k6_ms.values()):.1f} ms of {busy_ms:.1f} busy "
        f"({sum(k6_ms.values()) / busy_ms:.3f})")
    return float(metrics["loss"])


def phase_small_train_reference(seed: int):
    """A narrow model at the real sequence length: one micro-step in bf16 on
    the card (K1 with LSE, K6, K3) against the same weights in f32 on the
    CPU through the plain twins; loss and every trainable leaf's gradient."""
    import torch
    from videoglamm_torch.config import LoRAConfig, TrainConfig
    from videoglamm_torch.training import build_training

    cfg = small_config()
    tcfg = TrainConfig(warmup_steps=0, grad_accum_steps=1, lora=LoRAConfig(r=4))
    ref = build_training(cfg, tcfg, device="cpu", dtype=torch.float32,
                         init=lambda m: seeded_init(
                             m, torch.Generator().manual_seed(5)))
    dev = build_training(cfg, tcfg, ref.model.state_dict(), device="cuda",
                         dtype=torch.bfloat16)
    batch = make_train_batch(cfg, seed, device="cpu", dtype=torch.float32,
                             rows=1, videos=1)
    out_ref = ref.model(**batch)
    out_ref.loss.backward()
    reset_counts()
    out = dev.model(**{k: (v.bfloat16() if v.is_floating_point()
                           and k != "gt_masks" else v).cuda()
                       for k, v in batch.items()})
    out.loss.backward()
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.llm.num_layers
    if counts["attention_fwd[causal]"] != 2 * L or counts["flash_bwd"] != L:
        raise AssertionError(f"small model (training): K1/K6 launches {counts}")
    for k in ("loss", "ce_loss", "mask_bce_loss", "mask_dice_loss"):
        a = float(getattr(out, k).detach())
        w = float(getattr(out_ref, k).detach())
        rel = abs(a - w) / max(abs(w), 1e-12)
        log(f"  small model (training), {k}: card bf16 {a:.5f} vs CPU f32 "
            f"{w:.5f} rel {rel:.3e} (tol {TOL_TRAIN_LOSS:g})")
        if not rel <= TOL_TRAIN_LOSS:
            raise AssertionError(f"small model (training) {k}: the card "
                                 "disagrees with the CPU reference")
    got = dict(dev.model.named_parameters())

    def group_of(n):
        return ("lora" if "lora_" in n else "lm_head" if "lm_head" in n else
                "embed_tokens" if "embed_tokens" in n else
                "text_hidden_fcs" if "text_hidden_fcs" in n else "mask_decoder")

    groups = {}     # group -> [sum |d|^2, sum |w|^2, [(|d|^2, |w|^2, name)]]
    for n in ref.tx.trainable:
        w = ref.state.params[n].grad
        if w is None:         # the mask decoder's unused IoU / score heads
            if got[n].grad is not None:
                raise AssertionError(f"small model (training): {n} has a "
                                     "gradient on the card only")
            continue
        a = got[n].grad.float().cpu()
        d2, w2 = float((a - w).norm()) ** 2, float(w.norm()) ** 2
        g = groups.setdefault(group_of(n), [0.0, 0.0, []])
        g[0], g[1] = g[0] + d2, g[1] + w2
        g[2].append((d2, w2, n))
    leaves = []
    for grp, (gd, gw, members) in sorted(groups.items()):
        log(f"  small model (training), gradients of {grp} ({len(members)} "
            f"leaves): card bf16 vs CPU f32 rel L2 {(gd / gw) ** 0.5:.3e}")
        # a leaf whose true gradient is zero (a softmax's key bias) holds
        # rounding on both sides; it counts in its group's total only
        leaves += [((d2 / w2) ** 0.5, n) for d2, w2, n in members
                   if w2 ** 0.5 > 1e-4 * gw ** 0.5]
    rel_all = (sum(g[0] for g in groups.values())
               / sum(g[1] for g in groups.values())) ** 0.5
    leaves.sort(reverse=True)
    worst = leaves[0]
    log(f"  small model (training), all trainable gradients: rel L2 "
        f"{rel_all:.3e} (tol {TOL_TRAIN_GRAD_ALL:g}); of {len(leaves)} leaves "
        f"with a gradient the worst (tol {TOL_TRAIN_GRAD:g}): "
        + ", ".join(f"{n} {r:.3e}" for r, n in leaves[:3]))
    if not (rel_all <= TOL_TRAIN_GRAD_ALL and worst[0] <= TOL_TRAIN_GRAD):
        raise AssertionError("small model (training): gradients on the card "
                             "disagree with the CPU reference")


# ---------------------------------------------------------------------------
# train through the CLI: dataset files -> samples -> collated micro-batches
# -> the prefetch thread's copy onto the card -> the train step -> Trainer
# ---------------------------------------------------------------------------
CLI_STEPS = 3           # optimizer steps of the CLI's one epoch
CLI_BATCH = 2           # samples (one conversation each) a micro-batch
CLI_VAL_SAMPLES = 2


class WordTokenizer:
    """A word-level stand-in for the HF tokenizer: stateless (the loader
    thread and the validators call it at once), `[SEG]` (also inside
    "[SEG].") at the config's seg id, every other word hashed into the
    base vocabulary."""
    bos_token_id = 1

    def __init__(self, seg_id: int, vocab: int):
        self.seg_id, self.vocab = seg_id, vocab

    def __call__(self, text):
        import re
        import types
        import zlib
        ids = [self.bos_token_id]
        for w in re.findall(r"\[SEG\]|\S+", text):
            ids.append(self.seg_id if w == "[SEG]"
                       else 10 + zlib.crc32(w.encode()) % (self.vocab - 10))
        return types.SimpleNamespace(input_ids=ids)


def _smooth_frame(rng, h=RAW_H, w=RAW_W):
    """A 480x854 RGB frame with the low-frequency content of a photo (a
    bilinear blow-up of a 6x10 grid) and mild noise, so its JPEG decodes at
    a photo's cost rather than noise's."""
    import numpy as np
    from PIL import Image
    small = Image.fromarray(rng.randint(0, 256, (6, 10, 3), np.uint8))
    img = np.asarray(small.resize((w, h), Image.BILINEAR), np.int16)
    img = img + rng.randint(-6, 7, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _blob(rng, h=RAW_H, w=RAW_W):
    import numpy as np
    y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
    m = np.zeros((h, w), bool)
    m[y0:y0 + rng.randint(h // 8, h // 2), x0:x0 + rng.randint(w // 8, w // 2)] = True
    return m


def write_train_fixture(root: str, seed: int) -> dict:
    """Synthetic training data at the main path's 480x854 frames, from the
    seed: a GCG train.json over frame directories with RLE object masks
    (2 videos, 8 frames, 2 objects), a MeViS-layout root (2 videos, 6
    frames, one expression each, RLE masks in mask_dict.json), ReasonSeg
    train and val images with their polygon JSON (2 each), and a VQA file
    over 2 images. Returns the CLI's paths."""
    import os
    import numpy as np
    from PIL import Image
    from videoglamm_torch.data.rle import rle_encode
    rng = np.random.RandomState(seed)

    def save(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, quality=90)

    videos, anns = [], []
    for v in range(2):
        n = 8
        names = [f"v{v}/{t:05d}.jpg" for t in range(n)]
        for f in names:
            save(os.path.join(root, "gcg", "frames", f), _smooth_frame(rng))
        mask_ids = []
        for o in range(2):
            aid = 10 * v + o
            segs = [rle_encode(_blob(rng)) if (t + o) % 3 else None
                    for t in range(n)]
            anns.append({"id": aid, "segmentations": segs})
            mask_ids.append(aid)
        videos.append({"file_names": names, "width": RAW_W, "height": RAW_H,
                       "length": n, "dense_cap": {
                           "caption": f"a striped cat {v} chases the red ball "
                                      "across the kitchen floor",
                           "token_pos": [2, 7], "mask_id": mask_ids,
                           "v_id2o_id": {}}})
    os.makedirs(os.path.join(root, "gcg"), exist_ok=True)
    with open(os.path.join(root, "gcg", "train.json"), "w") as f:
        json.dump({"videos": videos, "annotations": anns}, f)

    meta, mask_dict = {"videos": {}}, {}
    for v in range(2):
        for t in range(6):
            save(os.path.join(root, "mevis", "JPEGImages", f"vid{v}",
                              f"{t:05d}.jpg"), _smooth_frame(rng))
        mask_dict[str(100 + v)] = [rle_encode(_blob(rng)) if t != 2 else None
                                   for t in range(6)]
        meta["videos"][f"vid{v}"] = {"expressions": {"0": {
            "exp": f"the dog {v} that jumps first", "anno_id": [100 + v]}},
            "frames": [f"{t:05d}" for t in range(6)]}
    with open(os.path.join(root, "mevis", "meta_expressions.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(root, "mevis", "mask_dict.json"), "w") as f:
        json.dump(mask_dict, f)

    for split in ("train", "val"):
        for i in range(2):
            save(os.path.join(root, "reason", split, f"x{i}.jpg"),
                 _smooth_frame(rng))
            x0, y0 = rng.randint(50, 300), rng.randint(50, 200)
            anno = {"text": "the object that holds the most water" if i == 0
                    else "cup", "is_sentence": i == 0, "shapes": [
                        {"label": "target", "points": [
                            [x0, y0], [x0 + 300, y0], [x0 + 280, y0 + 220],
                            [x0 + 20, y0 + 200]]},
                        {"label": "ignore", "points": [
                            [10, 400], [120, 400], [120, 470], [10, 470]]}]}
            with open(os.path.join(root, "reason", split, f"x{i}.json"), "w") as f:
                json.dump(anno, f)

    for i in range(2):
        save(os.path.join(root, "vqa", "media", f"p{i}.jpg"), _smooth_frame(rng))
    with open(os.path.join(root, "vqa", "ann.json"), "w") as f:
        json.dump([{"image": f"p{i}.jpg", "conversations": [
            {"from": "human", "value": "What is shown in the picture?"},
            {"from": "gpt", "value": "A blurred scene with soft colours."}]}
            for i in range(2)], f)
    return dict(gcg_json=os.path.join(root, "gcg", "train.json"),
                gcg_frames=os.path.join(root, "gcg", "frames"),
                mevis=os.path.join(root, "mevis"),
                reason=os.path.join(root, "reason"),
                vqa_json=os.path.join(root, "vqa", "ann.json"),
                vqa_media=os.path.join(root, "vqa", "media"))


def time_host_loader(cfg, tok, paths, smi: str):
    """Host seconds to build samples of each dataset and to collate one
    micro-batch, on this thread with the card idle; fails unless every
    row fits S_TEXT_TRAIN ids with all its [SEG] tokens."""
    import numpy as np
    from videoglamm_torch.data.collate import build_batch
    from videoglamm_torch.data.datasets import (
        GCGVideoDataset, ReasonSegDataset, ReferVOSDataset, SampleBuilder,
        VQADataset)
    builder = SampleBuilder(cfg, tok, max_text_len=S_TEXT_TRAIN,
                            num_frames_for_sam=T_SAM_TRAIN)
    sets = {"video_gcg": GCGVideoDataset(paths["gcg_json"], paths["gcg_frames"],
                                         max_num_frames=T_SAM_TRAIN),
            "refer_vos": ReferVOSDataset(paths["mevis"]),
            "reason_seg": ReasonSegDataset(paths["reason"]),
            "vqa": VQADataset(paths["vqa_json"], paths["vqa_media"])}
    per, samples = {}, []
    for name, ds in sets.items():
        for i in range(len(ds)):
            t0 = time.perf_counter()
            rec = ds[i]
            t1 = time.perf_counter()
            s = builder(rec)
            per.setdefault(name, []).append((t1 - t0, time.perf_counter() - t1))
            samples.append(s)
            for (ids, _), m in zip(s["conversations"], s["masks"]):
                n_seg = int((np.asarray(ids) == cfg.seg_token_idx).sum())
                want = 0 if m is None else len(m)
                if len(ids) >= S_TEXT_TRAIN or n_seg != want:
                    raise AssertionError(
                        f"train fixture: a {name} row of {len(ids)} ids holds "
                        f"{n_seg} [SEG] for {want} masks (max {S_TEXT_TRAIN})")
    t0 = time.perf_counter()
    build_batch(samples[:CLI_BATCH], max_text_len=S_TEXT_TRAIN,
                mask_hw=builder.mask_hw)
    t_collate = time.perf_counter() - t0
    # the three host preprocessors apart, on the first GCG record's frames
    from videoglamm_torch.data.preprocess import (
        preprocess_clip, preprocess_internvideo, preprocess_sam2)
    frames = sets["video_gcg"][0]["frames"]
    idx = [i * len(frames) // cfg.num_frames for i in range(cfg.num_frames)]
    stages = {}
    for name, fn, fs, size in (
            ("internvideo", preprocess_internvideo, [frames[i] for i in idx],
             cfg.internvideo.image_size),
            ("clip", preprocess_clip, [frames[i] for i in idx], cfg.clip.image_size),
            ("sam2", preprocess_sam2, frames[:T_SAM_TRAIN], cfg.sam2.image_size)):
        t0 = time.perf_counter()
        fn(fs, size)
        stages[f"{name} x{len(fs)}"] = time.perf_counter() - t0
    all_s = [a + b for v in per.values() for a, b in v]
    log(f"  train CLI, host loader on one thread ({smi}): a sample "
        f"{statistics.mean(all_s):.3f} s mean ({min(all_s):.3f}-"
        f"{max(all_s):.3f}); by dataset, read + build: "
        + "; ".join(f"{k} " + ", ".join(f"{a:.3f} + {b:.3f}" for a, b in v)
                    for k, v in per.items())
        + f"; collating a micro-batch of {CLI_BATCH} {t_collate:.3f} s; "
        "a GCG sample's preprocessors: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in stages.items()))
    return statistics.mean(all_s), t_collate


def phase_train_cli(cfg, seed: int, train_counts: dict, train_walls, smi: str):
    """`videoglamm_torch.cli.train.main` at flagship width from dataset
    files written here: CLI_STEPS optimizer steps of GRAD_ACCUM micro-steps
    of CLI_BATCH one-row samples at S_TEXT_TRAIN ids (the LLM sees
    [2,3456,3072], as in phase_train), the epoch checkpoint, both
    validators. The weights are seeded on the card and handed over by
    patching `load_model`, the tokenizer by patching `load_tokenizer`.
    Returns the launch counts of the CLI's training steps."""
    import os
    import tempfile
    import torch
    from videoglamm_torch.cli import train as cli
    from videoglamm_torch.models.videoglamm import VideoGLaMM

    tok = WordTokenizer(cfg.seg_token_idx, cfg.llm.vocab_size)

    def seeded_state_dict(args, cfg_=None):
        with torch.device("cuda"):
            m = VideoGLaMM(cfg)
        m.to("cuda")      # tensors made from numpy ignore the device context
        seeded_init(m, torch.Generator(device="cuda").manual_seed(0))
        return m.state_dict()

    checked, snaps, val_s = [], [], []
    orig_prefetch, orig_val = cli.prefetch_to_device, cli.make_val_fn

    class FirstBatchChecked:
        """The consumer side of the CLI's prefetcher: the first device
        batch, copied back, must be bit-equal to the host batch it came
        from (pixels compared after the same cast to bf16)."""

        def __init__(self, it, host):
            self.it, self.host = it, host

        def __iter__(self):
            return self

        def __next__(self):
            dev = next(self.it)
            if not checked:
                host = self.host[0]
                bad = [k for k in host if not (
                    dev[k].is_cuda and torch.equal(
                        dev[k].cpu(), host[k].to(dev[k].dtype)))]
                checked.append(bad)
                if bad or dev["frames"].dtype != torch.bfloat16:
                    raise AssertionError(f"train CLI: the device batch differs "
                                         f"from its host batch in {bad}")
            return dev

        def close(self):
            self.it.close()

    def prefetch_checked(batches, to_device, prefetch=2):
        host = []

        def keep(gen):
            for b in gen:
                if not host:
                    host.append({k: v.clone() for k, v in b.items()})
                yield b
        return FirstBatchChecked(orig_prefetch(keep(batches), to_device,
                                               prefetch), host)

    def make_val_fn(*a, **kw):
        fn = orig_val(*a, **kw)

        def val_fn(state, epoch, logger):
            torch.cuda.synchronize()
            snaps.append(read_counts())
            t0 = time.perf_counter()
            fn(state, epoch, logger)
            torch.cuda.synchronize()
            val_s.append(time.perf_counter() - t0)
        return val_fn

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        paths = write_train_fixture(os.path.join(d, "data"), seed)
        log(f"  train CLI: fixture written in {time.perf_counter() - t0:.1f} s "
            f"(4 datasets, 34 JPEG frames of {RAW_H}x{RAW_W})")
        sample_s, collate_s = time_host_loader(cfg, tok, paths, smi)
        argv = ["--checkpoint", "seeded", "--tokenizer", "word-level",
                "--gcg_json", paths["gcg_json"], "--gcg_frames", paths["gcg_frames"],
                "--refer_vos_root", paths["mevis"],
                "--reason_seg_root", paths["reason"],
                "--vqa_json", paths["vqa_json"],
                "--vqa_media_root", paths["vqa_media"],
                "--sample_rates", "1,1,1,1", "--batch_size", str(CLI_BATCH),
                "--grad_accum", str(GRAD_ACCUM), "--max_text_len",
                str(S_TEXT_TRAIN), "--num_frames_for_sam", str(T_SAM_TRAIN),
                "--epochs", "1", "--steps_per_epoch", str(CLI_STEPS),
                "--val_mevis_root", paths["mevis"],
                "--val_reason_seg_root", paths["reason"],
                "--val_samples", str(CLI_VAL_SAMPLES),
                "--ckpt_dir", os.path.join(d, "ckpt"),
                "--log_dir", os.path.join(d, "log")]
        log("  train CLI: python -m videoglamm_torch.cli.train "
            + " ".join(a if not a.startswith(d) else a.replace(d, "$TMP")
                       for a in argv))
        patched = dict(load_model=seeded_state_dict,
                       load_tokenizer=lambda path: tok,
                       prefetch_to_device=prefetch_checked,
                       make_val_fn=make_val_fn)
        saved = {k: getattr(cli, k) for k in patched}
        for k, v in patched.items():
            setattr(cli, k, v)
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        try:
            trainer = cli.main(argv)
        finally:
            for k, v in saved.items():
                setattr(cli, k, v)
        t_main = time.perf_counter() - t0
        torch.cuda.synchronize()
        ckpt = os.path.join(d, "ckpt", str(CLI_STEPS))
        have_ckpt = os.path.exists(os.path.join(ckpt, "state.pt"))
        with open(os.path.join(d, "log", "scalars.jsonl")) as f:
            scalars = {r["tag"]: r["value"] for r in map(json.loads, f)
                       if r["tag"].startswith("val/")}
    hist = trainer.history
    for h in hist:
        log(f"  train CLI step {h['step']}: wall {h['step_s']:.3f} s, waiting "
            f"on next(batches) {h['data_s']:.3f} s ({h['data_s'] / h['step_s']:.3f} "
            f"of the step), " + ", ".join(
                f"{k} {h[k]:.4f}" for k in ("loss", "ce_loss", "mask_bce_loss",
                                            "mask_dice_loss")) + f" ({smi})")
    steady = [h["step_s"] for h in hist[1:]]
    log(f"  train CLI: steps after the first {', '.join(f'{x:.3f}' for x in steady)} "
        f"s against phase_train's {', '.join(f'{x:.3f}' for x in train_walls[1:])} "
        f"s; loader {sample_s:.3f} s a sample x {CLI_BATCH * GRAD_ACCUM} a step "
        f"+ {GRAD_ACCUM} collations of {collate_s:.3f} s on one thread; "
        f"checkpoint {', '.join(f'{x:.1f}' for x in trainer.ckpt_seconds)} s; "
        f"validators {', '.join(f'{x:.1f}' for x in val_s)} s; main() "
        f"{t_main:.1f} s in all ({smi})")
    if len(hist) != CLI_STEPS or trainer.state.step != CLI_STEPS:
        raise AssertionError(f"train CLI: {len(hist)} steps, state step "
                             f"{trainer.state.step}")
    for h in hist:
        if not all(math.isfinite(h[k]) for k in ("loss", "ce_loss",
                                                 "mask_bce_loss", "mask_dice_loss")):
            raise AssertionError(f"train CLI step {h['step']}: non-finite loss {h}")
        if not h["mask_bce_loss"] > 0:
            raise AssertionError(f"train CLI step {h['step']}: mask_bce_loss 0 "
                                 "(no [SEG] reached the mask decoder)")
    if checked != [[]]:
        raise AssertionError("train CLI: the first device batch was not checked")
    if not have_ckpt or len(trainer.ckpt_seconds) != 1:
        raise AssertionError("train CLI: no epoch checkpoint")
    want = {f"val/{v}/{m}" for v in ("mevis", "reason_seg") for m in ("giou", "ciou")}
    if set(scalars) != want or not all(math.isfinite(x) for x in scalars.values()):
        raise AssertionError(f"train CLI: validator scalars {scalars}")
    log("  train CLI: validators " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in sorted(scalars.items())))
    if len(snaps) != 1:
        raise AssertionError(f"train CLI: {len(snaps)} validation passes")
    counts = snaps[0]
    per_step = {k: v / CLI_STEPS for k, v in counts.items()}
    differ = {k: (per_step[k], train_counts[k] / TRAIN_STEPS) for k in counts
              if counts[k] * TRAIN_STEPS != train_counts[k] * CLI_STEPS}
    log("  train CLI: launches a step " + json.dumps(
        {k: v for k, v in per_step.items() if v}))
    if differ:
        raise AssertionError("train CLI: launches a step differ from "
                             f"phase_train's (CLI, phase_train): {differ}")
    log("  train CLI: launches a step equal phase_train's for every kernel; "
        "the first device batch is bit-equal to its host batch")
    return counts


# ---------------------------------------------------------------------------
# predictors: the SAM-2 image predictor, the automatic mask generator and
# the interactive video predictor
# ---------------------------------------------------------------------------
# one image-encoder forward of Hiera-L at 1024, whatever its batch: 3
# global blocks on K1 flash, 42 fused window blocks (K1 window mode, 4 K2
# products and 2 K3 norms each), and K3 on the one 1152-wide norm of the
# stage-4 pooling block (Hiera's other norms are 144, 288 and 576 wide,
# which K3's gate leaves to the plain twin). All K1 launches take the
# "wgmma" route.
ENCODE = {"attention_fwd[flash]": 3, "attention_fwd[window]": 42,
          "fused_window_block": 42, "gemm_epilogue": 168,
          "row_norm[ln]": 2 * 42 + 1, "k1_route[wgmma]": 45,
          "attention_fwd[flash_d256]": 0, "k1_route[wgmma_f32]": 0,
          "stage_bf16": 0, "attention_fwd[bshd]": 0, "window_attention": 0}
ENCODE_KERNELS = ("attention_fwd[flash]", "attention_fwd[window]",
                  "fused_window_block", "gemm_epilogue", "k1_route[wgmma]")
N_PROPAGATE_FRAMES = 16
N_OBJECTS = 2
AMG_SMALL_GRID = 8      # points a side of the crop pass (5 crops, m2m)
TOL_PRED_REF = 2e-2     # relative L2, narrow SAM-2 in bf16 on the card vs f32
                        # on the CPU: bf16 image features, f32 heads (as
                        # TOL_TRACK_REF)
TOL_STABILITY = 5e-2    # |d| of a stability score (a ratio of pixel counts
                        # whose boundary pixels move with bf16 logits)


def check_launches(counts: dict, want: dict, what: str):
    bad = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
    if bad:
        raise AssertionError(f"{what}: launches (got, expected) {bad}")


def _wall(fn):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def _blob_masks(B: int, S: int):
    """User-drawn masks: one rectangle an object, the second with a hole."""
    import torch
    m = torch.zeros(B, S, S)
    for b in range(B):
        y0, x0 = (S // 8) * (b + 1), (S // 6) * (b + 1)
        m[b, y0:y0 + S // 3, x0:x0 + S // 4] = 1.0
    if B > 1:
        m[1, S // 4 + S // 16:S // 4 + S // 8, S // 3 + S // 16:S // 3 + S // 8] = 0.0
    return m


def phase_predictors(smi: str) -> dict:
    """The three SAM-2 surfaces at flagship width (`SAM2Config()`: Hiera-L
    at 1024, seeded random weights, bf16 image encoder, f32 heads) through
    `build_sam2`, with the launch counters set to 0 just before each path
    and read just after it. Returns the counts of the interactive session's
    propagations (K1 at head dim 256) and of one image encode."""
    import torch
    import numpy as np
    from videoglamm_torch.config import SAM2Config
    from videoglamm_torch.inference.pipeline import build_sam2
    from videoglamm_torch.models.sam2.amg import (SAM2AutomaticMaskGenerator,
                                                  generate_crop_boxes)
    from videoglamm_torch.models.sam2.image_predictor import SAM2ImagePredictor
    from videoglamm_torch.models.sam2.interactive import (
        SAM2InteractivePredictor, propagation_frames)
    from videoglamm_torch.ops.connected_components import connected_components
    from videoglamm_torch.ops.preprocess import preprocess_sam_stream

    cfg = SAM2Config()
    t0 = time.perf_counter()
    sam = build_sam2(cfg, device="cuda", dtype=torch.bfloat16,
                     init=lambda m: seeded_init(
                         m, torch.Generator(device="cuda").manual_seed(5)))
    torch.cuda.synchronize()
    log(f"  SAM-2 Hiera-L at {cfg.image_size}: "
        f"{sum(p.numel() for p in sam.parameters()) / 1e6:.1f} M parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(51)
    frames = torch.randint(0, 256, (N_PROPAGATE_FRAMES, RAW_H, RAW_W, 3),
                           dtype=torch.uint8, generator=g, device="cuda")
    E4 = 4 * cfg.low_res_size

    # --- image predictor -------------------------------------------------
    pred = SAM2ImagePredictor(sam, max_hole_area=64.0, max_sprinkle_area=64.0)
    pred.set_image(frames[0])                                  # warm-up
    reset_counts()
    _, enc_ms = _wall(lambda: pred.set_image(frames[0]))
    encode_counts = read_counts()
    check_launches(encode_counts, ENCODE, "set_image (one Hiera-L encode)")
    pts = np.array([[300.0, 200.0], [520.0, 260.0]])
    pred.predict(point_coords=pts, point_labels=np.array([1, 0]))   # warm-up
    reset_counts()
    (masks, ious, low), pt_ms = _wall(lambda: pred.predict(
        point_coords=pts, point_labels=np.array([1, 0]), multimask_output=True))
    check_launches(read_counts(), {k: 0 for k in ENCODE_KERNELS},
                   "predict (the decoder launches no encoder kernel)")
    if masks.shape != (3, RAW_H, RAW_W) or ious.shape != (3,) \
            or low.shape != (3, E4, E4) or not np.isfinite(low).all():
        raise AssertionError(f"predict: shapes {masks.shape} {ious.shape} {low.shape}")
    (bm, bi, bl), box_ms = _wall(lambda: pred.predict(
        box=np.array([100.0, 80.0, 600.0, 400.0]), multimask_output=False))
    best = int(np.argmax(ious))
    (rm, ri, rl), ref_ms = _wall(lambda: pred.predict(
        point_coords=pts, point_labels=np.array([1, 0]),
        mask_input=low[best:best + 1], multimask_output=False))
    if rm.shape != (1, RAW_H, RAW_W) and rm.shape != (RAW_H, RAW_W):
        raise AssertionError(f"refinement: shape {rm.shape}")
    if not (np.isfinite(bl).all() and np.isfinite(rl).all()
            and np.abs(rl).max() <= 32.0):
        raise AssertionError("predict: box / refinement logits")
    reset_counts()
    _, batch_ms = _wall(lambda: pred.set_image_batch(list(frames[:4])))
    check_launches(read_counts(), ENCODE, "set_image_batch of 4 (one encode)")
    (bmasks, bious, blows), pb_ms = _wall(lambda: pred.predict_batch(
        point_coords_batch=[pts[:1]] * 4, point_labels_batch=[np.array([1])] * 4))
    if len(bmasks) != 4 or bmasks[0].shape != (3, RAW_H, RAW_W):
        raise AssertionError("predict_batch: shapes")
    # connected components alone at the predictor's shape: 3 masks of the
    # low-res logits
    lowt = torch.from_numpy(low).cuda()
    _, cc_ms = _wall(lambda: connected_components(lowt > 0))
    log(f"  image predictor, raw [{RAW_H},{RAW_W},3] uint8: set_image {enc_ms:.1f} ms "
        f"(launches {', '.join(f'{k} {encode_counts[k]}' for k in ENCODE if encode_counts[k])}); "
        f"predict 2 points x3 masks {pt_ms:.1f} ms, box {box_ms:.1f} ms, "
        f"refinement with mask_input {ref_ms:.1f} ms (hole and sprinkle "
        f"filling on: connected components run); set_image_batch of 4 "
        f"{batch_ms:.1f} ms, predict_batch {pb_ms:.1f} ms; connected "
        f"components alone on [3,{E4},{E4}] {cc_ms:.2f} ms [{smi}]")

    # --- automatic mask generator ------------------------------------------
    img = torch.randint(0, 256, (cfg.image_size, cfg.image_size, 3),
                        dtype=torch.uint8, generator=g, device="cuda")

    def amg_pass(what, **kw):
        gen = SAM2AutomaticMaskGenerator(sam, **kw)
        n_crops = len(generate_crop_boxes(img.shape[:2], gen.crop_n_layers,
                                          gen.crop_overlap_ratio)[0])
        timings = {}
        reset_counts()
        recs, ms = _wall(lambda: gen.generate(img, timings=timings))
        counts = read_counts()
        want = {k: ENCODE[k] * n_crops for k in ENCODE_KERNELS}
        want["attention_fwd[flash_d256]"] = 0
        check_launches(counts, want, f"AMG {what}")
        if counts["row_norm[ln]"] < ENCODE["row_norm[ln]"] * n_crops:
            raise AssertionError(f"AMG {what}: K3 launched {counts['row_norm[ln]']} times")
        for r in recs:
            if not (0 <= r["area"] <= img.shape[0] * img.shape[1]) \
                    or not np.isfinite(r["predicted_iou"]):
                raise AssertionError(f"AMG {what}: record {r['bbox']}")
        stages = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(
            timings.items(), key=lambda kv: -kv[1]))
        cc = timings.get("connected_components", 0.0)
        log(f"  AMG {what}: {len(recs)} records in {ms:.1f} ms over {n_crops} "
            f"crop(s); stage ms: {stages}; connected components "
            f"{cc / max(sum(timings.values()), 1e-12):.3f} of the pass; K1 "
            f"{counts['k1_route[wgmma]']}, K2 {counts['gemm_epilogue']}, K3 "
            f"{counts['row_norm[ln]']} launches [{smi}]")
        return gen, recs

    gen, _ = amg_pass("warm-up, 32x32 grid, JAX defaults")
    gen, recs = amg_pass("32x32 grid, points_per_batch 64, JAX defaults")
    device_busy(lambda: gen.generate(img), "one AMG pass at the JAX defaults", smi)
    _, recs0 = amg_pass("32x32 grid, pred_iou_thresh=0, stability_score_thresh=0",
                        pred_iou_thresh=0.0, stability_score_thresh=0.0,
                        output_mode="coco_rle")
    if not recs0:
        raise AssertionError("AMG with zero thresholds: no record")
    amg_pass(f"{AMG_SMALL_GRID}x{AMG_SMALL_GRID} grid, crop_n_layers=1, "
             "use_m2m, min_mask_region_area=100",
             points_per_side=AMG_SMALL_GRID, crop_n_layers=1, use_m2m=True,
             min_mask_region_area=100, pred_iou_thresh=0.0,
             stability_score_thresh=0.0)
    del gen, recs, recs0
    torch.cuda.empty_cache()

    # --- interactive video predictor ---------------------------------------
    T, B = N_PROPAGATE_FRAMES, N_OBJECTS
    with torch.no_grad():
        sam_frames = preprocess_sam_stream(frames, cfg.image_size)
    reset_counts()
    sess, sess_ms = _wall(lambda: SAM2InteractivePredictor(
        sam, sam_frames, num_objects=B, non_overlap_masks=True,
        clear_non_cond_mem_around_input=True,
        clear_non_cond_mem_for_multi_obj=True))
    check_launches(read_counts(), ENCODE, f"interactive: encode of {T} frames")
    reset_counts()
    m0, pm = _wall(lambda: sess.add_new_points(
        0, np.array([[[300.0, 200.0]], [[700.0, 600.0]]]) * cfg.image_size / 1024,
        np.ones((B, 1), np.int32)))
    m8, bx = _wall(lambda: sess.add_new_box(
        8, np.array([[100.0, 100.0, 500.0, 400.0], [520, 300, 900, 800]])))
    m15, mk = _wall(lambda: sess.add_new_mask(15, _blob_masks(B, cfg.image_size)))
    check_launches(read_counts(), {"attention_fwd[flash_d256]": 0,
                                   **{k: 0 for k in ENCODE_KERNELS}},
                   "interactive prompts (fresh cond frames: no memory attention)")
    for what, m in (("points", m0), ("box", m8), ("mask", m15)):
        if tuple(m.shape) != (B, E4, E4) or not torch.isfinite(m).all():
            raise AssertionError(f"interactive {what} prompt: {tuple(m.shape)}")
    prop_counts = {}
    for what, kw in (("forward from 0", dict()),
                     ("reverse from 15", dict(start_frame_idx=T - 1, reverse=True))):
        start, end = sess.propagation_range(**kw)
        pinned = np.zeros(T, bool)
        pinned[list(sess.pinned)] = True
        n = len(propagation_frames(T, start, end, kw.get("reverse", False),
                                   sess.bank.cond_frame, pinned))
        reset_counts()
        out, ms = _wall(lambda: sess.propagate_in_video(**kw))
        counts = read_counts()
        layers = cfg.memory_attention_layers
        check_launches(counts, {"attention_fwd[flash_d256]": layers * n,
                                "k1_route[wgmma_f32]": layers * n,
                                "stage_bf16": layers * n,
                                "k1_route[wgmma]": 0, "window_attention": 0},
                       f"propagation {what} ({n} frames)")
        for k, v in counts.items():
            prop_counts[k] = prop_counts.get(k, 0) + v
        if tuple(out.shape) != (B, T, E4, E4) or not torch.isfinite(out).all():
            raise AssertionError(f"propagation {what}: {tuple(out.shape)}")
        log(f"  interactive propagation {what}: {n} frames, {ms:.1f} ms, "
            f"{ms / max(n, 1):.1f} ms a frame ({B} objects); K1 at head dim "
            f"256 x{counts['attention_fwd[flash_d256]']} + staging "
            f"x{counts['stage_bf16']} [{smi}]")
    vid = sess.to_video_res((RAW_H, RAW_W))
    if tuple(vid.shape) != (B, T, RAW_H, RAW_W) or not torch.isfinite(vid).all() \
            or int(((vid > -10.0).sum(dim=0) > 1).sum()) != 0:
        raise AssertionError("to_video_res with non_overlap_masks")
    log(f"  interactive session: {T} raw frames encoded in {sess_ms:.1f} ms "
        f"(one forward), points {pm:.1f} ms (the session's first decode), "
        f"box {bx:.1f} ms, mask {mk:.1f} ms; "
        f"to_video_res {tuple(vid.shape)}, at most one object above -10 a pixel "
        f"[{smi}]")
    device_busy(lambda: sess.propagate_in_video(),
                "one forward propagation (13 frames, 2 objects)", smi)
    del sess, vid, sam, pred
    torch.cuda.empty_cache()
    return prop_counts, encode_counts


def hold_close(who, got, want, what, tol=TOL_PRED_REF):
    """Card output against the CPU f32 reference by relative L2."""
    import torch
    a = torch.as_tensor(got).float().cpu()
    w = torch.as_tensor(want).float()
    rel = ((a - w).norm() / w.norm().clamp_min(1e-12)).item()
    ok = rel <= tol and bool(torch.isfinite(a).all())
    log(f"  {who}, {what} {tuple(w.shape)}: card vs CPU f32 rel L2 "
        f"{rel:.3e} (tol {tol:g}){'' if ok else ' MISS'}")
    if not ok:
        raise AssertionError(f"{who}, {what}: the card disagrees with the CPU "
                             "reference")


def hold_masks(who, got, want_logits, what, thr=0.0):
    """Binary card output equal to the thresholded CPU logits wherever a
    logit lies farther than TOL_PRED_REF * max|ref| from the threshold;
    fails if no pixel lies that far."""
    import torch
    w = torch.as_tensor(want_logits).float()
    band = TOL_PRED_REF * w.abs().max().item()
    far = (w - thr).abs() > band
    got = torch.as_tensor(got).bool().cpu()
    bad = int((got[far] != (w > thr)[far]).sum())
    log(f"  {who}, {what}: {bad} of {int(far.sum())} pixels outside the band "
        f"+-{band:.3g} differ ({int((~far).sum())} inside, not held)")
    if not far.any():
        raise AssertionError(f"{who}, {what}: no pixel outside the band")
    if bad:
        raise AssertionError(f"{who}, {what}: binary output differs")


def check_amg_records(gens, binm, up, ious, img, who="narrow SAM-2"):
    """The AMG's device-side filter and run boundaries on the card against
    the CPU. `gens`: the CPU and card generators, thresholds at 0 and NMS
    at IoU 1; binm: the CPU's binary masks of the one grid batch [N, H, W];
    up: its upscaled logits (f32, CPU); ious: each side's IoU predictions
    [P, M] of that batch.

    - `rles_from_device_masks` on the card equals the CPU's bit for bit on
      the same masks (with an empty and a full one, placed at an offset on a
      larger canvas), and the CPU's equals `rle_encode` of the canvases;
    - `generate` on both keeps all N candidates. Each record goes back to
      its candidate by its point and its IoU. A candidate's box is held
      exactly where the reference's row and column maxima lie outside the
      band on both sides of the box's edges (where the edge cannot move);
      the decoded RLEs are held pixel by pixel outside the band."""
    import torch
    import numpy as np
    from videoglamm_torch.data.rle import rle_decode, rle_encode
    from videoglamm_torch.models.sam2.amg import rles_from_device_masks

    N, H, W = binm.shape
    masks = torch.cat([binm, torch.zeros(1, H, W, dtype=torch.bool),
                       torch.ones(1, H, W, dtype=torch.bool)])
    (x0, y0), canvas_hw = (37, 21), (H + 50, W + 80)
    want = rles_from_device_masks(masks, (x0, y0), canvas_hw)
    got = rles_from_device_masks(masks.cuda(), (x0, y0), canvas_hw)
    canvas = np.zeros((len(masks), *canvas_hw), bool)
    canvas[:, y0:y0 + H, x0:x0 + W] = masks.numpy()
    enc = [rle_encode(c, compress=False) for c in canvas]
    runs = sum(len(r["counts"]) for r in want)
    log(f"  {who}, AMG run boundaries of {len(masks)} masks ({runs} runs) "
        f"on a {canvas_hw} canvas: card {'equal to' if got == want else 'DIFFERS from'}"
        f" CPU, CPU {'equal to' if want == enc else 'DIFFERS from'} rle_encode")
    if got != want or want != enc:
        raise AssertionError(f"{who}: AMG run boundaries disagree")

    recs = [gen.generate(im) for gen, im in zip(gens, (img, img.cuda()))]
    P, M = ious[0].shape
    pts = gens[0].point_grids[0] * np.array([W, H])[None]
    if not len(recs[0]) == len(recs[1]) == N == P * M:
        raise AssertionError(f"{who}: AMG generate kept {len(recs[0])} "
                             f"records on the CPU, {len(recs[1])} on the card, "
                             f"of {N} candidates")
    by_cand = []
    for side, rs in enumerate(recs):
        io = ious[side].float().cpu().numpy()
        cand = {}
        for r in rs:
            p = int(np.abs(pts - np.asarray(r["point_coords"][0])).sum(1).argmin())
            cand[p * M + int(np.abs(io[p] - r["predicted_iou"]).argmin())] = r
        if len(cand) != N:
            raise AssertionError(f"{who}: AMG records do not map one to "
                                 "one onto the candidates")
        by_cand.append(cand)
    thr = float(gens[0].mask_threshold)
    band = TOL_PRED_REF * up.abs().max().item()
    far_r = ((up.amax(dim=2) - thr).abs() > band).numpy()     # [N, H]
    far_c = ((up.amax(dim=1) - thr).abs() > band).numpy()     # [N, W]
    held, bad_box, bad_px, far_px = 0, [], 0, 0
    for c in range(N):
        rc, rd = by_cand[0][c], by_cand[1][c]
        x, y, w, h = (int(v) for v in rc["bbox"])
        if rc["area"] == 0:
            fixed = far_r[c].all()
        else:
            fixed = (far_r[c, :y + 1].all() and far_r[c, y + h:].all()
                     and far_c[c, :x + 1].all() and far_c[c, x + w:].all())
        if fixed:
            held += 1
            if rd["bbox"] != rc["bbox"]:
                bad_box.append((c, rc["bbox"], rd["bbox"]))
        far = ((up[c] - thr).abs() > band).numpy()
        far_px += int(far.sum())
        bad_px += int((rle_decode(rd["segmentation"])[far]
                       != rle_decode(rc["segmentation"])[far]).sum())
    log(f"  {who}, AMG generate, {N} records on both: boxes of the "
        f"{held} whose edges lie outside the band {'equal' if not bad_box else 'DIFFER'}"
        f"; decoded RLEs: {bad_px} of {far_px} pixels outside the band differ")
    if not held:
        raise AssertionError(f"{who}: no AMG box could be held outside "
                             "the band")
    if bad_box or bad_px:
        raise AssertionError(f"{who}: AMG records disagree: boxes "
                             f"{bad_box[:4]}, {bad_px} pixels")


def phase_small_predictors_reference(smi: str):
    """A narrow SAM-2 (`track_config(1024)`: narrow Hiera, full-width heads
    and memory modules, so the memory self-attention still takes K1 at head
    dim 256) built through `build_sam2` in bf16 on the card, against the
    same weights in f32 on the CPU through the plain twins, for each of the
    three surfaces. Logits are held by relative L2 (TOL_PRED_REF); binary
    outputs are equal wherever the reference logit lies farther than
    TOL_PRED_REF * max|ref| from the threshold."""
    import torch
    import numpy as np
    from videoglamm_torch.inference.pipeline import build_sam2
    from videoglamm_torch.models.sam2 import interactive as I
    from videoglamm_torch.models.sam2.amg import SAM2AutomaticMaskGenerator
    from videoglamm_torch.models.sam2.image_predictor import SAM2ImagePredictor
    from videoglamm_torch.ops.connected_components import postprocess_mask_scores
    from videoglamm_torch.ops.preprocess import preprocess_sam_stream
    from videoglamm_torch.ops.resize import resize_bilinear

    cfg = track_config(1024)

    def init(m):
        seeded_init(m, torch.Generator().manual_seed(61))
        with torch.no_grad():   # objects present by a margin above rounding
            m.sam_mask_decoder.pred_obj_score_head.layers[-1].bias.fill_(2.0)

    ref = build_sam2(cfg, device="cpu", dtype=torch.float32, init=init)
    dev = build_sam2(cfg, ref.state_dict(), device="cuda", dtype=torch.bfloat16)

    def hold(got, want, what, tol=TOL_PRED_REF):
        hold_close("narrow SAM-2", got, want, what, tol)

    def hold_binary(got, want_logits, what):
        hold_masks("narrow SAM-2", got, want_logits, what)

    g = torch.Generator().manual_seed(62)
    raw = torch.randint(0, 256, (4, RAW_H, RAW_W, 3), dtype=torch.uint8, generator=g)

    # image predictor. Hole and sprinkle filling is a step function of the
    # logits (a component one pixel larger is not filled), so the logits
    # are held unfilled, and the filling is held apart on equal inputs.
    preds = [SAM2ImagePredictor(m) for m in (ref, dev)]
    preds[0].set_image(raw[0])
    preds[1].set_image(raw[0].cuda())
    hold(preds[1].get_image_embedding(), preds[0].get_image_embedding(),
         "image embedding")
    pts = np.array([[300.0, 200.0]])
    for what, kw in (("points", dict(point_coords=pts, point_labels=np.array([1]))),
                     ("box", dict(box=np.array([100.0, 80.0, 600.0, 400.0])))):
        (rl, ri, rlow), (dl, di, dlow) = (p.predict(return_logits=True, **kw)
                                          for p in preds)
        dm, _, _ = preds[1].predict(**kw)
        hold(dl, rl, f"predict {what} logits")
        hold(di, ri, f"predict {what} ious")
        hold(dlow, rlow, f"predict {what} low-res logits")
        hold_binary(dm, rl, f"predict {what} masks")
    filled = [postprocess_mask_scores(torch.from_numpy(dlow).to(d), 16.0, 16.0)
              for d in ("cpu", "cuda")]
    same = torch.equal(filled[1].cpu(), filled[0])
    log(f"  narrow SAM-2, hole and sprinkle filling of the same logits "
        f"{tuple(dlow.shape)}: card {'equal to' if same else 'DIFFERS from'} CPU")
    if not same:
        raise AssertionError("narrow SAM-2: connected components on the card")
    rlow_best = rlow[:1] if rlow.ndim == 3 else rlow[None]
    (rl, _, _), (dl, _, _) = (p.predict(point_coords=pts, point_labels=np.array([1]),
                                        mask_input=rlow_best, multimask_output=False,
                                        return_logits=True) for p in preds)
    hold(dl, rl, "predict refinement logits")
    preds[0].set_image_batch(list(raw[:2]))
    preds[1].set_image_batch([r.cuda() for r in raw[:2]])
    outs = [p.predict_batch(point_coords_batch=[pts, pts + 50],
                            point_labels_batch=[np.array([1])] * 2,
                            return_logits=True) for p in preds]
    for i in range(2):
        hold(outs[1][0][i], outs[0][0][i], f"predict_batch image {i} logits")

    # automatic mask generator: the decoded candidates of one grid batch,
    # then their scores, binary masks and boxes
    # (thresholds at 0 and NMS at IoU 1 keep every candidate in `generate`)
    gens = [SAM2AutomaticMaskGenerator(m, points_per_side=4, points_per_batch=16,
                                       pred_iou_thresh=0.0,
                                       stability_score_thresh=0.0,
                                       box_nms_thresh=1.0,
                                       output_mode="uncompressed_rle")
            for m in (ref, dev)]
    lows, scores = [], []
    for gen, img in zip(gens, (raw[1], raw[1].cuda())):
        gen.predictor.set_image(img)
        feats = gen._crop_features()
        pts_g = gen.point_grids[0] * np.array([RAW_W, RAW_H])[None]
        coords = torch.from_numpy(gen._model_coords(pts_g, (RAW_H, RAW_W))
                                  .astype(np.float32)).to(img.device)[:, None]
        with torch.no_grad():
            low, ious = gen._decode_fn(16, True, False)(*feats, coords, None)
            low = low.reshape(-1, *low.shape[2:])
            lows.append((low, ious))
            scores.append(gen._score_fn(low.shape[0], (RAW_H, RAW_W))(low))
    hold(lows[1][0], lows[0][0], "AMG decoded low-res logits")
    hold(lows[1][1], lows[0][1], "AMG IoU predictions")
    with torch.no_grad():
        up = resize_bilinear(lows[0][0][..., None], (RAW_H, RAW_W))[..., 0]
    hold_binary(scores[1][0], up, "AMG binary masks")
    d_stab = (scores[1][1].cpu() - scores[0][1]).abs().max().item()
    log(f"  narrow SAM-2, AMG stability scores: max |d| {d_stab:.3e} "
        f"(tol {TOL_STABILITY:g})")
    if d_stab > TOL_STABILITY:
        raise AssertionError("narrow SAM-2: AMG stability scores disagree")
    check_amg_records(gens, scores[0][0], up, [lw[1] for lw in lows], raw[1])

    # interactive predictor: the prompts on both, then each propagated frame
    # teacher-forced on the reference's bank
    T, B = 4, 2
    sess = [I.SAM2InteractivePredictor(m, preprocess_sam_stream(
                raw.to(I.model_device(m)), cfg.image_size), num_objects=B)
            for m in (ref, dev)]
    mask = _blob_masks(B, cfg.image_size)
    for what, fn in (("points", lambda s: s.add_new_points(
                          0, np.array([[[300.0, 200.0]], [[700.0, 600.0]]]),
                          np.ones((B, 1), np.int32))),
                     ("box", lambda s: s.add_new_box(
                          2, np.array([[100.0, 100.0, 500.0, 400.0],
                                       [520, 300, 900, 800]]))),
                     ("mask", lambda s: s.add_new_mask(3, mask))):
        with torch.no_grad():
            r, d = fn(sess[0]), fn(sess[1])
        hold(d, r, f"interactive {what} prompt logits")
    if not (np.array_equal(sess[0].bank.cond_frame, sess[1].bank.cond_frame)):
        raise AssertionError("interactive: cond frames differ")
    rel = ((sess[1].bank.cond_mem.cpu() - sess[0].bank.cond_mem).norm()
           / sess[0].bank.cond_mem.norm()).item()
    log(f"  narrow SAM-2, interactive cond memories, each side from its own "
        f"binarised mask: rel L2 {rel:.3e}, not held")
    reset_counts()
    n = 0
    for reverse in (False, True):
        pinned = np.zeros(T, bool)
        pinned[list(sess[0].pinned)] = True
        start, end = (T - 1, 0) if reverse else (0, T - 1)
        for t in I.propagation_frames(T, start, end, reverse,
                                      sess[0].bank.cond_frame, pinned):
            rb = sess[0].bank
            db = I.InteractiveBank(*(x.clone().cuda() if torch.is_tensor(x)
                                     else x.copy() for x in rb))
            with torch.no_grad():
                feats = [[f[t][None].expand(B, *f.shape[1:]) for f in s.feats]
                         for s in sess]
                rh = I.propagate_step(ref, feats[0], sess[0].pos[-1], rb, t, T, reverse)
                dh = I.propagate_step(dev, feats[1], sess[1].pos[-1], db, t, T, reverse)
                mem, _ = dev.encode_new_memory(
                    feats[1][-1], rh.high_res_masks.permute(0, 2, 3, 1).cuda(),
                    rh.object_score_logits.cuda())
            n += 1
            what = f"interactive {'reverse' if reverse else 'forward'} frame {t}"
            for name in ("low_res_multimasks", "ious", "object_score_logits"):
                hold(getattr(dh, name), getattr(rh, name), f"{what} {name}")
            hold(mem, rb.mem_ring[:, t], f"{what} memory")
    counts = read_counts()
    if counts["attention_fwd[flash_d256]"] != cfg.memory_attention_layers * n:
        raise AssertionError(f"narrow SAM-2 interactive: K1 at head dim 256 "
                             f"launched {counts['attention_fwd[flash_d256]']} times "
                             f"for {n} frames")
    log(f"  narrow SAM-2, interactive: {n} propagated frames held, K1 at head "
        f"dim 256 x{counts['attention_fwd[flash_d256]']} [{smi}]")


# SAM-1 ViT-H: the only kernel of its path is K3, at every LayerNorm that
# `layer_norm`'s dispatch rule gives it (ops/norms.py: a width that is a
# multiple of 128 and at least 65,536 elements). Its biased attention, its
# dense layers, convs and the f32 decoder's attention stay plain.
SAM1_ENCODE_K3 = 2 * 32 + 2   # norm1 and norm2 of the 32 blocks, the neck's 2
N_SAM1_TRACK_FRAMES = 8
N_SAM1_OBJECTS = 4


def sam1_decode_k3(B: int, N: int, C: int = 256) -> int:
    """K3 launches of one SAM-1 decode of B prompts over N tokens (iou, 4
    mask, 4 track tokens with ITM, the sparse prompts): norm4 of both
    two-way blocks on the keys [B, 4096, C] always; norm1-3 of both blocks
    and norm_final_attn on the queries [B, N, C] from B * N * C >= 65,536;
    `upscale_ln` (C / 4 = 64 wide) and the mask-prompt norms (4 and 16
    wide) never."""
    return 2 + (7 if B * N * C >= 1 << 16 else 0)


def vit_h_encode_cost(cfg) -> tuple:
    """(dense FLOP, attention FLOP) of one SAM-1 encode at batch 1: patch
    embedding, qkv, proj and the 4x MLP of every block, the neck's 1x1 and
    3x3 convs; QK^T and PV over the windows (zero-padded to whole windows)
    and over the whole grid in the global blocks."""
    g, D, C = cfg.image_size // 16, cfg.encoder_embed_dim, cfg.prompt_embed_dim
    S = g * g
    dense = 2 * S * (16 * 16 * 3 * D + cfg.encoder_depth * 12 * D * D
                     + D * C + 9 * C * C)
    ws = cfg.window_size
    nw = (-(-g // ws)) ** 2
    n_glob = len(cfg.encoder_global_attn_indexes)
    attn = 4 * D * ((cfg.encoder_depth - n_glob) * nw * (ws * ws) ** 2
                    + n_glob * S * S)
    return dense, attn


def phase_sam1(smi: str) -> dict:
    """SAM-1 ViT-H with the ITM tracker at its published width
    (`SAM1Config.vit_h()`, `with_itm=True`, seeded random weights, bf16
    encoder, f32 decoder) through `build_sam1`, with the launch counters
    set to 0 just before each path and read just after: the image predictor
    on a raw 480x854 uint8 frame (2 points and 3 masks, a box, the box with
    the low-res mask fed back), the automatic mask generator at the JAX
    defaults on the same frame, and `track_frames` over 8 frames with 4
    text-embed objects. Returns the counts of the three paths together."""
    import torch
    import numpy as np
    from videoglamm_torch.config import SAM1Config
    from videoglamm_torch.inference.pipeline import build_sam1
    from videoglamm_torch.models.sam1_predictor import (
        SAM1AutomaticMaskGenerator, SAM1ImagePredictor, preprocess_image_longest)

    cfg = dataclasses.replace(SAM1Config.vit_h(), with_itm=True)
    t0 = time.perf_counter()
    sam = build_sam1(cfg, device="cuda", dtype=torch.bfloat16,
                     init=lambda m: seeded_init(
                         m, torch.Generator(device="cuda").manual_seed(7)))
    torch.cuda.synchronize()
    log(f"  SAM-1 ViT-H at {cfg.image_size} with ITM: "
        f"{sum(p.numel() for p in sam.parameters()) / 1e6:.1f} M parameters, "
        f"built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(71)
    frames = torch.randint(0, 256, (N_SAM1_TRACK_FRAMES, RAW_H, RAW_W, 3),
                           dtype=torch.uint8, generator=g, device="cuda")
    E4 = 4 * cfg.image_size // 16
    only_k3 = {k: 0 for k in read_counts() if k != "row_norm[ln]"}
    total = {}

    def run(what, fn, k3):
        """fn's result and wall ms, its launches checked: K3 `k3` times and
        no other kernel."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        out, ms = _wall(fn)
        counts = read_counts()
        check_launches(counts, {**only_k3, "row_norm[ln]": k3}, f"SAM-1 {what}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"  SAM-1 {what}: {ms:.1f} ms, K3 x{k3}, peak device memory "
            f"{peak:.2f} GiB [{smi}]")
        return out, ms

    # --- image predictor ---------------------------------------------------
    pred = SAM1ImagePredictor(sam)
    pred.set_image(frames[0])                                    # warm-up
    _, enc_ms = run("set_image (one ViT-H encode)", lambda: pred.set_image(frames[0]),
                    SAM1_ENCODE_K3)
    dense, attn = vit_h_encode_cost(cfg)
    bound_ms = (dense + attn) / PEAK_OPS["bf16"] * 1e3
    log(f"  SAM-1 encode: {(dense + attn) / 1e12:.3f} TFLOP ({dense / 1e12:.3f} dense, "
        f"{attn / 1e12:.3f} attention), bound {bound_ms:.3f} ms at the bf16 peak; "
        f"measured {enc_ms:.1f} ms = {enc_ms / bound_ms:.1f} x the bound [{smi}]")
    device_busy(lambda: pred.set_image(frames[0]), "one SAM-1 ViT-H encode", smi)
    pts = np.array([[300.0, 200.0], [520.0, 260.0]])
    pred.predict(point_coords=pts, point_labels=np.array([1, 0]))  # warm-up
    (masks, ious, low), _ = run(
        "predict 2 points x3 masks", lambda: pred.predict(
            point_coords=pts, point_labels=np.array([1, 0])),
        sam1_decode_k3(1, 5 + 3))
    box = np.array([100.0, 80.0, 600.0, 400.0])
    (bm, bi, bl), _ = run("predict box", lambda: pred.predict(
        box=box, multimask_output=False), sam1_decode_k3(1, 5 + 2))
    best = int(np.argmax(ious))
    (rm, ri, rl), _ = run("predict box + low-res mask fed back", lambda: pred.predict(
        box=box, mask_input=low[best:best + 1], multimask_output=False),
        sam1_decode_k3(1, 5 + 2))
    for what, (m, i, lo), n in (("points", (masks, ious, low), 3),
                                ("box", (bm, bi, bl), 1), ("refinement", (rm, ri, rl), 1)):
        if m.shape != (n, RAW_H, RAW_W) or i.shape != (n,) \
                or lo.shape != (n, E4, E4) or not np.isfinite(lo).all():
            raise AssertionError(f"SAM-1 predict {what}: {m.shape} {i.shape} {lo.shape}")

    # --- automatic mask generator at the JAX defaults ------------------------
    gen = SAM1AutomaticMaskGenerator(sam)
    n_batches = -(-len(gen.point_grids[0]) // gen.points_per_batch)
    amg_k3 = SAM1_ENCODE_K3 + n_batches * sam1_decode_k3(gen.points_per_batch, 5 + 2)
    gen.generate(frames[0])                                      # warm-up
    timings = {}
    recs, amg_ms = run(f"AMG, {len(gen.point_grids[0])} points, "
                       f"{gen.points_per_batch} a batch, JAX defaults",
                       lambda: gen.generate(frames[0], timings=timings), amg_k3)
    for r in recs:
        if not (0 <= r["area"] <= RAW_H * RAW_W) or not np.isfinite(r["predicted_iou"]):
            raise AssertionError(f"SAM-1 AMG: record {r['bbox']}")
    log(f"  SAM-1 AMG: {len(recs)} records; stage ms: " + ", ".join(
        f"{k} {v * 1e3:.1f}" for k, v in sorted(timings.items(), key=lambda kv: -kv[1]))
        + f" [{smi}]")
    device_busy(lambda: gen.generate(frames[0]), "one SAM-1 AMG pass at the JAX defaults",
                smi)
    del gen, recs

    # --- track_frames: the ITM track-token recurrence ------------------------
    T, B = N_SAM1_TRACK_FRAMES, N_SAM1_OBJECTS
    with torch.no_grad():
        x = torch.stack([preprocess_image_longest(f, cfg.image_size)[0] for f in frames])
        text = torch.randn(B, 1, cfg.prompt_embed_dim, generator=g, device="cuda")
        sam.track_frames(x[:2], text)                            # warm-up
        track_k3 = SAM1_ENCODE_K3 + sam1_decode_k3(B, 5 + 1) \
            + (T - 1) * sam1_decode_k3(B, 5 + 4 + 1)
        out, tr_ms = run(f"track_frames, {T} frames, {B} objects",
                         lambda: sam.track_frames(x, text), track_k3)
    if tuple(out.shape) != (B, T, E4, E4) or not torch.isfinite(out).all():
        raise AssertionError(f"SAM-1 track_frames: {tuple(out.shape)}")
    log(f"  SAM-1 track_frames: {tr_ms / T:.1f} ms a frame [{smi}]")
    with torch.no_grad():
        device_busy(lambda: sam.track_frames(x, text),
                    f"SAM-1 track_frames ({T} frames, {B} objects)", smi)
    del sam, pred, x, out
    torch.cuda.empty_cache()
    return total


def sam1_narrow_config():
    """SAM-1 at the real image size (1024: a 64x64 grid in windows of 14,
    padded to 70x70, and a global block over 4,096 tokens) and the full
    decoder width, with a narrow encoder (256 wide, 4 blocks): every norm
    K3 takes at ViT-H's shapes but the 1280 width."""
    from videoglamm_torch.config import SAM1Config
    return SAM1Config(encoder_embed_dim=256, encoder_depth=4, encoder_num_heads=4,
                      encoder_global_attn_indexes=(3,), with_itm=True)


def phase_small_sam1_reference(smi: str):
    """The narrow SAM-1 built through `build_sam1` in bf16 on the card
    against the same weights in f32 on the CPU through the plain twins, on
    each surface: the embedding, `predict` (points, box with mask input),
    the AMG's candidates, scores and records (`check_amg_records`) and
    `track_frames`. Logits by relative L2 (TOL_PRED_REF), binary outputs
    outside the band, as the narrow SAM-2."""
    import torch
    import numpy as np
    from videoglamm_torch.inference.pipeline import build_sam1
    from videoglamm_torch.models.sam1_predictor import (
        SAM1AutomaticMaskGenerator, SAM1ImagePredictor, preprocess_image_longest,
        preprocess_shape)
    from videoglamm_torch.ops.resize import resize_bilinear

    cfg = sam1_narrow_config()
    who = "narrow SAM-1"
    ref = build_sam1(cfg, device="cpu", dtype=torch.float32,
                     init=lambda m: seeded_init(m, torch.Generator().manual_seed(72)))
    dev = build_sam1(cfg, ref.state_dict(), device="cuda", dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(73)
    raw = torch.randint(0, 256, (3, RAW_H, RAW_W, 3), dtype=torch.uint8, generator=g)

    preds = [SAM1ImagePredictor(m) for m in (ref, dev)]
    preds[0].set_image(raw[0])
    reset_counts()
    preds[1].set_image(raw[0].cuda())
    k3 = read_counts()["row_norm[ln]"]
    if k3 != 2 * cfg.encoder_depth + 2:
        raise AssertionError(f"{who}: K3 launched {k3} times in an encode")
    hold_close(who, preds[1].get_image_embedding(), preds[0].get_image_embedding(),
               "image embedding")
    pts = np.array([[300.0, 200.0], [520.0, 260.0]])
    outs = [p.predict(point_coords=pts, point_labels=np.array([1, 0]),
                      return_logits=True) for p in preds]
    for i, what in enumerate(("logits", "ious", "low-res logits")):
        hold_close(who, outs[1][i], outs[0][i], f"predict points {what}")
    hold_masks(who, preds[1].predict(point_coords=pts, point_labels=np.array([1, 0]))[0],
               outs[0][0], "predict points masks")
    low = outs[0][2][:1]
    kw = dict(box=np.array([100.0, 80.0, 600.0, 400.0]), mask_input=low,
              multimask_output=False)
    outs = [p.predict(return_logits=True, **kw) for p in preds]
    hold_close(who, outs[1][0], outs[0][0], "predict box + mask input logits")
    hold_masks(who, preds[1].predict(**kw)[0], outs[0][0], "predict box + mask input masks")

    # the AMG: one grid batch's candidates, their scores, then the records
    gens = [SAM1AutomaticMaskGenerator(m, points_per_side=4, points_per_batch=16,
                                       pred_iou_thresh=0.0, stability_score_thresh=0.0,
                                       box_nms_thresh=1.0, output_mode="uncompressed_rle")
            for m in (ref, dev)]
    lows, scores = [], []
    for gen, img in zip(gens, (raw[1], raw[1].cuda())):
        gen.predictor.set_image(img)
        pts_g = gen.point_grids[0] * np.array([RAW_W, RAW_H])[None]
        coords = torch.from_numpy(gen._model_coords(pts_g, (RAW_H, RAW_W))
                                  .astype(np.float32)).to(img.device)[:, None]
        with torch.no_grad():
            lo, io = gen._decode_fn(16, True, False)(*gen._crop_features(), coords, None)
            lo = lo.reshape(-1, *lo.shape[2:])
            lows.append((lo, io))
            scores.append(gen._score_fn(lo.shape[0], (RAW_H, RAW_W))(lo))
    hold_close(who, lows[1][0], lows[0][0], "AMG decoded low-res logits")
    hold_close(who, lows[1][1], lows[0][1], "AMG IoU predictions")
    nh, nw = preprocess_shape(RAW_H, RAW_W, cfg.image_size)
    with torch.no_grad():
        up = resize_bilinear(lows[0][0][..., None], (cfg.image_size,) * 2)[:, :nh, :nw]
        up = resize_bilinear(up, (RAW_H, RAW_W))[..., 0]
    hold_masks(who, scores[1][0], up, "AMG binary masks")
    d_stab = (scores[1][1].cpu() - scores[0][1]).abs().max().item()
    log(f"  {who}, AMG stability scores: max |d| {d_stab:.3e} (tol {TOL_STABILITY:g})")
    if d_stab > TOL_STABILITY:
        raise AssertionError(f"{who}: AMG stability scores disagree")
    check_amg_records(gens, scores[0][0], up, [lw[1] for lw in lows], raw[1], who)

    # track_frames: 3 frames, 2 objects, the ITM recurrence
    x = torch.stack([preprocess_image_longest(f, cfg.image_size)[0] for f in raw])
    text = torch.randn(2, 1, cfg.prompt_embed_dim, generator=g)
    with torch.no_grad():
        r = ref.track_frames(x, text)
        d = dev.track_frames(x.cuda(), text.cuda())
    for t in range(x.shape[0]):
        hold_close(who, d[:, t], r[:, t], f"track_frames frame {t} logits")
    log(f"  {who}: every surface held [{smi}]")


# ---------------------------------------------------------------------------
# 11. the serving CLIs from files: chat, the five eval-inference CLIs, the
# two metric CLIs and convert_checkpoint, at flagship width
# ---------------------------------------------------------------------------
CLI_MAX_NEW = MAX_NEW       # --max_new_tokens of every serving CLI run
CLI_SAM_FRAMES = 64         # eval_refer_infer's default --max_sam_frames
CLI_GCG_FRAMES = 16
TOL_MASK_THRESHOLD = 1e-4   # |resized logit| below which the card's mask and
                            # its CPU f32 twin may differ (summation order)


class CLITokenizer(WordTokenizer):
    """The word-level stand-in with a `decode`: the seg id as "[SEG]",
    every other id as "w<id>"."""

    def decode(self, ids, skip_special_tokens=False):
        return " ".join("[SEG]" if i == self.seg_id else f"w{i}" for i in ids)


class StampedLines:
    """A stdout for a CLI run: keeps every line with the perf_counter time
    at which it was written."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        now = time.perf_counter()
        self.lines.extend((now, ln) for ln in done)
        return len(s)

    def flush(self):
        pass


def write_cli_fixture(root: str, seed: int) -> dict:
    """Serving fixtures at 480x854 from the seed: an image; a GCG root of 2
    videos x 16 frames with gt.json and 2 objects' gt_masks; a MeViS-layout
    root of one 64-frame video with 2 expressions and its DAVIS-layout
    ground truth; 2 sentence records (A2D-Sentences where h5py is
    installed, JHMDB-Sentences otherwise: the card's machine has no h5py);
    one grounding question and one ActivityNet-Entities phrase over frame
    directories."""
    import importlib.util
    import os
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)

    def save(path, arr):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, **({"quality": 90}
                                           if path.endswith(".jpg") else {}))

    out = dict(root=root, image=os.path.join(root, "image.jpg"))
    save(out["image"], _smooth_frame(rng))
    for v in range(2):
        vdir = os.path.join(root, "gcg", f"vid{v}")
        for t in range(CLI_GCG_FRAMES):
            save(os.path.join(vdir, "frames", f"{t:05d}.jpg"), _smooth_frame(rng))
            for o in range(2):
                save(os.path.join(vdir, "gt_masks", str(o), f"{t:05d}.png"),
                     (_blob(rng) * 255).astype(np.uint8))
        with open(os.path.join(vdir, "gt.json"), "w") as f:
            json.dump({"caption": f"a striped cat {v} chases the red ball "
                       "across the kitchen floor",
                       "phrases": ["a striped cat", "the red ball"]}, f)
    names = [f"{t:05d}" for t in range(CLI_SAM_FRAMES)]
    for t, name in enumerate(names):
        save(os.path.join(root, "mevis", "JPEGImages", "vid0", f"{name}.jpg"),
             _smooth_frame(rng))
        for e in range(2):
            save(os.path.join(root, "davis_gt", "vid0", str(e), f"{name}.png"),
                 (_blob(rng) * 255).astype(np.uint8))
    with open(os.path.join(root, "mevis", "meta_expressions.json"), "w") as f:
        json.dump({"videos": {"vid0": {"frames": names, "expressions": {
            "0": {"exp": "the dog that jumps first"},
            "1": {"exp": "the red ball on the floor"}}}}}, f)
    if importlib.util.find_spec("h5py") is not None:
        import h5py
        out["sentences"] = "a2d"
        sdir = os.path.join(root, "a2d")
        for t in range(8):
            save(os.path.join(sdir, "Release", "clips320H", "vidA",
                              f"{t:05d}.jpg"), _smooth_frame(rng))
        hdir = os.path.join(sdir, "text_annotations",
                            "a2d_annotation_with_instances", "vidA")
        os.makedirs(hdir)
        with h5py.File(os.path.join(hdir, "00004.h5"), "w") as f:
            f["instance"] = np.asarray([3, 5])
            f["reMask"] = np.stack([_blob(rng).T, _blob(rng).T]).astype(np.uint8)
        rows = [["a dog jumping over the fence", "vidA", 4, 3],
                ["the red ball rolling", "vidA", 4, 5]]
    else:
        import scipy.io
        out["sentences"] = "jhmdb"
        sdir = os.path.join(root, "jhmdb")
        rel = "Rename_Images/brush_hair/clipZ"
        for t in range(1, 9):
            save(os.path.join(sdir, rel, f"{t:05d}.png"), _smooth_frame(rng))
        mat = "puppet_mask/brush_hair/clipZ/puppet_mask.mat"
        os.makedirs(os.path.dirname(os.path.join(sdir, mat)))
        part = np.stack([_blob(rng) for _ in range(8)], -1).astype(np.uint8)
        scipy.io.savemat(os.path.join(sdir, mat), {"part_mask": part})
        rows = [["clipZ", f"./{rel}/00003.png", mat, 8, "a person brushing hair"],
                ["clipZ", f"./{rel}/00006.png", mat, 8, "the hand holding a brush"]]
    out["sentences_root"] = sdir
    out["sentences_ann"] = os.path.join(sdir, "ann.json")
    with open(out["sentences_ann"], "w") as f:
        json.dump(rows, f)
    gcg0 = os.path.join(root, "gcg", "vid0", "frames")
    out["ground"] = os.path.join(root, "ground.json")
    with open(out["ground"], "w") as f:
        json.dump([{"vid": "vid0", "qtype": "declarative",
                    "question": "who chases the ball", "frames_dir": gcg0,
                    "gt_sted": [2, 9], "gt_boxes": {
                        str(t): [100 + 5 * t, 80, 420, 300] for t in range(2, 9)}}],
                  f)
    out["anet"] = os.path.join(root, "anet.json")
    with open(out["anet"], "w") as f:
        json.dump([{"vid": "vid1", "phrase": "a striped cat", "segment": [0.1, 0.9],
                    "frames_dir": os.path.join(root, "gcg", "vid1", "frames")}], f)
    return out


def phase_cli(cfg, seed: int, smi: str, share=None) -> dict:
    """The port's serving CLIs' `main` at flagship width on seeded weights,
    from the fixture files of `write_cli_fixture`, with only `load_model`
    and `load_tokenizer` patched: the seeded state dict is made ONCE on the
    card (bf16) and every CLI builds its model from it through
    `build_inference` (about a second; a CLI builds in its `main`, so a
    serving mode cannot be built once for two CLIs without patching more);
    the tokenizer is the word-level stand-in. Each serving CLI runs with
    the counters set to 0 just before and read just after; its launches
    must be the serve phase's per-request formula times its requests, it
    must skip nothing and write what it writes. Then the SAM-2 encode of
    the refer CLI's 64 frames timed alone with its peak memory, its masks
    at 480x854 on the card against their CPU f32 twin, and
    convert_checkpoint on a reference-layout directory of the seeded
    weights, read back equal through `load_model`. Returns the launches
    summed over the serving CLIs' runs. share: a directory that outlives
    the phase, where the reference-layout files go (`hf_export/`, `iv.pt`,
    `clip.bin`) for the parity phase to read."""
    import os
    import tempfile
    import types
    import numpy as np
    import torch
    from videoglamm_torch.cli import (chat, common, convert_checkpoint,
                                      eval_anet_entities_infer, eval_gcg_infer,
                                      eval_gcg_metrics, eval_grounding,
                                      eval_refer_infer, eval_referdavis_metrics)
    from videoglamm_torch.data.conversation import (ConvGenerator,
                                                    tokenizer_image_token)
    from videoglamm_torch.data.video_reader import load_frame_dir
    from videoglamm_torch.io.reference import to_reference_layout
    from videoglamm_torch.models.videoglamm import SegExtraction
    from videoglamm_torch.ops.resize import resize_bilinear

    tok = CLITokenizer(cfg.seg_token_idx, cfg.llm.vocab_size)
    gi = build(cfg, "none", "bf16", "the CLIs' seeded weights")
    sd = gi.model.state_dict()        # the CLIs' weights, on the card
    del gi
    ids = tokenizer_image_token(ConvGenerator(cfg.llm_type).apply_for_chat(
        eval_gcg_infer.GCG_PROMPT, media="video"), tok)
    log(f"  the GCG prompt is {len(ids)} ids through the stand-in tokenizer; "
        f"--max_new_tokens {CLI_MAX_NEW} cuts it to {min(len(ids), CLI_MAX_NEW)} "
        "(every CLI passes --max_new_tokens as the prompt's max_len, as the "
        "JAX CLIs do)")
    total = {}
    stamps = {}

    def load_model(args, cfg_=None):
        stamps["loaded"] = time.perf_counter()
        return sd

    def run(name, mod, argv, mode=None, requests=0):
        saved = {k: getattr(mod, k) for k in ("load_model", "load_tokenizer")
                 if hasattr(mod, k)}
        if saved:
            mod.load_model, mod.load_tokenizer = load_model, lambda path: tok
        out = StampedLines()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        stamps.clear()
        real = sys.stdout
        try:
            sys.stdout = out
            ret = mod.main(argv)
            torch.cuda.synchronize()
        finally:
            sys.stdout = real
            for k, v in saved.items():
                setattr(mod, k, v)
        wall = time.perf_counter() - t0
        counts = read_counts()
        lines = [ln for _, ln in out.lines]
        skips = [ln for ln in lines if ln.startswith("[skip]")]
        if skips:
            raise AssertionError(f"{name} skipped samples: {skips}")
        oks = [t for t, ln in out.lines if ln.startswith("[ok]")]
        msg = f"  {name}: wall {wall:.2f} s"
        if mode is not None:
            per = [b - a for a, b in zip(oks, oks[1:])]
            after_load = time.perf_counter() - stamps["loaded"]
            msg += (f" ({after_load:.2f} s from load_model's return: the "
                    f"model's build and {requests} samples), s per sample "
                    f"{', '.join(f'{x:.2f}' for x in per) or 'n/a'} (between "
                    f"consecutive [ok] lines), peak device memory "
                    f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
            want = EXPECTED_PER_REQUEST[mode]
            for k, n in counts.items():
                per_req = want.get(k)
                if per_req is None:
                    if n == 0:
                        raise AssertionError(f"{name}: {k} was never launched")
                elif n != per_req * requests:
                    raise AssertionError(
                        f"{name}: {k} launched {n} times, expected {per_req} "
                        f"per request ({mode}) x {requests}")
            for k, n in counts.items():
                total[k] = total.get(k, 0) + n
            msg += f"; launches = the {mode} formula x {requests}"
        elif any(counts.values()):
            raise AssertionError(f"{name} launched kernels: {counts}")
        log(msg + f"; last line: {lines[-1][:160] if lines else ''}")
        return ret, lines

    def finite(x):
        return all(math.isfinite(v) for v in x) if isinstance(x, list) \
            else math.isfinite(x)

    model = ["--checkpoint", "seeded", "--tokenizer", "word-level",
             "--max_new_tokens", str(CLI_MAX_NEW)]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        fx = write_cli_fixture(os.path.join(d, "data"), seed)
        log(f"  serving CLIs: fixtures written in {time.perf_counter() - t0:.1f} s "
            f"(an image, 2 x {CLI_GCG_FRAMES} GCG frames, {CLI_SAM_FRAMES} MeViS "
            f"frames, 2 {fx['sentences']} records, a grounding question, an "
            f"ANet phrase; {RAW_H}x{RAW_W})")

        o = os.path.join(d, "chat")
        turns, _ = run("chat (int8 + int8 KV, video branch, image)", chat, model + [
            "--media", fx["image"], "--prompt", "Segment the striped cat.",
            "--out_dir", o, "--quant", "int8", "--kv_cache", "int8",
            "--use_sam2_video_branch"], "track", 1)
        if sorted(os.listdir(o)) != [f"turn0_frame{t:03d}.png" for t in range(16)]:
            raise AssertionError(f"chat wrote {sorted(os.listdir(o))}")

        o = os.path.join(d, "gcg_out")
        ret, lines = run("eval_gcg_infer (int8 + int8 KV)", eval_gcg_infer, model + [
            "--data_root", os.path.join(fx["root"], "gcg"), "--save_dir", o,
            "--quant", "int8", "--kv_cache", "int8"], "int8", 2)
        if ret != {"videos": 2, "resumed": 0, "skipped": 0}:
            raise AssertionError(f"eval_gcg_infer: {ret}")
        for v in range(2):
            if not os.path.exists(os.path.join(o, f"vid{v}", "res.json")):
                raise AssertionError(f"eval_gcg_infer: no res.json for vid{v}")
        n_seg = sum(int(ln.split()[-2]) for ln in lines if ln.startswith("[ok]"))
        ret, _ = run("eval_gcg_metrics", eval_gcg_metrics, [
            "--pred_root", o, "--gt_root", os.path.join(fx["root"], "gcg")])
        keys = ("miou", "recall", "meteor", "cider")
        if ret["n_videos"] != 2 or not all(finite(ret[k]) for k in keys):
            raise AssertionError(f"eval_gcg_metrics: {ret}")
        log(f"    GCG: {n_seg} [SEG] objects over 2 videos (random weights); "
            + ", ".join(f"{k} {ret[k]:.4f}" for k in keys))

        o = os.path.join(d, "refer_out")
        ret, _ = run(f"eval_refer_infer (MeViS, bf16, {CLI_SAM_FRAMES} SAM frames, "
                     "framewise)", eval_refer_infer, model + [
                         "--data_root", os.path.join(fx["root"], "mevis"),
                         "--save_dir", o], "bf16", 2)
        if ret != {"expressions": 2, "resumed": 0, "skipped": 0}:
            raise AssertionError(f"eval_refer_infer: {ret}")
        for e in range(2):
            got = sorted(os.listdir(os.path.join(o, "vid0", str(e))))
            if got != [f"{t:05d}.png" for t in range(CLI_SAM_FRAMES)]:
                raise AssertionError(f"eval_refer_infer wrote {len(got)} PNGs")
        ret, _ = run("eval_referdavis_metrics", eval_referdavis_metrics, [
            "--pred_root", o, "--gt_root", os.path.join(fx["root"], "davis_gt"),
            "--out", os.path.join(d, "jf.json")])
        if ret["n_sequences"] != 2 or not finite([ret["J&F"], ret["J-mean"],
                                                  ret["F-mean"]]):
            raise AssertionError(f"eval_referdavis_metrics: {ret}")
        log(f"    Ref-DAVIS J&F {ret['J&F']:.4f} (J {ret['J-mean']:.4f}, F "
            f"{ret['F-mean']:.4f}) over 2 sequences x {CLI_SAM_FRAMES} frames")

        o = os.path.join(d, "sentences_out")
        ret, _ = run(f"eval_refer_infer --dataset {fx['sentences']} (bf16)",
                     eval_refer_infer, model + [
                         "--dataset", fx["sentences"], "--data_root",
                         fx["sentences_root"], "--ann_file", fx["sentences_ann"],
                         "--save_dir", o], "bf16", 2)
        if ret["n"] != 2 or ret["skipped"] or not os.path.exists(
                os.path.join(o, "results.json")) or not finite(
                [v for v in ret.values() if isinstance(v, float)]):
            raise AssertionError(f"eval_refer_infer --dataset: {ret}")

        ret, _ = run("eval_grounding (bf16)", eval_grounding, model + [
            "--annotations", fx["ground"], "--out", os.path.join(d, "ground.json")],
            "bf16", 1)
        if ret.pop("skipped") or list(ret) != ["declarative"] or not finite(
                list(ret["declarative"].values())) or not os.path.exists(
                os.path.join(d, "ground.json")):
            raise AssertionError(f"eval_grounding: {ret}")

        o = os.path.join(d, "anet_out")
        ret, _ = run("eval_anet_entities_infer (bf16)", eval_anet_entities_infer,
                     model + ["--annotations", fx["anet"], "--save_dir", o],
                     "bf16", 1)
        idx = eval_anet_entities_infer.window_indices(CLI_GCG_FRAMES, [0.1, 0.9],
                                                      CLI_GCG_FRAMES)
        if ret != {"phrases": 1, "skipped": 0} or sorted(
                os.listdir(os.path.join(o, "000000"))) != sorted(
                {f"{int(i):05d}.png" for i in idx}) or not \
                os.path.exists(os.path.join(o, "results.json")):
            raise AssertionError(f"eval_anet_entities_infer: {ret}")

        # the refer CLI's SAM-2 encode of 64 frames alone, and its masks at
        # the frames' size on the card against the CPU f32 twin
        from videoglamm_torch.inference.pipeline import build_inference
        gi = build_inference(cfg, sd, device="cuda", dtype=torch.bfloat16,
                             max_new_tokens=CLI_MAX_NEW)
        m = gi.model
        frames = load_frame_dir(os.path.join(fx["root"], "mevis", "JPEGImages",
                                             "vid0"))
        with torch.no_grad():
            _, _, s, hw = common.prepare_vision_inputs(
                frames[:16], cfg, sam_frames=frames, to="cuda",
                dtype=torch.bfloat16)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            feats, _ = m.encode_sam_features(s)
            torch.cuda.synchronize()
            enc_ms = (time.perf_counter() - t0) * 1e3
            peak = torch.cuda.max_memory_allocated()
            enc_counts = read_counts()
            g = torch.Generator(device="cuda").manual_seed(seed)
            ms = cfg.max_seg_tokens
            seg = SegExtraction(
                embeds=torch.randn(1, ms, cfg.out_dim, generator=g, device="cuda"),
                valid=torch.ones(1, ms, dtype=torch.bool, device="cuda"),
                positions=torch.arange(ms, device="cuda")[None])
            logits = m.decode_masks(feats, seg, torch.zeros(1, dtype=torch.long,
                                                            device="cuda"))[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_card = common.masks_to_original_size(logits, hw)
            m2o_ms = (time.perf_counter() - t0) * 1e3
            cpu = logits.float().cpu()
            twin = common.masks_to_original_size(cpu, hw)
            ref = resize_bilinear(cpu.reshape((-1,) + cpu.shape[-2:] + (1,)), hw)
            ref = ref[..., 0].reshape(cpu.shape[:-2] + hw).numpy()
        for k, n in (("attention_fwd[flash]", 3), ("attention_fwd[window]", 42),
                     ("fused_window_block", 42), ("gemm_epilogue", 168)):
            if enc_counts[k] != n:
                raise AssertionError(f"64-frame SAM encode: {k} {enc_counts[k]} != {n}")
        log(f"  SAM-2 encode of the refer CLI's {CLI_SAM_FRAMES} frames as one "
            f"batch ({tuple(s.shape)} bf16): {enc_ms:.1f} ms, peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} GiB above the "
            f"{base / 2**30:.2f} GiB held before it); launches K1 flash 3, "
            f"window 42, K2 168, fused blocks 42 ({smi})")
        differ = on_card != twin
        far = differ & (np.abs(ref) >= TOL_MASK_THRESHOLD)
        log(f"  masks_to_original_size of {tuple(logits.shape)} logits (4 forced "
            f"[SEG] prompts over the {CLI_SAM_FRAMES} frames) to {hw}: "
            f"{m2o_ms:.1f} ms on the card; {int(differ.sum())} of {differ.size} "
            f"pixels differ from the CPU f32 twin, {int(far.sum())} of them with "
            f"|logit| >= {TOL_MASK_THRESHOLD}; {int(twin.sum())} foreground")
        if far.any() or on_card.shape != tuple(logits.shape[:-2]) + hw:
            raise AssertionError("masks_to_original_size: the card differs from "
                                 "its CPU twin away from the threshold")
        del gi, m, feats, logits, s
        torch.cuda.empty_cache()

        # convert_checkpoint over the seeded weights in the reference layout
        t0 = time.perf_counter()
        hf, iv, clip = to_reference_layout(sd, cfg)
        ref_root = share if share is not None else d
        ref_dir = os.path.join(ref_root, "hf_export")
        os.makedirs(ref_dir)
        keys = sorted(hf)
        for i, part in enumerate((keys[::2], keys[1::2])):
            torch.save({k: hf[k].cpu() for k in part},
                       os.path.join(ref_dir, f"pytorch_model-0000{i + 1}-of-00002.bin"))
        torch.save({"module": {k: v.cpu() for k, v in iv.items()}},
                   os.path.join(ref_root, "iv.pt"))
        torch.save({k: v.cpu() for k, v in clip.items()},
                   os.path.join(ref_root, "clip.bin"))
        write_s = time.perf_counter() - t0
        out_dir = os.path.join(d, "converted")
        run("convert_checkpoint", convert_checkpoint, [
            "--hf_export", ref_dir, "--internvideo_ckpt",
            os.path.join(ref_root, "iv.pt"), "--clip_ckpt",
            os.path.join(ref_root, "clip.bin"), "--out", out_dir])
        t0 = time.perf_counter()
        back = common.load_model(types.SimpleNamespace(checkpoint=out_dir), cfg)
        bad = [k for k in sd if k not in back or not torch.equal(
            back[k], sd[k].cpu())]
        if bad or set(back) != set(sd):
            raise AssertionError(f"convert_checkpoint: {len(bad)} tensors differ, "
                                 f"e.g. {bad[:3]}")
        size = os.path.getsize(os.path.join(out_dir, "params.pt"))
        log(f"  convert_checkpoint: reference layout written in {write_s:.1f} s; "
            f"{len(sd)} tensors ({size / 2**30:.2f} GiB) read back through "
            f"load_model and compared equal in {time.perf_counter() - t0:.1f} s")
    del sd
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------------ parity
PARITY_SEGMENTER_FRAMES = 6   # timed segmenter calls (after one warm call)
PARITY_BOXES = 3
TOL_PARITY_REF = TOL_SMALL_REF   # relative L2, the narrow clip_run's masks
                                 # (bf16 kernels on the card vs f32 twins)


def parity_expected(mode: str) -> dict:
    """Launches of one quant-stage `clip_run` of verify_parity at flagship
    width (16 frames, 2 SAM frames, 24 prompt ids, 12 new tokens, no stop
    token), by run: the towers, prefill and SAM encode of EXPECTED_TOWERS
    (whatever the SAM batch); K3's RMSNorm on the prefill's 2 x 32 + 1
    norms and InternVideo2's 4 a block over 39 blocks (a decode step's
    [1, 3072] rows stay under K3's 64K-element gate), its LayerNorm on
    CLIP's pre-norm and 2 a layer over 23, the SAM encode's 2 x 42 + 1 and
    the mask decoder's norm4 of its two two-way blocks on the keys (the 8
    prompts' queries stay under the gate). int8: the int8 cache, K4 once a
    layer and decode step, K5 four times a layer and once for the lm_head a
    step plus the lm_head after the prefill; int4: K5 the same, bf16 cache
    (the JAX harness quantises the KV cache with int8 only)."""
    from videoglamm_torch.cli import verify_parity as vp
    n = vp.N_NEW
    gemv = n * (4 * 32 + 1) + 1
    want = dict(EXPECTED_TOWERS, **{
        "row_norm[rms]": 2 * 32 + 1 + 4 * 39,
        "row_norm[ln]": 1 + 2 * 23 + 2 * 42 + 1 + 2,
        "decode_attention_q8": n * 32 if mode == "int8" else 0,
        "dequant_gemv[int8]": gemv if mode == "int8" else 0,
        "dequant_gemv[int4]": gemv if mode == "int4" else 0})
    return want


def segmenter_expected(calls: int) -> dict:
    """Launches of `calls` Sam2BoxSegmenter calls on Hiera-L at 1024: one
    image encode each (ENCODE) and the mask decoder's norm4 of its two
    two-way blocks on the keys [boxes, 4096, 256] (the queries, 8 tokens a
    box, stay under K3's gate); no LLM kernel."""
    want = {k: v * calls for k, v in ENCODE.items()}
    want["row_norm[ln]"] += 2 * calls
    want.update({"row_norm[rms]": 0, "attention_fwd[causal]": 0,
                 "decode_attention_q8": 0, "dequant_gemv[int8]": 0,
                 "dequant_gemv[int4]": 0})
    return want


def write_reference_checkpoint(cfg, root: str) -> dict:
    """The flagship seeded weights (bf16, as `build` makes them) in the
    reference layout under root: the HF export as pytorch_model.bin and the
    two tower files that `to_reference_layout` returns."""
    import os
    import torch
    from videoglamm_torch.io.reference import to_reference_layout
    t0 = time.perf_counter()
    gi = build(cfg, "none", "bf16", "the parity checkpoint's seeded weights")
    sd = {k: v.cpu() for k, v in gi.model.state_dict().items()}
    del gi
    torch.cuda.empty_cache()
    hf, iv, clip = to_reference_layout(sd, cfg)
    paths = {"dir": os.path.join(root, "hf_export"),
             "iv": os.path.join(root, "iv.pt"),
             "clip": os.path.join(root, "clip.bin")}
    os.makedirs(paths["dir"])
    torch.save(hf, os.path.join(paths["dir"], "pytorch_model.bin"))
    torch.save({"module": iv}, paths["iv"])
    torch.save(clip, paths["clip"])
    log(f"  parity checkpoint written in the reference layout in "
        f"{time.perf_counter() - t0:.1f} s")
    return paths


def trace_kernel_names(path: str) -> tuple:
    """(device kernel names with their event counts, annotation names) of a
    Chrome trace."""
    events = json.load(open(path))["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e.get("name")] = kernels.get(e.get("name"), 0) + 1
    notes = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    return kernels, notes


def phase_parity(cfg, seed: int, smi: str, ckpt=None):
    """verify_parity's second command of the JAX docstring on the card:
    the import and quant stages at flagship width on a reference-layout
    checkpoint of seeded weights (the cli phase's when it ran, else one
    written here), `--int4 --tokens_advisory`, through `main` inside
    `profile_trace`. The counters are set to 0 just before each of the
    three `clip_run`s and read just after (the module attribute is wrapped
    for that): each must equal `parity_expected`. The trace must hold the
    three runs' annotations and the kernels K1 to K5. Then the datagen
    segmenter on Hiera-L at 1024, a narrow segmenter and a narrow clip_run
    against their CPU f32 twins, and the memory report."""
    import os
    import tempfile
    import torch
    from videoglamm_torch.cli import verify_parity as vp
    from videoglamm_torch.utils import device_memory_report, profile_trace
    from videoglamm_torch.utils.profiling import TRACE_FILE

    with tempfile.TemporaryDirectory() as d:
        if ckpt is None:
            ckpt = write_reference_checkpoint(cfg, d)
        else:
            log("  parity: the cli phase's reference-layout checkpoint "
                "(convert_checkpoint's input)")
        runs = []
        real = vp.clip_run

        def counted(model, batch):
            torch.cuda.synchronize()
            reset_counts()
            out = real(model, batch)
            torch.cuda.synchronize()
            runs.append(read_counts())
            return out

        argv = ["--scale", "flagship", "--checkpoint", ckpt["dir"],
                "--internvideo_ckpt", ckpt["iv"], "--clip_ckpt", ckpt["clip"],
                "--stages", "import,quant", "--int4", "--tokens_advisory",
                "--seed", str(seed), "--out_dir", os.path.join(d, "report"),
                "--report_name", "parity_quant_cuda.json"]
        log(f"  verify_parity.main({argv})")
        t0 = time.perf_counter()
        vp.clip_run = counted
        try:
            with profile_trace(os.path.join(d, "trace")):
                rc = vp.main(argv)
                t_main = time.perf_counter() - t0
        finally:
            vp.clip_run = real
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        rep = json.load(open(os.path.join(d, "report", "parity_quant_cuda.json")))
        trace = os.path.join(d, "trace", TRACE_FILE)
        trace_mb = os.path.getsize(trace) / 2**20
        kernels, notes = trace_kernel_names(trace)
        t_read = time.perf_counter() - t1
    log("  parity report: " + json.dumps(rep))
    imp = rep["stages"]["import"]
    if rc != 0 or not rep["ok"] or imp["unmatched"] or imp["random_init_modules"]:
        raise AssertionError(f"verify_parity: rc {rc}, report {rep}")
    if len(runs) != 3:
        raise AssertionError(f"verify_parity ran clip_run {len(runs)} times")
    for name, counts in zip(("float", "int8", "int4"), runs):
        check_launches(counts, parity_expected(name), f"parity {name} run")
    for name in ("float", "int8", "int4"):
        if f"verify_parity/{name}" not in notes:
            raise AssertionError(f"the trace lacks the annotation of the {name} run")
    sources = {"K1": source_kernels("attention_fwd"),
               "K2": source_kernels("gemm_epilogue"),
               "K4": source_kernels("decode_attention_q8"),
               "K5": source_kernels("dequant_gemv")}
    # CUDA kernels by their __global__ name inside the demangled signature.
    # K3, the Triton kernel `kernel` of ops/norms.py, is exported to the
    # Chrome trace as "Kernel" (key_averages() lists it as "kernel"; summing
    # a trace this large there takes over a minute): at least one such event
    # for each K3 launch the three runs counted
    missing = [k for k, names in sources.items()
               if not any(n in key for n in names for key in kernels)]
    k3 = sum(c["row_norm[rms]"] + c["row_norm[ln]"] for c in runs)
    if kernels.get("Kernel", 0) < k3:
        missing.append(f"K3 ({kernels.get('Kernel', 0)} events for {k3} launches)")
    if missing:
        raise AssertionError(f"the trace lacks kernels of {missing}; its device "
                             f"kernels: {sorted(kernels)[:80]}")
    q = rep["stages"]["quant"]
    r = rep["runs"]
    log(f"  parity (flagship, {smi}): main() {t_main:.1f} s under the "
        f"profiler, the trace's export {wall - t_main:.1f} s ({trace_mb:.1f} "
        f"MB), reading it back {t_read:.1f} s; exit code {rc}, ok {rep['ok']}")
    for name in ("float", "int8", "int4"):
        log(f"    {name} run: clip_run {r[name]['run_s']:.3f} s, build "
            f"{r[name]['build_s']:.1f} s, peak device memory "
            f"{r[name]['peak_bytes'] / 2**30:.2f} GiB, valid [SEG] "
            f"{r[name]['seg_valid']}; launches = parity_expected('{name}')")
    for mode in ("int8", "int4"):
        log(f"    {mode}: token agreement {q[mode]['token_agreement']:.4f}, "
            f"mask IoU {q[mode]['mask_iou']:.4f}, valid [SEG] float "
            f"{q[mode]['float_seg_valid']} / {mode} {q[mode]['seg_valid']}, "
            f"ok {q[mode]['ok']}{' (advisory)' if mode == 'int4' else ''}")
    vacuous = all(r[n]["seg_valid"] == 0 for n in r)
    log(f"    the mask IoU gate {'is vacuous here' if vacuous else 'compared served masks'}: "
        f"{'no run emitted a [SEG], so every prompt embedding was zero' if vacuous else 'some run emitted [SEG]'}")
    log(f"    trace: annotations {sorted(n for n in notes if n.startswith('verify_parity'))}; "
        f"K1-K5 device kernels present")

    timer = phase_parity_segmenter(cfg, seed, smi)
    phase_parity_narrow(seed)
    log(f"  StepTimer over the segmenter's frames: {json.dumps(timer.summary())}")
    log(f"  device_memory_report(): {json.dumps(device_memory_report())}")
    return runs[1]


def write_anet_fixture(root: str, seed: int) -> int:
    """2 ANet-Entities GCG videos of 3 frames at 480x854 from the seed, 2
    [SEG:n] boxes each; returns the number of boxes."""
    import os
    import numpy as np
    from PIL import Image
    rng = np.random.RandomState(seed)
    n = 0
    for v in range(2):
        vid, seg = f"v_card{v}", str(v)
        fdir = os.path.join(root, "video_frames", vid, seg)
        os.makedirs(fdir)
        for t in range(3):
            Image.fromarray(_smooth_frame(rng)).save(os.path.join(fdir, f"{t:02d}.jpg"))
        boxes = {}
        for s in range(2):
            x0, y0 = rng.randint(0, RAW_W // 2), rng.randint(0, RAW_H // 2)
            boxes[f"[SEG:{s}]"] = {"frame_id": int(rng.randint(0, 3)), "bbox": [
                int(x0), int(y0), int(x0 + rng.randint(40, RAW_W // 2)),
                int(y0 + rng.randint(40, RAW_H // 2))]}
            n += 1
        os.makedirs(os.path.join(root, "anns"), exist_ok=True)
        json.dump({"refined_caption": "A man [SEG:0] hands a dog [SEG:1] a ball.",
                   "seg_token_to_obj": boxes},
                  open(os.path.join(root, "anns", f"{vid}____{seg}.json"), "w"))
    return n


def phase_parity_segmenter(cfg, seed: int, smi: str):
    """Sam2BoxSegmenter on `build_sam2()` (Hiera-L at 1024, seeded, bf16
    encoder) over a seeded 480x854 frame with 3 boxes, timed with
    StepTimer; then extract_anet_gcg_masks over a 2-video fixture. Launches
    against `segmenter_expected`."""
    import tempfile
    import numpy as np
    import torch
    from videoglamm_torch.data.datasets import ANetEntitiesGCGDataset
    from videoglamm_torch.datagen.mask_extract import (Sam2BoxSegmenter,
                                                       extract_anet_gcg_masks)
    from videoglamm_torch.inference.pipeline import build_sam2
    from videoglamm_torch.utils import StepTimer

    sam = build_sam2(cfg.sam2, init=lambda m: seeded_init(
        m, torch.Generator(device="cuda").manual_seed(seed + 7)))
    seg = Sam2BoxSegmenter(sam)
    rng = np.random.RandomState(seed)
    frame = _smooth_frame(rng)
    boxes = [[100, 80, 420, 400], [300, 50, 800, 300], [0, 0, 853, 479]]
    masks = seg(frame, boxes)                      # warm
    timer = StepTimer()
    torch.cuda.synchronize()
    reset_counts()
    for _ in range(PARITY_SEGMENTER_FRAMES):
        timer.start()
        masks = seg(frame, boxes)                  # ends in a host copy
        timer.stop()
    counts = read_counts()
    # where a frame's time goes: the host preprocessing, the card's
    # encode and decode, the resize back and its copy to the host
    from videoglamm_torch.data.preprocess import preprocess_sam2
    from videoglamm_torch.evals.postprocess import masks_to_original_size
    img, pre_ms = _wall(lambda: torch.from_numpy(
        preprocess_sam2([frame], seg.size)).cuda())
    sb = torch.tensor(boxes, dtype=torch.float32, device="cuda") * torch.tensor(
        [seg.size / RAW_W, seg.size / RAW_H] * 2, device="cuda")
    low, dev_ms = _wall(lambda: seg.segment(img, sb))
    _, post_ms = _wall(lambda: masks_to_original_size(low, (RAW_H, RAW_W)))
    check_launches(counts, segmenter_expected(PARITY_SEGMENTER_FRAMES),
                   "segmenter")
    if masks.shape != (PARITY_BOXES, RAW_H, RAW_W) or masks.dtype != bool:
        raise AssertionError(f"segmenter masks {masks.shape} {masks.dtype}")
    s = timer.summary()
    log(f"  Sam2BoxSegmenter, Hiera-L at 1024, {PARITY_BOXES} boxes on a "
        f"{RAW_H}x{RAW_W} frame: {s['mean_s'] * 1e3:.1f} ms a frame (mean of "
        f"{s['n']}, p50 {s['p50_s'] * 1e3:.1f}; apart: host preprocess_sam2 "
        f"and upload {pre_ms:.1f}, encode and decode {dev_ms:.1f}, resize and "
        f"copy back {post_ms:.1f}), foreground "
        f"{[int(m.sum()) for m in masks]} px; launches = segmenter_expected "
        f"x {PARITY_SEGMENTER_FRAMES} ({smi})")
    with tempfile.TemporaryDirectory() as d:
        n_boxes = write_anet_fixture(d, seed)
        reset_counts()
        t0 = time.perf_counter()
        n = extract_anet_gcg_masks(seg, d)
        dt = time.perf_counter() - t0
        counts = read_counts()
        check_launches(counts, segmenter_expected(n_boxes), "extract_anet_gcg_masks")
        rec = ANetEntitiesGCGDataset(d)[0]
        if n != n_boxes or rec["masks"][0].shape[0] != 2:
            raise AssertionError(f"extract_anet_gcg_masks wrote {n} of {n_boxes}")
    log(f"  extract_anet_gcg_masks over 2 videos: {n} masks in {dt:.2f} s; "
        f"launches = segmenter_expected x {n_boxes}; the dataset loads them")
    del sam, seg
    torch.cuda.empty_cache()
    return timer


def phase_parity_narrow(seed: int):
    """A narrow segmenter (`track_config(1024)`) and a narrow clip_run
    (`small_config()`) in bf16 on the card against the same weights in f32
    on the CPU through the plain twins."""
    import numpy as np
    import torch
    from videoglamm_torch.cli import verify_parity as vp
    from videoglamm_torch.data.preprocess import preprocess_sam2
    from videoglamm_torch.datagen.mask_extract import Sam2BoxSegmenter
    from videoglamm_torch.inference.pipeline import build_inference, build_sam2
    from videoglamm_torch.ops.resize import resize_bilinear

    scfg = track_config(1024)
    ref = build_sam2(scfg, device="cpu", dtype=torch.float32, init=lambda m: fan_in_init(
        m, torch.Generator().manual_seed(seed + 71)))
    dev = build_sam2(scfg, ref.state_dict(), device="cuda", dtype=torch.bfloat16)
    frame = _smooth_frame(np.random.RandomState(seed + 1))
    boxes = np.asarray([[100, 80, 420, 400], [300, 50, 800, 300]], np.float32)
    size = scfg.image_size
    img = torch.from_numpy(preprocess_sam2([frame], size))
    sb = torch.from_numpy(boxes * np.asarray([size / RAW_W, size / RAW_H] * 2,
                                             np.float32))
    with torch.no_grad():
        want = Sam2BoxSegmenter(ref).segment(img, sb)
        got = Sam2BoxSegmenter(dev).segment(img.cuda(), sb.cuda())
    hold_close("narrow segmenter", got, want, "low-res mask logits")
    up = resize_bilinear(want[..., None], (RAW_H, RAW_W))[..., 0]
    hold_masks("narrow segmenter", Sam2BoxSegmenter(dev)(frame, boxes), up,
               "masks at 480x854")
    del ref, dev

    cfg = small_config()
    ref = build_inference(cfg, device="cpu", dtype=torch.float32, init=lambda m: fan_in_init(
        m, torch.Generator().manual_seed(seed + 72))).model
    dev = build_inference(cfg, ref.state_dict(), device="cuda",
                          dtype=torch.bfloat16).model
    batch, _ = vp.make_batch(cfg, seed, torch.float32, "cpu")
    tok_c, masks_c, seg_c = vp.clip_run(ref, batch)
    dbatch = {k: v.cuda().to(torch.bfloat16) if v.is_floating_point() else v.cuda()
              for k, v in batch.items()}
    tok_d, masks_d, seg_d = vp.clip_run(dev, dbatch)
    agree = float((tok_c == tok_d).mean())
    log(f"  narrow clip_run: tokens agree {agree:.3f} (free-running greedy, "
        f"not held), valid [SEG] card {seg_d} / CPU {seg_c}")
    if seg_c != seg_d:
        raise AssertionError("narrow clip_run: the [SEG] counts differ")
    hold_close("narrow clip_run", masks_d, masks_c, "mask logits",
               tol=TOL_PARITY_REF)
    del ref, dev
    torch.cuda.empty_cache()


def fan_in_init(model, g):
    """Random weights from a seed whose activations keep their scale
    through depth, so that mask logits lie away from 0 by more than bf16
    rounding: matrices and convs N(0, 1 / fan_in), norm scales 1, norm
    biases 0, other vectors and embeddings N(0, 0.02), the random-Fourier
    PE matrix standard normal."""
    import torch
    seeded_init(model, g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() >= 2 and "embed" not in name and "token" not in name:
                fan = p[0].numel()
                p.normal_(0.0, fan ** -0.5, generator=g)
    return model


def forced_generation(stream):
    """A stand-in for `generate_with_prefix` that feeds `stream` (token ids
    holding [SEG]) through the model's prefill and cached decode steps,
    teacher-forced, and records each fed token's hidden state as the
    generation does: the [SEG] hidden states are the model's own."""
    import torch
    from videoglamm_torch.inference.generate import (GenerateResult,
                                                     decode_step, prefill)

    def generate(model, visual, input_ids, text_lens, *, max_new_tokens,
                 **_):
        n = len(stream)
        hidden_pre, cache, sp, _ = prefill(
            model.llm, visual, input_ids, text_lens, n,
            quant_kv=model.quant_kv_int8)
        B = input_ids.shape[0]
        tok = torch.tensor(stream, device=input_ids.device)[None].expand(B, n)
        hs = [decode_step(model.llm, cache, tok[:, j], sp.attn_lens + j)[1]
              for j in range(n)]
        return GenerateResult(tokens=tok, hidden=torch.stack(hs, 1),
                              lengths=torch.full((B,), n, device=tok.device),
                              prefill_hidden=hidden_pre,
                              prefill_len=sp.attn_lens)
    return generate


def phase_cli_forced_seg(seed: int, smi: str):
    """eval_gcg_infer on the narrow model (`small_config()`: flagship image
    sizes and frame counts, narrow towers) over the cli fixture's GCG root,
    once on the card in bf16 and once on the CPU in f32, with the
    generation stubbed to a token stream holding two [SEG]: the served
    masks of real [SEG] hidden states. The results JSON must be equal, the
    PNG files the same set, and a pixel may differ only where the CPU's
    resized logit lies within the largest card-vs-CPU logit difference of
    0; the logits are held by relative L2 (TOL_SMALL_REF, as the narrow
    model's other outputs). --min_blob 0 on both: the blob
    filter is host code and would turn a pixel at the threshold into a
    blob."""
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    from videoglamm_torch.cli import eval_gcg_infer
    from videoglamm_torch.config import VideoGLaMMConfig
    from videoglamm_torch.inference import pipeline
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.ops.resize import resize_bilinear

    cfg = small_config()
    sd = build_inference(cfg, device="cpu", dtype=torch.float32, init=lambda m: fan_in_init(
        m, torch.Generator().manual_seed(seed + 73))).model.state_dict()
    narrow = staticmethod(lambda: cfg)
    tok = CLITokenizer(cfg.seg_token_idx, cfg.llm.vocab_size)
    stream = [101, 202, cfg.seg_token_idx, 303, 404, cfg.seg_token_idx, 505]
    captured = {}

    def run(where, argv):
        real = (eval_gcg_infer.load_model, eval_gcg_infer.load_tokenizer,
                eval_gcg_infer.masks_of, pipeline.generate_with_prefix,
                VideoGLaMMConfig.flagship)
        logits = captured.setdefault(where, [])

        def masks_of(res, orig_hw):
            valid = res.seg_valid[0]
            logits.append((res.pred_masks[0][valid].float().cpu(), orig_hw))
            return real[2](res, orig_hw)
        eval_gcg_infer.load_model = lambda args, cfg_=None: sd
        eval_gcg_infer.load_tokenizer = lambda path: tok
        eval_gcg_infer.masks_of = masks_of
        pipeline.generate_with_prefix = forced_generation(stream)
        VideoGLaMMConfig.flagship = narrow
        out = StampedLines()
        stdout = sys.stdout
        try:
            sys.stdout = out
            reset_counts()
            t0 = time.perf_counter()
            ret = eval_gcg_infer.main(argv)
            if where == "card":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            sys.stdout = stdout
            (eval_gcg_infer.load_model, eval_gcg_infer.load_tokenizer,
             eval_gcg_infer.masks_of, pipeline.generate_with_prefix) = real[:4]
            VideoGLaMMConfig.flagship = real[4]
        return ret, wall, read_counts(), [ln for _, ln in out.lines]

    def files(root):
        out = {}
        for dirpath, _, names in os.walk(root):
            for f in names:
                p = os.path.join(dirpath, f)
                k = os.path.relpath(p, root)
                out[k] = (np.asarray(Image.open(p)) if f.endswith(".png")
                          else json.load(open(p)))
        return out

    with tempfile.TemporaryDirectory() as d:
        fx = write_cli_fixture(os.path.join(d, "data"), seed)
        model = ["--checkpoint", "seeded", "--tokenizer", "word-level",
                 "--max_new_tokens", str(CLI_MAX_NEW), "--min_blob", "0",
                 "--data_root", os.path.join(fx["root"], "gcg")]
        ret_c, wall_c, counts, lines = run("card", model + [
            "--save_dir", os.path.join(d, "card")])
        ret_h, wall_h, _, _ = run("cpu", model + [
            "--save_dir", os.path.join(d, "cpu"), "--device", "cpu",
            "--precision", "f32"])
        card, cpu = files(os.path.join(d, "card")), files(os.path.join(d, "cpu"))
    if ret_c != ret_h or ret_c != {"videos": 2, "resumed": 0, "skipped": 0}:
        raise AssertionError(f"forced [SEG] eval_gcg_infer: {ret_c} vs {ret_h}")
    for k in ("attention_fwd[causal]", "attention_fwd[bshd]", "attention_fwd[flash]",
              "fused_window_block", "gemm_epilogue", "row_norm[ln]"):
        if counts[k] == 0:
            raise AssertionError(f"forced [SEG] eval_gcg_infer: {k} never launched")
    if sorted(card) != sorted(cpu):
        raise AssertionError("forced [SEG] eval_gcg_infer: the card wrote other files")
    pngs = [k for k in card if k.endswith(".png")]
    for k in card:
        if not k.endswith(".png") and card[k] != cpu[k]:
            raise AssertionError(f"forced [SEG] eval_gcg_infer: {k} differs")
    n_obj = sum(int(ln.split()[-2]) for ln in lines if ln.startswith("[ok]"))
    if n_obj != 4 or len(pngs) != 4 * CLI_GCG_FRAMES:
        raise AssertionError(f"forced [SEG]: {n_obj} objects, {len(pngs)} PNGs")
    def up(logits, hw):       # [n, T, h, w] -> [n, T, H, W] f32 on the CPU
        x = resize_bilinear(logits.reshape((-1,) + logits.shape[-2:] + (1,)), hw)
        return x[..., 0].reshape(logits.shape[:2] + tuple(hw))

    vids = sorted({k.split(os.sep)[0] for k in pngs})
    worst, ref = 0.0, {}
    for v, (lc, hw), (lh, _) in zip(vids, captured["card"], captured["cpu"]):
        hold_close("forced [SEG] eval_gcg_infer", lc, lh,
                   f"{v}'s served mask logits", tol=TOL_SMALL_REF)
        ref[v] = up(lh, hw)
        worst = max(worst, (up(lc, hw) - ref[v]).abs().max().item())
    band = max(worst, TOL_MASK_THRESHOLD)
    differ = far = 0
    for k in pngs:
        v, _, obj, name = k.split(os.sep)
        moved = torch.from_numpy(card[k] != cpu[k])
        differ += int(moved.sum())
        far += int((moved & (ref[v][int(obj), int(name[:-4])].abs() > band)).sum())
    log(f"  forced [SEG] eval_gcg_infer (narrow model, 2 videos x "
        f"{CLI_GCG_FRAMES} frames, stream {stream}): card {wall_c:.2f} s, CPU "
        f"f32 {wall_h:.2f} s; {n_obj} objects, {len(pngs)} PNGs, results JSON "
        f"equal; {differ} PNG pixels differ, {far} of them farther than "
        f"{band:.3g} (the largest resized-logit difference) from 0 ({smi})")
    if far:
        raise AssertionError("forced [SEG] eval_gcg_infer: masks differ away "
                             "from the threshold")


# ---------------------------------------------------------------------------
# f32 on the card: the full-precision f32 routes of K1, K2 and K6, the f32
# flagship serving and training, a narrow f32 model against its CPU twin;
# then training through the towers (freeze_towers=False)
# ---------------------------------------------------------------------------
TOL_F32_ROUTE = 1e-5    # relative L2, and max|d| / max(1, max|ref|), of an
                        # f32 route against its f32 twin with TF32 off: the
                        # same f32 products and sums, in another order; an
                        # operand rounded to bf16 or TF32 would move it to
                        # 1e-3
TOL_F32_LSE = 2e-5      # K1 "simt_f32"'s LSE, max|d|: exp2 / log2 against
                        # the twin's logsumexp of O(10) values
TOL_F32_MODEL = 1e-4    # relative L2, a narrow f32 model on the card against
                        # its CPU f32 twin through a few layers: logits,
                        # masks, loss and every gradient held
TOL_F32_POOLED = 2e-3   # the same for a Hiera block's gradients when the
                        # loss reaches them through a 2x2 max-pooling block:
                        # a near-tie routes the gradient to another token
                        # when the forward moves by an ulp. On the CPU alone
                        # a 1e-7 relative change of the SAM frames moves the
                        # narrow towers' stage-3 block gradients by 4.4e-4;
                        # the trunk check below holds the same
                        # blocks at TOL_F32_MODEL with the gradient injected
                        # above the pooling
N_F32_REQUESTS = 2      # framewise f32 requests (then one on the video branch)
F32_TRAIN_STEPS = 3
F32_TRAIN_ROWS = 2      # rows (and videos) of an f32 training micro-step
# the leaves that train in the towers phase: both projectors, one
# InternVideo2 block, one CLIP layer, a Hiera window block and a Hiera
# global block (narrow: `towers_config`, whose trunk is blocks 0-6 with the
# global block 4 and the fused window block 5; flagship: Hiera-L's first
# window block and its first global block, so the backward crosses every
# block of each tower)
TOWER_LEAVES_NARROW = (r"^(image_)?mm_projector\.", r"^vision_tower\.blocks\.1\.",
                       r"^image_vision_tower\.encoder\.layers\.1\.",
                       r"trunk\.blocks\.4\.", r"trunk\.blocks\.5\.")
TOWER_LEAVES_FLAGSHIP = (r"^(image_)?mm_projector\.", r"^vision_tower\.blocks\.0\.",
                         r"^image_vision_tower\.encoder\.layers\.0\.",
                         r"trunk\.blocks\.0\.", r"trunk\.blocks\.23\.")


def hiera_window_shapes(cfg, frames: int):
    """(stage, [B,H,S,D] of K1's window mode, win, rows M, width C) of the
    fused block at each Hiera stage over `frames` SAM frames, as
    `fused_window_block` packs the windows (`window_fold`)."""
    from videoglamm_torch.ops.fused_block import window_fold
    h = cfg.sam2.hiera
    side = cfg.sam2.image_size // h.patch_stride
    out = []
    for s in range(len(h.stages)):
        C, H = int(h.embed_dim * h.dim_mul ** s), int(h.num_heads * h.head_mul ** s)
        ws = h.window_spec[s]
        NW = frames * (side // ws) ** 2
        f = window_fold(NW, ws * ws)
        out.append((s + 1, (NW // f, H, ws * ws * f, C // H),
                    ws * ws if f > 1 else 0, NW * ws * ws, C))
        side //= 2
    return out


def phase_f32_kernels(K: Kernels, cfg):
    """Each full-precision f32 route against its f32 twin (TF32 off) at the
    f32 model's path shapes: K1 "simt_f32" in every mode, K2's f32 route at
    the 16 products of Hiera-L's four stages over 8 SAM frames, K6's f32
    route at the training shape and at the Hiera global blocks."""
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.ops import attention as A
    from videoglamm_torch.ops import fused_block as FB

    g = torch.Generator(device="cuda").manual_seed(17)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")

    def k1(name, B, H, Sq, Sk, D, mode, causal=False, kv=None, win=0,
           with_lse=False):
        q, k, v = randn(B, H, Sq, D), randn(B, H, Sk, D), randn(B, H, Sk, D)
        kvl = torch.tensor(kv or [Sk] * B, **i32)
        qs = (kvl - Sq) if causal else torch.zeros(B, **i32)
        out = torch.empty_like(q)
        lse = torch.empty(B, H, Sq, device="cuda") if with_lse else None
        scale = D ** -0.5

        def kern():
            return A.attention_fwd_kernel(
                q, k, v, out, causal=causal, sm_scale=scale, mode=mode,
                kv_lens=kvl, q_start=qs, win=win, lse=lse, exact=True)

        if win:
            def plain():
                return A._attention_plain_bshd(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    scale, win).transpose(1, 2)
            blk = torch.arange(Sq, device="cuda") // win
            mask = blk[:, None] == blk[None, :]
            lib = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
            pairs = B * Sq * win
        else:
            def plain():
                return A._flash_fwd_plain(q, k, v, kvl, qs, causal, scale)[0]
            lib = lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=causal)
            pairs = attended_pairs(Sq, Sk, kvl.tolist(), qs.tolist(), causal)
        nbytes = 4 * B * H * D * (2 * Sq + 2 * Sk) + (4 * B * H * Sq if with_lse else 0)
        K.compare(f"attention_fwd_f32@{name}",
                  f"K1 simt_f32 {name} [{B},{H},{Sq},{D}] over Sk={Sk}"
                  f"{' causal' if causal else ''}{f' win={win}' if win else ''}",
                  kern, plain, TOL_F32_ROUTE, nbytes=nbytes,
                  ops=4 * D * H * pairs, rate="f32", library_fn=lib,
                  tol_l2=TOL_F32_ROUTE)
        if with_lse:
            kern()
            _, ref = A._flash_fwd_plain(q, k, v, kvl, qs, causal, scale)
            torch.cuda.synchronize()
            err = (lse - ref).abs().max().item()
            log(f"  K1 simt_f32 {name}: LSE max|d| {err:.3e} (tol {TOL_F32_LSE:g})")
            if not err <= TOL_F32_LSE:
                raise AssertionError(f"K1 simt_f32 {name}: LSE disagrees")

    T = T_SAM
    k1("causal Phi-3 prefill", 1, 32, 3391, 3391, 96, "causal", causal=True)
    k1("causal train LSE", 2, 32, 3456, 3456, 96, "causal", causal=True,
       kv=[3456, 3300], with_lse=True)
    k1("flash Hiera global", T, 8, 4096, 4096, 72, "flash")
    k1("flash_d256 memory self-attention", 4, 1, 4096, 4096, 256, "flash_d256")
    k1("bshd CLIP", 16, 16, 577, 577, 64, "bshd")
    k1("bshd InternVideo2", 4, 16, 1025, 1025, 88, "bshd")
    for stage, (B, H, S, D), win, _, _ in hiera_window_shapes(cfg, T):
        k1(f"window Hiera stage {stage}", B, H, S, S, D, "window", win=win)
    torch.cuda.empty_cache()

    # K2's f32 route at the four products of each Hiera-L stage
    for stage, _, _, M, C in hiera_window_shapes(cfg, T):
        a = randn(M, C)
        for prod, (N, Kd, gelu, res) in (("qkv", (3 * C, C, False, False)),
                                         ("proj", (C, C, False, True)),
                                         ("fc1", (4 * C, C, True, False)),
                                         ("fc2", (C, 4 * C, False, True))):
            x = a if Kd == C else randn(M, Kd)
            w, b = randn(N, Kd) * Kd ** -0.5, 0.1 * randn(N)
            r = randn(M, N) if res else None
            plan = FB.k2_f32_plan(M, N, Kd)
            log(f"  K2 f32 stage {stage} {prod}: plan " + ", ".join(
                f"{k} {plan[k]}" for k in ("bm", "bn", "bk", "kblock", "stages",
                                           "split_stages", "tiles", "chunks",
                                           "smem")))
            K.compare(f"gemm_epilogue_f32@stage {stage} {prod}",
                      f"K2 f32 Hiera stage {stage} {prod} [{M},{Kd}] x [{N},{Kd}]"
                      f"{' + GELU' if gelu else ''}{' + residual' if res else ''}",
                      lambda: FB.gemm_epilogue(x, w, b, gelu=gelu, residual=r),
                      lambda: FB._gemm_plain(x, w, b, gelu=gelu, residual=r),
                      TOL_F32_ROUTE,
                      nbytes=4 * (M * Kd + N * Kd + N + M * N * (2 if res else 1)),
                      ops=2 * M * N * Kd, rate="f32",
                      library_fn=lambda: F.linear(x, w, b), tol_l2=TOL_F32_ROUTE)
            del x, w, b, r
        del a
        torch.cuda.empty_cache()

    # K6's f32 route
    for name, (B, H, S, D), causal, kv in (
            ("train causal", (2, 32, 3456, 96), True, [3456, 3300]),
            ("Hiera global", (2 * T_SAM_TRAIN, 8, 4096, 72), False, None)):
        q, k, v, do = (randn(B, H, S, D) for _ in range(4))
        kvl = torch.tensor(kv or [S] * B, **i32)
        qs = (kvl - S) if causal else torch.zeros(B, **i32)
        scale = D ** -0.5
        out, lse = A._flash_fwd_plain(q, k, v, kvl, qs, causal, scale)
        bwd = lambda: A.flash_bwd_kernel(q, k, v, out, lse, do, causal=causal,
                                         sm_scale=scale, kv_lens=kvl, q_start=qs)
        plain = lambda: A._flash_bwd_plain(q, k, v, out, lse, do, kvl, qs,
                                           causal, scale)
        got, want = bwd(), plain()
        torch.cuda.synchronize()
        rels = [rel_l2(a, b) for a, b in zip(got, want)]
        errs = [rel_err(a, b) for a, b in zip(got, want)]
        del got, want
        ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

        def lib_fb():
            o = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
            return torch.autograd.grad(o, (ql, kl, vl), do)

        def lib_f():
            with torch.no_grad():
                return F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)

        ms, plain_ms = time_ms(bwd), time_ms(plain, reps=3, warmup=1)
        library_ms = time_ms(lib_fb) - time_ms(lib_f)
        pairs = attended_pairs(S, S, kvl.tolist(), qs.tolist(), causal)
        ops = 5 * 2 * D * pairs * H
        nbytes = 4 * B * H * D * 8 * S + 2 * 4 * B * H * S
        t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS["f32"] * 1e3
        ok = max(rels) <= TOL_F32_ROUTE and max(e[1] for e in errs) <= TOL_F32_ROUTE
        log(f"  K6 f32 {name} [{B},{H},{S},{D}]{' causal' if causal else ''}: "
            f"rel L2 dq={rels[0]:.3e} dk={rels[1]:.3e} dv={rels[2]:.3e} (tol "
            f"{TOL_F32_ROUTE:g}) max_abs_err={max(e[0] for e in errs):.3e} "
            f"kernel={ms:.4f} ms ({ops / ms / 1e9:.1f} TFLOP/s) plain="
            f"{plain_ms:.4f} ms library={library_ms:.4f} ms (SDPA f32 forward"
            f"+backward less forward) bound={max(t_bytes, t_ops):.4f} ms "
            f"({'bytes' if t_bytes >= t_ops else 'operations'}) "
            f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise AssertionError(f"K6 f32 {name}: disagrees with its plain twin")
        K.rows[f"flash_bwd_f32@{name}"] = dict(
            max_abs_err=max(e[0] for e in errs), ms=ms, plain_ms=plain_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=library_ms)
        del q, k, v, do, out, lse, ql, kl, vl
        torch.cuda.empty_cache()


def _tf32_spy():
    """Record cuDNN's and cuBLAS's TF32 flags at every convolution call
    (F.conv2d, F.conv3d, F.conv_transpose2d, which the modules call);
    returns (the records, a function that removes the spy)."""
    import torch.nn.functional as F
    import torch
    seen, saved = [], {}
    for name in ("conv2d", "conv3d", "conv_transpose2d"):
        fn = saved[name] = getattr(F, name)

        def spy(*a, _fn=fn, **kw):
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))
            return _fn(*a, **kw)
        setattr(F, name, spy)

    def remove():
        for name, fn in saved.items():
            setattr(F, name, fn)
    return seen, remove


def phase_f32_serve(cfg):
    """The flagship in f32 through `build_inference(dtype=torch.float32)`:
    N_F32_REQUESTS framewise requests and one on the video branch, from
    raw frames, under torch's default TF32 flags (cuDNN on, cuBLAS off):
    every convolution must run with both off (the model's
    `full_precision`), and the defaults come back after. Returns the
    launch counts of the framewise and the video-branch runs."""
    import torch
    from videoglamm_torch.inference.pipeline import build_inference

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gi = build_inference(
        cfg, device="cuda", dtype=torch.float32, max_new_tokens=MAX_NEW,
        init=lambda m: seeded_init(
            m, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in gi.model.parameters())
    log(f"  flagship VideoGLaMM in f32: {n / 1e9:.3f} B parameters, built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
        f"exact_f32={gi.model.exact_f32}")
    if not gi.model.exact_f32:
        raise AssertionError("f32: build_inference did not mark the model f32")
    raw = [make_raw_request(cfg, 300 + i) for i in range(N_F32_REQUESTS)]
    script_flags = (torch.backends.cudnn.allow_tf32,
                    torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True       # torch's defaults
    torch.backends.cuda.matmul.allow_tf32 = False
    seen, remove = _tf32_spy()
    try:
        results, counts = phase_serve(gi, cfg, "f32", raw, raw=True)
        check_outputs(cfg, results, "f32")
        del results
        results, track_counts = phase_serve(gi, cfg, "f32_track", raw[:1],
                                            raw=True, track=True)
        check_outputs(cfg, results, "f32 video branch", t_sam=cfg.num_frames)
        after = (torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul.allow_tf32)
    finally:
        remove()
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
            script_flags
    tf32 = sum(1 for c, m in seen if c or m)
    log(f"  f32: {len(seen)} convolution calls while serving, {tf32} of them "
        f"with TF32 allowed; flags after the requests: cuDNN {after[0]}, "
        f"cuBLAS {after[1]} (torch's defaults: True, False)")
    if not seen or tf32 or after != (True, False):
        raise AssertionError("f32: the model did not keep its convolutions "
                             "and products out of TF32, or left the flags changed")
    for what, c in (("framewise", counts), ("video branch", track_counts)):
        if c["stage_bf16"] or c["k1_route[wgmma]"] or c["k1_route[wgmma_f32]"]:
            raise AssertionError(f"f32 {what}: a launch left the f32 routes {c}")
    del gi, results
    torch.cuda.empty_cache()
    return counts, track_counts


def phase_f32_train(cfg, seed: int):
    """F32_TRAIN_STEPS optimizer steps of GRAD_ACCUM micro-steps of the f32
    flagship through `build_training(dtype=torch.float32)`: finite, falling
    loss, frozen leaves bit-equal, launches by the bf16 formula on the f32
    routes, peak memory. Returns the launch counts."""
    import torch
    from videoglamm_torch.config import TrainConfig
    from videoglamm_torch.training import build_training

    tcfg = TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       grad_accum_steps=GRAD_ACCUM)
    t0 = time.perf_counter()
    tr = build_training(
        cfg, tcfg, device="cuda", dtype=torch.float32,
        init=lambda m: seeded_init(
            m, torch.Generator(device="cuda").manual_seed(0)))
    torch.cuda.synchronize()
    params = tr.state.params
    trainable = set(tr.tx.trainable)
    log(f"  flagship VideoGLaMM for training in f32: built in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    micro = [make_train_batch(cfg, seed + i, dtype=torch.float32,
                              rows=F32_TRAIN_ROWS, videos=F32_TRAIN_ROWS)
             for i in range(GRAD_ACCUM)]
    batch = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
    del micro
    t0 = time.perf_counter()
    frozen0 = {n: p.detach().cpu() for n, p in params.items()
               if n not in trainable}
    log(f"  copy of the {len(frozen0)} frozen leaves on the host: "
        f"{time.perf_counter() - t0:.1f} s")
    state = tr.state
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(F32_TRAIN_STEPS):
        timings = {}
        t0 = time.perf_counter()
        state, metrics = tr.train_step(state, batch, timings=timings)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = {k: float(v) for k, v in metrics.items()}
        losses.append(m["loss"])
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"f32 train step {i}: non-finite loss {m}")
        log(f"  f32 train step {i}: wall {wall:.3f} s, "
            + ", ".join(f"{k} {v:.3f} s" for k, v in timings.items())
            + ", " + ", ".join(f"{k} {v:.5f}" for k, v in m.items()))
    counts = read_counts()
    log(f"  f32 train: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB at micro-batch "
        f"{F32_TRAIN_ROWS} videos x {F32_TRAIN_ROWS} rows")
    log(f"  f32 train: launches over {F32_TRAIN_STEPS} optimizer steps: "
        + json.dumps(counts))
    n_micro = F32_TRAIN_STEPS * GRAD_ACCUM
    for name, n in counts.items():
        per = EXPECTED_PER_MICRO_STEP_F32.get(name)
        if per is None:
            if n == 0:
                raise AssertionError(f"{name} was never launched on the f32 "
                                     "training path")
        elif n != per * n_micro:
            raise AssertionError(f"{name}: {n} launches on the f32 training "
                                 f"path, expected {per} per micro-step x {n_micro}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"f32 train: the loss did not fall: {losses}")
    changed = [n for n, ref in frozen0.items()
               if not torch.equal(params[n].detach().cpu(), ref)]
    if changed:
        raise AssertionError(f"f32 train: frozen parameters changed: {changed[:4]}")
    log(f"  f32 train: losses {', '.join(f'{x:.5f}' for x in losses)}: last "
        "below first; all frozen leaves bit-equal to their start")
    # one more step under the profiler: where the f32 step's device time goes
    device_busy(lambda: tr.train_step(state, batch), "f32 train step", top=16)
    del tr, state, params, frozen0, batch
    torch.cuda.empty_cache()
    return counts


def hold_grads(what, got, want, names, tol_leaf, tol_all):
    """The gradients `got` (card) against `want` (CPU) of the named leaves:
    all together and leaf by leaf by relative L2 (a leaf whose gradient is
    below 1e-4 of the total, a softmax's key bias, holds rounding on both
    sides and counts in the total only)."""
    d2s = w2s = 0.0
    leaves = []
    for n in names:
        w = want[n]
        a = got[n]
        if w is None:
            if a is not None and bool(a.abs().max() > 0):
                raise AssertionError(f"{what}: {n} has a gradient on the card only")
            continue
        a = (a.float().cpu() if a is not None else w * 0)
        d2, w2 = float((a - w).norm()) ** 2, float(w.norm()) ** 2
        d2s, w2s = d2s + d2, w2s + w2
        leaves.append((d2, w2, n))
    rel_all = (d2s / w2s) ** 0.5
    scored = sorted((((d2 / w2) ** 0.5, n) for d2, w2, n in leaves
                     if w2 ** 0.5 > 1e-4 * w2s ** 0.5), reverse=True)
    log(f"  {what}: {len(leaves)} leaves, all together rel L2 {rel_all:.3e} "
        f"(tol {tol_all:g}); the worst leaves (tol {tol_leaf:g}): "
        + ", ".join(f"{n} {r:.3e}" for r, n in scored[:3]))
    if not (rel_all <= tol_all and scored and scored[0][0] <= tol_leaf):
        raise AssertionError(f"{what}: gradients on the card disagree with "
                             "the CPU reference")


def phase_f32_small(seed: int):
    """A narrow f32 model (`small_config`) on the card against the same
    weights in f32 on the CPU: teacher-forced logits and mask logits, then
    one training micro-step's loss and every trainable leaf's gradient."""
    import torch
    from videoglamm_torch.config import LoRAConfig, TrainConfig
    from videoglamm_torch.constants import IMAGE_TOKEN_INDEX
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.models.multimodal import splice_visual_prefix
    from videoglamm_torch.models.videoglamm import SegExtraction
    from videoglamm_torch.training import build_training

    cfg = small_config()
    f32 = torch.float32
    ref = build_inference(cfg, device="cpu", dtype=f32, init=lambda m: seeded_init(
        m, torch.Generator().manual_seed(3))).model
    dev = build_inference(cfg, ref.state_dict(), device="cuda", dtype=f32).model
    g = torch.Generator().manual_seed(seed + 11)
    T = cfg.num_frames
    frames = torch.randn(1, T, 224, 224, 3, generator=g)
    context = torch.randn(1, T, 336, 336, 3, generator=g)
    sam = torch.randn(1, 1, 1024, 1024, 3, generator=g)
    n_forced = 16
    ids = torch.randint(1, 32000, (1, S_TEXT + n_forced), generator=g)
    ids[:, 2] = IMAGE_TOKEN_INDEX
    lens = torch.tensor([S_TEXT + n_forced])
    seg = SegExtraction(torch.randn(1, cfg.max_seg_tokens, cfg.out_dim, generator=g),
                        torch.ones(1, cfg.max_seg_tokens, dtype=torch.bool),
                        torch.arange(cfg.max_seg_tokens)[None])

    def run(model, device):
        on = lambda t: t.to(device)
        visual = model.encode_visual_prefix(on(frames), on(context))
        sp = splice_visual_prefix(model.llm.embed(on(ids)), on(ids), visual,
                                  on(lens))
        logits, _, _ = model.llm(sp.embeds, sp.positions, sp.attn_lens)
        feats, _ = model.encode_sam_features(on(sam))
        masks = model.decode_masks(feats, SegExtraction(*map(on, seg)),
                                   torch.arange(1, device=device))
        return dict(teacher_forced_logits=logits, masks=masks)

    with torch.no_grad():
        want = run(ref, "cpu")
        reset_counts()
        got = run(dev, "cuda")
        torch.cuda.synchronize()
        counts = read_counts()
    for k, w in want.items():
        rel = rel_l2(got[k].cpu(), w)
        log(f"  narrow f32 model, {k} {tuple(w.shape)}: card f32 vs CPU f32 "
            f"rel L2 {rel:.3e} (tol {TOL_F32_MODEL:g})")
        if not rel <= TOL_F32_MODEL:
            raise AssertionError(f"narrow f32 model {k}: the card disagrees")
    if not (counts["attention_fwd_f32"] and counts["gemm_epilogue_f32"]) \
            or counts["stage_bf16"] or counts["k1_route[wgmma]"]:
        raise AssertionError(f"narrow f32 model: launches {counts}")
    del ref, dev, got, want

    tcfg = TrainConfig(warmup_steps=0, grad_accum_steps=1, lora=LoRAConfig(r=4))
    ref = build_training(cfg, tcfg, device="cpu", dtype=f32,
                         init=lambda m: seeded_init(
                             m, torch.Generator().manual_seed(5)))
    dev = build_training(cfg, tcfg, ref.model.state_dict(), device="cuda",
                         dtype=f32)
    batch = make_train_batch(cfg, seed, device="cpu", dtype=f32, rows=1,
                             videos=1, t_sam=1)
    out_ref = ref.model(**batch)
    out_ref.loss.backward()
    reset_counts()
    out = dev.model(**{k: v.cuda() for k, v in batch.items()})
    out.loss.backward()
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.llm.num_layers
    if counts["flash_bwd_f32"] != L or counts["attention_fwd[causal]"] != 2 * L \
            or counts["stage_bf16"]:
        raise AssertionError(f"narrow f32 model (training): launches {counts}")
    a, w = float(out.loss.detach()), float(out_ref.loss.detach())
    rel = abs(a - w) / abs(w)
    log(f"  narrow f32 model (training): loss card {a:.7f} vs CPU {w:.7f} rel "
        f"{rel:.3e} (tol {TOL_F32_MODEL:g})")
    if not rel <= TOL_F32_MODEL:
        raise AssertionError("narrow f32 model (training): the loss disagrees")
    hold_grads("narrow f32 model (training), trainable gradients",
               {n: p.grad for n, p in dev.model.named_parameters()},
               {n: p.grad for n, p in ref.model.named_parameters()},
               ref.tx.trainable, TOL_F32_MODEL, TOL_F32_MODEL)


# ---------------------------------------------------------------------------
# f32 through every serving kernel: the f32 routes of K4, K5, K7 and K8, the
# f32 flagship with int8 / int4 weights and the int8 cache, a narrow f32
# model with quantised weights against its CPU twin, verify_parity in f32
# ---------------------------------------------------------------------------
TOL_F32_SERVE = 2e-6    # relative L2 of K4's, K5's, K7's and K8's f32 routes
                        # against their f32 twins (TF32 off): the same f32
                        # products summed in another order (the f32 routes
                        # of K1, K2 and K6 reach 1.7e-6); a bf16 rounding
                        # gives 1e-3. Their max-norm ratio is held at
                        # TOL_F32_ROUTE: the worst of 2 million K5 outputs at
                        # M = 64 read 2.5e-6 on an NVIDIA H100 80GB HBM3,
                        # 700.00 W
TOL_F32_HOIST = 1e-4    # relative L2, the unhoisted f32 Hiera-L (K8 f32,
                        # super-windows, plain norms and linears) against the
                        # hoisted one (fused blocks) over 48 blocks
TOL_F32_QUANT_LOOSE = 2e-2  # a narrow f32 model with the int8 cache, card vs
                        # CPU, once a code of the two caches differs: a
                        # last-bit difference before round() moves a code by
                        # one, its row by amax/127 (tests/test_torch_slice_quant.py)
N_F32Q_REQUESTS = 1     # framewise f32 requests with int8 weights and cache
K5_F32_ROWS = (1, 2, 3, 4, 8, 64)
PHI3_PRODUCTS = (("qkv_proj", 3072, 9216), ("o_proj", 3072, 3072),
                 ("gate_up_proj", 3072, 16384), ("down_proj", 8192, 3072),
                 ("lm_head", 3072, 32065))


def phase_f32q_kernels(K: Kernels, cfg):
    """The f32 routes of K4, K5, K7 and K8 against their f32 twins with TF32
    off at the f32 model's path shapes, relative L2 within TOL_F32_SERVE
    (max-norm ratio within TOL_F32_ROUTE),
    each timed beside its bound and its twin (K7 and K8 also beside SDPA in
    f32, K5 int8 beside `torch._weight_int8pack_mm`; K4 has no one-call
    library counterpart): K4 at Phi-3 over a stacked 32-layer cache (698 MB,
    past L2) and at Llama-3.1-8B's GQA, equal bits on a repeat; K5 int8 and
    int4 at the five Phi-3 decode products for 1, 2, 3, 4, 8 and 64 rows
    (timed over weight copies past L2), past one row the route that the
    plan does not take forced beside the one it takes (the crossover); K7 at the memory self-attention
    [4,1,1024,256]; K8 at the unhoisted Hiera-L's three small-window shapes
    over 8 frames."""
    import torch
    import torch.nn.functional as F
    from videoglamm_torch.ops import attention as A
    from videoglamm_torch.ops import quant as Q

    g = torch.Generator(device="cuda").manual_seed(18)
    randn = lambda *s: torch.randn(*s, generator=g, device="cuda")

    # K4: as the bf16 case of phase_kernels, f32 q and out
    def decode_case(L, Hq, Hkv, hd, C, kv_len, layer, key, label):
        HD = Hkv * hd
        kc, vc = (torch.randint(-127, 128, (L, 1, C, HD), dtype=torch.int8,
                                generator=g, device="cuda") for _ in range(2))
        ks, vs = (torch.rand(L, 1, Hkv, C, generator=g, device="cuda") * 0.02
                  + 0.005 for _ in range(2))
        dq = randn(1, Hq, 1, hd)
        kvl = torch.tensor([kv_len], device="cuda", dtype=torch.int32)
        rot = itertools.count()

        def launch(layer_):
            return A.dot_product_attention(dq, kc, vc, causal=True, kv_lens=kvl,
                                           q_start=kvl - 1, k_scale=ks,
                                           v_scale=vs, layer=layer_)

        a, b = launch(layer), launch(layer)
        torch.cuda.synchronize()
        if a.dtype != torch.float32 or not torch.equal(a, b):
            raise AssertionError(f"{label}: not f32, or repeats differ")
        nb = 2 * kv_len * HD + 2 * Hkv * kv_len * 4 + 2 * Hq * hd * 4
        K.compare(key, label + " (two calls bit-equal)", lambda: launch(layer),
                  lambda: A._decode_attention_q8_plain(
                      dq, kc, vc, ks, vs, sm_scale=hd ** -0.5, kv_lens=kvl,
                      layer=layer), TOL_F32_ROUTE, tol_l2=TOL_F32_SERVE,
                  nbytes=nb, ops=4 * Hq * kv_len * hd, rate="f32", graphed=True,
                  timed_fn=lambda: launch(next(rot) % L))
        del kc, vc, ks, vs

    decode_case(32, 32, 32, 96, 3456, 3400, 17, "decode_attention_q8_f32",
                "K4 f32 decode Phi-3 [1,32,1,96] over [32,1,3456,3072] int8, "
                "layer 17, kv_len 3400")
    decode_case(32, 32, 8, 128, 3456, 3400, 2, "decode_attention_q8_f32@gqa",
                "K4 f32 decode GQA G=4 [1,32,1,128] over [32,1,3456,1024] int8, "
                "layer 2, kv_len 3400")
    torch.cuda.empty_cache()

    # K5: f32 x, one row on the CUDA cores, from `k5_f32_tc_min_m` rows on the
    # tensor cores (x split into three bf16 planes, one pass over the
    # weights a 64 rows); at every row count past one the other route is
    # timed beside it, forced through its plan: the crossover, and the
    # earlier design's times (the CUDA-core route: every M in tiles of 4 rows)
    sums = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for what, Kd, Nd in PHI3_PRODUCTS:
        wf = randn(Nd, Kd) * Kd ** -0.5
        q8, s8 = Q.quantize_int8(wf)
        q8 = Q.pad_rows8(q8)
        p4, s4 = Q.quantize_int4(wf, 128)
        del wf
        ring = max(2, min(16, math.ceil(150e6 / (Nd * Kd))))
        ring8 = [q8] + [q8.clone() for _ in range(ring - 1)]
        ring4 = [(p4, s4)] + [(p4.clone(), s4.clone())
                              for _ in range(2 * ring - 1)]
        r8, r4 = itertools.count(), itertools.count()
        q8n, s8f = q8[:Nd], s8.float()
        for M in K5_F32_ROWS:
            x = randn(M, Kd)
            io = 4 * M * (Kd + Nd)
            main = what == "gate_up_proj"
            # library: torch's weight-only int8 product takes f32 x and f32
            # scales on the card; its int4 one refuses f32 x ("Expected
            # A.dtype() == at::kBFloat16"), so int4 f32 has none
            for kind, nb, kern, plain, timed, lib, group in (
                    ("int8", Nd * Kd + 4 * Nd + io,
                     lambda: Q.dequant_matmul(x, q8, s8),
                     lambda: Q._dequant_matmul_plain(x, q8, s8),
                     lambda: Q.dequant_matmul(x, ring8[next(r8) % len(ring8)], s8),
                     lambda: torch._weight_int8pack_mm(x, q8n, s8f), 0),
                    ("int4", Nd * Kd // 2 + 4 * Nd * Kd // 128 + io,
                     lambda: Q.dequant4_matmul(x, p4, s4, 128),
                     lambda: Q._dequant4_matmul_plain(x, p4, s4, 128),
                     lambda: Q.dequant4_matmul(x, *ring4[next(r4) % len(ring4)], 128),
                     None, 128)):
                plan = Q.k5_plan(M, Nd, Kd, group, sms, f32=True)
                route = "tensor cores" if plan.tc else "CUDA cores"
                key = (f"dequant_gemv_f32[{kind}]" + ("" if M == 1 else f"@M={M}")
                       if main else None)
                # the bound: bytes, or 3 bf16 products of exact operands
                # (x's planes times the codes) at the bf16 tensor rate
                ms = K.compare(key, f"K5 f32 {kind} {what} M={M} [{Nd},{Kd}] "
                               f"({route}, {plan.m_tiles} pass"
                               f"{'es' if plan.m_tiles > 1 else ''} over the "
                               "weights)", kern, plain, TOL_F32_ROUTE,
                               tol_l2=TOL_F32_SERVE, nbytes=nb,
                               ops=3 * 2 * M * Nd * Kd, rate="bf16", graphed=True,
                               timed_fn=timed, library_fn=lib)
                t = sums.setdefault((kind, M), [0.0, 0.0, 0.0, 0.0])
                t[0] += ms
                t[1] += max(nb / HBM_BYTES_S, 3 * 2 * M * Nd * Kd / PEAK_OPS["bf16"]) * 1e3
                if M > 1:
                    # the other route, forced through its plan
                    other = Q.k5_plan(M, Nd, Kd, group, sms, f32=True, tc=not plan.tc)
                    if kind == "int8":
                        forced = lambda: Q._launch_gemv(
                            kind, x, ring8[next(r8) % len(ring8)], s8, Nd, 0, other)
                    else:
                        forced = lambda: Q._launch_gemv(
                            kind, x, *ring4[next(r4) % len(ring4)], Nd, 128, other)
                    oroute = "tensor cores" if other.tc else "CUDA cores"
                    err = rel_l2(forced(), plain())
                    if not err <= TOL_F32_SERVE:
                        raise AssertionError(f"K5 f32 {kind} {what} M={M} on the "
                                             f"{oroute}: relative L2 {err:.3e}")
                    other_ms = time_ms(forced, graphed=True)
                    t[2] += other_ms if plan.tc else ms      # the CUDA cores
                    t[3] += ms if plan.tc else other_ms      # the tensor cores
                    log(f"    the {oroute} forced at M={M} ({other.m_tiles} pass"
                        f"{'es' if other.m_tiles > 1 else ''}): {other_ms:.4f} ms, "
                        f"{other_ms / ms:.2f}x the {route}' time")
            del x
        del ring8, ring4, q8, q8n, s8f, p4, s4
        torch.cuda.empty_cache()
    for (kind, M), (ms, bound, cuda_ms, tc_ms) in sorted(sums.items()):
        log(f"  K5 f32 {kind} M={M}, sum of the five Phi-3 products: {ms:.4f} ms "
            f"back to back, bound {bound:.4f} ms ({bound / ms:.1%} of it)"
            + (f"; every product on the CUDA cores {cuda_ms:.4f} ms, on the "
               f"tensor cores {tc_ms:.4f} ms" if M > 1 else ""))

    # K7: the memory self-attention at the 32x32 grid
    q, k, v = (randn(4, 1, 1024, 256) for _ in range(3))
    nb, ops = attn_cost(4, 1, 1024, 1024, 256, elt=4)
    K.compare("window_attention_f32", "K7 f32 memory self-attention "
              "[4,1,1024,256] (an f32 model: nothing staged)",
              lambda: A.dot_product_attention(q, k, v, exact=True),
              lambda: A._window_attention_plain(q, k, v, 256 ** -0.5),
              TOL_F32_ROUTE, tol_l2=TOL_F32_SERVE, nbytes=nb, ops=ops,
              rate="f32", graphed=True,
              library_fn=lambda: F.scaled_dot_product_attention(q, k, v))
    del q, k, v

    # K8: Hiera-L's small windows over 8 frames without hoisting (stage 1:
    # 8x8 windows of a 256x256 grid, stage 2: 4x4 of 128x128, stage 4: 8x8
    # of 32x32)
    for stage, NW, Sw, H in ((1, 8192, 64, 2), (2, 8192, 16, 4), (4, 128, 64, 16)):
        hd = 72
        qkv = randn(NW, Sw, 3 * H * hd)
        wins = [qkv.view(NW, Sw, 3, H, hd)[:, :, i].transpose(1, 2)
                for i in range(3)]
        nb, ops = attn_cost(NW, H, Sw, Sw, hd, elt=4)
        K.compare("smallwin_attention_f32" + ("" if stage == 1 else f"@stage{stage}"),
                  f"K8 f32 Hiera-L stage {stage} windows [{NW},{Sw},{3 * H * hd}] "
                  f"H={H}", lambda: A.attention_packed_qkv_smallwin(
                      qkv, H, hd, exact=True),
                  lambda: A._smallwin_plain(qkv, H, hd ** -0.5), TOL_F32_ROUTE,
                  tol_l2=TOL_F32_SERVE, nbytes=nb, ops=ops, rate="f32",
                  library_fn=lambda: F.scaled_dot_product_attention(*wins))
        del qkv, wins
        torch.cuda.empty_cache()


def phase_f32q_serve(cfg):
    """The flagship in f32 with quantised weights through
    `build_inference(dtype=torch.float32, quant=..., kv_cache="int8")`:
    N_F32Q_REQUESTS framewise requests with int8 weights (the main path's
    mode in f32), the unhoisted Hiera-L against the hoisted one in f32 on
    that model's trunk, one request with int4 weights, and one video-branch
    request at SAM image size 512 with int8 weights. Launches by the bf16
    formulas on the f32 routes: K4, K5 and K7 never on their bf16 counters,
    nothing staged. Returns the launch counts of the int8, int4, tracking
    and unhoisted runs."""
    import torch
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.ops import quant as Q

    def f32_model(c, quant, what):
        t0 = time.perf_counter()
        gi = build_inference(
            c, device="cuda", dtype=torch.float32, quant=quant,
            kv_cache="int8", max_new_tokens=MAX_NEW,
            init=lambda m: seeded_init(
                m, torch.Generator(device="cuda").manual_seed(0)))
        torch.cuda.synchronize()
        log(f"  flagship VideoGLaMM in f32, {what}: built in "
            f"{time.perf_counter() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated, "
            f"exact_f32={gi.model.exact_f32}")
        if not (gi.model.exact_f32 and gi.model.quant_kv_int8
                and gi.model.llm.quant == quant):
            raise AssertionError(f"f32 {what}: build_inference built {gi.model}")
        return gi

    raw = [make_raw_request(cfg, 400 + i) for i in range(N_F32Q_REQUESTS)]
    gi = f32_model(cfg, "int8", "int8 weights, int8 cache")
    results, counts8 = phase_serve(gi, cfg, "f32_int8", raw, raw=True)
    check_outputs(cfg, results, "f32 int8")
    del results
    hoist_counts = phase_unhoisted_hiera(
        gi.model.visual_model.image_encoder.trunk, dtype=torch.float32,
        tol=TOL_F32_HOIST)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B = len(BATCH_TEXT_LENS)
    routes = {what: Q.k5_plan(B, N, K, 0, sms, f32=True).tc
              for what, K, N in PHI3_PRODUCTS}
    log(f"  batch 4 on the f32 int8 model: four clips, prompts of "
        f"{'/'.join(map(str, BATCH_TEXT_LENS))} tokens; K5 at {B} rows on the "
        "f32 tensor-core route: " + ", ".join(f"{w} {t}" for w, t in routes.items()))
    if routes != {w: B >= Q.k5_f32_tc_min_m(N, sms) for w, _, N in PHI3_PRODUCTS} \
            or not routes["gate_up_proj"]:
        raise AssertionError(f"f32 batch 4: K5's routes {routes}")
    phase_batch(gi, cfg, "f32_int8", 600, TOL_BATCH_F32,
                "f32 batch 4, int8 + int8 KV", max_flips=TOL_BATCH_F32_FLIPS)
    del gi
    torch.cuda.empty_cache()

    gi = f32_model(cfg, "int4", "int4 weights, int8 cache")
    results, counts4 = phase_serve(gi, cfg, "f32_int4", raw[:1], raw=True)
    check_outputs(cfg, results, "f32 int4")
    del gi, results
    torch.cuda.empty_cache()

    cfg512 = dataclasses.replace(
        cfg, sam2=dataclasses.replace(cfg.sam2, image_size=512))
    gi = f32_model(cfg512, "int8", "int8 weights, int8 cache, SAM image size 512")
    results, track_counts = phase_serve(gi, cfg512, "f32_track512", raw[:1],
                                        raw=True, track=True)
    check_outputs(cfg512, results, "f32 video branch at 512",
                  t_sam=cfg.num_frames)
    del gi, results
    torch.cuda.empty_cache()
    return counts8, counts4, track_counts, hoist_counts


def phase_f32q_small(seed: int):
    """A narrow f32 model (`small_config`) with int8 weights and the int8
    cache on the card against the same codes in f32 on the CPU, teacher-
    forced through the model's own prefill and cached decode steps (K5
    f32 on every product, W8A8 left out by raising its gate on both sides,
    and K4 f32 at every step): the decode logits, the [SEG] hidden states
    and the mask logits of the forced [SEG] prompts. The two int8 caches
    are compared code by code: with none differing the outputs are held at
    TOL_F32_MODEL, else at TOL_F32_QUANT_LOOSE with under 1e-3 of the codes
    differing, by one."""
    import torch
    from videoglamm_torch.inference.generate import decode_step, prefill
    from videoglamm_torch.inference.pipeline import build_inference
    from videoglamm_torch.models.common import QDense
    from videoglamm_torch.models.videoglamm import SegExtraction

    cfg = small_config()
    f32 = torch.float32
    ref = build_inference(cfg, device="cpu", dtype=f32, quant="int8",
                          kv_cache="int8", init=lambda m: seeded_init(
                              m, torch.Generator().manual_seed(7))).model
    dev = build_inference(cfg, ref.state_dict(), device="cuda", dtype=f32,
                          quant="int8", kv_cache="int8").model
    g = torch.Generator().manual_seed(seed + 13)
    T = cfg.num_frames
    frames = torch.randn(1, T, 224, 224, 3, generator=g)
    context = torch.randn(1, T, 336, 336, 3, generator=g)
    sam = torch.randn(1, 1, 1024, 1024, 3, generator=g)
    ids = torch.randint(1, 32000, (1, S_TEXT), generator=g)
    ids[:, 2] = -200
    lens = torch.tensor([S_TEXT])
    forced = torch.randint(1, 32000, (1, 8), generator=g)
    forced[0, 2] = forced[0, 5] = cfg.seg_token_idx

    def run(model, device):
        on = lambda t: t.to(device)
        n = forced.shape[1]
        visual = model.encode_visual_prefix(on(frames), on(context))
        h_pre, cache, sp, last = prefill(model.llm, visual, on(ids), on(lens), n,
                                         quant_kv=True)
        logits, hidden = [last], []
        for i in range(n):
            lg, h = decode_step(model.llm, cache, on(forced[:, i]),
                                sp.attn_lens + i)
            logits.append(lg)
            hidden.append(h)
        hidden = torch.stack(hidden, dim=1)
        # the two forced [SEG] first, the other slots empty (pipeline order)
        ms = cfg.max_seg_tokens
        idx = on(torch.tensor([[2, 5] + [0] * (ms - 2)]))
        valid = on(torch.arange(ms)[None] < 2)
        pick = hidden[:, idx[0]]
        seg = SegExtraction(torch.where(valid[..., None],
                                        model.text_hidden_fcs[0](pick), 0.0),
                            valid, idx)
        feats, _ = model.encode_sam_features(on(sam))
        masks = model.decode_masks(feats, seg, torch.arange(1, device=device))
        return dict(decode_logits=torch.stack(logits, 1),
                    seg_hidden=pick[:, :2], masks=masks[:, :2]), cache

    gate = QDense.w8a8_min_m
    QDense.w8a8_min_m = 1 << 30
    try:
        with torch.no_grad():
            want, cache_ref = run(ref, "cpu")
            reset_counts()
            got, cache_dev = run(dev, "cuda")
            torch.cuda.synchronize()
            counts = read_counts()
    finally:
        QDense.w8a8_min_m = gate
    flips = 0
    for key in ("k", "v"):
        d = (cache_dev[key].cpu().int() - cache_ref[key].int()).abs()
        if d.max() > 1 or (d > 0).float().mean() >= 1e-3:
            raise AssertionError(f"narrow f32 int8 model: cache {key} codes "
                                 f"differ by {int(d.max())} at {(d > 0).float().mean():.2e}")
        flips += int((d > 0).sum())
    tol = TOL_F32_QUANT_LOOSE if flips else TOL_F32_MODEL
    for k, w in want.items():
        rel = rel_l2(got[k].cpu(), w)
        log(f"  narrow f32 model, int8 weights and cache, {k} {tuple(w.shape)}: "
            f"card vs CPU rel L2 {rel:.3e} (tol {tol:g}; {flips} of the "
            f"caches' codes differ)")
        if not rel <= tol:
            raise AssertionError(f"narrow f32 int8 model {k}: the card disagrees")
    L = cfg.llm.num_layers
    n = forced.shape[1]
    if counts["decode_attention_q8_f32"] != n * L or counts["decode_attention_q8"] \
            or counts["dequant_gemv_f32[int8]"] != (n + 1) * (4 * L + 1) \
            or counts["dequant_gemv[int8]"] or counts["stage_bf16"] \
            or counts["k1_route[wgmma]"]:
        raise AssertionError(f"narrow f32 int8 model: launches {counts}")


def phase_f32q_parity(cfg, seed: int, smi: str, ckpt=None):
    """verify_parity on the card in f32: `--scale flagship --dtype f32
    --stages import,quant --int4 --tokens_advisory` on a reference-layout
    checkpoint of seeded weights (the cli phase's when it ran), each
    clip_run's launches by `parity_expected` on the f32 routes; then
    `--scale tiny --stages import,quant --int4 --tokens_advisory` (f32 by
    default) on a tiny checkpoint written here. Both must exit 0. Prints
    the f32 quant-parity record."""
    import os
    import tempfile
    import torch
    from videoglamm_torch.cli import verify_parity as vp
    from videoglamm_torch.config import VideoGLaMMConfig

    with tempfile.TemporaryDirectory() as d:
        tiny = write_reference_checkpoint(VideoGLaMMConfig.tiny(num_frames=4),
                                          os.path.join(d, "tiny"))
        if ckpt is None:
            ckpt = write_reference_checkpoint(cfg, os.path.join(d, "flagship"))
        runs = []
        real = vp.clip_run

        def counted(model, batch):
            torch.cuda.synchronize()
            reset_counts()
            out = real(model, batch)
            torch.cuda.synchronize()
            runs.append(read_counts())
            return out

        reports = {}
        for scale, paths, extra in (("flagship", ckpt, ["--dtype", "f32"]),
                                    ("tiny", tiny, [])):
            argv = ["--scale", scale, "--checkpoint", paths["dir"],
                    "--internvideo_ckpt", paths["iv"], "--clip_ckpt",
                    paths["clip"], "--stages", "import,quant", "--int4",
                    "--tokens_advisory", "--seed", str(seed), "--out_dir",
                    os.path.join(d, "report"), "--report_name",
                    f"parity_{scale}_f32.json", *extra]
            log(f"  verify_parity.main({argv})")
            t0 = time.perf_counter()
            vp.clip_run = counted
            try:
                rc = vp.main(argv)
            finally:
                vp.clip_run = real
            rep = json.load(open(os.path.join(d, "report", f"parity_{scale}_f32.json")))
            imp = rep["stages"]["import"]
            if rc != 0 or not rep["ok"] or rep["serving_dtype"] != "float32" \
                    or imp["unmatched"] or imp["random_init_modules"]:
                raise AssertionError(f"verify_parity {scale} f32: rc {rc}, report {rep}")
            reports[scale] = (rep, time.perf_counter() - t0)
    if len(runs) != 6:
        raise AssertionError(f"verify_parity ran clip_run {len(runs)} times")
    for name, counts in zip(("float", "int8", "int4"), runs[:3]):
        check_launches(counts, f32_formula(parity_expected(name)),
                       f"parity f32 {name} run")
    for name, counts in zip(("float", "int8", "int4"), runs[3:]):
        if counts["stage_bf16"] or counts["k1_route[wgmma]"] \
                or counts["decode_attention_q8"] or counts["dequant_gemv[int8]"] \
                or counts["dequant_gemv[int4]"]:
            raise AssertionError(f"parity tiny f32 {name} run left the f32 "
                                 f"routes: {counts}")
    for scale, (rep, wall) in reports.items():
        q, r = rep["stages"]["quant"], rep["runs"]
        log(f"  f32 quant parity ({scale}, {smi}): main() {wall:.1f} s, exit "
            f"code 0, ok {rep['ok']}, serving dtype {rep['serving_dtype']}")
        for name in ("float", "int8", "int4"):
            peak = r[name]["peak_bytes"] or 0
            log(f"    {name} run: clip_run {r[name]['run_s']:.3f} s, build "
                f"{r[name]['build_s']:.1f} s, peak device memory "
                f"{peak / 2**30:.2f} GiB, valid [SEG] {r[name]['seg_valid']}")
        for mode in ("int8", "int4"):
            log(f"    {mode}: token agreement {q[mode]['token_agreement']:.4f}, "
                f"mask IoU {q[mode]['mask_iou']:.4f}, valid [SEG] float "
                f"{q[mode]['float_seg_valid']} / {mode} {q[mode]['seg_valid']}, "
                f"ok {q[mode]['ok']}{' (advisory)' if mode == 'int4' else ''}")
    return runs[1]


def towers_config():
    """small_config()'s narrow LLM, CLIP and InternVideo2 (head dims 64 and
    88) with a shallow Hiera at Hiera-L's widths (144 to 1152, head dim 72):
    blocks 0-1 windowed (64 tokens, fused), 2 and 3 pooling, 4 global
    (4096 tokens at 1024: K1 flash and K6), 5 windowed (256 tokens, fused),
    6 pooling."""
    from videoglamm_torch.config import HieraConfig
    cfg = small_config()
    return dataclasses.replace(cfg, sam2=dataclasses.replace(
        cfg.sam2, hiera=HieraConfig(embed_dim=144, num_heads=2,
                                    stages=(2, 1, 3, 1),
                                    global_att_blocks=(4,))))


def trunk_grads(model, x, dy) -> dict:
    """Gradients of Hiera blocks 4 and 5 (`towers_config`) for the trunk
    alone on frame x, with `dy` injected at the stage-3 output."""
    import torch
    trunk = model.visual_model.image_encoder.trunk
    named = {n: p for n, p in trunk.named_parameters()
             if n.startswith(("blocks.4.", "blocks.5."))}
    for p in named.values():
        p.requires_grad_(True)
    out = trunk(x)[2]
    return dict(zip(named, torch.autograd.grad(out, list(named.values()), dy)))


def _tower_step(tr, batch, patterns):
    """One forward with freeze_towers=False and one backward with the
    leaves matching `patterns` (and the trainable set) asking for a
    gradient; returns the tower leaves' names and the model's gradients."""
    import re
    rx = re.compile("|".join(patterns))
    names = [n for n, p in tr.model.named_parameters() if rx.search(n)]
    for n, p in tr.model.named_parameters():
        p.requires_grad_(n in names or n in tr.tx.trainable)
        p.grad = None
    out = tr.model(**batch, freeze_towers=False)
    out.loss.backward()
    return names, {n: p.grad for n, p in tr.model.named_parameters()}, out


def phase_towers(cfg, seed: int):
    """freeze_towers=False. A narrow model (`towers_config`) whose
    projectors, an InternVideo2 block, a CLIP layer, a Hiera global block
    and a Hiera window block train: their gradients on the card in bf16
    and in f32 against the CPU f32 twin. Then one backward through the
    towers of the bf16 flagship, timed, with its peak memory. Returns the
    flagship backward's launch counts."""
    import re
    import torch
    from videoglamm_torch.config import LoRAConfig, TrainConfig
    from videoglamm_torch.training import build_training

    ncfg = towers_config()
    tcfg = TrainConfig(warmup_steps=0, grad_accum_steps=1, lora=LoRAConfig(r=4))
    ref = build_training(ncfg, tcfg, device="cpu", dtype=torch.float32,
                         init=lambda m: seeded_init(
                             m, torch.Generator().manual_seed(6)))
    batch = make_train_batch(ncfg, seed, device="cpu", dtype=torch.float32,
                             rows=1, videos=1, t_sam=1)
    t0 = time.perf_counter()
    names, want, _ = _tower_step(ref, batch, TOWER_LEAVES_NARROW)
    g = torch.Generator().manual_seed(seed + 7)
    S = ncfg.sam2.image_size
    trunk_x = torch.randn(1, S, S, 3, generator=g)
    trunk_dy = torch.randn(1, S // 16, S // 16, 4 * ncfg.sam2.hiera.embed_dim,
                           generator=g)
    want_t = trunk_grads(ref.model, trunk_x, trunk_dy)
    log(f"  narrow towers: {len(names)} tower leaves train; CPU f32 forward "
        f"and backward {time.perf_counter() - t0:.1f} s")
    L = ncfg.llm.num_layers
    for dtype, tol_leaf, tol_all in ((torch.bfloat16, TOL_TRAIN_GRAD,
                                      TOL_TRAIN_GRAD_ALL),
                                     (torch.float32, TOL_F32_MODEL, TOL_F32_MODEL)):
        dev = build_training(ncfg, tcfg, ref.model.state_dict(), device="cuda",
                             dtype=dtype)
        db = {k: (v.to(dtype) if v.is_floating_point() and k != "gt_masks"
                  else v).cuda() for k, v in batch.items()}
        reset_counts()
        _, got, _ = _tower_step(dev, db, TOWER_LEAVES_NARROW)
        torch.cuda.synchronize()
        counts = read_counts()
        f32 = dtype == torch.float32
        # the LLM's causal layers and the Hiera global block take K6, the
        # fused window blocks run forward on the kernels (their backward is
        # the recompute through the twin)
        if counts["flash_bwd"] != L + 1 or counts["fused_window_block"] != 3 \
                or counts["attention_fwd[bshd]"] == 0 \
                or bool(counts["flash_bwd_f32"]) != f32 \
                or bool(counts["attention_fwd_f32"]) != f32 or counts["stage_bf16"]:
            raise AssertionError(f"narrow towers ({dtype}): launches {counts}")
        for pat in TOWER_LEAVES_NARROW:
            pooled = f32 and "trunk" in pat
            hold_grads(f"narrow towers, card {'f32' if f32 else 'bf16'} vs CPU "
                       f"f32, gradients of {pat}", got, want,
                       [n for n in names if re.search(pat, n)],
                       TOL_F32_POOLED if pooled else tol_leaf,
                       TOL_F32_POOLED if pooled else tol_all)
        # the trunk alone: the same frame, one fixed gradient injected at
        # the stage-3 output, which no pooling follows: the global block
        # (K1 flash and K6 at head dim 72) and the fused window block (its
        # recompute) against the CPU twin
        reset_counts()
        got_t = trunk_grads(dev.model, trunk_x.cuda().to(dtype),
                            trunk_dy.cuda().to(dtype))
        torch.cuda.synchronize()
        counts = read_counts()
        if counts["flash_bwd"] != 1 or counts["fused_window_block"] != 3:
            raise AssertionError(f"trunk ({dtype}): launches {counts}")
        hold_grads(f"Hiera trunk alone, card {'f32' if f32 else 'bf16'} vs CPU "
                   "f32, blocks 4 and 5 from the stage-3 output", got_t,
                   want_t, list(want_t), tol_leaf, tol_all)
        del dev, got, got_t
        torch.cuda.empty_cache()
    del ref, want, want_t

    # the flagship, bf16: one backward through the towers
    tr = build_training(cfg, tcfg, device="cuda", dtype=torch.bfloat16,
                        init=lambda m: seeded_init(
                            m, torch.Generator(device="cuda").manual_seed(0)))
    fb = make_train_batch(cfg, seed, rows=1, videos=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    names, grads, out = _tower_step(tr, fb, TOWER_LEAVES_FLAGSHIP)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    missing = [n for n in names if grads[n] is None
               or not bool(torch.isfinite(grads[n]).all())]
    log(f"  flagship bf16, freeze_towers=False, {len(names)} tower leaves "
        f"training (InternVideo2 block 0, CLIP layer 0, Hiera blocks 0 and 23, "
        f"both projectors), 1 video x 1 row: forward and backward {wall:.2f} s, "
        f"peak device memory {peak:.2f} GiB, loss {float(out.loss.detach()):.4f}; "
        f"launches {json.dumps({k: v for k, v in counts.items() if v})}")
    Lf = cfg.llm.num_layers
    if missing or counts["flash_bwd"] != Lf + 3 or counts["fused_window_block"] != 42:
        raise AssertionError(f"flagship towers backward: leaves without a finite "
                             f"gradient {missing[:4]}, launches {counts}")
    del tr, grads, out, fb
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the sharded train step over torch.distributed: one NCCL rank at flagship
# width, two gloo ranks on the one card at narrow width, serving over a mesh
# ---------------------------------------------------------------------------
PARALLEL_STEPS = 3          # optimizer steps of each flagship run
PARALLEL_SMALL_STEPS = 2    # steps of each narrow run over gloo
TOL_PAR_F32_LOSS = 1e-5     # relative, f32 losses: the same sums, split
TOL_PAR_F32_MOMENTS = 1e-4  # relative L2, f32 moments after 2 steps
PARALLEL_MESHES = ((2, 1), (1, 2))
PARALLEL_TIMEOUT = 300      # seconds for the two gloo processes together


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def parallel_tcfg(grad_accum: int):
    from videoglamm_torch.config import TrainConfig
    return TrainConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                       grad_accum_steps=grad_accum)


def phase_parallel(cfg, seed: int, smi: str) -> dict:
    """(a), (b) and (c) of phase 16; returns the launches of the sharded
    flagship run."""
    import torch
    import torch.distributed as dist
    from videoglamm_torch.parallel import initialize_distributed

    t0 = time.perf_counter()
    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"parallel: backend {dist.get_backend()}")
        counts = parallel_flagship_world1(cfg, seed, smi)
        torch.cuda.empty_cache()
        parallel_serve(cfg, smi)
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    parallel_gloo(seed, smi)
    log(f"  parallel phase: {time.perf_counter() - t0:.1f} s wall [{smi}]")
    return counts


def parallel_flagship_world1(cfg, seed: int, smi: str) -> dict:
    """(a): make_train_step and make_sharded_train_step on the mesh (1, 1)
    from the same start on the same flagship model, bit for bit."""
    import warnings
    import torch
    from videoglamm_torch.parallel import collectives, create_mesh
    from videoglamm_torch.training import (build_training, create_train_state,
                                           make_sharded_train_step)

    tr = build_training(cfg, parallel_tcfg(GRAD_ACCUM), device="cuda",
                        dtype=torch.bfloat16,
                        init=lambda m: seeded_init(
                            m, torch.Generator(device="cuda").manual_seed(0)))
    micro = [make_train_batch(cfg, seed + i) for i in range(GRAD_ACCUM)]
    batch = {k: torch.stack([m[k] for m in micro]) for k in micro[0]}
    params = dict(tr.model.named_parameters())
    trainable = list(tr.tx.trainable)
    start = {n: params[n].detach().clone() for n in trainable}
    versions = {n: p._version for n, p in params.items() if n not in start}
    n_micro = PARALLEL_STEPS * GRAD_ACCUM

    def run(step, state, what):
        reset_counts()
        collectives.reset_count()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics, walls = [], []
        for _ in range(PARALLEL_STEPS):
            t = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            metrics.append({k: float(v) for k, v in m.items()})
        counts = read_counts()
        for name, n in counts.items():
            per = EXPECTED_PER_MICRO_STEP.get(name)
            if (per is None and n == 0) or (per is not None and n != per * n_micro):
                raise AssertionError(f"parallel, {what}: {name} launched {n} "
                                     f"times in {n_micro} micro-steps")
        coll = dict(collectives.COUNT)
        log(f"  {what}: step walls " + ", ".join(f"{w:.3f}" for w in walls)
            + f" s, losses " + ", ".join(f"{m['loss']:.6f}" for m in metrics)
            + f", peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
            f"collectives issued {json.dumps(coll)} [{smi}]")
        return state, metrics, walls, counts, coll

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain, m_plain, w_plain, c_plain, _ = run(
                tr.train_step, tr.state, "make_train_step, flagship bf16, "
                f"{PARALLEL_STEPS} steps of {GRAD_ACCUM} micro-steps")
            end = {n: params[n].detach().clone() for n in trainable}
            with torch.no_grad():
                for n in trainable:
                    params[n].copy_(start[n])
            mesh = create_mesh()
            step, state, split = make_sharded_train_step(
                tr.model, tr.tx, mesh, create_train_state(tr.model, tr.tx),
                grad_accum=GRAD_ACCUM)
            if split(batch) is not batch or state.sharding.model:
                raise AssertionError("parallel: the mesh (1, 1) split something")
            sharded, m_sh, w_sh, c_sh, coll = run(
                step, state, f"make_sharded_train_step on {mesh!r} over NCCL")
        finally:
            torch.use_deterministic_algorithms(False)
    notes = sorted({str(w.message).splitlines()[0][:120] for w in caught
                    if "determinis" in str(w.message)})
    if notes:
        log("  deterministic-algorithm warnings: " + " | ".join(notes))
    differ = [n for n in trainable if not torch.equal(params[n], end[n])]
    moments = [n for n in trainable for k in ("mu", "nu")
               if not torch.equal(plain.opt_state[k][n], sharded.opt_state[k][n])]
    touched = [n for n, v in versions.items() if params[n]._version != v]
    if m_plain != m_sh or differ or moments or touched or c_plain != c_sh \
            or any(coll.values()):
        raise AssertionError(
            f"parallel (a): the mesh (1, 1) step is not make_train_step's: "
            f"metrics equal {m_plain == m_sh}, parameters differing "
            f"{differ[:4]}, moments differing {moments[:4]}, frozen leaves "
            f"written {touched[:4]}, launches equal {c_plain == c_sh}, "
            f"collectives {coll}")
    log(f"  parallel (a): {PARALLEL_STEPS} steps on the mesh (1, 1) over NCCL "
        f"equal make_train_step's bit for bit ({len(trainable)} trainable "
        f"leaves and their moments, 5 metrics a step; {len(versions)} frozen "
        f"leaves never written; the same launches); median step "
        f"{statistics.median(w_sh):.3f} s sharded vs "
        f"{statistics.median(w_plain):.3f} s plain [{smi}]")
    del tr, plain, sharded, state, start, end, batch, micro, params
    return c_sh


def parallel_serve(cfg, smi: str):
    """(c): one bf16 flagship request before and after `shard_params` on
    the mesh (1, 1)."""
    import torch
    from videoglamm_torch.parallel import create_mesh, shard_params

    gi = build(cfg, "none", "bf16", "bf16 LLM (serving over a mesh)")
    frames, context, frames_sam, ids, lens = make_request(cfg, 100)
    outs, counts = [], []
    for sharded in (False, True):
        if sharded:
            shard_params(gi.model, create_mesh())
        reset_counts()
        t = time.perf_counter()
        outs.append(gi(frames, context, frames_sam, ids, lens))
        torch.cuda.synchronize()
        counts.append(read_counts())
        log(f"  serve {'after' if sharded else 'before'} shard_params: "
            f"{time.perf_counter() - t:.2f} s [{smi}]")
    a, b = outs
    if not (torch.equal(a.tokens, b.tokens) and torch.equal(a.lengths, b.lengths)
            and torch.equal(a.pred_masks, b.pred_masks)
            and counts[0] == counts[1]):
        raise AssertionError("parallel (c): serving through shard_params on "
                             "the mesh (1, 1) changed the request's result")
    log(f"  parallel (c): tokens and lengths equal, masks bit-equal "
        f"{tuple(b.pred_masks.shape)}, the same launches")
    del gi


def _small_train_run(cfg, dtype, seed: int, mesh, ckpt_dir: str):
    """PARALLEL_SMALL_STEPS sharded steps (the one-process step where mesh
    is None) of the narrow model; the state is checkpointed whole into
    ckpt_dir. Returns (metrics, step walls, collectives a step, split)."""
    import torch
    from videoglamm_torch.io.checkpoint import CheckpointManager
    from videoglamm_torch.parallel import collectives
    from videoglamm_torch.training import build_training, make_sharded_train_step

    tr = build_training(cfg, parallel_tcfg(1), device="cuda", dtype=dtype,
                        init=lambda m: seeded_init(
                            m, torch.Generator(device="cuda").manual_seed(0)))
    batch = make_train_batch(cfg, seed, dtype=dtype, rows=2, videos=2)
    step, state, local = tr.train_step, tr.state, batch
    if mesh is not None:
        step, state, split = make_sharded_train_step(tr.model, tr.tx, mesh,
                                                     tr.state)
        local = split(batch)
    collectives.reset_count()
    metrics, walls = [], []
    for _ in range(PARALLEL_SMALL_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, local)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        metrics.append({k: float(v) for k, v in m.items()})
    coll = {k: v / PARALLEL_SMALL_STEPS for k, v in collectives.COUNT.items()}
    CheckpointManager(ckpt_dir).save(PARALLEL_SMALL_STEPS, state)
    return metrics, walls, coll, "ce_norm" in local


def parallel_worker(argv) -> int:
    """One of the two gloo ranks of (b): `chip_smoke.py --parallel-worker
    RANK ADDR DIR SEED`. Probes gloo on CUDA tensors first and writes what
    it found; then runs both meshes in f32 and bf16."""
    import torch
    import torch.distributed as dist
    from videoglamm_torch.parallel import create_mesh, initialize_distributed

    rank, addr, d, seed = int(argv[0]), argv[1], argv[2], int(argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False     # as main() sets them
    torch.backends.cudnn.allow_tf32 = False
    initialize_distributed(addr, 2, rank, backend="gloo", device="cuda")
    try:
        x = torch.arange(4.0, device="cuda") + rank
        dist.all_reduce(x)
        out = torch.empty(8, device="cuda", dtype=torch.bfloat16)
        dist.all_gather_into_tensor(out, x.bfloat16())
        probe = "ok" if float(x.sum()) == 16.0 else f"wrong sum {x.tolist()}"
    except Exception as e:   # gloo's refusal is the finding; recorded, not hidden
        probe = f"{type(e).__name__}: {e}"
    with open(f"{d}/probe{rank}.json", "w") as f:
        json.dump(probe, f)
    if probe != "ok":
        return 3
    cfg = small_config()
    res = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in PARALLEL_MESHES:
            mesh = create_mesh(*shape)
            tag = f"{str(dtype)[6:]}_{shape[0]}x{shape[1]}"
            res[tag] = _small_train_run(cfg, dtype, seed, mesh,
                                        f"{d}/ckpt_{tag}")
            torch.cuda.empty_cache()
    if rank == 0:
        with open(f"{d}/results.json", "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _moments(ckpt_dir: str):
    import torch
    from videoglamm_torch.io.checkpoint import CheckpointManager
    path = os.path.join(ckpt_dir, str(PARALLEL_SMALL_STEPS), "state.pt")
    if not os.path.exists(path):
        raise AssertionError(f"parallel (b): no checkpoint at {path}")
    st = torch.load(path, map_location="cpu", weights_only=True)
    return torch.cat([st["opt_state"][k][n].float().reshape(-1)
                      for k in ("mu", "nu") for n in sorted(st["opt_state"][k])])


def parallel_gloo(seed: int, smi: str):
    """(b): the narrow model's one-process step on the card, then two
    processes over gloo at (2, 1) and (1, 2), f32 and bf16."""
    import tempfile
    import torch

    cfg = small_config()
    with tempfile.TemporaryDirectory() as d:
        ref = {}
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype)[6:]
            ref[tag] = _small_train_run(cfg, dtype, seed, None, f"{d}/ref_{tag}")
            log(f"  narrow model, one process, {tag}: step walls "
                + ", ".join(f"{w * 1e3:.1f}" for w in ref[tag][1])
                + " ms, losses " + ", ".join(f"{m['loss']:.6f}" for m in ref[tag][0]))
        torch.cuda.empty_cache()
        addr = f"127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             str(r), addr, d, str(seed)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=PARALLEL_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t0
        probes = [json.load(open(f"{d}/probe{r}.json"))
                  if os.path.exists(f"{d}/probe{r}.json") else None
                  for r in range(2)]
        if probes != ["ok", "ok"] and all(p is not None for p in probes):
            log(f"  parallel (b): NOT POSSIBLE: gloo refused CUDA tensors: "
                f"{probes}")
            return
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"parallel (b): rank {r} exit "
                                     f"{p.returncode}:\n{out[-4000:]}")
        res = json.load(open(f"{d}/results.json"))
        log(f"  parallel (b): two gloo processes on the one card, gloo takes "
            f"CUDA tensors (all_reduce, all_gather_into_tensor probed); "
            f"{wall:.1f} s for both ranks' start, build and runs [{smi}]")
        for tag, (metrics, walls, coll, split) in sorted(res.items()):
            dt = tag.split("_")[0]
            want = ref[dt][0]
            tol_loss = TOL_PAR_F32_LOSS if dt == "float32" else TOL_TRAIN_LOSS
            tol_m = TOL_PAR_F32_MOMENTS if dt == "float32" else TOL_TRAIN_GRAD_ALL
            worst = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                        for g, w in zip(metrics, want) for k in w)
            m_err = rel_l2(_moments(f"{d}/ckpt_{tag}"), _moments(f"{d}/ref_{dt}"))
            log(f"  {tag}: split by videos {split}, step walls "
                + ", ".join(f"{w * 1e3:.1f}" for w in walls)
                + " ms (one process "
                + ", ".join(f"{w * 1e3:.1f}" for w in ref[dt][1]) + "; the "
                "first step of each run builds and JITs), "
                f"collectives a step {json.dumps(coll)}; losses against one "
                f"process: worst relative {worst:.3e} (tol {tol_loss:g}); "
                f"AdamW moments gathered through the checkpoint: relative L2 "
                f"{m_err:.3e} (tol {tol_m:g}) [{smi}]")
            if not (worst <= tol_loss and m_err <= tol_m
                    and split == tag.endswith("2x1")):
                raise AssertionError(f"parallel (b) {tag}: disagrees with the "
                                     "one-process step")


PHASES = ("kernels", "experiments", "serve", "predictors", "sam1", "train",
          "cli", "parity", "f32", "f32q", "towers", "parallel")
SOURCES = {
    "attention_fwd": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
    "gemm_epilogue": ("cuda", "videoglamm_torch/csrc/gemm_epilogue.cu"),
    "row_norm": ("triton", "videoglamm_torch/ops/norms.py"),
    "fused_window_block": ("cuda", "videoglamm_torch/ops/fused_block.py"),
    "decode_attention_q8": ("cuda", "videoglamm_torch/csrc/decode_attention_q8.cu"),
    "dequant_gemv": ("cuda", "videoglamm_torch/csrc/dequant_gemv.cu"),
    "flash_bwd": ("cuda", "videoglamm_torch/csrc/flash_bwd.cu"),
    "window_attention": ("cuda", "videoglamm_torch/csrc/window_attention.cu"),
    "smallwin_attention": ("cuda", "videoglamm_torch/csrc/smallwin_attention.cu"),
    "decode_fused": ("cuda", "videoglamm_torch/csrc/decode_fused.cu"),
    # K1 through BSHD strides: no device code of its own
    "flash_bshd": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
    # the staging pass of the f32 routes, in K1's source
    "stage_bf16": ("cuda", "videoglamm_torch/csrc/attention_fwd.cu"),
    # the full-precision f32 routes of an f32 model
    "attention_fwd_f32": ("cuda", "videoglamm_torch/csrc/attention_f32.cu"),
    "gemm_epilogue_f32": ("cuda", "videoglamm_torch/csrc/gemm_f32.cu"),
    "flash_bwd_f32": ("cuda", "videoglamm_torch/csrc/attention_f32.cu"),
    # K4's and K5's f32 routes in their own sources; K7's and K8's through
    # the full-precision body of K1's f32 route
    "decode_attention_q8_f32": ("cuda", "videoglamm_torch/csrc/decode_attention_q8.cu"),
    "dequant_gemv_f32": ("cuda", "videoglamm_torch/csrc/dequant_gemv.cu"),
    "window_attention_f32": ("cuda", "videoglamm_torch/csrc/attention_f32.cu"),
    "smallwin_attention_f32": ("cuda", "videoglamm_torch/csrc/attention_f32.cu"),
}
REPLACES = {
    "attention_fwd[causal]": "videoglamm_tpu/ops/attention.py:93",
    "attention_fwd[flash]": "videoglamm_tpu/ops/attention.py:93",
    "attention_fwd[bshd]": "videoglamm_tpu/ops/attention.py:738",
    "attention_fwd[window]": "videoglamm_tpu/ops/fused_block.py:108",
    "gemm_epilogue": "videoglamm_tpu/ops/fused_block.py:108",
    "row_norm[rms]": "videoglamm_tpu/ops/norms.py:45",
    "row_norm[ln]": "videoglamm_tpu/ops/norms.py:116",
    "fused_window_block": "videoglamm_tpu/ops/fused_block.py:108",
    "decode_attention_q8": "videoglamm_tpu/ops/attention.py:1061",
    "dequant_gemv[int8]": "videoglamm_tpu/ops/quant.py:36",
    "dequant_gemv[int4]": "videoglamm_tpu/ops/quant.py:132",
    "flash_bwd": "videoglamm_tpu/ops/attention.py:302",
    "attention_fwd[flash_d256]": "videoglamm_tpu/ops/attention.py:93",
    "window_attention": "videoglamm_tpu/ops/attention.py:523",
    "smallwin_attention": "videoglamm_tpu/ops/attention.py:605",
    "decode_fused[norm_matmul]": "scripts/decode_mlp_experiment.py:304",
    "decode_fused[matmul_residual]": "scripts/decode_mlp_experiment.py:366",
    "decode_fused[mlp]": "scripts/decode_mlp_experiment.py:123",
    "decode_fused[mlp_w8a8]": "scripts/decode_mlp_experiment.py:212",
    "flash_bshd": "scripts/bench_flash_bshd.py:61",
    # part of K1's f32 route: the TPU kernel reads f32 operands itself
    "stage_bf16": "videoglamm_tpu/ops/attention.py:93",
    # the TPU kernels read f32 operands themselves: K1's, K2's and K6's f32
    # routes take their place in an f32 model (K1's also that of
    # `_bshd_kernel`, attention.py:738)
    "attention_fwd_f32": "videoglamm_tpu/ops/attention.py:93",
    "gemm_epilogue_f32": "videoglamm_tpu/ops/fused_block.py:108",
    "flash_bwd_f32": "videoglamm_tpu/ops/attention.py:302",
    "decode_attention_q8_f32": "videoglamm_tpu/ops/attention.py:1061",
    "dequant_gemv_f32[int8]": "videoglamm_tpu/ops/quant.py:36",
    "dequant_gemv_f32[int4]": "videoglamm_tpu/ops/quant.py:132",
    "window_attention_f32": "videoglamm_tpu/ops/attention.py:523",
    "smallwin_attention_f32": "videoglamm_tpu/ops/attention.py:605",
}


def main() -> int:
    import argparse
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(sys.argv[2:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic training batch")
    ap.add_argument("--phases", default="all",
                    help="'all' (the default: every phase, as the contract "
                    "runs it) or a comma list of " + ", ".join(PHASES)
                    + "; the build always runs")
    args = ap.parse_args()
    chosen = set(PHASES) if args.phases == "all" else set(args.phases.split(","))
    if not chosen <= set(PHASES):
        ap.error(f"--phases: unknown {sorted(chosen - set(PHASES))}")
    try:
        import torch
    except ImportError as e:
        log(f"FAIL: torch is not importable ({e})")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 2
    try:
        import videoglamm_torch  # noqa: F401
    except ImportError as e:
        log(f"FAIL: run from the root of a videoglamm checkout ({e})")
        return 2
    from videoglamm_torch.config import VideoGLaMMConfig
    from videoglamm_torch.inference.pipeline import prepare_vision_inputs

    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] TF32 off for matmul and cuDNN")

    t_start = time.perf_counter()

    def phase(title: str):
        log(f"{title} (at {time.perf_counter() - t_start:.0f} s)")

    K = Kernels()
    cfg = VideoGLaMMConfig.flagship()
    # the cli phase's reference-layout checkpoint, read again by the parity
    # phase; removed when the script ends
    import os
    import tempfile
    shared = tempfile.TemporaryDirectory()
    ckpt = None
    try:
        phase("[build]")
        phase_build()
        if "kernels" in chosen:
            phase("[kernels] kernel vs plain twin at the main path's shapes")
            phase_kernels(K)
            torch.cuda.empty_cache()
            phase("[kernels] the fused decode-layer entries (K9) and K1 on BSHD views")
            phase_decode_fused(K)
            torch.cuda.empty_cache()
        if "experiments" in chosen:
            phase("[experiment] decode-layer A/B over 32 layers of stacked "
                  "weights, then the BSHD attention harness")
            experiment_counts = phase_experiments()
            torch.cuda.empty_cache()

        if "serve" in chosen:
            phase("[serve] bf16 weights, bf16 cache, preprocessed streams")
            gi = build(cfg, "none", "bf16", "bf16 LLM")
            requests = [make_request(cfg, 100 + i) for i in range(2)]
            results, _ = phase_serve(gi, cfg, "bf16", requests, raw=False)
            phase("[check] bf16")
            check_outputs(cfg, results, "bf16")
            frames, context, _, ids, lens = requests[0]
            check_teacher_forced(gi.model, frames, context, ids, lens, TOL_LLM_TF,
                                 "bf16 weights, bf16 cache")
            measure_decode(gi.model, frames, context, ids, lens, "bf16")
            phase("[check] reference-layout round trip of the bf16 model")
            check_reference_round_trip(gi, cfg, requests[0])
            del gi, results, requests, frames, context
            torch.cuda.empty_cache()

            phase("[serve] main path: int8 weights, int8 cache, raw uint8 "
                f"[1,{cfg.num_frames},{RAW_H},{RAW_W},3] frames")
            gi = build(cfg, "int8", "int8", "int8 LLM")
            raw_requests = [make_raw_request(cfg, 200 + i) for i in range(N_REQUESTS)]
            results, counts = phase_serve(gi, cfg, "int8", raw_requests, raw=True)
            phase("[check] int8")
            check_outputs(cfg, results, "int8")
            raw, ids, lens = raw_requests[0]
            with torch.no_grad():
                frames, context, _ = prepare_vision_inputs(
                    raw, cfg, num_sam_frames=T_SAM, dtype=torch.bfloat16)
            check_teacher_forced(gi.model, frames, context, ids, lens,
                                 TOL_LLM_TF_Q, "int8 weights, int8 cache")
            step_ms = measure_decode(gi.model, frames, context, ids, lens,
                                     "int8 + int8 KV")
            del results

            phase("[serve] batch 4 on the main path's model: four clips "
                  f"[4,{cfg.num_frames},{RAW_H},{RAW_W},3], prompts of "
                  f"{'/'.join(map(str, BATCH_TEXT_LENS))} tokens, each row held "
                  "to its clip alone")
            phase_batch(gi, cfg, "int8", 500, TOL_BATCH_BF16,
                        "batch 4, int8 + int8 KV")

            phase(f"[serve] speculative decoding on the main path's model, "
                f"draft_k={DRAFT_K}, raw frames")
            phase_speculative(gi, cfg, raw_requests, frames, context, ids, lens,
                              step_ms)
            phase("[serve] sampled decoding on the main path's model, temperature "
                "0.7, raw frames")
            phase_sampled(gi, cfg, raw_requests[0])

            phase("[serve] video branch on the main path's model: SAM-2 memory "
                f"tracker, all {cfg.num_frames} frames to SAM, "
                f"{cfg.max_seg_tokens} [SEG] objects")
            results, track_counts = phase_serve(
                gi, cfg, "track", raw_requests[:N_TRACK_REQUESTS], raw=True,
                track=True)
            phase("[check] video branch")
            check_outputs(cfg, results, "video branch", t_sam=cfg.num_frames)
            profile_track(gi, cfg, raw)
            del results
            torch.cuda.empty_cache()
            phase("[check] Hiera(hoist_layout=False) against the hoisted encoder")
            hoist_counts = phase_unhoisted_hiera(
                gi.model.visual_model.image_encoder.trunk)
            del gi
            torch.cuda.empty_cache()

            phase("[serve] int4 weights, int8 cache, raw frames")
            gi = build(cfg, "int4", "int8", "int4 LLM")
            results, counts4 = phase_serve(gi, cfg, "int4", raw_requests[:2], raw=True)
            phase("[check] int4")
            check_outputs(cfg, results, "int4")
            measure_decode(gi.model, frames, context, ids, lens, "int4 + int8 KV")
            counts["dequant_gemv[int4]"] = counts4["dequant_gemv[int4]"]
            del gi, results, frames, context, raw
            torch.cuda.empty_cache()

            phase("[serve] video branch at SAM image size 512 (32x32 memory grid), "
                "bf16 weights, raw frames")
            cfg512 = dataclasses.replace(
                cfg, sam2=dataclasses.replace(cfg.sam2, image_size=512))
            gi = build(cfg512, "none", "bf16", "bf16 LLM, SAM image size 512")
            results, track512_counts = phase_serve(
                gi, cfg512, "track512", raw_requests[:N_TRACK_REQUESTS], raw=True,
                track=True)
            phase("[check] video branch at 512")
            check_outputs(cfg512, results, "video branch at 512",
                          t_sam=cfg.num_frames)
            profile_track(gi, cfg512, raw_requests[0][0])
            del gi, results
            torch.cuda.empty_cache()

            phase("[serve] Llama-3.1-8B base at full width and depth, bf16 weights, "
                "int8 cache, raw frames")
            phase_llama(cfg, raw_requests)
            del raw_requests
            torch.cuda.empty_cache()

            phase("[check] narrow model on the card against the CPU twins")
            phase_small_reference()
            phase("[check] narrow tracker on the card against the CPU twins")
            for image_size in (1024, 512):
                phase_small_track_reference(image_size)

        if "predictors" in chosen:
            phase("[predictors] SAM-2 image predictor, automatic mask generator "
                  "and interactive video predictor, Hiera-L at 1024")
            pred_counts, encode_counts = phase_predictors(smi)
            torch.cuda.empty_cache()
            phase("[check] narrow SAM-2 predictors on the card against the CPU twins")
            phase_small_predictors_reference(smi)
            torch.cuda.empty_cache()

        if "sam1" in chosen:
            phase("[sam1] SAM-1 ViT-H with the ITM tracker at 1024: image predictor, "
                  "automatic mask generator, track_frames")
            sam1_counts = phase_sam1(smi)
            phase("[check] narrow SAM-1 on the card against the CPU twins")
            phase_small_sam1_reference(smi)
            torch.cuda.empty_cache()

        if "train" in chosen:
            phase(f"[train] flagship, {TRAIN_STEPS} optimizer steps of {GRAD_ACCUM} "
                "micro-steps, LoRA + lm_head + embed_tokens + text_hidden_fcs + "
                "mask decoder")
            train_counts, train_walls = phase_train(cfg, args.seed)
            torch.cuda.empty_cache()
            phase("[check] narrow model, one training micro-step on the card "
                "against the CPU twins")
            phase_small_train_reference(args.seed)
            torch.cuda.empty_cache()
            phase(f"[train] the train CLI from dataset files: {CLI_STEPS} "
                  f"optimizer steps of {GRAD_ACCUM} micro-steps, the epoch "
                  "checkpoint, the MeViS and ReasonSeg validators")
            cli_counts = phase_train_cli(cfg, args.seed, train_counts,
                                         train_walls, smi)
            torch.cuda.empty_cache()

        if "cli" in chosen:
            phase("[cli] the serving CLIs from files: chat, eval_gcg_infer, "
                  "eval_gcg_metrics, eval_refer_infer (MeViS at 64 SAM frames, "
                  "sentences), eval_referdavis_metrics, eval_grounding, "
                  "eval_anet_entities_infer, convert_checkpoint")
            serve_cli_counts = phase_cli(cfg, args.seed, smi,
                                         share=shared.name)
            ckpt = {"dir": os.path.join(shared.name, "hf_export"),
                    "iv": os.path.join(shared.name, "iv.pt"),
                    "clip": os.path.join(shared.name, "clip.bin")}
            torch.cuda.empty_cache()
            phase("[cli] eval_gcg_infer with the generation stubbed to a "
                  "stream holding [SEG], narrow model, card against CPU")
            phase_cli_forced_seg(args.seed, smi)
            torch.cuda.empty_cache()

        if "parity" in chosen:
            phase("[parity] verify_parity --scale flagship --stages import,quant "
                  "--int4 --tokens_advisory under profile_trace; the datagen "
                  "segmenter on Hiera-L; narrow references; memory report")
            parity_counts = phase_parity(cfg, args.seed, smi, ckpt)
            torch.cuda.empty_cache()

        if "f32" in chosen:
            phase("[f32] the full-precision f32 routes (K1 simt_f32, K2 f32, K6 "
                  "f32) against their f32 twins at the f32 model's path shapes")
            phase_f32_kernels(K, cfg)
            torch.cuda.empty_cache()
            phase(f"[f32] the flagship in f32: {N_F32_REQUESTS} framewise requests "
                  "and 1 on the video branch from raw frames, under torch's "
                  "default TF32 flags")
            f32_counts, f32_track_counts = phase_f32_serve(cfg)
            phase(f"[f32] the flagship training in f32: {F32_TRAIN_STEPS} "
                  f"optimizer steps of {GRAD_ACCUM} micro-steps")
            f32_train_counts = phase_f32_train(cfg, args.seed)
            phase("[check] narrow f32 model on the card against its CPU f32 "
                  "twin: teacher-forced logits, masks, one training micro-step")
            phase_f32_small(args.seed)
            torch.cuda.empty_cache()

        if "f32q" in chosen:
            phase("[f32q] the f32 routes of K4, K5, K7 and K8 against their f32 "
                  "twins at the f32 model's path shapes")
            phase_f32q_kernels(K, cfg)
            torch.cuda.empty_cache()
            phase(f"[f32q] the flagship in f32 with int8 weights and the int8 "
                  f"cache ({N_F32Q_REQUESTS} framewise requests, the unhoisted "
                  "Hiera-L), int4 weights (1 request), and the video branch at "
                  "SAM image size 512 (1 request), from raw frames")
            f32q = phase_f32q_serve(cfg)
            phase("[check] narrow f32 model with int8 weights and the int8 cache "
                  "on the card against its CPU f32 twin")
            phase_f32q_small(args.seed)
            torch.cuda.empty_cache()
            phase("[f32q] verify_parity --dtype f32 --stages import,quant at "
                  "flagship and tiny scale")
            f32q_parity_counts = phase_f32q_parity(cfg, args.seed, smi, ckpt)
            torch.cuda.empty_cache()

        if "towers" in chosen:
            phase("[towers] freeze_towers=False: narrow tower gradients in bf16 "
                  "and f32 against the CPU f32 twin, then one backward through "
                  "the bf16 flagship's towers")
            towers_counts = phase_towers(cfg, args.seed)
            torch.cuda.empty_cache()

        if "parallel" in chosen:
            phase("[parallel] the sharded train step: the flagship on the mesh "
                  "(1, 1) over NCCL against make_train_step, serving through "
                  "shard_params, two gloo processes at (2, 1) and (1, 2)")
            parallel_counts = phase_parallel(cfg, args.seed, smi)
            torch.cuda.empty_cache()
    except Exception:
        traceback.print_exc()
        log("FAIL")
        return 1
    finally:
        shared.cleanup()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    # launches: the serving main path's run (int8 + int8 KV from raw frames,
    # 3 requests); the int4 entry's from the int4 path's run (2 requests);
    # K6's from the training path's run, whose counts stand beside every
    # kernel as launches_train (4 optimizer steps of 2 micro-steps); K1 at
    # head dim 256 from the video branch's run on the main path's model (2
    # requests), whose counts stand beside every kernel as launches_track;
    # K7's from the video branch at image size 512 (2 requests); K8's from
    # the unhoisted Hiera forward; the staging pass's from the video branch
    # on the main path's model; K9's four entries and the BSHD launcher
    # from the run of the two experiment harnesses; launches_predictors:
    # one image predictor `set_image` and the interactive session's two
    # propagations (26 frames: K1 at head dim 256); launches_sam1: the SAM-1
    # phase's three paths (K3 only); launches_train_cli: the train CLI's 3
    # optimizer steps from dataset files (validators not counted);
    # launches_cli: the serving CLIs' runs together (chat 1 request with the
    # video branch, eval_gcg_infer 2, eval_refer_infer 2 at 64 SAM frames and
    # 2 sentence records, eval_grounding 1, eval_anet_entities_infer 1);
    # launches_parity: verify_parity's int8 run at flagship width (one
    # clip_run: 12 new tokens, int8 weights and cache). A row keyed
    # "<counter>@<shape>" is another shape of the counter's kernel. Phases
    # that did not run leave their counts null.
    if "serve" in chosen:
        counts["attention_fwd[flash_d256]"] = track_counts["attention_fwd[flash_d256]"]
        counts["window_attention"] = track512_counts["window_attention"]
        counts["stage_bf16"] = track_counts["stage_bf16"]
        counts["smallwin_attention"] = hoist_counts["smallwin_attention"]
    else:
        counts = track_counts = {}
    if "train" in chosen:
        counts["flash_bwd"] = train_counts["flash_bwd"]
    else:
        train_counts = cli_counts = {}
    if "predictors" in chosen:
        pred_counts = {k: pred_counts.get(k, 0) + encode_counts[k]
                       for k in encode_counts}
    else:
        pred_counts = {}
    if "sam1" not in chosen:
        sam1_counts = {}
    if "cli" not in chosen:
        serve_cli_counts = {}
    if "parity" not in chosen:
        parity_counts = {}
    # the f32 routes' launches: K1's and K2's from the f32 flagship's
    # framewise run (2 requests), K6's from its training run (3 optimizer
    # steps of 2 micro-steps); launches_f32 / launches_f32_track /
    # launches_f32_train stand beside every kernel, and launches_towers: the
    # bf16 flagship's one forward and backward through the towers
    if "f32" in chosen:
        counts["attention_fwd_f32"] = f32_counts["attention_fwd_f32"]
        counts["gemm_epilogue_f32"] = f32_counts["gemm_epilogue_f32"]
        counts["flash_bwd_f32"] = f32_train_counts["flash_bwd_f32"]
    else:
        f32_counts = f32_track_counts = f32_train_counts = {}
    # the f32 routes of K4, K5, K7 and K8: K4's and K5 int8's from the f32
    # flagship's int8 run (2 requests), K5 int4's from its int4 run (1
    # request), K7's from its video branch at 512 (1 request), K8's from the
    # unhoisted f32 Hiera-L; launches_f32q (the int8 run) and
    # launches_f32q_parity (verify_parity's f32 int8 run at flagship
    # width) stand beside every kernel
    if "f32q" in chosen:
        f32q_counts, f32q4_counts, f32q_track_counts, f32q_hoist_counts = f32q
        counts["decode_attention_q8_f32"] = f32q_counts["decode_attention_q8_f32"]
        counts["dequant_gemv_f32[int8]"] = f32q_counts["dequant_gemv_f32[int8]"]
        counts["dequant_gemv_f32[int4]"] = f32q4_counts["dequant_gemv_f32[int4]"]
        counts["window_attention_f32"] = f32q_track_counts["window_attention_f32"]
        counts["smallwin_attention_f32"] = f32q_hoist_counts["smallwin_attention_f32"]
    else:
        f32q_counts = f32q_parity_counts = {}
    if "towers" not in chosen:
        towers_counts = {}
    # launches_parallel: the flagship's 3 sharded optimizer steps of 2
    # micro-steps on the mesh (1, 1)
    if "parallel" not in chosen:
        parallel_counts = {}
    if "experiments" in chosen:
        for key in experiment_counts:
            if key.startswith("decode_fused") or key == "flash_bshd":
                counts[key] = experiment_counts[key]
    kernels = []
    for key, row in K.rows.items():
        counter = key.split("@")[0]
        route, source = SOURCES[counter.split("[")[0]]
        kernels.append(dict(name=key, route=route, source=source,
                            replaces=REPLACES[counter],
                            launches=counts.get(counter),
                            launches_train=train_counts.get(counter),
                            launches_train_cli=cli_counts.get(counter),
                            launches_track=track_counts.get(counter),
                            launches_predictors=pred_counts.get(counter),
                            launches_sam1=sam1_counts.get(counter),
                            launches_cli=serve_cli_counts.get(counter),
                            launches_parity=parity_counts.get(counter),
                            launches_f32=f32_counts.get(counter),
                            launches_f32_track=f32_track_counts.get(counter),
                            launches_f32_train=f32_train_counts.get(counter),
                            launches_f32q=f32q_counts.get(counter),
                            launches_f32q_parity=f32q_parity_counts.get(counter),
                            launches_towers=towers_counts.get(counter),
                            launches_parallel=parallel_counts.get(counter),
                            **row))
    log(json.dumps({"kernels": kernels}))
    log(smi)
    result = {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}
    if args.phases != "all":
        result["phases"] = sorted(chosen)
    log(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
