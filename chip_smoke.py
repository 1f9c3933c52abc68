#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (msau_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

  0. require a CUDA card; print the card's name and power limit, the torch
     and CUDA versions, and build the hand-written kernels from csrc/
     (nvcc, sm_90a) with the build time;
  1. each kernel against its plain PyTorch version on the card, with its
     device time (torch.profiler; CUDA events where the profiler stays
     empty, counted in the report) beside
     the plain version's and, where one torch call computes the same
     function, that call's, and its bound (the larger of its operations
     over the FP32 peak, or for the DTYPE_AWARE kernels in bf16 the
     tensor-core peak, and its bytes over the memory rate; the
     attention's exponentials over the SFUs' rate a floor of its own):
       paint      a random 512^2 program (B = 4096: overlapping, cross-tile,
                  empty and zero-padded boxes), the edge programs of
                  utils/kernel_inputs.py at 512^2 and 130 x 97, and the
                  serve path's instances (paint_ccl_instances: the three
                  programs of the 512^2 bench page and of the page in the
                  1024 bucket), exact and the same bits on a rerun, the
                  instances timed (paint_ccl_times);
       CCL        blobby, noisy 3-class and maze maps at 512^2 and 1024^2,
                  the class map the decoder labels on each of those pages,
                  and CCL_CASES (865 x 860, 1 x 4096, 4096 x 1, one class,
                  a checkerboard), exact and the same bits on a rerun, the
                  serve path's instances timed; then its page axis
                  (check_ccl_batched): the decoder's class maps of 8 and 3
                  pages of the 512 bucket from one predict_batch, the map
                  kinds stacked (B 3 and 8 at 512^2, B 3 at 865 x 860), one
                  call a stack, each page equal to the plain version's and
                  to the kernel's own [H, W] call, the same bits on a
                  rerun, each stack timed beside ccl_bound times B;
       attention  the resident forward and backward on every ATTN_CASES
                  entry (N 16 and N 1 at T 4096, Cb 8, C 64; ragged T 1000
                  and 66; every other width of SPECIALISED_WIDTHS), f32 and
                  bf16, and integer logits near 2e5 in bf16
                  (ATTN_LARGE_LOGITS), each run twice for equal bits: the
                  forward within 1e-5 of the float64 plain version (bf16
                  2e-2 of the bf16 one) and its m, l within 1e-4, the
                  backward within 1e-4 of the largest |gradient| (bf16
                  2e-2); the forward timed at N 16 and N 1, the backward at
                  N 16, each beside its bound (bf16 at the tensor-core
                  peak);
       masked CE  fwd and bwd on [16, 17, 512^2] f32 and bf16 logits with
                  label-0 pixels and a masked-out band: correct exact,
                  ce_sum rel 1e-5, dlogits 1e-6 (f32) / 1e-2 (bf16);
       box conv   forward and backward (dx, both coordinate gradients) at
                  every scale shape of config 4 and of the benchmark's
                  BMSAU (BOX_SHAPES), f32 and bf16 inputs, coordinates
                  drawn as the model draws them, against the plain version
                  in float64 on the same input (BOX_TOL, over max(1, max
                  |want|); f32 no further than twice the f32 plain
                  version, bf16 no further than the bf16 one, or within
                  the tolerance), each run twice for equal bits; both timed
                  at the largest shape beside the plain version and their
                  byte bounds, and at each of the BMSAU's;
     the flat-layout forward kernels (entry layout, max pool, conv with its
     fused epilogue, concat 1x1, stride-2 deconv, fused residual block) on
     every case of utils/flat_cases.py: each instance the flagship's
     flat_scales=3 request runs, ragged shapes (odd sizes, an image smaller
     than a tile) and an LRN over 64 channels, in f32 (1e-5 of max(1, max
     |want|)) and bf16 (2e-2 of it), layout and pool exact; the conv, the
     coupling conv, the residual block and the deconv also timed at batch
     16 (with their library call where one exists); and their backward
     kernels
     (pool, conv stage 1 and dx, the concat 1x1 conv's one pass, deconv dx
     and dw, residual block) on every FLAT_BWD_CASES entry, the train
     step's instances at batch 16, in f32 and bf16 (FLAT_BWD_TOL), each run
     twice for equal bits (the concat 1x1 pass also beside the split path
     it replaced, conv stage 1 then the dx conv, on the same inputs; a
     coupling wider than the one pass takes runs that split path), and
     the weight gradients' partial-row sums timed alone (partial_sums);
       streaming attention  N=2, T=16384, Cb=8, C=64 (config 5's deepest
                  scale) and a ragged T = 8200 with f32 and bf16 operands,
                  T = 66, and integer logits near 2e5 (FUSED_LARGE_LOGITS),
                  against the blockwise plain versions: the f32 output
                  within 1e-5 of max(1, max |want|) for both operand types,
                  m within 1e-5 and l a relative 1e-5 (also read against
                  the plain version in float64), the backward (the rows
                  kernel's f32 path on the f32 cotangent) within 1e-4 of
                  the largest |gradient| (2e-2 for bf16 gradients), each
                  with the same bits on a second run; at T = 4096 the
                  blockwise plain version and the kernel against the
                  materialised [T, T] form (1e-5); the forward timed at N
                  2 and N 1;
       general attention  every width outside SPECIALISED_WIDTHS takes the
                  kernels of csrc/attention_general_fwd.cu and
                  attention_general_bwd.cu: the resident pair
                  on ATTN_WIDTH_CASES (C 4 to 2400, ragged T, and phase 9's
                  train instances) by the attention's tolerances above, and
                  the streaming pair on FUSED_WIDTH_CASES (also T 16384 at
                  C 96) against float64 (ATTN_TOL, ATTN_STATS_TOL), its
                  backward by the streaming one's, f32 and bf16, integer
                  logits at Cb 64, each twice for equal bits; the autograd
                  ops on the card at each width with every plain version
                  made to raise, each launch counted once in launches and
                  in general_launches; phase 9's instances and two wide
                  ones timed (ATTN_WIDTH_TIMED) beside their plain
                  versions, the bound and the tensor-core bound of the
                  design's products (_attention_tc_bound);
  2. the serve path, KVModel.predict, of the flagship model (img_channels 64,
     17 classes, 4 scales, feat_root 8, res_depth 2, 3 stages) at
     flat_scales 0 and 3, f32 and bf16, with the same seeded random weights
     on the 512^2 bench page: warm-up, then 5 requests per model with the
     launch counters reset just before and read just after.  Checks: the
     launches per request (paint 3, attention 3, CCL 1; at flat_scales 3
     also conv 21, residual block 18, concat 1x1 12, deconv 9, pool 9,
     entry layout 1, and no backward kernel); the decode tables equal the
     same pipeline's with the plain versions (CPU) on the same
     probabilities; at 64x64 the f32 forwards at flat_scales 0 and 3 on the
     card and on the CPU agree to 1e-4; the bf16 flat_scales 3
     probabilities lie from the bf16 flat_scales 0 ones at most 2.5 times
     as far (mean abs) as those lie from their f32 counterparts; p50 of
     each predict stage, flat_scales 0 and 3 side by side; then config 5's
     model (the flagship's widths at flat_scales 2: 1024^2 pages put 16384
     tokens at the deepest scale, where the model takes the streaming
     attention) on a page that lands in the 1024 bucket (2814 lines), f32
     and bf16, 3 requests each: launches per request (paint 3, streaming
     attention 3, resident attention 0, CCL 1, conv 15, residual block 12,
     concat 1x1 8, deconv 6, pool 6, entry layout 1), the decode tables
     equal to the plain-version pipeline's, p50 of each stage, and the f32
     probabilities on the page's chargrid within 2e-3 (mean 1e-6) of the
     CPU's plain versions with the same weights;
  2c. batched serving (serve_batch): KVModel.predict_batch of the flagship
     at flat_scales 3 and 0, f32 and bf16, with phase 2's seeded weights,
     on SERVE_BATCH_PAGES (six pages of the 512 bucket, two of the 1024
     bucket, interleaved): 2 timed calls after a warm-up with the launch
     counters reset just before and read just after (per call: paint 3 a
     page; per group one CCL, three attention forwards, resident at 512^2
     and streaming at 1024^2, and at flat_scales 3 the flat forward
     kernels of one request); each page's decode tables equal to the
     unbatched decoder's on its slice of the batched probabilities and its
     results to those tables'; in f32 the batched probabilities within
     5e-3 (mean 1e-6) of each page's predict, on the bench page within
     twice predict's distance of the float64 forward, and the results
     equal where the argmax maps agree (these checks on cuDNN's
     deterministic algorithms: at flat_scales 0 the default ones give
     other bits on every call); host ms and device busy ms
     (torch.profiler) per page beside predict's, one request a page;
  2d. field evaluation (field_eval): write_corpus of 8 labelled pages (rng
     11) under build/, run_test with the flagship at flat_scales 3, bf16:
     the launches per page a request's, num_label per class equal to the
     label files' own count, the counters equal to the sum of per-page
     predict(label_path=, eval_results=), the summary in [0, 1];
  3. the train path: the same model through Trainer.init_state and its
     train step (masked CE, Adam lr 1e-4, clip 1.0) at batch 16, 512^2, on
     the bench's structured batch, at flat_scales 3 (the bench's setting)
     and then 0, bf16 activations with f32 parameters, then f32: 2 warm-up
     steps, then 10 (fs 3) or 5 (fs 0) timed steps with the launch counters
     reset just before (img/s, ms/step, peak memory).  Checks: the launches
     per step (PER_STEP: at flat_scales 3 the six forward kernels and conv
     stage 1 21, conv dx 20, concat 1x1 bwd 12, residual block bwd 18,
     deconv dx 9, deconv dw 9, pool bwd 9; at both 3 attention forwards, 2
     attention backwards, 2 CE forwards and 2 CE backwards); the loss
     finite, and below its first
     value after 20 bf16 steps; and one step at 128^2, batch 2, from the
     same weights, held to the exact step (the CPU's plain versions in
     float64, at flat_scales 0 and 3 equal to 1e-6 of the bound): the
     card's f32 steps at flat_scales 3 and 0 within F32_VS_EXACT times the
     bound (each gradient within 1e-3 of that tensor's largest |gradient|
     plus 1e-6 of the model's; loss rel 1e-5, grad_norm rel 1e-3), the
     card's flat_scales 3 against its 0 within twice that, and the card's
     flat_scales 0 against the CPU's f32 step within 1x (grad_norm rel
     1e-4); see train_step_check.  Then config 5 through Trainer (batch 2,
     1024^2, remat, flat_scales 2; bf16, then f32): 2 warm-up and 5 timed
     steps, launches per step (PER_STEP_CONFIG5: the forward kernels of a
     stage twice, since remat recomputes it), the bf16 loss below its first
     value after 20 steps, a device profile, and the attention backward's
     scratch beside what was allocated while it ran and the step's peak (at
     the flagship's steps too);
     train_step_check also holds the card's flat_scales 2 step with the
     streaming attention forced (attention_impl="pallas") to the exact one;
  4. the model variants and entry A: (a) BASELINE config 4, the BMSAU (box
     convolutions: 2 a block, 3 boxes a channel, max 28) at 256^2, batch
     4, remat, f32 and bf16, on rng(0) uniform inputs and random labels
     (bench_configs.time_train): 2 warm-up and 5 timed steps (launches per
     step PER_STEP_CONFIG4: 6 resident attention forwards, 2 backwards, 2 CE
     forwards and backwards, 84 box filter forwards and 42 backwards), the
     loss below its first value after 10
     steps, a device profile; (b) one f32 step at 64^2, batch 2, of the
     BMSAU and of the flagship with use_lstm and use_spn (the LSTM's
     cuDNN cell, the CSPN), on the card within F32_VS_EXACT of the exact
     (float64, CPU) step and of the CPU's f32 step within twice that; (c)
     KVModel.predict of the BMSAU on the 512^2 bench page, f32: launches
     per request (paint 3, attention 3, CCL 1, box filter 42) and the
     decode tables equal
     to the plain pipeline's; (d) BASELINE config 3, the flagship's widths
     on 832 input channels, 256^2, batch 8, remat, f32, 3 timed steps; (e)
     entry A: preprocess_funsd of the FUNSD fixture, then train_funsd
     --device cuda --epochs 2 with --features chargrid, bert (the
     char-ngram fallback, 768 channels) and bow, and with a
     model_kwargs.json naming msau_box: paint 2 per run (one page),
     checkpoints 0, 1, 2 under the gen_prefix directory;
  5. entry B: (a) ChargridProvider._assemble (upload, paint x4, the
     one-hot, affine + elastic + rotation warps) on the card against the
     same on the CPU, from the same programs and augmentation seed, on the
     512^2 bench page and with rotate_mod90 on a 256 x 512 page, two
     examples each: the id planes exact, the binarised planes, labels and
     valid exact except where the CPU's value before its threshold lies
     within 1e-6 of it (counted), paint 4 an example; (b) write_corpus
     (rng 5) of 24 bench-sized pages under build/, random_split 0.75,
     train_generic (its library call, with fit(log_dir=)) at the
     flagship's widths, flat_scales 3, affine + elastic + rotate, batch 2,
     2 epochs of 6 steps: each step's loss finite and its launches phase
     3's flat kernels with the attention of its bucket (resident below
     8192 tokens, streaming from there) and no masked CE, paint 4 an
     example pulled, the checkpoints and metrics.jsonl written; ms/step
     and per example the worker's host ms, the device ms of upload, paint
     and warps, and the fetch ms; (c) run_kv_test --device cuda
     --flat_scales 3 on the val pages with the last checkpoint: a
     request's launches per page (paint 3, CCL 1, the flat forward
     kernels, the attention of the page's bucket) and the summary in [0,
     1];
  6. parallel/: (a) the flagship's step (bs 16, 512^2, flat_scales 3,
     phase 3's weights and batch) at spatial_shards 4 in one process,
     f32 then bf16: the forward logits (max error over the largest
     |value|), one step's loss and the gradients leaf by leaf, held to sp
     1 on the sharded code path (one shard: the same ops, only the halo
     rows' sources differ; SP_SAME_PATH) and to the f32 sp 1 step (f32:
     logits 1e-4, loss rel 1e-5, each gradient within twice phase 3's
     F32_VS_EXACT of its bound; bf16 sp 4 and sp 1 alike: SP_BF16_VS_F32,
     the median leaf), each reading beside its bound and beside the
     reading of a planted fault (every halo row zeroed), which must fail
     every bound; then 2 warm-up and 10 timed steps (launches per step
     PER_STEP_SP4 at sp 4: each residual block as two flat convs, the
     fused block 0 times; PER_STEP[3] at sp 1), ms per step, device busy
     ms and kernels per step; (b) on a one-rank NCCL group, the flagship
     in a Trainer on make_mesh((1,), ("data",)) and in one with no mesh,
     f32 and bf16: 1 + 3 steps each, then 6 alternating timed rounds of 5
     steps, losses and parameters equal bit for bit throughout (cuDNN's
     deterministic algorithms for both), ms per step by round, and a
     profile of each (busy ms, kernels, the collectives' host ms, the
     host ops whose time grew the most with the mesh);
     (c) sharded_conv2d on the one-rank group against
     F.conv2d, and a ConvBnLrnDrop with BatchNorm and dropout at 8 channels,
     512^2, against its CPU result in train mode (output and running
     statistics) and in eval mode (1e-5 of the largest |value|).  The
     process group is destroyed whatever happens;
  7. the trained end-to-end path: (a) examples/end_to_end_kv_torch.py's
     main on the card (the fixture page, 120 steps, f32): F1 > 0.9, paint,
     the attention forward and backward and the CCL launched, ms a step
     over the 120 and over 10 steady steps of a fresh demo model, kernels
     and busy ms of one profiled step; (b) tools/corpus_eval.run in this
     process at the protocol's model (2 stages, 4 scales, flat_scales 3,
     bf16) on 8 train and 4 held-out pages, 10 epochs (CORPUS_EVAL_ARGS):
     the epochs' losses finite and falling, the summary in [0, 1], every
     kernel of CORPUS_EVAL_KERNELS launched, F1 and pixel P / R printed (a
     smoke reading, not the protocol's); (c) its trained weights (f32,
     flat_scales 0) serving the held-out pages with predict(return_maps=
     False): p50 of each stage, busy ms and kernels a request; (d) the
     resident attention on PHASE7_ATTN_CASES, the flat kernels and their
     backward at (b)'s instances (256^2, batch 4), f32 and bf16, and the
     CCL on (c)'s class maps against their plain versions, phase 1's
     tolerances and the same bits on a rerun;
  8. the port's last modules: (a) a seeded state dict in the layout of the
     original PyTorch MSAU (utils/reference_weights.py) at the reference's
     FUNSD entry-A widths (featRoot 8, scale_space_num 4, res_depth 2, 3
     blocks, 17 classes, the serving charset's 64 tokens), migrated with
     utils/transplant.torch_state_dict_to_flax and served through
     KVModel.load(params=) / predict on the 512^2 bench page, f32, at
     flat_scales 0 and 3 (the launches of phase 2, the decode tables equal
     to the plain pipeline's, at 64x64 the card against the CPU and fs 3
     against fs 0 within 1e-4), and one request at the reference defaults
     (scale_space_num 6, res_depth 3); (b) the flagship train state (bs
     16, 512^2, fs 3, bf16, phase 3's batch) after 3 steps through
     utils/io.save_checkpoint with its config and a cg_dict, loaded by
     load_checkpoint into a fresh Trainer's state: the states, then the
     losses and every tensor after 2 more steps from each, equal bit for
     bit (cuDNN's deterministic algorithms), the meta and npz as written,
     and KVModel.load(model_weight=) serving the checkpoint; (c) the C
     rasterizer core (msau_tpu_torch/native) in use, its records equal to
     the numpy version's on the bench page, the 2814-line 1024^2 page and
     the 24 entry-B pages, and the host times (this machine's CPU, median
     of 20) of char_records and of the bench page's prepare_host, C and
     numpy;
  9. the model at widths outside SPECIALISED_WIDTHS, every deepest-scale
     attention a general kernel (phase9's comment: 9a feat_root 12 at the
     flagship's geometry, 9b the reference defaults at feat_root 16, 9c
     config 5 at feat_root 12, 9d pool 3), trained through Trainer (the
     attention's launches per step held, the loss finite and falling) and
     served through KVModel (launches per request held, decode tables
     equal to the plain pipeline's), 9b's and 9d's f32 logits on the
     bench page against the host CPU's float64 forward and 9a's fs 3
     against fs 0, within 1e-4; PHASE9_BUDGET_S its limit.

The line before the last two is one JSON object with every kernel's route,
source, the TPU kernel it replaces, its launches in phases 2 (2c and 2d
included), 3, 4, 5 (5b and 5c), 6 (6a and 6b), 7 (7a-7c), 8 (8a, 8b) and 9
(the general kernels' entries: phase 9 alone), its
largest error against the plain version (f32, 7d's cases included), its time, the plain version's,
the library call's (or null) and its bound; then the card's name and power
limit; the last line is the device record.  A fuller report, with nvcc's register and
shared-memory lines for each kernel, goes to build/chip_smoke.json.
"""

import glob
import json
import os
import shutil
import subprocess
import sys
import time


def _profile_once(fn, iters, keys=None):
    """One torch.profiler session over ``iters`` calls of ``fn`` -> (device
    ms per call: each kernel's summed time over the launches it recorded,
    times its launches per call, since the profiler now and then loses a
    launch's record; (min, max) ms of one launch of the kernel that took the
    most time), or None when the session recorded no device time.  With
    ``keys``, only the kernels whose name holds one of them count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per_call, top, top_us, recorded = 0.0, None, 0.0, False
    for evt in prof.key_averages():
        if evt.device_type == cuda and evt.count:
            recorded = True
            if keys is not None and not any(k in evt.key for k in keys):
                continue
            total = getattr(evt, "self_device_time_total",
                            getattr(evt, "self_cuda_time_total", 0.0))
            per_call += total / evt.count * round(evt.count / iters)
            if total > top_us:
                top, top_us = evt.key, total
    if not recorded or (keys is None and per_call <= 0):
        return None
    if top is None:
        return 0.0, (0.0, 0.0)
    launches = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                if e.device_type == cuda and e.key == top]
    return per_call / 1e3, (min(launches), max(launches))


# how the calls of _device_time were timed in this run, whether the
# profiler last failed a call outright, and the host clock before which a
# call after such a failure asks it no more
TIMER = {"profiler_calls": 0, "event_calls": 0, "profiler_down": False,
         "retry_at": 0.0}
# seconds a failed profiler is left alone: its outages last minutes, and
# each session asked during one costs as much host time as a recorded one
PROFILER_RETRY_S = 20.0


def _event_time(fn, iters):
    """CUDA events around ``iters`` back-to-back calls -> (ms per call,
    (ms, ms)).  Between the kernels of a call it also counts the gaps the
    host leaves, so a kernel of a few microseconds reads as the host's
    launch rate: the fallback only, marked in TIMER."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    return ms, (ms, ms)


def _device_time(fn, iters, attempts=3):
    """``_profile_once`` after two warm-up calls.  A session that recorded
    no device time (about one in a hundred on the H100's host) is run again
    after a pause, up to ``attempts`` times.  Now and then the profiler
    stays empty for minutes, every session started within a few seconds of
    the last one lost (one run lost 159 sessions): a call that used up its
    attempts takes CUDA events (``_event_time``), the calls of the next
    PROFILER_RETRY_S seconds take them with no session, and until the
    profiler records again each later call gives it one session and no
    pause, so the run ends inside its time limit; TIMER counts both, and
    the report and the line before the kernels' say how many calls fell
    back."""
    for _ in range(2):
        fn()
    if TIMER["profiler_down"] and time.perf_counter() < TIMER["retry_at"]:
        TIMER["event_calls"] += 1
        return _event_time(fn, iters)
    for i in range(1 if TIMER["profiler_down"] else attempts):
        got = _profile_once(fn, iters)
        if got is not None:
            TIMER["profiler_calls"] += 1
            TIMER["profiler_down"] = False
            return got
        print(f"[timer] torch.profiler recorded no device time ({i + 1})",
              flush=True)
        if not TIMER["profiler_down"] and i + 1 < attempts:
            time.sleep(0.5 * 2 ** i)
    TIMER["profiler_down"] = True
    TIMER["retry_at"] = time.perf_counter() + PROFILER_RETRY_S
    TIMER["event_calls"] += 1
    print("[timer] timed by CUDA events instead", flush=True)
    return _event_time(fn, iters)


def _cuda_ms(fn, iters):
    """Mean device time of one call of ``fn`` in ms (``_device_time``)."""
    return _device_time(fn, iters)[0]


# The least time the card could take for a kernel's work: the larger of
# the operations over the peak of the pipes that run them and the bytes
# moved, each input read once and each output written once, over the
# memory rate.  Every kernel runs its arithmetic on the FP32 pipes, bf16
# operands included, but these, whose bf16 operands go to the tensor cores
# (DTYPE_AWARE): the deconv forward, dx and weight gradient with the 3x3
# kernel, the coupling conv's one-pass backward, the flat conv's forward
# (the coupling's too), dx and stage 1 where their fast path takes the
# shape (_conv_fast), and the fused residual block forward and backward
# (every channel count), and the resident attention's forward and backward
# (every width; the streaming forward with bf16 operands too, and the
# streaming backward runs its f32 path in both dtypes: _attention_bound).
# The flat conv's f32 forward and dx go to the tensor cores too, as six
# bf16 products of three-part operands, where _conv_tc takes the shape.
# H100 SXM data sheet; the SFUs' exp2 rate, a floor of the attention's own,
# is 16 results per clock per SM at compute capability 9.0 (CUDA C++
# Programming Guide, throughput of arithmetic instructions) on 132 SMs at
# the 1.98 GHz of the data sheet's FP32 rate.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_EXP_PER_S = 132 * 16 * 1.98e9
# f32 flat convs on the tensor cores (_conv_tc): each f32 product is six
# bf16 products of three-part operands
PEAK_F32_TC_FLOPS = PEAK_BF16_FLOPS / 6
DTYPE_AWARE = ("flat_deconv2", "flat_deconv2_dx", "flat_deconv2_dw",
               "concat_conv1x1_bwd", "flat_conv2d", "flat_conv_dx",
               "flat_conv_bwd", "concat_conv1x1", "flat_res_block",
               "flat_res_block_bwd", "resident_attention_fwd",
               "resident_attention_bwd")


def _fast_shape(case, itemsize):
    """(op, k, d, cin, cout) of a flat conv case as its kernel sees it (the
    dx conv's channels swapped) where csrc/conv_fast.cuh:fast_shape takes
    it, else None."""
    op, k, d = case["op"], case.get("k", 1), case.get("d", 1)
    cin, cout = case["c"] + case.get("cb", 0), case["cout"]
    pleft = (k - 1) * d // 2
    if op == "flat_conv_dx":
        cin, cout, pleft = cout, cin, (k - 1) * d - pleft
    v = 16 // itemsize
    right = (k - 1) * d - pleft
    if (k not in ((3, 4) if op == "flat_conv_bwd" else (1, 3, 4))
            or cin > 64 or cout > 64 or pleft > v or right > v):
        return None
    return op, k, d, cin, cout


def _conv_tc(case):
    """Whether an f32 flat conv case (flat_conv2d, concat_conv1x1 or
    flat_conv_dx) runs on the tensor cores, mirroring csrc/flatconv.cu's
    tc_plan: a fast shape whose three bf16 parts, in tiles of 8 rows (of 4
    for a 3x3 kernel into more than 24 channels) and passes of at most 32
    input channels in chunks of 8, fit a block's shared memory (the
    weights', then the tile's or E)."""
    if case["op"] not in ("flat_conv2d", "concat_conv1x1", "flat_conv_dx"):
        return False
    shape = _fast_shape(case, 4)
    if shape is None:
        return False
    _, k, d, cin, cout = shape
    a16 = lambda b: (b + 15) // 16 * 16
    chunks = lambda c: 8 * (7 if -(-c // 8) == 6 else -(-c // 8))
    cs = chunks(min(cin, 32))
    wcs = chunks(cin if cin <= 32 else -(-cin // 32) * 32)
    nt = next(t for t in (1, 2, 3, 4, 8) if cout <= 8 * t)

    def smem(mt):   # tiles of 4 mt rows
        parts = a16(6 * (4 * mt + (k - 1) * d) * 40 * cs)
        e = a16(cout * (32 * 4 * mt + 4) * 4)
        return a16(6 * k * k * nt * 8 * wcs) + max(parts, e)
    return smem(2) <= 227 * 1024 or (k == 3 and cout > 24
                                     and smem(1) <= 227 * 1024)


def _conv_fast(case, itemsize):
    """Whether a flat conv case (flat_conv2d, concat_conv1x1, flat_conv_dx
    or flat_conv_bwd) takes the fast kernels of csrc/conv_fast.cuh,
    mirroring their dispatch (fast_shape, the dw plan and the shared memory
    of launch_fast (bf16), tc_plan (f32) and launch_bwd_fast)."""
    shape = _fast_shape(case, itemsize)
    if shape is None:
        return False
    op, k, d, cin, cout = shape
    v = 16 // itemsize
    a16 = lambda b: (b + 15) // 16 * 16
    f32 = itemsize == 4
    if f32 and op != "flat_conv_bwd":
        if _conv_tc(case):
            return True
        if k == 1:   # the coupling takes the tensor cores or the general path
            return False
    th = 4 if f32 else 8
    p, es = 32 * th, 32 * th + 4
    kc = -(-cin // (4 if f32 else 16))
    cs = 4 * (kc | 1) if f32 else 8 * (2 * kc + 1)
    xs = a16((th + (k - 1) * d) * (32 + 2 * v) * cs * itemsize)
    e = a16(cout * es * 4)
    ct = 8 if cout <= 8 else 12 if 16 < cout <= 24 else 16
    ng = -(-cout // ct)
    red = a16(8 // ng * ng * ct * p * 4)
    nt = next(t for t in (1, 2, 3, 4, 8) if cout <= 8 * t)
    w = (a16(k * k * kc * 4 * ng * ct * 4) if f32
         else a16(k * k * nt * 8 * cs * 2))
    if op != "flat_conv_bwd":
        smem = w + (max(xs, red) + e if f32 else max(xs, e))
        return smem <= 227 * 1024
    lrn = bool(case.get("lrn"))
    epi = lrn or case.get("act") is not None
    if epi and cout > 8 and k != 3:
        return False
    ntd = -(-cout // 8)
    if f32:
        if kc * k * ntd > 256:
            return False
        g = a16(p * 4 * (2 * ntd + 1) * 4)
    else:
        if kc * ntd > (16 if k == 3 and not epi else 8):
            return False
        w = a16(k * k * (4 if nt == 3 else nt) * 8 * cs * 2)
        g = a16(ntd * 8 * 264 * 2)
    u = 2 * e if lrn else e if epi and not f32 else 0
    total = (w * epi + xs + red * (epi and f32) + e * epi + u + g + 1024
             + a16(2 * cout * p * itemsize))
    if not f32 and 2 * kc * ntd <= 8:
        total = max(total, 8 * k * k * 128 * 4)
    return total <= 227 * 1024


def _bound(flops, nbytes, peak_flops=PEAK_F32_FLOPS):
    """-> (bound_ms, "operations" or "bytes")."""
    t_ops = flops / peak_flops * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


# the card cases beside the serve path's instances (paint_ccl_instances):
# paint at 512^2 and at an odd size, CCL at sizes no tile divides and on
# the worst cases for root contention (one class) and for the number of
# components (checker)
PAINT_SIZES = ((512, 512), (130, 97))
CCL_CASES = (("noisy", 865, 860), ("maze", 865, 860), ("noisy", 1, 4096),
             ("noisy", 4096, 1), ("one_class", 1024, 1024),
             ("checker", 512, 512))


def paint_bound(n_boxes, h, w):
    """Boxes [B, 4] and values [B] int32 read, the int32 grid written."""
    return _bound(0, n_boxes * 5 * 4 + h * w * 4)


def ccl_bound(h, w):
    """The int32 class map read, the int32 label map written."""
    return _bound(0, 2 * h * w * 4)


def _same_bits_as_plain(name, kernel, plain):
    """The kernel twice and its plain version on the same inputs: raises
    unless all three agree bit for bit."""
    import torch

    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    want = plain()
    if not torch.equal(got, again):
        raise AssertionError(f"{name}: a rerun gives other bits")
    differ = int((got != want).sum())
    if differ:
        raise AssertionError(f"{name}: {differ} values differ from the plain "
                             "version")


def check_kernels(dev):
    """Phase 1, paint and CCL -> {kernel: {max_abs_err, ms, plain_ms,
    library_ms, bound, cases, instances}}: every card case and every serve
    instance bit for bit against the plain version and on a rerun; the
    instances timed (``paint_ccl_times``), the JSON line's numbers taken at
    the bench page's char program and the noisy 512^2 map."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.ccl import (
        connected_components_multiclass_cuda,
        connected_components_multiclass_plain,
    )
    from msau_tpu_torch.ops.paint import paint_boxes_cuda, paint_boxes_plain
    from msau_tpu_torch.utils.kernel_inputs import (
        PAINT_EDGE_CASES,
        ccl_map,
        paint_edge_program,
        paint_program,
    )

    paint_cases = {"random_b4096 512x512": (
        paint_program(np.random.default_rng(0), 3500, 512, 512, 4096),
        512, 512)}
    for h, w in PAINT_SIZES:
        for name in PAINT_EDGE_CASES:
            paint_cases[f"{name} {h}x{w}"] = (paint_edge_program(name, h, w),
                                               h, w)
    for name, ((boxes, values), h, w) in paint_cases.items():
        b = torch.from_numpy(boxes).to(dev)
        v = torch.from_numpy(values).to(dev)
        _same_bits_as_plain(f"paint {name}",
                            lambda: paint_boxes_cuda(b, v, h, w),
                            lambda: paint_boxes_plain(b, v, h, w))
    ccl_cases = {}
    for kind, h, w in CCL_CASES:
        cls = torch.from_numpy(ccl_map(kind, h, w,
                                       np.random.default_rng(5))).to(dev)
        ccl_cases[f"{kind} {h}x{w}"] = cls
        _same_bits_as_plain(
            f"ccl {kind} {h}x{w}",
            lambda: connected_components_multiclass_cuda(cls),
            lambda: connected_components_multiclass_plain(cls))
    times = paint_ccl_times(dev, plain=True)
    out = {}
    for kernel, cases, prefix, at in (
            ("paint", paint_cases, "paint ", "char 512"),
            ("ccl_multiclass", ccl_cases, "ccl ", "noisy 512^2")):
        inst = {k[len(prefix):]: v for k, v in times.items()
                if k.startswith(prefix)}
        out[kernel] = {
            "max_abs_err": 0.0, "cases": sorted(cases) + sorted(inst),
            "timed_on": at, "ms": inst[at]["ms"],
            "plain_ms": inst[at]["plain_ms"], "library_ms": None,
            "bound": inst[at]["bound"], "instances": inst}
        print(f"[phase 1] {kernel} exact and the same bits on a rerun on "
              f"{len(out[kernel]['cases'])} cases; {at}: "
              f"{out[kernel]['ms']:.4f} ms vs plain "
              f"{out[kernel]['plain_ms']:.2f} ms", flush=True)
    return out


def _scaled_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    want = want.double()
    return float((got.double() - want).abs().max()
                 / max(1.0, float(want.abs().max())))


# (N, T, Cb, C) of the resident attention's card cases, each in f32 and
# bf16: the flagship train step's instance (N 16) and a page's (N 1) at T =
# 4096, ragged T, and the other widths of ops/attention.py:SPECIALISED_WIDTHS
# (Cb 32, C 256: the reference defaults' deepest scale, 6 scales at
# feat_root 8, on a 512^2 page and ragged)
ATTN_CASES = ((16, 4096, 8, 64), (1, 4096, 8, 64), (2, 1000, 8, 64),
              (3, 66, 8, 64), (2, 300, 1, 8), (2, 300, 2, 16),
              (1, 520, 4, 32), (1, 300, 16, 128), (1, 256, 32, 256),
              (2, 300, 32, 256))
# f and g scaled by 100 and rounded to integers put the logits near 2e5,
# the size the flagship's bf16 model at flat_scales 0 gives its first
# attention, each an integer below 2^24 and so exact in any sum order (the
# kernel's and the plain version's m agree to the bit); bf16 only, since
# f32 operands would not stay integers
ATTN_LARGE_LOGITS = (2, 1000, 8, 64, 100.0)
# the forward against its plain version with rtol = atol = tol (f32: the
# plain version run in float64, as the exact answer; bf16: the output is
# rounded to bf16); the backward's largest error over max(1, the largest
# |gradient|) (f32: sums over T keys in another order, rho cancels against
# h . dout; bf16: rounded gradients)
ATTN_TOL = {"fwd": {"float32": 1e-5, "bfloat16": 2e-2},
            "bwd": {"float32": 1e-4, "bfloat16": 2e-2}}
# the softmax statistics against the plain version's: m to 1e-4, l to a
# relative 1e-4 (the kernel takes exp on the SFU, ex2.approx)
ATTN_STATS_TOL = 1e-4
# the masked CE's logits shape: the flagship train step's
CE_SHAPE = (16, 17, 512 * 512)


def _attention_bytes(kernel, n, t, cb, c, itemsize):
    """Bytes one call of an attention kernel must move: forward f, g, h in,
    out and m, l (f32) out; backward f, g, h, dout, m, l in, df, dg, dh
    out.  The streaming forward's output is f32 whatever the operands, and
    the streaming backward counts 4-byte items (its f32 path)."""
    out_size = itemsize
    if kernel == "fused_attention_fwd":
        out_size = 4
    elif kernel.startswith("fused_attention"):
        itemsize = out_size = 4
    if kernel.endswith("_fwd"):
        return n * t * ((2 * cb + c) * itemsize + c * out_size) + n * t * 8
    return n * t * (4 * cb + 3 * c) * itemsize + n * t * 8


def _attention_bound(kernel, n, t, cb, c, itemsize):
    """(bound_ms, bound_by) of one call of an attention kernel.  Forward:
    the score product and A^T h; f, g, h in, out and m, l (f32) out.
    Backward: the score product, dh = A dout, h dout^T, dg = ds f and df =
    ds^T g; f, g, h, dout, m, l in, df, dg, dh out.  The resident kernels'
    bf16 products count at the tensor-core peak (DTYPE_AWARE), f32 at the
    FP32 peak.  The streaming forward's output is f32 whatever the
    operands: with bf16 ones its scores are exact bf16 products on the
    tensor cores and A^T h, A in f32 as three bf16 parts against bf16 h,
    three products; with f32 ones, like the streaming backward (an f32
    cotangent, its f32 path in both dtypes), it counts at the FP32 peak
    with 4-byte items.  The N T^2 exponentials on the SFUs are a floor of
    their own (bound by operations where it is the larger)."""
    fwd = kernel.endswith("_fwd")
    flops = 2 * n * t * t * ((cb + c) if fwd else (3 * cb + 2 * c))
    peak = PEAK_F32_FLOPS
    if kernel == "fused_attention_fwd" and itemsize == 2:
        flops = 2 * n * t * t * (cb + 3 * c)
        peak = PEAK_BF16_FLOPS
    elif kernel in DTYPE_AWARE and itemsize == 2:
        peak = PEAK_BF16_FLOPS
    ms, by = _bound(flops, _attention_bytes(kernel, n, t, cb, c, itemsize),
                    peak)
    exp_ms = n * t * t / PEAK_EXP_PER_S * 1e3
    return (exp_ms, "operations") if exp_ms > ms else (ms, by)


# The FP64 tensor cores' peak (H100 SXM data sheet), where the general
# attention kernels sum the f32 score product
PEAK_F64_TC_FLOPS = 67e12


def _attention_tc_bound(kernel, n, t, cb, c, itemsize):
    """(bound_ms, bound_by) of one call of a general attention kernel at
    the tensor cores' rates, by the products its design forms
    (csrc/attention_general_fwd.cu, _bwd.cu): the score product in each of
    its two passes (forward: stats and accumulate; backward: dh and ds), on the
    FP64 tensor cores with f32 operands and in bf16 with bf16 ones; every
    other product in bf16 as as many terms as its parts give (f32
    operands: six; bf16: one; an f32 A, ds or dout against bf16 operands:
    three; f32 A, ds and dout against each other: six); 2 N T^2
    exponentials (one a pass) on the SFUs; the bytes as _attention_bound
    counts them."""
    fwd = kernel.endswith("_fwd")
    stream = kernel.startswith("fused_attention")
    bf16 = itemsize == 2
    score = 2 * 2 * n * t * t * cb
    if fwd:
        # A^T h: A in f32 for an f32 output (the streaming form)
        terms = 1 if bf16 and not stream else 3 if bf16 else 6
        wide = terms * 2 * n * t * t * c
    else:
        # a dout and h dout^T over C, ds f and ds^T g over Cb; the
        # streaming backward's cotangent is f32 in both dtypes
        dterm = 3 if stream else 1
        wide = (2 * n * t * t * c * (6 if stream or not bf16 else 1)
                + 2 * n * t * t * c * (6 if not bf16 else dterm)
                + 2 * 2 * n * t * t * cb * (6 if not bf16 else dterm))
    ms = score / (PEAK_BF16_FLOPS if bf16 else PEAK_F64_TC_FLOPS) * 1e3 + (
        wide / PEAK_BF16_FLOPS * 1e3)
    exp_ms = 2 * n * t * t / PEAK_EXP_PER_S * 1e3
    bytes_ms = (_attention_bytes(kernel, n, t, cb, c, itemsize)
                / PEAK_BYTES_PER_S * 1e3)
    return max((ms, "operations"), (exp_ms, "operations"),
               (bytes_ms, "bytes"))


def _attention_tensors(dev, n, t, cb, c, dtype, scale=1.0):
    """The seeded f, g, h and dout of an attention case on ``dev``; with
    ``scale``, f and g times scale rounded to integers."""
    import numpy as np
    import torch

    from msau_tpu_torch.utils.kernel_inputs import attention_inputs

    rng = np.random.default_rng(t)
    f, g, h = attention_inputs(rng, n, t, cb, c)
    if scale != 1.0:
        f, g = np.round(f * scale), np.round(g * scale)
    f, g, h = (torch.from_numpy(a).to(dev, dtype) for a in (f, g, h))
    dout = torch.from_numpy(rng.normal(size=(n, t, c)).astype(
        np.float32)).to(dev, dtype)
    return f, g, h, dout


def check_attention_kernels(dev, cases=None, phase="phase 1", large=None):
    """Phase 1, the resident attention's kernels (forward: stats and
    accumulate; backward: rows and combine) on every ATTN_CASES entry in f32
    and bf16 against their plain versions, each run twice for equal bits;
    the forward timed at N 16 and N 1, the backward at N 16 -> {kernel:
    {max_abs_err, ms, plain_ms, bound, cases, times}}.  ``cases``: other
    (N, T, Cb, C) in place of ATTN_CASES and the large logits, untimed
    (phase 7d and the general kernels' cases), and ``large`` another
    large-logits case (N, T, Cb, C, scale) with them.  A probe quicker
    than the whole script: ``python3 -c "import chip_smoke as cs, torch;
    cs.check_attention_kernels(torch.device('cuda', 0))"``."""
    import torch

    from msau_tpu_torch.ops.attention import (
        resident_attention_bwd_cuda,
        resident_attention_bwd_plain,
        resident_attention_cuda,
        resident_attention_plain_stats,
    )

    fwd = {"cases": {}, "times": {}, "library_ms": None, "max_abs_err": 0.0}
    bwd = {"cases": {}, "times": {}, "library_ms": None, "max_abs_err": 0.0}
    runs = [(*case, 1.0, ("float32", "bfloat16"))
            for case in (cases or ATTN_CASES)]
    for case in ((ATTN_LARGE_LOGITS,) if cases is None else
                 (large,) if large else ()):
        runs.append((*case, ("bfloat16",)))
    for n, t, cb, c, scale, keys in runs:
        for key in keys:
            dtype = getattr(torch, key)
            f, g, h, dout = _attention_tensors(dev, n, t, cb, c, dtype, scale)
            name = f"N{n}_T{t}_Cb{cb}_C{c}_{key}" + (
                f"_scale{scale:g}" if scale != 1.0 else "")
            got = resident_attention_cuda(f, g, h)
            again = resident_attention_cuda(f, g, h)
            torch.cuda.synchronize()
            want, wm, wl = resident_attention_plain_stats(f, g, h)
            f32_err = None
            if key == "float32":
                # the f32 output against the plain version in float64: at N
                # 16 the kernel lies 9.9e-6 from it and 3.2e-5 from the f32
                # plain version, so that one is at least 2.2e-5 away
                f32_err = _max_abs(got[0], want)
                want = resident_attention_plain_stats(
                    f.double(), g.double(), h.double())[0]
            tol = ATTN_TOL["fwd"][key]
            err = {"max_abs_err": _max_abs(got[0], want),
                   "vs_f32_plain_max_abs_err": f32_err,
                   "scaled_err": _scaled_err(got[0], want),
                   # the largest share of its allowance (rtol = atol = tol)
                   # any element uses: the check below holds while <= 1
                   "tol_share": float(((got[0].double() - want.double()).abs()
                                       / (tol * (1 + want.double().abs()))
                                       ).max()),
                   "m_max_abs_err": _max_abs(got[1], wm),
                   "l_max_rel_err": float(((got[2] - wl).abs() / wl).max()),
                   "tol": tol, "bit_identical": all(
                       torch.equal(a, b) for a, b in zip(got, again))}
            close = torch.allclose(got[0].double(), want.double(), rtol=tol,
                                   atol=tol)
            if (got[0].dtype != dtype or not close or not err["bit_identical"]
                    or not err["m_max_abs_err"] <= ATTN_STATS_TOL
                    or not err["l_max_rel_err"] <= ATTN_STATS_TOL):
                raise AssertionError(f"attention fwd {name}: {err}, within "
                                     f"rtol = atol = {tol}: {close}")
            fwd["cases"][name] = err
            # the backward from the plain version's statistics
            grads = resident_attention_bwd_cuda(f, g, h, wm, wl, dout)
            again = resident_attention_bwd_cuda(f, g, h, wm, wl, dout)
            scratch = resident_attention_bwd_cuda.scratch_bytes
            torch.cuda.synchronize()
            wgrads = resident_attention_bwd_plain(f, g, h, wm, wl, dout)
            btol = ATTN_TOL["bwd"][key]
            berr = {"tol": btol, "scratch_mib": scratch / 2**20,
                    "bit_identical": all(torch.equal(a, b)
                                         for a, b in zip(grads, again))}
            for gname, a, b in zip(("df", "dg", "dh"), grads, wgrads):
                berr[gname] = {"max_abs_err": _max_abs(a, b),
                               "scaled_err": _scaled_err(a, b)}
                if a.dtype != dtype or not berr[gname]["scaled_err"] <= btol:
                    raise AssertionError(f"attention bwd {name} {gname}: "
                                         f"{berr[gname]} (tol {btol})")
            if not berr["bit_identical"]:
                raise AssertionError(f"attention bwd {name}: a second run "
                                     "gave other bits")
            bwd["cases"][name] = berr
            if key == "float32":
                fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                         err["max_abs_err"])
                bwd["max_abs_err"] = max(bwd["max_abs_err"], max(
                    berr[k]["max_abs_err"] for k in ("df", "dg", "dh")))
            del got, again, want, grads, wgrads
            isz = f.element_size()
            if cases is None and t == 4096 and cb == 8:
                fwd["times"][name] = {
                    "ms": _cuda_ms(lambda: resident_attention_cuda(f, g, h),
                                   20),
                    "plain_ms": _cuda_ms(
                        lambda: resident_attention_plain_stats(f, g, h), 5),
                    "bound": _attention_bound("resident_attention_fwd", n, t,
                                              cb, c, isz)}
            if cases is None and t == 4096 and n == 16:
                bwd["times"][name] = {
                    "ms": _cuda_ms(lambda: resident_attention_bwd_cuda(
                        f, g, h, wm, wl, dout), 10),
                    "plain_ms": _cuda_ms(lambda: resident_attention_bwd_plain(
                        f, g, h, wm, wl, dout), 5),
                    "bound": _attention_bound("resident_attention_bwd", n, t,
                                              cb, c, isz),
                    "scratch_mib": scratch / 2**20}
            print(f"[{phase}] attention {name}: fwd scaled err "
                  f"{err['scaled_err']:.3e} (tol {tol}), m {err['m_max_abs_err']:.2e}"
                  f", l rel {err['l_max_rel_err']:.2e}; bwd " + ", ".join(
                      f"{k} {berr[k]['scaled_err']:.3e}"
                      for k in ("df", "dg", "dh"))
                  + f" (tol {btol}); same bits on a rerun; bwd scratch "
                  f"{berr['scratch_mib']:.1f} MiB", flush=True)
            del f, g, h, dout, wm, wl
            torch.cuda.empty_cache()
    if cases is not None:
        return {"resident_attention_fwd": fwd, "resident_attention_bwd": bwd}
    # the kernels line: the forward as a page runs it, the backward as the
    # flagship train step does, f32
    main_f, main_b = "N1_T4096_Cb8_C64_float32", "N16_T4096_Cb8_C64_float32"
    for rec, main in ((fwd, main_f), (bwd, main_b)):
        rec.update(ms=rec["times"][main]["ms"],
                   plain_ms=rec["times"][main]["plain_ms"],
                   bound=rec["times"][main]["bound"], timed_on=main)
    for label, rec in (("fwd", fwd), ("bwd", bwd)):
        print(f"[phase 1] attention {label} times: " + "; ".join(
            f"{k} {v['ms']:.4f} ms vs plain {v['plain_ms']:.4f}, bound "
            f"{v['bound'][0]:.4f} ({v['bound'][1]})"
            for k, v in rec["times"].items()), flush=True)
    return {"resident_attention_fwd": fwd, "resident_attention_bwd": bwd}


def attention_times(dev, iters=10):
    """Device ms of the attention kernels at the main path's instances,
    from whichever msau_tpu_torch this process imports: the resident
    forward at N 16 and N 1, its backward at N 16 (T 4096), the streaming
    forward at N 2 (config 5's train step) and N 1 (a 1024^2 page) and its
    backward at N 2, T 16384, f32 and bf16 operands.  Loaded with
    ``importlib`` from another checkout's root it times that version on
    the same card (parent against change in one call)."""
    import torch

    from msau_tpu_torch.ops import attention as A

    out = {}
    for key in ("float32", "bfloat16"):
        dtype = getattr(torch, key)
        for n in (16, 1):
            f, g, h, dout = _attention_tensors(dev, n, 4096, 8, 64, dtype)
            out[f"fwd_N{n}_{key}"] = _cuda_ms(
                lambda: A.resident_attention_cuda(f, g, h), 2 * iters)
            if n == 16:
                _, m, l = A.resident_attention_cuda(f, g, h)
                out[f"bwd_N16_{key}"] = _cuda_ms(
                    lambda: A.resident_attention_bwd_cuda(f, g, h, m, l, dout),
                    iters)
        f, g, h, _ = _attention_tensors(dev, 2, 16384, 8, 64, dtype)
        dout = torch.randn((2, 16384, 64), device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
        out[f"stream_fwd_N2_T16384_{key}"] = _cuda_ms(
            lambda: A.fused_attention_cuda(f, g, h), iters)
        out[f"stream_fwd_N1_T16384_{key}"] = _cuda_ms(
            lambda: A.fused_attention_cuda(f[:1], g[:1], h[:1]), iters)
        _, m, l = A.fused_attention_cuda(f, g, h)
        out[f"stream_bwd_N2_T16384_{key}"] = _cuda_ms(
            lambda: A.fused_attention_bwd_cuda(f, g, h, m, l, dout), iters // 2)
        del f, g, h, dout, m, l
        torch.cuda.empty_cache()
    print(f"[attention times] {json.dumps(out)}", flush=True)
    return out


# ---- the attention at any width (csrc/attention_general_*.cu) ------------

# (N, T, Cb, C) of the general kernels' card cases, each in f32 and bf16,
# resident and streaming: every width outside
# ops/attention.py:SPECIALISED_WIDTHS takes them.  The widths of
# tests/test_torch_attention_widths.py at small and ragged T (37, 129,
# 300, 70, 100), two that stress the padding (Cb 5, 7; C 40, 52: k and n
# tiles partly past the edge), a Cb past 128 (the backward's dg and df in
# two launches), one past the 256 columns the kernels stage (Cb 300, C
# 2400: the rest read from global memory), and phase 9's train instances
# at feat_root 12 (C 96, N 16, T 4096) and at the reference defaults with
# feat_root 16 (C 512, N 4, T 256); the streaming cases add config 5's T
# 16384 at feat_root 12
ATTN_WIDTH_CASES = ((2, 37, 1, 4), (2, 300, 2, 20), (2, 129, 3, 24),
                    (2, 300, 12, 96), (16, 4096, 12, 96), (1, 324, 27, 216),
                    (2, 100, 48, 384), (4, 256, 64, 512), (2, 70, 128, 1024),
                    (2, 300, 5, 40), (3, 45, 7, 52), (1, 100, 200, 256),
                    (1, 64, 300, 2400))
FUSED_WIDTH_CASES = ATTN_WIDTH_CASES[:4] + ATTN_WIDTH_CASES[5:] + (
    (2, 16384, 12, 96),)
# integer logits near 2e5 and above (ATTN_LARGE_LOGITS) at the widest
# score product phase 9 runs, Cb 64: each logit an integer below 2^24
ATTN_WIDTH_LARGE_LOGITS = (2, 256, 64, 512, 100.0)
# phase 9's attention instances, each timed in f32 and bf16 beside its
# plain version and both bounds, and two wide ones whose backward forms
# the scores in more than two passes (C 512: three; C 1024: five; the
# forward's accumulate forms them once per 128 columns of C): label ->
# (op, N, T, Cb, C, backward too)
ATTN_WIDTH_TIMED = {
    "9a train": ("resident", 16, 4096, 12, 96, True),
    "9a serve": ("resident", 1, 4096, 12, 96, False),
    "9b train": ("resident", 4, 256, 64, 512, True),
    "9b serve": ("resident", 1, 256, 64, 512, False),
    "9c train": ("streaming", 2, 16384, 12, 96, True),
    "9d train": ("resident", 4, 324, 27, 216, True),
    "9d serve": ("resident", 1, 361, 27, 216, False),
    "C 512, T 4096": ("resident", 1, 4096, 64, 512, True),
    "C 1024, T 1000": ("resident", 1, 1000, 128, 1024, True),
}
# the kernels line's entry for each general kernel: its instance above
GENERAL_TIMED_ON = {"resident_attention_fwd_general": "9a train",
                    "resident_attention_bwd_general": "9a train",
                    "fused_attention_fwd_general": "9c train",
                    "fused_attention_bwd_general": "9c train"}


def _fused_width_errors(got, f, g, h, rerun, name):
    """A general streaming forward's (out, m, l) against the blockwise
    plain version in float64, the exact answer for either operand dtype
    (the output is f32 in both): out within ATTN_TOL's f32 value of max(1,
    max |want|), as the streaming checks scale it (over T 16384 rows the
    sums of h of either sign cancel: one element lay 4.2e-5 from float64,
    past rtol = atol = 1e-5 of it, and the f32 plain version 5.5e-5 from
    the kernel), m and l within
    ATTN_STATS_TOL (at Cb 64 and above the logits reach 60-90, where the
    f32 plain version's own m lies ~1e-5 off, one f32 ulp being 7.6e-6;
    the kernel sums f32 scores in f64), the same bits as ``rerun`` ->
    errors, also against the f32 plain version."""
    import torch

    from msau_tpu_torch.ops.attention import fused_attention_plain_stats

    out, m, l = got
    want, wm, wl = fused_attention_plain_stats(f.double(), g.double(),
                                               h.double())
    tol = ATTN_TOL["fwd"]["float32"]
    err = {"max_abs_err": _max_abs(out, want),
           "scaled_err": _scaled_err(out, want),
           "vs_f32_plain_max_abs_err": _max_abs(
               out, fused_attention_plain_stats(f, g, h)[0]),
           "m_max_abs_err": _max_abs(m, wm),
           "l_max_rel_err": float(((l.double() - wl).abs() / wl).max()),
           "tol": tol, "stats_tol": ATTN_STATS_TOL,
           "bit_identical": all(torch.equal(a, b) for a, b in zip(got, rerun))}
    if (out.dtype != torch.float32 or not err["bit_identical"]
            or not err["scaled_err"] <= tol
            or not err["m_max_abs_err"] <= ATTN_STATS_TOL
            or not err["l_max_rel_err"] <= ATTN_STATS_TOL):
        raise AssertionError(f"fused attention fwd {name}: {err}")
    return err


def check_fused_widths(dev):
    """Phase 1, the streaming attention's general kernels on every
    FUSED_WIDTH_CASES entry in f32 and bf16: the forward against the
    plain version in float64 (_fused_width_errors); the backward on an f32
    cotangent within FUSED_BWD_TOL of the blockwise plain version; each
    run twice for equal bits; then ATTN_WIDTH_LARGE_LOGITS (m to the bit)
    -> {"fused_attention_fwd": record, "fused_attention_bwd": record}."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.attention import (
        fused_attention_bwd_cuda,
        fused_attention_bwd_plain,
        fused_attention_cuda,
    )

    fwd = {"cases": {}, "max_abs_err": 0.0}
    bwd = {"cases": {}, "max_abs_err": 0.0}
    for n, t, cb, c in FUSED_WIDTH_CASES:
        for key in ("float32", "bfloat16"):
            f, g, h, _ = _attention_tensors(dev, n, t, cb, c,
                                            getattr(torch, key))
            dout = torch.from_numpy(np.random.default_rng(c).normal(
                size=(n, t, c)).astype(np.float32)).to(dev)
            name = f"N{n}_T{t}_Cb{cb}_C{c}_{key}"
            got = fused_attention_cuda(f, g, h)
            again = fused_attention_cuda(f, g, h)
            torch.cuda.synchronize()
            err = _fused_width_errors(got, f, g, h, again, name)
            if key == "float32":
                fwd["max_abs_err"] = max(fwd["max_abs_err"],
                                         err["vs_f32_plain_max_abs_err"])
            fwd["cases"][name] = err
            _, m, l = got
            grads = fused_attention_bwd_cuda(f, g, h, m, l, dout)
            again = fused_attention_bwd_cuda(f, g, h, m, l, dout)
            torch.cuda.synchronize()
            wgrads = fused_attention_bwd_plain(f, g, h, m, l, dout)
            tol = FUSED_BWD_TOL[key]
            berr = {"tol": tol, "bit_identical": all(
                torch.equal(a, b) for a, b in zip(grads, again))}
            for gname, a, b in zip(("df", "dg", "dh"), grads, wgrads):
                berr[gname] = {"max_abs_err": _max_abs(a, b),
                               "scaled_err": _scaled_err(a, b)}
                if a.dtype != f.dtype or berr[gname]["scaled_err"] > tol:
                    raise AssertionError(f"fused attention bwd {name} "
                                         f"{gname}: {berr[gname]} (tol {tol})")
            if not berr["bit_identical"]:
                raise AssertionError(f"fused attention bwd {name}: a second "
                                     "run gave other bits")
            if key == "float32":
                bwd["max_abs_err"] = max(bwd["max_abs_err"], max(
                    berr[k]["max_abs_err"] for k in ("df", "dg", "dh")))
            bwd["cases"][name] = berr
            print(f"[phase 1] fused attention {name}: fwd against float64 "
                  f"scaled err {err['scaled_err']:.3e} (tol "
                  f"{ATTN_TOL['fwd']['float32']}), m {err['m_max_abs_err']:.2e}"
                  f", l rel {err['l_max_rel_err']:.2e} (tol {ATTN_STATS_TOL})"
                  f"; bwd "
                  + ", ".join(f"{k} {berr[k]['scaled_err']:.3e}"
                              for k in ("df", "dg", "dh"))
                  + f" (tol {tol}); same bits on a rerun", flush=True)
            del f, g, h, dout, got, again, grads, wgrads, m, l
            torch.cuda.empty_cache()
    n, t, cb, c, scale = ATTN_WIDTH_LARGE_LOGITS
    for key in ("float32", "bfloat16"):
        f, g, h, _ = _attention_tensors(dev, n, t, cb, c, getattr(torch, key),
                                        scale)
        got, again = fused_attention_cuda(f, g, h), fused_attention_cuda(f, g, h)
        name = f"N{n}_T{t}_Cb{cb}_C{c}_{key}_scale{scale:g}"
        err = fwd["cases"][name] = _fused_width_errors(got, f, g, h, again,
                                                       name)
        if not err["m_max_abs_err"] == 0.0:
            raise AssertionError(f"fused attention {name}: m is not exact")
        print(f"[phase 1] fused attention {name}: fwd against float64 "
              f"{err['max_abs_err']:.3e}, m exact; same bits on a rerun",
              flush=True)
    return {"fused_attention_fwd": fwd, "fused_attention_bwd": bwd}


def _general_autograd_on_card(dev):
    """Each general width (ATTN_WIDTH_CASES below T 1000) through the
    autograd ops on the card, forward and backward, f32 and bf16, with every
    plain version of ops/attention.py replaced by one that raises: each
    call raises its wrapper's launches and general_launches by one ->
    {width: launches}."""
    import torch

    from msau_tpu_torch.ops import attention as A

    wrappers = {"resident": (A.resident_attention, A.resident_attention_cuda,
                             A.resident_attention_bwd_cuda),
                "streaming": (A.fused_attention, A.fused_attention_cuda,
                              A.fused_attention_bwd_cuda)}
    plain = [k for k in vars(A) if k.endswith(("_plain", "_plain_stats"))]
    saved = {k: getattr(A, k) for k in plain}

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    seen = {}
    try:
        for k in plain:
            setattr(A, k, refuse)
        for n, t, cb, c in ATTN_WIDTH_CASES:
            if t >= 1000:
                continue
            for key in ("float32", "bfloat16"):
                f, g, h, dout = _attention_tensors(dev, n, t, cb, c,
                                                   getattr(torch, key))
                for op_name, (op, fw, bw) in wrappers.items():
                    before = [(w.launches, w.general_launches) for w in (fw, bw)]
                    leaves = [x.clone().requires_grad_() for x in (f, g, h)]
                    out = op(*leaves)
                    out.backward(dout.to(out.dtype))
                    torch.cuda.synchronize()
                    after = [(w.launches, w.general_launches) for w in (fw, bw)]
                    if any(a != (b[0] + 1, b[1] + 1)
                           for a, b in zip(after, before)):
                        raise AssertionError(
                            f"{op_name} attention ({cb}, {c}) {key}: "
                            f"launches {before} -> {after}")
                    if not all(torch.isfinite(x.grad).all() for x in leaves):
                        raise AssertionError(f"{op_name} attention ({cb}, "
                                             f"{c}) {key}: gradient not finite")
                seen[f"({cb}, {c}) {key}"] = "fwd and bwd launched once each"
    finally:
        for k, fn in saved.items():
            setattr(A, k, fn)
    print(f"[phase 1] general attention through the autograd ops on the "
          f"card: {len(seen)} widths x dtypes, resident and streaming, each "
          "forward and backward one launch of its kernel, no plain version",
          flush=True)
    return seen


def attention_width_times(dev, iters=10):
    """ATTN_WIDTH_TIMED: each instance's device ms (f32 and bf16), the
    plain versions', the bound (_attention_bound) and the tensor-core bound
    of the design's products (_attention_tc_bound) -> {label: {dtype:
    record}}."""
    import torch

    from msau_tpu_torch.ops import attention as A

    out = {}
    for label, (op, n, t, cb, c, with_bwd) in ATTN_WIDTH_TIMED.items():
        out[label] = {}
        res = op == "resident"
        fwd_k = A.resident_attention_cuda if res else A.fused_attention_cuda
        bwd_k = (A.resident_attention_bwd_cuda if res
                 else A.fused_attention_bwd_cuda)
        fwd_p = (A.resident_attention_plain_stats if res
                 else A.fused_attention_plain_stats)
        bwd_p = (A.resident_attention_bwd_plain if res
                 else A.fused_attention_bwd_plain)
        kname = "resident_attention" if res else "fused_attention"
        for key in ("float32", "bfloat16"):
            f, g, h, dout = _attention_tensors(dev, n, t, cb, c,
                                               getattr(torch, key))
            if not res:
                dout = dout.float()
            isz = f.element_size()
            rec = {"fwd_ms": _cuda_ms(lambda: fwd_k(f, g, h), 2 * iters)}
            rec["fwd_plain_ms"] = _cuda_ms(lambda: fwd_p(f, g, h), 3)
            rec["fwd_bound"] = _attention_bound(f"{kname}_fwd", n, t, cb, c,
                                                isz)
            rec["fwd_tc_bound"] = _attention_tc_bound(f"{kname}_fwd", n, t,
                                                      cb, c, isz)
            if with_bwd:
                _, m, l = fwd_k(f, g, h)
                rec["bwd_ms"] = _cuda_ms(lambda: bwd_k(f, g, h, m, l, dout),
                                         iters)
                rec["bwd_plain_ms"] = _cuda_ms(
                    lambda: bwd_p(f, g, h, m, l, dout), 3)
                rec["bwd_bound"] = _attention_bound(f"{kname}_bwd", n, t, cb,
                                                    c, isz)
                rec["bwd_tc_bound"] = _attention_tc_bound(
                    f"{kname}_bwd", n, t, cb, c, isz)
                del m, l
            out[label][key] = rec
            print(f"[phase 1] general attention {label} (N {n}, T {t}, Cb "
                  f"{cb}, C {c}) {key}: " + ", ".join(
                      f"{k} {v:.4f}" if isinstance(v, float) else
                      f"{k} {v[0]:.4f} ({v[1]})" for k, v in rec.items()),
                  flush=True)
            del f, g, h, dout
            torch.cuda.empty_cache()
    return out


def check_attention_widths(dev):
    """Phase 1, the general attention kernels: the resident forward and
    backward on ATTN_WIDTH_CASES (and ATTN_WIDTH_LARGE_LOGITS in bf16) by
    check_attention_kernels' tolerances, the streaming pair on
    FUSED_WIDTH_CASES (check_fused_widths), the autograd ops on the card
    with no plain version reachable, and the timed instances -> {general
    kernel: {max_abs_err, ms, plain_ms, bound, library_ms, ...}}."""
    res = check_attention_kernels(dev, ATTN_WIDTH_CASES, phase="phase 1",
                                  large=ATTN_WIDTH_LARGE_LOGITS)
    res.update(check_fused_widths(dev))
    autograd = _general_autograd_on_card(dev)
    times = attention_width_times(dev)
    out = {}
    for name, label in GENERAL_TIMED_ON.items():
        base = name[:-len("_general")]
        part = "bwd" if base.endswith("_bwd") else "fwd"
        rec = times[label]["float32"]
        out[name] = {"max_abs_err": res[base]["max_abs_err"],
                     "cases": res[base]["cases"],
                     "ms": rec[f"{part}_ms"],
                     "plain_ms": rec[f"{part}_plain_ms"],
                     "bound": rec[f"{part}_bound"], "library_ms": None,
                     "timed_on": f"{label} float32", "times": times,
                     "autograd_on_card": autograd}
    return out


def check_train_kernels(dev):
    """Phase 1, the train slice's kernels -> {kernel: {max_abs_err, ms,
    plain_ms, cases}}."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.ce_loss import (
        masked_ce_bwd_cuda,
        masked_ce_bwd_plain,
        masked_ce_fwd_cuda,
        masked_ce_fwd_plain,
    )
    from msau_tpu_torch.utils.kernel_inputs import ce_inputs

    out = {}
    # ---- masked CE ---------------------------------------------------
    logits32, labels, maskf = (
        torch.from_numpy(a).to(dev) for a in
        ce_inputs(np.random.default_rng(0), *CE_SHAPE))
    g = torch.tensor(0.37, device=dev)
    cases, times = {}, {}
    for dtype, tol in ((torch.float32, 1e-6), (torch.bfloat16, 1e-2)):
        logits = logits32.to(dtype)
        key = str(dtype).split(".")[-1]
        s, c = masked_ce_fwd_cuda(logits, labels, maskf)
        torch.cuda.synchronize()
        ps, pc = masked_ce_fwd_plain(logits, labels, maskf)
        rel = abs(float(s) - float(ps)) / abs(float(ps))
        if float(c) != float(pc) or rel > 1e-5:
            raise AssertionError(f"masked CE fwd {key}: ce_sum {float(s)} vs "
                                 f"{float(ps)}, correct {float(c)} vs {float(pc)}")
        dl = masked_ce_bwd_cuda(logits, labels, maskf, g)
        torch.cuda.synchronize()
        dl_err = _max_abs(dl, masked_ce_bwd_plain(logits, labels, maskf, g))
        if dl.dtype != dtype or dl_err > tol:
            raise AssertionError(f"masked CE bwd {key}: max abs err {dl_err}")
        cases[key] = {"ce_sum": float(s), "ce_sum_abs_err": abs(float(s) - float(ps)),
                      "ce_sum_rel_err": rel, "correct": float(c),
                      "correct_equal": True, "dlogits_max_abs_err": dl_err,
                      "dlogits_tol": tol}
        times[key] = {
            "fwd_ms": _cuda_ms(lambda: masked_ce_fwd_cuda(logits, labels, maskf), 20),
            "fwd_plain_ms": _cuda_ms(lambda: masked_ce_fwd_plain(logits, labels, maskf), 10),
            "bwd_ms": _cuda_ms(lambda: masked_ce_bwd_cuda(logits, labels, maskf, g), 20),
            "bwd_plain_ms": _cuda_ms(lambda: masked_ce_bwd_plain(logits, labels, maskf, g), 10),
        }
        print(f"[phase 1] masked CE {key}: ce_sum rel err {rel:.3e}, correct "
              f"{float(c):.0f} exact, dlogits max abs err {dl_err:.3e} "
              f"(tol {tol}); {json.dumps(times[key])}", flush=True)
    # the masked CE sum is one cross_entropy call with the masked-out
    # pixels' labels set to its ignore_index (prepared outside the timing)
    ignore = torch.where(maskf > 0, labels.long(), torch.full_like(labels.long(), -100))
    library_ms = _cuda_ms(lambda: torch.nn.functional.cross_entropy(
        logits32, ignore, ignore_index=-100, reduction="sum"), 20)
    n, c, length = CE_SHAPE
    out["masked_ce_fwd"] = {
        "max_abs_err": cases["float32"]["ce_sum_abs_err"], "cases": cases,
        "ms": times["float32"]["fwd_ms"], "plain_ms": times["float32"]["fwd_plain_ms"],
        "library_ms": library_ms, "times": times,
        "bound": _bound(0, n * length * (c + 2) * 4)}
    out["masked_ce_bwd"] = {
        "max_abs_err": cases["float32"]["dlogits_max_abs_err"], "cases": cases,
        "ms": times["float32"]["bwd_ms"], "plain_ms": times["float32"]["bwd_plain_ms"],
        "library_ms": None, "times": times,
        "bound": _bound(0, n * length * (2 * c + 2) * 4)}
    return out


# the box convolution's card cases (N, C, H, W), 3 boxes of up to 28: each
# scale of config 4 (4 scales from 256^2, batch 4) and of the benchmark's
# BMSAU (benchmark/configs/bmsau_default.json: 6 scales from 512^2, batch
# 16), featRoot 8; the last is the largest, the one timed against the plain
# version
BOX_MAX = 28
BOX_SHAPES = ([(4, 8 * 2 ** s, 256 // 2 ** s, 256 // 2 ** s) for s in range(4)]
              + [(16, 8 * 2 ** s, 512 // 2 ** s, 512 // 2 ** s)
                 for s in range(5, -1, -1)])
# tolerances of (out, dx, dybox, dxbox) over max(1, max |want|), as the card
# tests hold them (tests/test_torch_kernels_gpu.py)
BOX_TOL = {"float32": (2e-3, 2e-5, 5e-5, 5e-5),
           "bfloat16": (2e-3, 4e-3, 5e-5, 5e-5)}


def _box_bytes(kind, n, c, h, w, itemsize):
    """Bytes the box filter must move: the forward reads x and the f32
    coordinates and writes the 3 f32 responses; the backward reads their
    cotangent, x and the coordinates, writes dx and the coordinates'
    gradients."""
    x, y = n * c * h * w * itemsize, n * c * 3 * h * w * 4
    coords = 2 * 2 * c * 3 * 4
    return x + y + coords if kind == "fwd" else y + 2 * x + 3 * coords


def check_box_kernels(dev):
    """Phase 1, the box convolution's kernels -> {kernel: {max_abs_err, ms,
    plain_ms, library_ms, bound, cases, times}}."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.boxconv import (
        box_conv_bwd_cuda,
        box_conv_bwd_plain,
        box_conv_fwd_cuda,
        box_conv_plain,
    )

    kw = dict(max_h=BOX_MAX, max_w=BOX_MAX)
    cases, worst = {}, {"fwd": 0.0, "bwd": 0.0}
    for n, c, h, w in BOX_SHAPES:
        rng = np.random.default_rng(n * c + h)
        # the model's draw: centre U(-max/4, max/4), half-size U(1, max/2)
        centre = rng.uniform(-BOX_MAX / 4, BOX_MAX / 4, (2, c, 3))
        half = rng.uniform(1, BOX_MAX / 2, (2, c, 3))
        yb, xb = (torch.from_numpy(np.stack([centre[i] - half[i],
                                             centre[i] + half[i]])).float()
                  .to(dev) for i in range(2))
        x32 = torch.from_numpy(rng.random((n, c, h, w), dtype=np.float32)).to(dev)
        g = torch.from_numpy(rng.standard_normal((n, c * 3, h, w),
                                                 dtype=np.float32)).to(dev)
        for dtype, tols in BOX_TOL.items():
            x = x32.to(getattr(torch, dtype))
            runs = [(box_conv_fwd_cuda(x, yb, xb, **kw),
                     *box_conv_bwd_cuda(x, yb, xb, g, **kw)) for _ in range(2)]
            torch.cuda.synchronize()
            key = f"N{n} C{c} {h}x{w} {dtype}"
            for a, b in zip(*runs):
                if not torch.equal(a, b):
                    raise AssertionError(f"box conv {key}: a rerun gives "
                                         "other bits")
            want = (box_conv_plain(x.double(), yb.double(), xb.double(), **kw),
                    *box_conv_bwd_plain(x.double(), yb.double(), xb.double(),
                                        g.double(), **kw))
            plain = (box_conv_plain(x, yb, xb, **kw),
                     *box_conv_bwd_plain(x, yb, xb, g, **kw))
            errs = [_scaled_err(a, b) for a, b in zip(runs[0], want)]
            plain_errs = [_scaled_err(a, b) for a, b in zip(plain, want)]
            del runs, want, plain
            for name, e, pe, tol in zip(("out", "dx", "dybox", "dxbox"),
                                        errs, plain_errs, tols):
                near = max(2 * pe, 1e-5) if dtype == "float32" else max(pe, tol)
                if e > tol or e > near:
                    raise AssertionError(
                        f"box conv {key}: {name} error {e:.3e} (tolerance "
                        f"{tol}, the plain version's {pe:.3e})")
            cases[key] = {"errors": errs, "plain_errors": plain_errs}
            if dtype == "float32":
                worst["fwd"] = max(worst["fwd"], errs[0])
                worst["bwd"] = max(worst["bwd"], *errs[1:])
            print(f"[phase 1] box conv {key}: out / dx / dybox / dxbox "
                  f"errors {', '.join(f'{e:.2e}' for e in errs)} (plain "
                  f"{', '.join(f'{e:.2e}' for e in plain_errs)})", flush=True)
        del x32, g
        torch.cuda.empty_cache()

    # times: every shape of the benchmark's BMSAU, and the plain version at
    # the largest
    times = {}
    for n, c, h, w in BOX_SHAPES[4:]:
        x = torch.rand((n, c, h, w), device=dev)
        yb = torch.tensor([-7.5, 6.25], device=dev)[:, None, None].expand(
            2, c, 3).contiguous()
        g = torch.randn((n, c * 3, h, w), device=dev)
        rec = {}
        for dtype in BOX_TOL:
            xd = x.to(getattr(torch, dtype))
            item = xd.element_size()
            rec[dtype] = {
                "fwd_ms": _cuda_ms(lambda: box_conv_fwd_cuda(xd, yb, yb, **kw), 10),
                "bwd_ms": _cuda_ms(lambda: box_conv_bwd_cuda(xd, yb, yb, g, **kw), 10),
                "fwd_bound_ms": _bound(0, _box_bytes("fwd", n, c, h, w, item))[0],
                "bwd_bound_ms": _bound(0, _box_bytes("bwd", n, c, h, w, item))[0]}
        if (n, c, h, w) == BOX_SHAPES[-1]:
            rec["float32"]["fwd_plain_ms"] = _cuda_ms(
                lambda: box_conv_plain(x, yb, yb, **kw), 3)
            rec["float32"]["bwd_plain_ms"] = _cuda_ms(
                lambda: box_conv_bwd_plain(x, yb, yb, g, **kw), 3)
        times[f"N{n} C{c} {h}x{w}"] = rec
        print(f"[phase 1] box conv times N{n} C{c} {h}x{w}: {json.dumps(rec)}",
              flush=True)
        del x, g
    torch.cuda.empty_cache()
    n, c, h, w = BOX_SHAPES[-1]
    top = times[f"N{n} C{c} {h}x{w}"]["float32"]
    return {f"box_conv_{kind}": {
        "max_abs_err": worst[kind], "ms": top[f"{kind}_ms"],
        "plain_ms": top[f"{kind}_plain_ms"], "library_ms": None,
        "bound": _bound(0, _box_bytes(kind, n, c, h, w, 4)),
        "cases": cases, "times": times} for kind in ("fwd", "bwd")}


# (N, T, operand dtype) of the streaming attention's cases: config 5's
# deepest scale (1024^2 pages, batch 2), a ragged T above the streaming
# threshold and a small one.  The forward's output is f32 whatever the
# operands, so both dtypes are held to FUSED_FWD_TOL of max(1, max |want|)
# (bf16 operands are upcast alike on both sides and nothing is rounded on
# the way out), m to FUSED_FWD_TOL and l to a relative FUSED_FWD_TOL; the
# backward's gradients come out in the operands' dtype
FUSED_CASES = ((2, 16384, "float32"), (2, 16384, "bfloat16"),
               (1, 8200, "float32"), (1, 8200, "bfloat16"),
               (3, 66, "float32"))
FUSED_FWD_TOL = 1e-5
FUSED_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # of the largest |gradient|
# f and g scaled by 100 and rounded to integers: logits near 2e5, each an
# integer below 2^24 in either operand dtype and so exact in any sum order
# (ATTN_LARGE_LOGITS for the streaming forward), forward only
FUSED_LARGE_LOGITS = (2, 1000, 100.0)


def _fused_fwd_errors(got, want, rerun):
    """The streaming forward's (out, m, l) against a plain version's ->
    errors; raises past FUSED_FWD_TOL or when ``rerun`` has other bits."""
    import torch

    (out, m, l), (wout, wm, wl) = got, want
    err = {"max_abs_err": _max_abs(out, wout),
           "scaled_err": _scaled_err(out, wout),
           "m_max_abs_err": _max_abs(m, wm),
           "l_max_rel_err": float(((l.double() - wl.double()).abs()
                                   / wl.double()).max()),
           "tol": FUSED_FWD_TOL,
           "bit_identical": all(torch.equal(a, b) for a, b in zip(got, rerun))}
    if (out.dtype != torch.float32 or not err["bit_identical"]
            or not err["scaled_err"] <= FUSED_FWD_TOL
            or not err["m_max_abs_err"] <= FUSED_FWD_TOL
            or not err["l_max_rel_err"] <= FUSED_FWD_TOL):
        raise AssertionError(f"fused attention fwd: {err}")
    return err


def check_fused_attention(dev):
    """Phase 1, the streaming attention (forward kernels, and the rows
    kernel on their f32 cotangent) against the blockwise plain versions ->
    {kernel: {max_abs_err, ms, plain_ms, cases, ...}}.  Each forward also
    runs twice for equal bits and is read against the plain version in
    float64 (``vs_f64_scaled_err``)."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.attention import (
        fused_attention_bwd_cuda,
        fused_attention_bwd_plain,
        fused_attention_cuda,
        fused_attention_plain_stats,
        resident_attention_plain_stats,
    )
    from msau_tpu_torch.utils.kernel_inputs import attention_inputs

    cb, c = 8, 64
    fwd = {"cases": {}, "times": {}, "library_ms": None}
    bwd = {"cases": {}, "times": {}, "library_ms": None}
    # the blockwise oracle itself, and the kernel, against the materialised
    # [T, T] form at the flagship's T
    f, g, h = (torch.from_numpy(a).to(dev) for a in
               attention_inputs(np.random.default_rng(4096), 1, 4096, cb, c))
    full = resident_attention_plain_stats(f, g, h)[0]
    oracle = _scaled_err(fused_attention_plain_stats(f, g, h)[0], full)
    kernel = _scaled_err(fused_attention_cuda(f, g, h)[0], full)
    fwd["cases"]["T4096_vs_materialised"] = {
        "blockwise_plain_scaled_err": oracle, "kernel_scaled_err": kernel,
        "tol": FUSED_FWD_TOL}
    if max(oracle, kernel) > FUSED_FWD_TOL:
        raise AssertionError(f"fused attention against the materialised form "
                             f"at T = 4096: {fwd['cases']}")
    print(f"[phase 1] fused attention T4096 against the materialised form: "
          f"blockwise plain {oracle:.3e}, kernel {kernel:.3e}", flush=True)
    n, t, scale = FUSED_LARGE_LOGITS
    for key in ("float32", "bfloat16"):
        f, g, h, _ = _attention_tensors(dev, n, t, cb, c, getattr(torch, key),
                                        scale)
        got, again = fused_attention_cuda(f, g, h), fused_attention_cuda(f, g, h)
        torch.cuda.synchronize()
        name = f"N{n}_T{t}_{key}_scale{scale:g}"
        err = fwd["cases"][name] = _fused_fwd_errors(
            got, fused_attention_plain_stats(f, g, h), again)
        print(f"[phase 1] fused attention {name}: fwd scaled err "
              f"{err['scaled_err']:.3e}, m {err['m_max_abs_err']:.2e}, l rel "
              f"{err['l_max_rel_err']:.2e} (tol {FUSED_FWD_TOL}); same bits "
              "on a rerun", flush=True)
    for n, t, key in FUSED_CASES:
        dtype = getattr(torch, key)
        rng = np.random.default_rng(t)
        f, g, h = (torch.from_numpy(a).to(dev, dtype)
                   for a in attention_inputs(rng, n, t, cb, c))
        dout = torch.from_numpy(rng.normal(size=(n, t, c)).astype(
            np.float32)).to(dev)
        name = f"N{n}_T{t}_{key}"
        got = fused_attention_cuda(f, g, h)
        again = fused_attention_cuda(f, g, h)
        torch.cuda.synchronize()
        err = _fused_fwd_errors(got, fused_attention_plain_stats(f, g, h), again)
        exact = fused_attention_plain_stats(f.double(), g.double(), h.double())
        err["vs_f64_scaled_err"] = _scaled_err(got[0], exact[0])
        err["vs_f64_m_max_abs_err"] = _max_abs(got[1], exact[1])
        del exact, again
        fwd["cases"][name] = err
        out, m, l = got
        grads = fused_attention_bwd_cuda(f, g, h, m, l, dout)
        again = fused_attention_bwd_cuda(f, g, h, m, l, dout)
        scratch = fused_attention_bwd_cuda.scratch_bytes
        torch.cuda.synchronize()
        wgrads = fused_attention_bwd_plain(f, g, h, m, l, dout)
        tol = FUSED_BWD_TOL[key]
        berr = {"tol": tol, "bit_identical": all(
            torch.equal(a, b) for a, b in zip(grads, again)),
            "scratch_mib": scratch / 2**20}
        for gname, a, b in zip(("df", "dg", "dh"), grads, wgrads):
            berr[gname] = {"max_abs_err": _max_abs(a, b),
                           "scaled_err": _scaled_err(a, b)}
            if a.dtype != dtype or berr[gname]["scaled_err"] > tol:
                raise AssertionError(f"fused attention bwd {name} {gname}: "
                                     f"{berr[gname]} (tol {tol})")
        if not berr["bit_identical"]:
            raise AssertionError(f"fused attention bwd {name}: a second run "
                                 "gave other bits")
        bwd["cases"][name] = berr
        del got, out, grads, again, wgrads
        if t == FUSED_CASES[0][1]:
            fwd["times"][name] = {
                "ms": _cuda_ms(lambda: fused_attention_cuda(f, g, h), 10),
                "plain_ms": _cuda_ms(
                    lambda: fused_attention_plain_stats(f, g, h), 3),
                "bound": _attention_bound("fused_attention_fwd", n, t, cb, c,
                                          f.element_size())}
            # one page: the serve path's launch
            fwd["times"][f"N1_T{t}_{key}"] = {
                "ms": _cuda_ms(lambda: fused_attention_cuda(
                    f[:1], g[:1], h[:1]), 10),
                "bound": _attention_bound("fused_attention_fwd", 1, t, cb, c,
                                          f.element_size())}
            bwd["times"][name] = {
                "ms": _cuda_ms(lambda: fused_attention_bwd_cuda(
                    f, g, h, m, l, dout), 5),
                "plain_ms": _cuda_ms(lambda: fused_attention_bwd_plain(
                    f, g, h, m, l, dout), 3)}
        print(f"[phase 1] fused attention {name}: fwd scaled err "
              f"{err['scaled_err']:.3e} (float64 plain: "
              f"{err['vs_f64_scaled_err']:.3e}), m {err['m_max_abs_err']:.2e}, "
              f"l rel {err['l_max_rel_err']:.2e} (tol {FUSED_FWD_TOL}); bwd "
              + ", ".join(f"{k} {berr[k]['scaled_err']:.3e}"
                          for k in ("df", "dg", "dh"))
              + f" (tol {tol}); same bits on a rerun, scratch "
              f"{berr['scratch_mib']:.1f} MiB", flush=True)
        del f, g, h, dout, m, l
        torch.cuda.empty_cache()
    n, t, key = FUSED_CASES[0]
    main = f"N{n}_T{t}_{key}"
    fwd.update(max_abs_err=fwd["cases"][main]["max_abs_err"],
               ms=fwd["times"][main]["ms"],
               plain_ms=fwd["times"][main]["plain_ms"],
               bound=fwd["times"][main]["bound"],
               timed_on=f"{main} (config 5's train step)")
    bwd.update(max_abs_err=max(bwd["cases"][main][k]["max_abs_err"]
                               for k in ("df", "dg", "dh")),
               ms=bwd["times"][main]["ms"],
               plain_ms=bwd["times"][main]["plain_ms"],
               bound=_attention_bound("fused_attention_bwd", n, t, cb, c, 4),
               timed_on=f"{main} (config 5's train step)")
    print(f"[phase 1] fused attention times: fwd {json.dumps(fwd['times'])}; "
          f"bwd {json.dumps(bwd['times'])}", flush=True)
    return {"fused_attention_fwd": fwd, "fused_attention_bwd": bwd}


# kernel -> (its source, the TPU kernel it replaces) for the flat-layout ops
FLAT_KERNELS = {
    "to_nchw": ("msau_tpu_torch/csrc/layout.cu",
                "msau_tpu/ops/flatconv.py:2394"),
    "flat_maxpool2": ("msau_tpu_torch/csrc/pool.cu",
                      "msau_tpu/ops/flatconv.py:1862"),
    "flat_conv2d": ("msau_tpu_torch/csrc/flatconv.cu",
                    "msau_tpu/ops/flatconv.py:472"),
    "concat_conv1x1": ("msau_tpu_torch/csrc/flatconv.cu",
                       "msau_tpu/ops/flatconv.py:2083"),
    "flat_deconv2": ("msau_tpu_torch/csrc/deconv.cu",
                     "msau_tpu/ops/flatconv.py:1396"),
    "flat_res_block": ("msau_tpu_torch/csrc/flatres.cu",
                       "msau_tpu/ops/flatres.py:400"),
}
FLAT_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # of max(1, max |want|)
TIMED_BATCH = 16   # the flagship train step's batch: K1, K3, K2 and K6 timed there
# the backward kernels: source, the TPU kernels they replace, and the case
# of utils/flat_cases.FLAT_BWD_CASES the kernels line reports (f32, batch
# 16; where one torch call computes the same function, an instance that
# has one)
FLAT_BWD_KERNELS = {
    "flat_maxpool2_bwd": ("msau_tpu_torch/csrc/pool.cu",
                          "msau_tpu/ops/flatconv.py:1896", "8 ch 512^2"),
    "flat_conv_bwd": ("msau_tpu_torch/csrc/flatconv_bwd.cu",
                      "msau_tpu/ops/flatconv.py:600 (and :544)",
                      "merge_conv_0"),
    "flat_conv_dx": ("msau_tpu_torch/csrc/flatconv.cu",
                     "msau_tpu/ops/flatconv.py:472 (as _conv_body, :990)",
                     "merge_conv_0"),
    "concat_conv1x1_bwd": ("msau_tpu_torch/csrc/concat1x1_bwd.cu",
                           "msau_tpu/ops/flatconv.py:2108",
                           "couple 8 ch 512^2"),
    "flat_deconv2_dx": ("msau_tpu_torch/csrc/deconv_bwd.cu",
                        "msau_tpu/ops/flatconv.py:1451 (and :1223)",
                        "16->8 to 512^2"),
    "flat_deconv2_dw": ("msau_tpu_torch/csrc/deconv_bwd.cu",
                        "msau_tpu/ops/flatconv.py:1500", "16->8 to 512^2"),
    "flat_res_block_bwd": ("msau_tpu_torch/csrc/flatres_bwd.cu",
                           "msau_tpu/ops/flatres.py:458", "8 ch 512^2"),
}


def _flat_bound(case, n, itemsize):
    """(bound_ms, bound_by) of a flat op's case (forward or backward op) at
    batch n and operand size ``itemsize``; LRN and activation arithmetic is
    left out (a few operations per output against the conv's hundreds).
    The DTYPE_AWARE ops' bf16 operations (the deconv's with the 3x3 kernel;
    other odd K take the general kernels, FP32 pipes; the flat conv's where
    _conv_fast takes the shape; the residual block's) count at the
    tensor-core peak, the flat conv's f32 forward and dx where _conv_tc
    takes the shape at a sixth of it."""
    op, c, cb = case["op"], case["c"], case.get("cb", 0)
    h, w = case["h"], case["w"]
    hw, cin = h * w, c + cb
    cout = case.get("cout", c)
    k = case.get("k", 3 if "deconv" in op else 1)
    conv = 2 * n * hw * cout * cin * k * k
    if op == "to_nchw":
        return _bound(0, n * hw * c * (4 + itemsize))
    if op in ("flat_maxpool2", "flat_maxpool2_bwd"):
        q = -(-h // 2) * -(-w // 2)
        return _bound(0, n * c * ((2 * hw + q) if op.endswith("bwd")
                                  else (hw + q)) * itemsize)
    tensor = (op in ("flat_conv2d", "concat_conv1x1", "flat_conv_dx",
                     "flat_conv_bwd")
              and op in DTYPE_AWARE and itemsize == 2
              and _conv_fast(case, itemsize))
    peak = PEAK_BF16_FLOPS if tensor else PEAK_F32_FLOPS
    if itemsize == 4 and _conv_tc(case):
        peak = PEAK_F32_TC_FLOPS
    if op in ("flat_conv2d", "concat_conv1x1", "flat_conv_dx"):
        return _bound(conv, n * hw * (cin + cout) * itemsize, peak)
    if op == "concat_conv1x1_bwd":
        # z (where act is set), dx and dw; a, b and g read, da and db
        # written once
        return _bound(conv * (3 if case.get("act") else 2),
                      n * hw * (2 * cin + cout) * itemsize
                      + 4 * cout * (cin + 1),
                      PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS)
    if op == "flat_conv_bwd":
        epi = case.get("act") is not None or case.get("lrn")
        return _bound(conv * (2 if epi else 1),
                      n * hw * (cin + cout * (2 if epi else 1)) * itemsize
                      + 4 * cout * (cin * k * k + 1), peak)
    if op.startswith("flat_deconv2"):
        moved = n * (c * hw + cout * case["ho"] * case["wo"]) * itemsize
        tensor = op in DTYPE_AWARE and itemsize == 2 and k == 3
        return _bound(2 * n * hw * c * cout * k * k,
                      moved + (4 * c * cout * k * k if op.endswith("dw") else 0),
                      PEAK_BF16_FLOPS if tensor else PEAK_F32_FLOPS)
    peak = (PEAK_BF16_FLOPS if op in DTYPE_AWARE and itemsize == 2
            else PEAK_F32_FLOPS)
    if op == "flat_res_block":
        return _bound(2 * 2 * 9 * c * c * hw * n, 2 * n * c * hw * itemsize,
                      peak)
    if op == "flat_res_block_bwd":
        # two convs, their two transposes and two weight gradients
        return _bound(6 * 2 * 9 * c * c * hw * n,
                      3 * n * c * hw * itemsize + 8 * (9 * c * c + c), peak)
    raise ValueError(op)


def _flat_library(case, tensors):
    """One torch call computing a case's function on its tensors, or None
    (a fused epilogue, an LRN, a residual block, an asymmetric padding)."""
    import torch
    import torch.nn.functional as F

    op = case["op"]
    if op == "flat_conv2d":
        # the merge convs: no act, no LRN, an odd kernel (symmetric padding)
        a, b, w, bias = tensors
        k, d = w.shape[-1], case.get("d", 1)
        if case.get("act") or case.get("lrn") or k % 2 == 0:
            return None
        x = a if b is None else torch.cat([a, b], 1)
        bx = bias.to(x.dtype)
        return lambda: F.conv2d(x, w, bx, padding=(k - 1) * d // 2,
                                dilation=d)
    if op == "to_nchw":
        (x,) = tensors
        n, h, w, c = x.shape
        y = torch.empty((n, c, h, w), dtype=x.dtype, device=x.device)
        return lambda: y.copy_(x.permute(0, 3, 1, 2))
    if op == "flat_maxpool2":
        return lambda: F.max_pool2d(tensors[0], 2, 2, ceil_mode=True)
    if op == "flat_maxpool2_bwd":
        x, g = tensors
        _, idx = F.max_pool2d(x, 2, 2, ceil_mode=True, return_indices=True)
        return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
            g, x, [2, 2], [2, 2], [0, 0], [1, 1], True, idx)
    if op == "flat_deconv2":
        x, w, b = tensors
        h, wd = x.shape[-2:]
        op_hw = [case["ho"] - (2 * h - 1), case["wo"] - (2 * wd - 1)]
        return lambda: F.conv_transpose2d(x, w, b.to(x.dtype), stride=2,
                                          padding=w.shape[-1] // 2,
                                          output_padding=op_hw)
    if op in ("flat_deconv2_dx", "flat_deconv2_dw"):
        x, w, _, g = tensors
        h, wd = x.shape[-2:]
        op_hw = [case["ho"] - (2 * h - 1), case["wo"] - (2 * wd - 1)]
        mask = [op.endswith("dx"), op.endswith("dw"), False]
        p = w.shape[-1] // 2
        return lambda: torch.ops.aten.convolution_backward(
            g, x, w, None, [2, 2], [p, p], [1, 1], True, op_hw, 1, mask)
    if op in ("flat_conv_bwd", "flat_conv_dx"):
        a, b, w, _, g = tensors
        k, d = w.shape[-1], case.get("d", 1)
        if op == "flat_conv_bwd" and (case.get("act") or case.get("lrn")):
            return None
        if k % 2 == 0:
            return None
        x = a if b is None else torch.cat([a, b], 1)
        p = (k - 1) * d // 2
        mask = [op == "flat_conv_dx", op == "flat_conv_bwd",
                op == "flat_conv_bwd"]
        return lambda: torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]], [1, 1], [p, p], [d, d], False, [0, 0], 1,
            mask)
    return None


def check_flat_kernels(dev, ops=None):
    """Phase 1, the flat-layout kernels on every ``FLAT_CASES`` entry in
    f32 and bf16 -> {kernel: {max_abs_err, ms, plain_ms, cases, ...}}.
    ``ms`` / ``plain_ms``: f32, the op's first (largest) serve case;
    ``request_ms``: the sum over one request's instances, per dtype.
    ``ops``: only those kernels' cases, a probe quicker than the whole
    script (``cs.check_flat_kernels(torch.device('cuda', 0),
    ['flat_conv2d'])``)."""
    import numpy as np
    import torch

    from msau_tpu_torch.utils.flat_cases import (
        FLAT_CASES,
        flat_case_fns,
        flat_case_tensors,
    )

    out = {name: {"max_abs_err": 0.0, "cases": {}, "request_ms": {},
                  "request_plain_ms": {}, "batch16": {}}
           for name in FLAT_KERNELS if ops is None or name in ops}
    for case in FLAT_CASES:
        if case["op"] not in out:
            continue
        rec, report = out[case["op"]], []
        exact = case["op"] in ("to_nchw", "flat_maxpool2")
        for key, tol in FLAT_TOL.items():
            dtype = getattr(torch, key)
            tensors = flat_case_tensors(case, np.random.default_rng(11), dev,
                                        dtype)
            kernel, plain = flat_case_fns(case, tensors, dtype)
            got = kernel()
            torch.cuda.synchronize()
            want = plain()
            err, scaled = _max_abs(got, want), _scaled_err(got, want)
            if (got.dtype != dtype or got.shape != want.shape
                    or (err if exact else scaled > tol)):
                raise AssertionError(
                    f"{case['op']} {case['name']} {key}: max abs err {err} "
                    f"(scaled {scaled}, tol {0 if exact else tol})")
            entry = {"max_abs_err": err, "scaled_err": scaled,
                     "tol": 0 if exact else tol}
            msg = f"{key} err {err:.3e}"
            if case["per_request"]:
                entry["ms"] = _cuda_ms(kernel, 20)
                entry["plain_ms"] = _cuda_ms(plain, 10)
                if case["op"] in DTYPE_AWARE or case["op"] == "flat_maxpool2":
                    lib = _flat_library(case, tensors)
                    entry["library_ms"] = (None if lib is None
                                           else _cuda_ms(lib, 20))
                    entry["bound"] = _flat_bound(case, tensors[0].shape[0],
                                                 tensors[0].element_size())
                for field, ms in (("request_ms", entry["ms"]),
                                  ("request_plain_ms", entry["plain_ms"])):
                    rec[field][key] = (rec[field].get(key, 0.0)
                                       + case["per_request"] * ms)
                if "ms" not in rec and key == "float32":
                    rec["ms"], rec["plain_ms"] = entry["ms"], entry["plain_ms"]
                    lib = _flat_library(case, tensors)
                    rec["library_ms"] = None if lib is None else _cuda_ms(lib, 20)
                    rec["bound"] = _flat_bound(case, tensors[0].shape[0], 4)
                    rec["timed_on"] = f"{case['name']} float32 batch 1"
                msg += f", {entry['ms']:.4f} ms vs plain {entry['plain_ms']:.4f}"
            if key == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            rec["cases"][f"{case['name']} {key}"] = entry
            report.append(msg)
            del tensors, got, want
        print(f"[phase 1] {case['op']} {case['name']}: " + "; ".join(report),
              flush=True)
    for case in FLAT_CASES:
        if case["op"] not in ("flat_conv2d", "concat_conv1x1", "flat_res_block",
                              "flat_deconv2") \
                or not case["per_request"] or case["op"] not in out:
            continue
        # drawn once at batch 16 in f32 and cast for bf16 (the same values
        # a second draw from the seed gave)
        base = flat_case_tensors(case, np.random.default_rng(12), dev,
                                 torch.float32, n=TIMED_BATCH)
        for key in FLAT_TOL:
            dtype = getattr(torch, key)
            tensors = [None if t is None else t.to(dtype) if t.ndim > 1
                       else t for t in base]
            kernel, plain = flat_case_fns(case, tensors, dtype)
            lib = _flat_library(case, tensors)
            t = {"ms": _cuda_ms(kernel, 10), "plain_ms": _cuda_ms(plain, 5),
                 "library_ms": None if lib is None else _cuda_ms(lib, 10),
                 "bound": _flat_bound(case, TIMED_BATCH,
                                      tensors[0].element_size())}
            out[case["op"]]["batch16"][f"{case['name']} {key}"] = t
            print(f"[phase 1] {case['op']} {case['name']} {key} batch "
                  f"{TIMED_BATCH}: {t['ms']:.4f} ms vs plain "
                  f"{t['plain_ms']:.4f}, library {t['library_ms']}, bound "
                  f"{t['bound'][0]:.4f} ({t['bound'][1]})", flush=True)
            del tensors
    for name, rec in out.items():
        print(f"[phase 1] {name} per request ms: {json.dumps(rec['request_ms'])}"
              f" vs plain {json.dumps(rec['request_plain_ms'])}", flush=True)
    return out


def check_flat_bwd_kernels(dev, ops=None):
    """Phase 1, the flat-layout backward kernels on every FLAT_BWD_CASES
    entry in f32 and bf16, the train step's instances at batch 16, each
    run twice for equal bits -> {kernel: {max_abs_err, ms, plain_ms,
    library_ms, bound, cases, step_ms, ...}}; ``step_ms``: the sum of
    device times over one flagship train step's instances, per dtype.
    ``ops``: only those kernels' cases, a probe quicker than the whole
    script: ``python3 -c "import chip_smoke as cs, torch;
    cs.check_flat_bwd_kernels(torch.device('cuda', 0),
    ['concat_conv1x1_bwd'])"``."""
    import numpy as np
    import torch

    from msau_tpu_torch.utils.flat_cases import (
        FLAT_BWD_CASES,
        flat_bwd_case_fns,
        flat_bwd_case_tensors,
        flat_bwd_errors,
    )

    out = {name: {"max_abs_err": 0.0, "cases": {}, "step_ms": {},
                  "step_plain_ms": {}, "step_library_ms": {}}
           for name in FLAT_BWD_KERNELS if ops is None or name in ops}
    for case in FLAT_BWD_CASES:
        if case["op"] not in out:
            continue
        rec, report = out[case["op"]], []
        n = TIMED_BATCH if case["per_step"] else case["n"]
        # drawn once in f32 and cast for bf16: the numpy draws at batch 16
        # took most of the phase, and a second draw from the same seed gave
        # the same values
        base = flat_bwd_case_tensors(case, np.random.default_rng(13), dev,
                                     torch.float32, n=n)
        for key in FLAT_TOL:
            dtype = getattr(torch, key)
            tensors = [None if t is None else t.to(dtype) if t.ndim > 1
                       else t for t in base]
            kernel, plain = flat_bwd_case_fns(case, tensors)
            got = kernel()
            again = kernel()
            torch.cuda.synchronize()
            want = plain()
            errs = flat_bwd_errors(case, got, want, key)
            bits = all(torch.equal(a, b) for a, b in zip(got, again))
            abs_err = max(_max_abs(a, b) for a, b in zip(got, want))
            if not bits or any(e > tol for _, e, tol in errs):
                raise AssertionError(
                    f"{case['op']} {case['name']} {key}: errors {errs}, "
                    f"same bits on a second run: {bits}"
                    + _relu_flips(case, tensors, got, want))
            entry = {"n": n, "max_abs_err": abs_err, "bit_identical": True,
                     "errors": [{"kind": k, "scaled_err": e, "tol": t}
                                for k, e, t in errs]}
            msg = f"{key} n {n} err " + ", ".join(
                f"{k} {e:.2e}" for k, e, _ in errs)
            if case["per_step"]:
                entry["ms"], entry["launch_ms_range"] = _device_time(kernel, 20)
                entry["plain_ms"] = _cuda_ms(plain, 5)
                lib = _flat_library(case, tensors)
                entry["library_ms"] = None if lib is None else _cuda_ms(lib, 20)
                entry["bound"] = _flat_bound(case, n, tensors[0].element_size())
                if case["op"] == "concat_conv1x1_bwd":
                    from msau_tpu_torch.ops import flatconv
                    entry["split_ms"] = _cuda_ms(
                        lambda: flatconv.concat_conv1x1_bwd_split(
                            *tensors, act=case["act"]), 20)
                    msg += f"; split path {entry['split_ms']:.4f} ms"
                for field, ms in (("step_ms", entry["ms"]),
                                  ("step_plain_ms", entry["plain_ms"]),
                                  ("step_library_ms", entry["library_ms"])):
                    if ms is not None:
                        rec[field][key] = (rec[field].get(key, 0.0)
                                           + case["per_step"] * ms)
                if (key == "float32"
                        and case["name"] == FLAT_BWD_KERNELS[case["op"]][2]):
                    rec.update(ms=entry["ms"],
                               launch_ms_range=entry["launch_ms_range"],
                               plain_ms=entry["plain_ms"],
                               library_ms=entry["library_ms"],
                               bound=_flat_bound(case, n, 4),
                               timed_on=f"{case['name']} float32 batch {n}")
                    if "split_ms" in entry:
                        rec["split_ms"] = entry["split_ms"]
                lo, hi = entry["launch_ms_range"]
                msg += (f"; {entry['ms']:.4f} ms (one launch of its largest "
                        f"kernel {lo:.4f}-{hi:.4f}) vs plain "
                        f"{entry['plain_ms']:.4f}, library "
                        f"{entry['library_ms']}")
            if key == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"], abs_err)
            rec["cases"][f"{case['name']} {key}"] = entry
            report.append(msg)
            del tensors, got, again, want
            torch.cuda.empty_cache()
        del base
        print(f"[phase 1] {case['op']} {case['name']}: " + "; ".join(report),
              flush=True)
    for name, rec in out.items():
        print(f"[phase 1] {name} per train step ms: "
              f"{json.dumps(rec['step_ms'])} vs plain "
              f"{json.dumps(rec['step_plain_ms'])}, library "
              f"{json.dumps(rec['step_library_ms'])}", flush=True)
    return out


def _relu_flips(case, tensors, got, want):
    """For a relu case of the coupling conv or the residual block: the
    pixels whose first output (da, dx) misses 1e-3 of the plain version,
    and the largest of their least |z| (a relu mask flipped at z near 0
    shows as a tiny |z|); else ''.  z: the coupling's preactivation; the
    block's u and v (in float64), least over the 5 x 5 pixels around each
    (a flip moves dx up to two pixels away)."""
    import torch
    import torch.nn.functional as F

    if (case["op"] not in ("concat_conv1x1_bwd", "flat_res_block_bwd")
            or case["act"] != "relu"):
        return ""
    if case["op"] == "concat_conv1x1_bwd":
        a, b, w, bias, _ = tensors
        z = torch.einsum("oc,nchw->nohw", w.double()[:, :, 0, 0],
                         torch.cat([a, b], 1).double())
        z = (z + bias.double()[:, None, None]).abs().amin(1)
    else:
        x, w1, b1, w2, b2, _ = tensors
        xd = x.double()
        u = F.conv2d(F.relu(xd), w1.double(), b1.double(), padding=1)
        h1 = F.relu(u).to(x.dtype).double()
        v = F.conv2d(h1, w2.double(), b2.double(), padding=1) + xd
        z = torch.minimum(u.abs().amin(1), v.abs().amin(1))
        z = -F.max_pool2d(-z[:, None], 5, 1, 2)[:, 0]
    bad = ((got[0].double() - want[0].double()).abs().amax(1)
           > 1e-3 * max(1.0, float(want[0].abs().max())))
    name = "da" if case["op"] == "concat_conv1x1_bwd" else "dx"
    return (f"; {int(bad.sum())} pixels of {name} off, least |z| there at "
            f"most {float(z[bad].max()) if bad.any() else None}")


# the kernels that add a weight gradient's per-block partial rows
PARTIAL_SUM_KERNELS = ("sum_partials_kernel", "dw_sum_kernel")


def partial_sums(dev, iters=10):
    """The partial-row sums inside the weight-gradient kernels of one
    flagship fs=3 train step (f32, batch 16): device ms per call of the
    PARTIAL_SUM_KERNELS by backward case, and per step by op.  It reads the
    msau_tpu_torch it imports, so run from another checkout's root
    (``importlib`` on this file) it times that version on the same card."""
    import numpy as np
    import torch

    from msau_tpu_torch.utils.flat_cases import (
        FLAT_BWD_CASES,
        flat_bwd_case_fns,
        flat_bwd_case_tensors,
    )

    out = {"cases": {}, "step_ms": {}}
    for case in FLAT_BWD_CASES:
        if not case["per_step"] or case["op"] not in (
                "flat_conv_bwd", "concat_conv1x1_bwd", "flat_res_block_bwd",
                "flat_deconv2_dw"):
            continue
        tensors = flat_bwd_case_tensors(case, np.random.default_rng(13), dev,
                                        torch.float32, n=TIMED_BATCH)
        kernel, _ = flat_bwd_case_fns(case, tensors)
        for _ in range(2):
            kernel()
        got = None
        for _ in range(3):
            got = _profile_once(kernel, iters, PARTIAL_SUM_KERNELS)
            if got is not None:
                break
        ms = None if got is None else got[0]
        out["cases"][f"{case['op']} {case['name']}"] = ms
        if ms is not None:
            out["step_ms"][case["op"]] = (out["step_ms"].get(case["op"], 0.0)
                                          + case["per_step"] * ms)
        del tensors
    print(f"[phase 1] partial sums per train step ms (f32): "
          f"{json.dumps(out['step_ms'])}", flush=True)
    return out


def _from_hbm(make, tensors, dev):
    """A zero-argument call that runs ``make(copy)()`` on the next of enough
    copies of ``tensors`` that the calls between two uses of one copy read
    over twice the card's L2 cache: each timed call then reads its inputs
    from HBM, as the main path does, whatever their size."""
    import itertools

    import torch

    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    nbytes = sum(a.nbytes for a in tensors if a is not None)
    copies = [tensors] + [[None if a is None else a.clone() for a in tensors]
                          for _ in range(-(-2 * l2 // nbytes))]
    calls = itertools.cycle([make(copy) for copy in copies])
    return lambda: next(calls)()


def pool_bwd_times(dev, iters=20):
    """Device ms of the pool backward at the flagship fs=3 train step's
    three instances (batch 16), f32 and bf16, beside the library's
    ``max_pool2d_with_indices_backward`` and the bound, each call on inputs
    that are not in the L2 cache (``_from_hbm``), from whichever
    msau_tpu_torch this process imports: loaded with ``importlib`` from
    another checkout's root it times that version on the same card."""
    import numpy as np
    import torch

    from msau_tpu_torch.utils.flat_cases import (
        FLAT_BWD_CASES,
        flat_bwd_case_fns,
        flat_bwd_case_tensors,
    )

    out = {}
    for case in FLAT_BWD_CASES:
        if case["op"] != "flat_maxpool2_bwd" or not case["per_step"]:
            continue
        for key in FLAT_TOL:
            tensors = flat_bwd_case_tensors(case, np.random.default_rng(13),
                                            dev, getattr(torch, key),
                                            n=TIMED_BATCH)
            kernel = _from_hbm(
                lambda ts: flat_bwd_case_fns(case, ts)[0], tensors, dev)
            lib = _from_hbm(lambda ts: _flat_library(case, ts), tensors, dev)
            out[f"{case['name']} {key}"] = {
                "ms": _cuda_ms(kernel, iters), "library_ms": _cuda_ms(lib, iters),
                "bound_ms": _flat_bound(case, TIMED_BATCH,
                                        tensors[0].element_size())[0]}
            del tensors, kernel, lib
            torch.cuda.empty_cache()
    print(f"[pool bwd times] {json.dumps(out)}", flush=True)
    return out


def paint_ccl_instances(dev):
    """The serve path's paint and CCL instances on ``dev`` -> (paint
    {name: (boxes, values, h, w)}, CCL {name: class map}): the three box
    programs of the 512^2 bench page and of the page in the 1024 bucket, as
    ``KVModel`` pads them; ``ccl_map``'s blobby, noisy and maze maps at
    512^2 and 1024^2; and the class map the decoder labels on each page
    (``cls_map`` of ``decode_fields_device``, recorded during one f32
    predict of the flagship at flat_scales 3 and of config 5, with the
    serve phase's seeded random weights).  It runs on the package of
    either checkout of a parent-against-change call, so it takes the
    programs from ``KVModel._prepare_host``."""
    import numpy as np
    import torch

    import msau_tpu_torch.infer.decode as decode
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page
    from msau_tpu_torch.utils.kernel_inputs import ccl_map

    paint, ccl = {}, {}
    for side in (512, 1024):
        for kind in ("blobby", "noisy", "maze"):
            ccl[f"{kind} {side}^2"] = torch.from_numpy(
                ccl_map(kind, side, side, np.random.default_rng(5))).to(dev)
    pages = ((512, dict(FLAGSHIP, flat_scales=3), 5),
             (1024, CONFIG5, 10))
    for bucket, model, n_cols in pages:
        page = page_from_label_dict(make_page(
            np.random.default_rng(3), n_cols=n_cols, rows_per_col=2 * n_cols))
        kv = _bench_kv(model, "float32", dev, bucket, page)
        _, _, arrays, hb, wb = kv._prepare_host(page)
        for i, name in enumerate(("char", "line_id", "char_id")):
            paint[f"{name} {bucket}"] = tuple(
                torch.from_numpy(a).to(dev) for a in arrays[2 * i:2 * i + 2]
            ) + (hb, wb)
        seen, label = [], decode.connected_components_multiclass
        # [H, W], or [1, H, W] where the decoder has a page axis
        decode.connected_components_multiclass = (
            lambda cls: seen.append(cls.reshape(cls.shape[-2:]).cpu().numpy())
            or label(cls))
        try:
            kv.predict(page, return_maps=False)
        finally:
            decode.connected_components_multiclass = label
        ccl[f"decoder {bucket}"] = torch.from_numpy(seen[0]).to(dev)
        del kv
        torch.cuda.empty_cache()
    return paint, ccl


def _ms_by_kernel(fn, iters):
    """Device ms per call of ``fn`` by kernel (and memset), from one
    torch.profiler session after a warm-up call; {} when it recorded
    nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and evt.count:
            name = evt.key.replace(_OURS, "").split("(")[0]
            out[name] = getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0)
                                ) / 1e3 / iters
    return out


def paint_ccl_times(dev, plain=False, iters=50):
    """Device ms of the paint and CCL kernels at ``paint_ccl_instances``,
    beside their bounds (``paint_bound``, ``ccl_bound``), from whichever
    msau_tpu_torch this process imports: loaded with ``importlib`` from
    another checkout's root it times that version on the same card.  With
    ``plain``, each instance's kernel output is also held to its plain
    version's and to a rerun's, bit for bit, and at 512^2 the plain
    version is timed."""
    from msau_tpu_torch.ops.ccl import (
        connected_components_multiclass_cuda,
        connected_components_multiclass_plain,
    )
    from msau_tpu_torch.ops.paint import paint_boxes_cuda, paint_boxes_plain

    paint, ccl = paint_ccl_instances(dev)
    calls = {}
    for name, (b, v, h, w) in paint.items():
        calls[f"paint {name}"] = (
            lambda b=b, v=v, h=h, w=w: paint_boxes_cuda(b, v, h, w),
            lambda b=b, v=v, h=h, w=w: paint_boxes_plain(b, v, h, w),
            paint_bound(b.shape[0], h, w), h * w)
    for name, cls in ccl.items():
        calls[f"ccl {name}"] = (
            lambda cls=cls: connected_components_multiclass_cuda(cls),
            lambda cls=cls: connected_components_multiclass_plain(cls),
            ccl_bound(*cls.shape), cls.numel())
    out = {}
    for name, (kernel, ref, bound, pixels) in calls.items():
        rec = out[name] = {"ms": _cuda_ms(kernel, iters), "bound": bound,
                           "by_kernel": _ms_by_kernel(kernel, iters)}
        if plain:
            _same_bits_as_plain(name, kernel, ref)
            # the plain versions are timed at 512^2 only: at 1024^2 one
            # plain paint is 2 x 10^5 launches, and a profiler session that
            # large left every later session of the run empty
            if pixels <= 512 * 512:
                rec["plain_ms"] = _cuda_ms(ref, 1)
    print(f"[paint ccl times] {json.dumps(out)}", flush=True)
    return out


# kernel launches per request of the flagship's serve path at each
# flat_scales; every other kernel launches no time
SERVE_PER_REQUEST = {
    0: {"paint": 3, "resident_attention_fwd": 3, "ccl_multiclass": 1},
    3: {"paint": 3, "resident_attention_fwd": 3, "ccl_multiclass": 1,
        "flat_conv2d": 21, "flat_res_block": 18, "concat_conv1x1": 12,
        "flat_deconv2": 9, "flat_maxpool2": 9, "to_nchw": 1},
}
# bf16 flat_scales 3 probabilities against bf16 flat_scales 0: each bf16
# path rounds the same f32 function at other places, so their mean
# distance may be at most this many times the unfused path's own mean
# distance from f32
BF16_FLAT_FACTOR = 2.5


# config 5 of BASELINE.md (scripts/bench_configs.py: 1024^2, bf16, batch 2,
# remat, flat_scales 2): the flagship's widths; the deepest scale holds
# 128 x 128 = 16384 tokens, so "auto" takes the streaming attention
CONFIG5 = dict(img_channels=64, n_class=17, scale_space_num=4, res_depth=2,
               feat_root=8, num_blocks=3, final_act="softmax", remat=True,
               flat_scales=2, attention_impl="auto")
# kernel launches per request of config 5's serve path, read off
# models/msau.py at flat_scales 2: per stage 2 dil + 2 merge + 1 end convs,
# 4 residual blocks, 2 deconvs, 2 pools, and 4 couplings in stages 1 and 2
SERVE_PER_REQUEST_1024 = {
    "paint": 3, "fused_attention_fwd": 3, "ccl_multiclass": 1,
    "flat_conv2d": 15, "flat_res_block": 12, "concat_conv1x1": 8,
    "flat_deconv2": 6, "flat_maxpool2": 6, "to_nchw": 1}
# the card's f32 probabilities at 1024^2 against the CPU's plain versions
# on the same chargrid.  At 64x64 the bound is 1e-4 (below); this random
# model amplifies one-ulp differences at a few pixels, and over 17 M
# probabilities three runs read a largest error of 2.9e-4 to 3.6e-4 with a
# mean of 5.7e-8, and another CPU sums in another order (its f32 step lay
# 2.3x further from the exact one): the largest error is held to 2e-3 and
# the mean to 1e-6, which a fault in any kernel of the path exceeds
FORWARD_1024_TOL = 2e-3
FORWARD_1024_MEAN_TOL = 1e-6


def _bench_kv(model_kwargs, dtype, dev, bucket, page):
    """A KVModel of ``model_kwargs`` with the bench charset and seeded
    random weights (the same at every flat_scales and dtype), warmed up at
    ``bucket`` and on ``page``."""
    import torch

    from msau_tpu_torch.config import InferConfig, ModelConfig
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.synth import BENCH_CHARSET
    from msau_tpu_torch.infer.kv_model import KVModel

    kv = KVModel(model_config=ModelConfig(**model_kwargs, dtype=dtype),
                 infer_config=InferConfig(n_class=17), device=dev)
    kv.charset = Charset(chars=" $" + BENCH_CHARSET)
    assert kv.charset.n_token == 64
    kv.load(n_class=17, generator=torch.Generator().manual_seed(0))
    kv.warmup_bucket(bucket)
    kv.predict(page, return_maps=False)   # the page itself, unmeasured
    return kv


def _serve_requests(kv, page, n_req, per_request, label, total,
                    phase="phase 2"):
    """``n_req`` requests with the launch counters reset just before and
    read just after -> p50 ms of each predict stage; the launches per
    request are held to ``per_request`` and added into ``total``."""
    import numpy as np

    from msau_tpu_torch import ops

    rows = []
    ops.reset_launch_counts()
    for _ in range(n_req):
        t = {}
        kv.predict(page, return_maps=False, timings=t)
        rows.append(t)
    counts = ops.launch_counts()
    for name, n in counts.items():
        want = per_request.get(name, 0) * n_req
        if n != want:
            raise AssertionError(f"{label}: {name} launched {n} times in "
                                 f"{n_req} requests, want {want}")
        total[name] += n
    print(f"[{phase}] {label}: launches per request "
          f"{ {k: v / n_req for k, v in counts.items() if v} }", flush=True)
    return {k: float(np.median([r[k] for r in rows]))
            for k in ("prep", "device", "strings")}


def _decode_check(kv, page, hb, dev, label, phase="phase 2"):
    """One request with its maps: finite probabilities of the bucket's
    shape that sum to 1, and decode tables equal to the same pipeline's
    with the plain versions (CPU) on the same probabilities -> (check,
    probs [H, W, C] f32)."""
    import torch

    from msau_tpu_torch.data.rasterize import paint_boxes
    from msau_tpu_torch.infer.decode import decode_fields_device, pack_decode_out
    from msau_tpu_torch.ops.paint import paint_boxes_plain

    res, extras = kv.predict(page, return_maps=True)
    probs = extras["pred"]
    progs = extras["programs"]
    wb = hb
    assert probs.shape == (hb, wb, 17), probs.shape
    assert torch.isfinite(probs).all()
    assert torch.allclose(probs.sum(-1), torch.ones((), device=dev), atol=1e-4)
    num_lines = -(-max(len(extras["scaled_lines"]), 1) // 128) * 128
    planes = {}
    for name in ("line_id", "char_id"):
        prog = getattr(progs, name).padded(
            -(-max(len(getattr(progs, name).values), 1) // 512) * 512)
        b, v = torch.from_numpy(prog.boxes), torch.from_numpy(prog.values)
        b, v = b.to(dev), v.to(dev)
        on_card = paint_boxes(b, v, hb, wb)
        # the plain version, a select per box, takes 24 s per 1024^2 plane
        # on the CPU: it runs on the card and its plane goes to the CPU
        plain = paint_boxes_plain(b, v, hb, wb).cpu()
        assert torch.equal(on_card.cpu(), plain), name
        planes[name] = (on_card, plain)
    kw = dict(n_class=17, num_lines=num_lines, k=8,
              min_area=kv.cfg.min_component_area)
    mlc = kv._multiline_classes()
    card = decode_fields_device(probs, planes["line_id"][0],
                                planes["char_id"][0], mlc, **kw)
    host = decode_fields_device(probs.cpu(), planes["line_id"][1],
                                planes["char_id"][1], mlc, **kw)
    same = torch.equal(pack_decode_out(card).cpu(), pack_decode_out(host))
    assert torch.equal(card["chosen_class"].cpu(), host["chosen_class"])
    assert torch.equal(card["chosen_class"], extras["chosen_class"])
    if not same:
        raise AssertionError(f"{label}: decode tables differ from the "
                             "plain-version pipeline")
    check = {"decode_tables_equal_plain": True,
             "active_fields": int(card["active"].sum()),
             "n_results": len(res), "lines": len(extras["scaled_lines"])}
    print(f"[{phase}] {label}: decode tables equal the plain pipeline's; "
          f"{check['active_fields']} active classes", flush=True)
    return check, probs.float()


def _cpu_twin(kv):
    """The KVModel's network on the CPU with the same weights."""
    import torch

    from msau_tpu_torch.models.msau import build_model

    twin = build_model(kv.model_config, torch.Generator().manual_seed(0)).eval()
    twin.load_state_dict({k: v.cpu() for k, v in kv.model.state_dict().items()})
    return twin


def _page_chargrid(kv, page, side, dev):
    """The page's one-hot chargrid in its ``side`` bucket, [1, side, side,
    64] f32 on ``dev``, painted by the card from the KVModel's programs."""
    import torch

    from msau_tpu_torch.data.rasterize import paint_boxes, round_up

    _, extras = kv.predict(page, return_maps=False)
    prog = extras["programs"].char
    prog = prog.padded(round_up(max(len(prog.values), 1), 512))
    ids = paint_boxes(torch.from_numpy(prog.boxes).to(dev),
                      torch.from_numpy(prog.values).to(dev), side, side)
    tokens = torch.arange(64, dtype=torch.int32, device=dev)
    return (ids[..., None] == tokens).to(torch.float32)[None]


def serve_path(dev):
    """Phase 2, the flagship at 512^2 -> (launch counts, stage p50s by
    model, checks)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page

    base = dict(img_channels=64, n_class=17, scale_space_num=4, res_depth=2,
                feat_root=8, num_blocks=3, final_act="softmax")
    page = page_from_label_dict(
        make_page(np.random.default_rng(3), n_cols=5, rows_per_col=10))
    # the same seed draws the same weights at every flat_scales
    models = {(fs, dtype): _bench_kv(dict(base, flat_scales=fs), dtype, dev,
                                     512, page)
              for fs in SERVE_PER_REQUEST for dtype in ("float32", "bfloat16")}

    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    timings = {}
    for (fs, dtype), kv in models.items():
        timings[f"fs{fs}_{dtype}"] = _serve_requests(
            kv, page, 5, SERVE_PER_REQUEST[fs], f"fs={fs} {dtype}", total)
    for dtype in ("float32", "bfloat16"):
        print(f"[phase 2] {dtype} predict p50 ms: " + " | ".join(
            f"fs={fs} " + ", ".join(f"{k} {v:.3f}" for k, v in
                                    timings[f"fs{fs}_{dtype}"].items())
            for fs in SERVE_PER_REQUEST), flush=True)

    # ---- correctness of what comes out -----------------------------------
    checks, probs_of = {}, {}
    for (fs, dtype), kv in models.items():
        key = f"fs{fs}_{dtype}"
        checks[key], probs_of[(fs, dtype)] = _decode_check(kv, page, 512, dev,
                                                           key)

    # f32 at 512^2: flat_scales 3 against 0 (reported), and at 64x64 the
    # card's fs=0 and fs=3 forwards against each other and against the CPU
    p = probs_of
    err = _max_abs(p[(3, "float32")], p[(0, "float32")])
    checks["probs_f32_fs3_vs_fs0_512_max_abs_err"] = err
    print(f"[phase 2] f32 probs at 512^2, fs=3 vs fs=0: max abs err {err:.3e}",
          flush=True)
    ids = np.random.default_rng(1).integers(0, 64, (1, 64, 64))
    x = torch.from_numpy(np.eye(64, dtype=np.float32)[ids])
    small = {}
    for fs in SERVE_PER_REQUEST:
        kv = models[(fs, "float32")]
        cpu_model = _cpu_twin(kv)
        with torch.inference_mode():
            small[(fs, "card")] = kv.model(x.to(dev))[0].cpu()
            small[(fs, "cpu")] = cpu_model(x)[0]
    for name, a, b in (("fs0_card_vs_cpu", (0, "card"), (0, "cpu")),
                       ("fs3_card_vs_cpu", (3, "card"), (3, "cpu")),
                       ("fs3_vs_fs0_card", (3, "card"), (0, "card"))):
        err = _max_abs(small[a], small[b])
        if err > 1e-4:
            raise AssertionError(f"f32 forward at 64x64, {name}: max abs err "
                                 f"{err}")
        checks[f"forward_f32_64x64_{name}_max_abs_err"] = err
        print(f"[phase 2] f32 forward at 64x64, {name}: max abs err {err:.3e}",
              flush=True)
    # bf16 flat_scales 3 against the port's own bf16 flat_scales 0
    mean = lambda a, b: float((a - b).abs().mean())
    d_flat = mean(p[(3, "bfloat16")], p[(0, "bfloat16")])
    d_ref = mean(p[(0, "bfloat16")], p[(0, "float32")])
    bf = {"mean_abs_fs3_vs_fs0": d_flat,
          "max_abs_fs3_vs_fs0": _max_abs(p[(3, "bfloat16")], p[(0, "bfloat16")]),
          "mean_abs_fs0_bf16_vs_f32": d_ref,
          "mean_abs_fs3_bf16_vs_f32": mean(p[(3, "bfloat16")], p[(3, "float32")]),
          "tol": BF16_FLAT_FACTOR * d_ref}
    checks["probs_bf16_fs3_vs_fs0_512"] = bf
    print(f"[phase 2] bf16 probs at 512^2, fs=3 vs fs=0: {json.dumps(bf)}",
          flush=True)
    if not d_flat <= bf["tol"]:
        raise AssertionError(f"bf16 fs=3 vs fs=0 probs: mean abs {d_flat} > "
                             f"{bf['tol']}")
    return total, timings, checks


def serve_path_1024(dev):
    """Phase 2, config 5's model serving one page that lands in the 1024
    bucket (10 columns x 20 rows of fields: 2814 lines), f32 and bf16 ->
    (launch counts, stage p50s by dtype, checks)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page

    page = page_from_label_dict(
        make_page(np.random.default_rng(3), n_cols=10, rows_per_col=20))
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    timings, checks, models = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        kv = models[dtype] = _bench_kv(CONFIG5, dtype, dev, 1024, page)
        key = f"config5_{dtype}"
        timings[key] = _serve_requests(kv, page, 3, SERVE_PER_REQUEST_1024,
                                       f"config 5 {dtype} 1024^2", total)
        print(f"[phase 2] config 5 {dtype} 1024^2 predict p50 ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in timings[key].items()), flush=True)
        checks[key], _ = _decode_check(kv, page, 1024, dev, key)

    # the f32 forward on the page's 1024^2 chargrid: the card (flat kernels
    # at scales 0 and 1, cuDNN below, the streaming attention) against the
    # CPU's plain versions with the same weights
    kv = models["float32"]
    x = _page_chargrid(kv, page, 1024, dev)
    t0 = time.perf_counter()
    with torch.inference_mode():
        on_card = kv.model(x)[0].cpu()
        on_cpu = _cpu_twin(kv)(x.cpu())[0]
    err = _max_abs(on_card, on_cpu)
    mean_err = float((on_card - on_cpu).abs().mean())
    checks["forward_f32_1024_card_vs_cpu"] = {
        "max_abs_err": err, "tol": FORWARD_1024_TOL,
        "mean_abs_err": mean_err, "mean_tol": FORWARD_1024_MEAN_TOL,
        "seconds": time.perf_counter() - t0}
    print(f"[phase 2] config 5 f32 forward at 1024^2, card vs CPU: max abs "
          f"err {err:.3e} (tol {FORWARD_1024_TOL}), mean {mean_err:.3e} (tol "
          f"{FORWARD_1024_MEAN_TOL}), "
          f"{checks['forward_f32_1024_card_vs_cpu']['seconds']:.1f} s",
          flush=True)
    if not (err <= FORWARD_1024_TOL and mean_err <= FORWARD_1024_MEAN_TOL):
        raise AssertionError(f"config 5 f32 forward at 1024^2: card vs CPU "
                             f"max abs err {err}, mean {mean_err}")
    return total, timings, checks


def serve_busy(dev, requests=7):
    """The flagship at flat_scales 0 and 3 serving the 512^2 bench page and
    config 5 serving a page in the 1024 bucket, f32 and bf16, as
    ``serve_path`` and ``serve_path_1024`` serve them -> by model: p50 of
    each predict stage (host clock) over ``requests``, and device busy ms
    and kernels per request (torch.profiler over 3), from
    whichever msau_tpu_torch this process imports: loaded with
    ``importlib`` from another checkout's root it times that version on the
    same card."""
    import numpy as np
    import torch

    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page

    page = {n: page_from_label_dict(make_page(np.random.default_rng(3),
                                              n_cols=n, rows_per_col=2 * n))
            for n in (5, 10)}
    runs = [(f"fs{fs}_{dtype}", dict(FLAGSHIP, flat_scales=fs), dtype, 512,
             page[5]) for fs in (0, 3) for dtype in ("float32", "bfloat16")]
    runs += [(f"config5_{dtype}", CONFIG5, dtype, 1024, page[10])
             for dtype in ("float32", "bfloat16")]
    out = {}
    for name, kw, dtype, bucket, pg in runs:
        kv = _bench_kv(kw, dtype, dev, bucket, pg)
        rows = []
        for _ in range(requests):
            rows.append({})
            kv.predict(pg, return_maps=False, timings=rows[-1])
        prof = _profile_steps(lambda: kv.predict(pg, return_maps=False), 3)
        out[name] = {k: float(np.median([r[k] for r in rows]))
                     for k in ("prep", "device", "strings")}
        out[name].update(busy_ms=prof["busy_ms"], kernels=prof["kernels"])
        print(f"[serve busy] {name} {json.dumps(out[name])}", flush=True)
        del kv
        torch.cuda.empty_cache()
    return out


def _pages(specs):
    """Pages of ``make_page(rng seed, n_cols, rows_per_col)`` for each
    (seed, n_cols, rows_per_col)."""
    import numpy as np

    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page

    return [page_from_label_dict(make_page(np.random.default_rng(s),
                                           n_cols=c, rows_per_col=r))
            for s, c, r in specs]


def _record_decoder_maps(kv, pages):
    """The class maps the decoder labels in one ``predict_batch`` of
    ``pages`` -> [int32 class map stack of each group, on the card]."""
    import msau_tpu_torch.infer.decode as decode

    seen, label = [], decode.connected_components_multiclass
    decode.connected_components_multiclass = (
        lambda cls: seen.append(cls.clone()) or label(cls))
    try:
        kv.predict_batch(pages)
    finally:
        decode.connected_components_multiclass = label
    return seen


# phase 1's page-axis instances of the CCL: the decoder's class maps of
# eight pages of the 512 bucket (seeds 3-10; the first three too), the
# blobby / noisy / maze maps stacked at 512^2 (B 3, and B 8 drawing each
# kind in turn) and a ragged stack of three at 865 x 860
CCL_BATCH_PAGES = tuple((s, 5, 10) for s in range(3, 11))


def ccl_batch_instances(dev):
    """{name: [B, H, W] int32 class maps on ``dev``} of the CCL's page axis
    (``CCL_BATCH_PAGES``, ``ccl_map``)."""
    import numpy as np
    import torch

    from msau_tpu_torch.utils.kernel_inputs import ccl_map

    kv = _bench_kv(dict(FLAGSHIP, flat_scales=3), "float32", dev, 512,
                   _pages(CCL_BATCH_PAGES[:1])[0])
    (maps,) = _record_decoder_maps(kv, _pages(CCL_BATCH_PAGES))
    del kv
    torch.cuda.empty_cache()
    out = {"decoder B8 512^2": maps, "decoder B3 512^2": maps[:3].contiguous()}
    kinds = ("blobby", "noisy", "maze")
    for b, h, w in ((3, 512, 512), (8, 512, 512), (3, 865, 860)):
        rng = np.random.default_rng(5)
        out[f"stacked B{b} {h}x{w}"] = torch.from_numpy(np.stack(
            [ccl_map(kinds[i % 3], h, w, rng) for i in range(b)])).to(dev)
    return out


def check_ccl_batched(dev, iters=50):
    """Phase 1, the CCL's page axis: each ``ccl_batch_instances`` stack
    labelled in one call, held page by page to the plain version of that
    page alone and to the kernel's own [H, W] call, with the same bits on
    a rerun; each timed beside ``ccl_bound`` times B -> {name: {B, ms,
    bound}}."""
    import torch

    from msau_tpu_torch.ops.ccl import (
        connected_components_multiclass_cuda as ccl,
        connected_components_multiclass_plain,
    )

    out = {}
    for name, maps in ccl_batch_instances(dev).items():
        b, h, w = maps.shape
        got, again = ccl(maps), ccl(maps)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"ccl {name}: a rerun gives other bits")
        for i in range(b):
            if not torch.equal(got[i], ccl(maps[i].contiguous())):
                raise AssertionError(f"ccl {name}: page {i} differs from "
                                     "the kernel's [H, W] call")
            if not torch.equal(got[i],
                               connected_components_multiclass_plain(maps[i])):
                raise AssertionError(f"ccl {name}: page {i} differs from "
                                     "the plain version")
        ms, by = ccl_bound(h, w)
        out[name] = {"B": b, "ms": _cuda_ms(lambda: ccl(maps), iters),
                     "bound": (ms * b, by)}
    print(f"[phase 1] ccl page axis exact page by page, equal to B = 1 and "
          f"the same bits on a rerun: {json.dumps(out)}", flush=True)
    return out


# phase 2c's batch: six pages of the 512 bucket (seed 3 is phase 2's bench
# page) and two of the 1024 bucket, interleaved, so that the results come
# back in input order from two groups
SERVE_BATCH_PAGES = ((3, 5, 10), (4, 5, 10), (3, 10, 20), (5, 5, 10),
                     (6, 5, 10), (7, 5, 10), (4, 10, 20), (8, 5, 10))
SERVE_BATCH_GROUPS = {512: 6, 1024: 2}   # bucket side: pages
SERVE_BATCH_CALLS = 2
# the batched f32 probabilities against each page's predict.  The batch
# changes summation orders (cuDNN's algorithms, the attention's grid
# layout), and this random model amplifies one-ulp differences at a few
# pixels: a probe read, over the eight pages at fs 3 and 0, a largest
# difference of 3.3e-5 to 2.0e-3 (at most 484 of 17.8 M probabilities over
# 1e-4, on a 1024 page) with means of 3.3e-8 to 1.4e-7, while on the bench
# page the batched and the single forward lay equally far from the float64
# forward (largest 5.9e-5 and 4.5e-5 at fs 3, 8.9e-5 and 1.0e-4 at fs 0).
# So the mean is held to 1e-6 and the largest to 5e-3, which a page-axis
# fault (a page reading another's pixels) exceeds by orders of magnitude,
# and on the bench page the batched forward to the float64 one within
# twice the single forward's own distance (at least 1e-5)
BATCH_PROBS_TOL = 5e-3
BATCH_PROBS_MEAN_TOL = 1e-6


def _batch_launches(fs, groups):
    """Kernel launches of one ``predict_batch`` call: paint 3 a page; per
    group one CCL, three attention forwards (resident below 8192 tokens,
    streaming from there) and at flat_scales 3 the flat forward kernels of
    one request."""
    per = {"paint": 3 * sum(groups.values()),
           "ccl_multiclass": len(groups)}
    for side in groups:
        attn = ("fused_attention_fwd" if (side // 8) ** 2 >= 8192
                else "resident_attention_fwd")
        per[attn] = per.get(attn, 0) + 3
        for name, n in SERVE_PER_REQUEST[fs].items():
            if name not in ("paint", "ccl_multiclass",
                            "resident_attention_fwd"):
                per[name] = per.get(name, 0) + n
    return per


def _exact_probs(kv, x, index=0):
    """The float64 forward of the KVModel's network on the CPU (the plain
    versions, no f32 rounding) on one page's one-hot ``x`` [H, W, V]: its
    probabilities (``index`` 1: its logits)."""
    import dataclasses

    import torch

    from msau_tpu_torch.models.msau import build_model

    exact = build_model(dataclasses.replace(kv.model_config, dtype="float64"),
                        torch.Generator().manual_seed(0)).eval().double()
    exact.load_state_dict({k: v.cpu().double()
                           for k, v in kv.model.state_dict().items()})
    with torch.inference_mode():
        return exact(x[None].cpu().double())[index][0]


def serve_batch(dev):
    """Phase 2c: ``predict_batch`` of the flagship at flat_scales 3 and 0,
    f32 and bf16 (phase 2's seeded weights) on ``SERVE_BATCH_PAGES`` ->
    (launch counts, timings, checks).  Per model: launches per call
    (``_batch_launches``), each page's decode tables equal to the unbatched
    decoder's on that page's slice of the batched probabilities (which the
    pages' strings come from); in f32 the
    batched probabilities within BATCH_PROBS_TOL (mean BATCH_PROBS_MEAN_TOL)
    of each page's ``predict``, on the first page as near the float64
    forward as ``predict``'s (both on cuDNN's deterministic algorithms),
    and, where the argmax maps agree, the same
    results; host ms per page (p50 over SERVE_BATCH_CALLS calls) and
    device busy ms per page beside ``predict``'s (one request per page,
    host ms their mean)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.rasterize import round_up
    from msau_tpu_torch.infer.decode import pack_decode_out

    pages = _pages(SERVE_BATCH_PAGES)
    n = len(pages)
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    timings, checks = {}, {}
    for fs in (3, 0):
        for dtype in ("float32", "bfloat16"):
            key = f"batch_fs{fs}_{dtype}"
            kv = _bench_kv(dict(FLAGSHIP, flat_scales=fs), dtype, dev, 512,
                           pages[0])
            rast = [kv.rasterize(p) for p in pages]
            groups = {}
            for x, *_ in rast:
                groups[x.shape[0]] = groups.get(x.shape[0], 0) + 1
            if fs == 3 and dtype == "float32":
                print(f"[phase 2c] groups (bucket: pages) {groups}", flush=True)
            if groups != SERVE_BATCH_GROUPS:
                raise AssertionError(f"pages landed in buckets {groups}")
            want = _batch_launches(fs, groups)
            kv.predict_batch(pages)                 # warm-up
            walls = []
            ops.reset_launch_counts()
            for _ in range(SERVE_BATCH_CALLS):
                t0 = time.perf_counter()
                results = kv.predict_batch(pages)
                walls.append((time.perf_counter() - t0) * 1e3 / n)
            counts = ops.launch_counts()
            for name, got in counts.items():
                if got != want.get(name, 0) * SERVE_BATCH_CALLS:
                    raise AssertionError(
                        f"{key}: {name} launched {got} times in "
                        f"{SERVE_BATCH_CALLS} calls, want "
                        f"{want.get(name, 0)} a call")
                total[name] += got
            singles = []
            for p in pages:
                t0 = time.perf_counter()
                kv.predict(p, return_maps=False)
                singles.append((time.perf_counter() - t0) * 1e3)
            prof_b = _profile_steps(lambda: kv.predict_batch(pages), 1)
            prof_1 = _profile_steps(
                lambda: [kv.predict(p, return_maps=False) for p in pages], 1)
            timings[key] = {
                "batch_p50_ms_per_page": float(np.median(walls)),
                "predict_mean_ms_per_page": float(np.mean(singles)),
                "batch_busy_ms_per_page": prof_b["busy_ms"] / n,
                "predict_busy_ms_per_page": prof_1["busy_ms"] / n,
                "batch_kernels_per_page": prof_b["kernels"] / n,
                "predict_kernels_per_page": prof_1["kernels"] / n}
            print(f"[phase 2c] {key}: launches per call "
                  f"{ {k: v // SERVE_BATCH_CALLS for k, v in counts.items() if v} }"
                  f"; per page {json.dumps(timings[key])}", flush=True)

            # the checks run on cuDNN's deterministic algorithms: at fs 0
            # the default ones give other bits on every call, batched or
            # not, and page 0's distance from the float64 forward would
            # compare two random draws with predict's
            deterministic = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
            try:
                # each page's tables against the unbatched decoder on its slice
                check = {"tables_equal_unbatched": True}
                order = {}
                for i, (x, *_rest) in enumerate(rast):
                    order.setdefault(tuple(x.shape), []).append(i)
                probs_of = {}
                for shape, idx in order.items():
                    nl = round_up(max(max(len(rast[i][3]) for i in idx), 1),
                                  128)
                    packed, probs = kv.serve_group(
                        torch.stack([rast[i][0] for i in idx]),
                        torch.stack([rast[i][1] for i in idx]),
                        torch.stack([rast[i][2] for i in idx]), nl)
                    for j, i in enumerate(idx):
                        with torch.inference_mode():
                            one = pack_decode_out(kv._decode(
                                probs[j], rast[i][1], rast[i][2], nl))
                        if not torch.equal(one, packed[j]):
                            raise AssertionError(f"{key}: page {i}'s batched "
                                                 "tables differ from the "
                                                 "unbatched decoder's")
                        probs_of[i] = probs[j].float()
                        if not torch.isfinite(probs[j]).all():
                            raise AssertionError(f"{key}: non-finite probs")
                if dtype == "float32":
                    errs, means, same_results, argmax_equal = [], [], 0, 0
                    for i, p in enumerate(pages):
                        res, ex = kv.predict(p, return_maps=True)
                        errs.append(_max_abs(probs_of[i], ex["pred"]))
                        means.append(float((probs_of[i] - ex["pred"])
                                           .abs().mean()))
                        if i == 0:
                            exact = _exact_probs(kv, rast[0][0])
                            near = {
                                "batched": _max_abs(probs_of[0].cpu(), exact),
                                "predict": _max_abs(ex["pred"].cpu(), exact)}
                        if torch.equal(probs_of[i].argmax(-1),
                                       ex["pred"].argmax(-1)):
                            argmax_equal += 1
                            if res != results[i][0]:
                                raise AssertionError(
                                    f"{key}: page {i}: results differ from "
                                    "predict's")
                            same_results += 1
                    check.update(probs_max_abs_err=max(errs),
                                 tol=BATCH_PROBS_TOL,
                                 probs_mean_abs_err=max(means),
                                 mean_tol=BATCH_PROBS_MEAN_TOL,
                                 page0_max_abs_err_vs_float64=near,
                                 argmax_equal_pages=argmax_equal,
                                 results_equal_pages=same_results)
                    if not (max(errs) <= BATCH_PROBS_TOL
                            and max(means) <= BATCH_PROBS_MEAN_TOL
                            and near["batched"]
                            <= 2 * max(near["predict"], 1e-5)):
                        raise AssertionError(f"{key}: batched probs from "
                                             f"predict's: {json.dumps(check)}")
            finally:
                torch.backends.cudnn.deterministic = deterministic
            checks[key] = check
            print(f"[phase 2c] {key}: {json.dumps(check)}", flush=True)
            del kv, rast, probs_of
            torch.cuda.empty_cache()
    return total, timings, checks


def field_eval(dev):
    """Phase 2d: ``write_corpus`` (8 labelled test pages, rng 11) under the
    build directory, then ``run_test`` with the flagship at flat_scales 3,
    bf16 (seeded random weights: the F1 means nothing) -> (launch counts,
    check).  Checks: ``num_label`` per class equals the label files' own
    count (``read_json_gt``), the counters equal the sum of per-page
    ``predict(label_path=, eval_results=)``, the summary lies in [0, 1],
    and the launches per page are a request's (SERVE_PER_REQUEST)."""
    import os

    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.pages import load_label_json_page
    from msau_tpu_torch.data.synth import write_corpus
    from msau_tpu_torch.infer.evaluate import read_json_gt
    from msau_tpu_torch.ops import cuda_lib

    root = str(cuda_lib.BUILD_DIR.parent / "field_eval")
    _, tests, _ = write_corpus(root, 0, 8, np.random.default_rng(11))
    kv = _bench_kv(dict(FLAGSHIP, flat_scales=3), "bfloat16", dev, 256,
                   load_label_json_page(tests[0]))
    ops.reset_launch_counts()
    kv_results, eval_results, summary = kv.run_test(tests, label_dir=root)
    counts = ops.launch_counts()
    for name, got in counts.items():
        if got != SERVE_PER_REQUEST[3].get(name, 0) * len(tests):
            raise AssertionError(f"run_test: {name} launched {got} times "
                                 f"for {len(tests)} pages")
    labels = [0] * kv.n_class
    summed = [{"num_pred": 0, "num_correct": 0, "num_label": 0}
              for _ in range(kv.n_class)]
    for path in tests:
        for value_id in read_json_gt(path):
            if value_id < kv.n_class:
                labels[value_id] += 1
        one = [{"num_pred": 0, "num_correct": 0, "num_label": 0}
               for _ in range(kv.n_class)]
        kv.predict(path, label_path=os.path.join(
            root, os.path.basename(path)), eval_results=one)
        for a, b in zip(summed, one):
            for k in a:
                a[k] += b[k]
    if [c["num_label"] for c in eval_results] != labels:
        raise AssertionError(f"run_test num_label {eval_results} against "
                             f"the label files' {labels}")
    if eval_results != summed:
        raise AssertionError("run_test counters differ from the sum of "
                             "per-page predict counters")
    if not all(0.0 <= v <= 1.0 for v in summary.values()):
        raise AssertionError(f"run_test summary out of [0, 1]: {summary}")
    check = {"pages": len(tests), "results": len(kv_results),
             "counters": eval_results, "summary": summary}
    print(f"[phase 2d] run_test on {len(tests)} labelled pages (random "
          f"weights: the F1 means nothing): counters "
          f"{json.dumps(eval_results)}; summary {json.dumps(summary)}",
          flush=True)
    del kv
    torch.cuda.empty_cache()
    return counts, check


FLAGSHIP = dict(img_channels=64, n_class=17, scale_space_num=4, res_depth=2,
                feat_root=8, num_blocks=3, final_act="softmax", remat=False)
# kernel launches per flagship train step at each flat_scales, as read off
# the model; every other kernel launches no time.  The last stage's
# attention output feeds nothing, so autograd runs its forward but no
# backward; the entry conv of stage 0 reads the chargrid, which has no
# gradient, so it has no dx conv (20 dx, 21 stage-1: 9 LRN dil convs, 9
# merge, 3 end; the 12 couplings take their one-pass backward)
_ATTN_CE = {"resident_attention_fwd": 3, "resident_attention_bwd": 2,
            "masked_ce_fwd": 2, "masked_ce_bwd": 2}
PER_STEP = {
    3: {**_ATTN_CE, "to_nchw": 1, "flat_conv2d": 21, "flat_res_block": 18,
        "concat_conv1x1": 12, "flat_deconv2": 9, "flat_maxpool2": 9,
        "flat_conv_bwd": 21, "flat_conv_dx": 20, "concat_conv1x1_bwd": 12,
        "flat_res_block_bwd": 18,
        "flat_deconv2_dx": 9, "flat_deconv2_dw": 9, "flat_maxpool2_bwd": 9},
    0: dict(_ATTN_CE),
}
# the flagship step at flat_scales 3 on spatial_shards 4 H-shards in one
# process (phase 6a): each residual block runs as two flat convs, since
# the fused kernel would give act(b1) in the zero rows at the image's
# edge of an extended shard (36 more convs, stage-1 and dx backward each,
# and no fused block); the rest as at sp 1
PER_STEP_SP4 = {**PER_STEP[3], "flat_conv2d": 21 + 36, "flat_res_block": 0,
                "flat_conv_bwd": 21 + 36, "flat_conv_dx": 20 + 36,
                "flat_res_block_bwd": 0}
TRAIN_BATCH = (16, 512)  # images per step, side
TIMED_STEPS = {3: 10, 0: 5}
# config 5's step (CONFIG5 at batch 2, 1024^2), as read off models/msau.py
# at flat_scales 2 with remat: every kernel inside a stage runs its forward
# twice (torch.utils.checkpoint recomputes the stage in the backward), the
# three end convs, the entry layout and the loss once.  Forward per stage:
# 2 dil + 2 merge convs, 4 residual blocks, 2 deconvs, 2 pools, 4 couplings
# (stages 1 and 2), 1 streaming attention.  Backward: conv stage 1 for 6
# dil + 6 merge + 3 end convs; conv dx for all but stage 0's entry conv
# (14); the one-pass backward of the 8 couplings; the last stage's
# attention output feeds nothing, so 2 attention backwards
PER_STEP_CONFIG5 = {
    "fused_attention_fwd": 6, "fused_attention_bwd": 2,
    "masked_ce_fwd": 2, "masked_ce_bwd": 2, "to_nchw": 1,
    "flat_conv2d": 27, "flat_res_block": 24, "concat_conv1x1": 16,
    "flat_deconv2": 12, "flat_maxpool2": 12,
    "flat_conv_bwd": 15, "flat_conv_dx": 14, "concat_conv1x1_bwd": 8,
    "flat_res_block_bwd": 12,
    "flat_deconv2_dx": 6, "flat_deconv2_dw": 6, "flat_maxpool2_bwd": 6}
CONFIG5_BATCH = (2, 1024)
CONFIG5_TIMED = 5        # scripts/bench_configs.py times 5 steps
CHECK_BATCH = (2, 128)   # the card-vs-CPU step


# device kernels by family: the port's kernels by their CUDA function
# names as torch.profiler demangles them (templates in an anonymous
# namespace; the partial sums in namespace msau), then cuDNN / GEMM by the
# usual substrings of its kernel names; the rest are "other torch ops"
_OURS = "(anonymous namespace)::"
KERNEL_FAMILIES = (
    ("flat conv stage 1", (_OURS + "conv_bwd_kernel<",
                           _OURS + "conv_bwd_fast_kernel<")),
    ("flat conv fwd and dx", (_OURS + "conv_kernel<",
                              _OURS + "conv_fast_kernel<",
                              _OURS + "conv_lrn_wide_kernel<")),
    ("flat concat 1x1 bwd", (_OURS + "concat1x1_bwd",)),
    ("flat res block bwd", (_OURS + "res_block_bwd_kernel<",)),
    ("flat res block fwd", (_OURS + "res_block_kernel<",)),
    ("flat deconv dx / dw", (_OURS + "deconv2_dx", _OURS + "deconv2_dw_")),
    ("flat deconv fwd", (_OURS + "deconv2_f32_kernel<",
                         _OURS + "deconv2_bf16_kernel<",
                         _OURS + "deconv2_general_kernel<")),
    ("flat pool fwd / bwd, entry layout", (_OURS + "maxpool2_kernel<",
                                           _OURS + "maxpool2_bwd_kernel<",
                                           _OURS + "maxpool2_bwd_vec_kernel<",
                                           _OURS + "nhwc_to_nchw_kernel<")),
    ("weight-gradient partial sums", ("msau::sum_partials_kernel",)),
    ("attention fwd / bwd", (_OURS + "stats_kernel<", _OURS + "accum_kernel<",
                             _OURS + "rows_kernel<", "msau::attn::general::")),
    ("masked CE fwd / bwd, attention and CE partials",
     (_OURS + "fwd_kernel<", _OURS + "bwd_kernel<", _OURS + "combine_kernel<")),
    ("cuDNN / GEMM", ("cudnn", "xmma", "cutlass", "gemm", "conv2d", "wgrad",
                      "dgrad", "winograd", "implicit", "convolve")),
)


# host ops of torch.distributed's collectives, by a part of their name
COLLECTIVE_KEYS = ("nccl", "gloo", "c10d", "all_reduce", "allreduce",
                   "record_param_comms")


def _profile_steps(step, steps, host_ops=False):
    """torch.profiler over ``steps`` calls of ``step`` -> per step: wall ms
    (host clock, ending in a synchronize), device busy ms (the sum of kernel
    times; kernels on one stream do not overlap), busy share, kernel count,
    busy ms by KERNEL_FAMILIES (the rest: "other torch ops"), the top
    kernels, the top host ops by their own host time, the host ms of all
    profiled ops but the synchronizes, and of the collectives
    (COLLECTIVE_KEYS); with ``host_ops``, every host op's own ms and
    calls a step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    fams, names, host, calls, busy, count = {}, {}, {}, {}, 0.0, 0
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue   # a span (``utils.profiling.trace``) and its device twin
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host[evt.key] = evt.self_cpu_time_total
            calls[evt.key] = evt.count
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        busy += us
        count += evt.count
        names[evt.key] = names.get(evt.key, 0.0) + us
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(k in evt.key for k in keys)), "other torch ops")
        fams[fam] = fams.get(fam, 0.0) + us
    per = lambda us: us / 1e3 / steps
    top = sorted(names.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1])[:8]
    extra = ({"host_ops": {k: (per(v), calls[k] / steps)
                           for k, v in host.items()}} if host_ops else {})
    return {**extra, "wall_ms": wall, "busy_ms": per(busy),
            "busy_share": per(busy) / wall if wall else 0.0,
            "kernels": count / steps,
            "families_ms": {k: per(v) for k, v in
                            sorted(fams.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": {k[:120]: per(v) for k, v in top},
            "top_host_ops_ms": {k[:120]: per(v) for k, v in top_host},
            "host_ms": per(sum(v for k, v in host.items()
                               if "Synchronize" not in k)),
            "collectives_host_ms": per(sum(
                v for k, v in host.items()
                if any(c in k.lower() for c in COLLECTIVE_KEYS)))}


def _attention_bwd_memory(step, dev, kernel):
    """One more step with an attention backward's wrapper (``kernel``:
    "resident_attention_bwd" or "fused_attention_bwd") wrapped to read the
    allocator where it runs -> MiB: its df scratch and the most that was
    allocated during one of its launches, scratch included, to set beside
    the step's peak."""
    import torch

    from msau_tpu_torch.ops import attention

    attr = {"resident_attention_bwd": "resident_attention_bwd_cuda",
            "fused_attention_bwd": "fused_attention_bwd_cuda"}[kernel]
    real = getattr(attention, attr)
    live = []

    def probe(*args):
        out = real(*args)   # its scratch is freed when it returns
        live.append(torch.cuda.memory_allocated(dev) + probe.scratch_bytes)
        return out

    # the wrapper keeps its counts and scratch size on the module's name
    probe.launches, probe.scratch_bytes = real.launches, 0
    probe.general_launches = real.general_launches
    setattr(attention, attr, probe)
    try:
        step()
    finally:
        setattr(attention, attr, real)
        real.launches, real.scratch_bytes = probe.launches, probe.scratch_bytes
        real.general_launches = probe.general_launches
    return {"scratch_mib": real.scratch_bytes / 2**20,
            "allocated_during_mib": max(live) / 2**20, "launches": len(live)}


def _train_run(dev, label, model_kwargs, dtype, batch_hw, timed, per_step,
               total, batch=None, fall_after=None, phase="phase 3",
               profile_steps=3):
    """One model through Trainer at ``batch_hw``: 2 warm-up steps, ``timed``
    timed steps with the launch counters reset just before (held to
    ``per_step`` and added into ``total``), ``fall_after`` steps in all
    (default 20 when bf16, none when f32: the loss must fall), then a
    device profile of ``profile_steps`` more -> results.  ``batch``, numpy
    (x, y), replaces the bench's structured batch."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.train.trainer import Trainer

    (bs, hw), warm = batch_hw, 2
    x, y = batch if batch is not None else make_structured_batch(
        np.random.default_rng(0), bs, hw, 17, 64)
    if fall_after is None:
        fall_after = 20 if dtype == "bfloat16" else 0
    tcfg = TrainConfig(learning_rate=1e-4, lr_decay_staircase=False)
    tr = Trainer(ModelConfig(**model_kwargs, dtype=dtype), tcfg, device=dev)
    tr.init_state(x, seed=0)
    batch = tr.put_batch({"input": x, "label": y,
                          "valid": np.ones(y.shape, bool)})
    # the bench feeds the batch in the compute dtype (bench.py:88)
    batch["input"] = batch["input"].to(tr.model.compute_dtype)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = []
    t0 = time.perf_counter()
    for _ in range(warm):
        tr.state, metrics = tr.train_step(tr.state, batch)
        losses.append(float(metrics["loss"]))
    warm_s = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(timed):
        tr.state, metrics = tr.train_step(tr.state, batch)
    losses.append(float(metrics["loss"]))  # closes the timed window
    dt = (time.perf_counter() - t0) / timed
    counts = ops.launch_counts()
    for name, n in counts.items():
        if n != per_step.get(name, 0) * timed:
            raise AssertionError(
                f"{label} {dtype}: {name} launched {n} times in {timed} "
                f"steps, want {per_step.get(name, 0) * timed}")
        total[name] += n
    peak = torch.cuda.max_memory_allocated(dev)
    res = {"ms_per_step": dt * 1e3, "img_per_s": bs / dt,
           "peak_mem_gib": peak / 2**30, "warmup_s": warm_s,
           "timed_steps": timed, "first_loss": losses[0],
           "grad_norm": float(metrics["grad_norm"]),
           "launches_per_step": {k: v / timed for k, v in counts.items()
                                 if v}}
    if fall_after:
        for _ in range(fall_after - warm - timed):
            tr.state, metrics = tr.train_step(tr.state, batch)
        losses.append(float(metrics["loss"]))
        res[f"loss_after_{fall_after}"] = losses[-1]
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{label} {dtype} loss did not fall in "
                                 f"{fall_after} steps: {losses[0]} -> "
                                 f"{losses[-1]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label} {dtype}: non-finite loss {losses}")
    res["losses"] = losses

    def step():
        tr.state, _ = tr.train_step(tr.state, batch)

    res["profile"] = _profile_steps(step, profile_steps)
    kernel = ("fused_attention_bwd" if per_step.get("fused_attention_bwd")
              else "resident_attention_bwd")
    if per_step.get(kernel):
        mem = res["attention_bwd_memory"] = _attention_bwd_memory(step, dev,
                                                                  kernel)
        print(f"[{phase}] {label} {dtype}: the attention backward's scratch "
              f"{mem['scratch_mib']:.1f} MiB; {mem['allocated_during_mib']:.1f}"
              f" MiB allocated while it ran, the step's peak "
              f"{1024 * res['peak_mem_gib']:.1f} MiB", flush=True)
    print(f"[{phase}] {label} {dtype} bs {bs} {hw}^2: "
          f"{res['ms_per_step']:.2f} ms/step, {res['img_per_s']:.3f} "
          f"img/s, peak {res['peak_mem_gib']:.2f} GiB, loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches/step "
          f"{res['launches_per_step']}", flush=True)
    prof = res["profile"]
    print(f"[{phase}] {label} {dtype} profile ({profile_steps} steps): wall "
          f"{prof['wall_ms']:.2f} ms/step, device busy "
          f"{prof['busy_ms']:.2f} ms ({100 * prof['busy_share']:.1f} "
          f"%), {prof['kernels']:.0f} kernels/step; by family "
          + json.dumps({k: round(v, 3) for k, v in
                        prof["families_ms"].items()}), flush=True)
    del tr, batch, metrics
    torch.cuda.empty_cache()
    return res


def train_path(dev):
    """Phase 3: the flagship train step at TRAIN_BATCH at flat_scales 3 and
    0, then config 5's at CONFIG5_BATCH -> (launch counts, results by
    "fs{fs}_{dtype}" and "config5_{dtype}")."""
    from msau_tpu_torch import ops

    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    results = {}
    for fs in PER_STEP:
        for dtype in ("bfloat16", "float32"):
            results[f"fs{fs}_{dtype}"] = _train_run(
                dev, f"fs={fs}", dict(FLAGSHIP, flat_scales=fs), dtype,
                TRAIN_BATCH, TIMED_STEPS[fs], PER_STEP[fs], total)
    for dtype in ("bfloat16", "float32"):
        results[f"config5_{dtype}"] = _train_run(
            dev, "config 5", CONFIG5, dtype, CONFIG5_BATCH, CONFIG5_TIMED,
            PER_STEP_CONFIG5, total)
    return total, results


# An f32 step against the exact one (float64 on the CPU), in units of the
# per-tensor bound of _grad_ratios (see train_step_check); two f32 steps
# against each other at twice that
F32_VS_EXACT = 3.0
GRAD_NORM_VS_EXACT = 1e-3
# float64 at flat_scales 3 against float64 at 0: the same function, summed
# in other orders
F64_FACTOR = 1e-6


def _grad_ratios(got, want):
    """Each gradient's max abs error over (1e-3 of that tensor's largest
    |gradient| plus 1e-6 of the model's)."""
    scale = max(float(v.abs().max()) for v in want.values())
    return {name: _max_abs(got[name], w)
            / (1e-3 * float(w.abs().max()) + 1e-6 * scale)
            for name, w in want.items()}


def train_step_check(dev):
    """Phase 3, one step at CHECK_BATCH (T = 256 at the deepest scale) from
    the same weights, held to the exact step: the CPU's plain versions in
    float64 at flat_scales 0 and 3 (equal to F64_FACTOR of the bound: the
    flat plain versions compute the fs=0 function).  Read against it: the
    card's f32 steps at flat_scales 3 (the flat kernels) and 0 (cuDNN), and
    the CPU's f32 steps at both (no kernel at all).  Config 5's path at this
    size (flat_scales 2 with ``attention_impl="pallas"``, which forces the
    streaming attention and its backward at T = 256) is held the same way:
    its float64 step equals the fs=0 one to F64_FACTOR, and the card's f32
    step lies within F32_VS_EXACT of it.

    Bounds: loss rel 1e-5; each gradient within 1e-3 of that tensor's
    largest |gradient| plus 1e-6 of the model's, times a fixed factor; the
    card's fs=0 step against the CPU's f32 one at 1x (grad_norm rel 1e-4).
    This random model amplifies f32 rounding: with no kernel of the port in
    it, the CPU's f32 fs=0 step lies up to 1.53x that bound from the exact
    one (grad_norm rel 1.8e-4) on one x86 CPU, 0.67x on another.  So an f32
    step is held to the exact one at F32_VS_EXACT (about twice that
    reading; grad_norm rel GRAD_NORM_VS_EXACT), and the card's fs=3 step
    to its fs=0 step at twice that (each lies within F32_VS_EXACT of the
    exact step); a kernel fault moves a gradient by its own size, far
    above either."""
    import numpy as np
    import torch

    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.ops import flatconv
    from msau_tpu_torch.train.optimizer import global_norm
    from msau_tpu_torch.train.trainer import make_loss_and_grad

    x, y = make_structured_batch(np.random.default_rng(1), *CHECK_BATCH, 17, 64)
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(y),
             "valid": torch.ones(y.shape, dtype=torch.bool)}
    card = str(dev)

    def step(fs, where, dtype, impl="auto"):
        cfg = ModelConfig(**FLAGSHIP, flat_scales=fs, dtype=dtype,
                          attention_impl=impl)
        model = build_model(cfg, torch.Generator().manual_seed(0))
        model = model.to(where, getattr(torch, dtype))
        loss, _, grads = make_loss_and_grad(model)(
            {k: v.to(where) for k, v in batch.items()})
        return (float(loss), float(global_norm(list(grads.values()))),
                {k: v.cpu().double() for k, v in grads.items()})

    out = {run: step(*run) for run in (
        (0, "cpu", "float64"), (3, "cpu", "float64"), (0, "cpu", "float32"),
        (3, "cpu", "float32"), (0, card, "float32"), (3, card, "float32"),
        # config 5's path at this size: flat_scales 2 and the streaming
        # attention forced ("pallas": T = 256 here), exact and on the card
        (2, "cpu", "float64", "pallas"), (2, card, "float32", "pallas"))}
    # which kernel moves the card's fs=3 step: the same step with the
    # forward conv (K1) on its plain version, cuDNN and torch's pow
    kernel = flatconv.flat_conv2d_cuda
    flatconv.flat_conv2d_cuda = flatconv.flat_conv2d_plain
    try:
        out["plain conv forward"] = step(3, card, "float32")
    finally:
        flatconv.flat_conv2d_cuda = kernel
    exact = lambda fs: (fs, "cpu", "float64")
    checks = {}
    for name, a, b, factor, norm_tol, loss_tol in (
            ("fs3_vs_fs0_f64_cpu", exact(3), exact(0), F64_FACTOR, 1e-12,
             1e-12),
            ("fs2_streaming_vs_fs0_f64_cpu", (2, "cpu", "float64", "pallas"),
             exact(0), F64_FACTOR, 1e-12, 1e-12),
            ("fs2_streaming_card_vs_exact", (2, card, "float32", "pallas"),
             (2, "cpu", "float64", "pallas"), F32_VS_EXACT,
             GRAD_NORM_VS_EXACT, 1e-5),
            ("fs0_card_vs_cpu", (0, card, "float32"), (0, "cpu", "float32"),
             1.0, 1e-4, 1e-5),
            ("fs0_cpu_vs_exact", (0, "cpu", "float32"), exact(0), None,
             None, 1e-5),
            ("fs3_cpu_vs_exact", (3, "cpu", "float32"), exact(3), None,
             None, 1e-5),
            ("fs3_card_plain_conv_fwd_vs_exact", "plain conv forward",
             exact(3), None, None, 1e-5),
            ("fs0_card_vs_exact", (0, card, "float32"), exact(0),
             F32_VS_EXACT, GRAD_NORM_VS_EXACT, 1e-5),
            ("fs3_card_vs_exact", (3, card, "float32"), exact(3),
             F32_VS_EXACT, GRAD_NORM_VS_EXACT, 1e-5),
            ("fs3_vs_fs0_card", (3, card, "float32"), (0, card, "float32"),
             2 * F32_VS_EXACT, 2 * GRAD_NORM_VS_EXACT, 1e-5)):
        (l_a, n_a, g_a), (l_b, n_b, g_b) = out[a], out[b]
        ratios = _grad_ratios(g_a, g_b)
        worst_name = max(ratios, key=ratios.get)
        worst = ratios[worst_name]
        check = {"loss": l_a, "loss_ref": l_b,
                 "loss_rel_err": abs(l_a - l_b) / abs(l_b),
                 "grad_norm": n_a, "grad_norm_ref": n_b,
                 "grad_norm_rel_err": abs(n_a - n_b) / abs(n_b),
                 "loss_tol": loss_tol, "grad_norm_tol": norm_tol,
                 "bound_factor": factor,
                 "worst_grad_err_over_bound": worst, "worst_grad": worst_name,
                 "grad_err_over_bound": ratios}
        checks[name] = check
        print(f"[phase 3] step {CHECK_BATCH[1]}^2 bs {CHECK_BATCH[0]}, {name}: "
              f"loss rel err {check['loss_rel_err']:.3e}, grad_norm rel err "
              f"{check['grad_norm_rel_err']:.3e}, worst gradient at "
              f"{worst:.3e} of its bound ({worst_name}; allowed {factor})",
              flush=True)
    # factor None: a reading only (the CPU's f32 steps, with no kernel in
    # them, and the card's fs=3 step without K1's forward)
    failed = {name: c for name, c in checks.items()
              if c["loss_rel_err"] > c["loss_tol"] or (
                  c["bound_factor"] is not None
                  and (c["worst_grad_err_over_bound"] > c["bound_factor"]
                       or c["grad_norm_rel_err"] > c["grad_norm_tol"]))}
    if failed:
        raise AssertionError("train step checks failed: " + json.dumps(
            {name: {k: v for k, v in c.items() if k != "grad_err_over_bound"}
             for name, c in failed.items()}))
    return checks


# ---- phase 4: the model variants and entry A ------------------------------
# BASELINE config 4 (scripts/bench_configs.py:144-158): the box-convolution
# MSAU at 256^2, batch 4, remat; config 3 (:122-141): the flagship's widths
# on 832 input channels (a 768-wide text embedding beside the 64-channel
# chargrid) at 256^2, batch 8, remat.  Both feed rng(0) uniform inputs and
# random labels, as bench_configs.time_train does
CONFIG4 = dict(model="msau_box", img_channels=64, n_class=17,
               scale_space_num=4, res_depth=2, feat_root=8, num_blocks=3,
               remat=True, num_box_convs=2, num_box_per_channel=3,
               max_box_size=28)
CONFIG4_BATCH = (4, 256)
CONFIG3 = dict(img_channels=768 + 64, n_class=17, scale_space_num=4,
               res_depth=2, feat_root=8, num_blocks=3, remat=True)
CONFIG3_BATCH = (8, 256)
VARIANT_TIMED = {"config 4": 5, "config 3": 3}
# per step with remat: each stage's forward runs again in the backward, so
# 3 + 3 resident attention forwards (T = 32^2 at the deepest scale); the
# last stage's attention output feeds nothing, so 2 backwards
PER_STEP_REMAT = {"resident_attention_fwd": 6, "resident_attention_bwd": 2,
                  "masked_ce_fwd": 2, "masked_ce_bwd": 2}
# config 4 adds its box convolutions, 3 stages x 7 blocks (4 down, 3 up) x
# 2 a block, each forward twice (remat) and one backward, in both dtypes
PER_STEP_CONFIG4 = dict(PER_STEP_REMAT, box_conv_fwd=84, box_conv_bwd=42)
# and a request of config 4's serve path: the forward once
SERVE_PER_REQUEST_BOX = dict(SERVE_PER_REQUEST[0], box_conv_fwd=42)
# the bottleneck extras at the flagship's widths: the row / column LSTM in
# every stage, the CSPN in the last
LSTM_SPN = dict(FLAGSHIP, use_lstm=True, use_spn=True)
VARIANT_CHECK_BATCH = (2, 64)
# entry A: the FUNSD word grid of the fixture page (one page, 2 paint calls
# a page: the char ids and the labels, or the cell ids and the labels)
ENTRY_A_RUNS = (("chargrid", None), ("bert", None), ("bow", None),
                ("chargrid", "msau_box"))
ENTRY_A_BOX_KWARGS = dict(model="msau_box", final_act="softmax", featRoot=8,
                          scale_space_num=4, res_depth=2, n_class=5,
                          img_channels=1, num_box_convs=2,
                          num_box_per_channels=3, max_box_sizes=28)


def _uniform_batch(model_kwargs, bs, hw):
    """bench_configs.time_train's batch: rng(0) uniform inputs, then
    random labels."""
    import numpy as np

    rng = np.random.default_rng(0)
    x = rng.random((bs, hw, hw, model_kwargs["img_channels"])).astype(
        np.float32)
    y = rng.integers(0, model_kwargs["n_class"], (bs, hw, hw)).astype(np.int32)
    return x, y


def variants_train(dev):
    """Phase 4a and 4d: config 4 (BMSAU) in f32 and bf16 and config 3 in
    f32 through Trainer -> (launch counts, results).  Config 4's loss on
    its fixed batch must fall within 10 steps in both dtypes."""
    from msau_tpu_torch import ops

    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    results = {}
    runs = [("config 4", CONFIG4, CONFIG4_BATCH, dtype, 10, PER_STEP_CONFIG4)
            for dtype in ("float32", "bfloat16")]
    runs.append(("config 3", CONFIG3, CONFIG3_BATCH, "float32", 0,
                 PER_STEP_REMAT))
    for label, kwargs, batch_hw, dtype, fall, per_step in runs:
        results[f"{label.replace(' ', '')}_{dtype}"] = _train_run(
            dev, label, kwargs, dtype, batch_hw, VARIANT_TIMED[label],
            per_step, total, batch=_uniform_batch(kwargs, *batch_hw),
            fall_after=fall, phase="phase 4", profile_steps=1)
    return total, results


def variant_step_check(dev):
    """Phase 4b: one f32 step at VARIANT_CHECK_BATCH of the BMSAU (config
    4's widths) and of the flagship with use_lstm and use_spn, on the card
    and on the CPU, each held to the exact step (the CPU in float64) as
    train_step_check holds the flagship's: the card within F32_VS_EXACT of
    the bound (loss rel 1e-5, grad_norm rel GRAD_NORM_VS_EXACT), the card
    against the CPU's f32 step within twice that; the CPU's f32 step a
    reading."""
    import numpy as np
    import torch

    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.models.msau import build_model
    from msau_tpu_torch.train.optimizer import global_norm
    from msau_tpu_torch.train.trainer import make_loss_and_grad

    x, y = make_structured_batch(np.random.default_rng(1),
                                 *VARIANT_CHECK_BATCH, 17, 64)
    batch = {"input": torch.from_numpy(x), "label": torch.from_numpy(y),
             "valid": torch.ones(y.shape, dtype=torch.bool)}
    checks = {}
    for name, kwargs in (("bmsau", dict(CONFIG4, final_act="softmax")),
                         ("lstm_spn", LSTM_SPN)):
        def step(where, dtype):
            model = build_model(ModelConfig(**kwargs, dtype=dtype),
                                torch.Generator().manual_seed(0))
            model = model.to(where, getattr(torch, dtype))
            loss, _, grads = make_loss_and_grad(model)(
                {k: v.to(where) for k, v in batch.items()})
            return (float(loss), float(global_norm(list(grads.values()))),
                    {k: v.cpu().double() for k, v in grads.items()})

        out = {"exact": step("cpu", "float64"), "cpu": step("cpu", "float32"),
               "card": step(dev, "float32")}
        for pair, factor, norm_tol in (
                (("card", "exact"), F32_VS_EXACT, GRAD_NORM_VS_EXACT),
                (("cpu", "exact"), None, None),
                (("card", "cpu"), 2 * F32_VS_EXACT, 2 * GRAD_NORM_VS_EXACT)):
            (l_a, n_a, g_a), (l_b, n_b, g_b) = out[pair[0]], out[pair[1]]
            ratios = _grad_ratios(g_a, g_b)
            worst_name = max(ratios, key=ratios.get)
            c = {"loss": l_a, "loss_ref": l_b,
                 "loss_rel_err": abs(l_a - l_b) / abs(l_b),
                 "grad_norm_rel_err": abs(n_a - n_b) / abs(n_b),
                 "worst_grad_err_over_bound": ratios[worst_name],
                 "worst_grad": worst_name, "bound_factor": factor}
            key = f"{name}_{pair[0]}_vs_{pair[1]}"
            checks[key] = c
            print(f"[phase 4] step {VARIANT_CHECK_BATCH[1]}^2 bs "
                  f"{VARIANT_CHECK_BATCH[0]}, {key}: loss rel err "
                  f"{c['loss_rel_err']:.3e}, grad_norm rel err "
                  f"{c['grad_norm_rel_err']:.3e}, worst gradient at "
                  f"{ratios[worst_name]:.3e} of its bound ({worst_name}; "
                  f"allowed {factor})", flush=True)
            if c["loss_rel_err"] > 1e-5 or (factor is not None and (
                    ratios[worst_name] > factor
                    or c["grad_norm_rel_err"] > norm_tol)):
                raise AssertionError(f"{key}: {json.dumps(c)}")
    return checks


def variant_serve(dev):
    """Phase 4c: KVModel.predict of the BMSAU (config 4's widths, seeded
    random weights) on the 512^2 bench page, f32: 3 requests with the
    launch counts held to a request's (paint 3, resident attention 3, CCL
    1, box filter forward 42), the decode tables equal to the plain-version pipeline's -> (launch
    counts, stage p50s, check)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page

    page = page_from_label_dict(
        make_page(np.random.default_rng(3), n_cols=5, rows_per_col=10))
    kv = _bench_kv(dict(CONFIG4, final_act="softmax"), "float32", dev, 512,
                   page)
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    timings = _serve_requests(kv, page, 3, SERVE_PER_REQUEST_BOX,
                              "BMSAU f32", total, phase="phase 4")
    print(f"[phase 4] BMSAU f32 predict p50 ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in timings.items()), flush=True)
    check, _ = _decode_check(kv, page, 512, dev, "bmsau_f32", phase="phase 4")
    del kv
    torch.cuda.empty_cache()
    return total, timings, check


def entry_a(dev):
    """Phase 4e: preprocess_funsd of the FUNSD fixture, then train_funsd
    --device cuda --epochs 2 with each --features and with a
    model_kwargs.json naming msau_box, each run with the launch counters
    reset just before and read just after (paint: 2 a page) -> (launch
    counts, seconds by run)."""
    import os
    import shutil

    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.ops import cuda_lib
    from msau_tpu_torch.tools import preprocess_funsd, train_funsd

    if dev.type != "cuda":
        raise ValueError(f"entry A runs on the card, not {dev}")
    root = cuda_lib.BUILD_DIR.parent / "entry_a"
    shutil.rmtree(root, ignore_errors=True)
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tests", "fixtures")
    pp = str(root / "pp")
    preprocess_funsd.main(["--train_dir", fixtures, "--out_dir", pp])
    box_kwargs = root / "model_kwargs_box.json"
    box_kwargs.write_text(json.dumps(ENTRY_A_BOX_KWARGS))
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    seconds = {}
    for features, model in ENTRY_A_RUNS:
        key = features if model is None else f"{features}_{model}"
        argv = ["--data_dir", pp, "--ckptdir", str(root / key), "--epochs",
                "2", "--train_ratio", "1.0", "--features", features,
                "--checkpoint_every", "1", "--device", "cuda"]
        if model is not None:
            argv += ["--model_kwargs_path", str(box_kwargs)]
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        train_funsd.main(argv)
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts["paint"] != 2:
            raise AssertionError(f"entry A {key}: paint launched "
                                 f"{counts['paint']} times for one page")
        ckpts = sorted(p.name for p in (root / key).glob("funsd_msau_*/*"))
        if ckpts != ["0", "1", "2"]:
            raise AssertionError(f"entry A {key}: checkpoints {ckpts}")
        for name, n in counts.items():
            total[name] += n
        print(f"[phase 4] entry A {key}: {seconds[key]:.1f} s, launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return total, seconds


# ---- phase 5: entry B ------------------------------------------------------
# (a) the training input on the card against the CPU: the 512^2 bench page
# with affine + elastic + rotation, and a non-square page (256 x 512) with
# rotate_mod90, each two examples from one augmentation stream
ENTRY_B_PARITY = (("affine_elastic_rotate", dict(n_cols=5, rows_per_col=10),
                   dict(affine=True, elastic=True, rotate=True)),
                  ("rotate_mod90", dict(n_cols=5, rows_per_col=4),
                   dict(rotate_mod90=True)))
ENTRY_B_NEAR = 1e-6       # the CPU tests' near-threshold window
ENTRY_B_PROFILED = 4      # examples in 5a's trace of _assemble
# (b) write_corpus (rng 5) of 24 bench-sized pages, random_split 0.75, then
# train_generic at the flagship's widths
ENTRY_B_PAGES = 24
ENTRY_B_ARGS = ["--n_classes", "17", "--feat_root", "8",
                "--scale_space_num", "4", "--res_depth", "2",
                "--flat_scales", "3", "--affine", "--elastic", "--rotate",
                "--per_device_batch", "2", "--epochs", "2",
                "--batch_steps_per_epoch", "6", "--device", "cuda"]
ENTRY_B_STEPS = 12        # epochs x batch_steps_per_epoch
# per entry-B step at flat_scales 3: phase 3's flat kernels, the attention
# by the step's bucket, no masked CE (entry B trains with unet_loss)
_FLAT3 = {k: v for k, v in PER_STEP[3].items()
          if not k.startswith(("resident_attention", "masked_ce"))}


def _attention_kind(h, w, scales=4):
    """The deepest scale's attention op at an h x w input ("auto")."""
    from msau_tpu_torch.models.attention import STREAMING_MIN_TOKENS

    d = 2 ** (scales - 1)
    return ("fused_attention" if (h // d) * (w // d) >= STREAMING_MIN_TOKENS
            else "resident_attention")


def _entry_b_per_step(h, w):
    kind = _attention_kind(h, w)
    return {**_FLAT3, f"{kind}_fwd": 3, f"{kind}_bwd": 2}


def entry_b_parity(dev):
    """Phase 5a: ChargridProvider._assemble (paint x4, the one-hot, the
    warps) on the card against the same on the CPU, same programs and
    augmentation seed: the id planes exact; the binarised planes, labels
    and valid exact except where the CPU's value before the threshold lies
    within ENTRY_B_NEAR of it (counted); then one torch.profiler trace of
    the card's _assemble with the elastic warp -> checks."""
    import copy

    import numpy as np

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import DataConfig
    from msau_tpu_torch.data import augment, pipeline
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.rasterize import build_chargrid_programs
    from msau_tpu_torch.data.synth import BENCH_CHARSET, make_page

    cs = Charset(chars="◫⎅" + BENCH_CHARSET)
    checks = {}
    for name, page_kw, flags in ENTRY_B_PARITY:
        page = page_from_label_dict(make_page(np.random.default_rng(3),
                                              **page_kw))
        progs = build_chargrid_programs(page, cs, scale_min=3.0,
                                        scale_max=3.0,
                                        label_style="underline")
        cfg = DataConfig(n_classes=17, **flags)
        out = {}
        for where in ("card", "cpu"):
            prov = pipeline.ChargridProvider(
                None, None, cs, cfg, device=dev if where == "card" else "cpu")
            prov._aug_rng = np.random.default_rng(20260816)
            soft, real = [], pipeline.augment_example

            def recording(inp, label, valid, n_classes, rng, **kw):
                s, _ = augment.warp_example(inp, label, valid, n_classes,
                                            copy.deepcopy(rng), **kw)
                soft.append(s.numpy())
                return real(inp, label, valid, n_classes, rng, **kw)

            if where == "cpu":
                pipeline.augment_example = recording
            ops.reset_launch_counts()
            try:
                out[where] = [prov._assemble(progs) for _ in range(2)]
            finally:
                pipeline.augment_example = real
            paints = ops.launch_counts()["paint"]
            if where == "card" and paints != 8:
                raise AssertionError(f"entry B parity {name}: paint "
                                     f"launched {paints} times for 2 "
                                     "examples")
            out[where + "_soft"] = soft
        excused = 0
        for card, cpu, soft in zip(out["card"], out["cpu"], out["cpu_soft"]):
            n_soft = cpu["input"].shape[-1] - 2
            if not np.array_equal(card["input"][..., n_soft:],
                                  cpu["input"][..., n_soft:]):
                raise AssertionError(f"entry B parity {name}: id planes")
            near_tok = np.abs(soft[..., :n_soft] - 0.25) <= ENTRY_B_NEAR
            near_lab = (np.abs(soft[..., n_soft:-1] - 0.25)
                        <= ENTRY_B_NEAR).any(-1)
            near_val = np.abs(soft[..., -1] - 0.5) <= ENTRY_B_NEAR
            for key, plane, near in (
                    ("input", np.s_[..., :n_soft], near_tok),
                    ("label", np.s_[...], near_lab),
                    ("valid", np.s_[...], near_val)):
                a, b = card[key][0][plane], cpu[key][0][plane]
                if a.shape != b.shape or not np.array_equal(a[~near],
                                                            b[~near]):
                    raise AssertionError(f"entry B parity {name}: {key} "
                                         "differs outside the near-"
                                         "threshold pixels")
            excused += int(near_tok.sum() + near_lab.sum() + near_val.sum())
        checks[name] = {"shape": list(out["card"][0]["input"].shape),
                        "excused": excused}
        print(f"[phase 5] entry B parity {name}: card equals the CPU on "
              f"{checks[name]['shape']} (2 examples), {excused} "
              f"near-threshold values excused; paint 4 an example",
              flush=True)
        if flags.get("elastic"):
            # where the consumer's time goes: one torch.profiler trace of
            # ENTRY_B_PROFILED examples (upload, paint x4, warps, fetch)
            prov = pipeline.ChargridProvider(None, None, cs, cfg, device=dev)
            prov._aug_rng = np.random.default_rng(20260816)
            prof = _profile_steps(lambda: prov._assemble(progs),
                                  ENTRY_B_PROFILED)
            prof["assemble_ms"] = [t["assemble_ms"] for t in prov.timings]
            prof["fetch_ms"] = [t["fetch_ms"] for t in prov.timings]
            checks[name]["profile"] = prof
            print(f"[phase 5] _assemble {name} by torch.profiler, "
                  f"{ENTRY_B_PROFILED} examples: wall {prof['wall_ms']:.2f} "
                  f"ms an example, device busy {prof['busy_ms']:.2f} ms "
                  f"({100 * prof['busy_share']:.1f} %), "
                  f"{prof['kernels']:.0f} kernels; top "
                  f"{json.dumps(prof['top_kernels_ms'])}; top host ops "
                  f"{json.dumps(prof['top_host_ops_ms'])}", flush=True)
    return checks


def entry_b(dev):
    """Phase 5b and 5c: write_corpus (rng 5) of ENTRY_B_PAGES bench-sized
    pages under build/, random_split 0.75, train_generic through its
    library call with fit(log_dir=), each step and each pull checked
    (finite loss, launches by the step's bucket, paint 4 an example); then
    run_kv_test --device cuda on the val pages with the last checkpoint,
    and KVModel.run_test at flat_scales 3, each page served entry B's
    input -> (launch counts, results)."""
    import dataclasses
    import os
    import shutil
    import statistics

    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pages import load_label_json_page
    from msau_tpu_torch.data.synth import write_corpus
    from msau_tpu_torch.infer.kv_model import KVModel, prepare_host
    from msau_tpu_torch.ops import cuda_lib
    from msau_tpu_torch.tools import random_split, run_kv_test, train_generic

    if dev.type != "cuda":
        raise ValueError(f"entry B runs on the card, not {dev}")
    root = cuda_lib.BUILD_DIR.parent / "entry_b"
    shutil.rmtree(root, ignore_errors=True)
    _, _, cs_path = write_corpus(str(root / "all"), ENTRY_B_PAGES, 0,
                                 np.random.default_rng(5), n_cols=5,
                                 rows_per_col=10)
    train_names, val_names = random_split.random_split(str(root / "all"),
                                                       0.75, seed=5)
    for split, names in (("train", train_names), ("val", val_names)):
        os.makedirs(root / split)
        for n in names:
            shutil.copy(root / "all" / n, root / split / n)
    args = train_generic.build_parser().parse_args(
        ["--train_dir", str(root / "train"), "--val_dir", str(root / "val"),
         "--charset", cs_path, "--output_path", str(root / "out")]
        + ENTRY_B_ARGS)

    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    steps, pulls = [], []

    def instrument(trainer, chargrid, provider):
        real_step, real_next = trainer.train_step, chargrid.next_data

        def step(state, batch):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = real_step(state, batch)
            loss = float(metrics["loss"])
            ms = (time.perf_counter() - t0) * 1e3
            after = ops.launch_counts()
            n, h, w, _ = batch["input"].shape
            got = {k: after[k] - before[k] for k in after}
            want = _entry_b_per_step(h, w)
            for k, v in got.items():
                if v != want.get(k, 0):
                    raise AssertionError(f"entry B step {len(steps)} at "
                                         f"{n} x {h} x {w}: {k} launched "
                                         f"{v} times, want {want.get(k, 0)}")
            if not np.isfinite(loss):
                raise AssertionError(f"entry B step {len(steps)}: loss {loss}")
            steps.append({"shape": [n, h, w], "loss": loss, "ms": ms})
            return state, metrics

        def next_data(split="train"):
            before = ops.launch_counts()["paint"]
            item = real_next(split)
            paints = ops.launch_counts()["paint"] - before
            if item is not None and paints != 4:
                raise AssertionError(f"entry B: paint launched {paints} "
                                     f"times for one {split} example")
            pulls.append(split)
            return item

        trainer.train_step, chargrid.next_data = step, next_data
        instrument.chargrid = chargrid

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    trainer, history = train_generic.train(args, log_dir=str(root / "logs"),
                                           setup=instrument)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    for k in total:
        total[k] += counts[k]
    if len(steps) != ENTRY_B_STEPS:
        raise AssertionError(f"entry B ran {len(steps)} steps, want "
                             f"{ENTRY_B_STEPS}")
    if counts["masked_ce_fwd"] or counts["masked_ce_bwd"]:
        raise AssertionError("entry B launched the masked CE")
    ckpts = sorted((p for p in (root / "out").glob("model*")),
                   key=lambda p: int(p.name[5:]))
    if not ckpts or not (ckpts[-1] / "train_state.pt").exists():
        raise AssertionError(f"entry B checkpoints: {ckpts}")
    rows = [json.loads(l) for l in
            (root / "logs" / "metrics.jsonl").read_text().splitlines()]
    if [sorted(r) for r in rows] != [
            ["epoch", "step", "train/accuracy", "train/loss"],
            ["step", "val/accuracy", "val/loss"]] * 2:
        raise AssertionError(f"entry B metrics.jsonl rows {rows}")
    timings = list(instrument.chargrid.timings)
    med = lambda key, rows: statistics.median(r[key] for r in rows)
    res = {"train_seconds": train_s, "steps": steps,
           "ms_per_step": med("ms", steps),
           "buckets": sorted({tuple(s["shape"][1:]) for s in steps}),
           "examples": len(timings), "pulls": {
               s: pulls.count(s) for s in ("train", "val")},
           "host_ms": med("host_ms", timings),
           "assemble_ms": med("assemble_ms", timings),
           "fetch_ms": med("fetch_ms", timings),
           "history": history, "checkpoints": [p.name for p in ckpts]}
    print(f"[phase 5] entry B train: {len(steps)} steps in {train_s:.1f} s, "
          f"buckets {res['buckets']}, p50 {res['ms_per_step']:.2f} ms/step "
          f"(synchronised); per example p50: worker host "
          f"{res['host_ms']:.2f} ms, consumer wall from the upload to the "
          f"last warp (CUDA events) {res['assemble_ms']:.3f} ms, fetch "
          f"{res['fetch_ms']:.3f} ms "
          f"({len(timings)} examples); losses "
          f"{[round(s['loss'], 4) for s in steps]}; checkpoints "
          f"{res['checkpoints']}", flush=True)

    # 5c: run_kv_test on the val pages with the last checkpoint, at the
    # widths of model_kwargs.json (flat_scales 0), then the same through
    # KVModel.run_test at flat_scales 3; each page is served entry B's
    # input (paint x5: the one-hot, the line mask, the char separators)
    cfg = train_generic.configs(args, Charset.from_file(cs_path))[1]
    mk = root / "model_kwargs.json"
    mk.write_text(json.dumps(cfg.to_model_kwargs()))
    val = sorted(glob.glob(str(root / "val" / "*.json")))
    res["run_kv_test"] = {}
    for fs in (0, 3):
        want = {k: 0 for k in total}
        for path in val:
            _, _, _, hb, wb = prepare_host(load_label_json_page(path),
                                           Charset.from_file(cs_path), 3.0)
            per = dict(SERVE_PER_REQUEST[fs], paint=5)
            per[_attention_kind(hb, wb) + "_fwd"] = per.pop(
                "resident_attention_fwd")
            for k, v in per.items():
                want[k] += v
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        if fs == 0:
            kv_results, eval_results, summary = run_kv_test.main([
                "--input_dir", str(root / "val"), "--charset", cs_path,
                "--n_class", "17", "--model_weight", str(ckpts[-1]),
                "--model_kwargs", str(mk), "--out_dir", str(root / "kv"),
                "--label_dir", str(root / "val"), "--device", "cuda"])
        else:
            kv = KVModel(dataclasses.replace(cfg, flat_scales=fs),
                         device=dev).load(model_weight=str(ckpts[-1]),
                                          charset=cs_path, n_class=17)
            kv_results, eval_results, summary = kv.run_test(
                val, label_dir=str(root / "val"))
        torch.cuda.synchronize()
        kv_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        if counts != want:
            raise AssertionError(f"run_kv_test fs {fs}: launches {counts}, "
                                 f"want {want}")
        if not (summary and all(0.0 <= v <= 1.0 for v in summary.values())):
            raise AssertionError(f"run_kv_test fs {fs}: summary {summary}")
        for k in total:
            total[k] += counts[k]
        res["run_kv_test"][f"fs{fs}"] = {
            "pages": len(kv_results), "seconds": kv_s,
            "ms_per_page": kv_s * 1e3 / len(kv_results),
            "summary": summary, "counters": eval_results}
        print(f"[phase 5] {'run_kv_test' if fs == 0 else 'KVModel.run_test'}"
              f" on {len(kv_results)} val pages (flat_scales {fs}, f32, the "
              f"last checkpoint {ckpts[-1].name}): {kv_s:.2f} s, "
              f"{kv_s * 1e3 / len(kv_results):.1f} ms a page (model load "
              f"included); summary {json.dumps(summary)}; launches "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    # the served input of one page is entry B's, plane for plane
    from msau_tpu_torch.data.rasterize import (assemble_chargrid_input,
                                               round_up, upload_programs)

    x, _, _, _, progs = kv.rasterize(load_label_json_page(val[0]))
    cap = round_up(len(progs.char.values), 512)
    lcap = round_up(max(len(progs.line_id.values), 1), 512)
    ref = assemble_chargrid_input(
        *upload_programs([progs.char.padded(cap), progs.char_sep.padded(cap),
                          progs.line_mask.padded(lcap)], dev),
        x.shape[0], x.shape[1], cfg.img_channels - 2)
    if not (torch.equal(x, ref) and x[..., -2:].amax() > 0):
        raise AssertionError("the served input is not entry B's")
    print(f"[phase 5] served input of {os.path.basename(val[0])} equals "
          f"assemble_chargrid_input's, {list(x.shape)}", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return total, res


# ---- phase 6: spatial shards, a world of one, the parallel helpers --------
# 6a: the flagship step at flat_scales 3 on SP_SHARDS H-shards in one
# process against sp 1, phase 3's weights (seed 0) and batch, f32 and bf16.
# Three measures: the forward logits' max abs error over their largest
# |value| ("scaled"), one step's loss (rel) and the gradients leaf by leaf
# (each leaf's max abs error over its largest |value|; leaves whose
# reference gradient is below SP_LEAF_FLOOR of the model's largest are
# zero to rounding and left out).  Two references:
#   * "same path": sp 1 on the sharded code path (one shard: every op's
#     extension is the image's zero padding, residual blocks as two flat
#     convs), the same op sequence as sp SP_SHARDS with only the halo rows'
#     sources differing: held to SP_SAME_PATH[dtype];
#   * "f32 sp 1", the plain sp 1 step in f32 (fused residual blocks): f32 sp
#     SP_SHARDS at SP_F32_FWD_TOL, rel 1e-5 and each gradient within
#     2 * F32_VS_EXACT of its _grad_ratios bound (two f32 steps of the card,
#     as phase 3 holds fs 3 to fs 0); bf16 sp SP_SHARDS and bf16 sp 1 both
#     at SP_BF16_VS_F32 (the median leaf: this random model amplifies bf16
#     rounding, so some leaves of bf16 sp 1 lie several times their size
#     from f32).
# A planted fault, every halo row zeroed (each shard padded as if it were
# the image's edge), runs through the same checks in both dtypes and must
# fail every measure of both references.
SP_SHARDS = 4
SP_TIMED = 10
SP_PROFILED = 3
SP_F32_FWD_TOL = 1e-4
SP_LEAF_FLOOR = 1e-3
SP_SAME_PATH = {"float32": {"logits": 1e-3, "loss": 1e-5, "leaf": 1e-3},
                "bfloat16": {"logits": 1e-3, "loss": 1e-5, "leaf": 5e-2}}
SP_BF16_VS_F32 = {"logits": 0.75, "loss": 1e-2, "median_leaf": 0.11}
WORLD_ONE_STEPS = 3       # compared step by step, after one warm-up step
WORLD_ONE_ROUNDS = 6      # then alternating timed rounds of each trainer
WORLD_ONE_ROUND_STEPS = 5
WORLD_ONE_HOST_OPS = 6    # the host ops printed whose time grew the most
BN_CASE = (2, 8, 512)    # the BN + dropout layer: N, channels, side
BN_TOL = 1e-5            # of the largest |value|, card against CPU


def _one_shard_path():
    """A context in which a model at spatial_shards 1 takes the sharded
    code path (its SpatialShards of one shard reads as active)."""
    from unittest import mock

    from msau_tpu_torch.parallel.spatial import SpatialShards

    return mock.patch.object(SpatialShards, "active",
                             new_callable=mock.PropertyMock,
                             return_value=True)


def _zeroed_halos():
    """A context with a planted fault: every shard extended by zero rows,
    as if each shard's edges were the image's."""
    from unittest import mock

    import torch.nn.functional as F

    from msau_tpu_torch.parallel.spatial import SpatialShards

    return mock.patch.object(SpatialShards, "extend",
                             lambda self, x, top, bottom: F.pad(
                                 x, (0, 0, top, bottom)))


def _sp_outputs(dev, dtype, sp, x, y, context=None):
    """The flagship at flat_scales 3 on ``sp`` shards (seed 0 weights):
    a Trainer, its device batch, and (inside ``context``, when given) its
    forward logits, one step's loss and gradients (make_loss_and_grad)."""
    import contextlib

    import numpy as np
    import torch

    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.train.trainer import Trainer, make_loss_and_grad

    cfg = ModelConfig(**FLAGSHIP, flat_scales=3, spatial_shards=sp,
                      dtype=dtype)
    tr = Trainer(cfg, TrainConfig(learning_rate=1e-4,
                                  lr_decay_staircase=False), device=dev)
    tr.init_state(x, seed=0)
    batch = tr.put_batch({"input": x, "label": y,
                          "valid": np.ones(y.shape, bool)})
    batch["input"] = batch["input"].to(tr.model.compute_dtype)
    with context or contextlib.nullcontext():
        with torch.no_grad():
            logits = tr.model(batch["input"], logits_layout="NCHW")[1].cpu()
        loss, _, grads = make_loss_and_grad(tr.model)(batch)
    res = {"logits": logits, "loss": float(loss),
           "grads": {k: v.cpu().double() for k, v in grads.items()}}
    return tr, batch, res


def _sp_reference(dev, dtype, sp, x, y, context):
    """_sp_outputs' results alone, the device freed."""
    import torch

    tr, batch, res = _sp_outputs(dev, dtype, sp, x, y, context)
    del tr, batch
    torch.cuda.empty_cache()
    return res


def _sp_run(dev, dtype, sp, x, y, total):
    """_sp_outputs' results, then 2 warm-up and SP_TIMED timed Trainer
    steps with the launch counters reset just before (held to PER_STEP_SP4
    or PER_STEP[3] and added into ``total``), then a device profile of
    SP_PROFILED more -> results."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops

    tr, batch, res = _sp_outputs(dev, dtype, sp, x, y)
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(2):
        tr.state, metrics = tr.train_step(tr.state, batch)
    float(metrics["loss"])
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SP_TIMED):
        tr.state, metrics = tr.train_step(tr.state, batch)
    last = float(metrics["loss"])  # closes the timed window
    res["ms_per_step"] = (time.perf_counter() - t0) * 1e3 / SP_TIMED
    counts = ops.launch_counts()
    table = PER_STEP_SP4 if sp > 1 else PER_STEP[3]
    for name, n in counts.items():
        if n != table.get(name, 0) * SP_TIMED:
            raise AssertionError(
                f"sp {sp} {dtype}: {name} launched {n} times in {SP_TIMED} "
                f"steps, want {table.get(name, 0) * SP_TIMED}")
        total[name] += n
    if not np.isfinite(last):
        raise AssertionError(f"sp {sp} {dtype}: loss {last}")

    def step():
        tr.state, _ = tr.train_step(tr.state, batch)

    prof = _profile_steps(step, SP_PROFILED)
    res.update(peak_mem_gib=torch.cuda.max_memory_allocated(dev) / 2**30,
               busy_ms=prof["busy_ms"], kernels_per_step=prof["kernels"],
               busy_share=prof["busy_share"],
               families_ms=prof["families_ms"],
               launches_per_step={k: v / SP_TIMED for k, v in counts.items()
                                  if v})
    del tr, batch, metrics
    torch.cuda.empty_cache()
    return res


def _sp_measures(got, want):
    """got against want: logits scaled, loss rel, and the leaves' errors
    over their largest |value| (leaves below SP_LEAF_FLOOR of the largest
    left out): the worst, its name, the median, the count kept."""
    import numpy as np

    d = (got["logits"].double() - want["logits"].double()).abs()
    top = {k: float(v.abs().max()) for k, v in want["grads"].items()}
    floor = SP_LEAF_FLOOR * max(top.values())
    leaf = {k: _max_abs(got["grads"][k], w) / top[k]
            for k, w in want["grads"].items() if top[k] >= floor}
    worst = max(leaf, key=leaf.get)
    return {"logits": float(d.max() / want["logits"].double().abs().max()),
            "loss": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
            "leaf": leaf[worst], "worst_leaf": worst,
            "median_leaf": float(np.median(list(leaf.values()))),
            "leaves_kept": f"{len(leaf)} of {len(top)}"}


def spatial_shards_check(dev):
    """Phase 6a: the flagship's step at bs 16, 512^2, flat_scales 3 at sp
    SP_SHARDS and 1, f32 then bf16, held to sp 1 on the same code path and
    to f32 sp 1, with a planted fault that must fail each check (see
    SP_SHARDS's note) -> (launch counts of the timed steps, results and
    checks)."""
    import numpy as np

    from msau_tpu_torch import ops
    from msau_tpu_torch.data.synth import make_structured_batch

    x, y = make_structured_batch(np.random.default_rng(0), *TRAIN_BATCH, 17,
                                 64)
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    runs, same, fault = {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        for sp in (1, SP_SHARDS):
            runs[(dtype, sp)] = _sp_run(dev, dtype, sp, x, y, total)
        same[dtype] = _sp_reference(dev, dtype, 1, x, y, _one_shard_path())
        fault[dtype] = _sp_reference(dev, dtype, SP_SHARDS, x, y,
                                     _zeroed_halos())
    f32_1 = runs[("float32", 1)]

    def f32_check(got):
        ratios = _grad_ratios(got["grads"], f32_1["grads"])
        m = _sp_measures(got, f32_1)
        return {"logits": m["logits"], "loss": m["loss"],
                "grad_of_bound": max(ratios.values()),
                "worst_grad": max(ratios, key=ratios.get)}

    # (name, measure, bounds, run, planted fault's run): each reading of
    # the run must lie under its bound, each of the planted fault over it
    checks = []
    for dtype in ("float32", "bfloat16"):
        checks.append((f"{dtype} sp {SP_SHARDS} vs sp 1 on the same path",
                       lambda got, d=dtype: _sp_measures(got, same[d]),
                       SP_SAME_PATH[dtype], runs[(dtype, SP_SHARDS)],
                       fault[dtype]))
    checks.append((f"float32 sp {SP_SHARDS} vs f32 sp 1", f32_check,
                   {"logits": SP_F32_FWD_TOL, "loss": 1e-5,
                    "grad_of_bound": 2 * F32_VS_EXACT},
                   runs[("float32", SP_SHARDS)], fault["float32"]))
    for sp in (SP_SHARDS, 1):
        checks.append((f"bfloat16 sp {sp} vs f32 sp 1",
                       lambda got: _sp_measures(got, f32_1), SP_BF16_VS_F32,
                       runs[("bfloat16", sp)], fault["bfloat16"]))
    report, bad = [], []
    for name, measure, bounds, got, planted in checks:
        m, mf = measure(got), measure(planted)
        row = {"check": name, "reading": m, "planted_fault": mf,
               "bounds": bounds}
        report.append(row)
        print(f"[phase 6a] {name}: " + "; ".join(
            f"{k} {m[k]:.3e} (bound {b:.3e}; planted fault {mf[k]:.3e})"
            for k, b in bounds.items())
            + "".join(f"; {k} {m[k]}" for k in ("worst_leaf", "worst_grad",
                                                "leaves_kept") if k in m),
            flush=True)
        for k, b in bounds.items():
            if not m[k] <= b:
                bad.append(f"{name}: {k} {m[k]:.3e} over {b:.3e}")
            if not mf[k] > b:
                bad.append(f"{name}: the planted fault's {k} {mf[k]:.3e} "
                           f"passes {b:.3e}")
    if bad:
        raise AssertionError("phase 6a: " + "; ".join(bad))
    results = {}
    for (dtype, sp), r in runs.items():
        keep = {k: v for k, v in r.items() if k not in ("logits", "grads")}
        results[f"sp{sp}_{dtype}"] = keep
        print(f"[phase 6a] {dtype} sp {sp} bs {TRAIN_BATCH[0]} "
              f"{TRAIN_BATCH[1]}^2: {r['ms_per_step']:.2f} ms/step (host "
              f"clock, {SP_TIMED} steps), device busy {r['busy_ms']:.2f} ms "
              f"({100 * r['busy_share']:.1f} %), {r['kernels_per_step']:.0f} "
              f"kernels/step, peak {r['peak_mem_gib']:.2f} GiB; launches/step "
              f"{r['launches_per_step']}", flush=True)
    return total, {"runs": results, "checks": report}


def world_of_one(dev):
    """Phase 6b and 6c on a one-rank NCCL group: the flagship (fs 3, bs 16,
    512^2; f32, then bf16) in two Trainers, on make_mesh((1,), ("data",))
    and with no mesh (cuDNN's deterministic algorithms for both): 1 +
    WORLD_ONE_STEPS steps each, losses compared step by step, then
    WORLD_ONE_ROUNDS timed rounds of WORLD_ONE_ROUND_STEPS steps each,
    alternating which goes first, then a device profile of each (busy ms,
    kernels, the host ms of the collectives, the WORLD_ONE_HOST_OPS host
    ops whose own time grew the most with the mesh); losses and parameters
    equal bit for bit after every step.  Then sharded_conv2d on the one-rank
    group equals F.conv2d, and a ConvBnLrnDrop with BatchNorm and dropout
    (keep 0.9) at BN_CASE matches its CPU result in train mode (output and
    running statistics) and in eval mode -> (launch counts of the steps,
    results)."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.nn.functional as F

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.models.layers import ConvBnLrnDrop
    from msau_tpu_torch.ops import cuda_lib
    from msau_tpu_torch.parallel.sharding import (
        make_mesh, maybe_initialize_distributed)
    from msau_tpu_torch.parallel.spatial import sharded_conv2d
    from msau_tpu_torch.train.trainer import Trainer

    store = cuda_lib.BUILD_DIR.parent / "phase6_store"
    if store.exists():
        os.remove(store)
    torch.cuda.set_device(dev)
    maybe_initialize_distributed(f"file://{store}", 1, 0, backend="nccl")
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    res = {}

    def counted(what, steps):
        for k, n in ops.launch_counts().items():
            if n != PER_STEP[3].get(k, 0) * steps:
                raise AssertionError(f"phase 6b {what}: {k} launched {n} "
                                     f"times in {steps} steps")
            total[k] += n

    try:
        mesh = make_mesh((1,), ("data",))
        x, y = make_structured_batch(np.random.default_rng(0), *TRAIN_BATCH,
                                     17, 64)
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            for dtype in ("float32", "bfloat16"):
                runs = {}
                for name, m in (("no mesh", None), ("mesh", mesh)):
                    tr = Trainer(ModelConfig(**FLAGSHIP, flat_scales=3,
                                             dtype=dtype),
                                 TrainConfig(learning_rate=1e-4,
                                             lr_decay_staircase=False),
                                 mesh=m, device=dev)
                    tr.init_state(x, seed=0)
                    batch = tr.put_batch({"input": x, "label": y,
                                          "valid": np.ones(y.shape, bool)})
                    batch["input"] = batch["input"].to(tr.model.compute_dtype)
                    tr.state, metrics = tr.train_step(tr.state, batch)
                    losses = [float(metrics["loss"])]
                    ops.reset_launch_counts()
                    t0 = time.perf_counter()
                    for _ in range(WORLD_ONE_STEPS):
                        tr.state, metrics = tr.train_step(tr.state, batch)
                        losses.append(float(metrics["loss"]))
                    ms = (time.perf_counter() - t0) * 1e3 / WORLD_ONE_STEPS
                    counted(f"{name} {dtype}", WORLD_ONE_STEPS)
                    runs[name] = {"tr": tr, "batch": batch, "losses": losses,
                                  "ms": ms, "rounds_ms": []}
                ops.reset_launch_counts()
                for r in range(WORLD_ONE_ROUNDS):
                    order = ("no mesh", "mesh")[::1 if r % 2 == 0 else -1]
                    for name in order:
                        run, tr = runs[name], runs[name]["tr"]
                        t0 = time.perf_counter()
                        for _ in range(WORLD_ONE_ROUND_STEPS):
                            tr.state, metrics = tr.train_step(tr.state,
                                                              run["batch"])
                        run["losses"].append(float(metrics["loss"]))
                        run["rounds_ms"].append(
                            (time.perf_counter() - t0) * 1e3
                            / WORLD_ONE_ROUND_STEPS)
                counted(f"rounds {dtype}",
                        2 * WORLD_ONE_ROUNDS * WORLD_ONE_ROUND_STEPS)
                for run in runs.values():
                    def step(run=run):
                        tr = run["tr"]
                        tr.state, _ = tr.train_step(tr.state, run["batch"])
                    run["prof"] = _profile_steps(step, SP_PROFILED,
                                                 host_ops=True)
                a, b = runs["no mesh"], runs["mesh"]
                ha, hb = a["prof"]["host_ops"], b["prof"]["host_ops"]
                # the mesh's host ms by op, minus the mesh-less step's
                grown = sorted(((hb.get(k, (0, 0))[0] - ha.get(k, (0, 0))[0],
                                 k) for k in set(ha) | set(hb)),
                               reverse=True)[:WORLD_ONE_HOST_OPS]
                grown = {k[:60]: {"ms": d, "calls": (ha.get(k, (0, 0))[1],
                                                     hb.get(k, (0, 0))[1])}
                         for d, k in grown}
                params = dict(a["tr"].model.named_parameters())
                same = a["losses"] == b["losses"] and all(
                    torch.equal(params[k], v)
                    for k, v in b["tr"].model.named_parameters())
                diffs = [q - p for p, q in zip(a["rounds_ms"],
                                               b["rounds_ms"])]
                out = {"losses": a["losses"], "mesh_losses": b["losses"],
                       "equal_bits": same}
                for key, run in (("", a), ("mesh_", b)):
                    p = run["prof"]
                    out.update({
                        f"{key}ms_per_step": run["ms"],
                        f"{key}rounds_ms": run["rounds_ms"],
                        f"{key}rounds_median_ms": float(np.median(
                            run["rounds_ms"])),
                        f"{key}busy_ms": p["busy_ms"],
                        f"{key}kernels_per_step": p["kernels"],
                        f"{key}collectives_host_ms": p["collectives_host_ms"],
                        f"{key}host_ms": p["host_ms"]})
                out["rounds_diff_median_ms"] = float(np.median(diffs))
                out["host_ops_grown"] = grown
                res[f"mesh_vs_none_{dtype}"] = out
                print(f"[phase 6b] {dtype} world of one: losses {a['losses']} "
                      f"without a mesh, {b['losses']} on make_mesh((1,)) (1 "
                      f"+ {WORLD_ONE_STEPS} steps one by one, then the last "
                      f"of each of {WORLD_ONE_ROUNDS} rounds of "
                      f"{WORLD_ONE_ROUND_STEPS}); parameters equal bit for "
                      f"bit: {same}; ms/step without / with the mesh (host "
                      f"clock): the {WORLD_ONE_STEPS} steps {a['ms']:.2f} / "
                      f"{b['ms']:.2f}, the rounds "
                      f"{[round(v, 2) for v in a['rounds_ms']]} / "
                      f"{[round(v, 2) for v in b['rounds_ms']]} (median "
                      f"{out['rounds_median_ms']:.2f} / "
                      f"{out['mesh_rounds_median_ms']:.2f}; mesh minus none "
                      f"by round, median {out['rounds_diff_median_ms']:.2f}, "
                      f"{min(diffs):.2f} to {max(diffs):.2f}); profiled "
                      f"{SP_PROFILED} steps: busy {out['busy_ms']:.2f} / "
                      f"{out['mesh_busy_ms']:.2f} ms, kernels "
                      f"{out['kernels_per_step']:.1f} / "
                      f"{out['mesh_kernels_per_step']:.1f}, host ms in "
                      f"profiled ops (no synchronize) {out['host_ms']:.2f} / "
                      f"{out['mesh_host_ms']:.2f}, of which collectives "
                      f"{out['collectives_host_ms']:.3f} / "
                      f"{out['mesh_collectives_host_ms']:.3f}; host ms by "
                      f"op grown most with the mesh (calls a step without / "
                      f"with): " + "; ".join(
                          f"{k} {v['ms']:+.3f} ({v['calls'][0]:g} / "
                          f"{v['calls'][1]:g})" for k, v in grown.items()),
                      flush=True)
                if not same:
                    raise AssertionError(f"phase 6b {dtype}: the mesh's "
                                         "steps differ from the mesh-less")
                del runs, a, b, params
                torch.cuda.empty_cache()
        finally:
            torch.backends.cudnn.deterministic = deterministic

        # 6c: the spatial helpers on the one-rank group, the BN layer
        gen = torch.Generator().manual_seed(6)
        n, c, side = BN_CASE
        xc = torch.randn(n, c, side, side, generator=gen).to(dev)
        kern = (torch.randn(c, c, 3, 3, generator=gen) * 0.1).to(dev)
        got = sharded_conv2d(xc, kern, dist.group.WORLD)
        want = F.conv2d(xc, kern, padding=1)
        conv_err = _max_abs(got, want) / float(want.abs().max())
        layers, outs = {}, {}
        for where in ("cpu", dev):
            layer = ConvBnLrnDrop(c, c, use_bn=True, use_lrn=True,
                                  keep_prob=0.9,
                                  gen=torch.Generator().manual_seed(7),
                                  dropout_gen=torch.Generator().manual_seed(8))
            layers[str(where)] = layer.to(where).train()
            xin = xc.to(where)
            with torch.no_grad():
                train_out = layer(xin)
                layer.eval()
                outs[str(where)] = (train_out.cpu(), layer(xin).cpu(),
                                    layer.BatchNorm_0.mean.cpu(),
                                    layer.BatchNorm_0.var.cpu())
        errs = {k: _max_abs(a, b) / max(float(b.abs().max()), 1e-30)
                for k, a, b in zip(("train", "eval", "mean", "var"),
                                   outs[str(dev)], outs["cpu"])}
        res["sharded_conv2d_scaled_err"] = conv_err
        res["bn_dropout_scaled_err"] = errs
        print(f"[phase 6c] sharded_conv2d on a one-rank group vs F.conv2d "
              f"({list(xc.shape)}, 3x3): scaled err {conv_err:.3e} (bound "
              f"{BN_TOL}); BN + dropout layer {list(xc.shape)}, card vs CPU, "
              f"scaled errs {json.dumps(errs)} (bound {BN_TOL})", flush=True)
        if conv_err > BN_TOL or max(errs.values()) > BN_TOL:
            raise AssertionError("phase 6c: the card is off the reference")
    finally:
        dist.destroy_process_group()
        if store.exists():
            os.remove(store)
    return total, res


# Phase 7, the trained end-to-end path.  7b runs the held-out protocol's
# own model (2 stages, feat_root 8, res_depth 2, 4 scales, bf16,
# flat_scales 3) on 8 train and 4 held-out pages of its corpus for 10
# epochs: a smoke reading of its F1, not the protocol's (40 / 50 pages, 60
# epochs: tools/accuracy_matrix.py).  --quick would build one stage, whose
# attention output and couplings feed nothing: no attention backward and
# no coupling kernel would launch.
CORPUS_EVAL_ARGS = ["--train_pages", "8", "--test_pages", "4", "--epochs",
                    "10", "--dtype", "bf16", "--flat", "3", "--scales", "4",
                    "--device", "cuda"]
# the kernels 7b's training and serving must launch (rows 1-4, 6-8, 11-19
# of the kernels table; 9 and 10 run inside 11 and 12's kernels)
CORPUS_EVAL_KERNELS = (
    "paint", "resident_attention_fwd", "ccl_multiclass",
    "resident_attention_bwd", "to_nchw", "flat_maxpool2", "flat_conv2d",
    "concat_conv1x1", "flat_deconv2", "flat_res_block", "flat_maxpool2_bwd",
    "flat_conv_bwd", "flat_conv_dx", "concat_conv1x1_bwd", "flat_deconv2_dx",
    "flat_deconv2_dw", "flat_res_block_bwd")
E2E_KERNELS = ("paint", "resident_attention_fwd", "resident_attention_bwd",
               "ccl_multiclass")
E2E_TIMED = 10   # 7a's steady steps of a fresh demo model, after 2
TRAINED_SERVE_ROUNDS = 3  # timed passes over 7b's held-out pages
# 7d: the resident attention at the deepest scales this phase runs: 7b's
# step (256^2 at 4 scales: N 4, T 1024, C 64) and the 3-scale models of
# the matrix (T 4096, C 32) at batch 4 and the demo's N 1
PHASE7_ATTN_CASES = ((4, 1024, 8, 64), (4, 4096, 4, 32), (1, 4096, 4, 32))
PHASE7_FLAT = (256, 4)    # 7b's bucket side and batch


def _load_example():
    """examples/end_to_end_kv_torch.py as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "end_to_end_kv_torch.py")
    spec = importlib.util.spec_from_file_location("end_to_end_kv_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _missing(counts, names):
    return [k for k in names if not counts[k]]


def end_to_end(dev):
    """7a: the end-to-end demo on the card, 120 steps -> (launches, record):
    F1 > 0.9 asserted; ms a step (host clock) over the demo's 120 (its
    first steps included) and, off the counted run, over E2E_TIMED steps
    of a fresh demo model after 2 warm-up steps, then kernels and busy ms
    of one profiled step."""
    import tempfile

    import torch

    from msau_tpu_torch.ops import launch_counts, reset_launch_counts

    ex = _load_example()
    timings = {}
    reset_launch_counts()
    f1 = ex.main(dev, timings=timings)
    counts = launch_counts()
    with tempfile.TemporaryDirectory(prefix="msau_demo_") as tmp:
        kv, x, label = ex.setup(dev, tmp)
        _, _, step = ex.build(kv)
        xb, yb = x[None], label[None]
        for _ in range(2):
            step(xb, yb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(E2E_TIMED):
            loss, _ = step(xb, yb)
        float(loss)
        steady = (time.perf_counter() - t0) * 1e3 / E2E_TIMED
        prof = _profile_steps(lambda: step(xb, yb), 1)
        shape = list(x.shape)
    rec = {"f1": f1, "ms_per_step": timings["train_ms_per_step"],
           "steady_ms_per_step": steady,
           "kernels_per_step": prof["kernels"], "busy_ms": prof["busy_ms"],
           "input": shape, "launches": counts}
    print(f"[phase 7a] end-to-end demo on {shape}, {ex.N_CLASS} classes, 120 "
          f"steps: F1 {f1:.3f}; ms a step (host clock) {rec['ms_per_step']:.2f}"
          f" over the 120, {steady:.2f} over {E2E_TIMED} after 2 warm-up "
          f"steps; one profiled step: {prof['kernels']:.0f} kernels, busy "
          f"{prof['busy_ms']:.2f} ms; launches {json.dumps(counts)}",
          flush=True)
    if not f1 > 0.9:
        raise AssertionError(f"phase 7a: the demo's F1 {f1} is not > 0.9")
    missing = _missing(counts, E2E_KERNELS)
    if missing:
        raise AssertionError(f"phase 7a: {missing} did not launch")
    del kv, x, label, xb, yb, step
    torch.cuda.empty_cache()
    return counts, rec


def corpus_eval_run(dev):
    """7b: tools/corpus_eval.run(CORPUS_EVAL_ARGS) in this process ->
    (launches, the run, record): the epochs' losses finite and the last
    below the first, the summary in [0, 1], and every kernel of
    CORPUS_EVAL_KERNELS launched."""
    import math

    import numpy as np

    from msau_tpu_torch.ops import launch_counts, reset_launch_counts
    from msau_tpu_torch.tools import corpus_eval

    reset_launch_counts()
    t0 = time.perf_counter()
    run = corpus_eval.run(CORPUS_EVAL_ARGS)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    losses = run.epoch_losses
    per_epoch = run.steps / len(losses)
    rec = {"result": run.result, "epoch_losses": losses,
           "steps": run.steps, "wall_s": wall,
           "ms_per_step": sum(run.epoch_seconds) * 1e3 / run.steps,
           "steady_ms_per_step": float(np.median(run.epoch_seconds[1:]))
           * 1e3 / per_epoch, "launches": counts}
    print(f"[phase 7b] corpus_eval {' '.join(CORPUS_EVAL_ARGS)}: F1 "
          f"{run.summary['f1']:.4f} (P {run.summary['precision']:.4f}, R "
          f"{run.summary['recall']:.4f}), pixel P "
          f"{run.result['pixel_precision']} R {run.result['pixel_recall']} "
          f"(a smoke reading, not the protocol's); epoch losses "
          f"{[round(v, 4) for v in losses]}; {run.steps} steps, ms a step "
          f"(host clock, with its loss fetch an epoch) "
          f"{rec['ms_per_step']:.2f} over all, "
          f"{rec['steady_ms_per_step']:.2f} the median epoch after the "
          f"first; {wall:.1f} s in all; launches {json.dumps(counts)}",
          flush=True)
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"phase 7b: the loss did not fall: {losses}")
    if not all(0.0 <= run.summary[k] <= 1.0 for k in run.summary):
        raise AssertionError(f"phase 7b: summary {run.summary}")
    missing = _missing(counts, CORPUS_EVAL_KERNELS)
    if missing:
        raise AssertionError(f"phase 7b: {missing} did not launch")
    return counts, run, rec


def trained_serve(dev, run):
    """7c: 7b's trained weights (f32, flat_scales 0) serving its held-out
    pages with ``predict(return_maps=False)`` -> (launches, record, the
    class maps the decoder labelled in one ``predict_batch`` of the pages):
    p50 of each predict stage over TRAINED_SERVE_ROUNDS passes after a
    warm-up pass, and device busy ms and kernels a request (torch.profiler
    over one pass)."""
    import numpy as np

    from msau_tpu_torch.data.pages import load_label_json_page
    from msau_tpu_torch.ops import launch_counts, reset_launch_counts

    kv = run.kv
    pages = [load_label_json_page(p) for p in run.test_paths]
    reset_launch_counts()
    for pg in pages:
        kv.predict(pg, return_maps=False)
    rows = []
    for _ in range(TRAINED_SERVE_ROUNDS):
        for pg in pages:
            rows.append({})
            kv.predict(pg, return_maps=False, timings=rows[-1])
    counts = launch_counts()
    prof = _profile_steps(lambda: [kv.predict(pg, return_maps=False)
                                   for pg in pages], 1)
    rec = {k: float(np.median([r[k] for r in rows]))
           for k in ("prep", "device", "strings")}
    rec.update(busy_ms=prof["busy_ms"] / len(pages),
               kernels=prof["kernels"] / len(pages), requests=len(rows),
               lines=[len(pg.lines) for pg in pages])
    print(f"[phase 7c] trained serving (7b's weights, f32, flat_scales 0) "
          f"of {len(pages)} held-out pages, {len(rows)} requests: p50 ms "
          f"prep {rec['prep']:.2f}, device {rec['device']:.2f}, strings "
          f"{rec['strings']:.2f}; device busy {rec['busy_ms']:.2f} ms and "
          f"{rec['kernels']:.0f} kernels a request", flush=True)
    maps = _record_decoder_maps(kv, pages)
    return counts, rec, maps


def phase7_kernels(dev, n_token, maps):
    """7d: the kernels at this phase's shapes against their plain versions,
    the same bits on a rerun: the resident attention on PHASE7_ATTN_CASES
    (f32 and bf16, phase 1's tolerances); the flat kernels, forward and
    backward, at 7b's instances (``flat_cases.scaled_cases``: 256^2,
    batch 4, ``n_token`` input planes; FLAT_TOL, layout and pool exact,
    FLAT_BWD_TOL); the CCL on the class maps 7c's trained model gave the
    decoder, each page alone and the stack -> {kernel: {max_abs_err (f32),
    cases}}."""
    import numpy as np
    import torch

    from msau_tpu_torch.ops.ccl import (
        connected_components_multiclass_cuda as ccl,
        connected_components_multiclass_plain,
    )
    from msau_tpu_torch.utils.flat_cases import (
        flat_bwd_case_fns,
        flat_bwd_case_tensors,
        flat_bwd_errors,
        flat_case_fns,
        flat_case_tensors,
        scaled_cases,
    )

    out = check_attention_kernels(dev, PHASE7_ATTN_CASES, phase="phase 7d")
    side, n = PHASE7_FLAT
    fwd_cases, bwd_cases = scaled_cases(side, n, n_token)
    for case in fwd_cases + bwd_cases:
        bwd = "fwd_op" in case
        rec = out.setdefault(case["op"], {"max_abs_err": 0.0, "cases": {}})
        for key, tol in FLAT_TOL.items():
            dtype = getattr(torch, key)
            name = f"phase 7d {case['op']} {case['name']} {key}"
            if bwd:
                tensors = flat_bwd_case_tensors(
                    case, np.random.default_rng(13), dev, dtype)
                kernel, plain = flat_bwd_case_fns(case, tensors)
            else:
                tensors = flat_case_tensors(case, np.random.default_rng(11),
                                            dev, dtype)
                kernel, plain = flat_case_fns(case, tensors, dtype)
            got, again = kernel(), kernel()
            torch.cuda.synchronize()
            want = plain()
            if not bwd:
                got, again, want = (got,), (again,), (want,)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"{name}: a rerun gives other bits")
            err = max(_max_abs(a, b) for a, b in zip(got, want))
            if bwd:
                bad = [e for e in flat_bwd_errors(case, got, want, key)
                       if e[1] > e[2]]
            elif case["op"] in ("to_nchw", "flat_maxpool2"):
                bad = err > 0
            else:
                bad = _scaled_err(got[0], want[0]) > tol
            if bad or (not bwd and (got[0].dtype != dtype
                                    or got[0].shape != want[0].shape)):
                raise AssertionError(f"{name}: max abs err {err}, {bad}")
            rec["cases"][f"{case['name']} {key}"] = err
            if key == "float32":
                rec["max_abs_err"] = max(rec["max_abs_err"], err)
            del tensors, got, again, want
        torch.cuda.empty_cache()
    for op in sorted({c["op"] for c in fwd_cases + bwd_cases}):
        print(f"[phase 7d] {op}: {len(out[op]['cases'])} cases at "
              f"{side}^2 batch {n} within phase 1's tolerances, the same "
              f"bits on a rerun; f32 max abs err "
              f"{out[op]['max_abs_err']:.3e}", flush=True)
    # the CCL on the trained model's class maps: each page, and each
    # group's stack in one call
    pages = 0
    for stack in maps:
        _same_bits_as_plain("phase 7d ccl stack", lambda: ccl(stack),
                            lambda: torch.stack([
                                connected_components_multiclass_plain(m)
                                for m in stack]))
        for m in stack:
            m = m.contiguous()
            _same_bits_as_plain("phase 7d ccl page", lambda: ccl(m),
                                lambda: connected_components_multiclass_plain(
                                    m))
            pages += 1
    classes = sorted({int(c) for s in maps for c in s.unique().tolist()})
    out["ccl_multiclass"] = {"max_abs_err": 0.0, "pages": pages,
                             "stacks": [list(s.shape) for s in maps],
                             "classes": classes}
    print(f"[phase 7d] ccl on the trained model's class maps ({pages} "
          f"pages, stacks {out['ccl_multiclass']['stacks']}, classes "
          f"{classes}): exact, the same bits on a rerun", flush=True)
    return out


def phase7(dev):
    """Phase 7, the trained end-to-end path -> (launches of 7a-7c, 7d's
    errors by kernel, record with the seconds of each sub-phase)."""
    from msau_tpu_torch.ops import launch_counts

    seconds, res = {}, {}

    def sub(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase {name}] {seconds[name]:.1f} s", flush=True)
        return got

    c_a, res["end_to_end"] = sub("7a", end_to_end, dev)
    c_b, run, res["corpus_eval"] = sub("7b", corpus_eval_run, dev)
    c_c, res["trained_serve"], maps = sub("7c", trained_serve, dev, run)
    errs = sub("7d", phase7_kernels, dev, run.kv.charset.n_token, maps)
    shutil.rmtree(run.out_dir, ignore_errors=True)
    res["seconds"] = seconds
    counts = {k: c_a[k] + c_b[k] + c_c[k] for k in launch_counts()}
    return counts, errs, res


# phase 8: the port's last modules.  (a) checkpoints of the original
# PyTorch MSAU migrated and served: the reference's FUNSD entry-A
# hyperparameters at full width (featRoot 8, scale_space_num 4, res_depth
# 2, 3 blocks, 17 classes, the serving charset's 64 tokens), and its
# defaults (scale_space_num 6, res_depth 3)
MIGRATED = dict(img_channels=64, n_class=17, scale_space_num=4, res_depth=2,
                feat_root=8, num_blocks=3, final_act="softmax",
                activation_name="relu")
MIGRATED_DEFAULTS = dict(MIGRATED, scale_space_num=6, res_depth=3)
MIGRATED_REQUESTS = 3       # timed requests a model, after a warm-up
# the resident attention at the defaults' deepest scale on the bench page
# (512^2 / 2^5 = 16 x 16 tokens; feat_root 8 x 2^5 = 256 channels)
MIGRATED_ATTN = (1, 256, 32, 256)
RICH_STEPS = (3, 2)         # steps before the checkpoint, then from each state
NATIVE_REPEATS = 20         # host timings: the median of this many calls
PHASE8_BUDGET_S = 40.0


def _migrated_kv(model_kwargs, params, dev, page):
    """A KVModel of ``model_kwargs`` (f32) with the bench charset, its
    weights a migrated flax tree through ``load(params=)``, warmed up at
    512 and on ``page``."""
    from msau_tpu_torch.config import InferConfig, ModelConfig
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.synth import BENCH_CHARSET
    from msau_tpu_torch.infer.kv_model import KVModel

    kv = KVModel(model_config=ModelConfig(**model_kwargs, dtype="float32"),
                 infer_config=InferConfig(n_class=17), device=dev)
    kv.charset = Charset(chars=" $" + BENCH_CHARSET)
    kv.load(n_class=17, params=params)
    kv.warmup_bucket(512)
    kv.predict(page, return_maps=False)
    return kv


def _bench_page():
    import numpy as np

    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.synth import make_page

    return page_from_label_dict(
        make_page(np.random.default_rng(3), n_cols=5, rows_per_col=10))


def migrated_serve(dev):
    """8a: a seeded reference-layout state dict (utils/reference_weights.py)
    at MIGRATED's widths, migrated with the port's torch_state_dict_to_flax
    and served through KVModel.load(params=) / predict on the 512^2 bench
    page, f32, at flat_scales 0 and 3: the launches per request held to
    SERVE_PER_REQUEST, the decode tables equal to the plain pipeline's, at
    64x64 the card's forwards against the CPU's and fs 3 against fs 0
    within phase 2's 1e-4; then one request at the reference defaults
    (MIGRATED_DEFAULTS, fs 0) -> (launches, record)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig
    from msau_tpu_torch.utils.reference_weights import reference_state_dict
    from msau_tpu_torch.utils.transplant import torch_state_dict_to_flax

    page = _bench_page()
    sd = reference_state_dict(ModelConfig(**MIGRATED), seed=18)
    params = torch_state_dict_to_flax(sd, MIGRATED["scale_space_num"])
    rec = {"reference_keys": len(sd)}
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    models, probs = {}, {}
    for fs in (0, 3):
        kv = models[fs] = _migrated_kv(dict(MIGRATED, flat_scales=fs), params,
                                       dev, page)
        label = f"migrated fs={fs} float32"
        rec[f"fs{fs}_p50_ms"] = _serve_requests(
            kv, page, MIGRATED_REQUESTS, SERVE_PER_REQUEST[fs], label, total,
            phase="phase 8a")
        rec[f"fs{fs}_check"], probs[fs] = _decode_check(
            kv, page, 512, dev, label, phase="phase 8a")
        print(f"[phase 8a] {label} predict p50 ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in rec[f"fs{fs}_p50_ms"].items()),
            flush=True)
    rec["probs_fs3_vs_fs0_512_max_abs_err"] = _max_abs(probs[3], probs[0])
    ids = np.random.default_rng(1).integers(0, 64, (1, 64, 64))
    x = torch.from_numpy(np.eye(64, dtype=np.float32)[ids])
    small = {}
    for fs, kv in models.items():
        with torch.inference_mode():
            small[(fs, "card")] = kv.model(x.to(dev))[0].cpu()
            small[(fs, "cpu")] = _cpu_twin(kv)(x)[0]
    for name, a, b in (("fs0_card_vs_cpu", (0, "card"), (0, "cpu")),
                       ("fs3_card_vs_cpu", (3, "card"), (3, "cpu")),
                       ("fs3_vs_fs0_card", (3, "card"), (0, "card"))):
        err = rec[f"forward_f32_64x64_{name}_max_abs_err"] = _max_abs(
            small[a], small[b])
        print(f"[phase 8a] migrated f32 forward at 64x64, {name}: max abs "
              f"err {err:.3e}", flush=True)
        if err > 1e-4:
            raise AssertionError(f"phase 8a: migrated f32 forward at 64x64, "
                                 f"{name}: max abs err {err}")
    del models, small

    sd = reference_state_dict(ModelConfig(**MIGRATED_DEFAULTS), seed=19)
    rec["defaults_reference_keys"] = len(sd)
    kv = _migrated_kv(MIGRATED_DEFAULTS, torch_state_dict_to_flax(
        sd, MIGRATED_DEFAULTS["scale_space_num"]), dev, page)
    label = "migrated reference defaults (6 scales, res_depth 3) fs=0 float32"
    rec["defaults_p50_ms"] = _serve_requests(kv, page, 1, SERVE_PER_REQUEST[0],
                                             label, total, phase="phase 8a")
    rec["defaults_check"], _ = _decode_check(kv, page, 512, dev, label,
                                             phase="phase 8a")
    rec["wide_attention"] = _wide_attention_times(dev)
    print(f"[phase 8a] migrated: {rec['reference_keys']} and "
          f"{rec['defaults_reference_keys']} reference keys; f32 probs at "
          f"512^2, fs=3 vs fs=0: max abs err "
          f"{rec['probs_fs3_vs_fs0_512_max_abs_err']:.3e}", flush=True)
    del kv
    torch.cuda.empty_cache()
    return total, rec


def _wide_attention_times(dev):
    """The resident attention's kernels at MIGRATED_ATTN (the width the
    reference defaults need), f32 and bf16: device ms of the forward and
    the backward beside their plain versions' and bounds -> record."""
    import torch

    from msau_tpu_torch.ops.attention import (
        resident_attention_bwd_cuda,
        resident_attention_bwd_plain,
        resident_attention_cuda,
        resident_attention_plain_stats,
    )

    n, t, cb, c = MIGRATED_ATTN
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        f, g, h, dout = _attention_tensors(dev, n, t, cb, c, dtype)
        _, m, l = resident_attention_cuda(f, g, h)
        size = f.element_size()
        rec = out[str(dtype).split(".")[-1]] = {
            "fwd_ms": _device_time(lambda: resident_attention_cuda(f, g, h),
                                   10)[0],
            "fwd_plain_ms": _device_time(
                lambda: resident_attention_plain_stats(f, g, h), 10)[0],
            "fwd_bound": _attention_bound("resident_attention_fwd", n, t, cb,
                                          c, size),
            "bwd_ms": _device_time(lambda: resident_attention_bwd_cuda(
                f, g, h, m, l, dout), 10)[0],
            "bwd_plain_ms": _device_time(lambda: resident_attention_bwd_plain(
                f, g, h, m, l, dout), 10)[0],
            "bwd_bound": _attention_bound("resident_attention_bwd", n, t, cb,
                                          c, size)}
        print(f"[phase 8a] resident attention at (N, T, Cb, C) = "
              f"{MIGRATED_ATTN}, {dtype}: forward {rec['fwd_ms']:.4f} ms "
              f"(plain {rec['fwd_plain_ms']:.4f}, bound "
              f"{rec['fwd_bound'][0]:.4f}), backward {rec['bwd_ms']:.4f} ms "
              f"(plain {rec['bwd_plain_ms']:.4f}, bound "
              f"{rec['bwd_bound'][0]:.4f})", flush=True)
    return out


def _state_tensors(state):
    out = {f"params/{k}": v for k, v in state.params.items()}
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"{k}/{n}": t for n, t in v.items()})
    return out


def _same_state(a, b, label):
    """Raise unless train states ``a`` and ``b`` are equal in bits (every
    tensor, its dtype and device; the step and the update count)."""
    import torch

    ta, tb = _state_tensors(a), _state_tensors(b)
    if ta.keys() != tb.keys():
        raise AssertionError(f"{label}: the states hold other tensors")
    for k in ta:
        if not (ta[k].dtype == tb[k].dtype and ta[k].device == tb[k].device
                and torch.equal(ta[k], tb[k])):
            raise AssertionError(f"{label}: {k} differs")
    if (a.step, a.opt_state["count"]) != (b.step, b.opt_state["count"]):
        raise AssertionError(f"{label}: step or update count differs")


def rich_checkpoint(dev):
    """8b: the flagship train state (batch 16, 512^2, flat_scales 3, bf16,
    phase 3's batch and optimizer) after RICH_STEPS[0] steps through
    save_checkpoint with its config and a small cg_dict, then
    load_checkpoint into a fresh Trainer's state (another seed) on the card:
    the states equal in bits, the meta and the npz equal what was written,
    RICH_STEPS[1] more steps from each equal in losses and every tensor;
    then KVModel.load(model_weight=) serves the checkpoint on the bench
    page (the launches of a request, the decode tables equal to the plain
    pipeline's).  The steps run on cuDNN's deterministic algorithms (the
    default ones give other bits on each call) -> (launches, record)."""
    import dataclasses
    import shutil

    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import InferConfig, ModelConfig, TrainConfig
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.synth import BENCH_CHARSET, make_structured_batch
    from msau_tpu_torch.infer.kv_model import KVModel
    from msau_tpu_torch.ops import cuda_lib
    from msau_tpu_torch.train.trainer import Trainer
    from msau_tpu_torch.utils.io import load_checkpoint, save_checkpoint

    bs, hw = TRAIN_BATCH
    x, y = make_structured_batch(np.random.default_rng(0), bs, hw, 17, 64)
    mc = ModelConfig(**FLAGSHIP, flat_scales=3, dtype="bfloat16")
    tcfg = TrainConfig(learning_rate=1e-4, lr_decay_staircase=False)
    root = cuda_lib.BUILD_DIR.parent / "phase8_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    path = str(root / "flagship")
    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    rec = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        trainers, batches = [], []
        for seed in (0, 1):
            tr = Trainer(mc, tcfg, device=dev)
            tr.init_state(x, seed=seed)
            batch = tr.put_batch({"input": x, "label": y,
                                  "valid": np.ones(y.shape, bool)})
            batch["input"] = batch["input"].to(tr.model.compute_dtype)
            trainers.append(tr)
            batches.append(batch)
        tr, fresh = trainers
        ops.reset_launch_counts()
        losses = []
        for _ in range(RICH_STEPS[0]):
            tr.state, m = tr.train_step(tr.state, batches[0])
            losses.append(m["loss"])
        cg = {"losses": torch.stack(losses).float().cpu().numpy(),
              "label_counts": np.bincount(y.ravel(), minlength=17),
              "absent": None}
        config = dataclasses.asdict(mc)
        t0 = time.perf_counter()
        save_checkpoint(path, tr.state, config=config, cg_dict=cg,
                        epoch=RICH_STEPS[0])
        rec["save_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, meta = load_checkpoint(path, fresh.state)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["load_s"] = time.perf_counter() - t0
        if state is not fresh.state:
            raise AssertionError("phase 8b: load_checkpoint returned another "
                                 "state than its template")
        _same_state(fresh.state, tr.state, "phase 8b after the load")
        if meta != {"epoch": RICH_STEPS[0],
                    "config": json.loads(json.dumps(config))}:
            raise AssertionError(f"phase 8b: meta {meta} differs")
        with np.load(path + ".cg.npz") as z:
            if sorted(z.files) != ["label_counts", "losses"] or not all(
                    np.array_equal(z[k], cg[k]) for k in z.files):
                raise AssertionError("phase 8b: the cg npz differs")
        runs = []
        for t, batch in ((tr, batches[0]), (fresh, batches[1])):
            run = []
            for _ in range(RICH_STEPS[1]):
                t.state, m = t.train_step(t.state, batch)
                run.append(m["loss"].float().cpu().numpy().tobytes())
            runs.append(run)
        counts = ops.launch_counts()
        if runs[0] != runs[1]:
            raise AssertionError("phase 8b: the losses after the load differ")
        _same_state(fresh.state, tr.state,
                    f"phase 8b after {RICH_STEPS[1]} more steps")
        n_steps = RICH_STEPS[0] + 2 * RICH_STEPS[1]
        for name, n in counts.items():
            if n != PER_STEP[3].get(name, 0) * n_steps:
                raise AssertionError(f"phase 8b: {name} launched {n} times in "
                                     f"{n_steps} steps")
            total[name] += n
        rec.update(steps=n_steps, losses=[float(v) for v in cg["losses"]],
                   file_mib=os.path.getsize(os.path.join(
                       path, "train_state.pt")) / 2**20)
        del trainers, batches, tr, fresh, state
        torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic

    page = _bench_page()
    kv = KVModel(model_config=mc, infer_config=InferConfig(n_class=17),
                 device=dev)
    kv.charset = Charset(chars=" $" + BENCH_CHARSET)
    kv.load(n_class=17, model_weight=path)
    kv.predict(page, return_maps=False)
    label = "rich checkpoint fs=3 bfloat16"
    rec["serve_p50_ms"] = _serve_requests(kv, page, 1, SERVE_PER_REQUEST[3],
                                          label, total, phase="phase 8b")
    rec["serve_check"], _ = _decode_check(kv, page, 512, dev, label,
                                          phase="phase 8b")
    shutil.rmtree(root, ignore_errors=True)
    print(f"[phase 8b] {n_steps} steps: states, losses and parameters equal "
          f"bit for bit across save / load ({rec['file_mib']:.2f} MiB, save "
          f"{rec['save_s']:.3f} s, load {rec['load_s']:.3f} s); losses "
          f"{rec['losses']}", flush=True)
    del kv
    torch.cuda.empty_cache()
    return total, rec


def _captured_records(fn, *args, **kwargs):
    """Run ``fn`` with ``data.native.char_records`` recording its inputs ->
    [(line_boxes, text_offsets, char_ids, cap_factor), ...]."""
    from msau_tpu_torch.data import native as dn

    seen, orig = [], dn.char_records

    def spy(*a):
        seen.append(a)
        return orig(*a)

    dn.char_records = spy
    try:
        fn(*args, **kwargs)
    finally:
        dn.char_records = orig
    return seen


def _median_ms(fns, n=NATIVE_REPEATS):
    """Host ms of each of ``fns`` (name -> callable), the median of ``n``
    calls, the functions called in turn so that a drift of the host's
    clock falls on each alike -> {name: ms}."""
    import statistics

    times = {k: [] for k in fns}
    for _ in range(n):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def native_core():
    """8c: the C rasterizer core (msau_tpu_torch.native) must be in use
    (native_available() True); its records equal the numpy version's on
    the inputs the rasterizer gives it for the 512^2 bench page, the
    2814-line 1024^2 page and the 24 entry-B pages; host times (this
    machine's CPU, the median of NATIVE_REPEATS calls) of char_records and
    of the bench page's host prep (prepare_host), with the C core and with
    the numpy version in its place -> record."""
    import numpy as np

    from msau_tpu_torch import native
    from msau_tpu_torch.config import InferConfig
    from msau_tpu_torch.data import native as dn
    from msau_tpu_torch.data.charset import Charset
    from msau_tpu_torch.data.pages import page_from_label_dict
    from msau_tpu_torch.data.rasterize import build_chargrid_programs
    from msau_tpu_torch.data.synth import BENCH_CHARSET, make_page
    from msau_tpu_torch.infer.kv_model import prepare_host

    if not native.native_available():
        raise AssertionError("phase 8c: the C rasterizer core is not in use")
    serve_cs = Charset(chars=" $" + BENCH_CHARSET)
    scale = InferConfig().scale
    bench = _bench_page()
    big = page_from_label_dict(
        make_page(np.random.default_rng(3), n_cols=10, rows_per_col=20))
    rng = np.random.default_rng(5)      # entry B's corpus: write_corpus's draws
    entry_b = [page_from_label_dict(make_page(rng, n_cols=5, rows_per_col=10))
               for _ in range(ENTRY_B_PAGES)]
    train_cs = Charset.from_corpus([t for p in entry_b for t in p.texts])
    inputs = {"bench 512^2": _captured_records(prepare_host, bench, serve_cs,
                                               scale),
              "1024^2 (2814 lines)": _captured_records(prepare_host, big,
                                                        serve_cs, scale)}
    inputs["entry B (24 pages)"] = [
        a for p in entry_b for a in _captured_records(
            build_chargrid_programs, p, train_cs, scale_min=3.0,
            scale_max=3.0, label_style="underline")]
    rec = {"library": dict(native.BUILD_INFO), "records": {}}
    for name, calls in inputs.items():
        n = 0
        for a in calls:
            got, want = native.char_records(*a), dn.char_records_plain(*a)
            if not all(g.dtype == w.dtype and np.array_equal(g, w)
                       for g, w in zip(got, want)):
                raise AssertionError(f"phase 8c: {name}: the C core's "
                                     "records differ from numpy's")
            n += len(got[0])
        rec["records"][name] = {"calls": len(calls), "records": n}
    host = {}
    for name in ("bench 512^2", "1024^2 (2814 lines)"):
        a = inputs[name][0]
        host[f"char_records {name}"] = _median_ms({
            "c_ms": lambda: native.char_records(*a),
            "numpy_ms": lambda: dn.char_records_plain(*a)})
    # the bench page's host prep with the dispatch (the C core) and with
    # the numpy version in its place
    dispatch = dn.char_records

    def prep(records):
        dn.char_records = records
        try:
            prepare_host(bench, serve_cs, scale)
        finally:
            dn.char_records = dispatch

    host["prepare_host bench 512^2"] = _median_ms({
        "c_ms": lambda: prep(dispatch),
        "numpy_ms": lambda: prep(dn.char_records_plain)})
    rec["host_ms"] = host
    print(f"[phase 8c] the C core ({rec['library'].get('path')}): records "
          f"equal numpy's on " + ", ".join(
              f"{k} ({v['records']} records)"
              for k, v in rec["records"].items()), flush=True)
    for k, v in host.items():
        print(f"[phase 8c] host CPU of this machine, median of "
              f"{NATIVE_REPEATS}: {k}: C {v['c_ms']:.4f} ms, numpy "
              f"{v['numpy_ms']:.4f} ms", flush=True)
    return rec


def phase8(dev):
    """Phase 8, the port's last modules -> (launches of 8a and 8b, record
    with the seconds of each sub-phase)."""
    seconds, res = {}, {}

    def sub(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase {name}] {seconds[name]:.1f} s", flush=True)
        return got

    c_a, res["migrated_serve"] = sub("8a", migrated_serve, dev)
    c_b, res["rich_checkpoint"] = sub("8b", rich_checkpoint, dev)
    res["native_core"] = sub("8c", native_core)
    res["seconds"] = seconds
    total = sum(seconds.values())
    print(f"[phase 8] {total:.1f} s (budget {PHASE8_BUDGET_S:.0f} s)",
          flush=True)
    return {k: c_a[k] + c_b[k] for k in c_a}, res


# ---- phase 9: the model at widths outside SPECIALISED_WIDTHS --------------
# Each configuration trained and served on the card through Trainer and
# KVModel with seeded random weights; every deepest-scale attention takes
# the general kernels (csrc/attention_general_fwd.cu, _bwd.cu).
#   9a  the flagship's geometry (bench.py: 512^2, 3 stages, res_depth 2, 64
#       input channels, 17 classes) at feat_root 12: C 96, Cb 12, T 4096;
#       train bf16 at flat_scales 3, serve the bench page in f32 at fs 0
#       and fs 3;
#   9b  the reference defaults (6 scales, res_depth 3) at feat_root 16: C
#       512, Cb 64, T 256 at 512^2; train f32 at fs 0, serve the bench
#       page, its f32 logits against the host CPU's (float64);
#   9c  config 5's geometry (1024^2, batch 2, remat, fs 2) at feat_root 12:
#       the streaming pair at C 96, T 16384; train bf16;
#   9d  pool_size 3, feat_root 8, 4 scales, fs 0 at 486^2: C 216, Cb 27, T
#       324; train f32, serve the bench page (T 361 in the 512 bucket), its
#       f32 logits against the host CPU's (float64).
P9_FLAGSHIP = dict(FLAGSHIP, feat_root=12)
P9_DEFAULTS = dict(MIGRATED_DEFAULTS, feat_root=16)
P9_CONFIG5 = dict(CONFIG5, feat_root=12)
P9_POOL3 = dict(FLAGSHIP, pool_size=3, flat_scales=0)
# (batch, side, steps) of each train run
P9_TRAIN = {"9a": (16, 512, 5), "9b": (4, 512, 5), "9c": (2, 1024, 3),
            "9d": (4, 486, 3)}
# Adam's step on the bench's structured batch: at 1e-3 the loss falls in
# three steps in bf16 too (the bench's 1e-4 takes up to 20 there)
P9_LR = 1e-3
# the deepest attention's launches per train step: 3 stages, the last
# stage's output feeds no gradient (2 backwards); with remat each stage's
# forward runs twice (config 5)
P9_PER_STEP = {"resident_attention_fwd": 3, "resident_attention_bwd": 2}
P9_PER_STEP_REMAT = {"fused_attention_fwd": 6, "fused_attention_bwd": 2}
# 9a's launches per request at fs 3: the flagship's, but its residual
# blocks at 12, 24 and 48 channels are outside ops/flatres.py:
# FUSED_CHANNELS, so each of the 18 runs as two flat convs
P9_SERVE_FS3 = {**SERVE_PER_REQUEST[3], "flat_conv2d": 21 + 36,
                "flat_res_block": 0}
# the card's f32 logits on a page against the host CPU's forward in
# float64 (9b, 9d; the CPU's f32 forward, reported beside it, carries its
# own f32 error: 8.8e-5 from the card at pool 3 in one run) and fs 3
# against fs 0 (9a, at 64x64): phase 8a's bound
P9_LOGITS_TOL = 1e-4
PHASE9_BUDGET_S = 240.0


def _p9_train(dev, label, model_kwargs, dtype, run, per_step, total,
              general):
    """P9_TRAIN[run] steps through Trainer on the bench's structured batch
    with the launch counters reset just before and read just after: the
    attention's launches per step held to ``per_step``, each a general
    kernel's; every loss finite, the last below the first -> record; the
    launches added into ``total`` and ``general``."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops
    from msau_tpu_torch.config import ModelConfig, TrainConfig
    from msau_tpu_torch.data.synth import make_structured_batch
    from msau_tpu_torch.train.trainer import Trainer

    bs, hw, steps = P9_TRAIN[run]
    x, y = make_structured_batch(np.random.default_rng(0), bs, hw, 17, 64)
    tr = Trainer(ModelConfig(**model_kwargs, dtype=dtype),
                 TrainConfig(learning_rate=P9_LR, lr_decay_staircase=False),
                 device=dev)
    tr.init_state(x, seed=0)
    batch = tr.put_batch({"input": x, "label": y,
                          "valid": np.ones(y.shape, bool)})
    batch["input"] = batch["input"].to(tr.model.compute_dtype)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    losses, t0 = [], time.perf_counter()
    for _ in range(steps):
        tr.state, metrics = tr.train_step(tr.state, batch)
        losses.append(float(metrics["loss"]))
    seconds = time.perf_counter() - t0
    counts, gen = ops.launch_counts(), ops.general_launch_counts()
    for name, want in per_step.items():
        if counts[name] != want * steps or gen[f"{name}_general"] != want * steps:
            raise AssertionError(
                f"phase {run} {label}: {name} launched {counts[name]} times "
                f"({gen[f'{name}_general']} general) in {steps} steps, want "
                f"{want * steps}")
    for name, n in counts.items():
        total[name] += n
    for name, n in gen.items():
        general[name] += n
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"phase {run} {label}: losses {losses}")
    rec = {"losses": losses, "steps": steps, "batch": bs, "side": hw,
           "s_per_step_with_first": seconds / steps,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
           "launches_per_step": {k: v / steps for k, v in counts.items() if v}}
    print(f"[phase {run}] {label} {dtype} bs {bs} {hw}^2: {steps} steps, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"{rec['s_per_step_with_first']:.3f} s/step (first included), peak "
          f"{rec['peak_mem_gib']:.2f} GiB; launches/step "
          f"{rec['launches_per_step']}", flush=True)
    del tr, batch, metrics
    torch.cuda.empty_cache()
    return rec


def _p9_serve(dev, run, label, model_kwargs, fs, page, total, general,
              cpu_logits=False):
    """One f32 KVModel (seeded weights) on the bench page: one request with
    its launches held to SERVE_PER_REQUEST[fs] (P9_SERVE_FS3 for 9a at fs
    3), the attention's all general,
    the decode check; with ``cpu_logits``, its logits on the page's 512^2
    chargrid against the host CPU's within P9_LOGITS_TOL -> (kv, record)."""
    import torch

    from msau_tpu_torch import ops

    kv = _bench_kv(dict(model_kwargs, flat_scales=fs), "float32", dev, 512,
                   page)
    phase = f"phase {run}"
    per_request = P9_SERVE_FS3 if fs == 3 else SERVE_PER_REQUEST[fs]
    p50 = _serve_requests(kv, page, 1, per_request, label, total,
                          phase=phase)
    gen = ops.general_launch_counts()
    if gen["resident_attention_fwd_general"] != 3:
        raise AssertionError(f"{phase} {label}: general attention launches "
                             f"{gen}")
    for name, n in gen.items():
        general[name] += n
    check, _ = _decode_check(kv, page, 512, dev, label, phase=phase)
    rec = {"p50_ms": p50, "check": check}
    if cpu_logits:
        x = _page_chargrid(kv, page, 512, dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            card = kv.model(x)[1][0].cpu()
            host = _cpu_twin(kv)(x.cpu())[1][0]
        exact = _exact_probs(kv, x[0], index=1)
        err = rec["logits_card_vs_cpu_f64_max_abs_err"] = _max_abs(card,
                                                                   exact)
        rec["logits_card_vs_cpu_f32_max_abs_err"] = _max_abs(card, host)
        rec["logits_cpu_f32_vs_f64_max_abs_err"] = _max_abs(host, exact)
        rec["logits_max_abs"] = float(exact.abs().max())
        rec["cpu_seconds"] = time.perf_counter() - t0
        print(f"[{phase}] {label}: f32 logits at 512^2 against the host "
              f"CPU's float64 forward: max abs err {err:.3e} (tol "
              f"{P9_LOGITS_TOL}; largest |logit| {rec['logits_max_abs']:.3f}"
              f"); the CPU's f32 forward lies "
              f"{rec['logits_cpu_f32_vs_f64_max_abs_err']:.3e} from it and "
              f"{rec['logits_card_vs_cpu_f32_max_abs_err']:.3e} from the "
              f"card; {rec['cpu_seconds']:.1f} s", flush=True)
        if not err <= P9_LOGITS_TOL:
            raise AssertionError(f"{phase} {label}: card vs CPU float64 "
                                 f"logits max abs err {err}")
    print(f"[{phase}] {label} predict p50 ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in p50.items()), flush=True)
    return kv, rec


def phase9(dev):
    """Phase 9, the model at widths outside SPECIALISED_WIDTHS (9a-9d
    above) -> (launches by kernel, general launches by general kernel,
    record with each sub-phase's seconds)."""
    import numpy as np
    import torch

    from msau_tpu_torch import ops

    total = {k: 0 for k in ops.KERNEL_WRAPPERS}
    general = {k: 0 for k in ops.GENERAL_ATTENTION}
    page = _bench_page()
    seconds, res = {}, {}
    t_start = time.perf_counter()

    def sub(name, fn, *args):
        t0 = time.perf_counter()
        got = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase {name}] {seconds[name]:.1f} s", flush=True)
        return got

    def run_9a():
        rec = {"train": _p9_train(dev, "feat_root 12 fs=3",
                                  dict(P9_FLAGSHIP, flat_scales=3),
                                  "bfloat16", "9a", P9_PER_STEP, total,
                                  general)}
        models = {}
        for fs in (0, 3):
            models[fs], rec[f"serve_fs{fs}"] = _p9_serve(
                dev, "9a", f"feat_root 12 fs={fs} float32", P9_FLAGSHIP, fs,
                page, total, general)
        ids = np.random.default_rng(1).integers(0, 64, (1, 64, 64))
        x = torch.from_numpy(np.eye(64, dtype=np.float32)[ids]).to(dev)
        with torch.inference_mode():
            out = {fs: kv.model(x) for fs, kv in models.items()}
        for i, what in ((1, "logits"), (0, "probs")):
            err = rec[f"fs3_vs_fs0_64x64_{what}_max_abs_err"] = _max_abs(
                out[3][i], out[0][i])
            print(f"[phase 9a] f32 {what} at 64x64, fs 3 vs fs 0: max abs "
                  f"err {err:.3e} (tol {P9_LOGITS_TOL})", flush=True)
            if not err <= P9_LOGITS_TOL:
                raise AssertionError(f"phase 9a: fs 3 vs fs 0 {what} {err}")
        return rec

    def run_9b():
        rec = {"train": _p9_train(dev, "reference defaults at feat_root 16",
                                  P9_DEFAULTS, "float32", "9b", P9_PER_STEP,
                                  total, general)}
        _, rec["serve"] = _p9_serve(dev, "9b", "reference defaults at "
                                    "feat_root 16 fs=0 float32", P9_DEFAULTS,
                                    0, page, total, general, cpu_logits=True)
        return rec

    def run_9c():
        return {"train": _p9_train(dev, "config 5 at feat_root 12",
                                   P9_CONFIG5, "bfloat16", "9c",
                                   P9_PER_STEP_REMAT, total, general)}

    def run_9d():
        rec = {"train": _p9_train(dev, "pool 3 fs=0", P9_POOL3, "float32",
                                  "9d", P9_PER_STEP, total, general)}
        _, rec["serve"] = _p9_serve(dev, "9d", "pool 3 fs=0 float32",
                                    P9_POOL3, 0, page, total, general,
                                    cpu_logits=True)
        return rec

    for name, fn in (("9a", run_9a), ("9b", run_9b), ("9c", run_9c),
                     ("9d", run_9d)):
        res[name] = sub(name, fn)
        torch.cuda.empty_cache()
    res["seconds"] = seconds
    elapsed = time.perf_counter() - t_start
    print(f"[phase 9] {elapsed:.1f} s (limit {PHASE9_BUDGET_S:.0f} s); "
          f"general launches {general}", flush=True)
    missing = [k for k, v in general.items() if not v]
    if missing:
        raise AssertionError(f"phase 9: {missing} did not launch")
    if elapsed > PHASE9_BUDGET_S:
        raise AssertionError(f"phase 9 took {elapsed:.0f} s, past its limit "
                             f"of {PHASE9_BUDGET_S:.0f} s")
    return total, general, res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from msau_tpu_torch.ops import cuda_lib
    except ImportError as e:
        print(f"chip_smoke: the msau_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    dev = torch.device("cuda", 0)
    print(f"[phase 0] card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"[phase 0] kernels built in {lib.build_seconds:.1f} s "
          f"({time.perf_counter() - t0:.1f} s with loading): {lib.path.name}",
          flush=True)
    from msau_tpu_torch import native
    print(f"[phase 0] rasterizer core: native_available() "
          f"{native.native_available()}, {native.BUILD_INFO}", flush=True)

    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"[{name}] done in {seconds[name]:.1f} s", flush=True)
        return out

    kernels = timed("phase 1 serve kernels", check_kernels, dev)
    kernels["ccl_multiclass"]["page_axis"] = timed(
        "phase 1 ccl page axis", check_ccl_batched, dev)
    kernels.update(timed("phase 1 attention", check_attention_kernels, dev))
    kernels.update(timed("phase 1 train kernels", check_train_kernels, dev))
    kernels.update(timed("phase 1 box conv", check_box_kernels, dev))
    kernels.update(timed("phase 1 streaming attention",
                         check_fused_attention, dev))
    kernels.update(timed("phase 1 general attention",
                         check_attention_widths, dev))
    kernels.update(timed("phase 1 flat kernels", check_flat_kernels, dev))
    kernels.update(timed("phase 1 flat backward kernels",
                         check_flat_bwd_kernels, dev))
    sums = timed("phase 1 partial sums", partial_sums, dev)
    counts, timings, checks = timed("phase 2 512^2", serve_path, dev)
    counts_1024, timings_1024, checks_1024 = timed(
        "phase 2 1024^2", serve_path_1024, dev)
    counts_batch, timings_batch, checks_batch = timed(
        "phase 2c batched serve", serve_batch, dev)
    counts_eval, checks["field_eval"] = timed("phase 2d field evaluation",
                                              field_eval, dev)
    counts = {k: counts[k] + counts_1024[k] + counts_batch[k] + counts_eval[k]
              for k in counts}
    timings.update(timings_1024)
    timings.update(timings_batch)
    checks.update(checks_1024)
    checks.update(checks_batch)
    train_counts, train = timed("phase 3 train", train_path, dev)
    checks["train_step"] = timed("phase 3 step check", train_step_check, dev)
    if not (counts["fused_attention_fwd"] and train_counts["fused_attention_fwd"]):
        raise AssertionError("the streaming attention did not launch in both "
                             "the serve and the train phase")
    print(f"[phase 3] launches: serve {counts}, train {train_counts}",
          flush=True)
    var_train_counts, variants = timed("phase 4a, 4d variants train",
                                       variants_train, dev)
    checks["variant_step"] = timed("phase 4b variant step check",
                                   variant_step_check, dev)
    var_serve_counts, timings["bmsau_f32"], checks["bmsau_serve"] = timed(
        "phase 4c BMSAU serve", variant_serve, dev)
    entry_counts, entry_seconds = timed("phase 4e entry A", entry_a, dev)
    for name, phase_counts in (
            ("resident_attention_fwd", var_train_counts),
            ("resident_attention_bwd", var_train_counts),
            ("masked_ce_fwd", var_train_counts),
            ("masked_ce_bwd", var_train_counts),
            ("box_conv_fwd", var_train_counts),
            ("box_conv_bwd", var_train_counts),
            ("box_conv_fwd", var_serve_counts),
            ("paint", var_serve_counts), ("ccl_multiclass", var_serve_counts),
            ("paint", entry_counts)):
        if not phase_counts[name]:
            raise AssertionError(f"phase 4: {name} did not launch")
    phase4 = {k: var_train_counts[k] + var_serve_counts[k] + entry_counts[k]
              for k in counts}
    print(f"[phase 4] launches: {phase4}", flush=True)
    checks["entry_b_parity"] = timed("phase 5a entry B parity",
                                     entry_b_parity, dev)
    phase5, entry_b_res = timed("phase 5b, 5c entry B", entry_b, dev)
    print(f"[phase 5] launches: {phase5}", flush=True)
    sp_counts, sp_res = timed("phase 6a spatial shards", spatial_shards_check,
                              dev)
    one_counts, one_res = timed("phase 6b, 6c world of one", world_of_one,
                                dev)
    phase6 = {k: sp_counts[k] + one_counts[k] for k in counts}
    print(f"[phase 6] launches: {phase6}", flush=True)
    phase7_counts, phase7_errs, phase7_res = timed(
        "phase 7 trained end-to-end", phase7, dev)
    print(f"[phase 7] launches: {phase7_counts}", flush=True)
    # 7d held kernels at this phase's shapes: their f32 errors join the
    # line's (7d's own launches compare and are not counted)
    for name, rec in phase7_errs.items():
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"],
                                           rec["max_abs_err"])
    phase8_counts, phase8_res = timed("phase 8 last modules", phase8, dev)
    print(f"[phase 8] launches: {phase8_counts}", flush=True)
    phase9_counts, phase9_general, phase9_res = timed(
        "phase 9 widths", phase9, dev)
    print(f"[phase 9] launches: {phase9_counts}", flush=True)
    launches = {k: counts[k] + train_counts[k] + phase4[k] + phase5[k]
                + phase6[k] + phase7_counts[k] + phase8_counts[k]
                + phase9_counts[k] for k in counts}
    # the general kernels run in phase 9 alone
    launches.update(phase9_general)

    sources = {
        "paint": ("msau_tpu_torch/csrc/paint.cu",
                  "msau_tpu/ops/paint_pallas.py:25"),
        "resident_attention_fwd": ("msau_tpu_torch/csrc/attention.cu",
                                   "msau_tpu/ops/pallas_attn.py:238"),
        "ccl_multiclass": ("msau_tpu_torch/csrc/ccl.cu",
                           "msau_tpu/ops/ccl.py:337"),
        "resident_attention_bwd": ("msau_tpu_torch/csrc/attention_bwd.cu",
                                   "msau_tpu/ops/pallas_attn.py:262"),
        "masked_ce_fwd": ("msau_tpu_torch/csrc/ce_loss.cu",
                          "msau_tpu/ops/ce_loss.py:39"),
        "masked_ce_bwd": ("msau_tpu_torch/csrc/ce_loss.cu",
                          "msau_tpu/ops/ce_loss.py:61"),
        # no Pallas kernel: the JAX package's box filter is XLA (two banded
        # einsums over the integral image)
        "box_conv_fwd": ("msau_tpu_torch/csrc/boxconv.cu",
                         "msau_tpu/ops/boxconv.py:56 (XLA)"),
        "box_conv_bwd": ("msau_tpu_torch/csrc/boxconv.cu",
                         "msau_tpu/ops/boxconv.py:56 (XLA, autodiff)"),
        **FLAT_KERNELS,
        **{name: v[:2] for name, v in FLAT_BWD_KERNELS.items()},
        "fused_attention_fwd": ("msau_tpu_torch/csrc/attention.cu",
                                "msau_tpu/ops/pallas_attn.py:41 (and :66)"),
        # the rows kernel's second use: the JAX package's streaming backward
        # (pallas_attn.py:158) is blockwise XLA with this kernel's formula
        "fused_attention_bwd": ("msau_tpu_torch/csrc/attention_bwd.cu",
                                "msau_tpu/ops/pallas_attn.py:262"),
        # every width outside SPECIALISED_WIDTHS: the general kernels,
        # through the same four entry points
        "resident_attention_fwd_general": (
            "msau_tpu_torch/csrc/attention_general_fwd.cu",
            "msau_tpu/ops/pallas_attn.py:238"),
        "resident_attention_bwd_general": (
            "msau_tpu_torch/csrc/attention_general_bwd.cu",
            "msau_tpu/ops/pallas_attn.py:262"),
        "fused_attention_fwd_general": (
            "msau_tpu_torch/csrc/attention_general_fwd.cu",
            "msau_tpu/ops/pallas_attn.py:41 (and :66)"),
        "fused_attention_bwd_general": (
            "msau_tpu_torch/csrc/attention_general_bwd.cu",
            "msau_tpu/ops/pallas_attn.py:262"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound"][0],
         "bound_by": kernels[name]["bound"][1],
         "library_ms": kernels[name]["library_ms"]}
        for name, (src, rep) in sources.items()]}
    report = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda, "build_seconds": lib.build_seconds,
              "ptxas": lib.build_log, "seconds": seconds, "timer": TIMER,
              "kernels": kernels, "partial_sums": sums,
              "launches": {"serve": counts, "train": train_counts,
                           "variants": phase4, "entry_b": phase5,
                           "parallel": phase6,
                           "trained_end_to_end": phase7_counts,
                           "last_modules": phase8_counts,
                           "widths": phase9_counts,
                           "widths_general": phase9_general},
              "predict_p50_ms": timings, "train": train,
              "variants": variants, "entry_a_seconds": entry_seconds,
              "entry_b": entry_b_res, "spatial_shards": sp_res,
              "world_of_one": one_res,
              "trained_end_to_end": {**phase7_res, "kernels": phase7_errs},
              "last_modules": phase8_res, "widths": phase9_res,
              "checks": checks}
    with open(cuda_lib.BUILD_DIR.parent / "chip_smoke.json", "w") as f:
        json.dump(report, f, indent=1)
    print(f"[timer] {TIMER['profiler_calls']} calls timed by torch.profiler, "
          f"{TIMER['event_calls']} by CUDA events", flush=True)
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
