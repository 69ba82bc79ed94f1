"""Smoke run of fft_tpu_torch on one NVIDIA GPU: the tiny LM's serving and
training paths at full width (6 layers, d=512, 8 heads, seq 2048; training
also at seq 8192, where the direct kernels take #6 and #10),
BASELINE config 1's non-causal block (B=8, L=1024, d=512) forward and
backward, the same block past n_fft 2048 (kernels #3 and #4), and BASELINE
config 4, SPECTRE-350M at seq 16384 (24 layers, d=1024, 16 heads, vocab
50432), serving and training, and at seq 32768 and 65536 in fp32 and in
bf16 (#7's and #11's bf16 instances), with both LMs' decode through kernel
#12, and in bf16 (ROADMAP item 3b) the tiny LM, the config-1 block at
n_fft 1024-65536 and the 350M's prompts of 512 and 600 tokens (the bf16
instances of #6, #10 and #1-#4), BASELINE config 3, the ViT
(train-vit), and config 5, the hybrid SPECTRE + sliding-window LM (the
tiny one in fp32 and bf16, the 1B at seq 32768 in bf16: training,
scoring, hybrid_generate, train-hybrid), and the parallel paths of
fft_tpu_torch/parallel (DP, head TP, both SP mixes, causal SP, the
hybrid's halo CP, GPipe) on a 1-rank NCCL group, random weights from seed
0, through the port's own entry points.  The
tiny LM's causal mix runs kernels #8 kf_spectra and #6 fused_causal_mix as
shared-memory FFTs and its backward #10 fused_causal_mix_bwd as FFTs and
bin-major sums (csrc/causal_fft.cu); their direct kernels
(csrc/causal.cu: kf_spectra_direct, fused_causal_mix_direct;
csrc/causal_bwd.cu: fused_causal_mix_bwd_direct), which the wrappers take
for shapes the FFT kernels do not take, are checked and timed beside them
in phase 2 and must not launch on the tiny LM's paths at seq 2048; at seq
8192 (phase 6c) the direct #6 and #10 are its path.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is nonzero:

1. build     compile and load the CUDA kernels from fft_tpu_torch/csrc.
2. kernels   each kernel against its plain PyTorch version on the card at
             the slices' shapes (rel_err = max|a-b| / max|b| <= 2e-5, each
             output of the backward on its own), with the median ms of both
             over CUDA events (ms: back-to-back calls, so a call the host
             launches more slowly than the card runs it counts the host's
             time) and the device-busy ms from torch.profiler
             (device_ms; plain_device_ms in a kernel's main case; each
             with its *_source: "profiler", or "events" where two
             profiles held no CUDA span, utils/prof.py's read_profile),
             the median ms of one PyTorch composition of the same function
             where there is one (library_ms, and its device-busy ms in the
             main case, library_device_ms; cuFFT), and the least time the
             card could take (bound_ms, bound_by: utils/prof.py's work
             model of the kernel, bytes over 3.35 TB/s or FFT-equivalent
             operations over 67 TFLOP/s fp32).
             direct_mix (#1) and direct_mix_bwd (#2) also at every n_fft
             up to 2048 that the layer fuses, with gate groups of 1, 3, 6,
             16 and 64 channels (kernels_direct_sweep), and staged_mix
             (#3) at every n_fft = 256 m, m = 9..32, untimed; #1 and #2 at
             n_fft 512-2048, #3 at 4096 x 2 and 8192 x 1 and twopass_mix
             (#4) at 16384-65536 over every plan of their kernels
             (kernels_mix_plan_sweep; #1, #3 and #4 share
             csrc/mix_fft.cuh) and by CUDA kernel, #1 and #2 at config 1
             (kernels_mix_launch_split).  #8 and #6 at the tiny LM's shapes (B=4, n_fft
             2048, C=128, L=512; nc 8 and 16, d=512, 32 gate columns)
             through the FFT kernel, the direct kernel and, for #6, #7's
             kernel (fused_causal_mix_v3, which takes chunk 128 too), all
             in one call; then the FFT kernels over the tile plans that
             fit shared memory (kernels_tile_sweep).  #10 at the tiny LM's
             training batch (B=8, nc 16 and 8) through its FFT kernel, its
             direct kernel and #11's, and at C=384 (2C = 256 * 3), Kbar
             exactly 0 where c < delta; then #10's FFT kernel over its
             plans and #9 over its blocks (kernels_bwd_seg_sweep).  #7 and
             #11 (causal_long.cu, three launches each: segment FFTs, the
             bin-major banded sum in place, one inverse FFT a chunk) at the
             350M's layer (nc 8, C 2048), its prompts (nc 4; nc 1 at C
             1024) and nc 4 at C 1024, then over their transform tile plans
             at the 350M's layer (kernels_long_tile_sweep), and their
             device time by CUDA kernel at those shapes, #7's at C 128,
             nc 16, #10 (all three kernels) at the tiny LM's training
             shape and #9 at the 350M's (kernels_launch_split).  #5
             (banded_fft_kernel, csrc/causal.cu) at the CLI's prompt (B=4,
             C=4 and 100, d=512) and the 350M's prompts (B=1, d=1024, 64
             columns, C in BANDED_LONG_CHUNKS: 2C a power of two, with an
             odd factor, Bluestein at M = 4096, 8192, 16384), beside the
             banded sum and torch.fft.irfft (library_ms); over its tile
             plans (kernels_banded_plan_sweep); by CUDA kernel with the
             direct #6 (kernels_banded_launch_split); its wrapper's host
             time piece by piece (kernels_banded_host_split).  #9, #7 and
             #11 at the 350M's layer at seq 32768 and 65536 (nc 16 and
             32, long_nc_cases), #7 and #11 also through their bf16
             instances on the same inputs rounded to bf16 (rel_err <=
             1e-2 on the bf16 outputs; fewer timed calls).  The bf16
             instances of #6 (the FFT kernel at B=4 nc=16 C=128 d=512 and
             nc=1 C=512 d=1024; the direct kernel at nc=1 C=600), #10 (B=8
             nc=16), #1 and #2 (B=8 N=1024), #3 (4096 x 2, 8192 x 1) and #4
             (16384, 65536 x 1) against their plain versions on the same
             bf16 inputs (1e-2 on bf16 outputs, 2e-5 on fp32 ones), each
             timed beside its fp32 instance on the same values (fp32_ms,
             fp32_device_ms), the bound with v, ybar, y and vbar at 2
             bytes.  The direct #6 (segment FFTs, csrc/segment_fft.cuh,
             then #5's body) at the 350M's prompts (B=1, d=1024, 64
             columns: nc=1 C=600, its main case, and 853; nc=2 C=600)
             beside its cuFFT composition (lib_direct6), at every chunk
             128-853 that has no FFT #6 plan at that width, parity only
             (kernels_direct6_sweep).  The direct #10 (csrc/causal_bwd.cu,
             fp32 and bf16) at the tiny LM's 8 x 8192 (nc 64, its main
             case) and 8 x 6144, the tiny hybrid's nc 64 (C=256), the
             350M's 600- and 853-token chunks, with Kbar exactly 0 where
             c < delta and the same bits on a second run, timed beside
             its first design (FIRST_DIRECT10, built on its own: parent_ms)
             and lib_direct6_bwd; side by side with #10's FFT kernel at nc
             16 and 32; #8 at n_fft 8192 and the direct #6 at nc 64, which
             run before it at 8 x 8192; its device time by CUDA kernel
             (kernels_bwd_direct_split) and its lag-tile plans
             (kernels_bwd_direct_sweep) at 8 x 8192 (bwd_direct_cases).
3. score     lm_apply on 4 x 2048 tokens; logits within rel_err 1e-4 of
             the same model and weights on the CPU (where the kernels'
             plain versions run); tokens/s on the card, and 3 calls under
             torch.profiler (device time by kernel, idle share).
4. generate  lm_generate on 4 prompts of 1024 tokens for 64 greedy steps,
             fused_decode_mix launched once a layer per decode step;
             prefill logits and 8 teacher-forced decode logits against the
             CPU; prefill ms and decode ms/token with the fused branch
             (kernels.decode.ENABLE) and with the plain one, in turns, and
             a profile of 8 steps of each; then the CLI's generate on its
             default 4-byte prompt.
5. launches  every kernel of the serving path was launched during phases
             3-4, and no direct-DFT kernel (TINY_DIRECT) was.
   4c.       (run after 5, on launch counts of their own) one tiny-LM block
             (B=4, d=512, 8 heads, n_fft 2048): prefill 2048 tokens, then
             64 fused decode steps past the window's wrap; outputs, the
             final prefix and the query sum within rel_err 2e-5 of the
             CPU's.
   4d.       a 2-layer causal LM at the tiny width with DCT pooling and the
             "window" decode descriptor: lm_apply and 8 teacher-forced
             decode steps within 1e-4 of the CPU.  kf_spectra,
             fused_causal_mix and fused_decode_mix were launched during
             4c-4d, and no direct-DFT kernel was.
6. train     one train_step at 2 x 2048: loss and every parameter gradient
             within rel_err 1e-4 of the same model and batch on the CPU,
             with the CPU's modReLUs on the card's side of their kinks (see
             same_modrelu_side);
             5 steps at 8 x 2048 (step ms, training tokens/s, peak device
             memory; fused_causal_mix_bwd launched once a layer a step,
             its direct kernel never) and 2 under torch.profiler (#10's
             kernels' device time on its own); the CLI's train-lm for 3
             steps.  Every kernel of the training path (kf_spectra,
             fused_causal_mix and its backward) was launched during the
             phase, and no direct-DFT kernel was.
   6b.       (launch counts of its own) the tiny LM in bf16 (--bf16):
             a train_step at 2 x 2048 on the card against the same bf16
             model on the CPU on the card's modReLU sides (loss 1e-2,
             logits 2e-2, each gradient 4e-2, max-wise), with #6 and #10
             by their plain versions on the card passing and a #10 whose
             Kbar drops its farthest lag failing the same check; scoring
             4 x 2048, prefill 4 x 1024, 32 decode steps at B=4, the CLI's
             generate --bf16, 4 train steps at 8 x 2048 (median of steps
             2-3, peak memory) and one profiled, train-lm --bf16; #8, the
             bf16 instances of #6 and #10, #5 and #12 launched, and no
             fp32 instance of #6 or #10 and no direct kernel.
   6c.       (launch counts of its own) the tiny LM at seq 8192 (nc 64:
             #8 at n_fft 8192, the direct #6 and the direct #10, each in
             the mode's instance; #10's FFT kernel never): parity of 2
             layers at full width, a train_step at 1 x 8192 against the
             CPU (fp32: 1e-4; bf16: bf16_model_ok, with #6 and #10 by their
             plain versions passing and a #10 whose Kbar drops its nearest
             lag failing; its farthest lag's fault reported), 5 steps at 8
             x 8192 at full depth in fp32 and bf16 (step ms, peak memory,
             one profiled: busy, idle, the direct #10's and #6's device ms
             and share), the CLI's train-lm --preset tiny --seq 8192
             --bf16 for 2 steps (phase_tiny_long).
7. block     BASELINE config 1's block (fft_impl="pallas", mean pooling,
             memory 16, fp32): forward within rel_err 2e-5 of the same
             weights and input on the CPU, every parameter gradient of
             sum(y^2) within 1e-4 (modReLU kink sides aligned); 5 timed
             steps of forward, backward and update through
             fft_tpu_torch.bench.run (step ms, tokens/s, peak memory) and
             3 profiled (device busy ms a step); the bench's CLI once;
             the same block at n_fft = L = 1536 (256 * 3), B=4, with the
             same parity limits, on the fused branch, direct_mix and
             direct_mix_bwd launched; the same block with the original
             constructor's defaults (DCT pooling, wavelet rate 0.1, no
             memory) for one finite training step and eval-mode forward
             parity with the CPU.  Both spectral-mix kernels were launched
             during the phase.  Then one forward of a block at n_fft
             16384 (B=1, N=16384, d=512, fft_impl="pallas") within 2e-5 of
             the CPU, on the d-wide composition (MIX_BRANCH_CALLS "wide").
   7b.       (launch counts of its own) the config-1 block at n_fft = L =
             4096, B=2 and 8192, B=1 (fft_impl="pallas": staged_mix, #3,
             forward; autograd through unfused_mix backward): forward
             within 2e-5 and every gradient within 1e-4 of the CPU, the
             fused branch taken, 5 timed steps through bench.run (step ms,
             tokens/s, peak memory) and 3 profiled; the mix's backward
             alone (ms) beside the gate product and irfft of the forward
             that its autograd re-runs and drops.  staged_mix was
             launched and direct_mix_bwd was not.
   7c.       (launch counts of its own) with kernels.spectral_mix.
             TWOPASS_ENABLE on (restored after): block forwards at n_fft
             16384 and 65536, B=1, within 2e-5 of the CPU on the fused
             branch (twopass_mix, #4); then at 16384, 32768 and 65536 the
             block's forward ms with the flag on and off in turns, the
             fused branch's mem_t ms, and a profile of the forward with
             each.  twopass_mix was launched once in each block forward
             with the flag on (phase 2 times #4 alone against cuFFT).
   7d.       (launch counts of its own) the config-1 block in bf16, as
             bench.py builds it: against the same bf16 block on the CPU
             (output 2e-2, each gradient 4e-2, max-wise), with #1 and #2
             by their plain versions on the card passing and a #2 whose
             first gate group's cotangent is dropped failing; 5 steps and
             3 profiled through bench.run; python -m fft_tpu_torch.bench;
             4096 x 2 and 8192 x 1 (forward within 2e-2 of the CPU, 3
             steps, 2 profiled); the forward at 16384-65536 with
             TWOPASS_ENABLE on and off in turns (16384 within 2e-2 of the
             CPU).  The bf16 instances of #1-#4 launched, their fp32 ones
             never, #4 once in each forward with the flag on.
8. 350m      SPECTRE-350M (spectre_350m_config, seq 16384, chunk 2048).
             Parity at 2 layers and 8192 tokens (nc=4: kf_seg_rfft, the v3
             mix and its backward): logits, loss and every gradient of a
             train_step within 1e-4 of the CPU; 4 teacher-forced decode
             steps after a 1024-token prefill within 1e-4; a 1500-token
             prompt (chunk 1500, nc=1: banded_inverse, Bluestein): lm_apply
             logits, prefill logits and 2 decode steps within 1e-4, #5 once
             a layer a call.  Then at full
             depth: scoring 1 x 16384 (ms, tokens/s), prefill of 8192 and
             1024 tokens, and of 1500 (ms, and one call profiled: device
             busy ms, idle share; banded_inverse launched once a layer a
             prefill), decode ms/token with the fused and the plain
             branch in turns (and a profile of 4 steps of each), the CLI's
             generate --preset 350m --seq 16384 (fused_decode_mix once a
             layer per decode step), one scoring call and one 1024-token
             prefill under torch.profiler; every serving kernel of the
             slice launched and no causal mix on the plain composition.  3 train_steps at 1 x
             16384 (step ms, tokens/s, peak memory, finite loss), one more
             under torch.profiler (device time by kernel, idle share), the
             CLI's train-lm --preset 350m on a text file (through the
             native loader, which it must say it used); kf_seg_rfft,
             fused_causal_mix_v3 and fused_causal_mix_bwd_v3 launched.
             The profiles report causal_long.cu's kernels' device time on
             its own (matched_ms_per_step).
   8b.       (launch counts of its own) 350m_ckpt, in a temporary HOME:
             train-lm --preset 350m --seq 16384 --batch 1 --steps 4 --ckpt
             DIR --ckpt-every 2 under the supervisor's subprocess runner
             with FFT_TPU_FAULT_STEP=3, on the default BPE corpus (built by
             the first child) through the native loader: one restart from
             the step-2 checkpoint, steps 0-3 logged with finite losses,
             checkpoints 2 and 4 kept.  The step-4 checkpoint restored on
             the card equals its files bit for bit (restore s), then is
             written again (snapshot ms, write s); the corpus is built
             again (BPE s) and must equal the child's; one more step
             resumed in-process (kf_seg_rfft, fused_causal_mix_v3 and its
             backward launched); generate --ckpt DIR --vocab CORPUS
             --steps 8 prints the text of the model restored in-process
             with restore_checkpoint and lm_generate on the same encoded
             prompt, fused_decode_mix launched once a layer per decode step
             and banded_inverse once a layer at the prompt.
   8d.       (launch counts of its own) the 350M at full depth, prefills
             of 512 (bf16), 600 and 853 (bf16 and fp32) and 1500 (bf16)
             tokens (chunk = length, nc = 1: #6's FFT kernel at 512, its
             direct kernel at 600 and 853, #5 at 1500, each once a layer
             a call and no other causal kernel), logits within 2e-2
             (bf16) or 1e-4 (fp32) of the same prefill with that kernel's
             plain version on the card, wall ms and one call profiled.
   8c.       (launch counts of their own) 350m_long: SPECTRE-350M at seq
             32768 and 65536 (chunk 2048, nc 16 and 32), fp32 and bf16.
             Parity at 1 layer, full width, 32768 tokens, every run with
             the modReLU sides of the card's bf16 run: a train_step's
             logits, loss and every gradient against the CPU
             (fp32: 1e-4 max-wise; bf16: the loss within 1e-2, the logits
             within 2e-2 and each gradient within 4e-2 max-wise, and a
             control run on the card whose #11 Kbar drops its farthest lag
             must fail that check), and the card's bf16 loss within 1e-2 of
             its fp32 loss.  Then at full depth, each (seq, mode):
             scoring 1 x S, a prefill of S/2 tokens, 8 decode steps (ms),
             3 train_steps (step ms, peak memory from a reset) and one
             under torch.profiler (busy ms, idle share); fp32 at 32768
             scoring and one step only, at 65536 two steps and no
             profile (the run's time limit); kf_seg on every
             forward, #9, #7 and #11 launched in the mode's instance only
             (the bf16 ones counted apart), #12 once a layer a decode
             step.  Then, in a temporary HOME, the CLI's train-lm
             --preset 350m --seq 65536 --bf16 --batch 1 --steps 2 on the
             default BPE corpus (native loader; finite losses, the second
             not above the first by 5%) and generate --preset 350m --seq
             65536 --bf16.
9. vit       (launch counts of its own) the ViT, BASELINE config 3
             (vit_s_config: 12 layers, d=384, 6 heads, L = 197, 1000
             classes, the per-head cuFFT branch: no hand-written kernel
             launches, which the phase checks): parity at 2 layers, B=32,
             logits, loss and every gradient within 1e-4 of the CPU at the
             wavelet rate 0.1 (eval: off) and 1.0; 6 train-vit steps
             (vit_train_step) with the host's synthetic batch timed apart,
             peak memory, 3 profiled; the CLI's train-vit for 3 steps
             (phase_vit).
10. hybrid   (launch counts of their own) the tiny hybrid in fp32 and
             bf16 (parity of a train step with the CPU: 1e-4, or the bf16
             rule with #6/#10 plain passing and a Kbar fault failing;
             train steps at 1 x 2048, scoring, hybrid_generate, teacher-
             forced decode against the CPU, the CLI's train-hybrid;
             phase_hybrid_tiny), then the 1B hybrid, BASELINE config 5, at
             seq 32768 in bf16, full depth (parity at one group at seq 8192
             under the bf16 rule with #7/#11 plain passing and a Kbar fault
             failing; 3 train steps at 1 x 32768 with peak memory, scoring,
             hybrid_generate, the CLI's train-hybrid --preset 1b;
             phase_hybrid_1b).  #8, #6, #10 (fp32 or bf16) and #12 on the
             tiny hybrid's paths; #9, #7 and #11's bf16 instances and #12
             on the 1B's; phase 2 holds each at these shapes against its
             plain version (hybrid_cases).
11. prof     (launch counts of its own) module 7b: measure_chip_constants
             (HBM, GEMM bf16 / fp32 / TF32 and csrc/probe.cu's fp32 FMA
             rate, each beside its published peak, with the card's name
             and power limit); train-lm and train-hybrid --preset tiny
             --steps 4 --profile DIR, each writing one trace that names
             #8's, #6's and #10's CUDA kernels; bench-mix at the JAX CLI's
             defaults; the tiny LM untied (tie_embeddings=False) at full
             width, a train step at 2 x 2048 and scoring within 1e-4 of
             the CPU; the config-1 block with fft_impl="matmul" within
             2e-5 of "auto" (phase_prof).  #8, #6 and #10 launched, no
             direct kernel.
12. parallel (launch counts of its own) module 7c, fft_tpu_torch/parallel,
             on a 1-rank NCCL group that parallel.distributed_init builds
             (explicit rank 0, world 1, a file store in a temporary
             directory; destroyed after): (a) the tiny LM, 8 x 2048 fp32,
             3 train_steps under make_mesh(1, 1, 1) against 3 without a
             mesh (losses and the first step's gradients within 1e-5,
             #8, #6 and #10 launched as often), then the step ms both ways
             in turns; (b) sp_segmented_causal_mix at S = 1 at that width,
             forward and backward, against segmented_causal_mix (2e-5,
             both on kf_fused); (c) sp_spectral_mix and
             sp_spectral_mix_strided at S = 1 at 8 x 1024 and 1 x 8192,
             d=512, forward and backward, against spectral_mix (#1/#2,
             #3; 2e-5), 4 and 2 all-to-alls a direction, with their ms,
             and the config-1 block with the wavelet on under tp_mesh
             (its gathered descriptor) against the block (1e-5);
             (d) a tiny-hybrid hybrid_train_step with cp_mesh (the SWA
             halo hop) against one without (1e-5), and pipeline_apply
             with 1 stage and 2 microbatches over the tiny LM's 6 blocks
             against the plain stack run a microbatch at a time (output
             2e-5, also against the whole batch at once; gradients
             1e-4).  The
             collectives by kind for each path; every kind of
             parallel/comm.py is called (phase_parallel).

Prints one JSON line per phase, the card's name and power limit as
nvidia-smi gives them, a JSON line of per-kernel results, and last
{"ok": true, "device": {...}}.  Without a CUDA device it fails at once.

``tree_compare`` times #5, the direct #6 and the 350M's prefills of 1500
and 600 tokens for whichever tree's ``fft_tpu_torch`` the process imports;
to set two trees side by side in one call, run in each tree's root, in
turns:

    python -c 'import importlib.util as u, sys; sys.path.insert(0, "."); \
      s = u.spec_from_file_location("cs", "PATH/chip_smoke.py"); \
      m = u.module_from_spec(s); s.loader.exec_module(m); m.tree_compare()'
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

import torch

from fft_tpu_torch.utils import prof as fprof

SEED = 0
REL_KERNEL = 2e-5      # direct fp32 DFTs vs cuFFT, different sum orders
REL_MODEL = 1e-4       # 6 layers of fp32 FFT round trips, GPU vs CPU
REL_BLOCK = 2e-5       # one block, fp32 FFTs in another order than the CPU's
REL_DECODE = 2e-5      # decode outputs (COMPONENTS.md 2.4)
# bf16: a kernel's bf16 output against its plain version on the same bf16
# inputs (one rounding to bf16 on each side), and a bf16 model's loss on
# the card against the CPU's and against fp32's (BASELINE.md's bf16
# budget)
REL_BF16 = 1e-2
# bf16: the 2-layer 350M at 32768 tokens on the card against the same bf16
# model on the CPU (phase 8c), each gradient and the logits max-wise.  Two
# sound bf16 runs that round GEMM outputs and LayerNorm inputs apart read
# up to 2.34e-2 on a gradient (q_norm_w, with #7 and #11 run by their
# plain versions on the card) and 1.05e-2 on the logits; a #11 whose Kbar
# misses its farthest lag reads 9.8e-2 (H100 80GB HBM3, 700 W; PERF.md,
# Findings).  The limits sit between; both runs are the check's
# controls (phase_350m_long_parity).
REL_BF16_MODEL = 4e-2
REL_BF16_LOGITS = 2e-2
SOURCES = {
    "direct_mix": "fft_tpu_torch/csrc/spectral_mix.cu",
    "direct_mix_bwd": "fft_tpu_torch/csrc/spectral_mix.cu",
    "kf_spectra": "fft_tpu_torch/csrc/causal_fft.cu",
    "fused_causal_mix": "fft_tpu_torch/csrc/causal_fft.cu",
    "kf_spectra_direct": "fft_tpu_torch/csrc/causal.cu",
    "fused_causal_mix_direct": "fft_tpu_torch/csrc/causal.cu",
    "banded_inverse": "fft_tpu_torch/csrc/causal.cu",
    "fused_causal_mix_bwd": "fft_tpu_torch/csrc/causal_fft.cu",
    "fused_causal_mix_bwd_direct": "fft_tpu_torch/csrc/causal_bwd.cu",
    "fused_causal_mix_bwd_direct_bf16": "fft_tpu_torch/csrc/causal_bwd.cu",
    "kf_seg_rfft": "fft_tpu_torch/csrc/causal_long.cu",
    "fused_causal_mix_v3": "fft_tpu_torch/csrc/causal_long.cu",
    "fused_causal_mix_bwd_v3": "fft_tpu_torch/csrc/causal_long.cu",
    "fused_causal_mix_v3_bf16": "fft_tpu_torch/csrc/causal_long.cu",
    "fused_causal_mix_bwd_v3_bf16": "fft_tpu_torch/csrc/causal_long.cu",
    "fused_decode_mix": "fft_tpu_torch/csrc/decode.cu",
    "staged_mix": "fft_tpu_torch/csrc/staged_mix.cu",
    "twopass_mix": "fft_tpu_torch/csrc/twopass_mix.cu",
    "fused_causal_mix_bf16": "fft_tpu_torch/csrc/causal_fft.cu",
    "fused_causal_mix_direct_bf16": "fft_tpu_torch/csrc/causal.cu",
    "fused_causal_mix_bwd_bf16": "fft_tpu_torch/csrc/causal_fft.cu",
    "direct_mix_bf16": "fft_tpu_torch/csrc/spectral_mix.cu",
    "direct_mix_bwd_bf16": "fft_tpu_torch/csrc/spectral_mix.cu",
    "staged_mix_bf16": "fft_tpu_torch/csrc/staged_mix.cu",
    "twopass_mix_bf16": "fft_tpu_torch/csrc/twopass_mix.cu",
}
REPLACES = {
    "direct_mix": "fft_tpu/kernels/pallas_fft.py:301",
    "direct_mix_bwd": "fft_tpu/kernels/pallas_fft.py:449",
    "kf_spectra": "fft_tpu/kernels/pallas_causal.py:1428",
    "fused_causal_mix": "fft_tpu/kernels/pallas_causal.py:592",
    "kf_spectra_direct": "fft_tpu/kernels/pallas_causal.py:1428",
    "fused_causal_mix_direct": "fft_tpu/kernels/pallas_causal.py:592",
    "banded_inverse": "fft_tpu/kernels/pallas_causal.py:167",
    "fused_causal_mix_bwd": "fft_tpu/kernels/pallas_causal.py:1921",
    "fused_causal_mix_bwd_direct": "fft_tpu/kernels/pallas_causal.py:1921",
    "fused_causal_mix_bwd_direct_bf16":
        "fft_tpu/kernels/pallas_causal.py:1921",
    "kf_seg_rfft": "fft_tpu/kernels/pallas_causal.py:1596",
    "fused_causal_mix_v3": "fft_tpu/kernels/pallas_causal.py:931",
    "fused_causal_mix_bwd_v3": "fft_tpu/kernels/pallas_causal.py:2307",
    "fused_causal_mix_v3_bf16": "fft_tpu/kernels/pallas_causal.py:931",
    "fused_causal_mix_bwd_v3_bf16": "fft_tpu/kernels/pallas_causal.py:2307",
    "fused_decode_mix": "fft_tpu/kernels/pallas_decode.py:71",
    "staged_mix": "fft_tpu/kernels/pallas_fft.py:630",
    "twopass_mix": "fft_tpu/kernels/pallas_fft.py:1156",
    "fused_causal_mix_bf16": "fft_tpu/kernels/pallas_causal.py:592",
    "fused_causal_mix_direct_bf16": "fft_tpu/kernels/pallas_causal.py:592",
    "fused_causal_mix_bwd_bf16": "fft_tpu/kernels/pallas_causal.py:1921",
    "direct_mix_bf16": "fft_tpu/kernels/pallas_fft.py:301",
    "direct_mix_bwd_bf16": "fft_tpu/kernels/pallas_fft.py:449",
    "staged_mix_bf16": "fft_tpu/kernels/pallas_fft.py:630",
    "twopass_mix_bf16": "fft_tpu/kernels/pallas_fft.py:1156",
}
SERVE_KERNELS = ("kf_spectra", "fused_causal_mix", "banded_inverse",
                 "fused_decode_mix")
# phases 4c and 4d: a block's prefill and decode past the wrap, and a
# DCT-pooled LM's scoring, prefill and window-descriptor decode
DECODE_KERNELS = ("kf_spectra", "fused_causal_mix", "fused_decode_mix")
TRAIN_KERNELS = ("kf_spectra", "fused_causal_mix", "fused_causal_mix_bwd")
# the direct-DFT #8, #6 (causal.cu) and #10 (causal_bwd.cu): launched on
# none of the tiny LM's paths (serving, 4c-4d, training), which the FFT
# kernels take
TINY_DIRECT = ("kf_spectra_direct", "fused_causal_mix_direct",
               "fused_causal_mix_bwd_direct")
BLOCK_KERNELS = ("direct_mix", "direct_mix_bwd")
# phase 7b: the block at n_fft 4096/8192 (7c counts #4 per forward)
BLOCK_LONG_KERNELS = ("staged_mix",)
# the 350M's paths at seq 16384: its long-context kernels (the CLI's 4-byte
# prompt runs banded_inverse)
SERVE_350M_KERNELS = ("kf_seg_rfft", "fused_causal_mix_v3", "banded_inverse",
                      "fused_decode_mix")
TRAIN_350M_KERNELS = ("kf_seg_rfft", "fused_causal_mix_v3",
                      "fused_causal_mix_bwd_v3")
# the 350M at seq 32768 and 65536 (phase 8c), fp32 and bf16: #7 and #11
# by their launch names in each mode (the bf16 instances counted apart)
LONG_SEQS = (32768, 65536)
LONG_MIX = {"float32": ("fused_causal_mix_v3", "fused_causal_mix_bwd_v3"),
            "bfloat16": ("fused_causal_mix_v3_bf16",
                         "fused_causal_mix_bwd_v3_bf16")}
OTHER_MODE = {"float32": "bfloat16", "bfloat16": "float32"}
# the bf16 paths of item 3b: the tiny LM in bf16 (#8, the bf16 instances
# of #6 and #10, #5 at the CLI's prompt, #12), the config-1 block in bf16
# (#1, #2; #3 at 4096-8192; #4 at 16384-65536)
TINY_BF16_KERNELS = ("kf_spectra", "fused_causal_mix_bf16",
                     "fused_causal_mix_bwd_bf16", "banded_inverse",
                     "fused_decode_mix")
# the 350M's short prompts (phase 8d, chunk = length, nc = 1): (tokens,
# mode, the one causal kernel launched once a layer a prefill, the wrapper
# run by its plain version for the check, the logits' limit against that
# prefill): the FFT #6 at 512, the direct #6 at 600 and 853 (2C with no FFT
# plan), #5 at 1500
SHORT_350M = (
    (512, "bfloat16", "fused_causal_mix_bf16", "_fused_causal_mix",
     REL_BF16_LOGITS),
    (600, "bfloat16", "fused_causal_mix_direct_bf16", "_fused_causal_mix",
     REL_BF16_LOGITS),
    (600, "float32", "fused_causal_mix_direct", "_fused_causal_mix",
     REL_MODEL),
    (853, "bfloat16", "fused_causal_mix_direct_bf16", "_fused_causal_mix",
     REL_BF16_LOGITS),
    (853, "float32", "fused_causal_mix_direct", "_fused_causal_mix",
     REL_MODEL),
    (1500, "bfloat16", "banded_inverse", "_banded_inverse",
     REL_BF16_LOGITS))
BLOCK_BF16_KERNELS = ("direct_mix_bf16", "direct_mix_bwd_bf16",
                      "staged_mix_bf16", "twopass_mix_bf16")
# #10's CUDA kernels (causal_fft.cu), by name in the tiny LM's training
# profile
BWD_KERNEL_NAMES = ("bwd_window_kernel", "bwd_bins_fft_kernel",
                    "bwd_inverse_kernel")
# causal_long.cu's CUDA kernels (#9, #7, #11), by name in a profile
LONG_KERNEL_NAMES = ("seg_rfft_kernel", "window_fft_kernel",
                     "banded_bins_kernel", "bwd_bins_kernel",
                     "chunk_inverse_kernel")
# what the CLI's train-lm prints when the native C++ loader samples a text
# file (and a BPE stream)
NATIVE_LINE = "using native C++ data loader"
NATIVE_BPE_LINE = "using native C++ data loader (uint16 BPE tokens)"


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def as_float64(a, b) -> tuple:
    """a and b in float64 on one device: the card where both are there (a
    kernel against its plain version; no copy to the host), else the CPU.
    Every operation on them is exact or correctly rounded in float64 on
    either device, so the errors read the same."""
    a, b = a.detach(), b.detach()
    if a.device != b.device:
        a, b = a.cpu(), b.cpu()
    return a.double(), b.double()


def rel_err(a, b) -> float:
    """max|a-b| / max|b|; for tuples of outputs, the worst output's."""
    if isinstance(a, tuple):
        return max(rel_err(x, y) for x, y in zip(a, b))
    a, b = as_float64(a, b)
    return float((a - b).abs().max() / b.abs().max())


def max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x, y) for x, y in zip(a, b))
    a, b = as_float64(a, b)
    return float((a - b).abs().max())


def all_finite(a) -> bool:
    if isinstance(a, tuple):
        return all(all_finite(x) for x in a)
    return bool(torch.isfinite(a).all())


def median_ms(fn, reps: int = 10, rounds: int = 7) -> float:
    """Median over rounds of (CUDA-event time of ``reps`` calls) / reps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, reps: int = 10, key: str = "device_ms") -> dict:
    """{key: device-busy ms a call over ``reps`` calls, key + "_source":
    where it came from}.  From torch.profiler's CUDA kernel spans (their
    union, "profiler"): unlike ``median_ms`` it leaves out the gaps where
    the card waits for the host to launch the next kernel.  Where two
    profiles hold no span, CUDA events' time ("events", gaps included;
    ``fprof.read_profile``), never 0."""
    fn()
    torch.cuda.synchronize()
    rec = fprof.read_profile(fn, torch.cuda.synchronize, reps)
    return {key: rec["device_busy_ms_per_step"],
            key + "_source": rec["device_ms_source"]}


def wall_ms(fn, rounds: int = 5) -> float:
    """Median host wall time of fn() ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_kernels(kc, sm, kd, dev, first):
    """Each kernel vs its plain version at the slices' shapes; ``first``:
    the first design of the direct #10 being built
    (``start_first_direct10``)."""
    g = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    # (kernel name, shape label, kernel fn, plain fn, library fn or None,
    #  the work (fprof.MixCost), main case of the kernel?)
    cases = []
    b, n_fft, chunk, lanes = 4, 2048, 128, 512
    nc = n_fft // chunk
    gr, gi = randn(b, n_fft // 2 + 1, lanes), randn(b, n_fft // 2 + 1, lanes)
    kf_work = fprof.kf_spectra_cost(b, n_fft, chunk, lanes)
    # the two output planes as a tuple (rel_err takes each on its own): a
    # torch.cat would add a copy of 17 MB to the time of a 0.06 ms kernel
    for name, fn in (("kf_spectra", kc.kf_spectra),
                     ("kf_spectra_direct", kc.kf_spectra_direct)):
        cases.append((
            name, f"B={b} n_fft={n_fft} C={chunk} L={lanes}",
            lambda fn=fn: fn(gr, gi, n_fft, chunk),
            lambda: kc.kf_spectra_ref(gr, gi, n_fft, chunk),
            lambda: torch.fft.rfft(torch.fft.irfft(
                torch.complex(gr, gi), n_fft, dim=1).reshape(
                    b, nc, chunk, lanes), 2 * chunk, dim=2),
            kf_work, True))
    d, cols = 512, 32
    for nc in (8, 16):
        v = randn(b, nc * chunk, d)
        kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
        # #7's kernel (causal_long.cu) takes chunk 128 too: a data point
        for name, fn in (
                ("fused_causal_mix", kc.fused_causal_mix),
                ("fused_causal_mix_direct", kc.fused_causal_mix_direct),
                ("fused_causal_mix_v3", lambda *a: kc._launch_mix(
                    "fused_causal_mix_v3", *a))):
            main = nc == 16 and name == "fused_causal_mix"
            cases.append((
                name, f"B={b} nc={nc} C={chunk} d={d} cols={cols}",
                lambda fn=fn, v=v, kr=kr, ki=ki: fn(v, kr, ki, chunk, cols),
                lambda v=v, kr=kr, ki=ki: kc.fused_causal_mix_ref(
                    v, kr, ki, chunk, cols),
                (lambda v=v, kr=kr, ki=ki: lib_direct6(v, kr, ki, chunk,
                                                       cols))
                if name == "fused_causal_mix" else None,
                fprof.fused_causal_mix_cost(b, nc, chunk, d, cols), main))
    cases += bwd_cases(kc, randn)
    cases += banded_cases(kc, randn, b, (4, 100), d, cols)
    cases += long_cases(kc, randn)
    cases += long_nc_cases(kc, randn)
    cases += decode_cases(kd, randn)
    cases += hybrid_cases(kc, kd, randn)
    # the spectral mix: BASELINE config 1 (B=8, N=1024, d=512, H*G=32, with
    # and without memory), then N=2048 and N=256
    for n, mem in ((1024, True), (1024, False), (2048, True), (256, True)):
        cases += mix_cases(sm, randn, 8, n, d, cols, mem,
                           main=(n == 1024 and mem))
    cases += long_mix_cases(sm, randn)
    cases += bf16_causal_cases(kc, randn)
    cases += bf16_mix_cases(sm, randn)
    cases += direct6_cases(kc, randn)
    cases += bwd_direct_cases(kc, first_direct10(first))

    direct_sweep(sm, randn)
    direct6_sweep(kc, randn)
    staged_sweep(sm, randn)
    mix_plan_sweep(sm, randn)
    mix_launch_split(sm, randn)
    tile_sweep(kc, randn)
    long_tile_sweep(kc, randn)
    bwd_seg_sweep(kc, randn)
    long_launch_split(kc, randn)
    banded_plan_sweep(kc, randn)
    banded_launch_split(kc, randn)
    banded_host_split(kc, randn)
    return run_cases(cases)


def run_cases(cases) -> dict:
    """Each case's kernel against its plain version (rel_err within the
    case's limit, finite), then both timed in turns, the library call and
    the bound; emits one line a case and returns them by kernel name."""
    results = {}
    for name, shape, kern, plain, lib, work, main, *opts in cases:
        # opts: {"tol": the limit (REL_KERNEL unless given; a tuple gives
        # each output of a tuple its own), "reps", "rounds": fewer calls
        # timed by events where the plain version is slow; the profiler's
        # device_ms always takes 10 calls, as it reads low on fewer;
        # "fp32": a bf16 instance's fp32 instance on the same values, or
        # "parent": the kernel's earlier design (FIRST_DIRECT10), each
        # timed in the same turns (fp32_ms, fp32_device_ms; parent_ms,
        # parent_device_ms); "slow": the plain version and the library
        # call take tens to hundreds of ms a call, so each is timed by one
        # call a turn and the profiler reads neither}
        opts = opts[0] if opts else {}
        tol = opts.get("tol", REL_KERNEL)
        reps, rounds = opts.get("reps", 10), opts.get("rounds", 7)
        slow = opts.get("slow", False)
        ref_reps, ref_rounds = (1, 1) if slow else (reps, rounds)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if isinstance(tol, tuple):
            errs = [rel_err(a, w) for a, w in zip(got, want)]
            ok = all(e <= t for e, t in zip(errs, tol))
        else:
            errs = [rel_err(got, want)]
            ok = errs[0] <= tol
        err = max(errs)
        abs_err = max_abs(got, want)
        finite = all_finite(got)
        del got, want
        if not (ok and finite):
            raise AssertionError(f"{name} [{shape}]: rel_err {errs} > "
                                 f"{tol} or non-finite")
        # alternate plain, kernel, kernel, plain on the same card (plain,
        # kernel, other, other, kernel, plain where the fp32 instance or
        # the parent design is timed)
        other = next(((k, opts[k]) for k in ("fp32", "parent") if k in opts),
                     None)
        turns = (plain, kern, kern, plain) if other is None else (
            plain, kern, other[1], other[1], kern, plain)
        times = [median_ms(f, *((ref_reps, ref_rounds) if f is plain
                                else (reps, rounds))) for f in turns]
        p1, k1, k2, p2 = times[0], times[1], times[-2], times[-1]
        if other is not None:
            other_case = {other[0] + "_ms": statistics.median(times[2:4]),
                          **device_ms(other[1],
                                      key=other[0] + "_device_ms")}
        bound_ms, bound_by = work.bound()
        case = dict(shape=shape, rel_err=err, tol=tol, max_abs_err=abs_err,
                    **({"rel_errs": errs} if len(errs) > 1 else {}),
                    ms=statistics.median([k1, k2]),
                    plain_ms=statistics.median([p1, p2]),
                    **device_ms(kern),
                    # the profiler's reading of the plain version and the
                    # library call for a kernel's main case only: the
                    # others' took ~30 s of the run's 1200
                    **(device_ms(plain, key="plain_device_ms")
                       if main and not slow else {"plain_device_ms": None}),
                    library_ms=(None if lib is None
                                else median_ms(lib, ref_reps, ref_rounds)),
                    **(device_ms(lib, key="library_device_ms")
                       if lib is not None and main and not slow
                       else {"library_device_ms": None}),
                    bound_ms=bound_ms, bound_by=bound_by, main=main)
        if hasattr(lib, "release"):
            lib.release()            # lib_direct6_bwd's kept graph
        if other is not None:
            case.update(other_case)
        emit(phase="kernels", kernel=name, **case)
        results.setdefault(name, []).append(case)
    return results


def bwd_cases(kc, randn):
    """#10 at the tiny LM's training batch (B=8, C=128, d=512, 32 gate
    columns; nc 16, the main case, and 8) through the FFT kernel, the
    direct kernel and #11's (fused_causal_mix_bwd_v3, which takes chunk 128
    too), all in one call; the FFT and the direct kernel side by side at
    nc 32 (seq 4096, the FFT kernel's last nc at this width); the FFT
    kernel at a chunk that is no power of two (C=384: 2C = 256 * 3).  On
    the first call of each case Kbar must be exactly 0 where c < delta and
    a second run must give the same bits (kbar_checked)."""
    cases = []
    d, cols = 512, 32
    three = ("fused_causal_mix_bwd", "fused_causal_mix_bwd_direct",
             "fused_causal_mix_bwd_v3")
    for b, nc, chunk, names in ((8, 16, 128, three), (8, 8, 128, three),
                                (8, 32, 128, three[:2]),
                                (4, 3, 384, three[:1])):
        v, ybar = randn(b, nc * chunk, d), randn(b, nc * chunk, d)
        kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
        fns = {"fused_causal_mix_bwd": kc.fused_causal_mix_bwd,
               "fused_causal_mix_bwd_direct": kc.fused_causal_mix_bwd_direct,
               "fused_causal_mix_bwd_v3": lambda *a: kc._launch_bwd(
                   "fused_causal_mix_bwd_v3", *a)}
        for name in names:
            kern = kbar_checked(
                lambda name=name, v=v, kr=kr, ki=ki, yb=ybar, c=chunk:
                    fns[name](v, kr, ki, yb, c, cols), b, nc, chunk, cols,
                name)
            main = nc == 16 and name == "fused_causal_mix_bwd"
            cases.append((
                name, f"B={b} nc={nc} C={chunk} d={d} cols={cols}", kern,
                lambda v=v, kr=kr, ki=ki, yb=ybar, c=chunk:
                    kc.fused_causal_mix_bwd_ref(v, kr, ki, yb, c, cols),
                lib_direct6_bwd(v, kr, ki, ybar, chunk, cols)
                if name == "fused_causal_mix_bwd" and chunk == 128 else None,
                fprof.fused_causal_mix_bwd_cost(b, nc, chunk, d, cols), main))
    return cases


# The direct #10 as it stood before its redesign (launches 3-5 as direct
# sums: Kbar with warp shuffles, Vbar a lag a pass, vbar a direct DFT),
# built on its own so that phase 2 times the redesign beside it in one
# call; no path of the port calls it.
FIRST_DIRECT10 = "fft_tpu_torch/csrc/first_designs/causal_bwd.cu"
# (B, nc, C, d, cols) of the direct #10 in phase 2: the tiny LM's training
# at 8 x 8192 (nc 64, the main case) and 8 x 6144 (nc 48), the tiny
# hybrid at seq 16384 (nc 64 of C=256, d=256, 16 columns), the 350M's
# prompts of two 600-token chunks (2C = 1200 = 16 * 75: Bluestein) and of
# 853 tokens (Bluestein)
DIRECT10_SHAPES = ((8, 64, 128, 512, 32), (8, 48, 128, 512, 32),
                   (1, 64, 256, 256, 16), (1, 2, 600, 1024, 64),
                   (1, 1, 853, 1024, 64))


def start_first_direct10():
    """nvcc of FIRST_DIRECT10 into a library of its own under the port's
    build directory, started in the background (beside the port's own
    build); returns (process, library path)."""
    from fft_tpu_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = build.BUILD_DIR / "first_direct10.so"
    src = pathlib.Path(__file__).resolve().parent / FIRST_DIRECT10
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
           str(build.CSRC_DIR), "-o", str(out), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def first_direct10(started):
    """The first design's C entry (FIRST_DIRECT10, fp32 only) as a call
    (v, kfr, kfi, ybar, chunk, cols) -> (vbar, kbr, kbi) on CUDA tensors,
    once its build (``start_first_direct10``) has ended; raises if the
    build or a launch fails."""
    import ctypes
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.kernels.common import twiddles

    proc, path = started
    log, _ = proc.communicate(timeout=900)
    if proc.returncode:
        raise RuntimeError(f"nvcc of {FIRST_DIRECT10} failed:\n{log}")
    fn = ctypes.CDLL(str(path)).fft_fused_causal_mix_bwd_direct
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(v, kr, ki, ybar, chunk, cols):
        b, n, d = v.shape
        nc, f2 = n // chunk, chunk + 1
        scratch = [torch.empty((b, nc, f2, d), device=v.device)
                   for _ in range(4)]
        vbar = torch.empty_like(v)
        kbr, kbi = torch.empty_like(kr), torch.empty_like(ki)
        seg = kc._segment_params(b, nc, chunk, d, v.device)
        err = fn(v.data_ptr(), kr.data_ptr(), ki.data_ptr(), ybar.data_ptr(),
                 twiddles(2 * chunk, v.device).data_ptr(),
                 *(t.data_ptr() for t in scratch), vbar.data_ptr(),
                 kbr.data_ptr(), kbi.data_ptr(), ctypes.addressof(seg), b,
                 nc, chunk, d, cols,
                 torch._C._cuda_getCurrentRawStream(v.device.index))
        if err:
            raise RuntimeError(f"{FIRST_DIRECT10}: cudaError_t {err}")
        return vbar, kbr, kbi

    return call


def kbar_checked(kern, b, nc, chunk, cols, label):
    """``kern`` whose first call also checks Kbar: exactly 0 where c <
    delta, and the same bits (vbar's too) on a second run."""
    first = [True]

    def call():
        out = kern()
        if first[0]:
            first[0] = False
            again = kern()
            kbar = out[1].view(b, nc, chunk + 1, nc, cols)
            for dl in range(1, nc):
                if torch.count_nonzero(kbar[:, dl, :, :dl]):
                    raise AssertionError(f"{label}: Kbar nonzero at c < "
                                         f"delta {dl}")
            if not all(torch.equal(x, y) for x, y in zip(out, again)):
                raise AssertionError(f"{label}: two runs differ")
        return out

    return call


def bwd_direct_cases(kc, first):
    """The direct #10 (csrc/causal_bwd.cu) at DIRECT10_SHAPES in fp32 and
    in bf16 (v and ybar rounded to bf16; REL_BF16 on vbar, REL_KERNEL on
    Kbar), each against its plain version, beside lib_direct6_bwd
    (library_ms; the bf16 cases' at 8 x 8192 alone) and the bound, Kbar
    exactly 0 where c < delta and bit-identical across two runs
    (kbar_checked); the fp32 cases with the first design (``first``,
    FIRST_DIRECT10) timed in the same turns (parent_ms), the bf16 case at
    8 x 8192 with the fp32 instance on the same values (fp32_ms).  Then
    #8 and the direct #6 at the tiny LM's 8 x 8192 (n_fft 8192, 2048 gate
    lanes; nc 64, fp32 and bf16), which run before it on that path; the
    direct #10's device time by CUDA kernel and the first design's at 8 x
    8192 (kernels_bwd_direct_split), and its lag-tile plans there
    (kernels_bwd_direct_sweep).  Fewer calls timed by events, and at B=8
    one call a turn of the plain version (36-64 ms) and the library call
    (119-231 ms); the values drawn on the card (hundreds of MB)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    cases = []
    quick = dict(reps=3, rounds=3)
    for b, nc, c, d, cols in DIRECT10_SHAPES:
        v, ybar = randn(b, nc * c, d), randn(b, nc * c, d)
        kr, ki = (randn(b, nc, c + 1, nc * cols) for _ in range(2))
        shape = f"B={b} nc={nc} C={c} d={d} cols={cols}"
        for dt, suffix, tol in (
                (torch.float32, "", REL_KERNEL),
                (torch.bfloat16, "_bf16", (REL_BF16, REL_KERNEL,
                                           REL_KERNEL))):
            # every value a call reads is bound now: the loop rebinds them
            vv, yy = v.to(dt), ybar.to(dt)
            args = (kr, ki, c, cols)
            name = "fused_causal_mix_bwd_direct" + suffix
            kern = kbar_checked(
                lambda vv=vv, yy=yy, a=args: kc.fused_causal_mix_bwd_direct(
                    vv, a[0], a[1], yy, a[2], a[3]), b, nc, c, cols, name)
            main = (b, nc) == (8, 64)
            other = {"slow": True} if b == 8 else {}
            if not suffix:
                other["parent"] = lambda v=v, yb=ybar, a=args: first(
                    v, a[0], a[1], yb, a[2], a[3])
            elif main:              # elsewhere the fp32 case's shape times it
                v32, y32 = vv.float(), yy.float()
                other["fp32"] = lambda v32=v32, y32=y32, a=args: \
                    kc.fused_causal_mix_bwd_direct(v32, a[0], a[1], y32,
                                                   a[2], a[3])
            cases.append((
                name, shape, kern,
                lambda vv=vv, yy=yy, a=args: kc.fused_causal_mix_bwd_ref(
                    vv, a[0], a[1], yy, a[2], a[3]),
                lib_direct6_bwd(vv, kr, ki, yy, c, cols)
                if main or not suffix else None,
                fprof.fused_causal_mix_bwd_cost(b, nc, c, d, cols,
                                               dt.itemsize),
                main, dict(quick, tol=tol, **other)))
        if (b, nc) == (8, 64):
            k64 = (kr, ki)
    # what runs before the direct #10 on the tiny LM's path at 8 x 8192
    b, n, c, d, cols = 8, 8192, 128, 512, 32
    nc, lanes = n // c, n // c * cols
    gr, gi = randn(b, n // 2 + 1, lanes), randn(b, n // 2 + 1, lanes)
    cases.append((
        "kf_spectra", f"B={b} n_fft={n} C={c} L={lanes}",
        lambda: kc.kf_spectra(gr, gi, n, c),
        lambda: kc.kf_spectra_ref(gr, gi, n, c),
        lambda: torch.fft.rfft(torch.fft.irfft(
            torch.complex(gr, gi), n, dim=1).reshape(b, nc, c, lanes),
            2 * c, dim=2),
        fprof.kf_spectra_cost(b, n, c, lanes), False, quick))
    v = randn(b, n, d)
    kr, ki = k64                    # the direct #10's main case's K planes
    args = (kr, ki, c, cols)
    for dt, suffix, tol in ((torch.float32, "", REL_KERNEL),
                            (torch.bfloat16, "_bf16", REL_BF16)):
        vv = v.to(dt)
        cases.append((
            "fused_causal_mix_direct" + suffix,
            f"B={b} nc={nc} C={c} d={d} cols={cols}",
            lambda vv=vv, a=args: kc.fused_causal_mix(vv, *a),
            lambda vv=vv, a=args: kc.fused_causal_mix_ref(vv, *a),
            lambda vv=vv, a=args: lib_direct6(vv, *a),
            fprof.fused_causal_mix_cost(b, nc, c, d, cols, dt.itemsize),
            False, dict(quick, tol=tol, slow=True)))
    ybar = randn(b, n, d)
    v16, y16 = v.bfloat16(), ybar.bfloat16()
    rows = []
    for label, fn in (
            ("fused_causal_mix_bwd_direct",
             lambda: kc.fused_causal_mix_bwd_direct(v, kr, ki, ybar, c,
                                                    cols)),
            ("fused_causal_mix_bwd_direct_bf16",
             lambda: kc.fused_causal_mix_bwd_direct(v16, kr, ki, y16, c,
                                                    cols)),
            ("first_design", lambda: first(v, kr, ki, ybar, c, cols))):
        fn()
        torch.cuda.synchronize()
        prof = fprof.read_profile(fn, torch.cuda.synchronize, 10)
        rows.append(dict(kernel=label, shape=f"B={b} nc={nc} C={c} d={d} "
                         f"cols={cols}", ms=median_ms(fn, 5, 3),
                         device_ms=prof["device_busy_ms_per_step"],
                         device_ms_source=prof["device_ms_source"],
                         by_launch=prof["top_kernels_ms_per_step"]))
    emit(phase="kernels_bwd_direct_split", rows=rows)
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, c, cols)
    sweep = []
    # (gate groups, bins, segments) a lag tile: 128 or 256 channels a
    # block (8 or 16 groups), 2 bins of 128, 512 channels; 4 or 8 segments
    for plan in ((8, 1, 8), (8, 2, 8), (16, 1, 8), (16, 1, 4), (32, 1, 8)):
        fn = lambda plan=plan: kc._launch_bwd(                # noqa: E731
            "fused_causal_mix_bwd_direct", v, kr, ki, ybar, c, cols, plan)
        err = rel_err(fn(), want)
        if err > REL_KERNEL:
            raise AssertionError(f"direct #10 plan {plan}: rel_err {err}")
        sweep.append(dict(plan=plan, rel_err=err, ms=median_ms(fn, 5, 3),
                          chosen=plan == kc.bwd_direct_plan(nc, c, d, cols)))
    emit(phase="kernels_bwd_direct_sweep",
         shape=f"B={b} nc={nc} C={c} d={d} cols={cols}", plans=sweep)
    return cases


def bwd_seg_sweep(kc, randn) -> None:
    """#10's FFT kernel at the tiny LM's training shape (B=8, nc=16, C=128,
    d=512, 32 gate columns) over its plans (channel pairs np and windows gs
    a transform block, threads bt a bin-major block), and #9 at the 350M's
    layer (B=1, N=16384, C=2048, L=512) over threads a block; median ms
    over CUDA events of each, the wrappers' own choice marked.  Each output
    is held to the plain version first."""
    b, nc, chunk, d, cols = 8, 16, 128, 512, 32
    v, ybar = randn(b, nc * chunk, d), randn(b, nc * chunk, d)
    kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
    want = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    runs = [("fused_causal_mix_bwd", plan,
             tuple(plan) == kc.bwd_fft_plan(nc, chunk, d, cols),
             lambda plan=plan: kc._launch_bwd("fused_causal_mix_bwd", v, kr,
                                              ki, ybar, chunk, cols, plan),
             want)
            for plan in ((4, 4, 256), (4, 4, 128), (4, 4, 512), (4, 2, 256),
                         (4, 8, 256), (2, 4, 256))]
    n, c, lanes = 16384, 2048, 512
    kt = randn(1, n, lanes)
    want_seg = kc.kf_seg_rfft_ref(kt, c)
    runs += [("kf_seg_rfft", (threads,), threads == kc.SEG_THREADS,
              lambda threads=threads: kc._kf_seg_rfft(kt, c, threads),
              want_seg) for threads in (512, 384, 256)]
    rows = []
    for name, plan, chosen, kern, want_out in runs:
        err = rel_err(kern(), want_out)
        if not err <= REL_KERNEL:
            raise AssertionError(f"{name} plan {plan}: rel_err {err}")
        rows.append(dict(kernel=name, plan=list(plan), rel_err=err,
                         ms=median_ms(kern), chosen=chosen))
    emit(phase="kernels_bwd_seg_sweep", rows=rows)


def tile_sweep(kc, randn) -> None:
    """#8's and #6's FFT kernels (causal_fft.cu) at the tiny LM's scoring
    shapes (B=4, n_fft 2048, C 128, L 512; nc 16, d 512, 32 gate columns)
    over the tile plans that fit shared memory: lane or channel pairs a
    block (np) and segments or windows a pass (gs); median ms over CUDA
    events of each, the wrappers' own plan marked.  Each plan's output is
    held to the plain version first."""
    b, n_fft, chunk, lanes, d, cols = 4, 2048, 128, 512, 512, 32
    nc = n_fft // chunk
    gr, gi = randn(b, n_fft // 2 + 1, lanes), randn(b, n_fft // 2 + 1, lanes)
    v = randn(b, n_fft, d)
    kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
    runs = []
    for plan in ((4, 8), (4, 4), (4, 2), (2, 4)):
        if kc._kf_fft_smem(n_fft, chunk, *plan) <= kc.SMEM_MAX:
            runs.append(("kf_spectra", plan, kc.kf_fft_plan(n_fft, chunk,
                                                            lanes),
                         lambda plan=plan: kc._launch_kf(
                             "kf_spectra", gr, gi, n_fft, chunk, plan),
                         lambda: kc.kf_spectra_ref(gr, gi, n_fft, chunk)))
    for plan in ((4, 4), (4, 2), (2, 4), (2, 2)):
        ng = kc._tile_groups(d, cols, 2 * plan[0])
        if kc._mix_fft_smem(nc, chunk, *plan, ng) <= kc.SMEM_MAX:
            runs.append(("fused_causal_mix", plan,
                         kc.mix_fft_plan(nc, chunk, d, cols),
                         lambda plan=plan: kc._launch_mix(
                             "fused_causal_mix", v, kr, ki, chunk, cols,
                             plan),
                         lambda: kc.fused_causal_mix_ref(v, kr, ki, chunk,
                                                         cols)))
    rows = []
    for name, plan, chosen, kern, plain in runs:
        err = rel_err(kern(), plain())
        if not err <= REL_KERNEL:
            raise AssertionError(f"{name} plan {plan}: rel_err {err}")
        rows.append(dict(kernel=name, plan=list(plan), rel_err=err,
                         ms=median_ms(kern), chosen=tuple(plan) == chosen))
    emit(phase="kernels_tile_sweep", rows=rows)


def long_tile_sweep(kc, randn) -> None:
    """#7's and #11's kernels (causal_long.cu) at the 350M's layer (B=1,
    nc=8, C=2048, d=1024, 64 gate columns) over the transform tile plans:
    channel pairs a block (np) and threads a block; median ms over CUDA
    events of each, ``kc.LONG_PLAN`` marked.  Each plan's output is held to
    the plain version first."""
    b, nc, chunk, d, cols = 1, 8, 2048, 1024, 64
    v, ybar = randn(b, nc * chunk, d), randn(b, nc * chunk, d)
    kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
    want_fwd = kc.fused_causal_mix_ref(v, kr, ki, chunk, cols)
    want_bwd = kc.fused_causal_mix_bwd_ref(v, kr, ki, ybar, chunk, cols)
    rows = []
    for plan in ((4, 512), (4, 256), (2, 512), (2, 256), (1, 512),
                 (1, 256)):
        for name, kern, want in (
                ("fused_causal_mix_v3",
                 lambda plan=plan: kc._launch_mix(
                     "fused_causal_mix_v3", v, kr, ki, chunk, cols, plan),
                 want_fwd),
                ("fused_causal_mix_bwd_v3",
                 lambda plan=plan: kc._launch_bwd(
                     "fused_causal_mix_bwd_v3", v, kr, ki, ybar, chunk, cols,
                     plan),
                 want_bwd)):
            err = rel_err(kern(), want)
            if not err <= REL_KERNEL:
                raise AssertionError(f"{name} plan {plan}: rel_err {err}")
            rows.append(dict(kernel=name, plan=list(plan), rel_err=err,
                             ms=median_ms(kern),
                             chosen=plan == tuple(kc.LONG_PLAN)))
    emit(phase="kernels_long_tile_sweep", rows=rows)


def long_launch_split(kc, randn) -> None:
    """Device time by CUDA kernel (torch.profiler over 10 calls): #7 and
    #11 at the 350M's layer (B=1, nc=8, C=2048, d=1024, 64 gate columns),
    its 8192- and 1024-token prompts (nc=4; nc=1 at C=1024), #7's kernel
    at the tiny LM's nc=16, C=128 (d=512, 32 columns); at the tiny LM's
    training shape (B=8, nc=16, C=128, d=512, 32 columns) #10 as the
    wrapper dispatches it, #11's kernel and #10's direct kernel; #7 and
    #11 at the 350M's layer at seq 65536 (nc=32), each instance (fp32,
    bf16); #9 at the 350M's layer (B=1, N=16384, C=2048, L=512): which
    launches take the time.  It takes any tree's ``kernels.causal`` (an older tree has no
    ``fused_causal_mix_bwd_direct``: there ``fused_causal_mix_bwd`` is
    the direct kernel), so one call can time two trees' kernels."""
    rows = []
    for b, nc, c, d, cols in ((1, 8, 2048, 1024, 64), (1, 4, 2048, 1024, 64),
                              (1, 1, 1024, 1024, 64), (4, 16, 128, 512, 32),
                              (8, 16, 128, 512, 32)):
        v, ybar = randn(b, nc * c, d), randn(b, nc * c, d)
        kr, ki = (randn(b, nc, c + 1, nc * cols) for _ in range(2))
        runs = []
        if b < 8:
            runs.append(("fused_causal_mix_v3",
                         lambda v=v, kr=kr, ki=ki, c=c, cols=cols:
                         kc._launch_mix("fused_causal_mix_v3", v, kr, ki, c,
                                        cols)))
        if not kc.fused_mix_supported(nc, c, d, cols):
            runs.append(("fused_causal_mix_bwd_v3",
                         lambda v=v, kr=kr, ki=ki, yb=ybar, c=c, cols=cols:
                         kc.fused_causal_mix_bwd(v, kr, ki, yb, c, cols)))
        elif b == 8:
            runs += [("fused_causal_mix_bwd",
                      lambda v=v, kr=kr, ki=ki, yb=ybar, c=c, cols=cols:
                      kc.fused_causal_mix_bwd(v, kr, ki, yb, c, cols)),
                     ("fused_causal_mix_bwd_v3",
                      lambda v=v, kr=kr, ki=ki, yb=ybar, c=c, cols=cols:
                      kc._launch_bwd("fused_causal_mix_bwd_v3", v, kr, ki,
                                     yb, c, cols))]
            if hasattr(kc, "fused_causal_mix_bwd_direct"):
                runs.append(("fused_causal_mix_bwd_direct",
                             lambda v=v, kr=kr, ki=ki, yb=ybar, c=c,
                             cols=cols: kc.fused_causal_mix_bwd_direct(
                                 v, kr, ki, yb, c, cols)))
        for name, fn in runs:
            fn()
            torch.cuda.synchronize()
            prof = fprof.read_profile(fn, torch.cuda.synchronize, 10)
            rows.append(dict(kernel=name,
                             shape=f"B={b} nc={nc} C={c} d={d} cols={cols}",
                             ms=median_ms(fn),
                             device_ms=prof["device_busy_ms_per_step"],
                             device_ms_source=prof["device_ms_source"],
                             by_launch=prof["top_kernels_ms_per_step"]))
    # #7 and #11 at the 350M's layer at seq 65536 (nc 32), fp32 and bf16
    b, nc, c, d, cols = 1, 32, 2048, 1024, 64
    v, ybar = randn(b, nc * c, d), randn(b, nc * c, d)
    kr, ki = (randn(b, nc, c + 1, nc * cols) for _ in range(2))
    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        vv, yy = v.to(dt), ybar.to(dt)
        for name, fn in (
                ("fused_causal_mix_v3", lambda vv=vv: kc.fused_causal_mix(
                    vv, kr, ki, c, cols)),
                ("fused_causal_mix_bwd_v3",
                 lambda vv=vv, yy=yy: kc.fused_causal_mix_bwd(
                     vv, kr, ki, yy, c, cols))):
            fn()
            torch.cuda.synchronize()
            prof = fprof.read_profile(fn, torch.cuda.synchronize, 10)
            rows.append(dict(kernel=name + suffix,
                             shape=f"B={b} nc={nc} C={c} d={d} cols={cols}",
                             ms=median_ms(fn),
                             device_ms=prof["device_busy_ms_per_step"],
                             device_ms_source=prof["device_ms_source"],
                             by_launch=prof["top_kernels_ms_per_step"]))
    del v, ybar, kr, ki, vv, yy
    b, n, c, lanes = 1, 16384, 2048, 512
    kt = randn(b, n, lanes)
    fn = lambda: kc.kf_seg_rfft(kt, c)                       # noqa: E731
    fn()
    torch.cuda.synchronize()
    prof = fprof.read_profile(fn, torch.cuda.synchronize, 10)
    rows.append(dict(kernel="kf_seg_rfft",
                     shape=f"B={b} N={n} C={c} L={lanes}", ms=median_ms(fn),
                     device_ms=prof["device_busy_ms_per_step"],
                     device_ms_source=prof["device_ms_source"],
                     by_launch=prof["top_kernels_ms_per_step"]))
    emit(phase="kernels_launch_split", rows=rows)


def mix_launch_split(sm, randn, kernels=None) -> None:
    """Device time by CUDA kernel (torch.profiler over 10 calls) of the
    non-causal mix at phase 2's shapes, 32 gate columns: #1 (with memory)
    and #2 at config 1's B=8, n_fft 1024, d=512; the forward past n_fft 2048
    (long_mix_cases), with memory: #3 at config 1's 4096 x 2 and 8192 x 1
    and at the odd factors 9, 17 and 31, #4 at 16384, 32768 and 65536.  It
    takes any tree's ``kernels.spectral_mix``, so one call can time two
    trees' kernels; ``kernels`` (names) keeps those rows alone."""
    rows = []
    for name, b, n, d in (("direct_mix", 8, 1024, 512),
                          ("direct_mix_bwd", 8, 1024, 512),
                          ("staged_mix", 2, 4096, 512),
                          ("staged_mix", 1, 8192, 512),
                          ("staged_mix", 1, 2304, 512),
                          ("staged_mix", 1, 4352, 128),
                          ("staged_mix", 1, 7936, 512),
                          ("twopass_mix", 1, 16384, 512),
                          ("twopass_mix", 1, 32768, 512),
                          ("twopass_mix", 1, 65536, 512)):
        if kernels is not None and name not in kernels:
            continue
        cols = 32
        # #2 takes the cotangent (B, N, d) where the forwards take mem_t
        last = randn(b, n, d) if name == "direct_mix_bwd" else randn(n, d)
        args = (randn(b, n, d), randn(b, n // 2 + 1, cols),
                randn(b, n // 2 + 1, cols), last, n)
        fn = lambda f=getattr(sm, name), a=args: f(*a)       # noqa: E731
        fn()
        torch.cuda.synchronize()
        prof = fprof.read_profile(fn, torch.cuda.synchronize, 10)
        rows.append(dict(kernel=name,
                         shape=f"B={b} N={n} d={d} cols={cols} "
                               f"mem={int(name != 'direct_mix_bwd')}",
                         ms=median_ms(fn),
                         device_ms=prof["device_busy_ms_per_step"],
                         device_ms_source=prof["device_ms_source"],
                         by_launch=prof["top_kernels_ms_per_step"]))
        del args, fn
    emit(phase="kernels_mix_launch_split", rows=rows)


def direct_plans(sm, n):
    """#1's plans (cs, np, threads) at n_fft: cs 2 only at powers of two
    (an odd factor or a direct DFT runs in one CTA)."""
    pow2 = n & (n - 1) == 0
    return [(cs, np_, threads) for cs, np_ in sm.DIRECT_INSTANCES
            if cs == 1 or pow2 for threads in (128, 256, 512)]


def mix_plan_sweep(sm, randn) -> None:
    """#1 (with memory) and #2 at n_fft 512, 1024 (config 1), 1536 and 2048
    with B n_fft = 8192 tokens, over their plans (#1: CTAs a cluster, channel
    pairs a CTA, threads a CTA; #2: channel pairs a CTA, threads a CTA); #3
    at config 1's 4096 x 2 and 8192 x 1 and at the odd factors 9 and 31
    (2304, 7936), #4 at 16384, 32768 and 65536 (B=1), with memory, over the
    plans of their kernel (csrc/mix_fft.cuh) whose tile fits a block; d=512,
    32 gate columns; median ms over CUDA events and device ms of each, the
    wrappers' own plan marked.  Each plan's output is held to the plain
    version first."""
    rows = []
    d, cols = 512, 32
    for n in (512, 1024, 1536, 2048):
        b = 8192 // n
        args = (randn(b, n, d), randn(b, n // 2 + 1, cols),
                randn(b, n // 2 + 1, cols))
        mem_t, ybar = randn(n, d), randn(b, n, d)
        want = sm.direct_mix_ref(*args, mem_t, n)
        want_bwd = sm.direct_mix_bwd_ref(*args, ybar, n)
        for name, plans, chosen, kern, ref in (
                ("direct_mix", direct_plans(sm, n), sm.direct_plan(n),
                 lambda plan, a=args, m=mem_t, n=n: sm._launch_direct(
                     *a, m, n, plan), want),
                ("direct_mix_bwd",
                 [(np_, t) for np_ in sm.BWD_INSTANCES
                  for t in (128, 256, 512)], sm.bwd_plan(n),
                 lambda plan, a=args, y=ybar, n=n: sm._launch_bwd(
                     *a, y, n, plan), want_bwd)):
            for plan in plans:
                err = rel_err(kern(plan), ref)
                if not err <= REL_KERNEL:
                    raise AssertionError(f"{name} n_fft {n} plan {plan}: "
                                         f"rel_err {err}")
                rows.append(dict(
                    kernel=name, shape=f"B={b} N={n} d={d}",
                    plan=list(plan), rel_err=err,
                    ms=median_ms(lambda k=kern, p=plan: k(p)),
                    **device_ms(lambda k=kern, p=plan: k(p)),
                    chosen=tuple(plan) == tuple(chosen)))
        del args, mem_t, ybar, want, want_bwd
    for name, b, n in (("staged_mix", 2, 4096), ("staged_mix", 1, 8192),
                       ("staged_mix", 1, 2304), ("staged_mix", 1, 7936),
                       ("twopass_mix", 1, 16384), ("twopass_mix", 1, 32768),
                       ("twopass_mix", 1, 65536)):
        d, cols = 512, 32
        args = (randn(b, n, d), randn(b, n // 2 + 1, cols),
                randn(b, n // 2 + 1, cols), randn(n, d), n)
        want = sm.twopass_mix_ref(*args)
        chosen = (sm.staged_plan(n) if name == "staged_mix"
                  else sm.TWOPASS_PLAN[n])
        odd = n // (n & -n) > 1
        for plan in ((cs, np_, threads)
                     for cs, np_ in sm.LONG_INSTANCES[name + "_odd" * odd]
                     for threads in ((128, 256) if odd else (256, 512))
                     if sm.long_plan_fits(n, (cs, np_, threads))):
            def kern(name=name, args=args, plan=plan):
                return sm._launch_long(name, *args, plan)

            err = rel_err(kern(), want)
            if not err <= REL_KERNEL:
                raise AssertionError(f"{name} n_fft {n} plan {plan}: "
                                     f"rel_err {err}")
            rows.append(dict(kernel=name, shape=f"B={b} N={n} d={d}",
                             plan=list(plan), rel_err=err,
                             ms=median_ms(kern), **device_ms(kern),
                             chosen=plan == tuple(chosen)))
        del args, want
    emit(phase="kernels_mix_plan_sweep", rows=rows)


def long_cases(kc, randn):
    """The 350M's long-context kernels: one layer at seq 16384 (d=1024, 16
    heads x 4 groups = 64 gate columns, chunk 2048, nc=8), the 8192- and
    1024-token prompts' mixes (nc=4; nc=1 at C=1024), nc=4 at C=1024, and
    #5 at the other prompts' chunks (BANDED_LONG_CHUNKS)."""
    cases = []
    b, chunk, d, cols = 1, 2048, 1024, 64
    n, lanes = 16384, 8 * 64
    kt = randn(b, n, lanes)
    # the two output planes as a tuple, as #8's: a torch.cat would add a
    # copy of 67 MB to the kernel's time
    cases.append((
        "kf_seg_rfft", f"B={b} N={n} C={chunk} L={lanes}",
        lambda: kc.kf_seg_rfft(kt, chunk),
        lambda: kc.kf_seg_rfft_ref(kt, chunk),
        lambda: torch.fft.rfft(kt.view(b, n // chunk, chunk, lanes),
                               2 * chunk, dim=2),
        fprof.kf_seg_rfft_cost(b, n, chunk, lanes), True))
    for nc, c in ((8, chunk), (4, chunk), (4, 1024), (1, 1024)):
        v, ybar = randn(b, nc * c, d), randn(b, nc * c, d)
        kr, ki = (randn(b, nc, c + 1, nc * cols) for _ in range(2))
        shape = f"B={b} nc={nc} C={c} d={d} cols={cols}"
        main = nc == 8
        cases.append((
            "fused_causal_mix_v3", shape,
            lambda v=v, kr=kr, ki=ki, c=c: kc.fused_causal_mix(v, kr, ki, c,
                                                               cols),
            lambda v=v, kr=kr, ki=ki, c=c: kc.fused_causal_mix_ref(
                v, kr, ki, c, cols),
            (lambda v=v, kr=kr, ki=ki, c=c: lib_direct6(v, kr, ki, c, cols))
            if main else None, fprof.fused_causal_mix_cost(b, nc, c, d, cols),
            main))
        cases.append((
            "fused_causal_mix_bwd_v3", shape,
            lambda v=v, kr=kr, ki=ki, yb=ybar, c=c: kc.fused_causal_mix_bwd(
                v, kr, ki, yb, c, cols),
            lambda v=v, kr=kr, ki=ki, yb=ybar, c=c:
                kc.fused_causal_mix_bwd_ref(v, kr, ki, yb, c, cols),
            lib_direct6_bwd(v, kr, ki, ybar, c, cols) if main else None,
            fprof.fused_causal_mix_bwd_cost(b, nc, c, d, cols), main))
    return cases + banded_cases(kc, randn, b, BANDED_LONG_CHUNKS, d, cols)


def long_nc_cases(kc, randn):
    """The 350M's layer at seq 32768 and 65536 (B=1, C=2048, d=1024, 64
    gate columns; nc 16 and 32): #9 over the layer's k_time (nc x 64
    lanes), #7 and #11 in fp32, and their bf16 instances on the same
    inputs rounded to bf16 (REL_BF16 on y and vbar, REL_KERNEL on Kbar,
    which is summed in fp32 from the same values; the main cases of the
    bf16 instances are nc 32, the CLI's seq 65536).  Fewer calls timed by
    events: the plain versions take 20-80 ms a call."""
    cases = []
    b, chunk, d, cols = 1, 2048, 1024, 64
    quick = dict(reps=2, rounds=3)
    for nc in (16, 32):
        n, lanes = nc * chunk, nc * cols
        kt = randn(b, n, lanes)
        cases.append((
            "kf_seg_rfft", f"B={b} N={n} C={chunk} L={lanes}",
            lambda kt=kt: kc.kf_seg_rfft(kt, chunk),
            lambda kt=kt: kc.kf_seg_rfft_ref(kt, chunk),
            lambda kt=kt, n=n, lanes=lanes: torch.fft.rfft(
                kt.view(b, n // chunk, chunk, lanes), 2 * chunk, dim=2),
            fprof.kf_seg_rfft_cost(b, n, chunk, lanes), False, quick))
        del kt
        v, ybar = randn(b, n, d), randn(b, n, d)
        kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
        shape = f"B={b} nc={nc} C={chunk} d={d} cols={cols}"
        for dt, suffix, tol in ((torch.float32, "", REL_KERNEL),
                                (torch.bfloat16, "_bf16", REL_BF16)):
            vv, yy = v.to(dt), ybar.to(dt)
            main = bool(suffix) and nc == 32
            cases.append((
                "fused_causal_mix_v3" + suffix, shape,
                lambda vv=vv, kr=kr, ki=ki: kc.fused_causal_mix(
                    vv, kr, ki, chunk, cols),
                lambda vv=vv, kr=kr, ki=ki: kc.fused_causal_mix_ref(
                    vv, kr, ki, chunk, cols),
                lambda vv=vv, kr=kr, ki=ki: lib_direct6(
                    vv, kr, ki, chunk, cols),
                fprof.fused_causal_mix_cost(b, nc, chunk, d, cols,
                                           dt.itemsize),
                main, dict(quick, tol=tol)))
            cases.append((
                "fused_causal_mix_bwd_v3" + suffix, shape,
                lambda vv=vv, kr=kr, ki=ki, yy=yy: kc.fused_causal_mix_bwd(
                    vv, kr, ki, yy, chunk, cols),
                lambda vv=vv, kr=kr, ki=ki, yy=yy:
                    kc.fused_causal_mix_bwd_ref(vv, kr, ki, yy, chunk, cols),
                lib_direct6_bwd(vv, kr, ki, yy, chunk, cols),
                fprof.fused_causal_mix_bwd_cost(b, nc, chunk, d, cols,
                                               dt.itemsize), main,
                dict(quick, tol=(tol, REL_KERNEL, REL_KERNEL))))
    return cases


# #5 at the 350M's prompts (B=1, d=1024, 64 gate columns, nc=1): the
# power-of-two chunk, Bluestein's M = 4096, 8192 and 16384 (a prime among
# them), the odd factor 3; 1500 is the main case
BANDED_LONG_CHUNKS = (1024, 854, 1499, 1500, 1536, 2047, 2904)


def banded_inputs(randn, b, nc, c, d, cols):
    return (randn(b, nc, c + 1, d), randn(b, nc, c + 1, d),
            randn(b, nc, nc, c + 1, cols), randn(b, nc, nc, c + 1, cols))


def lib_banded(vfr, vfi, kfr, kfi, c):
    """#5 as PyTorch ops (which the port never calls): the banded sum of
    complex products over the lags, then torch.fft.irfft (cuFFT) of 2C and
    rows C..2C-1."""
    b, nc, f2, d = vfr.shape
    cols = kfr.shape[-1]
    vf = torch.complex(vfr, vfi).view(b, nc, f2, cols, d // cols)
    kf = torch.complex(kfr, kfi)
    acc = kf[:, :, 0, :, :, None] * vf
    for j in range(1, nc):
        acc[:, j:] += kf[:, j:, j, :, :, None] * vf[:, :nc - j]
    return torch.fft.irfft(acc.view(b, nc, f2, d), 2 * c, dim=2)[:, :, c:]


def banded_cases(kc, randn, b, chunks, d, cols):
    """#5 at nc=1 and each chunk, with the cuFFT composition beside it."""
    cases = []
    for c in chunks:
        args = banded_inputs(randn, b, 1, c, d, cols)
        cases.append((
            "banded_inverse", f"B={b} nc=1 C={c} d={d} cols={cols}",
            lambda args=args, c=c: kc.banded_inverse(*args, c),
            lambda args=args, c=c: kc.banded_inverse_ref(*args, c),
            lambda args=args, c=c: lib_banded(*args, c),
            fprof.banded_inverse_cost(b, 1, c, d, cols), c == 1500))
    return cases


def lib_direct6(v, kfr, kfi, c, cols):
    """The direct #6 as PyTorch ops (which the port never calls): the
    windows' torch.fft.rfft of 2C (cuFFT), the banded sum of complex
    products over the lags on the producer layout, torch.fft.irfft of 2C
    and rows C..2C-1."""
    b, n, d = v.shape
    nc, f2 = n // c, c + 1
    vs = v.float().view(b, nc, c, d)
    prev = torch.cat([torch.zeros_like(vs[:, :1]), vs[:, :-1]], 1)
    vf = torch.fft.rfft(torch.cat([prev, vs], 2), dim=2).view(
        b, nc, f2, cols, d // cols)
    kf = torch.complex(kfr, kfi).view(b, nc, f2, nc, cols)  # (b, j, f, c, g)
    acc = kf[:, 0].permute(0, 2, 1, 3)[..., None] * vf
    for j in range(1, nc):
        acc[:, j:] += kf[:, j, :, j:].permute(0, 2, 1, 3)[..., None] * vf[
            :, :nc - j]
    return torch.fft.irfft(acc.view(b, nc, f2, d), 2 * c, dim=2)[
        :, :, c:].reshape(b, n, d)


def lib_direct6_bwd(v, kfr, kfi, ybar, c, cols):
    """#10 and #11 as PyTorch ops (which the port never calls): the
    backward of ``lib_direct6`` by autograd (the adjoint cuFFT transforms
    and products), vbar and the K planes' cotangents Kbar for the
    cotangent ybar.  Returns a call that runs the backward alone: the
    forward graph is built on its first call (the timers' warm-up) and
    kept, so a timed call is ``torch.autograd.grad(..., retain_graph=True)``
    and nothing more; ``release()`` frees the graph."""
    graph = []

    def call():
        if not graph:
            ins = tuple(t.detach().float().requires_grad_()
                        for t in (v, kfr, kfi))
            graph.append((lib_direct6(*ins, c, cols), ins))
        out, ins = graph[0]
        return torch.autograd.grad(out, ins, ybar.float(), retain_graph=True)

    call.release = graph.clear
    return call


# (B, nc, C, d, cols) of the direct #6 in phase 2, fp32: the 350M's prompt
# of 600 tokens (the main case; Bluestein at M = 2048), of 853 (M =
# 4096) and two 600-token chunks (a full window, M = 4096)
DIRECT6_SHAPES = ((1, 1, 600, 1024, 64), (1, 1, 853, 1024, 64),
                  (1, 2, 600, 1024, 64))


def direct6_cases(kc, randn):
    """The direct #6 (segment FFTs, then #5's body) at DIRECT6_SHAPES in
    fp32, each beside the cuFFT composition (library_ms), against its plain
    version (the direct #10's shapes are bwd_direct_cases')."""
    cases = []
    for b, nc, c, d, cols in DIRECT6_SHAPES:
        v = randn(b, nc * c, d)
        kr, ki = (randn(b, nc, c + 1, nc * cols) for _ in range(2))
        cases.append((
            "fused_causal_mix_direct", f"B={b} nc={nc} C={c} d={d} "
            f"cols={cols}",
            lambda v=v, kr=kr, ki=ki, c=c, cols=cols:
                kc.fused_causal_mix_direct(v, kr, ki, c, cols),
            lambda v=v, kr=kr, ki=ki, c=c, cols=cols:
                kc.fused_causal_mix_ref(v, kr, ki, c, cols),
            lambda v=v, kr=kr, ki=ki, c=c, cols=cols:
                lib_direct6(v, kr, ki, c, cols),
            fprof.fused_causal_mix_cost(b, nc, c, d, cols),
            (nc, c) == (1, 600)))
    return cases


def direct6_sweep(kc, randn) -> None:
    """The direct #6 at every 7th chunk from 128 to 853 where the FFT #6
    has no plan at the 350M's width (``mix_fft_plan(1, C, 1024, 64)`` is
    None: the prompts that run the direct #6), and at 853, B=1, nc=1,
    fp32, against its plain version (REL_KERNEL); untimed.  All 683 such
    chunks took 54 s of the card's time, past what the run's 1200 s
    leave (one new cuFFT plan and the plain version's tables a length:
    PERF.md, Findings)."""
    d, cols = 1024, 64
    chunks = [c for c in range(128, 854)
              if kc.mix_fft_plan(1, c, d, cols) is None]
    chunks = sorted(set(chunks[::7]) | {chunks[-1]})
    worst = (0.0, None)
    # inputs made and errors taken on the card: the plain version's own
    # tables are most of the host's time a length
    dev = randn(1).device
    g = torch.Generator(dev).manual_seed(SEED)
    for c in chunks:
        v, kr, ki = (torch.randn(shape, generator=g, device=dev) for shape in
                     ((1, c, d), (1, 1, c + 1, cols), (1, 1, c + 1, cols)))
        got = kc.fused_causal_mix_direct(v, kr, ki, c, cols)
        want = kc.fused_causal_mix_ref(v, kr, ki, c, cols)
        err = float((got.double() - want.double()).abs().max()
                    / want.double().abs().max())
        if not err <= REL_KERNEL:
            raise AssertionError(f"fused_causal_mix_direct C={c}: rel_err "
                                 f"{err}")
        if err >= worst[0]:
            worst = (err, c)
    emit(phase="kernels_direct6_sweep", d=d, cols=cols,
         lengths=len(chunks), first=chunks[0], last=chunks[-1],
         worst_rel_err=worst[0], worst_chunk=worst[1])


# (B, C, d, cols) of banded_plan_sweep: a chunk for each path and tile
# length (rows 8 to 16384), the 350M's width (d=1024, 64 gate columns) but
# at the CLI's prompt and C=100, 129 (the tiny LM's width)
BANDED_SWEEP = ((4, 4, 512, 32), (4, 100, 512, 32), (1, 1024, 1024, 64),
                (1, 2048, 1024, 64), (1, 768, 1024, 64),
                (1, 1280, 1024, 64), (1, 1536, 1024, 64),
                (1, 300, 1024, 64), (4, 129, 512, 32), (1, 500, 1024, 64),
                (1, 854, 1024, 64), (1, 1500, 1024, 64),
                (1, 2904, 1024, 64))


def banded_plan_sweep(kc, randn) -> None:
    """#5's kernel (csrc/causal.cu's banded_fft_kernel) over its tile
    plans, channel pairs a block (np) and threads a block, where the block
    fits; at each shape of BANDED_SWEEP (nc=1); median ms over CUDA events
    and device ms of each, ``kc.banded_fft_plan``'s marked.  Each plan's
    output is held to the plain version first."""
    rows = []
    for b, c, d, cols in BANDED_SWEEP:
        args = banded_inputs(randn, b, 1, c, d, cols)
        want = kc.banded_inverse_ref(*args, c)
        length, o, *chosen = kc.banded_fft_plan(c)
        for plan in ((np_, threads) for np_ in (1, 2, 4)
                     for threads in (128, 256, 512)):
            if (o > 1 and plan[1] > 256) or kc._banded_fft_smem(
                    c, length, o, plan[0]) > kc.SMEM_MAX:
                continue

            def kern(args=args, c=c, plan=plan):
                return kc._banded_inverse(*args, c, plan)

            err = rel_err(kern(), want)
            if not err <= REL_KERNEL:
                raise AssertionError(f"banded_inverse C={c} plan {plan}: "
                                     f"rel_err {err}")
            rows.append(dict(shape=f"B={b} nc=1 C={c} d={d} cols={cols}",
                             transform=[length, o], plan=list(plan),
                             rel_err=err, ms=median_ms(kern),
                             **device_ms(kern),
                             chosen=list(plan) == chosen))
        del args, want
    emit(phase="kernels_banded_plan_sweep", rows=rows)


def banded_host_split(kc, randn) -> None:
    """Where #5's host time goes at the CLI's prompt (B=4, nc=1, C=4,
    d=512, 32 columns), whose kernel takes ~0.003 ms: host microseconds a
    call (perf_counter over 2000 calls, no synchronize) of the public
    function, its wrapper alone, and the wrapper's pieces: the cached
    per-shape lookup, the output's allocation, the stream handle (the
    accessor ``launch`` uses and ``torch.cuda.current_stream``'s), the
    ctypes call that launches the kernel, and the Function around it."""
    from fft_tpu_torch.kernels.build import load_library

    b, c, d, cols = 4, 4, 512, 32
    args = banded_inputs(randn, b, 1, c, d, cols)
    dev = args[0].device
    kc.banded_inverse(*args, c)
    _, out_shape, _, address = kc._banded_call(b, 1, c, d, cols, dev)
    out = torch.empty(out_shape, device=dev)
    fn = load_library().fft_banded_inverse
    ptrs = [t.data_ptr() for t in (*args, out)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    pieces = (
        ("banded_inverse", lambda: kc.banded_inverse(*args, c)),
        ("_banded_inverse", lambda: kc._banded_inverse(*args, c)),
        ("_banded_call (cached)",
         lambda: kc._banded_call(b, 1, c, d, cols, dev)),
        ("torch.empty", lambda: torch.empty(out_shape, dtype=torch.float32,
                                            device=dev)),
        ("raw stream handle",
         lambda: torch._C._cuda_getCurrentRawStream(dev.index)),
        ("current_stream().cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream),
        ("ctypes launch", lambda: fn(*ptrs, address, stream)),
        ("_BandedInverse.apply", lambda: kc._BandedInverse.apply(*args, c)))
    rows = {}
    for name, f in pieces:
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            f()
        rows[name] = (time.perf_counter() - t0) / 2000 * 1e6
        torch.cuda.synchronize()
    emit(phase="kernels_banded_host_split", shape=f"B={b} nc=1 C={c} d={d} "
         f"cols={cols}", us_per_call=rows)


def banded_launch_split(kc, randn) -> list:
    """#5 at phase 2's shapes (the CLI's prompt, B=4, C=4, d=512, 32
    columns; the 350M's prompts, B=1, d=1024, 64 columns, C 1024, 1499,
    1500) and the direct #6 at phase 2's (B=4, nc 16, C=128, d=512), at
    C=129, nc=3, where the wrappers take it, and at DIRECT6_SHAPES (the
    600-token prompt in bf16 too): ms between CUDA events and
    device ms by CUDA kernel (torch.profiler over 10 calls).  It takes any
    tree's ``kernels.causal``, so one call can time two trees' kernels."""
    rows = []
    runs = []
    for b, c, d, cols in ((4, 4, 512, 32), (1, 1024, 1024, 64),
                          (1, 1499, 1024, 64), (1, 1500, 1024, 64)):
        args = banded_inputs(randn, b, 1, c, d, cols)
        runs.append(("banded_inverse", f"B={b} nc=1 C={c} d={d} cols={cols}",
                     lambda a=args, c=c: kc.banded_inverse(*a, c)))
    for b, nc, c, d, cols in ((4, 16, 128, 512, 32), (4, 3, 129, 512, 32),
                              *DIRECT6_SHAPES):
        v = randn(b, nc * c, d)
        kr, ki = (randn(b, nc, c + 1, nc * cols) for _ in range(2))
        for vv in (v, v.bfloat16()) if (nc, c) == (1, 600) else (v,):
            bf = "_bf16" if vv.dtype == torch.bfloat16 else ""
            runs.append(("fused_causal_mix_direct" + bf,
                         f"B={b} nc={nc} C={c} d={d} cols={cols}",
                         lambda v=vv, kr=kr, ki=ki, c=c, cols=cols:
                         kc.fused_causal_mix_direct(v, kr, ki, c, cols)))
    for name, shape, fn in runs:
        fn()
        torch.cuda.synchronize()
        prof = fprof.read_profile(fn, torch.cuda.synchronize, 10)
        rows.append(dict(kernel=name, shape=shape, ms=median_ms(fn),
                         device_ms=prof["device_busy_ms_per_step"],
                         device_ms_source=prof["device_ms_source"],
                         by_launch=prof["top_kernels_ms_per_step"]))
    emit(phase="kernels_banded_launch_split", rows=rows)
    return rows


def hybrid_cases(kc, kd, randn):
    """The hybrid LMs' shapes: the tiny hybrid's layer (tiny_hybrid_cases)
    and the 1B's (hybrid_1b_cases), then #12 at both (hd 64: B=1, H=4, n
    2048; hd 128: B=1, H=16, n 32768, 2 rows of 128 threads a block)."""
    return (tiny_hybrid_cases(kc, randn) + hybrid_1b_cases(kc, randn)
            + decode_cases(kd, randn, ((1, 4, 2048, 64),
                                       (1, 16, 32768, 128)), False))


def kf_case(kc, randn, n, chunk, lanes, label):
    """#8 at B=1 (n_fft n, chunk, lanes gate lanes) beside its cuFFT
    composition."""
    nc = n // chunk
    gr, gi = randn(1, n // 2 + 1, lanes), randn(1, n // 2 + 1, lanes)
    return (
        "kf_spectra", f"B=1 n_fft={n} C={chunk} L={lanes} ({label})",
        lambda: kc.kf_spectra(gr, gi, n, chunk),
        lambda: kc.kf_spectra_ref(gr, gi, n, chunk),
        lambda: torch.fft.rfft(torch.fft.irfft(
            torch.complex(gr, gi), n, dim=1).reshape(1, nc, chunk, lanes),
            2 * chunk, dim=2),
        fprof.kf_spectra_cost(1, n, chunk, lanes), False)


def tiny_hybrid_cases(kc, randn):
    """The tiny hybrid's layer (B=1, seq 2048, d=256, 4 heads x 4 groups =
    16 gate columns, chunk 256, nc 8): #8 over its nc x 16 = 128 gate
    lanes beside its cuFFT composition, #6 and #10 in fp32 and bf16 (their
    FFT kernels' plans at 2C = 512) beside theirs (lib_direct6 and
    autograd through it)."""
    n, chunk, d, cols = 2048, 256, 256, 16
    nc = n // chunk
    cases = [kf_case(kc, randn, n, chunk, nc * cols, "tiny hybrid")]
    kr, ki = (randn(1, nc, chunk + 1, nc * cols) for _ in range(2))
    v32, y32 = randn(1, n, d), randn(1, n, d)
    shape = f"B=1 nc={nc} C={chunk} d={d} cols={cols} (tiny hybrid)"
    for dt, suffix, tol in ((torch.float32, "", REL_KERNEL),
                            (torch.bfloat16, "_bf16", REL_BF16)):
        v, yb = v32.to(dt), y32.to(dt)
        cases.append((
            "fused_causal_mix" + suffix, shape,
            lambda v=v: kc.fused_causal_mix(v, kr, ki, chunk, cols),
            lambda v=v: kc.fused_causal_mix_ref(v, kr, ki, chunk, cols),
            lambda v=v: lib_direct6(v, kr, ki, chunk, cols),
            fprof.fused_causal_mix_cost(1, nc, chunk, d, cols, dt.itemsize),
            False, dict(tol=tol)))
        cases.append((
            "fused_causal_mix_bwd" + suffix, shape,
            lambda v=v, yb=yb: kc.fused_causal_mix_bwd(v, kr, ki, yb, chunk,
                                                       cols),
            lambda v=v, yb=yb: kc.fused_causal_mix_bwd_ref(v, kr, ki, yb,
                                                           chunk, cols),
            lib_direct6_bwd(v, kr, ki, yb, chunk, cols),
            fprof.fused_causal_mix_bwd_cost(1, nc, chunk, d, cols,
                                           dt.itemsize), False,
            dict(tol=(tol, REL_KERNEL, REL_KERNEL))))
    return cases


def hybrid_1b_cases(kc, randn):
    """The 1B hybrid's layer (B=1, seq 32768, d=2048, 16 heads x 4 groups
    = 64 gate columns, chunk 1024, nc 32, bf16): #9 over its 2048 lanes,
    the bf16 instances of #7 and #11, each beside its cuFFT composition;
    fewer timed calls (the plain versions take tens of ms).  And #8 at its
    parity's seq 8192 (nc 8: 512 gate lanes, which #8 takes whole)."""
    cases = [kf_case(kc, randn, 8192, 1024, 8 * 64, "1B hybrid, seq 8192")]
    quick = dict(reps=2, rounds=3)
    n, chunk, d, cols = 32768, 1024, 2048, 64
    nc = n // chunk
    lanes = nc * cols
    kt = randn(1, n, lanes)
    cases.append((
        "kf_seg_rfft", f"B=1 N={n} C={chunk} L={lanes} (1B hybrid)",
        lambda: kc.kf_seg_rfft(kt, chunk),
        lambda: kc.kf_seg_rfft_ref(kt, chunk),
        lambda: torch.fft.rfft(kt.view(1, nc, chunk, lanes), 2 * chunk,
                               dim=2),
        fprof.kf_seg_rfft_cost(1, n, chunk, lanes), False, quick))
    kr, ki = (randn(1, nc, chunk + 1, nc * cols) for _ in range(2))
    v = randn(1, n, d).to(torch.bfloat16)
    yb = randn(1, n, d).to(torch.bfloat16)
    shape = f"B=1 nc={nc} C={chunk} d={d} cols={cols} (1B hybrid)"
    # v and y (ybar and vbar, v) at 2 bytes
    cases.append((
        "fused_causal_mix_v3_bf16", shape,
        lambda: kc.fused_causal_mix(v, kr, ki, chunk, cols),
        lambda: kc.fused_causal_mix_ref(v, kr, ki, chunk, cols),
        lambda: lib_direct6(v, kr, ki, chunk, cols),
        fprof.fused_causal_mix_cost(1, nc, chunk, d, cols, 2), False,
        dict(quick, tol=REL_BF16)))
    cases.append((
        "fused_causal_mix_bwd_v3_bf16", shape,
        lambda: kc.fused_causal_mix_bwd(v, kr, ki, yb, chunk, cols),
        lambda: kc.fused_causal_mix_bwd_ref(v, kr, ki, yb, chunk, cols),
        lib_direct6_bwd(v, kr, ki, yb, chunk, cols),
        fprof.fused_causal_mix_bwd_cost(1, nc, chunk, d, cols, 2), False,
        dict(quick, tol=(REL_BF16, REL_KERNEL, REL_KERNEL))))
    return cases


def decode_cases(kd, randn, shapes=((4, 8, 2048, 64), (1, 16, 16384, 64)),
                 mains=True):
    """#12 at the tiny LM's decode shape (B=4, H=8, n 2048) and the 350M's
    (B=1, H=16, n 16384), hd 64, 4 gate groups: evict 0 at the first step
    after a 1024-token prompt (the generate paths' steps) and evict 1 at
    the window's last slot (``shapes``: (B, H, n, hd); the hybrids' too,
    without ``mains``).  The kernel and the plain version each update
    their own copy of one prefix in place; the first calls are compared
    (the prefix and y each on its own), later ones only timed.  No PyTorch
    call computes the fused step (library_ms null)."""
    cases = []
    for b, h, n, hd in shapes:
        groups, f = 4, n // 2 + 1
        for evict, j in ((0, 1024), (1, n - 1)):
            prefix = torch.complex(randn(b, h, f, hd), randn(b, h, f, hd))
            gate = torch.complex(randn(b, h, groups, f),
                                 randn(b, h, groups, f))
            v_t, v_buf = randn(b, h, hd), randn(b, h, n, hd)
            args = (gate, v_t, v_buf, evict, j, j)

            def kern(p=prefix.clone(), args=args):
                y = kd.fused_decode_mix(p, *args)
                return torch.view_as_real(p), y

            def plain(p=prefix, args=args):
                y = kd.fused_decode_mix_ref(p, *args)
                return torch.view_as_real(p), y

            cases.append((
                "fused_decode_mix",
                f"B={b} H={h} n={n} hd={hd} G={groups} evict={evict}",
                kern, plain, None,
                fprof.fused_decode_mix_cost(b, h, n, hd, groups),
                mains and n == 16384 and evict == 0))
    return cases


def lib_mix(v, gr, gi, mem_t, n):
    """The cuFFT composition of the forward mix (which the port never
    calls): rfft, the gate broadcast over each group's channels, irfft."""
    b, _, d = v.shape
    fh, cols = n // 2 + 1, gr.shape[-1]
    x = torch.fft.rfft(v, dim=1).view(b, fh, cols, d // cols)
    y = torch.fft.irfft((x * torch.complex(gr, gi)[..., None]).view(
        b, fh, d), n, dim=1)
    return y if mem_t is None else y + mem_t


# the forward mix kernels' work models by launch name
MIX_COST = {"direct_mix": fprof.direct_mix_cost,
            "staged_mix": fprof.staged_mix_cost,
            "twopass_mix": fprof.twopass_mix_cost}


def long_mix_cases(sm, randn):
    """#3 at config 1's block lengths (4096 at B=2, 8192 at B=1) and at the
    odd factors 9, 17 and 31 (2304, 4352, 7936); #4 at 16384, 32768 and
    65536, B=1; d=512 (128 at 4352), 32 gate columns, each with and
    without memory, beside the cuFFT composition."""
    cases = []
    for name, fn, plain, shapes in (
            ("staged_mix", sm.staged_mix, sm.staged_mix_ref,
             ((2, 4096, 512), (1, 8192, 512), (1, 2304, 512),
              (1, 4352, 128), (1, 7936, 512))),
            ("twopass_mix", sm.twopass_mix, sm.twopass_mix_ref,
             ((1, 16384, 512), (1, 32768, 512), (1, 65536, 512)))):
        for b, n, d in shapes:
            fh, cols = n // 2 + 1, 32
            v, gr, gi = randn(b, n, d), randn(b, fh, cols), randn(b, fh, cols)
            mem_t = randn(n, d)
            for mem in (True, False):
                args = (v, gr, gi, mem_t if mem else None, n)
                cases.append((
                    name, f"B={b} N={n} d={d} cols={cols} mem={int(mem)}",
                    lambda fn=fn, args=args: fn(*args),
                    lambda plain=plain, args=args: plain(*args),
                    lambda args=args: lib_mix(*args),
                    MIX_COST[name](b, n, d, cols, 4, mem),
                    mem and n in (4096, 16384)))
    return cases


def bf16_causal_cases(kc, randn):
    """The bf16 instances of #6 (its FFT kernel at the tiny LM's B=4 nc=16
    C=128 d=512 and at a 350M prompt of 512 tokens, nc=1 C=512 d=1024;
    its direct kernel at a 600-token prompt, C=600, where 2C = 1200 takes
    no FFT plan) and of #10's FFT kernel at the tiny LM's training batch
    (B=8 nc=16), against their plain versions on the same bf16 inputs
    (REL_BF16 on y and vbar, REL_KERNEL on the fp32 Kbar), each beside
    its fp32 instance on the same values; the bound with v, ybar, y and
    vbar at 2 bytes."""
    cases = []
    bf = torch.bfloat16
    for b, nc, chunk, d, cols, names, main in (
            (4, 16, 128, 512, 32, ("fused_causal_mix_bf16",), True),
            (1, 1, 512, 1024, 64, ("fused_causal_mix_bf16",), False),
            (1, 1, 600, 1024, 64, ("fused_causal_mix_direct_bf16",), True),
            (8, 16, 128, 512, 32, ("fused_causal_mix_bwd_bf16",), True)):
        v, ybar = (randn(b, nc * chunk, d).to(bf) for _ in range(2))
        kr, ki = (randn(b, nc, chunk + 1, nc * cols) for _ in range(2))
        v32, y32 = v.float(), ybar.float()
        shape = f"B={b} nc={nc} C={chunk} d={d} cols={cols}"
        name = names[0]
        if name == "fused_causal_mix_bwd_bf16":
            cases.append((
                name, shape,
                lambda v=v, kr=kr, ki=ki, yb=ybar, c=chunk, g=cols:
                    kc.fused_causal_mix_bwd(v, kr, ki, yb, c, g),
                lambda v=v, kr=kr, ki=ki, yb=ybar, c=chunk, g=cols:
                    kc.fused_causal_mix_bwd_ref(v, kr, ki, yb, c, g),
                lib_direct6_bwd(v, kr, ki, ybar, chunk, cols),
                fprof.fused_causal_mix_bwd_cost(b, nc, chunk, d, cols, 2),
                main,
                dict(tol=(REL_BF16, REL_KERNEL, REL_KERNEL),
                     fp32=lambda v=v32, kr=kr, ki=ki, yb=y32, c=chunk,
                     g=cols: kc.fused_causal_mix_bwd(v, kr, ki, yb, c, g))))
            continue
        cases.append((
            name, shape,
            lambda v=v, kr=kr, ki=ki, c=chunk, g=cols: kc.fused_causal_mix(
                v, kr, ki, c, g),
            lambda v=v, kr=kr, ki=ki, c=chunk, g=cols:
                kc.fused_causal_mix_ref(v, kr, ki, c, g),
            lambda v=v, kr=kr, ki=ki, c=chunk, g=cols: lib_direct6(
                v, kr, ki, c, g),
            fprof.fused_causal_mix_cost(b, nc, chunk, d, cols, 2), main,
            dict(tol=REL_BF16, fp32=lambda v=v32, kr=kr, ki=ki, c=chunk,
                 g=cols: kc.fused_causal_mix(v, kr, ki, c, g))))
    return cases


def bf16_mix_cases(sm, randn):
    """The bf16 instances of #1 and #2 at config 1 (B=8 N=1024 d=512, 32
    gate columns, memory), #3 at 4096 x 2 and 8192 x 1, #4 at 16384 and
    65536 x 1, against their plain versions on the same bf16 inputs
    (REL_BF16 on y and vbar, REL_KERNEL on the fp32 gate cotangent), each
    beside its fp32 instance on the same values and the cuFFT composition
    on them upcast (library_ms, the casts included); the bound with v,
    ybar, y and vbar at 2 bytes."""
    cases = []
    bf = torch.bfloat16
    d, cols = 512, 32
    for name, b, n, main in (("direct_mix", 8, 1024, True),
                             ("staged_mix", 2, 4096, True),
                             ("staged_mix", 1, 8192, False),
                             ("twopass_mix", 1, 16384, True),
                             ("twopass_mix", 1, 65536, False)):
        fh = n // 2 + 1
        v, ybar = (randn(b, n, d).to(bf) for _ in range(2))
        gr, gi, mem_t = randn(b, fh, cols), randn(b, fh, cols), randn(n, d)
        v32, y32 = v.float(), ybar.float()
        fn = getattr(sm, name)
        shape = f"B={b} N={n} d={d} cols={cols} mem=1"
        cases.append((
            name + "_bf16", shape,
            lambda fn=fn, v=v, gr=gr, gi=gi, m=mem_t, n=n: fn(v, gr, gi, m,
                                                              n),
            lambda v=v, gr=gr, gi=gi, m=mem_t, n=n: sm.direct_mix_ref(
                v, gr, gi, m, n),
            lambda v=v, gr=gr, gi=gi, m=mem_t, n=n: lib_mix(
                v.float(), gr, gi, m, n).to(bf),
            MIX_COST[name](b, n, d, cols, 2, True), main,
            dict(tol=REL_BF16, fp32=lambda fn=fn, v=v32, gr=gr, gi=gi,
                 m=mem_t, n=n: fn(v, gr, gi, m, n))))
        if name == "direct_mix":
            cases.append((
                "direct_mix_bwd_bf16", f"B={b} N={n} d={d} cols={cols}",
                lambda v=v, gr=gr, gi=gi, yb=ybar, n=n: sm.direct_mix_bwd(
                    v, gr, gi, yb, n),
                lambda v=v, gr=gr, gi=gi, yb=ybar, n=n:
                    sm.direct_mix_bwd_ref(v, gr, gi, yb, n),
                lambda v=v, gr=gr, gi=gi, yb=ybar, n=n: tuple(
                    t.to(bf) if i == 0 else t for i, t in enumerate(
                        lib_mix_bwd(v.float(), gr, gi, yb.float(), n))),
                fprof.direct_mix_bwd_cost(b, n, d, cols, 2), main,
                dict(tol=(REL_BF16, REL_KERNEL, REL_KERNEL),
                     fp32=lambda v=v32, gr=gr, gi=gi, yb=y32, n=n:
                         sm.direct_mix_bwd(v, gr, gi, yb, n))))
    return cases


def direct_sweep(sm, randn) -> None:
    """#1 (with memory) and #2 at every n_fft up to 2048 that the layer
    fuses (``mix_kernel``: the even n_fft from 8 to 256, 256 m up to 2048)
    with gate groups of 1, 3, 6, 16 and 64 channels (B=2, d=384), against
    their plain versions, untimed."""
    worst = {}
    d = 384
    for n in range(8, 2049, 2):
        if sm.mix_kernel(n) != "direct_mix":
            continue
        fh = n // 2 + 1
        v, ybar, mem_t = randn(2, n, d), randn(2, n, d), randn(n, d)
        for d_g in (1, 3, 6, 16, 64):
            gr, gi = randn(2, fh, d // d_g), randn(2, fh, d // d_g)
            for name, got, want in (
                    ("direct_mix", sm.direct_mix(v, gr, gi, mem_t, n),
                     sm.direct_mix_ref(v, gr, gi, mem_t, n)),
                    ("direct_mix_bwd", sm.direct_mix_bwd(v, gr, gi, ybar, n),
                     sm.direct_mix_bwd_ref(v, gr, gi, ybar, n))):
                torch.cuda.synchronize()
                err = rel_err(got, want)
                if not (err <= REL_KERNEL and all_finite(got)):
                    raise AssertionError(f"{name} n_fft {n} d_g {d_g}: "
                                         f"rel_err {err} > {REL_KERNEL} or "
                                         "non-finite")
                worst[name] = max(worst.get(name, 0.0), err)
    emit(phase="kernels_direct_sweep", d=d, group_widths=[1, 3, 6, 16, 64],
         lengths=sum(sm.mix_kernel(n) == "direct_mix"
                     for n in range(8, 2049, 2)), worst_rel_err=worst)


def staged_sweep(sm, randn) -> None:
    """#3 at every n_fft = 256 m, m = 9..32, against its plain version (each
    odd factor's instance of the kernel; B=1, d=128, 32 gate columns, with
    memory), untimed."""
    errs = {}
    for m in range(9, 33):
        n = 256 * m
        args = (randn(1, n, 128), randn(1, n // 2 + 1, 32),
                randn(1, n // 2 + 1, 32), randn(n, 128), n)
        got, want = sm.staged_mix(*args), sm.staged_mix_ref(*args)
        torch.cuda.synchronize()
        errs[n] = rel_err(got, want)
        if not (errs[n] <= REL_KERNEL and all_finite(got)):
            raise AssertionError(f"staged_mix n_fft {n}: rel_err {errs[n]} "
                                 f"> {REL_KERNEL} or non-finite")
    emit(phase="kernels_staged_sweep", d=128, rel_err=errs)


def lib_mix_bwd(v, gr, gi, ybar, n):
    """The cuFFT composition of #2's adjoint (which the port never calls):
    (vbar, the gate cotangent as one complex plane)."""
    b, _, d = v.shape
    fh, cols = n // 2 + 1, gr.shape[-1]
    d_g = d // cols
    gc = torch.complex(gr, gi)[..., None]
    coef = torch.full((fh, 1), 2.0, device=v.device)
    coef[0] = coef[-1] = 1.0
    u = torch.fft.rfft(ybar, dim=1).view(b, fh, cols, d_g) * (coef[
        ..., None] / n)
    x = torch.fft.rfft(v, dim=1).view(b, fh, cols, d_g)
    vbar = n * torch.fft.irfft((gc.conj() * u / coef[..., None]).view(
        b, fh, d), n, dim=1)
    return vbar, (u * x.conj()).sum(-1)


def mix_cases(sm, randn, b, n, d, cols, mem, main):
    """direct_mix and direct_mix_bwd at one shape, each beside the cuFFT
    composition of the same function (which the port never calls)."""
    fh = n // 2 + 1
    v, ybar = randn(b, n, d), randn(b, n, d)
    gr, gi = randn(b, fh, cols), randn(b, fh, cols)
    mem_t = randn(n, d) if mem else None

    def lib_fwd():
        return lib_mix(v, gr, gi, mem_t, n)

    def lib_bwd():
        return lib_mix_bwd(v, gr, gi, ybar, n)

    cases = [(
        "direct_mix", f"B={b} N={n} d={d} cols={cols} mem={int(mem)}",
        lambda: sm.direct_mix(v, gr, gi, mem_t, n),
        lambda: sm.direct_mix_ref(v, gr, gi, mem_t, n), lib_fwd,
        fprof.direct_mix_cost(b, n, d, cols, 4, mem), main)]
    if mem:                 # the adjoint takes no memory: once per shape
        cases.append((
            "direct_mix_bwd", f"B={b} N={n} d={d} cols={cols}",
            lambda: sm.direct_mix_bwd(v, gr, gi, ybar, n),
            lambda: sm.direct_mix_bwd_ref(v, gr, gi, ybar, n), lib_bwd,
            fprof.direct_mix_bwd_cost(b, n, d, cols), main))
    return cases


@contextlib.contextmanager
def same_modrelu_side(record: bool, sides: list, flips: list | None = None):
    """The gate's modReLU, ReLU(|z| + b) z / sqrt(|z|^2 + eps^2), has a kink
    at |z| + b = 0.  A few of the ~6.3e6 gate values of a full-width step at
    batch 2 can lie within fp32 rounding of it, so the card and the CPU can
    take different sides there; the gradient then jumps by that value's
    whole share (each bias entry sums only B * nc = 32 values) and moves
    the mixer parameters upstream of it by up to a few 1e-4, which says
    nothing about the kernels.  With
    ``record`` the card's run appends, per call, which side each value took;
    otherwise the CPU's run (or another run on the card) takes those sides,
    in call order, appending to ``flips`` (where given) how many values of
    each call it moved to the other side.  A value
    exactly on the kink (|z| = -b in fp32, as |z| = 0.1 meets the initial
    bias of -0.1) counts as on: torch.clamp's gradient passes there."""
    from fft_tpu_torch.layers import spectre
    plain = spectre.modrelu

    def modrelu(z, bias, eps=1e-4):
        mag = z.abs()
        if record:
            sides.append((mag + bias >= 0).detach().cpu())
            return plain(z, bias, eps)
        keep = sides.pop(0).to(z.device)
        if flips is not None:
            flips.append(int(((mag + bias >= 0) != keep).sum()))
        mag_stable = torch.sqrt(mag * mag + eps * eps)
        return z * (torch.where(keep, mag + bias, 0.0) / mag_stable)

    spectre.modrelu = modrelu
    try:
        yield
    finally:
        spectre.modrelu = plain


def train_parity(cfg, dev, tokens) -> dict:
    """One train_step of ``cfg`` from seed 0 on the card and on the CPU
    (modReLU kink sides aligned; the values the CPU moved, in the forward
    and its recompute): loss and every parameter gradient."""
    from fft_tpu_torch.models.lm import lm_init
    from fft_tpu_torch.train import TrainConfig, train_init, train_step

    def state_on(device):
        model = lm_init(cfg, torch.Generator().manual_seed(SEED), device)
        return train_init(model, TrainConfig(), seed=SEED + 1)

    gpu, cpu = state_on(dev), state_on("cpu")
    sides, flips = [], []
    with same_modrelu_side(True, sides):
        got = train_step(gpu, tokens)
        torch.cuda.synchronize()
    with same_modrelu_side(False, list(sides), flips):
        want = train_step(cpu, tokens)
    loss, ref_loss = float(got["loss"]), float(want["loss"])
    grad_errs = {}
    for (name, pg), (_, pc) in zip(gpu.model.named_parameters(),
                                   cpu.model.named_parameters()):
        if pc.grad is None or pg.grad is None:   # the unused wavelet MLP
            if pc.grad is not pg.grad:
                raise AssertionError(f"{name} has a gradient on one device "
                                     "only")
            continue
        grad_errs[name] = rel_err(pg.grad, pc.grad)
    worst = max(grad_errs, key=grad_errs.get)
    return dict(loss=loss, cpu_loss=ref_loss,
                loss_rel_err=abs(loss - ref_loss) / abs(ref_loss),
                max_grad_rel_err=grad_errs[worst], worst_grad=worst,
                tensors=len(grad_errs), modrelu_sides_aligned=sum(flips),
                finite=math.isfinite(loss))


def phase_train(cfg, dev) -> float:
    """Gradient parity with the CPU, 5 steps at the CLI's batch (#10's FFT
    kernel launched once a layer a step, its direct kernel never) and 2
    more under torch.profiler, the CLI.  Returns the median step ms."""
    from fft_tpu_torch import cli
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.models.lm import lm_init
    from fft_tpu_torch.train import TrainConfig, train_init, train_step
    from fft_tpu_torch.train.data import CharDataset

    data = CharDataset()                      # the synthetic corpus
    seq = cfg.max_seq
    res = train_parity(cfg, dev, next(data.batches(2, seq, seed=SEED)))
    emit(phase="train_parity", batch=2, seq=seq, **res)
    if not (res["finite"] and res["loss_rel_err"] <= REL_MODEL
            and res["max_grad_rel_err"] <= REL_MODEL):
        raise AssertionError(f"train: loss rel_err {res['loss_rel_err']}, "
                             f"worst gradient {res['worst_grad']} rel_err "
                             f"{res['max_grad_rel_err']} (limit {REL_MODEL})")

    state = train_init(lm_init(cfg, torch.Generator().manual_seed(SEED), dev),
                       TrainConfig(), seed=SEED + 1)
    batches = data.batches(8, seq, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses, norms = [], [], []
    bwd_before = {k: kc.LAUNCHES[k] for k in ("fused_causal_mix_bwd",
                                              "fused_causal_mix_bwd_direct")}
    for _ in range(5):
        batch = next(batches)
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated()
    bwd = {k: kc.LAUNCHES[k] - n for k, n in bwd_before.items()}
    if (bwd["fused_causal_mix_bwd"] != 5 * cfg.num_layers
            or bwd["fused_causal_mix_bwd_direct"]):
        raise AssertionError(f"train: #10's launches in 5 steps {bwd}, not "
                             f"once a layer a step through the FFT kernel")
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"train: non-finite loss {losses} or grad_norm "
                             f"{norms}")
    ms = statistics.median(step_ms[1:])       # the first builds cuFFT plans
    prof = fprof.read_profile(lambda: train_step(state, batch),
                              torch.cuda.synchronize, 2, BWD_KERNEL_NAMES)
    emit(phase="train_steps", batch=8, seq=seq, step_ms=step_ms,
         median_step_ms=ms, tokens_per_s=8 * seq / (ms / 1e3), loss=losses,
         grad_norm=norms, peak_memory_bytes=peak, bwd_launches_5_steps=bwd,
         profile=prof)
    del state

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["train-lm", "--device", "cuda", "--steps", "3"])
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    if not recs or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"cli train-lm printed {buf.getvalue()!r}")
    emit(phase="cli_train_lm", steps=3, lines=recs)
    return ms


def teacher_forced(model, model_cpu, prompts, toks, dev):
    """(prefill logits' rel_err, worst decode step's rel_err) of ``model``
    on the card against ``model_cpu``: one prefill of ``prompts`` (on the
    CPU), then one decode step per column of ``toks`` fed on both sides
    (greedy tokens are not compared: argmax ties flip on 1e-6
    differences)."""
    from fft_tpu_torch.models.lm import lm_decode_step, lm_prefill

    length = prompts.shape[1]
    logits, caches = lm_prefill(model, prompts.to(dev))
    ref, ref_caches = lm_prefill(model_cpu, prompts)
    p_err = rel_err(logits, ref)
    errs = []
    for i in range(toks.shape[1]):
        tok = toks[:, i]
        logits, caches = lm_decode_step(model, tok.to(dev), length + i,
                                        caches)
        ref, ref_caches = lm_decode_step(model_cpu, tok.cpu(), length + i,
                                         ref_caches)
        if not all_finite(logits):
            raise AssertionError(f"decode step {i}: non-finite logits")
        errs.append(rel_err(logits, ref))
    return p_err, max(errs)


def both_branches(kd, run, profile):
    """Median of ``run()`` (ms a token) with kernels.decode.ENABLE off and
    on, in turns (plain, fused, fused, plain, twice each after a warm-up),
    and ``profile()`` under each; ENABLE is put back as it was."""
    default = kd.ENABLE
    times, profs = {False: [], True: []}, {}
    try:
        for flag in (False, True):
            kd.ENABLE = flag
            run()
        for flag in (False, True, True, False):
            kd.ENABLE = flag
            times[flag] += [run(), run()]
        for flag in (False, True):
            kd.ENABLE = flag
            profs[flag] = profile()
    finally:
        kd.ENABLE = default
    return {k: statistics.median(v) for k, v in times.items()}, profs


def decode_profile(model, prompt, pos, tok, steps):
    """torch.profiler over ``steps`` decode steps after a prefill."""
    from fft_tpu_torch.models.lm import lm_decode_step, lm_prefill

    _, caches = lm_prefill(model, prompt)
    state = {"i": 0}

    def step():
        lm_decode_step(model, tok, pos + state["i"], caches)
        state["i"] += 1

    step()
    torch.cuda.synchronize()
    return fprof.read_profile(step, torch.cuda.synchronize, steps)


def phase_decode_wrap(cfg, dev) -> None:
    """4c: one block at the tiny LM's width (B=4, d=512, 8 heads, n_fft
    2048): prefill the full window, then 64 fused decode steps, each
    evicting the window's oldest token, fed fresh random tokens; outputs,
    the final prefix and query sum against the same on the CPU."""
    from fft_tpu_torch.decode.cache import (
        cache_init, spectre_block_decode_step, spectre_block_prefill,
    )
    from fft_tpu_torch.kernels import decode as kd
    from fft_tpu_torch.layers.spectre import spectre_block_init

    bc, b, steps = cfg.block, 4, 64
    g = torch.Generator().manual_seed(SEED + 5)
    x = torch.randn((b, bc.n_fft, bc.embed_dim), generator=g)
    xs = torch.randn((steps, b, bc.embed_dim), generator=g)

    def run(device):
        block = spectre_block_init(bc, torch.Generator().manual_seed(SEED),
                                   device)
        with torch.no_grad():
            cache = spectre_block_prefill(
                block, x.to(device), cache_init(b, bc.num_heads, bc.n_fft,
                                                bc.head_dim, device=device))
            outs = []
            for i in range(steps):
                y, cache = spectre_block_decode_step(block, xs[i].to(device),
                                                     cache)
                outs.append(y)
        return (torch.stack(outs), torch.view_as_real(cache.prefix),
                cache.sum_q), cache.t

    before = kd.LAUNCHES["fused_decode_mix"]
    got, t = run(dev)
    torch.cuda.synchronize()
    launched = kd.LAUNCHES["fused_decode_mix"] - before
    want, _ = run("cpu")
    errs = [rel_err(a, w) for a, w in zip(got, want)]
    emit(phase="decode_wrap", batch=b, n_fft=bc.n_fft, steps=steps,
         last_t=t, evicting_steps=steps, fused_decode_launches=launched,
         rel_err_outputs=errs[0], rel_err_prefix=errs[1],
         rel_err_sum_q=errs[2])
    if not (all_finite(got) and max(errs) <= REL_DECODE and launched == steps
            and t == bc.n_fft + steps - 1):
        raise AssertionError(f"decode past the wrap: rel_err {errs} (limit "
                             f"{REL_DECODE}), {launched} launches")


def phase_pooler_lm(cfg, dev) -> None:
    """4d: a 2-layer causal LM at the tiny width with the DCT pooler (its
    chunk gates) and the window descriptor (its decode): lm_apply on 2 x
    2048 and 8 teacher-forced decode steps after a 1024-token prefill,
    against the CPU."""
    from fft_tpu_torch.models.lm import lm_apply, lm_init

    pcfg = dataclasses.replace(
        cfg, num_layers=2, block=dataclasses.replace(
            cfg.block, pooling_type="dct", decode_descriptor="window"))
    gpu = lm_init(pcfg, torch.Generator().manual_seed(SEED), dev)
    cpu = lm_init(pcfg, torch.Generator().manual_seed(SEED), "cpu")
    toks = torch.randint(0, pcfg.vocab_size, (2, pcfg.max_seq),
                         generator=torch.Generator().manual_seed(SEED + 6))
    logits = lm_apply(gpu, toks.to(dev))
    torch.cuda.synchronize()
    a_err = rel_err(logits, lm_apply(cpu, toks))
    p_err, d_err = teacher_forced(gpu, cpu, toks[:, :1024],
                                  toks[:, 1024:1032], dev)
    emit(phase="pooler_lm", pooling="dct", decode_descriptor="window",
         layers=2, apply_rel_err=a_err, prefill_rel_err=p_err,
         decode_rel_err=d_err, teacher_forced_steps=8)
    if not (all_finite(logits) and max(a_err, p_err, d_err) <= REL_MODEL):
        raise AssertionError(f"pooler LM: lm_apply {a_err}, prefill {p_err}"
                             f", decode {d_err} (limit {REL_MODEL})")


def phase_wide_block(dev) -> None:
    """A block at n_fft 16384 (B=1, N=16384, d=512, fft_impl="pallas"):
    past the spectral-mix kernels the reference runs the d-wide
    composition, and so does the port (it raised naming kernel #4 before)."""
    from fft_tpu_torch import bench
    from fft_tpu_torch.layers.spectre import (
        MIX_BRANCH_CALLS, spectre_block_apply, spectre_block_init,
    )

    cfg = bench.config1(16384, "float32")
    x = torch.randn((1, 16384, cfg.embed_dim),
                    generator=torch.Generator().manual_seed(SEED + 7))
    MIX_BRANCH_CALLS.clear()
    with torch.no_grad():
        y = spectre_block_apply(spectre_block_init(
            cfg, torch.Generator().manual_seed(SEED), dev), x.to(dev))
        torch.cuda.synchronize()
        branches = dict(MIX_BRANCH_CALLS)
        err = rel_err(y, spectre_block_apply(spectre_block_init(
            cfg, torch.Generator().manual_seed(SEED), "cpu"), x))
    emit(phase="wide_block", n_fft=cfg.n_fft, batch=1, seq=16384,
         d=cfg.embed_dim, fft_impl=cfg.fft_impl, branches=branches,
         rel_err=err)
    if not (all_finite(y) and err <= REL_BLOCK
            and branches == {"wide": 1}):
        raise AssertionError(f"wide block: rel_err {err} (limit {REL_BLOCK}),"
                             f" branches {branches}")


def block_parity(cfg, x, dev) -> dict:
    """A block of ``cfg`` from seed 0 on the card and on the CPU (modReLU
    kink sides aligned): forward within REL_BLOCK, every parameter
    gradient of sum(y^2) within REL_MODEL; also the non-causal branches
    the card's forward took."""
    from fft_tpu_torch.layers.spectre import (
        MIX_BRANCH_CALLS, spectre_block_apply, spectre_block_init,
    )

    def block_on(device):
        return spectre_block_init(cfg, torch.Generator().manual_seed(SEED),
                                  device)

    gpu, cpu = block_on(dev), block_on("cpu")
    sides, flips = [], []
    MIX_BRANCH_CALLS.clear()
    with same_modrelu_side(True, sides):
        y = spectre_block_apply(gpu, x.to(dev))
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
    branches = dict(MIX_BRANCH_CALLS)
    with same_modrelu_side(False, list(sides), flips):
        y_cpu = spectre_block_apply(cpu, x)
        (y_cpu ** 2).sum().backward()
    err = rel_err(y, y_cpu)
    grad_errs = {}
    for (name, pg), (_, pc) in zip(gpu.named_parameters(),
                                   cpu.named_parameters()):
        if pc.grad is None or pg.grad is None:   # the unused wavelet MLP
            if pc.grad is not pg.grad:
                raise AssertionError(f"block: {name} has a gradient on one "
                                     "device only")
            continue
        grad_errs[name] = rel_err(pg.grad, pc.grad)
    worst = max(grad_errs, key=grad_errs.get)
    if not (all_finite(y) and err <= REL_BLOCK
            and grad_errs[worst] <= REL_MODEL):
        raise AssertionError(f"block n_fft {cfg.n_fft}: forward rel_err "
                             f"{err} (limit {REL_BLOCK}), worst gradient "
                             f"{worst} rel_err {grad_errs[worst]} (limit "
                             f"{REL_MODEL})")
    return dict(batch=x.shape[0], seq=x.shape[1], n_fft=cfg.n_fft,
                rel_err=err, max_grad_rel_err=grad_errs[worst],
                worst_grad=worst, tensors=len(grad_errs),
                modrelu_sides_aligned=sum(flips), branches=branches)


def phase_block(dev) -> None:
    """BASELINE config 1's block in fp32: parity with the CPU, timed steps
    through the bench, and the original constructor's defaults (the
    bench's CLI, bf16 as bench.py's, runs in phase_block_bf16)."""
    from fft_tpu_torch import bench
    from fft_tpu_torch.layers.spectre import (
        spectre_block_apply, spectre_block_init,
    )

    cfg = bench.config1(compute_dtype="float32")

    def block_on(device, c=cfg):
        return spectre_block_init(c, torch.Generator().manual_seed(SEED),
                                  device)

    x = torch.randn((bench.B, bench.L, bench.D),
                    generator=torch.Generator().manual_seed(SEED + 2))
    emit(phase="block_parity", **block_parity(cfg, x, dev))

    # step ms, and the device's busy ms a step from 3 profiled steps
    res = bench.run(steps=5, device=dev, seed=SEED, profile_steps=3,
                    compute_dtype="float32")
    emit(phase="block_steps", steps=5, **res)

    # the original constructor's defaults: DCT pooling, wavelet rate 0.1
    # (on for a row with probability 0.1 in training), no memory
    dcfg = dataclasses.replace(cfg, pooling_type="dct", wavelet_on_rate=0.1,
                               memory_size=0)
    seed = next(s for s in range(100) if bool((torch.rand(
        (bench.B, 1, 1), device=dev,
        generator=torch.Generator(device=dev).manual_seed(s)) < 0.1).any()))
    gpu = block_on(dev, dcfg).train()
    y = spectre_block_apply(
        gpu, x.to(dev),
        generator=torch.Generator(device=dev).manual_seed(seed))
    (y ** 2).sum().backward()
    grads = [p.grad for p in gpu.parameters()]
    if not (all_finite(y) and all(g is not None and all_finite(g)
                                  for g in grads)):
        raise AssertionError("defaults block: non-finite output or a "
                             "missing or non-finite gradient in training")
    with torch.no_grad():
        err = rel_err(spectre_block_apply(gpu.eval(), x.to(dev)),
                      spectre_block_apply(block_on("cpu", dcfg), x))
    if err > REL_BLOCK:
        raise AssertionError(f"defaults block: eval forward rel_err {err} > "
                             f"{REL_BLOCK}")
    emit(phase="block_defaults", pooling="dct", wavelet_on_rate=0.1,
         generator_seed=seed, train_finite=True, tensors=len(grads),
         eval_rel_err=err)


def phase_block_1536(dev, sm) -> None:
    """The config-1 block at n_fft = L = 1536 (256 * 3), B=4: parity with
    the CPU on the fused branch, direct_mix and direct_mix_bwd launched
    (the lengths 768-1792 raised on the card before #1 and #2 took odd
    factors)."""
    from fft_tpu_torch import bench

    cfg = bench.config1(1536, "float32")
    x = torch.randn((4, 1536, bench.D),
                    generator=torch.Generator().manual_seed(SEED + 9))
    before = dict(sm.LAUNCHES)
    rec = block_parity(cfg, x, dev)
    launched = {k: sm.LAUNCHES[k] - before[k]
                for k in ("direct_mix", "direct_mix_bwd")}
    emit(phase="block_1536", launches=launched, **rec)
    if rec["branches"] != {"fused": 1} or not all(launched.values()):
        raise AssertionError(f"block at n_fft 1536: branches "
                             f"{rec['branches']}, launches {launched}")


def phase_block_long(dev) -> None:
    """7b: the config-1 block at n_fft = L = 4096 (B=2) and 8192 (B=1):
    parity with the CPU on the fused branch (#3 forward), then 5 timed
    steps through the bench, and the mix's backward at the block's shape
    beside the part of it that autograd computes and drops."""
    from fft_tpu_torch import bench
    from fft_tpu_torch.kernels import spectral_mix as sm
    from fft_tpu_torch.ops import fftops

    for seq, batch in ((4096, 2), (8192, 1)):
        cfg = bench.config1(seq, "float32")
        x = torch.randn((batch, seq, bench.D),
                        generator=torch.Generator().manual_seed(SEED + seq))
        res = block_parity(cfg, x, dev)
        emit(phase="block_long_parity", **res)
        if res["branches"] != {"fused": 1}:
            raise AssertionError(f"block n_fft {seq} took {res['branches']}")
        steps = bench.run(steps=5, batch=batch, seq=seq, device=dev,
                          seed=SEED, profile_steps=3, compute_dtype="float32")
        emit(phase="block_long_steps", steps=5, **steps)
        if not math.isfinite(steps["loss"]):
            raise AssertionError(f"block n_fft {seq}: loss {steps['loss']}")
        # above n_fft 2048 the backward is autograd through unfused_mix,
        # which re-runs its forward: the gate product and the irfft of that
        # forward are computed and dropped
        cols = cfg.num_heads * cfg.num_groups
        g = torch.Generator().manual_seed(SEED + seq + 1)
        v, ybar = (torch.randn((batch, seq, bench.D), generator=g).to(dev)
                   for _ in range(2))
        gr, gi = (torch.randn((batch, seq // 2 + 1, cols),
                              generator=g).to(dev) for _ in range(2))
        x_f = fftops.rfft(v, seq, dim=-2)
        g_e = torch.complex(gr, gi).repeat_interleave(bench.D // cols, -1)

        def bwd():
            return sm._unfused_vjp(v, gr, gi, ybar, seq)

        def dropped():
            return fftops.irfft(g_e * x_f, seq, dim=-2)

        emit(phase="block_long_backward", n_fft=seq, batch=batch, cols=cols,
             mix_bwd_ms=median_ms(bwd, reps=3, rounds=5),
             **device_ms(bwd, reps=3, key="mix_bwd_device_ms"),
             dropped_forward_ms=median_ms(dropped, reps=3, rounds=5),
             **device_ms(dropped, reps=3,
                         key="dropped_forward_device_ms"))
        del v, ybar, gr, gi, x_f, g_e     # the next length's peak is its own


def flag_turns(sm, run) -> dict:
    """Median ms of ``run()`` with TWOPASS_ENABLE on ("twopass") and off
    ("wide"), in turns (off, on, on, off)."""
    times = {False: [], True: []}
    for flag in (False, True, True, False):
        sm.TWOPASS_ENABLE = flag
        times[flag].append(median_ms(run, reps=3, rounds=5))
    return {"twopass": statistics.median(times[True]),
            "wide": statistics.median(times[False])}


def phase_twopass(dev, sm) -> int:
    """7c: with TWOPASS_ENABLE on, the block at n_fft 16384 and 65536 (B=1)
    on the fused branch (#4) against the CPU; then at 16384, 32768 and
    65536 the block's forward with the flag on and off in turns, the fused
    branch's mem_t, and a profile of the forward with each.  The flag is
    put back as it was.  Only block forwards launch kernels here; returns
    how many ran with the flag on (each launches #4 once)."""
    from fft_tpu_torch import bench
    from fft_tpu_torch.layers.spectre import (
        MIX_BRANCH_CALLS, spectre_block_apply, spectre_block_init,
    )
    from fft_tpu_torch.ops import fftops

    forwards_on = 0

    def forward(block, x):
        nonlocal forwards_on
        forwards_on += bool(sm.TWOPASS_ENABLE)
        return spectre_block_apply(block, x)

    default = sm.TWOPASS_ENABLE
    try:
        for n in (16384, 32768, 65536):
            cfg = bench.config1(n, "float32")
            x = torch.randn((1, n, cfg.embed_dim),
                            generator=torch.Generator().manual_seed(SEED + n))
            rec = dict(n_fft=n, batch=1, seq=n)
            with torch.no_grad():
                gpu = spectre_block_init(
                    cfg, torch.Generator().manual_seed(SEED), dev)
                xd = x.to(dev)
                if n != 32768:
                    sm.TWOPASS_ENABLE = True
                    MIX_BRANCH_CALLS.clear()
                    y = forward(gpu, xd)
                    torch.cuda.synchronize()
                    branches = dict(MIX_BRANCH_CALLS)
                    err = rel_err(y, spectre_block_apply(spectre_block_init(
                        cfg, torch.Generator().manual_seed(SEED), "cpu"), x))
                    rec.update(rel_err=err, branches=branches)
                    if not (all_finite(y) and err <= REL_BLOCK
                            and branches == {"fused": 1}):
                        raise AssertionError(
                            f"two-pass block n_fft {n}: rel_err {err} "
                            f"(limit {REL_BLOCK}), branches {branches}")
                    del y
                rec["block_forward_ms"] = flag_turns(
                    sm, lambda: forward(gpu, xd))
                # what the fused branch adds in every forward: the memory's
                # time-domain constant, made contiguous for the kernel
                mem = gpu.memory_complex()
                rec["mem_t_ms"] = median_ms(
                    lambda: fftops.irfft(mem, n, dim=0).contiguous(), reps=3,
                    rounds=5)
                for flag, key in ((False, "wide"), (True, "twopass")):
                    sm.TWOPASS_ENABLE = flag
                    rec["forward_profile_" + key] = fprof.read_profile(
                        lambda: forward(gpu, xd), torch.cuda.synchronize, 2)
            sm.TWOPASS_ENABLE = default
            emit(phase="twopass_block", **rec)
            del gpu, xd
    finally:
        sm.TWOPASS_ENABLE = default
    return forwards_on


def phase_350m_parity(dev, kc) -> None:
    """SPECTRE-350M cut to 2 layers, 8192 tokens: the kf_seg branch and the
    long-chunk kernels (nc = 4) on the card against the CPU."""
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.models.lm import lm_apply, lm_init, spectre_350m_config

    cfg = dataclasses.replace(spectre_350m_config(), num_layers=2)
    n = 8192
    tokens = torch.randint(0, cfg.vocab_size, (1, n + 1),
                           generator=torch.Generator().manual_seed(SEED + 3))
    kc.reset_launches()
    BRANCH_CALLS.clear()
    gpu = lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
    logits = lm_apply(gpu, tokens[:, :n].to(dev))
    torch.cuda.synchronize()
    branches = dict(BRANCH_CALLS)
    cpu = lm_init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    ref = lm_apply(cpu, tokens[:, :n])
    logit_err = rel_err(logits, ref)
    finite = all_finite(logits)
    del logits, ref
    tf_prefill_err, tf_decode_err = teacher_forced(
        gpu, cpu, tokens[:, :1024], tokens[:, 1024:1028], dev)
    # a 1500-token prompt: chunk 1500, nc = 1, banded_inverse (Bluestein)
    BRANCH_CALLS.clear()
    banded_before = kc.LAUNCHES["banded_inverse"]
    logits = lm_apply(gpu, tokens[:, :1500].to(dev))
    ref = lm_apply(cpu, tokens[:, :1500])
    p1500_logit_err = rel_err(logits, ref)
    finite = finite and all_finite(logits)
    del logits, ref
    p1500_prefill_err, p1500_decode_err = teacher_forced(
        gpu, cpu, tokens[:, :1500], tokens[:, 1500:1502], dev)
    p1500 = dict(logits_rel_err=p1500_logit_err,
                 prefill_rel_err=p1500_prefill_err,
                 decode_rel_err=p1500_decode_err,
                 branches=dict(BRANCH_CALLS),
                 banded_launches=kc.LAUNCHES["banded_inverse"]
                 - banded_before)
    del gpu, cpu
    res = train_parity(cfg, dev, tokens.numpy().astype("int32"))
    used = {k: v for k, v in kc.LAUNCHES.items() if v}
    emit(phase="350m_parity", layers=cfg.num_layers, seq=n,
         chunk=cfg.block.causal_chunk, logits_rel_err=logit_err,
         decode_prefill_rel_err=tf_prefill_err,
         decode_rel_err=tf_decode_err, teacher_forced_steps=4,
         branches=branches, launches=used, prompt_1500=p1500, **res)
    if not (finite and res["finite"] and logit_err <= REL_MODEL
            and max(tf_prefill_err, tf_decode_err) <= REL_MODEL
            and max(p1500_logit_err, p1500_prefill_err,
                    p1500_decode_err) <= REL_MODEL
            and res["loss_rel_err"] <= REL_MODEL
            and res["max_grad_rel_err"] <= REL_MODEL):
        raise AssertionError(f"350m parity: logits {logit_err}, decode "
                             f"{tf_prefill_err} / {tf_decode_err}, loss "
                             f"{res['loss_rel_err']}, worst gradient "
                             f"{res['worst_grad']} {res['max_grad_rel_err']} "
                             f"(limit {REL_MODEL})")
    if branches != {"kf_seg": cfg.num_layers} or not all(
            used.get(k) for k in TRAIN_350M_KERNELS):
        raise AssertionError(f"350m parity took {branches}, launched {used}")
    # lm_apply and two prefills (teacher_forced's, the CPU's not counted)
    if (p1500["branches"] != {"banded": 4 * cfg.num_layers}
            or p1500["banded_launches"] != 2 * cfg.num_layers):
        raise AssertionError(f"350m parity at 1500 tokens: {p1500}")


def prefill_350m(model, x, length: int) -> dict:
    """The 350M's prefill of x's first ``length`` tokens: finite logits,
    the median wall ms of 3 calls ending in a synchronize, and one call
    under torch.profiler (device busy ms, idle share, kernels by name);
    ``calls``: the prefills run."""
    from fft_tpu_torch.models.lm import lm_prefill

    prompt = x[:, :length]
    lg, _ = lm_prefill(model, prompt)
    if not all_finite(lg):
        raise AssertionError(f"350m prefill {length}: non-finite")
    del lg
    ms = wall_ms(lambda: lm_prefill(model, prompt), rounds=3)
    prof = fprof.read_profile(lambda: lm_prefill(model, prompt),
                              torch.cuda.synchronize, 1,
                              ("banded_fft_kernel", "banded_inverse",
                           "segment_fft_kernel", "segment_rfft_kernel"))
    return dict(ms=ms, profile=prof, calls=1 + 1 + 3 + 1)


def tree_compare() -> None:
    """One tree's side of a comparison of two trees in one call: run from
    a process whose ``fft_tpu_torch`` is the tree to time (this file
    loaded by its path), it emits banded_launch_split (#5 and the direct
    #6 by CUDA kernel) and the full-depth 350M's prefills (prefill_350m)
    of 1500 tokens in fp32 (#5) and of 600 tokens in bf16 and fp32 (the
    direct #6) for that tree."""
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.models.lm import lm_init, spectre_350m_config

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g).to(dev)

    banded_launch_split(kc, randn)
    cfg = spectre_350m_config()
    x = torch.randint(0, cfg.vocab_size, (1, 1500),
                      generator=torch.Generator().manual_seed(SEED + 4)
                      ).to(dev)
    for mode, c, lengths in (("float32", cfg, (1500, 600)),
                             ("bfloat16", bf16_config(cfg), (600,))):
        model = lm_init(c, torch.Generator().manual_seed(SEED), dev)
        with torch.no_grad():
            for length in lengths:
                res = prefill_350m(model, x, length)
                emit(phase=f"tree_compare_prefill_{length}", mode=mode,
                     tree=kc.__file__, ms=res["ms"], profile=res["profile"])
        del model


def phase_350m(dev, kd, reset_launches, launches):
    """SPECTRE-350M at seq 16384, full depth: scoring, prefill, decode, the
    CLI's generate (the serving path), then train steps, a profiled step
    and the CLI's train-lm (the training path).  Returns the launches of
    the two paths."""
    import tempfile

    from fft_tpu_torch import cli
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.models.lm import (
        lm_apply, lm_decode_step, lm_init, lm_prefill, spectre_350m_config,
    )
    from fft_tpu_torch.train import TrainConfig, train_init, train_step
    from fft_tpu_torch.train.data import synthetic_corpus

    cfg = spectre_350m_config()
    seq = cfg.max_seq
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + 1),
                           generator=torch.Generator().manual_seed(SEED + 4))
    model = lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
    params = sum(p.numel() for p in model.parameters())
    x = tokens[:, :seq].to(dev)

    reset_launches()                          # the 350M's serving path
    BRANCH_CALLS.clear()
    logits = lm_apply(model, x)
    torch.cuda.synchronize()
    if not (logits.shape == (1, seq, cfg.vocab_size) and all_finite(logits)):
        raise AssertionError(f"350m score: shape {tuple(logits.shape)} or "
                             "non-finite")
    del logits
    score_ms = wall_ms(lambda: lm_apply(model, x), rounds=3)
    prefill_ms = {}
    for length in (8192, 1024):
        prompt = x[:, :length]
        lg, caches = lm_prefill(model, prompt)
        if not all_finite(lg):
            raise AssertionError(f"350m prefill {length}: non-finite")
        del lg, caches
        prefill_ms[length] = wall_ms(lambda: lm_prefill(model, prompt),
                                     rounds=3)
    # a prompt of 854-2047 tokens but 1024: #5 once a layer
    before = launches()["banded_inverse"]
    p1500 = prefill_350m(model, x, 1500)
    banded_1500 = launches()["banded_inverse"] - before
    if banded_1500 != cfg.num_layers * p1500["calls"]:
        raise AssertionError(f"350m prefill 1500: banded_inverse launched "
                             f"{banded_1500} times in {p1500['calls']} "
                             f"prefills of {cfg.num_layers} layers")
    prefill_ms[1500] = p1500["ms"]
    profiles = {
        "score": fprof.read_profile(lambda: lm_apply(model, x),
                                    torch.cuda.synchronize, 1,
                                    LONG_KERNEL_NAMES),
        "prefill_1024": fprof.read_profile(
            lambda: lm_prefill(model, x[:, :1024]), torch.cuda.synchronize,
            1, LONG_KERNEL_NAMES),
        "prefill_1500": p1500["profile"]}
    steps = 16
    finite = []

    def decode_run():
        lg, caches = lm_prefill(model, x[:, :1024])
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, caches = lm_decode_step(model, tok, 1024 + i, caches)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
        finite.append(all_finite(lg))
        return (time.perf_counter() - t0) * 1e3 / steps

    decode_ms, decode_prof = both_branches(
        kd, decode_run, lambda: decode_profile(
            model, x[:, :1024], 1024, x[:, 1024], 4))
    if not all(finite):
        raise AssertionError("350m decode: non-finite logits")
    before = kd.LAUNCHES["fused_decode_mix"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["generate", "--device", "cuda", "--preset", "350m",
                  "--seq", str(seq), "--steps", str(steps)])
    cli_launches = kd.LAUNCHES["fused_decode_mix"] - before
    if not buf.getvalue().startswith("the "):
        raise AssertionError(f"cli generate --preset 350m printed "
                             f"{buf.getvalue()!r}")
    if cli_launches != cfg.num_layers * (steps - 1):
        raise AssertionError(f"cli generate --preset 350m: fused_decode_mix "
                             f"launched {cli_launches} times, not once a "
                             f"layer per decode step")
    serve = launches()
    serve_branches = dict(BRANCH_CALLS)
    emit(phase="350m_serve", params=params, seq=seq,
         chunk=cfg.block.causal_chunk, score_ms=score_ms,
         score_tokens_per_s=seq / (score_ms / 1e3),
         prefill_ms={str(k): v for k, v in prefill_ms.items()},
         decode_ms_per_token=decode_ms[True],
         decode_ms_per_token_plain=decode_ms[False],
         decode_profile_fused=decode_prof[True],
         decode_profile_plain=decode_prof[False],
         cli_generate_chars=len(buf.getvalue()),
         cli_fused_decode_launches=cli_launches,
         branches=serve_branches, launches=serve, profiles=profiles)
    missing = [k for k in SERVE_350M_KERNELS if serve[k] == 0]
    if missing or serve_branches.get("composition"):
        raise AssertionError(f"350m serving: kernels never launched "
                             f"{missing}, branches {serve_branches}")

    reset_launches()                          # the 350M's training path
    BRANCH_CALLS.clear()
    state = train_init(model, TrainConfig(), seed=SEED + 1)
    batches = [torch.randint(0, cfg.vocab_size, (1, seq + 1),
                             generator=torch.Generator().manual_seed(s))
               for s in range(3)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"350m train: non-finite loss {losses}")
    ms = statistics.median(step_ms[1:])
    prof = fprof.read_profile(lambda: train_step(state, batches[0]),
                              torch.cuda.synchronize, 1, LONG_KERNEL_NAMES)
    emit(phase="350m_train", batch=1, seq=seq, step_ms=step_ms,
         median_step_ms=ms, tokens_per_s=seq / (ms / 1e3), loss=losses,
         peak_memory_bytes=peak, profile=prof)
    del state, model, x
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/corpus.txt"
        with open(path, "w", encoding="utf-8") as f:
            f.write(synthetic_corpus(200_000, seed=SEED))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["train-lm", "--device", "cuda", "--preset", "350m",
                      "--data", path, "--seq", str(seq), "--batch", "1",
                      "--steps", "2", "--log-every", "1"])
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    notes = [line for line in buf.getvalue().splitlines()
             if not line.startswith("{")]
    if (not recs or not all(math.isfinite(r["loss"]) for r in recs)
            or notes != [NATIVE_LINE]):
        raise AssertionError(f"cli train-lm --preset 350m printed "
                             f"{buf.getvalue()!r}")
    train = launches()
    train_branches = dict(BRANCH_CALLS)
    emit(phase="350m_cli_train_lm", steps=2, lines=recs, notes=notes,
         branches=train_branches, launches=train)
    missing = [k for k in TRAIN_350M_KERNELS if train[k] == 0]
    if missing or train_branches.get("composition"):
        raise AssertionError(f"350m training: kernels never launched "
                             f"{missing}, branches {train_branches}")
    return serve, train


def long_parity_run(cfg, device, tokens, sides, record, swap=None) -> dict:
    """One train step of ``cfg`` (an LMConfig: train_step; a HybridConfig:
    hybrid_train_step) from seed 0 on ``device``: its loss, its
    parameter gradients (fp32, on the CPU) and the logits of its forward
    (fp32, left on ``device``; the train loss's chunked head, kept as its
    forward makes them: no scoring pass of its own), the modReLUs on the
    sides in ``sides`` (a list; ``record``: this run appends its own).
    ``swap``: functions of ``kernels.causal`` replaced for the run (by
    name), for the checks' controls.  On the CPU the reference recomputes
    nothing (remat off, the chunked CE's chunks not checkpointed): the
    same function with a quarter less CPU work; every forward records its
    modReLU sides before any recompute does, so the recomputes' entries
    are left over."""
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.models.hybrid import HybridConfig, hybrid_init
    from fft_tpu_torch.models.lm import lm_init
    from fft_tpu_torch.train import (
        TrainConfig, hybrid_train_step, loop, train_init, train_step)

    seq = tokens.shape[1] - 1
    flips, chunks = [], []
    head, kept = loop.head_logits, {k: getattr(kc, k) for k in swap or {}}

    def keep_head(h, w):
        out = head(h, w)
        if sum(c.shape[1] for c in chunks) < seq:  # the forward, not remat
            chunks.append(out.detach())
        return out

    hybrid = isinstance(cfg, HybridConfig)
    cpu = torch.device(device).type == "cpu"
    if cpu:
        cfg = dataclasses.replace(cfg, remat=False)
    init = hybrid_init if hybrid else lm_init
    state = train_init(init(cfg, torch.Generator().manual_seed(SEED), device),
                       TrainConfig(), seed=SEED + 1, deterministic=hybrid)
    step = hybrid_train_step if hybrid else train_step
    ckpt = loop.checkpoint
    loop.head_logits = keep_head
    if cpu:
        loop.checkpoint = lambda fn, *a, **kw: fn(*a)
    for k, fn in (swap or {}).items():
        setattr(kc, k, fn)
    try:
        with same_modrelu_side(record, sides if record else list(sides),
                               flips):
            loss = float(step(state, tokens.numpy().astype("int32"))[
                "loss"])
    finally:
        loop.head_logits = head
        loop.checkpoint = ckpt
        for k, fn in kept.items():
            setattr(kc, k, fn)
    grads = {n: p.grad.detach().float().cpu()
             for n, p in state.model.named_parameters() if p.grad is not None}
    return dict(logits=torch.cat(chunks, dim=1), loss=loss, grads=grads,
                flips=sum(flips))


def logit_errs(a, b, rows: int = 2048) -> tuple:
    """(max|a-b| / max|b|, ||a-b|| / ||b||) of two (B, N, V) tensors in one
    pass over slices of ``rows`` along dim 1, on a's device (the card's
    float64 does in seconds what the CPU's does in tens of them)."""
    num = den = sq = ref_sq = 0.0
    for i in range(0, b.shape[1], rows):
        x = a[:, i:i + rows].double()
        y = b[:, i:i + rows].to(a.device).double()
        num = max(num, float((x - y).abs().max()))
        den = max(den, float(y.abs().max()))
        sq += float(((x - y) ** 2).sum())
        ref_sq += float((y ** 2).sum())
    return num / den, math.sqrt(sq / ref_sq)


def parity_errs(got: dict, ref: dict) -> dict:
    """Each gradient's max|a-b| / max|b| and ||a-b|| / ||b||, the loss's
    and the logits'."""
    errs = {}
    for name, r in ref["grads"].items():
        g, r = got["grads"][name].double(), r.double()
        errs[name] = (float((g - r).abs().max() / r.abs().max()),
                      float((g - r).norm() / r.norm()))
    worst = max(errs, key=lambda n: errs[n][0])
    logits_rel_err, logits_rel_l2 = logit_errs(got["logits"], ref["logits"])
    return dict(loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(
                    ref["loss"]),
                logits_rel_err=logits_rel_err, logits_rel_l2=logits_rel_l2,
                grads=errs, tensors=len(errs), worst_grad=worst,
                max_grad_rel_err=errs[worst][0],
                max_grad_rel_l2=max(e[1] for e in errs.values()))


def bf16_model_ok(res: dict) -> bool:
    """The bf16 model check: loss within REL_BF16, logits within
    REL_BF16_LOGITS and each gradient within REL_BF16_MODEL, max-wise."""
    return (res["loss_rel_err"] <= REL_BF16
            and res["logits_rel_err"] <= REL_BF16_LOGITS
            and res["max_grad_rel_err"] <= REL_BF16_MODEL)


def drop_last_lag(vbar, kbr, kbi):
    """The control's fault: Kbar of the farthest lag (dl = nc - 1, the
    single pair of the last chunk and the first) dropped."""
    kbr, kbi = kbr.clone(), kbi.clone()
    kbr[:, -1] = 0
    kbi[:, -1] = 0
    return vbar, kbr, kbi


def phase_350m_long_parity(dev, kc) -> dict:
    """SPECTRE-350M cut to 1 layer at seq 32768 (nc = 16, the kf_seg
    branch), full width, in fp32 and in bf16, every run with the modReLUs
    on the sides the card's bf16 run took (same_modrelu_side): a
    train_step's logits, loss and every gradient on the card against the
    same model on the CPU (long_parity_run).

    fp32: logits, loss and each gradient max-wise within REL_MODEL.  bf16
    (bf16_model_ok): the loss within REL_BF16, the logits within
    REL_BF16_LOGITS and each gradient within REL_BF16_MODEL, max-wise.
    Two controls on the card go through that same check against the same
    CPU run: #7 and #11 run by their plain versions must pass it, a #11
    whose Kbar drops its farthest lag (drop_last_lag) must fail it; the
    card's fp32 run against the CPU's bf16 one is reported.  Then the
    card's bf16 loss against its fp32 loss within REL_BF16, as the JAX
    package holds its bf16 LM (tests/test_bf16.py:29; the logits' own
    distance is reported).  Returns the card's fp32 and bf16 losses."""
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.models.lm import spectre_350m_config

    seq = LONG_SEQS[0]
    base = dataclasses.replace(spectre_350m_config(seq=seq), num_layers=1)
    tokens = torch.randint(0, base.vocab_size, (1, seq + 1),
                           generator=torch.Generator().manual_seed(SEED + 5))
    cfgs = {mode: dataclasses.replace(base, block=dataclasses.replace(
        base.block, compute_dtype=mode)) for mode in ("float32", "bfloat16")}
    sides = []
    card, losses = {}, {}
    for mode in ("bfloat16", "float32"):
        fwd, bwd = LONG_MIX[mode]
        kc.reset_launches()
        BRANCH_CALLS.clear()
        card[mode] = long_parity_run(cfgs[mode], dev, tokens, sides,
                                     record=(mode == "bfloat16"))
        torch.cuda.synchronize()
        branches = dict(BRANCH_CALLS)
        used = {k: v for k, v in kc.LAUNCHES.items() if v}
        ref = long_parity_run(cfgs[mode], "cpu", tokens, sides, False)
        res = parity_errs(card[mode], ref)
        losses[mode] = card[mode]["loss"]
        finite = (all_finite(card[mode]["logits"])
                  and math.isfinite(losses[mode]))
        if mode == "bfloat16":
            ok = bf16_model_ok(res)
            # the controls, on the card against the same CPU run: #7 and
            # #11 run by their plain versions (sound: must pass), and #11's
            # Kbar missing its farthest lag (a fault: must fail)
            bwd_kernel = kc.fused_causal_mix_bwd
            control = {}
            for name, swap in (
                    ("plain_7_11", {
                        "_fused_causal_mix": kc.fused_causal_mix_ref,
                        "fused_causal_mix_bwd": kc.fused_causal_mix_bwd_ref}),
                    ("kbar_farthest_lag_dropped", {
                        "fused_causal_mix_bwd": lambda *a: drop_last_lag(
                            *bwd_kernel(*a))})):
                ctl = parity_errs(long_parity_run(
                    cfgs[mode], dev, tokens, sides, False, swap), ref)
                control[name] = dict(
                    passed=bf16_model_ok(ctl), worst_grad=ctl["worst_grad"],
                    max_grad_rel_err=ctl["max_grad_rel_err"],
                    logits_rel_err=ctl["logits_rel_err"],
                    loss_rel_err=ctl["loss_rel_err"])
            ok = (ok and control["plain_7_11"]["passed"]
                  and not control["kbar_farthest_lag_dropped"]["passed"])
            ref_bf16 = ref
        else:
            ok = (res["logits_rel_err"] <= REL_MODEL
                  and res["loss_rel_err"] <= REL_MODEL
                  and res["max_grad_rel_err"] <= REL_MODEL)
            control = None
        emit(phase="350m_long_parity", mode=mode, layers=base.num_layers,
             seq=seq, chunk=base.block.causal_chunk,
             limit=(REL_MODEL if mode == "float32" else dict(
                 loss=REL_BF16, logits=REL_BF16_LOGITS,
                 grads=REL_BF16_MODEL)),
             loss=losses[mode], cpu_loss=ref["loss"],
             modrelu_sides_moved=dict(card=card[mode]["flips"],
                                      cpu=ref["flips"]),
             branches=branches, launches=used, control=control,
             **{k: v for k, v in res.items() if k != "grads"},
             grads={k: v[0] for k, v in res["grads"].items()})
        if mode == "float32":
            # the card's fp32 run against the CPU's bf16 one, reported: no
            # limit that passes two sound bf16 runs can fail it, as bf16
            # rounding is the whole of either distance
            fp32_vs = parity_errs(card[mode], ref_bf16)
            del ref_bf16
            emit(phase="350m_long_fp32_vs_cpu_bf16", seq=seq,
                 worst_grad=fp32_vs["worst_grad"],
                 max_grad_rel_err=fp32_vs["max_grad_rel_err"],
                 logits_rel_err=fp32_vs["logits_rel_err"],
                 loss_rel_err=fp32_vs["loss_rel_err"])
        if not (finite and ok):
            raise AssertionError(
                f"350m long parity {mode}: logits "
                f"{res.get('logits_rel_err')}, loss {res['loss_rel_err']}, "
                f"worst gradient {res['worst_grad']} "
                f"{res['max_grad_rel_err']}; control {control}")
        other = LONG_MIX[OTHER_MODE[mode]]
        if (branches != {"kf_seg": 2 * base.num_layers}
                or not all(used.get(k) for k in ("kf_seg_rfft", fwd, bwd))
                or any(used.get(k) for k in other)):
            raise AssertionError(f"350m long parity {mode} took {branches}, "
                                 f"launched {used}")
        del ref
    loss_err = abs(losses["bfloat16"] - losses["float32"]) / abs(
        losses["float32"])
    logit_err, logit_l2 = logit_errs(card["bfloat16"]["logits"],
                                     card["float32"]["logits"])
    del card
    emit(phase="350m_long_bf16_vs_fp32", seq=seq, loss=losses,
         loss_rel_err=loss_err, logits_rel_err=logit_err,
         logits_rel_l2=logit_l2, limit=REL_BF16)
    if not loss_err <= REL_BF16:
        raise AssertionError(f"350m bf16 loss {losses['bfloat16']} against "
                             f"fp32 {losses['float32']}: {loss_err}")
    return losses


def bf16_config(cfg):
    """``cfg`` (an LMConfig) with its blocks in bf16 (the parameters stay
    fp32)."""
    return dataclasses.replace(cfg, block=dataclasses.replace(
        cfg.block, compute_dtype="bfloat16"))


def control_summary(ctl: dict) -> dict:
    """What a control run of the bf16 model check reports."""
    return dict(passed=bf16_model_ok(ctl), worst_grad=ctl["worst_grad"],
                max_grad_rel_err=ctl["max_grad_rel_err"],
                logits_rel_err=ctl["logits_rel_err"],
                loss_rel_err=ctl["loss_rel_err"])


def phase_tiny_bf16(dev) -> dict:
    """The tiny LM in bf16 at full depth (6 layers, d=512, seq 2048; the
    CLI's --bf16): a train_step at 2 x 2048 on the card against the same
    bf16 model on the CPU, every run on the card's bf16 modReLU sides
    (bf16_model_ok: loss 1e-2, logits 2e-2, each gradient 4e-2, max-wise),
    with #6 and #10 run by their plain versions on the card (must pass)
    and a #10 whose Kbar drops its farthest lag (must fail) as controls;
    then scoring 4 x 2048, prefill 4 x 1024, decode at B=4, the CLI's
    generate --bf16 (its 4-byte prompt takes #5), 4 train steps at 8 x
    2048 (median of steps 2-3, peak memory) and one profiled (busy and
    wall), and train-lm --bf16.  Returns the step's numbers."""
    from fft_tpu_torch import cli
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.models.lm import (
        lm_apply, lm_decode_step, lm_init, lm_prefill, tiny_lm_config,
    )
    from fft_tpu_torch.train import TrainConfig, train_init, train_step
    from fft_tpu_torch.train.data import CharDataset

    cfg = bf16_config(tiny_lm_config())
    seq = cfg.max_seq
    data = CharDataset()
    tokens = torch.from_numpy(next(data.batches(2, seq, seed=SEED)))
    sides = []
    card = long_parity_run(cfg, dev, tokens, sides, record=True)
    torch.cuda.synchronize()
    ref = long_parity_run(cfg, "cpu", tokens, sides, False)
    res = parity_errs(card, ref)
    bwd_kernel = kc.fused_causal_mix_bwd
    control = {name: control_summary(parity_errs(long_parity_run(
        cfg, dev, tokens, sides, False, swap), ref)) for name, swap in (
            ("plain_6_10", {
                "_fused_causal_mix": kc.fused_causal_mix_ref,
                "fused_causal_mix_bwd": kc.fused_causal_mix_bwd_ref}),
            ("kbar_farthest_lag_dropped", {
                "fused_causal_mix_bwd": lambda *a: drop_last_lag(
                    *bwd_kernel(*a))}))}
    ok = (bf16_model_ok(res) and control["plain_6_10"]["passed"]
          and not control["kbar_farthest_lag_dropped"]["passed"]
          and all_finite(card["logits"]) and math.isfinite(card["loss"]))
    emit(phase="tiny_bf16_parity", layers=cfg.num_layers, batch=2, seq=seq,
         limit=dict(loss=REL_BF16, logits=REL_BF16_LOGITS,
                    grads=REL_BF16_MODEL),
         loss=card["loss"], cpu_loss=ref["loss"],
         modrelu_sides_moved=dict(card=card["flips"], cpu=ref["flips"]),
         control=control, **{k: v for k, v in res.items() if k != "grads"},
         grads={k: v[0] for k, v in res["grads"].items()})
    if not ok:
        raise AssertionError(f"tiny bf16 parity: {res['worst_grad']} "
                             f"{res['max_grad_rel_err']}, logits "
                             f"{res['logits_rel_err']}, loss "
                             f"{res['loss_rel_err']}; control {control}")
    del card, ref

    model = lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
    tg = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (4, seq), generator=tg).to(dev)
    prompts = torch.randint(0, cfg.vocab_size, (4, 1024), generator=tg).to(
        dev)
    with torch.no_grad():
        logits = lm_apply(model, toks)
        torch.cuda.synchronize()
        if not (logits.shape == (4, seq, cfg.vocab_size)
                and all_finite(logits)):
            raise AssertionError("tiny bf16 score: bad shape or non-finite")
        del logits
        score_ms = wall_ms(lambda: lm_apply(model, toks))
        score_prof = fprof.read_profile(lambda: lm_apply(model, toks),
                                        torch.cuda.synchronize, 3)
        prefill_ms = wall_ms(lambda: lm_prefill(model, prompts))
        steps = 32

        def decode_run():
            lg, cs = lm_prefill(model, prompts)
            tok = lg.argmax(-1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                lg, cs = lm_decode_step(model, tok, 1024 + i, cs)
                tok = lg.argmax(-1)
            torch.cuda.synchronize()
            if not all_finite(lg):
                raise AssertionError("tiny bf16 decode: non-finite")
            return (time.perf_counter() - t0) * 1e3 / steps

        decode_ms = statistics.median(decode_run() for _ in range(3))
    emit(phase="tiny_bf16_serve", score_batch=4, seq=seq, score_ms=score_ms,
         score_tokens_per_s=4 * seq / (score_ms / 1e3),
         score_profile=score_prof, prefill_batch=4, prefill_tokens=1024,
         prefill_ms=prefill_ms, decode_batch=4, decode_steps=steps,
         decode_ms_per_token=decode_ms)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["generate", "--device", "cuda", "--bf16", "--steps", "64"])
    if not buf.getvalue().startswith("the "):
        raise AssertionError(f"cli generate --bf16 printed "
                             f"{buf.getvalue()!r}")
    emit(phase="tiny_bf16_cli_generate", prompt="the ", steps=64,
         chars=len(buf.getvalue()))
    del model

    state = train_init(lm_init(cfg, torch.Generator().manual_seed(SEED), dev),
                       TrainConfig(), seed=SEED + 1)
    batches = data.batches(8, seq, seed=SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(4):
        batch = next(batches)
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tiny bf16 train: losses {losses}")
    ms = statistics.median(step_ms[1:3])
    prof = fprof.read_profile(lambda: train_step(state, batch),
                              torch.cuda.synchronize, 1, BWD_KERNEL_NAMES)
    train = dict(batch=8, seq=seq, step_ms=step_ms, median_step_ms=ms,
                 tokens_per_s=8 * seq / (ms / 1e3), loss=losses,
                 peak_memory_bytes=peak, profile=prof)
    emit(phase="tiny_bf16_train", **train)
    del state

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["train-lm", "--device", "cuda", "--bf16", "--steps", "3"])
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    if not recs or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"cli train-lm --bf16 printed "
                             f"{buf.getvalue()!r}")
    emit(phase="tiny_bf16_cli_train_lm", steps=3, lines=recs)
    return train


# the tiny LM at seq 8192 (chunk 128, nc 64): the kf_fused branch, #8 at
# n_fft 8192, the direct #6 forward (#6's FFT kernel holds no nc 64
# spectra) and the direct #10 backward (#10's FFT kernel stages no nc 64
# segments), by launch name in each mode
TINY_LONG_SEQ = 8192
TINY_LONG_KERNELS = {
    "float32": ("kf_spectra", "fused_causal_mix_direct",
                "fused_causal_mix_bwd_direct"),
    "bfloat16": ("kf_spectra", "fused_causal_mix_direct_bf16",
                 "fused_causal_mix_bwd_direct_bf16")}
# the direct #10's and the direct #6's CUDA kernels in a profile: the
# backward's own launches, the transforms of [0 | ybar_s] (kAccbar true),
# the windows' transforms (the forward's and the backward's V, one
# instance: split by their launches), #5's body (the forward's second)
DIRECT_TRACE = ("lag_tiles_kernel", "adjoint_fft_kernel",
                "segment_fft_kernel<4, 0, true",
                "segment_fft_kernel<4, 0, false", "banded_fft_kernel")


def drop_nearest_lag(vbar, kbr, kbi):
    """The control's fault at nc 64: Kbar of the nearest lag (dl = 0,
    every chunk's own segment) dropped; the farthest lag's one chunk pair
    of 2080 is below what a bf16 model check can see."""
    kbr, kbi = kbr.clone(), kbi.clone()
    kbr[:, 0] = 0
    kbi[:, 0] = 0
    return vbar, kbr, kbi


def tiny_long_steps(cfg, dev, kc, launches, mode) -> dict:
    """5 train_steps of ``cfg`` at 8 x TINY_LONG_SEQ (step ms, median of
    steps 2-5, peak memory, finite losses), the mode's kernels launched
    once a layer a step (the direct #10 in the mode's instance, #10's FFT
    kernel never), then one step under torch.profiler: busy and idle ms
    and the direct #10's and the direct #6's device ms and share of it
    (DIRECT_TRACE; the windows' transforms split by launches)."""
    from fft_tpu_torch.models.lm import lm_init
    from fft_tpu_torch.train import TrainConfig, train_init, train_step
    from fft_tpu_torch.train.data import CharDataset

    seq, layers = cfg.max_seq, cfg.num_layers
    state = train_init(lm_init(cfg, torch.Generator().manual_seed(SEED), dev),
                       TrainConfig(), seed=SEED + 1)
    batches = CharDataset().batches(8, seq, seed=SEED)
    start = launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for _ in range(5):
        batch = next(batches)
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    used = {k: v - start[k] for k, v in launches().items() if v - start[k]}
    _, fwd, bwd = TINY_LONG_KERNELS[mode]
    other = TINY_LONG_KERNELS[OTHER_MODE[mode]]
    if (used.get(bwd) != 5 * layers or used.get(fwd, 0) < 5 * layers
            or any(used.get(k) for k in other[1:])
            or used.get("fused_causal_mix_bwd")
            or used.get("fused_causal_mix_bwd_bf16")):
        raise AssertionError(f"tiny long {mode}: 5 steps launched {used}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"tiny long {mode}: losses {losses}")
    before = dict(kc.LAUNCHES)
    prof = fprof.read_profile(lambda: train_step(state, batch),
                              torch.cuda.synchronize, 1, DIRECT_TRACE)
    n6, n10 = (kc.LAUNCHES[k] - before[k] for k in (fwd, bwd))
    got = prof["matched_ms_per_step"]
    direct10 = direct6 = None
    if None not in got.values() and n6 + n10:
        win = got["segment_fft_kernel<4, 0, false"]
        direct10 = (got["lag_tiles_kernel"] + got["adjoint_fft_kernel"]
                    + got["segment_fft_kernel<4, 0, true"]
                    + win * n10 / (n6 + n10))
        direct6 = got["banded_fft_kernel"] + win * n6 / (n6 + n10)
    busy = prof["device_busy_ms_per_step"]
    del state
    return dict(mode=mode, batch=8, seq=seq, layers=layers, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms[1:]),
                tokens_per_s=8 * seq / (statistics.median(step_ms[1:]) / 1e3),
                loss=losses, peak_memory_bytes=peak, launches_5_steps=used,
                busy_ms=busy, wall_ms=prof["wall_ms_per_step"],
                idle_share=prof["idle_share"],
                direct10_ms=direct10, direct6_ms=direct6,
                direct10_share=None if direct10 is None else direct10 / busy,
                direct6_share=None if direct6 is None else direct6 / busy,
                profiled_launches=dict(direct6=n6, direct10=n10),
                profile=prof)


def phase_tiny_long(dev, kc, reset_launches, launches) -> dict:
    """The tiny LM at seq 8192 (chunk 128, nc 64; TINY_LONG_KERNELS), fp32
    and bf16.  Parity: 2 layers at full width (d=512, 8 heads x 4 groups),
    a train_step at 1 x 8192 on the card against the same model on the CPU,
    every run on the card's bf16 modReLU sides: fp32 logits, loss and each
    gradient within REL_MODEL; bf16 under bf16_model_ok (loss 1e-2, logits
    2e-2, each gradient 4e-2, max-wise) with #6 and #10 by their plain
    versions on the card passing and a #10 whose Kbar drops its nearest
    lag failing (drop_nearest_lag; the farthest lag's fault is reported).
    Then 5 steps at 8 x 8192 at full depth in each mode (tiny_long_steps),
    and 2 steps of the CLI's train-lm --preset tiny --seq 8192 --bf16.
    Launch counts of its own, set to 0 before the phase: every kernel of
    TINY_LONG_KERNELS launched, #10's FFT kernel never; returns them."""
    from fft_tpu_torch import cli
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.models.lm import tiny_lm_config

    seq = TINY_LONG_SEQ
    full = tiny_lm_config(seq=seq)
    base = dataclasses.replace(full, num_layers=2)
    tokens = torch.randint(0, base.vocab_size, (1, seq + 1),
                           generator=torch.Generator().manual_seed(SEED + 7))
    cfgs = {"float32": base, "bfloat16": bf16_config(base)}
    sides = []
    reset_launches()                          # the tiny long path
    for mode in ("bfloat16", "float32"):
        kernels = TINY_LONG_KERNELS[mode]
        BRANCH_CALLS.clear()
        before = launches()
        card = long_parity_run(cfgs[mode], dev, tokens, sides,
                               record=(mode == "bfloat16"))
        torch.cuda.synchronize()
        branches = dict(BRANCH_CALLS)
        used = {k: v - before[k] for k, v in launches().items()
                if v - before[k]}
        ref = long_parity_run(cfgs[mode], "cpu", tokens, sides, False)
        res = parity_errs(card, ref)
        finite = all_finite(card["logits"]) and math.isfinite(card["loss"])
        control = None
        if mode == "bfloat16":
            bwd_kernel = kc.fused_causal_mix_bwd
            control = {name: control_summary(parity_errs(long_parity_run(
                cfgs[mode], dev, tokens, sides, False, swap), ref))
                for name, swap in (
                    ("plain_6_10", {
                        "_fused_causal_mix": kc.fused_causal_mix_ref,
                        "fused_causal_mix_bwd": kc.fused_causal_mix_bwd_ref}),
                    ("kbar_nearest_lag_dropped", {
                        "fused_causal_mix_bwd": lambda *a: drop_nearest_lag(
                            *bwd_kernel(*a))}),
                    ("kbar_farthest_lag_dropped", {
                        "fused_causal_mix_bwd": lambda *a: drop_last_lag(
                            *bwd_kernel(*a))}))}
            ok = (bf16_model_ok(res) and control["plain_6_10"]["passed"]
                  and not control["kbar_nearest_lag_dropped"]["passed"])
        else:
            ok = (res["logits_rel_err"] <= REL_MODEL
                  and res["loss_rel_err"] <= REL_MODEL
                  and res["max_grad_rel_err"] <= REL_MODEL)
        emit(phase="tiny_long_parity", mode=mode, layers=base.num_layers,
             seq=seq, chunk=base.block.causal_chunk,
             limit=(REL_MODEL if mode == "float32" else dict(
                 loss=REL_BF16, logits=REL_BF16_LOGITS,
                 grads=REL_BF16_MODEL)),
             loss=card["loss"], cpu_loss=ref["loss"],
             modrelu_sides_moved=dict(card=card["flips"], cpu=ref["flips"]),
             branches=branches, launches=used, control=control,
             **{k: v for k, v in res.items() if k != "grads"},
             grads={k: v[0] for k, v in res["grads"].items()})
        if not (finite and ok):
            raise AssertionError(
                f"tiny long parity {mode}: logits {res['logits_rel_err']}, "
                f"loss {res['loss_rel_err']}, worst gradient "
                f"{res['worst_grad']} {res['max_grad_rel_err']}; control "
                f"{control}")
        other = TINY_LONG_KERNELS[OTHER_MODE[mode]]
        if (set(branches) != {"kf_fused"}
                or not all(used.get(k) for k in kernels)
                or any(used.get(k) for k in other[1:])):
            raise AssertionError(f"tiny long parity {mode} took {branches}, "
                                 f"launched {used}")
        del card, ref
    for mode in ("float32", "bfloat16"):
        cfg = full if mode == "float32" else bf16_config(full)
        emit(phase="tiny_long_train",
             **tiny_long_steps(cfg, dev, kc, launches, mode))
    before = launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["train-lm", "--device", "cuda", "--preset", "tiny",
                  "--seq", str(seq), "--bf16", "--steps", "2"])
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    cli_used = {k: v - before[k] for k, v in launches().items()
                if v - before[k]}
    if (not recs or not all(math.isfinite(r["loss"]) for r in recs)
            or not cli_used.get("fused_causal_mix_bwd_direct_bf16")):
        raise AssertionError(f"cli train-lm --seq {seq} --bf16 printed "
                             f"{buf.getvalue()!r}, launched {cli_used}")
    emit(phase="tiny_long_cli_train_lm", seq=seq, steps=2, lines=recs,
         launches=cli_used)
    used = launches()
    missing = [k for m in TINY_LONG_KERNELS.values() for k in m
               if not used[k]]
    if missing or used["fused_causal_mix_bwd"] or used[
            "fused_causal_mix_bwd_bf16"]:
        raise AssertionError(f"tiny long: never launched {missing}, or #10's "
                             f"FFT kernel launched ({used})")
    return used


def phase_350m_short(dev, kc) -> None:
    """SPECTRE-350M at full depth (24 layers, d=1024), the prefills of
    SHORT_350M, each in its mode: chunk = length, nc = 1, so #6's FFT
    kernel at 512 (2C = 1024), the direct #6 at 600 and 853 (no FFT plan:
    segment FFTs by Bluestein, then #5's body) and #5 at 1500, each
    launched once a layer a call and no other causal kernel; the logits
    against the same prefill with that kernel's wrapper run by its plain
    version on the card (max-wise within the entry's limit); wall ms
    (median of 3) and one call profiled."""
    from fft_tpu_torch.models.lm import lm_init, lm_prefill, spectre_350m_config

    cfg32 = spectre_350m_config()
    cfgs = {"float32": cfg32, "bfloat16": bf16_config(cfg32)}
    models = {mode: lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
              for mode, cfg in cfgs.items()}
    x = torch.randint(0, cfg32.vocab_size,
                      (1, max(e[0] for e in SHORT_350M)),
                      generator=torch.Generator().manual_seed(SEED + 7)).to(
                          dev)
    plain = {"_fused_causal_mix": kc.fused_causal_mix_ref,
             "_banded_inverse": kc.banded_inverse_ref}
    with torch.no_grad():
        for length, mode, name, wrapper, limit in SHORT_350M:
            model, layers = models[mode], cfgs[mode].num_layers
            prompt = x[:, :length]
            before = dict(kc.LAUNCHES)
            lg, _ = lm_prefill(model, prompt)
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in kc.LAUNCHES.items()
                        if v != before[k]}
            kept = getattr(kc, wrapper)
            setattr(kc, wrapper, plain[wrapper])
            try:
                want, _ = lm_prefill(model, prompt)
            finally:
                setattr(kc, wrapper, kept)
            err = rel_err(lg, want)
            ms = wall_ms(lambda: lm_prefill(model, prompt), rounds=3)
            prof = fprof.read_profile(lambda: lm_prefill(model, prompt),
                                      torch.cuda.synchronize, 1,
                                      ("fused_mix_fft_kernel",
                                   "segment_fft_kernel",
                                   "banded_fft_kernel"))
            emit(phase="350m_short", prompt=length, mode=mode, layers=layers,
                 rel_err_vs_plain=err, limit=limit, launches=launched,
                 ms=ms, profile=prof)
            if not (all_finite(lg) and err <= limit
                    and launched == {name: layers}):
                raise AssertionError(f"350m {mode} prefill {length}: "
                                     f"rel_err {err} (limit {limit}), "
                                     f"launches {launched}")
            del lg, want
    del models


def block_bf16_run(cfg, device, x, sides, record, swap=()) -> dict:
    """The bf16 block of ``cfg`` from seed 0 on ``device``: y (fp32, on
    the CPU) and every parameter gradient of sum(y.float() ** 2), the
    modReLUs on ``sides`` (``record``: this run appends its own).
    ``swap``: (module or dict, name, value) replaced for the run."""
    from fft_tpu_torch.layers.spectre import (
        spectre_block_apply, spectre_block_init,
    )

    def get(obj, k):
        return obj[k] if isinstance(obj, dict) else getattr(obj, k)

    def put(obj, k, val):
        if isinstance(obj, dict):
            obj[k] = val
        else:
            setattr(obj, k, val)

    kept = [(obj, k, get(obj, k)) for obj, k, _ in swap]
    block = spectre_block_init(cfg, torch.Generator().manual_seed(SEED),
                               device)
    for obj, k, val in swap:
        put(obj, k, val)
    try:
        with same_modrelu_side(record, sides if record else list(sides)):
            y = spectre_block_apply(block, x.to(device))
            (y.float() ** 2).sum().backward()
    finally:
        for obj, k, val in kept:
            put(obj, k, val)
    return dict(y=y.detach().float().cpu(),
                grads={n: p.grad.float().cpu()
                       for n, p in block.named_parameters()
                       if p.grad is not None})


def block_bf16_errs(got: dict, ref: dict) -> dict:
    """The output's and each gradient's max|a-b| / max|b|, and whether
    they pass (output REL_BF16_LOGITS, gradients REL_BF16_MODEL)."""
    errs = {n: rel_err(g, ref["grads"][n]) for n, g in got["grads"].items()}
    worst = max(errs, key=errs.get)
    y_err = rel_err(got["y"], ref["y"])
    return dict(rel_err=y_err, worst_grad=worst,
                max_grad_rel_err=errs[worst], tensors=len(errs),
                passed=(y_err <= REL_BF16_LOGITS
                        and errs[worst] <= REL_BF16_MODEL))


def drop_group(vbar, gbr, gbi):
    """The block check's fault: #2's cotangent of the first gate group
    dropped."""
    gbr, gbi = gbr.clone(), gbi.clone()
    gbr[..., 0] = 0
    gbi[..., 0] = 0
    return vbar, gbr, gbi


def phase_block_bf16(dev, sm) -> int:
    """The config-1 block in bf16, as bench.py builds it: the card's block
    against the same bf16 block on the CPU (output within REL_BF16_LOGITS,
    each gradient of sum(y.float() ** 2) within REL_BF16_MODEL, max-wise,
    on the card's modReLU sides), with #1 and #2 run by their plain
    versions on the card (must pass) and a #2 whose first gate group's
    cotangent is dropped (must fail) as controls; 5 timed steps and 3
    profiled through bench.run, and ``python -m fft_tpu_torch.bench``;
    4096 x 2 and 8192 x 1 (#3's bf16 instance forward, cuFFT with casts
    backward): forward within REL_BF16_LOGITS of the CPU, 3 steps and 2
    profiled; the forward at 16384, 32768 and 65536 with TWOPASS_ENABLE on
    and off in turns (#4's bf16 instance against the wide branch), at
    16384 with the flag on within REL_BF16_LOGITS of the CPU.  Returns the
    forwards run with the flag on (each launches #4 once)."""
    from fft_tpu_torch import bench
    from fft_tpu_torch.layers.spectre import (
        MIX_BRANCH_CALLS, spectre_block_apply, spectre_block_init,
    )

    cfg = bench.config1()
    x = torch.randn((bench.B, bench.L, bench.D),
                    generator=torch.Generator().manual_seed(SEED + 2))
    sides = []
    MIX_BRANCH_CALLS.clear()
    card = block_bf16_run(cfg, dev, x, sides, True)
    branches = dict(MIX_BRANCH_CALLS)
    ref = block_bf16_run(cfg, "cpu", x, sides, False)
    res = block_bf16_errs(card, ref)
    bwd_kernel = sm.direct_mix_bwd
    control = {}
    for name, swap in (
            ("plain_1_2", ((sm._FORWARD, "direct_mix", sm.direct_mix_ref),
                           (sm, "direct_mix_bwd", sm.direct_mix_bwd_ref))),
            ("gate_group_dropped", ((sm, "direct_mix_bwd",
                                     lambda *a: drop_group(*bwd_kernel(*a))),
                                    ))):
        control[name] = block_bf16_errs(
            block_bf16_run(cfg, dev, x, sides, False, swap), ref)
    emit(phase="block_bf16_parity", batch=bench.B, seq=bench.L,
         limit=dict(output=REL_BF16_LOGITS, grads=REL_BF16_MODEL),
         branches=branches, control=control, **res)
    if not (res["passed"] and control["plain_1_2"]["passed"]
            and not control["gate_group_dropped"]["passed"]
            and all_finite(card["y"]) and branches == {"fused": 1}):
        raise AssertionError(f"block bf16 parity {res}, branches {branches}, "
                             f"control {control}")
    del card, ref

    res = bench.run(steps=5, device=dev, seed=SEED, profile_steps=3)
    emit(phase="block_bf16_steps", steps=5, **res)
    proc = subprocess.run(
        [sys.executable, "-m", "fft_tpu_torch.bench", "--steps", "3"],
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"python -m fft_tpu_torch.bench failed "
                             f"({proc.returncode}): {proc.stderr[-2000:]}")
    rec = json.loads(lines[-1])
    if not (math.isfinite(rec["value"]) and "bfloat16" in rec["config"]):
        raise AssertionError(f"bench printed {rec}")
    emit(phase="cli_bench", **rec)

    for seq, batch in ((4096, 2), (8192, 1)):
        c = bench.config1(seq)
        xl = torch.randn((batch, seq, bench.D),
                         generator=torch.Generator().manual_seed(SEED + seq))
        with torch.no_grad():
            MIX_BRANCH_CALLS.clear()
            y = spectre_block_apply(spectre_block_init(
                c, torch.Generator().manual_seed(SEED), dev), xl.to(dev))
            torch.cuda.synchronize()
            branches = dict(MIX_BRANCH_CALLS)
            err = rel_err(y.float(), spectre_block_apply(spectre_block_init(
                c, torch.Generator().manual_seed(SEED), "cpu"), xl).float())
        steps = bench.run(steps=3, batch=batch, seq=seq, device=dev,
                          seed=SEED, profile_steps=2)
        emit(phase="block_bf16_long", forward_rel_err=err,
             limit=REL_BF16_LOGITS, branches=branches, **steps)
        if not (err <= REL_BF16_LOGITS and branches == {"fused": 1}
                and math.isfinite(steps["loss"])):
            raise AssertionError(f"block bf16 n_fft {seq}: rel_err {err}, "
                                 f"branches {branches}, loss "
                                 f"{steps['loss']}")
        del y

    forwards_on = 0

    def forward(block, xd):
        nonlocal forwards_on
        forwards_on += bool(sm.TWOPASS_ENABLE)
        return spectre_block_apply(block, xd)

    default = sm.TWOPASS_ENABLE
    try:
        for n in (16384, 32768, 65536):
            c = bench.config1(n)
            xl = torch.randn((1, n, bench.D),
                             generator=torch.Generator().manual_seed(SEED + n))
            rec = dict(n_fft=n, batch=1)
            with torch.no_grad():
                gpu = spectre_block_init(
                    c, torch.Generator().manual_seed(SEED), dev)
                xd = xl.to(dev)
                if n == 16384:
                    sm.TWOPASS_ENABLE = True
                    MIX_BRANCH_CALLS.clear()
                    y = forward(gpu, xd)
                    torch.cuda.synchronize()
                    branches = dict(MIX_BRANCH_CALLS)
                    err = rel_err(y.float(), spectre_block_apply(
                        spectre_block_init(c, torch.Generator().manual_seed(
                            SEED), "cpu"), xl).float())
                    rec.update(rel_err=err, branches=branches)
                    if not (all_finite(y) and err <= REL_BF16_LOGITS
                            and branches == {"fused": 1}):
                        raise AssertionError(
                            f"two-pass bf16 block n_fft {n}: rel_err {err}, "
                            f"branches {branches}")
                    del y
                rec["block_forward_ms"] = flag_turns(
                    sm, lambda: forward(gpu, xd))
                for flag, key in ((False, "wide"), (True, "twopass")):
                    sm.TWOPASS_ENABLE = flag
                    rec["forward_profile_" + key] = fprof.read_profile(
                        lambda: forward(gpu, xd), torch.cuda.synchronize, 2)
            sm.TWOPASS_ENABLE = default
            emit(phase="block_bf16_twopass", **rec)
            del gpu, xd
    finally:
        sm.TWOPASS_ENABLE = default
    return forwards_on


def long_config(seq: int, mode: str):
    """spectre_350m_config(seq) with its blocks in ``mode``."""
    from fft_tpu_torch.models.lm import spectre_350m_config

    cfg = spectre_350m_config(seq=seq)
    return dataclasses.replace(cfg, block=dataclasses.replace(
        cfg.block, compute_dtype=mode))


def serve_long(model, x, reset_launches, launches, light=False) -> dict:
    """The serving path of one 350M configuration on launch counts of its
    own: scoring 1 x S (ms), a prefill of S/2 tokens (ms), then 8 greedy
    decode steps (ms a token); ``light``: scoring alone, one checked call
    and one timed.  Checks finite outputs, kf_seg on every forward, #9, #7
    (the mode's instance, the other never) and #12."""
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.models.lm import lm_apply, lm_decode_step, lm_prefill

    cfg = model.cfg
    seq, layers = x.shape[1], cfg.num_layers
    fwd, _ = LONG_MIX[cfg.block.compute_dtype]
    other = LONG_MIX[OTHER_MODE[cfg.block.compute_dtype]]
    reset_launches()
    BRANCH_CALLS.clear()
    logits = lm_apply(model, x)
    torch.cuda.synchronize()
    if not (logits.shape == (1, seq, cfg.vocab_size)
            and logits.dtype == torch.float32 and all_finite(logits)):
        raise AssertionError(f"350m score at {seq}: {logits.shape} "
                             f"{logits.dtype} or non-finite")
    del logits
    if light:
        t0 = time.perf_counter()
        lm_apply(model, x)
        torch.cuda.synchronize()
        score_ms = (time.perf_counter() - t0) * 1e3
        prefill_ms = decode_ms = None
        steps, forwards, finite = 0, 2 * layers, True
    else:
        score_ms = wall_ms(lambda: lm_apply(model, x), rounds=2)
        prompt = x[:, :seq // 2]
        prefill_ms = wall_ms(lambda: lm_prefill(model, prompt), rounds=2)
        steps = 8
        lg, caches = lm_prefill(model, prompt)
        tok = lg.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(steps):
            lg, caches = lm_decode_step(model, tok, seq // 2 + i, caches)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / steps
        finite = all_finite(lg)
        del lg, caches
        # 4 scorings and 4 prefills (1 + 2 timed + 1 each), every layer
        forwards = 8 * layers
    used = launches()
    branches = dict(BRANCH_CALLS)
    res = dict(score_ms=score_ms, score_tokens_per_s=seq / (score_ms / 1e3),
               prefill_tokens=0 if light else seq // 2,
               prefill_ms=prefill_ms, decode_ms_per_token=decode_ms,
               decode_steps=steps, branches=branches,
               launches={k: v for k, v in used.items() if v})
    if (not finite or branches != {"kf_seg": forwards}
            or used["kf_seg_rfft"] != forwards or used[fwd] != forwards
            or any(used[k] for k in other)
            or used["fused_decode_mix"] != steps * layers):
        raise AssertionError(f"350m serving at {seq} "
                             f"{cfg.block.compute_dtype}: {res}")
    return res


def train_long(model, reset_launches, launches, steps: int = 3,
               profile: bool = True) -> dict:
    """``steps`` train_steps of one 350M configuration at 1 x S on launch
    counts of their own (step ms, peak memory from a reset, finite losses),
    then, with ``profile``, one more under torch.profiler (device busy ms,
    wall ms, causal_long.cu's kernels by name).  #9 and #7 launched twice a
    layer a step (the forward and its recompute), #11 once, the mode's
    instances only."""
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.train import TrainConfig, train_init, train_step

    cfg = model.cfg
    seq, layers = cfg.max_seq, cfg.num_layers
    fwd, bwd = LONG_MIX[cfg.block.compute_dtype]
    other = LONG_MIX[OTHER_MODE[cfg.block.compute_dtype]]
    reset_launches()
    BRANCH_CALLS.clear()
    state = train_init(model, TrainConfig(), seed=SEED + 1)
    batches = [torch.randint(0, cfg.vocab_size, (1, seq + 1),
                             generator=torch.Generator().manual_seed(s))
               for s in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        m = train_step(state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    prof = fprof.read_profile(
        lambda: train_step(state, batches[0]), torch.cuda.synchronize, 1,
        LONG_KERNEL_NAMES) if profile else None
    del state
    for p in model.parameters():
        p.grad = None
    model.eval()
    used = launches()
    steps = len(batches) + int(profile)
    ms = statistics.median(step_ms[1:] or step_ms)
    res = dict(step_ms=step_ms, median_step_ms=ms,
               tokens_per_s=seq / (ms / 1e3),
               loss=losses, peak_memory_bytes=peak,
               peak_memory_gb=peak / 1e9, profile=prof,
               branches=dict(BRANCH_CALLS),
               launches={k: v for k, v in used.items() if v})
    if (not all(math.isfinite(v) for v in losses)
            or res["branches"] != {"kf_seg": 2 * layers * steps}
            or used["kf_seg_rfft"] != 2 * layers * steps
            or used[fwd] != 2 * layers * steps
            or used[bwd] != layers * steps
            or any(used[k] for k in other)):
        raise AssertionError(f"350m training at {seq} "
                             f"{cfg.block.compute_dtype}: {res}")
    return res


def phase_350m_long(dev, reset_launches, launches):
    """SPECTRE-350M at seq 32768 and 65536, full depth, in fp32 and in bf16
    (the same weights from seed 0 in both modes): each configuration's
    serving path (serve_long) and training path (train_long): fp32 at
    32768 as scoring and one step (``light``), fp32 at 65536 with two steps
    and no profile (the run's time limit); then the
    CLI at seq 65536 in bf16, in a temporary HOME: train-lm --preset 350m
    --bf16 --steps 2 --batch 1 on the default BPE corpus (through the
    native loader; losses finite and not rising by more than 5%), and
    generate --preset 350m --bf16.  Returns the launches of the serving,
    training and CLI paths, each summed over its runs."""
    import tempfile

    from fft_tpu_torch import cli
    from fft_tpu_torch.models.lm import SpectreLM, lm_init

    totals = {"serve": {}, "train": {}, "cli": {}}

    def add(path, used):
        for k, v in used.items():
            totals[path][k] = totals[path].get(k, 0) + v

    for seq in LONG_SEQS:
        tokens = torch.randint(0, 50432, (1, seq),
                               generator=torch.Generator().manual_seed(
                                   SEED + 6))
        x = tokens.to(dev)
        model = lm_init(long_config(seq, "float32"),
                        torch.Generator().manual_seed(SEED), dev)
        # the bf16 run starts from the same weights; one model on the card
        # at a time, so that each peak is its own
        init = {k: v.to("cpu", copy=True)
                for k, v in model.state_dict().items()}
        params = sum(p.numel() for p in model.parameters())
        for mode in ("float32", "bfloat16"):
            if mode == "bfloat16":
                del model
                torch.cuda.empty_cache()
                model = SpectreLM(long_config(seq, mode)).to(dev)
                model.load_state_dict(init)
                model.eval()
            t0 = time.perf_counter()
            # fp32 at 32768: scoring and one step; at 65536 two steps and
            # no profile (the run's time limit)
            light = (seq, mode) == (LONG_SEQS[0], "float32")
            serve = serve_long(model, x, reset_launches, launches, light)
            add("serve", launches())
            fp32 = mode == "float32"
            train = train_long(model, reset_launches, launches,
                               steps=1 if light else 2 if fp32 else 3,
                               profile=not fp32)
            add("train", launches())
            emit(phase="350m_long", seq=seq, mode=mode, params=params,
                 chunk=model.cfg.block.causal_chunk, serve=serve,
                 train=train, seconds=time.perf_counter() - t0)
        del model, x, init
        torch.cuda.empty_cache()

    seq = LONG_SEQS[-1]
    layers = 24
    home = os.environ.get("HOME")
    with tempfile.TemporaryDirectory() as tmp:
        os.environ["HOME"] = tmp              # the corpus cache
        try:
            reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["train-lm", "--device", "cuda", "--preset", "350m",
                          "--seq", str(seq), "--bf16", "--batch", "1",
                          "--steps", "2", "--log-every", "1"])
            train_used = launches()
            add("cli", train_used)
            reset_launches()
            gen = io.StringIO()
            with contextlib.redirect_stdout(gen):
                cli.main(["generate", "--device", "cuda", "--preset",
                          "350m", "--seq", str(seq), "--bf16", "--steps",
                          "8"])
            gen_used = launches()
            add("cli", gen_used)
        finally:
            if home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = home
    lines = buf.getvalue().splitlines()
    recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    notes = [ln for ln in lines if not ln.startswith("{")]
    losses = [r["loss"] for r in recs]
    emit(phase="350m_long_cli", seq=seq, mode="bfloat16", lines=recs,
         notes=notes, train_launches={k: v for k, v in train_used.items()
                                      if v},
         generate_chars=len(gen.getvalue()),
         generate_launches={k: v for k, v in gen_used.items() if v})
    fwd, bwd = LONG_MIX["bfloat16"]
    if (len(losses) != 2 or not all(math.isfinite(v) for v in losses)
            or losses[1] > 1.05 * losses[0]
            or notes[-1:] != [NATIVE_BPE_LINE]
            or not all(train_used[k] for k in ("kf_seg_rfft", fwd, bwd))
            or any(train_used[k] for k in LONG_MIX["float32"])):
        raise AssertionError(f"cli train-lm --preset 350m --seq {seq} "
                             f"--bf16: {lines}, launched {train_used}")
    if (not gen.getvalue().startswith("the ")
            or gen_used["fused_decode_mix"] != layers * 7
            or gen_used["banded_inverse"] != layers):
        raise AssertionError(f"cli generate --preset 350m --seq {seq} "
                             f"--bf16 printed {gen.getvalue()!r}, launched "
                             f"{gen_used}")
    return totals["serve"], totals["train"], totals["cli"]


@contextlib.contextmanager
def stdout_fd_to(path: str):
    """File descriptor 1, which child processes inherit, written to
    ``path`` for the duration."""
    sys.stdout.flush()
    saved = os.dup(1)
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        os.dup2(fd, 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(fd)
        os.close(saved)


def differing_keys(a: dict, b: dict) -> list:
    """The keys of two nested dicts of tensors (and numbers, strings) whose
    values differ: a bit-for-bit comparison."""
    bad = [] if sorted(a) == sorted(b) else ["<keys>"]
    for k in set(a) & set(b):
        x, y = a[k], b[k]
        if isinstance(x, dict):
            bad += [f"{k}.{sub}" for sub in differing_keys(x, y)]
        elif isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and torch.equal(x, y.to(x.device))):
                bad.append(k)
        elif x != y:
            bad.append(k)
    return bad


def phase_350m_ckpt(dev, reset_launches, launches):
    """SPECTRE-350M at seq 16384, full depth: train-lm on the default BPE
    corpus under the supervisor's subprocess runner, killed at step 3 by an
    injected fault and resumed from the step-2 checkpoint; the step-4
    checkpoint restored bit for bit and written again (snapshot and write
    times); one more step resumed in-process (the training path's
    launches); generate --ckpt --vocab against the restored model (the
    serving path's).  Returns the launches of the two paths."""
    import tempfile

    from fft_tpu_torch import cli
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS
    from fft_tpu_torch.models.lm import (lm_generate, lm_init,
                                         spectre_350m_config)
    from fft_tpu_torch.train import TrainConfig, train_init
    from fft_tpu_torch.train import checkpoint as ck
    from fft_tpu_torch.train.bpe import Tokenizer, tokenize_file, \
        vocab_sidecar
    from fft_tpu_torch.train.data import synthetic_corpus
    from fft_tpu_torch.train.supervisor import supervise

    cfg = spectre_350m_config()
    seq, layers = cfg.max_seq, cfg.num_layers
    torch.cuda.empty_cache()                  # the children need the card
    home = os.environ.get("HOME")
    with tempfile.TemporaryDirectory() as tmp:
        ckdir = f"{tmp}/ckpt"
        corpus = f"{tmp}/.cache/fft_tpu_torch/synth_v{cfg.vocab_size}.tokens"
        free = {"start": shutil.disk_usage(tmp).free}
        argv = ["train-lm", "--device", "cuda", "--preset", "350m", "--seq",
                str(seq), "--batch", "1", "--steps", "4", "--ckpt", ckdir,
                "--ckpt-every", "2", "--log-every", "1"]
        os.environ["HOME"] = tmp              # the corpus cache
        try:
            # 1. the supervisor's own runner: python -m fft_tpu_torch.cli
            os.environ["FFT_TPU_FAULT_STEP"] = "3"
            t0 = time.perf_counter()
            try:
                with stdout_fd_to(f"{tmp}/children.log"):
                    restarts = supervise(argv, max_restarts=1)
            finally:
                del os.environ["FFT_TPU_FAULT_STEP"]
            supervised_s = time.perf_counter() - t0
            with open(f"{tmp}/children.log", encoding="utf-8") as f:
                child = f.read().splitlines()
            recs = [json.loads(ln) for ln in child if ln.startswith("{")]
            notes = [ln for ln in child if not ln.startswith("{")]
            kept = sorted(int(p) for p in os.listdir(ckdir) if p.isdigit())
            free["children"] = shutil.disk_usage(tmp).free
            want = [f"building BPE corpus at {corpus} ...", NATIVE_BPE_LINE,
                    "resumed at step 2", NATIVE_BPE_LINE]
            losses = [r["loss"] for r in recs]
            if (restarts != 1 or ck.latest_step(ckdir) != 4
                    or kept != [2, 4] or notes != want
                    or [r["step"] for r in recs] != [0, 1, 2, 3]
                    or not all(math.isfinite(v) for v in losses)):
                raise AssertionError(
                    f"350m supervised train-lm: {restarts} restarts, kept "
                    f"{kept}, printed {child}")
            ckpt_bytes = sum(os.path.getsize(f"{ckdir}/4/{name}")
                             for name in os.listdir(f"{ckdir}/4"))

            # 2. the step-4 checkpoint restored on the card, bit for bit
            state = train_init(lm_init(cfg, torch.Generator().manual_seed(
                SEED + 9), dev), TrainConfig(total_steps=4), seed=SEED + 9)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.restore_checkpoint(ckdir, state, step=4)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            files = {name: torch.load(f"{ckdir}/4/{name}",
                                      map_location="cpu", weights_only=True)
                     for name in (ck.MODEL_FILE, ck.TRAIN_FILE)}
            differ = differing_keys(ck.snapshot(state), files)
            on_card = all(t.device.type == "cuda" for t in
                          [*state.model.state_dict().values(),
                           *state.optimizer.mu, *state.optimizer.nu])
            if (differ or state.step != 4 or state.optimizer.count != 4
                    or state.generator.device.type != "cuda"
                    or not on_card):
                raise AssertionError(f"350m restore: differs at {differ[:8]}"
                                     f", step {state.step}, on card "
                                     f"{on_card}")
            del files
            # ... and written again: the snapshot the train loop waits for,
            # then the write on the writer's thread
            writer = ck.AsyncCheckpointWriter(f"{tmp}/again")
            t0 = time.perf_counter()
            writer.save(state, 4)
            snapshot_ms = (time.perf_counter() - t0) * 1e3
            writer.wait()
            write_s = time.perf_counter() - t0 - snapshot_ms / 1e3
            free["peak"] = shutil.disk_usage(tmp).free
            shutil.rmtree(f"{tmp}/again")
            del state, writer
            torch.cuda.empty_cache()

            # 3. the corpus the first child built, built again here
            t0 = time.perf_counter()
            tok = tokenize_file(synthetic_corpus(2_000_000),
                                f"{tmp}/rebuilt.tokens",
                                vocab_size=cfg.vocab_size)
            bpe_s = time.perf_counter() - t0
            with open(corpus, "rb") as a, \
                    open(f"{tmp}/rebuilt.tokens", "rb") as b:
                rebuilt_equal = a.read() == b.read()
            corpus_tokens = os.path.getsize(corpus) // 2
            if not rebuilt_equal:
                raise AssertionError("350m BPE corpus: a rebuild differs "
                                     "from the first child's")

            # 4. one more step resumed in-process: the training path
            reset_launches()
            BRANCH_CALLS.clear()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(argv[:10] + ["5"] + argv[11:] + ["--resume"])
            torch.cuda.synchronize()
            resume_s = time.perf_counter() - t0
            train = launches()
            train_branches = dict(BRANCH_CALLS)
            lines = buf.getvalue().splitlines()
            resumed = [json.loads(ln) for ln in lines if ln.startswith("{")]
            if (lines[:2] != ["resumed at step 4", NATIVE_BPE_LINE]
                    or [r["step"] for r in resumed] != [4]
                    or not math.isfinite(resumed[0]["loss"])
                    or ck.latest_step(ckdir) != 5):
                raise AssertionError(f"350m in-process resume printed "
                                     f"{lines}")
            missing = [k for k in TRAIN_350M_KERNELS if train[k] == 0]
            if missing or train_branches.get("composition"):
                raise AssertionError(f"350m resumed training: never launched "
                                     f"{missing}, branches {train_branches}")
            torch.cuda.empty_cache()

            # 5. serving the checkpoint through the tokenizer
            steps = 8
            reset_launches()
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["generate", "--device", "cuda", "--preset", "350m",
                          "--seq", str(seq), "--ckpt", ckdir, "--vocab",
                          corpus, "--steps", str(steps)])
            serve = launches()
            text = buf.getvalue()
            state = train_init(lm_init(cfg, torch.Generator().manual_seed(
                SEED + 9), dev), TrainConfig(), seed=SEED + 9)
            ck.restore_checkpoint(ckdir, state)
            tokenizer = Tokenizer.load(vocab_sidecar(corpus))
            prompt = torch.from_numpy(tokenizer.encode("the ").astype(
                "int64"))[None].to(dev)
            out = lm_generate(state.model.eval(), prompt, steps=steps)
            want_text = "the " + tokenizer.decode(out[0].tolist()) + "\n"
            del state
            torch.cuda.empty_cache()
        finally:
            if home is None:
                os.environ.pop("HOME", None)
            else:
                os.environ["HOME"] = home
    step_ms = [seq / r["tokens_per_sec"] * 1e3 for r in recs
               if "tokens_per_sec" in r]
    emit(phase="350m_ckpt", layers=layers, seq=seq, restarts=restarts,
         kept=kept, child_notes=notes, losses=losses,
         resumed_loss=resumed[0]["loss"], step_ms=step_ms,
         supervised_s=supervised_s, resume_one_step_s=resume_s,
         checkpoint_bytes=ckpt_bytes, snapshot_ms=snapshot_ms,
         write_s=write_s, restore_s=restore_s, bpe_build_s=bpe_s,
         merges=len(tok.merges), corpus_tokens=corpus_tokens,
         prompt_tokens=int(prompt.shape[1]), generated=text,
         generated_ids=out[0].tolist(),
         free_disk_bytes=free, train_launches=train,
         train_branches=train_branches, serve_launches=serve)
    if text != want_text:
        raise AssertionError(f"350m generate --ckpt --vocab printed {text!r}, "
                             f"the restored model {want_text!r}")
    if (serve["fused_decode_mix"] != layers * (steps - 1)
            or serve["banded_inverse"] != layers):
        raise AssertionError(f"350m generate --ckpt --vocab: launches "
                             f"{serve}, not #12 once a layer per decode step "
                             f"and #5 once a layer at the prompt")
    return serve, train


# the ViT (config 3): its train step's batch
VIT_BATCH = 32
# the hybrids' paths: the tiny hybrid in each mode (#8, #6 and #10 by their
# FFT kernels, #12; in fp32 #5 too, at the 24-token forward that the
# decode check compares with), the 1B in bf16 (#9, #7 and #11, #12)
HYBRID_TINY_KERNELS = {
    "float32": ("kf_spectra", "fused_causal_mix", "fused_causal_mix_bwd",
                "fused_decode_mix", "banded_inverse"),
    "bfloat16": ("kf_spectra", "fused_causal_mix_bf16",
                 "fused_causal_mix_bwd_bf16", "fused_decode_mix")}
HYBRID_1B_KERNELS = ("kf_seg_rfft", "fused_causal_mix_v3_bf16",
                     "fused_causal_mix_bwd_v3_bf16", "fused_decode_mix")


def launched(used: dict, allowed) -> dict:
    """The kernels of ``used`` launched outside ``allowed``."""
    return {k: v for k, v in used.items() if v and k not in allowed}


def cli_lines(argv) -> list:
    """The JSON lines ``cli.main(argv)`` prints, each loss finite."""
    from fft_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    recs = [json.loads(line) for line in buf.getvalue().splitlines()
            if line.startswith("{")]
    if not recs or not all(math.isfinite(r["loss"]) for r in recs):
        raise AssertionError(f"cli {argv} printed {buf.getvalue()!r}")
    return recs


def vit_parity(cfg, dev, imgs, labels) -> dict:
    """The classification loss of ``cfg`` from seed 0 in eval mode (JAX's
    deterministic rule: the wavelet on at rate >= 1, off below), forward
    and backward on the card and on the CPU, modReLU sides aligned: the
    logits, the loss and every gradient."""
    from fft_tpu_torch.models.vit import vit_apply, vit_init

    out, sides, flips = {}, [], []
    for name, device in (("card", dev), ("cpu", "cpu")):
        model = vit_init(cfg, torch.Generator().manual_seed(SEED), device)
        record = name == "card"
        with same_modrelu_side(record, sides if record else list(sides),
                               None if record else flips):
            logits = vit_apply(model, torch.from_numpy(imgs).to(device))
            loss = torch.nn.functional.cross_entropy(
                logits, torch.from_numpy(labels).to(device).long())
            loss.backward()
        out[name] = dict(
            logits=logits.detach().cpu(), loss=float(loss),
            grads={n: p.grad.cpu() for n, p in model.named_parameters()
                   if p.grad is not None})
    card, cpu = out["card"], out["cpu"]
    if sorted(card["grads"]) != sorted(cpu["grads"]):
        raise AssertionError("vit parity: gradients on one device only")
    grads = {n: rel_err(g, cpu["grads"][n]) for n, g in card["grads"].items()}
    worst = max(grads, key=grads.get)
    return dict(logits_rel_err=rel_err(card["logits"], cpu["logits"]),
                loss=card["loss"], cpu_loss=cpu["loss"],
                loss_rel_err=abs(card["loss"] - cpu["loss"]) / cpu["loss"],
                tensors=len(grads), worst_grad=worst,
                max_grad_rel_err=grads[worst],
                modrelu_sides_moved=sum(flips),
                finite=all_finite(card["logits"]) and math.isfinite(
                    card["loss"]))


def phase_vit(dev) -> None:
    """The ViT, BASELINE config 3 (vit_s_config: 12 layers, d=384, 6
    heads, n_fft 256, L = 197, 1000 classes, wavelet 0.1, fft_impl
    "auto": the per-head cuFFT branch, no hand-written kernel).  Parity
    at 2 layers, full width, B=32 (one synthetic batch): the logits, loss
    and every gradient within REL_MODEL of the CPU, in eval mode at the
    config's rate 0.1 (the wavelet off) and at rate 1.0 (on, the Haar
    pyramid at the odd length 197).  Then 6 train-vit steps at full depth
    (vit_train_step, optax.adamw's update; the masks drawn in train mode):
    the host's synthetic batch (32 x 224 x 224 x 3 float32 from numpy)
    timed apart from the step, step ms (median of steps 2-5), peak
    memory, 3 profiled (busy, wall, idle share); the CLI's train-vit for 3
    steps.  No kernel launched; every multihead took the per-head branch."""
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.kernels import decode as kd
    from fft_tpu_torch.kernels import spectral_mix as sm
    from fft_tpu_torch.layers.spectre import MIX_BRANCH_CALLS
    from fft_tpu_torch.models.vit import vit_init, vit_s_config
    from fft_tpu_torch.train import train_init, vit_train_config, \
        vit_train_step
    from fft_tpu_torch.train.images import synthetic_image_batches

    cfg = vit_s_config()
    MIX_BRANCH_CALLS.clear()
    batches = synthetic_image_batches(VIT_BATCH, cfg.image_size,
                                      cfg.num_classes, seed=SEED)
    imgs, labels = next(batches)
    for rate in (cfg.block.wavelet_on_rate, 1.0):
        pcfg = dataclasses.replace(cfg, num_layers=2, block=dataclasses.replace(
            cfg.block, wavelet_on_rate=rate))
        res = vit_parity(pcfg, dev, imgs, labels)
        emit(phase="vit_parity", layers=2, batch=VIT_BATCH,
             seq=cfg.seq_len, wavelet_on_rate=rate, limit=REL_MODEL, **res)
        if not (res["finite"] and res["logits_rel_err"] <= REL_MODEL
                and res["loss_rel_err"] <= REL_MODEL
                and res["max_grad_rel_err"] <= REL_MODEL):
            raise AssertionError(f"vit parity at rate {rate}: {res}")

    state = train_init(vit_init(cfg, torch.Generator().manual_seed(SEED), dev),
                       vit_train_config(3e-4), seed=SEED)
    params = sum(p.numel() for p in state.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    host_ms, step_ms, losses = [], [], []
    for _ in range(6):
        t0 = time.perf_counter()
        imgs, labels = next(batches)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        m = vit_train_step(state, imgs, labels)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"vit train: losses {losses}")
    ms = statistics.median(step_ms[1:5])
    prof = fprof.read_profile(lambda: vit_train_step(state, imgs, labels),
                              torch.cuda.synchronize, 3)
    emit(phase="vit_train", batch=VIT_BATCH, seq=cfg.seq_len,
         layers=cfg.num_layers, params=params, host_batch_ms=host_ms,
         step_ms=step_ms, median_step_ms=ms,
         images_per_s=VIT_BATCH / (ms / 1e3), loss=losses,
         peak_memory_bytes=peak, profile=prof)
    del state
    recs = cli_lines(["train-vit", "--device", "cuda", "--steps", "3",
                      "--log-every", "1"])
    emit(phase="vit_cli_train_vit", steps=3, lines=recs)
    used = {**kc.LAUNCHES, **sm.LAUNCHES, **kd.LAUNCHES}
    branches = dict(MIX_BRANCH_CALLS)
    if any(used.values()) or set(branches) != {"per_head"}:
        raise AssertionError(f"vit: kernels launched {launched(used, ())}, "
                             f"branches {branches}")


def hybrid_bf16(cfg):
    """``cfg`` (a HybridConfig) with its blocks in bf16."""
    return dataclasses.replace(cfg, block=dataclasses.replace(
        cfg.block, compute_dtype="bfloat16"))


def hybrid_parity(cfg, dev, tokens, controls, label) -> dict:
    """A hybrid train step on the card against the CPU (long_parity_run,
    the card's modReLU sides): fp32 within REL_MODEL max-wise; bf16 under
    bf16_model_ok, with ``controls`` ({name: swap}) run on the card
    through the same check, "plain..." passing and the fault failing."""
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.layers.causal_seg import BRANCH_CALLS

    kc.reset_launches()
    BRANCH_CALLS.clear()
    sides = []
    card = long_parity_run(cfg, dev, tokens, sides, record=True)
    torch.cuda.synchronize()
    used = {k: v for k, v in kc.LAUNCHES.items() if v}
    branches = dict(BRANCH_CALLS)
    ref = long_parity_run(cfg, "cpu", tokens, sides, False)
    res = parity_errs(card, ref)
    finite = all_finite(card["logits"]) and math.isfinite(card["loss"])
    bf16 = cfg.block.compute_dtype == "bfloat16"
    control = None
    if bf16:
        control = {name: control_summary(parity_errs(long_parity_run(
            cfg, dev, tokens, sides, False, swap), ref))
            for name, swap in controls.items()}
        ok = bf16_model_ok(res) and all(
            c["passed"] == name.startswith("plain")
            for name, c in control.items())
    else:
        ok = (res["logits_rel_err"] <= REL_MODEL
              and res["loss_rel_err"] <= REL_MODEL
              and res["max_grad_rel_err"] <= REL_MODEL)
    emit(phase=label, mode=cfg.block.compute_dtype, groups=cfg.num_groups,
         seq=tokens.shape[1] - 1, chunk=cfg.block.causal_chunk,
         limit=(dict(loss=REL_BF16, logits=REL_BF16_LOGITS,
                     grads=REL_BF16_MODEL) if bf16 else REL_MODEL),
         loss=card["loss"], cpu_loss=ref["loss"],
         modrelu_sides_moved=dict(card=card["flips"], cpu=ref["flips"]),
         branches=branches, launches=used, control=control,
         **{k: v for k, v in res.items() if k != "grads"},
         grads={k: v[0] for k, v in res["grads"].items()})
    if not (finite and ok):
        raise AssertionError(f"{label} {cfg.block.compute_dtype}: logits "
                             f"{res['logits_rel_err']}, loss "
                             f"{res['loss_rel_err']}, worst gradient "
                             f"{res['worst_grad']} {res['max_grad_rel_err']}"
                             f"; control {control}")
    return dict(branches=branches, launches=used)


def hybrid_train_run(cfg, dev, tokens, steps: int, profiled: int):
    """``steps`` hybrid_train_steps of ``cfg`` from seed 0 on ``tokens``
    (a list of (B, N+1) batches, one a step), then ``profiled`` more under
    torch.profiler: (step ms, peak memory (from a reset), losses, busy and
    wall; the trained model in eval mode, its optimizer dropped)."""
    from fft_tpu_torch.models.hybrid import hybrid_init
    from fft_tpu_torch.train import TrainConfig, hybrid_train_step, \
        train_init

    state = train_init(hybrid_init(cfg, torch.Generator().manual_seed(SEED),
                                   dev), TrainConfig(), seed=SEED + 1,
                       deterministic=True)
    params = sum(p.numel() for p in state.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        m = hybrid_train_step(state, tokens[i % len(tokens)])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"hybrid train: losses {losses}")
    prof = fprof.read_profile(lambda: hybrid_train_step(state, tokens[0]),
                              torch.cuda.synchronize, profiled,
                              LONG_KERNEL_NAMES + BWD_KERNEL_NAMES)
    model = state.model
    del state
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    return dict(batch=tokens[0].shape[0], seq=tokens[0].shape[1] - 1,
                params=params, step_ms=step_ms,
                median_step_ms=statistics.median(step_ms[1:]),
                loss=losses, peak_memory_bytes=peak, profile=prof), model


def hybrid_decode_check(model, model_cpu, toks, dev) -> dict:
    """Teacher-forced decode of ``toks`` (B, T) from empty caches on the
    card against the CPU, step by step (REL_MODEL each), and against
    hybrid_apply on the card: equal at position 0 (REL_MODEL), where the
    decode's gate descriptor (the window's query sum over N) is the
    forward's chunk gate; past it the descriptors differ inside a chunk
    (the reported max).  hybrid_apply at T < chunk tokens takes #5 (chunk
    = T, nc = 1)."""
    from fft_tpu_torch.models.hybrid import (
        hybrid_apply, hybrid_decode_init, hybrid_decode_step)

    fwd = hybrid_apply(model, toks.to(dev))
    caches = hybrid_decode_init(model, toks.shape[0])
    ref_caches = hybrid_decode_init(model_cpu, toks.shape[0])
    errs, vs_fwd = [], []
    for i in range(toks.shape[1]):
        logits, caches = hybrid_decode_step(model, toks[:, i].to(dev), i,
                                            caches)
        ref, ref_caches = hybrid_decode_step(model_cpu, toks[:, i], i,
                                             ref_caches)
        if not all_finite(logits):
            raise AssertionError(f"hybrid decode step {i}: non-finite")
        errs.append(rel_err(logits, ref))
        vs_fwd.append(rel_err(logits, fwd[:, i]))
    res = dict(steps=toks.shape[1], decode_rel_err=max(errs),
               vs_apply_first=vs_fwd[0], vs_apply_max=max(vs_fwd))
    if not (res["decode_rel_err"] <= REL_MODEL
            and res["vs_apply_first"] <= REL_MODEL):
        raise AssertionError(f"hybrid decode: {res}")
    return res


def generate_run(model, prompt, steps: int) -> dict:
    """hybrid_generate of ``steps`` greedy tokens from ``prompt`` (fed
    token by token), twice: the second's ms a decode step (length + steps
    - 1 steps) and #12's launches in it."""
    from fft_tpu_torch.kernels import decode as kd
    from fft_tpu_torch.models.hybrid import hybrid_generate

    hybrid_generate(model, prompt, steps)
    torch.cuda.synchronize()
    before = kd.LAUNCHES["fused_decode_mix"]
    t0 = time.perf_counter()
    out = hybrid_generate(model, prompt, steps)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    n = prompt.shape[1] + steps - 1
    cfg = model.cfg
    layers = cfg.num_groups * cfg.spectre_per_group
    launches = kd.LAUNCHES["fused_decode_mix"] - before
    if not (out.shape == (prompt.shape[0], steps) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size and launches == layers * n):
        raise AssertionError(f"hybrid_generate: {tuple(out.shape)}, "
                             f"#12 launched {launches} (not {layers} x {n})")
    return dict(prompt=prompt.shape[1], steps=steps, decode_steps=n,
                ms=ms, ms_per_decode_step=ms / n,
                fused_decode_launches=launches)


def phase_hybrid_tiny(dev, kc, reset_launches, launches) -> dict:
    """The tiny hybrid (hybrid_tiny_config: 2 x (SPECTRE + SWA), d=256, 4
    heads x 4 groups, seq 2048, chunk 256, nc 8, window 256) in fp32 and
    bf16.  Each mode: a train step at 1 x 2048 on the card against the CPU
    (hybrid_parity; bf16 with #6 and #10 by their plain versions passing
    and #10's Kbar without its farthest lag failing); then, on launch
    counts of the mode's own, 5 train steps at 1 x 2048 and 2 profiled,
    scoring 1 x 2048, hybrid_generate of 32 tokens from a 16-token prompt
    (ms a decode step, #12 once a SPECTRE layer a step), and the CLI's
    train-hybrid for 3 steps (--bf16 in bf16).  In fp32 also 24
    teacher-forced decode steps against the CPU (hybrid_decode_check;
    decode is fp32 in both modes).  Each mode launches its kernels
    (HYBRID_TINY_KERNELS) and no other causal kernel.  Returns the
    launches by mode."""
    from fft_tpu_torch.models.hybrid import (
        hybrid_apply, hybrid_init, hybrid_tiny_config)
    from fft_tpu_torch.train.data import CharDataset

    data = CharDataset()
    base = hybrid_tiny_config()
    seq = base.max_seq
    batches = data.batches(1, seq, seed=SEED)
    tokens = [torch.from_numpy(next(batches)) for _ in range(5)]
    out = {}
    for mode in ("float32", "bfloat16"):
        cfg = base if mode == "float32" else hybrid_bf16(base)
        bwd = kc.fused_causal_mix_bwd
        par = hybrid_parity(cfg, dev, tokens[0], {
            "plain_6_10": {"_fused_causal_mix": kc.fused_causal_mix_ref,
                           "fused_causal_mix_bwd": kc.fused_causal_mix_bwd_ref},
            "kbar_farthest_lag_dropped": {
                "fused_causal_mix_bwd": lambda *a: drop_last_lag(*bwd(*a))}},
            "hybrid_tiny_parity")
        reset_launches()
        train, model = hybrid_train_run(cfg, dev, tokens, 5, 2)
        x = tokens[0][:, :-1].to(dev)
        logits = hybrid_apply(model, x)
        if not (logits.shape == (1, seq, cfg.vocab_size)
                and all_finite(logits)):
            raise AssertionError("hybrid tiny score: bad shape or non-finite")
        score_ms = wall_ms(lambda: hybrid_apply(model, x))
        score_prof = fprof.read_profile(lambda: hybrid_apply(model, x),
                                        torch.cuda.synchronize, 3)
        gen = generate_run(model, x[:, :16], 32)
        decode = None
        if mode == "float32":
            model_cpu = hybrid_init(cfg, torch.Generator(), "cpu")
            model_cpu.load_state_dict(model.state_dict())
            decode = hybrid_decode_check(model, model_cpu,
                                         tokens[1][:, :24], dev)
            del model_cpu
        del model, logits
        argv = ["train-hybrid", "--device", "cuda", "--steps", "3",
                "--log-every", "1"] + (["--bf16"] if mode != "float32"
                                       else [])
        recs = cli_lines(argv)
        used = launches()
        wrong = launched(used, HYBRID_TINY_KERNELS[mode])
        missing = [k for k in HYBRID_TINY_KERNELS[mode] if not used[k]]
        emit(phase="hybrid_tiny", mode=mode, params=train["params"],
             train=train, score_batch=1, seq=seq, score_ms=score_ms,
             score_tokens_per_s=seq / (score_ms / 1e3),
             score_profile=score_prof, generate=gen, decode=decode,
             cli_train_hybrid=recs, parity_branches=par["branches"],
             launches={k: v for k, v in used.items() if v})
        if missing or wrong:
            raise AssertionError(f"hybrid tiny {mode}: never launched "
                                 f"{missing}; launched {wrong}")
        out[mode] = used
    return out


def phase_hybrid_1b(dev, kc, reset_launches, launches) -> dict:
    """The 1B hybrid, BASELINE config 5 (hybrid_1b_config(seq=32768): 8 x
    (SPECTRE + SWA) = 16 layers, d=2048, 16 heads x 4 groups, chunk 1024,
    nc 32, window 1024, bf16, group remat), full depth.  Parity first, at
    one group (SPECTRE + SWA) of hybrid_1b_config(seq=8192), the same
    widths at nc 8 (the kf_fused branch: #8 over the 512 gate lanes, then
    #7; #11 backward): a train step's bf16 loss, logits and every gradient
    on the card against the CPU's bf16 (bf16_model_ok), with #7 and #11 by
    their plain versions passing and #11's Kbar without its farthest lag
    failing.  Then, on launch counts of their own: 3 train steps at 1 x
    32768 (step ms, peak memory from a reset) and one profiled (busy,
    wall); with the trained weights scoring 1 x 32768 (hybrid_apply: ms, one call profiled);
    hybrid_generate of 8 tokens from an 8-token prompt (ms a decode step,
    #12 once a SPECTRE layer a step); the CLI's train-hybrid --preset 1b
    --seq 32768 --steps 2.  #9, #7 and #11 in their bf16 instances and
    #12 launched, no fp32 instance.  Returns the launches."""
    from fft_tpu_torch.models.hybrid import hybrid_1b_config, hybrid_apply

    cfg = hybrid_1b_config(seq=32768)
    pcfg = dataclasses.replace(hybrid_1b_config(seq=8192), num_groups=1)
    g = torch.Generator().manual_seed(SEED + 7)
    ptoks = torch.randint(0, cfg.vocab_size, (1, pcfg.max_seq + 1),
                          generator=g)
    bwd = kc.fused_causal_mix_bwd
    t0 = time.perf_counter()
    par = hybrid_parity(pcfg, dev, ptoks, {
        "plain_7_11": {"_fused_causal_mix": kc.fused_causal_mix_ref,
                       "fused_causal_mix_bwd": kc.fused_causal_mix_bwd_ref},
        "kbar_farthest_lag_dropped": {
            "fused_causal_mix_bwd": lambda *a: drop_last_lag(*bwd(*a))}},
        "hybrid_1b_parity")
    parity_s = time.perf_counter() - t0
    # at seq 8192 #8 takes the gate lanes (nc x 64 = 512) whole: kf_fused
    parity_kernels = ("kf_spectra",) + HYBRID_1B_KERNELS[1:3]
    if (par["branches"] != {"kf_fused": 2}
            or not all(par["launches"].get(k) for k in parity_kernels)
            or launched(par["launches"], parity_kernels)):
        raise AssertionError(f"hybrid 1b parity took {par}")

    reset_launches()
    tokens = [torch.randint(0, cfg.vocab_size, (1, cfg.max_seq + 1),
                            generator=g) for _ in range(2)]
    train, model = hybrid_train_run(cfg, dev, tokens, 3, 1)
    x = tokens[0][:, :-1].to(dev)
    logits = hybrid_apply(model, x)
    if not (logits.shape == (1, cfg.max_seq, cfg.vocab_size)
            and all_finite(logits)):
        raise AssertionError("hybrid 1b score: bad shape or non-finite")
    del logits
    score_ms = wall_ms(lambda: hybrid_apply(model, x), rounds=3)
    score_prof = fprof.read_profile(lambda: hybrid_apply(model, x),
                                    torch.cuda.synchronize, 1,
                                    LONG_KERNEL_NAMES)
    gen = generate_run(model, x[:, :8], 8)
    del model, x
    torch.cuda.empty_cache()
    recs = cli_lines(["train-hybrid", "--device", "cuda", "--preset", "1b",
                      "--seq", str(cfg.max_seq), "--steps", "2",
                      "--log-every", "1"])
    used = launches()
    wrong = launched(used, HYBRID_1B_KERNELS)
    missing = [k for k in HYBRID_1B_KERNELS if not used[k]]
    emit(phase="hybrid_1b", params=train["params"], layers=cfg.num_layers,
         parity_seconds=parity_s, train=train, score_batch=1,
         seq=cfg.max_seq, score_ms=score_ms,
         score_tokens_per_s=cfg.max_seq / (score_ms / 1e3),
         score_profile=score_prof, generate=gen, cli_train_hybrid=recs,
         launches={k: v for k, v in used.items() if v})
    if missing or wrong:
        raise AssertionError(f"hybrid 1b: never launched {missing}; "
                             f"launched {wrong}")
    return used


# phase 11: the CUDA kernels a train-lm or train-hybrid trace must name
# (#8, #6 and #10's three launches, csrc/causal_fft.cu)
PROF_TRACE_KERNELS = ("kf_spectra_fft_kernel", "fused_mix_fft_kernel",
                      *BWD_KERNEL_NAMES)
# bench-mix's lines: the JAX CLI's keys, then the port's
BENCH_MIX_KEYS = ("seq", "block_fwd_ms", "tokens_per_sec", "mix_roofline_ms",
                  "mix_branch", "device", "name_power_limit")


def trace_kernels(logdir) -> tuple:
    """(the Chrome traces under ``logdir``, the names of their events)."""
    files = sorted(pathlib.Path(logdir).glob("*.json"))
    names = set()
    for f in files:
        names |= {e.get("name", "") for e in
                  json.loads(f.read_text())["traceEvents"]}
    return files, names


def phase_prof(dev) -> None:
    """Module 7b on the card (utils/prof.py): the card's measured rates
    beside its published peaks (measure_chip_constants, csrc/probe.cu's
    FMA chain); train-lm and train-hybrid --preset tiny --steps 4
    --profile DIR, each trace naming #8's, #6's and #10's CUDA kernels;
    bench-mix at the JAX CLI's defaults; the tiny LM untied
    (tie_embeddings=False) at full width: a train step at 2 x 2048 and
    scoring against the CPU (REL_MODEL); the config-1 block (fp32) with
    fft_impl="matmul" against the same block with "auto": a forward within
    REL_BLOCK, both on the per-head branch."""
    import tempfile

    from fft_tpu_torch import bench, cli
    from fft_tpu_torch.layers.spectre import (
        MIX_BRANCH_CALLS, spectre_block_init)
    from fft_tpu_torch.models.lm import lm_apply, lm_init, tiny_lm_config
    from fft_tpu_torch.train.data import CharDataset

    t0 = time.perf_counter()
    consts = fprof.measure_chip_constants(dev)
    emit(phase="prof_chip_constants", seconds=time.perf_counter() - t0,
         **consts.record())
    rates = ("hbm_gbps", "tflops_bf16", "tflops_f32", "tflops_tf32",
             "fp32_gops")
    if not all(math.isfinite(getattr(consts, k)) and getattr(consts, k) > 0
               for k in rates):
        raise AssertionError(f"prof: measured rates {consts}")

    with tempfile.TemporaryDirectory() as tmp:
        for cmd in ("train-lm", "train-hybrid"):
            logdir = os.path.join(tmp, cmd)
            recs = cli_lines([cmd, "--device", "cuda", "--preset", "tiny",
                              "--steps", "4", "--log-every", "1",
                              "--profile", logdir])
            files, names = trace_kernels(logdir)
            missing = [k for k in PROF_TRACE_KERNELS
                       if not any(k in n for n in names)]
            emit(phase="prof_cli_trace", command=cmd, steps=len(recs),
                 traces=[f.name for f in files],
                 trace_bytes=[f.stat().st_size for f in files],
                 kernels_named=[k for k in PROF_TRACE_KERNELS
                                if k not in missing])
            if len(files) != 1 or missing or len(recs) != 4:
                raise AssertionError(f"{cmd} --profile: traces {files}, "
                                     f"kernels not named {missing}, "
                                     f"{len(recs)} steps logged")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["bench-mix", "--device", "cuda"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    emit(phase="prof_bench_mix", rows=rows)
    if ([r["seq"] for r in rows] != [1024, 4096, 16384]
            or not all(set(BENCH_MIX_KEYS) <= set(r)
                       and r["block_fwd_ms"] > 0
                       and math.isfinite(r["tokens_per_sec"]) for r in rows)):
        raise AssertionError(f"bench-mix printed {buf.getvalue()!r}")

    cfg = dataclasses.replace(tiny_lm_config(), tie_embeddings=False)
    toks = next(CharDataset().batches(2, cfg.max_seq, seed=SEED))
    res = train_parity(cfg, dev, toks)
    x = torch.from_numpy(toks[:, :-1]).long()
    model = lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
    model_cpu = lm_init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    logits = lm_apply(model, x.to(dev))
    score_err = rel_err(logits, lm_apply(model_cpu, x))
    emit(phase="prof_untied_lm", batch=2, seq=cfg.max_seq,
         score_rel_err=score_err, **res)
    if not (res["finite"] and res["loss_rel_err"] <= REL_MODEL
            and res["max_grad_rel_err"] <= REL_MODEL
            and score_err <= REL_MODEL and all_finite(logits)
            and "lm_head" in dict(model.named_parameters())):
        raise AssertionError(f"untied LM: {res}, scoring rel_err "
                             f"{score_err} (limit {REL_MODEL})")
    del model, model_cpu, logits

    g = torch.Generator().manual_seed(SEED + 1)
    xb = torch.randn((bench.B, bench.L, bench.D), generator=g).to(dev)
    outs = {}
    MIX_BRANCH_CALLS.clear()
    for impl in ("auto", "matmul"):
        cfg = dataclasses.replace(bench.config1(compute_dtype="float32"),
                                  fft_impl=impl)
        block = spectre_block_init(cfg, torch.Generator().manual_seed(SEED),
                                   dev)
        with torch.no_grad():
            outs[impl] = block(xb)
    err = rel_err(outs["matmul"], outs["auto"])
    emit(phase="prof_fft_impl_matmul", rel_err=err,
         branches=dict(MIX_BRANCH_CALLS))
    if not (err <= REL_BLOCK and all_finite(outs["matmul"])
            and dict(MIX_BRANCH_CALLS) == {"per_head": 2}):
        raise AssertionError(f"fft_impl='matmul' block: rel_err {err} "
                             f"(limit {REL_BLOCK}), branches "
                             f"{dict(MIX_BRANCH_CALLS)}")


# phase 12: a parallel path at world size 1 against its no-mesh path on
# the card: a train step's loss and gradients (which differ only in the
# rounding of the vocab-parallel cross entropy), the TP block, the
# hybrid's halo step
REL_PARALLEL = 1e-5


def grads_of(model) -> dict:
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()
            if p.grad is not None}


def worst_rel(got: dict, want: dict) -> tuple:
    """(worst rel_err, its tensor) over the tensors of two dicts."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"gradients of {sorted(set(got) ^ set(want))} "
                             "on one side only")
    errs = {k: rel_err(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def parallel_lm(dev, mesh, kc, comm) -> dict:
    """(a) The tiny LM at full width, 8 x 2048, fp32: three train_steps
    under make_mesh(1, 1, 1) (the model sharded by shard_model at model
    size 1: the Megatron pair, the vocab-parallel embedding and cross
    entropy and the data/seq gradient sums all launched) against three
    without a mesh from the same weights: losses and the first step's
    gradients within REL_PARALLEL, #8, #6 and #10 launched as often both
    ways; then the step ms both ways, in turns."""
    from fft_tpu_torch.models.lm import lm_init, tiny_lm_config
    from fft_tpu_torch.parallel import shard_model
    from fft_tpu_torch.train import TrainConfig, train_init, train_step
    from fft_tpu_torch.train.data import CharDataset

    cfg = tiny_lm_config()
    batches = CharDataset().batches(8, cfg.max_seq, seed=SEED)
    bs = [next(batches) for _ in range(3)]

    def run(m):
        model = lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
        if m is not None:
            shard_model(model, m)
        state = train_init(model, TrainConfig(), seed=SEED + 1)
        before = {k: kc.LAUNCHES[k] for k in TRAIN_KERNELS}
        comm.reset_calls()
        losses, g0 = [], None
        for i, b in enumerate(bs):
            met = train_step(state, b, mesh=m)
            torch.cuda.synchronize()
            losses.append(float(met["loss"]))
            if i == 0:
                g0 = grads_of(model)
        used = {k: kc.LAUNCHES[k] - before[k] for k in TRAIN_KERNELS}
        return state, losses, g0, used, dict(comm.CALLS)

    plain, plain_losses, plain_g0, plain_used, _ = run(None)
    meshed, losses, g0, used, calls = run(mesh)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
    grad_err, worst = worst_rel(g0, plain_g0)
    if not (loss_err <= REL_PARALLEL and grad_err <= REL_PARALLEL
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"parallel LM: loss rel_err {loss_err}, "
                             f"gradient {worst} rel_err {grad_err} (limit "
                             f"{REL_PARALLEL})")
    if used != plain_used or not all(used.values()):
        raise AssertionError(f"parallel LM: launches {used} with the mesh, "
                             f"{plain_used} without")
    times = {"plain": [], "mesh": []}
    for _ in range(3):
        for key, st, m in (("plain", plain, None), ("mesh", meshed, mesh)):
            t0 = time.perf_counter()
            train_step(st, bs[0], mesh=m)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    return dict(batch=8, seq=cfg.max_seq, losses=losses,
                plain_losses=plain_losses, loss_rel_err=loss_err,
                first_step_grad_rel_err=grad_err, worst_grad=worst,
                launches=used, plain_launches=plain_used, step_ms=ms["mesh"],
                plain_step_ms=ms["plain"], step_ms_all=times,
                mesh_overhead_ms=ms["mesh"] - ms["plain"], collectives=calls)


def parallel_causal(dev, mesh, comm) -> dict:
    """(b) sp_segmented_causal_mix at S = 1 at the tiny LM's width (8 x
    2048, d=512, chunk 128, 32 gate columns), forward and backward, against
    segmented_causal_mix; both take kf_fused."""
    from fft_tpu_torch.layers.causal_seg import (
        BRANCH_CALLS, segmented_causal_mix, sp_segmented_causal_mix)
    from fft_tpu_torch.models.lm import tiny_lm_config

    cfg = tiny_lm_config().block
    hc = cfg.head_config()
    b, n, chunk = 8, cfg.n_fft, cfg.causal_chunk
    cols = cfg.num_heads * cfg.num_groups
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    v = randn(b, n, cfg.embed_dim).requires_grad_()
    gate = torch.complex(randn(b, n // chunk, cols, hc.f_half),
                         randn(b, n // chunk, cols, hc.f_half))
    gate = (0.1 * gate).requires_grad_()
    w = randn(b, n, cfg.embed_dim)

    def fwd_bwd(fn):
        v.grad = gate.grad = None
        y = fn()
        (y * w).sum().backward()
        return y.detach(), v.grad.clone(), torch.view_as_real(
            gate.grad.clone())

    plain = lambda: segmented_causal_mix(v, gate, hc, chunk)  # noqa: E731
    sp = lambda: sp_segmented_causal_mix(v, gate, hc, chunk,  # noqa: E731
                                         mesh)
    before = BRANCH_CALLS["kf_fused"]
    want = fwd_bwd(plain)
    comm.reset_calls()
    got = fwd_bwd(sp)
    calls = dict(comm.CALLS)
    kf = BRANCH_CALLS["kf_fused"] - before
    err = rel_err(got, want)
    if err > REL_KERNEL or kf != 2:
        raise AssertionError(f"causal SP: rel_err {err} (limit {REL_KERNEL}),"
                             f" kf_fused taken {kf} times of 2")
    return dict(batch=b, seq=n, chunk=chunk, rel_err=err, branch="kf_fused",
                collectives=calls,
                fwd_bwd_ms=median_ms(lambda: fwd_bwd(sp), 2, 3),
                plain_fwd_bwd_ms=median_ms(lambda: fwd_bwd(plain), 2, 3))


def parallel_mixes(dev, mesh, comm) -> list:
    """(c) Both SP mixes at S = 1 on the config-1 block's shapes (8 x 1024
    and 1 x 8192, d=512, 64 gate columns, memory), forward and backward,
    against spectral_mix's fused branch (#1/#2 at 1024, #3 and the cuFFT
    autograd backward at 8192); ms of each and the all-to-alls."""
    from fft_tpu_torch.kernels.spectral_mix import spectral_mix
    from fft_tpu_torch.parallel.dist_fft import (
        sp_plan_strided, sp_spectral_mix, sp_spectral_mix_strided,
        sp_stride_permute)

    out = []
    d, cols = 512, 64
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    for b, n in ((8, 1024), (1, 8192)):
        f = n // 2 + 1

        def randn(*shape):
            return torch.randn(shape, generator=g, device=dev)

        v = randn(b, n, d).requires_grad_()
        g_r = (0.5 * randn(b, f, cols)).requires_grad_()
        g_i = (0.5 * randn(b, f, cols)).requires_grad_()
        mem = torch.complex(randn(f, d), randn(f, d)) / math.sqrt(2.0 * d)
        mem_t = torch.fft.irfft(mem, n, dim=0).contiguous()
        w = randn(b, n, d)
        n1 = sp_plan_strided(n, 1)

        def gate_bc():
            return torch.complex(g_r, g_i).repeat_interleave(d // cols,
                                                             dim=-1)

        ways = {
            "fused": lambda: spectral_mix(v, g_r, g_i, mem_t, n),
            "contiguous": lambda: sp_spectral_mix(
                v, gate_bc(), mem, n_fft=n, mesh=mesh),
            "strided": lambda: sp_stride_permute(sp_spectral_mix_strided(
                sp_stride_permute(v, n1, n // n1), gate_bc(), mem, n_fft=n,
                mesh=mesh), n1, n // n1, inverse=True)}

        def fwd_bwd(fn):
            v.grad = g_r.grad = g_i.grad = None
            y = fn()
            (y * w).sum().backward()
            return y.detach(), v.grad.clone(), g_r.grad.clone(), \
                g_i.grad.clone()

        want = fwd_bwd(ways["fused"])
        rec = dict(batch=b, n=n, d=d, cols=cols,
                   fused_ms=median_ms(lambda: fwd_bwd(ways["fused"]), 2, 3))
        for layout in ("contiguous", "strided"):
            comm.reset_calls()
            got = fwd_bwd(ways[layout])
            a2a = comm.CALLS["all_to_all"]
            err = rel_err(got, want)
            expect = 8 if layout == "contiguous" else 4
            if err > REL_KERNEL or a2a != expect:
                raise AssertionError(f"SP mix {layout} at {b} x {n}: rel_err"
                                     f" {err} (limit {REL_KERNEL}), "
                                     f"{a2a} all-to-alls, not {expect}")
            rec[layout] = dict(rel_err=err, all_to_all_fwd_bwd=a2a,
                               ms=median_ms(lambda: fwd_bwd(ways[layout]),
                                            2, 3))
        out.append(rec)
    return out


def parallel_tp_block(dev, mesh, comm) -> dict:
    """(c') The config-1 block (fft_impl="pallas", mean pooling, memory
    16) with the wavelet on (rate 1.0), 8 x 1024, under tp_mesh at model
    size 1 (its heads and MLP by Megatron's layout, the wavelet's gate from
    the gathered descriptor) against the block without a mesh: output and
    every gradient of sum(y^2), #1 and #2 on both sides."""
    from fft_tpu_torch.config import SpectreConfig
    from fft_tpu_torch.layers.spectre import spectre_block_init
    from fft_tpu_torch.parallel import shard_model

    cfg = SpectreConfig(embed_dim=512, num_heads=8, n_fft=1024,
                        pooling_type="mean", wavelet_on_rate=1.0,
                        memory_size=16, fft_impl="pallas")
    x = torch.randn((8, 1024, 512), generator=torch.Generator(
        device=dev).manual_seed(SEED + 3), device=dev)
    res = {}
    for key, m in (("plain", None), ("tp", mesh)):
        block = spectre_block_init(cfg, torch.Generator().manual_seed(SEED),
                                   dev)
        if m is not None:
            shard_model(block, m)
        comm.reset_calls()
        y = block(x, tp_mesh=m)
        (y ** 2).sum().backward()
        torch.cuda.synchronize()
        res[key] = (y.detach(), grads_of(block), dict(comm.CALLS))
    y_err = rel_err(res["tp"][0], res["plain"][0])
    grad_err, worst = worst_rel(res["tp"][1], res["plain"][1])
    calls = res["tp"][2]
    if (max(y_err, grad_err) > REL_PARALLEL or not calls["gather_from"]
            or not calls["copy_to"] or not calls["reduce_from"]):
        raise AssertionError(f"TP block: output rel_err {y_err}, gradient "
                             f"{worst} rel_err {grad_err} (limit "
                             f"{REL_PARALLEL}), collectives {calls}")
    return dict(batch=8, seq=1024, wavelet_on_rate=1.0, rel_err=y_err,
                grad_rel_err=grad_err, worst_grad=worst, collectives=calls)


def parallel_hybrid_pipeline(dev, mesh, stages, comm) -> dict:
    """(d) The tiny hybrid (1 x 2048, window 256): a hybrid_train_step
    with cp_mesh at S = 1 (the SWA blocks' halo hop) against one without;
    pipeline_apply with 1 stage and 2 microbatches over the tiny LM's 6
    blocks (fp32, 2 x 2048) against the plain stack a microbatch at a
    time, output and every block gradient of sum(y^2)."""
    from fft_tpu_torch.models.hybrid import hybrid_init, hybrid_tiny_config
    from fft_tpu_torch.models.lm import lm_init, tiny_lm_config
    from fft_tpu_torch.parallel.pipeline import pipeline_apply
    from fft_tpu_torch.train import TrainConfig, hybrid_train_step, \
        train_init
    from fft_tpu_torch.train.data import CharDataset

    cfg = hybrid_tiny_config()
    batch = next(CharDataset().batches(1, cfg.max_seq, seed=SEED))
    res = {}
    for key, m in (("plain", None), ("cp", mesh)):
        model = hybrid_init(cfg, torch.Generator().manual_seed(SEED), dev)
        state = train_init(model, TrainConfig(), seed=SEED + 1,
                           deterministic=True)
        comm.reset_calls()
        met = hybrid_train_step(state, batch, cp_mesh=m)
        torch.cuda.synchronize()
        res[key] = (float(met["loss"]), grads_of(model), dict(comm.CALLS))
    loss_err = abs(res["cp"][0] - res["plain"][0]) / abs(res["plain"][0])
    grad_err, worst = worst_rel(res["cp"][1], res["plain"][1])
    if not (loss_err <= REL_PARALLEL and grad_err <= REL_PARALLEL
            and res["cp"][2]["halo"]):
        raise AssertionError(f"hybrid CP: loss rel_err {loss_err}, gradient "
                             f"{worst} rel_err {grad_err}, halo hops "
                             f"{res['cp'][2]['halo']}")
    hybrid = dict(batch=1, seq=cfg.max_seq, window=cfg.attn_window,
                  loss=res["cp"][0], loss_rel_err=loss_err,
                  grad_rel_err=grad_err, worst_grad=worst,
                  collectives=res["cp"][2])

    lm = lm_init(tiny_lm_config(), torch.Generator().manual_seed(SEED), dev)
    h = torch.randn((2, 2048, 512), generator=torch.Generator(
        device=dev).manual_seed(SEED + 2), device=dev)

    def stack(x):
        for block in lm.blocks:
            x = block(x)
        return x

    # the plain stack on each microbatch (GPipe's arithmetic: a gradient
    # of the whole batch at once rounds otherwise, and the modReLUs'
    # kinks turn such roundings into 1e-2 on their bias's gradient)
    y_plain = torch.cat([stack(h[i:i + 1]) for i in range(2)])
    for i in range(2):
        (stack(h[i:i + 1]) ** 2).sum().backward()
    want = grads_of(lm.blocks)
    lm.zero_grad(set_to_none=True)
    with torch.no_grad():
        whole_err = rel_err(stack(h), y_plain)
    comm.reset_calls()
    y = pipeline_apply(lm.blocks, lambda blk, x: blk(x), h, mesh=stages,
                       num_microbatches=2)
    (y ** 2).sum().backward()
    calls = dict(comm.CALLS)
    y_err = rel_err(y, y_plain)
    grad_err, worst = worst_rel(grads_of(lm.blocks), want)
    if max(y_err, whole_err) > REL_BLOCK or grad_err > REL_MODEL:
        raise AssertionError(f"pipeline: output rel_err {y_err}, the whole "
                             f"batch's {whole_err} (limit {REL_BLOCK}), "
                             f"gradient {worst} rel_err {grad_err} (limit "
                             f"{REL_MODEL})")
    return dict(hybrid=hybrid, pipeline=dict(
        batch=2, seq=2048, layers=len(lm.blocks), microbatches=2,
        rel_err=y_err, whole_batch_rel_err=whole_err, grad_rel_err=grad_err,
        worst_grad=worst, collectives=calls))


def phase_parallel(dev, kc, reset_launches, launches) -> dict:
    """12. parallel: module 7c on a 1-rank NCCL group, built by
    distributed_init (explicit rank 0, world 1, a file store in a
    temporary directory): (a) parallel_lm, (b) parallel_causal, (c)
    parallel_mixes and parallel_tp_block, (d) parallel_hybrid_pipeline,
    each with its collectives by kind; every kind of parallel/comm.py is
    called.
    Returns the phase's kernel launches; the group is destroyed after."""
    import tempfile

    import torch.distributed as dist
    from fft_tpu_torch.parallel import (
        comm, distributed_init, make_mesh, make_stage_mesh)

    store = tempfile.mkdtemp()
    distributed_init(f"file://{store}/store", 1, 0, dev)
    try:
        backend = dist.get_backend()
        mesh = make_mesh(1, 1, 1, dev)
        stages = make_stage_mesh(1, dev)
        emit(phase="parallel_group", backend=backend,
             world_size=dist.get_world_size(), mesh=mesh.shape)
        if backend != "nccl":
            raise AssertionError(f"parallel: backend {backend}, not nccl")
        reset_launches()
        lm = parallel_lm(dev, mesh, kc, comm)
        emit(phase="parallel_lm", **lm)
        causal = parallel_causal(dev, mesh, comm)
        emit(phase="parallel_causal_sp", **causal)
        mixes = parallel_mixes(dev, mesh, comm)
        emit(phase="parallel_sp_mixes", cases=mixes)
        tp_block = parallel_tp_block(dev, mesh, comm)
        emit(phase="parallel_tp_block", **tp_block)
        rest = parallel_hybrid_pipeline(dev, mesh, stages, comm)
        emit(phase="parallel_hybrid_cp", **rest["hybrid"])
        emit(phase="parallel_pipeline", **rest["pipeline"])
        used = launches()
        kinds = set()
        for calls in (lm["collectives"], causal["collectives"],
                      tp_block["collectives"], rest["hybrid"]["collectives"],
                      rest["pipeline"]["collectives"]):
            kinds |= {k for k, v in calls.items() if v}
        if mixes:
            kinds.add("all_to_all")
        missing = sorted(set(comm.KINDS) - kinds)
        emit(phase="parallel_launches", kinds_called=sorted(kinds),
             **{k: v for k, v in used.items() if v})
        if missing:
            raise AssertionError(f"parallel: collectives never called: "
                                 f"{missing}")
        return used
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this check runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 GEMMs accumulate in fp32 throughout, as the CPU's and the
    # reference's (no bf16 partial sums in split-K reductions)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    from fft_tpu_torch import cli
    from fft_tpu_torch.kernels import build
    from fft_tpu_torch.kernels import causal as kc
    from fft_tpu_torch.kernels import decode as kd
    from fft_tpu_torch.kernels import spectral_mix as sm
    from fft_tpu_torch.models.lm import (
        lm_apply, lm_decode_step, lm_generate, lm_init, lm_prefill,
        tiny_lm_config,
    )

    dev = torch.device("cuda")
    start = time.perf_counter()

    def mark(after: str) -> None:
        """The run's seconds so far, after a phase (where the time goes)."""
        emit(phase="elapsed", after=after,
             seconds=time.perf_counter() - start)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()

    # 1. build ---------------------------------------------------------------
    first = start_first_direct10()
    build.load_library()
    emit(phase="build", seconds=build.BUILD_INFO["seconds"],
         library=build.BUILD_INFO["path"])
    if build.BUILD_INFO["log"].strip():
        print(build.BUILD_INFO["log"].strip(), flush=True)

    # 2. kernels vs plain ----------------------------------------------------
    kernel_results = phase_kernels(kc, sm, kd, dev, first)
    mark("kernels")

    def reset_launches():
        kc.reset_launches()
        sm.reset_launches()
        kd.reset_launches()

    def launches():
        return {**kc.LAUNCHES, **sm.LAUNCHES, **kd.LAUNCHES}

    # 3. score ---------------------------------------------------------------
    cfg = tiny_lm_config()
    model = lm_init(cfg, torch.Generator().manual_seed(SEED), dev)
    model_cpu = lm_init(cfg, torch.Generator().manual_seed(SEED), "cpu")
    tg = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (4, cfg.max_seq), generator=tg)
    prompts = torch.randint(0, cfg.vocab_size, (4, 1024), generator=tg)
    steps = 64

    reset_launches()                          # the serving path starts here
    logits = lm_apply(model, toks.to(dev))
    torch.cuda.synchronize()
    ref = lm_apply(model_cpu, toks)
    err = rel_err(logits, ref)
    if not (logits.shape == (4, cfg.max_seq, cfg.vocab_size)
            and torch.isfinite(logits).all() and err <= REL_MODEL):
        raise AssertionError(f"score: rel_err {err} > {REL_MODEL}, shape "
                             f"{tuple(logits.shape)} or non-finite")
    ms = wall_ms(lambda: lm_apply(model, toks.to(dev)))
    toks_dev = toks.to(dev)
    prof = fprof.read_profile(lambda: lm_apply(model, toks_dev),
                              torch.cuda.synchronize, 3)
    emit(phase="score", batch=4, seq=cfg.max_seq, rel_err=err, ms=ms,
         tokens_per_s=4 * cfg.max_seq / (ms / 1e3), profile=prof)

    # 4. generate ------------------------------------------------------------
    before = kd.LAUNCHES["fused_decode_mix"]
    out = lm_generate(model, prompts.to(dev), steps=steps)
    torch.cuda.synchronize()
    gen_launches = kd.LAUNCHES["fused_decode_mix"] - before
    if not (out.shape == (4, steps) and int(out.min()) >= 0
            and int(out.max()) < cfg.vocab_size):
        raise AssertionError(f"generate: bad tokens {tuple(out.shape)}")
    if gen_launches != cfg.num_layers * (steps - 1):
        raise AssertionError(f"generate: fused_decode_mix launched "
                             f"{gen_launches} times, not once a layer per "
                             f"decode step ({cfg.num_layers} x {steps - 1})")
    p_err, d_err = teacher_forced(model, model_cpu, prompts, out[:, :8], dev)
    if not (p_err <= REL_MODEL and d_err <= REL_MODEL):
        raise AssertionError(f"generate: prefill rel_err {p_err}, decode "
                             f"rel_err {d_err} (limit {REL_MODEL})")
    prefill_ms = wall_ms(lambda: lm_prefill(model, prompts.to(dev)))

    def decode_run():
        _, cs = lm_prefill(model, prompts.to(dev))
        torch.cuda.synchronize()
        tok = out[:, 0]
        t0 = time.perf_counter()
        for i in range(steps):
            lg, cs = lm_decode_step(model, tok, 1024 + i, cs)
            tok = lg.argmax(-1)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    decode_ms, decode_prof = both_branches(
        kd, decode_run, lambda: decode_profile(model, prompts.to(dev), 1024,
                                               out[:, 0], 8))
    emit(phase="generate", batch=4, prompt=1024, steps=steps,
         fused_decode_launches=gen_launches, prefill_rel_err=p_err,
         decode_rel_err=d_err, teacher_forced_steps=8, prefill_ms=prefill_ms,
         decode_ms_per_token=decode_ms[True],
         decode_ms_per_token_plain=decode_ms[False],
         decode_profile_fused=decode_prof[True],
         decode_profile_plain=decode_prof[False])

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["generate", "--device", "cuda", "--steps", str(steps)])
    text = buf.getvalue()
    if not text.startswith("the "):
        raise AssertionError(f"cli generate printed {text!r}")
    emit(phase="cli_generate", prompt="the ", steps=steps, chars=len(text))
    mark("tiny_serving")

    # 5. launches ------------------------------------------------------------
    serve_launches = launches()
    emit(phase="launches", **serve_launches)
    missing = [k for k in SERVE_KERNELS if serve_launches[k] == 0]
    direct = {k: serve_launches[k] for k in TINY_DIRECT if serve_launches[k]}
    if missing or direct:
        raise AssertionError(f"kernels never launched on the serving path: "
                             f"{missing}; direct kernels launched: {direct}")
    # the later phases' peak memory is their own
    del model, model_cpu, logits, ref, out

    # 4c, 4d. decode past the window's wrap; the pooler descriptors ---------
    reset_launches()                          # their own path starts here
    phase_decode_wrap(cfg, dev)
    phase_pooler_lm(cfg, dev)
    decode_launches = launches()
    emit(phase="decode_launches", **decode_launches)
    missing = [k for k in DECODE_KERNELS if decode_launches[k] == 0]
    direct = {k: decode_launches[k] for k in TINY_DIRECT
              if decode_launches[k]}
    if missing or direct:
        raise AssertionError(f"kernels never launched past the wrap or on "
                             f"the pooler LM: {missing}; direct kernels "
                             f"launched: {direct}")

    # 6. train ---------------------------------------------------------------
    reset_launches()                          # the training path starts here
    tiny_fp32_step_ms = phase_train(cfg, dev)
    train_launches = launches()
    emit(phase="train_launches", **train_launches)
    missing = [k for k in TRAIN_KERNELS if train_launches[k] == 0]
    direct = {k: train_launches[k] for k in TINY_DIRECT if train_launches[k]}
    if missing or direct:
        raise AssertionError(f"kernels never launched on the training path: "
                             f"{missing}; direct kernels launched: {direct}")
    mark("tiny_training")

    # 6b. the tiny LM in bf16 ---------------------------------------------
    reset_launches()                          # the tiny bf16 path
    tiny_bf16 = phase_tiny_bf16(dev)
    tiny_bf16_launches = launches()
    emit(phase="tiny_bf16_launches", **tiny_bf16_launches)
    missing = [k for k in TINY_BF16_KERNELS if tiny_bf16_launches[k] == 0]
    fp32 = {k: tiny_bf16_launches[k] for k in (
        "fused_causal_mix", "fused_causal_mix_bwd",
        "fused_causal_mix_direct_bf16", *TINY_DIRECT)
        if tiny_bf16_launches[k]}
    if missing or fp32:
        raise AssertionError(f"tiny bf16: never launched {missing}; "
                             f"launched outside its bf16 kernels {fp32}")
    emit(phase="tiny_bf16_vs_fp32_step", bf16_step_ms=tiny_bf16[
        "median_step_ms"], fp32_step_ms=tiny_fp32_step_ms)
    mark("tiny_bf16")

    # 6c. the tiny LM at seq 8192: the direct #6 and #10 -----------------
    tiny_long_launches = phase_tiny_long(dev, kc, reset_launches, launches)
    emit(phase="tiny_long_launches", **tiny_long_launches)
    mark("tiny_long")

    # 7. block -------------------------------------------------------------
    reset_launches()                          # the block's path starts here
    phase_block(dev)
    phase_block_1536(dev, sm)
    phase_wide_block(dev)
    block_launches = launches()
    emit(phase="block_launches", **block_launches)
    missing = [k for k in BLOCK_KERNELS if block_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the block path: "
                             f"{missing}")

    # 7b, 7c. the block past n_fft 2048 ------------------------------------
    reset_launches()                          # #3's path starts here
    phase_block_long(dev)
    block_long_launches = launches()
    emit(phase="block_long_launches", **block_long_launches)
    missing = [k for k in BLOCK_LONG_KERNELS if block_long_launches[k] == 0]
    if missing or block_long_launches["direct_mix_bwd"]:
        raise AssertionError(f"block past n_fft 2048: never launched "
                             f"{missing}, or #2 launched "
                             f"{block_long_launches['direct_mix_bwd']} times")
    reset_launches()                          # #4's path starts here
    forwards_on = phase_twopass(dev, sm)
    twopass_launches = launches()
    emit(phase="twopass_launches", block_forwards_on=forwards_on,
         **twopass_launches)
    if not forwards_on or twopass_launches["twopass_mix"] != forwards_on:
        raise AssertionError(f"two-pass block: twopass_mix launched "
                             f"{twopass_launches['twopass_mix']} times in "
                             f"{forwards_on} forwards with the flag on")
    mark("blocks")

    # 7d. the config-1 block in bf16 --------------------------------------
    reset_launches()                          # the bf16 block's path
    forwards_on = phase_block_bf16(dev, sm)
    block_bf16_launches = launches()
    emit(phase="block_bf16_launches", block_forwards_on=forwards_on,
         **block_bf16_launches)
    missing = [k for k in BLOCK_BF16_KERNELS if block_bf16_launches[k] == 0]
    fp32 = {k: block_bf16_launches[k.removesuffix("_bf16")]
            for k in BLOCK_BF16_KERNELS
            if block_bf16_launches[k.removesuffix("_bf16")]}
    if (missing or fp32
            or block_bf16_launches["twopass_mix_bf16"] != forwards_on):
        raise AssertionError(f"bf16 block: never launched {missing}, fp32 "
                             f"instances launched {fp32}, twopass_mix_bf16 "
                             f"{block_bf16_launches['twopass_mix_bf16']} in "
                             f"{forwards_on} forwards with the flag on")
    mark("block_bf16")

    # 8. 350m --------------------------------------------------------------
    phase_350m_parity(dev, kc)
    serve_350m, train_350m = phase_350m(dev, kd, reset_launches, launches)
    mark("350m")

    # 8d. the 350M's short prompts: 512-1500 tokens, fp32 and bf16 ----------
    reset_launches()                          # the short prompts
    phase_350m_short(dev, kc)
    short_launches = launches()
    emit(phase="350m_short_launches", **short_launches)
    mark("350m_short")

    # 8b. 350m checkpoints, restart, BPE -----------------------------------
    serve_ckpt, train_ckpt = phase_350m_ckpt(dev, reset_launches, launches)
    mark("350m_ckpt")

    # 8c. 350m at seq 32768 and 65536, fp32 and bf16 -----------------------
    phase_350m_long_parity(dev, kc)
    mark("350m_long_parity")
    serve_long, train_long, cli_long = phase_350m_long(dev, reset_launches,
                                                       launches)
    mark("350m_long")

    # 9. the ViT (config 3) ------------------------------------------------
    reset_launches()                          # the ViT's path: no kernel
    phase_vit(dev)
    mark("vit")

    # 10. the hybrid LMs (config 5) ----------------------------------------
    hybrid_tiny = phase_hybrid_tiny(dev, kc, reset_launches, launches)
    mark("hybrid_tiny")
    hybrid_1b = phase_hybrid_1b(dev, kc, reset_launches, launches)
    mark("hybrid_1b")

    # 11. prof: module 7b, the untied head, fft_impl="matmul" --------------
    reset_launches()                          # the profiled paths
    phase_prof(dev)
    prof_launches = launches()
    emit(phase="prof_launches", **prof_launches)
    missing = [k for k in TRAIN_KERNELS if prof_launches[k] == 0]
    direct = {k: prof_launches[k] for k in TINY_DIRECT if prof_launches[k]}
    if missing or direct:
        raise AssertionError(f"prof: never launched {missing}; direct "
                             f"kernels launched: {direct}")
    mark("prof")

    # 12. parallel: module 7c on a 1-rank NCCL group ---------------------
    parallel_launches = phase_parallel(dev, kc, reset_launches, launches)
    mark("parallel")

    summary = []
    for name, cases in kernel_results.items():
        main_case = next(c for c in cases if c["main"])
        by_path = dict(serve=serve_launches[name],
                       decode=decode_launches[name],
                       train=train_launches[name],
                       block=block_launches[name],
                       block_long=block_long_launches[name],
                       twopass=twopass_launches[name],
                       serve_350m=serve_350m[name],
                       train_350m=train_350m[name],
                       ckpt_train_350m=train_ckpt[name],
                       ckpt_serve_350m=serve_ckpt[name],
                       serve_350m_long=serve_long.get(name, 0),
                       train_350m_long=train_long.get(name, 0),
                       cli_350m_long=cli_long.get(name, 0),
                       tiny_bf16=tiny_bf16_launches[name],
                       tiny_long=tiny_long_launches[name],
                       block_bf16=block_bf16_launches[name],
                       short_350m=short_launches[name],
                       hybrid_tiny=hybrid_tiny["float32"][name],
                       hybrid_tiny_bf16=hybrid_tiny["bfloat16"][name],
                       hybrid_1b=hybrid_1b[name],
                       prof=prof_launches[name],
                       parallel=parallel_launches[name])
        summary.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=REPLACES[name], launches=sum(by_path.values()),
            launches_by_path=by_path,
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            device_ms=main_case["device_ms"],
            device_ms_source=main_case["device_ms_source"],
            plain_device_ms=main_case["plain_device_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            library_ms=main_case["library_ms"],
            library_device_ms=main_case["library_device_ms"],
            **{k: main_case[k] for k in ("fp32_ms", "fp32_device_ms",
                                         "parent_ms", "parent_device_ms")
               if k in main_case},
            shape=main_case["shape"],
            cases=cases))
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
