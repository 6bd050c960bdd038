#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it, phase by phase.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  device       the card (nvidia-smi name and power limit, torch's name);
  build        nvcc build of every CUDA source of the port, all in parallel
               (seconds; ~0 if cached); per kernel, ptxas's registers, shared
               memory, spills and warnings and the HMMA (mma.sync) and HGMMA
               (wgmma) counts of `cuobjdump -sass` (cuobjdump from beside
               nvcc); every kernel of both must show HGMMA and none may
               spill;
  kernel_check each kernel against its plain PyTorch version on the card, at
               its path's shape and at edge shapes (one or two layers, K=1, odd
               B, C and L that are no multiple of the kernel's tile, odd C,
               C=128 and 256, a partly filled last block; for K2 also B=1001,
               whose blocks of 2 rows fill their tiles in part, and C=300 in
               two column groups) and at the
               long-block shape L=1000 that the wrappers window; each
               kernel's plan (rows and blocks, warpgroups, tiles a
               warpgroup, wgmma width, ring stages) beside each of its cases;
  forward      the crown checkpoint's forward on the card against the port's
               own forward on the CPU, on the same small input;
  crown_sweep  main path 1: the crown's bf16 evaluation sweep through the
               fused decoder (-1 dB and 0 dB, 20,000 blocks each, batch 2000),
               held to artifacts/eval_crown_r4.json by a two-proportion z test,
               with the kernels' launch counts read around it;
  train_step   from the crown's params and one batch of host-drawn bits and
               noise: a decoder, an encoder, a joint and an STE encoder step in
               f32, unfused, on the card against the port on the CPU;
  train        main path 2: one epoch of the flagship recipe from a seeded
               init at full width, bf16, fused (50 encoder steps, 5 decoder
               epochs of 50 steps, batch 500), then validate; launches read
               around it;
  channels     every channel's sampler and the fading gain on the card, drawn
               from a CUDA generator (1e7 samples each), against the moments
               the CPU tests hold (tests/test_torch_channels.py);
  fading_curve path 3: artifacts/flagship_fading.msgpack through
               cli/eval_flagship.evaluate (--channel fading, bf16, fused,
               batch 2000, -1 and 0 dB, 20,000 blocks each), held to
               artifacts/eval_fading.json by the BLER z test;
  legacy_curve path 4: the crown under --legacy_noise at -1 and 0 dB,
               20,000 blocks each, held to artifacts/eval_crown_legacy.json
               with n = 2000 (one noise realization) on both sides; the
               sweep must draw its noise once;
  test_pass    path 5: Trainer.test on the crown (bf16, fused, -1 and 0 dB,
               10,000 blocks, with the punctured second pass): main-pass
               BLER against eval_crown_r4.json, encoder power 1 +- 1e-2;
  resume       path 6: flagship_fading.msgpack with its Adam state: one f32
               decoder step on the card against the CPU from the same state,
               batch and gain; then one epoch of the fading leg-2 recipe
               through cli/train_flagship.main (--resume, bf16, fused,
               num_block 5,000) into a temporary directory, reloaded: the
               epoch and the Adam counts carried on, the last decoder
               epoch's mean loss below RESUME_DEC_LOSS_MAX;
  deepturbo_encoder  DeepTurbo's classical turbo encoder (757 and LTE) on
               the card against the same function on the CPU, bit for bit
               (B=2000, L=100 and 1000), and its ms per call;
  deepturbo_forward  artifacts/deepturbo.msgpack (dense decoder stacks)
               loaded through train/checkpoint.py: the f32 forward on the
               card against the CPU within 1e-4, bf16 decisions reported;
  deepturbo_curve  path 8: DeepTurbo through cli/eval_flagship.evaluate
               (--encoder Turbo_rate3_757, bf16, batch 2000, 20,000 blocks a
               point at the 8 points -1.5..2.0 dB) held to
               artifacts/eval_deepturbo.json by the BLER z test; its dense
               stacks never launch K2;
  deepturbo_resume  path 9: deepturbo.msgpack with its Adam state: an f32
               decoder step on the card against the CPU, then one epoch of
               its last leg's recipe through cli/train_flagship.main
               (--num_train_enc 0, 6 decoder epochs, lr 2e-5): the epoch to
               523, the decoder's Adam count +30, the encoder's untouched,
               the loss below DEEPTURBO_DEC_LOSS_MAX, no K2 launch;
  losses       path 10: on the flagship, one f32 joint step of each of the
               nine losses on the card against the CPU; 6 Lookahead(Adam)
               decoder steps across the syncs at counts 0 and 5, card
               against CPU; then `-optimizer lookahead -loss maxBCE`
               through cli/main.main (bf16, fused), its K2 launches counted;
  gru_forward  ops/gru.py's card route (cuDNN, one call a layer) against its
               plain scan on the card and against the scan in f64, B=500,
               L=100, In=7, H=100, 2 layers: GRU f32 within 1e-5 relative,
               LSTM within F32_REL_TOL, GRU gradients within 1e-4, no cuDNN
               weight-copy warning; bf16 cuDNN (the port's bf16 route)
               within KERNEL_REL_TOL of the bf16 scan; ms a call of each;
  rnn_forward  the RNN zoo at full width from one seeded init (batch 32,
               0 dB), card against CPU: the rate-3 RNN pair, GRU and LSTM,
               rnn_sys + rate-3 decoder, the rate-2 pair, nbcjr; f32 within
               1e-4 and through cuDNN only; bf16 (cuDNN's bf16 RNN on the
               card, the bf16 scan on the CPU) decisions > 99 % agreeing;
  rnn_train    path 11: a joint f32 step of the rate-3 RNN pair, card against
               CPU (loss 1e-4, gradients 1e-3 of each leaf's largest); the
               share of head units dropped under -dropout 0.3 within 4 sigma
               of 0.3; then cli/main.py with the pair for one f32 epoch
               (num_block 1,000): finite, below the untrained 0.69, its train
               blocks/s;
  ftae_curve   path 12: cli/eval_ftae.py on artifacts/ftae_pa.msgpack
               (pos_phase, batch 2000, feedback at 40 dB, block_len 50) at
               -2..1 dB, 20,000 blocks a point: f32 held to
               artifacts/eval_ftae_pa.json (the TPU's bf16 curve) by the
               BLER z test, bf16 measured beside it (its z reported: the
               port's bf16, like JAX's on the CPU, lies above the TPU's);
               blocks/s of both; the guard refuses --ftae_power_alloc pos on
               that file;
  ftae_train   path 13: an f32 step of each phase from ftae_pa.msgpack's
               params, card against CPU (rnn_train's tolerances); cli/ftae_main
               with -dec_type turboae_rnn for one epoch at full width and
               block_len 50, finite and falling; the turboae_sharedcnn and
               cnn decoders' forwards, card against CPU, f32 within 1e-4;
  cnn_zoo_forward  path 14: the rest of the CNN zoo at full width from one
               seeded init a pair (batch 64, 0 dB; the 2D codes at img_size
               10): the two-interleaver, rate-2, no-interleaver and 2D pairs,
               every key of ROADMAP M9; f32 card against CPU within 1e-4
               relative, bf16 with the fused decoder asked for decisions
               > 99 % agreeing, 0 K2 launches (JAX fuses none of them);
  cnn_zoo_train  path 15: a joint f32 step of each pair card against CPU
               (rnn_train's tolerances); one cli/main.py epoch of the 2D pair
               in f32 at lr 1e-4 (batch 100, 10 encoder and 50 decoder steps):
               finite, below the untrained 0.69, its train blocks/s;
  mod_curve    path 16: artifacts/mod_ae.msgpack (the joint coding +
               modulation AE) through ModTrainer.test in f32, batch 2000,
               20,000 blocks a point at -2..2 dB, held by the BLER z test to
               the exact counts of artifacts/mod_tr2.out's closing test
               (50,000 blocks a point); blocks/s; 0 K2 launches;
  mod_forward  path 17: its forward on host-drawn bits and symbol noise, f32
               card against CPU within 1e-4; bf16 with K2 carrying the
               decoder's 12 stacks against bf16 unfused, decisions > 99 %
               agreeing, exactly 12 launches;
  mod_resume   path 18: mod_ae.msgpack with its four Adam states resumed for
               one epoch of its last leg (lr 1e-4, batch 500, 1/5/1/5
               encoder/decoder/mod/demod phase-epochs of 10 steps): each
               count up by its steps, each loss below MOD_LOSS_MAX; then
               cli/main_modulation.py from its params for one epoch, whose
               checkpoint has the file's layout;
  train_times  the port of bench.py (cli/bench_train.py), fused on and off,
               with its MFU;
  vbl_epoch    path 19: one cli/main.py epoch with --is_variable_block_len
               (10..199: the 8 buckets 10, 37, ..., 199), full width, bf16,
               fused, batch 500 (60 steps), then its tests at its length, at
               10 and at 200: the (phase, length) of every step as a narrow
               CPU trainer draws them from the same seed, every phase-epoch
               finite and the last below 0.69, 12 K2 launches a forward (K2
               is also held to its plain version at each bucket length, B=500,
               in kernel_check);
  k_same_code  path 20: is_k_same_code (k 2) at full width, bf16, fused: the
               encoder's bits shared by steps (0, 1) and (2, 3), the noise new
               at every step, the decoder's bits new at every step;
  norm_stats_test  path 21: test_pass with --precompute_norm_stats (the
               precompute's running mean and std threaded through both passes);
  graph_steps  path 22: steps_per_call as CUDA graphs (6 steps a replay, 2
               replays) against eager steps from the same params, optimizer
               state and generator: flagship_fading.msgpack's Adam state on
               its fading channel, bf16 fused and f32 unfused, both phases;
               Lookahead and SGD in f32; f32 losses within 1e-5 relative,
               bf16 within the gap of two eager runs plus 1e-3; K2 counted
               per replayed step; then bench_train's timed loop through the
               graphs, fused and unfused, beside train_times' eager figures;
  flops        cli/compute_flop's report on the card (the counted forward
               within 5 % of the closed form) and bench_train's step FLOPs,
               TFLOP/s and MFU (eager and graph) against the named peak;
  train_clis   path 23: the crown averaged with itself is its own file, byte
               for byte; select_checkpoint and select_bler_deep rank
               flagship.msgpack and flagship_fading.msgpack (4,000 blocks a
               point, fused); train_family resumes ftae_pa.msgpack and
               mod_ae.msgpack for one epoch each, every phase-epoch finite and
               below 0.69;
  classical_parity  path 24: each classical device decoder on the card
               against the same function on the CPU on host-seeded symbols:
               the turbo decoder in every variant for Turbo-757 and LTE
               (B=2000, L=100, -1 dB, 256 of the blocks again on the CPU;
               LLRs within 1e-2, decisions equal where |LLR| > 1e-3), Viterbi (hard, unquantized, tdist3 on
               [7,5] and [7,5,6]; decisions equal), LDPC BP on the (96, 48)
               design (MSA bits and LLRs on every frame, SPA bits on the
               converged frames and frame errors by z); the ms of a call,
               and launches and busy share of one;
  classical_curve  path 25: Turbo-757 through cli/turbo_benchmark on the
               card, each point's BLER held by z to the committed exact
               counts: torch_mc at -1.5..0 dB (K=100, 20,000 blocks a point,
               classical_awgn_k100.json), torch at -1 dB, torch with t-dist
               noise (vv 3) at -1.5 dB (classical_nonawgn_k100.json),
               torch_mc at K=1000, -1 dB, 4,000 blocks
               (classical_awgn_k1000.json); blocks/s a point;
  ldpc_fer     path 26: cli/ldpc_benchmark on the card at Eb/N0 2.5 dB (SPA,
               100 iterations, 20,000 frames), FER held by z to JAX's
               708/8,000 on the CPU, the reference's 0.1 beside it;
  viterbi_curve  path 27: cli/conv_benchmark ([7,5], unquantized, AWGN, 0, 2
               and 4 dB, 20,000 blocks a point) on the card and the same
               seeded run on the CPU: equal error counts;
  dist_train   path 28: data parallelism (ROADMAP M16), two gloo ranks on the
               one card, each its own process (`chip_smoke.py --dist-rank`),
               against this process alone: the flagship at full width from
               the crown's params, f32, global batch 500 (250 rows a rank), a
               decoder and an encoder step (losses within 1e-5 relative,
               params within rtol 1e-4 / atol 1e-5, both ranks alike) and 5
               timed decoder steps; a fused bf16 forward of each rank's rows
               (12 K2 launches a rank, decisions > 99.9 % those of the one
               process); the crown's sweep counts at -1 dB, 2,000 blocks, equal
               but for blocks within 1e-5 of 0.5, which it prints; steps_per_call
               2 under gloo refused;
  k1000_curve  path 31: artifacts/flagship_k1000.msgpack through
               cli/eval_flagship.evaluate (--block_len 1000, bf16, K2, AWGN,
               batch 2000) at 0 and 0.5 dB, 20,000 blocks a point, held to
               artifacts/eval_k1000.json by the BLER z test; its blocks/s
               beside the TPU's, which the file holds (marked as the TPU's);
  time_shard   path 32: time-axis sharding (ROADMAP M16b), two gloo ranks on
               the one card (`chip_smoke.py --dist-rank ... time_shard`) under
               shard_axis 'time' against this process alone, the K=1000
               flagship at full width from its file, global batch 32: an f32
               decoder and encoder step under dist_train's tolerances and Adam
               rule, both ranks alike; the bf16 forward through K2 on each
               rank's halo windows (500 + 10 positions; 12 launches a rank),
               its decisions equal but within 1e-2 of 0.5 (counted, printed);
               one sweep batch at 0 dB, its counts apart by its such flips;
  mesh_2d      path 33: a (2, 2) mesh ('data', 'model') of four gloo ranks
               on the card (`... mesh_2d`), the batch over the data axis,
               from the crown: an f32 decoder step at global batch 500 and a
               fused forward (12 K2 launches a rank); the two replicas of each
               data index bit-equal, the step against this process alone
               under dist_train's tolerances;
  native_parity  path 29: the C++ oracle (ROADMAP M15b, g++ at first use, its
               seconds printed) against the card's decoders: Turbo-757 hazzys
               (200 blocks, L=100, -1 dB) decisions equal but where the card's
               |LLR| < 1e-3 (counted), [7,5] Viterbi equal; one `-engine
               native` point of cli/turbo_benchmark (-1 dB, 10,000 blocks,
               blocks/s) by z against classical_awgn_k100.json;
  dist_cli     path 30: torchrun --nproc_per_node 1 (`chip_smoke.py --cli-rank`,
               which runs cli/main.py's main after its check): one NCCL rank;
               steps_per_call's CUDA graph under the NCCL mesh against eager
               steps (f32 losses within 1e-5 relative); then cli/main.py
               -mesh_shape 1 at full width (bf16, fused) trains one epoch and
               writes its checkpoint and log; K2 counted; it runs while
               native_parity runs here;
  examples     path 37: the five examples/torch_*.py on the card, each
               through its main at its own flags: conv_encode_decode (10
               noiseless 1000-bit round trips exact, the batched Viterbi's
               decisions the host decoder's), turbo_example (K = 50, 100,
               1000), viterbi_bawgn, fading_viterbi (each curve's BER and
               BLER finite, in [0, 1], no higher at the highest SNR than at
               the lowest), deepturbo cut to one epoch of 1,000 blocks (its
               last phase-epoch's loss below the untrained 0.69, its test
               curve held as the others); seconds of each; 0 launches;
  conv_stack_bench  path 7: the port of scripts/bench_conv_stack.py, the only
               path of K1, with its launches read around it;
  times        CUDA-event times of each kernel (a wrapper call, which packs
               the weights, and the launch alone on weights packed once),
               its plain version and a PyTorch library yardstick, beside
               the card's bound;
  atn_curve, radar_curve, binary_curve  paths 34-36: artifacts/flagship_
               {atn,radar,binary}.msgpack through cli/eval_flagship.evaluate
               (bf16, K2, batch 2000) at -1 and 0 dB, 20,000 blocks a point,
               with the flags tests/test_torch_curves_{awgn,channels}.py pass
               (t-dist vv 3; radar; block_norm_ste), held to
               artifacts/eval_{atn,radar,binary}.json by the BLER z test;
               last, since the whole set of checkpoints that the script
               reads passes what one copy to the card may hold;
  ftae_uniform_curve  path 38: ftae_curve's run on artifacts/ftae.msgpack
               (uniform power: --ftae_power_alloc none) held to
               artifacts/eval_ftae.json, the guard refusing pos (the file has
               no 'pw' leaf); last, for the same reason;
then the nvidia-smi line, the kernels' summary line, and last
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero and prints no result. Without a GPU it exits non-zero at once.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
STARTED = time.perf_counter()

SWEEP_POINTS = (-1.0, 0.0)
SWEEP_BLOCKS = 20000
SWEEP_BATCH = 2000
MAIN_SHAPE = (SWEEP_BATCH, 100, 7, 100, 5, 5)   # K2 on the sweep: B, L, Cin, C, K, layers
MAX_Z = 4.0
KERNEL_REL_TOL = 1e-2       # bf16 tolerance of the Pallas kernel tests (tests/test_kernels.py:33-41)
F32_REL_TOL = 2e-5          # f32 tolerance of the Pallas kernel tests (tests/test_kernels.py:25-30)

TRAIN_BATCH = 500
BENCH_SHAPE = (TRAIN_BATCH, 100, 7, 100, 5, 5)  # the conv-stack bench's and training's
TRAIN_NUM_BLOCK = 25000     # scripts/train_flagship.py defaults: 50 steps per epoch
# The last decoder epoch's mean loss (what scripts/train_flagship.py logs as
# dec_loss) must lie below this after one epoch of the recipe. Fixed before
# the first run on the card; the JAX trainer logged 0.159 there in f32
# (logs/flagship.jsonl:1), an untrained decoder ~0.69.
DEC_LOSS_MAX = 0.25
PARITY_BATCH = 64

CHANNEL_SAMPLES = 10_000_000
TEST_PASS_BLOCKS = 10000
LEGACY_N = SWEEP_BATCH       # independent noise blocks under legacy noise, each side
RESUME_NUM_BLOCK = 5000
RESUME_BATCH = 500          # scripts/train_flagship.py's default: 10 steps an epoch
# After one epoch of the fading leg-2 recipe resumed from
# artifacts/flagship_fading.msgpack, the last decoder epoch's mean loss must
# lie below this. Fixed before the first run on the card: the JAX leg logged
# 0.095 at its epoch 150 (artifacts/flagship_fading2.jsonl); a fresh init
# gives ~0.69.
RESUME_DEC_LOSS_MAX = 0.15

DEEPTURBO_POINTS = (-1.5, -1.0, -0.5, 0.0, 0.5, 1.0, 1.5, 2.0)   # >= 20 block errors at 20,000
# After one epoch of DeepTurbo's last leg (lr 2e-5, decoder SNR -2.5..2 dB)
# resumed from artifacts/deepturbo.msgpack, the last decoder epoch's mean
# loss must lie below this. Fixed before the first run on the card: the JAX
# leg's last three epochs logged 0.0376-0.0384 (artifacts/deepturbo5.out).
DEEPTURBO_DEC_LOSS_MAX = 0.05
# DeepTurbo's resumed epoch at 2,500 blocks (5 steps a decoder epoch), the
# fading resume's at RESUME_NUM_BLOCK: a depth cut, as MOD_RECIPE's
DEEPTURBO_RESUME_NUM_BLOCK = 2500
LOSSES = ('bce', 'soft_ber', 'bce_rl', 'enc_rl', 'bce_block', 'focal', 'mse', 'maxBCE',
          'sortBCE')
LOOKAHEAD_STEPS = 6         # across the syncs at counts 0 and 5
LOSSES_NUM_BLOCK = 1000     # the cli/main.py run: 2 steps an epoch at batch 500
LOSSES_BATCH = 500
RNN_FORWARD_BATCH = 32              # rnn_forward's blocks, card and CPU (a depth cut from 64)
GRU_SHAPE = (500, 100, 7, 100, 2)   # B, L, In, H, layers: the rate-3 RNN decoder's first biGRU
GRU_F32_TOL = 1e-5                  # cuDNN's f32 GRU against the plain scan, relative
RNN_EPOCH_LOSS_MAX = 0.69           # the untrained BCE, log 2; fixed before the first card run
RNN_NUM_BLOCK = 1000
FTAE_POINTS = (-2.0, -1.0, 0.0, 1.0)  # 2 dB expects ~2 block errors at 20,000
FTAE_NUM_BLOCK = 5000               # the cli/ftae_main.py epoch: 10 steps at batch 500
FTAE_BATCH = 500
# the CNN zoo's pairs (encoder, decoder, code_rate_n): every key the port
# gained in ROADMAP M9, the 2D ones at the Config's img_size 10
ZOO_PAIRS = (('turboae_2int', 'turboae_2int', 3),
             ('TurboAE_rate3_cnn', 'TurboAE_rate3_cnn_2inter', 3),
             ('TurboAE_rate2_cnn', 'TurboAE_rate2_cnn', 2),
             ('rate2_cnn', 'TurboAE_rate2_cnn', 2),
             ('rate3_cnn', 'rate3_cnn', 3),
             ('TurboAE_rate3_cnn2d', 'TurboAE_rate3_cnn2d', 3),
             ('TurboAE_rate3_cnn2d_dense', 'TurboAE_rate3_cnn2d_dense', 3),
             ('rate3_cnn2d', 'rate3_cnn2d', 3))
ZOO_NUM_BLOCK = 1000                # the cli/main.py epoch: 10 steps at batch 100
ZOO_BATCH = 100
ZOO_EPOCH_LOSS_MAX = 0.69           # the untrained BCE, log 2; fixed before the first card run
# The 2D pair's epoch runs at lr 1e-4: at the Config's 1e-3 its decoder
# epochs diverge past log 2 in the JAX package on the CPU as on the card
# (JAX: 0.8899 then 7.366 in the first two decoder epochs; PERF.md §6)
ZOO_LR = '1e-4'
MOD_POINTS = (-2.0, -1.0, 0.0, 1.0, 2.0)
MOD_REF_BLOCKS = 50000              # the blocks a point of mod_tr2.out's test (RESULTS.md Round 3)
# artifacts/mod_ae.msgpack's last leg (artifacts/mod_tr2.out, epochs
# 141-400): every lr 1e-4, batch 500, 10,000 blocks an epoch of each phase;
# resumed here at 5,000 blocks a phase-epoch (a depth cut, to keep the
# script near 5 minutes once the data-parallel phases came in)
MOD_RECIPE = dict(enc_lr=1e-4, dec_lr=1e-4, mod_lr=1e-4, demod_lr=1e-4, batch_size=500,
                  num_block=5000)
# Each phase's epoch loss after one resumed epoch of that recipe must lie
# below this; fixed before the first card run: the log's epochs 397-400
# give 0.00114-0.00121 (enc), 0.0090-0.0096 (dec), 0.0087-0.0090 (mod),
# 0.0089-0.0098 (demod).
MOD_LOSS_MAX = 0.02
MOD_CLI_NUM_BLOCK = 1000            # the cli/main_modulation.py run: 2 steps an epoch
VBL_LOW, VBL_HIGH = 10, 200
VBL_BUCKETS = [10, 37, 64, 91, 118, 145, 172, 199]   # np.linspace(10, 199, 8)
VBL_NUM_BLOCK = 5000                # the cli/main.py epoch: 10 steps a phase-epoch at batch 500
VBL_BATCH = 500
VBL_LOSS_MAX = 0.69                 # the untrained BCE, log 2; fixed before the first card run
GRAPH_N = 6                         # steps_per_call: optimizer steps a graph replay
SELECT_BLOCKS = 4000                # blocks a point of the two rankings
FAMILY_NUM_BLOCK = 1000             # train_family's epoch: 2 steps a phase-epoch at batch 500
# the classical device decoders (ROADMAP M15): Turbo-757 and Turbo-LTE at
# K=100, 6 iterations, hazzys; the Gallager (96, 48) LDPC code; [7,5] Viterbi
CLASSICAL_B, CLASSICAL_L, CLASSICAL_ITERS = 2000, 100, 6
CLASSICAL_CPU_ROWS = 256      # the blocks of a card batch that the CPU decodes again
CLASSICAL_PARITY_SNR = -1.0
# f32 turbo LLRs, card against CPU, absolute. Tier-1 holds the CPU to JAX by
# 2e-4 at B <= 8, L <= 40; over B=2000 blocks of L=100 six iterations of
# extrinsic exchange amplify the two devices' f32 rounding (exp, log, the
# order of a sum) on a few blocks, most in the standard variant, so the
# LLRs are held to 1e-2 and the decisions exactly, wherever |LLR| > 1e-3
CLASSICAL_LLR_TOL = 1e-2
CLASSICAL_NEAR_ZERO = 1e-3
# f32 BP output LLRs, absolute: MSA's arithmetic is exact up to its sums,
# which the decoder takes in one order on every device, so its bits and
# LLRs are held on every frame. SPA's check update takes atanh of a product
# of tanh values clipped at 0.9999999, where one ulp of the product moves a
# message by up to ~1
# (tests/test_torch_classical_decoders.py::test_spa_check_update_is_ill_conditioned_at_its_clip),
# and the card's tanh is not the CPU's: SPA is held by its bits on the
# frames that satisfy the parity on both devices and by its frame errors.
LDPC_LLR_TOL = 1e-4
CURVE_BLOCKS = 20000          # blocks a point of the K=100 curve, one batch
K100_POINTS = (-1.5, -1.0, -0.5, 0.0)
K1000_BLOCKS = 4000           # the K=1000 point, one batch
# JAX's make_jax_ldpc_decoder on the CPU at Eb/N0 2.5 dB, SPA, 100
# iterations, seed 0, 8 batches of 1,000 frames, through its CLI:
#   python -m turboae_tpu.cli.ldpc_benchmark -design
#     turboae_tpu/classical/designs/96.33.964.txt -ebn0_start 2.5 -points 1
#     -batch 1000 -max_frames 8000 -target_frame_errors 100000 -engine jax
LDPC_REF = (708, 8000)        # frame errors, frames
LDPC_COMMPY_FER = 0.1         # what the reference's commpy test expects there (tests/test_ldpc.py)
LDPC_FRAMES, LDPC_BATCH = 20000, 2000
VITERBI_BLOCKS = 20000
# data parallelism (ROADMAP M16): two gloo ranks share the card (NCCL refuses
# two ranks on one card); the flagship's global batch splits 250 + 250
DIST_RANKS = 2
DIST_BATCH = 500
DIST_TIMED_STEPS = 5
DIST_SWEEP_BLOCKS = 2000     # one global batch of SWEEP_BATCH
# a bf16 decision this close to 0.5 may flip with an f32 sum's order: the
# power constraint's global statistics, reordered, can move a code across a
# bf16 rounding, which the bf16 decoder carries to ~1e-2 of its output
# (KERNEL_REL_TOL); the f32 tests hold such decisions at 1e-5
DIST_NEAR = 1e-2
# the gradients of two ranks against one process on the same card, relative
# to each leaf's largest: the same arithmetic summed in another order (the
# port against JAX on the CPU is held to 1e-4, tests/test_torch_train.py)
DIST_GRAD_TOL = 1e-4
WORKER_TIMEOUT = 240         # seconds a spawned rank may take
# the K=1000 flagship (ROADMAP M16b): its curve, and its time-sharded step
K1000_POINTS = (0.0, 0.5)    # eval_k1000.json: BLER 0.2714 and 0.10429 there
TIME_RANKS = 2
TIME_BATCH = 32              # global batch of the time-sharded K=1000 steps
TIME_TIMED_STEPS = 3
MESH_2D = (2, 2)             # ('data', 'model'): four gloo ranks, two replicas a share
# the C++ oracle (ROADMAP M15b)
NATIVE_B = 200
NATIVE_CURVE_BLOCKS = 10000
# the examples phase: DeepTurbo's depth cut (1 epoch of 5 x 5 decoder steps at
# batch 200 from a seeded init, a 5-batch test), and the bound of its last
# phase-epoch's loss: the untrained BCE, log 2, fixed before the first card run
EXAMPLE_DEEPTURBO_CUT = ['-num_epoch', '1', '-num_block', '1000']
EXAMPLE_DEEPTURBO_LOSS_MAX = 0.69
# the bf16 curves of the flagship's architecture that K2 carries (12 stacks a
# batch), at SWEEP_POINTS, with the flags tests/test_torch_curves_{awgn,channels}.py pass
OWED_CURVES = (
    ('atn_curve', 'flagship_atn.msgpack', 'eval_atn.json', ['--channel', 't-dist', '--vv', '3']),
    ('radar_curve', 'flagship_radar.msgpack', 'eval_radar.json', ['--channel', 'radar']),
    ('binary_curve', 'flagship_binary.msgpack', 'eval_binary.json',
     ['--test_channel_mode', 'block_norm_ste']))


def emit(phase: str, **fields):
    """One JSON line; `elapsed_s` is the script's wall time so far, which
    gives each phase's share of the run."""
    print(json.dumps({'phase': phase, **fields,
                      'elapsed_s': time.perf_counter() - STARTED}), flush=True)


def check(cond: bool, msg: str):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of fn() over `iters` back-to-back calls, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script needs an '
              'NVIDIA GPU', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from turboae_tpu_torch.cli.eval_flagship import load_flagship
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.kernels import conv_stack as ks
    from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms
    from turboae_tpu_torch.train.sweep import params_to, sweep
    from turboae_tpu_torch.utils.device import no_tf32, nvidia_smi
    from turboae_tpu_torch.utils.metrics import snr_db2sigma, two_proportion_z

    # f32 references in full f32: no TF32 in matmuls or cuDNN convolutions
    no_tf32()
    dev = torch.device('cuda', 0)

    # ---- device ----
    smi = nvidia_smi()
    check(not smi.startswith('nvidia-smi failed'), smi)
    kind = torch.cuda.get_device_name(0)
    emit('device', nvidia_smi=smi, torch_name=kind, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda, python=sys.version.split()[0])

    # ---- build ----
    build_phase()

    # ---- kernel_check: each kernel against its plain version on the card ----
    crown = load_flagship(os.path.join(ROOT, 'artifacts', 'flagship.msgpack'), dev)
    gen = torch.Generator().manual_seed(0)
    max_abs = kernel_check_phase(crown, gen, dev)

    # ---- forward: the crown on the card against the port on the CPU ----
    crown_cpu = params_to(crown, 'cpu')
    bits = (torch.rand((64, 100, 1), generator=gen) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((64, 100, 3), generator=gen)
    outs = {}
    for dtype, fused in (('float32', False), ('bfloat16', True)):
        cfg = Config(dtype=dtype, use_fused_conv=fused)
        with torch.inference_mode():
            g_out = forward_ae(crown, cfg, bits.to(dev), noise.to(dev), make_perms(cfg, dev),
                               training=False)[0].cpu()
            c_out = forward_ae(crown_cpu, cfg, bits, noise, make_perms(cfg, 'cpu'),
                               training=False)[0]
        check(g_out.shape == (64, 100, 1) and bool(torch.isfinite(g_out).all()),
              f'{dtype} forward: shape or non-finite values')
        outs[dtype] = {'max_abs_diff': (g_out - c_out).abs().max().item(),
                       'decision_agreement': (g_out.round() == c_out.round()).float().mean().item()}
    emit('forward', batch=64, snr_db=0.0, **outs)
    # f32: same arithmetic on both sides up to summation order
    check(outs['float32']['max_abs_diff'] < 1e-4, 'f32 forward differs from the CPU')
    # bf16 fused: kernel on the card, plain version on the CPU; roundings to
    # bf16 may differ by one ulp and move a probability near 0.5 across it
    check(outs['bfloat16']['decision_agreement'] > 0.99, 'bf16 fused decisions differ')

    # ---- crown_sweep: main path 1 ----
    with open(os.path.join(ROOT, 'artifacts', 'eval_crown_r4.json')) as f:
        ref = json.load(f)
    cfg = Config(batch_size=SWEEP_BATCH, dtype='bfloat16', use_fused_conv=True)
    sweep_gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = sweep(crown, cfg, list(SWEEP_POINTS), num_block=SWEEP_BLOCKS, device=dev,
                generator=sweep_gen)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    paths = {'crown_sweep': read_counts()}
    n_batches = SWEEP_BLOCKS // SWEEP_BATCH
    points = []
    for i, snr in enumerate(SWEEP_POINTS):
        j = ref['snr'].index(snr)
        z = two_proportion_z(res['blk_errors'][i], res['n_blocks'],
                             ref['blk_errors'][j], ref['n_blocks'][j])
        points.append({'snr': snr, 'blk_errors': res['blk_errors'][i],
                       'bit_errors': res['bit_errors'][i], 'n_blocks': res['n_blocks'],
                       'bler': res['bler'][i], 'ber': res['ber'][i],
                       'ref_bler': ref['bler'][j], 'ref_ber': ref['ber'][j], 'z_bler': z})
    blocks_per_s = res['n_blocks'] * len(SWEEP_POINTS) / sweep_s
    expected = 12 * n_batches * len(SWEEP_POINTS)
    emit('crown_sweep', points=points, launches=paths['crown_sweep'],
         expected_launches=expected, seconds=sweep_s, blocks_per_s=blocks_per_s)
    check(paths['crown_sweep']['conv_stack_bf16'] == expected,
          f"conv_stack_bf16 launched {paths['crown_sweep']['conv_stack_bf16']} times in the sweep")
    for p in points:
        check(abs(p['z_bler']) < MAX_Z, f"BLER at {p['snr']} dB: z = {p['z_bler']}")

    # ---- train_step: f32 steps on the card against the CPU ----
    train_step_parity(crown, crown_cpu, dev, gen)

    # ---- train: main path 2, one epoch of the flagship recipe ----
    paths['train'] = train_epoch_phase(
        Config(batch_size=TRAIN_BATCH, num_block=TRAIN_NUM_BLOCK, dtype='bfloat16',
               use_fused_conv=True), dev)

    # ---- channels: every sampler on the card, from a CUDA generator ----
    channels_phase(dev)

    # ---- fading_curve, legacy_curve: paths 3 and 4, the eval CLI ----
    paths['fading_curve'] = curve_phase(
        'fading_curve', dev, 'flagship_fading.msgpack', 'eval_fading.json', ['--channel', 'fading'])
    paths['legacy_curve'] = curve_phase(
        'legacy_curve', dev, 'flagship.msgpack', 'eval_crown_legacy.json', ['--legacy_noise'])

    # ---- test_pass: path 5, Trainer.test with its punctured pass ----
    paths['test_pass'] = test_pass_phase(crown, dev)

    # ---- resume: path 6, a committed run resumed with its Adam state ----
    paths['resume'] = resume_phase(dev, gen)

    # ---- train_times: the port of bench.py, fused on and off ----
    eager_bench = train_times_phase(dev)

    # ---- conv_stack_bench: path 7, the only path of K1 ----
    paths['conv_stack_bench'] = conv_stack_bench_phase(dev)

    # ---- DeepTurbo: its encoder, forward, curve (path 8) and resume (path 9) ----
    deepturbo_encoder_phase(dev)
    deepturbo_forward_phase(dev, gen)
    paths['deepturbo_curve'] = curve_phase(
        'deepturbo_curve', dev, 'deepturbo.msgpack', 'eval_deepturbo.json',
        ['--encoder', 'Turbo_rate3_757'], snrs=DEEPTURBO_POINTS, stacks=0)
    paths['deepturbo_resume'] = resume_phase(
        dev, gen, phase='deepturbo_resume', ckpt='deepturbo.msgpack',
        step_cfg={'encoder': 'Turbo_rate3_757', 'dec_lr': 2e-5}, dec_snr=(-2.5, 2.0),
        recipe=['--encoder', 'Turbo_rate3_757', '--num_train_enc', '0', '--num_train_dec', '6',
                '--dec_lr', '2e-5', '--train_dec_channel_low', '-2.5',
                '--train_dec_channel_high', '2.0'],
        train_enc=0, train_dec=6, dec_loss_max=DEEPTURBO_DEC_LOSS_MAX, stacks=0,
        num_block=DEEPTURBO_RESUME_NUM_BLOCK)

    # ---- losses: path 10, the loss menu and Lookahead ----
    paths['losses'] = losses_phase(dev, gen)

    # ---- the RNN zoo (paths 11) and FTAE (paths 12 and 13) ----
    gru_forward_phase(dev)
    paths['rnn_forward'] = rnn_forward_phase(dev, gen, batch=RNN_FORWARD_BATCH)
    paths['rnn_train'] = rnn_train_phase(dev, gen)
    paths['ftae_curve'] = ftae_curve_phase(dev, 'ftae_curve', 'ftae_pa.msgpack',
                                           'eval_ftae_pa.json', 'pos_phase', refuse='pos')
    paths['ftae_train'] = ftae_train_phase(dev, gen)

    # ---- the CNN zoo (paths 14, 15) and the modulation AE (paths 16-18) ----
    paths['cnn_zoo_forward'] = cnn_zoo_forward_phase(dev, gen)
    paths['cnn_zoo_train'] = cnn_zoo_train_phase(dev, gen)
    paths['mod_curve'] = mod_curve_phase(dev)
    paths['mod_forward'] = mod_forward_phase(dev, gen)
    paths['mod_resume'] = mod_resume_phase(dev)

    # ---- the trainer's extras (paths 19-22), the FLOP count and the training CLIs ----
    paths['vbl_epoch'] = vbl_epoch_phase(dev)
    paths['k_same_code'] = k_same_code_phase(dev)
    paths['norm_stats_test'] = test_pass_phase(crown, dev, phase='norm_stats_test',
                                               precompute_norm_stats=True)
    paths['graph_steps'], graph_bench = graph_steps_phase(dev, eager_bench)
    flops_phase(dev, {**{f'eager_{k}': r for k, r in eager_bench.items()},
                      **{f'graph_{k}': r for k, r in graph_bench.items()}})
    paths['train_clis'] = train_clis_phase(dev)

    # ---- the classical device decoders (paths 24-27): parity, curves, FER ----
    paths['classical_parity'] = classical_parity_phase(dev)
    paths['classical_curve'] = classical_curve_phase(dev)
    paths['ldpc_fer'] = ldpc_fer_phase(dev)
    paths['viterbi_curve'] = viterbi_curve_phase(dev)

    # ---- data parallelism (M16) and the C++ oracle (M15b) ----
    paths['dist_train'] = dist_train_phase(dev)

    # ---- the K=1000 flagship's curve; time-axis sharding and a 2-D mesh (M16b) ----
    with open(os.path.join(ROOT, 'artifacts', 'eval_k1000.json')) as f:
        tpu_rate = json.load(f)['eval_blocks_per_s']
    paths['k1000_curve'] = curve_phase(
        'k1000_curve', dev, 'flagship_k1000.msgpack', 'eval_k1000.json',
        ['--block_len', '1000'], snrs=K1000_POINTS,
        tpu_blocks_per_s_of_eval_k1000_json=tpu_rate)
    sharded = start_sharded()             # their ranks start while this process works
    try:
        paths['time_shard'] = time_shard_phase(dev, sharded['time_shard'])
        paths['mesh_2d'] = mesh_2d_phase(dev, sharded['mesh_2d'])
    except BaseException:
        for procs, _, _ in sharded.values():
            for proc in procs:
                stop(proc)
        raise
    dist_cli = start_dist_cli()           # its own processes, while native_parity runs here
    try:
        paths['native_parity'] = native_parity_phase(dev)
    except BaseException:
        stop(dist_cli[0])
        raise
    paths['dist_cli'] = dist_cli_phase(dist_cli)

    # ---- the five examples/torch_*.py, each through its main (path 37) ----
    paths['examples'] = examples_phase(dev)

    # ---- times: each kernel, its plain version, a library yardstick, its bound ----
    sweep_layers = crown['dec']['iters'][0]['dec1_cnn']
    times = {
        ('conv_stack_bf16', 'sweep'): time_kernel(ks.conv_stack_bf16, ks.conv_stack_bf16_plain,
                                                  torch.bfloat16, MAIN_SHAPE, sweep_layers, gen, dev),
        ('conv_stack_bf16', 'train'): time_kernel(ks.conv_stack_bf16, ks.conv_stack_bf16_plain,
                                                  torch.bfloat16, BENCH_SHAPE, sweep_layers, gen, dev),
        ('conv_stack_f32', 'bench'): time_kernel(ks.conv_stack_f32, ks.conv_stack_f32_plain,
                                                 torch.float32, BENCH_SHAPE, None, gen, dev),
    }
    for (kname, at), t in times.items():
        emit('times', kernel=kname, at=at, **t, card=smi)

    # ---- the ATN, radar and binary curves (paths 34-36), through K2 ----
    for phase, ckpt, ref_name, flags in OWED_CURVES:
        paths[phase] = curve_phase(phase, dev, ckpt, ref_name, flags)
    # ---- ftae.msgpack's curve (path 38): uniform power, so no 'pw' leaf ----
    paths['ftae_uniform_curve'] = ftae_curve_phase(dev, 'ftae_uniform_curve', 'ftae.msgpack',
                                                   'eval_ftae.json', 'none', refuse='pos')

    # ---- summary ----
    print(smi, flush=True)
    summary = []
    for kname, at, src, line in (('conv_stack_bf16', 'sweep', 'conv_stack_bf16.cu', 250),
                                 ('conv_stack_f32', 'bench', 'conv_stack_f32.cu', 137)):
        t = times[(kname, at)]
        # every path, zeros included: DeepTurbo's dense stacks never launch K2
        by_path = {p: c[kname] for p, c in paths.items()}
        summary.append({
            'name': kname, 'route': 'cuda',
            'source': f'turboae_tpu_torch/kernels/csrc/{src}',
            'replaces': f'turboae_tpu/kernels/conv_stack.py:{line}',
            'launches': sum(by_path.values()), 'launches_by_path': by_path,
            'max_abs_err': max_abs[kname], 'ms': t['ms'], 'plain_ms': t['plain_ms'],
            'bound_ms': t['bound_ms'], 'bound_by': t['bound_by'],
            'library_ms': t['library_ms'], 'shape': t['shape']})
    print(json.dumps({'kernels': summary}), flush=True)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                             'count': torch.cuda.device_count()}}), flush=True)
    return 0


def build_phase():
    """Builds every CUDA source in parallel and reads, per kernel, ptxas's
    registers, shared memory, spills and warnings and the SASS's HMMA
    (mma.sync) and HGMMA (wgmma) counts. Every kernel of both must run on
    wgmma (HGMMA > 0); none may spill."""
    from turboae_tpu_torch.kernels import build
    from turboae_tpu_torch.kernels import conv_stack as ks
    t0 = time.perf_counter()
    built = build.build(list(ks.LIBRARIES))
    libraries = {}
    for name, lib in built.items():
        ptxas = build.ptxas_report(lib.log)
        tensor_core = build.tensor_core_counts(build.sass(lib.path))
        libraries[name] = {'seconds': lib.seconds, 'cached': lib.seconds == 0.0,
                           'kernels': {k: {**ptxas.get(k, {}), **n} for k, n in tensor_core.items()},
                           'warnings': [ln.strip() for ln in lib.log.splitlines()
                                        if 'warning' in ln.lower()]}
    emit('build', seconds=time.perf_counter() - t0, libraries=libraries)
    for name, lib in libraries.items():
        found = lib['kernels']
        check(bool(found), f'{name}: no kernel in its SASS')
        check(all(v['hgmma'] > 0 for v in found.values()),
              f'{name} has a kernel with no HGMMA (wgmma) in its SASS')
        check(all('spill_stores' in v and v['spill_stores'] == v['spill_loads'] == 0
                  for v in found.values()), f'ptxas reports spills (or nothing) for {name}')
    return libraries


def kernel_check_phase(crown, gen, dev):
    """Each kernel against its plain version on the card at its paths'
    shapes and at edge shapes; returns each kernel's largest absolute error."""
    from turboae_tpu_torch.kernels import conv_stack as ks
    from turboae_tpu_torch.ops.conv1d import stack_init
    edge = [('one_layer', (2000, 100, 7, 100, 5, 1)), ('two_layers', (500, 100, 7, 100, 5, 2)),
            ('k1', (256, 100, 7, 100, 1, 3)), ('odd_b', (333, 100, 7, 100, 5, 5)),
            ('ragged', (5, 23, 3, 30, 3, 2)), ('long_block_l1000', (16, 1000, 7, 100, 5, 5))]
    # the tensor-core block layout of both kernels: odd C, one and several
    # column groups of warps, a last block that holds one of its three rows
    block_edge = [('odd_c', (500, 100, 7, 25, 5, 5)), ('c128', (500, 100, 7, 128, 5, 5)),
                  ('c256', (500, 100, 7, 256, 5, 5)), ('partial_block', (334, 100, 7, 100, 5, 5))]
    # K2's plan at B=1001: 396 blocks (three rounds of 132) of 2 or 3 rows,
    # so blocks of 2 rows leave their fourth m64 tile partly filled and their
    # fifth warpgroup without a product
    k2_edge = [('partial_rows_b1001', (1001, 100, 7, 100, 5, 5)),
               ('c300_two_groups', (500, 40, 7, 300, 5, 5))]   # two column groups of n256
    # the bucket lengths of a variable-block-length epoch, the crown's stack
    vbl = [(f'vbl_l{L}', (VBL_BATCH, L, 7, 100, 5, 5), crown['dec']['iters'][0]['dec1_cnn'])
           for L in VBL_BUCKETS]
    kernels = {  # name: (wrapper, plain, tolerance, cases)
        'conv_stack_bf16': (ks.conv_stack_bf16, ks.conv_stack_bf16_plain, KERNEL_REL_TOL,
                            [('main_path', MAIN_SHAPE, crown['dec']['iters'][0]['dec1_cnn'])]
                            + [(n, sh, None) for n, sh in edge + block_edge + k2_edge
                               if n != 'two_layers']
                            + vbl),
        'conv_stack_f32': (ks.conv_stack_f32, ks.conv_stack_f32_plain, F32_REL_TOL,
                           [('bench', BENCH_SHAPE, None)]
                           + [(n, sh, None) for n, sh in edge + block_edge]),
    }
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    max_abs = {}
    for kname, (wrapper, plain, tol, cases) in kernels.items():
        for name, (B, L, cin, c, k, nl), layers in cases:
            layers = layers or stack_init(gen, nl, cin, c, k, dev)
            x = torch.randn((B, L, cin), generator=gen).to(dev)
            before = wrapper.launches
            got = wrapper(layers, x)
            ref = plain(layers, x)
            torch.cuda.synchronize()
            check(wrapper.launches == before + 1, f'{kname} {name}: not one launch')
            check(got.shape == (B, L, c) and got.dtype == ref.dtype, f'{kname} {name}: shape/dtype')
            check(bool(torch.isfinite(got.float()).all()), f'{kname} {name}: non-finite output')
            err = (got.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            if kname == 'conv_stack_bf16':
                kp, shown = ks.k2_plan(B, L, cin, c, k, nl, n_sm), ('R', 'G', 'nc', 'N')
                windowed = {'windowed_rows': ks.k2_max_rows(cin, c, k, nl)}
            else:
                kp, shown = ks.k1_plan(B, L, cin, c, k, nl, n_sm), ('R', 'nc', 'tpw', 'N')
                windowed = {'windowed_rows': ks.k1_max_rows(cin, c, k, nl)}
            plan = {'plan': {f: getattr(kp, f) for f in shown + ('ngroups', 'stages', 'smem')}
                    if kp else windowed}
            emit('kernel_check', kernel=kname, case=name, shape=[B, L, cin, c, k, nl],
                 max_abs_err=err, max_rel_err=rel, tol=tol, **plan)
            check(rel < tol, f'{kname} {name}: relative error {rel} >= {tol}')
            max_abs[kname] = max(max_abs.get(kname, 0.0), err)
    return max_abs


def train_epoch_phase(cfg, dev):
    """One epoch of the alternating recipe from a seeded init, then validate;
    returns the kernels' launch counts of the run."""
    from turboae_tpu_torch.train.trainer import Trainer
    trainer = Trainer(cfg, dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    enc_losses = [trainer.train_epoch(0, 'encoder', verbose=False)
                  for _ in range(cfg.num_train_enc)]
    dec_losses = [trainer.train_epoch(0, 'decoder', verbose=False)
                  for _ in range(cfg.num_train_dec)]
    train_s = time.perf_counter() - t0
    val_bce, val_ber = trainer.validate(verbose=False)
    sync(dev)
    counts = read_counts()
    steps_per_epoch = max(1, cfg.num_block // cfg.batch_size)
    n_steps = steps_per_epoch * (cfg.num_train_enc + cfg.num_train_dec)
    forwards = n_steps + max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio))
    emit('train', enc_losses=enc_losses, dec_losses=dec_losses, dec_loss=dec_losses[-1],
         dec_loss_max=DEC_LOSS_MAX, val_bce=val_bce, val_ber=val_ber, steps=n_steps,
         forwards=forwards, launches=counts, expected_launches=12 * forwards,
         train_seconds=train_s, train_blocks_per_s=n_steps * cfg.batch_size / train_s)
    check(all(math.isfinite(v) for v in enc_losses + dec_losses + [val_bce, val_ber]),
          'a training loss is not finite')
    check(counts['conv_stack_bf16'] == 12 * forwards,
          f"conv_stack_bf16 launched {counts['conv_stack_bf16']} times, "
          f'expected 12 x {forwards} forwards')
    check(dec_losses[-1] < DEC_LOSS_MAX, f'decoder loss {dec_losses[-1]} >= {DEC_LOSS_MAX}')
    return counts


def channels_phase(dev):
    """Each channel's statistic of tests/test_torch_channels.py, with its
    bound, from 1e7 draws of a CUDA generator."""
    from turboae_tpu_torch.channels import apply as ap
    from turboae_tpu_torch.channels import noise as nz
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (CHANNEL_SAMPLES // 300, 100, 3)
    chain = (CHANNEL_SAMPLES // 500, 500, 1)

    def sample(sigma, shp=shape, **spec):
        out = nz.sample_noise(shp, nz.NoiseSpec(**spec), sigma, g, dev)
        check(out.device == dev and out.shape == shp, f'{spec}: device or shape')
        return out

    stats = {}
    stats['awgn_std'] = (sample(0.5, channel='awgn').std().item(), 0.5, 0.01)
    ts = nz.train_sigma(shape, -1.5, 2.0, g, dev)
    stats['train_sigma_min'] = (ts.min().item(), snr_db2sigma(2.0), 1e-6)
    stats['train_sigma_max'] = (ts.max().item(), snr_db2sigma(-1.5), 1e-6)
    stats['t_dist_std'] = (sample(1.0, channel='t-dist', vv=5.0).std().item(), 1.0, 0.05)
    radar = sample(0.1, channel='radar', radar_prob=0.05, radar_power=10.0)
    stats['radar_burst_share'] = ((radar.abs() > 1.0).float().mean().item(), 0.05, 0.03)
    stats['bsc_keep'] = (sample(0.1, channel='bsc').mean().item(), 0.9, 0.01)
    ge_awgn = nz.generate_noise(shape, Config(channel='ge_awgn'), g, dev, test_sigma=0.0)
    lo, hi = snr_db2sigma(1.0), snr_db2sigma(-1.0)
    stats['ge_awgn_std'] = (ge_awgn.std().item(), (lo + hi) / 2, (hi - lo) / 2)
    ge = sample(0.0, chain, channel='ge')[:, :, 0]
    stats['ge_keep'] = (ge.mean().item(), 0.8, 0.03)
    stats['ge_agree'] = ((ge[:, :-1] == ge[:, 1:]).float().mean().item(), 0.68, 0.04)
    h = ap.apply_channel(torch.ones(shape, device=dev), torch.zeros(shape, device=dev),
                         'fading', g)
    stats['fading_gain_mean'] = (h.mean().item(), math.sqrt(math.pi / 2) / math.sqrt(3.14 / 2), 0.01)
    stats['fading_gain_m2'] = ((h ** 2).mean().item(), 2.0 / (3.14 / 2), 0.02)
    emit('channels', samples=CHANNEL_SAMPLES, generator=str(g.device),
         stats={k: {'got': v, 'want': w, 'tol': t} for k, (v, w, t) in stats.items()})
    for k, (v, w, t) in stats.items():
        check(abs(v - w) <= t, f'channels {k}: {v} against {w} +- {t}')


def curve_phase(phase, dev, ckpt, ref_name, flags, snrs=SWEEP_POINTS, stacks=12, **fields):
    """Evenly spaced points of a committed curve through
    cli/eval_flagship.evaluate at the sweep's settings, `stacks` K2 launches
    a batch; returns the kernels' launch counts of the run. `fields` go into
    the phase's line."""
    from turboae_tpu_torch.cli import eval_flagship
    from turboae_tpu_torch.train import sweep as sweep_mod
    from turboae_tpu_torch.utils.device import nvidia_smi
    args = eval_flagship.parse([
        '--ckpt', os.path.join(ROOT, 'artifacts', ckpt), '--device', str(dev),
        '--batch_size', str(SWEEP_BATCH), '--num_block', str(SWEEP_BLOCKS),
        '--snr_points', str(len(snrs)), '--snr_test_start', str(snrs[0]),
        '--snr_test_end', str(snrs[-1]), '--dtype', 'bfloat16',
        '--ref', os.path.join(ROOT, 'artifacts', ref_name), *flags])
    draws = []
    inner = sweep_mod.sample_noise

    def counted(*a, **kw):
        draws.append(1)
        return inner(*a, **kw)
    sweep_mod.sample_noise = counted
    try:
        sync(dev)
        reset_counts()
        out = eval_flagship.evaluate(args)
        sync(dev)
        counts = read_counts()
    finally:
        sweep_mod.sample_noise = inner
    n_batches = SWEEP_BLOCKS // SWEEP_BATCH
    expected = stacks * n_batches * len(snrs)
    with open(args.ref) as f:
        ref = json.load(f)
    points = [{'snr': s, 'blk_errors': out['blk_errors'][i], 'n_blocks': out['n_blocks'][i],
               'bler': out['bler'][i], 'ber': out['ber'][i],
               'ref_bler': ref['bler'][ref['snr'].index(s)], 'z_bler': out['z_bler_vs_ref'][i]}
              for i, s in enumerate(out['snr'])]
    emit(phase, ckpt=ckpt, flags=flags, points=points, legacy_noise=out['legacy_noise'],
         z_n=LEGACY_N if out['legacy_noise'] else 'n_blocks', noise_draws=len(draws),
         launches=counts, expected_launches=expected, blocks_per_s=out['eval_blocks_per_s'],
         device=out['device'], card=nvidia_smi(), **fields)
    check(out['snr'] == list(snrs), f'{phase}: points {out["snr"]}')
    check(counts['conv_stack_bf16'] == expected,
          f"{phase}: conv_stack_bf16 launched {counts['conv_stack_bf16']} times, not {expected}")
    if out['legacy_noise']:
        check(len(draws) == 1, f'{phase}: the sweep drew its noise {len(draws)} times')
    for p in points:
        check(abs(p['z_bler']) < MAX_Z, f"{phase}: BLER at {p['snr']} dB: z = {p['z_bler']}")
    return counts


def test_pass_phase(crown, dev, phase='test_pass', precompute_norm_stats=False):
    """Trainer.test on the crown: both passes at -1 and 0 dB; the main pass
    held to the crown's counts, the encoder power to block_norm's 1. With
    precompute_norm_stats the stats of the precompute pass are threaded
    through every batch of both passes."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    cfg = Config(batch_size=SWEEP_BATCH, num_block=TEST_PASS_BLOCKS, dtype='bfloat16',
                 use_fused_conv=True, snr_points=len(SWEEP_POINTS),
                 snr_test_start=SWEEP_POINTS[0], snr_test_end=SWEEP_POINTS[-1],
                 precompute_norm_stats=precompute_norm_stats)
    trainer = Trainer(cfg, dev, params=crown)
    with open(os.path.join(ROOT, 'artifacts', 'eval_crown_r4.json')) as f:
        ref = json.load(f)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    snrs, ber, bler = trainer.test(verbose=True)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    n = TEST_PASS_BLOCKS // SWEEP_BATCH * SWEEP_BATCH
    z = [two_proportion_z(b * n, n, ref['blk_errors'][ref['snr'].index(s)],
                          ref['n_blocks'][ref['snr'].index(s)]) for s, b in zip(snrs, bler)]
    rep = trainer.last_test
    expected = 12 * 2 * (TEST_PASS_BLOCKS // SWEEP_BATCH) * len(SWEEP_POINTS)
    decoded = 2 * n * len(SWEEP_POINTS)
    stats = trainer.norm_stats
    emit(phase, snrs=snrs, ber=ber, bler=bler, z_bler=z, ber_punc=rep['ber_punc'],
         bler_punc=rep['bler_punc'], encoder_power=rep['encoder_power'], blocks=n,
         norm_stats=None if stats is None else {k: float(v) for k, v in stats._asdict().items()},
         launches=counts, expected_launches=expected, seconds=seconds,
         decoded_blocks_per_s=decoded / seconds)
    check(counts['conv_stack_bf16'] == expected,
          f"{phase}: conv_stack_bf16 launched {counts['conv_stack_bf16']} times, not {expected}")
    check(all(abs(v) < MAX_Z for v in z), f'{phase}: BLER z {z}')
    check(abs(rep['encoder_power'] - 1.0) < 1e-2, f"encoder power {rep['encoder_power']}")
    check((stats is not None) == precompute_norm_stats, f'{phase}: norm stats {stats}')
    return counts


FADING_RECIPE = ['--channel', 'fading', '--train_enc_channel_low', '0.5',
                 '--train_enc_channel_high', '0.5', '--train_dec_channel_low', '-2.5',
                 '--train_dec_channel_high', '2.5', '--enc_lr', '5e-5', '--dec_lr', '5e-5']


def resume_phase(dev, gen, phase='resume', ckpt='flagship_fading.msgpack',
                 step_cfg=(('channel', 'fading'),), dec_snr=(-2.5, 2.5), recipe=FADING_RECIPE,
                 train_enc=1, train_dec=5, dec_loss_max=RESUME_DEC_LOSS_MAX, stacks=12,
                 num_block=RESUME_NUM_BLOCK):
    """A committed run resumed on the card: a step's parity with the CPU,
    then one epoch of the recipe through the training CLI (`stacks` K2
    launches a forward); returns the kernels' launch counts of the epoch."""
    import tempfile
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.cli import train_flagship
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.msgpack_io import load_msgpack
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.device import nvidia_smi
    path = os.path.join(ROOT, 'artifacts', ckpt)
    saved = load_msgpack(path)
    counts0 = {h: int(saved['opt_state'][h]['0']['count']) for h in ('enc', 'dec')}

    # one f32 decoder step from the file's params and Adam state, the same
    # host-drawn batch on both sides and the fading gain from two CPU
    # generators of one seed
    batch = PARITY_BATCH
    bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
    noise = train_sigma((batch, 100, 3), *dec_snr, gen, 'cpu') * torch.randn((batch, 100, 3),
                                                                          generator=gen)
    cfg = Config(batch_size=batch, **dict(step_cfg))
    side = {}
    for where in ('gpu', 'cpu'):
        tr = Trainer(cfg, dev if where == 'gpu' else 'cpu')
        tr.params, tr.opt_state, step = load_checkpoint(path, tr.params, tr.opt_state)
        tr.generator = torch.Generator().manual_seed(11)
        loss = tr._train_step('decoder', bits.to(tr.device), noise.to(tr.device)).item()
        side[where] = (loss, tr.opt['dec'].count, tr.opt['enc'].count,
                       [p.cpu() for p in tr._leaves['dec']])
    (lg, cg, eg, pg), (lc, cc, ec, pc) = side['gpu'], side['cpu']
    loss_rel = abs(lg - lc) / abs(lc)
    dp = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(pg, pc))

    # one epoch of the recipe through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        out_ckpt = os.path.join(tmp, 'resumed.msgpack')
        metrics = os.path.join(tmp, 'metrics.jsonl')
        argv = ['--resume', path, *recipe,
                '--dtype', 'bfloat16', '--use_fused_conv', '--num_block', str(num_block),
                '--batch_size', str(RESUME_BATCH), '--epochs', str(step + 1), '--val_every', '1',
                '--ckpt', out_ckpt, '--metrics', metrics, '--device', str(dev)]
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        trainer = train_flagship.main(argv)
        sync(dev)
        seconds = time.perf_counter() - t0
        counts = read_counts()
        after = load_msgpack(out_ckpt)
        with open(metrics) as f:
            records = [json.loads(line) for line in f]
    epoch = [r for r in records if r['event'] == 'epoch']
    steps = num_block // RESUME_BATCH
    grew = {h: int(after['opt_state'][h]['0']['count']) - counts0[h] for h in ('enc', 'dec')}
    # the epoch's training forwards, the validation's steps and the final
    # test's two passes over 12 points
    forwards = (train_enc + train_dec + 1) * steps + \
        2 * 12 * (min(10000, num_block) // RESUME_BATCH)
    emit(phase, step_loss_gpu=lg, step_loss_cpu=lc, step_loss_rel=loss_rel,
         step_param_diff_rel=dp, step_counts={'gpu': [eg, cg], 'cpu': [ec, cc]},
         file_step=step, file_counts=counts0, saved_step=after['step'], counts_grew=grew,
         epoch=epoch, dec_loss=epoch[-1]['dec_loss'] if epoch else None,
         dec_loss_max=dec_loss_max, launches=counts, expected_launches=stacks * forwards,
         seconds=seconds, train_blocks_per_s=num_block * (train_enc + train_dec)
         / epoch[-1]['seconds'] if epoch else None,
         test_bler=trainer.last_test['bler'], card=nvidia_smi())
    check(loss_rel < 1e-4, f'{phase} step: loss differs from the CPU by {loss_rel}')
    check(cg == cc == counts0['dec'] + 1 and eg == ec == counts0['enc'],
          f'{phase} step: the Adam counts did not carry on')
    check(dp < 1e-3, f'{phase} step: updated params differ from the CPU by {dp}')
    check(len(epoch) == 1 and epoch[0]['epoch'] == step + 1 and after['step'] == step + 1,
          f'{phase}: the epoch counter did not carry on')
    check(any(r['event'] == 'validate' for r in records), f'{phase}: no validation')
    check(grew == {'enc': train_enc * steps, 'dec': train_dec * steps},
          f'{phase}: Adam counts grew by {grew}')
    check(math.isfinite(epoch[0]['dec_loss']) and epoch[0]['dec_loss'] < dec_loss_max,
          f"{phase}: decoder loss {epoch[0]['dec_loss']} >= {dec_loss_max}")
    check(counts['conv_stack_bf16'] == stacks * forwards,
          f"{phase}: conv_stack_bf16 launched {counts['conv_stack_bf16']} times, "
          f'not {stacks} x {forwards}')
    return counts


def deepturbo_encoder_phase(dev):
    """The turbo encoder on the card against the same function on the CPU,
    bit for bit, for both trellises at B=2000 and L=100, 1000; the card's
    ms per call at L=100 (a loop of 2 x L steps of table gathers)."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import make_perms
    from turboae_tpu_torch.models.deepturbo import turbo_enc_apply
    from turboae_tpu_torch.utils.device import nvidia_smi
    g = torch.Generator().manual_seed(5)
    cases = []
    for encoder in ('Turbo_rate3_757', 'Turbo_rate3_lte'):
        for L in (100, 1000):
            cfg = Config(encoder=encoder, block_len=L)
            bits = (torch.rand((SWEEP_BATCH, L, 1), generator=g) < 0.5).float()
            ref, _ = turbo_enc_apply({}, cfg, bits, make_perms(cfg, 'cpu'))
            bits_d, perms_d = bits.to(dev), make_perms(cfg, dev)
            got, _ = turbo_enc_apply({}, cfg, bits_d, perms_d)
            got = got.cpu()
            case = {'encoder': encoder, 'B': SWEEP_BATCH, 'L': L,
                    'equal': bool(torch.equal(got, ref)),
                    'mismatches': int((got != ref).sum())}
            if L == 100:
                case['ms'] = cuda_ms(lambda: turbo_enc_apply({}, cfg, bits_d, perms_d), iters=20)
            cases.append(case)
    emit('deepturbo_encoder', cases=cases, card=nvidia_smi())
    for c in cases:
        check(c['equal'], f"turbo encoder {c['encoder']} L={c['L']}: {c['mismatches']} "
                          'code bits differ between the card and the CPU')


def deepturbo_forward_phase(dev, gen, batch=PARITY_BATCH):
    """artifacts/deepturbo.msgpack through train/checkpoint.py: the f32
    forward on the card against the CPU on the same host-drawn bits and
    noise (0 dB), within 1e-4; bf16 decisions reported."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.sweep import params_to
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    path = os.path.join(ROOT, 'artifacts', 'deepturbo.msgpack')
    cfg = Config(encoder='Turbo_rate3_757')
    params = load_checkpoint(path, init_ae(torch.Generator().manual_seed(0), cfg, dev))
    check(params['enc'] == {} and len(params['dec']['iters']) == 6, 'deepturbo: the params')
    params_cpu = params_to(params, 'cpu')
    bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((batch, 100, 3), generator=gen)
    outs = {}
    for dtype in ('float32', 'bfloat16'):
        c = cfg.replace(dtype=dtype)
        with torch.inference_mode():
            g_out, g_codes, _ = forward_ae(params, c, bits.to(dev), noise.to(dev),
                                           make_perms(c, dev), training=False)
            c_out, c_codes, _ = forward_ae(params_cpu, c, bits, noise, make_perms(c, 'cpu'),
                                           training=False)
        g_out = g_out.cpu()
        check(g_out.shape == (batch, 100, 1) and bool(torch.isfinite(g_out).all()),
              f'deepturbo {dtype} forward: shape or non-finite values')
        check(torch.equal(g_codes.cpu(), c_codes), f'deepturbo {dtype}: codes differ')
        outs[dtype] = {'max_abs_diff': (g_out - c_out).abs().max().item(),
                       'decision_agreement': (g_out.round() == c_out.round()).float().mean().item(),
                       'ber_gpu': (g_out.round() != bits).float().mean().item()}
    emit('deepturbo_forward', batch=batch, snr_db=0.0, **outs)
    check(outs['float32']['max_abs_diff'] < 1e-4, 'deepturbo f32 forward differs from the CPU')


def losses_phase(dev, gen, batch=PARITY_BATCH):
    """The loss menu and Lookahead on the flagship (flagship_fading.msgpack's
    params and Adam state, so that an update is no longer ~lr * sign(g)),
    AWGN, f32, unfused: one joint step of each loss and LOOKAHEAD_STEPS
    Lookahead decoder steps (its inner Adam from the file's state), card
    against CPU on the same host-drawn batches: the loss to 1e-4 relative,
    params and slow weights to 1e-3 of each leaf's largest. Then
    `-optimizer lookahead -loss maxBCE` through cli/main.main, bf16 and
    fused; returns the kernels' launch counts of that run."""
    import tempfile
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.cli import main as cli_main
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.trainer import Trainer
    path = os.path.join(ROOT, 'artifacts', 'flagship_fading.msgpack')

    def batch_pair():
        bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
        return bits, train_sigma((batch, 100, 3), -1.5, 2.0, gen, 'cpu') * \
            torch.randn((batch, 100, 3), generator=gen)

    def rel(a, b):
        return max(((x - y).abs().max() / y.abs().max()).item() for x, y in zip(a, b))

    bits, noise = batch_pair()
    steps = {}
    for loss_name in LOSSES:
        side = {}
        for where in ('gpu', 'cpu'):
            tr = Trainer(Config(batch_size=batch, loss=loss_name), dev if where == 'gpu' else 'cpu')
            tr.params, tr.opt_state, _ = load_checkpoint(path, tr.params, tr.opt_state)
            loss = tr._train_step('joint', bits.to(tr.device), noise.to(tr.device)).item()
            side[where] = (loss, [p.cpu() for h in ('enc', 'dec') for p in tr._leaves[h]])
        (lg, pg), (lc, pc) = side['gpu'], side['cpu']
        steps[loss_name] = {'loss_gpu': lg, 'loss_cpu': lc, 'loss_rel': abs(lg - lc) / abs(lc),
                            'param_diff_rel': rel(pg, pc)}

    batches = [batch_pair() for _ in range(LOOKAHEAD_STEPS)]
    side = {}
    for where in ('gpu', 'cpu'):
        tr = Trainer(Config(batch_size=batch, optimizer='lookahead'),
                     dev if where == 'gpu' else 'cpu')
        tr.params, adam, _ = load_checkpoint(path, tr.params,
                                             {h: o.inner.state() for h, o in tr.opt.items()})
        tr.opt['dec'] = type(tr.opt['dec'])(tr._leaves['dec'], tr.cfg.dec_lr)  # slow = params
        tr.opt['dec'].inner.load_state(adam['dec'])
        losses = [tr._train_step('decoder', b.to(tr.device), n.to(tr.device)).item()
                  for b, n in batches]
        o = tr.opt['dec']
        side[where] = (losses, o.count, o.inner.count, [p.cpu() for p in tr._leaves['dec']],
                       [p.cpu() for p in o.slow], adam['dec']['count'])
    (lg, cg, ig, pg, sg, a0), (lc, cc, ic, pc, sc, _) = side['gpu'], side['cpu']
    look = {'losses_gpu': lg, 'losses_cpu': lc,
            'loss_rel': max(abs(a - b) / abs(b) for a, b in zip(lg, lc)),
            'param_diff_rel': rel(pg, pc), 'slow_diff_rel': rel(sg, sc),
            'counts': {'gpu': [cg, ig], 'cpu': [cc, ic]}, 'inner_count_from_file': a0}

    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, 'metrics.jsonl')
        argv = ['-optimizer', 'lookahead', '-loss', 'maxBCE', '-dtype', 'bfloat16',
                '--use_fused_conv', '-num_epoch', '1', '-num_block', str(LOSSES_NUM_BLOCK),
                '-batch_size', str(LOSSES_BATCH),
                '-log_jsonl', log, '--device', str(dev)]
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            trainer = cli_main.main(argv)
            sync(dev)
            seconds = time.perf_counter() - t0
            counts = read_counts()
        finally:
            os.chdir(cwd)
        with open(log) as f:
            records = [json.loads(line) for line in f]
    cfg = trainer.cfg
    n = max(1, cfg.num_block // cfg.batch_size)
    # training steps, validation batches, Trainer.test's two passes
    forwards = (cfg.num_train_enc + cfg.num_train_dec) * n + \
        max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio)) + 2 * cfg.snr_points * n
    epoch = [r for r in records if r['event'] == 'epoch']
    emit('losses', batch=batch, steps=steps, lookahead=look,
         cli={'argv': argv[:-4], 'epoch': epoch, 'test_ber': trainer.last_test['ber'],
              'seconds': seconds, 'opt_counts': {h: o.count for h, o in trainer.opt.items()}},
         launches=counts, expected_launches=12 * forwards)
    for name, st in steps.items():
        check(math.isfinite(st['loss_gpu']) and st['loss_rel'] < 1e-4,
              f'losses {name}: loss differs from the CPU by {st["loss_rel"]}')
        check(st['param_diff_rel'] < 1e-3, f'losses {name}: params differ by {st["param_diff_rel"]}')
    check(cg == cc == LOOKAHEAD_STEPS and ig == ic == a0 + LOOKAHEAD_STEPS,
          f'lookahead: counts {look["counts"]}')
    check(look['loss_rel'] < 1e-4 and look['param_diff_rel'] < 1e-3 and
          look['slow_diff_rel'] < 1e-3, f'lookahead: card and CPU differ {look}')
    check(len(epoch) == 1 and all(math.isfinite(epoch[0][k]) for k in ('loss', 'val_bce')),
          'losses: the maxBCE epoch is not finite')
    check(trainer.opt['dec'].count == cfg.num_train_dec * n and
          trainer.opt['enc'].count == cfg.num_train_enc * n, 'losses: Lookahead counts')
    check(counts['conv_stack_bf16'] == 12 * forwards,
          f"losses: conv_stack_bf16 launched {counts['conv_stack_bf16']} times, not 12 x {forwards}")
    return counts


def rel_diff(a, b) -> float:
    """max |a - b| / max |b| over two tensors (b the reference)."""
    a, b = a.float().cpu(), b.float().cpu()
    return ((a - b).abs().max() / b.abs().max()).item()


def grads_rel(ga, gb) -> float:
    """The largest, over leaves, of max |a - b| / max |b| (b the reference)."""
    return max(rel_diff(a, b) for a, b in zip(ga, gb))


def gru_forward_phase(dev):
    """ops/gru.py's routes on the card at the RNN decoder's shape: cuDNN
    against the plain scan in f32 (GRU, LSTM; GRU gradients) and bf16, with
    ms a call of each."""
    import warnings
    from turboae_tpu_torch.ops import gru
    from turboae_tpu_torch.utils.device import nvidia_smi
    B, L, IN, H, NL = GRU_SHAPE
    g = torch.Generator().manual_seed(21)
    x = torch.randn((B, L, IN), generator=g).to(dev)
    out = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        for kind, dtype in (('gru', torch.float32), ('lstm', torch.float32),
                            ('gru', torch.bfloat16)):
            layers = gru.birnn_init(g, IN, H, NL, kind, dev)

            def run(route, layers=layers, kind=kind, dtype=dtype):
                with torch.inference_mode():
                    return gru.birnn_apply(layers, x, kind, dtype, route=route)
            before = dict(gru.ROUTE_CALLS)
            cud, scan = run('cudnn'), run('scan')
            sync(dev)
            check(gru.ROUTE_CALLS['cudnn'] == before['cudnn'] + NL and
                  gru.ROUTE_CALLS['scan'] == before['scan'] + NL, f'gru {kind}: routes')
            check(cud.shape == (B, L, 2 * H) and bool(torch.isfinite(cud).all()),
                  f'gru {kind}: shape or non-finite values')
            case = {'kind': kind, 'dtype': str(dtype).split('.')[-1],
                    'cudnn_vs_scan_rel': rel_diff(cud, scan),
                    'cudnn_ms': cuda_ms(lambda: run('cudnn'), iters=20),
                    'scan_ms': cuda_ms(lambda: run('scan'), iters=3, warmup=1)}
            if dtype == torch.float32:
                # both f32 routes against the exact function (the scan in f64)
                with torch.inference_mode():
                    exact = gru.birnn_apply(layers, x.double(), kind, torch.float64, route='scan')
                case['cudnn_vs_f64_rel'] = rel_diff(cud, exact)
                case['scan_vs_f64_rel'] = rel_diff(scan, exact)
            out[f'{kind}_{case["dtype"]}'] = case
        # gradients of a scalar loss through both routes, f32 GRU
        layers = gru.birnn_init(g, IN, H, NL, 'gru', dev)
        leaves = [t.requires_grad_(True) for layer in layers for d in layer.values()
                  for t in d.values()]
        w = torch.randn((B, L, 2 * H), generator=g).to(dev)
        grads = {r: torch.autograd.grad((gru.birnn_apply(layers, x, route=r) * w).sum(), leaves)
                 for r in ('cudnn', 'scan')}
        out['gru_float32']['grad_rel'] = grads_rel(grads['cudnn'], grads['scan'])
        sync(dev)
    weight_warnings = [str(c.message) for c in caught if 'contiguous' in str(c.message)]
    emit('gru_forward', shape=list(GRU_SHAPE), cases=out, weight_warnings=weight_warnings,
         card=nvidia_smi())
    check(not weight_warnings, f'cuDNN copied the RNN weights: {weight_warnings}')
    # the GRU to 1e-5; the LSTM to the repo's f32 kernel tolerance, since
    # cuDNN's f32 LSTM itself lies ~1.2e-5 from the exact (f64) function,
    # where the f32 scan lies ~5e-7 from it (PERF.md §6)
    for k, tol in (('gru_float32', GRU_F32_TOL), ('lstm_float32', F32_REL_TOL)):
        check(out[k]['cudnn_vs_scan_rel'] < tol, f'{k}: cuDNN against the scan {out[k]}')
        check(out[k]['cudnn_vs_f64_rel'] < tol, f'{k}: cuDNN against the f64 scan {out[k]}')
    check(out['gru_float32']['grad_rel'] < 1e-4, f"gru gradients {out['gru_float32']}")
    check(out['gru_bfloat16']['cudnn_vs_scan_rel'] < KERNEL_REL_TOL,
          f"gru bf16: cuDNN against the scan {out['gru_bfloat16']}")


RNN_MODELS = (('Turboae_rate3_rnn', 'TurboAE_rate3_rnn', {}),
              ('Turboae_rate3_rnn', 'TurboAE_rate3_rnn', {'enc_rnn': 'lstm', 'dec_rnn': 'lstm'}),
              ('TurboAE_rate3_rnn_sys', 'TurboAE_rate3_rnn', {}),
              ('TurboAE_rate2_rnn', 'TurboAE_rate2_rnn', {'code_rate_n': 2}),
              ('Turboae_rate3_rnn', 'nbcjr_rate3', {}))


def rnn_forward_phase(dev, gen, batch=PARITY_BATCH):
    """The RNN zoo at full width, card against CPU on host-drawn bits and
    noise (0 dB); returns the kernels' launch counts of the card's runs."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
    from turboae_tpu_torch.ops import gru
    from turboae_tpu_torch.train.sweep import params_to
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    cases, counts = [], {'conv_stack_bf16': 0, 'conv_stack_f32': 0}

    def fwd(params, c, bits, noise, where):
        with torch.inference_mode():
            return forward_ae(params, c, bits.to(where), noise.to(where), make_perms(c, where),
                              training=False)[0].cpu()
    for enc, dec, kw in RNN_MODELS:
        cfg = Config(encoder=enc, decoder=dec, **kw)
        params = init_ae(torch.Generator().manual_seed(0), cfg)
        params_d = params_to(params, dev)
        bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
        noise = snr_db2sigma(0.0) * torch.randn((batch, 100, cfg.code_rate_n), generator=gen)
        case = {'encoder': enc, 'decoder': dec, **kw}
        for dtype in ('float32', 'bfloat16'):
            c = cfg.replace(dtype=dtype)
            before = dict(gru.ROUTE_CALLS)
            sync(dev)
            reset_counts()
            g_out = fwd(params_d, c, bits, noise, dev)
            for k, v in read_counts().items():
                counts[k] += v
            routes = {r: gru.ROUTE_CALLS[r] - before[r] for r in before}
            c_out = fwd(params, c, bits, noise, 'cpu')
            check(g_out.shape == (batch, 100, 1) and bool(torch.isfinite(g_out).all()),
                  f'{enc}+{dec} {dtype}: shape or non-finite values')
            case[dtype] = {'max_abs_diff': (g_out - c_out).abs().max().item(),
                           'decision_agreement': (g_out.round() == c_out.round()).float()
                           .mean().item(),
                           'ber_gpu': (g_out.round() != bits).float().mean().item(),
                           'card_routes': routes}
        cases.append(case)
    emit('rnn_forward', batch=batch, snr_db=0.0, cases=cases, launches=counts)
    for c in cases:
        name = f"{c['encoder']}+{c['decoder']} {c.get('enc_rnn', 'gru')}"
        check(c['float32']['max_abs_diff'] < 1e-4, f'{name}: f32 differs from the CPU {c}')
        check(c['float32']['card_routes']['scan'] == 0 and
              c['float32']['card_routes']['cudnn'] > 0, f'{name}: f32 did not run on cuDNN')
        check(c['bfloat16']['decision_agreement'] > 0.99, f'{name}: bf16 decisions differ {c}')
    check(counts['conv_stack_bf16'] == 0, 'rnn_forward: K2 launched')
    return counts


def rnn_train_phase(dev, gen, batch=PARITY_BATCH):
    """A joint f32 step of the rate-3 RNN pair, card against CPU; the head
    dropout's share; one epoch through cli/main.py. Returns the kernels'
    launch counts of the epoch."""
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.cli import main as cli_main
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import init_ae
    from turboae_tpu_torch.ops import gru
    from turboae_tpu_torch.train import trainer as trainer_mod
    from turboae_tpu_torch.utils.device import nvidia_smi
    cfg = Config(encoder='Turboae_rate3_rnn', decoder='TurboAE_rate3_rnn', batch_size=batch)
    params = init_ae(torch.Generator().manual_seed(0), cfg)
    bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
    noise = train_sigma((batch, 100, 3), -1.5, 2.0, gen, 'cpu') * \
        torch.randn((batch, 100, 3), generator=gen)
    side = {}
    for where in ('gpu', 'cpu'):
        tr = trainer_mod.Trainer(cfg, dev if where == 'gpu' else 'cpu', params=params)
        loss, grads = tr.loss_and_grads('joint', bits.to(tr.device), noise.to(tr.device))
        side[where] = (loss.item(), [t.cpu() for h in ('enc', 'dec') for t in grads[h]])
    (lg, gg), (lc, gc) = side['gpu'], side['cpu']
    step = {'loss_gpu': lg, 'loss_cpu': lc, 'loss_rel': abs(lg - lc) / abs(lc),
            'grad_rel': grads_rel(gg, gc)}

    # the head dropout's share under -dropout 0.3, one decoder step at batch 500
    tr = trainer_mod.Trainer(cfg.replace(dropout=0.3, batch_size=500), dev)
    heads = []
    inner = gru.dropout

    def record(x, rate, generator):
        y = inner(x, rate, generator)
        if x.shape[-1] != 2 * cfg.dec_num_unit:
            heads.append(((y == 0).sum().item(), y.numel()))
        return y
    gru.dropout = record
    try:
        tr._train_step('decoder')
    finally:
        gru.dropout = inner
    n = sum(m for _, m in heads)
    share = sum(z for z, _ in heads) / n
    dropout = {'share': share, 'units': n, 'calls': len(heads),
               'sigma': math.sqrt(0.3 * 0.7 / n)}

    # one epoch of the pair through cli/main.py, f32; the training epochs timed
    argv = ['-encoder', 'Turboae_rate3_rnn', '-decoder', 'TurboAE_rate3_rnn',
            '-num_epoch', '1', '-num_block', str(RNN_NUM_BLOCK), '--device', str(dev)]
    trainer, seconds, train_s, blocks, losses, counts, _ = timed_cli(
        dev, trainer_mod.Trainer, cli_main.main, argv)
    emit('rnn_train', step=step, dropout=dropout, epoch_losses=losses,
         loss_max=RNN_EPOCH_LOSS_MAX, cli_seconds=seconds, train_seconds=train_s,
         train_blocks_per_s=blocks / train_s, test_ber=trainer.last_test['ber'],
         launches=counts, card=nvidia_smi())
    check(step['loss_rel'] < 1e-4, f'rnn_train step: loss differs from the CPU {step}')
    check(step['grad_rel'] < 1e-3, f'rnn_train step: gradients differ from the CPU {step}')
    check(abs(share - 0.3) < 4 * dropout['sigma'], f'rnn_train: dropout share {dropout}')
    # the epoch's loss, as cli/main.py logs it: its last decoder epoch's
    check(len(losses) == 6 and all(math.isfinite(v) for v in losses) and
          losses[-1] < RNN_EPOCH_LOSS_MAX, f'rnn_train: epoch losses {losses}')
    check(counts['conv_stack_bf16'] == 0, 'rnn_train: K2 launched')
    return counts


def ftae_curve_phase(dev, phase, ckpt_name, ref_name, mode, refuse):
    """An FTAE checkpoint's curve through cli/eval_ftae.evaluate under its
    --ftae_power_alloc `mode` (batch 2000, feedback at 40 dB, block_len 50,
    the CLI's defaults), in f32 (held to the committed curve by the BLER z
    test) and in bf16 (measured: the port's bf16, like JAX's on the CPU, sits
    above the TPU's bf16 curve, PERF.md §6); the guard refusing
    --ftae_power_alloc `refuse` on that file. Returns the launch counts of
    both sweeps."""
    from turboae_tpu_torch.cli import eval_ftae
    from turboae_tpu_torch.utils.device import nvidia_smi
    ckpt = os.path.join(ROOT, 'artifacts', ckpt_name)
    ref_path = os.path.join(ROOT, 'artifacts', ref_name)

    def args(alloc, dtype):
        return eval_ftae.parse(['--ckpt', ckpt, '--ftae_power_alloc', alloc, '--snrs',
                                *map(str, FTAE_POINTS), '--num_block', str(SWEEP_BLOCKS),
                                '--batch_size', str(SWEEP_BATCH), '--dtype', dtype,
                                '--device', str(dev), '--ref', ref_path])
    refused = None
    try:
        eval_ftae.evaluate(args(refuse, 'float32'))
    except SystemExit as e:
        refused = str(e)
    with open(ref_path) as f:
        ref = json.load(f)
    sync(dev)
    reset_counts()
    curves = {}
    for dtype in ('float32', 'bfloat16'):
        out = eval_ftae.evaluate(args(mode, dtype))
        check(out['snr'] == list(FTAE_POINTS) and out['n_blocks'] == SWEEP_BLOCKS,
              f"{phase} {dtype}: points {out['snr']}")
        curves[dtype] = {
            'blocks_per_s': out['eval_blocks_per_s'],
            'points': [{'snr': s, 'blk_errors': out['blk_errors'][i],
                        'bit_errors': out['bit_errors'][i], 'n_blocks': out['n_blocks'],
                        'bler': out['bler'][i], 'ber': out['ber'][i],
                        'ref_bler': ref['bler'][ref['snr'].index(s)],
                        'z_bler': out['z_bler_vs_ref'][i]} for i, s in enumerate(out['snr'])]}
    sync(dev)
    counts = read_counts()
    emit(phase, ckpt=ckpt_name, ftae_power_alloc=mode, ref=ref_name, ref_dtype=ref['dtype'],
         curves=curves, refused_mode=refuse, refused=refused, launches=counts,
         device=out['device'], card=nvidia_smi())
    check(refused is not None and f'--ftae_power_alloc={refuse}' in refused,
          f'{phase}: the guard let {refuse} through')
    for p in curves['float32']['points']:
        check(abs(p['z_bler']) < MAX_Z, f"{phase}: f32 BLER at {p['snr']} dB: z = {p['z_bler']}")
    check(all(0.0 < p['bler'] < 1.0 for p in curves['bfloat16']['points']),
          f'{phase}: bf16 BLER out of range')
    check(not any(counts.values()), f'{phase} launched a conv-stack kernel: {counts}')
    return counts


def ftae_train_phase(dev, gen, batch=PARITY_BATCH):
    """An f32 step of each phase from ftae_pa.msgpack's params, card against
    CPU; one epoch of cli/ftae_main with the turboae_rnn decoder; the
    sharedcnn and cnn decoders' forwards. Returns the epoch's launch counts."""
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.cli import ftae_main
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import make_perms
    from turboae_tpu_torch.models.ftae import forward_ftae, init_ftae
    from turboae_tpu_torch.train import ftae_trainer
    from turboae_tpu_torch.train.checkpoint import FTAE_GROUPS, load_checkpoint
    from turboae_tpu_torch.train.sweep import params_to
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    from turboae_tpu_torch.utils.tree import tree_leaves
    path = os.path.join(ROOT, 'artifacts', 'ftae_pa.msgpack')
    cfg = Config(block_len=50, ftae_power_alloc='pos_phase', batch_size=batch)
    bits = (torch.rand((batch, 50, 1), generator=gen) < 0.5).float()
    fwd = train_sigma((batch, 50, 3), -1.5, 2.0, gen, 'cpu') * \
        torch.randn((batch, 50, 3), generator=gen)
    fb = snr_db2sigma(40.0) * torch.randn((batch, 50, 3), generator=gen)
    steps = {}
    for mode in ('encoder', 'decoder'):
        side = {}
        for where in ('gpu', 'cpu'):
            tr = ftae_trainer.FTAETrainer(cfg, dev if where == 'gpu' else 'cpu')
            tr.params = load_checkpoint(path, tr.params)
            loss, grads = tr.loss_and_grads(mode, *(t.to(tr.device) for t in (bits, fwd, fb)))
            side[where] = (loss.item(), [t.cpu() for t in grads])
        (lg, gg), (lc, gc) = side['gpu'], side['cpu']
        # per module (a phase encoder, the decoder), max |diff| over the
        # module's largest gradient: a head bias before the whitening has a
        # gradient that is zero up to rounding, so its own scale is none
        by_module, at = {}, 0
        for k in FTAE_GROUPS['enc' if mode == 'encoder' else 'dec']:
            n = len(tree_leaves(tr.params[k]))
            scale = max(b.abs().max().item() for b in gc[at:at + n])
            by_module[k] = max((a - b).abs().max().item() for a, b in
                               zip(gg[at:at + n], gc[at:at + n])) / scale
            at += n
        steps[mode] = {'loss_gpu': lg, 'loss_cpu': lc, 'loss_rel': abs(lg - lc) / abs(lc),
                       'grad_rel': max(by_module.values()), 'grad_rel_by_module': by_module,
                       'grad_rel_by_leaf': grads_rel(gg, gc)}

    forwards = {}
    for dec_type in ('turboae_sharedcnn', 'cnn'):
        c = Config(block_len=50, dec_type=dec_type)
        params = init_ftae(torch.Generator().manual_seed(0), c)
        with torch.inference_mode():
            g_out, g_codes = forward_ftae(params_to(params, dev), c, bits.to(dev), fwd.to(dev),
                                          fb.to(dev), make_perms(c, dev))
            c_out, c_codes = forward_ftae(params, c, bits, fwd, fb, make_perms(c, 'cpu'))
        forwards[dec_type] = {'max_abs_diff': (g_out.cpu() - c_out).abs().max().item(),
                              'codes_max_abs_diff': (g_codes.cpu() - c_codes).abs().max().item()}

    # one epoch through the CLI: 10 encoder steps, 5 x 10 decoder steps
    argv = ['-dec_type', 'turboae_rnn', '-block_len', '50', '-num_epoch', '1',
            '-num_block', str(FTAE_NUM_BLOCK), '-batch_size', str(FTAE_BATCH), '--device', str(dev)]
    _, seconds, train_s, blocks, losses, counts, saved = timed_cli(
        dev, ftae_trainer.FTAETrainer, ftae_main.main, argv)
    saved = [f for f in saved if f.startswith('ftae_model_')]
    emit('ftae_train', steps=steps, forwards=forwards, epoch_losses=losses, cli_seconds=seconds,
         train_seconds=train_s, train_blocks_per_s=blocks / train_s,
         saved=saved, launches=counts, card=nvidia_smi())
    for mode, st in steps.items():
        check(st['loss_rel'] < 1e-4, f'ftae_train {mode} step: loss differs from the CPU {st}')
        check(st['grad_rel'] < 1e-3, f'ftae_train {mode} step: gradients differ {st}')
    for dec_type, f in forwards.items():
        check(f['max_abs_diff'] < 1e-4 and f['codes_max_abs_diff'] < 1e-4,
              f'ftae {dec_type} forward differs from the CPU {f}')
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
          f'ftae_train: the epoch losses {losses} are not finite and falling')
    check(len(saved) == 1, 'ftae_train: no checkpoint saved')
    check(counts['conv_stack_bf16'] == 0, 'ftae_train: K2 launched')
    return counts


def timed_cli(dev, cls, main, argv):
    """main(argv) in a temporary working directory, each cls.train_epoch of
    the run timed between synchronisations; returns (main's result, the run's
    seconds, the training epochs' seconds, their blocks, their losses, the
    kernels' launch counts of the run, the checkpoints saved under ./tmp,
    read back)."""
    import tempfile
    from turboae_tpu_torch.train.msgpack_io import load_msgpack
    timed = {'seconds': 0.0, 'blocks': 0, 'losses': []}
    epoch_fn = cls.train_epoch

    def timed_epoch(self, *a, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = epoch_fn(self, *a, **kw)
        sync(dev)
        timed['seconds'] += time.perf_counter() - t0
        timed['blocks'] += max(1, self.cfg.num_block // self.cfg.batch_size) * self.cfg.batch_size
        timed['losses'].append(out)
        return out
    with tempfile.TemporaryDirectory() as tmp:
        cwd = os.getcwd()
        os.chdir(tmp)
        cls.train_epoch = timed_epoch
        try:
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            result = main(argv)
            sync(dev)
            seconds = time.perf_counter() - t0
            counts = read_counts()
            saved_dir = os.path.join(tmp, 'tmp')
            saved = {f: load_msgpack(os.path.join(saved_dir, f))
                     for f in sorted(os.listdir(saved_dir))} if os.path.isdir(saved_dir) else {}
        finally:
            cls.train_epoch = epoch_fn
            os.chdir(cwd)
    return result, seconds, timed['seconds'], timed['blocks'], timed['losses'], counts, saved


def load_example(name: str):
    """examples/torch_<name>.py as a module (its __main__ block not run)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f'torch_{name}', os.path.join(ROOT, 'examples', f'torch_{name}.py'))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def examples_phase(dev):
    """Each examples/torch_*.py through its main on the card, at its own
    flags (DeepTurbo cut to EXAMPLE_DEEPTURBO_CUT): the noiseless round trip
    exact and the batched decisions the host's; each curve's BER and BLER
    finite, in [0, 1] and no higher at the highest SNR than at the lowest;
    DeepTurbo's last phase-epoch below EXAMPLE_DEEPTURBO_LOSS_MAX; seconds of
    each. Returns the launch counts of the five runs."""
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.device import nvidia_smi
    runs = {}
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    trip = load_example('conv_encode_decode').main()
    sync(dev)
    runs['conv_encode_decode'] = {
        'seconds': time.perf_counter() - t0, 'bit_errors': trip['bit_errors'],
        'batched_equal': bool((trip['batched'] == trip['decoded']).all()),
        'exact': bool((trip['decoded'][:, :1000] == trip['messages']).all())}
    curves = {}
    for name in ('turbo_example', 'viterbi_bawgn', 'fading_viterbi'):
        t0 = time.perf_counter()
        out = load_example(name).main()
        sync(dev)
        results = out if isinstance(out, list) else [out]
        runs[name] = {'seconds': time.perf_counter() - t0, 'curves': [
            {k: r[k] for k in ('snrs', 'bers', 'blers', 'bit_errors', 'block_errors',
                               'n_blocks', 'seconds')} for r in results]}
        curves.update({f'{name}_{i}': (r['bers'], r['blers']) for i, r in enumerate(results)})
    counts = read_counts()
    trainer, seconds, train_s, blocks, losses, dt_counts, saved = timed_cli(
        dev, Trainer, load_example('deepturbo').main, EXAMPLE_DEEPTURBO_CUT)
    test = trainer.last_test
    runs['deepturbo'] = {'seconds': seconds, 'cut': EXAMPLE_DEEPTURBO_CUT, 'epoch_losses': losses,
                         'loss_max': EXAMPLE_DEEPTURBO_LOSS_MAX, 'train_seconds': train_s,
                         'train_blocks_per_s': blocks / train_s, 'test_snrs': test['snrs'],
                         'test_ber': test['ber'], 'test_bler': test['bler'], 'saved': list(saved)}
    curves['deepturbo'] = (test['ber'], test['bler'])
    counts = {k: counts[k] + dt_counts[k] for k in counts}
    emit('examples', runs=runs, launches=counts, card=nvidia_smi())
    check(runs['conv_encode_decode']['bit_errors'] == [0] * 10 and
          runs['conv_encode_decode']['exact'], 'examples: the noiseless round trip is not exact')
    check(runs['conv_encode_decode']['batched_equal'],
          'examples: the batched decisions differ from the host decoder\'s')
    for name, rates in curves.items():
        for r in rates:
            check(all(math.isfinite(v) and 0.0 <= v <= 1.0 for v in r) and r[-1] <= r[0],
                  f'examples {name}: rates {rates}')
    check(all(math.isfinite(v) for v in losses) and losses[-1] < EXAMPLE_DEEPTURBO_LOSS_MAX,
          f'examples deepturbo: the epoch losses {losses}')
    check(len(saved) == 1, 'examples deepturbo: no checkpoint saved')
    check(not any(counts.values()), f'examples launched a conv-stack kernel: {counts}')
    return counts


def cnn_zoo_forward_phase(dev, gen, batch=PARITY_BATCH):
    """The CNN zoo at full width from one seeded init a pair, card against
    CPU on host-drawn bits and noise (0 dB): f32 within 1e-4 relative; bf16,
    with the fused decoder asked for (none of these decoders takes it, as in
    JAX), decisions > 99 % agreeing. Returns the card's launch counts."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_ae, init_ae, make_perms
    from turboae_tpu_torch.train.sweep import params_to
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    cases, counts = [], {'conv_stack_bf16': 0, 'conv_stack_f32': 0}

    def fwd(params, c, bits, noise, where):
        with torch.inference_mode():
            return forward_ae(params, c, bits.to(where), noise.to(where), make_perms(c, where),
                              training=False)[0].cpu()
    for enc, dec, n in ZOO_PAIRS:
        cfg = Config(encoder=enc, decoder=dec, code_rate_n=n)
        params = init_ae(torch.Generator().manual_seed(0), cfg)
        params_d = params_to(params, dev)
        bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
        noise = snr_db2sigma(0.0) * torch.randn((batch, 100, n), generator=gen)
        case = {'encoder': enc, 'decoder': dec}
        for dtype, fused in (('float32', False), ('bfloat16', True)):
            c = cfg.replace(dtype=dtype, use_fused_conv=fused)
            sync(dev)
            reset_counts()
            g_out = fwd(params_d, c, bits, noise, dev)
            sync(dev)
            for k, v in read_counts().items():
                counts[k] += v
            c_out = fwd(params, c, bits, noise, 'cpu')
            check(g_out.shape == (batch, 100, 1) and bool(torch.isfinite(g_out).all()),
                  f'{enc}+{dec} {dtype}: shape or non-finite values')
            case[dtype] = {'max_rel_diff': rel_diff(g_out, c_out),
                           'decision_agreement': (g_out.round() == c_out.round()).float()
                           .mean().item(),
                           'ber_gpu': (g_out.round() != bits).float().mean().item()}
        cases.append(case)
    emit('cnn_zoo_forward', batch=batch, snr_db=0.0, cases=cases, launches=counts)
    for c in cases:
        name = f"{c['encoder']}+{c['decoder']}"
        check(c['float32']['max_rel_diff'] < 1e-4, f'{name}: f32 differs from the CPU {c}')
        check(c['bfloat16']['decision_agreement'] > 0.99, f'{name}: bf16 decisions differ {c}')
    check(counts['conv_stack_bf16'] == 0, 'cnn_zoo_forward: K2 launched')
    return counts


def cnn_zoo_train_phase(dev, gen, batch=PARITY_BATCH):
    """A joint f32 step of each CNN zoo pair, card against CPU (loss 1e-4,
    gradients 1e-3 of each leaf's largest); one cli/main.py epoch of the 2D
    pair in f32 at lr ZOO_LR (10 encoder, 50 decoder steps at batch 100):
    every phase-epoch's loss finite, the last below the untrained 0.69, its
    train blocks/s. Returns the epoch's launch counts."""
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.cli import main as cli_main
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import init_ae
    from turboae_tpu_torch.train import trainer as trainer_mod
    from turboae_tpu_torch.utils.device import nvidia_smi
    steps = []
    for enc, dec, n in ZOO_PAIRS:
        cfg = Config(encoder=enc, decoder=dec, code_rate_n=n, batch_size=batch)
        params = init_ae(torch.Generator().manual_seed(0), cfg)
        bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
        noise = train_sigma((batch, 100, n), -1.5, 2.0, gen, 'cpu') * \
            torch.randn((batch, 100, n), generator=gen)
        side = {}
        for where in ('gpu', 'cpu'):
            tr = trainer_mod.Trainer(cfg, dev if where == 'gpu' else 'cpu', params=params)
            loss, grads = tr.loss_and_grads('joint', bits.to(tr.device), noise.to(tr.device))
            side[where] = (loss.item(), [t.cpu() for h in ('enc', 'dec') for t in grads[h]])
        (lg, gg), (lc, gc) = side['gpu'], side['cpu']
        steps.append({'encoder': enc, 'decoder': dec, 'loss_gpu': lg, 'loss_cpu': lc,
                      'loss_rel': abs(lg - lc) / abs(lc), 'grad_rel': grads_rel(gg, gc)})

    argv = ['-encoder', 'TurboAE_rate3_cnn2d', '-decoder', 'TurboAE_rate3_cnn2d',
            '-num_epoch', '1', '-num_block', str(ZOO_NUM_BLOCK), '-batch_size', str(ZOO_BATCH),
            '-enc_lr', ZOO_LR, '-dec_lr', ZOO_LR, '--device', str(dev)]
    trainer, seconds, train_s, blocks, losses, counts, _ = timed_cli(
        dev, trainer_mod.Trainer, cli_main.main, argv)
    emit('cnn_zoo_train', steps=steps, epoch_losses=losses, loss_max=ZOO_EPOCH_LOSS_MAX,
         cli_seconds=seconds, train_seconds=train_s, train_blocks_per_s=blocks / train_s,
         test_ber=trainer.last_test['ber'], launches=counts, card=nvidia_smi())
    for st in steps:
        name = f"{st['encoder']}+{st['decoder']}"
        check(st['loss_rel'] < 1e-4, f'cnn_zoo_train {name}: loss differs from the CPU {st}')
        check(st['grad_rel'] < 1e-3, f'cnn_zoo_train {name}: gradients differ {st}')
    check(len(losses) == 6 and all(math.isfinite(v) for v in losses) and
          losses[-1] < ZOO_EPOCH_LOSS_MAX, f'cnn_zoo_train: epoch losses {losses}')
    check(counts['conv_stack_bf16'] == 0, 'cnn_zoo_train: K2 launched')
    return counts


def mod_reference():
    """The BLER of each point of artifacts/mod_tr2.out's closing test, the
    JAX run that ended at mod_ae.msgpack's epoch 400, as exact block error
    counts of MOD_REF_BLOCKS a point."""
    ref = {}
    with open(os.path.join(ROOT, 'artifacts', 'mod_tr2.out')) as f:
        for line in f:
            if line.startswith('Test SNR'):
                words = line.split()
                snr, bler = float(words[2]), float(words[-1])
                errors = bler * MOD_REF_BLOCKS
                check(abs(errors - round(errors)) < 0.05, f'mod_tr2.out: {line!r}')
                ref[snr] = round(errors)
    return ref


def load_mod_ae(cfg, dev):
    """A ModTrainer on `dev` holding artifacts/mod_ae.msgpack's params."""
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.mod_trainer import ModTrainer
    tr = ModTrainer(cfg, dev)
    stats = {}
    tr.params = load_checkpoint(os.path.join(ROOT, 'artifacts', 'mod_ae.msgpack'), tr.params,
                                stats=stats)
    check(stats['kept'] == 0, f'mod_ae.msgpack: not every leaf merged {stats}')
    return tr


def mod_curve_phase(dev):
    """mod_ae.msgpack through ModTrainer.test in f32 (batch 2000, 20,000
    blocks a point at -2..2 dB), each point's BLER held to mod_tr2.out's by
    the z test. Returns the launch counts of the sweep."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    ref = mod_reference()
    cfg = Config(batch_size=SWEEP_BATCH, num_block=SWEEP_BLOCKS, snr_points=len(MOD_POINTS),
                 snr_test_start=MOD_POINTS[0], snr_test_end=MOD_POINTS[-1])
    tr = load_mod_ae(cfg, dev)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    snrs, ber, bler = tr.test(verbose=False)
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    points = []
    for s, b, q in zip(snrs, ber, bler):
        errors = round(q * SWEEP_BLOCKS)
        points.append({'snr': s, 'blk_errors': errors, 'n_blocks': SWEEP_BLOCKS, 'bler': q,
                       'ber': b, 'ref_bler': ref[s] / MOD_REF_BLOCKS,
                       'z_bler': two_proportion_z(errors, SWEEP_BLOCKS, ref[s], MOD_REF_BLOCKS)})
    emit('mod_curve', ckpt='mod_ae.msgpack', ref='artifacts/mod_tr2.out', dtype='float32',
         points=points, seconds=seconds,
         blocks_per_s=SWEEP_BLOCKS * len(snrs) / seconds, launches=counts, card=nvidia_smi())
    check(snrs == list(MOD_POINTS), f'mod_curve: points {snrs}')
    for p in points:
        check(abs(p['z_bler']) < MAX_Z, f"mod_curve: BLER at {p['snr']} dB: z = {p['z_bler']}")
    check(counts['conv_stack_bf16'] == 0, 'mod_curve: K2 launched')
    return counts


def mod_forward_phase(dev, gen, batch=PARITY_BATCH):
    """mod_ae.msgpack's forward on host-drawn bits and symbol noise (0 dB):
    f32 on the card against the CPU within 1e-4; bf16 through K2 (the
    decoder's 12 stacks) against bf16 unfused on the card, decisions > 99 %
    agreeing and exactly 12 K2 launches. Returns the fused forward's counts."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.models.channel_ae import forward_mod_ae, make_perms
    from turboae_tpu_torch.train.sweep import params_to
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    cfg = Config()
    params = load_mod_ae(cfg, 'cpu').params
    params_d = params_to(params, dev)
    bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((batch, 150, 2), generator=gen)

    def fwd(p, c, where):
        with torch.inference_mode():
            out, sym, _ = forward_mod_ae(p, c, bits.to(where), noise.to(where),
                                         make_perms(c, where), training=False)
        return out.cpu(), sym.cpu()
    g_out, g_sym = fwd(params_d, cfg, dev)
    c_out, c_sym = fwd(params, cfg, 'cpu')
    f32 = {'max_rel_diff': rel_diff(g_out, c_out), 'symbols_max_rel_diff': rel_diff(g_sym, c_sym),
           'ber_gpu': (g_out.round() != bits).float().mean().item()}
    sync(dev)
    reset_counts()
    fused, _ = fwd(params_d, cfg.replace(dtype='bfloat16', use_fused_conv=True), dev)
    sync(dev)
    counts = read_counts()
    unfused, _ = fwd(params_d, cfg.replace(dtype='bfloat16'), dev)
    bf16 = {'decision_agreement': (fused.round() == unfused.round()).float().mean().item(),
            'max_abs_diff': (fused - unfused).abs().max().item()}
    emit('mod_forward', batch=batch, snr_db=0.0, float32=f32, bfloat16_fused_vs_unfused=bf16,
         launches=counts, expected_launches=12)
    check(g_out.shape == (batch, 100, 1) and bool(torch.isfinite(g_out).all()),
          'mod_forward: shape or non-finite values')
    check(f32['max_rel_diff'] < 1e-4 and f32['symbols_max_rel_diff'] < 1e-4,
          f'mod_forward: f32 differs from the CPU {f32}')
    check(bf16['decision_agreement'] > 0.99, f'mod_forward: bf16 fused decisions differ {bf16}')
    check(counts['conv_stack_bf16'] == 12, f'mod_forward: K2 launched {counts} times, not 12')
    return counts


def _shapes(tree, prefix=''):
    """{path: shape} of a msgpack tree's arrays."""
    import numpy as np
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _shapes(v, f'{prefix}/{k}').items()}
    return {prefix: tuple(np.shape(tree))}


def mod_resume_phase(dev):
    """mod_ae.msgpack with its four Adam states resumed for one epoch of its
    last leg's recipe (1 encoder, 5 decoder, 1 mod and 5 demod phase-epochs,
    f32): each phase's Adam count up by its steps, each phase's epoch loss
    finite and below MOD_LOSS_MAX; then cli/main_modulation.py from the
    file's params for one epoch, its checkpoint in the file's layout.
    Returns the launch counts of both runs."""
    from turboae_tpu_torch.cli import main_modulation
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.mod_trainer import ModTrainer
    from turboae_tpu_torch.train.msgpack_io import load_msgpack
    from turboae_tpu_torch.utils.device import nvidia_smi
    path = os.path.join(ROOT, 'artifacts', 'mod_ae.msgpack')
    saved = load_msgpack(path)
    counts0 = {ph: int(s['0']['count']) for ph, s in saved['opt_state'].items()}
    schedule = (('encoder', 1), ('decoder', 5), ('mod', 1), ('demod', 5))
    tr = ModTrainer(Config(**MOD_RECIPE), dev)
    tr.params, tr.opt_state, step = load_checkpoint(path, tr.params, tr.opt_state)
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    losses = {ph: [tr.train_epoch(step + 1, ph, verbose=False) for _ in range(k)]
              for ph, k in schedule}
    sync(dev)
    seconds = time.perf_counter() - t0
    counts = read_counts()
    steps = MOD_RECIPE['num_block'] // MOD_RECIPE['batch_size']
    grew = {ph: tr.opt[ph].count - counts0[ph] for ph in counts0}

    argv = ['-init_nw_weight', path, '-num_epoch', '1', '-num_block', str(MOD_CLI_NUM_BLOCK),
            '-batch_size', str(MOD_RECIPE['batch_size']), '--device', str(dev)]
    _, cli_s, _, _, cli_losses, cli_counts, files = timed_cli(
        dev, ModTrainer, main_modulation.main, argv)
    (name, written), = files.items()
    cli_steps = MOD_CLI_NUM_BLOCK // MOD_RECIPE['batch_size']
    written_counts = {ph: int(s['0']['count']) for ph, s in written['opt_state'].items()}
    same_layout = _shapes({k: v for k, v in written.items() if k != 'step'}) == \
        _shapes({k: v for k, v in saved.items() if k != 'step'})
    emit('mod_resume', file_step=step, file_counts=counts0, counts_grew=grew, losses=losses,
         loss_max=MOD_LOSS_MAX, seconds=seconds,
         train_blocks_per_s=steps * MOD_RECIPE['batch_size'] * sum(k for _, k in schedule)
         / seconds, cli_seconds=cli_s, cli_epoch_losses=cli_losses, cli_checkpoint=name,
         cli_counts=written_counts, cli_same_layout=same_layout, launches=counts,
         cli_launches=cli_counts,
         card=nvidia_smi())
    check(step == 400, f'mod_resume: the file holds step {step}')
    check(grew == {ph: k * steps for ph, k in schedule}, f'mod_resume: Adam counts grew {grew}')
    for ph, ls in losses.items():
        check(all(math.isfinite(v) and v < MOD_LOSS_MAX for v in ls),
              f'mod_resume: {ph} losses {ls} not below {MOD_LOSS_MAX}')
    check(written_counts == {ph: k * cli_steps for ph, k in schedule},
          f'mod_resume: the CLI checkpoint counts {written_counts}')
    check(same_layout, 'mod_resume: the CLI checkpoint differs from the file in layout')
    check(all(math.isfinite(v) for v in cli_losses), f'mod_resume: CLI losses {cli_losses}')
    check(counts['conv_stack_bf16'] == cli_counts['conv_stack_bf16'] == 0,
          'mod_resume: K2 launched')
    return {k: counts[k] + cli_counts[k] for k in counts}


def train_times_phase(dev, batch=TRAIN_BATCH, steps=60, **cfg_overrides):
    """cli/bench_train.py's timed loop, fused on and off, TF32 off."""
    from turboae_tpu_torch.cli.bench_train import bench
    from turboae_tpu_torch.kernels import conv_stack as ks
    out = {}
    for fused in (True, False):
        before = ks.conv_stack_bf16.launches
        r = bench(batch_size=batch, use_fused_conv=fused, steps=steps, device=dev,
                  **cfg_overrides)
        check(math.isfinite(r['last_loss']), 'bench_train: non-finite loss')
        check((ks.conv_stack_bf16.launches > before) == fused, 'bench_train: K2 launches')
        out['fused' if fused else 'unfused'] = r
    emit('train_times', train_blocks_per_s={k: r['value'] for k, r in out.items()},
         mfu={k: r['mfu'] for k, r in out.items()}, batch=batch, steps=steps,
         schedule='1 encoder : 5 decoder', dtype='bfloat16', allow_tf32=False)
    return out


def conv_stack_bench_phase(dev, argv=()):
    """cli/bench_conv_stack.py's rows; returns the launch counts of the run."""
    from turboae_tpu_torch.cli import bench_conv_stack
    args = bench_conv_stack.parse(['--device', str(dev), *argv])
    sync(dev)
    reset_counts()
    ms, numerics = bench_conv_stack.rows(args)
    sync(dev)
    counts = read_counts()
    emit('conv_stack_bench', ms=ms, check=numerics, launches=counts,
         shape=[args.B, args.L, args.Cin, args.C, args.K, args.layers])
    check(counts['conv_stack_f32'] > 0, 'K1 did not launch in its bench')
    check(counts['conv_stack_bf16'] > 0, 'K2 did not launch in its bench')
    check(numerics['cuda_f32_max_rel_err'] < F32_REL_TOL, 'K1 bench numerics')
    check(numerics['cuda_bf16_max_rel_err'] < KERNEL_REL_TOL, 'K2 bench numerics')
    return counts


def vbl_epoch_phase(dev):
    """One cli/main.py epoch with --is_variable_block_len over 10..199 (the
    eight buckets of np.linspace(10, 199, 8)) at full width, bf16, fused,
    batch VBL_BATCH, VBL_NUM_BLOCK blocks, then its three tests (the run's
    length, block_len_low and block_len_high; SNR_POINTS_VBL points each).
    The (phase, length) of every step equals what a narrow CPU trainer
    draws from the same seed and schedule; every phase-epoch's loss is
    finite and the last below the untrained 0.69; K2 launches 12 times a
    forward. Returns the run's launch counts."""
    from turboae_tpu_torch.cli import main as cli_main
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train import trainer as trainer_mod
    from turboae_tpu_torch.utils.device import nvidia_smi
    vbl = ['--is_variable_block_len', '-block_len_low', str(VBL_LOW), '-block_len_high',
           str(VBL_HIGH)]
    argv = [*vbl, '-dtype', 'bfloat16', '--use_fused_conv', '-num_epoch', '1',
            '-num_block', str(VBL_NUM_BLOCK), '-batch_size', str(VBL_BATCH),
            '-snr_points', str(len(SWEEP_POINTS)), '-snr_test_start', str(SWEEP_POINTS[0]),
            '-snr_test_end', str(SWEEP_POINTS[-1]), '--device', str(dev)]
    steps = []
    step_fn = trainer_mod.Trainer._train_step

    def recorded(self, mode, bits=None, noise=None, block_len=None):
        if self.cfg.is_variable_block_len:
            steps.append((mode, block_len))
        return step_fn(self, mode, bits, noise, block_len)
    trainer_mod.Trainer._train_step = recorded
    try:
        trainer, seconds, train_s, blocks, losses, counts, _ = timed_cli(
            dev, trainer_mod.Trainer, cli_main.main, argv)
        card_steps = list(steps)
        # the same schedule at a narrow width on the CPU: the lengths and
        # seeds come from cfg.seed alone
        steps.clear()
        n = VBL_NUM_BLOCK // VBL_BATCH
        cpu = trainer_mod.Trainer(trainer.cfg.replace(
            enc_num_unit=8, dec_num_unit=8, num_iteration=2, dtype='float32',
            use_fused_conv=False, batch_size=2, num_block=2 * n), 'cpu')
        for mode in ['encoder'] * trainer.cfg.num_train_enc + ['decoder'] * trainer.cfg.num_train_dec:
            cpu.train_epoch(1, mode, verbose=False)
        cpu_steps = list(steps)
    finally:
        trainer_mod.Trainer._train_step = step_fn
    cfg = trainer.cfg
    buckets = trainer_mod.vbl_buckets(cfg)
    val = max(1, int(cfg.num_block / cfg.batch_size * cfg.test_ratio))
    forwards = len(card_steps) + val + 3 * 2 * cfg.snr_points * n
    emit('vbl_epoch', buckets=buckets, lengths_used=sorted({L for _, L in card_steps}),
         seeds=sorted(trainer.vbl_seeds.items()), epoch_losses=losses,
         loss_max=VBL_LOSS_MAX, steps=len(card_steps), same_as_cpu=card_steps == cpu_steps,
         test_bler=trainer.last_test['bler'], cli_seconds=seconds, train_seconds=train_s,
         train_blocks_per_s=blocks / train_s, launches=counts,
         expected_launches=12 * forwards, card=nvidia_smi())
    check(buckets == VBL_BUCKETS, f'vbl_epoch: buckets {buckets}')
    check(card_steps == cpu_steps and len(card_steps) == 6 * n,
          'vbl_epoch: the card drew other lengths than the CPU')
    check(len(losses) == 6 and all(math.isfinite(v) for v in losses) and
          losses[-1] < VBL_LOSS_MAX, f'vbl_epoch: epoch losses {losses}')
    check(counts['conv_stack_bf16'] == 12 * forwards,
          f"vbl_epoch: conv_stack_bf16 launched {counts['conv_stack_bf16']} times, "
          f'not 12 x {forwards}')
    return counts


def k_same_code_phase(dev):
    """is_k_same_code (k = 2) at full width, bf16, fused, batch 500: in an
    encoder epoch of 5 steps the bits are shared by steps (0, 1) and (2, 3)
    and new at 0, 2 and 4, the noise new at every step; a decoder epoch
    draws new bits every step. Returns the launch counts of both epochs."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    cfg = Config(batch_size=TRAIN_BATCH, num_block=5 * TRAIN_BATCH, dtype='bfloat16',
                 use_fused_conv=True, is_k_same_code=True, k_same_code=2)
    tr = Trainer(cfg, dev)
    seen = []
    inner = tr.loss_and_grads

    def record(mode, bits, noise, *a):
        seen.append((mode, bits.clone(), noise.clone()))
        return inner(mode, bits, noise, *a)
    tr.loss_and_grads = record
    sync(dev)
    reset_counts()
    losses = {m: tr.train_epoch(1, m, verbose=False) for m in ('encoder', 'decoder')}
    sync(dev)
    counts = read_counts()
    enc = [(b, n) for m, b, n in seen if m == 'encoder']
    dec = [b for m, b, _ in seen if m == 'decoder']
    same = [bool(torch.equal(a[0], b[0])) for a, b in zip(enc, enc[1:])]
    noise_new = all(not torch.equal(a[1], b[1]) for i, a in enumerate(enc) for b in enc[i + 1:])
    dec_new = all(not torch.equal(a, b) for a, b in zip(dec, dec[1:]))
    emit('k_same_code', k=cfg.k_same_code, encoder_bits_same_as_previous=same,
         encoder_noise_all_new=noise_new, decoder_bits_all_new=dec_new, losses=losses,
         launches=counts, expected_launches=12 * len(seen))
    check(same == [True, False, True, False], f'k_same_code: bits reused {same}')
    check(noise_new and dec_new, 'k_same_code: noise or decoder bits repeated')
    check(all(math.isfinite(v) for v in losses.values()), f'k_same_code: losses {losses}')
    check(counts['conv_stack_bf16'] == 12 * len(seen), f'k_same_code: launches {counts}')
    return counts


def graph_steps_phase(dev, eager_bench):
    """steps_per_call as CUDA graphs, against eager steps from the same
    params, optimizer state and generator state (flagship_fading.msgpack
    with its Adam state on its fading channel, whose gain the generator
    draws; a seeded init for Lookahead and SGD): GRAPH_N steps a replay, 2
    replays, each phase. Three trainers a case: two eager (their gap is
    the run-to-run noise) and one that replays. f32 unfused: every loss
    within 1e-5 relative of eager; bf16 fused: within the eager-eager gap
    plus 1e-3. cuDNN's backward algorithms may add in another order from
    run to run, which bf16 and a fine-tuned model's small losses amplify
    (on an H100 80GB HBM3 at 700 W, eager against eager: 1.2e-3 in the
    decoder phase, 1.3e-2 in the encoder's); the comparisons run with
    torch.backends.cudnn.deterministic so that they measure the graph, not
    that noise. Then cli/bench_train's timed loop through the graphs, fused
    and unfused, beside the eager figures of train_times. Returns the launch
    counts of the replaying trainers and the graph benchmarks."""
    from turboae_tpu_torch.cli.bench_train import bench
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.device import nvidia_smi
    path = os.path.join(ROOT, 'artifacts', 'flagship_fading.msgpack')
    n, groups = GRAPH_N, 2
    cases = [('bfloat16', True, 'adam', ('decoder', 'encoder')),
             ('float32', False, 'adam', ('decoder', 'encoder')),
             ('float32', False, 'lookahead', ('decoder',)),
             ('float32', False, 'sgd', ('decoder',))]
    results, counts = [], {'conv_stack_bf16': 0, 'conv_stack_f32': 0}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True

    def trainer(cfg, from_file):
        tr = Trainer(cfg, dev)
        if from_file:
            tr.params, tr.opt_state, _ = load_checkpoint(path, tr.params, tr.opt_state)
        return tr
    for dtype, fused, opt, modes in cases:
        from_file = opt == 'adam'
        cfg = Config(batch_size=TRAIN_BATCH, dtype=dtype, use_fused_conv=fused, optimizer=opt,
                     **(dict(channel='fading', train_dec_channel_low=-2.5,
                             train_dec_channel_high=2.5, train_enc_channel_low=0.5,
                             train_enc_channel_high=0.5) if from_file else {}))
        for mode in modes:
            eager = []
            for _ in range(2):
                tr = trainer(cfg, from_file)
                eager.append((torch.stack([tr._train_step(mode) for _ in range(n * groups)]),
                              [p.clone() for h in ('enc', 'dec') for p in tr._leaves[h]]))
            tr = trainer(cfg, from_file)
            counts0 = {h: getattr(o, 'count', None) for h, o in tr.opt.items()}
            sync(dev)
            reset_counts()
            got = torch.cat(tr._train_steps(mode, n, groups))
            sync(dev)
            c = read_counts()
            for k in counts:
                counts[k] += c[k]
            params = [p for h in ('enc', 'dec') for p in tr._leaves[h]]

            def rel(a, b):
                return ((a - b).abs() / b.abs()).max().item()

            def prel(a, b):
                return max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
                           for x, y in zip(a, b))
            (l1, p1), (l2, p2) = eager
            results.append({
                'dtype': dtype, 'use_fused_conv': fused, 'optimizer': opt, 'mode': mode,
                'from': 'flagship_fading.msgpack' if from_file else 'seeded init',
                'losses_eager': l1.tolist(), 'losses_graph': got.tolist(),
                'loss_rel_graph_vs_eager': rel(got, l1), 'loss_rel_eager_vs_eager': rel(l2, l1),
                'param_rel_graph_vs_eager': prel(params, p1),
                'param_rel_eager_vs_eager': prel(p2, p1),
                'counts_before': counts0,
                'counts_after': {h: getattr(o, 'count', None) for h, o in tr.opt.items()},
                'launches': c, 'expected_launches': 12 * (1 + n * groups) if fused else 0})
    torch.backends.cudnn.deterministic = deterministic
    bench_graph = {}
    sync(dev)
    reset_counts()
    for fused in (True, False):
        r = bench(batch_size=TRAIN_BATCH, use_fused_conv=fused, steps=60, device=dev,
                  steps_per_call=n)
        check(math.isfinite(r['last_loss']), 'graph bench: non-finite loss')
        bench_graph['fused' if fused else 'unfused'] = r
    sync(dev)
    c = read_counts()
    for k in counts:
        counts[k] += c[k]
    emit('graph_steps', n=n, replays=groups, cases=results, cudnn_deterministic=True,
         train_blocks_per_s={k: {'eager': eager_bench[k]['value'],
                                 'graph': bench_graph[k]['value']} for k in bench_graph},
         bench_launches=c, card=nvidia_smi())
    for r in results:
        name = f"{r['dtype']} {r['optimizer']} {r['mode']}"
        if r['dtype'] == 'float32':
            check(r['loss_rel_graph_vs_eager'] < 1e-5, f'graph_steps {name}: {r}')
        else:
            check(r['loss_rel_graph_vs_eager'] <= r['loss_rel_eager_vs_eager'] + 1e-3,
                  f'graph_steps {name}: {r}')
        check(all(math.isfinite(v) for v in r['losses_graph']), f'graph_steps {name}: not finite')
        check(r['launches']['conv_stack_bf16'] == r['expected_launches'],
              f"graph_steps {name}: K2 launched {r['launches']} times")
        if r['counts_before']['dec'] is not None:
            h = 'dec' if r['mode'] == 'decoder' else 'enc'
            check(r['counts_after'][h] == r['counts_before'][h] + n * groups,
                  f'graph_steps {name}: optimizer counts {r}')
    check(c['conv_stack_bf16'] > 0, 'graph bench: K2 did not launch')
    return counts, bench_graph


def flops_phase(dev, benches):
    """cli/compute_flop's report at the flagship config on the card (the
    counted forward within 5 % of the closed form), and bench_train's step
    FLOPs, TFLOP/s and MFU from the eager and graph runs: each MFU a number
    between 0 and 1 against the named peak."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.flops import report
    rep = report(Config(), dev)
    rows = {k: {f: r[f] for f in ('step_flops', 'tflops_per_s', 'mfu', 'mfu_reason',
                                  'peak_flops', 'peak_dtype', 'value', 'steps_per_call',
                                  'use_fused_conv')} for k, r in benches.items()}
    emit('flops', compute_flop=rep, bench=rows, card=nvidia_smi())
    check(abs(rep['counted'] - rep['total_flops']) <= 0.05 * rep['total_flops'],
          f'flops: counted {rep["counted"]} against {rep["total_flops"]}')
    for k, r in rows.items():
        check(r['mfu'] is not None and 0 < r['mfu'] < 1 and r['peak_flops'],
              f'flops {k}: mfu {r}')


def train_clis_phase(dev):
    """The training-side CLIs on the card: the crown averaged with itself
    gives its own file back, byte for byte; select_checkpoint and
    select_bler_deep rank flagship.msgpack and flagship_fading.msgpack
    (SELECT_BLOCKS a point); train_family resumes ftae_pa.msgpack and
    mod_ae.msgpack for one epoch each (their phase-epoch losses finite and
    below the untrained 0.69). Returns the launch counts of the rankings
    and the family epochs."""
    import tempfile
    from turboae_tpu_torch.cli import average_checkpoints, select_bler_deep, select_checkpoint
    from turboae_tpu_torch.cli import train_family
    from turboae_tpu_torch.train.msgpack_io import load_msgpack
    from turboae_tpu_torch.utils.device import nvidia_smi
    art = os.path.join(ROOT, 'artifacts')
    crown = os.path.join(art, 'flagship.msgpack')
    pair = [crown, os.path.join(art, 'flagship_fading.msgpack')]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        soup = os.path.join(tmp, 'soup.msgpack')
        average_checkpoints.main(['--out', soup, crown, crown])
        with open(soup, 'rb') as f, open(crown, 'rb') as g:
            out['soup_same_bytes'] = f.read() == g.read()
        common = ['--num_block', str(SELECT_BLOCKS), '--batch_size', str(SWEEP_BATCH),
                  '--use_fused_conv', '--device', str(dev)]
        sync(dev)
        reset_counts()
        t0 = time.perf_counter()
        ranked = select_checkpoint.main([*pair, *common, '--out', os.path.join(tmp, 'r.jsonl')])
        deep = select_bler_deep.main([*pair, *common, '--out', os.path.join(tmp, 'd.jsonl'),
                                      '--snrs', '2.0', '3.5'])
        sync(dev)
        out['select_seconds'] = time.perf_counter() - t0
        counts = read_counts()
        out['select_checkpoint'] = [{k: r[k] for k in ('ckpt', 'ber_wins', 'bler_wins',
                                                       'blk_errors')} for r in ranked]
        out['select_bler_deep'] = [{k: r[k] for k in ('ckpt', 'snr', 'bler', 'blk_errors')}
                                   for r in deep]
        family = {
            'ftae': ['--family', 'ftae', '--resume', os.path.join(art, 'ftae_pa.msgpack'),
                     '--ftae_power_alloc', 'pos_phase', '--fb_channel_low', '40',
                     '--fb_channel_high', '40', '--block_len', '50', '--epochs', '1201'],
            'mod': ['--family', 'mod', '--resume', os.path.join(art, 'mod_ae.msgpack'),
                    '--block_len', '100', '--enc_lr', '1e-4', '--dec_lr', '1e-4', '--mod_lr',
                    '1e-4', '--demod_lr', '1e-4', '--epochs', '401']}
        for name, argv in family.items():
            ckpt = os.path.join(tmp, f'{name}.msgpack')
            argv = [*argv, '--num_block', str(FAMILY_NUM_BLOCK), '--batch_size',
                    str(TRAIN_BATCH), '--val_every', '0', '--test_num_block', '2000',
                    '--ckpt', ckpt, '--metrics', os.path.join(tmp, f'{name}.jsonl'),
                    '--device', str(dev)]
            sync(dev)
            reset_counts()
            t0 = time.perf_counter()
            tr = train_family.main(argv)
            sync(dev)
            seconds = time.perf_counter() - t0
            for k, v in read_counts().items():
                counts[k] += v
            with open(os.path.join(tmp, f'{name}.jsonl')) as f:
                epoch = [r for r in map(json.loads, f) if r['event'] == 'epoch']
            out[name] = {'epoch': epoch, 'saved_step': load_msgpack(ckpt)['step'],
                         'seconds': seconds}
    out['launches'] = counts
    emit('train_clis', **out, card=nvidia_smi())
    check(out['soup_same_bytes'], 'train_clis: the soup of the crown with itself differs')
    check(len(ranked) == 2 and all(len(r['ber']) == 12 for r in ranked),
          'train_clis: select_checkpoint rows')
    check(len(deep) == 2 and all(r['n_blocks'] == SELECT_BLOCKS for r in deep),
          'train_clis: select_bler_deep rows')
    for name, step in (('ftae', 1201), ('mod', 401)):
        (ep,) = out[name]['epoch']
        losses = [v for k, v in ep.items() if k.endswith('_loss')]
        check(out[name]['saved_step'] == step and ep['epoch'] == step,
              f'train_clis {name}: the epoch counter {ep}')
        check(losses and all(math.isfinite(v) and v < 0.69 for v in losses),
              f'train_clis {name}: losses {ep}')
    # K2: the rankings' sweeps; the families' decoders have no plain stack
    n_batches = SELECT_BLOCKS // SWEEP_BATCH
    check(counts['conv_stack_bf16'] == 12 * n_batches * 2 * (12 + 2),
          f'train_clis: K2 launched {counts}')
    return counts


def profile_call(fn, dev):
    """One call of fn under torch.profiler: its kernel launches, the device's
    busy time (kernels and copies) and the profiled wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages() if e.device_type != DeviceType.CPU]
    busy_ms = sum(getattr(e, 'self_device_time_total', 0.0) for e in device) / 1e3
    return {'launches': sum(e.count for e in device), 'device_busy_ms': busy_ms,
            'profiled_wall_ms': wall_ms, 'busy_share': busy_ms / wall_ms}


def turbo_profile(trellis, p_array, variant, rx_dev, sigma, ms, dev):
    """The launches and device busy time of one turbo decode of rx_dev, from
    decoders of 1 and 2 iterations under torch.profiler: every iteration
    launches the same kernels, so a decode of n iterations launches
    one + (n - 1) * (two - one); the profiler's bookkeeping of a whole
    decode's launches takes longer than the decode. Busy share against the
    unprofiled decode's `ms`."""
    from turboae_tpu_torch.classical.turbo import make_turbo_decoder
    runs = []
    for n in (1, 2):
        dec = make_turbo_decoder(trellis, p_array, n, variant)
        dec(*rx_dev.unbind(2), sigma ** 2)                      # tables on the card
        runs.append(profile_call(lambda: dec(*rx_dev.unbind(2), sigma ** 2), dev))
    one, two = runs
    n = CLASSICAL_ITERS - 1
    busy_ms = one['device_busy_ms'] + n * (two['device_busy_ms'] - one['device_busy_ms'])
    return {'launches': one['launches'] + n * (two['launches'] - one['launches']),
            'device_busy_ms': busy_ms, 'ms': ms, 'busy_share': busy_ms / ms,
            'one_iteration': one, 'two_iterations': two}


def timed_call(fn, dev):
    """(fn(), its ms on the host clock, ending in a synchronize)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def classical_parity_phase(dev):
    """Each classical device decoder on the card against the same function
    on the CPU, on host-seeded received symbols. The turbo decoder in every
    variant for Turbo-757 and Turbo-LTE, B=2000, L=100, -1 dB: the CPU
    decodes the first CLASSICAL_CPU_ROWS blocks (each block decodes on its
    own), LLRs within CLASSICAL_LLR_TOL, decisions equal where |LLR| >
    CLASSICAL_NEAR_ZERO. Viterbi with the hard, unquantized and tdist3
    metrics on [7,5] and the rate-1/3 [7,5,6] (B=2000, L=100, 2 dB):
    decisions equal. LDPC BP on the (96, 48) design (B=2000, 2.5 dB, 100
    iterations): MSA, exact arithmetic summed in one order, bits equal and
    LLRs within LDPC_LLR_TOL on every frame; SPA bits equal on the frames
    that satisfy the parity on both devices and the frame-error counts
    within |z| < MAX_Z. The ms of each card call (host clock; the turbo
    decoders' first, Viterbi's and BP's second), and for the
    757 hazzys decoder (turbo_profile), [7,5] unquantized Viterbi and SPA
    the launches and device busy share of one call under torch.profiler."""
    import numpy as np
    from turboae_tpu_torch.classical.convcode import conv_encode_batch, make_viterbi
    from turboae_tpu_torch.classical.interleavers import RandInterlv
    from turboae_tpu_torch.classical.ldpc import DESIGNS, get_ldpc_code_params, make_ldpc_decoder
    from turboae_tpu_torch.classical.trellis import Trellis, turbo757_trellis, turbo_lte_trellis
    from turboae_tpu_torch.classical.turbo import VARIANTS, make_turbo_decoder, turbo_encode_batch
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    rng = np.random.RandomState(0)
    B, L, rows = CLASSICAL_B, CLASSICAL_L, CLASSICAL_CPU_ROWS
    out = {'turbo': [], 'viterbi': [], 'ldpc': [], 'profiled': {}}
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    p = RandInterlv(L, 0).p_array
    sigma = 10 ** (-CLASSICAL_PARITY_SNR / 20)
    for code, trellis in (('757', turbo757_trellis()), ('lte', turbo_lte_trellis())):
        msgs = rng.randint(0, 2, (B, L))
        rx = torch.as_tensor(2.0 * turbo_encode_batch(msgs, trellis, p) - 1.0
                             + sigma * rng.randn(B, L, 3), dtype=torch.float32)
        rx_dev = rx.to(dev)
        for variant in VARIANTS:
            dec = make_turbo_decoder(trellis, p, CLASSICAL_ITERS, variant)
            got, ms = timed_call(lambda: dec.llr(*rx_dev.unbind(2), sigma ** 2), dev)
            got = got.cpu()
            ref, cpu_ms = timed_call(lambda: dec.llr(*rx[:rows].unbind(2), sigma ** 2), 'cpu')
            mine = got[:rows]
            firm = ref.abs() > CLASSICAL_NEAR_ZERO
            out['turbo'].append({
                'code': code, 'variant': variant, 'cpu_rows': rows,
                'max_abs_llr_diff': (mine - ref).abs().max().item(),
                'decision_agreement': ((mine > 0) == (ref > 0)).float().mean().item(),
                'firm_decisions_equal': bool(torch.equal((mine > 0)[firm], (ref > 0)[firm])),
                'ber': float(((got > 0).numpy() != msgs).mean()), 'ms': ms,
                'blocks_per_s': B / ms * 1e3, 'cpu_ms': cpu_ms})
            if (code, variant) == ('757', 'hazzys'):
                out['profiled']['turbo_757'] = turbo_profile(trellis, p, variant, rx_dev, sigma,
                                                             ms, dev)
    for gens in ([7, 5], [7, 5, 6]):
        trellis = Trellis(np.array([2]), np.array([gens]))
        coded = conv_encode_batch(rng.randint(0, 2, (B, L)), trellis)
        soft = (2.0 * coded - 1 + 10 ** (-2.0 / 20) * rng.randn(*coded.shape)).reshape(B, -1, trellis.n)
        for decoding_type in ('hard', 'unquantized', 'tdist3'):
            rx = torch.as_tensor((soft > 0).astype(float) if decoding_type == 'hard' else soft,
                                 dtype=torch.float32)
            rx_dev = rx.to(dev)
            dec = make_viterbi(trellis, decoding_type)
            dec(rx_dev)                     # warm: the first call loads kernels lazily
            got, ms = timed_call(lambda: dec(rx_dev), dev)
            out['viterbi'].append({'generators': gens, 'decoding_type': decoding_type,
                                   'equal': bool(torch.equal(got.cpu(), dec(rx))), 'ms': ms})
            if gens == [7, 5] and decoding_type == 'unquantized':
                out['profiled']['viterbi_75'] = profile_call(lambda: dec(rx_dev), dev)
    params = get_ldpc_code_params(os.path.join(DESIGNS, '96.33.964.txt'))
    nv = 1.0 / (2 * 0.5 * 10 ** (2.5 / 10.0))
    llr = torch.as_tensor(2.0 * (1.0 + np.sqrt(nv) * rng.randn(B, 96)) / nv, dtype=torch.float32)
    llr_dev = llr.to(dev)
    pmat = torch.as_tensor(params['pmat'], dtype=torch.float32)
    for alg in ('SPA', 'MSA'):
        dec = make_ldpc_decoder(params, alg, 100)
        dec(llr_dev)                        # warm, as Viterbi's
        (bits, out_llr), ms = timed_call(lambda: dec(llr_dev), dev)
        bits, out_llr = bits.cpu(), out_llr.cpu()
        ref_bits, ref_llr = dec(llr)
        # the frames whose bits satisfy every parity check on both devices
        both = ((pmat @ bits.T.float()) % 2 == 0).all(0) & ((pmat @ ref_bits.T.float()) % 2 == 0).all(0)
        fe, ref_fe = int((bits.sum(dim=1) > 0).sum()), int((ref_bits.sum(dim=1) > 0).sum())
        out['ldpc'].append({
            'alg': alg, 'converged_both': int(both.sum()),
            'converged_bits_equal': bool(torch.equal(bits[both], ref_bits[both])),
            'bits_equal': bool(torch.equal(bits, ref_bits)),
            'max_abs_llr_diff': (out_llr - ref_llr).abs().max().item(),
            'frames_bits_differ': int((bits != ref_bits).any(dim=1).sum()),
            'frame_errors': fe, 'cpu_frame_errors': ref_fe,
            'z_frame_errors': two_proportion_z(fe, B, ref_fe, B), 'ms': ms})
        if alg == 'SPA':
            out['profiled']['ldpc_spa'] = profile_call(lambda: dec(llr_dev), dev)
    counts = read_counts()
    emit('classical_parity', **out, seconds=time.perf_counter() - t0, launches=counts,
         card=nvidia_smi())
    for r in out['turbo']:
        check(r['max_abs_llr_diff'] < CLASSICAL_LLR_TOL and r['firm_decisions_equal'],
              f"classical_parity turbo {r['code']} {r['variant']}: {r}")
    for r in out['viterbi']:
        check(r['equal'], f'classical_parity viterbi: {r}')
    for r in out['ldpc']:
        check(r['converged_both'] > 0 and r['converged_bits_equal'] and abs(r['z_frame_errors']) < MAX_Z,
              f'classical_parity ldpc: {r}')
        check(r['alg'] == 'SPA' or (r['bits_equal'] and r['max_abs_llr_diff'] < LDPC_LLR_TOL),
              f'classical_parity ldpc: {r}')
    check(not any(counts.values()), f'classical_parity launched a conv-stack kernel: {counts}')
    return counts


def classical_curve_phase(dev):
    """Turbo-757 (hazzys, 6 iterations) through cli/turbo_benchmark.run_benchmark
    on the card, each point's BLER held by |z| < MAX_Z to the committed
    exact counts (bler x n_blocks): -engine torch_mc at -1.5..0 dB, K=100,
    CURVE_BLOCKS a point, against artifacts/classical_awgn_k100.json; -engine
    torch (host bits and noise) at -1 dB against the same; -engine torch
    with t-dist noise (vv 3) at -1.5 dB against classical_nonawgn_k100.json;
    -engine torch_mc at K=1000, -1 dB, K1000_BLOCKS, against
    classical_awgn_k1000.json. Blocks/s a point from the CLI's clock."""
    from turboae_tpu_torch.cli import turbo_benchmark
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    curves = {}
    for name in ('classical_awgn_k100', 'classical_awgn_k1000', 'classical_nonawgn_k100'):
        with open(os.path.join(ROOT, 'artifacts', f'{name}.json')) as f:
            curves[name] = json.load(f)
    k100, k1000 = curves['classical_awgn_k100'], curves['classical_awgn_k1000']
    tdist = curves['classical_nonawgn_k100']['channels']['t-dist_vv3']
    n100, n1000 = str(CURVE_BLOCKS), str(K1000_BLOCKS)
    runs = (  # name, argv, reference
        ('torch_mc_k100', ['-engine', 'torch_mc', '-snr_test_start', str(K100_POINTS[0]),
                           '-snr_test_end', str(K100_POINTS[-1]), '-snr_points',
                           str(len(K100_POINTS)), '-num_block', n100, '-batch_size', n100], k100),
        ('torch_k100', ['-engine', 'torch', '-snr_test_start', '-1', '-snr_test_end', '-1',
                        '-snr_points', '1', '-num_block', n100, '-batch_size', n100], k100),
        ('torch_tdist_vv3', ['-engine', 'torch', '-noise_type', 't-dist', '-vv', '3',
                             '-snr_test_start', '-1.5', '-snr_test_end', '-1.5', '-snr_points',
                             '1', '-num_block', n100, '-batch_size', n100], tdist),
        ('torch_mc_k1000', ['-engine', 'torch_mc', '-block_len', '1000', '-snr_test_start', '-1',
                            '-snr_test_end', '-1', '-snr_points', '1', '-num_block', n1000,
                            '-batch_size', n1000], k1000))
    points = []
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    for name, argv, ref in runs:
        res = turbo_benchmark.run_benchmark(turbo_benchmark.get_bench_args(
            argv + ['-num_dec_iter', str(CLASSICAL_ITERS), '-variant', 'hazzys', '-seed', '0',
                    '--device', str(dev)]))
        for i, snr in enumerate(res['snrs']):
            j = ref['snr'].index(snr)
            ref_n = ref['n_blocks'][j]
            ref_e = round(ref['bler'][j] * ref_n)
            n = res['n_blocks'][i]
            points.append({'run': name, 'snr': snr, 'bit_errors': res['bit_errors'][i],
                           'block_errors': res['block_errors'][i], 'n_blocks': n,
                           'ber': res['bers'][i], 'bler': res['blers'][i], 'ref_bler': ref['bler'][j],
                           'ref_block_errors': ref_e, 'ref_n_blocks': ref_n,
                           'z_bler': two_proportion_z(res['block_errors'][i], n, ref_e, ref_n),
                           'seconds': res['seconds'][i], 'blocks_per_s': n / res['seconds'][i]})
    counts = read_counts()
    emit('classical_curve', points=points, seconds=time.perf_counter() - t0, launches=counts,
         card=nvidia_smi())
    for pt in points:
        want = K1000_BLOCKS if pt['run'] == 'torch_mc_k1000' else CURVE_BLOCKS
        check(pt['n_blocks'] == want, f'classical_curve: blocks {pt}')
        check(abs(pt['z_bler']) < MAX_Z, f"classical_curve {pt['run']} at {pt['snr']} dB: {pt}")
    check(not any(counts.values()), f'classical_curve launched a conv-stack kernel: {counts}')
    return counts


def ldpc_fer_phase(dev):
    """cli/ldpc_benchmark.run, -engine torch, on the (96, 48) design at Eb/N0
    2.5 dB (SPA, 100 iterations, LDPC_FRAMES frames in batches of
    LDPC_BATCH, a frame-error target above that): FER within |z| < MAX_Z of
    JAX's LDPC_REF, reported beside the reference's LDPC_COMMPY_FER."""
    from turboae_tpu_torch.cli import ldpc_benchmark
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    sync(dev)
    reset_counts()
    res = ldpc_benchmark.run(ldpc_benchmark.get_args([
        '-engine', 'torch', '-ebn0_start', '2.5', '-points', '1', '-alg', 'SPA', '-n_iters', '100',
        '-batch', str(LDPC_BATCH), '-max_frames', str(LDPC_FRAMES), '-target_frame_errors',
        str(LDPC_FRAMES + 1), '-seed', '0', '--device', str(dev)]))
    counts = read_counts()
    fe, frames = res['frame_errors'][0], res['frames'][0]
    out = {'frame_errors': fe, 'frames': frames, 'fer': res['fers'][0], 'ber': res['bers'][0],
           'ref_frame_errors': LDPC_REF[0], 'ref_frames': LDPC_REF[1],
           'z_fer': two_proportion_z(fe, frames, *LDPC_REF), 'commpy_fer': LDPC_COMMPY_FER,
           'seconds': res['seconds'][0], 'frames_per_s': frames / res['seconds'][0]}
    emit('ldpc_fer', **out, launches=counts, card=nvidia_smi())
    check(frames == LDPC_FRAMES, f'ldpc_fer: {frames} frames')
    check(abs(out['z_fer']) < MAX_Z, f'ldpc_fer: {out}')
    check(not any(counts.values()), f'ldpc_fer launched a conv-stack kernel: {counts}')
    return counts


def viterbi_curve_phase(dev):
    """cli/conv_benchmark.run, -engine torch, [7,5] with unquantized metrics
    over AWGN at 0, 2 and 4 dB, VITERBI_BLOCKS a point, on the card and the
    same seeded run on the CPU: equal bit and block error counts."""
    from turboae_tpu_torch.cli import conv_benchmark
    from turboae_tpu_torch.utils.device import nvidia_smi
    argv = ['-engine', 'torch', '-snr_test_start', '0', '-snr_test_end', '4', '-snr_points', '3',
            '-num_block', str(VITERBI_BLOCKS), '-channel', 'awgn', '-decoding_type', 'unquantized',
            '-seed', '0']
    sync(dev)
    reset_counts()
    card = conv_benchmark.run(conv_benchmark.get_args(argv + ['--device', str(dev)]))
    counts = read_counts()
    cpu = conv_benchmark.run(conv_benchmark.get_args(argv + ['--device', 'cpu']))
    keys = ('bit_errors', 'block_errors', 'n_blocks')
    out = {'snrs': card['snrs'], 'gpu': {k: card[k] for k in keys + ('bers', 'blers', 'seconds')},
           'cpu': {k: cpu[k] for k in keys + ('seconds',)},
           'gpu_blocks_per_s': [VITERBI_BLOCKS / s for s in card['seconds']]}
    emit('viterbi_curve', **out, launches=counts, card=nvidia_smi())
    check(all(card[k] == cpu[k] for k in keys), f'viterbi_curve: card {card} cpu {cpu}')
    check(not any(counts.values()), f'viterbi_curve launched a conv-stack kernel: {counts}')
    return counts


def sync(dev):
    if torch.device(dev).type == 'cuda':
        torch.cuda.synchronize(dev)


def reset_counts():
    from turboae_tpu_torch.kernels import conv_stack as ks
    ks.conv_stack_bf16.launches = 0
    ks.conv_stack_f32.launches = 0


def read_counts():
    from turboae_tpu_torch.kernels import conv_stack as ks
    return {'conv_stack_bf16': ks.conv_stack_bf16.launches,
            'conv_stack_f32': ks.conv_stack_f32.launches}


def time_kernel(wrapper, plain, dtype, shape, layers, gen, dev):
    """CUDA-event ms of the kernel (a wrapper call, which packs the weights,
    and its launch alone on weights packed once), its plain version and five
    cuDNN conv1d + ELU in the kernel's type (TF32 off), with the bound of
    the same work: for bf16 its FLOP at the bf16 tensor-core peak; for f32
    three TF32 products a product (K1's 3xTF32) at the TF32 peak, with exact
    f32 at the FFMA peak beside it."""
    from turboae_tpu_torch.kernels import conv_stack as ks
    from turboae_tpu_torch.ops.conv1d import stack_init
    B, L, cin, c, k, nl = shape
    layers = layers or stack_init(gen, nl, cin, c, k, dev)
    x = torch.randn((B, L, cin), generator=gen).to(dev)
    ms = cuda_ms(lambda: wrapper(layers, x), iters=20)
    alone_ms = cuda_ms(ks.launch_alone(wrapper, layers, x), iters=20)
    plain_ms = cuda_ms(lambda: plain(layers, x), iters=10)
    # yardstick only, never called by the port
    xl = x.to(dtype).transpose(1, 2).contiguous()
    lw = [(p['w'].to(dtype), p['b'].to(dtype)) for p in layers]

    def library_chain():
        h = xl
        for w, b in lw:
            h = torch.nn.functional.elu(torch.nn.functional.conv1d(h, w, b, padding=k // 2))
        return h
    library_ms = cuda_ms(library_chain, iters=20)
    from turboae_tpu_torch.kernels.conv_stack import conv_stack_work
    from turboae_tpu_torch.utils.flops import PEAKS
    # the card's published dense peaks at its full power limit (utils/flops.py)
    peaks = PEAKS.get(torch.cuda.get_device_name(dev))
    check(peaks is not None, f'no peaks for {torch.cuda.get_device_name(dev)} in utils/flops.py')
    itemsize = torch.finfo(dtype).bits // 8
    flops, nbytes = conv_stack_work(B, L, cin, c, k, nl, itemsize)
    if dtype == torch.bfloat16:
        peak, products, extra = peaks['bfloat16'], flops, {}
    else:
        # K1 does three TF32 products a product (3xTF32); exact f32 without
        # the tensor cores is bound by the FFMA peak
        peak, products = peaks['tf32'], 3 * flops
        extra = {'ffma_bound_ms': flops / peaks['float32'] * 1e3}
    compute_ms = products / peak * 1e3
    memory_ms = nbytes / peaks['bytes_per_s'] * 1e3
    return {'shape': list(shape), 'ms': ms, 'alone_ms': alone_ms, 'plain_ms': plain_ms,
            'library_ms': library_ms,
            'flops': flops, 'tensor_core_flops': products, 'bytes': nbytes, 'peak_flops': peak,
            'compute_bound_ms': compute_ms, **extra, 'memory_bound_ms': memory_ms,
            'bound_ms': max(compute_ms, memory_ms),
            'bound_by': 'operations' if compute_ms >= memory_ms else 'bytes',
            'achieved_tflops': flops / ms / 1e9}


def train_step_parity(crown, crown_cpu, dev, gen, batch=PARITY_BATCH):
    """One step of each mode in f32, unfused, on the card and on the CPU from
    the same params, bits and noise (drawn on the host, noise at the
    decoder's training SNR mix). Tolerances: the loss to 1e-4 relative (f32,
    summation order only); gradients per leaf to 1e-3 of the leaf's largest;
    Adam's first step is ~lr * sign(g), so where |g| is below 1e-3 of the
    leaf's largest the sign is within the gradient tolerance and the update
    may flip (2 lr); elsewhere updated params agree to 1e-2 * lr."""
    from turboae_tpu_torch.channels.noise import train_sigma
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    bits = (torch.rand((batch, 100, 1), generator=gen) < 0.5).float()
    noise = train_sigma((batch, 100, 3), -1.5, 2.0, gen, 'cpu') * \
        torch.randn((batch, 100, 3), generator=gen)
    for mode, extra in (('decoder', {}), ('encoder', {}), ('joint', {}),
                        ('encoder', {'train_channel_mode': 'block_norm_ste'})):
        cfg = Config(batch_size=batch, **extra)
        out = {}
        for where, params in (('gpu', crown), ('cpu', crown_cpu)):
            tr = Trainer(cfg, dev if where == 'gpu' else 'cpu', params=params)
            loss, grads = tr.loss_and_grads(mode, bits.to(tr.device), noise.to(tr.device))
            step_loss = tr._train_step(mode, bits.to(tr.device), noise.to(tr.device))
            out[where] = (loss.item(), step_loss.item(),
                          {h: [g.cpu() for g in gs] for h, gs in grads.items()},
                          {h: [p.cpu() for p in tr._leaves[h]] for h in grads})
        (lg, sg, gg, pg), (lc, sc, gc, pc) = out['gpu'], out['cpu']
        loss_rel = abs(lg - lc) / abs(lc)
        grad_rel, firm_dp, max_dp = 0.0, 0.0, 0.0
        for h in gc:
            lr = cfg.enc_lr if h == 'enc' else cfg.dec_lr
            for a, b, p, q in zip(gg[h], gc[h], pg[h], pc[h]):
                scale = b.abs().max().item()
                grad_rel = max(grad_rel, (a - b).abs().max().item() / scale)
                firm = b.abs() > 1e-3 * scale
                dp = (p - q).abs() / lr
                firm_dp = max(firm_dp, dp[firm].max().item() if firm.any() else 0.0)
                max_dp = max(max_dp, dp.max().item())
        emit('train_step', mode=mode, **extra, batch=batch, loss_gpu=lg, loss_cpu=lc,
             loss_rel=loss_rel, grad_rel=grad_rel, param_diff_firm_over_lr=firm_dp,
             param_diff_max_over_lr=max_dp)
        check(math.isfinite(lg) and abs(sg - lg) <= 1e-6 * abs(lg) and sc == lc,
              f'{mode}: the step did not see the loss it was given')
        check(loss_rel < 1e-4, f'{mode}: loss differs from the CPU by {loss_rel}')
        check(grad_rel < 1e-3, f'{mode}: gradients differ from the CPU by {grad_rel}')
        check(firm_dp < 1e-2 and max_dp <= 2.002, f'{mode}: updated params differ')


# ---------------------------------------------------------------- data parallelism (M16)
def dist_train_work(dev, mesh, out_path=None):
    """The data-parallel flagship at full width (TurboAE_rate3_cnn, C=100, 6
    iterations, K=100) from the crown's params, on `mesh` or, with None, in
    this one process: a decoder step and an encoder step, each from the
    crown, in f32 at global batch DIST_BATCH from the generator seeded by
    cfg.seed (loss_and_grads, then the phase's Adam step), then
    DIST_TIMED_STEPS decoder steps timed; a fused bf16 forward of a global batch drawn on the
    card (this rank's rows through K2); the crown's sweep counts at -1 dB,
    DIST_SWEEP_BLOCKS blocks in one global batch (bf16, fused). Under a gloo
    mesh, steps_per_call 2 must raise. Returns a dict; the gradients and
    params of the two steps, the forward's rows and the sweep's outputs (this
    rank's rows) go to out_path (torch.save) when given."""
    from turboae_tpu_torch.cli.eval_flagship import load_flagship
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.dist import mesh as dm
    from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms
    from turboae_tpu_torch.train import sweep as sweep_mod
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    crown = load_flagship(os.path.join(ROOT, 'artifacts', 'flagship.msgpack'), dev)
    cfg = Config(batch_size=DIST_BATCH)
    losses, grads, params = [], {}, {}
    for mode, h in (('decoder', 'dec'), ('encoder', 'enc')):
        tr = Trainer(cfg, dev, params=crown, mesh=mesh)
        loss, g = tr.loss_and_grads(mode, tr._bits(), tr._noise(mode))
        tr.opt[h].step(g[h])
        losses.append(float(loss))
        grads[h] = [x.cpu() for x in g[h]]
        params[h] = [p.detach().cpu() for p in tr._leaves[h]]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(DIST_TIMED_STEPS):
        tr._train_step('decoder')
    sync(dev)
    step_ms = (time.perf_counter() - t0) / DIST_TIMED_STEPS * 1e3

    fused = Config(batch_size=DIST_BATCH, dtype='bfloat16', use_fused_conv=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    bits = (torch.rand((DIST_BATCH, 100, 1), generator=gen, device=dev) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((DIST_BATCH, 100, 3), generator=gen, device=dev)
    sweep_out = []
    real = sweep_mod.error_counts

    def recording(b, out):
        sweep_out.append(out.float().cpu())
        return real(b, out)
    sync(dev)
    reset_counts()
    with dm.active(mesh), torch.inference_mode():
        rows = [dm.shard_rows(t, mesh) for t in (bits, noise)]
        out = forward_ae(crown, fused, *rows, make_perms(fused, dev), training=False)[0]
    sweep_mod.error_counts = recording
    try:
        res = sweep_mod.sweep(crown, fused.replace(batch_size=SWEEP_BATCH), [-1.0],
                              num_block=DIST_SWEEP_BLOCKS, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    finally:
        sweep_mod.error_counts = real
    sync(dev)
    launches = read_counts()
    refused = None
    if mesh is not None and mesh.backend == 'gloo':
        try:
            Trainer(cfg.replace(steps_per_call=2, num_block=2 * DIST_BATCH), dev, params=crown,
                    mesh=mesh).train_epoch(0, 'decoder', verbose=False)
        except RuntimeError as e:
            refused = str(e)
    if out_path:
        torch.save({'grads': grads, 'params': params, 'out': out.float().cpu(),
                    'sweep_out': torch.cat(sweep_out)}, out_path)
    return {'losses': losses, 'step_ms': step_ms, 'launches': launches,
            'sweep': {'bit_errors': res['bit_errors'][0], 'blk_errors': res['blk_errors'][0],
                      'n_blocks': res['n_blocks']},
            'gloo_graph_refused': refused}


def dist_train_phase(dev):
    """Two gloo ranks on cuda:0, each its own process (`chip_smoke.py
    --dist-rank`), against this process alone on the same card
    (dist_train_work): the losses within 1e-5 relative, the gradients within
    DIST_GRAD_TOL of each leaf's largest, the params after Adam's step within
    rtol 1e-4 / atol 1e-5 wherever the gradient exceeds 1e-3 of its leaf's
    largest and within 2 lr elsewhere (Adam's first step is ~lr * g / |g|,
    which turns a reordered sum of a near-zero gradient into up to 2 lr:
    train_step_parity's rule), both ranks alike; the fused forward's decisions
    > 99.9 % agreeing with this process's rows; the sweep's decisions equal
    but where this process's output lies within DIST_NEAR of 0.5 (counted
    and printed), its counts apart by those at most; 12 K2 launches a
    forward and a sweep batch on each rank; steps_per_call 2 under gloo
    refused. Returns the launches of the two ranks' paths."""
    import tempfile
    from turboae_tpu_torch.utils.device import nvidia_smi
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as d:
            ref_path = os.path.join(d, 'one.pt')
            ref = dist_train_work(dev, None, ref_path)
            ranks = rank_results(start_ranks('dist_train', DIST_RANKS, d), 'dist_train', d)
            one = torch.load(ref_path)
    finally:
        torch.backends.cudnn.deterministic = False
    seconds = time.perf_counter() - t0
    agreement = step_agreement(ranks, ref['losses'], one)
    loss_rel, grad_rel = agreement['loss_rel'], agreement['grad_rel']
    firm_over_tol = agreement['firm_param_err_over_tol']
    moved_over_lr = agreement['param_diff_max_over_lr']
    ranks_alike = all(torch.equal(a, b) for h in one['params'] for a, b in
                      zip(ranks[0]['tensors']['params'][h], ranks[1]['tensors']['params'][h]))
    rows = one['out'].chunk(DIST_RANKS)
    agree = min((r['tensors']['out'].round() == rows[i].round()).float().mean().item()
                for i, r in enumerate(ranks))
    fwd_diff = max((r['tensors']['out'] - rows[i]).abs().max().item() for i, r in enumerate(ranks))
    launches = {k: sum(r['launches'][k] for r in ranks) for k in ranks[0]['launches']}
    sweeps = [r['sweep'] for r in ranks]
    sweep_flips, flips_near, outputs_near = _decisions_apart(
        torch.cat([r['tensors']['sweep_out'] for r in ranks]), one['sweep_out'])
    emit('dist_train', ranks=DIST_RANKS, backend='gloo', global_batch=DIST_BATCH,
         losses_one=ref['losses'], losses_ranks=[r['losses'] for r in ranks], loss_rel=loss_rel,
         grad_rel=grad_rel, firm_param_err_over_tol=firm_over_tol,
         param_diff_max_over_lr=moved_over_lr, ranks_alike=ranks_alike,
         forward_max_abs_diff=fwd_diff,
         forward_decision_agreement=agree, sweep_one=ref['sweep'], sweep_ranks=sweeps,
         sweep_decisions_flipped=sweep_flips, flipped_within_near=flips_near,
         outputs_within_near=outputs_near, step_ms_one=ref['step_ms'],
         step_ms_ranks=[r['step_ms'] for r in ranks], launches_one=ref['launches'],
         launches_ranks=[r['launches'] for r in ranks],
         gloo_graph_refused=ranks[0]['gloo_graph_refused'], seconds=seconds, card=nvidia_smi())
    check(loss_rel < 1e-5, f'dist_train: losses {ref["losses"]} vs {[r["losses"] for r in ranks]}')
    check(grad_rel < DIST_GRAD_TOL, f'dist_train: gradients differ by {grad_rel}')
    check(firm_over_tol <= 1.0 and moved_over_lr <= 2.002 and ranks_alike,
          f'dist_train: params {firm_over_tol} of the tolerance, {moved_over_lr} lr')
    check(agree > 0.999, f'dist_train: fused forward decisions agree {agree}')
    check(sweep_flips == flips_near, f'dist_train: {sweep_flips} sweep decisions flipped, '
          f'{flips_near} of them within {DIST_NEAR} of 0.5')
    for s in sweeps:
        check(s['n_blocks'] == ref['sweep']['n_blocks'] == DIST_SWEEP_BLOCKS
              and abs(s['blk_errors'] - ref['sweep']['blk_errors']) <= sweep_flips
              and abs(s['bit_errors'] - ref['sweep']['bit_errors']) <= sweep_flips,
              f'dist_train: sweep counts {sweeps} vs {ref["sweep"]}')
    for r in ranks:
        check(r['launches']['conv_stack_bf16'] == 12 * (1 + DIST_SWEEP_BLOCKS // SWEEP_BATCH),
              f"dist_train: K2 launched {r['launches']} times on a rank")
        check(r['gloo_graph_refused'] is not None and 'captured' in r['gloo_graph_refused'],
              'dist_train: steps_per_call 2 under gloo was not refused')
    return launches


def step_agreement(ranks, ref_losses, one, lr=1e-3) -> dict:
    """The ranks' losses, gradients and params after Adam's step against one
    process's: the losses' largest relative difference, the gradients'
    largest difference relative to each leaf's largest, the params'
    difference over rtol 1e-4 / atol 1e-5 where the gradient exceeds 1e-3 of
    its leaf's largest, and over lr anywhere (Adam's first step is ~lr * g /
    |g|: a reordered sum of a near-zero gradient moves it by up to 2 lr)."""
    loss_rel = max(abs(a - b) / abs(b) for r in ranks for a, b in zip(r['losses'], ref_losses))
    grad_rel = max(((a - b).abs().max() / b.abs().max()).item()
                   for r in ranks for h in one['grads']
                   for a, b in zip(r['tensors']['grads'][h], one['grads'][h]))
    firm_over_tol, moved_over_lr = 0.0, 0.0
    for r in ranks:
        for h in one['params']:
            for a, b, g in zip(r['tensors']['params'][h], one['params'][h], one['grads'][h]):
                firm = g.abs() > 1e-3 * g.abs().max()
                over = (a - b).abs() / (1e-5 + 1e-4 * b.abs())
                firm_over_tol = max(firm_over_tol, over[firm].max().item() if firm.any() else 0.0)
                moved_over_lr = max(moved_over_lr, (a - b).abs().max().item() / lr)
    return {'loss_rel': loss_rel, 'grad_rel': grad_rel, 'firm_param_err_over_tol': firm_over_tol,
            'param_diff_max_over_lr': moved_over_lr}


def start_ranks(work: str, world: int, d: str):
    """Starts `world` gloo ranks of `work` on cuda:0, each its own process
    (`chip_smoke.py --dist-rank <d>/<work><rank> <work>`), writing into d."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR='localhost', MASTER_PORT=str(port),
                   RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK='0')
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--dist-rank',
             os.path.join(d, f'{work}{rank}'), work], env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True))
    return procs


def rank_results(procs, work: str, d: str) -> list:
    """Each rank's result (its JSON, with its tensors under 'tensors') once
    every process has ended; fails the phase as wait_all does."""
    wait_all(procs, work)
    ranks = []
    for rank in range(len(procs)):
        with open(os.path.join(d, f'{work}{rank}.json')) as f:
            ranks.append(json.load(f))
        ranks[-1]['tensors'] = torch.load(os.path.join(d, f'{work}{rank}.pt'))
    return ranks


def dist_rank_main(out_prefix: str, work: str = 'dist_train') -> int:
    """`chip_smoke.py --dist-rank <prefix> <work>`: one gloo rank of
    dist_train, time_shard or mesh_2d on cuda:0 (RANK, WORLD_SIZE,
    MASTER_ADDR and MASTER_PORT from the environment); writes <prefix>.json
    and <prefix>.pt."""
    sys.path.insert(0, ROOT)
    from turboae_tpu_torch.dist import mesh as dm
    from turboae_tpu_torch.utils.device import no_tf32
    no_tf32()
    torch.backends.cudnn.deterministic = True
    dev = torch.device('cuda', 0)
    rank, world, _ = dm.launch_env()
    dm.initialize_distributed('env://', world, rank, 'gloo')
    fn, shape = {'dist_train': (dist_train_work, (world,)),
                 'time_shard': (time_shard_work, (world,)),
                 'mesh_2d': (mesh_2d_work, MESH_2D)}[work]
    res = fn(dev, dm.make_mesh(shape, dev), out_prefix + '.pt')
    with open(out_prefix + '.json', 'w') as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()
    return 0


# ---------------------------------------------------------------- sequence parallelism, 2-D meshes (M16b)
def _decisions_apart(got, ref):
    """(decisions flipped, of them within DIST_NEAR of 0.5 in ref, outputs
    within DIST_NEAR of 0.5) of two outputs of the same blocks."""
    flipped = got.round() != ref.round()
    near = (ref - 0.5).abs() < DIST_NEAR
    return int(flipped.sum()), int((flipped & near).sum()), int(near.sum())


def time_shard_work(dev, mesh, out_path=None):
    """The K=1000 flagship (artifacts/flagship_k1000.msgpack: C=100, 6
    iterations, 5-layer stacks) under shard_axis 'time' on `mesh`, or with
    None in this one process: a decoder and an encoder step from the file's
    params in f32 at global batch TIME_BATCH (loss_and_grads, then the
    phase's Adam step), TIME_TIMED_STEPS decoder steps timed; the bf16
    forward through K2 on this rank's halo windows of a global batch drawn
    on the card (its positions of the output kept); one sweep batch at 0 dB
    (bf16, fused). Returns a dict; the gradients, params and outputs go to
    out_path (torch.save) when given."""
    from turboae_tpu_torch.cli.eval_flagship import load_flagship
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.dist import mesh as dm
    from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms
    from turboae_tpu_torch.train import sweep as sweep_mod
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    k1000 = load_flagship(os.path.join(ROOT, 'artifacts', 'flagship_k1000.msgpack'), dev)
    cfg = Config(batch_size=TIME_BATCH, block_len=1000, shard_axis='time')
    losses, grads, params = [], {}, {}
    for mode, h in (('decoder', 'dec'), ('encoder', 'enc')):
        tr = Trainer(cfg, dev, params=k1000, mesh=mesh)
        loss, g = tr.loss_and_grads(mode, tr._bits(), tr._noise(mode))
        tr.opt[h].step(g[h])
        losses.append(float(loss))
        grads[h] = [x.cpu() for x in g[h]]
        params[h] = [p.detach().cpu() for p in tr._leaves[h]]
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(TIME_TIMED_STEPS):
        tr._train_step('decoder')
    sync(dev)
    step_ms = (time.perf_counter() - t0) / TIME_TIMED_STEPS * 1e3

    fused = cfg.replace(dtype='bfloat16', use_fused_conv=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    bits = (torch.rand((TIME_BATCH, 1000, 1), generator=gen, device=dev) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((TIME_BATCH, 1000, 3), generator=gen, device=dev)
    sweep_out = []
    real = sweep_mod.error_counts

    def recording(b, out):
        sweep_out.append(out.float().cpu())
        return real(b, out)
    sync(dev)
    reset_counts()
    tmesh = dm.along(mesh, 'time')
    with dm.active(tmesh), torch.inference_mode():
        rows = [dm.shard_rows(t, tmesh) for t in (bits, noise)]
        out = forward_ae(k1000, fused, *rows, make_perms(fused, dev), training=False)[0]
    sync(dev)
    forward_launches = read_counts()
    sweep_mod.error_counts = recording
    try:
        res = sweep_mod.sweep(k1000, fused, [0.0], num_block=TIME_BATCH, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(0), mesh=mesh)
    finally:
        sweep_mod.error_counts = real
    sync(dev)
    launches = read_counts()
    if out_path:
        torch.save({'grads': grads, 'params': params, 'out': out.float().cpu(),
                    'sweep_out': torch.cat(sweep_out)}, out_path)
    return {'losses': losses, 'step_ms': step_ms, 'launches': launches,
            'forward_launches': forward_launches,
            'positions': list(out.shape[1:2]),
            'sweep': {'bit_errors': res['bit_errors'][0], 'blk_errors': res['blk_errors'][0],
                      'n_blocks': res['n_blocks']}}


def mesh_2d_work(dev, mesh, out_path=None):
    """The crown at full width on a (2, 2) mesh (the batch over the data
    axis, two replicas of each share), or with None in this one process: an
    f32 decoder step from the crown at global batch DIST_BATCH
    (loss_and_grads, then Adam's step), and a fused bf16 forward of this
    rank's rows of a global batch drawn on the card (K2). Returns a dict;
    the gradients, params and output go to out_path when given."""
    from turboae_tpu_torch.cli.eval_flagship import load_flagship
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.dist import mesh as dm
    from turboae_tpu_torch.models.channel_ae import forward_ae, make_perms
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.metrics import snr_db2sigma
    crown = load_flagship(os.path.join(ROOT, 'artifacts', 'flagship.msgpack'), dev)
    tr = Trainer(Config(batch_size=DIST_BATCH), dev, params=crown, mesh=mesh)
    loss, g = tr.loss_and_grads('decoder', tr._bits(), tr._noise('decoder'))
    tr.opt['dec'].step(g['dec'])
    fused = Config(batch_size=DIST_BATCH, dtype='bfloat16', use_fused_conv=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    bits = (torch.rand((DIST_BATCH, 100, 1), generator=gen, device=dev) < 0.5).float()
    noise = snr_db2sigma(0.0) * torch.randn((DIST_BATCH, 100, 3), generator=gen, device=dev)
    sync(dev)
    reset_counts()
    with dm.active(mesh), torch.inference_mode():
        rows = [dm.shard_rows(t, mesh) for t in (bits, noise)]
        out = forward_ae(crown, fused, *rows, make_perms(fused, dev), training=False)[0]
    sync(dev)
    if out_path:
        torch.save({'grads': {'dec': [x.cpu() for x in g['dec']]},
                    'params': {'dec': [p.detach().cpu() for p in tr._leaves['dec']]},
                    'out': out.float().cpu()}, out_path)
    return {'losses': [float(loss)], 'launches': read_counts(),
            'coords': None if mesh is None else [mesh.data, mesh.model]}


def time_shard_phase(dev, started):
    """Two gloo ranks on cuda:0 under shard_axis 'time' (`chip_smoke.py
    --dist-rank ... time_shard`, started with start_ranks) against this
    process alone (time_shard_work): the f32 steps under dist_train's
    tolerances and its Adam rule; the bf16 forward's decisions (the ranks'
    positions side by side) equal but where this process's output lies
    within DIST_NEAR of 0.5 (counted and printed); the sweep batch's counts
    apart by the sweep's such flips at most; 12 K2 launches a forward on
    each rank, on its halo windows (500 + 10 positions). Returns the ranks'
    launches."""
    import shutil
    from turboae_tpu_torch.utils.device import nvidia_smi
    procs, d, t0 = started
    torch.backends.cudnn.deterministic = True
    try:
        ref = time_shard_work(dev, None, os.path.join(d, 'one.pt'))
        ranks = rank_results(procs, 'time_shard', d)
        one = torch.load(os.path.join(d, 'one.pt'))
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(d, ignore_errors=True)
    agreement = step_agreement(ranks, ref['losses'], one)
    ranks_alike = all(torch.equal(a, b) for h in one['params'] for a, b in
                      zip(ranks[0]['tensors']['params'][h], ranks[1]['tensors']['params'][h]))
    fwd = _decisions_apart(torch.cat([r['tensors']['out'] for r in ranks], dim=1), one['out'])
    sw = _decisions_apart(torch.cat([r['tensors']['sweep_out'] for r in ranks], dim=1),
                          one['sweep_out'])
    launches = {k: sum(r['launches'][k] for r in ranks) for k in ranks[0]['launches']}
    sweeps = [r['sweep'] for r in ranks]
    emit('time_shard', ranks=TIME_RANKS, backend='gloo', shard_axis='time', block_len=1000,
         global_batch=TIME_BATCH, positions_per_rank=[r['positions'] for r in ranks],
         losses_one=ref['losses'], losses_ranks=[r['losses'] for r in ranks], **agreement,
         ranks_alike=ranks_alike, forward_flipped=fwd[0], forward_flipped_within_near=fwd[1],
         forward_outputs_within_near=fwd[2], sweep_one=ref['sweep'], sweep_ranks=sweeps,
         sweep_flipped=sw[0], sweep_flipped_within_near=sw[1],
         step_ms_one=ref['step_ms'], step_ms_ranks=[r['step_ms'] for r in ranks],
         launches_one=ref['launches'], launches_ranks=[r['launches'] for r in ranks],
         seconds=time.perf_counter() - t0, card=nvidia_smi())
    check(agreement['loss_rel'] < 1e-5, f'time_shard: losses {ref["losses"]} vs '
          f'{[r["losses"] for r in ranks]}')
    check(agreement['grad_rel'] < DIST_GRAD_TOL, f'time_shard: gradients {agreement}')
    check(agreement['firm_param_err_over_tol'] <= 1.0
          and agreement['param_diff_max_over_lr'] <= 2.002 and ranks_alike,
          f'time_shard: params {agreement}, ranks alike {ranks_alike}')
    check(all(r['positions'] == [1000 // TIME_RANKS] for r in ranks),
          f"time_shard: positions {[r['positions'] for r in ranks]}")
    check(fwd[0] == fwd[1], f'time_shard: {fwd[0]} forward decisions flipped, {fwd[1]} '
          f'of them within {DIST_NEAR} of 0.5')
    check(sw[0] == sw[1], f'time_shard: {sw[0]} sweep decisions flipped, {sw[1]} near 0.5')
    for s in sweeps:
        check(s['n_blocks'] == ref['sweep']['n_blocks'] == TIME_BATCH
              and abs(s['blk_errors'] - ref['sweep']['blk_errors']) <= sw[0]
              and abs(s['bit_errors'] - ref['sweep']['bit_errors']) <= sw[0],
              f'time_shard: sweep counts {sweeps} vs {ref["sweep"]}')
    for r in ranks:
        check(r['forward_launches']['conv_stack_bf16'] == 12
              and r['launches']['conv_stack_bf16'] == 24,
              f"time_shard: K2 launched {r['forward_launches']}, {r['launches']} on a rank")
    return launches


def mesh_2d_phase(dev, started):
    """Four gloo ranks on cuda:0 on a (2, 2) mesh (`chip_smoke.py
    --dist-rank ... mesh_2d`) against this process alone (mesh_2d_work):
    the two replicas of each data index bit-equal (loss, gradients, params,
    forward); the decoder step under dist_train's tolerances and Adam rule;
    the fused forward's decisions > 99.9 % those of this process's rows of
    that data index; 12 K2 launches a rank. Returns the ranks' launches."""
    import shutil
    from turboae_tpu_torch.utils.device import nvidia_smi
    procs, d, t0 = started
    torch.backends.cudnn.deterministic = True
    try:
        ref = mesh_2d_work(dev, None, os.path.join(d, 'one.pt'))
        ranks = rank_results(procs, 'mesh_2d', d)
        one = torch.load(os.path.join(d, 'one.pt'))
    finally:
        torch.backends.cudnn.deterministic = False
        shutil.rmtree(d, ignore_errors=True)
    n, m = MESH_2D

    def same(a, b):
        ta, tb = a['tensors'], b['tensors']
        return (a['losses'] == b['losses'] and torch.equal(ta['out'], tb['out'])
                and all(torch.equal(x, y) for k in ('grads', 'params')
                        for x, y in zip(ta[k]['dec'], tb[k]['dec'])))
    replicas_equal = [same(ranks[i * m], ranks[i * m + j]) for i in range(n) for j in range(1, m)]
    agreement = step_agreement(ranks, ref['losses'], one)
    rows = one['out'].chunk(n)
    agree = min((r['tensors']['out'].round() == rows[r['coords'][0]].round()).float().mean().item()
                for r in ranks)
    launches = {k: sum(r['launches'][k] for r in ranks) for k in ranks[0]['launches']}
    emit('mesh_2d', mesh=list(MESH_2D), backend='gloo', global_batch=DIST_BATCH,
         coords=[r['coords'] for r in ranks], replicas_bit_equal=replicas_equal,
         losses_one=ref['losses'], losses_ranks=[r['losses'] for r in ranks], **agreement,
         forward_decision_agreement=agree, launches_one=ref['launches'],
         launches_ranks=[r['launches'] for r in ranks], seconds=time.perf_counter() - t0,
         card=nvidia_smi())
    check([r['coords'] for r in ranks] == [[i, j] for i in range(n) for j in range(m)],
          f"mesh_2d: coordinates {[r['coords'] for r in ranks]}")
    check(all(replicas_equal), f'mesh_2d: replicas differ {replicas_equal}')
    check(agreement['loss_rel'] < 1e-5 and agreement['grad_rel'] < DIST_GRAD_TOL
          and agreement['firm_param_err_over_tol'] <= 1.0
          and agreement['param_diff_max_over_lr'] <= 2.002, f'mesh_2d: {agreement}')
    check(agree > 0.999, f'mesh_2d: fused forward decisions agree {agree}')
    for r in ranks:
        check(r['launches']['conv_stack_bf16'] == 12, f"mesh_2d: K2 launched {r['launches']}")
    return launches


def start_sharded():
    """Starts time_shard's and mesh_2d's ranks, each set in its own new
    directory: {work: (processes, directory, started)}."""
    import tempfile
    out = {}
    for work, world in (('time_shard', TIME_RANKS), ('mesh_2d', MESH_2D[0] * MESH_2D[1])):
        d = tempfile.mkdtemp(prefix=f'{work}_')
        out[work] = (start_ranks(work, world, d), d, time.perf_counter())
    return out


def nccl_graph_check(dev, mesh):
    """steps_per_call under an NCCL mesh: GRAPH_N decoder steps a replay, 2
    replays, against 2 * GRAPH_N eager steps of a trainer on the same mesh
    from the same seeded init (f32, unfused, batch DIST_BATCH, cuDNN
    deterministic): the graph is kept only if its losses lie within 1e-5
    relative of the eager ones, as graph_steps holds a single process."""
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.tree import tree_leaves
    cfg = Config(batch_size=DIST_BATCH)
    eager = Trainer(cfg, dev, mesh=mesh)
    le = torch.stack([eager._train_step('decoder') for _ in range(2 * GRAPH_N)])
    graph = Trainer(cfg, dev, mesh=mesh)
    try:
        lg = torch.cat(graph._train_steps('decoder', GRAPH_N, 2))
    except Exception as e:      # reported, then failed by the phase's check
        return {'captured': False, 'error': f'{type(e).__name__}: {e}'}
    return {'captured': True, 'losses_eager': le.tolist(), 'losses_graph': lg.tolist(),
            'loss_rel': ((lg - le).abs() / le.abs()).max().item(),
            'param_rel': max(((a - b).abs().max() / b.abs().max()).item() for a, b in
                             zip(tree_leaves(graph.params), tree_leaves(eager.params)))}


def cli_rank_main(out_path: str, argv) -> int:
    """`chip_smoke.py --cli-rank <out.json> <cli/main.py argv>` under torchrun:
    joins the NCCL group on cuda:LOCAL_RANK, runs nccl_graph_check on the
    mesh, then cli/main.py's main (which finds the group up and leaves it at
    its end); writes the check, K2's launches in the CLI and its seconds."""
    sys.path.insert(0, ROOT)
    from turboae_tpu_torch.cli import main as cli_main
    from turboae_tpu_torch.dist import mesh as dm
    from turboae_tpu_torch.utils.device import no_tf32
    no_tf32()
    rank, world, local = dm.launch_env()
    dev = torch.device('cuda', local)
    torch.cuda.set_device(dev)
    dm.initialize_distributed('env://', world, rank, 'nccl')
    torch.backends.cudnn.deterministic = True
    graph = nccl_graph_check(dev, dm.make_mesh((world,), dev))
    torch.backends.cudnn.deterministic = False
    sync(dev)
    reset_counts()
    t0 = time.perf_counter()
    trainer = cli_main.main(list(argv))
    sync(dev)
    res = {'graph': graph, 'launches': read_counts(), 'seconds': time.perf_counter() - t0,
           'mesh': [trainer.mesh.size, trainer.mesh.backend],
           'test_bler': trainer.last_test['bler']}
    with open(out_path, 'w') as f:
        json.dump(res, f)
    return 0


def start_dist_cli():
    """Starts dist_cli: torchrun --nproc_per_node 1 over cli_rank_main and
    cli/main.py at full width (-mesh_shape 1, bf16, fused, one epoch of
    2 + 2 steps at batch 500, then its test at -1 dB) in a new directory.
    Returns (process, directory, started)."""
    import tempfile
    d = tempfile.mkdtemp(prefix='dist_cli_')
    argv = ['-mesh_shape', '1', '-num_epoch', '1', '-num_train_dec', '1', '-num_block',
            str(2 * DIST_BATCH), '-batch_size', str(DIST_BATCH), '-dtype', 'bfloat16',
            '--use_fused_conv', '-snr_points', '1', '-snr_test_start', '-1', '-snr_test_end',
            '-1']
    proc = subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node', '1',
         '--master_port', str(free_port()), os.path.abspath(__file__), '--cli-rank',
         os.path.join(d, 'rank.json'), *argv],
        cwd=d, text=True, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=dict(os.environ, PYTHONPATH=ROOT), start_new_session=True)
    return proc, d, time.perf_counter()


def dist_cli_phase(started):
    """dist_cli's result: the NCCL graph check, one epoch through cli/main.py
    whose checkpoint rank 0 wrote and which loads into the flagship's
    template, trained away from the seeded init; K2's launches in it.
    Returns those launches."""
    import shutil
    from turboae_tpu_torch.config import Config
    from turboae_tpu_torch.train.checkpoint import load_checkpoint
    from turboae_tpu_torch.train.trainer import Trainer
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.tree import tree_leaves
    proc, d, t0 = started
    wait_all([proc], 'dist_cli')
    with open(os.path.join(d, 'rank.json')) as f:
        res = json.load(f)
    ckpts = os.listdir(os.path.join(d, 'tmp'))
    logs = os.listdir(os.path.join(d, 'logs'))
    init = Trainer(Config(), 'cpu')
    init.params, init.opt_state, _ = load_checkpoint(os.path.join(d, 'tmp', ckpts[0]),
                                                     init.params, init.opt_state)
    fresh = Trainer(Config(), 'cpu')
    moved = max((a - b).abs().max().item() for a, b in
                zip(tree_leaves(init.params), tree_leaves(fresh.params)))
    shutil.rmtree(d)
    g = res['graph']
    emit('dist_cli', backend='nccl', ranks=1, nccl_graph=g, checkpoints=ckpts, logs=logs,
         adam_counts={h: init.opt[h].count for h in init.opt}, param_moved=moved,
         test_bler=res['test_bler'], launches=res['launches'],
         cli_seconds=res['seconds'], seconds=time.perf_counter() - t0, card=nvidia_smi())
    check(g['captured'] and g['loss_rel'] < 1e-5, f'dist_cli: NCCL graph steps {g}')
    check(len(ckpts) == 1 and len(logs) == 1 and moved > 0
          and init.opt['enc'].count == init.opt['dec'].count == 2,
          f'dist_cli: checkpoint {ckpts}, logs {logs}, moved {moved}, Adam counts '
          f'{[o.count for o in init.opt.values()]}')
    check(res['mesh'] == [1, 'nccl'], f"dist_cli: mesh {res['mesh']}")
    check(res['launches']['conv_stack_bf16'] > 0, f"dist_cli: K2 launched {res['launches']}")
    return res['launches']


def native_parity_phase(dev):
    """The port's C++ oracle (f64, on the host) against the card's decoders
    (f32): g++'s build seconds; Turbo-757 hazzys (6 iterations, NATIVE_B
    blocks of L=100 at -1 dB) decisions equal except where the card's |LLR|
    < CLASSICAL_NEAR_ZERO, which it counts; [7,5] Viterbi (unquantized and
    tdist3) decisions equal; one `-engine native` point of cli/turbo_benchmark
    (-1 dB, NATIVE_CURVE_BLOCKS blocks) with its blocks/s, its BLER held by
    |z| < MAX_Z to classical_awgn_k100.json, the anchor classical_curve uses."""
    import numpy as np
    from turboae_tpu_torch import native
    from turboae_tpu_torch.classical.convcode import conv_encode_batch, make_viterbi
    from turboae_tpu_torch.classical.interleavers import RandInterlv
    from turboae_tpu_torch.classical.trellis import Trellis, turbo757_trellis
    from turboae_tpu_torch.classical.turbo import make_turbo_decoder, turbo_encode_batch
    from turboae_tpu_torch.cli import turbo_benchmark
    from turboae_tpu_torch.utils.device import nvidia_smi
    from turboae_tpu_torch.utils.metrics import two_proportion_z
    t0 = time.perf_counter()
    native.build()
    build_s = native.last_build_seconds
    trellis, inter = turbo757_trellis(), RandInterlv(CLASSICAL_L, 0)
    rng = np.random.RandomState(7)
    sigma = 10 ** (1.0 / 20)
    msgs = rng.randint(0, 2, (NATIVE_B, CLASSICAL_L))
    rx = 2.0 * turbo_encode_batch(msgs, trellis, inter.p_array) - 1.0 + \
        sigma * rng.randn(NATIVE_B, CLASSICAL_L, 3)
    host = native.native_turbo_decode_batch(rx[:, :, 0], rx[:, :, 1], rx[:, :, 2], trellis,
                                            sigma ** 2, CLASSICAL_ITERS, inter.p_array)
    sync(dev)
    reset_counts()
    llr = make_turbo_decoder(trellis, inter.p_array, CLASSICAL_ITERS, 'hazzys').llr(
        *(torch.as_tensor(rx[:, :, i], dtype=torch.float32, device=dev) for i in range(3)),
        sigma ** 2).cpu()
    differ = torch.from_numpy(host).bool() != (llr > 0)
    near = llr.abs() < CLASSICAL_NEAR_ZERO
    vit = {}
    conv = Trellis(np.array([2]), np.array([[7, 5]]))
    coded = conv_encode_batch(rng.randint(0, 2, (NATIVE_B, CLASSICAL_L)), conv)
    vrx = (2.0 * coded - 1 + 0.9 * rng.randn(*coded.shape)).reshape(NATIVE_B, -1, conv.n)
    for metric in ('unquantized', 'tdist3'):
        card = make_viterbi(conv, metric)(torch.as_tensor(vrx, dtype=torch.float32,
                                                           device=dev)).cpu().numpy()
        host_v = np.stack([native.native_viterbi(vrx[i], conv, metric) for i in range(NATIVE_B)])
        vit[metric] = int((card != host_v).sum())
    with open(os.path.join(ROOT, 'artifacts', 'classical_awgn_k100.json')) as f:
        ref = json.load(f)
    n = str(NATIVE_CURVE_BLOCKS)
    res = turbo_benchmark.run_benchmark(turbo_benchmark.get_bench_args(
        ['-engine', 'native', '-snr_test_start', '-1', '-snr_test_end', '-1', '-snr_points', '1',
         '-num_block', n, '-batch_size', n, '-num_dec_iter', str(CLASSICAL_ITERS), '-seed', '0',
         '--device', str(dev)]))
    sync(dev)
    counts = read_counts()
    j = ref['snr'].index(-1.0)
    ref_e = round(ref['bler'][j] * ref['n_blocks'][j])
    z = two_proportion_z(res['block_errors'][0], res['n_blocks'][0], ref_e, ref['n_blocks'][j])
    emit('native_parity', gxx_build_s=build_s, turbo_blocks=NATIVE_B,
         turbo_decisions_differ=int(differ.sum()), turbo_near_zero=int(near.sum()),
         turbo_differ_near_zero=int((differ & near).sum()), viterbi_differ=vit,
         curve={'snr': -1.0, 'block_errors': res['block_errors'][0],
                'bit_errors': res['bit_errors'][0], 'n_blocks': res['n_blocks'][0],
                'bler': res['blers'][0], 'ref_block_errors': ref_e,
                'ref_n_blocks': ref['n_blocks'][j], 'z_bler': z,
                'blocks_per_s': res['n_blocks'][0] / res['seconds'][0],
                'threads': os.cpu_count()},
         launches=counts, seconds=time.perf_counter() - t0, card=nvidia_smi())
    check(not bool((differ & ~near).any()), 'native_parity: turbo decisions differ away from 0')
    check(not any(vit.values()), f'native_parity: Viterbi decisions differ {vit}')
    check(res['n_blocks'][0] == NATIVE_CURVE_BLOCKS and abs(z) < MAX_Z,
          f'native_parity: curve point z {z}')
    return counts


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def stop(proc):
    """Ends a process started in its own session and every process it
    started (torchrun's rank among them): SIGTERM, then SIGKILL after 20 s."""
    import signal
    for sig in (signal.SIGTERM, signal.SIGKILL):
        try:
            os.killpg(proc.pid, sig)
        except ProcessLookupError:
            break
        try:
            proc.communicate(timeout=20)
            break
        except subprocess.TimeoutExpired:
            continue


def wait_all(procs, phase):
    """Each process's output, each within WORKER_TIMEOUT; on a timeout every
    process is stopped, and on a timeout or a non-zero exit the phase fails
    with the tail of its output."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                stop(q)
            raise RuntimeError(f'check failed: {phase}: a process ran past {WORKER_TIMEOUT} s')
    for p, out in zip(procs, outs):
        check(p.returncode == 0, f'{phase}: a process exited {p.returncode}:\n{out[-6000:]}')
    return outs


if __name__ == '__main__':
    if sys.argv[1:2] == ['--dist-rank']:
        sys.exit(dist_rank_main(*sys.argv[2:4]))
    if sys.argv[1:2] == ['--cli-rank']:
        sys.exit(cli_rank_main(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
