#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/H100 port (`occm_tpu_torch`).

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --profile       # every phase + device time by kernel
    python3 chip_smoke.py --kernels-only  # phases 1-3 only
    python3 chip_smoke.py --controls-only # phases 1, 2 and 8 only
    python3 chip_smoke.py --rawboost-only # phases 1, 2 and 9-11 only
    python3 chip_smoke.py --models-only   # phases 1, 2 and 12 only
    python3 chip_smoke.py --remat-only    # phases 1, 2 and 13 only
    python3 chip_smoke.py --native-only   # phases 1, 2 and 14 only
    python3 chip_smoke.py --base-only     # phases 1, 2 and 15 only
    python3 chip_smoke.py --int8-only     # phases 1, 2 and 16 only
    python3 chip_smoke.py --parallel-only # phases 1, 2 and 17 only
    python3 chip_smoke.py --extras-only   # phases 1, 2 and 18 only
    python3 chip_smoke.py --orbax-only    # phases 1, 2 and 19 only
    python3 chip_smoke.py --coverage-only # phases 1, 2 and 20 only
    python3 chip_smoke.py --xlsr1b-only   # phases 1, 2 and 21 only
    python3 chip_smoke.py --wide-head-only  # phases 1, 2 and 22 only
    python3 chip_smoke.py --jax-resume-only # phases 1, 2 and 23 only
    python3 chip_smoke.py --over-256-only   # phases 1, 2 and 24 only

Phases (any failure ends the run with a non-zero exit and no last line):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit and turns TF32 off for the comparisons.
2. build: compiles occm_tpu_torch/csrc/*.cu with nvcc (sm_90a), one nvcc
   per source in parallel, and the host IO library (native/*.cpp, g++,
   `occm_tpu_torch.io.native`), prints ptxas's registers and spills, counts
   the HGMMA (wgmma) instructions of the bf16 and 3xTF32 FFN kernels and
   of the attention forward, backward dq and backward dk/dv kernels in the
   library's SASS (cuobjdump -sass), and the HMMA (mma.sync) instructions
   of the 3xTF32 attention backward; fails if any of the five, or any
   instance of the three attention kernels (round_up(D, 16) = 16 .. 256
   and D 64's and D 256's; above 128 the dk/dv kernel is the wide one) or
   of the 3xTF32 attention forward (16 .. 128), has no HGMMA, or an
   instance of the 3xTF32 dq or dk/dv kernel
   (round_up(D, 16) = 16 .. 128) no HMMA, or an instance of the three
   panel kernels above D 256 (panel widths 192, 256) no HGMMA.
3. kernels, each against its plain PyTorch version on the card on the same
   inputs, with the wrapper's time (CUDA events), the kernel's own device
   time (torch.profiler), and the plain, library and bound times:
   - flash_attn_fwd at B=8, H=16, D=64, bf16, T in {201, 299, 599, 1500},
     on [B*H, T, D] and on [B, T, H, D] views of one projection output,
     which must agree bit for bit (library: SDPA);
   - flash_attn_bwd (its dq and dk/dv launches) at B=12, H=16, D=64, T in
     {201, 299, 599, 1500}, on [B, T, H, D] views of one projection output
     and on [B*H, T, D]: the two and a repeat agree bit for bit, a call is
     two device launches and nothing else, and through autograd the
     gradients come back contiguous with no copy (library: SDPA
     forward+backward minus forward);
   - layernorm_bwd at [3588, 1024] bf16 (library:
     aten.native_layer_norm_backward) and at [1000, 1000] and [3588, 1280]:
     one device launch a call, a repeat identical bit for bit;
   - fused_adam over leaves of odd sizes (1, 3, 1027, two chunks + 3, a
     None gradient, a leaf 4 bytes past a 16-byte boundary), then over
     every leaf of the full AModel in one launch (library:
     torch.optim.Adam(fused=True).step());
   - ffn_fwd at M in {1608, 2392, 3588, 4792}, D 1024, F 4096, bf16, erf
     and tanh GELU, and at M = 1000 (a ragged tile), D = 1280, F = 5120
     (past the earlier kernel's width limit) and M = 1000, D = 1000,
     F = 4000 (partial K and N tiles) (library: the port's ffn_impl="xla"
     sequence, F.linear, F.gelu, F.linear).
4. the tiny model (XLSRConfig.tiny(): fp32, head dim 16, the 3xTF32
   forward's route) scored on the card under auto attention (the
   measured policy, impl_select.AUTO_TF32_MIN_SAMPLES) and with a
   pinned flash impl (the 3xTF32 forward), each in agreement with the
   CPU; a tiny model with head dim 260: xla under auto (no launch), a
   pinned flash on the generic forward's panels (a launch a layer), in
   agreement with the CPU. Then scoring and evaluation at full
   width (XLSR-300M + AASIST, random
   weights from seed 0, saved as a reference-named .pt):
   `occm_tpu_torch.cli.oc_classifier` in 1c2 and 2c2 mode on a synthetic
   ASVspoof-shaped tree (6 bonafide + 2 spoof train rows, 16 eval
   utterances of 3-13 s in 11 length buckets); checks the artefacts, the
   score lines and the attention kernel's launches per batch. Then the
   same eval set through OneClassScorer with ffn_impl="pallas": 24 ffn_fwd
   launches per batch, distances within a stated bound of the CLI's. EER
   and confusion matrix of the score files; utterances/s per bucket of
   1-13 s at a full batch of 8, attention xla vs flash (the measurement
   behind impl_select's AUTO_FLASH_MIN_SAMPLES), and ffn xla vs pallas at
   6 and 12 s.
5. serving: the same checkpoint served over HTTP by
   `occm_tpu_torch.cli.oc_server` from the reference embedding and
   threshold that phase 4 wrote: a 4 s WAV, a 6 s raw-PCM and a 12 s WAV
   request plus 8 concurrent 6 s requests. Checks every response, that the
   forward kernel launched 24 times (one per layer) for every batch of a
   flash bucket, and that the flash scores agree with the plain-attention
   scores.
6. training through the CLI: `occm_tpu_torch.cli.oc_training.main` at full
   width on the fixture's 6-7 s waves, --cut 96000 (flash attention
   through auto), one epoch. Checks every step's loss is finite, the
   attention kernels' launches per step (and that the backward copied no
   dO), and that aasist_vocoded_0.pt
   loads strictly into the port's AModel.
7. training through `train()`: 3 steps with every kernel (flash attention,
   ln_impl="pallas", ffn_impl="pallas", optimizer="fused_adam", AASIST
   dropouts zeroed), then the same 3 steps from the same weights and
   batches in the plain configuration (xla attention, LayerNorm and FFN,
   torch Adam). Checks each kernel's launches per step and the per-step
   losses within a stated bound; prints step times and peak memory.
8. the training controls at full width and DEPTH (4) layers of XLS-R
   300M's 24, as in phases 10, 12 and 13 and their CLI runs (12 x 6 s,
   flash attention,
   ln_impl and ffn_impl "pallas", remat, AASIST dropouts zeroed unless
   said), each against the eager loop from the same weights and batches
   under deterministic algorithms, with loss bounds derived in
   `loss_bound` from two backward passes:
   - steps_per_dispatch = 3 over 6 batches (2 chunks) with fused_adam:
     one CUDA graph launch per chunk, the capture recording 3 x each
     kernel's launches of an eager step, the profiler's device launches
     per step equal for eager, a graph of 1 step and a graph of 3 steps;
     step wall ms, device-busy share (the union of the device events'
     intervals over the host window), capture time and peak memory;
   - the same with adam under a cosine schedule (warmup 1, decay 5): the
     lr each captured step read, back from the device, is the schedule's;
   - the same with adam and AASIST's default dropouts: every loss and the
     final weights bit for bit (fresh masks on every replay);
   - grad_accum = 2 at groups_per_step = 2: on two meta-batches equal to
     its definition (the mean of the two meta-batches' own gradients, all
     under deterministic algorithms, to one fp32 rounding), on
     one meta-batch twice equal to the 24-utterance step (the gradient the
     update read within LOSS_RTOL of its norm, each updated weight within
     the bound that Adam's first update gives from the two gradients);
     each kernel twice its per-micro-batch count;
   - resume through `oc_training.main` (--checkpoint_every_steps 2, the
     CLI's default model with dropout on): SIGTERM from the on_step hook
     after step 2 saves and returns, --resume finishes the epoch bit for
     bit as an uninterrupted run, and the step-2 checkpoint is replaced
     and deleted; then the same with --steps_per_dispatch 3 (SIGTERM
     after the first chunk), again bit for bit as the eager run;
   - the bytes of dropout masks that remat holds with every XLSR rate on.
9. RawBoost (`occm_tpu_torch.augment`, plain PyTorch: no kernel of its
   own) on the card at one training batch, [12, 96000] fp32, algos 1-8:
   draws from a seeded CUDA generator; the card's apply against the CPU's
   on the same draws within RB_ATOL (algo 4 also with valid lengths); ISD's
   subset equal on both and changing exactly its n_sel samples a row;
   SSI's realised SNR equal to its draw and in [SNRmin, SNRmax]; finite
   outputs; one call captured in a CUDA graph, its replays equal to eager
   calls bit for bit; per algo the time of a call with its draws (CUDA
   events), its device time and device launches (torch.profiler).
10. training with RawBoost at full width and DEPTH layers (phase 8's
   configuration): algo 5
   with AASIST's dropouts as 2 CUDA graph launches of 3 steps against 6
   eager steps, bit for bit under deterministic algorithms; step wall ms
   eager and as a graph of 3 steps, algo 0 against algo 5, in turns, and
   the device launches and busy time a step that algo 5 adds; through the
   CLI, --rawboost_algo 5 for 6 eager steps with finite losses, and a
   --steps_per_dispatch 3 run sent SIGTERM after its first chunk and
   resumed, equal to them bit for bit.
11. --pretrained_xlsr at full width: a random XLS-R 300M encoder written
   as a fairseq .pt (a cfg whose class cannot be imported, the
   pretraining-only tensors) and as an HF .safetensors; each grafted into
   XLSREncoder (load time; every tensor equal to the file bit for bit, the
   positional conv within FOLD_RTOL of the fp64 weight-norm fold), then
   one CLI training step from each with a finite loss, the two equal.
12. the other models at full width and DEPTH layers (XLSR-300M's widths,
   random weights from seed 0, 12 x 6 s meta-batches, every kernel: flash
   attention, ln_impl and ffn_impl "pallas", fused_adam; RawBoost off, the
   backends' dropouts on): for each of ssl_resnet34, ssl_lcnn,
   ssl_lcnn_asoftmax, occm and cnn, one after another, 3 eager steps
   against the same 3 as one CUDA graph under deterministic algorithms,
   bit for bit (losses, weights; the angle loss's lambda moves inside the
   graph), each kernel's launches a step exact (XLSR's do not depend on
   the backend), step wall ms eager and as the graph, device busy share,
   peak memory. Then through the CLIs: `oc_training --model ssl_resnet34`
   for an epoch, `oc_classifier --mode 1c1` and `2c1` from its checkpoint
   and from the ssl_vocoded / senet34_vocoded pair split off it (equal
   score files, distances within SCORE_RTOL of a direct SSLResNet34
   forward, EER in [0, 1]), and `oc_training --model ssl_lcnn_asoftmax
   --steps_per_dispatch 3` for one chunk.
13. remat and fast numerics at full width and DEPTH layers (AModel,
   XLSR-300M's widths, random weights from seed 0, 12 x 6 s, fused_adam,
   AASIST dropouts on, under deterministic algorithms): each of the six
   remat policies with every kernel (flash attention, ln_impl and ffn_impl
   "pallas"), from the same weights: 3 eager steps equal bit for bit
   (losses, weights) to "nothing"'s, the same 3 as one CUDA graph equal to
   them, each kernel's launches a step exact, the peak memory of an eager
   step and what it holds when its forward ends, the step's wall ms as the
   graph and its device-busy share; attn_out_inner, attn_probs and dots
   again with plain attention against that path's "nothing". The bf16
   parameter mirror against its plain definition (the stack cast by hand
   outside the model, 3 eager steps bit for bit). Fast numerics
   (--fast_numerics' five fields) against exact: at the same weights
   before each of 3 steps, the encoder's features within FAST_FEATURE_RTOL
   and its gradient's cosine above FAST_GRAD_COSINE (the losses printed
   beside the loss's own sensitivity); graph wall, peak, busy share; flash
   against xla attention under fast numerics as graphs in turns and as
   scoring utt/s at 2, 6 and 12 s (the measurement behind impl_select's
   threshold under fast numerics). Then `oc_training --fast_numerics` for
   an epoch of 6 steps and `--fast_numerics --attention_impl flash
   --steps_per_dispatch 3` for one chunk.
14. the native IO lane (`occm_tpu_torch.io.native`: threaded C++ decode,
   header length probes, streamed FLAC) on the host: on phase 4's eval
   set (16 WAVs of 3-13 s), FLAC copies of it and a 60 s FLAC request
   body, the native readers against the Python ones bit for bit (whole,
   ranged, streamed) and both lanes timed (files/s, MB/s, native at 1
   and 8 threads); `oc_classifier --mode 2c2` on the FLAC eval set with
   the lane taken, forced off, taken (score files equal byte for byte,
   wall s, utt/s per bucket end to end, device-busy share); the 60 s
   body through `oc_server`'s spooled lane, native against Python decode
   (latency, equal scores); a training epoch's input, native against
   per-item (equal batches, steps/s); the lane's call counter above 0
   wherever it is taken, 0 where it is off.
15. the wav2vec2-base frontend at full width and depth:
   AModel(AASISTConfig(), XLSRConfig.base()) (group-norm extractor,
   post-norm encoder, 12 x 768, 12 heads of 64), random weights from seed
   0, bf16, every kernel: scoring at 2, 6 and 12 s, flash with the fused
   FFN against xla with the plain FFN in turns (utt/s, embeddings within
   BASE_EMB_RTOL_OF_MAX); training 12 x 6 s, 3 eager steps against one
   CUDA graph of 3 bit for bit (step ms, busy share, peak, launches a
   step exact); a random base-layout fairseq .pt and HF .safetensors
   grafted and held to the in-memory encoder; each kernel at base's
   shapes through phase 3's harness (attention at H = 12, the FFN at
   D 768 / F 3072, LayerNorm at [3588, 768], Adam over base + AASIST).
16. W8A8 int8 scoring and serving (`--quant_int8`, `occm_tpu_torch.ops.
   int8`; the product is torch._int_mm, not a kernel of the port: the JAX
   package computes it with lax.dot_general outside any Pallas kernel) at
   full width under --fast_numerics, printed on [int8] lines and not in
   the kernels line: int8_matmul against its plain version (an exact fp64
   product) at M = 8 x 99, 8 x 299, 8 x 599 frames, 299 and 8 (padded),
   (K, N) of XLS-R's and base's projections, x_q, accumulator and output
   bit for bit, with wrapper, device and int8-GEMM ms, the bound and the
   bf16 F.linear; `oc_classifier --mode 2c2 --quant_int8` beside the bf16
   call on phase 4's eval set (24 flash_attn_fwd launches and 144
   int8_matmul calls a batch, exact), the encoder outputs of one batch
   int8 against bf16 within the JAX suite's cosine 0.99 / relative L2
   0.15, utt/s at 2, 6 and 12 s in turns; `oc_server --quant_int8` on 4,
   6 and 12 s requests against the classifier's int8 path; the refusal
   of --quant_int8 without --fast_numerics (exit non-zero, ValueError,
   no weights read); `parity_gate --xlsr_tiny` on a tiny fairseq .pt and
   an LA-layout tree it writes, every stage PASS and rc 0.
17. the multi-GPU paths (`occm_tpu_torch.parallel`) on the one card, at
   full width and PAR_DEPTH (12) of the 24 layers (AModel(AASISTConfig(),
   XLSRConfig(encoder_layers=12)), random weights from seed 0, every
   kernel, fused_adam, AASIST dropouts on, deterministic algorithms): dp=2, fsdp=2 and tp=2 over two rank processes sharing
   cuda:0 over Gloo (NCCL refuses two ranks on one device), step 1 on
   their rows of a global 12 x 6 s batch and step 2 from the single
   process's state after step 1 (its one-GPU checkpoint restored into
   the placed state), each held against the single-process eager step
   from the same state (dp, fsdp: the loss and the gradient within
   LOSS_RTOL; tp, whose bf16 partial sums round otherwise and whose loss
   AASIST's top-k makes discontinuous: its encoder's features and
   gradient within LOSS_RTOL; every mode: the parameters within Adam's
   reach), each kernel's launches a step and rank equal to the single
   process's, on the per-rank shapes (tp: flash on 8 heads, ffn_fwd on F
   2048), the bytes each rank holds (fsdp: about half of dp's), step ms
   per rank (of two ranks sharing one card, not a multi-GPU speedup);
   the kernels at
   those shapes through phase 3's harness (the kernels line's "tp2",
   "dp2" and "fsdp2" rows). The GPipe pipeline pp=2 with 4 microbatches
   (step 1 and step 2 from the restored one-GPU checkpoint, held as dp
   is; per-layer launches the single process's x M / S, fused_adam once,
   at a microbatch's shapes; each stage's held bytes 0.5-0.55 of the
   one process's; the bubble) and tp=2 with seq_parallel (one step; its
   encoder held to the single process's and to tp=2's; launches tp=2's,
   the LayerNorm backward on a frame block; step-1 peak memory beside
   tp=2's), and their kernels' "pp2" and "sp2" rows; `oc_training --pp 2
   --pp_microbatches 4` over two ranks sharing cuda:0 (Gloo), whose
   one-GPU checkpoint one process loads with strict=True (NCCL's
   point-to-point path needs two cards and is not run here). pp2s4:
   pp=2 with pp_stages 4 (each rank two consecutive stages of 3 layers,
   the M + S - 1 tick schedule, hand-offs between a rank's own stages
   local), M = 4, one step, its loss equal bit for bit to the one
   process's at pp_stages 4 (both under deterministic algorithms), and
   the checks of pp2 against the one process without the pipeline
   (loss and gradient within LOSS_RTOL, launches, shapes, held bytes,
   Adam's reach).
   `oc_training --dp 1` (at PAR_DEPTH layers) in a torchrun
   environment of world size 1 (NCCL), --steps_per_dispatch 3 with the
   collectives captured in the CUDA graph, bit for bit with 1;
   `oc_classifier --mode 2c2` and `oc_server` with --data_parallel -1
   against the plain calls, bit for bit, and --data_parallel 2 refused.
   Runs last, since it makes and destroys a process group.
18. the rest of ROADMAP item 16 (`--extras-only`: phases 1, 2 and 18;
   in a full run right after phase 5, on its seed model):
   - the layouts: one 8 x 6 s batch through the encoder with fused_qkv,
     attention packed / packed8 / pad128 / xla_merged and the positional
     conv batched / s2d, each against its default layout in fp32 (TF32
     off) at the JAX suite's tolerances (LAYOUT_TOL) and in bf16 within
     SCORE_RTOL of the largest feature (fused_qkv with the flash
     kernels), ms a batch in bf16; one eager training step each at DEPTH
     layers, loss and gradient within LOSS_RTOL of the default layout's;
   - PGD: PGD_STEPS steps through AModel (flash, ln_impl "pallas") on
     8 x 4 s: the eps-ball, [-1, 1], the target's log-probability up,
     ms a step, the flash forward / backward and LayerNorm backward
     launches a step exact;
   - the feature bank: every extractor on the card against the CPU in
     fp64 (FEATURE_TOL), ms per 4 s utterance;
   - the linear SVM on the seed model's embeddings, fit on the card and
     on the CPU on the same orders: seconds, agreeing predictions;
   - profiling: `profile_trace` around one scoring batch, its trace
     naming the flash kernel;
   - `oc_training --debug_nans` and `--wandb_project p` at DEPTH layers
     bit for bit with the run without them, and `--debug_nans` on a tree
     with NaN samples ending in FloatingPointError (its own process), no
     epoch checkpoint written.
19. the JAX package's orbax checkpoints without orbax (`--orbax-only`:
   phases 1, 2 and 19; in a full run right after phase 11), at full width
   on phase 4's seed model with BatchNorm running statistics drawn from
   seed 19 (torch's defaults would hide lost batch_stats): libzstd's
   version; that .pt converted by `models.convert_backend.
   convert_model_file` to an orbax directory (bytes, seconds);
   `train.orbax.restore_tree` of it, every leaf equal to the converter's
   tree bit for bit (seconds, MB/s); `export_model_file` back to a .pt
   that loads strictly, every tensor the seed's but the positional conv's
   weight-norm pair and the never-run bn1s; `oc_classifier --mode 2c2
   --pretrained-sslaasist` on phase 4's eval set from the directory, from
   its exported .pt (bit for bit) and from the seed .pt (printed), the
   flash launches a batch exact; the encoder's outputs on 8 x 6 s from
   the directory and the seed .pt (within SCORE_RTOL, relative L2);
   `oc_server` from the same three, one 6 s request each (24 flash
   launches; bit for bit with the export's); `oc_training --init_from`
   the directory and its exported .pt for 2 eager steps each under
   deterministic algorithms (losses within LOSS_RTOL, the flash launches
   a step exact); `models.convert_xlsr.convert_checkpoint_file` of phase
   11's fairseq .pt to a directory, grafted as --pretrained_xlsr grafts
   it: every tensor equal to the .pt graft's bit for bit but the
   positional conv, within ORBAX_FOLD_RTOL of the fp64 fold; the dropout
   rates printed.
20. queue B's coverage (`--coverage-only`: phases 1, 2, 20 and phase 4's
   tiny checks): the 3xTF32 attention forward
   (csrc/flash_attn_fwd_3xtf32.cu: fp32 at D 64, B 8, H 16, T 201 / 299 /
   599 / 1500, at the training step's B 12, T 299 and at the tiny model's
   D 16, H 4, through the wrappers, with the generic forward called
   directly on the same inputs as its "was"), the generic attention
   kernels (csrc/flash_attn_generic.cu: bf16 at D 16 / 32 / 80 / 128,
   T 299 / 1500, called directly since the wgmma route takes those, and
   at D 132, T 299, through the wrappers), the 3xTF32 attention backward
   (csrc/flash_attn_bwd_3xtf32_dq.cu, _dkv.cu: fp32 at the same shapes,
   B 12, through the wrappers, with the generic pair called directly on
   the same inputs as its "was"), the fp32 FFN kernels
   (csrc/ffn_fwd_3xtf32.cu: M 2392 / 3588, D 1024, F 4096, erf and tanh;
   (1000, 1000, 4000); the SIMT
   csrc/ffn_fwd_f32.cu on the same inputs as its "was", and through the
   wrapper at D 1002, F 4002) against their plain versions
   (COVERAGE_F32_RTOL_OF_MAX, FFN_F32_RTOL_OF_MAX; bf16 at phase 3's
   bounds) with wrapper, device, plain, library (SDPA in the same dtype;
   F.linear, F.gelu, F.linear: wrapper and device) and bound times (fp32
   as 3xTF32 on the tensor cores, PEAK_TF32_FLOPS); each attention row
   also views = [B*H, T, D] = a repeat bit for bit, two device launches a
   backward call, and at T 299 contiguous gradients through autograd
   where the CUDA routes take the shape (an expanded dO read in place);
   the fp32 forward at B 8, T 299 for every D that is a multiple of 8 up
   to 128 (H 16) and at the tiny model's D 16, H 4, 3xTF32 against the
   generic kernel in turns (the measurement behind
   attention.TF32_FWD_HEAD_DIMS); the fp32 backward at B 12, H 16, T 299
   for every D that is a multiple of 8 up to 128, 3xTF32 against the
   generic pair in turns (the measurement behind
   attention.TF32_BWD_HEAD_DIMS). Then the fp32 model at full width
   (AModel(AASISTConfig(), XLSRConfig(dtype="float32",
   attention_impl="flash", ffn_impl="pallas")), seed 0): 8 x 6 s and
   8 x 12 s scored (24 3xTF32 forward and 24 3xTF32 FFN launches a batch,
   none of the generic forward, wgmma or SIMT FFN kernels; distances
   against the same weights on xla attention and the plain FFN within
   COVERAGE_MODEL_RTOL), one eager 12 x 6 s training step against the
   plain one (48 3xTF32 forward, 24 + 24 3xTF32 backward and 48 3xTF32
   FFN launches, no generic kernel; loss, encoder features and gradient
   within COVERAGE_MODEL_RTOL; its wall ms), utt/s at 1, 2, 6 and 12 s in
   turns (xla, flash, flash + the 3xTF32 FFN: the measurement behind
   AUTO_TF32_MIN_SAMPLES); and the tiny model through `oc_training
   --xlsr_tiny --attention_impl flash` (2 steps, the forward and 3xTF32
   backward launches a step exact) and `oc_classifier --mode 2c2`
   on the card and with --device cpu (logits within TINY_RTOL_OF_MAX). In
   a full run its kernel checks follow phase 3's and its paths phase 7.
21. bf16 attention at head dims other than 64 (`--xlsr1b-only`: phases 1,
   2 and 21; in a full run its kernel checks follow phase 20's and its
   path phase 20's paths): the wgmma kernels' instances for every
   round_up(D, 16) at D 16, 32, 64, 80, 120 and 128, T 201 / 299 / 599 /
   1500 (forward B 8, backward B 12, H 16), against their plain versions
   (phase 3's bounds), against the generic kernels on the same inputs
   (GENERIC_OUT_SLACK_OF_MAX, GENERIC_LSE_ATOL, GENERIC_BWD_RTOL_OF_MAX)
   and, at
   D 32, 80 and 128, through the scale-order gate (closer to the plain
   version than the plain version with the scale on the fp32 logits);
   views = [B*H, T, D] = a repeat bit for bit, two device launches a
   backward call, autograd at T 299 (an expanded dO copied once); at
   D != 64 and T 299 / 1500 wrapper, device, plain, SDPA (wrapper and
   device), the generic kernel's ("was") and bound times. Then XLS-R 1B's
   widths at full depth (AModel(AASISTConfig(), XLSRConfig(48 layers,
   d 1280, FFN 5120, 16 heads of 80, out_dim 1280)), bf16, flash, fused
   FFN, LayerNorm kernel, random weights from seed 0): 8 x 6 s and
   8 x 12 s scored through BucketedEmbedder (48 D 80 forward and 48
   ffn_fwd launches a batch, none of D 64's or the generic kernels;
   distances, relative to the embeddings' norms, and embeddings within
   XLSR1B_SCORE_RTOL of xla attention and the plain FFN), one eager
   12 x 6 s training step against the plain one (loss,
   encoder features and gradient within LOSS_RTOL; launches exact) and
   one fused_adam step, utt/s at 1, 2, 6 and 12 s in turns (xla, flash,
   flash + fused FFN: the measurement behind impl_select's threshold for
   this route).
22. bf16 attention at head dims 136-256 (`--wide-head-only`: phases 1, 2
   and 22; in a full run its kernel checks follow phase 21's and its path
   phase 21's path): the wgmma instances above D 128 (the forward with two
   consumer warpgroups, the wide dk/dv kernel) at D 136, 192 and 256,
   T 201 / 299 / 599 / 1500 (forward B 8, backward B 12, H 16), as phase
   21 checks its head dims: against their plain versions (phase 3's
   bounds), against the generic kernels on the same inputs, through the
   scale-order gate at D 136 and 192, and at D 256 (whose instance scales
   the logits) the folded instance bit for bit; views = [B*H, T, D] = a
   repeat bit for bit, two device launches a backward call, autograd at
   T 299; at T 299 / 1500 wrapper, device, plain, SDPA, the generic
   kernel's ("was") and bound times. Then XLS-R 300M's widths with 4 heads
   of 256 (AModel(AASISTConfig(), XLSRConfig(encoder_heads=4)), bf16,
   flash, fused FFN, LayerNorm kernel, random weights from seed 0), as
   phase 21's model: 8 x 6 s and 8 x 12 s scored (24 D 256 forward
   launches a batch, none of D 64's or the generic kernels; within
   SCORE_RTOL of xla attention and the plain FFN), one eager 12 x 6 s
   training step against the plain one with launches exact and one
   fused_adam step, utt/s at 1, 2, 6 and 12 s in turns.
23. `oc_training --resume` continuing a run of the JAX package
   (`--jax-resume-only`: phases 1, 2 and 23; in a full run right after
   phase 22's path) from orbax directories that `write_jax_checkpoint`
   writes in the layout of `occm_tpu.train.checkpoint` (parameters and
   BatchNorm statistics through `convert_backend.convert_model_state_dict`,
   the moments through the same mapping, opt_state in optax adam's or
   FusedAdamState's form, a step directory's progress; every array a
   "jax.Array" leaf; tests/test_torch_resume_jax.py holds the writer
   against the JAX package's saver): (a) XLS-R 300M + AASIST at full width
   and depth (seed 0, 2 eager steps under torch Adam) as the epoch
   directory `aasist_vocoded_0/` (~3.8 GB), resumed under the default
   --optimizer adam; (b) the same widths at DEPTH layers under fused_adam
   as the step directory `aasist_vocoded_step_2/` after 2 of epoch 0's
   dispatches, resumed under --optimizer fused_adam (the consumed
   dispatches replayed). Each resume trains 2 steps under deterministic
   algorithms; the gates: the state restored, read on the card before the
   first step, equal bit for bit to the state written (parameters,
   BatchNorm running statistics, mu, nu, step, count) and the generator
   seeded by `train.checkpoint.resume_seed`; the first batch trained the
   pipeline's next one; each step's launches exact (phase 6's, and one
   fused_adam launch a step in (b); no generic, 3xTF32 or other-D kernel);
   finite losses, equal bit for bit on a second resume (in (a) sent
   SIGTERM after its steps, so the port saves its step .pt beside the
   directory) and on a .pt resume of the restored state and generator;
   the directory's files, sizes and manifest hashes unchanged, and the
   next resume taking the port's .pt. Write, read and ready seconds and
   MB/s are printed.
24. attention above head dim 256 (`--over-256-only`: phases 1, 2 and 24;
   in a full run its kernel checks follow phase 22's and its path phase
   22's path): the panel kernels (csrc/flash_attn_panel.cu; bf16 at
   D 264, 320, 512 with H 16 and at D 1024 with H 1) and the generic
   kernels' panels (fp32 at D 264 and 512, bf16 at D 260), T 201 / 299 /
   599 / 1500 (forward B 8, backward B 12): against their plain versions
   (bf16 at phase 3's bounds, fp32 at phase 20's), the panel kernels also
   against the generic kernels on the same inputs; views = [B*H, T, D] =
   a repeat bit for bit, one device launch a forward call and two a
   backward call, autograd at T 299; at T 299 / 1500 wrapper, device,
   plain, SDPA (and the backend it ran), the generic kernels' ("was") and
   bound times. Then XLS-R 300M's widths with 2 heads of 512
   (AModel(AASISTConfig(), XLSRConfig(encoder_heads=2)), bf16, flash,
   fused FFN, LayerNorm kernel, random weights from seed 0), as phase
   22's model: 8 x 6 s and 8 x 12 s scored (24 panel forward launches a
   batch, none of D 64's, the other head dims' or the generic kernels;
   within SCORE_RTOL of xla attention and the plain FFN), one eager
   12 x 6 s training step against the plain one with launches exact and
   one fused_adam step, utt/s at 1, 2, 6 and 12 s in turns (the
   measurement behind impl_select.AUTO_OVER_256_MIN_SAMPLES); and the same
   widths in fp32 at DEPTH layers on the generic kernels' panels, as
   phase 20's fp32 model: scoring 8 x 6 s and 8 x 12 s and an eager
   training step against the plain path (COVERAGE_MODEL_RTOL).
25. with --profile only: device time by kernel (torch.profiler) for full
   batches of 8 in the two flash buckets, for a 6 s batch with
   ffn_impl="pallas", and for one full training step (12 x 6 s).
26. prints {"kernels": [...]} (each entry of phases 3's kernels with
   phase 15's row at base's shapes under "base" and phase 17's at the
   per-rank shapes under "tp2", "dp2" or "fsdp2", "pp2" and "sp2"; phase
   20's six entries and phase 21's, 22's and 24's two, two and four with
   their shapes under "per_shape"), then {"ok": true, "device": {...}}
   last.
A full run makes phase 15's, 16's, 17's, 20's, 21's, 22's and 24's kernel
checks right after phase 3's, and phases 15 and 16's other parts before
phase 14 (see main).

Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np

B, H, D = 8, 16, 64
KERNEL_TS = (201, 299, 599, 1500)
# T of the two flash buckets of the main path: 96 000 and 192 000 samples
MAIN_PATH_TS = (299, 599)
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
# TF32 on the tensor cores (dense). fp32-accurate products take three of
# them (3xTF32: hi hi + hi lo + lo hi), so the least time of fp32 work on
# the card is 3 FLOPs / PEAK_TF32_FLOPS, below FLOPs / PEAK_FP32_FLOPS
PEAK_TF32_FLOPS = 495e12
TRAIN_B = 12  # utterances in one training step: one meta-batch

# Kernel vs plain version: the plain version runs in fp32 on the same bf16
# inputs, so the kernel's own roundings show as error: P cast to bf16
# before P·V (relative 2^-9 per probability) and the bf16 output (relative
# 2^-9). With q, k, v ~ N(0, 1) the outputs are weighted means of v rows,
# |out| <= max|v| ~ 4.5, so both roundings stay below 4.5 * 2^-8 ~ 1.8e-2.
OUT_ATOL = 2e-2
# lse is fp32 on both sides; only the summation order differs.
LSE_ATOL = 1e-3
# Flash vs plain attention through the whole 24-layer model: both run bf16
# activations, and the two paths round P at different places (unnormalised
# vs normalised probabilities), a relative 2^-9 per layer that the residual
# stream carries through 24 layers; the distance to the reference is a norm
# over 160 embedding values. A relative bound of 5e-2 holds that drift and
# fails on any structural fault (a wrong mask, layout or scale moves the
# distance by far more).
SCORE_RTOL = 5e-2
# Fused FFN kernel vs its plain version on the same bf16 inputs: the plain
# version repeats the kernel's two bf16 roundings (the hidden activation and
# the output), so the two differ only by the order of the fp32 sums, which
# can flip one rounding of an output by one bf16 ulp (at most 2^-7 of its
# magnitude) or one rounding of a hidden element (an effect on y some 2^-8
# times smaller). A bound of 2^-7 of the largest |y| holds that and fails on
# a wrong fragment, tile or bias (those move whole rows or columns).
FFN_RTOL_OF_MAX = 2.0 ** -7
# M of the FFN check: 8 x T at 4, 6 and 12 s (serving and scoring batches),
# 12 x 299 (a training step at 6 s); M = 2392 is the kernels line's shape
FFN_MS = (8 * 201, 8 * 299, 12 * 299, 8 * 599)
FFN_MAIN_M = 8 * 299
# edge shapes (M, D, F): a ragged last row tile, a width past the earlier
# kernel's D <= 1024 limit, and D, F that are not multiples of the 64-deep
# k-steps or the 256-wide output tiles (TMA zero-fills the partial K and N
# tiles on load and clips N on store)
FFN_EDGES = ((1000, 1024, 4096), (FFN_MAIN_M, 1280, 5120), (1000, 1000, 4000))
# Training, step 1: the same forward as the serving check's, through the
# same 24 layers, plus the LayerNorm kernel's bf16 output: relative 5e-2 of
# the loss (later steps add an Adam term, see phase_train).
LOSS_RTOL = 5e-2

SR = 16000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: profiler sessions a device time may take (a session may lose records)
PROFILE_TRIES = 12
#: the marker kernel each profiler session launches first (torch.cuda.
#: _sleep's), and its length in clock cycles
PROFILE_MARKER = "spin_kernel"
PROFILE_MARKER_CYCLES = 1000


def profiled_events(fn, iters: int):
    """torch.profiler's CUDA events of `iters` calls of fn, in a session
    that first launches a marker kernel (PROFILE_MARKER) and waits for it:
    on one H100 every session lost its first device record (in each
    session of the attention backward the dq kernel kept 19 of 20 events
    and the dk/dv kernel all 20, whichever was timed), so the marker takes
    that place. The marker's own events are left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PROFILE_MARKER_CYCLES)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and PROFILE_MARKER not in e.name]


def device_ms(fn, names, iters: int = 20, warmup: int = 3,
              whole_others: bool = True, counters=()):
    """Device time of fn's own kernels per call: torch.profiler's CUDA
    events over `iters` calls (profiled_events), those whose name holds
    one of `names` summed and divided by `iters`. Returns (ms, their
    launches per call, all device launches per call, None or
    "kept/expected" named events).

    fn launches the same kernels on every call, so a session whose event
    counts are not multiples of `iters` has lost records: on the H100 a
    rare session records no device event, or drops a few, with or without
    CUPTI's teardown between sessions. Such a session is repeated, up to
    PROFILE_TRIES sessions in all. whole_others=False keeps a session whose
    named events alone are whole multiples (what is timed), whatever the
    count of fn's other launches. `counters`: the kernel wrappers' launch
    counters of the named kernels (KERNEL_NAMES' keys). With them a
    session is kept only if its named events are the wrappers' launches
    exactly (a session that lost all of one kernel's records is whole
    multiples too: on the H100 one kept the dq kernel's 20 events and
    none of the dk/dv kernel's). With them, and iters >= 20, a session
    after the first that lost exactly one record is kept too: one named
    record (the wrappers' count less one; the other events whole, under
    whole_others), timed as the mean of the kept events times the
    wrappers' launches a call (on the H100, in some calls every session
    lost one record: the LayerNorm backward at [1800, 1024] kept 19 of 20
    events), or one of the other kernels' records (the named events the
    wrappers' count exactly, timed as they are). The launches a call it
    returns are then the wrappers' and one more other event. A library
    call (names ("",)) has no counters: a session after the first one
    event short of whole multiples is timed the same way."""
    from occm_tpu_torch.ops import launch_counts

    for _ in range(warmup):
        fn()
    for attempt in range(1, PROFILE_TRIES + 1):
        before = launch_counts()
        events = profiled_events(fn, iters)
        after = launch_counts()
        us, own, every = 0.0, 0, len(events)
        for e in events:
            if any(n in e.name for n in names):
                us += e.time_range.elapsed_us()
                own += 1
        want = sum((after[c] - before[c])
                   * {**KERNEL_NAMES, **COVERAGE_KERNEL_NAMES,
                      **WIDE_KERNEL_NAMES, **OVER_256_KERNEL_NAMES}[c][1]
                   for c in counters)
        if (every and own % iters == 0 and (not counters or own == want)
                and (every % iters == 0 or not whole_others)):
            if own == 0:
                fail(f"profile: no device event named {names} "
                     f"({every / iters} device events a call)")
            return us / iters / 1e3, own / iters, every / iters, None
        print(f"[profile] session {attempt} of {PROFILE_TRIES} for {names} "
              f"lost records: {every} device events, {own} of them named, "
              f"over {iters} calls"
              + (f" (the wrappers launched {want})" if counters else ""),
              file=sys.stderr, flush=True)
        one_short = (attempt >= 2 and iters >= 20
                     and (every + 1) % iters == 0)
        if (counters and want and want % iters == 0 and own == want - 1
                and (one_short or (attempt >= 2 and iters >= 20
                                   and not whole_others))):
            print(f"[profile] timed {names} from session {attempt}, which "
                  f"kept {own} of the wrappers' {want} launches, at the mean "
                  "of those kept", file=sys.stderr, flush=True)
            return (us / own * (want / iters) / 1e3, want / iters,
                    (every + 1) / iters, f"{own}/{want}")
        if counters and want and own == want and one_short:
            print(f"[profile] timed {names} from session {attempt}, which "
                  f"kept all {want} of the wrappers' launches and lost one "
                  "other record", file=sys.stderr, flush=True)
            return (us / iters / 1e3, want / iters, (every + 1) / iters,
                    f"{every - own}/{every + 1 - own} others")
        if names == ("",) and one_short:
            # a library call (every event named, no wrapper to count its
            # launches): a session after the first one record short of
            # whole multiples, as above, is timed the same way (on the
            # H100 of one call every session of SDPA's kept 39 of 40)
            print(f"[profile] timed the library call from session "
                  f"{attempt}, which kept {every} of {every + 1} events, at "
                  "the mean of those kept", file=sys.stderr, flush=True)
            return (us / every * ((every + 1) / iters) / 1e3,
                    (every + 1) / iters, (every + 1) / iters,
                    f"{every}/{every + 1}")
    fail(f"profile: {PROFILE_TRIES} sessions for {names} all lost records")


def events_kept(kept, suffix: str = "") -> dict:
    """A kernels-line row's note of a device time taken from a session
    that lost one record (device_ms' "kept/expected"), else nothing."""
    return {} if kept is None else {f"device_events_kept{suffix}": kept}


def calls_device_ms(fn, iters: int = 20, warmup: int = 3,
                    sessions: int = 2):
    """Device time and device launches per call of everything fn launches
    (plain PyTorch, not one kernel): torch.profiler's CUDA events over
    `iters` calls, from the one of `sessions` sessions that recorded the
    most events (a session may lose records, see device_ms; while none
    has recorded any, up to PROFILE_TRIES sessions run: on the H100 two
    sessions in a row of an int8 product once recorded nothing). Unlike a
    kernel wrapper's, the count need not be a whole multiple of iters: on
    the H100, after phase 8, every session of RawBoost's 20 calls recorded
    one device event more than 20 times a call's."""
    for _ in range(warmup):
        fn()
    best = (0, 0.0)
    for attempt in range(1, PROFILE_TRIES + 1):
        if attempt > sessions and best[0] > 0:
            break
        events = profiled_events(fn, iters)
        best = max(best, (len(events), sum(e.time_range.elapsed_us()
                                           for e in events)))
    if best[0] == 0:
        fail(f"profile: {PROFILE_TRIES} sessions recorded no device event")
    return best[1] / iters / 1e3, best[0] / iters


def library_device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call of every kernel one library call launches."""
    return device_ms(fn, ("",), iters, warmup)[0]


def attention_bound(bh: int, t: int, d: int):
    """Least time for one forward on an H100: (bound_ms, bound_by, flops,
    bytes). Two products of 2*T*T*D flops per (b, h); q, k, v read once
    and out written once in bf16, lse written once in fp32."""
    flops = 4.0 * bh * t * t * d
    nbytes = 4.0 * bh * t * d * 2 + bh * t * 4
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


# ------------------------------------------------------------- phase 1, 2

def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA "
             "card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    return smi[0]


def phase_build():
    from occm_tpu_torch.io import native
    from occm_tpu_torch.ops import _build

    t0 = time.perf_counter()
    HOST_LIB["path"] = native.build()
    HOST_LIB["seconds"] = time.perf_counter() - t0
    if not native.available():
        fail(f"the native IO library did not load: "
             f"{native.unavailable_reason}")
    print(f"[build] host IO library {HOST_LIB['path']} (g++ "
          f"{' '.join(native.CXXFLAGS)}) in {HOST_LIB['seconds']:.2f} s",
          flush=True)

    t0 = time.perf_counter()
    _build.load()
    print(f"[build] {_build.library_path()} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f}"
          " s; each source's nvcc, s: "
          f"{ {k: round(v, 1) for k, v in _build.source_seconds.items()} })",
          flush=True)
    for line in _build.build_log.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"[build]   {line.strip()}", flush=True)
    # the FFN and the three attention kernels must run on wgmma: count
    # HGMMA in their SASS
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", _build.library_path()],
                          capture_output=True, text=True, check=True).stdout
    hgmma, hmma, fn = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn and "HGMMA" in line:
            hgmma[fn] = hgmma.get(fn, 0) + 1
        elif fn and "HMMA" in line:
            hmma[fn] = hmma.get(fn, 0) + 1
    print(f"[build] HGMMA instructions in the library's SASS: {hgmma}",
          flush=True)
    for kernel in ("ffn_gemm_kernel", "flash_attn_fwd_kernel",
                   "flash_attn_bwd_dq_kernel", "flash_attn_bwd_dkv_kernel",
                   "ffn_gemm_3xtf32_kernel"):
        if not any(kernel in f for f in hgmma):
            fail(f"the SASS of {kernel} holds no HGMMA: {hgmma}")
    # the 3xTF32 attention backward runs mma.sync (HMMA), in every
    # instance NP = round_up(D, 16), 16 to 128
    for kernel in ("flash_attn_3xtf32_dq_kernel",
                   "flash_attn_3xtf32_dkv_kernel"):
        for np_ in range(16, 129, 16):
            if not any(f"{kernel}ILi{np_}E" in f for f in hmma):
                fail(f"the SASS of {kernel}<{np_}> holds no HMMA: "
                     f"{sorted(hmma)}")
    print(f"[build] HMMA in every instance of the 3xTF32 attention "
          f"backward: {sum(hmma.values())} instructions", flush=True)
    # the 3xTF32 attention forward runs wgmma (HGMMA) in every instance
    # NP = round_up(D, 16), 16 to 128
    for np_ in range(16, 129, 16):
        if not any(f"flash_attn_fwd_3xtf32_kernelILi{np_}E" in f
                   for f in hgmma):
            fail(f"the SASS of flash_attn_fwd_3xtf32_kernel<{np_}> holds no "
                 f"HGMMA: {sorted(hgmma)}")
    print("[build] HGMMA in every instance of the 3xTF32 attention forward",
          flush=True)
    # and every instance of the attention kernels: <NP, fold> for
    # NP = round_up(D, 16) from 16 to 256 (the scale folded into q), and
    # <64, false> and <256, false> (D 64 and 256, the scale on the
    # logits); the dk/dv kernel above NP 128 is flash_attn_bwd_dkv_wide_
    # kernel
    instances = [(np_, 1) for np_ in range(16, 257, 16)] + [(64, 0),
                                                             (256, 0)]
    for kernel in ("flash_attn_fwd_kernel", "flash_attn_bwd_dq_kernel",
                   "flash_attn_bwd_dkv_kernel"):
        for np_, fold in instances:
            name = (kernel.replace("_kernel", "_wide_kernel")
                    if kernel == "flash_attn_bwd_dkv_kernel" and np_ > 128
                    else kernel)
            tag = f"{name}ILi{np_}ELb{fold}E"
            if not any(tag in f for f in hgmma):
                fail(f"the SASS of {tag} holds no HGMMA: {sorted(hgmma)}")
    print(f"[build] HGMMA in every instance of the three attention kernels "
          f"({len(instances)} each)", flush=True)
    # and the panel kernels above D 256 (csrc/flash_attn_panel.cu), in both
    # panel widths
    for kernel in OVER_256_KERNEL_NAMES.values():
        for pw in PANEL_WIDTHS:
            tag = f"{kernel[0]}ILi{pw}E"
            if not any(tag in f for f in hgmma):
                fail(f"the SASS of {tag} holds no HGMMA: {sorted(hgmma)}")
    print(f"[build] HGMMA in every instance of the three panel kernels "
          f"(PW {PANEL_WIDTHS})", flush=True)
    return hgmma


# ----------------------------------------------------------------- phase 3

def phase_kernels(b: int = B, h: int = H, ts=KERNEL_TS):
    """flash_attn_fwd at B = b, H = h and every T of ts on both layouts:
    [B*H, T, D] contiguous, and [B, T, H, D] views of one [B, T, 3, H, D]
    projection output (the layout the model hands it), each against the
    plain version; the two layouts must give the same bits."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops.attention import (
        flash_attention_fwd, flash_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for t in ts:
        qkv = torch.randn((b, t, 3, h, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q4, k4, v4 = qkv.unbind(2)  # strided [B, T, H, D] views

        def flat(x):
            return x.permute(0, 2, 1, 3).reshape(b * h, t, D).contiguous()

        q, k, v = flat(q4), flat(k4), flat(v4)
        out, lse = flash_attention_fwd(q, k, v, t)
        out4, lse4 = flash_attention_fwd(q4, k4, v4, t)
        torch.cuda.synchronize()
        if not (out4.shape == (b, t, h, D) and out4.is_contiguous()
                and torch.equal(flat(out4), out) and torch.equal(lse4, lse)):
            fail(f"flash_attn_fwd T={t}: [B, T, H, D] views and [B*H, T, D] "
                 "give different results")
        ref_out, ref_lse = flash_attention_reference(
            q.float(), k.float(), v.float(), t)
        err = (out.float() - ref_out).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        if not (math.isfinite(err) and err <= OUT_ATOL):
            fail(f"flash_attn_fwd T={t}: max |out - plain| = {err} > "
                 f"{OUT_ATOL}")
        if not (math.isfinite(lse_err) and lse_err <= LSE_ATOL):
            fail(f"flash_attn_fwd T={t}: max |lse - plain| = {lse_err} > "
                 f"{LSE_ATOL}")
        ms = cuda_ms(lambda: flash_attention_fwd(q4, k4, v4, t))
        ms_flat = cuda_ms(lambda: flash_attention_fwd(q, k, v, t))
        dev_ms, _, _, kept = device_ms(
            lambda: flash_attention_fwd(q4, k4, v4, t), ("flash_attn_fwd",),
            counters=("flash_attn_fwd",))
        qf, kf, vf = q.float(), k.float(), v.float()
        plain_ms = cuda_ms(lambda: flash_attention_reference(qf, kf, vf, t),
                           iters=5)
        q3, k3, v3 = (x.view(b, h, t, D) for x in (q, k, v))
        library_ms = cuda_ms(
            lambda: F.scaled_dot_product_attention(q3, k3, v3))
        lib_dev_ms = library_device_ms(
            lambda: F.scaled_dot_product_attention(q3, k3, v3))
        bound_ms, bound_by, flops, nbytes = attention_bound(b * h, t, D)
        row = dict(B=b, H=h, T=t, max_abs_err=err, lse_max_abs_err=lse_err,
                   ms=ms,
                   ms_bh_t_d=ms_flat, device_ms=dev_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=lib_dev_ms,
                   bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes,
                   **events_kept(kept))
        rows.append(row)
        print(f"[kernel] flash_attn_fwd B={b} H={h} T={t} D={D}: "
              f"max_err {err:.3e} (bound {OUT_ATOL}), lse_err "
              f"{lse_err:.3e}, [B, T, H, D] views = [B*H, T, D] bit for bit; "
              f"wrapper {ms:.4f} ms on the views ({ms_flat:.4f} on "
              f"[B*H, T, D]), device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"sdpa {library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


# Backward kernel vs its plain version on the same bf16 inputs: the plain
# version repeats the kernel's casts (P and dS to bf16 before their
# products), so the two differ only by fp32 summation order, which can move
# one bf16 rounding of P, dS or an output by one ulp (2^-8 relative). A
# bound of 2^-6 of the largest |value| of each gradient holds that and
# fails on a wrong fragment, mask or scale (those move whole rows).
BWD_RTOL_OF_MAX = 2.0 ** -6
# LayerNorm backward: dx is written in bf16 (one rounding, 2^-8 relative, a
# flip of it 2^-7 of the largest |dx|); dgamma and dbeta are fp32 sums over
# 3588 rows in another order (each term equal to ~1e-6 relative), so 1e-4
# of the largest |value|.
LN_DX_RTOL_OF_MAX = 2.0 ** -7
LN_DPARAM_RTOL_OF_MAX = 1e-4
# Fused Adam: the same fp32 formula, IEEE sqrt and division on both sides;
# they differ by fused multiply-adds at most, a few ulp of p (|p| < 8:
# ulp 5e-7), of m and of v.
ADAM_ATOL = 2e-6
LN_SHAPE = (12 * 299, 1024)  # [meta-batch x frames at 6 s, d_model]
# edge shapes: D not a multiple of the kernel's 256-column lane sweep, and
# D past 1024 (the kernel's wider instance)
LN_EDGES = ((1000, 1000), (12 * 299, 1280))


def attention_bwd_bound(bh: int, t: int, d: int):
    """Least time for one backward on an H100: five products of 2*T*T*D
    flops per (b, h); q, k, v, o, dO read and dq, dk, dv written once in
    bf16, lse read once in fp32 (delta is the kernels' own intermediate)."""
    flops = 10.0 * bh * t * t * d
    nbytes = 8.0 * bh * t * d * 2 + bh * t * 4
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def bytes_bound(nbytes: float, flops: float = 0.0,
                peak_flops: float = PEAK_FP32_FLOPS):
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def check_attention_autograd(q4, k4, v4, do4, want, t):
    """`flash_attention` on CUDA [B, T, H, D] views: q, k and v get
    contiguous gradients, through one launch of each backward kernel and no
    copy, equal bit for bit to the backward wrapper's `want`; a dO that
    the TMA maps cannot read (the expanded ones of `out.sum()`) costs one
    counted copy and gives the gradients of the same dO made contiguous."""
    import torch

    from occm_tpu_torch.ops import attention

    q, k, v = (x.detach().requires_grad_() for x in (q4, k4, v4))
    before = (attention.BWD_DQ_LAUNCHES, attention.BWD_DKV_LAUNCHES,
              attention.BWD_DOUT_COPIES)
    grads = torch.autograd.grad(attention.flash_attention(q, k, v),
                                (q, k, v), do4)
    torch.cuda.synchronize()
    if (attention.BWD_DQ_LAUNCHES - before[0],
            attention.BWD_DKV_LAUNCHES - before[1],
            attention.BWD_DOUT_COPIES - before[2]) != (1, 1, 0):
        fail("flash_attention backward did not launch each backward kernel "
             "once without a copy")
    for name, g, w in zip(("q", "k", "v"), grads, want):
        if not (g.shape == q4.shape and g.is_contiguous()):
            fail(f"flash_attention: {name}'s gradient is not contiguous "
                 f"{tuple(q4.shape)}: {tuple(g.shape)} {g.stride()}")
        if not torch.equal(g, w):
            fail(f"flash_attention: {name}'s gradient is not the kernel's")
    out = attention.flash_attention(q, k, v)
    before = attention.BWD_DOUT_COPIES
    summed = torch.autograd.grad(out.sum(), (q, k, v), retain_graph=True)
    ones = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    torch.cuda.synchronize()
    if attention.BWD_DOUT_COPIES - before != 1:
        fail("flash_attention: an expanded dO was not copied once")
    if not all(torch.equal(a, b) for a, b in zip(summed, ones)):
        fail("flash_attention: the gradients of out.sum() are not those of "
             "a contiguous dO of ones")
    print(f"[kernel] flash_attention autograd on cuda at T={t}: q, k, v "
          "gradients are the backward kernels', contiguous [B, T, H, D], no "
          "copy; an expanded dO costs one counted copy", flush=True)


def phase_attention_bwd(h: int = H, ts=KERNEL_TS, b: int = TRAIN_B):
    """flash_attn_bwd at every T of ts, B = b, H = h, on [B, T, H, D]
    views of one [B, T, 3 * H * D] projection output (the layout the model
    hands it, read in place) and on [B*H, T, D] copies: the two give the
    same bits, a repeat gives the same bits, one call is two device
    launches (dq, dk/dv) and nothing else, and the gradients are within
    BWD_RTOL_OF_MAX of the plain version's."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops.attention import (
        flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd)

    gen = torch.Generator(device="cuda").manual_seed(1)
    bt, ht = b, h
    rows = []
    for t in ts:
        qkv = torch.randn((bt, t, 3 * ht * D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        q4, k4, v4 = qkv.view(bt, t, 3, ht, D).unbind(2)
        do4 = torch.randn((bt, t, ht, D), generator=gen,
                          device="cuda").to(torch.bfloat16)
        out4, lse = flash_attention_fwd(q4, k4, v4, t)

        def flat(x):
            return x.permute(0, 2, 1, 3).reshape(bt * ht, t, D).contiguous()

        q, k, v, out, do = (flat(x) for x in (q4, k4, v4, out4, do4))
        got4 = flash_attention_bwd(q4, k4, v4, out4, lse, do4, t)
        again = flash_attention_bwd(q4, k4, v4, out4, lse, do4, t)
        got = flash_attention_bwd(q, k, v, out, lse, do, t)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("dq", "dk", "dv"), got4, again, got):
            if not (a.shape == q4.shape and a.is_contiguous()):
                fail(f"flash_attn_bwd T={t}: {name} is not contiguous "
                     f"[B, T, H, D]: {tuple(a.shape)} {a.stride()}")
            if not torch.equal(a, b):
                fail(f"flash_attn_bwd T={t}: two calls give different {name}")
            if not torch.equal(flat(a), c):
                fail(f"flash_attn_bwd T={t}: [B, T, H, D] views and "
                     f"[B*H, T, D] give different {name}")
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, t)
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(err) and err <= BWD_RTOL_OF_MAX * scale):
                fail(f"flash_attn_bwd T={t}: max |{name} - plain| = {err} > "
                     f"{BWD_RTOL_OF_MAX} * {scale}")
            errs.append((name, err, scale))
        if t == MAIN_PATH_TS[0]:
            check_attention_autograd(q4, k4, v4, do4, got4, t)
        ms = cuda_ms(lambda: flash_attention_bwd(q4, k4, v4, out4, lse, do4,
                                                 t))
        ms_flat = cuda_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                      t))
        dev_ms, own, every, kept = device_ms(
            lambda: flash_attention_bwd(q4, k4, v4, out4, lse, do4, t),
            ("flash_attn_bwd",),
            counters=("flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
        if (own, every) != (2, 2):
            fail(f"flash_attn_bwd T={t}: {every} device launches a call "
                 f"({own} of the kernels), want 2 (dq, dk/dv) and no other")
        (dq_ms, _, _, kept_dq), (dkv_ms, _, _, kept_dkv) = (device_ms(
            lambda: flash_attention_bwd(q4, k4, v4, out4, lse, do4, t),
            (name,), counters=(name,))
            for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"))
        plain_ms = cuda_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, t), iters=3, warmup=1)
        q3, k3, v3 = (x.view(bt, ht, t, D).detach().requires_grad_()
                      for x in (q, k, v))
        do3 = do.view(bt, ht, t, D)

        def sdpa_fwd_bwd():
            o3 = F.scaled_dot_product_attention(q3, k3, v3)
            torch.autograd.grad(o3, (q3, k3, v3), do3)

        with torch.no_grad():
            fwd_ms = cuda_ms(
                lambda: F.scaled_dot_product_attention(q3, k3, v3))
        library_ms = cuda_ms(sdpa_fwd_bwd) - fwd_ms
        with torch.no_grad():
            fwd_dev_ms = library_device_ms(
                lambda: F.scaled_dot_product_attention(q3, k3, v3))
        lib_dev_ms = library_device_ms(sdpa_fwd_bwd) - fwd_dev_ms
        bound_ms, bound_by, flops, nbytes = attention_bwd_bound(bt * ht, t, D)
        row = dict(B=bt, H=ht, T=t,
                   max_abs_err=max(e[1] for e in errs),
                   errors={n: e for n, e, _ in errs}, ms=ms,
                   ms_bh_t_d=ms_flat, device_ms=dev_ms,
                   device_ms_dq=dq_ms, device_ms_dkv=dkv_ms, plain_ms=plain_ms,
                   library_ms=library_ms, library_device_ms=lib_dev_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes, **events_kept(kept), **events_kept(
                       kept_dq, "_dq"), **events_kept(kept_dkv, "_dkv"))
        rows.append(row)
        print(f"[kernel] flash_attn_bwd B={bt} H={ht} T={t} D={D}: "
              + ", ".join(f"{n} err {e:.3e} (max |plain| {m:.3e})"
                          for n, e, m in errs)
              + f"; [B, T, H, D] views = [B*H, T, D] and repeat bit for "
              f"bit, 2 device launches a call; wrapper {ms:.4f} ms on the "
              f"views ({ms_flat:.4f} on [B*H, T, D]), device {dev_ms:.4f} ms "
              f"(dq {dq_ms:.4f} + dk/dv {dkv_ms:.4f}), plain {plain_ms:.4f} "
              f"ms, sdpa bwd "
              f"{library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


def phase_layernorm_bwd(shapes=(LN_SHAPE,) + LN_EDGES):
    """layernorm_bwd against its plain version at each of `shapes` (LN_SHAPE
    and the LN_EDGES shapes), bf16, each timed beside its bound, plain and
    library times: every call one device launch, and dx, dgamma, dbeta of
    a second call identical bit for bit. Returns the first shape's row
    with every shape's under "per_shape"."""
    import torch

    from occm_tpu_torch.ops.layernorm import (
        layer_norm_bwd, layer_norm_bwd_reference)

    gen = torch.Generator(device="cuda").manual_seed(2)
    eps = 1e-5
    rows = []
    for m, d in shapes:
        x = torch.randn((m, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        g = torch.randn((m, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        gamma = 1.0 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        got = layer_norm_bwd(x, gamma, g, eps)
        again = layer_norm_bwd(x, gamma, g, eps)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"layernorm_bwd [{m}, {d}]: two calls differ")
        want = layer_norm_bwd_reference(x, gamma, g, eps)
        errs = {}
        for name, a, b, rtol in zip(
                ("dx", "dgamma", "dbeta"), got, want,
                (LN_DX_RTOL_OF_MAX, LN_DPARAM_RTOL_OF_MAX,
                 LN_DPARAM_RTOL_OF_MAX)):
            err = (a.float() - b.float()).abs().max().item()
            scale = b.float().abs().max().item()
            if not (math.isfinite(err) and err <= rtol * scale):
                fail(f"layernorm_bwd [{m}, {d}]: max |{name} - plain| = "
                     f"{err} > {rtol} * {scale}")
            errs[name] = err
        dev_ms, own, every, kept = device_ms(
            lambda: layer_norm_bwd(x, gamma, g, eps), ("layernorm_bwd",),
            counters=("layernorm_bwd",))
        if (own, every) != (1, 1):
            fail(f"layernorm_bwd [{m}, {d}]: {every} device launches a call "
                 f"({own} of the kernel), want 1")
        ms = cuda_ms(lambda: layer_norm_bwd(x, gamma, g, eps))
        plain_ms = cuda_ms(lambda: layer_norm_bwd_reference(x, gamma, g,
                                                            eps))
        gb = gamma.to(torch.bfloat16)
        bb = torch.zeros_like(gb)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], gb, bb, eps)
        library_ms = cuda_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [d], mean, rstd, gb, bb, [True, True, True]))
        lib_dev_ms = library_device_ms(
            lambda: torch.ops.aten.native_layer_norm_backward(
                g, x, [d], mean, rstd, gb, bb, [True, True, True]))
        nbytes = 3.0 * m * d * 2 + 3.0 * d * 4
        flops = 12.0 * m * d
        bound_ms, bound_by = bytes_bound(nbytes, flops)
        print(f"[kernel] layernorm_bwd [{m}, {d}] bf16: "
              + ", ".join(f"{n} err {e:.3e}" for n, e in errs.items())
              + f", repeat bit-identical, 1 device launch a call, device "
              f"{dev_ms:.4f} ms, wrapper {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, aten native_layer_norm_backward {library_ms:.4f} ms "
              f"(device {lib_dev_ms:.4f}), bound {bound_ms:.4f} ms "
              f"({bound_by}; {flops:.4g} flop, {nbytes:.4g} B)", flush=True)
        rows.append(dict(shape=[m, d], max_abs_err=max(errs.values()),
                         errors=errs, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes,
                         **events_kept(kept)))
    return dict(rows[0], per_shape=rows)


#: phase_fused_adam's models with random weights from seed 0, by XLSR
#: config: built once on the host (an init of 300M parameters there takes
#: seconds) for the rows at every mesh's shards
ADAM_MODELS = {}


def phase_fused_adam(xcfg=None, odd_leaves: bool = True, mesh=None):
    """fused_adam over every leaf of AModel(AASISTConfig(), xcfg) (XLS-R
    300M by default) in one launch against its plain version and
    torch.optim.Adam(fused=True); with odd_leaves, the edge cases of
    phase_fused_adam_odd_leaves first. mesh (MeshConfig fields): over
    rank 0's shards of the leaves on that mesh (what its launch updates
    there: its fsdp / tp shards, its pipeline stage's layers)."""
    import torch

    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops import fused_adam
    from occm_tpu_torch.ops.fused_adam import (
        FusedAdam, adam_reference, bias_corrections_of)
    from occm_tpu_torch.utils import random_init_

    odd_err = phase_fused_adam_odd_leaves() if odd_leaves else 0.0
    xcfg = xcfg or XLSRConfig()
    key = repr(xcfg)
    if key not in ADAM_MODELS:
        ADAM_MODELS[key] = random_init_(AModel(AASISTConfig(), xcfg), seed=0)
    model = ADAM_MODELS[key]
    params = [p.detach().to("cuda") for p in model.parameters()]
    label = ""
    if mesh:
        from occm_tpu_torch.config import MeshConfig
        from occm_tpu_torch.parallel import make_mesh, param_shardings
        from occm_tpu_torch.parallel.sharding import shard_of

        ranks = make_mesh(MeshConfig(**mesh),
                          world_size=int(np.prod(list(mesh.values()))))
        named = list(model.named_parameters())
        table = param_shardings(named, ranks)
        params = [shard_of(p, table[n], ranks, 0)
                  for p, (n, _) in zip(params, named)]
        params = [p for p in params if p.numel()]  # another stage's: none
        label = f" (rank 0's shards on {mesh})"
    del model
    n = sum(p.numel() for p in params)
    gen = torch.Generator(device="cuda").manual_seed(3)
    grads = [torch.randn(p.shape, generator=gen, device="cuda")
             for p in params]
    opt = FusedAdam(1e-5).init(params)
    # moments from two earlier steps, so step 3's bias corrections and
    # moment decay are exercised
    for m_, v_, g_ in zip(opt.mu, opt.nu, grads):
        m_.copy_(0.1 * g_)
        v_.copy_(0.001 * g_ * g_)
    opt.count = 2
    ref = [(p.clone(), m_.clone(), v_.clone())
           for p, m_, v_ in zip(params, opt.mu, opt.nu)]
    before = fused_adam.LAUNCHES
    opt.step(params, grads)
    torch.cuda.synchronize()
    if fused_adam.LAUNCHES - before != 1:
        fail(f"fused_adam: a step over {len(params)} leaves made "
             f"{fused_adam.LAUNCHES - before} launches, want 1")
    # the kernel read its step count (3) from the device; the plain version
    # computes the corrections from the same tensor
    if opt.count != 3:
        fail(f"fused_adam: step count {opt.count} after a step from 2")
    inv_bc1, inv_bc2 = bias_corrections_of(opt.count_t, opt.b1, opt.b2)
    err = 0.0
    for (p0, m0, v0), p, m_, v_, g_ in zip(ref, params, opt.mu, opt.nu,
                                           grads):
        adam_reference(p0, m0, v0, g_, inv_bc1, inv_bc2, opt.lr, opt.b1,
                       opt.b2, opt.eps)
        for a, b in ((p, p0), (m_, m0), (v_, v0)):
            err = max(err, (a - b).abs().max().item())
    del ref
    if not (math.isfinite(err) and err <= ADAM_ATOL):
        fail(f"fused_adam: max |p, m, v - plain| = {err} > {ADAM_ATOL}")
    ms = cuda_ms(lambda: opt.step(params, grads), iters=5, warmup=1)
    # in full runs on the H100 every session of the fsdp=2 shards' row
    # recorded 9 device events for 5 calls, the kernel's own 5 whole
    dev_ms, _, _, kept = device_ms(
        lambda: opt.step(params, grads), ("fused_adam",), warmup=1,
        whole_others=False, counters=("fused_adam",))
    m_list, v_list = opt.mu, opt.nu
    plain_ms = cuda_ms(lambda: [adam_reference(
        p, m_, v_, g_, inv_bc1, inv_bc2, opt.lr, opt.b1, opt.b2, opt.eps)
        for p, m_, v_, g_ in zip(params, m_list, v_list, grads)],
        iters=3, warmup=1)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for lp, g_ in zip(lib_params, grads):
        lp.grad = g_
    lib_opt = torch.optim.Adam(lib_params, lr=1e-5, fused=True)
    library_ms = cuda_ms(lib_opt.step, iters=5, warmup=1)
    # every profiler session of torch's fused Adam on an H100 may record a
    # count of device events that is not a whole multiple of its calls
    # (over the shards late in a full run; over the whole model early in
    # one, 144 of 145 in each of 8 sessions on one machine): take the
    # session that kept the most, as for other plain PyTorch
    lib_dev_ms = calls_device_ms(lib_opt.step, iters=5, warmup=1)[0]
    del lib_opt, lib_params
    nbytes = 28.0 * n
    bound_ms, bound_by = bytes_bound(nbytes, 10.0 * n)
    print(f"[kernel] fused_adam over {len(params)} leaves, {n} fp32 params"
          f"{label} (1 launch): max err {err:.3e} (bound {ADAM_ATOL}; odd leaves "
          f"{odd_err:.3e}), wrapper {ms:.4f} ms/step, device {dev_ms:.4f} "
          f"ms, "
          f"plain {plain_ms:.4f} ms, torch Adam(fused=True) "
          f"{library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
          f"{bound_ms:.4f} ms ({bound_by}; {nbytes:.4g} B)", flush=True)
    return dict(leaves=len(params), params=n, max_abs_err=max(err, odd_err),
                ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, library_ms=library_ms,
                library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, **events_kept(kept))


def phase_fused_adam_odd_leaves() -> float:
    """FusedAdam over leaves that test the kernel's edges: 1, 3 and 1027
    elements (scalar tails), a leaf of two chunks plus 3, an aligned
    [64, 128], a leaf with a None gradient (left as it is), and a leaf that
    is a view 4 bytes past a 16-byte boundary (a clone of its values into a
    buffer at storage offset 1, so the kernel takes its scalar path). One
    launch, held against adam_reference at ADAM_ATOL; returns the largest
    error."""
    import torch

    from occm_tpu_torch.ops import fused_adam
    from occm_tpu_torch.ops.fused_adam import (
        FusedAdam, adam_reference, bias_corrections_of)

    gen = torch.Generator(device="cuda").manual_seed(5)
    shapes = [(1,), (3,), (1027,), (2 * fused_adam.CHUNK + 3,), (64, 128),
              (5,), (777,)]
    none_leaf, view_leaf = 5, 6
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    buf = torch.empty(params[view_leaf].numel() + 1, device="cuda")
    params[view_leaf] = buf[1:].copy_(params[view_leaf])
    if params[view_leaf].data_ptr() % 16 == 0:
        fail("the odd-leaf case's view leaf is 16-byte aligned")
    grads = [None if i == none_leaf else
             torch.randn(s, generator=gen, device="cuda")
             for i, s in enumerate(shapes)]
    opt = FusedAdam(1e-3).init(params)
    for m_, v_, g_ in zip(opt.mu, opt.nu, grads):
        if g_ is not None:
            m_.copy_(0.1 * g_)
            v_.copy_(0.001 * g_ * g_)
    opt.count = 2
    ref = [(p.clone(), m_.clone(), v_.clone())
           for p, m_, v_ in zip(params, opt.mu, opt.nu)]
    before = fused_adam.LAUNCHES
    opt.step(params, grads)
    torch.cuda.synchronize()
    if fused_adam.LAUNCHES - before != 1:
        fail("fused_adam odd leaves: not one launch")
    inv_bc1, inv_bc2 = bias_corrections_of(opt.count_t, opt.b1, opt.b2)
    err = 0.0
    for (p0, m0, v0), p, m_, v_, g_ in zip(ref, params, opt.mu, opt.nu,
                                           grads):
        if g_ is not None:
            adam_reference(p0, m0, v0, g_, inv_bc1, inv_bc2, opt.lr, opt.b1,
                           opt.b2, opt.eps)
        for a, b in ((p, p0), (m_, m0), (v_, v0)):
            err = max(err, (a - b).abs().max().item())
    if not (math.isfinite(err) and err <= ADAM_ATOL):
        fail(f"fused_adam odd leaves: max |p, m, v - plain| = {err} > "
             f"{ADAM_ATOL}")
    if not torch.equal(params[none_leaf], ref[none_leaf][0]):
        fail("fused_adam odd leaves: the leaf without a gradient moved")
    print(f"[kernel] fused_adam odd leaves {shapes} (leaf {none_leaf} "
          f"without a gradient, leaf {view_leaf} at a 4-byte offset): max "
          f"err {err:.3e} (bound {ADAM_ATOL}), 1 launch", flush=True)
    return err


def ffn_bound(m: int, d: int, f: int):
    """Least time for y = GELU(x W1 + b1) W2 + b2 on an H100: two products
    of 2 M D F flops; x, W1, W2, b1, b2 read once and y written once in
    bf16. Returns (bound_ms, bound_by, flops, bytes)."""
    flops = 4.0 * m * d * f
    nbytes = 2.0 * (2 * m * d + 2 * d * f + f + d)
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def phase_ffn(cases=None):
    """ffn_fwd against ffn_reference at `cases` (M, D, F, tanh GELU) or by
    default at the FFN_MS shapes, full width, erf and tanh GELU, and at
    the edge shapes FFN_EDGES (erf), with the
    kernel, plain, library and bound times. Library: the port's
    ffn_impl="xla" sequence, F.linear -> F.gelu -> F.linear in bf16 (three
    calls; no single PyTorch call computes the fused function)."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.ops.ffn import ffn_fwd, ffn_reference

    cfg = XLSRConfig()
    gen = torch.Generator(device="cuda").manual_seed(4)

    def randn(*shape, std=1.0):
        return (std * torch.randn(shape, generator=gen, device="cuda")).to(
            torch.bfloat16)

    weights = {}

    def layer(d, f):
        """fc1.weight [F, D], fc1.bias, fc2.weight [D, F], fc2.bias, as
        the model holds them, and the JAX-layout views it passes."""
        if (d, f) not in weights:
            fc1_w, fc1_b = randn(f, d, std=0.02), randn(f, std=0.02)
            fc2_w, fc2_b = randn(d, f, std=0.02), randn(d, std=0.02)
            weights[d, f] = (fc1_w, fc1_b, fc2_w, fc2_b, fc1_w.t(),
                             fc2_w.t())
        return weights[d, f]

    if cases is None:
        cases = [(m, cfg.encoder_embed_dim, cfg.encoder_ffn_dim, approximate)
                 for m in FFN_MS for approximate in (False, True)]
        cases += [(m, d, f, False) for m, d, f in FFN_EDGES]
    rows = []
    for m, d, f, approximate in cases:
        fc1_w, fc1_b, fc2_w, fc2_b, w1, w2 = layer(d, f)
        x = randn(m, d)
        y = ffn_fwd(x, w1, fc1_b, w2, fc2_b, approximate)
        torch.cuda.synchronize()
        ref = ffn_reference(x, w1, fc1_b, w2, fc2_b, approximate)
        err = (y.float() - ref.float()).abs().max().item()
        scale = ref.float().abs().max().item()
        if not (y.shape == (m, d) and math.isfinite(err)
                and err <= FFN_RTOL_OF_MAX * scale):
            fail(f"ffn_fwd M={m} D={d} F={f} approximate={approximate}: "
                 f"max |y - plain| = {err} > {FFN_RTOL_OF_MAX} * {scale}")
        gelu = "tanh" if approximate else "erf"
        ms = cuda_ms(lambda: ffn_fwd(x, w1, fc1_b, w2, fc2_b, approximate))
        dev_ms, _, _, kept = device_ms(
            lambda: ffn_fwd(x, w1, fc1_b, w2, fc2_b, approximate),
            ("ffn_gemm_kernel",), counters=("ffn_fwd",))
        plain_ms = cuda_ms(lambda: ffn_reference(
            x, w1, fc1_b, w2, fc2_b, approximate), iters=5, warmup=1)
        mode = "tanh" if approximate else "none"
        library_ms = cuda_ms(lambda: F.linear(F.gelu(
            F.linear(x, fc1_w, fc1_b), approximate=mode), fc2_w, fc2_b))
        lib_dev_ms = library_device_ms(lambda: F.linear(F.gelu(
            F.linear(x, fc1_w, fc1_b), approximate=mode), fc2_w, fc2_b))
        bound_ms, bound_by, flops, nbytes = ffn_bound(m, d, f)
        rows.append(dict(M=m, D=d, F=f, gelu=gelu, max_abs_err=err,
                         max_abs_y=scale, ms=ms, device_ms=dev_ms,
                         plain_ms=plain_ms, library_ms=library_ms,
                         library_device_ms=lib_dev_ms, bound_ms=bound_ms,
                         bound_by=bound_by, flops=flops, bytes=nbytes,
                         **events_kept(kept)))
        print(f"[kernel] ffn_fwd [{m}, {d}] x [{d}, {f}] bf16, {gelu}: "
              f"max_err {err:.3e} (bound {FFN_RTOL_OF_MAX} * {scale:.3e})"
              f", wrapper {ms:.4f} ms, device {dev_ms:.4f} ms (fc1 + fc2), "
              f"plain {plain_ms:.4f} ms, ffn_impl=xla sequence (F.linear, F.gelu, F.linear) "
              f"{library_ms:.4f} ms (device {lib_dev_ms:.4f}), bound "
              f"{bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


# ------------------------------------------------------ scoring (phase 4)

def build_seed_model(workdir: str):
    """The full-width AModel with random weights from seed 0, on the card
    in eval mode, and its state dict saved as a reference-named .pt."""
    import torch

    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.utils import random_init_

    xcfg = XLSRConfig()
    t0 = time.perf_counter()
    model = random_init_(AModel(AASISTConfig(), xcfg), seed=0).to(
        "cuda").eval()
    ckpt = os.path.join(workdir, "amodel_seed0.pt")
    torch.save(model.state_dict(), ckpt)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main] AModel(AASISTConfig(), XLSRConfig()): {n_params} params, "
          f"{xcfg.encoder_layers} layers d={xcfg.encoder_embed_dim} "
          f"ffn={xcfg.encoder_ffn_dim} heads={xcfg.encoder_heads} "
          f"dtype={xcfg.dtype}; init + save {time.perf_counter() - t0:.1f} s",
          flush=True)
    return model, ckpt


# The tiny model on the card against itself on the CPU: both fp32 with TF32
# off (phase 1), so they differ only by the order of fp32 sums through two
# layers and the backend (relative ~1e-6; the 3xTF32 kernels' split adds
# ~1e-6 of each product), whether attention is the plain einsum or the
# kernels against their plain version; 1e-3 of the largest |value| holds
# that and fails on a wrong route or layout.
TINY_RTOL_OF_MAX = 1e-3


def phase_tiny_auto():
    """XLSRConfig.tiny() is fp32 with head dim 16, whose forward
    `cuda_route` gives the 3xTF32 kernel (csrc/flash_attn_fwd_3xtf32.cu; the
    generic one at a head dim outside TF32_FWD_HEAD_DIMS). On the card, 4
    waves of 1-2 s through BucketedEmbedder and make_embed_fn_factory (what
    oc_classifier, embed and oc_server run), in two buckets: under auto
    each bucket runs what the measured policy picks for that route
    (impl_select.auto_flash_min_samples), and a pinned "flash" runs the
    route's forward (2 launches a batch, none of the other forwards); both
    agree with the same model on the CPU. Above head dim 256 auto keeps
    "xla" (AUTO_OVER_256_MIN_SAMPLES is None until measured): a tiny model
    with head dim 260 launches nothing under auto, and a pinned "flash"
    runs the generic forward's panels (a launch a layer, no other
    forward), within TINY_RTOL_OF_MAX of the same model on the CPU."""
    import torch

    from occm_tpu_torch.classify import (
        BucketedEmbedder, make_embed_fn_factory)
    from occm_tpu_torch.classify.impl_select import (
        auto_flash_min_samples, select_attention_impl)
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.serve import make_score_fn
    from occm_tpu_torch.utils import random_init_

    xcfg = XLSRConfig.tiny()
    layers = xcfg.encoder_layers
    fwd = fwd_counter(xcfg.dtype, xcfg.encoder_embed_dim // xcfg.encoder_heads)
    others = {"flash_attn_3xtf32_fwd", "flash_attn_generic_fwd",
              "flash_attn_fwd", "flash_attn_fwd_other_d",
              "flash_attn_fwd_panel"} - {fwd}
    floor = auto_flash_min_samples(xcfg, "cuda")
    model = random_init_(AModel(AASISTConfig.tiny(), xcfg), seed=0)
    rng = np.random.default_rng(3)
    waves = [synthetic_wave(rng, sec) for sec in (1.0, 1.5, 1.7, 2.0)]
    buckets = (SR, 2 * SR)  # one wave in the first, three in the second

    def embed(device, impl):
        emb, logits = BucketedEmbedder(
            embed_fn_factory=make_embed_fn_factory(model, impl),
            bucket_step=SR, batch_size=4, device=device).embed_all(waves)
        return emb, logits

    out = {}
    for impl in ("auto", "flash"):
        want = embed("cpu", impl)
        model.to("cuda")
        reset_counts()
        got = embed("cuda", impl)
        counts = read_counts()
        model.to("cpu")
        picked = [select_attention_impl(b, min_samples=floor)
                  if impl == "auto" else "flash" for b in buckets]
        n_flash = layers * picked.count("flash")
        if counts[fwd] != n_flash or any(counts[k] for k in others):
            fail(f"tiny model, {impl} attention on the card: launches "
                 f"{counts}, want {n_flash} {fwd} launches "
                 f"(buckets {buckets} -> {picked}) and no other forward")
        for name, a, b in zip(("embeddings", "logits"), got, want):
            err = float(np.abs(a - b).max())
            scale = float(np.abs(b).max())
            if not (a.shape == b.shape and np.isfinite(a).all()
                    and err <= TINY_RTOL_OF_MAX * scale):
                fail(f"tiny model, {impl} attention on the card: {name} "
                     f"{a.shape} max |cuda - cpu| = {err} > "
                     f"{TINY_RTOL_OF_MAX} * {scale}")
        out[impl] = dict(picked=picked, forward=fwd, launches=n_flash,
                         emb_max_abs_err=float(np.abs(got[0] - want[0]).max()))
    # a head dim above 256: xla under auto, a pinned flash runs the
    # generic forward's panels
    wide = dataclasses.replace(xcfg, encoder_embed_dim=1040)  # D = 260
    model = random_init_(AModel(AASISTConfig.tiny(), wide), seed=0)
    x = torch.from_numpy(np.stack([w[:SR] for w in waves]))
    want = make_score_fn(model, "flash")(x)
    model.to("cuda")
    x = x.to("cuda")
    reset_counts()
    make_embed_fn_factory(model, "auto")(SR)(x)
    make_embed_fn_factory(model, "auto")(40 * SR)(x)
    if any(read_counts().values()):
        fail(f"a head dim of 260 under auto launched a kernel: "
             f"{read_counts()}")
    got = make_score_fn(model, "flash")(x)
    counts = read_counts()
    wide_fwd = fwd_counter(wide.dtype, 260)
    if counts[wide_fwd] != layers or any(counts[k] for k in others | {fwd}
                                         if k != wide_fwd):
        fail(f"head dim 260 with a pinned flash impl: launches {counts}, "
             f"want {layers} {wide_fwd} launches and no other forward")
    for name, a, b in zip(("embeddings", "logits"), got, want):
        a = a.cpu()
        err = float((a - b).abs().max())
        if not (a.shape == b.shape and bool(torch.isfinite(a).all())
                and err <= TINY_RTOL_OF_MAX * float(b.abs().max())):
            fail(f"head dim 260, pinned flash on the card: {name} max "
                 f"|cuda - cpu| = {err}")
    out["d260_pinned_flash"] = dict(forward=wide_fwd, launches=layers,
                                    emb_max_abs_err=float(
                                        (got[0].cpu() - want[0]).abs().max()))
    print(f"[tiny] XLSRConfig.tiny() (fp32, head dim 16) on the card: "
          f"{len(waves)} waves of 1-2 s in buckets {buckets}; auto picks "
          f"{out['auto']['picked']} (threshold {floor} samples), a pinned "
          f"flash runs {fwd} ({out['flash']['launches']} launches); "
          f"embeddings within {TINY_RTOL_OF_MAX} of the largest |value| of "
          f"the CPU's both ways; head dim 260: xla under auto (no launch), "
          f"a pinned flash runs {wide_fwd} ({layers} launches), within "
          f"{TINY_RTOL_OF_MAX} of the CPU's", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


# Eval utterances of the scoring phase, seconds: with oc_classifier's
# default --bucket_step 16000 they fill the 3 s and 4 s buckets (plain
# attention under auto) and nine buckets of 5-13 s (the flash kernel; 11 s
# and up have T > 512 frames, the JAX package's blocked route).
EVAL_SECONDS = (3.0, 3.0, 3.6, 3.9, 4.5, 5.4, 5.9, 6.3, 7.2, 8.5, 9.6, 10.5,
                11.2, 11.9, 12.6, 13.0)
# pallas vs xla FFN distances through the whole 24-layer model: the xla path
# rounds fc1's output to bf16 before the GELU, the fused kernel applies the
# GELU in fp32 and rounds after it: a relative 2^-9 per hidden element per
# layer, carried through 24 layers as the flash-vs-xla attention rounding
# is (SCORE_RTOL's argument), so the same relative bound.
FFN_SCORE_RTOL = SCORE_RTOL
THROUGHPUT_REPS = 4


def write_eval_set(root: str, seed: int = 1, seconds=EVAL_SECONDS):
    """A bare eval list over waves of `seconds`, trial metadata with
    labels (column 2 utt, column 6 label) and a 5-column protocol of the
    same utterances and labels."""
    from occm_tpu_torch.io.wav import write_wav

    eval_dir = os.path.join(root, "eval")
    os.makedirs(eval_dir)
    rng = np.random.default_rng(seed)
    utts, meta, proto = [], [], []
    for i, sec in enumerate(seconds):
        utt = f"LA_E_{i:05d}"
        write_wav(os.path.join(eval_dir, utt + ".wav"),
                  synthetic_wave(rng, sec), SR)
        label = "spoof" if i % 2 else "bonafide"
        utts.append(utt)
        meta.append(f"LA_{i:04d} {utt} - asvspoof A09 {label} notrim eval "
                    "- - - -")
        proto.append(f"LA_{i:04d} {utt} - - {label}")
    paths = {}
    for name, lines in (("eval.txt", utts), ("metadata.txt", meta),
                        ("eval5.txt", proto)):
        paths[name] = os.path.join(root, name)
        with open(paths[name], "w") as f:
            f.write("\n".join(lines) + "\n")
    return eval_dir, paths


def flash_batches(lengths, batch: int = 8, step: int = 16000) -> int:
    """Batches the scorer runs through the flash kernel under auto for
    utterances of these sample counts: per bucket, ceil(count / batch)."""
    from occm_tpu_torch.classify.impl_select import select_attention_impl

    counts = {}
    for n in lengths:
        b = max(step, -(-n // step) * step)
        counts[b] = counts.get(b, 0) + 1
    return sum(-(-c // batch) for b, c in counts.items()
               if select_attention_impl(b) == "flash")


def utt_per_s(fns, x) -> dict:
    """Utterances per second of each fn on batch x, timed in turns
    (A B ... B A) on the host clock around synchronised runs of
    THROUGHPUT_REPS calls each."""
    import torch

    times = dict.fromkeys(fns, 0.0)
    for fn in fns.values():
        fn(x)  # warm-up: kernels, allocator pools, cuDNN plans
    for k in list(fns) + list(fns)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(THROUGHPUT_REPS):
            fns[k](x)
        torch.cuda.synchronize()
        times[k] += time.perf_counter() - t0
    return {k: 2 * THROUGHPUT_REPS * x.shape[0] / t for k, t in times.items()}


def phase_scoring(workdir: str, model, ckpt: str, fixture):
    """Offline scoring and evaluation at full width: `oc_classifier` in
    1c2 and 2c2 mode on the fixture's train protocol and a bare eval list
    (attention auto per bucket, ffn "xla" as the CLI runs it), the same eval
    set through OneClassScorer with ffn_impl="pallas" (the fused FFN kernel)
    gated against the CLI's distances, EER and confusion matrix from the
    score files, and utterances/s per bucket. Returns the artefacts'
    directory and the kernels' launches."""
    import torch

    from occm_tpu_torch.audio import pad_numpy
    from occm_tpu_torch.classify import (
        BucketedEmbedder, OneClassScorer, make_embed_fn_factory)
    from occm_tpu_torch.classify.impl_select import (
        AUTO_FLASH_MIN_SAMPLES, select_attention_impl)
    from occm_tpu_torch.cli import oc_classifier
    from occm_tpu_torch.cli.oc_server import build_model
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.data import ASVDataset
    from occm_tpu_torch.evaluate import calculate_eer_merged, evaluate_scores
    from occm_tpu_torch.io.scorefiles import read_comma_scores
    from occm_tpu_torch.io.wav import load_audio
    from occm_tpu_torch.serve import make_score_fn

    protocol, train_dir, _ = fixture
    root = os.path.join(workdir, "scoring")
    os.makedirs(root)
    eval_dir, paths = write_eval_set(root)
    layers = XLSRConfig().encoder_layers
    eval_ds = ASVDataset(paths["eval.txt"], eval_dir, eval=True)
    train_ds = ASVDataset(protocol, train_dir)
    eval_lens = [len(load_audio(p)[0]) for p in eval_ds.file_paths()]
    train_lens = [len(load_audio(p)[0]) for p in train_ds.file_paths()]
    n_eval, n_train = len(eval_lens), len(train_lens)
    eval_buckets = sorted({max(16000, -(-n // 16000) * 16000)
                           for n in eval_lens})
    flash_eval = flash_batches(eval_lens)
    flash_train = flash_batches(train_lens)
    print(f"[score] eval set: {n_eval} utterances of {EVAL_SECONDS[0]}-"
          f"{EVAL_SECONDS[-1]} s in buckets {eval_buckets} "
          f"({flash_eval} flash batches under auto); train protocol: "
          f"{n_train} bonafide rows (the 2 spoof rows are filtered out)",
          flush=True)

    # ---- the CLI, as a user runs it: 1c2, then 2c2
    argv = ["--pretrained-sslaasist", ckpt, "--protocol_file", protocol,
            "--dataset_dir", train_dir, "--eval_protocol_file",
            paths["eval.txt"], "--eval_dataset_dir", eval_dir]
    scores = {m: os.path.join(root, f"scores_{m}.txt") for m in ("1c2", "2c2")}
    cwd = os.getcwd()
    os.chdir(root)  # reference_embedding.npy, threshold.npy land here
    launches = {"flash_attn_fwd": 0}
    try:
        for mode, want_batches in (("1c2", flash_train + flash_eval),
                                   ("2c2", flash_eval)):
            reset_counts()
            t0 = time.perf_counter()
            oc_classifier.main(argv + ["--mode", mode, "--score_file",
                                       scores[mode]])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts()
            if counts["flash_attn_fwd"] != layers * want_batches or \
                    counts["ffn_fwd"] != 0:
                fail(f"oc_classifier {mode}: launches {counts}, want "
                     f"flash_attn_fwd {layers * want_batches}, ffn_fwd 0")
            launches["flash_attn_fwd"] += counts["flash_attn_fwd"]
            print(f"[score] oc_classifier --mode {mode}: {wall:.1f} s "
                  "(model load included), launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    finally:
        os.chdir(cwd)
    for name in ("reference_embedding.npy", "threshold.npy", "distances.txt"):
        if not os.path.exists(os.path.join(root, name)):
            fail(f"oc_classifier 1c2 wrote no {name}")
    reference = np.load(os.path.join(root, "reference_embedding.npy"))
    threshold = float(np.load(os.path.join(root, "threshold.npy")))
    train_d = np.loadtxt(os.path.join(root, "distances.txt"))
    if not (reference.shape == (160,) and np.isfinite(reference).all()
            and train_d.shape == (n_train,)
            and math.isfinite(threshold) and threshold == np.float32(
                train_d.max())):
        fail(f"bad artefacts: reference {reference.shape}, threshold "
             f"{threshold}, distances {train_d}")
    lines_1c = open(scores["1c2"]).read().splitlines(keepends=True)
    d_cli = np.asarray(read_comma_scores(scores["1c2"]))
    logits = np.loadtxt(scores["2c2"])
    if len(lines_1c) != n_eval or logits.shape != (n_eval,):
        fail(f"score files: {len(lines_1c)} and {logits.shape} lines, want "
             f"{n_eval}")
    for line, d in zip(lines_1c, d_cli):
        if line != f"{d}, {int(d > threshold)} \n" or not math.isfinite(d):
            fail(f"bad 1c score line {line!r}")
    if not np.isfinite(logits).all():
        fail(f"2c logits not finite: {logits}")
    print(f"[score] artefacts: reference {reference.shape}, threshold "
          f"{threshold:.6f} (max of {n_train} train distances); 1c "
          f"distances {np.round(d_cli, 4).tolist()}; 2c logits "
          f"{np.round(logits, 4).tolist()}", flush=True)

    # ---- the fused FFN kernel's path: same checkpoint, ffn_impl="pallas"
    pallas = build_model(XLSRConfig(ffn_impl="pallas"), ckpt, False, "cuda")
    scorer = OneClassScorer(BucketedEmbedder(
        embed_fn_factory=make_embed_fn_factory(pallas), device="cuda"),
        cache_dir=root)
    pallas_file = os.path.join(root, "scores_1c2_pallas.txt")
    reset_counts()
    scorer.score_eval_set_1c(eval_ds, reference, threshold,
                             score_file=pallas_file)
    torch.cuda.synchronize()
    counts = read_counts()
    n_batches = len(eval_buckets)
    if counts["ffn_fwd"] != layers * n_batches:
        fail(f"ffn_impl=pallas scoring: ffn_fwd launched {counts['ffn_fwd']}"
             f" times over {n_batches} batches, want {layers * n_batches}")
    launches["ffn_fwd"] = counts["ffn_fwd"]
    launches["flash_attn_fwd"] += counts["flash_attn_fwd"]
    d_pallas = np.asarray(read_comma_scores(pallas_file))
    rel = np.abs(d_pallas - d_cli) / np.abs(d_cli)
    print(f"[score] ffn_impl=pallas: ffn_fwd launches {counts['ffn_fwd']} "
          f"({layers} x {n_batches} batches); distances vs the CLI's "
          f"(ffn xla): max rel diff {rel.max():.3e} (bound {FFN_SCORE_RTOL})",
          flush=True)
    if not rel.max() <= FFN_SCORE_RTOL:
        fail(f"pallas and xla FFN distances disagree: rel {rel}")

    # ---- evaluation of the score files
    res = evaluate_scores(scores["1c2"], paths["eval.txt"],
                          paths["metadata.txt"], threshold=threshold)
    utt_file = os.path.join(root, "utt_scores_2c.txt")
    with open(utt_file, "w") as f:
        for utt, lg in zip(open(paths["eval.txt"]).read().split(), logits):
            f.write(f"{utt} {float(lg)}\n")
    eer_2c, _ = calculate_eer_merged(paths["eval5.txt"], utt_file)
    for name, eer in (("1c (evaluate_scores)", res["eer"]),
                      ("2c (calculate_eer_merged)", eer_2c)):
        if not (math.isfinite(eer) and 0.0 <= eer <= 1.0):
            fail(f"EER {name} = {eer}")
    print(f"[score] EER 1c {res['eer'] * 100.0:.2f} % (threshold "
          f"{res['eer_threshold']:.6f}), 2c {eer_2c * 100.0:.2f} %; "
          f"confusion matrix {res['confusion_matrix'].tolist()} "
          "(random weights: the values only show the pipeline runs)",
          flush=True)

    # ---- utterances/s at a full batch of 8 per bucket
    rng = np.random.default_rng(7)
    rows = []
    for bucket in sorted(set(eval_buckets) | {16000, 32000}):
        x = torch.from_numpy(np.stack([pad_numpy(
            synthetic_wave(rng, bucket / SR), bucket) for _ in range(8)])
        ).to("cuda")
        fns = {"xla": make_score_fn(model, "xla"),
               "flash": make_score_fn(model, "flash")}
        if bucket in (96000, 192000):
            fns["flash+ffn_pallas"] = make_score_fn(pallas, "flash")
        row = dict(bucket=bucket, auto=select_attention_impl(bucket),
                   **utt_per_s(fns, x))
        rows.append(row)
        print(f"[score] bucket {bucket} ({bucket / SR:.0f} s), batch 8, "
              "utt/s: " + ", ".join(f"{k} {v:.2f}" for k, v in row.items()
                                    if isinstance(v, float))
              + f" (auto picks {row['auto']})", flush=True)
    wins = [r["bucket"] for r in rows if r["flash"] > r["xla"]]
    print(f"[score] flash beats xla attention in buckets {wins}; first "
          f"{wins[0] if wins else None} (AUTO_FLASH_MIN_SAMPLES "
          f"{AUTO_FLASH_MIN_SAMPLES})", flush=True)
    del pallas, scorer
    torch.cuda.empty_cache()
    return root, launches, rows


# ----------------------------------------------------------------- phase 5

def wav_bytes(x: np.ndarray, sr: int = SR) -> bytes:
    pcm = (np.clip(x, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    return hdr + b"data" + struct.pack("<I", len(pcm)) + pcm


def synthetic_wave(rng: np.random.Generator, seconds: float) -> np.ndarray:
    """A few random tones plus noise, amplitude ~0.3, 16 kHz float32."""
    n = int(seconds * SR)
    t = np.arange(n) / SR
    x = sum(rng.uniform(0.05, 0.1) * np.sin(2 * np.pi * rng.uniform(80, 4000)
                                             * t + rng.uniform(0, 6.3))
            for _ in range(4))
    x = x + 0.02 * rng.standard_normal(n)
    return x.astype(np.float32)


def post(port: int, body: bytes, headers=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/score",
                                 data=body, method="POST",
                                 headers=headers or {})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as resp:
        status = resp.status
        payload = json.loads(resp.read())
    return status, payload, (time.perf_counter() - t0) * 1e3


def check_response(name, status, payload):
    if status != 200:
        fail(f"{name}: HTTP {status} {payload}")
    if not (isinstance(payload.get("score"), float)
            and math.isfinite(payload["score"])):
        fail(f"{name}: score not finite: {payload}")
    if payload.get("prediction") not in (0, 1):
        fail(f"{name}: prediction not in {{0, 1}}: {payload}")


@contextlib.contextmanager
def serving(argv, what: str = "oc_server"):
    """`oc_server.main(argv)` on a thread, as a user starts it; yields its
    started event (`.server.port`, `.service`) once it is up, then stops
    and joins it. A server that does not start or stop fails the run."""
    from occm_tpu_torch.cli import oc_server

    started = threading.Event()
    started.stop = threading.Event()
    errors = []

    def serve():
        try:
            oc_server.main(argv, started_event=started)
        except BaseException as e:  # surfaced below, never swallowed
            errors.append(e)
            started.set()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    if not started.wait(900) or errors:
        fail(f"{what} did not start: {errors}")
    try:
        yield started
    finally:
        started.stop.set()
        th.join(120)
    if th.is_alive() or errors:
        fail(f"{what} did not stop cleanly: {errors}")


def phase_main_path(model, ckpt: str, artifacts_dir: str):
    """Serving: `oc_server` on the checkpoint, from the reference embedding
    and threshold that the scoring phase's `oc_classifier` wrote."""
    import torch

    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.ops import attention
    from occm_tpu_torch.serve import ScoringService, make_score_fn

    dev = torch.device("cuda")
    per_batch = XLSRConfig().encoder_layers  # one kernel launch per layer
    reference = np.load(os.path.join(artifacts_dir, "reference_embedding.npy"))
    threshold = float(np.load(os.path.join(artifacts_dir, "threshold.npy")))
    print(f"[main] serving from oc_classifier's artefacts: reference "
          f"embedding {reference.shape}, threshold {threshold:.6f}",
          flush=True)
    rng = np.random.default_rng(0)

    # --- the server, as a user starts it
    attention.LAUNCHES = 0
    t0 = time.perf_counter()
    with serving(["--pretrained-sslaasist", ckpt, "--artifacts_dir",
                  artifacts_dir, "--host", "127.0.0.1", "--port", "0",
                  "--max_wait_ms", "100"], "server") as started:
        port = started.server.port
        service = started.service
        warm_launches = attention.LAUNCHES
        print(f"[main] server up on port {port} in "
              f"{time.perf_counter() - t0:.1f} s (load + warmup of "
              f"{service.buckets}); warmup launches {warm_launches}",
              flush=True)
        # one warmup batch per bucket; the flash buckets launch the kernel
        warm_want = per_batch * sum(select_attention_impl(b) == "flash"
                                    for b in service.buckets)
        if warm_launches != warm_want:
            fail(f"warmup launched the kernel {warm_launches} times, want "
                 f"{warm_want}")

        # count the device batches per bucket the batcher forms
        batches = []
        score = service.score

        def counting_score(waves):
            batches.append([service._bucket_for(len(w)) for w in waves])
            return score(waves)

        service.score = counting_score

        w4, w6, w12 = (synthetic_wave(rng, s) for s in (4.0, 6.0, 12.0))
        requests = [
            ("4s_wav", wav_bytes(w4), {}, 64600),
            ("6s_pcm", w6.astype("<f4").tobytes(), {"X-Sample-Rate": "16000"},
             96000),
            ("12s_wav", wav_bytes(w12), {}, 192000),
        ]
        results = {}
        for name, body, hdrs, bucket in requests:
            before = attention.LAUNCHES
            status, payload, ms = post(port, body, hdrs)
            check_response(name, status, payload)
            launched = attention.LAUNCHES - before
            want = per_batch if select_attention_impl(bucket) == "flash" else 0
            if launched != want:
                fail(f"{name} (bucket {bucket}): kernel launched {launched} "
                     f"times, want {want}")
            results[name] = payload["score"]
            print(f"[main] {name}: bucket {bucket}, score "
                  f"{payload['score']:.6f}, prediction "
                  f"{payload['prediction']}, latency {ms:.1f} ms (max_wait "
                  f"100 ms), kernel launches {launched}", flush=True)

        # 8 concurrent 6 s requests: one full batch. Whether all 8 reach the
        # batcher inside one max_wait window is up to the host's scheduler, so
        # a round that splits them is reported and the round is sent again
        # (at most 3 rounds); every round's launches are checked all the same.
        waves8 = [synthetic_wave(rng, 6.0) for _ in range(8)]
        for attempt in range(1, 4):
            out8 = [None] * 8
            go = threading.Barrier(8)

            def client(i):
                go.wait()
                out8[i] = post(port, waves8[i].astype("<f4").tobytes())

            n_batches0 = len(batches)
            before = attention.LAUNCHES
            t0 = time.perf_counter()
            clients = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            wall = time.perf_counter() - t0
            for i, r in enumerate(out8):
                if r is None:
                    fail(f"concurrent request {i} got no response")
                check_response(f"6s_concurrent_{i}", r[0], r[1])
            formed = batches[n_batches0:]
            launched = attention.LAUNCHES - before
            if launched != per_batch * len(formed):
                fail(f"8 x 6 s: {len(formed)} batches but {launched} launches")
            print(f"[main] 8 x 6 s concurrent, round {attempt}: batches "
                  f"{[len(b) for b in formed]}, wall {wall * 1e3:.1f} ms, "
                  f"{8 / wall:.3f} utt/s, latencies "
                  f"{[round(r[2], 1) for r in out8]} ms, kernel launches "
                  f"{launched}", flush=True)
            if max(len(b) for b in formed) == 8:
                break
        else:
            fail(f"no full batch of 8 formed in 3 rounds: {formed}")

        main_launches = attention.LAUNCHES

    # flash (server) vs plain attention on the same waves and buckets
    plain = ScoringService(score_fn=make_score_fn(model, "xla"),
                           reference_embedding=reference,
                           threshold=threshold, buckets=service.buckets,
                           batch=8, device=dev)
    d_plain, _ = plain.score([w6, w12] + waves8)
    d_flash = np.asarray([results["6s_pcm"], results["12s_wav"]]
                         + [r[1]["score"] for r in out8])
    rel = np.abs(d_flash - d_plain) / np.abs(d_plain)
    print(f"[main] flash vs xla distances: max rel diff {rel.max():.3e} "
          f"(bound {SCORE_RTOL}); flash {d_flash[:2]}, xla {d_plain[:2]}",
          flush=True)
    if not rel.max() <= SCORE_RTOL:
        fail(f"flash and xla scores disagree: rel {rel}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[main] peak device memory {peak:.2f} GiB; kernel "
          f"launches on the main path {main_launches} (warmup "
          f"{warm_launches} + requests {main_launches - warm_launches})",
          flush=True)
    return main_launches, reference


# ------------------------------------------------------------- phases 6, 7

VOCODERS = ("hifigan", "hn-sinc-nsf-hifi", "hn-sinc-nsf", "melgan",
            "waveglow")
DEVICE = "cuda"
TRAIN_CUT = 96000  # 6 s: impl_select's auto policy picks the flash kernels
TRAIN_STEPS = 3


def write_fixture(root: str, n_bona: int = 6, n_spoof: int = 2,
                  seed: int = 0):
    """An ASVspoof-shaped tree (the recipe of tests/test_cli_training.py)
    of 6-7 s waves: bonafide and spoof utterances, a train protocol, and
    the 5 vocoded copies of every bonafide one."""
    from occm_tpu_torch.io.wav import write_wav

    train_dir = os.path.join(root, "train")
    voc_dir = os.path.join(root, "vocoded")
    os.makedirs(train_dir)
    os.makedirs(voc_dir)
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n_bona):
        utt = f"LA_T_b{i:04d}"
        wave = synthetic_wave(rng, rng.uniform(6.0, 7.0))
        write_wav(os.path.join(train_dir, utt + ".wav"), wave, SR)
        lines.append(f"LA_{i:04d} {utt} - - bonafide")
        for voc in VOCODERS:
            noisy = wave + 0.01 * rng.standard_normal(wave.shape[0])
            write_wav(os.path.join(voc_dir, f"{voc}_{utt}.wav"), noisy, SR)
    for i in range(n_spoof):
        utt = f"LA_T_s{i:04d}"
        write_wav(os.path.join(train_dir, utt + ".wav"),
                  synthetic_wave(rng, rng.uniform(6.0, 7.0)), SR)
        lines.append(f"LA_{100 + i:04d} {utt} - A01 spoof")
    protocol = os.path.join(root, "train.txt")
    with open(protocol, "w") as f:
        f.write("\n".join(lines) + "\n")
    return protocol, train_dir, voc_dir


def reset_counts():
    from occm_tpu_torch.ops import attention, ffn, fused_adam, layernorm

    attention.LAUNCHES = 0
    attention.BWD_DQ_LAUNCHES = 0
    attention.BWD_DKV_LAUNCHES = 0
    attention.OTHER_D_LAUNCHES = 0
    attention.OTHER_D_BWD_DQ_LAUNCHES = 0
    attention.OTHER_D_BWD_DKV_LAUNCHES = 0
    attention.BWD_DOUT_COPIES = 0
    attention.GENERIC_LAUNCHES = 0
    attention.GENERIC_BWD_DQ_LAUNCHES = 0
    attention.GENERIC_BWD_DKV_LAUNCHES = 0
    attention.TF32_FWD_LAUNCHES = 0
    attention.TF32_BWD_DQ_LAUNCHES = 0
    attention.TF32_BWD_DKV_LAUNCHES = 0
    attention.PANEL_LAUNCHES = 0
    attention.PANEL_BWD_DQ_LAUNCHES = 0
    attention.PANEL_BWD_DKV_LAUNCHES = 0
    layernorm.LAUNCHES = 0
    fused_adam.LAUNCHES = 0
    ffn.LAUNCHES = 0
    ffn.F32_LAUNCHES = 0
    ffn.TF32_LAUNCHES = 0


def read_counts():
    from occm_tpu_torch.ops import attention, launch_counts

    return {**launch_counts(),
            "flash_attn_bwd_dout_copies": attention.BWD_DOUT_COPIES}


class StepRecorder:
    """on_step hook: each step's loss, wall time (after a synchronize) and
    kernel launches."""

    def __init__(self):
        import torch

        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.last = read_counts()
        self.steps = []

    def __call__(self, step, metrics):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = read_counts()
        self.steps.append(dict(
            step=step, loss=float(metrics["loss"]),
            closs=float(metrics["closs"]), dloss=float(metrics["dloss"]),
            ms=(now - self.t0) * 1e3,
            launches={k: counts[k] - self.last[k] for k in counts}))
        self.t0, self.last = now, counts


def check_steps(name, rec, want):
    """Every step's loss finite and its launches as `want` says."""
    if not rec.steps:
        fail(f"{name}: no training step ran")
    for st in rec.steps:
        if not all(math.isfinite(st[k]) for k in ("loss", "closs", "dloss")):
            fail(f"{name}: step {st['step']} loss not finite: {st}")
        for k, n in want.items():
            if st["launches"][k] != n:
                fail(f"{name}: step {st['step']} launched {k} "
                     f"{st['launches'][k]} times, want {n}")
        print(f"[train] {name} step {st['step']}: loss {st['loss']:.6f} "
              f"(closs {st['closs']:.6f}, dloss {st['dloss']:.6f}), "
              f"{st['ms']:.1f} ms, launches {st['launches']}", flush=True)


class ListPipeline:
    """The same batches every epoch (the kernel-vs-plain training runs)."""

    def __init__(self, batches):
        self.batches = batches

    def epoch(self, epoch=0):
        return iter(self.batches)


def phase_train(workdir: str, fixture, profile: bool):
    """Phase 6 (CLI) and phase 7 (train() with every kernel against the
    plain configuration) on the fixture tree (protocol, train_dir,
    voc_dir). Returns the launches of both runs."""
    import dataclasses

    import torch

    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel, load_reference_state_dict
    from occm_tpu_torch.ops.fused_adam import MAX_LEAVES as MAX_ADAM_LEAVES
    from occm_tpu_torch.train import train
    from occm_tpu_torch.utils.logging import MetricsLogger

    protocol, train_dir, voc_dir = fixture
    layers = XLSRConfig().encoder_layers
    launches = {}

    # ---- phase 6: the CLI, as a user runs it
    ckpt_dir = os.path.join(workdir, "ckpt")
    cwd = os.getcwd()
    os.chdir(workdir)  # loss.txt and metrics.jsonl land here
    try:
        reset_counts()
        rec = StepRecorder()
        t0 = time.perf_counter()
        oc_training.main([
            "--train_protocol_file", protocol,
            "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
            "--model", "aasist", "--cut", str(TRAIN_CUT), "--num_epochs", "1",
            "--compactness_weight", "0.1", "--descriptiveness_weight", "0.9",
            "--checkpoint_dir", ckpt_dir], on_step=rec)
        wall = time.perf_counter() - t0
        cli_counts = read_counts()
    finally:
        os.chdir(cwd)
    # remat (the default) runs every layer's forward twice: once in the
    # forward, once in the backward's recompute
    check_steps("cli", rec, {
        "flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
        "flash_attn_bwd_dkv": layers, "flash_attn_bwd_dout_copies": 0,
        "layernorm_bwd": 0, "fused_adam": 0, "ffn_fwd": 0})
    path = os.path.join(ckpt_dir, "aasist_vocoded_0.pt")
    model = AModel(AASISTConfig(), XLSRConfig())
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    print(f"[train] cli: {len(rec.steps)} steps of 12 x {TRAIN_CUT} "
          f"samples in {wall:.1f} s (model build, data, checkpoint "
          f"included); {path} ({os.path.getsize(path) / 2**30:.2f} GiB) "
          f"loads strictly into AModel", flush=True)
    del model

    # ---- phase 7: train() with every kernel, then the plain configuration
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = []
    for x, labels in MetaBatchPipeline(dataset, seed=0).epoch(0):
        batches.append((x, labels))
        if len(batches) == TRAIN_STEPS:
            break
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    impl = select_attention_impl(TRAIN_CUT)
    if impl != "flash":
        fail(f"auto attention at {TRAIN_CUT} samples is {impl!r}, not flash")
    kcfg = XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                      attention_impl=impl)
    pcfg = XLSRConfig(ln_impl="xla", attention_impl="xla")
    base = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                       descriptiveness_weight=0.9, log_every=1,
                       rawboost=RawBoostConfig(algo=0))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = AModel(acfg, kcfg).state_dict()

    # Adam's first update moves every weight by lr * sign(g) (mhat / sqrt(
    # vhat) = g / |g|), so after step 1 the two runs' weights differ only
    # where the two configurations' gradients at the initial weights differ
    # in sign, by 2 * lr there. To first order that moves the loss by at
    # most 2 * lr * sum over those weights of |g|: measured here from both
    # gradients on the first batch (before the counted runs)
    grads = {}
    for name, xcfg in (("plain", pcfg), ("kernels", kcfg)):
        model = AModel(acfg, xcfg)
        model.load_state_dict(init)
        model.to(DEVICE).train()
        emb, logits = model(torch.from_numpy(batches[0][0]).to(DEVICE),
                            generator=torch.Generator().manual_seed(0))
        loss0, _ = group_one_class_loss(
            emb, logits, torch.from_numpy(batches[0][1]).to(DEVICE), 0.1,
            0.9)
        loss0.backward()
        grads[name] = [p.grad for p in model.parameters()]
        del model, emb, logits, loss0
    flip_l1 = 0.0
    for gp, gk in zip(grads["plain"], grads["kernels"]):
        if gp is not None:
            flip = torch.sign(gp) != torch.sign(gk)
            flip_l1 += float(((gp.abs() + gk.abs()) * flip).sum())
    del grads
    torch.cuda.empty_cache()

    runs = {}
    for name, xcfg, opt in (("kernels", kcfg, "fused_adam"),
                            ("plain", pcfg, "adam")):
        cfg = dataclasses.replace(base, optimizer=opt,
                                  loss_txt=os.path.join(
                                      workdir, f"loss_{name}.txt"))
        logger = MetricsLogger(cfg.loss_txt,
                               os.path.join(workdir, f"metrics_{name}.jsonl"))
        model = AModel(acfg, xcfg)
        model.load_state_dict(init)
        leaves = sum(1 for n, _ in model.named_parameters()
                     if ".bn1." not in n)  # bn1 never runs: no gradient
        # one multi-tensor launch per MAX_LEAVES leaves: 1 for the AModel
        adam_launches = -(-leaves // MAX_ADAM_LEAVES)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        rec = StepRecorder()
        if profile and name == "kernels":
            train(model, ListPipeline(batches[:1]), cfg, logger=logger,
                  num_epochs=1, device=DEVICE)  # warm-up before the profile
            phase_profile_train(model, batches[0], cfg)
            model.load_state_dict(init)
            reset_counts()
            rec = StepRecorder()
        train(model, ListPipeline(batches), cfg, logger=logger,
              num_epochs=1, device=DEVICE, on_step=rec)
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        if name == "kernels":
            want = {"flash_attn_fwd": 2 * layers,
                    "flash_attn_bwd_dq": layers,
                    "flash_attn_bwd_dkv": layers,
                    "flash_attn_bwd_dout_copies": 0,
                    "layernorm_bwd": 2 * layers,
                    "fused_adam": adam_launches,
                    "ffn_fwd": 2 * layers}
            kernel_counts = counts
        else:
            want = dict.fromkeys(counts, 0)
        check_steps(f"train() {name}", rec, want)
        runs[name] = rec.steps
        step_ms = [st["ms"] for st in rec.steps]
        print(f"[train] train() {name} ({opt}, attention "
              f"{xcfg.attention_impl}, ln {xcfg.ln_impl}, ffn "
              f"{xcfg.ffn_impl}): step ms "
              f"{[round(x, 1) for x in step_ms]}, peak device memory "
              f"{peak:.2f} GiB", flush=True)
        del model
        torch.cuda.empty_cache()

    # kernel vs plain losses: step 1 is a forward from identical weights,
    # where bf16 attention and LayerNorm round differently (the serving
    # check's relative 5e-2 through 24 layers); each later step adds the
    # sign-flip term above once more, doubled for the change of the
    # gradient over three steps
    for k, (a, b) in enumerate(zip(runs["kernels"], runs["plain"])):
        bound = LOSS_RTOL * abs(b["loss"]) + 2.0 * k * base.lr * flip_l1
        diff = abs(a["loss"] - b["loss"])
        print(f"[train] step {k + 1}: loss kernels {a['loss']:.6f}, plain "
              f"{b['loss']:.6f}, |diff| {diff:.3e} (bound {bound:.3e}; "
              f"sign-flip L1 {flip_l1:.4g})", flush=True)
        if not diff <= bound:
            fail(f"train(): step {k + 1} losses disagree: {diff} > {bound}")

    launches["flash_attn_fwd"] = (cli_counts["flash_attn_fwd"]
                                  + kernel_counts["flash_attn_fwd"])
    launches["flash_attn_bwd"] = (cli_counts["flash_attn_bwd_dq"]
                                  + kernel_counts["flash_attn_bwd_dq"])
    launches["layernorm_bwd"] = kernel_counts["layernorm_bwd"]
    launches["fused_adam"] = kernel_counts["fused_adam"]
    launches["ffn_fwd"] = kernel_counts["ffn_fwd"]
    return launches


# ------------------------------------------------------------------ phase 8

CONTROL_K = 3   # steps per dispatch (one CUDA graph launch per chunk)
# rounds in turns of the step-wall timings of phases 8, 10 and 12 (one,
# to keep the whole script near 600 s with phase 13)
TIMING_ROUNDS = 1
RESUME_EVERY = 2
# device kernels of each wrapper count: ffn_fwd makes two launches a call
KERNEL_NAMES = {"flash_attn_fwd": ("flash_attn_fwd_kernel", 1),
                "flash_attn_bwd_dq": ("flash_attn_bwd_dq_kernel", 1),
                "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv_kernel", 1),
                "layernorm_bwd": ("layernorm_bwd_kernel", 1),
                "fused_adam": ("fused_adam_kernel", 1),
                "ffn_fwd": ("ffn_gemm_kernel", 2)}
# the XLSR depth of phases 8, 10, 12 and 13: XLS-R 300M's widths (d 1024,
# 16 heads, FFN 4096) at 4 of its 24 layers. What they hold (graphs
# against eager, resume, grad_accum, RawBoost in the step, the other
# models, the remat policies) is the same at any depth, and at 24 layers
# these four phases took half of a run that must end within its time
# limit (at 6 layers a full run with phase 21 took 1131.8 s of its 1200
# on an H100 whose host ran the other phases ~18 % slower than usual).
# Phases 4-7, 11 and 14-16 keep all 24; phase 17 runs PAR_DEPTH.
DEPTH = 4
# the XLSR depth of phase 17's meshes, its one-process references, its
# `oc_training --pp 2` and its NCCL world-size-1 graph: 12 of the 24
# layers. What they hold (each mesh against the one process, launches,
# shapes, a graph against eager steps) is the same at any depth, while
# the state the two ranks build, gather, restore and reduce through the
# host halves with it: at 24 layers phase 17 took 203 and 253 s of full
# runs that ended at 1057.8 and 1203.5 s (an H100 whose host ran phases
# 8-19 15-30 % slower). 12 keeps a pp=2 rank near half the state (about
# 0.54, the frontend on stage 0; the gate is 0.5-0.55) and divides into
# pp_stages 4.
PAR_DEPTH = 12


def at_depth(xcfg, depth: int = DEPTH):
    """xcfg with `depth` encoder layers."""
    return dataclasses.replace(xcfg, encoder_layers=depth)


@contextlib.contextmanager
def cli_at_depth(depth: int = DEPTH):
    """Inside the block, oc_training, oc_classifier and oc_server build
    the XLSRConfig their flags give, at `depth` encoder layers."""
    from occm_tpu_torch.cli import oc_server, oc_training

    train_cfg, serve_cfg = oc_training.xlsr_config, oc_server.xlsr_config
    oc_training.xlsr_config = lambda *a, **k: at_depth(train_cfg(*a, **k),
                                                       depth)
    oc_server.xlsr_config = lambda *a, **k: at_depth(serve_cfg(*a, **k),
                                                     depth)
    try:
        yield
    finally:
        oc_training.xlsr_config = train_cfg
        oc_server.xlsr_config = serve_cfg


def union_us(intervals) -> float:
    """Length of the union of [start, end] intervals (us): the time at
    least one of them covers, so that overlapping events count once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def profile_steps(fn, steps: int, label: str, want, tries: int = 5):
    """torch.profiler around fn() (which runs `steps` optimizer steps,
    ending in a synchronize): per step the host window, the device busy
    time (the union of the device events' intervals: the time at least
    one kernel, copy or set ran) and its share of the window, the device
    events' summed durations (larger than busy where they overlap), all
    device launches, and each wrapper's kernels by name, which must equal
    `want` (per step). A session that lost records (see device_ms) is
    repeated, up to `tries` sessions in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the marker takes a lost first record's place (see
            # profiled_events)
            torch.cuda._sleep(PROFILE_MARKER_CYCLES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t0) * 1e3
        summed_us, spans = 0.0, []
        by_kernel = dict.fromkeys(KERNEL_NAMES, 0)
        for e in prof.events():
            if (e.device_type != torch.autograd.DeviceType.CUDA
                    or PROFILE_MARKER in e.name):
                continue
            spans.append((e.time_range.start, e.time_range.end))
            summed_us += e.time_range.elapsed_us()
            for key, (name, _) in KERNEL_NAMES.items():
                if name in e.name:
                    by_kernel[key] += 1
        busy_ms = union_us(spans) / 1e3
        row = dict(window_ms=window_ms / steps, busy_ms=busy_ms / steps,
                   busy_share=busy_ms / window_ms,
                   summed_ms=summed_us / 1e3 / steps,
                   launches=len(spans) / steps,
                   kernels={k: n / steps for k, n in by_kernel.items()})
        print(f"[controls] profile {label}: {row['window_ms']:.3f} ms/step "
              f"host window, device busy {row['busy_ms']:.3f} ms/step "
              f"({row['busy_share']:.3f} of the window; device events' "
              f"summed durations {row['summed_ms']:.3f} ms/step), "
              f"{row['launches']:.1f} device launches/step, port kernels/"
              f"step {row['kernels']}", flush=True)
        if row["kernels"] == want:
            return row
        print(f"[profile] session {attempt} of {tries} for {label}: port "
              f"kernels/step {row['kernels']}, want {want}",
              file=sys.stderr, flush=True)
    fail(f"controls: profile {label} never showed the port's kernels "
         f"{want} a step")


class ChunkRecorder:
    """on_step hook of a graph run: per dispatch its wall ms (after a
    synchronize), its steps' losses and lrs (host reads), and the kernel
    wrappers' launch deltas."""

    def __init__(self):
        import torch

        from occm_tpu_torch.ops import launch_counts

        self.counts = launch_counts
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        self.last = launch_counts()
        self.dispatches = []

    def __call__(self, step, metrics):
        import torch

        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = self.counts()
        self.dispatches.append(dict(
            step=step, ms=(now - self.t0) * 1e3,
            losses=[float(v) for v in metrics["step_loss"]],
            lrs=[float(v) for v in metrics["step_lr"]],
            launches={k: counts[k] - self.last[k] for k in counts}))
        self.t0, self.last = now, counts


def loss_bound(loss: float, k: int, lr: float, flip_l1: float,
               g_l1: float) -> float:
    """Bound on |loss difference| at step k (1-based) of two runs of the
    same kernels from the same weights on the same batches, both under
    deterministic algorithms: the step-1 forward is the same computation
    (1e-6 relative for the order of its fp32 sums); each update before
    step k may differ where two backward passes give a gradient of
    opposite sign (Adam's first update is lr * sign(g): those weights
    differ by 2 lr, first-order loss effect 2 lr * flip_l1, flip_l1 the L1
    of such gradients, measured from two backward passes; 0 when the
    backward is deterministic) and by the fp32 rounding of the update (at
    most 2^-20 of lr per weight: 2 lr 2^-20 g_l1, with g_l1 the
    gradient's L1)."""
    return 1e-6 * abs(loss) + 2.0 * (k - 1) * lr * (flip_l1
                                                    + 2.0 ** -20 * g_l1)


def mask_memory() -> dict:
    """Bytes of dropout masks that remat holds until the backward (the
    masks are the rematerialised layers' inputs), drawn on the card by the
    port's own `draw_masks` for one meta-batch of 12 at the full width with
    every XLSR rate non-zero and plain attention (its probabilities are
    masked too), at the CLI's default cut and at phase 8's."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import TrainConfig, XLSRConfig
    from occm_tpu_torch.models.xlsr import TransformerLayer

    cfg = dataclasses.replace(XLSRConfig(), attention_impl="xla",
                              dropout=0.1, attention_dropout=0.1,
                              activation_dropout=0.1)
    layer = TransformerLayer(cfg)
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    out = {}
    for cut in (TrainConfig().cut, TRAIN_CUT):
        t = cut
        for _, kernel, stride in cfg.conv_layers:
            t = (t - kernel) // stride + 1
        masks = layer.draw_masks((TRAIN_B, t, cfg.encoder_embed_dim),
                                 DEVICE, "xla", gen)
        per_layer = sum(m.numel() * m.element_size() for m in masks)
        attn = masks[0].numel() * masks[0].element_size()
        out[cut] = dict(T=t, layer_mib=per_layer / 2**20,
                        attention_mib=attn / 2**20,
                        total_mib=cfg.encoder_layers * per_layer / 2**20)
        del masks
    print(f"[controls] dropout masks held under remat, 12 utterances, every "
          f"XLSR rate on, plain attention: {out} (none at the default rates "
          "of 0)", flush=True)
    return out


def wall_ms(fn, steps: int) -> float:
    """Host wall ms per optimizer step of fn() (which runs `steps` steps),
    between two synchronizes."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


class GraphCheck:
    """What `graph_vs_eager` runs on and collects: the batches, a factory
    of models from the initial weights, each kernel wrapper's launches per
    step, the loss bound's inputs (flip_l1, g_l1), the wrappers' launches
    (eager, warm-up and capture), the graphs' replayed launches, and the
    timings by check."""

    def __init__(self, batches, model_from_init, per_step):
        self.batches = batches
        self.model_from_init = model_from_init
        self.per_step = per_step
        self.flip_l1 = self.g_l1 = 0.0
        self.launches = dict.fromkeys(per_step, 0)
        self.graph_launches = dict.fromkeys(per_step, 0)
        self.timing = {}


def graph_vs_eager(ctx, name, cfg, aasist, exact=False):
    """6 eager steps, then the same 6 steps as 2 chunks of 3
    through one CUDA graph, from the same weights and dropout
    generator seed; each step's loss within loss_bound, or equal
    bit for bit when `exact`. `ctx` (a GraphCheck) holds the batches, the
    initial weights, each kernel's launches per step and the loss bound's
    inputs, and collects launches and timings. Returns the graph run's
    dispatches."""
    import dataclasses

    import torch

    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train import create_train_state, train
    from occm_tpu_torch.train.loop import train_step
    from occm_tpu_torch.utils.logging import MetricsLogger

    eager_cfg = dataclasses.replace(cfg, steps_per_dispatch=1)
    graph_cfg = dataclasses.replace(cfg,
                                    steps_per_dispatch=CONTROL_K)
    each = {**ctx.per_step,
            "fused_adam": int(cfg.optimizer == "fused_adam")}
    reset_counts()
    eager_state = create_train_state(
        ctx.model_from_init(aasist).to(DEVICE), eager_cfg)
    rec = StepRecorder()
    for x, labels in ctx.batches:
        rec(eager_state.step + 1, train_step(
            eager_state, torch.from_numpy(x).to(DEVICE),
            torch.from_numpy(labels).to(DEVICE), eager_cfg))
    eager_weights = {n: t.detach().clone() for n, t
                     in eager_state.model.state_dict().items()
                     } if exact else {}
    del eager_state
    eager_counts = launch_counts()
    check_steps(f"controls {name} eager", rec, {
        **each, "flash_attn_bwd_dout_copies": 0})
    torch.cuda.empty_cache()
    before = launch_counts()
    chunks = ChunkRecorder()
    state = train(ctx.model_from_init(aasist), ListPipeline(ctx.batches),
                  graph_cfg, logger=MetricsLogger(None, None), num_epochs=1,
                  device=DEVICE, on_step=chunks)
    after = launch_counts()
    runner = state.graph
    shapes = list(runner.capture_launches) if runner else []
    if len(shapes) != 1:
        fail(f"controls {name}: captured {shapes}, want one chunk "
             "shape")
    captured = runner.capture_launches[shapes[0]]
    if runner.replays != len(chunks.dispatches) or (
            runner.replays != 2):
        fail(f"controls {name}: {runner.replays} graph launches "
             f"for {len(chunks.dispatches)} chunks, want one per "
             "chunk (2)")
    for key, n in each.items():
        # the capture recorded k steps' launches; the eager
        # warm-up step before it launched one step's
        if captured[key] != CONTROL_K * n:
            fail(f"controls {name}: the capture recorded "
                 f"{captured[key]} {key} launches, want "
                 f"{CONTROL_K} x {n}")
        if after[key] - before[key] != (CONTROL_K + 1) * n:
            fail(f"controls {name}: {after[key] - before[key]} "
                 f"{key} wrapper calls in the graph run, want "
                 f"warm-up + capture = {(CONTROL_K + 1) * n}")
        ctx.launches[key] += (after[key] - before[key]
                          + eager_counts[key])
        ctx.graph_launches[key] += captured[key] * runner.replays
    got = [v for d in chunks.dispatches for v in d["losses"]]
    want = [st["loss"] for st in rec.steps]
    if len(got) != len(want):
        fail(f"controls {name}: {len(got)} graph steps, {len(want)} "
             "eager")
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        bound = 0.0 if exact else loss_bound(b, i + 1, cfg.lr,
                                             ctx.flip_l1, ctx.g_l1)
        diff = abs(a - b)
        worst = max(worst, diff)
        print(f"[controls] {name} step {i + 1}: loss graph "
              f"{a:.9f}, eager {b:.9f}, |diff| {diff:.3e} (bound "
              f"{bound:.3e})", flush=True)
        if not (math.isfinite(a) and diff <= bound):
            fail(f"controls {name}: step {i + 1} graph loss {a} vs "
                 f"eager {b}: |diff| {diff} > {bound}")
    differ = [n for n, t in state.model.state_dict().items()
              if n in eager_weights
              and not torch.equal(t, eager_weights[n])]
    if differ:
        fail(f"controls {name}: the graph run's final weights differ "
             f"from the eager run's in {len(differ)} tensors, e.g. "
             f"{differ[:3]}")
    del eager_weights
    ctx.timing[name] = dict(
        capture_s=runner.capture_seconds[shapes[0]],
        max_loss_diff=worst, bit_identical=got == want)
    print(f"[controls] {name}: largest |loss diff| {worst:.3e} "
          f"(bit-identical: {got == want}); graph launches "
          f"{runner.replays}, launches per replay {captured}, "
          f"capture {runner.capture_seconds[shapes[0]]:.2f} s",
          flush=True)
    del state, runner
    gc.collect()  # a state and its graph runner refer to each other
    torch.cuda.empty_cache()
    return chunks


def phase_train_controls(workdir: str, fixture):
    """Phase 8: the training controls at full width and DEPTH layers
    (12 x 6 s meta-batches,
    flash attention, ln_impl and ffn_impl "pallas", remat, AASIST dropouts
    zeroed unless said), each against the eager loop from the same weights
    and batches: steps_per_dispatch = 3 as one CUDA graph per chunk with
    fused_adam, with adam under a cosine schedule, and with adam and
    AASIST's default dropouts (bit for bit), all under deterministic
    algorithms, so that the two runs may be held to each other; the
    step's wall time, device-busy share and device launches eager and as
    graphs of 1 and 3 steps (default algorithms); grad_accum = 2; resume
    through the CLI after a SIGTERM, eager and as graphs; the dropout
    masks' memory under remat. Returns the kernel wrappers' launches of
    the phase, the graphs' replayed launches, and the measurements."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.graph import GraphedSteps
    from occm_tpu_torch.train.loop import train_step

    protocol, train_dir, voc_dir = fixture
    t_phase = time.perf_counter()
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = list(MetaBatchPipeline(dataset, seed=0).epoch(0))
    if len(batches) != 2 * CONTROL_K:
        fail(f"controls: {len(batches)} batches, want {2 * CONTROL_K}")
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    xcfg = at_depth(XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                               attention_impl="flash"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = AModel(acfg, xcfg).state_dict()
    base = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                       descriptiveness_weight=0.9, log_every=1,
                       rawboost=RawBoostConfig(algo=0))
    layers = xcfg.encoder_layers
    per_step = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers, "layernorm_bwd": 2 * layers,
                "fused_adam": 1, "ffn_fwd": 2 * layers}

    def model_from_init(aasist=acfg):
        model = AModel(aasist, xcfg)
        model.load_state_dict(init)
        return model

    check = GraphCheck(batches, model_from_init, per_step)
    launches, graph_launches = check.launches, check.graph_launches
    timing = check.timing

    # ---- graph against eager, under deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # two backward passes at the initial weights on batch 0: where
        # their gradients disagree in sign (flip_l1), and the gradient's L1
        # (the loss bounds' inputs)
        grads = []
        for _ in range(2):
            model = model_from_init().to(DEVICE).train()
            x0 = torch.from_numpy(batches[0][0]).to(DEVICE)
            emb, logits = model(x0, generator=torch.Generator(device=DEVICE))
            loss0, _ = group_one_class_loss(
                emb, logits, torch.from_numpy(batches[0][1]).to(DEVICE), 0.1,
                0.9)
            loss0.backward()
            grads.append([p.grad for p in model.parameters()])
            del model, emb, logits, loss0
        for ga, gb in zip(*grads):
            if ga is not None:
                flip = torch.sign(ga) != torch.sign(gb)
                check.flip_l1 += float(((ga.abs() + gb.abs()) * flip).sum())
                check.g_l1 += float(ga.abs().sum())
        del grads
        torch.cuda.empty_cache()
        print(f"[controls] two backward passes at the initial weights "
              f"(deterministic algorithms): sign-flip L1 "
              f"{check.flip_l1:.6g}, gradient L1 {check.g_l1:.6g}",
              flush=True)

        graph_vs_eager(check, "fused_adam k=3", dataclasses.replace(
            base, optimizer="fused_adam"), acfg)
        # adam under a cosine schedule: each step's lr read back
        cos_cfg = dataclasses.replace(base, optimizer="adam",
                                      lr_schedule="cosine", warmup_steps=1,
                                      decay_steps=5)
        achunks = graph_vs_eager(check, "adam cosine k=3", cos_cfg, acfg)
        # the CLI's model: AASIST's default dropouts, drawn in every step
        # from the state's CUDA generator. A graph that replayed its
        # capture's masks, or whose generator missed the replays' draws,
        # would part from the eager run at the second chunk
        graph_vs_eager(check, "adam dropout k=3", dataclasses.replace(
            base, optimizer="adam"), AASISTConfig(), exact=True)
        from occm_tpu_torch.train.schedules import make_schedule

        sched = make_schedule(cos_cfg)
        lrs = [v for d in achunks.dispatches for v in d["lrs"]]
        want_lrs = [sched(i) for i in range(2 * CONTROL_K)]
        print(f"[controls] adam cosine: lr per step read from the device "
              f"{lrs}, schedule {want_lrs}", flush=True)
        if lrs != want_lrs:
            fail(f"controls: the graph's lrs {lrs} are not the schedule's "
                 f"{want_lrs}")
    finally:
        torch.use_deterministic_algorithms(False)

    # ---- the step eager, as a graph of 1 step and of 3 (fused_adam,
    # default algorithms): wall ms (no profiler), then device busy share
    # and device launches (torch.profiler)
    cfg_f = dataclasses.replace(base, optimizer="fused_adam")
    xs = np.stack([b[0] for b in batches[:CONTROL_K]])
    ls = np.stack([b[1] for b in batches[:CONTROL_K]])
    x1 = torch.from_numpy(xs[0]).to(DEVICE)
    l1 = torch.from_numpy(ls[0]).to(DEVICE)
    state = create_train_state(model_from_init().to(DEVICE), cfg_f)
    torch.cuda.reset_peak_memory_stats()

    def eager():
        for _ in range(CONTROL_K):
            train_step(state, x1, l1, cfg_f)

    eager()  # warm
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    one = GraphedSteps(state, cfg_f, 1)
    one.run(xs[:1], ls[:1])  # capture
    one_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    three = GraphedSteps(state, cfg_f, CONTROL_K)
    three.run(xs, ls)  # capture
    three_peak = torch.cuda.max_memory_allocated() / 2**30

    def graph1():
        for _ in range(CONTROL_K):
            one.run(xs[:1], ls[:1])

    runs = {"eager": eager, "graph k=1": graph1,
            "graph k=3": lambda: three.run(xs, ls)}
    walls = {label: [] for label in runs}
    for _ in range(TIMING_ROUNDS):  # in turns
        for label, fn in runs.items():
            walls[label].append(wall_ms(fn, CONTROL_K))
    want = {key: per_step[key] * per_call
            for key, (_, per_call) in KERNEL_NAMES.items()}
    rows = {label: profile_steps(fn, CONTROL_K, label, want)
            for label, fn in runs.items()}
    for label, row in rows.items():
        row["wall_ms"] = walls[label]
    timing["profile"] = rows
    timing["capture_s"] = {"graph k=1": list(one.capture_seconds.values()),
                           "graph k=3": list(three.capture_seconds.values())}
    timing["peak_gib"] = {"eager": eager_peak, "graph k=1 capture": one_peak,
                          "graph k=3 capture": three_peak}
    print(f"[controls] step wall ms ({TIMING_ROUNDS} rounds, in turns) "
          f"{walls}; peak "
          f"memory {timing['peak_gib']} GiB; capture s "
          f"{timing['capture_s']}", flush=True)
    del state, one, three
    gc.collect()
    torch.cuda.empty_cache()

    # ---- grad_accum = 2
    timing["grad_accum"] = phase_grad_accum(batches, base, model_from_init,
                                            per_step, launches)

    # ---- resume through the CLI after a SIGTERM
    with cli_at_depth():
        timing["resume"] = phase_resume(workdir, fixture, launches)
    timing["mask_mib"] = mask_memory()
    timing["seconds"] = time.perf_counter() - t_phase
    print(f"[controls] phase 8 took {timing['seconds']:.1f} s", flush=True)
    return launches, graph_launches, timing


def phase_grad_accum(batches, base, model_from_init, per_step, launches):
    """grad_accum = 2 at groups_per_step = 2 (two micro-batches of 12), one
    fused_adam step from the initial weights:
    - on two different meta-batches, against its definition: each
      meta-batch's gradient from its own grad_accum = 1 pass, averaged
      (BatchNorm normalises each micro-batch with its own statistics, in
      the JAX package too, so this, not the 24-utterance pass, is the
      update accumulation must equal); the same kernels on the same
      shapes under deterministic algorithms, where two backward passes of
      one batch agree bit for bit (their spread, measured here, is 0) and
      a share of 1/2 scales every rounding exactly, so the gradients
      agree to the spread plus one fp32 rounding of the sum;
    - on one meta-batch twice, against grad_accum = 1 on those 24
      utterances, where the batch statistics coincide and accumulation
      equals the big batch: the two differ in the shapes of their cuBLAS
      and cuDNN calls, and so in the order of fp32 sums and where bf16
      rounds, which the layers carry into the loss as phase 7's LOSS_RTOL
      bound says (for 24 of them), and back through the same layers into
      the gradient:
      the gradient the update reads is held to LOSS_RTOL of its norm (a
      missing micro-batch or a wrong share moves it by half its norm or
      more). Adam's first update is lr * g / (|g| + eps) whatever the
      gradient's scale, so each updated weight is held to the other run's
      within lr times the difference of that direction (computed from the
      two gradients) plus the roundings of the update (2^-19 lr) and of
      the weight (2^-22 |w|): the update read the gradient held above.
    Each kernel runs twice its per-micro-batch count."""
    import dataclasses

    import torch

    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.loop import train_step

    def step(x, labels, accum):
        cfg = dataclasses.replace(base, optimizer="fused_adam",
                                  groups_per_step=x.shape[0] // 12,
                                  grad_accum=accum)
        state = create_train_state(model_from_init().to(DEVICE), cfg)
        grads = {}
        apply = state.apply_gradients

        def keep_grads(lr=None):  # the gradient the update reads
            grads.update({n: p.grad.clone() for n, p
                          in state.model.named_parameters()
                          if p.grad is not None})
            apply(lr)

        state.apply_gradients = keep_grads
        before = launch_counts()
        m = train_step(state, torch.from_numpy(x).to(DEVICE),
                       torch.from_numpy(labels).to(DEVICE), cfg)
        torch.cuda.synchronize()
        counts = {k: v - before[k] for k, v in launch_counts().items()}
        weights = {n: p.detach().clone()
                   for n, p in state.model.named_parameters()}
        return float(m["loss"]), grads, weights, counts

    def single_grads(x, labels):
        model = model_from_init().to(DEVICE).train()
        emb, logits = model(torch.from_numpy(x).to(DEVICE),
                            generator=torch.Generator(device=DEVICE))
        loss, _ = group_one_class_loss(
            emb, logits, torch.from_numpy(labels).to(DEVICE), 0.1, 0.9)
        loss.backward()
        return float(loss.detach()), {
            n: p.grad for n, p in model.named_parameters()
            if p.grad is not None}

    (xa, la), (xb, lb) = batches[0], batches[1]
    result = {}
    # distinct meta-batches against the definition, under deterministic
    # algorithms: with the default ones the spread of two passes and the
    # gradient's difference are two samples of one noise, and the gate
    # failed on one run of an archive that passed it on others
    x2, l2 = np.concatenate([xa, xb]), np.concatenate([la, lb])
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        loss, grads, _, counts = step(x2, l2, 2)
        loss_a, ga = single_grads(xa, la)
        loss_b, gb = single_grads(xb, lb)
        _, ga2 = single_grads(xa, la)
    finally:
        torch.use_deterministic_algorithms(False)
    for key, n in per_step.items():
        want = n if key == "fused_adam" else 2 * n
        if counts[key] != want:
            fail(f"grad_accum: {counts[key]} {key} launches in a step of "
                 f"two micro-batches, want {want}")
        launches[key] += counts[key]
    spread = max(float((ga[n] - ga2[n]).abs().max()) for n in ga)
    spread_rel = math.sqrt(
        sum(float(((ga[n] - ga2[n]) ** 2).sum()) for n in ga)
        / sum(float((ga[n] ** 2).sum()) for n in ga))
    worst = worst_excess = 0.0
    for n, g in grads.items():
        ref = 0.5 * ga[n] + 0.5 * gb[n]
        diff = (g - ref).abs()
        bound = spread + 2.0 ** -23 * (0.5 * ga[n].abs() + 0.5 * gb[n].abs())
        worst = max(worst, float(diff.max()))
        worst_excess = max(worst_excess, float((diff - bound).max()))
    want_loss = 0.5 * loss_a + 0.5 * loss_b
    loss_diff = abs(loss - want_loss)
    print(f"[controls] grad_accum 2 on two meta-batches: loss {loss:.9f} vs "
          f"the two passes' mean {want_loss:.9f} (|diff| {loss_diff:.3e}); "
          f"gradient max |diff| {worst:.3e} (spread of two passes "
          f"{spread:.3e}; deterministic algorithms); launches {counts}",
          flush=True)
    if worst_excess > 0 or loss_diff > 1e-6 * abs(want_loss) + 1e-7:
        fail(f"grad_accum: accumulated gradient or loss off its definition "
             f"(gradient excess over bound {worst_excess}, loss |diff| "
             f"{loss_diff})")
    result.update(loss_diff_distinct=loss_diff, grad_diff_distinct=worst,
                  grad_spread=spread, grad_spread_rel=spread_rel)
    del grads, ga, gb, ga2
    # one meta-batch twice against the 24-utterance pass
    x2, l2 = np.concatenate([xa, xa]), np.concatenate([la, la])
    loss_acc, g_acc, w_acc, _ = step(x2, l2, 2)
    loss_big, g_big, w_big, _ = step(x2, l2, 1)
    bound = LOSS_RTOL * abs(loss_big)
    loss_diff = abs(loss_acc - loss_big)
    if sorted(g_acc) != sorted(g_big):
        fail("grad_accum vs big batch: different parameters got gradients")
    sq_diff = sum(float(((g_acc[n] - g_big[n]) ** 2).sum()) for n in g_big)
    sq_big = sum(float((g ** 2).sum()) for g in g_big.values())
    g_rel = math.sqrt(sq_diff / sq_big)
    eps, lr = 1e-8, base.lr
    w_diff = w_excess = 0.0
    for n, w in w_big.items():
        diff = (w_acc[n] - w).abs()
        if n in g_big:
            s_acc = g_acc[n] / (g_acc[n].abs() + eps)
            s_big = g_big[n] / (g_big[n].abs() + eps)
            w_bound = (lr * (s_acc - s_big).abs() + 2.0 ** -19 * lr
                       + 2.0 ** -22 * w.abs())
        else:  # no gradient in either run: the weight did not move
            w_bound = torch.zeros_like(w)
        w_diff = max(w_diff, float(diff.max()))
        w_excess = max(w_excess, float((diff - w_bound).max()))
    moved = sum(int(((w_acc[n] - w_big[n]).abs() > 1e-9).sum())
                for n in w_acc)
    total = sum(w.numel() for w in w_acc.values())
    print(f"[controls] grad_accum 2 vs 1 on one meta-batch twice: loss "
          f"{loss_acc:.9f} vs {loss_big:.9f} (|diff| {loss_diff:.3e}, bound "
          f"{bound:.3e}); gradient |diff| / |g| {g_rel:.3e} (bound "
          f"{LOSS_RTOL}; two passes of one batch {spread_rel:.3e}); updated "
          f"weights max |diff| {w_diff:.3e}, largest excess over the "
          f"update's bound {w_excess:.3e}; {moved} of {total} differ",
          flush=True)
    if not (loss_diff <= bound and g_rel <= LOSS_RTOL and w_excess <= 0.0):
        fail(f"grad_accum vs big batch: loss |diff| {loss_diff} > {bound}, "
             f"gradient |diff| / |g| {g_rel} > {LOSS_RTOL} or weights over "
             f"their bound by {w_excess}")
    result.update(loss_diff_big=loss_diff, grad_rel_diff_big=g_rel,
                  weight_diff_big=w_diff, weight_excess_big=w_excess,
                  weights_differing=moved, weights=total)
    del g_acc, g_big, w_acc, w_big
    torch.cuda.empty_cache()
    return result


def phase_resume(workdir: str, fixture, launches, flags=(), eager=True,
                 label="resume"):
    """Resume through `oc_training.main` (the CLI's defaults: AASIST
    dropouts on, drawn from the CUDA generator, torch Adam; plus `flags`)
    with --checkpoint_every_steps 2, under
    torch.use_deterministic_algorithms, against one uninterrupted run of 6
    eager steps (every loss finite):
    - eager steps: a run sent SIGTERM from its on_step hook after step 2
      saves and returns; --resume finishes the epoch; steps 3-6 and the
      final weights equal the uninterrupted run's bit for bit; the step-2
      checkpoint is replaced at step 4 and deleted;
    - --steps_per_dispatch 3 (two chunks, each one CUDA graph launch): the
      SIGTERM after the first chunk saves at step 3 (the generator's state
      after a replay), --resume replays the second chunk, and all 6 steps
      and the final weights again equal the eager run's bit for bit.
    eager=False runs the uninterrupted run and the graphs' case only."""
    import signal

    import torch

    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.ops import launch_counts

    protocol, train_dir, voc_dir = fixture

    def args(ckpt_dir, *extra):
        return ["--train_protocol_file", protocol,
                "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
                "--model", "aasist", "--cut", str(TRAIN_CUT),
                "--num_epochs", "1", "--compactness_weight", "0.1",
                "--descriptiveness_weight", "0.9", "--checkpoint_dir",
                ckpt_dir, *flags, *extra]

    def losses_of(metrics):
        if "step_loss" in metrics:  # a chunk: each of its steps
            return [float(v) for v in metrics["step_loss"]]
        return [float(metrics["loss"])]

    def interrupted(name, stop, *extra):
        """A run sent SIGTERM after step `stop`, then --resume: the step
        it stopped at, the files it left, the resumed dispatches (step,
        losses, files seen), the files at the end, the losses before the
        stop and the final weights."""
        run_dir = os.path.join(workdir, name)
        every = ["--checkpoint_every_steps", str(RESUME_EVERY), *extra]
        first = []

        def preempt(step, metrics):
            first.extend(losses_of(metrics))
            if step == stop:
                os.kill(os.getpid(), signal.SIGTERM)

        state = oc_training.main(args(run_dir, *every), on_step=preempt)
        stopped = state.step
        del state
        gc.collect()  # a state and its graph runner refer to each other
        files_after_stop = sorted(os.listdir(run_dir))
        torch.cuda.empty_cache()
        seen = []

        def listing(step, metrics):
            seen.append((step, losses_of(metrics),
                         sorted(os.listdir(run_dir))))

        resumed = oc_training.main(args(run_dir, *every, "--resume"),
                                   on_step=listing)
        final_files = sorted(os.listdir(run_dir))
        weights = {k: v.detach().cpu() for k, v
                   in resumed.model.state_dict().items()}
        del resumed
        gc.collect()
        shutil.rmtree(run_dir)
        torch.cuda.empty_cache()
        print(f"[controls] {label} {name}: stopped at step {stopped} with "
              f"{files_after_stop}; resumed steps {[s for s, _, _ in seen]}, "
              f"files seen at each {[f for _, _, f in seen]}, at the end "
              f"{final_files}; losses first {first}, resumed "
              f"{[v for _, l, _ in seen for v in l]}", flush=True)
        return stopped, files_after_stop, seen, final_files, first, weights

    def check(name, ref_losses, ref_weights, got):
        stopped, files_after_stop, seen, final_files, first, weights = got
        resumed_losses = [v for _, l, _ in seen for v in l]
        if first + resumed_losses != ref_losses:
            fail(f"{label} {name}: losses {first} + {resumed_losses} differ "
                 f"from the uninterrupted run's {ref_losses}")
        differ = [k for k in weights if not torch.equal(weights[k],
                                                        ref_weights[k])]
        if differ:
            fail(f"{label} {name}: final weights differ from the "
                 f"uninterrupted run's in {len(differ)} tensors, e.g. "
                 f"{differ[:3]}")
        print(f"[controls] {label} {name}: the losses and the final weights "
              f"equal the uninterrupted run's bit for bit ({len(weights)} "
              f"tensors)", flush=True)

    torch.use_deterministic_algorithms(True, warn_only=True)
    cwd = os.getcwd()
    os.chdir(workdir)
    before = launch_counts()
    try:
        ref_losses = []
        ref_dir = os.path.join(workdir, "resume_ref")
        t0 = time.perf_counter()
        ref = oc_training.main(args(ref_dir), on_step=lambda s, m:
                               ref_losses.extend(losses_of(m)))
        ref_s = time.perf_counter() - t0
        ref_weights = {k: v.detach().cpu() for k, v
                       in ref.model.state_dict().items()}
        del ref
        shutil.rmtree(ref_dir)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        eager = interrupted("eager", RESUME_EVERY) if eager else None
        resume_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = interrupted("graph", CONTROL_K, "--steps_per_dispatch",
                            str(CONTROL_K))
        graph_resume_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        torch.use_deterministic_algorithms(False)
    after = launch_counts()
    for key in launches:
        launches[key] += after[key] - before[key]
    print(f"[controls] {label}: uninterrupted losses {ref_losses} "
          f"({ref_s:.1f} s, model build and checkpoint included)",
          flush=True)
    if len(ref_losses) != 2 * CONTROL_K or not all(
            math.isfinite(v) for v in ref_losses):
        fail(f"{label}: the uninterrupted run's losses {ref_losses}")
    if eager is not None:
        stopped, files_after_stop, seen, final_files, _, _ = eager
        if stopped != 2 or files_after_stop != ["aasist_vocoded_step_2.pt"]:
            fail(f"{label} eager: the SIGTERM run stopped at {stopped} with "
                 f"{files_after_stop}, want step 2 and its step checkpoint")
        if [s for s, _, _ in seen] != [3, 4, 5, 6]:
            fail(f"{label} eager: resumed steps {[s for s, _, _ in seen]}, "
                 "want 3-6")
        if (seen[1][2] != ["aasist_vocoded_step_2.pt"]
                or seen[2][2] != ["aasist_vocoded_step_4.pt"]
                or final_files != ["aasist_vocoded_0.pt",
                                   "aasist_vocoded_step_6.pt"]):
            fail(f"{label} eager: the step-2 checkpoint was not replaced at "
                 "step 4 and deleted")
        check("eager", ref_losses, ref_weights, eager)

    stopped, files_after_stop, seen, final_files, _, _ = graph
    if stopped != CONTROL_K or files_after_stop != [
            f"aasist_vocoded_step_{CONTROL_K}.pt"]:
        fail(f"{label} graph: the SIGTERM run stopped at {stopped} with "
             f"{files_after_stop}, want step {CONTROL_K} and its step "
             "checkpoint")
    if ([s for s, _, _ in seen] != [2 * CONTROL_K]
            or seen[0][2] != [f"aasist_vocoded_step_{CONTROL_K}.pt"]
            or final_files != ["aasist_vocoded_0.pt",
                               f"aasist_vocoded_step_{2 * CONTROL_K}.pt"]):
        fail(f"{label} graph: resumed dispatches {[s for s, _, _ in seen]} "
             f"and files {final_files}, want the second chunk and its step "
             "checkpoint in place of the first's")
    check("graph", ref_losses, ref_weights, graph)
    print(f"[controls] {label}: interrupted + resumed wall, eager "
          f"{resume_s:.1f} s, graph {graph_resume_s:.1f} s", flush=True)
    return dict(losses=ref_losses, ref_s=ref_s,
                stopped=None if eager is None else eager[0],
                resume_s=resume_s, graph_stopped=graph[0],
                graph_resume_s=graph_resume_s)


# ------------------------------------------------------------------ phase 9

RB_CALLS = 20
# RawBoost on the card against the CPU on the same draws. Both sides are
# fp32; they differ by the two FFT libraries' rounding (cuFFT against
# pocketfft, 131072-point transforms: some 2^-24 * log2(131072), ~1e-6, of
# the signal's scale of at most 1) and by reductions summed in another
# order. 1e-4 holds that and fails any wrong tap, crop offset or subset,
# which moves samples by the signal's own size (~1e-1). ISD's subset is
# integer logic on the same uniforms and must agree exactly.
RB_ATOL = 1e-4
# SSI scales its noise to the drawn SNR exactly, up to fp32 rounding of
# the two norms and the scale (~1e-6 relative): 1e-3 dB.
SNR_ATOL_DB = 1e-3


def rawboost_graph_check(x) -> None:
    """One batch_rawboost call of algo 5 captured in a CUDA graph: its
    replays draw afresh from the registered generator, and equal eager
    calls from a twin generator of the same seed bit for bit."""
    import torch

    from occm_tpu_torch.augment import batch_rawboost
    from occm_tpu_torch.config import RawBoostConfig

    cfg = RawBoostConfig(algo=5)
    gen = torch.Generator(device=DEVICE).manual_seed(50)
    twin = torch.Generator(device=DEVICE).manual_seed(50)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm-up: cuFFT plans, sort scratch
        batch_rawboost(gen, x, cfg)
    torch.cuda.current_stream().wait_stream(stream)
    batch_rawboost(twin, x, cfg)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = batch_rawboost(gen, x, cfg)
    for i in range(2):
        graph.replay()
        want = batch_rawboost(twin, x, cfg)
        if not torch.equal(out, want):
            fail(f"rawboost: graph replay {i + 1} differs from the eager "
                 f"call (max |diff| {float((out - want).abs().max())})")
    print("[rawboost] algo 5 as a CUDA graph: two replays equal eager calls "
          "from a twin generator bit for bit", flush=True)


def phase_rawboost():
    """Phase 9: RawBoost (`occm_tpu_torch.augment`) on the card at one
    training batch, [12, 96000] fp32, algos 1-8: draws from a seeded CUDA
    generator, the card's apply against the CPU's on the same draws (and
    algo 4 with valid lengths), ISD's subset equal on both and changing
    exactly n_sel samples a row, SSI's realised SNR equal to its draw and
    in [SNRmin, SNRmax], finite outputs; one call of algo 5 captured in a
    CUDA graph, whose replays equal eager calls bit for bit; and per algo
    the time of a call with its draws (CUDA events over 20 calls), its
    device time and device launches (torch.profiler)."""
    import torch

    from occm_tpu_torch.augment import (
        batch_rawboost, draw_rawboost, process_rawboost)
    from occm_tpu_torch.augment.rawboost import isd_selection
    from occm_tpu_torch.config import RawBoostConfig

    t_phase = time.perf_counter()
    rng = np.random.default_rng(9)
    x_np = np.stack([synthetic_wave(rng, TRAIN_CUT / SR)
                     for _ in range(TRAIN_B)])
    x = torch.from_numpy(x_np).to(DEVICE)
    lengths = torch.from_numpy(rng.integers(TRAIN_CUT // 2, TRAIN_CUT + 1,
                                            TRAIN_B)).to(DEVICE)

    def on_cpu(draws):
        return {s: {k: v.cpu() for k, v in d.items()}
                for s, d in draws.items()}

    rows = []
    for algo in range(1, 9):
        cfg = RawBoostConfig(algo=algo)
        gen = torch.Generator(device=DEVICE).manual_seed(algo)
        errs = []
        for lens in (None, lengths) if algo == 4 else (None,):
            draws = draw_rawboost(cfg, TRAIN_B, TRAIN_CUT, gen)
            y = process_rawboost(x, draws, cfg, lens)
            lens_cpu = None if lens is None else lens.cpu()
            y_cpu = process_rawboost(x.cpu(), on_cpu(draws), cfg, lens_cpu)
            if not bool(torch.isfinite(y).all()):
                fail(f"rawboost algo {algo}: non-finite output on the card")
            errs.append(float((y.cpu() - y_cpu).abs().max()))
            if errs[-1] > RB_ATOL:
                fail(f"rawboost algo {algo}: card vs CPU max |diff| "
                     f"{errs[-1]} > {RB_ATOL}")
            if "isd" in draws:
                n_sel, sel = isd_selection(draws["isd"], cfg, TRAIN_CUT,
                                           lens)
                n_cpu, sel_cpu = isd_selection(on_cpu(draws)["isd"], cfg,
                                               TRAIN_CUT, lens_cpu)
                if not (torch.equal(n_sel.cpu(), n_cpu)
                        and torch.equal(sel.cpu(), sel_cpu)
                        and torch.equal(sel.sum(-1).int(), n_sel)):
                    fail(f"rawboost algo {algo}: ISD subsets differ between "
                         "the card and the CPU, or miss n_sel")

        def call():
            return batch_rawboost(gen, x, cfg)

        ms = cuda_ms(call, RB_CALLS)
        dev_ms, launches = calls_device_ms(call, RB_CALLS)
        rows.append(dict(algo=algo, max_abs_err=max(errs),
                         max_abs_err_lengths=errs[1] if algo == 4 else None,
                         ms=ms, device_ms=dev_ms, launches=launches))
        print(f"[rawboost] algo {algo} at [{TRAIN_B}, {TRAIN_CUT}]: card vs "
              f"CPU max |diff| {errs} (bound {RB_ATOL}), {ms:.4f} ms a call "
              f"with its draws (CUDA events, {RB_CALLS} calls), device "
              f"{dev_ms:.4f} ms, {launches:.1f} device launches a call",
              flush=True)

    # ISD changes exactly the n_sel selected samples of a row (inputs at a
    # quarter of their scale, so that no row's peak passes 1 and nothing is
    # renormalised); a selected sample may stay only if its impulse
    # x * g_sd * f_r is below its rounding, |f_r| <= 2^-20
    cfg = RawBoostConfig(algo=2)
    draws = draw_rawboost(cfg, TRAIN_B, TRAIN_CUT,
                          torch.Generator(device=DEVICE).manual_seed(20))
    xq = x / 4.0
    y = process_rawboost(xq, draws, cfg)
    n_sel, sel = isd_selection(draws["isd"], cfg, TRAIN_CUT)
    d = draws["isd"]
    f_r = (2.0 * d["f1"] - 1.0) * (2.0 * d["f2"] - 1.0)
    changed = y != xq
    stayed = sel & ~changed
    if bool((changed & ~sel).any()) or bool(
            (f_r[stayed].abs() > 2.0 ** -20).any()):
        fail("rawboost ISD: the changed samples are not the selected ones")
    print(f"[rawboost] ISD: samples changed a row "
          f"{changed.sum(-1).tolist()}, n_sel {n_sel.tolist()} (selected "
          f"samples left unchanged by an impulse below their rounding: "
          f"{int(stayed.sum())})", flush=True)

    # SSI's realised SNR
    cfg = RawBoostConfig(algo=3)
    draws = draw_rawboost(cfg, TRAIN_B, TRAIN_CUT,
                          torch.Generator(device=DEVICE).manual_seed(30))
    y = process_rawboost(x, draws, cfg).double().cpu()
    xd = x.double().cpu()
    snr = (20.0 * torch.log10(xd.norm(dim=-1) / (y - xd).norm(dim=-1)))
    drawn = (cfg.SNRmin + (cfg.SNRmax - cfg.SNRmin)
             * draws["ssi"]["snr"].double().cpu())
    if not (bool(((snr - drawn).abs() <= SNR_ATOL_DB).all())
            and float(snr.min()) >= cfg.SNRmin - SNR_ATOL_DB
            and float(snr.max()) <= cfg.SNRmax + SNR_ATOL_DB):
        fail(f"rawboost SSI: realised SNR {snr.tolist()} dB, drawn "
             f"{drawn.tolist()}")
    print(f"[rawboost] SSI: realised SNR dB "
          f"{[round(v, 4) for v in snr.tolist()]}, |realised - drawn| <= "
          f"{float((snr - drawn).abs().max()):.2e}", flush=True)

    rawboost_graph_check(x)
    seconds = time.perf_counter() - t_phase
    print(f"[rawboost] phase 9 took {seconds:.1f} s", flush=True)
    return dict(algos=rows, seconds=seconds)


# ----------------------------------------------------------------- phase 10

def phase_train_rawboost(workdir: str, fixture):
    """Phase 10: training with RawBoost at full width and DEPTH layers
    (12 x 6 s, every
    kernel, remat), under deterministic algorithms where two runs are held
    to each other:
    - algo 5 with AASIST's dropouts, 6 eager steps against the same 6 as
      2 CUDA graph launches of 3 steps: bit for bit, one replay a chunk;
    - step wall ms eager and as a graph of 3 steps, algo 0 against algo 5,
      in turns (fused_adam, default algorithms), and the device launches
      and device busy time an eager step gains from RawBoost
      (torch.profiler);
    - through the CLI (`--rawboost_algo 5`): 6 eager steps with finite
      losses, and a `--steps_per_dispatch 3` run sent SIGTERM after its
      first chunk and resumed, equal to them bit for bit.
    Returns the kernel wrappers' launches, the graphs' replayed launches
    and the measurements."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.graph import GraphedSteps
    from occm_tpu_torch.train.loop import train_step

    protocol, train_dir, voc_dir = fixture
    t_phase = time.perf_counter()
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = list(MetaBatchPipeline(dataset, seed=0).epoch(0))
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    xcfg = at_depth(XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                               attention_impl="flash"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = AModel(acfg, xcfg).state_dict()
    layers = xcfg.encoder_layers
    per_step = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers, "layernorm_bwd": 2 * layers,
                "fused_adam": 1, "ffn_fwd": 2 * layers}

    def model_from_init(aasist=acfg):
        model = AModel(aasist, xcfg)
        model.load_state_dict(init)
        return model

    check = GraphCheck(batches, model_from_init, per_step)
    base = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                       descriptiveness_weight=0.9, log_every=1,
                       rawboost=RawBoostConfig(algo=5))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        graph_vs_eager(check, "rawboost 5, adam dropout k=3",
                       dataclasses.replace(base, optimizer="adam"),
                       AASISTConfig(), exact=True)
    finally:
        torch.use_deterministic_algorithms(False)

    # ---- step wall, algo 0 against algo 5, eager and as a graph of 3
    xs = np.stack([b[0] for b in batches[:CONTROL_K]])
    ls = np.stack([b[1] for b in batches[:CONTROL_K]])
    x1 = torch.from_numpy(xs[0]).to(DEVICE)
    l1 = torch.from_numpy(ls[0]).to(DEVICE)
    runs = {}
    for algo in (0, 5):
        cfg = dataclasses.replace(base, optimizer="fused_adam",
                                  rawboost=RawBoostConfig(algo=algo))
        state = create_train_state(model_from_init().to(DEVICE), cfg)

        def eager(state=state, cfg=cfg):
            for _ in range(CONTROL_K):
                train_step(state, x1, l1, cfg)

        eager()  # warm
        graph = GraphedSteps(state, cfg, CONTROL_K)
        graph.run(xs, ls)  # capture
        runs[f"eager algo {algo}"] = eager
        runs[f"graph k=3 algo {algo}"] = (
            lambda graph=graph: graph.run(xs, ls))
    walls = {label: [] for label in runs}
    for _ in range(TIMING_ROUNDS):  # in turns
        for label, fn in runs.items():
            walls[label].append(wall_ms(fn, CONTROL_K))
    want = {key: per_step[key] * per_call
            for key, (_, per_call) in KERNEL_NAMES.items()}
    rows = {label: profile_steps(runs[label], CONTROL_K, label, want)
            for label in ("eager algo 0", "eager algo 5")}
    rows["walls_ms"] = walls
    added = {
        "device_launches": rows["eager algo 5"]["launches"]
        - rows["eager algo 0"]["launches"],
        "device_busy_ms": rows["eager algo 5"]["busy_ms"]
        - rows["eager algo 0"]["busy_ms"]}
    print(f"[train-rawboost] step wall ms ({TIMING_ROUNDS} rounds, in turns) "
          f"{walls}; "
          f"RawBoost algo 5 adds {added['device_launches']:.1f} device "
          f"launches and {added['device_busy_ms']:.3f} ms of device busy "
          f"time a step (eager)", flush=True)
    del runs, state, graph
    gc.collect()  # a state and its graph runner refer to each other
    torch.cuda.empty_cache()

    # ---- the CLI with --rawboost_algo 5: eager, and resumed as graphs
    with cli_at_depth():
        resume = phase_resume(workdir, fixture, check.launches,
                              flags=("--rawboost_algo", "5"), eager=False,
                              label="rawboost 5 resume")
    timing = dict(check.timing, profile=rows, added_per_step=added,
                  resume=resume, seconds=time.perf_counter() - t_phase)
    print(f"[train-rawboost] phase 10 took {timing['seconds']:.1f} s",
          flush=True)
    return check.launches, check.graph_launches, timing


# ----------------------------------------------------------------- phase 11

# fairseq's pretraining-only tensors of XLS-R 300M (quantizer, targets)
PRETRAINING_ONLY = {"mask_emb": (1024,), "quantizer.vars": (1, 640, 384),
                    "quantizer.weight_proj.weight": (640, 512),
                    "quantizer.weight_proj.bias": (640,),
                    "project_q.weight": (768, 384), "project_q.bias": (768,),
                    "final_proj.weight": (768, 1024),
                    "final_proj.bias": (768,)}
# The grafted positional conv is fairseq's weight norm folded, w = v * (g /
# ||v||) in fp32 with ||v|| from an fp64 sum: three fp32 roundings
# (||v||, the ratio, the product) of at most 2^-24 each, so w lies within
# 4 * 2^-24 of the fp64 fold g * v / ||v|| (relative).
FOLD_RTOL = 4 * 2.0 ** -24

_TO_HF = (  # fairseq naming -> HuggingFace transformers' Wav2Vec2
    (r"^feature_extractor\.conv_layers\.(\d+)\.0\.",
     r"feature_extractor.conv_layers.\1.conv."),
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.1\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    # the base layout's GroupNorm after conv 0
    (r"^feature_extractor\.conv_layers\.(\d+)\.2\.",
     r"feature_extractor.conv_layers.\1.layer_norm."),
    (r"^layer_norm\.", "feature_projection.layer_norm."),
    (r"^post_extract_proj\.", "feature_projection.projection."),
    (r"^encoder\.pos_conv\.0\.weight_g",
     "encoder.pos_conv_embed.conv.parametrizations.weight.original0"),
    (r"^encoder\.pos_conv\.0\.weight_v",
     "encoder.pos_conv_embed.conv.parametrizations.weight.original1"),
    (r"^encoder\.pos_conv\.0\.bias", "encoder.pos_conv_embed.conv.bias"),
    (r"\.self_attn\.", ".attention."),
    (r"\.self_attn_layer_norm\.", ".layer_norm."),
    (r"\.fc1\.", ".feed_forward.intermediate_dense."),
    (r"\.fc2\.", ".feed_forward.output_dense."),
)


class _CfgOfAnotherProgram:
    """A checkpoint cfg whose class cannot be imported where it is read
    (fairseq pickles an omegaconf DictConfig there)."""

    def __init__(self, model):
        self.model = model


def write_fairseq_checkpoint(path: str, sd) -> None:
    """{"model": sd + pretraining-only tensors, "cfg": an object of a class
    whose module is gone by the time the file is read}, as fairseq saves
    xlsr2_300m.pt."""
    import types

    import torch

    gen = torch.Generator().manual_seed(11)
    model = dict(sd)
    for k, shape in PRETRAINING_ONLY.items():
        model[k] = torch.randn(shape, generator=gen)
    mod = types.ModuleType("omegaconf_not_here")
    cls = type("DictConfig", (_CfgOfAnotherProgram,), {})
    cls.__module__ = mod.__name__
    mod.DictConfig = cls
    sys.modules[mod.__name__] = mod
    try:
        torch.save({"model": model, "cfg": cls({"_name": "wav2vec2",
                                                 "dropout": 0.1})}, path)
    finally:
        del sys.modules[mod.__name__]


def write_hf_safetensors(path: str, sd) -> None:
    """sd renamed to HuggingFace's Wav2Vec2ForPreTraining naming
    (`wav2vec2.` prefix, the weight norm as parametrizations) and written
    in the safetensors layout with numpy, as `model.safetensors`."""
    import re

    arrays = {}
    for k, v in sd.items():
        for old, new in _TO_HF:
            k = re.sub(old, new, k)
        arrays["wav2vec2." + k] = v.numpy()
    arrays["quantizer.codevectors"] = np.zeros((1, 640, 384), np.float32)
    arrays["project_hid.weight"] = np.zeros((768, 1024), np.float32)
    header, off = {"__metadata__": {"format": "pt"}}, 0
    for k, a in arrays.items():
        header[k] = {"dtype": "F32", "shape": list(a.shape),
                     "data_offsets": [off, off + a.nbytes]}
        off += a.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for a in arrays.values():
            f.write(np.ascontiguousarray(a).tobytes())


class _OneStep(Exception):
    """Raised by phase 11's on_step hook to end a CLI run after a step."""


def phase_pretrained(workdir: str, fixture):
    """Phase 11: --pretrained_xlsr at full width. A random XLS-R 300M
    encoder (seed 1; its positional conv's weight-norm gain g drawn apart
    from ||v||, as in a trained checkpoint) is written as a fairseq .pt
    (cfg of an unimportable class, pretraining-only tensors) and as an HF
    .safetensors; each is grafted into XLSREncoder (timed, equal to the
    file bit for bit, the positional conv within FOLD_RTOL of the fp64
    fold), then trains through the CLI on the phase's tree, stopped by its
    on_step hook after one step with a finite loss. The fairseq file stays
    for phase 19 (its path under "fairseq_pt")."""
    import torch

    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.models.convert_xlsr import graft_pretrained_xlsr
    from occm_tpu_torch.models.xlsr import XLSREncoder

    t_phase = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        sd = XLSREncoder(XLSRConfig()).state_dict()
    pos = "encoder.pos_conv.0."
    gen = torch.Generator().manual_seed(12)
    sd[pos + "weight_g"] = sd[pos + "weight_g"] * (
        0.5 + torch.rand(sd[pos + "weight_g"].shape, generator=gen))
    v64 = sd[pos + "weight_v"].double()
    fold = (sd[pos + "weight_g"].double() * v64
            / v64.pow(2).sum(dim=(0, 1), keepdim=True).sqrt())
    paths = {"fairseq .pt": os.path.join(workdir, "xlsr2_300m.pt"),
             "HF .safetensors": os.path.join(workdir, "model.safetensors")}
    t0 = time.perf_counter()
    write_fairseq_checkpoint(paths["fairseq .pt"], sd)
    write_hf_safetensors(paths["HF .safetensors"], sd)
    write_s = time.perf_counter() - t0
    protocol, train_dir, voc_dir = fixture
    encoder = XLSREncoder(XLSRConfig())
    out = {"write_s": write_s}
    for name, path in paths.items():
        t0 = time.perf_counter()
        graft_pretrained_xlsr(encoder, path)
        load_s = time.perf_counter() - t0
        got = encoder.state_dict()
        differ = [k for k in sd if not k.startswith(pos + "weight_")
                  and not torch.equal(got[k], sd[k])]
        if differ:
            fail(f"pretrained {name}: {len(differ)} grafted tensors differ "
                 f"from the file, e.g. {differ[:3]}")
        w = encoder.encoder.pos_conv[0].weight.detach().double()
        fold_err = float(((w - fold).abs()
                          / fold.abs().clamp_min(1e-30)).max())
        if fold_err > FOLD_RTOL:
            fail(f"pretrained {name}: folded positional conv off by "
                 f"{fold_err} (relative) > {FOLD_RTOL}")
        steps = []

        def one_step(step, metrics):
            steps.append(float(metrics["loss"]))
            raise _OneStep

        t0 = time.perf_counter()
        try:
            oc_training.main([
                "--train_protocol_file", protocol,
                "--train_dataset_dir", train_dir, "--vocoded_dir", voc_dir,
                "--model", "aasist", "--cut", str(TRAIN_CUT),
                "--num_epochs", "1", "--checkpoint_dir",
                os.path.join(workdir, "ck_pretrained"),
                "--pretrained_xlsr", path], on_step=one_step)
        except _OneStep:
            pass
        cli_s = time.perf_counter() - t0
        if len(steps) != 1 or not math.isfinite(steps[0]):
            fail(f"pretrained {name}: CLI steps {steps}")
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = dict(bytes=os.path.getsize(path), load_s=load_s,
                         fold_rel_err=fold_err, loss=steps[0], cli_s=cli_s)
        print(f"[pretrained] {name} ({os.path.getsize(path) / 2**30:.2f} "
              f"GiB): grafted in {load_s:.2f} s, every tensor equal to the "
              f"file bit for bit, positional conv within {fold_err:.2e} of "
              f"the fp64 fold (bound {FOLD_RTOL:.2e}); CLI, one step: loss "
              f"{steps[0]:.6f}, {cli_s:.1f} s with model build and graft",
              flush=True)
        if name != "fairseq .pt":  # phase 19 converts the fairseq file
            os.remove(path)
    out["fairseq_pt"] = paths["fairseq .pt"]
    losses = [out[name]["loss"] for name in paths]
    if losses[0] != losses[1]:
        fail(f"pretrained: the two files hold one encoder, but their first "
             f"steps' losses differ: {losses}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[pretrained] phase 11 took {out['seconds']:.1f} s (writing the "
          f"two files {write_s:.1f} s)", flush=True)
    return out


def phase_rawboost_all(workdir: str, fixture):
    """Phases 9-11. Returns the kernel wrappers' launches of phases 10 and
    11, the graphs' replayed launches, and the measurements."""
    from occm_tpu_torch.ops import launch_counts

    out = {"augment": phase_rawboost()}
    counts, replayed, out["train"] = phase_train_rawboost(workdir, fixture)
    before = launch_counts()
    out["pretrained"] = phase_pretrained(workdir, fixture)
    after = launch_counts()
    for name in counts:
        counts[name] += after[name] - before[name]
    return counts, replayed, out



# ----------------------------------------------------------------- phase 19

# Bound of phase 19's grafted positional conv against the fp64 fold of the
# fairseq file. The JAX package's converter (and the port's copy) folds the
# weight norm with an fp32 norm that numpy sums over two non-contiguous
# axes one term after another (n = C * C / G = 65 536 squares at XLS-R's
# widths), and the bridge splits the directory's kernel again with such a
# norm. Rounding errors of a long sum walk at random: their typical size is
# sqrt(n) u = 1.53e-5 (u = 2^-24), and two readings on an H100's host were
# 9.160e-6 and 9.311e-6. 1e-4 is 6.5 sqrt(n) u, 11x those readings, and
# 20x below one bf16 rounding (2^-9 = 1.95e-3 relative), so a fold done in
# bf16, or a wrong layout, scale or group (each O(1e-3) or more), fails it.
ORBAX_FOLD_RTOL = 1e-4


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _serve_once(weights: str, artifacts_dir: str, wave: np.ndarray):
    """oc_server on `weights` (bucket 96000 warmed up), one request with
    the raw PCM of `wave`; returns (score, the flash launches it made,
    seconds to start)."""
    from occm_tpu_torch.ops import attention

    t0 = time.perf_counter()
    with serving(["--pretrained-sslaasist", weights, "--artifacts_dir",
                  artifacts_dir, "--host", "127.0.0.1", "--port", "0",
                  "--buckets", "96000"], f"orbax: server on {weights}") \
            as started:
        up_s = time.perf_counter() - t0
        before = attention.LAUNCHES
        status, payload, _ = post(started.server.port,
                                  wave.astype("<f4").tobytes(),
                                  {"X-Sample-Rate": "16000"})
        launched = attention.LAUNCHES - before
        check_response(f"orbax serve {weights}", status, payload)
    return payload["score"], launched, up_s


class _TwoSteps(Exception):
    """Raised by phase 19's on_step hook to end a CLI run after 2 steps."""


def phase_orbax(workdir: str, fixture, ckpt: str, fairseq_pt=None,
                scoring=None):
    """Phase 19: the JAX package's orbax checkpoints without orbax, at
    full width on phase 4's seed model, its BatchNorms given running
    statistics of their own (torch's defaults would hide lost
    batch_stats). libzstd's version; that .pt converted by
    `convert_backend.convert_model_file` to an orbax directory (bytes,
    seconds); `restore_tree` of it, every leaf equal to the converter's
    tree bit for bit (seconds, MB/s); `export_model_file` back to a .pt
    that loads strictly, every tensor the seed's but the positional conv's
    weight-norm pair and the never-run bn1s; `oc_classifier --mode 2c2`
    from the directory, from its exported .pt (scores bit for bit) and
    from the seed .pt (printed), flash launches a batch exact; the
    encoder's outputs from the directory and the seed .pt on one batch
    (within SCORE_RTOL); `oc_server` from the same three on one 6 s
    request (the directory's score bit for bit with the export's);
    `oc_training --init_from` the directory and its exported .pt for 2
    eager steps each under deterministic algorithms (losses within
    LOSS_RTOL, flash launches a step exact); `convert_xlsr` of phase 11's
    fairseq .pt to a directory grafted by `--pretrained_xlsr`'s graft:
    every tensor equal to the .pt graft's bit for bit but the positional
    conv (within ORBAX_FOLD_RTOL of the fp64 fold). `scoring`: phase 4's
    (root, eval_dir, eval list); without it (--orbax-only) the phase
    writes the eval set. Returns the kernel wrappers' launches and the
    measurements."""
    import torch

    from occm_tpu_torch.audio import pad_numpy
    from occm_tpu_torch.cli import oc_classifier, oc_server, oc_training
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.io import zstd
    from occm_tpu_torch.io.wav import load_audio
    from occm_tpu_torch.models import AModel, load_reference_state_dict
    from occm_tpu_torch.models.convert_backend import (
        convert_model_file, convert_model_state_dict, export_model_file)
    from occm_tpu_torch.models.convert_xlsr import (
        convert_checkpoint_file, graft_pretrained_xlsr, read_checkpoint)
    from occm_tpu_torch.models.xlsr import XLSREncoder
    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train.orbax import restore_tree

    t_phase = time.perf_counter()
    xcfg = XLSRConfig()
    layers = xcfg.encoder_layers
    totals = dict.fromkeys(launch_counts(), 0)
    out = {"libzstd": zstd.version()}
    print(f"[orbax] {zstd.LIBRARY} {out['libzstd']} (ctypes)", flush=True)

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    # ---- the seed .pt with BatchNorm running statistics of its own
    seed_sd = load_reference_state_dict(ckpt)
    gen = torch.Generator().manual_seed(19)
    stats = [k for k in seed_sd if k.endswith((".running_mean",
                                                ".running_var"))]
    for k in stats:
        r = torch.rand(seed_sd[k].shape, generator=gen)
        seed_sd[k] = (0.5 + r if k.endswith("var") else r - 0.5).to(
            seed_sd[k].dtype)
    ckpt = os.path.join(workdir, "orbax_seed.pt")
    torch.save(seed_sd, ckpt)
    print(f"[orbax] seed .pt: {len(stats)} BatchNorm running statistics "
          f"drawn (means in [-0.5, 0.5), variances in [0.5, 1.5))",
          flush=True)

    # ---- write: the seed .pt through the converter into a directory
    d = os.path.join(workdir, "orbax_amodel")
    t0 = time.perf_counter()
    kind = convert_model_file(ckpt, d, xlsr_cfg=xcfg)
    out["write_s"] = time.perf_counter() - t0
    out["dir_bytes"] = _dir_bytes(d)
    if kind != "amodel":
        fail(f"orbax: convert_model_file found a {kind}, not an amodel")
    # ---- read: every leaf as the converter made it
    t0 = time.perf_counter()
    tree = restore_tree(d)
    out["read_s"] = time.perf_counter() - t0
    want = convert_model_state_dict(load_reference_state_dict(ckpt),
                                    xlsr_cfg=xcfg)
    want.pop("_kind")
    got, wanted = dict(_leaves(tree)), dict(_leaves(want))
    if set(got) != set(wanted):
        fail(f"orbax: the directory's paths are not the converter's: "
             f"{sorted(set(got) ^ set(wanted))[:4]}")
    differ = [k for k, w in wanted.items()
              if not (isinstance(got[k], np.ndarray)
                      and got[k].dtype == np.asarray(w).dtype
                      and got[k].shape == np.shape(w)
                      and got[k].tobytes() == np.asarray(w).tobytes())]
    if differ:
        fail(f"orbax: {len(differ)} leaves read back differ from the "
             f"converter's, e.g. {differ[:3]}")
    out["array_bytes"] = sum(a.nbytes for a in got.values())
    out["leaves"] = len(got)
    out["read_MBps"] = out["array_bytes"] / 1e6 / out["read_s"]
    out["write_MBps"] = out["array_bytes"] / 1e6 / out["write_s"]
    del tree, want, got, wanted
    print(f"[orbax] write: {ckpt} -> {d}, {out['leaves']} leaves, "
          f"{out['dir_bytes']} bytes on disk ({out['array_bytes']} of "
          f"arrays), {out['write_s']:.2f} s ({out['write_MBps']:.0f} MB/s "
          f"of arrays, the .pt's load and the conversion included); read: "
          f"restore_tree {out['read_s']:.2f} s ({out['read_MBps']:.0f} "
          f"MB/s), every leaf equal to the converter's bit for bit",
          flush=True)
    # ---- export round trip
    exported = os.path.join(workdir, "orbax_export.pt")
    t0 = time.perf_counter()
    export_model_file(d, exported, xlsr_cfg=xcfg)
    out["export_s"] = time.perf_counter() - t0
    sd = load_reference_state_dict(exported)
    with torch.device("meta"):
        meta = AModel(AASISTConfig(), xcfg)
    meta.load_state_dict(sd, strict=True, assign=True)
    pos = "ssl_model.model.encoder.pos_conv.0."
    # the reference's never-run bn1 BatchNorms have no place in the JAX
    # layout: the export writes them at torch's defaults
    dead = [k for k in seed_sd if ".0.bn1." in k and k.startswith("encoder.")]
    changed = [k for k, v in seed_sd.items() if not k.startswith(pos)
               and k not in dead and not torch.equal(sd[k], v)]
    if changed:
        fail(f"orbax: the export differs from the seed .pt in "
             f"{len(changed)} tensors, e.g. {changed[:3]}")
    kept = sum(k not in dead for k in stats)
    del meta, sd, seed_sd
    print(f"[orbax] export: {out['export_s']:.2f} s, loads strictly into "
          f"AModel; every tensor but the positional conv's weight-norm "
          f"pair and the {len(dead)} of the never-run bn1 BatchNorms (at "
          f"torch's defaults) equal to the seed .pt's, its {kept} running "
          f"statistics of run BatchNorms included", flush=True)

    # ---- score: oc_classifier 2c2 from the directory, its export and the
    # seed .pt. The directory and its export hold the same tensors, so
    # their scores must agree bit for bit; the seed differs from them only
    # in the positional conv's refolded weight norm (ORBAX_FOLD_RTOL)
    protocol, train_dir, voc_dir = fixture
    if scoring is None:
        root = os.path.join(workdir, "orbax_scoring")
        os.makedirs(root)
        eval_dir, paths = write_eval_set(root)
        eval_list = paths["eval.txt"]
    else:
        root, eval_dir, eval_list = scoring
    argv = ["--protocol_file", protocol, "--dataset_dir", train_dir,
            "--eval_protocol_file", eval_list, "--eval_dataset_dir",
            eval_dir, "--mode", "2c2"]
    lens = [len(load_audio(os.path.join(eval_dir, f))[0])
            for f in sorted(os.listdir(eval_dir))]
    want_flash = layers * flash_batches(lens)
    sources = (("dir", d), ("export", exported), ("pt", ckpt))
    scores = {}
    for name, weights in sources:
        score_file = os.path.join(root, f"scores_orbax_{name}.txt")
        reset_counts()
        t0 = time.perf_counter()
        oc_classifier.main(argv + ["--pretrained-sslaasist", weights,
                                   "--score_file", score_file])
        torch.cuda.synchronize()
        counts = read_counts()
        add(counts)
        out[f"score_{name}_s"] = time.perf_counter() - t0
        if counts["flash_attn_fwd"] != want_flash or counts["ffn_fwd"]:
            fail(f"orbax: oc_classifier 2c2 from the {name} launched "
                 f"{counts}, want flash_attn_fwd {want_flash}, ffn_fwd 0")
        scores[name] = np.loadtxt(score_file)
    a, e, b = scores["dir"], scores["export"], scores["pt"]
    err = float(np.abs(a - b).max() / np.abs(b).max())
    out["score"] = dict(n=int(a.size), export_bit_for_bit=bool(
        np.array_equal(a, e)), seed_bit_for_bit=bool(np.array_equal(a, b)),
        seed_rel_err_of_max=err, flash_launches=want_flash)
    if a.shape != b.shape or not (np.isfinite(a).all()
                                  and np.isfinite(b).all()):
        fail(f"orbax: 2c2 scores from the directory {a}, from the seed "
             f".pt {b}")
    if not np.array_equal(a, e):
        fail(f"orbax: 2c2 scores from the directory {a} are not its "
             f"exported .pt's {e} bit for bit")
    print(f"[orbax] score: oc_classifier --mode 2c2 from the directory, "
          f"{a.size} utterances in {out['score_dir_s']:.1f} s (its export "
          f"{out['score_export_s']:.1f} s, the seed .pt "
          f"{out['score_pt_s']:.1f} s), flash launches {want_flash} "
          f"({layers} a flash batch) on each; bit for bit with the export's "
          f"scores; against the seed .pt's: bit for bit "
          f"{out['score']['seed_bit_for_bit']}, max |diff| {err:.3e} of the "
          f"largest score", flush=True)

    # ---- the seed against the directory where the refold acts: the
    # encoder. The refold moves the positional conv within ORBAX_FOLD_RTOL,
    # which flips a few of its bf16 roundings; 24 bf16 layers carry that to
    # ~1e-2 of the encoder's outputs (relative L2), as they carry the
    # flash-vs-plain roundings SCORE_RTOL bounds, and the 2c2 scores,
    # distances of the embeddings to the reference, moved 5.1e-2 of the
    # largest on an H100: so the scores are printed above, and the encoder
    # is held
    rng = np.random.default_rng(20)
    x = torch.from_numpy(np.stack([pad_numpy(synthetic_wave(rng, 6.0),
                                             96000) for _ in range(8)])).to(
        "cuda")
    feats, embs = {}, {}
    for name, weights in (("dir", d), ("pt", ckpt)):
        model = oc_server.build_model(oc_server.xlsr_config(), weights,
                                      False, "cuda")
        with torch.inference_mode():
            feats[name] = model.ssl_model(x, "flash")
            embs[name] = model.backend(feats[name])[0].float()
            feats[name] = feats[name].float()
        del model
        torch.cuda.empty_cache()

    def rel_l2(p, q):
        return float((p - q).norm() / q.norm())

    enc = rel_l2(feats["dir"], feats["pt"])
    emb = rel_l2(embs["dir"], embs["pt"])
    out["encoder"] = dict(rel_l2=enc, embedding_rel_l2=emb, batch="8 x 6 s")
    print(f"[orbax] encoder outputs, one batch of 8 x 6 s, the directory "
          f"against the seed .pt (flash): relative L2 {enc:.3e} (bound "
          f"{SCORE_RTOL}); AASIST's embedding {emb:.3e}", flush=True)
    if not enc <= SCORE_RTOL:
        fail(f"orbax: encoder outputs from the directory and the seed .pt "
             f"differ by {enc} (relative L2) > {SCORE_RTOL}")
    del feats, embs, x

    # ---- serve: one 6 s request from each of the three
    art = os.path.join(workdir, "orbax_artifacts")
    os.makedirs(art)
    ref = os.path.join(root, "reference_embedding.npy")
    np.save(os.path.join(art, "reference_embedding.npy"),
            np.load(ref) if os.path.exists(ref) else np.zeros(160,
                                                             np.float32))
    np.save(os.path.join(art, "threshold.npy"), np.float32(1.0))
    wave = synthetic_wave(np.random.default_rng(19), 6.0)
    served = {}
    for name, weights in sources:
        reset_counts()
        score, launched, up_s = _serve_once(weights, art, wave)
        add(read_counts())
        if launched != layers:
            fail(f"orbax: the 6 s request to the {name} server launched "
                 f"the flash kernel {launched} times, want {layers}")
        served[name] = dict(score=score, up_s=up_s)
    got = {name: served[name]["score"] for name in served}
    rel = abs(got["dir"] - got["pt"]) / max(abs(got["pt"]), 1e-30)
    out["serve"] = dict(served, seed_rel_err=rel,
                        seed_bit_for_bit=got["dir"] == got["pt"])
    if got["dir"] != got["export"] or not math.isfinite(got["pt"]):
        fail(f"orbax: the directory's server scored {got['dir']!r}, its "
             f"exported .pt's {got['export']!r} (not bit for bit), the "
             f"seed .pt's {got['pt']!r}")
    print(f"[orbax] serve: oc_server from the directory up in "
          f"{served['dir']['up_s']:.1f} s, 6 s request score "
          f"{got['dir']:.6f} ({layers} flash launches), bit for bit with "
          f"its export's server; the seed .pt server's {got['pt']:.6f}: "
          f"bit for bit {out['serve']['seed_bit_for_bit']}, relative "
          f"{rel:.3e}", flush=True)

    # ---- train: --init_from the directory and its export (the same
    # weights), 2 eager steps each under deterministic algorithms
    trained = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, weights in (("dir", d), ("pt", exported)):
            reset_counts()
            rec = StepRecorder()

            def two_steps(step, metrics):
                rec(step, metrics)
                if len(rec.steps) == 2:
                    raise _TwoSteps

            t0 = time.perf_counter()
            try:
                oc_training.main([
                    "--train_protocol_file", protocol,
                    "--train_dataset_dir", train_dir, "--vocoded_dir",
                    voc_dir, "--model", "aasist", "--cut", str(TRAIN_CUT),
                    "--num_epochs", "1", "--compactness_weight", "0.1",
                    "--descriptiveness_weight", "0.9", "--checkpoint_dir",
                    os.path.join(workdir, f"ck_orbax_{name}"),
                    "--init_from", weights], on_step=two_steps)
            except _TwoSteps:
                pass
            add(read_counts())
            check_steps(f"orbax init_from {name}", rec, {
                "flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers,
                "flash_attn_bwd_dout_copies": 0, "layernorm_bwd": 0,
                "fused_adam": 0, "ffn_fwd": 0})
            trained[name] = dict(losses=[st["loss"] for st in rec.steps],
                                 cli_s=time.perf_counter() - t0,
                                 launches=rec.steps[0]["launches"])
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    os.remove(exported)
    os.remove(ckpt)
    lo_d, lo_p = trained["dir"]["losses"], trained["pt"]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(lo_d, lo_p))
    out["train"] = dict(trained, rel_err=rel, bit_for_bit=lo_d == lo_p)
    if len(lo_d) != 2 or rel > LOSS_RTOL:
        fail(f"orbax: --init_from losses {lo_d} against the .pt's {lo_p} "
             f"({rel} > {LOSS_RTOL})")
    print(f"[orbax] train: --init_from the directory, 2 eager steps, "
          f"losses {lo_d} against its exported .pt's {lo_p} (bit for bit "
          f"{lo_d == lo_p}, relative {rel:.3e}, bound {LOSS_RTOL}); "
          f"launches a step {trained['dir']['launches']}", flush=True)

    # ---- graft: convert_xlsr of phase 11's fairseq .pt, then the graft
    if fairseq_pt is None:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            enc_sd = XLSREncoder(xcfg).state_dict()
        fairseq_pt = os.path.join(workdir, "xlsr2_300m.pt")
        write_fairseq_checkpoint(fairseq_pt, enc_sd)
        del enc_sd
    xd = os.path.join(workdir, "orbax_xlsr")
    t0 = time.perf_counter()
    rates = convert_checkpoint_file(fairseq_pt, xd, cfg=xcfg)
    out["convert_xlsr_s"] = time.perf_counter() - t0
    encoders = {}
    for name, path in (("dir", xd), ("pt", fairseq_pt)):
        with torch.device("meta"):  # no init: the graft writes every tensor
            encoders[name] = XLSREncoder(xcfg).to_empty(device="cpu")
        t0 = time.perf_counter()
        graft_pretrained_xlsr(encoders[name], path)
        out[f"graft_{name}_s"] = time.perf_counter() - t0
    a, b = encoders["dir"].state_dict(), encoders["pt"].state_dict()
    pos = "encoder.pos_conv.0."
    differ = [k for k in b if not k.startswith(pos + "weight_")
              and not torch.equal(a[k], b[k])]
    if differ:
        fail(f"orbax: {len(differ)} tensors grafted from the directory "
             f"differ from the .pt graft's, e.g. {differ[:3]}")
    raw = read_checkpoint(fairseq_pt)
    v64 = raw[pos + "weight_v"].double()
    fold = (raw[pos + "weight_g"].double() * v64
            / v64.pow(2).sum(dim=(0, 1), keepdim=True).sqrt())
    del raw

    def rel_err(w, ref):
        return float(((w - ref).abs() / ref.abs().clamp_min(1e-30)).max())

    w_dir = encoders["dir"].encoder.pos_conv[0].weight.detach().double()
    w_pt = encoders["pt"].encoder.pos_conv[0].weight.detach().double()
    bound = ORBAX_FOLD_RTOL
    out["graft"] = dict(
        rates=rates, pos_conv_rel_err_dir=rel_err(w_dir, fold),
        pos_conv_rel_err_pt=rel_err(w_pt, fold),
        pos_conv_dir_vs_pt=rel_err(w_dir, w_pt), bound=bound)
    if out["graft"]["pos_conv_rel_err_dir"] > bound:
        fail(f"orbax: the directory's grafted positional conv is "
             f"{out['graft']['pos_conv_rel_err_dir']} from the fp64 fold "
             f"> {bound}")
    del encoders, a, b, w_dir, w_pt, fold, v64
    os.remove(fairseq_pt)
    print(f"[orbax] graft: convert_xlsr {out['convert_xlsr_s']:.2f} s "
          f"(dropout rates {rates}); --pretrained_xlsr's graft from the "
          f"directory {out['graft_dir_s']:.2f} s, from the .pt "
          f"{out['graft_pt_s']:.2f} s; every tensor equal bit for bit but "
          f"the positional conv: relative to the fp64 fold "
          f"{out['graft']['pos_conv_rel_err_dir']:.3e} from the directory "
          f"(bound {bound:.3e}), {out['graft']['pos_conv_rel_err_pt']:.3e} "
          f"from the .pt; directory against .pt "
          f"{out['graft']['pos_conv_dir_vs_pt']:.3e}", flush=True)
    shutil.rmtree(d, ignore_errors=True)
    shutil.rmtree(xd, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[orbax] phase 19 took {out['seconds']:.1f} s", flush=True)
    return totals, out

# ----------------------------------------------------------------- phase 12

#: the other models of `oc_training --model`, in the order phase 12 runs them
OTHER_MODELS = ("ssl_resnet34", "ssl_lcnn", "ssl_lcnn_asoftmax", "occm", "cnn")
#: eval utterances of phase 12's 1c1 / 2c1 scoring, seconds (buckets of 4,
#: 5, 6 and 7 s: the flash kernel)
MODEL_EVAL_SECONDS = (3.6, 4.5, 5.4, 6.3)


def model_step_checks(name, kind, model, batches, cfg, per_step):
    """One of the other models at full width: 3 eager steps, then the
    same 3 steps as one CUDA graph (k = 3) from the same weights and
    generator seed, under deterministic algorithms: every loss and the
    final weights bit for bit, and the device step count at 3 (the angle
    loss anneals lambda from it inside the graph). The wrappers' launches
    of each eager step, of the warm-up and of the capture are gated
    exactly. Then the step's wall ms eager and as the graph (two rounds
    in turns), the device busy share of each (torch.profiler) and the peak
    memory, all under the same deterministic algorithms. Returns
    (launches by wrapper, graph replay launches, row)."""
    import torch

    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.ops.fused_adam import MAX_LEAVES
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.graph import GraphedSteps
    from occm_tpu_torch.train.loop import train_step

    k = len(batches)
    xs = np.stack([b[0] for b in batches])
    ls = np.stack([b[1] for b in batches])
    # one fused_adam launch a step holds every leaf with a gradient: all
    # but LCNN's never-run group BatchNorms
    live = [n for n, _ in model.named_parameters() if ".0.bn." not in n]
    if -(-len(live) // MAX_LEAVES) != per_step["fused_adam"]:
        fail(f"models {name}: {len(live)} leaves with a gradient need "
             f"{-(-len(live) // MAX_LEAVES)} fused_adam launches a step")
    model.to(DEVICE)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    # ---- 3 eager steps
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    state = create_train_state(model, cfg, kind)
    rec = StepRecorder()
    for x, labels in batches:
        rec(state.step + 1, train_step(
            state, torch.from_numpy(x).to(DEVICE),
            torch.from_numpy(labels).to(DEVICE), cfg))
    eager_peak = torch.cuda.max_memory_allocated() / 2**30
    check_steps(f"models {name} eager", rec,
                {**per_step, "flash_attn_bwd_dout_copies": 0})
    eager_counts = launch_counts()
    eager_losses = [st["loss"] for st in rec.steps]
    eager_weights = {n: t.detach().clone()
                     for n, t in model.state_dict().items()}
    del state
    gc.collect()
    # ---- the same 3 steps as one graph, from the same weights and seed
    model.load_state_dict(init)
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = create_train_state(model, cfg, kind)
    runner = GraphedSteps(state, cfg, k)
    before = launch_counts()
    metrics = runner.run(xs, ls)
    torch.cuda.synchronize()
    after = launch_counts()
    graph_peak = torch.cuda.max_memory_allocated() / 2**30
    captured = runner.capture_launches[tuple(xs.shape)]
    for key, n in per_step.items():
        if captured[key] != k * n or after[key] - before[key] != (k + 1) * n:
            fail(f"models {name}: {key} captured {captured[key]} and "
                 f"called {after[key] - before[key]} times, want {k} x {n} "
                 f"and warm-up + capture = {(k + 1) * n}")
    graph_losses = [float(v) for v in metrics["step_loss"]]
    if graph_losses != eager_losses:
        fail(f"models {name}: graph losses {graph_losses} are not the eager "
             f"steps' {eager_losses}")
    differ = [n for n, t in model.state_dict().items()
              if not torch.equal(t, eager_weights[n])]
    if differ:
        fail(f"models {name}: the graph's weights differ from the eager "
             f"steps' in {len(differ)} tensors, e.g. {differ[:3]}")
    if state.step != k or int(state.step_t) != k:
        fail(f"models {name}: step count {state.step} / {int(state.step_t)}"
             f" after the graph, want {k}")
    del eager_weights
    counts = {key: eager_counts[key] + after[key] - before[key]
              for key in per_step}
    replayed = {key: captured[key] * runner.replays for key in per_step}
    # ---- wall ms a step, eager and as the graph, in turns; device busy
    x1 = torch.from_numpy(xs[0]).to(DEVICE)
    l1 = torch.from_numpy(ls[0]).to(DEVICE)

    def eager():
        for _ in range(k):
            train_step(state, x1, l1, cfg)

    runs = {"eager": eager, "graph k=3": lambda: runner.run(xs, ls)}
    walls = {label: [] for label in runs}
    for _ in range(TIMING_ROUNDS):
        for label, fn in runs.items():
            walls[label].append(wall_ms(fn, k))
    want = {key: per_step[key] * per_call
            for key, (_, per_call) in KERNEL_NAMES.items()}
    busy = {label: profile_steps(fn, k, f"{name} {label}", want)
            for label, fn in runs.items()}
    row = dict(model=name, kind=kind, losses=eager_losses,
               params=sum(p.numel() for p in model.parameters()),
               leaves=len(list(model.parameters())), adam_leaves=len(live),
               wall_ms=walls, peak_gib={"eager": eager_peak,
                                        "graph capture": graph_peak},
               busy={label: {key: r[key] for key in
                             ("window_ms", "busy_ms", "busy_share",
                              "launches")} for label, r in busy.items()},
               capture_s=runner.capture_seconds[tuple(xs.shape)])
    print(f"[models] {name} ({kind}): losses {eager_losses} (graph = eager "
          f"bit for bit, weights too; step count {k}); wall ms a step "
          f"{walls}; device busy {row['busy']}; peak {row['peak_gib']} GiB;"
          f" capture {row['capture_s']:.2f} s", flush=True)
    del state, runner
    gc.collect()  # a state and its graph runner refer to each other
    torch.cuda.empty_cache()
    return counts, replayed, row


def phase_models_cli(workdir: str, fixture, layers: int):
    """The other models through the CLIs at full width: `oc_training
    --model ssl_resnet34` for its epoch of 6 steps (ssl_resnet34_vocoded_0
    .pt), `oc_classifier --mode 1c1` and `2c1` from it and from the
    ssl_vocoded / senet34_vocoded pair split off it (score files equal),
    its distances against a direct SSLResNet34 forward within SCORE_RTOL,
    EER of both score files in [0, 1]; then `oc_training --model
    ssl_lcnn_asoftmax --steps_per_dispatch 3` for one chunk. Returns the
    wrappers' launches, the graph replay launches and the measurements."""
    import torch

    from occm_tpu_torch.audio import pad_numpy
    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.cli import oc_classifier, oc_training
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.data import ASVDataset
    from occm_tpu_torch.evaluate import calculate_eer_merged, evaluate_scores
    from occm_tpu_torch.io.scorefiles import read_comma_scores
    from occm_tpu_torch.io.wav import load_audio
    from occm_tpu_torch.losses import pairwise_distance
    from occm_tpu_torch.models import SSLResNet34, load_reference_state_dict

    protocol, train_dir, voc_dir = fixture
    root = os.path.join(workdir, "models_cli")
    os.makedirs(root)
    out, counts, replayed = {}, {}, {}

    def add(delta):
        for key, n in delta.items():
            counts[key] = counts.get(key, 0) + n

    # ---- training: --model ssl_resnet34, one epoch
    ck = os.path.join(root, "ck")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        reset_counts()
        rec = StepRecorder()
        t0 = time.perf_counter()
        oc_training.main([
            "--train_protocol_file", protocol, "--train_dataset_dir",
            train_dir, "--vocoded_dir", voc_dir, "--model", "ssl_resnet34",
            "--cut", str(TRAIN_CUT), "--num_epochs", "1",
            "--compactness_weight", "0.1", "--descriptiveness_weight",
            "0.9", "--checkpoint_dir", ck], on_step=rec)
        out["train_s"] = time.perf_counter() - t0
        add(read_counts())
    finally:
        os.chdir(cwd)
    check_steps("models cli ssl_resnet34", rec, {
        "flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
        "flash_attn_bwd_dkv": layers, "flash_attn_bwd_dout_copies": 0,
        "layernorm_bwd": 0, "fused_adam": 0, "ffn_fwd": 0})
    fused = os.path.join(ck, "ssl_resnet34_vocoded_0.pt")
    state = load_reference_state_dict(fused)
    pair = {"ssl": os.path.join(root, "ssl_vocoded_0.pt"),
            "senet": os.path.join(root, "senet34_vocoded_0.pt")}
    torch.save({k[len("frontend."):]: v for k, v in state.items()
                if k.startswith("frontend.")}, pair["ssl"])
    torch.save({k[len("resnet34."):]: v for k, v in state.items()
                if k.startswith("resnet34.")}, pair["senet"])
    print(f"[models] cli: oc_training --model ssl_resnet34, "
          f"{len(rec.steps)} steps in {out['train_s']:.1f} s (build, data, "
          f"checkpoint included), losses "
          f"{[round(st['loss'], 6) for st in rec.steps]}; {fused} "
          f"({os.path.getsize(fused) / 2**30:.2f} GiB) split into "
          f"{sorted(pair)}", flush=True)

    # ---- scoring: 1c1 and 2c1, from the fused file and from the pair
    eval_dir, paths = write_eval_set(root, seconds=MODEL_EVAL_SECONDS)
    weights = {"fused": ["--pretrained-ssl", fused],
               "pair": ["--pretrained-ssl", pair["ssl"],
                        "--pretrained-senet", pair["senet"]]}
    files = {}
    for how, flags in weights.items():
        run = os.path.join(root, how)
        os.makedirs(run)
        os.chdir(run)  # reference_embedding.npy, threshold.npy land here
        try:
            for mode in ("1c1", "2c1"):
                files[how, mode] = os.path.join(run, f"scores_{mode}.txt")
                reset_counts()
                t0 = time.perf_counter()
                oc_classifier.main([
                    *flags, "--protocol_file", protocol, "--dataset_dir",
                    train_dir, "--eval_protocol_file", paths["eval.txt"],
                    "--eval_dataset_dir", eval_dir, "--mode", mode,
                    "--score_file", files[how, mode]])
                torch.cuda.synchronize()
                out[f"score_{how}_{mode}_s"] = time.perf_counter() - t0
                add(read_counts())
        finally:
            os.chdir(cwd)
    for mode in ("1c1", "2c1"):
        a = open(files["fused", mode]).read()
        b = open(files["pair", mode]).read()
        if a != b or len(a.splitlines()) != len(MODEL_EVAL_SECONDS):
            fail(f"oc_classifier {mode}: the fused file and the pair score "
                 f"differently:\n{a}\n{b}")
    ref_dir = os.path.join(root, "fused")
    reference = np.load(os.path.join(ref_dir, "reference_embedding.npy"))
    threshold = float(np.load(os.path.join(ref_dir, "threshold.npy")))
    if not np.array_equal(reference, np.load(os.path.join(
            root, "pair", "reference_embedding.npy"))):
        fail("1c1: the fused file and the pair give other references")
    d_cli = np.asarray(read_comma_scores(files["fused", "1c1"]))
    logits = np.loadtxt(files["fused", "2c1"])
    if not (reference.shape == (128,) and np.isfinite(d_cli).all()
            and np.isfinite(logits).all()):
        fail(f"1c1 / 2c1 outputs: reference {reference.shape}, distances "
             f"{d_cli}, logits {logits}")

    # ---- the same distances from a direct SSLResNet34 forward
    model = SSLResNet34(at_depth(XLSRConfig()))
    model.load_state_dict(state, strict=True)
    del state
    model.to(DEVICE).eval()

    def embed(paths_):
        rows = []
        for path in paths_:
            wave = load_audio(path)[0]
            bucket = max(16000, -(-len(wave) // 16000) * 16000)
            x = torch.from_numpy(pad_numpy(wave, bucket)[None].astype(
                np.float32)).to(DEVICE)
            with torch.inference_mode():
                com, _ = model(x, attention_impl=select_attention_impl(
                    bucket))
            rows.append(com[0].float())
        return torch.stack(rows)

    train_ds = ASVDataset(protocol, train_dir)
    eval_ds = ASVDataset(paths["eval.txt"], eval_dir, eval=True)
    ref_direct = embed(train_ds.file_paths()).mean(dim=0)
    d_direct = pairwise_distance(embed(eval_ds.file_paths()),
                                 ref_direct[None]).cpu().numpy()
    rel = np.abs(d_direct - d_cli) / np.abs(d_direct)
    ref_rel = float((ref_direct.cpu() - torch.from_numpy(reference)).norm()
                    / ref_direct.norm().cpu())
    print(f"[models] 1c1 / 2c1: the fused file and the ssl_vocoded / "
          f"senet34_vocoded pair give equal score files and references; "
          f"distances {np.round(d_cli, 4).tolist()}, direct forward "
          f"{np.round(d_direct, 4).tolist()}: max rel diff {rel.max():.3e}, "
          f"reference {ref_rel:.3e} (bound {SCORE_RTOL}); threshold "
          f"{threshold:.6f}", flush=True)
    if not (rel.max() <= SCORE_RTOL and ref_rel <= SCORE_RTOL):
        fail(f"1c1 distances off the direct forward: rel {rel}, reference "
             f"{ref_rel}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res = evaluate_scores(files["fused", "1c1"], paths["eval.txt"],
                          paths["metadata.txt"], threshold=threshold)
    utt_file = os.path.join(root, "utt_scores_2c1.txt")
    with open(utt_file, "w") as f:
        for utt, lg in zip(open(paths["eval.txt"]).read().split(), logits):
            f.write(f"{utt} {float(lg)}\n")
    eer_2c, _ = calculate_eer_merged(paths["eval5.txt"], utt_file)
    for mode, eer in (("1c1", res["eer"]), ("2c1", eer_2c)):
        if not (math.isfinite(eer) and 0.0 <= eer <= 1.0):
            fail(f"EER {mode} = {eer}")
    out.update(eer_1c1=res["eer"], eer_2c1=eer_2c, max_rel=float(rel.max()),
               ref_rel=ref_rel)
    score_s = [round(v, 1) for k, v in out.items() if k.startswith("score_")]
    print(f"[models] EER 1c1 {res['eer'] * 100:.2f} %, 2c1 "
          f"{eer_2c * 100:.2f} % (random weights: the pipeline runs); "
          f"scoring s {score_s}", flush=True)

    # ---- --model ssl_lcnn_asoftmax --steps_per_dispatch 3: one chunk
    chunks = []

    def one_chunk(step, metrics):
        chunks.append([float(v) for v in metrics["step_loss"]])
        raise _OneStep

    reset_counts()
    os.chdir(root)
    try:
        t0 = time.perf_counter()
        oc_training.main([
            "--train_protocol_file", protocol, "--train_dataset_dir",
            train_dir, "--vocoded_dir", voc_dir, "--model",
            "ssl_lcnn_asoftmax", "--cut", str(TRAIN_CUT), "--num_epochs",
            "1", "--steps_per_dispatch", str(CONTROL_K), "--checkpoint_dir",
            os.path.join(root, "ck_angle")], on_step=one_chunk)
    except _OneStep:
        pass
    finally:
        os.chdir(cwd)
    out["angle_chunk_s"] = time.perf_counter() - t0
    got = read_counts()
    add(got)
    # one graph replay of what the capture recorded: k steps' launches
    want_calls = (CONTROL_K + 1) * 2 * layers
    if (len(chunks) != 1 or len(chunks[0]) != CONTROL_K
            or not all(math.isfinite(v) for v in chunks[0])
            or got["flash_attn_fwd"] != want_calls):
        fail(f"oc_training ssl_lcnn_asoftmax --steps_per_dispatch "
             f"{CONTROL_K}: chunks {chunks}, launches {got}, want "
             f"flash_attn_fwd {want_calls} (warm-up + capture)")
    for key in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        replayed[key] = got[key] // (CONTROL_K + 1) * CONTROL_K
    print(f"[models] cli: oc_training --model ssl_lcnn_asoftmax "
          f"--steps_per_dispatch {CONTROL_K}, one chunk as one graph: "
          f"losses {chunks[0]}, {out['angle_chunk_s']:.1f} s with model "
          "build and capture", flush=True)
    return counts, replayed, out


def phase_models(workdir: str, fixture):
    """Phase 12: the other models at full width and DEPTH layers
    (`model_step_checks` for
    each of OTHER_MODELS, one after another, each freed before the next;
    every kernel: flash attention, ln_impl and ffn_impl "pallas",
    fused_adam, remat; RawBoost off; the backends' default dropouts on),
    then the CLIs (`phase_models_cli`). Returns the kernel wrappers'
    launches, the graphs' replayed launches and the measurements."""
    import torch

    from occm_tpu_torch.cli.oc_training import make_model
    from occm_tpu_torch.config import RawBoostConfig, TrainConfig, XLSRConfig
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset

    protocol, train_dir, voc_dir = fixture
    t_phase = time.perf_counter()
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = list(MetaBatchPipeline(dataset, seed=0).epoch(0))[:CONTROL_K]
    xcfg = at_depth(XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                               attention_impl="flash"))
    layers = xcfg.encoder_layers
    per_step = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers, "layernorm_bwd": 2 * layers,
                "fused_adam": 1, "ffn_fwd": 2 * layers}
    cfg = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                      descriptiveness_weight=0.9, log_every=1,
                      optimizer="fused_adam", rawboost=RawBoostConfig(algo=0))
    counts = dict.fromkeys(per_step, 0)
    replayed = dict.fromkeys(per_step, 0)
    rows = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name in OTHER_MODELS:
            t0 = time.perf_counter()
            # built on the card: its initialisation draws from the CUDA
            # generator, seeded (and forked) here
            with torch.random.fork_rng(devices=[0]), torch.device(DEVICE):
                torch.manual_seed(0)
                model, kind = make_model(name, xcfg)
            build_s = time.perf_counter() - t0
            c, r, row = model_step_checks(name, kind, model, batches, cfg,
                                          per_step)
            row.update(build_s=build_s, seconds=time.perf_counter() - t0)
            rows.append(row)
            for key in per_step:
                counts[key] += c[key]
                replayed[key] += r[key]
            del model
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    with cli_at_depth():
        c, r, cli = phase_models_cli(workdir, fixture, layers)
    for key, n in c.items():
        if key in counts:
            counts[key] += n
    for key, n in r.items():
        replayed[key] += n
    out = dict(models=rows, cli=cli, seconds=time.perf_counter() - t_phase)
    print(f"[models] phase 12 took {out['seconds']:.1f} s", flush=True)
    return counts, replayed, out


# -------------------------------------- phase 13: remat and fast numerics

REMAT_POLICIES = ("nothing", "dots", "attn_out", "attn_out_inner",
                  "attn_probs", "attn_all")
#: the policies that keep other tensors on the plain attention path (its
#: QK^T, probabilities and P.V exist only there), run again with
#: attention_impl="xla" against that path's "nothing"
PLAIN_POLICIES = ("nothing", "attn_out_inner", "attn_probs", "dots")
#: the fields --fast_numerics sets (the JAX CLI's five,
#: occm_tpu/cli/oc_training.py:255-260)
FAST_FIELDS = dict(norm_dtype="bfloat16", gelu_approximate=True,
                   conv_gelu_approximate=True, bf16_param_mirror=True,
                   remat_policy="attn_out_inner")
#: fast against exact numerics at the same weights, where the knobs act:
#: the XLSR encoder's features within 2 % relative L2 and the gradient of
#: their mean square at cosine above 0.99 (the JAX suite's encoder gate,
#: tests/test_fast_numerics.py). AASIST's loss is not gated: its top-k
#: graph pooling reroutes under any bf16-sized change of its input, so the
#: loss moves as far when the exact run's input is scaled by 1 + 2^-8
#: (`same_params_check` prints both)
FAST_FEATURE_RTOL = 2e-2
FAST_GRAD_COSINE = 0.99
#: scoring buckets (seconds) of the flash-vs-xla measurement under fast
#: numerics, a full batch of 8 each, and the training graphs' rounds in
#: turns
FAST_SCORE_SECONDS = (2, 6, 12)
FAST_ROUNDS = 2


def set_xlsr_cfg(model, xcfg) -> None:
    """Point every module of `model` that holds its XLSR config at xcfg:
    the same weights under another remat policy or numerics."""
    from occm_tpu_torch.config import XLSRConfig

    for m in model.modules():
        if isinstance(getattr(m, "cfg", None), XLSRConfig):
            m.cfg = xcfg


def hand_mirror(model):
    """The bf16 mirror by its plain definition, outside the model: a
    wrapper whose forward casts the stack's fp32 parameters to bf16 and
    runs `model` (mirror off) on those copies through
    torch.func.functional_call; the gradients come back to the fp32
    leaves through the casts. Its parameters are model's."""
    import torch

    class HandMirror(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = model

        def forward(self, x, generator=None):
            stack = {n: p.to(torch.bfloat16) for n, p
                     in self.model.named_parameters()
                     if n.startswith("ssl_model.model.encoder.layers.")
                     and p.dtype == torch.float32}
            return torch.func.functional_call(
                self.model, stack, (x,), {"generator": generator})

    return HandMirror()


def remat_steps(label, model, init, cfg, batches, per_step, ref=None,
                keep=False):
    """The model from `init` under its current config: 3 eager steps (the
    second one's peak memory, reset before it: the optimizer's moments
    exist by then; and what the step holds when its forward ends, which
    is what the policy keeps), their losses and weights
    equal bit for bit to `ref`'s where given; then the same 3 steps as one
    CUDA graph, equal to them bit for bit; each wrapper's launches a step
    exact; the step's wall ms as the graph and its device-busy share.
    Returns (row, (losses, weights) when ref is None, launches, replayed
    launches, the graph runner when keep)."""
    import torch

    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.graph import GraphedSteps
    from occm_tpu_torch.train.loop import train_step

    t0 = time.perf_counter()
    k = len(batches)
    xs = np.stack([b[0] for b in batches])
    ls = np.stack([b[1] for b in batches])
    model.load_state_dict(init)
    gc.collect()
    torch.cuda.empty_cache()
    # ---- 3 eager steps
    reset_counts()
    state = create_train_state(model, cfg, "dual")
    rec = StepRecorder()
    held = []
    hook = model.register_forward_hook(
        lambda *_: held.append(torch.cuda.memory_allocated()))
    for i, (x, labels) in enumerate(batches):
        x, labels = (torch.from_numpy(x).to(DEVICE),
                     torch.from_numpy(labels).to(DEVICE))
        if i == 1:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        metrics = train_step(state, x, labels, cfg)
        if i == 1:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        rec(state.step, metrics)
    hook.remove()
    check_steps(f"remat {label} eager", rec,
                {**per_step, "flash_attn_bwd_dout_copies": 0})
    eager_counts = launch_counts()
    losses = [st["loss"] for st in rec.steps]
    weights = {n: t.detach().clone() for n, t in model.state_dict().items()}
    if ref is not None:
        differ = [n for n, t in weights.items() if not torch.equal(
            t, ref[1][n])]
        if losses != ref[0] or differ:
            fail(f"remat {label}: eager losses {losses} against "
                 f"{ref[0]}; weights differ in {len(differ)} tensors, "
                 f"e.g. {differ[:3]}")
    del state
    gc.collect()
    # ---- the same 3 steps as one graph, from the same weights
    model.load_state_dict(init)
    torch.cuda.empty_cache()
    state = create_train_state(model, cfg, "dual")
    runner = GraphedSteps(state, cfg, k)
    before = launch_counts()
    graph = runner.run(xs, ls)
    torch.cuda.synchronize()
    after = launch_counts()
    captured = runner.capture_launches[tuple(xs.shape)]
    for key, n in per_step.items():
        if captured[key] != k * n or after[key] - before[key] != (k + 1) * n:
            fail(f"remat {label}: {key} captured {captured[key]} and "
                 f"called {after[key] - before[key]} times, want {k} x {n} "
                 f"and warm-up + capture = {(k + 1) * n}")
    graph_losses = [float(v) for v in graph["step_loss"]]
    differ = [n for n, t in model.state_dict().items()
              if not torch.equal(t, weights[n])]
    if graph_losses != losses or differ:
        fail(f"remat {label}: graph losses {graph_losses} against eager "
             f"{losses}; weights differ in {len(differ)} tensors, e.g. "
             f"{differ[:3]}")
    if ref is not None:
        weights = None
    # ---- wall ms a step as the graph, device busy
    wall = wall_ms(lambda: runner.run(xs, ls), k)
    want = {key: per_step[key] * per_call
            for key, (_, per_call) in KERNEL_NAMES.items()}
    busy = profile_steps(lambda: runner.run(xs, ls), k, f"remat {label}",
                         want)
    counts = {key: eager_counts[key] + after[key] - before[key]
              for key in per_step}
    row = dict(losses=losses, peak_gib=peak / 2**30,
               step_gib=(peak - base) / 2**30,
               held_gib=(held[1] - base) / 2**30, graph_wall_ms=wall,
               busy={key: busy[key] for key in ("window_ms", "busy_ms",
                                                "busy_share", "launches")},
               capture_s=runner.capture_seconds[tuple(xs.shape)],
               seconds=time.perf_counter() - t0)
    print(f"[remat] {label}: losses {losses} (eager = graph bit for bit"
          f"{'' if ref is None else ', = the reference'}); peak "
          f"{row['peak_gib']:.3f} GiB in eager step 2 "
          f"({row['step_gib']:.3f} GiB above the step's start, "
          f"{row['held_gib']:.3f} GiB held at the forward's end); graph "
          f"{wall:.2f} ms a step, "
          f"device busy {busy['busy_ms']:.2f} ms ({busy['busy_share']:.3f});"
          f" capture {row['capture_s']:.2f} s; {row['seconds']:.1f} s in all",
          flush=True)
    if keep:
        return row, (losses, weights), counts, runner
    replayed = {key: captured[key] * runner.replays for key in per_step}
    del state, runner
    gc.collect()
    torch.cuda.empty_cache()
    return row, (losses, weights), counts, replayed


def same_params_check(model, init, cfg, batches, exact, fast):
    """The JAX suite's same-params gates (tests/test_fast_numerics.py)
    along a trajectory: from `init`, before each of the exact config's 3
    eager steps, both configs at those weights, on that batch: the XLSR
    encoder's features (relative L2) and the gradient of their mean square
    (cosine), held to FAST_FEATURE_RTOL and FAST_GRAD_COSINE; AASIST's loss
    of both with the same dropout masks (a generator seeded alike), and the
    exact loss again on the batch scaled by 1 + 2^-8 (one bf16 rounding:
    the loss's own sensitivity), printed. Returns the rows."""
    import torch

    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.loop import train_step

    def loss_of(x, labels, xcfg):
        set_xlsr_cfg(model, xcfg)
        model.train()
        with torch.no_grad():
            emb, logits = model(x, generator=torch.Generator(
                device=DEVICE).manual_seed(7))
            loss, _ = group_one_class_loss(
                emb, logits, labels, cfg.compactness_weight,
                cfg.descriptiveness_weight, cfg.meta_batch)
        return float(loss)

    def encoder(x, xcfg):
        set_xlsr_cfg(model, xcfg)
        enc = model.ssl_model.model
        enc.zero_grad(set_to_none=True)
        feats = enc(x)
        torch.mean(torch.square(feats)).backward()
        grad = torch.cat([p.grad.float().flatten() for p in enc.parameters()
                          if p.grad is not None])
        enc.zero_grad(set_to_none=True)
        return feats.detach().float(), grad

    model.load_state_dict(init)
    set_xlsr_cfg(model, exact)
    state = create_train_state(model, cfg, "dual")
    rows = []
    for x, labels in batches:
        x, labels = (torch.from_numpy(x).to(DEVICE),
                     torch.from_numpy(labels).to(DEVICE))
        f_e, g_e = encoder(x, exact)
        f_f, g_f = encoder(x, fast)
        row = dict(
            loss_exact=loss_of(x, labels, exact),
            loss_fast=loss_of(x, labels, fast),
            loss_exact_scaled=loss_of(x * (1 + 2.0 ** -8), labels, exact),
            feature_rel_l2=float((f_f - f_e).norm() / f_e.norm()),
            grad_cosine=float(torch.dot(g_f, g_e)
                              / (g_f.norm() * g_e.norm())))
        for key in ("loss_fast", "loss_exact_scaled"):
            row[key + "_rel"] = abs(row[key] - row["loss_exact"]) / abs(
                row["loss_exact"])
        rows.append(row)
        del f_e, g_e, f_f, g_f
        set_xlsr_cfg(model, exact)
        train_step(state, x, labels, cfg)
    del state
    print(f"[remat] fast against exact numerics at the same weights, before "
          f"each of 3 exact steps: {rows}", flush=True)
    for row in rows:
        if not (row["feature_rel_l2"] < FAST_FEATURE_RTOL
                and row["grad_cosine"] > FAST_GRAD_COSINE
                and math.isfinite(row["loss_fast"])):
            fail(f"fast numerics off exact at the same weights: {row} "
                 f"(features within {FAST_FEATURE_RTOL}, cosine above "
                 f"{FAST_GRAD_COSINE})")
    return rows


def phase_remat(workdir: str, fixture):
    """Phase 13: the remat policies and --fast_numerics at full width
    and DEPTH layers (AModel, XLSR-300M's widths, random weights from
    seed 0, 12 x 6 s, fused_adam, AASIST dropouts on, deterministic
    algorithms): `remat_steps` for each policy with every kernel against
    "nothing", and for PLAIN_POLICIES with plain attention against that
    path's "nothing"; the bf16 mirror against `hand_mirror`; fast against
    exact numerics; flash against xla attention under fast numerics
    (training and scoring); then the CLI. Returns the wrappers' launches,
    the graphs' replayed launches and the measurements."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train import create_train_state
    from occm_tpu_torch.train.loop import train_step

    protocol, train_dir, voc_dir = fixture
    t_phase = time.perf_counter()
    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    batches = list(MetaBatchPipeline(dataset, seed=0).epoch(0))[:CONTROL_K]
    base = at_depth(XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                               attention_impl="flash"))
    layers = base.encoder_layers
    # every policy reruns the flash forward in its recompute (the CUDA
    # backward reads out and lse, which no name keeps) and the fused FFN
    flash = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
             "flash_attn_bwd_dkv": layers, "layernorm_bwd": 2 * layers,
             "fused_adam": 1, "ffn_fwd": 2 * layers}
    plain = {**flash, "flash_attn_fwd": 0, "flash_attn_bwd_dq": 0,
             "flash_attn_bwd_dkv": 0}
    cfg = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                      descriptiveness_weight=0.9, log_every=1,
                      optimizer="fused_adam", rawboost=RawBoostConfig(algo=0))
    counts = dict.fromkeys(flash, 0)
    replayed = dict.fromkeys(flash, 0)

    def add(c, r=None):
        for key, n in c.items():
            if key in counts:
                counts[key] += n
        for key, n in (r or {}).items():
            replayed[key] += n

    out = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with torch.random.fork_rng(devices=[0]), torch.device(DEVICE):
            torch.manual_seed(0)
            model = AModel(AASISTConfig(), base)
        init = {n: t.detach().clone() for n, t in model.state_dict().items()}
        # ---- every policy, flash attention, then the plain path
        for impl, policies, per_step in (("flash", REMAT_POLICIES, flash),
                                         ("xla", PLAIN_POLICIES, plain)):
            ref = None
            for policy in policies:
                set_xlsr_cfg(model, dataclasses.replace(
                    base, attention_impl=impl, remat_policy=policy))
                row, eager, c, r = remat_steps(
                    f"{impl} {policy}", model, init, cfg, batches, per_step,
                    ref)
                add(c, r)
                ref = ref or eager
                out[f"{impl} {policy}"] = row
            del ref
        # ---- the mirror against its plain definition (remat off)
        mirrored = dataclasses.replace(base, remat=False, **FAST_FIELDS)
        no_remat = {**flash, "flash_attn_fwd": layers, "ffn_fwd": layers}
        runs = {}
        for how, xcfg in (("mirror", mirrored), ("by hand", dataclasses
                          .replace(mirrored, bf16_param_mirror=False))):
            set_xlsr_cfg(model, xcfg)
            model.load_state_dict(init)
            reset_counts()
            state = create_train_state(
                model if how == "mirror" else hand_mirror(model), cfg, "dual")
            rec = StepRecorder()
            for x, labels in batches:
                rec(state.step + 1, train_step(
                    state, torch.from_numpy(x).to(DEVICE),
                    torch.from_numpy(labels).to(DEVICE), cfg))
            check_steps(f"remat mirror {how}", rec,
                        {**no_remat, "flash_attn_bwd_dout_copies": 0})
            add(read_counts())
            runs[how] = ([st["loss"] for st in rec.steps],
                         {n: t.detach().clone()
                          for n, t in model.state_dict().items()})
            del state
        differ = [n for n, t in runs["mirror"][1].items()
                  if not torch.equal(t, runs["by hand"][1][n])]
        if runs["mirror"][0] != runs["by hand"][0] or differ:
            fail(f"bf16 mirror: losses {runs['mirror'][0]} against the "
                 f"hand cast's {runs['by hand'][0]}; weights differ in "
                 f"{len(differ)} tensors, e.g. {differ[:3]}")
        out["mirror"] = dict(losses=runs["mirror"][0])
        print(f"[remat] bf16 mirror = the stack cast by hand outside the "
              f"model, 3 eager steps bit for bit (losses "
              f"{runs['mirror'][0]}, weights)", flush=True)
        del runs
        # ---- fast numerics: flash (the kept runner) and xla, in turns
        fast, graphs = {}, {}
        for impl, per_step in (("flash", flash), ("xla", plain)):
            set_xlsr_cfg(model, dataclasses.replace(
                base, attention_impl=impl, **FAST_FIELDS))
            row, _, c, graphs[impl] = remat_steps(
                f"fast {impl}", model, init, cfg, batches, per_step,
                keep=True)
            add(c)
            fast[impl] = row
        same = same_params_check(model, init, cfg, batches, base,
                                 dataclasses.replace(base, **FAST_FIELDS))
        xs = np.stack([b[0] for b in batches])
        ls = np.stack([b[1] for b in batches])
        walls = {impl: [] for impl in graphs}
        for _ in range(FAST_ROUNDS):
            for impl, runner in graphs.items():
                walls[impl].append(wall_ms(lambda: runner.run(xs, ls),
                                           CONTROL_K))
        for impl, runner in graphs.items():
            add({}, {key: runner.capture_launches[tuple(xs.shape)][key]
                     * runner.replays for key in flash})
            fast[impl]["graph_wall_ms_in_turns"] = walls[impl]
        out["fast"] = dict(fast, same_params=same)
        print(f"[remat] fast numerics (attn_out_inner, bf16 norms and "
              f"mirror, tanh GELU): trajectory losses "
              f"{fast['flash']['losses']} against exact "
              f"{out['flash nothing']['losses']}; graph ms a step in turns "
              f"flash {walls['flash']}, xla {walls['xla']}", flush=True)
        del graphs
        gc.collect()
        torch.cuda.empty_cache()
        # ---- scoring under fast numerics: flash against xla per bucket
        from occm_tpu_torch.serve import make_score_fn

        set_xlsr_cfg(model, dataclasses.replace(base, **FAST_FIELDS))
        model.load_state_dict(init)
        model.eval()
        rng = np.random.default_rng(13)
        scoring = {}
        for seconds in FAST_SCORE_SECONDS:
            x = torch.from_numpy((rng.normal(size=(8, seconds * SR)) * 0.1)
                                 .astype(np.float32)).to(DEVICE)
            reset_counts()
            scoring[seconds] = utt_per_s(
                {impl: make_score_fn(model, impl)
                 for impl in ("flash", "xla")}, x)
            add(read_counts())
        out["fast_scoring_utt_per_s"] = scoring
        print(f"[remat] scoring under fast numerics, utt/s at batch 8 (A B "
              f"B A): {scoring}", flush=True)
        del model, init
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
    # ---- through the CLI
    with cli_at_depth():
        c, r, cli = phase_remat_cli(workdir, fixture, layers)
    add(c, r)
    out["cli"] = cli
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[remat] phase 13 took {out['seconds']:.1f} s", flush=True)
    return counts, replayed, out


def phase_remat_cli(workdir: str, fixture, layers: int):
    """`oc_training --fast_numerics` for its epoch of 6 steps (finite
    losses; its attention from auto), then `--fast_numerics
    --attention_impl flash --steps_per_dispatch 3` for one chunk (the
    flash kernels inside the graph under attn_out_inner)."""
    import torch

    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.cli import oc_training

    protocol, train_dir, voc_dir = fixture
    root = os.path.join(workdir, "remat_cli")
    os.makedirs(root)
    args = ["--train_protocol_file", protocol, "--train_dataset_dir",
            train_dir, "--vocoded_dir", voc_dir, "--cut", str(TRAIN_CUT),
            "--num_epochs", "1", "--compactness_weight", "0.1",
            "--descriptiveness_weight", "0.9", "--fast_numerics"]
    out, counts, replayed = {}, {}, {}
    impl = select_attention_impl(TRAIN_CUT)
    per_layer = 2 if impl == "flash" else 0
    cwd = os.getcwd()
    os.chdir(root)
    try:
        reset_counts()
        rec = StepRecorder()
        t0 = time.perf_counter()
        state = oc_training.main(args + ["--checkpoint_dir",
                                         os.path.join(root, "ck")],
                                 on_step=rec)
        out["train_s"] = time.perf_counter() - t0
        got = state.model.ssl_model.model.cfg
        if {k: getattr(got, k) for k in FAST_FIELDS} != FAST_FIELDS \
                or got.attention_impl != impl:
            fail(f"oc_training --fast_numerics built {got}")
        del state
        counts.update(read_counts())
        check_steps("remat cli --fast_numerics", rec, {
            "flash_attn_fwd": per_layer * layers,
            "flash_attn_bwd_dq": per_layer // 2 * layers,
            "flash_attn_bwd_dkv": per_layer // 2 * layers,
            "flash_attn_bwd_dout_copies": 0, "layernorm_bwd": 0,
            "fused_adam": 0, "ffn_fwd": 0})
        if len(rec.steps) != 6:
            fail(f"oc_training --fast_numerics took {len(rec.steps)} steps")
        out["losses"] = [st["loss"] for st in rec.steps]
        print(f"[remat] cli: oc_training --fast_numerics ({impl} attention "
              f"from auto), 6 steps in {out['train_s']:.1f} s (build, data, "
              f"checkpoint included), losses "
              f"{[round(v, 6) for v in out['losses']]}", flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        chunks = []

        def one_chunk(step, metrics):
            chunks.append([float(v) for v in metrics["step_loss"]])
            raise _OneStep

        reset_counts()
        t0 = time.perf_counter()
        try:
            oc_training.main(args + [
                "--attention_impl", "flash", "--steps_per_dispatch",
                str(CONTROL_K), "--checkpoint_dir",
                os.path.join(root, "ck_graph")], on_step=one_chunk)
        except _OneStep:
            pass
        out["chunk_s"] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    got = read_counts()
    for key, n in got.items():
        counts[key] = counts.get(key, 0) + n
    # warm-up + capture; the replay launches what the capture recorded
    want = (CONTROL_K + 1) * 2 * layers
    if (len(chunks) != 1 or len(chunks[0]) != CONTROL_K
            or not all(math.isfinite(v) for v in chunks[0])
            or got["flash_attn_fwd"] != want
            or got["flash_attn_bwd_dq"] != want // 2):
        fail(f"oc_training --fast_numerics --attention_impl flash "
             f"--steps_per_dispatch {CONTROL_K}: chunks {chunks}, launches "
             f"{got}, want flash_attn_fwd {want} (warm-up + capture)")
    for key in ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        replayed[key] = got[key] // (CONTROL_K + 1) * CONTROL_K
    out["chunk_losses"] = chunks[0]
    print(f"[remat] cli: oc_training --fast_numerics --attention_impl flash "
          f"--steps_per_dispatch {CONTROL_K}, one chunk as one graph "
          f"(attn_out_inner): losses {chunks[0]}, {out['chunk_s']:.1f} s "
          "with model build and capture", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return counts, replayed, out


# ------------------------------------ phase 14: the native IO lane (host)

NATIVE_BODY_SECONDS = 60
NATIVE_THREADS = (1, 8)
# The spool threshold of phase 14's server: a 60 s body of 16 kHz mono
# 16-bit FLAC is ~1.7 MB, under the default 8 MiB, which only ~5 min of
# such audio passes; lowered so that the 60 s body takes the spooled lane
NATIVE_SPOOL_BYTES = 1 << 20
# the host library's build in phase 2: its path and seconds
HOST_LIB = {}


def _flac_copy(job):
    """(wav path, flac path) -> the FLAC copy's samples as the Python
    decoder reads them: a worker of phase 14's process pool (the
    pure-Python FLAC codec runs ~130k samples/s)."""
    from occm_tpu_torch.io.flac import read_flac, write_flac
    from occm_tpu_torch.io.wav import read_wav

    wav, flac = job
    x, sr = read_wav(wav)
    write_flac(flac, x, sr)
    return read_flac(flac)[0]


def timed_s(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def device_busy(fn):
    """(host window ms, device busy ms) of fn() under torch.profiler:
    busy is the union of the device events' intervals."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return window, union_us(spans) / 1e3


class _LaneOff:
    """`io.native.available` patched to False: every caller decodes in
    Python, as where the library cannot be built."""

    def __enter__(self):
        from occm_tpu_torch.io import native

        self.native, self.available = native, native.available
        native.available = lambda: False
        native.reset_counts()

    def __exit__(self, *exc):
        self.native.available = self.available
        if not exc[0] and self.native.CALLS:
            fail(f"native lane forced off, yet called: "
                 f"{dict(self.native.CALLS)}")


def phase_native(workdir: str, fixture, ckpt: str):
    """Phase 14: the native IO lane on the host (the library built in
    phase 2 from native/*.cpp). On the phase's eval set (phase 4's 16 WAVs
    of 3-13 s), FLAC copies of it and a 60 s FLAC request body (written and
    decoded in Python by a process pool): the native readers against the
    Python ones bit for bit, whole, ranged and streamed; both decode lanes
    timed (files/s, decoded MB/s; native at 1 and 8 threads);
    `oc_classifier --mode 2c2` on the FLAC eval set with the lane taken,
    forced off, taken (score files equal byte for byte; wall s, utt/s per
    bucket end to end, device-busy share); the 60 s body through
    `oc_server`'s spooled lane, native against Python decode (latency,
    equal scores); a training epoch's input, native against per-item
    (equal batches bit for bit, steps/s). The lane's call counter must
    move wherever the lane is taken and stay at 0 where it is off.
    Returns the kernels' launches (the CLI's and the server's flash
    attention), no graph replays, and the measurements."""
    import concurrent.futures
    import multiprocessing

    import torch

    from occm_tpu_torch import serve_http
    from occm_tpu_torch.classify import scoring
    from occm_tpu_torch.cli import oc_classifier
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.io import native
    from occm_tpu_torch.io.wav import _read_python, write_wav

    t_phase = time.perf_counter()
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    out = {"host_library": dict(HOST_LIB)}
    print(f"[native] host library {HOST_LIB['path']}, built in "
          f"{HOST_LIB['seconds']:.2f} s (phase 2)", flush=True)
    root = os.path.join(workdir, "native")
    os.makedirs(root)
    wav_dir, paths = write_eval_set(root)
    flac_dir = os.path.join(root, "eval_flac")
    os.makedirs(flac_dir)
    utts = open(paths["eval.txt"]).read().split()
    wavs = [os.path.join(wav_dir, u + ".wav") for u in utts]
    flacs = [os.path.join(flac_dir, u + ".flac") for u in utts]
    body_wav, body = (os.path.join(root, f"body.{e}") for e in ("wav",
                                                                 "flac"))
    write_wav(body_wav, synthetic_wave(np.random.default_rng(21),
                                       NATIVE_BODY_SECONDS), SR)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        decoded = list(pool.map(_flac_copy, [(body_wav, body)]
                                + list(zip(wavs, flacs))))
    out["flac_copies_s"] = time.perf_counter() - t0
    whole, python_flac = decoded[0], decoded[1:]

    # ---- bit for bit: whole files, ranges, a stream
    native.reset_counts()
    for path, want in zip([body] + flacs + wavs, decoded + [
            _read_python(p)[0] for p in wavs]):
        if not np.array_equal(native.native_read_wav(path)[0], want):
            fail(f"native reader differs from the Python one on {path}")
    lens, _ = native.native_audio_len_batch(flacs + wavs + [body])
    if list(lens) != [len(w) for w in python_flac] * 2 + [len(whole)]:
        fail(f"native length probes {list(lens)} differ from the decodes")
    for start, count in ((0, 4096), (17 * SR + 5, 3 * SR),
                         (len(whole) - 100, 1000)):
        got, _ = native.native_read_flac_range(body, start, count)
        if not np.array_equal(got, whole[start:start + count]):
            fail(f"native FLAC range [{start}, +{count}) differs")
    wav_whole = _read_python(wavs[-1])[0]
    got, _ = native.native_read_audio_range(wavs[-1], SR + 3, 2 * SR)
    if not np.array_equal(got, wav_whole[SR + 3:3 * SR + 3]):
        fail("native WAV range differs")
    chunks = []
    with native.FlacStream(body) as stream:
        if stream.total_samples != len(whole):
            fail(f"FlacStream total {stream.total_samples} != {len(whole)}")
        while True:
            chunk = stream.read(1 << 16)
            if not len(chunk):
                break
            chunks.append(chunk)
    if not np.array_equal(np.concatenate(chunks), whole):
        fail("FlacStream chunks differ from the whole decode")
    out["bit_for_bit_calls"] = dict(native.CALLS)
    print(f"[native] {len(flacs)} FLAC copies of the eval set and a "
          f"{NATIVE_BODY_SECONDS} s FLAC body ({os.path.getsize(body)} B) "
          f"written and Python-decoded by a process pool in "
          f"{out['flac_copies_s']:.1f} s; native = Python bit for bit on "
          f"every FLAC and WAV, whole, ranged and streamed; length probes "
          f"exact; native calls {dict(native.CALLS)}", flush=True)

    # ---- the two decode lanes
    lanes = {}
    true_mb = sum(len(w) for w in python_flac) * 4 / 1e6
    for kind, files in (("flac", flacs), ("wav", wavs)):
        for n in NATIVE_THREADS:
            s = timed_s(lambda: native.native_read_batch_padded(
                files, max(len(w) for w in python_flac), n_threads=n))
            lanes[f"native {kind}, {n} threads"] = dict(
                files_per_s=len(files) / s, mb_per_s=true_mb / s)
    s = timed_s(lambda: [_read_python(p) for p in wavs])
    lanes["python wav"] = dict(files_per_s=len(wavs) / s,
                               mb_per_s=true_mb / s)
    few = flacs[:4]  # the Python FLAC decoder: the 4 shortest files
    few_mb = sum(len(w) for w in python_flac[:4]) * 4 / 1e6
    s = timed_s(lambda: [_read_python(p) for p in few])
    lanes["python flac"] = dict(files_per_s=len(few) / s,
                                mb_per_s=few_mb / s)
    out["decode_lanes"] = lanes
    print("[native] decode lanes (decoded float32 MB/s): " + "; ".join(
        f"{k} {v['files_per_s']:.1f} files/s, {v['mb_per_s']:.1f} MB/s"
        for k, v in lanes.items()), flush=True)

    # ---- oc_classifier 2c2 on the FLAC eval set: on, off, on
    protocol, train_dir, voc_dir = fixture
    argv = ["--pretrained-sslaasist", ckpt, "--protocol_file", protocol,
            "--dataset_dir", train_dir, "--eval_protocol_file",
            paths["eval.txt"], "--eval_dataset_dir", flac_dir,
            "--mode", "2c2"]
    stamps = []
    embed_for = scoring.BucketedEmbedder._embed_for

    def timed_embed_for(self, blen):
        fn = embed_for(self, blen)

        def run(x):
            t_in = time.perf_counter()
            y = fn(x)
            torch.cuda.synchronize()
            stamps.append((blen, t_in, time.perf_counter()))
            return y

        return run

    in_bucket = {}
    for w in python_flac:
        b = max(16000, -(-len(w) // 16000) * 16000)
        in_bucket[b] = in_bucket.get(b, 0) + 1
    runs, files = [], []
    cwd = os.getcwd()
    os.chdir(root)
    scoring.BucketedEmbedder._embed_for = timed_embed_for
    try:
        for i, lane in enumerate(("on", "off", "on")):
            files.append(os.path.join(root, f"scores_2c2_{i}_{lane}.txt"))
            stamps.clear()
            reset_counts()
            native.reset_counts()

            def cli():
                oc_classifier.main(argv + ["--score_file", files[-1]])

            if lane == "off":
                with _LaneOff():
                    window, busy = device_busy(cli)
            elif i == 0:
                window, busy = timed_s(cli) * 1e3, None
            else:
                window, busy = device_busy(cli)
            calls = dict(native.CALLS)
            if lane == "on" and not (calls.get("read_batch_padded")
                                     and calls.get("audio_len_batch")):
                fail(f"oc_classifier: the native lane was not taken: {calls}")
            c = read_counts()
            counts["flash_attn_fwd"] += c["flash_attn_fwd"]
            per_bucket, prev = {}, None
            for blen, t_in, t_done in stamps:
                n, s = per_bucket.get(blen, (0, 0.0))
                per_bucket[blen] = (n + 1, s + t_done - (prev or t_in))
                prev = t_done
            rates = {b: in_bucket[b] / s
                     for b, (_, s) in sorted(per_bucket.items())}
            runs.append(dict(lane=lane, wall_s=window / 1e3,
                             busy_share=None if busy is None
                             else busy / window, native_calls=calls,
                             flash_attn_fwd=c["flash_attn_fwd"],
                             utt_per_s_by_bucket=rates,
                             profiled=busy is not None))
            print(f"[native] oc_classifier --mode 2c2, lane {lane}: "
                  f"{window / 1e3:.2f} s wall (model load included"
                  f"{', profiled' if busy is not None else ''}), device "
                  f"busy {'-' if busy is None else f'{busy / window:.3f}'}"
                  f" of it, utt/s by bucket end to end "
                  f"{ {b: round(r, 2) for b, r in rates.items()} }, native "
                  f"calls {calls}, flash_attn_fwd {c['flash_attn_fwd']}",
                  flush=True)
    finally:
        scoring.BucketedEmbedder._embed_for = embed_for
        os.chdir(cwd)
    contents = [open(f, "rb").read() for f in files]
    if any(c != contents[0] for c in contents) or not contents[0]:
        fail("oc_classifier 2c2 score files differ between the lanes")
    out["scoring"] = runs

    # ---- the 60 s body through oc_server's spooled lane
    art = os.path.join(root, "artifacts")
    os.makedirs(art)
    np.save(os.path.join(art, "reference_embedding.npy"),
            np.random.default_rng(22).normal(size=160).astype(np.float32))
    np.save(os.path.join(art, "threshold.npy"), np.float32(1.0))
    spool = serve_http.SPOOL_THRESHOLD_BYTES
    serve_http.SPOOL_THRESHOLD_BYTES = NATIVE_SPOOL_BYTES
    data = open(body, "rb").read()
    if len(data) <= NATIVE_SPOOL_BYTES:
        fail(f"the {NATIVE_BODY_SECONDS} s body ({len(data)} B) would not "
             "spool")
    reset_counts()
    served = []
    try:
        with serving(["--pretrained-sslaasist", ckpt, "--artifacts_dir", art,
                      "--host", "127.0.0.1", "--port", "0", "--buckets",
                      "16000"], "server") as started:
            port = started.server.port
            for lane in ("warm-up", "on", "off", "on"):
                native.reset_counts()
                if lane == "off":
                    with _LaneOff():
                        status, payload, ms = post(port, data)
                else:
                    status, payload, ms = post(port, data)
                    if not native.CALLS.get("flac_read"):
                        fail(f"oc_server: the spooled body did not stream "
                             f"through FlacStream: {dict(native.CALLS)}")
                check_response(f"{NATIVE_BODY_SECONDS} s FLAC", status,
                               payload)
                served.append(dict(lane=lane, latency_ms=ms,
                                   score=payload["score"]))
                print(f"[native] oc_server, {NATIVE_BODY_SECONDS} s FLAC "
                      f"body ({len(data)} B, spooled), decode lane {lane}: "
                      f"latency {ms:.1f} ms, score {payload['score']:.6f}",
                      flush=True)
    finally:
        serve_http.SPOOL_THRESHOLD_BYTES = spool
    counts["flash_attn_fwd"] += read_counts()["flash_attn_fwd"]
    if len({r["score"] for r in served}) != 1:
        fail(f"oc_server scores differ between the decode lanes: {served}")
    out["serving"] = served

    # ---- a training epoch's input: native against per-item
    epochs = {}
    for lane in ("on", "off"):
        native.reset_counts()

        def epoch():
            pipe = MetaBatchPipeline(PFDataset(
                protocol, train_dir, voc_dir, cut=TRAIN_CUT, seed=0), seed=0)
            if pipe._native != (lane == "on"):
                fail(f"pipeline native lane {pipe._native}, want {lane}")
            epochs[lane] = list(pipe.epoch(0))

        if lane == "off":
            with _LaneOff():
                s = timed_s(epoch)
        else:
            s = timed_s(epoch)
            if not native.CALLS.get("read_batch_padded"):
                fail(f"pipeline: native lane not taken {dict(native.CALLS)}")
        out[f"pipeline_{lane}_steps_per_s"] = len(epochs[lane]) / s
    same = len(epochs["on"]) == len(epochs["off"]) and all(
        np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        for a, b in zip(epochs["on"], epochs["off"]))
    if not same:
        fail("pipeline: the native epoch's batches differ from per-item's")
    print(f"[native] training input, {len(epochs['on'])} steps of "
          f"[12, {TRAIN_CUT}]: native = per-item bit for bit; "
          f"{out['pipeline_on_steps_per_s']:.1f} against "
          f"{out['pipeline_off_steps_per_s']:.1f} steps/s", flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[native] phase 14 took {out['seconds']:.1f} s", flush=True)
    return counts, {}, out


# ------------------------------- phase 15: the wav2vec2-base frontend

BASE_SCORE_SECONDS = (2, 6, 12)
# Flash attention and the fused FFN against plain attention and the plain
# FFN through base's 12 layers: both bf16, rounding P and the FFN's hidden
# activation at different places (a relative 2^-9 per element per layer,
# SCORE_RTOL's argument over half the layers); the largest |difference| of
# the 768 embedding values held to SCORE_RTOL of the largest |value|.
BASE_EMB_RTOL_OF_MAX = SCORE_RTOL
# The grafted encoder against the in-memory one: every tensor equal bit
# for bit but the positional conv (within FOLD_RTOL), whose bf16 cast can
# then round some hundreds of its 4.7M weights the other way; the features
# stay within 1e-2 of their largest |value|, where a wrong or missing
# tensor moves them by the order of that value.
BASE_GRAFT_RTOL_OF_MAX = 1e-2


def phase_base_kernels():
    """Phase 15's kernel checks: each kernel at base's shapes through phase
    3's harness (attention at H = 12, the FFN at D 768 / F 3072, LayerNorm
    at [3588, 768], Adam over base + AASIST). Returns the rows by kernel."""
    from occm_tpu_torch.config import XLSRConfig

    base = XLSRConfig.base()
    d, f, h = base.encoder_embed_dim, base.encoder_ffn_dim, base.encoder_heads
    return dict(
        flash_attn_fwd=phase_kernels(b=8, h=h, ts=(MAIN_PATH_TS[0],))[0],
        flash_attn_bwd=phase_attention_bwd(h=h, ts=(MAIN_PATH_TS[0],))[0],
        layernorm_bwd=phase_layernorm_bwd(
            shapes=((TRAIN_B * MAIN_PATH_TS[0], d),)),
        fused_adam=phase_fused_adam(base, odd_leaves=False),
        ffn_fwd=phase_ffn(cases=[(FFN_MAIN_M, d, f, False),
                                 (TRAIN_B * MAIN_PATH_TS[0], d, f, False)]))


def phase_base(workdir: str, fixture, kernels: bool = True):
    """Phase 15: the wav2vec2-base frontend at full width and depth:
    AModel(AASISTConfig(), XLSRConfig.base()) with random weights from seed
    0 (its convs' biases zero, as wav2vec2-base's checkpoints have none),
    bf16, every kernel (flash attention, ln_impl and ffn_impl "pallas",
    fused_adam). Scoring at 2, 6 and 12 s, batch 8: flash with the fused
    FFN against xla with the plain FFN, in turns (utt/s, the embeddings'
    largest difference within BASE_EMB_RTOL_OF_MAX); training at 12 x 6 s
    under deterministic algorithms: 3 eager steps against one CUDA graph
    of 3, bit for bit (`remat_steps`); a random base-layout fairseq .pt and
    HF .safetensors, written here, grafted and held to the in-memory
    encoder; then, if `kernels`, each kernel at base's shapes
    (`phase_base_kernels`; a full run does those right after phase 3).
    Returns the kernels' launches, the graph's replayed launches and the
    measurements (the kernel rows under "kernels")."""
    import dataclasses

    import torch

    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.models.convert_xlsr import graft_pretrained_xlsr
    from occm_tpu_torch.models.xlsr import XLSREncoder
    from occm_tpu_torch.serve import make_score_fn

    t_phase = time.perf_counter()
    base = dataclasses.replace(XLSRConfig.base(), ln_impl="pallas",
                               ffn_impl="pallas", attention_impl="flash")
    plain = dataclasses.replace(base, attention_impl="xla", ffn_impl="xla",
                                ln_impl="xla")
    layers = base.encoder_layers
    counts = dict.fromkeys(KERNEL_NAMES, 0)
    replayed = dict.fromkeys(KERNEL_NAMES, 0)

    def add(c, r=None):
        for key in counts:
            counts[key] += c.get(key, 0)
            replayed[key] += (r or {}).get(key, 0)

    with torch.random.fork_rng(devices=[0]), torch.device(DEVICE):
        torch.manual_seed(0)
        model = AModel(AASISTConfig(), base)
    encoder = model.ssl_model.model
    with torch.no_grad():
        for layer in encoder.feature_extractor.conv_layers:
            layer["0"].bias.zero_()
    n_params = sum(p.numel() for p in model.parameters())
    out = {"params": n_params, "encoder_params": sum(
        p.numel() for p in encoder.parameters())}
    print(f"[base] AModel(AASISTConfig(), XLSRConfig.base()): {n_params} "
          f"params ({out['encoder_params']} in the encoder), {layers} "
          f"post-norm layers d={base.encoder_embed_dim} "
          f"ffn={base.encoder_ffn_dim} heads={base.encoder_heads}, "
          f"group-norm extractor, dtype {base.dtype}", flush=True)

    # ---- scoring: flash + fused FFN against xla + plain FFN, in turns
    def fn_for(xcfg, impl):
        score = make_score_fn(model, impl)

        def run(x):
            set_xlsr_cfg(model, xcfg)
            return score(x)

        return run

    fns = {"flash+ffn_pallas": fn_for(base, "flash"),
           "xla": fn_for(plain, "xla")}
    rng = np.random.default_rng(31)
    scoring = {}
    for seconds in BASE_SCORE_SECONDS:
        x = torch.from_numpy(np.stack([synthetic_wave(rng, seconds)
                                       for _ in range(8)])).to(DEVICE)
        reset_counts()
        emb_k = fns["flash+ffn_pallas"](x)[0].float()
        emb_p = fns["xla"](x)[0].float()
        err = float((emb_k - emb_p).abs().max())
        scale = float(emb_p.abs().max())
        if not (math.isfinite(err) and err <= BASE_EMB_RTOL_OF_MAX * scale):
            fail(f"base scoring at {seconds} s: flash + fused FFN against "
                 f"xla: max |difference| {err} > {BASE_EMB_RTOL_OF_MAX} * "
                 f"{scale}")
        rates = utt_per_s(fns, x)
        c = read_counts()
        calls = 2 + 2 * THROUGHPUT_REPS  # the check, a warm-up, the timed
        if (c["flash_attn_fwd"], c["ffn_fwd"]) != (layers * calls,) * 2:
            fail(f"base scoring at {seconds} s: launches {c}, want "
                 f"{layers * calls} flash_attn_fwd and ffn_fwd")
        add(c)
        scoring[seconds] = dict(utt_per_s=rates, max_abs_emb_diff=err,
                                max_abs_emb=scale)
        print(f"[base] scoring {seconds} s, batch 8, utt/s (A B B A): "
              + ", ".join(f"{k} {v:.2f}" for k, v in rates.items())
              + f"; embeddings max |difference| {err:.3e} (bound "
              f"{BASE_EMB_RTOL_OF_MAX} * {scale:.3e}); launches a batch "
              f"{layers} flash_attn_fwd + {layers} ffn_fwd", flush=True)
    out["scoring"] = scoring

    # ---- training: 3 eager steps against one graph of 3
    protocol, train_dir, voc_dir = fixture
    batches = list(MetaBatchPipeline(PFDataset(
        protocol, dataset_dir=train_dir, vocoded_dir=voc_dir, cut=TRAIN_CUT,
        seed=0), seed=0).epoch(0))[:CONTROL_K]
    cfg = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                      descriptiveness_weight=0.9, log_every=1,
                      optimizer="fused_adam", rawboost=RawBoostConfig(algo=0))
    # remat "nothing" reruns the flash forward and the fused FFN
    per_step = {"flash_attn_fwd": 2 * layers, "flash_attn_bwd_dq": layers,
                "flash_attn_bwd_dkv": layers, "layernorm_bwd": 2 * layers,
                "fused_adam": 1, "ffn_fwd": 2 * layers}
    set_xlsr_cfg(model, base)
    init = {n: t.detach().clone() for n, t in model.state_dict().items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        row, _, c, r = remat_steps("base (phase 15)", model, init, cfg,
                                   batches, per_step)
    finally:
        torch.use_deterministic_algorithms(False)
    add(c, r)
    out["train"] = row
    print(f"[base] training 12 x 6 s: graph of 3 = 3 eager steps bit for "
          f"bit; {row['graph_wall_ms']:.2f} ms a step as the graph, busy "
          f"{row['busy']['busy_share']:.3f}, peak {row['peak_gib']:.3f} GiB;"
          f" launches a step {per_step}", flush=True)

    # ---- a base-layout fairseq .pt and HF .safetensors, grafted
    model.load_state_dict(init)
    model.eval()
    sd = {k: v.detach().cpu() for k, v in encoder.state_dict().items()
          if not (k.startswith("feature_extractor.")
                  and k.endswith(".0.bias"))}
    x = torch.from_numpy(np.stack([synthetic_wave(rng, 6.0)
                                   for _ in range(2)])).to(DEVICE)
    with torch.no_grad():
        want = encoder(x).float()
    pos = "encoder.pos_conv.0."
    grafts = {}
    for name, writer, file in (
            ("fairseq .pt", write_fairseq_checkpoint, "wav2vec_small.pt"),
            ("HF .safetensors", write_hf_safetensors, "model.safetensors")):
        path = os.path.join(workdir, file)
        writer(path, sd)
        with torch.device(DEVICE):
            grafted = XLSREncoder(base).eval()
        t0 = time.perf_counter()
        graft_pretrained_xlsr(grafted, path)
        load_s = time.perf_counter() - t0
        got_sd = grafted.state_dict()
        ref_sd = encoder.state_dict()
        differ = [k for k in ref_sd if not k.startswith(pos + "weight_")
                  and not torch.equal(got_sd[k], ref_sd[k])]
        w, w0 = (m.encoder.pos_conv[0].weight.detach().double()
                 for m in (grafted, encoder))
        fold = float(((w - w0).abs() / w0.abs().clamp_min(1e-30)).max())
        with torch.no_grad():
            got = grafted(x).float()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if differ or fold > FOLD_RTOL or not (
                err <= BASE_GRAFT_RTOL_OF_MAX * scale):
            fail(f"base graft {name}: {len(differ)} tensors differ "
                 f"({differ[:3]}), positional conv {fold} (bound "
                 f"{FOLD_RTOL}), features {err} (bound "
                 f"{BASE_GRAFT_RTOL_OF_MAX} * {scale})")
        grafts[name] = dict(bytes=os.path.getsize(path), load_s=load_s,
                            fold_rel_err=fold, max_abs_feature_diff=err)
        print(f"[base] graft {name} ({os.path.getsize(path) / 2**20:.0f} "
              f"MiB, no conv biases): {load_s:.2f} s, every tensor equal "
              f"bit for bit but the positional conv ({fold:.2e} of the "
              f"fold, bound {FOLD_RTOL:.2e}); features max |difference| "
              f"{err:.3e} (bound {BASE_GRAFT_RTOL_OF_MAX} * {scale:.3e})",
              flush=True)
        os.remove(path)
        del grafted
    out["graft"] = grafts
    del model, encoder, init, want
    gc.collect()
    torch.cuda.empty_cache()

    if kernels:
        out["kernels"] = phase_base_kernels()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[base] phase 15 took {out['seconds']:.1f} s", flush=True)
    return counts, replayed, out


# ---------------------------------------------------------------- phase 16

PEAK_INT8_OPS = 1979e12  # H100 SXM, dense int8 TOP/s at 700 W
# Rows of the int8 products on the main path: 8 utterances of the 2, 6 and
# 12 s buckets (99, 299 and 599 frames); 8 rows, which the wrapper pads to
# 32 (torch._int_mm takes more than 16); one 6 s utterance alone (299, not
# a multiple of 8).
INT8_MS = (8, 299, 8 * 99, 8 * 299, 8 * 599)
# (K, N) of XLS-R's q/k/v/out_proj, fc1 and fc2, then wav2vec2-base's
INT8_KN = ((1024, 1024), (1024, 4096), (4096, 1024), (768, 768),
           (768, 3072), (3072, 768))
INT8_SECONDS = (2, 6, 12)
# The int8 encoder against the bf16 one at the same weights: the JAX
# suite's own bounds for its W8A8 path (tests/test_int8.py:88-93).
INT8_COSINE = 0.99
INT8_REL_L2 = 0.15
INT8_ITERS = 10


def int8_bound(m: int, k: int, n: int):
    """Least time of one int8_matmul on an H100: (bound_ms, bound_by). 2MKN
    int8 operations; x [M, K] bf16 read once, w_q [K, N] int8, scale and
    bias [N] bf16 (the mirror's) read once, y [M, N] bf16 written once."""
    ops = 2.0 * m * k * n
    nbytes = 2.0 * m * k + k * n + 2.0 * 2 * n + 2.0 * m * n
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_int8_kernels():
    """Phase 16's product checks, beside phase 3's (profiler sessions late
    in a run lose records): `int8_matmul` against `int8_matmul_reference`
    on the card (its int32 product an fp64 GEMM of the int8 values, exact)
    at every main-path shape: x_q, the int32 accumulator and y equal bit
    for bit. Per shape: the wrapper's ms (CUDA events), its device ms and
    launches and those of the int8 GEMM alone (torch.profiler), the bound,
    and the bf16 F.linear at the same shape. Not a kernel of the port: the
    JAX package computes the product with lax.dot_general."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops import int8

    t0 = time.perf_counter()
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(16)
    for k, n in INT8_KN:
        w = torch.randn(n, k, device="cuda", generator=gen) / math.sqrt(k)
        w_q, scale = int8.quantize_weight_int8(w)
        scale = scale.to(torch.bfloat16)
        bias = (0.02 * torch.randn(n, device="cuda", generator=gen)).to(
            torch.bfloat16)
        w_bf16 = w.to(torch.bfloat16)
        for m in INT8_MS:
            x = torch.randn(m, k, device="cuda", generator=gen).to(
                torch.bfloat16)
            y, x_q, acc = int8.int8_matmul(x, w_q, scale, bias,
                                           torch.bfloat16, parts=True)
            y0, x_q0, acc0 = int8.int8_matmul_reference(
                x, w_q, scale, bias, torch.bfloat16, parts=True)
            torch.cuda.synchronize()
            if not (torch.equal(x_q, x_q0) and torch.equal(acc, acc0)
                    and torch.equal(y, y0)):
                fail(f"int8_matmul [{m}, {k}] x [{k}, {n}]: x_q equal "
                     f"{torch.equal(x_q, x_q0)}, acc equal "
                     f"{torch.equal(acc, acc0)} (max |diff| "
                     f"{int((acc - acc0).abs().max())}), y equal "
                     f"{torch.equal(y, y0)}")
            wrapper = lambda: int8.int8_matmul(x, w_q, scale, bias,
                                               torch.bfloat16)
            gemm = lambda: int8.int8_mm(x_q, w_q)
            linear = lambda: F.linear(x, w_bf16, bias)
            ms = cuda_ms(wrapper, INT8_ITERS)
            dev_ms, dev_launches = calls_device_ms(wrapper, INT8_ITERS)
            gemm_ms, gemm_launches = calls_device_ms(gemm, INT8_ITERS)
            bound, bound_by = int8_bound(m, k, n)
            row = dict(m=m, k=k, n=n, ms=ms, device_ms=dev_ms,
                       device_launches=dev_launches, gemm_device_ms=gemm_ms,
                       gemm_launches=gemm_launches, bound_ms=bound,
                       bound_by=bound_by, bf16_linear_ms=cuda_ms(
                           linear, INT8_ITERS), bit_equal=True)
            rows.append(row)
            print(f"[int8] int8_matmul [{m}, {k}] x [{k}, {n}] bf16 in/out: "
                  f"x_q, acc, y equal to the plain version bit for bit; "
                  f"wrapper {ms:.4f} ms, device {dev_ms:.4f} ms "
                  f"({dev_launches:g} launches), int8 GEMM alone "
                  f"{gemm_ms:.4f} ms ({gemm_launches:g} launches); bound "
                  f"{bound:.4f} ms ({bound_by}); bf16 F.linear "
                  f"{row['bf16_linear_ms']:.4f} ms", flush=True)
    print(f"[int8] {len(rows)} products checked and timed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def write_la_tree(root: str, seed: int = 3):
    """A tiny ASVspoof2019-LA layout (train / dev flac dirs of WAVs, cm
    protocols) with separable audio, as the JAX gate's test writes it:
    12 bonafide harmonic tones and 6 noise bursts to train on (the tones'
    5 vocoded copies beside), 8 + 8 dev utterances."""
    from occm_tpu_torch.io.wav import write_wav

    dirs = {name: os.path.join(root, *parts) for name, parts in (
        ("train", ("ASVspoof2019_LA_train", "flac")),
        ("dev", ("ASVspoof2019_LA_dev", "flac")),
        ("proto", ("ASVspoof2019_LA_cm_protocols",)),
        ("vocoded", ("vocoded",)))}
    for d in dirs.values():
        os.makedirs(d)
    rng = np.random.default_rng(seed)

    def bona(i, n=3000):
        t = np.arange(n) / SR
        f0 = 180 + 15 * i
        return (0.25 * np.sin(2 * np.pi * f0 * t)
                + 0.12 * np.sin(4 * np.pi * f0 * t)
                + 0.06 * np.sin(6 * np.pi * f0 * t)).astype(np.float32)

    def spoof(n=3000):
        env = np.repeat((rng.uniform(size=n // 100 + 1) > 0.4), 100)[:n]
        return (0.25 * rng.normal(size=n) * (0.4 + 0.6 * env)).astype(
            np.float32)

    train, dev = [], []
    for i in range(12):
        utt = f"LA_T_b{i:04d}"
        w = bona(i)
        write_wav(os.path.join(dirs["train"], utt + ".wav"), w, SR)
        train.append(f"LA_{i:04d} {utt} - - bonafide")
        for voc in VOCODERS:
            write_wav(os.path.join(dirs["vocoded"], f"{voc}_{utt}.wav"),
                      w + 0.15 * rng.normal(size=w.shape), SR)
    for i in range(6):
        utt = f"LA_T_s{i:04d}"
        write_wav(os.path.join(dirs["train"], utt + ".wav"), spoof(), SR)
        train.append(f"LA_{100 + i:04d} {utt} - A0{i} spoof")
    for i in range(8):
        for kind, wave, label, base in (("b", bona(20 + i, 3100),
                                         "bonafide", 200),
                                        ("s", spoof(3100), "spoof", 300)):
            utt = f"LA_D_{kind}{i:04d}"
            write_wav(os.path.join(dirs["dev"], utt + ".wav"), wave, SR)
            dev.append(f"LA_{base + i:04d} {utt} - "
                       f"{'-' if kind == 'b' else f'A0{i % 6}'} {label}")
    for name, lines in (("ASVspoof2019.LA.cm.train.trn.txt", train),
                        ("ASVspoof2019.LA.cm.dev.trl.txt", dev)):
        with open(os.path.join(dirs["proto"], name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return dirs["vocoded"]


def phase_int8(workdir: str, fixture, ckpt: str):
    """Phase 16: W8A8 int8 scoring and serving at full width (XLS-R 300M +
    AASIST, random weights from seed 0, under --fast_numerics), through
    the CLIs. `oc_classifier --mode 2c2 --quant_int8 --fast_numerics` on
    phase 4's eval set beside the same call without --quant_int8 (24
    flash_attn_fwd launches and 144 int8_matmul calls a batch, exact); the
    encoder outputs of one batch, int8 against bf16, within the JAX
    suite's bounds; utt/s at batch 8 for 2, 6 and 12 s, int8 against bf16
    in turns; `oc_server --quant_int8 --fast_numerics` answering 4, 6 and
    12 s requests, held to the classifier's int8 path on the same audio;
    the refusal of --quant_int8 without --fast_numerics before any weights
    load; `parity_gate --xlsr_tiny` end to end on a tiny fairseq .pt and
    an LA-layout tree this writes. Returns (launches, result)."""
    import torch

    from occm_tpu_torch.audio import pad_numpy
    from occm_tpu_torch.classify import (
        BucketedEmbedder, OneClassScorer, make_embed_fn_factory)
    from occm_tpu_torch.classify.impl_select import select_attention_impl
    from occm_tpu_torch.cli import oc_classifier, oc_server
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.data import ASVDataset
    from occm_tpu_torch.io.wav import load_audio
    from occm_tpu_torch.ops import attention, int8
    from occm_tpu_torch.serve import make_score_fn
    from occm_tpu_torch.utils import random_init_

    t_phase = time.perf_counter()
    layers = XLSRConfig().encoder_layers
    per_batch = {"flash_attn_fwd": layers, "int8_matmul": 6 * layers}
    out = {}
    launches = 0
    root = os.path.join(workdir, "int8")
    os.makedirs(root)
    eval_dir, paths = write_eval_set(root)
    eval_lens = [len(load_audio(p)[0]) for p in ASVDataset(
        paths["eval.txt"], eval_dir, eval=True).file_paths()]
    n_batches = sum(-(-c // 8) for c in np.unique(
        [max(16000, -(-n // 16000) * 16000) for n in eval_lens],
        return_counts=True)[1])
    flash = flash_batches(eval_lens)

    # ---- oc_classifier 2c2: bf16 (--fast_numerics), then int8
    protocol, train_dir, _ = fixture
    argv = ["--pretrained-sslaasist", ckpt, "--protocol_file", protocol,
            "--dataset_dir", train_dir, "--eval_protocol_file",
            paths["eval.txt"], "--eval_dataset_dir", eval_dir, "--mode",
            "2c2", "--fast_numerics"]
    logits = {}
    for tag, extra in (("bf16", []), ("int8", ["--quant_int8"])):
        score_file = os.path.join(root, f"scores_{tag}.txt")
        reset_counts()
        int8.CALLS = 0
        t0 = time.perf_counter()
        oc_classifier.main(argv + ["--score_file", score_file] + extra)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {"flash_attn_fwd": attention.LAUNCHES,
               "int8_matmul": int8.CALLS}
        want = {"flash_attn_fwd": per_batch["flash_attn_fwd"] * flash,
                "int8_matmul": per_batch["int8_matmul"] * n_batches
                if extra else 0}
        if got != want:
            fail(f"oc_classifier 2c2 {tag}: counts {got}, want {want} "
                 f"({n_batches} batches, {flash} through flash)")
        launches += got["flash_attn_fwd"]
        logits[tag] = np.loadtxt(score_file)
        if logits[tag].shape != (len(eval_lens),) or not np.isfinite(
                logits[tag]).all():
            fail(f"oc_classifier 2c2 {tag}: logits {logits[tag]}")
        out[f"classifier_2c2_{tag}"] = dict(wall_s=wall, counts=got)
        print(f"[int8] oc_classifier --mode 2c2 --fast_numerics "
              f"{' '.join(extra)}: {wall:.1f} s (model load included), "
              f"{n_batches} batches ({flash} flash), counts {got}",
              flush=True)
    out["logits_max_abs_diff"] = float(np.abs(logits["int8"]
                                              - logits["bf16"]).max())
    print(f"[int8] 2c2 logits int8 {np.round(logits['int8'], 4).tolist()}; "
          f"bf16 {np.round(logits['bf16'], 4).tolist()}", flush=True)

    # ---- the models the CLIs build, for the encoder gate and utt/s
    models = {tag: oc_server.build_model(
        oc_server.xlsr_config(False, True, tag == "int8"), ckpt, False,
        "cuda") for tag in ("bf16", "int8")}
    rng = np.random.default_rng(16)
    x = torch.from_numpy(np.stack([pad_numpy(synthetic_wave(rng, 6.0),
                                             96000) for _ in range(8)])).to(
        "cuda")
    with torch.inference_mode():
        feats = {tag: m.ssl_model(x, "flash").float()
                 for tag, m in models.items()}
    a, b = feats["int8"].flatten(), feats["bf16"].flatten()
    cos = float(a @ b / (a.norm() * b.norm()))
    rel = float((a - b).norm() / b.norm())
    out["encoder"] = dict(cosine=cos, rel_l2=rel, batch="8 x 6 s")
    print(f"[int8] encoder outputs, one batch of 8 x 6 s, int8 vs bf16 "
          f"(fast numerics, flash): cosine {cos:.6f} (bound >= "
          f"{INT8_COSINE}), relative L2 {rel:.5f} (bound <= {INT8_REL_L2})",
          flush=True)
    if not (cos >= INT8_COSINE and rel <= INT8_REL_L2):
        fail(f"int8 encoder outputs: cosine {cos}, relative L2 {rel}")
    rows = []
    for sec in INT8_SECONDS:
        bucket = sec * SR
        xb = torch.from_numpy(np.stack([pad_numpy(
            synthetic_wave(rng, sec), bucket) for _ in range(8)])).to("cuda")
        impl = select_attention_impl(bucket)
        row = dict(seconds=sec, impl=impl, **utt_per_s(
            {tag: make_score_fn(m, impl) for tag, m in models.items()}, xb))
        rows.append(row)
        print(f"[int8] scoring utt/s, batch 8, {sec} s ({impl}): int8 "
              f"{row['int8']:.2f}, bf16 {row['bf16']:.2f}", flush=True)
    out["utt_per_s"] = rows
    int8_model = models.pop("int8")
    del models, feats, a, b
    torch.cuda.empty_cache()

    # ---- oc_server --quant_int8 --fast_numerics
    art = os.path.join(root, "artifacts")
    os.makedirs(art)
    reference = np.random.default_rng(5).normal(size=160).astype(np.float32)
    np.save(os.path.join(art, "reference_embedding.npy"), reference)
    np.save(os.path.join(art, "threshold.npy"), np.float32(10.0))
    buckets = (16000, 64000, 96000, 192000)  # oc_classifier's bucket_step
    reset_counts()
    int8.CALLS = 0
    with serving(["--pretrained-sslaasist", ckpt, "--artifacts_dir", art,
                  "--host", "127.0.0.1", "--port", "0", "--quant_int8",
                  "--fast_numerics", "--max_wait_ms", "5", "--buckets",
                  *map(str, buckets)], "int8 server") as started:
        warm = {"flash_attn_fwd": attention.LAUNCHES,
                "int8_matmul": int8.CALLS}
        want_warm = {k: v * len(buckets) if k == "int8_matmul" else
                     v * sum(select_attention_impl(b) == "flash"
                             for b in buckets) for k, v in per_batch.items()}
        if warm != want_warm:
            fail(f"int8 server warmup counts {warm}, want {want_warm}")
        waves = [synthetic_wave(rng, s) for s in (4.0, 6.0, 12.0)]
        served = []
        for w in waves:
            before = (attention.LAUNCHES, int8.CALLS)
            status, payload, ms = post(started.server.port,
                                       w.astype("<f4").tobytes(),
                                       {"X-Sample-Rate": "16000"})
            check_response(f"int8 {len(w) / SR:.0f} s", status, payload)
            got = {"flash_attn_fwd": attention.LAUNCHES - before[0],
                   "int8_matmul": int8.CALLS - before[1]}
            if got != per_batch:
                fail(f"int8 server request of {len(w)} samples: counts "
                     f"{got}, want {per_batch}")
            served.append(payload["score"])
            print(f"[int8] oc_server --quant_int8 --fast_numerics: "
                  f"{len(w) / SR:.0f} s raw PCM, score "
                  f"{payload['score']:.6f}, latency {ms:.1f} ms, counts "
                  f"{got}", flush=True)
        launches += attention.LAUNCHES
    # the classifier's int8 path on the same audio: BucketedEmbedder's
    # buckets (bucket_step 16000) are the server's, and each wave is alone
    # in its bucket, the row of a zero-padded batch of 8 on both sides, so
    # the same weights see the same inputs: the scores should agree bit
    # for bit, and a library kernel picked anew could only reorder fp32
    # sums, whose flipped int8 roundings travel as SCORE_RTOL's argument
    # says
    emb, _ = BucketedEmbedder(embed_fn_factory=make_embed_fn_factory(
        int8_model), bucket_step=16000, batch_size=8,
        device="cuda").embed_all(waves)
    direct = OneClassScorer._distances(emb, reference)
    rel = np.abs(np.asarray(served) - direct) / np.abs(direct)
    out["server"] = dict(scores=served, classifier=direct.tolist(),
                         max_rel_diff=float(rel.max()),
                         bit_equal=bool(np.array_equal(served, direct)))
    print(f"[int8] server scores vs the classifier's int8 path: max rel "
          f"diff {rel.max():.3e} (bound {SCORE_RTOL}), bit for bit "
          f"{out['server']['bit_equal']}", flush=True)
    if not rel.max() <= SCORE_RTOL:
        fail(f"int8 server and classifier scores disagree: {rel}")
    del int8_model
    torch.cuda.empty_cache()

    # ---- the refusal, before any weights load
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "occm_tpu_torch.cli.oc_classifier",
         "--quant_int8", "--score_file", os.path.join(root, "refused.txt")]
        + [a for a in argv if a != "--fast_numerics"],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    last = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
    if (proc.returncode == 0 or "ValueError" not in last
            or "--fast_numerics" not in last
            or "weights loaded" in proc.stdout):
        fail(f"--quant_int8 without --fast_numerics: rc {proc.returncode}, "
             f"stdout {proc.stdout[-300:]!r}, stderr {last!r}")
    out["refusal"] = dict(rc=proc.returncode, message=last,
                          seconds=time.perf_counter() - t0)
    print(f"[int8] --quant_int8 without --fast_numerics exits "
          f"{proc.returncode} before any weights load: {last}", flush=True)

    # ---- parity_gate --xlsr_tiny on a tiny fairseq .pt and an LA tree
    from occm_tpu_torch.cli import parity_gate
    from occm_tpu_torch.models import XLSREncoder

    la = os.path.join(root, "LA")
    vocoded = write_la_tree(la)
    xlsr_pt = os.path.join(root, "xlsr2_tiny.pt")
    torch.save({"model": random_init_(XLSREncoder(XLSRConfig.tiny()),
                                      seed=5).state_dict()}, xlsr_pt)
    t0 = time.perf_counter()
    cwd = os.getcwd()
    os.chdir(root)  # oc_classifier's 1c artefacts land here
    try:
        rc = parity_gate.main([
            "--xlsr", xlsr_pt, "--la", la, "--vocoded_dir", vocoded,
            "--workdir", os.path.join(root, "gate"), "--xlsr_tiny",
            "--epochs", "2", "--lr", "1e-3", "--cut", "3200",
            "--groups_per_step", "4", "--compactness_weight", "0.1",
            "--descriptiveness_weight", "0.9", "--batch_size", "4",
            "--bucket_step", "3200", "--int8_gate", "0.25"])
    finally:
        os.chdir(cwd)
    out["parity_gate"] = dict(rc=rc, seconds=time.perf_counter() - t0)
    print(f"[int8] parity_gate --xlsr_tiny on the card: rc {rc} in "
          f"{out['parity_gate']['seconds']:.1f} s", flush=True)
    if rc != 0:
        fail(f"parity_gate exited {rc}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[int8] phase 16 took {out['seconds']:.1f} s", flush=True)
    return launches, out


# ------------------------------------------------------- optional profile

def _kernel_class(name: str) -> str:
    n = name.lower()
    for k in ("flash_attn_fwd", "flash_attn_bwd", "layernorm_bwd",
              "fused_adam"):
        if k in n:
            return f"{k} (this port)"
    if "ffn_gemm_kernel" in n:  # the FFN's two launches
        return "ffn_fwd (this port)"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(s in n for s in ("conv", "cudnn", "implicit", "dgrad", "wgrad")):
        return "conv (cuDNN)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90")):
        return "matmul (cuBLAS)"
    if "layer_norm" in n:
        return "layer_norm"
    if "copy_kernel" in n:
        return "dtype casts and layout copies"
    return "other elementwise and reductions"


def report_profile(prof, window_us: float, n: int, label: str):
    """Device time by kernel class and the top kernels, per run of `n`,
    from torch.profiler's CUDA events, with the busy share of the host's
    window."""
    import torch

    by_name, by_class, events = {}, {}, 0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        events += 1
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy = sum(by_name.values())
    if busy <= 0:
        fail("profile: torch.profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    print(f"[profile] {label}, {n} runs: host window "
          f"{window_us / n / 1e3:.3f} ms/run, device busy "
          f"{busy / n / 1e3:.3f} ms/run ({busy / window_us:.3f} of the "
          f"window), {events / n:.1f} device launches/run", flush=True)
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"[profile]   {cls}: {us / n / 1e3:.3f} ms/run "
              f"({us / busy:.3f} of device time)", flush=True)
    for name, us in top:
        print(f"[profile]     {us / n / 1e3:9.3f} ms  {name[:110]}",
              flush=True)


def phase_profile(model, reference: np.ndarray, ckpt: str,
                  batches: int = 3):
    """Device time by kernel for full batches of 8 in the two flash
    buckets, through ScoringService as the server runs them, and for a
    6 s batch with ffn_impl="pallas" (the scoring phase's kernel path)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occm_tpu_torch.cli.oc_server import build_model
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.serve import ScoringService, make_score_fn

    pallas = build_model(XLSRConfig(ffn_impl="pallas"), ckpt, False, "cuda")
    rng = np.random.default_rng(1)
    for seconds, bucket, m, label in (
            (6.0, 96000, model, ""), (12.0, 192000, model, ""),
            (6.0, 96000, pallas, ', ffn_impl="pallas"')):
        svc = ScoringService(score_fn=make_score_fn(m, "flash"),
                             reference_embedding=reference, threshold=0.0,
                             buckets=(bucket,), batch=8, device="cuda")
        waves = [synthetic_wave(rng, seconds) for _ in range(8)]
        svc.score(waves)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(batches):
                svc.score(waves)
            torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
        report_profile(prof, window_us, batches,
                       f"scoring bucket {bucket} ({seconds:.0f} s), batch 8"
                       + label)
    del pallas
    torch.cuda.empty_cache()


# ------------------------------------------- multi-GPU paths (phase 17)

# dp=2, fsdp=2, tp=2, tp=2 with sequence parallelism and the pp=2 GPipe
# pipeline over two ranks sharing cuda:0 (Gloo: NCCL refuses two ranks of
# one communicator on one device)
PAR_MESHES = {"dp2": dict(dp=2), "fsdp2": dict(dp=1, fsdp=2),
              "tp2": dict(dp=1, tp=2), "tp2sp": dict(dp=1, tp=2),
              "pp2": dict(dp=1, pp=2), "pp2s4": dict(dp=1, pp=2)}
PP_STAGES, PP_M = 2, 4  # pp=2 with 4 microbatches of 3 rows
PP_S4 = 4  # pp2s4: 4 stages of 3 layers on the 2 ranks, two each
#: each mode's XLSRConfig fields beside parallel_configs()'
PAR_XLSR = {"tp2sp": dict(seq_parallel=True),
            "pp2": dict(pp_stages=PP_STAGES, pp_microbatches=PP_M),
            "pp2s4": dict(pp_stages=PP_S4, pp_microbatches=PP_M)}
#: the steps a mode takes (PAR_STEPS unless named): tp=2 with sequence
#: parallelism is held to tp=2's encoder, its one step to the launches;
#: pp2s4 to the one process's step at pp_stages 4
PAR_MODE_STEPS = {"tp2sp": 1, "pp2s4": 1}
PAR_STEPS = 2
PAR_LR = 1e-5
# the rank processes' limit: they take about 120 s on an H100, and a
# deadlocked rank must fail the run, with its log, inside the run's limit
PAR_TIMEOUT_S = 300
XLSR_HEADS, XLSR_FFN = 16, 4096  # XLSRConfig()'s; tp=2 halves both


def parallel_configs():
    """Phase 17's model and training configs: full width at PAR_DEPTH
    layers, every kernel (flash attention, the fused FFN, the LayerNorm
    backward, fused_adam), AASIST's dropouts on (their masks are drawn for
    the global batch)."""
    from occm_tpu_torch.config import (
        AASISTConfig, RawBoostConfig, TrainConfig, XLSRConfig)

    xcfg = at_depth(XLSRConfig(ln_impl="pallas", ffn_impl="pallas",
                               attention_impl="flash"), PAR_DEPTH)
    cfg = TrainConfig(optimizer="fused_adam", lr=PAR_LR, cut=TRAIN_CUT,
                      compactness_weight=0.1, descriptiveness_weight=0.9,
                      rawboost=RawBoostConfig(algo=0))
    return AASISTConfig(), xcfg, cfg


def _flat(tensors) -> "object":
    import torch

    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _ckpt_flat(payload, names):
    """A checkpoint's parameters and Adam first moments, flat in `names`'
    order (the positional conv's state-dict v is its trained w)."""
    model = payload["model"]
    w = _flat(model[n[:-len("weight")] + "weight_v"]
              if n.endswith("pos_conv.0.weight") else model[n] for n in names)
    return w, _flat(payload["optimizer"]["mu"][n] for n in names)


def parallel_single(init, batches, workdir=None, xlsr=None):
    """The single-process eager steps from `init`: step 1 on batches[0],
    its state saved as a one-GPU checkpoint (`par_step1_0.pt` in
    `workdir`, when given), then step 2 on batches[1] (if given).
    `xlsr`: XLSRConfig fields beside parallel_configs()' (the pipeline's,
    run in one process). Returns the steps (loss, ms, launches), the
    parameter names, and the parameters and Adam first moments after the
    last step, flat in parameter order."""
    import torch

    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.train import create_train_state, train_step
    from occm_tpu_torch.train.checkpoint import save_checkpoint

    acfg, xcfg, cfg = parallel_configs()
    xcfg = dataclasses.replace(xcfg, **(xlsr or {}))
    with torch.device("cuda"):  # built on the card: no CPU init pass
        model = AModel(acfg, xcfg)
    model.load_state_dict(init)
    state = create_train_state(model, cfg)
    steps = []
    for i, (x, labels) in enumerate(batches):
        xs = torch.from_numpy(x).to("cuda")
        ls = torch.from_numpy(labels).long().to("cuda")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = train_step(state, xs, ls, cfg)
        torch.cuda.synchronize()
        steps.append(dict(loss=float(m["loss"]),
                          ms=(time.perf_counter() - t0) * 1e3,
                          launches=read_counts()))
        if i == 0 and workdir is not None:
            save_checkpoint(state, workdir, "par_step1", 0)
    names = [n for n, _ in state.named_params()]
    w = _flat(p for _, p in state.named_params())
    mu = _flat(state.optimizer.mu)
    del state, model
    torch.cuda.empty_cache()
    return steps, names, w, mu


def encoder_reference(init, batch, workdir: str) -> dict:
    """The single process's XLSR encoder at `init` on the first global
    batch (train mode): its features, the gradient of the step's loss
    with respect to them, and the encoder's parameter gradient from that
    upstream gradient (saved as `par_enc.pt` for the tp ranks). Also the
    loss's sensitivity to its features: the loss on features moved by one
    bf16 rounding (relative noise 2^-8), four draws."""
    import torch

    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel

    acfg, xcfg, cfg = parallel_configs()
    with torch.device("cuda"):
        model = AModel(acfg, xcfg)
    model.load_state_dict(init)
    model.train()
    x = torch.from_numpy(batch[0]).to("cuda")
    labels = torch.from_numpy(batch[1]).long().to("cuda")

    def loss_of(feats):
        gen = torch.Generator(device="cuda").manual_seed(0)
        emb, logits = model.backend(feats, generator=gen)
        return group_one_class_loss(emb, logits, labels,
                                    cfg.compactness_weight,
                                    cfg.descriptiveness_weight)[0]

    feats = model.ssl_model(x)
    loss = loss_of(feats)
    (up,) = torch.autograd.grad(loss, feats, retain_graph=True)
    feats.backward(up)
    names = [n for n, _ in model.named_parameters()
             if n.startswith("ssl_model.")]
    params = dict(model.named_parameters())
    grad = _flat(params[n].grad for n in names)
    gen = torch.Generator(device="cuda").manual_seed(1)
    with torch.no_grad():
        moved = [float(loss_of(feats * (1 + 2.0 ** -8 * torch.randn(
            feats.shape, generator=gen, device="cuda")))) for _ in range(4)]
    torch.save({"f": feats.detach().cpu(), "up": up.cpu(),
                "g": grad.cpu(), "names": names},
               os.path.join(workdir, "par_enc.pt"))
    out = dict(loss=float(loss), moved=moved,
               loss_spread=max(abs(m - float(loss)) for m in moved))
    del model, feats, up, grad, params
    torch.cuda.empty_cache()
    return out


def encoder_check(state, mesh, batch, workdir: str, rank: int, dev,
                  against=None):
    """The tp ranks' XLSR encoder at the init weights on the whole first
    batch: its features, and its parameter gradient (the tp shards
    gathered) from the single process's upstream gradient, against the
    single process's (rank 0 returns the relative L2 differences, and the
    features and gradient under "_f" / "_g"); `against`: another mode's
    (features, gradient), held to as well (relative L2, largest
    difference)."""
    import torch

    from occm_tpu_torch.parallel import compute_mesh
    from occm_tpu_torch.parallel.collectives import all_reduce_
    from occm_tpu_torch.parallel.sharding import gather_full

    ref = torch.load(os.path.join(workdir, "par_enc.pt"), weights_only=True,
                     mmap=True)
    model = state.model.train()
    x = torch.from_numpy(batch[0]).to(dev)
    with compute_mesh(mesh):
        feats = model.ssl_model(x)
        feats.backward(ref["up"].to(dev))
    params = dict(state.named_params())
    grads = []
    for n in ref["names"]:
        g = params[n].grad
        pl = state.placements.get(n)
        if pl is not None and pl.tp_dim is not None:
            g = gather_full(g, pl, mesh, axes=("tp",))
        if pl is not None and pl.tp_sum:
            # under sequence parallelism a rank's share of the frames
            g = all_reduce_(g.clone(), mesh.group("tp"))
        grads.append(g)
    for p in params.values():
        p.grad = None
    if rank != 0:
        return None
    grad, want = _flat(grads), ref["g"].to(dev)
    f, f_ref = feats.detach().float(), ref["f"].to(dev)
    out = dict(feats_rel_l2=float((f - f_ref).norm() / f_ref.norm()),
               grad_rel_l2=float((grad - want).norm() / want.norm()))
    if against is not None:
        f_o, g_o = against
        out.update(
            feats_vs_rel_l2=float((f - f_o).norm() / f_o.norm()),
            feats_vs_max_abs=float((f - f_o).abs().max()),
            grad_vs_rel_l2=float((grad - g_o).norm() / g_o.norm()),
            grad_vs_max_abs=float((grad - g_o).abs().max()))
    out["_f"], out["_g"] = f, grad
    return out


def _shape_recorder():
    """Wrap the flash forward, ffn_fwd and LayerNorm backward wrappers to
    record the shapes they launch on (the rank's heads and FFN columns
    under tp, its microbatch under pp, its frames under sp)."""
    from occm_tpu_torch.ops import attention, ffn, layernorm

    shapes = {"flash_attn_fwd": set(), "ffn_fwd": set(),
              "layernorm_bwd": set()}
    fwd, ffn_fwd = attention.flash_attention_fwd, ffn.ffn_fwd
    ln_bwd = layernorm.layer_norm_bwd

    def flash(q, k, v, t_valid):
        shapes["flash_attn_fwd"].add(tuple(q.shape))
        return fwd(q, k, v, t_valid)

    def fused(x, w1, b1, w2, b2, approximate):
        shapes["ffn_fwd"].add((x.shape[0], w1.shape[0], w1.shape[1]))
        return ffn_fwd(x, w1, b1, w2, b2, approximate)

    def layer_norm(x, gamma, g, eps):
        shapes["layernorm_bwd"].add(tuple(x.shape))
        return ln_bwd(x, gamma, g, eps)

    attention.flash_attention_fwd = flash
    ffn.ffn_fwd = fused
    layernorm.layer_norm_bwd = layer_norm
    return shapes


def parallel_rank(rank: int, world: int, port: int, workdir: str) -> int:
    """One rank of phase 17 (a process of its own, on cuda:0, Gloo): for
    each mesh of PAR_MESHES, the state placed from the same init (the
    mode's XLSRConfig fields, PAR_XLSR), step 1 on its rows of the first
    global batch; then (PAR_STEPS) the single process's state after step
    1 restored from its one-GPU checkpoint into the placed state, and
    step 2 on its rows of the second batch. Rank 0 gathers the state
    after each step and compares it with the single process's, and
    writes every rank's record: step ms, launches, the kernels' shapes,
    the peak memory of step 1 and the bytes held."""
    import torch
    import torch.distributed as dist

    from occm_tpu_torch.config import MeshConfig
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.parallel import make_mesh, multihost
    from occm_tpu_torch.parallel.sharding import (
        full_optimizer_state, full_parameters, held_bytes,
        place_state_on_mesh, placement_table, shard_batch)
    from occm_tpu_torch.train import create_train_state, train_step
    from occm_tpu_torch.train.checkpoint import restore_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    dev = multihost.initialize("cuda:0", f"tcp://127.0.0.1:{port}", world,
                               rank, backend="gloo")
    init = torch.load(os.path.join(workdir, "par_init.pt"),
                      weights_only=True)
    data = np.load(os.path.join(workdir, "par_batches.npz"))
    batches = [(data[f"x{i}"], data[f"l{i}"]) for i in range(PAR_STEPS)]
    refs = None
    shapes = _shape_recorder()
    acfg, xcfg, cfg = parallel_configs()
    records = {}
    tp2_encoder = None
    for mode, axes in PAR_MESHES.items():
        mesh = make_mesh(MeshConfig(**axes))
        mode_xcfg = dataclasses.replace(xcfg, **PAR_XLSR.get(mode, {}))
        with torch.device(dev):  # built on the card: no CPU init pass
            model = AModel(acfg, mode_xcfg)
        model.load_state_dict(init)
        state = create_train_state(model, cfg)
        place_state_on_mesh(state, mesh)
        names = [n for n, _ in state.named_params()]
        if rank == 0 and refs is None:
            ck = torch.load(os.path.join(workdir, "par_step1_0.pt"),
                            weights_only=True, mmap=True)
            fin = torch.load(os.path.join(workdir, "par_ref.pt"),
                             weights_only=True, mmap=True)
            refs = [_ckpt_flat(ck, names), (fin["w"], fin["mu"])]
            del ck
        rec = dict(bytes_before=held_bytes(state), steps=[])
        if mode in ("tp2", "tp2sp"):
            enc = encoder_check(state, mesh, batches[0], workdir, rank, dev,
                                tp2_encoder if mode == "tp2sp" else None)
            if enc is not None:
                f_g = enc.pop("_f"), enc.pop("_g")
                tp2_encoder = f_g if mode == "tp2" else None
            rec["encoder"] = enc
        for i, (x, labels) in enumerate(
                batches[:PAR_MODE_STEPS.get(mode, PAR_STEPS)]):
            if i == 1:
                # step 2 from the single process's state after step 1,
                # through the one-GPU checkpoint into the placed state
                restore_checkpoint(state, workdir, "par_step1", 0)
            xs, ls = shard_batch((torch.from_numpy(x),
                                  torch.from_numpy(labels).long()), mesh)
            xs, ls = xs.to(dev), ls.to(dev)
            for s in shapes.values():
                s.clear()
            reset_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            m = train_step(state, xs, ls, cfg)
            torch.cuda.synchronize()
            st = dict(loss=float(m["loss"]),
                      ms=(time.perf_counter() - t0) * 1e3,
                      peak_bytes=torch.cuda.max_memory_allocated(),
                      launches=read_counts(),
                      shapes={k: sorted(v) for k, v in shapes.items()})
            with full_parameters(state):
                w = _flat(p for _, p in state.named_params())
            opt = full_optimizer_state(state)
            mu = _flat(opt["mu"][n] for n in names)
            if rank == 0:
                prev_mu = None if i == 0 else refs[0][1]
                st["compare"] = parallel_compare(w, mu, *refs[i], i + 1,
                                                 prev_mu)
            del w, mu, opt
            rec["steps"].append(st)
        rec["bytes_after"] = held_bytes(state)
        rec["sharded_leaves"] = len(placement_table(state.placements))
        rec["stage_leaves"] = sum(pl.stage is not None for pl in
                                  state.placements.values())
        rec["backend"] = str(dist.get_backend())
        del state, model
        torch.cuda.empty_cache()
        records[mode] = rec
    everyone = [None] * world
    dist.all_gather_object(everyone, records)
    if rank == 0:
        with open(os.path.join(workdir, "par_ranks.json"), "w") as f:
            json.dump(everyone, f)
    torch.use_deterministic_algorithms(False)
    pp_cli_rank(rank, world, port, workdir)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def parallel_compare(w, mu, w_ref, mu_ref, step: int, prev_mu=None) -> dict:
    """The ranks' gathered state after `step` against the single
    process's from the same state before it. The step's gradient g =
    (mu - 0.9 prev_mu) / 0.1 (prev_mu 0 at step 1) as a relative L2
    difference (phase 8's gradient gate). The parameters: at step 1,
    Adam's update is lr * g / (|g| + eps), so each weight may differ by
    lr * |s_a - s_b| (s = g / (|g| + eps): 2 lr where the two gradients
    differ in sign) plus the update's and the weight's rounding (phase 8's
    bound); at step 2, by twice the largest update Adam makes
    (lr (1 - b1) / sqrt(1 - b2) each) plus the rounding. Reports the
    largest excess over the bound (<= 0 passes) and how many weights
    differ by over lr / 100."""
    import torch

    dev = w.device
    w_ref, mu_ref = w_ref.to(dev), mu_ref.to(dev)
    if prev_mu is None:
        g, g_ref = mu / 0.1, mu_ref / 0.1
    else:
        prev = prev_mu.to(dev)
        g, g_ref = (mu - 0.9 * prev) / 0.1, (mu_ref - 0.9 * prev) / 0.1
        del prev
    diff = (w - w_ref).abs()
    if step == 1:
        s, s_ref = g / (g.abs() + 1e-8), g_ref / (g_ref.abs() + 1e-8)
        bound = PAR_LR * (s - s_ref).abs() + 2.0 ** -19 * PAR_LR
        del s, s_ref
    else:
        bound = torch.full_like(w, 2 * PAR_LR * 0.1 / math.sqrt(0.001)
                                + 2.0 ** -19 * PAR_LR)
    bound += 2.0 ** -22 * w_ref.abs()
    out = dict(
        grad_rel_l2=float((g - g_ref).norm() / g_ref.norm()),
        w_max_abs_diff=float(diff.max()),
        w_excess=float((diff - bound).max()),
        w_differing=int((diff > PAR_LR / 100).sum()), w_total=w.numel())
    del w_ref, mu_ref, g, g_ref, diff, bound
    torch.cuda.empty_cache()
    return out


def phase_parallel_kernels():
    """Phase 17's kernel checks at the per-rank shapes, through phase 3's
    harness: attention at H = 8 (tp=2 of 16 heads), ffn_fwd at F 2048
    (tp=2 of 4096), LayerNorm's backward on a rank's rows under dp=2
    ([6 x 299, 1024]) and fused_adam over rank 0's fsdp=2 shards."""
    h = XLSR_HEADS // 2
    f = XLSR_FFN // 2
    return dict(
        flash_attn_fwd=phase_kernels(b=8, h=h, ts=(MAIN_PATH_TS[0],))[0],
        flash_attn_bwd=phase_attention_bwd(h=h, ts=(MAIN_PATH_TS[0],))[0],
        ffn_fwd=phase_ffn(cases=[(FFN_MAIN_M, 1024, f, False),
                                 (TRAIN_B * MAIN_PATH_TS[0], 1024, f,
                                  False)]),
        layernorm_bwd=phase_layernorm_bwd(
            shapes=((TRAIN_B // 2 * MAIN_PATH_TS[0], 1024),)),
        fused_adam=phase_fused_adam(odd_leaves=False,
                                    mesh=dict(dp=1, fsdp=2)))


def phase_pipeline_kernels(tp2_rows):
    """Phase 17's kernel checks at the pp=2 and tp=2 + sp per-rank shapes
    (the "pp2" and "sp2" rows): under pp a microbatch of TRAIN_B / PP_M
    rows (attention at B 3 x H 16, ffn_fwd and the LayerNorm backward on
    897 rows) and fused_adam over stage 0's leaves; under sp the
    LayerNorm backward on a frame block ([12 x 150, 1024], T = 299 padded
    to 300) and fused_adam over a tp=2 rank's shards. Attention and the
    FFN run on the gathered frames under sp, at tp=2's shapes: their sp2
    rows are tp2's (`tp2_rows`), not measured again."""
    t = MAIN_PATH_TS[0]
    b = TRAIN_B // PP_M
    pp2 = dict(
        flash_attn_fwd=phase_kernels(b=b, h=XLSR_HEADS, ts=(t,))[0],
        flash_attn_bwd=phase_attention_bwd(h=XLSR_HEADS, ts=(t,), b=b)[0],
        ffn_fwd=phase_ffn(cases=[(b * t, 1024, XLSR_FFN, False)]),
        layernorm_bwd=phase_layernorm_bwd(shapes=((b * t, 1024),)),
        fused_adam=phase_fused_adam(odd_leaves=False,
                                    mesh=dict(dp=1, pp=PP_STAGES)))
    sp2 = {k: dict(tp2_rows[k], shape_of="tp2")
           for k in ("flash_attn_fwd", "flash_attn_bwd")}
    sp2["ffn_fwd"] = [dict(r, shape_of="tp2") for r in tp2_rows["ffn_fwd"]]
    sp2.update(
        layernorm_bwd=phase_layernorm_bwd(
            shapes=((TRAIN_B * (t + 1) // 2, 1024),)),
        fused_adam=phase_fused_adam(odd_leaves=False,
                                    mesh=dict(dp=1, tp=2)))
    return dict(pp2=pp2, sp2=sp2)


def phase_parallel(workdir: str, fixture, ckpt=None):
    """Phase 17: the multi-GPU paths on one card.

    1. dp=2, fsdp=2, tp=2 over two ranks sharing cuda:0 (Gloo), each mesh
       from the same weights: step 1 on their rows of a global 12 x 6 s
       batch, then step 2 from the single process's state after step 1
       (its one-GPU checkpoint restored into the placed state) on a
       second batch, each held against the single-process eager step from
       the same state: dp=2 and fsdp=2 with the loss within LOSS_RTOL
       (the ranks' losses equal) and the gradient within LOSS_RTOL
       (relative L2, phase 8's gate); tp=2, which rounds its bf16 partial
       sums otherwise (its features move by about one bf16 rounding, and
       AASIST's top-k pools make the loss of another routing: the single
       process's own loss moves as far under that noise, printed), with
       its XLSR encoder at the init weights held instead: features and
       the parameter gradient from the single process's upstream gradient
       within LOSS_RTOL (relative L2); every mode's parameters within
       Adam's reach (`parallel_compare`); each kernel's launches a step
       and rank equal to the single process's, on the per-rank shapes
       (tp: flash on 8 heads, ffn_fwd on F 2048), and the bytes each rank
       holds (fsdp=2: about half of dp=2's);
    2. NCCL at world size 1: `oc_training --dp 1 --steps_per_dispatch 3`
       in a torchrun environment, its collectives inside the CUDA graph,
       bit for bit with `--steps_per_dispatch 1`;
    3. `oc_classifier --mode 2c2 --data_parallel -1` and `oc_server
       --data_parallel -1`: the plain calls' scores; `--data_parallel 2`
       on one card raises.
    Every number of step 1 and the bytes are printed before any gate
    fails. Returns (launches by kernel, the record)."""
    import torch

    from occm_tpu_torch.models import AModel

    out = {}
    total = dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                           "flash_attn_bwd_dkv", "layernorm_bwd",
                           "fused_adam", "ffn_fwd"), 0)

    def add(counts):
        for k in total:
            total[k] += counts.get(k, 0)

    acfg, xcfg, _ = parallel_configs()
    t_phase = time.perf_counter()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        init = AModel(acfg, xcfg).state_dict()
    torch.save(init, os.path.join(workdir, "par_init.pt"))
    rng = np.random.default_rng(17)
    batches = [((rng.normal(size=(TRAIN_B, TRAIN_CUT)) * 0.1).astype(
        np.float32), np.array([0] * 6 + [1] * 6, np.int64))
        for _ in range(PAR_STEPS)]
    np.savez(os.path.join(workdir, "par_batches.npz"),
             **{f"x{i}": x for i, (x, _) in enumerate(batches)},
             **{f"l{i}": lb for i, (_, lb) in enumerate(batches)})

    # ---- the single process, twice (its spread under deterministic
    # algorithms); the first run's step-1 state saved as a checkpoint
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        ref_steps, names, w, mu = parallel_single(init, batches, workdir)
        _, _, w2, mu2 = parallel_single(init, batches)
        # pp2s4's reference: the one process at pp_stages 4 (its 4
        # microbatches through all PAR_DEPTH layers in turn), step 1
        s4_steps = parallel_single(init, batches[:1],
                                   xlsr=PAR_XLSR["pp2s4"])[0]
        enc_ref = encoder_reference(init, batches[0], workdir)
    finally:
        torch.use_deterministic_algorithms(False)
    for st in ref_steps + s4_steps:
        add(st["launches"])
    spread = dict(w_max_abs_diff=float((w - w2).abs().max()),
                  mu_rel_l2=float((mu - mu2).norm() / mu.norm()))
    torch.save({"w": w.cpu(), "mu": mu.cpu()},
               os.path.join(workdir, "par_ref.pt"))
    del w, mu, w2, mu2, init
    torch.cuda.empty_cache()
    per_step = {k: v for k, v in ref_steps[0]["launches"].items()
                if k in total}
    print(f"[parallel] single process, 2 eager steps of 12 x 6 s: losses "
          f"{[round(s['loss'], 6) for s in ref_steps]}, ms "
          f"{[round(s['ms'], 1) for s in ref_steps]}, launches per step "
          f"{per_step}; spread of two runs (deterministic algorithms): "
          f"{spread}; the step-1 loss on its encoder's features moved by "
          f"one bf16 rounding (relative noise 2^-8): {enc_ref['moved']} "
          f"against {enc_ref['loss']:.6f}", flush=True)

    # ---- two ranks on cuda:0 over Gloo (each then runs oc_training --pp)
    pp_ckpt = pp_cli_argv(workdir, fixture)
    with socket_port() as port:
        pass
    ranks_s = _run_ranks(lambda r: ["--parallel-rank", str(r), "2",
                                    str(port), workdir], workdir,
                         "par_rank")
    with open(os.path.join(workdir, "par_ranks.json")) as f:
        ranks = json.load(f)
    tol = LOSS_RTOL
    failures = []
    frames = 299  # TRAIN_CUT's
    for mode in PAR_MESHES:
        recs = [r[mode] for r in ranks]
        tp = mode.startswith("tp2")
        want_h = XLSR_HEADS // 2 if tp else XLSR_HEADS
        want_f = XLSR_FFN // 2 if tp else XLSR_FFN
        rows = {"dp2": TRAIN_B // 2, "fsdp2": TRAIN_B // 2,
                "pp2": TRAIN_B // PP_M,
                "pp2s4": TRAIN_B // PP_M}.get(mode, TRAIN_B)
        # the LayerNorms' rows: a microbatch under pp, a frame block (T
        # padded to a multiple of 2) under sp
        ln_rows = (TRAIN_B * (frames + 1) // 2 if mode == "tp2sp"
                   else rows * frames)
        want_launches = dict(per_step)
        if mode in ("pp2", "pp2s4"):
            # each of the 2 ranks runs half the layers (one stage of pp2,
            # two of pp2s4) on PP_M microbatches
            want_launches = {k: (n if k == "fused_adam"
                                 else n * PP_M // 2)
                             for k, n in per_step.items()}
        for i, ref in enumerate(ref_steps[:len(recs[0]["steps"])]):
            cmp = recs[0]["steps"][i]["compare"]
            losses = {rec["steps"][i]["loss"] for rec in recs}
            loss = recs[0]["steps"][i]["loss"]
            if len(losses) != 1:
                failures.append(f"{mode} step {i + 1}: ranks' losses "
                                f"{losses}")
            # tp=2 rounds its bf16 partial sums otherwise, so its features
            # move by about one bf16 rounding, and AASIST's top-k pools
            # turn that into a loss and gradient of another routing (the
            # single process's own loss moves as far under that noise):
            # its whole-model loss and gradient are printed, and its
            # encoder is held below
            if not tp and not (abs(loss - ref["loss"])
                               <= tol * abs(ref["loss"])
                               and cmp["grad_rel_l2"] <= tol):
                failures.append(f"{mode} step {i + 1}: loss {loss} vs "
                                f"single {ref['loss']} (rtol {tol}), "
                                f"gradient rel L2 {cmp['grad_rel_l2']}")
            if not cmp["w_excess"] <= 0.0:
                failures.append(f"{mode} step {i + 1}: weights over Adam's "
                                f"reach by {cmp['w_excess']}")
            for r, rec in enumerate(recs):
                st = rec["steps"][i]
                got = {k: st["launches"][k] for k in per_step}
                if got != want_launches:
                    failures.append(f"{mode} rank {r} step {i + 1}: "
                                    f"launches {got}, want {want_launches}")
                add(got)
                sh = st["shapes"]
                seen = ({s[0] for s in sh["flash_attn_fwd"]},
                        {s[2] for s in sh["flash_attn_fwd"]},
                        {s[0] for s in sh["ffn_fwd"]},
                        {s[2] for s in sh["ffn_fwd"]},
                        {s[0] for s in sh["layernorm_bwd"]})
                want = ({rows}, {want_h}, {rows * frames}, {want_f},
                        {ln_rows})
                if seen != want:
                    failures.append(
                        f"{mode} rank {r}: flash on (rows, heads) "
                        f"{seen[:2]}, ffn_fwd on (M, F) {seen[2:4]}, "
                        f"layernorm_bwd on rows {seen[4]}; want {want}")
            print(f"[parallel] {mode} step {i + 1} (2 ranks sharing "
                  f"cuda:0, Gloo): loss {loss:.6f} vs single "
                  f"{ref['loss']:.6f} (rtol {tol}); gradient rel L2 "
                  f"{cmp['grad_rel_l2']:.3e} (bound {tol}); params max "
                  f"|diff| {cmp['w_max_abs_diff']:.3e}, excess over "
                  f"Adam's reach {cmp['w_excess']:.3e}, "
                  f"{cmp['w_differing']} of {cmp['w_total']} over lr/100; "
                  f"step ms per rank (two ranks sharing one card) "
                  f"{[round(rec['steps'][i]['ms'], 1) for rec in recs]}, "
                  f"peak GiB per rank "
                  f"{[round(rec['steps'][i]['peak_bytes'] / 2**30, 3) for rec in recs]}",
                  flush=True)
        if tp:
            enc = recs[0]["encoder"]
            out[f"{mode}_encoder"] = enc
            print(f"[parallel] {mode} encoder at the init weights on the "
                  f"whole batch: features rel L2 {enc['feats_rel_l2']:.3e}, "
                  f"parameter gradient (from the single process's upstream "
                  f"gradient) rel L2 {enc['grad_rel_l2']:.3e} (bounds "
                  f"{tol})", flush=True)
            if not (enc["feats_rel_l2"] <= tol and enc["grad_rel_l2"] <= tol):
                failures.append(f"{mode} encoder: {enc}")
            if mode == "tp2sp":
                print(f"[parallel] tp2sp encoder against tp2's (same weights "
                      f"and batch): features rel L2 "
                      f"{enc['feats_vs_rel_l2']:.3e} (largest |diff| "
                      f"{enc['feats_vs_max_abs']:.3e}), gradient rel L2 "
                      f"{enc['grad_vs_rel_l2']:.3e} (largest |diff| "
                      f"{enc['grad_vs_max_abs']:.3e}); bounds {tol}",
                      flush=True)
                if not (enc["feats_vs_rel_l2"] <= tol
                        and enc["grad_vs_rel_l2"] <= tol):
                    failures.append(f"tp2sp encoder against tp2's: {enc}")
        if mode == "pp2s4":
            # against the one process at pp_stages 4: the same 4
            # microbatches through the same layers, in one process
            loss, s4 = recs[0]["steps"][0]["loss"], s4_steps[0]["loss"]
            out["pp2s4_single_s4"] = dict(
                loss=loss, single_s4_loss=s4, bit_equal=loss == s4,
                single_s4_ms=s4_steps[0]["ms"])
            print(f"[parallel] pp2s4 (pp=2, pp_stages {PP_S4}, M={PP_M}, "
                  f"two stages a rank) step 1: loss {loss!r} vs the one "
                  f"process at pp_stages {PP_S4} {s4!r} (bit for bit "
                  f"{loss == s4}); step ms per rank "
                  f"{[round(rec['steps'][0]['ms'], 1) for rec in recs]} "
                  f"(one process {s4_steps[0]['ms']:.1f})", flush=True)
            # the same kernels on the same microbatches, under
            # deterministic algorithms on both sides, and exact hand-offs
            if loss != s4:
                failures.append(f"pp2s4 loss {loss!r} vs the one process "
                                f"at pp_stages {PP_S4}: {s4!r}")
        if any(rec["backend"] != "gloo" for rec in recs):
            failures.append(f"{mode}: backend {recs[0]['backend']}")
        by = {k: [rec[k] for rec in recs] for k in ("bytes_before",
                                                    "bytes_after")}
        out[mode] = dict(
            losses=[s["loss"] for s in recs[0]["steps"]],
            single_losses=[s["loss"] for s in ref_steps],
            step_ms=[[s["ms"] for s in rec["steps"]] for rec in recs],
            peak_bytes=[[s["peak_bytes"] for s in rec["steps"]]
                        for rec in recs],
            bytes=by, sharded_leaves=recs[0]["sharded_leaves"],
            stage_leaves=recs[0]["stage_leaves"],
            compare=[s["compare"] for s in recs[0]["steps"]],
            launches=recs[0]["steps"][0]["launches"],
            shapes=recs[0]["steps"][0]["shapes"])
        print(f"[parallel] {mode}: held bytes per rank (parameters, Adam "
              f"moments) {by['bytes_after']}; {out[mode]['sharded_leaves']}"
              f" sharded leaves; flash / ffn_fwd shapes "
              f"{out[mode]['shapes']}", flush=True)
    dp_b = out["dp2"]["bytes"]["bytes_after"][0]
    fs_b = out["fsdp2"]["bytes"]["bytes_after"][0]
    out["fsdp_over_dp"] = {k: fs_b[k] / dp_b[k] for k in dp_b}
    if not all(v < 0.55 for v in out["fsdp_over_dp"].values()):
        failures.append(f"fsdp=2 holds {out['fsdp_over_dp']} of dp=2's "
                        "bytes per rank")
    # a dp=2 rank holds the one process's state whole
    for mode in ("pp2", "pp2s4"):
        key = "pp_over_one" if mode == "pp2" else "pp2s4_over_one"
        out[key] = [{k: b[k] / dp_b[k] for k in dp_b}
                    for b in out[mode]["bytes"]["bytes_after"]]
        if not all(0.5 < v < 0.55 for b in out[key] for v in b.values()):
            failures.append(f"a {mode} rank holds {out[key]} of the one "
                            "process's bytes")
    out["pp_bubble"] = (PP_STAGES - 1) / (PP_M + PP_STAGES - 1)
    out["sp_peak_over_tp2"] = [
        a[0] / b[0] for a, b in zip(out["tp2sp"]["peak_bytes"],
                                    out["tp2"]["peak_bytes"])]
    print(f"[parallel] pp=2 (M={PP_M}): each stage holds "
          f"{out['pp_over_one']} of the one process's bytes (parameters, "
          f"Adam moments; {out['pp2']['stage_leaves']} stage-placed "
          f"leaves); bubble (S - 1) / (M + S - 1) = {out['pp_bubble']:.3f}; "
          f"step-1 peak per rank tp2 "
          f"{[p[0] for p in out['tp2']['peak_bytes']]} B, tp2 + sp "
          f"{[p[0] for p in out['tp2sp']['peak_bytes']]} B "
          f"({out['sp_peak_over_tp2']} of tp2's); pp2s4: each rank holds "
          f"{out['pp2s4_over_one']} of the one process's bytes "
          f"({out['pp2s4']['bytes']['bytes_after']}), bubble (S - 1) / "
          f"(M + S - 1) = {(PP_S4 - 1) / (PP_M + PP_S4 - 1):.3f}",
          flush=True)
    out["ranks_wall_s"] = ranks_s
    out["single_spread"] = spread
    out["single_ms"] = [s["ms"] for s in ref_steps]
    out["single_loss_under_feature_rounding"] = enc_ref
    print(f"[parallel] fsdp=2 / dp=2 held bytes per rank: "
          f"{out['fsdp_over_dp']}; the two ranks' processes took "
          f"{ranks_s:.1f} s (start, model build, 5 meshes x 1-2 steps, "
          f"gathers, a checkpoint restore each, then oc_training --pp 2)",
          flush=True)
    if failures:
        fail("parallel: " + "; ".join(failures))
    for name in ("par_init.pt", "par_ref.pt", "par_step1_0.pt",
                 "par_enc.pt"):
        os.remove(os.path.join(workdir, name))

    # ---- oc_training --pp 2 over the two ranks: a one-GPU checkpoint
    pp_cli, counts = phase_pp_cli(workdir, pp_ckpt, per_step)
    add(counts)
    out["pp_cli"] = pp_cli

    # ---- NCCL at world size 1: the collectives inside the CUDA graph
    nccl, counts = phase_nccl_graph(workdir, fixture)
    add(counts)
    out["nccl_world_1"] = nccl

    # ---- data-parallel scoring and serving
    dp, counts = phase_dp_scoring(workdir, fixture, ckpt)
    add(counts)
    out["data_parallel"] = dp
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[parallel] phase 17: {out['wall_s']:.1f} s", flush=True)
    return total, out


def _run_ranks(args, workdir: str, label: str):
    """Two processes of this script (`args` after the script) on cuda:0,
    each with a log of its own; fails on a rank's non-zero exit. Returns
    the wall seconds."""
    logs = [open(os.path.join(workdir, f"{label}{r}.log"), "w")
            for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), *args(r)],
        stdout=logs[r], stderr=subprocess.STDOUT, cwd=workdir)
        for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=PAR_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    wall = time.perf_counter() - t0
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"{label}{r}.log")) as f:
                print(f.read()[-6000:], file=sys.stderr)
            fail(f"{label} rank {r} exited {p.returncode}")
    return wall


def pp_cli_rank(rank: int, world: int, port: int, workdir: str) -> None:
    """One rank of `oc_training --pp 2 --pp_microbatches 4` (phase 17), in
    the rank's process after its meshes: the torchrun environment with
    LOCAL_RANK 0 for both ranks (they share cuda:0), the process group
    already joined over Gloo (the CLI's own join finds it), then the
    CLI's main; writes its steps' losses, times and launches."""
    import torch.distributed as dist

    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.parallel import pp_stage

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    with open(os.path.join(workdir, "pp_cli_argv.json")) as f:
        argv = json.load(f)
    reset_counts()
    t0 = time.perf_counter()
    rec = StepRecorder()
    with cli_at_depth(PAR_DEPTH):  # the meshes' model
        state = oc_training.main(argv, on_step=rec)
    with open(os.path.join(workdir, f"pp_cli_rank{rank}.json"), "w") as f:
        json.dump(dict(steps=rec.steps, step=state.step,
                       backend=str(dist.get_backend()),
                       stage=pp_stage(state.mesh),
                       wall_s=time.perf_counter() - t0), f)


def pp_cli_argv(workdir: str, fixture) -> str:
    """Write phase 17's `oc_training --pp 2` arguments for the ranks (an
    epoch of the fixture tree at --groups_per_step 3: 2 steps of 36 x 6
    s, microbatches of 9); returns its checkpoint directory."""
    protocol, train_dir, voc_dir = fixture
    ckpt_dir = os.path.join(workdir, "pp_ckpt")
    argv = ["--train_protocol_file", protocol, "--train_dataset_dir",
            train_dir, "--vocoded_dir", voc_dir, "--cut", str(TRAIN_CUT),
            "--num_epochs", "1", "--groups_per_step", "3", "--pp",
            str(PP_STAGES), "--pp_microbatches", str(PP_M),
            "--attention_impl", "flash", "--compactness_weight", "0.1",
            "--descriptiveness_weight", "0.9", "--checkpoint_dir", ckpt_dir]
    with open(os.path.join(workdir, "pp_cli_argv.json"), "w") as f:
        json.dump(argv, f)
    return ckpt_dir


def phase_pp_cli(workdir: str, ckpt_dir: str, per_step):
    """`oc_training --pp 2 --pp_microbatches 4 --attention_impl flash` over
    phase 17's two ranks sharing cuda:0 (Gloo; `pp_cli_rank`): every
    step's loss finite and equal on the ranks, the flash kernels' launches
    a step and rank the one process's x M / S; rank 0 writes a one-GPU
    checkpoint, which one process loads with strict=True. Returns (the
    record, launches by kernel)."""
    import torch

    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.models import AModel, load_reference_state_dict

    ranks = []
    for r in range(2):
        with open(os.path.join(workdir, f"pp_cli_rank{r}.json")) as f:
            ranks.append(json.load(f))
    scale = PP_M // PP_STAGES
    want = {k: per_step[k] * scale for k in ("flash_attn_fwd",
                                             "flash_attn_bwd_dq",
                                             "flash_attn_bwd_dkv")}
    counts = {}
    for r, rec in enumerate(ranks):
        if rec["backend"] != "gloo" or rec["stage"] != r or not rec["steps"]:
            fail(f"oc_training --pp 2 rank {r}: {rec}")
        for st in rec["steps"]:
            got = {k: st["launches"][k] for k in want}
            if got != want or not math.isfinite(st["loss"]):
                fail(f"oc_training --pp 2 rank {r} step {st['step']}: loss "
                     f"{st['loss']}, launches {got}, want {want}")
            for k, n in st["launches"].items():
                counts[k] = counts.get(k, 0) + n
    losses = [[st["loss"] for st in rec["steps"]] for rec in ranks]
    if losses[0] != losses[1]:
        fail(f"oc_training --pp 2: the ranks' losses differ: {losses}")
    path = os.path.join(ckpt_dir, "aasist_vocoded_0.pt")
    if sorted(os.listdir(ckpt_dir)) != ["aasist_vocoded_0.pt"]:
        fail(f"oc_training --pp 2 wrote {sorted(os.listdir(ckpt_dir))}")
    size = os.path.getsize(path)
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = AModel(AASISTConfig(), at_depth(XLSRConfig(), PAR_DEPTH))
    model.load_state_dict(load_reference_state_dict(path), strict=True)
    load_s = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(ckpt_dir)
    wall = [rec["wall_s"] for rec in ranks]
    out = dict(losses=losses[0], wall_s=wall, ckpt_bytes=size,
               load_s=load_s, steps=len(losses[0]),
               step_ms=[[st["ms"] for st in rec["steps"]] for rec in ranks],
               launches=ranks[0]["steps"][0]["launches"])
    print(f"[parallel] oc_training --pp 2 --pp_microbatches {PP_M} over two "
          f"ranks sharing cuda:0 (Gloo): {len(losses[0])} steps, losses "
          f"{losses[0]} (equal on the ranks), step ms per rank "
          f"{out['step_ms']}, flash launches a step and rank {want}; rank "
          f"0's one-GPU checkpoint ({size} B) loads into one process with "
          f"strict=True ({load_s:.1f} s); the CLI's main took "
          f"{[round(w, 1) for w in wall]} s on the ranks", flush=True)
    return out, counts


class socket_port:
    """A free localhost TCP port (the socket is closed on exit, and the
    port handed to the process group)."""

    def __enter__(self):
        import socket

        self.sock = socket.socket()
        self.sock.bind(("127.0.0.1", 0))
        return self.sock.getsockname()[1]

    def __exit__(self, *exc):
        self.sock.close()


def phase_nccl_graph(workdir: str, fixture):
    """`oc_training --dp 1` in a torchrun environment of world size 1
    (NCCL): one epoch of 6 steps with --steps_per_dispatch 3 (two graph
    launches, the gradient all-reduce, the BatchNorm sums and the loss's
    all-gather captured) and with 1 (eager); the epoch checkpoints must
    be equal bit for bit (deterministic algorithms)."""
    import torch
    import torch.distributed as dist

    from occm_tpu_torch.cli import oc_training

    protocol, train_dir, voc_dir = fixture
    with socket_port() as port:
        pass
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    argv = ["--train_protocol_file", protocol, "--train_dataset_dir",
            train_dir, "--vocoded_dir", voc_dir, "--cut", str(TRAIN_CUT),
            "--num_epochs", "1", "--dp", "1", "--attention_impl", "flash",
            "--compactness_weight", "0.1", "--descriptiveness_weight", "0.9"]
    runs, counts = {}, dict.fromkeys(("flash_attn_fwd", "flash_attn_bwd_dq",
                                      "flash_attn_bwd_dkv", "layernorm_bwd",
                                      "fused_adam", "ffn_fwd"), 0)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for k in (3, 1):
            d = os.path.join(workdir, f"nccl_k{k}")
            reset_counts()
            rec = StepRecorder()
            t0 = time.perf_counter()
            with cli_at_depth(PAR_DEPTH):
                state = oc_training.main(
                    argv + ["--checkpoint_dir", d, "--steps_per_dispatch",
                            str(k)], on_step=rec)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_counts()
            for key in counts:
                counts[key] += got[key]
            backend = str(dist.get_backend())
            graph = state.graph
            runs[k] = dict(
                wall_s=wall, backend=backend,
                world=dist.get_world_size(),
                losses=[s["loss"] for s in rec.steps],
                replays=0 if graph is None else graph.replays,
                captured=None if graph is None else {
                    str(s): c for s, c in graph.capture_launches.items()},
                ckpt=os.path.join(d, "aasist_vocoded_0.pt"))
            del state, graph
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    a = torch.load(runs[3]["ckpt"], weights_only=True)
    b = torch.load(runs[1]["ckpt"], weights_only=True)
    same = all(torch.equal(v, b["model"][n]) for n, v in a["model"].items())
    same_opt = all(torch.equal(v, b["optimizer"]["mu"][n])
                   for n, v in a["optimizer"]["mu"].items())
    for k in (3, 1):
        os.remove(runs[k]["ckpt"])
    if runs[3]["backend"] != "nccl" or runs[3]["world"] != 1:
        fail(f"NCCL world 1: backend {runs[3]['backend']}, world "
             f"{runs[3]['world']}")
    if runs[3]["replays"] != 2 or runs[1]["replays"] != 0:
        fail(f"NCCL world 1: {runs[3]['replays']} graph launches with k=3 "
             "for 6 steps, want 2")
    if not (same and same_opt and runs[3]["losses"] != []):
        fail("NCCL world 1: the k=3 graph's checkpoint differs from the "
             "eager steps' (weights or Adam moments)")
    out = dict(k3=dict(runs[3], ckpt=None), k1=dict(runs[1], ckpt=None),
               bit_equal=True)
    print(f"[parallel] NCCL world 1, oc_training --dp 1: --steps_per_"
          f"dispatch 3 ({runs[3]['replays']} graph launches, collectives "
          f"captured; {runs[3]['wall_s']:.1f} s) = --steps_per_dispatch 1 "
          f"({runs[1]['wall_s']:.1f} s) bit for bit (weights, Adam "
          f"moments); chunk losses {runs[3]['losses']}", flush=True)
    return out, counts


def phase_dp_scoring(workdir: str, fixture, ckpt=None):
    """`oc_classifier --mode 2c2` and `oc_server` with `--data_parallel -1`
    (one card: a mesh of one device) against the plain calls on the same
    eval set and requests: the same scores, bit for bit;
    `--data_parallel 2` raises as JAX's make_dp_mesh does."""
    import torch

    from occm_tpu_torch.cli import oc_classifier

    root = os.path.join(workdir, "dp_scoring")
    os.makedirs(root)
    if ckpt is None:  # a full run passes phase 4's
        _, ckpt = build_seed_model(root)
        gc.collect()
        torch.cuda.empty_cache()
    eval_dir, paths = write_eval_set(root)
    protocol, train_dir, _ = fixture
    argv = ["--pretrained-sslaasist", ckpt, "--protocol_file", protocol,
            "--dataset_dir", train_dir, "--eval_protocol_file",
            paths["eval.txt"], "--eval_dataset_dir", eval_dir, "--mode",
            "2c2"]
    counts = dict.fromkeys(("flash_attn_fwd",), 0)
    files = {}
    reset_counts()
    for tag, extra in (("plain", []), ("dp", ["--data_parallel", "-1"])):
        files[tag] = os.path.join(root, f"scores_{tag}.txt")
        oc_classifier.main(argv + ["--score_file", files[tag]] + extra)
    from occm_tpu_torch.ops import attention

    counts["flash_attn_fwd"] += attention.LAUNCHES
    plain, dp = (np.loadtxt(files[t]) for t in ("plain", "dp"))
    if not (plain.shape == dp.shape and np.isfinite(plain).all()
            and open(files["plain"]).read() == open(files["dp"]).read()):
        fail(f"oc_classifier --data_parallel -1: scores {dp} differ from "
             f"the plain call's {plain}")
    try:
        oc_classifier.main(argv + ["--score_file",
                                   os.path.join(root, "x.txt"),
                                   "--data_parallel", "2"])
        refused = None
    except ValueError as e:
        refused = str(e)
    if refused is None or "only 1 present" not in refused:
        fail(f"oc_classifier --data_parallel 2 on one card: {refused}")

    art = os.path.join(root, "artifacts")
    os.makedirs(art)
    np.save(os.path.join(art, "reference_embedding.npy"),
            np.random.default_rng(5).normal(size=160).astype(np.float32))
    np.save(os.path.join(art, "threshold.npy"), np.float32(10.0))
    rng = np.random.default_rng(18)
    waves = [synthetic_wave(rng, s) for s in (4.0, 6.0, 12.0)]
    served = {}
    reset_counts()
    for tag, extra in (("plain", []), ("dp", ["--data_parallel", "-1"])):
        scores = []
        with serving(["--pretrained-sslaasist", ckpt, "--artifacts_dir", art,
                      "--host", "127.0.0.1", "--port", "0", "--max_wait_ms",
                      "5", "--buckets", "16000", "64000", "96000", "192000",
                      *extra], f"oc_server {extra}") as started:
            for w in waves:
                status, payload, _ = post(started.server.port,
                                          w.astype("<f4").tobytes(),
                                          {"X-Sample-Rate": "16000"})
                check_response(f"dp server {tag}", status, payload)
                scores.append(payload["score"])
        served[tag] = scores
    counts["flash_attn_fwd"] += attention.LAUNCHES
    if served["dp"] != served["plain"]:
        fail(f"oc_server --data_parallel -1: scores {served['dp']} vs the "
             f"plain server's {served['plain']}")
    out = dict(classifier_2c2=dp.tolist(), server=served["dp"],
               refused_2=refused)
    print(f"[parallel] oc_classifier 2c2 and oc_server with "
          f"--data_parallel -1 = the plain calls bit for bit "
          f"({len(dp)} utterances, {len(waves)} requests); "
          f"--data_parallel 2: ValueError({refused!r})", flush=True)
    return out, counts


# ------------------------------ phase 18: the rest of ROADMAP item 16

EXTRA_SCORE_SECONDS = 6.0   # the layouts' scoring batch: 8 x 6 s
PGD_SECONDS = 4.0           # PGD's batch: 8 x 4 s
PGD_STEPS = 10
FEATURE_SECONDS = 4.0       # the feature bank's utterances
FEATURE_BATCH = 8           # 2 for the CWT and the synchrosqueezed CWT
SVM_UTTERANCES = 32         # 4 batches of 8 x 4 s, two classes
SVM_EPOCHS = 50             # the JAX package's default
# the layouts against the default one, in fp32 (TF32 off): the JAX
# suite's tolerances for the same comparisons at tiny width
# (tests/test_xlsr_extras.py:107-109 fused_qkv, :231-234 the attention
# layouts, :319-324 the positional conv), elementwise |a - b| <= atol +
# rtol |b|, fused_qkv also by its relative L2
LAYOUT_TOL = {"fused_qkv": (2e-2, 2e-4), "attention": (1e-4, 1e-5),
              "pos_conv": (1e-4, 1e-5)}
FUSED_REL_L2 = 2e-3
# the feature bank on the card (fp32) against the CPU in fp64: the CPU
# suite's tolerances against JAX (tests/test_torch_features.py): spectra,
# mel, CWT within 1e-4 of the largest magnitude; the cepstra (log, DCT,
# MVN) and CQCC within 2e-3; LPC / LPCC within 1e-3; the synchrosqueezed
# CWT with at most 0.2 % of its entries in another bin (an fp32 rounding
# at a bin edge) and its columns' sums within 1e-4 of the largest
FEATURE_TOL = {"stft_mag": ("rel_max", 1e-4), "extract_mel": ("rel_max", 1e-4),
               "extract_lfcc": ("abs", 2e-3), "extract_mfcc": ("abs", 2e-3),
               "extract_bfcc": ("abs", 2e-3), "extract_cqcc": ("abs", 2e-3),
               "extract_lpc": ("abs", 1e-3), "extract_lpcc": ("abs", 1e-3),
               "extract_cwt": ("rel_max", 1e-4),
               "extract_ssqcwt": ("moved", 2e-3)}
# the SVM's fit on the card against the CPU's, on the same orders: the
# hinge's margin test can flip on one rounding and send the two fits on
# other paths, so the predictions are held, not the weights
SVM_AGREE = 0.9


def float_wav(path: str, x: np.ndarray, sr: int = SR) -> None:
    """IEEE float32 mono WAV (format 3): it can hold a NaN."""
    data = np.asarray(x, "<f4").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * 4, 4, 32)
    hdr += b"data" + struct.pack("<I", len(data))
    with open(path, "wb") as f:
        f.write(hdr + data)


def _close(a, b, rtol: float, atol: float):
    """(passes, largest |a - b| - atol - rtol |b|, relative L2)."""
    excess = float(((a - b).abs() - atol - rtol * b.abs()).max())
    rel = float((a - b).norm() / b.norm())
    return excess <= 0.0, excess, rel


def layouts_scoring(model, xcfg) -> dict:
    """One 8 x 6 s batch through the encoder in every layout the JAX
    package has, each against its default layout (fused_qkv: the three
    projections; the attention layouts: xla; the positional conv:
    grouped): in fp32 (TF32 off) at the JAX suite's tolerances
    (LAYOUT_TOL), and in bf16, the served dtype (fused_qkv with the flash
    kernels, the rest on plain attention), within SCORE_RTOL of the
    largest |feature| and timed (ms a batch, CUDA events)."""
    import torch

    enc = model.ssl_model.model
    rng = np.random.default_rng(18)
    x = torch.from_numpy(np.stack([synthetic_wave(rng, EXTRA_SCORE_SECONDS)
                                   for _ in range(8)])).to("cuda")
    cases = {  # name -> (kind, its fields, its default's fields)
        "fused_qkv": ("fused_qkv", dict(fused_qkv=True), {}),
        "packed": ("attention", dict(attention_impl="packed"), {}),
        "packed8": ("attention", dict(attention_impl="packed8"), {}),
        "pad128": ("attention", dict(attention_impl="pad128"), {}),
        "xla_merged": ("attention", dict(attention_impl="xla_merged"), {}),
        "pos_batched": ("pos_conv", dict(pos_conv_impl="batched"), {}),
        "pos_s2d": ("pos_conv", dict(pos_conv_impl="s2d"), {}),
    }
    out, failures = {}, []

    def features(fields, dtype):
        set_xlsr_cfg(model, dataclasses.replace(xcfg, dtype=dtype, **fields))
        with torch.no_grad():
            return enc(x)

    try:
        for dtype in ("float32", "bfloat16"):
            base = {}
            for name, (kind, fields, default) in cases.items():
                if dtype == "bfloat16" and kind == "fused_qkv":
                    fields = dict(fields, attention_impl="flash")
                    default = dict(default, attention_impl="flash")
                key = str(sorted(default.items()))
                if key not in base:
                    base[key] = features(default, dtype)
                got = features(fields, dtype)
                want = base[key]
                row = out.setdefault(name, {})
                if not torch.isfinite(got).all():
                    failures.append(f"{name} {dtype}: non-finite features")
                    continue
                if dtype == "float32":
                    rtol, atol = LAYOUT_TOL[kind]
                    ok, excess, rel = _close(got, want, rtol, atol)
                    if kind == "fused_qkv":
                        ok = ok and rel < FUSED_REL_L2
                    row["fp32"] = dict(excess=excess, rel_l2=rel,
                                       rtol=rtol, atol=atol)
                    if not ok:
                        failures.append(f"{name} fp32: {row['fp32']}")
                else:
                    err = float((got - want).abs().max())
                    scale = float(want.abs().max())
                    row["bf16"] = dict(max_abs=err, scale=scale,
                                       rel_l2=float((got - want).norm()
                                                    / want.norm()))
                    if not err <= SCORE_RTOL * scale:
                        failures.append(f"{name} bf16: {row['bf16']}")
                    # in turns: default, layout, layout, default
                    times = {"ms": [], "default_ms": []}
                    for which in ("default_ms", "ms", "ms", "default_ms"):
                        set_xlsr_cfg(model, dataclasses.replace(
                            xcfg, dtype=dtype,
                            **(fields if which == "ms" else default)))
                        with torch.no_grad():
                            times[which].append(cuda_ms(lambda: enc(x),
                                                        iters=5, warmup=1))
                    row.update({k: sum(v) / len(v)
                                for k, v in times.items()})
                print(f"[extras] layout {name} ({dtype}) against "
                      f"{default or 'the defaults'}: {row}", flush=True)
            base.clear()
    finally:
        set_xlsr_cfg(model, xcfg)
    if failures:
        fail("extras layouts scoring: " + "; ".join(failures))
    return out


def layouts_training() -> dict:
    """One eager training step (12 x 6 s, AASIST's dropouts off, DEPTH
    layers, bf16) in each layout against the default one from the same
    weights: fused_qkv with the flash kernels against flash, the attention
    layouts against xla, the positional conv's against grouped. A layout
    that rounds its bf16 products otherwise moves the features by about
    one bf16 rounding, and AASIST's top-k pools turn that into the
    gradient of another routing (as phase 17's tp=2): the whole model's
    loss is held within LOSS_RTOL and its gradient's relative L2 printed;
    the XLSR encoder is held instead, its features and its parameter
    gradient from the default layout's upstream gradient (dloss/dfeatures)
    each within LOSS_RTOL (relative L2, phase 17's gate)."""
    import torch

    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.utils import random_init_

    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    xcfg = at_depth(XLSRConfig())
    model = random_init_(AModel(acfg, xcfg), seed=0).to("cuda").train()
    enc_params = list(model.ssl_model.parameters())
    rng = np.random.default_rng(19)
    x = torch.from_numpy(np.stack([synthetic_wave(rng, TRAIN_CUT / SR)
                                   for _ in range(TRAIN_B)])).to("cuda")
    labels = torch.tensor([0] * 6 + [1] * 6).to(x.device)

    def flat(params):
        return torch.cat([p.grad.reshape(-1).float() for p in params
                          if p.grad is not None])

    def step(fields, upstream=None):
        """(loss, the whole model's gradient, the features, dloss/dfeatures,
        the encoder's gradient from `upstream` (else from dloss/dfeatures),
        ms of the step)."""
        set_xlsr_cfg(model, dataclasses.replace(xcfg, **fields))
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = model.ssl_model(x)
        leaf = feats.detach().requires_grad_()
        emb, logits = model.backend(leaf, None)
        loss, _ = group_one_class_loss(emb, logits, labels, 0.1, 0.9,
                                       TRAIN_B)
        loss.backward()
        feats.backward(leaf.grad)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        whole = flat(model.parameters())
        enc = flat(enc_params)
        if upstream is not None:
            model.zero_grad(set_to_none=True)
            feats = model.ssl_model(x)
            feats.backward(upstream)
            enc = flat(enc_params)
        return (float(loss.detach()), whole, feats.detach(), leaf.grad,
                enc, ms)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    cases = {
        "fused_qkv": (dict(fused_qkv=True, attention_impl="flash"),
                      dict(attention_impl="flash")),
        "packed": (dict(attention_impl="packed"), {}),
        "packed8": (dict(attention_impl="packed8"), {}),
        "pad128": (dict(attention_impl="pad128"), {}),
        "xla_merged": (dict(attention_impl="xla_merged"), {}),
        "pos_batched": (dict(pos_conv_impl="batched"), {}),
        "pos_s2d": (dict(pos_conv_impl="s2d"), {}),
    }
    out, failures, base = {}, [], {}
    for name, (fields, default) in cases.items():
        key = str(sorted(default.items()))
        if key not in base:
            step(default)  # a warm-up of the default path
            base[key] = step(default)
        loss0, whole0, f0, up0, enc0, ms0 = base[key]
        step(fields, up0)
        loss, whole, f, _, enc, ms = step(fields, up0)
        out[name] = dict(loss=loss, default_loss=loss0,
                         grad_rel_l2=rel(whole, whole0),
                         encoder_feats_rel_l2=rel(f, f0),
                         encoder_grad_rel_l2=rel(enc, enc0),
                         ms=ms, default_ms=ms0)
        print(f"[extras] train step {name} (DEPTH {DEPTH} layers, 12 x 6 s) "
              f"against {default or 'the defaults'}: {out[name]}",
              flush=True)
        if not (math.isfinite(loss)
                and abs(loss - loss0) <= LOSS_RTOL * abs(loss0)
                and out[name]["encoder_feats_rel_l2"] <= LOSS_RTOL
                and out[name]["encoder_grad_rel_l2"] <= LOSS_RTOL):
            failures.append(f"{name}: {out[name]}")
    del model, base
    gc.collect()
    torch.cuda.empty_cache()
    if failures:
        fail("extras layouts training: " + "; ".join(failures))
    return out


def extras_pgd(model, xcfg) -> dict:
    """PGD_STEPS targeted PGD steps through the scorer's AModel in eval
    mode (flash attention, ln_impl "pallas": each step's input gradient
    runs the flash forward and backward and the LayerNorm backward
    kernels) on 8 x 4 s, each toward the class the model does not pick,
    from a seeded CUDA generator's start: x_adv within eps and [-1, 1],
    the target's mean log-probability up, ms a step, each kernel's
    launches a step exact."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.attack import pgd_attack

    pxcfg = dataclasses.replace(xcfg, attention_impl="flash",
                                ln_impl="pallas")
    set_xlsr_cfg(model, pxcfg)
    rng = np.random.default_rng(20)
    x = torch.from_numpy(np.stack([synthetic_wave(rng, PGD_SECONDS)
                                   for _ in range(8)])).to("cuda")
    eps = 8 / 255

    def logits_fn(xx):
        return model(xx)[1].float()

    def target_logp(xx):
        with torch.no_grad():
            logp = F.log_softmax(logits_fn(xx), -1)
        return float(logp.gather(1, target[:, None]).mean())

    total = {}

    def take():
        """The launches since the last take, added to the total."""
        got = read_counts()
        for k, n in got.items():
            total[k] = total.get(k, 0) + n
        reset_counts()
        return got

    try:
        reset_counts()
        with torch.no_grad():  # toward the class the model does not pick
            target = logits_fn(x).argmin(-1)
        before = target_logp(x)
        gen = torch.Generator(device=x.device).manual_seed(0)
        pgd_attack(logits_fn, x, target, gen, eps=eps, steps=1)  # warm-up
        take()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_adv = pgd_attack(logits_fn, x, target, gen, eps=eps,
                           steps=PGD_STEPS)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / PGD_STEPS
        counts = take()
        after = target_logp(x_adv)
        take()
    finally:
        set_xlsr_cfg(model, xcfg)
    layers = xcfg.encoder_layers
    # the random start's forward is part of no step: each step is one
    # forward and one backward of the model
    want = {"flash_attn_fwd": PGD_STEPS * layers,
            "flash_attn_bwd_dq": PGD_STEPS * layers,
            "flash_attn_bwd_dkv": PGD_STEPS * layers,
            "layernorm_bwd": PGD_STEPS * 2 * layers,
            "flash_attn_bwd_dout_copies": 0}
    dist = float((x_adv - x).abs().max())
    out = dict(ms_per_step=ms, target_logp_before=before,
               target_logp_after=after, max_abs_perturbation=dist,
               eps=eps, launches={k: counts[k] for k in want})
    print(f"[extras] PGD {PGD_STEPS} steps through AModel (eval, flash, "
          f"ln_impl pallas) on 8 x {PGD_SECONDS:g} s: {ms:.1f} ms a step, "
          f"target log-prob {before:.5f} -> {after:.5f}, max |x_adv - x| "
          f"{dist:.6f} (eps {eps:.6f}), launches {out['launches']}",
          flush=True)
    if not (dist <= eps + 1e-6 and float(x_adv.abs().max()) <= 1.0
            and after > before and out["launches"] == want):
        fail(f"extras PGD: {out}, want launches {want}")
    return dict(out, counts=total)


def extras_features() -> dict:
    """Every extractor of `audio.features` on the card (fp32, batched)
    against the same extractor on the CPU in fp64 (FEATURE_TOL), with ms
    per utterance on the card (CUDA events) and seconds on the CPU."""
    import torch

    from occm_tpu_torch.audio import features as Fe

    rng = np.random.default_rng(21)
    waves = np.stack([synthetic_wave(rng, FEATURE_SECONDS)
                      for _ in range(FEATURE_BATCH)])
    out, failures = {}, []
    for name, (kind, tol) in FEATURE_TOL.items():
        fn = getattr(Fe, name)
        batch = 2 if name in ("extract_cwt", "extract_ssqcwt") else len(waves)
        x = torch.from_numpy(waves[:batch])
        t0 = time.perf_counter()
        want = fn(x.double(), SR)
        cpu_s = time.perf_counter() - t0
        xc = x.to("cuda")
        got = fn(xc, SR)
        ms = cuda_ms(lambda: fn(xc, SR), iters=3, warmup=1) / batch
        got, want = got.cpu(), want.to(got.dtype).cpu()
        scale = float(want.abs().max())
        if kind == "rel_max":
            err = float((got - want).abs().max()) / scale
        elif kind == "abs":
            err = float((got - want).abs().max())
        else:
            cols = float((got.sum(-2) - want.sum(-2)).abs().max()) / float(
                want.sum(-2).abs().max())
            err = float(((got - want).abs() > 1e-4 * scale).float().mean())
            if cols > 1e-4:
                failures.append(f"{name}: columns' sums {cols}")
        out[name] = dict(shape=list(got.shape), err=err, tol=tol,
                         kind=kind, ms_per_utterance=ms, cpu_fp64_s=cpu_s,
                         utterances=batch)
        print(f"[extras] {name} on the card (fp32) vs the CPU (fp64), "
              f"{batch} x {FEATURE_SECONDS:g} s: {out[name]}", flush=True)
        if not (torch.isfinite(got).all() and err <= tol):
            failures.append(f"{name}: {out[name]}")
    if failures:
        fail("extras features: " + "; ".join(failures))
    return out


def extras_svm(model) -> dict:
    """The linear SVM on the scorer's embeddings (SVM_UTTERANCES of 4 s:
    half tones, half tones under loud noise), fit on the card and on the
    CPU on the same epoch orders: seconds of each, the share of equal
    predictions (at least SVM_AGREE), the training accuracy."""
    import torch

    from occm_tpu_torch.models.linearsvc import SGD

    rng = np.random.default_rng(22)
    waves = [synthetic_wave(rng, 4.0) for _ in range(SVM_UTTERANCES)]
    for w in waves[SVM_UTTERANCES // 2:]:
        w += 0.3 * rng.standard_normal(w.shape[0]).astype(np.float32)
    y = np.array([0] * (SVM_UTTERANCES // 2) + [1] * (SVM_UTTERANCES // 2))
    embs = []
    with torch.no_grad():
        for i in range(0, SVM_UTTERANCES, 8):
            xb = torch.from_numpy(np.stack(waves[i:i + 8])).to("cuda")
            embs.append(model(xb, attention_impl="flash")[0].float().cpu())
    X = torch.cat(embs).numpy()
    gen = torch.Generator().manual_seed(0)
    orders = [torch.randperm(len(y), generator=gen).numpy()
              for _ in range(SVM_EPOCHS)]
    fits = {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits[device] = SGD(X, y, epochs=SVM_EPOCHS, device=device,
                           orders=orders)
        fits[device + "_s"] = time.perf_counter() - t0
    pc, pp = fits["cuda"].predict(X), fits["cpu"].predict(X)
    w_rel = float(np.linalg.norm(fits["cuda"]._w - fits["cpu"]._w)
                  / np.linalg.norm(fits["cpu"]._w))
    out = dict(utterances=len(y), dim=int(X.shape[1]), epochs=SVM_EPOCHS,
               updates=len(y) * SVM_EPOCHS, cuda_s=fits["cuda_s"],
               cpu_s=fits["cpu_s"], agree=float(np.mean(pc == pp)),
               w_rel_l2=w_rel, accuracy=fits["cuda"].evaluate(X, y))
    print(f"[extras] linear SVM on {len(y)} embeddings of dim "
          f"{X.shape[1]}, {SVM_EPOCHS} epochs ({out['updates']} sequential "
          f"updates): {out}", flush=True)
    if not out["agree"] >= SVM_AGREE:
        fail(f"extras SVM: the card's and the CPU's predictions: {out}")
    return out


def extras_profiling(model, workdir: str) -> dict:
    """`utils.profiling.profile_trace` around one 8 x 6 s scoring batch
    (flash): its trace file under the logdir names the flash kernel, one
    event per layer (a session that lost records is taken again, up to 3
    times)."""
    import torch

    from occm_tpu_torch.utils.profiling import StepTimer, profile_trace

    rng = np.random.default_rng(23)
    x = torch.from_numpy(np.stack([synthetic_wave(rng, 6.0)
                                   for _ in range(8)])).to("cuda")
    timer = StepTimer(warmup=0)
    for attempt in range(3):
        logdir = os.path.join(workdir, f"trace_{attempt}")
        with torch.no_grad(), profile_trace(logdir), timer:
            model(x, attention_impl="flash")[0].sum().item()
        files = [f for f in os.listdir(logdir) if f.endswith(".json")]
        with open(os.path.join(logdir, files[0])) as f:
            events = json.load(f)["traceEvents"]
        flash = [e for e in events
                 if "flash_attn_fwd_kernel" in str(e.get("name", ""))]
        if len(flash) == model.ssl_model.model.cfg.encoder_layers:
            break
    out = dict(trace=files[0], trace_bytes=os.path.getsize(
        os.path.join(logdir, files[0])), events=len(events),
        flash_events=len(flash), attempts=attempt + 1,
        profiled_batch_s=timer.times[-1])
    print(f"[extras] profile_trace around one scoring batch: {out}",
          flush=True)
    if not flash:
        fail(f"extras profiling: the trace names no flash kernel: {out}")
    return out


def debug_nans_child(spec: str) -> int:
    """The --debug_nans run on NaN data (a process of its own): the CLI at
    DEPTH layers with the argv in `spec` (JSON); its FloatingPointError
    ends the process with a traceback."""
    from occm_tpu_torch.cli import oc_training

    with open(spec) as f:
        argv = json.load(f)
    with cli_at_depth():
        oc_training.main(argv)
    return 0


def extras_cli(workdir: str, fixture) -> dict:
    """oc_training at DEPTH layers on the fixture (6 steps, AASIST's
    dropouts on, deterministic algorithms): --debug_nans and
    --wandb_project p (wandb not importable) each bit for bit with the
    run without them (losses and weights); then --debug_nans
    --steps_per_dispatch CONTROL_K (the check after each CUDA graph chunk;
    the eager check ran in the run above) on a copy of the tree with one
    training utterance holding NaNs, in a process of its own: it must end
    with FloatingPointError and write no epoch checkpoint."""
    import importlib.util

    import torch

    from occm_tpu_torch.cli import oc_training

    protocol, train_dir, voc_dir = fixture
    root = os.path.join(workdir, "extras_cli")
    os.makedirs(root)
    base = ["--train_protocol_file", protocol, "--train_dataset_dir",
            train_dir, "--vocoded_dir", voc_dir, "--cut", str(TRAIN_CUT),
            "--num_epochs", "1", "--compactness_weight", "0.1",
            "--descriptiveness_weight", "0.9"]
    runs, counts = {}, {}
    cwd = os.getcwd()
    os.chdir(root)
    torch.use_deterministic_algorithms(True, warn_only=True)
    installed = importlib.util.find_spec("wandb") is not None
    try:
        for name, extra in (("plain", []), ("debug_nans", ["--debug_nans"]),
                            ("wandb", ["--wandb_project", "p"])):
            rec = StepRecorder()
            t0 = time.perf_counter()
            # the run "with no wandb installed": `import wandb` fails inside
            # it, whether or not the machine has wandb (a wandb run would
            # try to reach its server, and this machine has no network)
            saved = sys.modules.get("wandb")
            sys.modules["wandb"] = None
            try:
                with cli_at_depth():
                    state = oc_training.main(
                        base + extra + ["--checkpoint_dir",
                                        os.path.join(root, "ck_" + name)],
                        on_step=rec)
            finally:
                if saved is None:
                    del sys.modules["wandb"]
                else:
                    sys.modules["wandb"] = saved
            secs = time.perf_counter() - t0
            for k, n in read_counts().items():
                counts[k] = counts.get(k, 0) + n
            reset_counts()
            runs[name] = dict(losses=[st["loss"] for st in rec.steps],
                              s=secs, w=_flat(p for _, p in
                                              state.named_params()).cpu())
            del state
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(False)
        os.chdir(cwd)
    out = {"wandb_installed": installed}
    failures = []
    for name in ("debug_nans", "wandb"):
        same = (runs[name]["losses"] == runs["plain"]["losses"]
                and torch.equal(runs[name]["w"], runs["plain"]["w"]))
        out[name] = dict(bit_for_bit=same, s=runs[name]["s"],
                         losses=runs[name]["losses"])
        if not same or len(runs[name]["losses"]) != 6:
            failures.append(f"{name}: {out[name]} vs the plain run's "
                            f"{runs['plain']['losses']}")
    out["plain"] = dict(s=runs["plain"]["s"], losses=runs["plain"]["losses"])
    print(f"[extras] oc_training (DEPTH {DEPTH} layers, 6 steps) with "
          f"--debug_nans and with --wandb_project p (wandb installed: "
          f"{installed}; its import blocked in every run) against the plain "
          f"run: {out}",
          flush=True)

    # ---- NaN data in a process of its own
    nan_root = os.path.join(root, "nan_tree")
    os.makedirs(nan_root)
    nan_fixture = write_fixture(nan_root)
    wave = synthetic_wave(np.random.default_rng(24), 6.5)
    wave[1000:1010] = np.nan
    float_wav(os.path.join(nan_fixture[1], "LA_T_b0003.wav"), wave)
    ck = os.path.join(root, "ck_nan")
    spec = os.path.join(root, "nan_argv.json")
    with open(spec, "w") as f:
        json.dump(["--train_protocol_file", nan_fixture[0],
                   "--train_dataset_dir", nan_fixture[1], "--vocoded_dir",
                   nan_fixture[2]] + base[6:]
                  + ["--debug_nans", "--steps_per_dispatch", str(CONTROL_K),
                     "--checkpoint_dir", ck], f)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--debug-nans-child",
         spec], capture_output=True, text=True, timeout=300, cwd=root)
    tail = proc.stderr.strip().splitlines()[-1] if proc.stderr else ""
    written = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    out["nan_run"] = dict(rc=proc.returncode, last_line=tail,
                          s=time.perf_counter() - t0, checkpoints=written)
    print(f"[extras] oc_training --debug_nans --steps_per_dispatch "
          f"{CONTROL_K} on a tree with NaN samples (own process; the check "
          f"after each CUDA graph chunk): {out['nan_run']}", flush=True)
    if (proc.returncode == 0 or not tail.startswith("FloatingPointError")
            or "NaN in" not in tail or "aasist_vocoded_0.pt" in written):
        failures.append(f"NaN run: {out['nan_run']}; stdout "
                        f"{proc.stdout[-500:]!r}")
    if failures:
        fail("extras cli: " + "; ".join(failures))
    return dict(out, counts=counts)


def phase_extras(workdir: str, fixture, model) -> tuple:
    """Phase 18: the rest of ROADMAP item 16 on the card (see the module
    docstring). `model` is the seed model (full width, eval). Returns
    (launches by kernel, the record)."""
    import torch

    t0 = time.perf_counter()
    xcfg = model.ssl_model.model.cfg
    out = {}
    total = {}

    def add(counts):
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n

    reset_counts()
    out["layouts_scoring"] = layouts_scoring(model, xcfg)
    add(read_counts())
    reset_counts()
    out["layouts_training"] = layouts_training()
    add(read_counts())
    reset_counts()
    pgd = extras_pgd(model, xcfg)
    add(pgd.pop("counts"))
    out["pgd"] = pgd
    out["features"] = extras_features()
    reset_counts()
    out["svm"] = extras_svm(model)
    out["profiling"] = extras_profiling(model, workdir)
    add(read_counts())
    reset_counts()
    cli = extras_cli(workdir, fixture)
    add(cli.pop("counts"))
    out["cli"] = cli
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"[extras] phase 18: {out['wall_s']:.1f} s", flush=True)
    return total, out


# --------------------------------------------------------------- phase 20

# The generic attention kernels, the 3xTF32 attention forward and backward
# and the fp32 FFN kernels (KERNEL_NAMES' form: wrapper counter -> (device
# kernel name, device launches a call))
COVERAGE_KERNEL_NAMES = {
    "flash_attn_3xtf32_fwd": ("flash_attn_fwd_3xtf32_kernel", 1),
    "flash_attn_generic_fwd": ("flash_attn_generic_fwd_kernel", 1),
    "flash_attn_generic_bwd_dq": ("flash_attn_generic_dq_kernel", 1),
    "flash_attn_generic_bwd_dkv": ("flash_attn_generic_dkv_kernel", 1),
    "flash_attn_3xtf32_bwd_dq": ("flash_attn_3xtf32_dq_kernel", 1),
    "flash_attn_3xtf32_bwd_dkv": ("flash_attn_3xtf32_dkv_kernel", 1),
    "ffn_fwd_f32": ("ffn_gemm_f32_kernel", 2),
    "ffn_fwd_3xtf32": ("ffn_gemm_3xtf32_kernel", 2)}
# the ones phase 20's paths launch: the fp32 model's shapes (D 64, D 16;
# D and F multiples of 4) go to the 3xTF32 kernels, so the generic
# attention kernels and the SIMT FFN, which keep every other fp32 shape,
# are held in the kernel checks only
COVERAGE_PATH_KERNELS = ("flash_attn_3xtf32_fwd", "flash_attn_3xtf32_bwd_dq",
                         "flash_attn_3xtf32_bwd_dkv", "ffn_fwd_3xtf32")
# (dtype, D, H, Ts) of the generic attention checks: fp32 at XLS-R's head
# dim and at the tiny model's (D 16, H 4), bf16 at head dims other than 64:
# at D 16, 32, 80 and 128, which the wgmma instances now take, called on
# the generic kernels directly (the "was" of phase 21's rows); at D 132,
# not a multiple of 8 and so still the generic route's in bf16 (D 136 was
# until the wgmma instances reached 256), through the wrappers and autograd
COVERAGE_ATTENTION = (("float32", 64, 16, KERNEL_TS),
                      ("float32", 16, 4, (299,)),
                      *(("bfloat16", d, 16, (299, 1500))
                        for d in (16, 32, 80, 128)),
                      ("bfloat16", 132, 16, (299,)))
# generic kernels vs their plain version on the same fp32 inputs: the plain
# version repeats the kernels' arithmetic, so the two differ only by the
# order of fp32 sums (each of up to T * D products, relative ~1e-7, read
# 4e-7 on the H100); 1e-5 of the largest |value| holds that and fails on a
# wrong tile, mask or scale (those move whole rows). The 3xTF32 backward
# adds its split (the dropped lo lo term, below 2^-20 of each product) and
# the tensor cores' accumulation, which it restarts each 64-row tile (read
# up to 6.4e-6 on the H100 at T 1500); one TF32 product alone is off by
# up to 2^-10 and fails the bound. bf16 keeps phase 3's
# bounds (OUT_ATOL, LSE_ATOL, BWD_RTOL_OF_MAX): the plain version on the
# same bf16 inputs rounds P from the final row max, the kernel from the
# running one (one bf16 rounding of P, 2^-9 relative), and an output's
# rounding may flip by one bf16 ulp.
COVERAGE_F32_RTOL_OF_MAX = 1e-5
# fp32 FFN kernels vs their plain version: the SIMT kernel's fp32 sums of
# up to F = 4096 products in another order, ~sqrt(F) 2^-24 ~ 4e-6 of the
# terms' size (read 3e-6 of the largest |y| on the H100); the 3xTF32
# kernel adds its split (below 2^-20 of each product) and the tensor
# cores' accumulation, which it restarts every K 256 (read up to 5.2e-6
# on the H100; one accumulator over K 4096 read 4.7e-5); 1e-4 of the
# largest |y| holds both and fails on a wrong tile or bias (O(1) moves of
# whole rows or columns), and on one TF32 product (2^-10)
FFN_F32_RTOL_OF_MAX = 1e-4
FFN_F32_CASES = ((8 * 299, 1024, 4096, False), (8 * 299, 1024, 4096, True),
                 (12 * 299, 1024, 4096, False),
                 (12 * 299, 1024, 4096, True), (1000, 1000, 4000, False))
# an fp32 FFN whose D and F are not multiples of 4: the wrapper keeps the
# SIMT kernel there (TMA needs 16-byte row strides)
FFN_F32_SIMT_CASE = (1000, 1002, 4002, False)
# the fp32 model through the kernels vs the same weights through plain
# attention and the plain FFN, both fp32 with TF32 off: summation order
# only, ~1e-6 relative a layer through 24 layers and AASIST; 1e-3 relative
# holds that and fails on any structural fault (a wrong mask, scale or
# layout moves a distance by far more). The training step's loss and the
# encoder's features and gradient (relative L2) are held to the same bound.
COVERAGE_MODEL_RTOL = 1e-3
COVERAGE_SECONDS = (1, 2, 6, 12)


def coverage_attention_bound(bh: int, t: int, d: int, dtype: str,
                             backward: bool = False):
    """Least time of one call on an H100: (bound_ms, bound_by, flops,
    bytes). Forward: two products of 2 T^2 D flops a (b, h), q, k, v read
    and out written once, lse written once; backward: five products, q, k,
    v, o, dO read and dq, dk, dv written once, lse read once. fp32 as
    3xTF32 on the tensor cores (three TF32 products each, 495 TFLOP/s),
    bf16 at the tensor cores' 989."""
    elt = 4 if dtype == "float32" else 2
    flops = (10.0 if backward else 4.0) * bh * t * t * d
    nbytes = (8.0 if backward else 4.0) * bh * t * d * elt + bh * t * 4
    t_ops = (3 * flops / PEAK_TF32_FLOPS if dtype == "float32"
             else flops / PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def ffn_f32_bound(m: int, d: int, f: int):
    """ffn_bound in fp32: 4 M D F flops as 3xTF32 (three TF32 products
    each at 495 TFLOP/s); x, W1, W2, b1, b2 read and y written once in
    fp32."""
    flops = 4.0 * m * d * f
    nbytes = 4.0 * (2 * m * d + 2 * d * f + f + d)
    t_ops = 3 * flops / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def _abs_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _rel_of_max(a, b) -> float:
    return _abs_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def coverage_attention_rows():
    """The generic attention kernels and the 3xTF32 forward and backward
    against their plain versions on the card at COVERAGE_ATTENTION's
    shapes: forward at B 8 (and at fp32 D 64, T 299 also at the training
    step's B 12), backward at B 12 (TRAIN_B), each on [B, T, H, D] views
    of one projection output and on [B*H, T, D] copies (bit for bit, and a
    repeat bit for bit), the backward as two device launches a call and
    nothing else, and, where the CUDA routes take the shape to these
    kernels, through the wrappers and autograd (contiguous gradients,
    equal to the wrapper's; an expanded dO read where it lies, no copy);
    the shapes of the wgmma route are called on the generic kernels
    directly (generic_attention_fwd, _bwd). The fp32 forward takes the
    3xTF32 kernel (`cuda_route`) and the fp32 backward the 3xTF32 pair
    (`cuda_bwd_route`); the generic kernels, called directly on the same
    inputs, are held to the same bound and timed beside them ("was", a
    row of its own). Wrapper, device, plain, SDPA (same dtype, wrapper and
    device) and bound times. Returns (forward rows, backward rows); a
    row's "kernel" names its kernels line entry."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops import attention
    from occm_tpu_torch.ops.attention import (
        flash_attention_bwd_reference, flash_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(20)
    fwd_rows, bwd_rows = [], []
    for dtype, d, h, ts in COVERAGE_ATTENTION:
        dt = getattr(torch, dtype)
        route = attention.cuda_route(dt, d)
        routed = route in ("generic", "3xtf32")
        # the forward kernel the wrapper launches here (or, on the wgmma
        # route's shapes, the generic one called directly)
        fwd_kernel = ("flash_attn_3xtf32_fwd" if route == "3xtf32"
                      else "flash_attn_generic_fwd")
        flash_attention_fwd = (attention.flash_attention_fwd if routed
                               else generic_attention_fwd)
        flash_attention_bwd = (attention.flash_attention_bwd if routed
                               else generic_attention_bwd)
        # the kernel pair the backward wrapper launches here
        bwd_kernel = ("flash_attn_3xtf32" if routed and attention.
                      cuda_bwd_route(dt, d) == "3xtf32"
                      else "flash_attn_generic")
        for t in ts:
            passes = [(False, B), (True, TRAIN_B)]
            if route == "3xtf32" and d == 64 and t == MAIN_PATH_TS[0]:
                passes.insert(1, (False, TRAIN_B))  # the training step's
            for backward, b in passes:
                qkv = torch.randn((b, t, 3, h, d), generator=gen,
                                  device="cuda").to(dt)
                q4, k4, v4 = qkv.unbind(2)

                def flat(x):
                    return x.permute(0, 2, 1, 3).reshape(
                        b * h, t, d).contiguous()

                q, k, v = flat(q4), flat(k4), flat(v4)
                out4, lse4 = flash_attention_fwd(q4, k4, v4, t)
                out, lse = flash_attention_fwd(q, k, v, t)
                again = flash_attention_fwd(q4, k4, v4, t)
                torch.cuda.synchronize()
                label = f"{dtype} D={d} B={b} H={h} T={t}"
                if not (out4.shape == q4.shape and out4.is_contiguous()
                        and torch.equal(flat(out4), out)
                        and torch.equal(lse4, lse)
                        and torch.equal(again[0], out4)
                        and torch.equal(again[1], lse4)):
                    fail(f"{fwd_kernel} {label}: views, [B*H, T, D] and "
                         "a repeat do not agree bit for bit")
                was = None
                if not backward:
                    kernel = fwd_kernel
                    ref_out, ref_lse = flash_attention_reference(q, k, v, t)

                    def fwd_errs(o, l, who):
                        if dtype == "float32":
                            errs = {"out": _rel_of_max(o, ref_out),
                                    "lse": _rel_of_max(l, ref_lse)}
                            bad = max(errs.values()) > COVERAGE_F32_RTOL_OF_MAX
                        else:
                            errs = {"out": (o.float() - ref_out.float()).abs()
                                    .max().item(),
                                    "lse": (l - ref_lse).abs().max().item()}
                            bad = (errs["out"] > OUT_ATOL
                                   or errs["lse"] > LSE_ATOL)
                        if bad or not all(map(math.isfinite, errs.values())):
                            fail(f"{who} {label} against its plain version: "
                                 f"{errs}")
                        return errs, max(_abs_err(o, ref_out),
                                         _abs_err(l, ref_lse))

                    errs, abs_err = fwd_errs(out, lse, kernel)
                    call = (lambda: flash_attention_fwd(q4, k4, v4, t))
                    names = (("flash_attn_fwd_3xtf32",)
                             if kernel == "flash_attn_3xtf32_fwd"
                             else ("flash_attn_generic_fwd",))
                    counters = (kernel,)
                    if kernel == "flash_attn_3xtf32_fwd":
                        # the generic forward it took over from, on these
                        # inputs
                        was_call = (lambda: generic_attention_fwd(
                            q4, k4, v4, t))
                        w_out, w_lse = was_call()
                        was_errs, was_abs = fwd_errs(
                            flat(w_out), w_lse, "flash_attn_generic_fwd")
                        was_dev, _, _, was_kept = device_ms(
                            was_call, ("flash_attn_generic_fwd",), warmup=1,
                            counters=("flash_attn_generic_fwd",))
                        was = dict(kernel="flash_attn_generic_fwd",
                                   max_abs_err=was_abs, errors=was_errs,
                                   ms=cuda_ms(was_call, iters=10 if t <= 600
                                              else 4, warmup=2),
                                   device_ms=was_dev,
                                   **events_kept(was_kept))
                    plain = (lambda: flash_attention_reference(q, k, v, t))
                    q3, k3, v3 = (x.view(b, h, t, d) for x in (q, k, v))

                    def library():
                        with torch.no_grad():
                            F.scaled_dot_product_attention(q3, k3, v3)
                else:
                    kernel = f"{bwd_kernel}_bwd"
                    do4 = torch.randn((b, t, h, d), generator=gen,
                                      device="cuda").to(dt)
                    do = flat(do4)
                    got4 = flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
                    rep = flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
                    got = flash_attention_bwd(q, k, v, out, lse, do, t)
                    torch.cuda.synchronize()
                    for name, a, r, c in zip(("dq", "dk", "dv"), got4, rep,
                                             got):
                        if not (a.shape == q4.shape and a.is_contiguous()
                                and torch.equal(a, r)
                                and torch.equal(flat(a), c)):
                            fail(f"{kernel} {label}: {name} of views,"
                                 " [B*H, T, D] and a repeat do not agree "
                                 "bit for bit, or is not contiguous")
                    want = flash_attention_bwd_reference(q, k, v, out, lse,
                                                         do, t)
                    rtol = (COVERAGE_F32_RTOL_OF_MAX if dtype == "float32"
                            else BWD_RTOL_OF_MAX)

                    def held(grads, who):
                        errs = {n: _rel_of_max(a, w) for n, a, w
                                in zip(("dq", "dk", "dv"), grads, want)}
                        if not all(math.isfinite(e) and e <= rtol
                                   for e in errs.values()):
                            fail(f"{who} {label} against its plain version: "
                                 f"{errs} (relative to the largest |value|, "
                                 f"bound {rtol})")
                        return errs, max(_abs_err(a, w)
                                         for a, w in zip(grads, want))

                    errs, abs_err = held(got, kernel)
                    if t == MAIN_PATH_TS[0] and routed:
                        coverage_autograd(
                            q4, k4, v4, do4, got4, f"{kernel} {label}",
                            (f"{bwd_kernel}_bwd_dq", f"{bwd_kernel}_bwd_dkv"))
                    call = (lambda: flash_attention_bwd(
                        q4, k4, v4, out4, lse4, do4, t))
                    names = (f"{bwd_kernel}_d",)
                    counters = (f"{bwd_kernel}_bwd_dq",
                                f"{bwd_kernel}_bwd_dkv")
                    if bwd_kernel == "flash_attn_3xtf32":
                        # the generic pair it took over from, on these inputs
                        was_call = (lambda: generic_attention_bwd(
                            q4, k4, v4, out4, lse4, do4, t))
                        was_errs, was_abs = held(
                            tuple(flat(g) for g in was_call()),
                            "flash_attn_generic_bwd")
                        was_dev, own, every, was_kept = device_ms(
                            was_call, ("flash_attn_generic_d",), warmup=1,
                            counters=("flash_attn_generic_bwd_dq",
                                      "flash_attn_generic_bwd_dkv"))
                        if (own, every) != (2, 2):
                            fail(f"flash_attn_generic_bwd {label}: {every} "
                                 f"device launches a call ({own} of the "
                                 "kernels), want 2")
                        was = dict(kernel="flash_attn_generic_bwd",
                                   max_abs_err=was_abs, errors=was_errs,
                                   ms=cuda_ms(was_call, iters=10 if t <= 600
                                              else 4, warmup=2),
                                   device_ms=was_dev,
                                   **events_kept(was_kept))
                    plain = (lambda: flash_attention_bwd_reference(
                        q, k, v, out, lse, do, t))
                    q3, k3, v3 = (x.view(b, h, t, d).detach()
                                  .requires_grad_() for x in (q, k, v))
                    do3 = do.view(b, h, t, d)

                    def library():
                        o3 = F.scaled_dot_product_attention(q3, k3, v3)
                        torch.autograd.grad(o3, (q3, k3, v3), do3)

                # fewer timed calls where one takes milliseconds (T 1500);
                # the profiler's sessions keep device_ms' 20 calls, the
                # count at which a session one record short is accepted
                iters = 10 if t <= 600 else 4
                ms = cuda_ms(call, iters=iters, warmup=2)
                dev_ms, own, every, kept = device_ms(
                    call, names, warmup=1, counters=counters)
                if backward and (own, every) != (2, 2):
                    fail(f"{kernel} {label}: {every} device launches a call "
                         f"({own} of the kernels), want 2 (dq, dk/dv) and "
                         "no other")
                plain_ms = cuda_ms(plain, iters=2, warmup=1)
                library_ms = cuda_ms(library, iters=iters, warmup=2)
                library_dev = library_device_ms(library, warmup=1)
                if backward:
                    with torch.no_grad():
                        fwd_only = (lambda: F.scaled_dot_product_attention(
                            q3, k3, v3))
                        library_ms -= cuda_ms(fwd_only, iters=5, warmup=2)
                        library_dev -= library_device_ms(fwd_only, warmup=1)
                bound_ms, bound_by, flops, nbytes = coverage_attention_bound(
                    b * h, t, d, dtype, backward)
                # errors: fp32 relative to the largest |value|; bf16
                # forward absolute, bf16 backward relative (as gated)
                shared = dict(dtype=dtype, D=d, B=b, H=h, T=t,
                              plain_ms=plain_ms, library_ms=library_ms,
                              library_device_ms=library_dev,
                              bound_ms=bound_ms, bound_by=bound_by,
                              flops=flops, bytes=nbytes)
                row = dict(shared, kernel=kernel, max_abs_err=abs_err,
                           errors=errs, ms=ms, device_ms=dev_ms,
                           **events_kept(kept))
                rows = bwd_rows if backward else fwd_rows
                rows.append(row)
                if was is not None:
                    rows.append(dict(shared, **was))
                    row["was_ms"], row["was_device_ms"] = (
                        was["ms"], was["device_ms"])
                print(f"[coverage] {kernel} {label}: errors "
                      f"{ {k: f'{e:.3e}' for k, e in errs.items()} }; views "
                      f"= [B*H, T, D] = repeat bit for bit"
                      f"{', 2 device launches a call' if backward else ''}; "
                      f"wrapper {ms:.4f} ms, device {dev_ms:.4f} ms"
                      + ("" if was is None else
                         f" (was: {was['kernel']} {was['ms']:.4f} ms, "
                         f"device {was['device_ms']:.4f} ms, errors "
                         + str({k: f"{e:.3e}"
                                for k, e in was["errors"].items()}) + ")")
                      + f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms "
                      f"(device {library_dev:.4f}), bound {bound_ms:.4f} ms "
                      f"({bound_by}; {flops:.4g} flop, {nbytes:.4g} B)",
                      flush=True)
                del qkv, q, k, v, out, lse, out4, lse4, again
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def coverage_route_sweep():
    """The measurement behind attention.TF32_BWD_HEAD_DIMS: the fp32
    backward at B 12, H 16, T 299 for every head dim that is a multiple of
    8 from 8 to 128, through the wrapper (the 3xTF32 pair, held to
    COVERAGE_F32_RTOL_OF_MAX against the plain version) and on the generic
    pair called directly, wrapper ms (CUDA events) of each in turns.
    Returns the rows."""
    import torch

    from occm_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(22)
    rows = []
    b, h, t = TRAIN_B, H, MAIN_PATH_TS[0]
    for d in range(8, 129, 8):
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
        q4, k4, v4 = qkv.unbind(2)
        out4, lse4 = attention.flash_attention_fwd(q4, k4, v4, t)
        do4 = torch.randn((b, t, h, d), generator=gen, device="cuda")
        reset_counts()
        got = attention.flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
        counts = read_counts()
        want = attention.flash_attention_bwd_reference(q4, k4, v4, out4,
                                                       lse4, do4, t)
        err = max(_rel_of_max(a, w) for a, w in zip(got, want))
        routed = (counts["flash_attn_3xtf32_bwd_dq"],
                  counts["flash_attn_generic_bwd_dq"]) == (1, 0)
        if not (routed and math.isfinite(err)
                and err <= COVERAGE_F32_RTOL_OF_MAX):
            fail(f"fp32 backward D={d}: launches {counts}, error {err:.3e} "
                 f"of the largest |value| (bound {COVERAGE_F32_RTOL_OF_MAX})")
        new = (lambda: attention.flash_attention_bwd(q4, k4, v4, out4, lse4,
                                                     do4, t))
        old = (lambda: generic_attention_bwd(q4, k4, v4, out4, lse4, do4, t))
        times = {"3xtf32": [], "generic": []}
        for key, fn in (("3xtf32", new), ("generic", old), ("generic", old),
                        ("3xtf32", new)):
            times[key].append(cuda_ms(fn, iters=10, warmup=2))
        row = dict(D=d, B=b, H=h, T=t, rel_of_max=err,
                   ms=min(times["3xtf32"]), generic_ms=min(times["generic"]))
        rows.append(row)
        print(f"[coverage] fp32 backward D={d} B={b} H={h} T={t}: 3xTF32 "
              f"{row['ms']:.4f} ms, generic {row['generic_ms']:.4f} ms "
              f"(wrappers, in turns), error {err:.3e}", flush=True)
        del qkv, out4, lse4, do4, got, want
    slower = [r["D"] for r in rows if r["ms"] > r["generic_ms"]]
    print(f"[coverage] the 3xTF32 backward is slower than the generic pair "
          f"at D {slower} (attention.TF32_BWD_HEAD_DIMS routes "
          f"{list(attention.TF32_BWD_HEAD_DIMS)} to it)", flush=True)
    torch.cuda.empty_cache()
    return rows


# (D, H) of the forward's route sweep: every head dim that is a multiple of
# 8 up to 128 at XLS-R's 16 heads, and the tiny model's D 16 at its 4
COVERAGE_FWD_SWEEP = (*((d, H) for d in range(8, 129, 8)), (16, 4))


def tf32_attention_fwd(q, k, v, t):
    """The 3xTF32 forward kernel on q, k, v whatever `cuda_route` picks
    for them (csrc/flash_attn_fwd_3xtf32.cu)."""
    from occm_tpu_torch.ops import attention

    four_d = q.dim() == 4
    B, T, H, D = q.shape if four_d else (q.shape[0], q.shape[1], 1,
                                         q.shape[2])
    return attention._tf32_fwd(q, k, v, t, four_d, B, H, T, D)


def coverage_fwd_route_sweep():
    """The measurement behind attention.TF32_FWD_HEAD_DIMS: the fp32
    forward at B 8, T 299 and COVERAGE_FWD_SWEEP's (D, H), the 3xTF32
    kernel and the generic one each called directly (both held to
    COVERAGE_F32_RTOL_OF_MAX against the plain version), wrapper ms (CUDA
    events) of each in turns and device ms (torch.profiler), and the route
    the wrapper takes there. Returns the rows."""
    import torch

    from occm_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(23)
    rows = []
    b, t = B, MAIN_PATH_TS[0]
    for d, h in COVERAGE_FWD_SWEEP:
        qkv = torch.randn((b, t, 3, h, d), generator=gen, device="cuda")
        q4, k4, v4 = qkv.unbind(2)
        flat = [x.permute(0, 2, 1, 3).reshape(b * h, t, d)
                for x in (q4, k4, v4)]
        ref_out, ref_lse = attention.flash_attention_reference(*flat, t)
        ref_out = ref_out.view(b, h, t, d).permute(0, 2, 1, 3)
        new = (lambda: tf32_attention_fwd(q4, k4, v4, t))
        old = (lambda: generic_attention_fwd(q4, k4, v4, t))
        errs = {}
        for key, fn in (("3xtf32", new), ("generic", old)):
            out, lse = fn()
            errs[key] = max(_rel_of_max(out, ref_out),
                            _rel_of_max(lse, ref_lse))
        if not all(math.isfinite(e) and e <= COVERAGE_F32_RTOL_OF_MAX
                   for e in errs.values()):
            fail(f"fp32 forward D={d} H={h}: errors {errs} of the largest "
                 f"|value| (bound {COVERAGE_F32_RTOL_OF_MAX})")
        times = {"3xtf32": [], "generic": []}
        for key, fn in (("3xtf32", new), ("generic", old), ("generic", old),
                        ("3xtf32", new)):
            times[key].append(cuda_ms(fn, iters=10, warmup=2))
        dev = {key: device_ms(fn, (name,), warmup=1, counters=(counter,))[0]
               for key, fn, name, counter in (
                   ("3xtf32", new, "flash_attn_fwd_3xtf32",
                    "flash_attn_3xtf32_fwd"),
                   ("generic", old, "flash_attn_generic_fwd",
                    "flash_attn_generic_fwd"))}
        row = dict(D=d, B=b, H=h, T=t, rel_of_max=errs["3xtf32"],
                   generic_rel_of_max=errs["generic"],
                   ms=min(times["3xtf32"]), generic_ms=min(times["generic"]),
                   device_ms=dev["3xtf32"], generic_device_ms=dev["generic"],
                   route=attention.cuda_route(torch.float32, d))
        rows.append(row)
        print(f"[coverage] fp32 forward D={d} B={b} H={h} T={t}: 3xTF32 "
              f"{row['ms']:.4f} ms (device {row['device_ms']:.4f}), generic "
              f"{row['generic_ms']:.4f} ms (device "
              f"{row['generic_device_ms']:.4f}) (in turns), errors "
              f"{errs['3xtf32']:.3e} / {errs['generic']:.3e}; the wrapper's "
              f"route {row['route']}", flush=True)
        del qkv, ref_out, ref_lse, flat
    for key in ("ms", "device_ms"):
        slower = [(r["D"], r["H"]) for r in rows
                  if r[key] > r[f"generic_{key}"]]
        print(f"[coverage] the 3xTF32 forward's {key} is above the generic "
              f"one's at (D, H) {slower} (attention.TF32_FWD_HEAD_DIMS routes "
              f"{list(attention.TF32_FWD_HEAD_DIMS)} to it)", flush=True)
    torch.cuda.empty_cache()
    return rows


def coverage_autograd(q4, k4, v4, do4, want, label,
                      kernels=("flash_attn_generic_bwd_dq",
                               "flash_attn_generic_bwd_dkv")):
    """`flash_attention` through autograd on CUDA [B, T, H, D] views: one
    launch of each backward kernel the route takes (`kernels`: the generic
    or 3xTF32 pair, or a wgmma instance's counters) and none of any other
    attention backward kernel, contiguous gradients equal bit for bit to
    the backward wrapper's `want`; the expanded dO of `out.sum()` gives the
    gradients of a contiguous dO of ones, read where it lies on the generic
    and 3xTF32 routes and copied once on the wgmma route (its TMA maps
    cannot read stride 0)."""
    import torch

    from occm_tpu_torch.ops import attention

    backward = ("flash_attn_generic_bwd_dq", "flash_attn_generic_bwd_dkv",
                "flash_attn_3xtf32_bwd_dq", "flash_attn_3xtf32_bwd_dkv",
                "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                "flash_attn_bwd_other_d_dq", "flash_attn_bwd_other_d_dkv",
                "flash_attn_bwd_panel_dq", "flash_attn_bwd_panel_dkv")
    q, k, v = (x.detach().requires_grad_() for x in (q4, k4, v4))
    reset_counts()
    grads = torch.autograd.grad(attention.flash_attention(q, k, v),
                                (q, k, v), do4)
    torch.cuda.synchronize()
    counts = read_counts()
    want_counts = {key: int(key in kernels) for key in backward}
    if ({key: counts[key] for key in backward} != want_counts
            or counts["flash_attn_bwd_dout_copies"]):
        fail(f"{label}: autograd launched {counts}, want {want_counts} and "
             "no copy")
    for name, g, w in zip(("q", "k", "v"), grads, want):
        if not (g.is_contiguous() and torch.equal(g, w)):
            fail(f"{label}: {name}'s gradient through autograd is not the "
                 "backward kernels' contiguous one")
    out = attention.flash_attention(q, k, v)
    summed = torch.autograd.grad(out.sum(), (q, k, v), retain_graph=True)
    ones = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    torch.cuda.synchronize()
    copies = int(not any(k.startswith(("flash_attn_generic",
                                       "flash_attn_3xtf32"))
                         for k in kernels))
    if read_counts()["flash_attn_bwd_dout_copies"] != copies:
        fail(f"{label}: the expanded dO was copied "
             f"{read_counts()['flash_attn_bwd_dout_copies']} times, want "
             f"{copies}")
    if not all(torch.equal(a, b) for a, b in zip(summed, ones)):
        fail(f"{label}: the gradients of out.sum() are not those of a "
             "contiguous dO of ones")
    print(f"[autograd] flash_attention {label}: the kernels' contiguous "
          f"gradients ({', '.join(kernels)}), an expanded dO "
          f"{'read in place' if not copies else 'copied once'}", flush=True)


def coverage_ffn_rows():
    """ffn_fwd in fp32 against ffn_reference at FFN_F32_CASES: full width
    at M = 8 x 299 and 12 x 299 (erf and tanh GELU) and the edge (1000,
    1000, 4000), which the wrapper sends to the 3xTF32 kernel
    (csrc/ffn_fwd_3xtf32.cu: D and F multiples of 4), each timed beside
    its bound, the plain version (the same fp32 products), the library
    sequence F.linear -> F.gelu -> F.linear in fp32 and the SIMT kernel
    (csrc/ffn_fwd_f32.cu) on the same inputs ("was", a row of its own,
    held to the same bound); and the SIMT kernel through the wrapper at
    FFN_F32_SIMT_CASE, whose D and F it keeps."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops import _build, ffn
    from occm_tpu_torch.ops.ffn import ffn_fwd, ffn_reference

    lib = _build.load()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(21)
    rows = []
    for m, d, f, approximate in (*FFN_F32_CASES, FFN_F32_SIMT_CASE):
        fc1_w = 0.02 * torch.randn((f, d), generator=gen, device="cuda")
        fc1_b = 0.02 * torch.randn((f,), generator=gen, device="cuda")
        fc2_w = 0.02 * torch.randn((d, f), generator=gen, device="cuda")
        fc2_b = 0.02 * torch.randn((d,), generator=gen, device="cuda")
        x = torch.randn((m, d), generator=gen, device="cuda")
        args = (x, fc1_w.t(), fc1_b, fc2_w.t(), fc2_b, approximate)
        act = ffn.ACT_GELU_TANH if approximate else ffn.ACT_GELU_ERF
        label = f"[{m}, {d}] x [{d}, {f}], {'tanh' if approximate else 'erf'}"
        reset_counts()
        y = ffn_fwd(*args)
        torch.cuda.synchronize()
        counts = read_counts()
        simt_route = (m, d, f, approximate) == FFN_F32_SIMT_CASE
        kernel = "ffn_fwd_f32" if simt_route else "ffn_fwd_3xtf32"
        ref = ffn_reference(*args)

        def held(out, who):
            err = _rel_of_max(out, ref)
            if not (out.shape == (m, d) and out.dtype == torch.float32
                    and math.isfinite(err) and err <= FFN_F32_RTOL_OF_MAX):
                fail(f"{who} fp32 {label}: max |y - plain| = {err} of the "
                     f"largest |y| > {FFN_F32_RTOL_OF_MAX}")
            return err

        err = held(y, kernel)
        launched = {k: counts[k] for k in ("ffn_fwd_f32", "ffn_fwd_3xtf32")}
        if launched != {k: int(k == kernel) for k in launched}:
            fail(f"ffn_fwd fp32 {label}: launches {launched}, want one call "
                 f"of {kernel}")
        if simt_route:
            print(f"[coverage] ffn_fwd fp32 {label} through the wrapper: the "
                  f"SIMT kernel (D, F not multiples of 4), max err "
                  f"{err:.3e} of the largest |y| (bound "
                  f"{FFN_F32_RTOL_OF_MAX})", flush=True)
            continue

        def simt():
            h = ffn.gemm_bias_act("occm_ffn_gemm_f32", x, fc1_w, fc1_b, act)
            return ffn.gemm_bias_act("occm_ffn_gemm_f32", h, fc2_w, fc2_b,
                                     ffn.ACT_NONE)

        was_err = held(simt(), "the SIMT kernel")
        ms = cuda_ms(lambda: ffn_fwd(*args), iters=10)
        dev_ms, _, _, kept = device_ms(lambda: ffn_fwd(*args),
                                       ("ffn_gemm_3xtf32_kernel",), warmup=1,
                                       counters=("ffn_fwd_3xtf32",))
        was_ms = cuda_ms(simt, iters=10)
        was_dev, own, _, was_kept = device_ms(simt, ("ffn_gemm_f32_kernel",),
                                              warmup=1)
        if own != 2:
            fail(f"the SIMT kernel fp32 {label}: {own} launches a call, "
                 "want 2")
        plain_ms = cuda_ms(lambda: ffn_reference(*args), iters=5, warmup=1)
        mode = "tanh" if approximate else "none"

        def library():
            return F.linear(F.gelu(F.linear(x, fc1_w, fc1_b),
                                   approximate=mode), fc2_w, fc2_b)

        library_ms = cuda_ms(library, iters=5, warmup=1)
        library_dev = calls_device_ms(library, warmup=1)[0]
        bound_ms, bound_by, flops, nbytes = ffn_f32_bound(m, d, f)
        gelu = "tanh" if approximate else "erf"
        tiles = [lib.occm_ffn_gemm_3xtf32_tile_n(m, n, sms) for n in (f, d)]
        shared = dict(M=m, D=d, F=f, gelu=gelu, plain_ms=plain_ms,
                      library_ms=library_ms, library_device_ms=library_dev,
                      bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                      bytes=nbytes)
        rows.append(dict(shared, kernel="ffn_fwd_3xtf32",
                         max_abs_err=_abs_err(y, ref), rel_of_max=err, ms=ms,
                         device_ms=dev_ms, was_ms=was_ms,
                         was_device_ms=was_dev, tile_n=tiles,
                         **events_kept(kept)))
        rows.append(dict(shared, kernel="ffn_fwd_f32",
                         max_abs_err=_abs_err(simt(), ref),
                         rel_of_max=was_err, ms=was_ms, device_ms=was_dev,
                         **events_kept(was_kept)))
        print(f"[coverage] ffn_fwd fp32 {label}: 3xTF32 max err {err:.3e} of "
              f"the largest |y| (bound {FFN_F32_RTOL_OF_MAX}), wrapper "
              f"{ms:.4f} ms, device {dev_ms:.4f} ms (fc1 + fc2, tiles "
              f"128 x {tiles[0]} / 128 x {tiles[1]}; was: the SIMT kernel "
              f"{was_ms:.4f} ms, device {was_dev:.4f} ms, err "
              f"{was_err:.3e}), plain {plain_ms:.4f} ms, F.linear, F.gelu, "
              f"F.linear {library_ms:.4f} ms (device {library_dev:.4f}), "
              f"bound {bound_ms:.4f} ms ({bound_by}; {flops:.4g} flop, "
              f"{nbytes:.4g} B)", flush=True)
    return rows


def phase_coverage_kernels():
    """Phase 20's kernel checks (in a full run right after phase 3's, while
    torch.profiler keeps every record): the generic attention kernels, the
    3xTF32 attention forward and backward and the fp32 FFN kernels against
    their plain versions, and the fp32 forward's and backward's route
    sweeps."""
    t0 = time.perf_counter()
    fwd, bwd = coverage_attention_rows()
    rows = {"fwd": fwd, "bwd": bwd, "ffn": coverage_ffn_rows(),
            "fwd_route": coverage_fwd_route_sweep(),
            "bwd_route": coverage_route_sweep()}
    print(f"[coverage] phase 20's kernel checks: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def fwd_counter(dtype, head_dim: int) -> str:
    """The launch counter (launch_counts' key) of the forward kernel that
    `cuda_route` gives q, k, v of this dtype and head dim (on the wgmma
    route: D 64's instance, another head dim's up to 256, or the panel
    kernel above)."""
    import torch

    from occm_tpu_torch.ops import attention

    route = attention.cuda_route(getattr(torch, dtype), head_dim)
    if route == "wgmma":
        return ("flash_attn_fwd" if head_dim == 64
                else "flash_attn_fwd_other_d" if head_dim <= 256
                else "flash_attn_fwd_panel")
    return {"3xtf32": "flash_attn_3xtf32_fwd",
            "generic": "flash_attn_generic_fwd"}[route]


def coverage_model(workdir: str, fields=None, tag: str = "coverage",
                   speed: bool = True) -> tuple:
    """The fp32 model at full width through the 3xTF32 attention forward
    and backward and the 3xTF32 FFN kernel: AModel(AASISTConfig(),
    XLSRConfig(dtype="float32", attention_impl="flash",
    ffn_impl="pallas")) from seed 0. Scoring of 8 x 6 s and 8 x 12 s (24
    3xTF32 forward and 24 3xTF32 FFN launches a batch, no generic forward,
    wgmma or SIMT FFN launch) against the same weights on xla attention
    and the xla FFN (distances to the plain path's mean embedding,
    COVERAGE_MODEL_RTOL); one eager 12 x 6 s training step against the
    plain step (loss; the encoder held: its features and gradient from the
    plain step's dloss/dfeatures; 48 3xTF32 forward, 24 + 24 3xTF32
    backward, 48 3xTF32 FFN launches, no generic kernel); utt/s at 1, 2, 6
    and 12 s in turns: xla, flash (3xTF32 forward and backward) and flash
    with the 3xTF32 FFN kernel (the measurement behind impl_select's
    AUTO_TF32_MIN_SAMPLES). `fields`: other XLSRConfig fields (phase 24:
    2 heads of 512 at DEPTH layers, whose attention takes the generic
    kernels' panels, forward and backward; the launch gates follow
    `cuda_route` and `cuda_bwd_route`), `speed` False leaves out the
    utt/s. Returns (the counts of the path's run, the results)."""
    import torch

    from occm_tpu_torch.classify.impl_select import AUTO_TF32_MIN_SAMPLES
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.serve import make_score_fn
    from occm_tpu_torch.utils import random_init_

    from occm_tpu_torch.ops.attention import cuda_bwd_route

    kcfg = XLSRConfig(dtype="float32", attention_impl="flash",
                      ffn_impl="pallas", **(fields or {}))
    pcfg = dataclasses.replace(kcfg, attention_impl="xla", ffn_impl="xla")
    layers = kcfg.encoder_layers
    fwd = fwd_counter(kcfg.dtype,
                      kcfg.encoder_embed_dim // kcfg.encoder_heads)
    other_fwd = ({"flash_attn_3xtf32_fwd", "flash_attn_generic_fwd"}
                 - {fwd}).pop()
    bwd = cuda_bwd_route(torch.float32,
                         kcfg.encoder_embed_dim // kcfg.encoder_heads)
    other_bwd = ({"3xtf32", "generic"} - {bwd}).pop()
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    t0 = time.perf_counter()
    model = random_init_(AModel(acfg, kcfg), seed=0).to("cuda").eval()
    print(f"[{tag}] AModel(AASISTConfig(), XLSRConfig(dtype='float32', "
          f"attention_impl='flash', ffn_impl='pallas', {fields or ''})): "
          f"{sum(p.numel() for p in model.parameters())} params, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(20)
    out, total = {}, {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    # ---- scoring: kernels vs plain at 6 and 12 s
    kernels = make_score_fn(model)

    def run(cfg, x):
        set_xlsr_cfg(model, cfg)
        return kernels(x)

    scoring = {}
    for sec in (6, 12):
        x = torch.from_numpy(np.stack([synthetic_wave(rng, sec)
                                       for _ in range(8)])).to("cuda")
        emb_p, _ = run(pcfg, x)
        reset_counts()
        emb_k, logits_k = run(kcfg, x)
        torch.cuda.synchronize()
        counts = read_counts()
        add(counts)
        want = {fwd: layers, other_fwd: 0, "ffn_fwd_3xtf32": layers,
                "ffn_fwd_f32": 0, "flash_attn_fwd": 0, "ffn_fwd": 0}
        if any(counts[k] != n for k, n in want.items()):
            fail(f"fp32 scoring 8 x {sec} s: launches {counts}, want {want}")
        ref = emb_p.mean(0, keepdim=True)
        d_k = (emb_k - ref).norm(dim=1)
        d_p = (emb_p - ref).norm(dim=1)
        rel = float(((d_k - d_p).abs() / d_p).max())
        feat_rel = float((emb_k - emb_p).norm() / emb_p.norm())
        scoring[sec] = dict(distance_max_rel=rel, emb_rel_l2=feat_rel,
                            launches=want)
        print(f"[{tag}] fp32 scoring 8 x {sec} s: {layers} {fwd} and "
              f"{layers} 3xTF32 FFN launches, no {other_fwd}, wgmma or SIMT "
              f"FFN; distances "
              f"to the plain path's mean embedding max rel diff {rel:.3e}, "
              f"embeddings rel L2 {feat_rel:.3e} (bound "
              f"{COVERAGE_MODEL_RTOL})", flush=True)
        if not (torch.isfinite(logits_k).all() and rel <= COVERAGE_MODEL_RTOL
                and feat_rel <= COVERAGE_MODEL_RTOL):
            fail(f"fp32 scoring 8 x {sec} s: kernels against plain "
                 f"{scoring[sec]}")
    out["scoring"] = scoring

    # ---- one eager training step, kernels vs plain, the encoder held
    model.train()
    enc_params = list(model.ssl_model.parameters())
    x = torch.from_numpy(np.stack([synthetic_wave(rng, TRAIN_CUT / SR)
                                   for _ in range(TRAIN_B)])).to("cuda")
    labels = torch.tensor([0] * 6 + [1] * 6).to(x.device)

    def flat(params):
        return torch.cat([p.grad.reshape(-1) for p in params
                          if p.grad is not None])

    def step(cfg, upstream=None):
        set_xlsr_cfg(model, cfg)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = model.ssl_model(x)
        leaf = feats.detach().requires_grad_()
        emb, logits = model.backend(leaf, None)
        loss, _ = group_one_class_loss(emb, logits, labels, 0.1, 0.9,
                                       TRAIN_B)
        loss.backward()
        feats.backward(leaf.grad if upstream is None else upstream)
        torch.cuda.synchronize()
        return (float(loss.detach()), feats.detach(), leaf.grad,
                flat(enc_params), (time.perf_counter() - t1) * 1e3)

    loss_p, f_p, up_p, enc_p, ms_p = step(pcfg)
    reset_counts()
    loss_k, f_k, _, enc_k, ms_k = step(kcfg, up_p)
    counts = read_counts()
    add(counts)
    # remat (the default) runs every layer's forward again in the backward
    fwd_per = layers * (2 if kcfg.remat else 1)
    want = {fwd: fwd_per, other_fwd: 0,
            f"flash_attn_{bwd}_bwd_dq": layers,
            f"flash_attn_{bwd}_bwd_dkv": layers,
            f"flash_attn_{other_bwd}_bwd_dq": 0,
            f"flash_attn_{other_bwd}_bwd_dkv": 0,
            "ffn_fwd_3xtf32": fwd_per, "ffn_fwd_f32": 0,
            "flash_attn_fwd": 0, "flash_attn_bwd_dq": 0, "ffn_fwd": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"fp32 training step: launches {counts}, want {want}")
    train = dict(loss=loss_k, plain_loss=loss_p,
                 feats_rel_l2=float((f_k - f_p).norm() / f_p.norm()),
                 encoder_grad_rel_l2=float((enc_k - enc_p).norm()
                                           / enc_p.norm()),
                 ms=ms_k, plain_ms=ms_p, launches=want)
    out["train"] = train
    print(f"[{tag}] fp32 training step 12 x 6 s (eager): {train}",
          flush=True)
    if not (math.isfinite(loss_k)
            and abs(loss_k - loss_p) <= COVERAGE_MODEL_RTOL * abs(loss_p)
            and train["feats_rel_l2"] <= COVERAGE_MODEL_RTOL
            and train["encoder_grad_rel_l2"] <= COVERAGE_MODEL_RTOL):
        fail(f"fp32 training step: kernels against plain {train}")
    del enc_p, enc_k, f_p, f_k, up_p
    model.eval()
    if not speed:
        del model, kernels
        gc.collect()
        torch.cuda.empty_cache()
        return total, out

    # ---- utt/s in turns: xla, flash (3xTF32 forward and backward), flash +
    # the 3xTF32 FFN kernel
    fcfg = dataclasses.replace(kcfg, ffn_impl="xla")
    speed = []
    for sec in COVERAGE_SECONDS:
        x = torch.from_numpy(np.stack([synthetic_wave(rng, sec)
                                       for _ in range(8)])).to("cuda")
        fns = {"xla": lambda x: run(pcfg, x), "flash": lambda x: run(fcfg, x),
               "flash+ffn_pallas": lambda x: run(kcfg, x)}
        row = dict(seconds=sec, **utt_per_s(fns, x))
        speed.append(row)
        print(f"[coverage] fp32 scoring utt/s, batch 8 x {sec} s, in turns: "
              + ", ".join(f"{k} {v:.2f}" for k, v in row.items()
                          if isinstance(v, float)), flush=True)
    wins = [r["seconds"] for r in speed if r["flash"] > r["xla"]]
    first = wins[0] * SR if wins else None
    out["speed"] = dict(rows=speed, flash_wins_at_s=wins,
                        first_winning_bucket=first,
                        AUTO_TF32_MIN_SAMPLES=AUTO_TF32_MIN_SAMPLES)
    print(f"[coverage] fp32 flash ({fwd}) beats xla at {wins} s; first "
          f"winning bucket {first} samples (AUTO_TF32_MIN_SAMPLES "
          f"{AUTO_TF32_MIN_SAMPLES})", flush=True)
    del model, kernels
    gc.collect()
    torch.cuda.empty_cache()
    return total, out


def coverage_cli(workdir: str, fixture) -> tuple:
    """XLSRConfig.tiny() through the CLIs with a pinned flash impl (the
    forward `cuda_route` gives its head dim 16, the 3xTF32 backward):
    `oc_training --xlsr_tiny --attention_impl flash` for 2 steps on the
    fixture (finite losses; the forward and 3xTF32 dq and dk/dv launches a
    step exact), and `oc_classifier --mode 2c2` on the fixture's
    utterances with seeded random weights on the card and with --device
    cpu: the forward launches a batch exact, the logits within
    TINY_RTOL_OF_MAX of the largest |value|. Returns (counts, results)."""
    import torch

    from occm_tpu_torch.cli import oc_classifier, oc_training
    from occm_tpu_torch.config import XLSRConfig
    from occm_tpu_torch.io.wav import load_audio

    protocol, train_dir, voc_dir = fixture
    xcfg = XLSRConfig.tiny()
    layers = xcfg.encoder_layers
    fwd = fwd_counter(xcfg.dtype, xcfg.encoder_embed_dim // xcfg.encoder_heads)
    other_fwd = ({"flash_attn_3xtf32_fwd", "flash_attn_generic_fwd"}
                 - {fwd}).pop()
    total, out = {}, {}
    root = os.path.join(workdir, "coverage_cli")
    os.makedirs(root)
    cwd = os.getcwd()
    os.chdir(root)  # loss.txt, metrics.jsonl and the artefacts land here
    try:
        reset_counts()
        rec = StepRecorder()

        def two_steps(step, metrics):
            rec(step, metrics)
            if len(rec.steps) == 2:
                raise _TwoSteps

        try:
            oc_training.main([
                "--train_protocol_file", protocol, "--train_dataset_dir",
                train_dir, "--vocoded_dir", voc_dir, "--xlsr_tiny",
                "--attention_impl", "flash", "--cut", str(TRAIN_CUT),
                "--num_epochs", "1", "--compactness_weight", "0.1",
                "--descriptiveness_weight", "0.9", "--checkpoint_dir",
                os.path.join(root, "ckpt")], on_step=two_steps)
        except _TwoSteps:
            pass
        fwd_per = layers * (2 if xcfg.remat else 1)
        check_steps("coverage oc_training --xlsr_tiny --attention_impl flash",
                    rec, {fwd: fwd_per, other_fwd: 0,
                          "flash_attn_3xtf32_bwd_dq": layers,
                          "flash_attn_3xtf32_bwd_dkv": layers,
                          "flash_attn_generic_bwd_dq": 0,
                          "flash_attn_fwd": 0, "flash_attn_bwd_dq": 0})
        counts = read_counts()
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n
        out["train_losses"] = [st["loss"] for st in rec.steps]

        # the fixture's utterances as a bare eval list
        utts = [line.split()[1] for line in open(protocol).read().split("\n")
                if line.strip()]
        eval_list = os.path.join(root, "eval.txt")
        with open(eval_list, "w") as f:
            f.write("\n".join(utts) + "\n")
        lengths = [len(load_audio(os.path.join(train_dir, u + ".wav"))[0])
                   for u in utts]
        buckets = {}
        for n in lengths:
            b = max(SR, -(-n // SR) * SR)
            buckets[b] = buckets.get(b, 0) + 1
        n_batches = sum(-(-c // 8) for c in buckets.values())
        logits = {}
        for device in ("cuda", "cpu"):
            reset_counts()
            score_file = os.path.join(root, f"scores_2c2_{device}.txt")
            oc_classifier.main([
                "--xlsr_tiny", "--allow_random_init", "--pretrained-sslaasist",
                os.path.join(root, "no_such.pt"), "--attention_impl", "flash",
                "--mode", "2c2", "--device", device, "--protocol_file",
                protocol, "--dataset_dir", train_dir, "--eval_protocol_file",
                eval_list, "--eval_dataset_dir", train_dir, "--score_file",
                score_file])
            counts = read_counts()
            want = layers * n_batches if device == "cuda" else 0
            if (counts[fwd], counts[other_fwd], counts["flash_attn_fwd"]) != (
                    want, 0, 0):
                fail(f"coverage oc_classifier 2c2 --xlsr_tiny on {device}: "
                     f"launches {counts}, want {want} {fwd} launches "
                     f"({n_batches} batches) and no other forward")
            for key, n in counts.items():
                total[key] = total.get(key, 0) + n
            logits[device] = np.loadtxt(score_file)
    finally:
        os.chdir(cwd)
    a, b = logits["cuda"], logits["cpu"]
    err = float(np.abs(a - b).max())
    scale = float(np.abs(b).max())
    out["classifier"] = dict(logits_max_abs_err=err, max_abs_logit=scale,
                             batches=n_batches)
    print(f"[coverage] oc_training --xlsr_tiny --attention_impl flash: 2 "
          f"steps, losses {out['train_losses']}; oc_classifier 2c2 "
          f"--xlsr_tiny --attention_impl flash: {len(a)} logits on the card "
          f"against --device cpu max |diff| {err:.3e} (bound "
          f"{TINY_RTOL_OF_MAX} * {scale:.3e}), {layers * n_batches} {fwd} "
          "launches", flush=True)
    if not (a.shape == b.shape == (len(utts),) and np.isfinite(a).all()
            and err <= TINY_RTOL_OF_MAX * scale):
        fail(f"coverage oc_classifier 2c2: card and CPU logits disagree: "
             f"{out['classifier']}")
    torch.cuda.empty_cache()
    return total, out


def phase_coverage(workdir: str, fixture) -> tuple:
    """Phase 20's paths after its kernel checks: the fp32 model at full
    width (coverage_model) and the tiny model through the CLIs
    (coverage_cli); phase 4's phase_tiny_auto holds the tiny model under
    auto and pinned flash. The counts are set to 0 before each path and
    read after it; every kernel of COVERAGE_PATH_KERNELS must have
    launched. Returns (the paths' summed counts, the results)."""
    t0 = time.perf_counter()
    m_counts, model_out = coverage_model(workdir)
    c_counts, cli_out = coverage_cli(workdir, fixture)
    counts = {k: m_counts.get(k, 0) + c_counts.get(k, 0)
              for k in set(m_counts) | set(c_counts)}
    for key in COVERAGE_PATH_KERNELS:
        if not counts.get(key):
            fail(f"phase 20's paths never launched {key}: {counts}")
    out = dict(model=model_out, cli=cli_out, wall_s=time.perf_counter() - t0)
    print(f"[coverage] phase 20's paths: {out['wall_s']:.1f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return counts, out


# --------------------------------------------------------------- phase 21

# The wgmma attention kernels' instances at head dims other than 64
# (KERNEL_NAMES' form: wrapper counter -> (device kernel name, device
# launches a call)); D 64's instances count under flash_attn_fwd,
# flash_attn_bwd_dq and flash_attn_bwd_dkv
WIDE_KERNEL_NAMES = {
    "flash_attn_fwd_other_d": ("flash_attn_fwd_kernel", 1),
    "flash_attn_bwd_other_d_dq": ("flash_attn_bwd_dq_kernel", 1),
    "flash_attn_bwd_other_d_dkv": ("flash_attn_bwd_dkv_kernel", 1)}
# head dims of phase 21's kernel checks (D 64: the instance of phase 3,
# checked again beside the others), each at every T of KERNEL_TS; timed
# (D != 64) at WIDE_TIMED_TS, the rows of PERF.md
WIDE_DIMS = (16, 32, 64, 80, 120, 128)
WIDE_TIMED_TS = (299, 1500)
# head dims whose scale 1/sqrt(D) is not a power of two: the kernels fold
# it into q before the bf16 cast (the JAX order), which the scale-order
# gate tells apart from scaling the fp32 logits (the D 64 order)
SCALE_GATE_DIMS = (32, 80, 128)
# the wgmma instances against the generic kernels (csrc/flash_attn_generic
# .cu) on the same inputs: the same roundings at the same places (the
# scale folded into q, P and dS rounded to bf16 before their products,
# fp32 sums), in another summation order. Each forward output may then
# round to the neighbouring bf16 value (one ulp of its own magnitude), and
# a bf16 P that rounds the other way moves an output by at most 2^-8 of
# that key's weighted |v|, independent of the output's own size (an
# output near 0 read 37 of its own ulps, 2.2e-4 of the largest |out|, at
# D 16): one ulp of each output plus 2^-9 of the largest |out|. lse is
# fp32 on both sides (read 1.9e-6 apart): 1e-5, a hundredth of the plain
# bound. The gradients also pass through the cancellation of
# dS = P (dP - delta), so each is held to one bf16 ulp of its largest
# |value| (2^-7 of it), a quarter of the plain bound.
GENERIC_OUT_SLACK_OF_MAX = 2.0 ** -9
GENERIC_LSE_ATOL = 1e-5
GENERIC_BWD_RTOL_OF_MAX = 2.0 ** -7
# XLS-R 1B's published widths (fairseq xls_r_1b, HF facebook/wav2vec2-xls-r-
# 1b): 48 layers, d 1280, FFN 5120, 16 heads of 80; AASIST's ssl_dim is
# the encoder's width
XLSR1B = dict(encoder_layers=48, encoder_embed_dim=1280,
              encoder_ffn_dim=5120, encoder_heads=16, out_dim=1280)
# flash attention and the fused FFN against xla attention and the plain
# FFN through XLS-R 1B's 48 layers: SCORE_RTOL's argument (P and the FFN's
# hidden activation rounded at other places, a relative 2^-9 a layer
# carried by the residual stream) over twice the layers, whose drift grows
# as their square root: 1.5 x SCORE_RTOL for the embeddings' relative L2
# and for each distance's difference relative to its embedding's norm
# (|d_k - d_p| <= |e_k - e_p|). Relative to the distance itself it is
# ill-conditioned here: with random weights the 48 layers bring the eight
# synthetic utterances' embeddings close to their mean (one 12 s distance
# moved by 0.77 of itself while the embeddings moved 4.3e-3, relative L2),
# so that ratio is printed, not held.
XLSR1B_SCORE_RTOL = 1.5 * SCORE_RTOL
XLSR1B_SECONDS = (1, 2, 6, 12)


def _ulp_bf16(x):
    """The bf16 ulp of each |x| (2^(e - 7) for |x| in [2^e, 2^(e+1)),
    the smallest normal's below it)."""
    import torch

    e = torch.floor(torch.log2(x.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def generic_attention_fwd(q, k, v, t):
    """The generic forward kernel on q, k, v whatever `cuda_route` picks
    for them (csrc/flash_attn_generic.cu, the wgmma instances' "was")."""
    from occm_tpu_torch.ops import attention

    four_d = q.dim() == 4
    B, T, H, D = q.shape if four_d else (q.shape[0], q.shape[1], 1,
                                         q.shape[2])
    return attention._generic_fwd(q, k, v, t, four_d, B, H, T, D)


def generic_attention_bwd(q, k, v, o, lse, do, t):
    """The generic backward pair whatever `cuda_route` picks."""
    from occm_tpu_torch.ops import attention

    four_d = q.dim() == 4
    B, T, H, D = q.shape if four_d else (q.shape[0], q.shape[1], 1,
                                         q.shape[2])
    return attention._generic_bwd(q, k, v, o, lse, do, t, four_d, B, H, T,
                                  D)


def plain_scale_on_logits(q, k, v, t):
    """flash_attention_reference with the scale on the fp32 logits of the
    unscaled bf16 q (the D 64 kernels' order) instead of folded into q
    before the bf16 cast (the TPU kernels' and the plain version's)."""
    import torch

    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= t, -1e30)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return ((acc / l).to(q.dtype),
            (m + torch.log(torch.clamp(l, min=1e-30)))[..., 0])


def plain_scale_on_logits_bwd(q, k, v, o, lse, do, t):
    """flash_attention_bwd_reference on [BH, T, D] with P from the fp32
    logits of the unscaled q times the scale (the D 64 kernels' order)."""
    import torch

    from occm_tpu_torch.ops.attention import flash_attention_bwd_delta

    scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    kf, vf, dof = k.float(), v.float(), do.float()
    logits = torch.matmul(q.float(), kf.transpose(-1, -2)) * scale
    col = torch.arange(logits.shape[-1], device=logits.device)
    logits = logits.masked_fill(col >= t, -1e30)
    p = torch.exp(logits - lse[..., None])
    delta = flash_attention_bwd_delta(o, do)[..., None]
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    p_lo, ds_lo = p.to(dt).float(), ds.to(dt).float()
    dv = torch.matmul(p_lo.transpose(-1, -2), dof)
    dq = torch.matmul(ds_lo, kf) * scale
    dk = torch.matmul(ds_lo.transpose(-1, -2), q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm()
                 / b.float().norm().clamp_min(1e-30))


def wide_attention_rows(dims=WIDE_DIMS, gate_dims=SCALE_GATE_DIMS,
                        tag="wide"):
    """The wgmma attention kernels at bf16 head dims `dims` (phase 21:
    WIDE_DIMS; phase 22: WIDE_HEAD_DIMS), T in KERNEL_TS (forward at B 8,
    backward at B 12, H 16), on [B, T, H, D] views of one projection
    output and on [B*H, T, D] copies: views, copies
    and a repeat bit for bit, launches counted on the instance's counters
    (OTHER_D_* off D 64), the backward two device launches a call and
    nothing else, autograd at T 299 (coverage_autograd); each against its
    plain version (phase 3's bounds), against the generic kernels on the same
    inputs (GENERIC_*), and at `gate_dims` through the scale-order
    gate: the kernel's distance from the plain version (out's relative L2
    and lse's largest difference; each gradient's relative L2) below that
    of the plain version with the scale on the fp32 logits. At the head
    dims whose instances scale the logits (LOGITS_SCALE_HEAD_DIMS: 64, 256;
    the gate cannot tell the two orders apart there) the folded instance
    of the same round_up(D, 16), called directly, gives the route's out,
    lse and gradients bit for bit. Timed at D != 64 and T in
    WIDE_TIMED_TS: wrapper, device, plain, SDPA (wrapper and device), the
    generic kernel's wrapper time ("was") and the bound. Returns (forward
    rows, backward rows)."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops import attention
    from occm_tpu_torch.ops.attention import (
        LOGITS_SCALE_HEAD_DIMS, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd,
        flash_attention_reference)

    gen = torch.Generator(device="cuda").manual_seed(21)
    fwd_rows, bwd_rows = [], []
    for d in dims:
        other = d != 64
        exact = d in LOGITS_SCALE_HEAD_DIMS
        fwd_key = "flash_attn_fwd_other_d" if other else "flash_attn_fwd"
        for t in KERNEL_TS:
            for backward in (False, True):
                b, h = (TRAIN_B if backward else B), H
                qkv = torch.randn((b, t, 3, h, d), generator=gen,
                                  device="cuda").to(torch.bfloat16)
                q4, k4, v4 = qkv.unbind(2)

                def flat(x):
                    return x.permute(0, 2, 1, 3).reshape(
                        b * h, t, d).contiguous()

                q, k, v = flat(q4), flat(k4), flat(v4)
                reset_counts()
                out4, lse4 = flash_attention_fwd(q4, k4, v4, t)
                out, lse = flash_attention_fwd(q, k, v, t)
                again = flash_attention_fwd(q4, k4, v4, t)
                torch.cuda.synchronize()
                label = f"bf16 D={d} B={b} H={h} T={t}"
                if read_counts()[fwd_key] != 3:
                    fail(f"wgmma forward {label}: launches {read_counts()}, "
                         f"want 3 of {fwd_key}")
                if not (out4.shape == q4.shape and out4.is_contiguous()
                        and torch.equal(flat(out4), out)
                        and torch.equal(lse4, lse)
                        and torch.equal(again[0], out4)
                        and torch.equal(again[1], lse4)):
                    fail(f"wgmma forward {label}: views, [B*H, T, D] and a "
                         "repeat do not agree bit for bit")
                gate = None
                if not backward:
                    ref_out, ref_lse = flash_attention_reference(q, k, v, t)
                    errs = {"out": _abs_err(out, ref_out),
                            "lse": _abs_err(lse, ref_lse)}
                    if not (errs["out"] <= OUT_ATOL
                            and errs["lse"] <= LSE_ATOL
                            and all(map(math.isfinite, errs.values()))):
                        fail(f"wgmma forward {label} against its plain "
                             f"version: {errs}")
                    g_out, g_lse = generic_attention_fwd(q, k, v, t)
                    a, g = out.float(), g_out.float()
                    excess = float(((a - g).abs() - _ulp_bf16(
                        torch.maximum(a.abs(), g.abs()))).max()
                        / g.abs().max())
                    vs_generic = {"out_excess_of_max": excess,
                                  "out": _abs_err(a, g),
                                  "lse": _abs_err(lse, g_lse)}
                    if not (excess <= GENERIC_OUT_SLACK_OF_MAX
                            and vs_generic["lse"] <= GENERIC_LSE_ATOL):
                        fail(f"wgmma forward {label} against the generic "
                             f"kernel: {vs_generic} (bounds one ulp + "
                             f"{GENERIC_OUT_SLACK_OF_MAX} of the largest "
                             f"|out|, {GENERIC_LSE_ATOL})")
                    if exact:
                        f_out, f_lse = attention._tma_fwd(
                            "occm_flash_attn_fwd", q4, k4, v4, t, True, b,
                            h, t, d, 1)
                        if not (torch.equal(f_out, out4)
                                and torch.equal(f_lse, lse4)):
                            fail(f"wgmma forward {label}: the folded "
                                 "instance does not give the bits of the "
                                 "one that scales the logits")
                        gate = {"folded_instance_bit_for_bit": True}
                    if d in gate_dims:
                        v_out, v_lse = plain_scale_on_logits(q, k, v, t)
                        gate = {"kernel": (_rel_l2(out, ref_out),
                                           _abs_err(lse, ref_lse)),
                                "logits_scaled": (_rel_l2(v_out, ref_out),
                                                  _abs_err(v_lse, ref_lse))}
                        if not all(a < b for a, b in zip(
                                gate["kernel"], gate["logits_scaled"])):
                            fail(f"wgmma forward {label}: scale-order gate "
                                 f"(out rel L2, lse max): {gate}")
                    call = (lambda: flash_attention_fwd(q4, k4, v4, t))
                    generic = (lambda: generic_attention_fwd(q4, k4, v4, t))
                    names = ("flash_attn_fwd_kernel",)
                    counters = (fwd_key,)
                    plain = (lambda: flash_attention_reference(q, k, v, t))
                    q3, k3, v3 = (x.view(b, h, t, d) for x in (q, k, v))

                    def library():
                        with torch.no_grad():
                            F.scaled_dot_product_attention(q3, k3, v3)
                else:
                    do4 = torch.randn((b, t, h, d), generator=gen,
                                      device="cuda").to(torch.bfloat16)
                    do = flat(do4)
                    got4 = flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
                    rep = flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
                    got = flash_attention_bwd(q, k, v, out, lse, do, t)
                    torch.cuda.synchronize()
                    for name, a, r, c in zip(("dq", "dk", "dv"), got4, rep,
                                             got):
                        if not (a.shape == q4.shape and a.is_contiguous()
                                and torch.equal(a, r)
                                and torch.equal(flat(a), c)):
                            fail(f"wgmma backward {label}: {name} of views, "
                                 "[B*H, T, D] and a repeat do not agree bit "
                                 "for bit, or is not contiguous")
                    want = flash_attention_bwd_reference(q, k, v, out, lse,
                                                         do, t)
                    errs = {n: _rel_of_max(a, w) for n, a, w
                            in zip(("dq", "dk", "dv"), got, want)}
                    if not all(math.isfinite(e) and e <= BWD_RTOL_OF_MAX
                               for e in errs.values()):
                        fail(f"wgmma backward {label} against its plain "
                             f"version: {errs} (relative to the largest "
                             f"|value|, bound {BWD_RTOL_OF_MAX})")
                    g_grads = generic_attention_bwd(q, k, v, out, lse, do, t)
                    vs_generic = {n: _rel_of_max(a, w) for n, a, w
                                  in zip(("dq", "dk", "dv"), got, g_grads)}
                    if not all(e <= GENERIC_BWD_RTOL_OF_MAX
                               for e in vs_generic.values()):
                        fail(f"wgmma backward {label} against the generic "
                             f"kernels: {vs_generic} (bound "
                             f"{GENERIC_BWD_RTOL_OF_MAX})")
                    if exact:
                        folded = attention._wgmma_bwd(
                            q4, k4, v4, out4, lse4, do4, t, True, b, h, t, d,
                            1)
                        if not all(torch.equal(a, w)
                                   for a, w in zip(folded, got4)):
                            fail(f"wgmma backward {label}: the folded "
                                 "instance does not give the bits of the "
                                 "one that scales the logits")
                        gate = {"folded_instance_bit_for_bit": True}
                    if d in gate_dims:
                        variant = plain_scale_on_logits_bwd(q, k, v, out,
                                                            lse, do, t)
                        gate = {"kernel": tuple(_rel_l2(a, w) for a, w
                                                in zip(got, want)),
                                "logits_scaled": tuple(
                                    _rel_l2(a, w)
                                    for a, w in zip(variant, want))}
                        if not all(a < b for a, b in zip(
                                gate["kernel"], gate["logits_scaled"])):
                            fail(f"wgmma backward {label}: scale-order gate "
                                 f"(dq, dk, dv rel L2): {gate}")
                    counters = (("flash_attn_bwd_other_d_dq",
                                 "flash_attn_bwd_other_d_dkv") if other
                                else ("flash_attn_bwd_dq",
                                      "flash_attn_bwd_dkv"))
                    if t == MAIN_PATH_TS[0]:
                        coverage_autograd(q4, k4, v4, do4, got4,
                                          f"wgmma {label}", counters)
                    call = (lambda: flash_attention_bwd(
                        q4, k4, v4, out4, lse4, do4, t))
                    generic = (lambda: generic_attention_bwd(
                        q4, k4, v4, out4, lse4, do4, t))
                    names = ("flash_attn_bwd_d",)
                    plain = (lambda: flash_attention_bwd_reference(
                        q, k, v, out, lse, do, t))
                    q3, k3, v3 = (x.view(b, h, t, d).detach()
                                  .requires_grad_() for x in (q, k, v))
                    do3 = do.view(b, h, t, d)

                    def library():
                        o3 = F.scaled_dot_product_attention(q3, k3, v3)
                        torch.autograd.grad(o3, (q3, k3, v3), do3)

                row = dict(dtype="bfloat16", D=d, B=b, H=h, T=t,
                           errors=errs, vs_generic=vs_generic,
                           max_abs_err=max(
                               _abs_err(a, w) for a, w in (
                                   zip(got, want) if backward
                                   else ((out, ref_out),))),
                           **({"scale_order_gate": gate} if gate else {}))
                timed = other and t in WIDE_TIMED_TS
                if timed:
                    iters = 10 if t <= 600 else 4
                    row["ms"] = cuda_ms(call, iters=iters, warmup=2)
                    dev_ms, own, every, kept = device_ms(
                        call, names, warmup=1, counters=counters)
                    if backward and (own, every) != (2, 2):
                        fail(f"wgmma backward {label}: {every} device "
                             f"launches a call ({own} of the kernels), want "
                             "2 (dq, dk/dv) and no other")
                    row["device_ms"] = dev_ms
                    row.update(events_kept(kept))
                    row["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
                    row["was_ms"] = cuda_ms(generic, iters=iters, warmup=1)
                    library_ms = cuda_ms(library, iters=iters, warmup=2)
                    library_dev = library_device_ms(library, warmup=1)
                    if backward:
                        with torch.no_grad():
                            fwd_only = (lambda: F.scaled_dot_product_attention(
                                q3, k3, v3))
                            library_ms -= cuda_ms(fwd_only, iters=5, warmup=2)
                            library_dev -= library_device_ms(fwd_only,
                                                             warmup=1)
                    row["library_ms"] = library_ms
                    row["library_device_ms"] = library_dev
                    (row["bound_ms"], row["bound_by"], row["flops"],
                     row["bytes"]) = coverage_attention_bound(
                         b * h, t, d, "bfloat16", backward)
                (bwd_rows if backward else fwd_rows).append(row)
                kind = "bwd" if backward else "fwd"
                times = (f"; wrapper {row['ms']:.4f} ms, device "
                         f"{row['device_ms']:.4f} ms, plain "
                         f"{row['plain_ms']:.4f} ms, sdpa "
                         f"{row['library_ms']:.4f} ms (device "
                         f"{row['library_device_ms']:.4f}), was (generic) "
                         f"{row['was_ms']:.4f} ms, bound "
                         f"{row['bound_ms']:.4f} ms ({row['bound_by']})"
                         if timed else "")
                print(f"[{tag}] flash_attn_{kind} {label}: against plain "
                      f"{ {k: f'{e:.3e}' for k, e in errs.items()} }, "
                      f"against generic "
                      f"{ {k: f'{e:.3e}' for k, e in vs_generic.items()} }"
                      + (f", scale-order gate {gate}" if gate else "")
                      + "; views = [B*H, T, D] = repeat bit for bit" + times,
                      flush=True)
                del qkv, q, k, v, out, lse, out4, lse4, again
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def phase_wide_kernels():
    """Phase 21's kernel checks (in a full run right after phase 20's):
    the wgmma attention instances at bf16 head dims other than 64."""
    t0 = time.perf_counter()
    fwd, bwd = wide_attention_rows()
    print(f"[wide] phase 21's kernel checks: {time.perf_counter() - t0:.1f} "
          "s", flush=True)
    return {"fwd": fwd, "bwd": bwd}


def model_at_widths(widths=XLSR1B, tag="xlsr1b",
                    score_rtol=XLSR1B_SCORE_RTOL, seed=21) -> tuple:
    """A model at published widths (phase 21: XLS-R 1B's, at full depth;
    phase 22: XLS-R 300M's with 4 heads of 256; phase 24: with 2 heads of
    512) through the wgmma route's kernels at its head dim (the instances
    of D 80 and D 256, counted on OTHER_D_*; the panel kernels of D 512,
    counted on PANEL_*, none of the other family launched):
    AModel(AASISTConfig(), XLSRConfig(**widths)) in bf16 with
    attention_impl="flash", ffn_impl="pallas" and ln_impl="pallas", random
    weights from seed 0 (PyTorch's initialisers, on the card), AASIST's
    dropouts off. Scoring of 8 x 6 s and 8 x 12 s through BucketedEmbedder
    (a forward launch of the instance and an ffn_fwd a layer and batch, no
    D 64 or generic launch), the distances to the plain path's mean
    embedding (their differences relative to the embeddings' norms) and
    the embeddings within `score_rtol` of the same weights on xla
    attention and the plain FFN; one eager 12 x 6 s training step against
    the plain one (loss within LOSS_RTOL; the encoder held: its features
    and its gradient from the plain step's dloss/dfeatures within
    LOSS_RTOL, relative L2), its launches exact (the forward twice a
    layer under remat, dq and dk/dv once, layernorm_bwd twice, ffn_fwd
    twice), then one fused_adam step over every leaf (a launch a
    MAX_LEAVES leaves); utt/s
    at XLSR1B_SECONDS in turns: xla, flash (the plain FFN) and flash with
    the fused FFN (the measurement behind impl_select's threshold for the
    wgmma route at head dims other than 64). Returns (the counts of the
    path's run, the results)."""
    import torch

    from occm_tpu_torch.classify import (
        BucketedEmbedder, make_embed_fn_factory)
    from occm_tpu_torch.classify.impl_select import auto_flash_min_samples
    from occm_tpu_torch.config import AASISTConfig, XLSRConfig
    from occm_tpu_torch.losses import group_one_class_loss
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops.fused_adam import MAX_LEAVES, FusedAdam
    from occm_tpu_torch.serve import make_score_fn

    kcfg = XLSRConfig(**widths, attention_impl="flash", ffn_impl="pallas",
                      ln_impl="pallas")
    head_dim = kcfg.encoder_embed_dim // kcfg.encoder_heads
    # the wgmma route's counters at this head dim, and the other family's
    fwd_key = fwd_counter(kcfg.dtype, head_dim)
    family = ("panel" if fwd_key == "flash_attn_fwd_panel" else "other_d")
    dq_key, dkv_key = (f"flash_attn_bwd_{family}_dq",
                       f"flash_attn_bwd_{family}_dkv")
    not_family = ("other_d" if family == "panel" else "panel")
    not_fwd = f"flash_attn_fwd_{not_family}"
    pcfg = dataclasses.replace(kcfg, attention_impl="xla", ffn_impl="xla",
                               ln_impl="xla")
    layers = kcfg.encoder_layers
    acfg = AASISTConfig(dropout=0.0, pool_dropout=0.0, head_dropout=0.0)
    t0 = time.perf_counter()
    with torch.random.fork_rng(devices=[0]), torch.device(DEVICE):
        torch.manual_seed(0)
        model = AModel(acfg, kcfg)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    out = {"params": n_params, "encoder_params": sum(
        p.numel() for p in model.ssl_model.parameters()),
           "init_s": time.perf_counter() - t0}
    print(f"[{tag}] AModel(AASISTConfig(), XLSRConfig({widths}, bf16, "
          f"flash, ffn_impl and ln_impl 'pallas')): {n_params} params "
          f"({out['encoder_params']} in the encoder), head dim {head_dim}, "
          f"init {out['init_s']:.1f} s", flush=True)
    rng = np.random.default_rng(seed)
    total = {}

    def add(counts):
        for key, n in counts.items():
            total[key] = total.get(key, 0) + n

    # ---- scoring through BucketedEmbedder: kernels vs plain, 6 and 12 s
    def embed(cfg, impl, waves):
        set_xlsr_cfg(model, cfg)
        return BucketedEmbedder(
            embed_fn_factory=make_embed_fn_factory(model, impl),
            bucket_step=SR, batch_size=8, device=DEVICE).embed_all(waves)

    scoring = {}
    for sec in (6, 12):
        waves = [synthetic_wave(rng, sec) for _ in range(8)]
        emb_p, _ = embed(pcfg, "xla", waves)
        reset_counts()
        emb_k, logits_k = embed(kcfg, "flash", waves)
        torch.cuda.synchronize()
        counts = read_counts()
        add(counts)
        want = {fwd_key: layers, "ffn_fwd": layers, not_fwd: 0,
                "flash_attn_fwd": 0, "flash_attn_generic_fwd": 0}
        if any(counts[k] != n for k, n in want.items()):
            fail(f"{tag} scoring 8 x {sec} s: launches {counts}, want "
                 f"{want}")
        ref = emb_p.mean(0, keepdims=True)
        d_k = np.linalg.norm(emb_k - ref, axis=1)
        d_p = np.linalg.norm(emb_p - ref, axis=1)
        norms = np.linalg.norm(emb_p, axis=1)
        rel = float((np.abs(d_k - d_p) / norms).max())
        emb_rel = float(np.linalg.norm(emb_k - emb_p) / np.linalg.norm(emb_p))
        scoring[sec] = dict(
            distance_max_diff_of_norm=rel, emb_rel_l2=emb_rel,
            distance_max_rel=float((np.abs(d_k - d_p) / d_p).max()),
            plain_distances_of_norm=(d_p / norms).tolist(), launches=want)
        print(f"[{tag}] scoring 8 x {sec} s through BucketedEmbedder: "
              f"{layers} D {head_dim} forward and {layers} ffn_fwd launches, "
              f"no D 64 or generic one; distances to the plain path's mean "
              f"embedding: largest difference {rel:.3e} of the embedding's "
              f"norm, embeddings rel L2 {emb_rel:.3e} (bound "
              f"{score_rtol}); the plain distances "
              f"{(d_p / norms).min():.3e}-{(d_p / norms).max():.3e} of the "
              f"norm, their largest relative difference "
              f"{scoring[sec]['distance_max_rel']:.3e} (printed)",
              flush=True)
        if not (np.isfinite(logits_k).all() and rel <= score_rtol
                and emb_rel <= score_rtol):
            fail(f"{tag} scoring 8 x {sec} s: kernels against plain "
                 f"{scoring[sec]}")
    out["scoring"] = scoring

    # ---- one eager training step, kernels vs plain, the encoder held
    model.train()
    params = list(model.parameters())
    enc_params = list(model.ssl_model.parameters())
    x = torch.from_numpy(np.stack([synthetic_wave(rng, TRAIN_CUT / SR)
                                   for _ in range(TRAIN_B)])).to(DEVICE)
    labels = torch.tensor([0] * 6 + [1] * 6).to(x.device)

    def flat(ps):
        return torch.cat([p.grad.reshape(-1).float() for p in ps
                          if p.grad is not None])

    def step(cfg, upstream=None):
        set_xlsr_cfg(model, cfg)
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        feats = model.ssl_model(x)
        leaf = feats.detach().requires_grad_()
        emb, logits = model.backend(leaf, None)
        loss, _ = group_one_class_loss(emb, logits, labels, 0.1, 0.9,
                                       TRAIN_B)
        loss.backward()
        feats.backward(leaf.grad if upstream is None else upstream)
        torch.cuda.synchronize()
        return (float(loss.detach()), feats.detach(), leaf.grad,
                flat(enc_params), (time.perf_counter() - t1) * 1e3)

    loss_p, f_p, up_p, enc_p, ms_p = step(pcfg)
    reset_counts()
    loss_k, f_k, _, enc_k, ms_k = step(kcfg, up_p)
    opt = FusedAdam(1e-5).init([p.detach() for p in params])
    opt.step([p.detach() for p in params], [p.grad for p in params])
    torch.cuda.synchronize()
    counts = read_counts()
    add(counts)
    fwd_per = layers * (2 if kcfg.remat else 1)
    # the Adam kernel takes MAX_LEAVES leaves a launch
    adam_launches = -(-sum(p.grad is not None for p in params) // MAX_LEAVES)
    want = {fwd_key: fwd_per, dq_key: layers, dkv_key: layers,
            "layernorm_bwd": 2 * layers, "ffn_fwd": fwd_per,
            "fused_adam": adam_launches, "flash_attn_fwd": 0,
            "flash_attn_bwd_dq": 0, "flash_attn_generic_fwd": 0,
            "flash_attn_generic_bwd_dq": 0, not_fwd: 0,
            f"flash_attn_bwd_{not_family}_dq": 0}
    if any(counts[k] != n for k, n in want.items()):
        fail(f"{tag} training step: launches {counts}, want {want}")
    finite = all(bool(torch.isfinite(p).all()) for p in params)
    train = dict(loss=loss_k, plain_loss=loss_p,
                 feats_rel_l2=_rel_l2(f_k, f_p),
                 encoder_grad_rel_l2=_rel_l2(enc_k, enc_p),
                 ms=ms_k, plain_ms=ms_p, launches=want,
                 params_finite_after_adam=finite)
    out["train"] = train
    print(f"[{tag}] training step 12 x 6 s (eager, all {layers} layers), "
          f"then one fused_adam step: {train}", flush=True)
    if not (math.isfinite(loss_k) and finite
            and abs(loss_k - loss_p) <= LOSS_RTOL * abs(loss_p)
            and train["feats_rel_l2"] <= LOSS_RTOL
            and train["encoder_grad_rel_l2"] <= LOSS_RTOL):
        fail(f"{tag} training step: kernels against plain {train}")
    del enc_p, enc_k, f_p, f_k, up_p, opt
    model.zero_grad(set_to_none=True)
    model.eval()

    # ---- utt/s in turns: xla, flash, flash + the fused FFN
    fcfg = dataclasses.replace(kcfg, ffn_impl="xla")

    def run(cfg, impl):
        score = make_score_fn(model, impl)

        def fn(x):
            set_xlsr_cfg(model, cfg)
            return score(x)

        return fn

    fns = {"xla": run(pcfg, "xla"), "flash": run(fcfg, "flash"),
           "flash+ffn_pallas": run(kcfg, "flash")}
    speed = []
    for sec in XLSR1B_SECONDS:
        x = torch.from_numpy(np.stack([synthetic_wave(rng, sec)
                                       for _ in range(8)])).to(DEVICE)
        row = dict(seconds=sec, **utt_per_s(fns, x))
        speed.append(row)
        print(f"[{tag}] scoring utt/s, batch 8 x {sec} s, in turns: "
              + ", ".join(f"{k} {v:.2f}" for k, v in row.items()
                          if isinstance(v, float)), flush=True)
    wins = [r["seconds"] for r in speed if r["flash"] > r["xla"]]
    out["speed"] = dict(rows=speed, flash_wins_at_s=wins,
                        auto_min_samples=auto_flash_min_samples(kcfg, DEVICE))
    print(f"[{tag}] flash (D {head_dim} instance) beats xla at {wins} s; "
          f"auto's threshold for the model: "
          f"{out['speed']['auto_min_samples']} samples", flush=True)
    del model, fns
    gc.collect()
    torch.cuda.empty_cache()
    return total, out


def phase_xlsr1b() -> tuple:
    """Phase 21's path after its kernel checks: XLS-R 1B's widths
    (model_at_widths). The counts are set to 0 before the path and read
    after it; each kernel of the path must have launched. Returns (the
    path's counts, the results)."""
    t0 = time.perf_counter()
    counts, out = model_at_widths()
    for key in (*WIDE_KERNEL_NAMES, "ffn_fwd", "layernorm_bwd",
                "fused_adam"):
        if not counts.get(key):
            fail(f"phase 21's path never launched {key}: {counts}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[xlsr1b] phase 21's path: {out['wall_s']:.1f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return counts, out


def wide_kernel_line(rows, launches):
    """Phase 21's {"kernels": [...]} entries: the wgmma attention instances
    at head dims other than 64, forward and backward, their head row at
    XLS-R 1B's shape (D 80, T 299: [B=8, T=299, H=16, D=80] forward,
    B 12 backward), every row under "per_shape". `launches` come from
    phase 21's path, 0 with --kernels-only."""

    def head(kind):
        return next(r for r in rows[kind]
                    if r["D"] == 80 and r["T"] == MAIN_PATH_TS[0])

    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "was_ms")
    fwd, bwd = head("fwd"), head("bwd")
    replaced = "occm_tpu/ops/attention.py:"
    return [
        {"name": "flash_attn_fwd_other_d", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": f"{replaced}45 (_fwd_kernel), {replaced}234 "
                     "(_blocked_fwd_kernel), in bf16 at head dims other "
                     "than 64",
         "launches": launches["flash_attn_fwd_other_d"],
         "shape": f"[B={B}, T={fwd['T']}, H={H}, D=80] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in rows["fwd"]),
         **{k: fwd[k] for k in keys},
         "library": "SDPA, bf16",
         "was": "the generic kernel, csrc/flash_attn_generic.cu",
         "per_shape": rows["fwd"]},
        {"name": "flash_attn_bwd_other_d", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": f"{replaced}79 (_bwd_kernel), {replaced}350 "
                     f"(_blocked_dq_kernel), {replaced}373 "
                     "(_blocked_dkv_kernel), in bf16 at head dims other "
                     "than 64",
         "launches": launches["flash_attn_bwd_other_d_dq"],
         "launches_dkv": launches["flash_attn_bwd_other_d_dkv"],
         "shape": f"[B={TRAIN_B}, T={bwd['T']}, H={H}, D=80] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in rows["bwd"]),
         **{k: bwd[k] for k in keys},
         "library": "SDPA forward + backward minus forward, bf16",
         "was": "the generic kernels, csrc/flash_attn_generic.cu",
         "per_shape": rows["bwd"]},
    ]


# --------------------------------------------------------------- phase 22

# bf16 head dims above 128 of phase 22's kernel checks, each at every T of
# KERNEL_TS and timed at WIDE_TIMED_TS: round_up(D, 16) 144 and 192 fold
# the scale into q (through the scale-order gate), D 256 scales the logits
# (its scale 2^-4 is exact: the folded instance <256> gives its bits). The
# wide dk/dv kernel and the two-warpgroup forward run at all three.
WIDE_HEAD_DIMS = (136, 192, 256)
WIDE_HEAD_GATE_DIMS = (136, 192)
# XLS-R 300M's published widths (XLSRConfig(): 24 layers, d 1024, FFN
# 4096, fairseq xlsr_53 / xls_r_300m) with 4 heads of 256 in place of its
# 16 of 64: the wide instances at the 300M model's width and depth, held
# to SCORE_RTOL (SCORE_RTOL's argument is that of 24 layers)
XLSR300M_D256 = dict(encoder_heads=4)


def phase_wide_head_kernels():
    """Phase 22's kernel checks (in a full run right after phase 21's): the
    wgmma attention instances at bf16 head dims 136, 192 and 256
    (wide_attention_rows at WIDE_HEAD_DIMS)."""
    t0 = time.perf_counter()
    fwd, bwd = wide_attention_rows(WIDE_HEAD_DIMS, WIDE_HEAD_GATE_DIMS,
                                   tag="wide-head")
    print(f"[wide-head] phase 22's kernel checks: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"fwd": fwd, "bwd": bwd}


def phase_wide_head() -> tuple:
    """Phase 22's path after its kernel checks: XLS-R 300M's widths with 4
    heads of 256 (model_at_widths at XLSR300M_D256, SCORE_RTOL). The counts
    are set to 0 before the path and read after it; each kernel of the path
    must have launched, and none of D 64's or the generic route's
    (model_at_widths's launch gates). Returns (the path's counts, the
    results)."""
    t0 = time.perf_counter()
    counts, out = model_at_widths(XLSR300M_D256, "wide-head", SCORE_RTOL,
                                  22)
    for key in (*WIDE_KERNEL_NAMES, "ffn_fwd", "layernorm_bwd",
                "fused_adam"):
        if not counts.get(key):
            fail(f"phase 22's path never launched {key}: {counts}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"[wide-head] phase 22's path: {out['wall_s']:.1f} s, launches "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    return counts, out


def wide_head_kernel_line(rows, launches):
    """Phase 22's {"kernels": [...]} entries: the wgmma attention instances
    at bf16 head dims 136-256, forward and backward, their head row at
    D 256, T 299 ([B=8, T=299, H=16, D=256] forward, B 12 backward), every
    row under "per_shape". `launches` come from phase 22's path (the
    OTHER_D_* counters, which phase 21's entries read from phase 21's
    path), 0 with --kernels-only."""

    def head(kind):
        return next(r for r in rows[kind]
                    if r["D"] == 256 and r["T"] == MAIN_PATH_TS[0])

    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "was_ms")
    fwd, bwd = head("fwd"), head("bwd")
    replaced = "occm_tpu/ops/attention.py:"
    return [
        {"name": "flash_attn_fwd_wide_head", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": f"{replaced}45 (_fwd_kernel), {replaced}234 "
                     "(_blocked_fwd_kernel), in bf16 at head dims 136-256",
         "launches": launches["flash_attn_fwd_other_d"],
         "shape": f"[B={B}, T={fwd['T']}, H={H}, D=256] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in rows["fwd"]),
         **{k: fwd[k] for k in keys},
         "library": "SDPA, bf16",
         "was": "the generic kernel, csrc/flash_attn_generic.cu",
         "per_shape": rows["fwd"]},
        {"name": "flash_attn_bwd_wide_head", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": f"{replaced}79 (_bwd_kernel), {replaced}350 "
                     f"(_blocked_dq_kernel), {replaced}373 "
                     "(_blocked_dkv_kernel), in bf16 at head dims 136-256",
         "launches": launches["flash_attn_bwd_other_d_dq"],
         "launches_dkv": launches["flash_attn_bwd_other_d_dkv"],
         "shape": f"[B={TRAIN_B}, T={bwd['T']}, H={H}, D=256] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in rows["bwd"]),
         **{k: bwd[k] for k in keys},
         "library": "SDPA forward + backward minus forward, bf16",
         "was": "the generic kernels, csrc/flash_attn_generic.cu",
         "per_shape": rows["bwd"]},
    ]


# --------------------------------------------------------------- phase 23

# the steps each of phase 23's resumed CLI runs trains
JAX_RESUME_STEPS = 2
# the prefix of the CLI's checkpoints (--model aasist)
JAX_RESUME_PREFIX = "aasist_vocoded"
# the integer keys of a step checkpoint's progress (the rest are the
# running loss sums)
PROGRESS_INTS = ("epoch", "dispatches", "opt_steps")
POS_CONV = "ssl_model.model.encoder.pos_conv.0.weight"


def jax_trainer_tree(state, xlsr_cfg, progress=None) -> dict:
    """The tree that the JAX package's `save_checkpoint` (with `progress`,
    its `save_step_checkpoint`) writes for an AModel's TrainState, made from
    the port's `state` without JAX: the parameters and BatchNorm statistics
    through `convert_backend.convert_model_state_dict`, Adam's moments
    through the same mapping (each moment in its parameter's place; zeros
    where torch Adam holds none), the positional conv's kernel and its
    moments as the port trains them, transposed (not the weight-norm pair
    refolded); opt_state in optax adam's form, [{count, mu, nu}, None]
    (under an lr schedule [{count, mu, nu}, {count}]), or FusedAdamState's,
    {count, mu, nu}; the step, the count and the progress as the int32 /
    float32 arrays JAX saves. tests/test_torch_resume_jax.py holds it
    against the JAX package's own saver."""
    import torch

    from occm_tpu_torch.models.convert_backend import (
        convert_model_state_dict)
    from occm_tpu_torch.models.xlsr import weight_norm_g
    from occm_tpu_torch.ops.fused_adam import FusedAdam

    sd = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
    named = {n: p.detach().cpu() for n, p in state.model.named_parameters()}

    def variables(values):
        """{"params", "batch_stats"} with `values` in the parameters'
        places."""
        tensors = dict(sd)
        for n, v in values.items():
            if n == POS_CONV:
                tensors[n + "_g"], tensors[n + "_v"] = weight_norm_g(v), v
            else:
                tensors[n] = v
        out = convert_model_state_dict(tensors, kind="amodel",
                                       xlsr_cfg=xlsr_cfg)
        out.pop("_kind")
        out["params"]["ssl_model"]["pos_conv"]["kernel"] = \
            np.ascontiguousarray(values[POS_CONV].numpy().transpose(2, 1, 0))
        return out

    opt = state.optimizer_state()
    moments = {key: variables({
        n: opt[key][n].detach().cpu() if n in opt[key]
        else torch.zeros_like(p) for n, p in named.items()})["params"]
        for key in ("mu", "nu")}
    count = np.int32(opt["count"])
    adam = {"count": count, "mu": moments["mu"], "nu": moments["nu"]}
    if isinstance(state.optimizer, FusedAdam):
        opt_state = adam
    elif state.schedule is None:
        opt_state = [adam, None]
    else:
        opt_state = [adam, {"count": count}]
    tree = dict(variables(named), opt_state=opt_state,
                step=np.int32(state.step))
    if progress is not None:
        tree["progress"] = {
            k: (np.int32 if k in PROGRESS_INTS else np.float32)(v)
            for k, v in progress.items()}
    return tree


def write_jax_checkpoint(state, directory: str, prefix: str, xlsr_cfg,
                         epoch: int = 0, progress=None) -> str:
    """`jax_trainer_tree` written where and as the JAX package writes it:
    `<prefix>_<epoch>/`, or with `progress` `<prefix>_step_<opt_steps>/`,
    every array a "jax.Array" leaf. Returns the directory."""
    from occm_tpu_torch.train.orbax import save_tree

    name = (f"{prefix}_{epoch}" if progress is None
            else f"{prefix}_step_{int(progress['opt_steps'])}")
    return save_tree(jax_trainer_tree(state, xlsr_cfg, progress),
                     os.path.join(directory, name), array_type="jax.Array")


def dir_fingerprint(path: str) -> dict:
    """{file: size} of a directory, and the sha256 of each of its
    manifests (OCDBT's manifest.ocdbt files and orbax's metadata)."""
    import hashlib

    files, hashes = {}, {}
    for d, _, names in os.walk(path):
        for name in names:
            full = os.path.join(d, name)
            rel = os.path.relpath(full, path)
            files[rel] = os.path.getsize(full)
            if name.startswith(("manifest", "_METADATA",
                                "_CHECKPOINT_METADATA")):
                with open(full, "rb") as f:
                    hashes[rel] = hashlib.sha256(f.read()).hexdigest()
    return {"files": files, "manifest_sha256": hashes}


def state_snapshot(state) -> dict:
    """The state's parameters, BatchNorm running statistics, Adam moments,
    step (host and device), the optimizer's count and the generator's
    state, copied to the CPU."""
    model = state.model
    opt = state.optimizer_state()

    def cpu(tensors):
        return {n: t.detach().cpu().clone() for n, t in tensors}

    return {"params": cpu(model.named_parameters()),
            "stats": cpu((n, b) for n, b in model.named_buffers()
                         if n.endswith(("running_mean", "running_var"))),
            "mu": cpu(opt["mu"].items()), "nu": cpu(opt["nu"].items()),
            "step": state.step, "step_t": int(state.step_t),
            "count": int(opt["count"]), "rng": state.generator.get_state()}


def same_state(got: dict, want: dict, what: str) -> int:
    """Every tensor of two snapshots equal bit for bit, and the counts;
    returns the number of tensors compared."""
    import torch

    n = 0
    for group in ("params", "stats", "mu", "nu"):
        if set(got[group]) != set(want[group]):
            fail(f"{what}: {group} name other tensors: "
                 f"{sorted(set(got[group]) ^ set(want[group]))[:4]}")
        differ = [k for k in want[group]
                  if got[group][k].dtype != want[group][k].dtype
                  or not torch.equal(got[group][k], want[group][k])]
        if differ:
            fail(f"{what}: {group} differ from the state written in "
                 f"{len(differ)} tensors, e.g. {differ[:3]}")
        n += len(want[group])
    for key in ("step", "step_t", "count"):
        if got[key] != want[key]:
            fail(f"{what}: {key} {got[key]}, the state written "
                 f"{want[key]}")
    return n


def phase_jax_resume(workdir: str, fixture) -> tuple:
    """Phase 23: `oc_training --resume` continuing a run of the JAX package
    from its orbax directories, written here by `write_jax_checkpoint` in
    the layout of `occm_tpu.train.checkpoint` (no JAX on the card).
    (a) XLS-R 300M + AASIST at full width and depth, seed 0, 2 eager steps
    under torch Adam (its moments non-zero), written as the epoch directory
    `<prefix>_0/` in optax adam's form, then resumed under the default
    --optimizer adam for 2 steps of epoch 1; (b) the same widths at DEPTH
    layers under fused_adam, written after 2 of epoch 0's dispatches as the
    step directory `<prefix>_step_2/` with its progress, resumed under
    --optimizer fused_adam (the 2 consumed dispatches replayed, not
    trained). Each, under deterministic algorithms: the state the resume
    restores, read on the card before its first step, equal bit for bit to
    the state written (parameters, BatchNorm statistics, mu, nu, step,
    count) and its generator seeded by `train.checkpoint.resume_seed`; the
    first batch trained the pipeline's next one; every step's launches
    exact (phase 6's, plus one fused_adam launch a step in (b); no generic,
    3xTF32 or other-D kernel); finite losses; a second resume equal bit for
    bit (in (a) sent SIGTERM after its steps, so the port saves its own
    step .pt beside the directory); a .pt resume of the restored state
    (generator included) equal bit for bit; the JAX directory's files,
    sizes and manifests unchanged, and the next resume choosing the port's
    .pt. Prints the write, read and ready seconds and MB/s. Returns the
    kernel wrappers' launches and the measurements."""
    import signal

    import torch

    from occm_tpu_torch.cli import oc_training
    from occm_tpu_torch.config import AASISTConfig, TrainConfig, XLSRConfig
    from occm_tpu_torch.data import MetaBatchPipeline, PFDataset
    from occm_tpu_torch.models import AModel
    from occm_tpu_torch.ops import launch_counts
    from occm_tpu_torch.train import checkpoint, loop, orbax, train
    from occm_tpu_torch.utils.logging import MetricsLogger

    t_phase = time.perf_counter()
    protocol, train_dir, voc_dir = fixture
    prefix = JAX_RESUME_PREFIX
    totals = dict.fromkeys(launch_counts(), 0)
    out = {}

    def add(counts):
        for k in totals:
            totals[k] += counts[k]

    dataset = PFDataset(protocol, dataset_dir=train_dir, vocoded_dir=voc_dir,
                        cut=TRAIN_CUT, seed=0)
    pipeline = MetaBatchPipeline(dataset, seed=0)  # the CLI's, --seed 0

    captured, first_x = {}, []
    restore_jax = checkpoint.restore_jax_checkpoint
    read_tree, step_fn = orbax.restore_tree, loop.train_step

    def timed_read(path, subtree=None):
        t0 = time.perf_counter()
        tree = read_tree(path, subtree)
        if subtree is None:
            captured["read_s"] = time.perf_counter() - t0
        return tree

    def restore_and_read(state, path, cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        progress = restore_jax(state, path, cfg)
        torch.cuda.synchronize()
        captured["ready_s"] = time.perf_counter() - t0
        captured["state"] = state_snapshot(state)
        if captured.get("pt_path"):
            # the same state as the port's own checkpoint, its generator
            # seeded as the JAX resume seeded it
            payload = checkpoint._payload(state)
            if progress is not None:
                payload["progress"] = progress
            os.makedirs(os.path.dirname(captured["pt_path"]), exist_ok=True)
            torch.save(payload, captured["pt_path"])
        return progress

    def first_batch(state, x, *args, **kwargs):
        if not first_x:
            first_x.append(x.detach().cpu())
        return step_fn(state, x, *args, **kwargs)

    def seeded_rng(step):
        return torch.Generator(device=DEVICE).manual_seed(
            checkpoint.resume_seed(0, step)).get_state()

    def resume(ckpt_dir, flags, label, layers, fused, sigterm=False,
               pt_path=None):
        """One `oc_training --resume` run of JAX_RESUME_STEPS steps (with
        `pt_path`, the restored state saved there as a .pt); the counts
        set to 0 just before it and read just after."""
        captured.clear()
        captured["pt_path"] = pt_path
        first_x.clear()
        reset_counts()
        rec = StepRecorder()

        def hook(step, metrics):
            rec(step, metrics)
            if len(rec.steps) == JAX_RESUME_STEPS:
                if not sigterm:
                    raise _TwoSteps
                os.kill(os.getpid(), signal.SIGTERM)

        argv = ["--train_protocol_file", protocol, "--train_dataset_dir",
                train_dir, "--vocoded_dir", voc_dir, "--model", "aasist",
                "--cut", str(TRAIN_CUT), "--compactness_weight", "0.1",
                "--descriptiveness_weight", "0.9", "--checkpoint_dir",
                ckpt_dir, "--resume", *flags]
        if sigterm:
            argv += ["--checkpoint_every_steps", "1000"]
        t0 = time.perf_counter()
        try:
            oc_training.main(argv, on_step=hook)
        except _TwoSteps:
            pass
        wall = time.perf_counter() - t0
        counts = read_counts()
        add(counts)
        want = dict.fromkeys(counts, 0)
        want.update({"flash_attn_fwd": 2 * layers,
                     "flash_attn_bwd_dq": layers,
                     "flash_attn_bwd_dkv": layers,
                     "fused_adam": 1 if fused else 0})
        check_steps(f"jax-resume {label}", rec, want)
        if len(rec.steps) != JAX_RESUME_STEPS:
            fail(f"jax-resume {label}: {len(rec.steps)} steps")
        for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                     "flash_attn_bwd_dkv") + (("fused_adam",) if fused
                                              else ()):
            if not counts[name]:
                fail(f"jax-resume {label}: {name} never launched")
        gc.collect()
        torch.cuda.empty_cache()
        return dict(losses=[st["loss"] for st in rec.steps], wall_s=wall,
                    step_ms=[st["ms"] for st in rec.steps],
                    launches=rec.steps[0]["launches"],
                    first_x=first_x[0] if first_x else None,
                    read_s=captured.get("read_s"),
                    ready_s=captured.get("ready_s"),
                    state=captured.get("state"))

    def case(label, xcfg, optimizer, progress_after, num_epochs, flags,
             sigterm):
        """Train 2 steps from seed 0, write the JAX directory, resume it
        twice and its restored state once as a .pt."""
        layers = xcfg.encoder_layers
        fused = optimizer == "fused_adam"
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = AModel(AASISTConfig(), xcfg)
        cfg = TrainConfig(cut=TRAIN_CUT, compactness_weight=0.1,
                          descriptiveness_weight=0.9, optimizer=optimizer)
        losses = []
        reset_counts()
        state = train(model, ListPipeline(list(pipeline.epoch(0))[:2]), cfg,
                      logger=MetricsLogger(None, None), num_epochs=1,
                      device=DEVICE, on_step=lambda s, m: losses.append(
                          {k: float(m[k]) for k in ("loss", "closs",
                                                    "dloss")}))
        add(read_counts())
        written = state_snapshot(state)
        progress = None
        if progress_after:
            progress = {"epoch": 0, "dispatches": 2, "opt_steps": 2,
                        **{f"running_{k}": sum(m[k] for m in losses)
                           for k in ("loss", "closs", "dloss")}}
        ckpt_dir = os.path.join(workdir, f"jax_resume_{label}")
        os.makedirs(ckpt_dir)
        t0 = time.perf_counter()
        path = write_jax_checkpoint(state, ckpt_dir, prefix, xcfg,
                                    progress=progress)
        write_s = time.perf_counter() - t0
        del state, model
        gc.collect()
        torch.cuda.empty_cache()
        nbytes = _dir_bytes(path)
        before = dir_fingerprint(path)
        res = {"dir": os.path.basename(path), "bytes": nbytes,
               "write_s": write_s, "write_MBps": nbytes / 1e6 / write_s}
        print(f"[jax-resume] {label}: wrote {res['dir']} ({nbytes / 1e9:.3f} "
              f"GB) in {write_s:.2f} s ({res['write_MBps']:.0f} MB/s); "
              f"pre-write losses {[m['loss'] for m in losses]}", flush=True)

        if progress is None:
            want_x = list(pipeline.epoch(1))[0][0]
        else:
            want_x = list(pipeline.epoch(0))[progress["dispatches"]][0]
        pt_dir = ckpt_dir + "_pt"
        pt_path = (checkpoint.checkpoint_path(pt_dir, prefix, 0)
                   if progress is None else
                   checkpoint.step_checkpoint_path(pt_dir, prefix, 2))
        runs = {}
        for run, ck, pt in (("first", ckpt_dir, False),
                            ("second", ckpt_dir, False),
                            ("pt", pt_dir, True)):
            runs[run] = r = resume(ck, flags + ["--num_epochs",
                                                str(num_epochs)],
                                   f"{label} {run}", layers, fused,
                                   sigterm=sigterm and run == "second",
                                   pt_path=pt_path if run == "first"
                                   else None)
            if not pt:
                if r["state"] is None:
                    fail(f"jax-resume {label} {run}: the JAX directory was "
                         "not restored")
                n = same_state(r["state"], written, f"jax-resume {label}")
                if not torch.equal(r["state"]["rng"],
                                   seeded_rng(written["step"])):
                    fail(f"jax-resume {label}: the generator is not seeded "
                         "by resume_seed")
            if r["first_x"] is None or r["first_x"].numpy().tobytes() != \
                    np.asarray(want_x, np.float32).tobytes():
                fail(f"jax-resume {label} {run}: the first batch trained is "
                     "not the pipeline's next one")
            if run == "first":
                res.update(read_s=r["read_s"], ready_s=r["ready_s"],
                           read_MBps=nbytes / 1e6 / r["read_s"],
                           tensors_bit_for_bit=n)
            r["state"] = r["first_x"] = None
        first = runs["first"]["losses"]
        for run in ("second", "pt"):
            if runs[run]["losses"] != first:
                fail(f"jax-resume {label}: the {run} resume's losses "
                     f"{runs[run]['losses']} differ from the first's {first}")
        after = dir_fingerprint(path)
        if after != before:
            fail(f"jax-resume {label}: {path} changed under the port's runs")
        listing = sorted(os.listdir(ckpt_dir))
        epoch_ckpt, step_ckpt = checkpoint.find_resume(ckpt_dir, prefix)
        nxt = step_ckpt or epoch_ckpt
        if sigterm:
            if listing != sorted([res["dir"], f"{prefix}_step_2.pt"]) or \
                    nxt.jax:
                fail(f"jax-resume {label}: after the SIGTERM save the "
                     f"directory holds {listing}, and the next resume takes "
                     f"{nxt}")
        res.update(losses=first, pre_write_losses=[m["loss"] for m in losses],
                   listing=listing, next_resume=os.path.basename(nxt.path),
                   dir_unchanged=True,
                   runs={k: {x: v[x] for x in ("wall_s", "step_ms",
                                               "launches")}
                         for k, v in runs.items()})
        print(f"[jax-resume] {label}: {res['dir']} to a state ready to step "
              f"in {res['ready_s']:.2f} s (read {res['read_s']:.2f} s, "
              f"{res['read_MBps']:.0f} MB/s), {n} tensors bit for bit; "
              f"losses {first} (second and .pt resumes bit for bit); CLI "
              f"runs {[round(v['wall_s'], 1) for v in runs.values()]} s; "
              f"{path} unchanged beside {listing}; the next resume takes "
              f"{res['next_resume']}", flush=True)
        shutil.rmtree(ckpt_dir)
        shutil.rmtree(pt_dir)
        return res

    torch.use_deterministic_algorithms(True, warn_only=True)
    cwd = os.getcwd()
    os.chdir(workdir)  # loss.txt and metrics.jsonl land here
    for module, name, fn in ((checkpoint, "restore_jax_checkpoint",
                              restore_and_read),
                             (orbax, "restore_tree", timed_read),
                             (loop, "train_step", first_batch)):
        setattr(module, name, fn)
    try:
        out["a"] = case("a", XLSRConfig(attention_impl="flash"), "adam",
                        False, 2, [], sigterm=True)
        with cli_at_depth(DEPTH):
            out["b"] = case("b", at_depth(XLSRConfig(attention_impl="flash")),
                            "fused_adam", True, 1,
                            ["--optimizer", "fused_adam"], sigterm=False)
    finally:
        checkpoint.restore_jax_checkpoint = restore_jax
        orbax.restore_tree, loop.train_step = read_tree, step_fn
        os.chdir(cwd)
        torch.use_deterministic_algorithms(False)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[jax-resume] phase 23: {out['phase_s']:.1f} s", flush=True)
    return totals, out


# --------------------------------------------------------------- phase 24

# The wgmma route's panel kernels above head dim 256 (csrc/flash_attn_
# panel.cu; KERNEL_NAMES' form: wrapper counter -> (device kernel name,
# device launches a call)); the generic kernels above 256 count on the
# generic counters of COVERAGE_KERNEL_NAMES
OVER_256_KERNEL_NAMES = {
    "flash_attn_fwd_panel": ("flash_attn_fwd_panel_kernel", 1),
    "flash_attn_bwd_panel_dq": ("flash_attn_bwd_dq_panel_kernel", 1),
    "flash_attn_bwd_panel_dkv": ("flash_attn_bwd_dkv_panel_kernel", 1)}
# the panel widths (PW) the panel kernels are built at
PANEL_WIDTHS = (192, 256)
# the device kernels of the generic route above head dim 256
GENERIC_WIDE_NAMES = {"fwd": ("flash_attn_generic_fwd_wide_kernel",),
                      "bwd": ("flash_attn_generic_dq_wide_kernel",
                              "flash_attn_generic_dkv_wide_kernel")}
# (dtype, D, H) of phase 24's kernel checks, each at every T of KERNEL_TS
# (forward B 8, backward B 12) and timed at OVER_256_TIMED_TS: bf16 at
# D 264 and 320 (two panels of 192 columns), 512 (two of 256) and 1024
# (four of 256, one head: XLS-R 300M's width in a single head) on the
# panel kernels; bf16 at D 260 (not a multiple of 8) and fp32 at D 264
# and 512 on the generic kernels' panels of 256
OVER_256_ROWS = (("bfloat16", 264, H), ("bfloat16", 320, H),
                 ("bfloat16", 512, H), ("bfloat16", 1024, 1),
                 ("bfloat16", 260, H), ("float32", 264, H),
                 ("float32", 512, H))
OVER_256_TIMED_TS = (299, 1500)
# XLS-R 300M's published widths (XLSRConfig(): 24 layers, d 1024, FFN
# 4096) with 2 heads of 512: the panel kernels at the 300M model's width
# and depth, held to SCORE_RTOL as phase 22's 4 heads of 256
XLSR300M_D512 = dict(encoder_heads=2)
# the fp32 model of phase 24: the same widths at DEPTH layers, on the
# generic kernels' panels
OVER_256_FP32 = dict(encoder_heads=2, encoder_layers=DEPTH)


def sdpa_backend(fn) -> dict:
    """The backend SDPA ran for fn (its flash backend takes head dims up
    to 256), named from the device kernels of one profiled call: "cudnn",
    "flash", "efficient" (the memory-efficient fmha kernels) or "math"
    (GEMMs and a softmax); with those kernels' names."""
    names = sorted({e.name for e in profiled_events(fn, 1)})
    text = " ".join(names).lower()
    backend = ("not recorded" if not names else "cudnn" if "cudnn" in text
               else "flash" if "flash" in text
               else "efficient" if "fmha" in text or "efficient" in text
               else "math")
    return {"library_backend": backend,
            "library_kernels": [n[:96] for n in names]}


def over_256_attention_rows():
    """Phase 24's kernel checks: attention above head dim 256 at
    OVER_256_ROWS' (dtype, D, H), T in KERNEL_TS (forward at B 8, backward
    at B 12), on [B, T, H, D] views of one projection output and on
    [B*H, T, D] copies: views, copies and a repeat bit for bit, three
    launches of the route's counter (PANEL_* on the wgmma route, GENERIC_*
    otherwise) and none of any other attention kernel; each against its
    plain version (bf16 at phase 3's bounds, fp32 at
    COVERAGE_F32_RTOL_OF_MAX), the panel kernels also against the generic
    kernels on the same inputs (GENERIC_*); autograd at T 299
    (coverage_autograd). Timed at OVER_256_TIMED_TS: wrapper, device (one
    device launch a forward call, two a backward call and nothing else),
    plain, SDPA (wrapper and device, with the backend it ran), the generic
    kernels' wrapper time beside the panel kernels' ("was") and the bound.
    Returns (forward rows, backward rows)."""
    import torch
    import torch.nn.functional as F

    from occm_tpu_torch.ops.attention import (
        cuda_route, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_fwd, flash_attention_reference)

    attn_fwd = ("flash_attn_fwd", "flash_attn_fwd_other_d",
                "flash_attn_fwd_panel", "flash_attn_generic_fwd",
                "flash_attn_3xtf32_fwd")
    attn_bwd = tuple(f"flash_attn_bwd{fam}_{part}" for fam in (
        "", "_other_d", "_panel") for part in ("dq", "dkv")) + tuple(
            f"flash_attn_{fam}_bwd_{part}" for fam in ("generic", "3xtf32")
            for part in ("dq", "dkv"))
    gen = torch.Generator(device="cuda").manual_seed(24)
    fwd_rows, bwd_rows = [], []
    for dtype, d, h in OVER_256_ROWS:
        tdt = getattr(torch, dtype)
        panel = cuda_route(tdt, d) == "wgmma"
        fp32 = dtype == "float32"
        if panel:
            fwd_key = "flash_attn_fwd_panel"
            bwd_keys = ("flash_attn_bwd_panel_dq", "flash_attn_bwd_panel_dkv")
            names = {"fwd": (OVER_256_KERNEL_NAMES[fwd_key][0],),
                     "bwd": tuple(OVER_256_KERNEL_NAMES[k][0]
                                  for k in bwd_keys)}
        else:
            fwd_key = "flash_attn_generic_fwd"
            bwd_keys = ("flash_attn_generic_bwd_dq",
                        "flash_attn_generic_bwd_dkv")
            names = GENERIC_WIDE_NAMES
        route = "wgmma (panels)" if panel else "generic (panels)"
        for t in KERNEL_TS:
            for backward in (False, True):
                b = TRAIN_B if backward else B
                qkv = torch.randn((b, t, 3, h, d), generator=gen,
                                  device="cuda").to(tdt)
                q4, k4, v4 = qkv.unbind(2)

                def flat(x):
                    return x.permute(0, 2, 1, 3).reshape(
                        b * h, t, d).contiguous()

                q, k, v = flat(q4), flat(k4), flat(v4)
                reset_counts()
                out4, lse4 = flash_attention_fwd(q4, k4, v4, t)
                out, lse = flash_attention_fwd(q, k, v, t)
                again = flash_attention_fwd(q4, k4, v4, t)
                torch.cuda.synchronize()
                label = f"{dtype} D={d} B={b} H={h} T={t}"
                counts = read_counts()
                want = {key: 3 * (key == fwd_key) for key in attn_fwd}
                if {key: counts[key] for key in attn_fwd} != want:
                    fail(f"forward {label}: launches {counts}, want {want}")
                if not (out4.shape == q4.shape and out4.is_contiguous()
                        and torch.equal(flat(out4), out)
                        and torch.equal(lse4, lse)
                        and torch.equal(again[0], out4)
                        and torch.equal(again[1], lse4)):
                    fail(f"forward {label}: views, [B*H, T, D] and a "
                         "repeat do not agree bit for bit")
                vs_generic = None
                if not backward:
                    ref_out, ref_lse = flash_attention_reference(q, k, v, t)
                    if fp32:
                        errs = {"out": _rel_of_max(out, ref_out),
                                "lse": _rel_of_max(lse, ref_lse)}
                        bounds = {"out": COVERAGE_F32_RTOL_OF_MAX,
                                  "lse": COVERAGE_F32_RTOL_OF_MAX}
                    else:
                        errs = {"out": _abs_err(out, ref_out),
                                "lse": _abs_err(lse, ref_lse)}
                        bounds = {"out": OUT_ATOL, "lse": LSE_ATOL}
                    if not all(math.isfinite(e) and e <= bounds[n]
                               for n, e in errs.items()):
                        fail(f"forward {label} against its plain version: "
                             f"{errs} (bounds {bounds})")
                    if panel:
                        g_out, g_lse = generic_attention_fwd(q, k, v, t)
                        a, g = out.float(), g_out.float()
                        excess = float(((a - g).abs() - _ulp_bf16(
                            torch.maximum(a.abs(), g.abs()))).max()
                            / g.abs().max())
                        vs_generic = {"out_excess_of_max": excess,
                                      "out": _abs_err(a, g),
                                      "lse": _abs_err(lse, g_lse)}
                        if not (excess <= GENERIC_OUT_SLACK_OF_MAX
                                and vs_generic["lse"] <= GENERIC_LSE_ATOL):
                            fail(f"panel forward {label} against the "
                                 f"generic kernel: {vs_generic} (bounds "
                                 f"one ulp + {GENERIC_OUT_SLACK_OF_MAX} of "
                                 f"the largest |out|, {GENERIC_LSE_ATOL})")
                    max_abs = _abs_err(out, ref_out)
                    call = (lambda: flash_attention_fwd(q4, k4, v4, t))
                    generic = (lambda: generic_attention_fwd(q4, k4, v4, t))
                    plain = (lambda: flash_attention_reference(q, k, v, t))
                    counters = (fwd_key,)
                    q3, k3, v3 = (x.view(b, h, t, d) for x in (q, k, v))

                    def library():
                        with torch.no_grad():
                            F.scaled_dot_product_attention(q3, k3, v3)
                else:
                    do4 = torch.randn((b, t, h, d), generator=gen,
                                      device="cuda").to(tdt)
                    do = flat(do4)
                    reset_counts()
                    got4 = flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
                    rep = flash_attention_bwd(q4, k4, v4, out4, lse4, do4, t)
                    got = flash_attention_bwd(q, k, v, out, lse, do, t)
                    torch.cuda.synchronize()
                    counts = read_counts()
                    want = {key: 3 * (key in bwd_keys) for key in attn_bwd}
                    if {key: counts[key] for key in attn_bwd} != want:
                        fail(f"backward {label}: launches {counts}, want "
                             f"{want}")
                    for name, a, r, c in zip(("dq", "dk", "dv"), got4, rep,
                                             got):
                        if not (a.shape == q4.shape and a.is_contiguous()
                                and torch.equal(a, r)
                                and torch.equal(flat(a), c)):
                            fail(f"backward {label}: {name} of views, "
                                 "[B*H, T, D] and a repeat do not agree bit "
                                 "for bit, or is not contiguous")
                    ref = flash_attention_bwd_reference(q, k, v, out, lse,
                                                        do, t)
                    errs = {n: _rel_of_max(a, w) for n, a, w
                            in zip(("dq", "dk", "dv"), got, ref)}
                    bound = COVERAGE_F32_RTOL_OF_MAX if fp32 else (
                        BWD_RTOL_OF_MAX)
                    if not all(math.isfinite(e) and e <= bound
                               for e in errs.values()):
                        fail(f"backward {label} against its plain version: "
                             f"{errs} (relative to the largest |value|, "
                             f"bound {bound})")
                    if panel:
                        g_grads = generic_attention_bwd(q, k, v, out, lse,
                                                        do, t)
                        vs_generic = {n: _rel_of_max(a, w) for n, a, w
                                      in zip(("dq", "dk", "dv"), got,
                                             g_grads)}
                        if not all(e <= GENERIC_BWD_RTOL_OF_MAX
                                   for e in vs_generic.values()):
                            fail(f"panel backward {label} against the "
                                 f"generic kernels: {vs_generic} (bound "
                                 f"{GENERIC_BWD_RTOL_OF_MAX})")
                    if t == MAIN_PATH_TS[0]:
                        coverage_autograd(q4, k4, v4, do4, got4, label,
                                          bwd_keys)
                    max_abs = max(_abs_err(a, w) for a, w in zip(got, ref))
                    call = (lambda: flash_attention_bwd(
                        q4, k4, v4, out4, lse4, do4, t))
                    generic = (lambda: generic_attention_bwd(
                        q4, k4, v4, out4, lse4, do4, t))
                    plain = (lambda: flash_attention_bwd_reference(
                        q, k, v, out, lse, do, t))
                    counters = bwd_keys
                    q3, k3, v3 = (x.view(b, h, t, d).detach()
                                  .requires_grad_() for x in (q, k, v))
                    do3 = do.view(b, h, t, d)

                    def library():
                        o3 = F.scaled_dot_product_attention(q3, k3, v3)
                        torch.autograd.grad(o3, (q3, k3, v3), do3)

                row = dict(dtype=dtype, D=d, B=b, H=h, T=t, route=route,
                           panels=-(-d // 256), errors=errs,
                           max_abs_err=max_abs,
                           **({"vs_generic": vs_generic} if vs_generic
                              else {}))
                timed = t in OVER_256_TIMED_TS
                if timed:
                    iters = 10 if t <= 600 else 4
                    row["ms"] = cuda_ms(call, iters=iters, warmup=2)
                    dev_iters = 20 if row["ms"] * 20 <= 2000 else 5
                    dev_ms, own, every, kept = device_ms(
                        call, names["bwd" if backward else "fwd"],
                        iters=dev_iters, warmup=1, counters=counters)
                    launches = 2 if backward else 1
                    if (own, every) != (launches, launches):
                        fail(f"{label}: {every} device launches a call "
                             f"({own} of the kernels), want {launches} and "
                             "no other")
                    row["device_ms"] = dev_ms
                    row.update(events_kept(kept))
                    row["plain_ms"] = cuda_ms(plain, iters=2, warmup=1)
                    if panel:
                        row["was_ms"] = cuda_ms(generic, iters=iters,
                                                warmup=1)
                    row.update(sdpa_backend(library))
                    library_ms = cuda_ms(library, iters=iters, warmup=2)
                    library_dev = library_device_ms(library, iters=dev_iters,
                                                    warmup=1)
                    if backward:
                        with torch.no_grad():
                            fwd_only = (lambda: F.scaled_dot_product_attention(
                                q3, k3, v3))
                            library_ms -= cuda_ms(fwd_only, iters=iters,
                                                  warmup=2)
                            library_dev -= library_device_ms(
                                fwd_only, iters=dev_iters, warmup=1)
                    row["library_ms"] = library_ms
                    row["library_device_ms"] = library_dev
                    (row["bound_ms"], row["bound_by"], row["flops"],
                     row["bytes"]) = coverage_attention_bound(
                         b * h, t, d, dtype, backward)
                (bwd_rows if backward else fwd_rows).append(row)
                kind = "bwd" if backward else "fwd"
                times = (f"; wrapper {row['ms']:.4f} ms, device "
                         f"{row['device_ms']:.4f} ms, plain "
                         f"{row['plain_ms']:.4f} ms, sdpa "
                         f"{row['library_ms']:.4f} ms (device "
                         f"{row['library_device_ms']:.4f}, backend "
                         f"{row['library_backend']})"
                         + (f", was (generic) {row['was_ms']:.4f} ms"
                            if panel else "")
                         + f", bound {row['bound_ms']:.4f} ms "
                         f"({row['bound_by']})" if timed else "")
                print(f"[over-256] flash_attn_{kind} {route} {label}: "
                      f"against plain "
                      f"{ {k: f'{e:.3e}' for k, e in errs.items()} }"
                      + (f", against generic "
                         f"{ {k: f'{e:.3e}' for k, e in vs_generic.items()} }"
                         if vs_generic else "")
                      + "; views = [B*H, T, D] = repeat bit for bit" + times,
                      flush=True)
                del qkv, q, k, v, out, lse, out4, lse4, again
    torch.cuda.empty_cache()
    return fwd_rows, bwd_rows


def phase_over_256_kernels():
    """Phase 24's kernel checks (in a full run right after phase 22's):
    attention above head dim 256 (over_256_attention_rows)."""
    t0 = time.perf_counter()
    fwd, bwd = over_256_attention_rows()
    print(f"[over-256] phase 24's kernel checks: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {"fwd": fwd, "bwd": bwd}


def phase_over_256() -> tuple:
    """Phase 24's path after its kernel checks: XLS-R 300M's widths with 2
    heads of 512 in bf16 on the panel kernels (model_at_widths at
    XLSR300M_D512, SCORE_RTOL: no generic launch), then the same widths in
    fp32 at DEPTH layers on the generic kernels' panels (coverage_model at
    OVER_256_FP32: scoring and a training step through autograd against
    the plain path). The counts are set to 0 before each check and read
    after it; each kernel of the path must have launched. Returns (the
    path's counts, the results)."""
    t0 = time.perf_counter()
    counts, out = model_at_widths(XLSR300M_D512, "over-256", SCORE_RTOL, 24)
    out["bf16_s"] = time.perf_counter() - t0
    f_counts, out["fp32_model"] = coverage_model(None, OVER_256_FP32,
                                                 "over-256", speed=False)
    for key in (*OVER_256_KERNEL_NAMES, "ffn_fwd", "layernorm_bwd",
                "fused_adam"):
        if not counts.get(key):
            fail(f"phase 24's bf16 path never launched {key}: {counts}")
    for key in ("flash_attn_generic_fwd", "flash_attn_generic_bwd_dq",
                "flash_attn_generic_bwd_dkv"):
        if not f_counts.get(key):
            fail(f"phase 24's fp32 path never launched {key}: {f_counts}")
    total = {key: counts.get(key, 0) + f_counts.get(key, 0)
             for key in {*counts, *f_counts}}
    out["wall_s"] = time.perf_counter() - t0
    print(f"[over-256] phase 24's path: {out['wall_s']:.1f} s (bf16 "
          f"{out['bf16_s']:.1f} s), launches "
          f"{ {k: v for k, v in total.items() if v} }", flush=True)
    return total, out


def over_256_kernel_line(rows, launches):
    """Phase 24's {"kernels": [...]} entries: the panel kernels (bf16 at
    head dims above 256 that are multiples of 8) and the generic kernels
    above 256 (fp32, and bf16 off the multiples of 8), forward and
    backward, their head rows at D 512, T 299 ([B=8, T=299, H=16, D=512]
    forward, B 12 backward; bf16 for the panel kernels, fp32 for the
    generic ones), every row of the route under "per_shape". `launches`
    come from phase 24's path (the bf16 model's PANEL_*, the fp32 model's
    GENERIC_*), 0 with --kernels-only."""

    def head(kind, dtype):
        return next(r for r in rows[kind] if r["dtype"] == dtype
                    and r["D"] == 512 and r["T"] == MAIN_PATH_TS[0])

    def of(kind, panel):
        return [r for r in rows[kind] if r["route"].startswith("wgmma")
                is panel]

    keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "library_device_ms", "library_backend")
    replaced = "occm_tpu/ops/attention.py:"
    fwd_replaces = (f"{replaced}45 (_fwd_kernel), {replaced}234 "
                    "(_blocked_fwd_kernel)")
    bwd_replaces = (f"{replaced}79 (_bwd_kernel), {replaced}350 "
                    f"(_blocked_dq_kernel), {replaced}373 "
                    "(_blocked_dkv_kernel)")
    entries = []
    for panel, dtype in ((True, "bfloat16"), (False, "float32")):
        fwd, bwd = head("fwd", dtype), head("bwd", dtype)
        which = ("in bf16 at head dims above 256 that are multiples of 8"
                 if panel else "in fp32, and in bf16 off the multiples of "
                 "8, at head dims above 256")
        source = ("occm_tpu_torch/csrc/flash_attn_panel.cu" if panel
                  else "occm_tpu_torch/csrc/flash_attn_generic.cu")
        fwd_key = ("flash_attn_fwd_panel" if panel
                   else "flash_attn_generic_fwd")
        dq_key, dkv_key = (("flash_attn_bwd_panel_dq",
                            "flash_attn_bwd_panel_dkv") if panel
                           else ("flash_attn_generic_bwd_dq",
                                 "flash_attn_generic_bwd_dkv"))
        dt = "bf16" if panel else "fp32"
        extra = ({"was": "the generic kernels' panels, "
                         "csrc/flash_attn_generic.cu"} if panel else {})
        entries += [
            {"name": ("flash_attn_fwd_panel" if panel
                      else "flash_attn_generic_fwd_over_256"),
             "route": "cuda", "source": source,
             "replaces": f"{fwd_replaces}, {which}",
             "launches": launches[fwd_key],
             "shape": f"[B={B}, T={fwd['T']}, H={H}, D=512] {dt} views",
             "max_abs_err": max(r["max_abs_err"] for r in of("fwd", panel)),
             **{k: fwd[k] for k in keys},
             **({"was_ms": fwd["was_ms"]} if panel else {}),
             "library": f"SDPA, {dt}", **extra,
             "per_shape": of("fwd", panel)},
            {"name": ("flash_attn_bwd_panel" if panel
                      else "flash_attn_generic_bwd_over_256"),
             "route": "cuda", "source": source,
             "replaces": f"{bwd_replaces}, {which}",
             "launches": launches[dq_key], "launches_dkv": launches[dkv_key],
             "shape": f"[B={TRAIN_B}, T={bwd['T']}, H={H}, D=512] {dt} views",
             "max_abs_err": max(r["max_abs_err"] for r in of("bwd", panel)),
             **{k: bwd[k] for k in keys},
             **({"was_ms": bwd["was_ms"]} if panel else {}),
             "library": f"SDPA forward + backward minus forward, {dt}",
             **extra, "per_shape": of("bwd", panel)},
        ]
    return entries


def kernel_line(fwd_rows, bwd_rows, ln, adam, ffn_rows, hgmma, launches):
    """The {"kernels": [...]} entries. Times, errors and bounds are this
    run's, at the shape named in each entry: `ms` the wrapper's time per
    call (CUDA events), `device_ms` the kernel's own device time per call
    (torch.profiler); `launches` come from the main path (scoring, serving
    and training), 0 with --kernels-only."""
    head = next(r for r in fwd_rows if r["T"] == MAIN_PATH_TS[0])
    bhead = next(r for r in bwd_rows if r["T"] == MAIN_PATH_TS[0])
    fhead = next(r for r in ffn_rows if r["M"] == FFN_MAIN_M
                 and r["D"] == 1024 and r["gelu"] == "erf")

    return [
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_fwd.cu",
         "replaces": "occm_tpu/ops/attention.py:45 (_fwd_kernel), "
                     "occm_tpu/ops/attention.py:234 (_blocked_fwd_kernel)",
         "launches": launches["flash_attn_fwd"],
         "shape": f"[B={B}, T={head['T']}, H={H}, D={D}] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in fwd_rows),
         **{k: head[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms",
                                 "library_device_ms")},
         "sass_hgmma": {k: n for k, n in hgmma.items()
                        if "flash_attn_fwd" in k}, "per_T": fwd_rows},
        {"name": "flash_attn_bwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_bwd.cu",
         "replaces": "occm_tpu/ops/attention.py:79 (_bwd_kernel), "
                     "occm_tpu/ops/attention.py:350 (_blocked_dq_kernel), "
                     "occm_tpu/ops/attention.py:373 (_blocked_dkv_kernel)",
         "launches": launches["flash_attn_bwd"],
         "shape": f"[B={TRAIN_B}, T={bhead['T']}, H={H}, D={D}] bf16 views",
         "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
         **{k: bhead[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms",
                                  "library_device_ms")},
         "sass_hgmma": {k: n for k, n in hgmma.items()
                        if "flash_attn_bwd" in k}, "per_T": bwd_rows},
        {"name": "layernorm_bwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/layernorm_bwd.cu",
         "replaces": "occm_tpu/ops/layernorm.py:46 (_bwd_kernel)",
         "launches": launches["layernorm_bwd"],
         "shape": f"[{ln['shape'][0]}, {ln['shape'][1]}] bf16",
         **{k: ln[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms",
                               "library_device_ms", "per_shape")}},
        {"name": "fused_adam", "route": "cuda",
         "source": "occm_tpu_torch/csrc/fused_adam.cu",
         "replaces": "occm_tpu/ops/fused_adam.py:58 (_kernel)",
         "launches": launches["fused_adam"],
         "shape": f"{adam['leaves']} fp32 leaves, {adam['params']} params",
         **{k: adam[k] for k in ("max_abs_err", "ms", "device_ms",
                                 "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "library_device_ms")}},
        {"name": "ffn_fwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/ffn_fwd.cu",
         "replaces": "occm_tpu/ops/ffn.py:50 (_kernel)",
         "launches": launches["ffn_fwd"],
         "shape": f"x [{FFN_MAIN_M}, 1024] x W1 [1024, 4096] bf16, erf GELU",
         "max_abs_err": max(r["max_abs_err"] for r in ffn_rows),
         **{k: fhead[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms",
                                  "library_device_ms")},
         "library": "F.linear, F.gelu, F.linear (ffn_impl=\"xla\")",
         "sass_hgmma": {k: n for k, n in hgmma.items()
                        if "ffn_gemm_kernel" in k}, "per_M": ffn_rows},
    ]


def coverage_kernel_line(rows, launches):
    """Phase 20's {"kernels": [...]} entries: the generic attention forward
    and backward, the 3xTF32 attention forward and backward (head rows
    fp32 at XLS-R's shape, [B, T=299, H=16, D=64]; every row under
    "per_shape"; the route sweeps under "route_sweep") and the fp32 FFN
    kernels (head rows [2392, 1024] x [1024, 4096], erf). The generic
    kernels' and the SIMT FFN's head rows are their "was" rows, timed on
    the same inputs as the 3xTF32 kernels that took over their shapes.
    `launches` come from phase 20's paths, 0 with --kernels-only; a kernel
    that keeps no shape of those paths says so in "launches_note"."""

    def head(kind, kernel, **match):
        return next(r for r in rows[kind] if r["kernel"] == kernel
                    and all(r[k] == v for k, v in match.items()))

    def per_shape(kind, kernel):
        return [r for r in rows[kind] if r["kernel"] == kernel]

    keys = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms")
    main_t = dict(dtype="float32", D=64, T=MAIN_PATH_TS[0])
    fwd = head("fwd", "flash_attn_generic_fwd", B=B, **main_t)
    tf32_fwd = head("fwd", "flash_attn_3xtf32_fwd", B=B, **main_t)
    bwd = head("bwd", "flash_attn_generic_bwd", **main_t)
    tf32_bwd = head("bwd", "flash_attn_3xtf32_bwd", **main_t)
    ffn = head("ffn", "ffn_fwd_f32", M=FFN_MAIN_M, gelu="erf")
    tf32_ffn = head("ffn", "ffn_fwd_3xtf32", M=FFN_MAIN_M, gelu="erf")
    replaced = "occm_tpu/ops/attention.py:"
    bwd_shape = (f"[B={TRAIN_B}, T={MAIN_PATH_TS[0]}, H={H}, D=64] fp32 "
                 "views")
    ffn_shape = f"x [{FFN_MAIN_M}, 1024] x W1 [1024, 4096] fp32, erf GELU"
    off_path = ("no shape of phase 20's paths: the 3xTF32 kernels take "
                "every fp32 shape there; timed on the same inputs")
    fwd_shape = f"[B={B}, T={MAIN_PATH_TS[0]}, H={H}, D=64] fp32 views"
    generic_fwd = {
        "name": "flash_attn_generic_fwd", "route": "cuda",
        "source": "occm_tpu_torch/csrc/flash_attn_generic.cu",
        "replaces": f"{replaced}45 (_fwd_kernel), {replaced}234 "
                    "(_blocked_fwd_kernel), in fp32 at head dims the 3xTF32 "
                    "forward does not take and in bf16 at head dims the "
                    "wgmma kernels do not take",
        "launches": launches["flash_attn_generic_fwd"],
        "shape": fwd_shape, **{k: fwd[k] for k in keys},
        "library": "SDPA, same dtype",
        "per_shape": per_shape("fwd", "flash_attn_generic_fwd")}
    if not launches["flash_attn_generic_fwd"]:
        generic_fwd["launches_note"] = off_path
    return [
        generic_fwd,
        {"name": "flash_attn_3xtf32_fwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_fwd_3xtf32.cu",
         "replaces": f"{replaced}45 (_fwd_kernel), {replaced}234 "
                     "(_blocked_fwd_kernel), in fp32",
         "launches": launches["flash_attn_3xtf32_fwd"],
         "shape": fwd_shape, **{k: tf32_fwd[k] for k in keys},
         "was_ms": tf32_fwd["was_ms"],
         "was_device_ms": tf32_fwd["was_device_ms"],
         "library": "SDPA, same dtype",
         "per_shape": per_shape("fwd", "flash_attn_3xtf32_fwd"),
         "route_sweep": rows["fwd_route"]},
        {"name": "flash_attn_generic_bwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_generic.cu",
         "replaces": f"{replaced}79 (_bwd_kernel), {replaced}350 "
                     f"(_blocked_dq_kernel), {replaced}373 "
                     "(_blocked_dkv_kernel), in fp32 at head dims the "
                     "3xTF32 pair does not take and in bf16 at head dims "
                     "the wgmma pair does not take",
         "launches": launches["flash_attn_generic_bwd_dq"],
         "launches_dkv": launches["flash_attn_generic_bwd_dkv"],
         "launches_note": off_path,
         "shape": bwd_shape, **{k: bwd[k] for k in keys},
         "library": "SDPA forward + backward minus forward, same dtype",
         "per_shape": per_shape("bwd", "flash_attn_generic_bwd")},
        {"name": "flash_attn_3xtf32_bwd", "route": "cuda",
         "source": "occm_tpu_torch/csrc/flash_attn_bwd_3xtf32_dq.cu, "
                   "occm_tpu_torch/csrc/flash_attn_bwd_3xtf32_dkv.cu",
         "replaces": f"{replaced}79 (_bwd_kernel), {replaced}350 "
                     f"(_blocked_dq_kernel), {replaced}373 "
                     "(_blocked_dkv_kernel), in fp32",
         "launches": launches["flash_attn_3xtf32_bwd_dq"],
         "launches_dkv": launches["flash_attn_3xtf32_bwd_dkv"],
         "shape": bwd_shape, **{k: tf32_bwd[k] for k in keys},
         "was_ms": tf32_bwd["was_ms"],
         "was_device_ms": tf32_bwd["was_device_ms"],
         "library": "SDPA forward + backward minus forward, same dtype",
         "per_shape": per_shape("bwd", "flash_attn_3xtf32_bwd"),
         "route_sweep": rows["bwd_route"]},
        {"name": "ffn_fwd_f32", "route": "cuda",
         "source": "occm_tpu_torch/csrc/ffn_fwd_f32.cu",
         "replaces": "occm_tpu/ops/ffn.py:50 (_kernel), in fp32 at D or F "
                     "not a multiple of 4",
         "launches": launches["ffn_fwd_f32"], "launches_note": off_path,
         "shape": ffn_shape, **{k: ffn[k] for k in keys},
         "library": "F.linear, F.gelu, F.linear (fp32)",
         "per_shape": per_shape("ffn", "ffn_fwd_f32")},
        {"name": "ffn_fwd_3xtf32", "route": "cuda",
         "source": "occm_tpu_torch/csrc/ffn_fwd_3xtf32.cu",
         "replaces": "occm_tpu/ops/ffn.py:50 (_kernel), in fp32",
         "launches": launches["ffn_fwd_3xtf32"],
         "shape": ffn_shape, **{k: tf32_ffn[k] for k in keys},
         "was_ms": tf32_ffn["was_ms"],
         "was_device_ms": tf32_ffn["was_device_ms"],
         "library": "F.linear, F.gelu, F.linear (fp32)",
         "per_shape": per_shape("ffn", "ffn_fwd_3xtf32")},
    ]


def phase_profile_train(model, batch, cfg):
    """Device time by kernel class for one full training step (12 x 6 s,
    every kernel), through train_step as train() runs it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occm_tpu_torch.train.state import create_train_state
    from occm_tpu_torch.train.loop import train_step

    state = create_train_state(model, cfg)
    x = torch.from_numpy(batch[0]).to(DEVICE)
    labels = torch.from_numpy(batch[1]).long().to(DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, x, labels, cfg)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    report_profile(prof, window_us, 1, "training step 12 x 6 s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="after the main path, print device time by kernel "
                         "for full batches of the two flash buckets and "
                         "for one full training step")
    ap.add_argument("--kernels-only", action="store_true",
                    help="run phases 1-3 only (device, build, kernel "
                         "checks); launches are then 0")
    ap.add_argument("--controls-only", action="store_true",
                    help="run phases 1, 2 and 8 only (device, build, the "
                         "training controls); prints no kernels line")
    ap.add_argument("--rawboost-only", action="store_true",
                    help="run phases 1, 2 and 9-11 only (device, build, "
                         "RawBoost on the card, training with RawBoost, "
                         "--pretrained_xlsr); prints no kernels line")
    ap.add_argument("--models-only", action="store_true",
                    help="run phases 1, 2 and 12 only (device, build, the "
                         "other models and scoring modes 1c1 / 2c1); "
                         "prints no kernels line")
    ap.add_argument("--remat-only", action="store_true",
                    help="run phases 1, 2 and 13 only (device, build, the "
                         "remat policies and --fast_numerics); prints no "
                         "kernels line")
    ap.add_argument("--native-only", action="store_true",
                    help="run phases 1, 2 and 14 only (device, build, the "
                         "native IO lane in scoring, serving and training "
                         "input); prints no kernels line")
    ap.add_argument("--base-only", action="store_true",
                    help="run phases 1, 2 and 15 only (device, build, the "
                         "wav2vec2-base frontend through every kernel); "
                         "prints no kernels line")
    ap.add_argument("--int8-only", action="store_true",
                    help="run phases 1, 2 and 16 only (device, build, W8A8 "
                         "int8 scoring, serving and the parity gate); "
                         "prints no kernels line")
    ap.add_argument("--parallel-only", action="store_true",
                    help="run phases 1, 2 and 17 only (device, build, the "
                         "multi-GPU paths: dp / fsdp / tp training over two "
                         "ranks on the card, the NCCL world-size-1 graph, "
                         "data-parallel scoring and serving); prints no "
                         "kernels line")
    ap.add_argument("--extras-only", action="store_true",
                    help="run phases 1, 2 and 18 only (device, build, the "
                         "other layouts, PGD, the feature bank, the linear "
                         "SVM, profiling, --debug_nans, --wandb_project); "
                         "prints no kernels line")
    ap.add_argument("--orbax-only", action="store_true",
                    help="run phases 1, 2 and 19 only (device, build, the "
                         "JAX package's orbax checkpoints without orbax: "
                         "write, read, export, and scoring, serving, "
                         "training and the XLS-R graft from a directory); "
                         "prints no kernels line")
    ap.add_argument("--coverage-only", action="store_true",
                    help="run phases 1, 2 and 20 only (device, build, the "
                         "generic attention kernels, the 3xTF32 attention "
                         "forward and backward and the fp32 FFN kernels: "
                         "checks against "
                         "their plain versions, the "
                         "fp32 model at full width, the tiny model under "
                         "auto, pinned flash and through the CLIs); prints "
                         "no kernels line")
    ap.add_argument("--xlsr1b-only", action="store_true",
                    help="run phases 1, 2 and 21 only (device, build, the "
                         "wgmma attention kernels at bf16 head dims other "
                         "than 64: checks against their plain versions and "
                         "the generic kernels, XLS-R 1B's widths at full "
                         "depth (D 80): scoring, a training step, utt/s); "
                         "prints no kernels line")
    ap.add_argument("--wide-head-only", action="store_true",
                    help="run phases 1, 2 and 22 only (device, build, the "
                         "wgmma attention kernels at bf16 head dims 136, "
                         "192 and 256: checks against their plain versions "
                         "and the generic kernels, XLS-R 300M's widths "
                         "with 4 heads of 256: scoring, a training step, "
                         "utt/s); prints no kernels line")
    ap.add_argument("--jax-resume-only", action="store_true",
                    help="run phases 1, 2 and 23 only (device, build, "
                         "oc_training --resume from the JAX package's epoch "
                         "and step orbax directories at full width); prints "
                         "no kernels line")
    ap.add_argument("--over-256-only", action="store_true",
                    help="run phases 1, 2 and 24 only (device, build, "
                         "attention above head dim 256: the panel kernels "
                         "and the generic kernels' panels against their "
                         "plain versions, XLS-R 300M's widths with 2 heads "
                         "of 512: scoring, a training step, utt/s, and an "
                         "fp32 model at D 512); prints no kernels line")
    ap.add_argument("--parallel-rank", nargs=4, metavar=("RANK", "WORLD",
                                                          "PORT", "WORKDIR"),
                    help=argparse.SUPPRESS)  # phase 17's rank processes
    ap.add_argument("--debug-nans-child", metavar="ARGV_JSON",
                    help=argparse.SUPPRESS)  # phase 18's NaN run
    args = ap.parse_args(argv)
    if args.parallel_rank:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        rank, world, port, workdir = args.parallel_rank
        return parallel_rank(int(rank), int(world), int(port), workdir)
    if args.debug_nans_child:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return debug_nans_child(args.debug_nans_child)

    t_run = time.perf_counter()
    smi = phase_device()
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    hgmma = phase_build()
    if (args.controls_only or args.rawboost_only or args.models_only
            or args.remat_only or args.native_only or args.base_only
            or args.int8_only or args.parallel_only or args.extras_only
            or args.orbax_only or args.coverage_only or args.xlsr1b_only
            or args.wide_head_only or args.jax_resume_only
            or args.over_256_only):
        from occm_tpu_torch.ops import _build

        workdir = tempfile.mkdtemp(prefix="smoke_", dir=_build.BUILD_DIR)
        try:
            fixture_dir = os.path.join(workdir, "fixture")
            os.makedirs(fixture_dir)
            fixture = write_fixture(fixture_dir)
            if args.controls_only:
                result = {"controls": phase_train_controls(workdir,
                                                           fixture)[2]}
            elif args.rawboost_only:
                result = {"rawboost": phase_rawboost_all(workdir,
                                                         fixture)[2]}
            elif args.remat_only:
                result = {"remat": phase_remat(workdir, fixture)[2]}
            elif args.native_only:
                model, ckpt = build_seed_model(workdir)
                del model
                result = {"native": phase_native(workdir, fixture, ckpt)[2]}
            elif args.base_only:
                result = {"base": phase_base(workdir, fixture)[2]}
            elif args.int8_only:
                rows = phase_int8_kernels()
                model, ckpt = build_seed_model(workdir)
                del model
                result = {"int8": dict(phase_int8(workdir, fixture, ckpt)[1],
                                       products=rows)}
            elif args.coverage_only:
                rows = phase_coverage_kernels()
                tiny = phase_tiny_auto()
                counts, cov = phase_coverage(workdir, fixture)
                result = {"coverage": dict(cov, tiny=tiny, kernels=rows,
                                           launches=counts)}
            elif args.xlsr1b_only:
                rows = phase_wide_kernels()
                counts, wide = phase_xlsr1b()
                result = {"xlsr1b": dict(wide, kernels=rows,
                                         launches=counts)}
            elif args.wide_head_only:
                rows = phase_wide_head_kernels()
                counts, wide = phase_wide_head()
                result = {"wide_head": dict(wide, kernels=rows,
                                            launches=counts)}
            elif args.over_256_only:
                rows = phase_over_256_kernels()
                counts, over = phase_over_256()
                result = {"over_256": dict(over, kernels=rows,
                                           launches=counts)}
            elif args.jax_resume_only:
                counts, jax_resume = phase_jax_resume(workdir, fixture)
                result = {"jax_resume": dict(jax_resume, launches=counts)}
            elif args.orbax_only:
                model, ckpt = build_seed_model(workdir)
                del model
                result = {"orbax": phase_orbax(workdir, fixture, ckpt)[1]}
            elif args.extras_only:
                model, _ = build_seed_model(workdir)
                result = {"extras": phase_extras(workdir, fixture,
                                                 model)[1]}
                del model
            elif args.parallel_only:
                rows = phase_parallel_kernels()
                rows = dict(tp2=rows, **phase_pipeline_kernels(rows))
                counts, par = phase_parallel(workdir, fixture)
                result = {"parallel": dict(par, kernels=rows,
                                           launches=counts)}
            else:
                result = {"models": phase_models(workdir, fixture)[2]}
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(smi)
        print(json.dumps(result, default=str))
        return 0
    fwd_rows = phase_kernels()
    bwd_rows = phase_attention_bwd()
    ln = phase_layernorm_bwd()
    adam = phase_fused_adam()
    ffn_rows = phase_ffn()
    # phase 20's kernel checks: the generic attention, 3xTF32 attention and
    # fp32 FFN kernels
    cov_rows = phase_coverage_kernels()
    # phase 21's: the wgmma attention kernels at head dims other than 64
    wide_rows = phase_wide_kernels()
    # phase 22's: the same kernels at bf16 head dims 136-256
    wide_head_rows = phase_wide_head_kernels()
    # phase 24's: attention above head dim 256
    over_rows = phase_over_256_kernels()
    # phase 15's kernel checks here, beside phase 3's: late in a full run
    # (after phases 4-13's graphs and profiled CLI runs) torch.profiler on
    # the H100 came back with too few device events in every repeat of a
    # session, while its sessions this early have kept every record
    base_rows = None if args.kernels_only else phase_base_kernels()
    int8_rows = None if args.kernels_only else phase_int8_kernels()
    par_rows = pipe_rows = None
    if not args.kernels_only:
        par_rows = phase_parallel_kernels()
        pipe_rows = phase_pipeline_kernels(par_rows)
    print(f"[smoke] the kernel checks ended at "
          f"{time.perf_counter() - t_run:.1f} s", flush=True)
    launches = dict.fromkeys(
        ("flash_attn_fwd", "flash_attn_bwd", "layernorm_bwd", "fused_adam",
         "ffn_fwd"), 0)
    graph_launches = dict.fromkeys(launches, 0)
    cov_launches = dict.fromkeys(COVERAGE_KERNEL_NAMES, 0)
    wide_launches = dict.fromkeys(WIDE_KERNEL_NAMES, 0)
    wide_head_launches = dict.fromkeys(WIDE_KERNEL_NAMES, 0)
    over_launches = dict.fromkeys(
        (*OVER_256_KERNEL_NAMES, "flash_attn_generic_fwd",
         "flash_attn_generic_bwd_dq", "flash_attn_generic_bwd_dkv"), 0)
    if not args.kernels_only:
        from occm_tpu_torch.ops import _build

        workdir = tempfile.mkdtemp(prefix="smoke_", dir=_build.BUILD_DIR)
        try:
            fixture_dir = os.path.join(workdir, "fixture")
            os.makedirs(fixture_dir)
            fixture = write_fixture(fixture_dir)
            phase_tiny_auto()
            model, ckpt = build_seed_model(workdir)
            artifacts, score_launches, _ = phase_scoring(
                workdir, model, ckpt, fixture)
            serve_launches, reference = phase_main_path(model, ckpt,
                                                        artifacts)
            if args.profile:
                phase_profile(model, reference, ckpt)
            # phase 18 on the seed model, early: torch.profiler's sessions
            # lose device events late in a full run (phase 15's note)
            e_counts, extras = phase_extras(workdir, fixture, model)
            del model
            train_launches = phase_train(workdir, fixture, args.profile)
            print(f"[smoke] phases 4-7 ended at "
                  f"{time.perf_counter() - t_run:.1f} s", flush=True)
            # phase 20's paths: the fp32 model at full width and the tiny
            # model through the CLIs, on the 3xTF32 attention and FFN
            # kernels
            c_counts, coverage = phase_coverage(workdir, fixture)
            for name in cov_launches:
                cov_launches[name] = c_counts[name]
            # phase 21's path: XLS-R 1B's widths on the D 80 instance
            w_counts, xlsr1b = phase_xlsr1b()
            for name in wide_launches:
                wide_launches[name] = w_counts[name]
            # phase 22's path: XLS-R 300M's widths on the D 256 instances
            h_counts, wide_head = phase_wide_head()
            for name in wide_head_launches:
                wide_head_launches[name] = h_counts[name]
            # phase 24's path: XLS-R 300M's widths with 2 heads of 512 on
            # the panel kernels, and in fp32 on the generic kernels' panels
            v_counts, over_256 = phase_over_256()
            for name in over_launches:
                over_launches[name] = v_counts.get(name, 0)
            # phase 23: oc_training --resume from the JAX package's
            # directories
            j_counts, jax_resume = phase_jax_resume(workdir, fixture)
            control_counts, replayed, controls = phase_train_controls(
                workdir, fixture)
            rb_counts, rb_replayed, rawboost = phase_rawboost_all(workdir,
                                                                  fixture)
            # phase 19 right after phase 11, on its fairseq file and on
            # phase 4's seed .pt and eval set
            o_counts, orbax_out = phase_orbax(
                workdir, fixture, ckpt,
                fairseq_pt=rawboost["pretrained"].pop("fairseq_pt"),
                scoring=(artifacts, os.path.join(artifacts, "eval"),
                         os.path.join(artifacts, "eval.txt")))
            m_counts, m_replayed, models = phase_models(workdir, fixture)
            r_counts, r_replayed, remat = phase_remat(workdir, fixture)
            b_counts, b_replayed, base = phase_base(workdir, fixture,
                                                    kernels=False)
            base["kernels"] = base_rows
            int8_launches, int8_out = phase_int8(workdir, fixture, ckpt)
            int8_out["products"] = int8_rows
            n_counts, n_replayed, native_io = phase_native(workdir, fixture,
                                                           ckpt)
            # the multi-GPU paths last: phase 17's NCCL group is made and
            # destroyed in this process
            p_counts, parallel = phase_parallel(workdir, fixture, ckpt)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        launches["flash_attn_fwd"] += serve_launches + int8_launches
        for name in ("flash_attn_fwd", "layernorm_bwd", "fused_adam",
                     "ffn_fwd"):
            launches[name] += e_counts.get(name, 0)
        launches["flash_attn_bwd"] += e_counts.get("flash_attn_bwd_dq", 0)
        for counts in (score_launches, train_launches):
            for name, n in counts.items():
                launches[name] += n
        # the wrappers' counts of phases 8, 10-13 (eager steps, warm-ups
        # and captures); a graph's replays launch what its capture recorded
        for counts, replays in ((control_counts, replayed),
                                (rb_counts, rb_replayed),
                                (m_counts, m_replayed),
                                (r_counts, r_replayed),
                                (n_counts, n_replayed),
                                (b_counts, b_replayed)):
            for name in ("flash_attn_fwd", "layernorm_bwd", "fused_adam",
                         "ffn_fwd"):
                launches[name] += counts[name]
                graph_launches[name] += replays.get(name, 0)
            launches["flash_attn_bwd"] += counts["flash_attn_bwd_dq"]
            graph_launches["flash_attn_bwd"] += replays.get(
                "flash_attn_bwd_dq", 0)
        print(f"[controls] {json.dumps(controls, default=str)}", flush=True)
        print(f"[rawboost] {json.dumps(rawboost, default=str)}", flush=True)
        print(f"[models] {json.dumps(models, default=str)}", flush=True)
        print(f"[remat] {json.dumps(remat, default=str)}", flush=True)
        print(f"[native] {json.dumps(native_io, default=str)}", flush=True)
        print(f"[base] {json.dumps(base, default=str)}", flush=True)
        print(f"[int8] {json.dumps(int8_out, default=str)}", flush=True)
        print(f"[parallel] {json.dumps(parallel, default=str)}", flush=True)
        print(f"[extras] {json.dumps(extras, default=str)}", flush=True)
        print(f"[orbax] {json.dumps(orbax_out, default=str)}", flush=True)
        print(f"[coverage] {json.dumps(coverage, default=str)}", flush=True)
        print(f"[xlsr1b] {json.dumps(xlsr1b, default=str)}", flush=True)
        print(f"[wide-head] {json.dumps(wide_head, default=str)}",
              flush=True)
        print(f"[jax-resume] {json.dumps(jax_resume, default=str)}",
              flush=True)
        print(f"[over-256] {json.dumps(over_256, default=str)}", flush=True)
        # phase 17's path: the ranks', the NCCL run's and the scoring runs'
        # and phase 19's: scoring, serving and training from a directory
        # and phase 21's and 22's: their steps run the FFN, LayerNorm and
        # Adam kernels too; and phase 23's resumed runs, and phase 24's
        # path
        for counts in (p_counts, o_counts, w_counts, h_counts, j_counts,
                       v_counts):
            for name in ("flash_attn_fwd", "layernorm_bwd", "fused_adam",
                         "ffn_fwd"):
                launches[name] += counts.get(name, 0)
            launches["flash_attn_bwd"] += counts.get("flash_attn_bwd_dq", 0)

    print(f"[smoke] phases 1-24 took {time.perf_counter() - t_run:.1f} s",
          flush=True)
    print(smi)
    kernels = kernel_line(fwd_rows, bwd_rows, ln, adam, ffn_rows, hgmma,
                          launches)
    for entry in kernels:
        entry["graph_replay_launches"] = graph_launches[entry["name"]]
        if not args.kernels_only:  # phase 15's rows at base's shapes
            entry["base"] = base["kernels"][entry["name"]]
            # phase 17's rows at the per-rank shapes: tp=2 (attention at
            # 8 heads, the FFN at F 2048), dp=2 (LayerNorm on a rank's
            # rows), fsdp=2 (Adam over rank 0's shards)
            key = {"layernorm_bwd": "dp2", "fused_adam": "fsdp2"}.get(
                entry["name"], "tp2")
            entry[key] = par_rows[entry["name"]]
            # and pp=2 (a microbatch of 3 rows, stage 0's leaves) and
            # tp=2 + sp (the LayerNorm on a frame block)
            for key, rows in pipe_rows.items():
                entry[key] = rows[entry["name"]]
    kernels += coverage_kernel_line(cov_rows, cov_launches)
    kernels += wide_kernel_line(wide_rows, wide_launches)
    kernels += wide_head_kernel_line(wide_head_rows, wide_head_launches)
    kernels += over_256_kernel_line(over_rows, over_launches)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
