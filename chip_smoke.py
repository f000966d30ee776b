"""Smoke test of the PyTorch port (idc_models_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (or another
sm_90a card). Phases, each printing its own lines; any failure exits
non-zero before the result line:

1. device -- require CUDA; print the card's name and power limit;
2. build  -- compile every hand-written kernel from
   idc_models_tpu_torch/ops/csrc/ with nvcc (one process per source, all
   started together), print each one's ptxas registers and fail on a
   register spill in the depthwise or the flash kernels;
3. parity -- TF32 off; the fused depthwise kernel against its plain
   PyTorch version at every shape the main path gives it (f32 bit for
   bit, and bf16), on the op grid of the card tests (C 1/6/8/960, H = W
   1/2/4/25/50, stride 1 and 2, 1x1/3x3/5x5/3x1, f32 and bf16: every
   path), on misaligned and strided x, with an inf weight on a padding
   tap (NaN as the plain version) and a NaN in x (through the clamp),
   with its in-launch BN fold against fold_bn + the affine kernel, plus
   one backward; the secure
   masking kernel against its plain version bit for bit (sizes 1 to
   14.7M, 1 to 10 clients, seeds 0 and 0xFFFFFFFF, inputs at and past
   the clip and at exact half-steps), and its masks cancelling over the
   8 clients of a round;
4. main path -- two paths, each with every launch count set to 0 just
   before it and read just after:
   (a) `cli.main(["mobile", "--depthwise-impl", "fused", ...])`:
       MobileNetV2 at full width, batch 32, lr 1e-4, fine-tune at 100,
       one epoch per phase on 512 synthetic 50x50 patches, then
       `predict` over the test split with the trained weights; launches
       held to the count the schedule implies, every one on the kernel's
       3x3 vector path, predictions held against the cuDNN (grouped)
       build of the same weights;
   (b) `cli.main(["secure-fed", "--mask-impl", "pallas", ...])`: the
       secure_fed preset (the small CNN at full width, 8 clients, 5 local
       epochs, batch 32, percent 0.5) for 3 rounds on 2048 synthetic
       10x10 patches; launches held to rounds x clients = 24, finite
       round metrics, no client recovered, nothing clipped;
   (a2) the same `mobile` argv with `--cache-features`: the fused
       kernel's launches held to the cached schedule (11 chains a batch
       of the frozen prefix's features, 6 a suffix eval forward, none a
       suffix train step) and its phase-2 history to (a)'s (rtol 1e-4);
   (a3) `vgg` and `vgg --cache-features` at full width (VGG16, 50x50,
       batch 32, lr 1e-3, fine-tune at 15): no hand kernel launched,
       finite metrics, cached against uncached history, the card's eval
       logits against the CPU's on the trained weights (TF32 off,
       1e-4 (1 + max |logit|));
   (a4) `dense` and `dense --cache-features` at full width
       (DenseNet201 with packed blocks, CIFAR-10 stand-in at 32x32,
       batch 256, 10 classes, two passes an epoch, fine-tune at 150, so
       phase 2 runs a backward through packed blocks): the same checks,
       plus packed against concat on the card -- eval logits bit for
       bit, phase-2 gradients within 1e-4 of each tensor's largest
       |gradient|;
   then (c) one `secure_aggregate` of fixed MobileNetV2 client updates
   through the kernel, through threefry on the card and through the
   plain version on the CPU, held bit-identical to each other and to
   dequantize(sum of quantize); (d) one MobileNetV2 secure round
   through the kernel (50x50, 2 clients x 32 patches);
5. times -- CUDA-event times of each kernel, its plain version and the
   nearest library call (for the masking kernel: the threefry path) at
   the main path's shapes and at larger ones, with the least time the
   card could take (the depthwise kernel: device time behind a sleep
   kernel, through the wrapper, the profiler's device us a launch and
   the wrapper's host us a call, at batch 32 and 4096, f32, and bf16 at
   4096; the host us of the wrapper's pieces beside the grouped chain
   it replaces); host-clock times of the train steps (with kernels a call and
   device busy of the fused and the grouped build), of the VGG16 and
   DenseNet201 steps (phase 1, phase 2, cached phase 2, eval: host ms,
   device busy, idle share, kernels a call, peak memory), of the
   DenseNet201 eval forward packed against concat, and of secure
   rounds (pallas against threefry);
6. flash -- the three flash kernels of the causal LM
   (ops/flash_block_kernel.py; their ptxas lines must show no register
   spills): parity against their plain versions over a grid (causal or
   not; offsets [0,0], [128,0], [0,128], [32,96] (which cuts a tile's
   causal span inside a chunk) with a mid-stream carry, and [0,32] with a
   fresh one (rows 0-31 see no key, so the update kernel's vote fails
   and it walks every chunk); a single fully masked fold into a fresh
   carry, compared raw, and the same block folded before a visible one;
   a fully masked backward block that must give exact zeros; Tq 256
   against Tk 512; D 16 to 128; f32 and bf16; the main path's
   1x16384x8x64), the
   pallas ring's values and gradients against full attention at T=2048,
   the backward's memory rise at T=16384 (under 1 GB), then two paths,
   each with every launch count set to 0 just before it and read just
   after: (e) `cli.main(["lm", ...])` at the repo's serving width (vocab
   1024, embed 512, 8 heads, MLP 2048, 2 blocks), T=16384, batch 1,
   `--block-impl pallas`, 4 steps (8 launches of each kernel); (f) a
   bf16-cache pallas `Generator` at t_max 32768 answering prompts of
   16384, 4096 and 1000 tokens (6 forward launches), its prefill logits
   and caches held against the plain (jnp) Generator; then times of each
   kernel, its plain version and SDPA at T=4096 and 16384 (f32, bf16)
   beside the bound (f32 inputs at the TF32 tensor-core peak, with the
   f32 FMA peak beside it; each kernel's computed steps beside the
   visible pairs), and the `lm` train step, pallas against jnp;

7. fed -- (g) `cli.main(["fed", ...])` at the fed preset's width (VGG16,
   50x50, batch 32, lr 1e-3 to pretrain and 1e-4 for the clients,
   fine-tune at 15, 10 clients: 8 train and 2 test, 1 local epoch), cut
   to 2048 synthetic patches, one pretraining epoch and 3 rounds (each cut
   printed): no hand kernel launched (every count set to 0 just before
   and read just after), finite round metrics, no client dropped, both
   checkpoints (pretrained/cp.ckpt, fed_server) complete; the same argv
   at 4 rounds restores the pretrained weights, resumes from round 3 and
   appends one round record; a fault drill (nan:1 drops one client;
   sign_flip:0-1:x1000 under trimmed_mean --trim 2 stays finite and
   flags both attackers in clients_trimmed); one make_fedavg_round from
   the carried server on the card against the CPU in float64 (VGG16, 4
   clients x 32 patches, full-shard steps, 1e-4 (1 + max |w|) a tensor),
   and the same in f32 (TF32 off) over 6 data draws, measured and not
   held (RMSprop's first step amplifies f32 rounding 1000x); host ms of
   a round (mean and trimmed mean, in turns), its device busy, idle
   share, kernels and peak memory, and the pretraining epoch's seconds;
8. population -- (h) `fed --population` at the fed preset's width
   (VGG16, 50x50, batch 32, clients at lr 1e-4 with every layer
   training): 10,000 virtual clients, cohort 32, 16 examples a client,
   each path with every launch count set to 0 just before it and read
   just after (none may launch): (h1) sync in 4 waves of 8 for 3 rounds
   (finite metrics, 4 waves a round, three fed_cohort records with the
   frozen keys), then a restart at 4 rounds that runs round 3 alone;
   (h2) the same argv with `--async-buffer 8` (at least one buffered
   update a round, the mean staleness printed); (h4) a small-CNN
   straggler drill, `--fault-delay-ms 250`, sync against async (the
   sync round holding the straggler lasts at least its 0.5 s barrier);
   then (h3) one wave against `make_fedavg_round` on the materialized
   cohort, bit for bit (cuDNN deterministic, TF32 off), and 4 waves
   within rtol 2e-5, atol 2e-6 of 1 wave; (h5) a round's peak memory at
   population 10,000 and 1,000,000, which must not grow; host ms of a
   round (1 wave, 4 waves, async; in turns), device busy, idle share,
   kernels and peak memory;
9. observe and stream -- (i) `cli.main(["profile", ...])` on VGG16,
   MobileNetV2 (`--depthwise-impl fused`) and DenseNet201 at the bench
   batches (configs.BENCH_TRAIN_CONFIGS: 2048, 4096, 2048) in bf16 and on
   the LM (vocab 8192, embed 1024, 4 blocks, T=512, batch 8, f32), 8
   measured steps each: the records' frozen key sets, the card's name,
   MFU in (0, 1], a verdict, a host-wait share in [0, 1], each record's
   FLOPs and bytes equal to the op count of its counted call plus, for
   mobile, exactly the fused kernel's analytic account, the kernel's
   launches (11 chains x 18 steps), no compile; `profile --churn-drill`
   flagged; `--trace-out` on the `mobile` argv of (a) and the `fed` argv
   of (g) (their spans, and `stats --json` with the metrics snapshot),
   the `fed` run with `--profile-dir`, which files its first attempt as
   fed.round; `--profile-dir` on that `mobile` argv, whose trace holds
   one fused_depthwise kernel event per launch in its window and whose
   metrics snapshot holds the train.step account with its peak memory; `mobile --stream
   --decode-workers 2` over 512 PNG patches (written with zlib) against
   two_phase_fit on the same file-level split, equal losses and launches
   (cuDNN deterministic); `vgg --central-storage` against the mirrored
   run within rtol 1e-4 (cuDNN deterministic, TF32 off);
10. attention -- right after the flash phases: the pallas zigzag ring's
   values and gradients against the plain zigzag ring and full attention
   at 1x2048x8x64 (f32 at the ring tests' tolerances; bf16 per tensor,
   ||err|| / ||want|| <= 2^-7); the three flash kernels against their
   plain versions at every quarter fold a 4-rank zigzag ring makes (B=2,
   H=8, quarters of 256 cut as the ring cuts them, f32 and bf16); an
   AttentionClassifier with remat against one without (values and
   gradients, dropout 0 and 0.1); then (j) `cli.main(["attention",
   ...])` at the JAX bench's width (T=16,384, 8 features, embed 512, 8
   heads, MLP 2048, 2 blocks, batch 1, --block-impl pallas), 3 steps on
   8 synthetic sequences and a validation pass over 2, three runs
   (contiguous, --layout zigzag, --layout zigzag --remat), each with the
   launch counts set to 0 just before and read just after and held to
   its schedule (per block a step: 1/1/1, 3/3/3, 6/3/3 update/dq/dkv;
   an eval forward 1 or 3 updates), finite losses and val with AUROC,
   the zigzag and remat losses against the contiguous run's, and one
   batch's gradients at that width, zigzag and remat against contiguous
   per tensor (the losses cannot see a gradient's scale); later, with
   the times, the three layouts' train steps (host ms, device busy, idle
   share, kernels, peak memory), an emulated ring-of-8 rank-7 forward
   schedule at t_local 16,384 in bf16 (contiguous against zigzag), and
   each kernel at the path's 8,192 x 8,192 quarters ([0, 0] and [8192,
   8192] causal, [8192, 0] unmasked), held against its plain version
   there and timed;
11. dist -- right after the `mobile` paths, the distribution layer on a
   world of one card: without a process group, the LM's plan path
   (LM_RULES over a 1-rank fsdp x tp x seq mesh, the vocab-parallel
   loss) against the plain path, 3 steps at the `lm` width; then a
   1-rank NCCL group started here through a file:// rendezvous in a
   temporary directory (its backend must be nccl, an all-reduce on the
   card must give its input), and on it, each with the launch counts
   set to 0 just before and read just after: `mobile --depthwise-impl
   fused` through the data-parallel path (506 B1 launches, epochs
   within DIST_RERUN_RTOL of the un-meshed run's), `lm --fsdp 1 --tp 1
   --seq-parallel 1` at lm_path's flags (8 launches of each flash
   kernel, losses against lm_path's) and `attention --seq-parallel 1`
   (10/6/6, losses against the contiguous run's); and the layer's cost
   at world size 1, host ms of the `vgg` b32 phase-2 step and the `lm`
   step (plain and plan paths) without and with the group, in turns;
   the group is taken down at the end;
12. serve -- right after the serving Generator, the continuous-batching
   server (serve/) at that width (t_max 32,768, 8 slots, windows of 16),
   replaying a burst of 24 Poisson requests (prompts 128-16,384 tokens,
   budgets 16-128), each run with the launch counts set to 0 just before
   and read just after: (k1) LMServer(block_impl="pallas", bf16 caches),
   greedy, B3 launched 48 times (once a block a prefill) and no backward
   kernel; (k2) int8 caches, against a one-slot int8 engine; (k3)
   prefill_chunk=512, no flash launch, against the chunked Generator;
   (k4) sampled (temperature 0.8, top-k 50, seeded requests) against the
   serial sampled Generator; every request ok and its tokens equal to
   its serial reference's up to the first near tie (SERVE_TOL); then
   TTFT (queue wait + prefill), the window at 8 live slots (ms a step,
   tokens/s, device busy, idle share, kernels, peak memory) and warm
   prefill ms at the 4,096 and 16,384 buckets; (k5) `cli.main(["serve",
   ...])` at that width (t_max 1,024) with --metrics-port 0, scraped
   while it serves, no kernel launched;

then one JSON line of per-kernel numbers, and the last line
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}`.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# H100 SXM data-sheet peaks (dense): HBM bytes/s, f32 outside the tensor
# cores (a depthwise conv has no contraction for the tensor cores to take)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# int32 operations: at most 128 lanes per SM per clock -- four warp
# schedulers, each dispatching one 32-lane instruction a clock; the same
# rate, an FMA counted twice, gives the data sheet's 67 TFLOP/s f32 --
# times 132 SMs, times the SM clock read from nvidia-smi at run time. (The
# 64-lane rate of the int32 ALU pipe alone is no bound for this kernel:
# its multiplies run on the FMA pipe beside it, and it ran at 14.7M
# elements in less time than 64 lanes would allow.)
INT32_LANES_PER_SM, H100_SMS = 128, 132
# the secure masking kernel's work per element, counted from its source:
# 8 bytes (f32 in, int32 out); 5 operations (the clip's min and max, the
# scale, one round-and-convert, the index product) plus 18 per peer with
# a nonzero sign (the seed xor; two fmix32 of 3 shift/xor pairs = 12;
# their 4 multiplies; the signed add, one multiply-add)
MASK_BYTES_PER_ELEM, MASK_OPS_BASE, MASK_OPS_PER_PEER = 8, 5, 18
SB, CLIP = 20, 64.0
MASK_SIZES = [1, 127, 1_920, 192_576, 2**20 + 3, 14_714_688]
MASK_TIME_SIZES = [1_920, 192_576, 262_144, 4_194_304, 14_714_688,
                   33_554_432]

F32_TOL = dict(rtol=1e-5, atol=1e-6)   # same f32 arithmetic, same order
BF16_TOL = dict(rtol=1e-2, atol=1e-2)  # one bf16 rounding of equal f32 sums
OP_GRID = [(1, 8, 6), (2, 7, 6), (2, 25, 32), (1, 25, 96)]  # stride,size,C
BATCH, SIZE, BENCH_BATCH = 32, 50, 4096


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def tf32_off(torch) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def fused_inputs(torch, gen, n, h, c, dtype):
    x = torch.randn(n, h, h, c, device="cuda", generator=gen).to(dtype)
    w = torch.randn(3, 3, 1, c, device="cuda", generator=gen) * 0.3
    mul = torch.randn(c, device="cuda", generator=gen) * 0.5 + 1.0
    add = torch.randn(c, device="cuda", generator=gen) * 0.5
    return x, w, mul, add


def parity(torch, fc, mobilenet) -> float:
    """Kernel vs plain version on the card; returns the largest f32
    |kernel - plain| at the main path's shapes (0.0: bit for bit)."""
    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [(BATCH, c["h_in"], c["c"], c["stride"], True)
             for c in mobilenet.fused_call_shapes(BATCH, SIZE)]
    main_path = len(cases)
    cases += [(2, size, c, s, clamp) for s, size, c in OP_GRID
              for clamp in (True, False)]
    worst = 0.0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for k, (n, h, c, s, clamp) in enumerate(cases):
            x, w, mul, add = fused_inputs(torch, gen, n, h, c, dtype)
            got = fc.fused_depthwise_affine(x, w, mul, add, stride=s,
                                            clamp6=clamp)
            torch.cuda.synchronize()
            want = fc.reference_impl(x, w, mul, add, stride=s, clamp6=clamp)
            torch.testing.assert_close(
                got.float(), want.float(), **tol,
                msg=lambda m: f"{dtype} n={n} {h}x{h}x{c} s{s}: {m}")
            if dtype == torch.float32 and k < main_path:
                worst = max(worst, (got - want).abs().max().item())
    log(f"parity: {len(cases)} shapes x f32/bf16 match the plain version "
        f"(f32 rtol 1e-5 atol 1e-6, bf16 rtol 1e-2 atol 1e-2); "
        f"max f32 |err| at the main path's shapes {worst!r}")
    if worst != 0.0:
        raise SystemExit(f"the f32 depthwise kernel differs from its plain "
                         f"version by {worst!r} at the main path's shapes")

    # the op grid of the card tests, each case on the path the predicate
    # names; then misaligned (a 1-element storage offset) and strided x
    paths = dict.fromkeys(fc.PATHS, 0)
    n_grid = 0
    for dtype, tol in ((torch.float32, F32_TOL), (torch.bfloat16, BF16_TOL)):
        for (kh, kw), c, h, s in [(k, c, h, s)
                                  for k in ((1, 1), (3, 3), (5, 5), (3, 1))
                                  for c in (1, 6, 8, 960)
                                  for h in (1, 2, 4, 25, 50)
                                  for s in (1, 2)]:
            x = torch.randn(2, h, h, c, device="cuda",
                            generator=gen).to(dtype)
            w = torch.randn(kh, kw, 1, c, device="cuda", generator=gen) * 0.3
            mul = torch.randn(c, device="cuda", generator=gen) + 1.0
            add = torch.randn(c, device="cuda", generator=gen)
            clamp = (h + c + s) % 2 == 0
            path = fc.depthwise_path(c, kh, kw, s, s, x.element_size(),
                                     vector_ok=fc.vector_ok(x, w))
            before = fc.PATH_LAUNCHES[path]
            got = fc.fused_depthwise_affine(x, w, mul, add, stride=s,
                                            clamp6=clamp)
            torch.cuda.synchronize()
            if fc.PATH_LAUNCHES[path] != before + 1:
                raise SystemExit(f"{(c, h, s, kh, kw)} did not take the "
                                 f"{path} path")
            paths[path] += 1
            torch.testing.assert_close(
                got.float(), fc.reference_impl(
                    x, w, mul, add, stride=s, clamp6=clamp).float(), **tol,
                msg=lambda m: f"{dtype} {(c, h, s, kh, kw)}: {m}")
            n_grid += 1
        _, w, mul, add = fused_inputs(torch, gen, 2, 13, 64, dtype)
        base = torch.randn(2 * 13 * 13 * 64 + 1, device="cuda",
                           generator=gen).to(dtype)
        for x in (base[1:].view(2, 13, 13, 64),
                  base[:-1].view(2, 13, 13, 64).transpose(1, 2),
                  base[:-1].view(2, 64, 13, 13).permute(0, 2, 3, 1)):
            for s in (1, 2):
                torch.testing.assert_close(
                    fc.fused_depthwise_affine(x, w, mul, add,
                                              stride=s).float(),
                    fc.reference_impl(x, w, mul, add, stride=s).float(),
                    **tol)
                n_grid += 1
    log(f"parity: the op grid (C 1/6/8/960, H 1/2/4/25/50, stride 1/2, "
        f"1x1/3x3/5x5/3x1, f32/bf16) and misaligned or strided x, "
        f"{n_grid} cases, match the plain version; the grid's launches by "
        f"path {paths}")

    # TF-SAME padding contributes 0 * w: an inf weight on a padding tap
    # gives the references' NaNs; a NaN in x passes through the clamp
    x, w, mul, add = fused_inputs(torch, gen, 1, 5, 8, torch.float32)
    w[0, 0, 0, 0] = float("inf")
    got = fc.fused_depthwise_affine(x, w, mul, add, clamp6=False)
    want = fc.reference_impl(x, w, mul, add, clamp6=False)
    x2, w2, mul2, add2 = fused_inputs(torch, gen, 1, 6, 8, torch.float32)
    x2[0, 2, 2, 3] = float("nan")
    got2 = fc.fused_depthwise_affine(x2, w2, mul2, add2)
    nans = (int(got.isnan().sum()), int(want.isnan().sum()),
            int(got2.isnan().sum()))
    log(f"parity: an inf weight on a padding tap gives {nans[0]} NaNs "
        f"(plain {nans[1]}); a NaN in x gives {nans[2]} NaN outputs through "
        f"the clamp (expected 9)")
    if (not nans[0] or nans[2] != 9
            or not torch.equal(got.isnan(), want.isnan())):
        raise SystemExit(f"NaN handling differs from the plain version: "
                         f"{nans}")

    # the BN fold inside the launch against fold_bn + the affine kernel
    folds = []
    for call in mobilenet.fused_call_shapes(BATCH, SIZE):
        c, s = call["c"], call["stride"]
        x, w, _, _ = fused_inputs(torch, gen, BATCH, call["h_in"], c,
                                  torch.float32)
        bn = (torch.randn(c, device="cuda", generator=gen),
              torch.randn(c, device="cuda", generator=gen),
              torch.randn(c, device="cuda", generator=gen),
              torch.rand(c, device="cuda", generator=gen) + 0.1)
        got = fc.fused_depthwise_bn_relu6(x, w, *bn, eps=1e-3, stride=s)
        want = fc.fused_depthwise_affine(x, w, *fc.fold_bn(*bn, 1e-3),
                                         stride=s)
        folds.append(torch.equal(got, want))
    log(f"parity: the in-launch BN fold equals fold_bn + the affine kernel "
        f"bit for bit at {sum(folds)} of {len(folds)} main-path shapes")
    if not all(folds):
        raise SystemExit("the in-launch BN fold differs from fold_bn")

    # one backward through the autograd.Function vs autograd of the plain
    x, w, mul, add = fused_inputs(torch, gen, BATCH, 13, 144, torch.float32)
    g = torch.randn(BATCH, 7, 7, 144, device="cuda", generator=gen)
    grads = []
    for fn in (fc.fused_depthwise_affine, fc.reference_impl):
        ins = [t.detach().clone().requires_grad_() for t in (x, w, mul, add)]
        y = fn(*ins, stride=2, clamp6=True)
        y.backward(g)
        torch.cuda.synchronize()
        grads.append([y.detach()] + [t.grad for t in ins])
    for name, a, b in zip(("y", "dx", "dw", "dmul", "dadd"), *grads):
        torch.testing.assert_close(a, b, **F32_TOL, msg=f"backward {name}")
    log("parity: backward through the autograd.Function matches autograd "
        "of the plain version (32x13x13x144, stride 2)")
    return worst


def main_path(torch, fc, mobilenet, card: str, extra=()) -> dict:
    """Drive the port's `mobile` verb through the kernel and hold its
    launches, outputs and predictions to what the schedule implies."""
    from idc_models_tpu_torch import cli, convert
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, train_val_test_split,
    )
    from idc_models_tpu_torch.data.pipeline import Loader
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.models.pretrained import load_pretrained_file
    from idc_models_tpu_torch.ops import secure_masking_kernel as smk
    from idc_models_tpu_torch.train.loop import predict

    preset = get_preset("mobile")
    n_examples, seed = 512, 0
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["mobile", "--depthwise-impl", "fused", "--synthetic-examples",
                str(n_examples), "--epochs", "1", "--fine-tune-epochs", "1",
                "--seed", str(seed), *extra, "--path", tmp]
        imgs, labels = synthetic.make_idc_like(n_examples, preset.image_size,
                                               seed=seed)
        train, val, test = train_val_test_split(ArrayDataset(imgs, labels),
                                                seed=seed)
        fc.KERNEL.launches = smk.KERNEL.launches = 0
        fc.PATH_LAUNCHES.update(dict.fromkeys(fc.PATHS, 0))
        t0 = time.perf_counter()
        rc = cli.main(argv)
        params, state = load_pretrained_file(Path(tmp) / "model.npz")
        model = registry.get_model(preset.model).build(
            preset.num_outputs, **registry.FUSED_BUILD_KWARGS[preset.model])
        convert.load_jax(model, params, state).cuda()
        logits = predict(model, test.images, batch_size=preset.batch_size)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = fc.KERNEL.launches
        paths = dict(fc.PATH_LAUNCHES)
        if smk.KERNEL.launches:
            raise SystemExit(f"the mobile path launched the masking kernel "
                             f"{smk.KERNEL.launches} times")
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "run.jsonl").read_text().splitlines()]
    if rc != 0:
        raise SystemExit(f"cli.main returned {rc}")

    epochs = [r for r in records if r["event"] == "epoch"]
    tests = [r for r in records if r["event"] == "test"]
    if len(epochs) != 2 or len(tests) != 1:
        raise SystemExit(f"expected 2 epoch records and 1 test record, "
                         f"got {[r['event'] for r in records]}")
    for r in epochs + tests:
        for k in ("loss", "accuracy", "val_loss", "val_accuracy", "auroc"):
            if k in r and not math.isfinite(r[k]):
                raise SystemExit(f"non-finite {k} in {r}")
    if not {"accuracy", "auroc"} <= set(tests[0]):
        raise SystemExit(f"test metrics lack accuracy/AUROC: {tests[0]}")
    if logits.shape != (len(test), 1) or not np.isfinite(logits).all():
        raise SystemExit(f"predict gave {logits.shape}, finite "
                         f"{bool(np.isfinite(logits).all())}")

    # launches: 17 chains per eval/predict forward and phase-1 train
    # forward, 11 per phase-2 train forward (fine_tune_at=100)
    bs = preset.batch_size
    steps = len(Loader(train, bs))
    val_fwd, test_fwd = -(-len(val) // bs), -(-len(test) // bs)
    # the untrained floor (at most 20 batches), both epochs' validation,
    # the test evaluation and predict
    eval_forwards = min(val_fwd, 20) + 2 * val_fwd + 2 * test_fwd
    phase1 = mobilenet.fused_chain_count(mobilenet.FREEZE_ALL, train=True)
    phase2 = mobilenet.fused_chain_count(preset.fine_tune_at, train=True)
    evals = mobilenet.fused_chain_count(preset.fine_tune_at, train=False)
    if (phase1, phase2, evals) != (17, 11, 17):
        raise SystemExit(f"fused chains per forward {phase1}/{phase2}/"
                         f"{evals}, expected 17/11/17")
    expected = (phase1 + phase2) * steps + evals * eval_forwards
    log(f"main path: cli.main({' '.join(argv[:-1])} <tmp>) + predict "
        f"over {len(test)} test patches in {seconds!r} s; "
        f"epochs {[(r['loss'], r['val_loss']) for r in epochs]}; "
        f"test {tests[0]}; fused kernel launches {launches} "
        f"(expected 17 x ({steps} phase-1 train + {eval_forwards} eval/"
        f"predict forwards) + 11 x {steps} phase-2 train = {expected}); "
        f"{card}")
    if launches != expected:
        raise SystemExit(f"kernel launches {launches} != {expected}")
    log(f"main path: fused launches by kernel path {paths}")
    if paths["3x3"] != launches:
        raise SystemExit(f"main-path launches off the 3x3 vector path: "
                         f"{paths}")

    # the trained model's predictions through the kernel vs the grouped
    # (cuDNN) build of the same weights, TF32 off
    tf32_off(torch)
    grouped = registry.get_model(preset.model).build(
        preset.num_outputs, **registry.UNFUSED_BUILD_KWARGS[preset.model])
    convert.load_jax(grouped, params, state).cuda()
    ref = predict(grouped, test.images, batch_size=bs)
    err = float(abs(logits - ref).max())
    log(f"main path: predictions vs the grouped build of the same weights, "
        f"max |diff| {err!r} (tolerance 1e-3)")
    if not err <= 1e-3:
        raise SystemExit(f"fused and grouped predictions differ by {err}")
    return {"launches": launches, "steps": steps, "epochs": epochs}


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_times(torch, fc, mobilenet, batch: int, card: str,
                 dtype=None) -> dict:
    """Times of the kernel at the 17 main-path shapes of `batch`, summed
    over one forward: device ms (CUDA events behind a sleep kernel, so
    the host never binds), ms through the wrapper (CUDA events), the
    plain version, cuDNN's grouped conv (device ms; conv only), the
    least time the card could take, the profiler's device us a launch,
    and the wrapper's host us a call (the BN wrapper the model calls,
    under no_grad, host clock over a loop of calls)."""
    import torch.nn.functional as F

    dtype = dtype or torch.float32
    gen = torch.Generator(device="cuda").manual_seed(1)
    iters = 50 if batch <= BATCH else 10
    keys = ("ms", "wrapper_ms", "plain_ms", "library_ms", "bound_ms",
            "bytes", "flops", "host_us")
    tot = dict.fromkeys(keys, 0.0)
    calls = []
    for call in mobilenet.fused_call_shapes(batch, SIZE):
        c, s = call["c"], call["stride"]
        x, w, mul, add = fused_inputs(torch, gen, batch, call["h_in"], c,
                                      dtype)
        y = fc.fused_depthwise_affine(x, w, mul, add, stride=s)
        # bytes: x read once, y written once, w/mul/add read once
        nbytes = (x.numel() + y.numel()) * x.element_size() + (
            w.numel() + 2 * c) * 4
        flops = y.numel() * (2 * 9 + 3)
        bound = max(nbytes / PEAK_BYTES_PER_S,
                    flops / PEAK_F32_FLOP_PER_S) * 1e3
        xc = x.permute(0, 3, 1, 2)                       # channels_last
        wc = w.permute(3, 2, 0, 1).contiguous().to(dtype)  # [C, 1, 3, 3]
        del y
        fn = (lambda x=x, w=w, mul=mul, add=add, s=s:
              fc.fused_depthwise_affine(x, w, mul, add, stride=s))
        calls.append(fn)
        dev = device_ms(torch, fn, iters)
        t = time_ms(torch, fn, iters)
        p = time_ms(torch, lambda: fc.reference_impl(
            x, w, mul, add, stride=s), max(iters // 5, 2))
        lib = device_ms(torch, lambda: F.conv2d(xc, wc, None, s, 1, 1, c),
                        iters)
        bn = (mul, add, add, mul.abs())
        with torch.no_grad():
            host = host_us(torch, lambda: fc.fused_depthwise_bn_relu6(
                x, w, *bn, eps=1e-3, stride=s))
        plan = fc.depthwise_tiles(batch, call["h_in"], call["h_in"], c, 3, 3,
                                  s, s, x.element_size())
        log(f"time b{batch} {str(dtype)[6:]} {call['h_in']}x{call['h_in']}x"
            f"{c} s{s}: kernel {dev!r} ms on the device, {t!r} ms through "
            f"the wrapper, wrapper host {host!r} us a call, plain {p!r} ms, "
            f"cudnn {lib!r} ms, bound {bound!r} ms ({nbytes} B); tiles "
            f"{plan.rows}x{plan.cols} rows x cols, {plan.cvec} vectors a "
            f"slab, walk {plan.walk}, {plan.blocks} blocks of "
            f"{plan.threads}, {plan.smem} B shared; {card}")
        for k, v in (("ms", dev), ("wrapper_ms", t), ("plain_ms", p),
                     ("library_ms", lib), ("bound_ms", bound),
                     ("bytes", nbytes), ("flops", flops), ("host_us", host)):
            tot[k] += v
    us = profile_kernels(torch, lambda: [fn() for fn in calls],
                         ["fused_depthwise"], n=2)["fused_depthwise"]
    tot["device_us_per_launch"] = us
    tot["host_us"] /= len(calls)
    del calls
    torch.cuda.empty_cache()
    log(f"time b{batch} {str(dtype)[6:]} sum of the 17 calls of one forward: "
        f"kernel {tot['ms']!r} ms on the device ({us!r} us a launch under the "
        f"profiler), {tot['wrapper_ms']!r} ms through the wrapper (the "
        f"wrapper's host time {tot['host_us']!r} us a call), plain "
        f"{tot['plain_ms']!r} ms, cuDNN F.conv2d(groups=C) channels_last "
        f"(conv only, no affine/clamp: the nearest library yardstick) "
        f"{tot['library_ms']!r} ms, bound {tot['bound_ms']!r} ms "
        f"({tot['bytes']!r} B at 3.35 TB/s; kernel at "
        f"{tot['bound_ms'] / tot['ms']!r} of it); {card}")
    return tot


def host_us(torch, fn, n: int = 300, warmup: int = 20) -> float:
    """Host-clock us a call of `fn` over a loop of `n` calls, before the
    synchronize: where the card finishes a call faster than the host
    issues it, the host's cost of one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def wrapper_pieces(torch, fc, card: str) -> None:
    """Host us of the pieces of one fused chain's call at batch 32
    (13x13x144, stride 1), under no_grad, beside the grouped chain it
    replaces (cuDNN's depthwise conv, the BN layer, ReLU6): the pieces
    the wrapper keeps, and those it dropped (the fold's five ops, the
    .to(float32) generator, the device context on every call,
    current_stream)."""
    from idc_models_tpu_torch.models import core

    gen = torch.Generator(device="cuda").manual_seed(3)
    x, w, scale, bias = fused_inputs(torch, gen, BATCH, 13, 144,
                                     torch.float32)
    mean = torch.randn(144, device="cuda", generator=gen)
    var = torch.rand(144, device="cuda", generator=gen) + 0.1
    bn = (scale, bias, mean, var)
    dw = core.DepthwiseConv2d(144, 3, impl="grouped").cuda()
    norm = core.BatchNorm(144, frozen=True).cuda().eval()
    with torch.no_grad():
        dw.kernel.copy_(w)
        for name, t in zip(("scale", "bias", "mean", "var"), bn):
            getattr(norm, name).copy_(t)
    path, g, y_shape = fc._plan(x.shape, x.stride(), x.dtype, 3, 3, (1, 1),
                                True, True, 1e-3, True)
    y = torch.empty(y_shape, device="cuda")
    lib = fc.KERNEL.lib()
    import ctypes
    args = (ctypes.byref(g), x.data_ptr(), w.data_ptr(),
            *(t.data_ptr() for t in bn), y.data_ptr(),
            torch._C._cuda_getCurrentRawStream(0))
    req = [t.detach().clone().requires_grad_() for t in (x, w, *bn)]

    def device_context():
        with torch.cuda.device(x.device):
            pass

    pieces = {
        "grouped chain (conv, BN, ReLU6)":
            lambda: core.relu6(norm(dw(x))),
        "fused chain (the BN wrapper)":
            lambda: fc.fused_depthwise_bn_relu6(x, w, *bn, eps=1e-3),
        "_launch (checks, plan, empty, launch)":
            lambda: fc._launch(x, w, scale, bias, (1, 1), True, mean, var,
                               1e-3),
        "the ctypes launch alone": lambda: lib.fused_depthwise_forward(*args),
        "torch.empty for y": lambda: torch.empty(y_shape, device="cuda"),
        "the cached plan lookup": lambda: fc._plan(
            x.shape, x.stride(), x.dtype, 3, 3, (1, 1), True, True, 1e-3,
            True),
        "the raw current stream":
            lambda: torch._C._cuda_getCurrentRawStream(0),
        "dropped: fold_bn's five ops": lambda: fc.fold_bn(*bn, 1e-3),
        "dropped: .to(float32) generator":
            lambda: [t.to(torch.float32) for t in (w, scale, bias)],
        "dropped: torch.cuda.device context": device_context,
        "dropped: current_stream().cuda_stream":
            lambda: torch.cuda.current_stream(x.device).cuda_stream,
    }
    with torch.no_grad():
        us = {k: host_us(torch, fn) for k, fn in pieces.items()}
    # Function.apply, taken when an input needs a gradient
    us["with grad: Function.apply + save"] = host_us(
        torch, lambda: fc.fused_depthwise_bn_relu6(*req, eps=1e-3))
    log("host us a call at b32 13x13x144 s1: " + "; ".join(
        f"{k} {v!r}" for k, v in us.items()) + f"; {card}")


def host_ms(torch, fn, n: int = 30, warmup: int = 3) -> float:
    """Host-clock ms per call of `fn` over `n` calls ending in a
    synchronize, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def profiled(torch, fn, n: int = 10,
             kernel: str = "fused_depthwise") -> str:
    """Where one call's time goes, from torch.profiler over `n` calls:
    device-busy ms (the kernels' summed device time) against wall ms, the
    idle share, the device time per launch of the kernel whose name
    holds `kernel`, and the five kernels with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    # device kernels only: a user annotation on the device timeline (the
    # optimizer's "Optimizer.step#RMSprop.step") spans kernels already
    # counted. A kernel's name has an argument list, an annotation's
    # none; kernel names may hold "#" too ("{lambda()#2}").
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and ("#" not in e.key or "(" in e.key)]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    if busy == 0:
        return f"profiler saw no device time ({wall!r} ms wall per call)"
    ours = [e for e in kernels if kernel in e.key]
    launches = sum(e.count for e in ours)
    ours_us = sum(e.self_device_time_total for e in ours)
    per_launch = (f"{ours_us / launches!r} us device time per {kernel} "
                  f"launch over {launches} launches" if launches
                  else f"no {kernel} launches")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return (f"device busy {busy!r} ms of {wall!r} ms wall per call under "
            f"the profiler (idle share {1 - busy / wall!r}); {per_launch}; "
            f"{sum(e.count for e in kernels) / n!r} kernels per call; top: "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total / n!r} us"
                        for e in top))


def kernel_counts(torch, fn, n: int = 5) -> dict:
    """Kernels a call of `fn` by name (the first 90 characters), from
    torch.profiler over `n` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type == DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)
                and ("#" not in e.key or "(" in e.key)):
            out[e.key[:90]] = out.get(e.key[:90], 0.0) + e.count / n
    return out


def step_times(torch, card: str) -> None:
    """Host-clock ms per train step (forward, backward, RMSprop) at batch
    32 on 50x50 patches, phase 1 and phase 2, and per eval forward, of the
    fused and the grouped build, timed in turns (fused, grouped, grouped,
    fused) since host time drifts; then where each build's time goes,
    from the profiler."""
    from idc_models_tpu_torch.models import core, mobilenet, registry
    from idc_models_tpu_torch.train import losses
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import (
        make_eval_step, make_train_step,
    )

    spec = registry.get_model("mobilenet_v2")
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(BATCH, SIZE, SIZE, 3, device="cuda", generator=gen)
    y = (torch.rand(BATCH, device="cuda", generator=gen) > 0.5).int()
    loss = losses.binary_cross_entropy
    calls = {}
    for phase, frozen_below in (("phase-1", mobilenet.FREEZE_ALL),
                                ("phase-2", 100)):
        for impl in ("fused", "grouped"):
            model = core.init_params(spec.build(
                1, bn_frozen_below=frozen_below, depthwise_impl=impl), 0)
            model.cuda()
            mask = (spec.head_only_mask(model) if phase == "phase-1"
                    else spec.fine_tune_mask(model, 100))
            step = make_train_step(TrainState(model, rmsprop(
                model, 1e-4, trainable_mask=mask)), loss)
            calls[(f"{phase} train step", impl)] = (
                lambda step=step: step(x, y))
            if phase == "phase-2":
                ev = make_eval_step(model, loss)
                calls[("eval forward", impl)] = lambda ev=ev: ev(x, y)
    for what in dict.fromkeys(w for w, _ in calls):
        ms = {"fused": [], "grouped": []}
        for impl in ("fused", "grouped", "grouped", "fused"):
            ms[impl].append(host_ms(torch, calls[(what, impl)]))
        log(f"time {what} b{BATCH}: fused {ms['fused']!r} ms, grouped "
            f"{ms['grouped']!r} ms (in turns f, g, g, f); {card}")
        for impl in ("fused", "grouped"):
            log(f"profile {what} b{BATCH} {impl}: "
                f"{profiled(torch, calls[(what, impl)])}; {card}")
    # the account: which kernels an eval forward of each build launches,
    # by name, where the two builds differ
    counts = {impl: kernel_counts(torch, calls[("eval forward", impl)])
              for impl in ("fused", "grouped")}
    diff = {k: (counts["fused"].get(k, 0.0), counts["grouped"].get(k, 0.0))
            for k in set(counts["fused"]) | set(counts["grouped"])
            if counts["fused"].get(k) != counts["grouped"].get(k)}
    log(f"profile eval forward b{BATCH}, kernels a call where the builds "
        f"differ (fused, grouped): " + "; ".join(
            f"{k} {v}" for k, v in sorted(diff.items(), key=lambda i: i[0]))
        + f"; {card}")


def masking_input(torch, gen, size: int):
    """f32 [size]: normal draws, with the clip edges (at, past, far past)
    and exact half-steps (k + 0.5) * 2^-sb at the front and spread
    through, where round-half-to-even decides."""
    x = torch.randn(size, device="cuda", generator=gen) * 40
    k = torch.randint(-2**20, 2**20, (size,), device="cuda", generator=gen)
    half = (k.double() + 0.5).float() * 2.0 ** -SB
    x[::3] = half[::3]
    edges = torch.tensor([CLIP, -CLIP, 64.5, -64.5, 1e9, -1e9, 0.0,
                          0.5 * 2**-SB, -0.5 * 2**-SB, 1.5 * 2**-SB,
                          -2.5 * 2**-SB], device="cuda")
    n = min(size, len(edges))
    x[:n] = edges[:n]
    return x


def masking_parity(torch, smk) -> float:
    """The secure masking kernel against its plain version, bit for bit
    (torch.equal on int32), then the masks of one round's 8 clients
    cancelling in the int32 sum. Returns the largest |kernel - plain|."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, cases = 0, 0
    for size in MASK_SIZES:
        x = masking_input(torch, gen, size)
        for n in (1, 2, 8, 10):
            runs = [smk.pair_seeds_and_signs(base, me, n, device="cuda")
                    for base in (0, 0xFFFFFFFF) for me in {0, n - 1}]
            # raw seeds 0 and 0xFFFFFFFF, both signs and a skipped peer
            raw = torch.tensor([0, 0xFFFFFFFF, 0x9E3779B1, 1][:n] + [7] * (n - 4),
                               dtype=torch.int64, device="cuda")
            signs = torch.tensor(([-1, 1, 0, 1] * 3)[:n], dtype=torch.int32,
                                 device="cuda")
            runs.append((raw, signs))
            for seeds, sg in runs:
                got = smk.fused_masked_quantize(x, seeds, sg, scale_bits=SB,
                                                clip_abs=CLIP)
                torch.cuda.synchronize()
                want = smk.masked_quantize_reference(x, seeds, sg,
                                                     scale_bits=SB,
                                                     clip_abs=CLIP)
                err = int((got.long() - want.long()).abs().max())
                worst = max(worst, err)
                cases += 1
                if not torch.equal(got, want):
                    raise SystemExit(
                        f"secure masking kernel differs from its plain "
                        f"version at size {size}, {n} clients, seeds "
                        f"{seeds.tolist()}: max |err| {err}")
        del x
    log(f"parity: secure masking kernel equals its plain version bit for "
        f"bit in {cases} cases (sizes {MASK_SIZES}, 1/2/8/10 clients, "
        f"seeds from bases 0 and 0xFFFFFFFF and raw seeds 0 and "
        f"0xFFFFFFFF, inputs at +-{CLIP}, past it and at half-steps)")

    n, size = 8, 192_576
    xs = [masking_input(torch, gen, size) for _ in range(n)]
    masked = torch.zeros(size, dtype=torch.int64, device="cuda")
    plain = torch.zeros(size, dtype=torch.int64, device="cuda")
    for i, x in enumerate(xs):
        seeds, sg = smk.pair_seeds_and_signs(0xC0FFEE, i, n, device="cuda")
        masked += smk.fused_masked_quantize(x, seeds, sg, scale_bits=SB,
                                            clip_abs=CLIP)
        plain += smk.quantize_f32(x, SB, CLIP)
    if not torch.equal(smk.wrap_int32(masked), smk.wrap_int32(plain)):
        raise SystemExit("the kernel's masks do not cancel over 8 clients")
    log(f"parity: the int32 sum of 8 clients' kernel outputs equals the "
        f"int32 sum of their quantized values ({size} elements)")
    return float(worst)


def secure_path(torch, fc, smk, card: str) -> dict:
    """Drive `secure-fed --mask-impl pallas` at the preset and hold its
    launches and round records to what the schedule implies."""
    from idc_models_tpu_torch import cli
    from idc_models_tpu_torch.configs import get_preset

    preset = get_preset("secure_fed")
    rounds = 3
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["secure-fed", "--mask-impl", "pallas", "--synthetic-examples",
                "2048", "--rounds", str(rounds), "--seed", "0", "--path", tmp]
        fc.KERNEL.launches = smk.KERNEL.launches = 0
        fc.PATH_LAUNCHES.update(dict.fromkeys(fc.PATHS, 0))
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fused": fc.KERNEL.launches, "masking": smk.KERNEL.launches}
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "run.jsonl").read_text().splitlines()]
    if rc != 0:
        raise SystemExit(f"cli.main returned {rc}")
    rounds_rec = [r for r in records if r["event"] == "round"]
    if len(rounds_rec) != rounds:
        raise SystemExit(f"expected {rounds} round records, got "
                         f"{[r['event'] for r in records]}")
    for r in rounds_rec:
        for k in ("train_loss", "train_accuracy", "test_loss",
                  "test_accuracy", "test_auroc"):
            if not math.isfinite(r[k]):
                raise SystemExit(f"non-finite {k} in {r}")
        if r["clients_recovered"] != 0 or r["clip_saturated"] != 0:
            raise SystemExit(f"round recovered or clipped: {r}")
    expected = rounds * preset.num_clients
    log(f"main path: cli.main({' '.join(argv[:-1])} <tmp>) in {seconds!r} s; "
        f"rounds {[(r['train_loss'], r['test_loss'], r['test_accuracy'], r['test_auroc']) for r in rounds_rec]} "
        f"(train loss, test loss, accuracy, AUROC); masking kernel launches "
        f"{launches['masking']} (expected {rounds} rounds x "
        f"{preset.num_clients} clients = {expected}), fused depthwise "
        f"launches {launches['fused']}; {card}")
    if launches["masking"] != expected or launches["fused"] != 0:
        raise SystemExit(f"kernel launches {launches} != masking {expected}")
    return {"launches": launches["masking"], "seconds": seconds}


def mobilenet_updates(torch, n: int, seed: int):
    """A fresh MobileNetV2's weights and n clients' updates of them (the
    weights plus noise; BN moving variances kept positive), on the CPU."""
    from idc_models_tpu_torch.models import core, registry

    model = core.init_params(registry.get_model("mobilenet_v2").build(1), seed)
    gen = torch.Generator().manual_seed(seed)
    params = {k: v.detach().clone() for k, v in model.named_parameters()}
    state = {k: v.detach().clone() for k, v in model.named_buffers()}

    def noisy(tree, scale):
        out = {}
        for k, v in tree.items():
            d = torch.randn((n,) + v.shape, generator=gen) * scale
            out[k] = v + (d.abs() if k.endswith(".var") else d)
        return out

    return model, params, state, noisy(params, 0.05), noisy(state, 0.5)


def aggregate_three_ways(torch, smk) -> None:
    """One `secure_aggregate` of 8 clients' fixed MobileNetV2 updates: the
    kernel, threefry on the card, the plain version on the CPU; all
    three bit-identical, the protected part dequantize(sum quantize)."""
    from idc_models_tpu_torch.secure import masking
    from idc_models_tpu_torch.secure.fedavg import (
        _STATE_PRESCALE, secure_aggregate,
    )

    n = 8
    model, params, state, cp, cs = mobilenet_updates(torch, n, 5)
    key = masking.key_from_seed(7)
    out = {}
    for name, device, impl in (("kernel", "cuda", "pallas"),
                               ("threefry", "cuda", "threefry"),
                               ("plain", "cpu", "pallas")):
        def on(tree):
            return {k: v.to(device) for k, v in tree.items()}
        before = smk.KERNEL.launches
        p, s, m = secure_aggregate(on(cp), on(cs), on(params), on(state),
                                   percent=0.5, layer_order=model.layer_names,
                                   mask_impl=impl, mask_key=key)
        torch.cuda.synchronize()
        out[name] = {k: v.cpu() for k, v in {**p, **s}.items()}
        out[name + "_launches"] = smk.KERNEL.launches - before
    if (out["kernel_launches"], out["threefry_launches"],
            out["plain_launches"]) != (n, 0, 0):
        raise SystemExit(f"aggregate launches: kernel "
                         f"{out['kernel_launches']}, threefry "
                         f"{out['threefry_launches']}, plain "
                         f"{out['plain_launches']}; expected {n}, 0, 0")
    for k, v in out["plain"].items():
        for other in ("kernel", "threefry"):
            if not torch.equal(out[other][k], v):
                raise SystemExit(f"{other} aggregate differs from the plain "
                                 f"version's at {k}")
    # the protected part is exactly dequantize(sum of quantize)
    pf, sf = masking.first_fraction_selection_weights(
        params, state, 0.5, model.layer_names)
    sb = masking.choose_scale_bits(n, CLIP)
    checked = 0
    for tree, flags, scale in ((cp, pf, 1.0), (cs, sf, _STATE_PRESCALE)):
        for k, f in flags.items():
            if f:
                q = masking.quantize(tree[k] / scale, sb, clip_abs=CLIP)
                want = masking.dequantize(smk.wrap_int32(q.long().sum(0)), sb,
                                          count=n) * scale
                if not torch.equal(out["kernel"][k], want):
                    raise SystemExit(f"protected {k} is not dequantize(sum "
                                     f"quantize)")
                checked += tree[k][0].numel()
    log(f"main path: secure_aggregate of 8 clients' MobileNetV2 updates is "
        f"bit-identical through the kernel ({n} launches), threefry on the "
        f"card and the plain version on the CPU; the {checked} protected "
        f"elements equal dequantize(sum quantize)")


def mobilenet_round(torch, fc, smk, card: str) -> None:
    """One secure round of MobileNetV2 through the kernel: 2 clients x 32
    50x50 patches, 1 local epoch, percent 0.5."""
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.federated.fedavg import initialize_server
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.secure.fedavg import make_secure_fedavg_round
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    model = registry.get_model("mobilenet_v2").build(1)
    imgs, labels = synthetic.make_idc_like(64, SIZE, seed=1)
    rnd = make_secure_fedavg_round(model, 1e-4, binary_cross_entropy,
                                   percent=0.5, local_epochs=1, batch_size=32,
                                   mask_impl="pallas")
    server = initialize_server(model, 0)
    fc.KERNEL.launches = smk.KERNEL.launches = 0
    t0 = time.perf_counter()
    server, m = rnd(server, imgs.reshape(2, 32, SIZE, SIZE, 3),
                    labels.reshape(2, 32), torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    finite = all(bool(torch.isfinite(v).all())
                 for v in {**server.params, **server.state}.values())
    log(f"main path: one MobileNetV2 secure round (2 clients x 32 patches, "
        f"percent 0.5) in {seconds!r} s: {m}; masking kernel launches "
        f"{smk.KERNEL.launches}; all aggregate weights finite {finite}; "
        f"{card}")
    if smk.KERNEL.launches != 2 or not finite or m["clip_saturated"] != 0:
        raise SystemExit("the MobileNetV2 secure round failed its checks")


def masking_bound_ms(size: int, active_peers: int, clock_hz: float):
    """(bound ms, 'bytes' or 'operations', bytes, ops) of one kernel call
    on `size` elements with `active_peers` peers of nonzero sign."""
    nbytes = size * MASK_BYTES_PER_ELEM
    ops = size * (MASK_OPS_BASE + MASK_OPS_PER_PEER * active_peers)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = ops / (INT32_LANES_PER_SM * H100_SMS * clock_hz)
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def masking_times(torch, smk, clock_hz: float, card: str) -> dict:
    """CUDA-event ms per call of the kernel, its plain version and the
    threefry path (quantize + pairwise_mask + add, what the round runs
    for one client under mask_impl="threefry") for client 3 of 8, by
    size; returns {size: row}."""
    from idc_models_tpu_torch.secure import masking

    gen = torch.Generator(device="cuda").manual_seed(4)
    n, me = 8, 3
    seeds, signs = smk.pair_seeds_and_signs(0x5EED, me, n, device="cuda")
    key = masking.key_from_seed(11)
    rows = {}
    for size in MASK_TIME_SIZES:
        x = torch.randn(size, device="cuda", generator=gen)
        big = size >= 14_000_000
        t = time_ms(torch, lambda: smk.fused_masked_quantize(
            x, seeds, signs, scale_bits=SB, clip_abs=CLIP),
            20 if big else 100)
        p = time_ms(torch, lambda: smk.masked_quantize_reference(
            x, seeds, signs, scale_bits=SB, clip_abs=CLIP),
            2 if big else 10, warmup=1)
        f = time_ms(torch, lambda: masking.quantize(x, SB, clip_abs=CLIP)
                    .long() + masking.pairwise_mask(key, me, n, (size,),
                                                    device="cuda"),
                    2 if big else 10, warmup=1)
        bound, by, nbytes, ops = masking_bound_ms(size, n - 1, clock_hz)
        rows[size] = {"ms": t, "plain_ms": p, "threefry_ms": f,
                      "bound_ms": bound, "bound_by": by}
        log(f"time masking {size} elements, 8 clients (7 peers): kernel "
            f"{t!r} ms, plain {p!r} ms, threefry path {f!r} ms, bound "
            f"{bound!r} ms by {by} ({nbytes} B, {ops} int32 ops at "
            f"{clock_hz / 1e9!r} GHz); kernel at {bound / t!r} of the "
            f"bound; {card}")
        del x
        torch.cuda.empty_cache()
    return rows


def secure_round_times(torch, card: str) -> None:
    """Host-clock ms per secure round at the secure_fed preset (small CNN,
    8 clients x 204 patches, 5 local epochs), mask_impl pallas against
    threefry, in turns (p, t, t, p); then where a pallas round's time
    goes, from the profiler."""
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.federated.fedavg import initialize_server
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.secure.fedavg import make_secure_fedavg_round
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    preset = get_preset("secure_fed")
    n = preset.num_clients
    imgs, labels = synthetic.make_idc_like(n * 204, preset.image_size, seed=2)
    imgs = torch.as_tensor(imgs, dtype=torch.float32, device="cuda").reshape(
        n, 204, preset.image_size, preset.image_size, 3)
    labels = torch.as_tensor(labels, device="cuda").reshape(n, 204)
    calls = {}
    for impl in ("pallas", "threefry"):
        model = registry.get_model(preset.model).build(1)
        rnd = make_secure_fedavg_round(
            model, preset.lr, binary_cross_entropy, percent=preset.percent,
            local_epochs=preset.local_epochs, batch_size=preset.batch_size,
            mask_impl=impl)
        state = {"server": initialize_server(model, 0),
                 "gen": torch.Generator().manual_seed(1)}

        def call(rnd=rnd, state=state):
            state["server"], _ = rnd(state["server"], imgs, labels,
                                     state["gen"])
        calls[impl] = call
    ms = {"pallas": [], "threefry": []}
    for impl in ("pallas", "threefry", "threefry", "pallas"):
        ms[impl].append(host_ms(torch, calls[impl], n=3, warmup=1))
    log(f"time secure round (secure_fed preset, {n} clients x 204 patches, "
        f"5 local epochs): pallas {ms['pallas']!r} ms, threefry "
        f"{ms['threefry']!r} ms (in turns p, t, t, p); {card}")
    log(f"profile secure round pallas: "
        f"{profiled(torch, calls['pallas'], n=2, kernel='secure_masked')}; "
        f"{card}")


# ---------------------------------------------------------------------------
# the causal LM's flash kernels (ops/flash_block_kernel.py)
# ---------------------------------------------------------------------------

# the repo's full-width serving LM (bench.py's vocab 1024, embed 512,
# 8 heads of 64, MLP 2048, 2 blocks) and its long-context block
LM = dict(vocab=1024, embed_dim=512, num_heads=8, mlp_dim=2048,
          num_blocks=2)
LM_T, LM_STEPS, SERVE_T_MAX = 16384, 4, 32768
SERVE_REQUESTS = [(16384, 256), (4096, 64), (1000, 64)]   # prompt, decode
# the kernels and their plain versions do the same f32 arithmetic in
# another order (64-key chunks against one whole-block product), so they
# are held normwise: max |kernel - plain| <= FLASH_TOL * (1 + max |plain|)
FLASH_TOL = 5e-5
# bf16 caches of the pallas and plain Generators, near zero (see serving)
CACHE_ATOL = 1e-4
PEAK_BF16_FLOP_PER_S = 989e12
# f32 inputs are bounded at the TF32 tensor-core peak, which the flash
# kernels' 3xTF32 products run on; the f32 FMA peak (PEAK_F32_FLOP_PER_S),
# the bound of the earlier CUDA-core kernels, is printed beside it so
# their shares stay comparable
PEAK_TF32_FLOP_PER_S = 495e12
FLASH_NAMES = {"fwd": "flash_block_update", "dq": "flash_block_dq",
               "dkv": "flash_block_dkv"}
KERNEL_SYMBOLS = {"fwd": "flash_block_fwd_kernel<",
                  "dq": "flash_block_dq_kernel<",
                  "dkv": "flash_block_dkv_kernel<"}
FLASH_REPLACES = {"fwd": "idc_models_tpu/ops/flash_block_kernel.py:87",
                  "dq": "idc_models_tpu/ops/flash_block_kernel.py:182",
                  "dkv": "idc_models_tpu/ops/flash_block_kernel.py:216"}


def flash_err(got, want, elementwise=False) -> float:
    """max |got - want|, raising past the tolerance: normwise,
    max |got - want| / (1 + max |want|) <= FLASH_TOL, or elementwise,
    |got - want| / (1 + |want|) <= FLASH_TOL (for m, whose fully masked
    rows hold the -1e30 sentinel)."""
    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    rel = ((diff / (1.0 + want.float().abs())).max().item() if elementwise
           else err / (1.0 + want.float().abs().max().item()))
    if not rel <= FLASH_TOL:
        raise SystemExit(f"flash kernel differs from its plain version: "
                         f"max |err| {err!r}, relative {rel!r} > {FLASH_TOL}")
    return err


def flash_inputs(torch, gen, b, t_q, t_k, h, d, dtype, fresh=False):
    """q, k, v in `dtype`; a mid-stream f32 carry (or a fresh one);
    dout in `dtype`; an L and D for the backward (L large enough that
    exp(s - L) stays in range, as a real logsumexp keeps it)."""
    def mk(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)
    q, dout = mk(b, t_q, h, d).to(dtype), mk(b, t_q, h, d).to(dtype)
    k, v = mk(b, t_k, h, d).to(dtype), mk(b, t_k, h, d).to(dtype)
    if fresh:
        m = torch.full((b, h, t_q), -1e30, device="cuda")
        l = torch.zeros(b, h, t_q, device="cuda")
        acc = torch.zeros(b, t_q, h, d, device="cuda")
    else:
        m, acc = mk(b, h, t_q), mk(b, t_q, h, d)
        l = torch.rand(b, h, t_q, device="cuda", generator=gen) * 1.5 + 0.5
    lse = mk(b, h, t_q) + 3.0 + math.log(t_k)
    delta = mk(b, h, t_q)
    return q, k, v, m, l, acc, dout, lse, delta


def flash_case(torch, fbk, ins, offs, causal, heads_per_plain=None):
    """One update and one backward through the kernels against the plain
    versions; the plain side may run a few heads at a time (heads are
    independent) to bound its [B, H, Tq, Tk] temporaries. Returns the
    worst |err| of the update and of dq, dk, dv."""
    q, k, v, m, l, acc, dout, lse, delta = ins
    d = q.shape[-1]
    kw = dict(scale=d ** -0.5, causal=causal)
    o = torch.tensor(offs, dtype=torch.int32, device="cuda")
    got = fbk.flash_block_fold(q, k, v, m, l, acc, o, **kw)
    grads = fbk.flash_block_grads(q, k, v, dout, lse, delta, o, **kw)
    torch.cuda.synchronize()
    h = q.shape[2]
    step = heads_per_plain or h
    errs = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for h0 in range(0, h, step):
        sl = slice(h0, h0 + step)
        row = lambda t: t[:, :, sl]      # noqa: E731 -- [B, T, H, D]
        col = lambda t: t[:, sl]         # noqa: E731 -- [B, H, T]
        want = fbk.reference_impl(row(q), row(k), row(v), col(m), col(l),
                                  row(acc), o, **kw)
        for i, (g, w) in enumerate(zip(
                (col(got[0]), col(got[1]), row(got[2])), want)):
            errs["fwd"] = max(errs["fwd"], flash_err(g, w, i == 0))
        del want
        want = fbk.block_grads_reference(row(q), row(k), row(v), row(dout),
                                         col(lse), col(delta), o, **kw)
        errs["dq"] = max(errs["dq"], flash_err(row(grads[0]), want[0]))
        for g, w in zip(grads[1:], want[1:]):
            errs["dkv"] = max(errs["dkv"], flash_err(row(g), w))
        errs["scale"] = max(errs.get("scale", 0.0),
                            *(w.abs().max().item() for w in want))
        del want
        torch.cuda.empty_cache()
    return errs


def flash_parity(torch, fbk) -> dict:
    """The three flash kernels against their plain versions over the
    grid; returns the worst |err| per kernel at the main path's shape
    (f32, causal)."""
    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(10)
    n = n_masked = 0
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for d in (16, 32, 64, 128):
        for dtype in (torch.float32, torch.bfloat16):
            for t_q, t_k in ((256, 256), (256, 512)):
                for causal in (False, True):
                    # mid-stream carries, then a fresh one at [0, 32]
                    for offs, fresh in (([0, 0], False), ([128, 0], False),
                                        ([0, 128], False), ([32, 96], False),
                                        ([0, 32], True)):
                        ins = flash_inputs(torch, gen, 2, t_q, t_k, 2, d,
                                           dtype, fresh=fresh)
                        errs = flash_case(torch, fbk, ins, offs, causal)
                        for key in worst:
                            worst[key] = max(worst[key], errs[key])
                        n += 1
                # a fully masked first block (every key after every
                # query) folded into a fresh carry: compared raw (the
                # update kernel's vote fails, so it computes the plain
                # version's p = 1 garbage), then after a visible block,
                # where the garbage has healed
                q, k, v, m, l, acc, *_ = flash_inputs(
                    torch, gen, 2, 128, 128, 2, d, dtype, fresh=True)
                kw = dict(scale=d ** -0.5, causal=True)
                got, want = (m, l, acc), (m, l, acc)
                for offs in ([0, 128], [128, 0]):
                    o = torch.tensor(offs, dtype=torch.int32, device="cuda")
                    got = fbk.flash_block_fold(q, k, v, *got, o, **kw)
                    want = fbk.reference_impl(q, k, v, *want, o, **kw)
                    for i, (g, w) in enumerate(zip(got, want)):
                        worst["fwd"] = max(worst["fwd"],
                                           flash_err(g, w, i == 0))
                    n += 1
                # a fully masked block in the backward: every key after
                # every query, so the kernels skip every tile and the
                # plain version's p and ds are exactly 0
                q, k, v, _, _, _, dout, lse, delta = flash_inputs(
                    torch, gen, 2, 256, 256, 2, d, dtype)
                o = torch.tensor([0, 256], dtype=torch.int32, device="cuda")
                args = (q, k, v, dout, lse, delta, o)
                grads = fbk.flash_block_grads(*args, **kw)
                want = fbk.block_grads_reference(*args, **kw)
                torch.cuda.synchronize()
                if any(g.any() or w.any() for g, w in zip(grads, want)):
                    raise SystemExit(f"a fully masked block's backward is "
                                     f"not exactly 0 (D {d}, {dtype})")
                n_masked += 1
    log(f"flash parity: {n} cases (D 16/32/64/128 x f32/bf16 x Tq,Tk "
        f"256,256 / 256,512 x causal or not x offsets [0,0] [128,0] "
        f"[0,128] [32,96] (the last cuts a tile's span inside a chunk) "
        f"with a mid-stream carry and [0,32] with a fresh one; plus a fully "
        f"masked first block folded into a fresh carry, compared raw and "
        f"after a visible block) match the plain versions, normwise "
        f"tolerance {FLASH_TOL}, m elementwise; worst |err| update "
        f"{worst['fwd']!r}, dq {worst['dq']!r}, dk/dv {worst['dkv']!r}; "
        f"{n_masked} fully masked backward blocks (offsets [0,256], T 256) "
        f"give exact zeros, as the plain version does")
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        ins = flash_inputs(torch, gen, 1, LM_T, LM_T, 8, 64, dtype,
                           fresh=True)
        errs = flash_case(torch, fbk, ins, [0, 0], True, heads_per_plain=2)
        del ins
        torch.cuda.empty_cache()
        log(f"flash parity at the main path's shape 1x{LM_T}x8x64 "
            f"{str(dtype)[6:]}, causal, fresh carry: max |err| update "
            f"{errs['fwd']!r}, dq {errs['dq']!r}, dk/dv {errs['dkv']!r} "
            f"(normwise tolerance {FLASH_TOL}; largest |plain| gradient "
            f"{errs['scale']!r})")
        if dtype == torch.float32:
            main = errs
    return main


def ring_on_card(torch, tring) -> None:
    """The pallas ring's values and gradients against full attention
    under autograd, f32, T=2048."""
    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn(1, 2048, 8, 64, device="cuda", generator=gen)
               for _ in range(3))
    outs, grads = [], []
    for fn in (tring.make_ring_attention(causal=True, block_impl="pallas"),
               lambda a, b, c: tring.full_attention(a, b, c, causal=True)):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        out.square().sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in ins])
    torch.cuda.synchronize()
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    errs = []
    for a, b, name in zip(grads[0], grads[1], ("dq", "dk", "dv")):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5,
                                   msg=f"pallas ring {name}")
        errs.append((a - b).abs().max().item())
    log(f"ring: make_ring_attention(block_impl='pallas') at 1x2048x8x64 "
        f"f32 matches full attention (values rtol/atol 1e-5, max |err| "
        f"{(outs[0] - outs[1]).abs().max().item()!r}; gradients rtol 2e-4 "
        f"atol 2e-5, max |err| dq/dk/dv {errs!r})")


def backward_memory(torch, tring) -> float:
    """The pallas ring's forward + backward at B=1, T=16384, H=8, D=64
    must raise the peak allocation by under 1 GB -- one [1, 8, T, T] f32
    score tensor would be 8.6 GB. Returns the rise in bytes."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    q, k, v, g = (torch.randn(1, LM_T, 8, 64, device="cuda", generator=gen)
                  for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_()
    ring = tring.make_ring_attention(causal=True, block_impl="pallas")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ring(q, k, v).backward(g)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    scores = 8 * LM_T * LM_T * 4
    log(f"memory: pallas ring forward + backward at 1x{LM_T}x8x64 f32 "
        f"raised the peak allocation by {rise} B ({rise / 1e9!r} GB; one "
        f"[1, 8, {LM_T}, {LM_T}] f32 score tensor is {scores / 1e9!r} GB; "
        f"limit 1 GB)")
    if not rise < 1e9:
        raise SystemExit(f"the pallas backward raised memory by {rise} B")
    return float(rise)


def flash_counts(fbk) -> tuple[int, int, int]:
    return tuple(k.launches for k in fbk.KERNELS)


def zero_counts(fc, smk, fbk) -> None:
    fc.KERNEL.launches = smk.KERNEL.launches = 0
    fc.PATH_LAUNCHES.update(dict.fromkeys(fc.PATHS, 0))
    for k in fbk.KERNELS:
        k.launches = 0


def lm_path(torch, fc, smk, fbk, card: str) -> dict:
    """Drive `cli.main(["lm", ...])` at full width through the pallas
    ring and hold its launches, losses and generate line."""
    import contextlib
    import io

    from idc_models_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["lm", "--vocab", str(LM["vocab"]), "--embed-dim",
                str(LM["embed_dim"]), "--num-heads", str(LM["num_heads"]),
                "--mlp-dim", str(LM["mlp_dim"]), "--num-blocks",
                str(LM["num_blocks"]), "--seq-len", str(LM_T),
                "--batch-size", "1", "--block-impl", "pallas", "--steps",
                str(LM_STEPS), "--generate", "12", "--path", tmp]
        out = io.StringIO()
        zero_counts(fc, smk, fbk)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_counts(fbk)
        others = (fc.KERNEL.launches, smk.KERNEL.launches)
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "run.jsonl").read_text().splitlines()]
    for line in out.getvalue().splitlines():
        log(f"  lm | {line}")
    if rc != 0:
        raise SystemExit(f"cli.main returned {rc}")
    steps = [r for r in records if r["event"] == "step"]
    if not steps or not all(math.isfinite(r["loss"]) for r in steps):
        raise SystemExit(f"lm step records missing or not finite: {steps}")
    if not any(line.startswith("generate: ") for line in
               out.getvalue().splitlines()):
        raise SystemExit("the lm path printed no generate line")
    want = LM_STEPS * LM["num_blocks"]
    log(f"main path: cli.main({' '.join(argv[:-1])} <tmp>) in {seconds!r} "
        f"s; losses {[r['loss'] for r in steps]}; flash launches "
        f"update/dq/dkv {launches} (expected {LM_STEPS} steps x "
        f"{LM['num_blocks']} blocks x a ring of 1 = {want} each); other "
        f"kernels {others}; {card}")
    if launches != (want, want, want) or others != (0, 0):
        raise SystemExit(f"lm launches {launches} / {others}")
    return {"launches": want, "seconds": seconds, "argv": argv[:-2],
            "losses": [r["loss"] for r in steps]}


def cache_diff(torch, a, b) -> tuple[int, int, int, float]:
    """Two bf16 caches: (elements that differ, elements more than one
    bf16 ulp of their own magnitude apart, of those the ones also more
    than CACHE_ATOL of b's scale apart, max |a - b|)."""
    af, bf = a.float(), b.float()
    diff = (af - bf).abs()
    _, exp = torch.frexp(torch.maximum(af.abs(), bf.abs()))
    beyond = diff > torch.ldexp(torch.ones_like(diff), exp - 8)
    far = beyond & (diff > CACHE_ATOL * bf.abs().max())
    return (int((diff > 0).sum()), int(beyond.sum()), int(far.sum()),
            diff.max().item())


def serving(torch, fc, smk, fbk, card: str) -> dict:
    """A bf16-cache pallas Generator at the repo's serving width, t_max
    32768, answering three requests; prefill logits and caches held
    against the plain (jnp) Generator on the card."""
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.lm import (
        AttentionLM, Generator, prefill_bucket,
    )

    tf32_off(torch)
    model = core.init_params(AttentionLM(
        LM["vocab"], SERVE_T_MAX, embed_dim=LM["embed_dim"],
        num_heads=LM["num_heads"], mlp_dim=LM["mlp_dim"],
        num_blocks=LM["num_blocks"]), 0)
    kw = dict(embed_dim=LM["embed_dim"], num_heads=LM["num_heads"],
              num_blocks=LM["num_blocks"], t_max=SERVE_T_MAX,
              cache_dtype=torch.bfloat16, device="cuda")
    gen = Generator(model, block_impl="pallas", **kw)
    plain = Generator(model, block_impl="jnp", **kw)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, LM["vocab"], (1, p)) for p, _ in SERVE_REQUESTS]
    rows = []
    zero_counts(fc, smk, fbk)
    for prompt, (p_len, n_dec) in zip(prompts, SERVE_REQUESTS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = gen.prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        before = flash_counts(fbk)
        want_logits, want_caches = plain.prefill(prompt)
        torch.cuda.synchronize()
        if flash_counts(fbk) != before:
            raise SystemExit("the plain Generator launched a flash kernel")
        err = (logits - want_logits).abs().max().item()
        scale = 1.0 + want_logits.abs().max().item()
        if not err <= 1e-4 * scale:
            raise SystemExit(f"pallas prefill logits differ from plain by "
                             f"{err} at {p_len} tokens")
        # block 0's K/V come before any attention: equal bit for bit.
        # Later blocks' K/V are bf16 casts of f32 values that differ by
        # the attention's rounding (about 1e-6 of the scale), so each
        # element is held to one bf16 ulp of its own magnitude, or to
        # CACHE_ATOL of the cache's scale where it lies near zero
        diffs = []
        for i, (pair, want) in enumerate(zip(caches, want_caches)):
            for a, b in zip(pair, want):
                n_diff, n_ulp, n_far, worst = cache_diff(torch, a, b)
                if (i == 0 and n_diff) or n_far:
                    raise SystemExit(
                        f"pallas prefill cache of block {i} differs from "
                        f"plain at {p_len} tokens: {n_diff} elements "
                        f"differ, {n_ulp} by more than one bf16 ulp, "
                        f"{n_far} of them by more than {CACHE_ATOL} of the "
                        f"scale; max |diff| {worst!r}")
                diffs.append((n_diff, n_ulp, worst))
        del want_logits, want_caches
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        toks, _, _ = gen.decode(caches, logits, p_len, n_dec)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        if toks.shape != (1, n_dec) or not (
                (toks >= 0) & (toks < LM["vocab"])).all():
            raise SystemExit(f"decode gave {toks.shape} tokens out of range")
        rows.append((p_len, n_dec, prefill_ms, decode_ms, err))
        log(f"serving: prompt {p_len} (bucket "
            f"{prefill_bucket(p_len, SERVE_T_MAX, 1)}) -> "
            f"prefill {prefill_ms!r} ms (host clock, ends in a "
            f"synchronize), decode {n_dec} tokens at {decode_ms!r} ms a "
            f"token; prefill logits vs plain max |err| {err!r} (tolerance "
            f"1e-4 x (1 + max |logit|)); bf16 caches (k, v per block): "
            f"(elements differing, beyond one ulp of their magnitude, max "
            f"|diff|) {diffs}, none beyond both one ulp and {CACHE_ATOL} "
            f"of the cache's scale, of "
            f"{caches[0][0].numel()} each; {card}")
    launches = flash_counts(fbk)
    log(f"serving: flash launches update/dq/dkv {launches} over the three "
        f"requests (expected 6, 0, 0: one per block per prefill)")
    if launches != (6, 0, 0) or fc.KERNEL.launches or smk.KERNEL.launches:
        raise SystemExit(f"serving launches {launches}")
    return {"rows": rows}


# ---------------------------------------------------------------------------
# phase 12: continuous-batching serving (serve/)
# ---------------------------------------------------------------------------

# the serving width of phase (f) (LM, t_max SERVE_T_MAX), seed-0 weights;
# 8 slots, windows of 16; a burst of 24 Poisson arrivals, prompts of 128
# to 16,384 tokens (every pallas bucket is at least 128), budgets 16-128
SERVE_SLOTS, SERVE_WINDOW = 8, 16
SERVE_TRACE = dict(rate_per_s=50.0, vocab=LM["vocab"], t_max=SERVE_T_MAX,
                   prompt_lens=(128, 16384), budgets=(16, 128), seed=0)
SERVE_N = 24
# the engine-against-serial contract on the card: the engine's products
# are [8, E] @ W where the serial ones are [1, E] @ W (cuBLAS rounds them
# differently), so tokens are held equal up to the first step where the
# serial run's top-2 margin falls below SERVE_TOL of its largest |logit|.
# The logits are f32 over bf16 or int8 caches; an appended element that
# the other rounding flips by one level moves a logit by far less than
# this (one of thousands of attended positions)
SERVE_TOL = 1e-4
SERVE_CHUNK, SERVE_CHUNK_PREFILLS = 512, 32  # (k3): 32 chunks a cycle
SERVE_TEMPERATURE, SERVE_TOP_K = 0.8, 50
SERVE_CLI_T_MAX = 1024                        # (k5): budgets up to 256


def serve_model(torch):
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.lm import AttentionLM

    return core.init_params(AttentionLM(
        LM["vocab"], SERVE_T_MAX, embed_dim=LM["embed_dim"],
        num_heads=LM["num_heads"], mlp_dim=LM["mlp_dim"],
        num_blocks=LM["num_blocks"]), 0)


def serve_kw(**kw) -> dict:
    return dict(embed_dim=LM["embed_dim"], num_heads=LM["num_heads"],
                num_blocks=LM["num_blocks"], t_max=SERVE_T_MAX,
                device="cuda", **kw)


def serial_steps(gen, prompt, n: int, rng=None):
    """A request alone through the serial Generator: its tokens, the
    logits each step's pick read, and the generator's state before each
    draw."""
    logits, caches = gen.prefill([list(prompt)])
    toks, seen, states = [], [], []
    for i in range(n):
        seen.append(logits[0].clone())
        states.append(None if rng is None else rng.get_state())
        tok, logits, caches = gen.decode(caches, logits, len(prompt) + i, 1,
                                         rng=rng)
        toks.append(int(tok[0, 0]))
    return toks, seen, states


def engine_steps(eng, prompt, n: int):
    """A request alone through a one-slot engine, a step a window: its
    tokens and the logits each step's pick read."""
    eng.admit(0, list(prompt), n)
    toks, seen = [], []
    while not eng.finished(0):
        seen.append(eng._logits[0].clone())
        toks += eng.step_window(1)[0]
    eng.release(0)
    return toks, seen, [None] * n


def held_steps(torch, got, want, seen, states, pick=None):
    """The contract for one request: the number of steps its tokens were
    held equal, and whether a near tie released it. Greedy: released at
    the first step whose serial top-2 margin is below SERVE_TOL of the
    largest |logit|, and any earlier difference fails. Sampled (`pick`):
    released at the first differing step if the serial draw, from the
    same generator state, gives the engine's token once the two tokens'
    logits are moved SERVE_TOL of the scale toward it; else it fails."""
    if len(got) != len(want):
        raise SystemExit(f"serve: {len(got)} tokens, the serial run "
                         f"{len(want)}")
    for j, (g, w) in enumerate(zip(got, want)):
        lw = seen[j]
        eps = SERVE_TOL * float(lw.abs().max())
        if pick is None:
            top2 = lw.topk(2).values
            if float(top2[0] - top2[1]) < eps:
                return j, True
        if g == w:
            continue
        if pick is not None:
            nudged = lw.clone()
            nudged[g] += eps
            nudged[w] -= eps
            rng = torch.Generator(device="cuda")
            rng.set_state(states[j])
            if int(pick(nudged[None], rng)[0]) == g:
                return j, True
        raise SystemExit(f"serve: the engine's token {g} at step {j} is "
                         f"not the serial {w}, and no near tie explains it")
    return len(want), False


def serve_once(torch, fc, smk, fbk, model, trace, **kw) -> tuple:
    """LMServer over `trace` as a burst, every launch count set to 0 just
    before and read just after: (server, results, flash launches,
    seconds)."""
    from idc_models_tpu_torch.observe import MetricsRegistry
    from idc_models_tpu_torch.serve import LMServer

    server = LMServer(model, n_slots=SERVE_SLOTS, window=SERVE_WINDOW,
                      registry=MetricsRegistry(), **serve_kw(**kw))
    torch.cuda.synchronize()
    zero_counts(fc, smk, fbk)
    t0 = time.perf_counter()
    results = server.run(trace)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_counts(fbk)
    if fc.KERNEL.launches or smk.KERNEL.launches:
        raise SystemExit("the serve path launched a classifier kernel")
    bad = [r for r in results if r.status != "ok"]
    if len(results) != len(trace) or bad:
        raise SystemExit(f"serve: {len(results)} results of {len(trace)}, "
                         f"not ok: {bad[:3]}")
    return server, results, launches, seconds


def serve_case(torch, fc, smk, fbk, model, name, trace, want_launches,
               reference, card, pick=None, **kw) -> tuple:
    """One of (k1)-(k4): the server's run, its launches, and every
    request's tokens against `reference(request)` under the contract."""
    server, results, launches, seconds = serve_once(
        torch, fc, smk, fbk, model, trace, **kw)
    if launches != want_launches:
        raise SystemExit(f"serve {name}: flash launches update/dq/dkv "
                         f"{launches}, expected {want_launches}")
    held = total = released = 0
    for _, req in trace:
        want, seen, states = reference(req)
        n, near = held_steps(torch, server.poll(req.id).tokens, want, seen,
                             states, pick)
        held, total, released = held + n, total + len(want), released + near
    summary = server.summary()
    log(f"serve {name}: {len(results)} requests ok in {seconds!r} s; "
        f"flash launches update/dq/dkv {launches} (expected "
        f"{want_launches}); tokens held equal to the serial reference for "
        f"{held} of {total} steps, {released} request(s) released at a near "
        f"tie (tolerance {SERVE_TOL} of max |logit|); "
        f"{summary['serve_tokens']} tokens, "
        f"{summary['serve_decode_dispatches']} windows; {card}")
    return server, summary, launches


def serve_times(torch, fbk, server, gen, card: str) -> None:
    """Serving times at the (k1) configuration: TTFT (queue wait +
    prefill) from the run's summary; at 8 live slots, the window's host
    ms a step, decode tokens/s, device busy, idle share, kernels a step
    and peak memory; warm pallas prefill ms at the 4,096 and 16,384
    buckets (median of 7 calls after a warm-up)."""
    s = server.summary()
    log(f"serve times (k1, a burst of {SERVE_N}): TTFT p50 "
        f"{s['serve_ttft_ms_p50']!r} / p95 {s['serve_ttft_ms_p95']!r} ms = "
        f"queue wait p50 {s['serve_queue_wait_ms_p50']!r} / p95 "
        f"{s['serve_queue_wait_ms_p95']!r} + prefill p50 "
        f"{s['serve_prefill_ms_p50']!r} / p95 {s['serve_prefill_ms_p95']!r} "
        f"ms; {s['serve_tokens_per_sec']!r} tokens/s over the run; "
        f"inter-token p50 {s['serve_token_ms_p50']!r} ms; {card}")
    eng = server.engine
    rng = np.random.default_rng(1)
    for slot in range(SERVE_SLOTS):
        eng.admit(slot, rng.integers(0, LM["vocab"], 1024), 512)
    eng.step_window(SERVE_WINDOW)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        if len(sum(eng.step_window(SERVE_WINDOW).values(), [])) != \
                SERVE_SLOTS * SERVE_WINDOW:
            raise SystemExit("serve: a steady window emitted short")
    window_s = (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated() / 2**20
    prof = profiled(torch, lambda: eng.step_window(SERVE_WINDOW), n=1,
                    kernel="elementwise")
    log(f"serve steady state (8 live slots, t_max {SERVE_T_MAX}, bf16 "
        f"caches, windows of {SERVE_WINDOW}): {window_s * 1e3!r} ms a "
        f"window, {window_s * 1e3 / SERVE_WINDOW!r} ms a step, "
        f"{SERVE_SLOTS * SERVE_WINDOW / window_s!r} decode tokens/s; peak "
        f"memory {peak!r} MiB; one window (16 steps): {prof}; {card}")
    for slot in range(SERVE_SLOTS):
        eng.release(slot)
    for p_len in (4096, 16384):
        prompt = rng.integers(0, LM["vocab"], (1, p_len))
        gen.prefill(prompt)
        ms = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            gen.prefill(prompt)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        log(f"serve prefill warm (pallas, bf16 cache) at bucket {p_len}: "
            f"median {float(np.median(ms))!r} ms of {sorted(ms)} (host "
            f"clock, each ending in a synchronize); {card}")


def serve_cli(torch, fc, smk, fbk, card: str) -> tuple:
    """(k5) `cli.main(["serve", ...])` at the serving width, 16 requests,
    --metrics-port 0, --realtime: one scrape of /metrics and one of
    /healthz while it serves; no kernel launches."""
    import contextlib
    import io
    import re
    import threading
    import urllib.request

    from idc_models_tpu_torch import cli

    argv = ["serve", "--vocab", str(LM["vocab"]), "--embed-dim",
            str(LM["embed_dim"]), "--num-heads", str(LM["num_heads"]),
            "--mlp-dim", str(LM["mlp_dim"]), "--num-blocks",
            str(LM["num_blocks"]), "--t-max", str(SERVE_CLI_T_MAX),
            "--slots", str(SERVE_SLOTS), "--window", str(SERVE_WINDOW),
            "--requests", "16", "--realtime", "--metrics-port", "0"]
    out, rc = io.StringIO(), []

    def run():
        with contextlib.redirect_stdout(out):
            rc.append(cli.main(argv))

    zero_counts(fc, smk, fbk)
    t0 = time.perf_counter()
    worker = threading.Thread(target=run)
    worker.start()
    scraped, deadline = {}, time.monotonic() + 300
    while worker.is_alive() and time.monotonic() < deadline:
        m = re.search(r"metrics: (http://\S+)/metrics", out.getvalue())
        if m and "serving " in out.getvalue():
            # /healthz until the scheduler has ticked, then /metrics
            with urllib.request.urlopen(m.group(1) + "/healthz",
                                        timeout=30) as r:
                scraped["/healthz"] = (r.status, r.read())
            if json.loads(scraped["/healthz"][1])["last_tick_age_s"] is None:
                time.sleep(0.01)
                continue
            with urllib.request.urlopen(m.group(1) + "/metrics",
                                        timeout=30) as r:
                scraped["/metrics"] = (r.status, r.read())
            break
        time.sleep(0.01)
    worker.join(timeout=600)
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = flash_counts(fbk) + (fc.KERNEL.launches, smk.KERNEL.launches)
    lines = out.getvalue().splitlines()
    for line in lines:
        if not line.startswith("serve summary:"):
            log(f"  serve | {line}")
    if worker.is_alive() or rc != [0]:
        raise SystemExit(f"serve verb: rc {rc}, still running "
                         f"{worker.is_alive()}")
    if not any(line.startswith("served: ok=16 ") for line in lines):
        raise SystemExit("serve verb: not every request was ok")
    health = json.loads(scraped.get("/healthz", (0, b"{}"))[1] or b"{}")
    if (scraped.get("/metrics", (0,))[0] != 200
            or b"serve_requests_submitted_total" not in
            scraped["/metrics"][1] or health.get("status") != "ok"):
        raise SystemExit(f"serve verb: scrapes {scraped}")
    if any(launches):
        raise SystemExit(f"serve verb launched kernels {launches}")
    log(f"serve (k5): cli.main({' '.join(argv)}) in {seconds!r} s; /metrics "
        f"{len(scraped['/metrics'][1])} bytes, /healthz {health}; no kernel "
        f"launched; {card}")
    return (0, 0, 0)


def serve_path(torch, fc, smk, fbk, card: str) -> dict:
    """Phase 12: (k1) LMServer(block_impl="pallas", bf16 caches, 8 slots,
    windows of 16) replaying the 24-request trace as a burst, greedy, B3
    launched once a block a prefill (48) and no backward kernel; (k2) the
    same with int8 caches against a one-slot int8 engine; (k3) chunked
    prefill of 512 (32 chunks a cycle), no flash launch, against
    Generator(prefill_chunk=512); (k4) sampled (temperature 0.8, top-k
    50, seeded requests) against the serial sampled Generator; every
    request ok and held to the engine-against-serial contract; then the
    times; (k5) the `serve` verb. Returns B3's serve launches by run."""
    from idc_models_tpu_torch.models.lm import Generator, _make_pick
    from idc_models_tpu_torch.serve import SlotEngine, poisson_trace

    t_start = time.perf_counter()
    tf32_off(torch)
    model = serve_model(torch)
    trace = poisson_trace(SERVE_N, **SERVE_TRACE)
    bf16 = dict(block_impl="pallas", cache_dtype=torch.bfloat16)
    gen = Generator(model, **serve_kw(**bf16))

    def serial(g):
        return lambda req: serial_steps(g, req.prompt, req.max_new_tokens)

    out = {}
    k1, _, out["k1"] = serve_case(torch, fc, smk, fbk, model, "(k1)", trace,
                                  (2 * SERVE_N, 0, 0), serial(gen), card,
                                  **bf16)
    one = SlotEngine(model, n_slots=1, kv_dtype="int8", **serve_kw(**bf16))
    _, _, out["k2"] = serve_case(
        torch, fc, smk, fbk, model, "(k2) int8", trace, (2 * SERVE_N, 0, 0),
        lambda req: engine_steps(one, req.prompt, req.max_new_tokens), card,
        kv_dtype="int8", **bf16)
    del one
    chunked = Generator(model, prefill_chunk=SERVE_CHUNK, **serve_kw(**bf16))
    _, _, out["k3"] = serve_case(
        torch, fc, smk, fbk, model, f"(k3) chunk {SERVE_CHUNK}", trace,
        (0, 0, 0), serial(chunked), card, prefill_chunk=SERVE_CHUNK,
        max_prefills_per_cycle=SERVE_CHUNK_PREFILLS, **bf16)
    del chunked
    sampled = dict(temperature=SERVE_TEMPERATURE, top_k=SERVE_TOP_K)
    sgen = Generator(model, **serve_kw(**bf16, **sampled))
    strace = poisson_trace(SERVE_N, sampled=True, **SERVE_TRACE)
    _, _, out["k4"] = serve_case(
        torch, fc, smk, fbk, model, "(k4) sampled", strace,
        (2 * SERVE_N, 0, 0),
        lambda req: serial_steps(sgen, req.prompt, req.max_new_tokens,
                                 torch.Generator(device="cuda").manual_seed(
                                     req.seed)),
        card, pick=_make_pick(sgen._cfg), **bf16, **sampled)
    del sgen
    torch.cuda.empty_cache()
    serve_times(torch, fbk, k1, gen, card)
    del k1, gen
    torch.cuda.empty_cache()
    out["k5"] = serve_cli(torch, fc, smk, fbk, card)
    log(f"phase 12 (serve) took {time.perf_counter() - t_start!r} s")
    return out


def flash_bytes_flops(t: int, d: int, h: int, itemsize: int,
                      causal: bool = True):
    """Bytes each kernel must move (inputs read once, outputs written
    once) and the flops it needs, counting only the visible (query, key)
    pairs, for B=1, Tq=Tk=t: causal at offsets [0, 0], or every pair."""
    pairs = h * t * (t + 1) // 2 if causal else h * t * t
    qkv = t * h * d * itemsize
    f32_rows, f32_vec = t * h * d * 4, h * t * 4
    return {
        # q, k, v; m, l, acc in and m, l, acc out
        "fwd": (3 * qkv + 2 * (2 * f32_vec + f32_rows), 4 * d * pairs),
        # q, k, v, dout; L, D; dq out -- s, dout.v, ds.k
        "dq": (4 * qkv + 2 * f32_vec + f32_rows, 6 * d * pairs),
        # q, k, v, dout; L, D; dk, dv out -- s, dout.v, p.dout, ds.q
        "dkv": (4 * qkv + 2 * f32_vec + 2 * f32_rows, 8 * d * pairs),
    }


def device_ms(torch, fn, n: int) -> float:
    """Device ms per call of `fn`: CUDA events around `n` back-to-back
    calls queued behind a sleep kernel, so the card never waits on the
    host between them (a standalone kernel's device time, where the
    profiler drops its records)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)     # ~50 ms of SM clock cycles
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def profile_kernels(torch, fn, names, n: int = 2) -> dict:
    """Device us per launch of each kernel whose name holds one of
    `names`, from torch.profiler over `n` calls of `fn`; NaN for a
    kernel the profiler did not see."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    seen = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    out = {}
    for name in names:
        evs = [e for e in seen if name in e.key]
        count = sum(e.count for e in evs)
        out[name] = (sum(e.self_device_time_total for e in evs) / count
                     if count else float("nan"))
    return out


def log_flash_tiles(fbk, t: int) -> None:
    """The (tile, chunk) steps each flash kernel computes at B=1, H=8,
    D=64, T=t, causal, offsets [0, 0], from a fresh carry
    (`update_chunk_span` and `causal_chunk_span` at the kernels' own tile
    sizes), beside the visible pairs and the steps without skipping."""
    visible = 8 * t * (t + 1) // 2
    tiles = {"fwd": fbk.forward_tiles(64), **fbk.backward_tiles(64)}
    for key, (rows, cols) in tiles.items():
        if key == "fwd":
            per_head = sum(fbk.update_chunk_span(t, t, rows, cols, 0, 0)[1])
        else:
            n_chunks, first_tile = fbk.causal_chunk_span(t, t, rows, cols,
                                                         0, 0)
            per_head = (sum(n_chunks) if key == "dq"
                        else sum(t // rows - f for f in first_tile))
        steps = 8 * per_head
        log(f"tiles flash {FLASH_NAMES[key]} T={t}: {steps} steps of "
            f"{rows} queries x {cols} keys computed over 8 heads "
            f"({steps * rows * cols} pairs) for {visible} visible pairs "
            f"(x{steps * rows * cols / visible!r}); without skipping "
            f"{8 * (t // rows) * (t // cols)} steps")


def flash_times(torch, fbk, card: str) -> dict:
    """CUDA-event ms of each flash kernel through its wrapper and on the
    device (`device_ms`), its plain version, and SDPA (forward from
    a fresh carry for the update; backward for dq and dk/dv, which it
    computes together) at B=1, H=8, D=64, causal, T=4096 and 16384, f32
    and bf16, beside the bound. Returns the rows of T=16384 f32, the
    main path's."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = {}
    for t in (4096, LM_T):
        log_flash_tiles(fbk, t)
        for dtype in (torch.float32, torch.bfloat16):
            torch.cuda.empty_cache()
            q, k, v, m, l, acc, dout, lse, delta = flash_inputs(
                torch, gen, 1, t, t, 8, 64, dtype, fresh=True)
            o = torch.tensor([0, 0], dtype=torch.int32, device="cuda")
            kw = dict(scale=0.125, causal=True)
            grads_in = (q, k, v, dout, lse, delta, o)
            big = t == LM_T
            iters = 5 if big else 20
            kernels = {
                "fwd": lambda: fbk.flash_block_fold(q, k, v, m, l, acc, o,
                                                    **kw),
                "dq": lambda: fbk.flash_block_dq(*grads_in, **kw),
                "dkv": lambda: fbk.flash_block_dkv(*grads_in, **kw),
            }
            ms = {key: time_ms(torch, fn, iters)
                  for key, fn in kernels.items()}
            dev = {key: device_ms(torch, fn, iters)
                   for key, fn in kernels.items()}
            torch.cuda.empty_cache()
            plain = {"fwd": time_ms(torch, lambda: fbk.reference_impl(
                q, k, v, m, l, acc, o, **kw), 2 if big else 5, warmup=1)}
            torch.cuda.empty_cache()
            plain["dq"] = plain["dkv"] = time_ms(
                torch, lambda: fbk.block_grads_reference(*grads_in, **kw),
                2 if big else 5, warmup=1)
            torch.cuda.empty_cache()
            qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                          for x in (q, k, v))
            lib = {"fwd": time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True), iters)}
            out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            g = dout.transpose(1, 2)
            lib["dq"] = lib["dkv"] = time_ms(torch, lambda: torch.autograd.grad(
                out, (qs, ks, vs), g, retain_graph=True), iters)
            del out, qs, ks, vs, g
            f32 = dtype == torch.float32
            itemsize = 4 if f32 else 2
            peak = PEAK_TF32_FLOP_PER_S if f32 else PEAK_BF16_FLOP_PER_S
            work = flash_bytes_flops(t, 64, 8, itemsize)
            for key in ("fwd", "dq", "dkv"):
                nbytes, flops = work[key]
                t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
                t_ops = flops / peak * 1e3
                bound = max(t_bytes, t_ops)
                row = {"ms": ms[key], "device_ms": dev[key],
                       "plain_ms": plain[key], "library_ms": lib[key],
                       "bound_ms": bound,
                       "bound_by": "bytes" if t_bytes >= t_ops
                       else "operations"}
                rows[(t, str(dtype)[6:], key)] = row
                what = ("SDPA forward" if key == "fwd"
                        else "SDPA backward (dq, dk, dv together)")
                fma_ms = flops / PEAK_F32_FLOP_PER_S * 1e3
                fma = (f"; at the f32 FMA peak (67 TFLOP/s, the earlier bound) "
                       f"{fma_ms!r} ms, kernel at {fma_ms / ms[key]!r} of "
                       f"it" if f32 else "")
                log(f"time flash {FLASH_NAMES[key]} T={t} {str(dtype)[6:]} "
                    f"causal: kernel {ms[key]!r} ms through the wrapper, "
                    f"{dev[key]!r} ms on the device (events behind a sleep "
                    f"kernel), plain {plain[key]!r} ms"
                    + ("" if key == "fwd" else " (dq, dk, dv together)")
                    + f", {what} {lib[key]!r} ms, bound {bound!r} ms by "
                    f"{row['bound_by']} ({nbytes} B at 3.35 TB/s: "
                    f"{t_bytes!r} ms; {flops} flops of the visible pairs "
                    f"at {peak / 1e12!r} TFLOP/s: {t_ops!r} ms); kernel at "
                    f"{bound / ms[key]!r} of the bound{fma}; {card}")
            bwd_flops = 10 * 64 * 8 * t * (t + 1) // 2
            bwd_bound = bwd_flops / peak * 1e3
            fma = (f", at the f32 FMA peak "
                   f"{bwd_flops / PEAK_F32_FLOP_PER_S * 1e3!r} ms" if f32
                   else "")
            log(f"time flash backward T={t} {str(dtype)[6:]}: dq + dk/dv "
                f"kernels {ms['dq'] + ms['dkv']!r} ms, SDPA backward "
                f"{lib['dq']!r} ms, bound of the backward's 10*D flops a "
                f"visible pair at {peak / 1e12!r} TFLOP/s {bwd_bound!r} ms"
                f"{fma}; {card}")
            del q, k, v, m, l, acc, dout, lse, delta
    return {key: rows[(LM_T, "float32", key)] for key in FLASH_NAMES}


def lm_step_times(torch, card: str) -> None:
    """Host-clock ms per `lm` train step (forward, backward, RMSprop) at
    the main path's width, T=16384, batch 1, pallas against jnp, in
    turns (p, j, j, p); then where each step's time goes, from the
    profiler."""
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.lm import AttentionLM, next_token_loss
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(1)
    seqs = torch.as_tensor((rng.integers(0, LM["vocab"], (1, 1))
                            + np.arange(LM_T)) % LM["vocab"]).cuda()
    calls = {}
    for impl in ("pallas", "jnp"):
        model = core.init_params(AttentionLM(
            LM["vocab"], LM_T, block_impl=impl, **{
                k: LM[k] for k in ("embed_dim", "num_heads", "mlp_dim",
                                   "num_blocks")}), 0).cuda()
        step = make_train_step(TrainState(model, rmsprop(model, 3e-3)),
                               next_token_loss)
        calls[impl] = lambda step=step: step(seqs, seqs)
    ms = {"pallas": [], "jnp": []}
    # cudaMalloc calls and allocator retries (a failed cudaMalloc that
    # frees the cache and tries again) while timed
    allocs = {"pallas": [0, 0], "jnp": [0, 0]}
    stats = ("num_device_alloc", "num_alloc_retries")
    for impl in ("pallas", "jnp", "jnp", "pallas"):
        torch.cuda.empty_cache()
        before = [torch.cuda.memory_stats().get(k, 0) for k in stats]
        ms[impl].append(host_ms(torch, calls[impl], n=3, warmup=1))
        for i, k in enumerate(stats):
            allocs[impl][i] += torch.cuda.memory_stats().get(k, 0) - before[i]
    peak = {}
    for impl in ("pallas", "jnp"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        calls[impl]()
        torch.cuda.synchronize()
        peak[impl] = torch.cuda.max_memory_allocated()
    log(f"time lm train step (vocab 1024, embed 512, 8 heads, MLP 2048, 2 "
        f"blocks, T={LM_T}, batch 1, f32): pallas {ms['pallas']!r} ms, jnp "
        f"{ms['jnp']!r} ms (in turns p, j, j, p); peak allocation pallas "
        f"{peak['pallas']} B, jnp {peak['jnp']} B; (cudaMalloc calls, "
        f"allocator retries) over each one's 8 steps (warm-ups included): "
        f"pallas {allocs['pallas']}, jnp {allocs['jnp']}; {card}")
    for impl in ("pallas", "jnp"):
        torch.cuda.empty_cache()
        log(f"profile lm train step {impl}: "
            f"{profiled(torch, calls[impl], n=2, kernel='flash_block')}; "
            f"{card}")
    torch.cuda.empty_cache()
    us = profile_kernels(torch, calls["pallas"], KERNEL_SYMBOLS.values())
    log(f"profile lm train step pallas: device us per launch (profiler) "
        + ", ".join(f"{FLASH_NAMES[key]} {us[sym]!r}"
                    for key, sym in KERNEL_SYMBOLS.items())
        + f"; {card}")


# ---------------------------------------------------------------------------
# phase 10: the attention classifier and the zigzag ring (`attention`)
# ---------------------------------------------------------------------------

# the JAX bench's model step (bench.py:557-590): attention_classifier at
# T=16,384, 8 features, embed 512, 8 heads of 64, MLP 2048, 2 blocks,
# batch 1, pallas blocks, a ring of one
ATT = dict(seq_len=16384, features=8, embed_dim=512, num_heads=8,
           mlp_dim=2048, num_blocks=2)
# cut: 3 steps on 8 synthetic sequences; validation is max(8 // 4, 1) = 2
# sequences, one eval forward each at batch 1
ATT_STEPS, ATT_EXAMPLES, ATT_VAL = 3, 8, 2
ATT_RUNS = {"contiguous": [], "zigzag": ["--layout", "zigzag"],
            "zigzag_remat": ["--layout", "zigzag", "--remat"]}
# launches of (update, dq, dk/dv) per block: a train step (forward and
# backward; remat runs the forward again in the backward), and the
# update kernel per eval forward
ATT_PER_STEP = {"contiguous": (1, 1, 1), "zigzag": (3, 3, 3),
                "zigzag_remat": (6, 3, 3)}
ATT_PER_EVAL = {"contiguous": 1, "zigzag": 3, "zigzag_remat": 3}
# the step losses against the contiguous run's, relative: step 0 is one
# forward from the same weights, whose folds differ in order only
# (quarters against whole blocks: f32 rounding, FLASH_TOL's scale); the
# later steps follow RMSprop updates, whose first step has slope lr/1e-7
# at a zero gradient (eps 1e-7), so the rounding of near-zero
# gradients can move single weights by up to lr: 1e-3. The remat run
# recomputes the zigzag run's forward through the same kernels on the
# same inputs: 1e-6 (bit for bit expected; the line says which)
ATT_LOSS_RTOL_FIRST, ATT_LOSS_RTOL, ATT_REMAT_RTOL = 1e-5, 1e-3, 1e-6
# bf16 rings against their plain versions, ||got - want|| / ||want||
# per tensor: both sides sum in f32 in other orders and round to bf16,
# and the pallas backward's D = rowsum(dout * out) reads the rounded
# output, which moves small dq and dk elements by up to a tenth of their
# mean |value| (an elementwise bar would have to allow that); the
# readings were at most 2.9e-3 (PERF.md), the bar is 2^-7. A tenth off
# on the late half of the rows alone would read about 3e-2
BF16_REL = 2.0 ** -7
# the bench-width gradients of the zigzag and remat layouts against the
# contiguous one, per tensor ||a - b|| / ||b||: f32 (TF32 off) folds in
# other orders only
ATT_GRAD_REL = 1e-4
ZZ_RING = 4        # the rank count whose quarter schedule the grid covers
EMU_RING, EMU_T = 8, 16384   # the emulated per-rank ring schedule
# the attention path's quarter folds (ring of one) in the kernels line
QUARTERS = ("diagonal", "diagonal_high", "unmasked")


def ring_err(got, want, tol: float) -> float:
    """max |got - want|, raising past tol * (1 + max |want|)."""
    err = (got.float() - want.float()).abs().max().item()
    if not err <= tol * (1.0 + want.float().abs().max().item()):
        raise SystemExit(f"ring differs: max |err| {err!r} > {tol} x "
                         f"(1 + max |want|)")
    return err


def bf16_err(got, want, what: str) -> tuple[float, float]:
    """max |got - want| and ||got - want|| / ||want||, raising past
    BF16_REL."""
    a, b = got.float(), want.float()
    rel = ((a - b).norm() / b.norm()).item()
    if not rel <= BF16_REL:
        raise SystemExit(f"bf16 {what} differs: ||err|| / ||want|| "
                         f"{rel!r} > {BF16_REL}")
    return (a - b).abs().max().item(), rel


def zigzag_on_card(torch, tring) -> None:
    """The pallas zigzag ring's values and gradients against the plain
    (jnp) zigzag ring and full attention under autograd, f32 (TF32 off)
    and bf16, at 1x2048x8x64."""
    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(20)
    q, k, v, g = (torch.randn(1, 2048, 8, 64, device="cuda", generator=gen)
                  for _ in range(4))
    for dtype in (torch.float32, torch.bfloat16):
        runs = {}
        for name, fn in (
                ("pallas", tring.make_ring_attention(
                    causal=True, layout="zigzag", block_impl="pallas")),
                ("plain", tring.make_ring_attention(causal=True,
                                                    layout="zigzag")),
                ("full", lambda a, b, c: tring.full_attention(
                    a, b, c, causal=True))):
            ins = [t.to(dtype).clone().requires_grad_() for t in (q, k, v)]
            out = fn(*ins)
            out.backward(g.to(dtype))
            runs[name] = [out.detach()] + [t.grad for t in ins]
        torch.cuda.synchronize()
        errs = {}
        for ref in ("plain", "full"):
            for i, what in enumerate(("out", "dq", "dk", "dv")):
                if dtype == torch.float32:
                    a, b = runs["pallas"][i], runs[ref][i]
                    rtol, atol = (1e-5, 1e-5) if i == 0 else (2e-4, 2e-5)
                    torch.testing.assert_close(
                        a, b, rtol=rtol, atol=atol,
                        msg=f"zigzag pallas ring {what} vs {ref}")
                    errs[f"{what} vs {ref}"] = (a - b).abs().max().item()
                else:
                    errs[f"{what} vs {ref}"] = bf16_err(
                        runs["pallas"][i], runs[ref][i], f"{what} vs {ref}")
        log(f"ring: make_ring_attention(layout='zigzag', block_impl="
            f"'pallas') at 1x2048x8x64 {str(dtype)[6:]} matches the plain "
            f"zigzag ring and full attention ("
            + ("values rtol/atol 1e-5, gradients rtol 2e-4 atol 2e-5); "
               "max |err| " if dtype == torch.float32 else
               f"||err|| / ||want|| within {BF16_REL}); (max |err|, "
               f"||err|| / ||want||) ")
            + f"{errs!r}")


def zigzag_offsets(tring, n: int, th: int) -> list:
    """Every (query stripe, key stripe, q_off, k_off, causal) quarter
    fold of an n-rank zigzag ring, each once: the ring's own schedule
    (`zigzag_schedule`) walked by all its ranks."""
    return sorted({quarter for me in range(n)
                   for step in tring.zigzag_schedule(me, n, th)
                   for quarter in step})


def quarter_grid(torch, fbk, tring) -> dict:
    """The three flash kernels against their plain versions at every
    quarter fold a 4-rank zigzag ring makes, B=2, H=8, D=64, quarters of
    256, f32 and bf16: each operand cut from a [2, 512, 8, 64] block (or
    its [2, 8, 512] carry) the way the ring cuts it (`_halves`), a fresh
    carry for a stripe's first fold, else a mid-stream one."""
    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(21)
    th = 256
    cases = zigzag_offsets(tring, ZZ_RING, th)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for qi, ki, q_off, k_off, causal in cases:
            full = flash_inputs(torch, gen, 2, 2 * th, 2 * th, 8, 64, dtype,
                                fresh=causal)
            q, k, v, m, l, acc, dout, lse, delta = full
            rows = lambda t, dim=1: tring._halves(t, th, dim)[qi]  # noqa
            keys = lambda t: tring._halves(t, th)[ki]              # noqa
            ins = (rows(q), keys(k), keys(v), rows(m, 2), rows(l, 2),
                   rows(acc), rows(dout), rows(lse, 2), rows(delta, 2))
            errs = flash_case(torch, fbk, ins, [q_off, k_off], causal)
            for key in worst:
                worst[key] = max(worst[key], errs[key])
    log(f"flash parity, {ZZ_RING}-rank zigzag quarters: {len(cases)} "
        f"(q_off, k_off, causal) folds x f32/bf16 at B=2, H=8, D=64, "
        f"quarters of {th}: {[c[2:] for c in cases]}; match the plain "
        f"versions (normwise {FLASH_TOL}, m elementwise); worst |err| "
        f"update {worst['fwd']!r}, dq {worst['dq']!r}, dk/dv "
        f"{worst['dkv']!r}")
    return worst


def remat_on_card(torch) -> None:
    """An AttentionClassifier (T=2048, embed 512, 8 heads, 2 blocks,
    pallas, zigzag) with remat against the same weights without it:
    logits and gradients, f32 (TF32 off), without and with dropout 0.1
    under one seed."""
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.attention import AttentionClassifier
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.randn(2, 2048, 8, device="cuda", generator=gen)
    y = torch.tensor([0, 1], device="cuda")
    kw = dict(**{k: ATT[k] for k in ("embed_dim", "num_heads", "mlp_dim",
                                      "num_blocks")},
              block_impl="pallas", layout="zigzag")
    for dropout in (0.0, 0.1):
        runs = []
        for remat in (False, True):
            model = core.init_params(AttentionClassifier(
                2048, 8, dropout_rate=dropout, remat=remat, **kw),
                0).cuda().train()
            core.use_generator(model, torch.Generator(
                device="cuda").manual_seed(5))
            logits = model(x)
            binary_cross_entropy(logits, y).backward()
            runs.append([logits.detach()] + [p.grad for p in
                                             model.parameters()])
        torch.cuda.synchronize()
        errs = [ring_err(a, b, FLASH_TOL) for a, b in zip(*runs)]
        same = all(torch.equal(a, b) for a, b in zip(*runs))
        log(f"remat: AttentionClassifier(T=2048, embed 512, 8 heads, 2 "
            f"blocks, pallas, zigzag, dropout {dropout}) with remat "
            f"against without: logits and {len(errs) - 1} gradients "
            f"within {FLASH_TOL} normwise, bit for bit: {same}; max |err| "
            f"{max(errs)!r}")


def attention_run(torch, fc, smk, fbk, name: str, extra=()) -> dict:
    """One `cli.main(["attention", ...])` run of ATT_RUNS (`extra` flags
    appended), its launch counts set to 0 just before and read just
    after."""
    import contextlib
    import io

    from idc_models_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["attention", "--seq-len", str(ATT["seq_len"]),
                "--features", str(ATT["features"]), "--embed-dim",
                str(ATT["embed_dim"]), "--num-heads", str(ATT["num_heads"]),
                "--mlp-dim", str(ATT["mlp_dim"]), "--num-blocks",
                str(ATT["num_blocks"]), "--batch-size", "1", "--block-impl",
                "pallas", "--steps", str(ATT_STEPS), "--synthetic-examples",
                str(ATT_EXAMPLES), "--seed", "0", *ATT_RUNS[name], *extra,
                "--path", tmp]
        out = io.StringIO()
        zero_counts(fc, smk, fbk)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = flash_counts(fbk)
        others = (fc.KERNEL.launches, smk.KERNEL.launches)
        records = jsonl(Path(tmp) / "logs" / "run.jsonl")
    for line in out.getvalue().splitlines():
        log(f"  attention {name} | {line}")
    if rc != 0:
        raise SystemExit(f"cli.main returned {rc}")
    steps = [r for r in records if r["event"] == "step"]
    vals = [r for r in records if r["event"] == "val"]
    if (not steps or not all(math.isfinite(r["loss"]) for r in steps)
            or len(vals) != 1 or not all(
                math.isfinite(vals[0][k]) for k in ("loss", "accuracy",
                                                    "auroc"))):
        raise SystemExit(f"attention {name}: step or val records missing "
                         f"or not finite: {steps} {vals}")
    blocks = ATT["num_blocks"]
    per_step, per_eval = ATT_PER_STEP[name], ATT_PER_EVAL[name]
    want = tuple(blocks * (ATT_STEPS * p + (ATT_VAL * per_eval if i == 0
                                            else 0))
                 for i, p in enumerate(per_step))
    log(f"main path: cli.main({' '.join(argv[:-1])} <tmp>) in {seconds!r} "
        f"s; step losses {[r['loss'] for r in steps]}; val {vals[0]}; "
        f"flash launches update/dq/dkv {launches} (expected {blocks} blocks "
        f"x ({ATT_STEPS} steps x {per_step} + {ATT_VAL} eval forwards x "
        f"({per_eval}, 0, 0)) = {want}); other kernels {others}")
    if launches != want or others != (0, 0):
        raise SystemExit(f"attention {name} launches {launches} / {others}")
    return {"launches": launches, "seconds": seconds,
            "losses": [r["loss"] for r in steps]}


def attention_grads(torch, card: str) -> None:
    """The gradients of one train batch at the bench width (ATT, the
    verb's seed-0 weights and first synthetic sequence, pallas, f32 with
    TF32 off), zigzag and zigzag with remat against contiguous, each
    tensor within ATT_GRAD_REL of its norm: the losses of the runs above
    cannot see a gradient's scale (RMSprop divides it out), this does."""
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.attention import AttentionClassifier
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    tf32_off(torch)
    x, y = synthetic.make_sequence_task(1, ATT["seq_len"], ATT["features"],
                                        seed=0)
    x, y = torch.as_tensor(x).cuda(), torch.as_tensor(y).cuda()
    grads = {}
    for name, (layout, remat) in (("contiguous", ("contiguous", False)),
                                  ("zigzag", ("zigzag", False)),
                                  ("zigzag_remat", ("zigzag", True))):
        model = core.init_params(AttentionClassifier(
            ATT["seq_len"], ATT["features"], block_impl="pallas",
            layout=layout, remat=remat,
            **{k: ATT[k] for k in ("embed_dim", "num_heads", "mlp_dim",
                                   "num_blocks")}), 0).cuda()
        binary_cross_entropy(model(x), y).backward()
        grads[name] = {n: p.grad for n, p in model.named_parameters()}
        del model
    torch.cuda.synchronize()
    base = grads["contiguous"]
    for name in ("zigzag", "zigzag_remat"):
        rel = {n: ((g - base[n]).norm() / base[n].norm()).item()
               for n, g in grads[name].items()}
        scale = {n: (g.norm() / base[n].norm()).item()
                 for n, g in grads[name].items()}
        worst = max(rel, key=rel.get)
        log(f"attention gradients at the bench width, {name} against "
            f"contiguous: {len(rel)} tensors, worst ||a - b|| / ||b|| "
            f"{rel[worst]!r} ({worst}), norm ratios "
            f"{min(scale.values())!r} .. {max(scale.values())!r} (bar "
            f"{ATT_GRAD_REL}); {card}")
        if not all(r <= ATT_GRAD_REL for r in rel.values()):
            raise SystemExit(f"attention {name} gradients differ: {rel}")
    same = all(torch.equal(g, grads["zigzag"][n])
               for n, g in grads["zigzag_remat"].items())
    log(f"attention gradients, remat against zigzag bit for bit: {same}")


def attention_path(torch, fc, smk, fbk, tring, card: str) -> dict:
    """Phase 10: (j) the `attention` verb at the bench width in the three
    layouts, their step losses held together; the zigzag ring, the
    quarter grid and remat on the card. Returns the runs and the grid's
    worst errors."""
    t0 = time.perf_counter()
    zigzag_on_card(torch, tring)
    grid = quarter_grid(torch, fbk, tring)
    remat_on_card(torch)
    runs = {name: attention_run(torch, fc, smk, fbk, name)
            for name in ATT_RUNS}
    base = runs["contiguous"]["losses"]
    for name in ("zigzag", "zigzag_remat"):
        got = runs[name]["losses"]
        rel = [abs(a - b) / abs(b) for a, b in zip(got, base)]
        log(f"attention {name} step losses {got!r} against contiguous "
            f"{base!r}: relative {rel!r} (bars {ATT_LOSS_RTOL_FIRST} at "
            f"step 0, {ATT_LOSS_RTOL} after)")
        if (len(got) != len(base) or not rel[0] <= ATT_LOSS_RTOL_FIRST
                or not all(r <= ATT_LOSS_RTOL for r in rel)):
            raise SystemExit(f"attention {name} losses leave the bars")
    attention_grads(torch, card)
    zz, rm = runs["zigzag"]["losses"], runs["zigzag_remat"]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(rm, zz))
    log(f"attention remat step losses against zigzag: bit for bit "
        f"{rm == zz}, largest relative difference {rel!r} (bar "
        f"{ATT_REMAT_RTOL}); {card}")
    if not rel <= ATT_REMAT_RTOL:
        raise SystemExit("remat changed the zigzag run's losses")
    log(f"phase 10 (attention) checks took {time.perf_counter() - t0!r} s")
    return {"runs": runs, "grid": grid}


def attention_step_times(torch, card: str) -> dict:
    """Host ms a train step of the attention classifier at the bench
    width (T=16,384, batch 1, pallas, f32), the three layouts in turns;
    device busy, idle share and kernels a step from the profiler; peak
    memory of a step."""
    from idc_models_tpu_torch.models import core
    from idc_models_tpu_torch.models.attention import AttentionClassifier
    from idc_models_tpu_torch.train.losses import binary_cross_entropy
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    gen = torch.Generator(device="cuda").manual_seed(23)
    x = torch.randn(1, ATT["seq_len"], ATT["features"], device="cuda",
                    generator=gen)
    y = torch.tensor([1], device="cuda")
    layouts = {"contiguous": ("contiguous", False),
               "zigzag": ("zigzag", False), "zigzag_remat": ("zigzag", True)}
    calls = {}
    for name, (layout, remat) in layouts.items():
        model = core.init_params(AttentionClassifier(
            ATT["seq_len"], ATT["features"], block_impl="pallas",
            layout=layout, remat=remat,
            **{k: ATT[k] for k in ("embed_dim", "num_heads", "mlp_dim",
                                   "num_blocks")}), 0).cuda()
        step = make_train_step(TrainState(model, rmsprop(model, 1e-4)),
                               binary_cross_entropy)
        calls[name] = lambda step=step: step(x, y)
    ms = {name: [] for name in calls}
    order = list(calls) + list(calls)[::-1]
    for name in order:
        ms[name].append(host_ms(torch, calls[name], n=5, warmup=1))
    out = {}
    for name, fn in calls.items():
        torch.cuda.empty_cache()
        peak = peak_mb(torch, fn)
        prof = profiled(torch, fn, n=3, kernel="flash_block")
        out[name] = {"host_ms": ms[name], "peak_mb": peak}
        log(f"time attention train step {name} (T={ATT['seq_len']}, embed "
            f"512, 8 heads, MLP 2048, 2 blocks, batch 1, pallas, f32): "
            f"{ms[name]!r} ms (in turns {order}); peak {peak!r} MB above "
            f"the weights; {prof}; {card}")
    return out


class _EmulatedRing:
    """Rank EMU_RING - 1 of an EMU_RING-rank ring on one card: each hop
    hands over the next visiting block, already on the card, cut as the
    fold asks (2 tensors: k, v; 4: their halves), so only the folds are
    timed, as experiments/zigzag_bench.py times one rank's schedule."""

    def __init__(self, tring, blocks):
        self.rank, self.size = EMU_RING - 1, EMU_RING
        th = blocks[0][0].shape[1] // 2
        self._whole = blocks
        self._halves = [(*tring._halves(k, th), *tring._halves(v, th))
                        for k, v in blocks]
        self._step = 0

    def start(self):
        self._step = 0
        return self

    def hop(self, *xs):
        self._step += 1
        if len(xs) == 2:
            return self._whole[self._step]
        k_lo, k_hi, v_lo, v_hi = self._halves[self._step]
        return k_lo, k_hi, v_lo, v_hi


def emulated_ring_times(torch, fbk, tring, card: str) -> dict:
    """One rank's forward schedule of a causal ring of EMU_RING ranks at
    t_local EMU_T, bf16, contiguous against zigzag (in turns c, z, z, c),
    CUDA events over the kernel folds alone; rank EMU_RING - 1, which
    sets the pace. The sizing to check (not a claim): contiguous folds
    one causal diagonal (half its tiles, skipped exactly) and 7 full
    blocks, 7.5 blocks; zigzag 2n+1 = 17 quarters, 4.25 blocks: 0.57 of
    the time at equal efficiency."""
    gen = torch.Generator(device="cuda").manual_seed(24)

    def mk(*shape):
        return torch.randn(*shape, device="cuda",
                           generator=gen).to(torch.bfloat16)

    q = mk(1, EMU_T, 8, 64)
    blocks = [(mk(1, EMU_T, 8, 64), mk(1, EMU_T, 8, 64))
              for _ in range(EMU_RING)]
    ring = _EmulatedRing(tring, blocks)
    attend = tring._kernel_attend(0.125)

    def contiguous():
        return tring._contiguous_fold(q, *blocks[0], attend, ring.start(),
                                      True)

    def zigzag():
        return tring._zigzag_fold(q, *blocks[0], attend, ring.start())

    ms = {"contiguous": [], "zigzag": []}
    for name in ("contiguous", "zigzag", "zigzag", "contiguous"):
        ms[name].append(time_ms(torch, {"contiguous": contiguous,
                                        "zigzag": zigzag}[name], 3,
                                warmup=1))
    ratio = min(ms["zigzag"]) / min(ms["contiguous"])
    log(f"time emulated ring-of-{EMU_RING} rank {EMU_RING - 1} forward "
        f"schedule, t_local {EMU_T}, bf16, causal: contiguous "
        f"{ms['contiguous']!r} ms, zigzag {ms['zigzag']!r} ms (in turns c, "
        f"z, z, c), zigzag / contiguous {ratio!r} (the schedule's work: "
        f"4.25 / 7.5 = {4.25 / 7.5!r}); {card}")
    return {**ms, "ratio": ratio}


def quarter_times(torch, fbk, card: str) -> dict:
    """Each flash kernel at the quarter size of the `attention` path's
    zigzag ring of one (B=1, 8192 x 8192, H=8, D=64, f32): the causal
    stripe diagonals (offsets [0, 0] and [8192, 8192], fresh carries)
    and the unmasked high-on-low quarter ([8192, 0], mid-stream), held
    against the plain versions (FLASH_TOL, two heads at a time), then
    device ms beside the bound."""
    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(25)
    t = ATT["seq_len"] // 2
    rows = {}
    for what, offs, causal in (("diagonal", [0, 0], True),
                               ("diagonal_high", [t, t], True),
                               ("unmasked", [t, 0], False)):
        ins = flash_inputs(torch, gen, 1, t, t, 8, 64, torch.float32,
                           fresh=causal)
        errs = flash_case(torch, fbk, ins, offs, causal, heads_per_plain=2)
        log(f"flash parity at the attention path's quarter {what} {t}x{t} "
            f"offsets {offs} causal {causal}, 1x{t}x8x64 f32: max |err| "
            f"update {errs['fwd']!r}, dq {errs['dq']!r}, dk/dv "
            f"{errs['dkv']!r} (normwise {FLASH_TOL}, m elementwise)")
        q, k, v, m, l, acc, dout, lse, delta = ins
        o = torch.tensor(offs, dtype=torch.int32, device="cuda")
        kw = dict(scale=0.125, causal=causal)
        grads_in = (q, k, v, dout, lse, delta, o)
        fns = {"fwd": lambda: fbk.flash_block_fold(q, k, v, m, l, acc, o,
                                                   **kw),
               "dq": lambda: fbk.flash_block_dq(*grads_in, **kw),
               "dkv": lambda: fbk.flash_block_dkv(*grads_in, **kw)}
        work = flash_bytes_flops(t, 64, 8, 4, causal=causal)
        for key, fn in fns.items():
            dev = device_ms(torch, fn, 5)
            nbytes, flops = work[key]
            bound = max(nbytes / PEAK_BYTES_PER_S,
                        flops / PEAK_TF32_FLOP_PER_S) * 1e3
            rows[(what, key)] = {"ms": dev, "bound_ms": bound,
                                 "max_abs_err": errs[key]}
            log(f"time flash {FLASH_NAMES[key]} zigzag quarter {what} "
                f"{t}x{t} f32: {dev!r} ms on the device (events behind a "
                f"sleep kernel), bound {bound!r} ms ({flops} flops of the "
                f"visible pairs at 495 TFLOP/s); kernel at "
                f"{bound / dev!r} of the bound; {card}")
        del ins, q, k, v, m, l, acc, dout, lse, delta, fns
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the rest of the classifier main path: vgg, dense, --cache-features
# ---------------------------------------------------------------------------

CLS_EXAMPLES = 512
DENSE_GRAD_REL = 1e-4   # packed vs concat phase-2 gradients, of max |g|


def logit_tol(ref) -> float:
    """The card-against-CPU bar: 1e-4 (1 + max |logit|)."""
    return 1e-4 * (1.0 + float(np.abs(ref).max()))


def classifier_run(torch, fc, smk, fbk, argv: list[str]) -> dict:
    """`cli.main(argv + ["--path", <tmp>])` with every launch count set
    to 0 just before it and read just after: its epoch and test records
    (held finite), the trained trees from model.npz, its seconds and the
    kernels' launches."""
    from idc_models_tpu_torch import cli
    from idc_models_tpu_torch.models.pretrained import load_pretrained_file

    with tempfile.TemporaryDirectory() as tmp:
        zero_counts(fc, smk, fbk)
        t0 = time.perf_counter()
        rc = cli.main(argv + ["--path", tmp])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {"fused": fc.KERNEL.launches,
                    "fused_3x3": fc.PATH_LAUNCHES["3x3"],
                    "masking": smk.KERNEL.launches,
                    "flash": sum(flash_counts(fbk))}
        records = [json.loads(line) for line in
                   (Path(tmp) / "logs" / "run.jsonl").read_text().splitlines()]
        params, state = load_pretrained_file(Path(tmp) / "model.npz")
    if rc != 0:
        raise SystemExit(f"cli.main({argv}) returned {rc}")
    epochs = [r for r in records if r["event"] == "epoch"]
    tests = [r for r in records if r["event"] == "test"]
    if len(epochs) != 2 or len(tests) != 1:
        raise SystemExit(f"{argv[0]}: expected 2 epoch records and 1 test "
                         f"record, got {[r['event'] for r in records]}")
    for r in epochs + tests:
        for k in ("loss", "accuracy", "val_loss", "val_accuracy", "auroc"):
            if k in r and not math.isfinite(r[k]):
                raise SystemExit(f"{argv[0]}: non-finite {k} in {r}")
    return {"epochs": epochs, "test": tests[0], "params": params,
            "state": state, "seconds": seconds, "launches": launches}


def same_history(name: str, got: list[dict], want: list[dict],
                 rtol: float = 1e-4) -> float:
    """Cached against uncached epoch records: loss and val_loss within
    `rtol` (1e-4: the JAX package's tests/test_feature_cache.py bar);
    returns the largest relative difference."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        for k in ("loss", "val_loss"):
            rel = abs(g[k] - w[k]) / abs(w[k])
            worst = max(worst, rel)
            if not rel <= rtol:
                raise SystemExit(f"{name}: {k} {g[k]!r} against "
                                 f"{w[k]!r} (rel {rel!r} > {rtol})")
    return worst


def card_vs_cpu(torch, model_fn, params, state, images, batch: int) -> tuple:
    """Eval logits of the same trained trees on the card and on the CPU
    (TF32 off): (card logits, max |diff|, tolerance)."""
    from idc_models_tpu_torch import convert
    from idc_models_tpu_torch.train.loop import predict

    tf32_off(torch)
    card = predict(convert.load_jax(model_fn(), params, state).cuda(),
                   images, batch_size=batch)
    cpu = predict(convert.load_jax(model_fn(), params, state), images,
                  batch_size=batch)
    err = float(np.abs(card - cpu).max())
    return card, err, logit_tol(cpu)


def vgg_path(torch, fc, smk, fbk, card: str) -> None:
    """`vgg` at full width (VGG16, 50x50, batch 32, lr 1e-3, fine-tune at
    15), then `vgg --cache-features`: no hand kernel runs on this path;
    finite metrics; the card's logits against the CPU's on the same
    weights; the cached phase 2 against the uncached one."""
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, train_val_test_split,
    )
    from idc_models_tpu_torch.models import vgg

    argv = ["vgg", "--synthetic-examples", str(CLS_EXAMPLES), "--epochs",
            "1", "--fine-tune-epochs", "1", "--seed", "0"]
    plain = classifier_run(torch, fc, smk, fbk, argv)
    cached = classifier_run(torch, fc, smk, fbk, argv + ["--cache-features"])
    for r in (plain, cached):
        if any(r["launches"].values()):
            raise SystemExit(f"vgg launched hand kernels: {r['launches']}")
    if not {"accuracy", "auroc"} <= set(plain["test"]):
        raise SystemExit(f"vgg test metrics lack accuracy/AUROC: "
                         f"{plain['test']}")
    rel = same_history("vgg", cached["epochs"], plain["epochs"])
    imgs, labels = synthetic.make_idc_like(CLS_EXAMPLES, 50, seed=0)
    _, _, test = train_val_test_split(ArrayDataset(imgs, labels), seed=0)
    logits, err, tol = card_vs_cpu(torch, lambda: vgg.vgg16(1),
                                   plain["params"], plain["state"],
                                   test.images, 32)
    log(f"classifier path: cli.main({' '.join(argv)}) in "
        f"{plain['seconds']!r} s, with --cache-features in "
        f"{cached['seconds']!r} s; epochs (loss, val_loss) "
        f"{[(r['loss'], r['val_loss']) for r in plain['epochs']]}, cached "
        f"{[(r['loss'], r['val_loss']) for r in cached['epochs']]} (largest "
        f"relative difference {rel!r}, bar 1e-4); test {plain['test']}; hand "
        f"kernel launches {plain['launches']} (none on this path); card vs "
        f"CPU eval logits over {len(test)} test patches, TF32 off: max "
        f"|diff| {err!r} (tolerance {tol!r}); {card}")
    if logits.shape != (len(test), 1) or not err <= tol:
        raise SystemExit(f"vgg card logits {logits.shape} differ from the "
                         f"CPU's by {err} > {tol}")


def dense_path(torch, fc, smk, fbk, card: str) -> None:
    """`dense` at full width (DenseNet201 packed, CIFAR-10 stand-in at
    32x32, batch 256, 10 classes, sparse CE, two passes an epoch,
    fine-tune at 150: phase 2 runs a backward through packed blocks),
    then `dense --cache-features`; packed against concat on the card
    (eval logits bit for bit, phase-2 gradients within DENSE_GRAD_REL
    of each tensor's largest |gradient|); card against CPU logits."""
    from idc_models_tpu_torch import convert
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.models import densenet
    from idc_models_tpu_torch.train.loop import predict

    argv = ["dense", "--synthetic-examples", str(CLS_EXAMPLES), "--epochs",
            "1", "--fine-tune-epochs", "1", "--seed", "0"]
    plain = classifier_run(torch, fc, smk, fbk, argv)
    cached = classifier_run(torch, fc, smk, fbk, argv + ["--cache-features"])
    for r in (plain, cached):
        if any(r["launches"].values()):
            raise SystemExit(f"dense launched hand kernels: {r['launches']}")
    rel = same_history("dense", cached["epochs"], plain["epochs"])
    params, state = plain["params"], plain["state"]
    # the verb's test split: the synthetic stand-in at seed 2*0 + 1
    test, _ = synthetic.make_cifar_like(max(CLS_EXAMPLES // 5, 64), seed=1)
    logits, err, tol = card_vs_cpu(
        torch, lambda: densenet.densenet201(10), params, state, test, 256)

    def build(impl, frozen_below=0):
        return convert.load_jax(densenet.densenet201(
            10, bn_frozen_below=frozen_below, block_impl=impl),
            params, state).cuda()

    x, y = synthetic.make_cifar_like(256, seed=5)
    concat = predict(build("concat"), x, batch_size=256)
    packed = predict(build("packed"), x, batch_size=256)
    same = bool(np.array_equal(packed, concat))
    xt = torch.as_tensor(x, device="cuda")
    r = torch.randn(256, 10, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    grads, stats = {}, {}
    for impl in ("packed", "concat"):
        m = build(impl, 150).train()
        mask = densenet.fine_tune_mask(m, 150)
        for k, p in m.named_parameters():
            p.requires_grad_(mask[k])
        (m(xt) * r).sum().backward()
        grads[impl] = {k: p.grad for k, p in m.named_parameters() if mask[k]}
        stats[impl] = dict(m.named_buffers())
    worst = max(float((grads["packed"][k] - g).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for k, g in grads["concat"].items())
    stat_err = max(float((stats["packed"][k] - v).abs().max())
                   / max(float(v.abs().max()), 1.0)
                   for k, v in stats["concat"].items())
    log(f"classifier path: cli.main({' '.join(argv)}) in "
        f"{plain['seconds']!r} s, with --cache-features in "
        f"{cached['seconds']!r} s; epochs (loss, val_loss) "
        f"{[(r['loss'], r['val_loss']) for r in plain['epochs']]}, cached "
        f"{[(r['loss'], r['val_loss']) for r in cached['epochs']]} (largest "
        f"relative difference {rel!r}, bar 1e-4); test {plain['test']}; hand "
        f"kernel launches {plain['launches']} (none on this path); card vs "
        f"CPU eval logits over {len(test)} test images, TF32 off: max "
        f"|diff| {err!r} (tolerance {tol!r}); packed vs concat eval logits "
        f"at batch 256 bit for bit: {same}; phase-2 gradients (fine-tune "
        f"at 150, train mode, batch 256) over {len(grads['concat'])} "
        f"tensors: largest max|diff| / max|g| {worst!r} (bar "
        f"{DENSE_GRAD_REL!r}), BN statistics max|diff| / max(1, max|v|) "
        f"{stat_err!r} (bar 1e-5); "
        f"{card}")
    if logits.shape != (len(test), 10) or not err <= tol:
        raise SystemExit(f"dense card logits {logits.shape} differ from "
                         f"the CPU's by {err} > {tol}")
    if not same:
        raise SystemExit(f"packed and concat eval logits differ on the "
                         f"card by {float(np.abs(packed - concat).max())}")
    if not worst <= DENSE_GRAD_REL or not stat_err <= 1e-5:
        raise SystemExit(f"packed and concat phase-2 gradients differ "
                         f"({worst}) or statistics ({stat_err})")


def mobile_cache_path(torch, fc, smk, fbk, uncached: dict,
                      card: str) -> int:
    """`mobile --cache-features --depthwise-impl fused` (the main path's
    argv plus the cache): the fused kernel's launches held to the
    schedule -- 17 chains a phase-1 train and eval forward, 11 (the
    prefix's) a batch of compute_features, none a suffix train step (its
    6 chains train their BNs), 6 a suffix eval forward -- and the
    phase-2 history to the uncached main path's. Returns the launches."""
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, train_val_test_split,
    )
    from idc_models_tpu_torch.data.pipeline import Loader
    from idc_models_tpu_torch.models import mobilenet, registry
    from idc_models_tpu_torch.train import feature_cache

    preset = get_preset("mobile")
    argv = ["mobile", "--depthwise-impl", "fused", "--synthetic-examples",
            "512", "--epochs", "1", "--fine-tune-epochs", "1", "--seed", "0",
            "--cache-features"]
    run = classifier_run(torch, fc, smk, fbk, argv)
    rel = same_history("mobile", run["epochs"], uncached["epochs"])
    imgs, labels = synthetic.make_idc_like(512, preset.image_size, seed=0)
    train, val, test = train_val_test_split(ArrayDataset(imgs, labels),
                                            seed=0)
    spec = registry.get_model(preset.model)
    plan = feature_cache.plan_feature_cache(
        spec.build(1, bn_frozen_below=preset.fine_tune_at,
                   depthwise_impl="fused"),
        spec.layer_index, preset.fine_tune_at)
    suffix = sum(n.endswith("depthwise_BN") for n in plan.suffix_keys)
    prefix = mobilenet.fused_chain_count(preset.fine_tune_at, train=False) \
        - suffix
    if (prefix, suffix) != (11, 6):
        raise SystemExit(f"mobile cache split {prefix}/{suffix} chains, "
                         f"expected 11/6")
    bs = preset.batch_size
    steps = len(Loader(train, bs))
    val_fwd, train_fwd = -(-len(val) // bs), -(-len(train) // bs)
    test_fwd = -(-len(test) // bs)
    # phase 1: train steps, the untrained floor and epoch 1's validation;
    # the cache over train and val; epoch 2's validation on the suffix;
    # the test evaluation on the full model
    expected = (17 * steps + 17 * (min(val_fwd, 20) + val_fwd)
                + prefix * (train_fwd + val_fwd) + suffix * val_fwd
                + 17 * test_fwd)
    got = run["launches"]
    log(f"classifier path: cli.main({' '.join(argv)}) in "
        f"{run['seconds']!r} s; epochs (loss, val_loss) "
        f"{[(r['loss'], r['val_loss']) for r in run['epochs']]} against the "
        f"uncached main path's "
        f"{[(r['loss'], r['val_loss']) for r in uncached['epochs']]} "
        f"(largest relative difference {rel!r}, bar 1e-4); fused kernel "
        f"launches {got['fused']} (expected 17 x ({steps} phase-1 steps + "
        f"{min(val_fwd, 20) + val_fwd} eval forwards + {test_fwd} test) + "
        f"{prefix} x {train_fwd + val_fwd} cached batches + {suffix} x "
        f"{val_fwd} suffix eval forwards = {expected}), all on the 3x3 "
        f"path: {got['fused_3x3'] == got['fused']}; {card}")
    if got["fused"] != expected or got["fused_3x3"] != got["fused"] \
            or got["masking"] or got["flash"]:
        raise SystemExit(f"mobile --cache-features launches {got} != "
                         f"{expected}")
    return got["fused"]


def peak_mb(torch, fn) -> float:
    """Peak device memory (MB) of one call of `fn`, above what was
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def classifier_step_times(torch, card: str) -> None:
    """Where a `vgg` and a `dense` step's time goes, TF32 off: for the
    phase-1 step, the phase-2 step, the cached phase-2 step (the suffix
    on cached features) and the eval forward, host ms a call (in turns
    with the next), then the profiler's device busy, idle share and
    kernels a call, and peak memory; then DenseNet201's eval forward,
    packed against concat at batch 256: device busy, kernels a call (cat
    kernels among them) and peak memory. (CUDA events would time the
    host here: at about 2,600 kernels a forward, the card outruns the
    launches.)"""
    from idc_models_tpu_torch.models import core, densenet, registry
    from idc_models_tpu_torch.train import feature_cache, losses
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import (
        make_eval_step, make_train_step,
    )

    tf32_off(torch)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for name, size, batch, n_out, at in (("vgg16", 50, 32, 1, 15),
                                         ("densenet201", 32, 256, 10, 150)):
        spec = registry.get_model(name)
        x = torch.rand(batch, size, size, 3, device="cuda", generator=gen)
        y = torch.randint(0, max(n_out, 2), (batch,), device="cuda",
                          generator=gen)
        loss = (losses.binary_cross_entropy if n_out == 1
                else losses.sparse_categorical_cross_entropy)
        calls = {}
        for phase, frozen_below in (("phase-1", densenet.FREEZE_ALL),
                                    ("phase-2", at)):
            kw = ({} if name == "vgg16"
                  else {"bn_frozen_below": frozen_below})
            model = core.init_params(spec.build(n_out, **kw), 0).cuda()
            mask = (spec.head_only_mask(model) if phase == "phase-1"
                    else spec.fine_tune_mask(model, at))
            step = make_train_step(TrainState(model, rmsprop(
                model, 1e-4, trainable_mask=mask)), loss)
            calls[f"{phase} train step"] = lambda step=step: step(x, y)
        plan = feature_cache.plan_feature_cache(model, spec.layer_index, at)
        with torch.no_grad():
            feats = plan.prefix.eval()(x).clone()
        suffix = plan.suffix_model
        sstep = make_train_step(TrainState(suffix, rmsprop(
            suffix, 1e-4, trainable_mask=spec.fine_tune_mask(suffix, at))),
            loss)
        calls["cached phase-2 train step"] = lambda: sstep(feats, y)
        ev = make_eval_step(model, loss)
        calls["eval forward"] = lambda: ev(x, y)
        names = list(calls)
        ms = {k: [] for k in names}
        for k in names + names[::-1]:
            ms[k].append(host_ms(torch, calls[k], n=5, warmup=2))
        for k in names:
            peak = peak_mb(torch, calls[k])
            # two calls: a DenseNet201 step launches about 10k kernels
            log(f"time {name} {k} b{batch} {size}x{size}: host {ms[k]!r} ms "
                f"a call (in turns); peak memory {peak!r} MB above the "
                f"weights; TF32 off; "
                f"{profiled(torch, calls[k], n=2)}; {card}")
        del calls, model, suffix, plan, feats
        torch.cuda.empty_cache()

    x = torch.rand(256, 32, 32, 3, device="cuda", generator=gen)
    fwd = {}
    for impl in ("packed", "concat"):
        m = core.init_params(densenet.densenet201(10, block_impl=impl),
                             0).cuda().eval()

        def forward(m=m):
            with torch.no_grad():
                return m(x)

        fwd[impl] = forward
    for impl in ("packed", "concat", "concat", "packed"):
        counts = kernel_counts(torch, fwd[impl], n=3)
        cats = sum(v for k, v in counts.items() if "Cat" in k)
        log(f"time densenet201 eval forward b256 32x32 {impl} (in turns "
            f"p, c, c, p): {profiled(torch, fwd[impl], n=3)}; {cats!r} cat "
            f"kernels a call; peak memory {peak_mb(torch, fwd[impl])!r} MB "
            f"above the weights; TF32 off; {card}")


# ---------------------------------------------------------------------------
# the federated path: the `fed` verb (FedAvg over a pretrained VGG16)
# ---------------------------------------------------------------------------

# the fed preset at full width (VGG16, 50x50, batch 32, lr 1e-3 to
# pretrain and 1e-4 for the clients, fine-tune at 15, 10 clients: 8 train
# and 2 test, 1 local epoch), cut in data, pretraining and rounds
FED_EXAMPLES, FED_ROUNDS = 2048, 3
FED_CUTS = (
    f"{FED_EXAMPLES} synthetic 50x50 patches (the repo holds no IDC data; "
    f"the preset takes up to 30,000)",
    "--pretrain-epochs 1 (the preset's 10)",
    f"--rounds {FED_ROUNDS} (the preset's 10), then a resume to "
    f"{FED_ROUNDS + 1}",
)


def fed_records(path: Path) -> list[dict]:
    return [json.loads(line) for line in
            (path / "logs" / "run.jsonl").read_text().splitlines()]


def fed_run(torch, fc, smk, fbk, argv: list[str]) -> tuple[str, float]:
    """`cli.main(argv)` with every launch count set to 0 just before it and
    read just after (none may launch on this path); returns its standard
    output, echoed here, and its seconds."""
    import contextlib
    import io

    from idc_models_tpu_torch import cli

    buf = io.StringIO()
    zero_counts(fc, smk, fbk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"fused": fc.KERNEL.launches, "masking": smk.KERNEL.launches,
                "flash": sum(flash_counts(fbk))}
    out = buf.getvalue()
    for line in out.splitlines():
        log(f"fed| {line}")
    if rc != 0:
        raise SystemExit(f"cli.main({argv}) returned {rc}")
    if any(launches.values()):
        raise SystemExit(f"fed launched hand kernels: {launches}")
    return out, seconds


def fed_path(torch, fc, smk, fbk, card: str) -> None:
    """(g) `cli.main(["fed", ...])` at the fed preset's width for
    FED_ROUNDS rounds; its resume; a fault drill; one round on the card
    against the CPU; round times."""
    import shutil

    from idc_models_tpu_torch.data.partition import train_test_client_split
    from idc_models_tpu_torch.federated import ServerState
    from idc_models_tpu_torch.models import vgg
    from idc_models_tpu_torch.train.checkpoint import (
        checkpoint_exists, restore_checkpoint,
    )

    tf32_off(torch)
    for cut in FED_CUTS:
        log(f"fed cut: {cut}")
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "run"
        argv = ["fed", "--synthetic-examples", str(FED_EXAMPLES),
                "--pretrain-epochs", "1", "--seed", "0", "--path", str(run)]
        _, seconds = fed_run(torch, fc, smk, fbk,
                             argv + ["--rounds", str(FED_ROUNDS)])
        recs = fed_records(run)
        rounds = [r for r in recs if r["event"] == "round"]
        health = [r for r in recs if r["event"] == "round_health"]
        if [r["round"] for r in rounds] != list(range(FED_ROUNDS)):
            raise SystemExit(f"fed: round records {rounds}")
        for r in rounds:
            if not all(math.isfinite(r[k]) for k in (
                    "train_loss", "train_acc", "test_loss", "test_acc")):
                raise SystemExit(f"fed: non-finite round metrics {r}")
            if r["clients_dropped"] != 0:
                raise SystemExit(f"fed: clients dropped in {r}")
        if any(h["status"] != "ok" or h["participants"] != 8
               for h in health):
            raise SystemExit(f"fed: round_health {health}")
        for d in (run / "pretrained" / "cp.ckpt", run / "fed_server"):
            if not (checkpoint_exists(d) and (d / "_IDC_COMPLETE").is_file()):
                raise SystemExit(f"fed: no complete checkpoint at {d}")
        (pretrain,) = [r["seconds"] for r in recs if r["event"] == "timer"
                       and r["name"].startswith("Pre-training")]
        log(f"fed path: cli.main({' '.join(argv[:-2])} --rounds "
            f"{FED_ROUNDS}) in {seconds!r} s; rounds (train_loss, "
            f"train_acc, test_loss, test_acc) "
            f"{[(r['train_loss'], r['train_acc'], r['test_loss'], r['test_acc']) for r in rounds]}; "
            f"no client dropped; pretrained/cp.ckpt and fed_server complete; "
            f"hand kernel launches 0 (none on this path)")
        log(f"time fed: the pretraining epoch (VGG16 head, 50x50, batch 32, "
            f"{int(FED_EXAMPLES * 0.8)} patches, with its validation) took "
            f"{pretrain!r} s of host time; the driver's round seconds (a "
            f"synchronize ends each) {[h['seconds'] for h in health]!r}; "
            f"TF32 off; {card}")

        out, seconds = fed_run(torch, fc, smk, fbk,
                               argv + ["--rounds", str(FED_ROUNDS + 1)])
        new = [r for r in fed_records(run) if r["event"] == "round"][
            len(rounds):]
        if ("restored pretrained weights from" not in out
                or f"resuming federated training from round {FED_ROUNDS}"
                not in out or "Pre-training" in out
                or [r["round"] for r in new] != [FED_ROUNDS]):
            raise SystemExit(f"fed resume: new round records {new}")
        log(f"fed resume: --rounds {FED_ROUNDS + 1} restored the pretrained "
            f"weights without retraining, resumed from round {FED_ROUNDS}, "
            f"ran it alone and appended one round record in {seconds!r} s")

        train_ids, _ = train_test_client_split(10, 0.2, seed=0)
        if not {0, 1} <= set(train_ids.tolist()):
            raise SystemExit(f"fed drill: clients 0 and 1 must train, "
                             f"train clients are {train_ids}")
        drills = {"nan": ["--rounds", "1", "--faults", "nan:1"],
                  "sign_flip": ["--rounds", "2", "--faults",
                                "sign_flip:0-1:x1000", "--aggregator",
                                "trimmed_mean", "--trim", "2"]}
        for name, extra in drills.items():
            d = Path(tmp) / name
            shutil.copytree(run / "pretrained", d / "pretrained")
            fed_run(torch, fc, smk, fbk, argv[:-1] + [str(d)] + extra)
            h = [r for r in fed_records(d) if r["event"] == "round_health"]
            if name == "nan" and [r["clients_dropped"] for r in h] != [1.0]:
                raise SystemExit(f"fed drill nan:1: round_health {h}")
            # both attackers out of the kept band on (nearly) every
            # coordinate: clients_trimmed flags them
            if name == "sign_flip" and not all(
                    r["status"] == "ok" and math.isfinite(r["loss"])
                    and r.get("clients_trimmed", 0) >= 2 for r in h):
                raise SystemExit(f"fed drill sign_flip: round_health {h}")
            log(f"fed drill {' '.join(extra)}: round_health "
                + "; ".join(f"round {r['round']} {r['status']} loss "
                            f"{r['loss']!r} clients_dropped "
                            f"{r['clients_dropped']!r}"
                            + (f" clients_trimmed {r['clients_trimmed']!r}"
                               if "clients_trimmed" in r else "")
                            for r in h))

        server = ServerState.from_tree(restore_checkpoint(
            run / "fed_server", ServerState.of(vgg.vgg16(1)).tree()))
    fed_card_vs_cpu(torch, server, card)
    fed_round_times(torch, card)


# f32 data draws of the card-against-CPU round, measured and not held
FED_F32_DRAWS = 6


def fed_round_pair(torch, server, dtype, seed: int) -> tuple[float, dict]:
    """One `make_fedavg_round` from `server` on the card and on the CPU in
    `dtype`: VGG16 under the fine-tune mask at 15, lr 1e-4, 4 clients of
    32 patches at 50x50 (one full-shard step each), TF32 off. Returns the
    largest |card - CPU| over the 1e-4 (1 + max |w|) tolerance of its
    tensor, and both rounds' metrics and seconds."""
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.federated.fedavg import make_fedavg_round
    from idc_models_tpu_torch.models import vgg
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    tf32_off(torch)
    imgs, labels = synthetic.make_idc_like(4 * 32, 50, seed=seed)
    imgs = imgs.reshape(4, 32, 50, 50, 3)
    labels = labels.reshape(4, 32)
    weights = np.full(4, 32.0, np.float32)
    server = server.replace(
        params={k: v.to(dtype) for k, v in server.params.items()},
        state={k: v.to(dtype) for k, v in server.state.items()})
    out = {}
    for device in ("cuda", "cpu"):
        model = vgg.vgg16(1).to(dtype)
        rnd = make_fedavg_round(model, 1e-4, binary_cross_entropy,
                                batch_size=32,
                                trainable_mask=vgg.fine_tune_mask(model, 15),
                                device=device)
        t0 = time.perf_counter()
        got, m = rnd(server.to(device), imgs, labels, weights, (1, 0, 0))
        out[device] = (got, m, time.perf_counter() - t0)
    worst = 0.0
    for k, w in out["cpu"][0].params.items():
        err = float((out["cuda"][0].params[k].cpu() - w).abs().max())
        worst = max(worst, err / (1e-4 * (1 + float(w.abs().max()))))
    return worst, {d: (m, sec) for d, (_, m, sec) in out.items()}


def fed_card_vs_cpu(torch, server, card: str) -> None:
    """One `make_fedavg_round` from the same carried server weights on the
    card and on the CPU, held to 1e-4 (1 + max |w|) a tensor, in float64.
    In f32 the comparison is ill-conditioned, and is measured over
    FED_F32_DRAWS data draws, not held: a client's first Keras RMSprop
    step is lr g / (sqrt(0.1 g^2) + 1e-7), whose slope at g = 0 is lr /
    1e-7 = 1000, so the card's and the CPU's f32 summation orders, which
    give a near-zero gradient coordinate values about 1e-7 apart, move
    that weight up to about 1e-4 apart. Float64 leaves the slope and
    removes the rounding it amplifies; a wrong gradient sign still moves
    a weight 2 sqrt(10) lr = 6.3e-4, past the tolerance."""
    worst, m = fed_round_pair(torch, server, torch.float64, seed=5)
    log(f"fed card vs CPU: one make_fedavg_round from the carried server, "
        f"float64, VGG16 fine-tune mask at 15, lr 1e-4, 4 clients x 32 "
        f"patches at 50x50, full-shard steps: the largest |card - CPU| is "
        f"{worst!r} of the tolerance 1e-4 (1 + max |w|) a tensor; loss "
        f"{m['cuda'][0]['loss']!r} (card) against {m['cpu'][0]['loss']!r} "
        f"(CPU); {m['cuda'][1]!r} s on the card, {m['cpu'][1]!r} s on the "
        f"CPU; {card}")
    if not worst <= 1.0 or not abs(
            m["cuda"][0]["loss"] - m["cpu"][0]["loss"]) <= 1e-4 * (
            1 + abs(m["cpu"][0]["loss"])):
        raise SystemExit(f"fed round on the card differs from the CPU's: "
                         f"{worst} of the tolerance")
    f32 = [fed_round_pair(torch, server, torch.float32, seed=5 + i)[0]
           for i in range(FED_F32_DRAWS)]
    log(f"fed card vs CPU in f32 (TF32 off), measured, not held: the same "
        f"round on {FED_F32_DRAWS} data draws gives the largest |card - "
        f"CPU| as {f32!r} of the same tolerance ({sum(r > 1 for r in f32)} "
        f"above it): RMSprop's first step amplifies f32 summation-order "
        f"differences of near-zero gradients 1000x; {card}")


def fed_round_times(torch, card: str) -> None:
    """A fed round at the phase's size (10 clients of FED_EXAMPLES / 10
    patches, 8 of them training in steps of 32, VGG16 fine-tune mask at
    15), with
    the mean and with the trimmed mean (trim 1): host ms a round ending
    in a synchronize, in turns; then the profiler's device busy, idle
    share and kernels a round, and peak memory."""
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import ArrayDataset
    from idc_models_tpu_torch.data.partition import (
        partition_clients, train_test_client_split,
    )
    from idc_models_tpu_torch.federated.fedavg import (
        ServerState, make_fedavg_round,
    )
    from idc_models_tpu_torch.models import core, vgg
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    tf32_off(torch)
    imgs, labels = synthetic.make_idc_like(FED_EXAMPLES, 50, seed=0)
    ci, cl = partition_clients(ArrayDataset(imgs, labels), 10, iid=True)
    imgs = torch.as_tensor(ci.astype(np.float32), device="cuda")
    labels = torch.as_tensor(cl, device="cuda")
    train_ids, _ = train_test_client_split(10, 0.2, seed=0)
    w = np.zeros(10, np.float32)
    w[train_ids] = ci.shape[1]
    model = core.init_params(vgg.vgg16(1), 0).cuda()
    server = ServerState.of(model)
    calls = {}
    for agg in ("mean", "trimmed_mean"):
        rnd = make_fedavg_round(model, 1e-4, binary_cross_entropy,
                                batch_size=32, aggregator=agg,
                                trainable_mask=vgg.fine_tune_mask(model, 15),
                                device="cuda")
        calls[agg] = lambda rnd=rnd: rnd(server, imgs, labels, w, (0, 0, 0))
    names = list(calls)
    ms = {k: [] for k in names}
    for k in names + names[::-1]:
        ms[k].append(host_ms(torch, calls[k], n=2, warmup=1))
    steps = max(ci.shape[1] // 32, 1)
    for k in names:
        log(f"time fed round ({k}, 10 clients x {ci.shape[1]} patches, 8 "
            f"training, {steps} steps of 32 each, VGG16 50x50): host "
            f"{ms[k]!r} ms "
            f"a round (in turns); peak memory {peak_mb(torch, calls[k])!r} "
            f"MB above the weights and shards; TF32 off; "
            f"{profiled(torch, calls[k], n=2)}; {card}")


# ---------------------------------------------------------------------------
# the population path: `fed --population` (virtual clients, streamed
# waves, the buffered async server)
# ---------------------------------------------------------------------------

# the fed preset's width (VGG16, 50x50, batch 32, clients at lr 1e-4, 1
# local epoch) over virtual clients, every layer training, cut in
# population and rounds
POP, POP_BIG, COHORT, WAVE, POP_EXAMPLES, POP_ROUNDS = (
    10_000, 1_000_000, 32, 8, 16, 3)
POP_CUTS = (
    f"--population {POP} (and {POP_BIG} for the memory check), --cohort "
    f"{COHORT}, --client-examples {POP_EXAMPLES}: one step of "
    f"{POP_EXAMPLES} a client at batch 32",
    f"--rounds {POP_ROUNDS} (the preset's 10), then a restart at "
    f"{POP_ROUNDS + 1}",
)
FED_COHORT_KEYS = {
    "sync": {"ts", "event", "round", "mode", "population", "cohort",
             "participants", "waves", "wave_size"},
    "async": {"ts", "event", "round", "mode", "population", "cohort",
              "participants", "buffer", "updates", "staleness_mean",
              "staleness_max", "staleness_hist"},
}


def population_checks(recs: list[dict], mode: str, rounds: list[int]):
    """The run's round, round_health and fed_cohort records: one each a
    round, finite metrics, every cohort member healthy, the frozen
    fed_cohort keys."""
    got = {e: [r for r in recs if r["event"] == e]
           for e in ("round", "round_health", "fed_cohort")}
    for e, rs in got.items():
        if [r["round"] for r in rs] != rounds:
            raise SystemExit(f"population {mode}: {e} records {rs}")
    for r in got["round"]:
        if not all(math.isfinite(r[k]) for k in (
                "train_loss", "train_acc", "test_loss", "test_acc")):
            raise SystemExit(f"population {mode}: non-finite {r}")
    if any(h["status"] != "ok" or h["participants"] != COHORT
           for h in got["round_health"]):
        raise SystemExit(f"population {mode}: {got['round_health']}")
    for c in got["fed_cohort"]:
        if set(c) != FED_COHORT_KEYS[mode] or c["mode"] != mode:
            raise SystemExit(f"population {mode}: fed_cohort {c}")
    return got


def population_path(torch, fc, smk, fbk, card: str) -> None:
    """(h1) sync and its restart, (h2) async, (h4) the straggler drill,
    each through `cli.main(["fed", "--population", ...])` with every
    launch count held at 0; then (h3), (h5) and the round times."""
    from idc_models_tpu_torch.federated import ClientPopulation, CohortSampler

    tf32_off(torch)
    for cut in POP_CUTS:
        log(f"population cut: {cut}")
    base = ["fed", "--population", str(POP), "--cohort", str(COHORT),
            "--client-examples", str(POP_EXAMPLES), "--seed", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        run = Path(tmp) / "sync"
        argv = base + ["--cohort-wave", str(WAVE), "--path", str(run)]
        out, seconds = fed_run(torch, fc, smk, fbk,
                               argv + ["--rounds", str(POP_ROUNDS)])
        got = population_checks(fed_records(run), "sync",
                                list(range(POP_ROUNDS)))
        want = (f"population: {POP} virtual clients, cohort {COHORT} "
                f"(uniform) in {COHORT // WAVE} wave(s) of {WAVE}")
        if want not in out or any(c["waves"] != COHORT // WAVE
                                  for c in got["fed_cohort"]):
            raise SystemExit(f"population sync: {got['fed_cohort']}")
        log(f"population sync: cli.main({' '.join(argv[:-2])} --rounds "
            f"{POP_ROUNDS}) in {seconds!r} s; rounds (train_loss, "
            f"train_acc, test_loss, test_acc) "
            f"{[(r['train_loss'], r['train_acc'], r['test_loss'], r['test_acc']) for r in got['round']]}; "
            f"{COHORT // WAVE} waves a round, fed_cohort keys frozen; the "
            f"driver's round seconds (a synchronize ends each) "
            f"{[h['seconds'] for h in got['round_health']]!r}; hand "
            f"kernel launches 0; TF32 off; {card}")
        out, seconds = fed_run(torch, fc, smk, fbk,
                               argv + ["--rounds", str(POP_ROUNDS + 1)])
        population_checks(fed_records(run), "sync",
                          list(range(POP_ROUNDS + 1)))
        printed = [x.split(",")[0] for x in out.splitlines()
                   if x[:1].isdigit() and x.count(",") == 4]
        if (f"resuming federated training from round {POP_ROUNDS}"
                not in out or printed != [str(POP_ROUNDS)]):
            raise SystemExit(f"population restart ran rounds {printed}")
        log(f"population restart: --rounds {POP_ROUNDS + 1} resumed from "
            f"round {POP_ROUNDS}, drew its cohort again and ran it alone "
            f"in {seconds!r} s (one round and one fed_cohort record "
            f"appended)")

        run = Path(tmp) / "async"
        argv = base + ["--async-buffer", str(WAVE), "--rounds",
                       str(POP_ROUNDS), "--path", str(run)]
        out, seconds = fed_run(torch, fc, smk, fbk, argv)
        got = population_checks(fed_records(run), "async",
                                list(range(POP_ROUNDS)))
        line = [x for x in out.splitlines() if x.startswith("async buffer")]
        if not line or any(c["updates"] < 1 for c in got["fed_cohort"]):
            raise SystemExit(f"population async: {got['fed_cohort']}")
        log(f"population async: cli.main({' '.join(argv[:-2])}) in "
            f"{seconds!r} s; rounds "
            f"{[(r['train_loss'], r['test_loss'], r['test_acc']) for r in got['round']]}; "
            f"updates a round {[c['updates'] for c in got['fed_cohort']]}, "
            f"staleness histograms "
            f"{[c['staleness_hist'] for c in got['fed_cohort']]}; "
            f"'{line[0]}'; the driver's round seconds "
            f"{[h['seconds'] for h in got['round_health']]!r}; {card}")

        # (h4) one straggler of lag 2 in the sync run's round-0 cohort and
        # one at the head of the async dispatch stream
        small = ClientPopulation(POP, examples_per_client=POP_EXAMPLES,
                                 seed=0)
        lag = [int(CohortSampler(small, COHORT).cohort(0)[0]),
               CohortSampler(small, COHORT).client_at(0)]
        drill = base + ["--model", "small_cnn", "--rounds", "2",
                        "--fault-delay-ms", "250", "--faults",
                        f"straggler:*:2@c{lag[0]},c{lag[1]}"]
        walls = {}
        for mode, extra in (("sync", ["--cohort-wave", str(WAVE)]),
                            ("async", ["--async-buffer", str(WAVE)])):
            d = Path(tmp) / f"drill_{mode}"
            fed_run(torch, fc, smk, fbk, drill + extra + ["--path", str(d)])
            walls[mode] = [h["seconds"] for h in population_checks(
                fed_records(d), mode, [0, 1])["round_health"]]
        if not walls["sync"][0] >= 0.5:
            raise SystemExit(f"population drill: the sync round holding "
                             f"the straggler took {walls['sync'][0]} s, "
                             f"under its 0.5 s barrier")
        log(f"population drill (small CNN, straggler:*:2@c{lag[0]},"
            f"c{lag[1]}, --fault-delay-ms 250): round seconds sync "
            f"{walls['sync']!r} (round 0 waits its 0.5 s barrier) against "
            f"async {walls['async']!r} (a late arrival reorders the "
            f"buffer, nothing waits); {card}")
    population_rounds(torch, card)


def population_round_fns(torch, population: int = POP):
    """VGG16 at the fed preset's width (all layers, lr 1e-4, batch 32)
    over `population` virtual clients: the server and the sync round in 1
    and in 4 waves, the async round (K = 8) and the one-shot round, all
    on the card."""
    from idc_models_tpu_torch.federated import (
        ClientPopulation, CohortSampler, ServerState, make_async_round,
        make_fedavg_round, make_population_round,
    )
    from idc_models_tpu_torch.models import core, vgg
    from idc_models_tpu_torch.train.losses import binary_cross_entropy

    pop = ClientPopulation(population, examples_per_client=POP_EXAMPLES,
                           image_size=50)
    sampler = CohortSampler(pop, COHORT)
    model = core.init_params(vgg.vgg16(1), 0).cuda()
    kw = dict(batch_size=32, device="cuda")
    fns = {"1 wave": make_population_round(
               model, 1e-4, binary_cross_entropy, pop, sampler,
               wave_size=COHORT, **kw),
           "4 waves": make_population_round(
               model, 1e-4, binary_cross_entropy, pop, sampler,
               wave_size=WAVE, **kw),
           "async": make_async_round(
               model, 1e-4, binary_cross_entropy, pop, sampler,
               buffer_size=WAVE, **kw),
           "one-shot": make_fedavg_round(model, 1e-4, binary_cross_entropy,
                                         **kw)}
    return pop, sampler, ServerState.of(model), fns


def population_rounds(torch, card: str) -> None:
    """(h3) one wave against the one-shot round and 4 waves against 1;
    (h5) peak memory at two population sizes; round times."""
    # no atomics in cuDNN's weight gradients: two programs on the same
    # inputs agree bit for bit
    torch.backends.cudnn.deterministic = True
    pop, sampler, server, fns = population_round_fns(torch)
    imgs, labels, w = pop.materialize(sampler.cohort(0))
    imgs = torch.as_tensor(imgs, device="cuda")
    labels = torch.as_tensor(labels, device="cuda")
    key = (1, 0, 0)
    one, m1 = fns["one-shot"](server, imgs, labels, w, key)
    wave, mw = fns["1 wave"](server, None, None, None, key, round_idx=0)
    four, m4 = fns["4 waves"](server, None, None, None, key, round_idx=0)
    same = all(torch.equal(one.params[k], wave.params[k])
               for k in one.params) and m1["loss"] == mw["loss"]
    worst = max(float(((four.params[k] - wave.params[k]).abs()
                       / (2e-6 + 2e-5 * wave.params[k].abs())).max())
                for k in wave.params)
    log(f"population on the card (VGG16, {COHORT} clients x "
        f"{POP_EXAMPLES} patches, cuDNN deterministic, TF32 off): one wave "
        f"equals make_fedavg_round on the materialized cohort bit for bit: "
        f"{same} (loss {mw['loss']!r} against {m1['loss']!r}); 4 waves "
        f"against 1: the largest |diff| / (2e-6 + 2e-5 |w|) is {worst!r} "
        f"(must be <= 1); {card}")
    if not same or not worst <= 1.0:
        raise SystemExit("population round on the card: one wave differs "
                         "from the one-shot round, or 4 waves from 1")
    torch.backends.cudnn.deterministic = False
    del one, wave, four, imgs, labels

    peaks = {}
    for size in (POP, POP_BIG):
        _, _, srv, big = population_round_fns(torch, size)
        call = big["4 waves"]
        call(srv, None, None, None, key, round_idx=0)        # warm-up
        peaks[size] = peak_mb(torch, lambda: call(
            srv, None, None, None, key, round_idx=1))
        del srv, big
    grown = peaks[POP_BIG] - peaks[POP]
    log(f"population memory: one 4-wave round's peak above the server "
        f"weights, {peaks[POP]!r} MB at population {POP} and "
        f"{peaks[POP_BIG]!r} MB at {POP_BIG} (same cohort {COHORT}); "
        f"{card}")
    if grown > max(0.01 * peaks[POP], 16.0):
        raise SystemExit(f"population memory grew {grown} MB with the "
                         f"population")

    _, _, server, fns = population_round_fns(torch)
    r = {"i": 0}

    def call(name):
        def go():
            r["i"] += 1
            fns[name](server, None, None, None, (1, r["i"], 0),
                      round_idx=r["i"])
        return go

    names = ["1 wave", "4 waves", "async"]
    ms = {k: [] for k in names}
    for k in names + names[::-1]:
        ms[k].append(host_ms(torch, call(k), n=2, warmup=1))
    for k in names:
        log(f"time population round ({k}, VGG16 50x50, {COHORT} clients x "
            f"1 step of {POP_EXAMPLES}, every layer training, population "
            f"{POP}): host {ms[k]!r} ms a round (in turns, a synchronize "
            f"ends each); peak memory {peak_mb(torch, call(k))!r} MB above "
            f"the server weights; TF32 off; {profiled(torch, call(k), n=2)};"
            f" {card}")


# ---------------------------------------------------------------------------
# (i) observe and stream: profile, stats, --trace-out, --profile-dir,
# the PNG loaders under --stream, --central-storage
# ---------------------------------------------------------------------------

# the frozen key sets of the JAX package's profile records
# (tests/test_observability.py, test_profile_program_jsonl_schema_frozen
# and test_profile_step_jsonl_schema_frozen)
PROFILE_PROGRAM_KEYS = frozenset({
    "ts", "event", "program", "flops", "bytes_accessed",
    "arithmetic_intensity", "argument_bytes", "output_bytes", "temp_bytes",
    "peak_hbm_bytes", "generated_code_bytes", "available", "step_ms",
    "verdict", "achieved_tflops", "achieved_hbm_gbps", "mfu",
    "hbm_utilization", "bound_fraction", "ridge_intensity", "peak_tflops",
    "peak_hbm_gbps", "device_kind"})
PROFILE_STEP_KEYS = frozenset({
    "ts", "event", "loop", "steps", "wall_ms", "device_ms", "host_gap_ms",
    "device_busy_fraction", "host_gap_fraction", "step_ms_mean"})
PROFILE_STEPS = 8
PROFILE_MODELS = (("vgg", []), ("mobile", ["--depthwise-impl", "fused"]),
                  ("dense", []), ("lm", []))
# the PNG tree of the streamed phase: 50x50 patches, half of each label
STREAM_FILES = 512


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG, written with zlib and struct alone (the card's
    machine may have no image library to write one)."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png_tree(root: Path, n: int, size: int = 50, seed: int = 0):
    """`n` random `size`x`size` patches under root/{0,1}/; returns the
    root."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        d = root / str(i % 2)
        d.mkdir(parents=True, exist_ok=True)
        (d / f"p{i:04d}.png").write_bytes(png_bytes(
            rng.integers(0, 256, (size, size, 3), np.uint8)))
    return root


def jsonl(path: Path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def profile_models(torch, fc, smk, fbk, card: str, tmp: Path) -> None:
    """(i1) `profile` on VGG16, MobileNetV2 (fused), DenseNet201 at their
    bench batches in bf16, and on the LM (f32, plain block): frozen key
    sets, the card's name, MFU in (0, 1], a verdict, a host-wait share
    in [0, 1] (`device_busy_fraction`: the share of the fenced steps the
    host spent blocked on the card, a floor on its busy share), the
    record's FLOPs and bytes equal to the op count of the verb's counted
    call (`program_report`, watched as the verb calls it) plus, for the
    fused mobile, exactly the kernel's analytic account; the kernel's
    launches, no compile."""
    from idc_models_tpu_torch import cli
    from idc_models_tpu_torch.configs import BENCH_TRAIN_CONFIGS
    from idc_models_tpu_torch.models import mobilenet
    from idc_models_tpu_torch.observe import profile as prof

    kind = torch.cuda.get_device_name(0)
    counted = []
    program_report = prof.program_report

    def watched(*args, **kw):
        cost, out = program_report(*args, **kw)
        counted.append(cost)
        return cost, out

    for model, extra in PROFILE_MODELS:
        out = tmp / f"profile_{model}.jsonl"
        zero_counts(fc, smk, fbk)
        counted.clear()
        prof.program_report = watched
        t0 = time.perf_counter()
        try:
            rc = cli.main(["profile", "--model", model, "--steps",
                           str(PROFILE_STEPS), "--out", str(out)] + extra)
        finally:
            prof.program_report = program_report
        seconds = time.perf_counter() - t0
        launches = {"fused": fc.KERNEL.launches,
                    "masking": smk.KERNEL.launches,
                    "flash": sum(flash_counts(fbk))}
        recs = jsonl(out)
        progs = [r for r in recs if r["event"] == "profile_program"]
        steps = [r for r in recs if r["event"] == "profile_step"]
        snap = [r for r in recs if r["event"] == "metrics_snapshot"][-1]
        if rc != 0 or len(progs) != 1 or len(steps) != 1:
            raise SystemExit(f"profile {model}: rc {rc}, records "
                             f"{[r['event'] for r in recs]}")
        prog, step = progs[0], steps[0]
        if set(prog) != PROFILE_PROGRAM_KEYS or set(step) != PROFILE_STEP_KEYS:
            raise SystemExit(f"profile {model}: keys {sorted(prog)} / "
                             f"{sorted(step)} differ from the frozen sets")
        compiles = sum(m["value"] for m in snap["metrics"]
                       if m["name"] == "compiles_total")
        checks = {"device_kind": prog["device_kind"] == kind,
                  "mfu": prog["mfu"] is not None and 0 < prog["mfu"] <= 1,
                  "verdict": prog["verdict"] != "unknown",
                  "host_wait": 0 <= step["device_busy_fraction"] <= 1,
                  "compiles": compiles == 0,
                  "one_counted_call": len(counted) == 1}
        k_flops = k_bytes = 0.0
        calls = 2 + 2 * PROFILE_STEPS       # two warm-ups, two passes
        if model == "mobile":
            bc = BENCH_TRAIN_CONFIGS["mobilenet_v2"]
            n_fused = mobilenet.fused_chain_count(bc["fine_tune_at"],
                                                  train=True)
            k_flops, k_bytes = fc.depthwise_chain_cost(
                mobilenet.fused_call_shapes(
                    bc["batch_per_chip"], bc["image_size"])[:n_fused],
                itemsize=2)
            want = {"fused": n_fused * calls, "masking": 0, "flash": 0}
        else:
            want = {"fused": 0, "masking": 0, "flash": 0}
        # the record is the counted call's op count, merged with the
        # kernel's account where the step launches it, and nothing else
        ops = counted[0] if counted else None
        checks["kernel_account"] = ops is not None and (
            prog["flops"] == ops.flops + k_flops
            and prog["bytes_accessed"] == ops.bytes_accessed + k_bytes)
        checks["launches"] = launches == want
        if model == "lm":
            batch, unit = 8, "sequences of 512 tokens"
        else:
            name = {"vgg": "vgg16", "mobile": "mobilenet_v2",
                    "dense": "densenet201"}[model]
            batch, unit = BENCH_TRAIN_CONFIGS[name]["batch_per_chip"], "patches"
        log(f"profile {model} {' '.join(extra)}: {prog['step_ms']!r} ms a "
            f"step, {batch / prog['step_ms'] * 1e3!r} {unit} a second, MFU "
            f"{prog['mfu']!r}, HBM utilisation {prog['hbm_utilization']!r}, "
            f"{prog['verdict']} ({prog['flops']!r} FLOP, "
            f"{prog['bytes_accessed']!r} bytes, intensity "
            f"{prog['arithmetic_intensity']!r}), peak memory "
            f"{prog['peak_hbm_bytes']!r} bytes (arguments "
            f"{prog['argument_bytes']!r}), op count "
            f"{ops.flops if ops else None!r} FLOP, "
            f"{ops.bytes_accessed if ops else None!r} bytes + kernel "
            f"account {k_flops!r} FLOP, {k_bytes!r} bytes; host-wait share "
            f"{step['device_busy_fraction']!r} of the fenced steps; "
            f"launches {launches} (want {want}); {compiles} compiles; verb "
            f"{seconds!r} s; {card}")
        if not all(checks.values()):
            raise SystemExit(f"profile {model}: failed checks "
                             f"{[k for k, v in checks.items() if not v]}")

    out = tmp / "profile_drill.jsonl"
    rc = cli.main(["profile", "--model", "small", "--steps", "2",
                   "--churn-drill", "--out", str(out)])
    snap = [r for r in jsonl(out) if r["event"] == "metrics_snapshot"][-1]
    flagged = [m for m in snap["metrics"]
               if m["name"] == "compile_churn_flagged_total"
               and m["labels"].get("program") == "churn.drill"]
    log(f"profile churn drill: compile_churn_flagged_total "
        f"{[(m['labels'], m['value']) for m in flagged]}")
    if rc != 0 or not flagged or flagged[0]["value"] < 1:
        raise SystemExit("profile --churn-drill: the watchdog did not flag "
                         "churn.drill")


def traced_runs(torch, fc, smk, fbk, card: str, tmp: Path) -> None:
    """(i3) --trace-out on the `mobile` argv of (a) and the `fed` argv of
    (g): the Chrome JSON loads and holds the loops' spans; `stats --json`
    on run.jsonl carries the metrics snapshot. The `fed` run also takes
    --profile-dir, which arms program accounting: its snapshot holds the
    fed.round account. (i4) --profile-dir on the same `mobile` argv: the
    trace holds one fused_depthwise kernel event per launch made while
    it was armed, and the snapshot the train.step account (fit's first
    step, counted; the kernel's work is not in it) with its peak
    memory."""
    import contextlib
    import io

    from idc_models_tpu_torch import cli
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data.idc import ArrayDataset, train_val_test_split
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.observe import profile as prof

    mobile = ["mobile", "--depthwise-impl", "fused", "--synthetic-examples",
              str(CLS_EXAMPLES), "--epochs", "1", "--fine-tune-epochs", "1",
              "--seed", "0"]
    fed = ["fed", "--synthetic-examples", str(FED_EXAMPLES),
           "--pretrain-epochs", "1", "--seed", "0", "--rounds",
           str(FED_ROUNDS)]
    fed_prof = ["--profile-dir", str(tmp / "profile_fed")]
    prof.PROGRAMS.pop("fed.round", None)
    for argv, want in ((mobile, {"train.epoch", "train.step",
                                 "device.sync", "train.eval"}),
                       (fed + fed_prof, {"fed.round", "fed.client",
                                         "device.sync"})):
        run = tmp / f"trace_{argv[0]}"
        trace_json = tmp / f"trace_{argv[0]}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(argv + ["--path", str(run), "--trace-out",
                                  str(trace_json)])
        events = json.loads(trace_json.read_text())["traceEvents"]
        names = {e.get("name") for e in events}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["stats", str(run / "logs" / "run.jsonl"), "--json"])
        summary = json.loads(buf.getvalue())
        log(f"--trace-out on {argv[0]}: {len(events)} trace events, "
            f"{sorted(want & names)} of {sorted(want)}; stats --json: "
            f"{summary['records']} records, events "
            f"{sorted(summary['events'])}, {len(summary['metrics'])} "
            f"metrics in the snapshot")
        if rc != 0 or not want <= names or not summary["metrics"] or (
                "metrics_snapshot" not in summary["events"]):
            raise SystemExit(f"--trace-out on {argv[0]}: spans "
                             f"{sorted(names)[:40]}, summary {summary}")
    program_account(run, "fed.round", card)

    # (i4): the profiler window is two_phase_fit; the test evaluation
    # after it launches 17 chains a test batch outside the window
    prof_dir = tmp / "profile_dir"
    run = tmp / "profile_dir_run"
    prof.PROGRAMS.pop("train.step", None)    # filed by (i1)
    zero_counts(fc, smk, fbk)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(mobile + ["--profile-dir", str(prof_dir), "--path",
                                str(run)])
    preset = get_preset("mobile")
    imgs, labels = synthetic.make_idc_like(CLS_EXAMPLES, preset.image_size,
                                           seed=0)
    _, _, test = train_val_test_split(ArrayDataset(imgs, labels), seed=0)
    outside = 17 * -(-len(test) // preset.batch_size)
    inside = fc.KERNEL.launches - outside
    events = json.loads((prof_dir / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    ours = [e for e in kernels if "fused_depthwise" in e.get("name", "")]
    log(f"--profile-dir on mobile --depthwise-impl fused: the trace holds "
        f"{len(ours)} fused_depthwise kernel events of {len(kernels)} "
        f"kernel events; the launch counter made {inside} launches inside "
        f"the window ({fc.KERNEL.launches} in all, {outside} in the test "
        f"evaluation after it); {card}")
    if rc != 0 or len(ours) != inside:
        raise SystemExit(f"--profile-dir: {len(ours)} fused_depthwise "
                         f"events against {inside} launches")
    program_account(run, "train.step", card)


def program_account(run: Path, program: str, card: str) -> None:
    """The account a --profile-dir run filed for `program` (cleared from
    the program table before the run): in the table, with FLOPs, bytes
    and a peak memory above zero (the memory is measured on the card
    only), and the same numbers in the run log's metrics snapshot."""
    from idc_models_tpu_torch.observe import profile as prof

    cost = prof.registered_programs().get(program)
    snap = [r for r in jsonl(run / "logs" / "run.jsonl")
            if r["event"] == "metrics_snapshot"][-1]
    got = {m["name"]: m["value"] for m in snap["metrics"]
           if m["name"].startswith("program_")
           and m["labels"] == {"program": program}}
    log(f"--profile-dir account of {program}: {got}; {card}")
    want = (None if cost is None else
            {"program_flops": cost.flops,
             "program_bytes_accessed": cost.bytes_accessed,
             "program_peak_hbm_bytes": cost.peak_hbm_bytes})
    if want is None or got != want or not all(
            v is not None and v > 0 for v in want.values()):
        raise SystemExit(f"--profile-dir: the {program} account "
                         f"{want} against the metrics snapshot's {got}")


def stream_run(torch, fc, smk, fbk, card: str, tmp: Path) -> None:
    """(i5) `mobile --depthwise-impl fused --data-dir <PNG tree> --stream
    --decode-workers 2` against two_phase_fit on the same file-level
    split decoded up front (the backend `auto` picks, native or PIL):
    equal histories, equal launches (cuDNN deterministic, TF32 off)."""
    import contextlib
    import io

    from idc_models_tpu_torch import cli
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data import native
    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, decode_pairs, list_shuffled_pairs,
    )
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.train.loop import TwoPhaseConfig, two_phase_fit

    preset = get_preset("mobile")
    tree = write_png_tree(tmp / "pngs", STREAM_FILES)
    backend = "native" if native.available() else "pil"
    log(f"stream: {STREAM_FILES} 50x50 PNG patches written; decode backend "
        f"{backend} (native loader: {native.build_error() or 'built'})")
    torch.backends.cudnn.deterministic = True
    run = tmp / "stream"
    zero_counts(fc, smk, fbk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["mobile", "--depthwise-impl", "fused", "--data-dir",
                       str(tree), "--stream", "--decode-workers", "2",
                       "--epochs", "1", "--fine-tune-epochs", "1", "--seed",
                       "0", "--path", str(run)])
    streamed_s = time.perf_counter() - t0
    streamed_launches = fc.KERNEL.launches
    streamed = [r for r in jsonl(run / "logs" / "run.jsonl")
                if r["event"] == "epoch"]

    pairs = list_shuffled_pairs(tree, seed=0)
    n_tr, n_va = int(0.8 * len(pairs)), int(0.1 * len(pairs))

    def materialize(subset):
        return ArrayDataset(decode_pairs(subset, 50, backend=backend),
                            np.asarray([l for _, l in subset], np.int32))

    zero_counts(fc, smk, fbk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        result = two_phase_fit(
            preset.model, 1, materialize(pairs[:n_tr]),
            materialize(pairs[n_tr:n_tr + n_va]),
            TwoPhaseConfig(lr=preset.lr, epochs=1, fine_tune_epochs=1,
                           batch_size=preset.batch_size,
                           fine_tune_at=preset.fine_tune_at, seed=0),
            build_kwargs=registry.FUSED_BUILD_KWARGS[preset.model],
            device="cuda")
    mat_s = time.perf_counter() - t0
    # two_phase_fit alone: the streamed run's test evaluation adds 17
    # chains a test batch
    n_test = len(pairs) - n_tr - n_va
    test_launches = 17 * -(-n_test // preset.batch_size)
    materialized = result.history["loss"] + result.history_fine["loss"]
    got = [r["loss"] for r in streamed]
    torch.backends.cudnn.deterministic = False
    log(f"stream: --stream --decode-workers 2 epoch losses {got!r} in "
        f"{streamed_s!r} s against the materialized split's "
        f"{materialized!r} in {mat_s!r} s; fused launches "
        f"{streamed_launches} (test evaluation {test_launches}) against "
        f"{fc.KERNEL.launches}; {card}")
    if (rc != 0 or got != materialized
            or streamed_launches - test_launches != fc.KERNEL.launches):
        raise SystemExit("--stream: the streamed run differs from the "
                         "materialized one")


def central_storage_run(torch, fc, smk, fbk, card: str) -> None:
    """(i6) `vgg --central-storage` against the mirrored `vgg`, TF32 off
    and cuDNN deterministic (its weight gradients otherwise sum in a
    varying order, which RMSprop's first steps amplify past the bar):
    histories within rtol 1e-4."""
    tf32_off(torch)
    torch.backends.cudnn.deterministic = True
    argv = ["vgg", "--synthetic-examples", str(CLS_EXAMPLES), "--epochs",
            "1", "--fine-tune-epochs", "1", "--seed", "0"]
    mirrored = classifier_run(torch, fc, smk, fbk, argv)
    central = classifier_run(torch, fc, smk, fbk,
                             argv + ["--central-storage"])
    torch.backends.cudnn.deterministic = False
    rel = same_history("vgg --central-storage", central["epochs"],
                       mirrored["epochs"])
    log(f"central storage: vgg in {central['seconds']!r} s against "
        f"mirrored {mirrored['seconds']!r} s; epochs (loss, val_loss) "
        f"{[(r['loss'], r['val_loss']) for r in central['epochs']]} against "
        f"{[(r['loss'], r['val_loss']) for r in mirrored['epochs']]} "
        f"(largest relative difference {rel!r}, bar 1e-4); {card}")


# ---------------------------------------------------------------------------
# phase (j): the distribution layer on a world of one card (`dist`)
# ---------------------------------------------------------------------------

# host-ms steps a cost sample (in turns), LM plan-path steps held against
# the plain path's
DIST_STEPS, DIST_LM_STEPS = 10, 3
# the plan path's LM losses against the plain path's, relative: the
# vocab-parallel cross-entropy sums its terms in another order
DIST_LM_RTOL = 1e-5
# a rerun against the first run (epoch and step losses), relative: the
# embedding's and cuDNN's backward add in an order that may change
# between two runs on the card
DIST_RERUN_RTOL = 1e-4


def dist_models(torch):
    """The `vgg` b32 phase-2 step and the `lm` step (pallas, T=16,384,
    batch 1) as the verbs build them: `make` returns ``(vgg(mesh),
    lm_plain(mesh), lm_plan())`` step callables, each on fresh weights
    from seed 0; the plan path is the LM over an fsdp 1 x tp 1 x seq 1
    mesh under LM_RULES (FSDP gathers, TP splits, vocab-parallel loss,
    each a no-op at one rank)."""
    from idc_models_tpu_torch import mesh as meshlib
    from idc_models_tpu_torch.models import core, registry
    from idc_models_tpu_torch.models.lm import (
        AttentionLM, make_lm_train_step, next_token_loss,
    )
    from idc_models_tpu_torch.train import losses
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(32, 50, 50, 3, device="cuda", generator=gen)
    y = torch.randint(0, 2, (32,), device="cuda", generator=gen)
    rng = np.random.default_rng(1)
    seqs = torch.as_tensor((rng.integers(0, LM["vocab"], (1, 1))
                            + np.arange(LM_T)) % LM["vocab"]).cuda()
    dims = {k: LM[k] for k in ("embed_dim", "num_heads", "mlp_dim",
                               "num_blocks")}

    def vgg(mesh):
        spec = registry.get_model("vgg16")
        model = core.init_params(spec.build(1), 0).cuda()
        step = make_train_step(TrainState(model, rmsprop(
            model, 1e-4, trainable_mask=spec.fine_tune_mask(model, 15))),
            losses.binary_cross_entropy, mesh=mesh)
        return lambda: step(x, y)

    def lm_plain(mesh):
        model = core.init_params(AttentionLM(
            LM["vocab"], LM_T, block_impl="pallas", **dims), 0).cuda()
        step = make_train_step(TrainState(model, rmsprop(model, 3e-3)),
                               next_token_loss, mesh=mesh)
        return lambda: step(seqs, seqs)

    def lm_plan():
        model = core.init_params(AttentionLM(
            LM["vocab"], LM_T, block_impl="pallas",
            mesh=meshlib.fsdp_tp_mesh(1, 1, 1), **dims), 0).cuda()
        model.shard_(registry.LM_RULES)
        step = make_lm_train_step(TrainState(model, rmsprop(model, 3e-3)),
                                  global_batch=1)
        return lambda: step(seqs, seqs)

    return vgg, lm_plain, lm_plan


def dist_cost(torch, calls: dict) -> dict:
    """Host ms a step of each call, in turns forward then back."""
    names = list(calls)
    ms = {k: [] for k in names}
    for k in names + names[::-1]:
        ms[k].append(host_ms(torch, calls[k], n=DIST_STEPS, warmup=2))
    return ms


def dist_path(torch, fc, smk, fbk, mobile: dict, lm: dict, att: dict,
              card: str) -> dict:
    """(j) the distribution layer on one card. Without a process group:
    the cost samples, and the LM's plan path (LM_RULES over a one-rank
    mesh) held against the plain path. Then a 1-rank NCCL group through
    a file:// rendezvous, checked to be NCCL and to all-reduce on the
    card, and on it the verbs: `mobile --depthwise-impl fused`
    data-parallel (its launches as the un-meshed run's, its epochs
    within DIST_RERUN_RTOL), `lm --fsdp 1 --tp 1 --seq-parallel 1` at the
    bench width (launches and losses against `lm_path`'s; at one rank
    the verb runs the plain LM), `attention --seq-parallel 1` (against
    the contiguous run); the LM's plan path built on the group, its
    losses against the plain path's; and the same cost samples with the
    group. The group is taken down at the end."""
    import torch.distributed as dist

    from idc_models_tpu_torch import collectives
    from idc_models_tpu_torch import mesh as meshlib
    from idc_models_tpu_torch.models import mobilenet

    t0 = time.perf_counter()
    tf32_off(torch)
    vgg, lm_plain, lm_plan = dist_models(torch)
    plain, plan = lm_plain(None), lm_plan()
    losses = {}
    for name, call in (("plain", plain), ("plan", plan)):
        losses[name] = [float(call()["loss"]) for _ in range(DIST_LM_STEPS)]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["plan"],
                                                 losses["plain"])]
    log(f"dist: lm step losses, plan path (LM_RULES on a 1-rank fsdp x tp x "
        f"seq mesh, vocab-parallel loss) {losses['plan']!r} against the "
        f"plain path {losses['plain']!r}: relative {rel!r} (bar "
        f"{DIST_LM_RTOL}); {card}")
    if not all(r <= DIST_LM_RTOL for r in rel):
        raise SystemExit("the LM's plan path left the plain path's losses")
    alone = dist_cost(torch, {"vgg": vgg(None), "lm plain": lm_plain(None),
                              "lm plan": plan})
    del plain, plan
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        meshlib.initialize_multihost(f"file://{tmp}/store", 1, 0)
        try:
            backend = dist.get_backend()
            probe = torch.full((4,), 2.0, device="cuda")
            dist.all_reduce(probe)
            log(f"dist: a 1-rank group, backend {backend}, all-reduce of "
                f"2.0 on the card gives {probe.tolist()}")
            if backend != "nccl" or probe.tolist() != [2.0] * 4:
                raise SystemExit(f"the 1-rank group is {backend}, "
                                 f"all-reduce {probe.tolist()}")
            if not collectives.initialized():
                raise SystemExit("the port does not see the group")
            grouped = main_path(torch, fc, mobilenet, card)
            rel = same_history("dist mobile", grouped["epochs"],
                               mobile["epochs"], DIST_RERUN_RTOL)
            log(f"dist: mobile data-parallel on the group: {grouped['launches']} "
                f"fused launches (un-meshed run {mobile['launches']}); "
                f"epochs within {rel!r} of the un-meshed run's (bar "
                f"{DIST_RERUN_RTOL}); {card}")
            if grouped["launches"] != mobile["launches"]:
                raise SystemExit("dist mobile launches differ")
            lm_launches = dist_lm(torch, fc, smk, fbk, lm, card)
            run = attention_run(torch, fc, smk, fbk, "contiguous",
                                ["--seq-parallel", "1"])
            base = att["runs"]["contiguous"]
            rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                         base["losses"])]
            log(f"dist: attention --seq-parallel 1 on the group: launches "
                f"{run['launches']} (first run {base['launches']}), losses "
                f"{run['losses']!r} against {base['losses']!r}: relative "
                f"{rel!r} (bar {DIST_RERUN_RTOL}); {card}")
            if (run["launches"] != base["launches"]
                    or not all(r <= DIST_RERUN_RTOL for r in rel)):
                raise SystemExit("dist attention left the first run")
            plan = lm_plan()
            got = [float(plan()["loss"]) for _ in range(DIST_LM_STEPS)]
            rel = [abs(a - b) / abs(b) for a, b in zip(got, losses["plain"])]
            log(f"dist: lm step losses, plan path built on the group "
                f"{got!r} against the plain path without it "
                f"{losses['plain']!r}: relative {rel!r} (bar "
                f"{DIST_LM_RTOL}); {card}")
            if not all(r <= DIST_LM_RTOL for r in rel):
                raise SystemExit("the LM's plan path on the group left the "
                                 "plain path's losses")
            grid = meshlib.data_mesh()
            with_group = dist_cost(torch, {
                "vgg": vgg(grid), "lm plain": lm_plain(grid),
                "lm plan": plan})
        finally:
            dist.destroy_process_group()
    for k in alone:
        log(f"time dist {k} step (vgg: b32 phase-2 50x50 f32; lm: "
            f"T={LM_T} batch 1 pallas f32): host ms without a process "
            f"group {alone[k]!r}, with a 1-rank NCCL group {with_group[k]!r} "
            f"(each in turns); TF32 off; {card}")
    log(f"phase (j) dist took {time.perf_counter() - t0!r} s")
    return {"mobile": grouped["launches"], "lm": lm_launches,
            "attention": run["launches"]}


def dist_lm(torch, fc, smk, fbk, lm: dict, card: str) -> tuple:
    """`lm --fsdp 1 --tp 1 --seq-parallel 1` with lm_path's flags on the
    group: the same flash launches (returned), losses within
    DIST_RERUN_RTOL."""
    import contextlib
    import io

    from idc_models_tpu_torch import cli

    with tempfile.TemporaryDirectory() as tmp:
        argv = [*lm["argv"], "--fsdp", "1", "--tp", "1", "--seq-parallel",
                "1", "--path", tmp]
        out = io.StringIO()
        zero_counts(fc, smk, fbk)
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        launches = flash_counts(fbk)
        records = jsonl(Path(tmp) / "logs" / "run.jsonl")
    if rc != 0:
        raise SystemExit(f"dist lm returned {rc}")
    got = [r["loss"] for r in records if r["event"] == "step"]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, lm["losses"])]
    log(f"dist: lm --fsdp 1 --tp 1 --seq-parallel 1 on the group: flash "
        f"launches {launches} (lm path {lm['launches']} each), losses "
        f"{got!r} against {lm['losses']!r}: relative {rel!r} (bar "
        f"{DIST_RERUN_RTOL}); {card}")
    if (launches != (lm["launches"],) * 3 or len(got) != len(lm["losses"])
            or not all(r <= DIST_RERUN_RTOL for r in rel)):
        raise SystemExit("dist lm left lm_path")
    return launches


def observe_path(torch, fc, smk, fbk, card: str) -> None:
    """(i) observe and stream."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        profile_models(torch, fc, smk, fbk, card, tmp)
        traced_runs(torch, fc, smk, fbk, card, tmp)
        stream_run(torch, fc, smk, fbk, card, tmp)
    central_storage_run(torch, fc, smk, fbk, card)
    log(f"phase (i) took {time.perf_counter() - t0!r} s")


def main() -> int:
    if not (REPO / "idc_models_tpu_torch" / "ops" / "csrc").is_dir():
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         "repository: idc_models_tpu_torch/ is missing")
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; "
                         "torch.cuda.is_available() is False")
    card = card_line()
    log(f"device: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.device_count()} card(s)")

    from idc_models_tpu_torch import ring_attention as tring
    from idc_models_tpu_torch.models import mobilenet
    from idc_models_tpu_torch.ops import build
    from idc_models_tpu_torch.ops import flash_block_kernel as fbk
    from idc_models_tpu_torch.ops import fused_conv as fc
    from idc_models_tpu_torch.ops import secure_masking_kernel as smk

    kernels = [fc.KERNEL, smk.KERNEL, *fbk.KERNELS]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"build: {[k.source.relative_to(REPO).as_posix() for k in kernels]} "
        f"for sm_90a in {time.perf_counter() - t0!r} s")
    for k in kernels:
        regs = [line.strip() for line in k.build_log.splitlines()
                if "registers" in line or "spill" in line]
        log(f"build: {k.name} ptxas {regs}")
    # the depthwise kernel holds its weights and window, and the
    # tensor-core flash kernels their tiles and carries, in registers: a
    # spill would put them in local memory
    for k in (fc.KERNEL, *fbk.KERNELS):
        spills = [line.strip() for line in k.build_log.splitlines()
                  if "spill" in line
                  and "0 bytes spill stores, 0 bytes spill loads" not in line]
        if spills:
            raise SystemExit(f"ptxas spills registers in {k.name}: {spills}")
    log("build: no register spills in fused_depthwise, flash_block_fwd, "
        "flash_block_dq and flash_block_dkv")
    clock_hz = sm_clock_hz()

    flash_worst = flash_parity(torch, fbk)
    ring_on_card(torch, tring)
    backward_memory(torch, tring)
    lm = lm_path(torch, fc, smk, fbk, card)
    serving(torch, fc, smk, fbk, card)
    served = serve_path(torch, fc, smk, fbk, card)
    att = attention_path(torch, fc, smk, fbk, tring, card)

    worst = parity(torch, fc, mobilenet)
    mask_worst = masking_parity(torch, smk)
    path = main_path(torch, fc, mobilenet, card)
    mobile_cache_path(torch, fc, smk, fbk, path, card)
    dist = dist_path(torch, fc, smk, fbk, path, lm, att, card)
    vgg_path(torch, fc, smk, fbk, card)
    dense_path(torch, fc, smk, fbk, card)
    fed_path(torch, fc, smk, fbk, card)
    population_path(torch, fc, smk, fbk, card)
    observe_path(torch, fc, smk, fbk, card)
    secure = secure_path(torch, fc, smk, card)
    aggregate_three_ways(torch, smk)
    mobilenet_round(torch, fc, smk, card)
    t32 = kernel_times(torch, fc, mobilenet, BATCH, card)
    wrapper_pieces(torch, fc, card)
    t4096 = kernel_times(torch, fc, mobilenet, BENCH_BATCH, card)
    kernel_times(torch, fc, mobilenet, BENCH_BATCH, card, torch.bfloat16)
    log(f"time b{BENCH_BATCH} f32: the 17 calls take {t4096['ms']!r} ms on "
        f"the device against cuDNN's conv-only {t4096['library_ms']!r} ms "
        f"and the byte bound {t4096['bound_ms']!r} ms; {card}")
    masks = masking_times(torch, smk, clock_hz, card)
    step_times(torch, card)
    classifier_step_times(torch, card)
    secure_round_times(torch, card)
    flash = flash_times(torch, fbk, card)
    lm_step_times(torch, card)
    attention_step_times(torch, card)
    emulated_ring_times(torch, fbk, tring, card)
    quarters = quarter_times(torch, fbk, card)

    # the masking kernel's row is at the main path's buffer: the small
    # CNN's 1,920 protected elements, 8 clients
    m = masks[1_920]
    log(json.dumps({"kernels": [{
        "name": "fused_depthwise_bn_relu6",
        "route": "cuda",
        "source": fc.KERNEL.source.relative_to(REPO).as_posix(),
        "replaces": "idc_models_tpu/ops/fused_conv.py:122",
        "launches": path["launches"],
        "max_abs_err": worst,
        "ms": t32["ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": ("bytes" if t32["bytes"] / PEAK_BYTES_PER_S
                     >= t32["flops"] / PEAK_F32_FLOP_PER_S else "operations"),
        "library_ms": t32["library_ms"],
        # phase (j): the data-parallel `mobile` run on a 1-rank group
        "launches_dist": dist["mobile"],
        "device_us_per_launch": t32["device_us_per_launch"],
        "host_us_per_call": t32["host_us"],
    }, {
        "name": "secure_masked_quantize",
        "route": "cuda",
        "source": smk.KERNEL.source.relative_to(REPO).as_posix(),
        "replaces": "idc_models_tpu/ops/secure_masking_kernel.py:92",
        "launches": secure["launches"],
        "max_abs_err": mask_worst,
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
        "bound_ms": m["bound_ms"],
        "bound_by": m["bound_by"],
        "library_ms": None,
        "threefry_ms": m["threefry_ms"],
    }] + [{
        "name": FLASH_NAMES[key],
        "route": "cuda",
        "source": kern.source.relative_to(REPO).as_posix(),
        "replaces": FLASH_REPLACES[key],
        "launches": lm["launches"],
        "max_abs_err": flash_worst[key],
        "ms": flash[key]["ms"],
        "plain_ms": flash[key]["plain_ms"],
        "bound_ms": flash[key]["bound_ms"],
        "bound_by": flash[key]["bound_by"],
        "library_ms": flash[key]["library_ms"],
        # phase 10: the `attention` runs' launches (i: this kernel's
        # place in (update, dq, dk/dv)); the 4-rank quarter grid's worst
        # error (quarters of 256); and at the path's own quarters (8192
        # x 8192) the error, the device ms and the bound
        "launches_attention": {name: run["launches"][i] for name, run
                               in att["runs"].items()},
        # phase (j): `lm --fsdp 1 --tp 1 --seq-parallel 1` and
        # `attention --seq-parallel 1` on a 1-rank group
        "launches_dist": {"lm": dist["lm"][i],
                          "attention": dist["attention"][i]},
        # phase 12: the serve runs (k1)-(k5)
        "launches_serve": {run: counts[i] for run, counts in served.items()},
        "max_abs_err_zigzag_grid_256": att["grid"][key],
        **{f"quarter_{field}": {what: quarters[(what, key)][field]
                                for what in QUARTERS}
           for field in ("max_abs_err", "ms", "bound_ms")},
    } for i, (key, kern) in enumerate(zip(("fwd", "dq", "dkv"),
                                          fbk.KERNELS))]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
