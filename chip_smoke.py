"""Smoke test of the PyTorch port (idc_models_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an H100 (or another
sm_90a card). Phases, each printing its own lines; any failure exits
non-zero before the result line:

1. device -- require CUDA; print the card's name and power limit;
2. build  -- compile every hand-written kernel from
   idc_models_tpu_torch/ops/csrc/ with nvcc (one process per source, all
   started together);
3. parity -- TF32 off; each kernel against its plain PyTorch version on
   the card, at every shape the main path gives it (f32 and bf16) and on
   the op-level grid of the tests, plus one backward;
4. main path -- `idc_models_tpu_torch.cli.main(["mobile",
   "--depthwise-impl", "fused", ...])`: MobileNetV2 at full width,
   batch 32, lr 1e-4, fine-tune at 100, one epoch per phase on 512
   synthetic 50x50 patches, then `predict` over the test split with the
   trained weights; launch counts held to the count the schedule implies,
   the predictions held against the cuDNN (grouped) build of the same
   weights;
5. times -- CUDA-event times of each kernel, its plain version and the
   nearest library call at the main path's shapes (batch 32) and at the
   benchmark batch (4096), and host-clock times of the train steps;

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
    |kernel - plain| at the main path's shapes."""
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


def main_path(torch, fc, mobilenet, card: str) -> dict:
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
    from idc_models_tpu_torch.train.loop import predict

    preset = get_preset("mobile")
    n_examples, seed = 512, 0
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["mobile", "--depthwise-impl", "fused", "--synthetic-examples",
                str(n_examples), "--epochs", "1", "--fine-tune-epochs", "1",
                "--seed", str(seed), "--path", tmp]
        imgs, labels = synthetic.make_idc_like(n_examples, preset.image_size,
                                               seed=seed)
        train, val, test = train_val_test_split(ArrayDataset(imgs, labels),
                                                seed=seed)
        fc.KERNEL.launches = 0
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
    return {"launches": launches, "steps": steps}


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


def kernel_times(torch, fc, mobilenet, batch: int, card: str) -> dict:
    """Per-call times of the kernel, its plain version and cuDNN's grouped
    conv at the 17 main-path shapes of `batch`, f32, summed over one
    forward; `bound` is the least time the card could take."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    iters = 50 if batch <= BATCH else 10
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "bytes": 0.0, "flops": 0.0}
    for call in mobilenet.fused_call_shapes(batch, SIZE):
        c, s = call["c"], call["stride"]
        x, w, mul, add = fused_inputs(torch, gen, batch, call["h_in"], c,
                                      torch.float32)
        y = fc.fused_depthwise_affine(x, w, mul, add, stride=s)
        # bytes: x read once, y written once, w/mul/add read once
        nbytes = (x.numel() + y.numel()) * 4 + (w.numel() + 2 * c) * 4
        flops = y.numel() * (2 * 9 + 3)
        bound = max(nbytes / PEAK_BYTES_PER_S,
                    flops / PEAK_F32_FLOP_PER_S) * 1e3
        xc = x.permute(0, 3, 1, 2)               # channels_last NCHW view
        wc = w.permute(3, 2, 0, 1).contiguous()  # [C, 1, 3, 3]
        del y
        t = time_ms(torch, lambda: fc.fused_depthwise_affine(
            x, w, mul, add, stride=s), iters)
        p = time_ms(torch, lambda: fc.reference_impl(
            x, w, mul, add, stride=s), max(iters // 5, 2))
        lib = time_ms(torch, lambda: F.conv2d(xc, wc, None, s, 1, 1, c),
                      iters)
        log(f"time b{batch} {call['h_in']}x{call['h_in']}x{c} s{s}: kernel "
            f"{t!r} ms, plain {p!r} ms, cudnn {lib!r} ms, bound {bound!r} ms "
            f"({nbytes} B); {card}")
        for k, v in (("ms", t), ("plain_ms", p), ("library_ms", lib),
                     ("bound_ms", bound), ("bytes", nbytes),
                     ("flops", flops)):
            tot[k] += v
        del x, w, mul, add, xc, wc
        torch.cuda.empty_cache()
    log(f"time b{batch} sum of the 17 calls of one forward: kernel "
        f"{tot['ms']!r} ms, plain {tot['plain_ms']!r} ms, cuDNN "
        f"F.conv2d(groups=C) channels_last (conv only, no affine/clamp: "
        f"the nearest library yardstick) {tot['library_ms']!r} ms, bound "
        f"{tot['bound_ms']!r} ms ({tot['bytes']!r} B at 3.35 TB/s); "
        f"{card}")
    return tot


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


def profiled(torch, fn, n: int = 10) -> str:
    """Where one call's time goes, from torch.profiler over `n` calls:
    device-busy ms (the kernels' summed device time) against wall ms, the
    idle share, the fused kernel's device time per launch, and the five
    kernels with the most device time."""
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
    # counted
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and "#" not in e.key]
    busy = sum(e.self_device_time_total for e in kernels) / n / 1e3
    if busy == 0:
        return f"profiler saw no device time ({wall!r} ms wall per call)"
    fused = [e for e in kernels if "fused_depthwise_kernel" in e.key]
    launches = sum(e.count for e in fused)
    fused_us = sum(e.self_device_time_total for e in fused)
    per_launch = (f"{fused_us / launches!r} us device time per fused "
                  f"launch over {launches} launches" if launches
                  else "no fused launches")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return (f"device busy {busy!r} ms of {wall!r} ms wall per call under "
            f"the profiler (idle share {1 - busy / wall!r}); {per_launch}; "
            f"{sum(e.count for e in kernels) / n!r} kernels per call; top: "
            + "; ".join(f"{e.key[:60]} {e.self_device_time_total / n!r} us"
                        for e in top))


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

    from idc_models_tpu_torch.models import mobilenet
    from idc_models_tpu_torch.ops import build
    from idc_models_tpu_torch.ops import fused_conv as fc

    kernels = [fc.KERNEL]
    t0 = time.perf_counter()
    build.build_all(kernels)
    log(f"build: {[k.source.relative_to(REPO).as_posix() for k in kernels]} "
        f"for sm_90a in {time.perf_counter() - t0!r} s")
    for k in kernels:
        regs = [line.strip() for line in k.build_log.splitlines()
                if "registers" in line]
        log(f"build: {k.name} ptxas {regs}")

    worst = parity(torch, fc, mobilenet)
    path = main_path(torch, fc, mobilenet, card)
    t32 = kernel_times(torch, fc, mobilenet, BATCH, card)
    kernel_times(torch, fc, mobilenet, BENCH_BATCH, card)
    step_times(torch, card)

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
    }]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
