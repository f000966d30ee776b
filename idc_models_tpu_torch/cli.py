"""Command-line entry point: the ``vgg``, ``mobile``, ``dense``, ``fed``,
``secure-fed``, ``lm``, ``attention``, ``serve``, ``profile`` and
``stats`` verbs of ``idc_models_tpu``.

    python -m idc_models_tpu_torch vgg --path runs/vgg \\
        --data-dir .../balanced_IDC_30k --cache-features
    python -m idc_models_tpu_torch mobile --path runs/mobile \\
        --data-dir .../balanced_IDC_30k --depthwise-impl fused
    python -m idc_models_tpu_torch dense --path runs/dense
    python -m idc_models_tpu_torch fed --path runs/fed
    python -m idc_models_tpu_torch secure-fed --path runs/secure \\
        --mask-impl pallas

``vgg``, ``mobile`` and ``dense`` run two-phase transfer learning with
their preset's hyperparameters, every one overridable: VGG16 (batch 32,
lr 1e-3, fine-tune at Keras index 15) and MobileNetV2 (batch 32, lr
1e-4, at 100) on IDC patches, DenseNet201 (batch 256, lr 1e-4, at 150,
sparse CE, the train set twice an epoch) on CIFAR-10. IDC data:
--data-dir (a ``<label>/*.png`` tree) if given, else
``<path>/data/balanced_IDC_30k`` if present, else --synthetic-examples
synthetic patches. CIFAR-10: ``cifar10.npz`` or
``cifar-10-batches-py/`` under --path, else a synthetic stand-in.
``--cache-features`` fine-tunes on the frozen prefix's activations,
computed once (``train/feature_cache.py``). ``--pretrained-weights``
takes the JAX package's npz or a Keras ``.h5``.

``--central-storage`` keeps the train state in host memory between
steps; ``--stream`` decodes the training batches from the ``--data-dir``
tree per batch (``data/pipeline.FileStream``, the native libpng loader
when it builds, else PIL), fanned out to ``--decode-workers`` processes.

``--depthwise-impl fused`` runs MobileNetV2's frozen and eval depthwise
chains through the hand-written CUDA kernel (``ops/fused_conv.py``);
``grouped`` (the default, as in the JAX package) uses cuDNN's grouped
convolution. ``--device`` is ``cuda`` unless ``cpu`` is asked for.

With --path the run writes ``<path>/logs/run.jsonl`` (``epoch``,
``timer`` and ``test`` records) and the trained model as
``<path>/model.npz`` in the JAX package's npz layout
(``{"params": ..., "state": ...}``). ``--resumable`` (needs --path)
checkpoints both phases every ``--checkpoint-every`` epochs under
``<path>/dist_ckpt`` and resumes from there on a restart.

``fed`` runs FedAvg with the ``fed`` preset: VGG16 pretrained on the
pooled data (gated on the checkpoint ``<path>/pretrained/cp.ckpt``), then
10 clients (8 train, 2 test) fine-tuning above Keras index 15 at lr/10
under the self-healing round driver (``federated/driver.py``), with
``--faults`` injection and a robust ``--aggregator``; the server state is
checkpointed to ``<path>/fed_server`` and resumed from it. Each round
prints ``round, train_loss, train_acc, test_loss, test_acc`` and, with
--path, logs ``round`` and ``round_health`` records. ``--population N``
trains N virtual clients instead (``federated/population.py``): no
pretraining, every layer at lr/10, a ``--cohort`` sampled each round and
streamed in ``--cohort-wave`` waves, or the buffered async server with
``--async-buffer K`` (``federated/async_fedavg.py``); each round also
logs a ``fed_cohort`` record.

    python -m idc_models_tpu_torch fed --population 10000 --cohort 32 \\
        --cohort-wave 8 --client-examples 16 --path runs/pop

``secure-fed`` runs secure-aggregation FedAvg with the ``secure_fed``
preset (the small CNN on 10x10 patches, 8 clients, 5 local epochs, half
the weight tensors masked). ``--mask-impl pallas`` masks with the fused
CUDA kernel (``ops/secure_masking_kernel.py``; the choice keeps the JAX
package's name so commands carry over), ``threefry`` (the default) with
threefry streams, ``auto`` picks by size. ``--paillier`` runs the
host-side Paillier parity protocol instead. Each round prints
``round r: train_loss=... test_loss=... acc=... auroc=...`` and, with
--path, logs an ``event=round`` record.

``lm`` trains the causal LM through the ring on the counting task and
generates through the KV-cache decoder; ``attention`` trains the
ring-attention sequence classifier on the synthetic sequence task (or
IDC patches as token sequences, ``--data-dir``) and prints ``val:
loss=... accuracy=... auroc=...``. Both take ``--block-impl pallas``
(the hand-written CUDA flash kernels), ``--layout zigzag`` and
``--remat``; ``attention --seq-parallel N`` splits the sequence over a
ring of N ranks and the batch over the rest, and ``lm --fsdp F --tp T
--seq-parallel S`` shards the LM over a ("data", "model", "seq") mesh
under the rule set ``lm`` (FSDP, Megatron TP, the sequence ring).

    python -m idc_models_tpu_torch attention --seq-len 16384 \\
        --embed-dim 512 --num-heads 8 --mlp-dim 2048 --batch-size 1 \\
        --block-impl pallas --layout zigzag --remat

Every verb takes ``--trace-out t.json`` (a Chrome trace-event export of
the run's spans: ``train.epoch`` / ``train.step`` / ``device.sync``,
``fed.round`` / ``fed.client``, ``lm.prefill`` / ``lm.decode``, every
Timer) and ``--profile-dir d`` (``torch.profiler`` over the training
phase, written to ``d/trace.json``); a run with --path ends its jsonl
with one ``metrics_snapshot`` record.

``serve`` replays a request trace (``--trace``, or synthetic Poisson
arrivals) through the continuous-batching server (``serve/``): an LM at
the given widths, random from --seed or trained --train-steps on the
counting task, decoding in --slots slots, --window tokens a window, f32
caches. It prints ``serving N requests on ...``, ``served: ok=...``,
the TTFT split into queue wait and prefill, and ``serve summary: {...}``;
``--metrics-port`` serves ``/metrics`` and ``/healthz`` for the run.

    python -m idc_models_tpu_torch serve --requests 16 --slots 4 \
        --window 8 --t-max 64 --metrics-port 0

``profile --model vgg|mobile|dense|small|lm`` runs a train step at the
bench batch (``configs.BENCH_TRAIN_CONFIGS``, bf16 for the classifiers)
and prints each program's account, its roofline verdict, the
device-wait vs host-gap split of the measured steps and the
compile-churn watchdog's findings, and writes ``profile_program`` /
``profile_step`` records (``--out`` or ``<path>/logs/profile.jsonl``).
``stats run.jsonl`` summarizes any run log of either package.

Distribution: a verb runs over every rank of the world it was started
into -- ``torchrun`` ranks (one card each, NCCL), or ``--host-devices
N`` gloo ranks on the CPU (``mesh.launch_cpu_pod``; rank 0 prints and
writes the run's files). ``vgg``/``mobile``/``dense`` train
data-parallel (the batch is split over the "data" ranks, BatchNorm takes
the global batch's moments; ``dense`` scales its per-replica batch by
them), and ``--model-parallel N`` stores their parameters and RMSprop
moments channel-sharded over a "model" axis of N ranks (the compute is
not split: each step gathers them whole).

    torchrun --nproc-per-node 4 -m idc_models_tpu_torch lm --fsdp 2 --tp 2
    python -m idc_models_tpu_torch attention --host-devices 4 \
        --seq-parallel 4 --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

from idc_models_tpu_torch.models.core import DEPTHWISE_IMPLS


# the serve verb's flags of later ROADMAP items: (flag, argparse
# keywords, label); `_run_serve` refuses any that differs from its default
_LATER = [
    ("--prefix-cache-mb", dict(type=float, default=0.0), "A9.2"),
    ("--kv-page-size", dict(type=int, default=0), "A9.2"),
    ("--kv-pages", dict(type=int, default=0), "A9.2"),
    ("--kv-decode-reserve", dict(type=int, default=0), "A9.2"),
    ("--spec-decode", dict(action="store_true"), "A9.3"),
    ("--draft-k", dict(type=int, default=8), "A9.3"),
    ("--ngram-order", dict(type=int, default=3), "A9.3"),
    ("--drafter", dict(default="ngram"), "A9.3"),
    ("--draft-ckpt", dict(default=None), "A9.3"),
    ("--serve-faults", dict(default=None), "A9.4"),
    ("--journal", dict(default=None), "A9.4"),
    ("--brownout", dict(action="store_true"), "A9.4"),
    ("--brownout-queue-high", dict(type=int, default=None), "A9.4"),
    ("--brownout-clamp-tokens", dict(type=int, default=8), "A9.4"),
    ("--brownout-dwell-ms", dict(type=float, default=250.0), "A9.4"),
    ("--brownout-clear-ms", dict(type=float, default=1000.0), "A9.4"),
    ("--tenants", dict(default=None), "A9.4"),
    ("--tenant-quota", dict(action="append", default=None), "A9.4"),
    ("--tenant-slo-ttft-ms", dict(action="append", default=None), "A9.4"),
    ("--rollout-adapters", dict(type=int, default=None), "A9.4"),
    ("--save-ckpt", dict(default=None), "A11"),
    ("--rollout", dict(default=None), "A11"),
    ("--canary-fraction", dict(type=float, default=None), "A11"),
    ("--canary-requests", dict(type=int, default=None), "A11"),
    ("--rollout-at", dict(type=float, default=None), "A11"),
    ("--compile-cache", dict(default=None), "A10"),
]


def main(argv: list[str] | None = None) -> int:
    from idc_models_tpu_torch import collectives, mesh
    from idc_models_tpu_torch.observe import tracing

    argv = list(sys.argv[1:] if argv is None else argv)
    ns = _parse(argv)
    if getattr(ns, "host_devices", 0) < 0:
        sys.exit(f"--host-devices {ns.host_devices} must be >= 0 (0: this "
                 f"process alone)")
    if getattr(ns, "host_devices", 0):
        if ns.host_devices > 1 and ns.preset_key in ("fed", "secure_fed"):
            _one_rank_fed(ns.host_devices)
        if ns.preset_key == "serve":
            sys.exit(f"serve --host-devices {ns.host_devices}: serving "
                     f"over several ranks is not ported yet (ROADMAP "
                     f"A9-dist)")
        if ns.host_devices > 1 and not mesh.in_cpu_pod():
            return mesh.launch_cpu_pod(ns.host_devices, argv)
        # the ranks of a CPU pod run on the CPU
        ns.device = "cpu"
    mesh.join_world()
    runner = {"vgg": _run_dist, "mobile": _run_dist, "dense": _run_dist,
              "fed": _run_fed, "secure_fed": _run_secure, "lm": _run_lm,
              "attention": _run_attention, "serve": _run_serve,
              "stats": _run_stats, "profile": _run_profile}[ns.preset_key]
    # --trace-out: one wiring point arms the tracer for every verb; the
    # spans export as Chrome trace-event JSON when the run ends
    writer = collectives.is_writer()
    with tracing(chrome_path=getattr(ns, "trace_out", None) if writer
                 else None):
        runner(ns)
    return 0


def _ranks_line(mesh) -> str:
    """The ' over N ranks (axis=size, ...)' suffix of a device line, for
    a mesh of several ranks."""
    if mesh.size == 1:
        return ""
    axes = ", ".join(f"{a}={n}" for a, n in mesh.shape.items())
    return f" over {mesh.size} ranks ({axes})"


def _one_rank_fed(ranks: int) -> None:
    """The federated verbs run on one rank: the client-axis meshes of
    the rounds wait for ROADMAP A4-client."""
    sys.exit(f"{ranks} ranks: the federated rounds run on one rank so far; "
             f"their client-axis meshes wait for ROADMAP A4-client")


def _run_logger(ns):
    """The run's jsonl logger under --path, on rank 0 only."""
    from idc_models_tpu_torch import collectives

    if ns.path is None or not collectives.is_writer():
        return None
    from idc_models_tpu_torch.observe import JsonlLogger

    return JsonlLogger(Path(ns.path) / "logs" / "run.jsonl")


def _parse(argv):
    p = argparse.ArgumentParser(prog="idc_models_tpu_torch",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="preset_key", required=True)

    def common(sp):
        sp.add_argument("--path", default=None,
                        help="artifact root (<path>/logs/run.jsonl, "
                             "<path>/model.npz)")
        sp.add_argument("--data-dir", default=None,
                        help="directory tree <label>/*.png")
        sp.add_argument("--synthetic-examples", type=int, default=512,
                        help="synthetic dataset size when no real data")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--host-devices", type=int, default=0,
                        help="run as N gloo ranks on the CPU (the TPU-pod "
                             "stand-in for local runs); rank 0 prints and "
                             "writes")
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--lr", type=float, default=None)
        sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        sp.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the training "
                             "phase to <dir>/trace.json (CPU and CUDA "
                             "activities; Perfetto-loadable)")
        sp.add_argument("--trace-out", default=None,
                        help="write a Chrome trace-event JSON of the run's "
                             "spans here (Perfetto / chrome://tracing)")

    for key, model in (("vgg", "VGG16"), ("mobile", "MobileNetV2"),
                       ("dense", "DenseNet201")):
        sp = sub.add_parser(key, help=f"{model} two-phase training")
        common(sp)
        sp.add_argument("--epochs", type=int, default=None)
        sp.add_argument("--fine-tune-epochs", type=int, default=None)
        sp.add_argument("--fine-tune-at", type=int, default=None)
        sp.add_argument("--pretrained-weights", default=None,
                        help="backbone weight artifact: .npz in the JAX "
                             "package's layout, or a Keras .h5")
        sp.add_argument("--repeats", type=int, default=None,
                        help="train-set passes per epoch (the dense "
                             "preset's 2)")
        sp.add_argument("--cache-features", action="store_true",
                        help="fine-tune on cached frozen-backbone "
                             "activations (the prefix runs once instead "
                             "of every step; the same function)")
        sp.add_argument("--resumable", action="store_true",
                        help="checkpoint the training loop under "
                             "<path>/dist_ckpt and resume from there on "
                             "a restart (requires --path)")
        sp.add_argument("--checkpoint-every", type=int, default=1,
                        help="with --resumable: epochs between loop "
                             "checkpoints (the final epoch always saves)")
        sp.add_argument("--central-storage", action="store_true",
                        help="host-resident train state, copied to the "
                             "card and back every step (the reference's "
                             "use_mirror=False CentralStorageStrategy "
                             "toggle)")
        sp.add_argument("--stream", action="store_true",
                        help="decode training batches from disk on the "
                             "fly instead of materializing the train "
                             "split; needs a real --data-dir IDC tree")
        sp.add_argument("--decode-workers", type=int, default=0,
                        help="with --stream: fan batch decoding out to N "
                             "worker processes (whole batches, round "
                             "robin; the same stream bit for bit)")
        sp.add_argument("--model-parallel", type=int, default=1,
                        help="store the weights and RMSprop moments "
                             "channel-sharded over a 'model' mesh axis of "
                             "this size (tp.py; gathered whole for each "
                             "step's compute); data parallelism over the "
                             "remaining ranks")
        if key == "mobile":
            sp.add_argument("--depthwise-impl", default="grouped",
                            choices=DEPTHWISE_IMPLS,
                            help="MobileNetV2's depthwise lowering: "
                                 "'fused' runs the frozen/eval "
                                 "depthwise+BN+relu6 chains through the "
                                 "CUDA kernel")

    sp = sub.add_parser("fed", help="federated averaging (FedAvg)")
    common(sp)
    sp.add_argument("--pretrained-weights", default=None,
                    help="backbone weight artifact for the pretrain "
                         "phase: .npz in the JAX package's layout, or a "
                         "Keras .h5")
    sp.add_argument("--rounds", type=int, default=None)
    sp.add_argument("--iid", dest="iid", action="store_true", default=None)
    sp.add_argument("--noniid", dest="iid", action="store_false")
    sp.add_argument("--num-clients", type=int, default=None)
    sp.add_argument("--local-epochs", type=int, default=None)
    sp.add_argument("--pretrain-epochs", type=int, default=None)
    sp.add_argument("--checkpoint-every", type=int, default=10,
                    help="save the federated server state every N rounds "
                         "(plus once at the end)")
    sp.add_argument("--aggregator", default="mean",
                    choices=("mean", "trimmed_mean", "median",
                             "norm_clip"),
                    help="round-boundary aggregation "
                         "(federated/robust.py): mean = example-weighted "
                         "FedAvg; trimmed_mean/median bound Byzantine "
                         "influence coordinate-wise; norm_clip L2-clips "
                         "each client's update")
    sp.add_argument("--trim", type=int, default=1,
                    help="clients trimmed per side with --aggregator "
                         "trimmed_mean (needs > 2*trim participants)")
    sp.add_argument("--clip-norm", type=float, default=10.0,
                    help="per-client update L2 bound with --aggregator "
                         "norm_clip")
    sp.add_argument("--faults", default=None,
                    help="fault-injection plan (faults.py), e.g. "
                         "'sign_flip:0-2:x1000,crash:5': deterministic "
                         "per-round client faults applied before "
                         "aggregation")
    sp.add_argument("--round-timeout", type=float, default=None,
                    help="per-round wall budget in seconds; a slower "
                         "round is discarded and retried with a "
                         "reseeded client subset (federated/driver.py)")
    sp.add_argument("--max-round-retries", type=int, default=2,
                    help="retries per failed round before the run "
                         "aborts with RoundFailure")
    sp.add_argument("--loss-spike-ratio", type=float, default=10.0,
                    help="divergence detector: a round whose train loss "
                         "exceeds this multiple of the last good round's "
                         "is rolled back (0 disables)")
    sp.add_argument("--population", type=int, default=0,
                    help="population mode: train over N VIRTUAL clients "
                         "(federated/population.py) whose shards derive "
                         "lazily from (seed, id); memory is bounded by "
                         "the wave, not N. 0 = classic materialized "
                         "mode. Skips the pretrain phase; --faults then "
                         "takes the population grammar "
                         "(kind:rounds[:param][@c<id>,...], fractions "
                         "like crash:2:0.1%%)")
    sp.add_argument("--cohort", type=int, default=32,
                    help="clients sampled per round in population mode "
                         "(deterministic per (seed, round))")
    sp.add_argument("--cohort-wave", type=int, default=0,
                    help="streamed-aggregation wave size (must divide "
                         "the cohort; 0 = one wave per cohort). Server "
                         "memory is O(wave), constant in population "
                         "and cohort size")
    sp.add_argument("--weighted-sampling", action="store_true",
                    help="sample cohorts in proportion to each virtual "
                         "client's (seeded) dataset-size weight instead "
                         "of uniformly")
    sp.add_argument("--client-examples", type=int, default=16,
                    help="examples per virtual client shard in "
                         "population mode")
    sp.add_argument("--async-buffer", type=int, default=0,
                    help="population mode: buffered-async FedAvg "
                         "(FedBuff): client completions fill a buffer "
                         "of this size, and each full buffer makes one "
                         "staleness-weighted server update instead of "
                         "a round barrier. 0 = synchronous streamed "
                         "rounds")
    sp.add_argument("--staleness-decay", type=float, default=0.9,
                    help="async mode: per-version weight discount for "
                         "stale updates (weight x decay^staleness), in "
                         "(0, 1]; 1 = no discount")
    sp.add_argument("--model", default=None,
                    choices=("vgg16", "mobilenet_v2", "densenet201",
                             "small_cnn"),
                    help="population mode: override the preset model "
                         "(small_cnn = 10x10 population drills; classic "
                         "mode keeps the preset's backbone)")
    sp.add_argument("--fault-delay-ms", type=float, default=0.0,
                    help="population mode: wall-clock delay per "
                         "straggler staleness unit (lag k completes k x "
                         "this late): arms the sync round's BARRIER "
                         "sleep and the async arrival lag; 0 = "
                         "stale-params-only stragglers (sync) / inert "
                         "stragglers (async)")

    sp = sub.add_parser("secure-fed", aliases=["secure_fed"],
                        help="secure-aggregation FedAvg")
    common(sp)
    sp.add_argument("--rounds", type=int, default=None)
    sp.add_argument("--percent", type=float, default=None)
    sp.add_argument("--num-clients", type=int, default=None)
    sp.add_argument("--local-epochs", type=int, default=None)
    sp.add_argument("--paillier", action="store_true", default=None,
                    help="host-side Paillier parity mode instead of "
                         "pairwise masks")
    sp.add_argument("--mask-impl", default="threefry",
                    choices=("threefry", "pallas", "auto"),
                    help="PRG for the pairwise masks: threefry (default; "
                         "cryptographic), pallas -- in this package the "
                         "fused CUDA hash-PRG kernel -- or auto (the "
                         "kernel on CUDA above "
                         "masking.MASK_PALLAS_MIN_ELEMS protected "
                         "elements)")
    sp.add_argument("--async-buffer", type=int, default=0,
                    help="rejected: buffered-async aggregation cannot "
                         "compose with the pairwise-mask protocol")
    sp = sub.add_parser("lm",
                        help="causal LM through the ring: train next-token "
                             "on the counting task, then generate through "
                             "the KV-cache decoder")
    common(sp)
    sp.add_argument("--vocab", type=int, default=16)
    sp.add_argument("--seq-len", type=int, default=64)
    sp.add_argument("--embed-dim", type=int, default=64)
    sp.add_argument("--num-heads", type=int, default=4)
    sp.add_argument("--mlp-dim", type=int, default=128)
    sp.add_argument("--num-blocks", type=int, default=2)
    sp.add_argument("--steps", type=int, default=200)
    sp.add_argument("--fsdp", type=int, default=0,
                    help="FSDP degree: shard the parameters AND RMSprop "
                         "moments over a 'data' mesh axis of this size "
                         "(partition.py, rule set 'lm'); 0 = off")
    sp.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel degree: shard the attention/MLP/"
                         "head weights over a 'model' mesh axis of this "
                         "size (Megatron orientation); composes with "
                         "--fsdp on a ('data', 'model', 'seq') mesh; "
                         "0 = off")
    sp.add_argument("--seq-parallel", type=int, default=0,
                    help="ring size over the 'seq' mesh axis (0 = the "
                         "largest dividing power of two, capped at 4)")
    sp.add_argument("--layout", choices=("contiguous", "zigzag"),
                    default="contiguous")
    sp.add_argument("--block-impl", choices=("jnp", "pallas"),
                    default="jnp",
                    help="ring block fold: jnp (plain PyTorch) or pallas "
                         "-- in this package the hand-written CUDA flash "
                         "kernels, forward and backward")
    sp.add_argument("--remat", action="store_true")
    sp.add_argument("--dropout", type=float, default=0.0)
    sp.add_argument("--generate", type=int, default=12,
                    help="tokens to generate after training, through the "
                         "KV-cache decoder (0 = skip)")
    sp.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature for --generate (0 = greedy "
                         "argmax, the default)")
    sp.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k most likely tokens "
                         "(0 = no restriction; needs --temperature > 0)")

    sp = sub.add_parser("attention",
                        help="ring-attention transformer classifier over "
                             "sequences: synthetic, or IDC patches as "
                             "token sequences")
    common(sp)
    sp.add_argument("--seq-len", type=int, default=128)
    sp.add_argument("--features", type=int, default=8)
    sp.add_argument("--embed-dim", type=int, default=64)
    sp.add_argument("--num-heads", type=int, default=4)
    sp.add_argument("--mlp-dim", type=int, default=128)
    sp.add_argument("--num-blocks", type=int, default=2)
    sp.add_argument("--steps", type=int, default=300)
    sp.add_argument("--seq-parallel", type=int, default=0,
                    help="ring size over the 'seq' mesh axis; remaining "
                         "ranks form the 'data' axis (0 = the largest "
                         "power of two that divides the rank count, "
                         "capped at 4)")
    sp.add_argument("--layout", choices=("contiguous", "zigzag"),
                    default="contiguous",
                    help="causal sequence layout (zigzag balances the "
                         "causal ring schedule)")
    sp.add_argument("--block-impl", choices=("jnp", "pallas"),
                    default="jnp",
                    help="ring block fold: jnp (plain PyTorch) or pallas "
                         "-- the hand-written CUDA flash kernels; needs "
                         "--seq-len a multiple of 128 (256 under zigzag)")
    sp.add_argument("--remat", action="store_true",
                    help="checkpoint each transformer block: the "
                         "backward recomputes its activations instead of "
                         "keeping them")
    sp.add_argument("--dropout", type=float, default=0.0,
                    help="residual dropout rate inside each block")
    sp.add_argument("--patch-size", type=int, default=5,
                    help="with --data-dir: each image becomes a raster "
                         "sequence of patch-size^2-pixel tokens; "
                         "--seq-len/--features then come from the images")
    sp.add_argument("--image-size", type=int, default=50,
                    help="with --data-dir: decode size of the IDC patches")

    sp = sub.add_parser("serve",
                        help="continuous-batching LM serving: fixed decode "
                             "slots, masked windows, FIFO admission with "
                             "backpressure (serve/)")
    sp.add_argument("--path", default=None,
                    help="artifact root (serving events stream to "
                         "<path>/logs/serve.jsonl)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.add_argument("--host-devices", type=int, default=0,
                    help="refused: serving over several ranks waits for "
                         "ROADMAP A9-dist")
    sp.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace of the serve loop "
                         "to <dir>/trace.json")
    sp.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the serve "
                         "loop's spans (admission, prefill, windows, "
                         "collects) here")
    sp.add_argument("--vocab", type=int, default=16)
    sp.add_argument("--t-max", type=int, default=64,
                    help="cache capacity per slot (prompt + generation)")
    sp.add_argument("--embed-dim", type=int, default=32)
    sp.add_argument("--num-heads", type=int, default=2)
    sp.add_argument("--mlp-dim", type=int, default=64)
    sp.add_argument("--num-blocks", type=int, default=2)
    sp.add_argument("--seq-parallel", type=int, default=1,
                    help="ring size of the serving mesh; above 1 waits "
                         "for ROADMAP A9-dist")
    sp.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel serving; above 1 waits for "
                         "ROADMAP A9-dist")
    sp.add_argument("--fsdp", type=int, default=0,
                    help="must stay 0 or 1: a serving engine holds no "
                         "optimizer state")
    sp.add_argument("--train-steps", type=int, default=0,
                    help="train the counting task this many steps before "
                         "serving (0 = serve from random init)")
    sp.add_argument("--slots", type=int, default=4,
                    help="concurrent decode slots")
    sp.add_argument("--window", type=int, default=8,
                    help="tokens per decode window")
    sp.add_argument("--requests", type=int, default=16,
                    help="synthetic trace length (ignored with --trace)")
    sp.add_argument("--rate", type=float, default=50.0,
                    help="synthetic Poisson arrival rate, requests/s")
    sp.add_argument("--trace", default=None,
                    help="JSONL request trace to replay (serve.load_trace "
                         "format)")
    sp.add_argument("--realtime", action="store_true",
                    help="honor trace arrival times on the wall clock")
    sp.add_argument("--temperature", type=float, default=0.0)
    sp.add_argument("--top-k", type=int, default=0)
    sp.add_argument("--eos", type=int, default=None,
                    help="stop token id (default: none)")
    sp.add_argument("--max-queue-depth", type=int, default=64,
                    help="admission-queue backpressure bound")
    sp.add_argument("--max-prefills-per-cycle", type=int, default=1,
                    help="prefill-vs-decode interleave cap per cycle")
    sp.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill: admit prompts C tokens a cycle "
                         "(0 = off; must divide --t-max)")
    sp.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                    help="cache K/V storage: int8 rows with per-(slot, "
                         "head) scales, or the float cache")
    sp.add_argument("--metrics-port", type=int, default=None,
                    help="serve GET /metrics and GET /healthz on "
                         "127.0.0.1:PORT for the run (0 = OS-assigned)")
    sp.add_argument("--max-retries", type=int, default=0,
                    help="re-admissions of a request recovered from a "
                         "quarantined slot (0 = off; arms the per-cycle "
                         "slot health checks)")
    sp.add_argument("--retry-backoff-ms", type=float, default=50.0,
                    help="base delay between retries (doubles per retry)")
    sp.add_argument("--slo-ttft-p95-ms", type=float, default=None,
                    help="declare a TTFT SLO, burn-rate alerted "
                         "(observe/slo.py)")
    sp.add_argument("--slo-error-rate", type=float, default=None,
                    help="declare an error-rate SLO (fraction in (0, 1))")
    sp.add_argument("--slo-window-s", type=float, default=60.0,
                    help="the SLO engine's short window (the long one is "
                         "5x)")
    # the JAX verb's flags of later items: accepted, and refused by
    # `_run_serve` with the item's label when set
    for flag, kw, label in _LATER:
        sp.add_argument(flag, help=f"not ported yet (ROADMAP {label})",
                        **kw)

    sp = sub.add_parser(
        "profile",
        help="performance attribution over a train step: each program's "
             "FLOP/byte/memory account, a compute- vs bandwidth-bound "
             "roofline verdict, device-wait vs host-gap step attribution "
             "and the compile-churn watchdog; writes profile_program / "
             "profile_step jsonl (rendered by `stats`)")
    sp.add_argument("--model", required=True,
                    choices=("vgg", "mobile", "dense", "small", "serve",
                             "lm"),
                    help="which train step to profile: a backbone's "
                         "fine-tune step at its bench batch "
                         "(vgg/mobile/dense; `small` is the tiny CNN) or "
                         "the LM's (`serve` waits for ROADMAP A9.3)")
    sp.add_argument("--fsdp", type=int, default=0,
                    help="with --model lm: FSDP degree (the parameters and "
                         "RMSprop moments shard over a 'data' axis of "
                         "this size; rule set 'lm')")
    sp.add_argument("--tp", type=int, default=0,
                    help="with --model lm: tensor-parallel degree (the "
                         "weights shard over a 'model' axis); composes "
                         "with --fsdp")
    sp.add_argument("--host-devices", type=int, default=0,
                    help="run as N gloo ranks on the CPU; rank 0 prints "
                         "and writes")
    sp.add_argument("--steps", type=int, default=None,
                    help="measured steps (default: 30 on the card, 4 on "
                         "the CPU)")
    sp.add_argument("--batch-size", type=int, default=None,
                    help="per-card batch (default: the bench batch on the "
                         "card, 8 on the CPU)")
    sp.add_argument("--path", default=None,
                    help="artifact root (profile events stream to "
                         "<path>/logs/profile.jsonl)")
    sp.add_argument("--out", default=None,
                    help="explicit profile jsonl path (overrides --path's "
                         "default location)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    sp.add_argument("--compile-limit", type=int, default=5,
                    help="compile-churn watchdog: flag any program "
                         "compiled more than this many times")
    sp.add_argument("--peak-tflops", type=float, default=None,
                    help="declare the device's peak dense bf16 TFLOP/s "
                         "(with --peak-gbps; needed for a verdict on a "
                         "device the roof table does not know, e.g. the "
                         "CPU)")
    sp.add_argument("--peak-gbps", type=float, default=None,
                    help="declare the device's peak memory bandwidth, "
                         "GB/s")
    sp.add_argument("--depthwise-impl", default="grouped",
                    choices=DEPTHWISE_IMPLS,
                    help="with --model mobile: 'fused' runs the frozen "
                         "depthwise+BN+relu6 chains through the CUDA "
                         "kernel and merges its analytic FLOPs/bytes "
                         "into the train.step account (a ctypes launch "
                         "is invisible to the op count)")
    sp.add_argument("--churn-drill", action="store_true",
                    help="end with a deliberately shape-varying compiled "
                         "loop so the compile-churn watchdog fires (a "
                         "clean run stays silent)")
    sp.add_argument("--trace-out", default=None,
                    help="also export the run's spans as Chrome "
                         "trace-event JSON")

    sp = sub.add_parser("stats",
                        help="offline summary of any run jsonl (train, "
                             "fed, profile; of either package): per-event "
                             "counts, percentiles over every numeric "
                             "field, timer/span tables and the last "
                             "metrics snapshot")
    sp.add_argument("jsonl", nargs="+",
                    help="path(s) to run.jsonl / profile.jsonl / "
                         "exported span jsonl; several merge into one "
                         "summary")
    sp.add_argument("--json", action="store_true",
                    help="emit the summary as one JSON object")
    sp.add_argument("--request", default=None, metavar="RID",
                    help="render one request's timeline instead of the "
                         "whole-run summary")
    sp.add_argument("--top", type=int, default=15,
                    help="rows in the span self-time table")
    ns = p.parse_args(argv)
    ns.preset_key = ns.preset_key.replace("-", "_")
    return ns


def _log_snapshot(logger) -> None:
    """The shared tail of every logged run that ends well: one
    ``metrics_snapshot`` record of the process-wide registry."""
    if logger is not None:
        from idc_models_tpu_torch.observe import REGISTRY

        REGISTRY.log_snapshot(logger)


def _apply_overrides(preset, ns, fields):
    kw = {f: getattr(ns, f) for f in fields if getattr(ns, f) is not None}
    return dataclasses.replace(preset, **kw) if kw else preset


def _data_root(ns):
    """--data-dir > <path>/data/balanced_IDC_30k > None (synthetic)."""
    root = ns.data_dir
    if root is None and ns.path is not None:
        cand = Path(ns.path) / "data" / "balanced_IDC_30k"
        if cand.exists():
            root = cand
    return root


def _load_idc(ns, image_size, limit):
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import ArrayDataset, load_directory

    root = _data_root(ns)
    if root is not None:
        return load_directory(root, image_size=image_size, limit=limit,
                              seed=ns.seed)
    print(f"[idc_models_tpu_torch] no IDC data found; using "
          f"{ns.synthetic_examples} synthetic {image_size}x{image_size} "
          f"patches", file=sys.stderr)
    imgs, labels = synthetic.make_idc_like(ns.synthetic_examples,
                                           size=image_size, seed=ns.seed)
    return ArrayDataset(imgs, labels)


def _streamed_idc_splits(ns, preset, batch_size: int):
    """80/10/10 split at the FILE level: train as a FileStream (decoded
    per batch), val/test materialized (small, and evaluation takes
    ArrayDatasets). None when there is no real data tree."""
    import numpy as np

    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, decode_pairs, list_shuffled_pairs,
    )
    from idc_models_tpu_torch.data.pipeline import FileStream

    root = _data_root(ns)
    if root is None:
        return None
    pairs = list_shuffled_pairs(root, seed=ns.seed,
                                limit=preset.dataset_limit)
    n = len(pairs)
    n_tr, n_va = int(0.8 * n), int(0.1 * n)
    if n_tr < batch_size or n_va == 0 or n - n_tr - n_va == 0:
        sys.exit(f"--stream: {n} files are too few for an 80/10/10 split "
                 f"at batch {batch_size}")
    train = FileStream(pairs[:n_tr], preset.image_size, batch_size,
                       seed=ns.seed, repeat=preset.repeats,
                       decode_workers=ns.decode_workers)

    def materialize(subset):
        labels = np.asarray([l for _, l in subset], np.int32)
        return ArrayDataset(decode_pairs(subset, preset.image_size), labels)

    return (train, materialize(pairs[n_tr:n_tr + n_va]),
            materialize(pairs[n_tr + n_va:]))


def _run_dist(ns):
    from idc_models_tpu_torch import (
        collectives, convert, mesh as meshlib, resolve_device,
    )
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data.cifar10 import load_cifar10
    from idc_models_tpu_torch.data.idc import train_val_test_split
    from idc_models_tpu_torch.models.pretrained import save_npz
    from idc_models_tpu_torch.observe import profile_trace
    from idc_models_tpu_torch.train import losses
    from idc_models_tpu_torch.train.loop import (
        TwoPhaseConfig, evaluate, two_phase_fit,
    )

    device = resolve_device(ns.device)
    if ns.resumable and ns.path is None:
        sys.exit("--resumable requires --path (checkpoints live under it)")
    if ns.checkpoint_every < 1:
        sys.exit(f"--checkpoint-every {ns.checkpoint_every} must be "
                 f">= 1: saving every 0 epochs is never, and never "
                 f"checkpointing is what --resumable exists to fix")
    if ns.checkpoint_every != 1 and not ns.resumable:
        sys.exit("--checkpoint-every needs --resumable: it paces the "
                 "resume checkpoints, and without --resumable none "
                 "are written")
    preset = _apply_overrides(
        get_preset(ns.preset_key), ns,
        ["batch_size", "lr", "epochs", "fine_tune_epochs", "fine_tune_at",
         "repeats"])
    if ns.model_parallel > 1:
        if ns.central_storage:
            sys.exit("--central-storage broadcasts a host-resident "
                     "replica each step and cannot keep a model-sharded "
                     "layout; drop one of the two flags")
        if ns.resumable:
            sys.exit("--resumable checkpoints of a model-sharded state "
                     "wait for the sharded checkpoints (ROADMAP A11); "
                     "drop one of the two flags")
        from idc_models_tpu_torch import tp

        try:
            mesh = tp.dp_tp_mesh(ns.model_parallel)
        except ValueError as e:
            sys.exit(str(e))
    else:
        mesh = meshlib.data_mesh()
    n_data = mesh.shape[meshlib.DATA_AXIS]
    batch = (preset.batch_size * n_data if preset.per_replica_batch
             else preset.batch_size)
    if batch % n_data:
        sys.exit(f"--batch-size {batch} must divide by the {n_data} "
                 f"data-parallel ranks (each takes an equal share)")
    preset = dataclasses.replace(preset, batch_size=batch)
    print(f"Device: {device}" + _ranks_line(mesh))
    # a process started alone trains on its card without a mesh
    if not collectives.initialized():
        mesh = None
    # the synthetic fallback must yield at least one full global batch
    # after the train split, or the Loader rightly refuses to run
    ns.synthetic_examples = max(ns.synthetic_examples, 2 * preset.batch_size)
    streamed = None
    if ns.stream:
        if preset.dataset != "idc":
            sys.exit("--stream needs an IDC directory preset (vgg/mobile)")
        streamed = _streamed_idc_splits(ns, preset, preset.batch_size)
        if streamed is None:
            print("[idc_models_tpu_torch] --stream: no real data dir "
                  "found; falling back to the materialized synthetic path",
                  file=sys.stderr)
    if streamed is not None:
        train, val, test = streamed
    elif preset.dataset == "cifar10":
        ds = load_cifar10(ns.path, split="train",
                          synthetic_size=ns.synthetic_examples, seed=ns.seed)
        test = load_cifar10(ns.path, split="test",
                            synthetic_size=max(ns.synthetic_examples // 5, 64),
                            seed=ns.seed)
        train, val, _ = train_val_test_split(ds, (0.9, 0.1, 0.0),
                                             seed=ns.seed)
    else:
        ds = _load_idc(ns, preset.image_size, preset.dataset_limit)
        train, val, test = train_val_test_split(ds, seed=ns.seed)
    loss_fn = (losses.binary_cross_entropy if preset.num_outputs == 1
               else losses.sparse_categorical_cross_entropy)
    build_kwargs = ({"depthwise_impl": ns.depthwise_impl}
                    if preset.model == "mobilenet_v2" else {})

    logger = _run_logger(ns)
    try:
        with profile_trace(ns.profile_dir if collectives.is_writer() else None):
            result = two_phase_fit(
                preset.model, preset.num_outputs, train, val,
                TwoPhaseConfig(lr=preset.lr, epochs=preset.epochs,
                               fine_tune_epochs=preset.fine_tune_epochs,
                               batch_size=preset.batch_size,
                               fine_tune_at=preset.fine_tune_at,
                               repeats=preset.repeats,
                               cache_features=ns.cache_features,
                               central_storage=ns.central_storage,
                               seed=ns.seed),
                loss_fn=loss_fn, build_kwargs=build_kwargs,
                pretrained_weights=ns.pretrained_weights,
                artifact_path=ns.path,
                checkpoint_dir=(Path(ns.path) / "dist_ckpt" if ns.resumable
                                else None),
                checkpoint_every=ns.checkpoint_every,
                logger=logger, device=device, mesh=mesh)
        test_metrics = evaluate(result.model, test, loss_fn,
                                batch_size=preset.batch_size,
                                with_auroc=preset.num_outputs == 1,
                                mesh=mesh)
        print("test:", " ".join(f"{k}={v:.4f}"
                                for k, v in test_metrics.items()))
        if logger is not None:
            logger.log(event="test", **test_metrics)
            params, state = convert.to_jax(result.model)
            save_npz(Path(ns.path) / "model.npz",
                     {"params": params, "state": state})
        _log_snapshot(logger)
    finally:
        if streamed is not None:
            train.close()
        if logger is not None:
            logger.close()


def _run_fed(ns):
    """FedAvg over a pretrained VGG16 (fed_model.py), classic mode:
    pretrain on the pooled data (or restore the pretrained checkpoint),
    partition the data into train and test clients, and run the rounds
    under the self-healing driver, checkpointing and resuming the server
    state."""
    import numpy as np
    import torch

    from idc_models_tpu_torch import collectives, convert, resolve_device
    from idc_models_tpu_torch import faults as faults_lib
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.data.idc import train_val_test_split
    from idc_models_tpu_torch.data.partition import (
        partition_clients, train_test_client_split,
    )
    from idc_models_tpu_torch.federated import (
        ServerState, initialize_server, make_fedavg_round,
        make_federated_eval, seed_server_with,
    )
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.observe import JsonlLogger
    from idc_models_tpu_torch.train import losses
    from idc_models_tpu_torch.train.checkpoint import (
        checkpoint_exists, restore_checkpoint, save_checkpoint,
    )
    from idc_models_tpu_torch.train.loop import TwoPhaseConfig, two_phase_fit

    device = resolve_device(ns.device)
    if collectives.axis_size() > 1:
        _one_rank_fed(collectives.axis_size())
    if ns.checkpoint_every < 1:
        sys.exit(f"--checkpoint-every {ns.checkpoint_every} must be "
                 f">= 1: saving every 0 rounds is never, and a crash "
                 f"then replays the whole run")
    spike = ns.loss_spike_ratio
    if spike != 0 and spike <= 1:
        # only the documented 0 disables; negatives and (0, 1] are
        # configuration mistakes that must not silently turn the
        # divergence detector off
        sys.exit(f"--loss-spike-ratio {spike} must be > 1 (a round is "
                 f"rolled back when its loss exceeds ratio x the last "
                 f"good loss; 0 disables the detector)")
    if ns.population:
        return _run_fed_population(ns, device)
    preset = _apply_overrides(
        get_preset("fed"), ns,
        ["batch_size", "lr", "rounds", "iid", "num_clients", "local_epochs",
         "pretrain_epochs"])
    print(f"Device: {device}")
    n_clients = preset.num_clients
    ds = _load_idc(ns, preset.image_size, preset.dataset_limit)
    loss_fn = (losses.binary_cross_entropy if preset.num_outputs == 1
               else losses.sparse_categorical_cross_entropy)
    logger = (JsonlLogger(Path(ns.path) / "logs" / "run.jsonl")
              if ns.path is not None else None)
    try:
        # Pretrain (C8): checkpoint-gated VGG16 on the pooled data
        spec = registry.get_model(preset.model)
        train, val, _ = train_val_test_split(ds, seed=ns.seed)
        ckpt = (Path(ns.path) / "pretrained" / "cp.ckpt" if ns.path
                else None)
        if ckpt is not None and checkpoint_exists(ckpt):
            model = spec.build(preset.num_outputs)
            params, state = convert.to_jax(model)
            restored = restore_checkpoint(ckpt, {"params": params,
                                                 "state": state})
            convert.load_jax(model, restored["params"], restored["state"])
            print(f"restored pretrained weights from {ckpt}")
            if ns.pretrained_weights:
                print(f"[idc_models_tpu_torch] --pretrained-weights "
                      f"ignored: checkpoint {ckpt} takes precedence "
                      f"(delete it to re-pretrain from the artifact)",
                      file=sys.stderr)
        else:
            model = two_phase_fit(
                preset.model, preset.num_outputs, train, val,
                TwoPhaseConfig(lr=preset.lr, epochs=preset.pretrain_epochs,
                               fine_tune_epochs=0,
                               batch_size=preset.batch_size,
                               fine_tune_at=preset.fine_tune_at,
                               seed=ns.seed),
                loss_fn=loss_fn, pretrained_weights=ns.pretrained_weights,
                logger=logger, device=device).model
            if ckpt is not None:
                params, state = convert.to_jax(model)
                save_checkpoint(ckpt, {"params": params, "state": state})
        model.to(device)

        # Federate: clients fine-tune above fine_tune_at at lr/10
        # (fed_model.py:140-147,208)
        imgs, labels = partition_clients(ds, n_clients,
                                         iid=bool(preset.iid), seed=ns.seed)
        n_per_client = imgs.shape[1]
        train_ids, test_ids = train_test_client_split(
            n_clients, preset.test_client_fraction, seed=ns.seed)
        # train clients carry weight = examples, test clients weight 0
        # (one card holds every client: no padding to a mesh)
        w_train = np.zeros((n_clients,), np.float32)
        w_train[train_ids] = n_per_client
        w_test = np.zeros((n_clients,), np.float32)
        w_test[test_ids] = n_per_client
        # the stacked client shards go to the card once, not once a round
        imgs = torch.as_tensor(np.asarray(imgs, np.float32), device=device)
        labels = torch.as_tensor(labels, device=device)
        mask = spec.fine_tune_mask(model, preset.fine_tune_at)
        pretrained = ServerState.of(model)
        server = seed_server_with(initialize_server(model, ns.seed),
                                  pretrained.params, pretrained.state)
        # round-loop checkpoint/resume: the reference checkpoints only
        # the pretrainer; here the federated loop resumes too
        server, server_ckpt, resumed = _restore_fed_server(server, ns)
        plan = None
        if ns.faults:
            plan = faults_lib.parse_fault_spec(ns.faults, n_clients)
            print(f"[idc_models_tpu_torch] injecting faults: {plan}",
                  file=sys.stderr)
        round_fn = make_fedavg_round(
            model, preset.lr / 10.0, loss_fn,
            local_epochs=preset.local_epochs, batch_size=preset.batch_size,
            trainable_mask=mask, aggregator=_fed_aggregator(ns),
            faults=plan, device=device)
        eval_fn = make_federated_eval(model, loss_fn, device=device)
        # A resume from an every-N checkpoint replays the rounds after
        # the last save (same keys). Replayed rounds print again but must
        # not append duplicate records to the append-only run.jsonl; a
        # fresh run pointed at a reused --path logs every round.
        logged_through = _resume_marks(logger)[0] if resumed else -1

        def eval_round(sv):
            em = eval_fn(sv, imgs, labels, w_test)
            return {"test_loss": em["loss"], "test_acc": em["accuracy"]}

        def warn_degenerate(entry):
            if entry.get("trim_degenerate"):
                print(f"[idc_models_tpu_torch] round {entry['round']}: "
                      f"trimmed mean had NO kept band (live clients <= "
                      f"2*trim) -- the server state was left UNCHANGED "
                      f"this round; lower --trim or enroll more clients",
                      file=sys.stderr)

        result = _drive_fed(
            ns, round_fn, server, imgs, labels, w_train,
            rounds=preset.rounds, eval_round=eval_round, logger=logger,
            server_ckpt=server_ckpt, logged_through=logged_through,
            on_round=warn_degenerate, fault_plan=plan)
        for entry in result.history:
            dropped = int(entry.get("clients_dropped", 0))
            if dropped:
                print(f"[idc_models_tpu_torch] round {entry['round']}: "
                      f"dropped {dropped} client(s) with non-finite "
                      f"updates from the aggregate", file=sys.stderr)
        _log_snapshot(logger)
    finally:
        if logger is not None:
            logger.close()


def _fed_aggregator(ns):
    """The --aggregator the fed verbs train with, built with its flag."""
    from idc_models_tpu_torch.federated import get_aggregator

    agg_kw = ({"trim": ns.trim} if ns.aggregator == "trimmed_mean" else
              {"max_norm": ns.clip_norm}
              if ns.aggregator == "norm_clip" else {})
    return get_aggregator(ns.aggregator, **agg_kw)


def _restore_fed_server(server, ns):
    """(server, checkpoint path, resumed): the server state restored from
    ``<path>/fed_server`` when a checkpoint is there, else `server`."""
    from idc_models_tpu_torch.federated import ServerState
    from idc_models_tpu_torch.train.checkpoint import (
        checkpoint_exists, restore_checkpoint,
    )

    server_ckpt = Path(ns.path) / "fed_server" if ns.path else None
    if server_ckpt is None or not checkpoint_exists(server_ckpt):
        return server, server_ckpt, False
    server = ServerState.from_tree(
        restore_checkpoint(server_ckpt, server.tree()))
    print(f"resuming federated training from round {server.round}")
    return server, server_ckpt, server.round > 0


def _drive_fed(ns, round_fn, server, images, labels, weights, *, rounds,
               eval_round, logger, server_ckpt, logged_through, on_round,
               fault_plan=None, participant_ids_fn=None):
    """Run the fed verbs' rounds under the self-healing driver: print
    each round and append its ``round`` record past `logged_through`,
    call `on_round(entry)`, checkpoint the server, exit on a round that
    could not be healed and report the healed attempts. `fault_plan`
    and `participant_ids_fn` label the ``fed.client`` spans. Returns the
    driver's result."""
    from idc_models_tpu_torch.federated import (
        DriverConfig, RoundFailure, run_rounds,
    )
    from idc_models_tpu_torch.observe import Timer, profile_trace

    print("round, train_loss, train_acc, test_loss, test_acc")

    def print_round(entry):
        print(f"{entry['round']}, {entry['loss']:.4f}, "
              f"{entry['accuracy']:.4f}, {entry['test_loss']:.4f}, "
              f"{entry['test_acc']:.4f}")
        on_round(entry)
        # the verb owns the `round` records (the driver logs only
        # round_health), under their historical field names
        if logger is not None and entry["round"] > logged_through:
            logger.log(event="round", round=entry["round"],
                       train_loss=entry["loss"],
                       train_acc=entry["accuracy"],
                       test_loss=entry["test_loss"],
                       test_acc=entry["test_acc"],
                       clients_dropped=int(entry.get("clients_dropped", 0)))

    spike = ns.loss_spike_ratio
    config = DriverConfig(
        rounds=rounds, timeout_s=ns.round_timeout,
        max_attempts=1 + max(ns.max_round_retries, 0),
        loss_spike_ratio=spike if spike > 1 else None,
        checkpoint_path=server_ckpt,
        checkpoint_every=ns.checkpoint_every)
    try:
        with Timer("Federated training", logger=logger), \
                profile_trace(ns.profile_dir):
            result = run_rounds(
                round_fn, server, images, labels, weights, config=config,
                seed=ns.seed + 1, eval_fn=eval_round, on_round=print_round,
                logger=logger, verbose=True, log_from_round=logged_through,
                log_round_records=False, fault_plan=fault_plan,
                participant_ids_fn=participant_ids_fn)
    except RoundFailure as e:
        sys.exit(f"[idc_models_tpu_torch] federated training aborted: {e}")
    retried = [e for e in result.events if e["status"] != "ok"]
    if retried:
        print(f"[idc_models_tpu_torch] {len(retried)} round attempt(s) "
              f"failed and were healed (rollback/reseed); see "
              f"round_health events", file=sys.stderr)
    return result


def _resume_marks(logger) -> tuple[int, int]:
    """The last round of the run's ``round`` and ``fed_cohort`` records in
    its jsonl, each -1 when none, so a resumed run appends neither twice.
    Kept apart: fed_cohort is written inside the round and ``round``
    after its evaluation, so a crash between them leaves them unequal."""
    import json

    marks = {"round": -1, "fed_cohort": -1}
    if logger is None or not logger.path.exists():
        return marks["round"], marks["fed_cohort"]
    for line in logger.path.read_text().splitlines():
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if rec.get("event") in marks:
            marks[rec["event"]] = max(marks[rec["event"]], int(rec["round"]))
    return marks["round"], marks["fed_cohort"]


def _run_fed_population(ns, device):
    """Population-scale FedAvg: virtual clients, a sampled cohort a
    round, streamed waves (or the buffered async server), under the
    self-healing driver with the server checkpointed to
    ``<path>/fed_server``."""
    import numpy as np
    import torch

    from idc_models_tpu_torch import faults as faults_lib
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.federated import (
        ClientPopulation, CohortSampler, initialize_server, make_async_round,
        make_federated_eval, make_population_round,
    )
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.observe import JsonlLogger
    from idc_models_tpu_torch.train import losses

    preset = _apply_overrides(
        get_preset("fed"), ns, ["batch_size", "lr", "rounds", "local_epochs"])
    n_pop = int(ns.population)
    cohort = int(ns.cohort)
    if cohort < 1:
        sys.exit(f"--cohort must be >= 1, got {cohort}")
    if cohort > n_pop:
        sys.exit(f"--cohort {cohort} exceeds --population {n_pop}: a "
                 f"round cannot sample more clients than the "
                 f"population holds")
    wave = int(ns.cohort_wave) or cohort
    use_async = int(ns.async_buffer) != 0
    if use_async and ns.async_buffer < 0:
        sys.exit(f"--async-buffer must be >= 1 (0 disables async "
                 f"mode), got {ns.async_buffer}")
    if use_async and int(ns.cohort_wave):
        sys.exit("--cohort-wave only applies to synchronous streamed "
                 "rounds; the async server buffers by --async-buffer "
                 "instead (drop one of the two flags)")
    decay = float(ns.staleness_decay)
    if not 0.0 < decay <= 1.0:
        sys.exit(f"--staleness-decay must be in (0, 1], got {decay} "
                 f"(1 = no discount; smaller discounts staler "
                 f"updates harder)")
    model_name = ns.model or preset.model
    image_size = 10 if model_name == "small_cnn" else preset.image_size
    s = int(ns.client_examples)
    if s < 1:
        sys.exit(f"--client-examples must be >= 1, got {s} (each "
                 f"virtual client's shard size)")
    weight_range = ((0.5 * s, 1.5 * s) if ns.weighted_sampling
                    else (float(s), float(s)))
    population = ClientPopulation(
        n_pop, examples_per_client=s, image_size=image_size, seed=ns.seed,
        weight_range=weight_range)
    sampler = CohortSampler(population, cohort, seed=ns.seed,
                            weighted=ns.weighted_sampling)
    delay_ms = float(ns.fault_delay_ms)
    if delay_ms < 0:
        sys.exit(f"--fault-delay-ms must be >= 0, got {delay_ms}")
    plan = None
    if ns.faults:
        try:
            plan = faults_lib.parse_population_fault_spec(
                ns.faults, n_pop, seed=ns.seed,
                delay_unit_s=delay_ms / 1000.0)
        except ValueError as e:
            sys.exit(str(e))
        print(f"[idc_models_tpu_torch] injecting faults: {plan}",
              file=sys.stderr)
        if use_async and delay_ms == 0.0 and plan.max_staleness > 0:
            # async staleness IS lateness: without a delay a straggler
            # arrives on time, so say so instead of running fault-free
            print("[idc_models_tpu_torch] straggler faults are INERT in "
                  "async mode without --fault-delay-ms: buffered "
                  "staleness comes from late arrival, and the plan's "
                  "stragglers arrive on time", file=sys.stderr)
    print(f"Device: {device}")
    # every layer trains, from a seeded init: population mode has no
    # pretraining phase (the JAX package's spec.build(num_outputs, 3))
    model = registry.get_model(model_name).build(preset.num_outputs, 3)
    loss_fn = (losses.binary_cross_entropy if preset.num_outputs == 1
               else losses.sparse_categorical_cross_entropy)
    server, server_ckpt, resumed = _restore_fed_server(
        initialize_server(model, ns.seed), ns)
    logger = (JsonlLogger(Path(ns.path) / "logs" / "run.jsonl")
              if ns.path is not None else None)
    try:
        logged_through, cohort_through = (
            _resume_marks(logger) if resumed else (-1, -1))
        kw = dict(local_epochs=preset.local_epochs,
                  batch_size=preset.batch_size, faults=plan, logger=logger,
                  log_from_round=cohort_through, device=device)
        try:
            agg = _fed_aggregator(ns)
            if use_async:
                round_fn = make_async_round(
                    model, preset.lr / 10.0, loss_fn, population, sampler,
                    buffer_size=int(ns.async_buffer),
                    staleness_decay=decay, aggregator=agg, seed=ns.seed,
                    **kw)
            else:
                round_fn = make_population_round(
                    model, preset.lr / 10.0, loss_fn, population, sampler,
                    wave_size=wave, aggregator=agg,
                    barrier_sleep=delay_ms > 0, **kw)
        except ValueError as e:
            sys.exit(str(e))

        # the held-out eval cohort: a fixed seeded draw of one wave,
        # made and uploaded once
        eval_ids = CohortSampler(population, wave,
                                 seed=ns.seed + 4242).cohort(0)
        eval_imgs, eval_labels, eval_w = population.materialize(eval_ids)
        eval_imgs = torch.as_tensor(eval_imgs, dtype=torch.float32,
                                    device=device)
        eval_labels = torch.as_tensor(eval_labels, device=device)
        eval_fn = make_federated_eval(model, loss_fn, device=device)

        def eval_round(sv):
            em = eval_fn(sv, eval_imgs, eval_labels, eval_w)
            return {"test_loss": em["loss"], "test_acc": em["accuracy"]}

        totals = {"updates": 0, "staleness_sum": 0.0, "participants": 0}

        def add_totals(entry):
            n = int(entry.get("participants", 0))
            totals["updates"] += int(entry.get("updates", 0))
            totals["staleness_sum"] += float(
                entry.get("staleness_mean", 0.0)) * n
            totals["participants"] += n

        # the fed.client spans name VIRTUAL clients: the async server's
        # completions of the attempt, the sync round's cohort
        ids_fn = ((lambda r: round_fn.last_participants) if use_async
                  else sampler.cohort)
        _drive_fed(ns, round_fn, server, None, None,
                   np.ones((cohort,), np.float32), rounds=preset.rounds,
                   eval_round=eval_round, logger=logger,
                   server_ckpt=server_ckpt, logged_through=logged_through,
                   on_round=add_totals, fault_plan=plan,
                   participant_ids_fn=ids_fn)
        mode = "weighted" if ns.weighted_sampling else "uniform"
        decomp = (f" in {cohort // wave} wave(s) of {wave}; memory "
                  f"bounded by the wave, not the population"
                  if not use_async else "; memory bounded by the "
                  "in-flight pool, not the population")
        print(f"population: {n_pop} virtual clients, cohort {cohort} "
              f"({mode}){decomp}")
        if use_async:
            mean_st = (totals["staleness_sum"] / totals["participants"]
                       if totals["participants"] else 0.0)
            print(f"async buffer: K={int(ns.async_buffer)}, staleness "
                  f"decay {decay}, {totals['updates']} buffered "
                  f"update(s), mean staleness {mean_st:.2f}")
        _log_snapshot(logger)
    finally:
        if logger is not None:
            logger.close()


def _run_secure(ns):
    import numpy as np
    import torch

    from idc_models_tpu_torch import collectives, resolve_device
    from idc_models_tpu_torch.configs import get_preset
    from idc_models_tpu_torch.federated.fedavg import (
        initialize_server, load_server,
    )
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.observe import JsonlLogger, Timer, profile_trace
    from idc_models_tpu_torch.secure.fedavg import make_secure_fedavg_round
    from idc_models_tpu_torch.train import losses
    from idc_models_tpu_torch.train.loop import evaluate

    device = resolve_device(ns.device)
    if collectives.axis_size() > 1:
        _one_rank_fed(collectives.axis_size())
    if ns.async_buffer:
        from idc_models_tpu_torch.federated import ensure_async_compatible

        try:
            ensure_async_compatible(secure=True)
        except ValueError as e:
            sys.exit(str(e))
    preset = _apply_overrides(
        get_preset("secure_fed"), ns,
        ["batch_size", "lr", "rounds", "percent", "num_clients",
         "local_epochs", "paillier"])
    print(f"Device: {device}")
    n_clients = preset.num_clients
    ds = _load_idc(ns, preset.image_size, None)
    # take/skip split sized by the preset (24000/6000 in the reference,
    # secure_fed_model.py:219-220), scaled down when the dataset is smaller
    n_client_total = min(preset.client_examples, int(len(ds) * 0.8))
    client_ds = ds.take(n_client_total)
    test_ds = ds.skip(n_client_total).take(preset.test_examples)
    loss_fn = (losses.binary_cross_entropy if preset.num_outputs == 1
               else losses.sparse_categorical_cross_entropy)
    model = registry.get_model(preset.model).build(preset.num_outputs, 3)
    logger = (JsonlLogger(Path(ns.path) / "logs" / "run.jsonl")
              if ns.path is not None else None)
    try:
        if preset.paillier:
            if ns.mask_impl != "threefry":
                print("[idc_models_tpu_torch] --mask-impl has no effect "
                      "with --paillier (host-side Paillier path)",
                      file=sys.stderr)
            _run_secure_paillier(preset, client_ds, test_ds, model, loss_fn,
                                 logger, ns, device)
            _log_snapshot(logger)
            return
        # strided shard per client (secure_fed_model.py:206-210), stacked
        # and uploaded to the card once
        shards = [client_ds.shard(n_clients, i) for i in range(n_clients)]
        size = min(len(s) for s in shards)
        imgs = torch.as_tensor(np.stack([s.images[:size] for s in shards]),
                               dtype=torch.float32, device=device)
        labels = torch.as_tensor(np.stack([s.labels[:size] for s in shards]),
                                 device=device)
        server = initialize_server(model, ns.seed)
        round_fn = make_secure_fedavg_round(
            model, preset.lr, loss_fn, percent=preset.percent,
            local_epochs=preset.local_epochs, batch_size=preset.batch_size,
            mask_impl=ns.mask_impl, device=device)
        generator = torch.Generator().manual_seed(ns.seed + 1)
        with Timer("Secure fed model", logger=logger), \
                profile_trace(ns.profile_dir):
            for r in range(preset.rounds):
                server, tm = round_fn(server, imgs, labels, generator)
                em = evaluate(load_server(model, server), test_ds, loss_fn,
                              batch_size=preset.batch_size, with_auroc=True)
                print(f"round {r}: train_loss={tm['loss']:.4f} "
                      f"test_loss={em['loss']:.4f} "
                      f"acc={em['accuracy']:.4f} auroc={em['auroc']:.4f}")
                recovered = int(tm["clients_recovered"])
                if recovered:
                    print(f"[idc_models_tpu_torch] round {r}: {recovered} "
                          f"client(s) diverged; their updates were "
                          f"replaced with the incoming global weights",
                          file=sys.stderr)
                if logger is not None:
                    logger.log(event="round", round=r,
                               train_loss=tm["loss"],
                               train_accuracy=tm["accuracy"],
                               clients_recovered=recovered,
                               clip_saturated=tm["clip_saturated"],
                               **{f"test_{k}": v for k, v in em.items()})
        if ns.path is not None:
            from idc_models_tpu_torch import convert
            from idc_models_tpu_torch.models.pretrained import save_npz

            params, state = convert.to_jax(load_server(model, server))
            save_npz(Path(ns.path) / "model.npz",
                     {"params": params, "state": state})
        _log_snapshot(logger)
    finally:
        if logger is not None:
            logger.close()


def _run_secure_paillier(preset, client_ds, test_ds, model, loss_fn, logger,
                         ns, device):
    from idc_models_tpu_torch.observe import Timer
    from idc_models_tpu_torch.secure.fedavg import (
        PaillierClient, PaillierServer,
    )
    from idc_models_tpu_torch.secure.paillier import generate_paillier_keypair

    pub, priv = generate_paillier_keypair(512)
    clients = []
    for i in range(preset.num_clients):
        shard = client_ds.shard(preset.num_clients, i)
        clients.append(PaillierClient(
            model, preset.lr, loss_fn, shard.images, shard.labels, i,
            preset.percent, pub, priv, local_epochs=preset.local_epochs,
            batch_size=preset.batch_size, seed=ns.seed, device=device))
    with Timer("Secure fed model", logger=logger):
        for r in range(preset.rounds):
            packages = []
            for c in clients:
                with Timer(f"Client {c.client_id} training"):
                    pkg, _ = c.client_fit()
                packages.append(pkg)
            agg = PaillierServer.aggregate(packages)
            for c in clients:
                c.client_update(agg)
            m = clients[0].evaluate(test_ds.images, test_ds.labels, loss_fn)
            print(f"round {r}: " + " ".join(f"{k}={v:.4f}"
                                            for k, v in m.items()))
            if logger is not None:
                logger.log(event="round", round=r, **m)


def _run_lm(ns):
    """The decoder-only LM trained through the ring on the counting task
    (next = (tok + 1) % vocab), then served through the KV-cache
    decoder: train and generate from one set of weights."""
    import time

    import numpy as np
    import torch

    from idc_models_tpu_torch import collectives, resolve_device
    from idc_models_tpu_torch import mesh as meshlib
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.models.core import init_params, use_generator
    from idc_models_tpu_torch.models.lm import (
        AttentionLM, Generator, make_lm_train_step, next_token_loss,
    )
    from idc_models_tpu_torch.observe import Timer, profile_trace
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step, shard_batch

    device = resolve_device(ns.device)
    if not 0.0 <= ns.dropout < 1.0:
        sys.exit(f"--dropout {ns.dropout} must be in [0, 1)")
    if ns.fsdp < 0 or ns.tp < 0:
        sys.exit(f"--fsdp/--tp must be >= 0 (0 = off), got "
                 f"{ns.fsdp}/{ns.tp}")
    n_dev = collectives.axis_size()
    batch = ns.batch_size or 32
    sharded = ns.fsdp > 1 or ns.tp > 1
    if sharded:
        # the rule-sharded mesh: FSDP over "data", TP over "model", the
        # ring over "seq"; --seq-parallel defaults to 1 here (the three
        # axes share the ranks)
        f, t = max(ns.fsdp, 1), max(ns.tp, 1)
        n_seq = ns.seq_parallel or 1
        if f * t * n_seq > n_dev:
            sys.exit(f"--fsdp {f} x --tp {t} x --seq-parallel {n_seq} "
                     f"needs {f * t * n_seq} devices, have {n_dev} "
                     f"(use --host-devices to grow the virtual pod)")
        if batch % f:
            sys.exit(f"--batch-size {batch} must divide by --fsdp {f} "
                     f"(the batch shards over the same 'data' axis the "
                     f"params shard over)")
        mesh = meshlib.fsdp_tp_mesh(f, t, n_seq)
    else:
        n_seq = _seq_ring(ns.seq_parallel, n_dev)
        mesh = meshlib.data_seq_mesh(n_seq)
        if batch % mesh.shape[meshlib.DATA_AXIS]:
            sys.exit(f"--batch-size {batch} must divide by the "
                     f"{mesh.shape[meshlib.DATA_AXIS]} data-parallel ranks")
    _check_stripes(ns.layout, ns.seq_len, f"--seq-len {ns.seq_len}", n_seq)
    print(f"Device: {device} (ring size {n_seq})" + _ranks_line(mesh)
          + ("; params + optimizer state sharded by rule set 'lm'"
             if sharded else ""))
    if mesh.coords is None:
        return               # a rank the mesh leaves idle
    # one rank is one card: the plain model, no plan
    model_mesh = mesh if mesh.size > 1 else None
    model = init_params(AttentionLM(
        ns.vocab, ns.seq_len, embed_dim=ns.embed_dim,
        num_heads=ns.num_heads, mlp_dim=ns.mlp_dim,
        num_blocks=ns.num_blocks, block_impl=ns.block_impl,
        layout=ns.layout, dropout_rate=ns.dropout, remat=ns.remat,
        mesh=model_mesh), ns.seed).to(device)
    if sharded:
        model.shard_(registry.get_partition_rules("lm"))
    if ns.dropout:
        use_generator(model, torch.Generator(device=device).manual_seed(
            ns.seed + 2))
    lr = ns.lr if ns.lr is not None else 3e-3
    state = TrainState(model, rmsprop(model, lr))
    step = (make_lm_train_step(state, global_batch=batch)
            if model_mesh is not None else
            make_train_step(state, next_token_loss,
                            mesh=mesh if collectives.initialized() else None))
    logger = _run_logger(ns)
    rng = np.random.default_rng(ns.seed + 1)
    try:
        with Timer("LM training", logger=logger), \
                profile_trace(ns.profile_dir if collectives.is_writer() else None):
            for i in range(ns.steps):
                starts = rng.integers(0, ns.vocab, (batch, 1))
                seqs = shard_batch(mesh, (starts + np.arange(ns.seq_len))
                                   % ns.vocab, axis=meshlib.DATA_AXIS,
                                   device=device)
                m = step(seqs, seqs)
                if i % 50 == 0 or i == ns.steps - 1:
                    loss, acc = float(m["loss"]), float(m["accuracy"])
                    print(f"step {i}, loss={loss:.4f}, "
                          f"next-token accuracy={acc:.4f}")
                    if logger is not None:
                        logger.log(event="step", step=i, loss=loss,
                                   accuracy=acc)
        n_gen = min(ns.generate, ns.seq_len - 3)
        if ns.generate > 0 and n_gen >= 1:
            if ns.temperature < 0.0:
                sys.exit(f"--temperature {ns.temperature} must be >= 0")
            if ns.top_k < 0:
                sys.exit(f"--top-k {ns.top_k} must be >= 0 (0 = no "
                         f"restriction)")
            if ns.top_k > 0 and ns.temperature == 0.0:
                print("[idc_models_tpu_torch] --top-k has no effect at "
                      "--temperature 0 (greedy argmax already picks the "
                      "top-1 token)", file=sys.stderr)
            gen = Generator(model if model_mesh is None
                            else model.gathered_params(),
                            embed_dim=ns.embed_dim,
                            num_heads=ns.num_heads,
                            num_blocks=ns.num_blocks, t_max=ns.seq_len,
                            cache_dtype=torch.float32,
                            temperature=ns.temperature,
                            top_k=ns.top_k or None, device=device)
            prompt = [[i % ns.vocab for i in range(3)]]

            def sampler():
                # a fresh stream per call, so both runs draw alike
                return (torch.Generator(device=device).manual_seed(
                    ns.seed + 3) if ns.temperature > 0.0 else None)

            gen(prompt, n_gen, rng=sampler())             # warm-up
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            toks = gen(prompt, n_gen, rng=sampler()).tolist()[0]
            dt = time.perf_counter() - t0
            want = [i % ns.vocab for i in range(3 + n_gen)]
            ok = toks == want
            verdict = (("matches" if ok else "does NOT match")
                       if ns.temperature == 0.0 else "sampled against")
            print(f"generate: {toks[:3]} -> {toks[3:]} ({verdict} the "
                  f"counting pattern; {n_gen} tokens end-to-end in "
                  f"{dt * 1e3:.1f} ms, one prefill + {n_gen} decode "
                  f"steps)")
            if logger is not None:
                # end to end (prefill + decode + host fetch) / tokens
                logger.log(event="generate", tokens=toks, matches=ok,
                           generate_ms_per_token=dt * 1e3 / n_gen)
        _log_snapshot(logger)
    finally:
        if logger is not None:
            logger.close()


def _check_stripes(layout: str, seq_len: int, what: str,
                   n_seq: int = 1) -> None:
    """The layout's stripes on a ring of n_seq, 2 n_seq under zigzag,
    must cut the sequence evenly; `what` names the sequence in the
    message."""
    stripes = 2 * n_seq if layout == "zigzag" else n_seq
    if seq_len % stripes:
        sys.exit(f"{what} must divide into {stripes} equal stripes for "
                 f"--layout {layout} at ring size {n_seq}")


def _seq_ring(seq_parallel: int, n_dev: int) -> int:
    """--seq-parallel, or by default the largest power of two that
    divides the rank count (at most 4); it must divide the ranks."""
    n_seq = seq_parallel or max(p for p in (4, 2, 1) if n_dev % p == 0)
    if n_seq < 1 or n_dev % n_seq:
        sys.exit(f"--seq-parallel {n_seq} must be a positive divisor of "
                 f"the device count ({n_dev})")
    return n_seq


def _run_attention(ns):
    """The ring-attention transformer classifier (`AttentionClassifier`)
    trained on the position-sensitive synthetic sequence task or, with
    --data-dir, on IDC patches as raster token sequences (``patchify``),
    split 80/10/10; RMSprop at 1e-3 and BCE; then a validation pass
    with AUROC."""
    import numpy as np
    import torch

    from idc_models_tpu_torch import collectives, resolve_device
    from idc_models_tpu_torch import mesh as meshlib
    from idc_models_tpu_torch.data import synthetic
    from idc_models_tpu_torch.data.idc import (
        ArrayDataset, train_val_test_split,
    )
    from idc_models_tpu_torch.data.sequences import patchify, sequence_shape
    from idc_models_tpu_torch.models.attention import AttentionClassifier
    from idc_models_tpu_torch.models.core import init_params, use_generator
    from idc_models_tpu_torch.observe import Timer, profile_trace
    from idc_models_tpu_torch.train.loop import evaluate
    from idc_models_tpu_torch.train.losses import binary_cross_entropy
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step, shard_batch

    device = resolve_device(ns.device)
    if not 0.0 <= ns.dropout < 1.0:
        sys.exit(f"--dropout {ns.dropout} must be in [0, 1)")
    # explicit --data-dir only: real data sets the sequence shape, so an
    # artifact directory holding an IDC tree must not turn a synthetic
    # long-context run into a short IDC one
    root = ns.data_dir
    seq_len, features = ns.seq_len, ns.features
    if root is not None:
        try:
            seq_len, features = sequence_shape(ns.image_size, ns.patch_size)
        except ValueError as e:
            sys.exit(f"--patch-size: {e}")
    what = ("--seq-len" if root is None
            else f"the {seq_len}-token patch sequence "
                 f"({ns.image_size}x{ns.image_size} images at "
                 f"--patch-size {ns.patch_size})")
    n_seq = _seq_ring(ns.seq_parallel, collectives.axis_size())
    _check_stripes(ns.layout, seq_len, f"{what} = {seq_len}", n_seq)
    mesh = meshlib.data_seq_mesh(n_seq)
    print(f"Device: {device} (ring size {n_seq})" + _ranks_line(mesh))
    model = init_params(AttentionClassifier(
        seq_len, features, embed_dim=ns.embed_dim, num_heads=ns.num_heads,
        mlp_dim=ns.mlp_dim, num_blocks=ns.num_blocks, num_outputs=1,
        causal=True, block_impl=ns.block_impl, layout=ns.layout,
        dropout_rate=ns.dropout, remat=ns.remat, mesh=mesh),
        ns.seed).to(device)
    if ns.dropout:
        use_generator(model, torch.Generator(device=device).manual_seed(
            ns.seed + 1))
    batch = ns.batch_size or 64
    if batch % mesh.shape[meshlib.DATA_AXIS]:
        sys.exit(f"--batch-size {batch} must divide by the "
                 f"{mesh.shape[meshlib.DATA_AXIS]} data-parallel ranks")
    lr = ns.lr if ns.lr is not None else 1e-3
    if root is not None:
        # the reference's data domain: the labeled tree, the 80/10/10
        # split, then each patch as a token sequence
        train_ds, val_ds, _ = train_val_test_split(
            _load_idc(ns, ns.image_size, None), seed=ns.seed)
        x, y = patchify(train_ds.images, ns.patch_size), train_ds.labels
        vx, vy = patchify(val_ds.images, ns.patch_size), val_ds.labels
        print(f"IDC patch sequences: {len(x)} train / {len(vx)} val, "
              f"{seq_len} tokens x {features} features per patch")
    else:
        n_train = max(ns.synthetic_examples, 4 * batch)
        x, y = synthetic.make_sequence_task(n_train, seq_len, features,
                                            seed=ns.seed)
        vx, vy = synthetic.make_sequence_task(max(n_train // 4, batch),
                                              seq_len, features,
                                              seed=ns.seed + 1)
    # a process started alone trains on its card without a mesh
    mesh = mesh if collectives.initialized() else None
    step = make_train_step(TrainState(model, rmsprop(model, lr)),
                           binary_cross_entropy, mesh=mesh)
    logger = _run_logger(ns)
    sel_rng = np.random.default_rng(ns.seed + 2)
    try:
        with Timer("Attention training", logger=logger), \
                profile_trace(ns.profile_dir if collectives.is_writer() else None):
            for i in range(ns.steps):
                sel = sel_rng.integers(0, len(x), batch)
                if mesh is None:
                    xs, ys = (torch.as_tensor(a).to(device)
                              for a in (x[sel], y[sel]))
                else:
                    xs, ys = shard_batch(mesh, x[sel], y[sel],
                                         axis=meshlib.DATA_AXIS,
                                         device=device)
                m = step(xs, ys)
                if i % 50 == 0 or i == ns.steps - 1:
                    loss, acc = float(m["loss"]), float(m["accuracy"])
                    print(f"step {i}, loss={loss:.4f}, accuracy={acc:.4f}")
                    if logger is not None:
                        logger.log(event="step", step=i, loss=loss,
                                   accuracy=acc)
        vm = evaluate(model, ArrayDataset(vx, vy), binary_cross_entropy,
                      batch_size=batch, with_auroc=True, mesh=mesh)
        print("val:", " ".join(f"{k}={v:.4f}" for k, v in vm.items()))
        if logger is not None:
            logger.log(event="val", **vm)
        _log_snapshot(logger)
    finally:
        if logger is not None:
            logger.close()


def _run_serve(ns):
    """The continuous-batching server (``serve/``) over an LM at the
    given widths -- random from --seed, or trained --train-steps steps on
    the counting task -- replaying a request trace (JSONL or synthetic
    Poisson arrivals) and reporting throughput, TTFT and occupancy, as
    the JAX package's ``serve`` verb does."""
    import json

    import numpy as np
    import torch

    from idc_models_tpu_torch import resolve_device
    from idc_models_tpu_torch.models.core import init_params
    from idc_models_tpu_torch.models.lm import AttentionLM, next_token_loss
    from idc_models_tpu_torch.observe import (
        SLO, JsonlLogger, MetricsExporter, SLOEngine, Timer, profile_trace,
    )
    from idc_models_tpu_torch.serve import (
        InjectedEngineCrash, LMServer, RetryPolicy, load_trace,
        poisson_trace,
    )

    for flag, kw, label in _LATER:
        dest = flag.lstrip("-").replace("-", "_")
        if getattr(ns, dest) != kw.get("default", False):
            sys.exit(f"serve {flag}: not ported yet (ROADMAP {label})")
    if ns.seq_parallel < 1:
        sys.exit(f"--seq-parallel {ns.seq_parallel} must be >= 1")
    if ns.seq_parallel > 1 or ns.tp > 1:
        sys.exit(f"serve --seq-parallel {ns.seq_parallel} --tp {ns.tp}: "
                 f"serving over several ranks is not ported yet "
                 f"(ROADMAP A9-dist)")
    if ns.fsdp not in (0, 1):
        sys.exit(f"--fsdp {ns.fsdp}: FSDP shards the optimizer+param "
                 f"state over the batch axis at TRAIN time; a serving "
                 f"engine holds no optimizer state and prefills [1, P] "
                 f"batches — use --tp for serving-side param sharding")
    if ns.tp < 0:
        sys.exit(f"--tp {ns.tp} must be >= 0 (0 = off)")
    if ns.temperature < 0.0:
        sys.exit(f"--temperature {ns.temperature} must be >= 0")
    if ns.prefill_chunk and (ns.prefill_chunk < 1
                             or ns.t_max % ns.prefill_chunk):
        sys.exit(f"--prefill-chunk {ns.prefill_chunk} must be >= 1 and "
                 f"divide --t-max {ns.t_max}")
    if ns.slo_ttft_p95_ms is not None and ns.slo_ttft_p95_ms <= 0:
        sys.exit(f"--slo-ttft-p95-ms {ns.slo_ttft_p95_ms} must be > 0")
    if (ns.slo_error_rate is not None
            and not 0.0 < ns.slo_error_rate < 1.0):
        sys.exit(f"--slo-error-rate {ns.slo_error_rate} must be a "
                 f"fraction in (0, 1)")
    if ns.slo_window_s <= 0:
        sys.exit(f"--slo-window-s {ns.slo_window_s} must be > 0")
    if ns.metrics_port is not None and not 0 <= ns.metrics_port <= 65535:
        sys.exit(f"--metrics-port {ns.metrics_port} must be in "
                 f"[0, 65535] (0 = OS-assigned)")
    if ns.max_retries < 0:
        sys.exit(f"--max-retries {ns.max_retries} must be >= 0")
    if ns.retry_backoff_ms < 0:
        sys.exit(f"--retry-backoff-ms {ns.retry_backoff_ms} must be "
                 f">= 0")
    device = resolve_device(ns.device)
    model = init_params(AttentionLM(
        ns.vocab, ns.t_max, embed_dim=ns.embed_dim, num_heads=ns.num_heads,
        mlp_dim=ns.mlp_dim, num_blocks=ns.num_blocks), ns.seed).to(device)
    if ns.train_steps > 0:
        from idc_models_tpu_torch.train.state import TrainState, rmsprop
        from idc_models_tpu_torch.train.step import make_train_step

        state = TrainState(model, rmsprop(model, 3e-3))
        step = make_train_step(state, next_token_loss)
        rng = np.random.default_rng(ns.seed + 1)
        with Timer("Serve pre-training"):
            for _ in range(ns.train_steps):
                starts = rng.integers(0, ns.vocab, (16, 1))
                seqs = torch.as_tensor((starts + np.arange(ns.t_max))
                                       % ns.vocab, device=device)
                m = step(seqs, seqs)
            print(f"pre-trained {ns.train_steps} steps, "
                  f"loss={float(m['loss']):.4f}")
    logger = (JsonlLogger(Path(ns.path) / "logs" / "serve.jsonl")
              if ns.path else None)
    slos = []
    if ns.slo_ttft_p95_ms is not None:
        slos.append(SLO.latency("ttft",
                                threshold_s=ns.slo_ttft_p95_ms / 1e3))
    if ns.slo_error_rate is not None:
        slos.append(SLO.rate("error_rate", budget=ns.slo_error_rate))
    slo = (SLOEngine(slos, short_window_s=ns.slo_window_s,
                     long_window_s=5.0 * ns.slo_window_s, logger=logger)
           if slos else None)
    retry = (RetryPolicy(max_retries=ns.max_retries,
                         backoff_s=ns.retry_backoff_ms / 1e3)
             if ns.max_retries > 0 else None)
    # armed before the server's warmup, so a scraper sees the process
    # from the start; taken down with the run
    exporter = None
    if ns.metrics_port is not None:
        try:
            exporter = MetricsExporter(port=ns.metrics_port).start()
        except OSError as e:
            sys.exit(f"serve: cannot bind --metrics-port "
                     f"{ns.metrics_port}: {e}")
        print(f"metrics: {exporter.url}/metrics  healthz: "
              f"{exporter.url}/healthz")
    try:
        server = LMServer(
            model, embed_dim=ns.embed_dim, num_heads=ns.num_heads,
            num_blocks=ns.num_blocks, t_max=ns.t_max, n_slots=ns.slots,
            window=ns.window, cache_dtype=torch.float32,
            temperature=ns.temperature, top_k=ns.top_k or None,
            eos_id=ns.eos, max_queue_depth=ns.max_queue_depth,
            max_prefills_per_cycle=ns.max_prefills_per_cycle,
            logger=logger, prefill_chunk=ns.prefill_chunk or None,
            kv_dtype=("int8" if ns.kv_dtype == "int8" else None),
            slo=slo, retry=retry, device=device)
        if ns.trace:
            trace = load_trace(ns.trace)
        else:
            trace = poisson_trace(
                ns.requests, rate_per_s=ns.rate, vocab=ns.vocab,
                t_max=ns.t_max, eos_id=ns.eos,
                prompt_lens=(2, max(ns.t_max // 4, 2)),
                budgets=(2, max(ns.t_max // 4, 2)), seed=ns.seed,
                sampled=ns.temperature > 0.0)
        print(f"serving {len(trace)} requests on {ns.slots} slots "
              f"(window {ns.window}, t_max {ns.t_max}, ring "
              f"{ns.seq_parallel})")
        crashed = None
        with Timer("Serving trace", logger=logger), \
                profile_trace(ns.profile_dir):
            try:
                results = server.run(trace, realtime=ns.realtime)
            except InjectedEngineCrash as e:
                # the failure cleanup already recorded every in-flight
                # request as an error Result
                crashed = e
                results = server.results()
        if crashed is not None:
            print(f"engine crashed mid-run (injected): {crashed}")
        n_ok = sum(r.status == "ok" for r in results)
        summary = server.summary()
        print(f"served: ok={n_ok} timeout={summary['serve_timed_out']} "
              f"rejected={summary['serve_rejected']} "
              f"tokens={summary['serve_tokens']}")
        # p95 TTFT = queue wait (add slots, shed load) + prefill compute
        # (shrink prompts, chunk smaller)
        if summary.get("serve_ttft_ms_p95") is not None:
            print(f"ttft p95 {summary['serve_ttft_ms_p95']} ms = "
                  f"queue-wait {summary['serve_queue_wait_ms_p95']} ms + "
                  f"prefill {summary['serve_prefill_ms_p95']} ms (p95s)")
        if slo is not None:
            names = sorted({a["slo"] for a in slo.alerts})
            print(f"slo: {len(slo.alerts)} alert(s)"
                  + (f" ({', '.join(names)})" if names else ""))
        if retry is not None or summary["serve_slot_faults"]:
            print(f"resilience: injected="
                  f"{summary['serve_faults_injected']}"
                  f" slot_faults={summary['serve_slot_faults']}"
                  f" retries={summary['serve_retries']}"
                  f" shed={summary['serve_shed']}"
                  f" clamped={summary['serve_clamped']}")
        print("serve summary:", json.dumps(summary))
        if logger is not None:
            logger.log(event="serve_summary", **summary)
        server.close()
        _log_snapshot(logger)
    finally:
        if exporter is not None:
            exporter.close()
        if logger is not None:
            logger.close()


def _run_stats(ns):
    """Offline run-log rollup (``observe/stats.py``) of any jsonl either
    package writes: run.jsonl, profile.jsonl, a tracer's span export."""
    import json

    from idc_models_tpu_torch.observe import (
        format_request_timeline, format_summary, summarize_jsonl,
    )

    paths = [Path(p) for p in ns.jsonl]
    for p in paths:
        if not p.exists():
            sys.exit(f"stats: no such file: {p}")
    summary = summarize_jsonl(paths[0] if len(paths) == 1 else paths)
    if ns.request is not None:
        try:
            text = format_request_timeline(summary, ns.request)
        except KeyError as e:
            sys.exit(f"stats: {e.args[0]}")
        if ns.json:
            print(json.dumps({ns.request: summary["requests"][ns.request]}))
        else:
            print(text)
    elif ns.json:
        print(json.dumps(summary))
    else:
        if ns.top < 1:
            sys.exit(f"stats: --top {ns.top} must be >= 1")
        print(format_summary(summary, top=ns.top))


def _run_profile(ns):
    """Performance attribution over one train step (``observe/profile.py``):
    the program's account from one counted real call, a roofline verdict
    against the device's roof, the device-wait vs host-gap split of a
    fenced pass, and the compile-churn watchdog -- printed, and written
    as ``profile_program`` / ``profile_step`` records."""
    import torch

    from idc_models_tpu_torch import collectives, resolve_device
    from idc_models_tpu_torch.observe import REGISTRY, JsonlLogger, trace
    from idc_models_tpu_torch.observe import profile as prof

    if ns.model == "serve":
        sys.exit("profile --model serve: its verify program and draft "
                 "LM are not ported yet (ROADMAP A9.3)")
    if ns.steps is not None and ns.steps < 1:
        sys.exit(f"profile: --steps {ns.steps} must be >= 1")
    if ns.batch_size is not None and ns.batch_size < 1:
        sys.exit(f"profile: --batch-size {ns.batch_size} must be >= 1")
    if ns.compile_limit < 1:
        sys.exit(f"profile: --compile-limit {ns.compile_limit} must "
                 f"be >= 1")
    if (ns.peak_tflops is None) != (ns.peak_gbps is None):
        sys.exit("profile: --peak-tflops and --peak-gbps declare the "
                 "two axes of one roofline -- pass both or neither")
    if ns.fsdp < 0 or ns.tp < 0:
        sys.exit(f"profile: --fsdp/--tp must be >= 0 (0 = off), got "
                 f"{ns.fsdp}/{ns.tp}")
    if (ns.fsdp > 1 or ns.tp > 1) and ns.model != "lm":
        sys.exit(f"profile: --fsdp/--tp shard the LM's rule-based "
                 f"partition layout (--model lm); the {ns.model} "
                 f"model's default rules are replicated")
    device = resolve_device(ns.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    if ns.peak_tflops is not None:
        try:
            prof.register_roof(kind, ns.peak_tflops, ns.peak_gbps)
        except ValueError as e:
            sys.exit(f"profile: {e}")
    wd = prof.arm_watchdog(limit=ns.compile_limit)
    # main()'s --trace-out context may already have armed a tracer (the
    # whole run then lands in the export); the timeline below reads only
    # the measured region either way
    own = trace.get_tracer() is None
    prev = trace.set_tracer(trace.Tracer()) if own else None
    tr = trace.get_tracer()
    try:
        if ns.model == "lm":
            progs, mark = _profile_lm(ns, device, kind)
        else:
            progs, mark = _profile_train_step(ns, device, kind)
        if ns.churn_drill:
            _profile_churn_drill(ns.compile_limit, device)
        records = prof.records_since(tr, mark)
    finally:
        prof.disarm_watchdog()
        if own:
            trace.set_tracer(prev)

    timeline = prof.DeviceTimeline().consume(records)
    step_stats = timeline.report()
    print("programs (performance attribution):")
    recs = []
    for cost, roofline, step_ms in progs.values():
        rec = prof.program_record(cost, roofline, step_ms=step_ms,
                                  device_kind=kind)
        recs.append(rec)
        print(prof.format_program(rec))
    print("step-time attribution (device-wait vs host-gap):")
    print(timeline.format_report(step_stats))
    rep = wd.report()
    line = (f"compiles: {rep['total_compiles']} observed, "
            f"{rep['compile_seconds_total']} s total")
    if rep["flagged"]:
        line += (f"; CHURN flagged: {', '.join(rep['flagged'])} "
                 f"(> {rep['limit']} compiles each -- a shape/dtype is "
                 f"varying per call)")
    else:
        line += "; churn: none"
    print(line)

    out_path = ns.out or (Path(ns.path) / "logs" / "profile.jsonl"
                          if ns.path else None)
    if out_path and collectives.is_writer():
        with JsonlLogger(out_path) as logger:
            for rec in recs:
                logger.log(event="profile_program", **rec)
            for loop, st in step_stats.items():
                logger.log(event="profile_step",
                           **prof.step_record(loop, st))
            REGISTRY.log_snapshot(logger)
        print(f"profile events written to {out_path}")


def _measure_steps(one_step, fence, steps: int):
    """The two measured passes of a profiled step, after its two warm-up
    steps: a throughput window (`steps` launches, one fence) for the
    roofline verdict, then a fenced pass (one ``device.sync`` wait per
    ``profile.step``) for the device-wait vs host-gap split. Returns
    (seconds a step, the trace mark where the measured region starts)."""
    import time

    from idc_models_tpu_torch.observe import profile as prof
    from idc_models_tpu_torch.observe import trace

    mark = prof.trace_mark(trace.get_tracer())
    t0 = time.perf_counter()
    for _ in range(steps):
        one_step()
    fence()
    step_s = (time.perf_counter() - t0) / steps
    for _ in range(steps):
        with trace.span("profile.step"):
            one_step()
            with trace.span("device.sync"):
                fence()
    return step_s, mark


def _profile_train_step(ns, device, kind: str):
    """Profile one backbone's fine-tune train step in bf16 at its bench
    configuration (``configs.BENCH_TRAIN_CONFIGS``; batch 8 on the CPU).
    The first of the two warm-up steps is the counted call of the
    program account."""
    import numpy as np
    import torch

    from idc_models_tpu_torch.configs import BENCH_TRAIN_CONFIGS
    from idc_models_tpu_torch.models import core, mobilenet, registry
    from idc_models_tpu_torch.models.small_cnn import small_cnn
    from idc_models_tpu_torch.observe import profile as prof
    from idc_models_tpu_torch.ops import fused_conv
    from idc_models_tpu_torch.train.losses import (
        binary_cross_entropy, sparse_categorical_cross_entropy,
    )
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step

    on_card = device.type == "cuda"
    if ns.model == "small":
        cfg = dict(model=None, image=10, outputs=1, ft=None, lr=1e-3,
                   batch=64)
    else:
        name = {"vgg": "vgg16", "mobile": "mobilenet_v2",
                "dense": "densenet201"}[ns.model]
        bc = BENCH_TRAIN_CONFIGS[name]
        cfg = dict(model=name, image=bc["image_size"],
                   outputs=bc["num_outputs"], ft=bc["fine_tune_at"],
                   lr=bc["lr"], batch=bc["batch_per_chip"])
    batch = ns.batch_size or (cfg["batch"] if on_card else 8)
    steps = ns.steps or (30 if on_card else 4)
    if cfg["model"] is None:
        model = core.init_params(small_cnn(cfg["image"], 3, cfg["outputs"]),
                                 ns.seed).to(device)
        core.use_generator(model, torch.Generator(device=device)
                           .manual_seed(ns.seed + 2))
        opt = rmsprop(model, cfg["lr"])
    else:
        spec = registry.get_model(cfg["model"])
        # BN-freeze only exists on the BN backbones (VGG has none)
        build_kw = ({"bn_frozen_below": cfg["ft"]}
                    if ns.model in ("mobile", "dense") else {})
        if ns.model == "mobile":
            build_kw["depthwise_impl"] = ns.depthwise_impl
        model = core.init_params(spec.build(cfg["outputs"], **build_kw),
                                 ns.seed).to(device)
        opt = rmsprop(model, cfg["lr"], trainable_mask=spec.fine_tune_mask(
            model, cfg["ft"]))
    loss_fn = (binary_cross_entropy if cfg["outputs"] == 1
               else sparse_categorical_cross_entropy)
    step = make_train_step(TrainState(model, opt), loss_fn,
                           compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(ns.seed)
    s = cfg["image"]
    x = torch.as_tensor(rng.random((batch, s, s, 3), np.float32),
                        device=device)
    y = torch.as_tensor(rng.integers(0, max(cfg["outputs"], 2), batch)
                        .astype(np.int32), device=device)
    first = next(model.parameters())

    def one_step():
        step(x, y)

    def fence():
        return float(first.detach().float().sum())   # waits for the card

    cost, _ = prof.program_report(step, x, y, name="train.step",
                                  arguments=(model, opt))
    if (ns.model == "mobile" and ns.depthwise_impl == "fused"
            and on_card):
        # the fused chains whose BN is frozen launch the CUDA kernel, a
        # ctypes call the op count cannot see: merge their analytic
        # account, counted at the step's bf16 (itemsize 2)
        n_fused = mobilenet.fused_chain_count(cfg["ft"], train=True)
        k_flops, k_bytes = fused_conv.depthwise_chain_cost(
            mobilenet.fused_call_shapes(batch, s)[:n_fused], itemsize=2)
        cost = prof.augment_cost(cost, flops=k_flops,
                                 bytes_accessed=k_bytes)
    cost = prof.register_cost("train.step", cost)
    one_step()
    fence()                                  # warm + fence
    step_s, mark = _measure_steps(one_step, fence, steps)
    roofline = prof.roofline_verdict(cost, step_s, kind)
    print(f"profile: train.step ({cfg['model'] or 'small_cnn'}, batch "
          f"{batch} on {kind}, bf16, {steps} steps)")
    print(f"  throughput {batch / step_s:.1f} patches/sec, "
          f"{step_s * 1e3:.2f} ms/step")
    if cost.peak_hbm_bytes is not None:
        print(f"  peak memory: {cost.peak_hbm_bytes / 2**20:.2f} MiB")
    return {"train.step": (cost, roofline, step_s * 1e3)}, mark


def _profile_lm(ns, device, kind: str):
    """Profile the LM train step, f32 with the plain (jnp) block, at the
    JAX package's accelerator configuration on the card (vocab 8192,
    embed 1024, 4 blocks, T=512, batch 8) and a small one on the CPU;
    with --fsdp/--tp the step of the rule-sharded LM on an (fsdp, tp)
    mesh, its account this rank's."""
    import numpy as np

    from idc_models_tpu_torch import collectives
    from idc_models_tpu_torch import mesh as meshlib
    from idc_models_tpu_torch.models import registry
    from idc_models_tpu_torch.models.core import init_params
    from idc_models_tpu_torch.models.lm import (
        AttentionLM, make_lm_train_step, next_token_loss,
    )
    from idc_models_tpu_torch.observe import profile as prof
    from idc_models_tpu_torch.train.state import TrainState, rmsprop
    from idc_models_tpu_torch.train.step import make_train_step, shard_batch

    if device.type == "cuda":
        vocab, e, mlp, heads, blocks, seq_len = 8192, 1024, 4096, 8, 4, 512
    else:
        vocab, e, mlp, heads, blocks, seq_len = 512, 128, 512, 4, 2, 64
    sharded = ns.fsdp > 1 or ns.tp > 1
    f, t = max(ns.fsdp, 1), max(ns.tp, 1)
    n_dev = collectives.axis_size()
    if f * t > n_dev:
        sys.exit(f"profile: --fsdp {f} x --tp {t} needs {f * t} "
                 f"devices, have {n_dev} (use --host-devices)")
    mesh = meshlib.fsdp_tp_mesh(f, t, 1)
    batch = ns.batch_size or (8 if device.type == "cuda" else 4)
    if batch % f:
        sys.exit(f"profile: --batch-size {batch} must divide by "
                 f"--fsdp {f} (the batch shards over the same 'data' "
                 f"axis the params shard over)")
    if mesh.coords is None:
        sys.exit(f"profile: rank {collectives.axis_index()} is outside "
                 f"the {f} x {t} mesh; run {f * t} ranks")
    steps = ns.steps or (30 if device.type == "cuda" else 4)
    model = init_params(AttentionLM(
        vocab, seq_len, embed_dim=e, num_heads=heads, mlp_dim=mlp,
        num_blocks=blocks, mesh=mesh if sharded else None),
        ns.seed).to(device)
    opt = rmsprop(model if not sharded else model.shard_(
        registry.get_partition_rules("lm")), 3e-3)
    step = (make_lm_train_step(TrainState(model, opt), global_batch=batch)
            if sharded else
            make_train_step(TrainState(model, opt), next_token_loss))
    rng = np.random.default_rng(ns.seed + 1)
    seqs = shard_batch(mesh, (rng.integers(0, vocab, (batch, 1))
                              + np.arange(seq_len)) % vocab,
                       axis=meshlib.DATA_AXIS, device=device)

    def one_step():
        step(seqs, seqs)

    def fence():
        return float(model.embed.detach().sum())     # waits for the card

    cost, _ = prof.register_program("train.step", step, seqs, seqs,
                                    arguments=(model, opt))
    one_step()
    fence()                                  # warm + fence
    step_s, mark = _measure_steps(one_step, fence, steps)
    roofline = prof.roofline_verdict(cost, step_s, kind)
    layout = (f"fsdp={f}, tp={t} (rule set 'lm': params + optimizer "
              f"state sharded)" if sharded else "replicated")
    print(f"profile: train.step (lm {e}x{blocks}, vocab {vocab}, seq "
          f"{seq_len}, batch {batch} global, f32, {steps} steps) -- "
          f"{layout}")
    print(f"  {step_s * 1e3:.2f} ms/step")
    if cost.peak_hbm_bytes is not None:
        print(f"  per-rank peak memory: {cost.peak_hbm_bytes / 2**20:.2f} "
              f"MiB over {mesh.size} rank(s)")
    return {"train.step": (cost, roofline, step_s * 1e3)}, mark


def _profile_churn_drill(limit: int, device) -> None:
    """The injected recompile loop: a ``torch.compile``d reduction
    (eager backend, static shapes) called with a different shape every
    iteration, so the watchdog's churn detector fires on
    ``churn.drill``. Dynamo's own recompile limit is raised above the
    drill's count for the drill only."""
    import torch
    import torch._dynamo

    from idc_models_tpu_torch.observe import profile as prof

    cfg = torch._dynamo.config
    key = ("recompile_limit" if hasattr(cfg, "recompile_limit")
           else "cache_size_limit")
    saved = getattr(cfg, key)
    setattr(cfg, key, max(saved, limit + 4))
    try:
        f = torch.compile(lambda t: torch.sum(t * 2.0), backend="eager",
                          dynamic=False)
        with prof.compiling("churn.drill"):
            for n in range(limit + 2):
                float(f(torch.zeros((n + 1,), device=device)))
    finally:
        setattr(cfg, key, saved)
        torch._dynamo.reset()
