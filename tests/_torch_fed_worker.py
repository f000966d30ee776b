"""One rank of the port's federated-rounds-over-ranks check (the FedAvg,
secure and population rounds over a "client" mesh). It imports torch and
the port only, never JAX.

    python tests/_torch_fed_worker.py STORE WORLD RANK OUT
    python tests/_torch_fed_worker.py --init OUT
    python tests/_torch_fed_worker.py --pod WORLD OUT [--cpu]
    python tests/_torch_fed_worker.py --compare WANT.npz GOT.npz

Every rank joins a world of WORLD (4) ranks through
`mesh.initialize_multihost`, the shared file STORE its rendezvous, reads
the dropout-free model's initial weights from OUT/inputs.npz (written by
`tests/test_torch_fed_ranks.py` from the JAX package's init, or by
`--init` from the port's own) and runs the same program on
``mesh.client_mesh(4)``:

- FedAvg over 8 clients, two of them of weight 0 (mean), and with the
  trimmed mean, and under a fault plan over two rounds;
- the secure round over 6 clients padded to 8 slots (2 dummies), with
  the threefry and the pallas mask (the kernel on a card), and over 3
  clients on a mesh of 3 with rank 3 outside it;
- `secure_aggregate` alone over 6 seeded client updates in 8 slots, both
  mask impls: integer arithmetic from the same inputs on any device;
- the population round, 2 waves of 4, with and without the replicated
  partition rules.

Rank 0 also runs every case with no mesh (the port's one-rank rounds)
and writes both to OUT/results.npz; every rank writes the servers it
returned to OUT/rank{RANK}.npz. Where the ranks see cards, each takes
one (NCCL, TF32 off, cuDNN deterministic); `--compare` holds such a
run's results against a gloo run's: the secure aggregate's protected
leaves bit for bit, and within each run the trained secure rounds'
protected leaves on 4 ranks bit for bit against 1 rank's (trained on
another device, their updates round differently); every other array
within 1e-4 of its largest value. `--pod` starts WORLD
ranks of this script on OUT (on the cards it sees, or with `--cpu` on
the CPU) and waits for them.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from idc_models_tpu_torch import convert, faults, mesh  # noqa: E402
from idc_models_tpu_torch.data import synthetic  # noqa: E402
from idc_models_tpu_torch.federated import (  # noqa: E402
    ClientPopulation, CohortSampler, ServerState, get_aggregator,
    make_fedavg_round, make_population_round,
)
from idc_models_tpu_torch.federated.fedavg import ClientLayout  # noqa: E402
from idc_models_tpu_torch.models import core, registry  # noqa: E402
from idc_models_tpu_torch.ops import secure_masking_kernel as smk  # noqa: E402
from idc_models_tpu_torch.secure import fedavg as secure  # noqa: E402
from idc_models_tpu_torch.secure import masking  # noqa: E402
from idc_models_tpu_torch.train.losses import (  # noqa: E402
    binary_cross_entropy,
)

WORLD = 4
DEVICE = torch.device("cpu")
# --compare: |got - want| <= TOL * (1 + max |want|), secure protected
# leaves exactly
COMPARE_TOL = 1e-4
LR = 1e-3
# FedAvg: 8 clients of 16 examples, one full-shard step a round (the two
# packages' permutations differ), two clients of weight 0
N_FED, SHARD, FED_SEED = 8, 16, 2
FED_WEIGHTS = np.array([16, 12, 0, 16, 8, 0, 16, 12], np.float32)
FAULTS, FAULT_ROUNDS = "crash:3,nan:4,straggler:1:1,sign_flip:6:x5", 2
# the secure round: 6 real clients on 4 ranks (8 slots), 2 local epochs
N_SECURE, SECURE_SEED, SECURE_EPOCHS, PERCENT = 6, 4, 2, 0.5
SECURE_IMPLS = ("threefry", "pallas")
# the population round: 64 virtual clients, a cohort of 8 in waves of 4
POPULATION, COHORT, WAVE, POP_EXAMPLES = 64, 8, 4, 8


def seq_model() -> core.Sequential:
    """The dropout-free model (SAME conv, max pool, dense head)."""
    return core.Sequential(
        [core.Conv2d(3, 4, 3, name="c1"), core.ReLU(),
         core.MaxPool(2, name="pool"), core.Flatten(),
         core.Dense(100, 1, name="head")], name="seq")


def client_data(n: int, seed: int):
    imgs, labels = synthetic.make_idc_like(n * SHARD, size=10, seed=seed)
    return (imgs.astype(np.float32).reshape(n, SHARD, 10, 10, 3),
            labels.reshape(n, SHARD))


def protected(model) -> list[str]:
    """The leaves the secure round masks at PERCENT (dotted names)."""
    params = dict(model.named_parameters())
    state = dict(model.named_buffers())
    pf, sf = masking.first_fraction_selection_weights(
        params, state, PERCENT, getattr(model, "layer_names", None))
    return sorted(n for n, f in {**pf, **sf}.items() if f)


def model_from(inputs) -> core.Sequential:
    model = seq_model()
    tree = convert.unflatten({k[len("seq/"):]: v for k, v in inputs.items()
                              if k.startswith("seq/")})
    return convert.load_jax(model, tree["params"], tree.get("state"))


def host(server: ServerState, prefix: str) -> dict:
    out = {f"{prefix}/round": np.asarray(server.round)}
    for k, v in {**server.params, **server.state}.items():
        out[f"{prefix}/{k}"] = v.detach().cpu().numpy()
    return out


def metrics(m: dict, prefix: str) -> dict:
    return {f"{prefix}/m/{k}": np.asarray(v, np.float64) for k, v in
            m.items()}


def fed_case(inputs, m, name, *, aggregator=None, spec=None, rounds=1):
    model = model_from(inputs)
    plan = faults.parse_fault_spec(spec, N_FED) if spec else None
    agg_kw = {"trim": 1} if aggregator == "trimmed_mean" else {}
    rnd = make_fedavg_round(model, LR, binary_cross_entropy, local_epochs=1,
                            batch_size=SHARD,
                            aggregator=get_aggregator(aggregator, **agg_kw),
                            faults=plan, mesh=m, device=DEVICE)
    imgs, labels = client_data(N_FED, FED_SEED)
    server = ServerState.of(model)
    out = {}
    for r in range(rounds):
        server, met = rnd(server, torch.as_tensor(imgs),
                          torch.as_tensor(labels), FED_WEIGHTS, (1, r, 0),
                          round_idx=r)
        out.update(metrics(met, f"{name}/r{r}"))
    out.update(host(server, name))
    return out


def secure_case(inputs, m, name, impl, n_clients=N_SECURE):
    model = model_from(inputs)
    rnd = secure.make_secure_fedavg_round(
        model, LR, binary_cross_entropy, percent=PERCENT,
        local_epochs=SECURE_EPOCHS, batch_size=SHARD, mask_impl=impl,
        mesh=m, device=DEVICE)
    imgs, labels = client_data(n_clients, SECURE_SEED)
    before = smk.KERNEL.launches
    server, met = rnd(ServerState.of(model), torch.as_tensor(imgs),
                      torch.as_tensor(labels),
                      torch.Generator().manual_seed(1))
    out = host(server, name)
    out.update(metrics(met, name))
    out[f"{name}/launches"] = np.asarray(smk.KERNEL.launches - before)
    return out


def aggregate_case(inputs, m, name, impl):
    """`secure_aggregate` over N_SECURE seeded client updates (the
    model's weights plus noise), padded to whole slots on `m`: each rank
    aggregates its block of slots under their global ids."""
    model = model_from(inputs)
    lay = ClientLayout.of(m)
    n_total = N_SECURE + (-N_SECURE % lay.size)
    k = n_total // lay.size
    rng = np.random.default_rng(7)
    glob_p = {n: p.detach() for n, p in model.named_parameters()}
    glob_s = {n: b.detach() for n, b in model.named_buffers()}

    def stacked(tree):
        out = {}
        for n, v in tree.items():
            noise = rng.standard_normal((N_SECURE,) + tuple(v.shape))
            x = v.numpy()[None] + 0.05 * noise.astype(np.float32)
            x = np.concatenate([x, np.zeros((n_total - N_SECURE,)
                                            + x.shape[1:], np.float32)])
            out[n] = torch.as_tensor(
                x[lay.index * k:(lay.index + 1) * k]).to(DEVICE)
        return out

    client_p, client_s = stacked(glob_p), stacked(glob_s)
    params, state, met = secure.secure_aggregate(
        client_p, client_s, {n: v.to(DEVICE) for n, v in glob_p.items()},
        {n: v.to(DEVICE) for n, v in glob_s.items()}, percent=PERCENT,
        layer_order=getattr(model, "layer_names", None), mask_impl=impl,
        mask_key=(7, 9), first=lay.index * k, n_total=n_total,
        n_real=N_SECURE, group=lay.group)
    out = host(ServerState(0, params, state), name)
    out.update(metrics({k_: float(v) for k_, v in met.items()}, name))
    return out


def population_case(inputs, m, name, rules=None):
    model = model_from(inputs)
    pop = ClientPopulation(POPULATION, examples_per_client=POP_EXAMPLES,
                           image_size=10, seed=0)
    sampler = CohortSampler(pop, COHORT, seed=1)
    rnd = make_population_round(model, LR, binary_cross_entropy, pop,
                                sampler, wave_size=WAVE,
                                batch_size=POP_EXAMPLES, mesh=m,
                                rules=rules, device=DEVICE)
    server, met = rnd(ServerState.of(model), key=(2,), round_idx=0)
    out = host(server, name)
    out.update(metrics(met, name))
    return out


def run(inputs, rank: int) -> tuple[dict, dict]:
    """(rank 0's results, this rank's servers) of every case."""
    m4 = mesh.client_mesh(WORLD)
    m3 = mesh.client_mesh(3)
    results: dict = {}
    mine: dict = {}

    def both(name, fn, *args, **kw):
        got = fn(inputs, m4, f"{name}4", *args, **kw)
        mine.update(got)
        results.update(got)
        if rank == 0:       # the port's one-rank round: no mesh
            results.update(fn(inputs, None, f"{name}1", *args, **kw))

    both("fed", fed_case)
    both("trim", fed_case, aggregator="trimmed_mean")
    both("faults", fed_case, spec=FAULTS, rounds=FAULT_ROUNDS)
    for impl in SECURE_IMPLS:
        both(f"secure_{impl}", secure_case, impl)
        both(f"secure_agg_{impl}", aggregate_case, impl)
    both("pop", population_case)
    rules = population_case(inputs, m4, "pop4rules",
                            registry.REPLICATED_RULES)
    results.update(rules)
    mine.update(rules)
    # three clients on a mesh of three: rank 3 is outside it
    outside = secure_case(inputs, m3, "secure3", "threefry", n_clients=3)
    results.update(outside)
    mine.update(outside)
    results["secure_protected"] = np.asarray(protected(seq_model()))
    return results, mine


def init_inputs(out: Path) -> None:
    """OUT/inputs.npz from the port's seed-0 init of the model."""
    params, state = convert.to_jax(core.init_params(seq_model(), 0))
    flat = {f"seq/params/{k}": v
            for k, v in convert.flatten(params).items()}
    flat.update({f"seq/state/{k}": v
                 for k, v in convert.flatten(state).items()})
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "inputs.npz", **flat)


def pod(world: int, out: Path, cpu: bool) -> int:
    """Start `world` ranks of this script on `out` and wait for them;
    the first nonzero exit code, or 0."""
    import subprocess

    out = out.resolve()
    env = dict(os.environ, OMP_NUM_THREADS=os.environ.get(
        "OMP_NUM_THREADS", "1"))
    if cpu:
        env["CUDA_VISIBLE_DEVICES"] = ""
    (out / "store").unlink(missing_ok=True)
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(out / "store"), str(world), str(r),
         str(out)], env=dict(env, LOCAL_RANK=str(r)),
        stdout=open(out / f"log.{r}", "w"), stderr=subprocess.STDOUT)
        for r in range(world)]
    codes = [p.wait() for p in procs]
    print(f"pod of {world} on {out}: exit codes {codes}")
    return next((c for c in codes if c), 0)


def compare(want_path: str, got_path: str) -> int:
    """Hold a run's results against another's (a card run against a gloo
    run): the secure aggregate's protected leaves bit for bit, the
    trained secure rounds' protected leaves bit for bit between their 4-
    and 1-rank runs within `got`, every other array (the launch counts
    aside) within COMPARE_TOL of the reference's largest value. Prints
    the worst relative error by case; returns 1 past the bar."""
    want, got = dict(np.load(want_path)), dict(np.load(got_path))
    prot = set(str(p) for p in want["secure_protected"])
    worst: dict[str, float] = {}
    exact_bad = []
    for k in sorted(set(want) & set(got)):
        if k == "secure_protected" or k.endswith("/launches"):
            continue
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        case, _, leaf = k.partition("/")
        if case.startswith("secure_agg") and leaf in prot:
            if not np.array_equal(w, g):
                exact_bad.append(k)
            continue
        if (case.startswith("secure_") and case.endswith("4")
                and leaf in prot and not np.array_equal(
                    got[k], got[case[:-1] + "1/" + leaf])):
            exact_bad.append(f"{k} (4 ranks against 1, within the run)")
        err = float(np.abs(g - w).max()) / (1.0 + float(np.abs(w).max()))
        worst[case] = max(worst.get(case, 0.0), err)
    missing = sorted(set(want) ^ set(got))
    for case, err in worst.items():
        print(f"{case}: {err!r}")
    bad = {c: e for c, e in worst.items() if not e <= COMPARE_TOL}
    print(f"{len(worst)} cases, worst {max(worst.values())!r}, bar "
          f"{COMPARE_TOL}; past it: {bad}; protected leaves not bit-equal: "
          f"{exact_bad}; keys in one file only: {missing}")
    return 1 if bad or exact_bad or missing else 0


def main(store: str, world: int, rank: int, out: Path) -> None:
    global DEVICE
    torch.set_num_threads(1)
    mesh.PROCESS_GROUP_TIMEOUT_S = 120.0
    mesh.initialize_multihost(f"file://{store}", world, rank)
    if torch.cuda.is_available():
        DEVICE = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
    try:
        inputs = dict(np.load(out / "inputs.npz"))
        results, mine = run(inputs, rank)
        np.savez(out / f"rank{rank}.npz", **mine)
        dist.barrier()
        if rank == 0:
            np.savez(out / "results.npz", **results)
        (out / f"done.{rank}").write_text("ok")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    if sys.argv[1] == "--init":
        sys.exit(init_inputs(Path(sys.argv[2])))
    if sys.argv[1] == "--pod":
        sys.exit(pod(int(sys.argv[2]), Path(sys.argv[3]),
                     "--cpu" in sys.argv[4:]))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
