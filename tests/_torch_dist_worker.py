"""One rank of the port's distribution-layer check, over gloo on the CPU.
It imports torch and the port only, never JAX.

    python tests/_torch_dist_worker.py STORE WORLD RANK OUT
    python tests/_torch_dist_worker.py --compare WANT.npz GOT.npz

Every rank joins a world of WORLD ranks through
`mesh.initialize_multihost`, the shared file STORE its rendezvous, reads
the JAX package's initial weights from OUT/inputs.npz (written by
`tests/test_torch_dist.py`) and runs the same program: data parallelism
with BatchNorm over the global batch, the channel rule's dp x tp, the LM
sharded by LM_RULES (FSDP, TP, the sequence ring), the
sequence-sharded attention classifier and the padded eval batch. Rank 0
writes what the checks need to OUT/results.npz.

Where the ranks see cards, each takes one (NCCL, TF32 off) and the same
program runs there; `--compare` then holds such a run's results against
a gloo run's on the CPU, every array within 1e-4 of its largest value
(the dropout cases draw from another generator on the card, so their
four-ranks-equal-one check runs within the card's results instead).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from idc_models_tpu_torch import collectives, convert, mesh, tp  # noqa: E402
from idc_models_tpu_torch.data.idc import ArrayDataset  # noqa: E402
from idc_models_tpu_torch.models import core, registry  # noqa: E402
from idc_models_tpu_torch.models.attention import (  # noqa: E402
    AttentionClassifier,
)
from idc_models_tpu_torch.models.lm import (  # noqa: E402
    AttentionLM, make_lm_train_step,
)
from idc_models_tpu_torch.models.small_cnn import small_cnn  # noqa: E402
from idc_models_tpu_torch.train import loop  # noqa: E402
from idc_models_tpu_torch.train.losses import (  # noqa: E402
    binary_cross_entropy,
)
from idc_models_tpu_torch.train.state import TrainState, rmsprop  # noqa: E402
from idc_models_tpu_torch.train.step import (  # noqa: E402
    make_train_step, place_state, replicate, shard_batch,
)

WORLD = 4
# where the tensors live: the CPU, or this rank's card (`main`)
DEVICE = torch.device("cpu")
# --compare: |got - want| <= TOL * (1 + max |want|) for every array
COMPARE_TOL = 1e-4
# the BN CNN of the data-parallel cases (no dropout: the JAX package's
# stream cannot be drawn here), its batch, steps and learning rate
CNN_BATCH, CNN_SIZE, DP_STEPS, TP_STEPS, CNN_LR = 64, 10, 5, 8, 1e-3
# the small CNN (dropout 0.25 and 0.5) of the n-ranks-equal-one case
DROPOUT_SEED = 11
# BatchNorm on shards whose means differ
BN_ROWS, BN_C = 6, 5
# the LM: vocab, T, width, heads, MLP width, blocks, global batch, lr
LM = dict(vocab=64, seq_len=64, embed_dim=32, num_heads=4, mlp_dim=48,
          num_blocks=2)
LM_BATCH, LM_STEPS, LM_LR = 4, 3, 3e-3
# (fsdp, tp, seq, layout, rules) of each LM case: under LM_RULES on
# fsdp_tp_mesh, or (rules False) replicated on the verb's default
# data_seq_mesh, fsdp then counting the data ranks
LM_CASES = [(2, 2, 1, "contiguous", True), (4, 1, 1, "contiguous", True),
            (1, 4, 1, "contiguous", True), (1, 3, 1, "contiguous", True),
            (1, 2, 2, "contiguous", True), (1, 2, 2, "zigzag", True),
            (2, 1, 2, "zigzag", False)]
# the attention classifier over a ring of 4
ATT = dict(seq_len=64, features_in=8, embed_dim=16, num_heads=2,
           mlp_dim=32, num_blocks=2)
ATT_BATCH, ATT_RING = 4, 4
ATT_LAYOUTS = ("contiguous", "zigzag")
# the padded eval batch: 70 examples at batch 16 over 4 ranks
EVAL_N, EVAL_BATCH = 70, 16


def dev(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(DEVICE)


def host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def lm_key(f, t, s, layout, rules) -> str:
    return f"lm_f{f}_t{t}_s{s}_{layout}" + ("" if rules else "_replicated")


def cnn_data(seed: int):
    from idc_models_tpu_torch.data import synthetic

    x, y = synthetic.make_idc_like(CNN_BATCH, size=CNN_SIZE, seed=seed)
    return x.astype(np.float32), y


def lm_tokens() -> np.ndarray:
    rng = np.random.default_rng(0)
    return ((rng.integers(0, LM["vocab"], (LM_BATCH, 1))
             + np.arange(LM["seq_len"])) % LM["vocab"]).astype(np.int64)


def att_data():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (ATT_BATCH, ATT["seq_len"], ATT["features_in"]))
    return x.astype(np.float32), np.asarray([0, 1, 1, 0], np.int32)


def bn_shards() -> np.ndarray:
    """[WORLD, rows, C]: rank r's rows centred at 3r, so per-rank
    variances badly underestimate the global one."""
    rng = np.random.default_rng(5)
    return np.stack([rng.normal(3.0 * r, 1.0 + r, (BN_ROWS, BN_C))
                     for r in range(WORLD)]).astype(np.float32)


def bn_cnn() -> core.Sequential:
    """conv -> BN -> relu -> flatten -> dense, the JAX test's layers. The
    conv has no bias: one feeding a train-mode BN has a zero gradient
    plus rounding, which RMSprop's first steps amplify."""
    return core.Sequential([
        core.Conv2d(3, 8, 3, stride=2, padding="SAME", use_bias=False,
                    name="conv1"),
        core.BatchNorm(8, name="bn1"),
        core.ReLU(),
        core.Flatten(),
        core.Dense(5 * 5 * 8, 1, name="head"),
    ], name="bn_cnn")


def tree_of(inputs: dict, prefix: str) -> dict:
    return convert.unflatten({k[len(prefix) + 1:]: v for k, v in
                              inputs.items() if k.startswith(prefix + "/")})


def flat_np(tree, prefix: str) -> dict:
    return {f"{prefix}/{k}": np.asarray(v)
            for k, v in convert.flatten(tree).items()}


# the torch.distributed calls `counted` watches
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "reduce_scatter_tensor", "broadcast", "batch_isend_irecv")


def counted(fn):
    """(fn(), how many torch.distributed collectives it called)."""
    calls = []
    real = {n: getattr(dist, n) for n in COLLECTIVES}

    def watch(name):
        def call(*args, **kwargs):
            calls.append(name)
            return real[name](*args, **kwargs)
        return call

    try:
        for n in COLLECTIVES:
            setattr(dist, n, watch(n))
        return fn(), len(calls)
    finally:
        for n, f in real.items():
            setattr(dist, n, f)


def train_cnn(inputs, grid, steps: int, data_seed: int):
    """The BN CNN from the JAX weights for `steps` steps on the global
    batch, data-parallel over `grid` (or alone): losses, final params,
    the train state and how many collectives the steps called."""
    model = convert.load_jax(bn_cnn(), tree_of(inputs, "cnn_params"),
                             tree_of(inputs, "cnn_state")).to(DEVICE)
    state = TrainState(model, rmsprop(model, CNN_LR))
    if grid is not None:
        state = place_state(grid, state)
    step = make_train_step(state, binary_cross_entropy, mesh=grid)
    x, y = cnn_data(data_seed)
    if grid is not None:
        x, y = shard_batch(grid, x, y, device=DEVICE)
    else:
        x, y = dev(x), dev(y)
    losses, calls = counted(
        lambda: [float(step(x, y)["loss"]) for _ in range(steps)])
    return losses, convert.to_jax(model), state, calls


def dp_cases(inputs) -> dict:
    res = {}
    grid = mesh.data_mesh(WORLD)
    for name, g in (("dp4", grid), ("dp1", None)):
        losses, (params, buffers), _, calls = train_cnn(
            inputs, g, DP_STEPS, 1)
        res[f"{name}_losses"] = np.asarray(losses)
        res[f"{name}_collectives"] = np.asarray(calls)
        res.update(flat_np(params, f"{name}_params"))
        res.update(flat_np(buffers, f"{name}_state"))
    # dp 2 x tp 2 (the channel rule) against dp 4
    dptp = tp.dp_tp_mesh(2)
    for name, g in (("tp_dp4", grid), ("tp_dp2x2", dptp)):
        losses, (params, _), state, _ = train_cnn(inputs, g, TP_STEPS, 0)
        res[f"{name}_losses"] = np.asarray(losses)
        res.update(flat_np(params, f"{name}_params"))
        if name == "tp_dp2x2":
            # the stored blocks: this rank's share of each moment
            res["tp_moment_shapes"] = np.asarray(
                [list(b.shape) + [0] * (4 - b.dim())
                 for b in state.optimizer.blocks])
            res["tp_full_shapes"] = np.asarray(
                [list(p.shape) + [0] * (4 - p.dim())
                 for p in state.model.parameters()])
    # the small CNN's dropout: 4 ranks draw the masks one rank draws
    x, y = cnn_data(2)
    for name, g in (("drop4", grid), ("drop1", None)):
        model = core.init_params(small_cnn(10, 3, 1), 0).to(DEVICE)
        core.use_generator(model, torch.Generator(DEVICE).manual_seed(
            DROPOUT_SEED))
        step = make_train_step(TrainState(model, rmsprop(model, CNN_LR)),
                               binary_cross_entropy, mesh=g)
        xs, ys = (shard_batch(g, x, y, device=DEVICE) if g is not None
                  else (dev(x), dev(y)))
        losses, calls = counted(
            lambda: [float(step(xs, ys)["loss"]) for _ in range(3)])
        res[f"{name}_losses"] = np.asarray(losses)
        res[f"{name}_collectives"] = np.asarray(calls)
        res.update(flat_np(convert.to_jax(model)[0], f"{name}_params"))
    return res


def bn_case() -> dict:
    """Train-mode BN over the data group on each rank's shard: the output
    rows, the moving statistics and the gradients of sum(out * g)."""
    me = collectives.axis_index()
    grid = mesh.data_mesh(WORLD)
    bn = core.BatchNorm(BN_C, name="bn")
    core.init_params(bn, 0).to(DEVICE)
    core.sync_batch_norm(bn, grid.group(mesh.DATA_AXIS))
    x = dev(bn_shards()[me]).requires_grad_()
    g = dev(np.arange(BN_ROWS * BN_C, dtype=np.float32)
            .reshape(BN_ROWS, BN_C) / 7.0 - 1.0)
    bn.train()
    out = bn(x)
    (out * g).sum().backward()
    group = grid.group(mesh.DATA_AXIS)
    return {"bn_out": host(collectives.all_gather(out.detach(), group,
                                                  tiled=True)),
            "bn_dx": host(collectives.all_gather(x.grad, group, tiled=True)),
            "bn_dscale": host(collectives.psum(bn.scale.grad, group)),
            "bn_dbias": host(collectives.psum(bn.bias.grad, group)),
            "bn_mean": host(bn.mean), "bn_var": host(bn.var)}


def tree_case() -> dict:
    """shard_tree on a 2 x 2 ("data", "model") mesh, then gather_tree."""
    from idc_models_tpu_torch import partition

    grid = tp.dp_tp_mesh(2)
    rules = partition.PartitionRules((
        (r"w$", mesh.P(mesh.DATA_AXIS, mesh.MODEL_AXIS)),
        (r"v$", mesh.P((mesh.DATA_AXIS, mesh.MODEL_AXIS))), (r".*", mesh.P())))
    tree = {"w": np.arange(32.0).reshape(4, 8), "v": np.arange(8.0),
            "b": np.ones((3,))}
    blocks = partition.shard_tree(grid, rules, tree, device=DEVICE)
    back = partition.gather_tree(grid, blocks, rules.specs(tree, mesh=grid))
    # replicate: every rank's model becomes rank 0's
    model = core.init_params(small_cnn(10, 3, 1),
                             collectives.axis_index()).to(DEVICE)
    replicate(grid, model)
    flat = torch.cat([t.reshape(-1) for t in model.state_dict().values()])
    return {"tree_block_w": host(blocks["w"]),
            "tree_block_v": host(blocks["v"]),
            "replicated": host(collectives.all_gather(flat)),
            **{f"tree_back/{k}": host(v) for k, v in back.items()}}


def lm_case(inputs, f, t, s, layout, rules) -> dict:
    grid = mesh.fsdp_tp_mesh(f, t, s) if rules else mesh.data_seq_mesh(s, f)
    key = lm_key(f, t, s, layout, rules)
    if grid.coords is None:
        return {}
    model = AttentionLM(LM["vocab"], LM["seq_len"], embed_dim=LM["embed_dim"],
                        num_heads=LM["num_heads"], mlp_dim=LM["mlp_dim"],
                        num_blocks=LM["num_blocks"], layout=layout,
                        mesh=grid)
    convert.load_jax(model, tree_of(inputs, "lm")).to(DEVICE)
    if rules:
        model.shard_(registry.LM_RULES)
    tokens = shard_batch(grid, lm_tokens(), axis=mesh.DATA_AXIS,
                         device=DEVICE)
    # the first step's loss and gradients, gathered whole
    targets, mask = model.next_token_targets(tokens)
    loss, _ = model.token_loss(model(tokens), targets, mask)
    count = LM_BATCH * (LM["seq_len"] - 1)
    (loss / count).backward()
    model.reduce_gradients()
    grads = {n: mesh.gather_block(p.grad, mesh.Sharding(grid, model.specs[n]))
             for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    res = {f"{key}_grad/{n.replace('.', '/')}": host(g)
           for n, g in grads.items()}
    opt = rmsprop(model, LM_LR)
    step = make_lm_train_step(TrainState(model, opt), global_batch=LM_BATCH)
    res[f"{key}_losses"] = np.asarray(
        [float(step(tokens, tokens)["loss"]) for _ in range(LM_STEPS)])
    res.update(flat_np(model.gathered_params(), f"{key}_params"))
    # what each rank keeps: its block of each parameter and moment
    res[f"{key}_block_elems"] = np.asarray(
        [sum(p.numel() for p in model.parameters()),
         sum(s["square_avg"].numel() for s in opt.state.values())])
    res[f"{key}_split"] = np.asarray([model._split.get(k, False) for k in
                                      ("block0.attn", "block0.mlp", "head")])
    return res


def att_case(inputs, layout) -> dict:
    grid = mesh.seq_mesh(ATT_RING)
    model = AttentionClassifier(**ATT, layout=layout, mesh=grid)
    convert.load_jax(model, tree_of(inputs, "att")).to(DEVICE)
    widths = []
    model.block0.register_forward_hook(
        lambda m, i, o: widths.append(list(o.shape)))
    x, y = att_data()
    logits = model(dev(x))
    loss = binary_cross_entropy(logits, dev(y))
    loss.backward()
    model.reduce_gradients()
    res = {f"att_{layout}_loss": np.asarray(float(loss)),
           f"att_{layout}_widths": host(collectives.all_gather(
               dev(widths[0])))}
    for n, p in model.named_parameters():
        res[f"att_{layout}_grad/{n.replace('.', '/')}"] = host(p.grad)
    return res


def eval_case(inputs) -> dict:
    """Evaluate and predict over 4 ranks with a padded last batch, and
    on this rank alone."""
    model = convert.load_jax(bn_cnn(), tree_of(inputs, "cnn_params"),
                             tree_of(inputs, "cnn_state")).to(DEVICE)
    rng = np.random.default_rng(9)
    ds = ArrayDataset(rng.random((EVAL_N, CNN_SIZE, CNN_SIZE, 3))
                      .astype(np.float32),
                      rng.integers(0, 2, EVAL_N).astype(np.int32))
    grid = mesh.data_mesh(WORLD)
    res = {}
    for name, g in (("mesh", grid), ("one", None)):
        m = loop.evaluate(model, ds, binary_cross_entropy,
                          batch_size=EVAL_BATCH, with_auroc=True, mesh=g)
        res[f"eval_{name}"] = np.asarray([m["loss"], m["accuracy"],
                                          m["auroc"]])
        res[f"predict_{name}"] = loop.predict(model, ds.images,
                                              batch_size=EVAL_BATCH, mesh=g)
    return res


def compare(want_path: str, got_path: str) -> int:
    """Hold a run's results against another's (a card run against a gloo
    run): every shared array within COMPARE_TOL of the reference's
    largest value, the dropout cases inside `got` alone. Prints the
    worst relative error by case; returns 1 past the bar."""
    want, got = dict(np.load(want_path)), dict(np.load(got_path))
    worst: dict[str, float] = {}
    for k in sorted(set(want) & set(got)):
        if k.startswith("drop"):
            continue
        w, g = np.asarray(want[k], np.float64), np.asarray(got[k], np.float64)
        err = float(np.abs(g - w).max()) / (1.0 + float(np.abs(w).max()))
        case = k.split("/")[0]
        worst[case] = max(worst.get(case, 0.0), err)
    for name in ("losses", "params/head/kernel"):
        a, b = got[f"drop4_{name}"], got[f"drop1_{name}"]
        err = float(np.abs(a - b).max()) / (1.0 + float(np.abs(b).max()))
        worst[f"drop4 vs drop1 {name}"] = err
    missing = sorted(set(want) ^ set(got))
    for case, err in worst.items():
        print(f"{case}: {err!r}")
    bad = {c: e for c, e in worst.items() if not e <= COMPARE_TOL}
    print(f"{len(worst)} cases, worst {max(worst.values())!r}, bar "
          f"{COMPARE_TOL}; past it: {bad}; keys in one file only: {missing}")
    return 1 if bad or missing else 0


def main(store: str, world: int, rank: int, out: Path) -> None:
    global DEVICE
    torch.set_num_threads(1)
    mesh.PROCESS_GROUP_TIMEOUT_S = 60.0
    mesh.initialize_multihost(f"file://{store}", world, rank)
    if torch.cuda.is_available():
        DEVICE = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    try:
        inputs = dict(np.load(out / "inputs.npz"))
        results = {}
        results.update(dp_cases(inputs))
        results.update(bn_case())
        results.update(tree_case())
        for case in LM_CASES:
            results.update(lm_case(inputs, *case))
        for layout in ATT_LAYOUTS:
            results.update(att_case(inputs, layout))
        results.update(eval_case(inputs))
        dist.barrier()
        if rank == 0:
            np.savez(out / "results.npz", **results)
        (out / f"done.{rank}").write_text("ok")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
