"""The port's distribution layer (mesh.py, partition.py, tp.py,
train/step.py, train/loop.py, models/core.py's BatchNorm, the sharded
AttentionLM and AttentionClassifier) against the JAX package's sharded
runs: four gloo ranks on the CPU, started once for the module from
`tests/_torch_dist_worker.py` (torch and the port only), given the JAX
package's initial weights. The JAX side runs here, in the test process,
on the conftest's virtual devices."""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from idc_models_tpu import mesh as meshlib
from idc_models_tpu.data import synthetic
from idc_models_tpu.models import core as jcore
from idc_models_tpu.models import registry as jregistry
from idc_models_tpu.models.attention import attention_classifier
from idc_models_tpu.models.lm import attention_lm, next_token_loss
from idc_models_tpu.train import (
    TrainState, jit_data_parallel, make_train_step, replicate, rmsprop,
    shard_batch,
)
from idc_models_tpu.train.losses import binary_cross_entropy
from idc_models_tpu.train.step import place_state
from idc_models_tpu_torch import convert

import _torch_dist_worker as worker

WORKER = Path(worker.__file__)
WORLD = worker.WORLD
DEADLINE_S = 240.0


def _bn_cnn():
    return jcore.sequential([
        jcore.conv2d(3, 8, 3, stride=2, padding="SAME", use_bias=False,
                     name="conv1"),
        jcore.batch_norm(8, name="bn1"),
        jcore.relu(),
        jcore.flatten(),
        jcore.dense(5 * 5 * 8, 1, name="head"),
    ], name="bn_cnn")


def _lm(mesh=None, layout="contiguous"):
    return attention_lm(worker.LM["vocab"], worker.LM["seq_len"],
                        embed_dim=worker.LM["embed_dim"],
                        num_heads=worker.LM["num_heads"],
                        mlp_dim=worker.LM["mlp_dim"],
                        num_blocks=worker.LM["num_blocks"], mesh=mesh,
                        layout=layout)


def _att(mesh=None, layout="contiguous"):
    return attention_classifier(mesh=mesh, layout=layout, causal=True,
                                **worker.ATT)


@functools.cache
def _inputs() -> dict:
    """The JAX package's initial weights, flat "group/a/b" keys."""
    cnn = jax.device_get(_bn_cnn().init(jax.random.key(0)))
    out = {}
    for prefix, tree in (("cnn_params", cnn.params),
                         ("cnn_state", cnn.state),
                         ("lm", jax.device_get(
                             _lm().init(jax.random.key(0)).params)),
                         ("att", jax.device_get(
                             _att().init(jax.random.key(1)).params))):
        out.update({f"{prefix}/{k}": np.asarray(v)
                    for k, v in convert.flatten(tree).items()})
    return out


class _Ranks:
    """The worker processes of one module run: started with the inputs
    written, waited for (all killed past the deadline or when one
    fails), rank 0's results loaded."""

    def __init__(self, out: Path):
        self.out = out
        np.savez(out / "inputs.npz", **_inputs())
        env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
        self.logs = [open(out / f"log.{r}", "w") for r in range(WORLD)]
        self.procs = [subprocess.Popen(
            [sys.executable, str(WORKER), str(out / "store"), str(WORLD),
             str(r), str(out)], stdout=log, stderr=subprocess.STDOUT,
            env=env) for r, log in enumerate(self.logs)]
        self.started = time.monotonic()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait(timeout=30)
        for log in self.logs:
            if not log.closed:
                log.close()

    def wait(self) -> dict:
        while any(p.poll() is None for p in self.procs):
            failed = any(p.poll() not in (None, 0) for p in self.procs)
            if failed or time.monotonic() - self.started > DEADLINE_S:
                break
            time.sleep(0.1)
        self.kill()
        codes = [p.returncode for p in self.procs]
        if codes != [0] * WORLD:
            logs = "\n".join(f"--- rank {r}:\n"
                             + (self.out / f"log.{r}").read_text()[-3000:]
                             for r in range(WORLD))
            pytest.fail(f"dist ranks ended with {codes}\n{logs}")
        return dict(np.load(self.out / "results.npz"))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    run = _Ranks(tmp_path_factory.mktemp("dist_ranks"))
    try:
        yield run.wait()
    finally:
        run.kill()


def _tree(results, prefix):
    return {k[len(prefix) + 1:]: v for k, v in results.items()
            if k.startswith(prefix + "/")}


def _flat(tree):
    return {k: np.asarray(v) for k, v in convert.flatten(tree).items()}


# -- data parallelism -------------------------------------------------------


@functools.cache
def _jax_cnn_run(n_dev: int, steps: int, data_seed: int):
    """The BN CNN's JAX DP step on an n-device data mesh: losses and the
    final params and BN statistics."""
    inp = _inputs()
    model, opt = _bn_cnn(), rmsprop(worker.CNN_LR)
    params = convert.unflatten({k[11:]: v for k, v in inp.items()
                                if k.startswith("cnn_params/")})
    mstate = convert.unflatten({k[10:]: v for k, v in inp.items()
                                if k.startswith("cnn_state/")})
    mesh = meshlib.data_mesh(n_dev)
    state = replicate(mesh, TrainState(
        step=jnp.zeros((), jnp.int32), params=params, model_state=mstate,
        opt_state=opt.init(params)))
    step = jit_data_parallel(
        make_train_step(model, opt, binary_cross_entropy), mesh)
    imgs, labels = synthetic.make_idc_like(worker.CNN_BATCH,
                                           size=worker.CNN_SIZE,
                                           seed=data_seed)
    key, losses = jax.random.key(7), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        state, m = step(state, *shard_batch(mesh, imgs, labels), sub)
        losses.append(float(m["loss"]))
    return (np.asarray(losses), _flat(jax.device_get(state.params)),
            _flat(jax.device_get(state.model_state)))


def test_data_parallel_matches_one_rank_and_jax_dp_step(results):
    """5 steps of the BN CNN on a 64-example batch: 4 ranks (BatchNorm
    over the global batch) against 1 rank and against the JAX package's
    DP step on 4 devices -- loss rtol 1e-5, parameters and BN statistics
    rtol 1e-4 / atol 1e-6, as tests/test_slice0_dp.py. The one-rank
    run, given no mesh inside the running world, calls no collective;
    the four-rank run does."""
    assert results["dp1_collectives"] == 0
    assert results["dp4_collectives"] > 0
    j_losses, j_params, j_state = _jax_cnn_run(WORLD, worker.DP_STEPS, 1)
    for name in ("dp4", "dp1"):
        np.testing.assert_allclose(results[f"{name}_losses"][-1],
                                   j_losses[-1], rtol=1e-5, err_msg=name)
        for prefix, want in (("params", j_params), ("state", j_state)):
            got = _tree(results, f"{name}_{prefix}")
            assert set(got) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-6,
                                           err_msg=f"{name} {k}")
    np.testing.assert_allclose(results["dp4_losses"], results["dp1_losses"],
                               rtol=1e-5)


def test_dropout_masks_of_four_ranks_are_one_ranks(results):
    """The small CNN's two dropouts, drawn for the global batch on every
    rank from one seeded generator, each rank keeping its rows: 4 ranks
    train as 1 (loss rtol 1e-5, parameters rtol 1e-4 / atol 1e-6); the
    one-rank run calls no collective."""
    assert results["drop1_collectives"] == 0
    assert results["drop4_collectives"] > 0
    np.testing.assert_allclose(results["drop4_losses"],
                               results["drop1_losses"], rtol=1e-5)
    one = _tree(results, "drop1_params")
    for k, got in _tree(results, "drop4_params").items():
        np.testing.assert_allclose(got, one[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_batch_norm_takes_the_global_batch_moments(results):
    """Train-mode BN on 4 shards centred at 0, 3, 6, 9: the output, the
    moving statistics and the gradients of sum(out * g) equal the JAX
    layer's on the whole batch (rtol 1e-5, atol 1e-5): the shards' means
    differ, so averaged per-rank variances would miss the spread of the
    means."""
    x = worker.bn_shards().reshape(-1, worker.BN_C)
    g = np.tile(np.arange(worker.BN_ROWS * worker.BN_C, dtype=np.float32)
                .reshape(worker.BN_ROWS, worker.BN_C) / 7.0 - 1.0,
                (WORLD, 1))
    bn = jcore.batch_norm(worker.BN_C)
    v = bn.init(jax.random.key(0))

    def loss(params, x):
        out, state = bn.apply(params, v.state, x, train=True)
        return jnp.sum(out * g), (out, state)

    (_, (out, state)), (dp, dx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v.params, jnp.asarray(x))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(results["bn_out"], out, **tol)
    np.testing.assert_allclose(results["bn_dx"], dx, **tol)
    np.testing.assert_allclose(results["bn_dscale"], dp["scale"], **tol)
    np.testing.assert_allclose(results["bn_dbias"], dp["bias"], **tol)
    np.testing.assert_allclose(results["bn_mean"], state["mean"], **tol)
    np.testing.assert_allclose(results["bn_var"], state["var"], **tol)


def test_dp_tp_matches_dp_and_stores_channel_blocks(results):
    """8 steps on a 2 x 2 ("data", "model") mesh, parameters and RMSprop
    moments stored by the channel rule, against 4-way DP and the JAX
    package's 4-device DP (losses rtol 1e-4, parameters rtol 1e-4 /
    atol 1e-5, as tests/test_tp.py); each rank keeps half of every
    moment whose last axis divides (conv 8 channels, BN 8) and all of
    the Dense(1) head's."""
    j_losses, j_params, _ = _jax_cnn_run(WORLD, worker.TP_STEPS, 0)
    for name in ("tp_dp2x2", "tp_dp4"):
        np.testing.assert_allclose(results[f"{name}_losses"], j_losses,
                                   rtol=1e-4, err_msg=name)
        got = _tree(results, f"{name}_params")
        for k, w in j_params.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {k}")
    full, blocks = results["tp_full_shapes"], results["tp_moment_shapes"]
    for f, b in zip(full, blocks):
        f, b = [d for d in f if d], [d for d in b if d]
        last_splits = f[-1] > 1 and f[-1] % 2 == 0
        assert b == f[:-1] + [f[-1] // 2 if last_splits else f[-1]], (f, b)
    assert any(f[-1] == 1 for f in ([d for d in s if d] for s in full))


def test_padded_last_eval_batch_is_masked_out(results):
    """70 examples at batch 16 over 4 ranks: the last batch of 6 padded to
    8, its 2 padding rows dropped -- evaluate's loss, accuracy and AUROC
    and predict's 70 rows equal one rank's (rtol 1e-6)."""
    np.testing.assert_allclose(results["eval_mesh"], results["eval_one"],
                               rtol=1e-6)
    assert results["predict_mesh"].shape == (worker.EVAL_N, 1)
    np.testing.assert_allclose(results["predict_mesh"],
                               results["predict_one"], rtol=1e-6, atol=1e-7)


def test_gather_tree_puts_shard_tree_back(results):
    """shard_tree over a 2 x 2 gloo mesh keeps rank 0's blocks (w split
    over both axes, v over their product) and gather_tree gives back the
    input bit for bit."""
    w, v = np.arange(32.0).reshape(4, 8), np.arange(8.0)
    np.testing.assert_array_equal(results["tree_block_w"], w[:2, :4])
    np.testing.assert_array_equal(results["tree_block_v"], v[:2])
    back = _tree(results, "tree_back")
    np.testing.assert_array_equal(back["w"], w)
    np.testing.assert_array_equal(back["v"], v)
    np.testing.assert_array_equal(back["b"], np.ones(3))


def test_replicate_makes_every_rank_rank_0(results):
    """Four ranks build the small CNN from seeds 0-3; after replicate
    each holds rank 0's parameters, bit for bit."""
    rows = results["replicated"]
    assert rows.shape[0] == WORLD and not np.array_equal(rows[0], 0 * rows[0])
    for r in range(1, WORLD):
        np.testing.assert_array_equal(rows[r], rows[0])


# -- the sharded LM ---------------------------------------------------------


@functools.cache
def _jax_lm(f: int, t: int, s: int, layout: str, rules: bool):
    """JAX's LM on fsdp_tp_mesh(f, t, s) under LM_RULES (or replicated on
    data_seq_mesh(s, f)): the first step's loss and gradients, then 3
    RMSprop steps' losses and parameters."""
    if rules:
        mesh = meshlib.fsdp_tp_mesh(f, t, s)
        rules = jregistry.get_partition_rules("lm")
    else:
        mesh, rules = meshlib.data_seq_mesh(s, f), None
    model, opt = _lm(mesh, layout), rmsprop(worker.LM_LR)
    params = convert.unflatten({k[3:]: v for k, v in _inputs().items()
                                if k.startswith("lm/")})
    tokens = jnp.asarray(worker.lm_tokens(), jnp.int32)

    def loss(p, x):
        return next_token_loss(model.apply(p, {}, x)[0], x)

    placed = place_state(mesh, params, rules=rules)
    x = shard_batch(mesh, tokens, axis=meshlib.DATA_AXIS)
    loss0, grads = jax.jit(jax.value_and_grad(loss))(placed, x)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       model_state={}, opt_state=opt.init(params))
    step = jit_data_parallel(
        make_train_step(model, opt, next_token_loss), mesh,
        axis=meshlib.DATA_AXIS,
        state_shardings=rules and rules.shardings(mesh, state))
    state = place_state(mesh, state, rules=rules)
    losses = []
    for _ in range(worker.LM_STEPS):
        state, m = step(state, x, x, jax.random.key(0))
        losses.append(float(m["loss"]))
    return (float(loss0), _flat(jax.device_get(grads)), np.asarray(losses),
            _flat(jax.device_get(state.params)))


@pytest.mark.parametrize("f,t,s,layout,rules", worker.LM_CASES,
                         ids=[worker.lm_key(*c) for c in worker.LM_CASES])
def test_sharded_lm_matches_jax_sharded_lm(results, f, t, s, layout, rules):
    """The LM (vocab 64, embed 32, 4 heads, MLP 48, 2 blocks, T 64,
    batch 4) on fsdp x tp x seq gloo ranks under LM_RULES against JAX's
    on the same mesh: the first step's gradients, gathered from every
    rank's blocks (rtol 1e-4, atol 1e-4), 3 RMSprop steps' losses (rtol
    1e-5; the first is the step's loss) and parameters (rtol 1e-4, atol
    1e-4), as tests/test_torch_lm.py holds one card's. tp 3 splits the
    MLP (48 / 3) and leaves the attention and head whole (32 and 64 do
    not divide), so that mesh mixes split and replicated leaves. The
    replicated case is the verb's mesh without --fsdp/--tp: data 2 x a
    zigzag ring of 2."""
    key = worker.lm_key(f, t, s, layout, rules)
    loss0, grads, losses, params = _jax_lm(f, t, s, layout, rules)
    np.testing.assert_allclose(results[f"{key}_losses"][0], loss0,
                               rtol=1e-5)
    np.testing.assert_allclose(results[f"{key}_losses"], losses, rtol=1e-5)
    got = _tree(results, f"{key}_grad")
    assert set(got) == set(grads)
    for k, w in grads.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"grad {k}")
    got = _tree(results, f"{key}_params")
    for k, w in params.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=f"param {k}")
    heads_split = rules and t > 1 and worker.LM["num_heads"] % t == 0
    mlp_split = rules and t > 1 and worker.LM["mlp_dim"] % t == 0
    vocab_split = rules and t > 1 and worker.LM["vocab"] % t == 0
    assert list(results[f"{key}_split"]) == [heads_split, mlp_split,
                                             vocab_split]
    # each rank keeps less than the whole model, its moments alike
    whole = sum(w.size for w in params.values())
    kept, moments = results[f"{key}_block_elems"]
    assert kept == moments and (kept < whole) == (rules and f * t > 1)


# -- the sequence-sharded attention classifier ------------------------------


@functools.cache
def _jax_att(layout: str):
    mesh = meshlib.seq_mesh(worker.ATT_RING)
    model = _att(mesh, layout)
    params = convert.unflatten({k[4:]: v for k, v in _inputs().items()
                                if k.startswith("att/")})
    x, y = (jnp.asarray(a) for a in worker.att_data())

    def loss(p):
        return binary_cross_entropy(model.apply(p, {}, x)[0], y)

    value, grads = jax.jit(jax.value_and_grad(loss))(params)
    return float(value), _flat(jax.device_get(grads))


@pytest.mark.parametrize("layout", worker.ATT_LAYOUTS)
def test_sequence_sharded_classifier_matches_jax(results, layout):
    """AttentionClassifier over a ring of 4 (T 64: 16 positions a rank)
    against attention_classifier on seq_mesh(4): the loss (rtol 1e-5)
    and every gradient after the "seq" sums, the head's included (which
    must not be summed: rtol 1e-4, atol 1e-5); and each rank's residual
    stream holds its T/4 positions."""
    value, grads = _jax_att(layout)
    np.testing.assert_allclose(results[f"att_{layout}_loss"], value,
                               rtol=1e-5)
    got = _tree(results, f"att_{layout}_grad")
    assert set(got) == set(grads)
    for k, w in grads.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    t_local = worker.ATT["seq_len"] // worker.ATT_RING
    np.testing.assert_array_equal(
        results[f"att_{layout}_widths"],
        [[worker.ATT_BATCH, t_local, worker.ATT["embed_dim"]]] * WORLD)


# -- the verbs over a CPU pod -----------------------------------------------


def test_mobile_model_parallel_trains_over_a_cpu_pod(tmp_path, capsys,
                                                 monkeypatch):
    """`mobile --host-devices 4 --model-parallel 2`: a 2 x 2 ("data",
    "model") mesh of gloo ranks stores MobileNetV2's weights and moments
    by the channel rule and trains both phases; rank 0 prints and writes
    the records and model.npz, in the JAX layout."""
    # one thread a rank: the pod shares the test run's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from idc_models_tpu_torch import cli
    from idc_models_tpu_torch.models.pretrained import load_pretrained_file

    assert cli.main(["mobile", "--device", "cpu", "--host-devices", "4",
                     "--model-parallel", "2", "--synthetic-examples", "64",
                     "--batch-size", "8", "--epochs", "1",
                     "--fine-tune-epochs", "1", "--path",
                     str(tmp_path)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "Device: cpu over 4 ranks (data=2, model=2)"
    assert any(line.startswith("test: loss=") for line in lines)
    records = [json.loads(line) for line in
               (tmp_path / "logs" / "run.jsonl").read_text().splitlines()]
    events = [r["event"] for r in records]
    assert events.count("epoch") == 2 and events[-2:] == [
        "test", "metrics_snapshot"]
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    params, _ = load_pretrained_file(tmp_path / "model.npz")
    assert params["head"]["kernel"].shape == (1280, 1)
