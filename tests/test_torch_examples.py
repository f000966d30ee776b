"""The port's eleven example scripts (examples/torch_port/) on the CPU:

- each runs as a user runs it, a subprocess with ``--device cpu``,
  exiting 0 with its own asserts held;
- each is held against its JAX example (examples/*.py) where no random
  stream separates the two packages: the data bit for bit, the ring
  attention and ring decode of 04 and 06 against the JAX functions on
  the same numpy inputs (1e-5), and, started from the JAX example's own
  init carried over by `convert.py`, the first evaluation of 02, 03, 05,
  07 and 09 within the tolerance of the module's own test. Training past
  that point is held by each script's own asserts: the port's random
  streams (dropout, client order) differ from JAX's by design;
- 04, 06 and 07 also run as a pod of 4 gloo ranks (``--host-devices
  4``) and pass the same checks.

The JAX examples' layouts are computed here on the suite's 8 virtual
devices; the port's scripts run in this process at a world of one."""

from __future__ import annotations

import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idc_models_tpu import faults as jfaults
from idc_models_tpu import mesh as jmesh
from idc_models_tpu import ring_attention as jring
from idc_models_tpu import ring_decode as jdecode
from idc_models_tpu.data import idc as jidc
from idc_models_tpu.data import partition as jpartition
from idc_models_tpu.data import synthetic as jsyn
from idc_models_tpu.federated import fedavg as jfed
from idc_models_tpu.models import attention as jattn
from idc_models_tpu.models import lm as jlm
from idc_models_tpu.models.small_cnn import small_cnn as jsmall_cnn
from idc_models_tpu.serve import api as jserve
from idc_models_tpu.train import losses as jlosses
from idc_models_tpu.train import loop as jloop
from idc_models_tpu.train import state as jstate
from idc_models_tpu import tp as jtp
from idc_models_tpu_torch import convert
from idc_models_tpu_torch.federated import fedavg as tfed
from idc_models_tpu_torch.models import lm as tlm
from idc_models_tpu_torch.train import loop as tloop
from idc_models_tpu_torch.train import losses as tlosses

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "examples" / "torch_port"
SCRIPTS = sorted(p for p in EXAMPLES.glob("[0-9]*.py"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share a few cores: one torch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the scripts import each other (08 takes 07's model) and `_world` from
# their directory
sys.path.insert(0, str(EXAMPLES))


def _load(stem: str):
    """An example script as a module (its name starts with a digit, which
    an import statement cannot name)."""
    return importlib.import_module(stem)


def _world():
    """The port's world of one, on the CPU, in this process."""
    return _load("_world").World(torch.device("cpu"), joined=False)


def _run(script: Path, tmp_path, *args) -> subprocess.CompletedProcess:
    """The script as a user runs it, on the CPU: one thread a process
    (the pod's ranks too), temporary files under `tmp_path`."""
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, str(script), "--device", "cpu",
                        *args], capture_output=True, text=True,
                       timeout=300, env=env, cwd=tmp_path)
    assert r.returncode == 0, f"{script.name} failed:\n{r.stdout}\n{r.stderr}"
    assert r.stdout.strip(), f"{script.name} printed nothing"
    return r


def test_eleven_scripts_one_for_one():
    """One port script per JAX example, under the same name."""
    jax_names = sorted(p.name for p in (REPO / "examples").glob("*.py"))
    assert len(jax_names) == 11
    assert [p.name for p in SCRIPTS] == jax_names


# ---------------------------------------------------------------------------
# (a) every script runs as a user runs it
# ---------------------------------------------------------------------------

# a line each script prints only once its own asserts have held
LAST_WORDS = {
    "01_two_phase_vgg.py": "final val acc",
    "02_federated_rounds.py": "round 2: train_loss=",
    "03_tensor_parallel.py": "first 5 malignancy probabilities:",
    "04_ring_attention.py": "max |ring - full| =",
    "05_attention_classifier.py": "OK: ring-attention transformer trained",
    "06_ring_decode.py": "max |err| vs full causal attention",
    "07_lm_train_and_generate.py": "Generator served 2 requests",
    "08_serve_continuous_batching.py": "Poisson trace served with zero new",
    "09_federated_faults.py": "the mean is steered away by the attackers",
    "10_observability.py": "metrics registry (Prometheus text exposition)",
    "11_slo_alerts.py": "OK: alert under injected stragglers",
}


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.name)
def test_script_runs_on_the_cpu(script, tmp_path):
    r = _run(script, tmp_path)
    assert LAST_WORDS[script.name] in r.stdout, r.stdout


def test_observability_writes_its_own_directory(tmp_path):
    """10 writes under the temporary directory's idc_obs_example_torch/,
    never the JAX example's /tmp/idc_obs_example."""
    r = _run(EXAMPLES / "10_observability.py", tmp_path)
    out = tmp_path / "idc_obs_example_torch"
    assert (out / "trace.json").is_file() and (out / "spans.jsonl").is_file()
    assert "/tmp/idc_obs_example/" not in r.stdout
    assert "serve.tick" in r.stdout and "serve.window" in r.stdout


# ---------------------------------------------------------------------------
# (c) the data, bit for bit
# ---------------------------------------------------------------------------


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _same_datasets(got, want):
    for g, w in zip(got, want):
        _same_arrays((g.images, g.labels), (w.images, w.labels))


def test_two_phase_splits_equal_jax():
    images, labels = jsyn.make_idc_like(256, size=50, seed=0)
    want = jidc.train_val_test_split(jidc.ArrayDataset(images, labels),
                                     seed=0)
    _same_datasets(_load("01_two_phase_vgg").make_splits(), want)


def test_tensor_parallel_splits_equal_jax():
    images, labels = jsyn.make_idc_like(128, size=10, seed=0)
    want = (jidc.ArrayDataset(images[:96], labels[:96]),
            jidc.ArrayDataset(images[96:], labels[96:]))
    _same_datasets(_load("03_tensor_parallel").make_splits(), want)


def _jax_clients(n_clients, per_client, iid, pad_to=None):
    images, labels = jsyn.make_idc_like(n_clients * per_client, size=10,
                                        seed=0)
    ci, cl = jpartition.partition_clients(
        jidc.ArrayDataset(images, labels), n_clients, iid=iid, seed=0)
    w = np.full((n_clients,), ci.shape[1], np.float32)
    if pad_to is not None:
        return jpartition.pad_clients(ci, cl, w, multiple=pad_to)
    return ci, cl, w


@pytest.mark.parametrize("stem,want", [
    pytest.param("02_federated_rounds",
                 lambda: _jax_clients(8, 64, iid=False), id="02"),
    pytest.param("09_federated_faults",
                 lambda: _jax_clients(10, 16, iid=True, pad_to=8), id="09"),
    pytest.param("11_slo_alerts", lambda: _jax_clients(8, 64, iid=True),
                 id="11"),
])
def test_client_shards_equal_jax(stem, want):
    """partition_clients (and 09's pad_clients to 16 shards) and the
    example-count weights."""
    _same_arrays(_load(stem).make_clients(), want())


def test_sequence_task_and_batches_equal_jax():
    ex = _load("05_attention_classifier")
    x, y = ex.make_data()
    _same_arrays((x, y), jsyn.make_sequence_task(512, 32, 8, seed=5))
    sel_rng = np.random.default_rng(7)
    _same_arrays(ex.batches(x, y),
                 [sel_rng.integers(0, len(x), 64) for _ in range(150)])


def test_counting_batches_equal_jax():
    """07's (and 08's) counting batches, as the JAX example's int32
    arrays."""
    rng = np.random.default_rng(1)
    want = []
    for _ in range(150):
        starts = rng.integers(0, 11, (32, 1))
        want.append(np.asarray(jnp.asarray((starts + np.arange(32)) % 11,
                                           jnp.int32)))
    _same_arrays(_load("07_lm_train_and_generate").counting_batches(), want)
    _same_arrays(_load("08_serve_continuous_batching").lm.counting_batches(),
                 want)


def _same_trace(got, want):
    assert len(got) == len(want)
    for (ta, ra), (tb, rb) in zip(got, want):
        assert ta == tb and dataclasses.asdict(ra) == dataclasses.asdict(rb)


def test_serving_requests_and_traces_equal_jax():
    """08's burst of 8 and its Poisson trace, and 10's trace."""
    ex8 = _load("08_serve_continuous_batching")
    want = [jserve.Request(id=f"user{i}", prompt=tuple((i + j) % 11
                                                       for j in range(3)),
                           max_new_tokens=6 + i % 4) for i in range(8)]
    assert ([dataclasses.asdict(r) for r in ex8.make_requests()]
            == [dataclasses.asdict(r) for r in want])
    _same_trace(ex8.make_trace(), jserve.poisson_trace(
        6, rate_per_s=200.0, vocab=11, t_max=32, seed=7))
    _same_trace(_load("10_observability").make_trace(), jserve.poisson_trace(
        8, rate_per_s=1e9, vocab=11, t_max=32, prompt_lens=(4, 12),
        budgets=(4, 8), seed=0))


def test_byzantine_fault_plan_equals_jax():
    got = _load("09_federated_faults").make_plan()
    want = jfaults.FaultPlan.byzantine(10, 3, kind="sign_flip", scale=1000.0,
                                       seed=7)
    assert str(got) == str(want)
    assert ([dataclasses.asdict(f) for f in got.faults]
            == [dataclasses.asdict(f) for f in want.faults])


# ---------------------------------------------------------------------------
# (c) the ring and the decode against the JAX functions
# ---------------------------------------------------------------------------


def test_ring_attention_matches_jax():
    """04 on one rank against make_ring_attention over the JAX example's
    ring of 8 on the same inputs, within 1e-5."""
    ex = _load("04_ring_attention")
    q, k, v = ex.make_inputs()
    mesh = jmesh.seq_mesh()
    sh = jmesh.sharding(mesh, None, jmesh.SEQ_AXIS)
    want = jring.make_ring_attention(mesh, causal=True)(
        *(jax.device_put(jnp.asarray(x), sh) for x in (q, k, v)))
    got = ex.run(_world(), q, k, v)["out"]
    assert np.max(np.abs(got - np.asarray(want))) <= 1e-5


def test_ring_decode_matches_jax():
    """06 on one rank against prefill + make_ring_decode over the JAX
    example's ring of 8 on the same inputs, within 1e-5."""
    ex = _load("06_ring_decode")
    q, k, v = (jnp.asarray(x) for x in ex.make_inputs())
    mesh = jmesh.seq_mesh()
    kc, vc = jdecode.prefill(mesh, k[:, :ex.P_LEN], v[:, :ex.P_LEN],
                             ex.T_MAX, dtype=jnp.float32)
    step = jdecode.make_ring_decode(mesh)
    outs = []
    for pos in range(ex.P_LEN, ex.T_MAX):
        tok = slice(pos, pos + 1)
        out, kc, vc = step(kc, vc, q[:, tok], k[:, tok], v[:, tok], pos)
        outs.append(np.asarray(out))
    got = ex.run(_world(), *ex.make_inputs())["decoded"]
    assert np.max(np.abs(got - np.concatenate(outs, axis=1))) <= 1e-5


# ---------------------------------------------------------------------------
# (c) the first evaluation from the JAX example's own init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stem", ["02_federated_rounds",
                                  "09_federated_faults"])
def test_federated_eval_from_the_jax_init_matches_jax(stem):
    """make_federated_eval of the seed-0 server the JAX example starts
    from, on its own client mesh of 8, against the port's on the same
    weights (loss 1e-5, accuracy 1e-6: tests/test_torch_fedavg.py)."""
    ex = _load(stem)
    clients = ex.make_clients()
    jmodel = jsmall_cnn(10, 3, 1)
    server = jfed.initialize_server(jmodel, jax.random.key(0))
    want = jax.device_get(jfed.make_federated_eval(
        jmodel, jlosses.binary_cross_entropy, jmesh.client_mesh(8))(
        server, *(jnp.asarray(a) for a in clients)))
    world = _world()
    mesh = world.mesh(client=8)
    if stem == "02_federated_rounds":
        model, _, eval_fn = ex.build(world, mesh)
    else:
        drill = ex.Drill(world, mesh, clients, ex.make_plan())
        model, eval_fn = drill.model, drill.eval_fn
    convert.load_jax(model, jax.device_get(server.params),
                     jax.device_get(server.model_state))
    got = eval_fn(tfed.ServerState.of(model), *clients)
    np.testing.assert_allclose(got["loss"], float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["accuracy"], float(want["accuracy"]),
                               rtol=1e-6)


def test_tensor_parallel_predict_from_the_jax_init_matches_jax():
    """`predict` of the JAX example's seed-0 state on its 2 x 4 DP x TP
    mesh against the port's on the same weights (rtol 1e-5, atol 1e-6:
    tests/test_torch_core.py)."""
    ex = _load("03_tensor_parallel")
    _, val = ex.make_splits()
    jmodel = jsmall_cnn(10, 3, 1)
    state = jstate.create_train_state(jmodel, jstate.rmsprop(1e-3),
                                      jax.random.key(0))
    want = jloop.predict(jmodel, state, val.images,
                         jtp.dp_tp_mesh(model=4))
    world = _world()
    model = ex.build_model(world, jax.device_get(state.params),
                           jax.device_get(state.model_state))
    got = tloop.predict(model, val.images,
                        mesh=world.mesh(data=2, model=4))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def _first_batch_loss(jmodel_1, params, x, y, loss):
    logits, _ = jmodel_1.apply(params, {}, jnp.asarray(x))
    return float(loss(logits, jnp.asarray(y)))


def test_attention_classifier_loss_at_init_matches_jax():
    """The first batch's BCE from the JAX example's init (its model on
    the ("data" 2, "seq" 4) mesh, key 0), against the port's on the same
    weights (rtol 1e-5: tests/test_torch_attention.py). JAX computes it
    on a ring of one: the init does not depend on the mesh."""
    ex = _load("05_attention_classifier")
    kw = dict(embed_dim=32, num_heads=2, mlp_dim=64, num_blocks=2,
              num_outputs=1, causal=True)
    params = jax.device_get(jattn.attention_classifier(
        32, 8, mesh=jmesh.data_seq_mesh(4, 2), **kw).init(
        jax.random.key(0)).params)
    x, y = ex.make_data()
    sel = ex.batches(x, y)[0]
    want = _first_batch_loss(
        jattn.attention_classifier(32, 8, mesh=jmesh.seq_mesh(1), **kw),
        params, x[sel], y[sel], jlosses.binary_cross_entropy)
    world = _world()
    model = ex.build_model(world, world.mesh(data=2, seq=4), params)
    with torch.no_grad():
        got = tlosses.binary_cross_entropy(model(torch.from_numpy(x[sel])),
                                           torch.from_numpy(y[sel]))
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


def test_lm_loss_at_init_matches_jax():
    """The first counting batch's next-token loss from the JAX example's
    init (its LM on the ("data" 2, "seq" 4) mesh, key 0), against the
    port's on the same weights (rtol 1e-5: tests/test_torch_lm.py)."""
    ex = _load("07_lm_train_and_generate")
    kw = dict(embed_dim=32, num_heads=2, mlp_dim=64, num_blocks=2)
    params = jax.device_get(jlm.attention_lm(
        11, 32, mesh=jmesh.data_seq_mesh(4, 2), **kw).init(
        jax.random.key(0)).params)
    toks = ex.counting_batches(1)[0]
    want = _first_batch_loss(
        jlm.attention_lm(11, 32, mesh=jmesh.seq_mesh(1), **kw), params,
        toks, toks, jlm.next_token_loss)
    world = _world()
    model = ex.build_model(world, world.mesh(data=2, seq=4), params)
    with torch.no_grad():
        t = torch.from_numpy(toks)
        got = tlm.next_token_loss(model(t), t)
    np.testing.assert_allclose(got.item(), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) over a pod of 4 gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stem,shown", [
    pytest.param("04_ring_attention", "this rank's block (2, 128, 4, 32)",
                 id="04"),
    pytest.param("06_ring_decode", "this rank's shard (2, 64, 4, 32)",
                 id="06"),
    pytest.param("07_lm_train_and_generate",
                 "generation matches the learned successor pattern",
                 id="07"),
])
def test_script_runs_on_a_pod_of_four(stem, shown, tmp_path):
    """The same checks over 4 ranks: the ring and the cache split 4
    ways (rank 0's block printed), 07's LM trained over a ring of 4."""
    r = _run(EXAMPLES / f"{stem}.py", tmp_path, "--host-devices", "4")
    assert shown in r.stdout, r.stdout
    assert LAST_WORDS[f"{stem}.py"] in r.stdout
