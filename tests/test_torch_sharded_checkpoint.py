"""The port's sharded checkpoint (idc_models_tpu_torch/checkpoint/) on the
CPU, against the JAX package's (idc_models_tpu/checkpoint/sharded.py)
and its contracts, as tests/test_checkpoint_sharded.py holds them:

1. one format: a checkpoint either package saves restores bit for bit in
   the other -- the same file names, bytes, digests and manifest -- a
   JAX save from a 4-device mesh (several shards a leaf) included, whole
   or into any rank's block under the rules on a port mesh;
2. completion and integrity: a directory without MANIFEST.json is a torn
   save, a shard failing its sha256 or missing is refused, each with the
   JAX message; a dead rule is refused; a wrong format version too;
3. the async save's handle, `template`, the events and instruments, and
   one save and restore over two gloo ranks (`tests/_torch_ckpt_worker.py`,
   torch and the port only)."""

from __future__ import annotations

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
import torch

from idc_models_tpu import mesh as jmesh
from idc_models_tpu import partition as jpartition
from idc_models_tpu.checkpoint import sharded as jsharded
from idc_models_tpu_torch import mesh as tmesh
from idc_models_tpu_torch import partition as tpartition
from idc_models_tpu_torch.checkpoint import (
    MANIFEST_NAME, CheckpointError, checkpoint_info, restore_sharded,
    save_sharded,
)
from idc_models_tpu_torch.observe import MetricsRegistry

import _torch_ckpt_worker as worker

JP = jax.sharding.PartitionSpec
JRULES = jpartition.PartitionRules((
    (r"w1$", JP(jmesh.DATA_AXIS, jmesh.MODEL_AXIS)),
    (r"blocks/.*/kernel$", JP(None, jmesh.MODEL_AXIS)),
    (r".*", JP()),
))


def _host(seed=0) -> dict:
    """`worker.tree` plus a bf16 leaf (numpy has no bf16: the port
    restores it as a torch.bfloat16 tensor)."""
    tree = worker.tree(seed)
    tree["h"] = jnp.asarray(np.random.default_rng(seed + 9).normal(
        size=(6,)), jnp.bfloat16)
    return tree


def _as_np(x):
    if torch.is_tensor(x):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(jax.device_get(x))
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _assert_same(got, want):
    got, want = (dict(tpartition.tree_paths(t)) for t in (got, want))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(_as_np(got[name]), _as_np(want[name]),
                                      err_msg=name)


def _port_tree(host):
    """The host tree as the port holds it: tensors (bf16 as bf16)."""
    return {k: (_port_tree(v) if isinstance(v, dict) else
                torch.from_numpy(_as_np(v).copy()).view(torch.bfloat16)
                if k == "h" else torch.as_tensor(np.asarray(v)))
            for k, v in host.items()}


def test_jax_save_restores_in_the_port_and_back_byte_for_byte(tmp_path):
    """JAX save -> port restore bit-equal; port save of the same tree ->
    the same file names, the same bytes, the same manifest; and the JAX
    restore of the port's save bit-equal."""
    host = _host()
    jsharded.save_sharded(tmp_path / "j", host, step=3)
    _assert_same(restore_sharded(tmp_path / "j"), host)
    assert restore_sharded(tmp_path / "j")["h"].dtype == torch.bfloat16
    save_sharded(tmp_path / "t", _port_tree(host), step=3)
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    for f in files:
        assert (tmp_path / "j" / f).read_bytes() == \
            (tmp_path / "t" / f).read_bytes(), f
    _assert_same(jsharded.restore_sharded(tmp_path / "t"), host)


@pytest.mark.parametrize("target", [(1, 1), (2, 1), (1, 2), (2, 2), (4, 2)],
                         ids=lambda t: f"data{t[0]}xmodel{t[1]}")
def test_jax_multishard_save_restores_whole_and_into_blocks(tmp_path,
                                                            target):
    """A JAX save from an FSDP(2) x TP(2) mesh (several shards a leaf)
    restores in the port whole, and under the same rules on a port mesh
    of `target` (data, model) ranks each rank's block is its slice of
    the whole (`put_with_sharding`'s), bit for bit."""
    host = worker.tree(1)
    ck = tmp_path / "ck"
    jsharded.save_sharded(ck, jpartition.shard_tree(
        jmesh.fsdp_tp_mesh(2, 2), JRULES, host), step=4)
    assert checkpoint_info(ck)["n_shards"] > len(
        tpartition.tree_paths(host))
    _assert_same(restore_sharded(ck), host)
    shape = {tmesh.DATA_AXIS: target[0], tmesh.MODEL_AXIS: target[1]}
    leaves = dict(tpartition.tree_paths(host))
    for d in range(target[0]):
        for m in range(target[1]):
            mesh = tmesh.Mesh(shape, {tmesh.DATA_AXIS: d,
                                      tmesh.MODEL_AXIS: m}, {})
            specs = dict(tpartition.tree_paths(
                worker.RULES.specs(host, mesh=mesh)))
            for name, got in tpartition.tree_paths(
                    restore_sharded(ck, mesh=mesh, rules=worker.RULES)):
                want = tmesh.put_with_sharding(
                    leaves[name], tmesh.Sharding(mesh, specs[name]))
                assert torch.equal(got, want), (name, d, m)


@pytest.mark.parametrize("damage,match", [
    ("manifest", "no MANIFEST.json"),
    ("corrupt", "fails its manifest sha256"),
    ("missing", "file is missing"),
    ("format", "format 99"),
])
def test_torn_corrupt_missing_and_foreign_checkpoints_refused(tmp_path,
                                                              damage, match):
    """A torn save (no manifest), a shard whose bytes fail their sha256,
    a shard file deleted and a manifest of another format are refused
    with the JAX package's lessons, by both packages alike."""
    ck = tmp_path / "ck"
    save_sharded(ck, _port_tree(_host(2)))
    manifest = json.loads((ck / MANIFEST_NAME).read_text())
    shard = manifest["leaves"]["w1"]["shards"][0]["file"]
    if damage == "manifest":
        (ck / MANIFEST_NAME).unlink()
    elif damage == "corrupt":
        buf = bytearray((ck / shard).read_bytes())
        buf[7] ^= 0xFF
        (ck / shard).write_bytes(bytes(buf))
    elif damage == "missing":
        (ck / shard).unlink()
    else:
        manifest["format"] = 99
        (ck / MANIFEST_NAME).write_text(json.dumps(manifest))
    for restore in (restore_sharded, jsharded.restore_sharded):
        with pytest.raises(ValueError, match=match):
            restore(ck)


def test_dead_rule_mesh_xor_rules_and_template(tmp_path):
    """A rule matching none of the checkpoint's leaves is refused (and
    allowed with check_dead=False); mesh without rules and rules without
    mesh are errors; `template` fixes the structure, and a template
    naming other leaves is refused."""
    host = worker.tree(3)
    save_sharded(tmp_path / "ck", _port_tree(host))
    mesh = tmesh.Mesh({tmesh.DATA_AXIS: 2}, {tmesh.DATA_AXIS: 1}, {})
    stale = tpartition.PartitionRules((
        (r"decoder/.*", tmesh.PartitionSpec(tmesh.MODEL_AXIS)),
        (r".*", tmesh.PartitionSpec())))
    with pytest.raises(tpartition.PartitionError, match="dead"):
        restore_sharded(tmp_path / "ck", mesh=mesh, rules=stale)
    out = restore_sharded(tmp_path / "ck", mesh=mesh, rules=stale,
                          check_dead=False)
    _assert_same(out, host)
    for kw in (dict(mesh=mesh), dict(rules=stale)):
        with pytest.raises(CheckpointError, match="BOTH mesh and rules"):
            restore_sharded(tmp_path / "ck", **kw)
    template = {"blocks": {"0": {"bias": 0, "kernel": 0}}, "step": 0,
                "w1": 0}
    back = restore_sharded(tmp_path / "ck", template=template)
    assert back.keys() == template.keys()
    _assert_same(back, host)
    with pytest.raises(CheckpointError, match="leaf mismatch"):
        restore_sharded(tmp_path / "ck", template={"w1": 0})


def test_async_save_events_and_instruments(tmp_path):
    """`wait=False` returns a handle whose `.wait()` is the durability
    point; the ckpt_save / ckpt_restore events carry the JAX package's
    fields, and the registry counts saves, restores and bytes."""

    class Log:
        def __init__(self):
            self.records = []

        def log(self, **record):
            self.records.append(record)

    reg, log = MetricsRegistry(), Log()
    host = worker.tree(5)
    handle = save_sharded(tmp_path / "ck", _port_tree(host), wait=False,
                          logger=log, registry=reg)
    manifest = handle.wait(timeout=60)
    assert handle.done() and manifest["n_shards"] == 4
    stats = {}
    _assert_same(restore_sharded(tmp_path / "ck", stats=stats, logger=log,
                                 registry=reg), host)
    save, restore = log.records
    assert set(save) == {"event", "path", "step", "leaves", "shards",
                         "bytes", "seconds", "background"}
    assert save["event"] == "ckpt_save" and save["background"] is True
    assert set(restore) == {"event", "path", "leaves", "shards_read",
                            "bytes_read", "peak_host_bytes", "seconds",
                            "sharded"}
    assert stats["bytes_read"] == manifest["nbytes"] == save["bytes"]
    text = reg.prometheus_text()
    for name in ("ckpt_saves_total 1", "ckpt_restores_total 1",
                 f"ckpt_bytes_written_total {manifest['nbytes']}",
                 "ckpt_save_seconds_count 1"):
        assert name in text, name


def test_two_gloo_ranks_save_and_restore(tmp_path):
    """Two ranks over gloo each save their blocks under the rules (w1
    split over "data"; the replicated leaves written once, by the rank
    at data 0) and restore them bit for bit; the checkpoint restores
    whole in both packages."""
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, str(Path(worker.__file__)), str(tmp_path / "store"),
         "2", str(r), str(tmp_path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env) for r in range(2)]
    deadline = time.monotonic() + 180
    try:
        while any(p.poll() is None for p in procs):
            if (any(p.poll() not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        logs = [p.communicate(timeout=30)[0].decode() for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    assert all((tmp_path / f"done.{r}").exists() for r in range(2))
    info = checkpoint_info(tmp_path / "ck")
    assert info["step"] == 5
    assert [len(info["leaves"][n]["shards"]) for n in
            ("w1", "blocks/0/kernel", "step")] == [2, 1, 1]
    host = worker.tree()
    _assert_same(restore_sharded(tmp_path / "ck"), host)
    _assert_same(jsharded.restore_sharded(tmp_path / "ck"), host)
