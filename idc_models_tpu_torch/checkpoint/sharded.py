"""Sharded checkpoints keyed on `partition.py` rules, the counterpart of
``idc_models_tpu/checkpoint/sharded.py`` -- the same on-disk format byte
for byte, so a checkpoint either package writes restores in the other.

- **Save** walks `partition.tree_paths(tree)` and writes each leaf's
  blocks that this rank holds as replica 0 (so every distinct block is
  written exactly once across ranks), one block in host memory at a
  time. A leaf is whole (written by rank 0), or this rank's block under
  the `Sharding` that `shardings` gives it (the layout
  ``mesh.put_with_sharding`` cut it by). Each shard file carries its own
  sha256 and is committed tmp-then-`os.replace`, so a torn write is
  never readable under its final name.
- **The manifest is the completion contract**: every rank writes a
  ``_SHARDS.p<i>.json`` fragment listing its committed shards; after a
  barrier over the ``torch.distributed`` world (a no-op without one)
  rank 0 merges them into ``MANIFEST.json``. A directory without a
  manifest is a torn checkpoint and restore refuses it.
- **Restore re-resolves rules against the TARGET mesh**: with `mesh`
  and `rules` each leaf comes back as this rank's block under the rules
  on that mesh, assembled from only the saved shards that OVERLAP it,
  so a checkpoint saved under one layout or rank count restores bit for
  bit under another; without them, each leaf whole on the host. Every
  shard's sha256 is checked before its bytes are used.
- **Async**: ``save_sharded(..., wait=False)`` returns a `SaveHandle`
  whose thread fetches, writes and commits; ``.wait()`` is the
  durability point, and the tree must not change before it.

Leaves come back as numpy arrays, except bfloat16 leaves (numpy has no
such type): those are ``torch.bfloat16`` tensors. Events (the JAX
package's frozen schemas): ``ckpt_save`` and ``ckpt_restore``, one per
completed operation; registry instruments ``ckpt_saves_total``,
``ckpt_restores_total``, ``ckpt_bytes_written_total``,
``ckpt_bytes_read_total`` and the ``ckpt_save_seconds`` /
``ckpt_restore_seconds`` histograms.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import torch

from idc_models_tpu_torch import collectives
from idc_models_tpu_torch import mesh as meshlib
from idc_models_tpu_torch import partition

MANIFEST_NAME = "MANIFEST.json"
FORMAT_VERSION = 1
_FRAGMENT = "_SHARDS.p{}.json"
_BF16 = "bfloat16"


class CheckpointError(ValueError):
    """A torn, corrupt or mismatched checkpoint, with a teaching
    message."""


def barrier(tag: str) -> None:
    """The cross-rank sync point of a save (a no-op in a one-rank run):
    between "every rank committed its shards" and "rank 0 commits the
    manifest", and between that and any rank returning."""
    del tag
    if collectives.axis_size() > 1:
        torch.distributed.barrier()


def _registry(registry):
    if registry is not None:
        return registry
    from idc_models_tpu_torch.observe.metrics_registry import REGISTRY

    return REGISTRY


def _instruments(reg):
    return {
        "saves": reg.counter(
            "ckpt_saves_total", "completed sharded checkpoint saves"),
        "restores": reg.counter(
            "ckpt_restores_total",
            "completed sharded checkpoint restores"),
        "bytes_written": reg.counter(
            "ckpt_bytes_written_total",
            "shard bytes committed by sharded saves"),
        "bytes_read": reg.counter(
            "ckpt_bytes_read_total",
            "shard bytes read by sharded restores"),
        "save_s": reg.histogram(
            "ckpt_save_seconds", "wall seconds per sharded save"),
        "restore_s": reg.histogram(
            "ckpt_restore_seconds", "wall seconds per sharded restore"),
    }


def _dtype_str(leaf) -> str:
    """The manifest's dtype string: numpy's name (``float32``), and
    ``bfloat16`` for torch's bf16."""
    if torch.is_tensor(leaf):
        if leaf.dtype == torch.bfloat16:
            return _BF16
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _host_bytes(arr) -> bytes:
    """A block's raw C-order bytes (a tensor is fetched to the host;
    bf16 goes through its 16-bit pattern)."""
    if torch.is_tensor(arr):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(arr).tobytes()


def _read_dtype(s: str):
    """The numpy dtype a shard's bytes are read as (bf16: its 16-bit
    pattern)."""
    return np.dtype(np.uint16) if s == _BF16 else np.dtype(s)


def _shard_file(name: str, spans) -> str:
    """Deterministic shard filename: leaf path + the block's start
    offsets (unique per block)."""
    corner = "_".join(str(lo) for lo, _ in spans) or "scalar"
    return f"{name.replace('/', '.')}@{corner}"


def _replica0(sharding) -> bool:
    """Whether this rank holds replica 0 of its block under `sharding`:
    inside the mesh, at coordinate 0 on every axis the spec does not
    split."""
    mesh = sharding.mesh
    if mesh.coords is None:
        return False
    used = {a for e in sharding.spec for a in meshlib.axes_of(e)}
    return not any(mesh.axis_index(a) for a in mesh.axis_names
                   if a not in used)


def _block_spans(shape, sharding) -> tuple:
    """((start, stop), ...) of this rank's block of a leaf of `shape`
    under `sharding`."""
    mesh, spec = sharding.mesh, sharding.spec
    spans = []
    for dim, d in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        parts, index = 1, 0
        for a in meshlib.axes_of(entry):
            parts *= mesh.axis_size(a)
            index = index * mesh.axis_size(a) + mesh.axis_index(a)
        size = d // parts
        spans.append((index * size, (index + 1) * size))
    return tuple(spans)


def _leaf_shards(leaf, sharding):
    """[(full shape, spans, block)] for THIS rank's replica-0 block of
    one leaf: a whole leaf on rank 0 only, or the block `leaf` is under
    `sharding` (its full shape the block's times the parts)."""
    block_shape = tuple(getattr(leaf, "shape", np.shape(leaf)))
    if sharding is None:
        if collectives.axis_index() != 0:
            return block_shape, []
        return block_shape, [(tuple((0, d) for d in block_shape), leaf)]
    full = list(block_shape)
    for dim, entry in enumerate(sharding.spec):
        full[dim] *= meshlib._split(sharding.mesh, entry)[1]
    full = tuple(full)
    if not _replica0(sharding):
        return full, []
    return full, [(_block_spans(full, sharding), leaf)]


def _write_bytes(dirpath: Path, relfile: str, buf: bytes) -> str:
    """THE atomic byte commit: write to a tmp name, fsync, rename into
    place. Returns the sha256 hex."""
    h = hashlib.sha256(buf).hexdigest()
    tmp = dirpath / (relfile + ".tmp")
    with open(tmp, "wb") as f:
        f.write(buf)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, dirpath / relfile)
    return h


def _commit_json(dirpath: Path, relfile: str, doc: dict) -> None:
    """Atomic JSON commit: the manifest, fragment and sidecar writer."""
    _write_bytes(dirpath, relfile,
                 json.dumps(doc, sort_keys=True).encode())


class SaveHandle:
    """An in-flight (or finished) sharded save. `.wait()` is the
    durability point: it joins the writer, re-raises its failure and
    returns the committed manifest."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._manifest: dict | None = None
        self._error: BaseException | None = None

    def done(self) -> bool:
        return self._thread is None or not self._thread.is_alive()

    def wait(self, timeout: float | None = None) -> dict:
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError("sharded save still writing")
        if self._error is not None:
            raise self._error
        assert self._manifest is not None
        return self._manifest

    @property
    def manifest(self) -> dict:
        return self.wait()


def save_sharded(path, tree, *, step: int | None = None,
                 wait: bool = True, logger=None, registry=None,
                 shardings=None) -> SaveHandle:
    """Write `tree` (nested dicts/lists of tensors or arrays) as a
    sharded checkpoint under `path`.

    `shardings` (a tree of `mesh.Sharding` matching `tree`, or None for
    whole leaves) says which block of its leaf each leaf of `tree` is.
    Every rank writes only its replica-0 blocks, one resident at a time,
    then rank 0 commits ``MANIFEST.json`` behind a barrier. Every rank
    of the world must call it.

    ``wait=False`` runs the fetch/write/commit on a background thread
    and returns at once; call ``.wait()`` before changing the tree."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    proc = collectives.axis_index()
    shards_of = (dict(partition.tree_paths(shardings))
                 if shardings is not None else {})
    plan = []                      # (name, spans, block)
    leaves = {}
    for name, leaf in partition.tree_paths(tree):
        full, blocks = _leaf_shards(leaf, shards_of.get(name))
        leaves[name] = {"shape": list(full), "dtype": _dtype_str(leaf),
                        "shards": []}
        for spans, block in blocks:
            plan.append((name, spans, block))
    reg = _instruments(_registry(registry))
    handle = SaveHandle()

    def _run() -> None:
        t0 = time.perf_counter()
        frag: dict[str, list] = {}
        total = 0
        for name, spans, block in plan:
            buf = _host_bytes(block)            # ONE block resident
            relfile = _shard_file(name, spans)
            digest = _write_bytes(path, relfile, buf)
            frag.setdefault(name, []).append({
                "file": relfile, "index": [list(s) for s in spans],
                "sha256": digest, "bytes": len(buf)})
            total += len(buf)
            del buf
        _commit_json(path, _FRAGMENT.format(proc), frag)
        barrier("save-shards")
        if proc == 0:
            n_shards = 0
            for fp in sorted(path.glob(_FRAGMENT.format("*"))):
                for name, shards in json.loads(fp.read_text()).items():
                    leaves[name]["shards"].extend(shards)
                    n_shards += len(shards)
            manifest = {
                "format": FORMAT_VERSION, "step": step,
                "leaves": leaves, "n_shards": n_shards,
                "nbytes": sum(s["bytes"] for rec in leaves.values()
                              for s in rec["shards"])}
            for name, rec in leaves.items():
                if not rec["shards"]:
                    raise CheckpointError(
                        f"no process wrote any shard of leaf {name!r} "
                        f"— the manifest would commit a hole")
                rec["shards"].sort(key=lambda s: s["file"])
            _commit_json(path, MANIFEST_NAME, manifest)
            for fp in path.glob(_FRAGMENT.format("*")):
                fp.unlink()
        else:
            manifest = None
        barrier("save-manifest")
        if manifest is None:
            manifest = json.loads((path / MANIFEST_NAME).read_text())
        dt = time.perf_counter() - t0
        reg["saves"].inc()
        reg["bytes_written"].inc(total)
        reg["save_s"].observe(dt)
        if logger is not None:
            logger.log(event="ckpt_save", path=str(path), step=step,
                       leaves=len(leaves), shards=len(plan),
                       bytes=total, seconds=round(dt, 6),
                       background=not wait)
        handle._manifest = manifest

    if wait:
        _run()
        return handle

    def _guarded() -> None:
        try:
            _run()
        except BaseException as e:          # surfaced at .wait()
            handle._error = e

    handle._thread = threading.Thread(target=_guarded,
                                      name="ckpt-save", daemon=True)
    handle._thread.start()
    return handle


def checkpoint_info(path) -> dict:
    """The committed manifest, or a CheckpointError teaching why the
    directory is not a restorable checkpoint (missing = torn save)."""
    path = Path(path)
    mf = path / MANIFEST_NAME
    if not mf.exists():
        raise CheckpointError(
            f"{path} has no {MANIFEST_NAME} — not a completed sharded "
            f"checkpoint. The manifest is the atomic completion "
            f"contract (committed last, behind a barrier): its absence "
            f"means the save was interrupted or this directory never "
            f"held a checkpoint. Re-save, or point at a directory "
            f"containing {MANIFEST_NAME}")
    try:
        manifest = json.loads(mf.read_text())
    except ValueError as e:
        raise CheckpointError(
            f"{mf} is not valid JSON ({e}) — the manifest commit is "
            f"atomic (tmp + rename), so this is disk corruption, not "
            f"a torn write; the checkpoint cannot be trusted") from e
    if manifest.get("format") != FORMAT_VERSION:
        raise CheckpointError(
            f"{mf} is format {manifest.get('format')!r}, this reader "
            f"speaks {FORMAT_VERSION}")
    return manifest


def _read_shard(path: Path, shard: dict, dtype, verified: set,
                stats: dict) -> np.ndarray:
    """One saved shard back as an array, sha256-verified the first time
    this restore touches its file."""
    fp = path / shard["file"]
    if not fp.exists():
        raise CheckpointError(
            f"manifest names shard {shard['file']!r} but the file is "
            f"missing from {path} — the checkpoint directory was "
            f"partially deleted; restore refuses to fabricate the "
            f"block")
    buf = fp.read_bytes()
    if shard["file"] not in verified:
        if hashlib.sha256(buf).hexdigest() != shard["sha256"]:
            raise CheckpointError(
                f"shard {shard['file']!r} fails its manifest sha256 — "
                f"bytes on disk are not the bytes the save committed "
                f"(bit rot or tampering); refusing to restore a "
                f"corrupt block")
        verified.add(shard["file"])
    stats["bytes_read"] = stats.get("bytes_read", 0) + len(buf)
    stats["shards_read"] = stats.get("shards_read", 0) + 1
    shape = tuple(hi - lo for lo, hi in shard["index"])
    if len(buf) != shard["bytes"] or len(buf) != (
            int(np.prod(shape)) * dtype.itemsize):
        raise CheckpointError(
            f"shard {shard['file']!r} holds {len(buf)} bytes but the "
            f"manifest promised {shard['bytes']} for a {shape} block")
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _assemble(path: Path, rec: dict, spans, verified: set,
              stats: dict) -> np.ndarray:
    """The requested block of one leaf, assembled from only the saved
    shards that OVERLAP it -- one saved shard resident at a time."""
    dtype = _read_dtype(rec["dtype"])
    out = np.empty(tuple(hi - lo for lo, hi in spans), dtype)
    filled = 0
    for shard in rec["shards"]:
        inter = [(max(lo, slo), min(hi, shi))
                 for (lo, hi), (slo, shi) in zip(spans, shard["index"])]
        if any(lo >= hi for lo, hi in inter):
            continue
        data = _read_shard(path, shard, dtype, verified, stats)
        src = tuple(slice(lo - slo, hi - slo) for (lo, hi), (slo, _)
                    in zip(inter, shard["index"]))
        dst = tuple(slice(lo - rlo, hi - rlo) for (lo, hi), (rlo, _)
                    in zip(inter, spans))
        out[dst] = data[src]
        stats["peak_host_bytes"] = max(stats.get("peak_host_bytes", 0),
                                       out.nbytes + data.nbytes)
        filled += int(np.prod([hi - lo for lo, hi in inter]))
        del data
    if filled != out.size:
        raise CheckpointError(
            f"saved shards cover {filled} of {out.size} elements of a "
            f"requested block — the manifest's shards do not tile the "
            f"leaf (a save bug, not a mesh mismatch: restore handles "
            f"any target layout)")
    stats["peak_host_bytes"] = max(stats.get("peak_host_bytes", 0),
                                   out.nbytes)
    if rec["dtype"] == _BF16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def restore_sharded(path, *, mesh=None, rules=None, template=None,
                    check_dead: bool = True, stats: dict | None = None,
                    logger=None, registry=None):
    """Load a sharded checkpoint back as a tree.

    With `mesh` + `rules` each leaf's spec is re-resolved against the
    TARGET mesh (`rules.spec_for` + `partition.adapt`) and the leaf
    comes back as this rank's block, a host tensor assembled from the
    overlapping saved shards -- the save-time
    layout and rank count are irrelevant. Without a mesh each leaf comes
    back whole as a host array.

    `template` (a tree with the same leaf names) fixes the tree
    STRUCTURE; by default the manifest's "a/b/c" names rebuild nested
    dicts. `stats`, if a dict, is filled with bytes_read / shards_read /
    peak_host_bytes."""
    if (mesh is None) != (rules is None):
        raise CheckpointError(
            "pass BOTH mesh and rules (sharded restore re-resolves the "
            "rules against the target mesh) or neither (host restore)")
    t0 = time.perf_counter()
    manifest = checkpoint_info(path)
    path = Path(path)
    recs = manifest["leaves"]
    stats = stats if stats is not None else {}
    verified: set[str] = set()

    def build(name: str, rec: dict):
        shape = tuple(rec["shape"])
        if mesh is None:
            return _assemble(path, rec, tuple((0, d) for d in shape),
                             verified, stats)
        spec = partition.adapt(rules.spec_for(name, shape), shape, mesh)
        spans = _block_spans(shape, meshlib.Sharding(mesh, spec))
        block = _assemble(path, rec, spans, verified, stats)
        return block if torch.is_tensor(block) else torch.from_numpy(block)

    if rules is not None and check_dead:
        # a rule matching none of the checkpoint's leaves is the silent
        # sharding loss shard_tree refuses
        live = {i for n in recs
                for i in [rules._match(n)[0]] if i is not None}
        dead = [rules.patterns[i] for i in range(len(rules.patterns))
                if i not in live]
        if dead:
            raise partition.PartitionError(
                f"dead partition rule(s) {dead}: they match none of "
                f"the {len(recs)} checkpointed leaves — the rule set "
                f"and this checkpoint describe different models "
                f"(restore with check_dead=False for a deliberately "
                f"partial rule set)")

    built = {name: build(name, rec) for name, rec in recs.items()}
    if template is not None:
        t_names = [n for n, _ in partition.tree_paths(template)]
        missing = [n for n in t_names if n not in built]
        extra = [n for n in built if n not in t_names]
        if missing or extra:
            raise CheckpointError(
                f"template/checkpoint leaf mismatch: template-only "
                f"{missing}, checkpoint-only {extra} — the template "
                f"must name exactly the saved leaves")
        it = iter(built[n] for n in t_names)
        tree = partition.tree_map(lambda _: next(it), template)
    else:
        tree = {}
        for name, leaf in built.items():
            node, parts = tree, name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = leaf
    dt = time.perf_counter() - t0
    reg = _instruments(_registry(registry))
    reg["restores"].inc()
    reg["bytes_read"].inc(stats.get("bytes_read", 0))
    reg["restore_s"].observe(dt)
    if logger is not None:
        logger.log(event="ckpt_restore", path=str(path),
                   leaves=len(recs),
                   shards_read=stats.get("shards_read", 0),
                   bytes_read=stats.get("bytes_read", 0),
                   peak_host_bytes=stats.get("peak_host_bytes", 0),
                   seconds=round(dt, 6), sharded=mesh is not None)
    return tree
