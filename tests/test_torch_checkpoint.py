"""The port's checkpoints (idc_models_tpu_torch/train/checkpoint.py): the
JAX package's contracts (atomic save, completion marker, content digest,
load_or_train's retrain over torn or corrupt state) in the port's npz
format, and the digest formula against the JAX package's _tree_digest."""

from __future__ import annotations

import json
import warnings

import numpy as np
import pytest
import torch

from idc_models_tpu.train import checkpoint as jckpt
from idc_models_tpu_torch.train import checkpoint as tckpt


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"round": np.int32(3),
            "params": {"head": {"kernel": rng.normal(size=(4, 1)).astype(
                np.float32), "bias": np.zeros(1, np.float32)},
                "stem": {"kernel": rng.normal(size=(3, 3, 3, 4)).astype(
                    np.float32)}},
            "model_state": {"bn": {"mean": rng.normal(size=4),
                                   "count": np.arange(3, dtype=np.int64)}}}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("seed", [0, 1])
def test_digest_equals_the_jax_tree_digest(seed):
    """The same numpy tree digests the same in both packages (JAX's
    flatten order: sorted keys at every level), and torch leaves digest
    as their numpy values."""
    tree = _tree(seed)
    want = jckpt._tree_digest(tree)
    assert tckpt._tree_digest(tree) == want
    assert tckpt._tree_digest(_as_torch(tree)) == want
    # key order in the dicts does not matter; a changed bit does
    flipped = {k: tree[k] for k in reversed(list(tree))}
    assert tckpt._tree_digest(flipped) == want
    tree["params"]["head"]["bias"][0] = 1e-30
    assert tckpt._tree_digest(tree) != want


def test_round_trip_onto_the_target_device_and_dtype(tmp_path):
    tree = _as_torch(_tree())
    tree["empty"] = {}                   # a subtree without leaves
    path = tmp_path / "ckpt"
    assert not tckpt.checkpoint_exists(path)
    tckpt.save_checkpoint(path, tree)
    assert tckpt.checkpoint_exists(path)
    assert sorted(p.name for p in path.iterdir()) == [
        "_IDC_COMPLETE", "_IDC_DIGEST.json", "state.npz"]
    target = _as_torch(_tree(9))
    target["empty"] = {}
    target["round"] = 0
    got = tckpt.restore_checkpoint(path, target)
    assert got["round"] == 3 and isinstance(got["round"], int)
    assert got["empty"] == {}
    for (k, g), (_, w) in zip(_leaves({**got, "round": None}),
                              _leaves({**tree, "round": None})):
        if w is None:
            continue
        assert g.dtype == w.dtype and g.device == torch.device("cpu"), k
        assert torch.equal(g, w), k
    # target=None gives the saved tree back as numpy, without the empty
    # subtree (it has no leaf to save)
    raw = tckpt.restore_checkpoint(path)
    np.testing.assert_array_equal(raw["params"]["stem"]["kernel"],
                                  tree["params"]["stem"]["kernel"].numpy())
    assert "empty" not in raw


def test_save_is_atomic_and_replaces(tmp_path):
    """A leftover <path>.tmp from a crash is cleared, an existing
    checkpoint is replaced whole, and no .old directory is left."""
    path = tmp_path / "ckpt"
    (tmp_path / "ckpt.tmp").mkdir()
    (tmp_path / "ckpt.tmp" / "junk").write_text("x")
    tckpt.save_checkpoint(path, _tree(0))
    tckpt.save_checkpoint(path, _tree(1))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt"]
    got = tckpt.restore_checkpoint(path)
    np.testing.assert_array_equal(got["params"]["head"]["kernel"],
                                  _tree(1)["params"]["head"]["kernel"])


def test_torn_directory_is_refused(tmp_path):
    path = tmp_path / "ckpt"
    tckpt.save_checkpoint(path, _tree())
    (path / "_IDC_COMPLETE").unlink()
    assert not tckpt.checkpoint_exists(path)
    with pytest.raises(ValueError, match="no completion marker"):
        tckpt.restore_checkpoint(path, _tree())


@pytest.mark.parametrize("how", ["flip", "truncate", "rewrite"])
def test_corrupt_checkpoint_raises_value_error(tmp_path, how):
    """A flipped byte, a truncated file, or content rewritten behind the
    digest's back: each raises ValueError naming the checkpoint."""
    path = tmp_path / "ckpt"
    tckpt.save_checkpoint(path, _tree())
    f = path / "state.npz"
    data = bytearray(f.read_bytes())
    if how == "flip":
        data[len(data) // 2] ^= 0x01
        f.write_bytes(bytes(data))
    elif how == "truncate":
        f.write_bytes(bytes(data[:len(data) // 2]))
    else:
        other = _tree(1)
        np.savez(f, **{"/".join(k): v for k, v in _leaves(other)})
    with pytest.raises(ValueError, match=str(path)):
        tckpt.restore_checkpoint(path, _tree())
    if how == "rewrite":
        with pytest.raises(ValueError, match="CORRUPT"):
            tckpt.restore_checkpoint(path)


def test_target_that_does_not_fit_raises(tmp_path):
    path = tmp_path / "ckpt"
    tckpt.save_checkpoint(path, _as_torch(_tree()))
    bad = _as_torch(_tree())
    bad["params"]["head"]["kernel"] = torch.zeros(5, 1)
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, bad)
    del bad["params"]["stem"]
    with pytest.raises(ValueError, match="keys"):
        tckpt.restore_checkpoint(path, bad)


def test_load_or_train_trains_restores_and_retrains_over_damage(tmp_path):
    path = tmp_path / "pretrained" / "cp.ckpt"
    calls = []

    def train():
        calls.append(1)
        return _tree(len(calls))

    tree, restored = tckpt.load_or_train(path, _tree(), train)
    assert not restored and len(calls) == 1
    tree, restored = tckpt.load_or_train(path, _tree(), train)
    assert restored and len(calls) == 1
    np.testing.assert_array_equal(tree["params"]["head"]["kernel"],
                                  _tree(1)["params"]["head"]["kernel"])
    # torn: retrained over, with the torn-partial warning
    (path / "_IDC_COMPLETE").unlink()
    with pytest.warns(UserWarning, match="no completion marker"):
        _, restored = tckpt.load_or_train(path, _tree(), train)
    assert not restored and len(calls) == 2
    # corrupt: retrained over, with the unrestorable warning
    digest = path / "_IDC_DIGEST.json"
    digest.write_text(json.dumps({"sha256": "0" * 64}))
    with pytest.warns(UserWarning, match="unrestorable"):
        _, restored = tckpt.load_or_train(path, _tree(), train)
    assert not restored and len(calls) == 3
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, restored = tckpt.load_or_train(path, _tree(), train)
    assert restored and len(calls) == 3
