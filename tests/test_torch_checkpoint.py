"""``tdfo_tpu_torch/train/checkpoint.py`` on the CPU.

* Save then restore into a fresh state is bitwise, dtypes included, for the
  DMP state (f32 and bf16 fat stacks, their slots, AdamW's moments and step
  counters, ``step``) and for the dense ``TwoTower`` state (every table
  under AdamW, and a dynamic loss scale).
* The reference's refusals: a foreign layout version, a payload without a
  layout stamp, and any stamps mismatch (both sides); a tree that does not
  match the run's (missing key, shape, dtype) refuses naming the key.
* ``max_to_keep`` prunes the step directories and their cursor / stamps
  sidecars; a save cut off half-way (a hidden temporary directory, or a
  step directory without its payload) is never the newest step, and a
  Trainer resumes from the last complete one.
"""

import json

import jax  # noqa: F401  (the test process holds both packages)
import numpy as np
import pytest
import torch

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.core.precision import DynamicLossScale
from tdfo_tpu_torch.train import checkpoint as ckpt_mod
from tdfo_tpu_torch.train.checkpoint import LAYOUT_VERSION, CheckpointManager
from tdfo_tpu_torch.train.trainer import Trainer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are tiny, and the suite runs
    several test processes at once, whose thread pools would otherwise
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SIZE_MAP = {"user": 40, "item": 30, "language": 4, "is_ebook": 2,
            "format": 3, "publisher": 5, "pub_decade": 6}
B = 16


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return _leaves(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def _assert_same(a, b):
    fa, fb = _leaves(a), _leaves(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert x == y, k


def _batch(rng):
    b = {f"{f}_id" if f in ("user", "item") else f:
         torch.from_numpy(rng.integers(0, v, B).astype(np.int32))
         for f, v in SIZE_MAP.items()}
    b["avg_rating"] = torch.from_numpy(rng.random(B).astype(np.float32))
    b["num_pages"] = torch.from_numpy(rng.random(B).astype(np.float32))
    b["label"] = torch.from_numpy(rng.integers(0, 2, B).astype(np.int8))
    return b


def _trainer(tmp_path, **kw):
    cfg = dict(data_dir=str(tmp_path), model="twotower", model_parallel=True,
               embed_dim=16, fused_table_threshold=0, size_map=SIZE_MAP,
               learning_rate=3e-3)
    cfg.update(kw)
    extra = cfg.pop("embeddings", None)
    if extra:
        cfg["embeddings"] = extra
    return Trainer(read_configs(None, **cfg), device="cpu")


def _trained(tmp_path, steps=2, **kw):
    tr = _trainer(tmp_path, **kw)
    rng = np.random.default_rng(0)
    for _ in range(steps):
        tr.state, _ = tr.train_step(tr.state, _batch(rng))
    return tr


@pytest.mark.parametrize("kw", [
    {},
    {"embeddings": {"table_dtype": "bfloat16", "slot_dtype": "bfloat16"}},
    {"model_parallel": False},
], ids=["sparse_f32", "sparse_bf16", "dense"])
def test_roundtrip_is_bitwise(tmp_path, kw):
    tr = _trained(tmp_path, **kw)
    saved = tr.state.state_dict()
    assert saved["step"] == 2
    if "embeddings" in kw:
        assert any(t.dtype == torch.bfloat16 and t.dim() == 3
                   for t in saved["tables"].values())
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(2, tr.state, cursor={"epoch": 0, "step": 2})
    fresh = _trainer(tmp_path, **kw)
    step, state, cursor = mgr.restore(fresh.state)
    assert (step, cursor) == (2, {"epoch": 0, "step": 2})
    assert state is fresh.state
    _assert_same(state.state_dict(), saved)
    # the restored state keeps training exactly as the saved one does
    rng = np.random.default_rng(5)
    b = _batch(rng)
    _, la = tr.train_step(tr.state, b)
    _, lb = fresh.train_step(fresh.state, b)
    assert torch.equal(la[0], lb[0])
    _assert_same(fresh.state.state_dict(), tr.state.state_dict())


def test_dense_state_with_loss_scale_roundtrip(tmp_path):
    tr = _trained(tmp_path, model_parallel=False)
    ls = DynamicLossScale.create(initial_scale=2.0**10)
    tr.state.loss_scale = ls
    ls.growth_counter.fill_(7)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(4, tr.state)
    fresh = _trainer(tmp_path, model_parallel=False)
    fresh.state.loss_scale = DynamicLossScale.create()
    mgr.restore(fresh.state)
    assert float(fresh.state.loss_scale.scale) == 2.0**10
    assert int(fresh.state.loss_scale.growth_counter) == 7
    _assert_same(fresh.state.state_dict(), tr.state.state_dict())


def test_plain_tree_and_refusals(tmp_path, monkeypatch):
    state = {"w": torch.arange(6.0).reshape(2, 3), "n": 4}
    mgr = CheckpointManager(tmp_path / "ok")
    mgr.save(0, state)
    step, restored, cursor = mgr.restore(state)
    assert step == 0 and cursor is None and restored["n"] == 4
    assert torch.equal(restored["w"], state["w"])
    # a foreign layout version: refused with both versions named
    old = CheckpointManager(tmp_path / "old")
    monkeypatch.setattr(ckpt_mod, "LAYOUT_VERSION", LAYOUT_VERSION - 1)
    old.save(0, state)
    monkeypatch.setattr(ckpt_mod, "LAYOUT_VERSION", LAYOUT_VERSION)
    with pytest.raises(ValueError, match="layout version 2, but this build uses 3"):
        old.restore(state)
    # a payload without the stamp (the pre-versioning form): refused
    legacy = tmp_path / "legacy" / "0"
    legacy.mkdir(parents=True)
    torch.save({"state": state}, legacy / "state.pt")
    with pytest.raises(ValueError, match="layout_version stamp"):
        CheckpointManager(tmp_path / "legacy").restore(state)
    # a tree that is not this run's
    for bad, key in (({"w": torch.zeros(3, 2), "n": 4}, "w"),
                     ({"w": torch.zeros(2, 3, dtype=torch.float64), "n": 4}, "w"),
                     ({"w": state["w"], "n": 4, "extra": torch.ones(1)}, "extra"),
                     ({"w": state["w"]}, "n")):
        with pytest.raises(ValueError, match=key):
            mgr.restore(bad)
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(0, state)
    mgr.save(0, state, force=True)


def test_stamps_mismatch_refused(tmp_path):
    state = {"w": torch.arange(4.0)}
    stamps = {"table_dtype": {"t0": "bfloat16"}, "slot_dtype": "bfloat16"}
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(0, state, stamps=stamps)
    assert mgr.restore(state, stamps=dict(stamps))[0] == 0
    for bad in (None, {"table_dtype": {"t0": "float32"}, "slot_dtype": "bfloat16"},
                {"other": 1}):
        with pytest.raises(ValueError, match="stamps"):
            mgr.restore(state, stamps=bad)
    mgr2 = CheckpointManager(tmp_path / "ck2")
    mgr2.save(0, state)
    with pytest.raises(ValueError, match="stamps"):
        mgr2.restore(state, stamps=stamps)
    # the trainer stamps bf16 storage, and not the f32 defaults
    bf16 = _trainer(tmp_path, embeddings={"table_dtype": "bfloat16"})
    assert bf16._ckpt_stamps["slot_dtype"] == "float32"
    assert set(bf16._ckpt_stamps["table_dtype"].values()) == {"bfloat16"}
    assert _trainer(tmp_path)._ckpt_stamps is None


def test_sidecars_pruned_with_their_step(tmp_path):
    state = {"w": torch.arange(4.0)}
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    for step in (3, 6, 9):
        mgr.save(step, state, stamps={"s": step},
                 cursor={"epoch": 0, "step": step, "epoch_complete": False,
                         "global_step": step})
    assert mgr.all_steps() == [6, 9]
    assert not (tmp_path / "cursor_3.json").exists()
    assert not (tmp_path / "stamps_3.json").exists()
    assert not (tmp_path / "3").exists()
    assert json.loads((tmp_path / "cursor_9.json").read_text())["step"] == 9
    step, _, cursor = mgr.restore(state, stamps={"s": 9})
    assert step == 9 and cursor["global_step"] == 9
    mgr.save(9, state, force=True)  # replaced without sidecars: none linger
    assert mgr.read_cursor(9) is None and not (tmp_path / "stamps_9.json").exists()


def test_half_written_save_does_not_poison_resume(tmp_path):
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    data = tmp_path / "data"
    write_synthetic_goodreads(data)
    size_map = run_ctr_preprocessing(data)
    cfg = read_configs(None, data_dir=str(data), model="twotower", embed_dim=8,
                       n_epochs=1, per_device_train_batch_size=256,
                       per_device_eval_batch_size=256, size_map=size_map,
                       checkpoint_dir=str(tmp_path / "ck"))
    Trainer(cfg, device="cpu").fit()
    mgr = CheckpointManager(tmp_path / "ck")
    s0 = mgr.latest_step()
    assert mgr.read_cursor(s0)["epoch_complete"]
    # a kill during a later save: its temporary directory (partial payload)
    # and a step directory whose payload never arrived
    tmp = tmp_path / "ck" / f".tmp_{s0 + 5}_123"
    tmp.mkdir()
    (tmp / "state.pt").write_bytes(b"\x80\x02partial")
    (tmp_path / "ck" / str(s0 + 9)).mkdir()
    assert mgr.latest_step() == s0
    tr2 = Trainer(cfg.replace(n_epochs=2), device="cpu")
    assert not tmp.exists()  # cleared when the manager opens
    assert tr2._ckpt.latest_step() == s0
    m = tr2.fit()  # resumes after epoch 0 and trains epoch 1
    assert 0.0 <= m["auc"] <= 1.0
    s1 = tr2._ckpt.latest_step()
    assert s1 == 2 * s0 and tr2._ckpt.read_cursor(s1)["epoch"] == 1
