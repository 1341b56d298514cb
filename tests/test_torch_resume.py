"""Step-granular kill / resume in the PyTorch port, on the CPU.

* The stream cursors: a ``ParquetStream`` or ``MapStream`` that loads the
  ``(seed, epoch, batches_emitted)`` cursor of a partly consumed epoch
  yields exactly that epoch's remaining batches; a cursor of another seed
  is refused.
* Kill mid-epoch after a step checkpoint, restart the same configuration,
  and ``fit`` ends bit for bit where an uninterrupted run ends (every
  tensor of the state, the eval metrics and the epoch's mean loss), for:
  the DMP TwoTower in f32 and in bf16 storage (the stochastic-rounding keys
  fold the restored ``step``), DLRM-Criteo with ``dedup_lookup`` (the
  routed update), Bert4Rec with flash attention and dropout (the per-step
  dropout generator), jagged Bert4Rec, and the dense TwoTower.  For
  Bert4Rec and the dense TwoTower the restarted run uses
  ``steps_per_execution = 4``: the cursor counts single batches, so its
  chunks start at the resume step, and the state still matches the
  uninterrupted single-step run.
"""

import json

import jax  # noqa: F401  (the test process holds both packages)
import numpy as np
import pytest
import torch

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.data.loader import MapStream, ParquetStream, resolve_files
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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return _leaves(dict(enumerate(tree)), prefix)
    return {prefix: tree}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Goodreads CTR shards, Criteo shards, padded and ragged seq shards."""
    from tdfo_tpu_torch.data.criteo_preprocessing import run_criteo_preprocessing
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.seq_preprocessing import run_seq_preprocessing
    from tdfo_tpu_torch.data.synthetic import (
        write_synthetic_criteo,
        write_synthetic_goodreads,
    )

    root = tmp_path_factory.mktemp("resume")
    out = {}
    write_synthetic_goodreads(root / "ctr")
    out["ctr"] = (root / "ctr", run_ctr_preprocessing(root / "ctr"))
    write_synthetic_criteo(root / "criteo")
    out["criteo"] = (root / "criteo", run_criteo_preprocessing(root / "criteo"))
    for name, pad in (("seq", True), ("ragged", False)):
        write_synthetic_goodreads(root / name, n_users=60, n_books=120,
                                  interactions_per_user=(15, 40), seed=3)
        stats = run_seq_preprocessing(root / name, max_len=10, sliding_step=5,
                                      seed=3, pad=pad)
        out[name] = (root / name, {"n_items": stats["n_items"]})
    return out


def _files(data):
    d, _ = data["ctr"]
    return resolve_files(d, "parquet/train_part_*.parquet")


@pytest.mark.parametrize("cls", ["parquet", "map"])
def test_stream_cursor_roundtrip(data, cls):
    files = _files(data)

    def make():
        if cls == "map":
            return MapStream(files, batch_size=64, seed=5)
        return ParquetStream(files, batch_size=64, buffer_size=500, seed=5)

    full = make()
    full.set_epoch(2)
    want = list(full)
    assert len(want) > 6
    part = make()
    part.set_epoch(2)
    it = iter(part)
    for _ in range(4):
        next(it)
    cursor = part.state_dict()
    assert cursor == {"seed": 5, "epoch": 2, "batches_emitted": 4}
    resumed = make()
    resumed.set_epoch(0)
    resumed.load_state_dict(cursor)
    got = list(resumed)
    assert len(got) == len(want) - 4
    for a, b in zip(got, want[4:]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert resumed.state_dict()["batches_emitted"] == len(want)
    with pytest.raises(ValueError, match="seed"):
        make().load_state_dict({"seed": 6, "epoch": 0, "batches_emitted": 1})


CASES = {
    "twotower_f32": ("ctr", dict(model="twotower", model_parallel=True,
                                 fused_table_threshold=0), 1),
    "twotower_bf16": ("ctr", dict(model="twotower", model_parallel=True,
                                  fused_table_threshold=20,
                                  embeddings={"table_dtype": "bfloat16",
                                              "slot_dtype": "bfloat16"}), 1),
    "dlrm_dedup": ("criteo", dict(model="dlrm", stack_tables=True,
                                  dedup_lookup=True,
                                  sparse_optimizer="rowwise_adagrad",
                                  fused_table_threshold=20), 1),
    "bert4rec_flash": ("seq", dict(model="bert4rec", model_parallel=True,
                                   attn="flash", fused_table_threshold=8,
                                   dropout=0.1), 4),
    "bert4rec_jagged": ("ragged", dict(model="bert4rec", model_parallel=True,
                                       jagged=True, fused_table_threshold=8,
                                       dropout=0.1), 1),
    "twotower_dense": ("ctr", dict(model="twotower", model_parallel=False), 4),
}


class _Killed(Exception):
    pass


def _cfg(data, name, ckpt, **kw):
    key, extra, _ = CASES[name]
    d, size_map = data[key]
    seq = extra["model"] == "bert4rec"
    body = dict(data_dir=str(d), n_epochs=1, learning_rate=3e-3, embed_dim=16,
                per_device_train_batch_size=32 if seq else 256,
                per_device_eval_batch_size=32 if seq else 256,
                shuffle_buffer_size=500, log_every_n_steps=2,
                checkpoint_dir=str(ckpt), checkpoint_every_n_steps=3,
                size_map=size_map, seed=11)
    if seq:
        body.update(n_heads=2, n_layers=1, max_len=10, sliding_step=5)
    if extra["model"] == "dlrm":
        from tdfo_tpu_torch.data.criteo_preprocessing import (
            CRITEO_CATEGORICAL,
            CRITEO_CONTINUOUS,
        )

        body.update(categorical_features=list(CRITEO_CATEGORICAL),
                    continuous_features=list(CRITEO_CONTINUOUS))
    body.update({k: v for k, v in extra.items()})
    body.update(kw)
    return read_configs(None, **body)


@pytest.mark.parametrize("name", list(CASES))
def test_kill_resume_is_bitwise(data, tmp_path, name):
    resume_spe = CASES[name][2]
    # run 1: killed before its 6th step (its newest checkpoint: step 3)
    tr = Trainer(_cfg(data, name, tmp_path / "ck"), log_dir=tmp_path / "l1",
                 device="cpu")
    inner, calls = tr.train_step, [0]

    def dying(*args):
        calls[0] += 1
        if calls[0] == 6:
            raise _Killed
        return inner(*args)

    tr.train_step = dying
    with pytest.raises(_Killed):
        tr.fit()
    # run 2: the same configuration (K steps per execution) resumes at 3
    tr2 = Trainer(_cfg(data, name, tmp_path / "ck",
                       steps_per_execution=resume_spe),
                  log_dir=tmp_path / "l2", device="cpu")
    m2 = tr2.fit()
    recs = [json.loads(x) for x in (tmp_path / "l2" / "metrics.jsonl")
            .read_text().splitlines()]
    assert {"resumed_mid_epoch": 0, "step": 3} == {
        k: v for r in recs if "resumed_mid_epoch" in r for k, v in r.items()
        if k in ("resumed_mid_epoch", "step")}
    # run 3: uninterrupted
    tr3 = Trainer(_cfg(data, name, tmp_path / "ck_ref"), log_dir=tmp_path / "l3",
                  device="cpu")
    m3 = tr3.fit()
    assert m2 == m3
    ref = [json.loads(x) for x in (tmp_path / "l3" / "metrics.jsonl")
           .read_text().splitlines()]
    epoch_loss = lambda rs: [r["train_loss_epoch"] for r in rs  # noqa: E731
                             if "train_loss_epoch" in r]
    assert epoch_loss(recs) == epoch_loss(ref)
    a, b = _leaves(tr2.state.state_dict()), _leaves(tr3.state.state_dict())
    assert a.keys() == b.keys() and a["step/"] == b["step/"] > 6
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
