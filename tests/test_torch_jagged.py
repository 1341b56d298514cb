"""Jagged Bert4Rec windows in the PyTorch port, against the JAX package, on
the CPU.

* Every function of ``data/jagged.py`` returns exactly what the JAX
  package's does (int ids; 2-D float values bitwise): offsets, dense
  materialisation with truncation from the head, the per-host form, the
  packing, ``dense_to_jagged`` and ``JaggedTensor``.
* The loader carries ragged windows as object columns only when asked
  (``allow_ragged``); without it a ragged shard fails naming the jagged
  path.
* One epoch from ragged rows equals one epoch from the offline-padded rows
  of the same raw data (the reference's
  ``test_jagged_trainer_matches_padded_trainer``), the losses and the item
  table at the trajectory tolerance of the ladder.
* Bert4Rec with ``model_parallel = false`` (the item table placed
  ``"replicated"``) trains bitwise what ``model_parallel = true`` trains,
  over 3 steps with dropout.
"""

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu.data import jagged as jj
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.data import jagged as tj
from tdfo_tpu_torch.data.seq_preprocessing import run_seq_preprocessing
from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads
from tdfo_tpu_torch.interop import TOL
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


T = 12


def _rows(rng, n, max_len=9, empty=True):
    rows = [rng.integers(1, 50, int(rng.integers(0 if empty else 1, max_len + 1)))
            .astype(np.int32) for _ in range(n)]
    return rows


def test_functions_match_jax_exactly():
    rng = np.random.default_rng(0)
    rows = _rows(rng, 8)
    rows[3] = np.arange(1, 15, dtype=np.int32)  # longer than T: keep the head
    cap = 8 * 16
    tv, tl = tj.pack_rows(rows, cap)
    jv, jl = jj.pack_rows(rows, cap)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tl, jl)
    v, lens = torch.from_numpy(tv), torch.from_numpy(tl)
    np.testing.assert_array_equal(tj.lengths_to_offsets(lens).numpy(),
                                  np.asarray(jj.lengths_to_offsets(jnp.asarray(tl))))
    for pad in (0, 7):
        np.testing.assert_array_equal(
            tj.jagged_to_dense(v, lens, T, pad).numpy(),
            np.asarray(jj.jagged_to_dense(jnp.asarray(tv), jnp.asarray(tl), T, pad)))
    # 2-D values (a float payload per position)
    fv = rng.standard_normal((cap, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tj.jagged_to_dense(torch.from_numpy(fv), lens, T).numpy(),
        np.asarray(jj.jagged_to_dense(jnp.asarray(fv), jnp.asarray(tl), T)))
    # per host: two hosts, each packing its own 4 rows into half the capacity
    halves = [tj.pack_rows(rows[:4], cap // 2), tj.pack_rows(rows[4:], cap // 2)]
    hv = np.concatenate([h[0] for h in halves])
    hl = np.concatenate([h[1] for h in halves])
    for n_hosts, (pv, pl) in ((1, (tv, tl)), (2, (hv, hl))):
        np.testing.assert_array_equal(
            tj.jagged_to_dense_per_host(torch.from_numpy(pv), torch.from_numpy(pl),
                                        T, 0, n_hosts).numpy(),
            np.asarray(jj.jagged_to_dense_per_host(jnp.asarray(pv), jnp.asarray(pl),
                                                   T, 0, n_hosts)))
    with pytest.raises(ValueError, match="divide by n_hosts"):
        tj.jagged_to_dense_per_host(v[:-1], lens, T, 0, 3)
    dense = tj.jagged_to_dense(v, lens, T).numpy()
    short = np.minimum(tl, T)
    np.testing.assert_array_equal(
        tj.dense_to_jagged(torch.from_numpy(dense), torch.from_numpy(short)).numpy(),
        np.asarray(jj.dense_to_jagged(jnp.asarray(dense), jnp.asarray(short))))
    fd = rng.standard_normal((8, T, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tj.dense_to_jagged(torch.from_numpy(fd), torch.from_numpy(short)).numpy(),
        np.asarray(jj.dense_to_jagged(jnp.asarray(fd), jnp.asarray(short))))
    with pytest.raises(ValueError, match="capacity"):
        tj.pack_rows(rows, 4)
    # JaggedTensor round trip and fields
    jt = tj.JaggedTensor.from_lists(rows[:3], capacity=40)
    ref = jj.JaggedTensor.from_lists(rows[:3], capacity=40)
    np.testing.assert_array_equal(jt.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(jt.offsets.numpy(), np.asarray(ref.offsets))
    assert jt.batch_size == ref.batch_size == 3
    back = tj.JaggedTensor.from_dense(jt.to_dense(T), jt.lengths)
    np.testing.assert_array_equal(back.to_dense(T).numpy(), jt.to_dense(T).numpy())


@pytest.fixture(scope="module")
def twin_dirs(tmp_path_factory):
    """The same raw data preprocessed twice: offline-padded and ragged."""
    padded = tmp_path_factory.mktemp("gr_padded")
    ragged = tmp_path_factory.mktemp("gr_ragged")
    stats = {}
    for d, pad in ((padded, True), (ragged, False)):
        write_synthetic_goodreads(d, n_users=100, n_books=150,
                                  interactions_per_user=(15, 50), seed=9)
        stats[pad] = run_seq_preprocessing(d, max_len=T, sliding_step=6,
                                           seed=9, pad=pad)
    assert stats[True]["n_items"] == stats[False]["n_items"]
    return padded, ragged, stats[True]["n_items"]


def test_loader_object_columns_only_when_asked(twin_dirs):
    from tdfo_tpu_torch.data.loader import ParquetStream, resolve_files

    _, ragged, _ = twin_dirs
    files = resolve_files(ragged, "parquet_bert4rec/train_part_*.parquet")
    with pytest.raises(ValueError, match="jagged"):
        next(iter(ParquetStream(files, batch_size=16, shuffle=False)))
    batch = next(iter(ParquetStream(files, batch_size=16, shuffle=False,
                                    allow_ragged=True)))
    col = batch["train_interactions"]
    assert col.dtype == object and len({len(r) for r in col}) > 1
    assert max(len(r) for r in col) <= T


def _seq_cfg(data_dir, n_items, **kw):
    common = dict(
        model="bert4rec", model_parallel=True, n_epochs=1, learning_rate=3e-3,
        embed_dim=16, n_heads=2, n_layers=1, max_len=T, sliding_step=6,
        per_device_train_batch_size=8, per_device_eval_batch_size=8,
        shuffle_buffer_size=1000, log_every_n_steps=1000, attn="flash",
        fused_table_threshold=8, size_map={"n_items": n_items})
    common.update(kw)
    return read_configs(None, data_dir=data_dir, **common)


def test_jagged_trainer_matches_padded_trainer(twin_dirs):
    padded, ragged, n_items = twin_dirs
    tr_p = Trainer(_seq_cfg(padded, n_items), device="cpu")
    tr_j = Trainer(_seq_cfg(ragged, n_items, jagged=True), device="cpu")
    loss_p, loss_j = tr_p.train_epoch(0), tr_j.train_epoch(0)
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(loss_j, loss_p, rtol=rtol, atol=atol)
    assert tr_j.state.step == tr_p.state.step > 0
    item = "item_embedding"
    torch.testing.assert_close(tr_j.state.tables[item], tr_p.state.tables[item],
                               rtol=rtol, atol=atol)
    for v in tr_j.evaluate(0).values():  # eval windows stay padded
        assert 0.0 <= v <= 1.0


def test_model_parallel_false_equals_true(twin_dirs):
    """``model_parallel = false`` places the item table ``"replicated"``
    (the reference's dense Bert4Rec collection); on one device that is
    the same storage and step: 3 steps with dropout agree bitwise."""
    padded, _, n_items = twin_dirs
    runs = []
    for mp in (True, False):
        tr = Trainer(_seq_cfg(padded, n_items, model_parallel=mp, dropout=0.1),
                     device="cpu")
        batches = tr._train_batches(0)
        losses = [float(tr._one_step(tr.state, next(batches)[0])[1])
                  for _ in range(3)]
        runs.append((losses, tr.state.state_dict()))
    (la, sa), (lb, sb) = runs
    assert la == lb
    fa, fb = _leaves(sa), _leaves(sb)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert torch.equal(torch.as_tensor(fa[k]), torch.as_tensor(fb[k])), k


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _leaves(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return _leaves(dict(enumerate(tree)), prefix)
    return {prefix: tree}
