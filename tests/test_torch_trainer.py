"""The port's CLI journey on the CPU: ``python -m tdfo_tpu_torch.launch
synth | preprocess-ctr | train --device cpu`` with ``model_parallel = true``
and ``fused_table_threshold = 0`` (every table fat, packed R = 2 lines at
d = 16).  ``metrics.jsonl`` must carry train loss / train AUC and an eval
AUC in range; the fused update ran through the ``fat_line_update``
wrapper.  The Bert4Rec journey (``synth | preprocess-seq | train`` with
``attn = "flash"``) must log Recall/NDCG and ``test_*`` metrics in range
through the flash wrappers, and its unported knobs name their item.  The
DLRM-Criteo journey (``synth-criteo | preprocess-criteo | train`` with
``stack_tables`` and ``dedup_lookup``) runs the routed fat update once per
step."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk
from tdfo_tpu_torch.train.trainer import Trainer, pad_batch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are tiny, and the suite runs
    several test processes at once, whose thread pools would otherwise
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_config(tmp: Path, **extra) -> Path:
    body = {
        "data_dir": str(tmp / "data"), "model": "twotower",
        "model_parallel": True, "embed_dim": 16, "fused_table_threshold": 0,
        "n_epochs": 1, "per_device_train_batch_size": 256,
        "per_device_eval_batch_size": 256, "log_every_n_steps": 4, **extra,
    }
    lines = [f"{k} = {json.dumps(v) if not isinstance(v, bool) else str(v).lower()}"
             for k, v in body.items()]
    path = tmp / "config.toml"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_cli_synth_preprocess_train_cpu(tmp_path, capsys):
    from tdfo_tpu_torch import launch

    cfg = _write_config(tmp_path)
    for cmd in ("synth", "preprocess-ctr"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    # in-process: the entry point ``python -m tdfo_tpu_torch.launch`` runs
    assert launch.main(["train", "--config", str(cfg), "--log-dir",
                        str(tmp_path / "logs"), "--device", "cpu"]) == 0
    assert "__fatstack_16_row" in capsys.readouterr().out  # one fat stack
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in recs if "train_loss" in r]
    epoch = [r for r in recs if "train_loss_epoch" in r]
    evals = [r for r in recs if "auc" in r]
    assert steps and np.isfinite([r["train_loss"] for r in steps]).all()
    assert epoch and 0.0 <= epoch[-1]["train_auc"] <= 1.0 and epoch[-1]["steps"] > 4
    assert evals and 0.0 <= evals[-1]["auc"] <= 1.0
    assert np.isfinite(evals[-1]["eval_loss"])


def test_train_defaults_to_the_card(tmp_path):
    from tdfo_tpu_torch import launch

    cfg = _write_config(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            launch.main(["train", "--config", str(cfg)])


def test_trainer_in_process_counts_launches(tmp_path):
    """In-process epoch on the CPU: the packed-form fused update runs
    through the wrapper once per step, and eval reads the trained tables."""
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    write_synthetic_goodreads(tmp_path / "data")
    run_ctr_preprocessing(tmp_path / "data")
    cfg = read_configs(_write_config(tmp_path))
    tr = Trainer(cfg, device="cpu")
    assert tr.coll.fat_layout_for("__fatstack_16_row").r == 2
    before = tk.fat_line_update.plain_runs
    loss = tr.train_epoch(0)
    assert np.isfinite(loss)
    assert tk.fat_line_update.plain_runs - before == tr._logged_steps > 0
    m = tr.evaluate(0)
    assert 0.0 <= m["auc"] <= 1.0


def test_pad_batch_zero_weights():
    b = {"a": np.arange(3, dtype=np.int32), "b": np.ones((3, 2), np.float32)}
    out, w = pad_batch(b, 5)
    assert out["a"].tolist() == [0, 1, 2, 0, 0] and out["b"].shape == (5, 2)
    assert w.tolist() == [1, 1, 1, 0, 0]


@pytest.mark.parametrize("extra,error,match", [
    pytest.param({"tensorboard": True}, NotImplementedError,
                 "ROADMAP.md Queue A item", id="extra0"),
    # tensor parallelism is ported for bert4rec; a model without a
    # transformer refuses it by name instead of ignoring it
    pytest.param({"tensor_parallel": True}, ValueError,
                 "tensor_parallel = true splits bert4rec", id="extra1"),
])
def test_unported_knobs_refuse(tmp_path, extra, error, match):
    cfg = read_configs(_write_config(tmp_path, **extra))
    with pytest.raises(error, match=match):
        Trainer(cfg, device="cpu")


@pytest.mark.parametrize("extra,prep", [
    ({"model_parallel": False}, "preprocess-ctr"),
    ({"checkpoint_dir": "ckpt"}, "preprocess-ctr"),
    ({"steps_per_execution": 2}, "preprocess-ctr"),
    ({"model": "bert4rec", "jagged": True}, "preprocess-seq"),
])
def test_formerly_refused_knobs_train_one_epoch(tmp_path, extra, prep):
    """The knobs this port used to refuse (the dense TwoTower regime,
    checkpointing, ``steps_per_execution``, jagged Bert4Rec windows) each
    train one CPU epoch through ``launch`` with finite losses and an eval in
    range; ``checkpoint_dir`` leaves an epoch-complete checkpoint."""
    from tdfo_tpu_torch import launch

    if "checkpoint_dir" in extra:
        extra = {"checkpoint_dir": str(tmp_path / extra["checkpoint_dir"])}
    cfg = _write_config(tmp_path, **extra)
    for cmd in ("synth", prep):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    tr = launch.run(["train", "--config", str(cfg), "--log-dir",
                     str(tmp_path / "logs"), "--device", "cpu"])
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    epoch = [r for r in recs if "train_loss_epoch" in r]
    assert len(epoch) == 1 and epoch[0]["steps"] > 0
    assert np.isfinite(epoch[0]["train_loss_epoch"])
    assert tr.state.step == epoch[0]["steps"]
    key = "Recall@10" if prep == "preprocess-seq" else "auc"
    assert [0.0 <= r[key] <= 1.0 for r in recs if key in r] == [True] * (
        2 if prep == "preprocess-seq" else 1)
    if "checkpoint_dir" in extra:
        from tdfo_tpu_torch.train.checkpoint import CheckpointManager

        mgr = CheckpointManager(extra["checkpoint_dir"])
        cursor = mgr.read_cursor(mgr.latest_step())
        assert cursor["epoch_complete"] and cursor["global_step"] == tr.state.step


def test_dlrm_criteo_cli_dedup_cpu(tmp_path):
    """``synth-criteo -> preprocess-criteo -> train --device cpu``
    in-process with the Criteo schema, ``stack_tables``, ``dedup_lookup``,
    rowwise_adagrad and a ``fused_table_threshold`` that leaves a fat stack
    (tables above 20 rows) and a plain stack: eval AUC in [0, 1], and the
    routed update ran once per training step, ``fat_line_update`` never."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.data.criteo_preprocessing import (
        CRITEO_CATEGORICAL,
        CRITEO_CONTINUOUS,
    )
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    cfg = _write_config(
        tmp_path, model="dlrm", categorical_features=list(CRITEO_CATEGORICAL),
        continuous_features=list(CRITEO_CONTINUOUS), stack_tables=True,
        dedup_lookup=True, sparse_optimizer="rowwise_adagrad",
        fused_table_threshold=20, per_device_train_batch_size=1024,
        per_device_eval_batch_size=1024)
    for cmd in ("synth-criteo", "preprocess-criteo"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    counts = lambda: (tk.fat_line_update.plain_runs,  # noqa: E731
                      tkr.fat_line_update_routed.plain_runs)
    before = counts()
    assert launch.main(["train", "--config", str(cfg), "--log-dir",
                        str(tmp_path / "logs"), "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    evals = [r for r in recs if "auc" in r]
    assert steps > 0 and evals and 0.0 <= evals[-1]["auc"] <= 1.0
    assert np.isfinite(evals[-1]["eval_loss"])
    fat, routed = (a - b for a, b in zip(counts(), before))
    assert (fat, routed) == (0, steps)
    size_map = json.loads((tmp_path / "data" / "size_map.json").read_text())
    assert min(size_map.values()) <= 20 < max(size_map.values())


def test_bert4rec_flash_fit_cpu(tmp_path):
    """``synth -> preprocess-seq -> train --device cpu`` in-process with
    ``model = "bert4rec"``, ``attn = "flash"`` and a fat item table:
    Recall/NDCG@{10,20,50} for the pre-training eval, every epoch and the
    held-out test split, all in [0, 1]; every step ran the flash forward,
    dQ and dK/dV once per layer and the fused update once."""
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa

    cfg = _write_config(tmp_path, model="bert4rec", attn="flash", n_layers=2,
                        per_device_train_batch_size=32,
                        per_device_eval_batch_size=32)
    for cmd in ("synth", "preprocess-seq"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    counts = lambda: (tk.fat_line_update.plain_runs, fa.flash_fwd.plain_runs,  # noqa: E731
                      fa.flash_bwd_dq.plain_runs, fa.flash_bwd_dkv.plain_runs)
    before = counts()
    assert launch.main(["train", "--config", str(cfg), "--log-dir",
                        str(tmp_path / "logs"), "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    steps = sum(r["steps"] for r in recs if "train_loss_epoch" in r)
    evals = [r for r in recs if "Recall@10" in r]
    tests = [r for r in recs if "test_Recall@10" in r]
    assert steps > 0 and [r["epoch"] for r in evals] == [-1, 0] and len(tests) == 1
    for r in (*evals, *tests):
        vals = [v for k, v in r.items() if "Recall@" in k or "NDCG@" in k]
        assert len(vals) == 6 and all(0.0 <= v <= 1.0 for v in vals), r
    fused, fwd, dq, dkv = (a - b for a, b in zip(counts(), before))
    assert fused == steps and dq == dkv == 2 * steps
    assert fwd > 2 * steps  # training steps plus the eval forwards


@pytest.mark.parametrize("extra,twin", [
    pytest.param({"attn": "ring_flash"}, {"attn": "flash"}, id="extra0-12"),
    pytest.param({"attn": "ring"}, {"attn": "full"}, id="extra1-12"),
    pytest.param({"tensor_parallel": True}, {}, id="extra2-12"),
])
def test_bert4rec_unported_knobs_name_their_item(tmp_path, extra, twin):
    """The knobs of ``ROADMAP.md`` item 12b that once refused here train
    at world 1: a ring of one, and tensor parallelism over one rank.  One
    step of each equals its one-device twin from the same seed: bitwise
    for ``ring_flash`` (``flash``: one merge, weights 0 and exp(0)) and
    ``tensor_parallel`` (nothing to split), at the logits rung for
    ``ring`` (``full``: the online softmax sums in another order)."""
    from tdfo_tpu_torch.interop import TOL

    rng = np.random.default_rng(2)
    item = torch.from_numpy(rng.integers(1, 41, (8, 12)).astype(np.int64))
    item[0, 6:] = 0
    batch = {"item": item, "label": torch.where(item % 3 == 0, item, 0)}
    out = {}
    for name, kw in (("knob", extra), ("twin", twin)):
        (tmp_path / name).mkdir()
        cfg = read_configs(_write_config(tmp_path / name, model="bert4rec",
                                         max_len=12, n_heads=2, **kw),
                           size_map={"n_items": 40})
        tr = Trainer(cfg, device="cpu")
        state, loss = tr._one_step(tr.state, batch)
        out[name] = (float(loss), state.step,
                     [p.detach().clone() for p in tr.backbone.parameters()])
    (lk, sk, pk), (lt, st, pt) = out["knob"], out["twin"]
    assert sk == st == 1 and np.isfinite(lk)
    if extra.get("attn") == "ring":
        rtol, atol = TOL["logits"]
        np.testing.assert_allclose(lk, lt, rtol=rtol, atol=atol)
    else:
        assert lk == lt
        assert all(torch.equal(a, b) for a, b in zip(pk, pt))


def _with_embeddings(path: Path, **emb) -> Path:
    """Append an ``[embeddings]`` table (and its sub-tables) to a written
    config."""
    lines = [f"{k} = {json.dumps(v)}" for k, v in emb.items()
             if not isinstance(v, dict)]
    for k, v in emb.items():
        if isinstance(v, dict):
            lines += [f"[embeddings.{k}]"] + [f"{a} = {json.dumps(b)}"
                                             for a, b in v.items()]
    path.write_text(path.read_text() + "[embeddings]\n" + "\n".join(lines) + "\n")
    return path


@pytest.mark.parametrize("extra,emb", [
    ({}, {"table_dtype": "int8"}),
    ({"fused_table_threshold": -1}, {"table_dtype_overrides": {"user_embed": "int8"}}),
    ({"fused_table_threshold": -1}, {"hot_vocab": 8}),
    ({"fused_table_threshold": -1, "sparse_optimizer": "adagrad"},
     {"cache_rows": 512, "flush_every": 3}),
], ids=["int8_fat", "int8_override", "hot_vocab", "cache_rows"])
def test_item13_knobs_train_one_epoch(tmp_path, extra, emb):
    """int8 storage (every table fat: int8 byte lines; or one plain table by
    override, with its sidecar), hot/cold tables (``preprocess-ctr`` writes
    ``hot_ids.json``) and the update cache each train one CPU epoch through
    ``launch`` with finite losses and an eval AUC in range."""
    from tdfo_tpu_torch import launch

    cfg = _with_embeddings(_write_config(tmp_path, **extra), **emb)
    for cmd in ("synth", "preprocess-ctr"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    tr = launch.run(["train", "--config", str(cfg), "--log-dir",
                     str(tmp_path / "logs"), "--device", "cpu"])
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    epoch = [r for r in recs if "train_loss_epoch" in r]
    assert len(epoch) == 1 and epoch[0]["steps"] > 0
    assert np.isfinite(epoch[0]["train_loss_epoch"])
    assert [0.0 <= r["auc"] <= 1.0 for r in recs if "auc" in r] == [True]
    tables = tr.state.tables
    if "table_dtype" in emb:
        assert tables["__fatstack_16_row_int8"].dtype == torch.int8
    if "table_dtype_overrides" in emb:
        assert tables["user_embed"].dtype == torch.int8
        assert tables["__qscale__/user_embed"].shape == (tables["user_embed"].shape[0], 2)
    if "hot_vocab" in emb:
        assert (Path(tr.config.data_dir) / "hot_ids.json").exists()
        assert {"user_embed__hot", "item_embed__hot"} <= set(tables)
    if "cache_rows" in emb:
        assert any(k.startswith("__cache__/") for k in tr.state.slots)
        assert tr._flush_every == 3


def test_bert4rec_mixed_precision_trains_f32_as_the_reference(tmp_path):
    """``model = "bert4rec"`` with ``mixed_precision = true``: the reference
    accepts the toml and its ``_build_bert4rec`` never reads the flag, so
    Bert4Rec trains in f32; the port's trainer builds the arrays the
    reference's build (traced as ``_build_bert4rec`` calls it) makes, all
    f32, and from the same initial arrays two steps of the two packages
    agree at the trajectory rung."""
    import optax

    from tdfo_tpu.core.config import read_configs as j_read_configs
    from tdfo_tpu.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec
    from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
    from tdfo_tpu.train.seq import bert4rec_sparse_forward
    from tdfo_tpu.train.sparse_step import SparseTrainState as JState
    from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
    from tdfo_tpu_torch import launch
    from tdfo_tpu_torch.interop import TOL

    cfg_path = _write_config(tmp_path, model="bert4rec", mixed_precision=True,
                             attn="full", n_layers=1, n_heads=2, dropout=0.0,
                             fused_table_threshold=20,
                             per_device_train_batch_size=32)
    for cmd in ("synth", "preprocess-seq"):
        assert launch.main([cmd, "--config", str(cfg_path)]) == 0
    size_map = json.loads((tmp_path / "data" / "size_map_bert4rec.json").read_text())
    jcfg = j_read_configs(str(cfg_path), size_map=size_map)
    assert jcfg.mixed_precision and jcfg.model == "bert4rec"
    ttr = Trainer(read_configs(str(cfg_path), size_map=size_map),
                  log_dir=tmp_path / "tl", device="cpu")
    built = {}

    def build(key):
        built["coll"], tables, built["backbone"], dense = make_sharded_bert4rec(
            key, Bert4RecConfig(n_items=size_map["n_items"], max_len=jcfg.max_len,
                                embed_dim=jcfg.embed_dim, n_heads=jcfg.n_heads,
                                n_layers=jcfg.n_layers, dropout=jcfg.dropout),
            None, sharding="row", attn=jcfg.attn,
            fused_threshold=jcfg.effective_fused_threshold,
            fused_kind=jcfg.sparse_optimizer)
        return tables, dense

    # the reference's build, traced (its arrays' shapes and dtypes); the
    # values both packages then start from are the port trainer's
    want_tables, want_dense = jax.eval_shape(build, jax.random.key(jcfg.seed))
    coll, backbone = built["coll"], built["backbone"]
    jtables = {k: jnp.asarray(v.numpy()) for k, v in ttr.state.tables.items()}
    dense = {}
    for name, v in ttr.state.backbone.state_dict().items():
        *path, leaf = name.split(".")
        node = dense
        for part in path:
            node = node.setdefault(part, {})
        v = v.numpy()
        if leaf == "weight":  # Linear [out, in] -> kernel [in, out]; LayerNorm -> scale
            leaf, v = ("kernel", v.T) if v.ndim == 2 else ("scale", v)
        node[leaf] = jnp.asarray(v)
    assert jax.tree.structure(dense) == jax.tree.structure(want_dense)
    assert [(x.shape, x.dtype) for x in jax.tree.leaves(dense)] == [
        (x.shape, x.dtype) for x in jax.tree.leaves(want_dense)]
    assert {k: (v.shape, v.dtype) for k, v in jtables.items()} == {
        k: (v.shape, v.dtype) for k, v in want_tables.items()}
    jstate = JState.create(
        dense_params=dense, tx=optax.adamw(jcfg.learning_rate,
                                           weight_decay=jcfg.weight_decay),
        tables=jtables, sparse_opt=j_opt(jcfg.sparse_optimizer,
                                         lr=jcfg.learning_rate,
                                         weight_decay=jcfg.weight_decay))
    assert {x.dtype for x in jax.tree.leaves((want_tables, want_dense))} == {
        np.dtype(np.float32)}
    assert {t.dtype for t in ttr.state.tables.values()} == {torch.float32}
    assert {p.dtype for p in ttr.state.backbone.parameters()} == {torch.float32}
    jrun = j_step(coll, bert4rec_sparse_forward(backbone), donate=False)
    jl, tl = [], []
    for (batch, _), _ in zip(ttr._train_batches(0), range(2)):
        jstate, loss = jrun(jstate, {k: v.numpy() for k, v in batch.items()})
        jl.append(float(loss))
        ttr.state, loss = ttr._one_step(ttr.state, batch)
        tl.append(float(loss))
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    for k, v in jstate.tables.items():
        np.testing.assert_allclose(ttr.state.tables[k].numpy(), np.asarray(v),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_bf16_storage_cli_cpu(tmp_path):
    """``launch train --device cpu`` with ``table_dtype = "bfloat16"``,
    ``slot_dtype = "bfloat16"`` and ``mixed_precision`` (f32 compute on the
    CPU, the reference's mapping): the packed-form (d = 16, R = 2) bf16 fat
    stack of the tables above 20 rows runs the plain bf16
    ``fat_line_update`` once per step, the small tables the dense tier,
    and after training every table and every mu/nu is still bf16."""
    from tdfo_tpu_torch import launch

    cfg = _with_embeddings(_write_config(tmp_path, mixed_precision=True,
                                         fused_table_threshold=20),
                           table_dtype="bfloat16", slot_dtype="bfloat16")
    for cmd in ("synth", "preprocess-ctr"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    before = tk.fat_line_update.plain_runs
    tr = launch.run(["train", "--config", str(cfg), "--log-dir",
                     str(tmp_path / "logs"), "--device", "cpu"])
    assert tr.state.backbone.dtype == torch.float32
    assert tr.coll.fat_layout_for("__fatstack_16_row_bfloat16").r == 2
    assert tk.fat_line_update.plain_runs - before == tr._logged_steps > 0
    for name, t in tr.state.tables.items():
        assert t.dtype == torch.bfloat16, name
        assert all(s.dtype in (torch.bfloat16, torch.int32)
                   for s in tr.state.slots[name]), name
    assert any(len(s) == 3 for s in tr.state.slots.values())  # plain adam mu/nu
    recs = [json.loads(x) for x in
            (tmp_path / "logs" / "metrics.jsonl").read_text().splitlines()]
    evals = [r for r in recs if "auc" in r]
    assert evals and 0.0 <= evals[-1]["auc"] <= 1.0
    assert all(np.isfinite(r["train_loss"]) for r in recs if "train_loss" in r)
