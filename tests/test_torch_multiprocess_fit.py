"""``Trainer.fit`` on two gloo ranks against the one-rank fit
(``tests/torch_dist_worker.py``; two ranks spawned once for every case).

* ``launch train`` under ``--distributed auto`` on a DMP TwoTower whose
  tables are one fat stack (``fused_table_threshold = 0``), ``[mesh]``
  data 1 x model 2, ``psum``: every rank streams the same global batches as
  the one-rank fit, whose losses, eval metrics and final tables it equals
  bitwise; only rank 0 writes ``metrics.jsonl`` (as many lines as the
  one-rank run) and the checkpoints.  ``alltoall`` splits each batch over
  the ranks: losses at rtol 1e-4, the global AUC within 1e-6, and every
  log line carries the capacity factor's overflow count (0 here).
* A world-2 checkpoint restores at world 1 (the single-device layout).
* Killed before its 6th step and restarted, the two-rank run ends bitwise
  where the uninterrupted one does.
* At data 2 over an eval split of one row, the rank without eval rows
  runs zero-weight template batches and both ranks report the one-rank
  evaluation of the same (fresh) state.
* The dense regime (``model_parallel = false``) at data 1 x model 2 under
  the PS partition (``ps_min_shard_bytes`` splitting ``user`` and
  ``item``): the fit is bitwise the one-rank fit, its checkpoint restores
  at world 1, and a world-1 checkpoint restores at world 2.
* Every knob of ``ROADMAP.md`` Queue A item 12b builds under a
  multi-device mesh (the grouped exchange, the pipelined step, int8
  storage, column sharding under rowwise_adagrad, the update cache,
  hot/cold tables, ``dedup_lookup``, Bert4Rec with the seq axis, ring
  attention and tensor parallelism, the dense regime at model 2); the one
  refusal left is CUDA-graph steps under a backend other than NCCL, which
  names NCCL.
"""

import functools
import json
import math
import shutil
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_dist_worker import Ranks

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.interop import TOL, gather_to_numpy
from tdfo_tpu_torch.train.trainer import Trainer, refuse_unported


def _toml(d: dict) -> str:
    lines, tables = [], []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append(f"[{k}]\n" + "".join(f"{a} = {json.dumps(b)}\n"
                                               for a, b in v.items()))
        else:
            lines.append(f"{k} = {json.dumps(v)}")
    return "\n".join(lines) + "\n" + "\n".join(tables)


@functools.lru_cache(maxsize=None)
def _data():
    import pyarrow.parquet as pq

    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    root = Path(tempfile.mkdtemp(prefix="mp_fit_"))
    write_synthetic_goodreads(root / "ctr")
    size_map = run_ctr_preprocessing(root / "ctr")
    # a copy whose eval split is one row: data 2 leaves one rank without
    write_synthetic_goodreads(root / "one")
    run_ctr_preprocessing(root / "one")
    evals = sorted((root / "one" / "parquet").glob("eval_part_*.parquet"))
    pq.write_table(pq.read_table(evals[0]).slice(0, 1), evals[0])
    for f in evals[1:]:
        f.unlink()
    return root, size_map


def _body(root, size_map, name, **kw):
    body = dict(data_dir=str(root / "ctr"), model="twotower", model_parallel=True,
                n_epochs=1, learning_rate=3e-4, weight_decay=1e-4, embed_dim=16,
                per_device_train_batch_size=256, per_device_eval_batch_size=256,
                shuffle_buffer_size=500, log_every_n_steps=1,
                fused_table_threshold=0, size_map=size_map, seed=11,
                checkpoint_dir=str(root / name), checkpoint_every_n_steps=3)
    body.update(kw)
    return body


@functools.lru_cache(maxsize=None)
def _runs():
    ranks = Ranks(2, Path(tempfile.mkdtemp(prefix="mp_fit_ranks_")))
    root, size_map = _data()
    # a run after a failed one starts its fits over, not from the
    # checkpoints the failed set left
    for name in ("w2_psum", "w1_dense", "w2_dense", "w2_a2a", "w2_kill", "w2_one"):
        shutil.rmtree(root / name, ignore_errors=True)
    mesh = {"data": 1, "model": 2}
    cfg = root / "psum.toml"
    cfg.write_text(_toml(_body(root, size_map, "w2_psum", lookup_mode="psum",
                               mesh=mesh)))
    # the dense regime's PS fit, and a world-1 one that world 2 restores
    ps = dict(model_parallel=False, ps_min_shard_bytes=_ps_bytes(size_map))
    Trainer(read_configs(None, **_body(root, size_map, "w1_dense", **ps)),
            device="cpu").fit()
    cases = {
        "dense_ps": dict(fn="fit", body=_body(root, size_map, "w2_dense",
                                              mesh=mesh, **ps)),
        "dense_restore": dict(fn="restore", body=_body(root, size_map, "w1_dense",
                                                       mesh=mesh, **ps)),
        "psum": dict(fn="fit", cli=True, argv=["train", "--config", str(cfg),
                                               "--device", "cpu"]),
        "alltoall": dict(fn="fit", body=_body(root, size_map, "w2_a2a",
                                              lookup_mode="alltoall", mesh=mesh,
                                              a2a_capacity_factor=2.0)),
        "kill": dict(fn="fit", kill_at=6, body=_body(root, size_map, "w2_kill",
                                                     lookup_mode="psum", mesh=mesh)),
        "eval_template": dict(fn="fit", evaluate=True, body=_body(
            root, size_map, "w2_one", data_dir=str(root / "one"),
            mesh={"data": 2, "model": 1})),
    }
    return root, size_map, ranks.send(cases).wait()


def _ps_bytes(size_map):
    """A threshold that splits ``user`` and ``item`` (d = 16, f32) in two
    and no tower weight."""
    return min(size_map["user"], size_map["item"]) * 16 * 4 // 2


def _one_rank(name, **kw):
    root, size_map, _ = _runs()
    tr = Trainer(read_configs(None, **_body(root, size_map, name, **kw)),
                 device="cpu")
    metrics = tr.fit()
    return tr, metrics


def _losses(path):
    recs = [json.loads(x) for x in Path(path).read_text().splitlines()]
    return [r["train_loss"] for r in recs if "train_loss" in r], recs


def test_two_rank_fit_equals_one_rank_fit():
    root, _, res = _runs()
    tr, metrics = _one_rank("w1_psum", lookup_mode="psum")
    ref_losses, ref_recs = _losses(root / "w1_psum" / "metrics.jsonl")
    got_losses, got_recs = _losses(root / "w2_psum" / "metrics.jsonl")
    assert len(ref_losses) > 6 and got_losses == ref_losses
    # rank 0 alone wrote the log: the one-rank run's lines, no more
    assert len(got_recs) == len(ref_recs)
    for r in res:
        assert r["psum"]["metrics"] == metrics
        want = gather_to_numpy(tr.coll, tr.state.tables)[0]
        for k, v in want.items():
            np.testing.assert_array_equal(r["psum"]["tables"][k], v, err_msg=k)


def test_alltoall_fit_matches_at_the_trajectory_rung():
    root, _, res = _runs()
    _, metrics = _one_rank("w1_a2a", lookup_mode="alltoall")
    ref, _ = _losses(root / "w1_a2a" / "metrics.jsonl")
    got, recs = _losses(root / "w2_a2a" / "metrics.jsonl")
    # a capacity of 2x the balanced share drops nothing, and the log says so
    assert [r["a2a_overflow"] for r in recs if "a2a_overflow" in r] == [0] * len(got)
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)
    for r in res:
        assert abs(r["alltoall"]["metrics"]["auc"] - metrics["auc"]) <= 1e-6
        np.testing.assert_allclose(r["alltoall"]["metrics"]["eval_loss"],
                                   metrics["eval_loss"], rtol=rtol)


def test_world_two_checkpoint_restores_at_world_one():
    root, size_map, res = _runs()
    tr = Trainer(read_configs(None, **_body(root, size_map, "w2_psum",
                                            lookup_mode="psum")), device="cpu")
    step, _ = tr.restore_latest()
    assert step == res[0]["psum"]["step"]
    for k, v in gather_to_numpy(tr.coll, tr.state.tables)[0].items():
        np.testing.assert_array_equal(v, res[0]["psum"]["tables"][k], err_msg=k)


def test_kill_resume_at_world_two_is_bitwise():
    root, _, res = _runs()
    recs = [json.loads(x) for x in (root / "w2_kill" / "metrics.jsonl")
            .read_text().splitlines()]
    assert any(r.get("resumed_mid_epoch") == 0 and r.get("step") == 3 for r in recs)
    for r in res:
        assert r["kill"]["metrics"] == r["psum"]["metrics"]
        assert r["kill"]["step"] == r["psum"]["step"]
        for k, v in r["psum"]["tables"].items():
            np.testing.assert_array_equal(r["kill"]["tables"][k], v, err_msg=k)


def test_rank_without_eval_rows_takes_template_batches():
    root, size_map, res = _runs()
    tr = Trainer(read_configs(None, **_body(
        root, size_map, "w1_one", data_dir=str(root / "one"))), device="cpu")
    want = tr.evaluate(epoch=99)
    for r in res:
        got = r["eval_template"]["eval"]
        assert math.isclose(got["eval_loss"], want["eval_loss"], rel_tol=1e-6)
        assert math.isnan(got["auc"]) == math.isnan(want["auc"])
    a, b = (r["eval_template"]["eval"] for r in res)
    assert a["eval_loss"] == b["eval_loss"] and math.isnan(a["auc"]) == math.isnan(b["auc"])


def test_dense_ps_fit_equals_one_rank_and_restores_across_worlds():
    root, size_map, res = _runs()
    ps = dict(model_parallel=False, ps_min_shard_bytes=_ps_bytes(size_map))
    tr, metrics = _one_rank("w1_dense_again", **ps)
    want = {k: v.detach().numpy() for k, v in tr.state.model.named_parameters()}
    ref, _ = _losses(root / "w1_dense_again" / "metrics.jsonl")
    got, _ = _losses(root / "w2_dense" / "metrics.jsonl")
    assert len(ref) > 6 and got == ref
    for r in res:
        assert r["dense_ps"]["metrics"] == metrics
        for k, v in want.items():
            np.testing.assert_array_equal(r["dense_ps"]["params"][k], v, err_msg=k)
    # the world-2 checkpoint at world 1, the world-1 one at world 2
    one = Trainer(read_configs(None, **_body(root, size_map, "w2_dense", **ps)),
                  device="cpu")
    step, state = one.restore_latest()
    assert step == res[0]["dense_ps"]["step"]
    for k, v in state.model.named_parameters():
        np.testing.assert_array_equal(v.detach().numpy(), want[k], err_msg=k)
    for r in res:
        assert r["dense_restore"]["step"] == step
        for k, v in want.items():
            np.testing.assert_array_equal(r["dense_restore"]["params"][k], v,
                                          err_msg=k)


@pytest.mark.parametrize("kw,what", [
    pytest.param({"model_parallel": False, "steps_per_execution": 2},
                 "CUDA-graph steps", id="kw4-CUDA-graph steps"),
    pytest.param({"model_parallel": False, "mesh": {"data": 1, "model": 2}},
                 "dense regime", id="kw6-dense regime"),
])
def test_12b_knobs_refuse_by_name(kw, what):
    """The two item-12b knobs that refused: CUDA-graph steps under several
    ranks on the card still refuse under gloo, naming NCCL (no item), and
    take NCCL; the dense regime at model 2 builds."""
    body = dict(model="twotower", model_parallel=True, size_map={"user": 10})
    body.update(kw)
    cfg = read_configs(None, **body)
    if what == "CUDA-graph steps":
        with pytest.raises(ValueError, match="need NCCL") as e:
            refuse_unported(cfg, world=2, backend="gloo")
        assert "12b" not in str(e.value) and what in str(e.value)
        refuse_unported(cfg, world=2, backend="nccl")
    else:
        refuse_unported(cfg, world=2, backend="gloo")


@pytest.mark.parametrize("kw", [
    {"embeddings": {"grouped_a2a": True}, "lookup_mode": "alltoall",
     "train": {"pipeline_overlap": True}},
    {"embeddings": {"table_dtype": "int8"}, "lookup_mode": "alltoall"},
    {"embedding_sharding": "column", "sparse_optimizer": "rowwise_adagrad"},
    {"embeddings": {"cache_rows": 64}},
    {"embeddings": {"hot_vocab": 8}},
    {"dedup_lookup": True},
    {"mesh": {"seq": 2}},
    {"attn": "ring", "model": "bert4rec"},
    {"attn": "ring_flash", "model": "bert4rec"},
    {"tensor_parallel": True, "model": "bert4rec"},
    {"model": "bert4rec"},
], ids=["grouped_pipelined", "int8", "column_rowwise_adagrad", "cache_rows",
        "hot_vocab", "dedup_lookup", "seq", "ring", "ring_flash",
        "tensor_parallel", "bert4rec"])
def test_ported_12b_knobs_build_under_world_two(kw):
    """The grouped exchange, the pipelined step, int8 storage, column
    sharding under rowwise_adagrad, the update cache, hot/cold tables,
    ``dedup_lookup``, the seq axis, ring and ring_flash attention, tensor
    parallelism and Bert4Rec itself pass the refusals under a world of two
    (``tests/test_torch_grouped_a2a.py``,
    ``tests/test_torch_sharded_dedup_cache.py`` and
    ``tests/test_torch_sharded_bert4rec.py`` train them on two ranks);
    the dense regime's multi-step refuses only where it replays CUDA
    graphs, on the card."""
    body = dict(model="twotower", model_parallel=True, size_map={"user": 10})
    body.update(kw)
    refuse_unported(read_configs(None, **body), world=2)
    refuse_unported(read_configs(None, model="twotower", model_parallel=False,
                                 steps_per_execution=2, size_map={"user": 10}),
                    world=2, device="cpu")


def test_graph_step_refuses_under_several_ranks(monkeypatch):
    """Under several gloo ranks the graph step refuses, naming NCCL; under
    NCCL it builds (the capture itself needs the card)."""
    import torch.distributed as dist

    from tdfo_tpu_torch.train.step import CudaGraphStep

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "gloo")
    with pytest.raises(ValueError, match="need NCCL"):
        CudaGraphStep(lambda s, b: (s, torch.zeros(())))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    assert CudaGraphStep(lambda s, b: (s, torch.zeros(()))).graph is None


@pytest.mark.parametrize("n_files", [1, 2])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_splits_like_the_reference(tmp_path, n_files, drop_last):
    """Each data slice's stream is the reference's ``process_index`` /
    ``process_count`` split (whole files when they divide, strided rows
    otherwise), and the eval budget is its ``max_batches_per_host``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from tdfo_tpu.data.loader import ParquetStream as JStream
    from tdfo_tpu_torch.data.loader import ParquetStream as TStream

    rng = np.random.default_rng(n_files)
    files = []
    for i in range(n_files):
        n = 150 + 37 * i
        f = tmp_path / f"part_{i}.parquet"
        pq.write_table(pa.table({"x": rng.integers(0, 1000, n).astype(np.int32),
                                 "y": rng.random(n).astype(np.float32)}), f)
        files.append(str(f))
    for p in range(2):
        kw = dict(batch_size=32, shuffle=True, buffer_size=64, seed=3,
                  drop_last=drop_last, process_index=p, process_count=2)
        js, ts = JStream(files, **kw), TStream(files, **kw)
        js.set_epoch(1)
        ts.set_epoch(1)
        want, got = list(js), list(ts)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        assert ts.max_batches_per_host() == js.max_batches_per_host()
