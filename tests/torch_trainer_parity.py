"""Shared set-up of the trainer parity tests
(``test_torch_counters_parity*.py``, ``test_torch_faults_parity*.py``): the
data, the reference's trainer at one CPU device beside the port's carrying
its initial state, and the comparisons.

Counters: the integer counts (touched ids, unique rows and lines, hot ids,
cache hit, miss, flushed and resident rows, non-finite logits) must be
equal; ``grad_norm`` and ``param_norm`` agree at ``TOL["trajectory"]``
(rtol 1e-4, atol 1e-6), as do the eval metrics at the end of a fit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.interop import (
    TOL,
    backbone_params_from_flax,
    dense_params_from_flax,
)
from tdfo_tpu_torch.train.trainer import Trainer

NORMS = ("grad_norm", "param_norm")
STEPS = 3

CONFIGS = {
    "dmp": dict(model_parallel=True),
    "dense": dict(model_parallel=False),
    "dedup_fat": dict(model_parallel=True, dedup_lookup=True,
                      fused_table_threshold=0),
    "dedup_rows": dict(model_parallel=True, dedup_lookup=True,
                       fused_table_threshold=-1),
    "cache": dict(model_parallel=True, sparse_optimizer="rowwise_adagrad",
                  fused_table_threshold=-1,
                  embeddings={"cache_rows": 256, "flush_every": 2}),
    "hot": dict(model_parallel=True, embeddings={"hot_vocab": 8}),
}


def make_data(d, *, n_users: int = 80, n_books: int = 120,
              hot_vocab: int = 0) -> tuple[str, dict]:
    """Synthetic goodreads through the CTR ETL (with the hot/cold remap at
    ``hot_vocab`` > 0)."""
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    write_synthetic_goodreads(d, n_users=n_users, n_books=n_books,
                              interactions_per_user=(15, 40), seed=7)
    return str(d), run_ctr_preprocessing(d, hot_vocab=hot_vocab)


def trainer_kw(data, **kw) -> dict:
    """``read_configs`` keywords (both packages take them)."""
    d, ctr = data
    return dict(data_dir=d, model="twotower", n_epochs=1, learning_rate=3e-3,
                embed_dim=8, per_device_train_batch_size=16,
                per_device_eval_batch_size=16, shuffle_buffer_size=500,
                log_every_n_steps=2, size_map=ctr, **kw)


def one_device(monkeypatch) -> None:
    """The reference's trainers build their mesh over one CPU device (the
    port's batch is then the reference's global batch)."""
    import jax

    from tdfo_tpu.core import mesh as jmesh
    from tdfo_tpu.train import trainer as jtrainer

    monkeypatch.setattr(jtrainer, "make_mesh",
                        lambda spec=None: jmesh.make_mesh(spec, devices=jax.devices()[:1]))


def pair(kw: dict, log_dir=None, port_kw: dict | None = None):
    """The reference's trainer and the port's carrying its initial state
    (the tables by array name and the backbone, or the dense regime's whole
    model); ``log_dir``: each logs under its ``jax`` / ``port`` folder."""
    import jax

    from tdfo_tpu.core.config import read_configs as jread
    from tdfo_tpu.train.trainer import Trainer as JTrainer

    port_kw = port_kw or kw
    jt = JTrainer(jread(None, **kw),
                  log_dir=None if log_dir is None else log_dir / "jax")
    tr = Trainer(read_configs(None, **port_kw),
                 log_dir=None if log_dir is None else log_dir / "port", device="cpu")
    js = jt.state
    with torch.no_grad():
        if port_kw.get("model_parallel"):
            for name, t in tr.state.tables.items():
                t.copy_(torch.from_numpy(np.array(js.tables[name])))
            tr.state.backbone.load_state_dict(
                backbone_params_from_flax(jax.tree.map(np.asarray, js.dense_params)))
        else:
            tr.state.model.load_state_dict(
                dense_params_from_flax(jax.tree.map(np.asarray, js.params)))
    return jt, tr


def reference_step(jt, batch):
    """One reference step on the port's batch; returns its outputs (the
    counters last)."""
    import jax.numpy as jnp

    from tdfo_tpu.train.metrics import AUC

    out = jt.train_step(jt.state, {k: jnp.asarray(v.numpy())
                                   for k, v in batch.items()}, AUC.empty())
    jt.state = out[0]
    return out


def assert_same(want: dict, got: dict, where: str) -> None:
    """Two counter dicts: the same names, counts equal, norms at
    ``TOL["trajectory"]``."""
    want = {k: float(v) for k, v in want.items()}
    got = {k: float(v) for k, v in got.items()}
    assert sorted(got) == sorted(want), where
    rtol, atol = TOL["trajectory"]
    for k, w in want.items():
        if k in NORMS:
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                       equal_nan=True, err_msg=f"{where} {k}")
        else:
            assert got[k] == w, (where, k, got[k], w)


def run_and_compare(jt, tr) -> None:
    """``STEPS`` steps in both on the port's stream (train AUC off), each
    step's counters compared, then one cache write-back's (cache on)."""
    tr._train_auc = None
    stream = (b for b, _ in tr._train_batches(0))
    for i, batch in zip(range(STEPS), stream):
        out = reference_step(jt, batch)
        tr.state, loss = tr._one_step(tr.state, batch)
        np.testing.assert_allclose(float(loss), float(out[1]),
                                   rtol=TOL["trajectory"][0])
        assert_same(out[-1], tr._step_ctrs, f"step {i}")
    assert (jt._cache_flush is None) == (tr._cache_flush is None)
    if jt._cache_flush is not None:
        jt._run_cache_flush()
        tr._run_cache_flush()
        assert_same(jt._flush_ctrs, tr._flush_ctrs, "flush")
        assert any(k.endswith("cache_hit_rows") and float(v) > 0
                   for k, v in tr._step_ctrs.items())


def records(path) -> list[dict]:
    return [json.loads(line) for line in path.read_text().splitlines()]


def same_metrics(got: dict, want: dict) -> None:
    """Eval metrics of two fits at ``TOL["trajectory"]``."""
    assert sorted(got) == sorted(want)
    rtol, atol = TOL["trajectory"]
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=k)
