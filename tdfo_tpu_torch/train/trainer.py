"""Epoch loop, DMP (model-parallel) paths — port of
``tdfo_tpu/train/trainer.py`` (``_ctr_columns``, ``_ctr_eval_schema``,
``_build_ctr_sparse``, ``_build_bert4rec``, ``pad_batch``, ``train_epoch``,
``evaluate``, ``evaluate_test``, ``fit``, train AUC).

TwoTower and DLRM with ``model_parallel = true``: the tables (TwoTower's 7,
or one per ``categorical_features`` column of a custom schema such as
Criteo's 26) live in a ShardedEmbeddingCollection with the row-sparse
in-backward optimizer (``stack_tables`` stacks the plain ones,
``dedup_lookup`` shares one sort between the lookup and the update), the
dense backbone under AdamW.  Bert4Rec with ``model_parallel = true``: the item table
(fat lines above ``fused_table_threshold`` rows) under the row-sparse
optimizer, the transformer under AdamW, attention ``"full"`` or ``"flash"``
(the hand-written kernels); masked-LM loss with dropout drawn from a
``torch.Generator`` seeded ``seed + 1``, eval Recall/NDCG@{10,20,50} on the
last position against 1 positive + 100 negatives, a pre-training eval and a
held-out test eval after ``fit``.

Streaming parquet epochs feed the card through a pinned-memory double
buffer; losses stay on the device and are fetched in windows of
``log_every_n_steps`` (the reference's sync cadence); the non-finite guard
keeps a device snapshot and rolls back after ``nonfinite_tolerance``
consecutive non-finite losses, skipping the window.  Eval pads the last
batch with zero-weight rows and folds its metrics on the device.

Knobs whose code paths are not ported yet raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them (see
:func:`refuse_unported`); nothing is silently ignored.  Checkpointing waits
for a later slice: a config with ``checkpoint_dir`` is refused.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from tdfo_tpu_torch.core.config import Config
from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.data.loader import (
    MapStream,
    ParquetStream,
    prefetch_to_device,
    resolve_files,
)
from tdfo_tpu_torch.train.metrics import AUC, recalls_and_ndcgs_for_ks
from tdfo_tpu_torch.utils import retry as _retry
from tdfo_tpu_torch.utils.summary import MetricLogger, param_summary

__all__ = ["Trainer", "pad_batch", "refuse_unported"]


def _ctr_columns(cfg: Config) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(categorical input columns, continuous columns) for the CTR family:
    the custom schema (``categorical_features``, e.g. Criteo's 26 + 13) or
    the Goodreads TwoTower default."""
    if cfg.categorical_features:
        return tuple(cfg.categorical_features), tuple(cfg.continuous_features)
    from tdfo_tpu_torch.models.twotower import (
        FEATURE_TO_INPUT,
        TWOTOWER_CATEGORICAL,
        TWOTOWER_CONTINUOUS,
    )

    return (tuple(FEATURE_TO_INPUT[f] for f in TWOTOWER_CATEGORICAL),
            TWOTOWER_CONTINUOUS)


def _ctr_eval_schema(cat_columns: tuple[str, ...],
                     cont_columns: tuple[str, ...]) -> dict[str, type]:
    """Eval-batch schema of the CTR family: column -> numpy dtype, as the
    CTR ETLs write them.  (The reference also keeps each column's trailing
    shape, for the zero-weight template batches of hosts without eval rows:
    multi-host, ``ROADMAP.md`` Queue A item 12.)"""
    schema: dict[str, type] = {c: np.int32 for c in cat_columns}
    schema.update({c: np.float32 for c in cont_columns})
    schema["label"] = np.int8
    return schema


def pad_batch(batch: dict[str, np.ndarray], size: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Pad a short final eval batch to ``size`` rows; returns (batch, weights)
    with 0-weight padding rows."""
    n = len(next(iter(batch.values())))
    w = np.zeros((size,), np.float32)
    w[:n] = 1.0
    if n == size:
        return batch, w
    out = {}
    for k, v in batch.items():
        pad_width = [(0, size - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad_width)
    return out, w


def refuse_unported(cfg: Config) -> None:
    """Raise ``NotImplementedError`` for every knob value whose code path the
    port does not have yet, naming the ``ROADMAP.md`` item that ports it."""
    emb = cfg.embeddings
    tele = cfg.telemetry
    checks = [
        (cfg.jagged, "jagged = true (ragged sequence windows)", 11),
        (cfg.attn in ("ring", "ring_flash"), f"attn = {cfg.attn!r}", 12),
        (cfg.tensor_parallel, "tensor_parallel = true", 12),
        (not cfg.model_parallel,
         "the dense TwoTower regime (model_parallel = false)", 17),
        (cfg.checkpoint_dir is not None, "checkpoint_dir (checkpoint/resume)", 17),
        (cfg.steps_per_execution != 1, "steps_per_execution > 1", 17),
        (cfg.profile, "profile = true", 17),
        (cfg.use_tpu, "use_tpu = true", 17),
        (cfg.embedding_sharding not in ("row", "replicated"),
         f"embedding_sharding = {cfg.embedding_sharding!r}", 12),
        (cfg.lookup_mode != "gspmd", f"lookup_mode = {cfg.lookup_mode!r}", 12),
        (cfg.mesh.model != 1 or cfg.mesh.seq != 1 or cfg.mesh.data not in (-1, 1),
         "a multi-device [mesh]", 12),
        (emb.grouped_a2a, "embeddings.grouped_a2a", 12),
        (cfg.train.pipeline_overlap, "train.pipeline_overlap", 12),
        (cfg.mixed_precision, "mixed_precision = true (bf16 compute)", 13),
        (emb.table_dtype != "float32" or emb.slot_dtype != "float32"
         or bool(emb.table_dtype_overrides), "non-f32 table/slot storage", 13),
        (emb.hot_vocab > 0, "hot/cold tables (hot_vocab > 0)", 13),
        (emb.cache_rows > 0, "the update cache (cache_rows > 0)", 13),
        (bool(cfg.planner.plan), "planner.plan", 14),
        (cfg.write_format != "parquet", f"write_format = {cfg.write_format!r}", 16),
        (cfg.faults.any(), "[faults] injection", 16),
        (cfg.tensorboard, "tensorboard = true", 16),
        (tele.counters or tele.events or tele.trace or tele.stall_timeout_s > 0
         or tele.log_rotate_bytes > 0, "[telemetry] knobs", 16),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to tdfo_tpu_torch yet (ROADMAP.md "
                f"Queue A item {item})")


class Trainer:
    """Config-driven trainer for the TwoTower, DLRM and Bert4Rec DMP regimes on
    one device (``device`` defaults to the card; pass ``"cpu"``
    explicitly)."""

    _METRIC_KS = (10, 20, 50)

    def __init__(self, config: Config, *, log_dir: str | Path | None = None,
                 device="cuda"):
        refuse_unported(config)
        self.config = config
        self.device = resolve_device(device)
        self.logger = MetricLogger(log_dir)
        self._logged_steps = 0  # run-global data-step counter
        self._map_streams: dict = {}
        self._seq = config.model == "bert4rec"
        if log_dir is not None:
            _retry.set_failure_log(Path(log_dir) / "retries.jsonl")
        if self._seq:
            self._build_bert4rec()
        else:
            self._build_ctr_sparse()
        print(param_summary(self.state.backbone, tables=self.state.tables,
                            coll=self.coll,
                            title=f"{config.model} parameters"), flush=True)

    # ------------------------------------------------------------- building

    def _build_ctr_sparse(self) -> None:
        from tdfo_tpu_torch.models.twotower import (
            TWOTOWER_CATEGORICAL,
            TwoTowerBackbone,
            ctr_embedding_specs,
        )
        from tdfo_tpu_torch.ops.sparse import sparse_optimizer
        from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection
        from tdfo_tpu_torch.train.ctr import (
            ctr_sparse_forward,
            make_ctr_sparse_eval_step,
        )
        from tdfo_tpu_torch.train.sparse_step import (
            SparseTrainState,
            make_sparse_train_step,
        )

        cfg = self.config
        cat_cols, cont_cols = _ctr_columns(cfg)
        custom = bool(cfg.categorical_features)
        vocab_keys = cat_cols if custom else TWOTOWER_CATEGORICAL
        missing = [f for f in vocab_keys if f not in cfg.size_map]
        if missing:
            raise ValueError(
                f"{cfg.model} needs vocab sizes {missing} in size_map (run preprocessing)")
        self._train_pattern = str(Path("parquet") / cfg.train_data)
        self._eval_pattern = str(Path("parquet") / cfg.eval_data)
        if custom:
            from tdfo_tpu_torch.models.dlrm import generic_embedding_specs

            specs = generic_embedding_specs(
                cfg.size_map, cat_cols, cfg.embed_dim, cfg.embedding_sharding,
                fused_threshold=cfg.effective_fused_threshold)
        else:
            specs = ctr_embedding_specs(
                cfg.size_map, cfg.embed_dim, cfg.embedding_sharding,
                fused_threshold=cfg.effective_fused_threshold)
        coll = ShardedEmbeddingCollection(specs, fused_kind=cfg.sparse_optimizer,
                                          stack_tables=cfg.stack_tables)
        tables = coll.init(cfg.seed, device=self.device)
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        if cfg.model == "dlrm":
            from tdfo_tpu_torch.models.dlrm import DLRMBackbone

            backbone = DLRMBackbone(cfg.embed_dim, cat_columns=cat_cols,
                                    cont_columns=cont_cols, generator=gen)
        else:
            backbone = TwoTowerBackbone(cfg.embed_dim, generator=gen)
        backbone = backbone.to(self.device)
        self.coll = coll
        self.state = SparseTrainState.create(
            backbone=backbone, tables=tables,
            sparse_opt=sparse_optimizer(cfg.sparse_optimizer,
                                        lr=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay),
            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay)
        self.train_step = make_sparse_train_step(
            coll, ctr_sparse_forward(backbone, with_logits=True),
            mode=cfg.lookup_mode, with_aux=True, dedup_lookup=cfg.dedup_lookup)
        self.eval_step = make_ctr_sparse_eval_step(coll, backbone,
                                                   mode=cfg.lookup_mode)
        self._eval_schema = _ctr_eval_schema(cat_cols, cont_cols)
        self._eval_rename = None

    def _build_bert4rec(self) -> None:
        from tdfo_tpu_torch.models.bert4rec import (
            Bert4RecConfig,
            make_sharded_bert4rec,
        )
        from tdfo_tpu_torch.ops.sparse import sparse_optimizer
        from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward
        from tdfo_tpu_torch.train.sparse_step import (
            SparseTrainState,
            make_sparse_train_step,
        )

        cfg = self.config
        n_items = int(cfg.size_map.get("n_items", cfg.size_map.get("item", 0)))
        if not n_items:
            raise ValueError("bert4rec needs n_items in size_map (run preprocessing)")
        self.model_cfg = Bert4RecConfig(
            n_items=n_items, max_len=cfg.max_len, embed_dim=cfg.embed_dim,
            n_heads=cfg.n_heads, n_layers=cfg.n_layers, dropout=cfg.dropout)
        self.coll, tables, self.backbone = make_sharded_bert4rec(
            self.model_cfg, seed=cfg.seed, sharding=cfg.embedding_sharding,
            attn=cfg.attn, fused_threshold=cfg.effective_fused_threshold,
            fused_kind=cfg.sparse_optimizer, device=self.device)
        self.state = SparseTrainState.create(
            backbone=self.backbone, tables=tables,
            sparse_opt=sparse_optimizer(cfg.sparse_optimizer,
                                        lr=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay),
            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay)
        self.train_step = make_sparse_train_step(
            self.coll, bert4rec_sparse_forward(self.backbone),
            mode=cfg.lookup_mode, dedup_lookup=cfg.dedup_lookup)
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1)
        self._train_pattern = str(Path("parquet_bert4rec") / cfg.train_data)
        self._eval_pattern = str(Path("parquet_bert4rec") / cfg.eval_data)
        self._eval_schema = {"seqs": np.int32, "cands": np.int32}
        self._eval_rename = lambda raw: {"seqs": raw["eval_seqs"],
                                         "cands": raw["candidate_items"]}

    # ------------------------------------------------------------- streams

    def _stream(self, pattern: str, *, train: bool):
        cfg = self.config
        files = resolve_files(cfg.data_dir, pattern)
        bsz = (cfg.per_device_train_batch_size if train
               else cfg.per_device_eval_batch_size)
        if not cfg.streaming:
            key = (pattern, bsz, train)
            if key not in self._map_streams:
                self._map_streams[key] = MapStream(
                    files, batch_size=bsz, shuffle=train, seed=cfg.seed,
                    drop_last=train)
            return self._map_streams[key]
        return ParquetStream(
            files, batch_size=bsz, shuffle=train,
            buffer_size=cfg.shuffle_buffer_size, seed=cfg.seed,
            drop_last=train, num_workers=cfg.num_workers,
            max_bad_shards=cfg.max_bad_shards)

    def _train_batches(self, epoch: int) -> Iterator[dict]:
        stream = self._stream(self._train_pattern, train=True)
        stream.set_epoch(epoch)
        if self._seq:
            stream = ({"item": b["train_interactions"], "label": b["labels"]}
                      for b in stream)
        yield from prefetch_to_device(stream, self.device)

    # ---------------------------------------------------------------- train

    def train_epoch(self, epoch: int) -> float:
        """One training epoch; returns the mean finite train loss."""
        cfg = self.config
        t0 = time.perf_counter()
        n_steps = 0
        loss_sum, contributed = 0.0, 0
        next_log = cfg.log_every_n_steps
        train_auc = AUC.empty(device=self.device)
        tol = cfg.nonfinite_tolerance
        guard = tol > 0
        pending: list[tuple[torch.Tensor, int]] = []  # (device loss, gstep)
        flush_every = max(1, cfg.log_every_n_steps)
        consec_bad = 0
        snap = None  # (state snapshot, auc, loss_sum, contributed, gstep)
        steps_at_snap = 0
        if guard:
            snap = (self.state.snapshot(), train_auc, loss_sum, contributed,
                    self._logged_steps)

        def flush_checks() -> None:
            nonlocal loss_sum, contributed, consec_bad, snap, train_auc
            nonlocal steps_at_snap
            rolled = False
            for loss_dev, gstep in pending:
                v = float(loss_dev)
                if math.isfinite(v):
                    consec_bad = 0
                    loss_sum += v
                    contributed += 1
                    continue
                consec_bad += 1
                if not guard or consec_bad < tol:
                    continue
                st, auc_c, ls, ct, sg = snap
                self.state.restore(st)
                train_auc, loss_sum, contributed = auc_c, ls, ct
                consec_bad = 0
                rolled = True
                self.logger.log(epoch=epoch, rollback=1, global_step=gstep,
                                restored_to_step=sg, skipped_steps=gstep - sg,
                                nonfinite_loss=v)
                break
            pending.clear()
            if (guard and not rolled and consec_bad == 0
                    and n_steps - steps_at_snap >= cfg.snapshot_every_n_steps):
                snap = (self.state.snapshot(), train_auc, loss_sum,
                        contributed, self._logged_steps + n_steps)
                steps_at_snap = n_steps

        for batch in self._train_batches(epoch):
            if self._seq:  # no train AUC: a binary-CTR metric
                self.state, loss = self.train_step(self.state, batch,
                                                   self._dropout_gen)
            else:
                self.state, (loss, logits) = self.train_step(self.state, batch)
                ok = torch.isfinite(logits)
                train_auc = train_auc.update(
                    batch["label"], torch.sigmoid(torch.where(ok, logits, 0.0)),
                    ok.to(torch.float32))
            n_steps += 1
            gstep = self._logged_steps + n_steps
            pending.append((loss, gstep))
            if len(pending) >= flush_every:
                flush_checks()
            if n_steps >= next_log:
                self.logger.log(epoch=epoch, step=n_steps,
                                train_loss=float(loss), global_step=gstep)
                next_log = n_steps + cfg.log_every_n_steps
        flush_checks()
        dt = time.perf_counter() - t0
        self._logged_steps += n_steps
        avg = loss_sum / contributed if contributed else 0.0
        extra = {}
        if n_steps and not self._seq:
            extra["train_auc"] = float(train_auc.result())
        self.logger.log(epoch=epoch, train_loss_epoch=avg, steps=n_steps,
                        examples_per_sec=n_steps * cfg.per_device_train_batch_size
                        / max(dt, 1e-9), **extra)
        return avg

    # ----------------------------------------------------------------- eval

    def _eval_batches(self, pattern: str | None = None) -> Iterator[dict]:
        """Padded eval batches (of ``pattern``, default the eval split)
        restricted to the schema, each with a ``_weight`` row mask (0 on
        padding rows)."""
        stream = self._stream(pattern or self._eval_pattern, train=False)
        bsz = stream.batch_size
        schema = self._eval_schema
        rename = self._eval_rename

        def gen():
            for raw in stream:
                if rename is not None:
                    try:
                        raw = rename(raw)
                    except KeyError as e:
                        raise ValueError(
                            f"eval shard is missing column {e} (has "
                            f"{sorted(raw)}); re-run preprocessing for this "
                            "data_dir") from None
                missing = schema.keys() - raw.keys()
                if missing:
                    raise ValueError(
                        f"eval shard is missing columns {sorted(missing)} "
                        f"(has {sorted(raw)}); re-run preprocessing for this "
                        "data_dir")
                real = {k: np.asarray(raw[k]).astype(dt, copy=False)
                        for k, dt in schema.items()}
                batch, w = pad_batch(real, bsz)
                yield dict(batch, _weight=w)

        yield from prefetch_to_device(gen(), self.device)

    def evaluate(self, epoch: int) -> dict[str, float]:
        """Eval metrics over the eval split: loss and streaming AUC
        (TwoTower), Recall/NDCG@k (Bert4Rec); one host fetch at the end."""
        if self._seq:
            return self._evaluate_bert4rec(epoch)
        loss_sum = torch.zeros((), device=self.device)
        w_sum = torch.zeros((), device=self.device)
        auc = AUC.empty(device=self.device)
        for batch in self._eval_batches():
            _, logits = self.eval_step(self.state, batch)
            w = batch["_weight"]
            labels = batch["label"].to(torch.float32)
            loss_vec = torch.nn.functional.binary_cross_entropy_with_logits(
                logits, labels, reduction="none")
            ok = torch.isfinite(logits)
            loss_sum = loss_sum + (loss_vec * w).sum()
            w_sum = w_sum + w.sum()
            auc = auc.update(labels, torch.sigmoid(torch.where(ok, logits, 0.0)),
                             w * ok.to(torch.float32))
        metrics = {
            "eval_loss": float(loss_sum) / max(float(w_sum), 1.0),
            "auc": float(auc.result()),
        }
        self.logger.log(epoch=epoch, **metrics)
        return metrics

    @torch.no_grad()
    def _evaluate_bert4rec(self, epoch: int, pattern: str | None = None,
                           prefix: str = "") -> dict[str, float]:
        """Last-position scores of 1 positive (column 0) + 100 negatives ->
        weighted Recall/NDCG@{10,20,50}, folded on the device.  Runs the
        inference forward (flash: no lse)."""
        from tdfo_tpu_torch.models.bert4rec import key_padding_mask
        from tdfo_tpu_torch.train.seq import score_candidates

        acc = {"w_sum": torch.zeros((), device=self.device)}
        for k in self._METRIC_KS:
            acc[f"Recall@{k}"] = torch.zeros((), device=self.device)
            acc[f"NDCG@{k}"] = torch.zeros((), device=self.device)
        for batch in self._eval_batches(pattern):
            w = batch["_weight"]
            embs = self.coll.lookup(self.state.tables, {"item": batch["seqs"]},
                                    mode=self.config.lookup_mode)
            logits = self.backbone(embs["item"], key_padding_mask(batch["seqs"]))
            scores = score_candidates(logits, batch["cands"])
            labels = torch.zeros_like(scores)
            labels[:, 0] = 1.0
            m = recalls_and_ndcgs_for_ks(scores, labels, ks=self._METRIC_KS,
                                         row_weights=w)
            acc["w_sum"] += w.sum()
            for k, v in m.items():
                acc[k] += v * w.sum()
        w_sum = max(float(acc.pop("w_sum")), 1.0)
        metrics = {prefix + k: float(v) / w_sum for k, v in acc.items()}
        self.logger.log(epoch=epoch, **metrics)
        return metrics

    def evaluate_test(self) -> dict[str, float]:
        """Final held-out TEST evaluation (Bert4Rec leave-last-one); {} for
        other models, an empty ``test_data`` or a data dir without test
        shards."""
        cfg = self.config
        if not self._seq or not cfg.test_data:
            return {}
        pattern = str(Path("parquet_bert4rec") / cfg.test_data)
        try:
            resolve_files(cfg.data_dir, pattern)
        except FileNotFoundError:
            self.logger.log(test_split="absent (re-run preprocess-seq to write it)")
            return {}
        return self._evaluate_bert4rec(cfg.n_epochs, pattern=pattern,
                                       prefix="test_")

    # ------------------------------------------------------------------ fit

    def fit(self) -> dict[str, float]:
        """Train and evaluate for ``n_epochs`` (Bert4Rec: after a
        pre-training eval at epoch -1, and then the test eval); returns the
        last eval metrics.  Closes the metrics sink either way."""
        metrics: dict[str, float] = {}
        try:
            if self._seq:
                self.evaluate(epoch=-1)  # pre-training sanity floor
            for epoch in range(self.config.n_epochs):
                self.train_epoch(epoch)
                metrics = self.evaluate(epoch)
            metrics.update(self.evaluate_test())
        finally:
            self.logger.close()
        return metrics
