"""Epoch loop — port of ``tdfo_tpu/train/trainer.py`` (``_ctr_columns``,
``_ctr_eval_schema``, ``_build_twotower_dense``, ``_build_ctr_sparse``,
``_build_bert4rec``, ``pad_batch``, ``train_epoch``, ``evaluate``,
``evaluate_test``, ``fit``, train AUC, checkpoint/resume, profiling).

Regimes:

* TwoTower with ``model_parallel = false`` (the quickstart ``config.toml``):
  the dense regime, every parameter (the 7 ``[V, d]`` tables included) in
  one ``TwoTower`` under AdamW (``train/state.py::TrainState``,
  ``train/step.py``); f16 loss scaling under ``mixed_precision`` on the
  card.  ``ps_min_shard_bytes`` is the identity placement on one device.
* TwoTower with ``model_parallel = true`` and DLRM: the tables (TwoTower's
  7, or one per ``categorical_features`` column such as Criteo's 26) in a
  ShardedEmbeddingCollection with the row-sparse in-backward optimizer
  (``stack_tables``, ``dedup_lookup``; ``model_parallel = false`` places
  them ``"replicated"``, which on one device is the same storage), the
  dense backbone under AdamW.  ``[embeddings] table_dtype`` (and its
  per-table overrides) and ``slot_dtype`` set storage dtypes (bf16 writes
  stochastically rounded); ``mixed_precision`` computes the backbone in
  ``core.precision.compute_dtype`` (f16 on the card, f32 on the CPU).
* Bert4Rec (``model_parallel`` true, or false: ``"replicated"``): the item
  table (fat lines above ``fused_table_threshold`` rows) under the
  row-sparse optimizer, the transformer under AdamW, attention ``"full"`` or
  ``"flash"`` (the hand-written kernels); masked-LM loss with dropout drawn
  per step from ``train.seq.dropout_generator(seed + 1, state.step)``; eval
  Recall/NDCG@{10,20,50} against 1 positive + 100 negatives, a pre-training
  eval and a held-out test eval.  ``jagged = true`` streams the ragged
  windows ``preprocess-seq`` writes, packs each batch into ``(values,
  lengths)`` on the host and turns it into ``[B, T]`` ids inside the step
  (``data/jagged.py``).

Streaming parquet epochs feed the card through a pinned-memory double
buffer.  ``steps_per_execution = K`` stacks K host batches into one
transfer and runs them as K steps (the dense step as K replays of one CUDA
graph on the card; the sparse steps hold host syncs, so they run eagerly).
Losses stay on the device and are fetched in windows of
``log_every_n_steps``; the non-finite guard keeps a device snapshot and
rolls back after ``nonfinite_tolerance`` consecutive non-finite losses.

Checkpoints (``checkpoint_dir``, ``train/checkpoint.py``): every
``checkpoint_every_n_steps`` steps mid-epoch (after the pending losses are
verified, so no unverified window is saved) with the stream cursor, and at
epoch ends every ``checkpoint_every_n_epochs`` and at the last epoch.
``fit`` resumes from the newest: the stream fast-forwards to the exact
batch, so a killed and restarted run ends bit for bit where the
uninterrupted one does.  Storage dtypes other than f32 are stamped and a
mismatched restore refuses.  ``profile = true`` traces steps 10-20 of
epoch 0 with ``torch.profiler`` into ``<checkpoint_dir or .>/profile``;
``use_tpu = true`` refuses (this package never runs on a TPU).

Knobs whose code paths are not ported yet raise ``NotImplementedError``
naming the ``ROADMAP.md`` item that ports them (see
:func:`refuse_unported`); nothing is silently ignored.
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
from tdfo_tpu_torch.train.checkpoint import CheckpointManager
from tdfo_tpu_torch.train.metrics import AUC, recalls_and_ndcgs_for_ks
from tdfo_tpu_torch.train.seq import dropout_generator
from tdfo_tpu_torch.train.state import TrainState
from tdfo_tpu_torch.train.step import (
    CudaGraphStep,
    make_eval_step,
    make_multi_step,
    make_train_step,
)
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
        (cfg.attn in ("ring", "ring_flash"), f"attn = {cfg.attn!r}", 12),
        (cfg.tensor_parallel, "tensor_parallel = true", 12),
        (cfg.embedding_sharding not in ("row", "replicated"),
         f"embedding_sharding = {cfg.embedding_sharding!r}", 12),
        (cfg.lookup_mode != "gspmd", f"lookup_mode = {cfg.lookup_mode!r}", 12),
        (cfg.mesh.model != 1 or cfg.mesh.seq != 1 or cfg.mesh.data not in (-1, 1),
         "a multi-device [mesh]", 12),
        (emb.grouped_a2a, "embeddings.grouped_a2a", 12),
        (cfg.train.pipeline_overlap, "train.pipeline_overlap", 12),
        (cfg.mixed_precision and cfg.model == "bert4rec",
         "mixed_precision = true with model = \"bert4rec\"", 13),
        (emb.table_dtype == "int8"
         or any(d == "int8" for _, d in emb.table_dtype_overrides),
         "int8 table storage", 13),
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
    """Config-driven trainer for the TwoTower (dense and DMP), DLRM and
    Bert4Rec regimes on one device (``device`` defaults to the card; pass
    ``"cpu"`` explicitly).  ``log_dir`` defaults to ``checkpoint_dir``."""

    _METRIC_KS = (10, 20, 50)

    def __init__(self, config: Config, *, log_dir: str | Path | None = None,
                 device="cuda"):
        refuse_unported(config)
        if config.use_tpu:
            raise RuntimeError(
                "use_tpu = true but tdfo_tpu_torch trains on a CUDA card or "
                "the CPU, never a TPU (TPUStrategy-resolution parity: refuse "
                "to silently train a TPU config elsewhere)")
        self.config = config
        self.device = resolve_device(device)
        out_dir = log_dir or config.checkpoint_dir
        self.logger = MetricLogger(out_dir)
        self._logged_steps = 0  # run-global data-step counter
        self._map_streams: dict = {}
        self._seq = config.model == "bert4rec"
        self._dense = config.model == "twotower" and not config.model_parallel
        self._ckpt = None
        self._ckpt_stamps = None  # compatibility stamps (storage dtypes)
        self._train_auc = None
        if out_dir is not None:
            _retry.set_failure_log(Path(out_dir) / "retries.jsonl")
        if config.checkpoint_dir:
            self._ckpt = CheckpointManager(config.checkpoint_dir)
        if self._seq:
            self._build_bert4rec()
        elif self._dense:
            self._build_twotower_dense()
        else:
            self._build_ctr_sparse()
        self._multi_step = make_multi_step(self._one_step)
        if self._dense:
            summary = param_summary(self.state.model,
                                    title=f"{config.model} parameters")
        else:
            summary = param_summary(self.state.backbone, tables=self.state.tables,
                                    coll=self.coll,
                                    title=f"{config.model} parameters")
        print(summary, flush=True)

    # ------------------------------------------------------------- building

    def _set_patterns(self, subdir: str) -> None:
        cfg = self.config
        self._train_pattern = str(Path(subdir) / cfg.train_data)
        self._eval_pattern = str(Path(subdir) / cfg.eval_data)

    def _build_twotower_dense(self) -> None:
        """The reference's dense regime: ``TwoTower`` with its own tables,
        AdamW over everything (capturable on the card: the eager step and
        the CUDA-graph replays run the same optimizer code)."""
        from tdfo_tpu_torch.core.precision import DynamicLossScale, compute_dtype
        from tdfo_tpu_torch.models.twotower import TWOTOWER_CATEGORICAL, init_twotower

        cfg = self.config
        missing = [f for f in TWOTOWER_CATEGORICAL if f not in cfg.size_map]
        if missing:
            raise ValueError(
                f"{cfg.model} needs vocab sizes {missing} in size_map (run preprocessing)")
        dtype = compute_dtype(cfg.mixed_precision, self.device)
        model = init_twotower(cfg.seed, cfg.size_map, cfg.embed_dim, dtype=dtype,
                              device=self.device)
        loss_scale = (DynamicLossScale.create(device=self.device)
                      if cfg.mixed_precision and cfg.loss_scale == "dynamic"
                      and dtype == torch.float16 else None)
        on_card = self.device.type == "cuda"
        self.state = TrainState.create(
            model=model, learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay, loss_scale=loss_scale,
            capturable=on_card)
        inner = make_train_step(with_aux=True)
        self.train_step = (CudaGraphStep(inner)
                           if on_card and cfg.steps_per_execution > 1 else inner)
        self.eval_step = make_eval_step()
        self._set_patterns("parquet")
        self._eval_schema = _ctr_eval_schema(*_ctr_columns(cfg))
        self._eval_rename = None

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

        import dataclasses

        from tdfo_tpu_torch.core.precision import compute_dtype
        from tdfo_tpu_torch.ops.quant import storage_dtype

        cfg = self.config
        cat_cols, cont_cols = _ctr_columns(cfg)
        custom = bool(cfg.categorical_features)
        vocab_keys = cat_cols if custom else TWOTOWER_CATEGORICAL
        missing = [f for f in vocab_keys if f not in cfg.size_map]
        if missing:
            raise ValueError(
                f"{cfg.model} needs vocab sizes {missing} in size_map (run preprocessing)")
        self._set_patterns("parquet")
        sharding = cfg.embedding_sharding if cfg.model_parallel else "replicated"
        if custom:
            from tdfo_tpu_torch.models.dlrm import generic_embedding_specs

            specs = generic_embedding_specs(
                cfg.size_map, cat_cols, cfg.embed_dim, sharding,
                fused_threshold=cfg.effective_fused_threshold)
        else:
            specs = ctr_embedding_specs(
                cfg.size_map, cfg.embed_dim, sharding,
                fused_threshold=cfg.effective_fused_threshold)
        # storage dtype is a per-table property of the spec
        specs = [dataclasses.replace(
            s, dtype=storage_dtype(cfg.embeddings.dtype_for(s.name)))
            for s in specs]
        # a bf16-stored table restored into an f32 run (or the reverse)
        # would change every later update: stamp the storage dtypes;
        # defaults-only runs write no stamp (the reference's rule)
        tstamp = {s.name: str(s.dtype).removeprefix("torch.") for s in specs}
        if (any(v != "float32" for v in tstamp.values())
                or cfg.embeddings.slot_dtype != "float32"):
            self._ckpt_stamps = {"table_dtype": tstamp,
                                 "slot_dtype": cfg.embeddings.slot_dtype}
        coll = ShardedEmbeddingCollection(specs, fused_kind=cfg.sparse_optimizer,
                                          stack_tables=cfg.stack_tables)
        tables = coll.init(cfg.seed, device=self.device)
        gen = torch.Generator().manual_seed(cfg.seed + 1)
        dtype = compute_dtype(cfg.mixed_precision, self.device)
        if cfg.model == "dlrm":
            from tdfo_tpu_torch.models.dlrm import DLRMBackbone

            backbone = DLRMBackbone(cfg.embed_dim, cat_columns=cat_cols,
                                    cont_columns=cont_cols, generator=gen,
                                    dtype=dtype)
        else:
            backbone = TwoTowerBackbone(cfg.embed_dim, generator=gen,
                                        dtype=dtype)
        backbone = backbone.to(self.device)
        self.coll = coll
        self.state = SparseTrainState.create(
            backbone=backbone, tables=tables,
            sparse_opt=sparse_optimizer(cfg.sparse_optimizer,
                                        lr=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay,
                                        slot_dtype=cfg.embeddings.slot_dtype),
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
            PAD_ID,
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
        sharding = cfg.embedding_sharding if cfg.model_parallel else "replicated"
        self.coll, tables, self.backbone = make_sharded_bert4rec(
            self.model_cfg, seed=cfg.seed, sharding=sharding,
            attn=cfg.attn, fused_threshold=cfg.effective_fused_threshold,
            fused_kind=cfg.sparse_optimizer, device=self.device)
        self.state = SparseTrainState.create(
            backbone=self.backbone, tables=tables,
            sparse_opt=sparse_optimizer(cfg.sparse_optimizer,
                                        lr=cfg.learning_rate,
                                        weight_decay=cfg.weight_decay),
            learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay)
        transform = None
        if cfg.jagged:
            # (values, lengths) -> [B, T] inside the step, on the device
            from tdfo_tpu_torch.data.jagged import jagged_to_dense_per_host

            t_len = cfg.max_len

            def transform(batch):
                lengths = batch["item_lengths"]
                return {k: jagged_to_dense_per_host(batch[f"{k}_values"], lengths,
                                                    t_len, PAD_ID)
                        for k in ("item", "label")}

        self.train_step = make_sparse_train_step(
            self.coll, bert4rec_sparse_forward(self.backbone),
            mode=cfg.lookup_mode, dedup_lookup=cfg.dedup_lookup,
            batch_transform=transform)
        self._set_patterns("parquet_bert4rec")
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
            max_bad_shards=cfg.max_bad_shards,
            # eval shards are fixed-width; only the jagged TRAIN stream
            # carries ragged windows
            allow_ragged=train and self._seq and cfg.jagged)

    def _train_batches(self, epoch: int, skip: int = 0) -> Iterator[tuple[dict, int]]:
        """Yields ``(device batch, steps in it)``.  With
        ``steps_per_execution = K > 1`` host batches stack into ``[K, B,
        ...]`` chunks (a short tail chunk allowed), one transfer each.
        ``skip`` resumes mid-epoch: the stream fast-forwards that many
        batches first, so the batches that follow are the uninterrupted
        epoch's (a chunk may then start anywhere: chunks only group
        steps)."""
        cfg = self.config
        stream = self._stream(self._train_pattern, train=True)
        stream.set_epoch(epoch)
        if skip:
            stream.load_state_dict({"seed": cfg.seed, "epoch": epoch,
                                    "batches_emitted": skip})
        if self._seq and cfg.jagged:
            from tdfo_tpu_torch.data.jagged import pack_rows

            cap = stream.batch_size * cfg.max_len  # static host capacity

            def pack(b):
                iv, il = pack_rows(list(b["train_interactions"]), cap)
                lv, ll = pack_rows(list(b["labels"]), cap)
                if (il != ll).any():  # data integrity, must survive python -O
                    raise ValueError(
                        "item/label window lengths diverged — mixed-version "
                        "or corrupted jagged shards")
                return {"item_values": iv, "item_lengths": il, "label_values": lv}

            host = (pack(b) for b in stream)
        elif self._seq:
            host = ({"item": b["train_interactions"], "label": b["labels"]}
                    for b in stream)
        else:
            host = iter(stream)
        spe = cfg.steps_per_execution
        if spe <= 1:
            for batch in prefetch_to_device(host, self.device):
                yield batch, 1
            return

        def stacked():
            chunk: list[dict] = []
            for b in host:
                chunk.append(b)
                if len(chunk) == spe:
                    yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}
                    chunk = []
            if chunk:
                yield {k: np.stack([c[k] for c in chunk]) for k in chunk[0]}

        for stack in prefetch_to_device(stacked(), self.device):
            yield stack, int(next(iter(stack.values())).shape[0])

    # ---------------------------------------------------------------- train

    def _one_step(self, state, batch):
        """One train step and the trainer's folds: Bert4Rec's per-step
        dropout generator, the CTR train AUC.  ``(state, loss)``."""
        if self._seq:
            gen = dropout_generator(self.config.seed + 1, state.step, self.device)
            return self.train_step(state, batch, gen)
        state, (loss, logits) = self.train_step(state, batch)
        logits = logits.float()  # a narrow compute dtype's logits
        ok = torch.isfinite(logits)
        self._train_auc = self._train_auc.update(
            batch["label"], torch.sigmoid(torch.where(ok, logits, 0.0)),
            ok.to(torch.float32))
        return state, loss

    def _save(self, gstep: int, cursor: dict) -> None:
        self._ckpt.save(gstep, self.state, force=True, cursor=cursor,
                        stamps=self._ckpt_stamps)

    def train_epoch(self, epoch: int, *, start_step: int = 0,
                    loss_sum: float = 0.0, contributed: int = 0) -> float:
        """One training epoch, resumable at step granularity; returns the
        mean finite train loss.  ``start_step`` (with the partial
        ``loss_sum`` / ``contributed`` of the checkpoint cursor) restarts
        the epoch at an exact batch.  Device losses queue and are fetched
        together at the log cadence and before a checkpoint (one host sync
        per window).  The train AUC is not in the cursor: after a
        mid-epoch resume it covers the steps run since."""
        cfg = self.config
        t0 = time.perf_counter()
        n_steps = start_step
        next_log = start_step + cfg.log_every_n_steps
        self._train_auc = None if self._seq else AUC.empty(device=self.device)
        tol = cfg.nonfinite_tolerance
        guard = tol > 0
        # (device losses [k], k, global data step of the last one)
        pending: list[tuple[torch.Tensor, int, int]] = []
        pending_steps = 0
        flush_every = max(1, cfg.log_every_n_steps)
        consec_bad = 0
        snap = None  # (state snapshot, auc, loss_sum, contributed, gstep)
        steps_at_snap = n_steps
        if guard:
            snap = (self.state.snapshot(), self._train_auc, loss_sum,
                    contributed, self._logged_steps + n_steps)

        def flush_checks() -> None:
            nonlocal loss_sum, contributed, consec_bad, snap
            nonlocal steps_at_snap, pending_steps
            rolled = False
            vals = (torch.cat([x.reshape(-1) for x, _, _ in pending]).tolist()
                    if pending else [])  # one host fetch for the window
            steps = [g - k + 1 + j for _, k, g in pending for j in range(k)]
            for v, gstep in zip(vals, steps):
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
                self._train_auc, loss_sum, contributed = auc_c, ls, ct
                consec_bad = 0
                rolled = True
                self.logger.log(epoch=epoch, rollback=1, global_step=gstep,
                                restored_to_step=sg, skipped_steps=gstep - sg,
                                nonfinite_loss=v)
                break  # later losses came from the poisoned lineage
            pending.clear()
            pending_steps = 0
            if (guard and not rolled and consec_bad == 0
                    and n_steps - steps_at_snap >= cfg.snapshot_every_n_steps):
                snap = (self.state.snapshot(), self._train_auc, loss_sum,
                        contributed, self._logged_steps + n_steps)
                steps_at_snap = n_steps

        ckpt_n = cfg.checkpoint_every_n_steps if self._ckpt is not None else 0
        next_ckpt = (n_steps // ckpt_n + 1) * ckpt_n if ckpt_n else None
        profiling = cfg.profile and epoch == 0
        prof = None
        try:
            for batch, k in self._train_batches(epoch, skip=start_step):
                if profiling and prof is None and n_steps >= 10:
                    prof = self._start_profile()
                if cfg.steps_per_execution > 1:
                    self.state, losses = self._multi_step(self.state, batch)
                else:
                    self.state, loss = self._one_step(self.state, batch)
                    losses = loss.reshape(1)
                n_steps += k
                gstep = self._logged_steps + n_steps
                pending.append((losses, k, gstep))
                pending_steps += k
                if pending_steps >= flush_every:
                    flush_checks()
                if prof is not None and n_steps >= 20:
                    self._stop_profile(prof, epoch)
                    prof, profiling = None, False
                if next_ckpt is not None and n_steps >= next_ckpt:
                    # never persist an unverified window: a detected-NaN
                    # state rolls back BEFORE the save
                    flush_checks()
                    self._save(gstep, {"epoch": epoch, "step": n_steps,
                                       "epoch_complete": False,
                                       "global_step": gstep,
                                       "loss_sum": loss_sum,
                                       "contributed": contributed})
                    next_ckpt = (n_steps // ckpt_n + 1) * ckpt_n
                if n_steps >= next_log:
                    self.logger.log(epoch=epoch, step=n_steps,
                                    train_loss=float(losses[-1]),
                                    global_step=gstep)
                    next_log = n_steps + cfg.log_every_n_steps
        finally:
            if prof is not None:  # the epoch ended (or raised) mid-window
                self._stop_profile(prof, epoch)
        flush_checks()
        dt = time.perf_counter() - t0
        ran = n_steps - start_step  # steps executed in this session
        self._logged_steps += n_steps
        avg = loss_sum / contributed if contributed else 0.0
        extra = {}
        if n_steps and self._train_auc is not None:
            extra["train_auc"] = float(self._train_auc.result())
        self.logger.log(epoch=epoch, train_loss_epoch=avg, steps=n_steps,
                        examples_per_sec=ran * cfg.per_device_train_batch_size
                        / max(dt, 1e-9), **extra)
        return avg

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def _stop_profile(self, prof, epoch: int) -> None:
        """Stop the trace and write it as a Chrome trace under
        ``<checkpoint_dir or .>/profile``."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = Path(self.config.checkpoint_dir or ".") / "profile"
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"trace_epoch{epoch}.json"
        prof.export_chrome_trace(str(path))
        self.logger.log(epoch=epoch, profile_trace=str(path))

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
            logits = logits.float()
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
        """Train and evaluate for ``n_epochs``, resuming from the newest
        checkpoint (Bert4Rec: a pre-training eval at epoch -1 on a fresh
        start, and the test eval after).  A mid-epoch checkpoint re-enters
        its epoch at the exact batch; an epoch-complete one starts the next
        epoch; a checkpoint without a cursor is the legacy epoch-indexed
        form (its id is the epoch).  Returns the last eval metrics; closes
        the metrics sink either way."""
        cfg = self.config
        start_epoch = 0
        resume = {"step": 0, "loss_sum": 0.0, "contributed": 0}
        metrics: dict[str, float] = {}
        try:
            restored = (self._ckpt.restore(self.state, stamps=self._ckpt_stamps)
                        if self._ckpt is not None else None)
            if restored is not None:
                step_id, self.state, cursor = restored
                if cursor is None:
                    start_epoch = step_id + 1
                    self.logger.log(resumed_from_epoch=step_id)
                elif cursor.get("epoch_complete"):
                    start_epoch = int(cursor["epoch"]) + 1
                    self._logged_steps = int(cursor["global_step"])
                    self.logger.log(resumed_from_epoch=int(cursor["epoch"]),
                                    global_step=self._logged_steps)
                else:
                    start_epoch = int(cursor["epoch"])
                    resume = {"step": int(cursor["step"]),
                              "loss_sum": float(cursor.get("loss_sum", 0.0)),
                              "contributed": int(cursor.get("contributed", 0))}
                    self._logged_steps = int(cursor["global_step"]) - resume["step"]
                    self.logger.log(resumed_mid_epoch=start_epoch,
                                    step=resume["step"],
                                    global_step=int(cursor["global_step"]))
            if self._seq and start_epoch == 0 and not resume["step"]:
                self.evaluate(epoch=-1)  # pre-training sanity floor
            for epoch in range(start_epoch, cfg.n_epochs):
                self.train_epoch(epoch, start_step=resume["step"],
                                 loss_sum=resume["loss_sum"],
                                 contributed=resume["contributed"])
                resume = {"step": 0, "loss_sum": 0.0, "contributed": 0}
                metrics = self.evaluate(epoch)
                if self._ckpt is not None and (
                        (epoch + 1) % cfg.checkpoint_every_n_epochs == 0
                        or epoch == cfg.n_epochs - 1):
                    # ids share the global data-step namespace with the
                    # mid-epoch saves; force replaces one at the same step
                    gstep = self._logged_steps
                    self._save(gstep, {"epoch": epoch, "step": 0,
                                       "epoch_complete": True,
                                       "global_step": gstep})
            metrics.update(self.evaluate_test())
        finally:
            self.logger.close()
            if self._ckpt is not None:
                self._ckpt.close()
        return metrics
