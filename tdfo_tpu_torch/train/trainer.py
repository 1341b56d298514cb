"""Epoch loop — port of ``tdfo_tpu/train/trainer.py`` (``_ctr_columns``,
``_ctr_eval_schema``, ``_build_twotower_dense``, ``_build_ctr_sparse``,
``_build_bert4rec``, ``pad_batch``, ``train_epoch``, ``evaluate``,
``evaluate_test``, ``fit``, train AUC, checkpoint/resume, profiling).

Regimes:

* TwoTower with ``model_parallel = false`` (the quickstart ``config.toml``):
  the dense regime, every parameter (the 7 ``[V, d]`` tables included) in
  one ``TwoTower`` under AdamW (``train/state.py::TrainState``,
  ``train/step.py``); f16 loss scaling under ``mixed_precision`` on the
  card.  Under a ``[mesh]`` with ``model > 1`` the state replicates, or
  with ``ps_min_shard_bytes > 0`` takes the reference's PS partition
  (``parallel/sharding.py::ps_shard_module_``: each leaf the
  ``min_size_partitioner_rule`` splits, with its AdamW moments, held as
  this rank's block and all-gathered for every forward); CUDA-graph steps
  replay the data all-reduce and that all-gather over NCCL.
* TwoTower with ``model_parallel = true`` and DLRM: the tables (TwoTower's
  7, or one per ``categorical_features`` column such as Criteo's 26) in a
  ShardedEmbeddingCollection with the row-sparse in-backward optimizer
  (``stack_tables``, ``dedup_lookup``; ``model_parallel = false`` places
  them ``"replicated"``, which on one device is the same storage), the
  dense backbone under AdamW.  ``[embeddings] table_dtype`` (and its
  per-table overrides) and ``slot_dtype`` set storage dtypes (bf16 writes
  stochastically rounded; int8 rowwise with its (scale, offset) sidecar,
  or in-line in int8 fat lines); ``hot_vocab > 0`` splits the tables
  listed in the ETL's ``hot_ids.json`` into hot heads and cold arrays;
  ``cache_rows > 0`` keeps the row-sparse arrays' updates in a device
  cache written back every ``flush_every`` steps and before every save
  and eval (an admission overflow fails the run).  Their checkpoints are
  stamped (hot-set digests, storage dtypes, the sidecar's layout and
  storage, the cache's knobs), and a restore under other values refuses.
  ``mixed_precision`` computes the backbone in
  ``core.precision.compute_dtype`` (f16 on the card, f32 on the CPU).
* Bert4Rec (``model_parallel`` true, or false: ``"replicated"``; f32
  whatever ``mixed_precision`` says, as the reference): the item
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

Several ranks (``launch.py --distributed``, ``core/mesh.py``): with a
process group running, the trainer lays the ranks out as the ``[mesh]``
table says and each rank streams its data slice of the global batch
(``per_device_train_batch_size`` rows; ranks that share a data index read
the same rows).  The CTR regimes shard the tables over the model axis
(``embedding_sharding``: row, table or column; int8 storage,
``dedup_lookup``, ``hot_vocab`` and the update cache too, the hot heads and
caches replicated, each flush writing every row into its owner and the
overflow check global) and look them up with ``lookup_mode``, under
``alltoall`` through the grouped
exchange with ``[embeddings] grouped_a2a`` and through the pipelined step
with ``[train] pipeline_overlap`` (the epoch loop primes on its first
batch, trains each batch one call later and flushes the last; the carry
is not checkpointed: a resume primes on the batch the carry held); the
dense TwoTower regime is data-parallel.  Bert4Rec takes the same table
layouts and lookups, ``[mesh] seq`` with ``attn = "ring" | "ring_flash"``
(the seq ranks read the same rows) and ``tensor_parallel`` (the Megatron
split over the model axis, under every lookup mode: under ``alltoall`` the
model ranks' shares are gathered before the backbone; its shards and their
AdamW moments gathered into checkpoints), its masked-LM loss normalised by the global batch's
label count and its eval sums taken over the ranks that split the batch.  Train losses,
the train AUC and every eval metric are the global batch's on every rank
(histograms, sums and counts summed over the data axis); eval tops each
rank up with zero-weight template batches to the longest slice's count, so
the collectives stay in lockstep.  Only rank 0 writes logs,
``metrics.jsonl`` and checkpoints; a checkpoint holds the single-device
layout (each sharded array gathered onto rank 0's host a shard at a
time, so no rank's device holds a whole sharded table), and restore takes
each rank's shard
of it, so a run saved at one world size resumes at another.

``[faults]`` (armed at construction, ``utils/faults.py``): ``nan_at_step``
poisons that run-global step's host batch (the non-finite guard then
rolls back), ``stall_at_step`` sleeps and ``kill_at_step`` exits after the
step's checkpoint save; ``fail_io_nth`` fails one ``retry_call``.
``[telemetry]``: ``counters`` opens an ``obs/counters.py`` collector
around each step, pipelined step and flush, and cache write-back, all
wrapped one way (``_with_counters``: inside the CUDA graph when the step
is captured), and the latest step's and write-back's counters are fetched
with the loss at the log cadence into ``metrics.jsonl``; ``events``
records builds, captures and card memory (``events.jsonl``, warm-up
marked after the first epoch and eval);
``trace`` attaches the span sinks; ``stall_timeout_s`` runs the watchdog
while ``fit`` runs; ``log_rotate_bytes`` caps the JSONL sinks.  The
online loop (``train/online.py``) drives ``_one_step`` and
:meth:`Trainer.flush_cache` itself.

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
from tdfo_tpu_torch.obs import counters as obs_counters
from tdfo_tpu_torch.obs import events as obs_events
from tdfo_tpu_torch.obs import trace as obs_trace
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
from tdfo_tpu_torch.utils import faults as _faults
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
    CTR ETLs write them (every column ``[B]``, so a zero-weight template
    batch is zeros of these dtypes)."""
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


def _check_cache_overflow(overflow: dict, mesh=None) -> None:
    """Fail loudly on update-cache admission overflow: ids past the free
    capacity never entered the cache, so their updates were lost.  Under a
    ``mesh`` every rank calls this at the same flush, and the check is
    global: the replicated caches must count the same overflow on every
    rank (else they diverged), and every rank fails together."""
    counts = {a: int(v) for a, v in overflow.items()}
    if mesh is not None and counts:
        import torch.distributed as dist

        names = sorted(overflow)
        hi = torch.stack([overflow[a].to(torch.int64).reshape(()) for a in names])
        lo = hi.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN)
        if not torch.equal(hi, lo):
            raise RuntimeError(
                "update-cache admission overflow differs between ranks "
                f"(per array, most {dict(zip(names, hi.tolist()))}, least "
                f"{dict(zip(names, lo.tolist()))}): the replicated caches "
                "diverged")
        counts = dict(zip(names, hi.tolist()))
    bad = {a: v for a, v in counts.items() if v > 0}
    if bad:
        raise RuntimeError(
            f"update-cache admission overflow (distinct ids whose updates "
            f"were LOST): {bad}.  embeddings.cache_rows is too small for "
            "the per-flush-interval working set — raise cache_rows (the "
            "retained half must cover the interval's distinct touched "
            "rows) or lower flush_every.")


def refuse_unported(cfg: Config, world: int | None = None,
                    device="cuda", backend: str | None = None) -> None:
    """Raise ``NotImplementedError`` for every knob value whose code path the
    port does not have yet, naming the ``ROADMAP.md`` item that ports it.
    ``world``: the ranks of the process group (default: the running one's,
    1 without one).  ``device`` and ``backend`` (default: the running
    group's): the dense regime's multi-step runs as CUDA-graph replays on
    the card, which capture collectives only over NCCL, so several ranks
    under gloo refuse it (a ``ValueError``)."""
    import torch.distributed as dist

    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    dense = cfg.model == "twotower" and not cfg.model_parallel
    if (world > 1 and dense and cfg.steps_per_execution > 1
            and torch.device(device).type == "cuda" and backend != "nccl"):
        raise ValueError(
            "steps_per_execution > 1 in the dense regime replays CUDA "
            "graphs, and CUDA-graph steps need NCCL: the "
            f"{backend or 'non-NCCL'} backend's collectives run on the host "
            "and cannot be captured (run one rank per card over NCCL, or "
            "steps_per_execution = 1)")
    checks = [
        (bool(cfg.planner.plan), "planner.plan", "14"),
        (cfg.write_format != "parquet", f"write_format = {cfg.write_format!r}", "16b"),
        (cfg.tensorboard, "tensorboard = true", "16b"),
    ]
    for bad, what, item in checks:
        if bad:
            raise NotImplementedError(
                f"{what} is not ported to tdfo_tpu_torch yet (ROADMAP.md "
                f"Queue A item {item})")


def _with_counters(step_fn, nonfinite=None):
    """``[telemetry] counters``: a step ``(state, out, *rest)`` (a train
    step, the pipelined step or flush, the cache write-back) returns
    ``(state, (out, counters), *rest)``, the collector open for its whole
    body (inside a CUDA-graph capture when the step is captured, so the
    counters are graph outputs).  ``nonfinite(logits)``: the CTR steps'
    ``nonfinite_logits`` counter, emitted in the body from ``out``'s logits
    (the reference emits it at its in-step AUC fold)."""

    def counted(*args):
        with obs_counters.collect() as c:
            state, out, *rest = step_fn(*args)
            if nonfinite is not None:
                obs_counters.emit("nonfinite_logits", lambda: nonfinite(out[1]))
        return (state, (out, dict(c)), *rest)

    return counted


class _Quiet:
    """The logger of ranks other than 0: writes nothing."""

    def log(self, **record) -> None:
        pass

    def close(self) -> None:
        pass


class _GlobalView:
    """A sharded state in the single-device layout (what a checkpoint
    holds).  ``gathered`` gives global rank 0 the whole state, each sharded
    table and slot (``coll``; None for the dense regime), and each
    parameter that ``plan`` splits over the model axis (tensor parallel,
    or the dense regime's PS partition) with its AdamW moments, gathered
    onto its host a shard at a time (the other ranks get None);
    ``state_dict`` is the restore template, the layout's shapes and dtypes
    with zero-memory stand-ins for the sharded arrays; ``load_state_dict``
    keeps this rank's shards.  ``key``: where the state's tensor-dict form
    keeps the module's parameters (``"backbone"``, or the dense
    ``"params"``)."""

    def __init__(self, state, coll, plan=None, mesh=None, key="backbone"):
        self.state, self.coll, self.mesh, self.key = state, coll, mesh, key
        module = state.model if key == "params" else state.backbone
        # parameter index -> (name, dim split over the model axis)
        plan = plan or {}
        self.split = {i: (n, plan[n].index("model"))
                   for i, (n, _) in enumerate(module.named_parameters())
                   if "model" in plan.get(n, ())}

    def _each_split(self, sd, fn) -> None:
        """``fn(tensor, dim)`` over every split parameter and its moments
        in the ``state_dict`` form ``sd``, in place."""
        for i, (name, dim) in self.split.items():
            sd[self.key][name] = fn(sd[self.key][name], dim)
            moments = dict(sd["optimizer"][i])
            for k, v in moments.items():
                if v.dim():  # the step counter stays
                    moments[k] = fn(v, dim)
            sd["optimizer"][i] = moments

    def gathered(self) -> dict | None:
        from tdfo_tpu_torch.core.mesh import (
            DATA_AXIS,
            MODEL_AXIS,
            SEQ_AXIS,
            axis_group,
            axis_index,
        )
        from tdfo_tpu_torch.parallel.collectives import gather_to_host

        sd = self.state.state_dict()
        if self.coll is not None:
            tables, slots = self.coll.global_arrays(sd["tables"], sd["slots"],
                                                    root_only=True)
        if self.split and not (axis_index(self.mesh, DATA_AXIS)
                            or axis_index(self.mesh, SEQ_AXIS)):
            sd[self.key], sd["optimizer"] = (dict(sd[self.key]),
                                             dict(sd["optimizer"]))
            group = axis_group(self.mesh, MODEL_AXIS)
            self._each_split(sd, lambda t, dim: gather_to_host(t, group, dim))
        if torch.distributed.get_rank() != 0:
            return None
        if self.coll is not None:
            sd["tables"], sd["slots"] = tables, slots
        return sd

    def state_dict(self) -> dict:
        from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_size

        sd = self.state.state_dict()
        if self.coll is not None:
            sd["tables"], sd["slots"] = self.coll.global_template(
                sd["tables"], sd["slots"])
        n = axis_size(self.mesh, MODEL_AXIS)

        def stand_in(t, dim):
            shape = list(t.shape)
            shape[dim] *= n
            return torch.empty((), dtype=t.dtype).expand(shape)

        sd[self.key], sd["optimizer"] = dict(sd[self.key]), dict(sd["optimizer"])
        self._each_split(sd, stand_in)
        return sd

    def load_state_dict(self, tree: dict) -> None:
        from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_index, axis_size

        tree = dict(tree)
        if self.coll is not None:
            tree["tables"], tree["slots"] = self.coll.local_arrays(
                tree["tables"], tree["slots"])
        n, k = axis_size(self.mesh, MODEL_AXIS), axis_index(self.mesh, MODEL_AXIS)

        def block(t, dim):
            size = t.shape[dim] // n
            return t.narrow(dim, k * size, size)

        tree[self.key], tree["optimizer"] = (dict(tree[self.key]),
                                             dict(tree["optimizer"]))
        self._each_split(tree, block)
        self.state.load_state_dict(tree)


class Trainer:
    """Config-driven trainer for the TwoTower (dense and DMP), DLRM and
    Bert4Rec regimes on one device (``device`` defaults to the card; pass
    ``"cpu"`` explicitly), or on every rank of a running process group (the
    module note).  ``log_dir`` defaults to ``checkpoint_dir``."""

    _METRIC_KS = (10, 20, 50)

    def __init__(self, config: Config, *, log_dir: str | Path | None = None,
                 device="cuda"):
        import torch.distributed as dist

        from tdfo_tpu_torch.core.mesh import _resolve_sizes, make_mesh

        refuse_unported(config, device=device)
        if config.tensor_parallel and config.model != "bert4rec":
            raise ValueError(
                "tensor_parallel = true splits bert4rec's transformer; "
                f"model {config.model!r} has none to split")
        if config.use_tpu:
            raise RuntimeError(
                "use_tpu = true but tdfo_tpu_torch trains on a CUDA card or "
                "the CPU, never a TPU (TPUStrategy-resolution parity: refuse "
                "to silently train a TPU config elsewhere)")
        self.config = config
        self.device = resolve_device(device)
        self.mesh = None
        if dist.is_initialized():
            self.mesh = make_mesh(config.mesh, self.device)
        else:  # a [mesh] that asks for more ranks than this one fails here
            _resolve_sizes(config.mesh, 1)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.last_metrics: dict[str, float] = {}
        out_dir = log_dir or config.checkpoint_dir
        tele = config.telemetry
        self.logger = (MetricLogger(out_dir, rotate_bytes=tele.log_rotate_bytes)
                       if self.rank == 0 else _Quiet())
        self._logged_steps = 0  # run-global data-step counter
        self._map_streams: dict = {}
        self._seq = config.model == "bert4rec"
        self._dense = config.model == "twotower" and not config.model_parallel
        self._ckpt = None
        self._ckpt_stamps = None  # compatibility stamps (dtypes, hot sets)
        self._cache_flush = None  # the update cache's write-back
        self._flush_every = 0  # its cadence in train steps
        self._train_auc = None
        self._a2a_watch = None  # the alltoall capacity's overflow counter
        self._pipe = None  # train.pipeline_overlap's (prime, step, flush)
        if out_dir is not None and self.rank == 0:
            _retry.set_failure_log(Path(out_dir) / "retries.jsonl",
                                   rotate_bytes=tele.log_rotate_bytes)
        # [faults], armed from this config; the kill markers live in
        # checkpoint_dir, so restarting the same command converges
        _faults.configure(config.faults, config.checkpoint_dir or None)
        # [telemetry]: counters ride the step's outputs and are fetched with
        # the losses at the log cadence; build/capture and memory events go
        # to events.jsonl, spans to trace/, and the stall watchdog beats
        # heartbeat.jsonl from a thread while fit runs
        self._counters_on = tele.counters
        self._step_ctrs: dict = {}  # the latest step's device counters
        self._flush_ctrs: dict = {}  # the latest cache flush's
        self._watchdog = None
        if (tele.events or tele.stall_timeout_s > 0 or tele.trace) and not out_dir:
            raise ValueError(
                "telemetry.events / telemetry.stall_timeout_s / "
                "telemetry.trace need a checkpoint_dir (or log_dir) to "
                "write events.jsonl / heartbeat.jsonl / trace-*.jsonl")
        if self.rank == 0:
            if tele.events:
                obs_events.configure(Path(out_dir) / "events.jsonl",
                                     rotate_bytes=tele.log_rotate_bytes)
            if tele.trace:
                obs_trace.configure(Path(out_dir) / "trace",
                                    rotate_bytes=tele.log_rotate_bytes)
            if tele.stall_timeout_s > 0:
                from tdfo_tpu_torch.obs.watchdog import StallWatchdog

                self._watchdog = StallWatchdog(
                    Path(out_dir) / "heartbeat.jsonl", tele.stall_timeout_s,
                    rotate_bytes=tele.log_rotate_bytes)
        if config.checkpoint_dir:
            self._ckpt = CheckpointManager(config.checkpoint_dir)
        if self._seq:
            self._build_bert4rec()
        elif self._dense:
            self._build_twotower_dense()
        else:
            self._build_ctr_sparse()
        self._multi_step = make_multi_step(self._one_step)
        if self.rank == 0:
            if self._dense:
                summary = param_summary(self.state.model,
                                        title=f"{config.model} parameters")
            else:
                summary = param_summary(self.state.backbone,
                                        tables=self.state.tables, coll=self.coll,
                                        title=f"{config.model} parameters")
            print(summary, flush=True)

    def restore_latest(self):
        """``(step, state)`` of the newest checkpoint under
        ``checkpoint_dir`` (its compatibility stamps checked), or ``(0,
        self.state)``, the fresh init, when there is none; ``self.state``
        is left as it is."""
        if self._ckpt is None or self._ckpt.latest_step() is None:
            return 0, self.state
        step, _, _ = self._ckpt.restore(self._ckpt_view(),
                                        stamps=self._ckpt_stamps)
        return step, self.state

    # ------------------------------------------------------------- ranks

    def _ckpt_view(self):
        """What checkpoints save and restore: the state, in the
        single-device layout under a mesh."""
        if self.mesh is None:
            return self.state
        if self._dense:
            return _GlobalView(self.state, None, self._ps_plan, self.mesh,
                               key="params")
        return _GlobalView(self.state, self.coll,
                           getattr(self.backbone, "tp_plan", None) if self._seq
                           else None, self.mesh)

    def _data_sum(self, tensors):
        """Sums over the data axis (the global batch's totals); identity
        without a mesh."""
        from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_group, axis_size
        from tdfo_tpu_torch.parallel.collectives import all_reduce_tensors

        if axis_size(self.mesh, DATA_AXIS) == 1:
            return list(tensors)
        return all_reduce_tensors(tensors, axis_group(self.mesh, DATA_AXIS))

    def _global_auc(self, auc: AUC) -> AUC:
        pos, neg = self._data_sum([auc.pos_hist, auc.neg_hist])
        return AUC(pos_hist=pos, neg_hist=neg)

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
        # the PS partition (the reference's dense regime under a mesh with
        # ps_min_shard_bytes > 0): every rank drew the whole model and keeps
        # its blocks; without it the state replicates
        self._ps_plan = None
        if self.mesh is not None and cfg.ps_min_shard_bytes > 0:
            from tdfo_tpu_torch.parallel.sharding import (
                min_size_partitioner_rule,
                ps_shard_module_,
            )

            self._ps_plan = ps_shard_module_(
                model, self.mesh,
                min_size_partitioner_rule(self.mesh, cfg.ps_min_shard_bytes))
        loss_scale = (DynamicLossScale.create(device=self.device)
                      if cfg.mixed_precision and cfg.loss_scale == "dynamic"
                      and dtype == torch.float16 else None)
        on_card = self.device.type == "cuda"
        self.state = TrainState.create(
            model=model, learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay, loss_scale=loss_scale,
            capturable=on_card)
        inner = make_train_step(with_aux=True, mesh=self.mesh,
                                plan=self._ps_plan)
        if self._counters_on:
            inner = _with_counters(inner, self._nonfinite)
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
        hot_ids = None
        if cfg.embeddings.hot_vocab > 0:
            from tdfo_tpu_torch.data.hot_ids import load_hot_ids

            artifact = load_hot_ids(cfg.data_dir)
            if artifact is None:
                raise ValueError(
                    "embeddings.hot_vocab > 0 but no hot_ids.json under "
                    f"{cfg.data_dir!r} — re-run preprocessing with this "
                    "config to emit the hot/cold remap artifact"
                )
            # the artifact keys by column; keep the tables this model serves
            served = {f for s in specs for f in s.features} | {s.name for s in specs}
            hot_ids = {k: v for k, v in artifact.items() if k in served} or None
        cache_rows = cfg.embeddings.cache_rows
        coll = ShardedEmbeddingCollection(
            specs, fused_kind=cfg.sparse_optimizer, stack_tables=cfg.stack_tables,
            hot_ids=hot_ids, cache_rows=cache_rows, mesh=self.mesh,
            a2a_capacity_factor=cfg.a2a_capacity_factor or None,
            grouped_a2a=cfg.embeddings.grouped_a2a)
        # stamps refuse a restore that would pair values with the wrong ids
        # or dtypes: the hot sets, the storage dtypes (defaults-only runs
        # write none, the reference's rule), the int8 sidecar's layout and
        # where it lives, and the update cache's knobs
        stamps: dict = {}
        if coll.hot_ids:
            stamps["hot_ids"] = coll.hot_digest()
        tstamp = {s.name: str(s.dtype).removeprefix("torch.") for s in specs}
        if (any(v != "float32" for v in tstamp.values())
                or cfg.embeddings.slot_dtype != "float32"):
            stamps["table_dtype"] = tstamp
            stamps["slot_dtype"] = cfg.embeddings.slot_dtype
        if any(v == "int8" for v in tstamp.values()):
            from tdfo_tpu_torch.ops.quant import QSCALE_LAYOUT

            stamps["qscale_layout"] = QSCALE_LAYOUT
            fat_inline = {s.name: "fat-inline" for s in specs
                          if s.dtype == torch.int8 and s.fused}
            if fat_inline:
                stamps["qscale_storage"] = fat_inline
        if cache_rows > 0:
            stamps["update_cache"] = {
                "cache_rows": int(cache_rows),
                "flush_every": int(cfg.embeddings.flush_every),
            }
        if self.mesh is not None:
            # one checkpoint for all ranks: each must have loaded the same
            # hot sets and built the same storage
            import json

            seen: list = [None] * torch.distributed.get_world_size()
            torch.distributed.all_gather_object(seen, json.dumps(stamps, sort_keys=True))
            if len(set(seen)) > 1:
                raise ValueError(
                    "the ranks' checkpoint stamps differ (each rank must read "
                    f"the same hot_ids.json and storage knobs): {seen}")
        self._ckpt_stamps = stamps or None
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
        if cache_rows > 0:
            # the caches ride in the slots (checkpoints and rollback
            # snapshots carry them); the write-back runs every flush_every
            # steps and before every save and eval
            from tdfo_tpu_torch.train.sparse_step import make_cache_flush_fn

            caches = coll.init_caches(self.state.tables, self.state.sparse_opt)
            if caches:
                self.state.slots.update(caches)
                self._cache_flush = make_cache_flush_fn(coll)
                if self._counters_on:
                    self._cache_flush = _with_counters(self._cache_flush)
                self._flush_every = cfg.embeddings.flush_every
        if cfg.train.pipeline_overlap:
            # TrainPipelineSparseDist parity: batch N+1's input-dist is in
            # flight while batch N trains; the epoch loop primes on its
            # first batch and flushes its last
            from tdfo_tpu_torch.train.sparse_step import (
                make_pipelined_sparse_train_step,
            )

            if cfg.dedup_lookup:
                raise ValueError(
                    "dedup_lookup (gspmd-only) does not compose with "
                    "train.pipeline_overlap")
            self._pipe = make_pipelined_sparse_train_step(
                coll, ctr_sparse_forward(backbone, with_logits=True),
                with_aux=True)
            if self._counters_on:
                self._pipe = self._pipe._replace(
                    step=_with_counters(self._pipe.step, self._nonfinite),
                    flush=_with_counters(self._pipe.flush, self._nonfinite))
        else:
            self.train_step = make_sparse_train_step(
                coll, ctr_sparse_forward(backbone, with_logits=True),
                mode=cfg.lookup_mode, with_aux=True,
                dedup_lookup=cfg.dedup_lookup)
            if self._counters_on:
                self.train_step = _with_counters(self.train_step, self._nonfinite)
        if (self.mesh is not None and cfg.lookup_mode == "alltoall"
                and coll.a2a_capacity_factor is not None):
            # ids a finite capacity dropped (they read zeros): logged at
            # every log boundary, as the reference does
            from tdfo_tpu_torch.train.sparse_step import BatchGroup

            bg, feats = BatchGroup(self.mesh, "alltoall"), list(coll.features())
            self._a2a_watch = lambda b: coll.a2a_overflow(
                self.state.tables, bg.split({f: b[f] for f in feats}))
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
        self._refuse_bert4rec_knobs()
        self.coll, tables, self.backbone = make_sharded_bert4rec(
            self.model_cfg, seed=cfg.seed, sharding=sharding,
            attn=cfg.attn, fused_threshold=cfg.effective_fused_threshold,
            fused_kind=cfg.sparse_optimizer, device=self.device, mesh=self.mesh,
            a2a_capacity_factor=cfg.a2a_capacity_factor or None,
            ring_block_k=cfg.ring_block_k or None,
            tp_heads=cfg.tensor_parallel and cfg.attn in ("ring", "ring_flash"),
            tensor_parallel=cfg.tensor_parallel,
            grouped_a2a=cfg.embeddings.grouped_a2a)
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

        if cfg.train.pipeline_overlap:
            # the pipelined step over the grouped exchange (it refuses
            # without a mesh, by the reference's message)
            from tdfo_tpu_torch.train.sparse_step import (
                make_pipelined_sparse_train_step,
            )

            if cfg.dedup_lookup:
                raise ValueError(
                    "dedup_lookup (gspmd-only) does not compose with "
                    "train.pipeline_overlap")
            self._pipe = make_pipelined_sparse_train_step(
                self.coll, bert4rec_sparse_forward(self.backbone),
                batch_transform=transform,
                tensor_parallel=cfg.tensor_parallel)
            if self._counters_on:
                self._pipe = self._pipe._replace(
                    step=_with_counters(self._pipe.step),
                    flush=_with_counters(self._pipe.flush))
        else:
            self.train_step = make_sparse_train_step(
                self.coll, bert4rec_sparse_forward(self.backbone),
                mode=cfg.lookup_mode, dedup_lookup=cfg.dedup_lookup,
                batch_transform=transform,
                tensor_parallel=cfg.tensor_parallel)
            if self._counters_on:
                self.train_step = _with_counters(self.train_step)
        self._set_patterns("parquet_bert4rec")
        self._eval_schema = {"seqs": np.int32, "cands": np.int32}
        self._eval_rename = lambda raw: {"seqs": raw["eval_seqs"],
                                         "cands": raw["candidate_items"]}

    def _refuse_bert4rec_knobs(self) -> None:
        """Bert4Rec's knob that does not compose, by name: hot/cold
        storage (a CTR table form)."""
        cfg = self.config
        if cfg.embeddings.hot_vocab > 0:
            raise ValueError(
                "embeddings.hot_vocab splits the CTR tables the CTR ETL lists "
                "in hot_ids.json; bert4rec's item table has no hot/cold form")

    # ------------------------------------------------------------- streams

    def _stream(self, pattern: str, *, train: bool):
        """This rank's stream: its data slice (ranks that share a data
        index read the same rows)."""
        from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_index, axis_size

        cfg = self.config
        files = resolve_files(cfg.data_dir, pattern)
        bsz = (cfg.per_device_train_batch_size if train
               else cfg.per_device_eval_batch_size)
        n_data = axis_size(self.mesh, DATA_AXIS)
        if not cfg.streaming:
            key = (pattern, bsz, train)
            if key not in self._map_streams:
                self._map_streams[key] = MapStream(
                    files, batch_size=bsz, shuffle=train, seed=cfg.seed,
                    drop_last=train, process_count=n_data)
            return self._map_streams[key]
        return ParquetStream(
            files, batch_size=bsz, shuffle=train,
            buffer_size=cfg.shuffle_buffer_size, seed=cfg.seed,
            drop_last=train, num_workers=cfg.num_workers,
            process_index=axis_index(self.mesh, DATA_AXIS), process_count=n_data,
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
        inj = _faults.active()
        if inj is not None and inj.spec.nan_at_step:
            # keyed on the run-global data position (stable across resume
            # and steps_per_execution regrouping); _logged_steps holds the
            # epoch-start value until the epoch ends
            base, poison = self._logged_steps, inj.poison_batch

            def poisoned(gen, pos):
                for b in gen:
                    pos += 1
                    yield poison(b, base + pos)

            host = poisoned(host, skip)
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

    def dropout_generator(self, step: int):
        """Bert4Rec's dropout generator of train step ``step`` (the
        reference's ``_dropout_rng`` folded with ``state.step``)."""
        return dropout_generator(self.config.seed + 1, step, self.device)

    def _one_step(self, state, batch):
        """One train step and the trainer's folds: Bert4Rec's per-step
        dropout generator, the CTR train AUC, and with ``[telemetry]
        counters`` the step's counters kept (on the device) for the log
        boundary.  ``(state, loss)``."""
        if self._seq:
            state, out = self.train_step(state, batch,
                                         self.dropout_generator(state.step))
        else:
            state, out = self.train_step(state, batch)
        return state, self._fold(out, None if self._seq else batch["label"])

    def _fold(self, out, labels):
        """A step's output -> its loss: the counters kept and, for the CTR
        family (``labels`` given), the logits folded into the train AUC."""
        if self._counters_on:
            out, self._step_ctrs = out
        if labels is None:
            return out
        loss, logits = out
        if self._train_auc is not None:  # the online loop trains without it
            logits = logits.float()  # a narrow compute dtype's logits
            ok = torch.isfinite(logits)
            self._train_auc = self._train_auc.update(
                labels, torch.sigmoid(torch.where(ok, logits, 0.0)),
                ok.to(torch.float32))
        return loss

    def _nonfinite(self, logits):
        """The global batch's non-finite logits (the ``nonfinite_logits``
        counter, which the AUC fold weighs out)."""
        return self._data_sum([(~torch.isfinite(logits)).sum().to(torch.float32)])[0]

    def _pipelined_step(self, state, batch, carry):
        """The pipelined step: trains the CARRIED batch, so the AUC folds the
        carry's labels (reference ``_wrap_auc_pipelined``); Bert4Rec takes
        the dropout generator of the step it trains.  ``(state, loss,
        carry)``."""
        if self._seq:
            labels = None
            state, out, carry = self._pipe.step(
                state, batch, carry, self.dropout_generator(state.step))
        else:
            labels = carry[0]["label"]
            state, out, carry = self._pipe.step(state, batch, carry)
        return state, self._fold(out, labels), carry

    def _pipelined_flush(self, state, carry):
        if self._seq:
            labels = None
            state, out = self._pipe.flush(
                state, carry, self.dropout_generator(state.step))
        else:
            labels = carry[0]["label"]
            state, out = self._pipe.flush(state, carry)
        return state, self._fold(out, labels)

    def single_device_state(self) -> dict | None:
        """The state's tensor-dict form in the single-device layout (what a
        checkpoint or a serving bundle holds): under a mesh every rank
        calls this and global rank 0 gets the sharded arrays gathered onto
        its host (the others get None); without one, the state's own."""
        view = self._ckpt_view()
        return (view.gathered() if isinstance(view, _GlobalView)
                else view.state_dict())

    def _save(self, gstep: int, cursor: dict) -> None:
        """Rank 0 gathers the sharded arrays onto its host and writes; the
        others send their shards and wait for it."""
        import torch.distributed as dist

        tree = self.single_device_state()
        if self.rank == 0:
            self._ckpt.save(gstep, tree, force=True, cursor=cursor,
                            stamps=self._ckpt_stamps)
        if dist.is_initialized():
            dist.barrier()

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
        inj = _faults.active()
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
            for over in pending_over:
                _check_cache_overflow(over, self.mesh)
            pending_over.clear()
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
        # the cache's write-back cadence: the periodic flush's overflow
        # counts queue like the losses and are checked with them
        flush_n = self._flush_every if self._cache_flush is not None else 0
        next_flush = (n_steps // flush_n + 1) * flush_n if flush_n else None
        pending_over: list[dict] = []
        profiling = cfg.profile and epoch == 0
        prof = None
        # pipeline_overlap's carry: the next batch to train and its
        # input-dist.  Not in the cursor: n_steps counts TRAINED batches,
        # so a resume skips exactly those and primes on the carried batch
        carry = None
        try:
            for batch, k in self._train_batches(epoch, skip=start_step):
                if profiling and prof is None and n_steps >= 10:
                    prof = self._start_profile()
                if self._pipe is not None and carry is None:
                    carry = self._pipe.prime(batch)  # trains next iteration
                    continue
                if self._pipe is not None:
                    self.state, loss, carry = self._pipelined_step(
                        self.state, batch, carry)
                    losses = loss.reshape(1)
                elif cfg.steps_per_execution > 1:
                    self.state, losses = self._multi_step(self.state, batch)
                else:
                    self.state, loss = self._one_step(self.state, batch)
                    losses = loss.reshape(1)
                n_steps += k
                gstep = self._logged_steps + n_steps
                if self._watchdog is not None:
                    self._watchdog.beat(gstep)
                pending.append((losses, k, gstep))
                pending_steps += k
                if next_flush is not None and n_steps >= next_flush:
                    pending_over.append(self._run_cache_flush())
                    next_flush = (n_steps // flush_n + 1) * flush_n
                if pending_steps >= flush_every:
                    flush_checks()
                if prof is not None and n_steps >= 20:
                    self._stop_profile(prof, epoch)
                    prof, profiling = None, False
                if next_ckpt is not None and n_steps >= next_ckpt:
                    # never persist an unverified window: a detected-NaN
                    # state rolls back BEFORE the save; checkpoints hold
                    # flushed tables
                    flush_checks()
                    self.flush_cache()
                    self._save(gstep, {"epoch": epoch, "step": n_steps,
                                       "epoch_complete": False,
                                       "global_step": gstep,
                                       "loss_sum": loss_sum,
                                       "contributed": contributed})
                    next_ckpt = (n_steps // ckpt_n + 1) * ckpt_n
                if inj is not None:
                    inj.maybe_stall(gstep)  # a host-side sleep
                    inj.maybe_kill(gstep)  # after the save: it is durable
                if n_steps >= next_log:
                    extra = ({} if self._a2a_watch is None or k > 1 else
                             {"a2a_overflow": int(self._a2a_watch(batch))})
                    self.logger.log(epoch=epoch, step=n_steps,
                                    **self._log_values(losses[-1]),
                                    global_step=gstep, **extra)
                    if obs_events.active():
                        obs_events.memory_snapshot()
                    next_log = n_steps + cfg.log_every_n_steps
            if carry is not None:
                # drain the pipeline: the last carried batch trains here
                self.state, loss = self._pipelined_flush(self.state, carry)
                carry = None
                n_steps += 1
                pending.append((loss.reshape(1), 1, self._logged_steps + n_steps))
                pending_steps += 1
        finally:
            if prof is not None:  # the epoch ended (or raised) mid-window
                self._stop_profile(prof, epoch)
        flush_checks()
        self.flush_cache()  # epoch boundary: leave the tables flushed
        dt = time.perf_counter() - t0
        ran = n_steps - start_step  # steps executed in this session
        self._logged_steps += n_steps
        avg = loss_sum / contributed if contributed else 0.0
        extra = {}
        if n_steps and self._train_auc is not None:
            extra["train_auc"] = float(self._global_auc(self._train_auc).result())
        self.logger.log(epoch=epoch, train_loss_epoch=avg, steps=n_steps,
                        examples_per_sec=ran * cfg.per_device_train_batch_size
                        / max(dt, 1e-9), **extra)
        return avg

    def _log_values(self, loss) -> dict[str, float]:
        """``train_loss`` and, with ``[telemetry] counters``, the latest
        step's and cache flush's counters (and each cache's hit rate), in
        ONE host fetch: the log boundary's sync, which the loss needed
        anyway."""
        ctrs = {**self._step_ctrs, **self._flush_ctrs} if self._counters_on else {}
        vals = torch.stack([loss.reshape(()).to(torch.float32)]
                           + [v.to(loss.device) for v in ctrs.values()]).tolist()
        rec = {"train_loss": vals[0], **dict(zip(ctrs, vals[1:]))}
        for ck in [c for c in rec if c.endswith("cache_hit_rows")]:
            base = ck[: -len("hit_rows")]
            tot = rec[ck] + rec.get(base + "miss_rows", 0.0)
            if tot:
                rec[base + "hit_rate"] = rec[ck] / tot
        return rec

    def _run_cache_flush(self) -> dict:
        """One cache write-back (its counters kept with ``[telemetry]
        counters``); returns the overflow counts."""
        self.state, over = self._cache_flush(self.state)
        if self._counters_on:
            over, self._flush_ctrs = over
        return over

    def flush_cache(self) -> None:
        """Write the update cache back now and check that no admission
        overflowed (no-op when the cache is off): before every checkpoint,
        eval and serving export."""
        if self._cache_flush is None:
            return
        _check_cache_overflow(self._run_cache_flush(), self.mesh)

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

    def close_telemetry(self) -> None:
        """Stop the watchdog and detach the event recorder (its last record
        the run-peak memory watermark) and the trace sinks."""
        if self._watchdog is not None:
            self._watchdog.stop()
        if obs_events.active():
            obs_events.record("run_summary", peak_bytes=obs_events.peak_memory())
            obs_events.configure(None)
        if obs_trace.active():
            obs_trace.configure(None)

    # ----------------------------------------------------------------- eval

    def _eval_batches(self, pattern: str | None = None) -> Iterator[dict]:
        """Padded eval batches (of ``pattern``, default the eval split)
        restricted to the schema, each with a ``_weight`` row mask (0 on
        padding rows)."""
        stream = self._stream(pattern or self._eval_pattern, train=False)
        bsz = stream.batch_size
        schema = self._eval_schema
        rename = self._eval_rename
        # every rank runs the longest slice's count (the lookups are
        # collectives): short ranks top up with zero-weight templates
        budget = stream.max_batches_per_host() if self.mesh is not None else 0

        def template():
            t = {k: np.zeros((bsz,), dt) for k, dt in schema.items()}
            t["_weight"] = np.zeros((bsz,), np.float32)
            return t

        def gen():
            n = 0
            for raw in stream:
                n += 1
                if self._watchdog is not None:  # eval batches are liveness
                    self._watchdog.beat(self._logged_steps)
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
            for _ in range(n, budget):
                yield template()

        yield from prefetch_to_device(gen(), self.device)

    def evaluate(self, epoch: int) -> dict[str, float]:
        """Eval metrics over the eval split: loss and streaming AUC
        (TwoTower), Recall/NDCG@k (Bert4Rec); one host fetch at the end.
        The update cache is flushed first: eval reads the tables."""
        self.flush_cache()
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
        loss_sum, w_sum = self._data_sum([loss_sum, w_sum])
        metrics = {
            "eval_loss": float(loss_sum) / max(float(w_sum), 1.0),
            "auc": float(self._global_auc(auc).result()),
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
        from tdfo_tpu_torch.parallel.collectives import all_reduce_tensors
        from tdfo_tpu_torch.train.seq import score_candidates
        from tdfo_tpu_torch.train.sparse_step import BatchGroup

        mode = self.config.lookup_mode
        bg = BatchGroup(self.mesh, mode)  # the ranks whose lookups differ
        # a Megatron backbone needs the data-local batch on every model
        # rank: alltoall's shares are joined before it
        join = self.config.tensor_parallel and bg.model_split
        fg = BatchGroup(self.mesh, "gspmd") if join else bg
        acc = {"w_sum": torch.zeros((), device=self.device)}
        for k in self._METRIC_KS:
            acc[f"Recall@{k}"] = torch.zeros((), device=self.device)
            acc[f"NDCG@{k}"] = torch.zeros((), device=self.device)
        for batch in self._eval_batches(pattern):
            batch = bg.split(batch)
            emb = self.coll.lookup(self.state.tables, {"item": batch["seqs"]},
                                   mode=mode)["item"]
            if join:
                emb = bg.join(emb)
                batch = {k: bg.join(batch[k]) for k in ("seqs", "cands", "_weight")}
            w = batch["_weight"]
            logits = self.backbone(emb, key_padding_mask(batch["seqs"]))
            scores = score_candidates(logits, batch["cands"],
                                      vocab_split=self.backbone.vocab_tp)
            labels = torch.zeros_like(scores)
            labels[:, 0] = 1.0
            m = recalls_and_ndcgs_for_ks(scores, labels, ks=self._METRIC_KS,
                                         row_weights=w)
            acc["w_sum"] += w.sum()
            for k, v in m.items():
                acc[k] += v * w.sum()
        if fg.size > 1:  # the global batch's sums
            acc = dict(zip(acc, all_reduce_tensors(list(acc.values()), fg.group)))
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
        if self._watchdog is not None:
            self._watchdog.start()
        try:
            restored = (self._ckpt.restore(self._ckpt_view(),
                                           stamps=self._ckpt_stamps)
                        if self._ckpt is not None else None)
            if restored is not None:
                step_id, _, cursor = restored
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
                if epoch == start_epoch and obs_events.active():
                    # every kernel, graph and program of the steady cadence
                    # is built by the end of the first epoch and eval
                    obs_events.mark_warmup()
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
            self.last_metrics = metrics
        finally:
            self.close_telemetry()
            self.logger.close()
            if self._ckpt is not None:
                self._ckpt.close()
        return metrics
