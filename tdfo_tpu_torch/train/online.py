"""The online-learning supervisor: serve -> retrain -> delta-export -> swap —
port of ``tdfo_tpu/train/online.py`` (``OnlineLoop``, ``online_from_config``).

The loop tails the serving frontend's request log through the crash-safe
``ReplayConsumer`` (``data/replay.py``), trains ``steps_per_cycle``
incremental steps with the trainer's own step (the DMP sparse step, whose
fat-line update and segment sums are the hand-written kernels on the card;
Bert4Rec's attention too under ``attn = "flash"``), persists the replay
cursor beside the checkpoint, exports a delta bundle
(``serve/export.py::export_delta``), publishes it to the ``BundleStore``
and swaps the serving side: the in-process ``MicroBatcher``, the
in-process ``ServingFleet`` (``[serving] replicas > 1``) or the
out-of-process ``ProcessFleet`` (``fleet_mode = "process"``).

Crash safety is a single-durability-point design, the reference's.  Each
plain cycle runs

    replay -> train -> checkpoint -> export -> publish -> swap

and the CHECKPOINT is the only commit: the state and the replay cursor (and
a ``target_version`` claim for the store) land in one save.  A kill before
it discards the cycle: the restart re-reads the same records from the last
durable cursor onto the matching restored state.  A kill after it but
before the store caught up is repaired by ``_catch_up`` at start-up, which
re-exports the (deterministic) delta and publishes it.  Either way,
restarting the same command converges to the uninterrupted run's bundle
bit for bit.

The GATED mode (``[online] canary_cycles > 0``, over a fleet) puts a
canary gatekeeper between training and serving:

    replay -> train -> export -> publish -> canary -> verdict -> commit -> swap

with the VERDICT checkpoint as the single durability point: a shadow slice
of held-out replayed traffic (``peek_batches``: rows past the committed
cursor) scores the candidate against the incumbent, survivors publish under
the ``CANARY`` pointer for the fleet's first ``canary_fraction`` replicas,
``canary_cycles`` watch rounds compare canary and stable heartbeats (AUC,
and the p99 latency term), and promote moves ``CURRENT`` while rollback
deletes the candidate, records it in ``rejections.json``, restores the last
good state and lets every replica converge back onto the last good version.
A kill after the verdict checkpoint is repaired by ``_catch_up_gated``.

The stage boundaries consult ``FaultInjector.maybe_kill_stage`` (the kill
matrix), every cycle logs an ``online_cycle`` record (the consumed
``(seq, row_start, row_end)`` spans and the ``replay/*`` counters) through
the trainer's ``metrics.jsonl``, and ``[telemetry] trace`` gets the
reference's ``stage`` and ``online_cycle`` spans, so ``launch obs``
assembles the same timelines.  Both families run: CTR (TwoTower DMP, DLRM;
labelled rows, ``binary_auc`` gates) and seq (Bert4Rec: replayed candidate
panels, a last-position masked-LM step, ``ranking_auc`` gates).
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any

import numpy as np

from tdfo_tpu_torch.obs import events as _events
from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.obs.aggregate import percentile as _percentile
from tdfo_tpu_torch.utils import faults as _faults

__all__ = ["OnlineLoop", "online_from_config"]


def _stage(name: str) -> None:
    """A supervisor stage boundary: the deterministic kill-matrix hook.
    The named stage has NOT run yet when the injected kill fires."""
    inj = _faults.active()
    if inj is not None:
        inj.maybe_kill_stage(name)


class _StageTrace:
    """Per-cycle stage timer: ``mark(name)`` closes the previous stage's
    trace span (the reference's spans) and opens the next, and keeps each
    stage's milliseconds in ``ms``; ``split(part, t0)`` moves the time
    since ``t0`` out of the open stage into ``part`` (a finer breakdown
    that emits no span).  A killed stage never closes."""

    def __init__(self, cycle: int):
        self.cycle = int(cycle)
        self.ms: dict[str, float] = {}
        self._name: str | None = None
        self._t0 = 0.0

    def mark(self, name: str) -> None:
        self.close()
        self._name, self._t0 = name, _trace.clock()

    def split(self, part: str, t0: float) -> None:
        dur = _trace.elapsed_ms(t0)
        self.ms[part] = self.ms.get(part, 0.0) + dur
        self.ms[self._name] = self.ms.get(self._name, 0.0) - dur

    def close(self) -> None:
        if self._name is not None:
            dur = round(_trace.elapsed_ms(self._t0), 3)
            self.ms[self._name] = self.ms.get(self._name, 0.0) + dur
            _trace.emit("online", "stage", cycle=self.cycle, stage=self._name,
                        dur_ms=dur)
            self._name = None


class OnlineLoop:
    """One supervisor process: trainer + replay consumer + bundle store +
    serving side, advancing in checkpointed cycles on ``device`` (the card
    unless the caller asks for the CPU).

    Restricted to the DMP/sparse regime (DLRM, TwoTower with
    ``model_parallel``, or Bert4Rec): a delta diffs embedding tables.  The
    seq family replays eval-window records (``seqs``/``cands``, no label),
    trains each as a last-position masked-LM step and judges shadow and
    canary scores by ``ranking_auc`` over the candidate panels.
    """

    def __init__(self, config, *, log_dir: str | Path | None = None,
                 device="cuda"):
        import torch.distributed as dist

        from tdfo_tpu_torch.core.config import serving_model_kind
        from tdfo_tpu_torch.data.replay import ReplayConsumer, make_replay_consumer
        from tdfo_tpu_torch.serve.swap import BundleStore
        from tdfo_tpu_torch.train.trainer import Trainer

        if not config.online.request_log:
            raise ValueError(
                "the online loop needs [online] request_log — the directory "
                "a serving frontend (serve --serving.log_features) wrote")
        self.model_kind = serving_model_kind(config)
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise ValueError(
                "the online supervisor is single-process (one serving "
                "replica owns its request log and bundle store)")
        if config.steps_per_execution > 1:
            raise ValueError(
                "online requires steps_per_execution = 1: cycles are short "
                "and the cursor commits per cycle, not per scan chunk")

        self.config = config
        self.trainer = Trainer(config, log_dir=log_dir, device=device)
        if not hasattr(self.trainer.state, "tables"):
            raise ValueError(
                "online requires the DMP/sparse regime (dlrm, or twotower "
                "with model_parallel) — delta export diffs embedding tables")
        if self.trainer._pipe is not None:
            raise ValueError(
                "online does not support train.pipeline_overlap: the "
                "checkpoint stage needs the cycle's updates flushed")
        if self.trainer._ckpt is None:
            raise ValueError("online requires checkpoint_dir")
        self.trainer._train_auc = None  # no train AUC in the loop's records

        self.workdir = Path(config.checkpoint_dir)
        self.store = BundleStore(self.workdir / "bundle_store",
                                 keep_versions=config.serving.keep_versions)
        self.store.recover()  # half-published strays from a killed publish
        self.chain = self.workdir / "delta_chain"
        self.chain.mkdir(parents=True, exist_ok=True)
        self.gated = config.online.canary_cycles > 0

        # restore: the state and the replay cursor land together, so a
        # resumed process continues at the exact record the state has seen
        self.gstep = 0
        cursor: dict[str, Any] | None = None
        if self.trainer._ckpt.latest_step() is not None:
            self.gstep, _, cursor = self.trainer._ckpt.restore(
                self.trainer.state, stamps=self.trainer._ckpt_stamps)
        replay_cursor = (cursor or {}).get("replay")
        self._claimed_version = int((cursor or {}).get("target_version") or 0)
        self.cycles_done = int((cursor or {}).get("cycles_done") or 0)
        self._pending_canary = (cursor or {}).get("canary")

        # a multi-replica fleet writes one request log per replica; the
        # factory folds them into one exactly-once stream keyed
        # (replica_id, seq)
        consumer_cls = (make_replay_consumer if config.serving.replicas > 1
                        else ReplayConsumer)
        self.consumer = consumer_cls(
            config.online.request_log, schema=self._replay_schema(),
            batch_size=config.per_device_train_batch_size,
            max_bad_records=config.online.max_bad_records,
            max_lag_records=config.online.max_lag_records,
            lag_policy=config.online.lag_policy, cursor=replay_cursor)
        self._bootstrap_store()
        if self.gated and self.trainer._ckpt.latest_step() is None:
            # rollback anchor: gated cycle 1 needs a last good state to
            # restore on rejection, durable before any gated training
            self._save({"online": True, "global_step": 0, "cycles_done": 0,
                        "replay": self.consumer.cursor(),
                        "target_version": int(self.store.current_version() or 0)})
        if self.gated:
            self._catch_up_gated()
        else:
            self._catch_up()
        self.fleet = None
        self.batcher = None
        dev = self.trainer.device
        if config.serving.fleet_mode == "process":
            # out-of-process fleet: replica processes behind the socket
            # ingress; its canary watch delivers a real SIGKILL under
            # kill_replica_signal and sync() respawns the victims
            from tdfo_tpu_torch.serve.supervisor import ProcessFleet

            self.fleet = ProcessFleet(self.store, config, workdir=self.workdir,
                                      logger=self.trainer.logger,
                                      device=str(dev))
            self.fleet.sync()
        elif config.serving.replicas > 1:
            from tdfo_tpu_torch.serve.fleet import ServingFleet

            self.fleet = ServingFleet(self.store, config,
                                      logger=self.trainer.logger, device=dev)
            self.fleet.sync()
        else:
            self.batcher = self._make_batcher()
        self.cycles = 0

    # -------------------------------------------------------- state side

    def _replay_schema(self) -> dict[str, tuple]:
        """Replay columns -> ``(numpy dtype, per-row shape)``: the CTR eval
        columns (label included) or the seq family's eval windows and
        ``1 + EVAL_NEG_NUM`` candidate panels."""
        if self.model_kind == "seq":
            from tdfo_tpu_torch.data.seq_preprocessing import EVAL_NEG_NUM

            return {"seqs": (np.int32, (self.config.max_len,)),
                    "cands": (np.int32, (EVAL_NEG_NUM + 1,))}
        return {c: (dt, ()) for c, dt in self.trainer._eval_schema.items()}

    def _save(self, cursor: dict) -> None:
        """The cycle's durability point: state and ``cursor`` in one save
        at step id ``gstep``."""
        self.trainer._ckpt.save(self.gstep, self.trainer.state, force=True,
                                cursor=cursor, stamps=self.trainer._ckpt_stamps)

    # -------------------------------------------------------- store side

    def _export_kwargs(self) -> dict[str, Any]:
        cfg = self.config
        state = self.trainer.state
        if self.model_kind == "seq":
            # seq bundles carry no CTR columns; the manifest's seq block is
            # the backbone geometry the scorer rebuilds
            cat_cols: tuple[str, ...] = ()
            cont_cols: tuple[str, ...] = ()
            seq = {"max_len": cfg.max_len, "n_heads": cfg.n_heads,
                   "n_layers": cfg.n_layers}
        else:
            from tdfo_tpu_torch.train.trainer import _ctr_columns

            cat_cols, cont_cols = _ctr_columns(cfg)
            seq = None
        return dict(
            model=cfg.model, embed_dim=cfg.embed_dim, cat_columns=cat_cols,
            cont_columns=cont_cols, size_map=cfg.size_map, step=self.gstep,
            coll=self.trainer.coll, tables=state.tables,
            dense_params=state.backbone, mixed_precision=cfg.mixed_precision,
            platform=self.trainer.device.type, seq=seq)

    def _bootstrap_store(self) -> None:
        """First launch: publish the current state as full bundle v0, so
        every later cycle is a delta on a verified base.  A restart that
        finds a store head skips this."""
        from tdfo_tpu_torch.serve.export import export_bundle
        from tdfo_tpu_torch.serve.swap import _version_name

        if self.store.current_version() is not None:
            return
        v0 = self.chain / _version_name(0)
        if v0.exists():
            shutil.rmtree(v0)  # killed between export and ingest: redo
        export_bundle(v0, version=0, **self._export_kwargs())
        self.store.ingest_full(v0)

    def _publish_state(self, target: int, st: _StageTrace | None = None) -> None:
        """Export the delta from the store head to the CURRENT state and
        publish it as ``target``.  Deterministic and redoable.  ``st``
        gets the export's time as its own part."""
        from tdfo_tpu_torch.serve.export import export_delta
        from tdfo_tpu_torch.serve.swap import _version_name

        _stage("export")
        t0 = _trace.clock()
        delta_dir = self.chain / _version_name(target)
        if delta_dir.exists():
            shutil.rmtree(delta_dir)
        export_delta(delta_dir, self.store.current_dir(), **self._export_kwargs())
        self.last_delta_bytes = _dir_bytes(delta_dir)
        if st is not None:
            st.split("export", t0)
        _stage("publish")
        self.store.apply_delta(delta_dir)  # kill_during_swap fires in here

    def _catch_up(self) -> None:
        """Repair a kill between checkpoint and publish: the checkpoint
        claimed ``target_version`` but the store head is behind it."""
        if self._claimed_version <= int(self.store.current_version() or 0):
            return
        self._publish_state(self._claimed_version)

    def _catch_up_gated(self) -> None:
        """Repair a kill between the gated VERDICT checkpoint and the store
        commit: replay the recorded verdict onto the store.  Identity is
        the verdict's ``(version, digest)``: versions are reused after a
        rollback, so a later cycle's pending canary with the same number
        must not be judged by an old verdict."""
        pc = self._pending_canary
        if not pc:
            return
        verdict = pc.get("verdict")
        if verdict == "promote":
            if int(self.store.current_version() or 0) < int(pc["version"]):
                self.store.promote_canary()
        elif verdict == "rollback":
            ptr = self.store._read_pointer("CANARY")
            if ptr is not None and (ptr["version"], ptr["digest"]) == (
                    int(pc["version"]), pc["digest"]):
                self.store.rollback_canary(
                    str(pc.get("reason") or "auto-rollback (replayed)"))
        # "rejected" never published: nothing to redo

    def _make_batcher(self):
        from tdfo_tpu_torch.serve.frontend import MicroBatcher

        spec = self.config.serving
        scorer = self._build_scorer(self.store.current_dir())
        buckets = ((spec.history_buckets or spec.buckets)
                   if self.model_kind == "seq" else spec.buckets)
        return MicroBatcher(
            scorer.score, buckets=buckets, max_batch=spec.max_batch,
            batch_deadline_ms=spec.batch_deadline_ms,
            logger=self.trainer.logger,
            program_cache_size=scorer.score_cache_size,
            max_queue=spec.max_queue, shed_policy=spec.shed_policy)

    def _build_scorer(self, bundle_dir):
        from tdfo_tpu_torch.serve.export import load_bundle
        from tdfo_tpu_torch.serve.scoring import make_scorer

        return make_scorer(load_bundle(bundle_dir), device=self.trainer.device)

    # --------------------------------------------------------- the cycle

    def _seq_train_batch(self, batch: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Replayed eval windows -> one masked-LM batch: the request's
        ``seqs`` carry the MASK at the last position, and the label sheet
        supervises only that position with the panel's positive (column
        0); every other position is ``PAD_ID`` (ignored by the loss)."""
        from tdfo_tpu_torch.models.bert4rec import PAD_ID

        item = np.asarray(batch["seqs"], np.int32)
        label = np.full_like(item, PAD_ID)
        label[:, -1] = np.asarray(batch["cands"], np.int32)[:, 0]
        return {"item": item, "label": label}

    def _train_cycle(self, batches: list[dict[str, np.ndarray]]) -> float:
        """One step per replay batch through the trainer's own step, then
        the update cache written back (the export reads the tables).
        Returns the last step's loss (one host fetch a cycle)."""
        from tdfo_tpu_torch.data.loader import prefetch_to_device

        if self.model_kind == "seq":
            batches = [self._seq_train_batch(b) for b in batches]
        trainer, loss = self.trainer, None
        for batch in prefetch_to_device(iter(batches), trainer.device):
            trainer.state, loss = trainer._one_step(trainer.state, batch)
            self.gstep += 1
        trainer.flush_cache()
        return float(loss)

    def _replay_batches(self):
        """Up to ``steps_per_cycle`` committed batches and their spans."""
        self.consumer.check_backpressure()
        batches, consumed = [], []
        while len(batches) < self.config.online.steps_per_cycle:
            out = self.consumer.next_batch()
            if out is None:
                break
            batches.append(out[0])
            consumed.extend(out[1])
        return batches, consumed

    def run_cycle(self) -> dict[str, Any] | None:
        """One full serve -> retrain -> swap cycle; ``None`` when the
        durable log holds less than one batch of unread rows."""
        st = _StageTrace(self.cycles)
        cycle_t0 = _trace.clock()
        step_begin = self.gstep
        _stage("replay")
        st.mark("replay")
        batches, consumed = self._replay_batches()
        if not batches:
            return None

        _stage("train")
        st.mark("train")
        loss = self._train_cycle(batches)

        _stage("checkpoint")
        st.mark("checkpoint")
        target = int(self.store.current_version() or 0) + 1
        self._save({"online": True, "global_step": self.gstep,
                    "replay": self.consumer.cursor(), "target_version": target})
        self._claimed_version = target
        _trace.emit(
            "online", "online_cycle", cycle=self.cycles, verdict="published",
            version=target, step_begin=step_begin, step_end=self.gstep,
            dur_ms=round(_trace.elapsed_ms(cycle_t0), 3),
            consumed=[list(span) for span in consumed])
        rec = {
            "event": "online_cycle", "cycle": self.cycles,
            "global_step": self.gstep, "steps": len(batches),
            "loss": loss, "version": target,
            "consumed": [list(span) for span in consumed],
            **self.consumer.counters(),
        }
        self.trainer.logger.log(**rec)

        st.mark("publish")
        self._publish_state(target, st)  # stages: export -> publish

        _stage("swap")
        st.mark("swap")
        if self.fleet is not None:
            self.fleet.sync()  # every replica follows the new CURRENT
        else:
            scorer = self._build_scorer(self.store.current_dir())
            self.batcher.swap(scorer.score, version=target,
                              program_cache_size=scorer.score_cache_size)
        st.close()
        self.cycles += 1
        self.last_stage_ms = dict(st.ms, cycle=_trace.elapsed_ms(cycle_t0))
        return rec

    # --------------------------------------------------- the gated cycle

    def _score_batches(self, scorer, batches: list[dict[str, np.ndarray]]) -> np.ndarray:
        """Score replay batches on a scorer, label-stripped."""
        from tdfo_tpu_torch.serve.frontend import _host_scores

        return np.concatenate([
            _host_scores(scorer.score({k: np.array(v) for k, v in b.items()
                                       if k != "label"}))
            for b in batches])

    def _shadow_auc(self, labels, scores) -> float:
        """The gate metric: labelled rows -> ``binary_auc`` (CTR);
        ``labels is None`` -> ``ranking_auc`` over ``[N, C]`` panels with
        the positive in column 0 (seq)."""
        from tdfo_tpu_torch.train.metrics import binary_auc, ranking_auc

        return ranking_auc(scores) if labels is None else binary_auc(labels, scores)

    def _restore_last_good(self) -> None:
        """Discard the cycle's trained state: reload the last durable one
        (the previous verdict checkpoint, or the gated anchor).  ``gstep``
        is not rewound: checkpoint ids stay monotonic."""
        self.trainer._ckpt.restore(self.trainer.state,
                                   stamps=self.trainer._ckpt_stamps)

    def _corrupt_candidate(self, delta_dir: Path) -> None:
        """The ``corrupt_candidate`` fault: flip one payload byte of the
        on-disk delta (manifest digest left stale), so the gate's
        ``compose_delta`` digest check meets real corruption."""
        from tdfo_tpu_torch.serve.export import read_raw_bundle, write_raw_bundle

        manifest, arrays = read_raw_bundle(delta_dir)
        name = sorted(arrays)[0]
        arr = arrays[name]
        raw = bytearray(arr.tobytes())
        raw[len(raw) // 2] ^= 0xFF
        arrays[name] = np.frombuffer(bytes(raw), dtype=arr.dtype).reshape(arr.shape)
        shutil.rmtree(delta_dir)
        write_raw_bundle(delta_dir, manifest, arrays)

    def _run_cycle_gated(self) -> dict[str, Any] | None:
        """One gatekept cycle (the module note): shadow-gate the candidate,
        canary it on the canary cohort, then promote or roll back, with the
        verdict checkpoint as the single durability point.  ``None``
        (nothing committed) when the log lacks a cycle of train rows plus
        the held-out shadow slice."""
        from tdfo_tpu_torch.serve.export import bundle_from_raw, export_delta
        from tdfo_tpu_torch.serve.scoring import make_scorer
        from tdfo_tpu_torch.serve.swap import CorruptDeltaError, _version_name

        cfg = self.config
        inj = _faults.active()
        cycle_no = self.cycles_done + 1
        st = _StageTrace(cycle_no)
        cycle_t0 = _trace.clock()
        step_begin = self.gstep

        _stage("replay")
        st.mark("replay")
        batches, consumed = self._replay_batches()
        if not batches:
            return None
        # held-out traffic PAST the cursor: it trains in a later cycle
        shadow = self.consumer.peek_batches(cfg.online.shadow_eval_batches)
        if len(shadow) < cfg.online.shadow_eval_batches:
            return None  # no commit: wait until the held-out slice fills
        if self.model_kind == "seq":
            shadow_labels = None
            shadow_feats = {k: np.concatenate([b[k] for b in shadow])
                            for k in shadow[0]}
        else:
            shadow_labels = np.concatenate([b["label"] for b in shadow])
            shadow_feats = {k: np.concatenate([b[k] for b in shadow])
                            for k in shadow[0] if k != "label"}

        _stage("train")
        st.mark("train")
        loss = self._train_cycle(batches)

        _stage("export")
        st.mark("export")
        target = int(self.store.current_version() or 0) + 1
        delta_dir = self.chain / _version_name(target)
        if delta_dir.exists():
            shutil.rmtree(delta_dir)
        export_delta(delta_dir, self.store.current_dir(), **self._export_kwargs())
        if inj is not None and inj.corrupt_candidate_due():
            self._corrupt_candidate(delta_dir)
        try:
            manifest, arrays = self.store.compose_delta(delta_dir)
        except CorruptDeltaError as err:
            # a corrupt candidate never reaches a pointer: re-export from
            # the in-memory state and re-verify; a second failure raises
            self.trainer.logger.log(event="candidate_corrupt", cycle=cycle_no,
                                    version=target, error=str(err))
            shutil.rmtree(delta_dir)
            export_delta(delta_dir, self.store.current_dir(),
                         **self._export_kwargs())
            manifest, arrays = self.store.compose_delta(delta_dir)
        digest = manifest["digest"]
        self.last_delta_bytes = _dir_bytes(delta_dir)

        t_shadow = _trace.clock()  # inside the export span, as the reference's
        candidate = make_scorer(
            bundle_from_raw(manifest, arrays, source=str(delta_dir)),
            device=self.trainer.device)
        incumbent = self._build_scorer(self.store.current_dir())
        auc_cand = self._shadow_auc(shadow_labels,
                                    self._score_batches(candidate, shadow))
        auc_base = self._shadow_auc(shadow_labels,
                                    self._score_batches(incumbent, shadow))
        st.split("shadow", t_shadow)

        verdict, reason = "promote", ""
        canary_auc = stable_auc = None
        canary_p99 = stable_p99 = None
        canary_ms: list[float] = []
        stable_ms: list[float] = []
        if auc_cand < auc_base - cfg.online.max_auc_regression:
            verdict = "rejected"
            reason = (f"shadow gate: candidate AUC {auc_cand:.4f} < "
                      f"incumbent {auc_base:.4f} - "
                      f"{cfg.online.max_auc_regression}")
        else:
            if inj is not None and inj.auc_regress_due(cycle_no):
                # training/serving skew: healthy bytes that serve badly,
                # which only the canary watch can see
                self.fleet.set_score_skew(digest)
            if inj is not None and inj.slow_canary_due(cycle_no):
                self.fleet.set_score_slow(digest)
            _stage("publish")
            st.mark("publish")
            self.store.publish_canary(delta_dir, composed=(manifest, arrays))
            _stage("canary")
            st.mark("canary")
            self.fleet.sync()  # the canary cohort picks the candidate up
            for rnd in range(1, cfg.online.canary_cycles + 1):
                if inj is not None:
                    inj.maybe_kill_canary(rnd)
                self.fleet.mark_canary_watch()
                self.fleet.sync()
                hbs = self.fleet.heartbeat(shadow_feats, shadow_labels)
                for hb in hbs:
                    self.trainer.logger.log(event="canary_heartbeat",
                                            cycle=cycle_no, round=rnd, **hb)
                canaries = [h for h in hbs
                            if h["canary"] and h["version"] == target]
                stables = [h for h in hbs if not h["canary"]]
                if not canaries:
                    verdict, reason = "rollback", "no alive canary replica"
                    break
                canary_ms.extend(h["ms"] for h in canaries)
                stable_ms.extend(h["ms"] for h in stables)
                canary_auc = float(np.mean([h["auc"] for h in canaries]))
                stable_auc = (float(np.mean([h["auc"] for h in stables]))
                              if stables else auc_base)
                if canary_auc < stable_auc - cfg.online.max_auc_regression:
                    verdict = "rollback"
                    reason = (f"canary AUC {canary_auc:.4f} < stable "
                              f"{stable_auc:.4f} - "
                              f"{cfg.online.max_auc_regression} at watch "
                              f"round {rnd}")
                    break
            # the latency term: heartbeat p99s, canary vs stable cohort
            canary_p99 = _percentile(canary_ms, 99)
            stable_p99 = _percentile(stable_ms, 99)
            if (verdict == "promote" and cfg.online.max_p99_regression_ms > 0
                    and canary_p99 is not None and stable_p99 is not None
                    and canary_p99 > stable_p99 + cfg.online.max_p99_regression_ms):
                verdict = "rollback"
                reason = (f"canary p99 {canary_p99:.1f}ms > stable p99 "
                          f"{stable_p99:.1f}ms + "
                          f"{cfg.online.max_p99_regression_ms}ms budget")

        _stage("verdict")
        st.mark("verdict")
        if verdict != "promote":
            self._restore_last_good()
        canary_rec = {"verdict": verdict, "version": target,
                      "digest": digest, "reason": reason}
        self._save({"online": True, "global_step": self.gstep,
                    "cycles_done": cycle_no, "replay": self.consumer.cursor(),
                    "target_version": target if verdict == "promote"
                    else int(self.store.current_version() or 0),
                    "canary": canary_rec})
        self._pending_canary = canary_rec
        # the cycle's span lands right after its durability point: exactly
        # one record per durable cycle in the assembled timeline
        _trace.emit(
            "online", "online_cycle", cycle=cycle_no, verdict=verdict,
            reason=reason, version=target, digest=digest,
            step_begin=step_begin, step_end=self.gstep,
            canary_p99_ms=canary_p99, stable_p99_ms=stable_p99,
            dur_ms=round(_trace.elapsed_ms(cycle_t0), 3),
            consumed=[list(span) for span in consumed])

        _stage("commit")
        st.mark("commit")
        if verdict == "promote":
            self.store.promote_canary()
        elif verdict == "rollback":
            self.store.rollback_canary(reason)

        _stage("swap")
        st.mark("swap")
        self.fleet.sync()  # every replica converges on the verdict's head
        if cfg.online.keep_consumed_segments > 0:
            self.consumer.gc_consumed_segments(cfg.online.keep_consumed_segments)
        st.close()
        self.cycles_done = cycle_no
        self.cycles += 1
        self.last_stage_ms = dict(st.ms, cycle=_trace.elapsed_ms(cycle_t0))
        rec = {
            "event": "online_cycle", "cycle": cycle_no, "gated": True,
            "global_step": self.gstep, "steps": len(batches), "loss": loss,
            "verdict": verdict, "reason": reason, "version": target,
            "shadow_auc": auc_cand, "shadow_auc_base": auc_base,
            "canary_auc": canary_auc, "stable_auc": stable_auc,
            "canary_p99_ms": canary_p99, "stable_p99_ms": stable_p99,
            "consumed": [list(span) for span in consumed],
            **self.consumer.counters(),
        }
        self.trainer.logger.log(**rec)
        return rec

    def run(self) -> dict[str, Any]:
        """Cycle until the log drains or ``max_cycles``; returns run stats.
        The gated loop counts DURABLE cycles (``cycles_done`` rides in the
        verdict checkpoint), so a restarted run finishes the budget.  With
        ``[telemetry] events`` warm-up ends with the first cycle."""
        max_cycles = self.config.online.max_cycles
        while not max_cycles or (self.cycles_done if self.gated
                                 else self.cycles) < max_cycles:
            if (self._run_cycle_gated() if self.gated else self.run_cycle()) is None:
                break
            if self.cycles == 1 and _events.active():
                # every kernel and program of the cycle is built by the end
                # of the first: a later build (a swapped scorer's new
                # programs) is flagged and warned about
                _events.mark_warmup()
        out = {
            "cycles": self.cycles,
            "global_step": self.gstep,
            "version": int(self.store.current_version() or 0),
            "bundle": str(self.store.current_dir()),
            **self.consumer.counters(),
        }
        if self.gated:
            out["cycles_done"] = self.cycles_done
        return out

    def probe(self, requests) -> dict[Any, np.ndarray]:
        """Score a request trace through the live (post-swap) serving side:
        the served-logits fingerprint the kill drills compare.  A fleet
        round-robins it over its alive replicas."""
        if self.fleet is not None:
            return self.fleet.run(requests)
        return self.batcher.run(requests)

    def close(self) -> None:
        """Release the serving side (a process fleet's children and
        sockets) and the trainer's telemetry and sinks."""
        if self.fleet is not None:
            self.fleet.close()
        self.trainer.close_telemetry()
        self.trainer.logger.close()
        self.trainer._ckpt.close()


def _dir_bytes(path: Path) -> int:
    """Bytes of the files under ``path`` (a delta bundle's size)."""
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


def online_from_config(config, *, log_dir: str | Path | None = None,
                       device="cuda") -> dict[str, Any]:
    """The ``python -m tdfo_tpu_torch.launch online`` body."""
    loop = OnlineLoop(config, log_dir=log_dir, device=device)
    try:
        return loop.run()
    finally:
        loop.close()
