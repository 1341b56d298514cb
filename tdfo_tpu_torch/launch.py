"""Entry point: ``python -m tdfo_tpu_torch.launch
{synth,synth-criteo,preprocess-ctr,preprocess-criteo,preprocess-seq,train,
serve,serve-fleet,loadgen,online,obs} --config config.toml [--device cuda|cpu]``.

Port of ``tdfo_tpu/launch.py`` for the ported subcommands:

  * ``synth``          — write a synthetic raw-goodreads fixture;
  * ``synth-criteo``   — write a synthetic Criteo ``train.txt`` fixture;
  * ``preprocess-ctr`` — TwoTower ETL -> parquet shards + size_map.json;
  * ``preprocess-criteo`` — Criteo ETL -> parquet shards + size_map.json
    (the 26 + 13 column schema of ``configs/dlrm-criteo.toml``);
  * ``preprocess-seq`` — Bert4Rec ETL -> parquet_bert4rec/ shards +
    size_map_bert4rec.json;
  * ``train``          — build the Trainer from config and fit.  For
    ``model = "bert4rec"`` the size map is ``size_map_bert4rec.json`` (its
    remapped 1-based item count sizes the MASK token), as in the reference.
  * ``serve``          — restore the newest checkpoint of ``checkpoint_dir``
    (a fresh init without one), export the serving bundle, and run a
    synthetic ragged request trace through the micro-batcher plus one
    retrieval round (``serve/frontend.py``); prints the serving family and
    the stats dict.  ``[serving] replicas > 1`` serves the trace through an
    in-process fleet following a bundle store.
  * ``serve-fleet``    — export a bundle and stand up the out-of-process
    fleet (``[serving] replicas`` ``serve/replica_main.py`` children behind
    the power-of-two-choices ingress), then push the same synthetic trace
    through it; prints the stats dict.
  * ``loadgen``        — the same fleet, driven with zipf traffic
    (``[loadgen]``: closed or open loop) over ``--knee-steps`` doublings of
    the load, to the latency/throughput knee (``serve/loadgen.py``).
  * ``online``         — the serve -> retrain -> delta -> swap supervisor
    (``train/online.py``) over the request log ``[online] request_log``
    names, plain or gated (``canary_cycles > 0``), until the log drains or
    ``max_cycles``; prints the run stats.  Restarting a killed run with the
    same command converges to the uninterrupted run's bundle.
  * ``obs``            — fold the ``[telemetry] trace`` sinks of a finished
    (or killed) run under ``<log_dir or checkpoint_dir>/trace`` into one
    causal report and write ``chrome_trace.json`` beside them (host work
    only, ``obs/aggregate.py``).

``train``, ``serve``, ``serve-fleet``, ``loadgen`` and ``online`` run on the
card (the fleet's replica processes too) unless ``--device cpu`` is given,
and refuse to start when CUDA is asked for and absent.

Several ranks (the reference's ``--distributed``, ``tdfo_tpu/launch.py:80``):
``python -m torch.distributed.run --nproc-per-node N -m tdfo_tpu_torch.launch
{train,serve} --config ... [--device cpu]``.  ``--distributed auto`` (the default)
starts the process group when torchrun's ``WORLD_SIZE`` is above 1,
``always`` also at one rank (the distributed code path on one process),
``never`` not at all; NCCL on the card (one rank per card), gloo on the
CPU, unless ``--backend`` names one (``gloo`` lets several ranks share one
card, which NCCL refuses).  The ``[mesh]`` table lays the ranks out; only rank 0 writes logs,
metrics and checkpoints.  Under ``lookup_mode = "alltoall"``,
``[embeddings] grouped_a2a = true`` runs the grouped exchange and ``[train]
pipeline_overlap = true`` the pipelined step on top of it; int8 storage
runs under a mesh too.  ``serve`` under several ranks shards the retrieval
corpus over the ``data`` axis (``serve/frontend.py``).  The reference's
``plan`` arrives with ``ROADMAP.md`` item 14.
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


def run(argv: list[str] | None = None):
    """``main`` without the exit code: returns the fitted ``Trainer`` (its
    final state included) for ``train``, the stats dict for ``serve``,
    ``serve-fleet`` and ``online``, the knee report for ``loadgen``, the
    assembled report for ``obs``, ``None`` for the other subcommands."""
    p = argparse.ArgumentParser(prog="tdfo_tpu_torch.launch", description=__doc__)
    p.add_argument("command", nargs="?", default="train",
                   choices=["train", "preprocess-ctr", "preprocess-criteo",
                            "preprocess-seq", "synth", "synth-criteo", "serve",
                            "serve-fleet", "loadgen", "online", "obs"])
    p.add_argument("--config", default="config.toml", help="path to config.toml")
    p.add_argument("--data-dir", default=None, help="override config data_dir")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for train and the serving commands "
                        "(default: the card)")
    p.add_argument("--knee-steps", type=int, default=4,
                   help="loadgen: load doublings of the knee sweep")
    p.add_argument("--distributed", default="auto",
                   choices=["auto", "always", "never"],
                   help="start torch.distributed from torchrun's environment: "
                        "auto when WORLD_SIZE > 1 (default), always, or never")
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="process-group backend (default: nccl on the card, "
                        "gloo on the CPU; gloo lets several ranks share a card)")
    args = p.parse_args(argv)

    from tdfo_tpu_torch.core.config import read_configs

    overrides = {}
    if args.data_dir:
        overrides["data_dir"] = args.data_dir
    cfg = read_configs(args.config, **overrides)

    if args.command == "synth":
        from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

        write_synthetic_goodreads(cfg.data_dir)
        print(f"synthetic goodreads raw files written to {cfg.data_dir}")
        return None
    if args.command == "synth-criteo":
        from tdfo_tpu_torch.data.synthetic import write_synthetic_criteo

        write_synthetic_criteo(cfg.data_dir)
        print(f"synthetic criteo train.txt written to {cfg.data_dir}")
        return None
    if args.command == "preprocess-criteo":
        from tdfo_tpu_torch.data.criteo_preprocessing import (
            run_criteo_preprocessing,
        )

        size_map = run_criteo_preprocessing(
            cfg.data_dir, seed=cfg.seed, hot_vocab=cfg.embeddings.hot_vocab,
            hot_fraction=cfg.embeddings.hot_fraction)
        print(f"size_map: {{{len(size_map)} tables, "
              f"max vocab {max(size_map.values())}}}")
        return None
    if args.command == "preprocess-ctr":
        from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing

        size_map = run_ctr_preprocessing(
            cfg.data_dir, seed=cfg.seed, write_format=cfg.write_format,
            hot_vocab=cfg.embeddings.hot_vocab,
            hot_fraction=cfg.embeddings.hot_fraction,
        )
        print(f"size_map: {size_map}")
        return None
    if args.command == "obs":
        import json
        from pathlib import Path

        from tdfo_tpu_torch.obs.aggregate import (
            assemble,
            chrome_trace,
            format_report,
            load_spans,
        )

        out_dir = args.log_dir or cfg.checkpoint_dir
        if not out_dir:
            raise SystemExit(
                "obs needs the traced run's output dir — set checkpoint_dir "
                "in the config or pass --log-dir")
        trace_dir = Path(out_dir) / "trace"
        spans = load_spans(trace_dir)
        if not spans:
            raise SystemExit(
                f"no trace-*.jsonl spans under {trace_dir} — run with "
                "[telemetry] trace = true first")
        report = assemble(spans)
        print(format_report(report))
        chrome_path = trace_dir / "chrome_trace.json"
        chrome_path.write_text(json.dumps(chrome_trace(spans)))
        print(f"chrome trace written to {chrome_path} "
              "(load in chrome://tracing or ui.perfetto.dev)")
        return report
    if args.command == "preprocess-seq":
        from tdfo_tpu_torch.data.seq_preprocessing import run_seq_preprocessing

        stats = run_seq_preprocessing(
            cfg.data_dir, max_len=cfg.max_len, sliding_step=cfg.sliding_step,
            mask_prob=cfg.mask_prob, seed=cfg.seed, pad=not cfg.jagged)
        print(f"seq preprocessing: {stats}")
        return None

    if cfg.model == "bert4rec":
        # the CTR size_map.json that read_configs merges counts the full
        # catalogue and would mis-size the MASK token
        import json
        from pathlib import Path

        alt = Path(cfg.data_dir) / "size_map_bert4rec.json"
        if alt.exists():
            cfg = cfg.replace(size_map=json.loads(alt.read_text()))

    if cfg.faults.any():
        # a run that dies with exit 17 must show why
        print(f"WARNING: fault injection armed: {cfg.faults}", flush=True)
    if args.command in ("serve", "serve-fleet", "loadgen", "online"):
        from tdfo_tpu_torch.core.config import serving_model_kind

        try:
            kind = serving_model_kind(cfg)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    if args.command == "online":
        from tdfo_tpu_torch.train.online import online_from_config

        print(f"online: model {cfg.model!r} -> {kind} serving family", flush=True)
        out = online_from_config(cfg, log_dir=args.log_dir, device=args.device)
        print({k: round(v, 5) if isinstance(v, float) else v
               for k, v in out.items()})
        return out
    if args.command == "serve-fleet":
        from tdfo_tpu_torch.serve.loadgen import serve_fleet_from_config

        print(f"serve-fleet: model {cfg.model!r} -> {kind} serving family",
              flush=True)
        out = serve_fleet_from_config(cfg, log_dir=args.log_dir,
                                      device=args.device)
        print({k: round(v, 5) if isinstance(v, float) else v
               for k, v in out.items()})
        return out
    if args.command == "loadgen":
        from tdfo_tpu_torch.serve.loadgen import loadgen_from_config

        print(f"loadgen: model {cfg.model!r} -> {kind} serving family",
              flush=True)
        out = loadgen_from_config(cfg, log_dir=args.log_dir,
                                  knee_steps=args.knee_steps, device=args.device)
        for s in out["steps"]:
            axis = (f"conc={s['concurrency']}" if s["mode"] == "closed"
                    else f"rate={s['offered_qps']:.1f}qps")
            p99 = "-" if s["p99_ms"] is None else f"{s['p99_ms']:.2f}ms"
            print(f"loadgen {s['mode']} {axis}: "
                  f"qps={s['achieved_qps']:.1f} p99={p99} "
                  f"shed={s['shed']} failed={s['failed']} "
                  f"slo_ok={s['slo_ok']}")
        knee = out["knee"]
        print("knee: none (no step met the p99 SLO)" if knee is None else
              f"knee: qps={knee['achieved_qps']:.1f} at p99="
              f"{knee['p99_ms']:.2f}ms (SLO {knee['p99_slo_ms']} ms)")
        return out

    import os

    import torch.distributed as dist

    started = False
    if not dist.is_initialized() and (args.distributed == "always" or (
            args.distributed == "auto" and int(os.environ.get("WORLD_SIZE", "1")) > 1)):
        from tdfo_tpu_torch.core.mesh import initialize_distributed

        started = initialize_distributed(args.device, backend=args.backend,
                                         force=True)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if args.command == "serve":
        from tdfo_tpu_torch.serve.frontend import serve_from_config

        if rank0:
            print(f"serve: model {cfg.model!r} -> {kind} serving family", flush=True)
        out = serve_from_config(cfg, log_dir=args.log_dir, device=args.device)
        if rank0:
            print({k: round(v, 5) if isinstance(v, float) else v
                   for k, v in out.items()})
    else:
        from tdfo_tpu_torch.train.trainer import Trainer

        out = Trainer(cfg, log_dir=args.log_dir, device=args.device)
        metrics = out.fit()
        if rank0:
            print({k: round(v, 5) for k, v in metrics.items()})
    if started:  # every rank done, then the group's teardown
        dist.barrier()
        dist.destroy_process_group()
    return out


if __name__ == "__main__":
    sys.exit(main())
