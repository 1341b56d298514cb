"""Entry point: ``python -m tdfo_tpu_torch.launch
{synth,synth-criteo,preprocess-ctr,preprocess-criteo,preprocess-seq,train}
--config config.toml [--device cuda|cpu]``.

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

``train`` runs on the card unless ``--device cpu`` is given, and refuses to
start when CUDA is asked for and absent.  The other subcommands of the
reference (serve, online, plan, ...) arrive with their slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import argparse
import sys


def main(argv: list[str] | None = None) -> int:
    run(argv)
    return 0


def run(argv: list[str] | None = None):
    """``main`` without the exit code: returns the fitted ``Trainer`` (its
    final state included) for ``train``, ``None`` for the other
    subcommands."""
    p = argparse.ArgumentParser(prog="tdfo_tpu_torch.launch", description=__doc__)
    p.add_argument("command", nargs="?", default="train",
                   choices=["train", "preprocess-ctr", "preprocess-criteo",
                            "preprocess-seq", "synth", "synth-criteo"])
    p.add_argument("--config", default="config.toml", help="path to config.toml")
    p.add_argument("--data-dir", default=None, help="override config data_dir")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="device for train (default: the card)")
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

    from tdfo_tpu_torch.train.trainer import Trainer

    trainer = Trainer(cfg, log_dir=args.log_dir, device=args.device)
    metrics = trainer.fit()
    print({k: round(v, 5) for k, v in metrics.items()})
    return trainer


if __name__ == "__main__":
    sys.exit(main())
