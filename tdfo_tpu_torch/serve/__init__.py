"""Serving — port of ``tdfo_tpu/serve/``.  Offline to online:

* :mod:`~tdfo_tpu_torch.serve.export` — train state -> serving bundle on
  disk (byte-compatible with the reference's), delta bundles and their
  composition, and the corpus store;
* :mod:`~tdfo_tpu_torch.serve.scoring` — bundle -> CTR scorer (TwoTower,
  dense or DMP, and DLRM);
* :mod:`~tdfo_tpu_torch.serve.seq_scoring` — bundle -> Bert4Rec scorer at
  the appended-MASK position, and its output-head corpus;
* :mod:`~tdfo_tpu_torch.serve.corpus` — the item-tower sweep into a
  float32, bfloat16 or int8 corpus;
* :mod:`~tdfo_tpu_torch.serve.retrieval` — exact and int8 two-stage top-k
  MIPS, ties to the lower id;
* :mod:`~tdfo_tpu_torch.serve.frontend` — the micro-batcher and
  ``launch.py serve``;
* :mod:`~tdfo_tpu_torch.serve.swap` — the crash-safe bundle store
  (delta swaps, canary pointers, recovery, retention);
* :mod:`~tdfo_tpu_torch.serve.fleet` — replicas following one store in
  one process;
* :mod:`~tdfo_tpu_torch.serve.wire`, :mod:`~tdfo_tpu_torch.serve.ingress`,
  :mod:`~tdfo_tpu_torch.serve.supervisor` and
  :mod:`~tdfo_tpu_torch.serve.replica_main` — the fleet as replica
  processes behind a power-of-two-choices ingress;
* :mod:`~tdfo_tpu_torch.serve.loadgen` — zipf load and the knee, and the
  ``launch.py serve-fleet`` / ``loadgen`` bodies.
"""

from tdfo_tpu_torch.serve.corpus import Corpus, build_corpus, synthetic_item_features
from tdfo_tpu_torch.serve.export import (
    BUNDLE_VERSION,
    QSCALE_LAYOUT,
    ServingBundle,
    apply_delta_arrays,
    bundle_digest,
    export_bundle,
    export_corpus,
    export_delta,
    load_bundle,
    load_corpus,
    merged_tables,
)
from tdfo_tpu_torch.serve.fleet import ReplicaFrontend, ServingFleet
from tdfo_tpu_torch.serve.frontend import MicroBatcher, serve_from_config
from tdfo_tpu_torch.serve.retrieval import make_retrieval, mips_scores, retrieval_reference
from tdfo_tpu_torch.serve.scoring import make_scorer
from tdfo_tpu_torch.serve.swap import BundleStore

__all__ = [
    "BUNDLE_VERSION",
    "BundleStore",
    "Corpus",
    "MicroBatcher",
    "QSCALE_LAYOUT",
    "ReplicaFrontend",
    "ServingBundle",
    "ServingFleet",
    "apply_delta_arrays",
    "build_corpus",
    "bundle_digest",
    "export_bundle",
    "export_corpus",
    "export_delta",
    "load_bundle",
    "load_corpus",
    "make_retrieval",
    "make_scorer",
    "merged_tables",
    "mips_scores",
    "retrieval_reference",
    "serve_from_config",
    "synthetic_item_features",
]
