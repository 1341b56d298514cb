"""CTR scoring from a serving bundle — port of ``tdfo_tpu/serve/scoring.py``
(``Scorer``, ``make_scorer``, ``_dense_scorer``, ``_sparse_scorer``).

The serving forward is the training eval forward re-pointed at the
bundle: for the DMP regime the ``ShardedEmbeddingCollection`` lookup over
the merged tables (replicated, unfused, unstacked: each logical table is
its own ``[V, d]`` array under its own name) and the backbone
(``TwoTowerBackbone`` or ``DLRMBackbone``); for the dense regime the
``TwoTower`` module.  The compute dtype is the bundle's
(``ServingBundle.torch_dtype``: bf16 for a bf16 bundle, else f32).

``score_cache_size`` counts the distinct batch signatures (column shapes
and dtypes) the scoring function has run: the reference's jit-cache count,
one program per padded batch shape, which the micro-batcher holds to at
most ``len(buckets)``; each new one is an ``obs/events.py`` build event.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np
import torch

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.interop import backbone_params_from_flax, dense_params_from_flax
from tdfo_tpu_torch.models.twotower import (
    FEATURE_TO_INPUT,
    TWOTOWER_CATEGORICAL,
    TWOTOWER_CONTINUOUS,
    TWOTOWER_ITEM_CATEGORICAL,
)
from tdfo_tpu_torch.obs import events as _events
from tdfo_tpu_torch.obs import trace as _trace
from tdfo_tpu_torch.serve.export import ServingBundle

__all__ = ["CountedScore", "Scorer", "make_scorer", "to_device_batch"]


def to_device_batch(batch: Mapping, device: torch.device) -> dict[str, torch.Tensor]:
    """Request columns (numpy arrays or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor)
                               else v).to(device)
            for k, v in batch.items()}


class CountedScore:
    """A scoring function that records the batch signatures it has run."""

    def __init__(self, fn: Callable, device: torch.device):
        self._fn = fn
        self._device = device
        self.signatures: set = set()

    def __call__(self, batch: Mapping) -> torch.Tensor:
        batch = to_device_batch(batch, self._device)
        sig = tuple(sorted(
            (k, tuple(v.shape), str(v.dtype)) for k, v in batch.items()))
        new = sig not in self.signatures
        self.signatures.add(sig)
        t0 = _trace.clock() if new else None
        with torch.no_grad():
            out = self._fn(batch)
        if new:  # a new serving program (obs/events.py)
            _events.compiled("serving_program:" + ",".join(
                f"{k}{list(s)}" for k, s, _ in sig), _trace.elapsed_s(t0))
        return out


@dataclass
class Scorer:
    """Serving functions bound to one bundle's parameters on one device.

    ``score(batch) -> [B] logits`` is the CTR request path;
    ``user_embed`` / ``item_embed`` map a batch to its tower vectors (the
    retrieval query and corpus halves; TwoTower only, ``None`` for DLRM,
    whose interaction head does not factorize).  Outputs are tensors on
    the scorer's device."""

    model: str
    embed_dim: int
    cont_columns: tuple[str, ...]
    features: tuple[str, ...]  # categorical input columns score() consumes
    device: torch.device
    _score: CountedScore = field(repr=False)
    _user: Callable | None = field(repr=False, default=None)
    _item: Callable | None = field(repr=False, default=None)

    def score(self, batch: Mapping) -> torch.Tensor:
        return self._score(batch)

    def _tower(self, fn, batch, what):
        if fn is None:
            raise ValueError(f"{self.model!r} has no {what} tower")
        with torch.no_grad():
            return fn(to_device_batch(batch, self.device))

    def user_embed(self, batch: Mapping) -> torch.Tensor:
        return self._tower(self._user, batch, "user")

    def item_embed(self, batch: Mapping) -> torch.Tensor:
        return self._tower(self._item, batch, "item")

    def score_cache_size(self) -> int:
        """Distinct batch signatures scored so far (one per padded batch
        shape): the micro-batcher's bounded-program check."""
        return len(self._score.signatures)


def make_scorer(bundle: ServingBundle, *, mesh=None, device="cuda"):
    """Bundle -> :class:`Scorer` on ``device`` (the card unless the caller
    asks for the CPU).  Bert4Rec bundles go to
    ``serve/seq_scoring.py::make_seq_scorer``, so callers serve either
    family through one function.  Under a ``mesh`` every rank holds the
    whole parameters (replicated, as the reference places them) and scores
    its requests alone: the scorer runs no collective."""
    device = resolve_device(device)
    if bundle.model == "bert4rec":
        from tdfo_tpu_torch.serve.seq_scoring import make_seq_scorer

        return make_seq_scorer(bundle, mesh=mesh, device=device)
    if bundle.kind == "dense":
        return _dense_scorer(bundle, device)
    return _sparse_scorer(bundle, device)


def _dense_scorer(bundle: ServingBundle, device: torch.device) -> Scorer:
    from tdfo_tpu_torch.models.twotower import TwoTower

    model = TwoTower(dict(bundle.size_map), bundle.embed_dim,
                     dtype=bundle.torch_dtype)
    model.load_state_dict(dense_params_from_flax(bundle.params), strict=True)
    model = model.to(device).eval()
    return Scorer(
        model=bundle.model, embed_dim=bundle.embed_dim,
        cont_columns=tuple(TWOTOWER_CONTINUOUS),
        features=tuple(FEATURE_TO_INPUT[f] for f in TWOTOWER_CATEGORICAL),
        device=device, _score=CountedScore(model, device),
        _user=model.user_embeddings, _item=model.item_embeddings)


def _sparse_scorer(bundle: ServingBundle, device: torch.device) -> Scorer:
    from tdfo_tpu_torch.models.dlrm import DLRMBackbone, generic_embedding_specs
    from tdfo_tpu_torch.models.twotower import TwoTowerBackbone, ctr_embedding_specs
    from tdfo_tpu_torch.parallel.embedding import ShardedEmbeddingCollection

    dtype = bundle.torch_dtype
    twotower_names = {f"{f}_embed" for f in TWOTOWER_CATEGORICAL}
    if set(bundle.tables) == twotower_names:
        specs = ctr_embedding_specs(bundle.size_map, bundle.embed_dim,
                                    sharding="replicated", fused_threshold=None)
    else:
        specs = generic_embedding_specs(bundle.size_map, bundle.cat_columns,
                                        bundle.embed_dim, sharding="replicated",
                                        fused_threshold=None)
    # replicated + unfused + unstacked: every logical table keeps its own
    # [V, d] array under its own name, the merged-bundle layout
    coll = ShardedEmbeddingCollection(specs)
    if set(bundle.tables) != set(coll.specs):
        raise ValueError(
            f"bundle tables {sorted(bundle.tables)} do not match the "
            f"{bundle.model!r} schema {sorted(coll.specs)} — wrong bundle "
            "for this model/config")
    tables = {k: v.to(device) for k, v in bundle.tables.items()}
    features = tuple(coll.features())
    if bundle.model == "dlrm":
        backbone = DLRMBackbone(bundle.embed_dim,
                                cat_columns=tuple(bundle.cat_columns),
                                cont_columns=tuple(bundle.cont_columns),
                                dtype=dtype)
    else:
        backbone = TwoTowerBackbone(bundle.embed_dim, dtype=dtype)
    backbone.load_state_dict(backbone_params_from_flax(bundle.dense_params),
                             strict=True)
    backbone = backbone.to(device).eval()

    def score(batch):
        embs = coll.lookup(tables, {f: batch[f] for f in features})
        return backbone(embs, batch)

    user = item = None
    if bundle.model == "twotower":
        item_cols = tuple(FEATURE_TO_INPUT[f] for f in TWOTOWER_ITEM_CATEGORICAL)

        def user(batch):
            embs = coll.lookup(tables, {"user_id": batch["user_id"]})
            return backbone.user_tower(embs["user_id"].to(dtype))

        def item(batch):
            embs = coll.lookup(tables, {c: batch[c] for c in item_cols})
            parts = [embs[c].to(dtype) for c in item_cols]
            parts += [batch[c].to(dtype)[:, None] for c in TWOTOWER_CONTINUOUS]
            return backbone.item_tower(torch.cat(parts, dim=-1))

    return Scorer(
        model=bundle.model, embed_dim=bundle.embed_dim,
        cont_columns=tuple(bundle.cont_columns), features=features,
        device=device, _score=CountedScore(score, device), _user=user, _item=item)
