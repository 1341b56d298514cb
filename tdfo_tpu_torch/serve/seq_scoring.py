"""Sequence scoring from a ``model = "bert4rec"`` bundle — port of
``tdfo_tpu/serve/seq_scoring.py`` (``SeqScorer``, ``make_seq_scorer``,
``history_window``, ``item_corpus``).

The serving forward is the trainer's seq eval forward re-pointed at the
bundle: the item lookup over the merged ``item_embedding`` table, the
``Bert4RecBackbone`` rebuilt from the manifest's ``seq`` hyperparameters
with full attention (as the reference's scorer builds it), and the
appended-MASK (last) position.  ``out_proj`` is applied to the
last-position hidden state ``[B, d]`` only, so the ``[B, T, V]`` logits
cube is never built (420 GB at B = 8192, T = 64, V = 200,001); the
``[B, V]`` row is, and the candidates are taken from it.

Requests carry ``seqs [B, max_len]`` eval windows (:func:`history_window`)
and ``cands [B, C]`` candidate ids.  Next-item retrieval searches the
output head (``out_proj`` is untied from the item table): the corpus row of
item ``v`` is ``[W_out[:, v]; b_out[v]]`` and the query is ``[h, 1]``
(:meth:`SeqScorer.query_embed`), so every inner product is the served
logit.  Bert4Rec computes in f32 in both packages' trainers; a bf16 bundle
(the reference's TPU cast policy) refuses here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.interop import backbone_params_from_flax, to_numpy
from tdfo_tpu_torch.models.bert4rec import (
    PAD_ID,
    Bert4RecBackbone,
    Bert4RecConfig,
    key_padding_mask,
)
from tdfo_tpu_torch.ops.quant import STORAGE_DTYPES
from tdfo_tpu_torch.serve.corpus import Corpus, corpus_from_rows
from tdfo_tpu_torch.serve.export import ServingBundle
from tdfo_tpu_torch.serve.scoring import CountedScore, to_device_batch

__all__ = ["SeqScorer", "history_window", "item_corpus", "make_seq_scorer"]

# the seq request schema: the columns score() consumes
SEQ_FEATURES = ("seqs", "cands")


@dataclass
class SeqScorer:
    """Serving functions bound to one Bert4Rec bundle on one device.
    ``score(batch) -> [B, C] f32`` ranks ``cands`` at the appended-MASK
    position; ``query_embed(batch) -> [B, D+1] f32`` is ``[h, 1]``, the
    query against :func:`item_corpus`.  ``cont_columns`` is empty."""

    model: str
    embed_dim: int
    max_len: int
    n_items: int
    features: tuple[str, ...]
    cont_columns: tuple[str, ...]
    device: torch.device
    _score: CountedScore = field(repr=False)
    _last_hidden: Callable = field(repr=False)

    @property
    def mask_id(self) -> int:
        return self.n_items + 1

    def score(self, batch: Mapping) -> torch.Tensor:
        return self._score(batch)

    def query_embed(self, batch: Mapping) -> torch.Tensor:
        batch = to_device_batch(batch, self.device)
        with torch.no_grad():
            h = self._last_hidden(batch["seqs"]).to(torch.float32)
            return torch.cat([h, torch.ones_like(h[:, :1])], dim=1)

    def score_cache_size(self) -> int:
        """Distinct batch signatures scored so far (one per padded shape)."""
        return len(self._score.signatures)


def _check_seq_bundle(bundle: ServingBundle) -> tuple[int, dict]:
    """The reference's schema refusals: wrong family, missing seq
    hyperparameters, vocab drift."""
    if bundle.model != "bert4rec":
        raise ValueError(
            f"seq scorer got a {bundle.model!r} bundle — the CTR family "
            "(twotower/dlrm) is served by serve.scoring.make_scorer")
    if bundle.kind != "sparse":
        raise ValueError(
            "bert4rec bundles are sparse (item table + dense backbone split, "
            f"the DMP regime), got kind={bundle.kind!r}")
    seq = bundle.seq
    if not seq:
        raise ValueError(
            "bundle carries no seq hyperparameters — re-export with "
            "export_bundle(..., seq={'max_len': ..., 'n_heads': ..., "
            "'n_layers': ...}); a bundle without them cannot rebuild the "
            "backbone geometry")
    missing = [k for k in ("max_len", "n_heads", "n_layers") if k not in seq]
    if missing:
        raise ValueError(f"bundle seq hyperparameters missing {missing}")
    n_items = int(bundle.size_map.get("n_items", bundle.size_map.get("item", 0)))
    if not n_items:
        raise ValueError("bert4rec bundle needs n_items in size_map")
    if set(bundle.tables) != {"item_embedding"}:
        raise ValueError(
            f"bundle tables {sorted(bundle.tables)} do not match the "
            "bert4rec schema ['item_embedding'] — wrong bundle for this "
            "model/config")
    vocab = n_items + 2  # PAD(0) + items(1..n) + MASK(n+1)
    rows, dim = bundle.tables["item_embedding"].shape
    if rows != vocab or dim != bundle.embed_dim:
        raise ValueError(
            f"item_embedding is [{rows}, {dim}] but size_map says n_items="
            f"{n_items} (vocab {vocab}) at embed_dim {bundle.embed_dim} — "
            "vocab drift; the bundle and the catalog disagree")
    return n_items, dict(seq)


def make_seq_scorer(bundle: ServingBundle, *, mesh=None, device="cuda") -> SeqScorer:
    """Bundle -> :class:`SeqScorer` on ``device`` (under a ``mesh`` the
    parameters replicate: every rank scores its requests alone)."""
    from tdfo_tpu_torch.parallel.embedding import (
        EmbeddingSpec,
        ShardedEmbeddingCollection,
    )

    device = resolve_device(device)
    n_items, seq = _check_seq_bundle(bundle)
    if bundle.torch_dtype != torch.float32:
        raise NotImplementedError(
            f"a {bundle.dtype} Bert4Rec bundle computes in {bundle.dtype}; "
            "the port's Bert4Rec backbone computes in f32 only (both "
            "packages' trainers do): re-export without mixed_precision")
    cfg = Bert4RecConfig(n_items=n_items, max_len=int(seq["max_len"]),
                         embed_dim=bundle.embed_dim, n_heads=int(seq["n_heads"]),
                         n_layers=int(seq["n_layers"]))
    # replicated + unfused: the one logical table is its own [V, d] array
    coll = ShardedEmbeddingCollection([EmbeddingSpec(
        "item_embedding", num_embeddings=cfg.vocab_size,
        embedding_dim=cfg.embed_dim, features=("item",),
        sharding="replicated", init_scale=1.0)])
    backbone = Bert4RecBackbone(cfg)  # full attention, as the reference's
    backbone.load_state_dict(backbone_params_from_flax(bundle.dense_params),
                             strict=True)
    backbone = backbone.to(device).eval()
    tables = {k: v.to(device) for k, v in bundle.tables.items()}

    def last_hidden(seqs):
        # the last block's output at the appended-MASK (last) position
        embs = coll.lookup(tables, {"item": seqs})
        return backbone.hidden(embs["item"], key_padding_mask(seqs))[:, -1, :]

    def score(batch):
        # out_proj on the [B, d] last position only: [B, V], then the panel
        logits = backbone.out_proj(last_hidden(batch["seqs"]))
        return torch.gather(logits, 1, batch["cands"].to(torch.int64))

    return SeqScorer(
        model=bundle.model, embed_dim=bundle.embed_dim, max_len=cfg.max_len,
        n_items=n_items, features=SEQ_FEATURES, cont_columns=(), device=device,
        _score=CountedScore(score, device), _last_hidden=last_hidden)


def history_window(history: Sequence[int], *, n_items: int, max_len: int,
                   max_history: int = 0) -> np.ndarray:
    """Ragged user history -> the fixed ``[max_len]`` eval window: keep the
    newest ``max_len - 1`` items (``max_history`` caps them; 0 = the full
    window), append MASK, left-pad with ``PAD_ID``."""
    keep = max_len - 1
    if max_history > 0:
        keep = min(max_history, keep)
    hist = np.asarray(list(history), dtype=np.int64).reshape(-1)
    if hist.size and (hist.min() < 1 or hist.max() > n_items):
        bad = hist[(hist < 1) | (hist > n_items)]
        raise ValueError(
            f"history item id {int(bad[0])} outside the catalog [1, "
            f"{n_items}] — PAD({PAD_ID}) and MASK({n_items + 1}) are "
            "reserved ids, not items")
    tail = np.concatenate(
        [hist[-keep:] if keep else hist[:0], [n_items + 1]]).astype(np.int32)
    out = np.full((max_len,), PAD_ID, np.int32)
    out[-len(tail):] = tail
    return out


def item_corpus(bundle: ServingBundle, *, mesh=None, device="cuda",
                dtype: str = "float32") -> Corpus:
    """The bundle's output head as a retrieval corpus: row ``v`` is
    ``[W_out[:, v]; b_out[v]]`` for the catalogue items ``v = 1..n_items``
    (PAD and MASK are never candidates), ids the 1-based item ids; stored
    at ``dtype`` like ``build_corpus``, and under a ``mesh`` this rank's
    shard over its data axis, padded as ``build_corpus`` pads."""
    if dtype not in STORAGE_DTYPES:
        raise ValueError(f"corpus dtype {dtype!r} not in {STORAGE_DTYPES}")
    device = resolve_device(device)
    n_items, _ = _check_seq_bundle(bundle)
    op = (bundle.dense_params or {}).get("out_proj")
    if not isinstance(op, Mapping) or "kernel" not in op or "bias" not in op:
        raise ValueError(
            "bundle dense params carry no out_proj kernel/bias — the "
            "retrieval corpus is the output head (out_proj is untied from "
            "the item table), so a headless bundle cannot retrieve")
    kernel = to_numpy(op["kernel"]).astype(np.float32)  # [d, V]
    bias = to_numpy(op["bias"]).astype(np.float32)  # [V]
    vocab = n_items + 2
    if kernel.shape != (bundle.embed_dim, vocab) or bias.shape != (vocab,):
        raise ValueError(
            f"out_proj geometry kernel{kernel.shape} bias{bias.shape} does "
            f"not match embed_dim {bundle.embed_dim} x vocab {vocab} — "
            "head drift; the bundle and the catalog disagree")
    head = np.concatenate([kernel.T, bias[:, None]], axis=1)  # [V, d+1]
    vectors = torch.from_numpy(np.ascontiguousarray(head[1:n_items + 1]))
    ids = torch.arange(1, n_items + 1, dtype=torch.int32)
    return corpus_from_rows(vectors, ids, dtype, mesh=mesh, device=device)
