"""Top-k maximum-inner-product retrieval over a corpus — port of
``tdfo_tpu/serve/retrieval.py`` (``mips_scores``, ``_masked_top_k``,
``_coarse_scores``, ``_gather_dequant``, ``_rerank_scores``,
``make_retrieval``, ``retrieval_reference``), on one device or over a
corpus sharded across the ``data`` axis of a mesh.

* :func:`mips_scores` is the serving score formula: operands rounded to
  bf16, products and sums in f32 (the reference's bf16 ``dot_general``
  with ``preferred_element_type=f32``; a product of two bf16 values is
  exact in f32, so the f32 matmul of the rounded operands computes the
  same function).
* Ties go to the lower corpus position, as ``jax.lax.top_k`` resolves
  them (``torch.topk`` promises no order among equal values): the top-k
  runs on an int64 key holding the score's order-preserving bits above
  the reversed position, so every key is distinct and the largest keys
  are the highest scores, lower positions first.  Padding rows (id -1)
  score ``-inf`` and are never returned.
* Exact program (``coarse_k = 0``): one scan of the whole corpus (an int8
  corpus decoded first).  Two-stage program (``coarse_k >= top_k``, the
  ScaNN split for int8 corpora): a coarse scan of the STORED rows (int8:
  ``scale * dot(q, codes) + sum(q) * offset``, no f32 corpus built), the
  top ``coarse_k`` positions sorted ascending, their rows gathered and
  decoded, and an exact re-rank picks ``top_k``.  ``coarse_k >= n_items``
  runs the exact program (the coarse stage could drop nothing).
* Queries run in chunks that keep each ``[chunk, N]`` score block near
  ``2**27`` elements, so a batch of 8,192 queries against 200,000 items
  does not hold a 6.5 GB score matrix.

Over a sharded corpus (``serve/corpus.py``; S ranks, one process each,
every rank holding the same queries) the programs are the reference's:

* exact: each shard's top ``k_local = min(top_k, rows_per_shard)``, the
  ``[B, k_local]`` blocks all-gathered and concatenated shard-major, then
  one top-k over them: equal scores keep the lower shard, then the lower
  position, so ties go to the lower global position as on one device;
* two-stage: each shard's coarse top ``k_local`` as GLOBAL positions,
  merged shard-major to ``n_cand = min(coarse_k, k_local * S)`` sorted
  ascending; each candidate row is gathered and decoded by its owner,
  every other rank adding -0.0 (ids: 0), so the sum over the axis is the
  owner's bits; then the exact re-rank on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch

from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_group, axis_size
from tdfo_tpu_torch.ops.quant import dequantize_rows
from tdfo_tpu_torch.parallel.collectives import all_gather_cat, all_reduce_
from tdfo_tpu_torch.serve.corpus import Corpus

__all__ = ["make_retrieval", "mips_scores", "retrieval_reference", "top_k_ordered"]

_CHUNK_ELEMENTS = 1 << 27  # score elements per query chunk


def _bf16_f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def mips_scores(queries: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
    """``[B, D] x [N, D] -> [B, N]`` f32 inner products of bf16-rounded
    operands (int8 codes are exact in bf16)."""
    return _bf16_f32(queries) @ _bf16_f32(vectors).T


def top_k_ordered(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` along the last axis: the ``k`` largest values in
    descending order, equal values lower position first.  Returns
    ``(values, positions)``."""
    s = (scores + 0.0).contiguous()  # -0.0 ranks as +0.0
    bits = s.view(torch.int32).to(torch.int64)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)  # monotone in s
    n = s.shape[-1]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=s.device)
    _, pos = torch.topk(key * (1 << 32) + rev, k, dim=-1)
    return torch.gather(scores, -1, pos), pos


def _masked_top_k(scores, ids, k: int):
    """Top-k over one corpus block, padding rows (id -1) at -inf."""
    scores = torch.where(ids >= 0, scores, float("-inf"))
    s, pos = top_k_ordered(scores, k)
    return s, ids[pos]


def _coarse_scores(queries, vectors_b, qscale):
    """Scores against the STORED rows (``vectors_b``: already rounded to
    bf16 and widened): exact for float rows; int8 rows via ``scale *
    dot(q, codes) + sum(q) * offset``."""
    q = _bf16_f32(queries)
    raw = q @ vectors_b.T
    if qscale is None:
        return raw
    qsum = q.sum(dim=1)
    return raw * qscale[None, :, 0] + qsum[:, None] * qscale[None, :, 1]


def _gather_dequant(vectors, qscale, flat_pos):
    """Full-row gather of candidate rows, decoded to f32."""
    rows = vectors[flat_pos]
    if qscale is None:
        return rows.to(torch.float32)
    return dequantize_rows(rows, qscale[flat_pos])


def _rerank_scores(queries, cand):
    """Exact re-rank ``[B, D] x [B, m, D] -> [B, m]`` (the
    :func:`mips_scores` formula per query)."""
    return torch.bmm(_bf16_f32(cand), _bf16_f32(queries)[:, :, None])[..., 0]


def _chunks(queries: torch.Tensor, n: int):
    step = max(1, _CHUNK_ELEMENTS // max(n, 1))
    return queries.split(step, dim=0)


def make_retrieval(corpus: Corpus, *, mesh=None, top_k: int = 100,
                   coarse_k: int = 0) -> Callable:
    """``retrieve(queries [B, D]) -> (scores [B, k] f32, ids [B, k] int32)``
    over ``corpus``, candidates in descending score order.  ``coarse_k`` = 0
    runs the exact scan; ``coarse_k >= top_k`` the two-stage program.
    ``mesh``: the mesh ``corpus`` is sharded over (every rank calls
    ``retrieve`` with the same queries and gets the whole result)."""
    n_shards = axis_size(mesh, DATA_AXIS)
    if corpus.n_shards != n_shards:
        raise ValueError(
            f"the corpus is sharded {corpus.n_shards} ways and the mesh's "
            f"data axis has {n_shards} ranks: build or load it for this mesh")
    if top_k < 1:
        raise ValueError("top_k must be >= 1")
    if top_k > corpus.n_items:
        raise ValueError(f"top_k ({top_k}) exceeds the corpus ({corpus.n_items} items)")
    if coarse_k < 0:
        raise ValueError("coarse_k must be >= 0 (0 = exact scan)")
    if coarse_k and coarse_k < top_k:
        raise ValueError(
            f"coarse_k ({coarse_k}) must be >= top_k ({top_k}) — the "
            "coarse stage must keep every row the final stage can return")
    if coarse_k >= corpus.n_items:
        coarse_k = 0  # degenerate routing: nothing could be dropped
    vectors, ids, qs = corpus.vectors, corpus.ids, corpus.qscale
    rps, sharded = corpus.rows_per_shard, n_shards > 1
    base = corpus.shard * rps
    group = axis_group(mesh, DATA_AXIS) if sharded else None

    def merge(*blocks):
        """Every rank's ``[c, k_local]`` blocks along dim 1, shard-major."""
        return [all_gather_cat(b, group, dim=1) for b in blocks]

    def exact(q):
        # the corpus operand is rounded once per call, the queries per chunk
        vb = _bf16_f32(vectors if qs is None else dequantize_rows(vectors, qs))
        out = []
        for c in _chunks(q, rps):
            s, i = _masked_top_k(_bf16_f32(c) @ vb.T, ids, min(top_k, rps))
            if sharded:
                s, i = merge(s, i)
                s, pos = top_k_ordered(s, top_k)
                i = torch.gather(i, 1, pos)
            out.append((s, i))
        return out

    k_local = min(coarse_k, rps)
    n_cand = min(coarse_k, k_local * n_shards)

    def two_stage(q):
        out = []
        vb = _bf16_f32(vectors)  # stored rows: int8 codes are exact in bf16
        for c in _chunks(q, rps):
            coarse = torch.where(ids[None, :] >= 0, _coarse_scores(c, vb, qs),
                                 float("-inf"))
            s, pos = top_k_ordered(coarse, k_local)
            if sharded:
                s, pos = merge(s, pos + base)  # GLOBAL positions
                _, sel = top_k_ordered(s, n_cand)
                pos = torch.gather(pos, 1, sel)
            pos = torch.sort(pos, dim=1).values  # lower position first on ties
            loc = pos - base
            flat = torch.clamp(loc, 0, rps - 1).reshape(-1)
            cand = _gather_dequant(vectors, qs, flat).reshape(*pos.shape, -1)
            cand_ids = ids[flat].reshape(pos.shape)
            if sharded:  # the owner's rows and ids; the others add -0.0 and 0
                mine = (loc >= 0) & (loc < rps)
                cand = all_reduce_(torch.where(mine[..., None], cand, -0.0), group)
                cand_ids = all_reduce_(torch.where(mine, cand_ids, 0), group)
            rr = torch.where(cand_ids >= 0, _rerank_scores(c, cand), float("-inf"))
            s, sel = top_k_ordered(rr, top_k)
            out.append((s, torch.gather(cand_ids, 1, sel)))
        return out

    run = two_stage if coarse_k else exact

    def retrieve(queries):
        q = torch.as_tensor(queries).to(vectors.device, torch.float32)
        with torch.no_grad():
            parts = run(q)
        return (torch.cat([s for s, _ in parts]),
                torch.cat([i for _, i in parts]).to(torch.int32))

    retrieve.corpus = corpus
    retrieve.coarse_k = coarse_k
    return retrieve


def retrieval_reference(queries, corpus: Corpus, *, top_k: int = 100):
    """Single-device exact reference: the full ``[B, N]`` score matrix and a
    stable descending sort (ties lower corpus position first), int8 corpora
    decoded first; ``(scores [B, k], ids [B, k])``."""
    n = corpus.n_items
    vectors = corpus.vectors[:n]
    if corpus.qscale is not None:
        vectors = dequantize_rows(vectors, corpus.qscale[:n])
    ids = corpus.ids[:n]
    q = torch.as_tensor(queries).to(vectors.device, torch.float32)
    with torch.no_grad():
        scores = mips_scores(q, vectors)
        order = torch.sort(scores, dim=-1, descending=True, stable=True).indices[:, :top_k]
    return torch.gather(scores, 1, order), ids[order]
