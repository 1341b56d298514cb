"""Train state -> serving bundle — port of ``tdfo_tpu/serve/export.py``
(``BUNDLE_VERSION``, ``merged_tables``, ``ServingBundle``,
``bundle_digest``, ``read_raw_bundle`` / ``write_raw_bundle``,
``export_bundle``, ``export_delta`` / ``apply_delta_arrays``,
``load_bundle``, ``bundle_from_raw``, ``export_corpus`` / ``load_corpus``).

A bundle is a directory holding ``bundle.json`` (the manifest) and
``arrays.npz``, byte-compatible with the reference's: the same manifest
keys, the same array keys (``table:{name}``, ``dense:{flax path}``,
``params:{flax path}``), dtypes and shapes, and the same content
``digest``.  A bundle written by either package loads and scores in the
other.  Dense parameters are stored under the reference's flax names and
``[in, out]`` kernel layouts (``interop.flax_params_from_module``).

* optimizer slots are dropped: fat lines are read through
  ``ops/fat_lines.py::fat_view`` (table lanes only), stacks
  (``__tablestack_`` / ``__fatstack_``) are cut into their member tables,
  row padding is sliced off;
* int8 arrays decode through their ``__qscale__/`` sidecar, on the host in
  numpy with the reference's host formula (``q * scale`` rounded, then
  ``+ offset`` rounded: numpy does not fuse them), so a bundle holds f32
  rows whatever the training storage was;
* ``{name}__hot`` heads are written back over their cold rows;
* ``caches``: an unflushed update cache's dirty rows overlay the table.
  For an int8 array the cached rows' grid (the cache's ``qs`` mirror)
  overlays the sidecar too, as the flush does; the reference's overlay
  copies the codes only, so its export of an unflushed int8 cache decodes
  new codes on the old grid (``ROADMAP.md`` Queue C);
* the cast policy (``mixed_precision``) follows
  ``core.precision.compute_dtype``: bf16 is stored as uint16 bit patterns,
  every other float as f32 (so the GPU's f16 policy ships f32 arrays under
  a ``"float16"`` manifest, as in the reference).

Fused int8 tables (byte-container fat lines) are refused: the reference
reads them through the f32 line geometry and fails.  A delta
(``export_delta``) ships the rows whose stored bytes changed since its base
bundle and promises the digest of the full export of the same state; a
delta composed onto its base (``apply_delta_arrays``) therefore equals that
full export bitwise.  Loaded bundles hold CPU tensors (bf16 arrays as
``torch.bfloat16``).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from tdfo_tpu_torch.core.device import resolve_device
from tdfo_tpu_torch.core.precision import compute_dtype
from tdfo_tpu_torch.interop import flax_params_from_module, to_numpy, to_torch
from tdfo_tpu_torch.ops.fat_lines import fat_view
from tdfo_tpu_torch.ops.quant import QSCALE_LAYOUT, STORAGE_DTYPES
from tdfo_tpu_torch.parallel.embedding import CACHE_PREFIX, qscale_name

__all__ = [
    "BUNDLE_VERSION",
    "QSCALE_LAYOUT",
    "ServingBundle",
    "apply_delta_arrays",
    "bundle_digest",
    "bundle_from_raw",
    "export_bundle",
    "export_corpus",
    "export_delta",
    "load_bundle",
    "load_corpus",
    "merged_tables",
    "read_raw_bundle",
    "touched_rows",
    "write_raw_bundle",
]

# Bundle schema version, stamped into every manifest and verified on load
# (the reference's: the two packages read each other's bundles).
BUNDLE_VERSION = 1

_MANIFEST = "bundle.json"
_ARRAYS = "arrays.npz"
_OOB = 2**31 - 1  # the update cache's empty-slot id


def _host(t) -> np.ndarray:
    """A tensor's (or array's) values on the host; codes and ids keep their
    dtype, bf16 widens to f32 exactly."""
    return to_numpy(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _decode_host(codes: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """int8 codes + f32 (scale, offset) -> f32 rows, the reference's host
    formula: the product and the sum round separately."""
    qs = np.asarray(qs, np.float32)
    return np.asarray(codes, np.float32) * qs[..., 0:1] + qs[..., 1:2]


def merged_tables(coll, tables: Mapping[str, torch.Tensor],
                  caches: Mapping[str, Any] | None = None) -> dict[str, np.ndarray]:
    """Live tables (``coll.init()``'s dict, any device) -> logical
    ``{table name: [V, d] f32}`` host rows, undoing fat-line packing,
    stacking, row padding, int8 storage and the hot/cold split (module
    docstring).  ``caches``: the ``CACHE_PREFIX`` entries of the slots of an
    UNFLUSHED cache-enabled state (checkpointed states are always
    flushed)."""
    views: dict[str, np.ndarray] = {}  # array name -> [rows, >= d] host view
    sidecars: dict[str, np.ndarray] = {}  # int8 array name -> [rows, 2]
    out: dict[str, np.ndarray] = {}
    for tname, spec in coll.specs.items():
        aname, _, off = coll.resolve_table(tname)
        if aname not in views:
            arr = tables[aname].detach()
            if arr.dim() == 3:  # fused fat lines [L, T, 128]
                if arr.dtype == torch.int8:
                    raise ValueError(
                        f"array {aname!r}: fused int8 tables (byte-container "
                        "fat lines) cannot be exported; the reference's "
                        "merged_tables reads them through the f32 line "
                        "geometry and fails too.  Export from plain int8 "
                        "tables (fused_table_threshold = -1).")
                arr = fat_view(arr, coll.fat_layout(coll.array_embedding_dim(aname)))
            view = _host(arr.cpu())
            qs = None
            if view.dtype == np.int8:
                qs = _host(tables[qscale_name(aname)].cpu())
            cache = (caches or {}).get(CACHE_PREFIX + aname)
            if cache is not None:
                # dirty cached rows over their stale big-table values (a
                # bit-copy, the host twin of the flush)
                ids = _host(cache["ids"].cpu())
                slot = _host(cache["slot"].cpu())
                dirty = _host(cache["dirty"].cpu())[slot] & (ids < _OOB)
                if dirty.any():
                    view = view.copy()
                    view[ids[dirty]] = _host(cache["rows"].cpu())[slot[dirty]]
                    if qs is not None:
                        qs = qs.copy()
                        qs[ids[dirty]] = _host(cache["qs"].cpu())[slot[dirty]]
            views[aname] = view
            if qs is not None:
                sidecars[aname] = qs
        d = spec.embedding_dim
        view = views[aname]
        rows_ = slice(off, off + spec.num_embeddings)
        if aname in sidecars:
            # a raw cast would export codes, not values
            rows = _decode_host(view[rows_, :d], sidecars[aname][rows_])
        else:
            rows = np.array(view[rows_, :d], dtype=np.float32)
        hids = coll.hot_ids.get(tname)
        if hids is not None:
            rows[hids] = _host(tables[coll.hot_array_name(tname)].cpu()).astype(
                np.float32)
        out[tname] = rows
    return out


@dataclass(frozen=True)
class ServingBundle:
    """A loaded serving bundle (see :func:`export_bundle`).  ``kind`` =
    "sparse" (logical ``tables`` + backbone ``dense_params``) or "dense"
    (the dense-regime TwoTower's whole flax-form ``params`` tree, tables
    included).  Arrays are CPU tensors."""

    kind: str
    model: str
    embed_dim: int
    cat_columns: tuple[str, ...]
    cont_columns: tuple[str, ...]
    size_map: dict[str, int]
    step: int
    dtype: str  # "float32" | "bfloat16" | "float16": the export cast policy
    tables: dict[str, torch.Tensor] | None  # sparse kind
    dense_params: dict | None  # sparse kind
    params: dict | None  # dense kind
    # bert4rec: max_len / n_heads / n_layers, the geometry the scorer
    # rebuilds; None for the CTR family
    seq: dict | None = None
    version: int = 0
    digest: str = ""

    @property
    def torch_dtype(self) -> torch.dtype:
        """The compute dtype the scorer uses (the reference's ``jax_dtype``:
        bf16 for bf16 bundles, else f32)."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    flat: dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = _host(v)
    return flat


def _unflatten(flat: Mapping[str, Any]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _store(arr: np.ndarray, dtype_name: str) -> np.ndarray:
    """The cast policy: bf16 ships as uint16 bit patterns (round to nearest
    even; npz has no bfloat16), every other float as f32, integers as they
    are."""
    if not np.issubdtype(arr.dtype, np.floating):
        return arr
    if dtype_name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    return np.asarray(arr, np.float32)


def _load_stored(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16" and arr.dtype == np.uint16:
        return torch.from_numpy(arr.astype(np.int16)).view(torch.bfloat16)
    return to_torch(arr)


def bundle_digest(manifest: Mapping[str, Any],
                  arrays: Mapping[str, np.ndarray]) -> str:
    """Content digest: the canonical manifest (minus ``digest``) and every
    STORED array's key, dtype, shape and bytes, sha256 truncated to 16 hex
    (the npz container bytes are not hashed)."""
    core = {k: v for k, v in manifest.items() if k != "digest"}
    h = hashlib.sha256(json.dumps(core, sort_keys=True).encode())
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def read_raw_bundle(bundle_dir: str | Path) -> tuple[dict, dict[str, np.ndarray]]:
    """A bundle directory as (manifest, STORED arrays): no dtype view-back,
    no validation beyond file presence."""
    bdir = Path(bundle_dir)
    mpath = bdir / _MANIFEST
    if not mpath.exists():
        raise ValueError(f"{bdir} is not a serving bundle (no {_MANIFEST})")
    manifest = json.loads(mpath.read_text())
    with np.load(bdir / _ARRAYS) as z:
        arrays = {k: z[k] for k in z.files}
    return manifest, arrays


def write_raw_bundle(out_dir: str | Path, manifest: Mapping[str, Any],
                     arrays: Mapping[str, np.ndarray]) -> Path:
    """Write ``arrays.npz`` first and the manifest last (the manifest is
    the commit point a reader keys off)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / _ARRAYS, **arrays)
    (out / _MANIFEST).write_text(json.dumps(manifest, indent=1, sort_keys=True))
    return out


def _flax_tree(tree_or_module) -> Mapping[str, Any]:
    if isinstance(tree_or_module, torch.nn.Module):
        return flax_params_from_module(tree_or_module)
    return tree_or_module


def export_bundle(
    out_dir: str | Path,
    *,
    model: str,
    embed_dim: int,
    cat_columns: tuple[str, ...],
    cont_columns: tuple[str, ...],
    size_map: Mapping[str, int],
    step: int = 0,
    coll=None,
    tables: Mapping[str, torch.Tensor] | None = None,
    dense_params=None,
    params=None,
    caches: Mapping[str, Any] | None = None,
    mixed_precision: bool = False,
    platform: str | None = None,
    version: int = 0,
    seq: Mapping[str, int] | None = None,
) -> Path:
    """Write a serving bundle directory and return its path.

    Sparse regime: ``coll`` + ``tables`` + ``dense_params`` (the backbone
    module, or its flax-form tree).  Dense regime: ``params`` (the
    ``TwoTower`` module, or its flax-form tree).  ``caches``: see
    :func:`merged_tables`.  ``mixed_precision`` applies
    ``compute_dtype(mixed_precision, platform)``.  ``seq``: Bert4Rec's
    ``max_len`` / ``n_heads`` / ``n_layers``, stamped so the scorer
    rebuilds the backbone exactly.
    """
    if (coll is None) == (params is None):
        raise ValueError(
            "export_bundle takes either coll+tables+dense_params (sparse "
            "regime) or params (dense regime), not both/neither")
    manifest, arrays = _materialize(
        model=model, embed_dim=embed_dim, cat_columns=cat_columns,
        cont_columns=cont_columns, size_map=size_map, step=step, coll=coll,
        tables=tables, dense_params=dense_params, params=params,
        caches=caches,
        dtype_name=_dtype_name(compute_dtype(mixed_precision, platform)),
        version=version, seq=seq)
    manifest["digest"] = bundle_digest(manifest, arrays)
    return write_raw_bundle(out_dir, manifest, arrays)


def _materialize(
    *, model, embed_dim, cat_columns, cont_columns, size_map, step, coll,
    tables, dense_params, params, caches, dtype_name, version, seq=None,
) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    """The bundle both a full export and a delta's ``result_digest`` come
    from: (manifest without its digest, stored arrays)."""
    arrays: dict[str, np.ndarray] = {}
    manifest: dict[str, Any] = {
        "bundle_version": BUNDLE_VERSION,
        "kind": "sparse" if coll is not None else "dense",
        "model": model,
        "embed_dim": int(embed_dim),
        "cat_columns": list(cat_columns),
        "cont_columns": list(cont_columns),
        "size_map": {k: int(v) for k, v in size_map.items()},
        "step": int(step),
        "dtype": dtype_name,
        "version": int(version),
    }
    if seq is not None:
        manifest["seq"] = {k: int(v) for k, v in dict(seq).items()}
    if coll is not None:
        if tables is None or dense_params is None:
            raise ValueError("sparse export needs tables and dense_params")
        logical = merged_tables(coll, tables, caches)
        manifest["tables"] = {
            n: [int(t.shape[0]), int(t.shape[1])] for n, t in logical.items()}
        for n, t in logical.items():
            arrays[f"table:{n}"] = _store(t, dtype_name)
        for k, v in _flatten(_flax_tree(dense_params)).items():
            arrays[f"dense:{k}"] = _store(v, dtype_name)
    else:
        for k, v in _flatten(_flax_tree(params)).items():
            arrays[f"params:{k}"] = _store(v, dtype_name)
    return manifest, arrays


def touched_rows(coll, *, caches: Mapping[str, Any] | None = None,
                 batches=()) -> dict[str, np.ndarray]:
    """The ``touched`` hint of :func:`export_delta`: per logical table, the
    sorted row ids the steps since the base export may have changed.  Two
    sources, united: the dirty sets of an update cache (``caches``: the
    ``CACHE_PREFIX`` slots; valid while no flush ran since the base) and
    the id columns of the batches trained since the base (``batches``:
    feature -> ids, the stream's cursor form)."""
    out: dict[str, list[np.ndarray]] = {t: [] for t in coll.specs}
    for tname, spec in coll.specs.items():
        aname, _, off = coll.resolve_table(tname)
        cache = (caches or {}).get(CACHE_PREFIX + aname)
        if cache is not None:
            ids = _host(cache["ids"].cpu())
            slot = _host(cache["slot"].cpu())
            dirty = _host(cache["dirty"].cpu())[slot] & (ids < _OOB)
            rows = ids[dirty].astype(np.int64) - off
            out[tname].append(rows[(rows >= 0) & (rows < spec.num_embeddings)])
    for batch in batches:
        for f, ids in batch.items():
            try:
                tname = coll.resolve(f)[1].name
            except KeyError:
                continue
            ids = ids.detach().cpu().numpy() if torch.is_tensor(ids) else np.asarray(ids)
            ids = ids.reshape(-1).astype(np.int64)
            out[tname].append(ids[ids >= 0])
    return {t: np.unique(np.concatenate(v)) if v else np.zeros(0, np.int64)
            for t, v in out.items()}


def _row_diff(new: np.ndarray, base: np.ndarray) -> np.ndarray:
    """Boolean [rows] mask of rows whose STORED bytes differ (byte compare,
    so NaNs and negative zeros diff exactly like the digest sees them)."""
    a = np.ascontiguousarray(new).view(np.uint8).reshape(new.shape[0], -1)
    b = np.ascontiguousarray(base).view(np.uint8).reshape(base.shape[0], -1)
    return np.any(a != b, axis=1)


def export_delta(
    out_dir: str | Path,
    base_dir: str | Path,
    *,
    model: str,
    embed_dim: int,
    cat_columns: tuple[str, ...],
    cont_columns: tuple[str, ...],
    size_map: Mapping[str, int],
    step: int,
    coll,
    tables: Mapping[str, torch.Tensor],
    dense_params,
    caches: Mapping[str, Any] | None = None,
    mixed_precision: bool = False,
    platform: str | None = None,
    touched: Mapping[str, np.ndarray] | None = None,
    seq: Mapping[str, int] | None = None,
) -> Path:
    """Export only the rows that changed since the ``base_dir`` bundle.

    Per table, rows whose stored bytes differ from the base ship as
    ``delta_ids:{name}`` + ``delta_rows:{name}``; dense arrays that changed
    ship whole.  The manifest is a chain entry (``version = base + 1``,
    ``parent_digest``, and the ``result_digest`` the composed bundle must
    hash to after :func:`apply_delta_arrays`: the digest of the full export
    of the same state, from the same :func:`_materialize`).  The tables
    come to the host and are byte-diffed there.

    ``touched``: an optional per-table row-id hint (:func:`touched_rows`).
    The byte diff stays authoritative; a changed row outside the hint is a
    loud error (a stale hint never ships a stale delta).
    """
    base_manifest, base_arrays = read_raw_bundle(base_dir)
    want = base_manifest.get("digest")
    got = bundle_digest(base_manifest, base_arrays)
    if want != got:
        raise ValueError(
            f"delta base {base_dir}: digest {got} != manifest {want!r} — "
            "refusing to chain onto a corrupt base")
    if base_manifest["kind"] != "sparse":
        raise ValueError(
            f"delta export needs a sparse base bundle, got kind "
            f"{base_manifest['kind']!r} (dense bundles re-export whole)")
    new_manifest, new_arrays = _materialize(
        model=model, embed_dim=embed_dim, cat_columns=cat_columns,
        cont_columns=cont_columns, size_map=size_map, step=step, coll=coll,
        tables=tables, dense_params=dense_params, params=None, caches=caches,
        dtype_name=_dtype_name(compute_dtype(mixed_precision, platform)),
        version=int(base_manifest["version"]) + 1, seq=seq)
    # "seq" freezes the bert4rec backbone geometry; CTR bundles compare
    # absent == absent
    frozen = ("kind", "model", "embed_dim", "cat_columns", "cont_columns",
              "size_map", "dtype", "tables", "seq")
    for key in frozen:
        if new_manifest.get(key) != base_manifest.get(key):
            raise ValueError(
                f"delta export schema drift on {key!r}: base "
                f"{base_manifest.get(key)!r} != new {new_manifest.get(key)!r}"
                " — a delta cannot change the bundle schema; re-export full")
    result_digest = bundle_digest(new_manifest, new_arrays)

    delta_arrays: dict[str, np.ndarray] = {}
    tables_delta: dict[str, int] = {}
    replaced: list[str] = []
    for key in sorted(new_arrays):
        if key.startswith("table:"):
            name = key.removeprefix("table:")
            mask = _row_diff(new_arrays[key], base_arrays[key])
            ids = np.nonzero(mask)[0].astype(np.int64)
            if touched is not None:
                hint = np.asarray(touched.get(name, ()), dtype=np.int64)
                stray = np.setdiff1d(ids, hint)
                if stray.size:
                    raise ValueError(
                        f"delta export: table {name!r} rows {stray[:8].tolist()}"
                        " changed outside the touched-row hint — the hint is "
                        "stale; refusing to ship a delta that would miss them")
            if ids.size:
                delta_arrays[f"delta_ids:{name}"] = ids
                delta_arrays[f"delta_rows:{name}"] = np.ascontiguousarray(
                    new_arrays[key][ids])
                tables_delta[name] = int(ids.size)
        elif _row_diff(new_arrays[key].reshape(1, -1),
                       base_arrays[key].reshape(1, -1))[0]:
            delta_arrays[key] = new_arrays[key]
            replaced.append(key)

    delta_manifest: dict[str, Any] = {
        "bundle_version": BUNDLE_VERSION,
        "kind": "delta",
        "base_kind": base_manifest["kind"],
        "model": model,
        "step": int(step),
        "dtype": new_manifest["dtype"],
        "version": int(base_manifest["version"]) + 1,
        "parent_version": int(base_manifest["version"]),
        "parent_digest": base_manifest["digest"],
        "result_digest": result_digest,
        "tables_delta": tables_delta,
        "replaced": replaced,
    }
    delta_manifest["digest"] = bundle_digest(delta_manifest, delta_arrays)
    return write_raw_bundle(out_dir, delta_manifest, delta_arrays)


def apply_delta_arrays(
    base_manifest: Mapping[str, Any],
    base_arrays: Mapping[str, np.ndarray],
    delta_manifest: Mapping[str, Any],
    delta_arrays: Mapping[str, np.ndarray],
) -> tuple[dict[str, Any], dict[str, np.ndarray]]:
    """Compose a delta onto its parent: (result manifest, stored arrays).

    Pure chain math (durability is ``serve/swap.py``'s).  Refuses, with a
    ``ValueError`` naming the cause: a non-delta manifest, a
    ``bundle_version`` this build does not serve, a version gap or re-order
    (``parent_version``), a parent whose digest is not ``parent_digest``, a
    payload that does not hash to the delta's digest, and a composition
    that does not hash to ``result_digest``.
    """
    if delta_manifest.get("kind") != "delta":
        raise ValueError(
            f"not a delta manifest (kind={delta_manifest.get('kind')!r})")
    if delta_manifest.get("bundle_version") != BUNDLE_VERSION:
        raise ValueError(
            f"delta has bundle_version {delta_manifest.get('bundle_version')!r},"
            f" this build serves {BUNDLE_VERSION}")
    base_v = int(base_manifest.get("version", 0))
    parent_v = int(delta_manifest["parent_version"])
    if parent_v != base_v:
        raise ValueError(
            f"delta chain out of order: delta v{delta_manifest['version']} "
            f"expects parent v{parent_v}, current bundle is v{base_v} — "
            "deltas apply strictly in version order, no gaps or re-orders")
    if delta_manifest["parent_digest"] != base_manifest.get("digest"):
        raise ValueError(
            f"delta parent digest mismatch: delta expects parent "
            f"{delta_manifest['parent_digest']}, current bundle digest is "
            f"{base_manifest.get('digest')!r} — the parent is not the bundle "
            "this delta was exported against")
    own = bundle_digest(delta_manifest, delta_arrays)
    if own != delta_manifest.get("digest"):
        raise ValueError(
            f"delta digest mismatch: payload hashes to {own}, manifest says "
            f"{delta_manifest.get('digest')!r} — corrupt delta")

    out_arrays = dict(base_arrays)
    for key in delta_manifest.get("replaced", ()):
        out_arrays[key] = delta_arrays[key]
    for name in delta_manifest.get("tables_delta", {}):
        ids = delta_arrays[f"delta_ids:{name}"]
        rows = delta_arrays[f"delta_rows:{name}"]
        arr = np.array(base_arrays[f"table:{name}"])
        arr[ids] = rows
        out_arrays[f"table:{name}"] = arr

    out_manifest = {k: v for k, v in base_manifest.items() if k != "digest"}
    out_manifest["step"] = int(delta_manifest["step"])
    out_manifest["version"] = int(delta_manifest["version"])
    digest = bundle_digest(out_manifest, out_arrays)
    if digest != delta_manifest["result_digest"]:
        raise ValueError(
            f"delta result digest mismatch: composed bundle hashes to "
            f"{digest}, delta promises {delta_manifest['result_digest']} — "
            "refusing to serve an unverified composition")
    out_manifest["digest"] = digest
    return out_manifest, out_arrays


def load_bundle(bundle_dir: str | Path, *, verify: bool = False) -> ServingBundle:
    """Load and VALIDATE a serving bundle: refuses a missing manifest, a
    ``bundle_version`` mismatch, manifest/array key drift and table shape
    drift; ``verify=True`` also recomputes the content digest and refuses
    a mismatch."""
    bdir = Path(bundle_dir)
    manifest, raw = read_raw_bundle(bdir)
    return bundle_from_raw(manifest, raw, source=str(bdir), verify=verify)


def bundle_from_raw(manifest: Mapping[str, Any],
                    raw_arrays: Mapping[str, np.ndarray], *,
                    source: str = "<memory>",
                    verify: bool = False) -> ServingBundle:
    """Validate ``(manifest, STORED arrays)`` into a :class:`ServingBundle`
    without touching disk (the refusals of :func:`load_bundle`, which
    delegates here; ``source`` labels them)."""
    found = manifest.get("bundle_version")
    if found != BUNDLE_VERSION:
        raise ValueError(
            f"serving bundle {source} has bundle_version {found!r}, this build "
            f"serves {BUNDLE_VERSION}.  The array schemas are not "
            "value-compatible across versions; re-export the checkpoint.")
    dtype_name = manifest["dtype"]
    if verify:
        got = bundle_digest(manifest, raw_arrays)
        if got != manifest.get("digest"):
            raise ValueError(
                f"serving bundle {source}: content digest {got} != manifest "
                f"{manifest.get('digest')!r} — refusing a corrupt bundle")
    arrays = {k: _load_stored(v, dtype_name) for k, v in raw_arrays.items()}

    kind = manifest["kind"]
    tables = dense_params = params = None
    if kind == "sparse":
        schema = manifest["tables"]
        stored = {k.removeprefix("table:") for k in arrays if k.startswith("table:")}
        if stored != set(schema):
            raise ValueError(
                f"serving bundle {source}: manifest tables {sorted(schema)} != "
                f"stored arrays {sorted(stored)} — refusing a torn bundle")
        tables = {}
        for n, (rows, dim) in schema.items():
            t = arrays[f"table:{n}"]
            if tuple(t.shape) != (rows, dim):
                raise ValueError(
                    f"serving bundle {source}: table {n!r} is {tuple(t.shape)}, "
                    f"manifest says {(rows, dim)} — refusing a torn bundle")
            tables[n] = t
        dense_params = _unflatten({
            k.removeprefix("dense:"): v
            for k, v in arrays.items() if k.startswith("dense:")})
    elif kind == "dense":
        params = _unflatten({
            k.removeprefix("params:"): v
            for k, v in arrays.items() if k.startswith("params:")})
        if not params:
            raise ValueError(f"serving bundle {source}: dense bundle holds no params")
    else:
        raise ValueError(f"serving bundle {source}: unknown kind {kind!r}")

    return ServingBundle(
        kind=kind,
        model=manifest["model"],
        embed_dim=int(manifest["embed_dim"]),
        cat_columns=tuple(manifest["cat_columns"]),
        cont_columns=tuple(manifest["cont_columns"]),
        size_map={k: int(v) for k, v in manifest["size_map"].items()},
        step=int(manifest["step"]),
        dtype=dtype_name,
        tables=tables,
        dense_params=dense_params,
        params=params,
        seq=({k: int(v) for k, v in manifest["seq"].items()}
             if manifest.get("seq") else None),
        version=int(manifest.get("version", 0)),
        digest=str(manifest.get("digest", "")),
    )


# ----------------------------------------------------------- corpus store
# A corpus persists like a bundle (one npz + a stamped manifest) at its
# STORED dtype: int8 corpora ship codes plus the (scale, offset) sidecar.

_CORPUS_MANIFEST = "corpus.json"
_CORPUS_ARRAYS = "corpus.npz"


def _gathered_corpus(corpus, mesh):
    """A sharded corpus's ``(vectors, ids, qscale)`` in the single-device
    layout on global rank 0's host (shard by shard over the data axis;
    ``None`` on the other ranks); the corpus itself when unsharded."""
    if corpus.n_shards == 1:
        return corpus.vectors, corpus.ids, corpus.qscale
    from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_group
    from tdfo_tpu_torch.parallel.collectives import gather_to_host

    if mesh is None:
        raise ValueError("a sharded corpus exports through its mesh (mesh=)")
    group = axis_group(mesh, DATA_AXIS)
    parts = [None if t is None else gather_to_host(t, group)
             for t in (corpus.vectors, corpus.ids, corpus.qscale)]
    return None if parts[0] is None else parts


def export_corpus(out_dir: str | Path, corpus, *, step: int = 0,
                  mesh=None) -> Path:
    """Write a retrieval corpus directory (the unpadded rows at their
    stored dtype; bf16 as uint16 bit patterns; int8 with its ``qscale``
    sidecar and the ``qscale_layout`` stamp) and return its path.  A
    corpus sharded over ``mesh``: every rank calls this, the shards are
    gathered to global rank 0, which alone writes (the others wait for it
    at a barrier)."""
    out = Path(out_dir)
    if corpus.n_shards > 1:
        import torch.distributed as dist

        got = _gathered_corpus(corpus, mesh)
        if dist.get_rank() == 0:
            vectors, ids, qscale = got
            _write_corpus(out, vectors, ids, qscale, corpus.n_items, step)
        dist.barrier()
        return out
    return _write_corpus(out, corpus.vectors, corpus.ids, corpus.qscale,
                         corpus.n_items, step)


def _write_corpus(out: Path, vectors, ids, qscale, n: int, step: int) -> Path:
    vectors = vectors[:n].detach().cpu()
    dtype_name = _dtype_name(vectors.dtype)
    if dtype_name not in STORAGE_DTYPES:
        raise ValueError(f"corpus dtype {dtype_name!r} not in {STORAGE_DTYPES}")
    arrays: dict[str, np.ndarray] = {
        "vectors": (vectors.view(torch.int16).numpy().view(np.uint16)
                    if dtype_name == "bfloat16" else vectors.numpy()),
        "ids": np.asarray(_host(ids[:n].cpu()), np.int32),
    }
    manifest: dict[str, Any] = {
        "bundle_version": BUNDLE_VERSION,
        "kind": "corpus",
        "dtype": dtype_name,
        "n_items": int(n),
        "dim": int(vectors.shape[1]),
        "step": int(step),
    }
    if dtype_name == "int8":
        if qscale is None:
            raise ValueError(
                "int8 corpus has no qscale sidecar — it cannot be "
                "dequantized; refusing to export garbage")
        arrays["qscale"] = np.asarray(_host(qscale[:n].cpu()), np.float32)
        manifest["qscale_layout"] = QSCALE_LAYOUT
    elif qscale is not None:
        raise ValueError(
            f"{dtype_name} corpus carries a qscale sidecar — only int8 "
            "rows are scaled; refusing an inconsistent corpus")
    manifest["digest"] = bundle_digest(manifest, arrays)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / _CORPUS_ARRAYS, **arrays)
    (out / _CORPUS_MANIFEST).write_text(json.dumps(manifest, indent=1, sort_keys=True))
    return out


def load_corpus(corpus_dir: str | Path, *, mesh=None, device="cuda"):
    """Load a stored corpus onto ``device`` -> ``Corpus``.  Refuses (a
    ``ValueError`` naming the cause) a missing manifest, a
    ``bundle_version`` mismatch, an unknown dtype, a content-digest
    mismatch, shape drift, an int8 corpus without (or with another)
    ``qscale_layout`` or without its sidecar, and a float corpus that
    carries one.  ``mesh``: this rank's shard over its data axis, the
    padding re-derived for THIS mesh whatever mesh wrote the corpus (zero
    rows of id -1; int8 padding quantized from zero rows, as
    ``build_corpus`` stores it), so a same-mesh round trip is bitwise."""
    from tdfo_tpu_torch.serve.corpus import Corpus, pad_shard, shard_rows

    device = resolve_device(device)
    cdir = Path(corpus_dir)
    mpath = cdir / _CORPUS_MANIFEST
    if not mpath.exists():
        raise ValueError(f"{cdir} is not a corpus store (no {_CORPUS_MANIFEST})")
    manifest = json.loads(mpath.read_text())
    found = manifest.get("bundle_version")
    if found != BUNDLE_VERSION:
        raise ValueError(
            f"corpus store {cdir} has bundle_version {found!r}, this build "
            f"serves {BUNDLE_VERSION} — re-export the corpus.")
    if manifest.get("kind") != "corpus":
        raise ValueError(f"{cdir} is a {manifest.get('kind')!r} bundle, not a corpus")
    dtype_name = manifest["dtype"]
    if dtype_name not in STORAGE_DTYPES:
        raise ValueError(
            f"corpus store {cdir}: unknown dtype {dtype_name!r} (this build "
            f"reads {STORAGE_DTYPES})")
    with np.load(cdir / _CORPUS_ARRAYS) as z:
        arrays = {k: z[k] for k in z.files}
    got = bundle_digest(manifest, arrays)
    if got != manifest.get("digest"):
        raise ValueError(
            f"corpus store {cdir}: content digest {got} != manifest "
            f"{manifest.get('digest')!r} — refusing a corrupt corpus")
    n, dim = int(manifest["n_items"]), int(manifest["dim"])
    vectors = _load_stored(arrays["vectors"], dtype_name)
    if tuple(vectors.shape) != (n, dim):
        raise ValueError(
            f"corpus store {cdir}: vectors are {tuple(vectors.shape)}, manifest "
            f"says {(n, dim)} — refusing a torn corpus")
    qscale = None
    if dtype_name == "int8":
        layout = manifest.get("qscale_layout")
        if layout != QSCALE_LAYOUT:
            raise ValueError(
                f"corpus store {cdir}: int8 qscale_layout {layout!r}, this "
                f"build reads {QSCALE_LAYOUT!r} — the sidecar grids are not "
                "value-compatible; re-export the corpus.")
        if "qscale" not in arrays:
            raise ValueError(
                f"corpus store {cdir}: int8 corpus is missing the qscale "
                "sidecar — refusing a torn corpus")
        qscale = to_torch(np.asarray(arrays["qscale"], np.float32))
        if tuple(qscale.shape) != (n, 2):
            raise ValueError(
                f"corpus store {cdir}: qscale is {tuple(qscale.shape)}, expected "
                f"{(n, 2)} — refusing a torn corpus")
        qscale = qscale.to(device)
    elif "qscale" in arrays or "qscale_layout" in manifest:
        raise ValueError(
            f"corpus store {cdir}: {dtype_name} corpus carries a qscale "
            "sidecar — only int8 rows are scaled; refusing an "
            "inconsistent corpus")
    ids = to_torch(np.asarray(arrays["ids"], np.int32))
    shard, n_shards, lo, hi = shard_rows(n, mesh)
    vectors, ids = vectors[lo:hi].to(device), ids[lo:hi].to(device)
    if qscale is None:  # float padding rows are stored zeros
        vectors, ids = pad_shard(vectors, ids, n, n_shards)
    else:  # int8 ones are zero rows quantized, as a build stores them
        from tdfo_tpu_torch.ops.quant import quantize_rows

        _, ids = pad_shard(vectors, ids, n, n_shards)
        qscale = qscale[lo:hi]
        if ids.shape[0] > hi - lo:
            codes, qs = quantize_rows(torch.zeros((ids.shape[0] - (hi - lo), dim),
                                                  device=device), divide=True)
            vectors, qscale = torch.cat([vectors, codes]), torch.cat([qscale, qs])
    return Corpus(vectors=vectors, ids=ids, n_items=n, qscale=qscale,
                  shard=shard, n_shards=n_shards)
