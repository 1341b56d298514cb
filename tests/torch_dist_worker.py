"""Rank process of the port's multi-process tests (gloo on the CPU).

Imports torch and the port only.  A test starts one process per rank
(:class:`Ranks`, torchrun's environment variables set by hand); they join
their process group while the test builds its cases, then read the pickle
of cases it sends, and each rank runs every case in order: it builds
the case's ``DeviceMesh``, carries the case's global numpy arrays to its
shard (``interop.shard_from_numpy``), runs the port, and writes what it got
back as global numpy arrays (``interop.gather_to_numpy``) into
``rank<k>.pkl``.  The test compares those with the JAX package.  A case
whose ``expect`` names an exception type records the message it raised.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

if __name__ != "__main__":
    # a test process: one torch thread.  A parallel test run puts one
    # pytest worker on each of several cores, and torch's default of one
    # OpenMP thread per core in every worker oversubscribes them; the
    # port's tests work on tensors too small to gain from a pool.  Every
    # worker imports this module while it collects the test files.
    import torch

    torch.set_num_threads(1)


class Ranks:
    """``world`` gloo rank processes, started before their cases exist: they
    import torch and the port and join their process group while the test
    builds the cases (the JAX side); :meth:`send` hands them the cases, and
    :meth:`wait` returns each rank's results."""

    def __init__(self, world: int, tmp: Path, timeout: float = 240.0):
        self.world, self.tmp, self.timeout = world, Path(tmp), timeout
        self.tmp.mkdir(parents=True, exist_ok=True)
        self.inp = self.tmp / f"cases_{world}.pkl"
        # a file rendezvous in the set's own folder: no port is probed and
        # released before the ranks bind it, so no other process can take
        # it in between
        store = self.tmp / f"rendezvous_{world}"
        store.unlink(missing_ok=True)
        env = dict(os.environ, WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   TDFO_TEST_RENDEZVOUS=f"file://{store}")
        env["PYTHONPATH"] = f"{REPO}{os.pathsep}" + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), str(self.inp),
             str(self.tmp), str(timeout)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]

    def send(self, cases: dict) -> "Ranks":
        tmp = self.inp.with_suffix(".part")
        tmp.write_bytes(pickle.dumps(cases))
        os.replace(tmp, self.inp)  # the ranks see the whole file or none
        return self

    def wait(self) -> list[dict]:
        logs = []
        for p in self.procs:
            try:
                out, _ = p.communicate(timeout=self.timeout)
            except subprocess.TimeoutExpired:
                self.kill()
                raise
            logs.append(out)
        for r, p in enumerate(self.procs):
            if p.returncode != 0:
                raise RuntimeError(f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}")
        return [pickle.loads((self.tmp / f"rank{r}_{self.world}.pkl").read_bytes())
                for r in range(self.world)]


    def kill(self) -> None:
        """Stop every rank (a failed set leaves nothing running that could
        still write into its folders)."""
        for p in self.procs:
            p.kill()
        for p in self.procs:
            p.wait()


def run_ranks(world: int, cases: dict, tmp: Path, timeout: float = 240.0) -> list[dict]:
    """Run ``cases`` on ``world`` gloo ranks; returns each rank's results."""
    return Ranks(world, tmp, timeout).send(cases).wait()


# ------------------------------------------------------------------ cases

_MESHES: dict = {}


def _mesh(case):
    """The case's mesh, built once per shape (each build makes its groups)."""
    from tdfo_tpu_torch.core.mesh import MeshSpec, make_mesh

    d, m, s = (*case["mesh"], 1)[:3]
    if (d, m, s) not in _MESHES:
        _MESHES[d, m, s] = make_mesh(MeshSpec(data=d, model=m, seq=s), device="cpu")
    return _MESHES[d, m, s]


def _coll(case, mesh):
    from tdfo_tpu_torch.parallel.embedding import (
        EmbeddingSpec,
        ShardedEmbeddingCollection,
    )

    specs = [EmbeddingSpec(**s) for s in case["specs"]]
    return ShardedEmbeddingCollection(
        specs, mesh=mesh, fused_kind=case.get("kind", "adam"),
        stack_tables=case.get("stack_tables", False),
        a2a_capacity_factor=case.get("cf"),
        grouped_a2a=case.get("grouped", False), hot_ids=case.get("hot"),
        cache_rows=case.get("cache_rows", 0))


def _local_ids(mesh, mode, feats):
    import torch

    from tdfo_tpu_torch.core.mesh import data_slice
    from tdfo_tpu_torch.train.sparse_step import BatchGroup

    bg = BatchGroup(mesh, mode)
    out = {}
    for f, v in feats.items():
        v = torch.from_numpy(v)
        out[f] = v[data_slice(mesh, v.shape[0])]
    return bg, bg.split(out)


def case_mesh_info(case):
    """This rank's coordinates, the axis names, and the ranks of its line
    along each axis and of its data x model plane (an all-gather of the
    global rank over that group)."""
    import torch
    import torch.distributed as dist

    from tdfo_tpu_torch.core.mesh import (
        AXES,
        axis_group,
        axis_index,
        axis_size,
        plane_group,
        seq_slice,
    )
    from tdfo_tpu_torch.parallel.collectives import all_gather_cat

    mesh = _mesh(case)
    me = torch.tensor([dist.get_rank()])
    return {"names": tuple(mesh.mesh_dim_names),
            "coords": tuple(axis_index(mesh, a) for a in AXES),
            "sizes": tuple(axis_size(mesh, a) for a in AXES),
            "lines": {a: all_gather_cat(me, axis_group(mesh, a)).tolist()
                      for a in AXES},
            "plane": all_gather_cat(me, plane_group(mesh, ("data", "model"))).tolist(),
            "seq_slice": seq_slice(mesh, 8)}


def case_init(case):
    """``init`` under the mesh, gathered into the single-device layout."""
    from tdfo_tpu_torch.interop import gather_to_numpy

    coll = _coll(case, _mesh(case))
    return {"tables": gather_to_numpy(coll, coll.init(case["seed"], device="cpu"))[0]}


def case_ckpt_gather(case):
    """A checkpoint's gather of ``init``'s tables and adam slots (random
    values): on rank 0, ``global_arrays(root_only=True)`` on the host,
    bitwise the all-gather, and ``global_template`` of the same shapes and
    dtypes without memory behind its sharded arrays; on the other ranks,
    what they got (nothing, or None for every sharded array)."""
    import torch
    import torch.distributed as dist

    from tdfo_tpu_torch.ops.sparse import sparse_optimizer

    coll = _coll(case, _mesh(case))
    tables = coll.init(case["seed"], device="cpu")
    gen = torch.Generator().manual_seed(dist.get_rank())
    slots = {n: tuple(torch.rand(s.shape, generator=gen) if s.dim() else s
                      for s in sparse_optimizer("adam", lr=1e-2).init(t))
             for n, t in tables.items()}
    full = coll.global_arrays(tables, slots)
    root = coll.global_arrays(tables, slots, root_only=True)
    if dist.get_rank() != 0:
        return {"root": None if root[0] is None else
                sorted(k for k, v in root[0].items() if v is not None)}
    tmpl = coll.global_template(tables, slots)
    flat = lambda ts: [*ts[0].values(), *(x for sl in ts[1].values() for x in sl)]  # noqa: E731
    return {"root": "all",
            "bitwise": all(torch.equal(a, b) for a, b in zip(flat(root), flat(full))),
            "on_host": all(a.device.type == "cpu" for a in flat(root)),
            "template": [(tuple(a.shape), a.dtype) for a in flat(tmpl)]
            == [(tuple(b.shape), b.dtype) for b in flat(full)],
            # each stand-in's storage, in elements (zero-stride tensors)
            "stand_ins": [a.untyped_storage().nbytes() // a.element_size()
                          for a in flat(tmpl) if a.dim() and not any(a.stride())]}


def case_lookup(case):
    """Lookups of the case's global ids, gathered back in batch order; the
    a2a overflow count and fill; the local table shapes."""
    from tdfo_tpu_torch.interop import shard_from_numpy, to_numpy

    mesh = _mesh(case)
    coll = _coll(case, mesh)
    tables, _ = shard_from_numpy(coll, case["tables"])
    bg, ids = _local_ids(mesh, case["mode"], case["features"])
    out = coll.lookup(tables, ids, mode=case["mode"])
    feats = sorted(out)
    got = dict(zip(feats, bg.gather([out[f] for f in feats])))
    fill, dropped = coll.a2a_fill_stats(tables, ids)
    return {"out": {f: to_numpy(v) for f, v in got.items()},
            "overflow": int(coll.a2a_overflow(tables, ids)),
            "dropped": int(dropped), "fill": float(fill),
            "shapes": {k: tuple(v.shape) for k, v in tables.items()}}


def case_grad(case):
    """The gradient of the sum of the lookups with respect to the tables,
    gathered (summed over the data axis, as the reference's grad is)."""
    import torch

    from tdfo_tpu_torch.core.mesh import DATA_AXIS, axis_group
    from tdfo_tpu_torch.interop import gather_to_numpy, shard_from_numpy
    from tdfo_tpu_torch.parallel.collectives import all_reduce_

    mesh = _mesh(case)
    coll = _coll(case, mesh)
    tables, _ = shard_from_numpy(coll, case["tables"])
    for t in tables.values():
        t.requires_grad_(True)
    _, ids = _local_ids(mesh, case["mode"], case["features"])
    out = coll.lookup(tables, ids, mode=case["mode"])
    sum(v.sum() for v in out.values()).backward()
    grads = {k: all_reduce_(t.grad, axis_group(mesh, DATA_AXIS))
             for k, t in tables.items()}
    with torch.no_grad():
        return {"grad": gather_to_numpy(coll, grads)[0]}


def case_update(case):
    """One ``sparse_update`` of every array with the case's global ids and
    grads (and SR key), gathered."""
    import torch

    from tdfo_tpu_torch.interop import gather_to_numpy, shard_from_numpy
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.quant import sr_key
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer

    mesh = _mesh(case)
    coll = _coll(case, mesh)
    tables, slots = shard_from_numpy(coll, case["tables"], case["slots"])
    opt = sparse_optimizer(case.get("kind", "adam"), lr=case["lr"],
                           weight_decay=case.get("wd", 0.0))
    before = kl.fat_line_update.plain_runs
    for name, (ids, g) in case["updates"].items():
        key = sr_key(case["step"], name) if case.get("sr") else None
        coll.sparse_update(opt, name, tables[name], slots[name],
                           torch.from_numpy(ids), torch.from_numpy(g), sr_key=key)
    t, s = gather_to_numpy(coll, tables, slots)
    return {"tables": t, "slots": s,
            "fat_runs": kl.fat_line_update.plain_runs - before}


class _CountA2A:
    """Counts ``torch.distributed.all_to_all_single`` calls (the port's
    collectives boundary) while it is entered."""

    def __enter__(self):
        import torch.distributed as dist

        self.orig, self.n = dist.all_to_all_single, 0

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)

        dist.all_to_all_single = counted
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        dist.all_to_all_single = self.orig


def case_grouped(case):
    """The grouped exchange beside the per-table program on the case's
    global ids (each rank its share): both lookups gathered back in batch
    order, the ``all_to_all_single`` calls of each, the overflow count and
    fill; with ``grads``, one ``grouped_update`` (``sr``: a narrow key) and
    its calls, gathered; with ``per_table_update``, the per-table path's
    ``sparse_update`` of the global ids and grads, gathered."""
    import torch

    from tdfo_tpu_torch.interop import gather_to_numpy, shard_from_numpy, to_numpy
    from tdfo_tpu_torch.ops.quant import sr_key
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.parallel.embedding import qscale_name

    mesh = _mesh(case)
    coll = _coll(case, mesh)
    per_table = _coll(dict(case, grouped=False), mesh)
    tables, _ = shard_from_numpy(coll, case["tables"])
    bg, ids = _local_ids(mesh, "alltoall", case["features"])
    out = {}
    for name, c in (("grouped", coll), ("per_table", per_table)):
        with _CountA2A() as n:
            got = c.lookup(tables, ids, mode="alltoall")
        feats = sorted(got)
        out[name] = {f: to_numpy(v) for f, v in
                     zip(feats, bg.gather([got[f] for f in feats]))}
        out[name + "_a2a"] = n.n
    fill, dropped = coll.a2a_fill_stats(tables, ids)
    out.update(overflow=int(coll.a2a_overflow(tables, ids)), fill=float(fill),
               dropped=int(dropped))
    if "grads" not in case:
        return out
    opt = sparse_optimizer(case.get("kind", "adam"), lr=case["lr"])
    slots = {n: opt.init(t) for n, t in tables.items()
             if not n.startswith("__qscale__/")}
    _, grads = _local_ids(mesh, "alltoall", case["grads"])
    key = sr_key(case["step"], "__grouped_update__") if case.get("sr") else None
    before = {k: v.clone() for k, v in tables.items()}
    with _CountA2A() as n:
        coll.grouped_update(opt, tables, slots,
                            {f: ids[f] for f in case["grads"]}, grads, sr_key=key)
    out["update_a2a"] = n.n
    out["tables"], out["slots"] = gather_to_numpy(coll, tables, slots)
    if case.get("per_table_update"):
        tables = before
        slots = {n: opt.init(t) for n, t in tables.items()
                 if not n.startswith("__qscale__/")}
        for name, (gids, g) in case["per_table_update"].items():
            key = sr_key(case["step"], name) if case.get("sr") else None
            per_table.sparse_update(opt, name, tables[name], slots[name],
                                    torch.from_numpy(gids), torch.from_numpy(g),
                                    sr_key=key, qscale=tables.get(qscale_name(name)))
        out["per_table_tables"] = gather_to_numpy(per_table, tables)[0]
    return out


def case_lookup_modes(case):
    """``psum`` and ``alltoall`` lookups (per-table programs) of the
    case's global ids, gathered back in batch order."""
    from tdfo_tpu_torch.interop import shard_from_numpy, to_numpy

    mesh = _mesh(case)
    coll = _coll(case, mesh)
    tables, _ = shard_from_numpy(coll, case["tables"])
    out = {}
    for mode in ("psum", "alltoall"):
        bg, ids = _local_ids(mesh, mode, case["features"])
        got = coll.lookup(tables, ids, mode=mode)
        feats = sorted(got)
        out[mode] = {f: to_numpy(v) for f, v in
                     zip(feats, bg.gather([got[f] for f in feats]))}
    return out


def _backbone(case):
    import torch

    from tdfo_tpu_torch.interop import backbone_params_from_flax

    if case["model"] == "dlrm":
        from tdfo_tpu_torch.models.dlrm import DLRMBackbone

        b = DLRMBackbone(case["d"], cat_columns=case["cats"],
                         cont_columns=case["conts"])
    else:
        from tdfo_tpu_torch.models.twotower import TwoTowerBackbone

        b = TwoTowerBackbone(case["d"])
    b.load_state_dict(backbone_params_from_flax(case["dense"]))
    return b.to(torch.float32)


def case_step(case):
    """K sparse train steps on the rank's data slice of each global batch,
    with ``dedup`` (``dedup_lookup``) and the collection's update cache
    (flushed after every ``flush_every`` steps and at the end) as the case
    says: the losses (the global batch's), the caches before the last flush
    (each rank's own copy), the flushes' overflow counts, the gathered
    state after it, the fat-line kernels' runs and the local table
    shapes."""
    import torch

    from tdfo_tpu_torch.core.mesh import data_slice
    from tdfo_tpu_torch.interop import gather_to_numpy, shard_from_numpy, to_numpy
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as kr
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.parallel.embedding import CACHE_PREFIX
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_cache_flush_fn,
        make_sparse_train_step,
    )

    mesh = _mesh(case)
    coll = _coll(case, mesh)
    tables, _ = shard_from_numpy(coll, case["tables"])
    backbone = _backbone(case)
    kind, lr, wd = case.get("kind", "adam"), case["lr"], case["wd"]
    state = SparseTrainState.create(
        backbone=backbone, tables=tables,
        sparse_opt=sparse_optimizer(kind, lr=case.get("sparse_lr", lr),
                                    weight_decay=case.get("sparse_wd", wd)),
        learning_rate=lr, weight_decay=wd)
    state.slots.update(coll.init_caches(state.tables, state.sparse_opt))
    step = make_sparse_train_step(coll, ctr_sparse_forward(backbone),
                                  mode=case.get("mode", "gspmd"),
                                  dedup_lookup=case.get("dedup", False))
    flush = make_cache_flush_fn(coll)
    fe = case.get("flush_every", 0)
    runs = (kl.fat_line_update.plain_runs, kr.fat_line_update_routed.plain_runs)
    losses, overs = [], []
    for i, b in enumerate(case["batches"]):
        local = {k: torch.from_numpy(v)[data_slice(mesh, v.shape[0])]
                 for k, v in b.items()}
        state, loss = step(state, local)
        losses.append(float(loss))
        if fe and (i + 1) % fe == 0 and i + 1 < len(case["batches"]):
            state, over = flush(state)
            overs.append({k: int(v) for k, v in over.items()})
    # each rank's caches, a column shard's columns gathered (the layout a
    # checkpoint holds), and whether local_arrays takes them back exactly
    live = {k: v for k, v in state.slots.items() if k.startswith(CACHE_PREFIX)}
    whole = coll.global_arrays({}, live)[1]
    back = coll.local_arrays({}, whole)[1]
    roundtrip = all(torch.equal(back[k][c], x) for k, v in live.items()
                    for c, x in v.items())
    caches = {k: {c: to_numpy(x) for c, x in v.items()} for k, v in whole.items()}
    if caches:
        state, over = flush(state)
        overs.append({k: int(v) for k, v in over.items()})
    slots = {k: v for k, v in state.slots.items() if not k.startswith(CACHE_PREFIX)}
    t, s = gather_to_numpy(coll, state.tables, slots)
    return {"losses": losses, "tables": t, "slots": s, "caches": caches,
            "cache_roundtrip": roundtrip, "overflow": overs,
            "fat_runs": kl.fat_line_update.plain_runs - runs[0],
            "routed_runs": kr.fat_line_update_routed.plain_runs - runs[1],
            "local_rows": {k: tuple(v.shape) for k, v in state.tables.items()},
            "backbone": {k: to_numpy(v) for k, v in backbone.state_dict().items()}}


def case_grouped_steps(case):
    """The same batches through the eager grouped step and the pipelined
    one (prime, step, flush) from one state: each run's losses, gathered
    tables and slots, and ``all_to_all_single`` calls per trained batch;
    and the eager per-table ``alltoall`` step's losses."""
    import torch

    from tdfo_tpu_torch.core.mesh import data_slice
    from tdfo_tpu_torch.interop import gather_to_numpy, shard_from_numpy
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.ctr import ctr_sparse_forward
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_pipelined_sparse_train_step,
        make_sparse_train_step,
    )

    mesh = _mesh(case)
    out = {}
    batches = [{k: torch.from_numpy(v)[data_slice(mesh, v.shape[0])]
                for k, v in b.items()} for b in case["batches"]]
    for run in ("eager", "pipelined", "per_table"):
        coll = _coll(dict(case, grouped=run != "per_table"), mesh)
        tables, _ = shard_from_numpy(coll, case["tables"])
        backbone = _backbone(case)
        state = SparseTrainState.create(
            backbone=backbone, tables=tables,
            sparse_opt=sparse_optimizer(case.get("kind", "adam"), lr=case["lr"],
                                        weight_decay=case["wd"]),
            learning_rate=case["lr"], weight_decay=case["wd"])
        fwd = ctr_sparse_forward(backbone)
        before = kl.fat_line_update.plain_runs
        losses, calls = [], []
        if run == "pipelined":
            pipe = make_pipelined_sparse_train_step(coll, fwd)
            with _CountA2A() as n:
                carry = pipe.prime(batches[0])
            out["prime_a2a"] = n.n
            for b in batches[1:]:
                with _CountA2A() as n:
                    state, loss, carry = pipe.step(state, b, carry)
                losses.append(float(loss))
                calls.append(n.n)
            with _CountA2A() as n:
                state, loss = pipe.flush(state, carry)
            losses.append(float(loss))
            out["flush_a2a"] = n.n
        else:
            step = make_sparse_train_step(coll, fwd, mode="alltoall")
            for b in batches:
                with _CountA2A() as n:
                    state, loss = step(state, b)
                losses.append(float(loss))
                calls.append(n.n)
        t, s = gather_to_numpy(coll, state.tables, state.slots)
        out[run] = {"losses": losses, "a2a": calls, "tables": t, "slots": s,
                    "step": state.step,
                    "fat_runs": kl.fat_line_update.plain_runs - before}
    return out


def _whole_params(model, plan, mesh):
    """A dense model's parameters by name, each PS-split block all-gathered
    over the model axis (numpy)."""
    from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_group
    from tdfo_tpu_torch.interop import to_numpy
    from tdfo_tpu_torch.parallel.collectives import all_gather_cat

    out = {}
    for name, p in model.named_parameters():
        spec = (plan or {}).get(name, ())
        if MODEL_AXIS in spec:
            p = all_gather_cat(p.detach(), axis_group(mesh, MODEL_AXIS),
                               dim=spec.index(MODEL_AXIS))
        out[name] = to_numpy(p)
    return out


def case_dense_step(case):
    """K dense-regime steps (every parameter under AdamW) on the rank's
    data slice, the model PS-partitioned when the case gives ``ps`` (the
    ``ps_min_shard_bytes`` threshold): the global losses, the whole
    parameters, the local shapes and the plan in flax paths."""
    import torch

    from tdfo_tpu_torch.core.mesh import data_slice
    from tdfo_tpu_torch.interop import dense_params_from_flax
    from tdfo_tpu_torch.models.twotower import init_twotower
    from tdfo_tpu_torch.parallel.sharding import (
        min_size_partitioner_rule,
        module_flax_paths,
        ps_shard_module_,
    )
    from tdfo_tpu_torch.train.state import TrainState
    from tdfo_tpu_torch.train.step import make_train_step

    mesh = _mesh(case)
    model = init_twotower(0, case["size_map"], case["d"], device="cpu")
    model.load_state_dict(dense_params_from_flax(case["dense"]))
    plan, paths = None, module_flax_paths(model)
    if case.get("ps"):
        plan = ps_shard_module_(model, mesh,
                                min_size_partitioner_rule(mesh, case["ps"]))
    state = TrainState.create(model=model, learning_rate=case["lr"],
                              weight_decay=case["wd"])
    step = make_train_step(mesh=mesh)
    losses = []
    for b in case["batches"]:
        local = {k: torch.from_numpy(v)[data_slice(mesh, v.shape[0])]
                 for k, v in b.items()}
        state, loss = step(state, local)
        losses.append(float(loss))
    return {"losses": losses, "params": _whole_params(model, plan, mesh),
            "local": {k: tuple(v.shape) for k, v in model.named_parameters()},
            "moments": {k: tuple(state.optimizer.state[v]["exp_avg"].shape)
                        for k, v in model.named_parameters()},
            "split": sorted(paths[n][0] for n, sp in (plan or {}).items() if sp)}


def case_ring(case):
    """``ring_self_attention`` of the case's global ``q, k, v`` (bf16 when
    ``bf16``) and ``valid`` on the case's mesh: the output and, with
    ``grad``, the gradients of ``sum(out ** 2)``, all global (f32)."""
    import torch

    from tdfo_tpu_torch.interop import to_numpy
    from tdfo_tpu_torch.parallel.ring_attention import ring_self_attention

    mesh = _mesh(case)
    dtype = torch.bfloat16 if case.get("bf16") else torch.float32
    xs = [torch.from_numpy(case[n]).to(dtype).requires_grad_(case.get("grad", False))
          for n in ("q", "k", "v")]
    valid = None if case.get("valid") is None else torch.from_numpy(case["valid"])
    out = ring_self_attention(mesh, *xs, valid, block_k=case.get("block_k"),
                              head_axis=case.get("head_axis"),
                              batch_axis=case.get("batch_axis"),
                              impl=case.get("impl", "xla"))
    res = {"out": to_numpy(out), "dtype": str(out.dtype)}
    if case.get("grad"):
        grads = torch.autograd.grad((out.float() ** 2).sum(), xs)
        res["grads"] = [to_numpy(g) for g in grads]
    return res


def _b4r(case, mesh):
    """The case's Bert4Rec ``(collection, tables, backbone)`` on ``mesh``
    (None: one device) with the reference's tables and dense parameters."""
    from tdfo_tpu_torch.interop import (
        backbone_params_from_flax,
        shard_from_numpy,
        tp_backbone_params_from_flax,
    )
    from tdfo_tpu_torch.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec

    cfg = Bert4RecConfig(**case["cfg"])
    attn, tp = case.get("attn", "full"), case.get("tp", False)
    coll, _, bb = make_sharded_bert4rec(
        cfg, mesh=mesh, attn=attn, device="cpu",
        sharding=case.get("sharding", "row"),
        fused_threshold=case.get("fused_threshold", 16),
        ring_block_k=case.get("block_k"), tp_heads=case.get("tp_heads", False),
        tensor_parallel=tp, grouped_a2a=case.get("grouped", False))
    sd = (tp_backbone_params_from_flax(case["dense"], mesh,
                                       None if attn == "flash" else cfg.n_heads)
          if tp else backbone_params_from_flax(case["dense"]))
    bb.load_state_dict(sd, strict=True)
    tables, _ = shard_from_numpy(coll, case["tables"])
    return coll, tables, bb


def case_b4r_logits(case):
    """Backbone logits of the case's item vectors and ids (eval forward)."""
    import torch

    from tdfo_tpu_torch.interop import to_numpy
    from tdfo_tpu_torch.models.bert4rec import key_padding_mask

    _, _, bb = _b4r(case, _mesh(case))
    with torch.no_grad():
        out = bb(torch.from_numpy(case["embs"]),
                 key_padding_mask(torch.from_numpy(case["ids"])))
    return {"logits": to_numpy(out)}


def _full_backbone(bb, mesh):
    """Every backbone parameter whole (tensor-parallel shards gathered over
    the model axis), by torch name."""
    from tdfo_tpu_torch.core.mesh import MODEL_AXIS, axis_group
    from tdfo_tpu_torch.interop import to_numpy
    from tdfo_tpu_torch.parallel.collectives import all_gather_cat

    out = {}
    for name, p in bb.named_parameters():
        spec = bb.tp_plan.get(name, ())
        if mesh is not None and "model" in spec:
            p = all_gather_cat(p.detach(), axis_group(mesh, MODEL_AXIS),
                               dim=spec.index("model"))
        out[name] = to_numpy(p)
    return out


def case_b4r_steps(case):
    """K Bert4Rec sparse steps (``make_sparse_train_step``, lookup
    ``mode``) on the case's mesh (None: one device), each on this rank's
    data slice of the global batch, with dropout drawn per step from
    ``dropout_generator(seed, step)`` when the config's rate is not 0: the
    global losses, the gathered tables and backbone, and the flash and
    fat-line kernels' plain runs."""
    import torch

    from tdfo_tpu_torch.core.mesh import data_slice
    from tdfo_tpu_torch.interop import gather_to_numpy
    from tdfo_tpu_torch.ops.kernels import fat_line_update as kl
    from tdfo_tpu_torch.ops.kernels import flash_attention as fa
    from tdfo_tpu_torch.ops.sparse import sparse_optimizer
    from tdfo_tpu_torch.train.seq import bert4rec_sparse_forward, dropout_generator
    from tdfo_tpu_torch.train.sparse_step import (
        SparseTrainState,
        make_pipelined_sparse_train_step,
        make_sparse_train_step,
    )

    mesh = None if case["mesh"] is None else _mesh(case)
    coll, tables, bb = _b4r(case, mesh)
    lr, wd = case["lr"], case["wd"]
    state = SparseTrainState.create(
        backbone=bb, tables=tables,
        sparse_opt=sparse_optimizer("adam", lr=lr, weight_decay=wd),
        learning_rate=lr, weight_decay=wd)
    fwd = bert4rec_sparse_forward(bb)
    counts = lambda: [fa.flash_fwd.plain_runs, fa.flash_bwd_dq.plain_runs,  # noqa: E731
                      fa.flash_bwd_dkv.plain_runs, kl.fat_line_update.plain_runs]
    before = counts()
    batches = []
    for item, label in case["batches"]:
        rows = data_slice(mesh, item.shape[0])
        batches.append({"item": torch.from_numpy(item)[rows],
                        "label": torch.from_numpy(label)[rows]})
    gen = (lambda i: dropout_generator(case["seed"], i, "cpu")  # noqa: E731
           if case["cfg"].get("dropout", 0.1) else None)
    losses = []
    if case.get("pipelined"):
        pipe = make_pipelined_sparse_train_step(coll, fwd,
                                                tensor_parallel=case.get("tp", False))
        carry = pipe.prime(batches[0])
        for b in batches[1:]:
            state, loss, carry = pipe.step(state, b, carry, gen(state.step))
            losses.append(float(loss))
        state, loss = pipe.flush(state, carry, gen(state.step))
        losses.append(float(loss))
    else:
        step = make_sparse_train_step(coll, fwd, mode=case.get("mode", "gspmd"),
                                      dedup_lookup=case.get("dedup", False),
                                      tensor_parallel=case.get("tp", False))
        for b in batches:
            state, loss = step(state, b, gen(state.step))
            losses.append(float(loss))
    runs = [a - b for a, b in zip(counts(), before)]
    return {"losses": losses, "runs": runs,
            "tables": gather_to_numpy(coll, state.tables)[0],
            "backbone": _full_backbone(bb, mesh)}


class _Killed(Exception):
    pass


def case_fit(case):
    """A ``Trainer.fit`` of the case's config (``launch.run`` of a ``train``
    command line when ``cli``; ``evaluate``: one evaluation of the fresh
    trainer instead); ``kill_at``: the run dies before that train step and
    a second trainer resumes from its checkpoints.  The metrics and the
    gathered tables."""
    import torch

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.interop import gather_to_numpy
    from tdfo_tpu_torch.train.trainer import Trainer

    torch.manual_seed(0)
    if case.get("cli"):
        from tdfo_tpu_torch import launch

        trainer = launch.run(case["argv"])
    else:
        if case.get("kill_at"):
            tr = Trainer(read_configs(None, **case["body"]), device="cpu")
            pipe = tr._pipe
            inner = tr.train_step if pipe is None else pipe.step
            calls = [0]

            def dying(*args):
                calls[0] += 1
                if calls[0] == case["kill_at"]:
                    raise _Killed
                return inner(*args)

            if pipe is None:
                tr.train_step = dying
            else:  # the pipelined loop trains through its step
                tr._pipe = pipe._replace(step=dying)
            try:
                tr.fit()
            except _Killed:
                pass
            else:
                raise AssertionError("the run was not killed")
        trainer = Trainer(read_configs(None, **case["body"]), device="cpu")
        if not case.get("evaluate"):
            trainer.fit()
    out = {"metrics": trainer.last_metrics, "step": trainer.state.step}
    if case.get("evaluate"):
        out["eval"] = trainer.evaluate(epoch=99)
    if hasattr(trainer, "coll"):
        out["tables"] = gather_to_numpy(trainer.coll, trainer.state.tables)[0]
    else:  # the dense regime: its whole parameters
        out["params"] = _whole_params(trainer.state.model, trainer._ps_plan,
                                      trainer.mesh)
    if getattr(trainer, "_seq", False):
        out["backbone"] = _full_backbone(trainer.backbone, trainer.mesh)
    return out


def counter_steps(body: dict, steps: int, batches=None) -> tuple[list, list]:
    """``steps`` train steps of a ``[telemetry] counters`` trainer of
    ``body`` (train AUC off) on its own stream, or on ``batches`` (numpy
    dicts); each step's counters as floats (the last with the cache
    write-back's after it), and the batches trained, as numpy."""
    import torch

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.train.trainer import Trainer

    tr = Trainer(read_configs(None, **dict(body, telemetry={"counters": True})),
                 device="cpu")
    tr._train_auc = None
    if batches is None:
        batches = [{k: v.numpy() for k, v in b.items()}
                   for _, (b, _) in zip(range(steps), tr._train_batches(0))]
    out = []
    for b in batches:
        tr.state, _ = tr._one_step(tr.state, {k: torch.from_numpy(v)
                                              for k, v in b.items()})
        out.append({k: float(v) for k, v in tr._step_ctrs.items()})
    if tr._cache_flush is not None:
        tr._run_cache_flush()
        out[-1].update({k: float(v) for k, v in tr._flush_ctrs.items()})
    return out, batches


def case_counters(case):
    """:func:`counter_steps` of the case's config under its mesh."""
    return counter_steps(case["body"], case["steps"])


def case_retrieval(case):
    """The case's catalogue (global f32 ``rows`` and ``ids``) as this rank's
    corpus shard at each dtype, retrieved with the same ``queries`` for
    every ``(dtype, top_k, coarse_k)`` of ``configs``; each dtype's corpus
    exported (gathered to rank 0) under ``export`` / dtype, and each
    corpus under ``load`` / dtype loaded as this rank's shard."""
    import torch

    from tdfo_tpu_torch.interop import to_numpy
    from tdfo_tpu_torch.serve.corpus import corpus_from_rows
    from tdfo_tpu_torch.serve.export import export_corpus, load_corpus
    from tdfo_tpu_torch.serve.retrieval import make_retrieval

    mesh = _mesh(case)
    rows, ids = torch.from_numpy(case["rows"]), torch.from_numpy(case["ids"])
    q = torch.from_numpy(case["queries"])
    corpora = {dt: corpus_from_rows(rows, ids, dt, mesh=mesh)
               for dt in sorted({c[0] for c in case["configs"]})}
    out = {"got": {}, "loaded": {}}
    for dt, k, coarse in case["configs"]:
        s, i = make_retrieval(corpora[dt], mesh=mesh, top_k=k, coarse_k=coarse)(q)
        out["got"][dt, k, coarse] = (to_numpy(s), to_numpy(i))
    for dt, c in corpora.items():
        export_corpus(Path(case["export"]) / dt, c, mesh=mesh)
        got = load_corpus(Path(case["load"]) / dt, mesh=mesh, device="cpu")
        out["loaded"][dt] = {
            "vectors": to_numpy(got.vectors.view(torch.int16)
                                if got.vectors.dtype == torch.bfloat16 else got.vectors),
            "ids": to_numpy(got.ids), "shard": (got.shard, got.n_shards),
            "qscale": None if got.qscale is None else to_numpy(got.qscale)}
    return out


def case_serve(case):
    """``serve_from_config`` of the case's config on this rank: its stats
    and the written bundle's digest."""
    import json

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.serve.frontend import serve_from_config

    stats = serve_from_config(read_configs(None, **case["body"]),
                              log_dir=case["log_dir"], device="cpu")
    manifest = json.loads((Path(stats["bundle"]) / "bundle.json").read_text())
    return {"stats": stats, "digest": manifest["digest"]}


def case_restore(case):
    """A trainer of the case's config restores its newest checkpoint
    (written at another world size); the step and the gathered tables."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.interop import gather_to_numpy
    from tdfo_tpu_torch.train.trainer import Trainer

    trainer = Trainer(read_configs(None, **case["body"]), device="cpu")
    step, state = trainer.restore_latest()
    if not hasattr(trainer, "coll"):  # the dense regime
        return {"step": step, "params": _whole_params(
            state.model, trainer._ps_plan, trainer.mesh)}
    return {"step": step, "tables": gather_to_numpy(trainer.coll, state.tables)[0]}


def main() -> None:
    import torch

    torch.set_num_threads(1)
    inp, out_dir, timeout = Path(sys.argv[1]), Path(sys.argv[2]), float(sys.argv[3])
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.distributed.init_process_group(
        "gloo", init_method=os.environ["TDFO_TEST_RENDEZVOUS"], rank=rank,
        world_size=world)
    deadline = time.monotonic() + timeout
    while not inp.exists():  # the test is still building the cases
        if time.monotonic() > deadline:
            sys.exit(f"rank {rank}: no cases in {inp} after {timeout} s")
        time.sleep(0.02)
    cases = pickle.loads(inp.read_bytes())
    results = {}
    for name, case in cases.items():
        fn = globals()["case_" + case["fn"]]
        expect = case.get("expect")
        if expect is None:
            results[name] = fn(case)
            continue
        try:
            fn(case)
        except Exception as e:  # noqa: BLE001 (the expected refusal is checked)
            if type(e).__name__ != expect:
                traceback.print_exc()
                raise
            results[name] = {"raised": type(e).__name__, "message": str(e)}
        else:
            results[name] = {"raised": None}
    (out_dir / f"rank{rank}_{world}.pkl").write_bytes(pickle.dumps(results))
    # every rank done with its collectives, then out without the process
    # group's teardown (gloo's threads can abort a tearing-down process)
    torch.distributed.barrier()
    sys.stdout.flush()
    os._exit(0)


if __name__ == "__main__":
    main()
