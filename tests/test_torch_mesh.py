"""``core/mesh.py`` and ``parallel/sharding.py`` against the JAX package.

* ``_resolve_sizes`` takes the reference's cases (``tests/test_mesh.py``:
  the wildcard, full data parallelism, bad sizes) to the same sizes or the
  same errors;
* ``initialize_distributed`` reads torchrun's variables and is a no-op at
  one rank unless forced;
* on four gloo ranks (``tests/torch_dist_worker.py``), a ``MeshSpec(data=2,
  model=2)`` mesh is named ``("data", "model", "seq")`` with data
  outermost: rank r sits at ``(r // 2, r % 2, 0)``, as the reference's
  ``make_mesh`` lays ``jax.devices()`` out; a seq axis is innermost, and
  ``plane_group`` and ``seq_slice`` follow the layout;
* the placement rules give the reference's plans, ``megatron_tp_rule``'s
  included.
"""

import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
from torch_dist_worker import run_ranks

from tdfo_tpu.core import mesh as jmesh
from tdfo_tpu.core.config import MeshSpec as JMeshSpec
from tdfo_tpu.core.mesh import make_mesh
from tdfo_tpu_torch.core import mesh as tmesh
from tdfo_tpu_torch.core.config import MeshSpec as TMeshSpec


@pytest.mark.parametrize("sizes,n", [
    ((-1, 2, 1), 8), ((-1, 1, 1), 8), ((3, 2, 1), 8), ((-1, -1, 1), 8),
    ((2, 2, 1), 4), ((1, 2, 1), 2), ((1, 1, 1), 1), ((-1, 3, 1), 8),
])
def test_resolve_sizes_matches_the_reference(sizes, n):
    try:
        want = jmesh._resolve_sizes(JMeshSpec(*sizes), n)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" ")[0]):
            tmesh._resolve_sizes(TMeshSpec(*sizes), n)
        return
    assert tmesh._resolve_sizes(TMeshSpec(*sizes), n) == want


def test_initialize_distributed_reads_the_environment(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.initialize_distributed("cpu") is False
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        tmesh.make_mesh(TMeshSpec(), device="cpu")
    # forced at one rank: a one-rank gloo group from the variables given
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    try:
        assert tmesh.initialize_distributed("cpu", force=True) is True
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = tmesh.make_mesh(TMeshSpec(), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model", "seq")
        assert tmesh.axis_size(mesh, "data") == 1
        assert tmesh.data_slice(mesh, 8) == slice(0, 8)
    finally:
        dist.destroy_process_group()


def test_mesh_layout_over_four_ranks():
    cases = {"m22": dict(fn="mesh_info", mesh=(2, 2)),
             "m14": dict(fn="mesh_info", mesh=(1, 4)),
             "m122": dict(fn="mesh_info", mesh=(1, 2, 2))}
    res = run_ranks(4, cases, Path(tempfile.mkdtemp(prefix="mesh4_")))
    jm = make_mesh(JMeshSpec(data=2, model=2, seq=1), devices=jax.devices()[:4])
    dev = np.asarray(jm.devices)
    for r, out in enumerate(res):
        m = out["m22"]
        assert m["names"] == ("data", "model", "seq")
        assert m["sizes"] == (2, 2, 1)
        assert m["coords"] == (r // 2, r % 2, 0)
        # the reference's device at the same coordinates is device r
        assert dev[m["coords"]].id == jax.devices()[r].id
        assert m["lines"]["model"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert m["lines"]["data"] == [r % 2, 2 + r % 2]
        assert m["lines"]["seq"] == [r]
        assert out["m14"]["coords"] == (0, r, 0)
        assert out["m14"]["lines"]["model"] == [0, 1, 2, 3]
        assert m["plane"] == [0, 1, 2, 3] and m["seq_slice"] == slice(0, 8)
        # data 1 x model 2 x seq 2: rank r at (0, r // 2, r % 2); its model
        # line shares its seq index, its data x model plane too
        s = out["m122"]
        assert s["coords"] == (0, r // 2, r % 2)
        assert s["lines"]["seq"] == [2 * (r // 2), 2 * (r // 2) + 1]
        assert s["lines"]["model"] == s["plane"] == [r % 2, 2 + r % 2]
        assert s["seq_slice"] == slice(4 * (r % 2), 4 * (r % 2) + 4)


class _Sizes:
    """A stand-in mesh exposing only the axis sizes the rules read."""

    def __init__(self, data, model, seq=1):
        self.sizes = (data, model, seq)

    def size(self, dim):
        return self.sizes[dim]

    def get_local_rank(self, axis):
        return 1 if axis == "model" else 0


def test_sharding_rules_match_the_reference_plans():
    from jax.sharding import PartitionSpec as P

    from tdfo_tpu.models.twotower import TwoTower, dummy_batch
    from tdfo_tpu.parallel import sharding as jsh
    from tdfo_tpu_torch.parallel import sharding as tsh

    jmesh = make_mesh(JMeshSpec(data=4, model=2, seq=1))
    tmesh = _Sizes(4, 2)
    sizes = {"user": 100, "item": 150, "language": 5, "is_ebook": 2,
             "format": 4, "publisher": 7, "pub_decade": 6}
    # the reference's init_twotower, its init jitted (the same params)
    params = jax.jit(TwoTower(size_map=sizes, embed_dim=8).init)(
        jax.random.key(0), dummy_batch())["params"]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    cases = [((jsh.min_size_partitioner_rule(jmesh, 512),),
              (tsh.min_size_partitioner_rule(tmesh, 512),)),
             ((jsh.rowwise_embedding_rule(jmesh),), (tsh.rowwise_embedding_rule(tmesh),)),
             ((jsh.rowwise_embedding_rule(jmesh, min_rows=50),
               jsh.min_size_partitioner_rule(jmesh, 2048)),
              (tsh.rowwise_embedding_rule(tmesh, min_rows=50),
               tsh.min_size_partitioner_rule(tmesh, 2048)))]
    for jrules, trules in cases:
        jplan = jsh.make_sharding_plan(params, jmesh, *jrules)
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    jplan, is_leaf=lambda x: hasattr(x, "spec"))}
        got = tsh.make_sharding_plan(flat, tmesh, *trules)
        assert got == {k: tuple(v) if v != P() else () for k, v in want.items()}
        assert any(v for v in got.values())
        local = tsh.shard_state(flat, tmesh, *trules)
        for k, spec in got.items():
            if spec:  # model index 1 keeps the second half of the rows
                n = flat[k].shape[0] // 2
                np.testing.assert_array_equal(local[k], flat[k][n:])
    # Megatron tensor parallelism: the reference's plan of a Bert4Rec
    # backbone's tree, head guard included
    from tdfo_tpu.models.bert4rec import Bert4RecConfig, make_sharded_bert4rec

    # the plans read shapes only: the backbone's tree traced, not drawn
    b4r = Bert4RecConfig(n_items=40, max_len=8, embed_dim=16, n_heads=2, n_layers=1)
    dense = jax.eval_shape(lambda k: make_sharded_bert4rec(
        k, b4r, None, sharding="replicated")[3], jax.random.key(0))
    dflat = {"/".join(str(getattr(k, "key", k)) for k in path):
             np.empty(v.shape, v.dtype)
             for path, v in jax.tree_util.tree_leaves_with_path(dense)}
    for n_heads in (2, None):
        jplan = jsh.make_sharding_plan(dense, jmesh,
                                       jsh.megatron_tp_rule(jmesh, n_heads=n_heads))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    jplan, is_leaf=lambda x: hasattr(x, "spec"))}
        got = tsh.make_sharding_plan(dflat, tmesh,
                                     tsh.megatron_tp_rule(tmesh, n_heads=n_heads))
        assert got == {k: tuple(v) for k, v in want.items()}
    assert got["block_0/ff/fc1/kernel"] == (None, "model")
    with pytest.raises(ValueError, match="n_heads"):
        tsh.megatron_tp_rule(tmesh, n_heads=3)("block_0/attn/qkv/kernel",
                                                dflat["block_0/attn/qkv/kernel"])
