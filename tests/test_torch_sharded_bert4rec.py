"""Bert4Rec across ranks: K = 3 sparse steps with dropout on, on gloo
ranks (``tests/torch_dist_worker.py``; two and four ranks, each spawned
once for the file), against the port's one-device step on the same
tables, parameters and batches (the masks are drawn at the global shape,
so a sharded run draws what one device draws), and at dropout 0 against
the JAX step:

* data 1 x model 2 (the item table row-sharded) under ``gspmd`` and
  ``psum``: bitwise; ``dedup_lookup`` under ``gspmd``, and ``alltoall``
  (per table, grouped, and the pipelined step): rtol 1e-4;
* data 2: rtol 1e-4;
* seq 2 under ``ring`` and ``ring_flash`` against one-device full
  attention: rtol 1e-4; ``ring_flash`` runs each flash kernel 2 (ranks of
  the ring) x 2 (layers) times a step, and ``fat_line_update`` once;
* model 2 ``tensor_parallel`` (full attention): the plan equals the
  reference's ``make_sharding_plan(..., megatron_tp_rule(mesh, n_heads))``,
  a head count the axis does not divide raises, and the trajectory holds
  at rtol 1e-4;
* seq 2 x model 2, ``ring_flash`` with ``tp_heads`` (four ranks), with
  tensor parallelism and without it (the ring then splits the heads
  itself);
* a world-2 ``Trainer.fit`` under ``tensor_parallel`` over jagged shards
  equals the world-1 fit, and its checkpoint restores at world 1; a seq-2
  ``ring_flash`` checkpoint restores at world 1 bitwise;
* the pipelined ``Trainer.fit`` ends bitwise where the eager grouped
  fit does;
* model 2 ``tensor_parallel`` under the ``alltoall`` lookup (each rank's
  looked-up share gathered over model before the Megatron blocks): the
  steps and a jagged ``Trainer.fit`` hold rtol 1e-4 against one device,
  and the steps against the reference at dropout 0;
* hot/cold storage refuses by name for Bert4Rec.

The key bias of each attention layer gets gradients of float noise only
(softmax is invariant to it), which Adam scales up to a full step: it is
held to its bound (3 lr), not the ladder, as in
``tests/test_torch_bert4rec.py``.
"""

import functools
import json
import shutil
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch_dist_worker import Ranks, case_b4r_steps

from tdfo_tpu.models import bert4rec as jb4r
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.train import seq as jseq
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax

N_ITEMS, T, D, H, LAYERS, B, K = 60, 8, 16, 2, 2, 4, 3
LR, WD, SEED = 3e-4, 1e-4, 7
CFG = dict(n_items=N_ITEMS, max_len=T, embed_dim=D, n_heads=H, n_layers=LAYERS)

# name -> (world, mesh (data, model, seq), case options)
LAYOUTS = {
    "gspmd_m2": (2, (1, 2, 1), dict(mode="gspmd")),
    "psum_m2": (2, (1, 2, 1), dict(mode="psum")),
    "dedup_m2": (2, (1, 2, 1), dict(mode="gspmd", dedup=True)),
    "a2a_m2": (2, (1, 2, 1), dict(mode="alltoall")),
    "grouped_m2": (2, (1, 2, 1), dict(mode="alltoall", grouped=True)),
    "pipelined_m2": (2, (1, 2, 1), dict(grouped=True, pipelined=True)),
    "data2": (2, (2, 1, 1), dict(mode="gspmd")),
    "ring_s2": (2, (1, 1, 2), dict(attn="ring")),
    "ring_flash_s2": (2, (1, 1, 2), dict(attn="ring_flash")),
    "tp_m2": (2, (1, 2, 1), dict(tp=True)),
    # alltoall's shares gathered over model before the Megatron blocks
    "tp_a2a_m2": (2, (1, 2, 1), dict(mode="alltoall", tp=True)),
    "tp_heads_s2m2": (4, (1, 2, 2), dict(attn="ring_flash", tp=True, tp_heads=True)),
    # the ring's own head split over model, the backbone whole
    "heads_s2m2": (4, (1, 2, 2), dict(attn="ring_flash", tp_heads=True)),
}
BITWISE = {"gspmd_m2", "psum_m2"}
JAX_RUNG = ("data2", "ring_flash_s2", "tp_m2", "tp_a2a_m2", "tp_heads_s2m2")


def _batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(K):
        item = rng.integers(1, N_ITEMS + 1, (B, T)).astype(np.int32)
        masked = rng.random((B, T)) < 0.3
        masked[:, 0] = True
        label = np.where(masked, item, 0).astype(np.int32)
        item = np.where(masked, N_ITEMS + 1, item).astype(np.int32)
        item[1, T - 3:] = 0  # a padded tail
        label[1, T - 3:] = 0
        out.append((item, label))
    return out


@functools.lru_cache(maxsize=None)
def _initial():
    _, jtables, _, dense = jb4r.make_sharded_bert4rec(
        jax.random.key(SEED), jb4r.Bert4RecConfig(**CFG), None, attn="full",
        fused_threshold=16)
    return ({k: np.asarray(v) for k, v in jtables.items()},
            jax.tree.map(np.asarray, dense))


def _case(opts, dropout, mesh):
    tables, dense = _initial()
    return dict(fn="b4r_steps", mesh=mesh, cfg=dict(CFG, dropout=dropout),
                tables=tables, dense=dense, batches=_batches(), lr=LR, wd=WD,
                seed=SEED, fused_threshold=16, **opts)


def _toml(d: dict) -> str:
    lines, tables = [], []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append(f"[{k}]\n" + "".join(f"{a} = {json.dumps(b)}\n"
                                               for a, b in v.items()))
        else:
            lines.append(f"{k} = {json.dumps(v)}")
    return "\n".join(lines) + "\n" + "\n".join(tables)


@functools.lru_cache(maxsize=None)
def _seq_data(jagged: bool) -> tuple[Path, dict]:
    from tdfo_tpu_torch import launch

    root = Path(tempfile.mkdtemp(prefix="b4r_seq_"))
    cfg = root / "prep.toml"
    cfg.write_text(_toml(dict(data_dir=str(root / "d"), model="bert4rec",
                              max_len=T, sliding_step=4, jagged=jagged)))
    for cmd in ("synth", "preprocess-seq"):
        assert launch.main([cmd, "--config", str(cfg)]) == 0
    return root, json.loads((root / "d" / "size_map_bert4rec.json").read_text())


def _fit_body(name, jagged, **kw):
    root, size_map = _seq_data(jagged)
    body = dict(data_dir=str(root / "d"), model="bert4rec", max_len=T,
                sliding_step=4, jagged=jagged, embed_dim=D, n_heads=H,
                n_layers=LAYERS, n_epochs=1, learning_rate=LR, weight_decay=WD,
                per_device_train_batch_size=64, per_device_eval_batch_size=32,
                log_every_n_steps=2, fused_table_threshold=16, size_map=size_map,
                model_parallel=True,
                seed=SEED, checkpoint_dir=str(root / name),
                checkpoint_every_n_steps=4)
    body.update(kw)
    return body


_GROUPED = dict(mesh={"data": 1, "model": 2}, lookup_mode="alltoall",
                embeddings={"grouped_a2a": True})
FITS = {  # world-2 fits: name -> (jagged, config keys)
    "fit_tp_jagged": (True, dict(mesh={"data": 1, "model": 2},
                                 tensor_parallel=True)),
    "fit_ring_flash": (False, dict(mesh={"data": 1, "model": 1, "seq": 2},
                                   attn="ring_flash")),
    "fit_grouped": (False, _GROUPED),
    "fit_pipelined": (False, dict(_GROUPED, train={"pipeline_overlap": True})),
}


@functools.lru_cache(maxsize=None)
def _runs():
    """``(one-device and reference results, {world: each rank's results})``;
    the steps at worlds 2 and 4 and the world-2 fits run in three sets of
    rank processes at once (``"fits"``: the fits')."""
    ranks = {w: Ranks(2 if w == "fits" else w,
                      Path(tempfile.mkdtemp(prefix=f"b4r_{w}_")))
             for w in (2, 4, "fits")}
    try:
        return _run_sets(ranks)
    except BaseException:
        # no set of a failed run goes on writing beside the next one
        for r in ranks.values():
            r.kill()
        raise


def _run_sets(ranks):
    cases: dict = {2: {}, 4: {}, "fits": {}}
    for name, (world, mesh, opts) in LAYOUTS.items():
        cases[world][name] = _case(opts, 0.1, mesh)
        if name in JAX_RUNG:
            cases[world][name + "@0"] = _case(opts, 0.0, mesh)
    ranks[2].send(cases[2])
    ranks[4].send(cases[4])
    for name, (jagged, kw) in FITS.items():
        cases["fits"][name] = dict(fn="fit", body=_fit_body(name, jagged, **kw))
    cases["fits"]["tp_alltoall"] = dict(fn="fit", body=_fit_body(
        "tp_alltoall", True, mesh={"data": 1, "model": 2}, tensor_parallel=True,
        lookup_mode="alltoall"))
    # a run after a failed one starts its fits over, not from the
    # checkpoints the failed set left
    for case in cases["fits"].values():
        shutil.rmtree(case["body"]["checkpoint_dir"], ignore_errors=True)
    ranks["fits"].send(cases["fits"])
    # the one-device side and the reference while the ranks run
    refs = {"port": {}, "jax": _jax_run()}
    for name, (_, _, opts) in LAYOUTS.items():
        key = (opts.get("mode", "gspmd"), opts.get("dedup", False))
        if key not in refs["port"]:
            refs["port"][key] = case_b4r_steps(_case(
                {"mode": key[0], "dedup": key[1]}, 0.1, None))
    return refs, {w: r.wait() for w, r in ranks.items()}


def _jax_run():
    """The reference's sparse step at dropout 0 (full attention, one
    device): losses, tables, backbone (torch names)."""
    tables, dense = _initial()
    jcoll, _, jbb, _ = jb4r.make_sharded_bert4rec(
        jax.random.key(SEED), jb4r.Bert4RecConfig(**CFG, dropout=0.0), None,
        attn="full", fused_threshold=16)
    state = JState.create(dense_params=jax.tree.map(jnp.asarray, dense),
                          tx=optax.adamw(LR, weight_decay=WD),
                          tables={k: jnp.asarray(v) for k, v in tables.items()},
                          sparse_opt=j_opt("adam", lr=LR, weight_decay=WD))
    run = j_step(jcoll, jseq.bert4rec_sparse_forward(jbb), donate=False)
    losses = []
    for item, label in _batches():
        state, loss = run(state, {"item": jnp.asarray(item),
                                  "label": jnp.asarray(label)})
        losses.append(float(loss))
    return {"losses": losses,
            "tables": {k: np.asarray(v) for k, v in state.tables.items()},
            "backbone": {k: v.numpy() for k, v in backbone_params_from_flax(
                jax.tree.map(np.asarray, state.dense_params)).items()}}


def _close(got, want, exact=False):
    """``got`` (a run's losses, tables and backbone) against ``want``:
    bitwise, or at the trajectory rung (the key biases to their bound)."""
    rtol, atol = TOL["trajectory"]
    if exact:
        assert got["losses"] == want["losses"]
    else:
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=rtol, atol=atol)
    for k, v in want["tables"].items():
        if exact:
            np.testing.assert_array_equal(got["tables"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["tables"][k], v, rtol=rtol, atol=atol,
                                       err_msg=k)
    start = backbone_params_from_flax(_initial()[1])
    for name, v in want["backbone"].items():
        g = got["backbone"][name]
        if exact:
            np.testing.assert_array_equal(g, v, err_msg=name)
            continue
        if name.endswith("attn.qkv.bias"):  # (head, qkv, dh) order
            g, v, p0 = (x.reshape(H, 3, D // H) for x in (g, v, start[name].numpy()))
            for x in (g[:, 1], v[:, 1]):
                assert np.abs(x - p0[:, 1]).max() <= K * LR * 1.01, name
            g, v = g[:, 0::2], v[:, 0::2]
        np.testing.assert_allclose(g, v, rtol=rtol, atol=atol, err_msg=name)


def _layout(name):
    world = LAYOUTS[name][0]
    refs, res = _runs()
    got = res[world]
    for r in got[1:]:  # every rank reports the same global state
        assert r[name]["losses"] == got[0][name]["losses"]
    return refs, got[0]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_steps_match_the_one_device_step(name):
    refs, got = _layout(name)
    opts = LAYOUTS[name][2]
    want = refs["port"][(opts.get("mode", "gspmd"), opts.get("dedup", False))]
    _close(got[name], want, exact=name in BITWISE)
    flash, dq, dkv, fat = got[name]["runs"]
    # one fat-line update a step on each rank; the ring's flash kernels
    # run P times a layer a step, forward and backward
    assert fat == K
    p = LAYOUTS[name][1][2] if opts.get("attn") == "ring_flash" else 0
    assert (flash, dq, dkv) == (K * LAYERS * p,) * 3


@pytest.mark.parametrize("name", JAX_RUNG)
def test_sharded_steps_match_the_reference_at_dropout_zero(name):
    refs, got = _layout(name)
    _close(got[name + "@0"], refs["jax"])


def test_tensor_parallel_plan_matches_the_reference():
    from tdfo_tpu.core.config import MeshSpec
    from tdfo_tpu.core.mesh import make_mesh
    from tdfo_tpu.parallel import sharding as jsh
    from tdfo_tpu_torch.models.bert4rec import Bert4RecBackbone, Bert4RecConfig
    from tdfo_tpu_torch.parallel import sharding as tsh

    _, dense = _initial()
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(dense)}

    class Sizes:
        def __init__(self, model):
            self.sizes = (1, model, 1)

        def size(self, dim):
            return self.sizes[dim]

    for model, n_heads in ((2, H), (2, None), (4, H * 2)):
        jmesh = make_mesh(MeshSpec(data=1, model=model, seq=1),
                          devices=jax.devices()[:model])
        jplan = jsh.make_sharding_plan(dense, jmesh,
                                       jsh.megatron_tp_rule(jmesh, n_heads=n_heads))
        want = {"/".join(str(getattr(k, "key", k)) for k in path): tuple(s.spec)
                for path, s in jax.tree_util.tree_leaves_with_path(
                    jplan, is_leaf=lambda x: hasattr(x, "spec"))}
        got = tsh.make_sharding_plan(flat, Sizes(model),
                                     tsh.megatron_tp_rule(Sizes(model), n_heads=n_heads))
        assert got == want
    # the port's module plan is the same plan in torch layout
    bb = Bert4RecBackbone(Bert4RecConfig(**CFG))
    plan = tsh.module_plan(bb, Sizes(2), tsh.megatron_tp_rule(Sizes(2), n_heads=H))
    assert plan["block_0.attn.qkv.weight"] == ("model", None)
    assert plan["block_0.attn.out.weight"] == (None, "model")
    assert plan["block_1.ff.fc2.bias"] == () and plan["out_proj.bias"] == ("model",)
    # a vocab the axis does not divide stays whole: 62 splits over 2, not 4
    plan4 = tsh.module_plan(bb, Sizes(4), tsh.megatron_tp_rule(Sizes(4), n_heads=4))
    assert plan4["out_proj.weight"] == () and plan4["block_0.ff.fc1.weight"] == ("model", None)
    with pytest.raises(ValueError, match=r"n_heads \(2\)"):
        tsh.module_plan(bb, Sizes(4), tsh.megatron_tp_rule(Sizes(4), n_heads=H))


def _one_rank_fit(name, jagged, **kw):
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.train.trainer import Trainer

    tr = Trainer(read_configs(None, **_fit_body(name, jagged, **kw)), device="cpu")
    return tr, tr.fit()


def _restored(name, jagged, **kw):
    """A world-1 trainer restored from ``name``'s checkpoints: its step,
    tables and backbone."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.interop import gather_to_numpy
    from tdfo_tpu_torch.train.trainer import Trainer

    tr = Trainer(read_configs(None, **_fit_body(name, jagged, **kw)), device="cpu")
    step, state = tr.restore_latest()
    return (step, gather_to_numpy(tr.coll, state.tables)[0],
            {k: v.detach().numpy() for k, v in tr.backbone.named_parameters()})


def test_tensor_parallel_jagged_fit_matches_world_one_and_restores():
    _, res = _runs()
    _, want = _one_rank_fit("w1_tp_jagged", True, tensor_parallel=True)
    rtol, _ = TOL["trajectory"]
    for r in res["fits"]:
        got = r["fit_tp_jagged"]["metrics"]
        assert got.keys() == want.keys() and len(got) == 12
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6, err_msg=k)
    step, tables, backbone = _restored("fit_tp_jagged", True, tensor_parallel=True)
    ran = res["fits"][0]["fit_tp_jagged"]
    assert step == ran["step"] > 0
    for k, v in ran["tables"].items():
        np.testing.assert_array_equal(tables[k], v, err_msg=k)
    for k, v in ran["backbone"].items():
        np.testing.assert_array_equal(backbone[k], v, err_msg=k)


def test_pipelined_fit_equals_the_eager_grouped_fit():
    """``Trainer.fit`` through the pipelined step (each batch's id exchange
    issued one call ahead, the dropout generator of the step it trains)
    ends bitwise where the eager grouped fit does."""
    _, res = _runs()
    for r in res["fits"]:
        a, b = r["fit_pipelined"], r["fit_grouped"]
        assert a["metrics"] == b["metrics"] and a["step"] == b["step"] > 0
        for k, v in b["tables"].items():
            np.testing.assert_array_equal(a["tables"][k], v, err_msg=k)
        for k, v in b["backbone"].items():
            np.testing.assert_array_equal(a["backbone"][k], v, err_msg=k)


def test_tensor_parallel_alltoall_fit_matches_world_one():
    """A world-2 ``Trainer.fit`` under ``tensor_parallel`` with the
    ``alltoall`` lookup (the reference trains this pair too) ends at the
    world-1 fit's metrics, at the trajectory rung."""
    _, res = _runs()
    _, want = _one_rank_fit("w1_tp_a2a", True, tensor_parallel=True)
    rtol, _ = TOL["trajectory"]
    for r in res["fits"]:
        got = r["tp_alltoall"]["metrics"]
        assert r["tp_alltoall"]["step"] > 0 and got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=rtol, atol=1e-6, err_msg=k)


def test_knobs_that_do_not_compose_refuse_by_name():
    """Hot/cold storage, a CTR table form, refuses for Bert4Rec;
    tensor parallelism with the alltoall lookup no longer refuses
    (``test_tensor_parallel_alltoall_fit_matches_world_one``)."""
    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.train.trainer import Trainer

    _, res = _runs()
    for r in res["fits"]:
        assert "raised" not in r["tp_alltoall"], r["tp_alltoall"]
    with pytest.raises(ValueError, match="hot_vocab"):
        Trainer(read_configs(None, **_fit_body("hot", False,
                                               embeddings={"hot_vocab": 8})),
                device="cpu")


def test_ring_flash_checkpoint_restores_at_world_one():
    _, res = _runs()
    step, tables, backbone = _restored("fit_ring_flash", False, attn="flash")
    ran = res["fits"][0]["fit_ring_flash"]
    assert step == ran["step"] > 0
    assert ran["metrics"] == res["fits"][1]["fit_ring_flash"]["metrics"]
    for k, v in ran["tables"].items():
        np.testing.assert_array_equal(tables[k], v, err_msg=k)
    for k, v in ran["backbone"].items():
        np.testing.assert_array_equal(backbone[k], v, err_msg=k)
