"""Bert4Rec of the PyTorch port against the JAX package, on the CPU.

* The flax ``Bert4RecBackbone`` is initialised in JAX and carried over with
  ``interop.backbone_params_from_flax`` (``load_state_dict(strict=True)``);
  logits agree at ``TOL["logits"]`` for ``attn = "full"`` and ``"flash"``
  (the JAX flash kernel in interpret mode, as ``make_sharded_bert4rec``
  runs it off a TPU), one layer deep: at two layers the logits reach |7.7|
  and f32 rounding (2.6e-6 at most) exceeds the ladder's absolute 1e-6 on
  a few near-zero logits (``ROADMAP.md`` Queue C).
* ``masked_ce_loss`` (an all-PAD batch gives 0), ``score_candidates`` and
  ``recalls_and_ndcgs_for_ks`` (tied scores rank the lower index first) at
  ``TOL["logits"]``.
* A 3-step sparse trajectory at dropout 0 (dropout draws cannot match
  across the two RNGs): fat item table (``fused_threshold`` below the
  vocab), d = 16, 1 layer, 2 heads, T = 12, B = 8, flash attention; losses,
  the fat item array and the dense params at ``TOL["trajectory"]``.  One
  exception: the key part of the fused qkv bias has an exactly zero
  gradient (it adds the same q.b to every logit of a row), so each package's
  AdamW steps it by about ``lr`` in the direction of its own rounding noise;
  there both are held to that bound instead (``ROADMAP.md`` Queue C).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tdfo_tpu.models import bert4rec as jb4r
from tdfo_tpu.ops.sparse import sparse_optimizer as j_opt
from tdfo_tpu.train import metrics as jmetrics
from tdfo_tpu.train import seq as jseq
from tdfo_tpu.train.sparse_step import SparseTrainState as JState
from tdfo_tpu.train.sparse_step import make_sparse_train_step as j_step
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax, tables_from_numpy
from tdfo_tpu_torch.models import bert4rec as tb4r
from tdfo_tpu_torch.ops.kernels import fat_line_update as tk
from tdfo_tpu_torch.ops.kernels import flash_attention as fa
from tdfo_tpu_torch.ops.sparse import sparse_optimizer as t_opt
from tdfo_tpu_torch.train import metrics as tmetrics
from tdfo_tpu_torch.train import seq as tseq
from tdfo_tpu_torch.train.sparse_step import SparseTrainState as TState
from tdfo_tpu_torch.train.sparse_step import make_sparse_train_step as t_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these steps are tiny, and the suite runs
    several test processes at once, whose thread pools would otherwise
    oversubscribe the cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_ITEMS, D, T, B, LR, WD = 300, 16, 12, 8, 3e-4, 1e-4


def _cfgs(n_layers=1, dropout=0.0):
    kw = dict(n_items=N_ITEMS, max_len=T, embed_dim=D, n_heads=2,
              n_layers=n_layers, dropout=dropout)
    return jb4r.Bert4RecConfig(**kw), tb4r.Bert4RecConfig(**kw)


def _seqs(rng, b=B, all_pad_row=False):
    """Items in [1, n_items], 20% replaced by MASK and labelled, some rows
    PAD-padded at the tail (as preprocess-seq pads train windows)."""
    item = rng.integers(1, N_ITEMS + 1, (b, T)).astype(np.int32)
    masked = rng.random((b, T)) < 0.2
    masked[:, 0] = True  # every row has a label
    label = np.where(masked, item, 0).astype(np.int32)
    item = np.where(masked, N_ITEMS + 1, item).astype(np.int32)
    for r in range(0, b, 3):
        cut = int(rng.integers(T // 2, T))
        item[r, cut:] = 0
        label[r, cut:] = 0
    if all_pad_row:
        item[-1] = 0
        label[-1] = 0
    return item, label


def _backbones(attn, n_layers=1):
    jcfg, tcfg = _cfgs(n_layers)
    _, jtables, jbb, dense = jb4r.make_sharded_bert4rec(
        jax.random.key(0), jcfg, None, attn=attn, fused_threshold=100)
    tfn = {"full": tb4r.dot_product_attention, "flash": tb4r.flash_attn_fn}[attn]
    tbb = tb4r.Bert4RecBackbone(tcfg, tfn)
    tbb.load_state_dict(backbone_params_from_flax(
        jax.tree.map(np.asarray, dense)), strict=True)
    return jtables, jbb, dense, tbb


@pytest.mark.parametrize("attn", ["full", "flash"])
def test_backbone_logits_match_jax(attn):
    rng = np.random.default_rng(1)
    _, jbb, dense, tbb = _backbones(attn)
    item, _ = _seqs(rng, all_pad_row=True)
    embs = rng.uniform(-1, 1, (B, T, D)).astype(np.float32)
    want = jax.jit(lambda e, i: jbb.apply({"params": dense}, e,
                                          jb4r.key_padding_mask(i)))(
        jnp.asarray(embs), jnp.asarray(item))
    before = fa.flash_fwd.plain_runs
    with torch.no_grad():
        got = tbb(torch.from_numpy(embs),
                  tb4r.key_padding_mask(torch.from_numpy(item)))
    assert fa.flash_fwd.plain_runs - before == (1 if attn == "flash" else 0)
    assert got.shape == (B, T, N_ITEMS + 2)
    rtol, atol = TOL["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_interop_carries_every_backbone_param():
    _, _, dense, tbb = _backbones("full")
    sd = backbone_params_from_flax(jax.tree.map(np.asarray, dense))
    assert set(sd) == set(tbb.state_dict())
    np.testing.assert_array_equal(sd["block_0.attn.qkv.weight"].numpy(),
                                  np.asarray(dense["block_0"]["attn"]["qkv"]["kernel"]).T)
    np.testing.assert_array_equal(sd["ln_in.weight"].numpy(),
                                  np.asarray(dense["ln_in"]["scale"]))
    assert tbb.ln_in.eps == 1e-6  # flax LayerNorm's epsilon


def test_masked_ce_loss_and_scores_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((B, T, 50)).astype(np.float32) * 3
    labels = rng.integers(1, 50, (B, T)).astype(np.int32)
    labels[rng.random((B, T)) < 0.6] = 0
    rtol, atol = TOL["logits"]
    for smoothing in (0.1, 0.0):
        want = jseq.masked_ce_loss(jnp.asarray(logits), jnp.asarray(labels),
                                   label_smoothing=smoothing)
        got = tseq.masked_ce_loss(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  label_smoothing=smoothing)
        np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)
    pad = tseq.masked_ce_loss(torch.from_numpy(logits),
                              torch.zeros((B, T), dtype=torch.int32))
    assert float(pad) == 0.0  # no labels: 0, not NaN
    cands = rng.integers(0, 50, (B, 11)).astype(np.int32)
    np.testing.assert_array_equal(
        tseq.score_candidates(torch.from_numpy(logits),
                              torch.from_numpy(cands)).numpy(),
        np.asarray(jseq.score_candidates(jnp.asarray(logits), jnp.asarray(cands))))


def test_recalls_and_ndcgs_match_jax_with_ties():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, (16, 30)).astype(np.float32)  # many ties
    labels = np.zeros((16, 30), np.float32)
    labels[:, 0] = 1.0
    labels[::4, 5] = 1.0  # some rows with two positives
    w = np.ones(16, np.float32)
    w[-3:] = 0.0  # padded rows
    ks = (1, 5, 10, 50)  # 50 > C: ranks every candidate
    want = jmetrics.recalls_and_ndcgs_for_ks(jnp.asarray(scores), jnp.asarray(labels),
                                             ks=ks, row_weights=jnp.asarray(w))
    got = tmetrics.recalls_and_ndcgs_for_ks(torch.from_numpy(scores),
                                            torch.from_numpy(labels), ks=ks,
                                            row_weights=torch.from_numpy(w))
    assert set(got) == set(want)
    rtol, atol = TOL["logits"]
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


def test_three_step_sparse_trajectory_matches_jax():
    rng = np.random.default_rng(4)
    jcfg, tcfg = _cfgs(n_layers=1)
    jcoll, jtables, jbb, dense = jb4r.make_sharded_bert4rec(
        jax.random.key(5), jcfg, None, attn="flash", fused_threshold=100)
    jstate = JState.create(dense_params=dense,
                           tx=optax.adamw(LR, weight_decay=WD), tables=jtables,
                           sparse_opt=j_opt("adam", lr=LR, weight_decay=WD))
    jrun = j_step(jcoll, jseq.bert4rec_sparse_forward(jbb), donate=False)

    tcoll, _, tbb = tb4r.make_sharded_bert4rec(
        tcfg, attn="flash", fused_threshold=100, device="cpu")
    start = backbone_params_from_flax(jax.tree.map(np.asarray, dense))
    tbb.load_state_dict(start, strict=True)
    tstate = TState.create(
        backbone=tbb,
        tables=tables_from_numpy({k: np.asarray(v) for k, v in jtables.items()}),
        sparse_opt=t_opt("adam", lr=LR, weight_decay=WD), learning_rate=LR,
        weight_decay=WD)
    trun = t_step(tcoll, tseq.bert4rec_sparse_forward(tbb))
    assert list(tstate.tables) == ["item_embedding"]
    assert tstate.tables["item_embedding"].dim() == 3  # fat lines

    counts = lambda: (tk.fat_line_update.plain_runs, fa.flash_fwd.plain_runs,  # noqa: E731
                      fa.flash_bwd_dq.plain_runs, fa.flash_bwd_dkv.plain_runs)
    before = counts()
    jl, tl = [], []
    for _ in range(3):
        item, label = _seqs(rng)
        jstate, loss = jrun(jstate, {"item": jnp.asarray(item),
                                     "label": jnp.asarray(label)})
        jl.append(float(loss))
        tstate, loss = trun(tstate, {"item": torch.from_numpy(item),
                                     "label": torch.from_numpy(label)})
        tl.append(float(loss))
    # per step: one fused update; one flash forward, dQ and dK/dV per layer
    assert [a - b for a, b in zip(counts(), before)] == [3, 3, 3, 3]
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tstate.tables["item_embedding"].numpy(),
                               np.asarray(jstate.tables["item_embedding"]),
                               rtol=rtol, atol=atol)
    want = backbone_params_from_flax(jax.tree.map(np.asarray, jstate.dense_params))
    for name, p in tbb.state_dict().items():
        got, ref = p.numpy(), want[name].numpy()
        if name == "block_0.attn.qkv.bias":  # features in (head, qkv, dh) order
            got, ref, p0 = (x.reshape(2, 3, D // 2) for x in
                            (got, ref, start[name].numpy()))
            for x in (got[:, 1], ref[:, 1]):  # the key bias: noise-driven
                assert np.abs(x - p0[:, 1]).max() <= 3 * LR * 1.01
            got, ref = got[:, 0::2], ref[:, 0::2]  # q and v parts
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def test_dense_bert4rec_matches_jax():
    """The self-contained ``Bert4Rec`` (its own item table, every parameter
    under AdamW): ``init_bert4rec``'s params injected through
    ``interop.dense_params_from_flax``, logits at ``TOL["logits"]`` and a
    3-step ``make_train_step`` trajectory with ``bert4rec_loss_fn`` at
    ``TOL["trajectory"]`` (the qkv key bias held to 3 lr, as above)."""
    from tdfo_tpu.train.state import TrainState as JDense
    from tdfo_tpu.train.step import make_train_step as j_dense_step
    from tdfo_tpu_torch.interop import dense_params_from_flax
    from tdfo_tpu_torch.train.state import TrainState as TDense
    from tdfo_tpu_torch.train.step import make_train_step as t_dense_step

    rng = np.random.default_rng(9)
    jcfg, tcfg = _cfgs(n_layers=1)
    jmodel, params = jb4r.init_bert4rec(jax.random.key(3), jcfg)
    start = dense_params_from_flax(jax.tree.map(np.asarray, params))
    tm = tb4r.init_bert4rec(tcfg, device="cpu")
    tm.load_state_dict(start, strict=True)
    item, _ = _seqs(rng)
    want = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(item))
    with torch.no_grad():
        got = tm(torch.from_numpy(item))
    rtol, atol = TOL["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)

    jstate = JDense.create(apply_fn=jmodel.apply, params=params,
                           tx=optax.adamw(LR, weight_decay=WD))
    jrun = j_dense_step(jseq.bert4rec_loss_fn, donate_state=False)
    tstate = TDense.create(model=tm, learning_rate=LR, weight_decay=WD)
    trun = t_dense_step(tseq.bert4rec_loss_fn)
    jl, tl = [], []
    for _ in range(3):
        item, label = _seqs(rng)
        jstate, loss = jrun(jstate, {"item": jnp.asarray(item),
                                     "label": jnp.asarray(label)})
        jl.append(float(loss))
        tstate, loss = trun(tstate, {"item": torch.from_numpy(item),
                                     "label": torch.from_numpy(label)})
        tl.append(float(loss))
    rtol, atol = TOL["trajectory"]
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    want = dense_params_from_flax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tm.state_dict().items():
        got, ref = p.numpy(), want[name].numpy()
        if name == "backbone.block_0.attn.qkv.bias":
            got, ref, p0 = (x.reshape(2, 3, D // 2) for x in
                            (got, ref, start[name].numpy()))
            for x in (got[:, 1], ref[:, 1]):  # the key bias: noise-driven
                assert np.abs(x - p0[:, 1]).max() <= 3 * LR * 1.01
            got, ref = got[:, 0::2], ref[:, 0::2]
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def test_dropout_draws_from_the_step_generator():
    """With a generator the step applies dropout (a different loss from the
    deterministic one) and is reproducible from the generator's seed."""
    rng = np.random.default_rng(6)
    _, tcfg = _cfgs(n_layers=1, dropout=0.3)
    item, label = _seqs(rng)
    batch = {"item": torch.from_numpy(item), "label": torch.from_numpy(label)}
    losses = []
    for gen in (None, 7, 7):
        coll, tables, bb = tb4r.make_sharded_bert4rec(
            tcfg, attn="flash", fused_threshold=100, device="cpu")
        state = TState.create(backbone=bb, tables=tables,
                              sparse_opt=t_opt("adam", lr=LR), learning_rate=LR,
                              weight_decay=WD)
        g = None if gen is None else torch.Generator().manual_seed(gen)
        _, loss = t_step(coll, tseq.bert4rec_sparse_forward(bb))(state, batch, g)
        losses.append(float(loss))
    assert losses[1] == losses[2] != losses[0]


def test_ring_attention_refuses():
    """Ring attention no longer refuses: a ring of one (no mesh) is full
    attention at the logits rung (``ring``: the online softmax sums in
    another order) and the flash path bitwise (``ring_flash``: one merge,
    weights 0 and exp(0)), forward and backward."""
    _, tcfg = _cfgs(n_layers=2)
    rng = np.random.default_rng(7)
    item, _ = _seqs(rng)
    embs = torch.from_numpy(rng.uniform(-1, 1, (B, T, D)).astype(np.float32))
    mask = tb4r.key_padding_mask(torch.from_numpy(item))
    got = {}
    for attn in ("full", "ring", "flash", "ring_flash"):
        _, _, bb = tb4r.make_sharded_bert4rec(tcfg, attn=attn, device="cpu")
        e = embs.clone().requires_grad_(True)
        logits = bb(e, mask)
        grads = torch.autograd.grad(logits.square().mean(), [e, *bb.parameters()])
        got[attn] = (logits.detach(), grads)
    rtol, atol = TOL["logits"]
    np.testing.assert_allclose(got["ring"][0].numpy(), got["full"][0].numpy(),
                               rtol=rtol, atol=atol)
    for a, b in zip(got["ring"][1], got["full"][1]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, atol=atol)
    assert torch.equal(got["ring_flash"][0], got["flash"][0])
    assert all(torch.equal(a, b) for a, b in zip(got["ring_flash"][1], got["flash"][1]))


def test_dedup_lookup_matches_default_path():
    """``dedup_lookup`` on the sequence family ([B, T] ids with PAD 0, a
    fat item table): the routed update writes bitwise what ``fat_update``
    writes on the CPU and the forward gathers the same rows, so three steps
    give the default path's losses and tables."""
    from tdfo_tpu_torch.ops.kernels import fat_line_update_routed as tkr

    rng = np.random.default_rng(6)
    batches = [_seqs(rng) for _ in range(3)]
    runs = {}
    for dedup in (False, True):
        _, tcfg = _cfgs(n_layers=1)
        coll, tables, bb = tb4r.make_sharded_bert4rec(
            tcfg, fused_threshold=100, device="cpu")
        state = TState.create(backbone=bb, tables=tables,
                              sparse_opt=t_opt("adam", lr=LR, weight_decay=WD),
                              learning_rate=LR, weight_decay=WD)
        step = t_step(coll, tseq.bert4rec_sparse_forward(bb), dedup_lookup=dedup)
        before = tkr.fat_line_update_routed.plain_runs
        losses = []
        for item, label in batches:
            state, loss = step(state, {"item": torch.from_numpy(item),
                                       "label": torch.from_numpy(label)})
            losses.append(float(loss))
        assert tkr.fat_line_update_routed.plain_runs - before == (3 if dedup else 0)
        runs[dedup] = (losses, state.tables["item_embedding"])
    assert runs[True][0] == runs[False][0]
    assert torch.equal(runs[True][1], runs[False][1])
