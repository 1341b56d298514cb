"""The port's online loop on the seq family (Bert4Rec) against the
reference's on the CPU: one gated cycle over a two-replica fleet.

Both loops replay one log of eval windows (``history_window`` sequences
with the MASK last, 1 + 100 candidate panels, no label) from one initial
state: each cycle trains its batches as last-position masked-LM steps,
and the shadow gate and canary watch judge candidate panels by
``ranking_auc``.  Held to the reference: the verdict, version and
consumed spans exactly; the shadow and canary ``ranking_auc`` values at
abs 1e-6 (rank statistics of scores that agree at the forward rung); the
item table and the transformer after the cycle at rtol 1e-4, atol 1e-6
(``interop.TOL["trajectory"]``), but for the key part of the fused qkv
bias: its gradient is exactly zero, so each package's AdamW steps it by
about ``lr`` in the direction of its own rounding noise, and both are
held to that bound instead (the rule of ``test_torch_bert4rec.py``,
``ROADMAP.md`` Queue C).
"""

import jax
import numpy as np
import pytest
import torch

from torch_online_helpers import (
    carry_into_port,
    jax_loop,
    loop_kwargs,
    online_cycles,
    seq_env,
)

from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.interop import TOL, backbone_params_from_flax
from tdfo_tpu_torch.train.online import OnlineLoop
from tdfo_tpu_torch.utils import faults as tfaults

GATED = dict(canary_cycles=1, canary_fraction=0.5, max_auc_regression=0.3,
             shadow_eval_batches=1, max_cycles=1)
SERVING = dict(replicas=2, history_buckets=[32], max_batch=32,
               batch_deadline_ms=0.0)


@pytest.fixture(scope="module")
def cycle(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("online_seq")
    env = seq_env(tmp, n_batches=3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            kw = dict(seq=True, online=GATED, serving=SERVING)
            jloop = jax_loop(mp, loop_kwargs(env, tmp / "jck", **kw), tmp / "jlog")
            tkw = loop_kwargs(env, tmp / "tck", **kw)
            carry_into_port(jloop, tkw)
            tloop = OnlineLoop(read_configs(None, **tkw), log_dir=str(tmp / "tlog"),
                               device="cpu")
            start = backbone_params_from_flax(
                jax.tree.map(np.asarray, jloop.trainer.state.dense_params))
            jloop.run()
            tloop.run()
            out = dict(cycles=(online_cycles(tmp / "jlog" / "metrics.jsonl"),
                               online_cycles(tmp / "tlog" / "metrics.jsonl")),
                       jstate=jloop.trainer.state, tstate=tloop.trainer.state,
                       start=start, steps=tloop.gstep, lr=tkw["learning_rate"],
                       heads=tkw["n_heads"], dim=tkw["embed_dim"],
                       versions=tloop.fleet.versions())
            tloop.close()
            jloop.close()
    finally:
        torch.set_num_threads(n)
        jfaults.configure(None)
        tfaults.configure(None)
    return out


def test_seq_cycle_gates_by_the_reference_ranking_auc(cycle):
    jc, tc = cycle["cycles"]
    assert len(tc) == len(jc) == 1
    j, t = jc[0], tc[0]
    for key in ("verdict", "version", "consumed", "steps", "global_step"):
        assert t[key] == j[key], key
    assert t["verdict"] == "promote"
    for key in ("shadow_auc", "shadow_auc_base", "canary_auc", "stable_auc"):
        assert 0.0 <= t[key] <= 1.0
        assert t[key] == pytest.approx(j[key], abs=1e-6), key
    assert cycle["versions"] == {0: 1, 1: 1}


def test_seq_state_after_the_cycle_matches_the_reference(cycle):
    rtol, atol = TOL["trajectory"]
    js, ts = cycle["jstate"], cycle["tstate"]
    for name, t in ts.tables.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(js.tables[name]),
                                   rtol=rtol, atol=atol, err_msg=name)
    want = backbone_params_from_flax(jax.tree.map(np.asarray, js.dense_params))
    h, dh = cycle["heads"], cycle["dim"] // cycle["heads"]
    bound = cycle["steps"] * cycle["lr"] * 1.01
    for name, t in ts.backbone.state_dict().items():
        got, ref = t.numpy(), want[name].numpy()
        if name.endswith("attn.qkv.bias"):  # features in (head, qkv, dh) order
            got, ref, p0 = (x.reshape(h, 3, dh) for x in
                            (got, ref, cycle["start"][name].numpy()))
            for x in (got[:, 1], ref[:, 1]):  # the key bias: noise-driven
                assert np.abs(x - p0[:, 1]).max() <= bound
            got, ref = got[:, 0::2], ref[:, 0::2]  # q and v parts
        np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)
