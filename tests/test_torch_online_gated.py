"""The port's gated online loop (``[online] canary_cycles > 0``) against the
reference's on the CPU: the forced-rollback drill.

Both loops replay one fleet request log (two replicas' logs, labels
``avg_rating > 0.5``) from one initial state over an in-process
``ServingFleet`` of two replicas (replica 0 the canary cohort), two gated
cycles of two steps each with a one-batch shadow slice.
``regress_auc_at_cycle = 1`` makes cycle 1's candidate serve the skew
heuristic on the canary: its bytes pass the shadow gate, the canary watch
rolls it back; cycle 2 retrains and promotes.  Held to the reference:

* the verdicts, reasons, versions and consumed ``(replica, seq, lo, hi)``
  spans of every cycle, exactly; shadow and canary AUCs at abs 1e-6
  (rank statistics over the held-out rows, from scores that agree at the
  forward rung);
* ``rejections.json``: the same rejected versions and reasons, each with
  its own package's candidate digest;
* every replica back on the last good version after the rollback and on
  the promoted one at the end, its probe scores bitwise across the
  replicas, and the store's head version the reference's.
"""

import json

import numpy as np
import pytest
import torch

from torch_online_helpers import (
    carry_into_port,
    ctr_env,
    jax_loop,
    loop_kwargs,
    online_cycles,
)

from tdfo_tpu.utils import faults as jfaults
from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.train.online import OnlineLoop
from tdfo_tpu_torch.utils import faults as tfaults

N_CYCLES = 2
GATED = dict(canary_cycles=1, canary_fraction=0.5, max_auc_regression=0.3,
             shadow_eval_batches=1)
SERVING = dict(replicas=2, buckets=[32], max_batch=32, batch_deadline_ms=0.0)


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gated")
    env = ctr_env(tmp, n_batches=N_CYCLES * 2 + 1, replicas=2, seed=11,
                  label_from_rating=True)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            kw = dict(online=GATED, serving=SERVING,
                      faults={"regress_auc_at_cycle": 1})
            jloop = jax_loop(mp, loop_kwargs(env, tmp / "jck", **kw), tmp / "jlog")
            tkw = loop_kwargs(env, tmp / "tck", **kw)
            carry_into_port(jloop, tkw)
            tloop = OnlineLoop(read_configs(None, **tkw), log_dir=str(tmp / "tlog"),
                               device="cpu")
            jfaults.configure(jloop.config.faults, jloop.config.checkpoint_dir)
            jstats = jloop.run()
            tfaults.configure(tloop.config.faults, tloop.config.checkpoint_dir)
            tstats = tloop.run()
            rng = np.random.default_rng(3)
            probe = [(f"p{i}", {**{c: rng.integers(0, env["vocab"][c], 6).astype(np.int32)
                                   for c in env["cat_cols"]},
                                **{c: rng.random(6, dtype=np.float32)
                                   for c in env["cont_cols"]}})
                     for i in range(3)]
            out = dict(stats=(jstats, tstats),
                       cycles=(online_cycles(tmp / "jlog" / "metrics.jsonl"),
                               online_cycles(tmp / "tlog" / "metrics.jsonl")),
                       rejections=(jloop.store.rejections(), tloop.store.rejections()),
                       versions=(jloop.fleet.versions(), tloop.fleet.versions()),
                       probe=tloop.fleet.probe_each(probe),
                       heads=(jloop.store.current_version(),
                              tloop.store.current_version()))
            tloop.close()
            jloop.close()
    finally:
        torch.set_num_threads(n)
        jfaults.configure(None)
        tfaults.configure(None)
    return out


def test_verdicts_are_the_reference_verdicts(drill):
    jc, tc = drill["cycles"]
    assert [c["verdict"] for c in tc] == [c["verdict"] for c in jc] == \
        ["rollback", "promote"]
    for j, t in zip(jc, tc):
        for key in ("cycle", "version", "reason", "consumed", "global_step",
                    "replay/records", "replay/lag"):
            assert t[key] == j[key], key
        for key in ("shadow_auc", "shadow_auc_base", "canary_auc", "stable_auc"):
            assert t[key] == pytest.approx(j[key], abs=1e-6), key
    assert drill["heads"][1] == drill["heads"][0] == 1
    assert drill["stats"][1]["cycles_done"] == drill["stats"][0]["cycles_done"] == N_CYCLES


def test_rejections_ledger_is_the_reference_ledger(drill):
    jr, tr = drill["rejections"]
    assert [(r["version"], r["reason"]) for r in tr] == \
        [(r["version"], r["reason"]) for r in jr]
    assert len(tr) == 1 and tr[0]["version"] == 1
    # each ledger names its own candidate's digest (the bytes differ in
    # the optimizer's last bits, so the digests are each package's own)
    assert all(isinstance(r["digest"], str) and r["digest"] for r in tr + jr)


def test_every_replica_converges_on_the_last_good_version(drill):
    jv, tv = drill["versions"]
    assert tv == jv == {0: 1, 1: 1}
    probe = drill["probe"]
    assert sorted(probe) == [0, 1]
    for rid in probe[0]:
        assert np.array_equal(probe[0][rid], probe[1][rid]), rid
