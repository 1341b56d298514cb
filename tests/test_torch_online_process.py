"""The port's online loop over ``[serving] fleet_mode = "process"`` on the
CPU: the swap stage moves two replica processes (``serve/supervisor.py``
``ProcessFleet``) onto each new version.

Two plain cycles of two steps replay one request log.  After each cycle
both replica processes serve the store's head version, and the loop's
probe (round-robin through the ingress) answers every request with the
scores of a fresh in-process scorer on that version's bundle, at rtol
1e-5, atol 1e-6 (the serving rule of ``test_torch_fleet_process.py``: the
processes run their own thread counts, so CPU matmuls may round apart).
"""

import numpy as np
import pytest
import torch

from torch_online_helpers import ctr_env, loop_kwargs

from tdfo_tpu_torch.core.config import read_configs
from tdfo_tpu_torch.serve import MicroBatcher, load_bundle, make_scorer
from tdfo_tpu_torch.train.online import OnlineLoop
from tdfo_tpu_torch.utils import faults as tfaults

SERVING = dict(replicas=2, fleet_mode="process", buckets=[32], max_batch=32,
               batch_deadline_ms=0.0)


def test_online_swaps_a_process_fleet(tmp_path):
    env = ctr_env(tmp_path, n_batches=4)
    kw = loop_kwargs(env, tmp_path / "ck", serving=SERVING)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    loop = OnlineLoop(read_configs(None, **kw), log_dir=str(tmp_path / "log"),
                      device="cpu")
    try:
        rng = np.random.default_rng(5)
        probe = [(f"p{i}", {**{c: rng.integers(0, env["vocab"][c], 7).astype(np.int32)
                               for c in env["cat_cols"]},
                            **{c: rng.random(7, dtype=np.float32)
                               for c in env["cont_cols"]}})
                 for i in range(4)]
        for cycle in range(2):
            rec = loop.run_cycle()
            assert rec is not None and rec["version"] == cycle + 1
            assert loop.fleet.versions() == {0: cycle + 1, 1: cycle + 1}
            got = loop.probe([(r, {k: v.copy() for k, v in b.items()})
                              for r, b in probe])
            sc = make_scorer(load_bundle(loop.store.current_dir()), device="cpu")
            want = MicroBatcher(sc.score, buckets=(32,), max_batch=32,
                                batch_deadline_ms=0.0).run(
                [(r, {k: v.copy() for k, v in b.items()}) for r, b in probe])
            for r, _ in probe:
                np.testing.assert_allclose(np.asarray(got[r]), want[r],
                                           rtol=1e-5, atol=1e-6, err_msg=r)
        assert loop.run_cycle() is None
    finally:
        loop.close()
        torch.set_num_threads(n)
        tfaults.configure(None)
