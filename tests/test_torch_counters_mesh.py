"""The step counters under a mesh (gloo rank processes on the CPU): every
rank reports the counters of the whole state and the global batch, as the
reference's global arrays do, so a world-2 run's counters are the one-rank
run's of the same config on the same global batches.  Rows split over the model axis (``psum``), the
batch split over it (``alltoall``), the batch split over the data axis
(``gspmd``, data-parallel), and the dense regime's PS partition: for three
steps each, ``grad_norm`` and ``param_norm`` agree at ``TOL["trajectory"]``
(rtol 1e-4, atol 1e-6) and the counts (touched ids, non-finite logits) are
equal.  The values themselves are held to the reference's at one device in
``test_torch_counters_parity*.py``.
"""

import functools
import tempfile
from pathlib import Path

import numpy as np
import pytest
from torch_dist_worker import Ranks, counter_steps

from tdfo_tpu_torch.interop import TOL

STEPS = 3
B = 32
LAYOUTS = {  # name -> (mesh, config keys)
    "psum_model2": ({"data": 1, "model": 2}, dict(lookup_mode="psum")),
    "alltoall_model2": ({"data": 1, "model": 2}, dict(lookup_mode="alltoall")),
    "gspmd_data2": ({"data": 2, "model": 1}, {}),
    # the PS partition splits the user and item tables and the towers' first
    # layers (per shard >= 512 bytes)
    "dense_ps_model2": ({"data": 1, "model": 2},
                        dict(model_parallel=False, ps_min_shard_bytes=1 << 9)),
}


@functools.lru_cache(maxsize=None)
def _data():
    from tdfo_tpu_torch.data.ctr_preprocessing import run_ctr_preprocessing
    from tdfo_tpu_torch.data.synthetic import write_synthetic_goodreads

    root = Path(tempfile.mkdtemp(prefix="ctr_mesh_"))
    write_synthetic_goodreads(root, n_users=80, n_books=120,
                              interactions_per_user=(15, 40), seed=7)
    return str(root), run_ctr_preprocessing(root)


def _body(name, world_one: bool = False):
    d, size_map = _data()
    mesh, kw = LAYOUTS[name]
    body = dict(data_dir=d, model="twotower", model_parallel=True, n_epochs=1,
                learning_rate=3e-3, embed_dim=8, per_device_train_batch_size=B,
                per_device_eval_batch_size=B, shuffle_buffer_size=500,
                log_every_n_steps=2, fused_table_threshold=-1, size_map=size_map,
                seed=11, mesh=mesh)
    body.update(kw)
    if world_one:
        body.update(mesh={})
        body.pop("lookup_mode", None)
    return body


@functools.lru_cache(maxsize=None)
def _runs():
    ranks = Ranks(2, Path(tempfile.mkdtemp(prefix="ctr_mesh_ranks_")))
    _data()
    res = ranks.send({name: dict(fn="counters", body=_body(name), steps=STEPS)
                      for name in LAYOUTS}).wait()
    one = {}
    for name, (mesh, _) in LAYOUTS.items():
        # the global batches: each data rank's rows in rank order (the
        # model axis's ranks read the same rows)
        parts = [r[name][1] for r in res[:mesh["data"]]]
        batches = [{k: np.concatenate([p[i][k] for p in parts]) for k in parts[0][i]}
                   for i in range(STEPS)]
        one[name] = counter_steps(_body(name, world_one=True), STEPS, batches)[0]
    return one, [{name: r[name][0] for name in LAYOUTS} for r in res]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_counters_under_a_mesh_are_the_global_ones(name):
    one, res = _runs()
    rtol, atol = TOL["trajectory"]
    for rank, r in enumerate(res):
        for step, (got, want) in enumerate(zip(r[name], one[name], strict=True)):
            where = f"{name} rank {rank} step {step}"
            assert sorted(got) == sorted(want), where
            for k, w in want.items():
                if k.endswith("_norm"):
                    np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                               err_msg=f"{where} {k}")
                else:
                    assert got[k] == w, (where, k, got[k], w)
