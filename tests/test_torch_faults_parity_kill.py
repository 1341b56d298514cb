"""The training kill drill through ``Trainer.fit`` against the
reference's (``tests/test_fault_tolerance.py``), run for run: both
trainers start from the same state (``tests/torch_trainer_parity.py``),
checkpoint every 3 steps and are killed by ``kill_at_step = 5``.  The
killed runs leave the same cursor (mid-epoch, step 3; its running loss
sum at rtol 1e-4), and the restarted
runs resume at the same step and end on eval metrics that agree at
``TOL["trajectory"]`` (rtol 1e-4, atol 1e-6).
"""

import numpy as np
import pytest
import torch
from torch_trainer_parity import make_data, one_device, pair, records, same_metrics, trainer_kw

from tdfo_tpu_torch.utils import faults, retry


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    one_device(monkeypatch)
    yield
    torch.set_num_threads(n)
    faults.configure(None)
    retry.set_failure_log(None)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("gr_faults"), n_users=20, n_books=60)


def test_kill_resume_matches_reference(data, tmp_path, monkeypatch):
    import tdfo_tpu.utils.faults as jfaults
    from tdfo_tpu.core.config import read_configs as jread
    from tdfo_tpu.train.checkpoint import CheckpointManager as JManager
    from tdfo_tpu.train.trainer import Trainer as JTrainer

    from tdfo_tpu_torch.core.config import read_configs
    from tdfo_tpu_torch.interop import TOL
    from tdfo_tpu_torch.train.checkpoint import CheckpointManager
    from tdfo_tpu_torch.train.trainer import Trainer

    class Killed(SystemExit):
        pass

    def fake_exit(code):
        raise Killed(code)

    monkeypatch.setattr(faults.os, "_exit", fake_exit)
    monkeypatch.setattr(jfaults.os, "_exit", fake_exit)
    kw = {side: trainer_kw(data, checkpoint_dir=str(tmp_path / side / "ckpt"),
                           checkpoint_every_n_steps=3, faults={"kill_at_step": 5})
          for side in ("jax", "port")}
    jt, tr = pair(kw["jax"], tmp_path / "run1", kw["port"])
    with pytest.raises(Killed):
        jt.fit()
    faults.configure(tr.config.faults, tr.config.checkpoint_dir)
    with pytest.raises(Killed):
        tr.fit()
    jm = JManager(tmp_path / "jax" / "ckpt")
    want = jm.read_cursor(jm.latest_step())
    jm.close()
    m = CheckpointManager(tmp_path / "port" / "ckpt")
    got = m.read_cursor(m.latest_step())
    # the loss sum so far is a float of each package's losses
    np.testing.assert_allclose(got.pop("loss_sum"), want.pop("loss_sum"),
                               rtol=TOL["trajectory"][0])
    assert got == want
    assert want["epoch"] == 0 and want["step"] == 3 and not want["epoch_complete"]
    # the same commands again: the kill markers disarm the faults
    want = JTrainer(jread(None, **kw["jax"]), log_dir=tmp_path / "run2" / "jax").fit()
    got = Trainer(read_configs(None, **kw["port"]), log_dir=tmp_path / "run2" / "port",
                  device="cpu").fit()
    same_metrics(got, want)
    j, t = (records(tmp_path / "run2" / s / "metrics.jsonl") for s in ("jax", "port"))
    resumed = [[(r["resumed_mid_epoch"], r.get("step")) for r in recs
                if "resumed_mid_epoch" in r] for recs in (j, t)]
    assert resumed[0] == resumed[1] == [(0, 3)]
