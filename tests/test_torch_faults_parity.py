"""The training ``[faults]`` drills through ``Trainer.fit`` against the
reference's (``tests/test_fault_tolerance.py``), run for run: both
trainers start from the same state (the reference's initial dense model
carried into the port through ``interop``; ``tests/torch_trainer_parity.py``)
and fit the same data with ``nan_at_step = 4`` and ``fail_io_nth = 1``.
The rollback records are the reference's (the step, the step restored to,
the steps skipped; the non-finite loss non-finite in both),
``retries.jsonl`` holds the same retried failures, every log record falls
on the same step, and the final eval metrics agree at
``TOL["trajectory"]`` (rtol 1e-4, atol 1e-6).  The kill drill is
``test_torch_faults_parity_kill.py``.
"""

import math

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


def test_nan_rollback_and_io_failure_match_reference(data, tmp_path):
    jt, tr = pair(trainer_kw(data, faults={"nan_at_step": 4, "fail_io_nth": 1},
                             nonfinite_tolerance=2, snapshot_every_n_steps=2),
                  tmp_path)
    want = jt.fit()
    # the port's injector and failure log, armed by its trainer and then
    # by the reference's fit, start again
    faults.configure(tr.config.faults)
    retry.set_failure_log(tmp_path / "port" / "retries.jsonl")
    got = tr.fit()
    assert all(math.isfinite(v) for v in got.values())
    same_metrics(got, want)
    j, t = (records(tmp_path / s / "metrics.jsonl") for s in ("jax", "port"))

    def rollbacks(recs):
        out = [{k: v for k, v in r.items() if k != "time"}
               for r in recs if r.get("rollback")]
        for r in out:
            assert not math.isfinite(r.pop("nonfinite_loss"))
        return out
    assert rollbacks(t) == rollbacks(j) and rollbacks(j)[0]["restored_to_step"] == 2
    assert [r.get("global_step") for r in t] == [r.get("global_step") for r in j]
    j, t = (records(tmp_path / s / "retries.jsonl") for s in ("jax", "port"))
    keep = ("description", "attempt", "final", "error")
    assert [{k: r.get(k) for k in keep} for r in t] == \
        [{k: r.get(k) for k in keep} for r in j]
    assert any("[faults] injected I/O failure" in r["error"] for r in t)
