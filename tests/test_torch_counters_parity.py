"""The port's step counters (``[telemetry] counters``) against the
reference's, value for value, on the same inputs: the DMP sparse step, the
dense regime's step, and a step with non-finite logits.

Both trainers start from the same state (the reference's initial tables and
dense params carried into the port through ``interop``) and train the same
three batches; each step's counter dict is held to the reference's: the
same names, the integer counts exactly, ``grad_norm`` and ``param_norm``
at ``TOL["trajectory"]`` (rtol 1e-4, atol 1e-6;
``tests/torch_trainer_parity.py``).  The reference runs at one CPU device.
``test_torch_counters_parity_sparse.py`` holds the dedupe, cache and
hot/cold configurations.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_trainer_parity import (
    CONFIGS,
    assert_same,
    make_data,
    one_device,
    pair,
    reference_step,
    run_and_compare,
    trainer_kw,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return make_data(tmp_path_factory.mktemp("gr_ctr_parity"))


def _pair(data, monkeypatch, case):
    one_device(monkeypatch)
    return pair(trainer_kw(data, telemetry={"counters": True}, **CONFIGS[case]))


@pytest.mark.parametrize("case", ["dmp", "dense"])
def test_step_counters_match_reference(data, monkeypatch, case):
    run_and_compare(*_pair(data, monkeypatch, case))


def test_nonfinite_logits_match_reference(data, monkeypatch):
    """A non-finite table row: both count the same non-finite logits, and
    both norms go non-finite."""
    import jax.numpy as jnp

    jt, tr = _pair(data, monkeypatch, "dmp")
    tr._train_auc = None
    batch = next(iter(tr._train_batches(0)))[0]
    user = int(batch["user_id"][0])
    tables = dict(jt.state.tables)
    tables["user_embed"] = tables["user_embed"].at[user].set(jnp.nan)
    jt.state = dataclasses.replace(jt.state, tables=tables)
    with torch.no_grad():
        tr.state.tables["user_embed"][user] = float("nan")
    out = reference_step(jt, batch)
    tr.state, _ = tr._one_step(tr.state, batch)
    assert float(out[-1]["nonfinite_logits"]) == int((batch["user_id"] == user).sum())
    assert_same(out[-1], tr._step_ctrs, "poisoned step")
    assert not np.isfinite(float(tr._step_ctrs["grad_norm"]))
