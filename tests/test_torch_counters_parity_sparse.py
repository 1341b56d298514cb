"""The port's step and cache write-back counters against the reference's,
value for value, on the same inputs: ``dedup_lookup`` over fat lines and
over rows, the update cache (hit, miss, unique, flushed and resident rows)
and hot/cold tables (hot ids).  Set-up and tolerances as in
``test_torch_counters_parity.py`` (``tests/torch_trainer_parity.py``):
counts exactly, norms at ``TOL["trajectory"]`` (rtol 1e-4, atol 1e-6).
"""

import pytest
import torch
from torch_trainer_parity import (
    CONFIGS,
    make_data,
    one_device,
    pair,
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
    return make_data(tmp_path_factory.mktemp("gr_ctr_parity"), hot_vocab=8)


@pytest.mark.parametrize("case", ["dedup_fat", "dedup_rows", "cache", "hot"])
def test_step_counters_match_reference(data, monkeypatch, case):
    one_device(monkeypatch)
    run_and_compare(*pair(trainer_kw(data, telemetry={"counters": True},
                                     **CONFIGS[case])))
